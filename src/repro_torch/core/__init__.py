"""Square-form algebra, prepared operands, the matmul modes, the square
convolutions and the contraction dispatch (``fs_einsum``)."""
