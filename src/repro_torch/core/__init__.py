"""Square-form algebra, prepared operands, the matmul modes and the
contraction dispatch (``fs_einsum``)."""
