"""Square-form algebra, prepared operands, the matmul modes, the square
convolutions and the contraction dispatch (``fs_einsum``); the complex half:
the square complex matmuls (``complexmm``), the square transforms and DFT
(``transforms``), and the complex correlation and IIR filter of ``conv``."""
