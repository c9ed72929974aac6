"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
plain PyTorch versions, the public wrappers and the route planner.

- K1, the square GEMM: ``sq_matmul.sq_matmul_k1`` on ``csrc/sq_matmul.cu``.
- K2 and K3, the batched and batch-folded square GEMMs:
  ``sq_matmul.sq_matmul_k2`` / ``sq_matmul_k3``, in the same source.
- K4, paged decode attention: ``sq_paged_attn.sq_paged_attn_k4`` on
  ``csrc/sq_paged_attn.cu``.
"""
