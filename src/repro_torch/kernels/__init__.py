"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
plain PyTorch versions, the public wrappers and the route planner.

- K1, the square GEMM: ``sq_matmul.sq_matmul_k1`` on ``csrc/sq_matmul.cu``.
- K2 and K3, the batched and batch-folded square GEMMs:
  ``sq_matmul.sq_matmul_k2`` / ``sq_matmul_k3``, in the same source.
- K4, paged decode attention: ``sq_paged_attn.sq_paged_attn_k4`` on
  ``csrc/sq_paged_attn.cu``.
- K5, the complex matmul with three squares per multiply (CPM3):
  ``cpm3_matmul.cpm3_matmul_k5`` on ``csrc/cpm3_matmul.cu``.
- K6, the complex matmul with four squares per multiply (CPM4):
  ``cpm4_matmul.cpm4_matmul_k6`` on ``csrc/cpm4_matmul.cu``.
- K7, the fused 2D square convolution: ``sq_conv2d.sq_conv2d_k7`` on
  ``csrc/sq_conv2d.cu``.
- K8, the square 1D correlation: ``sq_conv.sq_conv_k8`` on
  ``csrc/sq_conv.cu``.
"""
