"""Hand-written CUDA kernels for Hopper (``repro_torch/csrc``), each beside
its plain PyTorch version (``ref.py``) and a launch counter on its wrapper.

  engram_gather  K1: Engram row gather (replaces the Pallas gather_rows)
  gated_fuse     K2: fused gated fusion (replaces the Pallas gated_fuse)

A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""
