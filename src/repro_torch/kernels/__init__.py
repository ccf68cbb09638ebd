"""Hand-written CUDA kernels for Hopper (``repro_torch/csrc``), each beside
its plain PyTorch version (``ref.py``) and a launch counter on its wrapper.

  engram_gather  K1: Engram row gather (replaces the Pallas gather_rows)
  gated_fuse     K2: fused gated fusion (replaces the Pallas gated_fuse)
  decode_attn    K3: GQA decode attention over the KV cache in place
                 (replaces none: the reference attends with XLA's dots)

A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. Each launch is a custom operator
(``torch.library.custom_op``) with a shape function, so meta and fake
tensors pass through a wrapper as the kernel's output shape.
"""
