"""PyTorch/CUDA port of the Engram-CXL serving system.

Laid out like the JAX package ``repro`` (the reference, which it never
imports): ``configs``, ``core`` (hashing, Engram retrieval and fusion),
``models``, ``kernels`` (hand-written CUDA for Hopper, ``csrc/``), ``pool``
and ``serving``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
