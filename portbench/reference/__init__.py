"""The plain reference the benchmark holds the port's served tokens
against: plain PyTorch in float32, importing nothing of the port, of the
JAX package or of JAX."""
