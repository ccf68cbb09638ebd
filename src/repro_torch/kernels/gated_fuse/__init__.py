from .ops import engram_gated_fuse
from .ref import gated_fuse_ref

__all__ = ["engram_gated_fuse", "gated_fuse_ref"]
