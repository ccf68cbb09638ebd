from .ops import engram_gather, gather_rows
from .ref import engram_gather_ref, gather_rows_ref

__all__ = ["engram_gather", "engram_gather_ref", "gather_rows",
           "gather_rows_ref"]
