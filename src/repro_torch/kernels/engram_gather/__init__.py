from .host import host_empty, is_mapped
from .ops import engram_gather, gather_rows, gather_rows_multi
from .ref import engram_gather_ref, gather_rows_multi_ref, gather_rows_ref

__all__ = ["engram_gather", "engram_gather_ref", "gather_rows",
           "gather_rows_multi", "gather_rows_multi_ref", "gather_rows_ref",
           "host_empty", "is_mapped"]
