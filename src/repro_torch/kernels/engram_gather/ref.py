"""Plain PyTorch version of the engram_gather kernel."""
import torch


def gather_rows_ref(table: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """out[i] = table[gid[i]]."""
    return table[gid]


def gather_rows_multi_ref(tables, gid: torch.Tensor) -> torch.Tensor:
    """out[t, i] = tables[t][gid[t, i]] -> (L, N, hd)."""
    return torch.stack([tab[g] for tab, g in zip(tables, gid)])


def engram_gather_ref(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables (T, V, hd); idx (..., T) -> rows (..., T, hd)."""
    return torch.stack([tables[t][idx[..., t]]
                        for t in range(tables.shape[0])], dim=-2)
