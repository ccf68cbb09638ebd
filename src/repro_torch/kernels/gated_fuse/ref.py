"""Plain PyTorch version of the gated_fuse kernel."""
import torch


def gated_fuse_ref(h, e, wg, wp):
    """out = h + sigmoid(h @ wg) * (e @ wp): f32 products, f32 epilogue,
    result in h's dtype."""
    g = torch.sigmoid(h.float() @ wg.float())
    p = e.float() @ wp.float()
    return (h.float() + g * p).to(h.dtype)
