"""Plain PyTorch version of the decode_attn kernel."""
import math

import torch


def decode_attention_ref(q, k_new, v_new, k_cache, v_cache, positions, *,
                         window: int = 0, softcap: float = 0.0,
                         group: int = 1, q_offset: int = 0):
    """One decode token a row: write ``k_new``/``v_new`` (B, Hc, D) into the
    caches (B, S, Hc, D) in place at ``clamp(positions, 0, S - 1)``, then
    attend q (B, Hq, D): query head i reads KV head ``(i + q_offset) //
    group`` at the keys ``max(0, pos - window + 1) .. min(pos, S - 1)``
    (``window`` 0: from key 0), every key with equal weight where none is
    valid. f32 scores over ``sqrt(D)``, ``softcap * tanh(s / softcap)``
    where ``softcap`` > 0, f32 softmax and value sum; out (B, Hq, D) in the
    cache's dtype."""
    B, S = k_cache.shape[:2]
    Hq, D = q.shape[1:]
    rows = torch.arange(B, device=k_cache.device)
    pos = positions.to(torch.int64)
    at = pos.clamp(0, S - 1)
    k_cache[rows, at] = k_new.to(k_cache.dtype)
    v_cache[rows, at] = v_new.to(v_cache.dtype)
    kv = (torch.arange(Hq, device=q.device) + q_offset) // group
    k = k_cache[:, :, kv].float()                     # (B, S, Hq, D)
    v = v_cache[:, :, kv].float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    valid = kpos <= pos[:, None]
    if window > 0:
        valid &= kpos > pos[:, None] - window
    none = ~valid.any(dim=-1, keepdim=True)
    s = torch.where(none[:, None], 0.0,
                    s.masked_fill(~valid[:, None], -math.inf))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v).to(k_cache.dtype)
