"""Plain PyTorch version of the flash attention kernel: dense softmax
attention with GQA and causal / sliding-window masks, logits in float32."""
from __future__ import annotations

import torch

NEG_INF = -1e30     # mask sentinel: exp(NEG_INF - m) is 0, never NaN


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, q_offset: int | None = None,
                  return_lse: bool = False):
    """Dense reference attention.

    q: (B, Sq, H, D);  k, v: (B, Sk, Hkv, D) with H % Hkv == 0; q head h
    reads kv head ``h // (H // Hkv)``.  Query row i sits at absolute
    position ``q_offset + i`` (default ``Sk - Sq``: the ends align, as for
    a decode step against a full cache); it sees key j when
    ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``
    (window).  A row that sees no key gives 0.  Logits, softmax and the
    value product run in float32 (float64 for float64 inputs); the result
    is in q's dtype.  With ``return_lse`` also each row's log-sum-exp
    (B, Sq, H) of the scaled, masked logits in that type, NEG_INF for a row
    that sees no key: the kernel's second output.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    q_offset = sk - sq if q_offset is None else q_offset

    ct = torch.promote_types(q.dtype, torch.float32)
    kx = k.repeat_interleave(group, dim=2).to(ct)
    vx = v.repeat_interleave(group, dim=2).to(ct)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), kx) * scale
    row = q_offset + torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= col <= row
    if window is not None:
        keep &= col > row - window
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / den
    out = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    seen = keep.any(dim=-1)
    out = torch.where(seen[None, :, None, None], out, 0.0).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(den))[..., 0].transpose(1, 2)      # (B, Sq, H)
    return out, torch.where(seen[None, :, None], lse, NEG_INF)
