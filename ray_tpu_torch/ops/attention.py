"""Attention primitives (PyTorch port of ``ray_tpu/ops/attention.py``).

- ``flash_update`` / ``flash_finalize``: the online-softmax block update
  and its normalisation, shared by blockwise and (later) ring attention.
- ``blockwise_attention``: causal attention as a loop over KV blocks with
  online softmax — O(T·block) activation memory instead of O(T²).
- ``dense_attention``: plain O(T²) attention.

The reference computes these outside Pallas, so plain ``torch`` matmuls
are the port (no hand-written kernel).  Accumulators are float32
whatever the input dtype.  ``NEG_INF`` is float32's lowest finite value,
not ``-inf``: the masked-softmax arithmetic (``exp(NEG_INF - m)`` with a
finite ``m``) depends on it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_update(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax accumulation step.

    Shapes: q (B,Tq,H,D); k,v (B,Tk,H,D); o (B,H,Tq,D) f32;
    m,l (B,H,Tq) f32; mask broadcastable to (B,H,Tq,Tk) bool (True=keep).

    Rows with no valid key yet keep ``m == NEG_INF``; callers must ensure
    the FIRST block every row sees has at least one valid key (causal
    blockwise starts with block 0) so ``m`` is finite before fully-masked
    blocks contribute exp(NEG_INF - m) == 0.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o * corr[..., None] + pv
    return o, m_new, l


def flash_finalize(o: torch.Tensor, l: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """(B,H,T,D) f32 accumulators → (B,T,H,D) normalized output."""
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(Tq,), (Tk,) global positions → (Tq, Tk) bool keep-mask."""
    return q_pos[:, None] >= k_pos[None, :]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        block_size: int = 512) -> torch.Tensor:
    """Memory-efficient attention. (B,T,H,D)×3 → (B,T,H,D).

    Loops over KV in blocks with online softmax (the reference's
    ``lax.scan``); differentiable by autograd.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bs = min(block_size, Tk)
    if Tk % bs:
        raise ValueError(f"kv length {Tk} not divisible by block {bs}")
    scale = 1.0 / math.sqrt(D)
    q_pos = torch.arange(Tq, device=q.device)
    o = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    # Forward block order satisfies flash_update's masking contract for
    # causal attention: block 0 contains k=0, a valid key for every row.
    for i in range(Tk // bs):
        mask = None
        if causal:
            k_pos = i * bs + torch.arange(bs, device=q.device)
            mask = causal_mask(q_pos, k_pos)[None, None]
        o, m, l = flash_update(o, m, l, q, k[:, i * bs:(i + 1) * bs],
                               v[:, i * bs:(i + 1) * bs], mask, scale)
    return flash_finalize(o, l, q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, q_offset: int = 0
                    ) -> torch.Tensor:
    """Plain O(T²) attention on (B, T, H, D); scores and softmax in
    float32, probabilities cast to ``v.dtype`` for the value product.

    ``q_offset`` shifts query positions for causal masking when q is a
    chunk of a longer sequence."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        mask = causal_mask(q_pos, torch.arange(k.shape[1], device=q.device))
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
