"""Attention primitives (PyTorch port of ``ray_tpu/ops/attention.py``).

This slice carries ``NEG_INF`` and ``dense_attention``.  ``NEG_INF`` is
float32's lowest finite value, not ``-inf``: the masked-softmax
arithmetic (``exp(NEG_INF - m)`` with a finite ``m``) depends on it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(Tq,), (Tk,) global positions → (Tq, Tk) bool keep-mask."""
    return q_pos[:, None] >= k_pos[None, :]


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
