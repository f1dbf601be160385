"""Paged decode attention (port of ``ray_tpu/ops/paged_attention.py``).

One query token attends over its sequence's KV, read through a block
table from a shared pool (PagedAttention, Kwon et al., SOSP '23).  The
reference has no Pallas kernel here, so neither does the port: gather,
then attend, in plain PyTorch ops with float32 accumulation.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops.attention import NEG_INF


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool (num_blocks, block_size, n_kv, d), block_tables (B, max_blocks)
    int → each sequence's paged KV as a padded dense (B, max_blocks *
    block_size, n_kv, d).  Entries past a sequence's allocation may be any
    valid index: masking is by context length."""
    n, bs, kv, d = pool.shape
    b, mb = block_tables.shape
    g = pool.index_select(0, block_tables.reshape(-1))
    return g.reshape(b, mb * bs, kv, d)


def paged_attention_decode(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention through a block table.

    q (B, H, D); k_pool, v_pool (N, bs, KV, D) — this layer's view of the
    pool; block_tables (B, MAXB); ctx_lens (B,) — tokens already in the
    pool (the new token is not); k_new, v_new (B, KV, D) — this token's
    key and value, attended explicitly so the pool stays read-only inside
    the step.  Returns (B, H, D) in q.dtype.
    """
    b, h, d = q.shape
    kvh = k_pool.shape[2]
    scale = 1.0 / math.sqrt(d)
    k_ctx = gather_kv(k_pool, block_tables)              # (B, T, KV, D)
    v_ctx = gather_kv(v_pool, block_tables)
    t = k_ctx.shape[1]
    if kvh != h:                                         # grouped-query heads
        rep = h // kvh
        k_ctx = k_ctx.repeat_interleave(rep, dim=2)
        v_ctx = v_ctx.repeat_interleave(rep, dim=2)
        k_new = k_new.repeat_interleave(rep, dim=1)
        v_new = v_new.repeat_interleave(rep, dim=1)
    qf = q.float()
    logits = torch.einsum("bhd,bkhd->bhk", qf, k_ctx.float()) * scale
    valid = torch.arange(t, device=q.device)[None, :] < ctx_lens[:, None]
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    self_logit = (qf * k_new.float()).sum(-1) * scale    # (B, H)
    logits = torch.cat([logits, self_logit[..., None]], dim=-1)
    probs = torch.softmax(logits, dim=-1)                # f32
    out = torch.einsum("bhk,bkhd->bhd", probs[..., :-1], v_ctx.float())
    out = out + probs[..., -1:] * v_new.float()
    return out.to(q.dtype)
