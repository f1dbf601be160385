"""Ulysses sequence parallelism: all-to-all over heads (port of
``ray_tpu/ops/ulysses.py``).

One all-to-all re-shards (B, T/n, H, D) → (B, T, H/n, D), so every rank
holds the FULL sequence for H/n heads and runs plain causal attention
locally; a second all-to-all restores the sequence split.  Q, K and V
ride one all-to-all together.  The local attention is the same causal
function over the full sequence as the reference's ``dense_attention``:
on CUDA the port's flash kernel (at H/n heads), on the CPU the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import dense_attention
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import Mesh, get_ambient_mesh, live_size


def _local_attention(q, k, v, causal: bool) -> torch.Tensor:
    if q.is_cuda and causal:
        from ray_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, True)
    return dense_attention(q, k, v, causal=causal)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str, causal: bool = True,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Per-rank Ulysses attention.  q/k/v: (B, T_local, H, D), sequence
    split over ``axis_name``; H must divide by the axis size.  Returns
    (B, T_local, H, D)."""
    n = col.axis_size(axis_name, mesh)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs n_heads ({H}) divisible by "
                         f"{axis_name} axis size ({n})")
    # (B, T/n, 3, H, D) -> (B, T, 3, H/n, D): split heads, gather sequence
    qkv = col.all_to_all(torch.stack([q, k, v], dim=2), axis_name,
                         split_dim=3, concat_dim=1, mesh=mesh)
    # the full sequence is local: positions are global, the plain mask
    out = _local_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           causal)
    return col.all_to_all(out, axis_name, split_dim=1, concat_dim=2,
                          mesh=mesh)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, mesh: Mesh,
                              axis_name: str = "context",
                              causal: bool = True) -> torch.Tensor:
    """Ulysses over ``mesh``'s ``axis_name`` (local attention when that
    axis has size 1)."""
    if live_size(mesh, axis_name) == 1:
        return dense_attention(q, k, v, causal=causal)
    return ulysses_attention(q, k, v, axis_name=axis_name, causal=causal,
                             mesh=mesh)


def ulysses_attention_for_model(q, k, v, cfg=None, *,
                                axis_name: Optional[str] = "context"):
    """Model hook (``attn_impl='ulysses'``)."""
    return ulysses_attention_sharded(q, k, v, mesh=get_ambient_mesh(),
                                     axis_name=axis_name or "context")
