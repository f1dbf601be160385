"""Ring attention: context-parallel attention around a ring of ranks (port
of ``ray_tpu/ops/ring_attention.py``).

The sequence is split over a mesh axis (``context``, or ``seq`` inside
GPT-2's sequence-parallel block); each rank holds a contiguous chunk of
Q/K/V.  K/V blocks rotate around the ring (``collective_matmul.ring_scan``:
the rotation for step s+1 is issued before step s's update) while each
rank folds its queries' attention over the resident block into the
online-softmax accumulators (``ops/attention.py``'s ``flash_update`` /
``flash_finalize``).  The full T×T scores never exist anywhere.

Plain PyTorch, as the reference's is plain XLA: the port's flash kernel
is causal-only, and the ring's off-diagonal blocks are not causal.
Differentiable by autograd; the permutation's backward is the inverse
ring.  The port's arrays are this rank's chunk already (the reference's
``*_sharded`` wrappers take global arrays and shard them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import (NEG_INF, causal_mask,
                                         dense_attention, flash_finalize,
                                         flash_update)
from ray_tpu_torch.ops.collective_matmul import ring_scan
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import Mesh, get_ambient_mesh, live_size


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str, axis_size: int, causal: bool = True,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Per-rank ring attention.  q/k/v: (B, T_local, H, D), this rank's
    contiguous chunk (chunk index = the rank's ``axis_name``
    coordinate).  Returns (B, T_local, H, D)."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    me = col.axis_index(axis_name, mesh)
    dev = q.device
    q_pos = me * T + torch.arange(T, device=dev)
    o0 = torch.zeros((B, H, T, D), dtype=torch.float32, device=dev)
    m0 = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=dev)
    l0 = torch.zeros((B, H, T), dtype=torch.float32, device=dev)

    def body(step, carry, kv):
        kc, vc = kv.split(D, dim=-1)
        # step s holds chunk (me - s) mod n: step 0 is the diagonal block,
        # which has a valid key for every row (flash_update's contract)
        src = (me - step) % axis_size
        mask = None
        if causal:
            k_pos = src * T + torch.arange(T, device=dev)
            mask = causal_mask(q_pos, k_pos)[None, None]
        return flash_update(*carry, q, kc, vc, mask, scale)

    # K and V ride one transfer a step
    o, _, l = ring_scan(body, (o0, m0, l0), torch.cat([k, v], dim=-1),
                        axis_name=axis_name, axis_size=axis_size, mesh=mesh)
    return flash_finalize(o, l, q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, mesh: Mesh,
                           axis_name: str = "context",
                           causal: bool = True) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``axis_name`` (dense attention when
    that axis has size 1)."""
    n = live_size(mesh, axis_name)
    if n == 1:
        return dense_attention(q, k, v, causal=causal)
    return ring_attention(q, k, v, axis_name=axis_name, axis_size=n,
                          causal=causal, mesh=mesh)


def ring_attention_for_model(q, k, v, cfg=None, *,
                             axis_name: Optional[str] = "context"):
    """Model hook (``attn_impl='ring'``): the ring over the ambient mesh's
    ``axis_name`` (default ``context``), dense causal attention without
    one."""
    return ring_attention_sharded(q, k, v, mesh=get_ambient_mesh(),
                                  axis_name=axis_name or "context")
