"""Pipeline parallelism: microbatch pipelining over the ``pipeline`` mesh
axis (port of ``ray_tpu/parallel/pipeline.py``).

Schedule: GPipe-style fill/drain over M microbatches and S stages — tick
t runs microbatch t - s on stage s; the bubble is (S-1)/(M+S-1), so pick
M >= 4·S.  As in the reference's SPMD program, every rank runs every
tick and issues the same collectives (stage 0 takes its input through a
``torch.where`` on a tensor mask, not a per-stage branch), so the
forward's ``ppermute``s and their backward inverses match on every rank
with no special case; autograd derives the reversed pipeline.  The last
stage's outputs are gathered to every rank (an ``all_gather`` over the
axis, then its row S-1).

Layout: stage params are the stacked-layer layout reshaped (L, ...) →
(S, L/S, ...) by ``stack_stages``; a rank holds its stage's row, leading
dim 1 (the slice the ``pipeline`` entry of the rules gives it, stacked
with ``stack_stages(local, 1)``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.parallel.mesh import Mesh


def stack_stages(params: Any, num_stages: int) -> Any:
    """(L, ...) stacked-layer params → (S, L/S, ...) stage-major layout."""
    def leaf(p):
        L = p.shape[0]
        if L % num_stages:
            raise ValueError(
                f"{L} layers not divisible by {num_stages} pipeline stages")
        return p.reshape(num_stages, L // num_stages, *p.shape[1:])
    return tx.tree_map(leaf, params)


def unstack_stages(params: Any) -> Any:
    """Inverse of ``stack_stages``."""
    return tx.tree_map(
        lambda p: p.reshape(p.shape[0] * p.shape[1], *p.shape[2:]), params)


def split_microbatches(batch: Any, num_microbatches: int) -> Any:
    """(B, ...) → (num_microbatches, B/num_microbatches, ...)."""
    def leaf(x):
        B = x.shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} not divisible by "
                             f"{num_microbatches} microbatches")
        return x.reshape(num_microbatches, B // num_microbatches,
                         *x.shape[1:])
    return tx.tree_map(leaf, batch)


def merge_microbatches(y: Any) -> Any:
    return tx.tree_map(
        lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), y)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, *,
                   mesh: Optional[Mesh] = None, axis: str = "pipeline",
                   remat: bool = True) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage pipeline over microbatched input.

    ``stage_fn(params_for_one_stage, x) -> y`` keeps the activation shape;
    ``stage_params``: this rank's stage, leaves with leading dim 1;
    ``x_micro``: (M, mb, ...), the same on every rank of the axis.
    Returns (M, mb, ...): the last stage's outputs, on every rank."""
    S = col.axis_size(axis, mesh)
    M = x_micro.shape[0]
    p = tx.tree_map(lambda q: q[0], stage_params)

    def f(xm):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, p, xm, use_reentrant=False,
                              preserve_rng_state=False)
        return stage_fn(p, xm)

    if S == 1:
        return torch.stack([f(x_micro[i]) for i in range(M)])
    if M < S:
        raise ValueError(f"need >= {S} microbatches for {S} stages")
    stage = col.axis_index(axis, mesh)
    dev = x_micro.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == S - 1, device=dev)
    fwd = col.ring_perm(S)
    state = torch.zeros_like(x_micro[0])
    ys = [torch.zeros_like(x_micro[0]) for _ in range(M)]
    ticks = M + S - 1
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped in the drain); the others
        # the activation stage s-1 sent last tick
        inp = torch.where(first, x_micro[min(t, M - 1)], state)
        out = f(inp)
        if t + 1 < ticks:       # the last tick's send would feed nothing
            state = col.ppermute(out, axis, fwd, mesh)
        if t >= S - 1:          # the last stage emits microbatch t-(S-1)
            i = t - (S - 1)
            ys[i] = torch.where(last, out, ys[i])
    # replicate the last stage's outputs to every rank of the axis
    return col.all_gather(torch.stack(ys)[None], axis, dim=0,
                          mesh=mesh)[S - 1]


def pick_num_microbatches(batch_size: int, num_stages: int,
                          target_multiple: int = 4) -> int:
    """Largest divisor of batch_size that is <= target_multiple * stages
    (enough microbatches to amortize the fill/drain bubble)."""
    want = max(num_stages, min(batch_size, target_multiple * num_stages))
    for m in range(want, 0, -1):
        if batch_size % m == 0 and m >= num_stages:
            return m
    return 1
