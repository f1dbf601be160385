"""Decomposed sharded matmuls: collective legs behind the chunk products
(port of ``ray_tpu/ops/collective_matmul.py``).

- ``all_gather_matmul``: ``Y = allgather_rows(X) @ W`` without ever
  materialising ``allgather(X)``: each ring step multiplies the resident
  X chunk by the local W shard while the next chunk is in flight.
- ``matmul_reduce_scatter``: ``Y = reducescatter_rows(X @ W)`` without the
  full partial product: the float32 accumulator rotates around the ring
  and each rank adds its partial for the chunk passing through, computed
  while the accumulator was in flight.

Both are ``torch.autograd.Function``s with the reference's custom VJPs:
each primitive's dX is the other primitive, the dW reduction is one more
ring, accumulated in float32.  Per-rank primitives: ``axis_name`` names
an axis of the mesh (default: the ambient mesh), ``axis_size`` its size.

Overlap: the rotation for step s+1 is issued (``permute_start``, an async
handle) before step s's chunk product, and waited for after it.  The
reference's last rotation, redundant in exact arithmetic, is not issued.
The chunk products are plain ``torch.matmul``, as the reference computes
them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import Mesh, get_ambient_mesh


def _ring_group(axis_name: str, axis_size: int, mesh: Optional[Mesh]):
    m = mesh if mesh is not None else get_ambient_mesh()
    have = 1 if m is None else m.shape.get(axis_name, 1)
    if have != axis_size:
        raise ValueError(f"axis {axis_name!r} has size {have} in the mesh, "
                         f"not {axis_size}")
    return m.group(axis_name) if axis_size > 1 else None


class _Rotation:
    """A rotation in flight: ``wait()`` gives the next resident blocks."""

    def __init__(self, starts):
        self.starts = starts

    def wait(self):
        return tuple(s.wait() for s in self.starts)


def _rotate(rotating: Tuple[torch.Tensor, ...], axis_name: str, n: int,
            mesh: Optional[Mesh], grad: bool) -> _Rotation:
    perm = col.ring_perm(n)
    if grad:
        # under autograd: the differentiable permutation, whose backward
        # issues the inverse ring when it reaches the wait and waits for
        # it when it reaches the start
        return _Rotation([col.ppermute_start(r, axis_name, perm, mesh)
                          for r in rotating])
    g = _ring_group(axis_name, n, mesh)
    return _Rotation([g.permute_start(r, perm) for r in rotating])


def ring_scan(body: Callable[[int, Any, Any], Any], carry: Any,
              rotating: Any, *, axis_name: str, axis_size: int,
              mesh: Optional[Mesh] = None) -> Any:
    """Run ``axis_size`` steps of a ring over ``rotating`` (a tensor or a
    tuple of them).

    ``body(step, carry, rotating) -> carry`` consumes the block resident
    at this step: after step s this rank holds the block that started s
    hops upstream (source ``(me - s) % n`` on the ``d → d+1`` ring).  The
    rotation for step s+1 is issued BEFORE body runs and waited for after
    it, so the transfer overlaps body's compute; under autograd the
    backward overlaps the same way (the inverse rotation is issued before
    body's backward and waited for after it)."""
    single = isinstance(rotating, torch.Tensor)
    blocks = (rotating,) if single else tuple(rotating)
    grad = torch.is_grad_enabled() and any(b.requires_grad for b in blocks)
    for step in range(axis_size):
        nxt = _rotate(blocks, axis_name, axis_size, mesh, grad) \
            if step + 1 < axis_size else None
        carry = body(step, carry, blocks[0] if single else blocks)
        if nxt is not None:
            blocks = nxt.wait()
    return carry


def _chunk(x: torch.Tensor, i: int, t: int) -> torch.Tensor:
    """Rows ``[i*t, (i+1)*t)`` of x's second-to-last dim."""
    return x.narrow(-2, i * t, t)


def _xt_dot(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW partial: x (..., t, k) contracted with g (..., t, n) over every
    dim but the last → (k, n) float32."""
    return x.reshape(-1, x.shape[-1]).float().t() \
        @ g.reshape(-1, g.shape[-1]).float()


def _ag_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str, n: int,
               mesh: Optional[Mesh]) -> torch.Tensor:
    if n == 1:
        return x @ w
    t = x.shape[-2]
    me = col.axis_index(axis_name, mesh)
    out = x.new_empty(x.shape[:-2] + (t * n, w.shape[-1]),
                      dtype=torch.result_type(x, w))

    def body(step, out, xc):
        src = (me - step) % n
        _chunk(out, src, t).copy_(xc @ w)
        return out

    return ring_scan(body, out, x, axis_name=axis_name, axis_size=n,
                     mesh=mesh)


def _mm_rs(x: torch.Tensor, w: torch.Tensor, axis_name: str, n: int,
           mesh: Optional[Mesh]) -> torch.Tensor:
    """Chunk c is born at rank c+1 (its partial, no add), rides the ring
    through c+2 ... and ends at rank c having accumulated every rank's
    partial: at step s rank d adds its partial for chunk (d - 1 - s) % n.
    The permutation for step s is issued before step s's partial product."""
    out_dtype = torch.result_type(x, w)
    if n == 1:
        return (x @ w).to(out_dtype)
    t = x.shape[-2] // n
    me = col.axis_index(axis_name, mesh)
    g = _ring_group(axis_name, n, mesh)
    perm = col.ring_perm(n)
    acc = (_chunk(x, (me - 1) % n, t) @ w).float()
    for step in range(1, n):
        pending = g.permute_start(acc, perm)
        part = _chunk(x, (me - 1 - step) % n, t) @ w
        acc = pending.wait() + part.float()
    return acc.to(out_dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis_name, n, mesh):
        ctx.save_for_backward(x, w)
        ctx.axis_name, ctx.n, ctx.mesh = axis_name, n, mesh
        return _ag_matmul(x, w, axis_name, n, mesh)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        a, n, mesh = ctx.axis_name, ctx.n, ctx.mesh
        # dX: every rank's W shard saw every X chunk, so chunk j's grad is
        # the sum over ranks of g[chunk j] @ Wᵀ: a matmul-reduce-scatter
        dx = _mm_rs(g, w.t(), a, n, mesh).to(x.dtype)
        if n == 1:
            return dx, _xt_dot(x, g).to(w.dtype), None, None, None
        # dW = gathered(X)ᵀ @ g: one more ring over the X chunks
        t = x.shape[-2]
        me = col.axis_index(a, mesh)

        def body(step, dw, xc):
            return dw + _xt_dot(xc, _chunk(g, (me - step) % n, t))

        dw = ring_scan(body, torch.zeros(w.shape, dtype=torch.float32,
                                         device=w.device),
                       x, axis_name=a, axis_size=n, mesh=mesh)
        return dx, dw.to(w.dtype), None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis_name, n, mesh):
        ctx.save_for_backward(x, w)
        ctx.axis_name, ctx.n, ctx.mesh = axis_name, n, mesh
        return _mm_rs(x, w, axis_name, n, mesh)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        a, n, mesh = ctx.axis_name, ctx.n, ctx.mesh
        # dX: the full row space from the per-rank chunk grads times Wᵀ:
        # an all-gather-matmul
        dx = _ag_matmul(g, w.t(), a, n, mesh).to(x.dtype)
        if n == 1:
            return dx, _xt_dot(x, g).to(w.dtype), None, None, None
        # dW = Xᵀ @ gathered(g): the local chunk grad rotates around the
        # ring, each step contracted with the matching rows of X
        t = g.shape[-2]
        me = col.axis_index(a, mesh)

        def body(step, dw, gc):
            return dw + _xt_dot(_chunk(x, (me - step) % n, t), gc)

        dw = ring_scan(body, torch.zeros(w.shape, dtype=torch.float32,
                                         device=w.device),
                       g.contiguous(), axis_name=a, axis_size=n, mesh=mesh)
        return dx, dw.to(w.dtype), None, None, None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                      axis_size: int, mesh: Optional[Mesh] = None
                      ) -> torch.Tensor:
    """x (..., t, k) local rows; w (k, n) local columns → (..., t·size,
    n): the gathered row space times this rank's W shard."""
    mesh = mesh if mesh is not None else get_ambient_mesh()
    _ring_group(axis_name, axis_size, mesh)
    # the mesh rides with the op: its backward may run outside the
    # ambient mesh's context
    return _AllGatherMatmul.apply(x, w, axis_name, axis_size, mesh)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                          axis_size: int, mesh: Optional[Mesh] = None
                          ) -> torch.Tensor:
    """x (..., t·size, k) this rank's partial operand over the full rows;
    w (k, n) → (..., t, n): the rows summed over the ring, this rank
    keeping chunk ``axis_index``."""
    mesh = mesh if mesh is not None else get_ambient_mesh()
    _ring_group(axis_name, axis_size, mesh)
    # the mesh rides with the op: its backward may run outside the
    # ambient mesh's context
    return _MatmulReduceScatter.apply(x, w, axis_name, axis_size, mesh)


# ---------------------------------------------------------------------------
# The un-decomposed pair: the numerics oracle, and the serialised
# collective legs (one all-gather, one reduce-scatter) the decomposition
# replaces.
# ---------------------------------------------------------------------------

def all_gather_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                                axis_name: str, axis_size: int,
                                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One all-gather, one matmul."""
    _ring_group(axis_name, axis_size, mesh)
    return col.all_gather(x, axis_name, dim=-2, mesh=mesh) @ w


def matmul_reduce_scatter_reference(x: torch.Tensor, w: torch.Tensor,
                                    axis_name: str, axis_size: int,
                                    mesh: Optional[Mesh] = None
                                    ) -> torch.Tensor:
    """One matmul, one reduce-scatter."""
    _ring_group(axis_name, axis_size, mesh)
    return col.psum_scatter(x @ w, axis_name, dim=-2, mesh=mesh)


def model_parallel_sizes(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(seq, tensor) axis sizes of a mesh (1 when absent): the gate the
    model uses to decide whether the decomposed path is live."""
    shape = getattr(mesh, "shape", None) or {}
    return int(shape.get("seq", 1)), int(shape.get("tensor", 1))
