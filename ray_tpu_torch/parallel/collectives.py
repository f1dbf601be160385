"""Per-axis collectives over a mesh's ranks (the port's counterpart of the
``jax.lax`` collectives the reference calls inside ``shard_map``).

Every function takes this rank's tensor and a mesh axis name, resolves
the axis's group from ``mesh`` (default: the ambient mesh,
``mesh.get_ambient_mesh()``), and returns this rank's result.  On an
axis of size 1 (or with no mesh) each is its single-device meaning.

Each differentiable one is a ``torch.autograd.Function`` whose backward
is its transpose collective, so a per-rank program's autograd gives, on
every rank, the gradient of the SUM over ranks of what each rank's
output feeds (the reference's ``shard_map`` transpose rules):

- ``ppermute``'s backward is the inverse permutation (``ppermute_start``
  issues it and returns a handle, forward and backward);
- ``all_gather`` (tiled) and ``psum_scatter`` are each other's backward;
  ``all_gather_uneven`` (ceil-sized pieces, the last short) is
  backed by a padded reduce-scatter in float32;
- ``all_to_all``'s backward swaps the split and concat dims;
- ``psum``'s backward is ``psum``;
- ``broadcast``'s backward sums every rank's gradient onto the source
  (the others' inputs get none).

``pmax`` has no gradient (a stabiliser).  Every rank must call the same
collectives in the same order, forward and backward.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel.mesh import Mesh, get_ambient_mesh
from ray_tpu_torch.util.collective.types import ReduceOp

Axes = Union[str, Sequence[str]]


def _mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return mesh if mesh is not None else get_ambient_mesh()


def axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    m = _mesh(mesh)
    return 1 if m is None else m.shape.get(axis, 1)


def axis_index(axis: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's coordinate along ``axis``."""
    m = _mesh(mesh)
    return 0 if m is None else m.coords.get(axis, 0)


def _group(axis: str, mesh: Optional[Mesh]):
    m = _mesh(mesh)
    if m is None or m.shape.get(axis, 1) == 1:
        return None
    return m.group(axis)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def ring_perm(n: int) -> Tuple[Tuple[int, int], ...]:
    """The canonical ring ``d → d + 1``."""
    return tuple((d, (d + 1) % n) for d in range(n))


def _chunks(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """(n, ...): ``x`` cut into n equal pieces along ``dim``, stacked."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split {n} ways")
    return torch.stack(x.chunk(n, dim=dim))


def _all_gather(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return torch.cat(g.all_gather(x), dim=dim)


def _psum_scatter(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return g.reduce_scatter(_chunks(x, g.world_size, dim))


def _all_to_all(x: torch.Tensor, g, split: int, concat: int
                ) -> torch.Tensor:
    rows = g.all_to_all(_chunks(x, g.world_size, split))
    return torch.cat(rows.unbind(0), dim=concat)


class _Transfer:
    """A permutation in flight between ``_PermuteStart`` and
    ``_PermuteWait``: the forward's pending receive, then the backward's
    (the inverse permutation of the output's gradient)."""
    fwd = bwd = None


class _PermuteStart(torch.autograd.Function):
    """Issues the permutation; returns an empty token that orders the
    wait after it.  Backward: waits for the inverse permutation that
    ``_PermuteWait``'s backward issued (``x``'s gradient)."""

    @staticmethod
    def forward(ctx, x, g, pairs, box):
        ctx.box = box
        box.fwd = g.permute_start(x, pairs)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, _token):
        gx, ctx.box.bwd = ctx.box.bwd.wait(), None
        return gx, None, None, None


class _PermuteWait(torch.autograd.Function):
    """Waits for the permutation ``_PermuteStart`` issued.  Backward:
    issues the inverse permutation of the output's gradient, and returns
    at once, so the gradients of what ran between the start and the wait
    are computed while it is in flight."""

    @staticmethod
    def forward(ctx, token, g, pairs, box):
        ctx.g, ctx.pairs, ctx.box = g, pairs, box
        out, box.fwd = box.fwd.wait(), None
        return out

    @staticmethod
    def backward(ctx, gy):
        inv = tuple((d, s) for s, d in ctx.pairs)
        ctx.box.bwd = ctx.g.permute_start(gy.contiguous(), inv)
        return gy.new_empty(0), None, None, None


class Permutation:
    """A ``ppermute`` in flight: ``wait()`` gives the received tensor,
    differentiable (its gradient rides the inverse permutation, issued
    when the backward reaches ``wait`` and waited for when it reaches
    the start)."""

    def __init__(self, x: torch.Tensor, g, pairs):
        self.g, self.pairs, self.box = g, pairs, _Transfer()
        if g is None:
            self.out = x if (0, 0) in pairs else torch.zeros_like(x)
        else:
            self.token = _PermuteStart.apply(x, g, pairs, self.box)

    def wait(self) -> torch.Tensor:
        if self.g is None:
            return self.out
        return _PermuteWait.apply(self.token, self.g, self.pairs, self.box)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _psum_scatter(gy, ctx.g, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _psum_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _all_gather(gy, ctx.g, ctx.dim), None, None


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    short = size - x.shape[dim]
    if short == 0:
        return x
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


class _AllGatherUneven(torch.autograd.Function):
    """Pieces of at most ``piece`` along ``dim``, padded to it, gathered
    and cut to ``total``.  Backward: the gradient padded back to the
    pieces' layout, reduce-scattered in float32, this rank's piece cut
    out and rounded once to the input's dtype."""

    @staticmethod
    def forward(ctx, x, g, dim, total, piece):
        ctx.g, ctx.dim, ctx.piece = g, dim, piece
        ctx.n, ctx.dtype = x.shape[dim], x.dtype
        full = _all_gather(_pad_to(x, dim, piece), g, dim)
        return full.narrow(dim, 0, total)

    @staticmethod
    def backward(ctx, gy):
        d = ctx.dim
        gy = _pad_to(gy.float(), d, ctx.piece * ctx.g.world_size)
        gx = _psum_scatter(gy, ctx.g, d).narrow(d, 0, ctx.n)
        return gx.to(ctx.dtype), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split, concat):
        ctx.g, ctx.split, ctx.concat = g, split, concat
        return _all_to_all(x, g, split, concat)

    @staticmethod
    def backward(ctx, gy):
        return _all_to_all(gy, ctx.g, ctx.concat, ctx.split), None, None, \
            None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return g.all_reduce(x)

    @staticmethod
    def backward(ctx, gy):
        return ctx.g.all_reduce(gy), None


class _Broadcast(torch.autograd.Function):
    """The source's ``x`` cast to ``dtype`` on every rank of the group
    (elsewhere ``x`` only carries the graph).  Backward: the gradients
    summed in ``dtype`` onto the source, cast to ``x``'s dtype there."""

    @staticmethod
    def forward(ctx, x, g, src, shape, dtype):
        ctx.g, ctx.src, ctx.dtype = g, src, x.dtype
        buf = x.to(dtype).contiguous() if g.rank == src \
            else x.new_empty(shape, dtype=dtype)
        return g.broadcast(buf, src)

    @staticmethod
    def backward(ctx, gy):
        total = ctx.g.all_reduce(gy.contiguous())
        gx = total.to(ctx.dtype) if ctx.g.rank == ctx.src else None
        return gx, None, None, None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.ndim


def ppermute_start(x: torch.Tensor, axis: str,
                   perm: Sequence[Tuple[int, int]],
                   mesh: Optional[Mesh] = None) -> Permutation:
    """Issue ``ppermute(x, axis, perm)`` and return at once; ``wait()``
    on the result gives its value.  Every rank waits in the order it
    started."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    return Permutation(x, _group(axis, mesh), pairs)


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]],
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` sent along ``perm`` ((src, dst) coordinates of ``axis``); a
    rank no one sends to gets zeros."""
    return ppermute_start(x, axis, perm, mesh).wait()


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (the
    reference's ``all_gather(tiled=True)``)."""
    g = _group(axis, mesh)
    return x if g is None else _AllGather.apply(x, g, _dim(x, dim))


def all_gather_uneven(x: torch.Tensor, axis: str, dim: int, total: int,
                      piece: int, mesh: Optional[Mesh] = None
                      ) -> torch.Tensor:
    """Every rank's piece of a dim of ``total`` cut in ``piece``-sized
    pieces (``mesh.shard_bounds``: the last short, or empty),
    concatenated along ``dim`` in axis order; no piece is trusted to be
    full.  The backward reduce-scatters in float32 (ZeRO-3's gradient of
    a gathered weight)."""
    g = _group(axis, mesh)
    if g is None:
        return x
    if x.shape[dim % x.ndim] > piece:
        raise ValueError(f"a piece of {x.shape[dim % x.ndim]} along dim "
                         f"{dim} is larger than {piece}")
    return _AllGatherUneven.apply(x, g, _dim(x, dim), total, piece)


def broadcast(x: torch.Tensor, axis: str, src: int, shape: Sequence[int],
              dtype: Optional[torch.dtype] = None,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The tensor of shape ``shape`` that the rank at coordinate ``src``
    of ``axis`` holds as ``x``, in ``dtype`` (default ``x``'s), on every
    rank of the axis; elsewhere ``x`` is a placeholder whose gradient is
    none.  The backward sums the ranks' gradients onto ``src``."""
    g = _group(axis, mesh)
    dtype = dtype or x.dtype
    if g is None:
        return x.to(dtype)
    return _Broadcast.apply(x, g, int(src), tuple(shape), dtype)


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum over ranks of ``x``, cut along ``dim``; this rank keeps
    piece ``axis_index`` (``psum_scatter(tiled=True)``)."""
    g = _group(axis, mesh)
    return x if g is None else _PsumScatter.apply(x, g, _dim(x, dim))


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` cut along ``split_dim``, piece j to rank j; the pieces that
    come in concatenated along ``concat_dim`` (``all_to_all(tiled=True)``)."""
    g = _group(axis, mesh)
    if g is None:
        return x
    return _AllToAll.apply(x, g, _dim(x, split_dim), _dim(x, concat_dim))


def psum(x: torch.Tensor, axes: Axes,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum over the ranks of every axis in ``axes``."""
    for axis in _axes(axes):
        g = _group(axis, mesh)
        if g is not None:
            x = _Psum.apply(x, g)
    return x


def pmax(x: torch.Tensor, axes: Axes,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes``; no gradient."""
    x = x.detach()
    for axis in _axes(axes):
        g = _group(axis, mesh)
        if g is not None:
            x = g.all_reduce(x, ReduceOp.MAX)
    return x
