"""Mixture-of-Experts feed-forward (port of ``ray_tpu/ops/moe.py``).

Top-k gating with a load-balancing loss and a router z-loss, a fixed
expert capacity with token dropping, then the experts' two products and
the gated combine: the reference's function, with the reference's
layouts (tokens ``(B, S, d)``, router ``(d, E)``, experts ``(E, d, ff)``
and ``(E, ff, d)``).

The reference dispatches and combines by einsums against one-hot
``(N, E, C)`` tensors, which suits the TPU's matrix unit.  On the card
``moe_ffn`` takes the index form instead: every (expert, slot) holds at
most one token and every token sums at most ``k`` gated terms, so a
gather of the tokens into ``(E, C, d)`` by slot and a gather of each
token's ``k`` expert outputs compute the same values.  At ``moe-small``'s
b8 x s1024 (N 8192, E 8, C 2560) the einsums would cost 258 GFLOP each a
layer, more than the experts' 193, and move a 336-671 MB one-hot tensor.
The combine sums its ``k`` products of bf16 values in float32 and rounds
once, as the einsum does, so in bf16 the two forms agree bitwise.  The
einsum form stays beside it as ``moe_ffn_plain``, the plain version the
tests and ``chip_smoke.py`` hold the index form to.  Neither is a Pallas
kernel in the reference, and neither is a kernel here.

Nothing here syncs with the host: the routing is computed on the device
at fixed shapes (dropped assignments go to a discarded slot), so the
train step keeps ``torch.cuda.set_sync_debug_mode("error")``.

Over an ambient mesh of ranks (``parallel/mesh.py``) the op reproduces
the reference's function, whatever GSPMD made of it.  Under
``MOE_RULES`` the tokens split over the batch axes (``data``, ``fsdp``)
and the sequence over ``context``, and are replicated over ``expert``
and ``tensor``; rank (d, e, t) holds experts ``e·X/ep … (e+1)·X/ep``,
and of each the ff columns ``t·ff/tp … (t+1)·ff/tp``.  The expert FFN
is row-wise, and ``gelu`` acts column by column, so a rank runs exactly
its own tokens through its own experts' ff slice (the index form), and
the partial combine is summed over ``expert`` and ``tensor`` at once
(``collectives.psum``, in float32, rounded once): no all-to-all.
``pipeline`` and ``seq`` (no rule splits the op over them) compute the
same rows on every rank.  Routing stays global: the capacity is
``expert_capacity`` of the GLOBAL token count, and a token's queue
position counts the assigned tokens before it in the reference's
flattened (b, s) order.  Under ``context`` a rank's tokens are not one
run of that order, so the count before each of its rows comes from an
all-gather of every rank's per-row (X,) counts over the token axes
(``_route``).  The load-balance loss, the z-loss and the dropped
fraction are means over every token (sums over the token axes).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (scalar)
    router_z_loss: torch.Tensor  # logit magnitude regularizer (scalar)
    fraction_dropped: torch.Tensor


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots, a multiple of 8 (the reference's tiling,
    kept because it decides which tokens drop)."""
    cap = int(math.ceil(k * num_tokens * capacity_factor / num_experts))
    return max(8, -(-cap // 8) * 8)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, ties
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_router(x: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token → expert assignment.

    x: (N, d) tokens; w_router: (d, E).  Returns (gates (N, E) with zeros
    off the top-k, logits (N, E), topk_idx (N, k)).  Logits and softmax in
    float32 whatever the activation dtype; the kept gates renormalised to
    sum to 1."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    topk_vals, topk_idx = _top_k(probs, k)
    gates = torch.zeros_like(probs).scatter(-1, topk_idx, topk_vals)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, logits, topk_idx


def _queue_positions(gates: torch.Tensor, capacity: int,
                     prefix: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(assigned (N, E), position of each token in each expert's queue
    (N, E), kept (N, E)): position is assignment order, a cumsum over
    tokens in their flattened (B·S) order, after ``prefix`` ((N, E):
    each token's count of other ranks' tokens before it); past
    ``capacity`` a token is dropped from that expert."""
    assigned = gates > 0.0
    # the scan runs along the inner dim of the (E, N) transpose: a scan
    # down N rows of only E columns leaves the card idle
    pos = torch.cumsum(assigned.t().to(torch.int32).contiguous(), dim=1,
                       dtype=torch.int32).t() - 1
    if prefix is not None:
        pos = pos + prefix
    return assigned, pos, assigned & (pos < capacity)


def _dispatch_tensors(gates: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's one-hot form: (dispatch (N, E, C) in the gates'
    dtype, combine (N, E, C), dropped (N,) bool)."""
    assigned, pos, keep = _queue_positions(gates, capacity)
    slot = torch.where(keep, pos, -1)
    pos_oh = (slot[..., None] == torch.arange(
        capacity, device=gates.device)).to(gates.dtype)       # (N, E, C)
    combine = pos_oh * gates[..., None]
    dropped = assigned.any(-1) & ~keep.any(-1)
    return pos_oh, combine, dropped


def load_balance_loss(gates: torch.Tensor, logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-style aux loss, E · Σ_e fraction_tokens_e · mean_prob_e, and
    the router z-loss, mean(logsumexp(logits)²)."""
    E = gates.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = (gates > 0).float().mean(0)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return aux, z


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default form (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def _experts(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             activation: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
    """(E, C, d) → (E, C, d): "ecd,edf->ecf", the activation, then
    "ecf,efd->ecd", as batched products over the experts."""
    return torch.bmm(activation(torch.bmm(xe, w_in)), w_out)


def _ffn_einsum(tokens, gates, cap, w_in, w_out, activation):
    dispatch, combine, dropped = _dispatch_tensors(gates, cap)
    xe = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype), tokens)
    ye = _experts(xe, w_in, w_out, activation)
    y = torch.einsum("nec,ecd->nd", combine.to(tokens.dtype), ye)
    return y, dropped


def _ffn_index(tokens, gates, topk_idx, cap, w_in, w_out, activation,
               route: Optional["_Route"] = None):
    """The index form; under a mesh (``route``) this rank's tokens through
    its experts alone, the combine returned in float32 (the caller sums
    it over ``expert``)."""
    N, d = tokens.shape
    k = topk_idx.shape[1]
    dev = tokens.device
    prefix = None if route is None else route.prefix
    assigned, pos, keep = _queue_positions(gates, cap, prefix)
    # this rank's experts [e0, e0 + E) and C slots an expert: a rank's own
    # tokens fill at most N of an expert's global queue
    e0, E = (0, gates.shape[1]) if route is None else (route.e0, route.ne)
    C = cap if route is None else min(cap, N)
    local = topk_idx - e0
    mine = (local >= 0) & (local < E)
    # each (token, choice)'s slot e·C + position (its own queue position
    # past the lower ranks'), or E·C (a discarded slot) where the
    # assignment was dropped, never made, or another rank's expert's
    kept = keep.gather(1, topk_idx) & mine                       # (N, k)
    qpos = pos.gather(1, topk_idx)
    if prefix is not None:
        qpos = qpos - prefix.gather(1, topk_idx)
    slot = torch.where(kept, local * C + qpos, E * C)
    # slot → token, -1 where empty; only the discarded slot repeats
    owner = torch.full((E * C + 1,), -1, dtype=torch.long, device=dev)
    owner.scatter_(0, slot.flatten(),
                   torch.arange(N, device=dev).repeat_interleave(k))
    owner = owner[:-1]
    filled = owner >= 0
    # The gathers are index_selects, whose backward adds with index_add:
    # a token's row receives its <= k slots' gradients, which in any
    # order sum to the same float32 value.  An empty slot reads a token
    # of its own (slot mod N, so no row takes many) and is zeroed.  The
    # dispatch gathers in float32, so its backward sums a token's slots
    # in float32 and rounds once, as the einsum's product does.
    src = torch.where(filled, owner,
                      torch.arange(E * C, device=dev) % N)
    xe = tokens.float().index_select(0, src)
    xe = torch.where(filled[:, None], xe, 0.0).to(tokens.dtype)
    ye = _experts(xe.view(E, C, d), w_in, w_out, activation)
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    # the gates rounded to the activation dtype (the reference's
    # combine.astype(x.dtype)), the k products summed in float32
    g = gates.gather(1, topk_idx).to(tokens.dtype).float()       # (N, k)
    picked = ye.index_select(0, slot.flatten()).view(N, k, d)
    y = (g[..., None] * picked.float()).sum(1)
    dropped = assigned.any(-1) & ~keep.any(-1)
    return (y if route is not None else y.to(tokens.dtype)), dropped


class _Route(NamedTuple):
    """A rank's part of the global routing: its first expert and expert
    count, and for each of its tokens, the assigned tokens before its
    row in each expert's queue that are not this rank's earlier rows
    ((N, E) int32: added to the local cumsum, it gives the global queue
    position)."""
    e0: int
    ne: int
    prefix: torch.Tensor


def _live_mesh():
    from ray_tpu_torch.parallel.mesh import get_ambient_mesh
    m = get_ambient_mesh()
    return m if m is not None and m.size > 1 else None


def _token_axes(mesh) -> Tuple[str, ...]:
    """The axes that split the op's tokens: the batch axes, then
    ``context``."""
    ctx = ("context",) if mesh.shape["context"] > 1 else ()
    return tuple(mesh.config.batch_axes()) + ctx


def _route(mesh, gates: torch.Tensor, rows: int) -> _Route:
    """This rank's ``_Route``: its slice of the experts by its ``expert``
    coordinate, and the count of assigned tokens before each of its
    ``rows`` (one all-gather of the (rows, E) per-row counts over
    ``context`` and the batch axes).  Global row g of context chunk c
    follows every chunk of the rows before it and the lower chunks of
    its own row: the exclusive prefix over (row, chunk) in that order."""
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import mesh as mesh_lib
    X = gates.shape[1]
    ep, e = mesh.shape["expert"], mesh.coords["expert"]
    e0, e1 = mesh_lib.shard_bounds(X, ep, e)
    axes = mesh.config.batch_axes()
    cp, c = mesh.shape["context"], mesh.coords["context"]
    with torch.no_grad():
        per_row = (gates > 0).view(rows, -1, X).sum(1, dtype=torch.int32)
        counts = col.all_gather(per_row[None, None], "context", 1, mesh)
        for a in reversed(axes):          # inner first: row-major order
            counts = col.all_gather(counts, a, 0, mesh)
        # (batch ranks, cp, rows, X) -> (global rows x cp, X) in order
        order = counts.permute(0, 2, 1, 3).reshape(-1, X)
        before = torch.cumsum(order, 0, dtype=torch.int32) - order
        _, b = mesh_lib.entry_coordinate(mesh, axes)
        mine = before.view(-1, cp, X)[b * rows:(b + 1) * rows, c]
        local = torch.cumsum(per_row, 0, dtype=torch.int32) - per_row
        prefix = (mine - local).repeat_interleave(gates.shape[0] // rows, 0)
    return _Route(e0, e1 - e0, prefix)


def _moe(x, w_router, w_in, w_out, k, capacity_factor, activation, ffn,
         mesh=None) -> Tuple[torch.Tensor, MoEMetrics]:
    B, S, d = x.shape
    E = w_router.shape[-1]
    N = B * S
    tokens = x.reshape(N, d)
    gates, logits, topk_idx = topk_router(tokens, w_router, k)
    if mesh is None:
        cap = expert_capacity(N, E, k, capacity_factor)
        y, dropped = ffn(tokens, gates, topk_idx, cap, w_in, w_out,
                         activation)
        aux, z = load_balance_loss(gates, logits)
        metrics = MoEMetrics(aux_loss=aux, router_z_loss=z,
                             fraction_dropped=dropped.float().mean())
        return y.reshape(B, S, d), metrics
    return _moe_mesh(x, tokens, gates, logits, topk_idx, w_in, w_out, k,
                     capacity_factor, activation, mesh)


def _moe_mesh(x, tokens, gates, logits, topk_idx, w_in, w_out, k,
              capacity_factor, activation, mesh
              ) -> Tuple[torch.Tensor, MoEMetrics]:
    """``_moe`` over a mesh of ranks (the module docstring)."""
    from ray_tpu_torch.parallel import collectives as col
    B, S, d = x.shape
    N, E = tokens.shape[0], gates.shape[1]
    axes = _token_axes(mesh)
    n_global = N * math.prod(mesh.shape[a] for a in axes)
    cap = expert_capacity(n_global, E, k, capacity_factor)
    route = _route(mesh, gates, B)
    if w_in.shape[0] != route.ne or w_out.shape[0] != route.ne:
        raise ValueError(f"this rank holds experts {route.e0}.."
                         f"{route.e0 + route.ne} of {E}, but w_in / w_out "
                         f"lead with {w_in.shape[0]} / {w_out.shape[0]}")
    y, dropped = _ffn_index(tokens, gates, topk_idx, cap, w_in, w_out,
                            activation, route)
    y = col.psum(y, ("expert", "tensor"), mesh).to(x.dtype)
    probs = torch.softmax(logits, dim=-1)
    frac = col.psum((gates > 0).float().sum(0), axes, mesh) / n_global
    mean_prob = col.psum(probs.sum(0), axes, mesh) / n_global
    aux = E * torch.sum(frac * mean_prob)
    z = col.psum((torch.logsumexp(logits, dim=-1) ** 2).sum(), axes,
                 mesh) / n_global
    dropped = col.psum(dropped.float().sum(), axes, mesh) / n_global
    return y.reshape(B, S, d), MoEMetrics(aux_loss=aux, router_z_loss=z,
                                          fraction_dropped=dropped)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, k: int = 2,
            capacity_factor: float = 1.25,
            activation: Callable[[torch.Tensor], torch.Tensor] = gelu_tanh
            ) -> Tuple[torch.Tensor, MoEMetrics]:
    """Expert feed-forward block, the index form (gathers by slot).

    x: (B, S, d).  w_router: (d, E).  w_in: (E, d, ff).  w_out: (E, ff,
    d).  Under an ambient mesh of ranks: x this rank's rows (and its
    ``context`` chunk of the sequence), w_in / w_out its slice of the
    experts and of their ff columns (``MOE_RULES``), y its rows, the
    metrics global (the module docstring)."""
    return _moe(x, w_router, w_in, w_out, k, capacity_factor, activation,
                _ffn_index, _live_mesh())


def moe_ffn_plain(x: torch.Tensor, w_router: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor, *, k: int = 2,
                  capacity_factor: float = 1.25,
                  activation: Callable[[torch.Tensor], torch.Tensor]
                  = gelu_tanh) -> Tuple[torch.Tensor, MoEMetrics]:
    """``moe_ffn`` in the reference's einsum form (one-hot dispatch and
    combine products): the plain version the index form is held to, on
    one device."""
    return _moe(x, w_router, w_in, w_out, k, capacity_factor, activation,
                lambda tokens, gates, _idx, cap, *rest: _ffn_einsum(
                    tokens, gates, cap, *rest))


# Sharding rules for MoE params: (path regex, PartitionSpec entries),
# the reference's; compose with the transformer rules by prepending
# (first match wins; the stacked-per-layer variants first).
MOE_RULES = [
    (r".*blocks/moe/router$", ("pipeline", None, None)),
    (r".*blocks/moe/w_in$", ("pipeline", "expert", "fsdp", "tensor")),
    (r".*blocks/moe/w_out$", ("pipeline", "expert", "tensor", "fsdp")),
    (r".*moe/router$", (None, None)),
    (r".*moe/w_in$", ("expert", "fsdp", "tensor")),
    (r".*moe/w_out$", ("expert", "tensor", "fsdp")),
]


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Random expert params drawn from ``gen`` on its device, with the
    reference's shapes and scales (router N(0, 0.02²), w_in 1/√d_model,
    w_out 1/√d_ff)."""
    # imported here: ``models._common`` loads the ``models`` package,
    # whose ``moe_transformer`` imports this module (a cycle when this
    # module is imported first)
    from ray_tpu_torch.models._common import normal_init
    return {
        "router": normal_init(gen, (d_model, num_experts), dtype, 0.02),
        "w_in": normal_init(gen, (num_experts, d_model, d_ff), dtype,
                            1.0 / math.sqrt(d_model)),
        "w_out": normal_init(gen, (num_experts, d_ff, d_model), dtype,
                             1.0 / math.sqrt(d_ff)),
    }
