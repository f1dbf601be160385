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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models._common import normal_init


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


def _queue_positions(gates: torch.Tensor, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(assigned (N, E), position of each token in each expert's queue
    (N, E), kept (N, E)): position is assignment order, a cumsum over
    tokens in their flattened (B·S) order; past ``capacity`` a token is
    dropped from that expert."""
    assigned = gates > 0.0
    # the scan runs along the inner dim of the (E, N) transpose: a scan
    # down N rows of only E columns leaves the card idle
    pos = torch.cumsum(assigned.t().to(torch.int32).contiguous(), dim=1,
                       dtype=torch.int32).t() - 1
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


def _ffn_index(tokens, gates, topk_idx, cap, w_in, w_out, activation):
    N, d = tokens.shape
    E, k = gates.shape[1], topk_idx.shape[1]
    dev = tokens.device
    assigned, pos, keep = _queue_positions(gates, cap)
    # each (token, choice)'s slot e·C + position, or E·C (a discarded
    # slot) where the assignment was dropped or never made
    kept = keep.gather(1, topk_idx)                              # (N, k)
    slot = torch.where(kept, topk_idx * cap + pos.gather(1, topk_idx),
                       E * cap)
    # slot → token, -1 where empty; only the discarded slot repeats
    owner = torch.full((E * cap + 1,), -1, dtype=torch.long, device=dev)
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
                      torch.arange(E * cap, device=dev) % N)
    xe = tokens.float().index_select(0, src)
    xe = torch.where(filled[:, None], xe, 0.0).to(tokens.dtype)
    ye = _experts(xe.view(E, cap, d), w_in, w_out, activation)
    ye = torch.cat([ye.reshape(E * cap, d), ye.new_zeros((1, d))])
    # the gates rounded to the activation dtype (the reference's
    # combine.astype(x.dtype)), the k products summed in float32
    g = gates.gather(1, topk_idx).to(tokens.dtype).float()       # (N, k)
    picked = ye.index_select(0, slot.flatten()).view(N, k, d)
    y = (g[..., None] * picked.float()).sum(1).to(tokens.dtype)
    dropped = assigned.any(-1) & ~keep.any(-1)
    return y, dropped


def _moe(x, w_router, w_in, w_out, k, capacity_factor, activation, ffn
         ) -> Tuple[torch.Tensor, MoEMetrics]:
    B, S, d = x.shape
    E = w_router.shape[-1]
    N = B * S
    tokens = x.reshape(N, d)
    gates, logits, topk_idx = topk_router(tokens, w_router, k)
    cap = expert_capacity(N, E, k, capacity_factor)
    y, dropped = ffn(tokens, gates, topk_idx, cap, w_in, w_out, activation)
    aux, z = load_balance_loss(gates, logits)
    metrics = MoEMetrics(aux_loss=aux, router_z_loss=z,
                         fraction_dropped=dropped.float().mean())
    return y.reshape(B, S, d), metrics


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, k: int = 2,
            capacity_factor: float = 1.25,
            activation: Callable[[torch.Tensor], torch.Tensor] = gelu_tanh
            ) -> Tuple[torch.Tensor, MoEMetrics]:
    """Expert feed-forward block, the index form (gathers by slot).

    x: (B, S, d).  w_router: (d, E).  w_in: (E, d, ff).  w_out: (E, ff,
    d)."""
    return _moe(x, w_router, w_in, w_out, k, capacity_factor, activation,
                _ffn_index)


def moe_ffn_plain(x: torch.Tensor, w_router: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor, *, k: int = 2,
                  capacity_factor: float = 1.25,
                  activation: Callable[[torch.Tensor], torch.Tensor]
                  = gelu_tanh) -> Tuple[torch.Tensor, MoEMetrics]:
    """``moe_ffn`` in the reference's einsum form (one-hot dispatch and
    combine products): the plain version the index form is held to."""
    return _moe(x, w_router, w_in, w_out, k, capacity_factor, activation,
                lambda tokens, gates, _idx, cap, *rest: _ffn_einsum(
                    tokens, gates, cap, *rest))


# Sharding rules for MoE params, as data: (path regex, PartitionSpec
# entries).  Meshes are the multi-GPU slice's work; the rules are kept so
# that slice applies them as the reference does (first match wins; the
# stacked-per-layer variants first).
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
    return {
        "router": normal_init(gen, (d_model, num_experts), dtype, 0.02),
        "w_in": normal_init(gen, (num_experts, d_model, d_ff), dtype,
                            1.0 / math.sqrt(d_model)),
        "w_out": normal_init(gen, (num_experts, d_ff, d_model), dtype,
                             1.0 / math.sqrt(d_ff)),
    }
