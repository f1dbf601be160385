"""Train-program assembly on one device or over a mesh of ranks (port of
``ray_tpu/parallel/spmd.py``).

``build_train_program(loss_fn=..., init_params_fn=...)`` returns an
``SpmdProgram`` whose ``init_fn(gen)`` makes a ``TrainState`` on the device
and whose ``step_fn(state, batch)`` runs forward, backward (with optional
in-step microbatch accumulation) and the optimizer, and returns the state
and ``{"loss", "grad_norm", "step"}``.

Differences from the reference, each forced by the port:
- PyTorch runs eagerly: there is no jit, and ``step_fn`` updates the
  params and optimizer moments IN PLACE (the counterpart of
  ``donate_state``), returning the same ``TrainState`` object.
- The metrics are device tensors and nothing in a step syncs with the
  host; read them after the step.  ``step_fn`` runs inside the
  ``train.step`` region of the step-hygiene oracle
  (``_private/xla_watchdog.py``, armed by ``RTT_XLA_WATCHDOG=1``), as in
  the reference: a host read inside the step raises, and so does a
  second batch signature (shapes, dtypes) for one program.
- Over a mesh (``parallel/mesh.py``: a ``Mesh``, or a ``mesh_config``
  inside a ``torch.distributed`` domain) each rank holds its slice of the
  state under ``rules`` and runs the per-rank program; GSPMD derived the
  reference's collectives, the port inserts them.  ``loss_fn`` runs with
  the mesh ambient on this rank's batch rows and returns the GLOBAL loss,
  the same on every rank (the port's models' ``loss_fn`` do).  Each
  collective's backward is its transpose, so a rank's gradient is that of
  the sum over ranks of their losses; the step sums each leaf's gradient
  over exactly the ranks that hold a copy of it (the axes its spec does
  not split) and divides by the number of ranks.  The global-norm clip
  and the reported ``grad_norm`` count a split leaf's squares once over
  its pieces and a replicated leaf's once.  AdamW's moments live on the
  local slice, in ``moments_dtype``.
- ZeRO-3 (``fsdp``): the model gathers each split leaf at use
  (``mesh.gather_for_use``), whose backward already reduce-scattered
  the gradient over ``fsdp`` onto the rank's piece; the step then sums
  it over the other axes that hold a copy (``data``, ``expert``), never
  over ``fsdp`` again, while a leaf replicated over ``fsdp`` (LayerNorm,
  the biases the rules leave whole, the router) is summed over it as
  over ``data``.  Both kinds are divided by the same number of ranks.
  The reduce-scatter sums in float32 and rounds once to the leaf's dtype
  (bf16 params included); the step's own sums ride one flat float32
  buffer an axis (``device_group.flatten``).
- Expert parallelism (``expert``): a rank holds its slice of the
  experts' leading axis; ``ops/moe.py`` sums the combine over
  ``expert``, and the step sums the rest over it as over ``data``.

An axis on which every rank computes the same rows is counted once, and
the one place that counts it is ``_mesh_reduce``'s division by the mesh
size (every collective's backward being its exact transpose).  Axis by
axis, what a rank's autograd gradient holds and what the step does:

- ``data``, ``fsdp``: ranks compute different rows; the loss's ``psum``
  over them transposes to a ``psum`` of the cotangent, so a rank's
  gradient is ``size`` times its rows' share; the step sums a copy over
  the axis (under ``fsdp`` the gather's reduce-scatter already did).
- ``tensor``, ``context``, ``expert``: a rank computes its part of the
  same rows (heads, vocab columns, ff columns, tokens, experts) and the
  parts meet in ``psum``s and gathers whose transposes route each
  part's gradient back; a leaf replicated over the axis (LayerNorm,
  RMSNorm scales, the router) is summed over it, and its copies are then
  equal.
- ``pipeline`` (Llama, the MoE transformer: no schedule) and ``seq``
  (the same two, where no ``context_axis`` names it): every rank
  computes the same loss on the same rows.  A leaf replicated over the
  axis gets its whole gradient on every rank, and the step's sum over
  the axis makes it ``size`` times; a layer split over ``pipeline`` gets
  the same from its gather's transpose (``mesh.gather_for_use``).  The
  division by the mesh size, which counts the axis, gives back the
  one-rank gradient: nothing else scales by it.  GPT-2's ``pipeline``
  is a schedule over microbatches and its ``seq`` a split sequence:
  neither computes the same rows twice.

``_mesh_norm`` sums a leaf's squares over the axes its spec splits and
once over the rest, so the clip and the reported norm are the one-rank
ones on every axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch._private.xla_watchdog import compile_budget, signature
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.parallel.mesh import (Mesh, MeshConfig, Rules,
                                         TRANSFORMER_RULES)
from ray_tpu_torch.parallel.optim import adamw_compact, apply_updates_mixed
from ray_tpu_torch.util.collective.collective_group import device_group

__all__ = ["TrainState", "MeshConfig", "SpmdProgram", "default_optimizer",
           "state_specs", "build_train_program", "shard_batch"]


@dataclass
class TrainState:
    step: torch.Tensor          # int32 scalar on the device
    params: Any
    opt_state: Any


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                      warmup: int = 100, total_steps: int = 10_000,
                      b2: float = 0.95, clip: float = 1.0,
                      moments_dtype: Optional[torch.dtype] = None
                      ) -> tx.GradientTransformation:
    """AdamW with a warmup-cosine schedule and global-norm clipping;
    ``moments_dtype`` (e.g. ``torch.bfloat16``) stores both Adam moments
    compactly, None keeps them float32."""
    sched = tx.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total_steps, warmup + 1), end_value=lr * 0.1)
    if moments_dtype is not None:
        return adamw_compact(sched, b1=0.9, b2=b2,
                             weight_decay=weight_decay, clip=clip,
                             mu_dtype=moments_dtype, nu_dtype=moments_dtype)
    return tx.chain(tx.clip_by_global_norm(clip),
                    tx.adamw(sched, b1=0.9, b2=b2,
                             weight_decay=weight_decay))


def state_specs(state: TrainState, rules: Rules) -> TrainState:
    """Specs for a TrainState: params by rules; a node of the optimizer
    state shaped as the params tree (AdamW's moments) takes their specs,
    every other leaf is replicated (``()``)."""
    pspecs = mesh_lib.param_specs(state.params, rules)

    def walk(node: Any) -> Any:
        if isinstance(node, dict) and sorted(node) == sorted(state.params):
            return tx.tree_map(lambda _, spec: spec, node, pspecs)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return out if isinstance(node, list) else tuple(out)
        return mesh_lib.P()

    return TrainState(step=mesh_lib.P(), params=pspecs,
                      opt_state=walk(state.opt_state))


def _spec_leaves(specs: Any) -> list:
    """A params spec tree's leaves, in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


@dataclass
class SpmdProgram:
    """The train step and where it runs (``mesh``: the ranks' mesh, None
    for one device)."""
    device: torch.device
    mesh_config: MeshConfig
    init_fn: Callable[[torch.Generator], TrainState]
    step_fn: Callable[[TrainState, Any],
                      Tuple[TrainState, Dict[str, torch.Tensor]]]
    mesh: Optional[Mesh] = None


MeshLike = Union[Mesh, torch.device, str,
                 Sequence[Union[torch.device, str]]]


def _resolve_placement(device: DeviceLike, mesh: Optional[MeshLike],
                       mesh_config: Optional[MeshConfig]
                       ) -> Tuple[torch.device, MeshConfig, Optional[Mesh]]:
    """(device, resolved config, mesh of ranks or None).  A ``Mesh``, or a
    ``mesh_config`` inside a ``torch.distributed`` domain, makes a mesh
    program; outside one a config must describe one device."""
    from ray_tpu_torch.parallel import multihost
    if isinstance(mesh, Mesh):
        if mesh_config is not None and \
                mesh_config.resolved(mesh.size) != mesh.config:
            raise ValueError(f"mesh_config {mesh_config} does not describe "
                             f"the mesh {mesh}")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"mesh {mesh} and device {device} differ")
        return mesh.device, mesh.config, mesh
    if mesh is not None:
        devs = [mesh] if isinstance(mesh, (torch.device, str)) \
            else list(mesh)
        if len(devs) != 1:
            raise ValueError(
                f"a list of {len(devs)} devices is not a mesh: the port's "
                f"mesh is one process a rank (parallel.mesh.Mesh over a "
                f"torch.distributed domain)")
        if device is not None and resolve_device(devs[0]) \
                != resolve_device(device):
            raise ValueError(f"mesh {devs[0]} and device {device} differ")
        device = devs[0]
    if multihost.is_distributed() and mesh_config is not None:
        m = Mesh(mesh_config, device=device)
        return m.device, m.config, m
    config = (mesh_config or MeshConfig()).resolved(1)
    return resolve_device(device), config, None


def _grad_buckets(mesh: Mesh, specs: list, key) -> Dict[tuple, list]:
    """Leaf indices grouped by ``key(mesh, spec)`` (an axis tuple)."""
    out: Dict[tuple, list] = {}
    for i, spec in enumerate(specs):
        out.setdefault(key(mesh, spec), []).append(i)
    return out


def _sum_over(mesh: Mesh, axes: Sequence[str],
              leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each leaf summed over the ranks of ``axes``: one flat float32
    buffer an axis."""
    if not axes or not leaves:
        return list(leaves)
    flat = device_group.flatten(leaves)
    for a in axes:
        flat = mesh.group(a).all_reduce(flat)
    return device_group.unflatten(flat, leaves)


def _mesh_reduce(mesh: Mesh, specs: list, grads: Any) -> Any:
    """Every leaf's gradient summed over the ranks that hold a copy of it
    (the axes its spec does not split), over the number of ranks: the
    gradient of the global loss (each rank's autograd gave the gradient
    of the sum of the ranks' copies of it)."""
    leaves = tx.tree_leaves(grads)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    inv = 1.0 / mesh.size
    buckets = _grad_buckets(mesh, specs, mesh_lib.replicated_axes)
    for axes in sorted(buckets):
        idx = buckets[axes]
        for i, t in zip(idx, _sum_over(mesh, axes,
                                       [leaves[i] for i in idx])):
            out[i] = t * inv
    it = iter(out)
    return tx.tree_map(lambda _: next(it), grads)


def _mesh_norm(mesh: Mesh, specs: list):
    """``global_norm`` over a mesh: each leaf's squares summed over the
    pieces of a split leaf (the axes its spec splits), once for a
    replicated one."""
    buckets = _grad_buckets(mesh, specs, mesh_lib.sharded_axes)

    def norm(tree: Any) -> torch.Tensor:
        sq = [torch.sum(x.float() * x.float()) for x in tx.tree_leaves(tree)]
        total = None
        for axes in sorted(buckets):
            part = torch.stack([sq[i] for i in buckets[axes]]).sum()
            part = _sum_over(mesh, axes, [part])[0]
            total = part if total is None else total + part
        return torch.sqrt(total)

    return norm


def build_train_program(
        *, loss_fn: Callable[[Any, Any], torch.Tensor],
        init_params_fn: Callable[[torch.Generator], Any],
        optimizer: Optional[tx.GradientTransformation] = None,
        mesh_config: Optional[MeshConfig] = None,
        mesh: Optional[MeshLike] = None,
        rules: Rules = TRANSFORMER_RULES,
        accum_steps: int = 1,
        accum_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
        grad_reduce: Optional[Callable[[torch.Tensor, Any],
                                       Tuple[torch.Tensor, Any]]] = None
        ) -> SpmdProgram:
    """Assemble the train step on one device (default ``cuda``), or over
    a mesh of ranks (``mesh``, or ``mesh_config`` inside a
    ``torch.distributed`` domain; the module docstring has the contract).

    ``loss_fn(params, batch) -> scalar``.  Over a mesh, ``init_fn``'s
    params are the GLOBAL tree (every rank draws the same), of which each
    rank keeps the slice ``rules`` give its coordinates, and a batch is
    this rank's rows (``shard_batch``).  ``accum_steps > 1`` splits the
    batch on its leading dim into that many microbatches and accumulates
    their gradients (in ``accum_dtype``, default the param dtype) before
    one optimizer update; activation memory then scales with the
    microbatch.  ``grad_reduce(loss, grads) -> (loss, grads)`` runs
    between the backward and the optimizer: a data-parallel program
    whose ranks each hold the whole state averages both over its ranks
    there (``multihost.allreduce``), so every rank makes the same
    update."""
    optimizer = optimizer or default_optimizer()
    dev, mesh_config, the_mesh = _resolve_placement(device, mesh,
                                                    mesh_config)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_fn(gen: torch.Generator) -> TrainState:
        params = init_params_fn(gen)
        if the_mesh is not None:
            params = mesh_lib.shard_params(the_mesh, params, rules)
        params = tx.tree_map(lambda t: t.detach().to(dev), params)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, opt_state=optimizer.init(params))

    def grads_of(params: Any, batch: Any):
        leaves = tx.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            # a leaf the loss does not use (BERT's MLM loss leaves the
            # pooler and the cls head out) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        return loss.detach(), tx.tree_map(lambda _: next(it), params)

    def grads_accum(params: Any, batch: Any):
        A = accum_steps

        def split(x):
            if x.ndim == 0 or x.shape[0] % A:
                raise ValueError(f"batch dim {tuple(x.shape)} not divisible "
                                 f"by accum_steps={A}")
            return x.reshape(A, x.shape[0] // A, *x.shape[1:])

        mbs = tx.tree_map(split, batch)
        acc = tx.tree_map(lambda p: torch.zeros_like(
            p, dtype=accum_dtype or p.dtype), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(A):
            loss, grads = grads_of(params, tx.tree_map(lambda x: x[i], mbs))
            tx.tree_map(lambda a, g: a.add_(g.to(a.dtype)), acc, grads)
            loss_sum = loss_sum + loss
        inv = 1.0 / A
        grads = tx.tree_map(lambda a, p: (a.float() * inv).to(p.dtype),
                            acc, params)
        return loss_sum * inv, grads

    specs: list = []

    def mesh_specs(params: Any) -> list:
        # by path and rank: the same for the local and the global tree,
        # and for every state of this program
        if not specs:
            specs.extend(_spec_leaves(mesh_lib.param_specs(params, rules)))
        return specs

    def _step(state: TrainState, batch: Any):
        if accum_steps > 1:
            loss, grads = grads_accum(state.params, batch)
        else:
            loss, grads = grads_of(state.params, batch)
        if the_mesh is not None:
            grads = _mesh_reduce(the_mesh, mesh_specs(state.params), grads)
        if grad_reduce is not None:
            loss, grads = grad_reduce(loss, grads)
        with torch.no_grad():
            gnorm = tx.global_norm(grads)      # of the raw gradients
            updates, state.opt_state = optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates_mixed(state.params, updates)
            state.step.add_(1)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "step": state.step.float()}

    def _mesh_step(state: TrainState, batch: Any):
        if the_mesh is None:
            return _step(state, batch)
        norm = _mesh_norm(the_mesh, mesh_specs(state.params))
        with mesh_lib.ambient_mesh(the_mesh), tx.norm_override(norm):
            return _step(state, batch)

    # the step region: one batch signature for this program's life
    # (COMPILE_BUDGETS["train.step"]) and no host read inside the step;
    # the caller's reads of the metrics happen on its side of it
    step_budget = compile_budget("train.step")

    def step_fn(state: TrainState, batch: Any):
        with step_budget:
            step_budget.see(signature(tx.tree_leaves(batch)))
            return _mesh_step(state, batch)

    return SpmdProgram(device=dev, mesh_config=mesh_config, init_fn=init_fn,
                       step_fn=step_fn, mesh=the_mesh)


def shard_batch(program: SpmdProgram, batch: Any) -> Any:
    """Host batch (numpy arrays or tensors, nested dicts) → tensors on the
    program's device; integer arrays become int64 (token ids).  Over a
    mesh, the GLOBAL batch → this rank's rows (its data coordinate's);
    the sequence stays whole (the model cuts its chunk: the next-token
    targets of a chunk need the token after it)."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else torch.as_tensor(x)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if program.mesh is not None and t.ndim:
            t = mesh_lib.shard_batch_rows(program.mesh, t)
        return t.to(program.device)

    return tx.tree_map(put, batch)
