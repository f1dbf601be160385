"""Train-program assembly on one device (port of
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
- One device only: a ``mesh`` or ``mesh_config`` that describes more than
  one device raises ``NotImplementedError`` until the multi-GPU slice
  (ROADMAP queue A, slice 4) ports meshes, sharding rules and
  ``state_specs``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch._private.xla_watchdog import compile_budget, signature
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.parallel.optim import adamw_compact, apply_updates_mixed

MULTI_DEVICE = ("meshes of more than one device are the multi-GPU slice's "
                "work (ROADMAP queue A, slice 4)")


@dataclass
class TrainState:
    step: torch.Tensor          # int32 scalar on the device
    params: Any
    opt_state: Any


@dataclass(frozen=True)
class MeshConfig:
    """The reference's logical layout; -1 on one axis absorbs the rest.
    This slice takes only layouts of one device."""
    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    context: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    @property
    def num_devices(self) -> int:
        """Devices the layout needs (a -1 axis counts as 1)."""
        return math.prod(abs(getattr(self, f.name)) for f in fields(self))


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


@dataclass
class SpmdProgram:
    """The train step and where it runs."""
    device: torch.device
    mesh_config: MeshConfig
    init_fn: Callable[[torch.Generator], TrainState]
    step_fn: Callable[[TrainState, Any],
                      Tuple[TrainState, Dict[str, torch.Tensor]]]


MeshLike = Union[torch.device, str, Sequence[Union[torch.device, str]]]


def _resolve_placement(device: DeviceLike, mesh: Optional[MeshLike],
                       mesh_config: Optional[MeshConfig]
                       ) -> Tuple[torch.device, MeshConfig]:
    mesh_config = mesh_config or MeshConfig()
    if mesh_config.num_devices != 1:
        raise NotImplementedError(
            f"mesh_config {mesh_config} needs {mesh_config.num_devices} "
            f"devices: {MULTI_DEVICE}")
    if mesh is not None:
        devs = [mesh] if isinstance(mesh, (torch.device, str)) \
            else list(mesh)
        if len(devs) != 1:
            raise NotImplementedError(
                f"a mesh of {len(devs)} devices: {MULTI_DEVICE}")
        if device is not None and resolve_device(devs[0]) \
                != resolve_device(device):
            raise ValueError(f"mesh {devs[0]} and device {device} differ")
        device = devs[0]
    return resolve_device(device), mesh_config


def build_train_program(
        *, loss_fn: Callable[[Any, Any], torch.Tensor],
        init_params_fn: Callable[[torch.Generator], Any],
        optimizer: Optional[tx.GradientTransformation] = None,
        mesh_config: Optional[MeshConfig] = None,
        mesh: Optional[MeshLike] = None,
        accum_steps: int = 1,
        accum_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None) -> SpmdProgram:
    """Assemble the train step on one device (default ``cuda``).

    ``loss_fn(params, batch) -> scalar``.  ``accum_steps > 1`` splits the
    batch on its leading dim into that many microbatches and accumulates
    their gradients (in ``accum_dtype``, default the param dtype) before
    one optimizer update; activation memory then scales with the
    microbatch."""
    optimizer = optimizer or default_optimizer()
    dev, mesh_config = _resolve_placement(device, mesh, mesh_config)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_fn(gen: torch.Generator) -> TrainState:
        params = tx.tree_map(lambda t: t.detach().to(dev), init_params_fn(gen))
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

    def _step(state: TrainState, batch: Any):
        if accum_steps > 1:
            loss, grads = grads_accum(state.params, batch)
        else:
            loss, grads = grads_of(state.params, batch)
        with torch.no_grad():
            gnorm = tx.global_norm(grads)      # of the raw gradients
            updates, state.opt_state = optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates_mixed(state.params, updates)
            state.step.add_(1)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "step": state.step.float()}

    # the step region: one batch signature for this program's life
    # (COMPILE_BUDGETS["train.step"]) and no host read inside the step;
    # the caller's reads of the metrics happen on its side of it
    step_budget = compile_budget("train.step")

    def step_fn(state: TrainState, batch: Any):
        with step_budget:
            step_budget.see(signature(tx.tree_leaves(batch)))
            return _step(state, batch)

    return SpmdProgram(device=dev, mesh_config=mesh_config, init_fn=init_fn,
                       step_fn=step_fn)


def shard_batch(program: SpmdProgram, batch: Any) -> Any:
    """Host batch (numpy arrays or tensors, nested dicts) → tensors on the
    program's device; integer arrays become int64 (token ids)."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else torch.as_tensor(x)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        return t.to(program.device)

    return tx.tree_map(put, batch)
