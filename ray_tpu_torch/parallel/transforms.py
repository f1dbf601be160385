"""The subset of optax that the reference's train step calls, on nested
dicts and lists of tensors.

Written from optax's semantics (optax itself is JAX and is not imported):
a ``GradientTransformation`` is an ``(init, update)`` pair,
``update(updates, state, params) -> (updates, state)``; ``chain`` runs its
parts in order.  What the reference's numbers depend on is kept:

- A schedule is evaluated at the count BEFORE the count is incremented,
  so ``warmup_cosine_decay_schedule(0.0, ...)`` makes a first update of
  exactly zero.  Adam's bias correction uses ``count + 1``.
- ``clip_by_global_norm`` is ``g if norm < c else g / norm * c`` (no
  epsilon on the norm, unlike ``torch.nn.utils.clip_grad_norm_``).
- ``add_decayed_weights`` adds ``wd * p`` on every leaf after Adam's
  scaling and before the learning rate.

Counts are int32 device tensors and every scalar stays on the device:
nothing here syncs with the host.  Adam's moments are updated in place
(the counterpart of the reference donating its state); updates are new
tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]       # (updates, state, params=None)


# ------------------------------------------------------------------ trees
# A tree is a nest of dicts and lists (ResNet keeps a list of block dicts
# per stage) with tensors at the leaves, walked in the reference's pytree
# order: a dict's keys sorted, a list's items in order.
def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of the trees (every tree shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Tree, prefix: str = ""
                          ) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the reference's order; a path joins the dict
    keys and list indices on the way with "/" (``stage0/1/conv2``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in tree_leaves_with_path(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def zero_count(params: Tree) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(x * x)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# -------------------------------------------------------------- transforms
def chain(*parts: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(updates, state, params=None):
        new_state = []
        for part, s in zip(parts, state):
            updates, s = part.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(
            keep, t, (t / g_norm.to(t.dtype)) * max_norm), updates), state

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                  ) -> GradientTransformation:
    """Adam's scaling, moments in the params' dtype."""
    def init(params):
        return {"count": zero_count(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        count = state["count"]
        count.add_(1)
        c = count.float()
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)

        def leaf(g, m, v):
            m_new = (1 - b1) * g + b1 * m
            v_new = (1 - b2) * (g * g) + b2 * v
            u = (m_new / bc1.to(m_new.dtype)) / (
                torch.sqrt(v_new / bc2.to(v_new.dtype)) + eps)
            m.copy_(m_new)
            v.copy_(v_new)
            return u

        return tree_map(leaf, updates, state["mu"], state["nu"]), state

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
    """RMSProp's scaling, as optax's (``eps_in_sqrt``, no bias
    correction): ``nu = (1 - decay) g² + decay nu``, ``g / sqrt(nu +
    eps)`` with ``eps`` INSIDE the root; ``nu`` starts at
    ``initial_scale``.  (``torch.optim.RMSprop`` divides by ``sqrt(nu) +
    eps``, far from this at RLlib's eps 0.1.)"""
    def init(params):
        return {"nu": tree_map(
            lambda p: torch.full_like(p, initial_scale), params)}

    def update(updates, state, params=None):
        def leaf(g, v):
            v.mul_(decay).add_((1 - decay) * (g * g))
            return g * torch.rsqrt(v + eps)

        return tree_map(leaf, updates, state["nu"]), state

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def init(params):
        return ()

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, updates,
                        params), state

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule
                           ) -> GradientTransformation:
    """``-learning_rate * update``; a schedule is called with the count
    before its increment."""
    if not callable(learning_rate):
        def init_const(params):
            return ()

        def update_const(updates, state, params=None):
            return tree_map(lambda g: -learning_rate * g, updates), state

        return GradientTransformation(init_const, update_const)

    def init(params):
        return {"count": zero_count(params)}

    def update(updates, state, params=None):
        count = state["count"]
        step_size = -learning_rate(count)
        out = tree_map(lambda g: step_size.to(g.dtype) * g, updates)
        count.add_(1)
        return out, state

    return GradientTransformation(init, update)


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: eps outside the root, bias-corrected moments."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate: ScalarOrSchedule, decay: float = 0.9,
            eps: float = 1e-8, initial_scale: float = 0.0
            ) -> GradientTransformation:
    """optax.rmsprop without momentum or centering (its defaults)."""
    return chain(scale_by_rms(decay, eps, initial_scale),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


# --------------------------------------------------------------- schedules
def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` by
    ``decay_steps`` (warmup included).  Takes an int count tensor and
    returns a float32 tensor on its device."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine decay needs positive steps, got "
                         f"decay_steps - warmup_steps = {cos_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        if warmup_steps > 0:
            w = count.clamp(0, warmup_steps).float()
            frac = 1 - w / warmup_steps
            linear = (init_value - peak_value) * frac + peak_value
        else:
            linear = torch.full((), init_value, dtype=torch.float32,
                                device=count.device)
        t = (count - warmup_steps).clamp(max=cos_steps).float()
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        decayed = (1 - alpha) * cosine ** exponent + alpha
        return torch.where(count < warmup_steps, linear,
                           peak_value * decayed)

    return schedule

