"""Compact AdamW (port of ``ray_tpu/parallel/optim.py``).

Both Adam moments are stored in a compact dtype (bf16 by default), which
halves the optimizer's memory and its bandwidth-bound update traffic; the
update math is float32 throughout and only the carried state is rounded.
``apply_updates_mixed`` adds the update to the params in float32.

The moments and the params are updated in place: the counterpart of the
reference donating its train state to the step.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ray_tpu_torch.parallel.transforms import (
    GradientTransformation, ScalarOrSchedule, add_decayed_weights, chain,
    clip_by_global_norm, scale_by_learning_rate, tree_map, zero_count)


def scale_by_adam_compact(b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8,
                          mu_dtype: torch.dtype = torch.bfloat16,
                          nu_dtype: torch.dtype = torch.bfloat16
                          ) -> GradientTransformation:
    """Adam's scaling with BOTH moments stored in compact dtypes; the
    blend and the update in float32."""
    def init(params):
        return {"count": zero_count(params),
                "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                               params),
                "nu": tree_map(lambda p: torch.zeros_like(p, dtype=nu_dtype),
                               params)}

    def update(updates, state, params=None):
        count = state["count"]
        count.add_(1)
        c = count.float()
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)

        def blend(g, m, v):
            g32 = g.float()
            m32 = b1 * m.float() + (1.0 - b1) * g32
            v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            m.copy_(m32)           # only the carried state is compact
            v.copy_(v32)
            return u

        return tree_map(blend, updates, state["mu"], state["nu"]), state

    return GradientTransformation(init, update)


def adamw_compact(learning_rate: ScalarOrSchedule, *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0, clip: Optional[float] = None,
                  mu_dtype: torch.dtype = torch.bfloat16,
                  nu_dtype: torch.dtype = torch.bfloat16
                  ) -> GradientTransformation:
    """AdamW with compact moment storage (drop-in for ``adamw``)."""
    parts = []
    if clip is not None:
        parts.append(clip_by_global_norm(clip))
    parts += [scale_by_adam_compact(b1, b2, eps, mu_dtype, nu_dtype),
              add_decayed_weights(weight_decay),
              scale_by_learning_rate(learning_rate)]
    return chain(*parts)


def apply_updates_mixed(params: Any, updates: Any) -> Any:
    """``p += u`` with the add in float32, in place; returns ``params``.
    For float32 params this is the plain add."""
    def add(p, u):
        if u is not None:
            p.copy_(p.float() + u.float())
        return p

    return tree_map(add, params, updates)
