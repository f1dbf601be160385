"""Weight bridge between the reference's param pytree and the port's.

The reference keeps params as a nested dict of arrays with per-layer
leaves stacked on a leading ``n_layer`` axis; the port keeps the same
keys, shapes and stacking with tensors, for every family it has (GPT-2,
Llama, the MoE transformer, whose ``blocks/moe`` router and expert banks
carry the L axis before the expert axis; BERT, ViT, T5; ResNet, whose
``stage{i}`` is a list of bottleneck dicts, carried as a list).  On the
JAX side a tree becomes numpy with ``jax.tree.map(np.asarray, params)``;
this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any], cfg,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Nest of dicts and lists of numpy arrays → the same nest of
    ``cfg.param_dtype`` tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=cfg.param_dtype)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: tensors → float32 numpy arrays, same keys and shapes."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return params.detach().to("cpu", torch.float32).numpy()
