"""The JAX side of the port's mesh tests: a tiny model's train program on
a mesh of the rig's virtual devices, and what the port's ranks compare
against (its initial params as numpy, its losses and grad norms, the
step-0 gradient of every leaf)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import transforms as tx

OPT = {"lr": 1e-2, "warmup": 1, "total_steps": 50}
# the families' tiny configs (each side builds its own from these)
TINY = {"gpt2": {"vocab": 128, "seq": 32}, "llama": {"vocab": 128,
                                                      "seq": 32},
        "moe": {"vocab": 128, "seq": 32, "experts": 4},
        "resnet": {"num_classes": 10}}
RESNET_HEAD_STD = 0.05


def _family(family: str):
    from ray_tpu.models import gpt2, llama, moe_transformer, resnet
    from ray_tpu.parallel import mesh as mesh_lib
    return {"gpt2": (gpt2, mesh_lib.TRANSFORMER_RULES),
            "llama": (llama, llama.LLAMA_RULES),
            "moe": (moe_transformer, moe_transformer.MOE_TRANSFORMER_RULES),
            "resnet": (resnet, resnet.RESNET_RULES)}[family]


def _init(mod, family: str, cfg):
    """The family's init; ResNet's zero head drawn N(0, 0.05²) instead
    (a zero head zeroes every other gradient at step 0)."""
    def init(r):
        params = mod.init_params(r, cfg)
        if family == "resnet":
            k = params["head"]["kernel"]
            params["head"]["kernel"] = RESNET_HEAD_STD * jax.random.normal(
                jax.random.key(7), k.shape, k.dtype)
        return params
    return init


def jax_train_run(axes: dict, cfg_kw: dict, tokens: np.ndarray = None,
                  steps: int = 3, family: str = "gpt2",
                  batch: dict = None, grads: bool = False) -> dict:
    """``steps`` steps of the JAX package's train program for
    ``family``'s tiny config (``TINY``) in float32 over a mesh of
    ``axes`` on the first devices; a token batch as an inputs / targets
    pair (a (B, T+1) block does not split over ``context``), or
    ``batch`` as it is.  ``grads``: also the step-0 gradient of every
    leaf (``jax.value_and_grad`` of the loss on the mesh-placed params)
    and the loss, ``loss0``."""
    from ray_tpu.parallel import mesh as mesh_lib
    from ray_tpu.parallel import spmd
    from ray_tpu.parallel.mesh import MeshConfig
    mod, rules = _family(family)
    cfg = dataclasses.replace(mod.tiny(**TINY[family]), dtype=jnp.float32,
                              **cfg_kw)
    mc = MeshConfig(**{"data": 1, **axes})
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        init_params_fn=_init(mod, family, cfg),
        optimizer=spmd.default_optimizer(**OPT),
        mesh=mesh_lib.build_mesh(mc, jax.devices()[:mc.num_devices]),
        mesh_config=mc, rules=rules,
        batch_rank=1 if family == "resnet" else 2)
    state = prog.init_fn(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    if batch is None:
        batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    placed = spmd.shard_batch(prog, batch)
    out = {"params": params}
    if grads:
        loss0, g = jax.jit(jax.value_and_grad(
            lambda p, b: mod.loss_fn(p, b, cfg)))(state.params, placed)
        out["grads"] = jax.tree_util.tree_map(np.asarray, jax.device_get(g))
        out["loss0"] = float(loss0)
    losses, norms = [], []
    for _ in range(steps):
        state, m = prog.step_fn(state, placed)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(losses=losses, norms=norms)
    return out


def tokens(seed: int, batch: int = 4, seq: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 128, (batch, seq + 1)).astype(np.int32)


def images(seed: int, batch: int = 8, hw: int = 16,
           classes: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((batch, hw, hw, 3)).astype(
                np.float32),
            "labels": (np.arange(batch) % classes).astype(np.int32)}


def rank_piece(full: np.ndarray, spec, coords, shape) -> np.ndarray:
    """The piece of ``full`` a rank at ``coords`` of a mesh of ``shape``
    holds under ``spec``."""
    mesh = types.SimpleNamespace(shape=shape, coords=coords)
    return full[tmesh.shard_index(full.shape, spec, mesh)]


def leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, lists and tuples (an optimizer
    state nests tuples)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k],
                                                          f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def check_grads(r, want, rules, shape, label="", tol=1e-4):
    """Every leaf of a rank's reduced step-0 gradients against the JAX
    gradient's piece at its coordinates, within ``tol`` of the leaf's
    largest element."""
    specs = tmesh.param_specs(want, rules)
    for (path, g), (_, w), (_, s) in zip(
            *(tx.tree_leaves_with_path(t)
              for t in (r["grads"], want, specs))):
        piece = rank_piece(w, s, r["coords"], shape)
        assert g.shape == piece.shape, (label, path, g.shape, piece.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, piece, rtol=0, atol=tol * scale,
                                   err_msg=f"{label} {path}")
