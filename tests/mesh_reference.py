"""The JAX side of the port's mesh tests: a tiny model's train program on
a mesh of the rig's virtual devices, and what the port's ranks compare
against (its initial params as numpy, its losses and grad norms)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

OPT = {"lr": 1e-2, "warmup": 1, "total_steps": 50}


def jax_train_run(axes: dict, cfg_kw: dict, tokens: np.ndarray,
                  steps: int = 3, family: str = "gpt2") -> dict:
    """``steps`` steps of the JAX package's train program for
    ``family``'s ``tiny(vocab=128, seq=32)`` in float32 over a mesh of
    ``axes`` on the first devices; the batch as an inputs / targets pair
    (a (B, T+1) block does not split over ``context``)."""
    from ray_tpu.models import gpt2, llama
    from ray_tpu.parallel import mesh as mesh_lib
    from ray_tpu.parallel import spmd
    from ray_tpu.parallel.mesh import MeshConfig
    mod = gpt2 if family == "gpt2" else llama
    cfg = dataclasses.replace(mod.tiny(vocab=128, seq=32),
                              dtype=jnp.float32, **cfg_kw)
    mc = MeshConfig(**{"data": 1, **axes})
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        init_params_fn=lambda r: mod.init_params(r, cfg),
        optimizer=spmd.default_optimizer(**OPT),
        mesh=mesh_lib.build_mesh(mc, jax.devices()[:mc.num_devices]),
        mesh_config=mc,
        **({} if family == "gpt2" else {"rules": llama.LLAMA_RULES}))
    state = prog.init_fn(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    batch = spmd.shard_batch(prog, {"inputs": tokens[:, :-1],
                                    "targets": tokens[:, 1:]})
    losses, norms = [], []
    for _ in range(steps):
        state, m = prog.step_fn(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"params": params, "losses": losses, "norms": norms}


def tokens(seed: int, batch: int = 4, seq: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 128, (batch, seq + 1)).astype(np.int32)
