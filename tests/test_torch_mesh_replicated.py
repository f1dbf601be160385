"""The replicated-axis contract: an axis on which every rank computes
the same rows is counted once (``ray_tpu_torch/parallel/spmd.py``'s
docstring).  Llama over ``pipeline`` and ``seq`` against the JAX
package's program on the same mesh, and the step's gradients against
the port's own one-rank gradients.

Under ``pipeline`` (Llama has no schedule: the reference's ``forward``
is one ``lax.scan`` over the stacked layers GSPMD splits) every rank
runs every layer on its rows, each layer fetched from the stage that
holds it; under ``seq`` (no rule names it) nothing is split.  Either
way a rank's reduced gradient must be the one-rank gradient, not
``pp`` or ``sp`` times it.  A leaf replicated over ``tensor`` (the
RMSNorm scales, the MoE router, the LayerNorm params) must end with the
same gradient, bitwise, on both ``tensor`` ranks.

The port's side runs on pools of 2 and 4 gloo ranks
(``tests/rtt_mesh_pool.py``).

Tolerances (float32): as ``tests/test_torch_llama_mesh.py`` against
JAX; against the port's one-rank gradients every leaf within 1e-5 of its
largest element (the same function, sums in other orders).  The layer
fetch's dtypes are held in bf16, bitwise (the same operations on the
same values).
"""

import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import transforms as tx

LAYOUTS = {
    "pipeline2": {"pipeline": 2},
    "data2_pipeline2": {"data": 2, "pipeline": 2},
    "seq2": {"seq": 2},
}
TRAJECTORY_RTOL = 1e-5
ONE_RANK_TOL = 1e-5


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = pool_lib.RankPool(world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _world(axes):
    return int(np.prod(list(axes.values())))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_llama_replicated_layout_matches_jax(pools, layout):
    """3 steps of Llama tiny over the layout: every rank's losses and
    grad norms, and its step-0 gradient shards, against the JAX program
    on the same mesh."""
    axes = LAYOUTS[layout]
    world = _world(axes)
    shape = tmesh.MeshConfig(**axes).resolved(world).as_dict()
    toks = ref.tokens(11)
    want = ref.jax_train_run(axes, {}, toks, family="llama", grads=True)
    rules = pool_lib._family("llama")[1]
    res = pools(world).run(pool_lib.rank_mesh_train, "llama", axes,
                           {"tiny": ref.TINY["llama"]}, want["params"],
                           {"inputs": toks[:, :-1], "targets": toks[:, 1:]},
                           3, ref.OPT)
    for r in res:
        ref.check_grads(r, want["grads"], rules, shape, layout)
        np.testing.assert_allclose(r["losses"][0], want["losses"][0],
                                   atol=1e-5)
        np.testing.assert_allclose(r["norms"][0], want["norms"][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=TRAJECTORY_RTOL)
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=TRAJECTORY_RTOL)
    assert res[0]["losses"][-1] < res[0]["losses"][0]


def _one_rank(family, params, batch):
    """The port's loss and gradients of a tiny ``family`` model on one
    process."""
    import torch

    from ray_tpu_torch.parallel import spmd
    prog, cfg, _ = pool_lib._program(family, None,
                                     {"tiny": ref.TINY[family]}, params, {})
    mod = pool_lib._family(family)[0]
    state = prog.init_fn(torch.Generator())
    b = spmd.shard_batch(prog, batch)
    leaves = tx.tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    loss = mod.loss_fn(state.params, b, cfg)
    gs = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), tx.tree_map(
        lambda _: next(gs).numpy(), state.params)


@pytest.mark.parametrize("family, axes", [
    ("llama", {"pipeline": 2}), ("llama", {"seq": 2}),
    ("moe", {"pipeline": 2})], ids=["llama-pipeline2", "llama-seq2",
                                    "moe-pipeline2"])
def test_replicated_compute_counts_once(pools, family, axes):
    """Every rank's loss and reduced step-0 gradient (each leaf its
    slice) equal the port's one-rank ones: not ``pp`` or ``sp`` times
    them."""
    toks = ref.tokens(13)
    params = ref.jax_train_run({"tensor": 1}, {}, toks, steps=0,
                               family=family)["params"]
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    loss, grads = _one_rank(family, params, batch)
    rules = pool_lib._family(family)[1]
    shape = tmesh.MeshConfig(**axes).resolved(2).as_dict()
    for r in pools(2).run(pool_lib.rank_mesh_loss, family, axes,
                          {"tiny": ref.TINY[family]}, params, batch):
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-6)
        ref.check_grads(r, grads, rules, shape, f"{family} {axes}",
                        tol=ONE_RANK_TOL)


@pytest.mark.parametrize("family, axes, leaves", [
    ("llama", {"data": 2, "tensor": 2},
     ["blocks/attn_norm/scale", "blocks/mlp_norm/scale", "norm_f/scale"]),
    ("moe", {"expert": 2, "tensor": 2},
     ["blocks/moe/router", "blocks/ln_1/scale", "blocks/ln_2/bias",
      "ln_f/scale"])], ids=["llama", "moe"])
def test_tensor_replicated_leaves_bitwise(pools, family, axes, leaves):
    """After the step's reduction a leaf replicated over ``tensor`` has
    the same gradient, bitwise, on both ``tensor`` ranks of each line."""
    toks = ref.tokens(14)
    params = ref.jax_train_run({"tensor": 1}, {}, toks, steps=0,
                               family=family)["params"]
    res = pools(4).run(pool_lib.rank_mesh_loss, family, axes,
                       {"tiny": ref.TINY[family]}, params,
                       {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    other = next(a for a in axes if a != "tensor")
    for path in leaves:
        by_line = {}
        for r in res:
            g = dict(tx.tree_leaves_with_path(r["grads"]))[path]
            by_line.setdefault(r["coords"][other], []).append(g)
        for pair in by_line.values():
            assert len(pair) == 2
            np.testing.assert_array_equal(pair[0], pair[1], err_msg=path)
            assert np.abs(pair[0]).max() > 0, path


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_pipeline_fetch_keeps_float32_leaves(pools, family):
    """Under ``pipeline=2`` with bf16 activations every rank's final-norm
    hidden states equal the one-rank run's, bitwise: a layer's leaf
    crosses the fetch in the dtype the block reads it in (the matrices
    in bf16; MoE's LayerNorm params and router in float32, which bf16
    would round; Llama's RMSNorm scales are not stacked over
    ``pipeline``).  The norms' params are drawn off 1 and 0 so that
    rounding shows."""
    import torch

    toks = ref.tokens(15)
    params = ref.jax_train_run({"tensor": 1}, {}, toks, steps=0,
                               family=family)["params"]
    rng = np.random.default_rng(15)

    def jitter(path, a):
        norm = path.endswith("scale") or "/ln_" in path
        return a + rng.normal(0, 0.05, a.shape).astype(a.dtype) if norm \
            else a

    params = tmesh._map_with_path(jitter, params)
    cfg_kw = {"tiny": ref.TINY[family], "dtype": torch.bfloat16}
    inp = toks[:, :-1]
    want = pool_lib.rank_mesh_hidden(family, None, cfg_kw, params, inp)
    for r in pools(2).run(pool_lib.rank_mesh_hidden, family,
                          {"pipeline": 2}, cfg_kw, params, inp):
        np.testing.assert_array_equal(r, want)
