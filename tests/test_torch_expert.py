"""Expert parallelism over the port's ``expert`` mesh axis against the
JAX package on the same mesh (mirrors of
``tests/test_pipeline_moe.py:159-186`` and ``tests/test_models.py:212``).

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``) under ``(data=2, expert=2)``: a rank holds
its rows of the batch and its half of the experts, runs its tokens
through them, and sums the combine over ``expert``; routing, capacity
and the losses stay global.

Tolerances (float32): outputs and the aux / z losses 1e-5 (sums in
other orders), the dropped set exact and ``fraction_dropped`` bitwise
(a count over a power of two), gradients within 1e-4 of each leaf's
largest element; the train step's losses 1e-5 absolute over 3 steps,
grad norms 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.parallel import mesh as tmesh

AXES = {"data": 2, "expert": 2}
SHAPE = tmesh.MeshConfig(**AXES).resolved(4).as_dict()
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


def _ffn_inputs(seed, B=4, S=8, d=8, ff=16, E=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)).astype(np.float32),
            (rng.standard_normal((d, E)) * 0.5).astype(np.float32),
            (rng.standard_normal((E, d, ff)) / np.sqrt(d)).astype(
                np.float32),
            (rng.standard_normal((E, ff, d)) / np.sqrt(ff)).astype(
                np.float32))


def _jax_moe(x, router, w_in, w_out, k, cf):
    """The JAX ``moe_ffn`` on the ``(data=2, expert=2)`` mesh (x over
    ``data``, the experts over ``expert``), its dropped set, and the
    gradients of sum(y²) + 0.01·aux + 0.001·z."""
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**AXES), jax.devices()[:4])
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))  # noqa

    def loss(ws, x):
        y, m = jmoe.moe_ffn(x, *ws, k=k, capacity_factor=cf)
        return jnp.sum(y ** 2) + 0.01 * m.aux_loss + 0.001 * m.router_z_loss

    ws = (put(router, P()), put(w_in, P("expert")), put(w_out, P("expert")))
    xs = put(x, P("data"))
    y, m = jax.jit(lambda ws, x: jmoe.moe_ffn(x, *ws, k=k,
                                              capacity_factor=cf))(ws, xs)
    grads = jax.jit(jax.grad(loss))(ws, xs)
    tokens = x.reshape(-1, x.shape[-1])
    gates, _, _ = jmoe.topk_router(tokens, router, k)
    cap = jmoe.expert_capacity(tokens.shape[0], router.shape[-1], k, cf)
    dropped = jmoe._dispatch_tensors(gates, cap)[2]
    return {"y": np.asarray(y), "aux": float(m.aux_loss),
            "z": float(m.router_z_loss),
            "fraction_dropped": float(m.fraction_dropped),
            "dropped": np.asarray(dropped),
            "grads": [np.asarray(g) for g in grads]}


@pytest.mark.parametrize("cf", [4.0, 0.3], ids=["roomy", "dropping"])
def test_moe_ffn_expert_parallel_matches_jax(pool, cf):
    """Each rank's output rows, the global aux / z losses, the dropped
    set of its tokens and ``fraction_dropped`` equal the JAX ``moe_ffn``
    on the same mesh; at ``capacity_factor`` 0.3 tokens drop (queue
    positions run in global token order across the data ranks)."""
    x, router, w_in, w_out = _ffn_inputs(0)
    want = _jax_moe(x, router, w_in, w_out, 2, cf)
    assert (want["fraction_dropped"] > 0) == (cf < 1)
    specs = [P(None, None), P("expert", None, None), P("expert", None, None)]
    B, S = x.shape[:2]
    for r in pool.run(pool_lib.rank_moe_ffn, AXES, x, router, w_in, w_out,
                      2, cf):
        rows = ref.rank_piece(np.arange(B), tmesh.P("data"), r["coords"],
                              SHAPE)
        np.testing.assert_allclose(r["y"], want["y"][rows], rtol=OUT_TOL,
                                   atol=OUT_TOL)
        np.testing.assert_allclose([r["aux"], r["z"]],
                                   [want["aux"], want["z"]], rtol=OUT_TOL)
        assert r["dropped_fraction"] == want["fraction_dropped"]
        np.testing.assert_array_equal(
            r["dropped"], want["dropped"].reshape(B, S)[rows].reshape(-1))
        for g, w, s in zip(r["grads"], want["grads"], specs):
            piece = ref.rank_piece(w, tmesh.P(*s), r["coords"], SHAPE)
            np.testing.assert_allclose(
                g, piece, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))


def test_moe_transformer_train_step_expert_parallel(pool):
    """The MoE transformer's train step under ``(data=2, expert=2)``:
    every rank's losses and grad norms over 3 steps, and its step-0
    gradient shards (stacked experts (L, X/ep, E, ff) a rank), against
    the JAX program on the same mesh."""
    toks = ref.tokens(8)
    want = ref.jax_train_run(AXES, {}, toks, family="moe", grads=True)
    res = pool.run(pool_lib.rank_mesh_train, "moe", AXES,
                   {"tiny": ref.TINY["moe"]}, want["params"],
                   {"inputs": toks[:, :-1], "targets": toks[:, 1:]}, 3,
                   ref.OPT)
    from ray_tpu_torch.models import moe_transformer as tmt
    for r in res:
        assert r["grads"]["blocks"]["moe"]["w_in"].shape[1] == 2
        np.testing.assert_allclose(r["losses"], want["losses"], atol=1e-5)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-4)
        ref.check_grads(r, want["grads"], tmt.MOE_TRANSFORMER_RULES, SHAPE,
                    "moe")
    assert res[0]["losses"][-1] < res[0]["losses"][0]
