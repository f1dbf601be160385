"""The MoE op and the MoE transformer over ``tensor``, ``context`` and
``pipeline`` against the JAX package on the same mesh (the rest of
``tests/test_torch_expert.py``'s layouts).

Under ``tensor`` a rank runs its tokens through its ff columns of every
expert, the partial combine ``psum``'d over ``tensor`` (with ``expert``,
in float32); under ``context`` a rank's tokens are its chunk of every
row, and the queue positions still count the tokens before each one in
the reference's flattened (b, s) order.  The transformer's attention is
the Megatron split under ``tensor``; under ``pipeline`` every rank runs
every layer on its rows, each layer fetched from its stage.

The port's side runs on pools of 4 and 2 gloo ranks
(``tests/rtt_mesh_pool.py``).

Tolerances (float32): the op's outputs and aux / z losses 1e-5, the
dropped set exact and ``fraction_dropped`` bitwise, gradients within
1e-4 of each leaf's largest element (``tests/test_torch_expert.py``'s);
the transformer's losses 1e-5 absolute over 3 steps, grad norms 1e-4
relative, step-0 gradient shards within 1e-4.
"""

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

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
OP_LAYOUTS = {"data2_tensor2": {"data": 2, "tensor": 2},
              "data2_context2": {"data": 2, "context": 2}}
# the specs of the router, w_in and w_out (MOE_RULES' unstacked ones)
SPECS = [tmesh.P(None, None), tmesh.P("expert", None, "tensor"),
         tmesh.P("expert", "tensor", None)]


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


def _ffn_inputs(seed, B=4, S=8, d=8, ff=16, E=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)).astype(np.float32),
            (rng.standard_normal((d, E)) * 0.5).astype(np.float32),
            (rng.standard_normal((E, d, ff)) / np.sqrt(d)).astype(
                np.float32),
            (rng.standard_normal((E, ff, d)) / np.sqrt(ff)).astype(
                np.float32))


def _jax_moe(axes, x, router, w_in, w_out, k, cf):
    """The JAX ``moe_ffn`` on the mesh ``axes`` (x over ``data`` and
    ``context``, w_in / w_out's ff over ``tensor``), its dropped set,
    and the gradients of sum(y²) + 0.01·aux + 0.001·z."""
    mc = jmesh.MeshConfig(**axes)
    mesh = jmesh.build_mesh(mc, jax.devices()[:4])
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))  # noqa

    def loss(ws, x):
        y, m = jmoe.moe_ffn(x, *ws, k=k, capacity_factor=cf)
        return jnp.sum(y ** 2) + 0.01 * m.aux_loss + 0.001 * m.router_z_loss

    ws = (put(router, P()), put(w_in, P(None, None, "tensor")),
          put(w_out, P(None, "tensor", None)))
    xs = put(x, P("data", "context"))
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
@pytest.mark.parametrize("layout", list(OP_LAYOUTS))
def test_moe_ffn_layout_matches_jax(pools, layout, cf):
    """Each rank's output tokens (its rows, and its ``context`` chunk),
    the global aux / z losses, the dropped set of its tokens and
    ``fraction_dropped`` equal the JAX ``moe_ffn`` on the same mesh; at
    ``capacity_factor`` 0.3 tokens drop."""
    axes = OP_LAYOUTS[layout]
    shape = tmesh.MeshConfig(**axes).resolved(4).as_dict()
    x, router, w_in, w_out = _ffn_inputs(1)
    want = _jax_moe(axes, x, router, w_in, w_out, 2, cf)
    assert (want["fraction_dropped"] > 0) == (cf < 1)
    B, S = x.shape[:2]
    ids = np.arange(B * S).reshape(B, S)
    for r in pools(4).run(pool_lib.rank_moe_ffn, axes, x, router, w_in,
                          w_out, 2, cf):
        mine = ref.rank_piece(ids, tmesh.P("data", "context"), r["coords"],
                              shape)
        np.testing.assert_allclose(
            r["y"].reshape(-1, x.shape[-1]),
            want["y"].reshape(-1, x.shape[-1])[mine.reshape(-1)],
            rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose([r["aux"], r["z"]],
                                   [want["aux"], want["z"]], rtol=OUT_TOL)
        assert r["dropped_fraction"] == want["fraction_dropped"]
        np.testing.assert_array_equal(r["dropped"],
                                      want["dropped"][mine.reshape(-1)])
        for g, w, s in zip(r["grads"], want["grads"], SPECS):
            piece = ref.rank_piece(w, s, r["coords"], shape)
            np.testing.assert_allclose(
                g, piece, rtol=0, atol=GRAD_TOL * float(np.abs(w).max()))


TRANSFORMER_LAYOUTS = {"expert2_tensor2": {"expert": 2, "tensor": 2},
                       "pipeline2": {"pipeline": 2},
                       "data2_context2": {"data": 2, "context": 2}}


@pytest.mark.parametrize("layout", list(TRANSFORMER_LAYOUTS))
def test_moe_transformer_layout_matches_jax(pools, layout):
    """The MoE transformer's train step: every rank's losses and grad
    norms over 3 steps, and its step-0 gradient shards, against the JAX
    program on the same mesh (under ``context`` dense attention reads K
    and V all-gathered over it)."""
    axes = TRANSFORMER_LAYOUTS[layout]
    world = int(np.prod(list(axes.values())))
    shape = tmesh.MeshConfig(**axes).resolved(world).as_dict()
    toks = ref.tokens(15)
    want = ref.jax_train_run(axes, {}, toks, family="moe", grads=True)
    from ray_tpu_torch.models import moe_transformer as tmt
    res = pools(world).run(pool_lib.rank_mesh_train, "moe", axes,
                           {"tiny": ref.TINY["moe"]}, want["params"],
                           {"inputs": toks[:, :-1], "targets": toks[:, 1:]},
                           3, ref.OPT)
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"], atol=1e-5)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-4)
        ref.check_grads(r, want["grads"], tmt.MOE_TRANSFORMER_RULES, shape,
                        f"moe {layout}")
    assert res[0]["losses"][-1] < res[0]["losses"][0]
