"""The port's pipeline schedule (``ray_tpu_torch/parallel/pipeline.py``)
against the JAX package's (mirrors of ``tests/test_pipeline_moe.py``'s
pipeline tests), and GPT-2 trained over a ``pipeline=2`` mesh against
the JAX program on the same mesh.

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``), the pipeline over 2 or 4 of them (the rest
on ``data``).  Outputs within 2e-5, gradient leaves within 1e-4
(float32, the reference's own tolerances); GPT-2's losses within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpp
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu_torch.parallel import pipeline as tpp

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


def _stage_fn(params, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, params["w"])
    return h


def _jax_pipeline(S: int, staged, x_micro):
    mesh = jmesh.build_mesh(JMeshConfig(data=1, pipeline=S),
                            jax.devices()[:S])

    def run(p, xm):
        return jpp.pipeline_apply(_stage_fn, p, xm, mesh=mesh)

    out = jax.jit(run)(staged, x_micro)
    gw, gx = jax.jit(jax.grad(lambda p, xm: jnp.sum(run(p, xm) ** 2),
                              argnums=(0, 1)))(staged, x_micro)
    return np.asarray(out), np.asarray(gw["w"]), np.asarray(gx)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_forward_and_grads_match_jax(pool, S, remat):
    """Every rank's output is the JAX pipeline's; each stage's gradient
    is its row of the JAX gradient, and x's gradient the JAX one."""
    d, B, L, M = 8, 8, 8, 4
    rng = np.random.default_rng(S)
    w = (rng.standard_normal((L, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((B, d)).astype(np.float32)
    staged = {"w": w.reshape(S, L // S, d, d)}
    x_micro = x.reshape(M, B // M, d)
    out, gw, gx = _jax_pipeline(S, staged, x_micro)
    for r in pool.run(pool_lib.rank_pipeline, staged, x_micro, S, remat):
        np.testing.assert_allclose(r["out"], out, atol=OUT_TOL)
        np.testing.assert_allclose(r["dw"], gw[r["stage"]:r["stage"] + 1],
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(r["dx"], gx, atol=GRAD_TOL)


def test_pipeline_single_stage_path():
    """One stage: the stage applied to every microbatch (no mesh)."""
    d, B, L = 8, 8, 4
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((B, d)).astype(np.float32)
    ref = jpp.merge_microbatches(jpp.pipeline_apply(
        _stage_fn, jpp.stack_stages({"w": w}, 1),
        jpp.split_microbatches(x, 2),
        mesh=jmesh.build_mesh(JMeshConfig(data=8), jax.devices()[:8])))
    got = tpp.merge_microbatches(tpp.pipeline_apply(
        pool_lib._pipe_stage, tpp.stack_stages({"w": torch.from_numpy(w)},
                                               1),
        tpp.split_microbatches(torch.from_numpy(x), 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_TOL)


def test_stack_roundtrip_and_microbatch_pick():
    w = torch.randn(12, 4, 4)
    rt = tpp.unstack_stages(tpp.stack_stages({"w": w}, 4))
    assert torch.equal(rt["w"], w)
    for b, s in ((64, 4), (8, 4), (6, 4), (7, 2)):
        assert tpp.pick_num_microbatches(b, s) == \
            jpp.pick_num_microbatches(b, s)
    with pytest.raises(ValueError):
        tpp.stack_stages({"w": w}, 5)
    with pytest.raises(ValueError, match="microbatches"):
        tpp.split_microbatches(torch.zeros(6, 2), 4)


def test_gpt2_pipeline_losses_match_jax(pool):
    """GPT-2 tiny, 3 steps over ``data=2, pipeline=2`` with 2
    microbatches: the losses and grad norms on every rank equal the JAX
    program's on the same mesh."""
    axes = {"data": 2, "pipeline": 2}
    kw = {"pipeline_axis": "pipeline", "num_microbatches": 2}
    toks = ref.tokens(7)
    want = ref.jax_train_run(axes, kw, toks)
    for r in pool.run(pool_lib.rank_gpt2_train, axes,
                      dict(kw, tiny={"vocab": 128, "seq": 32}),
                      want["params"], toks, 3, ref.OPT):
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-4)
