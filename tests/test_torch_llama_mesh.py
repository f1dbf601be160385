"""Llama and ResNet over ``tensor`` against the JAX package's program on
the same mesh (Llama's ``pipeline`` and ``seq`` layouts are in
``tests/test_torch_mesh_replicated.py``).

``(data=2, tensor=2)`` and ``(fsdp=2, tensor=2)`` together cover the
reference's ``tests/test_models.py:275`` (``test_llama_train_step_sharded``,
``data=2, fsdp=2, tensor=2`` on its 8 devices): the port's pools hold 4
ranks, so each ``tensor`` layout pairs it with one of the two row axes.
Under ``tensor`` a rank runs the Megatron block (its H/tp query heads over
its KV/tp KV heads, ``wo`` and ``w_down`` row-split and ``psum``'d, the
embedding and the LM head vocabulary-parallel).  ResNet tiny under
``(data=2, tensor=2)``: the convs replicated over ``tensor``, the head's
classes split over it, the logits gathered before the loss.

The port's side runs on a pool of 4 gloo ranks
(``tests/rtt_mesh_pool.py``) from the JAX program's initial params; the
JAX side on the rig's virtual devices (``tests/mesh_reference.py``).

Tolerances (float32): the step-0 loss 1e-5 absolute, the step-0 grad
norm 1e-4 relative, every rank's step-0 gradient shard within 1e-4 of
its leaf's largest element, the 3 steps' losses and norms 1e-5 relative
(``tests/test_torch_zero_models.py``'s Llama trajectories; ResNet's
1e-4, its ``TRAJECTORY_RTOL``); a rank's attention output within 1e-5
of the one-rank output's heads it holds.
"""

import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu_torch.parallel import mesh as tmesh

LAYOUTS = {
    "data2_tensor2": {"data": 2, "tensor": 2},
    "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
}
TRAJECTORY_RTOL = 1e-5
ATTN_TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_llama_layout_matches_jax(pool, layout):
    """3 steps of Llama tiny over the layout: every rank's losses and
    grad norms, and its step-0 gradient shards (the program's reduction),
    against the JAX program on the same mesh."""
    axes = LAYOUTS[layout]
    shape = tmesh.MeshConfig(**axes).resolved(4).as_dict()
    toks = ref.tokens(11)
    want = ref.jax_train_run(axes, {}, toks, family="llama", grads=True)
    rules = pool_lib._family("llama")[1]
    res = pool.run(pool_lib.rank_mesh_train, "llama", axes,
                   {"tiny": ref.TINY["llama"]}, want["params"],
                   {"inputs": toks[:, :-1], "targets": toks[:, 1:]}, 3,
                   ref.OPT)
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


def test_gqa_heads_under_tensor(pool):
    """Under ``tensor=2`` (Llama tiny: 4 query heads over 2 KV heads) a
    rank's attention output at every layer is the one-rank output's
    heads ``t·H/tp … (t+1)·H/tp``: its query heads met their own KV
    heads."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    toks = ref.tokens(12)[:, :-1]
    params = ref.jax_train_run({"tensor": 1}, {}, ref.tokens(12), steps=0,
                               family="llama")["params"]
    cfg = dataclasses.replace(llama.tiny(vocab=128, seq=32),
                              dtype=torch.float32, attn_impl="dense")
    seen = []
    real = llama._dense_gqa

    def record(q, k, v, c):
        out = real(q, k, v, c)
        seen.append(out.numpy())
        return out

    llama._dense_gqa = record
    try:
        with torch.no_grad():
            llama._hidden(params_from_numpy(params, cfg, "cpu"),
                          torch.from_numpy(toks).long(), cfg)
    finally:
        llama._dense_gqa = real
    axes = {"data": 2, "tensor": 2}
    H = cfg.n_head
    for r in pool.run(pool_lib.rank_attention_heads, axes, params, toks):
        d, t = r["coords"]["data"], r["coords"]["tensor"]
        assert len(r["attn"]) == cfg.n_layer
        for got, full in zip(r["attn"], seen):
            want = full[2 * d:2 * d + 2, :, t * H // 2:(t + 1) * H // 2]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)


def test_resnet_tensor_matches_jax(pool):
    """ResNet tiny under ``(data=2, tensor=2)``: 3 steps' losses and grad
    norms and the step-0 gradient shards against the JAX program."""
    axes = {"data": 2, "tensor": 2}
    shape = tmesh.MeshConfig(**axes).resolved(4).as_dict()
    batch = ref.images(17)
    want = ref.jax_train_run(axes, {}, family="resnet", batch=batch,
                             grads=True)
    res = pool.run(pool_lib.rank_mesh_train, "resnet", axes,
                   {"tiny": ref.TINY["resnet"]}, want["params"], batch, 3,
                   ref.OPT)
    for r in res:
        ref.check_grads(r, want["grads"], pool_lib._family("resnet")[1],
                        shape, "resnet")
        np.testing.assert_allclose(r["losses"][0], want["losses"][0],
                                   atol=1e-5)
        np.testing.assert_allclose(r["norms"][0], want["norms"][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-4)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
