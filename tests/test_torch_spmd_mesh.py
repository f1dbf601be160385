"""GPT-2 trained over meshes of ranks through the port's
``spmd.build_train_program`` against the JAX program on the same mesh
(mirrors of ``tests/test_spmd.py``'s and ``tests/test_collective_matmul.py``'s
mesh tests).

The port's side runs on a pool of two gloo ranks
(``tests/rtt_mesh_pool.py``) from the JAX program's initial params
(``params_from_numpy``, then each rank's slice by the rules).  Each
rank's losses over 3 steps must equal the JAX losses within 1e-5, and
its grad norms within 1e-4 relative (float32).
"""

import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib

LOSS_TOL = 1e-5
NORM_RTOL = 1e-4
TINY = {"vocab": 128, "seq": 32}


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("axes", [{"tensor": 2}, {"seq": 2}],
                         ids=["tensor", "seq"])
def test_gpt2_mesh_losses_match_jax(pool, axes):
    """The overlap-scheduled block (decomposed collective matmuls over
    ``tensor``; the KV ring over ``seq``) and the vocab-parallel head."""
    toks = ref.tokens(1)
    want = ref.jax_train_run(axes, {}, toks)
    for r in pool.run(pool_lib.rank_gpt2_train, axes, {"tiny": TINY},
                      want["params"], toks, 3, ref.OPT):
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=NORM_RTOL)


def _torch_params():
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import transforms as tx
    return tx.tree_map(lambda t: t.numpy(), gpt2.init_params(
        torch.Generator().manual_seed(0), gpt2.tiny(**TINY), "cpu"))


def test_overlapped_step_loss_continuity(pool):
    """10 steps under ``tensor=2``: the decomposed rings ("auto"), the
    un-decomposed pair ("off") and, at a sequence that does not split
    over tensor (31 tokens), the Megatron block follow the data-parallel
    run's trajectory (the one-device math); and it trains."""
    params = _torch_params()
    toks = ref.tokens(2)
    cases = {"auto": ({}, toks), "off": ({"collective_matmul": "off"}, toks),
             "megatron": ({}, toks[:, :32])}
    for name, (kw, t) in cases.items():
        want = pool.run(pool_lib.rank_gpt2_train, {"data": 2},
                        {"tiny": TINY}, params, t, 10, ref.OPT)[0]["losses"]
        got = pool.run(pool_lib.rank_gpt2_train, {"tensor": 2},
                       dict(kw, tiny=TINY), params, t, 10, ref.OPT)
        for r in got:
            np.testing.assert_allclose(r["losses"], want, rtol=1e-4,
                                       err_msg=name)
        assert got[0]["losses"][-1] < got[0]["losses"][0]


def test_seq_axis_requires_compatible_shapes(pool):
    """A mesh with seq > 1 must not fall back quietly: a sequence that
    does not split over seq raises (31 tokens over seq=2)."""
    with pytest.raises(RuntimeError, match="seq"):
        pool.run(pool_lib.rank_gpt2_train, {"seq": 2}, {"tiny": TINY},
                 _torch_params(), ref.tokens(3)[:, :32], 1, ref.OPT)
