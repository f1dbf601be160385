"""GPT-2 trained over four-rank meshes through the port's
``spmd.build_train_program`` against the JAX program on the same mesh:
context parallelism (ring and Ulysses attention over ``context``) and
data × tensor (mirrors of ``tests/test_spmd.py``'s mesh tests).

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``) from the JAX program's initial params.
Each rank's losses over 3 steps must equal the JAX losses within 1e-5,
and its grad norms within 1e-4 relative (float32).
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
    p = pool_lib.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("axes, cfg_kw", [
    ({"data": 2, "context": 2}, {"attn_impl": "ring",
                                 "context_axis": "context"}),
    ({"data": 2, "context": 2}, {"attn_impl": "ulysses",
                                 "context_axis": "context"}),
    ({"data": 2, "tensor": 2}, {}),
], ids=["context-ring", "context-ulysses", "data-tensor"])
def test_gpt2_mesh_losses_match_jax(pool, axes, cfg_kw):
    toks = ref.tokens(4)
    want = ref.jax_train_run(axes, cfg_kw, toks)
    for r in pool.run(pool_lib.rank_gpt2_train, axes,
                      dict(cfg_kw, tiny=TINY), want["params"], toks, 3,
                      ref.OPT):
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=NORM_RTOL)
