"""ZeRO-3 for Llama and ResNet over ``(data=2, fsdp=2)`` against the JAX
package's program on the same mesh (mirrors of ``tests/test_models.py``'s
``test_resnet_train_step_sharded`` (:129, the reference's ``data=4,
fsdp=2`` on 8 devices, here on the pool's 4 ranks) and
``test_llama_train_step_sharded`` (:276, whose ``tensor`` axis is ROADMAP
queue A, item 8b on the port)).

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``) from the JAX program's initial params; each
model gathers its ``fsdp`` pieces at use (Llama's by ``LLAMA_RULES``,
ResNet's convs on ``cout`` and its head as an MLP output by
``RESNET_RULES``).  ResNet's zero head is drawn N(0, 0.05²) on both
sides (a zero head zeroes every other step-0 gradient), and its batch
splits on its rows alone (the reference's ``batch_rank=1``).

Tolerances (float32): the step-0 loss 1e-5 absolute and grad norm 1e-4
relative, every rank's step-0 gradient shard within 1e-4 of its leaf's
largest element; the 3 steps' losses and norms 1e-5 relative (Llama)
and 1e-4 relative (ResNet, as ``tests/test_torch_train.py``'s
trajectories: ``TRAJECTORY_RTOL``).
"""

import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu_torch.parallel import mesh as tmesh

AXES = {"data": 2, "fsdp": 2}
SHAPE = tmesh.MeshConfig(**AXES).resolved(4).as_dict()
# steps 2-3 follow two AdamW updates, whose m/√v divides small gradient
# components' rounding into whole steps: ResNet's (GroupNorm, weight
# standardisation) part at 1.4e-5 relative by step 3, so its
# trajectories are held to test_torch_train.py's 1e-4
TRAJECTORY_RTOL = {"llama": 1e-5, "resnet": 1e-4}


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("family", ["llama", "resnet"])
def test_zero3_matches_jax(pool, family):
    if family == "resnet":
        batch = ref.images(9)
        want = ref.jax_train_run(AXES, {}, family=family, batch=batch,
                                 grads=True)
    else:
        toks = ref.tokens(10)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        want = ref.jax_train_run(AXES, {}, toks, family=family, grads=True)
    rules = pool_lib._family(family)[1]
    res = pool.run(pool_lib.rank_mesh_train, family, AXES,
                   {"tiny": ref.TINY[family]}, want["params"], batch, 3,
                   ref.OPT)
    for r in res:
        ref.check_grads(r, want["grads"], rules, SHAPE, family)
        np.testing.assert_allclose(r["losses"][0], want["losses"][0],
                                   atol=1e-5)
        np.testing.assert_allclose(r["norms"][0], want["norms"][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=TRAJECTORY_RTOL[family])
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=TRAJECTORY_RTOL[family])
    assert res[0]["losses"][-1] < res[0]["losses"][0]
