"""GPT-2's chunked cross entropy over a mesh against the JAX package's
chunked loss on the same mesh (the reference's ``tests/test_spmd.py:57-95``
holds its chunked losses to the unchunked one).

``loss_chunks=4`` cuts a rank's token range into checkpointed chunks,
each a vocabulary-parallel log-sum-exp over ``tensor``;
``loss_vocab_chunks=3`` (a count that does not divide GPT-2 tiny's
vocabulary slice of 64) runs an online log-sum-exp over a rank's slice,
its last chunk padded past the slice, then meets the other ranks'
through ``pmax`` / ``psum``.  Each runs under ``tensor=2``,
``(data=2, tensor=2)`` and ``seq=2`` (the manual block: the chunked
heads read the token range all-gathered over ``tensor``), and is held
to the JAX program's chunked loss and gradients and to the port's own
unchunked loss on the same mesh.

The port's side runs on pools of 2 and 4 gloo ranks
(``tests/rtt_mesh_pool.py``).

Tolerances (float32): the loss 1e-5 absolute against JAX and 1e-6
relative against the port's unchunked mesh loss (the same sums in other
orders), every rank's gradient shard within 1e-4 of its leaf's largest
element against JAX and 1e-5 against the unchunked one (the same
rank's slice).
"""

import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import transforms as tx

MESHES = {"tensor2": {"tensor": 2}, "data2_tensor2": {"data": 2,
                                                      "tensor": 2},
          "seq2": {"seq": 2}}
CHUNKS = {"loss_chunks": {"loss_chunks": 4},
          "loss_vocab_chunks": {"loss_vocab_chunks": 3}}
UNCHUNKED: dict = {}


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


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("layout", list(MESHES))
def test_chunked_ce_over_mesh(pools, layout, chunks):
    axes = MESHES[layout]
    world = int(np.prod(list(axes.values())))
    shape = tmesh.MeshConfig(**axes).resolved(world).as_dict()
    toks = ref.tokens(16)
    want = ref.jax_train_run(axes, CHUNKS[chunks], toks, steps=0,
                             grads=True)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    tiny = {"tiny": ref.TINY["gpt2"]}
    pool = pools(world)
    got = pool.run(pool_lib.rank_mesh_loss, "gpt2", axes,
                   {**tiny, **CHUNKS[chunks]}, want["params"], batch)
    if layout not in UNCHUNKED:     # the same params and batch each time
        UNCHUNKED[layout] = pool.run(pool_lib.rank_mesh_loss, "gpt2", axes,
                                     tiny, want["params"], batch)
    plain = UNCHUNKED[layout]
    rules = pool_lib._family("gpt2")[1]
    for r, u in zip(got, plain):
        np.testing.assert_allclose(r["loss"], want["loss0"], atol=1e-5)
        np.testing.assert_allclose(r["loss"], u["loss"], rtol=1e-6)
        ref.check_grads(r, want["grads"], rules, shape, f"{layout} jax")
        for (path, g), (_, w) in zip(tx.tree_leaves_with_path(r["grads"]),
                                     tx.tree_leaves_with_path(u["grads"])):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * max(float(np.abs(w).max()), 1e-12),
                err_msg=f"{layout} unchunked {path}")
