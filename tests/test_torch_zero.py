"""ZeRO-3 over the port's ``fsdp`` mesh axis against the JAX package's
GSPMD program on the same mesh (mirrors of ``tests/test_spmd.py``'s
``fsdp`` cases).

The port's side runs on pools of two and four gloo ranks
(``tests/rtt_mesh_pool.py``) from the JAX program's initial params
(``params_from_numpy``, then each rank's slice by the rules); the model
gathers each ``fsdp``-split leaf at use (``mesh.gather_for_use``).  The
reference's 8-device ``data=2, fsdp=2, tensor=2`` case
(``test_spmd.py:150``) is covered by the 4-rank pairs ``(data=2,
fsdp=2)`` and ``(fsdp=2, tensor=2)``: each pair of axes meets there, and
no axis acts on another's dims.

Tolerances (float32): losses 1e-5 absolute, grad norms 1e-4 relative,
every rank's step-0 gradient shard within 1e-4 of its leaf's largest
element (sums in other orders); the uneven gather's gradient 1e-5
relative; the sharded checkpoint within 1e-5 of the one-rank state after
two steps (and bitwise its own shards when placed again).  Selective
remat over a mesh must give losses bitwise equal to full remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu_torch.parallel import mesh as tmesh

LOSS_TOL = 1e-5
NORM_RTOL = 1e-4
TINY = ref.TINY["gpt2"]


@pytest.fixture(scope="module")
def pool2():
    p = pool_lib.RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"data": 2, "fsdp": 2},
                                  {"fsdp": 2, "tensor": 2}],
                         ids=["fsdp", "data-fsdp", "fsdp-tensor"])
def test_gpt2_zero3_matches_jax(pool2, pool4, axes):
    """3 steps of GPT-2 tiny under ZeRO-3: every rank's losses and grad
    norms, and its step-0 gradient shards, against the JAX program."""
    toks = ref.tokens(1)
    want = ref.jax_train_run(axes, {}, toks, grads=True)
    pool = pool2 if len(axes) == 1 else pool4
    shape = tmesh.MeshConfig(**axes).resolved(pool.world).as_dict()
    res = pool.run(pool_lib.rank_gpt2_train, axes, {"tiny": TINY},
                   want["params"], toks, 3, ref.OPT)
    assert len({tuple(sorted(r["coords"].items())) for r in res}) == \
        pool.world
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], want["norms"],
                                   rtol=NORM_RTOL)
        ref.check_grads(r, want["grads"], tmesh.TRANSFORMER_RULES, shape,
                    str(axes))


@pytest.mark.parametrize("axes", [{"fsdp": 2}, {"tensor": 2}],
                         ids=["fsdp", "tensor"])
def test_selective_remat_over_a_mesh_is_bitwise_full(pool2, axes):
    """``remat_policy="attn"`` (the flash op's outputs saved, the rest
    replayed with its gathers and collectives) over a mesh: the same
    losses, bitwise, as full remat on the same rank."""
    toks = ref.tokens(4)
    params = ref.jax_train_run({}, {}, toks, steps=0)["params"]
    runs = {p: pool2.run(pool_lib.rank_gpt2_train, axes,
                         {"tiny": TINY, "attn_impl": "flash",
                          "remat_policy": p}, params, toks, 3, ref.OPT)
            for p in ("full", "attn")}
    for full, attn in zip(runs["full"], runs["attn"]):
        assert attn["losses"] == full["losses"]
        assert attn["norms"] == full["norms"]
    assert runs["attn"][0]["losses"][-1] < runs["attn"][0]["losses"][0]


@pytest.mark.parametrize("rows", [10, 5], ids=["last-short", "last-empty"])
def test_uneven_fsdp_gather_gradient_matches_jax(pool4, rows):
    """A dim that does not divide over ``fsdp=4`` (pieces 3, 3, 3, 1 and
    2, 2, 1, 0): the gather pads, gathers and trims, and its backward's
    padded reduce-scatter gives each rank its piece of JAX's gradient."""
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((rows, 3)).astype(np.float32)
    x = rng.standard_normal((4, rows)).astype(np.float32)
    want = np.asarray(jax.grad(lambda w: jnp.sin(x @ w).sum())(w))
    pieces = []
    for r in pool4.run(pool_lib.rank_uneven_gather, w, x):
        np.testing.assert_array_equal(r["full"], w)
        lo, hi = tmesh.shard_bounds(rows, 4, r["fsdp"])
        pieces.append(r["piece_rows"])
        np.testing.assert_allclose(r["grad"], want[lo:hi], rtol=1e-5,
                                   atol=1e-6)
    assert pieces == [tmesh.shard_bounds(rows, 4, i)[1]
                      - tmesh.shard_bounds(rows, 4, i)[0] for i in range(4)]


def test_zero3_gathered_weights_die_with_their_block(pool2):
    """ZeRO-3's memory bound, counted with weak references: under remat
    no block's gathered weights outlive its forward (only the tied
    head's ``wte`` waits for the backward, which replays each block's
    gathers); without remat autograd keeps every block's four
    matrices (a bias's gradient does not read it)."""
    toks = ref.tokens(5)
    params = ref.jax_train_run({}, {}, toks, steps=0)["params"]
    head = (TINY["vocab"], 64)
    for remat in (True, False):
        for r in pool2.run(pool_lib.rank_gathered_alive, {"fsdp": 2},
                           params, toks, remat):
            block = [s for s in r["alive"] if s != head]
            # 2 layers x 6 fsdp-split leaves, wte and wpe at the embedding,
            # wte at the head
            assert r["made"] == 2 * 6 + 3
            assert r["alive_after_backward"] == []
            if remat:
                assert r["alive"] == [head], r["alive"]
                assert r["replayed"] == 2 * 6
            else:
                assert sorted(block) == sorted(
                    [(64, 3, 64), (64, 64), (64, 256), (256, 64)] * 2), \
                    r["alive"]
                assert r["replayed"] == 0


def test_sharded_checkpoint_equals_one_rank_state(pool4):
    """Train's checkpoint of a ``(data=2, fsdp=2)`` state, gathered on
    the host by its specs, has the one-rank state's layout and values
    (params and both Adam moments), and places back bitwise."""
    toks = ref.tokens(6)
    params = ref.jax_train_run({}, {}, toks, steps=0)["params"]
    for r in pool4.run(pool_lib.rank_sharded_checkpoint, "gpt2",
                       {"data": 2, "fsdp": 2}, {"tiny": TINY}, params,
                       {"tokens": toks}, 2, ref.OPT):
        assert r["placed_again"]
        got, want = ref.leaves(r["mesh"]), ref.leaves(r["one"])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            assert g.shape == w.shape, path
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=path)
