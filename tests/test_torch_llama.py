"""ray_tpu_torch Llama (serving half) held against ray_tpu.models.llama.

Weights come from the JAX init and cross by ``params_from_numpy``; both
sides run in float32 on the CPU.  The config is ``llama.tiny()`` widened
to E = 256 with 2 query heads over 1 KV head, so the head dim is Llama-3
8B's 128 and every block reads grouped K/V.  ``attn_impl="flash"`` makes
the JAX side run its Pallas kernel (interpret mode) on K/V expanded by
``_gqa_expand``, and the port's side the plain version of its flash
kernel, which expands the groups itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

# float32 on both sides; sums in other orders through two blocks: the
# same limit as tests/test_torch_gpt2.py.
ATOL = 1e-4
# RMSNorm and RoPE alone: a few float32 roundings of O(1) values (the
# inputs' scale is 1; rope's frequencies are bitwise equal, its angles up
# to 8191 rad carry the cos/sin implementations' last-bit differences).
OP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WIDE = dict(n_embd=256, n_head=2, n_kv_head=1)      # head dim 128


def _cfgs(attn_impl="dense"):
    jcfg = dataclasses.replace(jllama.tiny(), dtype=jnp.float32,
                               attn_impl=attn_impl, **WIDE)
    tcfg = dataclasses.replace(tllama.tiny(), dtype=torch.float32,
                               attn_impl=attn_impl, **WIDE)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    assert jcfg.head_dim == 128
    return jllama.init_params(jax.random.key(0), jcfg)


@pytest.fixture(scope="module")
def tparams(jparams):
    _, tcfg = _cfgs()
    return params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_matches_jax(jparams, tparams, attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    toks = _tokens(2, 32, jcfg.vocab_size)
    ref = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = tllama.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_forward_prefill_matches_jax(jparams, tparams):
    jcfg, tcfg = _cfgs("flash")
    toks = _tokens(1, 32, jcfg.vocab_size, seed=1)
    last = 20
    jl, jk, jv = jllama.forward_prefill(jparams, jnp.asarray(toks), jcfg,
                                        last_pos=jnp.int32(last))
    tl, tk, tv = tllama.forward_prefill(
        tparams, torch.from_numpy(toks).long(), tcfg, last_pos=last)
    assert tuple(tl.shape) == (1, jcfg.vocab_size)
    # keys post-RoPE, values pre-expand: (L, B, T, KV, D)
    assert tuple(tk.shape) == jk.shape == (2, 1, 32, 1, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_forward_decode_matches_jax(jparams, tparams):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    L, KV, D, bs, N = jcfg.n_layer, jcfg.n_kv_head, jcfg.head_dim, 4, 12
    pool = rng.standard_normal((N, L, 2, bs, KV, D)).astype(np.float32)
    tables = np.array([[3, 7, 1, 0], [5, 2, 9, 11], [4, 4, 4, 4]], np.int32)
    lens = np.array([10, 14, 1], np.int32)
    toks = np.array([5, 17, 100], np.int32)
    pos = lens.copy()
    jl, jk, jv = jllama.forward_decode(
        jparams, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lens), jcfg)
    i64 = [torch.from_numpy(a).long() for a in (toks, pos)]
    tl, tk, tv = tllama.forward_decode(
        tparams, *i64, torch.from_numpy(pool),
        torch.from_numpy(tables).long(), torch.from_numpy(lens).long(), tcfg)
    assert tuple(tk.shape) == jk.shape == (L, 3, KV, D)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


# ------------------------------------------------ the ops at llama3-8b's
THETA, D8B = tllama.llama3_8b().rope_theta, tllama.llama3_8b().head_dim


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 4096)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(4096)).astype(np.float32)
    ref = np.asarray(jllama._rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = tllama._rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=OP_ATOL, rtol=0)


def test_rope_matches_jax_at_every_position():
    """(1, 8192, 2, 128), theta 500000: positions 0..8191."""
    assert (THETA, D8B) == (500000.0, 128)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8192, 2, D8B)).astype(np.float32)
    ref = np.asarray(jllama._rope(jnp.asarray(x), THETA))
    got = tllama._rope(torch.from_numpy(x), THETA)
    np.testing.assert_allclose(got.numpy(), ref, atol=OP_ATOL, rtol=0)


def test_rope_at_matches_jax():
    rng = np.random.default_rng(5)
    pos = np.array([0, 1, 17, 1023, 2047, 4096, 8190, 8191], np.int32)
    x = rng.standard_normal((len(pos), 8, D8B)).astype(np.float32)
    ref = np.asarray(jllama._rope_at(jnp.asarray(x), jnp.asarray(pos),
                                     THETA))
    got = tllama._rope_at(torch.from_numpy(x), torch.from_numpy(pos).long(),
                          THETA)
    np.testing.assert_allclose(got.numpy(), ref, atol=OP_ATOL, rtol=0)
    # a token at position p rotates as row p of the full-sequence rope
    full = tllama._rope(torch.from_numpy(
        np.broadcast_to(x[-1], (8192, 8, D8B)).copy())[None], THETA)
    np.testing.assert_allclose(got[-1].numpy(), full[0, 8191].numpy(),
                               atol=OP_ATOL, rtol=0)


# -------------------------------------------------------------- params
def test_init_params_matches_jax_leaf_by_leaf(jparams):
    """Keys, shapes, dtypes and scales: norm scales exactly 1; every
    matrix's std within 3 % of the reference's scale (0.02, or
    0.02/sqrt(2L) for wo and w_down) and of the JAX leaf's own std, means
    near 0 (at >= 32768 draws a leaf, the sampling error of a std is
    under 0.5 %)."""
    jcfg, tcfg = _cfgs()
    tp = params_to_numpy(tllama.init_params(
        torch.Generator().manual_seed(7), tcfg, "cpu"))
    jp = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    out_scale = 0.02 / np.sqrt(2 * jcfg.n_layer)
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, j), t in zip(paths, jax.tree.leaves(tp)):
        name = jax.tree_util.keystr(path)
        assert t.shape == j.shape and t.dtype == np.float32, name
        if "norm" in name:
            np.testing.assert_array_equal(t, np.ones_like(j))
            np.testing.assert_array_equal(j, np.ones_like(j))
            continue
        scale = out_scale if ("wo" in name or "w_down" in name) else 0.02
        for leaf in (t, j):
            assert abs(leaf.std() / scale - 1) < 0.03, name
            assert abs(leaf.mean()) < 0.03 * scale, name
    again = params_to_numpy(tllama.init_params(
        torch.Generator().manual_seed(7), tcfg, "cpu"))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)          # seeded: reproducible


def test_init_params_llama3_8b_shapes_and_count_match_jax():
    """The 8 B preset's leaf shapes and parameter count, without drawing:
    torch's meta device against jax.eval_shape."""
    jcfg, tcfg = jllama.llama3_8b(), tllama.llama3_8b()
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jllama.init_params(k, jcfg), jax.random.key(0)))
    tp = tllama.init_params(None, tcfg, "meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(tp))
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert tshapes == jshapes
    n = sum(t.numel() for t in jax.tree.leaves(tp))
    assert n == sum(int(np.prod(s)) for s in jax.tree.leaves(
        jshapes, is_leaf=lambda x: isinstance(x, tuple))) == 8_030_261_248
    assert (tcfg.n_embd, tcfg.n_layer, tcfg.n_head, tcfg.n_kv_head,
            tcfg.head_dim, tcfg.ffn_dim, tcfg.vocab_size, tcfg.rope_theta,
            tcfg.max_positions) == (4096, 32, 32, 8, 128, 14336, 128256,
                                    500000.0, 8192)
    assert tcfg.dtype == torch.bfloat16 and tcfg.param_dtype == torch.float32


def test_params_numpy_round_trip(jparams, tparams):
    """params_from_numpy carries the JAX Llama tree across unchanged, and
    params_to_numpy brings it back bit for bit."""
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_auto_attention_is_flash_on_cuda_and_context_parallel_raises():
    from ray_tpu_torch.models.gpt2 import resolved_attn_impl
    cfg = tllama.llama3_8b()
    assert cfg.attn_impl == "auto"
    assert resolved_attn_impl(cfg, torch.device("cuda")) == "flash"
    assert resolved_attn_impl(cfg, torch.device("cpu")) == "dense"
    toks = torch.zeros((1, 4), dtype=torch.long)
    _, tcfg = _cfgs("ring")
    tp = tllama.init_params(torch.Generator(), tcfg, "cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        tllama.forward(tp, toks, tcfg)
