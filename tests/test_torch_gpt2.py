"""ray_tpu_torch GPT-2 (serving subset) held against ray_tpu.models.gpt2.

Weights come from the JAX init and cross by ``params_from_numpy``; both
sides run in float32 on the CPU.  ``n_embd=128`` with
``attn_impl="flash"`` makes the JAX side run both Pallas kernels (in
interpret mode) and the port's side their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jgpt2.tiny(), n_embd=128, dtype=jnp.float32,
                               attn_impl="flash")
    tcfg = dataclasses.replace(tgpt2.tiny(), n_embd=128, dtype=torch.float32,
                               attn_impl="flash")
    jparams = jgpt2.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def test_forward_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(2, 32, jcfg.vocab_size)
    ref = np.asarray(jgpt2.forward(jp, jnp.asarray(toks), jcfg))
    got = tgpt2.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_forward_blockwise_matches_jax(models):
    """attn_impl="blockwise": the reference's lax.scan over KV blocks
    against the port's loop over them."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, attn_impl="blockwise")
    tcfg = dataclasses.replace(tcfg, attn_impl="blockwise")
    toks = _tokens(2, 32, jcfg.vocab_size, seed=3)
    ref = np.asarray(jgpt2.forward(jp, jnp.asarray(toks), jcfg))
    got = tgpt2.forward(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_forward_prefill_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(1, 32, jcfg.vocab_size, seed=1)
    last = 20
    jl, jk, jv = jgpt2.forward_prefill(jp, jnp.asarray(toks), jcfg,
                                       last_pos=jnp.int32(last))
    tl, tk, tv = tgpt2.forward_prefill(tp, torch.from_numpy(toks).long(),
                                       tcfg, last_pos=last)
    assert tuple(tl.shape) == (1, jcfg.vocab_size)
    assert tuple(tk.shape) == jk.shape == (2, 1, 32, 4, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_forward_decode_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(2)
    L, H, D, bs, N = jcfg.n_layer, jcfg.n_head, jcfg.head_dim, 4, 12
    pool = rng.standard_normal((N, L, 2, bs, H, D)).astype(np.float32)
    tables = np.array([[3, 7, 1, 0], [5, 2, 9, 11], [4, 4, 4, 4]], np.int32)
    lens = np.array([10, 14, 1], np.int32)
    toks = np.array([5, 17, 200], np.int32)
    pos = lens.copy()
    jl, jk, jv = jgpt2.forward_decode(
        jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lens), jcfg)
    i64 = [torch.from_numpy(a).long() for a in (toks, pos)]
    tl, tk, tv = tgpt2.forward_decode(
        tp, *i64, torch.from_numpy(pool), torch.from_numpy(tables).long(),
        torch.from_numpy(lens).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_jax(dtype):
    """The CPU's attention (what ``auto`` resolves to off the card), in
    both activation dtypes: bf16 scores are masked in float32, as the
    reference's ``jnp.where`` promotes them."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
               for _ in range(3))
    ref = jgpt2.dense_causal_attention(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), None)
    got = tgpt2.dense_causal_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        None)
    assert got.dtype == getattr(torch, dtype)
    # bf16: one bf16 step (2^-7 relative) of |out| <= max|v| ~ 3
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * 4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol)


@pytest.mark.parametrize("E", [64, 128])
def test_layer_norm_matches_both_reference_branches(E):
    """The port takes the fused op at every E; the reference takes its
    Pallas kernel at E % 128 == 0 and the inline branch otherwise."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, E)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    b = (0.1 * rng.standard_normal(E)).astype(np.float32)
    ref = np.asarray(jgpt2._layer_norm(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b)))
    got = tgpt2._layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_params_numpy_round_trip(models):
    jcfg, tcfg, jp, tp = models
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_init_params_shapes_and_count_match_jax():
    jcfg = jgpt2.tiny()
    tcfg = tgpt2.tiny()
    jshapes = jax.tree.map(lambda a: a.shape, jgpt2.init_params(
        jax.random.key(0), jcfg))
    p1 = tgpt2.init_params(torch.Generator().manual_seed(7), tcfg, "cpu")
    p2 = tgpt2.init_params(torch.Generator().manual_seed(7), tcfg, "cpu")
    tshapes = jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(p1))
    assert tshapes == jshapes
    for a, b in zip(jax.tree.leaves(params_to_numpy(p1)),
                    jax.tree.leaves(params_to_numpy(p2))):
        np.testing.assert_array_equal(a, b)     # seeded: reproducible
    n = sum(a.size for a in jax.tree.leaves(params_to_numpy(p1)))
    assert n == tgpt2.param_count_analytic(tcfg) \
        == jgpt2.param_count_analytic(jcfg)
    assert p1["wte"].dtype == torch.float32


def test_auto_attention_is_flash_on_cuda():
    cfg = tgpt2.gpt2_small()
    assert tgpt2.resolved_attn_impl(cfg, torch.device("cuda")) == "flash"
    assert tgpt2.resolved_attn_impl(cfg, torch.device("cpu")) == "dense"
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert (cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.head_dim,
            cfg.vocab_size, cfg.n_positions) == (768, 12, 12, 64, 50257, 1024)


def test_init_params_raises_without_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt2.init_params(torch.Generator(), tgpt2.tiny())
    tgpt2.init_params(torch.Generator(), tgpt2.tiny(), device="cpu")
