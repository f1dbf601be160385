"""ray_tpu_torch ops held against the JAX reference on the CPU.

Inputs are made with numpy from a seed and go through both sides in
float32.  On the JAX side the Pallas kernels run in interpret mode
(``interpret=None`` picks it off-TPU); on the port's side a CPU tensor
takes each kernel's plain PyTorch version.  The CUDA kernels themselves
run only on the card: ``test_torch_cuda.py`` holds them against their
plain versions there (``chip_smoke.py`` does the same at full width).
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as t_attn
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import layer_norm as t_ln
from ray_tpu_torch.ops import paged_attention as t_paged

# ray_tpu.ops re-exports functions under its modules' names: import the
# modules themselves
j_attn = importlib.import_module("ray_tpu.ops.attention")
j_flash = importlib.import_module("ray_tpu.ops.flash_attention")
j_ln = importlib.import_module("ray_tpu.ops.layer_norm")
j_paged = importlib.import_module("ray_tpu.ops.paged_attention")

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ layer norm
@pytest.mark.parametrize("E", [128, 768])
def test_layer_norm_plain_matches_jax(E):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, E)).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(E)).astype(np.float32)
    ref = np.asarray(j_ln.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias)))
    got = t_ln.layer_norm_plain(_t(x), _t(scale), _t(bias)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_stats_match_jax_residuals():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((21, 128)).astype(np.float32)
    scale = np.ones(128, np.float32)
    bias = np.zeros(128, np.float32)
    _, mu, rstd = j_ln._ln_fwd(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 1e-5, None)
    _, tmu, trstd = t_ln.ln_fwd(_t(x), _t(scale), _t(bias), 1e-5,
                                want_stats=True)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu)[0], atol=1e-6)
    np.testing.assert_allclose(trstd.numpy(), np.asarray(rstd)[0],
                               rtol=1e-5)


def test_layer_norm_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((5, 96)).astype(np.float32))
    s, b = torch.ones(96), torch.zeros(96)
    before = t_ln.launches
    assert torch.equal(t_ln.layer_norm(x, s, b), t_ln.layer_norm_plain(x, s, b))
    assert t_ln.launches == before          # no kernel on a CPU tensor
    y, mu, rstd = t_ln.ln_fwd(x, s, b)
    assert mu is None and rstd is None


BF16, F32 = torch.bfloat16, torch.float32


# (N, E, row stride, misaligned bytes, dtype, backward) on 132 SMs ->
# (route, blocks)
@pytest.mark.parametrize("args,want", [
    # the train step's rows: a grid of 4 blocks an SM walks them
    ((32768, 768, 768, 0, BF16, False), ("vector", 4 * 132)),
    # the longest prefill bucket and the decode batch: a row a warp
    ((1024, 768, 768, 0, BF16, False), ("vector", 256)),
    ((16, 768, 768, 0, BF16, False), ("vector", 4)),
    ((1, 768, 768, 0, F32, False), ("vector", 1)),
    ((0, 768, 768, 0, BF16, False), ("vector", 0)),
    # a view of x with a row stride, still 8-element aligned
    ((1024, 768, 2304, 0, BF16, False), ("vector", 256)),
    # base one bf16 / one f32 element off a 16-byte boundary
    ((1024, 768, 768, 2, BF16, False), ("scalar", 256)),
    ((1024, 768, 768, 4, F32, False), ("scalar", 256)),
    # a row stride that is not a multiple of 8 elements
    ((1024, 768, 769, 0, BF16, False), ("scalar", 256)),
    # E not a multiple of 8
    ((1024, 100, 100, 0, BF16, False), ("scalar", 256)),
    # GPT-2 medium, large and xl's rows: the wide-row kernels, 3 forward
    # blocks an SM, up to E 2048; wider rows take the scalar kernel
    ((8192, 1024, 1024, 0, BF16, False), ("wide", 3 * 132)),
    ((8192, 1280, 1280, 0, BF16, False), ("wide", 3 * 132)),
    ((32768, 1600, 1600, 0, BF16, False), ("wide", 3 * 132)),
    ((333, 1600, 1600, 0, BF16, False), ("wide", 84)),
    ((8192, 2048, 2048, 0, F32, False), ("wide", 3 * 132)),
    ((8192, 2056, 2056, 0, BF16, False), ("scalar", 2048)),
    ((8192, 1600, 1600, 2, BF16, False), ("scalar", 2048)),
    # backward: 3 bf16 or 2 float32 blocks an SM, or fewer where rows
    # run out; the wide-row kernel 2; the scalar kernel 2 an SM
    ((32768, 768, 768, 0, BF16, True), ("vector", 3 * 132)),
    ((32768, 768, 768, 0, F32, True), ("vector", 2 * 132)),
    ((333, 768, 768, 0, BF16, True), ("vector", 84)),
    ((0, 768, 768, 0, BF16, True), ("vector", 1)),
    ((32768, 768, 768 | 769, 0, BF16, True), ("scalar", 264)),
    ((32768, 1600, 1600, 0, F32, True), ("wide", 2 * 132)),
    ((8192, 1600, 1600, 0, BF16, True), ("wide", 2 * 132)),
    ((333, 1280, 1280, 0, BF16, True), ("wide", 84)),
    ((32768, 1600, 1600 | 1601, 0, BF16, True), ("scalar", 264)),
])
def test_layer_norm_launch_plan(args, want):
    """The wrapper's choice of instantiation and grid, a pure function of
    the call's shape, strides, alignment, dtype and SM count."""
    N, E, stride, misalign, dtype, backward = args
    assert t_ln.launch_plan(N, E, stride, misalign, dtype, 132,
                            backward=backward) == want


def test_layer_norm_launch_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_ln.launch_plan(16, 768, 768, 0, torch.float16, 132)


@pytest.mark.parametrize("E", [1024, 1280, 1600])
def test_layer_norm_wide_rows_match_jax(E):
    """GPT-2 medium, large and xl's rows (the wide-row kernels' widths):
    the port's LayerNorm on the CPU (the plain forward and backward
    through its autograd Function) against the reference's Pallas kernels
    in interpret mode at E 1024 and 1280, and at E 1600, which the
    reference's gpt2._layer_norm sends to its plain branch (E % 128 !=
    0), against that branch: the output and jax.grad of x, scale and bias
    to 1e-4 (float32 sums over 1600 columns and 24 rows in other
    orders).  launch_plan gives these aligned rows the wide-row kernels,
    forward and backward."""
    import jax
    from ray_tpu.models import gpt2 as j_gpt2
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 12, E)).astype(np.float32) * 2 + 0.5
    s = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    b = (0.1 * rng.standard_normal(E)).astype(np.float32)
    w = rng.standard_normal((2, 12, E)).astype(np.float32)
    ref_fn = j_ln.layer_norm if E % 128 == 0 else j_gpt2._layer_norm
    args = [jnp.asarray(a) for a in (x, s, b)]
    ref_y = np.asarray(ref_fn(*args))
    ref = jax.grad(lambda *a: (ref_fn(*a) * w).sum(), argnums=(0, 1, 2))(
        *args)
    out, got = _torch_grads(t_ln.layer_norm, (x, s, b), w)
    np.testing.assert_allclose(out.detach().numpy(), ref_y, atol=1e-5,
                               rtol=1e-5)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)
    for dt in (BF16, F32):
        for backward in (False, True):
            assert t_ln.launch_plan(8192, E, E, 0, dt, 132,
                                    backward=backward)[0] == "wide"


def test_layer_norm_output_keeps_input_dtype():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    y = t_ln.layer_norm(x.to(torch.bfloat16), torch.ones(64), torch.zeros(64))
    assert y.dtype == torch.bfloat16


# --------------------------------------------------------- flash attention
def _qkv(rng, B, T, H, D):
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(causal):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 64, 2, 16)
    ref = np.asarray(j_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 16))
    got = t_flash.flash_attention_plain(_t(q), _t(k), _t(v), causal).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 32, 3, 16)
    _, lse = j_flash._flash_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_size=16, interpret=None)
    _, tlse = t_flash.flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                            want_lse=True)
    assert tlse.shape == (3, 32)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, 0],
                               atol=2e-5)


def test_flash_ragged_length_matches_dense():
    """Any T: no dense fallback, the plain version (like the kernel)
    takes a length no tile divides."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 37, 2, 8)
    ref = np.asarray(j_attn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = t_flash.flash_attention_for_model(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    port_dense = t_attn.dense_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(port_dense.numpy(), ref, atol=2e-5)


def test_flash_reads_strided_views():
    """The qkv split's strided views give the same result as copies."""
    rng = np.random.default_rng(6)
    qkv = _t(rng.standard_normal((2, 24, 3, 32)).astype(np.float32))
    q, k, v = [qkv[:, :, i].unflatten(-1, (4, 8)) for i in range(3)]
    assert not q.is_contiguous()
    got = t_flash.flash_attention(q, k, v, True)
    ref = t_flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), True)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


# ------------------------------------- grouped-query attention, D = 128
j_llama = importlib.import_module("ray_tpu.models.llama")


def _gqa_qkv(rng, B, T, H, KV, D):
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32))


def test_gqa_expand_matches_jax():
    """KV head j serves query heads j*G .. j*G + G - 1 (jnp.repeat)."""
    kv = np.random.default_rng(20).standard_normal((1, 3, 4, 8)) \
        .astype(np.float32)
    ref = np.asarray(j_llama._gqa_expand(jnp.asarray(kv), 12))
    got = t_flash.gqa_expand(_t(kv), 12).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_d128_plain_matches_jax(causal):
    """H 4 over KV 2 at head dim 128: the plain version reads the KV heads
    as given; the reference's kernel (interpret mode, block 16) runs on
    K/V its model expands with _gqa_expand."""
    rng = np.random.default_rng(21)
    q, k, v = _gqa_qkv(rng, 1, 64, 4, 2, 128)
    ke, ve = (j_llama._gqa_expand(jnp.asarray(a), 4) for a in (k, v))
    ref = np.asarray(j_flash.flash_attention(jnp.asarray(q), ke, ve, causal,
                                             16))
    got = t_flash.flash_attention(_t(q), _t(k), _t(v), causal).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_flash_gqa_d128_ragged_length_matches_dense():
    """T = 77: no tile divides it; held to the reference's dense attention
    on the same expanded K/V."""
    rng = np.random.default_rng(22)
    q, k, v = _gqa_qkv(rng, 2, 77, 4, 2, 128)
    ke, ve = (j_llama._gqa_expand(jnp.asarray(a), 4) for a in (k, v))
    ref = np.asarray(j_attn.dense_attention(jnp.asarray(q), ke, ve,
                                            causal=True))
    got = t_flash.flash_attention_for_model(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_flash_gqa_lse_is_per_query_head():
    """The lse stays (B·H, T): one row per query head, whatever KV."""
    rng = np.random.default_rng(23)
    q, k, v = (_t(a) for a in _gqa_qkv(rng, 2, 16, 4, 1, 128))
    _, lse = t_flash.flash_attention_plain(q, k, v, True, want_lse=True)
    _, ref = t_flash.flash_attention_plain(
        q, t_flash.gqa_expand(k, 4), t_flash.gqa_expand(v, 4), True,
        want_lse=True)
    assert lse.shape == (8, 16)
    torch.testing.assert_close(lse, ref, atol=0, rtol=0)


def test_flash_wrapper_rules():
    """KV must divide H on every device; the kernel wrapper refuses head
    dims outside HEAD_DIMS and a float32 head dim 128 before it builds or
    launches anything (CPU tensors reach the same checks)."""
    z = torch.zeros
    with pytest.raises(ValueError, match="must divide"):
        t_flash.flash_attention(z(1, 8, 6, 128), z(1, 8, 4, 128),
                                z(1, 8, 4, 128))
    with pytest.raises(ValueError, match="must divide"):
        t_flash._flash_kernel(z(1, 8, 6, 64), z(1, 8, 4, 64),
                              z(1, 8, 4, 64), True, False)
    with pytest.raises(ValueError, match="head dims"):
        t_flash._flash_kernel(z(1, 8, 4, 96), z(1, 8, 4, 96),
                              z(1, 8, 4, 96), True, False)
    with pytest.raises(ValueError, match="float32 flash kernel"):
        t_flash._flash_kernel(z(1, 8, 4, 128), z(1, 8, 2, 128),
                              z(1, 8, 2, 128), True, False)
    with pytest.raises(ValueError, match="block_m"):
        t_flash._flash_kernel(*(z(1, 8, 4, 128, dtype=torch.bfloat16)
                                for _ in range(3)), True, False, 128)
    assert t_flash.HEAD_DIMS == (64, 128)
    assert t_flash.BLOCK_MS == {64: (64, 128), 128: (64,)}
    # the backward kernels: bf16 at head dim 64 without KV groups or at
    # 128; float32 at 64 without KV groups
    q, kv = (z(1, 8, n, 64, dtype=torch.bfloat16) for n in (4, 2))
    with pytest.raises(ValueError, match="bf16 flash backward"):
        t_flash._flash_bwd_kernel(q, kv, kv, z(4, 8), z(4, 8), q, True)
    with pytest.raises(ValueError, match="float32 flash backward"):
        t_flash._flash_bwd_kernel(z(1, 8, 4, 128), z(1, 8, 4, 128),
                                  z(1, 8, 4, 128), z(4, 8), z(4, 8),
                                  z(1, 8, 4, 128), True)
    with pytest.raises(ValueError, match="must divide"):
        t_flash.flash_attention_bwd(z(1, 8, 6, 128), z(1, 8, 4, 128),
                                    z(1, 8, 4, 128), z(6, 8), z(6, 8),
                                    z(1, 8, 6, 128))


@pytest.mark.parametrize("kv,d", [(2, 128), (2, 64), (4, 128)])
def test_flash_gqa_or_d128_under_grad_raises(kv, d):
    """Grouped K/V and head dim 128 under autograd (they raised until the
    Llama training slice ported the backward): the gradients of q, k and
    v, with k and v keeping their KV heads, against jax.grad of the
    reference's flash attention (interpret mode, block 16) over K/V
    expanded by _gqa_expand; the forward without grad is unchanged."""
    import jax
    rng = np.random.default_rng(24)
    q, k, v = _gqa_qkv(rng, 1, 32, 4, kv, d)
    w = _cotangent(32)
    ref = jax.grad(lambda q_, k_, v_: (j_flash.flash_attention(
        q_, j_llama._gqa_expand(k_, 4), j_llama._gqa_expand(v_, 4), True,
        16) * w).sum(), argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    out, got = _torch_grads(t_flash.flash_attention, (q, k, v), w)
    assert "ray_tpu_torch_flash_fwd" in out.grad_fn.name()
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)
    with torch.no_grad():                      # inference as before
        assert t_flash.flash_attention(_t(q), _t(k), _t(v)).shape == \
            (1, 32, 4, d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [2, 4])
def test_flash_bwd_plain_gqa_d128_matches_jax(G, causal):
    """The plain backward at head dim 128 with G query heads a KV head,
    given the KV heads, against jax.vjp of the reference's flash attention
    over K/V expanded by jnp.repeat (_gqa_expand): the reference's dk and
    dv come per query head and are summed through the repeat's transpose,
    the plain version sums in float32 and rounds once; in float32 the two
    points agree.  Block 16 gives the reference four key blocks."""
    import jax
    rng = np.random.default_rng(25)
    B, T, H, D = 1, 64, 4, 128
    q, k, v = _gqa_qkv(rng, B, T, H, H // G, D)
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_flash.flash_attention(
        q_, j_llama._gqa_expand(k_, H), j_llama._gqa_expand(v_, H), causal,
        16), *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    out, lse = t_flash.flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                             want_lse=True)
    delta = (_t(do) * out).sum(-1).transpose(1, 2).reshape(B * H, T)
    got = t_flash.flash_attention_bwd_plain(_t(q), _t(k), _t(v), lse, delta,
                                            _t(do), causal)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("G", [2, 4])
def test_flash_bwd_gqa_group_sum_points_within_derived_bound(G):
    """bf16: the kernel's point (dk, dv summed over the group in float32,
    rounded once) against the reference's (each query head's dk, dv
    rounded to bf16, then summed by the transpose of jnp.repeat, in JAX,
    in bf16), from the same float32 per-head sums a_h.  With u = 2^-8
    (bf16's unit roundoff) and S = sum_h a_h, the kernel's value is
    within u|S| of S; the reference's per-head roundings move the sum by
    at most u·sum|a_h|, and its G - 1 additions, if each is rounded to
    bf16, by at most (G - 1)·u·(1 + u)·sum|a_h|.  So
        |kernel - reference| <= u|S| + G·u·(1 + u)·sum|a_h|,
    plus float32 noise; and the two points do differ somewhere."""
    import jax
    import math
    rng = np.random.default_rng(26)
    B, T, H, D = 1, 128, 8, 128
    bf = torch.bfloat16
    q, k, v = (_t(a).to(bf) for a in _gqa_qkv(rng, B, T, H, H // G, D))
    do = _t(rng.standard_normal((B, T, H, D)).astype(np.float32)).to(bf)
    out, lse = t_flash.flash_attention_plain(q, k, v, True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(B * H, T)
    _, dk_h, dv_h = t_flash._bwd_sums(q, k, v, lse, delta, do, True)
    _, dk, dv = t_flash.flash_attention_bwd_plain(q, k, v, lse, delta, do,
                                                  True)
    u = 2.0 ** -8
    _, transpose = jax.vjp(lambda x: j_llama._gqa_expand(x, H),
                           jnp.zeros((B, T, H // G, D), jnp.bfloat16))
    differ = 0
    for got, per_head in ((dk, dk_h / math.sqrt(D)), (dv, dv_h)):
        rounded = jnp.asarray(per_head.to(bf).float().numpy(), jnp.bfloat16)
        ref = np.asarray(transpose(rounded)[0], np.float32)
        S = t_flash.group_sum(per_head, H // G).double()
        A = t_flash.group_sum(per_head.abs(), H // G).double()
        bound = u * S.abs() + G * u * (1 + u) * A + 1e-6 * A
        err = (got.double() - torch.from_numpy(ref).double()).abs()
        assert (err <= bound).all(), (err / bound).max()
        differ += int((err > 0).sum())
    assert differ > 0


# (causal, reference block, bitwise-equal share at least): measured with
# seed 14.  Before the plain version rounded p to bf16 the shares were
# 0.657 / 0.630 (block 32) and 0.649 / 0.620 (block 128); after, 0.855 /
# 0.733 and 0.9997 / 0.9998.  With one block of 128 the reference rounds
# p against the final max as the plain version does with key_tile=0; with
# four blocks of 32 it rounds against the running max of each block.
# Rounding per key tile of the reference's block (key_tile=block), the
# plain version matches it at >= 0.9994 of the elements in all four
# cases.
@pytest.mark.parametrize("causal,block,share", [
    (True, 32, 0.85), (False, 32, 0.73), (True, 128, 0.999),
    (False, 128, 0.999)])
def test_flash_plain_rounds_p_where_jax_does(causal, block, share):
    """bf16: the plain forward rounds p to bf16 before the p·v product,
    the reference's rounding point (``p.astype(v.dtype)``); held to the
    reference in interpret mode within one bf16 step of each element
    (2^-7·|ref| + 4·2^-8·rms(ref): one rounding of the output, plus the
    summation order of float32 sums), rounding against the final max
    (``key_tile=0``) and against the running max of the reference's own
    key blocks."""
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 2, 128, 2, 64)
    ref = np.asarray(j_flash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal,
        block).astype(jnp.float32))
    limit = 2 ** -7 * np.abs(ref) + 4 * 2 ** -8 * np.sqrt((ref ** 2).mean())
    for key_tile, at_least in ((0, share), (block, 0.999)):
        got = t_flash.flash_attention_plain(
            *(_t(a).to(torch.bfloat16) for a in (q, k, v)), causal,
            key_tile=key_tile)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert (np.abs(got - ref) <= limit).all()
        assert (got == ref).mean() >= at_least


# ------------------------------------------------------------- backwards
# Tolerances: float32 on both sides; the sums run in other orders (and the
# reference's dscale/dbias add per-block partials), so agreement is to a
# few float32 roundings of the largest terms: 1e-5 absolute at these O(1)
# inputs, 1e-4 for gradients that pass through a softmax's sums.
@pytest.mark.parametrize("E", [128, 768])
def test_ln_bwd_plain_matches_jax(E):
    """N = 24 rows: the reference takes three blocks of 8 rows and sums
    their partial rows outside its kernel."""
    rng = np.random.default_rng(7)
    N = 24
    x = rng.standard_normal((N, E)).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal((N, E)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(E)).astype(np.float32)
    _, mu, rstd = j_ln._ln_fwd(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 1e-5, None)
    ref = j_ln._ln_bwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(g),
                       mu, rstd, None)
    got = t_ln.ln_bwd_plain(_t(x), _t(scale), _t(g),
                            _t(np.asarray(mu)[0]), _t(np.asarray(rstd)[0]))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


def _flat(a):
    """(B, T, H, D) → the reference's kernel layout (B·H, T, D)."""
    B, T, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, T, D)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax(causal):
    """The same lse and delta go into both backwards; block 16 gives the
    reference four key blocks and its dq carried across them."""
    rng = np.random.default_rng(8)
    B, T, H, D = 2, 64, 2, 16
    q, k, v = _qkv(rng, B, T, H, D)
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    _, lse = j_flash._flash_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_size=16, interpret=None)
    delta = rng.standard_normal((B * H, 1, T)).astype(np.float32)
    ref = j_flash._flash_backward_flat(
        *(jnp.asarray(_flat(a)) for a in (q, k, v)), lse,
        jnp.asarray(delta), jnp.asarray(_flat(do)), causal=causal,
        block_size=16, interpret=None)
    got = t_flash.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(np.asarray(lse)[:, 0]), _t(delta[:, 0]),
        _t(do), causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_flat(a.numpy()), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)


def test_flash_bwd_plain_within_one_step_of_exact():
    """bf16: the plain backward (float32 sums) is within one bf16 step of
    the same rounded pipeline computed in float64 — the premise of the
    card's two-step limit between kernel and plain version."""
    import math
    rng = np.random.default_rng(13)
    B, T, H, D = 1, 256, 4, 64
    bf = torch.bfloat16
    q, k, v, do = (_t(rng.standard_normal((B, T, H, D)).astype(
        np.float32)).to(bf) for _ in range(4))
    out, lse = t_flash.flash_attention_plain(q, k, v, True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(B * H, T)
    got = t_flash.flash_attention_bwd_plain(q, k, v, lse, delta, do, True)
    # the same pipeline in float64, rounded to bf16 at the same points
    scale = 1 / math.sqrt(D)
    qd, kd, vd, dod = (a.double() for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * (scale * t_flash.LOG2E)
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e300)
    p = torch.exp2(s - lse.double().reshape(B, H, T, 1))
    dsl = (p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd)
                - delta.double().reshape(B, H, T, 1))).to(bf).double()
    exact = (torch.einsum("bhqk,bkhd->bqhd", dsl,
                          (kd * scale).to(bf).double()),
             torch.einsum("bhqk,bqhd->bkhd", dsl, qd) * scale,
             torch.einsum("bhqk,bqhd->bkhd", p.to(bf).double(), dod))
    for a, r in zip(got, exact):
        r = r.to(bf).double()
        limit = 2 ** -7 * r.abs() + 4 * 2 ** -8 * r.pow(2).mean().sqrt()
        assert ((a.double() - r).abs() <= limit).all()


def _cotangent(T):
    """The non-uniform cotangent of tests/test_ops.py: weights 0.5..1.5
    along the sequence, so every dQ/dK/dV path is exercised."""
    return np.linspace(0.5, 1.5, T, dtype=np.float32)[None, :, None, None]


def _torch_grads(fn, arrays, w):
    ts = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad((out * _t(w)).sum(), ts)


def test_layer_norm_grads_match_jax():
    import jax
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32) * 2 + 0.5
    s = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    w = _cotangent(16)[..., 0]
    ref = jax.grad(lambda *a: (j_ln.layer_norm(*a) * w).sum(),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, s, b)))
    out, got = _torch_grads(t_ln.layer_norm, (x, s, b), w)
    assert isinstance(out.grad_fn, t_ln.LayerNormFn._backward_cls)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax(causal):
    import jax
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, 2, 64, 4, 16)
    w = _cotangent(64)
    ref = jax.grad(
        lambda *a: (j_flash.flash_attention(*a, causal, 16) * w).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    out, got = _torch_grads(
        lambda *a: t_flash.flash_attention(*a, causal), (q, k, v), w)
    assert "ray_tpu_torch_flash_fwd" in out.grad_fn.name()
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


def test_flash_grads_ragged_length_match_dense():
    """T = 37: no tile divides it; held to jax.grad of the reference's
    dense attention."""
    import jax
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 37, 2, 8)
    w = _cotangent(37)
    ref = jax.grad(
        lambda *a: (j_attn.dense_attention(*a, causal=True) * w).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    _, got = _torch_grads(t_flash.flash_attention_for_model, (q, k, v), w)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_fake_and_real_agree(causal):
    """The flash forward as the op ray_tpu_torch::flash_fwd, fed the
    strided q/k/v views the model makes: torch.library.opcheck (schema,
    autograd registration, the fake impl's shapes and strides against the
    real one's) passes; on the meta device the outputs are the kernel's
    contiguous (B, T, H, D) and (B·H, T) float32; the gradients through
    the op are those of the plain version under autograd."""
    rng = np.random.default_rng(26)
    qkv = _t(rng.standard_normal((2, 16, 3, 32)).astype(np.float32))
    q, k, v = [qkv[:, :, i].unflatten(-1, (4, 8)).requires_grad_()
               for i in range(3)]
    assert not q.is_contiguous()
    torch.library.opcheck(t_flash.flash_fwd_op, (q, k, v, causal))
    out, lse = t_flash.flash_fwd_op(*(t.to("meta") for t in (q, k, v)),
                                    causal)
    assert out.shape == (2, 16, 4, 8) and out.is_contiguous()
    assert lse.shape == (8, 16) and lse.dtype == torch.float32
    w = _t(rng.standard_normal((2, 16, 4, 8)).astype(np.float32))
    got = torch.autograd.grad((t_flash.flash_fwd_op(q, k, v, causal)[0]
                               * w).sum(), (q, k, v))
    ref = torch.autograd.grad((t_flash.flash_attention_plain(q, k, v, causal)
                               * w).sum(), (q, k, v))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_attn_qkv_op_matches_the_projection():
    """The qkv projection as the op ray_tpu_torch::attn_qkv: opcheck
    passes, and its value and registered backward equal autograd through
    the same product and bias add."""
    from ray_tpu_torch.models import gpt2 as t_gpt2
    rng = np.random.default_rng(27)
    h, w, b = (_t(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((2, 5, 16), (16, 3, 16), (3, 16)))
    torch.library.opcheck(t_gpt2.attn_qkv_op, (h, w, b))
    cot = _t(rng.standard_normal((2, 5, 3, 16)).astype(np.float32))
    got = t_gpt2.attn_qkv_op(h, w, b)
    ref = t_gpt2._qkv_projection(h, w, b)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    for a, r in zip(torch.autograd.grad((got * cot).sum(), (h, w, b)),
                    torch.autograd.grad((ref * cot).sum(), (h, w, b))):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_backward_cpu_tensors_take_plain_versions():
    """On a CPU tensor the Functions run the plain backwards: no kernel
    launch is counted, forward or backward."""
    rng = np.random.default_rng(12)
    x = _t(rng.standard_normal((3, 32)).astype(np.float32)).requires_grad_()
    q = _t(rng.standard_normal((1, 8, 2, 4)).astype(np.float32)) \
        .requires_grad_()
    def counts():
        return (t_ln.launches, t_ln.bwd_launches, t_ln.scalar_launches,
                t_ln.bwd_scalar_launches, t_flash.launches,
                t_flash.bwd_launches)

    before = counts()
    t_ln.layer_norm(x, torch.ones(32), torch.zeros(32)).sum().backward()
    t_flash.flash_attention(q, q, q).sum().backward()
    assert x.grad is not None and q.grad is not None
    assert counts() == before


def test_inference_keeps_the_stats_free_forward():
    """Without grad the ops return plain tensors (no Function node), so
    serving writes no mu/rstd or lse."""
    x = torch.randn(2, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert t_flash.flash_attention(x, x, x).grad_fn is None
        assert t_ln.layer_norm(x, torch.ones(16),
                               torch.zeros(16)).grad_fn is None
    out, lse = t_flash.flash_attention(x, x, x, want_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad


# -------------------------------------------------------- paged attention
def _paged_inputs():
    rng = np.random.default_rng(0)
    B, H, KV, D, bs, N = 2, 4, 2, 8, 4, 16
    return dict(
        q=rng.standard_normal((B, H, D), np.float32),
        k_pool=rng.standard_normal((N, bs, KV, D), np.float32),
        v_pool=rng.standard_normal((N, bs, KV, D), np.float32),
        block_tables=np.array([[3, 7, 1], [5, 2, 0]], np.int32),
        ctx_lens=np.array([10, 5], np.int32),
        k_new=rng.standard_normal((B, KV, D), np.float32),
        v_new=rng.standard_normal((B, KV, D), np.float32))


def test_paged_attention_matches_jax():
    inp = _paged_inputs()
    ref = np.asarray(j_paged.paged_attention_decode(
        **{k: jnp.asarray(v) for k, v in inp.items()}))
    got = t_paged.paged_attention_decode(
        **{k: _t(v).long() if v.dtype == np.int32 else _t(v)
           for k, v in inp.items()}).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_gather_kv_matches_jax():
    inp = _paged_inputs()
    ref = np.asarray(j_paged.gather_kv(jnp.asarray(inp["k_pool"]),
                                       jnp.asarray(inp["block_tables"])))
    got = t_paged.gather_kv(_t(inp["k_pool"]),
                            _t(inp["block_tables"]).long()).numpy()
    np.testing.assert_array_equal(got, ref)


def test_neg_inf_is_float32_min_not_inf():
    assert t_attn.NEG_INF == float(j_attn.NEG_INF)
    assert np.isfinite(t_attn.NEG_INF)


# --------------------------------------------------------- package rules
def _port_sources():
    # _build/ holds build outputs, never sources of the package
    return sorted(p for p in (REPO / "ray_tpu_torch").rglob("*.py")
                  if "_build" not in p.relative_to(REPO).parts) + \
        [REPO / "chip_smoke.py", REPO / "c1_kgroups.py"]


def test_port_imports_no_jax_and_no_ray_tpu():
    banned = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in banned]
    assert len(_port_sources()) > 10
    assert REPO / "ray_tpu_torch" / "models" / "llama.py" in _port_sources()
    assert REPO / "ray_tpu_torch" / "serve" / "llm" / "weights.py" in \
        _port_sources()
    assert REPO / "ray_tpu_torch" / "ops" / "moe.py" in _port_sources()
    assert REPO / "ray_tpu_torch" / "models" / "moe_transformer.py" in \
        _port_sources()
    for family in ("resnet", "bert", "vit", "t5"):
        assert REPO / "ray_tpu_torch" / "models" / f"{family}.py" in \
            _port_sources()
    rllib = REPO / "ray_tpu_torch" / "rllib"
    for mod in ("__init__", "sample_batch", "env", "models", "policy",
                "evaluation", "multi_agent", "algorithms/__init__",
                "algorithms/algorithm", "algorithms/ppo",
                "algorithms/impala", "algorithms/appo", "algorithms/dqn",
                "offline", "algorithms/sac", "algorithms/ddpg",
                "algorithms/marwil", "algorithms/a3c", "algorithms/apex"):
        assert rllib / f"{mod}.py" in _port_sources(), mod
    assert not bad, bad


def test_port_imports_gymnasium_only_where_the_reference_does():
    """The card's machine has no gymnasium: the port imports it only inside
    the functions of ``rllib/env.py`` that import it in the reference
    (the spaces, with a fallback, and an id that is not registered)."""
    where = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        parent = {c: n for n in ast.walk(tree)
                  for c in ast.iter_child_nodes(n)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if not any(n.split(".")[0] == "gymnasium" for n in names):
                continue
            fn = node
            while fn in parent and not isinstance(fn, ast.FunctionDef):
                fn = parent[fn]
            where.append((path.relative_to(REPO).as_posix(),
                          getattr(fn, "name", None)))
    assert set(where) == {("ray_tpu_torch/rllib/env.py", "make_box"),
                          ("ray_tpu_torch/rllib/env.py", "make_discrete"),
                          ("ray_tpu_torch/rllib/env.py", "create_env")}, \
        where


def test_kernel_modules_import_without_nvcc():
    """Importing (and running on the CPU) needs no nvcc: nothing is
    built or loaded until a CUDA tensor reaches a kernel."""
    code = (
        "import torch\n"
        "from ray_tpu_torch import _build\n"
        "from ray_tpu_torch.ops import flash_attention, layer_norm\n"
        "from ray_tpu_torch.models import llama\n"
        "from ray_tpu_torch.serve import llm\n"
        "x = torch.randn(2, 8, 4, 16, requires_grad=True)\n"
        "flash_attention.flash_attention(x, x, x).sum().backward()\n"
        "layer_norm.layer_norm(x, torch.ones(16), torch.zeros(16))"
        ".sum().backward()\n"
        "from ray_tpu_torch.parallel import spmd\n"
        "assert _build._lib is None\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except _build.KernelError:\n"
        "    print('no-nvcc')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = "/nonexistent"
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
