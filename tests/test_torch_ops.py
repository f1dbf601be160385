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


# (causal, reference block, bitwise-equal share at least): measured with
# seed 14.  Before the plain version rounded p to bf16 the shares were
# 0.657 / 0.630 (block 32) and 0.649 / 0.620 (block 128); after, 0.855 /
# 0.733 and 0.9997 / 0.9998.  With one block of 128 the reference rounds
# p against the final max as the plain version does; with four blocks of
# 32 it rounds against the running max of each block.
@pytest.mark.parametrize("causal,block,share", [
    (True, 32, 0.85), (False, 32, 0.73), (True, 128, 0.999),
    (False, 128, 0.999)])
def test_flash_plain_rounds_p_where_jax_does(causal, block, share):
    """bf16: the plain forward rounds p to bf16 before the p·v product,
    the reference's rounding point (``p.astype(v.dtype)``); held to the
    reference in interpret mode within one bf16 step of each element
    (2^-7·|ref| + 4·2^-8·rms(ref): one rounding of the output, plus the
    summation order of float32 sums)."""
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 2, 128, 2, 64)
    ref = np.asarray(j_flash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal,
        block).astype(jnp.float32))
    got = t_flash.flash_attention_plain(
        *(_t(a).to(torch.bfloat16) for a in (q, k, v)), causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    limit = 2 ** -7 * np.abs(ref) + 4 * 2 ** -8 * np.sqrt((ref ** 2).mean())
    assert (np.abs(got - ref) <= limit).all()
    assert (got == ref).mean() >= share


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
    assert isinstance(out.grad_fn, t_flash.FlashAttentionFn._backward_cls)
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


def test_backward_cpu_tensors_take_plain_versions():
    """On a CPU tensor the Functions run the plain backwards: no kernel
    launch is counted, forward or backward."""
    rng = np.random.default_rng(12)
    x = _t(rng.standard_normal((3, 32)).astype(np.float32)).requires_grad_()
    q = _t(rng.standard_normal((1, 8, 2, 4)).astype(np.float32)) \
        .requires_grad_()
    before = (t_ln.launches, t_ln.bwd_launches, t_flash.launches,
              t_flash.bwd_launches)
    t_ln.layer_norm(x, torch.ones(32), torch.zeros(32)).sum().backward()
    t_flash.flash_attention(q, q, q).sum().backward()
    assert x.grad is not None and q.grad is not None
    assert (t_ln.launches, t_ln.bwd_launches, t_flash.launches,
            t_flash.bwd_launches) == before


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
        [REPO / "chip_smoke.py"]


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
    assert not bad, bad


def test_kernel_modules_import_without_nvcc():
    """Importing (and running on the CPU) needs no nvcc: nothing is
    built or loaded until a CUDA tensor reaches a kernel."""
    code = (
        "import torch\n"
        "from ray_tpu_torch import _build\n"
        "from ray_tpu_torch.ops import flash_attention, layer_norm\n"
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
