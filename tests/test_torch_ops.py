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
    return torch.from_numpy(np.asarray(a))


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
        "x = torch.randn(2, 8, 4, 16)\n"
        "flash_attention.flash_attention(x, x, x)\n"
        "layer_norm.layer_norm(x, torch.ones(16), torch.zeros(16))\n"
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
