"""The port's ring and Ulysses attention (``ray_tpu_torch/ops/
{ring_attention, ulysses}.py``) against the JAX package's, and Llama's
``ring`` / ``ulysses`` impls trained over a ``context=2`` mesh against
the JAX program on the same mesh.

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``), a ``context`` axis of n (the other ranks
on ``data``).  Each rank's output must equal its sequence chunk of the
JAX ``shard_map`` run within 1e-5, and its q/k/v gradients (of
sum(sin(out))) their chunks within 1e-4 (float32); Llama's losses within
1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import mesh_reference as ref
import rtt_mesh_pool as pool_lib
from ray_tpu._private.jax_compat import shard_map
from ray_tpu.ops.ring_attention import ring_attention as jring
from ray_tpu.ops.ulysses import ulysses_attention as julysses

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


def _jax_attention(impl: str, n: int, q, k, v):
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("context",))
    inner = partial(jring, axis_name="context", axis_size=n) \
        if impl == "ring" else partial(julysses, axis_name="context")
    spec = P(None, "context", None, None)
    f = shard_map(inner, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                  check_vma=False)
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_context_attention_matches_jax_shards(pool, impl, n):
    B, T, H, D = 2, 8 * n, 4, 8
    rng = np.random.default_rng(n + 10 * (impl == "ring"))
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    out, grads = _jax_attention(impl, n, q, k, v)
    for r in pool.run(pool_lib.rank_context_attention, impl, n, q, k, v):
        c = r["context"]
        np.testing.assert_allclose(r["out"], np.split(out, n, 1)[c],
                                   atol=OUT_TOL)
        for got, want in zip(r["grads"], grads):
            np.testing.assert_allclose(got, np.split(want, n, 1)[c],
                                       atol=GRAD_TOL)


def test_context_attention_without_a_mesh_is_dense():
    """The model hooks with no ambient mesh: causal dense attention, as
    the reference's."""
    from ray_tpu_torch.ops.attention import dense_attention
    from ray_tpu_torch.ops.ring_attention import ring_attention_for_model
    from ray_tpu_torch.ops.ulysses import ulysses_attention_for_model
    q, k, v = torch.randn(3, 2, 16, 4, 8).unbind(0)
    want = dense_attention(q, k, v, causal=True)
    for hook in (ring_attention_for_model, ulysses_attention_for_model):
        torch.testing.assert_close(hook(q, k, v), want)


def test_ulysses_needs_heads_divisible(pool):
    """Heads that do not split over the axis raise, as the reference's."""
    q = np.zeros((1, 8, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="divisible"):
        pool.run(pool_lib.rank_context_attention, "ulysses", 2, q, q, q)


@pytest.fixture(scope="module")
def pool_after_failure():
    """A fresh pool: a failed run tears its pool down."""
    p = pool_lib.RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_context_parallel_losses_match_jax(pool_after_failure, impl):
    """Llama tiny (GQA: 4 heads over 2 KV heads), 3 steps over
    ``context=2`` with LLAMA_RULES: the losses and grad norms on both
    ranks equal the JAX program's on the same mesh."""
    kw = {"attn_impl": impl, "context_axis": "context"}
    toks = ref.tokens(3, batch=2)
    want = ref.jax_train_run({"context": 2}, kw, toks, family="llama")
    for r in pool_after_failure.run(
            pool_lib.rank_gpt2_train, {"context": 2},
            dict(kw, tiny={"vocab": 128, "seq": 32}), want["params"], toks,
            3, ref.OPT, "llama"):
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-4)
