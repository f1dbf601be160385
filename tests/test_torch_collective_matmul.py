"""The port's decomposed collective matmuls and ``ring_scan``
(``ray_tpu_torch/ops/collective_matmul.py``) against the JAX package's
(mirrors of ``tests/test_collective_matmul.py``).

The JAX side runs the primitives inside ``shard_map`` on the rig's
virtual devices; the port's side on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``), a ``tensor`` ring of n with the other
ranks on ``data``.  Every rank's output and gradients (of
sum(sin(y))) must equal its shard of the JAX run: outputs within 1e-5,
gradients within 1e-4 (float32; the products are summed in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import rtt_mesh_pool as pool_lib
from ray_tpu._private.jax_compat import shard_map
from ray_tpu.ops import collective_matmul as jcm

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


def _jax_case(kind: str, n: int, x, w, fn):
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("tensor",))
    if kind == "ag":
        specs = (P(None, "tensor", None), P(None, "tensor"))
        out = P(None, None, "tensor")
    else:
        specs = (P(None, None, "tensor"), P("tensor", None))
        out = P(None, "tensor", None)
    f = shard_map(lambda a, b: fn(a, b, "tensor", n), mesh=mesh,
                  in_specs=specs, out_specs=out, check_vma=False)
    y = jax.jit(f)(x, w)
    dx, dw = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.sin(f(a, b))),
                              argnums=(0, 1)))(x, w)
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _shape(kind: str, n: int):
    return ((2, 8 * n, 16), (16, 24)) if kind == "ag" \
        else ((2, 8 * n, 16 * n), (16 * n, 24))


@pytest.mark.parametrize("kind", ["ag", "rs"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_primitive_matches_jax_shards(pool, kind, n):
    """all_gather_matmul (ag) / matmul_reduce_scatter (rs), the ring and
    the ``_reference`` pair: each rank's output and dx, dw are its shards
    of the JAX primitive's."""
    xs, ws = _shape(kind, n)
    rng = np.random.default_rng(10 * n + (kind == "rs"))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0])).astype(np.float32)
    jfn = jcm.all_gather_matmul if kind == "ag" else jcm.matmul_reduce_scatter
    y, dx, dw = _jax_case(kind, n, x, w, jfn)
    res = pool.run(pool_lib.rank_collective_matmul, kind, n, x, w)
    for r in res:
        i = r["tensor"]
        if kind == "ag":
            want = (np.split(y, n, -1)[i], np.split(dx, n, -2)[i],
                    np.split(dw, n, -1)[i])
        else:
            want = (np.split(y, n, -2)[i], np.split(dx, n, -1)[i],
                    np.split(dw, n, -2)[i])
        for name in ("ring", "reference"):
            got = r[name]
            np.testing.assert_allclose(got["y"], want[0], atol=OUT_TOL)
            np.testing.assert_allclose(got["dx"], want[1], atol=GRAD_TOL)
            np.testing.assert_allclose(got["dw"], want[2], atol=GRAD_TOL)


@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_primitives_against_dense_math(pool, kind):
    """The ranks' results assembled equal the unsharded x @ w (a shared
    layout fault would fool a pairwise comparison)."""
    n = 4
    xs, ws = _shape(kind, n)
    rng = np.random.default_rng(20 + (kind == "rs"))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0])).astype(np.float32)
    res = sorted(pool.run(pool_lib.rank_collective_matmul, kind, n, x, w),
                 key=lambda r: r["tensor"])
    axis = -1 if kind == "ag" else -2
    got = np.concatenate([r["ring"]["y"] for r in res], axis=axis)
    np.testing.assert_allclose(got, x @ w, atol=OUT_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_scan_rotation_order(pool, n):
    """ring_scan presents block (me - s) % n at step s, as the JAX
    package's does (the contract ring attention and both matmul rings
    are built on)."""
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("tensor",))

    def collect(x):
        me = jax.lax.axis_index("tensor")

        def body(step, seen, blk):
            return seen.at[step].set(blk[0] - (me - step) % n)

        return jcm.ring_scan(body, jnp.zeros((n,), jnp.int32), x,
                             axis_name="tensor", axis_size=n)[None]

    ref = shard_map(collect, mesh=mesh, in_specs=(P("tensor"),),
                    out_specs=P("tensor", None),
                    check_vma=False)(jnp.arange(n, dtype=jnp.int32))
    assert np.all(np.asarray(ref) == 0)
    for seen in pool.run(pool_lib.rank_ring_scan_order, n):
        assert seen == [0] * n


def test_ring_scan_overlaps_its_rotation_forward_and_backward(pool):
    """Under autograd, each rotation is issued before the step's body and
    waited for after it, and the backward issues each inverse rotation
    before the body's backward of the step below it and waits for it
    after: n = 2, one rotation each way."""
    for log in pool.run(pool_lib.rank_ring_scan_overlap, 2):
        fwd, bwd = log[:log.index("backward")], \
            log[log.index("backward") + 1:]
        assert fwd == ["start", "fwd0", "wait", "fwd1"], log
        assert bwd == ["bwd1", "start", "bwd0", "wait"], log
