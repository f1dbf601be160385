"""The port's collective layer (``ray_tpu_torch.util.collective``, the shm
backend), held to the reference's ``TestShmBackend``
(``tests/test_collective.py``) with numpy arrays and with torch tensors,
plus the reduction against the JAX package's on the same arrays.

The groups live for the module: one of 2, 3 and 4 rank actors each, all
calling every collective in the same order, so a test never waits for a
worker to start.  Every collective has the group's own timeout and every
``get`` one of its own; nothing sleeps.  Rank actors are pickled by value
and import torch only for the torch cases.
"""

import logging
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective.collective_group import shm_group
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

from ray_tpu.util.collective.collective_group import shm_group as j_shm_group
from ray_tpu.util.collective.types import ReduceOp as JReduceOp

cloudpickle.register_pickle_by_value(sys.modules[__name__])
GET_TIMEOUT = 90
KINDS = ["numpy", "torch"]


def _arr(x, kind):
    if kind == "numpy":
        return np.asarray(x, np.float32)
    import torch as t
    return t.tensor(np.asarray(x, np.float32))


class Rank:
    def __init__(self, rank, world, group):
        col.init_collective_group(world, rank, "shm", group)
        self.rank = rank
        self.group = group

    def allreduce(self, x, kind):
        return col.allreduce(_arr(x, kind), self.group)

    def allreduce_bf16(self, x):
        import torch as t
        return col.allreduce(t.tensor(x, dtype=t.bfloat16), self.group)

    def allreduce_op(self, x, op, kind):
        ops = {"max": ReduceOp.MAX, "min": ReduceOp.MIN,
               "sum": ReduceOp.SUM}
        return col.allreduce(_arr(x, kind), self.group, op=ops[op])

    def allgather(self, x, kind):
        return col.allgather(_arr(x, kind), self.group)

    def broadcast(self, x, kind):
        return col.broadcast(_arr(x, kind), 0, self.group)

    def reducescatter(self, xs, kind):
        return col.reducescatter([_arr(x, kind) for x in xs], self.group)

    def alltoall(self, xs, kind):
        return col.alltoall([_arr(x, kind) for x in xs], self.group)

    def reduce_to0(self, x, kind):
        return col.reduce(_arr(x, kind), 0, self.group)

    def sendrecv(self, peer, x, kind):
        if self.rank == 0:
            col.send(_arr(x, kind), peer, self.group)
            return None
        return col.recv(peer, self.group)

    def rank_info(self):
        return (col.get_rank(self.group),
                col.get_collective_group_size(self.group))


@pytest.fixture(scope="module")
def groups():
    """world size -> its rank actors, made on first use."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=5)
    made = {}

    def get(n):
        if n not in made:
            actor = rt.remote(Rank)
            made[n] = [actor.options(num_cpus=0.5).remote(r, n, f"w{n}")
                       for r in range(n)]
            rt.get([a.__ray_ready__.remote() for a in made[n]],
                   timeout=GET_TIMEOUT)
        return made[n]

    yield get
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def _np(out):
    if isinstance(out, torch.Tensor):
        return out.float().numpy()
    return np.asarray(out)


def _check_kind(out, kind, dtype=torch.float32):
    if kind == "torch":
        assert isinstance(out, torch.Tensor) and out.dtype == dtype
    else:
        assert isinstance(out, np.ndarray)


def _get(refs):
    return rt.get(refs, timeout=GET_TIMEOUT)


# ---------------------------------------------- TestShmBackend's cases
@pytest.mark.parametrize("kind", KINDS)
def test_allreduce(groups, kind):
    actors = groups(4)
    outs = _get([a.allreduce.remote([float(i)] * 3, kind)
                 for i, a in enumerate(actors)])
    for o in outs:
        _check_kind(o, kind)
        np.testing.assert_allclose(_np(o), [6.0, 6.0, 6.0])


def test_allreduce_bf16_tensor(groups):
    """bf16 leaves as float32 (numpy has none), sums there and comes back
    bf16."""
    actors = groups(2)
    outs = _get([a.allreduce_bf16.remote([1.5, 2.0 + i])
                 for i, a in enumerate(actors)])
    for o in outs:
        _check_kind(o, "torch", torch.bfloat16)
        assert o.tolist() == [3.0, 5.0]


@pytest.mark.parametrize("kind", KINDS)
def test_allreduce_large_tensor(groups, kind):
    # > INLINE_LIMIT → object-store path
    actors = groups(2)
    big = np.ones(100_000, np.float32)
    outs = _get([a.allreduce.remote(big, kind) for a in actors])
    for o in outs:
        _check_kind(o, kind)
        np.testing.assert_allclose(_np(o), 2 * big)


@pytest.mark.parametrize("kind", KINDS)
def test_allreduce_ring_path(groups, kind):
    """≥ RING_THRESHOLD with world > 2 → the chunked ring algorithm;
    exact for SUM of integers-as-floats."""
    actors = groups(3)
    n = shm_group.ShmCollectiveGroup.RING_THRESHOLD // 4 + 7
    big = np.arange(n, dtype=np.float32) % 97
    outs = _get([a.allreduce.remote(big, kind) for a in actors])
    for o in outs:
        _check_kind(o, kind)
        np.testing.assert_array_equal(_np(o), 3 * big)


@pytest.mark.parametrize("kind", KINDS)
def test_allreduce_ring_max_op(groups, kind):
    actors = groups(3)
    n = shm_group.ShmCollectiveGroup.RING_THRESHOLD // 4
    outs = _get([a.allreduce_op.remote(np.full(n, float(i), np.float32),
                                       "max", kind)
                 for i, a in enumerate(actors)])
    for o in outs:
        np.testing.assert_array_equal(_np(o), np.full(n, 2.0))


@pytest.mark.parametrize("kind", KINDS)
def test_allgather_ordering(groups, kind):
    actors = groups(3)
    outs = _get([a.allgather.remote([float(i)], kind)
                 for i, a in enumerate(actors)])
    for o in outs:
        for x in o:
            _check_kind(x, kind)
        assert [float(_np(x)[0]) for x in o] == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("kind", KINDS)
def test_broadcast(groups, kind):
    actors = groups(3)
    outs = _get([a.broadcast.remote([float(i + 1)], kind)
                 for i, a in enumerate(actors)])
    for o in outs:
        _check_kind(o, kind)
        np.testing.assert_allclose(_np(o), [1.0])  # rank 0's value


@pytest.mark.parametrize("kind", KINDS)
def test_reducescatter(groups, kind):
    actors = groups(2)
    outs = _get([a.reducescatter.remote([[float(r + 1)], [float(r + 1)]],
                                        kind)
                 for r, a in enumerate(actors)])
    # chunk j = sum over ranks of (rank+1) = 3
    for o in outs:
        _check_kind(o, kind)
        np.testing.assert_allclose(_np(o), [3.0])


@pytest.mark.parametrize("kind", KINDS)
def test_alltoall(groups, kind):
    actors = groups(2)
    outs = _get([a.alltoall.remote([[float(10 * r)], [float(10 * r + 1)]],
                                   kind)
                 for r, a in enumerate(actors)])
    # rank i receives [rank0's chunk i, rank1's chunk i]
    np.testing.assert_allclose([float(_np(x)[0]) for x in outs[0]],
                               [0., 10.])
    np.testing.assert_allclose([float(_np(x)[0]) for x in outs[1]],
                               [1., 11.])


@pytest.mark.parametrize("kind", KINDS)
def test_reduce_dst_only(groups, kind):
    actors = groups(2)
    outs = _get([a.reduce_to0.remote([1.0], kind) for a in actors])
    _check_kind(outs[0], kind)
    np.testing.assert_allclose(_np(outs[0]), [2.0])
    np.testing.assert_allclose(_np(outs[1]), [1.0])   # its own input


@pytest.mark.parametrize("kind", KINDS)
def test_sendrecv(groups, kind):
    actors = groups(2)
    r0 = actors[0].sendrecv.remote(1, [7.0, 8.0], kind)
    r1 = actors[1].sendrecv.remote(0, None, kind)
    assert _get(r0) is None
    out = _get(r1)
    np.testing.assert_allclose(_np(out), [7.0, 8.0])


def test_rank_introspection(groups):
    actors = groups(2)
    assert _get([a.rank_info.remote() for a in actors]) == [(0, 2), (1, 2)]


def test_uninitialized_rank_is_minus1():
    assert col.get_rank("nope") == -1
    assert col.get_collective_group_size("nope") == -1


@pytest.mark.parametrize("kind", KINDS)
def test_sequence_of_ops(groups, kind):
    # multiple collectives in order exercises seq cleanup
    actors = groups(2)
    for k in range(5):
        outs = _get([a.allreduce.remote([float(k)], kind) for a in actors])
        for o in outs:
            np.testing.assert_allclose(_np(o), [2.0 * k])


# ------------------------------------------------------- the port's own
@pytest.mark.parametrize("op", ["SUM", "PRODUCT", "MIN", "MAX"])
def test_reduce_matches_jax_package(op):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((5, 7)).astype(np.float32)
              for _ in range(3)]
    got = shm_group._reduce_arrays(arrays, ReduceOp[op])
    ref = j_shm_group._reduce_arrays(arrays, JReduceOp[op])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_tensor_round_trip_keeps_dtype_and_device(dtype):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(dtype)
    arr = shm_group._to_numpy(t)
    assert isinstance(arr, np.ndarray)
    back = shm_group._like(arr, t)
    assert back.dtype == dtype and back.device == t.device
    assert torch.equal(back, t)
    assert shm_group._like(arr, np.zeros(1)) is arr


def test_recv_reads_before_it_releases_the_key():
    """The sender keeps a p2p object pinned only while its key exists:
    recv must read the object, within the op's timeout, before it deletes
    the key (the other order let a ring allreduce wait forever on a
    chunk the sender had freed)."""
    g = shm_group.ShmCollectiveGroup(2, 1, "unit")
    events = []
    g._kv_get = lambda key: b"R" + b"0" * 27
    g._kv_del = lambda key: events.append(("del", key))

    def fetch(blob, timeout):
        events.append(("fetch", timeout))
        return np.ones(3, np.float32)

    g._fetch = fetch
    out = g.recv(0, timeout=5.0)
    np.testing.assert_array_equal(out, np.ones(3))
    assert [e[0] for e in events] == ["fetch", "del"]
    assert 0 < events[0][1] <= 5.0
    assert events[1][1] == "unit/p2p/0-1/1"


def test_backends():
    assert Backend.coerce("gloo") == Backend.SHM
    assert Backend.coerce("shm") == Backend.SHM
    assert Backend.coerce("xla") == Backend.DEVICE
    # the device group needs a torch.distributed domain to stand on
    with pytest.raises(RuntimeError, match="torch.distributed domain"):
        col.init_collective_group(1, 0, "nccl", "never")
    assert not col.is_group_initialized("never")
