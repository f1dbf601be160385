"""The port's ``util`` extras, channels and workflows held to the JAX
package's: the committed outputs of ``tests/util_extras_reference.py``
(``tests/data/util_extras_reference.json``, made in a cluster of the JAX
package's runtime), the same code run through the port's runtime, and
both packages' pure parts side by side on the same inputs.

Tolerance: exact.  Everything compared is an integer, a byte string or
an order: ``ray_dask_get``'s values, ``ParallelIterator``'s shard
assignment and sequences, ``Pool``'s results, order and chunking
(``imap`` at ``chunksize=5`` included), ``ActorPool``'s deterministic
orders, a workflow's result, files, ``status.json`` and checkpoints,
``_topo_order`` / ``_step_keys``, and a ``Channel``'s header and
length-prefix bytes for the same payload.
"""

import json
import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
import util_extras_reference as ref
from ray_tpu_torch import workflow as t_wf
from ray_tpu_torch._private import rtlog, shm_store
from ray_tpu_torch.experimental import channels as t_chan
from ray_tpu_torch.util import dask as t_dask

from ray_tpu import workflow as j_wf
from ray_tpu.experimental import channels as j_chan
from ray_tpu.util import dask as j_dask

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def committed():
    return json.loads(ref.PATH.read_text())


@pytest.fixture(scope="module")
def cluster():
    """The port's cluster for the module; the package logger is handed
    back as it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=0)
    yield
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def test_reference_file_is_what_the_generator_writes(committed):
    assert committed["seed"] == ref.SEED
    assert ref.PATH.stat().st_size < 20_000
    assert ref.outputs() == committed


def test_port_matches_the_reference_file(cluster, committed):
    got = json.loads(json.dumps(ref.run_all(rt)))
    assert list(got) == list(committed["run"])
    for key, want in committed["run"].items():
        assert got[key] == want, key


def test_dask_dependencies_match_jax():
    g = ref.dask_graph(ref.draws()["lits"])
    for key, comp in g.items():
        assert t_dask._deps_of(comp, g) == j_dask._deps_of(comp, g), key
        assert t_dask._is_task(comp) == j_dask._is_task(comp), key


def test_workflow_topo_order_and_step_keys_match_jax():
    steps = ref.draws()["steps"]
    t_node, j_node = ref.workflow_dag(t_wf, steps), \
        ref.workflow_dag(j_wf, steps)
    t_order, j_order = t_wf._topo_order(t_node), j_wf._topo_order(j_node)
    assert [n.name for n in t_order] == [n.name for n in j_order] == \
        ["scale", "offset", "again", "combine"]
    t_keys, j_keys = t_wf._step_keys(t_order), j_wf._step_keys(j_order)
    assert [t_keys[id(n)] for n in t_order] == \
        [j_keys[id(n)] for n in j_order] == \
        ["scale_0", "offset_0", "again_0", "combine_0"]
    assert t_wf._DEFAULT_STORAGE == "/tmp/rtt_workflows"


def test_channel_bytes_match_jax(monkeypatch, tmp_path):
    """The same payloads through both packages' rings: the ``<QQ``
    header and each ``<I`` length prefix and payload byte for byte,
    across a wrap of the ring."""
    monkeypatch.setattr(shm_store, "_SHM_DIR", tmp_path)
    rng = np.random.default_rng(ref.SEED)
    payloads = [{"ids": rng.integers(0, 50257, 32).tolist(), "n": i,
                 "blob": rng.bytes(700)} for i in range(6)] + \
        [rng.standard_normal((4, 8)).astype(np.float32)]
    tc = t_chan.Channel(capacity_bytes=4096)
    jc = j_chan.Channel(capacity_bytes=4096)
    try:
        assert tc.capacity == jc.capacity == 4096
        hdr = t_chan._HDR.size
        for p in payloads:
            tc.put(p)
            jc.put(p)
            assert bytes(tc._mm) == bytes(jc._mm)
            assert tc._cursors() == jc._cursors()
            head, tail = tc._cursors()
            (n,) = t_chan._LEN.unpack(tc._read_bytes(tail, 4))
            assert head - tail == 4 + n
            got_t, got_j = tc.get(), jc.get()
            if isinstance(p, np.ndarray):
                np.testing.assert_array_equal(got_t, got_j)
            else:
                assert got_t == got_j == p
            assert tc._cursors() == jc._cursors() == (head, head)
            assert bytes(tc._mm[:hdr]) == bytes(jc._mm[:hdr]) == \
                t_chan._HDR.pack(head, head)
        assert tc._cursors()[0] > tc.capacity            # wrapped
    finally:
        tc.destroy()
        jc.destroy()

