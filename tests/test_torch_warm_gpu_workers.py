"""The runtime's warm GPU worker pool, on the CPU with a card declared
(``num_gpus=1``): a GPU worker is forked at ``init`` and imports torch
before it registers, the ``num_gpus=1`` actor lands in it with torch
already imported, no CPU task rides it, and when its actor dies another
is forked.  A GPU worker that dies before it registers (a node with no
usable torch) is forked again only after a growing back-off, and leaves
the worker table.

Functions and classes here are pickled by value, so spawned workers
never import this module (nor JAX through it).
"""

import logging
import os
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.util import state

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def _logger(monkeypatch):
    """Each test boots its own cluster; the package logger is handed back
    as it was (``init`` stops its propagation) and the config reset."""
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    yield
    if rt.is_initialized():
        rt.shutdown()
    GLOBAL_CONFIG.reset()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def _gpu_workers(states=("idle",)) -> list:
    return [w for w in state.list_workers()
            if w.get("gpu") and w.get("state") in states]


def _await(cond, timeout_s: float = 60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError("condition never held")
        time.sleep(0.05)


class Probe:
    def __init__(self):
        self.torch_at_init = "torch" in sys.modules

    def info(self):
        return {"pid": os.getpid(), "torch_at_init": self.torch_at_init,
                "gpu_worker": os.environ.get("RTT_GPU_WORKER")}


def test_prestarted_gpu_worker_hosts_the_gpu_actor_and_is_replaced():
    rt.init(num_cpus=2, num_gpus=1)
    (warm,) = _await(_gpu_workers)

    @rt.remote
    def where():
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    # more CPU tasks than plain workers: none may ride the warm GPU worker
    seen = rt.get([where.remote() for _ in range(40)], timeout=120)
    assert {v for _, v in seen} == {""}
    assert warm["pid"] not in {p for p, _ in seen}

    actor = rt.remote(num_gpus=1)(Probe).remote()
    info = rt.get(actor.info.remote(), timeout=120)
    assert info == {"pid": warm["pid"], "torch_at_init": True,
                    "gpu_worker": "1"}
    rt.kill(actor)
    (spare,) = _await(lambda: [w for w in _gpu_workers()
                               if w["pid"] != warm["pid"]])
    assert spare["pid"] != warm["pid"]
    again = rt.remote(num_gpus=1)(Probe).remote()
    assert rt.get(again.info.remote(), timeout=120)["pid"] == spare["pid"]


def test_gpu_worker_that_cannot_boot_is_forked_again_after_a_back_off(
        monkeypatch, tmp_path):
    """A card is declared but torch cannot be imported on the node, so
    every GPU worker dies before it registers.  The head forks the next
    one only after a back-off that doubles (1, 2, 4 s ...), not at every
    monitor tick; the dead ones leave the worker table; CPU tasks run
    meanwhile."""
    broken = tmp_path / "torch"
    broken.mkdir()
    (broken / "__init__.py").write_text(
        "raise ImportError('no usable torch on this node')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        filter(None, [str(tmp_path), os.environ.get("PYTHONPATH")])))
    rt.init(num_cpus=2, num_gpus=1)
    head = rt._head
    node = head.head_node_id

    @rt.remote
    def one():
        return 1

    assert rt.get([one.remote() for _ in range(8)], timeout=60) == [1] * 8
    _await(lambda: head._gpu_boot_failures.get(node, 0) >= 3)
    with head.lock:
        failures = head._gpu_boot_failures[node]
        wait_s = head._gpu_fork_after[node] - time.monotonic()
        forks = head._spawn_counter
        gpu_entries = [w for w in head.workers.values() if w.gpu_capable]
    # the third death in a row put the next fork 4 s off
    assert failures == 3 and wait_s > 2.0, (failures, wait_s)
    assert gpu_entries == []
    time.sleep(1.5)
    with head.lock:
        assert head._gpu_boot_failures[node] == 3
        assert head._spawn_counter == forks
    assert not [w for w in state.list_workers() if w.get("gpu")]
    assert rt.get(one.remote(), timeout=60) == 1
