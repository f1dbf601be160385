"""The port's shm channels and compiled actor chains
(``ray_tpu_torch.experimental.channels``) on its own runtime, held to the
reference's ``tests/test_experimental_channels.py`` (all 8, every
assertion kept, the chain's comparison with actor calls included), plus
the two faults the port fixes in the reference's design: C21 (a channel's
segment lives in the runtime's shm directory, ``RTT_SHM_DIR``, not at a
fixed ``/dev/shm`` path) and C22 (a stage that cannot decode its input
forwards the error instead of losing its pump).

Tests share one cluster at ``num_cpus=4`` (``cluster``); the fixture kills
the actors a test leaves.  Classes here are pickled by value, so spawned
workers never import this module (nor JAX through it).
"""

import logging
import os
import sys
import time
import types

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog, shm_store
from ray_tpu_torch._private import worker as t_worker
from ray_tpu_torch.experimental.channels import (
    Channel, compile_chain, enable_channels)

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's cluster and hands later modules the package
    logger as it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    if rt.is_initialized():
        rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def cluster(_shared, monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if not rt.is_initialized():
        rt.init(num_cpus=4, num_gpus=0)
    yield
    w = t_worker.global_worker()
    for a in w.rpc("list_actors")["actors"]:
        if a["state"] != "DEAD":
            rt.kill(rt.ActorHandle(a["actor_id"], {}))


def test_channel_same_process_roundtrip(cluster):
    ch = Channel(capacity_bytes=1 << 16)
    try:
        ch.put({"a": 1})
        ch.put(np.arange(100))
        assert ch.get() == {"a": 1}
        np.testing.assert_array_equal(ch.get(), np.arange(100))
        with pytest.raises(TimeoutError):
            ch.get(timeout=0.1)
    finally:
        ch.destroy()


def test_channel_wraparound_and_capacity(cluster):
    ch = Channel(capacity_bytes=4096)
    try:
        for i in range(50):  # forces multiple ring wraps
            ch.put(bytes([i % 256]) * 900)
            assert ch.get() == bytes([i % 256]) * 900
        with pytest.raises(ValueError):
            ch.put(b"x" * 8192)  # larger than the ring
    finally:
        ch.destroy()


def test_channel_cross_process(cluster):
    ch_in = Channel()
    ch_out = Channel()

    @rt.remote
    class Echo:
        def pump_once(self, cin, cout):
            cout.put(cin.get(timeout=30) * 2)
            return True

    e = Echo.remote()
    ref = e.pump_once.remote(ch_in, ch_out)
    ch_in.put(21)
    assert ch_out.get(timeout=30) == 42
    assert rt.get(ref, timeout=30)
    ch_in.destroy()
    ch_out.destroy()


def test_compiled_chain_executes_and_pipelines(cluster):
    @rt.remote
    @enable_channels
    class Stage:
        def __init__(self, add):
            self.add = add

        def f(self, x):
            return x + self.add

    a = Stage.remote(1)
    b = Stage.remote(10)
    c = Stage.remote(100)
    g = compile_chain([(a, "f"), (b, "f"), (c, "f")])
    try:
        assert g.execute(0) == 111
        assert g.execute(5) == 116
        # pipelined: N in-flight items flow without per-call submission
        for i in range(20):
            g.execute_async(i)
        outs = [g.result(timeout=60) for _ in range(20)]
        assert outs == [i + 111 for i in range(20)]
    finally:
        g.teardown()


def test_compiled_chain_error_propagates(cluster):
    @rt.remote
    @enable_channels
    class Boom:
        def f(self, x):
            raise ValueError("stage blew up")

    g = compile_chain([(Boom.remote(), "f")])
    try:
        with pytest.raises(ValueError, match="stage blew up"):
            g.execute(1)
    finally:
        g.teardown()


def test_compiled_chain_faster_than_actor_calls(cluster):
    """The point of compiled graphs: repeated execution beats the
    per-call path (here: two-stage chain vs chained actor calls)."""
    @rt.remote
    @enable_channels
    class S:
        def f(self, x):
            return x + 1

    a, b = S.remote(), S.remote()
    # warm the normal path
    rt.get(b.f.remote(rt.get(a.f.remote(0))), timeout=60)
    n = 50
    t0 = time.perf_counter()
    for i in range(n):
        rt.get(b.f.remote(rt.get(a.f.remote(i))), timeout=60)
    t_calls = time.perf_counter() - t0

    g = compile_chain([(a, "f"), (b, "f")])
    try:
        g.execute(0)  # warm
        t0 = time.perf_counter()
        for i in range(n):
            g.execute_async(i)
        outs = [g.result(timeout=60) for _ in range(n)]
        t_chain = time.perf_counter() - t0
        assert outs == [i + 2 for i in range(n)]
        assert t_chain < t_calls, (t_chain, t_calls)
    finally:
        g.teardown()


def test_teardown_with_backpressured_chain(cluster):
    """teardown must stop the pump threads even when the graceful _Stop
    cannot flow (rings full of unconsumed results)."""
    @rt.remote
    @enable_channels
    class S:
        def f(self, x):
            return bytes(100_000)  # chunky results fill the ring fast

    a = S.remote()
    g = compile_chain([(a, "f")], capacity_bytes=1 << 19)
    # fill the output ring without consuming
    for i in range(8):
        try:
            g.execute_async(i, timeout=2)
        except TimeoutError:
            break
    g.teardown()  # must not hang; pumps stop via the flag path
    # the actor is still healthy for normal calls afterwards
    assert rt.get(a.rtt_channel_pump_stop.remote(), timeout=30)


def test_two_chains_share_actor_independent_teardown(cluster):
    """Tearing down one chain must not kill another chain's pumps on the
    same actor (stop flags are chain-scoped)."""
    @rt.remote
    @enable_channels
    class S:
        def f(self, x):
            return x + 1

    shared = S.remote()
    g1 = compile_chain([(shared, "f")])
    g2 = compile_chain([(shared, "f")])
    try:
        assert g1.execute(1) == 2 and g2.execute(10) == 11
        g1.teardown()
        # g2 still fully alive after g1's teardown
        assert g2.execute(20) == 21
    finally:
        g2.teardown()


# ------------------------------------------------------- the port's faults

def test_channel_segment_lives_in_the_runtime_shm_dir(cluster, monkeypatch,
                                                      tmp_path):
    """C21: a channel's segment is made in the store's directory
    (``RTT_SHM_DIR``) under the port's ``rtt_`` prefix, where the run's
    other segments are watched and reaped; a stage in another process
    attaches to it there, and ``destroy`` removes it."""
    monkeypatch.setattr(shm_store, "_SHM_DIR", tmp_path)
    ch_in, ch_out = Channel(capacity_bytes=1 << 16), Channel(1 << 16)
    try:
        for ch in (ch_in, ch_out):
            assert ch.name.startswith("rtt_chan_")
            assert (tmp_path / ch.name).is_file()
            assert not os.path.lexists(f"/dev/shm/{ch.name}")

        @rt.remote
        class Echo:
            def pump_once(self, cin, cout):
                cout.put((cin.path, cin.get(timeout=30) * 2))
                return True

        ref = Echo.remote().pump_once.remote(ch_in, ch_out)
        ch_in.put(21)
        assert ch_out.get(timeout=30) == (str(tmp_path / ch_in.name), 42)
        assert rt.get(ref, timeout=30)
    finally:
        ch_in.destroy()
        ch_out.destroy()
    assert not any(p.name.startswith("rtt_chan_") for p in tmp_path.iterdir())


# a driver that makes a channel, reports its name and waits on stdin (EOF:
# it destroys the channel and shuts down)
_CHANNEL_SESSION = """
import json, sys, ray_tpu_torch as rt
from ray_tpu_torch.experimental.channels import Channel
rt.init(num_cpus=1, num_gpus=0)
ch = Channel(capacity_bytes=1 << 16)
print(json.dumps(ch.name), flush=True)
sys.stdin.read()
ch.destroy()
rt.shutdown()
"""

# a head booting in the same directory, then reporting what is left
_NEXT_HEAD = """
import json, os, ray_tpu_torch as rt
from ray_tpu_torch._private import shm_store
rt.init(num_cpus=1, num_gpus=0)
print(json.dumps(sorted(os.listdir(shm_store._SHM_DIR))), flush=True)
rt.shutdown()
"""


def test_killed_drivers_channel_is_reaped_by_the_next_head(tmp_path):
    """C21: a channel's name carries the pid of the process that made it,
    so the next head to boot in the directory unlinks the ring a SIGKILLed
    driver left (its session is dead) and leaves a live driver's alone."""
    import json
    import signal
    import subprocess
    from ray_tpu_torch._private.session import _pid_alive
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RTT_SHM_DIR=str(tmp_path), PYTHONPATH=os.pathsep
               .join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
    env.pop("RTT_NUM_GPUS", None)
    procs = []
    try:
        names = []
        for _ in range(2):
            p = subprocess.Popen(
                [sys.executable, "-c", _CHANNEL_SESSION], env=env, cwd=repo,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                start_new_session=True)
            procs.append(p)
            line = p.stdout.readline()
            assert line, f"driver failed to start (rc {p.poll()})"
            names.append(json.loads(line))
        dead, live = names
        assert dead.startswith(f"rtt_chan_{procs[0].pid:08x}_")
        assert {dead, live} <= set(os.listdir(tmp_path))
        os.killpg(procs[0].pid, signal.SIGKILL)
        procs[0].wait(30)
        (pids,) = [[int(n) for n in os.listdir(e)]
                   for e in (tmp_path / "rtt_sessions").iterdir()
                   if str(procs[0].pid) in os.listdir(e)]
        deadline = time.monotonic() + 30
        while any(map(_pid_alive, pids)) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(map(_pid_alive, pids))
        assert dead in os.listdir(tmp_path)   # nothing reaps at death
        out = subprocess.run([sys.executable, "-c", _NEXT_HEAD], env=env,
                             cwd=repo, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        left = set(json.loads(out.stdout.splitlines()[-1]))
        assert dead not in left
        assert live in left
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(30)
    assert procs[1].returncode == 0
    assert live not in os.listdir(tmp_path)


# a module only this process has: a stage's process cannot import it, so it
# cannot decode an object of its class (as a process without the card
# cannot decode a CUDA tensor)
_DRIVER_ONLY = types.ModuleType("_rtt_driver_only_module")
sys.modules[_DRIVER_ONLY.__name__] = _DRIVER_ONLY


class _Undecodable:
    def __init__(self, x):
        self.x = x


_Undecodable.__module__ = _DRIVER_ONLY.__name__
_DRIVER_ONLY._Undecodable = _Undecodable


def test_stage_that_cannot_decode_its_input_raises_through_result(cluster):
    """C22: the payload reaches the stage but its process cannot unpickle
    it.  The stage's pump forwards the decode error in its place, so
    ``result()`` raises it at once (not a bare timeout after the chain
    wedged), and the chain serves the next input."""
    @rt.remote
    @enable_channels
    class S:
        def f(self, x):
            return x + 1

    g = compile_chain([(S.remote(), "f")])
    try:
        t0 = time.monotonic()
        g.execute_async(_Undecodable(1), timeout=10)
        with pytest.raises(RuntimeError, match="could not decode its input"):
            g.result(timeout=10)
        assert time.monotonic() - t0 < 10
        assert g.execute(1, timeout=10) == 2
    finally:
        g.teardown()
