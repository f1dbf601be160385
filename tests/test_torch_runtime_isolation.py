"""Two runtimes on one host: a JAX ``ray_tpu`` cluster and a port
cluster, each in its own subprocess, at once.  The port names what it
puts on a host with ``rtt_`` / ``RTT_`` / ``/tmp/rtt_sessions``, so
neither finds, maps, reaps or kills the other's session, segments or
workers — the shm weights plane included.

The clusters keep their segments where they would meet, in
``/dev/shm``, and each reports the files it made; their session roots
are two private ones, so other tests' clusters on this host never mix
in.  The weights-plane test points both planes at one private directory.
"""

import json
import os
import select
import shutil
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from ray_tpu_torch._private import config as t_config
from ray_tpu_torch._private import memory_monitor as t_mm
from ray_tpu_torch.serve.llm import weights as t_weights

from ray_tpu._private import config as j_config
from ray_tpu._private import memory_monitor as j_mm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One cluster per package: start, run a task (its worker's pid), put a
# 2 MB object (a segment), report the files it made, wait for the
# parent, shut down.  ``{pkg}`` is ray_tpu or ray_tpu_torch.
CLUSTER = """
import json, os, sys
import numpy as np
import {pkg} as rt
from {pkg}._private import flight_recorder, shm_store
info = rt.init(num_cpus=1)
@rt.remote
def pid():
    return os.getpid()
ref = rt.put(np.ones(2_000_000, np.uint8))
files = [str(shm_store._seg_path(str(ref.id))), rt._head.session.slab_path(),
         str(flight_recorder.flight_dir_for(info["session_dir"]))]
assert all(os.path.exists(f) for f in files), files
print(json.dumps({{"session": info["session_dir"],
                  "worker": rt.get(pid.remote()), "files": files}}),
      flush=True)
assert sys.stdin.readline().strip() == "attach"
rt.shutdown()
print(json.dumps({{"down": True}}), flush=True)
"""

# attach to the latest session of this package's root, report its dir
ATTACH = """
import json
import {pkg} as rt
info = rt.init(address="auto")
print(json.dumps({{"session": info["session_dir"]}}), flush=True)
rt.shutdown()
"""

# the JAX package's weights plane: publish key "k" and stay alive, then
# look up key "k2", which only the port has published
JAX_WEIGHTS = """
import json, sys
import jax.numpy as jnp
from ray_tpu.serve.llm import weights
calls = []
def init(tag):
    def fn():
        calls.append(tag)
        return {"w": jnp.full((4,), 7.0)}
    return fn
weights.publish_or_attach("k", init("k"))
print(json.dumps({"published": True}), flush=True)
assert sys.stdin.readline().strip() == "look"
p = weights.publish_or_attach("k2", init("k2"))
print(json.dumps({"calls": calls, "w": [float(x) for x in p["w"]]}),
      flush=True)
assert sys.stdin.readline().strip() == "done"
weights.release("k")
weights.release("k2")
"""


class Child:
    def __init__(self, script: str, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script], cwd=REPO, env=env, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    def read(self, timeout: float = 60.0) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r, _, _ = select.select([self.proc.stdout], [], [],
                                    max(0.0, deadline - time.monotonic()))
            if not r:
                break
            line = self.proc.stdout.readline()
            if not line:
                break
            if line.startswith("{"):
                return json.loads(line)
        self.proc.kill()
        raise AssertionError(f"child gave no result: "
                             f"{self.proc.stderr.read()[-3000:]}")

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture
def roots(tmp_path):
    """Session roots short enough for the sessions' AF_UNIX sockets."""
    d = tempfile.mkdtemp(prefix="rtt_iso_", dir="/tmp")
    yield {"rtt": os.path.join(d, "t"), "rtpu": os.path.join(d, "j")}
    shutil.rmtree(d, ignore_errors=True)


def _env(tmp_path, roots) -> dict:
    shm = tmp_path / "shm"
    shm.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               RTT_SHM_DIR=str(shm), RTPU_SHM_DIR=str(shm),
               RTT_SESSION_DIR_ROOT=roots["rtt"],
               RTPU_SESSION_DIR_ROOT=roots["rtpu"],
               RTT_OBJECT_STORE_MEMORY_MB="64",
               RTPU_OBJECT_STORE_MEMORY_MB="64")
    return env


def _names(d) -> set:
    return set(os.listdir(d))


def test_two_runtimes_on_one_host(tmp_path, roots):
    env = _env(tmp_path, roots)
    for k in ("RTT_SHM_DIR", "RTPU_SHM_DIR"):
        env.pop(k)
    assert t_config._DEFS["session_dir_root"].default == "/tmp/rtt_sessions"
    assert j_config._DEFS["session_dir_root"].default == "/tmp/rtpu_sessions"

    port = Child(CLUSTER.format(pkg="ray_tpu_torch"), env)
    jax_ = Child(CLUSTER.format(pkg="ray_tpu"), env)
    try:
        p, j = port.read(), jax_.read()
        # segment, slab and flight-recorder dir: each of its own prefix
        assert [os.path.basename(f)[:4] for f in p["files"][:2]] == \
            ["rtt_"] * 2 and p["files"][2].startswith("/dev/shm/rtt_flight/")
        assert [os.path.basename(f)[:5] for f in j["files"][:2]] == \
            ["rtpu_"] * 2 and j["files"][2].startswith("/dev/shm/rtpu_flight/")

        # each package's auto-attach finds its own live session only
        for pkg, want in (("ray_tpu_torch", p), ("ray_tpu", j)):
            a = Child(ATTACH.format(pkg=pkg), env)
            assert a.read()["session"] == want["session"]
            a.close()
        assert p["session"].startswith(roots["rtt"] + "/")
        assert j["session"].startswith(roots["rtpu"] + "/")

        # the OOM killer proves a worker by its own package's module
        assert t_mm._pid_is_local_worker(p["worker"])
        assert not t_mm._pid_is_local_worker(j["worker"])
        assert j_mm._pid_is_local_worker(j["worker"])
        assert not j_mm._pid_is_local_worker(p["worker"])
    finally:
        for c in (port, jax_):
            if c.proc.poll() is None:
                c.send("attach")
        downs = [c.read().get("down") for c in (port, jax_)]
        for c in (port, jax_):
            c.close()
    assert downs == [True, True]
    # segments and slabs are gone; the flight rings stay by design (a
    # crash-surviving record, reaped by the next cluster's head)
    for f in p["files"][:2] + j["files"][:2]:
        assert not os.path.exists(f), f


def test_weights_planes_never_meet(tmp_path, roots, monkeypatch):
    """C6: the port neither attaches to nor reaps the JAX package's
    weight segments in a shared shm directory, and the JAX package's
    publish_or_attach does not see the port's."""
    env = _env(tmp_path, roots)
    shm = tmp_path / "shm"
    monkeypatch.setenv("RTT_SHM_DIR", str(shm))
    jax_ = Child(JAX_WEIGHTS, env)
    try:
        assert jax_.read()["published"]
        jax_names = _names(shm)
        assert f"rtpu_llmw_k.{jax_.proc.pid}.ready" in jax_names
        # a dead JAX publisher's leftovers: not the port's to reap
        dead = 2 ** 22 + 12345
        for sfx in ("", ".ready"):
            (shm / f"rtpu_llmw_k.{dead}{sfx}").write_bytes(b"x")
        assert t_weights.reap_orphans() == 0
        calls = []

        def init(device):
            calls.append(device.type)
            return {"w": torch.full((4,), 3.0, device=device)}

        cpu = torch.device("cpu")
        got = t_weights.publish_or_attach("k", init, cpu)
        assert calls == ["cpu"]                 # its own init, no attach
        assert got["w"].tolist() == [3.0] * 4
        t_weights.publish_or_attach("k2", init, cpu)
        assert os.path.exists(t_weights._seg_path("k2", os.getpid())
                              + ".ready")
        assert jax_names <= _names(shm)         # nothing of JAX's reaped
        jax_.send("look")
        seen = jax_.read()
        # the JAX package ran its own init for k2: the port's segment is
        # invisible to it
        assert seen["calls"] == ["k", "k2"] and seen["w"] == [7.0] * 4
        jax_.send("done")
    finally:
        jax_.close()
        t_weights.release("k")
        t_weights.release("k2")
    assert not [n for n in _names(shm) if n.startswith("rtt_llmw_")]
