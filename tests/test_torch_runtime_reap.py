"""A head that dies leaves its slab and object segments in the store's
shm directory; the next head to boot there reaps them, and never a live
session's (``session.reap_orphan_segments``).

Every cluster here is a child process with ``RTT_SHM_DIR`` set to the
test's own directory: session A puts an object and runs a task, then is
killed with SIGKILL, workers and all (its process group); session B
stays alive beside it; session C loses its registry entry (as a session
of code that predates the registry has none) and is killed like A; a fourth head boots,
and its ``init`` must unlink A's slab and segments and leave B's and
C's: only what the registry proves dead is reaped.
"""

import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# puts a 1 MB object (a segment of its own: above the inline size) and
# runs a task whose 1 MB result lands in another, then reports what it
# made and waits on stdin (EOF: a clean shutdown)
_SESSION = """
import json, os, sys, numpy as np, ray_tpu_torch as rt
info = rt.init(num_cpus=1)
ref = rt.put(np.ones(1 << 18, np.float32))
@rt.remote
def big():
    return np.zeros(1 << 18, np.float32)
out = big.remote()
assert rt.get(out).nbytes == 1 << 20
from ray_tpu_torch._private import worker
w = worker.global_worker()
print(json.dumps({"slab": os.path.basename(w.session.slab_path()),
                  "tag": w.session.tag,
                  "objects": ["rtt_" + ref.id, "rtt_" + out.id]}), flush=True)
sys.stdin.read()
rt.shutdown()
print("down", flush=True)
"""

# a head booting in the same directory, then reporting what is left
_NEXT = """
import json, os, ray_tpu_torch as rt
from ray_tpu_torch._private import shm_store
rt.init(num_cpus=1)
print(json.dumps(sorted(os.listdir(shm_store._SHM_DIR))), flush=True)
rt.shutdown()
"""


def _env(shm):
    env = dict(os.environ, PYTHONPATH=REPO, RTT_SHM_DIR=str(shm))
    env.pop("RTT_NUM_GPUS", None)
    return env


def _start(shm):
    import json
    p = subprocess.Popen([sys.executable, "-c", _SESSION], env=_env(shm),
                         cwd=REPO, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True,
                         start_new_session=True)
    line = p.stdout.readline()
    assert line, f"session failed to start (rc {p.poll()})"
    return p, json.loads(line)


def _alive(pid):
    from ray_tpu_torch._private.session import _pid_alive
    return _pid_alive(pid)


def test_next_head_reaps_a_killed_sessions_segments_not_a_live_ones(
        tmp_path):
    import json
    a, made_a = _start(tmp_path)
    b, made_b = _start(tmp_path)
    c, made_c = _start(tmp_path)
    try:
        names = set(os.listdir(tmp_path))
        for made in (made_a, made_b, made_c):
            assert made["slab"] in names
            assert set(made["objects"]) <= names
        pids_a = [int(n) for n in os.listdir(
            tmp_path / "rtt_sessions" / made_a["tag"])]
        assert a.pid in pids_a and len(pids_a) >= 2   # the head, a worker
        shutil.rmtree(tmp_path / "rtt_sessions" / made_c["tag"])
        pids_c = [int(n[4:12], 16) for n in made_c["objects"]]
        assert c.pid in pids_c
        for p, pids in ((a, pids_a), (c, pids_c)):
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(30)
            deadline = time.monotonic() + 30
            while any(map(_alive, pids)) and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not any(map(_alive, pids))
        # nothing reaps at death: A's and C's files are all still there
        names = set(os.listdir(tmp_path))
        for made in (made_a, made_c):
            assert made["slab"] in names and set(made["objects"]) <= names

        out = subprocess.run([sys.executable, "-c", _NEXT],
                             env=_env(tmp_path), cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        left = set(json.loads(out.stdout.splitlines()[-1]))
        assert made_a["slab"] not in left
        assert not set(made_a["objects"]) & left
        assert made_a["tag"] not in os.listdir(tmp_path / "rtt_sessions")
        # the live session's slab, segments and registry entry survive
        assert made_b["slab"] in left
        assert set(made_b["objects"]) <= left
        assert made_b["tag"] in os.listdir(tmp_path / "rtt_sessions")
        # the dead session that never registered is no one's to reap
        assert made_c["slab"] in left
        assert set(made_c["objects"]) <= left
    finally:
        for p in (a, b, c):
            if p.poll() is None:
                p.stdin.close()
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(30)
    # B's clean shutdown takes its slab and registry entry with it
    assert b.returncode == 0 and b.stdout.read().split() == ["down"]
    left = set(os.listdir(tmp_path))
    assert made_b["slab"] not in left
    assert made_b["tag"] not in os.listdir(tmp_path / "rtt_sessions")
