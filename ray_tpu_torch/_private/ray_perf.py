"""Core microbenchmark suite (baseline #7, SURVEY.md §4/§6).

Reference: ``python/ray/_private/ray_perf.py`` — the ``ray microbenchmark``
CLI: single-node tasks/s, actor calls/s, put/get throughput.  This is the
de-facto perf regression gate; run it after core changes.

Serial benches report per-op latency (p50/p99 µs) alongside ops/s, and the
suite can emit a machine-readable JSON artifact (``--json PATH --label
NAME``; with both ``pre`` and ``post`` labels in the file, the speedup
table ``ab`` is recomputed).

Usage: ``python -m ray_tpu_torch._private.ray_perf [--quick] [--json PATH]
[--label NAME] [--assert-sane]``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import numpy as np

import ray_tpu_torch


def _timeit(name: str, fn: Callable[[], int], *, repeat: int = 3,
            results: Optional[List[dict]] = None) -> dict:
    """fn() runs a batch and returns ops count; report best ops/s."""
    best = 0.0
    for _ in range(repeat):
        t0 = time.perf_counter()
        n = fn()
        dt = time.perf_counter() - t0
        best = max(best, n / dt)
    rec = {"name": name, "ops_per_s": best}
    print(f"{name:<44s} {best:>12,.1f} /s")
    if results is not None:
        results.append(rec)
    return rec


def _latency(name: str, fn_once: Callable[[], None], *, n: int,
             warmup: int = 5,
             results: Optional[List[dict]] = None) -> dict:
    """fn_once() is one serial round trip; report ops/s + p50/p99 µs.

    Unlike ``_timeit`` (best-of-3 batches, throughput benches), serial
    round-trip latency is reported from per-op samples of ONE run so the
    percentiles describe the distribution the ops/s figure came from."""
    for _ in range(max(1, warmup)):
        fn_once()
    lats: List[float] = []
    t_all0 = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        fn_once()
        lats.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all0
    lats.sort()
    p50 = lats[len(lats) // 2] * 1e6
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e6
    rec = {"name": name, "ops_per_s": n / total,
           "p50_us": p50, "p99_us": p99}
    print(f"{name:<44s} {n / total:>12,.1f} /s   "
          f"p50 {p50:,.0f}us  p99 {p99:,.0f}us")
    if results is not None:
        results.append(rec)
    return rec


def _bandwidth(name: str, fn: Callable[[], int], *, repeat: int = 3,
               results: Optional[List[dict]] = None) -> dict:
    """fn() moves bytes and returns byte count; report best GB/s."""
    best = 0.0
    for _ in range(repeat):
        t0 = time.perf_counter()
        nbytes = fn()
        dt = time.perf_counter() - t0
        best = max(best, nbytes / dt / 1e9)
    rec = {"name": name, "gb_per_s": best}
    print(f"{name:<44s} {best:>12.3f} GB/s")
    if results is not None:
        results.append(rec)
    return rec


def transport_floor_us(n: int = 2000) -> float:
    """Measured socket round-trip floor on THIS host (µs): a bare
    ping-pong over the same ``multiprocessing.connection`` transport the
    control plane uses.  The honest denominator for 'how far above the
    hardware is the control plane?' (VERDICT r5 protocol)."""
    import multiprocessing as mp

    def _echo(conn):
        while True:
            obj = conn.recv()
            if obj is None:
                return
            conn.send(obj)

    parent, child = mp.Pipe()
    proc = mp.get_context("fork").Process(target=_echo, args=(child,),
                                          daemon=True)
    proc.start()
    child.close()
    parent.send(1)  # warm
    parent.recv()
    t0 = time.perf_counter()
    for _ in range(n):
        parent.send(1)
        parent.recv()
    dt = time.perf_counter() - t0
    parent.send(None)
    proc.join(timeout=5)
    parent.close()
    return dt / n * 1e6


def main(quick: bool = False, json_path: Optional[str] = None,
         label: Optional[str] = None) -> List[dict]:
    scale = 0.2 if quick else 1.0
    results: List[dict] = []
    floor_us = transport_floor_us(400 if quick else 2000)
    print(f"{'transport floor (pipe RTT)':<44s} {floor_us:>12,.1f} us")
    owns_cluster = not ray_tpu_torch.is_initialized()
    if owns_cluster:
        ray_tpu_torch.init()

    @ray_tpu_torch.remote
    def nop():
        return None

    @ray_tpu_torch.remote
    def echo(x):
        return x

    @ray_tpu_torch.remote
    class Sink:
        def ping(self):
            return None

        def batch(self, n):
            return n

    # -- task throughput (async submit, drain at end) ------------------------
    n_tasks = int(2000 * scale)

    def task_throughput():
        ray_tpu_torch.get([nop.remote() for _ in range(n_tasks)])
        return n_tasks

    _timeit("tasks: submit+get throughput", task_throughput, results=results)

    # -- task round-trip latency (serial) ------------------------------------
    _latency("tasks: serial round-trips",
             lambda: ray_tpu_torch.get(nop.remote()),
             n=int(500 * scale), results=results)

    # -- actor calls ---------------------------------------------------------
    sink = Sink.remote()
    ray_tpu_torch.get(sink.ping.remote())  # warm
    n_actor = int(2000 * scale)

    def actor_async():
        ray_tpu_torch.get([sink.ping.remote() for _ in range(n_actor)])
        return n_actor

    _timeit("actor: async calls", actor_async, results=results)

    _latency("actor: serial round-trips",
             lambda: ray_tpu_torch.get(sink.ping.remote()),
             n=int(1000 * scale), results=results)
    # release the actor's CPU before the task benches below — on a 1-CPU
    # node a live actor would otherwise starve them forever
    ray_tpu_torch.kill(sink)

    # -- object plane --------------------------------------------------------
    small = np.random.bytes(8 * 1024)           # slab plane
    n_small = int(1000 * scale)

    def put_small():
        refs = [ray_tpu_torch.put(small) for _ in range(n_small)]
        del refs
        return n_small

    _timeit("put: 8KB objects (slab plane)", put_small, results=results)

    big = np.random.randint(0, 255, size=50 * 1024 * 1024 // 8,
                            dtype=np.int64)     # 50MB, file plane
    n_big = 4

    def put_big():
        refs = [ray_tpu_torch.put(big) for _ in range(n_big)]
        del refs
        return n_big * big.nbytes

    _bandwidth("put: 50MB numpy (shm plane)", put_big, results=results)

    ref = ray_tpu_torch.put(big)

    def get_big():
        for _ in range(n_big):
            ray_tpu_torch.get(ref)
        return n_big * big.nbytes

    _bandwidth("get: 50MB numpy (zero-copy reads)", get_big, results=results)

    # -- args passing --------------------------------------------------------
    payload = np.random.bytes(int(100 * 1024))
    n_args = int(300 * scale)

    def pass_args():
        ray_tpu_torch.get([echo.remote(payload) for _ in range(n_args)])
        return n_args

    _timeit("tasks: 100KB arg passing", pass_args, results=results)

    if owns_cluster:
        ray_tpu_torch.shutdown()
    if json_path:
        write_json(json_path, label or "run", results, floor_us,
                   quick=quick)
    return results


# Serial rows the A/B speedup table is computed over (the acceptance
# criteria of the control-plane fast-path work are stated on these).
_AB_ROWS = ("tasks: serial round-trips", "actor: serial round-trips",
            "tasks: submit+get throughput", "actor: async calls")


def write_json(path: str, label: str, results: List[dict],
               floor_us: float, quick: bool = False) -> None:
    """Merge one labeled run into the artifact; recompute the pre→post
    speedup table when both sides are present."""
    data: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
    runs = data.setdefault("runs", {})
    runs[label] = {
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "quick": quick,
        "host_cpus": os.cpu_count(),
        "transport_floor_us": floor_us,
        "rows": results,
    }
    pre, post = runs.get("pre"), runs.get("post")
    if pre and post:
        ab = {}
        pre_rows = {r["name"]: r for r in pre["rows"]}
        post_rows = {r["name"]: r for r in post["rows"]}
        for name in _AB_ROWS:
            a, b = pre_rows.get(name), post_rows.get(name)
            if a and b and a.get("ops_per_s"):
                ab[name] = {
                    "pre_ops_per_s": a["ops_per_s"],
                    "post_ops_per_s": b["ops_per_s"],
                    "speedup_x": b["ops_per_s"] / a["ops_per_s"],
                }
        data["ab"] = ab
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    print(f"wrote {path} (label={label!r})")


def assert_sane(results: List[dict]) -> None:
    """CI smoke gate (``make microbench-quick``): the suite completed and
    serial round-trip latency is within a loose sanity ceiling.  Bounds
    are deliberately generous — CI boxes are slow and shared; this
    catches order-of-magnitude regressions and hangs, not 20% drift."""
    by_name = {r["name"]: r for r in results}
    for name in ("tasks: serial round-trips", "actor: serial round-trips"):
        row = by_name.get(name)
        assert row is not None, f"benchmark row missing: {name}"
        assert row["ops_per_s"] > 10, \
            f"{name}: {row['ops_per_s']:.1f} ops/s is implausibly slow"
        assert row["p50_us"] < 100_000, \
            f"{name}: p50 {row['p50_us']:.0f}us exceeds the sanity ceiling"
    for name in ("tasks: submit+get throughput", "put: 8KB objects "
                 "(slab plane)"):
        row = by_name.get(name)
        assert row is not None, f"benchmark row missing: {name}"
        assert row["ops_per_s"] > 10, \
            f"{name}: {row['ops_per_s']:.1f} ops/s is implausibly slow"


if __name__ == "__main__":
    import sys
    argv = sys.argv[1:]

    def _opt(flag):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires a value")
            val = argv[i + 1]
            del argv[i:i + 2]
            return val
        return None

    json_path = _opt("--json")
    label = _opt("--label")
    res = main(quick="--quick" in argv, json_path=json_path, label=label)
    if "--assert-sane" in argv:
        assert_sane(res)
