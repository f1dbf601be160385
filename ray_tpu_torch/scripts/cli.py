"""``ray_tpu_torch`` command-line interface.

Reference: ``python/ray/scripts/scripts.py`` (SURVEY.md §2.3) — ``ray
start/stop/status/timeline/memory/microbenchmark`` and the state-API
``ray list ...`` commands.  Invoke as ``python -m ray_tpu_torch`` (see
``ray_tpu_torch/__main__.py``) or ``python -m ray_tpu_torch.scripts.cli``.

``start`` boots a head session whose control plane outlives the command
(daemon-style via fork) so other drivers can
``ray_tpu_torch.init(address="auto")`` against it; ``stop`` terminates the
latest session's head via its descriptor's ``head_pid``, and only when
that session is a ``start`` head's (``role: head``).  The command forks before
anything touches a card, so the head holds no CUDA context; its GPU
workers are the ones that do.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path
from typing import List, Optional


def _connect(address: Optional[str]) -> None:
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        return  # in-process callers (tests) are already connected
    ray_tpu_torch.init(address=address or "auto")


# ------------------------------------------------------------------ commands
def _start_aux_servers(args) -> None:
    from ray_tpu_torch._private import worker as worker_mod
    if getattr(args, "dashboard_port", None) is not None:
        from ray_tpu_torch.dashboard import start_dashboard
        start_dashboard(port=args.dashboard_port)
    if getattr(args, "client_server_port", None) is not None:
        from ray_tpu_torch.util.client import ClientProxyServer
        ClientProxyServer(worker_mod.global_worker().session,
                          host=getattr(args, "client_server_host", None)
                          or "127.0.0.1",
                          port=args.client_server_port)


def cmd_start(args) -> int:
    import ray_tpu_torch
    session_dir = getattr(args, "session_dir", None)
    if args.block:
        ray_tpu_torch.init(num_cpus=args.num_cpus or None,
                           _session_dir=session_dir)
        _start_aux_servers(args)
        w = ray_tpu_torch._worker_mod.global_worker()  # noqa: SLF001
        desc = w.session.path
        print(f"head started (session {desc}); Ctrl-C to stop")
        try:
            signal.pause()
        except KeyboardInterrupt:
            pass
        ray_tpu_torch.shutdown()
        return 0
    # the child reports its own session dir through this pipe: the root's
    # session_latest link names whichever init() ran last, which under
    # concurrent heads need not be this one
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:  # child: become the head daemon
        os.close(rfd)
        os.setsid()
        # detach from the parent's pipes or a capturing caller never sees
        # EOF; daemon logs go to the session dir once init() runs
        devnull = os.open(os.devnull, os.O_RDWR)
        for fd in (0, 1, 2):
            os.dup2(devnull, fd)
        ray_tpu_torch.init(num_cpus=args.num_cpus or None,
                           _session_dir=session_dir)
        _start_aux_servers(args)
        w = ray_tpu_torch._worker_mod.global_worker()  # noqa: SLF001
        desc = w.session.read_descriptor()
        desc.update({"role": "head", "head_pid": os.getpid()})
        w.session.write_descriptor(desc)
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
        os.write(wfd, str(w.session.path).encode())
        os.close(wfd)
        while True:
            time.sleep(3600)
    # parent: wait for the child to name the session whose descriptor
    # records it as the head (EOF first: it died during init)
    os.close(wfd)
    path = _read_pipe(rfd, timeout_s=20.0)
    if path:
        try:
            desc = json.loads((Path(path) / "session.json").read_text())
        except (OSError, json.JSONDecodeError):
            desc = {}
        if desc.get("head_pid") == pid and desc.get("role") == "head":
            print(f"head started: pid={pid} session={path}\n"
                  f"connect with ray_tpu_torch.init(address='auto')")
            return 0
    print("head failed to start", file=sys.stderr)
    return 1


def _read_pipe(fd: int, timeout_s: float) -> str:
    """Everything written to ``fd`` until EOF or ``timeout_s``."""
    import select
    chunks = []
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                break
            chunk = os.read(fd, 4096)
            if not chunk:
                break
            chunks.append(chunk)
    finally:
        os.close(fd)
    return b"".join(chunks).decode()


def cmd_join(args) -> int:
    import ray_tpu_torch._private.node_agent as na
    argv = ["--address", args.address]
    if args.num_cpus:
        argv += ["--num-cpus", str(args.num_cpus)]
    # forward explicit values even when falsy ("--num-gpus 0" must be able
    # to override an ambient $RTT_NUM_GPUS)
    if args.num_gpus is not None:
        argv += ["--num-gpus", str(args.num_gpus)]
    if args.labels is not None:
        argv += ["--labels", args.labels]
    return na.main(argv)


def cmd_stop(args) -> int:
    from ray_tpu_torch._private.session import Session
    try:
        desc = Session.latest().read_descriptor()
    except FileNotFoundError:
        print("no running session found")
        return 1
    # only a head that ``start`` forked records itself so; the ``pid`` of
    # any other session is the driver whose init() made it, never a head
    # this command may end
    pid = desc.get("head_pid")
    if desc.get("role") != "head" or not pid:
        print(f"no CLI head runs in the latest session "
              f"({desc.get('session_name')}): nothing to stop")
        return 1
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to head pid={pid}")
        return 0
    except ProcessLookupError:
        print(f"head pid={pid} already gone")
        return 0


def cmd_status(args) -> int:
    _connect(args.address)
    from ray_tpu_torch.util import state
    s = state.cluster_summary()
    # fleet header (DESIGN.md §4j): lifecycle phases, demand backlog,
    # last elastic re-mesh — the at-a-glance elasticity view; the full
    # JSON (fleet section included) follows for tooling
    fleet = s.get("fleet") or {}
    phases = fleet.get("phases") or {}
    phase_txt = " ".join(f"{k}={v}" for k, v in sorted(phases.items())) \
        or "none"
    print(f"fleet: nodes {phase_txt} | demand backlog "
          f"{fleet.get('demand_backlog_count', 0)}")
    for d in fleet.get("draining") or []:
        ttl = d.get("deadline_in_s")
        print(f"  draining {d['node_id'][:8]} ({d.get('reason')})"
              + (f" deadline in {ttl:.0f}s" if ttl is not None else ""))
    lr = fleet.get("last_remesh")
    if lr:
        print(f"  last elastic transition: {lr.get('action')} "
              f"group={lr.get('group')} gen={lr.get('generation')} "
              f"world={lr.get('world_size')}")
    print(json.dumps(s, indent=2, default=str))
    return 0


def cmd_list(args) -> int:
    _connect(args.address)
    from ray_tpu_torch.util import state
    fns = {"nodes": state.list_nodes, "actors": state.list_actors,
           "tasks": state.list_tasks, "objects": state.list_objects,
           "workers": state.list_workers,
           "placement-groups": state.list_placement_groups}
    rows = fns[args.kind]()
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_memory(args) -> int:
    _connect(args.address)
    from ray_tpu_torch.util import state
    rows = state.object_memory(group_by=args.group_by)
    print(f"{'group':<12} {'count':>8} {'bytes':>14} {'refs':>6}")
    for r in rows:
        print(f"{r[args.group_by]:<12} {r['count']:>8} {r['bytes']:>14,} "
              f"{r['pinned_refs']:>6}")
    return 0


def cmd_stack(args) -> int:
    """All-worker stack dump (reference: ``ray stack``)."""
    _connect(args.address)
    from ray_tpu_torch._private import worker as _worker
    resp = _worker.global_worker().rpc("stack")
    got, expected = resp["stacks"], resp["expected"]
    for wid, text in sorted(got.items()):
        print(f"===== worker {wid} =====")
        print(text)
    if len(got) < expected:
        print(f"({expected - len(got)} worker(s) did not reply in time)")
    return 0


def cmd_timeline(args) -> int:
    _connect(args.address)
    import ray_tpu_torch
    out = args.output or f"timeline_{int(time.time())}.json"
    events = ray_tpu_torch.timeline(filename=out)
    print(f"wrote {len(events)} events to {out} (chrome://tracing format)")
    return 0


def cmd_trace(args) -> int:
    """Assemble one request's cross-process trace tree
    (``ray_tpu_torch trace <trace_id> [-o out.json]``); with no id, list the
    trace ids present in the timeline, most recent first."""
    _connect(args.address)
    import ray_tpu_torch
    from ray_tpu_torch.util import trace_assembly
    events = ray_tpu_torch.timeline()
    if not args.trace_id:
        ids = trace_assembly.trace_ids(events)
        if not ids:
            print("no traces in the timeline (is trace_sample_rate 0, "
                  "or nothing traced yet?)")
            return 1
        for t in ids[:20]:
            print(t)
        return 0
    roots = trace_assembly.build_tree(events, args.trace_id)
    if not roots:
        print(f"no events for trace {args.trace_id!r}", file=sys.stderr)
        return 1
    print(trace_assembly.render_tree(roots))
    if args.output:
        doc = trace_assembly.to_chrome(events, args.trace_id)
        with open(args.output, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} events to {args.output} "
              f"(chrome://tracing / perfetto format)")
    return 0


def cmd_profile(args) -> int:
    """Query the always-on cluster profiler (``ray_tpu_torch profile``,
    DESIGN.md §4o): merged folded stacks over a trailing window,
    optional differential view, and a dependency-free SVG flamegraph."""
    _connect(args.address)
    from ray_tpu_torch.util import profiler as profiler_mod
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.tsdb import QueryError
    try:
        if args.diff:
            win_a = profiler_mod.parse_duration(args.diff[0])
            win_b = profiler_mod.parse_duration(args.diff[1])
            resp = state.profile_diff(win_a, win_b, proc=args.proc)
        else:
            resp = state.profile(
                window_s=profiler_mod.parse_duration(args.window),
                proc=args.proc)
    except QueryError as e:
        print(f"profile query error: {e}", file=sys.stderr)
        return 2
    if resp.get("disabled"):
        print("head has no profile store (profiler_enabled=0 or older "
              "release)", file=sys.stderr)
        return 1
    if args.diff:
        rows = sorted(resp.get("diff", {}).items(),
                      key=lambda kv: -abs(kv[1]))
        print(f"# windows: A={resp['window_a_s']:.0f}s (recent) vs "
              f"B={resp['window_b_s']:.0f}s (before it); "
              f"delta = A fraction - B fraction")
        for stack, delta in rows[:40]:
            print(f"{delta:+.4f}  {stack}")
        if args.output:
            with open(args.output, "w") as f:
                json.dump(resp, f, indent=2)
            print(f"wrote diff JSON to {args.output}")
        return 0
    stacks = resp.get("stacks", {})
    if args.flame:
        svg = profiler_mod.render_flame_svg(stacks)
        with open(args.flame, "w") as f:
            f.write(svg)
        print(f"wrote flamegraph ({resp.get('samples', 0)} samples, "
              f"{len(stacks)} stacks) to {args.flame}")
    folded = profiler_mod.folded_text(stacks)
    if args.output:
        with open(args.output, "w") as f:
            f.write(folded + ("\n" if folded else ""))
        print(f"wrote folded stacks to {args.output}")
    if not args.flame and not args.output:
        print(f"# {resp.get('samples', 0)} samples over "
              f"{resp.get('window_s', 0):.0f}s from "
              f"{len(resp.get('procs', []))} process(es)")
        for line in folded.splitlines()[:40]:
            print(line)
    return 0


def _debug_stacks(args) -> int:
    """All-worker stack dump via the debug surface (``ray_tpu_torch debug
    stacks``): same GCS ``stack`` fan-out as ``ray_tpu_torch stack`` but with
    a machine-readable ``-o`` JSON form for tooling."""
    from ray_tpu_torch._private import worker as _worker
    resp = _worker.global_worker().rpc("stack")
    got, expected = resp["stacks"], resp["expected"]
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"stacks": got, "expected": expected}, f, indent=2)
        print(f"wrote stacks of {len(got)}/{expected} worker(s) "
              f"to {args.output}")
        return 0
    for wid, text in sorted(got.items()):
        print(f"===== worker {wid} =====")
        print(text)
    if len(got) < expected:
        print(f"({expected - len(got)} worker(s) did not reply in time)")
    return 0


def _debug_incidents(args) -> int:
    """Post-mortem bundle access (``ray_tpu_torch debug incidents``): list the
    head's captured incident bundles, or fetch one with ``--id``."""
    from ray_tpu_torch._private import worker as _worker
    w = _worker.global_worker()
    if args.id:
        resp = w.rpc("debug_incidents", id=args.id)
        if resp.get("error"):
            print(resp["error"], file=sys.stderr)
            return 1
        if args.output:
            with open(args.output, "w") as f:
                json.dump(resp, f, indent=2)
            print(f"wrote incident {args.id} to {args.output}")
            return 0
        for name, text in sorted(resp.get("files", {}).items()):
            print(f"===== {name} =====")
            print(text)
        return 0
    resp = w.rpc("debug_incidents")
    incidents = resp.get("incidents", [])
    if args.output:
        with open(args.output, "w") as f:
            json.dump(incidents, f, indent=2)
        print(f"wrote {len(incidents)} incident(s) to {args.output}")
        return 0
    if not incidents:
        print("no incidents captured")
        return 0
    for inc in incidents:
        ts = inc.get("ts")
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(ts)) if ts else "?"
        print(f"{inc['id']}  kind={inc.get('kind')} "
              f"node={str(inc.get('node_id'))[:8]} at {when}")
    return 0


def cmd_debug(args) -> int:
    """Debug surface: ``dump`` (flight-recorder rings, SIGKILLed
    processes included), ``stacks`` (all-worker stack dump), and
    ``incidents`` (post-mortem bundles, DESIGN.md §4o)."""
    _connect(args.address)
    if args.action == "stacks":
        return _debug_stacks(args)
    if args.action == "incidents":
        return _debug_incidents(args)
    if args.action != "dump":
        print(f"unknown debug action {args.action!r}", file=sys.stderr)
        return 2
    from ray_tpu_torch._private import worker as _worker
    resp = _worker.global_worker().rpc("debug_dump", tail=args.tail)
    procs = resp.get("procs", {})
    for r in resp.get("raylets", []):
        print(f"----- raylet node {r['node_id'][:8]} "
              f"{'attached' if r.get('attached') else 'DETACHED'}: "
              f"held_leases={r.get('held_leases')} "
              f"queued={r.get('queued_leases')} "
              f"reconcile_age={r.get('last_reconcile_age_s')}s "
              f"stats={r.get('stats')}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(procs, f, indent=2)
        print(f"wrote flight-recorder dump of {len(procs)} process(es) "
              f"to {args.output}")
        return 0
    for name, info in sorted(procs.items()):
        state = "alive" if info.get("alive") else "DEAD"
        print(f"===== {name} (pid={info.get('pid')}, {state}) =====")
        for r in info.get("records", []):
            ts = time.strftime("%H:%M:%S", time.localtime(r["ts"]))
            frac = f"{r['ts'] % 1:.3f}"[1:]
            print(f"  {ts}{frac} #{r['seq']:<8d} {r['kind']:<12s} "
                  f"{r['detail']}")
    return 0


def cmd_microbenchmark(args) -> int:
    from ray_tpu_torch._private import ray_perf
    results = ray_perf.main(quick=args.quick, json_path=args.json,
                            label=args.label)
    if args.assert_sane:
        ray_perf.assert_sane(results)
    return 0


def cmd_metrics(args) -> int:
    _connect(args.address)
    from ray_tpu_torch.util import metrics
    print(metrics.prometheus_text(metrics.collect_cluster()))
    return 0


def _top_frame() -> str:
    """One rendered ``ray_tpu_torch top`` frame from the head TSDB
    (DESIGN.md §4k): instant queries over the history the GCS already
    holds — no cluster-wide scrape, one RPC per query."""
    from ray_tpu_torch._private import worker as _worker
    from ray_tpu_torch.util import state

    def q(expr):
        try:
            return state.metrics_history(expr)
        except Exception:  # noqa: BLE001 - series not there yet
            return []

    def total(rows):
        return sum(r["value"] for r in rows)

    w = _worker.global_worker()
    lines: List[str] = []
    try:
        resp = w.rpc("metrics_query", op="stats")
    except Exception:  # noqa: BLE001 - older head: no metrics_query op
        resp = {"disabled": True}
    stats = resp.get("stats")
    if stats is None or resp.get("disabled"):
        return (f"ray_tpu_torch top — {time.strftime('%H:%M:%S')}  "
                f"(head has no TSDB — older release or tsdb_enabled=0; "
                f"`ray_tpu_torch metrics` still shows the live snapshot)")
    lines.append(
        f"ray_tpu_torch top — {time.strftime('%H:%M:%S')}  "
        f"tsdb {stats.get('series', 0)} series / "
        f"{stats.get('samples_total', 0)} samples")
    lines.append("")
    task_rate = q('sum(rate(rtt_tasks_total[60s]))')
    exec_p99 = q('quantile_over_time(0.99, rtt_task_exec_seconds[5m])')
    queue_p99 = q('quantile_over_time(0.99, rtt_task_queue_seconds[5m])')
    row = f"tasks     {total(task_rate):8.1f}/s"
    if exec_p99:
        row += f"   exec p99 {max(r['value'] for r in exec_p99) * 1e3:.1f}ms"
    if queue_p99:
        row += f"   queue p99 {max(r['value'] for r in queue_p99) * 1e3:.1f}ms"
    lines.append(row)
    depth = q('sum by (node) (rtt_raylet_queue_depth)')
    if depth:
        lines.append("raylets   " + "  ".join(
            f"{r['tags'].get('node', '?')[:8]}:q={r['value']:.0f}"
            for r in depth))
    steps = q('sum by (rank) '
              '(increase(rtt_train_step_seconds[60s]))')
    if steps:
        means = {}
        for r in q('avg by (rank) (avg_over_time('
                   'rtt_train_throughput_steps_per_s[60s]))'):
            means[r["tags"].get("rank", "?")] = r["value"]
        per_rank = []
        for r in sorted(steps, key=lambda r: r["tags"].get("rank", "")):
            rank = r["tags"].get("rank", "?")
            thr = means.get(rank)
            per_rank.append(
                f"r{rank}:{1.0 / thr * 1e3:.0f}ms" if thr
                else f"r{rank}:{r['value']:.0f} steps")
        lines.append("train     " + "  ".join(per_rank) + "   (60s)")
    kv = q('sum by (state) (rtt_llm_kv_blocks)')
    if kv:
        used = total([r for r in kv if r["tags"].get("state") == "used"])
        free = total([r for r in kv if r["tags"].get("state") == "free"])
        occ = q('avg(avg_over_time(rtt_llm_batch_occupancy[60s]))')
        row = f"llm       kv used {used:.0f} / free {free:.0f}"
        if occ:
            row += f"   batch occupancy {total(occ):.2f}"
        lines.append(row)
    serve_rate = q('sum(rate(rtt_serve_requests_total[60s]))')
    if serve_rate:
        p99 = q('quantile_over_time(0.99, '
                'rtt_serve_request_latency_seconds[5m])')
        row = f"serve     {total(serve_rate):8.1f} req/s"
        if p99:
            row += f"   p99 {max(r['value'] for r in p99) * 1e3:.0f}ms"
        lines.append(row)
    goodput = q('sum(rtt_elastic_goodput_steps_per_s)')
    if goodput:
        lines.append(f"goodput   {total(goodput):.2f} useful steps/s")
    try:
        events = w.rpc("fleet_events", since=0)["events"]
    except Exception:  # noqa: BLE001 - older head
        events = []
    anomalies = [e for e in events
                 if e.get("kind") in ("straggler", "slo_burn")][-5:]
    if anomalies:
        lines.append("")
        lines.append("anomalies (fleet-event feed):")
        for e in anomalies:
            ts = time.strftime("%H:%M:%S", time.localtime(e["ts"]))
            detail = " ".join(
                f"{k}={v}" for k, v in sorted(e.items())
                if k not in ("kind", "ts", "seq", "node_id"))
            lines.append(f"  {ts} {e['kind']:<10s} "
                         f"node={str(e.get('node_id'))[:8]} {detail}")
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live refreshing cluster view over the head TSDB (``ray_tpu_torch top``;
    ``--once`` renders a single frame — tests and pipes)."""
    _connect(args.address)
    if args.once:
        print(_top_frame())
        return 0
    try:
        while True:
            frame = _top_frame()
            # clear + home, then the frame — flicker-free enough for a
            # status view without a curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_version(args) -> int:
    import ray_tpu_torch
    print(getattr(ray_tpu_torch, "__version__", "0.1.0-dev"))
    return 0


# --------------------------------------------------------------------- main
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch",
        description="distributed framework CLI (PyTorch / CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start a head node")
    sp.add_argument("--num-cpus", type=int, default=0)
    sp.add_argument("--block", action="store_true",
                    help="stay in the foreground")
    sp.add_argument("--dashboard-port", type=int, default=None,
                    help="serve the dashboard REST API on this port")
    sp.add_argument("--client-server-port", type=int, default=None,
                    help="accept ray:// remote clients on this port")
    sp.add_argument("--client-server-host", default=None,
                    help="bind address for the client server (default "
                         "loopback; 0.0.0.0 requires sharing the session "
                         "auth key with clients via RTT_AUTH_KEY)")
    sp.add_argument("--session-dir", default=None,
                    help="start over an EXISTING session dir, restoring "
                         "the GCS snapshot (head restart / fault "
                         "tolerance); surviving workers reattach")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the latest head node")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("join", help="join a remote head as a worker node "
                        "(set RTT_AUTH_KEY to the head session's key)")
    sp.add_argument("--address", required=True, help="head HOST:PORT")
    sp.add_argument("--num-cpus", type=int, default=0)
    sp.add_argument("--num-gpus", type=float, default=None,
                    help="CUDA cards on this host (default: $RTT_NUM_GPUS, "
                         "else torch.cuda.device_count())")
    sp.add_argument("--labels", default=None,
                    help="node labels k=v,k2=v2 (e.g. rack=a,zone=b; "
                         "also $RTT_NODE_LABELS)")
    sp.set_defaults(fn=cmd_join)

    sp = sub.add_parser("top", help="live refreshing cluster view over "
                        "the head metrics TSDB (tasks/s, queue depths, "
                        "per-rank step times, KV pressure, goodput)")
    sp.add_argument("--address", default=None)
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    sp.add_argument("--once", action="store_true",
                    help="render one frame and exit (tests / pipes)")
    sp.set_defaults(fn=cmd_top)

    for name, fn in (("status", cmd_status), ("timeline", cmd_timeline),
                     ("memory", cmd_memory), ("metrics", cmd_metrics),
                     ("stack", cmd_stack)):
        sp = sub.add_parser(name)
        sp.add_argument("--address", default=None)
        if name == "timeline":
            sp.add_argument("-o", "--output", default=None)
        if name == "memory":
            sp.add_argument("--group-by", default="loc",
                            choices=("loc", "state"))
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("trace", help="assemble one request's "
                        "cross-process trace tree (no id: list traces)")
    sp.add_argument("trace_id", nargs="?", default=None)
    sp.add_argument("--address", default=None)
    sp.add_argument("-o", "--output", default=None,
                    help="also write the Chrome/Perfetto trace JSON here")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("debug", help="debugging aids (flight recorder, "
                        "stack dumps, incident bundles)")
    sp.add_argument("action", choices=("dump", "stacks", "incidents"),
                    help="dump: every process's flight-recorder ring "
                         "(SIGKILLed processes included); stacks: "
                         "all-worker stack dump; incidents: post-mortem "
                         "bundles captured by the head")
    sp.add_argument("--address", default=None)
    sp.add_argument("--tail", type=int, default=50,
                    help="records per process (newest first kept)")
    sp.add_argument("--id", default=None,
                    help="incidents: fetch one bundle by id")
    sp.add_argument("-o", "--output", default=None,
                    help="write the full dump as JSON instead of text")
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("profile", help="query the always-on cluster "
                        "profiler: folded stacks, differential view, "
                        "SVG flamegraph")
    sp.add_argument("--address", default=None)
    sp.add_argument("--window", default="5m",
                    help="trailing window (e.g. 90s, 5m, 1h; default 5m)")
    sp.add_argument("--proc", default=None,
                    help="narrow to one publisher (worker id or ROLE:PID)")
    sp.add_argument("--diff", nargs=2, metavar=("WINA", "WINB"),
                    default=None,
                    help="differential view: recent WINA vs the WINB "
                         "before it")
    sp.add_argument("--flame", default=None, metavar="OUT.SVG",
                    help="write an SVG flamegraph here")
    sp.add_argument("-o", "--output", default=None,
                    help="write folded stacks (or diff JSON) here")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("kind", choices=("nodes", "actors", "tasks", "objects",
                                     "workers", "placement-groups"))
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("microbenchmark", help="run the core perf suite")
    sp.add_argument("--quick", action="store_true")
    sp.add_argument("--json", default=None, metavar="PATH",
                    help="merge results into a JSON artifact at PATH")
    sp.add_argument("--label", default=None,
                    help="run label inside the JSON artifact (e.g. pre/post)")
    sp.add_argument("--assert-sane", action="store_true",
                    help="CI smoke: fail on hangs / implausible latency")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("operator", add_help=False,
                        help="reconcile a declarative cluster spec into "
                        "Kubernetes pods (KubeRay-operator equivalent); "
                        "flags are the operator's own (--spec, ...)")
    # flags are parsed by the operator itself (main() intercepts this
    # subcommand before argparse — the operator owns its flag surface,
    # duplicating it here would drift)
    sp.set_defaults(fn=lambda a: 0)

    sp = sub.add_parser("version")
    sp.set_defaults(fn=cmd_version)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "operator":
        # passthrough: the operator parses its own flags (incl. --help)
        from ray_tpu_torch.autoscaler import operator as operator_mod
        return operator_mod.main(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
