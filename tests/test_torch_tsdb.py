"""The port's head-resident metrics TSDB (``ray_tpu_torch/util/tsdb.py``):
mirrors of ``tests/test_tsdb.py``, its 20 cases — ring/ladder mechanics,
the query engine against synthetic-trace oracles (EXACT — the traces are
built so every expected value is computable in closed form with the same
float operations), detectors, the SLO rule table, and the live
metrics_query RPC path through the port's GCS.

Every case but the last runs on a fake clock, with no process and no
sleep; the last starts one cluster of the port's own (a short session
root, stopped after it)."""

import logging
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.tsdb import (
    LADDER,
    QueryError,
    SloBurnAlerter,
    StragglerDetector,
    TSDB,
    parse_duration,
)


# ---------------------------------------------------------------- fixtures
class Clock:
    def __init__(self, t0=1_000_000.0):
        self.t = t0

    def __call__(self):
        return self.t


def make_db(clock, **kw):
    return TSDB(clock=clock, **kw)


def snap(name, kind, series):
    return {"ts": 0.0,
            "snapshot": {name: {"kind": kind, "description": "",
                                "series": series}}}


def hist_value(bounds, counts, total_sum, count):
    """A publisher-shaped cumulative histogram value."""
    return {"buckets": dict(zip(list(bounds) + ["+Inf"], counts)),
            "sum": total_sum, "count": count}


def feed_counter(db, clock, name, values, dt=1.0, tags=None, worker="w0"):
    for v in values:
        db.ingest(worker, snap(name, "counter",
                               [{"tags": dict(tags or {}), "value": v}]),
                  now=clock.t)
        clock.t += dt
    clock.t -= dt  # queries evaluate at the last sample's time


# ------------------------------------------------------------ ring / ladder
def test_raw_ring_wrap_keeps_newest():
    clock = Clock()
    db = make_db(clock, raw_slots=16)
    feed_counter(db, clock, "c_total", [float(i) for i in range(40)])
    rec = db.query("increase(c_total[10s])")
    # raw ring holds the newest 16 samples (24..39); a 10s window is
    # fully covered by raw: increase = 39 - 29 = 10
    assert rec == [{"tags": {"worker": "w0"}, "value": 10.0}]


def test_ladder_fallback_when_raw_wrapped():
    """A window older than raw's coverage answers from the 30s rung —
    downsampled last-wins, still cumulative-correct for increase()."""
    clock = Clock()
    db = make_db(clock, raw_slots=16)
    # 200 samples 1s apart: raw covers the last 16s, mid (30s rung)
    # covers everything at one sample per 30s bucket
    feed_counter(db, clock, "c_total", [2.0 * i for i in range(200)])
    got = db.query("increase(c_total[150s])")
    assert len(got) == 1
    # mid rung: last sample of each 30s bucket.  Window start falls
    # between bucket samples, so the increase spans the covered
    # sub-window — assert the exact delta between the first and last
    # mid samples inside [t-150, t]
    start, end = clock.t - 150.0, clock.t
    # reconstruct the mid rung exactly: last (ts, value) per 30s bucket
    ts0 = clock.t - 199.0
    mids = {}
    for i in range(200):
        ts = ts0 + i
        mids[int(ts // 30.0)] = (ts, 2.0 * i)
    in_window = sorted(v for k, v in mids.items()
                       if start <= v[0] <= end)
    expected = in_window[-1][1] - in_window[0][1]
    assert got[0]["value"] == expected


def test_downsample_bucket_is_last_wins():
    clock = Clock(1_000_020.0)
    db = make_db(clock, raw_slots=4)
    # 8 samples inside ONE 30s bucket, then one in the next; raw (4
    # slots) wraps, mid keeps exactly the final state of each bucket
    feed_counter(db, clock, "g", [float(i) for i in range(8)], dt=1.0)
    ser = next(iter(db._series.values()))
    mid = ser.rings[1]
    assert mid.res == LADDER[0][0]
    samples = mid.samples(0, 2_000_000.0)
    assert [v for _, v in samples] == [7.0]  # one bucket, final value


# ------------------------------------------------- query engine: exact oracle
def test_rate_and_increase_exact():
    clock = Clock()
    db = make_db(clock)
    # counter grows 5.0 per 1s sample for 20 samples: rate over any
    # window covering >= 2 samples is exactly 5.0 (binary-exact floats)
    feed_counter(db, clock, "rtt_tasks_total",
                 [5.0 * i for i in range(20)], tags={"state": "ok"})
    assert db.query('rate(rtt_tasks_total{state="ok"}[30s])') == \
        [{"tags": {"state": "ok", "worker": "w0"}, "value": 5.0}]
    # increase over the trailing 10s: samples at t-10..t -> 95 - 45
    assert db.query("increase(rtt_tasks_total[10s])")[0]["value"] == 50.0
    # windowed sum aggregation
    assert db.query("sum(rate(rtt_tasks_total[30s]))") == \
        [{"tags": {}, "value": 5.0}]


def test_counter_reset_detection():
    clock = Clock()
    db = make_db(clock)
    # 0,10,20, restart -> 5,15: growth = 20 + 15 = 35 (post-reset run
    # counts from zero), never negative
    feed_counter(db, clock, "c_total", [0.0, 10.0, 20.0, 5.0, 15.0])
    assert db.query("increase(c_total[60s])")[0]["value"] == 35.0


def test_gauge_over_time_exact():
    clock = Clock()
    db = make_db(clock)
    vals = [1.0, 5.0, 3.0, 7.0]
    for v in vals:
        db.ingest("w0", snap("g", "gauge", [{"tags": {}, "value": v}]),
                  now=clock.t)
        clock.t += 1.0
    clock.t -= 1.0
    assert db.query("avg_over_time(g[60s])")[0]["value"] == \
        sum(vals) / len(vals)
    assert db.query("max_over_time(g[60s])")[0]["value"] == 7.0
    assert db.query("min_over_time(g[60s])")[0]["value"] == 1.0
    # bare selector = latest
    assert db.query("g")[0]["value"] == 7.0
    # empirical quantile: sorted [1,3,5,7], q=0.5 -> pos 1.5 ->
    # 3 + (5-3)*0.5 = 4.0 exactly
    assert db.query("quantile_over_time(0.5, g[60s])")[0]["value"] == 4.0


def test_histogram_quantile_exact_oracle():
    clock = Clock()
    db = make_db(clock)
    bounds = ("0.5", "1.0")
    # cumulative states 2 samples apart; window delta: bucket counts
    # (8, 2, 0) — 8 obs <= 0.5, 2 in (0.5, 1.0]
    db.ingest("w0", snap("lat_seconds", "histogram",
                         [{"tags": {}, "value": hist_value(
                             bounds, [4, 1, 0], 2.0, 5)}]), now=clock.t)
    clock.t += 10.0
    db.ingest("w0", snap("lat_seconds", "histogram",
                         [{"tags": {}, "value": hist_value(
                             bounds, [12, 3, 0], 6.0, 15)}]), now=clock.t)
    # oracle: delta = (8, 2, 0), total 10.  q=0.5 -> target 5.0, first
    # bucket (cum 8 >= 5): 0 + 0.5 * 5/8 = 0.3125 exactly
    got = db.query("quantile_over_time(0.5, lat_seconds[30s])")
    assert got[0]["value"] == 0.3125
    # q=0.9 -> target 9.0, second bucket: 0.5 + 0.5 * (9-8)/2 = 0.75
    assert db.query(
        "quantile_over_time(0.9, lat_seconds[30s])")[0]["value"] == 0.75
    # rate of a histogram = observation-count rate: 10 obs / 10s
    assert db.query("rate(lat_seconds[30s])")[0]["value"] == 1.0


def test_label_matchers():
    clock = Clock()
    db = make_db(clock)
    for state in ("ok", "app_error", "cancelled"):
        db.ingest("w0", snap("t_total", "counter",
                             [{"tags": {"state": state}, "value": 1.0}]),
                  now=clock.t)
    eq = db.query('t_total{state="ok"}')
    assert [r["tags"]["state"] for r in eq] == ["ok"]
    ne = db.query('t_total{state!="ok"}')
    assert sorted(r["tags"]["state"] for r in ne) == \
        ["app_error", "cancelled"]
    rx = db.query('t_total{state=~"(ok|app_.*)"}')
    assert sorted(r["tags"]["state"] for r in rx) == ["app_error", "ok"]
    # worker tag is injected from the KV key
    assert all(r["tags"]["worker"] == "w0" for r in eq)
    # braces inside a quoted =~ value ({n} quantifiers) must not
    # terminate the matcher block
    brace = db.query('t_total{worker=~"w[0-9]{1}"}')
    assert sorted(r["tags"]["state"] for r in brace) == \
        ["app_error", "cancelled", "ok"]
    assert db.query('t_total{worker=~"x{2}"}') == []


def test_sum_by_grouping():
    clock = Clock()
    db = make_db(clock)
    for wk in ("w0", "w1"):
        for rank in ("0", "1"):
            feed_counter(db, Clock(clock.t), "s_total", [0.0, 6.0],
                         tags={"rank": rank}, worker=wk)
    clock.t += 1.0      # the second sample of each series lands at t+1
    got = db.query("sum by (rank) (increase(s_total[30s]))")
    assert got == [{"tags": {"rank": "0"}, "value": 12.0},
                   {"tags": {"rank": "1"}, "value": 12.0}]


def test_query_range_points():
    clock = Clock()
    db = make_db(clock)
    feed_counter(db, clock, "c_total", [5.0 * i for i in range(20)])
    end = clock.t
    rows = db.query_range("rate(c_total[10s])", start=end - 6.0, end=end,
                          step=2.0)
    assert len(rows) == 1
    pts = rows[0]["points"]
    assert len(pts) == 4            # t-6, t-4, t-2, t
    assert all(v == 5.0 for _, v in pts)


def test_bad_expressions_raise():
    db = make_db(Clock())
    for expr in ("rate(x)",             # missing window
                 "x[30s]",              # bare selector with window
                 "quantile_over_time(x[30s])",   # missing q
                 "quantile_over_time(1.5, x[30s])",  # q out of range
                 "rate(x[30q])",        # bad duration unit
                 'x{state~"ok"}',       # bad matcher op
                 'x{state=~"("}'):      # broken =~ regex
        with pytest.raises(QueryError):
            db.query(expr)
    assert parse_duration("90s") == 90.0
    assert parse_duration("5m") == 300.0
    assert parse_duration("250ms") == 0.25
    # range-step DoS guards: zero/negative steps and unbounded step
    # counts are rejected, never looped on (these arrive straight off
    # dashboard URLs onto a GCS handler thread)
    for bad_step in (0.0, -1.0):
        with pytest.raises(QueryError):
            db.query_range("g", start=0.0, end=600.0, step=bad_step)
    with pytest.raises(QueryError):
        db.query_range("g", start=0.0, end=1e9, step=1e-3)


# --------------------------------------------------------- bounds / hygiene
def test_max_series_cap_drops_not_grows():
    clock = Clock()
    db = make_db(clock, max_series=8)
    for i in range(20):
        db.ingest("w0", snap("m", "gauge",
                             [{"tags": {"k": str(i)}, "value": 1.0}]),
                  now=clock.t)
    st = db.stats()
    assert st["series"] == 8
    assert st["dropped_series"] == 12
    # existing series keep updating past the cap
    db.ingest("w0", snap("m", "gauge",
                         [{"tags": {"k": "0"}, "value": 9.0}]),
              now=clock.t)
    assert db.query('m{k="0"}')[0]["value"] == 9.0


def test_idle_series_pruned_after_retention():
    from ray_tpu_torch.util import tsdb as tsdb_mod
    clock = Clock()
    db = make_db(clock)
    db.ingest("dead", snap("m", "gauge", [{"tags": {}, "value": 1.0}]),
              now=clock.t)
    # a fresh series from a live publisher keeps the ingest path ticking
    clock.t += tsdb_mod.IDLE_PRUNE_S + 400.0
    db._last_prune = clock.t - 301.0    # due
    db.ingest("alive", snap("m", "gauge", [{"tags": {}, "value": 2.0}]),
              now=clock.t)
    names = {s["tags"]["worker"] for s in db.list_series("m")}
    assert names == {"alive"}           # dead worker's rings freed


def test_malformed_snapshots_never_raise():
    db = make_db(Clock())
    assert db.ingest("w0", b"not json") == 0
    assert db.ingest("w0", {"no_snapshot": 1}) == 0
    assert db.ingest("w0", snap("m", "histogram",
                                [{"tags": {}, "value": 3.0}])) == 0
    good = db.ingest("w0", snap("m2", "gauge",
                                [{"tags": {}, "value": 3.0}]))
    assert good == 1


# ---------------------------------------------------------------- detectors
def _feed_ranks(db, clock, step_by_rank, steps=8, dt=5.0):
    counts = {r: 0 for r in step_by_rank}
    for _ in range(steps):
        clock.t += dt
        for rank, step_s in step_by_rank.items():
            counts[rank] += 1
            n = counts[rank]
            val = hist_value(("1.0",), [n, 0], step_s * n, n)
            db.ingest(f"wk{rank}",
                      snap("rtt_train_step_seconds", "histogram",
                           [{"tags": {"rank": str(rank)}, "value": val}]),
                      now=clock.t)


def test_straggler_detector_fires_and_cools_down():
    clock = Clock()
    db = make_db(clock)
    _feed_ranks(db, clock, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.4})
    det = StragglerDetector(db, window_s=60.0, ratio=1.75, min_steps=2,
                            min_ranks=3)
    found = det.check()
    assert len(found) == 1
    ev = found[0]
    assert ev["kind"] == "straggler" and ev["rank"] == "3"
    assert ev["worker"] == "wk3"
    assert ev["skew_ratio"] == pytest.approx(4.0)
    assert det.check() == []            # cooldown
    clock.t += det.cooldown_s + 1.0
    _feed_ranks(db, clock, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.4}, steps=3)
    assert len(det.check()) == 1        # still slow after cooldown


def test_straggler_needs_quorum_and_skew():
    clock = Clock()
    db = make_db(clock)
    det = StragglerDetector(db, window_s=60.0, ratio=1.75, min_steps=2,
                            min_ranks=3)
    # two ranks only: no median quorum, no event
    _feed_ranks(db, clock, {0: 0.1, 1: 0.4})
    assert det.check() == []
    # balanced group: no event
    clock2 = Clock(2_000_000.0)
    db2 = make_db(clock2)
    det2 = StragglerDetector(db2, window_s=60.0, ratio=1.75, min_steps=2)
    _feed_ranks(db2, clock2, {0: 0.1, 1: 0.1, 2: 0.1, 3: 0.1})
    assert det2.check() == []


def _feed_latency(db, clock, bad_frac, n_per_sample=10, samples=10,
                  dt=5.0, name="rtt_llm_ttft_seconds"):
    """Cumulative latency histogram where ``bad_frac`` of observations
    exceed the 2.5s rule threshold (bounds 1.0 / 2.5)."""
    good = bad = 0
    for _ in range(samples):
        clock.t += dt
        bad += int(n_per_sample * bad_frac)
        good += n_per_sample - int(n_per_sample * bad_frac)
        n = good + bad
        val = hist_value(("1.0", "2.5"), [good, 0, bad],
                         good * 0.5 + bad * 5.0, n)
        db.ingest("w0", snap(name, "histogram",
                             [{"tags": {"model": "m"}, "value": val}]),
                  now=clock.t)


def test_slo_burn_alerter_multiwindow():
    rules = (dict(name="llm_ttft", series="rtt_llm_ttft_seconds",
                  threshold_s=2.5, objective=0.99,
                  windows=((300.0, 60.0, 10.0),)),)
    clock = Clock()
    db = make_db(clock)
    # 50% of requests over threshold: burn = 0.5 / 0.01 = 50 >> 10 on
    # both windows -> fires once, then cools down for the short window
    _feed_latency(db, clock, bad_frac=0.5)
    al = SloBurnAlerter(db, rules)
    found = al.check()
    assert len(found) == 1
    ev = found[0]
    assert ev["kind"] == "slo_burn" and ev["rule"] == "llm_ttft"
    assert ev["burn_long"] == pytest.approx(50.0)
    assert al.check() == []             # cooldown
    # healthy service: burn 0 -> never fires
    clock2 = Clock(3_000_000.0)
    db2 = make_db(clock2)
    _feed_latency(db2, clock2, bad_frac=0.0)
    assert SloBurnAlerter(db2, rules).check() == []


def test_slo_burn_short_window_gate():
    """Long window still burns from an old incident, short window has
    recovered: multi-window gating keeps the alert quiet."""
    rules = (dict(name="llm_ttft", series="rtt_llm_ttft_seconds",
                  threshold_s=2.5, objective=0.99,
                  windows=((300.0, 30.0, 10.0),)),)
    clock = Clock()
    db = make_db(clock)
    _feed_latency(db, clock, bad_frac=0.5, samples=8)   # incident
    _feed_latency(db, clock, bad_frac=0.0, samples=8)   # recovery
    al = SloBurnAlerter(db, rules)
    assert al.check() == []


def test_catalog_slo_rules_validate():
    """The shipped rule table passes its own rtlint pass (every rule
    names a live cataloged histogram, thresholds inside the ladder)."""
    from ray_tpu_torch.util.metrics_catalog import CATALOG, SLO_RULES
    from tools.rtlint.metricscheck import check_slo_rules
    from pathlib import Path
    findings = check_slo_rules(
        CATALOG, SLO_RULES,
        Path(ray_tpu_torch.__file__).parent / "util" / "metrics_catalog.py")
    assert findings == [], [f.render() for f in findings]
    # and the pass actually bites: a rule over a counter / missing
    # series / out-of-ladder threshold all produce findings
    bad = (dict(name="r1", series="rtt_tasks_total", threshold_s=1.0,
                objective=0.99, windows=((60.0, 10.0, 1.0),)),
           dict(name="r2", series="rtt_nope", threshold_s=1.0,
                objective=0.99, windows=((60.0, 10.0, 1.0),)),
           dict(name="r3", series="rtt_llm_ttft_seconds",
                threshold_s=1e9, objective=0.99,
                windows=((60.0, 10.0, 1.0),)))
    findings = check_slo_rules(
        CATALOG, bad,
        Path(ray_tpu_torch.__file__).parent / "util" / "metrics_catalog.py")
    assert len(findings) == 3


# ------------------------------------------------------------ live RPC path
@pytest.fixture
def port_cluster(monkeypatch):
    """One cluster of the port's own, in a short session root; the
    package logger handed back as it was (``init`` stops its
    propagation)."""
    from rtt_fixtures import session_root
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    with session_root(monkeypatch):
        ray_tpu_torch.init(num_cpus=1)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            for h in log.handlers[:]:
                if h not in handlers:
                    log.removeHandler(h)
                    h.close()
            log.propagate, log.level = propagate, level


def test_metrics_query_rpc_exact_oracle(port_cluster):
    """state.metrics_history() through the real GCS returns EXACTLY what
    the synthetic trace dictates: samples are injected through the same
    ingest entry point the KV receipt path uses, then queried over the
    wire with a pinned evaluation time."""
    from ray_tpu_torch.util import state
    head = ray_tpu_torch._head
    if head._tsdb is None:
        pytest.skip("tsdb disabled in this configuration")
    t0 = time.time() - 100.0
    for i in range(21):
        head._tsdb.ingest(
            "oracle_w", snap("rtt_tasks_total", "counter",
                             [{"tags": {"state": "ok"},
                               "value": 3.0 * i}]), now=t0 + i)
    at = t0 + 20.0
    got = state.metrics_history(
        'rate(rtt_tasks_total{worker="oracle_w"}[20s])', at=at)
    assert got == [{"tags": {"state": "ok", "worker": "oracle_w"},
                    "value": 3.0}]
    got = state.metrics_history(
        'increase(rtt_tasks_total{worker="oracle_w"}[10s])', at=at)
    assert got[0]["value"] == 30.0
    # histogram quantile over the wire, exact (oracle from
    # test_histogram_quantile_exact_oracle's construction)
    head._tsdb.ingest("oracle_w", snap(
        "rtt_llm_ttft_seconds", "histogram",
        [{"tags": {"model": "m"},
          "value": hist_value(("0.5", "1.0"), [4, 1, 0], 2.0, 5)}]),
        now=at - 10.0)
    head._tsdb.ingest("oracle_w", snap(
        "rtt_llm_ttft_seconds", "histogram",
        [{"tags": {"model": "m"},
          "value": hist_value(("0.5", "1.0"), [12, 3, 0], 6.0, 15)}]),
        now=at)
    got = state.metrics_history(
        'quantile_over_time(0.5, rtt_llm_ttft_seconds'
        '{worker="oracle_w"}[30s])', at=at)
    assert got[0]["value"] == 0.3125
    # series listing sees the injected series
    names = {s["name"] for s in state.metrics_series()}
    assert "rtt_tasks_total" in names
