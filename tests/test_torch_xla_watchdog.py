"""RTT_XLA_WATCHDOG — the port's step-hygiene oracle
(``ray_tpu_torch/_private/xla_watchdog.py``), mirroring the reference's
``tests/test_xla_watchdog.py`` case by case in eager PyTorch.

A host read inside a step region (``.item()``, ``.cpu()``,
``np.asarray``: the counterparts of ``jax.device_get`` and the array's
``_value``) raises with the tensor's shape and the reading stack; a new
input signature past the declared budget is the counterpart of a
steady-state recompile.  Live layer: the port's train step and LLM
runner complete under the armed oracle with zero violations, and an
injected read or signature churn raises naming the site.  Chaos: a
SIGKILLed worker mid-workload recovers with zero violations.  The AST
check pins every ``compile_budget("<site>")`` call of the port to one
row of ``COMPILE_BUDGETS`` and each row to a call.
"""

import ast
import dataclasses
import os
import signal
import sys
import threading
import types
from pathlib import Path

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu_torch._private import lock_watchdog as lw
from ray_tpu_torch._private import xla_watchdog as xw

cloudpickle.register_pickle_by_value(sys.modules[__name__])

PORT = Path(__file__).resolve().parents[1] / "ray_tpu_torch"


@pytest.fixture(autouse=True)
def _clean_stats():
    xw.reset_xla_stats()
    yield
    xw.reset_xla_stats()


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("RTT_XLA_WATCHDOG", "1")
    monkeypatch.delenv("RTT_XLA_WATCHDOG_WARMUP", raising=False)


def _times_two(budget, x):
    """An eager 'program': its signature charged at the region, as the
    runner and the train step charge theirs."""
    budget.see(xw.signature([x]))
    return x * 2


# ------------------------------------------------------------ unit layer
def test_disabled_is_a_noop(monkeypatch):
    monkeypatch.delenv("RTT_XLA_WATCHDOG", raising=False)
    x = torch.ones((2, 2))
    with xw.compile_budget("not.even.declared"):
        # host reads and fresh signatures are all legal when disarmed
        assert float(np.asarray(x).sum()) == 4.0
        assert x.sum().item() == 4.0
    assert xw.xla_stats() == {}


def test_undeclared_site_raises(armed):
    with pytest.raises(xw.XlaHygieneViolation, match="not declared"):
        with xw.compile_budget("no.such.site"):
            pass


def test_transfer_violation_has_shape_and_stack(armed):
    x = torch.ones((2, 3), dtype=torch.float32)
    with pytest.raises(xw.XlaHygieneViolation) as ei:
        with xw.compile_budget("train.step"):
            np.asarray(x)          # a host pull of the tensor
    msg = str(ei.value)
    assert "train.step" in msg
    assert "(2, 3)" in msg                       # the tensor's shape
    assert "torch.float32" in msg
    assert "Transfer point" in msg               # the reading stack...
    assert "test_torch_xla_watchdog" in msg      # ...pointing here
    assert xw.xla_stats()["train.step"][1] == 1


@pytest.mark.parametrize("read", ["item", "cpu", "tolist", "float"])
def test_device_get_inside_region_raises(armed, read):
    """The counterpart of ``jax.device_get``: each host read raises in a
    region, and the same read outside any region is a designed sync."""
    x = torch.ones((4,))
    do = {"item": lambda: x[0].item(), "cpu": lambda: x.cpu(),
          "tolist": lambda: x.tolist(), "float": lambda: float(x[0])}[read]
    with pytest.raises(xw.XlaHygieneViolation, match=read):
        with xw.compile_budget("train.step"):
            do()
    assert x.cpu().shape == (4,)
    assert do() is not None


def test_warmup_then_steady_state_recompile_raises(armed, monkeypatch):
    """Signatures inside the declared budget + warmup pass; the next
    distinct one after steady state raises with the site named."""
    monkeypatch.setenv("RTT_XLA_WATCHDOG_WARMUP", "2")
    xs = [torch.ones((i + 1,)) for i in range(4)]  # built outside
    budget = xw.compile_budget("train.step", budget=1)
    for i in range(3):                 # 3 distinct signatures <= 1 + 2
        with budget:
            _times_two(budget, xs[i])
    with budget:                       # a signature seen: no charge
        _times_two(budget, xs[0])
    assert xw.xla_stats()["train.step"][0] == 3
    monkeypatch.setenv("RTT_XLA_WATCHDOG_WARMUP", "0")
    with pytest.raises(xw.XlaHygieneViolation) as ei:
        with budget:
            _times_two(budget, xs[3])  # 4th: steady-state churn
    assert "train.step" in str(ei.value)
    assert "retrace" in str(ei.value)  # actionable: names the cause


def test_overrun_folds_into_profiler_namespace(armed):
    from ray_tpu_torch.util import profiler
    x = torch.ones((7,))
    budget = xw.compile_budget("train.step", budget=0)
    with pytest.raises(xw.XlaHygieneViolation):
        with budget:
            _times_two(budget, x)   # signature 1 > budget 0: in flight
            assert profiler._WAITING[threading.get_ident()] == \
                "recompile:train.step"
    # the synthetic frame clears with the region
    assert threading.get_ident() not in profiler._WAITING


def test_real_failure_is_not_masked_by_overrun(armed):
    budget = xw.compile_budget("train.step", budget=0)
    with pytest.raises(ValueError, match="the real failure"):
        with budget:
            _times_two(budget, torch.ones((9,)))
            raise ValueError("the real failure")


def _budget_call_sites():
    """Every ``compile_budget("<site>", ...)`` call in the port: its
    site literal, file and line (a call without a literal is a
    finding)."""
    sites, bad = [], []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else \
                f.attr if isinstance(f, ast.Attribute) else None
            if name != "compile_budget":
                continue
            where = f"{path.relative_to(PORT.parent)}:{node.lineno}"
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites.append((node.args[0].value, where))
            else:
                bad.append(where)
    return sites, bad


def test_budget_tables_match_static_config():
    """Static == runtime identity: every ``compile_budget("<site>")``
    call of the port names a row of ``COMPILE_BUDGETS`` and every row
    has exactly one call (the counterpart of jaxlint's
    compile-budget-undeclared / compile-budget-dead pair)."""
    sites, bad = _budget_call_sites()
    assert bad == [], f"compile_budget calls without a literal site: {bad}"
    names = [s for s, _ in sites]
    assert sorted(names) == sorted(set(names)), sites     # one call a row
    assert set(names) == set(lw.COMPILE_BUDGETS), sites
    wheres = {s: w.split(":")[0] for s, w in sites}
    assert wheres == {
        "train.step": "ray_tpu_torch/parallel/spmd.py",
        "llm.prefill": "ray_tpu_torch/serve/llm/model_runner.py",
        "llm.decode": "ray_tpu_torch/serve/llm/model_runner.py"}
    # the step paths the regions wrap exist under their declared names
    assert "spmd:build_train_program._step" in lw.STEP_PATHS
    src = (PORT / "parallel" / "spmd.py").read_text()
    assert "def _step(" in src


# ------------------------------------------------------------ live train
def _tiny_train_program(loss_fn=None):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import spmd
    cfg = dataclasses.replace(gpt2.tiny(), dtype=torch.float32)
    prog = spmd.build_train_program(
        loss_fn=loss_fn or (lambda p, b: gpt2.loss_fn(p, b, cfg)),
        init_params_fn=lambda g: gpt2.init_params(g, cfg, device="cpu"),
        optimizer=spmd.default_optimizer(lr=1e-2, warmup=1,
                                         total_steps=50), device="cpu")
    state = prog.init_fn(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
    return prog, state, batch, cfg


def test_live_train_step_zero_violations(armed):
    """The port's train step under the armed oracle: N steady-state
    steps, ONE signature, zero host reads; the caller's read of the
    metrics stays outside the region and legal."""
    prog, state, batch, _cfg = _tiny_train_program()
    for _ in range(3):
        state, m = prog.step_fn(state, batch)
    assert m["loss"].item() > 0                    # designed sync: legal
    compiles, transfers = xw.xla_stats()["train.step"]
    assert compiles == 1, xw.xla_stats()
    assert transfers == 0


def test_live_train_injected_recompile_raises(armed):
    """Shape churn on the step input — the retrace bug class — raises at
    the region with the site named."""
    from ray_tpu_torch.parallel import spmd
    prog, state, batch, _cfg = _tiny_train_program()
    state, _ = prog.step_fn(state, batch)          # the one signature
    toks = np.random.default_rng(1).integers(0, 64, (8, 17)).astype(
        np.int32)
    churned = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                      "targets": toks[:, 1:]})
    with pytest.raises(xw.XlaHygieneViolation, match="train.step"):
        prog.step_fn(state, churned)               # signature #2


def test_live_train_injected_device_get_raises(armed):
    """A host read inside the step (the hidden-sync bug class) raises
    with the site and the reading stack."""
    from ray_tpu_torch.models import gpt2
    cfg = dataclasses.replace(gpt2.tiny(), dtype=torch.float32)

    def bad_loss(p, b):
        b["inputs"].cpu()              # a host read in the step
        return gpt2.loss_fn(p, b, cfg)

    prog, state, batch, _cfg = _tiny_train_program(loss_fn=bad_loss)
    with pytest.raises(xw.XlaHygieneViolation, match="train.step") as ei:
        prog.step_fn(state, batch)
    assert "Tensor.cpu" in str(ei.value)


# ----------------------------------------------------------- live engine
def _engine_cfg(**kw):
    from ray_tpu_torch.serve.llm import EngineConfig
    base = dict(model="gpt2:tiny", num_blocks=64, block_size=8,
                max_num_seqs=4, max_model_len=64, max_prefill_tokens=32,
                prefill_len_buckets=(16, 32, 64),
                decode_batch_buckets=(1, 2, 4),
                share_weights=False)
    base.update(kw)
    return EngineConfig(**base)


def test_live_engine_zero_violations(armed):
    """The port's LLM engine under the armed oracle: a request storm
    completes with signatures bounded by the bucket space and zero host
    reads in the regions (the runner's logits pulls are outside them
    by construction)."""
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    eng = LLMEngine(_engine_cfg(), device="cpu")
    try:
        rng = np.random.default_rng(3)
        streams = [eng.submit(
            rng.integers(1, 100, size=int(rng.integers(3, 12))).tolist(),
            SamplingParams(max_tokens=4)) for _ in range(4)]
        assert all(len(s.tokens()) == 4 for s in streams)
    finally:
        eng.shutdown()
    stats = xw.xla_stats()
    pf_compiles, pf_transfers = stats["llm.prefill"]
    dc_compiles, dc_transfers = stats["llm.decode"]
    assert pf_compiles == 1 and pf_transfers == 0, stats
    assert 1 <= dc_compiles <= 3 and dc_transfers == 0, stats


def test_engine_injected_recompile_raises(armed, monkeypatch):
    """Bypassing the length bucketing makes every prompt length a
    distinct signature: the prefill budget trips instead of growing
    forever."""
    from ray_tpu_torch.serve.llm import model_runner as mr
    monkeypatch.setattr(mr, "_bucket", lambda n, buckets: n)
    runner = mr.ModelRunner(_engine_cfg(), device="cpu")
    with pytest.raises(xw.XlaHygieneViolation) as ei:
        for n in (3, 5, 7, 9):     # budget = len(buckets) = 3
            runner.prefill(list(range(1, n + 1)))
    assert "llm.prefill" in str(ei.value)
    assert "COMPILE_BUDGETS" in str(ei.value)


def test_engine_injected_device_get_raises(armed):
    from ray_tpu_torch.serve.llm import model_runner as mr
    runner = mr.ModelRunner(_engine_cfg(), device="cpu")
    orig = runner.mod.forward_prefill

    def synced(*a, **kw):
        out = orig(*a, **kw)
        out[0].cpu()                   # a host read in the forward
        return out

    runner.mod = types.SimpleNamespace(forward_prefill=synced)
    with pytest.raises(xw.XlaHygieneViolation, match="llm.prefill") as ei:
        runner.prefill([1, 2, 3])
    assert "Tensor.cpu" in str(ei.value)


# ----------------------------------------------------------------- chaos
def _watched_work(i):
    """One task of the chaos workload: arms the oracle in its worker,
    runs three steps of an eager 'program' in a region and reads the
    result outside it."""
    os.environ["RTT_XLA_WATCHDOG"] = "1"
    import torch as t

    from ray_tpu_torch._private import xla_watchdog as wxw

    # stats are process-global and a worker serves many tasks — scope
    # them to this task
    wxw.reset_xla_stats()
    x = t.tensor(float(i))           # built OUTSIDE the region
    budget = wxw.compile_budget("train.step", budget=1)
    out = 0.0
    for _ in range(3):
        with budget:
            budget.see(wxw.signature([x]))
            y = x * 2.0
        out = y.item()               # read OUTSIDE the region
    compiles, transfers = wxw.xla_stats()["train.step"]
    if compiles > 1 or transfers:
        raise AssertionError(wxw.xla_stats())
    return out


def test_chaos_workload_under_xla_watchdog(monkeypatch, tmp_path):
    """Worker SIGKILL mid-workload with the oracle armed in every
    worker: retried tasks re-enter their regions on fresh processes and
    the workload completes with zero violations (a violation would fail
    the task past its retries)."""
    import logging

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import rtlog, shm_store
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    monkeypatch.setenv("RTT_XLA_WATCHDOG", "1")
    monkeypatch.setattr(shm_store, "_SHM_DIR", tmp_path)
    monkeypatch.setenv("RTT_SHM_DIR", str(tmp_path))
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2)
    try:
        work = rt.remote(max_retries=-1)(_watched_work)
        assert rt.get([work.remote(i) for i in range(6)],
                      timeout=180) == [i * 2.0 for i in range(6)]
        victims = [w.pid for w in list(rt._head.workers.values())
                   if w.pid and w.pid != os.getpid()]
        assert victims, "no worker to kill"
        os.kill(victims[0], signal.SIGKILL)
        assert rt.get([work.remote(i) for i in range(6)],
                      timeout=180) == [i * 2.0 for i in range(6)]
    finally:
        rt.shutdown()
        # init stops the package logger's propagation: hand later
        # modules the logger as it was
        for h in log.handlers[:]:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        log.propagate, log.level = propagate, level
        rtlog._stream_configured = False
        rtlog._file_handlers.clear()
