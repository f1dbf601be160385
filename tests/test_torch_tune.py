"""The port's Tune (``ray_tpu_torch.tune``) on its own runtime, held to the
reference's Tune tests (``tests/test_tune.py``, all 13), plus the
session's ``sync_report`` / ``SessionStopped`` that Tune stands on.

Tests share one cluster at ``num_cpus=4`` (``cluster``).  Functions here
are pickled by value, so spawned workers never import this module (nor
JAX through it).  Where the reference's trials race (a straggler started
by a sleep, two PBT trials whose first windows may pass before the other
has a score), these wait on observed state instead: marker files a trial
writes once its report came back (``_touch`` / ``_await``), so every
scheduler decision is the same on every run.  Every assertion of the
reference's tests is kept.
"""

import logging
import os
import sys
import threading

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.train import CheckpointConfig, RunConfig
from ray_tpu_torch.tune import (ASHAScheduler, PopulationBasedTraining,
                                Trainable, TuneConfig, Tuner)

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _stop():
    if rt.is_initialized():
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's cluster and hands later modules the package
    logger as it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    _stop()
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
    if not rt.is_initialized() or "GPU" in rt.cluster_resources():
        _stop()
        rt.init(num_cpus=4)
    yield


def _touch(d, name):
    with open(os.path.join(d, name), "w"):
        pass


def _await(d, names, timeout_s=120.0):
    """Blocks until every marker in ``names`` exists in ``d`` (observed
    state; the timeout only turns a hang into an error)."""
    import time
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(os.path.join(d, n)) for n in names):
        if time.monotonic() > deadline:
            raise TimeoutError(f"markers {names} never all appeared in {d}")
        time.sleep(0.01)


# --------------------------------------------------- tests/test_tune.py
def test_grid_search_runs_all(cluster, tmp_path):
    def f(config):
        tune.report({"score": config["a"] * 10 + config["b"]})

    results = Tuner(
        f,
        param_space={"a": tune.grid_search([1, 2, 3]),
                     "b": tune.grid_search([0, 1])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 6
    best = results.get_best_result("score", "max")
    assert best.metrics["score"] == 31
    assert best.metrics["config"] == {"a": 3, "b": 1}


def test_random_sampling_domains(cluster, tmp_path):
    def f(config):
        assert 0.0 <= config["lr"] <= 1.0
        assert config["wd"] in (0.1, 0.2)
        assert isinstance(config["n"], int)
        tune.report({"ok": 1})

    results = Tuner(
        f,
        param_space={"lr": tune.uniform(0, 1),
                     "wd": tune.choice([0.1, 0.2]),
                     "n": tune.randint(1, 10)},
        tune_config=TuneConfig(num_samples=5, seed=0),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 5
    assert not results.errors


def test_multiple_reports_stream(cluster, tmp_path):
    def f(config):
        for i in range(4):
            tune.report({"loss": 10 - i})

    results = Tuner(
        f, param_space={},
        tune_config=TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert len(results[0].metrics_history) == 4
    assert results[0].metrics["loss"] == 7


def test_trial_error_captured(cluster, tmp_path):
    def f(config):
        if config["x"] == 1:
            raise ValueError("boom")
        tune.report({"ok": 1})

    results = Tuner(
        f, param_space={"x": tune.grid_search([0, 1])},
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert len(results.errors) == 1


def test_asha_unit_decisions():
    """ASHA is asynchronous: a trial reaching a rung late, below the
    top-1/rf of recorded values, is stopped; early arrivals survive."""
    from ray_tpu_torch.tune.trial import Trial

    sched = ASHAScheduler(metric="score", mode="max", max_t=100,
                          grace_period=4, reduction_factor=2)
    good = [Trial(f"good{i}", {}) for i in range(3)]
    bad = Trial("bad", {})
    for i, t in enumerate(good):
        assert sched.on_trial_result(
            None, t, {"training_iteration": 4,
                      "score": 100 + i}) == sched.CONTINUE
    assert sched.on_trial_result(
        None, bad, {"training_iteration": 4, "score": 1}) == sched.STOP
    best = Trial("best", {})
    assert sched.on_trial_result(
        None, best, {"training_iteration": 4, "score": 200}) == sched.CONTINUE
    assert sched.on_trial_result(
        None, best, {"training_iteration": 100, "score": 999}) == sched.STOP


def test_asha_integration_stops_straggler(cluster, tmp_path):
    """Good trials fill the first rung, then a poor trial starts late and
    must be cut before max_t.  The reference starts the straggler 0.5 s
    late; here it starts once the three others' rung-2 reports came back
    (each writes its marker then, stopped or not)."""
    d = str(tmp_path)

    def f(config):
        q = config["q"]
        if q == 0:      # the poor straggler starts after the rung is full
            _await(d, ["r2_1", "r2_2", "r2_3"])
        for i in range(15):
            try:
                tune.report({"score": q * 100 + i})
            finally:
                if i == 1 and q != 0:
                    _touch(d, f"r2_{q}")

    results = Tuner(
        f, param_space={"q": tune.grid_search([3, 2, 1, 0])},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=ASHAScheduler(max_t=15, grace_period=2,
                                    reduction_factor=2)),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    iters = {r.metrics["config"]["q"]: len(r.metrics_history)
             for r in results}
    assert iters[3] == 15       # best runs to completion
    assert iters[0] < 15        # straggler cut at a rung


def test_stop_criteria(cluster, tmp_path):
    def f(config):
        for i in range(100):
            tune.report({"v": i})

    results = tune.run(f, config={}, stop={"training_iteration": 5},
                       storage_path=str(tmp_path))
    assert len(results[0].metrics_history) <= 8  # stop is cooperative


def test_class_trainable_with_checkpointing(cluster, tmp_path):
    class MyTrainable(Trainable):
        def setup(self, config):
            self.base = config.get("base", 0)

        def step(self):
            return {"val": self.base + self.iteration}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "s.txt"), "w") as fh:
                fh.write(str(self.iteration))

        def load_checkpoint(self, d):
            with open(os.path.join(d, "s.txt")) as fh:
                self.iteration = int(fh.read())

    results = tune.run(MyTrainable, config={"base": 100},
                       stop={"training_iteration": 3},
                       storage_path=str(tmp_path))
    r = results[0]
    assert r.error is None
    assert r.metrics["val"] >= 103
    assert r.checkpoint is not None


def _barrier_trainable(d, steps, rates):
    """The PBT tests' trainable: ``score += rate`` a step from the
    checkpoint's score.  After its first report came back (so the
    scheduler holds its score) a trial waits for the other's, so both
    have scores before either reaches its first window; a clone's
    relaunch finds both markers and goes straight on."""
    def f(config):
        start = 0
        ck = tune.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["score"]
        score = start
        for i in range(steps):
            score += config["rate"]
            tune.report({"score": score},
                        checkpoint=tune.Checkpoint.from_dict(
                            {"score": score}))
            if i == 0:
                _touch(d, f"first_{config['rate']}")
                _await(d, [f"first_{r}" for r in rates])

    return f


def test_pbt_clones_from_better_trial(cluster, tmp_path):
    # two trials: "slow" (rate 1) and "fast" (rate 10); PBT should stop the
    # slow one at the perturbation interval and clone from the fast one
    d = str(tmp_path / "barrier")
    os.makedirs(d)
    f = _barrier_trainable(d, 12, [1, 10])

    results = Tuner(
        f, param_space={"rate": tune.grid_search([1, 10])},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=PopulationBasedTraining(
                perturbation_interval=4,
                hyperparam_mutations={"rate": [1, 10]}, seed=0)),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    best = results.get_best_result("score", "max")
    assert best.metrics["score"] >= 100
    # the cloned trial must have benefited from the donor's checkpoint
    worst = min(r.metrics["score"] for r in results)
    assert worst > 12  # pure rate-1 for 12 steps would be exactly 12


def test_tuner_restore(cluster, tmp_path):
    def f(config):
        tune.report({"m": config["x"]})

    Tuner(
        f, param_space={"x": tune.grid_search([5, 7])},
        run_config=RunConfig(storage_path=str(tmp_path), name="exp1"),
    ).fit()
    restored = Tuner.restore(str(tmp_path / "exp1"))
    grid = restored.get_results()
    assert sorted(r.metrics["m"] for r in grid) == [5, 7]


def test_tuner_wraps_trainer(cluster, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    def loop(config):
        train.report({"loss": 1.0 / config["lr"]})

    trainer = DataParallelTrainer(
        loop, train_loop_config={"lr": 1.0},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path)))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([1.0, 2.0])}},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert results.get_best_result("loss", "min").metrics["loss"] == 0.5


def test_pb2_bandit_explore_clones_and_improves(cluster, tmp_path):
    """PB2: the bottom trial exploits the donor's checkpoint and the
    GP-UCB bandit proposes the new hyperparameter INSIDE the declared
    bounds; with enough windows the bandit's dataset is populated and the
    population improves over its worst member."""
    from ray_tpu_torch.tune import PB2

    d = str(tmp_path / "barrier")
    os.makedirs(d)
    f = _barrier_trainable(d, 12, [1.0, 9.0])

    sched = PB2(perturbation_interval=3,
                hyperparam_bounds={"rate": [0.5, 10.0]}, seed=0)
    results = Tuner(
        f, param_space={"rate": tune.grid_search([1.0, 9.0])},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=2, scheduler=sched),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    best = results.get_best_result("score", "max")
    assert best.metrics["score"] >= 9 * 12 * 0.8
    # the clone escaped the pure rate-1 trajectory
    assert min(r.metrics["score"] for r in results) > 12
    # bandit recorded reward windows and every proposal stayed in bounds
    assert len(sched._data_y) >= 2
    for r in results:
        assert 0.5 <= r.metrics["config"]["rate"] <= 10.0


def test_pb2_requires_bounds():
    from ray_tpu_torch.tune import PB2
    with pytest.raises(ValueError):
        PB2(hyperparam_bounds=None)


# ------------------------------------------ the session Tune stands on
class _FakeKV:
    """The internal KV's three calls on a dict, counting each."""

    def __init__(self):
        self.data, self.calls = {}, []
        self.cv = threading.Condition()

    def put(self, key, value, overwrite=True, namespace="default"):
        with self.cv:
            self.calls.append(("put", key))
            self.data[(namespace, key)] = value
            self.cv.notify_all()

    def get(self, key, namespace="default"):
        with self.cv:
            self.calls.append(("get", key))
            return self.data.get((namespace, key))

    def delete(self, key, namespace="default"):
        with self.cv:
            self.calls.append(("del", key))
            return self.data.pop((namespace, key), None) is not None


def _session(monkeypatch, tmp_path, **kw):
    from ray_tpu_torch.experimental import internal_kv
    from ray_tpu_torch.train._internal import session as sess
    kv = _FakeKV()
    monkeypatch.setattr(internal_kv, "_internal_kv_put", kv.put)
    monkeypatch.setattr(internal_kv, "_internal_kv_get", kv.get)
    return kv, sess._TrainSession(
        run_id="run", run_name="run", rank=0, world_size=1,
        storage_dir=str(tmp_path), restore_checkpoint=None, **kw)


def test_plain_train_report_makes_one_kv_call(monkeypatch, tmp_path):
    """Without ``sync_report`` (every Train run) a report is one put and
    nothing else: no wait, no read of the stop flag."""
    kv, s = _session(monkeypatch, tmp_path)
    assert s.sync_report is False
    s.report({"loss": 1.0})
    s.report({"loss": 0.5})
    assert kv.calls == [("put", "run/r/1/0"), ("put", "run/r/2/0")]


def test_sync_report_blocks_until_consumed_then_honors_stop(monkeypatch,
                                                            tmp_path):
    """With ``sync_report`` a report returns only once the controller
    deleted its key, and raises ``SessionStopped`` when the stop flag was
    set before that deletion (the controller's order)."""
    from ray_tpu_torch.train._internal.session import (NAMESPACE,
                                                       SessionStopped)
    kv, s = _session(monkeypatch, tmp_path, sync_report=True)
    returned = []

    def reporter():
        try:
            s.report({"loss": 1.0})
            returned.append("ok")
            s.report({"loss": 0.5})
            returned.append("ok")
        except SessionStopped as e:
            returned.append(("stopped", str(e)))

    t = threading.Thread(target=reporter, name="reporter", daemon=True)
    t.start()
    with kv.cv:
        kv.cv.wait_for(lambda: (NAMESPACE, "run/r/1/0") in kv.data, 30)
    assert returned == []                       # blocked on its key
    kv.delete("run/r/1/0", namespace=NAMESPACE)  # consumed: CONTINUE
    with kv.cv:
        kv.cv.wait_for(lambda: (NAMESPACE, "run/r/2/0") in kv.data, 30)
    assert returned == ["ok"]
    kv.put("run/ctl/stop", b"1", namespace=NAMESPACE)   # STOP, then consume
    kv.delete("run/r/2/0", namespace=NAMESPACE)
    t.join(30)
    assert returned == ["ok", ("stopped", "run")]
    assert ("get", "run/ctl/stop") in kv.calls


@pytest.mark.parametrize("make", [
    lambda: RunConfig(verbose=2),
    lambda: CheckpointConfig(checkpoint_score_attribute="loss"),
    lambda: CheckpointConfig(checkpoint_score_order="min"),
], ids=["verbose", "score_attribute", "score_order"])
def test_unread_config_fields_raise_unless_default(make):
    # the reference's signature, but nothing reads these: a value other
    # than the default must raise, never be silently ignored
    with pytest.raises(NotImplementedError, match="not implemented"):
        make()
    assert RunConfig(stop={"training_iteration": 2}).stop == {
        "training_iteration": 2}
    assert CheckpointConfig(checkpoint_frequency=3).checkpoint_frequency == 3
