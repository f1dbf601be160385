"""The port's searchers and HyperBand, held to the reference's tests:
``tests/test_tune_bohb.py`` (all 4: BOHB and the Optuna / HyperOpt
adapters' importability gate) and the five Tune cases of
``tests/test_tune_search_rllib2.py`` (TPE and HyperBand; its RLlib cases
are mirrored in ``tests/test_torch_rllib_remote.py``).  The Tuner cases
run on one shared port cluster at ``num_cpus=4``; functions are pickled
by value, so spawned workers never import this module.
"""

import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train, tune
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.tune.schedulers import HyperBandScheduler
from ray_tpu_torch.tune.search import (
    BOHBSearcher, HyperBandForBOHB, HyperOptSearch, OptunaSearch,
    TPESearcher, uniform,
)

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
    if not rt.is_initialized() or "GPU" in rt.cluster_resources():
        if rt.is_initialized():
            rt.shutdown()
        rt.init(num_cpus=4)
    yield


# ------------------------------------------------------------------- BOHB

def test_bohb_learns_from_rung_results():
    """The model must form from INTERMEDIATE results: every trial
    reports at budget 1 but only a few ever reach budget 9 — plain
    final-only TPE would sit in its random phase far longer."""
    s = BOHBSearcher(metric="loss", mode="min", n_initial_points=6, seed=0)
    s.set_search_properties("loss", "min", {"x": uniform(0.0, 1.0)})
    xs = []
    for i in range(50):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        xs.append(cfg["x"])
        loss = (cfg["x"] - 0.3) ** 2
        s.on_trial_result(tid, {"training_iteration": 1,
                                "loss": loss + 0.05})
        if i % 5 == 0:  # only some trials reach the high rung
            s.on_trial_result(tid, {"training_iteration": 9, "loss": loss})
        s.on_trial_complete(tid, None)   # no final metric at all
    late = np.asarray(xs[30:])
    assert abs(late.mean() - 0.3) < 0.15, late.mean()
    assert late.std() < np.asarray(xs[:6]).std()


def test_bohb_prefers_largest_rich_budget():
    s = BOHBSearcher(metric="m", mode="max", n_initial_points=3, seed=1)
    s.set_search_properties("m", "max", {"x": uniform(0.0, 1.0)})
    # budget 1: many obs pointing AT 0.9; budget 5: enough obs pointing
    # at 0.1 -> the model must use budget 5
    for i in range(12):
        tid = f"a{i}"
        s._pending[tid] = {"x": 0.9}
        s.on_trial_result(tid, {"training_iteration": 1, "m": 1.0})
    for i in range(6):
        tid = f"b{i}"
        s._pending[tid] = {"x": 0.1 + 0.01 * i}
        s.on_trial_result(tid, {"training_iteration": 5,
                                "m": 1.0 - 0.01 * i})
    obs = s._model_observations()
    assert len(obs) == 6
    assert all(c["x"] < 0.2 for c, _ in obs)


def test_bohb_with_tuner_and_hyperband(cluster, tmp_path):
    """End-to-end: BOHB proposes, HyperBandForBOHB prunes; rung results
    reach the searcher through the controller's on_trial_result hook."""
    def trainable(config):
        for i in range(8):
            tune.report({"loss": (config["x"] - 0.5) ** 2 + 0.1 / (i + 1)})

    searcher = BOHBSearcher(n_initial_points=4, seed=0)
    tuner = tune.Tuner(
        trainable,
        param_space={"x": uniform(0, 1)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=10,
            max_concurrent_trials=2, search_alg=searcher,
            scheduler=HyperBandForBOHB(max_t=8, reduction_factor=2)),
        run_config=train.RunConfig(storage_path=str(tmp_path)))
    grid = tuner.fit()
    best = grid.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 0.2
    # the searcher actually saw intermediate budgets
    assert any(b > 0 for b in searcher._by_budget)


# ---------------------------------------------------------------- adapters

def test_adapters_gate_on_importability():
    """Neither optuna nor hyperopt is on the card's machine (nor here):
    the adapters must raise an actionable ImportError naming the native
    equivalent (NOT silently degrade)."""
    for cls, lib in ((OptunaSearch, "optuna"), (HyperOptSearch, "hyperopt")):
        try:
            __import__(lib)
            pytest.skip(f"{lib} unexpectedly present")
        except ImportError:
            pass
        with pytest.raises(ImportError) as ei:
            cls(metric="loss", mode="min")
        assert lib in str(ei.value)
        assert "TPESearcher" in str(ei.value)


# -------------------------------------------------------------------- TPE

def test_tpe_outperforms_random_on_quadratic():
    """On min (x-0.7)^2, TPE's later proposals concentrate near 0.7."""
    searcher = TPESearcher(metric="loss", mode="min", n_initial_points=8,
                          seed=0)
    searcher.set_search_properties("loss", "min", {"x": uniform(0.0, 1.0)})
    xs = []
    for i in range(60):
        cfg = searcher.suggest(f"t{i}")
        xs.append(cfg["x"])
        searcher.on_trial_complete(f"t{i}", {"loss": (cfg["x"] - 0.7) ** 2})
    late = np.asarray(xs[40:])
    assert abs(late.mean() - 0.7) < 0.15, late.mean()
    # adaptive phase concentrates relative to the uniform phase
    assert late.std() < np.asarray(xs[:8]).std()


def test_tpe_categorical_and_log():
    from ray_tpu_torch.tune.search import choice, loguniform
    searcher = TPESearcher(metric="score", mode="max", n_initial_points=6,
                          seed=1)
    searcher.set_search_properties("score", "max", {
        "algo": choice(["good", "bad"]),
        "lr": loguniform(1e-5, 1e-1),
    })
    picks = []
    for i in range(50):
        cfg = searcher.suggest(f"t{i}")
        picks.append(cfg["algo"])
        score = (1.0 if cfg["algo"] == "good" else 0.0) - \
            abs(np.log10(cfg["lr"]) + 3)
        searcher.on_trial_complete(f"t{i}", {"score": score})
    assert picks[20:].count("good") > picks[20:].count("bad")


def test_tpe_with_tuner(cluster, tmp_path):
    def objective(config):
        tune.report({"loss": (config["x"] - 0.5) ** 2})

    tuner = tune.Tuner(
        objective,
        param_space={"x": uniform(0, 1)},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=12, max_concurrent_trials=2,
                                    search_alg=TPESearcher(n_initial_points=4,
                                                           seed=0)),
        run_config=train.RunConfig(storage_path=str(tmp_path)))
    grid = tuner.fit()
    best = grid.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 0.1


# -------------------------------------------------------------- HyperBand

def test_hyperband_stops_bad_trials(cluster, tmp_path):
    def trainable(config):
        for i in range(20):
            tune.report({"score": config["quality"] * (i + 1)})

    tuner = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([0.1, 0.2, 1.0, 2.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=HyperBandScheduler(max_t=16, reduction_factor=2)),
        run_config=train.RunConfig(storage_path=str(tmp_path)))
    grid = tuner.fit()
    results = {r.metrics["config"]["quality"]:
               r.metrics.get("training_iteration", 0) for r in grid}
    # the best trial runs longest; the worst is culled earlier
    assert results[2.0] >= results[0.1]
    best = grid.get_best_result(metric="score", mode="max")
    assert best.metrics["config"]["quality"] == 2.0


def test_hyperband_brackets_structure():
    hb = HyperBandScheduler(max_t=81, reduction_factor=3)
    assert len(hb.brackets) == 5  # s = 4..0
    # most aggressive bracket halves from r0=1; the laziest (s=0) runs the
    # full budget with no halving (classic HyperBand's random-search arm)
    assert hb.brackets[0].milestones == [1, 3, 9, 27]
    assert hb.brackets[-2].milestones == [27]
    assert hb.brackets[-1].milestones == []
