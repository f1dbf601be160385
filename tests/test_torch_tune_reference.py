"""The port's Tune held to the JAX package's, on the same inputs.

In one process without a runtime: the seeded variant generator, every
search-space domain's draws, the schedulers (ASHA, HyperBand, the median
stopping rule, PBT with its mutations and clones, PB2's bandit) driven by
one scripted stream of trial results through a small fake controller,
and the searchers (TPE, BOHB) fed one scripted objective.  Both packages
run the same float64 numpy and ``random`` on the same seeds, so
decisions, rungs, suggested and mutated configs must be **equal**, not
close.

On the port's runtime: one tiny GPT-2 trial through
``Tuner(TorchTrainer)`` against the JAX package's ``build_train_program``
on the same config and weights (carried by ``params_from_numpy``), its
losses within 1e-4 relative (``tests/test_torch_train_parity.py``'s
limit: float32 on both sides, sums in other orders).  The loop is pickled
by value, so the spawned workers import neither this module nor JAX.
"""

import dataclasses
import logging
import os
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train as ttrain
from ray_tpu_torch import tune as ttune
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune.trial import Trial as TTrial

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu.tune.trial import Trial as JTrial

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

# the two packages side by side: (search, schedulers, Trial)
SIDES = {"jax": (jsearch, jsched, JTrial),
         "port": (tsearch, tsched, TTrial)}


def _space(search):
    """A space of every domain, two grids and constants, nested."""
    return {
        "lr": search.loguniform(1e-5, 1e-1),
        "wd": search.uniform(0.0, 0.3),
        "q": search.quniform(0.0, 1.0, 0.125),
        "n": search.randint(1, 100),
        "qn": search.qrandint(0, 64, 8),
        "act": search.choice(["relu", "gelu", "tanh"]),
        "noise": search.randn(1.0, 0.5),
        "fixed": search.sample_from(lambda spec: 7),
        "arch": {"layers": search.grid_search([2, 4]),
                 "width": search.grid_search([64, 128, 256]),
                 "dropout": search.uniform(0.0, 0.5)},
        "const": "x",
    }


def test_variant_generator_and_domains_equal():
    got = {}
    for side, (search, _, _) in SIDES.items():
        gen = search.BasicVariantGenerator(seed=123)
        configs = gen.generate(_space(search), num_samples=3)
        rng = np.random.default_rng(7)
        draws = {k: [d.sample(rng) for _ in range(50)]
                 for k, d in sorted(_space(search).items())
                 if isinstance(d, search.Domain)}
        got[side] = (configs, draws)
    assert len(got["port"][0]) == 3 * 2 * 3
    assert got["port"] == got["jax"]
    # the seed is the whole of the draw: another seed, other configs
    other = tsearch.BasicVariantGenerator(seed=124).generate(
        _space(tsearch), num_samples=3)
    assert other != got["port"][0]


class _FakeController:
    """What a scheduler asks of the controller: ``trials``,
    ``get_trial`` and ``request_clone`` (recorded, then relaunched as
    the controller does once the stopped trial ends)."""

    def __init__(self, trial_cls, configs):
        self.trials = [trial_cls(f"t{i}", dict(c))
                       for i, c in enumerate(configs)]
        self.clones = []

    def get_trial(self, trial_id):
        return next((t for t in self.trials if t.id == trial_id), None)

    def request_clone(self, trial, config, ckpt):
        self.clones.append((trial.id, dict(config), ckpt))
        trial.prepare_clone(config, ckpt)


def _stream(n_trials, n_iters, seed):
    """One scripted stream: trials interleaved in a seeded order, each
    reporting iterations 1.. in turn, a metric that trends with the
    trial's own rate plus noise."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.1, 2.0, n_trials)
    left = [list(range(1, n_iters + 1)) for _ in range(n_trials)]
    events = []
    while any(left):
        i = int(rng.choice([k for k in range(n_trials) if left[k]]))
        it = left[i].pop(0)
        events.append((i, it, float(rates[i] * it + rng.normal(0, 0.5))))
    return events


def _drive(sched, ctl, events, metric="score"):
    """Feeds ``events`` as the controller would: a stopped trial reports
    nothing more until a pending clone relaunches it (at once here)."""
    log = []
    stopped = set()
    for i, it, val in events:
        trial = ctl.trials[i]
        if trial.id in stopped:
            continue
        d = sched.on_trial_result(ctl, trial, {"training_iteration": it,
                                               metric: val})
        log.append((trial.id, it, d, sorted(trial.rungs_hit)))
        if d == sched.STOP:
            if trial.pending_clone is not None:
                trial.relaunch_as_clone()
                trial.latest_checkpoint_path = f"/ckpt/{trial.id}/{it}"
            else:
                stopped.add(trial.id)
        else:
            trial.latest_checkpoint_path = f"/ckpt/{trial.id}/{it}"
    return log


SCHEDULERS = {
    "asha": lambda s: s.ASHAScheduler(metric="score", mode="max", max_t=27,
                                      grace_period=1, reduction_factor=3),
    "asha_min": lambda s: s.ASHAScheduler(metric="score", mode="min",
                                          max_t=8, grace_period=1,
                                          reduction_factor=2),
    "hyperband": lambda s: s.HyperBandScheduler(metric="score", mode="max",
                                                max_t=27,
                                                reduction_factor=3),
    "median": lambda s: s.MedianStoppingRule(metric="score", mode="max",
                                             grace_period=2,
                                             min_samples_required=3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_stopping_schedulers_equal(name):
    events = _stream(9, 27, seed=3)
    logs = {}
    for side, (_, sched_mod, trial_cls) in SIDES.items():
        sched = SCHEDULERS[name](sched_mod)
        logs[side] = _drive(sched, _FakeController(trial_cls, [{}] * 9),
                            events)
    assert logs["port"] == logs["jax"]
    decisions = [d for _, _, d, _ in logs["port"]]
    assert "STOP" in decisions and "CONTINUE" in decisions


def _pbt(sched_mod, search):
    return sched_mod.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": search.loguniform(1e-4, 1e-1),
                              "bs": [16, 32, 64], "mom": [0.8, 0.9, 0.99],
                              "k": lambda: 5},
        quantile_fraction=0.25, resample_probability=0.4, seed=11)


def test_pbt_mutations_and_clones_equal():
    configs = [{"lr": 1e-3 * (i + 1), "bs": 32, "mom": 0.9, "k": i,
                "tag": f"c{i}"} for i in range(8)]
    events = _stream(8, 15, seed=5)
    out = {}
    for side, (search, sched_mod, trial_cls) in SIDES.items():
        sched = _pbt(sched_mod, search)
        ctl = _FakeController(trial_cls, configs)
        log = _drive(sched, ctl, events)
        mutated = [_pbt(sched_mod, search)._mutate(c) for c in configs]
        out[side] = (log, ctl.clones, [t.config for t in ctl.trials],
                     mutated, sched._last_perturb)
    assert out["port"] == out["jax"]
    assert out["port"][1], "the stream made no clone"


def test_pb2_bandit_equal():
    configs = [{"rate": 0.5 + i, "k": i} for i in range(6)]
    events = _stream(6, 18, seed=9)
    out = {}
    for side, (_, sched_mod, trial_cls) in SIDES.items():
        sched = sched_mod.PB2(metric="score", mode="max",
                              perturbation_interval=3,
                              hyperparam_bounds={"rate": [0.5, 10.0],
                                                 "k": [0, 5]}, seed=4)
        ctl = _FakeController(trial_cls, configs)
        log = _drive(sched, ctl, events)
        out[side] = (log, ctl.clones, sched._data_X, sched._data_y)
    assert out["port"] == out["jax"]
    assert len(out["port"][3]) >= 3, "the bandit never fit its GP"


def _objective(cfg):
    return (np.log10(cfg["lr"]) + 2.5) ** 2 + (cfg["wd"] - 0.1) ** 2 + \
        (0.0 if cfg["act"] == "gelu" else 0.3) + 0.01 * cfg["n"]


def test_tpe_suggestions_equal():
    out = {}
    for side, (search, _, _) in SIDES.items():
        s = search.TPESearcher(metric="loss", mode="min",
                               n_initial_points=5, seed=2)
        s.set_search_properties("loss", "min", {
            "lr": search.loguniform(1e-5, 1e-1),
            "wd": search.uniform(0.0, 0.3),
            "n": search.randint(1, 20),
            "act": search.choice(["relu", "gelu", "tanh"]),
            "layers": search.grid_search([2, 4]), "const": 3})
        cfgs = []
        for i in range(25):
            cfg = s.suggest(f"t{i}")
            cfgs.append(cfg)
            s.on_trial_complete(f"t{i}", {"loss": _objective(cfg)})
        out[side] = cfgs
    assert out["port"] == out["jax"]


def test_bohb_suggestions_equal():
    out = {}
    for side, (search, _, _) in SIDES.items():
        s = search.BOHBSearcher(metric="loss", mode="min",
                                n_initial_points=4, seed=6)
        s.set_search_properties("loss", "min", {
            "lr": search.loguniform(1e-5, 1e-1),
            "wd": search.uniform(0.0, 0.3),
            "n": search.randint(1, 20),
            "act": search.choice(["relu", "gelu", "tanh"])})
        cfgs = []
        for i in range(24):
            tid = f"t{i}"
            cfg = s.suggest(tid)
            cfgs.append(cfg)
            loss = _objective(cfg)
            s.on_trial_result(tid, {"training_iteration": 1,
                                    "loss": loss + 0.5})
            if i % 3 == 0:
                s.on_trial_result(tid, {"training_iteration": 3,
                                        "loss": loss})
            s.on_trial_complete(tid, None)
        out[side] = (cfgs, s._model_observations())
    assert out["port"] == out["jax"]


# ------------------------------------------------ GPT-2 through Tuner
TUNE_STEPS = 4


def _gpt2_loop(config):
    """The port's train program in the trial's train worker, from the JAX
    init; every step reported, the last report carrying all losses."""
    torch.set_num_threads(1)
    cfg = config["cfg"]
    prog = tspmd.build_train_program(
        loss_fn=lambda p, b: tgpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda g: params_from_numpy(config["tree"], cfg,
                                                   "cpu"),
        optimizer=tspmd.default_optimizer(lr=config["lr"], warmup=1,
                                          total_steps=50),
        device="cpu")
    state = prog.init_fn(torch.Generator())
    batch = tspmd.shard_batch(prog, {"tokens": config["tokens"]})
    losses = []
    for _ in range(config["steps"]):
        state, m = prog.step_fn(state, batch)
        losses.append(m["loss"].item())
        ttrain.report({"loss": losses[-1], "losses": list(losses)})


@pytest.fixture
def cluster():
    """A cluster of the test's own; the package logger is handed back as
    it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2)
    yield
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def test_gpt2_tuner_trial_matches_jax_train_program(cluster, tmp_path):
    jcfg = dataclasses.replace(jgpt2.tiny(), n_embd=128, dtype=jnp.float32,
                               attn_impl="flash")
    tcfg = dataclasses.replace(tgpt2.tiny(), n_embd=128, dtype=torch.float32,
                               attn_impl="flash")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0),
                                                      jcfg))
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    lr = 1e-2
    trainer = ttrain.TorchTrainer(
        _gpt2_loop, train_loop_config={"cfg": tcfg, "tree": tree,
                                       "tokens": toks, "steps": TUNE_STEPS},
        scaling_config=ttrain.ScalingConfig(num_workers=1),
        run_config=ttrain.RunConfig(storage_path=str(tmp_path / "train")))
    grid = ttune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": ttune.grid_search([lr])}},
        tune_config=ttune.TuneConfig(metric="loss", mode="min",
                                     max_concurrent_trials=1),
        run_config=ttrain.RunConfig(storage_path=str(tmp_path / "tune"),
                                    name="gpt2")).fit()
    assert len(grid) == 1 and not grid.errors
    best = grid.get_best_result()
    assert best.metrics["config"] == {"train_loop_config": {"lr": lr}}

    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=lr, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    js = jprog.init_fn(jax.random.key(0))
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    jlosses = []
    for _ in range(TUNE_STEPS):
        js, jm = jprog.step_fn(js, jb)
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(best.metrics["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(best.metrics["loss"], jlosses[-1], rtol=1e-4)
    assert jlosses[-1] < jlosses[0]
