"""The port's Train over a ``torch.distributed`` domain
(``TorchConfig(use_distributed=True)``): mirrors of
``tests/test_train_multicontroller.py``.

Two ``TorchTrainer`` workers form one gloo domain on the CPU
(``device="cpu"``) and run one mesh program across both (``tensor=2``,
the trainer's ``mesh_config``):

- its per-step losses equal a single-process run of the identical
  program within 1e-5 (float32; the reference's bound is 1e-4);
- killing one worker mid-run restarts the whole group, which resumes
  from the checkpoint its ranks gathered (``gather_to_host`` by the
  state's specs) with step continuity.

Functions here are pickled by value, so spawned workers never import
this module.
"""

import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STEPS = 4
MESH = MeshConfig(data=1, tensor=2)
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def single():
    """The single-process run's losses, taken before the module's cluster
    starts (6 steps: the restart test runs that many)."""
    return _single_process_losses(6)


@pytest.fixture(scope="module", autouse=True)
def cluster(single):
    """One cluster for the module; the package logger handed back as it
    was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    os.environ.pop("RTT_NUM_GPUS", None)
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


def _build_program(mesh_config):
    """One tiny GPT-2 program over ``mesh_config`` (None: one process on
    the CPU), shared verbatim by the workers and the single-process run:
    the loss match means something only for the identical program."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import spmd
    cfg = dataclasses.replace(gpt2.tiny(vocab=128, seq=32),
                              dtype=torch.float32)
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: gpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda g: gpt2.init_params(
            g.manual_seed(0), cfg, "cpu"),
        optimizer=spmd.default_optimizer(lr=1e-2, warmup=1,
                                         total_steps=50),
        mesh_config=mesh_config, device="cpu")
    toks = (np.arange(8 * 33, dtype=np.int32).reshape(8, 33)
            % cfg.vocab_size)
    batch = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
    return prog, batch


def _single_process_losses(steps: int):
    import torch
    prog, batch = _build_program(None)
    state = prog.init_fn(torch.Generator())
    out = []
    for _ in range(steps):
        state, m = prog.step_fn(state, batch)
        out.append(float(m["loss"]))
    return out


def _config():
    return TorchConfig(use_distributed=True, device="cpu",
                       init_collective_group=False)


def test_cross_process_spmd_matches_single_process(tmp_path, single):
    """2 processes, one tensor=2 program across both: the losses match
    the single-process run of the identical program."""
    build = _build_program

    def loop(config):
        import torch

        from ray_tpu_torch.parallel import multihost
        assert multihost.process_count() == 2
        mc = train.get_context().get_mesh_config()
        prog, batch = build(mc)
        assert prog.mesh.size == 2 and prog.mesh.shape["tensor"] == 2
        state = prog.init_fn(torch.Generator())
        for _ in range(STEPS):
            state, m = prog.step_fn(state, batch)
            train.report({"loss": float(m["loss"]),
                          "process_count": multihost.process_count(),
                          "device": str(multihost.device()),
                          "transport": prog.mesh.transport})

    result = TorchTrainer(
        loop, torch_config=_config(), mesh_config=MESH,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == STEPS
    assert (hist[0]["process_count"], hist[0]["device"],
            hist[0]["transport"]) == (2, "cpu", "gloo")
    multi = [m["loss"] for m in hist]
    np.testing.assert_allclose(multi, single[:STEPS], rtol=0, atol=LOSS_TOL)
    assert multi[-1] < multi[0]


def test_worker_death_restarts_group_from_checkpoint(tmp_path, single):
    """Kill one process of the domain mid-run: the whole group restarts
    and resumes from the gathered checkpoint."""
    build = _build_program

    def loop(config):
        import time

        import torch

        from ray_tpu_torch.experimental import internal_kv
        from ray_tpu_torch.parallel import multihost, spmd
        from ray_tpu_torch.train._internal.session import get_session
        sess = get_session()
        assert multihost.process_count() == 2
        prog, batch = build(train.get_context().get_mesh_config())
        state = prog.init_fn(torch.Generator())
        specs = spmd.state_specs(state, spmd.TRANSFORMER_RULES)
        ck = train.get_checkpoint()
        start = 0
        if ck is not None:
            blob = ck.to_dict()
            for name in ("params", "opt_state"):
                setattr(state, name, multihost.put_global(
                    blob[name], "cpu", specs=getattr(specs, name),
                    mesh=prog.mesh))
            state.step.fill_(blob["step"])
            start = blob["step"]
        for step in range(start, 6):
            state, m = prog.step_fn(state, batch)
            if sess.attempt == 0 and step == 2 and sess.rank == 1:
                # die only after the driver consumed both ranks' step-0/1
                # reports, so a checkpoint exists to resume from
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    if all(internal_kv._internal_kv_get(
                            f"{sess.run_id}/r/{it}/{r}",
                            namespace="train") is None
                            for it in (1, 2) for r in (0, 1)):
                        break
                    time.sleep(0.05)
                os._exit(1)
            host = {name: multihost.gather_to_host(
                getattr(state, name), specs=getattr(specs, name),
                mesh=prog.mesh) for name in ("params", "opt_state")}
            train.report({"loss": float(m["loss"]),
                          "state_step": int(state.step),
                          "attempt": sess.attempt},
                         checkpoint=Checkpoint.from_dict(
                             dict(host, step=step + 1)))

    result = TorchTrainer(
        loop, torch_config=_config(), mesh_config=MESH,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(
                                 max_failures=4))).fit()
    assert result.error is None, result.error
    hist = result.metrics_history
    attempts = [m["attempt"] for m in hist]
    assert 0 in attempts, attempts
    assert attempts[-1] != 0 and len(set(attempts)) >= 2, attempts
    steps = [m["state_step"] for m in hist]
    assert steps == sorted(steps), steps
    assert steps[-1] == 6, steps
    # the resumed run follows the uninterrupted one: over 6 steps at lr
    # 1e-2 the two float32 trajectories drift apart by ~2e-5
    np.testing.assert_allclose([m["loss"] for m in hist],
                               [single[s - 1] for s in steps], rtol=1e-4)
