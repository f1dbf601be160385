"""Train's mesh route under ZeRO-3 and expert parallelism
(``TorchTrainer(mesh_config=MeshConfig(fsdp=2))`` and
``MeshConfig(expert=2)`` with ``TorchConfig(use_distributed=True)``),
with a checkpoint of the sharded state and its restore.

Two ``TorchTrainer`` workers form one gloo domain on the CPU and run one
mesh program across both (GPT-2 tiny under ``fsdp=2``, the MoE
transformer tiny under ``expert=2``).  The first fit takes 2 steps and
checkpoints the state gathered on the host by its specs
(``gather_to_host``); the second fit places that checkpoint back
(``put_global`` by the specs) and takes 2 more.  The 4 losses must
equal a single-process run of the identical program within 1e-5
(float32).  The checkpoint must have the one-process state's layout
(every leaf's path and shape, params and optimizer state), and its Adam
moments the one-process values within 1e-5 of each leaf's largest
element.  The params' values are held through the losses after the
restore: AdamW moves an element by ~lr · m/√v whatever its gradient's
size, so an element whose gradient is rounding noise (the key bias's is
0 in exact arithmetic) lands up to lr apart on two sides that sum in
other orders.

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
from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = 1e-5
CASES = {"fsdp": ("gpt2", MeshConfig(data=1, fsdp=2)),
         "expert": ("moe", MeshConfig(data=1, expert=2))}


@pytest.fixture(scope="module", autouse=True)
def cluster():
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


def _build_program(family, mesh_config):
    """A tiny ``family`` program over ``mesh_config`` (None: one process
    on the CPU), shared verbatim by the workers and the single-process
    run; and its rules and batch."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt2, moe_transformer
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    mod, rules = {"gpt2": (gpt2, mesh_lib.TRANSFORMER_RULES),
                  "moe": (moe_transformer,
                          moe_transformer.MOE_TRANSFORMER_RULES)}[family]
    cfg = dataclasses.replace(mod.tiny(vocab=128, seq=32),
                              dtype=torch.float32)
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        init_params_fn=lambda g: mod.init_params(
            g.manual_seed(0), cfg, "cpu"),
        optimizer=spmd.default_optimizer(lr=1e-2, warmup=1,
                                         total_steps=50),
        mesh_config=mesh_config, device="cpu", rules=rules)
    toks = (np.arange(4 * 33, dtype=np.int32).reshape(4, 33) * 7
            % cfg.vocab_size)
    batch = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
    return prog, rules, batch


def _single(family, steps):
    """The single-process run's losses, and its state on the host after
    2 steps."""
    import torch

    from ray_tpu_torch.parallel import multihost
    prog, _, batch = _build_program(family, None)
    state = prog.init_fn(torch.Generator())
    losses, host = [], None
    for i in range(steps):
        state, m = prog.step_fn(state, batch)
        losses.append(float(m["loss"]))
        if i == 1:
            host = {k: multihost.gather_to_host(getattr(state, k))
                    for k in ("params", "opt_state")}
    return losses, host


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{path}/{i}")]
    return [(path, np.asarray(tree))]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_state_checkpoint_and_restore(tmp_path, case):
    family, mesh_config = CASES[case]
    single, single_state = _single(family, 4)
    build = _build_program

    def loop(config):
        import torch

        from ray_tpu_torch.parallel import multihost, spmd
        prog, rules, batch = build(config["family"],
                                   train.get_context().get_mesh_config())
        assert prog.mesh.size == 2
        state = prog.init_fn(torch.Generator())
        specs = spmd.state_specs(state, rules)
        start = 0
        if config.get("ckpt") is not None:
            blob = config["ckpt"].to_dict()
            for name in ("params", "opt_state"):
                setattr(state, name, multihost.put_global(
                    blob[name], "cpu", specs=getattr(specs, name),
                    mesh=prog.mesh))
            state.step.fill_(blob["step"])
            start = blob["step"]
        for step in range(start, start + 2):
            state, m = prog.step_fn(state, batch)
            host = {name: multihost.gather_to_host(
                getattr(state, name), specs=getattr(specs, name),
                mesh=prog.mesh) for name in ("params", "opt_state")}
            train.report({"loss": float(m["loss"]),
                          "state_step": int(state.step),
                          "transport": prog.mesh.transport},
                         checkpoint=Checkpoint.from_dict(
                             dict(host, step=step + 1)))

    losses, ckpt = [], None
    for fit in range(2):
        result = TorchTrainer(
            loop, train_loop_config={"family": family, "ckpt": ckpt},
            torch_config=TorchConfig(use_distributed=True, device="cpu",
                                     init_collective_group=False),
            mesh_config=mesh_config,
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name=f"{case}{fit}",
                                 storage_path=str(tmp_path))).fit()
        assert result.error is None, result.error
        assert [m["transport"] for m in result.metrics_history] == \
            ["gloo"] * 2
        losses += [m["loss"] for m in result.metrics_history]
        ckpt = result.checkpoint
        if fit == 0:
            blob = ckpt.to_dict()
            got = _leaves({k: blob[k] for k in single_state})
            want = _leaves(single_state)
            assert [(p, g.shape) for p, g in got] == \
                [(p, w.shape) for p, w in want]
            for (path, g), (_, w) in zip(got, want):
                if path.startswith("/opt_state") and w.ndim:
                    scale = max(float(np.abs(w).max()), 1e-30)
                    np.testing.assert_allclose(g, w, rtol=0,
                                               atol=TOL * scale,
                                               err_msg=path)
    np.testing.assert_allclose(losses, single, rtol=0, atol=TOL)
    assert losses[-1] < losses[0]
