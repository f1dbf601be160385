"""The port's ``TorchTrainer`` against the JAX package, on the CPU: a tiny
GPT-2 trained in a train worker, held to the JAX package's
``build_train_program`` run in this process, and ``chip_smoke.py``'s
crash-and-restore loop, which must restore bitwise.

Tolerances: the parity test holds the losses to 1e-4 relative and each
param leaf's update to 1e-3 of its L2 norm, the limits
``tests/test_torch_train.py`` sets for the same train-program trajectory
(float32 on both sides, sums in other orders).  The restore test is
bitwise: the same program on the same inputs in processes with one
thread each.  The loops are pickled by value, so spawned workers import
neither this module nor JAX.
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

import chip_smoke
import ray_tpu_torch as rt
from chip_smoke import restore_loop
from ray_tpu_torch import train
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchTrainer)

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(chip_smoke)


@pytest.fixture(scope="module")
def cluster():
    """One cluster for the module; the package logger is handed back as
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


PARITY_STEPS = 5


def _parity_loop(config):
    """The port's train program in a train worker, from the JAX init."""
    torch.set_num_threads(1)
    cfg = config["cfg"]
    prog = tspmd.build_train_program(
        loss_fn=lambda p, b: tgpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda g: params_from_numpy(config["tree"], cfg,
                                                   "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1,
                                          total_steps=50),
        device="cpu")
    state = prog.init_fn(torch.Generator())
    batch = tspmd.shard_batch(prog, {"tokens": config["tokens"]})
    for i in range(config["steps"]):
        state, m = prog.step_fn(state, batch)
        ckpt = None
        if i == config["steps"] - 1:
            d = os.path.join(train.get_context().get_storage_path(), "out")
            train.save_pytree(os.path.join(d, "params"), state.params)
            ckpt = Checkpoint.from_directory(d)
        train.report({"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item()}, checkpoint=ckpt)


def test_torch_trainer_matches_jax_train_program(cluster, tmp_path):
    """A tiny GPT-2 (E 128, flash: Pallas in interpret mode on the JAX
    side, the plain versions on the port's) through TorchTrainer on the
    CPU against the JAX package's build_train_program in this process:
    the reported losses within 1e-4, the params the worker saved within
    1e-3 of each leaf's update."""
    jcfg = dataclasses.replace(jgpt2.tiny(), n_embd=128, dtype=jnp.float32,
                               attn_impl="flash")
    tcfg = dataclasses.replace(tgpt2.tiny(), n_embd=128, dtype=torch.float32,
                               attn_impl="flash")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0),
                                                      jcfg))
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    result = TorchTrainer(
        _parity_loop, train_loop_config={"cfg": tcfg, "tree": tree,
                                         "tokens": toks,
                                         "steps": PARITY_STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None

    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    js = jprog.init_fn(jax.random.key(0))
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    jlosses = []
    for _ in range(PARITY_STEPS):
        js, jm = jprog.step_fn(js, jb)
        jlosses.append(float(jm["loss"]))
    losses = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]

    got = params_to_numpy(train.restore_pytree(
        os.path.join(result.checkpoint.path, "params")))
    ref = jax.tree.map(np.array, js.params)
    # the key bias has an exactly zero gradient (a shift of every score of
    # a query row); Adam turns noise into steps of up to lr: held within lr
    # a step of its start (test_torch_train.py's _assert_params_close)
    k0 = tree["blocks"]["attn_qkv"]["bias"][:, 1]
    for t in (got, ref):
        kb = t["blocks"]["attn_qkv"]["bias"]
        assert np.abs(kb[:, 1] - k0).max() <= 1e-2 * PARITY_STEPS * 1.001
        kb[:, 1] = k0
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


def _restore_loop(config):
    torch.set_num_threads(1)
    restore_loop(config)


def test_crash_restore_is_bitwise_on_cpu(cluster, tmp_path):
    """chip_smoke.py's crash-and-restore loop at a tiny size on the CPU:
    the worker exits at step 4, the next attempt restores step 2's params,
    optimizer state and step and runs to step 6; its final params equal an
    uninterrupted run's bitwise, and a restore without the optimizer
    state does not."""
    cfg = dataclasses.replace(tgpt2.tiny(), dtype=torch.float32,
                              attn_impl="flash")
    runs = {}
    for name, extra in (("straight", {}), ("restored", {"crash": True}),
                        ("no_opt_state", {"crash": True,
                                          "plant": "no_opt_state"})):
        result = TorchTrainer(
            _restore_loop, train_loop_config={
                "device": "cpu", "cfg": cfg, "batch_seq": (2, 16),
                "marker": str(tmp_path / f"crashed_{name}"), **extra},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name=name, storage_path=str(tmp_path),
                                 failure_config=FailureConfig(
                                     max_failures=1))).fit()
        assert result.error is None, name
        runs[name] = result.metrics_history
    straight, restored = runs["straight"], runs["restored"]
    assert [m["step"] for m in straight] == [1, 2, 3, 4, 5, 6]
    assert [m["step"] for m in restored] == [1, 2, 3, 3, 4, 5, 6]
    assert restored[3]["restored_from"] == 2
    assert [m["loss"] for m in restored[3:]] == \
        [m["loss"] for m in straight[2:]]
    assert restored[-1]["params_sha256"] == straight[-1]["params_sha256"]
    assert runs["no_opt_state"][-1]["params_sha256"] != \
        straight[-1]["params_sha256"]
