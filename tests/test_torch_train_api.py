"""The port's Ray Train (``ray_tpu_torch.train``) on its own runtime, held
to the reference's train tests (``tests/test_train.py``), plus what the
port adds: ``use_gpu`` bundles, the GPU-worker pool and a cluster with no
card, unported settings that raise, the internal KV and dataset shards.
``tests/test_torch_train_parity.py`` holds a tiny GPT-2 through
``TorchTrainer`` against the JAX package and the bitwise restore.

Tests share one cluster at ``num_cpus=4`` (``cluster``); the ones that
need another cluster make their own.  Functions here are pickled by
value, so spawned workers never import this module (nor JAX through it).
"""

import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch._private import rtlog
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.train import (Checkpoint, DataParallelTrainer,
                                 FailureConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _stop():
    if rt.is_initialized():
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's last cluster and hands later modules the
    package logger as it was (``init`` stops its propagation)."""
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


def _run(tmp_path, **kw):
    return RunConfig(storage_path=str(tmp_path), **kw)


# --------------------------------------------------- tests/test_train.py
def test_single_worker_reports(cluster, tmp_path):
    def loop(config):
        for i in range(3):
            train.report({"loss": 10.0 - i, "step": i})

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["loss"] == 8.0
    assert [m["loss"] for m in result.metrics_history] == [10.0, 9.0, 8.0]


def test_multi_worker_rank_context(cluster, tmp_path):
    def loop(config):
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(),
                      "world": ctx.get_world_size(), "pid": os.getpid()})

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=3),
        run_config=_run(tmp_path))
    result = trainer.fit()
    assert result.error is None
    # driver records rank 0's metrics
    assert result.metrics["rank"] == 0
    assert result.metrics["world"] == 3
    assert result.metrics["pid"] != os.getpid()


def test_checkpoint_roundtrip(cluster, tmp_path):
    def loop(config):
        for step in range(2):
            ck = Checkpoint.from_dict({"step": step, "weights": [1.0, 2.0]})
            train.report({"step": step}, checkpoint=ck)

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path))
    result = trainer.fit()
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict()["step"] == 1
    assert len(result.best_checkpoints) == 2


def test_checkpoint_retention(cluster, tmp_path):
    """``CheckpointConfig(num_to_keep=1)``: only the newest checkpoint is
    kept, on disk and in the result."""
    def loop(config):
        for step in range(3):
            train.report({"step": step},
                         checkpoint=Checkpoint.from_dict({"step": step}))

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path, checkpoint_config=train.CheckpointConfig(
            num_to_keep=1))).fit()
    assert result.error is None
    assert [c.to_dict()["step"] for c, _ in result.best_checkpoints] == [2]
    assert result.checkpoint.to_dict()["step"] == 2
    kept = [d for d in os.listdir(result.path) if d.startswith("checkpoint")]
    assert kept == [os.path.basename(result.checkpoint.path)]


def test_train_loop_config_passed(cluster, tmp_path):
    def loop(config):
        train.report({"lr": config["lr"]})

    trainer = DataParallelTrainer(
        loop, train_loop_config={"lr": 0.125},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path))
    assert trainer.fit().metrics["lr"] == 0.125


def test_as_trainable_merges_loop_config(cluster, tmp_path):
    """``as_trainable``: a function of a trial config whose
    ``train_loop_config`` overrides the trainer's, returning the final
    metrics (no session outside a trial)."""
    def loop(config):
        train.report({"lr": config["lr"], "bs": config["bs"]})

    trainable = DataParallelTrainer(
        loop, train_loop_config={"lr": 0.125, "bs": 4},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path)).as_trainable()
    metrics = trainable({"train_loop_config": {"lr": 0.5}})
    assert (metrics["lr"], metrics["bs"]) == (0.5, 4)


def test_failure_restarts_from_checkpoint(cluster, tmp_path):
    marker = str(tmp_path / "poison")

    def loop(config):
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for step in range(start, 4):
            if step == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                os._exit(1)  # hard-kill this worker
            train.report({"step": step},
                         checkpoint=Checkpoint.from_dict({"step": step}))

    trainer = DataParallelTrainer(
        loop, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path,
                        failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.error is None
    # resumed at step 2 after the crash
    steps = [m["step"] for m in result.metrics_history]
    assert steps == [0, 1, 2, 3]
    assert result.checkpoint.to_dict()["step"] == 3


def test_failure_exhausted_returns_error(cluster, tmp_path):
    def loop(config):
        os._exit(1)

    trainer = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path,
                        failure_config=FailureConfig(max_failures=0)))
    result = trainer.fit()
    assert result.error is not None


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_torch_trainer_collective_gradient_sync(cluster, tmp_path, kind):
    """Two workers average a 'gradient' through the auto-created train
    collective group; a torch tensor comes back a tensor of its dtype on
    its device."""

    def loop(config):
        from ray_tpu_torch.util import collective as col
        rank = train.get_context().get_world_rank()
        if config["kind"] == "torch":
            g = torch.full((4,), float(rank + 1), dtype=torch.bfloat16)
        else:
            g = np.full(4, float(rank + 1), np.float32)
        avg = col.allreduce(g, "train_default") / 2.0
        train.report({"avg0": float(avg[0]), "type": type(avg).__name__,
                      "dtype": str(avg.dtype)})

    trainer = TorchTrainer(
        loop, train_loop_config={"kind": kind},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run(tmp_path))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["avg0"] == pytest.approx(1.5)
    assert (result.metrics["type"], result.metrics["dtype"]) == \
        (("Tensor", "torch.bfloat16") if kind == "torch"
         else ("ndarray", "float32"))


def test_torch_trainer_pytree_checkpoint(cluster, tmp_path):
    """save_pytree / restore_pytree of a nested torch tree in a worker:
    dtypes, shapes and nesting kept; the driver reads it on the CPU, onto
    a template's devices, or onto the device it names."""

    def loop(config):
        from ray_tpu_torch.train import restore_pytree, save_pytree
        tree = {"w": torch.arange(4.0), "b": torch.zeros(2, dtype=torch.bfloat16),
                "opt": ({"count": torch.tensor(3, dtype=torch.int32)}, ()),
                "layers": [torch.ones(2, 3), torch.full((1,), 7.0)]}
        d = os.path.join(config["dir"], "ckpt_src")
        save_pytree(d, tree)
        back = restore_pytree(d)
        ok = all(torch.equal(a, b) and a.dtype == b.dtype
                 for a, b in ((back["w"], tree["w"]), (back["b"], tree["b"]),
                              (back["opt"][0]["count"],
                               tree["opt"][0]["count"]),
                              (back["layers"][1], tree["layers"][1])))
        train.report({"ok": ok and back["opt"][1] == ()},
                     checkpoint=Checkpoint.from_directory(config["dir"]))

    trainer = TorchTrainer(
        loop, train_loop_config={"dir": str(tmp_path / "src")},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=_run(tmp_path))
    result = trainer.fit()
    assert result.error is None and result.metrics["ok"] is True
    path = os.path.join(result.checkpoint.path, "ckpt_src")
    back = train.restore_pytree(path)
    assert back["b"].dtype == torch.bfloat16 and back["b"].device.type == "cpu"
    assert isinstance(back["opt"], tuple) and isinstance(back["layers"], list)
    templ = train.restore_pytree(path, template=back, device="meta")
    assert templ["w"].device.type == "meta"
    with pytest.raises(ValueError, match="template"):
        train.restore_pytree(path, template={**back, "w": torch.zeros(5)})


def test_scaling_config_use_gpu_bundles(_shared, tmp_path):
    """use_gpu asks for "GPU" in every bundle (1.0 unless
    resources_per_worker says otherwise), and each worker is a num_gpus
    actor in a GPU worker that sees the node's cards.  No CUDA work."""
    assert ScalingConfig(num_workers=2, use_gpu=True).bundle() == \
        {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=True, resources_per_worker={
        "GPU": 0.5}).bundle() == {"CPU": 1.0, "GPU": 0.5}
    assert ScalingConfig(resources_per_worker={"GPU": 1}).bundle() == \
        {"CPU": 1.0}
    _stop()
    rt.init(num_cpus=2, num_gpus=2,
            _system_config={"gpu_workers_per_node": 2})
    try:
        def loop(config):
            from ray_tpu_torch.util.placement_group import \
                placement_group_table
            pgs = [p for p in placement_group_table().values()
                   if p["state"] == "ready"]
            train.report({"gpu_worker": os.environ.get("RTT_GPU_WORKER"),
                          "bundles": [b for p in pgs for b in p["bundles"]],
                          "pid": os.getpid()})

        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
            run_config=_run(tmp_path)).fit()
        assert result.error is None
        assert result.metrics["gpu_worker"] == "1"
        assert result.metrics["bundles"] == [{"CPU": 1.0, "GPU": 1.0}] * 2
        assert rt.available_resources().get("GPU") == 2.0
    finally:
        _stop()
        GLOBAL_CONFIG.reset()


def test_gpu_workers_beyond_the_pool_raise(cluster, tmp_path):
    """Two GPU workers need two GPU worker processes: at the runtime's
    default of one a node, fit() names the flag instead of hanging."""
    trainer = TorchTrainer(
        lambda: None, run_config=_run(tmp_path),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True,
                                     resources_per_worker={"GPU": 0.5}))
    with pytest.raises(ValueError, match="gpu_workers_per_node"):
        trainer.fit()


def test_use_gpu_without_a_card_times_out(cluster, tmp_path):
    """No "GPU" in the cluster: the placement group stays pending until
    fit() fails with a timeout naming the bundle, never on CPU workers."""
    trainer = TorchTrainer(
        lambda: train.report({"ran": 1}), run_config=_run(tmp_path),
        torch_config=TorchConfig(init_timeout_s=0.5),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
    with pytest.raises(GetTimeoutError, match="'GPU': 1.0"):
        trainer.fit()
    assert not any(p["state"] == "ready" for p in
                   rt._worker_mod.global_worker().rpc("pg_table")["pgs"]
                   .values())


@pytest.mark.parametrize("setting, unported", [
    ({"use_distributed": True}, False),
    ({"drain_handler": print}, False),
    ({"elastic": True}, False)],
    ids=["use_distributed", "drain_handler", "elastic"])
def test_unported_settings_raise(setting, unported):
    """Every setting is ported now: the distributed domain
    (``use_distributed``, the mesh route), the drain subscription and
    the elastic route take their settings."""
    if unported:
        with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
            TorchConfig(**setting)
        return
    cfg = TorchConfig(**setting)
    for key, value in setting.items():
        assert getattr(cfg, key) is value


@pytest.mark.parametrize("scaling, bundle, gpus", [
    (ScalingConfig(), {"CPU": 1.0}, 0.0),
    (ScalingConfig(use_gpu=True), {"CPU": 1.0, "GPU": 1.0}, 1.0),
    (ScalingConfig(use_gpu=True, resources_per_worker={"CPU": 2, "GPU": 0.5}),
     {"CPU": 2, "GPU": 0.5}, 0.5),
    (ScalingConfig(resources_per_worker={"GPU": 1.0}), {"CPU": 1.0}, 0.0),
], ids=["default", "use_gpu", "half_card", "gpu_without_use_gpu"])
def test_scaling_config_bundle(scaling, bundle, gpus):
    """A worker's bundle asks for "GPU" only with use_gpu, one card by
    default, ``resources_per_worker["GPU"]`` otherwise."""
    assert scaling.bundle() == bundle
    assert scaling.num_gpus_per_worker == gpus


def test_internal_kv(cluster):
    ns = "test_torch_train_api"
    assert internal_kv._internal_kv_initialized()
    assert internal_kv._internal_kv_put("a/1", b"x", namespace=ns) is False
    assert internal_kv._internal_kv_put("a/1", b"y", namespace=ns) is True
    assert internal_kv._internal_kv_put("a/1", b"z", overwrite=False,
                                        namespace=ns) is True
    internal_kv._internal_kv_put("a/2", b"w", namespace=ns)
    assert internal_kv._internal_kv_get("a/1", namespace=ns) == b"y"
    assert internal_kv._internal_kv_get("a/1") is None      # other namespace
    assert internal_kv._internal_kv_exists("a/2", namespace=ns)
    assert sorted(internal_kv._internal_kv_list("a/", namespace=ns)) == \
        ["a/1", "a/2"]
    assert internal_kv._internal_kv_del("a/1", namespace=ns) is True
    assert internal_kv._internal_kv_del("a/1", namespace=ns) is False
    assert not internal_kv._internal_kv_exists("a/1", namespace=ns)
    assert internal_kv._internal_kv_list("a/", namespace=ns) == ["a/2"]


class _Splittable:
    def __init__(self, items):
        self.items = items

    def split(self, n):
        return [_Splittable(self.items[i::n]) for i in range(n)]


def test_get_dataset_shard(cluster, tmp_path):
    """A non-Dataset object reaches every worker unchanged; one with
    ``split(n)`` is split across them."""

    def loop():
        train.report({"plain": train.get_dataset_shard("plain"),
                      "split": train.get_dataset_shard("split").items,
                      "rank": train.get_context().get_world_rank()})

    result = TorchTrainer(
        loop, datasets={"plain": [1, 2, 3],
                        "split": _Splittable(list(range(6)))},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run(tmp_path)).fit()
    assert result.error is None
    assert result.metrics["plain"] == [1, 2, 3]
    assert result.metrics["split"] == [0, 2, 4]       # rank 0's shard
