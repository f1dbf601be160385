"""Slice topologies on the port (``ray_tpu_torch/parallel/topology.py``,
``ScalingConfig(topology=)``, ``util.placement_group.tpu_slice_bundles``),
held to the JAX package's ``ray_tpu/parallel/topology.py`` on the same
names and to the reference's tests: ``tests/test_train.py:152``
(``test_scaling_config_topology``) and ``tests/test_multihost.py:380``
(a slice-atomic STRICT_PACK group over the 8 hosts of a ``v4-32``, beside
a decoy slice of 3 hosts that cannot hold it, with a trainer running one
worker a host).  The port's bundles ask for ``"GPU"`` where the
reference's ask for ``"TPU"``; the multi-node case runs on
``ray_tpu_torch.cluster_utils.Cluster`` (logical nodes in one control
plane, their cards faked: ``num_gpus=4`` a node, no CUDA work).

Functions here are pickled by value, so spawned workers never import
this module (nor JAX through it).
"""

import logging
import sys

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu.parallel import topology as jtopo
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.parallel import topology as ttopo
from ray_tpu_torch.util.placement_group import tpu_slice_bundles

cloudpickle.register_pickle_by_value(sys.modules[__name__])

NAMES = ("v2-8", "v3-32", "v4-8", "v4-32", "v5p-128", "v5e-8",
         "v5litepod-16", "v6e-256", "v4-1")


@pytest.fixture(scope="module", autouse=True)
def _logger():
    """``init`` stops the package logger's propagation: hand later
    modules the logger as it was."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.mark.parametrize("name", NAMES)
def test_slice_spec_matches_reference(name):
    """Every field of a parsed topology, its host count and the labels of
    one of its hosts equal the JAX package's."""
    assert ttopo.slice_spec(name).__dict__ == \
        jtopo.slice_spec(name).__dict__
    assert ttopo.slice_spec(name).num_hosts == \
        jtopo.slice_spec(name).num_hosts
    assert ttopo.ici_domain_label(name, 3, host_index=2) == \
        jtopo.ici_domain_label(name, 3, host_index=2)
    assert ttopo.ici_domain_label(name) == jtopo.ici_domain_label(name)


@pytest.mark.parametrize("bad", ["v9x-8", "tpu-8", "v4"])
def test_slice_spec_rejects_unknown_names(bad):
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError):
            mod.slice_spec(bad)


def test_scaling_config_topology():
    """The reference's ``test_scaling_config_topology``, with ``"GPU"``
    for ``"TPU"``."""
    sc = ScalingConfig(topology="v4-32")
    assert sc.num_workers == 8  # 32 chips / 4 per host
    assert sc.placement_strategy == "STRICT_PACK"
    assert sc.bundle()["GPU"] == 4.0
    assert sc.use_gpu and "TPU" not in sc.bundle()


def test_slice_bundles_and_placement_factory():
    """``tpu_slice_bundles`` gives a bundle a host (the reference's with
    ``"GPU"``), and the factory's group holds ``num_workers`` bundles of
    ``bundle()`` under the slice's strategy."""
    want = [{"GPU": b["TPU"]} for b in [
        {"TPU": float(jtopo.slice_spec("v4-32").chips_per_host)}] * 8]
    assert tpu_slice_bundles("v4-32") == want
    assert tpu_slice_bundles("v5e-4") == [{"GPU": 4.0}]
    made = []
    import ray_tpu_torch.util.placement_group as pg_mod
    real = pg_mod.placement_group
    pg_mod.placement_group = lambda b, strategy: made.append((b, strategy))
    try:
        ScalingConfig(topology="v4-16").as_placement_group_factory()()
    finally:
        pg_mod.placement_group = real
    assert made == [([{"CPU": 1.0, "GPU": 4.0}] * 4, "STRICT_PACK")]


def test_detect_local_topology_without_a_card():
    """On a machine without CUDA cards there is no slice to detect."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is attached")
    assert ttopo.detect_local_topology() is None


def test_v4_32_slice_pg_and_torch_trainer(monkeypatch, tmp_path):
    """A slice-atomic STRICT_PACK placement group leases a whole logical
    v4-32 slice (8 hosts x 4 cards; ``ScalingConfig(topology="v4-32")``)
    and TorchTrainer runs one worker per slice host over it, never
    touching the incomplete decoy slice (3 hosts) or the head."""
    from ray_tpu_torch.experimental import internal_kv
    from ray_tpu_torch.train import RunConfig, TorchConfig, TorchTrainer
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    if rt.is_initialized():
        rt.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        # decoy slice 1: only 3 of its hosts exist — cannot hold 8 bundles
        for i in range(3):
            cluster.add_node(num_cpus=2, num_gpus=4,
                             labels=ttopo.ici_domain_label("v4-32", 1,
                                                           host_index=i))
        target = [
            cluster.add_node(num_cpus=2, num_gpus=4,
                             labels=ttopo.ici_domain_label("v4-32", 0,
                                                           host_index=i))
            for i in range(8)]
        target_ids = {n.node_id for n in target}

        def loop(config):
            import ray_tpu_torch as rtt
            from ray_tpu_torch import train
            from ray_tpu_torch.experimental import internal_kv as kv
            ctx = train.get_context()
            kv._internal_kv_put(
                f"mh32/{ctx.get_world_rank()}",
                rtt.get_runtime_context().get_node_id().encode(),
                namespace="test")
            train.report({"world": ctx.get_world_size()})

        sc = ScalingConfig(topology="v4-32")
        assert sc.num_workers == 8 and sc.placement_strategy == "STRICT_PACK"
        trainer = TorchTrainer(
            loop, torch_config=TorchConfig(init_collective_group=False),
            scaling_config=sc,
            run_config=RunConfig(storage_path=str(tmp_path)))
        result = trainer.fit()
        assert result.error is None, result.error
        assert result.metrics["world"] == 8
        landed = {internal_kv._internal_kv_get(f"mh32/{r}",
                                               namespace="test").decode()
                  for r in range(8)}
        # one worker per slice host, all 8 hosts of THE target slice,
        # none on the decoy or the head node
        assert landed == target_ids, (landed, target_ids)
    finally:
        cluster.shutdown()
