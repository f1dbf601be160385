"""The port's placement groups (``ray_tpu_torch.util.placement_group``),
held to the reference's cases in ``tests/test_placement_group.py``,
plus a ``"GPU"`` bundle on a cluster with faked cards (``num_gpus=2``: no
CUDA work, only the resource and the GPU worker).  The multi-node cases
run on ``ray_tpu_torch.cluster_utils.Cluster`` (logical nodes in one
control plane) with ``"GPU"`` bundles where the reference's ask for
``"TPU"``, and its ``ici_domain_label`` written out as literal labels.

Each single-node test has a fresh cluster at ``num_cpus=4`` (the
reference's ``ray_start_regular``): the removal test counts the node's
CPUs.
"""

import logging
import os
import sys

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.util.placement_group import (
    placement_group, placement_group_table, remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy

cloudpickle.register_pickle_by_value(sys.modules[__name__])


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


@pytest.fixture
def ray_start_regular(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture
def ray_start_cluster(monkeypatch):
    monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
    if rt.is_initialized():
        rt.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    yield cluster
    cluster.shutdown()


def test_pg_pack_ready(ray_start_regular):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=5)
    table = placement_group_table()
    assert table[pg.id]["state"] == "ready"
    # PACK on one node → same node for both bundles
    assert len(set(table[pg.id]["assignment"])) == 1
    remove_placement_group(pg)
    assert pg.id not in placement_group_table()


def test_pg_task_uses_bundle(ray_start_regular):
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=5)

    @rt.remote
    def inside():
        return "in-pg"

    strat = PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    assert rt.get(inside.options(
        scheduling_strategy=strat).remote(), timeout=20) == "in-pg"
    remove_placement_group(pg)


def test_pg_infeasible_until_node_added(ray_start_cluster):
    cluster = ray_start_cluster
    pg = placement_group([{"CPU": 8}], strategy="PACK")
    assert not pg.wait(timeout_seconds=0.5)
    cluster.add_node(num_cpus=8)
    assert pg.wait(timeout_seconds=10)


def test_strict_spread_needs_nodes(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=1)
    cluster.add_node(num_cpus=1)
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)
    table = placement_group_table()
    assert len(set(table[pg.id]["assignment"])) == 3


def test_strict_pack_single_ici_domain(ray_start_cluster):
    cluster = ray_start_cluster
    # two hosts of one slice share an ici_domain label
    cluster.add_node(num_cpus=1, num_gpus=4, labels={"ici_domain": "v4-16/0"})
    cluster.add_node(num_cpus=1, num_gpus=4, labels={"ici_domain": "v4-16/0"})
    # a different slice
    cluster.add_node(num_cpus=1, num_gpus=4, labels={"ici_domain": "v4-16/1"})
    pg = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="STRICT_PACK")
    assert pg.wait(timeout_seconds=10)
    table = placement_group_table()
    assigned = table[pg.id]["assignment"]
    nodes = {n["node_id"]: n for n in rt.nodes()}
    domains = {nodes[a]["labels"].get("ici_domain") for a in assigned}
    assert len(domains) == 1  # all bundles inside one domain


def test_strict_pack_prefers_adjacent_hosts(ray_start_cluster):
    """STRICT_PACK lands on a minimal CONTIGUOUS window of hosts
    (slice_host label order = adjacency), not arbitrary domain
    members."""
    cluster = ray_start_cluster
    for i, gpus in enumerate([4, 1, 4, 4]):   # host 1 is mostly busy
        cluster.add_node(
            num_cpus=1, num_gpus=gpus,
            labels={"ici_domain": "v4-16/0", "slice_topology": "v4-16",
                    "slice_host": str(i)})
    pg = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="STRICT_PACK")
    assert pg.wait(timeout_seconds=10)
    table = placement_group_table()
    assigned = table[pg.id]["assignment"]
    info = {n["node_id"]: n for n in rt.nodes()}
    idxs = sorted(int(info[a]["labels"]["slice_host"]) for a in assigned)
    # hosts 2,3 form the only adjacent window with 4 cards each
    assert idxs == [2, 3], idxs


def test_pg_removal_frees_resources(ray_start_regular):
    pg = placement_group([{"CPU": 4}], strategy="PACK")
    assert rt.get(pg.ready(), timeout=5) is pg
    assert rt.available_resources().get("CPU", 0) == 0
    remove_placement_group(pg)
    assert rt.available_resources().get("CPU", 0) == 4


def test_pg_bad_input_raises(ray_start_regular):
    with pytest.raises(ValueError, match="strategy"):
        placement_group([{"CPU": 1}], strategy="NEAR")
    with pytest.raises(ValueError, match="non-empty"):
        placement_group([{}])


def test_gpu_bundle_places_a_gpu_actor(monkeypatch):
    """A ``{"GPU": 1}`` bundle on a node with two (faked) cards holds one
    of them; an actor in it runs in a GPU worker that sees the node's
    cards.  A bundle of three cards stays pending: ready() times out."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=2, num_gpus=2)
    try:
        pg = placement_group([{"CPU": 1, "GPU": 1}])
        assert rt.get(pg.ready(), timeout=10) is pg
        assert rt.available_resources().get("GPU") == 1.0

        @rt.remote(num_gpus=1, num_cpus=1)
        class OnCard:
            def view(self):
                return (os.environ.get("RTT_GPU_WORKER"),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        a = OnCard.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)).remote()
        assert rt.get(a.view.remote(), timeout=60) == ("1", "3,5")
        rt.kill(a)
        too_big = placement_group([{"GPU": 3}])
        with pytest.raises(GetTimeoutError):
            rt.get(too_big.ready(), timeout=0.5)
        remove_placement_group(too_big)
        remove_placement_group(pg)
        assert rt.available_resources().get("GPU") == 2.0
    finally:
        rt.shutdown()
