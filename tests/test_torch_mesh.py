"""The port's meshes over ranks, sharding rules and device collective
group (``ray_tpu_torch/parallel/mesh.py``,
``util/collective/collective_group/device_group.py``) against the JAX
package's ``parallel/mesh.py`` and ``XlaCollectiveGroup`` (mirrors of
``tests/test_spmd.py``'s mesh tests).

The port's side runs on a pool of four gloo ranks
(``tests/rtt_mesh_pool.py``).  Slices and the group's results are exact
(they move data; the sums are of small integers).
"""

import jax
import numpy as np
import pytest
import torch

import rtt_mesh_pool as pool_lib
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.util.collective.collective_group.xla_group import \
    XlaCollectiveGroup
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.util.collective.collective_group.device_group import \
    transport_for


@pytest.fixture(scope="module")
def pool():
    p = pool_lib.RankPool(4)
    yield p
    p.close()


def test_mesh_config_resolution():
    cfg = tmesh.MeshConfig(data=-1, tensor=2).resolved(8)
    assert cfg == tmesh.MeshConfig(data=4, tensor=2)
    assert cfg.num_devices == 8 and cfg.batch_axes() == ("data",)
    with pytest.raises(ValueError):
        tmesh.MeshConfig(data=3, tensor=2).resolved(8)
    assert tspmd.MeshConfig is tmesh.MeshConfig
    mc = tmesh.MeshConfig(data=2, tensor=2)
    assert tmesh.local_batch_size(8, mc, 4) == \
        jmesh.local_batch_size(8, JMeshConfig(data=2, tensor=2), 4) == 4
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_batch_size(7, mc, 4)
    assert tmesh.AXES == jmesh.AXES
    for mc in (dict(data=4, tensor=2), dict(data=-1, pipeline=2)):
        assert tmesh.MeshConfig(**mc).resolved(8).as_dict() == \
            JMeshConfig(**mc).resolved(8).as_dict()


def test_rules_and_specs_are_the_reference_partition_specs():
    """TRANSFORMER_RULES and ACTIVATION_RULES are the reference's tables;
    param_specs fits them to each leaf's rank as the reference's does."""
    from ray_tpu.models import gpt2 as jgpt2
    assert tmesh.TRANSFORMER_RULES == [(pat, tuple(spec)) for pat, spec
                                       in jmesh.TRANSFORMER_RULES]
    assert tmesh.ACTIVATION_RULES == jmesh.ACTIVATION_RULES
    params = jax.eval_shape(lambda: jgpt2.init_params(
        jax.random.key(0), jgpt2.tiny()))
    want = jax.tree_util.tree_leaves(
        jmesh.param_specs(params), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    tree = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), params)
    got = tspmd._spec_leaves(tmesh.param_specs(tree))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert tmesh.batch_spec(tmesh.MeshConfig(data=2, context=2)) == \
        tuple(jmesh.batch_spec(JMeshConfig(data=2, context=2)))


@pytest.mark.parametrize("axes", [{"data": 2, "tensor": 2},
                                  {"pipeline": 2, "tensor": 2},
                                  {"data": 1, "tensor": 4}],
                         ids=["data-tensor", "pipeline-tensor", "tensor4"])
def test_every_rank_slice_is_the_named_sharding_shard(pool, axes):
    """``shard_params`` on each rank equals the shard JAX's
    NamedSharding places on the device at the rank's coordinates (the
    same spec), and the slices gather back to the global tree and place
    again (``gather_to_host`` / ``put_global`` with specs)."""
    from ray_tpu.models import gpt2 as jgpt2
    cfg = jgpt2.GPT2Config(vocab_size=128, n_positions=32, n_embd=64,
                           n_layer=2, n_head=4)
    params = jax.tree_util.tree_map(
        np.asarray, jgpt2.init_params(jax.random.key(0), cfg))
    mc = JMeshConfig(**{"data": 1, **axes})
    jm = jmesh.build_mesh(mc, jax.devices()[:mc.num_devices])
    shardings = jmesh.named_shardings(jm, jmesh.param_specs(params))
    for r in pool.run(pool_lib.rank_shard_params, axes, params):
        dev = jm.devices[tuple(r["coords"][a] for a in jmesh.AXES)]
        for (path, leaf), got, back, sh in zip(
                jax.tree_util.tree_leaves_with_path(params),
                jax.tree_util.tree_leaves(r["local"]),
                jax.tree_util.tree_leaves(r["back"]),
                jax.tree_util.tree_leaves(shardings)):
            idx = sh.addressable_devices_indices_map(leaf.shape)[dev]
            np.testing.assert_array_equal(got, leaf[idx], err_msg=str(path))
            np.testing.assert_array_equal(back, leaf, err_msg=str(path))
        assert r["placed_again"]


def test_uneven_dims_cut_in_ceil_pieces():
    """A dim that does not divide (GPT-2's vocab 50257 over tensor=2) is
    cut in ceil-sized pieces, the last one short."""
    assert [tmesh.shard_bounds(50257, 2, i) for i in (0, 1)] == \
        [(0, 25129), (25129, 50257)]
    assert [tmesh.shard_bounds(10, 4, i) for i in range(4)] == \
        [(0, 3), (3, 6), (6, 9), (9, 10)]


@pytest.mark.parametrize("axis", ["fsdp", "expert"])
def test_deferred_axes_raise_naming_item_8b(pool, axis):
    """``fsdp`` and ``expert`` (ZeRO-3, expert parallelism) build a mesh
    now: with ``data=2`` every rank's coordinates are its row-major
    place in the (data, axis) grid and each live axis's group holds the
    ranks that differ only along it.  What item 8b still defers, an
    ``fsdp`` that shares its spec entry with another axis (with
    ``tensor``, or with ``expert``; no rule table of the reference
    writes one), raises naming item 8b and the spec."""
    shared = {"fsdp": ["fsdp", "tensor"], "expert": ["expert", "fsdp"]}[
        axis]
    grid = np.arange(4).reshape(2, 2)
    for rank, r in enumerate(pool.run(pool_lib.rank_axis_mesh,
                                      {"data": 2, axis: 2}, shared)):
        d, a = np.unravel_index(rank, (2, 2))
        assert {k: v for k, v in r["coords"].items() if v} == \
            {k: v for k, v in {"data": d, axis: a}.items() if v}
        assert r["groups"] == {"data": [int(x) for x in grid[:, a]],
                               axis: [int(x) for x in grid[d]]}
        assert r["error"] is not None and "item 8b" in r["error"] \
            and repr(tuple(shared)) in r["error"], r["error"]


def test_device_group_matches_xla_group(pool):
    """Each op with rank r's tensor = row r of the stacked input equals
    the XlaCollectiveGroup's row r of the same op."""
    rows = np.arange(4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    xg = XlaCollectiveGroup(jax.devices()[:4])
    want = {"allreduce": np.asarray(xg.allreduce(rows)),
            "allreduce_max": np.asarray(xg.allreduce(rows, "max")),
            "allgather": np.asarray(xg.allgather(rows)),
            "reducescatter": np.asarray(xg.reducescatter(rows)),
            "alltoall": np.asarray(xg.alltoall(rows))}
    for r in pool.run(pool_lib.rank_device_group, rows):
        assert r["transport"] == "gloo"
        for op, w in want.items():
            np.testing.assert_array_equal(r[op], w[r["rank"]], err_msg=op)
        np.testing.assert_array_equal(r["broadcast"], rows[1])


def test_collective_api_over_the_device_backend(pool):
    rows = np.arange(4 * 5, dtype=np.float32).reshape(4, 5)
    res = pool.run(pool_lib.rank_collective_api, rows)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["allreduce"], rows.sum(0))
        assert (out["rank"], out["size"], out["after"]) == (r, 4, False)
    np.testing.assert_array_equal(res[1]["recv"], rows[0] * 3)


def test_multihost_allreduce_rides_the_domain_device_group(pool):
    """``multihost.allreduce`` (the elastic loop's and data-parallel
    programs' gradient sum) goes through the domain's device group: each
    leaf comes back in its dtype, the group's transport is the
    placement's, and its legs are the group's timers."""
    rows = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for out in pool.run(pool_lib.rank_multihost_allreduce, rows):
        np.testing.assert_array_equal(out["mean"], rows.mean(0))
        np.testing.assert_array_equal(out["sum"], rows.sum(0))
        assert out["mean_dtypes"] == ["torch.float32", "torch.float64"]
        assert out["transport"] == "gloo"
        assert out["legs"] == ["to_device", "to_host", "wire"]


def test_transport_by_placement(pool):
    """CPU ranks: gloo; ranks on cards of their own: NCCL; ranks sharing
    a card: the staged transport, and NCCL asked for there raises (it
    never switches).  The card placements are the rule's inputs: this
    box has no card."""
    assert pool.run(pool_lib.rank_transport, "cpu", None) == ["gloo"] * 4
    for got in pool.run(pool_lib.rank_transport, "cpu", "nccl"):
        assert got.startswith("ValueError") and "needs a card" in got
    own = [("h", "GPU-a"), ("h", "GPU-b")]
    shared = [("h", "GPU-a"), ("h", "GPU-a")]
    assert transport_for(own, "cuda") == "nccl"
    assert transport_for(shared, "cuda") == "staged"
    assert transport_for(own, "cuda", "staged") == "staged"
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        transport_for(shared, "cuda", "nccl")
    with pytest.raises(ValueError, match="host tensors"):
        transport_for(own, "cuda", "gloo")


def test_ambient_mesh_reaches_the_autograd_threads():
    """A CUDA backward (and every checkpointed block's replay in it) runs
    on the autograd engine's device thread, which does not see the
    caller's contextvars: the ambient mesh must reach it all the same."""
    import threading
    mesh = tmesh.single_device_mesh("cpu")
    seen = []
    with tmesh.ambient_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(
            tmesh.get_ambient_mesh()))
        t.start()
        t.join()
    assert seen == [mesh]
    assert tmesh.get_ambient_mesh() is None
