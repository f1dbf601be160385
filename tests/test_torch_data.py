"""The port's Ray Data (``ray_tpu_torch.data``) on its own runtime, held to
the reference's data tests (``tests/test_data.py``) one to one, plus what
the port adds: ``iter_device_batches`` on the CPU (writable tensors, the
reference's prefetch order) and its refusals (no card with
``device=None``, a ``sharding``), stage tasks that never ride a GPU
worker, a shard read twice in a train worker, and an import that needs
neither pyarrow nor pandas.

Tests share one cluster (``cluster``: ``num_cpus=4`` and one card faked
with ``num_gpus=1``, so the data tasks' routing is checked with a GPU
in the cluster).  Functions here are pickled by value, so spawned workers
never import this module.
"""

import logging
import os
import subprocess
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import rtlog

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    """One cluster for the module; the package logger is handed back as
    it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4, num_gpus=1)
    yield
    rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


class TestConstructors:
    def test_range(self, cluster):
        ds = rd.range(100, override_num_blocks=4)
        assert ds.count() == 100
        assert ds.num_blocks() == 4
        assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]

    def test_from_items_dicts(self, cluster):
        ds = rd.from_items([{"a": i, "b": str(i)} for i in range(10)])
        rows = ds.take_all()
        assert len(rows) == 10
        assert rows[0]["a"] == 0 and rows[0]["b"] == "0"

    def test_from_items_scalars(self, cluster):
        ds = rd.from_items([1, 2, 3])
        assert [r["item"] for r in ds.take_all()] == [1, 2, 3]

    def test_from_numpy(self, cluster):
        ds = rd.from_numpy(np.arange(12).reshape(6, 2))
        assert ds.count() == 6

    def test_from_pandas(self, cluster):
        pd = pytest.importorskip("pandas")
        ds = rd.from_pandas(pd.DataFrame({"x": [1, 2, 3]}))
        assert [r["x"] for r in ds.take_all()] == [1, 2, 3]


class TestTransforms:
    def test_map(self, cluster):
        ds = rd.range(10).map(lambda r: {"id": r["id"] * 2})
        assert [r["id"] for r in ds.take(3)] == [0, 2, 4]

    def test_map_batches_numpy(self, cluster):
        ds = rd.range(10, override_num_blocks=2).map_batches(
            lambda b: {"id": b["id"] + 100})
        assert ds.take(2) == [{"id": 100}, {"id": 101}]

    def test_map_batches_pandas(self, cluster):
        pytest.importorskip("pandas")

        def f(df):
            df["y"] = df["id"] * 3
            return df
        ds = rd.range(6).map_batches(f, batch_format="pandas")
        assert ds.take(2) == [{"id": 0, "y": 0}, {"id": 1, "y": 3}]

    def test_filter(self, cluster):
        ds = rd.range(20).filter(lambda r: r["id"] % 2 == 0)
        assert ds.count() == 10

    def test_flat_map(self, cluster):
        ds = rd.from_items([1, 2]).flat_map(
            lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}])
        assert [r["v"] for r in ds.take_all()] == [1, 10, 2, 20]

    def test_fusion_single_wave(self, cluster):
        ds = (rd.range(50, override_num_blocks=5)
              .map(lambda r: {"id": r["id"] + 1})
              .filter(lambda r: r["id"] % 2 == 0)
              .map(lambda r: {"id": r["id"] * 10}))
        vals = [r["id"] for r in ds.take_all()]
        assert vals[:3] == [20, 40, 60]

    def test_select_drop_rename(self, cluster):
        ds = rd.from_items([{"a": 1, "b": 2, "c": 3}])
        assert ds.select_columns(["a", "b"]).columns() == ["a", "b"]
        assert ds.drop_columns(["a"]).columns() == ["b", "c"]
        assert ds.rename_columns({"a": "z"}).take(1)[0]["z"] == 1


class TestShuffles:
    def test_repartition(self, cluster):
        ds = rd.range(100, override_num_blocks=2).repartition(5)
        assert ds.num_blocks() == 5
        assert ds.count() == 100

    def test_random_shuffle(self, cluster):
        ds = rd.range(100, override_num_blocks=4).random_shuffle(seed=7)
        vals = [r["id"] for r in ds.take_all()]
        assert sorted(vals) == list(range(100))
        assert vals != list(range(100))

    def test_sort(self, cluster):
        rng = np.random.default_rng(0)
        items = [{"k": int(x)} for x in rng.permutation(200)]
        ds = rd.from_items(items, override_num_blocks=4).sort("k")
        vals = [r["k"] for r in ds.take_all()]
        assert vals == sorted(vals)

    def test_sort_descending(self, cluster):
        ds = rd.from_items([{"k": i} for i in [3, 1, 2]]).sort(
            "k", descending=True)
        assert [r["k"] for r in ds.take_all()] == [3, 2, 1]

    def test_groupby_agg(self, cluster):
        items = [{"g": i % 3, "v": i} for i in range(12)]
        ds = rd.from_items(items, override_num_blocks=3)
        out = {r["g"]: r["sum(v)"]
               for r in ds.groupby("g").sum("v").take_all()}
        assert out == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}

    def test_groupby_string_keys_cross_process(self, cluster):
        # hash() is salted per process: the partition hash must not be
        items = [{"g": f"key{i % 2}", "v": 1} for i in range(10)]
        ds = rd.from_items(items, override_num_blocks=4)
        out = ds.groupby("g").count().take_all()
        assert sorted(r["count()"] for r in out) == [5, 5]

    def test_map_groups(self, cluster):
        items = [{"g": i % 2, "v": float(i)} for i in range(8)]
        ds = rd.from_items(items, override_num_blocks=2)
        out = ds.groupby("g").map_groups(
            lambda grp: {"g": grp["g"][:1], "n": np.array([len(grp["v"])])})
        assert sorted(r["n"] for r in out.take_all()) == [4, 4]


class TestCombination:
    def test_union(self, cluster):
        ds = rd.range(5).union(rd.range(5))
        assert ds.count() == 10

    def test_zip(self, cluster):
        a = rd.range(6, override_num_blocks=2)
        b = rd.range(6, override_num_blocks=3).map(
            lambda r: {"other": r["id"] * 2})
        rows = a.zip(b).take_all()
        assert all(r["other"] == 2 * r["id"] for r in rows)

    def test_limit(self, cluster):
        assert rd.range(100, override_num_blocks=5).limit(13).count() == 13


class TestSplits:
    def test_split_blocks(self, cluster):
        shards = rd.range(100, override_num_blocks=4).split(2)
        assert sum(s.count() for s in shards) == 100

    def test_split_equal(self, cluster):
        shards = rd.range(10, override_num_blocks=3).split(2, equal=True)
        assert [s.count() for s in shards] == [5, 5]

    def test_split_at_indices(self, cluster):
        parts = rd.range(10).split_at_indices([3, 7])
        assert [p.count() for p in parts] == [3, 4, 3]

    def test_train_test_split(self, cluster):
        tr, te = rd.range(10).train_test_split(0.3)
        assert tr.count() == 7 and te.count() == 3


class TestConsumption:
    def test_iter_batches_sizes(self, cluster):
        ds = rd.range(25, override_num_blocks=3)
        sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=10)]
        assert sizes == [10, 10, 5]
        sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=10,
                                                       drop_last=True)]
        assert sizes == [10, 10]

    def test_iter_batches_order(self, cluster):
        ds = rd.range(30, override_num_blocks=4)
        seen = []
        for b in ds.iter_batches(batch_size=7):
            seen.extend(b["id"].tolist())
        assert seen == list(range(30))

    def test_iter_torch_batches(self, cluster):
        import torch
        ds = rd.range(8)
        b = next(ds.iter_torch_batches(batch_size=4))
        assert isinstance(b["id"], torch.Tensor)

    def test_iter_device_batches(self, cluster):
        """The reference's test at ``device="cpu"``: plain, writable CPU
        tensors with the block's values and dtype, an object column left
        numpy, and no warning about the store's read-only arrays."""
        import warnings

        import torch
        ds = rd.range(16).map_batches(lambda b: {
            "id": b["id"], "x": b["id"].astype(np.float32) / 2,
            "tag": np.array([f"t{i}" for i in b["id"]], dtype=object)})
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            batches = list(ds.iter_device_batches(batch_size=8,
                                                  device="cpu"))
        assert len(batches) == 2
        assert isinstance(batches[0]["id"], torch.Tensor)
        assert batches[0]["id"].device.type == "cpu"
        assert batches[0]["id"].dtype == torch.int64
        assert batches[1]["x"].dtype == torch.float32
        assert torch.cat([b["id"] for b in batches]).tolist() == \
            list(range(16))
        assert batches[1]["x"].tolist() == [i / 2 for i in range(8, 16)]
        assert isinstance(batches[0]["tag"], np.ndarray)
        assert batches[0]["tag"].tolist() == [f"t{i}" for i in range(8)]
        batches[0]["id"].add_(1)                  # writable, not the store

    def test_schema_and_size(self, cluster):
        ds = rd.range(10)
        assert "id" in ds.schema()
        assert ds.size_bytes() >= 10 * 8


class TestIO:
    def test_parquet_roundtrip(self, cluster, tmp_path):
        pytest.importorskip("pyarrow")
        ds = rd.range(20, override_num_blocks=2)
        ds.write_parquet(str(tmp_path / "pq"))
        back = rd.read_parquet(str(tmp_path / "pq"))
        assert back.count() == 20
        assert sorted(r["id"] for r in back.take_all()) == list(range(20))

    def test_csv_roundtrip(self, cluster, tmp_path):
        pytest.importorskip("pandas")
        rd.from_items([{"a": 1, "b": "x"}]).write_csv(str(tmp_path / "csv"))
        back = rd.read_csv(str(tmp_path / "csv"))
        assert back.take_all() == [{"a": 1, "b": "x"}]

    def test_read_text(self, cluster, tmp_path):
        f = tmp_path / "t.txt"
        f.write_text("hello\nworld\n")
        ds = rd.read_text(str(f))
        assert [r["text"] for r in ds.take_all()] == ["hello", "world"]


class TestTrainIntegration:
    def test_dataset_shard_in_trainer(self, cluster, tmp_path):
        from ray_tpu_torch import train
        from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                         ScalingConfig)

        def loop(config):
            shard = train.get_dataset_shard("train")
            total = sum(int(b["id"].sum())
                        for b in shard.iter_batches(batch_size=8))
            train.report({"total": total})

        trainer = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=str(tmp_path)),
            datasets={"train": rd.range(20, override_num_blocks=4)})
        res = trainer.fit()
        assert res.error is None


def test_global_aggregates_and_sample(cluster):
    ds = rd.from_items([{"x": i, "y": i % 3} for i in range(100)]) \
             .repartition(4)
    assert ds.sum("x") == sum(range(100))
    assert ds.min("x") == 0 and ds.max("x") == 99
    assert abs(ds.mean("x") - 49.5) < 1e-9
    assert abs(ds.std("x") - np.std(np.arange(100), ddof=1)) < 1e-9
    assert sorted(ds.unique("y")) == [0, 1, 2]
    n = ds.random_sample(0.5, seed=0).count()
    assert 20 < n < 80, n


# ------------------------------------------------------ the port's additions
def test_iter_device_batches_refuses_without_a_card(cluster):
    """``device=None`` is the card: with none it raises, it never drops to
    the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(rd.range(16).iter_device_batches(batch_size=8))


def test_iter_device_batches_refuses_a_sharding(cluster):
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        next(rd.range(16).iter_device_batches(batch_size=8, device="cpu",
                                              sharding=object()))


def test_iter_device_batches_prefetch_order(cluster):
    """The reference's order: a batch is yielded once more than
    ``prefetch`` batches are staged, so staging stays ``prefetch`` batches
    ahead of the consumer (one more may be staging on the iterator's
    thread), and the last ones drain."""
    ds = rd.range(40, override_num_blocks=5)
    pulled = []
    real = rd.Dataset.iter_batches

    def counting(self, **kw):
        for b in real(self, **kw):
            pulled.append(int(b["id"][0]))
            yield b
    try:
        rd.Dataset.iter_batches = counting
        it = ds.iter_device_batches(batch_size=8, device="cpu", prefetch=2)
        first = next(it)
        assert int(first["id"][0]) == 0
        assert pulled[:3] == [0, 8, 16] and len(pulled) <= 4
        second = next(it)
        assert int(second["id"][0]) == 8
        assert pulled[:4] == [0, 8, 16, 24] and len(pulled) <= 5
        rest = [int(b["id"][0]) for b in it]
    finally:
        rd.Dataset.iter_batches = real
    assert rest == [16, 24, 32] and pulled == [0, 8, 16, 24, 32]


def _ingest_threads() -> list:
    import threading
    return [t for t in threading.enumerate()
            if t.name == "data-device-ingest"]


def test_iter_device_batches_raises_a_stage_error(cluster):
    """An error while a batch is made or staged (here a map task's) is
    raised in the consumer, and the staging thread ends."""
    def boom(b):
        if b["id"][0] >= 8:
            raise ValueError("stage error")
        return b

    it = rd.range(24, override_num_blocks=3).map_batches(boom) \
        .iter_device_batches(batch_size=8, device="cpu", prefetch=1)
    with pytest.raises(Exception, match="stage error"):
        list(it)
    assert not _ingest_threads()


def test_iter_device_batches_closed_early_stops_its_thread(cluster):
    """A consumer that stops after one batch stops the staging thread;
    a second pass over the same Dataset gives the same batches."""
    ds = rd.range(48, override_num_blocks=6).materialize()
    it = ds.iter_device_batches(batch_size=8, device="cpu")
    assert next(it)["id"].tolist() == list(range(8))
    it.close()
    assert not _ingest_threads()
    again = [b["id"].tolist() for b in ds.iter_device_batches(
        batch_size=8, device="cpu")]
    assert again == [list(range(i, i + 8)) for i in range(0, 48, 8)]


def test_stage_tasks_ride_no_gpu_worker(cluster):
    """Read, fused map, shuffle and unfused map tasks run in plain workers
    (no card visible, not a GPU worker), with a GPU in the cluster."""
    assert rt.cluster_resources().get("GPU") == 1

    def tag(b, _stage):
        n = len(b["id"])
        b[f"cvd_{_stage}"] = np.array(
            [os.environ.get("CUDA_VISIBLE_DEVICES", "unset")] * n)
        b[f"gpu_{_stage}"] = np.array(
            [os.environ.get("RTT_GPU_WORKER", "")] * n)
        return b

    rows = (rd.range(16, override_num_blocks=4)
            .map_batches(lambda b: tag(b, "read"))
            .repartition(3)
            .map_batches(lambda b: tag(b, "map"), fuse=False)
            .take_all())
    assert sorted(r["id"] for r in rows) == list(range(16))
    for stage in ("read", "map"):
        assert {str(r[f"cvd_{stage}"]) for r in rows} == {""}, stage
        assert {str(r[f"gpu_{stage}"]) for r in rows} == {""}, stage


def test_shard_read_twice_in_worker(cluster, tmp_path):
    """Two epochs over a train worker's shard give the same batches, the
    blocks read from the store as a borrower of the driver's refs."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    def loop(config):
        shard = train.get_dataset_shard("train")
        epochs = [[b["id"].tolist() for b in shard.iter_device_batches(
            batch_size=6, device="cpu")] for _ in range(2)]
        train.report({"epochs": epochs})

    ds = rd.range(20, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 3})
    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path)),
        datasets={"train": ds}).fit()
    assert res.error is None
    first, second = res.metrics["epochs"]
    assert first == second
    assert [len(b) for b in first] == [6, 6, 6, 2]
    assert sum(first, []) == [3 * i for i in range(20)]


def test_one_block_a_batch_is_not_copied(cluster):
    """Blocks of exactly ``batch_size`` rows reach the consumer as the
    store's own arrays (read-only views, no concatenation): the path the
    card's ingest keeps, one host copy into pinned memory.  The blocks
    (1.28 MB) are above the slab's limit, so each has a segment of its
    own, mapped read-only."""
    ds = rd.range(24, override_num_blocks=3).map_batches(lambda b: {
        "id": b["id"], "x": np.ones((len(b["id"]), 40_000), np.float32)
        * b["id"][:, None]}).materialize()
    batches = list(ds.iter_batches(batch_size=8))
    assert [b["id"].tolist() for b in batches] == \
        [list(range(i, i + 8)) for i in (0, 8, 16)]
    assert all(not b["x"].flags.writeable for b in batches)
    assert [b["x"][:, 0].tolist() for b in batches] == \
        [list(range(i, i + 8)) for i in (0, 8, 16)]
    carried = list(ds.iter_batches(batch_size=12))   # across blocks: copies
    assert [b["x"].flags.writeable for b in carried] == [True, True]


def test_import_needs_neither_pyarrow_nor_pandas():
    """As on the card's machine: with pyarrow and pandas unimportable the
    package imports, builds and concatenates numpy blocks, and refuses
    only the conversions that need them; importing it loads no torch."""
    code = "\n".join([
        "import sys",
        "sys.modules['pyarrow'] = None",
        "sys.modules['pandas'] = None",
        "import ray_tpu_torch.data as rd",
        "from ray_tpu_torch.data.block import (BlockAccessor,",
        "    block_from_rows, concat_blocks)",
        "from ray_tpu_torch.data._internal.aggregate import apply_groupby",
        "assert 'torch' not in sys.modules",
        "b = block_from_rows([{'k': i % 2, 'v': float(i)} for i in range(6)])",
        "assert BlockAccessor(concat_blocks([b, b])).num_rows() == 12",
        "g = apply_groupby(b, 'k', [('sum', 'v', 's')])",
        "assert g['s'].tolist() == [6.0, 9.0]",
        "for fmt in ('pandas', 'pyarrow'):",
        "    try:",
        "        BlockAccessor(b).to_batch(fmt)",
        "    except ImportError:",
        "        print('refused', fmt)",
        "print('ok')"])
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["refused", "pandas", "refused",
                                  "pyarrow", "ok"]
