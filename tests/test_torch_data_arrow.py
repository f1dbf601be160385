"""The port's Arrow block format, held to the reference's
``tests/test_data_arrow.py`` one to one.

Reference pattern: ``python/ray/data/tests/test_arrow_block.py`` — there
blocks ARE pyarrow Tables; here ``DataContext.block_format="arrow"``
switches every producer to Tables with zero-copy slice/concat, and the
two formats interoperate inside one pipeline.  The card's machine has no
pyarrow: the module skips without it.  Pipelines share one cluster
(``cluster``); functions here are pickled by value.
"""

import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu_torch import data as rd  # noqa: E402
from ray_tpu_torch._private import rtlog  # noqa: E402
from ray_tpu_torch.data.block import (ArrowBlockAccessor,  # noqa: E402
                                      BlockAccessor, concat_blocks)
from ray_tpu_torch.data.context import DataContext  # noqa: E402

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def cluster():
    """One cluster for the module; the package logger is handed back as
    it was (``init`` stops its propagation)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    if rt.is_initialized():
        rt.shutdown()
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


@pytest.fixture
def arrow_ctx():
    ctx = DataContext.get_current()
    prev = ctx.block_format
    ctx.block_format = "arrow"
    yield ctx
    ctx.block_format = prev


class TestAccessor:
    def test_dispatch(self):
        t = pa.table({"a": [1, 2, 3]})
        acc = BlockAccessor(t)
        assert isinstance(acc, ArrowBlockAccessor)
        assert acc.num_rows() == 3
        assert acc.columns() == ["a"]
        npacc = BlockAccessor({"a": np.arange(3)})
        assert not isinstance(npacc, ArrowBlockAccessor)

    def test_slice_zero_copy(self):
        t = pa.table({"a": np.arange(1000), "b": np.ones(1000)})
        acc = BlockAccessor(t)
        sl = acc.slice(100, 200)
        assert isinstance(sl, pa.Table)
        assert sl.num_rows == 100
        # zero-copy: the slice's buffer is the parent's buffer (offset view)
        parent_buf = t.column("a").chunk(0).buffers()[1]
        child_buf = sl.column("a").chunk(0).buffers()[1]
        assert child_buf.address >= parent_buf.address
        assert child_buf.address < parent_buf.address + parent_buf.size

    def test_concat_zero_copy_chunks(self):
        a = pa.table({"x": [1, 2]})
        b = pa.table({"x": [3, 4]})
        out = concat_blocks([a, b])
        assert isinstance(out, pa.Table)
        assert out.column("x").num_chunks == 2  # chunk-stitch, no copy
        assert out.column("x").to_pylist() == [1, 2, 3, 4]

    def test_concat_mixed_formats(self):
        out = concat_blocks([{"x": np.array([1, 2])}, pa.table({"x": [3]})])
        assert isinstance(out, pa.Table)
        assert out.column("x").to_pylist() == [1, 2, 3]

    def test_take_select_drop_rename_merge(self):
        t = pa.table({"a": [1, 2, 3, 4], "b": ["w", "x", "y", "z"]})
        acc = BlockAccessor(t)
        assert BlockAccessor(acc.take_idx(np.array([3, 0]))).to_batch(
            "numpy")["a"].tolist() == [4, 1]
        assert BlockAccessor(acc.select(["b"])).columns() == ["b"]
        assert BlockAccessor(acc.drop(["b"])).columns() == ["a"]
        assert BlockAccessor(acc.rename({"a": "c"})).columns() == ["c", "b"]
        m = acc.merge(pa.table({"a": [9, 9, 9, 9], "c": [0, 0, 0, 0]}))
        assert BlockAccessor(m).columns() == ["a", "b", "a_1", "c"]

    def test_tensor_columns(self):
        # image/embedding columns: ndim>1 numpy → FixedSizeList nests and
        # back, contiguous and shape-preserving
        emb = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
        blk = BlockAccessor.batch_to_block(
            {"id": np.arange(4), "emb": emb}, "arrow")
        assert isinstance(blk, pa.Table)
        acc = BlockAccessor(blk)
        out = acc.to_batch("numpy")["emb"]
        np.testing.assert_array_equal(out, emb)
        assert out.dtype == np.float32
        # slicing stays shape-correct through the offset view
        sl = BlockAccessor(acc.slice(1, 3)).to_batch("numpy")["emb"]
        np.testing.assert_array_equal(sl, emb[1:3])
        # with_column accepts tensors too
        b2 = acc.with_column("img", np.ones((4, 2, 2)))
        assert BlockAccessor(b2).to_batch("numpy")["img"].shape == (4, 2, 2)

    def test_tensor_columns_mixed_concat_and_rows(self):
        # mixed-format concat with a tensor column (union/zip/carry path)
        t = BlockAccessor.batch_to_block(
            {"img": np.ones((2, 2, 2), np.float32)}, "arrow")
        out = concat_blocks([t, {"img": np.zeros((3, 2, 2), np.float32)}])
        assert isinstance(out, pa.Table)
        merged = BlockAccessor(out).to_batch("numpy")["img"]
        assert merged.shape == (5, 2, 2) and merged.dtype == np.float32
        # row-built blocks stack ndarray fields into tensor columns
        from ray_tpu_torch.data.block import block_from_rows
        blk = block_from_rows(
            [{"emb": np.arange(3, dtype=np.float32) + i} for i in range(4)],
            "arrow")
        emb = BlockAccessor(blk).to_batch("numpy")["emb"]
        assert emb.shape == (4, 3) and emb.dtype == np.float32

    def test_batch_roundtrip(self):
        t = pa.table({"a": [1.5, 2.5]})
        acc = BlockAccessor(t)
        assert acc.to_batch("pyarrow") is t           # zero conversion
        np_b = acc.to_batch("numpy")
        assert np_b["a"].dtype == np.float64
        back = BlockAccessor.batch_to_block(np_b, "arrow")
        assert isinstance(back, pa.Table)
        assert BlockAccessor.batch_to_block(t, "arrow") is t


class TestPipelines:
    def test_from_items_and_transforms(self, cluster, arrow_ctx):
        ds = rd.from_items([{"a": i, "s": str(i)} for i in range(20)],
                           override_num_blocks=3)
        ds = ds.map_batches(lambda b: {"a": b["a"] * 2, "s": b["s"]})
        ds = ds.filter(lambda r: r["a"] % 4 == 0)
        rows = ds.take_all()
        assert [r["a"] for r in rows] == [0, 4, 8, 12, 16, 20, 24, 28, 32, 36]
        # blocks materialize as Tables
        ds2 = rd.range(10).materialize()
        blk = rt.get(ds2._cached_refs[0])
        assert isinstance(blk, pa.Table)

    def test_sort_groupby_shuffle(self, cluster, arrow_ctx):
        ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)],
                           override_num_blocks=4)
        agg = {r["k"]: r["sum(v)"]
               for r in ds.groupby("k").sum("v").take_all()}
        assert agg == {0: sum(float(i) for i in range(30) if i % 3 == 0),
                       1: sum(float(i) for i in range(30) if i % 3 == 1),
                       2: sum(float(i) for i in range(30) if i % 3 == 2)}
        s = ds.sort("v", descending=True).take(3)
        assert [r["v"] for r in s] == [29.0, 28.0, 27.0]
        assert sorted(r["v"] for r in
                      ds.random_shuffle(seed=7).take_all()) == \
            sorted(float(i) for i in range(30))

    def test_zip_and_union(self, cluster, arrow_ctx):
        a = rd.from_items([{"x": i} for i in range(8)])
        b = rd.from_items([{"y": i * 10} for i in range(8)])
        rows = a.zip(b).take_all()
        assert rows[3] == {"x": 3, "y": 30}
        assert a.union(b).count() == 16

    def test_parquet_roundtrip_no_numpy(self, cluster, arrow_ctx,
                                        tmp_path):
        src = pa.table({"a": np.arange(50, dtype=np.int64),
                        "txt": [f"r{i}" for i in range(50)]})
        import pyarrow.parquet as pq
        pq.write_table(src, os.path.join(tmp_path, "in.parquet"))
        ds = rd.read_parquet(str(tmp_path)).materialize()
        blk = rt.get(ds._cached_refs[0])
        assert isinstance(blk, pa.Table)       # table IS the block
        assert blk.schema.field("txt").type == pa.string()
        out_dir = str(tmp_path / "out")
        ds.write_parquet(out_dir)
        back = pq.read_table(out_dir + "/part-00000.parquet")
        assert back.column("a").to_pylist() == list(range(50))

    def test_schema_is_arrow_types(self, cluster, arrow_ctx):
        ds = rd.from_items([{"a": 1, "b": "x"}])
        sch = ds.schema()
        assert sch["a"] == pa.int64()
        assert sch["b"] == pa.string()

    def test_iter_batches_across_block_boundaries(self, cluster,
                                                  arrow_ctx):
        ds = rd.range(25, override_num_blocks=4)
        sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=7)]
        assert sizes == [7, 7, 7, 4]

    def test_numpy_pipeline_unaffected(self, cluster):
        # default context stays numpy-blocked
        ds = rd.range(5).materialize()
        blk = rt.get(ds._cached_refs[0])
        assert isinstance(blk, dict)
