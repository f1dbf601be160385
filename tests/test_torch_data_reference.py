"""The port's Ray Data held to the JAX package's: the committed outputs
of ``tests/data_reference.py`` (``tests/data/data_reference.json``), the
slice as a whole on the CPU (a tiny GPT-2 trained by ``TorchTrainer``
from a token Dataset through ``iter_device_batches(device="cpu")``), and
both packages' block accessors and aggregate helpers on the same blocks.

Tolerances: row orders and integer columns exactly, float aggregates
within 1e-12 (the same numpy reductions in the same order on both
sides); the GPT-2 losses within 1e-4 relative, the limit
``tests/test_torch_train_parity.py`` sets for the same train program
(float32, sums in other orders).  The regenerated file must equal the
committed one: the same keys and integers, floats within 1e-12 and the
XLA-computed losses within 1e-6 relative (another host's CPU may sum in
another order; a hand-edited or stale file moves them by far more).
"""

import json
import logging
import os
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import chip_smoke
import data_reference as ref
import ray_tpu_torch as rt
from chip_smoke import data_gpt2_loop, host_checksums
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import rtlog
from ray_tpu_torch.data import block as tblock
from ray_tpu_torch.data._internal import aggregate as tagg
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

from ray_tpu.data import block as jblock
from ray_tpu.data._internal import aggregate as jagg

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(chip_smoke)

FLOAT_TOL = 1e-12
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def committed():
    return json.loads(ref.PATH.read_text())


@pytest.fixture(scope="module")
def cluster():
    """The port's cluster for the module; the package logger is handed
    back as it was (``init`` stops its propagation)."""
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


def _assert_pipeline(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if key in ("group_mean_v", "group_std_v"):
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=key)
        elif key == "aggregates":
            assert list(g) == list(w)
            for a, wv in w.items():
                if isinstance(wv, float):
                    np.testing.assert_allclose(g[a], wv, rtol=FLOAT_TOL,
                                               atol=FLOAT_TOL, err_msg=a)
                else:
                    assert g[a] == wv, a
        else:
            assert g == w, key


def test_reference_file_is_what_the_generator_writes(committed):
    fresh = json.loads(json.dumps(ref.outputs()))
    assert committed["seed"] == fresh["seed"] == ref.SEED
    assert ref.PATH.stat().st_size < 50_000
    _assert_pipeline(fresh["pipeline"], committed["pipeline"])
    g, c = fresh["gpt2_tiny"], committed["gpt2_tiny"]
    assert {k: v for k, v in g.items() if k != "losses"} == \
        {k: v for k, v in c.items() if k != "losses"}
    np.testing.assert_allclose(g["losses"], c["losses"], rtol=1e-6)


def test_port_pipeline_matches_the_reference_file(cluster, committed):
    """The same pipeline through the port's Data on its runtime: every
    order and integer exactly, every float within 1e-12."""
    _assert_pipeline(ref.run_pipeline(rd), committed["pipeline"])


def test_gpt2_tiny_from_a_token_dataset_matches_jax(cluster, committed,
                                                    tmp_path):
    """The slice on the CPU: chip_smoke's ``data_gpt2_loop`` in a train
    worker reads ``iter_device_batches(device="cpu")`` from the token
    Dataset and trains the tiny GPT-2 from the JAX package's init; its
    losses within 1e-4 of the JAX package's committed ones, its batches'
    checksums those of the driver's numpy batches; the same Dataset
    shifted by one row must fail both."""
    rec = committed["gpt2_tiny"]
    cfg = ref.gpt2_config(tgpt2, torch.float32)
    tokens = ref.token_dataset(rd).materialize()
    host = [{k: np.array(v) for k, v in b.items()}
            for b in tokens.iter_batches(batch_size=rec["rows"])]
    assert [h["tokens"].shape for h in host] == \
        [(rec["rows"], rec["seq"] + 1)] * rec["batches"]
    whole = np.concatenate([h["tokens"] for h in host])
    shifted = rd.from_numpy(np.roll(whole, -1, axis=0),
                            override_num_blocks=rec["batches"]
                            ).rename_columns({"item": "tokens"})
    result = TorchTrainer(
        data_gpt2_loop, train_loop_config={
            "names": ["train", "shifted"], "device": "cpu", "cfg": cfg,
            "tree": ref.jax_init_tree(), "batch_size": rec["rows"]},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path)),
        datasets={"train": tokens, "shifted": shifted}).fit()
    assert result.error is None
    row = result.metrics
    assert row["device"] == "cpu" and row["pid"] != os.getpid()
    sums = [host_checksums(h) for h in host]
    np.testing.assert_allclose(row["train"]["losses"], rec["losses"],
                               rtol=LOSS_RTOL)
    assert row["train"]["sums"] == sums
    control = np.abs(np.array(row["shifted"]["losses"])
                     - np.array(rec["losses"])) / np.abs(rec["losses"])
    assert control.min() > LOSS_RTOL
    assert all(a != b for a, b in zip(row["shifted"]["sums"], sums))


def _blocks(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"id": np.arange(n, dtype=np.int64) + 100 * i,
             "k": rng.integers(0, 4, n),
             "v": rng.standard_normal(n),
             "emb": rng.standard_normal((n, 3)).astype(np.float32)}
            for i, n in enumerate((7, 0, 5, 9))]


def _same(a, b) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_block_accessors_and_aggregates_agree_with_jax_package(seed):
    """Both packages' pure block functions on the same seeded blocks:
    accessors, concatenation, row builders, batch conversion and the
    groupby kernels give equal arrays (dtype included)."""
    blocks = _blocks(seed)
    idx = np.array([4, 0, 2])
    for b in blocks:
        j, t = jblock.BlockAccessor(b), tblock.BlockAccessor(b)
        assert t.num_rows() == j.num_rows()
        assert t.size_bytes() == j.size_bytes()
        assert t.columns() == j.columns() and t.schema() == j.schema()
        if not j.num_rows():
            continue
        _same(t.slice(1, 4), j.slice(1, 4))
        _same(t.take_idx(idx[idx < j.num_rows()]),
              j.take_idx(idx[idx < j.num_rows()]))
        _same(t.select(["v", "id"]), j.select(["v", "id"]))
        _same(t.drop(["emb"]), j.drop(["emb"]))
        _same(t.rename({"v": "x"}), j.rename({"v": "x"}))
        _same(t.with_column("w", b["id"] * 2), j.with_column("w", b["id"] * 2))
        _same(t.merge(b), j.merge(b))
        assert [list(map(repr, r.values())) for r in t.iter_rows()] == \
            [list(map(repr, r.values())) for r in j.iter_rows()]
        for on in ("v", "id"):
            aggs = [(name, on, f"{name}({on})") for name in
                    ("count", "sum", "min", "max", "mean", "std")]
            _same(tagg.apply_groupby(b, "k", aggs),
                  jagg.apply_groupby(b, "k", aggs))
    _same(tblock.concat_blocks(blocks), jblock.concat_blocks(blocks))
    rows = [{"a": int(i), "s": f"r{i}", "e": np.arange(2.0) * i}
            for i in range(5)]
    _same(tblock.block_from_rows(rows, "numpy"),
          jblock.block_from_rows(rows, "numpy"))
    _same(tblock.block_from_rows(list(range(4)), "numpy"),
          jblock.block_from_rows(list(range(4)), "numpy"))
    ragged = [[1], [1, 2]]
    t_obj = tblock.block_from_rows(ragged, "numpy")["item"]
    j_obj = jblock.block_from_rows(ragged, "numpy")["item"]
    assert t_obj.dtype == j_obj.dtype == object
    assert t_obj.tolist() == j_obj.tolist()
    arr = np.arange(6).reshape(3, 2)
    _same(tblock.BlockAccessor.batch_to_block(arr, "numpy"),
          jblock.BlockAccessor.batch_to_block(arr, "numpy"))
    _same(tblock.BlockAccessor.batch_to_block({"x": [1, 2]}, "numpy"),
          jblock.BlockAccessor.batch_to_block({"x": [1, 2]}, "numpy"))
