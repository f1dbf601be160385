"""Dataset constructors.

Reference: ``python/ray/data/read_api.py`` — ``range``/``from_items``/
``read_parquet``/``read_csv``/``read_json``/``read_text``/
``read_binary_files``/``read_numpy``/``from_pandas``/``from_numpy``/
``from_arrow``.  Reads are lazy: each file/partition becomes a read-task
factory fused with downstream maps (execution.py).
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.data._internal.execution import ReadStage
from ray_tpu_torch.data.block import VALUE_COL, Block, BlockAccessor, block_from_rows
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset


def _n_blocks(total: int, override: Optional[int]) -> int:
    n = override or DataContext.get_current().default_parallelism
    return max(1, min(n, total)) if total else 1


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    nb = _n_blocks(n, override_num_blocks)
    bounds = np.linspace(0, n, nb + 1).astype(int)
    fmt = DataContext.get_current().block_format

    def mk(lo: int, hi: int):
        return lambda: BlockAccessor.batch_to_block(
            {"id": np.arange(lo, hi, dtype=np.int64)}, fmt)
    return Dataset([ReadStage([mk(bounds[i], bounds[i + 1])
                               for i in builtins.range(nb)], "ReadRange")])


def from_items(items: Sequence[Any], *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    items = list(items)
    nb = _n_blocks(len(items), override_num_blocks)
    bounds = np.linspace(0, len(items), nb + 1).astype(int)
    fmt = DataContext.get_current().block_format

    def mk(chunk: List[Any]):
        return lambda: block_from_rows(chunk, fmt)
    return Dataset([ReadStage(
        [mk(items[bounds[i]:bounds[i + 1]]) for i in builtins.range(nb)],
        "FromItems")])


def from_numpy(arr: np.ndarray, *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    nb = _n_blocks(len(arr), override_num_blocks)
    chunks = np.array_split(arr, nb)

    def mk(c: np.ndarray):
        return lambda: {VALUE_COL: c}
    return Dataset([ReadStage([mk(c) for c in chunks], "FromNumpy")])


def from_pandas(df: Any, *,
                override_num_blocks: Optional[int] = None) -> Dataset:
    block = BlockAccessor.batch_to_block(df)
    return _from_block(block, override_num_blocks, "FromPandas")


def from_arrow(table: Any, *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    block = BlockAccessor.batch_to_block(table)
    return _from_block(block, override_num_blocks, "FromArrow")


def _from_block(block: Block, override: Optional[int], name: str) -> Dataset:
    acc = BlockAccessor(block)
    nb = _n_blocks(acc.num_rows(), override)
    bounds = np.linspace(0, acc.num_rows(), nb + 1).astype(int)

    def mk(lo: int, hi: int):
        return lambda: acc.slice(lo, hi)
    return Dataset([ReadStage([mk(bounds[i], bounds[i + 1])
                               for i in builtins.range(nb)], name)])


# ------------------------------------------------------------------- files
def _expand_paths(paths: Any, suffix: str = "") -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, f"*{suffix}"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def read_parquet(paths: Any, *, columns: Optional[List[str]] = None,
                 **_compat) -> Dataset:
    files = _expand_paths(paths, ".parquet")
    fmt = DataContext.get_current().block_format

    def mk(f: str):
        def read() -> Block:
            import pyarrow.parquet as pq
            # block_format="arrow": the parquet table IS the block — no
            # numpy conversion anywhere on the read path
            return BlockAccessor.batch_to_block(
                pq.read_table(f, columns=columns), fmt)
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadParquet")])


def read_csv(paths: Any, **_compat) -> Dataset:
    files = _expand_paths(paths, ".csv")
    fmt = DataContext.get_current().block_format

    def mk(f: str):
        def read() -> Block:
            import pandas as pd
            return BlockAccessor.batch_to_block(pd.read_csv(f), fmt)
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadCSV")])


def read_json(paths: Any, **_compat) -> Dataset:
    files = _expand_paths(paths, ".json")
    fmt = DataContext.get_current().block_format

    def mk(f: str):
        def read() -> Block:
            import pandas as pd
            return BlockAccessor.batch_to_block(
                pd.read_json(f, orient="records", lines=True), fmt)
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadJSON")])


def read_text(paths: Any, **_compat) -> Dataset:
    files = _expand_paths(paths)
    fmt = DataContext.get_current().block_format

    def mk(f: str):
        def read() -> Block:
            with open(f, "r") as fh:
                lines = [ln.rstrip("\n") for ln in fh]
            return block_from_rows([{"text": ln} for ln in lines], fmt)
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadText")])


def read_binary_files(paths: Any, **_compat) -> Dataset:
    files = _expand_paths(paths)
    fmt = DataContext.get_current().block_format

    def mk(f: str):
        def read() -> Block:
            with open(f, "rb") as fh:
                data = fh.read()
            return block_from_rows([{"path": f, "bytes": data}], fmt)
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadBinary")])


def read_numpy(paths: Any, **_compat) -> Dataset:
    files = _expand_paths(paths, ".npy")

    def mk(f: str):
        def read() -> Block:
            return {VALUE_COL: np.load(f)}
        return read
    return Dataset([ReadStage([mk(f) for f in files], "ReadNumpy")])
