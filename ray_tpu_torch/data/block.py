"""Blocks: the unit of distributed data.

Reference: ``python/ray/data/block.py`` — there a block is a pyarrow Table
in the object store.  Here the DEFAULT block is a dict of column-major
numpy arrays — zero-copy out of the shm object store (read-only views of
its segments) and copied once, into pinned memory, on the way to the card
(SURVEY.md §2.4 "GPU↔object store interop").

Blocks may ALSO be pyarrow Tables —
``DataContext.block_format = "arrow"`` makes every producer (row
builders, batch converters, parquet reads) emit Arrow, with zero-copy
``Table.slice`` / ``concat_tables`` and a schema'd tabular path, exactly
the reference's block representation.  ``BlockAccessor`` dispatches on
the block's type, so the two formats coexist in one dataset pipeline
(e.g. a parquet read in Arrow feeding a numpy-batch map).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], "pyarrow.Table"]  # noqa: F821
VALUE_COL = "item"  # column name for non-tabular datasets (reference: same)


def _is_arrow(block: Any) -> bool:
    return type(block).__module__.split(".")[0] == "pyarrow"


def _block_format() -> str:
    from ray_tpu_torch.data.context import DataContext
    return DataContext.get_current().block_format


def _as_array(values: List[Any]) -> np.ndarray:
    """Column from python values; object dtype for ragged/arbitrary rows."""
    try:
        return np.asarray(values)
    except Exception:  # noqa: BLE001 - truly heterogeneous
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr


def _col_to_numpy(col) -> np.ndarray:
    """Arrow column → numpy; tensor columns (FixedSizeList nests, see
    ``_np_to_arrow``) come back as contiguous (N, ...) ndarrays; object
    array for types numpy can't hold."""
    import pyarrow as pa
    col = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    shape = []
    while pa.types.is_fixed_size_list(col.type):
        shape.append(col.type.list_size)
        col = col.flatten()          # offset-aware: works on sliced views
    try:
        vals = col.to_numpy(zero_copy_only=False)
    except Exception:  # noqa: BLE001 - nested / union types
        vals = _as_array(col.to_pylist())
    if shape:
        return vals.reshape((-1, *shape))
    return vals


def _np_to_arrow(values: Any):
    """numpy (or listlike) → Arrow array; ndim>1 tensors become nested
    FixedSizeList columns (the Arrow tensor representation — numpy-block
    pipelines carrying image/embedding columns keep working when
    ``block_format="arrow"``)."""
    import pyarrow as pa
    a = values if isinstance(values, np.ndarray) else _as_array(list(values))
    if a.dtype == object:
        return pa.array(a.tolist())
    if a.ndim <= 1:
        return pa.array(a)
    out = pa.FixedSizeListArray.from_arrays(pa.array(a.reshape(-1)),
                                            a.shape[-1])
    for dim in reversed(a.shape[1:-1]):
        out = pa.FixedSizeListArray.from_arrays(out, dim)
    return out


def block_from_rows(rows: Sequence[Any],
                    block_format: Optional[str] = None) -> Block:
    """Rows (dicts or scalars) → block in the context's format."""
    fmt = block_format or _block_format()
    if not rows:
        return {} if fmt != "arrow" else _empty_arrow()
    # columnize through numpy for BOTH formats: ndarray-valued row fields
    # (embeddings/images) stack into (N, ...) tensor columns, which the
    # arrow conversion then stores as FixedSizeList — from_pylist would
    # produce ragged list<T> columns that round-trip as object arrays
    if isinstance(rows[0], dict):
        cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r[k])
        block = {k: _as_array(v) for k, v in cols.items()}
    else:
        block = {VALUE_COL: _as_array(list(rows))}
    if fmt == "arrow":
        return BlockAccessor.batch_to_block(block, "arrow")
    return block


def _empty_arrow():
    import pyarrow as pa
    return pa.table({})


class BlockAccessor:
    """Uniform view over a block (reference: ``BlockAccessor``).

    ``BlockAccessor(block)`` (or ``for_block``) returns the numpy or the
    Arrow accessor depending on the block's type — call sites never
    branch on format.
    """

    def __new__(cls, block: Block = None):
        # block defaults to None so pickle's ``cls.__new__(cls)`` (an
        # accessor captured in a task closure) can reconstruct instances
        if cls is BlockAccessor and _is_arrow(block):
            return super().__new__(ArrowBlockAccessor)
        return super().__new__(cls)

    def __reduce__(self):
        # dispatching __new__ + default __reduce_ex__ lose the subclass
        # on round-trip; rebuild from the block itself
        return (BlockAccessor, (self._b,))

    def __init__(self, block: Block):
        self._b = block if block is not None else {}

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        return sum(a.nbytes if hasattr(a, "nbytes") else 64 * len(a)
                   for a in self._b.values())

    def columns(self) -> List[str]:
        return list(self._b.keys())

    def schema(self) -> Dict[str, Any]:
        return {k: v.dtype for k, v in self._b.items()}

    # ------------------------------------------------------------- columns
    def get_column(self, name: str) -> Optional[np.ndarray]:
        return self._b.get(name)

    def select(self, cols: List[str]) -> Block:
        return {k: self._b[k] for k in cols}

    def drop(self, cols: List[str]) -> Block:
        return {k: v for k, v in self._b.items() if k not in cols}

    def rename(self, mapping: Dict[str, str]) -> Block:
        return {mapping.get(k, k): v for k, v in self._b.items()}

    def with_column(self, name: str, values: Any) -> Block:
        out = dict(self._b)
        out[name] = np.asarray(values)
        return out

    def merge(self, other: Block, suffix: str = "_1") -> Block:
        """Column-concat two equal-row blocks (zip); clashes get suffix."""
        out = dict(self._b)
        for k, v in BlockAccessor(other).to_batch("numpy").items():
            out[k if k not in self._b else f"{k}{suffix}"] = v
        return out

    # ------------------------------------------------------------- slicing
    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def take_idx(self, idx: np.ndarray) -> Block:
        return {k: v[idx] for k, v in self._b.items()}

    # ----------------------------------------------------------- iteration
    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        keys = list(self._b.keys())
        for i in range(self.num_rows()):
            yield {k: self._b[k][i] for k in keys}

    # --------------------------------------------------------- conversions
    def to_batch(self, batch_format: str = "numpy") -> Any:
        if batch_format in ("numpy", "default", None):
            return dict(self._b)
        if batch_format == "pandas":
            import pandas as pd
            return pd.DataFrame({k: list(v) if v.dtype == object else v
                                 for k, v in self._b.items()})
        if batch_format == "pyarrow":
            import pyarrow as pa
            # _np_to_arrow: tensor (ndim>1) columns become FixedSizeList
            # instead of crashing pa.table (mixed-format concat/zip path)
            return pa.table({k: _np_to_arrow(v)
                             for k, v in self._b.items()})
        raise ValueError(f"unknown batch_format {batch_format!r}")

    @staticmethod
    def batch_to_block(batch: Any,
                       block_format: Optional[str] = None) -> Block:
        """Convert a user-facing batch to a block in the context format."""
        fmt = block_format or _block_format()
        if batch is None:
            return _empty_arrow() if fmt == "arrow" else {}
        mod = type(batch).__module__.split(".")[0]
        if fmt == "arrow":
            import pyarrow as pa
            if mod == "pyarrow":
                return batch          # zero conversion: the table IS a block
            if isinstance(batch, dict):
                return pa.table({k: _np_to_arrow(v)
                                 for k, v in batch.items()})
            if mod == "pandas":
                return pa.Table.from_pandas(batch, preserve_index=False)
            if isinstance(batch, np.ndarray):
                return pa.table({VALUE_COL: _np_to_arrow(batch)})
            raise TypeError(f"cannot convert batch of type {type(batch)}")
        if isinstance(batch, dict):
            return {k: v if isinstance(v, np.ndarray) else _as_array(list(v))
                    for k, v in batch.items()}
        if mod == "pandas":
            return {k: _as_array(batch[k].tolist())
                    if batch[k].dtype == object else batch[k].to_numpy()
                    for k in batch.columns}
        if mod == "pyarrow":
            return {name: _col_to_numpy(batch.column(name))
                    for name in batch.column_names}
        if isinstance(batch, np.ndarray):
            return {VALUE_COL: batch}
        raise TypeError(f"cannot convert batch of type {type(batch)}")


class ArrowBlockAccessor(BlockAccessor):
    """Accessor over a ``pyarrow.Table`` block.

    Slices are zero-copy views (Arrow buffer offsets); concat is
    zero-copy chunk stitching — neither touches the column bytes, which
    is the entire point of the Arrow path (reference:
    ``ArrowBlockAccessor`` in ``python/ray/data/_internal/arrow_block.py``
    — contract only, implementation independent).
    """

    def num_rows(self) -> int:
        return self._b.num_rows

    def size_bytes(self) -> int:
        return self._b.nbytes

    def columns(self) -> List[str]:
        return list(self._b.column_names)

    def schema(self) -> Dict[str, Any]:
        return {f.name: f.type for f in self._b.schema}

    # ------------------------------------------------------------- columns
    def get_column(self, name: str) -> Optional[np.ndarray]:
        if name not in self._b.column_names:
            return None
        return _col_to_numpy(self._b.column(name))

    def select(self, cols: List[str]) -> Block:
        return self._b.select(cols)

    def drop(self, cols: List[str]) -> Block:
        keep = [c for c in self._b.column_names if c not in cols]
        return self._b.select(keep)

    def rename(self, mapping: Dict[str, str]) -> Block:
        return self._b.rename_columns(
            [mapping.get(c, c) for c in self._b.column_names])

    def with_column(self, name: str, values: Any) -> Block:
        arr = _np_to_arrow(values)
        if name in self._b.column_names:
            i = self._b.column_names.index(name)
            return self._b.set_column(i, name, arr)
        return self._b.append_column(name, arr)

    def merge(self, other: Block, suffix: str = "_1") -> Block:
        out = self._b
        have = set(self._b.column_names)
        ob = other if _is_arrow(other) else BlockAccessor(
            other).to_batch("pyarrow")
        for name in ob.column_names:
            out = out.append_column(
                name if name not in have else f"{name}{suffix}",
                ob.column(name))
        return out

    # ------------------------------------------------------------- slicing
    def slice(self, start: int, end: int) -> Block:
        return self._b.slice(start, max(0, end - start))

    def take_idx(self, idx: np.ndarray) -> Block:
        return self._b.take(np.asarray(idx))

    # ----------------------------------------------------------- iteration
    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self._b.to_batches():
            yield from batch.to_pylist()

    # --------------------------------------------------------- conversions
    def to_batch(self, batch_format: str = "numpy") -> Any:
        if batch_format in ("numpy", "default", None):
            return {name: _col_to_numpy(self._b.column(name))
                    for name in self._b.column_names}
        if batch_format == "pandas":
            return self._b.to_pandas()
        if batch_format == "pyarrow":
            return self._b                      # zero copy
        raise ValueError(f"unknown batch_format {batch_format!r}")


def concat_blocks(blocks: Sequence[Block],
                  block_format: Optional[str] = None) -> Block:
    """``block_format`` matters only for the all-empty case: worker-side
    callers must pass their driver-captured format (the worker's
    DataContext singleton is a fresh default), or the inputs' own format
    decides."""
    nonempty = [b for b in blocks
                if b is not None and BlockAccessor(b).num_rows()]
    if not nonempty:
        fmt = block_format
        if fmt is None and any(_is_arrow(b) for b in blocks
                               if b is not None):
            fmt = "arrow"
        return _empty_arrow() if (fmt or _block_format()) == "arrow" else {}
    blocks = nonempty
    if any(_is_arrow(b) for b in blocks):
        import pyarrow as pa
        tables = [b if _is_arrow(b)
                  else BlockAccessor(b).to_batch("pyarrow") for b in blocks]
        return pa.concat_tables(tables, promote_options="default")
    keys = list(blocks[0].keys())
    out = {}
    for k in keys:
        arrs = [b[k] for b in blocks]
        if any(a.dtype == object for a in arrs):
            merged = np.empty(sum(len(a) for a in arrs), dtype=object)
            i = 0
            for a in arrs:
                merged[i:i + len(a)] = a
                i += len(a)
            out[k] = merged
        else:
            out[k] = np.concatenate(arrs)
    return out
