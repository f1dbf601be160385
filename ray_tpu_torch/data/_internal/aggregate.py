"""Groupby aggregation kernels.

Reference: ``python/ray/data/_internal/planner/exchange/aggregate_*`` +
``ray.data.aggregate.AggregateFn`` family (Count/Sum/Min/Max/Mean/Std).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor

# (agg_name, on_col, out_name)
AggSpec = Tuple[str, str, str]

_KERNELS = {
    "count": lambda v: len(v),
    "sum": lambda v: np.sum(v),
    "min": lambda v: np.min(v),
    "max": lambda v: np.max(v),
    "mean": lambda v: np.mean(v),
    "std": lambda v: np.std(v, ddof=1) if len(v) > 1 else 0.0,
}


def apply_groupby(block: Block, key: str, aggs: List[AggSpec]) -> Block:
    acc = BlockAccessor(block)
    if not acc.num_rows():
        return {}
    # kernels are numpy reductions; pull ONLY the key + agg input columns
    # through the accessor (format-dispatching) so Arrow blocks aggregate
    # identically without converting unrelated columns (result block
    # stays numpy — the reduce output is small)
    needed = {key} | {on for _, on, _ in aggs if on}
    cols = {c: acc.get_column(c) for c in needed}
    missing = sorted(c for c, v in cols.items() if v is None)
    if missing:
        raise KeyError(
            f"groupby/aggregate column(s) {missing} not found in block "
            f"(available: {sorted(acc.columns())})")
    keys = cols[key]
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    # group boundaries
    if len(sorted_keys) == 0:
        return {}
    change = np.nonzero(sorted_keys[1:] != sorted_keys[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(sorted_keys)]])
    out: Dict[str, List[Any]] = {key: []}
    for _, _, out_name in aggs:
        out[out_name] = []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        out[key].append(sorted_keys[s])
        for agg_name, on_col, out_name in aggs:
            col = cols[on_col] if on_col else keys
            out[out_name].append(_KERNELS[agg_name](col[idx]))
    return {k: np.asarray(v) for k, v in out.items()}
