"""Dask-on-Ray-equivalent scheduler.

Reference: ``python/ray/util/dask/`` (SURVEY.md §2.3 ray.util misc) —
``ray_dask_get`` is a drop-in dask scheduler: each graph task becomes a
framework task, intermediate results stay in the object store, and
shared dependencies are computed once.

Dask is not installed in this image, so this implements the *dask graph
protocol* directly (a graph is a plain dict of ``key -> computation``
where a computation is a ``(callable, *args)`` tuple, a key reference,
or a literal — the protocol is dependency-free by design).  With dask
present, pass ``get=ray_tpu_torch.util.dask.ray_dask_get`` to ``compute()``
exactly like the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Sequence, Union

import ray_tpu_torch

__all__ = ["ray_dask_get"]


def _is_task(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _is_key(x: Any, dsk: Dict) -> bool:
    # dask keys are str|bytes|int|float or TUPLES thereof (collection
    # chunks like ('x', 0)) — a tuple whose head is callable is a task,
    # everything else hashable that appears in the graph is a key
    if _is_task(x) or isinstance(x, list):
        return False
    try:
        return x in dsk
    except TypeError:
        return False


def _deps_of(comp: Any, dsk: Dict) -> set:
    out: set = set()

    def walk(x):
        if _is_task(x):
            for a in x[1:]:
                walk(a)
        elif isinstance(x, list):
            for a in x:
                walk(a)
        elif _is_key(x, dsk):
            out.add(x)
        elif type(x) is tuple:
            # exact-type, matching ev(): tuple SUBCLASSES (NamedTuples)
            # are literal data on both walks — descending here but not in
            # ev() would ship a dep that never gets substituted
            for a in x:
                walk(a)

    walk(comp)
    return out


@ray_tpu_torch.remote
def _exec_task(comp_blob: bytes, *dep_vals):
    import cloudpickle
    comp, dep_keys = cloudpickle.loads(comp_blob)
    env = dict(zip(dep_keys, dep_vals))

    def ev(x):
        if _is_task(x):
            return x[0](*[ev(a) for a in x[1:]])
        if isinstance(x, list):
            return [ev(a) for a in x]
        try:
            if isinstance(x, Hashable) and x in env:
                return env[x]
        except TypeError:
            pass
        if type(x) is tuple:
            # mirror _deps_of: keys may hide inside plain (non-task)
            # tuples — substitute them and rebuild the tuple.  Exact-type
            # check: tuple subclasses (NamedTuples) are literal data and
            # can never be dask keys; rebuilding would downcast them.
            return tuple(ev(a) for a in x)
        return x

    return ev(comp)


def ray_dask_get(dsk: Dict, keys: Union[Sequence, Any], **_: Any):
    """Execute a dask graph with framework tasks; returns computed keys
    in the same (possibly nested-list) structure dask uses."""
    import cloudpickle

    refs: Dict[Any, Any] = {}
    # literals (plain values, no task/key content) never need a remote
    # task — dask collection graphs carry hundreds of them; computing the
    # dependency map ONCE keeps chains O(V+E) instead of O(V^2)
    remaining: Dict[Any, Any] = {}
    dep_map: Dict[Any, set] = {}
    for key, comp in dsk.items():
        deps = _deps_of(comp, dsk)
        if not deps and not _is_task(comp) and not isinstance(comp, list):
            refs[key] = ray_tpu_torch.put(comp)
        else:
            remaining[key] = comp
            dep_map[key] = deps
    guard = len(remaining) + 1
    while remaining:
        guard -= 1
        if guard < 0:
            raise ValueError("cycle detected in dask graph")
        progressed = []
        for key, comp in remaining.items():
            deps = dep_map[key]
            if any(d in remaining for d in deps):
                continue
            dep_keys = sorted(deps, key=repr)
            blob = cloudpickle.dumps((comp, dep_keys))
            refs[key] = _exec_task.remote(blob, *[refs[d] for d in dep_keys])
            progressed.append(key)
        for key in progressed:
            del remaining[key]
        if not progressed and remaining:
            raise ValueError(
                f"unresolvable keys in dask graph: "
                f"{sorted(remaining, key=repr)[:5]}")

    def fetch(ks):
        if isinstance(ks, list):
            return [fetch(k) for k in ks]
        return ray_tpu_torch.get(refs[ks])

    return fetch(keys if isinstance(keys, list) else [keys])[0] \
        if not isinstance(keys, list) else fetch(keys)
