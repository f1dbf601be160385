"""The JAX package's ``util`` extras and workflow outputs, for holding the
port's to them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/util_extras_reference.py

(from the repo root) rewrites ``tests/data/util_extras_reference.json``.

One record, ``run``, made on the CPU in a cluster of the JAX package's
runtime (``run_all``) from inputs drawn with
``numpy.random.default_rng(SEED)`` (``draws``):

- ``dask``: ``ray_dask_get`` on one graph (literals, shared keys, nested
  tasks, tuple keys, a key inside a literal tuple), for a flat and a
  nested key list;
- ``iter``: each shard's items after ``from_items`` (the shard
  assignment), ``gather_sync`` through ``for_each`` / ``filter`` /
  ``flat_map`` / ``batch``, ``take``, ``from_range`` and
  ``from_iterators``; ``gather_async``'s items sorted (its order is the
  race between shards);
- ``pool``: ``Pool(processes=2)``'s chunk sizes, ``map`` (chunked by the
  pool's rule), ``imap`` at ``chunksize=5``, ``starmap``, ``apply``;
- ``actor_pool``: ``ActorPool``'s ordered ``map`` over two actors, and
  ``map_unordered`` and ``submit`` / ``get_next_unordered`` over one
  (the only orders that are deterministic);
- ``workflow``: a run's result, the files it leaves under its storage
  root, its ``status.json`` and every step's checkpoint.

``run_all`` takes the package as an argument, so the port's test runs
the same code through ``ray_tpu_torch``.  Functions here are pickled by
value, so neither package's workers import this module.
"""

from __future__ import annotations

import importlib
import json
import operator
import pathlib
import pickle
import sys
import tempfile
from typing import Any, Dict

import cloudpickle
import numpy as np

cloudpickle.register_pickle_by_value(sys.modules[__name__])

PATH = pathlib.Path(__file__).parent / "data" / "util_extras_reference.json"
SEED = 0


def draws() -> Dict[str, list]:
    rng = np.random.default_rng(SEED)
    return {"items": rng.integers(-1000, 1000, 37).tolist(),
            "lits": rng.integers(1, 50, 6).tolist(),
            "pairs": rng.integers(0, 100, (9, 2)).tolist(),
            "steps": rng.integers(1, 20, 4).tolist()}


def first_plus(pair, z):
    return pair[0] + z


def dask_graph(lits: list) -> dict:
    add, mul, sub = operator.add, operator.mul, operator.sub
    return {
        "a": lits[0],
        "b": (add, "a", lits[1]),
        "c": (mul, "b", "b"),
        ("x", 0): (add, "c", lits[2]),
        ("x", 1): (sub, (mul, "b", lits[3]), "a"),
        "d": (sum, [("x", 0), ("x", 1), "a"]),
        "e": (first_plus, ("b", lits[4]), lits[5]),
    }


def workflow_dag(wf, steps: list):
    @wf.step
    def scale(x, k):
        return x * k

    @wf.step
    def offset(x):
        return x + steps[3]

    @wf.step
    def combine(a, b, c):
        return [a, b, c]

    s0 = scale.bind(steps[0], steps[1])
    return combine.bind(s0, offset.bind(s0),
                        scale.options(name="again").bind(steps[2], 3))


def run_all(pkg) -> Dict[str, Any]:
    """Every record through ``pkg`` (``ray_tpu`` or ``ray_tpu_torch``),
    whose cluster is running."""
    name = pkg.__name__
    dask = importlib.import_module(f"{name}.util.dask")
    rit = importlib.import_module(f"{name}.util.iter")
    mp = importlib.import_module(f"{name}.util.multiprocessing")
    ap = importlib.import_module(f"{name}.util.actor_pool")
    wf = importlib.import_module(f"{name}.workflow")
    d = draws()
    items = d["items"]
    out: Dict[str, Any] = {}

    g = dask_graph(d["lits"])
    out["dask"] = {"d": dask.ray_dask_get(g, "d"),
                   "nested": dask.ray_dask_get(
                       g, ["b", ["c", ("x", 1)], "e", ("x", 0)])}

    pi = rit.from_items(items, num_shards=3)
    chained = (pi.for_each(lambda x: x * 3).filter(lambda x: x % 2 == 0)
               .flat_map(lambda x: [x, -x]).batch(4))
    out["iter"] = {
        "shards": [pkg.get(s.take.remote([], "probe", 0, 1000))
                   for s in pi._shards],
        "gather_sync": list(chained.gather_sync()),
        "gather_async_sorted": sorted(
            x for b in chained.gather_async() for x in b),
        "take": pi.take(10),
        "from_range": list(rit.from_range(23, num_shards=4)),
        "from_iterators": list(rit.from_iterators(
            [lambda: range(3), lambda: range(10, 15)]).gather_sync())}

    p = mp.Pool(processes=2)
    out["pool"] = {
        "chunk_sizes": p._submit_chunked(abs, [items], None, False)[1],
        "map": p.map(lambda x: x * x - 7, items),
        "imap_5": list(p.imap(lambda x: -x, items, chunksize=5)),
        "starmap": p.starmap(lambda a, b: a * 100 + b, d["pairs"]),
        "apply": p.apply(lambda a, b: a - b, tuple(d["pairs"][0]))}
    p.close()

    @pkg.remote
    class Mul:
        def __init__(self, k):
            self.k = k

        def f(self, x):
            return (self.k, x * self.k)

    two = ap.ActorPool([Mul.remote(2), Mul.remote(3)])
    one = ap.ActorPool([Mul.remote(5)])
    ordered = list(two.map(lambda a, v: a.f.remote(v), items[:9]))
    unordered = list(one.map_unordered(lambda a, v: a.f.remote(v),
                                       items[:6]))
    for v in items[6:9]:
        one.submit(lambda a, x: a.f.remote(x), v)
    submitted = [one.get_next_unordered(timeout=60) for _ in range(3)]
    out["actor_pool"] = {"ordered_values": [v for _, v in ordered],
                         "unordered": unordered, "submitted": submitted}

    with tempfile.TemporaryDirectory() as root:
        node = workflow_dag(wf, d["steps"])
        result = wf.run(node, workflow_id="wf_ref", storage=root)
        base = pathlib.Path(root) / "wf_ref"
        files = sorted(f.name for f in base.iterdir())
        ckpt = {}
        for f in files:
            if f.endswith(".pkl"):
                with open(base / f, "rb") as fh:
                    ckpt[f] = pickle.load(fh)
        out["workflow"] = {"result": result, "files": files,
                           "status": json.loads(
                               (base / "status.json").read_text()),
                           "checkpoints": ckpt,
                           "list_all": [list(r) for r in wf.list_all(
                               storage=root)]}
    return out


def outputs() -> Dict[str, Any]:
    """The record, from the JAX package in a cluster of its own."""
    import ray_tpu
    ray_tpu.init(num_cpus=2)
    try:
        return {"seed": SEED, "run": json.loads(json.dumps(
            run_all(ray_tpu)))}
    finally:
        ray_tpu.shutdown()


def main() -> int:
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps(outputs(), indent=1) + "\n")
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
