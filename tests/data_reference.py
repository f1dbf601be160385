"""The JAX package's Ray Data outputs, for holding the port's to them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data_reference.py

(from the repo root) rewrites ``tests/data/data_reference.json``.

Two records, both made on the CPU in a cluster of the JAX package's
runtime:

- ``pipeline``: one fixed pipeline (``run_pipeline``) over rows drawn
  from ``numpy.random.default_rng(SEED)``: ``from_items`` →
  ``map_batches`` → ``filter`` → ``random_shuffle(seed=0)`` →
  ``repartition`` → ``sort`` → ``groupby().mean/std`` →
  ``split(3, equal=True)`` → ``zip`` → ``random_sample(0.5, seed=0)`` →
  the global aggregates.  Row orders and integer columns are recorded
  as they come out, float aggregates as Python floats.
- ``gpt2_tiny``: a tiny GPT-2 (``gpt2_config``) trained one step a batch
  on ``GPT2_BATCHES`` batches of a token Dataset (``token_dataset``,
  each block drawn in its task by ``chip_smoke.data_token_block``), with
  the train phase's optimizer (``default_optimizer(lr=
  chip_smoke.TRAIN_LR, warmup=1, total_steps=1000)``), from
  ``init_params(jax.random.key(0))``.  The
  schedule's first step has lr 0, so the third loss is the first after
  an update.  Recorded: the losses.

``run_pipeline`` takes the data package as an argument, so the port's
test runs the same code through ``ray_tpu_torch.data``.  Functions here
and in ``chip_smoke`` are pickled by value, so neither package's workers
import them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Any, Dict

import cloudpickle
import numpy as np

import chip_smoke
from chip_smoke import TRAIN_LR, data_token_block

cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(chip_smoke)

PATH = pathlib.Path(__file__).parent / "data" / "data_reference.json"
SEED = 0
ROWS = 240
GPT2_ROWS, GPT2_SEQ, GPT2_VOCAB, GPT2_BATCHES = 4, 32, 256, 3


def items() -> list:
    """The pipeline's rows: an id, a key in [0, 7) and a float."""
    rng = np.random.default_rng(SEED)
    v = rng.standard_normal(ROWS)
    k = rng.integers(0, 7, ROWS)
    return [{"id": i, "k": int(k[i]), "v": float(v[i])} for i in range(ROWS)]


def _ids(ds, *cols) -> list:
    cols = cols or ("id",)
    rows = ds.take_all()
    if len(cols) == 1:
        return [int(r[cols[0]]) for r in rows]
    return [[int(r[c]) for c in cols] for r in rows]


def run_pipeline(rd) -> Dict[str, Any]:
    """The fixed pipeline through the data package ``rd`` (either
    package's), in a cluster of its runtime."""
    out: Dict[str, Any] = {}
    ds = rd.from_items(items(), override_num_blocks=4)
    ds = ds.map_batches(lambda b: {
        "id": b["id"], "k": b["k"], "v": b["v"] * 2.0 + 1.0,
        "w": b["id"] * 3 - b["k"]})
    ds = ds.filter(lambda r: r["id"] % 5 != 0)
    ds = ds.random_shuffle(seed=0)
    ds = ds.repartition(3).materialize()
    out["shuffled_ids"] = _ids(ds)
    out["shuffled_w"] = _ids(ds, "w")
    srt = ds.sort("v")
    out["sorted_ids"] = _ids(srt)
    g = ds.groupby("k")
    means = {int(r["k"]): float(r["mean(v)"]) for r in g.mean("v").take_all()}
    stds = {int(r["k"]): float(r["std(v)"]) for r in g.std("v").take_all()}
    out["group_keys"] = sorted(means)
    out["group_mean_v"] = [means[k] for k in sorted(means)]
    out["group_std_v"] = [stds[k] for k in sorted(means)]
    shards = srt.split(3, equal=True)
    out["split_ids"] = [_ids(s) for s in shards]
    z = shards[0].zip(shards[1])
    out["zip_ids"] = _ids(z, "id", "id_1")
    smp = z.random_sample(0.5, seed=0)
    out["sample_ids"] = _ids(smp, "id", "id_1")
    out["aggregates"] = {
        "count": int(smp.count()), "sum_w": int(smp.sum("w")),
        "min_w": int(smp.min("w")), "max_w": int(smp.max("w")),
        "sum_v": float(smp.sum("v")), "mean_v": float(smp.mean("v")),
        "std_v": float(smp.std("v")), "min_v": float(smp.min("v")),
        "max_v": float(smp.max("v")),
        "unique_k": [int(x) for x in smp.unique("k")]}
    return out


def gpt2_config(gpt2, dtype):
    """The tiny GPT-2 of the record: ``tiny()`` at E 128, float32, the
    flash path (Pallas in interpret mode on the JAX side)."""
    return dataclasses.replace(gpt2.tiny(vocab=GPT2_VOCAB), n_embd=128,
                               dtype=dtype, attn_impl="flash")


def token_dataset(rd):
    """The record's token Dataset through the data package ``rd``."""
    return rd.range(GPT2_ROWS * GPT2_BATCHES,
                    override_num_blocks=GPT2_BATCHES).map_batches(
        lambda b: data_token_block(b, GPT2_SEQ, GPT2_VOCAB))


def jax_init_tree() -> Dict[str, Any]:
    """The tiny GPT-2's params from the JAX package's init, as numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    cfg = gpt2_config(jgpt2, jnp.float32)
    return jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0),
                                                      cfg))


def jax_gpt2_losses() -> list:
    """One step a batch of the token Dataset (the JAX package's Data) by
    the JAX package's train program."""
    import jax
    import jax.numpy as jnp

    from ray_tpu import data as jrd
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import spmd as jspmd
    cfg = gpt2_config(jgpt2, jnp.float32)
    tree = jax_init_tree()
    mc = jmesh.MeshConfig(data=1).resolved(1)
    prog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                          total_steps=1000),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    state = prog.init_fn(jax.random.key(0))
    losses = []
    for b in token_dataset(jrd).iter_batches(batch_size=GPT2_ROWS):
        state, m = prog.step_fn(state, jspmd.shard_batch(
            prog, {"tokens": np.array(b["tokens"])}))
        losses.append(float(m["loss"]))
    return losses


def outputs() -> Dict[str, Any]:
    """Both records, from the JAX package in a cluster of its own."""
    import ray_tpu
    from ray_tpu import data as jrd
    ray_tpu.init(num_cpus=2)
    try:
        return {"seed": SEED, "pipeline": run_pipeline(jrd),
                "gpt2_tiny": {"rows": GPT2_ROWS, "seq": GPT2_SEQ,
                              "vocab": GPT2_VOCAB,
                              "batches": GPT2_BATCHES,
                              "losses": jax_gpt2_losses()}}
    finally:
        ray_tpu.shutdown()


def main() -> int:
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps(outputs(), indent=1) + "\n")
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
