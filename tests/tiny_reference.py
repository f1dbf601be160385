"""The JAX package's outputs for the four tiny encoder and vision models,
for holding the port to the reference on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/tiny_reference.py

(from the repo root) rewrites the file.

Runs ResNet, BERT, ViT and T5 at their ``tiny`` presets through
``ray_tpu.models`` on the CPU in float32, and writes what they compute to
``tests/data/tiny_reference.json`` (outputs only, never weights).

Weights: for each family a ``numpy.random.default_rng((SEED, i))`` (i the
family's place in ``FAMILIES``) draws every leaf of the reference's tree
in the pytree order of its leaf paths (dict keys sorted, list items in
order), heads included, by ``chip_smoke.tiny_draw`` (a leaf named
``scale`` 1 + 0.1·N(0, 1), every other 0.1·N(0, 1), float32); the same
generator then draws the inputs (``chip_smoke.tiny_inputs``).
``chip_smoke.py`` draws the same numbers in the port's tree order
(shapes from ``init_params`` on ``meta``) and holds the card's float32
outputs to this file; ``tests/test_torch_tiny_reference.py`` regenerates
the file in memory and requires it equal to the committed one, and runs
that ``chip_smoke.py`` check on the CPU.

Recorded per family: the logits (T5: the first ``TINY_T5_VOCAB_SLICE`` of
the vocabulary), BERT's pooled output, each loss, the global L2 norm of
the loss's gradient over every leaf, and a few named gradient leaves
(``TINY_GRAD_LEAVES``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from functools import partial
from typing import Any, Dict

import numpy as np

from chip_smoke import (TINY_FAMILIES as FAMILIES, TINY_GRAD_LEAVES,
                        TINY_REFERENCE, TINY_SEED as SEED,
                        TINY_T5_VOCAB_SLICE, tiny_draw, tiny_inputs)

PATH = pathlib.Path(TINY_REFERENCE)


def _entry(x) -> Dict[str, Any]:
    """An array as its shape and float32 values, each written as the
    shortest decimal that reads back to the same float32."""
    a = np.asarray(x, np.float32)
    return {"shape": list(a.shape),
            "values": [float(str(v)) for v in a.reshape(-1)]}


def outputs() -> Dict[str, Any]:
    """Every family's outputs, from the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import bert, resnet, t5, vit

    mods = {"resnet": resnet, "bert": bert, "vit": vit, "t5": t5}
    out: Dict[str, Any] = {}
    for i, fam in enumerate(FAMILIES):
        mod = mods[fam]
        cfg = dataclasses.replace(mod.tiny(), dtype=jnp.float32)
        rng = np.random.default_rng((SEED, i))
        shapes = jax.eval_shape(lambda: mod.init_params(jax.random.key(0),
                                                        cfg))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        drawn = [tiny_draw(rng, getattr(path[-1], "key", None), leaf.shape)
                 for path, leaf in leaves]
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in drawn])
        batch = {k: jnp.asarray(v) for k, v in tiny_inputs(fam, rng).items()}
        # each function compiled once, as the package's train step runs
        jit = partial(jax.jit, static_argnums=2)
        res: Dict[str, Any] = {}
        if fam == "resnet":
            res["logits"] = jit(mod.forward)(params, batch["images"], cfg)
            loss = partial(mod.loss_fn, label_smoothing=0.1)
        elif fam == "bert":
            mask = batch["attention_mask"]
            res["logits"] = jit(mod.classify)(params, batch["tokens"], cfg,
                                              mask)
            res["pooled"] = jit(mod.pooled)(params, batch["tokens"], cfg,
                                            mask)
            res["mlm_loss"] = jit(mod.mlm_loss)(params, batch, cfg)
            loss = mod.classification_loss
        elif fam == "vit":
            res["logits"] = jit(mod.forward)(params, batch["images"], cfg)
            loss = mod.loss_fn
        else:
            res["logits"] = jax.jit(mod.forward, static_argnums=3)(
                params, batch["inputs"], batch["decoder_inputs"],
                cfg)[..., :TINY_T5_VOCAB_SLICE]
            loss = mod.loss_fn
        value, grads = jit(jax.value_and_grad(loss))(params, batch, cfg)
        res["loss"] = value
        res["grad_norm"] = jnp.sqrt(sum(jnp.sum(g * g) for g in
                                        jax.tree_util.tree_leaves(grads)))
        by_path = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path): g for path, g in
                   jax.tree_util.tree_flatten_with_path(grads)[0]}
        for name in TINY_GRAD_LEAVES[fam]:
            res[f"grad/{name}"] = by_path[name]
        out[fam] = {k: _entry(v) for k, v in res.items()}
    return {"seed": SEED, "families": out}


def main() -> int:
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps(outputs(), indent=1) + "\n")
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
