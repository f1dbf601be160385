"""Model zoo (port of ``ray_tpu/models/__init__.py``): every family of the
reference, and its lookup by family or preset.

========== =========================== ===================================
module     flagship                    what the port does with it
========== =========================== ===================================
gpt2       GPT-2 124M…1.5B             serving (LLMEngine) and training
llama      Llama-2/3 recipe (RoPE/GQA)  serving (LLMEngine) and training
resnet     ResNet-50 (GN+WS)           training (BASELINE #2)
bert       BERT-base encoder           ``classify`` for serving
                                       (BASELINE #4), MLM and
                                       classification losses
moe        top-k routed MoE            training on one device
vit        ViT-B/16                    training
t5         t5.1.1-base enc-dec         training
========== =========================== ===================================
"""

from ray_tpu_torch.models import (bert, gpt2, llama,  # noqa: F401
                                  moe_transformer, resnet, t5, vit)

REGISTRY = {
    "gpt2": gpt2,
    "llama": llama,
    "resnet": resnet,
    "bert": bert,
    "moe": moe_transformer,
    "vit": vit,
    "t5": t5,
}


def get_model(name: str):
    """Look up a model module by family name, "family/preset", or an
    unambiguous preset name (raises KeyError if several families define
    it)."""
    if name in REGISTRY:
        return REGISTRY[name]
    if "/" in name:
        family, _, preset = name.partition("/")
        mod = REGISTRY.get(family)
        if mod is None or preset not in getattr(mod, "PRESETS", {}):
            raise KeyError(f"unknown model {name!r}")
        return mod
    hits = [(fam, mod) for fam, mod in REGISTRY.items()
            if name in getattr(mod, "PRESETS", {})]
    if len(hits) == 1:
        return hits[0][1]
    if hits:
        raise KeyError(
            f"preset {name!r} is ambiguous across families "
            f"{sorted(f for f, _ in hits)}; use 'family/{name}'")
    raise KeyError(f"unknown model {name!r}; families: {sorted(REGISTRY)}")
