"""Model zoo (port of ``ray_tpu/models/__init__.py``): the families the
port has so far, and the reference's lookup by family or preset.

========== =========================== ============================
module     flagship                    status in the port
========== =========================== ============================
gpt2       GPT-2 124M…1.5B             serving and training
llama      Llama-2/3 recipe (RoPE/GQA)  serving and training
moe        top-k routed MoE            training on one device
bert, vit, t5, resnet                  not ported (ROADMAP queue A)
========== =========================== ============================
"""

from ray_tpu_torch.models import gpt2, llama, moe_transformer

REGISTRY = {
    "gpt2": gpt2,
    "llama": llama,
    "moe": moe_transformer,
}

# The reference's other families and their presets, each a later slice
# of the port (ROADMAP queue A): looked up, they raise
# NotImplementedError; their presets still count when a bare preset
# name is ambiguous, as in the reference.
NOT_PORTED = {
    "resnet": ("resnet18", "resnet50", "resnet101", "tiny"),
    "bert": ("bert-base", "bert-large", "tiny"),
    "vit": ("vit-b16", "vit-l16", "tiny"),
    "t5": ("t5-base", "t5-large", "tiny"),
}


def _not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"model family {family!r} is not ported yet (a later slice: "
        f"ROADMAP queue A, the encoder and vision families)")


def get_model(name: str):
    """Look up a model module by family name, "family/preset", or an
    unambiguous preset name (raises KeyError if several families define
    it).  The reference's families the port does not have yet raise
    NotImplementedError."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise _not_ported(name)
    if "/" in name:
        family, _, preset = name.partition("/")
        if preset in NOT_PORTED.get(family, ()):
            raise _not_ported(family)
        mod = REGISTRY.get(family)
        if mod is None or preset not in getattr(mod, "PRESETS", {}):
            raise KeyError(f"unknown model {name!r}")
        return mod
    hits = [fam for fam, mod in REGISTRY.items()
            if name in getattr(mod, "PRESETS", {})]
    hits += [fam for fam, presets in NOT_PORTED.items() if name in presets]
    if len(hits) == 1:
        if hits[0] in NOT_PORTED:
            raise _not_ported(hits[0])
        return REGISTRY[hits[0]]
    if hits:
        raise KeyError(
            f"preset {name!r} is ambiguous across families "
            f"{sorted(hits)}; use 'family/{name}'")
    raise KeyError(f"unknown model {name!r}; families: "
                   f"{sorted([*REGISTRY, *NOT_PORTED])}")
