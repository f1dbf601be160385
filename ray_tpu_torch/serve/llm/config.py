"""Engine + sampling configuration for serve.llm (port of
``ray_tpu/serve/llm/config.py``: the same fields and defaults)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters.

    Greedy (temperature=0) is the default: deterministic output is what
    the engine tests rely on.  ``seed`` makes temperature>0 reproducible
    per request.
    """

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                   # 0 = full vocab
    stop_token: Optional[int] = None
    seed: int = 0


@dataclass(frozen=True)
class EngineConfig:
    """Engine-level knobs (model, cache geometry, batching limits).

    ``model`` is "<family>:<preset>" over the port's model zoo —
    ``gpt2:tiny``, ``gpt2:gpt2-124m`` … (``models/gpt2.py`` PRESETS) and
    ``llama:tiny``, ``llama:llama3-8b`` … (``models/llama.py`` PRESETS).
    """

    model: str = "gpt2:tiny"
    seed: int = 0
    # -- paged KV cache geometry ------------------------------------------
    block_size: int = 16             # tokens per KV block
    num_blocks: int = 128            # pool capacity, in blocks
    # -- iteration-level scheduler limits ---------------------------------
    max_num_seqs: int = 8            # max sequences decoded per step
    max_prefill_tokens: int = 512    # prompt-length admission cap
    max_model_len: int = 256         # context cap per sequence
    # -- shape bucketing --------------------------------------------------
    # decode batch is padded up to the nearest bucket; prefill prompt
    # length likewise.
    decode_batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    prefill_len_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    # -- weights plane ----------------------------------------------------
    # publish/attach params through the node's shared memory (weights.py)
    share_weights: bool = True

    @property
    def max_blocks_per_seq(self) -> int:
        # the block-table width of every decode step
        return -(-self.max_model_len // self.block_size)

    def model_key(self) -> str:
        return self.model.replace(":", "_").replace("/", "_")


def resolve_model(cfg: EngineConfig):
    """"<family>:<preset>" → (module, model cfg) from the port's zoo."""
    family, _, preset = cfg.model.partition(":")
    preset = preset or "tiny"
    if family == "gpt2":
        from ray_tpu_torch.models import gpt2 as mod
    elif family == "llama":
        from ray_tpu_torch.models import llama as mod
    else:
        raise ValueError(f"unknown model family {family!r} "
                         "(expected gpt2|llama)")
    try:
        mcfg = mod.PRESETS[preset]()
    except KeyError:
        raise ValueError(f"unknown {family} preset {preset!r}; have "
                         f"{sorted(mod.PRESETS)}") from None
    return mod, mcfg
