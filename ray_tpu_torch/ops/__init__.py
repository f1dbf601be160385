"""Attention and normalisation ops; kernels live in ``../csrc``.

Exports the one-card names of ``ray_tpu.ops`` that clash with no
submodule: ``dense_attention``, ``blockwise_attention`` and
``paged_attention_decode``.  ``flash_attention`` is not re-exported, by
decision: here it names the submodule (``ops/flash_attention.py``, with
its kernel wrappers and launch counters), which the tests and
``chip_smoke.py`` import under that name; the function is
``ops.flash_attention.flash_attention``.
"""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    blockwise_attention, dense_attention,
)
from ray_tpu_torch.ops.paged_attention import (  # noqa: F401
    paged_attention_decode,
)

__all__ = ["dense_attention", "blockwise_attention", "paged_attention_decode"]
