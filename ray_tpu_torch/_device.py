"""Device resolution for the port's entry points.

Entry points (``LLMEngine``, ``ModelRunner``, ``init_params``) run on the
card unless the caller asks for the CPU: ``device=None`` means ``cuda``,
and with no card that raises instead of dropping to the CPU quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    Parity checks against the JAX reference (and against a kernel's plain
    version) compare float32 results; TF32 keeps about three decimal
    digits and would swamp their tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

