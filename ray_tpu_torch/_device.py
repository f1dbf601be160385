"""Device resolution for the port's entry points.

Entry points (``LLMEngine``, ``ModelRunner``, ``init_params``) run on the
card unless the caller asks for the CPU: ``device=None`` means ``cuda``,
and with no card that raises instead of dropping to the CPU quietly.
The kernel wrappers read the SM count and launch on the current stream
through the helpers below, which keep their per-call host work small.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

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


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The CUDA device's SM count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def launch_on(device: torch.device, launch: Callable[[int], int]) -> int:
    """``launch(stream)`` with ``device`` current, on its current stream
    (a raw ``cudaStream_t`` as an int); switches the current device only
    when it is another one.  Returns what ``launch`` returns."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    Parity checks against the JAX reference (and against a kernel's plain
    version) compare float32 results; TF32 keeps about three decimal
    digits and would swamp their tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

