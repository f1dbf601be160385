"""Fused LayerNorm forward (port of ``ray_tpu/ops/layer_norm.py``).

On a CUDA tensor ``layer_norm`` launches the hand-written kernel in
``csrc/layer_norm.cu`` or raises; on a CPU tensor it runs
``layer_norm_plain``, the same arithmetic in PyTorch.  Statistics and the
affine are float32 and the output is in ``x.dtype``, as in the reference.

The reference takes its Pallas kernel only when ``E % 128 == 0`` (a TPU
lane-tiling limit); this kernel serves every E.  The backward kernel is
a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build

# Kernel launches since the last reset (chip_smoke.py reads it to show
# that the main path went through the kernel).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ln_fwd_plain(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, E) → (y (N, E) in x.dtype, mu (N,) f32, rstd (N,) f32), with
    two-pass statistics: the mean, then the mean of (x - mu)²."""
    x = x2.float()
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(x2.dtype), mu[:, 0], rstd[:, 0]


def _ln_fwd_kernel(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, want_stats: bool):
    global launches
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, "
                        f"not {x2.dtype}")
    N, E = x2.shape
    if x2.stride(1) != 1:
        raise ValueError("layer_norm kernel needs a contiguous last dim")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (E,) or t.device != x2.device:
            raise ValueError(f"{name} must be ({E},) on {x2.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((N, E), dtype=x2.dtype, device=x2.device)
    mu = rstd = None
    if want_stats:
        mu = torch.empty((N,), dtype=torch.float32, device=x2.device)
        rstd = torch.empty((N,), dtype=torch.float32, device=x2.device)
    fn = _build.lib().rtt_layer_norm_fwd
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x2.data_ptr(), x2.stride(0), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(),
                mu.data_ptr() if mu is not None else None,
                rstd.data_ptr() if rstd is not None else None,
                N, E, float(eps), _DTYPES[x2.dtype], stream)
    _build.check(rc, "rtt_layer_norm_fwd")
    launches += 1
    return y, mu, rstd


def ln_fwd(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5, want_stats: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                      Optional[torch.Tensor]]:
    """(N, E) → (y, mu, rstd); mu and rstd are None unless
    ``want_stats``.  The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x2.device.type == "cuda":
        return _ln_fwd_kernel(x2, scale, bias, eps, want_stats)
    y, mu, rstd = ln_fwd_plain(x2, scale, bias, eps)
    return (y, mu, rstd) if want_stats else (y, None, None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; x: (..., E); scale, bias: (E,)."""
    shape = x.shape
    y, _, _ = ln_fwd(x.reshape(-1, shape[-1]), scale, bias, eps)
    return y.reshape(shape)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device."""
    shape = x.shape
    return ln_fwd_plain(x.reshape(-1, shape[-1]), scale, bias,
                        eps)[0].reshape(shape)
