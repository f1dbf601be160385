"""Fused LayerNorm, forward and backward (port of
``ray_tpu/ops/layer_norm.py``).

On a CUDA tensor ``ln_fwd`` and ``ln_bwd`` launch the hand-written
kernels in ``csrc/layer_norm.cu`` or raise; on a CPU tensor they run
``ln_fwd_plain`` and ``ln_bwd_plain``, the same arithmetic in PyTorch.
Statistics and the affine are float32 and the output is in ``x.dtype``, as
in the reference.

``layer_norm`` goes through ``LayerNormFn`` (the counterpart of the
reference's ``custom_vjp``) whenever grad is enabled and an input requires
it, on every device: the forward saves only the per-row float32
``(mu, rstd)``, and the backward is ``ln_bwd``.  Otherwise it takes the
stats-free forward, so inference writes no mu/rstd.

The reference takes its Pallas kernel only when ``E % 128 == 0`` (a TPU
lane-tiling limit); these kernels serve every E up to 6144.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build

# Kernel launches since the last reset (chip_smoke.py reads them to show
# that the main path went through the kernels).
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The backward's partial rows live in 48 KB of shared memory per block.
MAX_BWD_E = 6144
BWD_WARPS = 8               # rows a block takes at a time (layer_norm.cu)


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


def _check_affine(x2: torch.Tensor, **named: torch.Tensor) -> None:
    E = x2.shape[1]
    for name, t in named.items():
        if t.shape != (E,) or t.device != x2.device:
            raise ValueError(f"{name} must be ({E},) on {x2.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _ln_fwd_kernel(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, want_stats: bool):
    global launches
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, "
                        f"not {x2.dtype}")
    N, E = x2.shape
    if x2.stride(1) != 1:
        raise ValueError("layer_norm kernel needs a contiguous last dim")
    _check_affine(x2, scale=scale, bias=bias)
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


def ln_bwd_plain(x2: torch.Tensor, scale: torch.Tensor, g2: torch.Tensor,
                 mu: torch.Tensor, rstd: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, E) x and cotangent g, (N,) f32 mu/rstd → (dx (N, E) in
    x.dtype, dscale (E,) f32, dbias (E,) f32)."""
    x, g = x2.float(), g2.float()
    xhat = (x - mu[:, None]) * rstd[:, None]
    gs = g * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (gs - m1 - xhat * m2)
    return dx.to(x2.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


def bwd_blocks(N: int, device: torch.device) -> int:
    """About two blocks per SM, and none without rows to walk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-N // BWD_WARPS), 2 * sms))


def _ln_bwd_kernel(x2, scale, g2, mu, rstd):
    global bwd_launches
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, "
                        f"not {x2.dtype}")
    N, E = x2.shape
    if E > MAX_BWD_E:
        raise ValueError(f"layer_norm backward kernel takes E <= "
                         f"{MAX_BWD_E}, not {E}")
    if x2.stride(1) != 1:
        raise ValueError("layer_norm kernel needs a contiguous last dim")
    if g2.shape != x2.shape or g2.device != x2.device:
        raise ValueError(f"cotangent {tuple(g2.shape)} on {g2.device} must "
                         f"match x {tuple(x2.shape)} on {x2.device}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.shape != (N,) or t.dtype != torch.float32 \
                or t.device != x2.device:
            raise ValueError(f"{name} must be ({N},) float32 on "
                             f"{x2.device}")
    _check_affine(x2, scale=scale)
    g2 = g2.to(x2.dtype)
    if g2.stride(1) != 1:
        g2 = g2.contiguous()
    scale = scale.to(torch.float32).contiguous()
    mu, rstd = mu.contiguous(), rstd.contiguous()
    nb = bwd_blocks(N, x2.device)
    dx = torch.empty((N, E), dtype=x2.dtype, device=x2.device)
    parts = torch.empty((2, nb, E), dtype=torch.float32, device=x2.device)
    fn = _build.lib().rtt_layer_norm_bwd
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x2.data_ptr(), x2.stride(0), scale.data_ptr(),
                g2.data_ptr(), g2.stride(0), mu.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                N, E, nb, _DTYPES[x2.dtype], stream)
    _build.check(rc, "rtt_layer_norm_bwd")
    bwd_launches += 1
    dscale, dbias = parts.sum(dim=1)      # the few partial rows, outside
    return dx, dscale, dbias


def ln_bwd(x2: torch.Tensor, scale: torch.Tensor, g2: torch.Tensor,
           mu: torch.Tensor, rstd: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias): the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x2.device.type == "cuda":
        return _ln_bwd_kernel(x2, scale, g2, mu, rstd)
    return ln_bwd_plain(x2, scale, g2, mu, rstd)


class LayerNormFn(torch.autograd.Function):
    """LayerNorm with the fused backward; saves x, scale and the per-row
    float32 (mu, rstd), O(rows) beside the input."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        y, mu, rstd = ln_fwd(x2, scale, bias, eps, want_stats=True)
        ctx.save_for_backward(x2, scale, mu, rstd)
        ctx.shape = shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = ln_bwd(x2, scale, g.reshape(x2.shape), mu, rstd)
        return (dx.reshape(ctx.shape), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; x: (..., E); scale, bias: (E,)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return LayerNormFn.apply(x, scale, bias, eps)
    shape = x.shape
    y, _, _ = ln_fwd(x.reshape(-1, shape[-1]), scale, bias, eps)
    return y.reshape(shape)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device (differentiated
    by autograd, not by ``ln_bwd``)."""
    shape = x.shape
    return ln_fwd_plain(x.reshape(-1, shape[-1]), scale, bias,
                        eps)[0].reshape(shape)
