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

Each kernel has three instantiations, and ``launch_plan`` picks one from
the shapes, strides and pointers alone: vector I/O (16-byte loads and
stores, the affine in registers, rows walked over a grid the SMs hold in
one wave) for E a multiple of 8 up to 768 with aligned rows, which is
every LayerNorm of the GPT-2 124M and MoE paths; wide-row vector I/O (the
affine, and the backward's column sums, in shared memory) for E a
multiple of 8 from 776 to 2048 with aligned rows, GPT-2 medium, large and
xl (1024, 1280, 1600); scalar I/O for any other layout.  All are
kernels, counted apart.

The reference takes its Pallas kernel only when ``E % 128 == 0`` (a TPU
lane-tiling limit), so at E 1600 it computes its plain branch; the port
computes the same function with a kernel at every E: the forward at any
E, the backward up to 6144.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build
from ray_tpu_torch._device import launch_on, sm_count

# Kernel launches since the last reset, one counter per instantiation
# (chip_smoke.py reads them to show that the main path went through the
# vector-I/O kernels): ``launches`` / ``bwd_launches`` count the
# vector-I/O kernels, ``wide_launches`` / ``bwd_wide_launches`` the
# wide-row ones, ``scalar_launches`` / ``bwd_scalar_launches`` the
# scalar-I/O ones.
launches = 0
bwd_launches = 0
wide_launches = 0
bwd_wide_launches = 0
scalar_launches = 0
bwd_scalar_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The instantiations, by the C entries' route argument.
ROUTES = {"scalar": 0, "vector": 1, "wide": 2}
# The launch geometry of csrc/layer_norm.cu.  The vector kernels hold
# E <= 768 in registers, 8 columns a vector; the wide-row kernels E <=
# 2048, 3 forward blocks an SM (168 registers) and 2 backward (255).  A
# block takes 4 rows at a time; an SM holds 4 vector forward blocks (128
# registers) and, by dtype, 3 or 2 vector backward blocks (168 or 255
# registers).  The scalar backward keeps its partial rows in 48 KB of
# shared memory.
VEC_CHUNK = 8
VEC_MAX_E = 768
WIDE_MAX_E = 2048
WIDE_FWD_BLOCKS_PER_SM = 3
WIDE_BWD_BLOCKS_PER_SM = 2
FWD_WARPS, FWD_BLOCKS_PER_SM = 4, 4
BWD_WARPS = 4
BWD_BLOCKS_PER_SM = {torch.bfloat16: 3, torch.float32: 2}
BWD_SCALAR_BLOCKS_PER_SM = 2
MAX_BWD_E = 6144


def wide_bwd_smem_bytes(E: int) -> int:
    """The wide-row backward's dynamic shared memory at width E: scale
    and each of its 4 warps' dscale and dbias sums, float32."""
    return (1 + 2 * BWD_WARPS) * E * 4


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


def launch_plan(N: int, E: int, row_stride: int, misalign: int,
                dtype: torch.dtype, sms: int, backward: bool = False
                ) -> Tuple[str, int]:
    """(route, blocks) for one kernel call: route ``"vector"``,
    ``"wide"`` or ``"scalar"`` (``ROUTES``).

    ``row_stride`` is in elements and ``misalign`` in bytes: for several
    operands, the bitwise OR of their row strides and of their base
    addresses mod 16, since any one that breaks the rule rules vector I/O
    out.  Vector I/O needs E a multiple of 8, row strides that are
    multiples of 8 elements and 16-byte aligned bases; E up to 768 takes
    the vector kernels, up to 2048 the wide-row ones.  Both walk rows over
    a grid the SMs hold in one wave; the scalar forward takes one row per
    warp, the scalar backward two blocks an SM.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    aligned = (E > 0 and E % VEC_CHUNK == 0 and row_stride % VEC_CHUNK == 0
               and misalign % 16 == 0)
    route = "scalar"
    if aligned and E <= VEC_MAX_E:
        route = "vector"
    elif aligned and E <= WIDE_MAX_E:
        route = "wide"
    if backward:
        per_sm = {"vector": BWD_BLOCKS_PER_SM[dtype],
                  "wide": WIDE_BWD_BLOCKS_PER_SM,
                  "scalar": BWD_SCALAR_BLOCKS_PER_SM}[route]
        return route, max(1, min(-(-N // BWD_WARPS), per_sm * sms))
    blocks = -(-N // FWD_WARPS)
    per_sm = {"vector": FWD_BLOCKS_PER_SM, "wide": WIDE_FWD_BLOCKS_PER_SM,
              "scalar": None}[route]
    return route, min(blocks, per_sm * sms) if per_sm else blocks


def _check_affine(x2: torch.Tensor, **named: torch.Tensor) -> None:
    E = x2.shape[1]
    for name, t in named.items():
        if t.shape != (E,) or t.device != x2.device:
            raise ValueError(f"{name} must be ({E},) on {x2.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous float32, copying only if it is not already."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _ln_fwd_kernel(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, want_stats: bool):
    global launches, wide_launches, scalar_launches
    N, E = x2.shape
    if x2.stride(1) != 1:
        raise ValueError("layer_norm kernel needs a contiguous last dim")
    _check_affine(x2, scale=scale, bias=bias)
    scale, bias = _f32(scale), _f32(bias)
    dev = x2.device
    y = torch.empty((N, E), dtype=x2.dtype, device=dev)
    mu = rstd = None
    if want_stats:
        mu = torch.empty((N,), dtype=torch.float32, device=dev)
        rstd = torch.empty((N,), dtype=torch.float32, device=dev)
    route, blocks = launch_plan(
        N, E, x2.stride(0),
        (x2.data_ptr() | scale.data_ptr() | bias.data_ptr()) % 16,
        x2.dtype, sm_count(dev))
    fn = _build.entry("rtt_layer_norm_fwd")
    rc = launch_on(dev, lambda stream: fn(
        x2.data_ptr(), x2.stride(0), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mu.data_ptr() if mu is not None else None,
        rstd.data_ptr() if rstd is not None else None, N, E, float(eps),
        _DTYPES[x2.dtype], ROUTES[route], blocks, stream))
    _build.check(rc, "rtt_layer_norm_fwd")
    if route == "vector":
        launches += 1
    elif route == "wide":
        wide_launches += 1
    else:
        scalar_launches += 1
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


def _ln_bwd_kernel(x2, scale, g2, mu, rstd):
    global bwd_launches, bwd_wide_launches, bwd_scalar_launches
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
    scale = _f32(scale)
    mu, rstd = mu.contiguous(), rstd.contiguous()
    dev = x2.device
    route, nb = launch_plan(
        N, E, x2.stride(0) | g2.stride(0),
        (x2.data_ptr() | g2.data_ptr() | scale.data_ptr()) % 16,
        x2.dtype, sm_count(dev), backward=True)
    dx = torch.empty((N, E), dtype=x2.dtype, device=dev)
    parts = torch.empty((nb, 2 * E), dtype=torch.float32, device=dev)
    sums = torch.empty((2, E), dtype=torch.float32, device=dev)
    fn = _build.entry("rtt_layer_norm_bwd")
    rc = launch_on(dev, lambda stream: fn(
        x2.data_ptr(), x2.stride(0), scale.data_ptr(), g2.data_ptr(),
        g2.stride(0), mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        parts.data_ptr(), sums.data_ptr(), N, E, nb, _DTYPES[x2.dtype],
        ROUTES[route], stream))
    _build.check(rc, "rtt_layer_norm_bwd")
    if route == "vector":
        bwd_launches += 1
    elif route == "wide":
        bwd_wide_launches += 1
    else:
        bwd_scalar_launches += 1
    return dx, sums[0], sums[1]


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
