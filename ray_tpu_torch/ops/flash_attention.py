"""Flash attention, forward and backward (port of
``ray_tpu/ops/flash_attention.py``).

The public layout is the reference's ``(B, T, H, D)``.  On CUDA tensors
the forward launches the hand-written kernels in ``csrc/flash_attention.cu``
and the backward those in ``csrc/flash_attention_bwd.cu``, or they raise;
on CPU tensors they run ``flash_attention_plain`` and
``flash_attention_bwd_plain``, the same arithmetic written densely in
PyTorch.  On the card the dtype picks the kernel, explicitly: bf16 (every
main path) launches the tensor-core kernels and counts ``launches`` /
``bwd_launches``; float32 launches the scalar kernels and counts
``f32_launches`` / ``f32_bwd_launches``.  A bf16 operand the tensor-core
kernels cannot read (a base pointer not 16-byte aligned, a stride not a
multiple of 8 elements) raises.

``flash_attention`` goes through ``FlashAttentionFn`` (the reference's
``custom_vjp``) whenever grad is enabled and an input requires it, on
every device: its forward also writes the base-2 lse, and its backward
computes ``delta = sum_D do * o`` in float32 outside the kernel, casts the
cotangent to q's dtype and calls ``flash_attention_bwd``.  Inference keeps
the lse-free forward.

Differences from the reference, each forced by the card:
- The kernel reads q, k and v through their strides (head dim
  contiguous), so the strided views of the qkv projection go in as they
  are; ``_flatten``/``_unflatten`` to ``(B·H, T, D)`` are gone.
- The kernel masks the ragged end of the sequence itself, so every T is
  taken and there is no dense fallback for untileable lengths, and no
  TPU-measured ``pick_block_size``.
- The optional lse is base 2 (``m + log2 l``), ``(B·H, T)`` float32: the
  residual the backward consumes.
- The backward is two deterministic launches (a dK/dV pass and a dQ
  pass) instead of one pass with dq carried across the grid, which on a
  GPU would take float atomics (``csrc/flash_attention_bwd.cu``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ray_tpu_torch import _build
from ray_tpu_torch.ops.attention import NEG_INF

LOG2E = math.log2(math.e)
HEAD_DIMS = (64,)                 # every GPT-2 preset

# Kernel launches since the last reset (one per call of each wrapper):
# the bf16 tensor-core kernels, and the float32 scalar kernels apart.
launches = 0
bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, want_lse: bool = False
                          ) -> Result:
    """The kernel's arithmetic, untiled: scores scaled by scale·log2(e),
    masked to ``NEG_INF``, ``p = exp2(s - m)``, ``l`` clamped to 1e-30;
    everything in float32 except that ``p`` is rounded to ``q.dtype``
    before the p·v product (the reference's ``p.astype(v.dtype)``; a
    no-op in float32), output in ``q.dtype``.  The reference and the
    kernel round p against the running max of each key tile, this
    untiled version against the row's final max.  Returns ``out`` or
    ``(out, lse)`` with ``lse`` ``(B·H, T)`` base 2."""
    B, T, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (LOG2E / math.sqrt(D))
    if causal:
        pos = torch.arange(T, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1)                                  # (B, H, T)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                       v.float()) \
        / l.transpose(1, 2)[..., None]
    out = out.to(q.dtype)
    if not want_lse:
        return out
    return out, (m + torch.log2(l)).reshape(B * H, T)


# Query rows a block of the bf16 forward owns: 128 while that still gives
# every SM at least two blocks, else 64 (the prefill at B = 1, T = 1024
# has 96 blocks of 128 rows for the H100's 132 SMs).
BLOCK_MS = (64, 128)
_sm_counts: dict = {}


def forward_block_m(B: int, T: int, H: int, device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return 128 if -(-T // 128) * B * H >= 2 * _sm_counts[idx] else 64


def _check_tc_operands(**tensors) -> None:
    """The bf16 kernels copy rows with 16-byte cp.async: each base pointer
    16-byte aligned, each (B, T, H) stride a multiple of 8 elements."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            raise ValueError(
                f"flash kernel needs bf16 {name} 16-byte aligned with "
                f"strides that are multiples of 8, got pointer "
                f"{t.data_ptr():#x} strides {tuple(t.stride())}")


def _flash_kernel(q, k, v, causal: bool, want_lse: bool,
                  block_m: Optional[int] = None):
    """The kernel for q's dtype; ``block_m`` (bf16 only) overrides
    ``forward_block_m``."""
    global launches, f32_launches
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a shape, got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, not {D}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs a contiguous head dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        _check_tc_operands(q=q, k=k, v=v)
        if block_m is None:
            block_m = forward_block_m(B, T, H, q.device)
        if block_m not in BLOCK_MS:
            raise ValueError(f"block_m must be one of {BLOCK_MS}, not "
                             f"{block_m}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = None
    if want_lse:
        lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = _build.lib().rtt_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                B, T, H, D,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                int(causal), LOG2E / math.sqrt(D), _DTYPES[q.dtype],
                block_m or 0, stream)
    _build.check(rc, "rtt_flash_attention_fwd")
    if tensor_cores:
        launches += 1
    else:
        f32_launches += 1
    return (out, lse) if want_lse else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, want_lse: bool = False
                        ) -> Result:
    """The forward alone: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal, want_lse)
    return flash_attention_plain(q, k, v, causal, want_lse)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lse: torch.Tensor,
                              delta: torch.Tensor, do: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's arithmetic, untiled, with the reference's
    rounding points: ``p`` and ``ds`` rounded to the storage type before
    their products, ``k·scale`` rounded for the dq product, ``dk``
    scaled after the sum.  lse, delta: ``(B·H, T)`` float32; do in q's
    dtype.  Returns (dq, dk, dv) in q's dtype."""
    B, T, H, D = q.shape
    dt = q.dtype
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), NEG_INF)
    p = torch.exp2(s - lse.reshape(B, H, T, 1))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dsl = (p * (dp - delta.reshape(B, H, T, 1))).to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", dsl, qf) * scale
    ks = (kf * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsl, ks)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _flash_bwd_kernel(q, k, v, lse, delta, do, causal: bool):
    global bwd_launches, f32_bwd_launches
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(f"flash backward takes float32 or bfloat16 q/k/v/do "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}/"
                        f"{do.dtype}")
    if any(t.shape != q.shape for t in (k, v, do)):
        raise ValueError("q, k, v, do must share a shape")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, not {D}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B * H}, {T}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (k, v, do, lse, delta)):
        raise ValueError("flash backward inputs must be on one device")
    if do.stride(3) != 1:
        do = do.contiguous()
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs a contiguous head dim")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        _check_tc_operands(q=q, k=k, v=v, do=do)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    fn = _build.lib().rtt_flash_attention_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, T, H, D,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                do.stride(0), do.stride(1), do.stride(2),
                int(causal), LOG2E / math.sqrt(D), 1.0 / math.sqrt(D),
                _DTYPES[q.dtype], stream)
    _build.check(rc, "rtt_flash_attention_bwd")
    if tensor_cores:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, delta: torch.Tensor,
                        do: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's base-2 lse and ``delta``: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_bwd_kernel(q, k, v, lse, delta, do, causal)
    return flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the fused backward; saves q, k, v, the output
    and the compact base-2 lse.  Returns (out, lse); lse carries no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        B, T, H, _ = q.shape
        # delta = sum_D do * o in float32, in the residual layout
        delta = (g.float() * out.float()).sum(dim=-1)          # (B, T, H)
        delta = delta.transpose(1, 2).reshape(B * H, T)
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, delta,
                                         g.to(q.dtype), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, want_lse: bool = False) -> Result:
    """(B, T, H, D)×3 → (B, T, H, D) tiled attention, differentiable;
    with ``want_lse`` also the base-2 lse, ``(B·H, T)`` float32."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttentionFn.apply(q, k, v, causal)
        return (out, lse) if want_lse else out
    return flash_attention_fwd(q, k, v, causal, want_lse)


def flash_attention_for_model(q, k, v, cfg=None, **_):
    """Model hook (``attn_impl='flash'``, and what ``'auto'`` resolves
    to on CUDA): causal flash attention at any sequence length."""
    return flash_attention(q, k, v, True)
