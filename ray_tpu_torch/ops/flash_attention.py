"""Flash-attention forward (port of ``ray_tpu/ops/flash_attention.py``).

The public layout is the reference's ``(B, T, H, D)``.  On CUDA tensors
``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu`` or raises; on CPU tensors it runs
``flash_attention_plain``, the same online-softmax arithmetic written
densely in PyTorch.

Differences from the reference, each forced by the card:
- The kernel reads q, k and v through their strides (head dim
  contiguous), so the strided views of the qkv projection go in as they
  are; ``_flatten``/``_unflatten`` to ``(B·H, T, D)`` are gone.
- The kernel masks the ragged end of the sequence itself, so every T is
  taken and there is no dense fallback for untileable lengths, and no
  TPU-measured ``pick_block_size``.
- The optional lse is base 2 (``m + log2 l``), ``(B·H, T)`` float32: the
  residual the training slice's backward will consume.
The backward kernel is a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ray_tpu_torch import _build
from ray_tpu_torch.ops.attention import NEG_INF

LOG2E = math.log2(math.e)
HEAD_DIMS = (64,)                 # every GPT-2 preset

# Kernel launches since the last reset.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, want_lse: bool = False
                          ) -> Result:
    """The kernel's arithmetic, untiled: scores scaled by scale·log2(e),
    masked to ``NEG_INF``, ``p = exp2(s - m)``, ``l`` clamped to 1e-30;
    everything in float32, output in ``q.dtype``.  Returns ``out`` or
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
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / l.transpose(1, 2)[..., None]
    out = out.to(q.dtype)
    if not want_lse:
        return out
    return out, (m + torch.log2(l)).reshape(B * H, T)


def _flash_kernel(q, k, v, causal: bool, want_lse: bool):
    global launches
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
                int(causal), LOG2E / math.sqrt(D), _DTYPES[q.dtype], stream)
    _build.check(rc, "rtt_flash_attention_fwd")
    launches += 1
    return (out, lse) if want_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, want_lse: bool = False) -> Result:
    """(B, T, H, D)×3 → (B, T, H, D) tiled attention (forward only);
    with ``want_lse`` also the base-2 lse, ``(B·H, T)`` float32."""
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal, want_lse)
    return flash_attention_plain(q, k, v, causal, want_lse)


def flash_attention_for_model(q, k, v, cfg=None, **_):
    """Model hook (``attn_impl='flash'``, and what ``'auto'`` resolves
    to on CUDA): causal flash attention at any sequence length."""
    return flash_attention(q, k, v, True)
