"""Flash attention, forward and backward (port of
``ray_tpu/ops/flash_attention.py``).

The public layout is the reference's ``(B, T, H, D)``.  On CUDA tensors
the forward launches the hand-written kernels in ``csrc/flash_attention.cu``
and the backward those in ``csrc/flash_attention_bwd.cu``, or they raise;
on CPU tensors they run ``flash_attention_plain`` and
``flash_attention_bwd_plain``, the same arithmetic written densely in
PyTorch.  On the card the dtype picks the kernel, explicitly: bf16 (every
main path) launches the tensor-core kernels and counts ``launches`` /
``bwd_launches`` at head dim 64 and ``d128_launches`` /
``d128_bwd_launches`` at head dim 128 (Llama's); float32 launches the
scalar kernels (head dim 64 without KV groups only) and counts
``f32_launches`` / ``f32_bwd_launches``.  A bf16 operand the tensor-core
kernels cannot read (a base pointer not 16-byte aligned, a stride not a
multiple of 8 elements) raises.

Grouped-query attention: k and v may have KV heads dividing q's H, and
query head h reads KV head h // (H / KV), the order of the reference's
``_gqa_expand`` (``jnp.repeat``).  The kernels read the KV heads in place;
the plain versions expand them with ``repeat_interleave``.  The backward
returns dk and dv with the KV heads, ``(B, T, KV, D)``: each is summed
over its group of query heads in float32 and rounded once (the reference
rounds per query head, then sums through ``jnp.repeat``'s transpose).
On the card the bf16 backward takes head dim 64 without groups and head
dim 128 with any KV dividing H.

``flash_attention`` goes through the op ``ray_tpu_torch::flash_fwd``
(``flash_fwd_op``, a ``torch.library.custom_op``: the reference's
``custom_vjp``) whenever grad is enabled and an input requires it, on
every device: it returns the output and the base-2 lse, and its
registered backward computes ``delta = sum_D do * o`` in float32 outside
the kernel, casts the cotangent to q's dtype and calls
``flash_attention_bwd``.  As one op at the dispatcher, the forward is
what ``torch.utils.checkpoint``'s selective policies see and can save
(the reference's ``checkpoint_name(out, "flash_attn_out")`` and
``"flash_attn_lse"``): a replay under such a policy takes the saved
``(out, lse)`` and launches nothing.  Inference keeps the lse-free
forward as a direct call, with no op dispatch.

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

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from ray_tpu_torch import _build
from ray_tpu_torch._device import launch_on, sm_count
from ray_tpu_torch.ops.attention import NEG_INF

LOG2E = math.log2(math.e)
HEAD_DIMS = (64, 128)             # every GPT-2 preset; Llama's
F32_HEAD_DIMS = (64,)             # the float32 kernels, forward and backward

# Kernel launches since the last reset (one per call of each wrapper):
# the bf16 tensor-core kernels at head dim 64 and at 128 apart, and the
# float32 scalar kernels apart.
launches = 0
d128_launches = 0
bwd_launches = 0
d128_bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

# Keys a tile of the forward kernels (csrc/flash_attention.cu kBN).
KEY_TILE = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, want_lse: bool = False,
                          key_tile: int = KEY_TILE) -> Result:
    """The kernel's arithmetic, untiled: scores scaled by scale·log2(e),
    masked to ``NEG_INF``, ``p = exp2(s - m)``, ``l`` clamped to 1e-30;
    everything in float32 except that ``p`` is rounded to ``q.dtype``
    before the p·v product (the reference's ``p.astype(v.dtype)``; a
    no-op in float32), output in ``q.dtype``.  p is rounded against the
    running max after each tile of ``key_tile`` keys (the kernel's tile
    by default; the reference rounds per key block), or against the
    row's final max with ``key_tile=0`` (``_p_for_pv``).  k and v may
    have KV heads dividing H, expanded here as the reference's
    ``jnp.repeat``.  Returns ``out`` or ``(out, lse)`` with ``lse``
    ``(B·H, T)`` base 2."""
    B, T, H, D = q.shape
    k, v = gqa_expand(k, H), gqa_expand(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (LOG2E / math.sqrt(D))
    if causal:
        pos = torch.arange(T, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1)                                  # (B, H, T)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd",
                       _p_for_pv(s, m, p, q.dtype, key_tile), v.float()) \
        / l.transpose(1, 2)[..., None]
    out = out.to(q.dtype)
    if not want_lse:
        return out
    return out, (m + torch.log2(l)).reshape(B * H, T)


def _p_for_pv(s: torch.Tensor, m: torch.Tensor, p: torch.Tensor,
              dtype: torch.dtype, tile: int) -> torch.Tensor:
    """The probabilities the p·v product sees, in float32, given the
    scaled scores ``s``, their row max ``m`` and ``p = exp2(s - m)``.  In
    float32, p.  In a narrower dtype, p rounded where the kernel (and the
    reference, per key block) rounds it: against the running max after
    each tile of ``tile`` keys, then scaled to the row's final max in
    float32, as the kernel rescales its accumulator; ``tile=0``: against
    the final max.  (Against the final max, a row whose max arrives in a
    later tile rounds its early tiles' p otherwise than the kernel:
    several bf16 steps on small outputs.)"""
    if dtype == torch.float32:
        return p
    if not tile:
        return p.to(dtype).float()
    Tk = s.shape[-1]
    nt = -(-Tk // tile)
    tiles = torch.nn.functional.pad(s, (0, nt * tile - Tk), value=NEG_INF)
    tiles = tiles.unflatten(-1, (nt, tile))
    m_run = tiles.amax(-1).cummax(-1).values               # (B, H, T, nt)
    pr = torch.exp2(tiles - m_run[..., None]).to(dtype).float()
    pr *= torch.exp2(m_run - m[..., None])[..., None]
    return pr.flatten(-2)[..., :Tk]


def gqa_expand(kv: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, KV, D) → (B, T, n_head, D), each KV head repeated n_head /
    KV times in place (the reference's ``_gqa_expand``)."""
    n_kv = kv.shape[2]
    if n_kv == n_head:
        return kv
    return kv.repeat_interleave(n_head // n_kv, dim=2)


# Query rows a block of the bf16 forward owns, by head dim.  At 64: 128
# while that still gives every SM at least two blocks, else 64 (the
# prefill at B = 1, T = 1024 has 96 blocks of 128 rows for the H100's 132
# SMs).  At 128: 64 only (a 128-row block would need ~256 registers a
# thread).
BLOCK_MS = {64: (64, 128), 128: (64,)}


def forward_block_m(B: int, T: int, H: int, device: torch.device,
                    D: int = 64) -> int:
    if D == 128:
        return 64
    return 128 if -(-T // 128) * B * H >= 2 * sm_count(device) else 64


def forward_occupancy(D: int, block_m: int) -> Tuple[int, int]:
    """(dynamic shared memory bytes, resident blocks an SM) of the bf16
    forward's (D, block_m) instantiation, from the CUDA occupancy
    calculator on the current device (builds the library)."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _build.entry("rtt_flash_attention_fwd_occupancy")(
        D, block_m, ctypes.byref(smem), ctypes.byref(blocks))
    _build.check(rc, "rtt_flash_attention_fwd_occupancy")
    return smem.value, blocks.value


def _check_tc_operands(**tensors) -> None:
    """The bf16 kernels copy rows with 16-byte cp.async: each base pointer
    16-byte aligned, each (B, T, H) stride a multiple of 8 elements."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
            raise ValueError(
                f"flash kernel needs bf16 {name} 16-byte aligned with "
                f"strides that are multiples of 8, got pointer "
                f"{t.data_ptr():#x} strides {tuple(t.stride())}")


def _check_kv_heads(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> int:
    """q (B, T, H, D), k and v (B, T, KV, D) with KV dividing H; returns
    KV.  The rule of every device (the kernels also take only
    ``HEAD_DIMS``)."""
    B, T, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, T) \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, T, KV, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"KV heads ({KV}) must divide the query heads "
                         f"({H})")
    return KV


def _flash_kernel(q, k, v, causal: bool, want_lse: bool,
                  block_m: Optional[int] = None):
    """The kernel for q's dtype and head dim; ``block_m`` (bf16 only)
    overrides ``forward_block_m``."""
    global launches, d128_launches, f32_launches
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    KV = _check_kv_heads(q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, not {D}")
    if q.dtype == torch.float32 and D not in F32_HEAD_DIMS:
        raise ValueError(f"the float32 flash kernel takes head dim "
                         f"{F32_HEAD_DIMS}, not {D}: head dim {D} runs in "
                         f"bfloat16 on the tensor cores")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs a contiguous head dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        _check_tc_operands(q=q, k=k, v=v)
        if block_m is None:
            block_m = forward_block_m(B, T, H, q.device, D)
        if block_m not in BLOCK_MS[D]:
            raise ValueError(f"block_m at head dim {D} must be one of "
                             f"{BLOCK_MS[D]}, not {block_m}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = None
    if want_lse:
        lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = _build.entry("rtt_flash_attention_fwd")
    rc = launch_on(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, T, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), LOG2E / math.sqrt(D), _DTYPES[q.dtype],
        block_m or 0, stream))
    _build.check(rc, "rtt_flash_attention_fwd")
    if tensor_cores and D == 128:
        d128_launches += 1
    elif tensor_cores:
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
    _check_kv_heads(q, k, v)
    return flash_attention_plain(q, k, v, causal, want_lse)


def group_sum(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, T, H, D) → (B, T, KV, D): the sum over each KV head's group of
    query heads (the transpose of ``gqa_expand``), in x's dtype."""
    H = x.shape[2]
    if n_kv == H:
        return x
    return x.unflatten(2, (n_kv, H // n_kv)).sum(3)


def _bwd_sums(q, k, v, lse, delta, do, causal: bool):
    """The backward's float32 sums per query head, before the outputs are
    scaled or rounded: (dq, dk / scale, dv), each (B, T, H, D), with ``p``
    and ``ds`` rounded to the storage type before their products and
    ``k·scale`` rounded for the dq product (the reference's points)."""
    B, T, H, D = q.shape
    dt = q.dtype
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf, vf = gqa_expand(k.float(), H), gqa_expand(v.float(), H)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), NEG_INF)
    p = torch.exp2(s - lse.reshape(B, H, T, 1))
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dsl = (p * (dp - delta.reshape(B, H, T, 1))).to(dt).float()
    del p, dp
    dk = torch.einsum("bhqk,bqhd->bkhd", dsl, qf)
    ks = (kf * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsl, ks)
    return dq, dk, dv


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lse: torch.Tensor,
                              delta: torch.Tensor, do: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's arithmetic, untiled, with the reference's
    rounding points: ``p`` and ``ds`` rounded to the storage type before
    their products, ``k·scale`` rounded for the dq product, ``dk``
    scaled after the sum.  k and v may have KV heads dividing H: dk and dv
    are summed over each group in float32 and rounded once, the kernel's
    point.  lse, delta: ``(B·H, T)`` float32; do in q's dtype.  Returns
    (dq, dk, dv) in q's dtype, dk and dv ``(B, T, KV, D)``."""
    dt = q.dtype
    n_kv = k.shape[2]
    dq, dk, dv = _bwd_sums(q, k, v, lse, delta, do, causal)
    dk = group_sum(dk, n_kv) * (1.0 / math.sqrt(q.shape[3]))
    return dq.to(dt), dk.to(dt), group_sum(dv, n_kv).to(dt)


def _flash_bwd_kernel(q, k, v, lse, delta, do, causal: bool):
    global bwd_launches, d128_bwd_launches, f32_bwd_launches
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(f"flash backward takes float32 or bfloat16 q/k/v/do "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}/"
                        f"{do.dtype}")
    KV = _check_kv_heads(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores and not (D == 128 or (D == 64 and KV == H)):
        raise ValueError(f"the bf16 flash backward takes head dim 64 "
                         f"without KV groups or head dim 128, not head dim "
                         f"{D} with {H} query heads over {KV}")
    if not tensor_cores and (D not in F32_HEAD_DIMS or KV != H):
        raise ValueError(f"the float32 flash backward takes head dim "
                         f"{F32_HEAD_DIMS} without KV groups, not head dim "
                         f"{D} with {H} query heads over {KV}")
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
    if tensor_cores:
        _check_tc_operands(q=q, k=k, v=v, do=do)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((B, T, KV, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    fn = _build.entry("rtt_flash_attention_bwd")
    rc = launch_on(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        int(causal), LOG2E / math.sqrt(D), 1.0 / math.sqrt(D),
        _DTYPES[q.dtype], stream))
    _build.check(rc, "rtt_flash_attention_bwd")
    if tensor_cores and D == 128:
        d128_bwd_launches += 1
    elif tensor_cores:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    return dq, dk, dv


def backward_occupancy(pass_: int) -> Tuple[int, int]:
    """(dynamic shared memory bytes, resident blocks an SM) of the bf16
    head-dim-128 backward's dK/dV (0) or dQ (1) kernel, from the CUDA
    occupancy calculator on the current device (builds the library)."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _build.entry("rtt_flash_attention_bwd_occupancy")(
        pass_, ctypes.byref(smem), ctypes.byref(blocks))
    _build.check(rc, "rtt_flash_attention_bwd_occupancy")
    return smem.value, blocks.value


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, delta: torch.Tensor,
                        do: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's base-2 lse and ``delta``: the
    kernel on a CUDA tensor, the plain version on a CPU tensor.  k and v,
    and so dk and dv, are (B, T, KV, D)."""
    if q.device.type == "cuda":
        return _flash_bwd_kernel(q, k, v, lse, delta, do, causal)
    _check_kv_heads(q, k, v)
    return flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its lse, as one op: ``(out (B, T, H, D), lse
    (B·H, T) float32)``, both contiguous (the kernel's layout; the plain
    version's einsum may leave another)."""
    out, lse = flash_attention_fwd(q, k, v, causal, want_lse=True)
    return out.contiguous(), lse.contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal):
    B, T, H, D = q.shape
    return (q.new_empty((B, T, H, D)),
            q.new_empty((B * H, T), dtype=torch.float32))


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.causal = causal


def _flash_fwd_backward(ctx, g, _g_lse):
    # lse carries no gradient: its cotangent is ignored
    q, k, v, out, lse = ctx.saved_tensors
    B, T, H, _ = q.shape
    # delta = sum_D do * o in float32, in the residual layout
    delta = (g.float() * out.float()).sum(dim=-1)              # (B, T, H)
    delta = delta.transpose(1, 2).reshape(B * H, T)
    dq, dk, dv = flash_attention_bwd(q, k, v, lse, delta, g.to(q.dtype),
                                     ctx.causal)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_flash_fwd_backward,
                               setup_context=_flash_fwd_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, want_lse: bool = False) -> Result:
    """(B, T, H, D), (B, T, KV, D)×2 → (B, T, H, D) tiled attention,
    differentiable; with ``want_lse`` also the base-2 lse, ``(B·H, T)``
    float32."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = flash_fwd_op(q, k, v, causal)
        return (out, lse) if want_lse else out
    return flash_attention_fwd(q, k, v, causal, want_lse)


def flash_attention_for_model(q, k, v, cfg=None, **_):
    """Model hook (``attn_impl='flash'``, and what ``'auto'`` resolves
    to on CUDA): causal flash attention at any sequence length; k and v
    may carry fewer (KV) heads than q."""
    return flash_attention(q, k, v, True)
