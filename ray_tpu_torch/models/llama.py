"""Llama family (port of ``ray_tpu/models/llama.py``): serving and
training on one device.

Pre-RMSNorm, rotary position embeddings, grouped-query attention, SwiGLU
MLP, untied LM head.  Params are a nested dict of tensors with the
reference's keys and shapes: per-layer leaves stacked on a leading
``n_layer`` axis, float32, cast to ``cfg.dtype`` at each use.  RMSNorm
statistics and RoPE rotations are float32, rounded to the activation
dtype once; logits come back in float32.

Attention follows ``gpt2.py``.  ``attn_impl="auto"`` is a port default:
it resolves to the flash kernel on CUDA (``ops/flash_attention.py``,
which reads the KV heads in place: query head h reads KV head
h // (H / KV)) and to dense attention elsewhere.  The reference's Llama
defaults to ``"dense"``, and its ``"flash"`` is the same function as
GPT-2's.  ``"dense"`` is ``gpt2.dense_causal_attention`` on K/V expanded
as the reference's ``_gqa_expand`` (``jnp.repeat``).  Under autograd the
flash kernel's backward (``flash_attention_bwd``) returns dk and dv with
the KV heads, each summed over its group of query heads.

Training: ``loss_fn`` (the reference's full float32 log-softmax) and
whole-block remat with ``torch.utils.checkpoint`` (``cfg.remat``).
RMSNorm, RoPE and SwiGLU are plain PyTorch, differentiated by autograd,
as the reference leaves them to XLA.  ``LLAMA_RULES`` is the reference's
sharding table as data; the multi-GPU slice applies it.  The
context-parallel impls (``ring``, ``ulysses``, with ``context_axis``)
raise ``NotImplementedError`` until that slice.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import layer_views, normal_init, tree_map
from ray_tpu_torch.models.gpt2 import dense_causal_attention, \
    resolved_attn_impl
from ray_tpu_torch.ops.flash_attention import flash_attention_for_model, \
    gqa_expand as _gqa_expand

Params = Dict[str, Any]
AttnImpl = Callable[..., torch.Tensor]  # (q, k, v, cfg) -> out


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_positions: int = 4096
    n_embd: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32          # < n_head → grouped-query attention
    ffn_dim: int = 11008         # SwiGLU hidden
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16          # activation dtype
    param_dtype: torch.dtype = torch.float32
    # recompute each block in the backward (torch.utils.checkpoint) when
    # grad is enabled
    remat: bool = True
    # "auto" resolves per device: the flash kernel on CUDA, dense
    # attention elsewhere.
    attn_impl: str = "auto"      # auto | dense | flash | ring | ulysses
    # the mesh axis of ring / ulysses attention (the multi-GPU slice)
    context_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def llama2_7b() -> LlamaConfig:
    return LlamaConfig()


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(vocab_size=128256, n_embd=4096, n_layer=32,
                       n_head=32, n_kv_head=8, ffn_dim=14336,
                       rope_theta=500000.0, max_positions=8192)


def tiny(vocab: int = 128, seq: int = 64) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab, max_positions=seq, n_embd=64,
                       n_layer=2, n_head=4, n_kv_head=2, ffn_dim=128)


PRESETS = {"llama2-7b": llama2_7b, "llama3-8b": llama3_8b, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: torch.Generator, cfg: LlamaConfig,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` (on its own device), placed on
    ``device`` (default ``cuda``).  Same keys, shapes and scales as the
    reference: N(0, 0.02), the output projections wo and w_down
    0.02/√(2L), RMSNorm scales 1.  On the ``meta`` device nothing is
    drawn: every leaf is an empty tensor of its shape (the 8 B preset's
    shapes without its 32 GB)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    E, L, FF = cfg.n_embd, cfg.n_layer, cfg.ffn_dim
    kv_dim = cfg.n_kv_head * cfg.head_dim
    out_scale = 0.02 / math.sqrt(2 * L)

    def normal(shape, scale=0.02):
        if dev.type == "meta":
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd, scale)

    def ones(*shape):
        return torch.ones(shape, dtype=pd,
                          device=dev if dev.type == "meta" else None)

    params = {
        "wte": normal((cfg.vocab_size, E)),
        "blocks": {
            "attn_norm": {"scale": ones(L, E)},
            "wq": {"kernel": normal((L, E, E))},
            "wk": {"kernel": normal((L, E, kv_dim))},
            "wv": {"kernel": normal((L, E, kv_dim))},
            "wo": {"kernel": normal((L, E, E), out_scale)},
            "mlp_norm": {"scale": ones(L, E)},
            "w_gate": {"kernel": normal((L, E, FF))},
            "w_up": {"kernel": normal((L, E, FF))},
            "w_down": {"kernel": normal((L, FF, E), out_scale)},
        },
        "norm_f": {"scale": ones(E)},
        "lm_head": {"kernel": normal((E, cfg.vocab_size))},
    }
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ forward
def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device
                ) -> torch.Tensor:
    """theta^(-i/half), i < half, float32 and correctly rounded: computed
    in float64, as the reference's XLA gives it.  (torch's float32 pow is
    one ulp off for some i at theta 1e4, and at position 8191 one ulp of a
    frequency near 1 moves the angle by ~5e-4.)"""
    i = torch.arange(half, dtype=torch.float64, device=device)
    return (theta ** (-i / half)).float()


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (d, d + D/2) of x by ``angles`` (broadcast against
    x's first half), in float32; the result in x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings over (B, T, H, D), positions 0..T-1."""
    T, D = x.shape[1], x.shape[-1]
    freqs = _rope_freqs(theta, D // 2, x.device)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    return _rotate(x, (pos[:, None] * freqs[None, :])[None, :, None, :])


def _rope_at(x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """Rotary embedding for single tokens at explicit positions: x
    (B, H, D), positions (B,) int (decode caches post-RoPE keys, so each
    key is rotated once, at its own position)."""
    freqs = _rope_freqs(theta, x.shape[-1] // 2, x.device)
    angles = positions.float()[:, None] * freqs[None, :]
    return _rotate(x, angles[:, None, :])


def _dense_gqa(q, k, v, cfg: LlamaConfig) -> torch.Tensor:
    H = q.shape[2]
    return dense_causal_attention(q, _gqa_expand(k, H), _gqa_expand(v, H),
                                  cfg)


def _resolve_attn(cfg: LlamaConfig, device: torch.device) -> AttnImpl:
    impl = resolved_attn_impl(cfg, device)
    if impl == "dense":
        return _dense_gqa
    if impl == "flash":
        return flash_attention_for_model
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} (context parallelism) is not ported yet: "
            f"a later slice (ROADMAP queue A)")
    raise ValueError(f"unknown attn_impl {impl!r} (expected auto, dense or "
                     f"flash)")


def _mlp(x: torch.Tensor, lp: Params, cfg: LlamaConfig) -> torch.Tensor:
    """x + SwiGLU(RMSNorm(x))."""
    dt = cfg.dtype
    h = _rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_eps)
    gate = F.silu(h @ lp["w_gate"]["kernel"].to(dt))
    up = h @ lp["w_up"]["kernel"].to(dt)
    return x + (gate * up) @ lp["w_down"]["kernel"].to(dt)


def _block(x: torch.Tensor, lp: Params, cfg: LlamaConfig, attn: AttnImpl,
           collect_kv: bool = False):
    """One decoder block; with ``collect_kv`` also returns the post-RoPE
    pre-GQA-expand (k, v) for the serving engine's prefill cache fill."""
    B, T, E = x.shape
    H, D, KV = cfg.n_head, cfg.head_dim, cfg.n_kv_head
    dt = cfg.dtype
    h = _rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_eps)
    q = (h @ lp["wq"]["kernel"].to(dt)).view(B, T, H, D)
    k = (h @ lp["wk"]["kernel"].to(dt)).view(B, T, KV, D)
    v = (h @ lp["wv"]["kernel"].to(dt)).view(B, T, KV, D)
    q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
    a = attn(q, k, v, cfg).reshape(B, T, E)
    out = _mlp(x + a @ lp["wo"]["kernel"].to(dt), lp, cfg)
    if collect_kv:
        return out, (k, v)
    return out


def _embed(params: Params, tokens: torch.Tensor,
           cfg: LlamaConfig) -> torch.Tensor:
    # gather, then cast: the reference's cast-then-gather values, without
    # a bf16 copy of the whole table
    return F.embedding(tokens, params["wte"]).to(cfg.dtype)


def _head(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    x = _rms_norm(x, params["norm_f"]["scale"], cfg.rms_eps)
    return (x @ params["lm_head"]["kernel"].to(cfg.dtype)).float()


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """tokens (B, T) int → logits (B, T, vocab) in float32.

    With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    whenever grad is enabled: the backward replays the block's forward
    (the reference's ``jax.checkpoint`` around the block)."""
    attn = _resolve_attn(cfg, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    x = _embed(params, tokens, cfg)
    for lp in layer_views(params["blocks"], cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(_block, x, lp, cfg, attn, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, lp, cfg, attn)
    return _head(params, x, cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig) -> torch.Tensor:
    """Mean next-token cross entropy.  batch: {"tokens": (B, T+1)} or an
    {"inputs", "targets"} pair of (B, T) integer tensors.  The full
    float32 log-softmax over the vocabulary, as the reference computes
    it."""
    if "inputs" in batch:
        inp, tgt = batch["inputs"], batch["targets"]
    else:
        inp, tgt = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logp = torch.log_softmax(forward(params, inp, cfg), dim=-1)
    return -logp.gather(-1, tgt.long()[..., None])[..., 0].mean()


# Sharding: attention/MLP matrices split fsdp×tensor; RoPE/norms
# replicated.  (param-path regex, mesh axis per dim), the reference's
# PartitionSpecs as tuples; the multi-GPU slice applies them.
LLAMA_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r".*wte$", ("tensor", "fsdp")),
    (r".*blocks/w[qku].*kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/wv/kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/wo/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*blocks/w_gate/kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/w_up/kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/w_down/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*norm.*scale$", (None,)),
    (r".*lm_head/kernel$", ("fsdp", "tensor")),
    (r".*", (None,)),
]


# -------------------------------------------------- inference (KV cache)
def forward_prefill(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                    last_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: tokens (B, T) → (logits, k, v) with k/v (L, B, T, KV, D)
    in cfg.dtype.  Keys are cached post-RoPE, values pre-GQA-expand (the
    paged decode attention expands groups itself): the layout the engine
    scatters into its pool.

    ``last_pos`` computes logits only at that position, as (B, V);
    ``None`` returns the full (B, T, V)."""
    attn = _resolve_attn(cfg, tokens.device)
    x = _embed(params, tokens, cfg)
    ks, vs = [], []
    for lp in layer_views(params["blocks"], cfg.n_layer):
        x, (k, v) = _block(x, lp, cfg, attn, collect_kv=True)
        ks.append(k)
        vs.append(v)
    if last_pos is not None:
        x = x[:, last_pos]                                   # (B, E)
    return _head(params, x, cfg), torch.stack(ks), torch.stack(vs)


def forward_decode(params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, kv_pool: torch.Tensor,
                   block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                   cfg: LlamaConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the paged KV pool (see gpt2.forward_decode).

    kv_pool (N, L, 2, bs, KV, D), read-only here; returns (logits (B, V)
    f32, new_k (L, B, KV, D), new_v (L, B, KV, D))."""
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode
    B = tokens.shape[0]
    E, H, D, KV = cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.n_kv_head
    dt = cfg.dtype
    x = _embed(params, tokens, cfg)                              # (B, E)
    ks, vs = [], []
    for i, lp in enumerate(layer_views(params["blocks"], cfg.n_layer)):
        # per-layer pools are views of the one pool tensor, not copies
        k_pool, v_pool = kv_pool[:, i, 0], kv_pool[:, i, 1]
        h = _rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_eps)
        q = (h @ lp["wq"]["kernel"].to(dt)).view(B, H, D)
        k = (h @ lp["wk"]["kernel"].to(dt)).view(B, KV, D)
        v = (h @ lp["wv"]["kernel"].to(dt)).view(B, KV, D)
        q = _rope_at(q, positions, cfg.rope_theta)
        k = _rope_at(k, positions, cfg.rope_theta)
        a = paged_attention_decode(q, k_pool, v_pool, block_tables,
                                   ctx_lens, k, v).reshape(B, E)
        x = _mlp(x + a @ lp["wo"]["kernel"].to(dt), lp, cfg)
        ks.append(k)
        vs.append(v)
    return _head(params, x, cfg), torch.stack(ks), torch.stack(vs)
