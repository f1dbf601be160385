"""GPT-2 family, serving subset (port of ``ray_tpu/models/gpt2.py``).

Params are a nested dict of tensors with the reference's keys and shapes:
per-layer leaves are stacked on a leading ``n_layer`` axis, and the qkv
kernel is ``(E, 3, E)``.  Params are float32 and cast to ``cfg.dtype`` at
each use; LayerNorm statistics are float32 with the output in the
activation dtype; GELU is the tanh form; the LM head is tied to ``wte``;
logits come back in float32.

On CUDA, ``attn_impl="auto"`` resolves to the flash kernel
(``ops/flash_attention.py``) and every LayerNorm is the fused kernel
(``ops/layer_norm.py``).  Remat, meshes, the overlap-scheduled block,
pipelines and the loss functions belong to the training and multi-GPU
slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import normal_init as _dense_init
from ray_tpu_torch.ops.attention import NEG_INF
from ray_tpu_torch.ops.layer_norm import layer_norm

Params = Dict[str, Any]
AttnImpl = Callable[..., torch.Tensor]  # (q, k, v, cfg) -> out


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16          # activation dtype
    param_dtype: torch.dtype = torch.float32
    # "auto" resolves per device: the flash kernel on CUDA, dense
    # attention elsewhere.
    attn_impl: str = "auto"    # auto | dense | flash

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def gpt2_small() -> GPT2Config:   # 124M
    return GPT2Config(n_embd=768, n_layer=12, n_head=12)


def gpt2_medium() -> GPT2Config:  # 350M
    return GPT2Config(n_embd=1024, n_layer=24, n_head=16)


def gpt2_large() -> GPT2Config:   # 774M
    return GPT2Config(n_embd=1280, n_layer=36, n_head=20)


def gpt2_xl() -> GPT2Config:      # 1.5B
    return GPT2Config(n_embd=1600, n_layer=48, n_head=25)


def tiny(vocab: int = 256, seq: int = 64) -> GPT2Config:
    """Tiny config for tests."""
    return GPT2Config(vocab_size=vocab, n_positions=seq, n_embd=64,
                      n_layer=2, n_head=4)


PRESETS = {"gpt2": gpt2_small, "gpt2-124m": gpt2_small,
           "gpt2-medium": gpt2_medium, "gpt2-large": gpt2_large,
           "gpt2-xl": gpt2_xl, "gpt2-1.5b": gpt2_xl, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: torch.Generator, cfg: GPT2Config,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` (on its own device), placed on
    ``device`` (default ``cuda``).  Same shapes and scales as the
    reference: N(0, 0.02), residual projections 0.02/√(2L), wpe 0.01."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    E, L = cfg.n_embd, cfg.n_layer
    res = 0.02 / math.sqrt(2 * L)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd)

    params = {
        "wte": _dense_init(gen, (cfg.vocab_size, E), pd),
        "wpe": _dense_init(gen, (cfg.n_positions, E), pd, 0.01),
        "blocks": {
            "ln_1": {"scale": ones(L, E), "bias": zeros(L, E)},
            "attn_qkv": {"kernel": _dense_init(gen, (L, E, 3, E), pd),
                         "bias": zeros(L, 3, E)},
            "attn_out": {"kernel": _dense_init(gen, (L, E, E), pd, res),
                         "bias": zeros(L, E)},
            "ln_2": {"scale": ones(L, E), "bias": zeros(L, E)},
            "mlp_in": {"kernel": _dense_init(gen, (L, E, 4 * E), pd),
                       "bias": zeros(L, 4 * E)},
            "mlp_out": {"kernel": _dense_init(gen, (L, 4 * E, E), pd, res),
                        "bias": zeros(L, E)},
        },
        "ln_f": {"scale": ones(E), "bias": zeros(E)},
    }
    return _map(lambda t: t.to(dev), params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s params as views into the stacked leaves."""
    return _map(lambda t: t[i], blocks)


# ------------------------------------------------------------------ forward
def _layer_norm(x, scale, bias, eps=1e-5):
    # The fused kernel serves every E on CUDA (the reference's E % 128
    # gate is a TPU lane-tiling limit); its math is the inline branch's.
    return layer_norm(x, scale, bias, eps)


def dense_causal_attention(q, k, v, cfg: GPT2Config) -> torch.Tensor:
    """Reference attention: (B, T, H, D) → (B, T, H, D)."""
    del cfg
    T = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    # The reference's jnp.where with a float32 fill promotes the scores to
    # float32; masked_fill keeps the dtype, and NEG_INF overflows bf16.
    logits = logits.float().masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def resolved_attn_impl(cfg: GPT2Config, device: torch.device) -> str:
    """Concrete impl for ``attn_impl='auto'``: the flash kernel on CUDA,
    dense attention elsewhere."""
    if cfg.attn_impl == "auto":
        return "flash" if device.type == "cuda" else "dense"
    return cfg.attn_impl


def _resolve_attn(cfg: GPT2Config, device: torch.device) -> AttnImpl:
    impl = resolved_attn_impl(cfg, device)
    if impl == "dense":
        return dense_causal_attention
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention_for_model
        return flash_attention_for_model
    raise ValueError(f"unknown attn_impl {impl!r} (expected auto, dense or "
                     f"flash)")


def _block(x: torch.Tensor, lp: Params, cfg: GPT2Config, attn: AttnImpl,
           collect_kv: bool = False):
    """One transformer block; with ``collect_kv`` also returns the
    per-head (k, v) for the serving engine's prefill cache fill."""
    B, T, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    dt = cfg.dtype
    h = _layer_norm(x, lp["ln_1"]["scale"], lp["ln_1"]["bias"])
    # "bte,eck->btck" as one (B·T, E) × (E, 3E) product
    qkv = (h @ lp["attn_qkv"]["kernel"].to(dt).reshape(E, 3 * E)) \
        .view(B, T, 3, E) + lp["attn_qkv"]["bias"].to(dt)
    # strided views (head dim contiguous): the flash kernel reads them
    # through their strides, with no copy into a (B·H, T, D) layout
    q, k, v = [qkv[:, :, i].unflatten(-1, (H, D)) for i in range(3)]
    a = attn(q, k, v, cfg).reshape(B, T, E)
    a = a @ lp["attn_out"]["kernel"].to(dt) + lp["attn_out"]["bias"].to(dt)
    x = x + a
    h = _layer_norm(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"])
    h = h @ lp["mlp_in"]["kernel"].to(dt) + lp["mlp_in"]["bias"].to(dt)
    h = F.gelu(h, approximate="tanh")
    h = h @ lp["mlp_out"]["kernel"].to(dt) + lp["mlp_out"]["bias"].to(dt)
    out = x + h
    if collect_kv:
        return out, (k, v)
    return out


def _embed(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
           cfg: GPT2Config) -> torch.Tensor:
    # gather, then cast: the same values as casting the tables first
    return F.embedding(tokens, params["wte"]).to(cfg.dtype) \
        + F.embedding(positions, params["wpe"]).to(cfg.dtype)


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: GPT2Config) -> torch.Tensor:
    """tokens (B, T) int → final-LN hidden states (B, T, E) in cfg.dtype."""
    B, T = tokens.shape
    attn = _resolve_attn(cfg, tokens.device)
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), cfg)
    for i in range(cfg.n_layer):
        x = _block(x, _layer(params["blocks"], i), cfg, attn)
    return _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


def forward(params: Params, tokens: torch.Tensor,
            cfg: GPT2Config) -> torch.Tensor:
    """tokens (B, T) int → logits (B, T, vocab) in float32."""
    x = forward_hidden(params, tokens, cfg)
    return (x @ params["wte"].to(cfg.dtype).t()).float()


# -------------------------------------------------- inference (KV cache)
def forward_prefill(params: Params, tokens: torch.Tensor, cfg: GPT2Config,
                    last_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: tokens (B, T) → (logits, k, v), k/v (L, B, T, H, D) in
    cfg.dtype — the per-layer KV the engine scatters into its pool.

    ``last_pos`` computes logits only at that position, as (B, V);
    ``None`` returns the full (B, T, V)."""
    B, T = tokens.shape
    attn = _resolve_attn(cfg, tokens.device)
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), cfg)
    ks, vs = [], []
    for i in range(cfg.n_layer):
        x, (k, v) = _block(x, _layer(params["blocks"], i), cfg, attn,
                           collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if last_pos is not None:
        x = x[:, last_pos]                                   # (B, E)
    logits = x @ params["wte"].to(cfg.dtype).t()
    return logits.float(), torch.stack(ks), torch.stack(vs)


def forward_decode(params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, kv_pool: torch.Tensor,
                   block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                   cfg: GPT2Config
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the paged KV pool.

    tokens/positions (B,) int; kv_pool (N, L, 2, bs, H, D) — read-only
    here (the new token's K/V is returned, not written); block_tables
    (B, MAXB) int; ctx_lens (B,) int.  Returns (logits (B, V) f32,
    new_k (L, B, H, D), new_v (L, B, H, D))."""
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode
    B = tokens.shape[0]
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim
    dt = cfg.dtype
    x = _embed(params, tokens, positions, cfg)                   # (B, E)
    ks, vs = [], []
    for i in range(cfg.n_layer):
        lp = _layer(params["blocks"], i)
        # per-layer pools are views of the one pool tensor, not copies
        k_pool, v_pool = kv_pool[:, i, 0], kv_pool[:, i, 1]
        h = _layer_norm(x, lp["ln_1"]["scale"], lp["ln_1"]["bias"])
        qkv = (h @ lp["attn_qkv"]["kernel"].to(dt).reshape(E, 3 * E)) \
            .view(B, 3, E) + lp["attn_qkv"]["bias"].to(dt)
        q, k, v = [qkv[:, j].reshape(B, H, D) for j in range(3)]
        a = paged_attention_decode(q, k_pool, v_pool, block_tables,
                                   ctx_lens, k, v).reshape(B, E)
        a = a @ lp["attn_out"]["kernel"].to(dt) + lp["attn_out"]["bias"].to(dt)
        x = x + a
        h = _layer_norm(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"])
        h = h @ lp["mlp_in"]["kernel"].to(dt) + lp["mlp_in"]["bias"].to(dt)
        h = F.gelu(h, approximate="tanh")
        h = h @ lp["mlp_out"]["kernel"].to(dt) + lp["mlp_out"]["bias"].to(dt)
        x = x + h
        ks.append(k)
        vs.append(v)
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    logits = x @ params["wte"].to(dt).t()
    return logits.float(), torch.stack(ks), torch.stack(vs)


def param_count_analytic(cfg: GPT2Config) -> int:
    E, L, V, Pn = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions
    per_layer = 12 * E * E + 13 * E
    return V * E + Pn * E + L * per_layer + 2 * E
