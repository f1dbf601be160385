"""T5 encoder-decoder, t5.1.1-base the flagship (port of
``ray_tpu/models/t5.py``).

The t5.1.1 recipe: RMSNorm (no bias, pre-norm, float32 statistics),
gated-GELU feed-forward, no bias in any projection, no 1/√D scale on the
attention scores (folded into the init), an untied LM head, and one
relative-position bias table per stack, bucketed logarithmically and
added to every layer's float32 scores; the decoder's causal mask fills
−1e9 into that bias.  Params are a nested dict with the reference's keys
and shapes, per-layer leaves stacked on a leading ``n_layer`` axis.
RMSNorm is plain PyTorch (inline in the reference too) and attention is
dense: no hand-written kernel runs on this model's path.

The buckets come from a float32 ``log`` truncated to int32, so the table
is computed on the device the model runs on, with true float32 divisions
(by a device tensor: a division by a Python scalar may become a product
by its reciprocal) as the reference computes it; ``tests`` and
``chip_smoke.py`` hold the card's table to the CPU's.
``cfg.remat`` checkpoints each block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import layer_views, normal_init, tree_map

Params = Dict[str, Any]

RMS_EPS = 1e-6
CAUSAL_FILL = -1e9


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    n_embd: int = 768            # d_model
    d_ff: int = 2048             # t5.1.1-base
    n_layer: int = 12            # per stack
    n_head: int = 12
    head_dim: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False


def t5_base() -> T5Config:    # ~250M
    return T5Config()


def t5_large() -> T5Config:   # ~780M
    return T5Config(n_embd=1024, d_ff=2816, n_layer=24, n_head=16)


def tiny(vocab: int = 256) -> T5Config:
    return T5Config(vocab_size=vocab, n_embd=64, d_ff=128, n_layer=2,
                    n_head=4, head_dim=16, rel_buckets=8,
                    rel_max_distance=32)


PRESETS = {"t5-base": t5_base, "t5-large": t5_large, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: Optional[torch.Generator], cfg: T5Config,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` on its own device, placed on
    ``device`` (default ``cuda``), with the reference's shapes and
    scales: the shared embedding N(0, 1), the bias tables N(0, 0.02),
    q (E·D)^-½, k, v and the gates E^-½, the outputs (H·D)^-½ and F^-½,
    the LM head E^-½, RMSNorm scales 1.  On the ``meta`` device nothing
    is drawn (``gen`` may be None)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype
    E, L, H, D, FF = (cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.head_dim,
                      cfg.d_ff)
    HD = H * D

    def dense(shape, scale):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd, scale)

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=pd,
                                    device=dev if meta else None)}

    def stack(cross: bool) -> Params:
        p = {
            "ln_attn": ones(L, E),
            "attn_q": dense((L, E, HD), (E * D) ** -0.5),
            "attn_k": dense((L, E, HD), E ** -0.5),
            "attn_v": dense((L, E, HD), E ** -0.5),
            "attn_o": dense((L, HD, E), HD ** -0.5),
            "ln_mlp": ones(L, E),
            "wi_0": dense((L, E, FF), E ** -0.5),    # gated gelu: gate
            "wi_1": dense((L, E, FF), E ** -0.5),    # gated gelu: value
            "wo": dense((L, FF, E), FF ** -0.5),
        }
        if cross:
            p["ln_cross"] = ones(L, E)
            p["cross_q"] = dense((L, E, HD), (E * D) ** -0.5)
            p["cross_k"] = dense((L, E, HD), E ** -0.5)
            p["cross_v"] = dense((L, E, HD), E ** -0.5)
            p["cross_o"] = dense((L, HD, E), HD ** -0.5)
        return p

    params = {
        "shared_embed": dense((cfg.vocab_size, E), 1.0),
        "enc_rel_bias": dense((cfg.rel_buckets, H), 0.02),
        "dec_rel_bias": dense((cfg.rel_buckets, H), 0.02),
        "encoder": stack(cross=False),
        "decoder": stack(cross=True),
        "enc_ln_f": ones(E),
        "dec_ln_f": ones(E),
        "lm_head": dense((E, cfg.vocab_size), E ** -0.5),
    }
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ forward
def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + RMS_EPS) * scale).to(x.dtype)


def _relative_buckets(rel: torch.Tensor, num_buckets: int, max_dist: int,
                      bidirectional: bool) -> torch.Tensor:
    """T5's log-bucketed relative positions (int32, on rel's device)."""
    def f32(v):               # a device scalar: a fill, no host copy
        return torch.full((), v, dtype=torch.float32, device=rel.device)

    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.float() / f32(max_exact) + 1e-6)
        / f32(math.log(max_dist / max_exact))
        * (num_buckets - max_exact)).to(rel.dtype)
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def _rel_bias(table: torch.Tensor, q_len: int, k_len: int, cfg: T5Config,
              bidirectional: bool) -> torch.Tensor:
    """(buckets, H) table → (1, H, q, k) float32 bias."""
    dev = table.device
    ctx = torch.arange(q_len, dtype=torch.int32, device=dev)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32, device=dev)[None, :]
    buckets = _relative_buckets(mem - ctx, cfg.rel_buckets,
                                cfg.rel_max_distance, bidirectional)
    return table.float()[buckets.long()].permute(2, 0, 1)[None]


def _attn(q, k, v, bias: Optional[torch.Tensor], cfg: T5Config):
    """(B, T, H·D) ×3 + (1|B, H, q, k) bias → (B, q, H·D); no 1/√D."""
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    H, D = cfg.n_head, cfg.head_dim
    logits = torch.einsum("bqhd,bkhd->bhqk", q.reshape(B, Tq, H, D),
                          k.reshape(B, Tk, H, D)).float()
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.reshape(B, Tk, H, D)).reshape(B, Tq, H * D)


def _ff(x: torch.Tensor, lp: Params, cfg: T5Config) -> torch.Tensor:
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_mlp"]["scale"])
    gate = F.gelu(h @ lp["wi_0"].to(dt), approximate="tanh")
    return x + (gate * (h @ lp["wi_1"].to(dt))) @ lp["wo"].to(dt)


def _enc_block(x: torch.Tensor, lp: Params, bias: torch.Tensor,
               cfg: T5Config) -> torch.Tensor:
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_attn"]["scale"])
    a = _attn(h @ lp["attn_q"].to(dt), h @ lp["attn_k"].to(dt),
              h @ lp["attn_v"].to(dt), bias, cfg)
    return _ff(x + a @ lp["attn_o"].to(dt), lp, cfg)


def _dec_block(x: torch.Tensor, lp: Params, enc: torch.Tensor,
               self_bias: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    dt = cfg.dtype
    h = _rms_norm(x, lp["ln_attn"]["scale"])
    a = _attn(h @ lp["attn_q"].to(dt), h @ lp["attn_k"].to(dt),
              h @ lp["attn_v"].to(dt), self_bias, cfg)
    x = x + a @ lp["attn_o"].to(dt)
    h = _rms_norm(x, lp["ln_cross"]["scale"])
    a = _attn(h @ lp["cross_q"].to(dt), enc @ lp["cross_k"].to(dt),
              enc @ lp["cross_v"].to(dt), None, cfg)
    return _ff(x + a @ lp["cross_o"].to(dt), lp, cfg)


def _run_stack(block, x: torch.Tensor, blocks: Params, cfg: T5Config,
               *args) -> torch.Tensor:
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(blocks, cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(block, x, lp, *args, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, lp, *args, cfg)
    return x


def encode(params: Params, input_ids: torch.Tensor,
           cfg: T5Config) -> torch.Tensor:
    """(B, S) ids → encoder states (B, S, E) in ``cfg.dtype``."""
    x = F.embedding(input_ids, params["shared_embed"]).to(cfg.dtype)
    T = input_ids.shape[1]
    bias = _rel_bias(params["enc_rel_bias"], T, T, cfg, bidirectional=True)
    x = _run_stack(_enc_block, x, params["encoder"], cfg, bias)
    return _rms_norm(x, params["enc_ln_f"]["scale"])


def decode(params: Params, decoder_ids: torch.Tensor, enc: torch.Tensor,
           cfg: T5Config) -> torch.Tensor:
    """(B, T) ids and encoder states → (B, T, vocab) float32 logits."""
    x = F.embedding(decoder_ids, params["shared_embed"]).to(cfg.dtype)
    T = decoder_ids.shape[1]
    bias = _rel_bias(params["dec_rel_bias"], T, T, cfg, bidirectional=False)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    bias = torch.where(causal[None, None], bias, CAUSAL_FILL)
    x = _run_stack(_dec_block, x, params["decoder"], cfg, enc, bias)
    x = _rms_norm(x, params["dec_ln_f"]["scale"])
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def forward(params: Params, input_ids: torch.Tensor,
            decoder_ids: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """(B, S) encoder ids + (B, T) decoder ids → (B, T, vocab) float32
    logits."""
    return decode(params, decoder_ids, encode(params, input_ids, cfg), cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: T5Config) -> torch.Tensor:
    """batch: {"inputs": (B, S), "decoder_inputs": (B, T), "targets":
    (B, T)} → mean teacher-forced cross entropy."""
    logits = forward(params, batch["inputs"], batch["decoder_inputs"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["targets"].long()[..., None]).mean()


def param_count_analytic(cfg: T5Config) -> int:
    E, L, HD, F_ = (cfg.n_embd, cfg.n_layer, cfg.n_head * cfg.head_dim,
                    cfg.d_ff)
    enc_layer = 3 * E * HD + HD * E + 2 * E * F_ + F_ * E + 2 * E
    dec_layer = enc_layer + 3 * E * HD + HD * E + E
    shared = cfg.vocab_size * E * 2 + 2 * cfg.rel_buckets * cfg.n_head + 2 * E
    return shared + L * (enc_layer + dec_layer)
