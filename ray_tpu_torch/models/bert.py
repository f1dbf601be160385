"""BERT encoder family, BERT-base the flagship (port of
``ray_tpu/models/bert.py``; BASELINE #4, Serve latency).

Post-LN blocks, bidirectional attention under a padding mask, learned
position and segment embeddings, bf16 activations with float32
LayerNorm statistics and softmax.  Params are a nested dict with the
reference's keys and shapes, per-layer leaves stacked on a leading
``n_layer`` axis.  Every LayerNorm (eps 1e-12) goes through
``ops.layer_norm.layer_norm``: on CUDA the hand-written kernel (the
vector-I/O instantiation at E 768), whose arithmetic is the reference's
inline ``_layer_norm``.  Attention stays the reference's dense form: the
scores scaled in bf16, then float32 with ``float32.min`` added at padded
keys.  ``classify`` is the function a Serve replica calls;
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
from ray_tpu_torch.models._common import param_count  # noqa: F401
from ray_tpu_torch.ops.layer_norm import layer_norm

Params = Dict[str, Any]

LN_EPS = 1e-12


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_positions: int = 512
    type_vocab_size: int = 2
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    intermediate: int = 3072
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(n_embd=1024, n_layer=24, n_head=16, intermediate=4096)


def tiny(vocab: int = 128, seq: int = 64) -> BertConfig:
    return BertConfig(vocab_size=vocab, max_positions=seq, n_embd=64,
                      n_layer=2, n_head=4, intermediate=128)


PRESETS = {"bert-base": bert_base, "bert-large": bert_large, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: Optional[torch.Generator], cfg: BertConfig,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` on its own device, placed on
    ``device`` (default ``cuda``), with the reference's shapes and
    scales: N(0, 0.02) matrices and embeddings, zero biases, LayerNorm
    scales 1, the ``cls`` head zero.  On the ``meta`` device nothing is
    drawn (``gen`` may be None)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype
    E, L, FF = cfg.n_embd, cfg.n_layer, cfg.intermediate

    def dense(*shape):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=pd,
                          device=dev if meta else None)

    def norm(*lead):
        return {"scale": const(1.0, *lead, E), "bias": const(0.0, *lead, E)}

    blocks = {
        "attn_qkv": {"kernel": dense(L, E, 3, E), "bias": const(0.0, L, 3, E)},
        "attn_out": {"kernel": dense(L, E, E), "bias": const(0.0, L, E)},
        "ln_1": norm(L),
        "mlp_in": {"kernel": dense(L, E, FF), "bias": const(0.0, L, FF)},
        "mlp_out": {"kernel": dense(L, FF, E), "bias": const(0.0, L, E)},
        "ln_2": norm(L),
    }
    params = {
        "wte": dense(cfg.vocab_size, E),
        "wpe": dense(cfg.max_positions, E),
        "wtype": dense(cfg.type_vocab_size, E),
        "ln_emb": norm(),
        "blocks": blocks,
        "pooler": {"kernel": dense(E, E), "bias": const(0.0, E)},
        "cls": {"kernel": const(0.0, E, cfg.num_labels),
                "bias": const(0.0, cfg.num_labels)},
        "mlm_ln": norm(),
        "mlm_dense": {"kernel": dense(E, E), "bias": const(0.0, E)},
        "mlm_bias": const(0.0, cfg.vocab_size),
    }
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ forward
def _layer_norm(x, scale, bias):
    return layer_norm(x, scale, bias, LN_EPS)


def _dense(x: torch.Tensor, p: Params, dt: torch.dtype) -> torch.Tensor:
    return x @ p["kernel"].to(dt) + p["bias"].to(dt)


def _attention(q, k, v, mask):
    """(B, T, H, D) bidirectional, mask (B, T) 1 = real token: the scores
    scaled in q's dtype, then float32 with float32.min at padded keys."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                       torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float() + bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _block(x: torch.Tensor, mask: torch.Tensor, lp: Params,
           cfg: BertConfig) -> torch.Tensor:
    B, T, E = x.shape
    H, D, dt = cfg.n_head, cfg.head_dim, cfg.dtype
    qkv = (x.reshape(B * T, E)
           @ lp["attn_qkv"]["kernel"].to(dt).reshape(E, 3 * E)) \
        .view(B, T, 3, E) + lp["attn_qkv"]["bias"].to(dt)
    q, k, v = [qkv[:, :, i].reshape(B, T, H, D) for i in range(3)]
    a = _attention(q, k, v, mask).reshape(B, T, E)
    x = _layer_norm(x + _dense(a, lp["attn_out"], dt), **lp["ln_1"])
    h = F.gelu(_dense(x, lp["mlp_in"], dt), approximate="tanh")
    return _layer_norm(x + _dense(h, lp["mlp_out"], dt), **lp["ln_2"])


def encode(params: Params, tokens: torch.Tensor, cfg: BertConfig,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) int → hidden states (B, T, E) in ``cfg.dtype``."""
    B, T = tokens.shape
    dt = cfg.dtype
    mask = attention_mask if attention_mask is not None \
        else torch.ones((B, T), dtype=torch.int32, device=tokens.device)
    types = token_type_ids if token_type_ids is not None \
        else torch.zeros((B, T), dtype=torch.long, device=tokens.device)
    x = F.embedding(tokens, params["wte"]).to(dt) \
        + params["wpe"][:T].to(dt) + F.embedding(types, params["wtype"]).to(dt)
    x = _layer_norm(x, **params["ln_emb"])
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params["blocks"], cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(_block, x, mask, lp, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, mask, lp, cfg)
    return x


def pooled(params: Params, tokens: torch.Tensor, cfg: BertConfig,
           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[CLS] pooled representation (B, E), tanh-activated."""
    h = encode(params, tokens, cfg, attention_mask)
    return torch.tanh(_dense(h[:, 0, :], params["pooler"], cfg.dtype))


def classify(params: Params, tokens: torch.Tensor, cfg: BertConfig,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence classification logits (B, num_labels) float32: the Serve
    path."""
    p = pooled(params, tokens, cfg, attention_mask)
    return p.float() @ params["cls"]["kernel"].float() \
        + params["cls"]["bias"].float()


def mlm_logits(params: Params, tokens: torch.Tensor, cfg: BertConfig,
               attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM logits (B, T, vocab) float32, the embeddings tied."""
    dt = cfg.dtype
    h = encode(params, tokens, cfg, attention_mask)
    h = F.gelu(_dense(h, params["mlm_dense"], dt), approximate="tanh")
    h = _layer_norm(h, **params["mlm_ln"])
    logits = h @ params["wte"].to(dt).t()
    return logits.float() + params["mlm_bias"].float()


def mlm_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: BertConfig) -> torch.Tensor:
    """batch: tokens (B, T), targets (B, T), loss_mask (B, T) 1 = masked
    position, optional attention_mask."""
    logits = mlm_logits(params, batch["tokens"], cfg,
                        batch.get("attention_mask"))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    m = batch["loss_mask"].float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def classification_loss(params: Params, batch: Dict[str, torch.Tensor],
                        cfg: BertConfig) -> torch.Tensor:
    logits = classify(params, batch["tokens"], cfg,
                      batch.get("attention_mask"))
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None]).mean()
