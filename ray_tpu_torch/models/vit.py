"""Vision Transformer, ViT-B/16 the flagship (port of
``ray_tpu/models/vit.py``).

The reference's recipe: the patch embedding as a reshape and one matrix
product (``patchify``: patches in (gh, gw) order, each flattened in (p,
p, C) order), a CLS token, learned position embeddings, pre-LN blocks
with dense attention, bf16 activations with float32 LayerNorm
statistics and softmax, the head zero-initialised.  Params are a nested
dict with the reference's keys and shapes, per-layer leaves stacked on a
leading ``n_layer`` axis.  Every LayerNorm (eps 1e-6) goes through
``ops.layer_norm.layer_norm``, on CUDA the hand-written kernel; the
final one runs on the CLS rows ``x[:, 0]``, a strided (B, E) view that
the kernel reads in place (a row stride of (T·E) elements).
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
from ray_tpu_torch.ops.layer_norm import layer_norm

Params = Dict[str, Any]

LN_EPS = 1e-6


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_b16() -> ViTConfig:    # 86M
    return ViTConfig()


def vit_l16() -> ViTConfig:    # 307M
    return ViTConfig(n_embd=1024, n_layer=24, n_head=16)


def tiny(image_size: int = 32, patch_size: int = 8,
         num_classes: int = 10) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=patch_size,
                     num_classes=num_classes, n_embd=64, n_layer=2, n_head=4)


PRESETS = {"vit-b16": vit_b16, "vit-l16": vit_l16, "tiny": tiny}


def init_params(gen: Optional[torch.Generator], cfg: ViTConfig,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` on its own device, placed on
    ``device`` (default ``cuda``), with the reference's shapes and
    scales: N(0, 0.02), the output projections 0.02/√(2L), the CLS token,
    biases and the head zero, LayerNorm scales 1.  On the ``meta`` device
    nothing is drawn (``gen`` may be None)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype
    E, L = cfg.n_embd, cfg.n_layer
    M = cfg.mlp_ratio * E
    P, C = cfg.patch_size, 3
    res = 0.02 / math.sqrt(2 * L)

    def dense(shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd, scale)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=pd,
                          device=dev if meta else None)

    def norm(*lead):
        return {"scale": const(1.0, *lead, E), "bias": const(0.0, *lead, E)}

    blocks = {
        "ln_1": norm(L),
        "attn_qkv": {"kernel": dense((L, E, 3, E)),
                     "bias": const(0.0, L, 3, E)},
        "attn_out": {"kernel": dense((L, E, E), res),
                     "bias": const(0.0, L, E)},
        "ln_2": norm(L),
        "mlp_in": {"kernel": dense((L, E, M)), "bias": const(0.0, L, M)},
        "mlp_out": {"kernel": dense((L, M, E), res),
                    "bias": const(0.0, L, E)},
    }
    params = {
        "patch_embed": {"kernel": dense((P * P * C, E)),
                        "bias": const(0.0, E)},
        "cls_token": const(0.0, 1, 1, E),
        "pos_embed": dense((cfg.num_patches + 1, E)),
        "blocks": blocks,
        "ln_f": norm(),
        "head": {"kernel": const(0.0, E, cfg.num_classes),
                 "bias": const(0.0, cfg.num_classes)},
    }
    return tree_map(lambda t: t.to(dev), params)


def _layer_norm(x, scale, bias):
    return layer_norm(x, scale, bias, LN_EPS)


def _dense(x: torch.Tensor, p: Params, dt: torch.dtype) -> torch.Tensor:
    return x @ p["kernel"].to(dt) + p["bias"].to(dt)


def _attention(q, k, v):
    """(B, T, H, D) bidirectional: scores scaled in q's dtype, softmax in
    float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block(x: torch.Tensor, lp: Params, cfg: ViTConfig) -> torch.Tensor:
    B, T, E = x.shape
    H, D, dt = cfg.n_head, cfg.head_dim, cfg.dtype
    h = _layer_norm(x, **lp["ln_1"])
    qkv = (h.reshape(B * T, E)
           @ lp["attn_qkv"]["kernel"].to(dt).reshape(E, 3 * E)) \
        .view(B, T, 3, E) + lp["attn_qkv"]["bias"].to(dt)
    q, k, v = [qkv[:, :, i].reshape(B, T, H, D) for i in range(3)]
    a = _attention(q, k, v).reshape(B, T, E)
    x = x + _dense(a, lp["attn_out"], dt)
    h = _layer_norm(x, **lp["ln_2"])
    h = F.gelu(_dense(h, lp["mlp_in"], dt), approximate="tanh")
    return x + _dense(h, lp["mlp_out"], dt)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) → (B, num_patches, patch·patch·C): a non-overlapping
    conv is a matrix product over the flattened patches."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def forward(params: Params, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """images (B, H, W, C) float → logits (B, num_classes) float32."""
    B = images.shape[0]
    dt = cfg.dtype
    x = _dense(patchify(images.to(dt), cfg.patch_size),
               params["patch_embed"], dt)
    cls = params["cls_token"].to(dt).expand(B, 1, cfg.n_embd)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dt)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params["blocks"], cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(_block, x, lp, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, lp, cfg)
    x = _layer_norm(x[:, 0], **params["ln_f"])
    return _dense(x, params["head"], dt).float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ViTConfig) -> torch.Tensor:
    """batch: {"images": (B, H, W, C), "labels": (B,) int} → mean cross
    entropy."""
    logp = torch.log_softmax(forward(params, batch["images"], cfg), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None]).mean()


def param_count_analytic(cfg: ViTConfig) -> int:
    E, L, M = cfg.n_embd, cfg.n_layer, cfg.mlp_ratio * cfg.n_embd
    per_layer = 4 * E * E + 4 * E + 2 * E * M + E + M + 4 * E
    stem = (cfg.patch_size ** 2 * 3 + 1) * E + (cfg.num_patches + 1) * E + E
    head = (E + 1) * cfg.num_classes + 2 * E
    return stem + L * per_layer + head
