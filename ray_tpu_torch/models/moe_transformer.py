"""MoE decoder transformer (port of ``ray_tpu/models/moe_transformer.py``).

GPT-2 blocks whose FFN is a top-k routed expert bank
(``ops/moe.py``): LayerNorm, the qkv projection, dense causal attention
(``gpt2.dense_causal_attention``, as the reference: it does not run
flash here), the output projection, LayerNorm, the MoE FFN.  Params are
a nested dict with the reference's keys and shapes, per-layer leaves
stacked on a leading ``n_layer`` axis (``moe/router`` (L, E, X),
``moe/w_in`` (L, X, E, ff), ``moe/w_out`` (L, X, ff, E), X experts).
Params are cast to ``cfg.dtype`` at each use, except the router, which
runs in float32.  On CUDA every LayerNorm is the fused kernel through
``gpt2._layer_norm``.  ``remat=True`` checkpoints each block (its
output and its three metrics) with ``torch.utils.checkpoint``.

``forward`` returns the float32 logits and the metrics, each the mean
over layers; ``loss_fn`` is the next-token NLL plus ``aux_loss_weight``
× the load-balance loss plus ``z_loss_weight`` × the router z-loss.
Expert parallelism over a mesh is the multi-GPU slice's work;
``MOE_TRANSFORMER_RULES`` is the reference's sharding table as data.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2 as gpt2_lib
from ray_tpu_torch.models._common import layer_views, normal_init, tree_map
from ray_tpu_torch.ops import moe as moe_lib

Params = Dict[str, Any]


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    num_experts: int = 8
    expert_ff: int = 3072
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def moe_small() -> MoEConfig:  # ~8x124M-FFN experts
    return MoEConfig()


def tiny(vocab: int = 128, seq: int = 64, experts: int = 4) -> MoEConfig:
    return MoEConfig(vocab_size=vocab, n_positions=seq, n_embd=64, n_layer=2,
                     n_head=4, num_experts=experts, expert_ff=128)


PRESETS = {"moe-small": moe_small, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: Optional[torch.Generator], cfg: MoEConfig,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` on its own device, placed on
    ``device`` (default ``cuda``), with the reference's shapes and scales:
    N(0, 0.02), the output projection 0.02/√(2L), wpe 0.01, the experts
    1/√E in and 1/√ff out.  On the ``meta`` device nothing is drawn
    (``gen`` may be None)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype
    E, L, X, FF = cfg.n_embd, cfg.n_layer, cfg.num_experts, cfg.expert_ff

    def dense(shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd, scale)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=pd,
                          device=dev if meta else None)

    blocks = {
        "ln_1": {"scale": const(1.0, L, E), "bias": const(0.0, L, E)},
        "attn_qkv": {"kernel": dense((L, E, 3, E)),
                     "bias": const(0.0, L, 3, E)},
        "attn_out": {"kernel": dense((L, E, E), 0.02 / math.sqrt(2 * L)),
                     "bias": const(0.0, L, E)},
        "ln_2": {"scale": const(1.0, L, E), "bias": const(0.0, L, E)},
        "moe": {
            "router": dense((L, E, X)),
            "w_in": dense((L, X, E, FF), 1.0 / math.sqrt(E)),
            "w_out": dense((L, X, FF, E), 1.0 / math.sqrt(FF)),
        },
    }
    params = {
        "wte": dense((cfg.vocab_size, E)),
        "wpe": dense((cfg.n_positions, E), 0.01),
        "blocks": blocks,
        "ln_f": {"scale": const(1.0, E), "bias": const(0.0, E)},
    }
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ forward
def _block(x: torch.Tensor, lp: Params, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Attention (dense causal) + MoE FFN → (y, aux, z, dropped)."""
    B, T, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    dt = cfg.dtype
    h = gpt2_lib._layer_norm(x, lp["ln_1"]["scale"], lp["ln_1"]["bias"])
    qkv = (h.reshape(B * T, E)
           @ lp["attn_qkv"]["kernel"].to(dt).reshape(E, 3 * E)) \
        .view(B, T, 3, E) + lp["attn_qkv"]["bias"].to(dt)
    q, k, v = [qkv[:, :, i].reshape(B, T, H, D) for i in range(3)]
    a = gpt2_lib.dense_causal_attention(q, k, v, None).reshape(B, T, E)
    a = a @ lp["attn_out"]["kernel"].to(dt) + lp["attn_out"]["bias"].to(dt)
    x = x + a
    h = gpt2_lib._layer_norm(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"])
    y, m = moe_lib.moe_ffn(
        h, lp["moe"]["router"].float(), lp["moe"]["w_in"].to(dt),
        lp["moe"]["w_out"].to(dt), k=cfg.top_k,
        capacity_factor=cfg.capacity_factor)
    return x + y, m.aux_loss, m.router_z_loss, m.fraction_dropped


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, T) → (logits (B, T, vocab) float32, MoE metrics, each
    the mean over layers)."""
    B, T = tokens.shape
    dt = cfg.dtype
    x = torch.nn.functional.embedding(tokens, params["wte"]).to(dt) \
        + params["wpe"][:T].to(dt)
    remat = cfg.remat and torch.is_grad_enabled()
    aux, z, dropped = [], [], []
    for lp in layer_views(params["blocks"], cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x, a, zl, d = checkpoint(_block, x, lp, cfg, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, a, zl, d = _block(x, lp, cfg)
        aux.append(a)
        z.append(zl)
        dropped.append(d)
    x = gpt2_lib._layer_norm(x, params["ln_f"]["scale"],
                             params["ln_f"]["bias"])
    logits = x @ params["wte"].to(dt).t()
    metrics = {"moe_aux_loss": torch.stack(aux).mean(),
               "moe_z_loss": torch.stack(z).mean(),
               "moe_fraction_dropped": torch.stack(dropped).mean()}
    return logits.float(), metrics


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: MoEConfig) -> torch.Tensor:
    """Next-token NLL (full float32 log-softmax, as the reference) +
    aux_loss_weight · aux + z_loss_weight · z.  batch: {"tokens": (B,
    T+1)} or an {"inputs", "targets"} pair of (B, T) integer tensors."""
    if "inputs" in batch:
        inp, tgt = batch["inputs"], batch["targets"]
    else:
        inp, tgt = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits, metrics = forward(params, inp, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
    return (nll.mean() + cfg.aux_loss_weight * metrics["moe_aux_loss"]
            + cfg.z_loss_weight * metrics["moe_z_loss"])


# The reference's TRANSFORMER_RULES (ray_tpu/parallel/mesh.py) as data,
# (path regex, PartitionSpec entries), until the multi-GPU slice ports
# the mesh layer.
_TRANSFORMER_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r".*wte$", ("tensor", "fsdp")),
    (r".*wpe$", (None, "fsdp")),
    (r".*blocks/attn_qkv/kernel$", ("pipeline", "fsdp", None, "tensor")),
    (r".*blocks/attn_qkv/bias$", ("pipeline", None, "tensor")),
    (r".*blocks/attn_out/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*blocks/attn_out/bias$", ("pipeline", "fsdp")),
    (r".*blocks/mlp_in/kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/mlp_in/bias$", ("pipeline", "tensor")),
    (r".*blocks/mlp_out/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*blocks/mlp_out/bias$", ("pipeline", "fsdp")),
    (r".*blocks/(ln_1|ln_2)/(scale|bias)$", ("pipeline", None)),
    (r".*attn_qkv/kernel$", ("fsdp", None, "tensor")),
    (r".*attn_out/kernel$", ("tensor", "fsdp")),
    (r".*mlp_in/kernel$", ("fsdp", "tensor")),
    (r".*mlp_out/kernel$", ("tensor", "fsdp")),
    (r".*(ln_1|ln_2|ln_f)/(scale|bias)$", (None,)),
    (r".*", (None,)),
]

# MoE rules first (most specific; first match wins), then the
# transformer set.
MOE_TRANSFORMER_RULES = moe_lib.MOE_RULES + _TRANSFORMER_RULES
