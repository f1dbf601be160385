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

Over a mesh of ranks (the ambient mesh ``spmd.build_train_program``
sets; params sliced by ``MOE_TRANSFORMER_RULES``, the stacked expert
leaves (L, X/ep, E, ff/tp) a rank) ``loss_fn`` returns the global loss
on every rank: a rank's rows of the batch (split over ``data`` ×
``fsdp``) and its ``context`` chunk of the sequence, its experts (and
their ff columns) run by ``ops/moe.py``'s mesh form, the NLL summed over
the token axes over the global token count, and the global aux and z
losses.  Under ``fsdp`` every matrix is gathered at use as in GPT-2
(``mesh.gather_for_use``, a block's inside its checkpointed region).
Under ``tensor`` attention is the Megatron split (a rank's heads, the
output projection ``psum``'d) and the embedding and the tied head are
vocabulary-parallel.  Under ``context`` a chunk's queries read K and V
all-gathered over it (dense causal attention over the whole sequence,
as the reference's).  ``pipeline`` and ``seq`` compute the same rows on
every rank, each layer fetched from its stage at use, as Llama's.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2 as gpt2_lib
from ray_tpu_torch.models._common import layer_views, normal_init, tree_map
from ray_tpu_torch.ops import moe as moe_lib
from ray_tpu_torch.parallel import mesh as mesh_lib

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
def _block(x: torch.Tensor, lp: Params, cfg: MoEConfig, mesh=None,
           pos0: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Attention (dense causal) + MoE FFN → (y, aux, z, dropped).  Over a
    mesh (``mesh``): the heads this rank's qkv columns hold (the Megatron
    split, the output projection's rows ``psum``'d over ``tensor``, then
    its bias), and under ``context`` the queries of this rank's chunk
    (from ``pos0``) against K and V all-gathered over it."""
    from ray_tpu_torch.parallel import collectives as col
    B, T, E = x.shape
    D = cfg.head_dim
    dt = cfg.dtype
    h = gpt2_lib._layer_norm(x, lp["ln_1"]["scale"], lp["ln_1"]["bias"])
    w = lp["attn_qkv"]["kernel"].to(dt)                # (E, 3, E/tp)
    El = w.shape[-1]
    qkv = (h.reshape(B * T, E) @ w.reshape(E, 3 * El)) \
        .view(B, T, 3, El) + lp["attn_qkv"]["bias"].to(dt)
    q, k, v = [qkv[:, :, i].reshape(B, T, El // D, D) for i in range(3)]
    if col.axis_size("context", mesh) > 1:
        k = col.all_gather(k, "context", 1, mesh)
        v = col.all_gather(v, "context", 1, mesh)
    a = gpt2_lib.dense_causal_attention(q, k, v, None, pos0).reshape(
        B, T, El)
    a = col.psum(a @ lp["attn_out"]["kernel"].to(dt), "tensor", mesh) \
        + lp["attn_out"]["bias"].to(dt)
    x = x + a
    h = gpt2_lib._layer_norm(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"])
    y, m = moe_lib.moe_ffn(
        h, lp["moe"]["router"].float(), lp["moe"]["w_in"].to(dt),
        lp["moe"]["w_out"].to(dt), k=cfg.top_k,
        capacity_factor=cfg.capacity_factor)
    return x + y, m.aux_loss, m.router_z_loss, m.fraction_dropped


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
                   mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, T) → (final-LN hidden states (B, T, E), MoE metrics,
    each the mean over layers).  ``mesh``: a mesh of ranks, ``tokens``
    this rank's rows (``_mesh_loss`` cuts the ``context`` chunk): the
    embedding from the vocabulary slice summed over ``tensor``, the
    ``fsdp`` pieces gathered at use, each layer fetched from its
    ``pipeline`` stage at use (in ``cfg.dtype``), the expert-parallel
    FFN under the ambient mesh."""
    from ray_tpu_torch.parallel import collectives as col
    B, T = tokens.shape
    dt = cfg.dtype
    specs = _use_specs(cfg) if mesh is not None else None
    cp = 1 if mesh is None else mesh.shape["context"]
    pos0 = 0 if cp == 1 else mesh.coords["context"] * (T // cp)
    if cp > 1:
        tokens = tokens[:, pos0:pos0 + T // cp]

    def gather(tree, spec_of):
        return tree if specs is None else \
            mesh_lib.gather_for_use(tree, spec_of(specs), mesh)

    wte = gather(params["wte"], lambda sp: sp["wte"])
    wpe = gather(params["wpe"], lambda sp: sp["wpe"])
    pos = wpe[pos0:pos0 + tokens.shape[1]].to(dt)
    if col.axis_size("tensor", mesh) > 1:
        off = gpt2_lib.vocab_offset(cfg.vocab_size, mesh)
        x = col.psum(gpt2_lib._vocab_embed(wte, tokens, off, dt), "tensor",
                     mesh)
    else:
        x = torch.nn.functional.embedding(tokens, wte).to(dt)
    x = x + pos
    del wte, wpe, pos

    if specs is None:
        layers = [(lp, None) for lp in layer_views(params["blocks"],
                                                   _stacked_layers(params))]
    else:
        layers = mesh_lib.layers_for_use(params["blocks"], specs["blocks"],
                                         cfg.n_layer, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    aux, z, dropped = [], [], []
    for lp, lspecs in layers:
        def block(x, lp, lspecs=lspecs):
            if lspecs is not None:
                lp = mesh_lib.gather_for_use(lp, lspecs, mesh,
                                             _fetch_dtypes(lp, dt))
            return _block(x, lp, cfg, mesh, pos0)
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x, a, zl, d = checkpoint(block, x, lp, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, a, zl, d = block(x, lp)
        aux.append(a)
        z.append(zl)
        dropped.append(d)
    x = gpt2_lib._layer_norm(x, params["ln_f"]["scale"],
                             params["ln_f"]["bias"])
    metrics = {"moe_aux_loss": torch.stack(aux).mean(),
               "moe_z_loss": torch.stack(z).mean(),
               "moe_fraction_dropped": torch.stack(dropped).mean()}
    return x, metrics


def _fetch_dtypes(lp: Params, dt: torch.dtype) -> Params:
    """The dtype each leaf of a layer crosses a ``pipeline`` fetch in:
    the one ``_block`` reads it in (attention's and the experts' matrices
    and biases in ``dt``; None, their own, for the LayerNorm params and
    the router, which it reads in float32)."""
    return {k: {n: None if k.startswith("ln_") or n == "router" else dt
                for n in v} for k, v in lp.items()}


def _stacked_layers(params: Params) -> int:
    return params["blocks"]["ln_1"]["scale"].shape[0]


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, T) → (logits (B, T, vocab) float32, MoE metrics, each
    the mean over layers); on one device (a mesh program's entry point
    is ``loss_fn``)."""
    x, metrics = forward_hidden(params, tokens, cfg)
    logits = x @ params["wte"].to(cfg.dtype).t()
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
    mesh = mesh_lib.get_ambient_mesh()
    if mesh is not None and mesh.size > 1:
        return _mesh_loss(params, inp, tgt.long(), cfg, mesh)[0]
    logits, metrics = forward(params, inp, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
    return (nll.mean() + cfg.aux_loss_weight * metrics["moe_aux_loss"]
            + cfg.z_loss_weight * metrics["moe_z_loss"])


def _mesh_loss(params: Params, inp: torch.Tensor, tgt: torch.Tensor,
               cfg: MoEConfig, mesh
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The global loss on every rank (the module docstring), and the
    global metrics."""
    from ray_tpu_torch.parallel import collectives as col
    tp, cp = mesh.shape["tensor"], mesh.shape["context"]
    B, T = inp.shape
    if cfg.n_head % tp:
        raise ValueError(f"n_head {cfg.n_head} does not split over "
                         f"tensor={tp}")
    if T % cp:
        raise ValueError(f"seq_len {T} not divisible by context={cp}")
    x, metrics = forward_hidden(params, inp, cfg, mesh)
    # the tied head gathers wte again (ZeRO-3)
    wte = mesh_lib.gather_for_use(params["wte"], _use_specs(cfg)["wte"],
                                  mesh)
    c = mesh.coords["context"]
    t = tgt[:, c * (T // cp):(c + 1) * (T // cp)]
    logits = (x @ wte.to(cfg.dtype).t()).float()
    nll = gpt2_lib.vocab_parallel_nll(
        logits, t, gpt2_lib.vocab_offset(cfg.vocab_size, mesh), mesh)
    axes = moe_lib._token_axes(mesh)
    n = B * T * math.prod(mesh.shape[a] for a in mesh.config.batch_axes())
    loss = (col.psum(nll.sum(), axes, mesh) / n
            + cfg.aux_loss_weight * metrics["moe_aux_loss"]
            + cfg.z_loss_weight * metrics["moe_z_loss"])
    return loss, metrics


@functools.lru_cache(maxsize=16)
def _use_specs(cfg: MoEConfig) -> Params:
    """``MOE_TRANSFORMER_RULES``' specs of the global tree with its
    shapes (from the meta tree: nothing drawn)."""
    return mesh_lib.use_specs(init_params(None, cfg, "meta"),
                              MOE_TRANSFORMER_RULES)


# MoE rules first (most specific; first match wins), then the
# transformer set.
MOE_TRANSFORMER_RULES = moe_lib.MOE_RULES + mesh_lib.TRANSFORMER_RULES
