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
sharding table as data; ``spmd.build_train_program(rules=LLAMA_RULES)``
applies it.  The context-parallel impls (``ring``, ``ulysses``, over
``context_axis``) take K/V expanded to the query heads, as the
reference's; without a mesh they are dense attention.  Over a mesh of
ranks ``loss_fn`` returns the global loss on every rank, the batch split
over ``data`` × ``fsdp``, the sequence over ``context`` with RoPE at the
chunk's global positions:

- under ``fsdp`` every matrix is gathered at use (ZeRO-3,
  ``mesh.gather_for_use``: a block's inside its checkpointed region, as
  GPT-2's);
- under ``tensor`` a rank runs the Megatron block: its H/tp query heads
  over its KV/tp KV heads (local query head h reads local KV head
  h // (H / KV), as the global head does; ``tensor`` must divide both),
  ``wo`` and ``w_down`` row-split with a ``psum`` over ``tensor``, the
  embedding and the LM head vocabulary-parallel (``gpt2._vocab_embed``,
  ``gpt2.vocab_parallel_nll``: the reference's full float32
  log-softmax as a log-sum-exp over the ranks' slices);
- under ``pipeline`` (the reference has no schedule for Llama: its
  ``forward`` is one ``lax.scan`` over the stacked layers GSPMD splits)
  every rank runs every layer on its rows, each layer fetched from the
  stage that holds it at use, in ``cfg.dtype`` (every leaf stacked over
  ``pipeline`` is a matrix; the RMSNorm scales are replicated), inside
  its checkpointed region; under ``seq`` (no rule names it, unless
  ``context_axis`` does) nothing is split.  Both compute the same rows on every rank, counted
  once by the step (``spmd``'s docstring).
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
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import mesh as mesh_lib

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


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embeddings over (B, T, H, D), positions offset..offset+T-1."""
    T, D = x.shape[1], x.shape[-1]
    freqs = _rope_freqs(theta, D // 2, x.device)
    pos = torch.arange(offset, offset + T, dtype=torch.float32,
                       device=x.device)
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
        if impl == "ring":
            from ray_tpu_torch.ops.ring_attention import \
                ring_attention_for_model as hook
        else:
            from ray_tpu_torch.ops.ulysses import \
                ulysses_attention_for_model as hook

        def context_parallel(q, k, v, cfg):
            H = q.shape[2]
            return hook(q, _gqa_expand(k, H), _gqa_expand(v, H), cfg,
                        axis_name=cfg.context_axis)
        return context_parallel
    raise ValueError(f"unknown attn_impl {impl!r} (expected auto, dense, "
                     f"flash, ring or ulysses)")


def _mlp(x: torch.Tensor, lp: Params, cfg: LlamaConfig,
         reduce: Callable[[torch.Tensor], torch.Tensor] = lambda y: y
         ) -> torch.Tensor:
    """x + SwiGLU(RMSNorm(x)); ``reduce`` sums the row-split product
    (``psum`` over ``tensor`` in the Megatron block)."""
    dt = cfg.dtype
    h = _rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_eps)
    gate = F.silu(h @ lp["w_gate"]["kernel"].to(dt))
    up = h @ lp["w_up"]["kernel"].to(dt)
    return x + reduce((gate * up) @ lp["w_down"]["kernel"].to(dt))


def _block(x: torch.Tensor, lp: Params, cfg: LlamaConfig, attn: AttnImpl,
           collect_kv: bool = False, pos_offset: int = 0,
           reduce: Callable[[torch.Tensor], torch.Tensor] = lambda y: y):
    """One decoder block; with ``collect_kv`` also returns the post-RoPE
    pre-GQA-expand (k, v) for the serving engine's prefill cache fill.
    ``pos_offset``: the global position of x's first token.  The heads
    are those the projections hold: under ``tensor`` (``reduce`` the
    ``psum`` over it) a rank's H/tp query heads over its KV/tp KV heads,
    local query head h reading local KV head h // (H / KV), as the
    global head does."""
    B, T, E = x.shape
    D = cfg.head_dim
    dt = cfg.dtype
    h = _rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_eps)
    q = (h @ lp["wq"]["kernel"].to(dt)).view(B, T, -1, D)
    k = (h @ lp["wk"]["kernel"].to(dt)).view(B, T, -1, D)
    v = (h @ lp["wv"]["kernel"].to(dt)).view(B, T, -1, D)
    q = _rope(q, cfg.rope_theta, pos_offset)
    k = _rope(k, cfg.rope_theta, pos_offset)
    a = attn(q, k, v, cfg).reshape(B, T, -1)
    out = _mlp(x + reduce(a @ lp["wo"]["kernel"].to(dt)), lp, cfg, reduce)
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
    (the reference's ``jax.checkpoint`` around the block).  Under a mesh
    of ranks ``tokens`` are this rank's chunk, at global positions from
    ``pos_offset``."""
    return _forward(params, tokens, cfg)


def _forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
             pos_offset: int = 0, mesh=None) -> torch.Tensor:
    """``forward``; ``mesh``: a mesh of ranks (``_hidden``), whose
    ``tensor`` ranks each give the logits of their vocabulary slice."""
    x = _hidden(params, tokens, cfg, pos_offset, mesh)
    lm_head = params["lm_head"]
    if mesh is not None:
        lm_head = mesh_lib.gather_for_use(lm_head, _use_specs(cfg)[
            "lm_head"], mesh)
    return (x @ lm_head["kernel"].to(cfg.dtype)).float()


def _hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            pos_offset: int = 0, mesh=None) -> torch.Tensor:
    """The final-RMSNorm hidden states.  ``mesh``: a mesh of ranks whose
    ``fsdp`` pieces are gathered at use, whose layers are fetched from
    their ``pipeline`` stage at use (in bf16: ``cfg.dtype``), and whose
    ``tensor`` ranks run the Megatron block (the embedding from the
    vocabulary slice, summed over ``tensor``)."""
    specs = _use_specs(cfg) if mesh is not None else None
    tp = 1 if mesh is None else mesh.shape["tensor"]

    def gather(tree, spec_of):
        return tree if specs is None else \
            mesh_lib.gather_for_use(tree, spec_of(specs), mesh)

    attn = _resolve_attn(cfg, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    wte = gather(params["wte"], lambda sp: sp["wte"])
    if tp > 1:
        from ray_tpu_torch.models.gpt2 import _vocab_embed, vocab_offset
        x = col.psum(_vocab_embed(wte, tokens,
                                  vocab_offset(cfg.vocab_size, mesh),
                                  cfg.dtype), "tensor", mesh)
    else:
        x = _embed({"wte": wte}, tokens, cfg)
    del wte
    reduce = (lambda y: col.psum(y, "tensor", mesh)) if tp > 1 \
        else (lambda y: y)
    plain = functools.partial(_block, cfg=cfg, attn=attn,
                              pos_offset=pos_offset, reduce=reduce)
    if specs is None:
        layers = [(lp, None) for lp in layer_views(params["blocks"],
                                                   cfg.n_layer)]
    else:
        layers = mesh_lib.layers_for_use(params["blocks"], specs["blocks"],
                                         cfg.n_layer, mesh)
    for lp, lspecs in layers:
        def block(x, lp, lspecs=lspecs):
            if lspecs is not None:
                lp = mesh_lib.gather_for_use(lp, lspecs, mesh, cfg.dtype)
            return plain(x, lp)
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(block, x, lp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, lp)
    return _rms_norm(x, params["norm_f"]["scale"], cfg.rms_eps)


@functools.lru_cache(maxsize=16)
def _use_specs(cfg: LlamaConfig) -> Params:
    """``LLAMA_RULES``' specs of the global tree with its shapes (from the
    meta tree: nothing drawn)."""
    return mesh_lib.use_specs(init_params(None, cfg, "meta"), LLAMA_RULES)


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
    mesh = mesh_lib.get_ambient_mesh()
    if mesh is not None and mesh.size > 1:
        return _mesh_loss(params, inp, tgt.long(), cfg, mesh)
    logp = torch.log_softmax(forward(params, inp, cfg), dim=-1)
    return -logp.gather(-1, tgt.long()[..., None])[..., 0].mean()


def check_mesh(cfg: LlamaConfig, mesh) -> Tuple[str, int, int]:
    """(the context axis, its size, this rank's chunk) of a mesh Llama
    runs over; raises where it cannot.  A ``tensor`` that does not divide
    the query and the KV heads raises: the Megatron block keeps whole
    heads a rank, where the reference's GSPMD re-lays the split columns
    out with collectives of its own (the same function)."""
    tp = mesh.shape["tensor"]
    if tp > 1 and (cfg.n_head % tp or cfg.n_kv_head % tp):
        raise ValueError(
            f"tensor={tp} must divide n_head={cfg.n_head} and n_kv_head="
            f"{cfg.n_kv_head}: a rank holds whole query heads and the "
            f"whole KV heads they read")
    axis = cfg.context_axis or "context"
    cp = mesh.shape.get(axis, 1)
    if cp > 1 and cfg.attn_impl not in ("ring", "ulysses"):
        raise ValueError(f"mesh has {axis}={cp}: attn_impl must be 'ring' "
                         f"or 'ulysses', not {cfg.attn_impl!r}")
    return axis, cp, mesh.coords.get(axis, 0)


def mesh_hidden(params: Params, inp: torch.Tensor, cfg: LlamaConfig,
                mesh) -> torch.Tensor:
    """This rank's final-RMSNorm hidden states over a mesh: its rows, its
    ``context`` chunk."""
    axis, cp, c = check_mesh(cfg, mesh)
    Tc = inp.shape[1] // cp
    return _hidden(params, inp[:, c * Tc:(c + 1) * Tc], cfg, c * Tc, mesh)


def _mesh_loss(params: Params, inp: torch.Tensor, tgt: torch.Tensor,
               cfg: LlamaConfig, mesh) -> torch.Tensor:
    """The global mean NLL on every rank: this rank's rows of its
    ``context`` chunk, the vocabulary-parallel NLL under ``tensor``
    (``gpt2.vocab_parallel_nll``), summed over the batch and context
    axes.  ``pipeline`` and ``seq`` (unless it is the context axis)
    compute the same rows on every rank (``spmd``'s docstring)."""
    from ray_tpu_torch.models.gpt2 import vocab_offset, vocab_parallel_nll
    axis, cp, c = check_mesh(cfg, mesh)
    B, T = inp.shape
    if T % cp:
        raise ValueError(f"seq_len {T} not divisible by {axis}={cp}")
    Tc = T // cp
    logits = _forward(params, inp[:, c * Tc:(c + 1) * Tc], cfg,
                      pos_offset=c * Tc, mesh=mesh)
    t = tgt[:, c * Tc:(c + 1) * Tc]
    nll = vocab_parallel_nll(logits, t, vocab_offset(cfg.vocab_size, mesh),
                             mesh)
    axes = tuple(mesh.config.batch_axes()) + ((axis,) if cp > 1 else ())
    n = B * T * math.prod(mesh.shape[a] for a in mesh.config.batch_axes())
    return col.psum(nll.sum(), axes, mesh) / n


# Sharding: attention/MLP matrices split fsdp×tensor; RoPE/norms
# replicated.  (param-path regex, mesh axis per dim), the reference's
# PartitionSpecs as tuples.
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
