"""GPT-2 family (port of ``ray_tpu/models/gpt2.py``): serving and the
single-device training half.

Params are a nested dict of tensors with the reference's keys and shapes:
per-layer leaves are stacked on a leading ``n_layer`` axis, and the qkv
kernel is ``(E, 3, E)``.  Params are ``cfg.param_dtype`` (float32 by
default; bf16 in bench.py's GPT-2-1.5B recipe) and cast to ``cfg.dtype``
at each use; LayerNorm statistics are float32 with the output in the
activation dtype; GELU is the tanh form; the LM head is tied to ``wte``;
logits come back in float32.

On CUDA, ``attn_impl="auto"`` resolves to the flash kernel
(``ops/flash_attention.py``) and every LayerNorm is the fused kernel
(``ops/layer_norm.py``, the wide-row kernels above E 768); under
autograd they go through the ``flash_fwd`` op and ``LayerNormFn``,
whose backwards are kernels too.  Training:
``loss_fn`` (logsumexp cross entropy, optionally chunked over the
sequence or the vocabulary) and per-block remat with
``torch.utils.checkpoint``, under the reference's four policies:
``full`` replays the whole block; ``dots``, ``attn`` and ``attn_qkv``
are selective (``create_selective_checkpoint_contexts``) and save what
the reference's ``jax.checkpoint`` policies save: the 2-D projections'
products, the flash op's ``(out, lse)``, and those plus the qkv
projection (the op ``ray_tpu_torch::attn_qkv``, the reference's
``checkpoint_name(qkv, "attn_qkv")``).  Meshes, the overlap-scheduled
block and pipelines belong to later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import layer_views as _layers
from ray_tpu_torch.models._common import normal_init as _dense_init
from ray_tpu_torch.models._common import tree_map as _map
from ray_tpu_torch.ops.attention import NEG_INF
from ray_tpu_torch.ops.flash_attention import flash_attention_for_model
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
    remat: bool = True
    # full: recompute each block in the backward (torch.utils.checkpoint
    # around the block).  dots: save the 2-D projections' products and
    # recompute LayerNorm, GELU and attention.  attn: save only the flash
    # op's (out, lse), so the replay never runs the flash forward; needs
    # attn_impl to resolve to "flash".  attn_qkv: attn plus the qkv
    # projection.  An unknown policy raises; none quietly acts as full
    # remat.  Ignored when remat=False.
    remat_policy: str = "full"  # full | dots | attn | attn_qkv
    # "auto" resolves per device: the flash kernel on CUDA, dense
    # attention elsewhere.
    attn_impl: str = "auto"    # auto | dense | flash
    # >0: the LM head and cross entropy in this many sequence chunks, each
    # checkpointed, so the (B, T, vocab) f32 logits never exist at once.
    loss_chunks: int = 0
    # >0: the LM head chunked over the VOCAB axis instead (running
    # logsumexp, each chunk checkpointed); exclusive with loss_chunks.
    loss_vocab_chunks: int = 0

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
    reference: N(0, 0.02), residual projections 0.02/√(2L), wpe 0.01.
    On the ``meta`` device nothing is drawn: every leaf is an empty
    tensor of its shape (what the shm weights plane's attach reads)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype
    E, L = cfg.n_embd, cfg.n_layer
    res = 0.02 / math.sqrt(2 * L)

    def dense(shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return _dense_init(gen, shape, pd, scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev if meta else None)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev if meta else None)

    params = {
        "wte": dense((cfg.vocab_size, E)),
        "wpe": dense((cfg.n_positions, E), 0.01),
        "blocks": {
            "ln_1": {"scale": ones(L, E), "bias": zeros(L, E)},
            "attn_qkv": {"kernel": dense((L, E, 3, E)),
                         "bias": zeros(L, 3, E)},
            "attn_out": {"kernel": dense((L, E, E), res),
                         "bias": zeros(L, E)},
            "ln_2": {"scale": ones(L, E), "bias": zeros(L, E)},
            "mlp_in": {"kernel": dense((L, E, 4 * E)),
                       "bias": zeros(L, 4 * E)},
            "mlp_out": {"kernel": dense((L, 4 * E, E), res),
                        "bias": zeros(L, E)},
        },
        "ln_f": {"scale": ones(E), "bias": zeros(E)},
    }
    return _map(lambda t: t.to(dev), params)


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
        return flash_attention_for_model
    raise ValueError(f"unknown attn_impl {impl!r} (expected auto, dense or "
                     f"flash)")


def _qkv_projection(h: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """h (B, T, E), kernel (E, 3, E), bias (3, E) → (B, T, 3, E):
    "bte,eck->btck" as one (B·T, E) × (E, 3E) product, then the bias."""
    B, T, E = h.shape
    return (h.reshape(B * T, E) @ kernel.reshape(E, 3 * E)) \
        .view(B, T, 3, E) + bias


@torch.library.custom_op("ray_tpu_torch::attn_qkv", mutates_args=())
def attn_qkv_op(h: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The qkv projection as one op, so that a selective remat policy can
    single out its product (``remat_policy="attn_qkv"``)."""
    return _qkv_projection(h, kernel, bias)


@attn_qkv_op.register_fake
def _attn_qkv_fake(h, kernel, bias):
    B, T, E = h.shape
    return h.new_empty((B, T, 3, E))


def _attn_qkv_setup(ctx, inputs, output):
    h, kernel, _ = inputs
    ctx.save_for_backward(h, kernel)


def _attn_qkv_backward(ctx, g):
    h, kernel = ctx.saved_tensors
    B, T, E = h.shape
    g2 = g.reshape(B * T, 3 * E)
    dh = (g2 @ kernel.reshape(E, 3 * E).t()).view(B, T, E)
    dk = (h.reshape(B * T, E).t() @ g2).view(E, 3, E)
    return dh, dk, g.sum((0, 1))


attn_qkv_op.register_autograd(_attn_qkv_backward,
                              setup_context=_attn_qkv_setup)


def _block(x: torch.Tensor, lp: Params, cfg: GPT2Config, attn: AttnImpl,
           collect_kv: bool = False):
    """One transformer block; with ``collect_kv`` also returns the
    per-head (k, v) for the serving engine's prefill cache fill."""
    B, T, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    dt = cfg.dtype
    h = _layer_norm(x, lp["ln_1"]["scale"], lp["ln_1"]["bias"])
    w, b = lp["attn_qkv"]["kernel"].to(dt), lp["attn_qkv"]["bias"].to(dt)
    # the op under autograd (what remat policies see); serving calls the
    # same arithmetic directly, with no op dispatch
    qkv = attn_qkv_op(h, w, b) if torch.is_grad_enabled() \
        else _qkv_projection(h, w, b)
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


# What each selective policy saves, by op (everything else is
# recomputed): the counterparts of the reference's
# dots_with_no_batch_dims_saveable and save_only_these_names.  dots: the
# block's projections are 2-D products after the view (aten.mm; addmm
# where a bias fuses in) and the qkv op; products with batch dims (the
# dense attention's einsums, bmm) are recomputed, as the reference's.
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.ray_tpu_torch.attn_qkv.default),
    "attn": (torch.ops.ray_tpu_torch.flash_fwd.default,),
    "attn_qkv": (torch.ops.ray_tpu_torch.flash_fwd.default,
                 torch.ops.ray_tpu_torch.attn_qkv.default),
}
REMAT_POLICIES = ("full",) + tuple(_SAVED_OPS)


def _save_policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: GPT2Config, device: torch.device):
    """The ``context_fn`` for ``torch.utils.checkpoint`` under
    ``cfg.remat_policy`` (None for ``full``).  Raises for an unknown
    policy, and for ``attn``/``attn_qkv`` where flash does not run: their
    saved op exists only in the flash path, so they would quietly act as
    full remat."""
    policy = cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (expected one "
                         f"of {REMAT_POLICIES})")
    if policy in ("attn", "attn_qkv") \
            and resolved_attn_impl(cfg, device) != "flash":
        raise ValueError(
            f"remat_policy={policy!r} requires attention that resolves to "
            f"'flash' (attn_impl={cfg.attn_impl!r} on {device.type}): the "
            f"saved (out, lse) exist only in the flash op")
    if policy == "full":
        return None
    return partial(create_selective_checkpoint_contexts,
                   partial(_save_policy, _SAVED_OPS[policy]))


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: GPT2Config) -> torch.Tensor:
    """tokens (B, T) int → final-LN hidden states (B, T, E) in cfg.dtype.

    With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    whenever grad is enabled: the backward replays the block's forward,
    less what ``cfg.remat_policy`` saves."""
    B, T = tokens.shape
    attn = _resolve_attn(cfg, tokens.device)
    context = _remat_context(cfg, tokens.device) if cfg.remat else None
    remat = cfg.remat and torch.is_grad_enabled()
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), cfg)
    for lp in _layers(params["blocks"], cfg.n_layer):
        if remat:
            # no dropout anywhere: no RNG state to save and restore
            x = checkpoint(_block, x, lp, cfg, attn, use_reentrant=False,
                           preserve_rng_state=False,
                           **({"context_fn": context} if context else {}))
        else:
            x = _block(x, lp, cfg, attn)
    return _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


def forward(params: Params, tokens: torch.Tensor,
            cfg: GPT2Config) -> torch.Tensor:
    """tokens (B, T) int → logits (B, T, vocab) in float32."""
    x = forward_hidden(params, tokens, cfg)
    return (x @ params["wte"].to(cfg.dtype).t()).float()


def _ce_sum(x: torch.Tensor, wte: torch.Tensor,
            tgt: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of one sequence chunk (checkpointed body)."""
    logits = (x @ wte.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, tgt[..., None])[..., 0]
    return (lse - correct).sum()


def _chunked_ce(x: torch.Tensor, wte: torch.Tensor, tgt: torch.Tensor,
                n_chunks: int) -> torch.Tensor:
    """Mean next-token NLL with the LM head applied per sequence chunk;
    each chunk's (B, T/c, V) logits live only inside one checkpointed
    call and are recomputed in the backward."""
    B, T, E = x.shape
    if T % n_chunks:
        raise ValueError(f"seq len {T} not divisible by loss_chunks "
                         f"{n_chunks}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, tc in zip(x.chunk(n_chunks, dim=1), tgt.chunk(n_chunks, dim=1)):
        total = total + checkpoint(_ce_sum, xc, wte, tc, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (B * T)


def _vocab_chunk(x, w, off: int, V: int, tgt, run_lse, correct):
    """One vocab slice: fold its logsumexp into the running one, and pick
    up the correct-class logit where the target falls in the slice."""
    vc_len = w.shape[0]
    logits = (x @ w.t()).float()
    valid = (off + torch.arange(vc_len, device=x.device)) < V
    logits = logits.masked_fill(~valid, -math.inf)   # padded columns out
    run_lse = torch.logaddexp(run_lse, torch.logsumexp(logits, dim=-1))
    local = tgt - off
    in_chunk = (local >= 0) & (local < vc_len)
    got = logits.gather(-1, local.clamp(0, vc_len - 1)[..., None])[..., 0]
    return run_lse, correct + torch.where(in_chunk, got, 0.0)


def _vocab_chunked_ce(x: torch.Tensor, wte: torch.Tensor, tgt: torch.Tensor,
                      n_chunks: int) -> torch.Tensor:
    """Mean next-token NLL with the LM head applied per VOCAB chunk
    (online logsumexp over the vocab axis): neither the (B, T, V) logits
    nor their gradient exist at once.  V is padded to a multiple of
    ``n_chunks`` with rows whose logits are masked to -inf."""
    B, T, E = x.shape
    V = wte.shape[0]
    vc_len = -(-V // n_chunks)
    pad = vc_len * n_chunks - V
    if pad:
        wte = torch.cat([wte, wte.new_zeros((pad, E))])
    run_lse = torch.full((B, T), -math.inf, dtype=torch.float32,
                         device=x.device)
    correct = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    for c, w in enumerate(wte.split(vc_len)):
        run_lse, correct = checkpoint(
            _vocab_chunk, x, w, c * vc_len, V, tgt, run_lse, correct,
            use_reentrant=False, preserve_rng_state=False)
    return (run_lse - correct).mean()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: GPT2Config) -> torch.Tensor:
    """Next-token cross entropy.  batch: {"tokens": (B, T+1)} or an
    {"inputs", "targets"} pair of (B, T) integer tensors."""
    if "inputs" in batch:
        inp, tgt = batch["inputs"], batch["targets"]
    else:
        inp, tgt = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    tgt = tgt.long()
    if cfg.loss_chunks and cfg.loss_vocab_chunks:
        raise ValueError("loss_chunks and loss_vocab_chunks are exclusive")
    x = forward_hidden(params, inp, cfg)
    wte = params["wte"].to(cfg.dtype)
    if cfg.loss_vocab_chunks:
        return _vocab_chunked_ce(x, wte, tgt, cfg.loss_vocab_chunks)
    if cfg.loss_chunks:
        return _chunked_ce(x, wte, tgt, cfg.loss_chunks)
    # logsumexp, not log_softmax (which would make a second (B, T, V)
    # float32 tensor to read one element a row); the correct-class logit
    # is gathered from the activation-dtype logits, as in the reference.
    logits = x @ wte.t()
    lse = torch.logsumexp(logits.float(), dim=-1)
    correct = logits.gather(-1, tgt[..., None])[..., 0]
    return (lse - correct.float()).mean()


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
    for lp in _layers(params["blocks"], cfg.n_layer):
        x, (k, v) = _block(x, lp, cfg, attn, collect_kv=True)
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
    for i, lp in enumerate(_layers(params["blocks"], cfg.n_layer)):
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


def flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Approximate train-step FLOPs/token (fwd+bwd ≈ 6*N + attention term)."""
    n = param_count_analytic(cfg)
    attn = 12 * cfg.n_layer * cfg.n_embd * seq_len  # 2*2*3 * L * E * T
    return 6 * n + attn


def param_count_analytic(cfg: GPT2Config) -> int:
    E, L, V, Pn = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions
    per_layer = 12 * E * E + 13 * E
    return V * E + Pn * E + L * per_layer + 2 * E
