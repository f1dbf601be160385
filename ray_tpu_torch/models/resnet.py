"""ResNet family, ResNet-50 the flagship (port of
``ray_tpu/models/resnet.py``; BASELINE #2).

The reference's BiT recipe: GroupNorm and weight standardisation in
place of BatchNorm, bf16 activations and float32 params, the head
zero-initialised.  Params are a nested dict with the reference's keys
and shapes: conv weights HWIO, and ``stage{i}`` a LIST of bottleneck
dicts (the bridge in ``convert.py`` and the trees of
``parallel/transforms.py`` walk it in order).

Images arrive (B, H, W, 3) as in the reference.  The forward permutes
them to (B, 3, H, W) without a copy, which is channels-last memory:
every activation stays NHWC in memory, the layout cuDNN's NHWC
convolutions take, and each conv weight is standardised in float32 and
laid out OIHW channels-last in the one copy that casts it.  Convolution,
GroupNorm and max-pool are PyTorch's (the reference computes them
outside any Pallas kernel); no hand-written kernel runs here.

XLA's "SAME" padding is asymmetric where the padding is odd: on an even
input the 7×7/2 stem pads (2, 3), every 3×3/2 conv (0, 1) and the 3×3/2
max-pool (0, 1) with −inf.  ``_same_pads`` computes XLA's split and an
explicit ``F.pad`` applies it; PyTorch's symmetric ``padding=k//2``
would give the same output size shifted by one pixel.
``cfg.remat`` checkpoints each bottleneck block.

Over a mesh of ranks (the ambient mesh ``spmd.build_train_program``
sets; params sliced by ``RESNET_RULES``) ``loss_fn`` returns the global
mean on every rank under ``data`` × ``fsdp`` × ``tensor``: the batch
split over ``data`` and ``fsdp``, every conv kept as its ``fsdp`` piece
of ``cout`` and the head as an MLP output's piece, each gathered at use
(ZeRO-3, ``mesh.gather_for_use``; a block's inside its checkpointed
region).  Under ``tensor`` the convs are replicated, the head's classes
split: a rank computes its columns of the logits, which are gathered
over ``tensor`` before the loss (every ``tensor`` rank then computes the
same loss).  No rule names another axis, and a mesh with one raises.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._common import normal_init, tree_map
from ray_tpu_torch.models._common import param_count  # noqa: F401

Params = Dict[str, Any]


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    gn_groups: int = 32
    remat: bool = False


def resnet18() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2))


def resnet50() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3))


def resnet101() -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 23, 3))


def tiny(num_classes: int = 10) -> ResNetConfig:
    """CIFAR-scale config for tests."""
    return ResNetConfig(stage_sizes=(1, 1), width=16, num_classes=num_classes,
                        gn_groups=8)


PRESETS = {"resnet18": resnet18, "resnet50": resnet50,
           "resnet101": resnet101, "tiny": tiny}


# ------------------------------------------------------------------- params
def init_params(gen: Optional[torch.Generator], cfg: ResNetConfig,
                device: DeviceLike = None) -> Params:
    """Random params drawn from ``gen`` on its own device, placed on
    ``device`` (default ``cuda``), with the reference's shapes and
    scales: convs He fan-out (N(0, 2 / (kh·kw·cout))), GroupNorm scale 1
    and bias 0, the head zero.  On the ``meta`` device nothing is drawn
    (``gen`` may be None)."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    pd = cfg.param_dtype

    def conv(shape):
        if meta:
            return torch.empty(shape, dtype=pd, device=dev)
        return normal_init(gen, shape, pd,
                           math.sqrt(2.0 / (shape[0] * shape[1] * shape[3])))

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=pd,
                          device=dev if meta else None)

    def norm(c):
        return {"scale": const(1.0, c), "bias": const(0.0, c)}

    def bottleneck(cin, cmid, stride):
        cout = cmid * 4
        p = {"conv1": conv((1, 1, cin, cmid)), "gn1": norm(cmid),
             "conv2": conv((3, 3, cmid, cmid)), "gn2": norm(cmid),
             "conv3": conv((1, 1, cmid, cout)), "gn3": norm(cout)}
        if stride != 1 or cin != cout:
            p["proj"] = conv((1, 1, cin, cout))
            p["gn_proj"] = norm(cout)
        return p

    params: Params = {"stem": {"conv": conv((7, 7, 3, cfg.width)),
                               "gn": norm(cfg.width)}}
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** si)
        blocks: List[Params] = []
        for bi in range(n_blocks):
            blocks.append(bottleneck(cin, cmid, _stride(si, bi)))
            cin = cmid * 4
        params[f"stage{si}"] = blocks
    params["head"] = {"kernel": const(0.0, cin, cfg.num_classes),
                      "bias": const(0.0, cfg.num_classes)}
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ forward
def _stride(si: int, bi: int) -> int:
    return 2 if (si > 0 and bi == 0) else 1


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after), the odd
    one after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _standardize(w: torch.Tensor) -> torch.Tensor:
    """Weight standardisation over (kh, kw, cin) in float32: the mean and
    the biased variance, eps 1e-10."""
    w32 = w.float()
    var, mu = torch.var_mean(w32, dim=(0, 1, 2), correction=0, keepdim=True)
    return ((w32 - mu) * torch.rsqrt(var + 1e-10)).to(w.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W) channels-last, w (kh, kw, cin, cout) → the
    standardised conv with XLA's "SAME" padding, in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    w = _standardize(w).permute(3, 2, 0, 1).to(
        dtype=x.dtype, memory_format=torch.channels_last)
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (*pw, *ph)), w, stride=stride)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int) -> torch.Tensor:
    """GroupNorm over contiguous blocks of ``min(groups, C)`` channels:
    float32 statistics (biased variance, eps 1e-5) and affine, the
    output in x's dtype."""
    g = min(groups, x.shape[1])
    return F.group_norm(x.float(), g, scale.float(), bias.float(),
                        1e-5).to(x.dtype)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 / 2 max-pool with XLA's "SAME" padding of −inf."""
    ph = _same_pads(x.shape[2], 3, 2)
    pw = _same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (*pw, *ph), value=-math.inf), 3, 2)


def _bottleneck(x: torch.Tensor, bp: Params, cfg: ResNetConfig,
                stride: int) -> torch.Tensor:
    g = cfg.gn_groups
    y = F.relu(_group_norm(_conv(x, bp["conv1"]), **bp["gn1"], groups=g))
    y = F.relu(_group_norm(_conv(y, bp["conv2"], stride), **bp["gn2"],
                           groups=g))
    y = _group_norm(_conv(y, bp["conv3"]), **bp["gn3"], groups=g)
    if "proj" in bp:
        x = _group_norm(_conv(x, bp["proj"], stride), **bp["gn_proj"],
                        groups=g)
    return F.relu(x + y)


def forward(params: Params, images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images (B, H, W, 3) float → logits (B, num_classes) float32."""
    return _forward(params, images, cfg)


def _forward(params: Params, images: torch.Tensor, cfg: ResNetConfig,
             mesh=None) -> torch.Tensor:
    """``forward``; ``mesh``: a mesh of ranks whose ``fsdp`` pieces are
    gathered at use."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    specs = _use_specs(cfg) if mesh is not None else None

    def gather(tree, spec_of):
        return tree if specs is None else \
            mesh_lib.gather_for_use(tree, spec_of(specs), mesh)

    x = images.to(cfg.dtype).permute(0, 3, 1, 2)      # channels-last
    stem = gather(params["stem"], lambda sp: sp["stem"])
    x = _conv(x, stem["conv"], stride=2)
    x = F.relu(_group_norm(x, **stem["gn"], groups=cfg.gn_groups))
    del stem
    x = _max_pool(x)
    remat = cfg.remat and torch.is_grad_enabled()
    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            def block(x, bp, si=si, bi=bi):
                bp = gather(bp, lambda sp: sp[f"stage{si}"][bi])
                return _bottleneck(x, bp, cfg, _stride(si, bi))

            bp = params[f"stage{si}"][bi]
            if remat:
                # no dropout anywhere: no RNG state to save and restore
                x = checkpoint(block, x, bp, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, bp)
    x = x.mean((2, 3))                                 # global average pool
    head = gather(params["head"], lambda sp: sp["head"])
    kernel, bias = head["kernel"].float(), head["bias"].float()
    tp = 1 if mesh is None else mesh.shape["tensor"]
    if tp == 1:
        return x.float() @ kernel + bias
    # the head's columns split over tensor: this rank's logits, then
    # every rank's gathered (its backward reduce-scatters)
    from ray_tpu_torch.parallel import collectives as col
    n, i = mesh_lib.entry_coordinate(mesh, "tensor")
    lo, hi = mesh_lib.shard_bounds(cfg.num_classes, n, i)
    local = x.float() @ kernel + bias[lo:hi]
    return col.all_gather_uneven(local, "tensor", -1, cfg.num_classes,
                                 -(-cfg.num_classes // n), mesh)


@functools.lru_cache(maxsize=16)
def _use_specs(cfg: ResNetConfig) -> Params:
    """``RESNET_RULES``' specs of the global tree with its shapes (from
    the meta tree: nothing drawn)."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.use_specs(init_params(None, cfg, "meta"), RESNET_RULES)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ResNetConfig, label_smoothing: float = 0.0) -> torch.Tensor:
    """batch: {"images": (B, H, W, 3), "labels": (B,) int} → mean cross
    entropy against one-hot targets, smoothed by ``label_smoothing``.
    The one-hot is a scatter (``F.one_hot`` checks its labels on the
    host, a sync inside the step).  Under an ambient mesh of ranks:
    this rank's rows, the global mean (the module docstring)."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.get_ambient_mesh()
    if mesh is not None and mesh.size > 1:
        for axis, n in mesh.shape.items():
            if axis not in ("data", "fsdp", "tensor") and n > 1:
                raise ValueError(
                    f"ResNet over a mesh with {axis}={n}: no rule of "
                    f"RESNET_RULES names {axis} (images split over data "
                    f"and fsdp, the head's classes over tensor)")
    else:
        mesh = None
    logits = _forward(params, batch["images"], cfg, mesh)
    n = logits.shape[-1]
    targets = torch.zeros_like(logits).scatter_(
        -1, batch["labels"].long()[:, None], 1.0)
    if label_smoothing > 0:
        targets = targets * (1 - label_smoothing) + label_smoothing / n
    logp = torch.log_softmax(logits, dim=-1)
    nll = -(targets * logp).sum(-1)
    if mesh is None:
        return nll.mean()
    from ray_tpu_torch.parallel import collectives as col
    axes = mesh.config.batch_axes()
    return col.psum(nll.sum(), axes, mesh) / (
        nll.numel() * math.prod(mesh.shape[a] for a in axes))


def accuracy(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ResNetConfig) -> torch.Tensor:
    logits = forward(params, batch["images"], cfg)
    return (logits.argmax(-1) == batch["labels"]).float().mean()


# The reference's RESNET_RULES (convs fsdp-sharded on cout, the head like
# an MLP output, the rest replicated) as (path regex, mesh axis per dim).
RESNET_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r".*stem/conv$", (None, None, None, "fsdp")),
    (r".*conv[123]$", (None, None, None, "fsdp")),
    (r".*proj$", (None, None, None, "fsdp")),
    (r".*head/kernel$", ("fsdp", "tensor")),
    (r".*", (None,)),
]
