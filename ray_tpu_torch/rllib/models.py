"""Policy/value networks and action distributions on tensors (port of
``ray_tpu/rllib/models.py``).

Reference: ``rllib/models/`` catalog + ``ModelV2``.  As in the reference,
a network is an (init, apply) pair over a dict of params, not a module:
the learners differentiate the apply function with respect to the dict's
leaves and update them with the transforms of ``parallel/transforms.py``.

Layout.  The port keeps the reference's keys and nesting (``pi_0`` …
``vf_out``; ``torso/conv_i``, ``torso/dense``; ``q_i``; ``q_out``) and
its dense weights as (in, out), applied as ``x @ w + b``.  Only the conv
kernels differ: the reference's HWIO becomes PyTorch's (O, I, H, W),
held channels-last.  The pixel torso takes the reference's NHWC
observations as a channels-last NCHW view (no copy), so cuDNN runs NHWC
convolutions, and flattens its output in the reference's (H, W, C) order
before ``dense`` (``_flatten_hwc``: free on a channels-last tensor), so
``dense/w`` keeps its rows.  ``params_from_numpy`` /
``params_to_numpy`` carry the reference's numpy dict across.

Observations are cast to float32 on the device: a uint8 frame uploads as
uint8 and is divided by 255 there, the same values in a quarter of the
bytes.  Inits use ``torch.nn.init.orthogonal_`` and normal draws from an
explicit generator at the reference's scales; they do not reproduce
JAX's bits (weights are carried across for every comparison).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    obs_dim: int
    num_outputs: int          # logits dim (discrete: n; gaussian: 2*act_dim)
    hiddens: Tuple[int, ...] = (256, 256)
    # Pixel path (reference: rllib/models catalog CNNs): non-empty
    # conv_filters → a shared conv torso ((out_ch, kernel, stride) per
    # layer, VALID padding, relu) + dense head feeds separate linear
    # pi/vf (or Q) heads.  obs are NHWC uint8-scale [0,255]; the torso
    # divides by 255.
    obs_shape: Tuple[int, ...] = ()
    conv_filters: Tuple[Tuple[int, int, int], ...] = ()
    conv_dense: int = 512


# The Nature DQN / IMPALA torso (Mnih et al. 2015): the reference's
# default Atari conv stack in rllib/models/catalog.py.
NATURE_CNN_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def make_model_config(observation_space, action_space,
                      config: dict) -> ModelConfig:
    """Catalog entry point (reference: ModelCatalog): rank-3 Box obs get
    the Nature CNN unless ``config['conv_filters']`` overrides."""
    obs_shape = tuple(observation_space.shape)
    conv = config.get("conv_filters")
    if conv is None and len(obs_shape) == 3:
        conv = NATURE_CNN_FILTERS
    return ModelConfig(
        obs_dim=flat_obs_dim(observation_space),
        num_outputs=num_dist_inputs(action_space),
        hiddens=tuple(config.get("fcnet_hiddens", (256, 256))),
        obs_shape=obs_shape,
        conv_filters=tuple(tuple(f) for f in conv) if conv else (),
        conv_dense=int(config.get("conv_dense", 512)))


def _init_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                 scale: float = math.sqrt(2)) -> Params:
    """Orthogonal init — the standard PPO-stability choice."""
    dev = gen.device
    w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=dev)
    torch.nn.init.orthogonal_(w, gain=scale, generator=gen)
    return {"w": w, "b": torch.zeros((fan_out,), dtype=torch.float32,
                                     device=dev)}


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.addmm(p["b"], x, p["w"])


def init_actor_critic(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Separate policy and value towers (reference default: two MLPs)."""
    sizes = (cfg.obs_dim, *cfg.hiddens)
    params: Params = {}
    for tower in ("pi", "vf"):
        for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"{tower}_{i}"] = _init_linear(gen, fi, fo)
    params["pi_out"] = _init_linear(gen, sizes[-1], cfg.num_outputs,
                                    scale=0.01)
    params["vf_out"] = _init_linear(gen, sizes[-1], 1, scale=1.0)
    return params


def actor_critic_apply(params: Params, obs: torch.Tensor,
                       num_hidden: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dist_inputs [B, num_outputs], values [B])."""
    obs = obs.to(torch.float32)
    x = obs
    for i in range(num_hidden):
        x = torch.tanh(_dense(params[f"pi_{i}"], x))
    logits = _dense(params["pi_out"], x)
    v = obs
    for i in range(num_hidden):
        v = torch.tanh(_dense(params[f"vf_{i}"], v))
    values = _dense(params["vf_out"], v)[:, 0]
    return logits, values


# ------------------------------------------------------------- conv torso

def _conv_out_hw(hw: int, kernel: int, stride: int) -> int:
    return (hw - kernel) // stride + 1


def conv_torso_feature_dim(cfg: ModelConfig) -> int:
    return cfg.conv_dense


def init_conv_torso(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Shared conv feature net: conv stack (VALID, relu) → dense(relu).
    Conv kernels (O, I, H, W), channels-last, N(0, 2 / fan_in)."""
    H, W, C = cfg.obs_shape
    dev = gen.device
    params: Params = {}
    in_c = C
    for i, (out_c, k, s) in enumerate(cfg.conv_filters):
        fan_in = k * k * in_c
        w = torch.empty((out_c, in_c, k, k), dtype=torch.float32,
                        device=dev, memory_format=torch.channels_last)
        torch.nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in),
                              generator=gen)
        params[f"conv_{i}"] = {"w": w, "b": torch.zeros(
            (out_c,), dtype=torch.float32, device=dev)}
        H, W, in_c = _conv_out_hw(H, k, s), _conv_out_hw(W, k, s), out_c
    params["dense"] = _init_linear(gen, H * W * in_c, cfg.conv_dense)
    return params


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the reference's NHWC order; a view of
    a channels-last tensor."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def conv_torso_apply(params: Params, obs: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """(B, H, W, C) [0,255] → (B, conv_dense) relu features."""
    x = obs.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    for i, (_, _, s) in enumerate(cfg.conv_filters):
        p = params[f"conv_{i}"]
        x = F.relu(F.conv2d(x, p["w"], p["b"], stride=s))
    return F.relu(_dense(params["dense"], _flatten_hwc(x)))


def init_actor_critic_conv(gen: torch.Generator, cfg: ModelConfig
                           ) -> Params:
    """Shared conv torso + separate linear pi/vf heads (the reference's
    Atari actor-critic shape)."""
    feat = conv_torso_feature_dim(cfg)
    return {"torso": init_conv_torso(gen, cfg),
            "pi_out": _init_linear(gen, feat, cfg.num_outputs, scale=0.01),
            "vf_out": _init_linear(gen, feat, 1, scale=1.0)}


def actor_critic_conv_apply(params: Params, obs: torch.Tensor,
                            cfg: ModelConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    f = conv_torso_apply(params["torso"], obs, cfg)
    logits = _dense(params["pi_out"], f)
    values = _dense(params["vf_out"], f)[:, 0]
    return logits, values


def init_q_net_conv(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"torso": init_conv_torso(gen, cfg),
            "q_out": _init_linear(gen, conv_torso_feature_dim(cfg),
                                  cfg.num_outputs, scale=1.0)}


def q_net_conv_apply(params: Params, obs: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    f = conv_torso_apply(params["torso"], obs, cfg)
    return _dense(params["q_out"], f)


def init_q_net(gen: torch.Generator, cfg: ModelConfig) -> Params:
    sizes = (cfg.obs_dim, *cfg.hiddens, cfg.num_outputs)
    return {f"q_{i}": _init_linear(gen, fi, fo)
            for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:]))}


def q_net_apply(params: Params, obs: torch.Tensor,
                num_layers: int) -> torch.Tensor:
    x = obs.to(torch.float32)
    for i in range(num_layers):
        x = _dense(params[f"q_{i}"], x)
        if i < num_layers - 1:
            x = torch.tanh(x)
    return x


# ------------------------------------------------- catalog dispatchers

Apply = Callable[[Params, torch.Tensor], Any]


def make_actor_critic(gen: torch.Generator, cfg: ModelConfig
                      ) -> Tuple[Params, Apply]:
    """(params on ``gen``'s device, apply(params, obs) -> (dist_inputs,
    values)) per catalog."""
    if cfg.conv_filters:
        return (init_actor_critic_conv(gen, cfg),
                lambda p, obs: actor_critic_conv_apply(p, obs, cfg))
    n_hidden = len(cfg.hiddens)
    return (init_actor_critic(gen, cfg),
            lambda p, obs: actor_critic_apply(p, obs, n_hidden))


def make_q_net(gen: torch.Generator, cfg: ModelConfig
               ) -> Tuple[Params, Apply]:
    """(params, apply(params, obs) -> q-values) per catalog."""
    if cfg.conv_filters:
        return (init_q_net_conv(gen, cfg),
                lambda p, obs: q_net_conv_apply(p, obs, cfg))
    n_layers = len(cfg.hiddens) + 1
    return (init_q_net(gen, cfg),
            lambda p, obs: q_net_apply(p, obs, n_layers))


# ---------------------------------------------------------- weight bridge

def params_from_numpy(tree: Dict[str, Any], model_config: ModelConfig,
                      device: DeviceLike = None) -> Params:
    """The reference's param dict (numpy or anything ``np.asarray``
    takes: dense ``w`` (in, out), conv ``w`` HWIO) → the port's float32
    tensors on ``device`` (default ``cuda``): conv kernels (the rank-4
    leaves, one per layer of ``model_config.conv_filters``) become
    (O, I, H, W), channels-last."""
    dev = resolve_device(device)
    n_conv = 0

    def conv(x):
        nonlocal n_conv
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, np.float32)).to(dev)
        if t.ndim == 4:                               # HWIO → OIHW
            n_conv += 1
            t = t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t

    out = conv(tree)
    if n_conv != len(model_config.conv_filters):
        raise ValueError(f"{n_conv} conv kernels for a model with "
                         f"{len(model_config.conv_filters)} conv layers")
    return out


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The inverse, in one device-to-host copy: float32 numpy arrays in
    the reference's layout, same keys."""
    flat = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
            return
        t = t.detach()
        if t.ndim == 4:                               # OIHW → HWIO
            t = t.permute(2, 3, 1, 0)
        flat.append(t.to(torch.float32).reshape(-1))

    collect(params)
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0)
    off = 0

    def rebuild(t):
        nonlocal off
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        shape = tuple(t.shape[i] for i in (2, 3, 1, 0)) if t.ndim == 4 \
            else tuple(t.shape)
        n = int(np.prod(shape))
        out = host[off:off + n].reshape(shape)
        off += n
        return out

    return rebuild(params)


def clone_params(params: Params) -> Params:
    """A detached copy (the learners update params in place)."""
    if isinstance(params, dict):
        return {k: clone_params(v) for k, v in params.items()}
    return params.detach().clone(memory_format=torch.preserve_format)


# ---------------------------------------------------------------- dists

class Categorical:
    """Discrete action distribution over logits."""

    @staticmethod
    def sample(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Gumbel-max, as ``jax.random.categorical``."""
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=logits.dtype)
        u = u.clamp_min(torch.finfo(logits.dtype).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    @staticmethod
    def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logp_all = F.log_softmax(logits, dim=-1)
        return torch.gather(logp_all, 1,
                            actions.reshape(-1, 1).to(torch.int64))[:, 0]

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    @staticmethod
    def kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
        lp = F.log_softmax(logits_p, dim=-1)
        lq = F.log_softmax(logits_q, dim=-1)
        return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)

    @staticmethod
    def deterministic(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)


class DiagGaussian:
    """Continuous actions; dist_inputs = concat(mean, log_std)."""

    @staticmethod
    def _split(inputs):
        mean, log_std = torch.chunk(inputs, 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    @staticmethod
    def sample(inputs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                            dtype=mean.dtype)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(inputs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        z = (actions - mean) / torch.exp(log_std)
        return torch.sum(-0.5 * z ** 2 - log_std
                         - 0.5 * math.log(2 * math.pi), dim=-1)

    @staticmethod
    def entropy(inputs: torch.Tensor) -> torch.Tensor:
        _, log_std = DiagGaussian._split(inputs)
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)

    @staticmethod
    def kl(inputs_p: torch.Tensor, inputs_q: torch.Tensor) -> torch.Tensor:
        mp, lp = DiagGaussian._split(inputs_p)
        mq, lq = DiagGaussian._split(inputs_q)
        return torch.sum(lq - lp + (torch.exp(2 * lp) + (mp - mq) ** 2)
                         / (2 * torch.exp(2 * lq)) - 0.5, dim=-1)

    @staticmethod
    def deterministic(inputs: torch.Tensor) -> torch.Tensor:
        mean, _ = DiagGaussian._split(inputs)
        return mean


def get_dist_class(action_space):
    if hasattr(action_space, "n"):
        return Categorical
    return DiagGaussian


def num_dist_inputs(action_space) -> int:
    if hasattr(action_space, "n"):
        return int(action_space.n)
    return 2 * int(np.prod(action_space.shape))


def flat_obs_dim(observation_space) -> int:
    return int(np.prod(observation_space.shape))
