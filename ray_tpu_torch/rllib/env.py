"""Environment layer: registry, RandomEnv, and synchronous vectorization.

A copy of ``ray_tpu/rllib/env.py`` (JAX-free there too; the port imports
nothing of the reference package).  Reference: ``rllib/env/`` — RLlib
wraps gym envs and steps them in a vectorized inner loop inside each
RolloutWorker.  Written against the gymnasium 1.x API (``reset() -> (obs,
info)``, ``step() -> (obs, r, terminated, truncated, info)``).  gymnasium
is imported only where the reference imports it: for its spaces (with a
fallback when it is absent) and for an id that is not registered here, so
the registered envs run on a machine without it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_ENV_REGISTRY: Dict[str, Callable[[dict], Any]] = {}


def register_env(name: str, creator: Callable[[dict], Any]) -> None:
    """Reference: ``ray.tune.registry.register_env``."""
    _ENV_REGISTRY[name] = creator


class _Box:
    def __init__(self, low, high, shape, dtype=np.float32):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        lo = np.broadcast_to(np.asarray(self.low, self.dtype), self.shape)
        hi = np.broadcast_to(np.asarray(self.high, self.dtype), self.shape)
        return rng.uniform(lo, hi).astype(self.dtype)


class _Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))


def make_box(low, high, shape, dtype=np.float32):
    try:
        from gymnasium import spaces
        return spaces.Box(low=low, high=high, shape=shape, dtype=dtype)
    except ImportError:
        return _Box(low, high, shape, dtype)


def make_discrete(n: int):
    try:
        from gymnasium import spaces
        return spaces.Discrete(n)
    except ImportError:
        return _Discrete(n)


class RandomEnv:
    """Uniform-random observations/rewards; episode length is configurable.
    The reference's fake-env test workhorse."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.obs_dim = int(config.get("obs_dim", 4))
        self.num_actions = int(config.get("num_actions", 2))
        self.episode_len = int(config.get("episode_len", 20))
        self.observation_space = make_box(-1.0, 1.0, (self.obs_dim,))
        self.action_space = make_discrete(self.num_actions)
        self._rng = np.random.default_rng(config.get("seed"))
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        terminated = False
        truncated = self._t >= self.episode_len
        return self._obs(), float(self._rng.uniform()), terminated, \
            truncated, {}

    def _obs(self):
        return self._rng.uniform(-1, 1, (self.obs_dim,)).astype(np.float32)


register_env("RandomEnv", lambda cfg: RandomEnv(cfg))


class RandomPixelEnv:
    """Atari-shaped random pixels (default 84×84×4 uint8) — the pixel
    analog of RandomEnv, used for conv-policy plumbing tests and pixel
    rollout throughput benchmarks (reference: baseline #3 'IMPALA Atari
    pixel' runs 84×84×4 stacked frames; no ALE ships in this image, so
    throughput is measured against synthetic frames of the same shape)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.size = int(config.get("size", 84))
        self.frames = int(config.get("frames", 4))
        self.num_actions = int(config.get("num_actions", 6))
        self.episode_len = int(config.get("episode_len", 128))
        shape = (self.size, self.size, self.frames)
        self.observation_space = make_box(0, 255, shape, np.uint8)
        self.action_space = make_discrete(self.num_actions)
        self._rng = np.random.default_rng(config.get("seed"))
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        return self._obs(), float(self._rng.uniform()), False, \
            self._t >= self.episode_len, {}

    def _obs(self):
        return self._rng.integers(
            0, 256, (self.size, self.size, self.frames), dtype=np.uint8)


class PixelSquareEnv:
    """Learnable pixel task: a bright square sits in the LEFT or RIGHT
    half of the frame; action 0 = "left", 1 = "right"; reward 1.0 for
    naming the correct side, else 0.  A random policy averages 0.5 —
    only a net that actually *sees* the frame beats it, which makes this
    the conv-policy learning test (an in-tree stand-in for Atari; the
    reference uses ALE which this image does not ship)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.size = int(config.get("size", 84))
        self.frames = int(config.get("frames", 4))
        self.square = int(config.get("square", max(8, self.size // 7)))
        self.episode_len = int(config.get("episode_len", 16))
        if self.square >= self.size // 2:
            raise ValueError(
                f"square ({self.square}) must fit inside one half of the "
                f"frame (size {self.size} → half {self.size // 2}); pass a "
                f"smaller 'square' or a larger 'size'")
        shape = (self.size, self.size, self.frames)
        self.observation_space = make_box(0, 255, shape, np.uint8)
        self.action_space = make_discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._t = 0
        self._side = 0

    def _obs(self):
        obs = np.zeros((self.size, self.size, self.frames), np.uint8)
        self._side = int(self._rng.integers(2))
        half = self.size // 2
        x0 = int(self._rng.integers(0, half - self.square)) \
            + (half if self._side else 0)
        y0 = int(self._rng.integers(0, self.size - self.square))
        obs[y0:y0 + self.square, x0:x0 + self.square, :] = 255
        return obs

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._side else 0.0
        self._t += 1
        return self._obs(), reward, False, self._t >= self.episode_len, {}


register_env("RandomPixelEnv", lambda cfg: RandomPixelEnv(cfg))
register_env("PixelSquareEnv", lambda cfg: PixelSquareEnv(cfg))


class SlowEnv:
    """Wraps any registered env with a fixed per-step latency
    (``env_config: {"inner": name, "inner_config": {...},
    "step_delay_ms": float}``).

    Models the simulator/remote-game envs async IMPALA exists for: the
    actor spends most of a step WAITING, not computing — exactly the
    latency the actor/learner pipeline hides (reference: IMPALA paper's
    motivation; used by ``rllib_bench.py impala_overlap``)."""

    def __init__(self, cfg: Optional[dict] = None):
        import time as _t
        cfg = cfg or {}
        self._delay = float(cfg.get("step_delay_ms", 2.0)) / 1e3
        self._sleep = _t.sleep
        self._inner = create_env(cfg.get("inner", "RandomEnv"),
                                 cfg.get("inner_config", {}))
        self.observation_space = self._inner.observation_space
        self.action_space = self._inner.action_space

    def reset(self, seed: Optional[int] = None):
        return self._inner.reset(seed=seed)

    def step(self, action):
        self._sleep(self._delay)
        return self._inner.step(action)


register_env("SlowEnv", lambda cfg: SlowEnv(cfg))


def create_env(env: Any, env_config: Optional[dict] = None):
    """Resolve an env spec: registered name, gymnasium id, class, or
    callable."""
    env_config = env_config or {}
    if isinstance(env, str):
        if env in _ENV_REGISTRY:
            return _ENV_REGISTRY[env](env_config)
        import gymnasium
        return gymnasium.make(env, **env_config)
    if isinstance(env, type):
        return env(env_config)
    if callable(env):
        return env(env_config)
    raise ValueError(f"cannot create env from {env!r}")


class VectorEnv:
    """N sub-envs stepped synchronously with auto-reset.

    Reference behavior: ``rllib/env/vector_env.py`` — on termination or
    truncation the sub-env resets immediately and the *reset* obs is
    returned, while done flags mark the boundary for the sampler.
    """

    def __init__(self, env_creator: Callable[[], Any], num_envs: int,
                 seed: Optional[int] = None):
        self.envs = [env_creator() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed

    def reset_all(self) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            seed = None if self._seed is None else self._seed + i
            o, _ = e.reset(seed=seed)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions: np.ndarray):
        """Returns (obs, final_obs, rewards, terminateds, truncateds).

        ``obs`` feeds the next policy step (post-auto-reset at done slots);
        ``final_obs`` is the true successor observation (pre-reset), needed
        to bootstrap truncated episodes correctly.
        """
        obs, finals, rews, terms, truncs = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, _ = e.step(a)
            finals.append(o)
            if term or trunc:
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
        return (np.stack(obs), np.stack(finals),
                np.asarray(rews, np.float32),
                np.asarray(terms), np.asarray(truncs))


# ---------------------------------------------------------------- multi-agent
class MultiAgentEnv:
    """Multi-agent env API (reference: ``rllib/env/multi_agent_env.py``).

    ``reset() -> (obs_dict, info_dict)``; ``step(action_dict) ->
    (obs, rewards, terminateds, truncateds, infos)`` — all keyed by agent
    id; ``terminateds``/``truncateds`` additionally carry ``"__all__"``.
    Agents that are done stop appearing in subsequent dicts.
    """

    agents: list
    observation_space: Any = None   # per-agent space (homogeneous default)
    action_space: Any = None

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


def make_multi_agent(env_name_or_creator):
    """Lift a single-agent env into an N-agent ``MultiAgentEnv`` of
    independent copies (reference: ``ray.rllib.env.make_multi_agent``).
    ``env_config["num_agents"]`` picks N (default 2)."""

    class _IndependentMultiAgent(MultiAgentEnv):
        def __init__(self, config: Optional[dict] = None):
            config = dict(config or {})
            self.num_agents = int(config.pop("num_agents", 2))
            if isinstance(env_name_or_creator, str):
                mk = lambda: create_env(env_name_or_creator, config)  # noqa: E731
            else:
                mk = lambda: env_name_or_creator(config)  # noqa: E731
            self.envs = [mk() for _ in range(self.num_agents)]
            self.agents = [f"agent_{i}" for i in range(self.num_agents)]
            self.observation_space = self.envs[0].observation_space
            self.action_space = self.envs[0].action_space
            self._done = [False] * self.num_agents

        def reset(self, seed: Optional[int] = None):
            obs, infos = {}, {}
            for i, (aid, e) in enumerate(zip(self.agents, self.envs)):
                o, inf = e.reset(seed=None if seed is None else seed + i)
                obs[aid], infos[aid] = o, inf
            self._done = [False] * self.num_agents
            return obs, infos

        def step(self, action_dict: Dict[str, Any]):
            obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
            for i, (aid, e) in enumerate(zip(self.agents, self.envs)):
                if self._done[i] or aid not in action_dict:
                    continue
                o, r, term, trunc, inf = e.step(action_dict[aid])
                obs[aid], rews[aid], infos[aid] = o, float(r), inf
                terms[aid], truncs[aid] = bool(term), bool(trunc)
                if term or trunc:
                    self._done[i] = True
            terms["__all__"] = all(self._done)
            truncs["__all__"] = False
            return obs, rews, terms, truncs, infos

    return _IndependentMultiAgent
