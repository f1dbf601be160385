"""PPO: synchronous on-policy sampling + clipped-surrogate SGD (port of
``ray_tpu/rllib/algorithms/ppo.py``).

Reference: ``rllib/algorithms/ppo/ppo.py`` — sample, run SGD epochs over
minibatches, broadcast weights.  The update is the reference's: a fresh
permutation each of ``num_sgd_iter`` epochs (from a ``torch.Generator``
on the learner's device, seeded from the config's seed), ``train_batch //
sgd_minibatch_size`` minibatches of clipped surrogate + clipped value
loss + adaptive-KL penalty, each an Adam step after optax's global-norm
clip.  The epochs run as eager device work with no host read; the
statistics come back in one read a ``training_step``, which the adaptive
KL needs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.evaluation import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTION_DIST_INPUTS, ACTION_LOGP, ACTIONS, ADVANTAGES, OBS, SampleBatch,
    VALUE_TARGETS, VF_PREDS)

LEARNER_COLUMNS = (OBS, ACTIONS, ACTION_LOGP, ACTION_DIST_INPUTS,
                   ADVANTAGES, VALUE_TARGETS, VF_PREDS)
STATS = ("kl", "entropy", "vf_loss", "policy_loss")


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self._cfg.update({
            "lr": 5e-5, "lambda": 0.95, "clip_param": 0.2,
            "vf_clip_param": 10.0, "vf_loss_coeff": 1.0,
            "entropy_coeff": 0.0, "kl_coeff": 0.2, "kl_target": 0.01,
            "num_sgd_iter": 10, "sgd_minibatch_size": 128,
            "train_batch_size": 4000, "grad_clip": 0.5,
        })


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """The reference's ``(adv - adv.mean()) / (adv.std() + 1e-8)``:
    ``jnp.std`` is the population std (ddof 0); ``torch.std``'s default
    is the unbiased one."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def device_batch(batch: SampleBatch, keys, device) -> Dict[str, Any]:
    """The learner's columns on ``device``, one copy each (frames as
    uint8)."""
    return {k: to_device(batch[k], device) for k in keys}


class PPO(Algorithm):
    _default_config_cls = PPOConfig
    _supports_multi_agent = True

    def setup(self, config: Dict[str, Any]) -> None:
        cfg = config
        lw = self.workers.local_worker
        self._ma = hasattr(lw, "policies")
        if self._ma:
            # one learner (update fn + optimizer state + adaptive KL) per
            # policy in the map (reference: multi-agent train_one_step);
            # a per-policy config in the spec tuple overrides the shared
            # algorithm config for THAT policy's learner (lr, clip, ...)
            from ray_tpu_torch.rllib.multi_agent import _policy_spec
            specs = cfg["multiagent"]["policies"]
            self._learners = {}
            for pid, pol in lw.policies.items():
                pconf = _policy_spec(specs.get(pid))[3]
                self._learners[pid] = self._build_learner(
                    pol, {**cfg, **pconf})
        else:
            self._learners = {"default_policy":
                              self._build_learner(lw.policy, cfg)}
        self._kl_target = float(cfg["kl_target"])
        self._gen = torch.Generator(device=lw.policy.device).manual_seed(
            cfg.get("seed") or 0)

    def _build_learner(self, policy, cfg) -> Dict[str, Any]:
        apply_fn = policy.apply_fn
        dist = policy.dist_class
        optimizer = tx.chain(
            tx.clip_by_global_norm(cfg["grad_clip"]),
            tx.adam(cfg["lr"]))
        clip = cfg["clip_param"]
        vf_clip = cfg["vf_clip_param"]
        vf_coeff = cfg["vf_loss_coeff"]
        ent_coeff = cfg["entropy_coeff"]
        num_epochs = int(cfg["num_sgd_iter"])
        mb_size = int(cfg["sgd_minibatch_size"])

        def loss_fn(params, mb, kl_coeff):
            inputs, values = apply_fn(params, mb[OBS])
            logp = dist.logp(inputs, mb[ACTIONS])
            ratio = torch.exp(logp - mb[ACTION_LOGP])
            adv = normalize_advantages(mb[ADVANTAGES])
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
            # Clipped value loss (reference vf_clip_param semantics).
            vf_err = torch.square(values - mb[VALUE_TARGETS])
            v_clipped = mb[VF_PREDS] + torch.clamp(
                values - mb[VF_PREDS], -vf_clip, vf_clip)
            vf_err_clipped = torch.square(v_clipped - mb[VALUE_TARGETS])
            vf_loss = torch.maximum(vf_err, vf_err_clipped).mean()
            entropy = dist.entropy(inputs).mean()
            kl = dist.kl(mb[ACTION_DIST_INPUTS], inputs).mean()
            total = (-surr.mean() + vf_coeff * vf_loss
                     - ent_coeff * entropy + kl_coeff * kl)
            return total, (kl, entropy, vf_loss, -surr.mean())

        def update(params, opt_state, batch, kl_coeff, gen):
            """All epochs × minibatches, params and opt_state in place;
            returns the last minibatch's (kl, entropy, vf_loss,
            policy_loss) as one device tensor."""
            n = batch[OBS].shape[0]
            num_mb = max(n // mb_size, 1)
            if num_mb * mb_size > n:
                raise ValueError(f"a batch of {n} rows is smaller than "
                                 f"sgd_minibatch_size {mb_size}")
            aux = None
            for _ in range(num_epochs):
                perm = torch.randperm(n, generator=gen, device=gen.device)
                for i in range(num_mb):
                    idx = perm[i * mb_size:(i + 1) * mb_size]
                    mb = {k: v.index_select(0, idx)
                          for k, v in batch.items()}
                    grads, aux = grads_with_aux(loss_fn, params, mb,
                                                kl_coeff)
                    # opt_state's moments and count update in place
                    updates, _ = optimizer.update(grads, opt_state, params)
                    apply_updates(params, updates)
            return torch.stack(aux)

        return {"policy": policy, "loss_fn": loss_fn, "update": update,
                "opt_state": optimizer.init(policy.params),
                "kl_coeff": float(cfg["kl_coeff"])}

    def _update_one(self, learner: Dict[str, Any],
                    batch: SampleBatch) -> Dict[str, float]:
        policy = learner["policy"]
        stats = learner["update"](
            policy.params, learner["opt_state"],
            device_batch(batch, LEARNER_COLUMNS, policy.device),
            learner["kl_coeff"], self._gen)
        info = dict(zip(STATS, stats.tolist()))      # the one host read
        # Adaptive KL penalty (reference: ``update_kl``).
        if info["kl"] > 2.0 * self._kl_target:
            learner["kl_coeff"] *= 1.5
        elif info["kl"] < 0.5 * self._kl_target:
            learner["kl_coeff"] *= 0.5
        info["kl_coeff"] = learner["kl_coeff"]
        return info

    def training_step(self) -> Dict[str, Any]:
        batch = synchronous_parallel_sample(self.workers)
        if self._ma:
            info: Dict[str, Any] = {}
            for pid, sb in batch.policy_batches.items():
                if sb.count:
                    info[pid] = self._update_one(self._learners[pid], sb)
        else:
            info = self._update_one(self._learners["default_policy"], batch)
        info["num_env_steps_trained"] = batch.count
        return info

    def get_extra_state(self):
        return {"kl_coeff": {pid: l["kl_coeff"]
                             for pid, l in self._learners.items()}}

    def set_extra_state(self, state):
        if state and "kl_coeff" in state:
            kc = state["kl_coeff"]
            if isinstance(kc, dict):
                for pid, v in kc.items():
                    if pid in self._learners:
                        self._learners[pid]["kl_coeff"] = v
            else:  # pre-multi-agent checkpoints
                for l in self._learners.values():
                    l["kl_coeff"] = kc
