"""IMPALA: async actor-learner with V-trace off-policy correction (port
of ``ray_tpu/rllib/algorithms/impala.py``).

Reference: ``rllib/algorithms/impala/`` — rollout actors continuously
push batches to a learner, which applies V-trace (Espeholt et al. 2018)
to correct for policy lag, then broadcasts weights.  As in the
reference, the "queue" is the object store: each remote worker keeps
exactly one ``sample_with_weights`` call in flight; the learner drains
whichever fragment is ready (``wait``), re-issues that worker at once
with the freshest weights ref, learns on ``num_fragments_per_update``
fragments at a time and puts new weights every ``broadcast_interval``
updates, so the CPU rollout actors sample while the learner updates on
the card.  ``sync_sampling`` is the barrier control (broadcast, wait for
every worker, learn), and a set with no remote workers learns on the
local worker's fragments.  The learner is the reference's: time-major
[T, B] columns, V-trace as a reverse loop over T outside autograd (the
reference stops gradients through ``vs`` and the policy-gradient
advantages), optax's global-norm clip and RMSProp (eps inside the
root).  Its stats stay on the device until one host read an iteration.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.parallel import transforms as tx
from ray_tpu_torch.rllib.algorithms.algorithm import (
    Algorithm, AlgorithmConfig, apply_updates, grads_with_aux)
from ray_tpu_torch.rllib.evaluation import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import to_device
from ray_tpu_torch.rllib.sample_batch import (
    ACTION_LOGP, ACTIONS, NEXT_OBS, OBS, REWARDS, SampleBatch, TERMINATEDS,
    TRUNCATEDS, concat_samples)

STATS = ("policy_loss", "vf_loss", "entropy")


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, discounts, values,
           bootstrap_value, clip_rho: float = 1.0, clip_c: float = 1.0,
           clip_pg_rho: float = None):
    """V-trace targets + policy-gradient advantages.

    All inputs time-major ``[T, B]``; ``bootstrap_value`` is ``[B]``.
    Returns ``(vs [T,B], pg_advantages [T,B])``.  ``clip_pg_rho`` clips the
    importance weights of the pg advantages separately from the value
    targets (reference: vtrace_clip_pg_rho_threshold); defaults to
    ``clip_rho``.  Computed without autograd.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    pg_rhos = torch.clamp(
        rhos, max=clip_rho if clip_pg_rho is None else clip_pg_rho)
    cs = torch.clamp(rhos, max=clip_c)
    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_next - values)
    decay = discounts * cs
    vs_minus_v = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(values.shape[0] - 1, -1, -1):     # the reverse scan
        acc = deltas[t] + decay[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = pg_rhos * (rewards + discounts * vs_next - values)
    return vs, pg_adv


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self._cfg.update({
            "lr": 5e-4, "num_workers": 2, "rollout_fragment_length": 50,
            "vtrace_clip_rho_threshold": 1.0,
            "vtrace_clip_pg_rho_threshold": 1.0,
            "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "grad_clip": 40.0,
            "num_batches_per_iteration": 10,
            # Weight broadcast cadence in learner updates (reference:
            # impala broadcast_interval) — actors run stale-by-at-most-this
            # policies; V-trace corrects the lag.  A broadcast is one
            # device-to-host copy of the params and one put.
            "broadcast_interval": 1,
            # Fragments concatenated (along B) per learner update
            # (reference: train_batch_size assembly from fragments).
            "num_fragments_per_update": 1,
            # "auto" (the policy's device) | "cpu": the policy's params,
            # and so the learner, live on the host CPU.
            "learner_device": "auto",
            # True = barrier sampling (wait for every worker, then learn)
            # — the control for the actor/learner overlap
            # (benchmarks/rllib_bench.py impala_overlap).
            "sync_sampling": False,
        })


class IMPALA(Algorithm):
    _default_config_cls = IMPALAConfig

    @staticmethod
    def _policy_surrogate(config):
        """Policy-loss term over (target_logp, behavior_logp, pg_adv) —
        plain V-trace policy gradient here; APPO overrides with the
        clipped PPO surrogate."""
        def pg(target_logp, behavior_logp, pg_adv):
            return -(target_logp * pg_adv).mean()
        return pg

    def setup(self, config: Dict[str, Any]) -> None:
        policy = self.workers.local_worker.policy
        if str(config.get("learner_device", "auto")) == "cpu" \
                and policy.device.type != "cpu":
            policy.to("cpu")
        apply_fn = policy.apply_fn
        dist = policy.dist_class
        self._optimizer = tx.chain(
            tx.clip_by_global_norm(config["grad_clip"]),
            tx.rmsprop(config["lr"], decay=0.99, eps=0.1))
        self._opt_state = self._optimizer.init(policy.params)
        gamma = float(config["gamma"])
        clip_rho = float(config["vtrace_clip_rho_threshold"])
        clip_pg_rho = float(config["vtrace_clip_pg_rho_threshold"])
        vf_coeff = float(config["vf_loss_coeff"])
        ent_coeff = float(config["entropy_coeff"])
        optimizer = self._optimizer

        surrogate = self._policy_surrogate(config)

        def loss_fn(params, batch):
            # batch cols are [T, B, ...]; flatten for the net, reshape back.
            T, B = batch[REWARDS].shape
            obs = batch[OBS].reshape((T * B,) + batch[OBS].shape[2:])
            inputs, values = apply_fn(params, obs)
            actions = batch[ACTIONS].reshape((T * B,))
            target_logp = dist.logp(inputs, actions).reshape((T, B))
            entropy = dist.entropy(inputs).mean()
            values = values.reshape((T, B))
            with torch.no_grad():         # reaches the loss through vtrace
                _, bootstrap = apply_fn(params, batch["last_obs"])
            discounts = gamma * (1.0 - batch["dones"])
            vs, pg_adv = vtrace(
                batch[ACTION_LOGP], target_logp.detach(), batch[REWARDS],
                discounts, values.detach(), bootstrap, clip_rho,
                clip_pg_rho=clip_pg_rho)
            pi_loss = surrogate(target_logp, batch[ACTION_LOGP], pg_adv)
            vf_loss = 0.5 * torch.square(vs - values).mean()
            total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
            return total, (pi_loss, vf_loss, entropy)

        def update(params, opt_state, batch):
            """One step, params and opt_state in place; returns
            (policy_loss, vf_loss, entropy) as one device tensor."""
            grads, aux = grads_with_aux(loss_fn, params, batch)
            updates, _ = optimizer.update(grads, opt_state, params)
            apply_updates(params, updates)
            return torch.stack(aux)

        self._loss_fn = loss_fn
        self._update = update
        self._in_flight: Dict[Any, Any] = {}  # future -> worker
        self._trained_steps = 0
        self._weights_ref = None
        self._updates_since_broadcast = 0

    def _to_time_major(self, batch: SampleBatch) -> Dict[str, torch.Tensor]:
        """Worker fragments arrive env-major ([env0 t0..T, env1 t0..T,
        ...]); each column uploads as it is and becomes a [T, B] view on
        the device.  Of NEXT_OBS only the final observation of each env
        row uploads: V-trace bootstraps from it alone."""
        T = int(self.config["rollout_fragment_length"])
        B = batch.count // T
        n = B * T
        dev = self.workers.local_worker.policy.device
        cols = {k: batch[k][:n] for k in (OBS, ACTIONS, REWARDS, ACTION_LOGP)}
        cols["dones"] = (batch[TERMINATEDS] | batch[TRUNCATEDS])[:n].astype(
            np.float32)
        out = {k: to_device(v, dev).reshape((B, T) + v.shape[1:])
               .transpose(0, 1) for k, v in cols.items()}
        next_obs = batch[NEXT_OBS][:n]
        out["last_obs"] = to_device(
            next_obs.reshape((B, T) + next_obs.shape[1:])[:, -1], dev)
        return out

    def _learn_on(self, batch: SampleBatch) -> torch.Tensor:
        """One learner update; returns its stats as a device tensor (NOT
        read: a host read per batch would serialize the device queue)."""
        policy = self.workers.local_worker.policy
        stats = self._update(policy.params, self._opt_state,
                             self._to_time_major(batch))
        self._trained_steps += batch.count
        return stats

    def _info(self, stats) -> Dict[str, Any]:
        """The iteration's metrics: a single host read of the last
        update's stats."""
        info = dict(zip(STATS, stats.tolist())) if stats is not None else {}
        info["num_env_steps_trained"] = self._trained_steps
        return info

    def training_step(self) -> Dict[str, Any]:
        remotes = self.workers.remote_workers
        n_batches = int(self.config["num_batches_per_iteration"])
        stats = None
        if not remotes:  # sync mode on the local worker
            for _ in range(n_batches):
                stats = self._learn_on(self.workers.local_worker.sample())
            return self._info(stats)
        if bool(self.config.get("sync_sampling")):
            # Barrier mode — the control for the actor/learner-overlap
            # benchmark: broadcast, wait for EVERY worker's fragment,
            # learn, repeat.  The async path below re-issues each worker
            # the moment its fragment lands and learns while the others
            # are still sampling.
            for _ in range(n_batches):
                self.workers.sync_weights()
                stats = self._learn_on(
                    synchronous_parallel_sample(self.workers))
            return self._info(stats)
        # Broadcast at most every `broadcast_interval` updates (reference:
        # IMPALA's broadcast_interval — actors run slightly stale policies
        # and V-trace corrects for the lag).
        interval = max(1, int(self.config.get("broadcast_interval", 1)))
        per_update = max(1, int(self.config.get(
            "num_fragments_per_update", 1)))
        if self._weights_ref is None:
            self._weights_ref = rt.put(
                self.workers.local_worker.get_weights())
        busy = set(self._in_flight.values())
        for w in remotes:
            if w not in busy:
                self._in_flight[w.sample_with_weights.remote(
                    self._weights_ref)] = w
        processed = 0
        pending: List[SampleBatch] = []
        while processed < n_batches:
            ready, _ = rt.wait(list(self._in_flight), num_returns=1)
            fut = ready[0]
            worker = self._in_flight.pop(fut)
            pending.append(rt.get(fut))
            # Re-issue immediately with the freshest broadcast ref.
            self._in_flight[worker.sample_with_weights.remote(
                self._weights_ref)] = worker
            if len(pending) < per_update:
                continue
            batch = pending[0] if len(pending) == 1 \
                else concat_samples(pending)
            pending = []
            stats = self._learn_on(batch)
            processed += 1
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= interval:
                self._weights_ref = rt.put(
                    self.workers.local_worker.get_weights())
                self._updates_since_broadcast = 0
        return self._info(stats)
