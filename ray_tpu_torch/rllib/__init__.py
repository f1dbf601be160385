"""ray_tpu_torch.rllib: the reference's RLlib on the port's runtime and
one GPU (port of ``ray_tpu/rllib/``, module for module).

Reference: ``rllib/``.  A rollout worker steps vectorized envs on the host
with one device call a step for the policy; a learner is eager PyTorch on
the config's device (PPO: all SGD epochs with no host read; IMPALA/APPO:
V-trace plus RMSProp behind the async actor-learner pipeline; DQN and
Ape-X: double-Q, Ape-X over prioritized replay shards; SAC, DDPG/TD3:
actor, critics and targets; MARWIL/BC: offline JSON data,
``offline.py``; A3C: worker-side gradients applied Hogwild; ES: episodes
as remote tasks).  Entry points run on the card unless the config says
``device="cpu"`` (``.resources(device="cpu")``).  With ``num_workers >
0`` the rollout workers are CPU actors of the runtime (``ray_tpu_torch.
init`` first) and the learner stays on the config's device::

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig
    rt.init(num_cpus=8)
    algo = (IMPALAConfig().environment(
                "RandomPixelEnv",
                env_config={"size": 84, "frames": 4, "num_actions": 6})
            .rollouts(num_workers=4, num_envs_per_worker=4,
                      rollout_fragment_length=32)
            .training(num_batches_per_iteration=4, lr=3e-4,
                      num_fragments_per_update=4, broadcast_interval=2)
            .debugging(seed=0).build())
    result = algo.train()
    algo.stop()
"""

from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch, SampleBatch,
                                              concat_samples)
from ray_tpu_torch.rllib.env import (MultiAgentEnv, RandomEnv, VectorEnv,
                                     make_multi_agent, register_env)
from ray_tpu_torch.rllib.policy import Policy, compute_gae
from ray_tpu_torch.rllib.evaluation import (
    RolloutWorker, WorkerSet, collect_metrics, synchronous_parallel_sample)
from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker
from ray_tpu_torch.rllib.algorithms import (
    A3C, A3CConfig, APEX, APEXConfig, APPO, APPOConfig, Algorithm,
    AlgorithmConfig, BC, BCConfig, DDPG, DDPGConfig, DQN, DQNConfig, IMPALA,
    IMPALAConfig, MARWIL, MARWILConfig, PPO, PPOConfig, SAC, SACConfig, TD3,
    TD3Config)
from ray_tpu_torch.rllib.algorithms.impala import vtrace

__all__ = [
    "SampleBatch", "MultiAgentBatch", "concat_samples", "RandomEnv",
    "VectorEnv", "register_env", "MultiAgentEnv", "make_multi_agent",
    "Policy", "compute_gae", "RolloutWorker", "MultiAgentRolloutWorker",
    "WorkerSet", "collect_metrics", "synchronous_parallel_sample",
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "DQN", "DQNConfig", "APEX", "APEXConfig", "vtrace",
    "APPO", "APPOConfig", "A3C", "A3CConfig", "MARWIL", "MARWILConfig",
    "BC", "BCConfig", "SAC", "SACConfig", "DDPG", "DDPGConfig", "TD3",
    "TD3Config",
]
