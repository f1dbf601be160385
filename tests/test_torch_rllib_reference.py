"""The committed outputs of the JAX package's RLlib learners
(``tests/data/rllib_reference.json``, written by
``tests/rllib_reference.py``), and the port held to them on the CPU by
the same check ``chip_smoke.py`` runs on the card.

The file is regenerated here and must equal the committed one: the same
runs, entries and shapes, and every value within 2^-20 of its entry's
largest magnitude (XLA may sum in another order on another host's CPU; a
hand-edited or stale file moves values by far more).  The port's side
runs ``chip_smoke.rllib_reference_check`` on the CPU (limits 1e-5 of the
largest magnitude for params after the update, 1e-4 for everything
else), which also requires the planted faults — the conv torso flattened
in (C, H, W) order, RMSProp's eps outside the root, PPO's advantages
normalised by the unbiased std — to fail that check.

The card's machine has no gymnasium: a rollout worker on the pixel env
runs here with the module made unimportable.
"""

import json
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import rllib_reference


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_file_is_what_the_generator_writes():
    committed = json.loads(rllib_reference.PATH.read_text())
    fresh = json.loads(json.dumps(rllib_reference.outputs()))
    assert committed["seed"] == fresh["seed"] == rllib_reference.SEED
    assert list(committed["runs"]) == list(rllib_reference.RUNS)
    assert rllib_reference.PATH.stat().st_size < 100_000
    for run, entries in fresh["runs"].items():
        assert list(committed["runs"][run]) == list(entries)
        for key, e in entries.items():
            c = committed["runs"][run][key]
            assert c["shape"] == e["shape"], (run, key)
            got, ref = np.float32(e["values"]), np.float32(c["values"])
            np.testing.assert_allclose(
                got, ref, rtol=0, atol=2 ** -20 * np.abs(ref).max(),
                err_msg=f"{run} {key}")


def test_port_matches_the_reference_file_on_cpu():
    """The card's check, on the CPU: each run within its limits, each
    planted fault beyond them."""
    out = chip_smoke.rllib_reference_check(torch.device("cpu"), "cpu")
    for run in chip_smoke.RL_RUNS:
        assert out[run][0] <= 1.0, (run, out[run])
    for fault in chip_smoke.RL_FAULTS:
        assert out[fault][0] > 1.0, (fault, out[fault])


def test_pixel_worker_runs_without_gymnasium(monkeypatch):
    """As on the card's machine: no gymnasium, the env's own spaces, a
    rollout worker sampling uint8 frames through the Nature CNN."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    from ray_tpu_torch.rllib import RolloutWorker, env, models
    assert isinstance(env.make_box(0, 255, (2,), np.uint8), env._Box)
    w = RolloutWorker({"env": "PixelSquareEnv", "env_config": {
        "size": 84, "frames": 4, "episode_len": 4},
        "num_envs_per_worker": 2, "rollout_fragment_length": 6, "seed": 0,
        "device": "cpu"})
    assert isinstance(w.vector_env.observation_space, env._Box)
    b = w.sample()
    assert b.count == 12
    assert b["obs"].shape == (12, 84, 84, 4) and b["obs"].dtype == np.uint8
    assert w.policy.model_config.conv_filters == models.NATURE_CNN_FILTERS
    assert np.isfinite(b["advantages"]).all()
    assert w.get_metrics()["episode_lens"] == [4, 4]     # one an env
