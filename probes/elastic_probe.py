"""``chip_smoke.py``'s elastic phase alone: GPT-2 124M through
``TorchTrainer(TorchConfig(elastic=True))``, drained 2 -> 1 and joined
1 -> 2 on one card, after the kernel build.  Every check runs, and a
failed one is printed (``FAIL ...``) instead of ending the run, so one
call reads every number the phase prints: the transitions' pauses, the
joiner's time to its first step, the state's publish and pull rates, the
all-reduce and step times, and the loss gap to the driver's uninterrupted
run beside the two planted faults' gaps (the sweep behind
``ELASTIC_LOSS_TOL``).  The train phase's launches per step are given by
hand (49 / 25 / 24 / 12, PERF.md §6).  Exits 1 if a check failed.

Run on a machine with a CUDA card, from the repository's root:

    python3 probes/elastic_probe.py [repeats] [steps]

``steps`` replaces ``ELASTIC_STEPS`` (and the gather cadence with it).
"""

import atexit
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402

TRAIN_LAUNCHES = {"layer_norm_fwd": 49, "layer_norm_bwd": 25,
                  "flash_attention_fwd": 24, "flash_attention_bwd": 12}


def main() -> int:
    d = tempfile.mkdtemp(prefix="rtt_smoke_", dir="/dev/shm"
                         if os.path.isdir("/dev/shm") else None)
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    os.environ["RTT_SHM_DIR"] = d
    os.environ["RTT_SESSION_DIR_ROOT"] = c.session_root()
    warm = c.bytecode_cache()
    import torch
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device
    tag = c.gpu_line()
    print(tag, sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    _build.build()
    _build.lib()
    disable_tf32()
    dev = resolve_device(None)
    warm.communicate()
    fails = []

    def record(msg: str) -> None:
        fails.append(msg)
        print(f"FAIL {msg}", flush=True)

    c.fail = record
    if len(sys.argv) > 2:
        c.ELASTIC_STEPS = c.ELASTIC_GATHER_EVERY = int(sys.argv[2])
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        c.elastic_phase(dev, {"launches_per_step": TRAIN_LAUNCHES}, tag)
    print(f"failed checks: {len(fails)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
