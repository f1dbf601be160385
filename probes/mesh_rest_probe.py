"""``chip_smoke.py``'s mesh_rest sub-phase alone: Llama-3 8B's width
under ``MeshConfig(tensor=2)`` and ``MeshConfig(pipeline=2)``, moe-small
under ``MeshConfig(tensor=2)`` and GPT-2 124M's chunked losses under
``MeshConfig(tensor=2)``, trained by two ``GPU: 0.5`` workers in one
``torch.distributed`` domain (the model_parallel phase's workers, here
without its layouts or zero_expert), after the kernel build.  Every
check runs, and a failed one is printed (``FAIL ...``) instead of ending
the run, so one call reads every number the sub-phase prints: each
leg's gaps to the driver's one-rank run beside the planted faults' (the
sweep behind ``MR_TOLS``), the launches a step against the predicted
ones, step ms, collective seconds and bytes, peak memory.  Exits 1 if a
check failed.

Run on a machine with a CUDA card, from the repository's root:

    python3 probes/mesh_rest_probe.py [repeats]
"""

import atexit
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402


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
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        c.model_parallel_phase(dev, tag, layouts=False, zero_expert=False)
    print(f"failed checks: {len(fails)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
