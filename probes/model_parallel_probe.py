"""``chip_smoke.py``'s model_parallel phase alone: GPT-2 124M trained
under each mesh layout by two ``GPU: 0.5`` workers in one
``torch.distributed`` domain, after the kernel build.  Every check runs,
and a failed one is printed (``FAIL ...``) instead of ending the run, so
one call reads every number the phase prints: each layout's loss, norm
and hidden-state gaps to the driver's one-rank run beside the planted
faults' (the sweep behind ``MP_LOSS_TOL`` / ``MP_NORM_TOL`` /
``MP_HIDDEN_TOL``), the float32 leg's (``MP_F32_TOL``), the launches a
step against the predicted ones, step ms, the collective seconds and
the all-reduce curve.  Exits 1 if a check failed.

Run on a machine with a CUDA card, from the repository's root:

    python3 probes/model_parallel_probe.py [repeats] [block scales...]

Each block scale (default ``MP_BLOCK_SCALE``; the float32 leg keeps
``MP_F32_SCALE``) runs the phase once a repeat, without its all-reduce
sweep after the first run.
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
    scales = [float(x) for x in sys.argv[2:]] or [c.MP_BLOCK_SCALE]
    sweep = c.MP_ALLREDUCE_BYTES
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        for scale in scales:
            print(f"model_parallel block scale {scale}", flush=True)
            c.model_parallel_phase(dev, tag, block_scale=scale,
                                   allreduce_bytes=sweep)
            sweep = c.MP_ALLREDUCE_BYTES[:1]
    print(f"failed checks: {len(fails)}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
