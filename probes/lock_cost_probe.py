"""What a ``threading.RLock`` costs against a ``threading.Lock``: the
question behind ``Worker._owned_lock`` becoming an ``RLock`` (a release run
by the cyclic GC inside ``_untrack_owned_ret`` re-enters it).  The worker
takes that lock at most three times a task (submit, the result observed,
the ref released).

Times two million uncontended ``with lock: pass`` blocks of each kind,
twice, alternating, and prints ns a block (loop overhead included).
Run from the repository root on the card's machine:

    python3 probes/lock_cost_probe.py
"""

import subprocess
import threading
import time

N = 2_000_000


def per_block_ns(lock) -> float:
    t0 = time.perf_counter()
    for _ in range(N):
        with lock:
            pass
    return 1e9 * (time.perf_counter() - t0) / N


def main() -> None:
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip() or "no nvidia-smi output")
    except FileNotFoundError:
        print("no nvidia-smi")
    for name, make in (("Lock", threading.Lock),
                       ("RLock", threading.RLock)) * 2:
        print(f"{name} acquire+release {per_block_ns(make()):.1f} ns")


if __name__ == "__main__":
    main()
