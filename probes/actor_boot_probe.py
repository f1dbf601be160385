"""Where a cold GPU actor's boot goes: the probe behind chip_smoke.py's
process-start cuts.

Times, on the card's machine, first in fresh processes outside any
cluster: ``import torch``, a CUDA context, ``import ray_tpu_torch`` and
its LLM engine modules.  Then, in one ``ray_tpu_torch.init(num_cpus=4)``
cluster, three actors one after another, each from ``.remote()`` to its
first reply and split into stages by wall-clock stamps taken in the
actor (``time.time()``, one clock on one host): the worker process's
start (``/proc/self/stat``), ``__init__``'s entry, ``import torch``, the
CUDA context, GPT-2 124M's params drawn on the CPU generator and moved to
the card, and the ``LLMEngine`` (``chip_smoke.EngineActor``'s boot, the
runtime phase's actor):

- a ``num_gpus=1`` actor that only stamps (spawn and registration alone);
- a ``num_gpus=1`` ``EngineActor``, twice (the second on a warm page
  cache);
- a plain actor that imports torch (a plain worker's share).

With ``--cached``, everything runs with chip_smoke.py's bytecode cache
(``chip_smoke.bytecode_cache``: a ``PYTHONPYCACHEPREFIX`` of the run's
own, filled first), as the script's phases run.

Run on a machine with a CUDA card, from the repository's root:

    python3 probes/actor_boot_probe.py [--cached]
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_SHM = tempfile.mkdtemp(prefix="rtt_probe_", dir="/dev/shm"
                        if os.path.isdir("/dev/shm") else None)
os.environ["RTT_SHM_DIR"] = _SHM

import chip_smoke as c  # noqa: E402


def proc_start() -> float:
    """This process's start, seconds since the epoch (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


class Stamp:
    def __init__(self):
        self.t = {"proc_start": proc_start(), "init_enter": time.time(),
                  "torch_in_modules": "torch" in sys.modules}

    def stamps(self) -> dict:
        return self.t


class TorchStamp(Stamp):
    def __init__(self):
        super().__init__()
        import torch  # noqa: F401
        self.t["torch_imported"] = time.time()


class TimedEngine(c.EngineActor):
    def __init__(self, *args):
        t = {"proc_start": proc_start(), "init_enter": time.time(),
             "torch_in_modules": "torch" in sys.modules}
        import torch
        t["torch_imported"] = time.time()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t["cuda_context"] = time.time()
        from ray_tpu_torch.serve.llm import LLMEngine  # noqa: F401
        t["engine_modules"] = time.time()
        # EngineActor.__init__: params drawn, then the engine
        mod_init = c.EngineActor.__init__
        import ray_tpu_torch.serve.llm as llm
        real = llm.LLMEngine

        class Engine(real):
            def __init__(self, *a, **k):
                t["params_drawn"] = time.time()
                super().__init__(*a, **k)

        llm.LLMEngine = Engine
        try:
            mod_init(self, *args)
        finally:
            llm.LLMEngine = real
        t["engine_built"] = time.time()
        self.t = t

    def stamps(self) -> dict:
        return self.t


def fresh(code: str) -> float:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return float(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    tag = c.gpu_line()
    print(tag, flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.environ["RTT_SESSION_DIR_ROOT"] = c.session_root()
    if "--cached" in sys.argv:
        t = time.perf_counter()
        warm = c.bytecode_cache()
        warm.communicate()
        print(f"boot_probe bytecode cache filled in "
              f"{time.perf_counter() - t:.3f} s [{tag}]", flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["PYTHONPATH"] = here
    from ray_tpu_torch import _build
    _build.build()
    _build.lib()
    res = {}
    timer = "import time; t = time.perf_counter(); {}; " \
            "print(time.perf_counter() - t)"
    for k, code in (
            ("import_torch_s", "import torch"),
            ("import_torch_again_s", "import torch"),
            ("cuda_context_s", "import torch; t = time.perf_counter(); "
             "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"),
            ("import_package_s", "import ray_tpu_torch"),
            ("import_llm_s", "import torch; t = time.perf_counter(); "
             "import ray_tpu_torch.serve.llm"),
            ("python_s", "pass")):
        res[k] = fresh(timer.format(code))
        print(f"boot_probe fresh process {k} {res[k]:.3f} [{tag}]",
              flush=True)
    import ray_tpu_torch as rt
    spec = c.gpt2_engine()
    args = (spec["cfg"], spec["blocks"], spec["block_scale"], c.SEED)
    rt.init(num_cpus=4)
    try:
        runs = [("gpu_stamp", rt.remote(num_gpus=1)(Stamp), ()),
                ("gpu_engine", rt.remote(num_gpus=1)(TimedEngine), args),
                ("gpu_engine_again", rt.remote(num_gpus=1)(TimedEngine),
                 args),
                ("plain_torch", rt.remote(TorchStamp), ())]
        for label, cls, a in runs:
            t0 = time.time()
            actor = cls.remote(*a)
            st = rt.get(actor.stamps.remote(), timeout=600)
            t1 = time.time()
            rel = {k: round(v - t0, 3) for k, v in st.items()
                   if isinstance(v, float)}
            rel["first_reply"] = round(t1 - t0, 3)
            rel["torch_in_modules"] = st["torch_in_modules"]
            res[label] = rel
            print(f"boot_probe {label} seconds from .remote(): "
                  f"{json.dumps(rel)} [{tag}]", flush=True)
            rt.kill(actor)
            time.sleep(1.0)
    finally:
        rt.shutdown()
        shutil.rmtree(_SHM, ignore_errors=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
