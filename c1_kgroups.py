"""Queue C1, a closed experiment: can the head-dim-128 flash forward come
within one bf16 step of its plain version?

    python3 c1_kgroups.py        # on one CUDA card, from the repo's root

Builds the forward with each score's 8 k-steps accumulated in fresh
tensor-core accumulators of 4, 2 or 1 k-steps, joined by float32 adds, from
a patched copy of ``ray_tpu_torch/csrc/flash_attention.cu``, and prints each
variant's worst element and device time beside the kernel as it is.  The
result and the decision (the kernel stays as it is, two steps stays the
limit) are in PERF.md section 6.  The patch matches the forward's
S = Q K^T loop as it stood when C1 was closed; the script fails if that
loop has changed since.  Not part of ``chip_smoke.py``.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from chip_smoke import SEED, bf16_excess, device_ms, fail


def c1_kgroups(groups=(4, 2, 1), tag: str = "") -> dict:
    """Queue C1: the head-dim-128 flash forward with each score's 8 k-steps
    (kD / 16) accumulated in fresh tensor-core accumulators of ``kg``
    k-steps, joined by float32 adds, against the kernel as it is (one
    chain of 8), at (8, 2048, 32 over 8, 128) causal.  Builds each variant
    from a patched copy of csrc/flash_attention.cu into _build/c1/, routes
    the wrapper through it, and prints each one's worst element against
    the plain version in one and in two bf16 steps and its device time,
    timed in turns with the kernel as it is."""
    import ctypes
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    old = """#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kf[4];
      rtt::ldsm_x4(kf, rtt::ld_nk<kD>(k_s, 16 * np, 2 * kk, lane));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        rtt::mma(s[mt][2 * np], qf[mt][kk], kf[0], kf[1]);
        rtt::mma(s[mt][2 * np + 1], qf[mt][kk], kf[2], kf[3]);
      }
    }
"""
    new = """  constexpr int kKG = RTT_KG < kD / 16 ? RTT_KG : kD / 16;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int kg = 0; kg < kD / 16; kg += kKG) {
      float part[kMT][2][4] = {};
#pragma unroll
      for (int kk = kg; kk < kg + kKG; ++kk) {
        uint32_t kf[4];
        rtt::ldsm_x4(kf, rtt::ld_nk<kD>(k_s, 16 * np, 2 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          rtt::mma(part[mt][0], qf[mt][kk], kf[0], kf[1]);
          rtt::mma(part[mt][1], qf[mt][kk], kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][2 * np][e] += part[mt][0][e];
          s[mt][2 * np + 1][e] += part[mt][1][e];
        }
    }
"""
    if old not in src:
        fail("c1_kgroups: the forward's S = Q K^T loop has changed")
    out_dir = _build.BUILD_DIR / "c1"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_attention.cu").write_text(src.replace(old, new))
    (out_dir / "tensor_core.cuh").write_text(
        (_build.CSRC_DIR / "tensor_core.cuh").read_text())
    nvcc = _build.find_nvcc()
    procs = {kg: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-DRTT_KG={kg}", "-shared",
         str(out_dir / "flash_attention.cu"), "-o",
         str(out_dir / f"libkg{kg}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for kg in groups}
    fns = {}
    for kg, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"c1_kgroups: nvcc failed for kg {kg}:\n{log}")
        regs = [ln for ln in log.splitlines() if "Used" in ln]
        print(f"c1 kg {kg} ptxas " + " | ".join(regs), flush=True)
        fn = ctypes.CDLL(str(out_dir / f"libkg{kg}.so")) \
            .rtt_flash_attention_fwd
        fn.argtypes = _build.SIGNATURES["rtt_flash_attention_fwd"]
        fn.restype = ctypes.c_int
        fns[kg] = fn
    fns[8] = _build.entry("rtt_flash_attention_fwd")   # as it is
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, T, H, KV, D = 8, 2048, 32, 8, 128
    q = torch.randn((B, T, H * D), generator=gen, device=dev) \
        .to(torch.bfloat16).view(B, T, H, D)
    k, v = (torch.randn((B, T, KV, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    ref = fa.flash_attention_plain(q, k, v, True)

    def run(kg):
        _build._entries["rtt_flash_attention_fwd"] = fns[kg]
        try:
            return fa.flash_attention(q, k, v, True)
        finally:
            _build._entries["rtt_flash_attention_fwd"] = fns[8]

    res = {}
    for kg in (8,) + tuple(groups):
        got = run(kg)
        torch.cuda.synchronize()
        res[kg] = dict(one_step=bf16_excess(got, ref, 1)[1],
                       two_steps=bf16_excess(got, ref, 2)[1],
                       max_abs_err=bf16_excess(got, ref, 1)[0])
    for kg in groups:       # in turns: as it is, variant, variant, as it is
        t = [device_ms(lambda: run(x), iters=10) for x in (8, kg, kg, 8)]
        res[kg].update(ms=(t[1] + t[2]) / 2, base_ms=(t[0] + t[3]) / 2)
    for kg, r in res.items():
        print(f"c1 kg {kg} " + " ".join(f"{a} {b:.6g}" for a, b in r.items())
              + f" [{tag}]", flush=True)
    return res


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("no CUDA device: c1_kgroups.py needs one GPU", file=sys.stderr)
        sys.exit(1)
    c1_kgroups()
