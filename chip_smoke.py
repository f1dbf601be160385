"""Chip smoke test for ray_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``ray_tpu_torch/csrc`` with nvcc for sm_90a, and prints, for each
   bf16 tensor-core kernel, ptxas's registers, shared memory and spill
   bytes and the HMMA instructions in its SASS (``cuobjdump -sass``);
   fails if one has none.
2. Kernel phase: at the serving path's shapes, holds each kernel against
   its plain PyTorch version on the card (bf16, stated tolerances) and
   times the kernel, the plain version and the closest single PyTorch
   call (a yardstick only: the port never calls it).
   The backward kernels, and the flash forward once more, are held the
   same way at the training path's shapes.
3. Engine phase: serves GPT-2 124M (full width, random weights from the
   seed, block matrices scaled x3 so the context decides the logits)
   through ``LLMEngine`` — 16 concurrent greedy requests — checks every
   request, checks that both kernels were launched by that run (and the
   float32 flash kernel never), and
   teacher-forces the engine's output through the full ``forward`` to
   hold the engine's per-step logits to it.  Then plants one fault at a
   time in the decode step's inputs and requires the same check to fail
   on each.
4. Train phase: trains GPT-2 124M (full width, random init from the seed,
   batch 32 x seq 1024, remat on) through ``spmd.build_train_program``.
   Holds every parameter's step-0 gradient to an independent reference
   (plain autograd through dense attention and the plain LayerNorm),
   requires two planted backward faults to fail that check, then runs six
   steps on one batch with host syncs made errors, and checks the falling
   loss, the step count and each kernel's launches per step (none of the
   float32 flash kernels).  Prints the
   step time, tokens/s, the model-FLOP share and one profiled step.
5. Prints one JSON line of per-kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.  Imports neither JAX nor the ray_tpu package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# Data-sheet peaks (dense, no sparsity) by card name: (bytes/s, bf16 FLOP/s)
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}

# Tolerances, each with its reason:
# bf16 outputs (LayerNorm y, flash out), held element by element: both
# versions compute in f32 and round once; a sum taken in another order
# can move the f32 value across a rounding boundary, which is one bf16
# step of that element (at most 2^-7 of it: 8 significant bits).  Values
# near zero get a floor of four bf16 steps at the reference's rms.
#   |kernel - plain| <= BF16_REL * |plain| + BF16_RMS_FLOOR * rms(plain)
BF16_REL = 2.0 ** -7
BF16_RMS_FLOOR = 4 * 2.0 ** -8
# Flash backward dq, dk, dv: two of those steps.  Each output is a sum of
# terms that are themselves rounded to bf16 (p and ds, the reference's
# rounding points), so a last-bit float32 difference in s or dp (sums in
# another order) flips some of those roundings.  Kernel and plain version
# are each within one step of the exactly computed pipeline (the CPU test
# test_flash_bwd_plain_within_one_step_of_exact holds the plain version
# to it), hence within two steps of each other.
FLASH_BWD_STEPS = 2
# LayerNorm mu/rstd (f32): summation order only.
LN_STAT_TOL = 1e-5
# LayerNorm dscale/dbias (f32 sums over the rows): the kernel and the
# plain version add the same float32 terms in other orders.  A sum taken
# through a chain of d roundings is within d * 2^-24 * sum|terms| of the
# exact sum; the kernel's chain is rows-per-lane + 8 warps + the partial
# rows, and 64 more cover the plain reduction's tree.
LN_SUM_DEPTH_PAD = 64
# lse (f32, base 2): exp2/log2 approximations and summation order.
FLASH_LSE_TOL = 1e-3
# Engine logits vs teacher-forced full forward, both bf16 through 12
# layers: matmuls of other shapes (bucket padding, batch 16 vs 1) round
# differently at every layer; logits here have std ~0.5.
ENGINE_LOGIT_TOL = 0.1
# The engine serves GPT-2's init with every block matrix scaled x3.  At
# the init scale attention is nearly uniform, and a KV length one short
# moves the logits less than ENGINE_LOGIT_TOL; at x10 (the CPU tests'
# float32 scale) attention is so sharp that bf16 rounding alone moves
# them past it.  PERF.md gives the sweep.
ENGINE_BLOCK_SCALE = 3.0
# Faults planted in the decode step's inputs, one run each after the
# main path: each must push the logits past ENGINE_LOGIT_TOL, or the
# engine check could not see it.
FAULTS = {
    "position_plus_1": lambda t, p, pool, tab, n: (t, p + 1, pool, tab, n),
    "kv_len_minus_1": lambda t, p, pool, tab, n: (t, p, pool, tab, n - 1),
    "block_table_rolled": lambda t, p, pool, tab, n: (
        t, p, pool, np.roll(tab, 1, axis=1), n),
}


# Train phase: GPT-2 124M at the flagship training shape.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 1024, 6
TRAIN_LR = 3e-4                      # default_optimizer's own
# Step-0 gradients, kernel path vs the independent reference, both bf16
# activations: the relative L2 error ||g - g_ref|| / ||g_ref|| of the
# worst parameter leaf.  Set from the healthy error and the two planted
# faults measured on the card at GPT-2's init (PERF.md, train phase):
# healthy 0.0137, faults 0.36 and 0.38, so 0.05 sits 3.6x above the one
# and 7x below the others.
GRAD_REL_TOL = 0.05
BLOCK_MATRICES = ("attn_qkv", "attn_out", "mlp_in", "mlp_out")
# Faults planted in the backward kernels' inputs, one run each: each must
# push some leaf past GRAD_REL_TOL.
GRAD_FAULTS = {
    "flash_bwd_lse_rolled": ("flash_attention", "flash_attention_bwd",
                             lambda f: lambda q, k, v, lse, d, do, c: f(
                                 q, k, v, lse.roll(1, 0), d, do, c)),
    "ln_bwd_rstd_rolled": ("layer_norm", "ln_bwd",
                           lambda f: lambda x, s, g, mu, rstd: f(
                               x, s, g, mu, rstd.roll(1, 0))),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per-call time of back-to-back eager calls, by CUDA events: the
    host's launch cost included wherever it exceeds the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times and timed by CUDA events, so no host launch
    cost enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * reps)


def bf16_excess(out: torch.Tensor, ref: torch.Tensor,
                steps: int = 1) -> tuple:
    """(max |out - ref|, the largest ratio of an element's error to its
    limit of ``steps`` bf16 steps, the limit's rms floor): the check
    passes when the ratio is at most 1."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    floor = steps * BF16_RMS_FLOOR * r.pow(2).mean().sqrt()
    ratio = (err / (steps * BF16_REL * r.abs() + floor)).max()
    return err.max().item(), ratio.item(), floor.item()


def bound_ms(nbytes: float, flops: float, card) -> tuple:
    bw, fl = card
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
# The bf16 tensor-core kernels, by a piece of their mangled names.
TC_KERNELS = ("flash_fwd_tc_kernelILi64E", "flash_fwd_tc_kernelILi128E",
              "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")


def tc_report(tag: str) -> dict:
    """For each bf16 tensor-core kernel of the build: ptxas's registers a
    thread, shared memory a block and spill bytes, and the HMMA
    instructions in its SASS.  Fails if one has no HMMA."""
    from ray_tpu_torch import _build
    res = _build.kernel_resources()
    hmma = _build.sass_counts("HMMA")
    out = {}
    for key in TC_KERNELS:
        names = [n for n in hmma if key in n]
        rnames = [n for n in res if key in n]
        if len(names) != 1 or len(rnames) != 1:
            fail(f"kernel {key}: {len(names)} SASS functions and "
                 f"{len(rnames)} ptxas entries")
        out[key] = dict(res[rnames[0]], hmma=hmma[names[0]])
        print(f"sass {key} " + " ".join(f"{k} {v}" for k, v in
                                        out[key].items()) + f" [{tag}]",
              flush=True)
        if out[key]["hmma"] == 0:
            fail(f"kernel {key} has no HMMA: it does not use the tensor "
                 f"cores")
    return out


def check_layer_norm(gen, card, dev) -> list:
    import torch.nn.functional as F
    from ray_tpu_torch.ops import layer_norm as ln
    rows = []
    for N in (1024, 16):             # longest prefill bucket, decode batch
        E = 768
        x = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn((E,), generator=gen, device=dev)
        bias = 0.1 * torch.randn((E,), generator=gen, device=dev)
        y, mu, rstd = ln.ln_fwd(x, scale, bias, 1e-5, want_stats=True)
        yp, mup, rstdp = ln.ln_fwd_plain(x, scale, bias, 1e-5)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(y, yp)
        serr = max((mu - mup).abs().max().item(),
                   ((rstd - rstdp).abs() / rstdp.abs()).max().item())
        name = f"layer_norm_fwd({N}x{E} bf16)"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) "
              f"stats_err {serr:.3g} tol {LN_STAT_TOL}", flush=True)
        if not (ratio <= 1.0 and serr <= LN_STAT_TOL):
            fail(f"{name} disagrees with its plain version")
        kern = lambda: ln.ln_fwd(x, scale, bias, 1e-5)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: ln.ln_fwd_plain(x, scale, bias, 1e-5))
        s16 = scale.to(torch.bfloat16)
        b16 = bias.to(torch.bfloat16)
        l_ms = device_ms(lambda: F.layer_norm(x, (E,), s16, b16, 1e-5))
        nbytes = 2 * N * E * 2 + 2 * E * 4
        b_ms, b_by = bound_ms(nbytes, 8 * N * E, card)
        rows.append(dict(name=name, shape=(N, E), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash(gen, card, dev) -> list:
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    rows = []
    H, D = 12, 64
    # the serving shapes at B = 1, then the train step's (32, 1024)
    for B, T, causal in ((1, 64, True), (1, 333, True), (1, 1024, True),
                         (1, 333, False), (TRAIN_BATCH, TRAIN_SEQ, True)):
        # q/k/v as the model makes them: strided views of one qkv tensor
        qkv = torch.randn((B, T, 3, H * D), generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = [qkv[:, :, i].unflatten(-1, (H, D)) for i in range(3)]
        out, lse = fa.flash_attention(q, k, v, causal, want_lse=True)
        outp, lsep = fa.flash_attention_plain(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(out, outp)
        lerr = (lse - lsep).abs().max().item()
        del out, outp, lse, lsep
        name = f"flash_attention_fwd({B}x{T}x{H}x{D} bf16" \
            f"{', causal' if causal else ''})"
        bm = fa.forward_block_m(B, T, H, dev)
        print(f"{name} block_m {bm} max_abs_err {err:.6g} "
              f"worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) "
              f"lse_err {lerr:.3g} tol {FLASH_LSE_TOL}", flush=True)
        if not (ratio <= 1.0 and lerr <= FLASH_LSE_TOL):
            fail(f"{name} disagrees with its plain version")
        if not causal:
            continue
        kern = lambda: fa.flash_attention(q, k, v, True)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        # the tile height the wrapper did not pick, for the record
        other = [x for x in fa.BLOCK_MS if x != bm][0]
        o_ms = device_ms(lambda: fa._flash_kernel(q, k, v, True, False,
                                                  other))
        print(f"{name} kernel_ms {k_ms:.6g} at block_m {bm}, {o_ms:.6g} "
              f"at block_m {other}", flush=True)
        p_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         **(dict(iters=5) if B == 1
                            else dict(iters=3, reps=2)))
        qt, kt, vt = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        del qt, kt, vt
        pairs = T * (T + 1) // 2            # causal: what the data needs
        flops = 4 * D * pairs * B * H
        nbytes = 4 * B * T * H * D * 2
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(B, T, H, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def check_layer_norm_bwd(gen, card, dev) -> list:
    from ray_tpu_torch.ops import layer_norm as ln
    rows = []
    E = 768
    for N in (TRAIN_BATCH * TRAIN_SEQ, 333):     # the train shape, ragged
        x = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn((E,), generator=gen, device=dev)
        bias = torch.zeros((E,), device=dev)
        _, mu, rstd = ln.ln_fwd_plain(x, scale, bias, 1e-5)
        dx, ds, db = ln.ln_bwd(x, scale, g, mu, rstd)
        dxp, dsp, dbp = ln.ln_bwd_plain(x, scale, g, mu, rstd)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(dx, dxp)
        # the f32 sums: each column within depth * 2^-24 * sum|terms|
        xhat = (x.float() - mu[:, None]) * rstd[:, None]
        nb = ln.bwd_blocks(N, dev)
        depth = -(-N // (nb * ln.BWD_WARPS)) + ln.BWD_WARPS + nb \
            + LN_SUM_DEPTH_PAD
        sum_ratio = max(
            ((k - p).abs() / (depth * 2.0 ** -24 * t.abs().sum(0))).max()
            .item() for k, p, t in ((ds, dsp, g.float() * xhat),
                                    (db, dbp, g.float())))
        name = f"layer_norm_bwd({N}x{E} bf16)"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) dscale/dbias "
              f"worst_err/limit {sum_ratio:.4g} (limit {depth}*2^-24*"
              f"sum|terms|)", flush=True)
        if not (ratio <= 1.0 and sum_ratio <= 1.0):
            fail(f"{name} disagrees with its plain version")
        if N < TRAIN_BATCH * TRAIN_SEQ:
            continue
        kern = lambda: ln.ln_bwd(x, scale, g, mu, rstd)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: ln.ln_bwd_plain(x, scale, g, mu, rstd),
                         iters=5)
        s16 = scale.to(torch.bfloat16)
        mu2, rstd2 = mu[:, None], rstd[:, None]
        l_ms = device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            g, x, [E], mu2, rstd2, s16, s16, [True, True, True]))
        nbytes = 3 * N * E * 2 + 2 * N * 4 + 3 * E * 4
        b_ms, b_by = bound_ms(nbytes, 10 * N * E, card)
        rows.append(dict(name=name, shape=(N, E), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash_bwd(gen, card, dev) -> list:
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    rows = []
    H, D = 12, 64
    for B, T, causal in ((TRAIN_BATCH, TRAIN_SEQ, True), (1, 333, True),
                         (1, 333, False)):
        qkv = torch.randn((B, T, 3, H * D), generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = [qkv[:, :, i].unflatten(-1, (H, D)) for i in range(3)]
        do = torch.randn((B, T, H, D), generator=gen,
                         device=dev).to(torch.bfloat16)
        out, lse = fa.flash_attention_plain(q, k, v, causal, want_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(B * H, T)
        del out
        got = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        ref = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)
        torch.cuda.synchronize()
        name = f"flash_attention_bwd({B}x{T}x{H}x{D} bf16" \
            f"{', causal' if causal else ''})"
        errs = {n: bf16_excess(a, r, FLASH_BWD_STEPS) for n, a, r in
                zip(("dq", "dk", "dv"), got, ref)}
        del got, ref
        err = max(e[0] for e in errs.values())
        ratio = max(e[1] for e in errs.values())
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {FLASH_BWD_STEPS}*({BF16_REL:.6g}*|ref| + floor)) "
              + " ".join(f"{n}:{e[1]:.3g}(floor {e[2]:.3g})"
                         for n, e in errs.items()), flush=True)
        if ratio > 1.0:
            fail(f"{name} disagrees with its plain version")
        if not causal:
            continue
        kern = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, lse, delta, do, True)
        k_ms, c_ms = device_ms(kern, iters=5), call_ms(kern, iters=10)
        p_ms = device_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, lse, delta, do, True), iters=3, reps=2)
        # yardstick: SDPA's backward on a retained graph, by CUDA events
        # over back-to-back calls (autograd does not capture into a graph)
        qt, kt, vt = [t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v)]
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        l_ms = call_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del o
        pairs = T * (T + 1) // 2
        flops = 5 * 2 * D * pairs * B * H
        nbytes = 7 * B * T * H * D * 2 + 2 * B * H * T * 4
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(B, T, H, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


# ---------------------------------------------------------------- profile
def profile_once(name: str, fn, tag: str = "") -> dict:
    """``fn`` once under torch.profiler: wall time, summed device time,
    the device's busy share and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # kernels only
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if dt > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dt
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    # the port's hand-written kernels, whatever their rank
    ours = {k: v for k, v in by_kernel.items()
            if "flash_" in k or "layer_norm_" in k}
    res = dict(wall_ms=wall, device_ms=dev_ms,
               busy=dev_ms / wall if wall else float("nan"),
               top=[(k[:90], v) for k, v in top],
               hand_written_ms=sum(ours.values()))
    tag = f" [{tag}]" if tag else ""
    print(f"profile {name} wall_ms {wall:.4g} device_ms {dev_ms:.4g} "
          f"busy {res['busy']:.3f} hand-written kernels "
          f"{res['hand_written_ms']:.4g} ms{tag}", flush=True)
    for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
        print(f"profile {name}   ours {v:.4g} ms  {k[:90]}{tag}", flush=True)
    for k, v in top:
        print(f"profile {name}   {v:.4g} ms  {k[:90]}{tag}", flush=True)
    return res
def profile_steps(runner, pool, dev) -> dict:
    """One prefill at the longest bucket and one decode step at batch 16,
    each under torch.profiler."""
    rng = np.random.default_rng(SEED + 1)
    V, maxb = runner.vocab, runner.cfg.max_blocks_per_seq
    tables = rng.integers(0, pool.shape[0], (16, maxb)).astype(np.int32)
    lens = np.full(16, 512, np.int32)
    steps = {
        "prefill_1024": lambda: runner.prefill(
            rng.integers(0, V, 1000).tolist()),
        "decode_b16_ctx512": lambda: runner.decode(
            rng.integers(0, V, 16).astype(np.int32), lens, pool, tables,
            lens),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        out[name] = profile_once(name, fn)
    return out


# ----------------------------------------------------------------- engine
def engine_phase(dev, block_scale: float = ENGINE_BLOCK_SCALE) -> dict:
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import layer_norm as ln
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, \
        SamplingParams
    from ray_tpu_torch.serve.llm.config import resolve_model
    from ray_tpu_torch.serve.llm.model_runner import ModelRunner

    cfg = EngineConfig(model="gpt2:gpt2-124m", block_size=16,
                       num_blocks=1100, max_num_seqs=16, max_model_len=1024,
                       max_prefill_tokens=1024,
                       prefill_len_buckets=(64, 128, 256, 512, 1024),
                       decode_batch_buckets=(1, 2, 4, 8, 16),
                       share_weights=False, seed=SEED)
    t0 = time.perf_counter()
    mod, mcfg = resolve_model(cfg)
    params = mod.init_params(torch.Generator().manual_seed(SEED), mcfg,
                             device=dev)
    for name in BLOCK_MATRICES:
        params["blocks"][name]["kernel"].mul_(block_scale)
    eng = LLMEngine(cfg, params, start=False, device=dev)
    setup_s = time.perf_counter() - t0
    runner = eng.runner
    rec = dict(logits={}, emit_at={}, prefill=[], decode=[])
    last = {}
    fault = {"fn": None}

    def sample(logits, sp, step):
        last["logits"] = np.array(logits, np.float32)
        return ModelRunner.sample(logits, sp, step)

    emit = eng._emit

    def record_emit(seq, tok):
        rec["logits"].setdefault(seq.seq_id, []).append(last["logits"])
        rec["emit_at"].setdefault(seq.seq_id, []).append(time.perf_counter())
        emit(seq, tok)

    prefill, decode = runner.prefill, runner.decode

    def timed_prefill(token_ids):
        t = time.perf_counter()
        res = prefill(token_ids)      # logits reach the host: synced
        rec["prefill"].append((len(token_ids), time.perf_counter() - t))
        return res

    def timed_decode(tokens, *a):
        if fault["fn"] is not None:
            tokens, *a = fault["fn"](tokens, *a)
        t = time.perf_counter()
        res = decode(tokens, *a)
        rec["decode"].append((len(tokens), time.perf_counter() - t))
        return res

    def serve(prompts, sp):
        """Submit every prompt at once; wait for every stream."""
        for v in rec.values():
            v.clear()
        t = time.perf_counter()
        streams = [eng.submit(p, sp) for p in prompts]
        outs = [s.tokens() for s in streams]
        return streams, outs, t, time.perf_counter() - t

    def logits_err(streams, prompts, outs) -> float:
        """Teacher-force each request's output through the full forward:
        the largest difference from the logits the engine sampled."""
        max_err = 0.0
        with torch.no_grad():
            for s, p, o in zip(streams, prompts, outs):
                full = torch.tensor([p + o[:-1]], device=dev)
                ref = gpt2.forward(runner.params, full,
                                   runner.mcfg)[0, len(p) - 1:]
                got = np.stack(rec["logits"][s.seq_id])
                if got.shape != tuple(ref.shape) or \
                        not np.isfinite(got).all():
                    fail(f"engine logits {got.shape} vs {tuple(ref.shape)}")
                err = float(np.abs(got - ref.cpu().numpy()).max())
                max_err = max(max_err, err)
        return max_err

    runner.sample, eng._emit = sample, record_emit
    runner.prefill, runner.decode = timed_prefill, timed_decode
    eng.start()
    try:
        V = runner.vocab
        rng = np.random.default_rng(SEED)
        # warm-up: one short request per prefill bucket
        for n in (40, 100, 200, 400, 900):
            eng.generate(rng.integers(0, V, n).tolist(),
                         SamplingParams(max_tokens=2))
        lens = rng.integers(32, 961, size=16)
        prompts = [rng.integers(0, V, int(n)).tolist() for n in lens]
        ln.launches = fa.launches = fa.f32_launches = 0
        streams, outs, t_sub, wall = serve(prompts,
                                           SamplingParams(max_tokens=32))
        launches = {"layer_norm_fwd": ln.launches,
                    "flash_attention_fwd": fa.launches}
        f32_launches = fa.f32_launches
        stats = eng.stats()
        timing = dict(emit_at=dict(rec["emit_at"]),
                      prefill=list(rec["prefill"]), decode=list(rec["decode"]))
        for p, o in zip(prompts, outs):
            if len(o) != 32 or not all(0 <= t < V for t in o):
                fail(f"request of {len(p)} tokens returned {o}")
        print(f"engine launches {launches} float32 flash {f32_launches}",
              flush=True)
        for k, n in launches.items():
            if n <= 0:
                fail(f"{k} was not launched on the engine's path")
        if f32_launches:
            fail("the float32 flash kernel ran on the engine's bf16 path")
        max_err = logits_err(streams, prompts, outs)
        print(f"engine logits_max_abs_err {max_err:.6g} tol "
              f"{ENGINE_LOGIT_TOL}", flush=True)
        if max_err > ENGINE_LOGIT_TOL:
            fail("engine logits disagree with the full forward")
        distinct = len({t for o in outs for t in o})
        # Controls: the same check on runs with a planted fault must fail.
        controls = {}
        for fname, fn in FAULTS.items():
            fault["fn"] = fn
            try:
                c_streams, c_outs, _, _ = serve(
                    prompts[:4], SamplingParams(max_tokens=8))
            finally:
                fault["fn"] = None
            controls[fname] = logits_err(c_streams, prompts[:4], c_outs)
            print(f"engine control {fname} logits_max_abs_err "
                  f"{controls[fname]:.6g} (must exceed {ENGINE_LOGIT_TOL})",
                  flush=True)
            if controls[fname] <= ENGINE_LOGIT_TOL:
                fail(f"planted fault {fname} passed the engine check")
        ttft = sorted(timing["emit_at"][s.seq_id][0] - t_sub
                      for s in streams)
        gaps = sorted(np.concatenate(
            [np.diff(timing["emit_at"][s.seq_id]) for s in streams]))
        pf_tok = sum(n for n, _ in timing["prefill"])
        pf_s = sum(t for _, t in timing["prefill"])
        dc_tok = sum(n for n, _ in timing["decode"])
        dc_s = sum(t for _, t in timing["decode"])
        res = dict(setup_s=setup_s, block_scale=block_scale, wall_s=wall,
                   stats=stats, prefill_tok_s=pf_tok / pf_s,
                   prefill_steps=len(timing["prefill"]),
                   decode_tok_s=dc_tok / dc_s,
                   decode_steps=len(timing["decode"]),
                   decode_step_ms=1e3 * dc_s / len(timing["decode"]),
                   ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
                   ttft_max_ms=1e3 * ttft[-1],
                   tpot_p50_ms=1e3 * gaps[len(gaps) // 2],
                   tpot_max_ms=1e3 * gaps[-1],
                   output_tok_s=16 * 32 / wall, distinct_tokens=distinct,
                   logits_max_abs_err=max_err,
                   control_logits_max_abs_err=controls, launches=launches)
        for k, val in res.items():
            print(f"engine {k} {val}", flush=True)
        res["profile"] = profile_steps(runner, eng.cache.pool, dev)
        return res
    finally:
        eng.shutdown()


# ------------------------------------------------------------------ train
def leaf_grads(params, loss_of) -> tuple:
    """(loss, gradient of every param leaf) by plain autograd."""
    from ray_tpu_torch.parallel.transforms import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_of()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def leaf_names(params, prefix="") -> list:
    if isinstance(params, dict):
        return [n for k, v in params.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def grad_check(cfg, params, batch, block_scale: float = 1.0) -> tuple:
    """Step-0 gradients of every leaf on the kernel path against an
    independent reference: plain autograd through dense attention and the
    plain LayerNorm, on the same card, at the same params with the block
    matrices scaled by ``block_scale``.  Then the same comparison with
    each planted fault.  Returns (worst healthy relative L2 error, its
    leaf, {fault: worst relative error}); fails only on a non-finite
    loss."""
    import dataclasses
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import layer_norm as ln
    names = leaf_names(params)
    if block_scale != 1.0:
        params = {**params, "blocks": {
            k: ({**v, "kernel": v["kernel"] * block_scale}
                if k in BLOCK_MATRICES else v)
            for k, v in params["blocks"].items()}}
    kernel_ln = gpt2._layer_norm
    gpt2._layer_norm = ln.layer_norm_plain
    try:
        ref_loss, ref = leaf_grads(params, lambda: gpt2.loss_fn(
            params, batch, dataclasses.replace(cfg, attn_impl="dense")))
    finally:
        gpt2._layer_norm = kernel_ln
    ref_norms = [r.float().norm() for r in ref]

    def errors(label: str) -> tuple:
        loss, got = leaf_grads(params, lambda: gpt2.loss_fn(
            params, batch, cfg))
        errs = [((g.float() - r.float()).norm() / n).item()
                for g, r, n in zip(got, ref, ref_norms)]
        order = sorted(range(len(errs)), key=lambda i: -errs[i])
        print(f"train grads x{block_scale} {label}: loss {loss.item():.6f} "
              f"(reference {ref_loss.item():.6f}) worst leaf "
              f"{names[order[0]]} rel_err {errs[order[0]]:.4g} (limit "
              f"{GRAD_REL_TOL}); next "
              + ", ".join(f"{names[i]} {errs[i]:.3g}" for i in order[1:4]),
              flush=True)
        if not math.isfinite(loss.item()):
            fail(f"non-finite loss in the gradient check ({label})")
        return errs[order[0]], names[order[0]]

    worst, worst_leaf = errors("healthy")
    controls = {}
    for fname, (modname, attr, plant) in GRAD_FAULTS.items():
        mod = {"flash_attention": fa, "layer_norm": ln}[modname]
        orig = getattr(mod, attr)
        setattr(mod, attr, plant(orig))
        try:
            controls[fname] = errors(f"control {fname}")[0]
        finally:
            setattr(mod, attr, orig)
    return worst, worst_leaf, controls


def train_phase(dev, card, tag: str) -> dict:
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import layer_norm as ln
    from ray_tpu_torch.parallel import spmd

    cfg = gpt2.gpt2_small()                  # remat "full", bf16 activations
    B, T, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layer
    t0 = time.perf_counter()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: gpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda g: gpt2.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- step-0 gradients against an independent reference
    worst, worst_leaf, controls = grad_check(cfg, state.params, batch)
    if worst > GRAD_REL_TOL:
        fail("step-0 gradients disagree with the independent reference")
    for fname, err in controls.items():
        if err <= GRAD_REL_TOL:
            fail(f"planted fault {fname} passed the gradient check")

    # -- the main path: six steps on one batch, no host sync inside a step
    per_step = {"layer_norm_fwd": 2 * L + 1 + 2 * L,   # forward + replay
                "layer_norm_bwd": 2 * L + 1,
                "flash_attention_fwd": L + L,
                "flash_attention_bwd": L,
                "flash_attention_fwd_f32": 0,          # bf16 activations
                "flash_attention_bwd_f32": 0}
    counters = {"layer_norm_fwd": (ln, "launches"),
                "layer_norm_bwd": (ln, "bwd_launches"),
                "flash_attention_fwd": (fa, "launches"),
                "flash_attention_bwd": (fa, "bwd_launches"),
                "flash_attention_fwd_f32": (fa, "f32_launches"),
                "flash_attention_bwd_f32": (fa, "f32_bwd_launches")}

    def counts() -> dict:
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    torch.cuda.reset_peak_memory_stats()
    for m, a in counters.values():
        setattr(m, a, 0)
    metrics, step_s, step_counts = [], [], []
    for _ in range(TRAIN_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = prog.step_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
        step_counts.append({k: v - before[k] for k, v in counts().items()})
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    print(f"train launches {launches} per step {step_counts[-1]} "
          f"(expected per step {per_step})", flush=True)
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("non-finite loss or grad norm in training")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if int(state.step.item()) != TRAIN_STEPS:
        fail(f"state.step is {int(state.step.item())}, not {TRAIN_STEPS}")
    for c in step_counts:
        if c != per_step:
            fail(f"launches per step {c}, expected {per_step}")
    steady = step_s[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tok_s = B * T / (step_ms / 1e3)
    flop_share = gpt2.flops_per_token(cfg, T) * tok_s / card[1]
    res = dict(setup_s=setup_s, grad_rel_err=worst, grad_worst_leaf=worst_leaf,
               grad_rel_tol=GRAD_REL_TOL, grad_controls=controls,
               losses=losses, grad_norms=gnorms,
               step_ms_each=[1e3 * s for s in step_s], step_ms=step_ms,
               tokens_per_s=tok_s, model_flop_share=flop_share,
               peak_mem_gb=peak_gb, launches=launches,
               launches_per_step=step_counts[-1])
    for k, val in res.items():
        print(f"train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "train_step", lambda: prog.step_fn(state, batch), tag)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device

    tag = gpu_line()
    print(tag, flush=True)
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    card_key, card = peaks(name)
    print(f"peaks ({card_key} data sheet): {card[0] / 1e12} TB/s, "
          f"{card[1] / 1e12} bf16 TFLOP/s", flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)
    tc_report(tag)
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {"layer_norm_fwd": check_layer_norm(gen, card, dev),
            "flash_attention_fwd": check_flash(gen, card, dev),
            "layer_norm_bwd": check_layer_norm_bwd(gen, card, dev),
            "flash_attention_bwd": check_flash_bwd(gen, card, dev)}
    for r in (r for rs in rows.values() for r in rs):
        for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
            print(f"{r['name']} {'kernel_ms' if key == 'ms' else key} "
                  f"{r[key]:.6g} [{tag}]", flush=True)
    eng = engine_phase(dev)
    train = train_phase(dev, card, tag)

    def kernel_row(row, kname, source, replaces, phase):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": phase["launches"][kname],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    # forward kernels: the engine phase's launches; backward kernels: the
    # train phase's (each phase's counts were zeroed just before it ran).
    # Both flash rows are timed at the train step's (32, 1024, 12, 64).
    kernels = [
        kernel_row(rows["layer_norm_fwd"][0], "layer_norm_fwd",
                   "ray_tpu_torch/csrc/layer_norm.cu",
                   "ray_tpu/ops/layer_norm.py:33", eng),
        kernel_row(next(r for r in rows["flash_attention_fwd"]
                        if r["shape"][0] == TRAIN_BATCH),
                   "flash_attention_fwd",
                   "ray_tpu_torch/csrc/flash_attention.cu",
                   "ray_tpu/ops/flash_attention.py:50", eng),
        kernel_row(rows["layer_norm_bwd"][0], "layer_norm_bwd",
                   "ray_tpu_torch/csrc/layer_norm.cu",
                   "ray_tpu/ops/layer_norm.py:47", train),
        kernel_row(rows["flash_attention_bwd"][0], "flash_attention_bwd",
                   "ray_tpu_torch/csrc/flash_attention_bwd.cu",
                   "ray_tpu/ops/flash_attention.py:103", train),
    ]
    for k in kernels:
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms",
                                                  "bound_ms")):
            fail(f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
