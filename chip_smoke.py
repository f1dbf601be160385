"""Chip smoke test for ray_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``ray_tpu_torch/csrc`` with nvcc for sm_90a.
2. Kernel phase: at the serving path's shapes, holds each kernel against
   its plain PyTorch version on the card (bf16, stated tolerances) and
   times the kernel, the plain version and the closest single PyTorch
   call (a yardstick only: the port never calls it).
3. Engine phase: serves GPT-2 124M (full width, random weights from the
   seed, block matrices scaled x3 so the context decides the logits)
   through ``LLMEngine`` — 16 concurrent greedy requests — checks every
   request, checks that both kernels were launched by that run, and
   teacher-forces the engine's output through the full ``forward`` to
   hold the engine's per-step logits to it.  Then plants one fault at a
   time in the decode step's inputs and requires the same check to fail
   on each.
4. Prints one JSON line of per-kernel numbers, then, as the last line,
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
# LayerNorm mu/rstd (f32): summation order only.
LN_STAT_TOL = 1e-5
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


def bf16_excess(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |out - ref|, the largest ratio of an element's error to its
    limit, the limit's rms floor): the check passes when the ratio is at
    most 1."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    floor = BF16_RMS_FLOOR * r.pow(2).mean().sqrt()
    ratio = (err / (BF16_REL * r.abs() + floor)).max()
    return err.max().item(), ratio.item(), floor.item()


def bound_ms(nbytes: float, flops: float, card) -> tuple:
    bw, fl = card
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels
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
    for T, causal in ((64, True), (333, True), (1024, True), (333, False)):
        # q/k/v as the model makes them: strided views of one qkv tensor
        qkv = torch.randn((1, T, 3, H * D), generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = [qkv[:, :, i].unflatten(-1, (H, D)) for i in range(3)]
        out, lse = fa.flash_attention(q, k, v, causal, want_lse=True)
        outp, lsep = fa.flash_attention_plain(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(out, outp)
        lerr = (lse - lsep).abs().max().item()
        name = f"flash_attention_fwd(1x{T}x{H}x{D} bf16" \
            f"{', causal' if causal else ''})"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) "
              f"lse_err {lerr:.3g} tol {FLASH_LSE_TOL}", flush=True)
        if not (ratio <= 1.0 and lerr <= FLASH_LSE_TOL):
            fail(f"{name} disagrees with its plain version")
        if not causal:
            continue
        kern = lambda: fa.flash_attention(q, k, v, True)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         iters=5)
        qt, kt, vt = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        pairs = T * (T + 1) // 2            # causal: what the data needs
        flops = 4 * D * pairs * H
        nbytes = 4 * T * H * D * 2
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(1, T, H, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# ---------------------------------------------------------------- profile
def profile_steps(runner, pool, dev) -> dict:
    """One prefill at the longest bucket and one decode step at batch 16,
    each under torch.profiler: wall time, summed device time, the device's
    busy share and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = dict(wall_ms=wall, device_ms=dev_ms,
                         busy=dev_ms / wall if wall else float("nan"))
        print(f"profile {name} wall_ms {wall:.4g} device_ms {dev_ms:.4g} "
              f"busy {out[name]['busy']:.3f}", flush=True)
        for k, v in top:
            print(f"profile {name}   {v:.4g} ms  {k[:90]}", flush=True)
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
    for name in ("attn_qkv", "attn_out", "mlp_in", "mlp_out"):
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
        ln.launches = fa.launches = 0
        streams, outs, t_sub, wall = serve(prompts,
                                           SamplingParams(max_tokens=32))
        launches = {"layer_norm_fwd": ln.launches,
                    "flash_attention_fwd": fa.launches}
        stats = eng.stats()
        timing = dict(emit_at=dict(rec["emit_at"]),
                      prefill=list(rec["prefill"]), decode=list(rec["decode"]))
        for p, o in zip(prompts, outs):
            if len(o) != 32 or not all(0 <= t < V for t in o):
                fail(f"request of {len(p)} tokens returned {o}")
        print(f"engine launches {launches}", flush=True)
        for k, n in launches.items():
            if n <= 0:
                fail(f"{k} was not launched on the engine's path")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device

    print(gpu_line(), flush=True)
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    card_key, card = peaks(name)
    print(f"peaks ({card_key} data sheet): {card[0] / 1e12} TB/s, "
          f"{card[1] / 1e12} bf16 TFLOP/s", flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ln_rows = check_layer_norm(gen, card, dev)
    fa_rows = check_flash(gen, card, dev)
    for r in ln_rows + fa_rows:
        for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
            print(f"{r['name']} {'kernel_ms' if key == 'ms' else key} "
                  f"{r[key]:.6g}", flush=True)
    eng = engine_phase(dev)

    def kernel_row(row, kname, source, replaces):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": eng["launches"][kname],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    kernels = [
        kernel_row(ln_rows[0], "layer_norm_fwd",
                   "ray_tpu_torch/csrc/layer_norm.cu",
                   "ray_tpu/ops/layer_norm.py:33"),
        kernel_row(next(r for r in fa_rows if r["shape"][1] == 1024),
                   "flash_attention_fwd",
                   "ray_tpu_torch/csrc/flash_attention.cu",
                   "ray_tpu/ops/flash_attention.py:50"),
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
