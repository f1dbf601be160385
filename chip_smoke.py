"""Chip smoke test for ray_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``ray_tpu_torch/csrc`` with nvcc for sm_90a, and prints, for each
   bf16 tensor-core kernel, ptxas's registers, shared memory and spill
   bytes and the HMMA instructions in its SASS (``cuobjdump -sass``), and
   for the forward's instantiations their dynamic shared memory and
   blocks an SM; fails if one has no HMMA or spills.  The same for each
   LayerNorm kernel, with its 128-bit global loads and stores in place of
   HMMA; fails if a
   vector-I/O instantiation has no 128-bit load, spills, or takes more
   registers than the blocks an SM its grid assumes leave it.
2. Kernel phase: at the serving path's shapes, holds each kernel against
   its plain PyTorch version on the card (bf16, stated tolerances) and
   times the kernel, the plain version and the closest single PyTorch
   call (a yardstick only: the port never calls it).
   The flash forward's head-dim-128 instantiation is held at Llama-3 8B's
   shapes (32 query heads over 8 KV heads), where a plain version with
   the KV heads in the wrong (tiled) order must fail the same check.
   The backward kernels, and both forward kernels once more, are held the
   same way at the training path's shapes; the LayerNorm backward's
   dscale/dbias must also be bitwise equal between two calls; the
   head-dim-128 grouped backward at Llama training's (4, 2048, 32 over 8,
   128), with its own tiled-order control.
3. Engine phase: serves GPT-2 124M (full width, random weights from the
   seed, block matrices scaled x3 so the context decides the logits)
   through ``LLMEngine`` — 16 concurrent greedy requests — checks every
   request, checks that both kernels were launched by that run (and the
   float32 flash kernel and the scalar-I/O LayerNorm never), and
   teacher-forces the engine's output through the full ``forward`` to
   hold the engine's per-step logits to it.  Then plants one fault at a
   time in the decode step's inputs and requires the same check to fail
   on each.  Then the same for Llama-3 8B (full width and depth, weights
   drawn on the card, block matrices x2): 32 head-dim-128 flash launches
   per prefill step and per full forward, none of another instantiation;
   the weights and the pool are freed before the next phase.
   Between the two, the weights-plane phase: a GPT-2 124M engine with
   ``share_weights=True`` publishes its params to this run's own
   directory under ``/dev/shm`` (``RTPU_SHM_DIR``, set for the whole run
   and removed at exit, so two runs on one machine never meet in the
   plane), an engine in a child process attaches (its private
   init is stamped, so only the attach gives the publisher's bytes) and
   must hold ``wte`` and a block matrix bitwise equal to the publisher's;
   shutdown unlinks the segment.
4. Train phase: trains GPT-2 124M (full width, random init from the seed,
   batch 32 x seq 1024, remat on) through ``spmd.build_train_program``.
   Holds every parameter's step-0 gradient to an independent reference
   (plain autograd through dense attention and the plain LayerNorm),
   requires two planted backward faults to fail that check, then runs six
   steps on one batch with host syncs made errors, and checks the falling
   loss, the step count and each kernel's launches per step (none of the
   float32 flash kernels or the scalar-I/O LayerNorm ones).  Prints the
   step time, tokens/s, the model-FLOP share and one profiled step.
   Then the same for Llama-3 8B's full width at 4 of its 32 layers
   (batch 4 x seq 2048): the head-dim-128 grouped flash forward and
   backward, 8 and 4 launches a step and no other kernel; a planted fault
   gives a KV head the wrong group of query heads.
   Then bench.py's GPT-2-1.5B recipe (BASELINE #5): GPT-2 xl at full width
   and depth, remat "attn", bf16 params and Adam moments, batch 8 x seq
   1024.  Step-0 gradients under the four remat policies must be bitwise
   equal, and "attn" must not replay the flash forward; a gradient check
   at 2 layers against dense attention, with two planted faults; six
   steps with every LayerNorm on the wide-row kernels (E 1600) and the
   flash forward once a layer.  Last, moe-small (the top-2 MoE
   transformer, 0.52 B params) at full size, held to its plain path
   (plain LayerNorm, the reference's einsum dispatch) with the routing
   held equal, then six steps on the LayerNorm kernels.
   The kernel phase also holds the wide-row LayerNorm kernels at E 1024,
   1280 and 1600 to their plain versions, and the vector ones at BERT's
   eps 1e-12, ViT's eps 1e-6 and on ViT's strided CLS rows.
5. Encoder and vision phases.  The four tiny models (ResNet, BERT, ViT,
   T5) in float32 against the JAX package's outputs committed in
   tests/data/tiny_reference.json, with ResNet's symmetric padding and
   BERT's ignored mask planted, each of which must fail that check.
   ResNet-50 (BASELINE #2) at resnet_bench.py's batch 128 x 224²: step-0
   gradients against float32, six steps, the step-0 loss ln 1000, no
   hand-written kernel.  BERT-base classify (BASELINE #4) at batches 1,
   2, 4, 8 x 128: each padded row against the row alone (a planted
   ignored mask must fail), the kernel path against the plain
   LayerNorm, 25 vector LayerNorm launches a call, latency and device
   time.  ViT-B/16 at batch 128: step-0 gradients against the plain
   LayerNorm path (a rolled rstd must fail), 25 + 25 LayerNorm launches
   a step.  T5-base at batch 32 x 512 / 114: the card's bucket tables
   against the CPU's, step-0 gradients against float32 (bidirectional
   decoder buckets must fail), six steps.
6. RLlib phases (no hand-written kernel on this path; every kernel
   counter must stay 0).  The learners of PPO, IMPALA, APPO and DQN
   (double_q on and off) and V-trace, at an MLP and a conv size, in
   float32 against the JAX package's outputs committed in
   tests/data/rllib_reference.json, with the conv torso flattened in
   (C, H, W) order, RMSProp's eps outside the root and PPO's unbiased
   advantage std planted, each of which must fail that check.  IMPALA
   with BASELINE #3's learner recipe (Nature CNN, 84×84×4 frames, 512
   an update, local sampling): the step-0 update against the CPU's (a
   planted flatten order must fail), then train() for a fixed wall
   budget (update ms, compute_actions ms, env frames/s, busy share,
   peak memory).  PPO with BASELINE #1's learner settings on
   PixelSquareEnv must beat the random policy's reward within a cap of
   iterations.  DQN: finite TD errors, the target synced on schedule.
   The reference check also holds SAC, DDPG, TD3 (two updates), MARWIL,
   BC, A3C (compute_gradients and apply) and Ape-X (one update), with
   SAC's log-probability without its 1e-6, TD3's actor stepping on every
   update, MARWIL's advantages normalised by the pre-update c² and Ape-X
   without its importance weights planted.  SAC with its defaults on
   PendulumLite (gymnasium's Pendulum-v1, copied below: the card's
   machine has no gymnasium): the step-0 update against the CPU's (a
   swapped Polyak average must fail), then a fixed step cap, after which
   it must beat a random policy's return.  TD3: the actor, its Adam count
   and its target move on exactly every second update; actions in
   bounds.  MARWIL and BC over 80 recorded episodes (BC's dataset NLL
   must fall); A3C's and Ape-X's local paths on the pixel task
   (priorities written back, the target synced on schedule).
7. Prints each phase's wall seconds, one JSON line of per-kernel numbers,
   then, as the last line, ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.  Imports neither JAX nor the ray_tpu package.
"""

from __future__ import annotations

import atexit
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

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
# Flash forward at head dim 128 (Llama) against its plain version: two
# of those steps, as the backward.  The output sums p·v with p rounded to
# bf16 (the reference's rounding point, at the same running maxima on
# both sides); the tensor cores accumulate each score over 128 dims in 8
# truncating k-steps, cuBLAS's float32 GEMM otherwise, and where the two
# p's straddle a bf16 rounding boundary one term of the sum moves by a
# step of p.  Measured at (8, 2048, 32 over 8, 128): 1.253 of one step at
# its worst element (PERF.md §6); at head dim 64 one step holds.
FLASH_D128_STEPS = 2
# LayerNorm mu/rstd (f32): summation order only.
LN_STAT_TOL = 1e-5
# LayerNorm dscale/dbias (f32 sums over the rows), held to the exact
# (float64) sum of the plain version's float32 terms g * xhat and g.  A
# sum whose every term passes through at most d roundings is within
# d * 2^-24 * sum|terms| of the exact sum (first order).  The kernel's
# chain, per column (ln_sum_depth): the rows a warp walks, summed in a
# register; the block's warps, added into shared memory one at a time;
# the blocks' partial rows, summed outside in some order (at most nb - 1
# roundings).  Its products g * xhat enter the register sum by FMA,
# unrounded, which is LN_SUM_FMA_STEPS more against the rounded terms.
LN_SUM_FMA_STEPS = 1
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

# The Llama engine phase: Llama-3 8B at full width and depth, 16 requests
# of up to 2016 tokens each: the pool holds 2100 blocks of 16 tokens
# (262 KB a token in float32: 8.8 GB).
LLAMA_NUM_BLOCKS = 2100
LLAMA_BLOCK_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                        "w_down")
# Llama's weights are its init with every block matrix scaled x2, and
# its logits limit is 1.5: set anew from a sweep of the scale on the card
# (llama_sweep; PERF.md §6).  Healthy error and the smallest planted
# fault (a dropped key): x1 0.370 / 1.875, x2 0.586 / 3.848, x3 0.688 /
# 1.742, x5 0.859 / 3.664.  Only x1, x2 and x5 leave room for a limit 2x
# above the one and 2x below the other; x2 leaves the most (6.6x), and
# 1.5 sits 2.56x from each.  The healthy error is bf16 rounding through
# 32 layers of random weights: in float32 (CPU, 4 layers) the engine's
# logits equal the full forward's to 1.5e-6.
LLAMA_ENGINE_BLOCK_SCALE = 2.0
LLAMA_ENGINE_LOGIT_TOL = 1.5

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


# Llama train phase: Llama-3 8B's full width (E 4096, 32 query heads over
# 8 KV heads, head dim 128, SwiGLU 14336, V 128256, theta 500000) at
# LLAMA_TRAIN_LAYERS of its 32 layers: the preset's f32 params, grads and
# two AdamW moments come to ~128 GB, past one 80 GB card; 4 layers are
# 1.92 B params, ~31 GB of that state.
LLAMA_TRAIN_LAYERS = 4
LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ = 4, 2048
# Step-0 gradients against plain autograd through dense GQA attention, the
# worst leaf's relative L2 error.  Set from the sweep on the card
# (llama_grad_sweep; PERF.md §6): at the init the healthy error is 0.0388
# against the bf16 reference and 0.0333 against a float32 one (bf16
# rounding through 4 layers of 4096), and the planted faults are 942 and
# 9773; at x2 the healthy error alone reaches 0.19-0.23 and the faults
# overflow.  So the check runs at the init, and 0.1 sits 2.6x above the
# healthy error and 9,400x below the smaller fault.
LLAMA_GRAD_REL_TOL = 0.1
LLAMA_BLOCK_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                        "w_down")


def _heads_tiled(t: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, T, H, D) with query head h moved to where the kernel's rule
    (KV head j // (H / KV) for position j) gives it KV head h % KV: the
    tiled order, jnp.tile's.  _heads_untiled undoes it."""
    return t.unflatten(2, (t.shape[2] // n_kv, n_kv)).transpose(2, 3) \
        .flatten(2, 3)


def _heads_untiled(t: torch.Tensor, n_kv: int) -> torch.Tensor:
    return t.unflatten(2, (n_kv, t.shape[2] // n_kv)).transpose(2, 3) \
        .flatten(2, 3)


def _rows_tiled(r: torch.Tensor, B: int, n_kv: int) -> torch.Tensor:
    """The same move on (B*H, T) rows of lse or delta."""
    H = r.shape[0] // B
    return r.view(B, H // n_kv, n_kv, -1).transpose(1, 2).reshape(r.shape)


def _kv_groups_tiled(f):
    """The backward with q, dO, lse and delta in the tiled head order: each
    KV head gets the wrong group of query heads; dq is moved back."""
    def bwd(q, k, v, lse, d, do, c):
        n_kv, B = k.shape[2], q.shape[0]
        dq, dk, dv = f(_heads_tiled(q, n_kv), k, v, _rows_tiled(lse, B, n_kv),
                       _rows_tiled(d, B, n_kv), _heads_tiled(do, n_kv), c)
        return _heads_untiled(dq, n_kv), dk, dv
    return bwd


# Faults planted in the Llama backward, one run each: each must push some
# leaf past LLAMA_GRAD_REL_TOL.
LLAMA_GRAD_FAULTS = {
    "flash_bwd_kv_groups_tiled": _kv_groups_tiled,
    "flash_bwd_lse_rolled": lambda f: lambda q, k, v, lse, d, do, c: f(
        q, k, v, lse.roll(1, 0), d, do, c),
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
# The bf16 tensor-core kernels, by a piece of their mangled names; the
# forward's instantiations <block_m, head dim> with their (D, block_m).
TC_FWD = {"flash_fwd_tc_kernelILi64ELi64E": (64, 64),
          "flash_fwd_tc_kernelILi128ELi64E": (64, 128),
          "flash_fwd_tc_kernelILi64ELi128E": (128, 64)}
# The backward's head-dim-128 grouped kernels with their pass (dK/dV 0,
# dQ 1) for backward_occupancy.
TC_BWD_GQA = {"flash_bwd_dkdv_gqa_kernel": 0, "flash_bwd_dq_gqa_kernel": 1}
TC_KERNELS = tuple(TC_FWD) + ("flash_bwd_dkdv_tc_kernel",
                              "flash_bwd_dq_tc_kernel") + tuple(TC_BWD_GQA)


def tc_report(tag: str) -> dict:
    """For each bf16 tensor-core kernel of the build: ptxas's registers a
    thread, static shared memory a block and spill bytes, and the HMMA
    instructions in its SASS; for the forward's instantiations also their
    dynamic shared memory and the blocks an SM the occupancy calculator
    allows.  Fails if one has no HMMA or spills."""
    from ray_tpu_torch import _build
    from ray_tpu_torch.ops import flash_attention as fa
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
        if key in TC_FWD or key in TC_BWD_GQA:
            smem, per_sm = fa.forward_occupancy(*TC_FWD[key]) \
                if key in TC_FWD else fa.backward_occupancy(TC_BWD_GQA[key])
            out[key].update(dynamic_smem_bytes=smem, blocks_per_sm=per_sm)
        print(f"sass {key} " + " ".join(f"{k} {v}" for k, v in
                                        out[key].items()) + f" [{tag}]",
              flush=True)
        if out[key]["hmma"] == 0:
            fail(f"kernel {key} has no HMMA: it does not use the tensor "
                 f"cores")
        if out[key]["spill_stores"] or out[key]["spill_loads"]:
            fail(f"kernel {key} spills")
        if out[key].get("blocks_per_sm", 1) < 1:
            fail(f"kernel {key} cannot be resident on an SM")
    return out


# The LayerNorm kernels by a piece of their mangled names: (name, whether
# it is a vector-I/O instantiation, threads a block, blocks an SM that the
# wrapper's grid assumes, or 0 where the grid assumes none).
def ln_kernels() -> list:
    from ray_tpu_torch.ops import layer_norm as ln
    out = []
    for dt, mangled in ((torch.bfloat16, "I13__nv_bfloat16E"),
                        (torch.float32, "IfE")):
        out += [(f"layer_norm_fwd_vec_kernel{mangled}", True,
                 32 * ln.FWD_WARPS, ln.FWD_BLOCKS_PER_SM),
                (f"layer_norm_bwd_vec_kernel{mangled}", True,
                 32 * ln.BWD_WARPS, ln.BWD_BLOCKS_PER_SM[dt]),
                (f"layer_norm_fwd_wide_kernel{mangled}", True,
                 32 * ln.FWD_WARPS, ln.WIDE_FWD_BLOCKS_PER_SM),
                (f"layer_norm_bwd_wide_kernel{mangled}", True,
                 32 * ln.BWD_WARPS, ln.WIDE_BWD_BLOCKS_PER_SM),
                (f"layer_norm_fwd_scalar_kernel{mangled}", False, 0, 0),
                (f"layer_norm_bwd_scalar_kernel{mangled}", False, 0, 0)]
    return out


def ln_report(tag: str) -> dict:
    """For each LayerNorm kernel of the build: ptxas's registers, shared
    memory and spill bytes, and the 128-bit global loads and stores in
    its SASS.  Fails if a vector-I/O instantiation has no 128-bit load,
    spills, or takes more registers than the blocks an SM its grid
    assumes leave it."""
    from ray_tpu_torch import _build
    from ray_tpu_torch.ops import layer_norm as ln
    res = _build.kernel_resources()
    ldg = _build.sass_counts("LDG.E.128")
    stg = _build.sass_counts("STG.E.128")
    out = {}
    for key, vector, threads, per_sm in ln_kernels():
        names = [n for n in ldg if key in n]
        rnames = [n for n in res if key in n]
        if len(names) != 1 or len(rnames) != 1:
            fail(f"kernel {key}: {len(names)} SASS functions and "
                 f"{len(rnames)} ptxas entries")
        r = out[key] = dict(res[rnames[0]], ldg_128=ldg[names[0]],
                            stg_128=stg[names[0]])
        if "bwd_wide" in key:        # its shared memory is dynamic
            r["dynamic_smem_bytes_at_e1600"] = ln.wide_bwd_smem_bytes(1600)
        print(f"sass {key} " + " ".join(f"{k} {v}" for k, v in r.items())
              + f" [{tag}]", flush=True)
        if not vector:
            continue
        if r["ldg_128"] == 0:
            fail(f"kernel {key} has no 128-bit global load")
        if r["spill_stores"] or r["spill_loads"]:
            fail(f"kernel {key} spills")
        if r["registers"] * threads * per_sm > 65536:
            fail(f"kernel {key}: {r['registers']} registers leave fewer "
                 f"than the {per_sm} blocks an SM its grid assumes")
    return out


# The LayerNorm forward's shapes, (N, E, with stats, timed): the vector
# kernel at the longest prefill bucket and the decode batch (stats-free,
# as served) and the GPT-2 train step's rows (with the stats, as
# trained); the wide-row kernel at GPT-2 medium, large and xl's widths
# over the xl train step's rows (b8 x s1024), and a ragged 333 rows.
# Then (N, E, stats, timed, eps, row stride): BERT-base serving's rows at
# its largest batch (8 x 128, eps 1e-12, stats-free), ViT-B/16 training's
# (128 x 197 rows, eps 1e-6, with stats) and its ln_f on the CLS rows
# x[:, 0], 128 rows 197 x 768 elements apart.  An entry without the last
# two has eps 1e-5 and dense rows.
BERT_SEQ, BERT_BATCHES = 128, (1, 2, 4, 8)
VIT_TRAIN_BATCH, VIT_TOKENS = 128, 197
LN_SHAPES = ((1024, 768, False, True), (16, 768, False, True),
             (TRAIN_BATCH * TRAIN_SEQ, 768, True, True),
             (BERT_BATCHES[-1] * BERT_SEQ, 768, False, True, 1e-12, 768),
             (VIT_TRAIN_BATCH * VIT_TOKENS, 768, True, True, 1e-6, 768),
             (VIT_TRAIN_BATCH, 768, True, False, 1e-6, VIT_TOKENS * 768))
XL_TRAIN_BATCH, XL_TRAIN_SEQ = 8, 1024
LN_WIDE_SHAPES = ((XL_TRAIN_BATCH * XL_TRAIN_SEQ, 1024, True, False),
                  (XL_TRAIN_BATCH * XL_TRAIN_SEQ, 1280, True, False),
                  (XL_TRAIN_BATCH * XL_TRAIN_SEQ, 1600, True, True),
                  (333, 1600, True, False))
# launch counters of each LayerNorm route, forward and backward
LN_FWD_COUNTERS = {"vector": "launches", "wide": "wide_launches",
                   "scalar": "scalar_launches"}
LN_BWD_COUNTERS = {"vector": "bwd_launches", "wide": "bwd_wide_launches",
                   "scalar": "bwd_scalar_launches"}


def _ln_took(counters: dict, before: dict, route: str) -> bool:
    """Whether exactly one launch went to ``route`` since ``before``."""
    from ray_tpu_torch.ops import layer_norm as ln
    return all(getattr(ln, a) - before[r] == (r == route)
               for r, a in counters.items())


def _ln_counts(counters: dict) -> dict:
    from ray_tpu_torch.ops import layer_norm as ln
    return {r: getattr(ln, a) for r, a in counters.items()}


def check_layer_norm(gen, card, dev, shapes=LN_SHAPES,
                     route: str = "vector") -> list:
    import torch.nn.functional as F
    from ray_tpu_torch.ops import layer_norm as ln
    rows = []
    for shape in shapes:
        N, E, stats, timed, eps, stride = (*shape, 1e-5, shape[1])[:6]
        x = torch.randn((N, stride), generator=gen, device=dev).to(
            torch.bfloat16)[:, :E]
        scale = 1 + 0.1 * torch.randn((E,), generator=gen, device=dev)
        bias = 0.1 * torch.randn((E,), generator=gen, device=dev)
        before = _ln_counts(LN_FWD_COUNTERS)
        y, mu, rstd = ln.ln_fwd(x, scale, bias, eps, want_stats=True)
        if not _ln_took(LN_FWD_COUNTERS, before, route):
            fail(f"layer_norm_fwd at ({N}, {E}) bf16 did not take the "
                 f"{route} kernel")
        yp, mup, rstdp = ln.ln_fwd_plain(x, scale, bias, eps)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(y, yp)
        serr = max((mu - mup).abs().max().item(),
                   ((rstd - rstdp).abs() / rstdp.abs()).max().item())
        del y, mu, rstd, yp, mup, rstdp
        name = f"layer_norm_fwd{'_wide' if route == 'wide' else ''}" \
            f"({N}x{E} bf16{', stats' if stats else ''}" \
            f"{f', eps {eps:g}' if eps != 1e-5 else ''}" \
            f"{f', rows {stride} apart' if stride != E else ''})"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) "
              f"stats_err {serr:.3g} tol {LN_STAT_TOL}", flush=True)
        if not (ratio <= 1.0 and serr <= LN_STAT_TOL):
            fail(f"{name} disagrees with its plain version")
        if not timed:
            continue
        kern = lambda: ln.ln_fwd(x, scale, bias, eps,  # noqa: E731
                                 want_stats=stats)
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: ln.ln_fwd_plain(x, scale, bias, eps),
                         iters=5 if N > 1024 else 20)
        s16 = scale.to(torch.bfloat16)
        b16 = bias.to(torch.bfloat16)
        lib = lambda: F.layer_norm(x, (E,), s16, b16, eps)  # noqa: E731
        l_ms, lc_ms = device_ms(lib), call_ms(lib)
        nbytes = 2 * N * E * 2 + 2 * E * 4 + (2 * N * 4 if stats else 0)
        b_ms, b_by = bound_ms(nbytes, 8 * N * E, card)
        rows.append(dict(name=name, shape=(N, E), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, library_call_ms=lc_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def ln_sum_depth(N: int, nb: int) -> int:
    """The roundings a column of the backward's dscale/dbias passes
    through, at most (LN_SUM_FMA_STEPS above)."""
    from ray_tpu_torch.ops import layer_norm as ln
    return -(-N // (nb * ln.BWD_WARPS)) + ln.BWD_WARPS + (nb - 1) \
        + LN_SUM_FMA_STEPS


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
        bm = fa.forward_block_m(B, T, H, dev, D)
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
        other = [x for x in fa.BLOCK_MS[D] if x != bm][0]
        o_ms = device_ms(lambda: fa._flash_kernel(q, k, v, True, False,
                                                  other))
        print(f"{name} kernel_ms {k_ms:.6g} at block_m {bm}, {o_ms:.6g} "
              f"at block_m {other}", flush=True)
        p_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         **(dict(iters=5) if B == 1
                            else dict(iters=3, reps=2)))
        qt, kt, vt = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        l_ms, lc_ms = device_ms(lib), call_ms(lib)
        del qt, kt, vt
        pairs = T * (T + 1) // 2            # causal: what the data needs
        flops = 4 * D * pairs * B * H
        nbytes = 4 * B * T * H * D * 2
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(B, T, H, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, library_call_ms=lc_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# Llama-3 8B's attention shapes (B, T, causal): prefill buckets at B = 1,
# a ragged length both ways, and one loaded shape.
GQA_SHAPES = ((1, 64, True), (1, 333, True), (1, 1024, True),
              (1, 2048, True), (1, 333, False), (8, 2048, True))


def check_flash_gqa(gen, card, dev) -> list:
    """The head-dim-128 instantiation at Llama-3 8B's attention: 32 query
    heads over 8 KV heads, q a view of a (B, T, 4096) projection, k and v
    (B, T, 8, 128) of their own.  Each shape is held to the plain version;
    a planted control (the plain version's KV heads in tiled order) must
    fail the same check at every B = 1 shape."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    rows = []
    H, KV, D = 32, 8, 128
    G = H // KV
    for B, T, causal in GQA_SHAPES:
        q = torch.randn((B, T, H * D), generator=gen, device=dev) \
            .to(torch.bfloat16).view(B, T, H, D)
        k, v = (torch.randn((B, T, KV, D), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        before = (fa.launches, fa.d128_launches, fa.f32_launches)
        out, lse = fa.flash_attention(q, k, v, causal, want_lse=True)
        if (fa.launches, fa.d128_launches, fa.f32_launches) != \
                (before[0], before[1] + 1, before[2]):
            fail(f"flash at ({B}, {T}, {H}/{KV}, {D}) did not take the "
                 f"head-dim-128 kernel")
        outp, lsep = fa.flash_attention_plain(q, k, v, causal, want_lse=True)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(out, outp, FLASH_D128_STEPS)
        lerr = (lse - lsep).abs().max().item()
        del outp, lsep
        name = f"flash_attention_fwd_gqa_d128({B}x{T}x{H}/{KV}x{D} bf16" \
            f"{', causal' if causal else ''})"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {FLASH_D128_STEPS}*({BF16_REL:.6g}*|ref| + "
              f"{floor:.6g})) lse_err {lerr:.3g} tol {FLASH_LSE_TOL}",
              flush=True)
        if not (ratio <= 1.0 and lerr <= FLASH_LSE_TOL):
            fail(f"{name} disagrees with its plain version")
        if B == 1:
            # control: KV head h % KV (jnp.tile's order) for query head h
            tiled = [t.repeat(1, 1, G, 1) for t in (k, v)]
            outc, lsec = fa.flash_attention_plain(q, *tiled, causal,
                                                  want_lse=True)
            torch.cuda.synchronize()
            _, cratio, _ = bf16_excess(out, outc, FLASH_D128_STEPS)
            clerr = (lse - lsec).abs().max().item()
            del outc, lsec, tiled
            print(f"{name} control kv_heads_tiled worst_err/limit "
                  f"{cratio:.4g} lse_err {clerr:.3g} (must fail)",
                  flush=True)
            if cratio <= 1.0 and clerr <= FLASH_LSE_TOL:
                fail(f"{name}: the tiled-order control passed the check")
        del out, lse
        if not causal:
            continue
        kern = lambda: fa.flash_attention(q, k, v, True)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         **(dict(iters=5) if B == 1
                            else dict(iters=2, reps=2)))
        # yardstick: SDPA on the same KV heads (enable_gqa), and on K/V
        # expanded to H heads beforehand
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        ke, ve = (fa.gqa_expand(t, H).transpose(1, 2).contiguous()
                  for t in (k, v))
        le_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=True))
        del qt, kt, vt, ke, ve
        pairs = T * (T + 1) // 2            # causal: what the data needs
        flops = 4 * D * pairs * B * H
        nbytes = 2 * B * T * D * (2 * H + 2 * KV)
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(B, T, H, KV, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, library_expanded_ms=le_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# The LayerNorm backward's shapes, (N, E, timed, x's row stride): the
# GPT-2 train step's rows and a ragged 333; ViT-B/16 training's rows and
# its CLS rows (the cotangent dense); the wide-row kernel's as the
# forward's.  An entry without the last has dense rows.
LN_BWD_SHAPES = ((TRAIN_BATCH * TRAIN_SEQ, 768, True), (333, 768, False),
                 (VIT_TRAIN_BATCH * VIT_TOKENS, 768, True, 768),
                 (VIT_TRAIN_BATCH, 768, False, VIT_TOKENS * 768))
LN_BWD_WIDE_SHAPES = tuple((N, E, timed)
                           for N, E, _, timed in LN_WIDE_SHAPES)


def check_layer_norm_bwd(gen, card, dev, shapes=LN_BWD_SHAPES,
                         route: str = "vector") -> list:
    from ray_tpu_torch._device import sm_count
    from ray_tpu_torch.ops import layer_norm as ln
    rows = []
    for shape in shapes:
        N, E, timed, stride = (*shape, shape[1])[:4]
        x = torch.randn((N, stride), generator=gen, device=dev).to(
            torch.bfloat16)[:, :E]
        g = torch.randn((N, E), generator=gen, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn((E,), generator=gen, device=dev)
        bias = torch.zeros((E,), device=dev)
        _, mu, rstd = ln.ln_fwd_plain(x, scale, bias, 1e-5)
        before = _ln_counts(LN_BWD_COUNTERS)
        dx, ds, db = ln.ln_bwd(x, scale, g, mu, rstd)
        if not _ln_took(LN_BWD_COUNTERS, before, route):
            fail(f"layer_norm_bwd at ({N}, {E}) bf16 did not take the "
                 f"{route} kernel")
        _, ds2, db2 = ln.ln_bwd(x, scale, g, mu, rstd)
        dxp, dsp, dbp = ln.ln_bwd_plain(x, scale, g, mu, rstd)
        torch.cuda.synchronize()
        err, ratio, floor = bf16_excess(dx, dxp)
        repro = torch.equal(ds, ds2) and torch.equal(db, db2)
        # the f32 sums: each column within depth * 2^-24 * sum|terms| of
        # the exact sum of the plain version's terms
        xhat = (x.float() - mu[:, None]) * rstd[:, None]
        _, nb = ln.launch_plan(N, E, E, 0, x.dtype, sm_count(dev),
                               backward=True)
        depth = ln_sum_depth(N, nb)
        sum_ratio = max(
            ((k.double() - t.double().sum(0)).abs()
             / (depth * 2.0 ** -24 * t.abs().double().sum(0))).max().item()
            for k, t in ((ds, g.float() * xhat), (db, g.float())))
        plain_ratio = max(
            ((p.double() - t.double().sum(0)).abs()
             / (depth * 2.0 ** -24 * t.abs().double().sum(0))).max().item()
            for p, t in ((dsp, g.float() * xhat), (dbp, g.float())))
        del xhat, dxp, dsp, dbp
        name = f"layer_norm_bwd{'_wide' if route == 'wide' else ''}" \
            f"({N}x{E} bf16{f', rows {stride} apart' if stride != E else ''})"
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {BF16_REL:.6g}*|ref| + {floor:.6g}) dscale/dbias "
              f"worst_err/limit {sum_ratio:.4g} (limit {depth}*2^-24*"
              f"sum|terms| from the exact sum; the plain version's f32 "
              f"sums {plain_ratio:.4g} of it) bitwise_repeatable {repro}",
              flush=True)
        if not (ratio <= 1.0 and sum_ratio <= 1.0):
            fail(f"{name} disagrees with its plain version")
        if not repro:
            fail(f"{name}: dscale/dbias differ between two calls")
        if not timed:
            continue
        kern = lambda: ln.ln_bwd(x, scale, g, mu, rstd)  # noqa: E731
        k_ms, c_ms = device_ms(kern), call_ms(kern)
        p_ms = device_ms(lambda: ln.ln_bwd_plain(x, scale, g, mu, rstd),
                         iters=5)
        s16 = scale.to(torch.bfloat16)
        mu2, rstd2 = mu[:, None], rstd[:, None]
        lib = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
            g, x, [E], mu2, rstd2, s16, s16, [True, True, True])
        l_ms, lc_ms = device_ms(lib), call_ms(lib)
        nbytes = 3 * N * E * 2 + 2 * N * 4 + 3 * E * 4
        b_ms, b_by = bound_ms(nbytes, 10 * N * E, card)
        rows.append(dict(name=name, shape=(N, E), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, library_call_ms=lc_ms,
                         bound_ms=b_ms, bound_by=b_by))
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


# Llama-3 8B's attention backward: the train phase's shape and a ragged
# one both ways.
GQA_BWD_SHAPES = ((4, 2048, True), (1, 333, True), (1, 333, False))


def check_flash_bwd_gqa(gen, card, dev) -> list:
    """The head-dim-128 grouped backward at Llama-3 8B's attention (32
    query heads over 8 KV heads): dq, dk and dv held to the plain version
    within FLASH_BWD_STEPS; a planted control (the plain version with the
    KV heads in tiled order, jnp.tile's, both ways) must fail the same
    check at every shape."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    rows = []
    H, KV, D = 32, 8, 128
    G = H // KV
    for B, T, causal in GQA_BWD_SHAPES:
        q = torch.randn((B, T, H * D), generator=gen, device=dev) \
            .to(torch.bfloat16).view(B, T, H, D)
        k, v = (torch.randn((B, T, KV, D), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        do = torch.randn((B, T, H, D), generator=gen,
                         device=dev).to(torch.bfloat16)
        out, lse = fa.flash_attention_plain(q, k, v, causal, want_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(B * H, T)
        del out
        before = (fa.bwd_launches, fa.d128_bwd_launches, fa.f32_bwd_launches)
        got = fa.flash_attention_bwd(q, k, v, lse, delta, do, causal)
        if (fa.bwd_launches, fa.d128_bwd_launches, fa.f32_bwd_launches) != \
                (before[0], before[1] + 1, before[2]):
            fail(f"flash backward at ({B}, {T}, {H}/{KV}, {D}) did not take "
                 f"the head-dim-128 kernel")
        if got[1].shape != k.shape or got[2].shape != v.shape:
            fail(f"dk, dv {tuple(got[1].shape)} {tuple(got[2].shape)}, "
                 f"expected {tuple(k.shape)}")
        ref = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)
        torch.cuda.synchronize()
        name = f"flash_attention_bwd_gqa_d128({B}x{T}x{H}/{KV}x{D} bf16" \
            f"{', causal' if causal else ''})"
        errs = {n: bf16_excess(a, r, FLASH_BWD_STEPS) for n, a, r in
                zip(("dq", "dk", "dv"), got, ref)}
        del ref
        err = max(e[0] for e in errs.values())
        ratio = max(e[1] for e in errs.values())
        print(f"{name} max_abs_err {err:.6g} worst_err/limit {ratio:.4g} "
              f"(limit {FLASH_BWD_STEPS}*({BF16_REL:.6g}*|ref| + floor)) "
              + " ".join(f"{n}:{e[1]:.3g}(floor {e[2]:.3g})"
                         for n, e in errs.items()), flush=True)
        if ratio > 1.0:
            fail(f"{name} disagrees with its plain version")
        # control: KV head h % KV (jnp.tile's order) for query head h, the
        # per-head dk and dv summed in the same order
        dq_c, dk_c, dv_c = fa.flash_attention_bwd_plain(
            q, k.repeat(1, 1, G, 1), v.repeat(1, 1, G, 1), lse, delta, do,
            causal)
        ctrl = (dq_c, dk_c.unflatten(2, (G, KV)).sum(2),
                dv_c.unflatten(2, (G, KV)).sum(2))
        cratio = {n: bf16_excess(a, r, FLASH_BWD_STEPS)[1] for n, a, r in
                  zip(("dq", "dk", "dv"), got, ctrl)}
        del got, ctrl, dq_c, dk_c, dv_c
        print(f"{name} control kv_heads_tiled worst_err/limit "
              + " ".join(f"{n}:{r:.4g}" for n, r in cratio.items())
              + " (must fail)", flush=True)
        if max(cratio.values()) <= 1.0:
            fail(f"{name}: the tiled-order control passed the check")
        if not causal:
            continue
        kern = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, lse, delta, do, True)
        k_ms, c_ms = device_ms(kern, iters=5), call_ms(kern, iters=10)
        p_ms = device_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, lse, delta, do, True),
            **(dict(iters=2, reps=2) if B > 1 else dict(iters=5)))
        # yardstick: SDPA's backward with enable_gqa on a retained graph,
        # by CUDA events over back-to-back calls
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        l_ms = call_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del o, qt, kt, vt, dot
        pairs = T * (T + 1) // 2            # causal: what the data needs
        flops = 5 * 2 * D * pairs * B * H
        nbytes = 2 * B * T * D * (3 * H + 4 * KV) + 2 * B * H * T * 4
        b_ms, b_by = bound_ms(nbytes, flops, card)
        rows.append(dict(name=name, shape=(B, T, H, KV, D), max_abs_err=err,
                         ms=k_ms, call_ms=c_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


# ---------------------------------------------------------------- profile
def kernel_class(name: str) -> str:
    """A device kernel's class, by its name: matrix products (cuBLAS's
    nvjet, CUTLASS and gemv kernels), copies and casts, reductions, the
    other elementwise passes, or other."""
    n = name.lower()
    if any(w in n for w in ("gemm", "nvjet", "gemv", "cutlass")):
        return "matmul"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy"          # dtype casts are copy kernels too
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reduction"
    if "elementwise" in n:
        return "elementwise"
    return "other"


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
    classes = {}
    for k, v in by_kernel.items():
        c = kernel_class(k) if k not in ours else "hand-written"
        classes[c] = classes.get(c, 0.0) + v
    res = dict(wall_ms=wall, device_ms=dev_ms,
               busy=dev_ms / wall if wall else float("nan"),
               top=[(k[:90], v) for k, v in top],
               hand_written_ms=sum(ours.values()), by_class=classes)
    tag = f" [{tag}]" if tag else ""
    print(f"profile {name} wall_ms {wall:.4g} device_ms {dev_ms:.4g} "
          f"busy {res['busy']:.3f} hand-written kernels "
          f"{res['hand_written_ms']:.4g} ms{tag}", flush=True)
    print(f"profile {name} by class " + ", ".join(
        f"{c} {v:.4g} ms" for c, v in sorted(classes.items(),
                                              key=lambda kv: -kv[1]))
          + tag, flush=True)
    for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
        print(f"profile {name}   ours {v:.4g} ms  {k[:90]}{tag}", flush=True)
    for k, v in top:
        print(f"profile {name}   {v:.4g} ms  {k[:90]}{tag}", flush=True)
    return res
def profile_steps(runner, pool, dev, prefill_len: int = 1000,
                  ctx: int = 512, tag: str = "") -> dict:
    """One prefill of ``prefill_len`` tokens and one decode step at batch
    16 over ``ctx`` tokens of context each, under torch.profiler."""
    from ray_tpu_torch.serve.llm.model_runner import _bucket
    rng = np.random.default_rng(SEED + 1)
    V, maxb = runner.vocab, runner.cfg.max_blocks_per_seq
    tables = rng.integers(0, pool.shape[0], (16, maxb)).astype(np.int32)
    lens = np.full(16, ctx, np.int32)
    bucket = _bucket(prefill_len, runner.cfg.prefill_len_buckets)
    steps = {
        f"prefill_{bucket}": lambda: runner.prefill(
            rng.integers(0, V, prefill_len).tolist()),
        f"decode_b16_ctx{ctx}": lambda: runner.decode(
            rng.integers(0, V, 16).astype(np.int32), lens, pool, tables,
            lens),
    }
    out = {}
    for name, fn in steps.items():
        fn()
        out[name] = profile_once(name, fn, tag)
    return out


# ----------------------------------------------------------------- engine
def gpt2_engine(block_scale: float = ENGINE_BLOCK_SCALE) -> dict:
    """GPT-2 124M behind the engine: what ``engine_phase`` serves."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import layer_norm as ln
    from ray_tpu_torch.serve.llm import EngineConfig
    return dict(
        label="engine",
        cfg=EngineConfig(model="gpt2:gpt2-124m", block_size=16,
                         num_blocks=1100, max_num_seqs=16,
                         max_model_len=1024, max_prefill_tokens=1024,
                         prefill_len_buckets=(64, 128, 256, 512, 1024),
                         decode_batch_buckets=(1, 2, 4, 8, 16),
                         share_weights=False, seed=SEED),
        gen_device="cpu", blocks=BLOCK_MATRICES, block_scale=block_scale,
        tol=ENGINE_LOGIT_TOL, warm=(40, 100, 200, 400, 900),
        prompt_lens=(32, 961),
        on_path={"layer_norm_fwd": (ln, "launches"),
                 "flash_attention_fwd": (fa, "launches")},
        off_path={"layer_norm_fwd_scalar": (ln, "scalar_launches"),
                  "flash_attention_fwd_f32": (fa, "f32_launches"),
                  "flash_attention_fwd_gqa_d128": (fa, "d128_launches")},
        per_forward=None, profile=(1000, 512))


def llama_engine(block_scale: float = LLAMA_ENGINE_BLOCK_SCALE) -> dict:
    """Llama-3 8B behind the engine, at full width and depth: what
    ``engine_phase`` serves after GPT-2."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import EngineConfig
    return dict(
        label="llama_engine",
        cfg=EngineConfig(model="llama:llama3-8b", block_size=16,
                         num_blocks=LLAMA_NUM_BLOCKS, max_num_seqs=16,
                         max_model_len=2048, max_prefill_tokens=2048,
                         prefill_len_buckets=(64, 128, 256, 512, 1024,
                                              2048),
                         decode_batch_buckets=(1, 2, 4, 8, 16),
                         share_weights=False, seed=SEED),
        gen_device="cuda", blocks=LLAMA_BLOCK_MATRICES,
        block_scale=block_scale, tol=LLAMA_ENGINE_LOGIT_TOL,
        warm=(40, 100, 200, 400, 900, 1900),
        prompt_lens=(32, 1985),
        on_path={"flash_attention_fwd_gqa_d128": (fa, "d128_launches")},
        off_path={"flash_attention_fwd_f32": (fa, "f32_launches"),
                  "flash_attention_fwd": (fa, "launches")},
        # one D = 128 flash launch a layer, per prefill step and per
        # full forward
        per_forward={"flash_attention_fwd_gqa_d128": "n_layer"},
        profile=(2000, 1024))


def engine_phase(dev, spec: Optional[dict] = None, tag: str = "") -> dict:
    """Serve ``spec``'s model (default GPT-2 124M) through ``LLMEngine``:
    16 concurrent greedy requests of 32 tokens, every request checked, the
    kernels' launches counted, the engine's logits held to the
    teacher-forced full ``forward``, then each planted fault in ``FAULTS``
    required to fail that check.  Frees the weights and the pool before it
    returns."""
    import gc
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.config import resolve_model
    from ray_tpu_torch.serve.llm.model_runner import ModelRunner

    spec = spec or gpt2_engine()
    label, cfg, tol = spec["label"], spec["cfg"], spec["tol"]
    check = spec.get("check", True)       # False only in llama_sweep
    block_scale = spec["block_scale"]
    t0 = time.perf_counter()
    mod, mcfg = resolve_model(cfg)
    per_forward = {k: getattr(mcfg, v) for k, v in
                   (spec["per_forward"] or {}).items()}
    gen = torch.Generator(device=spec["gen_device"]).manual_seed(SEED)
    params = mod.init_params(gen, mcfg, device=dev)
    for name in spec["blocks"]:
        params["blocks"][name]["kernel"].mul_(block_scale)
    eng = LLMEngine(cfg, params, start=False, device=dev)
    torch.cuda.synchronize()
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

    def logits_err(streams, prompts, outs) -> tuple:
        """Teacher-force each request's output through the full forward:
        the largest difference from the logits the engine sampled, over
        all of them, and over the first (prefill's) and the rest
        (decode's) apart."""
        errs = []
        with torch.no_grad():
            for s, p, o in zip(streams, prompts, outs):
                full = torch.tensor([p + o[:-1]], device=dev)
                ref = mod.forward(runner.params, full,
                                  runner.mcfg)[0, len(p) - 1:]
                got = np.stack(rec["logits"][s.seq_id])
                if got.shape != tuple(ref.shape) or \
                        not np.isfinite(got).all():
                    fail(f"{label} logits {got.shape} vs "
                         f"{tuple(ref.shape)}")
                errs.append(np.abs(got - ref.cpu().numpy()).max(axis=1))
        errs = np.stack(errs)                       # (requests, tokens)
        return (float(errs.max()), float(errs[:, 0].max()),
                float(errs[:, 1:].max()) if errs.shape[1] > 1 else 0.0)

    counters = {**spec["on_path"], **spec["off_path"]}

    def counts() -> dict:
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    runner.sample, eng._emit = sample, record_emit
    runner.prefill, runner.decode = timed_prefill, timed_decode
    eng.start()
    try:
        V = runner.vocab
        rng = np.random.default_rng(SEED)
        # warm-up: one short request per prefill bucket
        for n in spec["warm"]:
            eng.generate(rng.integers(0, V, n).tolist(),
                         SamplingParams(max_tokens=2))
        lens = rng.integers(*spec["prompt_lens"], size=16)
        prompts = [rng.integers(0, V, int(n)).tolist() for n in lens]
        for m, a in counters.values():
            setattr(m, a, 0)
        streams, outs, t_sub, wall = serve(prompts,
                                           SamplingParams(max_tokens=32))
        got = counts()
        launches = {k: got[k] for k in spec["on_path"]}
        # instantiations this path must not take
        off_path = {k: got[k] for k in spec["off_path"]}
        stats = eng.stats()
        timing = dict(emit_at=dict(rec["emit_at"]),
                      prefill=list(rec["prefill"]), decode=list(rec["decode"]))
        for p, o in zip(prompts, outs):
            if len(o) != 32 or not all(0 <= t < V for t in o):
                fail(f"request of {len(p)} tokens returned {o}")
        print(f"{label} launches {launches} off the bf16 path {off_path}",
              flush=True)
        for k, n in launches.items():
            if n <= 0:
                fail(f"{k} was not launched on the {label}'s path")
        for k, n in off_path.items():
            if n:
                fail(f"{k} ran {n} times on the {label}'s bf16 path")
        n_prefill = len(timing["prefill"])
        for k, per in per_forward.items():
            if launches[k] != per * n_prefill:
                fail(f"{k}: {launches[k]} launches in {n_prefill} prefill "
                     f"steps, expected {per} a step")
        before = counts()
        max_err, prefill_err, decode_err = logits_err(streams, prompts, outs)
        forced = {k: v - before[k] for k, v in counts().items()}
        for k, per in per_forward.items():
            print(f"{label} {k} {per} a prefill step ({launches[k]} in "
                  f"{n_prefill}), {forced[k]} in {len(streams)} full "
                  f"forwards", flush=True)
            if forced[k] != per * len(streams):
                fail(f"{k}: {forced[k]} launches in {len(streams)} full "
                     f"forwards, expected {per} a forward")
        print(f"{label} logits_max_abs_err {max_err:.6g} tol {tol} "
              f"(block matrices x{block_scale}; first tokens "
              f"{prefill_err:.6g}, decoded tokens {decode_err:.6g})",
              flush=True)
        if check and max_err > tol:
            fail(f"{label} logits disagree with the full forward")
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
            controls[fname] = logits_err(c_streams, prompts[:4], c_outs)[0]
            print(f"{label} control {fname} logits_max_abs_err "
                  f"{controls[fname]:.6g} (must exceed {tol})", flush=True)
            if check and controls[fname] <= tol:
                fail(f"planted fault {fname} passed the {label} check")
        ttft = sorted(timing["emit_at"][s.seq_id][0] - t_sub
                      for s in streams)
        gaps = sorted(np.concatenate(
            [np.diff(timing["emit_at"][s.seq_id]) for s in streams]))
        pf_tok = sum(n for n, _ in timing["prefill"])
        pf_s = sum(t for _, t in timing["prefill"])
        dc_tok = sum(n for n, _ in timing["decode"])
        dc_s = sum(t for _, t in timing["decode"])
        res = dict(setup_s=setup_s, block_scale=block_scale,
                   n_layer=mcfg.n_layer, wall_s=wall,
                   stats=stats, prefill_tok_s=pf_tok / pf_s,
                   prefill_steps=n_prefill,
                   decode_tok_s=dc_tok / dc_s,
                   decode_steps=len(timing["decode"]),
                   decode_step_ms=1e3 * dc_s / len(timing["decode"]),
                   ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
                   ttft_max_ms=1e3 * ttft[-1],
                   tpot_p50_ms=1e3 * gaps[len(gaps) // 2],
                   tpot_max_ms=1e3 * gaps[-1],
                   output_tok_s=16 * 32 / wall, distinct_tokens=distinct,
                   logits_max_abs_err=max_err,
                   logits_prefill_max_abs_err=prefill_err,
                   logits_decode_max_abs_err=decode_err, logits_tol=tol,
                   control_logits_max_abs_err=controls, launches=launches)
        sfx = f" [{tag}]" if tag else ""
        for k, val in res.items():
            print(f"{label} {k} {val}{sfx}", flush=True)
        if spec["profile"]:
            res["profile"] = profile_steps(runner, eng.cache.pool, dev,
                                           *spec["profile"], tag)
        return res
    finally:
        eng.shutdown()            # closes the pool
        runner.params = None
        del params
        gc.collect()              # the engine's hooks form a cycle
        torch.cuda.empty_cache()


def llama_sweep(scales, tag: str = "") -> dict:
    """The Llama engine check at each block-matrix scale, printing the
    healthy error and the three planted faults without failing on them:
    the sweep that sets LLAMA_ENGINE_BLOCK_SCALE and
    LLAMA_ENGINE_LOGIT_TOL.  ``python3 -c 'import chip_smoke as c;
    c.llama_sweep((1, 2, 3))'`` on the card."""
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device
    _build.lib()
    disable_tf32()
    out = {}
    for s in scales:
        spec = dict(llama_engine(s), check=False, profile=None)
        r = engine_phase(resolve_device(None), spec, tag)
        out[s] = (r["logits_max_abs_err"], r["control_logits_max_abs_err"])
        print(f"llama_sweep x{s} healthy {out[s][0]:.6g} controls "
              f"{out[s][1]}", flush=True)
    return out


# ------------------------------------------------------------------ train
def leaf_grads(params, loss_of) -> tuple:
    """(loss, gradient of every param leaf) by plain autograd."""
    from ray_tpu_torch.parallel.transforms import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_of()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def leaf_tensors(params) -> list:
    from ray_tpu_torch.parallel.transforms import tree_leaves
    return tree_leaves(params)


def leaf_names(params) -> list:
    """Each leaf's path, in the order of ``leaf_tensors``."""
    from ray_tpu_torch.parallel.transforms import tree_leaves_with_path
    return [path for path, _ in tree_leaves_with_path(params)]


def grad_check(cfg, params, batch, block_scale: float = 1.0,
               tol: float = GRAD_REL_TOL, label: str = "train") -> tuple:
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
            params, batch, dataclasses.replace(cfg, attn_impl="dense",
                                               remat_policy="full")))
    finally:
        gpt2._layer_norm = kernel_ln
    ref_norms = [r.float().norm() for r in ref]
    prefix = label

    def errors(label: str) -> tuple:
        loss, got = leaf_grads(params, lambda: gpt2.loss_fn(
            params, batch, cfg))
        errs = [((g.float() - r.float()).norm() / n).item()
                for g, r, n in zip(got, ref, ref_norms)]
        order = sorted(range(len(errs)), key=lambda i: -errs[i])
        print(f"{prefix} grads x{block_scale} {label}: loss "
              f"{loss.item():.6f} (reference {ref_loss.item():.6f}) worst "
              f"leaf {names[order[0]]} rel_err {errs[order[0]]:.4g} (limit "
              f"{tol}); next "
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


def kernel_counters() -> dict:
    """Every kernel's launch counter, by the name the phases use."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import layer_norm as ln
    return {"layer_norm_fwd": (ln, "launches"),
            "layer_norm_bwd": (ln, "bwd_launches"),
            "layer_norm_fwd_wide": (ln, "wide_launches"),
            "layer_norm_bwd_wide": (ln, "bwd_wide_launches"),
            "layer_norm_fwd_scalar": (ln, "scalar_launches"),
            "layer_norm_bwd_scalar": (ln, "bwd_scalar_launches"),
            "flash_attention_fwd": (fa, "launches"),
            "flash_attention_bwd": (fa, "bwd_launches"),
            "flash_attention_fwd_gqa_d128": (fa, "d128_launches"),
            "flash_attention_bwd_gqa_d128": (fa, "d128_bwd_launches"),
            "flash_attention_fwd_f32": (fa, "f32_launches"),
            "flash_attention_bwd_f32": (fa, "f32_bwd_launches")}


def train_steps(label: str, prog, state, batch, per_step: dict,
                tokens: int) -> tuple:
    """The main path of a train phase: TRAIN_STEPS steps of ``prog`` on one
    batch with host syncs made errors.  Every counter is zeroed just
    before; each step must launch exactly ``per_step`` (the kernels it
    leaves out, 0 times); the loss must be finite and fall, and the step
    count match.  Returns (state, the run's numbers)."""
    counters = kernel_counters()

    def counts() -> dict:
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    per_step = {k: per_step.get(k, 0) for k in counters}
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
    print(f"{label} launches {launches} per step {step_counts[-1]} "
          f"(expected per step {per_step})", flush=True)
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"non-finite loss or grad norm in {label}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if int(state.step.item()) != TRAIN_STEPS:
        fail(f"{label}: state.step is {int(state.step.item())}, not "
             f"{TRAIN_STEPS}")
    for c in step_counts:
        if c != per_step:
            fail(f"{label}: launches per step {c}, expected {per_step}")
    step_ms = 1e3 * sum(step_s[1:]) / (len(step_s) - 1)
    return state, dict(losses=losses, grad_norms=gnorms,
                       step_ms_each=[1e3 * t for t in step_s],
                       step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                       peak_mem_gb=peak_gb, launches=launches,
                       launches_per_step=step_counts[-1])


def train_phase(dev, card, tag: str) -> dict:
    from ray_tpu_torch.models import gpt2
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

    # -- the main path: six steps on one batch, no host sync inside a
    # step; the scalar-I/O LayerNorm (aligned bf16 rows), float32 flash
    # (bf16 activations) and head-dim-128 kernels launch 0 times
    state, run = train_steps("train", prog, state, batch, {
        "layer_norm_fwd": 2 * L + 1 + 2 * L,   # forward + replay
        "layer_norm_bwd": 2 * L + 1,
        "flash_attention_fwd": L + L,
        "flash_attention_bwd": L}, B * T)
    res = dict(setup_s=setup_s, grad_rel_err=worst, grad_worst_leaf=worst_leaf,
               grad_rel_tol=GRAD_REL_TOL, grad_controls=controls, **run,
               model_flop_share=gpt2.flops_per_token(cfg, T)
               * run["tokens_per_s"] / card[1])
    for k, val in res.items():
        print(f"train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "train_step", lambda: prog.step_fn(state, batch), tag)
    return res


def llama_flops_per_token(cfg, seq_len: int) -> float:
    """Model FLOPs a trained token: 6 x the params that enter matrix
    products (every block matrix and the LM head; the embedding is a
    gather) + 12 L E T for attention's two products, forward and
    backward, as GPT-2's flops_per_token counts them."""
    E, L, FF = cfg.n_embd, cfg.n_layer, cfg.ffn_dim
    kv = cfg.n_kv_head * cfg.head_dim
    n = L * (2 * E * E + 2 * E * kv + 3 * E * FF) + E * cfg.vocab_size
    return 6 * n + 12 * L * E * seq_len


def llama_grad_check(cfg, params, batch, block_scale: float = 1.0,
                     ref_dtype: Optional[torch.dtype] = None) -> tuple:
    """Step-0 gradients of every leaf on the kernel path (flash forward
    and backward at head dim 128 with GQA) against plain autograd through
    dense attention on K/V expanded as the reference's _gqa_expand, on the
    same card, at the same params with the block matrices scaled by
    ``block_scale``, its activations in ``ref_dtype`` (default the
    config's); then the same with each planted fault.  Returns (worst
    healthy relative L2 error, its leaf, {fault: worst relative error});
    fails only on a non-finite loss."""
    import dataclasses
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa
    names = leaf_names(params)
    if block_scale != 1.0:
        params = {**params, "blocks": {
            k: ({**v, "kernel": v["kernel"] * block_scale}
                if k in LLAMA_BLOCK_MATRICES else v)
            for k, v in params["blocks"].items()}}
    ref_cfg = dataclasses.replace(cfg, attn_impl="dense",
                                  dtype=ref_dtype or cfg.dtype)
    ref_loss, ref = leaf_grads(params, lambda: llama.loss_fn(
        params, batch, ref_cfg))
    ref_norms = [r.float().norm() for r in ref]

    def errors(label: str) -> tuple:
        loss, got = leaf_grads(params, lambda: llama.loss_fn(
            params, batch, cfg))
        errs = [((g.float() - r.float()).norm() / n).item()
                for g, r, n in zip(got, ref, ref_norms)]
        del got
        order = sorted(range(len(errs)), key=lambda i: -errs[i])
        print(f"llama_train grads x{block_scale} ref {ref_cfg.dtype} "
              f"{label}: loss "
              f"{loss.item():.6f} (reference {ref_loss.item():.6f}) worst "
              f"leaf {names[order[0]]} rel_err {errs[order[0]]:.4g} (limit "
              f"{LLAMA_GRAD_REL_TOL}); next "
              + ", ".join(f"{names[i]} {errs[i]:.3g}" for i in order[1:4]),
              flush=True)
        if not math.isfinite(loss.item()):
            fail(f"non-finite loss in the Llama gradient check ({label})")
        return errs[order[0]], names[order[0]]

    worst, worst_leaf = errors("healthy")
    controls = {}
    orig = fa.flash_attention_bwd
    for fname, plant in LLAMA_GRAD_FAULTS.items():
        fa.flash_attention_bwd = plant(orig)
        try:
            controls[fname] = errors(f"control {fname}")[0]
        finally:
            fa.flash_attention_bwd = orig
    return worst, worst_leaf, controls


def llama_grad_sweep(scales=(1.0, 2.0, 4.0), tag: str = "") -> dict:
    """The Llama gradient check at each block-matrix scale, against the
    bf16 reference and against a float32 one, printing the healthy error
    and the planted faults without failing on them: the sweep behind
    LLAMA_GRAD_REL_TOL.  ``python3 -c 'import chip_smoke as c;
    c.llama_grad_sweep()'`` on the card."""
    import dataclasses
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device
    from ray_tpu_torch.models import llama
    _build.lib()
    disable_tf32()
    dev = resolve_device(None)
    cfg = dataclasses.replace(llama.llama3_8b(), n_layer=LLAMA_TRAIN_LAYERS)
    B, T = LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T + 1))).to(dev)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    params = llama.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    out = {}
    for scale in scales:
        for ref_dtype in (None, torch.float32):
            r = llama_grad_check(cfg, params, batch, scale, ref_dtype)
            out[(scale, str(ref_dtype or cfg.dtype))] = r
            print(f"llama_grad_sweep x{scale} ref {ref_dtype or cfg.dtype} "
                  f"healthy {r[0]:.4g} ({r[1]}) controls {r[2]} [{tag}]",
                  flush=True)
    return out


def llama_train_phase(dev, card, tag: str) -> dict:
    """Llama-3 8B's width at LLAMA_TRAIN_LAYERS layers through
    spmd.build_train_program: the step-0 gradient check with its planted
    faults, then six steps on one batch with host syncs made errors, the
    exact kernel launches per step, the falling loss, the step time and
    one profiled step."""
    import dataclasses
    import gc
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = dataclasses.replace(llama.llama3_8b(), n_layer=LLAMA_TRAIN_LAYERS)
    assert cfg.remat and cfg.dtype == torch.bfloat16
    B, T, L = LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ, cfg.n_layer
    def count(c) -> int:
        return sum(t.numel() for t in leaf_tensors(
            llama.init_params(None, c, device="meta")))

    n_params = count(cfg)
    state_gb = n_params * 4 * 4 / 1e9        # f32 params, grads, mu, nu
    logits_gb = B * T * cfg.vocab_size * 4 / 1e9
    # a replayed block's bf16 activations: ~8 of width E (x, the normed
    # x, q, rotated q, attention out, its projection, ...) and 4 of width
    # FF (gate, up, silu, product), and ~4 float32 ones of width E
    # (RMSNorm and RoPE work in float32)
    block_gb = B * T * (8 * cfg.n_embd * 2 + 4 * cfg.ffn_dim * 2
                        + 4 * cfg.n_embd * 4) / 1e9
    reckoned_gb = state_gb + 3 * logits_gb + block_gb
    print(f"llama_train depth reduced to {L} of the preset's 32 layers, at "
          f"full width (E {cfg.n_embd}, {cfg.n_head}/{cfg.n_kv_head} heads "
          f"of {cfg.head_dim}, SwiGLU {cfg.ffn_dim}, V {cfg.vocab_size}): "
          f"the preset's f32 params, grads and two AdamW moments are "
          f"{count(llama.llama3_8b()) * 16 / 1e9:.1f} GB, past one 80 GB "
          f"card; here {n_params / 1e9:.3f} B params, state "
          f"{state_gb:.1f} GB; each f32 ({B * T} x {cfg.vocab_size}) logits "
          f"tensor, its log-softmax and their gradients {logits_gb:.2f} GB; "
          f"a replayed block ~{block_gb:.2f} GB; peak reckoned at state + "
          f"3 logits-sized tensors + a block: {reckoned_gb:.1f} GB "
          f"[{tag}]", flush=True)
    t0 = time.perf_counter()
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    host_batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    prog = spmd.build_train_program(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        init_params_fn=lambda g: llama.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    batch = spmd.shard_batch(prog, host_batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- step-0 gradients of the program's own params against an
    # independent reference, beside the optimizer state
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    worst, worst_leaf, controls = llama_grad_check(cfg, state.params, batch)
    check_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    if worst > LLAMA_GRAD_REL_TOL:
        fail("Llama step-0 gradients disagree with the independent "
             "reference")
    for fname, err in controls.items():
        if err <= LLAMA_GRAD_REL_TOL:
            fail(f"planted fault {fname} passed the Llama gradient check")
    check_s = time.perf_counter() - t0

    # -- the main path: six steps on one batch, no host sync inside a
    # step; the head-dim-128 flash kernels only
    state, run = train_steps("llama_train", prog, state, batch, {
        "flash_attention_fwd_gqa_d128": L + L,   # forward + replay
        "flash_attention_bwd_gqa_d128": L}, B * T)
    res = dict(n_layer=L, n_params=n_params, state_gb=state_gb,
               reckoned_peak_gb=reckoned_gb, setup_s=setup_s,
               grad_check_batch=B, grad_check_s=check_s,
               grad_check_peak_mem_gb=check_peak_gb,
               grad_rel_err=worst, grad_worst_leaf=worst_leaf,
               grad_rel_tol=LLAMA_GRAD_REL_TOL, grad_controls=controls,
               **run, flops_per_token=llama_flops_per_token(cfg, T),
               model_flop_share=llama_flops_per_token(cfg, T)
               * run["tokens_per_s"] / card[1])
    for k, val in res.items():
        print(f"llama_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "llama_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# The xl train phase: bench.py's BASELINE #5 recipe (_run_xl): GPT-2 xl
# at full width and depth (E 1600, 48 layers, 25 heads of 64), remat
# "attn", bf16 params and bf16 Adam moments, batch 8 x seq 1024.  The
# schedule is the other train phases' (lr 3e-4 from the second step):
# bench.py's default warmup of 100 steps moves a bf16 param by less than
# half its step in 6 steps, so the loss could not fall.
XL_POLICIES = ("full", "dots", "attn", "attn_qkv")
# The gradient check at xl's full width and XL_GRAD_LAYERS of its 48
# layers, against plain autograd through dense attention and the plain
# LayerNorm (grad_check), the worst leaf's relative L2 error.
XL_GRAD_LAYERS = 2
XL_GRAD_REL_TOL = 0.05


def xl_config():
    import dataclasses
    from ray_tpu_torch.models import gpt2
    return dataclasses.replace(gpt2.gpt2_xl(), remat_policy="attn",
                               param_dtype=torch.bfloat16)


def xl_batch(dev, vocab: int) -> dict:
    """One batch of b8 x s1024 tokens from the full vocabulary, seed 0, as
    int64 tensors on ``dev`` (what spmd.shard_batch gives)."""
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, vocab, (XL_TRAIN_BATCH, XL_TRAIN_SEQ + 1))).to(dev)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def xl_grad_params(dev, cfg):
    """xl's width at XL_GRAD_LAYERS layers: (config, params) for the
    gradient check."""
    import dataclasses
    from ray_tpu_torch.models import gpt2
    cfg = dataclasses.replace(cfg, n_layer=XL_GRAD_LAYERS)
    return cfg, gpt2.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)


def xl_grad_sweep(scales=(1.0, 2.0, 4.0), tag: str = "") -> dict:
    """The xl gradient check at each block-matrix scale, printing the
    healthy error and the planted faults without failing on them: the
    sweep behind XL_GRAD_REL_TOL.  ``python3 -c 'import chip_smoke as c;
    c.xl_grad_sweep()'`` on the card."""
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device
    _build.lib()
    disable_tf32()
    dev = resolve_device(None)
    cfg, params = xl_grad_params(dev, xl_config())
    batch = xl_batch(dev, cfg.vocab_size)
    out = {}
    for scale in scales:
        out[scale] = grad_check(cfg, params, batch, scale, XL_GRAD_REL_TOL,
                                "xl_sweep")
        print(f"xl_grad_sweep x{scale} healthy {out[scale][0]:.4g} "
              f"({out[scale][1]}) controls {out[scale][2]} [{tag}]",
              flush=True)
    return out


def xl_policy_check(cfg, params, batch, tag: str) -> dict:
    """Step-0 gradients of ``params`` under each remat policy: every leaf
    must equal full remat's bitwise (the kernels are deterministic and a
    replay repeats the same arithmetic, so the limit is 0).  Each
    policy's flash forward launches show what its backward replays: 2L
    under full and dots, L (none replayed) under attn and attn_qkv.
    Prints each policy's wall ms (host clock, synchronized; the second of
    two runs, so that the allocator holds the policy's memory) and peak
    memory."""
    import dataclasses
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    L = cfg.n_layer
    names = leaf_names(params)
    ref, out = None, {}
    for pol in XL_POLICIES:
        c = dataclasses.replace(cfg, remat_policy=pol)
        gc.collect()
        torch.cuda.empty_cache()
        leaf_grads(params, lambda: gpt2.loss_fn(params, batch, c))
        torch.cuda.reset_peak_memory_stats()
        before = fa.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = leaf_grads(params, lambda: gpt2.loss_fn(params, batch,
                                                              c))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        fwd = fa.launches - before
        peak = torch.cuda.max_memory_allocated() / 1e9
        if ref is None:
            ref, ref_loss = grads, loss
        equal = [torch.equal(a, b) for a, b in zip(grads, ref)]
        errs = [((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30)).item()
                for a, b in zip(grads, ref)]
        worst = max(range(len(errs)), key=lambda i: errs[i])
        want_fwd = L if pol in ("attn", "attn_qkv") else 2 * L
        out[pol] = dict(ms=ms, peak_mem_gb=peak, flash_fwd_launches=fwd,
                        bitwise_equal_to_full=all(equal),
                        loss_equal_to_full=torch.equal(loss, ref_loss),
                        worst_rel_err=errs[worst], worst_leaf=names[worst])
        print(f"xl_policy {pol} grads_ms {ms:.1f} peak_mem_gb {peak:.2f} "
              f"flash_fwd_launches {fwd} (expected {want_fwd}: the replay "
              f"{'skips' if fwd == L else 'reruns'} the flash forward) "
              f"bitwise_equal_to_full {all(equal)} ({sum(equal)} of "
              f"{len(equal)} leaves; worst {names[worst]} rel_err "
              f"{errs[worst]:.3g}, limit 0) loss {loss.item():.6f} "
              f"[{tag}]", flush=True)
        del grads
        if pol in ("full", "attn"):
            # the device's busy share: what a policy costs on the host
            out[pol]["busy"] = profile_once(
                f"xl_grads_{pol}", lambda: leaf_grads(
                    params, lambda: gpt2.loss_fn(params, batch, c)),
                tag)["busy"]
        if fwd != want_fwd:
            fail(f"xl remat_policy={pol!r}: {fwd} flash forward launches, "
                 f"expected {want_fwd}")
    del ref
    bad = [p for p, r in out.items()
           if not (r["bitwise_equal_to_full"] and r["loss_equal_to_full"])]
    if bad:
        fail(f"xl step-0 gradients under {bad} differ from full remat's")
    return out


def xl_train_phase(dev, card, tag: str) -> dict:
    """bench.py's GPT-2-1.5B recipe through spmd.build_train_program at
    full width and depth: the remat-policy check and the gradient check at
    XL_GRAD_LAYERS layers, then six steps on one batch with host syncs
    made errors, the exact kernel launches per step (the wide-row
    LayerNorm, the head-dim-64 flash kernels, nothing else), the falling
    loss, the step time and one profiled step."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import spmd

    cfg = xl_config()
    B, T, L = XL_TRAIN_BATCH, XL_TRAIN_SEQ, cfg.n_layer
    n_params = gpt2.param_count_analytic(cfg)
    state_gb = n_params * 2 * 4 / 1e9   # bf16 params, grads, mu, nu
    fpt = gpt2.flops_per_token(cfg, T)
    print(f"xl_train config E {cfg.n_embd} L {L} H {cfg.n_head}x"
          f"{cfg.head_dim} V {cfg.vocab_size} (gpt2_xl, full width and "
          f"depth) remat {cfg.remat_policy} params {cfg.param_dtype} "
          f"moments bf16 batch {B}x{T}: {n_params / 1e9:.4f} B params, "
          f"state {state_gb:.2f} GB; {fpt / 1e9:.2f} GFLOP a token, "
          f"{fpt * B * T / 1e12:.1f} TFLOP a step, "
          f"{fpt * B * T / card[1] * 1e3:.1f} ms at the peak [{tag}]",
          flush=True)
    t0 = time.perf_counter()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: gpt2.loss_fn(p, b, cfg),
        init_params_fn=lambda g: gpt2.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000,
                                         moments_dtype=torch.bfloat16),
        device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    batch = xl_batch(dev, cfg.vocab_size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- every policy's step-0 gradients, bitwise those of full remat
    policies = xl_policy_check(cfg, state.params, batch, tag)
    gc.collect()
    torch.cuda.empty_cache()

    # -- step-0 gradients at reduced depth against an independent
    # reference, with two planted faults
    t0 = time.perf_counter()
    gcfg, gparams = xl_grad_params(dev, cfg)
    worst, worst_leaf, controls = grad_check(gcfg, gparams, batch, 1.0,
                                             XL_GRAD_REL_TOL, "xl_train")
    del gparams
    gc.collect()
    torch.cuda.empty_cache()
    if worst > XL_GRAD_REL_TOL:
        fail("xl step-0 gradients disagree with the independent reference")
    for fname, err in controls.items():
        if err <= XL_GRAD_REL_TOL:
            fail(f"planted fault {fname} passed the xl gradient check")
    check_s = time.perf_counter() - t0

    # -- the main path: six steps on one batch, no host sync inside a
    # step; every LayerNorm on the wide-row kernels (forward and the
    # replay's), the flash forward once a layer (the replay takes the
    # saved out and lse), the flash backward once a layer
    state, run = train_steps("xl_train", prog, state, batch, {
        "layer_norm_fwd_wide": 2 * L + 1 + 2 * L,
        "layer_norm_bwd_wide": 2 * L + 1,
        "flash_attention_fwd": L,
        "flash_attention_bwd": L}, B * T)
    res = dict(n_params=n_params, state_gb=state_gb, setup_s=setup_s,
               policies=policies, grad_layers=XL_GRAD_LAYERS,
               grad_check_s=check_s, grad_rel_err=worst,
               grad_worst_leaf=worst_leaf, grad_rel_tol=XL_GRAD_REL_TOL,
               grad_controls=controls, **run, flops_per_token=fpt,
               model_flop_share=fpt * run["tokens_per_s"] / card[1])
    for k, val in res.items():
        print(f"xl_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "xl_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# The MoE train phase: moe-small at full width and depth (E 768, 12
# layers, 8 experts, top-2, ff 3072; 0.52 B params, f32 with f32 AdamW
# moments), remat on, batch 8 x seq 1024, the GPT-2 train phase's
# optimizer.  The kernel path (the LayerNorm kernels, the index-form
# dispatch) is held to the plain path (the plain LayerNorm, the
# reference's einsum dispatch) on the same card: the top-k routing of
# every layer is compared first, then the loss, dropped fraction and
# gradients with the plain path's routing held to the kernel path's (a
# one-ulp LayerNorm difference may flip a near-tie, which would move a
# token to another expert).  Limit: the worst leaf's relative L2 error,
# bf16 activations through 12 layers as GPT-2's check (its healthy
# error 0.0137 under the same 0.05).
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 1024
MOE_GRAD_REL_TOL = 0.05


def moe_flops_per_token(cfg, seq_len: int) -> float:
    """Model FLOPs a trained token: 6 x the params a token's products use
    (the attention projections, the router, its top-k experts, the LM
    head) + 12 L E T for attention, as GPT-2's flops_per_token counts."""
    E, L = cfg.n_embd, cfg.n_layer
    per_layer = 4 * E * E + E * cfg.num_experts \
        + cfg.top_k * 2 * E * cfg.expert_ff
    return 6 * (L * per_layer + E * cfg.vocab_size) + 12 * L * E * seq_len


def moe_plain_check(cfg, params, batch, tag: str) -> dict:
    """The kernel path's step-0 loss, gradients, routing and dropped
    fraction against the plain path's (see MOE_GRAD_REL_TOL)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models import moe_transformer as mt
    from ray_tpu_torch.ops import layer_norm as ln
    from ray_tpu_torch.ops import moe
    names = leaf_names(params)
    router, ffn, kernel_ln = moe.topk_router, moe.moe_ffn, gpt2._layer_norm
    routes = []

    def recording(x, w, k):
        out = router(x, w, k)
        routes.append(out[2])
        return out

    def run(plain: bool, held=None) -> tuple:
        """(loss, grads, dropped fraction, top-k indices by call)."""
        routes.clear()
        calls = iter(held or ())

        def held_router(x, w, k):
            logits = x.float() @ w.float()
            probs = torch.softmax(logits, dim=-1)
            idx = next(calls)
            gates = torch.zeros_like(probs).scatter(-1, idx,
                                                    probs.gather(-1, idx))
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            routes.append(idx)
            return gates, logits, idx

        moe.topk_router = held_router if held is not None else recording
        if plain:
            gpt2._layer_norm = ln.layer_norm_plain
            moe.moe_ffn = moe.moe_ffn_plain
        try:
            with torch.no_grad():
                _, m = mt.forward(params, batch["inputs"], cfg)
            fwd_routes = list(routes)
            routes.clear()
            calls = iter(held or ())
            loss, grads = leaf_grads(params, lambda: mt.loss_fn(params,
                                                                batch, cfg))
        finally:
            moe.topk_router, moe.moe_ffn = router, ffn
            gpt2._layer_norm = kernel_ln
        return loss, grads, m["moe_fraction_dropped"].item(), \
            fwd_routes, list(routes)

    k_loss, k_grads, k_drop, k_fwd, k_routes = run(False)
    _, _, p_drop, p_fwd, _ = run(True)
    differ = sum(int((a != b).sum().item()) for a, b in zip(k_fwd, p_fwd))
    total = sum(a.numel() for a in k_fwd)
    h_loss, h_grads, h_drop, _, _ = run(True, held=k_routes)
    ref_norms = [r.float().norm().clamp_min(1e-30) for r in h_grads]
    errs = [((g.float() - r.float()).norm() / n).item()
            for g, r, n in zip(k_grads, h_grads, ref_norms)]
    order = sorted(range(len(errs)), key=lambda i: -errs[i])
    loss_err = abs(k_loss.item() - h_loss.item()) / abs(h_loss.item())
    # control: the kernel path with its LayerNorm backward fed rolled rstd
    # rows (GRAD_FAULTS' fault; its routing is the kernel path's own)
    bwd = ln.ln_bwd
    ln.ln_bwd = lambda x, s, g, mu, rstd: bwd(x, s, g, mu, rstd.roll(1, 0))
    try:
        _, c_grads, _, _, _ = run(False)
    finally:
        ln.ln_bwd = bwd
    control = max(((g.float() - r.float()).norm() / n).item()
                  for g, r, n in zip(c_grads, h_grads, ref_norms))
    del c_grads
    res = dict(routing_choices_differing=differ, routing_choices=total,
               dropped_fraction=k_drop, plain_dropped_fraction=p_drop,
               held_dropped_fraction=h_drop, loss=k_loss.item(),
               plain_loss=h_loss.item(), loss_rel_err=loss_err,
               grad_rel_err=errs[order[0]], grad_worst_leaf=names[order[0]],
               grad_rel_tol=MOE_GRAD_REL_TOL,
               grad_control_ln_bwd_rstd_rolled=control)
    print(f"moe_train plain check: top-k choices differing {differ} of "
          f"{total} (plain path's own routing); dropped fraction "
          f"{k_drop:.6g} (plain {p_drop:.6g}, routing held "
          f"{h_drop:.6g}); routing held: loss {k_loss.item():.6f} vs "
          f"{h_loss.item():.6f} (rel {loss_err:.3g}), worst leaf "
          f"{names[order[0]]} rel_err {errs[order[0]]:.4g} (limit "
          f"{MOE_GRAD_REL_TOL}); next "
          + ", ".join(f"{names[i]} {errs[i]:.3g}" for i in order[1:4])
          + f"; control ln_bwd_rstd_rolled {control:.4g} (must fail) "
          f"[{tag}]", flush=True)
    if control <= MOE_GRAD_REL_TOL:
        fail("the planted LayerNorm backward fault passed the MoE check")
    if not math.isfinite(k_loss.item()):
        fail("non-finite loss in the MoE check")
    if h_drop != k_drop:
        fail("the MoE dropped fraction differs from the plain path's with "
             "the routing held")
    if errs[order[0]] > MOE_GRAD_REL_TOL or loss_err > MOE_GRAD_REL_TOL:
        fail("MoE step-0 gradients disagree with the plain path")
    return res


def moe_train_phase(dev, card, tag: str) -> dict:
    """moe-small through spmd.build_train_program: the plain-path check,
    then six steps on one batch with host syncs made errors, the exact
    LayerNorm launches per step and no flash launch, the falling loss,
    the step time and one profiled step."""
    from ray_tpu_torch.models import moe_transformer as mt
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel import spmd

    cfg = mt.moe_small()
    B, T, L = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, cfg.n_layer
    n_params = sum(t.numel() for t in leaf_tensors(
        mt.init_params(None, cfg, device="meta")))
    fpt = moe_flops_per_token(cfg, T)
    cap = moe.expert_capacity(B * T, cfg.num_experts, cfg.top_k,
                              cfg.capacity_factor)
    print(f"moe_train config moe-small E {cfg.n_embd} L {L} experts "
          f"{cfg.num_experts} top-{cfg.top_k} ff {cfg.expert_ff} (full "
          f"width and depth) batch {B}x{T}: {n_params / 1e9:.4f} B params, "
          f"f32 state {n_params * 16 / 1e9:.2f} GB; capacity {cap} slots "
          f"an expert; {fpt / 1e9:.3f} GFLOP a token (top-{cfg.top_k} "
          f"experts) [{tag}]", flush=True)
    t0 = time.perf_counter()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: mt.loss_fn(p, b, cfg),
        init_params_fn=lambda g: mt.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = spmd.shard_batch(prog, {"inputs": toks[:, :-1],
                                    "targets": toks[:, 1:]})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check = moe_plain_check(cfg, state.params, batch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    # -- the main path: the vector LayerNorm kernels (forward, the
    # replay's and backward), no flash kernel (dense attention, as the
    # reference)
    state, run = train_steps("moe_train", prog, state, batch, {
        "layer_norm_fwd": 2 * L + 1 + 2 * L,
        "layer_norm_bwd": 2 * L + 1}, B * T)
    res = dict(n_params=n_params, setup_s=setup_s, check_s=check_s,
               **check, **run, flops_per_token=fpt,
               model_flop_share=fpt * run["tokens_per_s"] / card[1])
    for k, val in res.items():
        print(f"moe_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "moe_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------- encoder and vision
# The check against the JAX package itself: tests/tiny_reference.py ran
# each family's tiny preset through ray_tpu on the CPU in float32, with
# weights and inputs drawn by tiny_draw and tiny_inputs in the order of
# the reference's pytree, and wrote its outputs to TINY_REFERENCE.
# tiny_outputs draws the same numbers in the port's tree order and runs
# the port, float32 with TF32 off.
TINY_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "tiny_reference.json")
TINY_FAMILIES = ("resnet", "bert", "vit", "t5")
TINY_SEED = 0
TINY_T5_VOCAB_SLICE = 16
TINY_GRAD_LEAVES = {
    "resnet": ("head/bias", "stem/gn/scale", "stage1/0/gn_proj/bias"),
    "bert": ("cls/bias", "ln_emb/scale", "pooler/bias"),
    "vit": ("head/bias", "ln_f/scale", "cls_token"),
    "t5": ("enc_rel_bias", "dec_rel_bias", "enc_ln_f/scale"),
}
# Limits, each array's largest error over its largest magnitude: float32
# on both sides, sums in other orders.  The CPU tests hold these models'
# outputs to 1e-5 and gradients to 1e-4 (tests/test_torch_*.py); on the
# card cuDNN and cuBLAS pick other float32 algorithms (cuDNN's Winograd
# and FFT convolutions round differently from a direct sum), so 10x that.
TINY_OUT_TOL = 1e-4
TINY_GRAD_TOL = 1e-3
# Faults that must fail the check: ResNet with PyTorch's symmetric k//2
# padding, BERT with the padding mask ignored.
TINY_FAULTS = {
    "resnet_symmetric_padding": ("resnet", "_same_pads",
                                 lambda f: lambda n, k, s: (k // 2, k // 2)),
    "bert_mask_ignored": ("bert", "_attention",
                          lambda f: lambda q, k, v, mask: f(
                              q, k, v, torch.ones_like(mask))),
}


def tiny_draw(rng, name: str, shape) -> np.ndarray:
    """One leaf named ``name``: 1 + 0.1 N(0, 1) for a ``scale``, else
    0.1 N(0, 1), float32."""
    x = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return x + np.float32(1.0) if name == "scale" else x


def tiny_inputs(family: str, rng) -> dict:
    """The batch each family runs, drawn after the weights (BERT's row 1
    padded after 9 tokens)."""
    if family in ("resnet", "vit"):
        return {"images": rng.standard_normal((2, 32, 32, 3)).astype(
                    np.float32),
                "labels": rng.integers(0, 10, 2).astype(np.int32)}
    if family == "bert":
        mask = np.ones((2, 16), np.int32)
        mask[1, 9:] = 0
        return {"tokens": rng.integers(0, 128, (2, 16)).astype(np.int32),
                "attention_mask": mask,
                "labels": rng.integers(0, 2, 2).astype(np.int32),
                "targets": rng.integers(0, 128, (2, 16)).astype(np.int32),
                "loss_mask": rng.integers(0, 2, (2, 16)).astype(np.int32)}
    return {"inputs": rng.integers(0, 256, (2, 12)).astype(np.int32),
            "decoder_inputs": rng.integers(0, 256, (2, 8)).astype(np.int32),
            "targets": rng.integers(0, 256, (2, 8)).astype(np.int32)}


def tiny_outputs(family: str, dev) -> dict:
    """The port's float32 outputs for one family's tiny preset, as
    tests/tiny_reference.py records the reference's (numpy arrays)."""
    import dataclasses
    from ray_tpu_torch import models
    from ray_tpu_torch.parallel import transforms as tx
    mod = models.get_model(family)
    cfg = dataclasses.replace(mod.tiny(), dtype=torch.float32)
    rng = np.random.default_rng((TINY_SEED, TINY_FAMILIES.index(family)))
    template = mod.init_params(None, cfg, device="meta")
    paths = [p for p, _ in tx.tree_leaves_with_path(template)]
    drawn = iter([tiny_draw(rng, p.rsplit("/", 1)[-1], tuple(t.shape))
                  for p, t in tx.tree_leaves_with_path(template)])
    params = tx.tree_map(lambda _: torch.from_numpy(next(drawn)).to(dev),
                         template)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in tiny_inputs(family, rng).items()}
    res = {}
    with torch.no_grad():
        if family in ("resnet", "vit"):
            res["logits"] = mod.forward(params, batch["images"], cfg)
        elif family == "bert":
            toks, mask = batch["tokens"], batch["attention_mask"]
            res["logits"] = mod.classify(params, toks, cfg, mask)
            res["pooled"] = mod.pooled(params, toks, cfg, mask)
            res["mlm_loss"] = mod.mlm_loss(params, batch, cfg)
        else:
            res["logits"] = mod.forward(
                params, batch["inputs"], batch["decoder_inputs"],
                cfg)[..., :TINY_T5_VOCAB_SLICE]
    if family == "resnet":
        loss, grads = leaf_grads(params, lambda: mod.loss_fn(
            params, batch, cfg, label_smoothing=0.1))
    elif family == "bert":
        loss, grads = leaf_grads(params, lambda: mod.classification_loss(
            params, batch, cfg))
    else:
        loss, grads = leaf_grads(params, lambda: mod.loss_fn(params, batch,
                                                             cfg))
    res["loss"] = loss
    res["grad_norm"] = torch.sqrt(sum(g.double().pow(2).sum()
                                      for g in grads))
    by_path = dict(zip(paths, grads))
    for name in TINY_GRAD_LEAVES[family]:
        res[f"grad/{name}"] = by_path[name]
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in res.items()}


def tiny_errors(family: str, ref: dict, dev) -> tuple:
    """(worst error over its limit, that entry, each entry's error): each
    entry's largest error over the reference's largest magnitude."""
    got = tiny_outputs(family, dev)
    errs = {}
    for key, entry in ref.items():
        r = np.asarray(entry["values"], np.float32).reshape(entry["shape"])
        if got[key].shape != r.shape:
            fail(f"tiny {family} {key}: shape {got[key].shape}, reference "
                 f"{r.shape}")
        errs[key] = float(np.abs(got[key] - r).max()
                          / max(np.abs(r).max(), 1e-30))
    ratio = {k: e / (TINY_GRAD_TOL if k.startswith("grad/")
                     else TINY_OUT_TOL) for k, e in errs.items()}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst, errs


def tiny_reference_check(dev, tag: str = "") -> dict:
    """The four tiny models on ``dev`` in float32 against the JAX
    package's outputs (TINY_REFERENCE), then each planted fault, which
    must fail the same check.  Returns {family or fault: (worst error
    over its limit, entry)}."""
    from ray_tpu_torch import models
    with open(TINY_REFERENCE) as f:
        ref = json.load(f)["families"]
    out = {}
    for family in TINY_FAMILIES:
        ratio, worst, errs = tiny_errors(family, ref[family], dev)
        out[family] = (ratio, worst)
        print(f"tiny_reference {family}: worst {worst} at {ratio:.4g} of "
              f"its limit (out {TINY_OUT_TOL}, grads {TINY_GRAD_TOL}); "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f" [{tag}]", flush=True)
        if not ratio <= 1.0:
            fail(f"tiny {family} disagrees with the JAX reference")
    for fault, (family, attr, plant) in TINY_FAULTS.items():
        mod = models.get_model(family)
        orig = getattr(mod, attr)
        setattr(mod, attr, plant(orig))
        try:
            ratio, worst, _ = tiny_errors(family, ref[family], dev)
        finally:
            setattr(mod, attr, orig)
        out[fault] = (ratio, worst)
        print(f"tiny_reference control {fault}: worst {worst} at "
              f"{ratio:.4g} of its limit (must exceed 1) [{tag}]",
              flush=True)
        if ratio <= 1.0:
            fail(f"planted fault {fault} passed the tiny reference check")
    return out


def rel_l2_errors(got, ref) -> list:
    """Each leaf's ||g - r|| / ||r|| in float32."""
    return [((g.float() - r.float()).norm()
             / r.float().norm().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]


def grad_report(label: str, names, errs, tol, tag: str) -> tuple:
    """Prints the worst leaves; returns (worst error, its leaf)."""
    order = sorted(range(len(errs)), key=lambda i: -errs[i])
    print(f"{label}: worst leaf {names[order[0]]} rel_err "
          f"{errs[order[0]]:.4g} (limit {tol}); next "
          + ", ".join(f"{names[i]} {errs[i]:.3g}" for i in order[1:4])
          + f" [{tag}]", flush=True)
    return errs[order[0]], names[order[0]]


def with_head(params, key: str, gen, std: float):
    """``params`` with ``params[key]["kernel"]`` drawn N(0, std²) (the
    zero-initialised heads leave every other gradient exactly zero)."""
    from ray_tpu_torch.models._common import normal_init
    k = params[key]["kernel"]
    return {**params, key: {**params[key], "kernel": normal_init(
        gen, tuple(k.shape), k.dtype, std)}}


# ResNet-50 (BASELINE #2) at benchmarks/resnet_bench.py's shape (:37,
# 41-44): 224 x 224 x 3 images, batch 128, float32 params, bf16
# activations, remat off.
RESNET_BATCH, RESNET_IMAGE = 128, 224
RESNET_HEAD_STD = 0.01
# Step-0 gradients, bf16 activations against the same program in
# float32 (TF32 off): the worst leaf's relative L2 error.  At the
# reference's init GN+WS ResNet-50 is chaotic: a bf16 rounding grows
# about 1.25x a block (0.3 % after the stem, 50 % after the last block,
# against float64; the JAX package's own bf16 logits are 20 % from its
# float32 ones at 96², its gradients up to 166 % per leaf), so no limit
# separates a planted fault from bf16 at the init.  The check scales
# every block's residual branch (its last GroupNorm scale, gn3) by
# RESNET_BRANCH_SCALE, as the GPT-2 checks scale their block matrices.
# resnet_grad_sweep() on the card (PERF.md §6), healthy / planted
# symmetric padding: x1 1.521 / 1.707, x0.5 1.239 / 1.844, x0.25 0.579 /
# 1.61, x0.1 0.281 / 1.439 (the phase's own draw: 0.336 / 1.519).  At
# x0.1, 0.6 sits 1.8x above the healthy error and 2.4x below the fault.
RESNET_BRANCH_SCALE = 0.1
RESNET_GRAD_REL_TOL = 0.6


def resnet_flops_per_image(cfg, hw: int) -> float:
    """Model FLOPs a trained image: 3 x 2 x the multiply-adds of every
    conv and the head, counted from the shapes (forward, and the
    backward's two products)."""
    h = -(-hw // 2)
    macs = h * h * 49 * 3 * cfg.width                      # stem 7x7/2
    h = -(-h // 2)                                         # max-pool
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** si
        for bi in range(n_blocks):
            s = 2 if (si > 0 and bi == 0) else 1
            ho = -(-h // s)
            macs += h * h * cin * cmid + ho * ho * 9 * cmid * cmid \
                + ho * ho * cmid * 4 * cmid
            if s != 1 or cin != 4 * cmid:
                macs += ho * ho * cin * 4 * cmid           # projection
            cin, h = 4 * cmid, ho
    return 3 * 2 * (macs + cin * cfg.num_classes)


def resnet_grad_check(cfg, params, batch, gen,
                      branch_scale: float = RESNET_BRANCH_SCALE,
                      tag: str = "") -> tuple:
    """Step-0 gradients of every leaf at bf16 activations against the
    same loss in float32, the head drawn N(0, RESNET_HEAD_STD²) and every
    block's gn3 scale times ``branch_scale``; then with PyTorch's
    symmetric padding planted in the bf16 run.  Returns (worst error, its
    leaf, the fault's worst)."""
    import dataclasses
    from ray_tpu_torch.models import resnet
    p = with_head(params, "head", gen, RESNET_HEAD_STD)
    for si in range(len(cfg.stage_sizes)):
        p[f"stage{si}"] = [{**bp, "gn3": {**bp["gn3"], "scale": bp["gn3"][
            "scale"] * branch_scale}} for bp in p[f"stage{si}"]]
    names = leaf_names(p)
    ref_loss, ref = leaf_grads(p, lambda: resnet.loss_fn(
        p, batch, dataclasses.replace(cfg, dtype=torch.float32)))
    loss, got = leaf_grads(p, lambda: resnet.loss_fn(p, batch, cfg))
    lab = f"resnet50_train grads branch x{branch_scale}"
    print(f"{lab}: loss {loss.item():.6f} (float32 {ref_loss.item():.6f}) "
          f"[{tag}]", flush=True)
    worst, leaf = grad_report(f"{lab} healthy", names,
                              rel_l2_errors(got, ref), RESNET_GRAD_REL_TOL,
                              tag)
    del got
    pads = resnet._same_pads
    resnet._same_pads = lambda n, k, s: (k // 2, k // 2)
    try:
        _, bad = leaf_grads(p, lambda: resnet.loss_fn(p, batch, cfg))
    finally:
        resnet._same_pads = pads
    control, _ = grad_report(
        f"{lab} control symmetric_padding (must fail)", names,
        rel_l2_errors(bad, ref), RESNET_GRAD_REL_TOL, tag)
    if not math.isfinite(loss.item()):
        fail("non-finite loss in the ResNet gradient check")
    return worst, leaf, control


def resnet_setup(dev):
    """ResNet-50's train program, state and batch (images and labels as
    resnet_bench.py makes them, from the seed)."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.parallel import spmd
    cfg = resnet.resnet50()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: resnet.loss_fn(p, b, cfg),
        init_params_fn=lambda g: resnet.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    B, hw = RESNET_BATCH, RESNET_IMAGE
    batch = spmd.shard_batch(prog, {
        "images": rng.standard_normal((B, hw, hw, 3)).astype(np.float32),
        "labels": (np.arange(B) % cfg.num_classes).astype(np.int32)})
    return cfg, prog, state, batch


def resnet_grad_sweep(scales=(1.0, 0.5, 0.25, 0.1), tag: str = "") -> dict:
    """The ResNet gradient check at several residual-branch scales,
    without failing on the limit (the sweep behind RESNET_BRANCH_SCALE
    and RESNET_GRAD_REL_TOL)."""
    from ray_tpu_torch._device import disable_tf32, resolve_device
    disable_tf32()
    dev = resolve_device(None)
    cfg, _, state, batch = resnet_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return {s: resnet_grad_check(cfg, state.params, batch, gen, s, tag=tag)
            for s in scales}


def resnet50_train_phase(dev, card, tag: str) -> dict:
    """ResNet-50 through spmd.build_train_program: the step-0 gradient
    check against float32, then six steps on one batch with host syncs
    made errors, no hand-written kernel (convolution, GroupNorm and
    max-pool are PyTorch's), the step-0 loss ln 1000 (the zero head), a
    falling loss, the step time, images/s, the model-FLOP share and one
    profiled step."""
    from ray_tpu_torch.models import resnet
    t0 = time.perf_counter()
    cfg, prog, state, batch = resnet_setup(dev)
    n_params = resnet.param_count(state.params)
    fpi = resnet_flops_per_image(cfg, RESNET_IMAGE)
    print(f"resnet50_train config resnet50 stages {cfg.stage_sizes} width "
          f"{cfg.width} GN {cfg.gn_groups} (full size) batch {RESNET_BATCH} "
          f"x {RESNET_IMAGE}^2: {n_params / 1e6:.4f} M params; "
          f"{fpi / 1e9:.4f} GFLOP a trained image [{tag}]", flush=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, leaf, control = resnet_grad_check(cfg, state.params, batch, gen,
                                             tag=tag)
    gc.collect()
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if worst > RESNET_GRAD_REL_TOL:
        fail("ResNet step-0 gradients disagree with float32")
    if control <= RESNET_GRAD_REL_TOL:
        fail("the planted symmetric padding passed the ResNet check")
    # -- the main path: no hand-written kernel runs
    state, run = train_steps("resnet50_train", prog, state, batch, {},
                             RESNET_BATCH)
    loss0_err = abs(run["losses"][0] - math.log(cfg.num_classes))
    if not loss0_err <= 1e-3:
        fail(f"ResNet step-0 loss {run['losses'][0]} is not ln "
             f"{cfg.num_classes}")
    images_per_s = run.pop("tokens_per_s")
    res = dict(n_params=n_params, setup_s=setup_s, check_s=check_s,
               grad_rel_err=worst, grad_worst_leaf=leaf,
               grad_rel_tol=RESNET_GRAD_REL_TOL,
               grad_control_symmetric_padding=control,
               step0_loss_minus_ln1000=run["losses"][0]
               - math.log(cfg.num_classes), **run,
               images_per_s=images_per_s, flops_per_image=fpi,
               model_flop_share=fpi * images_per_s / card[1])
    for k, val in res.items():
        print(f"resnet50_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "resnet50_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# BERT-base serving (BASELINE #4) at benchmarks/serve_bench.py's shapes
# (:56, 85): classify at batches 1, 2, 4, 8 x 128 tokens.  Padded rows of
# true lengths 1 to 128 (BERT_LENGTHS, in batch order), the cls head drawn
# N(0, BERT_CLS_STD²).
BERT_LENGTHS = tuple(int(round(x)) for x in np.linspace(128, 1, 15))
BERT_CLS_STD = 0.02
BERT_CALLS = 20
# Padding invariance: a padded row's pooled output and logits against the
# same row run alone, unpadded (other GEMM shapes, other roundings in
# bf16): the worst row's largest error over that row's largest magnitude.
# On the card (PERF.md §6) 0.0285, the mask ignored 1.105; on the CPU in
# bf16 0.018-0.023 at block matrices x1-x3.  0.05 sits 1.8x above the
# one and 22x below the other.
BERT_PAD_TOL = 0.05
# The kernel path against the plain-LayerNorm path, the same measure over
# every row of every batch (on the card 0.0223: a LayerNorm output one
# bf16 step apart, carried through 12 post-LN layers).
BERT_PLAIN_TOL = 0.05


def bert_batches(cfg) -> list:
    """(tokens, mask, lengths) on the host for each batch of BERT_BATCHES,
    from the seed."""
    rng = np.random.default_rng(SEED)
    out, i = [], 0
    for B in BERT_BATCHES:
        lengths = BERT_LENGTHS[i:i + B]
        i += B
        toks = rng.integers(0, cfg.vocab_size, (B, BERT_SEQ)).astype(
            np.int64)
        mask = (np.arange(BERT_SEQ)[None] < np.array(lengths)[:, None]) \
            .astype(np.int64)
        out.append((toks, mask, lengths))
    return out


def _row_errors(got: torch.Tensor, ref: torch.Tensor) -> list:
    return [((g.float() - r.float()).abs().max()
             / r.float().abs().max().clamp_min(1e-30)).item()
            for g, r in zip(got, ref)]


def bert_serve_phase(dev, card, tag: str) -> dict:
    """bert-base's classify, the function a Serve replica calls: padding
    invariance (with a planted mask fault), the kernel path against the
    plain-LayerNorm path, then the main path: BERT_CALLS timed calls a
    batch, each exactly 25 vector LayerNorm-forward launches (eps 1e-12)
    and no other kernel; p50 / max latency and device time a call."""
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.ops import layer_norm as ln
    cfg = bert.bert_base()
    L = cfg.n_layer
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = with_head(bert.init_params(gen, cfg, device=dev), "cls", gen,
                       BERT_CLS_STD)
    batches = [(torch.from_numpy(t).to(dev), torch.from_numpy(m).to(dev),
                lens) for t, m, lens in bert_batches(cfg)]
    print(f"bert_serve config bert-base E {cfg.n_embd} L {L} H "
          f"{cfg.n_head} (full size), batches {BERT_BATCHES} x {BERT_SEQ}, "
          f"true lengths {BERT_LENGTHS} [{tag}]", flush=True)

    def run_all():
        with torch.no_grad():
            return [(bert.pooled(params, t, cfg, m),
                     bert.classify(params, t, cfg, m))
                    for t, m, _ in batches]

    # -- padding invariance: each row alone, unpadded, no mask
    with torch.no_grad():
        alone = [[(bert.pooled(params, t[i:i + 1, :n], cfg),
                   bert.classify(params, t[i:i + 1, :n], cfg))
                  for i, n in enumerate(lens)] for t, _, lens in batches]

    def pad_error(outs) -> float:
        errs = []
        for (p, lg), rows in zip(outs, alone):
            errs += _row_errors(p, torch.cat([a for a, _ in rows]))
            errs += _row_errors(lg, torch.cat([b for _, b in rows]))
        return max(errs)

    kernel_outs = run_all()
    pad_err = pad_error(kernel_outs)
    attention = bert._attention
    bert._attention = lambda q, k, v, mask: attention(
        q, k, v, torch.ones_like(mask))
    try:
        pad_control = pad_error(run_all())
    finally:
        bert._attention = attention
    # -- the kernel path against the plain LayerNorm
    kernel_ln = bert.layer_norm
    bert.layer_norm = ln.layer_norm_plain
    try:
        plain_outs = run_all()
    finally:
        bert.layer_norm = kernel_ln
    plain_err = max(max(_row_errors(p, pp) + _row_errors(lg, lp))
                    for (p, lg), (pp, lp) in zip(kernel_outs, plain_outs))
    print(f"bert_serve padding invariance: worst row rel_err {pad_err:.4g} "
          f"(limit {BERT_PAD_TOL}); control mask_ignored {pad_control:.4g} "
          f"(must fail); against the plain LayerNorm {plain_err:.4g} (limit "
          f"{BERT_PLAIN_TOL}) [{tag}]", flush=True)
    if not pad_err <= BERT_PAD_TOL:
        fail("BERT padded rows disagree with the rows run alone")
    if pad_control <= BERT_PAD_TOL:
        fail("the planted mask fault passed the BERT padding check")
    if not plain_err <= BERT_PLAIN_TOL:
        fail("BERT's kernel path disagrees with the plain LayerNorm path")
    for p, lg in kernel_outs:
        if not (torch.isfinite(p).all() and torch.isfinite(lg).all()):
            fail("non-finite BERT outputs")
    del kernel_outs, plain_outs, alone
    # -- the main path: classify, BERT_CALLS timed calls a batch
    counters = kernel_counters()
    for m, a in counters.values():
        setattr(m, a, 0)
    per_call = {k: 0 for k in counters}
    per_call["layer_norm_fwd"] = 1 + 2 * L
    lat, calls = {}, 0
    with torch.no_grad():
        for t, m, _ in batches:
            times = []
            for i in range(BERT_CALLS + 3):          # 3 warm-up calls
                before = {k: getattr(mm, a)
                          for k, (mm, a) in counters.items()}
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                bert.classify(params, t, cfg, m)
                torch.cuda.synchronize()
                if i >= 3:
                    times.append((time.perf_counter() - t1) * 1e3)
                calls += 1
                got = {k: getattr(mm, a) - before[k]
                       for k, (mm, a) in counters.items()}
                if got != per_call:
                    fail(f"bert_serve: launches in a call {got}, expected "
                         f"{per_call}")
            lat[t.shape[0]] = (float(np.median(times)), max(times))
    launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
    if launches["layer_norm_fwd"] != calls * per_call["layer_norm_fwd"]:
        fail(f"bert_serve: {launches['layer_norm_fwd']} LayerNorm launches "
             f"over {calls} calls")
    dev_ms = {}
    with torch.no_grad():
        for t, m, _ in batches:
            r = profile_once(f"bert_classify_b{t.shape[0]}",
                             lambda: bert.classify(params, t, cfg, m), tag)
            dev_ms[t.shape[0]] = (r["device_ms"], r["busy"])
    for B in BERT_BATCHES:
        print(f"bert_serve b{B}x{BERT_SEQ}: p50 {lat[B][0]:.4g} ms max "
              f"{lat[B][1]:.4g} ms over {BERT_CALLS} calls (host clock); "
              f"device {dev_ms[B][0]:.4g} ms a call, busy {dev_ms[B][1]:.3f}"
              f" [{tag}]", flush=True)
    print(f"bert_serve launches {launches} over {calls} calls, per call "
          f"{per_call} [{tag}]", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pad_rel_err=pad_err, pad_control=pad_control,
                plain_rel_err=plain_err, latency_ms=lat, device_ms=dev_ms,
                calls=calls, launches=launches)


# ViT-B/16 training: 224² images, batch 128, remat off (the preset's).
VIT_HEAD_STD = 0.02
# Step-0 gradients, kernel path against the plain-LayerNorm path (both
# bf16): the worst leaf's relative L2 error.  On the card (PERF.md §6)
# healthy 0.0139, the rolled rstd 774; GPT-2's check (the same kernels,
# 12 layers of 768) holds 0.05 over its healthy 0.0137.
VIT_GRAD_REL_TOL = 0.05


def vit_flops_per_image(cfg) -> float:
    """Model FLOPs a trained image: 3 x the forward's matrix products,
    counted from the shapes (patch embedding, qkv, scores, p·v, output,
    MLP, head)."""
    E, L, T = cfg.n_embd, cfg.n_layer, cfg.num_patches + 1
    M = cfg.mlp_ratio * E
    per_layer = 2 * T * E * 3 * E + 2 * 2 * T * T * E + 2 * T * E * E \
        + 2 * 2 * T * E * M
    embed = 2 * cfg.num_patches * cfg.patch_size ** 2 * 3 * E
    return 3 * (embed + L * per_layer + 2 * E * cfg.num_classes)


def vit_grad_check(cfg, params, batch, gen, tag: str = "") -> tuple:
    """Step-0 gradients on the kernel path against the plain-LayerNorm
    path, the head drawn N(0, VIT_HEAD_STD²); then with the LayerNorm
    backward fed rolled rstd rows.  Returns (worst, its leaf, the
    fault's worst)."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops import layer_norm as ln
    p = with_head(params, "head", gen, VIT_HEAD_STD)
    names = leaf_names(p)
    kernel_ln = vit.layer_norm
    vit.layer_norm = ln.layer_norm_plain
    try:
        ref_loss, ref = leaf_grads(p, lambda: vit.loss_fn(p, batch, cfg))
    finally:
        vit.layer_norm = kernel_ln
    loss, got = leaf_grads(p, lambda: vit.loss_fn(p, batch, cfg))
    print(f"vit_train grads: loss {loss.item():.6f} (plain LayerNorm "
          f"{ref_loss.item():.6f}) [{tag}]", flush=True)
    worst, leaf = grad_report("vit_train grads healthy", names,
                              rel_l2_errors(got, ref), VIT_GRAD_REL_TOL, tag)
    del got
    bwd = ln.ln_bwd
    ln.ln_bwd = lambda x, s, g, mu, rstd: bwd(x, s, g, mu, rstd.roll(1, 0))
    try:
        _, bad = leaf_grads(p, lambda: vit.loss_fn(p, batch, cfg))
    finally:
        ln.ln_bwd = bwd
    control, _ = grad_report("vit_train grads control ln_bwd_rstd_rolled "
                             "(must fail)", names, rel_l2_errors(bad, ref),
                             VIT_GRAD_REL_TOL, tag)
    if not math.isfinite(loss.item()):
        fail("non-finite loss in the ViT gradient check")
    return worst, leaf, control


def vit_train_phase(dev, card, tag: str) -> dict:
    """vit-b16 through spmd.build_train_program: the gradient check, then
    six steps on one batch with host syncs made errors, exactly 25 vector
    LayerNorm forwards and 25 backwards a step (eps 1e-6; ln_f on the
    strided CLS rows) and no flash launch, a falling loss, the step time,
    images/s, the model-FLOP share and one profiled step."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel import spmd
    cfg = vit.vit_b16()
    B, L = VIT_TRAIN_BATCH, cfg.n_layer
    fpi = vit_flops_per_image(cfg)
    t0 = time.perf_counter()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: vit.loss_fn(p, b, cfg),
        init_params_fn=lambda g: vit.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(t.numel() for t in leaf_tensors(state.params))
    rng = np.random.default_rng(SEED)
    hw = cfg.image_size
    batch = spmd.shard_batch(prog, {
        "images": rng.standard_normal((B, hw, hw, 3)).astype(np.float32),
        "labels": rng.integers(0, cfg.num_classes, B).astype(np.int32)})
    print(f"vit_train config vit-b16 E {cfg.n_embd} L {L} H {cfg.n_head} "
          f"patch {cfg.patch_size} (full size) batch {B} x {hw}^2, "
          f"{VIT_TOKENS} tokens: {n_params / 1e6:.4f} M params; "
          f"{fpi / 1e9:.4f} GFLOP a trained image [{tag}]", flush=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, leaf, control = vit_grad_check(cfg, state.params, batch, gen, tag)
    gc.collect()
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if worst > VIT_GRAD_REL_TOL:
        fail("ViT step-0 gradients disagree with the plain LayerNorm path")
    if control <= VIT_GRAD_REL_TOL:
        fail("the planted LayerNorm backward fault passed the ViT check")
    # -- the main path: the vector LayerNorm kernels only
    state, run = train_steps("vit_train", prog, state, batch, {
        "layer_norm_fwd": 2 * L + 1, "layer_norm_bwd": 2 * L + 1}, B)
    images_per_s = run.pop("tokens_per_s")
    res = dict(n_params=n_params, setup_s=setup_s, check_s=check_s,
               grad_rel_err=worst, grad_worst_leaf=leaf,
               grad_rel_tol=VIT_GRAD_REL_TOL,
               grad_control_ln_bwd_rstd_rolled=control, **run,
               images_per_s=images_per_s, flops_per_image=fpi,
               model_flop_share=fpi * images_per_s / card[1])
    for k, val in res.items():
        print(f"vit_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "vit_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# T5 1.1-base training at the T5 paper's span-corruption lengths: batch
# 32 x 512 input tokens x 114 target tokens, from the full vocabulary.
T5_TRAIN_BATCH, T5_INPUT_LEN, T5_TARGET_LEN = 32, 512, 114
# Step-0 gradients, bf16 activations against the same program in float32
# (TF32 off): the worst leaf's relative L2 error.  On the card (PERF.md
# §6) healthy 0.0358, bidirectional decoder buckets 0.945; on the CPU at
# b2 x 128 / 32, 0.038 and 0.74.  0.1 sits 2.8x above the one and 9x
# below the other.
T5_GRAD_REL_TOL = 0.1


def t5_flops_per_step(cfg, B: int, S: int, T: int) -> float:
    """Model FLOPs a train step: 3 x the forward's matrix products,
    counted from the shapes (projections, scores and p·v of the encoder's
    self-attention and the decoder's self- and cross-attention, the
    gated FFNs, the LM head)."""
    E, HD, F_ = cfg.n_embd, cfg.n_head * cfg.head_dim, cfg.d_ff
    enc = 2 * S * E * HD * 4 + 2 * 2 * S * S * HD + 2 * S * E * F_ * 3
    dec = 2 * T * E * HD * 4 + 2 * 2 * T * T * HD \
        + 2 * T * E * HD * 2 + 2 * S * E * HD * 2 + 2 * 2 * T * S * HD \
        + 2 * T * E * F_ * 3
    return 3 * B * (cfg.n_layer * (enc + dec) + 2 * T * E * cfg.vocab_size)


def t5_bucket_check(dev, cfg, tag: str) -> None:
    """The relative-bucket tables computed on the card against the CPU's,
    exactly: the encoder's (S x S, bidirectional) and the decoder's (T x
    T, causal), and every relative position in [-4096, 4096] both ways."""
    from ray_tpu_torch.models import t5
    cases = []
    for q, k, bidir in ((T5_INPUT_LEN, T5_INPUT_LEN, True),
                        (T5_TARGET_LEN, T5_TARGET_LEN, False)):
        rel = [torch.arange(k, dtype=torch.int32, device=d)[None, :]
               - torch.arange(q, dtype=torch.int32, device=d)[:, None]
               for d in (dev, torch.device("cpu"))]
        cases.append((f"{q}x{k} {'bidirectional' if bidir else 'causal'}",
                      rel, bidir))
    for bidir in (True, False):
        rel = [torch.arange(-4096, 4097, dtype=torch.int32, device=d)
               for d in (dev, torch.device("cpu"))]
        way = "bidirectional" if bidir else "one-way"
        cases.append((f"[-4096, 4096] {way}", rel, bidir))
    for name, (rd, rc), bidir in cases:
        args = (cfg.rel_buckets, cfg.rel_max_distance, bidir)
        got = t5._relative_buckets(rd, *args).cpu()
        ref = t5._relative_buckets(rc, *args)
        differ = int((got != ref).sum())
        print(f"t5_train buckets {name}: {differ} of {ref.numel()} differ "
              f"from the CPU's [{tag}]", flush=True)
        if differ:
            fail(f"T5 bucket table {name} differs between card and CPU")


def t5_grad_check(cfg, params, batch, tag: str = "") -> tuple:
    """Step-0 gradients of every leaf at bf16 activations against the
    same loss in float32; then with bidirectional buckets planted in the
    decoder.  Returns (worst, its leaf, the fault's worst)."""
    import dataclasses
    from ray_tpu_torch.models import t5
    names = leaf_names(params)
    ref_loss, ref = leaf_grads(params, lambda: t5.loss_fn(
        params, batch, dataclasses.replace(cfg, dtype=torch.float32)))
    loss, got = leaf_grads(params, lambda: t5.loss_fn(params, batch, cfg))
    print(f"t5_train grads: loss {loss.item():.6f} (float32 "
          f"{ref_loss.item():.6f}) [{tag}]", flush=True)
    worst, leaf = grad_report("t5_train grads healthy", names,
                              rel_l2_errors(got, ref), T5_GRAD_REL_TOL, tag)
    del got
    rel_bias = t5._rel_bias
    t5._rel_bias = lambda table, q, k, c, bidirectional: rel_bias(
        table, q, k, c, True)
    try:
        _, bad = leaf_grads(params, lambda: t5.loss_fn(params, batch, cfg))
    finally:
        t5._rel_bias = rel_bias
    control, _ = grad_report("t5_train grads control decoder_bidirectional "
                             "(must fail)", names, rel_l2_errors(bad, ref),
                             T5_GRAD_REL_TOL, tag)
    if not math.isfinite(loss.item()):
        fail("non-finite loss in the T5 gradient check")
    return worst, leaf, control


def t5_train_phase(dev, card, tag: str) -> dict:
    """t5-base through spmd.build_train_program: the bucket tables, the
    gradient check against float32, then six steps on one batch with host
    syncs made errors and a falling loss.  No hand-written kernel runs on
    this path: RMSNorm is plain PyTorch (inline in the reference) and
    attention dense; every launch counter must stay 0.  Prints the step
    time, tokens/s (input and target tokens), the model-FLOP share, peak
    memory and one profiled step."""
    from ray_tpu_torch.models import t5
    from ray_tpu_torch.parallel import spmd
    cfg = t5.t5_base()
    B, S, T = T5_TRAIN_BATCH, T5_INPUT_LEN, T5_TARGET_LEN
    t5_bucket_check(dev, cfg, tag)
    flops = t5_flops_per_step(cfg, B, S, T)
    t0 = time.perf_counter()
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: t5.loss_fn(p, b, cfg),
        init_params_fn=lambda g: t5.init_params(g, cfg, device=dev),
        optimizer=spmd.default_optimizer(lr=TRAIN_LR, warmup=1,
                                         total_steps=1000), device=dev)
    state = prog.init_fn(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(t.numel() for t in leaf_tensors(state.params))
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    batch = spmd.shard_batch(prog, {
        "inputs": rng.integers(0, V, (B, S)).astype(np.int32),
        "decoder_inputs": rng.integers(0, V, (B, T)).astype(np.int32),
        "targets": rng.integers(0, V, (B, T)).astype(np.int32)})
    print(f"t5_train config t5-base E {cfg.n_embd} L {cfg.n_layer} a stack "
          f"H {cfg.n_head} ff {cfg.d_ff} V {V} (full size) batch {B} x "
          f"{S} inputs / {T} targets: {n_params / 1e6:.4f} M params; "
          f"{flops / 1e12:.4f} TFLOP a step [{tag}]", flush=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst, leaf, control = t5_grad_check(cfg, state.params, batch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if worst > T5_GRAD_REL_TOL:
        fail("T5 step-0 gradients disagree with float32")
    if control <= T5_GRAD_REL_TOL:
        fail("the planted decoder bucket fault passed the T5 check")
    state, run = train_steps("t5_train", prog, state, batch, {},
                             B * (S + T))
    res = dict(n_params=n_params, setup_s=setup_s, check_s=check_s,
               grad_rel_err=worst, grad_worst_leaf=leaf,
               grad_rel_tol=T5_GRAD_REL_TOL,
               grad_control_decoder_bidirectional=control, **run,
               flops_per_step=flops,
               model_flop_share=flops / (run["step_ms"] / 1e3) / card[1])
    for k, val in res.items():
        print(f"t5_train {k} {val} [{tag}]", flush=True)
    res["profile"] = profile_once(
        "t5_train_step", lambda: prog.step_fn(state, batch), tag)
    del state, prog, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ rllib
# RLlib's learners against the JAX package's outputs committed in
# RL_REFERENCE (tests/rllib_reference.py wrote them, JAX on the CPU in
# float32).  Each run draws, from numpy.random.default_rng((RL_SEED, i)),
# i the run's place in RL_RUNS: the params in the reference's layout and
# leaf order (rl_draw), DQN's target params the same way, then the batch
# (rl_inputs).  Both sides build the algorithm from rl_config(run), load
# the same draws, take the gradient's global norm at the drawn params and
# run ONE learner update on the batch.
RL_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "rllib_reference.json")
RL_SEED = 0
# The catalog's two networks at a small size: the tanh MLP (obs 4,
# hiddens (16, 16), 2 actions) and a conv torso (36×36×2 uint8 frames,
# VALID convs (16, 8, 4), (32, 4, 2) → 3×3×32, dense 64, 4 actions).
RL_SIZES = {
    "mlp": {"env": "RandomEnv", "env_config": {"obs_dim": 4,
                                               "num_actions": 2},
            "fcnet_hiddens": (16, 16)},
    "conv": {"env": "RandomPixelEnv",
             "env_config": {"size": 36, "frames": 2, "num_actions": 4},
             "conv_filters": ((16, 8, 4), (32, 4, 2)), "conv_dense": 64},
}
# Rows a PPO or DQN update takes; (T, B) of an IMPALA/APPO update.
RL_ROWS = {"mlp": 64, "conv": 32}
RL_TB = {"mlp": (8, 4), "conv": (8, 2)}
# Each algorithm's config beside its defaults: PPO at two epochs of one
# minibatch holding the whole batch (so the permutation cannot matter),
# lr 1e-3 so one update moves the params visibly, the value clip and the
# entropy bonus switched on.
RL_ALGO_CONFIG = {
    "ppo": {"lr": 1e-3, "num_sgd_iter": 2, "entropy_coeff": 0.01,
            "vf_clip_param": 0.5},
    "impala": {}, "appo": {},
    "dqn_double": {"double_q": True}, "dqn_single": {"double_q": False},
}
# The rest of the one-card learners, appended so that the runs above keep
# their draws: SAC, DDPG and TD3 (two updates: one actor step, one
# skipped) on PendulumLite's spaces (obs 3, one action in [-2, 2]),
# hiddens (16, 16), RL_CONTINUOUS_ROWS rows an update; MARWIL (two
# updates, c² carried) and BC; A3C (one compute_gradients on a fixed
# fragment, then one apply); Ape-X (one update with drawn importance
# weights).
RL_MORE_CONFIG = {"sac": {}, "ddpg": {}, "td3": {},
                  "marwil": {"lr": 1e-3, "vf_norm_rate": 1e-2},
                  "bc": {"lr": 1e-3},
                  "a3c": {"lr": 1e-3}, "apex": {}}
RL_MORE_RUNS = ("sac_mlp", "ddpg_mlp", "td3_mlp", "marwil_mlp",
                "marwil_conv", "bc_mlp", "a3c_mlp", "a3c_conv", "apex_mlp",
                "apex_conv")
RL_RUNS = tuple(f"{a}_{s}" for a in RL_ALGO_CONFIG for s in RL_SIZES) \
    + ("vtrace",) + RL_MORE_RUNS
RL_CONTINUOUS = {"env": "PendulumLite", "env_config": {},
                 "fcnet_hiddens": (16, 16)}
RL_CONTINUOUS_ROWS = 32
RL_UPDATES = {"td3": 2, "marwil": 2, "bc": 2}
# SAC's actor output layer is drawn x SAC_ACTOR_OUT_SCALE, so that some
# pre-tanh samples saturate float32's tanh (|pre| > 10: the action is ±1
# exactly and the 1e-6 decides logp and stops its gradient), and every
# row's pre-tanh samples avoid SAC_BAND, where 1/(1 − tanh²) amplifies
# an ulp of tanh (XLA's CPU tanh is a rational approximation, up to 4
# ulps from torch's) past the limits.  tests/test_torch_rllib_offpolicy.py
# holds the formula inside the band against float64.
SAC_ACTOR_OUT_SCALE = 16.0
SAC_BAND = (3.0, 10.0)
RL_VTRACE_TB = (7, 5)
RL_VTRACE_CLIPS = {"clip_rho": 1.0, "clip_c": 1.0, "clip_pg_rho": 0.9}
# The leaves recorded after the update (the file stays small).
RL_LEAVES = {
    ("ac", "mlp"): ("pi_0/b", "pi_1/w", "pi_out/w", "vf_0/b", "vf_out/w"),
    ("ac", "conv"): ("torso/conv_0/b", "torso/conv_1/b", "torso/dense/b",
                     "pi_out/w", "vf_out/b"),
    ("q", "mlp"): ("q_0/b", "q_1/w", "q_2/w"),
    ("q", "conv"): ("torso/conv_0/b", "torso/conv_1/b", "torso/dense/b",
                    "q_out/w"),
}
# (tree, leaf) recorded after the update of the runs in RL_MORE_RUNS.
RL_MORE_LEAVES = {
    "sac": (("actor", "q_2/w"), ("actor", "q_0/b"), ("q1", "q_2/w"),
            ("q2_t", "q_1/b")),
    "ddpg": (("actor", "q_2/w"), ("q1", "q_2/w"), ("q2", "q_2/w"),
             ("actor_t", "q_2/b"), ("q1_t", "q_0/b")),
    ("ac", "mlp"): (("params", "pi_out/w"), ("params", "pi_0/b"),
                    ("params", "vf_out/b")),
    ("ac", "conv"): (("params", "torso/conv_1/b"), ("params", "pi_out/b"),
                     ("params", "vf_out/w")),
    ("q", "mlp"): (("params", "q_2/w"), ("params", "q_0/b")),
    ("q", "conv"): (("params", "torso/conv_0/b"), ("params", "q_out/b")),
}
RL_MORE_LEAVES["td3"] = RL_MORE_LEAVES["ddpg"]
# Limits, each entry's largest error over its largest magnitude (float32
# on both sides, sums in other orders).  Params after the update: 1e-5,
# the target for one update.  Everything else (stats, the gradient's
# global norm, the update's global norm, V-trace's outputs): RL_OUT_TOL.
# The sweep (PERF.md §6): rllib_reference_check prints every entry's
# error.  Healthy, on the CPU and on the card: at most 9.7e-7 of the
# largest magnitude (params 6.2e-8); the planted faults: 149x (the
# unbiased std, 1.5e-2 on PPO's policy loss) to 21,130x the limits.
RL_PARAM_TOL = 1e-5
RL_OUT_TOL = 1e-4


def _rl_flatten_nchw(f):
    """The conv torso flattened in PyTorch's (C, H, W) order, not the
    reference's (H, W, C)."""
    return lambda x: x.reshape(x.shape[0], -1)


def _rl_rms_eps_outside_root(f):
    """RMSProp as ``torch.optim.RMSprop`` places eps: g / (sqrt(nu) +
    eps), not optax's g / sqrt(nu + eps)."""
    def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0):
        from ray_tpu_torch.parallel import transforms as tx

        def init(params):
            return {"nu": tx.tree_map(
                lambda p: torch.full_like(p, initial_scale), params)}

        def update(updates, state, params=None):
            def leaf(g, v):
                v.mul_(decay).add_((1 - decay) * (g * g))
                return g / (torch.sqrt(v) + eps)
            return tx.tree_map(leaf, updates, state["nu"]), state

        return tx.GradientTransformation(init, update)
    return scale_by_rms


def _rl_unbiased_std(f):
    """PPO's advantages normalised by ``torch.std``'s default, the
    unbiased std (the reference's ``jnp.std`` has ddof 0)."""
    return lambda adv: (adv - adv.mean()) / (adv.std() + 1e-8)


def _rl_tanh_transform(f):
    """SAC's log-probability with ``torch.distributions.TanhTransform``'s
    log-Jacobian, 2·(log 2 − x − softplus(−2x)): no 1e-6."""
    def tanh_log_det(pre, act):
        return (2 * (math.log(2) - pre
                     - torch.nn.functional.softplus(-2 * pre))).sum(-1)
    return tanh_log_det


def _rl_actor_every_update(f):
    """TD3's actor stepping on every update, not every policy_delay-th."""
    return lambda n_updates, policy_delay: True


def _rl_pre_update_c2(f):
    """MARWIL's advantages normalised by c² before this minibatch moves
    it."""
    def advantage_weights(adv, sq_norm, beta, rate):
        w = torch.exp(beta * adv / torch.sqrt(sq_norm + 1e-8))
        return torch.clamp(w, max=20.0), \
            sq_norm + rate * (torch.square(adv).mean() - sq_norm)
    return advantage_weights


def _rl_no_is_weights(f):
    """Ape-X's TD loss without the importance weights."""
    return lambda td, is_weights: torch.square(td).mean()


# Faults that must fail the check: (module of ray_tpu_torch, attribute,
# plant).
RL_FAULTS = {
    "conv_flatten_nchw": ("rllib.models", "_flatten_hwc", _rl_flatten_nchw),
    "rmsprop_eps_outside_root": ("parallel.transforms", "scale_by_rms",
                                 _rl_rms_eps_outside_root),
    "ppo_unbiased_std": ("rllib.algorithms.ppo", "normalize_advantages",
                         _rl_unbiased_std),
    "sac_tanh_transform": ("rllib.algorithms.sac", "tanh_log_det",
                           _rl_tanh_transform),
    "td3_actor_every_update": ("rllib.algorithms.ddpg", "actor_step_due",
                               _rl_actor_every_update),
    "marwil_pre_update_c2": ("rllib.algorithms.marwil", "advantage_weights",
                             _rl_pre_update_c2),
    "apex_no_is_weights": ("rllib.algorithms.apex", "weighted_td_loss",
                           _rl_no_is_weights),
}
# The runs each fault is checked on (the worst of them must fail): the
# runs that reach the faulty code.
RL_FAULT_RUNS = {
    "conv_flatten_nchw": RL_RUNS[:RL_RUNS.index("vtrace") + 1],
    "rmsprop_eps_outside_root": RL_RUNS[:RL_RUNS.index("vtrace") + 1],
    "ppo_unbiased_std": RL_RUNS[:RL_RUNS.index("vtrace") + 1],
    "sac_tanh_transform": ("sac_mlp",),
    "td3_actor_every_update": ("td3_mlp",),
    "marwil_pre_update_c2": ("marwil_mlp", "marwil_conv"),
    "apex_no_is_weights": ("apex_mlp", "apex_conv"),
}


def rl_config(run: str, input: Optional[str] = None) -> dict:  # noqa: A002
    """The algorithm config of one learner run (both sides); ``input``:
    MARWIL's and BC's dataset directory."""
    algo, size = run.rsplit("_", 1)
    cfg = dict(RL_CONTINUOUS if algo in ("sac", "ddpg", "td3")
               else RL_SIZES[size])
    cfg.update(num_workers=0, num_envs_per_worker=1, seed=RL_SEED,
               rollout_fragment_length=RL_TB[size][0])
    cfg.update({**RL_ALGO_CONFIG, **RL_MORE_CONFIG}[algo])
    if input is not None:
        cfg["input"] = input
    if algo == "ppo":
        cfg.update(train_batch_size=RL_ROWS[size],
                   sgd_minibatch_size=RL_ROWS[size])
    return cfg


def rl_draw(rng, path: str, shape) -> np.ndarray:
    """One leaf at ``path``: a weight (``w``, dense (in, out) or conv
    HWIO) N(0, 1 / fan_in), anything else 0.1 N(0, 1); float32."""
    if path.endswith("/w"):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def rl_draw_tree(rng, leaves) -> dict:
    """``leaves``: (path, shape) in the reference's leaf order → the nested
    dict of drawn leaves."""
    out: dict = {}
    for path, shape in leaves:
        *outer, name = path.split("/")
        node = out
        for k in outer:
            node = node.setdefault(k, {})
        node[name] = rl_draw(rng, path, tuple(shape))
    return out


def _rl_behavior(rng, lead, n_actions):
    """Behavior-policy logits, sampled actions and their log-probs."""
    logits = rng.standard_normal(lead + (n_actions,)).astype(np.float32)
    actions = rng.integers(0, n_actions, lead).astype(np.int32)
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    logp = np.take_along_axis(logits, actions[..., None], -1)[..., 0] - lse
    return logits, actions, logp.astype(np.float32)


def rl_inputs(run: str, rng) -> dict:
    """The batch one run learns on, drawn after the params.  PPO and DQN:
    rows; IMPALA/APPO: time-major [T, B] with ``last_obs`` and ``dones``,
    as ``_to_time_major`` gives them; vtrace: its arguments."""
    if run == "vtrace":
        T, B = RL_VTRACE_TB
        beh = (0.5 * rng.standard_normal((T, B)) - 1.0).astype(np.float32)
        tgt = (0.5 * rng.standard_normal((T, B)) - 1.0).astype(np.float32)
        return {"behavior_logp": beh, "target_logp": tgt,
                "rewards": rng.standard_normal((T, B)).astype(np.float32),
                "discounts": (0.99 * (rng.uniform(size=(T, B)) > 0.2))
                .astype(np.float32),
                "values": rng.standard_normal((T, B)).astype(np.float32),
                "bootstrap_value": rng.standard_normal(B).astype(
                    np.float32)}
    algo, size = run.rsplit("_", 1)
    A = RL_SIZES[size]["env_config"]["num_actions"]
    lead = RL_TB[size] if algo in ("impala", "appo") else (RL_ROWS[size],)

    def obs(shape):
        if size == "mlp":
            return rng.standard_normal(shape + (4,)).astype(np.float32)
        return rng.integers(0, 256, shape + (36, 36, 2), dtype=np.uint8)

    if algo == "ppo":
        n = lead[0]
        logits, actions, logp = _rl_behavior(rng, lead, A)
        vf = rng.standard_normal(n).astype(np.float32)
        return {"obs": obs(lead), "actions": actions, "action_logp": logp,
                "action_dist_inputs": logits,
                "advantages": (2.0 * rng.standard_normal(n) + 0.5).astype(
                    np.float32),
                "value_targets": (vf + rng.standard_normal(n)).astype(
                    np.float32),
                "vf_preds": vf}
    if algo in ("impala", "appo"):
        _, actions, logp = _rl_behavior(rng, lead, A)
        return {"obs": obs(lead), "actions": actions, "action_logp": logp,
                "rewards": rng.standard_normal(lead).astype(np.float32),
                "dones": (rng.uniform(size=lead) < 0.2).astype(np.float32),
                "last_obs": obs((lead[1],))}
    n = lead[0]
    return {"obs": obs(lead),
            "actions": rng.integers(0, A, n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "new_obs": obs(lead),
            "dones": (rng.uniform(size=n) < 0.2).astype(np.float32)}


def rl_tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a nested dict in the reference's leaf order (keys
    sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += rl_tree_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def rl_update_norm(before: dict, after: dict) -> float:
    """The global L2 norm of after − before, over every leaf, in float64."""
    b, a = dict(rl_tree_paths(before)), dict(rl_tree_paths(after))
    return float(np.sqrt(sum(
        np.sum((np.asarray(a[k], np.float64) - b[k]) ** 2) for k in b)))


# ------------------------------------------- the continuous-action env
class PendulumLite:
    """gymnasium's ``Pendulum-v1`` (classic_control/pendulum.py), copied:
    the card's machine has no gymnasium.  Swing a pole up: g 10, m 1, l 1,
    dt 0.05, max speed 8, max torque 2; reward −(θ̂² + 0.1·θ̇² +
    0.001·u²) with θ̂ the angle wrapped to [−π, π); observation (cos θ,
    sin θ, θ̇); the start uniform in θ ∈ [−π, π], θ̇ ∈ [−1, 1]; episodes
    truncated at 200 steps (gymnasium's TimeLimit).  Spaces from the
    port's ``env.make_box``."""

    max_speed, max_torque, dt, m, l = 8.0, 2.0, 0.05, 1.0, 1.0
    max_episode_steps = 200

    def __init__(self, config: Optional[dict] = None):
        from ray_tpu_torch.rllib import env as rl_env
        config = config or {}
        self.g = float(config.get("g", 10.0))
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = rl_env.make_box(-high, high, (3,))
        self.action_space = rl_env.make_box(-self.max_torque,
                                            self.max_torque, (1,))
        self._rng = np.random.default_rng(config.get("seed"))
        self.state = np.zeros(2)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._t = 0
        return self._obs(), {}

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        th_n = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = th_n ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._t += 1
        return self._obs(), -costs, False, \
            self._t >= self.max_episode_steps, {}

    def _obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)


def register_pendulum_lite(register_env) -> None:
    """``PendulumLite`` in a package's env registry (the port's, or the
    JAX package's for the reference generator)."""
    register_env("PendulumLite", lambda cfg: PendulumLite(cfg))


# ------------------------------- the learners of RL_MORE_RUNS, both sides
def _np_q_net(params: dict, x) -> np.ndarray:
    """The catalog's Q-net MLP (tanh hidden layers) in float64 numpy."""
    n = len(params)
    x = np.asarray(x, np.float64)
    for i in range(n):
        p = params[f"q_{i}"]
        x = x @ np.asarray(p["w"], np.float64) + p["b"]
        if i < n - 1:
            x = np.tanh(x)
    return x


def _sac_rows(rng, actor: dict, eps: np.ndarray, obs_dim: int) -> np.ndarray:
    """One observation row for each row of draws ``eps`` (B, act_dim):
    standard normal, redrawn until every pre-tanh sample of the actor
    (float64) lies outside SAC_BAND."""
    rows = []
    for e in eps:
        while True:
            o = rng.standard_normal(obs_dim).astype(np.float32)
            out = _np_q_net(actor, o[None])[0]
            pre = np.abs(out[:len(e)] + np.exp(np.clip(
                out[len(e):], -20.0, 2.0)) * e)
            if np.all((pre < SAC_BAND[0]) | (pre > SAC_BAND[1])):
                rows.append(o)
                break
    return np.stack(rows)


def rl_offpolicy_state(run: str, rng, actor_leaves, q_leaves) -> dict:
    """SAC's, DDPG's or TD3's drawn state in the reference's layout: the
    actor (SAC's output layer scaled by SAC_ACTOR_OUT_SCALE), DDPG's actor
    target, the two critics and their targets, SAC's log_alpha."""
    algo = run.rsplit("_", 1)[0]
    state = {"actor": rl_draw_tree(rng, actor_leaves)}
    if algo == "sac":
        out = state["actor"][f"q_{len(state['actor']) - 1}"]
        out["w"] = (out["w"] * SAC_ACTOR_OUT_SCALE).astype(np.float32)
    else:
        state["actor_t"] = rl_draw_tree(rng, actor_leaves)
    for k in ("q1", "q2", "q1_t", "q2_t"):
        state[k] = rl_draw_tree(rng, q_leaves)
    if algo == "sac":
        state["log_alpha"] = np.float32(0.1 * rng.standard_normal())
    return state


def _rl_obs(size: str, rng, lead: tuple) -> np.ndarray:
    if size == "mlp":
        return rng.standard_normal(lead + (4,)).astype(np.float32)
    return rng.integers(0, 256, lead + (36, 36, 2), dtype=np.uint8)


def rl_minibatches(run: str, rng, draws: Optional[dict] = None,
                   actor: Optional[dict] = None) -> list:
    """The host minibatches of a run of RL_MORE_RUNS, one an update, drawn
    after its params.  SAC's rows are chosen against its draws (JAX's,
    from the reference file) and drawn actor (``_sac_rows``)."""
    algo, size = run.rsplit("_", 1)
    out = []
    for _ in range(RL_UPDATES.get(algo, 1)):
        if algo in ("sac", "ddpg", "td3"):
            n = RL_CONTINUOUS_ROWS
            if algo == "sac":
                obs = _sac_rows(rng, actor, draws["actor"], 3)
                new_obs = _sac_rows(rng, actor, draws["next"], 3)
            else:
                obs = rng.standard_normal((n, 3)).astype(np.float32)
                new_obs = rng.standard_normal((n, 3)).astype(np.float32)
            mb = {"obs": obs, "new_obs": new_obs,
                  "raw_action": rng.uniform(-1, 1, (n, 1)).astype(
                      np.float32)}
        else:
            n = RL_ROWS[size]
            A = RL_SIZES[size]["env_config"]["num_actions"]
            mb = {"obs": _rl_obs(size, rng, (n,)),
                  "actions": rng.integers(0, A, n).astype(np.int64)}
        if algo in ("marwil", "bc"):
            mb["returns"] = (20.0 * rng.standard_normal(n) + 5.0).astype(
                np.float32)
        elif algo == "a3c":
            mb["advantages"] = (2.0 * rng.standard_normal(n) + 0.5).astype(
                np.float32)
            mb["value_targets"] = rng.standard_normal(n).astype(np.float32)
        else:
            mb["rewards"] = rng.standard_normal(n).astype(np.float32)
            mb["dones"] = (rng.uniform(size=n) < 0.2).astype(np.float32)
            if algo == "apex":
                mb["new_obs"] = _rl_obs(size, rng, (n,))
                mb["is_weights"] = rng.uniform(0.05, 1.0, n).astype(
                    np.float32)
        out.append(mb)
    return out


def rl_offline_stub(run: str, path: str) -> str:
    """One one-step episode in ``path``: MARWIL and BC need a dataset to
    build (the reference runs feed their minibatches directly)."""
    size = run.rsplit("_", 1)[1]
    shape = (4,) if size == "mlp" else (36, 36, 2)
    with open(os.path.join(path, "stub.json"), "w") as f:
        f.write(json.dumps({"obs": np.zeros((1,) + shape).tolist(),
                            "actions": [0], "rewards": [0.0],
                            "terminated": True}) + "\n")
    return path


def rl_more_record(run: str, pairs: dict, trees: dict, stats: dict,
                   extra: Optional[dict] = None) -> dict:
    """What a run of RL_MORE_RUNS records, from numpy trees in the
    reference's layout (both sides): ``stats`` (name → one value an
    update), the global L2 norm of each update in ``pairs`` (name →
    (tree before, tree after)), the leaves of RL_MORE_LEAVES from
    ``trees`` (the trees after the update), and ``extra`` as it is."""
    algo, size = run.rsplit("_", 1)
    res = {f"stat/{k}": v for k, v in stats.items()}
    for k, (b, a) in pairs.items():
        res[f"update_norm/{k}"] = rl_update_norm(b, a)
    key = algo if algo in RL_MORE_LEAVES else (
        "q" if algo == "apex" else "ac", size)
    for tree, path in RL_MORE_LEAVES[key]:
        res[f"param/{tree}/{path}"] = dict(rl_tree_paths(trees[tree]))[path]
    res.update(extra or {})
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def rl_offpolicy_pairs(before: dict, after: dict) -> dict:
    """SAC's, DDPG's and TD3's updates as rl_more_record takes them: the
    actor, the two critics, the targets."""
    def pick(state, keys):
        return {k: state[k] for k in keys}
    targets = [k for k in before if k.endswith("_t")]
    return {"actor": (before["actor"], after["actor"]),
            "critics": (pick(before, ("q1", "q2")), pick(after, ("q1", "q2"))),
            "targets": (pick(before, targets), pick(after, targets))}


def rl_tree_norm(tree: dict) -> np.float32:
    """The global L2 norm of a numpy tree, in float64."""
    return np.float32(np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2)
                                  for _, v in rl_tree_paths(tree))))


def rl_more_outputs(run: str, dev, draws: Optional[dict] = None) -> tuple:
    """The port's outputs for a run of RL_MORE_RUNS on ``dev``, as
    tests/rllib_reference.py records the reference's: (the record, every
    tree before the update, every tree after it).  ``draws``: SAC's and TD3's Gaussian draws,
    JAX's from the reference file."""
    import tempfile as _tmp
    from ray_tpu_torch.rllib import SampleBatch, algorithms, register_env
    from ray_tpu_torch.rllib import models as rl_models
    from ray_tpu_torch.rllib.algorithms.algorithm import grads_with_aux
    from ray_tpu_torch.parallel import transforms as tx
    register_pendulum_lite(register_env)
    rng = np.random.default_rng((RL_SEED, RL_RUNS.index(run)))
    algo_name, size = run.rsplit("_", 1)
    cls = {"sac": algorithms.SACConfig, "ddpg": algorithms.DDPGConfig,
           "td3": algorithms.TD3Config, "marwil": algorithms.MARWILConfig,
           "bc": algorithms.BCConfig, "a3c": algorithms.A3CConfig,
           "apex": algorithms.APEXConfig}[algo_name]
    with _tmp.TemporaryDirectory() as d:
        algo = cls().update(dict(rl_config(run, rl_offline_stub(run, d)),
                                 device=str(dev))).build()
    policy = algo.get_policy()
    to_dev = lambda mb: {k: torch.tensor(v, device=dev)  # noqa: E731
                         for k, v in mb.items()}
    extra = {}
    if algo_name in ("sac", "ddpg", "td3"):
        actor_leaves = [(p, v.shape) for p, v in rl_tree_paths(
            policy.get_weights()["params"])]
        q_leaves = [(p, v.shape) for p, v in rl_tree_paths(
            algo.get_learner_state()["q1"])]
        state = rl_offpolicy_state(run, rng, actor_leaves, q_leaves)
        mbs = rl_minibatches(run, rng, draws, state["actor"])
        policy.set_weights({"params": state["actor"]})
        algo.set_learner_state({k: v for k, v in state.items()
                                if k != "actor"})
        draws = to_dev(draws or {})
        rows = []
        for u, mb in enumerate(mbs):
            if algo_name == "sac":
                rows.append(algo.learn_on(to_dev(mb), draws["next"],
                                          draws["actor"]))
            else:
                rows.append(algo.learn_on(to_dev(mb), draws["noise"][u]
                                          if algo_name == "td3" else None))
        after = dict(algo.get_learner_state(),
                     actor=rl_models.params_to_numpy(policy.params))
        names = ("alpha", "entropy") if algo_name == "sac" \
            else ("critic_loss", "q_mean")
        stats = dict(zip(names, torch.stack(rows).T.cpu().numpy()))
        if algo_name == "sac":
            extra["log_alpha"] = after["log_alpha"]
        return rl_more_record(run, rl_offpolicy_pairs(state, after), after,
                              stats, extra), state, after
    q_net = algo_name == "apex"
    tree = policy.get_weights()
    tree = tree["params"] if q_net else tree
    leaves = [(p, v.shape) for p, v in rl_tree_paths(tree)]
    before = rl_draw_tree(rng, leaves)
    target = rl_draw_tree(rng, leaves) if q_net else None
    mbs = rl_minibatches(run, rng)
    policy.set_weights({"params": before} if q_net else before)
    if algo_name in ("marwil", "bc"):
        mb = mbs[0]
        grads, _ = grads_with_aux(
            algo._loss_fn, policy.params, algo._sq_norm,
            *(torch.from_numpy(mb[k]).to(dev)
              for k in ("obs", "actions", "returns")))
        extra["grad_norm"] = tx.global_norm(grads).cpu().numpy()
        rows = [torch.stack(algo.learn_on(mb)) for mb in mbs]
        stats = dict(zip(("policy_loss", "vf_loss"),
                         torch.stack(rows).T.cpu().numpy()))
        if algo_name == "marwil":
            extra["sq_norm"] = algo._sq_norm.cpu().numpy()
    elif algo_name == "a3c":
        worker = algo.workers.local_worker
        worker.sample = lambda: SampleBatch(dict(mbs[0]))  # the fragment
        grads, count, info = worker.compute_gradients(None, **algo._grad_kw)
        algo.apply_gradients(grads)
        stats = {k: [info[k]] for k in ("policy_loss", "vf_loss",
                                         "entropy")}
        extra["grad_norm"] = rl_tree_norm(grads)
        key = ("ac", size)
        for _, path in RL_MORE_LEAVES[key][:2]:
            extra[f"grad/{path}"] = dict(rl_tree_paths(grads))[path]
    else:
        algo.set_learner_state({"target": target})
        mb = to_dev(mbs[0])
        grads, _ = grads_with_aux(algo._loss_fn, policy.params,
                                  algo.target_params, mb)
        extra["grad_norm"] = tx.global_norm(grads).cpu().numpy()
        extra["td_abs"] = algo._update(policy.params, algo.target_params,
                                       algo._opt_state, mb).cpu().numpy()
        stats = {}
    after = rl_models.params_to_numpy(policy.params)
    return (rl_more_record(run, {"params": (before, after)},
                           {"params": after}, stats, extra),
            {"params": before}, {"params": after})


def rl_outputs(run: str, dev) -> dict:
    """The port's outputs for one run on ``dev`` (numpy arrays), as
    tests/rllib_reference.py records the reference's."""
    from ray_tpu_torch.parallel import transforms as tx
    from ray_tpu_torch.rllib import algorithms, vtrace
    from ray_tpu_torch.rllib import models as rl_models
    from ray_tpu_torch.rllib.algorithms.algorithm import grads_with_aux
    rng = np.random.default_rng((RL_SEED, RL_RUNS.index(run)))
    if run == "vtrace":
        args = {k: torch.from_numpy(v).to(dev)
                for k, v in rl_inputs(run, rng).items()}
        vs, pg_adv = vtrace(**args, **RL_VTRACE_CLIPS)
        return {"vs": vs.cpu().numpy(), "pg_adv": pg_adv.cpu().numpy()}
    algo_name, size = run.rsplit("_", 1)
    cls = {"ppo": algorithms.PPOConfig, "impala": algorithms.IMPALAConfig,
           "appo": algorithms.APPOConfig, "dqn": algorithms.DQNConfig}[
        algo_name.split("_")[0]]
    algo = cls().update(dict(rl_config(run), device=str(dev))).build()
    policy = algo.workers.local_worker.policy
    q_net = algo_name.startswith("dqn")
    shapes = [(p, v.shape) for p, v in rl_tree_paths(
        policy.get_weights()["params"] if q_net else policy.get_weights())]
    before = rl_draw_tree(rng, shapes)
    target = rl_draw_tree(rng, shapes) if q_net else None
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in rl_inputs(run, rng).items()}
    policy.set_weights({"params": before} if q_net else before)
    if algo_name == "ppo":
        learner = algo._learners["default_policy"]
        grads, _ = grads_with_aux(learner["loss_fn"], policy.params, batch,
                                  learner["kl_coeff"])
        stats = learner["update"](policy.params, learner["opt_state"],
                                  batch, learner["kl_coeff"], algo._gen)
        names = ("kl", "entropy", "vf_loss", "policy_loss")
    elif q_net:
        algo.target_params = rl_models.params_from_numpy(
            target, policy.model_config, dev)
        grads, _ = grads_with_aux(algo._loss_fn, policy.params,
                                  algo.target_params, batch)
        stats = algo._update(policy.params, algo.target_params,
                             algo._opt_state, batch)[None]
        names = ("mean_td_error",)
    else:
        grads, _ = grads_with_aux(algo._loss_fn, policy.params, batch)
        stats = algo._update(policy.params, algo._opt_state, batch)
        names = ("policy_loss", "vf_loss", "entropy")
    after = rl_models.params_to_numpy(policy.params)
    res = {f"stat/{n}": v for n, v in zip(names, stats.cpu().numpy())}
    res["grad_norm"] = tx.global_norm(grads).cpu().numpy()
    res["update_norm"] = np.float32(rl_update_norm(before, after))
    by_path = dict(rl_tree_paths(after))
    for p in RL_LEAVES[("q" if q_net else "ac", size)]:
        res[f"param/{p}"] = by_path[p]
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def rl_entry(entry: dict) -> np.ndarray:
    return np.asarray(entry["values"], np.float32).reshape(entry["shape"])


def rl_errors(run: str, ref: dict, dev) -> tuple:
    """(worst error over its limit, that entry, each entry's error): each
    entry's largest error over the reference's largest magnitude.  The
    ``draw/`` entries are inputs: JAX's Gaussian draws, fed to the port."""
    if run in RL_MORE_RUNS:
        got = rl_more_outputs(run, dev, {
            k[5:]: rl_entry(e) for k, e in ref.items()
            if k.startswith("draw/")})[0]
    else:
        got = rl_outputs(run, dev)
    errs = {}
    for key, entry in ref.items():
        if key.startswith("draw/"):
            continue
        r = rl_entry(entry)
        if got[key].shape != r.shape:
            fail(f"rllib {run} {key}: shape {got[key].shape}, reference "
                 f"{r.shape}")
        errs[key] = float(np.abs(got[key] - r).max()
                          / max(np.abs(r).max(), 1e-30))
    ratio = {k: e / (RL_PARAM_TOL if k.startswith("param/")
                     else RL_OUT_TOL) for k, e in errs.items()}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst, errs


def rllib_reference_check(dev, tag: str = "") -> dict:
    """Every run of RL_RUNS on ``dev`` in float32 against the JAX
    package's outputs (RL_REFERENCE), then each planted fault, which must
    fail the same check.  Returns {run or fault: (worst error over its
    limit, entry)}."""
    import importlib
    with open(RL_REFERENCE) as f:
        ref = json.load(f)["runs"]
    out = {}
    for run in RL_RUNS:
        ratio, worst, errs = rl_errors(run, ref[run], dev)
        out[run] = (ratio, worst)
        print(f"rllib_reference {run}: worst {worst} at {ratio:.4g} of its "
              f"limit (params {RL_PARAM_TOL}, other {RL_OUT_TOL}); "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f" [{tag}]", flush=True)
        if not ratio <= 1.0:
            fail(f"rllib {run} disagrees with the JAX reference")
    for fault, (module, attr, plant) in RL_FAULTS.items():
        mod = importlib.import_module(f"ray_tpu_torch.{module}")
        orig = getattr(mod, attr)
        setattr(mod, attr, plant(orig))
        try:
            worst = max(((rl_errors(run, ref[run], dev)[:2], run)
                         for run in RL_FAULT_RUNS[fault]),
                        key=lambda x: x[0][0])
        finally:
            setattr(mod, attr, orig)
        (ratio, entry), run = worst
        out[fault] = (ratio, f"{run} {entry}")
        print(f"rllib_reference control {fault}: worst {run} {entry} at "
              f"{ratio:.4g} of its limit (must exceed 1) [{tag}]",
              flush=True)
        if ratio <= 1.0:
            fail(f"planted fault {fault} passed the rllib reference check")
    return out


# The RLlib phases: BASELINE #3's and #1's learner recipes at full size,
# and DQN, sampling locally (num_workers=0: remote rollout actors wait for
# the runtime).  No hand-written kernel is on this path: the networks are
# cuDNN convolutions and cuBLAS products, as the reference computes them
# outside Pallas; every kernel counter must stay at 0.
#
# IMPALA (BASELINE #3), benchmarks/rllib_bench.py:70-98: RandomPixelEnv
# 84×84×4 uint8, 6 actions, the Nature CNN (conv_dense 512), lr 3e-4,
# num_batches_per_iteration 4; 16 envs × 32 steps = the 512 frames an
# update that the bench assembles from 4 fragments × 4 envs × 32.
IMPALA_PIXEL = {"env": "RandomPixelEnv",
                "env_config": {"size": 84, "frames": 4, "num_actions": 6},
                "num_workers": 0, "num_envs_per_worker": 16,
                "rollout_fragment_length": 32,
                "num_batches_per_iteration": 4, "lr": 3e-4, "seed": SEED}
IMPALA_WALL_S = 10.0
# Step-0 update on the card against the same update on the CPU (same
# weights, same batch): each leaf's optax update (before it is applied),
# relative L2.  float32 on both sides, TF32 off; cuDNN's algorithms sum
# in other orders than the CPU's.  impala_step0_sweep over three sampled
# batches (PERF.md §6): healthy 1.8e-6, 4.6e-5, 2.2e-4 (conv_1/w, a
# gradient summed over 512 frames with cancellation); the flatten-order
# fault 1.69-1.71.
IMPALA_STEP0_TOL = 1e-3
# PPO (BASELINE #1's learner), rllib_bench.py:24-30: train_batch_size
# 2048, num_sgd_iter 8, sgd_minibatch_size 256, lr 3e-4, 8 envs × 256
# steps; on PixelSquareEnv 84×84×4 with the Nature CNN (the card's
# machine has no gymnasium, so no CartPole).  A random policy earns 8 of
# an episode's 16.  PPO must reach PPO_TARGET_REWARD within PPO_ITER_CAP
# iterations: on the card it passed 13 at iteration 6 (7.88, 9.29,
# 10.83, 11.77, 12.74, 13.14), the CPU's run of the recipe at iteration
# 6 too (PERF.md §6); the cap leaves room for another random stream.
PPO_PIXEL = {"env": "PixelSquareEnv",
             "env_config": {"size": 84, "frames": 4},
             "num_workers": 0, "num_envs_per_worker": 8,
             "rollout_fragment_length": 256, "train_batch_size": 2048,
             "num_sgd_iter": 8, "sgd_minibatch_size": 256, "lr": 3e-4,
             "seed": SEED}
PPO_RANDOM_REWARD = 8.0
PPO_TARGET_REWARD = 13.0
PPO_ITER_CAP = 12
# DQN on PixelSquareEnv with the Nature CNN: DQN_UPDATES updates of 32
# frames, the target synced every DQN_TARGET_FREQ.
DQN_PIXEL = {"env": "PixelSquareEnv",
             "env_config": {"size": 84, "frames": 4},
             "num_workers": 0, "num_envs_per_worker": 4,
             "buffer_size": 4096, "learning_starts": 256,
             "train_batch_size": 32, "target_network_update_freq": 10,
             "epsilon_timesteps": 2000, "seed": SEED}
DQN_UPDATES = 40


def zero_kernel_counts() -> None:
    for m, a in kernel_counters().values():
        setattr(m, a, 0)


def rl_kernel_check(label: str) -> None:
    """The RL path launches none of the hand-written kernels: every
    counter is still 0 (zeroed just before the path ran)."""
    moved = {k: getattr(m, a) for k, (m, a) in kernel_counters().items()
             if getattr(m, a)}
    print(f"{label} hand-written kernel launches {moved or 0} (none on "
          f"this path)", flush=True)
    if moved:
        fail(f"{label} launched hand-written kernels: {moved}")


def rl_step0_updates(algo, batch) -> tuple:
    """IMPALA's first update on ``batch`` from a fresh optimizer state:
    (leaf paths, each leaf's optax update (not applied) on the CPU, the
    stats)."""
    from ray_tpu_torch.parallel import transforms as tx
    from ray_tpu_torch.rllib.algorithms.algorithm import grads_with_aux
    params = algo.workers.local_worker.policy.params
    grads, aux = grads_with_aux(algo._loss_fn, params,
                                algo._to_time_major(batch))
    updates, _ = algo._optimizer.update(grads, algo._optimizer.init(params),
                                        params)
    pairs = tx.tree_leaves_with_path(updates)
    return ([p for p, _ in pairs], [u.to("cpu") for _, u in pairs],
            torch.stack(aux).to("cpu"))


def impala_step0_check(algo, cpu_algo, batch, tag: str,
                       fault: Optional[str] = None) -> tuple:
    """The card's step-0 update against the CPU's on the same weights and
    batch: (worst leaf's relative L2, its leaf, stats' worst relative
    error).  ``fault``: one of RL_FAULTS that acts while the update runs
    (the flatten order; the optimizer is built before), planted on the
    card's side."""
    import importlib
    cpu_algo.workers.local_worker.policy.set_weights(algo.get_weights())
    names, ref, ref_stats = rl_step0_updates(cpu_algo, batch)
    orig = None
    if fault is not None:
        module, attr, plant = RL_FAULTS[fault]
        mod = importlib.import_module(f"ray_tpu_torch.{module}")
        orig = getattr(mod, attr)
        setattr(mod, attr, plant(orig))
    try:
        _, got, stats = rl_step0_updates(algo, batch)
    finally:
        if orig is not None:
            setattr(mod, attr, orig)
    errs = rel_l2_errors(got, ref)
    stats_err = float(((stats - ref_stats).abs()
                       / ref_stats.abs().clamp_min(1e-30)).max())
    label = "impala_pixel step0 update" + (f" control {fault}" if fault
                                           else "")
    worst, leaf = grad_report(label, names, errs, IMPALA_STEP0_TOL, tag)
    print(f"{label} stats rel_err {stats_err:.4g} [{tag}]", flush=True)
    return max(worst, stats_err), leaf, stats_err


def impala_step0_sweep(batches: int = 3, tag: str = "") -> list:
    """impala_step0_check on several sampled batches, healthy and with
    the flatten-order fault planted, without failing: the sweep behind
    IMPALA_STEP0_TOL."""
    from ray_tpu_torch._device import disable_tf32
    from ray_tpu_torch.rllib import IMPALAConfig
    disable_tf32()
    dev = torch.device("cuda")
    algo = IMPALAConfig().update(dict(IMPALA_PIXEL,
                                      device=str(dev))).build()
    cpu_algo = IMPALAConfig().update(dict(IMPALA_PIXEL,
                                          device="cpu")).build()
    out = []
    for _ in range(batches):
        batch = algo.workers.local_worker.sample()
        out.append({f: impala_step0_check(algo, cpu_algo, batch, tag, f)[0]
                    for f in (None, "conv_flatten_nchw")})
    print(f"impala_step0_sweep {out} [{tag}]", flush=True)
    return out


def impala_pixel_phase(dev, card, tag: str) -> dict:
    """BASELINE #3's learner on the card: the step-0 update against the
    CPU's (a planted flatten-order fault must fail it), then train() for
    IMPALA_WALL_S of wall time with local sampling; learner update ms
    (wall and device), compute_actions ms, env frames/s, the busy share
    of one profiled update and the peak memory."""
    from ray_tpu_torch.parallel import transforms as tx
    from ray_tpu_torch.rllib import IMPALAConfig
    t0 = time.perf_counter()
    algo = IMPALAConfig().update(dict(IMPALA_PIXEL, device=str(dev))).build()
    cpu_algo = IMPALAConfig().update(dict(IMPALA_PIXEL,
                                          device="cpu")).build()
    policy = algo.workers.local_worker.policy
    n_params = sum(p.numel() for p in tx.tree_leaves(policy.params))
    print(f"impala_pixel config {IMPALA_PIXEL} Nature CNN "
          f"{policy.model_config.conv_filters} dense "
          f"{policy.model_config.conv_dense}: {n_params} params; float32, "
          f"TF32 off [{tag}]", flush=True)
    batch = algo.workers.local_worker.sample()
    worst, leaf, _ = impala_step0_check(algo, cpu_algo, batch, tag)
    control, _, _ = impala_step0_check(algo, cpu_algo, batch, tag,
                                       "conv_flatten_nchw")
    if not worst <= IMPALA_STEP0_TOL:
        fail(f"IMPALA's step-0 update on the card disagrees with the CPU's "
             f"({leaf} {worst})")
    if control <= IMPALA_STEP0_TOL:
        fail("the planted flatten order passed the IMPALA step-0 check")
    del cpu_algo
    check_s = time.perf_counter() - t0
    # -- the main path: train() for a fixed wall budget
    zero_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters, infos = [], []
    t_run = time.perf_counter()
    frames0 = algo.workers.local_worker.get_metrics()["num_env_steps"]
    while time.perf_counter() - t_run < IMPALA_WALL_S:
        t = time.perf_counter()
        r = algo.train()
        iters.append(time.perf_counter() - t)
        infos.append(r["info"])
    wall = time.perf_counter() - t_run
    frames = r["timesteps_total"] - frames0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rl_kernel_check("impala_pixel")
    if not all(math.isfinite(i[k]) for i in infos
               for k in ("policy_loss", "vf_loss", "entropy")):
        fail(f"impala_pixel: non-finite learner stats {infos[-1]}")
    # -- the learner update alone, on one 512-frame batch, and acting
    learn = lambda: algo._learn_on(batch)            # noqa: E731
    learn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        learn()
    torch.cuda.synchronize()
    update_wall_ms = (time.perf_counter() - t) * 1e2
    obs = batch["obs"][:IMPALA_PIXEL["num_envs_per_worker"]]
    policy.compute_actions(obs)
    t = time.perf_counter()
    for _ in range(50):
        policy.compute_actions(obs)
    act_ms = (time.perf_counter() - t) * 20
    prof = profile_once("impala_pixel_update", learn, tag)
    res = dict(check_s=check_s, step0_rel_err=worst, step0_worst_leaf=leaf,
               step0_tol=IMPALA_STEP0_TOL,
               step0_control_flatten_nchw=control,
               iterations=len(iters), wall_s=wall, env_frames=frames,
               env_frames_per_s=frames / wall,
               iteration_ms=1e3 * sum(iters[1:]) / max(len(iters) - 1, 1),
               update_wall_ms=update_wall_ms,
               update_device_ms=prof["device_ms"], update_busy=prof["busy"],
               compute_actions_ms=act_ms, peak_mem_gb=peak_gb,
               last_info=infos[-1], launches={})
    for k, val in res.items():
        print(f"impala_pixel {k} {val} [{tag}]", flush=True)
    del algo, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ppo_pixel_phase(dev, card, tag: str) -> dict:
    """BASELINE #1's learner settings on PixelSquareEnv with the Nature
    CNN: train() until the episode reward reaches PPO_TARGET_REWARD (a
    random policy earns PPO_RANDOM_REWARD) within PPO_ITER_CAP
    iterations; update ms and iteration ms."""
    from ray_tpu_torch.rllib import PPOConfig
    algo = PPOConfig().update(dict(PPO_PIXEL, device=str(dev))).build()
    learner = algo._learners["default_policy"]
    update = learner["update"]
    update_s = []

    def timed_update(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*a)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t)
        return out

    learner["update"] = timed_update
    zero_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    rewards, iters = [], []
    for _ in range(PPO_ITER_CAP):
        t = time.perf_counter()
        r = algo.train()
        iters.append(time.perf_counter() - t)
        rewards.append(r["episode_reward_mean"])
        print(f"ppo_pixel iteration {r['training_iteration']} reward "
              f"{rewards[-1]:.4g} kl {r['info']['kl']:.4g} iteration_ms "
              f"{iters[-1] * 1e3:.5g} update_ms {update_s[-1] * 1e3:.5g} "
              f"[{tag}]", flush=True)
        if rewards[-1] >= PPO_TARGET_REWARD:
            break
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rl_kernel_check("ppo_pixel")
    learner["update"] = update
    if not rewards[-1] >= PPO_TARGET_REWARD:
        fail(f"PPO did not reach {PPO_TARGET_REWARD} (random "
             f"{PPO_RANDOM_REWARD}) in {PPO_ITER_CAP} iterations: "
             f"{rewards}")
    batch = algo.workers.local_worker.sample()
    from ray_tpu_torch.rllib.algorithms.ppo import LEARNER_COLUMNS, \
        device_batch
    dbatch = device_batch(batch, LEARNER_COLUMNS, dev)
    prof = profile_once("ppo_pixel_update", lambda: update(
        algo.get_policy().params, learner["opt_state"], dbatch,
        learner["kl_coeff"], algo._gen), tag)
    res = dict(rewards=rewards, iterations=len(rewards),
               iteration_ms=1e3 * sum(iters[1:]) / max(len(iters) - 1, 1),
               update_ms=1e3 * sum(update_s[1:]) / max(len(update_s) - 1,
                                                       1),
               update_device_ms=prof["device_ms"], update_busy=prof["busy"],
               peak_mem_gb=peak_gb, launches={})
    for k, val in res.items():
        print(f"ppo_pixel {k} {val} [{tag}]", flush=True)
    del algo, batch, dbatch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dqn_pixel_phase(dev, card, tag: str) -> dict:
    """DQN on PixelSquareEnv with the Nature CNN for DQN_UPDATES updates:
    every TD error finite, the target a copy of the params taken every
    ``target_network_update_freq`` updates (equal right after a sync,
    apart after every other update)."""
    from ray_tpu_torch.parallel import transforms as tx
    from ray_tpu_torch.rllib import DQNConfig
    algo = DQNConfig().update(dict(DQN_PIXEL, device=str(dev))).build()
    policy = algo.get_policy()
    freq = DQN_PIXEL["target_network_update_freq"]

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in
                   zip(tx.tree_leaves(a), tx.tree_leaves(b)))

    zero_kernel_counts()
    tds, step_s, updates, synced_equal, apart = [], [], 0, 0, 0
    while updates < DQN_UPDATES:
        syncs = algo.target_syncs
        t = time.perf_counter()
        info = algo.train()["info"]
        step_s.append(time.perf_counter() - t)
        if "mean_td_error" not in info:
            continue
        updates += 1
        tds.append(info["mean_td_error"])
        if algo.target_syncs != updates // freq:
            fail(f"dqn_pixel: {algo.target_syncs} target syncs after "
                 f"{updates} updates (every {freq})")
        if algo.target_syncs > syncs:
            synced_equal += same(algo.target_params, policy.params)
        else:
            apart += not same(algo.target_params, policy.params)
    rl_kernel_check("dqn_pixel")
    if not all(math.isfinite(x) for x in tds):
        fail(f"dqn_pixel: non-finite TD error {tds}")
    if synced_equal != DQN_UPDATES // freq or \
            apart != DQN_UPDATES - DQN_UPDATES // freq:
        fail(f"dqn_pixel: the target equals the params after "
             f"{synced_equal} syncs, differs after {apart} other updates")
    res = dict(updates=updates, target_syncs=algo.target_syncs,
               td_first=tds[0], td_last=tds[-1],
               train_step_ms=1e3 * sum(step_s[-10:]) / 10, launches={})
    for k, val in res.items():
        print(f"dqn_pixel {k} {val} [{tag}]", flush=True)
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return res


# The rest of RLlib on one card: SAC, TD3, MARWIL/BC over offline data,
# and the local paths of A3C and Ape-X.  No hand-written kernel is on
# these paths either (catalog MLPs and the Nature CNN: cuBLAS products,
# cuDNN convolutions); every kernel counter must stay at 0.
#
# SAC and TD3 with their configs' defaults ((256, 256), batch 256,
# buffer 100k, learning_starts 256, fragment 1, one update an env step)
# on PendulumLite, gymnasium's Pendulum-v1 copied (the card's machine has
# no gymnasium).  SAC's step-0 update on the card against the CPU's (same
# weights, batch and draws): each leaf's update (after − before),
# relative L2, limit SAC_STEP0_TOL; a swapped Polyak average on the
# card's side must fail it.  sac_step0_sweep over three sampled batches
# (PERF.md §6): healthy 1.6e-6 to 1.9e-3 over two sweeps, the worst
# mostly a target leaf (a target moves by tau·(critic − target), ~1.5e-6
# a weight at step 0, of which one float32 ulp of a 0.1 weight is 0.5 %);
# the swapped Polyak 198.  Adam's first step is about −lr·sign(g), so the
# update holds the gradients' signs only; the same call also holds each
# loss's gradient leaf by leaf and the returned (alpha, entropy), limit
# SAC_GRAD_TOL, which TF32 matmuls on the card's side must fail.  Its
# sweep: healthy 2.8e-7, 2.6e-7, 5.7e-6 (log_alpha's gradient, a mean of
# 256 log-probabilities); TF32 3.9e-4, 6.7e-4, 8.3e-4, while TF32's
# update stays inside SAC_STEP0_TOL (7.8e-3, 2.3e-3, 1.6e-3).  The limit
# is their geometric middle.  Then SAC_STEPS env steps through train();
# the mean return of the last SAC_LAST_EPISODES episodes must beat a
# random policy's (PENDULUM_RANDOM_EPISODES uniform-torque episodes,
# measured in the phase: −1,112) by SAC_MARGIN.  The CPU's runs of the
# recipe (PERF.md §6) reached −152 (seed 0) and −157 (seed 1) over their
# last five episodes; the card's first run −643 at 4,000 steps, still
# rising.
SAC_PENDULUM = {"env": "PendulumLite", "num_workers": 0, "seed": SEED}
SAC_STEP0_TOL = 1e-2
SAC_GRAD_TOL = 5e-5
SAC_STEPS = 5000
SAC_LAST_EPISODES = 5
SAC_MARGIN = 400.0
PENDULUM_RANDOM_EPISODES = 20
TD3_PENDULUM = dict(SAC_PENDULUM)
TD3_STEPS = 1000
# TD3's delay is watched over this many updates (each a host read of the
# actor and its Adam count), then the budget runs unwatched.
TD3_WATCH = 16
# bench_marwil (benchmarks/rllib_bench.py:450-489): 80 episodes recorded
# by an untrained policy, then MARWIL (β 1) and BC (β 0) at
# train_batch_size 512, 50 updates an iteration.  Cut: RandomEnv (obs 4,
# 2 actions, 20 steps) in CartPole's place (no gymnasium on the card's
# machine); the recorder acts greedily (explore=False), so the actions are
# a function of the observation that BC can learn.
MARWIL_ENV = {"env": "RandomEnv",
              "env_config": {"obs_dim": 4, "num_actions": 2,
                             "episode_len": 20}}
MARWIL_EPISODES = 80
MARWIL_ITERS = 4
# A3C's local mode and Ape-X's single-process path on PixelSquareEnv
# 84×84×4 with the Nature CNN.
A3C_PIXEL = {"env": "PixelSquareEnv", "env_config": {"size": 84, "frames": 4},
             "num_workers": 0, "num_envs_per_worker": 4,
             "rollout_fragment_length": 32, "grads_per_iteration": 4,
             "seed": SEED}
A3C_ITERS = 3
APEX_PIXEL = {"env": "PixelSquareEnv",
              "env_config": {"size": 84, "frames": 4},
              "num_workers": 0, "seed": SEED}
APEX_ITERS = 100


def pendulum_random_return(episodes: int = PENDULUM_RANDOM_EPISODES) -> float:
    """The mean return of uniform random torques on PendulumLite."""
    rng = np.random.default_rng(SEED)
    env, total = PendulumLite(), 0.0
    for ep in range(episodes):
        env.reset(seed=10_000 + ep)
        done = False
        while not done:
            _, r, term, trunc, _ = env.step(rng.uniform(-2.0, 2.0, (1,)))
            total += r
            done = term or trunc
    return total / episodes


def mem_base() -> int:
    """The bytes allocated on the card now, with the peak counter reset: a
    phase's own peak is the peak above this (``peak_above_gb``), not what
    earlier phases left allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above_gb(base: int) -> float:
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def timed_update(label: str, fn, tag: str, calls: int = 20) -> dict:
    """An update alone: wall ms over ``calls`` calls after a warm one,
    each ending in a synchronize, and one under the profiler (device ms,
    busy share)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / calls
    prof = profile_once(f"{label}_update", fn, tag)
    return dict(update_wall_ms=wall_ms, update_device_ms=prof["device_ms"],
                update_busy=prof["busy"])


def _tree_step(before: dict, after: dict) -> dict:
    """path → after − before of two numpy trees."""
    b = dict(rl_tree_paths(before))
    return {p: np.asarray(a, np.float64) - b[p]
            for p, a in rl_tree_paths(after)}


def _sac_state(algo) -> dict:
    from ray_tpu_torch.rllib import models as rl_models
    return dict(algo.get_learner_state(),
                actor=rl_models.params_to_numpy(algo.get_policy().params))


def _sac_polyak_swapped(f):
    """Polyak averaging with the weights swapped: (1 − tau)·s + tau·t."""
    def polyak(target, source, tau):
        f(target, source, 1 - tau)
    return polyak


def _host_tree(tree) -> dict:
    """path → float64 numpy of a dict of tensors."""
    return {p: v.detach().double().cpu().numpy()
            for p, v in rl_tree_paths(tree)}


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def sac_step0_check(algo, cpu_algo, mb: dict, tag: str,
                    fault: Optional[str] = None) -> dict:
    """The card's first SAC update against the CPU's from the same state,
    minibatch and draws, two ways: ``update``, each leaf's update (after −
    before, relative L2); ``grads``, the three losses' gradients leaf by
    leaf (critics, actor against the updated critics, log_alpha) and the
    returned (alpha, entropy), which keep the magnitude that Adam's
    sign-like first step drops.  Each → (worst relative L2, its leaf).
    ``fault`` on the card's side: "polyak" (the Polyak average swapped) or
    "tf32" (TF32 matmuls)."""
    import importlib
    from ray_tpu_torch._device import disable_tf32
    sac = importlib.import_module("ray_tpu_torch.rllib.algorithms.sac")
    state = _sac_state(algo)
    cpu_algo.get_policy().set_weights({"params": state["actor"]})
    cpu_algo.set_learner_state({k: v for k, v in state.items()
                                if k != "actor"})
    gen = torch.Generator(device=algo.get_policy().device).manual_seed(SEED)
    shape = (len(mb["obs"]), algo.get_policy().act_dim)
    eps = [torch.randn(shape, generator=gen, device=gen.device)
           for _ in range(2)]
    orig_polyak, orig_grads = sac.polyak, sac.grads_with_aux

    def learn(a, draws):
        """One update; the gradients of its three losses, in order, and
        the returned stats."""
        seen = []

        def recording(loss_fn, params, *args):
            grads, aux = orig_grads(loss_fn, params, *args)
            seen.append(_host_tree(grads))
            return grads, aux

        sac.grads_with_aux = recording
        try:
            stats = a.learn_on(sac.device_minibatch(
                mb, a.get_policy().device), *draws)
        finally:
            sac.grads_with_aux = orig_grads
        return seen, stats.cpu().numpy()

    ref_grads, ref_stats = learn(cpu_algo, [e.to("cpu") for e in eps])
    if fault == "polyak":
        sac.polyak = _sac_polyak_swapped(orig_polyak)
    if fault == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got_grads, got_stats = learn(algo, eps)
    finally:
        sac.polyak = orig_polyak
        disable_tf32()
    got, ref = _sac_state(algo), _sac_state(cpu_algo)
    names, errs = [], []
    for k in ("actor", "q1", "q2", "q1_t", "q2_t"):
        g, r = _tree_step(state[k], got[k]), _tree_step(state[k], ref[k])
        for p in r:
            names.append(f"{k}/{p}")
            errs.append(_rel_l2(g[p], r[p]))
    names.append("log_alpha")
    errs.append(_rel_l2(float(got["log_alpha"]) - float(state["log_alpha"]),
                        float(ref["log_alpha"]) - float(state["log_alpha"])))
    g_names, g_errs = [], []
    for loss, g, r in zip(("critic", "actor", "alpha"), got_grads, ref_grads):
        for p in r:
            g_names.append(f"grad {loss}/{p}")
            g_errs.append(_rel_l2(g[p], r[p]))
    for i, s in enumerate(sac.STATS):
        g_names.append(f"stat {s}")
        g_errs.append(_rel_l2(got_stats[i], ref_stats[i]))
    # back to the state the check started from, for the next call
    for a in (algo, cpu_algo):
        a.get_policy().set_weights({"params": state["actor"]})
        a.set_learner_state({k: v for k, v in state.items()
                             if k != "actor"})
    label = "sac_pendulum step0" + (f" control {fault}" if fault else "")
    return {"update": grad_report(f"{label} update", names, errs,
                                  SAC_STEP0_TOL, tag),
            "grads": grad_report(f"{label} grads", g_names, g_errs,
                                 SAC_GRAD_TOL, tag)}


def sac_step0_sweep(batches: int = 3, tag: str = "") -> list:
    """sac_step0_check on several sampled minibatches, healthy and with
    each fault planted, without failing: the sweep behind SAC_STEP0_TOL
    and SAC_GRAD_TOL."""
    from ray_tpu_torch._device import disable_tf32
    from ray_tpu_torch.rllib import SACConfig, register_env
    disable_tf32()
    register_pendulum_lite(register_env)
    algo = SACConfig().update(dict(SAC_PENDULUM, device="cuda")).build()
    cpu_algo = SACConfig().update(dict(SAC_PENDULUM, device="cpu")).build()
    out = []
    for i in range(batches):
        mb = _pendulum_minibatch(algo, seed=i)
        out.append({f: {k: v[0] for k, v in
                        sac_step0_check(algo, cpu_algo, mb, tag, f).items()}
                    for f in (None, "polyak", "tf32")})
    print(f"sac_step0_sweep {out} [{tag}]", flush=True)
    return out


def _pendulum_minibatch(algo, seed: int = 0) -> dict:
    """learning_starts env steps sampled by ``algo``'s worker (what its
    buffer holds when the first update comes), as one minibatch."""
    from ray_tpu_torch.rllib import concat_samples
    w = algo.workers.local_worker
    n = int(algo.config["learning_starts"])
    b = concat_samples([w.sample() for _ in range(
        -(-n // w.fragment_length))])
    rows = np.random.default_rng(seed).permutation(b.count)[:n]
    return {k: b[k][rows] for k in ("obs", "raw_action", "rewards",
                                    "new_obs", "terminateds")}


def continuous_run(label: str, algo, steps: int, tag: str, base: int,
                   after_step=None) -> dict:
    """``steps`` train() calls on the card from zeroed kernel counters:
    returns of the episodes that ended, each call's wall time, the last
    info; then the update alone (wall over 20 calls, and one profiled),
    compute_actions on one observation, the peak memory above ``base``
    (``mem_base()`` before the algorithm was built)."""
    policy = algo.get_policy()
    zero_kernel_counts()
    rets, step_s, info = [], [], {}
    t_run = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        r = algo.train()
        step_s.append(time.perf_counter() - t)
        info = r["info"]
        if r["episodes_this_iter"]:
            rets.append(r["episode_reward_mean"])
        if after_step is not None:
            after_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    peak_gb = peak_above_gb(base)
    rl_kernel_check(label)
    from ray_tpu_torch.rllib import SAC
    from ray_tpu_torch.rllib.algorithms.sac import device_minibatch
    n = int(algo.config["train_batch_size"])
    mb = device_minibatch(algo.buffer.sample(n, np.random.default_rng(SEED)),
                          policy.device)
    gen = torch.Generator(device=policy.device).manual_seed(SEED)
    draws = [torch.randn((n, policy.act_dim), generator=gen,
                         device=gen.device) for _ in range(2)]
    learn = (lambda: algo.learn_on(mb, *draws)) if isinstance(algo, SAC) \
        else (lambda: algo.learn_on(mb, draws[0]))
    update = timed_update(label, learn, tag)
    obs = algo.buffer.sample(1, np.random.default_rng(SEED))["obs"]
    policy.compute_actions(obs)
    t = time.perf_counter()
    for _ in range(100):
        policy.compute_actions(obs)
    act_ms = (time.perf_counter() - t) * 10
    return dict(steps=steps, wall_s=wall, env_steps_per_s=steps / wall,
                train_step_ms=1e3 * sum(step_s[-500:]) / len(step_s[-500:]),
                **update, compute_actions_ms=act_ms, peak_mem_gb=peak_gb,
                episodes=len(rets), returns=rets, last_info=info)


def sac_pendulum_phase(dev, card, tag: str) -> dict:
    """SAC's defaults on PendulumLite: the step-0 update against the
    CPU's (the swapped Polyak must fail it), then SAC_STEPS env steps
    through train(); the last episodes' mean return must beat a random
    policy's by SAC_MARGIN, alpha stays > 0 and the entropy finite."""
    from ray_tpu_torch.rllib import SACConfig, register_env
    register_pendulum_lite(register_env)
    t0 = time.perf_counter()
    algo = SACConfig().update(dict(SAC_PENDULUM, device=str(dev))).build()
    cpu_algo = SACConfig().update(dict(SAC_PENDULUM, device="cpu")).build()
    mb = _pendulum_minibatch(algo)
    healthy = sac_step0_check(algo, cpu_algo, mb, tag)
    polyak = sac_step0_check(algo, cpu_algo, mb, tag, "polyak")
    tf32 = sac_step0_check(algo, cpu_algo, mb, tag, "tf32")
    (worst, leaf), (g_worst, g_leaf) = healthy["update"], healthy["grads"]
    if not worst <= SAC_STEP0_TOL:
        fail(f"SAC's step-0 update on the card disagrees with the CPU's "
             f"({leaf} {worst})")
    if not g_worst <= SAC_GRAD_TOL:
        fail(f"SAC's step-0 gradients on the card disagree with the CPU's "
             f"({g_leaf} {g_worst})")
    if polyak["update"][0] <= SAC_STEP0_TOL:
        fail("the swapped Polyak average passed the SAC step-0 check")
    if tf32["grads"][0] <= SAC_GRAD_TOL:
        fail("TF32 matmuls passed the SAC step-0 gradient check")
    del algo, cpu_algo
    check_s = time.perf_counter() - t0
    random_return = pendulum_random_return()
    base = mem_base()
    algo = SACConfig().update(dict(SAC_PENDULUM, device=str(dev))).build()
    res = continuous_run("sac_pendulum", algo, SAC_STEPS, tag, base)
    last = float(np.mean(res["returns"][-SAC_LAST_EPISODES:]))
    info = res.pop("last_info")
    res.update(check_s=check_s, step0_rel_err=worst, step0_worst_leaf=leaf,
               step0_tol=SAC_STEP0_TOL,
               step0_control_polyak_swapped=polyak["update"][0],
               step0_grads_rel_err=g_worst, step0_grads_worst_leaf=g_leaf,
               step0_grads_tol=SAC_GRAD_TOL,
               step0_control_tf32_grads=tf32["grads"][0],
               step0_control_tf32_update=tf32["update"][0],
               random_return=random_return, last_return=last,
               alpha=info["alpha"], entropy=info["entropy"])
    for k, val in res.items():
        print(f"sac_pendulum {k} {val} [{tag}]", flush=True)
    if not last > random_return + SAC_MARGIN:
        fail(f"SAC's last {SAC_LAST_EPISODES} returns {last:.1f} do not beat "
             f"the random policy's {random_return:.1f} by {SAC_MARGIN}")
    if not (info["alpha"] > 0 and math.isfinite(info["entropy"])):
        fail(f"sac_pendulum: alpha {info['alpha']} entropy {info['entropy']}")
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return res


def td3_pendulum_phase(dev, card, tag: str) -> dict:
    """TD3's defaults on PendulumLite for TD3_STEPS env steps: scaled
    actions inside the bounds and raw ones inside [-1, 1]; over the first
    TD3_WATCH updates the actor, its Adam count and its target move on
    exactly every second update (the first included) and stay bitwise
    still on the others."""
    from ray_tpu_torch.rllib import TD3Config, register_env
    from ray_tpu_torch.rllib import models as rl_models
    register_pendulum_lite(register_env)
    base = mem_base()
    algo = TD3Config().update(dict(TD3_PENDULUM, device=str(dev))).build()
    policy = algo.get_policy()
    watched = []

    def snapshot():
        count = algo._actor_state[0]["count"].item()
        return (rl_models.params_to_numpy(policy.params),
                rl_models.params_to_numpy(algo.actor_t), count)

    prev = [snapshot()]

    def watch():
        """(update index, actor moved, target moved, Adam count step)."""
        n = algo._n_updates
        if n == 0 or len(watched) >= TD3_WATCH:
            return
        now = snapshot()
        moved = [any(not np.array_equal(a, b) for (_, a), (_, b) in zip(
            rl_tree_paths(x), rl_tree_paths(y))) for x, y in
            zip(now[:2], prev[0][:2])]
        watched.append((n - 1, moved[0], moved[1], now[2] - prev[0][2]))
        prev[0] = now

    res = continuous_run("td3_pendulum", algo, TD3_STEPS, tag, base, watch)
    # an actor step on every even update (the first included), none else
    bad = [w for w in watched
           if w[1:] != (w[0] % 2 == 0,) * 2 + (int(w[0] % 2 == 0),)]
    obs = algo.buffer.sample(256, np.random.default_rng(SEED))["obs"]
    acts, extras = policy.compute_actions(obs)
    raw = algo.buffer._cols["raw_action"][:len(algo.buffer)]
    in_bounds = bool((acts >= policy.low).all() and (acts <= policy.high).all()
                     and np.abs(extras["raw_action"]).max() <= 1.0
                     and np.abs(raw).max() <= 1.0)
    info = res.pop("last_info")
    res.update(watched_updates=len(watched), delay_violations=bad,
               actions_in_bounds=in_bounds, critic_loss=info["critic_loss"],
               q_mean=info["q_mean"], num_updates=info["num_updates"])
    for k, val in res.items():
        print(f"td3_pendulum {k} {val} [{tag}]", flush=True)
    if len(watched) != TD3_WATCH or bad:
        fail(f"td3_pendulum: the actor did not step on exactly every second "
             f"update: {watched}")
    if not in_bounds:
        fail("td3_pendulum: an action left its bounds")
    if not all(math.isfinite(info[k]) for k in ("critic_loss", "q_mean")):
        fail(f"td3_pendulum: non-finite learner stats {info}")
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _dataset_nll(algo) -> float:
    """The mean negative log-likelihood of the whole dataset's actions
    under ``algo``'s policy."""
    from ray_tpu_torch.rllib.policy import to_device
    policy = algo.get_policy()
    with torch.no_grad():
        inputs, _ = policy.apply_fn(policy.params, to_device(
            algo.data.obs, policy.device))
        return float(-policy.dist_class.logp(inputs, to_device(
            algo.data.actions, policy.device)).mean())


def offline_marwil_phase(dev, card, tag: str) -> dict:
    """bench_marwil's recipe: MARWIL_EPISODES episodes recorded by an
    untrained policy (``record_rollouts``), then MARWIL (β 1) and BC (β 0)
    for MARWIL_ITERS iterations each after a warm one: updates/s and
    trained steps/s, one update alone (wall, device, busy share), the peak
    memory above the phase's start; BC's NLL of the dataset must fall
    below the untrained policy's."""
    from ray_tpu_torch.rllib import BCConfig, MARWILConfig, Policy
    from ray_tpu_torch.rllib import env as rl_env
    from ray_tpu_torch.rllib.offline import record_rollouts
    res = {}
    with tempfile.TemporaryDirectory() as data_dir:
        e = rl_env.create_env(MARWIL_ENV["env"], MARWIL_ENV["env_config"])
        recorder = Policy(e.observation_space, e.action_space,
                          {"seed": SEED + 1, "device": str(dev)})
        t = time.perf_counter()
        res["recorded_steps"] = record_rollouts(
            recorder, MARWIL_ENV["env"], data_dir,
            episodes=MARWIL_EPISODES, env_config=MARWIL_ENV["env_config"],
            explore=False, seed=SEED)
        res["record_s"] = time.perf_counter() - t
        for label, cls in (("marwil_beta1", MARWILConfig),
                           ("bc_beta0", BCConfig)):
            base = mem_base()
            algo = cls().update(dict(MARWIL_ENV, input=data_dir,
                                     train_batch_size=512,
                                     updates_per_iteration=50, seed=SEED,
                                     device=str(dev))).build()
            nll0 = _dataset_nll(algo)
            zero_kernel_counts()
            algo.train()                              # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            trained0 = algo._trained
            losses = [algo.train()["info"]["policy_loss"]
                      for _ in range(MARWIL_ITERS)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            rl_kernel_check(f"offline_marwil {label}")
            res[label] = dict(
                updates_per_s=50 * MARWIL_ITERS / wall,
                trained_steps_per_s=(algo._trained - trained0) / wall,
                policy_loss=losses, nll_untrained=nll0,
                nll_trained=_dataset_nll(algo), batch_size=512)
            rng = np.random.default_rng(SEED)
            # the host minibatch as training_step makes it, its upload
            # inside the update
            res[label].update(timed_update(
                f"offline_marwil_{label}",
                lambda: algo.learn_on(algo.data.minibatch(rng, 512)), tag))
            res[label]["peak_mem_gb"] = peak_above_gb(base)
            if not all(math.isfinite(x) for x in losses):
                fail(f"offline_marwil {label}: non-finite loss {losses}")
            del algo
    for k, val in res.items():
        print(f"offline_marwil {k} {val} [{tag}]", flush=True)
    bc = res["bc_beta0"]
    if not bc["nll_trained"] < bc["nll_untrained"]:
        fail(f"BC's dataset NLL {bc['nll_trained']} did not fall below the "
             f"untrained policy's {bc['nll_untrained']}")
    return res


def a3c_pixel_phase(dev, card, tag: str) -> dict:
    """A3C's local mode on PixelSquareEnv with the Nature CNN: A3C_ITERS
    iterations of grads_per_iteration (compute_gradients, apply) pairs;
    one such update under the profiler (device ms, busy share); the
    gradient's device → numpy → device round trip (the reference's
    contract) timed on its own; the peak memory above the phase's
    start."""
    from ray_tpu_torch.rllib import A3CConfig
    from ray_tpu_torch.rllib import models as rl_models
    base = mem_base()
    algo = A3CConfig().update(dict(A3C_PIXEL, device=str(dev))).build()
    worker, policy = algo.workers.local_worker, algo.get_policy()
    before = rl_models.params_to_numpy(policy.params)
    algo.train()                                      # warm
    zero_kernel_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    infos = [algo.train()["info"] for _ in range(A3C_ITERS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rl_kernel_check("a3c_pixel")
    steps = A3C_ITERS * A3C_PIXEL["grads_per_iteration"] * \
        A3C_PIXEL["num_envs_per_worker"] * A3C_PIXEL["rollout_fragment_length"]
    prof = profile_once("a3c_pixel_update", lambda: algo.apply_gradients(
        worker.compute_gradients(None, **algo._grad_kw)[0]), tag)
    grads, _, _ = worker.compute_gradients(None, **algo._grad_kw)
    g_dev = rl_models.params_from_numpy(grads, policy.model_config, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        rl_models.params_from_numpy(rl_models.params_to_numpy(g_dev),
                                    policy.model_config, dev)
    torch.cuda.synchronize()
    round_trip_ms = (time.perf_counter() - t) * 100
    t = time.perf_counter()
    for _ in range(10):
        algo.apply_gradients(grads)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t) * 100
    moved = rl_tree_norm(_tree_step(before,
                                    rl_models.params_to_numpy(policy.params)))
    res = dict(iterations=A3C_ITERS, wall_s=wall, env_steps_per_s=steps / wall,
               update_ms=1e3 * wall / (A3C_ITERS *
                                       A3C_PIXEL["grads_per_iteration"]),
               update_device_ms=prof["device_ms"], update_busy=prof["busy"],
               grad_round_trip_ms=round_trip_ms, apply_ms=apply_ms,
               grad_mb=sum(v.nbytes for _, v in rl_tree_paths(grads)) / 1e6,
               peak_mem_gb=peak_above_gb(base), params_moved=float(moved),
               last_info=infos[-1])
    for k, val in res.items():
        print(f"a3c_pixel {k} {val} [{tag}]", flush=True)
    if not all(math.isfinite(v) for v in infos[-1].values()) or \
            not moved > 0:
        fail(f"a3c_pixel: stats {infos[-1]}, params moved {moved}")
    del algo, g_dev
    gc.collect()
    torch.cuda.empty_cache()
    return res


def apex_pixel_phase(dev, card, tag: str) -> dict:
    """Ape-X's single-process path (APEXConfig defaults, num_workers=0) on
    PixelSquareEnv with the Nature CNN for APEX_ITERS iterations: the
    sampled rows' priorities change after their updates, the target
    syncs every target_network_update_freq updates; the prioritized
    sample and the update timed on their own (the update also under the
    profiler); the peak memory above the phase's start."""
    from ray_tpu_torch.rllib import APEXConfig
    base = mem_base()
    algo = APEXConfig().update(dict(APEX_PIXEL, device=str(dev))).build()
    freq = int(algo.config["target_network_update_freq"])
    replay = algo._local_replay
    zero_kernel_counts()
    t = time.perf_counter()
    infos = [algo.train()["info"] for _ in range(APEX_ITERS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rl_kernel_check("apex_pixel")
    updates = algo._updates
    n = int(algo.config["train_batch_size"])
    beta = float(algo.config["prioritized_replay_beta"])
    cols, idx, w = replay.sample(n, beta)
    prio0 = replay._prio[idx].copy()
    t = time.perf_counter()
    for _ in range(20):
        replay.sample(n, beta)
    sample_ms = (time.perf_counter() - t) * 50
    algo._learn(cols, idx, w)
    changed = int((replay._prio[idx] != prio0).sum())
    syncs = algo.target_syncs
    # the timed updates run after the schedule's check is read
    update = timed_update("apex_pixel", lambda: algo._learn(cols, idx, w), tag)
    res = dict(iterations=APEX_ITERS, wall_s=wall,
               env_steps=infos[-1]["num_env_steps_sampled"],
               env_steps_per_s=infos[-1]["num_env_steps_sampled"] / wall,
               learner_updates=updates, target_syncs=syncs,
               prioritized_sample_ms=sample_ms, **update,
               peak_mem_gb=peak_above_gb(base),
               priorities_changed=changed, batch=n,
               mean_td_error=infos[-1].get("mean_td_error"))
    for k, val in res.items():
        print(f"apex_pixel {k} {val} [{tag}]", flush=True)
    if syncs != (updates + 1) // freq or updates < freq:
        fail(f"apex_pixel: {syncs} target syncs after "
             f"{updates + 1} updates (every {freq})")
    if changed == 0 or not math.isfinite(res["mean_td_error"]):
        fail(f"apex_pixel: priorities changed {changed}, "
             f"td {res['mean_td_error']}")
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return res


# The weights-plane phase: a child process attaches to what an engine in
# this one published.  Its private init is stamped (+1 on every leaf), so
# only an attach can give it the publisher's bytes.
WEIGHTS_CHILD = """
import hashlib, sys, torch
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

from ray_tpu_torch.models._common import tree_map

init = gpt2.init_params
def stamped(gen, cfg, device):
    p = init(gen, cfg, device=device)
    if device.type == "meta":
        return p
    print("private init taken", file=sys.stderr, flush=True)
    return tree_map(lambda t: t + 1, p)
gpt2.init_params = stamped
cfg = eval(sys.argv[1], {"EngineConfig": EngineConfig})
eng = LLMEngine(cfg, start=False)
p = eng.runner.params
for name, t in (("wte", p["wte"]),
                ("blocks.mlp_in.kernel", p["blocks"]["mlp_in"]["kernel"])):
    print(name, t.device.type, hashlib.sha256(
        t.cpu().numpy().tobytes()).hexdigest(), flush=True)
eng.shutdown()
"""


def weights_phase(dev, tag: str) -> dict:
    """GPT-2 124M's params (0.5 GB of f32) through the shm weights plane:
    an LLMEngine with share_weights=True publishes; an engine in a child
    process attaches and must hold wte and a block matrix bitwise equal to
    the publisher's (its private init is stamped, so only the attach can
    give them); shutdown releases the segment."""
    import gc
    import hashlib
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, weights
    shm = weights._shm_dir()
    if str(shm) != os.environ.get("RTPU_SHM_DIR"):
        fail("the weights plane is not in this run's own RTPU_SHM_DIR")
    st = os.statvfs(shm)
    print(f"weights shm_dir {shm} free_gb {st.f_bavail * st.f_frsize / 1e9:.2f}"
          f" [{tag}]", flush=True)
    cfg = EngineConfig(model="gpt2:gpt2-124m", num_blocks=64,
                       max_num_seqs=16, max_model_len=1024,
                       max_prefill_tokens=1024,
                       prefill_len_buckets=(64, 128, 256, 512, 1024),
                       share_weights=True, seed=SEED)
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, start=False, device=dev)
    try:
        key = eng.runner.weights_key
        seg = weights._seg_path(key, os.getpid())
        if not os.path.exists(seg + ".ready"):
            fail(f"the engine did not publish {seg}")
        publish_s = time.perf_counter() - t0
        p = eng.runner.params
        want = {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                for name, t in (("wte", p["wte"]), ("blocks.mlp_in.kernel",
                                p["blocks"]["mlp_in"]["kernel"]))}
        t1 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", WEIGHTS_CHILD, repr(cfg)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))))
        attach_s = time.perf_counter() - t1
        print(child.stdout.strip(), flush=True)
        if child.returncode != 0 or "private init" in child.stderr:
            fail(f"the child engine did not attach: {child.stderr[-2000:]}")
        got = dict(line.split()[::2] for line in
                   child.stdout.strip().splitlines())
        devs = {line.split()[0]: line.split()[1] for line in
                child.stdout.strip().splitlines()}
        if got != want or set(devs.values()) != {"cuda"}:
            fail(f"the child's weights {got} on {devs} are not the "
                 f"publisher's {want}")
    finally:
        eng.shutdown()
    if os.listdir(shm):
        fail(f"release left {os.listdir(shm)} in {shm}")
    res = dict(key=key, publish_s=publish_s, child_attach_s=attach_s,
               bitwise_equal=sorted(want))
    for k, val in res.items():
        print(f"weights {k} {val} [{tag}]", flush=True)
    del eng, p
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device

    # The shm weights plane (its segments, locks and the engines' boot-time
    # reaping) works in a directory of this run's own, on tmpfs where there
    # is one, removed at exit.
    shm_dir = tempfile.mkdtemp(prefix="rtpu_smoke_", dir="/dev/shm"
                               if os.path.isdir("/dev/shm") else None)
    atexit.register(shutil.rmtree, shm_dir, ignore_errors=True)
    os.environ["RTPU_SHM_DIR"] = shm_dir
    tag = gpu_line()
    print(tag, flush=True)
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    card_key, card = peaks(name)
    print(f"peaks ({card_key} data sheet): {card[0] / 1e12} TB/s, "
          f"{card[1] / 1e12} bf16 TFLOP/s", flush=True)
    t_start = t0 = time.perf_counter()
    phase_s = {}

    def phase_done(name: str) -> None:
        nonlocal t0
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name} wall_s {phase_s[name]:.1f} (run so far "
              f"{time.perf_counter() - t_start:.1f}) [{tag}]", flush=True)
        t0 = time.perf_counter()

    _build.build()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)
    tc_report(tag)
    ln_report(tag)
    phase_done("build")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {"layer_norm_fwd": check_layer_norm(gen, card, dev),
            "layer_norm_fwd_wide": check_layer_norm(
                gen, card, dev, LN_WIDE_SHAPES, "wide"),
            "flash_attention_fwd": check_flash(gen, card, dev),
            "flash_attention_fwd_gqa_d128": check_flash_gqa(gen, card, dev),
            "layer_norm_bwd": check_layer_norm_bwd(gen, card, dev),
            "layer_norm_bwd_wide": check_layer_norm_bwd(
                gen, card, dev, LN_BWD_WIDE_SHAPES, "wide"),
            "flash_attention_bwd": check_flash_bwd(gen, card, dev),
            "flash_attention_bwd_gqa_d128": check_flash_bwd_gqa(gen, card,
                                                                dev)}
    for r in (r for rs in rows.values() for r in rs):
        for key in ("ms", "call_ms", "plain_ms", "library_ms",
                    "library_call_ms", "library_expanded_ms", "bound_ms"):
            if key in r:
                print(f"{r['name']} {'kernel_ms' if key == 'ms' else key} "
                      f"{r[key]:.6g} [{tag}]", flush=True)
    torch.cuda.empty_cache()
    phase_done("kernels")
    eng = engine_phase(dev, gpt2_engine(), tag)
    phase_done("engine")
    weights_phase(dev, tag)
    phase_done("weights")
    llama = engine_phase(dev, llama_engine(), tag)
    print(f"llama_engine depth {llama['n_layer']} layers (the preset's, "
          f"uncut) at full width [{tag}]", flush=True)
    phase_done("llama_engine")
    train = train_phase(dev, card, tag)
    gc.collect()                  # GPT-2's train state
    torch.cuda.empty_cache()
    phase_done("train")
    llama_train = llama_train_phase(dev, card, tag)
    phase_done("llama_train")
    xl_train = xl_train_phase(dev, card, tag)
    phase_done("xl_train")
    moe_train = moe_train_phase(dev, card, tag)
    phase_done("moe_train")
    tiny_reference_check(dev, tag)
    phase_done("tiny_reference")
    resnet_train = resnet50_train_phase(dev, card, tag)
    phase_done("resnet50_train")
    bert_serve = bert_serve_phase(dev, card, tag)
    phase_done("bert_serve")
    vit_train = vit_train_phase(dev, card, tag)
    phase_done("vit_train")
    t5_train = t5_train_phase(dev, card, tag)
    phase_done("t5_train")
    rllib_reference_check(dev, tag)
    phase_done("rllib_reference")
    impala_pixel_phase(dev, card, tag)
    phase_done("impala_pixel")
    ppo_pixel_phase(dev, card, tag)
    phase_done("ppo_pixel")
    dqn_pixel_phase(dev, card, tag)
    phase_done("dqn_pixel")
    sac_pendulum_phase(dev, card, tag)
    phase_done("sac_pendulum")
    td3_pendulum_phase(dev, card, tag)
    phase_done("td3_pendulum")
    offline_marwil_phase(dev, card, tag)
    phase_done("offline_marwil")
    a3c_pixel_phase(dev, card, tag)
    phase_done("a3c_pixel")
    apex_pixel_phase(dev, card, tag)
    phase_done("apex_pixel")
    # every main path's launches of the kernels it counts, each counted
    # from 0 over its own run
    paths = {"engine": eng, "llama_engine": llama, "train": train,
             "llama_train": llama_train, "xl_train": xl_train,
             "moe_train": moe_train, "resnet50_train": resnet_train,
             "bert_serve": bert_serve, "vit_train": vit_train,
             "t5_train": t5_train}

    def kernel_row(row, kname, source, replaces, phase):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": phase["launches"][kname],
                "launches_by_path": {p: ph["launches"][kname]
                                     for p, ph in paths.items()
                                     if kname in ph["launches"]},
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    # forward kernels: the engine phases' launches (GPT-2's for head dim
    # 64, Llama's for 128); backward kernels: the train phase's (each
    # phase's counts were zeroed just before it ran); the wide-row
    # LayerNorm kernels: the xl train phase's.  Both head-dim-64 flash
    # rows are timed at the train step's (32, 1024, 12, 64), the
    # head-dim-128 row at (8, 2048, 32 over 8, 128), the wide-row
    # LayerNorm rows at the xl step's (8192, 1600).
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
        kernel_row(next(r for r in rows["flash_attention_fwd_gqa_d128"]
                        if r["shape"][0] == 8),
                   "flash_attention_fwd_gqa_d128",
                   "ray_tpu_torch/csrc/flash_attention.cu",
                   "ray_tpu/ops/flash_attention.py:50", llama),
        kernel_row(next(r for r in rows["flash_attention_bwd_gqa_d128"]
                        if r["shape"][0] == LLAMA_TRAIN_BATCH),
                   "flash_attention_bwd_gqa_d128",
                   "ray_tpu_torch/csrc/flash_attention_bwd.cu",
                   "ray_tpu/ops/flash_attention.py:103", llama_train),
        kernel_row(rows["layer_norm_fwd_wide"][0], "layer_norm_fwd_wide",
                   "ray_tpu_torch/csrc/layer_norm.cu",
                   "ray_tpu/ops/layer_norm.py:33", xl_train),
        kernel_row(rows["layer_norm_bwd_wide"][0], "layer_norm_bwd_wide",
                   "ray_tpu_torch/csrc/layer_norm.cu",
                   "ray_tpu/ops/layer_norm.py:47", xl_train),
    ]
    for k in kernels:
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms",
                                                  "bound_ms")):
            fail(f"non-finite timing for {k['name']}")
    print(f"phases wall_s {json.dumps(phase_s)} total "
          f"{time.perf_counter() - t_start:.1f} [{tag}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
