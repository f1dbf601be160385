"""Which attention path drifts from float32 as GPT-2's attention sharpens:
the model_parallel phase's witness, in one process on the card.

The phase's ring layouts (``seq=2``, ``context=2`` ring) run plain ring
attention (``ops/ring_attention.py``: float32 scores and accumulators,
bf16 probabilities for the value product, autograd backward); its
one-rank reference runs the hand-written flash kernel.  The ring's
numerics on two ranks are those of ``attn_impl="blockwise"`` with two
blocks on one: the same ``flash_update`` over the same two key chunks.
So, for GPT-2 124M at the phase's params (block matrices x each scale),
batch and shape, this runs the step-0 loss and gradients of

- ``flash_bf16``: the phase's reference (the flash kernel, bf16);
- ``blockwise_bf16``: the ring's numerics (plain, bf16);
- ``dense_bf16``: plain dense attention, bf16;
- ``flash_f32``: the flash kernel's float32 design;
- ``dense_f32``: plain dense attention in float32, the witness,

and prints each one's loss, gradient norm, worst leaf's norm gap and
worst leaf's relative L2 error against the witness.  Run on a machine
with a CUDA card, from the repository's root:

    python3 probes/attention_precision_probe.py [block scales...]

(default 3 8).
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402

VARIANTS = {
    "flash_bf16": {"attn_impl": "flash"},
    "blockwise_bf16": {"attn_impl": "blockwise"},
    "dense_bf16": {"attn_impl": "dense"},
    "flash_f32": {"attn_impl": "flash", "dtype": "float32"},
    "dense_f32": {"attn_impl": "dense", "dtype": "float32"},
}
WITNESS = "dense_f32"


def step0(dev, base, kw, scale):
    """(loss, [leaf grads]) of the phase's step 0 under ``kw``."""
    import torch

    from ray_tpu_torch.models import gpt2
    kw = dict(kw)
    if kw.get("dtype") == "float32":
        kw["dtype"] = torch.float32
    cfg = dataclasses.replace(base, **kw)
    params = gpt2.init_params(
        torch.Generator(device=dev).manual_seed(c.SEED), base, dev)
    for name in c.BLOCK_MATRICES:
        params["blocks"][name]["kernel"].mul_(scale)
    tokens = torch.from_numpy(c.mp_tokens(base)).long().to(dev)
    loss, grads = c.leaf_grads(params, lambda: gpt2.loss_fn(
        params, {"tokens": tokens}, cfg))
    names = c.leaf_names(params)
    return loss.item(), [g.float() for g in grads], names


def main() -> int:
    import torch
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import disable_tf32, resolve_device
    from ray_tpu_torch.models import gpt2
    tag = c.gpu_line()
    print(tag, sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    _build.build()
    _build.lib()
    disable_tf32()
    dev = resolve_device(None)
    base = gpt2.gpt2_small()
    for scale in [float(x) for x in sys.argv[1:]] or [3.0, 8.0]:
        runs = {k: step0(dev, base, kw, scale) for k, kw in VARIANTS.items()}
        _, ref, names = runs[WITNESS]
        ref_norm = torch.sqrt(sum((g * g).sum() for g in ref)).item()
        for k, (loss, grads, _) in runs.items():
            norm = torch.sqrt(sum((g * g).sum() for g in grads)).item()
            norm_gaps = [abs(g.norm().item() - r.norm().item())
                         / max(r.norm().item(), 1e-30)
                         for g, r in zip(grads, ref)]
            l2 = [((g - r).norm() / r.norm().clamp_min(1e-30)).item()
                  for g, r in zip(grads, ref)]
            i, j = max(range(len(names)), key=norm_gaps.__getitem__), \
                max(range(len(names)), key=l2.__getitem__)
            print(f"attention precision x{scale} {k}: loss {loss!r} "
                  f"(witness {runs[WITNESS][0]!r}) grad norm {norm!r} "
                  f"(witness {ref_norm!r}, gap "
                  f"{abs(norm - ref_norm) / ref_norm:.4g}); worst leaf norm "
                  f"gap {names[i]} {norm_gaps[i]:.4g}; worst leaf rel L2 "
                  f"{names[j]} {l2[j]:.4g} [{tag}]", flush=True)
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
