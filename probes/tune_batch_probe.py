"""The probe behind ``chip_smoke.TUNE_BATCH``: GPT-2 124M's program
(``chip_smoke.TuneGPT2``, the Tune phase's trial model) alone on the card
at each batch of 8, 16, 24 and 32 x 1024 tokens, three steps each: peak
allocated and reserved memory, the card's free memory after, and the mean
ms of steps 2-3 (host clock, synchronized).  The largest batch whose
reserved peak, with a CUDA context, fits four times beside the driver is
the Tune phase's.

Run on a machine with a CUDA card, from the repository's root:

    python3 probes/tune_batch_probe.py
"""

import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402


def probe(batches=(8, 16, 24, 32), tag: str = "") -> dict:
    from ray_tpu_torch.models import gpt2
    out = {}
    for B in batches:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = c.TuneGPT2({"lr": c.TRAIN_LR, "cfg": gpt2.gpt2_small(),
                            "batch": B, "seq": c.TRAIN_SEQ, "device": None})
        model.train(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = model.train(2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / 2 * 1e3
        free, total = torch.cuda.mem_get_info()
        out[B] = dict(peak_gb=r["peak_mem_gb"], reserved_gb=r["reserved_gb"],
                      free_gb=free / 1e9, total_gb=total / 1e9, step_ms=ms)
        print(f"tune_batch_probe b{B} x {c.TRAIN_SEQ}: peak "
              f"{r['peak_mem_gb']:.3f} GB allocated, {r['reserved_gb']:.3f} "
              f"GB reserved, card free {free / 1e9:.2f} of "
              f"{total / 1e9:.2f} GB, step {ms:.2f} ms [{tag}]", flush=True)
        del model, r
    gc.collect()
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("tune_batch_probe: no CUDA device")
    probe(tag=c.gpu_line())
