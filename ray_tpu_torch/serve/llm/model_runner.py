"""Bucketed prefill/decode execution for the LLM engine (port of
``ray_tpu/serve/llm/model_runner.py``).

Every call is padded up to a configured bucket
(``EngineConfig.prefill_len_buckets`` / ``decode_batch_buckets``) and the
block-table width is fixed at ``max_blocks_per_seq``, as in the
reference, so the set of shapes the card sees is bounded for the
engine's life (``compiles`` counts the distinct ones).  Each forward
runs inside a step region of the step-hygiene oracle
(``_private/xla_watchdog.py``: ``llm.prefill`` and ``llm.decode``, with
the bucket counts as budgets), as in the reference; the host-to-device
copies of the inputs and the logits' pull are designed syncs and sit
outside the regions.  Only the (V,) or (B, V) logits come back to the
host; K/V stay on the device.  Sampling
(greedy / temperature / top-k) happens host-side on those logits, with
the reference's numpy generator, so seeded sampling draws the same
tokens from the same logits.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch._private.xla_watchdog import compile_budget
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams, \
    resolve_model

logger = logging.getLogger("ray_tpu_torch.serve.llm.runner")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class ModelRunner:
    """Owns params and runs the bucketed prefill/decode steps.

    ``device`` defaults to ``cuda`` (raises with no card); ``model_cfg``
    overrides the preset's model config (the tests run in float32)."""

    def __init__(self, cfg: EngineConfig, params=None, *,
                 device: DeviceLike = None, model_cfg=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mod, self.mcfg = resolve_model(cfg)
        if model_cfg is not None:
            self.mcfg = model_cfg
        self.weights_key: str = ""      # set when the shm plane is used
        if params is None:
            params = self._load_params()
        self.params = params
        self.n_layer = self.mcfg.n_layer
        self.n_kv = getattr(self.mcfg, "n_kv_head", self.mcfg.n_head)
        self.head_dim = self.mcfg.head_dim
        self.vocab = self.mcfg.vocab_size
        self.compiles = 0          # distinct bucket shapes seen
        # step regions: one signature per bucket for the runner's life,
        # no host read inside a forward
        self._prefill_budget = compile_budget(
            "llm.prefill", len(cfg.prefill_len_buckets))
        self._decode_budget = compile_budget(
            "llm.decode", len(cfg.decode_batch_buckets))

    def _load_params(self):
        def init(device):
            # CPU generator: the same seed gives the same weights on every
            # device
            gen = torch.Generator().manual_seed(self.cfg.seed)
            return self.mod.init_params(gen, self.mcfg, device=device)

        if self.cfg.share_weights:
            from ray_tpu_torch.serve.llm import weights
            self.weights_key = f"{self.cfg.model_key()}_s{self.cfg.seed}"
            return weights.publish_or_attach(self.weights_key, init,
                                             self.device)
        return init(self.device)

    # ---------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, token_ids) -> Tuple[np.ndarray, torch.Tensor,
                                          torch.Tensor]:
        """One prompt → (last-position logits (V,) on the host,
        k, v (L, T_pad, KV, D) on the device).

        The prompt is padded to its length bucket; KV for pad positions
        is garbage and never referenced (the cache fill stops at the
        true length)."""
        n = len(token_ids)
        tb = _bucket(n, self.cfg.prefill_len_buckets)
        toks = np.zeros((1, tb), np.int64)
        toks[0, :n] = token_ids
        toks = torch.from_numpy(toks).to(self.device)
        with self._prefill_budget:
            self._note_shape(self._prefill_budget, ("prefill", tb))
            logits, ks, vs = self.mod.forward_prefill(
                self.params, toks, self.mcfg, last_pos=n - 1)
        return logits[0].cpu().numpy(), ks[:, 0], vs[:, 0]

    # ----------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               kv_pool: torch.Tensor, block_tables: np.ndarray,
               ctx_lens: np.ndarray) -> Tuple[np.ndarray, torch.Tensor,
                                              torch.Tensor]:
        """One iteration over a batch of sequences.

        tokens/positions/ctx_lens (B,); block_tables (B, MAXB); kv_pool —
        the cache's device pool, read in place.  Returns (logits (B, V)
        on the host, new_k, new_v (L, B, KV, D) on the device); only the
        first B rows are real after bucket padding."""
        b = len(tokens)
        bb = _bucket(b, self.cfg.decode_batch_buckets)
        pad = bb - b

        def dev(a: np.ndarray, *pad_shape) -> torch.Tensor:
            a = np.asarray(a, np.int64)
            if pad:
                a = np.concatenate([a, np.zeros((pad,) + pad_shape,
                                                np.int64)])
            return torch.from_numpy(a).to(self.device)

        args = (dev(tokens), dev(positions), kv_pool,
                dev(block_tables, block_tables.shape[1]), dev(ctx_lens))
        with self._decode_budget:
            self._note_shape(self._decode_budget, ("decode", bb))
            logits, ks, vs = self.mod.forward_decode(self.params, *args,
                                                     self.mcfg)
        return logits[:b].cpu().numpy(), ks[:, :b], vs[:, :b]

    def _note_shape(self, budget: compile_budget, key) -> None:
        if budget.see(key):
            self.compiles += 1
            logger.info("first %s step (distinct shapes %d)",
                        key, self.compiles)

    # --------------------------------------------------------------- sampling
    @staticmethod
    def sample(logits: np.ndarray, sp: SamplingParams,
               step: int) -> int:
        """Host-side sampling of one token from (V,) logits."""
        if sp.temperature <= 0.0:
            return int(np.argmax(logits))
        x = logits.astype(np.float64) / sp.temperature
        if sp.top_k:
            kth = np.partition(x, -sp.top_k)[-sp.top_k]
            x = np.where(x < kth, -np.inf, x)
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        rng = np.random.default_rng((sp.seed, step))
        return int(rng.choice(len(p), p=p))
