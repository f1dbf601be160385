"""Iteration-level (continuous) batching scheduler (a copy of
``ray_tpu/serve/llm/scheduler.py``: it is pure Python).

Reference design: Orca (Yu et al., OSDI '22) — scheduling decisions are
made every model iteration, not per request.  Each call to ``plan()``
looks at the waiting and running sets and decides what THIS step runs:

- **prefill** of the oldest admissible waiting sequence (one per step:
  interleaving a single prefill between decode steps bounds the decode
  stall — TPOT — that a long prompt would otherwise inject), admitted
  only if a decode batch slot AND enough KV blocks are free;
- **decode** of every running sequence (token-budget = batch bucket cap);
- **preemption** under cache pressure: when a running sequence cannot
  get its next block, the LOWEST-priority running sequence (latest
  arrival) is evicted — its blocks are freed and it re-queues at the
  FRONT of the waiting line for re-prefill with its tokens so far
  (vLLM's recompute-style preemption).

The scheduler owns no locks: the engine calls it only from the engine
loop thread; queues crossed by callers are the engine's.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from ray_tpu_torch.serve.llm.config import SamplingParams

WAITING, RUNNING, FINISHED, FAILED = ("waiting", "running", "finished",
                                      "failed")


@dataclass
class Sequence:
    """One request's generation state inside the engine."""

    seq_id: str
    prompt: List[int]
    sampling: SamplingParams
    arrival: float = field(default_factory=time.monotonic)
    state: str = WAITING
    output: List[int] = field(default_factory=list)
    # timing for TTFT/TPOT accounting (engine fills these in)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    error: Optional[str] = None
    # preemption folds generated tokens into the prompt for re-prefill;
    # the generation budget stays relative to the ORIGINAL prompt
    orig_len: int = 0
    # request's span context (tracing.SpanContext | None): captured at
    # submit() on the caller's thread; the engine loop parents its
    # per-sequence prefill/decode/preempt spans to it
    trace: Optional[object] = None

    def __post_init__(self):
        if not self.orig_len:
            self.orig_len = len(self.prompt)

    @property
    def ctx_len(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def generated(self) -> int:
        return self.ctx_len - self.orig_len

    def finish_reason(self) -> Optional[str]:
        sp = self.sampling
        if self.generated >= sp.max_tokens:
            return "length"
        if sp.stop_token is not None and self.output and \
                self.output[-1] == sp.stop_token:
            return "stop"
        return None


@dataclass
class Plan:
    """What one engine iteration executes."""

    prefill: Optional[Sequence] = None
    decode: List[Sequence] = field(default_factory=list)


class IterationScheduler:
    def __init__(self, max_num_seqs: int, max_prefill_tokens: int,
                 max_model_len: int):
        self.max_num_seqs = max_num_seqs
        self.max_prefill_tokens = max_prefill_tokens
        self.max_model_len = max_model_len
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []

    # ------------------------------------------------------------- lifecycle
    def add(self, seq: Sequence) -> None:
        if len(seq.prompt) > self.max_prefill_tokens:
            raise ValueError(
                f"prompt of {len(seq.prompt)} tokens exceeds "
                f"max_prefill_tokens={self.max_prefill_tokens}")
        if len(seq.prompt) + seq.sampling.max_tokens > self.max_model_len:
            raise ValueError(
                f"prompt+max_tokens {len(seq.prompt)}+"
                f"{seq.sampling.max_tokens} exceeds "
                f"max_model_len={self.max_model_len}")
        self.waiting.append(seq)

    def plan(self, blocks_free: int, blocks_needed_fn) -> Plan:
        """Decide this iteration.  ``blocks_needed_fn(n_tokens)`` maps a
        context length to its block cost (cache geometry lives there)."""
        p = Plan()
        if self.waiting and len(self.running) < self.max_num_seqs:
            head = self.waiting[0]
            # +1: room for the first decode step's block growth so a
            # just-admitted sequence can't immediately trigger preemption
            if blocks_needed_fn(head.ctx_len) + 1 <= blocks_free:
                p.prefill = self.waiting.popleft()
        # decode everything running (the batch bucket pads the rest)
        p.decode = list(self.running)
        return p

    def victim(self) -> Optional[Sequence]:
        """Lowest-priority running sequence = latest arrival."""
        if not self.running:
            return None
        return max(self.running, key=lambda s: s.arrival)

    def preempt(self, seq: Sequence) -> None:
        """Evict: back to the FRONT of the waiting line, prompt extended
        with everything generated so far (re-prefill resumes exactly)."""
        self.running.remove(seq)
        seq.prompt = seq.prompt + seq.output
        seq.output = []
        seq.state = WAITING
        seq.preemptions += 1
        self.waiting.appendleft(seq)

    def start_running(self, seq: Sequence) -> None:
        seq.state = RUNNING
        self.running.append(seq)

    def finish(self, seq: Sequence, state: str = FINISHED) -> None:
        if seq in self.running:
            self.running.remove(seq)
        seq.state = state
        seq.finished_at = time.monotonic()

    def drop_waiting(self, seq: Sequence) -> None:
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
