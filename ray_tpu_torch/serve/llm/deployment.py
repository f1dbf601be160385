"""Serve deployments around LLMEngine (port of
``ray_tpu/serve/llm/deployment.py``).

``llm_deployment(cfg)`` returns a bound-able Serve deployment whose
replicas each host a continuous-batching ``LLMEngine``: requests stream
tokens back through the existing Serve streaming-response path (the
replica returns a generator; the router pins continuation pulls to this
replica), many concurrent requests share one engine batch
(``max_ongoing_requests`` defaults well above the engine's
``max_num_seqs`` so the iteration scheduler — not the router — is the
batching authority), and model selection rides ``@serve.multiplexed``
(the router's model-affinity keeps a model's engine — weights, KV pool,
compiled programs — resident on the replicas that already serve it).

``naive_llm_deployment(cfg)`` is the A/B baseline ``llm_bench.py``
measures against: the same model runner and cache math, but classic
request-level serving — one request runs generation end-to-end before
the next starts (``max_ongoing_requests=1``).

On the card: the engine is built on ``device`` (default ``cuda``, which
raises in a replica that sees no card; give the deployment
``ray_actor_options={"num_gpus": ...}``), and ``model_cfg`` overrides the
preset's model config (the CPU tests run float32).  ``engine_stats``
returns no ``kv_segment``: the port's KV pool lives on the device, and
what a killed replica leaves on the host (its weights segment, its KV
export spool) carries its pid in the name, for the next engine's boot
to reap.  Disaggregated prefill/decode is the engine's API
(``LLMEngine.prefill_remote`` / ``attach``), as in the reference: no
deployment type wraps it.  Any ``EngineConfig`` serves, Llama-3 8B
included; an 8B replica takes ``share_weights=False``, since the weights
plane publishes float32 (32 GB of shared memory for 8B).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams


class _TokenStream:
    """Stream object handed to Serve: iterable (blocking) AND pollable.

    ``__serve_poll__`` is the replica ``stream_next`` fast path: it
    waits only for the FIRST ready token (bounded), then drains what is
    already queued — a pending request never parks a replica actor
    thread for a whole decode-steps-worth of production, and the first
    token reaches the client the moment it is sampled.  ``close()``
    (stream cancel / abandoned-stream reap) cancels the sequence so the
    engine frees its KV blocks instead of decoding for a dead client."""

    def __init__(self, stream):
        self._stream = stream
        self._it = iter(stream)

    def __iter__(self):
        return self

    def __next__(self):
        return f"{next(self._it)}\n"

    def __serve_poll__(self, max_chunks: int):
        toks, done = self._stream.poll(max_items=max_chunks, timeout=0.2)
        return [f"{t}\n" for t in toks], done

    def close(self):
        self._stream.cancel()


def _sampling_from(req: dict) -> SamplingParams:
    return SamplingParams(
        max_tokens=int(req.get("max_tokens", 16)),
        temperature=float(req.get("temperature", 0.0)),
        top_k=int(req.get("top_k", 0)),
        stop_token=(None if req.get("stop_token") is None
                    else int(req["stop_token"])),
        seed=int(req.get("seed", 0)))


def llm_deployment(cfg: EngineConfig, *, num_replicas: int = 1,
                   max_ongoing_requests: int = 64,
                   name: str = "LLMServer", device: DeviceLike = None,
                   model_cfg=None):
    """Continuous-batching deployment.  Request payload (dict or HTTP
    JSON body): ``{"prompt": [ids...], "max_tokens": N, ...}`` →
    streamed token ids."""
    from ray_tpu_torch import serve

    @serve.deployment(name=name, num_replicas=num_replicas,
                      max_ongoing_requests=max_ongoing_requests)
    class LLMServer:
        def __init__(self, engine_cfg: Optional[EngineConfig] = None):
            self._cfg = engine_cfg or cfg

        @serve.multiplexed(max_num_models_per_replica=2)
        async def _engine_for(self, model_id: str):
            import asyncio
            from dataclasses import replace

            from ray_tpu_torch.serve.llm.engine import LLMEngine
            base = model_id in ("", self._cfg.model)
            ecfg = self._cfg if base else replace(self._cfg, model=model_id)
            eng = LLMEngine(ecfg, device=device,
                            model_cfg=model_cfg if base else None)

            # engines hold a device KV pool + an engine thread: the mux
            # LRU must tear an evicted engine down, not just drop it.
            # Async + offloaded: shutdown joins the engine thread (up to
            # 10s) and must not stall the replica's event loop mid-evict.
            async def _unload(eng=eng):
                await asyncio.get_running_loop().run_in_executor(
                    None, eng.shutdown)

            eng.__serve_unload__ = _unload
            return eng

        async def __call__(self, request):
            from ray_tpu_torch.serve.http_util import Request, StreamingResponse
            if isinstance(request, Request):       # HTTP ingress path
                req = request.json()
            else:
                req = dict(request)
            from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id
            engine = await self._engine_for(
                get_multiplexed_model_id() or self._cfg.model)
            stream = engine.submit([int(t) for t in req["prompt"]],
                                   _sampling_from(req))
            # pull_chunks caps a poll's DRAIN, it is not a fill quota:
            # the first token still returns the moment it exists
            return StreamingResponse(_TokenStream(stream),
                                     content_type="text/plain",
                                     pull_chunks=8)

        async def engine_stats(self) -> dict:
            import os as _os
            engine = await self._engine_for(self._cfg.model)
            return dict(engine.stats(), pid=_os.getpid())

        def shutdown(self):
            """Serve graceful-drain hook (replica prepare_shutdown):
            tear down every engine the mux LRU holds (found by type,
            not by the wrapper's private attribute name)."""
            from ray_tpu_torch.serve.multiplex import _MultiplexWrapper
            for v in list(vars(self).values()):
                if not isinstance(v, _MultiplexWrapper):
                    continue
                for eng in v.pop_all():
                    try:
                        eng.shutdown()
                    except Exception:  # noqa: BLE001 - best-effort drain
                        pass

    return LLMServer


def naive_llm_deployment(cfg: EngineConfig, *, num_replicas: int = 1,
                         name: str = "NaiveLLMServer",
                         device: DeviceLike = None, model_cfg=None):
    """Request-level baseline: whole-request generation, one at a time
    per replica — what Serve offered before this subsystem (per-request
    batching only), measured by ``llm_bench --ab``."""
    from ray_tpu_torch import serve

    @serve.deployment(name=name, num_replicas=num_replicas,
                      max_ongoing_requests=1)
    class NaiveLLMServer:
        def __init__(self, engine_cfg: Optional[EngineConfig] = None):
            from ray_tpu_torch.serve.llm.engine import LLMEngine
            # same engine/runner/cache code path, driven synchronously
            # one request at a time (the engine batch never exceeds 1)
            self._engine = LLMEngine(engine_cfg or cfg, device=device,
                                     model_cfg=model_cfg)

        def __call__(self, request):
            from ray_tpu_torch.serve.http_util import Request, StreamingResponse
            if isinstance(request, Request):
                req = request.json()
            else:
                req = dict(request)
            toks = self._engine.generate([int(t) for t in req["prompt"]],
                                         _sampling_from(req))

            def tokens():
                for tok in toks:
                    yield f"{tok}\n"

            return StreamingResponse(tokens(), content_type="text/plain")

        def engine_stats(self) -> dict:
            return self._engine.stats()

        def shutdown(self):
            self._engine.shutdown()

    return NaiveLLMServer
