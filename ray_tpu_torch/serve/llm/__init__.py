"""serve.llm — continuous-batching inference engine on one GPU (port of
``ray_tpu/serve/llm``).

- **iteration-level (continuous) scheduling** per Orca (Yu et al.,
  OSDI '22): the batch is re-formed every decode step, new requests'
  prefills interleave with running decodes, finished sequences leave
  immediately, and the lowest-priority sequence is preempted (blocks
  freed, re-prefilled later) under cache pressure.
- **paged KV cache** per PagedAttention (Kwon et al., SOSP '23): the KV
  cache is fixed-size blocks in one device pool with a block table per
  sequence (``ops/paged_attention.py``).
- **shared weights**: engines on one node share one copy of the params
  in shared memory (``weights.py``), published by the first to arrive.

Entry points::

    from ray_tpu_torch.serve import llm
    eng = llm.LLMEngine(llm.EngineConfig(model="gpt2:tiny"))
    for tok in eng.submit([1, 2, 3], llm.SamplingParams(max_tokens=16)):
        ...

    app = llm.llm_deployment(llm.EngineConfig(model="gpt2:tiny")).options(
        ray_actor_options={"num_gpus": 1}).bind()
    handle = serve.run(app)          # streaming tokens per request
"""

from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams  # noqa: F401
from ray_tpu_torch.serve.llm.engine import LLMEngine  # noqa: F401
from ray_tpu_torch.serve.llm.deployment import (  # noqa: F401
    llm_deployment, naive_llm_deployment,
)

__all__ = ["EngineConfig", "SamplingParams", "LLMEngine",
           "llm_deployment", "naive_llm_deployment"]
