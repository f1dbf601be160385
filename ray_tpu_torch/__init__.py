"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays beside it as the reference; this
package imports nothing from it.  Plain tensor code is PyTorch, and every
Pallas kernel of the reference on a ported path is a CUDA C++ kernel
written by hand for ``sm_90a`` (``csrc/``, built at first use by
``_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``::

    from ray_tpu_torch.serve import llm
    eng = llm.LLMEngine(llm.EngineConfig(model="gpt2:gpt2-124m",
                                         share_weights=False))
    tokens = eng.generate([1, 2, 3], llm.SamplingParams(max_tokens=16))
"""

from ray_tpu_torch._device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
