"""joblib backend: ``with joblib.parallel_backend("ray_tpu_torch"): ...``.

Reference: ``python/ray/util/joblib/`` (SURVEY.md §2.3) — lets
scikit-learn's ``n_jobs`` parallelism fan out as cluster tasks.
Call :func:`register_ray_tpu_torch` once (importing this module does it).
"""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch

try:
    from joblib._parallel_backends import ParallelBackendBase
    from joblib.parallel import register_parallel_backend
    _HAVE_JOBLIB = True
except ImportError:  # pragma: no cover
    ParallelBackendBase = object
    _HAVE_JOBLIB = False


class _TaskFuture:
    """Duck-typed future joblib can poll: get(timeout)."""

    def __init__(self, ref, callback: Callable | None):
        self._ref = ref
        self._callback = callback
        self._done = False

    def get(self, timeout: float | None = None) -> Any:
        out = ray_tpu_torch.get(self._ref, timeout=timeout)
        if not self._done and self._callback is not None:
            self._done = True
            self._callback(out)
        return out


class RayTpuTorchBackend(ParallelBackendBase):
    """Each joblib batch becomes one cluster task."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def configure(self, n_jobs: int = 1, parallel=None, **kwargs) -> int:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        return cpus if n_jobs is None or n_jobs < 0 else n_jobs

    def apply_async(self, func: Callable, callback: Callable | None = None):
        # joblib's retrieval calls future.get(), which fires the callback —
        # eager dispatch isn't required for correctness
        return _TaskFuture(_run_joblib_batch.remote(func), callback)

    def abort_everything(self, ensure_ready: bool = True) -> None:
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)


@ray_tpu_torch.remote
def _run_joblib_batch(f):
    return f()


def register_ray_tpu_torch() -> None:
    if _HAVE_JOBLIB:
        register_parallel_backend("ray_tpu_torch", RayTpuTorchBackend)


register_ray_tpu_torch()
