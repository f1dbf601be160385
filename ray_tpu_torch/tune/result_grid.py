"""ResultGrid: the output of Tuner.fit().

Reference: ``python/ray/tune/result_grid.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.train.result import Result


class ResultGrid:
    def __init__(self, results: List[Result],
                 default_metric: Optional[str] = None,
                 default_mode: str = "max"):
        self._results = results
        self._default_metric = default_metric
        self._default_mode = default_mode

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._default_metric
        mode = mode or self._default_mode
        if metric is None:
            raise ValueError("no metric given and none configured on the "
                             "Tuner (TuneConfig(metric=...))")
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        best_of = max if mode == "max" else min
        return best_of(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd
        return pd.DataFrame([r.metrics or {} for r in self._results])
