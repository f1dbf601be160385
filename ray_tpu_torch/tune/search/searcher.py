"""Adaptive searcher interface (sequential model-based optimization).

Reference: ``python/ray/tune/search/searcher.py`` — unlike the upfront
``BasicVariantGenerator``, a Searcher proposes each trial's config lazily
(``suggest``) and learns from completed trials (``on_trial_complete``), so
later trials exploit earlier results.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Searcher:
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self._mode_explicit = mode is not None
        self.mode = mode or "max"
        self._space: Optional[Dict[str, Any]] = None

    def set_search_properties(self, metric: Optional[str], mode: Optional[str],
                              space: Dict[str, Any]) -> None:
        if self.metric is None:
            self.metric = metric
        # an explicitly-constructed mode wins over TuneConfig's default
        # ("max") — overwriting would silently invert the optimization
        if mode and not self._mode_explicit:
            self.mode = mode
        self._space = space

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        """Intermediate (per-report) observation — multi-fidelity
        searchers (BOHB) learn from rung results, not just finals."""

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        pass
