"""Searcher interface + ConcurrencyLimiter.

The port's copy of ``ray_tpu/tune/search/searcher.py``.

Reference: ``python/ray/tune/search/searcher.py`` and
``search/concurrency_limiter.py``. External algorithm wrappers (hyperopt,
optuna, ...) follow the reference's import-gated pattern: the class exists,
construction raises if the library isn't installed.
"""

from __future__ import annotations

from typing import Any, Optional


class Searcher:
    """Suggests configs; learns from reported results."""

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(
        self, metric: Optional[str], mode: Optional[str], param_space: dict, num_samples: int
    ) -> bool:
        """Returns True if the searcher consumed the space (else the caller
        expands grid/domains itself via BasicVariantGenerator)."""
        return False

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[dict] = None, error: bool = False
    ) -> None:
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: ``concurrency_limiter.py``)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self.live: set[str] = set()

    def set_search_properties(self, metric, mode, param_space, num_samples):
        return self.searcher.set_search_properties(metric, mode, param_space, num_samples)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if len(self.live) >= self.max_concurrent:
            return None  # backpressure: try again later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self.live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self.live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


def _gated(name: str, pip_name: str):
    class _Gated(Searcher):
        def __init__(self, *a, **k):
            raise ImportError(
                f"{name} requires `{pip_name}`, which is not available in "
                f"this environment. Use BasicVariantGenerator or write a "
                f"custom Searcher."
            )

    _Gated.__name__ = name
    return _Gated


# import-gated externals, mirroring the reference's search/ registry
HyperOptSearch = _gated("HyperOptSearch", "hyperopt")
OptunaSearch = _gated("OptunaSearch", "optuna")
AxSearch = _gated("AxSearch", "ax-platform")
BayesOptSearch = _gated("BayesOptSearch", "bayesian-optimization")
TuneBOHB = _gated("TuneBOHB", "hpbandster")
NevergradSearch = _gated("NevergradSearch", "nevergrad")
ZOOptSearch = _gated("ZOOptSearch", "zoopt")
HEBOSearch = _gated("HEBOSearch", "HEBO")
