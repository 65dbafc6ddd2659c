"""ResultGrid / ExperimentAnalysis (reference: ``tune/result_grid.py``,
``tune/analysis/experiment_analysis.py``): the port's copy of
``ray_tpu/tune/result_grid.py``, over the port's ``train/checkpoint.py:Checkpoint``."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


class TrialResult:
    def __init__(self, metrics, checkpoint, error, path, metrics_history, config, trial_id):
        self.metrics = metrics or {}
        self.checkpoint: Optional[Checkpoint] = checkpoint
        self.error = error
        self.path = path
        self.metrics_history = metrics_history or []
        self.config = config
        self.trial_id = trial_id

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.metrics_history)

    def __repr__(self):
        return (
            f"TrialResult(trial_id={self.trial_id!r}, metrics={self.metrics}, "
            f"error={self.error!r})"
        )


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric=None, mode="max"):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TrialResult:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return len(self._results) - self.num_errors

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (not set in TuneConfig)")
        candidates = [r for r in self._results if metric in r.metrics]
        if not candidates:
            raise RuntimeError("no trial reported the metric " + metric)
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(candidates, key=key) if mode == "max" else min(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self._results])


ExperimentAnalysis = ResultGrid  # legacy alias (reference keeps both)
