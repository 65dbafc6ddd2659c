"""ray_tpu_torch.tune — hyperparameter search, each trial a process of the port.

The public surface of ``ray_tpu/tune/__init__.py``, which mirrors the
reference's ``ray.tune``: ``Tuner`` + ``TuneConfig``, search-space
constructors, searchers, trial schedulers (FIFO, ASHA, sync HyperBand,
median stopping, PBT, PB2), ``ResultGrid``. The in-loop API is the Train
layer's: ``tune.report`` and ``tune.get_checkpoint`` are
``train/session.py``'s. Trials lease what ``with_resources`` names from the
host's card ledger (``tune/tuner.py``).
"""

from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.result_grid import ExperimentAnalysis, ResultGrid, TrialResult
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    GPSearcher,
    ConcurrencyLimiter,
    Searcher,
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    PB2,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.tuner import (
    TuneConfig,
    Tuner,
    with_parameters,
    with_resources,
)

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "GPSearcher",
    "ConcurrencyLimiter",
    "ExperimentAnalysis",
    "FIFOScheduler",
    "HyperBandScheduler",
    "PB2",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TrialResult",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "report",
    "sample_from",
    "uniform",
    "with_parameters",
    "with_resources",
]
