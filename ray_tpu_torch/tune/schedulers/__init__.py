from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.schedulers.async_hyperband import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
)
from ray_tpu_torch.tune.schedulers.hyperband import HyperBandScheduler
from ray_tpu_torch.tune.schedulers.pb2 import PB2
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "TrialScheduler",
]
