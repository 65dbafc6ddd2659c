from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator, generate_variants
from ray_tpu_torch.tune.search.gp_search import GPSearcher
from ray_tpu_torch.tune.search.sample import (
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
from ray_tpu_torch.tune.search.searcher import (
    AxSearch,
    BayesOptSearch,
    ConcurrencyLimiter,
    HEBOSearch,
    HyperOptSearch,
    NevergradSearch,
    OptunaSearch,
    Searcher,
    TuneBOHB,
    ZOOptSearch,
)

__all__ = [
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "GPSearcher",
    "Searcher",
    "choice",
    "generate_variants",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "sample_from",
    "uniform",
]
