"""Variant generation: grid expansion × random sampling.

The port's copy of ``ray_tpu/tune/search/basic_variant.py``.

Reference: ``python/ray/tune/search/basic_variant.py`` (BasicVariantGenerator)
— every ``grid_search`` in the param space is expanded exhaustively; Domain
leaves are sampled; the whole expansion repeats ``num_samples`` times.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Iterator, Optional

from ray_tpu_torch.tune.search.sample import Domain, _GridSearch
from ray_tpu_torch.tune.search.searcher import Searcher


def _find_leaves(space: Any, path=()):
    """Yield (path, leaf) for grid/domain leaves in a nested dict space."""
    if isinstance(space, dict):
        for k, v in space.items():
            yield from _find_leaves(v, path + (k,))
    elif isinstance(space, (_GridSearch, Domain)):
        yield path, space


def _set_path(d: dict, path, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _copy_space(space):
    if isinstance(space, dict):
        return {k: _copy_space(v) for k, v in space.items()}
    return space


def generate_variants(
    param_space: dict, num_samples: int, seed: Optional[int] = None
) -> Iterator[dict]:
    """Yield resolved configs: (grid cartesian product) × num_samples."""
    rng = random.Random(seed)
    leaves = list(_find_leaves(param_space))
    grid_leaves = [(p, l) for p, l in leaves if isinstance(l, _GridSearch)]
    domain_leaves = [(p, l) for p, l in leaves if isinstance(l, Domain)]

    grid_values = [l.values for _, l in grid_leaves]
    grid_combos = list(itertools.product(*grid_values)) if grid_leaves else [()]

    for _ in range(num_samples):
        for combo in grid_combos:
            cfg = _copy_space(param_space)
            for (path, _), val in zip(grid_leaves, combo):
                _set_path(cfg, path, val)
            for path, dom in domain_leaves:
                _set_path(cfg, path, dom.sample(rng))
            yield cfg


class BasicVariantGenerator(Searcher):
    """Searcher facade over generate_variants (grid + random)."""

    def __init__(self, param_space: Optional[dict] = None, num_samples: int = 1,
                 seed: Optional[int] = None, max_concurrent: int = 0):
        super().__init__()
        self._param_space = param_space or {}
        self._num_samples = num_samples
        self._seed = seed
        self._iter: Optional[Iterator[dict]] = None
        self.max_concurrent = max_concurrent

    def set_search_properties(self, metric, mode, param_space, num_samples):
        self._param_space = param_space
        self._num_samples = num_samples
        self.metric, self.mode = metric, mode
        self._iter = None
        return True

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._iter is None:
            self._iter = generate_variants(
                self._param_space, self._num_samples, self._seed
            )
        try:
            return next(self._iter)
        except StopIteration:
            return None

    def total_variants(self) -> int:
        leaves = list(_find_leaves(self._param_space))
        n_grid = 1
        for _, l in leaves:
            if isinstance(l, _GridSearch):
                n_grid *= len(l.values)
        return n_grid * self._num_samples
