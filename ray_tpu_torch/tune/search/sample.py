"""Search-space domains (reference: ``python/ray/tune/search/sample.py``).

The port's copy of ``ray_tpu/tune/search/sample.py``.

``grid_search`` / ``choice`` / ``uniform`` / ``loguniform`` / ``randint`` /
``lograndint`` / ``quniform`` / ``randn`` — the sampling vocabulary a
``param_space`` is written in.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)

    def __repr__(self):
        return f"choice({self.categories})"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: Optional[float] = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v

    def __repr__(self):
        return f"Float({self.lower}, {self.upper}, log={self.log})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            return int(
                math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
            )
        return rng.randint(self.lower, self.upper - 1)

    def __repr__(self):
        return f"Integer({self.lower}, {self.upper})"


class Normal(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    """tune.sample_from — arbitrary callable over the partial spec."""

    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn(None)
        except TypeError:
            return self.fn()


class _GridSearch:
    """Marker for exhaustive expansion (not a Domain: grid, not sampled)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# -- public constructors (match reference names) -----------------------------


def grid_search(values: Sequence[Any]) -> _GridSearch:
    return _GridSearch(values)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def sample_from(fn) -> Function:
    return Function(fn)
