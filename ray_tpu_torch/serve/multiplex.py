"""@serve.multiplexed — per-replica LRU of loaded models: the port's own
copy of ``ray_tpu/serve/multiplex.py``.

Reference: ``python/ray/serve/multiplex.py`` — a replica hosts up to
``max_num_models_per_replica`` models, loading on demand and evicting LRU.
``get_multiplexed_model_id()`` exposes the id requested by the caller.

On the card the loaded "model" is typically a set of weights in device
memory; eviction frees that memory for the incoming model.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Optional

_current = threading.local()


def get_multiplexed_model_id() -> str:
    return getattr(_current, "model_id", "")


def _set_model_id(model_id: str):
    _current.model_id = model_id


# module-level state resolved by import inside the wrapper so decorated
# classes stay picklable (no locks captured in closures)
_CACHES: dict[tuple, OrderedDict] = {}
_LOCKS: dict[tuple, threading.Lock] = {}
_GLOCK = threading.Lock()


def _get_cache(key: tuple):
    with _GLOCK:
        return (
            _CACHES.setdefault(key, OrderedDict()),
            _LOCKS.setdefault(key, threading.Lock()),
        )


def multiplexed(
    _fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorator for an async-less model loader method: called with a model
    id, returns the loaded model; results are LRU-cached per replica."""

    def wrap(fn: Callable):
        qual = getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def loader(self, model_id: str):
            from ray_tpu_torch.serve import multiplex as _m

            cache, lock = _m._get_cache((id(self), qual))
            while True:
                with lock:
                    entry = cache.get(model_id)
                    if entry is None:
                        # claim the load: concurrent requests for the same id
                        # wait on the event instead of double-loading (double
                        # load = double device memory during the window)
                        loading = threading.Event()
                        cache[model_id] = ("__loading__", loading)
                        break
                    if (
                        isinstance(entry, tuple)
                        and len(entry) == 2
                        and entry[0] == "__loading__"
                    ):
                        ev = entry[1]
                    else:
                        cache.move_to_end(model_id)
                        _set_model_id(model_id)
                        return entry
                # bounded: the outer loop re-checks the cache entry, so a
                # loader that died without setting the event can't strand us
                ev.wait(1.0)

            try:
                model = fn(self, model_id)  # load outside the lock (slow)
            except BaseException:
                with lock:
                    cache.pop(model_id, None)
                loading.set()
                raise
            with lock:
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    evicted_id, evicted = cache.popitem(last=False)
                    if (
                        isinstance(evicted, tuple)
                        and len(evicted) == 2
                        and evicted[0] == "__loading__"
                    ):
                        cache[evicted_id] = evicted  # never evict an in-flight load
                        cache.move_to_end(evicted_id, last=False)
                        break
                    unload = getattr(evicted, "unload", None)
                    if callable(unload):
                        unload()
                _set_model_id(model_id)
            loading.set()
            return model

        return loader

    if _fn is not None:
        return wrap(_fn)
    return wrap
