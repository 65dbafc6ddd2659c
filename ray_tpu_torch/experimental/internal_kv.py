"""Internal KV store: the port's counterpart of
``ray_tpu/experimental/internal_kv.py`` (the reference's GCS internal KV
table).

The table lives in the driver, the process no port process spawned, and
lasts as long as it does. A port process reaches it over its link to the
driver (``_private/driver_link.py``), as its Queue, pubsub and state API
calls do; in the driver each call runs in place. The reference keeps its
table in the controller and can snapshot it to disk for the next ``init``
(``gcs_snapshot_path``); the port has no ``init`` and no controller, so it
keeps no snapshot (``ROADMAP.md``, "Out by decision").
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private import driver_link

_table: dict = {}  # (namespace, key) -> bytes
_lock = threading.Lock()


def driver_op(op: str, namespace: str, arg):
    """One operation on the driver's table (what ``driver_link`` runs)."""
    with _lock:
        if op == "put":
            key, value = arg
            _table[(namespace, key)] = value
            return None
        if op == "get":
            return _table.get((namespace, arg))
        if op == "del":
            return _table.pop((namespace, arg), None) is not None
        if op == "keys":
            return [k for (n, k) in _table if n == namespace and k.startswith(arg)]
    raise ValueError(f"unknown internal_kv operation {op!r}")


def _call(op: str, namespace: str, arg):
    return driver_link.call("kv", op, namespace, arg)


def _internal_kv_put(key: str, value: bytes, namespace: str = "default") -> None:
    _call("put", namespace, (key, value))


def _internal_kv_get(key: str, namespace: str = "default") -> Optional[bytes]:
    return _call("get", namespace, key)


def _internal_kv_del(key: str, namespace: str = "default") -> bool:
    return _call("del", namespace, key)


def _internal_kv_list(prefix: str = "", namespace: str = "default") -> list[str]:
    return _call("keys", namespace, prefix)


# unprefixed aliases
kv_put = _internal_kv_put
kv_get = _internal_kv_get
kv_del = _internal_kv_del
kv_list = _internal_kv_list
