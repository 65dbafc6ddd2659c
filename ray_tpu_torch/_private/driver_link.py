"""The way in from a port process to the process that spawned it.

A process that spawns port processes (``ProcessActor``, a ``WorkerGroup``'s
ranks) runs one ``Listener`` on a Unix socket in the abstract namespace
(no file to leave behind when the process is killed) with a random authkey
(``ensure_server``) and hands its children the address and the key in
their environment (``child_env``). A child reaches its spawner through it
(``call``) for what lives only there:

- a call to one of the spawner's actors by id (``util/queue.py``: a
  ``Queue`` passed to another process reaches its host's actor this way,
  never carrying a copy of the items);
- the event channels (``util/pubsub.py``);
- the state API and placement-group queries (``util/state/api.py``,
  ``util/placement_group.py``);
- the internal KV table (``experimental/internal_kv.py``);
- the core API (``_private/worker.py``): a worker's tasks, objects and
  waits, which live in the driver.

The spawner answers each connection on a thread of its own, one request at
a time; a child opens one connection a thread, so a long poll holds only
its own. In the process that runs the server (the driver), ``call`` runs
the operation in place. A driver's server is also named in its session
file (``_private/session.py``), through which a process it did not spawn
(the CLI) attaches. Serve's replicas reach the driver's router through
a listener of the same kind (``serve/controller.py:RouterServer``).
"""

from __future__ import annotations

import atexit
import os
import pickle
import threading
import traceback
import uuid
from typing import Optional

_ADDR_ENV = "RAY_TPU_TORCH_DRIVER"
_KEY_ENV = "RAY_TPU_TORCH_DRIVER_KEY"


def _actor_call(actor_id: str, method, args: tuple, kwargs: dict):
    from ray_tpu_torch._private.process_actor import ActorDiedError, get
    from ray_tpu_torch._private.registry import registry

    actor = registry().handle(actor_id)
    if actor is None:
        raise ActorDiedError(f"actor {actor_id} is gone")
    return get(actor.call(method, *args, **kwargs), timeout=None)


def _actor_kill(actor_id: str) -> None:
    from ray_tpu_torch._private.registry import registry

    actor = registry().handle(actor_id)
    if actor is not None:
        actor.kill()


def _publish(channel: str, event: dict) -> None:
    from ray_tpu_torch._private.registry import registry

    registry().bus.publish(channel, event)


def _poll(channel: str, after_seq: int, timeout: float) -> tuple:
    from ray_tpu_torch._private.registry import registry

    return registry().bus.poll(channel, after_seq, min(timeout, 30.0))


def _group(group_id: str, method: str, args: tuple):
    from ray_tpu_torch.util.placement_group import group_op

    return group_op(group_id, method, args)


def _state(name: str, args: tuple, kwargs: dict):
    from ray_tpu_torch.util.state.api import driver_function

    return driver_function(name)(*args, **kwargs)


def _kv(op: str, namespace: str, arg):
    from ray_tpu_torch.experimental.internal_kv import driver_op

    return driver_op(op, namespace, arg)


def _core(op: str, args: tuple):
    from ray_tpu_torch._private.worker import driver_op

    return driver_op(op, args)


_OPS = {"actor_call": _actor_call, "actor_kill": _actor_kill, "publish": _publish,
        "poll": _poll, "group": _group, "state": _state, "kv": _kv, "core": _core}


class _Server:
    def __init__(self):
        from multiprocessing.connection import Listener

        self.address = f"\0ray_tpu_torch-link-{uuid.uuid4().hex}"
        self.authkey = os.urandom(32)
        self._listener = Listener(self.address, family="AF_UNIX", authkey=self.authkey)
        self._closed = False
        threading.Thread(target=self._accept, name="driver-link", daemon=True).start()

    def _accept(self):
        while not self._closed:
            try:
                conn = self._listener.accept()
            except OSError:
                if self._closed:
                    return
                continue  # a client that failed the authkey check
            except Exception:  # noqa: BLE001 — a malformed handshake
                continue
            threading.Thread(target=self._serve, args=(conn,), name="driver-link-conn",
                             daemon=True).start()

    def _serve(self, conn):
        while True:
            try:
                op, args = conn.recv()
            except (EOFError, OSError):
                break
            except Exception:  # noqa: BLE001 — a request that did not unpickle
                traceback.print_exc()
                continue
            try:
                reply = ("ok", _OPS[op](*args))
            except Exception as e:  # noqa: BLE001 — goes back to the caller
                reply = ("err", e)
            try:
                data = pickle.dumps(reply)
            except Exception:  # noqa: BLE001 — a value or error that does not pickle
                data = pickle.dumps(("err", RuntimeError(repr(reply[1]))))
            try:
                conn.send_bytes(data)
            except OSError:
                break
        conn.close()

    def close(self):
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass


_server: Optional[_Server] = None
_server_lock = threading.Lock()


def ensure_server() -> _Server:
    """This process's server, started at its first use."""
    global _server
    with _server_lock:
        if _server is None:
            _server = _Server()
            atexit.register(_server.close)
            if parent_address() is None:  # a driver: others attach through its session file
                from ray_tpu_torch._private import session

                session.write(_server.address, _server.authkey)
        return _server


def own_address() -> Optional[str]:
    return _server.address if _server is not None else None


def parent_address() -> Optional[str]:
    """The spawner's server, or None in a process no port process spawned
    (the environment holds the abstract address without its leading NUL)."""
    name = os.environ.get(_ADDR_ENV)
    return None if name is None else "\0" + name


def child_env() -> dict:
    """What a spawned port process's environment carries: its spawner's
    address and key, and the host's node id."""
    from ray_tpu_torch._private.registry import node_env

    s = ensure_server()
    return {_ADDR_ENV: s.address[1:], _KEY_ENV: s.authkey.hex(), **node_env()}


_conns = threading.local()


def call(op: str, *args, address: Optional[str] = None):
    """Run ``op`` where it lives: here when ``address`` is this process's
    own server (or no address is given and no port process spawned this
    one), else over the link to the spawner. Raises the operation's error."""
    parent = parent_address()
    address = address or parent
    if address is None or address == own_address():
        return _OPS[op](*args)
    if address != parent:
        raise RuntimeError(
            "an object of a port process is reached through the process that created it; this "
            "process was not spawned by it")
    conn = getattr(_conns, "conn", None)
    if conn is None:
        from multiprocessing.connection import Client

        conn = _conns.conn = Client(address, family="AF_UNIX",
                                    authkey=bytes.fromhex(os.environ[_KEY_ENV]))
    try:
        conn.send((op, args))
        kind, value = conn.recv()
    except (EOFError, OSError) as e:
        _conns.conn = None
        raise RuntimeError(f"the spawning process is gone ({type(e).__name__}: {e})") from e
    if kind == "err":
        raise value
    return value
