"""ServeController: reconciles target state into replica processes; a port
of ``ray_tpu/serve/controller.py`` (``ServeControllerActor``).

Reference: ``python/ray/serve/_private/controller.py:92`` (ServeController)
+ ``deployment_state.py:1391`` (replica rollout/scaling state machines) +
``autoscaling_state.py`` (queue-metric autoscaling). A background
reconcile loop:

  target replicas  ->  start/stop replica processes (rolling, health-checked)
  replica metrics  ->  autoscaling decisions between min/max

The port's process design:

- *The controller is a thread of the driver* (``serve.run`` starts it;
  the JAX package runs it as an actor named ``serve-controller``), and so
  are the proxy (``proxy.py``) and the router (``RouterServer`` below).
  ``serve.shutdown()`` stops every replica, which ends every lease.
- *A replica is a ``ProcessActor``* hosting ``replica.ReplicaActor``, with
  ``max_concurrency = max_ongoing_requests + 2`` (as the JAX controller
  starts its actors, ``controller.py:414``). It leads a process group of
  its own (``ProcessActor(leads_group=True)``), so that it may spawn
  processes (a ``GangLLMServer``'s ranks) and every stop of it (a
  scale-down, a replacement, ``serve.delete``, ``serve.shutdown``) ends
  them with it; a driver that goes takes the group with it. It leases
  from the driver's card ledger, which it receives, so the ranks it
  spawns lease from the same ledger.
- *Leases.* ``_start_replica`` leases what ``ray_actor_options`` names
  from the host's card ledger through ``spawn_env.assign_cards`` (as Data's
  actor pools do, ``data/execution.py:408-414``): ``{"resources":
  {"GPU": g}}`` a share of a card below 1 or whole cards, ``{"CPU": c}``
  CPU slots (``num_cpus`` as well). A deployment that names
  none leases nothing and its replicas see no card. A replica that cannot
  lease is not started: the deployment stays short, and ``status()`` says
  why. Nothing falls back to the CPU.
- *Readiness.* A replica is routable once its constructor has returned
  (``ProcessActor.ready``); that bumps the deployment's version, which the
  handles read. A replica still constructing is not health-checked: the
  starting-verdict state machine decides its fate from its process's
  state at once (the JAX controller learns the same by a health check
  that times out, holding its reconcile loop meanwhile).
- *Scale-down victims:* stale-version replicas first, then those still
  starting, then the newest (the JAX controller takes the oldest after
  the stale ones).
- *Routing for replicas.* A handle inside a replica cannot reach another
  replica's pipe, which belongs to the driver: ``RouterServer`` listens on
  a Unix socket (``multiprocessing.connection.Listener``, with an
  authkey) and routes each call it receives through a driver handle,
  relaying the reply and streamed chunks back.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import random
import shutil
import tempfile
import threading
import time
import traceback
from typing import Optional

from ray_tpu_torch._private.cards import CardLedger, LedgerError, default_ledger
from ray_tpu_torch._private.process_actor import ActorError, ProcessActor, get
from ray_tpu_torch._private.spawn_env import assign_cards

logger = logging.getLogger(__name__)

RECONCILE_PERIOD_S = 0.5


class _DeploymentState:
    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec  # serialized target, init payload, config fields
        self.replicas: dict[str, ProcessActor] = {}  # replica name -> its process
        self.target = spec["initial_replicas"]
        self.next_replica_id = 0
        self.last_scale_t = 0.0
        self.last_health_t = 0.0
        self.replica_started_t: dict[str, float] = {}
        self.replica_healthy_once: set[str] = set()
        # replica name -> when its constructor returned: the hung-replica
        # timeout clock starts HERE, not at spawn (a replica still
        # constructing is STARTING, not hung)
        self.replica_alive_t: dict[str, float] = {}
        # replica name -> code_version it was started with (rolling updates)
        self.replica_code: dict[str, str] = {}
        # bumped whenever the ready replica set changes; handles compare it
        self.version = random.getrandbits(62)
        self.metric_window: list[tuple[float, float]] = []  # (ts, ongoing)
        self.status = "UPDATING"
        self.message = ""  # why the deployment is short (a lease refused)


class ServeController:
    def __init__(self):
        self._deployments: dict[str, _DeploymentState] = {}
        self._apps: dict[str, dict] = {}  # app name -> {ingress, route_prefix}
        self._lock = threading.RLock()
        # handles wait here until a deployment's ready replica set changes
        self._change_cv = threading.Condition(self._lock)
        # serializes whole reconcile passes: deploy_application's inline pass
        # must not interleave with the background loop (both would observe the
        # same replica deficit and start duplicates)
        self._reconcile_mutex = threading.Lock()
        self._stop = threading.Event()
        # (time, deployment, event, detail): replica starts, readiness,
        # stops and the autoscaler's target changes, in order
        self.events: list[tuple] = []
        self.router = RouterServer()
        self._loop = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._loop.start()

    # -- deploy API ---------------------------------------------------------

    def deploy_application(self, app_name: str, route_prefix: str,
                           deployments: list[dict], ingress_name: str):
        with self._lock:
            for spec in deployments:
                name = spec["name"]
                # code version: replicas running a different version are
                # ROLLED (replaced one at a time with graceful drain) by the
                # reconciler — reference: DeploymentState version rollout
                spec["code_version"] = hashlib.sha256(
                    spec["serialized_target"] + spec["init_args_payload"]
                ).hexdigest()[:16]
                existing = self._deployments.get(name)
                if existing is None:
                    self._deployments[name] = _DeploymentState(name, spec)
                else:
                    existing.spec = spec
                    existing.target = spec["initial_replicas"]
                    existing.status = "UPDATING"
                    # config rollout: reconfigure live replicas in place
                    # (code rollout happens in reconcile via code_version)
                    for actor in list(existing.replicas.values()):
                        actor.call("reconfigure", spec.get("user_config"))
            self._apps[app_name] = {
                "ingress": ingress_name,
                "route_prefix": route_prefix,
                "deployments": [d["name"] for d in deployments],
            }
        self._reconcile_once()
        return True

    def delete_application(self, app_name: str):
        # exclude reconcile passes: a concurrent pass could otherwise start a
        # replica for the deployment we are deleting (an orphan process)
        with self._reconcile_mutex, self._lock:
            app = self._apps.pop(app_name, None)
            if not app:
                return False
            still_used = {
                d for a in self._apps.values() for d in a["deployments"]
            }
            for dname in app["deployments"]:
                if dname in still_used:
                    continue
                state = self._deployments.pop(dname, None)
                if state:
                    for actor in state.replicas.values():
                        actor.kill()
                    self._bump_version(state)
        return True

    def shutdown(self):
        self._stop.set()
        # the reconcile loop polls _stop every period, so this join is bounded
        self._loop.join(timeout=60.0)
        with self._reconcile_mutex, self._lock:
            for state in self._deployments.values():
                for actor in state.replicas.values():
                    actor.kill()
                self._bump_version(state)
            self._deployments.clear()
            self._apps.clear()
        self.router.close()
        return True

    # -- introspection ------------------------------------------------------

    def get_replica_names(self, deployment_name: str) -> list[str]:
        """Every replica started for the deployment, ready or not."""
        with self._lock:
            state = self._deployments.get(deployment_name)
            return list(state.replicas.keys()) if state else []

    def replicas(self, deployment_name: str) -> dict:
        """Replica name -> its ``ProcessActor``, ready or not."""
        with self._lock:
            state = self._deployments.get(deployment_name)
            return dict(state.replicas) if state else {}

    def replica_version(self, deployment_name: str) -> int:
        with self._lock:
            state = self._deployments.get(deployment_name)
            return -1 if state is None else state.version

    def get_replicas_versioned(self, deployment_name: str) -> tuple:
        """(version, [(name, ProcessActor)] of the replicas ready to route to)."""
        with self._lock:
            state = self._deployments.get(deployment_name)
            if state is None:
                return (-1, [])
            return (state.version, [
                (n, a) for n, a in state.replicas.items()
                if a.ready.done and a.ready._ok and a.is_alive()])

    def wait_for_change(self, deployment_name: str, known_version: Optional[int],
                        timeout_s: float) -> int:
        """Block until the deployment's version differs from
        ``known_version`` (or ``timeout_s`` passes); returns the version."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                state = self._deployments.get(deployment_name)
                version = -1 if state is None else state.version
                left = deadline - time.monotonic()
                if version != known_version or left <= 0:
                    return version
                self._change_cv.wait(left)

    def _bump_version(self, state: _DeploymentState):
        """Callers hold self._lock."""
        state.version += 1
        self._change_cv.notify_all()

    def get_app_route(self, app_name: str) -> Optional[dict]:
        with self._lock:
            return self._apps.get(app_name)

    def list_routes(self) -> dict:
        with self._lock:
            return {
                a["route_prefix"]: {
                    "app": name,
                    "ingress": a["ingress"],
                    # per-deployment admission-queue override for the proxy
                    # (None = ProxyConfig.serve_queue_depth_per_deployment)
                    "max_queued": (
                        self._deployments[a["ingress"]].spec.get(
                            "max_queued_requests"
                        )
                        if a["ingress"] in self._deployments
                        else None
                    ),
                }
                for name, a in self._apps.items()
            }

    def status(self) -> dict:
        with self._lock:
            return {
                "applications": {
                    name: {
                        "route_prefix": a["route_prefix"],
                        "deployments": {
                            d: {
                                "status": self._deployments[d].status,
                                "replicas": len(self._deployments[d].replicas),
                                # replicas alive but not yet past their first
                                # successful health check
                                "starting": sum(
                                    1
                                    for n in self._deployments[d].replicas
                                    if n
                                    not in self._deployments[d].replica_healthy_once
                                ),
                                "target": self._deployments[d].target,
                                "message": self._deployments[d].message,
                            }
                            for d in a["deployments"]
                            if d in self._deployments
                        },
                    }
                    for name, a in self._apps.items()
                }
            }

    def _event(self, deployment: str, what: str, detail=None) -> None:
        with self._lock:
            self.events.append((time.time(), deployment, what, detail))

    # -- reconciliation -----------------------------------------------------

    def _period(self) -> float:
        """The loop's period: 0.5 s, or a shorter ``metrics_interval_s`` of
        an autoscaled deployment."""
        with self._lock:
            intervals = [s.spec["autoscaling_config"]["metrics_interval_s"]
                         for s in self._deployments.values()
                         if s.spec.get("autoscaling_config")]
        return max(0.02, min([RECONCILE_PERIOD_S, *intervals]))

    def _reconcile_loop(self):
        while not self._stop.wait(self._period()):
            try:
                self._reconcile_once()
                self._autoscale()
            except Exception:
                logger.error("serve reconcile error:\n%s", traceback.format_exc())

    def _reconcile_once(self):
        with self._reconcile_mutex:
            with self._lock:
                states = list(self._deployments.values())
            for state in states:
                if self._stop.is_set():
                    return
                self._health_check(state)
                with self._lock:
                    cur = state.spec.get("code_version", "")
                    stale = [
                        n
                        for n in state.replicas
                        if state.replica_code.get(n, cur) != cur
                    ]
                    # rolling code update: surge ONE extra replica of the
                    # new version, drain one stale replica once a new one
                    # is healthy — repeat until no stale remain
                    surge = 1 if stale else 0
                    delta = state.target + surge - len(state.replicas)
                if delta > 0:
                    for _ in range(delta):
                        if not self._start_replica(state):
                            break
                elif delta < 0:
                    with self._lock:
                        # stale-version replicas first, then those still
                        # starting, then the newest
                        ordered = sorted(
                            state.replicas.items(),
                            key=lambda kv: (
                                state.replica_code.get(kv[0], cur) == cur,
                                kv[0] in state.replica_healthy_once,
                                -state.replica_started_t.get(kv[0], 0.0),
                            ),
                        )
                        victims = ordered[: -delta]
                        for name, _ in victims:
                            self._forget_replica(state, name)
                        if victims:
                            self._bump_version(state)
                    grace = state.spec.get("graceful_shutdown_timeout_s", 20.0)
                    for name, actor in victims:
                        self._graceful_stop(state, name, actor, grace)
                if stale and delta == 0:
                    # at surge capacity: retire one stale replica as soon as
                    # a new-version replica has passed its health check
                    with self._lock:
                        new_ready = [
                            n
                            for n in state.replicas
                            if state.replica_code.get(n) == cur
                            and n in state.replica_healthy_once
                        ]
                        victim = None
                        if new_ready:
                            name = stale[0]
                            actor = state.replicas.get(name)
                            if actor is not None:
                                victim = (name, actor)
                                self._forget_replica(state, name)
                                self._bump_version(state)
                    if victim is not None:
                        grace = state.spec.get("graceful_shutdown_timeout_s", 20.0)
                        self._graceful_stop(state, *victim, grace)
                with self._lock:
                    rolled = all(
                        state.replica_code.get(n, "") == cur
                        for n in state.replicas
                    )
                    state.status = (
                        "RUNNING"
                        if len(state.replicas) == state.target and rolled
                        else "UPDATING"
                    )

    @staticmethod
    def _lease_request(opts: dict) -> tuple[float, float]:
        """(GPU share or cards, CPU slots) a replica leases."""
        resources = dict(opts.get("resources") or {})
        gpu = float(resources.pop("GPU", 0) or 0)
        cpu = float(resources.pop("CPU", opts.get("num_cpus", 0)) or 0)
        if resources:
            raise ValueError(f"serve replicas lease GPU and CPU only, not {sorted(resources)}")
        return gpu, cpu

    def _start_replica(self, state: _DeploymentState) -> bool:
        """Lease, then spawn one replica; False when the ledger has no room
        for its lease (the deployment stays short)."""
        spec = state.spec
        opts = dict(spec.get("ray_actor_options") or {})
        dropped = [k for k in opts if k not in ("resources", "num_cpus")]
        if dropped:
            logger.warning(
                "ray_actor_options keys %s are not honored for serve replicas "
                "(the controller owns concurrency, names and restarts); dropped for %s",
                dropped, state.name,
            )
        with self._lock:
            replica_name = f"serve:{state.name}#{state.next_replica_id}"
        ledger = default_ledger()
        try:
            gpu, cpu = self._lease_request(opts)
            lease, = assign_cards(1, gpu, f"serve replica {replica_name}", cpu=cpu,
                                  ledger=ledger)
        except (LedgerError, RuntimeError, ValueError) as e:
            with self._lock:
                if state.message != str(e):
                    logger.warning("%s: %s", replica_name, e)
                state.message = str(e)
            return False
        with self._lock:
            state.next_replica_id += 1
            state.message = ""
        t0 = time.time()
        actor = ProcessActor(
            _replica_cls(),
            (spec["serialized_target"], spec["init_args_payload"], state.name,
             replica_name, (self.router.address, self.router.authkey),
             # the driver's ledger, its cards resolved here (the replica may
             # see none), for what the replica spawns
             CardLedger(ledger.root, cards=ledger.card_ids(), cpus=ledger.cpu_total())),
            lease=lease, name=replica_name,
            # +2 headroom so control-plane calls (check_health,
            # get_metrics, reconfigure) can't starve behind a saturated
            # request pool and get a healthy replica killed
            max_concurrency=spec.get("max_ongoing_requests", 8) + 2,
            leads_group=True,
        )
        with self._lock:
            state.replicas[replica_name] = actor
            state.replica_started_t[replica_name] = t0
            state.replica_code[replica_name] = spec.get("code_version", "")
        self._event(state.name, "start", {"replica": replica_name, "pid": actor.pid,
                                          "lease": lease.cards if lease else []})

        def on_ready(result, name=replica_name):
            with self._lock:
                if state.replicas.get(name) is not actor:
                    return
                if result._ok:
                    state.replica_alive_t.setdefault(name, time.time())
                else:  # its constructor raised: the error's last line
                    lines = str(result._value).strip().splitlines()
                    state.message = f"{name} failed to start: {lines[-1] if lines else ''}"
                self._bump_version(state)
            self._event(state.name, "ready" if result._ok else "failed", {"replica": name})

        actor.ready.add_done_callback(on_ready)
        return True

    @staticmethod
    def _replica_actor_state(actor: ProcessActor) -> Optional[str]:
        """The replica's state, as the JAX controller reads its actor's:
        PENDING while its constructor runs, ALIVE after, DEAD when its
        process is gone or its constructor raised."""
        if not actor.is_alive() or (actor.ready.done and not actor.ready._ok):
            return "DEAD"
        return "ALIVE" if actor.ready.done else "PENDING"

    @staticmethod
    def _starting_verdict(
        actor_state: Optional[str],
        started_t: float,
        alive_t: Optional[float],
        grace_s: Optional[float],
        timeout_s: float,
        now: float,
    ) -> str:
        """Decide a STARTING (never-yet-healthy) replica's fate — the
        slow-startup half of the replica state machine (reference:
        ``deployment_state.py:1391``):

        - process DEAD/gone                  -> "replace" (crashed in __init__)
        - PENDING (still in __init__)        -> "wait", unless the
          deployment's ``initial_health_grace_s`` is set and exceeded
        - ALIVE (init returned)              -> the hung-replica timeout
          clock starts at this FIRST READINESS: replace only once
          ``timeout_s`` has elapsed since without a successful health check
        - state unknowable                   -> "wait"
        """
        if actor_state == "DEAD":
            return "replace"
        if actor_state == "ALIVE":
            if alive_t is not None and now - alive_t > timeout_s:
                return "replace"
            return "wait"
        if actor_state in ("PENDING", "RESTARTING"):
            if grace_s is not None and now - started_t > grace_s:
                return "replace"
            return "wait"
        return "wait"

    def _forget_replica(self, state: _DeploymentState, name: str):
        """Drop all per-replica bookkeeping (callers hold self._lock)."""
        state.replicas.pop(name, None)
        state.replica_started_t.pop(name, None)
        state.replica_alive_t.pop(name, None)
        state.replica_healthy_once.discard(name)
        state.replica_code.pop(name, None)

    def _health_check(self, state: _DeploymentState):
        now = time.time()
        if now - state.last_health_t < state.spec.get("health_check_period_s", 2.0):
            return
        state.last_health_t = now
        with self._lock:
            replicas = list(state.replicas.items())
        if not replicas:
            return
        dead = []
        timeout = state.spec.get("health_check_timeout_s", 30)
        grace = state.spec.get("initial_health_grace_s")
        checks = []
        for name, actor in replicas:
            actor_state = self._replica_actor_state(actor)
            if actor_state == "ALIVE":
                checks.append((name, actor, actor.call("check_health")))
                continue
            # still constructing, or gone: the verdict needs no call
            verdict = self._starting_verdict(
                actor_state, state.replica_started_t.get(name, 0.0),
                state.replica_alive_t.get(name), grace, timeout, time.time())
            if verdict == "replace" or name in state.replica_healthy_once:
                dead.append((name, actor))
        # one shared deadline: a single hung replica must not stall the
        # reconcile loop for timeout x num_replicas
        deadline = time.time() + timeout
        for name, actor, pending in checks:
            try:
                get(pending, timeout=max(0.1, deadline - time.time()))
                state.replica_healthy_once.add(name)
            except TimeoutError:
                if name in state.replica_healthy_once:
                    dead.append((name, actor))  # was serving, now unresponsive
                    continue
                verdict = self._starting_verdict(
                    self._replica_actor_state(actor),
                    state.replica_started_t.get(name, 0.0),
                    state.replica_alive_t.get(name), grace, timeout, time.time())
                if verdict == "replace":
                    dead.append((name, actor))
            except ActorError:
                dead.append((name, actor))
        for name, actor in dead:
            logger.warning("replica %s unhealthy; replacing", name)
            with self._lock:
                self._forget_replica(state, name)
                self._bump_version(state)
            actor.kill()
            self._event(state.name, "replaced", {"replica": name})

    def _replica_metrics(self, actors: list) -> list:
        """Each replica's ``get_metrics`` (None where it did not answer)."""
        pending = [a.call("get_metrics") for a in actors]
        out = []
        for p in pending:
            try:
                out.append(get(p, timeout=5))
            except (ActorError, TimeoutError):
                out.append(None)
        return out

    def _autoscale(self):
        from ray_tpu_torch.serve.config import AutoscalingConfig

        with self._lock:
            states = list(self._deployments.values())
        for state in states:
            ac_dict = state.spec.get("autoscaling_config")
            if not ac_dict:
                continue
            ac = AutoscalingConfig(**ac_dict)
            with self._lock:
                replicas = list(state.replicas.values())
            total = 0.0
            for m in self._replica_metrics(replicas):
                if m is not None:
                    total += m["ongoing"]
            now = time.time()
            state.metric_window.append((now, total))
            state.metric_window = [
                (t, v) for t, v in state.metric_window if now - t < 60
            ]
            desired = ac.desired_replicas(total, len(replicas) or 1)
            before = state.target
            if desired > state.target:
                # upscale only after sustained pressure
                window = [
                    v for t, v in state.metric_window if now - t <= ac.upscale_delay_s
                ]
                if window and min(window) / max(len(replicas), 1) > ac.target_ongoing_requests:
                    state.target = desired
                    state.last_scale_t = now
            elif desired < state.target:
                window = [
                    v
                    for t, v in state.metric_window
                    if now - t <= ac.downscale_delay_s
                ]
                sustained = len(window) >= 2 and all(
                    v / max(len(replicas), 1) < ac.target_ongoing_requests
                    for v in window
                )
                if sustained and now - state.last_scale_t > ac.downscale_delay_s:
                    state.target = desired
                    state.last_scale_t = now
            if state.target != before:
                self._event(state.name, "target", {"from": before, "to": state.target,
                                                   "ongoing": total})

    # -- teardown helpers ---------------------------------------------------

    def _graceful_stop(self, state: _DeploymentState, name: str, actor: ProcessActor,
                       grace_s: float = 20.0):
        try:
            get(actor.call("prepare_shutdown", grace_s), timeout=grace_s + 5)
        except (ActorError, TimeoutError):
            pass
        actor.kill()
        self._event(state.name, "stop", {"replica": name})


def _replica_cls():
    from ray_tpu_torch.serve.replica import ReplicaActor

    return ReplicaActor


class RouterServer:
    """The driver's router for handles inside replicas: a Unix-socket
    ``Listener`` (authkey-checked), one thread a connection reading
    requests, one thread a request routing it through a driver
    ``DeploymentHandle`` (the one routing policy) and sending its reply or
    its chunks back under the request's id. A ``("cancel", id)`` from the
    replica cancels a relayed stream."""

    def __init__(self):
        from multiprocessing.connection import Listener

        self._dir = tempfile.mkdtemp(prefix="ray_tpu_torch-serve-")
        self.address = os.path.join(self._dir, "router")
        self.authkey = os.urandom(32)
        self._listener = Listener(self.address, family="AF_UNIX", authkey=self.authkey)
        self._handles: dict = {}
        self._lock = threading.Lock()
        self._conns: list = []
        self._closed = False
        threading.Thread(target=self._accept, name="serve-router", daemon=True).start()

    def _handle(self, name: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        with self._lock:
            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(name)
            return h

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
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), name="serve-router-conn",
                             daemon=True).start()

    def _serve(self, conn):
        send_lock = threading.Lock()
        streams: dict = {}

        def send(msg):
            try:
                data = pickle.dumps(msg)
            except Exception:  # noqa: BLE001 — a value or error that does not pickle
                data = pickle.dumps((msg[0], "err", RuntimeError(repr(msg[2]))))
            try:
                with send_lock:
                    conn.send_bytes(data)
            except OSError:
                pass

        def unary(req_id, name, method, args, kwargs):
            try:
                resp = self._handle(name)._call(method, args, kwargs)
            except Exception as e:  # noqa: BLE001 — goes back to the caller
                return send((req_id, "err", e))

            def done(p):
                send((req_id, "ok", p._value) if p._ok else (req_id, "err", p._value))

            resp._pending.add_done_callback(done)

        def stream(req_id, name, method, args, kwargs):
            try:
                source = self._handle(name)._open_stream(method, args, kwargs)
                streams[req_id] = source
                for item in source:
                    send((req_id, "item", item))
                send((req_id, "end", None))
            except Exception as e:  # noqa: BLE001 — goes back to the caller
                send((req_id, "err", e))
            finally:
                streams.pop(req_id, None)

        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            except Exception:  # noqa: BLE001 — a request that did not unpickle
                traceback.print_exc()
                continue
            if msg[0] == "cancel":
                source = streams.get(msg[1])
                if source is not None:
                    source.cancel()
                continue
            kind, req_id, name, method, args, kwargs = msg
            target = unary if kind == "call" else stream
            threading.Thread(target=target, args=(req_id, name, method, args, kwargs),
                             name="serve-router-req", daemon=True).start()
        for source in list(streams.values()):
            source.cancel()

    def close(self):
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        shutil.rmtree(self._dir, ignore_errors=True)
