"""A gang as a deployment: ``ray_tpu_torch.llm.build_gang_deployment`` at tp2
on the CPU, i.e. a replica process (a process group's leader) hosting a
``GangLLMServer`` whose two gloo rank processes it spawns itself.

Its greedy completions through the HTTP proxy (the gang's own entry,
``GangLLMServer.__call__``) equal the JAX package's ``LLMServer`` on a
2-device tp mesh, reading the same JAX ``save_pytree`` checkpoint
(tolerance 0 on token ids: texts equal). A killed replica takes its ranks
with it and is replaced by a new gang that serves the same text;
``serve.delete`` and ``serve.shutdown`` leave no rank process, no
``serve:`` process and no lease (the replica's CPU slot, in the shutdown
leg). This module imports neither JAX nor ray_tpu at its top (replicas
spawn rank processes that import the main module).
"""

import json
import multiprocessing
import os
import signal
import time
import urllib.request

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch._private.spawn_env import _group_members
from tests.test_torch_llm_batch import _config, _jax_config, checkpoint  # noqa: F401

pytestmark = pytest.mark.timeout(300)

PROMPTS = ["abc", "serve this prompt", "the third one"]


def _body(prompt):
    return {"prompt": prompt, "max_tokens": 6, "temperature": 0.0}


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


def _controller():
    from ray_tpu_torch.serve import api

    return api._controller


def _gang_cfg(checkpoint):  # noqa: F811
    return _config(checkpoint, tensor_parallel_degree=2)


def _ready_replica(name: str, not_pid=None, timeout_s: float = 120.0):
    """The deployment's one ready replica (another than ``not_pid``'s)."""
    deadline = time.monotonic() + timeout_s
    while True:
        ready = [a for _, a in _controller().get_replicas_versioned(name)[1] if a.pid != not_pid]
        if ready:
            return ready[0]
        assert time.monotonic() < deadline, f"{name}: no replica ready"
        time.sleep(0.05)


def _gone(pid: int, timeout_s: float = 15.0) -> list:
    """Waits until no process of ``pid``'s process group is alive; returns
    those still alive at the deadline."""
    deadline = time.monotonic() + timeout_s
    while (left := _group_members(pid)) and time.monotonic() < deadline:
        time.sleep(0.05)
    return left


@pytest.fixture(scope="module")
def jax_texts(checkpoint):  # noqa: F811
    """JAX's LLMServer on a 2-device tp mesh: the greedy texts."""
    import jax

    from ray_tpu.llm import server as jserver
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(tp=2), devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver, "JaxEngine", lambda config: JaxEngine(config, mesh=mesh))
        server = jserver.LLMServer(_jax_config(_gang_cfg(checkpoint)))
    try:
        return [server.completions(_body(p))["choices"][0]["text"] for p in PROMPTS]
    finally:
        server.engine.shutdown()


@pytest.fixture(scope="module")
def gang_app(checkpoint, tmp_path_factory):  # noqa: F811
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_gang_deployment

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        app = build_gang_deployment(_gang_cfg(checkpoint), num_workers=2, device="cpu")
        serve.run(app, name="gang", route_prefix="/gang", _wait_for_ready_s=120)
        _, port = serve.start_proxy(port=0)
        try:
            yield port, ledger, app
        finally:
            serve.shutdown()
        assert _serve_children() == [] and ledger.holders() == []


def _texts(port: int) -> list:
    out = []
    for p in PROMPTS:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/gang/v1/completions",
                                     data=json.dumps(_body(p)).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out.append(json.loads(r.read())["choices"][0]["text"])
    return out


def test_gang_deployment_completions_equal_jax(gang_app, jax_texts):
    port, _, _ = gang_app
    actor = _ready_replica("gang:tiny")
    ranks = [p for p in _group_members(actor.pid) if p != actor.pid]
    assert len(ranks) >= 2  # the replica's own gloo ranks, in its process group
    assert _texts(port) == jax_texts
    assert all(len(t) > 0 for t in jax_texts)


def test_killed_replica_takes_its_ranks_and_is_replaced(gang_app, jax_texts):
    port, _, _ = gang_app
    actor = _ready_replica("gang:tiny")
    os.kill(actor.pid, signal.SIGKILL)
    assert _gone(actor.pid) == []  # the ranks ended with their replica
    new = _ready_replica("gang:tiny", not_pid=actor.pid)
    assert _texts(port) == jax_texts
    assert any(e[2] == "replaced" and e[1] == "gang:tiny" for e in _controller().events)
    assert {a.pid for a in _controller().replicas("gang:tiny").values()} == {new.pid}


def test_delete_and_shutdown_end_the_ranks_and_their_leases(gang_app):
    from ray_tpu_torch import serve

    port, ledger, app = gang_app
    actor = _ready_replica("gang:tiny")
    serve.delete("gang")
    assert _gone(actor.pid) == []
    assert _serve_children() == [] and ledger.holders() == []

    # again, the replica holding a CPU slot, ended by serve.shutdown
    app.deployment = app.deployment.options(ray_actor_options={"resources": {"CPU": 1}})
    with use_ledger(ledger):
        serve.run(app, name="gang", route_prefix="/gang", _wait_for_ready_s=120)
        actor = _ready_replica("gang:tiny")
        assert [h.pid for h in ledger.holders()] == [actor.pid]
        assert len(_group_members(actor.pid)) >= 3
        serve.shutdown()
    assert _gone(actor.pid) == []
    assert _serve_children() == [] and ledger.holders() == []
