"""Elastic training in the port (``ScalingConfig(min_workers=...)``,
``train/_internal/controller.py:ElasticScalingPolicy``) against the JAX
package's, on the CPU.

- ``ScalingConfig`` accepts and rejects what JAX's does, over a grid.
- ``group_size(attempt)`` and sequences of ``resize_decision`` give JAX's
  sizes over a grid. JAX's capacity comes from a monkeypatched
  ``ray_tpu.available_resources``; the port's from a test ledger
  (``_private/cards.py``: 8 cards, 64 CPU slots) with a holder leasing what
  is not available, or a ledger that cannot be read where JAX's call raises.
- The midrun resize (``tests/test_train.py:test_elastic_midrun_resize``) on
  gloo ranks of 2 CPU slots, a ledger of 8 and a holder of 4: the group
  starts at 2 of 4 ranks, the holder lets go, and the group grows to 4 from
  its latest checkpoint, no failure charged. The loop is the example's
  (``examples/train_llama_dp.py``, tiny Llama in fp32, a global batch of 8
  rows a step, a state checkpoint every 2 steps), each report followed by
  the reference test's pause, and its per-step losses lie within rtol 1e-5
  of JAX's ``make_train_step`` on the same global batches from the same
  weights (well-conditioned, as ``test_torch_trainer.py`` draws them).
- A failure shrinks the group (4 -> 2), charged once; too few free slots is
  a start failure, charged to the budget; ``fit()`` refuses at once a GPU
  group whose cards are held, naming the holder.

Each multi-rank test runs its fit under a deadline: past it, the ranks are
killed and the test fails. Ranks import this module by name (the loops
live here), so it imports neither JAX nor ray_tpu at its top.
"""

import multiprocessing
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch.train as train
from ray_tpu_torch._private.cards import CardLedger, LedgerError, use_ledger
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.train._internal.controller import (ElasticScalingPolicy, RunState,
                                                      TrainController)

pytestmark = pytest.mark.timeout(300)

DEADLINE_S = 180.0


# ---- ScalingConfig -------------------------------------------------------------

CONFIGS = [
    dict(num_workers=2),
    dict(num_workers=0),
    dict(num_workers=-1, min_workers=1),
    dict(num_workers=4, min_workers=2),
    dict(num_workers=4, min_workers=4),
    dict(num_workers=4, min_workers=5),
    dict(num_workers=1, min_workers=0),
    dict(num_workers=2, max_workers=4),
    dict(num_workers=2, max_workers=1),
    dict(num_workers=4, min_workers=2, max_workers=8),
    dict(num_workers=4, min_workers=6, max_workers=8),
]


def _outcome(cls, kw):
    try:
        c = cls(**kw)
    except Exception as e:  # the type is what is compared
        return type(e).__name__
    return ("ok", c.elastic, c.min_workers, c.max_workers)


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=lambda kw: "-".join(f"{k[:3]}{v}" for k, v in kw.items()))
def test_scaling_config_accepts_and_rejects_as_jax(kw):
    from ray_tpu.train.config import ScalingConfig as JaxScalingConfig

    assert _outcome(ScalingConfig, kw) == _outcome(JaxScalingConfig, kw)


# ---- the policy's arithmetic ---------------------------------------------------------

CARDS, CPUS = 8, 64


class _Host:
    """The port's side of an available-resources dict: a test ledger of 8
    cards and 64 CPU slots with one holder leasing the rest, or, for None, a
    ledger whose directory cannot be made (JAX's call raises there)."""

    def __init__(self, tmp_path):
        self.ledger = CardLedger(str(tmp_path / "ledger"), cards=[str(i) for i in range(CARDS)],
                                 cpus=CPUS)
        blocked = tmp_path / "blocked"
        blocked.write_text("a file where the ledger's directory would be")
        self.unreadable = CardLedger(str(blocked))
        self.holder = None

    def offer(self, avail):
        if self.holder is not None:
            self.holder.release()
            self.holder = None
        if avail is None:
            return self.unreadable
        held = {"GPU": CARDS - avail.get("GPU", CARDS), "CPU": CPUS - avail.get("CPU", CPUS)}
        held = {k: v for k, v in held.items() if v}
        if held:
            self.holder, = self.ledger.acquire([held], "holder")
        return self.ledger


def _jax_available(monkeypatch, avail):
    import ray_tpu

    def available_resources():
        if avail is None:
            raise RuntimeError("no cluster")
        return {"CPU": float(CPUS), "GPU": float(CARDS), **{k: float(v) for k, v in avail.items()}}

    monkeypatch.setattr(ray_tpu, "available_resources", available_resources)


def _configs(n, lo, res):
    """The port's and JAX's ScalingConfig: GPU ranks where ``res`` names a
    GPU (the port's ``use_gpu``), CPU ranks otherwise."""
    from ray_tpu.train.config import ScalingConfig as JaxScalingConfig

    gpu = bool(res and "GPU" in res)
    return (ScalingConfig(num_workers=n, min_workers=lo, use_gpu=gpu, resources_per_worker=res),
            JaxScalingConfig(num_workers=n, min_workers=lo, resources_per_worker=res))


GROUP_SIZE_CASES = [
    # (num_workers, min_workers, resources_per_worker, attempt, available)
    (4, 2, {"CPU": 2}, 0, {"CPU": 4}),
    (4, 2, {"CPU": 2}, 0, {"CPU": 8}),
    (4, 2, {"CPU": 2}, 0, {"CPU": 2}),
    (4, 2, {"CPU": 2}, 1, {"CPU": 16}),
    (4, 2, {"CPU": 2}, 2, {"CPU": 16}),
    (4, 2, {"CPU": 2}, 1, {"CPU": 3}),
    (8, 1, {"CPU": 1}, 3, {"CPU": 64}),
    (8, 3, {"CPU": 1}, 1, {"CPU": 5}),
    (8, 3, {"CPU": 1}, 0, {"CPU": 5}),
    (4, 2, None, 0, {"CPU": 3}),
    (4, None, {"CPU": 1}, 2, {"CPU": 1}),
    (4, 2, {"GPU": 1}, 0, {"GPU": 3}),
    (4, 2, {"GPU": 1}, 0, {"GPU": 1}),
    (4, 1, {"GPU": 1}, 1, {"GPU": 8}),
    (4, 1, {"GPU": 2}, 0, {"GPU": 5}),
    (4, 2, {"CPU": 2}, 0, None),
    (4, 2, {"CPU": 2}, 1, None),
]


@pytest.mark.parametrize("n,lo,res,attempt,avail", GROUP_SIZE_CASES)
def test_group_size_as_jax(n, lo, res, attempt, avail, monkeypatch, tmp_path):
    from ray_tpu.train._internal.controller import ElasticScalingPolicy as JaxPolicy

    port, jax_cfg = _configs(n, lo, res)
    _jax_available(monkeypatch, avail)
    want = JaxPolicy(jax_cfg).group_size(attempt)
    host = _Host(tmp_path)
    with use_ledger(host.offer(avail)):
        got = ElasticScalingPolicy(port).group_size(attempt)
    host.offer({})
    assert got == want


RESIZE_CASES = [
    # (num_workers, min_workers, resources, current size, available at each check)
    (4, 2, {"CPU": 2}, 2, [{"CPU": 4}] * 3),
    (4, 2, {"CPU": 2}, 2, [{"CPU": 4}, {"CPU": 2}, {"CPU": 4}, {"CPU": 4}, {"CPU": 4}]),
    (4, 2, {"CPU": 2}, 2, [{"CPU": 0}, {"CPU": 4}, {"CPU": 4}, {"CPU": 0}] + [{"CPU": 4}] * 3),
    (4, 2, {"CPU": 2}, 4, [{"CPU": 8}] * 3),
    (8, 1, {"CPU": 1}, 2, [{"CPU": 3}] * 6),
    (4, 2, {"GPU": 1}, 2, [{"GPU": 1}] * 3),
    (4, 2, {"GPU": 1}, 1, [{"GPU": 2}, {"GPU": 3}, {"GPU": 3}, {"GPU": 3}]),
    (4, 2, {"CPU": 2}, 2, [None, {"CPU": 4}, None, {"CPU": 4}, {"CPU": 4}]),
    (4, 2, None, 3, [{"CPU": 1}] * 4),
]


@pytest.mark.parametrize("n,lo,res,current,seq", RESIZE_CASES)
def test_resize_decisions_as_jax(n, lo, res, current, seq, monkeypatch, tmp_path):
    from ray_tpu.train._internal.controller import ElasticScalingPolicy as JaxPolicy

    port_cfg, jax_cfg = _configs(n, lo, res)
    jax_policy, port_policy = JaxPolicy(jax_cfg), ElasticScalingPolicy(port_cfg)
    host = _Host(tmp_path)
    want, got = [], []
    for avail in seq:
        _jax_available(monkeypatch, avail)
        want.append(jax_policy.resize_decision(current))
        with use_ledger(host.offer(avail)):
            got.append(port_policy.resize_decision(current))
    host.offer({})
    assert got == want


# ---- fits ------------------------------------------------------------------------


def _no_rank_left():
    left = [p for p in multiprocessing.active_children() if "-rank-" in p.name]
    assert not left, left


def _fit(trainer, while_running=None):
    """``trainer.fit()`` in a thread, ``while_running(controller)`` polled
    until it returns True, under ``DEADLINE_S``: past it, the ranks are
    killed (the run then fails) and the test fails."""
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # re-raised in the test
            box["error"] = e

    t = threading.Thread(target=run, name="fit", daemon=True)
    t.start()
    deadline = time.monotonic() + DEADLINE_S
    pending = while_running is not None
    while t.is_alive() and time.monotonic() < deadline:
        if pending and getattr(trainer, "_controller", None) is not None:
            pending = not while_running(trainer._controller)
        t.join(0.05)
    if t.is_alive():
        for p in multiprocessing.active_children():
            if "-rank-" in p.name:
                p.kill()
        t.join(60)
        pytest.fail(f"fit() did not finish within {DEADLINE_S:.0f} s")
    if "error" in box:
        raise box["error"]
    return box["result"]


def _paced_example_loop(config):
    """The example's train loop, each report followed by the reference
    test's pause, so the group is still stepping when the host has room."""
    from ray_tpu_torch.examples import train_llama_dp as ex

    report = train.report

    def paced(metrics, checkpoint=None):
        report(metrics, checkpoint=checkpoint)
        time.sleep(config["pause_s"])

    train.report = paced  # in this rank process only
    ex.train_loop(config)


OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)
LLAMA = {"model": "tiny", "steps": 20, "global_batch": 8, "seq_len": 16, "seed": 3,
         "optimizer": OPT, "state_checkpoint_every": 2, "pause_s": 0.2}


def _conditioned(shapes: dict, seed: int) -> dict:
    """Norms ones, every other weight N(0, 1) / sqrt(d_model) in fp32."""
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """The example loop on an elastic group of 4 (min 2) gloo ranks of 2 CPU
    slots on a ledger of 8, while a holder leases 4: it starts at 2, and the
    holder lets go once step 2's checkpoint is in."""
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt

    tmp = tmp_path_factory.mktemp("grown")
    cfg = ex.model_config(LLAMA)
    params = _conditioned(tl._param_shapes(cfg), seed=11)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = tt.default_optimizer(**OPT)
    start = Checkpoint.from_state_dict(tt.TrainState(tparams, opt.init(tparams), 0).state_dict())
    ledger = CardLedger(str(tmp / "ledger"), cards=[], cpus=8)
    with use_ledger(ledger):
        holder, = ledger.acquire([{"CPU": 4}], "holder")
        trainer = TorchTrainer(
            _paced_example_loop, train_loop_config=LLAMA,
            scaling_config=ScalingConfig(num_workers=4, min_workers=2, use_gpu=False,
                                         resources_per_worker={"CPU": 2}),
            run_config=RunConfig(name="grown", storage_path=str(tmp / "results")),
            resume_from_checkpoint=start,
        )

        def let_go(controller):
            if any(m["step"] >= 2 for m in controller.metrics_history):
                holder.release()
                return True
            return False

        try:
            result = _fit(trainer, let_go)
        finally:
            holder.release()
        holders = ledger.holders()
    return {"result": result, "controller": trainer._controller, "params": params,
            "holders_after": holders}


def test_elastic_midrun_resize(grown):
    """``tests/test_train.py:test_elastic_midrun_resize`` on the port's ranks."""
    result, controller = grown["result"], grown["controller"]
    assert result.error is None, result.error
    h = result.metrics_history
    sizes = {m["world_size"] for m in h}
    assert {2, 4} <= sizes, sizes  # started at what was free, grew to num_workers
    assert [a["size"] for a in controller.attempts[:2]] == [2, 4], controller.attempts
    assert h[-1]["step"] == LLAMA["steps"]
    assert controller.num_resizes >= 1
    assert controller.failure_policy.failures == 0
    assert controller.attempts[0]["outcome"] == "resize"
    assert len(controller.rank_startup_s) == len(controller.attempts)
    # resumed from a checkpoint, not from the start: the first step at 4
    # ranks follows the latest checkpoint, every step is seen at most twice
    first4 = next(m for m in h if m["world_size"] == 4)
    assert first4["resumed_from_step"] >= 2 and first4["resumed_from_step"] % 2 == 0
    assert "attempt_000" in first4["resumed_from"]
    assert first4["step"] == first4["resumed_from_step"] + 1
    steps = [m["step"] for m in h]
    assert sorted(set(steps)) == list(range(1, LLAMA["steps"] + 1))
    assert max(steps.count(s) for s in steps) <= 2
    _no_rank_left()
    assert grown["holders_after"] == []  # every rank's lease ended with it


def test_resized_losses_match_jax(grown):
    """Every step's loss, before and after the resize (replayed steps too),
    within rtol 1e-5 of JAX's make_train_step on the same global batch from
    the same weights: the run computes one function at either size."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.examples import train_llama_dp as ex

    result = grown["result"]
    assert result.error is None, result.error
    cfg = ex.model_config(LLAMA)
    jcfg = jl.LlamaConfig.tiny(max_seq_len=LLAMA["seq_len"])
    mesh = build_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    jopt = jt.default_optimizer(**OPT)
    _, jstep = jt.make_train_step(jcfg, mesh, optimizer=jopt)
    jp = {k: jnp.asarray(v) for k, v in grown["params"].items()}
    jstate = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jlosses = []
    for step in range(LLAMA["steps"]):
        tokens = ex.global_batch(cfg, LLAMA, LLAMA["seed"], step)
        jbatch = jax.device_put({"tokens": jnp.asarray(tokens)}, jt.batch_sharding(mesh))
        jstate, jm = jstep(jstate, jbatch)
        jlosses.append(float(jm["loss"]))
    h = result.metrics_history
    got = [m["loss"] for m in h]
    want = [jlosses[m["step"] - 1] for m in h]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _loop_fails_at_full_size(config):
    """Rank 0 of a group of 4 fails after its second report (its reports
    reach the controller before its error: they share its pipe)."""
    ctx = train.get_context()
    ws = ctx.get_world_size()
    for i in range(config["steps"]):
        train.report({"i": i, "world_size": ws})
        if ws == 4 and i == 1 and ctx.get_world_rank() == 0:
            raise RuntimeError("a rank of the full group failed")


def test_failure_shrinks_the_group_and_is_charged(tmp_path):
    """Attempt 0 at 4 ranks fails; attempt 1 runs at 4 // 2 = 2 (the
    reference's back-off), and the failure is charged once. No checkpoint,
    so no resize back."""
    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)) as ledger:
        trainer = TorchTrainer(
            _loop_fails_at_full_size, train_loop_config={"steps": 4},
            scaling_config=ScalingConfig(num_workers=4, min_workers=2, use_gpu=False,
                                         resources_per_worker={"CPU": 2}),
            run_config=RunConfig(name="shrink", storage_path=str(tmp_path / "results"),
                                 failure_config=FailureConfig(max_failures=1)),
        )
        result = _fit(trainer)
        assert ledger.holders() == []
    assert result.error is None, result.error
    c = trainer._controller
    assert [(a["size"], a["outcome"]) for a in c.attempts] == [(4, "failed"), (2, "done")]
    assert (c.failure_policy.failures, c.num_resizes) == (1, 0)
    assert [m["world_size"] for m in result.metrics_history] == [4, 4, 2, 2, 2, 2]
    assert result.metrics_history[-1]["i"] == 3
    _no_rank_left()


def test_too_few_free_slots_is_a_start_failure(tmp_path):
    """With the slots held, each attempt fails to start (no rank spawned)
    and is charged; the error names the holder."""
    ledger = CardLedger(str(tmp_path / "ledger"), cards=[], cpus=4)
    with use_ledger(ledger):
        holder, = ledger.acquire([{"CPU": 3}], "holder")
        try:
            controller = TrainController(
                _loop_fails_at_full_size, {"steps": 1},
                ScalingConfig(num_workers=2, min_workers=1, use_gpu=False,
                              resources_per_worker={"CPU": 2}),
                RunConfig(name="held", storage_path=str(tmp_path),
                          failure_config=FailureConfig(max_failures=1)),
                experiment_dir=str(tmp_path / "held"),
            )
            out = controller.run()
        finally:
            holder.release()
    assert out.state is RunState.ERRORED
    assert controller.failure_policy.failures == 2
    # capacity 0 < min: the full size, refused; the retry halved, refused too
    assert controller.attempts == [{"size": 2, "outcome": "not started"},
                                   {"size": 1, "outcome": "not started"}]
    assert re.search(rf"LedgerError.*held by pid {os.getpid()} \(holder: 3 CPU", out.error), \
        out.error


def test_fit_refuses_a_held_card_at_once(tmp_path):
    """A one-card GPU group on a ledger whose one card is held: ``fit()``
    raises before any rank starts, naming the holder's pid."""
    ledger = CardLedger(str(tmp_path / "ledger"), cards=["0"], cpus=4)
    with use_ledger(ledger):
        holder, = ledger.acquire([{"GPU": 1}], "holder")
        try:
            for scaling in (ScalingConfig(num_workers=1),
                            ScalingConfig(num_workers=2, min_workers=1)):
                with pytest.raises(LedgerError, match=rf"held by pid {os.getpid()} "
                                                      r"\(holder: card 0\)"):
                    TorchTrainer(_loop_fails_at_full_size, train_loop_config={"steps": 1},
                                 scaling_config=scaling,
                                 run_config=RunConfig(storage_path=str(tmp_path))).fit()
        finally:
            holder.release()
        assert ledger.holders() == []
