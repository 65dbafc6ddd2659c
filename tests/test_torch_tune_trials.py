"""The port's Tune trials on its own processes (``ray_tpu_torch/tune/tuner.py``).

Each trial is a 1-rank process leasing what it names from a test ledger
(``_private/cards.py``; CPU slots here, no card). Covered:

- a trial SIGKILLed under ``FailureConfig(max_failures=1)`` restarts from
  its checkpoint, its death seen through its sentinel; ``with_parameters``'
  arguments reach it; with three of the ledger's four CPU slots held
  outside the sweep, the second trial waits PENDING for the first's slot
  (never two at once);
- a closure or a lambda raises ``TypeError`` at ``fit()``; a GPU trial on a
  host with no card and a trial larger than the host fail ``fit()`` at
  once, naming the counts, before any process starts;
- sync HyperBand pauses a trial at its rung and resumes it from its
  checkpoint in a new process;
- PBT restarts the weaker trial from the donor's checkpoint;
- ``Tuner.restore`` after the driver is SIGKILLed mid-sweep: the orphaned
  trial ends its process group itself, its lease frees, and the restored
  sweep resumes the interrupted trial from its checkpoint;
- ``TorchTrainer.as_trainable`` (the trial process leases a CPU slot, its
  nested rank another, from the driver's ledger) and ``PPO.as_trainable``
  on the CPU;
- after every fit, no lease is held and no trial process, nor anything it
  spawned, is left.

Trial processes import this module by name (the trainables live here), so
it imports neither JAX nor ray_tpu at its top.
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import time

import pytest

from ray_tpu_torch import tune
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch._private.spawn_env import _group_members
from ray_tpu_torch.tools.tune_bench import LedgerWatch, align
from ray_tpu_torch.train import Checkpoint, FailureConfig, RunConfig
from ray_tpu_torch.tune import TuneConfig, Tuner

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ledger(tmp_path):
    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=4)) as led:
        yield led


def _clean(tuner, ledger):
    """No lease held, and no trial process or process of a trial's group left."""
    assert ledger.holders() == []
    assert multiprocessing.active_children() == []
    pids = [p for t in tuner._controller.trials for p in t.pids]
    assert pids and all(_group_members(p) == [] for p in pids)


# ---- trainables (imported by name in the trial processes) --------------------------


def counting_trainable(config, data=None, marker_dir=None):
    """Reports i = start..5 with a checkpoint of the next i; the trial of
    ``config["kill_x"]`` SIGKILLs itself after i = 2 the first time."""
    chk = tune.get_checkpoint()
    start = chk.to_dict()["next"] if chk else 0
    for i in range(start, 6):
        tune.report({"i": i, "x": config["x"], "n": len(data), "pid": os.getpid()},
                    checkpoint=Checkpoint.from_dict({"next": i + 1}))
        marker = os.path.join(marker_dir, f"killed-{config['x']}")
        if i == 2 and config["x"] == config["kill_x"] and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.05)


def rung_trainable(config):
    """Reports score = q * (i + 1) from its checkpoint's i onwards."""
    chk = tune.get_checkpoint()
    start = chk.to_dict()["i"] if chk else 0
    for i in range(start, 100):
        tune.report({"score": config["q"] * (i + 1), "q": config["q"], "resumed_at": start},
                    checkpoint=Checkpoint.from_dict({"i": i + 1}))
        time.sleep(0.05)


def pbt_trainable(config):
    """score += lr an iteration, carried in the checkpoint. After its first
    report a trial waits until both trials have made theirs, so the two
    step side by side however late a process starts."""
    chk = tune.get_checkpoint()
    score = chk.to_dict()["score"] if chk else 0.0
    for i in range(12):
        score += config["lr"]
        tune.report({"score": score, "lr": config["lr"]},
                    checkpoint=Checkpoint.from_dict({"score": score}))
        if i == 0:
            align(config["sync_dir"], 2)
        time.sleep(0.1)


def slow_trainable(config):
    """40 reports 0.3 s apart, each with a checkpoint; a marker file each."""
    chk = tune.get_checkpoint()
    start = chk.to_dict()["i"] + 1 if chk else 0
    for i in range(start, 40):
        open(os.path.join(config["marker_dir"], f"{config['x']}-{i}"), "w").close()
        tune.report({"score": config["x"] * (i + 1), "i": i},
                    checkpoint=Checkpoint.from_dict({"i": i, "x": config["x"]}))
        time.sleep(0.3)


def fast_trainable(config):
    """The restored sweep's trainable: where its checkpoint left off, then 3 reports."""
    chk = tune.get_checkpoint()
    start = chk.to_dict()["i"] + 1 if chk else 0
    for i in range(3):
        tune.report({"score": config["x"] * 100 + i, "resumed_from": start})


def trainer_loop(config):
    import ray_tpu_torch.train as train

    train.report({"val": config["lr"] * 10, "rank_pid": os.getpid()})


# ---- tests -----------------------------------------------------------------------


def test_killed_trial_restarts_and_a_trial_waits_for_its_lease(ledger, tmp_path):
    """One of the ledger's 4 CPU slots is free to the sweep at a time (a
    holder takes 3 and trials of 1 slot are capped at 2 at once): the
    second trial waits PENDING, and the one SIGKILLed after its third report
    restarts from the checkpoint of that report."""
    holder, = ledger.acquire([{"CPU": 3}], "outside the sweep")
    try:
        trainable = tune.with_parameters(counting_trainable, data=list(range(10)),
                                         marker_dir=str(tmp_path))
        tuner = Tuner(
            tune.with_resources(trainable, {"CPU": 1}),
            param_space={"x": tune.grid_search([1, 2]), "kill_x": 1},
            tune_config=TuneConfig(metric="i", mode="max", max_concurrent_trials=2),
            run_config=RunConfig(name="kill", storage_path=str(tmp_path / "results"),
                                 failure_config=FailureConfig(max_failures=1)),
        )
        with LedgerWatch(ledger) as watch:
            results = tuner.fit()
    finally:
        holder.release()
    assert results.num_errors == 0, results.errors
    assert watch.most("1 tune trial") == 1  # never two trials on one free slot
    by_x = {r.config["x"]: r for r in results}
    for x, r in by_x.items():
        assert [m["i"] for m in r.metrics_history] == list(range(6))
        assert all(m["n"] == 10 for m in r.metrics_history)
    killed = [m["pid"] for m in by_x[1].metrics_history]
    assert killed[2] != killed[3] and len(set(killed)) == 2  # a new process from i = 3
    trials = {t.config["x"]: t for t in tuner._controller.trials}
    assert trials[1].num_failures == 1 and len(trials[1].startup_s) == 2
    assert trials[2].num_failures == 0 and trials[2].num_starts == 1
    _clean(tuner, ledger)


def _closure_trainable():
    def trainable(config):
        tune.report({"x": 1})

    return trainable


@pytest.mark.parametrize("trainable", [_closure_trainable(), lambda config: None],
                         ids=["closure", "lambda"])
def test_closure_trainable_raises_type_error(trainable, ledger, tmp_path):
    tuner = Tuner(trainable, param_space={"x": 1},
                  run_config=RunConfig(name="c", storage_path=str(tmp_path / "results")))
    with pytest.raises(TypeError, match="picklable by reference"):
        tuner.fit()
    assert not (tmp_path / "results").exists()


@pytest.mark.parametrize("resources,match", [
    ({"GPU": 0.25}, r"trials of \{'GPU': 0.25\} need a CUDA device, but none is visible"),
    ({"CPU": 5}, "needs 5 CPU slots, but the host has 4"),
])
def test_what_the_host_never_grants_fails_fit_at_once(resources, match, ledger, tmp_path):
    trainable = tune.with_resources(tune.with_parameters(counting_trainable), resources)
    tuner = Tuner(trainable, param_space={"x": 1, "kill_x": 0},
                  run_config=RunConfig(name="never", storage_path=str(tmp_path / "results")))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        tuner.fit()
    assert time.monotonic() - t0 < 1.0
    assert not (tmp_path / "results").exists() and multiprocessing.active_children() == []


def test_hyperband_pauses_and_resumes_from_checkpoint(ledger, tmp_path):
    """max_t 2, eta 2: one bracket of 2 trials run one at a time. The
    stronger trial (q 2) reaches the rung first and PAUSES; q 1 completes
    the cohort and stops; q 2 resumes from its rung checkpoint in a new
    process and stops at max_t."""
    tuner = Tuner(
        rung_trainable,
        param_space={"q": tune.grid_search([2.0, 1.0])},
        tune_config=TuneConfig(metric="score", mode="max", max_concurrent_trials=1,
                               scheduler=tune.HyperBandScheduler(max_t=2, reduction_factor=2)),
        run_config=RunConfig(name="hb", storage_path=str(tmp_path / "results")),
    )
    results = tuner.fit()
    assert results.num_errors == 0, results.errors
    by_q = {r.config["q"]: r for r in results}
    assert [m["training_iteration"] for m in by_q[1.0].metrics_history] == [1]
    strong = by_q[2.0].metrics_history
    assert [m["training_iteration"] for m in strong] == [1, 2]
    assert [m["resumed_at"] for m in strong] == [0, 1]  # the second from its checkpoint
    decisions = [e[3] for e in tuner._controller.events if e[0] == "result"]
    assert decisions == ["PAUSE", "STOP", "STOP"]
    trials = {t.config["q"]: t for t in tuner._controller.trials}
    assert trials[2.0].num_starts == 2 and trials[1.0].num_starts == 1
    assert results.get_best_result().config["q"] == 2.0
    _clean(tuner, ledger)


def test_pbt_restarts_from_the_donor_checkpoint(ledger, tmp_path):
    (tmp_path / "sync").mkdir()
    tuner = Tuner(
        pbt_trainable,
        param_space={"lr": tune.grid_search([0.001, 1.0]), "sync_dir": str(tmp_path / "sync")},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.PopulationBasedTraining(
                perturbation_interval=4, hyperparam_mutations={"lr": [0.001, 1.0]},
                quantile_fraction=0.5, seed=0)),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path / "results")),
    )
    results = tuner.fit()
    assert results.num_errors == 0, results.errors
    restarts = [e for e in tuner._controller.events if e[0] == "result" and e[3] == "RESTART"]
    assert restarts
    # the weak trial took the strong one's checkpoint: its final score is
    # out of reach of lr 0.001 alone over any number of its iterations
    scores = sorted(r.metrics["score"] for r in results)
    assert scores[0] > 0.001 * 40
    assert max(t.num_starts for t in tuner._controller.trials) >= 2
    _clean(tuner, ledger)


_DRIVER = """
import sys
sys.path.insert(0, {repo!r})
from ray_tpu_torch import tune
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.tune import TuneConfig, Tuner
from tests.test_torch_tune_trials import slow_trainable

if __name__ == "__main__":
    with use_ledger(CardLedger({ledger!r}, cards=[], cpus=4)):
        Tuner(
            slow_trainable,
            param_space={{"x": tune.grid_search([1, 2]), "marker_dir": {marker!r}}},
            tune_config=TuneConfig(metric="score", mode="max", max_concurrent_trials=1),
            run_config=RunConfig(name="resume-exp", storage_path={root!r}),
        ).fit()
"""


def _snapshot_has_checkpoint(exp_dir) -> bool:
    import pickle

    try:
        with open(exp_dir / "experiment_state.pkl", "rb") as f:
            trials = pickle.load(f)["trials"]
    except (OSError, EOFError, pickle.UnpicklingError):
        return False
    return any(t["checkpoint_dir"] for t in trials)


def test_tuner_restore_after_driver_death(ledger, tmp_path):
    """tests/test_tune.py:test_tuner_restore_after_driver_death on the port's
    processes: the orphaned trial ends itself, and the restored sweep
    resumes it from its checkpoint and runs the trial never started."""
    root, marker = tmp_path / "results", tmp_path / "progress"
    marker.mkdir()
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER.format(repo=REPO, ledger=ledger.root, marker=str(marker),
                                     root=str(root)))
    exp_dir = root / "resume-exp"
    proc = subprocess.Popen([sys.executable, str(script)], cwd=str(tmp_path))
    try:  # killed once a snapshot holds a checkpoint of the first trial
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not _snapshot_has_checkpoint(exp_dir):
            time.sleep(0.1)
        assert _snapshot_has_checkpoint(exp_dir), "no snapshot with a checkpoint"
    finally:
        proc.kill()
        proc.wait()
    deadline = time.monotonic() + 10
    while ledger.holders() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ledger.holders() == []  # the orphaned trial ended its group itself
    assert (exp_dir / "experiment_state.pkl").exists()
    tuner = Tuner.restore(str(exp_dir), fast_trainable)
    results = tuner.fit()
    assert len(results) == 2 and results.num_errors == 0, results.errors
    assert sorted(r.config["x"] for r in results) == [1, 2]
    by_x = {r.config["x"]: r for r in results}
    assert by_x[1].metrics["resumed_from"] >= 1  # from its checkpoint, not from the start
    assert by_x[2].metrics["resumed_from"] == 0
    _clean(tuner, ledger)


def test_trainer_as_trainable(ledger, tmp_path):
    """tests/test_tune.py:test_trainer_as_trainable on the port, over one
    trial (the sweep's cost is the other tests'): the trial process leases
    a CPU slot, and its nested 1-rank TorchTrainer, given the trial's
    ``train_loop_config``, leases another from the same ledger."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    trainer = TorchTrainer(
        trainer_loop,
        train_loop_config={"lr": 0.0},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="inner", storage_path=str(tmp_path / "inner")),
    )
    tuner = Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search([2.0])}},
        tune_config=TuneConfig(metric="val", mode="max", max_concurrent_trials=1),
        run_config=RunConfig(name="sweep", storage_path=str(tmp_path / "results")),
    )
    with LedgerWatch(ledger) as watch:
        results = tuner.fit()
    assert results.num_errors == 0, results.errors
    assert results.get_best_result().metrics["val"] == 20.0
    assert watch.most("1 tune trial") == 1 and watch.most("1 CPU ranks") == 1
    assert max(len(hs) for hs in watch.seen) == 2  # the trial and its rank together
    trials = tuner._controller.trials
    for t in trials:  # the nested run is named after the trial
        assert (tmp_path / "inner" / f"inner_{t.trial_id}").is_dir()
        assert t.last_result["rank_pid"] not in t.pids
    _clean(tuner, ledger)


def test_ppo_as_trainable_on_the_cpu(ledger, tmp_path):
    from ray_tpu_torch.rllib import PPO, PPOConfig

    base = (PPOConfig().environment("CartPole-v1")
            .env_runners(rollout_fragment_length=32, num_envs_per_env_runner=2)
            .training(minibatch_size=32, num_epochs=1).debugging(seed=0))
    tuner = Tuner(
        PPO.as_trainable(base),
        param_space={"lr": tune.grid_search([3e-4]), "stop_iters": 2},
        tune_config=TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=RunConfig(name="ppo", storage_path=str(tmp_path / "results")),
    )
    results = tuner.fit()
    assert results.num_errors == 0, results.errors
    assert [r.config["lr"] for r in results] == [3e-4]
    for r in results:
        assert [m["training_iteration"] for m in r.metrics_history] == [1, 2]
        assert r.metrics["num_env_steps_sampled_lifetime"] == 2 * 64
    _clean(tuner, ledger)
