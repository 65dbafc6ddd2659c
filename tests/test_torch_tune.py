"""The port's Tune search and schedulers (``ray_tpu_torch/tune/``) against
the JAX package's (``ray_tpu/tune/``), in this process, tolerance 0.

- ``generate_variants`` and ``BasicVariantGenerator`` (alone and behind a
  ``ConcurrencyLimiter``): equal configs in equal order for one seed, over
  grid, random and nested spaces.
- Every scheduler (FIFO, ASHA, sync HyperBand, median stopping, PBT, PB2):
  one scripted population of trials, fed one sequence of results drawn from
  a seeded numpy generator, gives equal decisions, equal resumed and culled
  trials (HyperBand), equal exploit sources and equal mutated configs (PBT,
  PB2). A trial's status follows each decision, as the controller's would.
- ``GPSearcher``: equal suggestions after the same observations.
- The trial capacity the port's controller counts from the card ledger, and
  its refusals.

No process is spawned here; the trial runtime is
``tests/test_torch_tune_trials.py`` and the sweep against JAX's
``tests/test_torch_tune_llama.py``.
"""

import numpy as np
import pytest

import ray_tpu.tune as jtune
import ray_tpu_torch.tune as ttune
from ray_tpu.tune.search.basic_variant import generate_variants as jgenerate
from ray_tpu.tune.tuner import TrialStatus as JStatus
from ray_tpu_torch._private.cards import CardLedger
from ray_tpu_torch.tune.search.basic_variant import generate_variants as tgenerate
from ray_tpu_torch.tune.tuner import TrialStatus as TStatus
from ray_tpu_torch.tune.tuner import trial_capacity

PKGS = {"jax": (jtune, jgenerate, JStatus), "port": (ttune, tgenerate, TStatus)}


def _double(spec=None):
    return 2


# ---- variants ----------------------------------------------------------------------


def _space(tune, kind):
    if kind == "grid":
        return {"lr": tune.grid_search([0.1, 0.01, 0.001]), "bs": tune.grid_search([16, 32])}
    if kind == "random":
        return {"u": tune.uniform(-1, 1), "q": tune.quniform(0, 10, 0.5),
                "lu": tune.loguniform(1e-5, 1e-1), "ri": tune.randint(0, 100),
                "lri": tune.lograndint(1, 1000), "n": tune.randn(3.0, 2.0),
                "c": tune.choice(["a", "b", "c"]), "f": tune.sample_from(_double),
                "const": 7}
    return {"opt": {"lr": tune.loguniform(1e-4, 1e-2), "betas": tune.grid_search([0.9, 0.99]),
                    "sched": {"warmup": tune.randint(0, 50), "kind": "cosine"}},
            "model": {"width": tune.grid_search([64, 128]), "drop": tune.uniform(0, 0.5)},
            "seed": tune.choice([1, 2, 3])}


@pytest.mark.parametrize("kind", ["grid", "random", "nested"])
@pytest.mark.parametrize("seed", [0, 7])
def test_variants_equal_jax(kind, seed):
    got = {}
    for name, (tune, generate, _) in PKGS.items():
        space = _space(tune, kind)
        direct = list(generate(space, num_samples=3, seed=seed))
        gen = tune.BasicVariantGenerator(seed=seed)
        gen.set_search_properties("m", "max", space, 3)
        via = []
        while (cfg := gen.suggest(f"t{len(via)}")) is not None:
            via.append(cfg)
        limited = tune.ConcurrencyLimiter(tune.BasicVariantGenerator(seed=seed), 2)
        limited.set_search_properties("m", "max", space, 3)
        seq = []  # suggestions and refusals, completing every third one
        for i in range(30):
            cfg = limited.suggest(f"t{i}")
            seq.append(cfg)
            if i % 3 == 2:
                for tid in sorted(limited.live)[:1]:
                    limited.on_trial_complete(tid, {"m": 1.0})
        got[name] = (direct, via, seq, gen.total_variants())
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == got["port"][3]


# ---- schedulers --------------------------------------------------------------------


class _Trial:
    """What a scheduler reads and writes of a controller's trial."""

    def __init__(self, trial_id, config, status_enum):
        self.trial_id = trial_id
        self.config = config
        self.status = status_enum.RUNNING
        self.checkpoint = None
        self.restore_checkpoint = None
        self.last = {}
        self.it = 0


def _schedulers(tune):
    mutations = {"lr": tune.loguniform(1e-4, 1e-1), "bs": [16, 32, 64],
                 "mom": [0.8, 0.9, 0.99]}
    return {
        "fifo": lambda: tune.FIFOScheduler(),
        "asha": lambda: tune.ASHAScheduler(max_t=9, grace_period=1, reduction_factor=3),
        "asha_brackets": lambda: tune.AsyncHyperBandScheduler(max_t=16, grace_period=2,
                                                              reduction_factor=2, brackets=2),
        "hyperband": lambda: tune.HyperBandScheduler(max_t=9, reduction_factor=3),
        "median": lambda: tune.MedianStoppingRule(grace_period=2, min_samples_required=2),
        "pbt": lambda: tune.PopulationBasedTraining(
            perturbation_interval=2, hyperparam_mutations=mutations, quantile_fraction=0.25,
            resample_probability=0.25, seed=3),
        "pb2": lambda: tune.PB2(perturbation_interval=2,
                                hyperparam_bounds={"lr": [1e-4, 1e-1], "mom": [0.8, 0.99]},
                                quantile_fraction=0.25, seed=3),
    }


def _drive(name, pkg, n_trials=12, steps=150, seed=0, mode="max"):
    """Feed one scheduler a scripted population: each step a running trial
    (drawn from a seeded generator) reports its next iteration; decisions
    move its status as the controller would. Returns the log of everything
    the scheduler decided."""
    tune, _, status = PKGS[pkg]
    sched = _schedulers(tune)[name]()
    sched.set_search_properties("score", mode)
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(n_trials):
        cfg = {"lr": float(10 ** rng.uniform(-4, -1)), "bs": [16, 32, 64][i % 3],
               "mom": [0.8, 0.9, 0.99][i % 3], "q": float(rng.uniform(0.5, 2.0))}
        trials.append(_Trial(f"trial_{i:05d}", cfg, status))
    for t in trials:
        sched.on_trial_add(t)
    log = []
    for _ in range(steps):
        chosen = sched.choose_trial_to_run(trials, exhausted=True)
        if chosen is not None:
            log.append(("resume", chosen.trial_id))
            chosen.status = status.RUNNING
        for t in sched.take_pending_stops():
            log.append(("culled", t.trial_id))
            t.status = status.TERMINATED
            sched.on_trial_complete(t, t.last)
        running = [t for t in trials if t.status is status.RUNNING]
        if not running:
            if any(t.status is status.PAUSED for t in trials):
                continue
            break
        t = running[int(rng.integers(len(running)))]
        t.it += 1
        score = t.config["q"] * t.it * (1 + t.config["lr"]) + float(rng.normal()) * 0.3
        result = {"training_iteration": t.it, "score": score}
        t.last = result
        t.checkpoint = f"{t.trial_id}@{t.it}"
        decision = sched.on_trial_result(t, result)
        log.append((t.trial_id, t.it, decision, dict(t.config), t.restore_checkpoint))
        if decision == sched.STOP:
            t.status = status.TERMINATED
            sched.on_trial_complete(t, result)
        elif decision == sched.PAUSE:
            t.status = status.PAUSED
        elif decision == sched.RESTART:
            t.it = int(t.restore_checkpoint.split("@")[1])  # resumes at the donor's step
            t.restore_checkpoint = None
    return log


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("name", ["fifo", "asha", "asha_brackets", "hyperband", "median", "pbt",
                                  "pb2"])
def test_scheduler_decisions_equal_jax(name, mode):
    want = _drive(name, "jax", mode=mode)
    got = _drive(name, "port", mode=mode)
    assert got == want
    decisions = {e[2] for e in got if len(e) == 5}
    # the script reaches the scheduler's own decisions, not CONTINUE alone
    expected = {"fifo": {"CONTINUE"}, "asha": {"STOP"}, "asha_brackets": {"STOP"},
                "hyperband": {"PAUSE", "STOP"}, "median": {"STOP"}, "pbt": {"RESTART"},
                "pb2": {"RESTART"}}[name]
    assert expected <= decisions, decisions
    if name == "hyperband":
        assert any(e[0] == "resume" for e in got)


def test_gp_searcher_suggestions_equal_jax():
    out = {}
    for name, (tune, _, _) in PKGS.items():
        space = {"x": tune.uniform(0.0, 1.0), "lr": tune.loguniform(1e-4, 1e-1),
                 "k": tune.randint(1, 10), "c": tune.choice(["a", "b"]), "fixed": 3}
        s = tune.GPSearcher(n_initial=4, n_candidates=256, seed=5)
        s.set_search_properties("score", "max", space, 16)
        seq = []
        for i in range(17):
            cfg = s.suggest(f"t{i}")
            seq.append(cfg)
            if cfg is not None:
                score = -((cfg["x"] - 0.7) ** 2) - (np.log10(cfg["lr"]) + 2.5) ** 2 / 10
                s.on_trial_complete(f"t{i}", {"score": score + 0.01 * cfg["k"]})
        out[name] = seq
    assert out["port"] == out["jax"]
    assert out["port"][-1] is None and len(out["port"]) == 17


# ---- the controller's capacity and refusals ------------------------------------------


@pytest.mark.parametrize("resources,cards,cpus,want", [
    ({"GPU": 0.25}, ["0"], 8, 4),
    ({"GPU": 0.5, "CPU": 1}, ["0", "1"], 3, 3),
    ({"GPU": 1}, ["0", "1", "2"], 8, 3),
    ({"GPU": 2}, ["0", "1", "2"], 8, 1),
    ({"CPU": 1}, [], 8, 8),
    ({"CPU": 3}, [], 8, 2),
    ({}, [], 6, 6),
])
def test_trial_capacity_counts_every_named_resource(resources, cards, cpus, want, tmp_path):
    assert trial_capacity(resources, CardLedger(str(tmp_path), cards=cards, cpus=cpus)) == want


@pytest.mark.parametrize("resources,cards,cpus,error,match", [
    ({"GPU": 0.5}, [], 8, RuntimeError, "need a CUDA device, but none is visible"),
    ({"GPU": 2}, ["0"], 8, RuntimeError, "needs 2 cards, but 1 are visible"),
    ({"CPU": 9}, [], 8, RuntimeError, "needs 9 CPU slots, but the host has 8"),
    ({"GPU": 1.5}, ["0", "1"], 8, ValueError, "a trial takes"),
    ({"TPU": 1}, [], 8, ValueError, "a trial takes"),
])
def test_trial_capacity_refuses_what_the_host_never_grants(resources, cards, cpus, error, match,
                                                           tmp_path):
    with pytest.raises(error, match=match):
        trial_capacity(resources, CardLedger(str(tmp_path), cards=cards, cpus=cpus))
