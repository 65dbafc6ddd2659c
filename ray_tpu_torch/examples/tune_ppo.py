"""A sweep over PPO learning rates on CartPole: the counterpart of
``examples/tune_ppo.py``.

    python -m ray_tpu_torch.examples.tune_ppo          # two trials a card, the learner on it
    python -m ray_tpu_torch.examples.tune_ppo --cpu    # trials on the CPU

Each trial is a process of its own (``ray_tpu_torch.tune``) running
``PPO.as_trainable(base)``: it builds PPO with the trial's ``lr`` on the
trial's device and reports ``train()`` ``stop_iters`` times. On the card a
trial leases half of one (``with_resources({"GPU": 0.5})``), so two run on
each card at once; with ``--cpu`` a trial leases a CPU slot and its learner
runs on the CPU. Set ``RAY_TPU_STORAGE_PATH`` for the results (default
``~/ray_tpu_results``).
"""

from ray_tpu_torch import tune
from ray_tpu_torch.rllib import PPO, PPOConfig
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.tune import TuneConfig, Tuner


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="trials on the CPU")
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args(argv)
    base = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=128)
        .training(minibatch_size=256, num_epochs=8, entropy_coeff=0.01,
                  vf_clip_param=100.0)
    )
    resources = {"CPU": 1} if args.cpu else {"GPU": 0.5}
    results = Tuner(
        tune.with_resources(PPO.as_trainable(base), resources),
        param_space={
            "lr": tune.grid_search([3e-4, 1e-3, 3e-3]),
            "stop_iters": args.iters,
        },
        tune_config=TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=RunConfig(name="ppo-sweep"),
    ).fit()
    best = results.get_best_result()
    print("best lr:", best.config["lr"], "return:", best.metrics["episode_return_mean"])


if __name__ == "__main__":
    main()
