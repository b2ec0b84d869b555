"""Tune on the port (ray_tpu_torch.tune), on the CPU: the cases of
tests/test_tune.py and tests/test_tune_pbt_hyperband.py on the port's
runtime (the trainer under the tuner is a two-worker gloo TorchTrainer);
every seeded searcher and scheduler (grid and random variants, TPE, ASHA,
HyperBand, PBT) against the JAX package's on one deterministic objective,
driven in process and through each package's Tuner; a trial's GPU request
on a CPU cluster that advertises one GPU; and a fit that returns as soon
as its loop has finished."""

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import RunConfig
from ray_tpu_torch.testing import torch_cluster  # noqa: F401
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, AsyncHyperBandScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ray6():
    """tests/test_tune_pbt_hyperband.py's cluster: 6 CPUs, so its six
    HyperBand trials run at once."""
    ray_tpu_torch.init(num_cpus=6)
    yield
    ray_tpu_torch.shutdown()




def test_basic_variant_grid_and_samples():
    gen = BasicVariantGenerator(seed=0)
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0.0, 1.0),
        "fixed": 7,
        "nested": {"bs": tune.grid_search([8, 16])},
    }
    configs = gen.generate(space, num_samples=2)
    assert len(configs) == 8  # 2 grid x 2 grid x 2 samples
    assert all(c["fixed"] == 7 for c in configs)
    assert {c["lr"] for c in configs} == {0.1, 0.01}
    assert {c["nested"]["bs"] for c in configs} == {8, 16}
    assert all(0.0 <= c["wd"] <= 1.0 for c in configs)


def test_asha_stops_bad_trials():
    sched = AsyncHyperBandScheduler(
        metric="score", mode="max", grace_period=1, reduction_factor=2, max_t=16
    )
    # Good trial reaches rung first and sets the bar.
    assert sched.on_trial_result("good", {"training_iteration": 1, "score": 1.0}) == CONTINUE
    assert sched.on_trial_result("bad", {"training_iteration": 1, "score": 0.1}) == STOP
    # max_t reached -> stop regardless
    assert sched.on_trial_result("good", {"training_iteration": 16, "score": 9.9}) == STOP


def test_tuner_grid_search_end_to_end(torch_cluster, tmp_path):  # noqa: F811
    def trainable(config):
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 5, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=__import__("ray_tpu_torch.air", fromlist=["RunConfig"]).RunConfig(
            name="exp1", storage_path=str(tmp_path)
        ),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.metrics["score"] == 15
    assert best.metrics["training_iteration"] == 3


def test_tuner_trial_error_isolated(torch_cluster, tmp_path):  # noqa: F811
    def trainable(config):
        if config["x"] == 2:
            raise RuntimeError("bad trial")
        tune.report({"score": config["x"]})

    from ray_tpu_torch.air import RunConfig

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="exp_err", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 1
    assert grid.get_best_result().metrics["score"] == 3


def test_tuner_with_asha_early_stops(torch_cluster, tmp_path):  # noqa: F811
    def trainable(config):
        for i in range(8):
            tune.report({"score": config["x"] * (i + 1)})

    from ray_tpu_torch.air import RunConfig

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([10, 1, 1, 1])},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            scheduler=AsyncHyperBandScheduler(
                grace_period=2, reduction_factor=2, max_t=8
            ),
            max_concurrent_trials=2,
        ),
        run_config=RunConfig(name="exp_asha", storage_path=str(tmp_path)),
    ).fit()
    stopped = [t for t in grid._trials if t.early_stopped]
    assert len(stopped) >= 1  # the x=1 stragglers get culled
    assert grid.get_best_result().metrics["score"] >= 80 - 10


def test_tuner_restore_reruns_unfinished(torch_cluster, tmp_path):  # noqa: F811
    import os

    def trainable(config):
        tune.report({"score": config["x"]})

    from ray_tpu_torch.air import RunConfig

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="exp_restore", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    exp_dir = os.path.join(str(tmp_path), "exp_restore")
    restored = tune.Tuner.restore(exp_dir, trainable)
    grid2 = restored.fit()
    # everything already TERMINATED -> same results, no re-run
    assert len(grid2) == 2
    assert grid2.get_best_result(metric="score", mode="max").metrics["score"] == 2


def test_trainer_under_tuner(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def train_fn(config):
        ctx = train.get_context()
        train.report({"acc": config["lr"] * 10, "world": ctx.get_world_size()})

    trainer = TorchTrainer(  # two CPU workers on a gloo process group
        train_fn,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search([0.1, 0.5])}},
        tune_config=tune.TuneConfig(metric="acc", mode="max", max_concurrent_trials=1),
        run_config=RunConfig(name="exp_trainer", storage_path=str(tmp_path)),
    ).fit()
    best = grid.get_best_result()
    assert best.metrics["acc"] == 5.0
    assert best.metrics["world"] == 2


def test_tpe_searcher_pure_protocol():
    """TPE model quality without the runtime: on a deterministic quadratic,
    TPE's post-startup suggestions concentrate near the optimum and beat
    random search under the same budget (seed-matched)."""
    import random

    from ray_tpu_torch.tune import TPESearcher
    from ray_tpu_torch.tune.search import _walk

    space = {"x": tune.uniform(-10.0, 10.0)}

    def objective(cfg):
        return -((cfg["x"] - 3.0) ** 2)  # max at x=3

    def run_tpe(seed):
        s = TPESearcher(metric="score", mode="max", n_initial=8, seed=seed)
        s.set_search_space(space)
        best = -float("inf")
        for i in range(40):
            cfg = s.suggest(f"t{i}")
            score = objective(cfg)
            best = max(best, score)
            s.on_trial_complete(f"t{i}", {"score": score})
        return best

    def run_random(seed):
        rng = random.Random(seed)
        _, domains = _walk(space, ())
        best = -float("inf")
        for _ in range(40):
            x = domains[0][1].sample(rng)
            best = max(best, objective({"x": x}))
        return best

    tpe_wins = sum(
        1 for seed in range(5) if run_tpe(seed) >= run_random(seed)
    )
    assert tpe_wins >= 4  # dominates random under a matched budget


def test_tpe_searcher_through_tuner(torch_cluster, tmp_path):  # noqa: F811
    """Tuner(search_alg=TPESearcher): trials are suggested on demand and
    results feed the model back through the controller."""
    from ray_tpu_torch.air import RunConfig
    from ray_tpu_torch.tune import TPESearcher

    def trainable(config):
        x = config["x"]
        tune.report({"score": -((x - 3.0) ** 2)})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.uniform(-10.0, 10.0)},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            num_samples=12,
            search_alg=TPESearcher(n_initial=4, seed=0),
            max_concurrent_trials=2,
        ),
        run_config=RunConfig(name="exp_tpe", storage_path=str(tmp_path)),
    ).fit()
    results = [r for r in grid]
    assert len(results) == 12
    best = grid.get_best_result()
    # With 8 adaptive suggestions after 4 random startups the best x should
    # land well inside (-10, 10)'s central region around 3.
    assert best.metrics["score"] > -9.0


# -- tests/test_tune_pbt_hyperband.py's cases ---------------------------------




def _quadratic_cls():
    """Defined inside a function so cloudpickle ships the class by value
    (trial workers cannot import this test module)."""

    class _Quadratic(tune.Trainable):
        """score grows by `lr` each step — higher lr is strictly better, so
        PBT should migrate the population toward the best lr."""

        def setup(self, config):
            self.lr = config["lr"]
            self.score = 0.0

        def step(self):
            import time

            # Slow enough that the population advances in overlapping poll
            # rounds — PBT/HyperBand compare trials at the same iteration.
            time.sleep(0.2)
            self.score += self.lr
            return {"score": self.score, "lr": self.lr}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"score": self.score}, f)

        def load_checkpoint(self, d):
            with open(os.path.join(d, "state.json")) as f:
                self.score = json.load(f)["score"]

    return _Quadratic


def test_pbt_perturbs_and_forks(ray6, tmp_path):
    sched = tune.PopulationBasedTraining(
        time_attr="training_iteration",
        perturbation_interval=2,
        hyperparam_mutations={"lr": (0.1, 10.0)},
        quantile_fraction=0.25,
        seed=7,
    )
    tuner = tune.Tuner(
        _quadratic_cls(),
        param_space={"lr": tune.grid_search([0.1, 0.5, 5.0, 9.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=sched, num_samples=1
        ),
        run_config=RunConfig(
            name="pbt",
            storage_path=str(tmp_path),
            stop={"training_iteration": 12},
        ),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0
    # The scheduler provably perturbed (exploit/explore fired)...
    assert sched.num_perturbations >= 1
    trials = grid._trials
    perturbed = [t for t in trials if t.num_perturbations > 0]
    assert perturbed, "no trial was restarted with an exploited config"
    # ...and the fork actually adopted donor state: a perturbed trial's
    # score history jumps to donor level (score >> what its original lr
    # could have produced by that iteration) or its lr changed.
    for t in perturbed:
        assert t.config["lr"] != pytest.approx(
            {0.1: 0.1, 0.5: 0.5, 5.0: 5.0, 9.0: 9.0}.get(t.config["lr"], -1)
        ) or t.checkpoint_path is not None
    best = grid.get_best_result()
    # Population converged toward high-lr configs: the winner must beat what
    # the two weak starting lrs (0.1, 0.5) could ever reach in 12 steps.
    assert best.metrics["score"] > 0.5 * 12


def test_hyperband_synchronous_halving(ray6, tmp_path):
    sched = tune.HyperBandScheduler(
        time_attr="training_iteration",
        max_t=9,
        grace_period=3,
        reduction_factor=3,
    )
    tuner = tune.Tuner(
        _quadratic_cls(),
        param_space={"lr": tune.grid_search([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", scheduler=sched, num_samples=1
        ),
        run_config=RunConfig(
            name="hb",
            storage_path=str(tmp_path),
            stop={"training_iteration": 9},
        ),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0
    trials = grid._trials
    stopped = [t for t in trials if t.early_stopped]
    survivors = [t for t in trials if not t.early_stopped]
    # 6 trials, eta=3: the rung at t=3 keeps 2, stops 4.
    assert len(stopped) == 4
    assert len(survivors) == 2
    # The survivors are exactly the best configs.
    surv_lrs = sorted(t.config["lr"] for t in survivors)
    assert surv_lrs == [5.0, 6.0]
    # Stopped trials halted at the rung milestone, not later.
    for t in stopped:
        assert t.history[-1]["training_iteration"] == 3
    # Survivors resumed from checkpoints and ran to the stop criterion with
    # continuous score (checkpoint restore preserved state).
    for t in survivors:
        assert t.history[-1]["training_iteration"] == 9
        assert t.history[-1]["score"] == pytest.approx(9 * t.config["lr"])


def test_class_trainable_save_restore(ray6, tmp_path):
    tuner = tune.Tuner(
        _quadratic_cls(),
        param_space={"lr": tune.grid_search([2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(
            name="cls1",
            storage_path=str(tmp_path),
            stop={"training_iteration": 3},
        ),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.metrics["score"] == pytest.approx(6.0)
    assert best.checkpoint is not None
    # Checkpoint holds the trainable's own state file.
    assert os.path.exists(os.path.join(best.checkpoint.path, "state.json"))

    # A fresh run resuming from that checkpoint continues the state.
    trial_ckpt = best.checkpoint.path
    cls = _quadratic_cls()

    def fn(config):
        from ray_tpu_torch.train._checkpoint import Checkpoint

        t = cls(config)
        with Checkpoint(trial_ckpt).as_directory() as d:
            t.load_checkpoint(d)
        out = t.train()
        tune.report(out)

    tuner2 = tune.Tuner(
        fn,
        param_space={"lr": tune.grid_search([2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="cls2", storage_path=str(tmp_path)),
    )
    grid2 = tuner2.fit()
    assert grid2.num_errors == 0
    assert grid2.get_best_result().metrics["score"] == pytest.approx(8.0)


# -- seeded searchers and schedulers against the JAX package -------------------

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SEARCH_CASES = ("grid", "random", "tpe", "asha", "hyperband", "pbt")
MAX_T = 9


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _gain(config: dict, t: int) -> float:
    """One step's score gain of the deterministic objective: a larger lr
    helps early and hurts late, weight decay costs a little."""
    lr, wd = config["lr"], config.get("wd", 0.0)
    return round(lr * (1.0 - 0.25 * lr * t) - 0.1 * wd + 0.01 * config.get("width", 0), 12)


def _space(pkg: str, case: str) -> dict:
    tune_ = _mod(pkg, "tune")
    if case == "grid":
        return {"lr": tune_.grid_search([0.2, 0.5, 1.0]), "wd": tune_.grid_search([0.0, 0.3])}
    return {"lr": tune_.loguniform(0.05, 2.0), "wd": tune_.uniform(0.0, 0.5),
            "width": tune_.randint(1, 9), "act": tune_.choice(["relu", "gelu", "silu"])}


def _scheduler(pkg: str, case: str):
    s = _mod(pkg, "tune.schedulers")
    if case == "asha":
        return s.AsyncHyperBandScheduler(metric="score", mode="max", grace_period=1,
                                         reduction_factor=2, max_t=MAX_T)
    if case == "hyperband":
        return s.HyperBandScheduler(metric="score", mode="max", max_t=MAX_T, grace_period=1,
                                    reduction_factor=3, brackets=2)
    if case == "pbt":
        return s.PopulationBasedTraining(metric="score", mode="max", perturbation_interval=2,
                                         hyperparam_mutations={"lr": (0.05, 2.0),
                                                               "act": ["relu", "gelu", "silu"]},
                                         quantile_fraction=0.25, seed=7)
    return s.FIFOScheduler()


class _SimTrial:
    def __init__(self, trial_id: str, config: dict):
        self.trial_id, self.config = trial_id, config
        self.t, self.score, self.status = 0, 0.0, "RUNNING"
        self.checkpoint_path, self.saved = None, {}


def _simulate(pkg: str, case: str) -> dict:
    """The controller's protocol with the scheduler and searcher, driven in
    rounds over a deterministic objective (every live trial takes one step
    a round, in trial order): each decision in order, the final configs and
    the best trial's config."""
    s = _mod(pkg, "tune.schedulers")
    log = []
    if case == "tpe":  # sequential suggest/observe, FIFO
        searcher = _mod(pkg, "tune").TPESearcher(metric="score", mode="max", n_initial=4, seed=0)
        searcher.set_search_space(_space(pkg, case))
        trials = []
        for i in range(12):
            trial = _SimTrial(f"t{i}", searcher.suggest(f"t{i}"))
            for t in range(1, MAX_T + 1):
                trial.score += _gain(trial.config, t)
            searcher.on_trial_complete(trial.trial_id, {"score": trial.score})
            trials.append(trial)
            log.append((trial.trial_id, trial.config, trial.score))
    else:
        gen = _mod(pkg, "tune.search").BasicVariantGenerator(seed=3)
        configs = gen.generate(_space(pkg, case), 1 if case == "grid" else 8)
        trials = [_SimTrial(f"t{i}", c) for i, c in enumerate(configs)]
        by_id = {t.trial_id: t for t in trials}
        sched = _scheduler(pkg, case)
        if hasattr(sched, "set_trial_state_reader"):
            sched.set_trial_state_reader(by_id.get)
        for trial in trials:
            sched.on_trial_add(trial.trial_id)

        def finish(trial, status):
            trial.status = status
            sched.on_trial_complete(trial.trial_id, {"score": trial.score})

        for _ in range(3 * MAX_T):
            for trial in trials:
                if trial.status != "RUNNING":
                    continue
                trial.t += 1
                trial.score += _gain(trial.config, trial.t)
                trial.checkpoint_path = f"{trial.trial_id}/{trial.t}"
                trial.saved[trial.checkpoint_path] = trial.score
                d = sched.on_trial_result(trial.trial_id, {"training_iteration": trial.t,
                                                           "score": trial.score})
                log.append((trial.trial_id, trial.t, trial.score, d))
                if isinstance(d, tuple) and d[0] == s.EXPLOIT:
                    donor = d[2].split("/")[0]
                    trial.config, trial.score = dict(d[1]), by_id[donor].saved[d[2]]
                elif d == s.STOP:
                    finish(trial, "STOPPED")
                elif d == s.PAUSE:
                    trial.status = "PAUSED"
                elif d == s.COMPLETE or trial.t >= MAX_T:
                    finish(trial, "DONE")
            for tid, action in (sched.pop_actions() if hasattr(sched, "pop_actions") else []):
                log.append((tid, "action", action))
                if action == s.RESUME:
                    by_id[tid].status = "RUNNING"
                else:
                    finish(by_id[tid], "STOPPED")
            if all(t.status in ("STOPPED", "DONE") for t in trials):
                break
    best = max(trials, key=lambda t: t.score)
    return {"log": log, "configs": [t.config for t in trials],
            "status": [getattr(t, "status", None) for t in trials],
            "best": best.config, "best_score": best.score}


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_and_schedule_parity(case):
    ref, port = (_simulate(pkg, case) for pkg in PACKAGES)
    assert port == ref
    decisions = [row[3] for row in port["log"] if len(row) == 4]
    if case in ("asha", "hyperband"):  # some trials were cut
        assert "STOPPED" in port["status"], port["status"]
    if case == "pbt":
        assert any(isinstance(d, tuple) for d in decisions), "PBT never exploited"


TUNER_SCRIPT = r'''
import json, sys
sys.path.insert(0, {repo!r})
import {pkg} as rt
from {pkg} import tune
from {pkg}.air import RunConfig


def trainable(config):
    score = 0.0
    for t in range(1, {max_t} + 1):
        lr, wd = config["lr"], config.get("wd", 0.0)
        score += round(lr * (1.0 - 0.25 * lr * t) - 0.1 * wd + 0.01 * config.get("width", 0), 12)
        tune.report({{"score": score}})


space = {{"lr": tune.loguniform(0.05, 2.0), "wd": tune.uniform(0.0, 0.5),
         "width": tune.randint(1, 9)}}
rt.init(num_cpus=2, **{init!r})
out = {{}}
for case in ("tpe", "asha"):
    cfg = dict(metric="score", mode="max", max_concurrent_trials=1, num_samples=6)
    if case == "tpe":
        cfg["search_alg"] = tune.TPESearcher(n_initial=3, seed=0)
    else:
        cfg["seed"] = 3
        cfg["scheduler"] = tune.schedulers.AsyncHyperBandScheduler(
            grace_period=1, reduction_factor=2, max_t={max_t})
    grid = tune.Tuner(trainable, param_space=space, tune_config=tune.TuneConfig(**cfg),
                      run_config=RunConfig(name=case, storage_path=sys.argv[1])).fit()
    trials = grid._trials
    out[case] = {{"configs": [t.config for t in trials],
                 "iterations": [len(t.history) for t in trials],
                 "early_stopped": [t.early_stopped for t in trials],
                 "best": max(trials, key=lambda t: t.history[-1]["score"]).config,
                 "best_score": grid.get_best_result().metrics["score"]}}
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


@pytest.mark.timeout(180)
def test_tuner_runs_match_jax_package(tmp_path):
    """TPE and ASHA through each package's Tuner, one trial at a time so the
    order of results is fixed: the same trial configs, the same early stops,
    the same best config."""
    procs = {}
    for pkg in PACKAGES:
        code = TUNER_SCRIPT.format(repo=REPO, pkg=pkg, max_t=MAX_T,
                                   init={"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0})
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path / pkg)], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    runs = {}
    for pkg, proc in procs.items():
        log, _ = proc.communicate(timeout=170)
        assert proc.returncode == 0, f"{pkg}'s Tuner failed:\n{log[-3000:]}"
        line = [row for row in log.splitlines() if row.startswith("RESULT ")][-1]
        runs[pkg] = json.loads(line[len("RESULT "):])
    assert runs["ray_tpu_torch"] == runs["ray_tpu"]
    assert any(runs["ray_tpu_torch"]["asha"]["early_stopped"])


# -- GPU requests and the fit's end -------------------------------------------


@pytest.mark.timeout(120)
def test_trial_gpu_reaches_its_actor(tmp_path):
    """tune.with_resources(..., {"GPU": 1}) on a CPU cluster that advertises
    one GPU: each trial's actor holds the GPU while it runs (none is left
    free), and gives it back when the trial ends. The controller starts a
    trial's actor and waits for it, so GPU trials that cannot all fit run
    one at a time (max_concurrent_trials), as TPU trials do in ray_tpu."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        def trainable(config):
            tune.report({"gpu_free": ray_tpu_torch.available_resources().get("GPU", 0.0),
                         "start": time.time(), "x": config["x"]})
            time.sleep(0.5)
            tune.report({"end": time.time(), "x": config["x"]})

        grid = tune.Tuner(
            tune.with_resources(trainable, {"CPU": 1, "GPU": 1}),
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(metric="x", mode="max", max_concurrent_trials=1),
            run_config=RunConfig(name="gpu_trials", storage_path=str(tmp_path)),
        ).fit()
        assert grid.num_errors == 0
        spans = []
        for trial in grid._trials:
            first, last = trial.history[0], trial.history[-1]
            assert first["gpu_free"] == 0.0, first
            spans.append((first["start"], last["end"]))
        spans.sort()
        assert spans[0][1] <= spans[1][0], spans
        deadline = time.monotonic() + 30  # the last trial's actor is killed asynchronously
        while ray_tpu_torch.available_resources().get("GPU") != 1.0:
            assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
            time.sleep(0.1)
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.timeout(120)
def test_fit_returns_soon_after_the_loop_ends(torch_cluster, tmp_path):  # noqa: F811
    """The trainer's poll returns once the loop has finished with nothing
    queued: fit() ends within FIT_END_S of the loop's last report, where
    ray_tpu's waits out its 10 s poll."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def train_fn():
        for i in range(3):
            train.report({"i": i, "at": time.time()})

    result = TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                          run_config=RunConfig(name="fit_end", storage_path=str(tmp_path))).fit()
    ended = time.time()
    assert [m["i"] for m in result.metrics_history] == [0, 1, 2]
    assert ended - result.metrics_history[-1]["at"] < FIT_END_S


# The fit's tail after the loop's last report: the last poll, the worker
# group's teardown and the result's assembly; 10 s or more before the poll
# returned on the loop's end.
FIT_END_S = 2.0
