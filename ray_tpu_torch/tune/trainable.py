"""Class-based Trainable API (reference:
python/ray/tune/trainable/trainable.py Trainable).

Subclass and override setup/step/save_checkpoint/load_checkpoint; the Tuner
wraps the class into a checkpointing trial loop. Because every step reports
with a checkpoint, class Trainables compose with PBT (exploit = checkpoint
restore + config swap) and synchronous HyperBand (pause/resume) for free.

    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.lr = config["lr"]; self.acc = 0.0
        def step(self):
            self.acc += self.lr
            return {"acc": self.acc}
        def save_checkpoint(self, d):
            json.dump({"acc": self.acc}, open(os.path.join(d, "s.json"), "w"))
        def load_checkpoint(self, d):
            self.acc = json.load(open(os.path.join(d, "s.json")))["acc"]

    Tuner(MyTrainable, param_space={"lr": tune.uniform(0, 1)},
          run_config=RunConfig(stop={"training_iteration": 20})).fit()

Stopping: a trial ends when step() returns {"done": True}, or when a
RunConfig.stop criterion is met (enforced by the controller).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional


class Trainable:
    """Override setup/step (+ save_checkpoint/load_checkpoint for resume,
    PBT, and HyperBand support)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- user hooks ----------------------------------------------------------

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError("Trainable subclasses must implement step()")

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- reference-compat alias ----------------------------------------------

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: Trainable.train wraps step)."""
        result = self.step()
        self.iteration += 1
        return result


_META = ".trainable_meta.json"


def class_trainable_to_fn(cls):
    """Wrap a Trainable subclass into the function-trainable loop the
    controller runs: instantiate, restore from the session checkpoint (PBT
    exploit / HyperBand resume / Tuner.restore), then step-report-checkpoint
    until stopped."""

    def _loop(config):
        from ray_tpu_torch import tune
        from ray_tpu_torch.train._checkpoint import Checkpoint

        t = cls(config)
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with ckpt.as_directory() as d:
                meta = os.path.join(d, _META)
                if os.path.exists(meta):
                    t.iteration = json.load(open(meta))["iteration"]
                t.load_checkpoint(d)
        while True:
            result = t.train()
            with tempfile.TemporaryDirectory() as d:
                t.save_checkpoint(d)
                json.dump(
                    {"iteration": t.iteration}, open(os.path.join(d, _META), "w")
                )
                result.setdefault("training_iteration", t.iteration)
                tune.report(result, checkpoint=Checkpoint.from_directory(d))
            if result.get("done"):
                break
        t.cleanup()

    _loop.__name__ = getattr(cls, "__name__", "trainable")
    _loop._tune_resources = getattr(cls, "_tune_resources", None)
    return _loop
