"""ray_tpu_torch.tune — hyperparameter search and trial execution (reference:
python/ray/tune)."""

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.suggest import Searcher, TPESearcher
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, with_resources

ASHAScheduler = AsyncHyperBandScheduler


def report(
    metrics: Dict[str, Any],
    *,
    checkpoint=None,
    _already_persisted: bool = False,
) -> None:
    """Report from inside a trial (reference: ray.tune.report / ray.train.report
    are the same session under the hood)."""
    from ray_tpu_torch.train import _session
    from ray_tpu_torch.train._checkpoint import Checkpoint
    from ray_tpu_torch.train._session import TrainingResult

    s = _session._get_session()
    if checkpoint is not None and _already_persisted:
        s.latest_checkpoint = (
            checkpoint
            if isinstance(checkpoint, Checkpoint)
            else Checkpoint(checkpoint)
        )
        s.result_queue.put(
            TrainingResult(
                metrics=dict(metrics),
                checkpoint_path=s.latest_checkpoint.path,
                iteration=s.iteration,
                world_rank=s.world_rank,
            )
        )
        s.iteration += 1
    else:
        s.report(metrics, checkpoint)


def get_checkpoint():
    from ray_tpu_torch.train import _session

    return _session._get_session().get_checkpoint()


__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "with_resources",
    "report",
    "get_checkpoint",
    "uniform",
    "loguniform",
    "randint",
    "choice",
    "sample_from",
    "grid_search",
    "BasicVariantGenerator",
    "TrialScheduler",
    "FIFOScheduler",
    "AsyncHyperBandScheduler",
    "ASHAScheduler",
    "HyperBandScheduler",
    "PopulationBasedTraining",
    "MedianStoppingRule",
    "Trainable",
    "Searcher",
    "TPESearcher",
]
