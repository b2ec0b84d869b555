"""TrainWorker actor + WorkerGroup (reference:
python/ray/train/_internal/worker_group.py).

One TrainWorker actor per rank (per GPU when the gang uses GPUs). The actor
runs with max_concurrency > 1 so `run()` (the user's train loop, on one
executor thread) and `poll()` (driver drains results, on another) overlap.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train import _session
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._session import TrialInfo, _TrainSession


class TrainWorker:
    """Actor hosting one rank of the training gang."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        for k, v in (env or {}).items():
            os.environ[k] = v
        self.session: Optional[_TrainSession] = None

    def node_info(self) -> Dict[str, str]:
        """This rank's node id, pid and node address (the raylet's host,
        where a rank-0 rendezvous listens)."""
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        return {"node_id": core.node_id, "pid": str(os.getpid()),
                "node_ip": core.raylet_addr[0]}

    def setup_session(
        self,
        *,
        world_rank: int,
        world_size: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        trial_info: TrialInfo,
        latest_checkpoint_path: Optional[str],
        dataset_shards: Dict[str, Any],
        loop_config: Dict[str, Any],
        collective_group: Optional[str],
        start_iteration: int = 0,
    ) -> None:
        s = _TrainSession(
            world_rank=world_rank,
            world_size=world_size,
            local_rank=local_rank,
            local_world_size=local_world_size,
            node_rank=node_rank,
            trial_info=trial_info,
            dataset_shards=dataset_shards,
            collective_group=collective_group,
            loop_config=loop_config,
        )
        if latest_checkpoint_path:
            s.latest_checkpoint = Checkpoint(latest_checkpoint_path)
        s.iteration = start_iteration
        self.session = s
        _session._set_session(s)

    def apply(self, fn_blob: bytes, *args):
        """Run an arbitrary setup function on this worker (backend hooks —
        reference: worker_group.py execute of setup callables)."""
        fn = cloudpickle.loads(fn_blob)
        return fn(*args)

    def init_collective(
        self, world_size: int, rank: int, backend: str, group_name: str
    ) -> None:
        from ray_tpu_torch.util import collective

        if not collective.is_group_initialized(group_name):
            collective.init_collective_group(
                world_size, rank, backend=backend, group_name=group_name
            )

    def run(self, fn_blob: bytes) -> Optional[str]:
        """Execute the train loop; returns a traceback string on failure."""
        assert self.session is not None, "setup_session must run first"
        s = self.session
        try:
            # Deserialize inside the guard: an unloadable blob (missing
            # module, version skew) must still set `finished`, or the
            # driver's poll loop waits forever for a rank that never ran.
            fn = cloudpickle.loads(fn_blob)
            if s.loop_config is not None and _takes_config(fn):
                fn(s.loop_config)
            else:
                fn()
            return None
        except BaseException as e:  # noqa: BLE001 - reported to driver
            s.error = e
            return traceback.format_exc()
        finally:
            s.finished.set()

    def poll(
        self, timeout: float = 5.0, max_results: Optional[int] = 1
    ) -> Dict[str, Any]:
        """Blocking-drain of queued TrainingResults.

        max_results=1 → lock-step drain (train's per-round rank sync);
        None → drain everything queued (tune, where a fast trial may have
        reported many times between controller rounds)."""
        import queue as _q

        assert self.session is not None
        s = self.session
        out = []
        try:
            out.append(s.result_queue.get(timeout=timeout))
            while max_results is None or len(out) < max_results:
                out.append(s.result_queue.get_nowait())
        except _q.Empty:
            pass
        if out:
            results = [
                {
                    "metrics": r.metrics,
                    "checkpoint_path": r.checkpoint_path,
                    "iteration": r.iteration,
                    "world_rank": r.world_rank,
                }
                for r in out
            ]
            if max_results == 1:
                return {"result": results[0]}
            return {"results": results}
        if s.finished.is_set() and s.result_queue.empty():
            return {"done": True, "error": repr(s.error) if s.error else None}
        return {"pending": True}

    def shutdown_collective(self, group_name: str) -> None:
        from ray_tpu_torch.util import collective

        if collective.is_group_initialized(group_name):
            collective.destroy_collective_group(group_name)


def _takes_config(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    return len(sig.parameters) >= 1


class WorkerGroup:
    """The gang of TrainWorker actors, placed one-per-bundle in a PG."""

    def __init__(
        self,
        num_workers: int,
        bundles: List[Dict[str, float]],
        placement_strategy: str,
        worker_env: Optional[Dict[str, str]] = None,
    ):
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        self.pg = placement_group(bundles, strategy=placement_strategy)
        if not self.pg.ready(timeout=120):
            raise RuntimeError(
                "placement group for the train worker gang did not become "
                f"ready (bundles={bundles})"
            )
        cls = ray_tpu_torch.remote(TrainWorker)
        self.workers = [
            cls.options(
                max_concurrency=4,
                num_cpus=0,  # resources held via the bundle reservation
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i
                ),
            ).remote(worker_env)
            for i in range(num_workers)
        ]
        # Rank layout: sort by node so local ranks are contiguous per host.
        infos = ray_tpu_torch.get([w.node_info.remote() for w in self.workers])
        self.node_ids = [i["node_id"] for i in infos]
        self.node_ips = [i["node_ip"] for i in infos]
        order: Dict[str, int] = {}
        for nid in self.node_ids:
            order.setdefault(nid, len(order))
        self.node_ranks = [order[nid] for nid in self.node_ids]
        counts: Dict[str, int] = {}
        self.local_ranks = []
        for nid in self.node_ids:
            self.local_ranks.append(counts.get(nid, 0))
            counts[nid] = counts.get(nid, 0) + 1
        self.local_world_sizes = [counts[nid] for nid in self.node_ids]

    def __len__(self):
        return len(self.workers)

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        """Call `method` on every worker, blocking; returns per-rank results."""
        refs = [
            getattr(w, method).remote(*args, **kwargs) for w in self.workers
        ]
        return ray_tpu_torch.get(refs)

    def execute_async(self, method: str, *args, **kwargs):
        return [getattr(w, method).remote(*args, **kwargs) for w in self.workers]

    def shutdown(self) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
        self.workers = []
