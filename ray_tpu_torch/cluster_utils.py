"""In-process multi-node cluster harness for tests.

Analog of python/ray/cluster_utils.py:135: boots one GCS plus N raylets inside
one machine — the backbone of "distributed" tests without real hosts. Each
added node is a full raylet (own worker pool, own object store namespace) on
the driver's background event loop; killing a node drops its RPC links, which
exercises the same death paths as a real host failure.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.raylet import Raylet


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: Optional[dict] = None):
        from ray_tpu_torch._private.common import config

        config.refresh()  # pick up env overrides set after import (fixtures)
        self._w = worker_mod.global_worker
        if self._w.loop is None:
            self._w._start_loop()
        self.gcs_server: Optional[GcsServer] = None
        self.gcs_addr = None
        self.raylets: Dict[str, Raylet] = {}
        self.head_node: Optional[Node] = None
        if initialize_head:
            self._start_head(head_node_args or {})

    def _run(self, coro, timeout=60):
        return self._w.run_async(coro, timeout=timeout)

    def _start_head(self, args: dict) -> None:
        async def go():
            node = Node(head=True, **args)
            await node.start()
            return node

        node = self._run(go())
        self.head_node = node
        self.gcs_server = node.gcs_server
        self.gcs_addr = node.gcs_addr
        self.raylets[node.raylet.node_id] = node.raylet

    @property
    def address(self) -> str:
        return f"{self.gcs_addr[0]}:{self.gcs_addr[1]}"

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> Raylet:
        """A node of `num_gpus` GPUs, leased as "GPU"; without a count it
        advertises the GPUs this host has, as a head node does. Nodes on one
        host share its cards: a GPU task uses cuda:0 of its process."""
        res = dict(resources or {})
        res["CPU"] = float(num_cpus)
        if num_gpus is None:
            from ray_tpu_torch._private.accelerators import detect_accelerator_resources

            res.update(detect_accelerator_resources())
        elif num_gpus:
            res["GPU"] = float(num_gpus)

        async def go():
            raylet = Raylet(
                self.gcs_addr,
                self.head_node.session_name,
                resources=res,
                object_store_memory=object_store_memory,
                labels=labels,
            )
            await raylet.start()
            return raylet

        raylet = self._run(go())
        self.raylets[raylet.node_id] = raylet
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        """Simulates node death: kills workers and drops the GCS link."""
        self.raylets.pop(raylet.node_id, None)

        async def go():
            await raylet.stop()

        self._run(go())

    def connect(self, **init_kwargs):
        """Attach the current process as a driver to this cluster."""
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.address, **init_kwargs)

    def shutdown(self) -> None:
        import ray_tpu_torch

        raylets = list(self.raylets.values())
        self.raylets.clear()

        async def go():
            # The driver says farewell and flushes while the daemons still
            # answer: against a stopped GCS each call redials until its
            # window ends (5 s for JobFinished, 30 s for a task-event flush).
            await worker_mod.close_driver(worker_mod.global_worker.core)
            for r in raylets:
                try:
                    await r.stop()
                except Exception:
                    pass
            # HA mode: disarm the warm standby BEFORE stopping the GCS, or
            # the expired lease promotes a new leader into the dying cluster.
            standby = getattr(self.head_node, "gcs_standby", None)
            if standby is not None:
                if standby.server is self.gcs_server:
                    standby.server = None
                try:
                    await standby.stop()
                except Exception:
                    pass
                self.head_node.gcs_standby = None
            if self.gcs_server is not None:
                await self.gcs_server.stop()

        if self._w.loop is not None:
            try:
                self._run(go())
            except Exception:
                pass
        # Driver teardown last: its farewell RPCs fail fast against the
        # now-stopped daemons and the loop is reclaimed here.
        if worker_mod.global_worker.connected:
            ray_tpu_torch.shutdown()
