"""Simulated-cluster harness: hundreds of in-process raylets on loopback.

The scale tests, the scheduler benchmark (``ray_perf._bench_sched``) and
the chaos ``sched`` scenario all need a cluster that is *real* at the
control plane — every raylet runs the actual lease scheduler, spillback
protocol and delta-synced cluster view over real loopback RPC — but fake
at the worker plane, because forking 4000 worker subprocesses to study
scheduling at 1000 nodes would measure the OS, not the scheduler. The
harness pairs three pieces:

- ``SimCluster`` boots a real ``GcsServer`` plus N real ``Raylet``
  instances with ``sim_workers=True`` (grants attach in-process stub
  workers, see raylet.py ``_make_sim_worker``) on a dedicated event-loop
  thread, so synchronous tests drive it with ``run()``.
- ``SimLeaseClient`` speaks the lease protocol the way ``core_worker``
  does — spillback chains with ``spilled_from`` pinning, the hop-cap
  re-anchor on the GCS global view, and retry-around-dead-raylets so the
  chaos scenario can kill nodes mid-chain.
- ``SimNodeProvider`` adapts the harness to the autoscaler's node-provider
  interface (``create_node``/``terminate_node``/``raylet_node_id``) so the
  scaling loop can be exercised against hundreds of fake nodes.

Everything here is test/bench infrastructure: nothing imports it from the
runtime paths.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.common import ResourceSet, config
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ids import fast_unique_hex
from ray_tpu_torch._private.raylet import Raylet

logger = logging.getLogger(__name__)

# Applied for the lifetime of the harness (restored on shutdown): periodic
# machinery that is per-node O(N) noise at hundreds of nodes — memory
# monitoring, store prefault, active health probes — is switched off, and
# GCS head broadcasts are batched so the fan-out is bounded by
# subscribers/batch_ms instead of subscribers*grants (common.py
# ``scheduler_view_batch_ms``). 200ms staleness is immaterial for picks
# (availability is also checked at the grant site) but the sim folds every
# subscriber's decode onto ONE loop thread, so the window directly scales
# harness throughput. Death detection still works with probing off: a
# killed raylet's GCS connection drop triggers _handle_node_death.
_SIM_ENV_DEFAULTS = {
    "RAY_TPU_MEMORY_MONITOR_INTERVAL_S": "0",
    "RAY_TPU_PREFAULT_OBJECT_STORE": "0",
    "RAY_TPU_HEALTH_CHECK_PERIOD_S": "0",
    "RAY_TPU_SCHEDULER_VIEW_BATCH_MS": "200",
    # Sim raylets host no real object churn: the default 0.25s pressure
    # poll is 2000 wakeups/s of pure timer noise at 500 nodes. Slower poll,
    # same behavior (sims that do spill just react within 2s).
    "RAY_TPU_OBJECT_SPILLING_POLL_INTERVAL_S": "2",
}

# Raylets booted concurrently during start(). Each boot is a server bind +
# GCS register + arena create; unbounded gather at 1000 nodes stampedes
# the accept queue and the allocator.
_BOOT_CONCURRENCY = 32


def _raise_nofile_limit(want: int) -> None:
    """Each sim raylet holds ~4 fds (listen socket, GCS conn both ends,
    arena shm): at 1000 nodes the default soft RLIMIT_NOFILE of 1024 is
    exhausted mid-boot. Raise it toward the hard limit; best-effort."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < want:
            resource.setrlimit(
                resource.RLIMIT_NOFILE, (min(want, hard), hard)
            )
    except (ImportError, ValueError, OSError):
        logger.warning("could not raise RLIMIT_NOFILE; large sims may fail")


class SimCluster:
    """N in-process raylets + a real GCS on a private event-loop thread.

    Synchronous drivers (pytest, ray_perf) call ``run(coro)`` to execute
    coroutines on the sim loop. The attribute surface matches what
    ``chaos.invariants`` and ``chaos.nemesis`` expect of a cluster:
    ``raylets`` (node_id -> Raylet), ``gcs_server``, and ``head_node``
    (None — every sim node is fair game for the nemesis).
    """

    def __init__(
        self,
        num_nodes: int,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: int = 1 << 20,
        env: Optional[Dict[str, str]] = None,
        persist_path: Optional[str] = None,
        ha: bool = False,
    ):
        self.num_nodes = num_nodes
        self.resources = resources or {"CPU": 4.0}
        self.object_store_memory = object_store_memory
        self.persist_path = persist_path
        # HA mode: replicated store + warm standby + leader pointer file, so
        # kill_gcs_host_async() can lose the "machine" holding the primary
        # log and fail over (docs/fault_tolerance.md "HA deployment").
        self.ha = ha
        if ha and not persist_path:
            raise ValueError("ha=True requires persist_path")
        self.gcs_standby = None
        self.session_name = f"sim-{fast_unique_hex()[:8]}"
        self.raylets: Dict[str, Raylet] = {}
        self.gcs_server: Optional[GcsServer] = None
        self.gcs_addr: Optional[Tuple[str, int]] = None
        self.head_node = None
        self._env = dict(_SIM_ENV_DEFAULTS)
        if env:
            self._env.update(env)
        self._saved_env: Dict[str, Optional[str]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SimCluster":
        for k, v in self._env.items():
            self._saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        config.refresh()
        _raise_nofile_limit(4 * self.num_nodes + 512)

        rpc.install_event_loop()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop_main, name="sim-cluster-loop", daemon=True
        )
        self._thread.start()
        self.run(self._start_async(), timeout=max(120.0, self.num_nodes))
        return self

    def _loop_main(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def run(self, coro, timeout: float = 60.0):
        """Run a coroutine on the sim loop from the driving thread."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout
        )

    async def _start_async(self) -> None:
        # persist_path=None (the default) -> in-memory GCS store; sim
        # sessions are throwaway and store churn at 1000 registrations is
        # pure tax. The chaos recovery scenarios pass a path so crash_gcs
        # has durable state to recover from.
        self.gcs_server = GcsServer(
            session_name=self.session_name,
            persist_path=self.persist_path,
            persist_backend="replicated" if self.ha else None,
        )
        self.gcs_addr = await self.gcs_server.start()
        sem = asyncio.Semaphore(_BOOT_CONCURRENCY)

        async def boot(_i: int) -> None:
            async with sem:
                await self._add_node_async(dict(self.resources))

        await asyncio.gather(*(boot(i) for i in range(self.num_nodes)))
        # The standby is armed once every node has registered. It watches
        # the leader's lease on this same loop, so a stall of the loop past
        # the lease (the boot storm on a loaded host) reads to it as the
        # leader's death; a promotion then fences the leader mid-boot, and a
        # raylet's first registration, unlike its later reconnects, does not
        # survive the lost connection.
        if self.ha:
            await self._arm_standby()

    async def _add_node_async(
        self, resources: Dict[str, float]
    ) -> Raylet:
        raylet = Raylet(
            self.gcs_addr,
            self.session_name,
            resources=resources,
            object_store_memory=self.object_store_memory,
            sim_workers=True,
            gcs_leader_file=self.gcs_leader_file(),
        )
        await raylet.start()
        self.raylets[raylet.node_id] = raylet
        return raylet

    def add_node(self, resources: Optional[Dict[str, float]] = None) -> Raylet:
        return self.run(
            self._add_node_async(dict(resources or self.resources)),
            timeout=60.0,
        )

    def remove_node(self, node_id: str) -> None:
        raylet = self.raylets.pop(node_id, None)
        if raylet is not None:
            self.run(raylet.stop(), timeout=60.0)

    def gcs_leader_file(self) -> Optional[str]:
        if not self.ha:
            return None
        from ray_tpu_torch._private import gcs_ha

        return gcs_ha.leader_file_path(self.persist_path)

    async def _arm_standby(self) -> None:
        from ray_tpu_torch._private.gcs_ha import GcsStandby

        self.gcs_standby = GcsStandby(
            session_name=self.session_name, persist_path=self.persist_path
        )
        await self.gcs_standby.start()

    async def kill_gcs_host_async(self, timeout: float = 30.0) -> bool:
        """Lose the GCS *machine*: hard-crash the process and drop its local
        log member (the disk went with the host), then wait for the warm
        standby to promote over the surviving follower log at term+1. The
        leader pointer file re-targets raylets on their next redial.
        Returns False when HA is off or the GCS is already gone."""
        if not self.ha or self.gcs_server is None or self.gcs_standby is None:
            return False
        from ray_tpu_torch._private.gcs_store import drop_host

        await self.gcs_server.crash()
        drop_host(self.persist_path)
        return await self.adopt_promoted_gcs_async(timeout)

    async def adopt_promoted_gcs_async(self, timeout: float = 30.0) -> bool:
        """Wait for the armed standby to promote, adopt its server, and
        re-arm. Shared tail of kill_gcs_host_async, also used standalone
        when the leader demoted itself (lost its replication majority)."""
        if self.gcs_standby is None:
            return False
        await asyncio.wait_for(self.gcs_standby.promoted.wait(), timeout)
        self.gcs_server = self.gcs_standby.server
        self.gcs_addr = self.gcs_server.server.address
        await self._arm_standby()
        return True

    async def crash_gcs_async(self, torn_tail: bool = True) -> bool:
        """Hard-crash the GCS (no store checkpoint/fsync, optionally a torn
        WAL tail) and restart it on the same address from the persisted
        state. Raylets re-register over their reconnect loops. Returns
        False when the sim has no GCS (already shut down)."""
        if self.gcs_server is None or self.gcs_addr is None:
            return False
        await self.gcs_server.crash()
        if torn_tail and self.persist_path:
            from ray_tpu_torch._private.gcs_store import inject_torn_tail

            inject_torn_tail(self.persist_path)
        self.gcs_server = GcsServer(
            host=self.gcs_addr[0],
            port=self.gcs_addr[1],
            session_name=self.session_name,
            persist_path=self.persist_path,
            persist_backend="replicated" if self.ha else None,
        )
        await self.gcs_server.start()
        return True

    def shutdown(self) -> None:
        if self._loop is None:
            return
        try:
            self.run(self._stop_async(), timeout=120.0)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=30.0)
            self._loop.close()
            self._loop = None
            for k, old in self._saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            config.refresh()

    async def _stop_async(self) -> None:
        raylets = list(self.raylets.values())
        self.raylets.clear()
        sem = asyncio.Semaphore(_BOOT_CONCURRENCY)

        async def stop_one(r: Raylet) -> None:
            async with sem:
                try:
                    await r.stop()
                except Exception:
                    pass

        await asyncio.gather(*(stop_one(r) for r in raylets))
        if self.gcs_standby is not None:
            if self.gcs_standby.server is self.gcs_server:
                self.gcs_standby.server = None
            await self.gcs_standby.stop()
            self.gcs_standby = None
        if self.gcs_server is not None:
            await self.gcs_server.stop()
            self.gcs_server = None

    # -- conveniences --------------------------------------------------------

    def node_stats(self) -> List[dict]:
        """Per-node GetNodeStats rows, collected in-process — the
        autoscaler's ``state_fn`` for a driverless sim cluster."""

        async def collect() -> List[dict]:
            return [
                await r._node_stats(None, {})
                for r in list(self.raylets.values())
            ]

        return self.run(collect(), timeout=60.0)

    def any_addr(self) -> Tuple[str, int]:
        """Address of an arbitrary live raylet (lease entry point)."""
        raylet = next(iter(self.raylets.values()))
        return tuple(raylet.addr)

    def node_addr(self, node_id: str) -> Tuple[str, int]:
        return tuple(self.raylets[node_id].addr)


class SimLeaseClient:
    """Drives the lease protocol like ``core_worker._request_lease`` does,
    without a CoreWorker: follows spillback chains with ``spilled_from``
    pinning, re-anchors on the GCS global view when the hop cap trips, and
    — beyond what core_worker needs — retries around raylets that die
    mid-chain, for the chaos ``sched`` scenario. All methods are
    coroutines meant to run on the sim loop (``cluster.run``)."""

    def __init__(self, cluster: SimCluster, job_id: str = "simjob"):
        self.cluster = cluster
        self.job_id = job_id
        self._conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._gcs_conn: Optional[rpc.Connection] = None

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
        if self._gcs_conn is not None:
            await self._gcs_conn.close()
            self._gcs_conn = None

    async def _conn_to(self, addr: Tuple[str, int]) -> rpc.Connection:
        key = (addr[0], addr[1])
        conn = self._conns.get(key)
        if conn is None or conn.closed:
            conn = await rpc.connect(*key)
            self._conns[key] = conn
        return conn

    async def _gcs(self) -> rpc.Connection:
        if self._gcs_conn is None or self._gcs_conn.closed:
            self._gcs_conn = await rpc.connect(*self.cluster.gcs_addr)
        return self._gcs_conn

    async def _gcs_pick(
        self, resources: Dict[str, int]
    ) -> Optional[Tuple[str, int]]:
        """Least-utilized ALIVE node whose totals fit the demand, from the
        GCS global view (mirrors core_worker._gcs_spill_target)."""
        try:
            reply = await (await self._gcs()).call("GetAllNodes")
        except rpc.RpcError:
            return None
        demand = ResourceSet.from_units(resources)
        best_addr = None
        best_util = None
        for n in reply["nodes"]:
            if n.get("state") != "ALIVE":
                continue
            total = ResourceSet.from_units(n.get("total") or {})
            if not demand.is_subset_of(total):
                continue
            tot = n.get("total") or {}
            avail = n.get("available") or {}
            util = max(
                (
                    1.0 - avail.get(r, 0) / t
                    for r, t in tot.items()
                    if t and not r.startswith("node:")
                ),
                default=0.0,
            )
            if best_util is None or util < best_util:
                best_util = util
                best_addr = tuple(n["addr"])
        return best_addr

    async def lease(
        self,
        resources: Dict[str, int],
        entry_addr: Optional[Tuple[str, int]] = None,
        strategy: Optional[dict] = None,
        locality: Optional[Dict[str, float]] = None,
        timeout: Optional[float] = 60.0,
    ) -> dict:
        """One lease grant: {"lease_id", "addr", "worker_id"}. ``addr`` is
        the granting raylet — pass the dict to release(). ``resources`` is
        a float amount dict ({"CPU": 1.0}); the wire carries fixed-point
        units like every other producer."""
        units = ResourceSet(resources).to_units()
        lease_id = fast_unique_hex()
        addr = tuple(entry_addr or self.cluster.any_addr())
        hops = 0
        used_gcs_fallback = False
        while True:
            try:
                conn = await self._conn_to(addr)
                # Batched: every lease op this client issues to the same
                # raylet in one loop tick rides a single LeaseBatch frame.
                reply = await conn.call_batched(
                    "RequestWorkerLease",
                    {
                        "lease_id": lease_id,
                        "resources": units,
                        "strategy": strategy,
                        "spilled_from": hops > 0,
                        "locality": locality if hops == 0 else None,
                        "job_id": self.job_id,
                    },
                    timeout=timeout,
                )
            except rpc.RpcError:
                # The target raylet died under us (chaos kill mid-chain).
                # Its ledger died with it, so the same lease_id is safe to
                # re-anchor elsewhere; pick via the GCS view, pinned so the
                # survivor queues instead of re-bouncing.
                self._conns.pop(addr, None)
                target = await self._gcs_pick(units)
                if target is None or target == addr:
                    raise
                addr = target
                hops = max(hops, 1)
                continue
            if reply.get("granted"):
                return {
                    "lease_id": reply["lease_id"],
                    "addr": addr,
                    "worker_id": reply["worker_id"],
                }
            if reply.get("cancelled"):
                raise rpc.RpcError(f"lease {lease_id} cancelled")
            spill = reply.get("spillback")
            if spill is None:
                raise rpc.RpcError(
                    f"no node can host resources {resources} "
                    "(cluster infeasible)"
                )
            hops += 1
            if hops > 4:
                if used_gcs_fallback:
                    raise rpc.RpcError(
                        "lease spillback loop exceeded 4 hops after "
                        "GCS-view fallback"
                    )
                used_gcs_fallback = True
                target = await self._gcs_pick(units)
                if target is None:
                    raise rpc.RpcError(
                        f"no node can host resources {resources} "
                        "(cluster infeasible)"
                    )
                addr = target
                hops = 1
                continue
            addr = tuple(spill["addr"])

    async def release(self, grant: dict, dirty: bool = False) -> bool:
        """Return the leased worker. False when the granting raylet is
        gone — its lease table died with it, nothing left to release."""
        try:
            conn = await self._conn_to(tuple(grant["addr"]))
            await conn.call_batched(
                "ReturnWorker",
                {"lease_id": grant["lease_id"], "dirty": dirty},
            )
            return True
        except rpc.RpcError:
            return False

    async def lease_cycle(
        self,
        resources: Dict[str, int],
        entry_addr: Optional[Tuple[str, int]] = None,
        hold_s: float = 0.0,
        **kw,
    ) -> dict:
        grant = await self.lease(resources, entry_addr, **kw)
        if hold_s > 0:
            await asyncio.sleep(hold_s)
        await self.release(grant)
        return grant


class SimNodeProvider:
    """Autoscaler node provider backed by a SimCluster: create_node boots
    a real sim raylet on the sim loop, terminate_node stops it. Thread
    context: the autoscaler calls these synchronously from its own thread;
    they block on ``cluster.run``."""

    def __init__(
        self,
        cluster: SimCluster,
        node_types: Optional[Dict[str, dict]] = None,
    ):
        self.cluster = cluster
        self.node_types = node_types or {
            "sim.cpu4": {"resources": {"CPU": 4}, "max_workers": 2000},
        }
        self._pids: Dict[str, str] = {}  # provider pid -> raylet node_id
        self._seq = 0

    def create_node(self, node_type: str) -> str:
        spec = self.node_types[node_type]
        resources = {
            k: float(v) for k, v in spec.get("resources", {}).items()
        }
        raylet = self.cluster.add_node(resources=resources)
        self._seq += 1
        pid = f"sim-{self._seq}"
        self._pids[pid] = raylet.node_id
        return pid

    def terminate_node(self, pid: str) -> bool:
        node_id = self._pids.pop(pid, None)
        if node_id is None:
            return False
        self.cluster.remove_node(node_id)
        return True

    def raylet_node_id(self, pid: str) -> Optional[str]:
        return self._pids.get(pid)

    def failed_nodes(self) -> List[str]:
        return []

    def forget_node(self, pid: str) -> None:
        self._pids.pop(pid, None)
