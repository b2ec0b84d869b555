"""GCS persistence: pluggable store clients.

TPU-native analog of the reference's StoreClient abstraction
(src/ray/gcs/store_client/store_client.h:33). Three backends, selected by
the ``gcs_persist_backend`` knob when a persist path is configured:

- ``memory`` (in_memory_store_client.h:31): no durability, state dies with
  the GCS process. Also the backend when no persist path is given.
- ``sqlite``: write-through rows in a WAL-mode sqlite file. Simple and
  battle-tested, but pays a full journal commit per record.
- ``wal`` (default): an append-only CRC-framed log with *group commit* —
  mutations from one event-loop tick coalesce into a single OS write (and,
  per the ``gcs_store_sync`` policy, a single fsync), so hot-path
  persistence stops paying per-record sync cost. Snapshot-based compaction
  bounds the log, and recovery truncates a torn tail (a record cut mid-
  append by a crash) instead of refusing to start. This is the moral
  analog of the reference's Redis AOF everysec policy behind
  RedisStoreClient (redis_store_client.h:33).

Durability contract (docs/fault_tolerance.md): a *process* crash (kill -9)
loses nothing that ``put`` returned for — buffered records are flushed to
the OS before the process dies, and page-cache writes survive process
death. An *OS/power* crash can lose the records since the last fsync:
under the default ``gcs_store_sync="batch"`` that is at most one loop tick
of mutations for the wal backend, and for sqlite (``synchronous=NORMAL``
under WAL) the commits since the last WAL checkpoint. ``"always"`` closes
that window at per-commit fsync cost; ``"off"`` never fsyncs.

All values are opaque bytes (the GCS msgpacks its own records). Table
layout follows the reference's gcs_table_storage.cc (one logical table per
domain: kv, actors, named, jobs, pgs).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import sqlite3
import struct
import threading
import time
import zlib
from typing import Dict, Optional

import msgpack

from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.common import config

_TEL_WRITE_S = telemetry.histogram(
    "gcs",
    "store_write_s",
    "store commit latency (one group-commit flush or sqlite commit)",
    buckets=telemetry.LATENCY_BUCKETS_S,
)
_TEL_WAL_BYTES = telemetry.counter(
    "gcs", "store_wal_bytes", "bytes appended to the GCS WAL"
)
_TEL_WAL_COMPACTIONS = telemetry.counter(
    "gcs", "store_wal_compactions", "WAL snapshot compactions"
)


class StoreClient:
    """Abstract synchronous KV-per-table store."""

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def get_all(self, table: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def crash(self) -> None:
        """Abrupt-death analog of close(): release OS resources without the
        graceful-shutdown work (checkpoint/compaction/fsync), preserving
        exactly what a killed process would leave on disk."""
        self.close()


class InMemoryStoreClient(StoreClient):
    """Default: no durability (reference in_memory_store_client.h:31)."""

    def __init__(self):
        self._tables: Dict[str, Dict[str, bytes]] = {}

    def put(self, table: str, key: str, value: bytes) -> None:
        self._tables.setdefault(table, {})[key] = value

    def get(self, table: str, key: str) -> Optional[bytes]:
        return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: str) -> None:
        self._tables.get(table, {}).pop(key, None)

    def get_all(self, table: str) -> Dict[str, bytes]:
        return dict(self._tables.get(table, {}))


class SqliteStoreClient(StoreClient):
    """Durable file-backed store for GCS fault tolerance.

    WAL mode + one flat table; writes are a few hundred bytes each and run
    inline on the GCS loop (sub-ms on local disk, same order as the
    reference's Redis round trip from the GCS process).

    Sync policy (``gcs_store_sync``): "always" -> synchronous=FULL (fsync
    per commit), "batch" -> NORMAL (WAL writes fsynced at checkpoint; an
    OS crash can lose the last commits), "off" -> OFF. close() checkpoints
    the WAL (wal_checkpoint TRUNCATE) so a graceful shutdown leaves the
    main db file complete and the -wal file empty.
    """

    _SYNC_PRAGMA = {"always": "FULL", "batch": "NORMAL", "off": "OFF"}

    def __init__(self, path: str, sync: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._lock = threading.Lock()
        self._closed = False
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        level = self._SYNC_PRAGMA.get(sync or config.gcs_store_sync, "NORMAL")
        self._db.execute(f"PRAGMA synchronous={level}")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS gcs (tbl TEXT, key TEXT, value BLOB,"
            " PRIMARY KEY (tbl, key))"
        )
        self._db.commit()

    def put(self, table: str, key: str, value: bytes) -> None:
        with self._lock:
            if self._closed:
                return  # shutdown race: a trailing handler after stop()
            t0 = time.perf_counter()
            self._db.execute(
                "INSERT OR REPLACE INTO gcs (tbl, key, value) VALUES (?, ?, ?)",
                (table, key, value),
            )
            self._db.commit()
            _TEL_WRITE_S.default.observe(time.perf_counter() - t0)

    def get(self, table: str, key: str) -> Optional[bytes]:
        with self._lock:
            if self._closed:
                return None
            row = self._db.execute(
                "SELECT value FROM gcs WHERE tbl = ? AND key = ?", (table, key)
            ).fetchone()
        return None if row is None else bytes(row[0])

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._db.execute(
                "DELETE FROM gcs WHERE tbl = ? AND key = ?", (table, key)
            )
            self._db.commit()

    def get_all(self, table: str) -> Dict[str, bytes]:
        with self._lock:
            if self._closed:
                return {}
            rows = self._db.execute(
                "SELECT key, value FROM gcs WHERE tbl = ?", (table,)
            ).fetchall()
        return {k: bytes(v) for k, v in rows}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                # Fold the -wal file back into the main db so a graceful
                # shutdown leaves one complete file (and no stale -wal to
                # replay — or to lose — on the next open).
                self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            except sqlite3.Error:
                pass
            self._db.close()

    def crash(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # No checkpoint: the -wal file stays behind exactly as a killed
            # process would leave it; sqlite replays it on the next open.
            self._db.close()


# -- WAL backend -------------------------------------------------------------

# Record framing: <u32 body_len> <u32 crc32(body)> <body>, body = msgpack
# [op, table, key, value]. Ops: "put", "del", and "snap" (value = packed
# {table: {key: value}} full state — a compaction checkpoint; replay resets
# to it and continues).
_HDR = struct.Struct("<II")


def _frame(op: str, table: str, key: str, value: Optional[bytes]) -> bytes:
    body = msgpack.packb([op, table, key, value], use_bin_type=True)
    return _HDR.pack(len(body), zlib.crc32(body)) + body


class WalStoreClient(StoreClient):
    """Append-only group-commit log (see module docstring).

    Reads are served from a full in-memory mirror; every mutation appends a
    frame to an in-process buffer and schedules one flush per event-loop
    tick (``loop.call_soon``), so N mutations in one handler burst cost one
    ``os.write`` + one fsync instead of N. Without a running loop (direct
    library use, tests) each mutation flushes inline.
    """

    def __init__(
        self,
        path: str,
        sync: Optional[str] = None,
        compact_bytes: Optional[int] = None,
    ):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._sync = sync or config.gcs_store_sync
        self._compact_bytes = (
            config.gcs_wal_compact_bytes if compact_bytes is None else compact_bytes
        )
        self._lock = threading.Lock()
        self._closed = False
        self._tables: Dict[str, Dict[str, bytes]] = {}
        self._pending: list = []
        self._flush_scheduled = False
        # Optional crash-point probe: called after each durable group commit
        # with (commit_index, log_byte_offset, n_ops). Used by the explorer
        # (devtools/explore.py) to snapshot acked state at every boundary.
        self.commit_listener = None
        self._commit_index = 0
        self._recover()
        self._fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        self._log_bytes = os.fstat(self._fd).st_size

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:
        """Replay the log into the mirror; truncate at the first torn or
        corrupt record (a crash mid-append leaves a short header, a short
        body, or a body whose CRC does not match — everything before it is
        intact and everything after it was never acknowledged as flushed)."""
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as f:
            data = f.read()
        if data.startswith(b"SQLite format 3"):
            # Backend switched under an existing file: refuse rather than
            # "recover" a sqlite db into an empty log (torn-tail truncation
            # at offset 0 would destroy it).
            raise ValueError(
                f"{self._path} is a sqlite store; set gcs_persist_backend="
                "sqlite or remove the file"
            )
        off = 0
        good = 0
        while off + _HDR.size <= len(data):
            blen, crc = _HDR.unpack_from(data, off)
            body = data[off + _HDR.size : off + _HDR.size + blen]
            if len(body) < blen or zlib.crc32(body) != crc:
                break  # torn tail
            op, table, key, value = msgpack.unpackb(body, raw=False)
            if op == "snap":
                self._tables = {
                    t: dict(kv)
                    for t, kv in msgpack.unpackb(value, raw=False).items()
                }
            elif op == "put":
                self._tables.setdefault(table, {})[key] = value
            else:  # "del"
                self._tables.get(table, {}).pop(key, None)
            off += _HDR.size + blen
            good = off
        if good < len(data):
            with open(self._path, "r+b") as f:
                f.truncate(good)

    # -- group commit --------------------------------------------------------

    def _schedule_flush(self) -> None:
        if self._sync == "always":
            # Per-record durability: no group commit, fsync inline.
            self._flush()
            return
        if self._flush_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush()
            return
        self._flush_scheduled = True
        loop.call_soon(self.flush)

    def flush(self) -> None:
        """Write and (per sync policy) fsync all buffered frames: the group
        commit. Public so shutdown paths can force the tail out."""
        with self._lock:
            self._flush_scheduled = False
            self._flush()

    def _flush(self) -> None:  # caller holds _lock (or is single-threaded init)
        if not self._pending or self._closed:
            self._pending.clear()
            return
        n_ops = len(self._pending)
        buf = b"".join(self._pending)
        self._pending.clear()
        t0 = time.perf_counter()
        os.write(self._fd, buf)
        if self._sync != "off":
            os.fsync(self._fd)
        _TEL_WRITE_S.default.observe(time.perf_counter() - t0)
        _TEL_WAL_BYTES.default.inc(len(buf))
        self._log_bytes += len(buf)
        self._commit_index += 1
        if self.commit_listener is not None:
            self.commit_listener(self._commit_index, self._log_bytes, n_ops)
        if self._compact_bytes and self._log_bytes > self._compact_bytes:
            self._compact()

    def _compact(self) -> None:
        """Snapshot compaction: write the full mirror as one "snap" frame to
        a temp file and atomically rename it over the log. Readers of the
        old file (none — the GCS is the only client) and a crash at any
        point see either the old log or the complete snapshot."""
        snap = _frame(
            "snap",
            "",
            "",
            msgpack.packb(self._tables, use_bin_type=True),
        )
        tmp = self._path + ".compact"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, snap)
            if self._sync != "off":
                os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, self._path)
        os.close(self._fd)
        self._fd = os.open(self._path, os.O_WRONLY | os.O_APPEND)
        self._log_bytes = len(snap)
        _TEL_WAL_COMPACTIONS.default.inc()

    # -- StoreClient API -----------------------------------------------------

    def put(self, table: str, key: str, value: bytes) -> None:
        with self._lock:
            if self._closed:
                return
            self._tables.setdefault(table, {})[key] = value
            self._pending.append(_frame("put", table, key, value))
            self._schedule_flush()

    def get(self, table: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._tables.get(table, {}).pop(key, None)
            self._pending.append(_frame("del", table, key, None))
            self._schedule_flush()

    def get_all(self, table: str) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._tables.get(table, {}))

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush()
            self._closed = True
            try:
                if self._sync != "off":
                    os.fsync(self._fd)
            except OSError:
                pass
            os.close(self._fd)

    def crash(self) -> None:
        """Kill -9 analog: the buffered tail reaches the OS (an in-process
        buffer is an artifact of the simulation — a real group-commit store
        writes before acking) but is NOT fsynced, and no compaction or
        checkpoint runs."""
        with self._lock:
            if self._closed:
                return
            buf = b"".join(self._pending)
            self._pending.clear()
            self._closed = True
            if buf:
                os.write(self._fd, buf)
                self._log_bytes += len(buf)
            os.close(self._fd)


# -- Replicated backend ------------------------------------------------------
#
# Same physical framing as the wal backend, but the body grows to
# [op, table, key, value, term, seq]:
#
# - ``term`` is the writer's leadership term. Every member tracks the
#   highest term it has ever accepted (its *fence*); an append from an
#   older term raises StaleLeaderError instead of landing — the mechanism
#   that stops a deposed, partitioned primary from split-braining the
#   actor/PG tables after a standby promoted (reference: Redis
#   replication + the GCS's "who is leader" record; Raft's term check in
#   miniature).
# - ``seq`` is the writer's monotonic log position, identical across
#   members (every member receives the same stream), used to pick the
#   freshest member on open and to bring stale members up via a snapshot
#   frame ("snap" carries the full tables plus the term/seq watermark).
#
# A replication *group* is one primary log plus N follower logs (default
# paths ``<path>.follower<i>``), each modeling an independent store
# process on another host. A group commit acks once a *majority* of
# members — ⌈(n+1)/2⌉, the leader's own append included — have the frame
# durable under the ``gcs_store_sync`` contract. Laggards (a slow or
# partitioned minority) catch up asynchronously: each follower has its own
# serial ship lane, and a member whose applied ``seq`` fell behind the
# stream receives the full state as one snapshot frame instead of the
# incremental buffer. Losing or partitioning a minority therefore never
# stalls the commit path; losing a majority demotes the leader (it fences
# itself rather than acking writes no quorum holds).
#
# The election on open mirrors Raft's: it requires a *majority* of members
# reachable and adopts the highest (term, seq) among them. Any ack quorum
# intersects any election majority, so every acknowledged record is seen
# by — and adopted into — the new leader's log, even when the single
# freshest *file* belongs to an unreachable member.


def _parse_replicated(data: bytes):
    """Replay a replicated-format log: returns (tables, term, seq,
    good_offset). Torn/corrupt tails stop the replay exactly like the wal
    backend; legacy 4-field frames are accepted with term=0/seq untouched
    so a plain wal file can be adopted into a group."""
    tables: Dict[str, Dict[str, bytes]] = {}
    term = 0
    seq = 0
    off = 0
    good = 0
    while off + _HDR.size <= len(data):
        blen, crc = _HDR.unpack_from(data, off)
        body = data[off + _HDR.size : off + _HDR.size + blen]
        if len(body) < blen or zlib.crc32(body) != crc:
            break
        fields = msgpack.unpackb(body, raw=False)
        op, table, key, value = fields[:4]
        if len(fields) >= 6:
            term = max(term, fields[4])
            seq = max(seq, fields[5])
        if op == "snap":
            tables = {
                t: dict(kv)
                for t, kv in msgpack.unpackb(value, raw=False).items()
            }
        elif op == "put":
            tables.setdefault(table, {})[key] = value
        else:
            tables.get(table, {}).pop(key, None)
        off += _HDR.size + blen
        good = off
    return tables, term, seq, good


def apply_replicated(tables: Dict[str, Dict[str, bytes]], data: bytes):
    """Splice replicated frames over a live mirror — frame by frame so
    deletes stay correct and a "snap" frame replaces the whole state.
    Returns (tables, term, seq, good): the (possibly replaced) mirror
    dict, the max term/seq seen, and how many bytes formed whole valid
    frames (a torn tail stops the splice, as in _parse_replicated).
    Shared by ReplicaTailer (file mode) and the RPC-fed standby mirror."""
    term = 0
    seq = 0
    _, _, _, good = _parse_replicated(data)
    off = 0
    while off < good:
        blen, _ = _HDR.unpack_from(data, off)
        body = data[off + _HDR.size : off + _HDR.size + blen]
        fields = msgpack.unpackb(body, raw=False)
        op, table, key, value = fields[:4]
        if len(fields) >= 6:
            term = max(term, fields[4])
            seq = max(seq, fields[5])
        if op == "snap":
            tables = {
                t: dict(kv)
                for t, kv in msgpack.unpackb(value, raw=False).items()
            }
        elif op == "put":
            tables.setdefault(table, {})[key] = value
        else:
            tables.get(table, {}).pop(key, None)
        off += _HDR.size + blen
    return tables, term, seq, good


def _rframe(op, table, key, value, term, seq) -> bytes:
    body = msgpack.packb(
        [op, table, key, value, term, seq], use_bin_type=True
    )
    return _HDR.pack(len(body), zlib.crc32(body)) + body


class _ReplicaLog:
    """One member of a replication group: an append-only log file plus the
    fence state a real follower process would hold. Instances are shared
    in-process through a registry keyed by path, so a deposed leader's
    store client and the promoted leader's client hit the *same* fence —
    the in-process model of a follower rejecting a stale leader's
    shipped stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._refs = 0
        data = b""
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
        _, term, seq, good = _parse_replicated(data)
        if good < len(data):
            with open(path, "r+b") as f:
                f.truncate(good)
        self.fence_term = term
        self.term = term
        self.seq = seq
        self._fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        self.log_bytes = good

    def raise_fence(self, term: int) -> None:
        """Adopt ``term`` as the minimum acceptable leader term. Called on
        open/promotion so a new leader fences the old one before its
        first write, not after. A partitioned member cannot receive the
        fence — it is fenced on rejoin by the catch-up snapshot instead."""
        if self.path in _PARTITIONED:
            return
        with self._lock:
            if term > self.fence_term:
                self.fence_term = term
                _FENCE_GEN[0] += 1

    def append(self, buf: bytes, term: int, seq: int, sync: str) -> None:
        """Accept one shipped group-commit from leader ``term`` ending at
        ``seq``; reject stale terms with StaleLeaderError."""
        from ray_tpu_torch._private.rpc import StaleLeaderError  # lazy: no cycle at import

        if self.path in _PARTITIONED:
            raise ReplicaUnreachableError(
                f"replica {os.path.basename(self.path)} unreachable (partitioned)"
            )
        with self._lock:
            if term < self.fence_term:
                raise StaleLeaderError(
                    f"append from term {term} rejected by "
                    f"replica {os.path.basename(self.path)} "
                    f"(fence at term {self.fence_term})"
                )
            if term > self.fence_term:
                self.fence_term = term
                _FENCE_GEN[0] += 1
            os.write(self._fd, buf)
            if sync != "off":
                os.fsync(self._fd)
            self.term = term
            self.seq = seq
            self.log_bytes += len(buf)

    def reset_with(self, snap: bytes, term: int, seq: int, sync: str) -> None:
        """Replace the whole log with one snapshot frame (compaction, and
        catch-up of a stale member): temp file + atomic rename, same
        crash-safety argument as WalStoreClient._compact. Fenced exactly
        like append: a deposed leader must not be able to "catch up" a
        member that a newer term already fenced — that would replace the
        new leader's state wholesale (split-brain through compaction)."""
        from ray_tpu_torch._private.rpc import StaleLeaderError  # lazy: no cycle at import

        if self.path in _PARTITIONED:
            raise ReplicaUnreachableError(
                f"replica {os.path.basename(self.path)} unreachable (partitioned)"
            )
        with self._lock:
            if term < self.fence_term:
                raise StaleLeaderError(
                    f"catch-up snapshot from term {term} rejected by "
                    f"replica {os.path.basename(self.path)} "
                    f"(fence at term {self.fence_term})"
                )
            tmp = self.path + ".compact"
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, snap)
                if sync != "off":
                    os.fsync(fd)
            finally:
                os.close(fd)
            os.rename(tmp, self.path)
            os.close(self._fd)
            self._fd = os.open(self.path, os.O_WRONLY | os.O_APPEND)
            self.term = term
            self.seq = seq
            if term > self.fence_term:
                self.fence_term = term
                _FENCE_GEN[0] += 1
            self.log_bytes = len(snap)

    def write_unsynced(self, buf: bytes) -> None:
        """crash() path: the buffered tail reaches the OS, no fsync."""
        if self.path in _PARTITIONED:
            return  # a dying leader cannot reach a partitioned member either
        with self._lock:
            try:
                os.write(self._fd, buf)
                self.log_bytes += len(buf)
            except OSError:
                pass

    # registry refcounting: the fd stays open while any client holds the
    # replica; the last release closes it and drops the registry entry.

    def _acquire(self) -> None:
        self._refs += 1

    def _release(self) -> None:
        self._refs -= 1
        if self._refs <= 0:
            with self._lock:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
            with _REGISTRY_LOCK:
                if _REPLICAS.get(self.path) is self:
                    del _REPLICAS[self.path]


_REPLICAS: Dict[str, "_ReplicaLog"] = {}
_REGISTRY_LOCK = threading.Lock()
# Global fence generation: bumped whenever ANY member's fence rises, so
# client put/delete can skip the per-write max() over members (the hot
# path of every GCS mutation) and only re-derive the fence after a bump.
_FENCE_GEN = [0]


def _open_replica(path: str) -> _ReplicaLog:
    path = os.path.abspath(path)
    with _REGISTRY_LOCK:
        rep = _REPLICAS.get(path)
        if rep is not None and not os.path.exists(path):
            # The host died under the live handle (file destroyed): the
            # registry entry models a process that no longer exists.
            del _REPLICAS[path]
            rep = None
        if rep is None:
            rep = _ReplicaLog(path)
            _REPLICAS[path] = rep
        rep._acquire()
        return rep


def follower_paths(path: str, n: Optional[int] = None) -> list:
    """Default follower log paths for a replication group rooted at
    ``path`` (one per simulated follower store host)."""
    if n is None:
        n = max(1, int(config.gcs_replication_followers))
    return [f"{path}.follower{i}" for i in range(n)]


def drop_host(path: str) -> list:
    """Machine-loss analog for chaos: destroy the primary member's file
    and its in-process replica object (process + disk gone). Follower
    members are untouched. Returns the paths removed."""
    path = os.path.abspath(path)
    removed = []
    with _REGISTRY_LOCK:
        rep = _REPLICAS.pop(path, None)
    if rep is not None:
        try:
            os.close(rep._fd)
        except OSError:
            pass
    if os.path.exists(path):
        os.unlink(path)
        removed.append(path)
    return removed


class ReplicaUnreachableError(OSError):
    """A shipped append/snapshot could not be delivered because the member
    host is network-partitioned from the leader (chaos/explorer fault).
    Fail-fast and deterministic: the member votes nothing toward the ack
    quorum and its lag grows until the partition heals."""


class QuorumLostError(RuntimeError):
    """Fewer than a majority of replication-group members are reachable:
    no election may be held (an ack quorum might hide entirely inside the
    unreachable set) and no leader may commit."""


# Network-partition fault injection: a partitioned member host is
# unreachable from everyone — appends, snapshot catch-up, and fence raises
# all fail fast with ReplicaUnreachableError, and elections must not count
# it toward the reachable majority. Keyed by abspath, like _REPLICAS.
_PARTITIONED: set = set()


def partition_host(path: str) -> str:
    """Partition one member host away from the group (chaos nemesis /
    explorer fault). Returns the normalized path for heal_host."""
    path = os.path.abspath(path)
    _PARTITIONED.add(path)
    return path


def heal_host(path: str) -> None:
    _PARTITIONED.discard(os.path.abspath(path))


def heal_all_partitions() -> None:
    """Chaos per-seed hygiene: drop every injected partition."""
    _PARTITIONED.clear()


def partitioned_hosts() -> set:
    return set(_PARTITIONED)


# Election claim registry: standbys racing a promotion claim their target
# term here atomically; only the highest claim proceeds to open the store.
# In-process analog of a Raft RequestVote round — cross-process safety
# still rests on the durable fence frames (an open at or below a durable
# fence raises StaleLeaderError on the first write).
_TERM_CLAIMS: Dict[str, int] = {}


def try_claim_term(path: str, term: int) -> bool:
    """Atomically claim leadership ``term`` for the group rooted at
    ``path``. Returns False if an equal-or-higher claim exists (another
    standby won this round — re-enter the watch loop at the new term)."""
    path = os.path.abspath(path)
    with _REGISTRY_LOCK:
        if _TERM_CLAIMS.get(path, 0) >= term:
            return False
        _TERM_CLAIMS[path] = term
        return True


_TEL_REPL_LAG_S = telemetry.histogram(
    "gcs",
    "replication_lag_s",
    "follower ack latency per shipped group-commit",
    buckets=telemetry.LATENCY_BUCKETS_S,
)
_TEL_REPL_LAG_SEQ = telemetry.gauge(
    "gcs",
    "replica_lag_seq",
    "per-member replication lag: leader seq minus the member's applied seq",
)
_TEL_QUORUM_SIZE = telemetry.gauge(
    "gcs",
    "quorum_size",
    "ack quorum of the replication group: ⌈(members+1)/2⌉",
)
_TEL_QUORUM_WAIT_S = telemetry.histogram(
    "gcs",
    "commit_quorum_wait_s",
    "group-commit wait from first member append to quorum ack",
    buckets=telemetry.LATENCY_BUCKETS_S,
)


class ReplicatedStoreClient(StoreClient):
    """WAL chained with majority-quorum log-shipping to follower members
    (see the replicated-backend comment above). Keeps WalStoreClient's
    group commit: mutations from one event-loop tick coalesce into one
    buffer that is appended — and per ``gcs_store_sync`` fsynced — on a
    *majority* of members (leader included) before the flush acks.
    Laggard members catch up asynchronously on their own serial ship
    lanes; a two-member group degenerates to wait-for-all (quorum 2 of 2),
    preserving the original synchronous-shipping semantics.

    Leadership: the client carries the writer's ``term``. ``set_term``
    raises the fence on every reachable member (promotion); a put/delete
    under a term older than any member's fence raises StaleLeaderError
    without touching the mirror, and a fence raised mid-tick poisons the
    client (``fenced``) so the deposed leader stops cleanly. Losing a
    reachable majority mid-flight fences the client the same way — the
    leader demotes rather than acking unreplicated writes.
    """

    def __init__(
        self,
        path: str,
        followers: Optional[list] = None,
        term: Optional[int] = None,
        sync: Optional[str] = None,
        compact_bytes: Optional[int] = None,
        on_fenced=None,
    ):
        self._path = os.path.abspath(path)
        self._sync = sync or config.gcs_store_sync
        self._compact_bytes = (
            config.gcs_wal_compact_bytes if compact_bytes is None else compact_bytes
        )
        self._lock = threading.Lock()
        self._closed = False
        self.fenced = False
        self._fence_gen = -1  # forces a full fence check on first write
        self._on_fenced = on_fenced
        self._pending: list = []
        self._flush_scheduled = False
        # Optional crash-point probe: called after each quorum-acked group
        # commit with (seq, n_ops). Fence aborts never ack, so never fire
        # it (see devtools/explore.py crash enumeration).
        self.commit_listener = None
        # Optional stream hook for the RPC-fed standby: called after each
        # quorum ack with (frames, term, seq, prev_seq) — the raw shipped
        # bytes plus the watermark they start after (gap detection).
        self.ship_listener = None
        member_paths = [self._path] + [
            os.path.abspath(p)
            for p in (followers if followers is not None else follower_paths(path))
        ]
        self._members = [_open_replica(p) for p in member_paths]
        self._quorum = len(self._members) // 2 + 1
        # Per-follower serial ship lanes: one single-thread executor per
        # follower so member fsyncs overlap (os.fsync drops the GIL) while
        # each member still applies its stream in order — required now that
        # a laggard's append may still be in flight when the next group
        # commit acks on the quorum.
        self._ship_lanes = [
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"gcs-repl-ship-{i}"
            )
            for i in range(1, len(self._members))
        ]
        # Election (Raft-style): require a majority of members reachable,
        # then adopt the highest (term, seq) among the *reachable* set.
        # Any ack quorum intersects any reachable majority, so every
        # acknowledged record is present in the adopted log — even when
        # the single freshest file sits on a partitioned member. After
        # machine loss of the primary a fresh primary file starts at
        # (term 0, seq 0) and loses this election.
        reachable = [
            i for i, m in enumerate(self._members) if m.path not in _PARTITIONED
        ]
        if len(reachable) < self._quorum:
            self.close()
            raise QuorumLostError(
                f"only {len(reachable)} of {len(self._members)} replication "
                f"members reachable; need a majority of {self._quorum} to elect"
            )
        states = {}
        for i in reachable:
            m = self._members[i]
            data = b""
            if os.path.exists(m.path):
                with open(m.path, "rb") as f:
                    data = f.read()
            states[i] = _parse_replicated(data)
        best = max(reachable, key=lambda i: (states[i][1], states[i][2]))
        tables, bterm, bseq, _ = states[best]
        self._tables = tables
        self._seq = bseq
        self._term = bterm if term is None else term
        fence = max(self._members[i].fence_term for i in reachable)
        if self._term < fence:
            from ray_tpu_torch._private.rpc import StaleLeaderError

            self.close()
            raise StaleLeaderError(
                f"store opened at term {self._term} behind "
                f"fence {fence}"
            )
        # Catch-up: stale reachable members (lost host replaced, follower
        # behind) receive the full state as one snapshot frame, then ride
        # the tail. Partitioned members catch up the same way when their
        # lag is noticed after the partition heals.
        snap = None
        for i in reachable:
            if states[i][2] < bseq or states[i][1] < bterm:
                if snap is None:
                    snap = _rframe(
                        "snap", "", "",
                        msgpack.packb(self._tables, use_bin_type=True),
                        self._term, self._seq,
                    )
                self._members[i].reset_with(snap, self._term, self._seq, self._sync)
        for i in reachable:
            self._members[i].raise_fence(self._term)
        # Per-follower shipped watermark: the seq after the last frame
        # SUBMITTED to the member's lane. Laggard detection keys off this,
        # not the member's applied seq — an in-flight append on a lane is
        # ordered, not behind, and must not trigger a snapshot re-ship.
        # Partitioned members keep their stale applied seq here, so their
        # first post-heal flush mismatches and ships the catch-up snapshot.
        self._shipped = [m.seq for m in self._members[1:]]
        _TEL_QUORUM_SIZE.default.set(self._quorum)

    @property
    def term(self) -> int:
        return self._term

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def quorum(self) -> int:
        """Ack quorum: ⌈(members+1)/2⌉, the leader's own append included."""
        return self._quorum

    def replica_lag(self) -> Dict[str, int]:
        """Per-member replication lag in sequence numbers (leader seq minus
        the member's applied seq). 0 = fully caught up; the leader's own
        entry is always 0 by the time a commit acks."""
        return {
            os.path.basename(m.path): max(0, self._seq - m.seq)
            for m in self._members
        }

    def wait_replication(self) -> None:
        """Barrier: block until every in-flight follower ship (including
        laggard catch-up) has drained. The event loop's group commit never
        waits for more than the quorum; a caller's ``flush`` ends with this
        barrier."""
        if self._closed:
            return
        try:
            futs = [lane.submit(lambda: None) for lane in self._ship_lanes]
        except RuntimeError:  # closed by another thread meanwhile
            return
        for fut in futs:
            fut.result()

    def snapshot_tables(self):
        """Full state as (packed_tables, term, seq) — the ShipSnapshot RPC
        body for bootstrapping a cross-process standby mirror."""
        with self._lock:
            return (
                msgpack.packb(self._tables, use_bin_type=True),
                self._term,
                self._seq,
            )

    def set_term(self, term: int) -> None:
        """Adopt a (higher) leadership term and fence every reachable
        member at it: the promoted standby's first store act, before any
        write. Partitioned members are fenced on rejoin by catch-up."""
        from ray_tpu_torch._private.rpc import StaleLeaderError

        with self._lock:
            fence = max(
                (
                    m.fence_term
                    for m in self._members
                    if m.path not in _PARTITIONED
                ),
                default=0,
            )
            if term < fence:
                raise StaleLeaderError(
                    f"cannot adopt term {term} behind "
                    f"fence {fence}"
                )
            self._term = term
        for m in self._members:
            m.raise_fence(term)

    def _check_fence(self) -> None:
        from ray_tpu_torch._private.rpc import StaleLeaderError

        if self.fenced:
            raise StaleLeaderError(
                f"store client (term {self._term}) is fenced"
            )
        # Snapshot the generation BEFORE reading fences: a concurrent raise
        # leaves the stored generation stale, forcing a re-check next write.
        gen = _FENCE_GEN[0]
        fence = max(m.fence_term for m in self._members)
        if self._term < fence:
            self._mark_fenced()
            raise StaleLeaderError(
                f"write from term {self._term} rejected "
                f"(leadership fence at term {fence})"
            )
        self._fence_gen = gen

    def _mark_fenced(self) -> None:
        self.fenced = True
        self._pending.clear()
        if self._on_fenced is not None:
            cb, self._on_fenced = self._on_fenced, None
            try:
                cb()
            except Exception:
                pass

    # -- group commit (shipped) ---------------------------------------------

    def _schedule_flush(self) -> None:
        if self._sync == "always":
            self._flush()
            return
        if self._flush_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush()
            return
        self._flush_scheduled = True
        loop.call_soon(self.flush, False)

    def flush(self, drain: bool = True) -> None:
        """Force the buffered tick out. The event loop's group commit
        (``drain=False``) returns once a quorum holds it; a caller's flush
        returns once every reachable member does: a standby tails one
        follower's file (``ReplicaTailer``), and what a caller flushed —
        the leadership lease, a write it waits on — must be in that file
        when ``flush`` returns, even when the other follower acked first."""
        with self._lock:
            self._flush_scheduled = False
            self._flush()
        if drain:
            self.wait_replication()

    def _ship_one(self, fi: int, m: "_ReplicaLog", buf, term, seq, prev_seq, snap) -> str:
        """Deliver one group commit to one follower on its serial lane.
        ``snap`` non-None means the member was behind the stream at submit
        time: ship the full state at (term, seq) instead of the
        incremental buffer (also how a healed partition rejoins — the
        snapshot carries the fence bump). Any failure (and any append that
        would land after a failed predecessor, leaving a gap in the
        member's log) demotes the shipped watermark to -1 so the next
        group commit re-ships the full state; the member never applies an
        out-of-order frame, so it can at worst be stale, never torn."""
        from ray_tpu_torch._private.rpc import StaleLeaderError

        try:
            if snap is not None:
                m.reset_with(snap, term, seq, self._sync)
            else:
                if m.seq != prev_seq:
                    self._shipped[fi] = -1
                    return "resync"
                m.append(buf, term, seq, self._sync)
            return "ok"
        except ReplicaUnreachableError:
            self._shipped[fi] = -1
            return "unreachable"
        except StaleLeaderError:
            return "fenced"
        except OSError:
            self._shipped[fi] = -1
            return "error"

    def _flush(self) -> None:  # caller holds _lock
        from ray_tpu_torch._private.rpc import StaleLeaderError

        if not self._pending or self._closed or self.fenced:
            self._pending.clear()
            return
        n_ops = len(self._pending)
        buf = b"".join(self._pending)
        self._pending.clear()
        prev_seq = self._seq - n_ops  # watermark the buffer starts after
        t0 = time.perf_counter()
        # Leader's own append is the first quorum vote.
        try:
            self._members[0].append(buf, self._term, self._seq, self._sync)
        except StaleLeaderError:
            # Fenced mid-tick: this tick's writes were never replicated and
            # the leadership that acknowledged them is over — the deposed
            # leader must stop serving, not limp on with a diverged mirror.
            self._mark_fenced()
            return
        # Ship to each follower on its serial lane. A member whose shipped
        # watermark is behind the stream (healed partition, failed ship,
        # reset file) gets the full state as one snapshot frame instead —
        # idempotent, and it truncates any unacked garbage the member may
        # carry. In-flight lane work does NOT count as behind: the lane
        # applies its stream in order.
        snap = None
        futs = []
        for fi, m in enumerate(self._members[1:]):
            if m.path in _PARTITIONED:
                continue  # fail-fast: no vote, lag accrues until heal
            this_snap = None
            if self._shipped[fi] != prev_seq:
                if snap is None:
                    snap = _rframe(
                        "snap", "", "",
                        msgpack.packb(self._tables, use_bin_type=True),
                        self._term, self._seq,
                    )
                this_snap = snap
            self._shipped[fi] = self._seq
            futs.append(
                self._ship_lanes[fi].submit(
                    self._ship_one, fi, m, buf, self._term, self._seq,
                    prev_seq, this_snap,
                )
            )
        # Quorum tally: ack as soon as a majority (leader included) holds
        # the commit. Laggard futures keep running on their lanes; their
        # lag is visible through replica_lag()/the replica_lag_seq gauge.
        needed = self._quorum - 1
        acks = 0
        saw_fence = False
        pending = set(futs)
        while pending and acks < needed and not saw_fence:
            done, pending = concurrent.futures.wait(
                pending, return_when=concurrent.futures.FIRST_COMPLETED
            )
            for fut in done:
                verdict = fut.result()
                if verdict == "ok":
                    acks += 1
                elif verdict == "fenced":
                    saw_fence = True
        if acks < needed:
            # No majority holds this commit: a newer leader fenced us, or
            # a majority of members is gone/partitioned. Either way the
            # leader demotes (fences itself) rather than acking writes no
            # quorum can recover.
            self._mark_fenced()
            return
        dt = time.perf_counter() - t0
        _TEL_WRITE_S.default.observe(dt)
        _TEL_REPL_LAG_S.default.observe(dt)
        _TEL_QUORUM_WAIT_S.default.observe(dt)
        _TEL_WAL_BYTES.default.inc(len(buf))
        for m in self._members[1:]:
            _TEL_REPL_LAG_SEQ.cell(member=os.path.basename(m.path)).set(
                max(0, self._seq - m.seq)
            )
        if self.commit_listener is not None:
            self.commit_listener(self._seq, n_ops)
        if self.ship_listener is not None:
            self.ship_listener(buf, self._term, self._seq, prev_seq)
        if self._compact_bytes and self._members[0].log_bytes > self._compact_bytes:
            snap = _rframe(
                "snap", "", "",
                msgpack.packb(self._tables, use_bin_type=True),
                self._term, self._seq,
            )
            try:
                self._members[0].reset_with(snap, self._term, self._seq, self._sync)
            except StaleLeaderError:
                # Fenced after the ack: the commit stands (a quorum holds
                # it), but this leadership is over — demote, skip compaction.
                self._mark_fenced()
                return
            # Follower resets ride their serial lanes so they cannot
            # reorder against an in-flight laggard append.
            for i, m in enumerate(self._members[1:]):
                if m.path in _PARTITIONED:
                    continue  # healed members catch up via the lag snapshot
                self._ship_lanes[i].submit(
                    self._ship_one, i, m, b"", self._term, self._seq,
                    self._seq, snap,
                )
            _TEL_WAL_COMPACTIONS.default.inc()

    # -- StoreClient API -----------------------------------------------------

    def put(self, table: str, key: str, value: bytes) -> None:
        with self._lock:
            if self._closed:
                return
            if self.fenced or self._fence_gen != _FENCE_GEN[0]:
                self._check_fence()
            self._seq += 1
            self._tables.setdefault(table, {})[key] = value
            body = msgpack.packb(
                ["put", table, key, value, self._term, self._seq],
                use_bin_type=True,
            )
            self._pending.append(
                _HDR.pack(len(body), zlib.crc32(body)) + body
            )
            self._schedule_flush()

    def get(self, table: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            if self._closed:
                return
            if self.fenced or self._fence_gen != _FENCE_GEN[0]:
                self._check_fence()
            self._seq += 1
            self._tables.get(table, {}).pop(key, None)
            body = msgpack.packb(
                ["del", table, key, None, self._term, self._seq],
                use_bin_type=True,
            )
            self._pending.append(
                _HDR.pack(len(body), zlib.crc32(body)) + body
            )
            self._schedule_flush()

    def get_all(self, table: str) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._tables.get(table, {}))

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush()
            self._closed = True
        for lane in self._ship_lanes:
            lane.shutdown(wait=True)  # drain laggard catch-up before release
        for m in self._members:
            m._release()

    def crash(self) -> None:
        """Process-death analog: the buffered tick reaches every reachable
        member's file (no fsync) — what a real leader that writes-before-
        acking would have already shipped. Ships already on a lane were
        sent before the death, so they land first, in order: a member
        behind the quorum ack still receives every acknowledged commit."""
        with self._lock:
            if self._closed:
                return
            buf = b"" if self.fenced else b"".join(self._pending)
            self._pending.clear()
            self._closed = True
        for lane in self._ship_lanes:
            lane.shutdown(wait=True)
        if buf:
            for m in self._members:
                m.write_unsynced(buf)
        for m in self._members:
            m._release()


class ReplicaTailer:
    """Warm-standby's view of a shipped log: re-reads new frames from a
    member file on each poll and applies them to a local mirror — the
    cross-process analog of a follower applying its received stream.
    Detects compaction/catch-up rewrites (inode change, shrink, or changed
    leading bytes — inode numbers alone are unreliable: many filesystems
    hand a renamed-over file the number the original just freed) and
    replays from offset zero. The check and the read go through one open
    file, so a rewrite renamed in between cannot hand the read the new
    file at the old one's offset."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.tables: Dict[str, Dict[str, bytes]] = {}
        self.term = 0
        self.seq = 0
        self._off = 0
        self._ino = None
        self._head = b""  # first bytes at last reset: rewrite fingerprint

    def poll(self) -> int:
        """Apply any new frames; returns how many bytes were consumed."""
        try:
            f = open(self.path, "rb")
        except OSError:
            return 0
        with f:
            st = os.fstat(f.fileno())
            head = f.read(len(self._head)) if self._head else b""
            if (
                st.st_ino != self._ino
                or st.st_size < self._off
                or head != self._head
            ):
                self._ino = st.st_ino
                self._off = 0
                self.tables = {}
            if st.st_size <= self._off:
                return 0
            f.seek(self._off)
            data = f.read()
        if self._off == 0:
            self._head = data[:32]
        self.tables, term, seq, good = apply_replicated(self.tables, data)
        if good == 0:
            return 0
        self.term = max(self.term, term)
        self.seq = max(self.seq, seq)
        self._off += good
        return good

    def get(self, table: str, key: str) -> Optional[bytes]:
        return self.tables.get(table, {}).get(key)

    def get_all(self, table: str) -> Dict[str, bytes]:
        return dict(self.tables.get(table, {}))


def inject_torn_tail(path: str) -> bool:
    """Append a partial frame to a WAL file — the on-disk shape of a crash
    that died mid-append of a NEW record (its header landed, its body did
    not). Recovery must truncate it without losing any earlier record.
    Returns False (no-op) for non-WAL persistence files (sqlite)."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:16].startswith(b"SQLite format 3"):
        return False
    with open(path, "ab") as f:
        f.write(_HDR.pack(512, 0xDEADBEEF) + b"\x00" * 17)  # 512-byte body cut short
    return True


def make_store(
    persist_path: Optional[str],
    backend: Optional[str] = None,
    term: Optional[int] = None,
    on_fenced=None,
) -> StoreClient:
    """Build the configured store. No path -> in-memory regardless of
    backend; with a path, ``backend`` (default: the ``gcs_persist_backend``
    knob) picks wal / sqlite / memory / replicated. ``term``/``on_fenced``
    apply to the replicated backend only (leadership stamp + fencing
    notification for the HA control plane)."""
    if not persist_path:
        return InMemoryStoreClient()
    backend = backend or config.gcs_persist_backend
    if backend == "sqlite":
        return SqliteStoreClient(persist_path)
    if backend == "memory":
        return InMemoryStoreClient()
    if backend == "replicated":
        return ReplicatedStoreClient(persist_path, term=term, on_fenced=on_fenced)
    if backend != "wal":
        raise ValueError(f"unknown gcs_persist_backend {backend!r}")
    return WalStoreClient(persist_path)
