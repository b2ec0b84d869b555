"""The reference's tests/test_gcs_store.py on the port, case for case after the
rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest fixtures
-> ray_tpu_torch.testing's). No case differs.

test_replica_tailer_follows_and_survives_compaction and
test_replicated_crash_keeps_acknowledged_state failed under the suite's
load: a flush acked on the quorum (the leader and follower1) while
follower0's ship lane still ran, so a tailer of follower0 missed the write,
and a crash cancelled the ships on that lane. The port's flush returns once
every reachable member holds the tick (the event loop's group commit still
acks on the quorum), its crash lands the ships already on a lane, and its
tailer checks for a rewrite and reads through one open file. Pins follow
the suite, each forcing its case without the load: a follower's lane held
past the flush, past the crash, and a compaction renamed between the
tailer's check and its read.

GCS store backends (gcs_store.py): WAL framing/recovery semantics —
torn-tail truncation, CRC rejection, group commit, snapshot compaction,
crash-vs-close — and op-sequence parity across all three backends."""

import asyncio
import os
import struct
import zlib

import pytest

from ray_tpu_torch._private import gcs_store
from ray_tpu_torch._private.gcs_store import (
    InMemoryStoreClient,
    SqliteStoreClient,
    WalStoreClient,
    inject_torn_tail,
    make_store,
)


@pytest.fixture
def wal_path(tmp_path):
    return str(tmp_path / "gcs.wal")


def test_wal_basic_roundtrip(wal_path):
    s = WalStoreClient(wal_path)
    s.put("kv", "a", b"1")
    s.put("kv", "b", b"2")
    s.put("kv", "a", b"3")  # overwrite
    s.delete("kv", "b")
    assert s.get("kv", "a") == b"3"
    assert s.get("kv", "b") is None
    s.close()
    s2 = WalStoreClient(wal_path)
    assert s2.get_all("kv") == {"a": b"3"}
    s2.close()


def test_wal_torn_tail_truncated(wal_path):
    s = WalStoreClient(wal_path)
    s.put("actors", "x", b"alive")
    s.crash()
    size_before = os.path.getsize(wal_path)
    assert inject_torn_tail(wal_path)
    assert os.path.getsize(wal_path) > size_before
    s2 = WalStoreClient(wal_path)
    # The torn frame is truncated away; every intact record survives.
    assert s2.get("actors", "x") == b"alive"
    s2.close()
    assert os.path.getsize(wal_path) == size_before


def test_wal_crc_rejection(wal_path):
    s = WalStoreClient(wal_path)
    s.put("kv", "good", b"v")
    s.put("kv", "bad", b"w")
    s.close()
    # Flip a byte inside the LAST record's body: its CRC no longer matches,
    # so recovery must stop before it (and keep everything earlier).
    with open(wal_path, "r+b") as f:
        data = f.read()
        f.seek(len(data) - 2)
        f.write(bytes([data[-2] ^ 0xFF]))
    s2 = WalStoreClient(wal_path)
    assert s2.get("kv", "good") == b"v"
    assert s2.get("kv", "bad") is None
    s2.close()


def test_wal_group_commit_one_write_per_tick(wal_path):
    s = WalStoreClient(wal_path)

    async def burst():
        for i in range(256):
            s.put("kv", f"k{i}", b"v" * 64)
        # Buffered until the scheduled call_soon flush runs.
        assert s._pending
        await asyncio.sleep(0)
        assert not s._pending

    asyncio.run(burst())
    s.crash()
    s2 = WalStoreClient(wal_path)
    assert len(s2.get_all("kv")) == 256
    s2.close()


def test_wal_compaction_preserves_state(wal_path):
    s = WalStoreClient(wal_path, compact_bytes=2048)
    for i in range(100):
        s.put("kv", f"k{i % 10}", (b"v%d" % i) * 30)
    s.delete("kv", "k0")
    s.close()
    # Log stayed bounded (~one snapshot, not 100 records)...
    assert os.path.getsize(wal_path) < 20 * 2048
    # ...and replays to the same state.
    s2 = WalStoreClient(wal_path)
    kv = s2.get_all("kv")
    assert set(kv) == {f"k{i}" for i in range(1, 10)}
    assert kv["k9"] == b"v99" * 30
    s2.close()


def test_wal_crash_keeps_acknowledged_state(wal_path):
    s = WalStoreClient(wal_path)
    for i in range(32):
        s.put("jobs", f"j{i}", b"running")
    s.crash()  # no fsync, no checkpoint — but the tail reaches the OS
    s2 = WalStoreClient(wal_path)
    assert len(s2.get_all("jobs")) == 32
    s2.close()


def test_wal_sync_always_flushes_inline(wal_path):
    s = WalStoreClient(wal_path, sync="always")

    async def one():
        s.put("kv", "k", b"v")
        assert not s._pending  # no group-commit buffering

    asyncio.run(one())
    s.crash()
    assert WalStoreClient(wal_path).get("kv", "k") == b"v"


def test_wal_refuses_sqlite_file(tmp_path):
    p = str(tmp_path / "gcs.db")
    sq = SqliteStoreClient(p)
    sq.put("kv", "k", b"v")
    sq.close()
    with pytest.raises(ValueError):
        WalStoreClient(p)
    assert not inject_torn_tail(p)
    # The refused open must not have damaged the sqlite file.
    sq2 = SqliteStoreClient(p)
    assert sq2.get("kv", "k") == b"v"
    sq2.close()


def test_sqlite_close_checkpoints_wal(tmp_path):
    p = str(tmp_path / "gcs.db")
    s = SqliteStoreClient(p)
    s.put("kv", "k", b"v")
    assert os.path.getsize(p + "-wal") > 0
    s.close()
    # Graceful close folds the -wal file into the main db.
    assert (
        not os.path.exists(p + "-wal") or os.path.getsize(p + "-wal") == 0
    )
    s2 = SqliteStoreClient(p)
    assert s2.get("kv", "k") == b"v"
    s2.close()


def test_sqlite_crash_leaves_wal_replayable(tmp_path):
    p = str(tmp_path / "gcs.db")
    s = SqliteStoreClient(p)
    s.put("kv", "k", b"v")
    s.crash()  # no checkpoint: -wal left behind
    s2 = SqliteStoreClient(p)
    assert s2.get("kv", "k") == b"v"  # sqlite replays its WAL on open
    s2.close()


_OPS = [
    ("put", "kv", "a", b"1"),
    ("put", "actors", "x", b"spec"),
    ("put", "kv", "a", b"2"),
    ("put", "kv", "b", b"3"),
    ("del", "kv", "a", None),
    ("put", "named", "all", b"{}"),
    ("del", "kv", "missing", None),
    ("put", "pgs", "pg1", b"pending"),
    ("put", "pgs", "pg1", b"created"),
]


def _apply(store):
    for op, table, key, value in _OPS:
        if op == "put":
            store.put(table, key, value)
        else:
            store.delete(table, key)


def test_backend_parity(tmp_path):
    """Same op sequence -> same get_all across all three backends, both
    live and (for the durable two) after a reopen."""
    stores = {
        "memory": InMemoryStoreClient(),
        "sqlite": SqliteStoreClient(str(tmp_path / "p.db")),
        "wal": WalStoreClient(str(tmp_path / "p.wal")),
    }
    tables = ("kv", "actors", "named", "jobs", "pgs")
    for s in stores.values():
        _apply(s)
    expect = {t: stores["memory"].get_all(t) for t in tables}
    for name, s in stores.items():
        assert {t: s.get_all(t) for t in tables} == expect, name
        s.close()
    for name, reopened in (
        ("sqlite", SqliteStoreClient(str(tmp_path / "p.db"))),
        ("wal", WalStoreClient(str(tmp_path / "p.wal"))),
    ):
        assert {t: reopened.get_all(t) for t in tables} == expect, name
        reopened.close()


def test_make_store_backend_selection(tmp_path, monkeypatch):
    from ray_tpu_torch._private.common import config

    assert isinstance(make_store(None), InMemoryStoreClient)
    assert isinstance(
        make_store(str(tmp_path / "a.wal")), WalStoreClient
    )  # default knob = wal
    assert isinstance(
        make_store(str(tmp_path / "b.db"), backend="sqlite"), SqliteStoreClient
    )
    assert isinstance(
        make_store(str(tmp_path / "c"), backend="memory"), InMemoryStoreClient
    )
    monkeypatch.setenv("RAY_TPU_GCS_PERSIST_BACKEND", "sqlite")
    config.refresh()
    try:
        assert isinstance(
            make_store(str(tmp_path / "d.db")), SqliteStoreClient
        )
        with pytest.raises(ValueError):
            make_store(str(tmp_path / "e"), backend="bogus")
    finally:
        monkeypatch.delenv("RAY_TPU_GCS_PERSIST_BACKEND")
        config.refresh()


# -- replicated store (HA): log shipping, fencing, machine loss --------------


@pytest.fixture
def repl_path(tmp_path):
    return str(tmp_path / "gcs.wal")


def test_replicated_ships_to_followers(repl_path):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path)
    s.put("kv", "a", b"1")
    s.put("actors", "x", b"alive")
    s.flush()
    s.close()
    # Every member of the replication group holds the full acknowledged
    # state, independently replayable from its own file.
    for member in [repl_path] + follower_paths(repl_path):
        with open(member, "rb") as f:
            tables, _, _, _ = gcs_store._parse_replicated(f.read())
        assert tables["kv"]["a"] == b"1", member
        assert tables["actors"]["x"] == b"alive", member


def test_replicated_survives_primary_host_loss(repl_path):
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient, drop_host

    s = ReplicatedStoreClient(repl_path, term=1)
    s.put("kv", "k", b"v")
    s.flush()
    s.crash()  # process death: no graceful close
    drop_host(repl_path)  # the machine (and its log member) is gone
    # A successor opens the group, adopts the surviving follower's state,
    # and re-creates the lost member via snapshot catch-up.
    s2 = ReplicatedStoreClient(repl_path, term=2)
    assert s2.get("kv", "k") == b"v"
    assert s2.term == 2
    s2.put("kv", "k2", b"v2")
    s2.flush()
    s2.close()
    assert os.path.exists(repl_path)  # re-created by catch-up


def test_replicated_fences_stale_writer(repl_path):
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient
    from ray_tpu_torch._private.rpc import StaleLeaderError

    old = ReplicatedStoreClient(repl_path, term=1)
    old.put("kv", "pre", b"1")
    old.flush()
    new = ReplicatedStoreClient(repl_path, term=2)
    # The deposed leader's next acknowledged write must be rejected, not
    # silently applied (split-brain prevention).
    with pytest.raises(StaleLeaderError):
        old.put("kv", "post", b"2")
        old.flush()
    new.flush()
    assert new.get("kv", "pre") == b"1"
    assert new.get("kv", "post") is None
    old.close()
    new.close()


def test_replicated_open_below_fence_rejected(repl_path):
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient
    from ray_tpu_torch._private.rpc import StaleLeaderError

    s = ReplicatedStoreClient(repl_path, term=3)
    s.put("kv", "a", b"1")
    s.flush()
    with pytest.raises(StaleLeaderError):
        ReplicatedStoreClient(repl_path, term=2)
    s.close()


def test_replicated_fence_survives_restart(repl_path):
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient
    from ray_tpu_torch._private.rpc import StaleLeaderError

    s = ReplicatedStoreClient(repl_path, term=5)
    s.put("kv", "a", b"1")
    s.flush()
    s.close()
    # The fence is durable: after every in-process handle is gone, a
    # reopened group still rejects terms below the highest ever accepted.
    with pytest.raises(StaleLeaderError):
        ReplicatedStoreClient(repl_path, term=4)
    s2 = ReplicatedStoreClient(repl_path, term=5)
    assert s2.get("kv", "a") == b"1"
    s2.close()


def test_replicated_crash_keeps_acknowledged_state(repl_path):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path, term=1)
    for i in range(10):
        s.put("kv", f"k{i}", str(i).encode())
    s.crash()  # pending group-commit buffer lands on every member
    for member in [repl_path] + follower_paths(repl_path):
        with open(member, "rb") as f:
            tables, _, _, _ = gcs_store._parse_replicated(f.read())
        for i in range(10):
            assert tables["kv"][f"k{i}"] == str(i).encode(), member


def test_replica_tailer_follows_and_survives_compaction(repl_path):
    from ray_tpu_torch._private.gcs_store import (
        ReplicaTailer,
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path, term=1, compact_bytes=2048)
    tailer = ReplicaTailer(follower_paths(repl_path)[0])
    s.put("kv", "a", b"1")
    s.flush()
    tailer.poll()
    assert tailer.get("kv", "a") == b"1"
    assert tailer.term == 1
    # Push the log past the compaction threshold: the member file is
    # rewritten in place and the tailer must detect the new inode/shorter
    # file and replay from scratch rather than tailing garbage.
    for i in range(200):
        s.put("kv", "big", b"x" * 64 + str(i).encode())
    s.flush()
    s.put("kv", "last", b"z")
    s.flush()
    tailer.poll()
    assert tailer.get("kv", "last") == b"z"
    assert tailer.get("kv", "a") == b"1"
    s.close()


def test_make_store_replicated_selection(tmp_path, monkeypatch):
    from ray_tpu_torch._private.common import config
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient

    s = make_store(str(tmp_path / "r.wal"), backend="replicated", term=1)
    assert isinstance(s, ReplicatedStoreClient)
    assert s.term == 1
    s.close()
    monkeypatch.setenv("RAY_TPU_GCS_PERSIST_BACKEND", "replicated")
    config.refresh()
    try:
        s = make_store(str(tmp_path / "r2.wal"))
        assert isinstance(s, ReplicatedStoreClient)
        s.close()
    finally:
        monkeypatch.delenv("RAY_TPU_GCS_PERSIST_BACKEND")
        config.refresh()


# ---------------------------------------------------------------------------
# Quorum replication (>= 3-member groups)
# ---------------------------------------------------------------------------


@pytest.fixture
def quorum_heal():
    """Partitions are module-global fault injection; never leak them."""
    yield
    gcs_store.heal_all_partitions()


def _member_state(path):
    with open(path, "rb") as f:
        return gcs_store._parse_replicated(f.read())


def test_quorum_acks_at_exact_majority(repl_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
        partition_host,
    )

    fols = follower_paths(repl_path, 2)
    s = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    assert s.quorum == 2  # ceil((3+1)/2)... floor(3/2)+1: 2 of 3
    partition_host(fols[1])
    commits = []
    s.commit_listener = lambda seq, n_ops: commits.append((seq, n_ops))
    s.put("kv", "a", b"1")
    s.flush()
    # Exactly the majority (leader + one follower) is reachable: the
    # commit must ack and the leader must stay un-fenced.
    assert commits == [(1, 1)]
    assert not s.fenced
    assert s.get("kv", "a") == b"1"
    tables, _, _, _ = _member_state(fols[0])
    assert tables["kv"]["a"] == b"1"
    # The dark minority member holds nothing and shows up as lag.
    tables, _, _, _ = _member_state(fols[1])
    assert "a" not in tables.get("kv", {})
    assert s.replica_lag()[os.path.basename(fols[1])] == 1
    assert s.replica_lag()[os.path.basename(fols[0])] == 0
    s.close()


def test_quorum_loss_demotes_leader_without_acking(repl_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
        partition_host,
    )
    from ray_tpu_torch._private.rpc import StaleLeaderError

    fols = follower_paths(repl_path, 2)
    s = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    commits = []
    s.commit_listener = lambda seq, n_ops: commits.append(seq)
    partition_host(fols[0])
    partition_host(fols[1])
    s.put("kv", "a", b"1")
    s.flush()
    # Every follower is unreachable: no majority can hold the write, so
    # the leader demotes itself rather than acking it.
    assert commits == []
    assert s.fenced
    with pytest.raises(StaleLeaderError):
        s.put("kv", "b", b"2")
        s.flush()
    s.close()


def test_quorum_laggard_catches_up_via_snapshot(repl_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
        heal_host,
        partition_host,
    )

    fols = follower_paths(repl_path, 2)
    s = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    partition_host(fols[1])
    for i in range(5):
        s.put("kv", f"k{i}", str(i).encode())
        s.flush()
    assert s.replica_lag()[os.path.basename(fols[1])] == 5
    heal_host(fols[1])
    # The next commit notices the healed member is behind the stream and
    # ships the full state as one snapshot frame on its lane.
    s.put("kv", "post", b"p")
    s.flush()
    s.wait_replication()
    tables, term, seq, _ = _member_state(fols[1])
    assert term == 1 and seq == s.seq
    assert tables["kv"]["post"] == b"p"
    for i in range(5):
        assert tables["kv"][f"k{i}"] == str(i).encode()
    assert s.replica_lag()[os.path.basename(fols[1])] == 0
    s.close()


def test_quorum_freshest_election_beats_file_freshest(repl_path, quorum_heal, tmp_path):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        drop_host,
        follower_paths,
        heal_host,
        partition_host,
    )

    fols = follower_paths(repl_path, 2)
    # Phase 1: 6KB of overwrites of one key land on every member.
    s1 = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    for i in range(4):
        s1.put("kv", "x", bytes([65 + i]) * 1500)
        s1.flush()
    s1.close()
    # Phase 2: fol0 partitions; the new term compacts the survivors down
    # to a ~1.5KB snapshot and commits a fresh key on the majority.
    partition_host(fols[0])
    s2 = ReplicatedStoreClient(
        repl_path, followers=fols, term=2, compact_bytes=2048, sync="off"
    )
    s2.put("kv", "fresh", b"F")
    s2.flush()
    s2.wait_replication()
    s2.crash()
    drop_host(repl_path)
    heal_host(fols[0])
    # fol0 has the LARGEST file (the long un-compacted term-1 log) but the
    # LOWEST (term, seq); fol1 is byte-small but quorum-fresh. Election
    # must adopt fol1 — a file-size/mtime heuristic would resurrect stale
    # state and lose the acked "fresh" key.
    assert os.path.getsize(fols[0]) > os.path.getsize(fols[1])
    s3 = ReplicatedStoreClient(repl_path, followers=fols, term=3, sync="off")
    assert s3.get("kv", "fresh") == b"F"
    assert s3.get("kv", "x") == b"D" * 1500
    s3.close()


def test_quorum_lost_error_until_majority_heals(repl_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import (
        QuorumLostError,
        ReplicatedStoreClient,
        follower_paths,
        heal_host,
        partition_host,
    )

    fols = follower_paths(repl_path, 2)
    s = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    s.put("kv", "a", b"1")
    s.flush()
    s.close()
    partition_host(fols[0])
    partition_host(fols[1])
    # Only the leader member is reachable (1 of 3): the election must
    # fail closed — it cannot prove it sees every possibly-acked write.
    with pytest.raises(QuorumLostError):
        ReplicatedStoreClient(repl_path, followers=fols, term=2, sync="off")
    heal_host(fols[0])
    s2 = ReplicatedStoreClient(repl_path, followers=fols, term=2, sync="off")
    assert s2.get("kv", "a") == b"1"
    s2.close()


def test_quorum_rejoin_gets_fence_bump(repl_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        drop_host,
        follower_paths,
        heal_host,
        partition_host,
    )

    fols = follower_paths(repl_path, 2)
    s1 = ReplicatedStoreClient(repl_path, followers=fols, term=1, sync="off")
    partition_host(fols[1])
    s1.put("kv", "a", b"1")
    s1.flush()
    s1.crash()
    drop_host(repl_path)
    # Successor elects over the reachable majority while fol1 is dark...
    s2 = ReplicatedStoreClient(repl_path, followers=fols, term=2, sync="off")
    s2.put("kv", "b", b"2")
    s2.flush()
    # ...and fol1's rejoin rides the catch-up snapshot, which carries the
    # new term: the fence bump that locks out the dead term-1 leadership.
    heal_host(fols[1])
    s2.put("kv", "c", b"3")
    s2.flush()
    s2.wait_replication()
    tables, term, _, _ = _member_state(fols[1])
    assert term == 2
    assert tables["kv"] == {"a": b"1", "b": b"2", "c": b"3"}
    s2.close()


def test_quorum_stale_catchup_snapshot_rejected(repl_path, tmp_path, quorum_heal):
    from ray_tpu_torch._private.gcs_store import ReplicatedStoreClient, follower_paths
    from ray_tpu_torch._private.rpc import StaleLeaderError

    # Regression (found by the interleaving explorer): a deposed leader
    # whose follower moved on sees it as a "laggard" and ships a catch-up
    # snapshot of its own stale state. reset_with must fence that exactly
    # like append, or the old term overwrites the new term's log wholesale.
    shared = follower_paths(repl_path, 1)[0]
    old = ReplicatedStoreClient(repl_path, followers=[shared], term=1, sync="off")
    old.put("kv", "old", b"1")
    old.flush()

    async def race():
        # Under a running loop the put's group commit is deferred to a
        # call_soon tick, so the promotion lands between the (passing)
        # put-side fence check and the flush — the explorer's schedule.
        old.put("kv", "late", b"3")
        new = ReplicatedStoreClient(
            str(tmp_path / "b.wal"), followers=[shared], term=2
        )
        new.put("kv", "new", b"2")
        new.flush()
        await asyncio.sleep(0)  # old's deferred flush fires here
        return new

    new = asyncio.run(race())
    # The deposed leader saw the follower's seq ahead of its stream,
    # shipped its stale state as a catch-up snapshot, and was rejected.
    assert old.fenced
    with pytest.raises(StaleLeaderError):
        old.put("kv", "even-later", b"4")
    tables, term, _, _ = _member_state(shared)
    assert term == 2
    assert tables["kv"].get("new") == b"2"
    assert "late" not in tables["kv"]
    old.close()
    new.close()


# ----------------------------------------------------------------------
# Pins of the port's repair: flush drains to every reachable member.


def _gate_member_appends(member, gate):
    """Hold a member's ship lane at its next append until `gate` is set."""
    append = member.append

    def gated(*args, **kwargs):
        gate.wait(10)
        return append(*args, **kwargs)

    member.append = gated


def test_flush_returns_once_the_tailed_follower_holds_the_write(repl_path):
    """follower0's lane is held for 0.5 s while follower1 acks at once: the
    quorum (leader and follower1) holds the write well before follower0
    does. A tailer of follower0, polled as flush returns, still sees it."""
    import threading

    from ray_tpu_torch._private.gcs_store import (
        ReplicaTailer,
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path, term=1)
    gate = threading.Event()
    _gate_member_appends(s._members[1], gate)  # members: leader, follower0, ...
    timer = threading.Timer(0.5, gate.set)
    timer.start()
    try:
        s.put("kv", "a", b"1")
        s.flush()
        tailer = ReplicaTailer(follower_paths(repl_path)[0])
        tailer.poll()
        assert tailer.get("kv", "a") == b"1"
        assert s.replica_lag() == {os.path.basename(p): 0 for p in
                                   [repl_path] + follower_paths(repl_path)}
    finally:
        gate.set()
        timer.cancel()
        s.close()


def test_group_commit_still_acks_on_the_quorum(repl_path):
    """The event loop's group commit acks once the quorum holds a tick: a
    follower whose lane is held does not stall it."""
    import threading

    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path, term=1)
    gate = threading.Event()
    _gate_member_appends(s._members[1], gate)
    acked = []
    s.commit_listener = lambda seq, n_ops: acked.append(seq)

    async def tick():
        s.put("kv", "a", b"1")
        s.put("kv", "b", b"2")
        await asyncio.sleep(0.05)  # the scheduled commit runs here

    try:
        asyncio.run(tick())
        assert acked == [2]
        assert s.replica_lag()[os.path.basename(follower_paths(repl_path)[0])] == 2
        gate.set()
        s.wait_replication()
        assert s.replica_lag()[os.path.basename(follower_paths(repl_path)[0])] == 0
    finally:
        gate.set()
        s.close()


def test_crash_lands_the_ships_a_lagging_follower_was_sent(repl_path):
    """Each put acks on the quorum while follower0's lane is held, so ten
    acknowledged commits wait on that lane when the leader crashes. They
    were shipped before the death: every member, follower0 too, ends with
    all ten (test_replicated_crash_keeps_acknowledged_state without the
    suite's load deciding which follower lags)."""
    import threading

    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        follower_paths,
    )

    s = ReplicatedStoreClient(repl_path, term=1)
    gate = threading.Event()
    _gate_member_appends(s._members[1], gate)
    timer = threading.Timer(0.5, gate.set)
    try:
        for i in range(10):
            s.put("kv", f"k{i}", str(i).encode())  # no loop: each put commits
        assert s.replica_lag()[os.path.basename(follower_paths(repl_path)[0])] == 10
        timer.start()
        s.crash()
    finally:
        gate.set()
        timer.cancel()
    for member in [repl_path] + follower_paths(repl_path):
        with open(member, "rb") as f:
            tables, _, _, _ = gcs_store._parse_replicated(f.read())
        assert tables["kv"] == {f"k{i}": str(i).encode() for i in range(10)}, member


def test_tailer_reads_the_file_it_checked(tmp_path, monkeypatch):
    """A compaction renamed over the log between the tailer's check for a
    rewrite and its read: the rewrite's snapshot is exactly as long as the
    tailer's offset and a delete follows it, so a read of the new file at
    the old offset parses cleanly. The tailer's state after each poll is the
    old log's or the new one's, never the new file's tail spliced onto the
    old state."""
    import builtins

    import msgpack

    from ray_tpu_torch._private.gcs_store import ReplicaTailer, _rframe

    path = str(tmp_path / "member.log")
    old = _rframe("put", "kv", "k1", b"1" * 100, 1, 1) + _rframe("put", "kv", "k2", b"2" * 100, 1, 2)
    with open(path, "wb") as f:
        f.write(old)
    tailer = ReplicaTailer(path)
    tailer.poll()
    with open(path, "ab") as f:
        f.write(_rframe("put", "kv", "k3", b"3", 1, 3))
    old_state = {"kv": {"k1": b"1" * 100, "k2": b"2" * 100, "k3": b"3"}}
    for n in range(len(old)):
        tables = {"kv": {"k1": b"1" * 100, "k3": b"3"}, "pad": {"p": b"." * n}}
        snap = _rframe("snap", "", "", msgpack.packb(tables, use_bin_type=True), 1, 3)
        if len(snap) == len(old):
            break
    assert len(snap) == len(old)
    new_state = {"kv": {"k3": b"3"}, "pad": tables["pad"]}
    with open(path + ".compact", "wb") as f:
        f.write(snap + _rframe("del", "kv", "k1", None, 1, 4))
    opens = []

    def open_renaming_at_the_second(file, *args, **kwargs):
        if file == tailer.path:
            opens.append(file)
            if len(opens) == 2:
                os.rename(path + ".compact", path)
        return builtins.open(file, *args, **kwargs)

    monkeypatch.setattr(gcs_store, "open", open_renaming_at_the_second, raising=False)
    tailer.poll()
    assert tailer.tables in (old_state, new_state)
    tailer.poll()
    assert tailer.tables == new_state
