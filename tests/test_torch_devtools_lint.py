"""Tests for the devtools static-analysis passes and the runtime probe.

Each lint rule gets at least one positive fixture (must flag) and one
negative fixture (must stay quiet); the rpc_check rules run against
throwaway fixture trees; the aiocheck probe is exercised with a real
two-task interleaving race under ``RAY_TPU_AIOCHECK=1``.
"""

import asyncio
import textwrap

import pytest

from ray_tpu_torch.devtools import aio_lint, lint, rpc_check


def _rules(findings):
    return {f.rule for f in findings}


def _lint(src):
    return aio_lint.lint_source(textwrap.dedent(src), "fixture.py")


# ---------------------------------------------------------------------------
# aio_lint: blocking-call
# ---------------------------------------------------------------------------


def test_blocking_call_positive():
    findings = _lint(
        """
        import time

        async def f():
            time.sleep(1)
        """
    )
    assert aio_lint.RULE_BLOCKING in _rules(findings)


def test_blocking_call_open_builtin_positive():
    findings = _lint(
        """
        async def f(path):
            with open(path) as fh:
                return fh.read()
        """
    )
    assert aio_lint.RULE_BLOCKING in _rules(findings)


def test_blocking_call_negative():
    findings = _lint(
        """
        import asyncio, time

        async def f():
            await asyncio.sleep(1)

        def sync_helper():
            time.sleep(1)  # fine outside async def
        """
    )
    assert aio_lint.RULE_BLOCKING not in _rules(findings)


# ---------------------------------------------------------------------------
# aio_lint: raw-create-task
# ---------------------------------------------------------------------------


def test_raw_create_task_positive():
    findings = _lint(
        """
        import asyncio

        async def f(coro):
            asyncio.create_task(coro)
        """
    )
    assert aio_lint.RULE_CREATE_TASK in _rules(findings)


def test_raw_loop_create_task_positive():
    findings = _lint(
        """
        import asyncio

        async def f(coro):
            asyncio.get_running_loop().create_task(coro)
        """
    )
    assert aio_lint.RULE_CREATE_TASK in _rules(findings)


def test_raw_create_task_negative():
    findings = _lint(
        """
        from ray_tpu_torch._private import rpc

        async def f(coro):
            rpc.spawn(coro)
        """
    )
    assert aio_lint.RULE_CREATE_TASK not in _rules(findings)


# ---------------------------------------------------------------------------
# aio_lint: unawaited-coro
# ---------------------------------------------------------------------------


def test_unawaited_coro_positive():
    findings = _lint(
        """
        async def g():
            return 1

        async def f():
            g()
        """
    )
    assert aio_lint.RULE_UNAWAITED in _rules(findings)


def test_unawaited_coro_negative():
    findings = _lint(
        """
        async def g():
            return 1

        async def f():
            await g()
            t = g()  # bound, not discarded: caller may await/spawn it
            await t
        """
    )
    assert aio_lint.RULE_UNAWAITED not in _rules(findings)


# ---------------------------------------------------------------------------
# aio_lint: await-interleave
# ---------------------------------------------------------------------------

_INTERLEAVE_POSITIVE = """
import asyncio

class Server:
    def __init__(self):
        self.state = {}

    async def handler(self, key):
        val = self.state[key]
        await asyncio.sleep(0)
        self.state[key] = val + 1
"""

_INTERLEAVE_NEGATIVE = """
import asyncio

class Server:
    def __init__(self):
        self.state = {}

    async def handler(self, key):
        val = self.state[key]
        self.state[key] = val + 1  # no await inside the read-write window
        await asyncio.sleep(0)
"""


def test_await_interleave_positive():
    findings = _lint(_INTERLEAVE_POSITIVE)
    assert aio_lint.RULE_INTERLEAVE in _rules(findings)


def test_await_interleave_negative():
    findings = _lint(_INTERLEAVE_NEGATIVE)
    assert aio_lint.RULE_INTERLEAVE not in _rules(findings)


def test_await_interleave_lock_negative():
    findings = _lint(
        """
        import asyncio

        class Server:
            def __init__(self):
                self.state = {}
                self.lock = asyncio.Lock()

            async def handler(self, key):
                async with self.lock:
                    val = self.state[key]
                    await asyncio.sleep(0)
                    self.state[key] = val + 1
        """
    )
    assert aio_lint.RULE_INTERLEAVE not in _rules(findings)


# ---------------------------------------------------------------------------
# aio_lint: inline suppressions
# ---------------------------------------------------------------------------


def test_suppression_same_line():
    findings = _lint(
        """
        import time

        async def f():
            time.sleep(1)  # aio-lint: disable=blocking-call
        """
    )
    assert aio_lint.RULE_BLOCKING not in _rules(findings)


def test_suppression_wrong_rule_does_not_apply():
    findings = _lint(
        """
        import time

        async def f():
            time.sleep(1)  # aio-lint: disable=raw-create-task
        """
    )
    assert aio_lint.RULE_BLOCKING in _rules(findings)


# ---------------------------------------------------------------------------
# rpc_check fixtures
# ---------------------------------------------------------------------------


def _fixture_tree(tmp_path, sources):
    for name, src in sources.items():
        (tmp_path / name).write_text(textwrap.dedent(src))
    return [str(tmp_path)]


def test_unknown_rpc_method_positive(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call("NoSuchMethod", {})
            """,
        },
    )
    findings = rpc_check.check(paths)
    assert rpc_check.RULE_UNKNOWN in _rules(findings)


def test_unknown_rpc_method_negative(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call("Frobnicate", {})
            """,
            "server.py": """
            def setup(s):
                s.register("Frobnicate", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    assert rpc_check.RULE_UNKNOWN not in _rules(findings)


def test_orphan_handler_positive(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "server.py": """
            def setup(s):
                s.register("DeadEndpoint", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    assert rpc_check.RULE_ORPHAN in _rules(findings)


def test_orphan_handler_wrapper_indirection_negative(tmp_path):
    # The method name appears as a plain string elsewhere (a wrapper builds
    # the call) — lenient mode must not flag it.
    paths = _fixture_tree(
        tmp_path,
        {
            "server.py": """
            def setup(s):
                s.register("WrappedEndpoint", handle)
            """,
            "wrapper.py": """
            async def go(client):
                return await client.invoke("WrappedEndpoint")
            """,
        },
    )
    findings = rpc_check.check(paths)
    assert rpc_check.RULE_ORPHAN not in _rules(findings)


def test_payload_drift_missing_required(tmp_path):
    # KVPut requires key+value per wire.py.
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call("KVPut", {"key": b"k"})
            """,
            "server.py": """
            def setup(s):
                s.register("KVPut", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    drift = [f for f in findings if f.rule == rpc_check.RULE_DRIFT]
    assert drift and "value" in drift[0].message


def test_payload_drift_undeclared_key(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call(
                    "KVPut", {"key": b"k", "value": b"v", "bogus_extra": 1}
                )
            """,
            "server.py": """
            def setup(s):
                s.register("KVPut", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    drift = [f for f in findings if f.rule == rpc_check.RULE_DRIFT]
    assert drift and "bogus_extra" in drift[0].message


def test_payload_drift_negative(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call("KVPut", {"key": b"k", "value": b"v", "ns": ""})
            """,
            "server.py": """
            async def handle(p):
                return p["key"], p["value"], p.get("ns")

            def setup(s):
                s.register("KVPut", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    assert rpc_check.RULE_DRIFT not in _rules(findings)


def test_payload_drift_consumer_side(tmp_path):
    paths = _fixture_tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                await conn.call("KVPut", {"key": b"k", "value": b"v"})
            """,
            "server.py": """
            async def handle(p):
                return p["key"], p["renamed_field"]

            def setup(s):
                s.register("KVPut", handle)
            """,
        },
    )
    findings = rpc_check.check(paths)
    drift = [f for f in findings if f.rule == rpc_check.RULE_DRIFT]
    assert drift and any("renamed_field" in f.message for f in drift)


# ---------------------------------------------------------------------------
# The gate itself
# ---------------------------------------------------------------------------


def test_repo_lints_clean():
    """The acceptance criterion: the tree as committed has zero findings."""
    assert lint.main([]) == 0


def test_gate_fails_on_fixture(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(
        "import time\n\nasync def f():\n    time.sleep(1)\n"
    )
    assert lint.main([str(tmp_path)]) == 1
    assert "blocking-call" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Runtime interleaving probe (RAY_TPU_AIOCHECK=1)
# ---------------------------------------------------------------------------


@pytest.fixture
def aiocheck_on(monkeypatch):
    from ray_tpu_torch._private import aiocheck

    monkeypatch.setenv("RAY_TPU_AIOCHECK", "1")
    aiocheck.reset()
    yield aiocheck
    aiocheck.reset()


def test_probe_disabled_returns_plain_dict(monkeypatch):
    from ray_tpu_torch._private import aiocheck

    monkeypatch.delenv("RAY_TPU_AIOCHECK", raising=False)
    d = aiocheck.track("x", {"a": 1})
    assert type(d) is dict and d == {"a": 1}


def test_probe_detects_read_await_write(aiocheck_on):
    aiocheck = aiocheck_on
    d = aiocheck.track("probe.state")

    async def main():
        d["k"] = 0

        async def reader_writer():
            val = d["k"]
            await asyncio.sleep(0.01)  # interleaving window
            d["k"] = val + 1  # stale write-back

        async def interloper():
            await asyncio.sleep(0.005)
            d["k"] = 100

        await asyncio.gather(
            asyncio.create_task(reader_writer(), name="rw"),
            asyncio.create_task(interloper(), name="other"),
        )

    asyncio.run(main())
    kinds = {c.kind for c in aiocheck.conflicts()}
    assert "read-await-write" in kinds


def test_probe_detects_write_write(aiocheck_on):
    aiocheck = aiocheck_on
    d = aiocheck.track("probe.ww")

    async def main():
        async def w1():
            d["z"] = 1

        async def w2():
            await asyncio.sleep(0)
            d["z"] = 2  # blind overwrite of another task's write

        await asyncio.gather(
            asyncio.create_task(w1(), name="w1"),
            asyncio.create_task(w2(), name="w2"),
        )

    asyncio.run(main())
    assert any(
        c.kind == "write-write" and c.key == "z" for c in aiocheck.conflicts()
    )


def test_probe_quiet_on_single_task(aiocheck_on):
    aiocheck = aiocheck_on
    d = aiocheck.track("probe.single")

    async def main():
        d["k"] = 0
        val = d["k"]
        await asyncio.sleep(0)
        d["k"] = val + 1  # same task: interleaving is impossible

    asyncio.run(main())
    assert aiocheck.conflicts() == []


def test_probe_wired_into_gcs(aiocheck_on):
    from ray_tpu_torch._private.aiocheck import TrackedDict
    from ray_tpu_torch._private.gcs import GcsServer

    srv = GcsServer()
    assert isinstance(srv.nodes, TrackedDict)
    assert isinstance(srv.actors, TrackedDict)
    assert isinstance(srv.kv, TrackedDict)


# ---------------------------------------------------------------------------
# aio_lint: await-interleave gaps closed for async-generator yields and
# async comprehensions (both are scheduling points exactly like ``await``)
# ---------------------------------------------------------------------------


def test_interleave_async_generator_yield_positive():
    findings = _lint(
        """
        class Streamer:
            def __init__(self):
                self.state = {}

            async def stream(self, key):
                val = self.state[key]
                yield val  # consumer runs arbitrary code before __anext__
                self.state[key] = val + 1
        """
    )
    assert aio_lint.RULE_INTERLEAVE in _rules(findings)


def test_interleave_async_comprehension_positive():
    findings = _lint(
        """
        class Collector:
            def __init__(self):
                self.state = {}

            async def collect(self, items, key):
                val = self.state[key]
                got = [x async for x in items]
                self.state[key] = val + len(got)
        """
    )
    assert aio_lint.RULE_INTERLEAVE in _rules(findings)


def test_interleave_sync_comprehension_negative():
    findings = _lint(
        """
        class Collector:
            def __init__(self):
                self.state = {}

            async def collect(self, items, key):
                val = self.state[key]
                got = [x for x in items]
                self.state[key] = val + len(got)
                await asyncio.sleep(0)
        """
    )
    assert aio_lint.RULE_INTERLEAVE not in _rules(findings)


def test_interleave_async_for_regression():
    findings = _lint(
        """
        class Consumer:
            def __init__(self):
                self.state = {}

            async def consume(self, source, key):
                val = self.state[key]
                async for item in source:
                    pass
                self.state[key] = val + 1
        """
    )
    assert aio_lint.RULE_INTERLEAVE in _rules(findings)


def test_interleave_async_with_regression():
    findings = _lint(
        """
        class Guard:
            def __init__(self):
                self.state = {}

            async def guarded(self, cm, key):
                val = self.state[key]
                async with cm:
                    pass
                self.state[key] = val + 1
        """
    )
    assert aio_lint.RULE_INTERLEAVE in _rules(findings)


# ---------------------------------------------------------------------------
# aio_lint: shared-attribute footprints (the explorer's DPOR input)
# ---------------------------------------------------------------------------


def test_extract_footprints(tmp_path):
    (tmp_path / "mod.py").write_text(
        textwrap.dedent(
            """
            REGISTRY = {}

            class Worker:
                def __init__(self):
                    self.jobs = []
                    self.done = 0

                def push(self, j):
                    self.jobs.append(j)

                def pull(self):
                    j = self.jobs.pop()
                    self._bump()
                    return j

                def _bump(self):
                    self.done += 1

            def register(name):
                REGISTRY[name] = 1
            """
        )
    )
    fp = aio_lint.extract_footprints([str(tmp_path / "mod.py")])
    assert "self.jobs" in fp["Worker.push"]["writes"]
    # Transitive closure folds _bump's write into pull.
    assert "self.done" in fp["Worker.pull"]["writes"]
    assert "self.jobs" in fp["Worker.pull"]["writes"]
    assert "mod:REGISTRY" in fp["register"]["writes"]


# ---------------------------------------------------------------------------
# lint: stale-suppression audit
# ---------------------------------------------------------------------------


def test_stale_suppression_flagged(tmp_path):
    (tmp_path / "m.py").write_text(
        "x = 1  # aio-lint: disable=blocking-call\n"
    )
    findings = lint.audit_suppressions([str(tmp_path)])
    assert [f.rule for f in findings] == [lint.RULE_STALE]


def test_live_suppression_not_flagged(tmp_path):
    (tmp_path / "m.py").write_text(
        textwrap.dedent(
            """
            import time

            async def f():
                time.sleep(1)  # aio-lint: disable=blocking-call
            """
        )
    )
    assert lint.audit_suppressions([str(tmp_path)]) == []


def test_suppression_syntax_in_string_not_flagged(tmp_path):
    # Docstrings and message strings mention the waiver syntax without
    # being waivers; only genuine comment tokens are audited.
    (tmp_path / "m.py").write_text(
        'HELP = "waive with # aio-lint: disable=blocking-call"\n'
    )
    assert lint.audit_suppressions([str(tmp_path)]) == []


def test_stale_telemetry_allow_flagged(tmp_path):
    private = tmp_path / "_private"
    private.mkdir()
    (private / "m.py").write_text(
        "y = 2  # telemetry: allow-adhoc-stats\n"
    )
    findings = lint.audit_suppressions([str(tmp_path)])
    assert [f.rule for f in findings] == [lint.RULE_STALE]


# ---------------------------------------------------------------------------
# rpc_check: wire-native-drift
# ---------------------------------------------------------------------------


def _cc_fixture(tmp_path, markers):
    cc = tmp_path / "fastpath.cc"
    cc.write_text("// codec\n" + "\n".join(markers) + "\n")
    return str(cc)


def _native_markers():
    """The markers matching the live wire.NATIVE_WIRE_SCHEMAS registry."""
    from ray_tpu_torch._private import wire

    return [
        f"// NATIVE_WIRE_SCHEMA: {m} v{v} fields={','.join(fields)}"
        for m, (v, fields) in sorted(wire.NATIVE_WIRE_SCHEMAS.items())
    ]


def test_native_drift_clean_registry_negative(tmp_path):
    cc = _cc_fixture(tmp_path, _native_markers())
    assert rpc_check._check_native_wire_drift(cc_path=cc) == []


def test_native_drift_field_mutation_positive(tmp_path):
    """Mutating a natively packed schema's field list without touching the
    C marker must fail lint — simulated by mutating the marker instead."""
    markers = [
        m.replace("dirty,lease_id", "dirty,lease_id,renamed_field")
        for m in _native_markers()
    ]
    findings = rpc_check._check_native_wire_drift(
        cc_path=_cc_fixture(tmp_path, markers)
    )
    assert any(
        f.rule == rpc_check.RULE_NATIVE and "ReturnWorker" in f.message
        for f in findings
    )


def test_native_drift_version_skew_positive(tmp_path):
    markers = [
        m.replace("RequestWorkerLease v1", "RequestWorkerLease v2")
        for m in _native_markers()
    ]
    findings = rpc_check._check_native_wire_drift(
        cc_path=_cc_fixture(tmp_path, markers)
    )
    assert any(
        f.rule == rpc_check.RULE_NATIVE and "version skew" in f.message
        for f in findings
    )


def test_native_drift_missing_marker_positive(tmp_path):
    markers = [m for m in _native_markers() if "PubBatch" not in m]
    findings = rpc_check._check_native_wire_drift(
        cc_path=_cc_fixture(tmp_path, markers)
    )
    assert any(
        f.rule == rpc_check.RULE_NATIVE and "PubBatch" in f.message
        for f in findings
    )


def test_native_drift_stale_marker_positive(tmp_path):
    markers = _native_markers() + [
        "// NATIVE_WIRE_SCHEMA: GhostMethod v1 fields=x"
    ]
    findings = rpc_check._check_native_wire_drift(
        cc_path=_cc_fixture(tmp_path, markers)
    )
    assert any(
        f.rule == rpc_check.RULE_NATIVE and "GhostMethod" in f.message
        for f in findings
    )


def test_native_drift_real_tree_is_clean():
    """The committed fastpath.cc markers must match wire.py exactly."""
    assert rpc_check._check_native_wire_drift() == []
