"""Fixtures for the exception-propagation pass (exc_flow).

Each rule gets positive fixtures (must flag) and negative fixtures (the
clean idiom must stay quiet) over throwaway trees whose file layout maps
onto the service topology (``_private/gcs.py`` -> gcs, ...). Fixture
handlers register real ``wire.py`` method names so the schema facts the
rules consume (``errors=``, retry class, dedup key) are the shipped ones.
Also covered: the retry-class cross-checks (SAFE-with-mutation fires,
DEDUP-after-key-check clean), ack-before-persist in both orders, the
``# exc-flow:`` waiver family + stale-suppression audit, both sides of
the ``swallow_cancel`` mutation gate, the shared per-file inventory
cache, and the repo-clean / wire-doc-current acceptance pins.
"""

import os
import textwrap

import pytest

from ray_tpu_torch._private import wire
from ray_tpu_torch.devtools import aio_lint, exc_flow, lint, rpc_check


def _rules(findings):
    return {f.rule for f in findings}


def _tree(tmp_path, sources):
    """Write {relpath: source} under tmp_path; returns check() paths."""
    for name, src in sources.items():
        dest = tmp_path / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(textwrap.dedent(src))
    return [str(tmp_path)]


# ---------------------------------------------------------------------------
# error-wire-undeclared
# ---------------------------------------------------------------------------


def test_undeclared_direct_raise(tmp_path):
    # RegisterNode declares errors=(): a typed raise escaping the handler
    # crosses the wire untyped and must be flagged.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("RegisterNode", self._register_node)

                async def _register_node(self, conn, p):
                    if p["node_id"] in self.dead:
                        raise WorkerCrashedError("node re-registered dead")
                    return {"ok": True}
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_UNDECLARED
    ]
    assert findings and "WorkerCrashedError" in findings[0].message


def test_undeclared_store_write_fact(tmp_path):
    # The replicated-store fact: store.put in a gcs-service file can raise
    # StaleLeaderError, interprocedurally through a persist helper.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("RegisterNode", self._register_node)

                async def _register_node(self, conn, p):
                    self.nodes[p["node_id"]] = p
                    self._persist_nodes()
                    return {"ok": True}

                def _persist_nodes(self):
                    self.store.put("nodes", self.nodes)
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_UNDECLARED
    ]
    assert findings and "StaleLeaderError" in findings[0].message


def test_undeclared_negative_declared_schema(tmp_path):
    # CreateActor declares StaleLeaderError: the same escape is clean.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("CreateActor", self._create_actor)

                async def _create_actor(self, conn, p):
                    self.store.put("actors", p["spec"])
                    return {"ok": True}
            """,
        },
    )
    assert exc_flow.RULE_UNDECLARED not in _rules(exc_flow.check(paths))


def test_undeclared_negative_caught_raise(tmp_path):
    # A raise caught by a matching clause (not re-raised) does not escape.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("RegisterNode", self._register_node)

                async def _register_node(self, conn, p):
                    try:
                        self._validate(p)
                    except ObjectLostError:
                        return {"ok": False}
                    return {"ok": True}

                def _validate(self, p):
                    raise ObjectLostError(p["node_id"])
            """,
        },
    )
    assert exc_flow.RULE_UNDECLARED not in _rules(exc_flow.check(paths))


# ---------------------------------------------------------------------------
# swallowed-control-error
# ---------------------------------------------------------------------------


def test_swallow_cancelled_bare_except(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/worker_main.py": """
            class Worker:
                async def teardown_guard(self):
                    try:
                        await self.drain()
                    except BaseException:
                        return None
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_SWALLOW
    ]
    assert findings and "CancelledError" in findings[0].message


def test_swallow_negative_except_exception_misses_cancel(tmp_path):
    # Python >= 3.8: CancelledError subclasses BaseException, so `except
    # Exception` around an await swallows nothing control-flow.
    paths = _tree(
        tmp_path,
        {
            "_private/worker_main.py": """
            class Worker:
                async def teardown_guard(self):
                    try:
                        await self.drain()
                    except Exception:
                        return None
            """,
        },
    )
    assert exc_flow.RULE_SWALLOW not in _rules(exc_flow.check(paths))


def test_swallow_negative_reraise(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/worker_main.py": """
            class Worker:
                async def teardown_guard(self):
                    try:
                        await self.drain()
                    except BaseException:
                        self.log()
                        raise
            """,
        },
    )
    assert exc_flow.RULE_SWALLOW not in _rules(exc_flow.check(paths))


def test_swallow_typed_flow_on_handler_path(tmp_path):
    # CreateActor declares StaleLeaderError, so the nested RPC can re-raise
    # it; the broad except on the handler path eats the fencing signal.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("RegisterWorker", self._register_worker)

                async def _register_worker(self, conn, p):
                    try:
                        await self.gcs.call("CreateActor", {"spec": p})
                    except Exception:
                        pass
                    return {"ok": True}
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_SWALLOW
    ]
    assert findings and "StaleLeaderError" in findings[0].message


def test_swallow_negative_dedicated_clause_first(tmp_path):
    # An earlier dedicated clause that re-raises the control error makes
    # the trailing broad clause legitimate.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("RegisterWorker", self._register_worker)

                async def _register_worker(self, conn, p):
                    try:
                        await self.gcs.call("CreateActor", {"spec": p})
                    except StaleLeaderError:
                        raise
                    except Exception:
                        pass
                    return {"ok": True}
            """,
        },
    )
    assert exc_flow.RULE_SWALLOW not in _rules(exc_flow.check(paths))


# ---------------------------------------------------------------------------
# retry-unsafe-mutation: retry-class cross-checks
# ---------------------------------------------------------------------------


def test_retry_safe_with_list_append_fires(tmp_path):
    # ObjSeal is RETRY_SAFE; an append in a closure helper double-applies
    # on a lost-reply retry.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ObjSeal", self._obj_seal)

                async def _obj_seal(self, conn, p):
                    self._log_seal(p["oid"])
                    return {"ok": True}

                def _log_seal(self, oid):
                    self.seal_log.append(oid)
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_RETRY
    ]
    assert findings and "seal_log.append" in findings[0].message


def test_retry_safe_counter_increment_fires(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ObjSeal", self._obj_seal)

                async def _obj_seal(self, conn, p):
                    self.sealed_count += 1
                    return {"ok": True}
            """,
        },
    )
    assert exc_flow.RULE_RETRY in _rules(exc_flow.check(paths))


def test_retry_safe_negative_keyed_and_idempotent(tmp_path):
    # Keyed dict writes, set.add, and observability counters are all
    # idempotent or exempt under re-delivery.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ObjSeal", self._obj_seal)

                async def _obj_seal(self, conn, p):
                    self.sealed[p["oid"]] = True
                    self.seen.add(p["oid"])
                    self.stats["seals"] += 1
                    return {"ok": True}
            """,
        },
    )
    assert exc_flow.RULE_RETRY not in _rules(exc_flow.check(paths))


def test_retry_dedup_mutation_before_key_check_fires(tmp_path):
    # RequestWorkerLease is RETRY_DEDUP on lease_id: state mutated before
    # the first read of the dedup key double-applies on re-delivery.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("RequestWorkerLease", self._lease)

                async def _lease(self, conn, p):
                    self.grant_audit.append(p)
                    lease_id = p["lease_id"]
                    if lease_id in self.ledger:
                        return self.ledger[lease_id]
                    return {"granted": True}
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_RETRY
    ]
    assert findings and "lease_id" in findings[0].message


def test_retry_dedup_negative_mutation_after_key_check(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("RequestWorkerLease", self._lease)

                async def _lease(self, conn, p):
                    lease_id = p["lease_id"]
                    if lease_id in self.ledger:
                        return self.ledger[lease_id]
                    self.grant_audit.append(p)
                    return {"granted": True}
            """,
        },
    )
    assert exc_flow.RULE_RETRY not in _rules(exc_flow.check(paths))


# ---------------------------------------------------------------------------
# ack-before-persist, both orders
# ---------------------------------------------------------------------------


def test_ack_before_persist_fires(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("KVPut", self._kv_put)

                async def _kv_put(self, conn, p):
                    self.kv[p["key"]] = p["value"]
                    return {"ok": True}

                def _persist_kv(self):
                    self.store.put("kv", self.kv)
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_ACK
    ]
    assert findings and "kv" in findings[0].message


def test_persist_before_ack_clean(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("KVPut", self._kv_put)

                async def _kv_put(self, conn, p):
                    self.kv[p["key"]] = p["value"]
                    self._persist_kv()
                    return {"ok": True}

                def _persist_kv(self):
                    self.store.put("kv", self.kv)
            """,
        },
    )
    assert exc_flow.RULE_ACK not in _rules(exc_flow.check(paths))


def test_waiter_ack_before_persist_fires(tmp_path):
    # fut.set_result is externally visible the moment it runs — it counts
    # as an ack even in a non-handler helper (the _fail_actor shape).
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                def _fail(self, actor, fut):
                    actor.state = "DEAD"
                    fut.set_result({"actor": actor.actor_id})
                    self._persist_actor(actor)
            """,
        },
    )
    findings = [
        f for f in exc_flow.check(paths) if f.rule == exc_flow.RULE_ACK
    ]
    assert findings and "set_result" in findings[0].message


def test_helper_return_is_not_an_ack(tmp_path):
    # A non-handler helper returning a value to the scheduler loop is not
    # a wire reply (the _try_place_actor shape).
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            class Gcs:
                async def _try_place(self, actor, node):
                    actor.node_id = node.node_id
                    return True
            """,
        },
    )
    assert exc_flow.RULE_ACK not in _rules(exc_flow.check(paths))


# ---------------------------------------------------------------------------
# suppression + the stale-suppression audit for the exc-flow family
# ---------------------------------------------------------------------------


def test_suppression_masks_finding(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ObjSeal", self._obj_seal)

                async def _obj_seal(self, conn, p):
                    # guarded upstream by a keyed membership check
                    self.seal_log.append(p["oid"])  # exc-flow: disable=retry-unsafe-mutation
                    return {"ok": True}
            """,
        },
    )
    assert exc_flow.RULE_RETRY not in _rules(exc_flow.check(paths))
    raw = exc_flow.check(paths, apply_suppressions=False)
    assert exc_flow.RULE_RETRY in _rules(raw)
    # ...and the audit sees the waiver as live, not stale.
    audit = lint.audit_suppressions(paths)
    assert [f for f in audit if f.rule == lint.RULE_STALE] == []


def test_stale_exc_flow_suppression_flagged(tmp_path):
    (tmp_path / "m.py").write_text(
        "x = 1  # exc-flow: disable=ack-before-persist\n"
    )
    findings = lint.audit_suppressions([str(tmp_path)])
    assert [f.rule for f in findings] == [lint.RULE_STALE]


# ---------------------------------------------------------------------------
# mutation gate, both sides
# ---------------------------------------------------------------------------


def test_mutation_seeds_detectable_swallow():
    findings = exc_flow.check(mutate="swallow_cancel")
    swallows = [f for f in findings if f.rule == exc_flow.RULE_SWALLOW]
    assert swallows, "seeded CancelledError swallow must be detected"
    assert any("<mutant>" in f.path for f in swallows)


def test_mutation_gate_cli_passes_on_mutant(capsys):
    assert (
        exc_flow.main(["--mutate", "swallow_cancel", "--expect-violation"])
        == 0
    )
    assert "mutation detected" in capsys.readouterr().out


def test_expect_violation_fails_on_clean_tree(capsys):
    # The other side of the gate: with no seeded defect the clean tree
    # must NOT satisfy --expect-violation (a toothless pass would).
    assert exc_flow.main(["--expect-violation"]) == 1


# ---------------------------------------------------------------------------
# wire.py errors= declarations
# ---------------------------------------------------------------------------


def test_unknown_error_name_rejected():
    with pytest.raises(ValueError, match="unknown error name"):
        wire._s(["k"], errors=("NoSuchError",))


def test_every_schema_declares_within_taxonomy():
    for method, schema in wire.SCHEMAS.items():
        assert set(schema.errors) <= wire.KNOWN_ERRORS, method


def test_durable_gcs_writers_declare_stale_leader():
    # The write-through methods whose handlers reach the replicated store.
    for method in (
        "CreateActor",
        "ReportActorReady",
        "ReportWorkerDied",
        "KillActor",
        "KVPut",
    ):
        assert "StaleLeaderError" in wire.SCHEMAS[method].errors, method


# ---------------------------------------------------------------------------
# shared per-file inventory cache + lint-gate integration
# ---------------------------------------------------------------------------


def test_inventory_cache_hits_and_invalidates(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("async def f(conn):\n    await conn.call('KVGet', {})\n")
    t1, f1 = rpc_check._scan_file(str(p))
    t2, f2 = rpc_check._scan_file(str(p))
    assert t1 is t2 and f1 is f2  # cache hit: same parse, same fragment
    p.write_text("async def f(conn):\n    await conn.call('KVPut', {})\n")
    os.utime(p, (1, 1))  # force a distinct mtime signature
    t3, f3 = rpc_check._scan_file(str(p))
    assert t3 is not t1
    assert {c.method for c in f3.calls} == {"KVPut"}


def test_lint_gate_times_exc_flow(tmp_path):
    (tmp_path / "m.py").write_text("x = 1\n")
    _findings, timings = lint.run_timed([str(tmp_path)])
    assert "exc-flow" in {name for name, _ in timings}


# ---------------------------------------------------------------------------
# acceptance: the shipped tree and its committed wire doc
# ---------------------------------------------------------------------------


def test_repo_is_exc_flow_clean():
    assert [str(f) for f in exc_flow.check()] == []


def test_repo_wire_doc_is_current():
    root = os.path.dirname(aio_lint._default_root())
    doc = os.path.join(root, "docs", "torch", "wire_protocol.md")
    with open(doc, "r", encoding="utf-8") as fh:
        assert fh.read() == rpc_check.markdown_table() + "\n"


def test_wire_doc_has_errors_column():
    assert "| Errors |" in rpc_check.markdown_table()
