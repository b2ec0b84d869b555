"""The port's chaos and devtools against the JAX package's, on the same
inputs: every scenario's fault schedule and nemesis plan for seeds 0-19,
byte for byte; the port's static passes run over the reference tree
ray_tpu/ give the reference's findings, wire-protocol table, blocking graph
and protocol document (the package's own name aside), unmutated and under
each seeded mutation; and both explorers enumerate the same schedules with
the same verdicts, on the toy scenario (DPOR and naive) and on the
control-plane scenarios."""

import asyncio
import os

import pytest

import ray_tpu
import ray_tpu.chaos.runner as ref_runner
import ray_tpu.chaos.scenarios_explore as ref_scenarios
import ray_tpu.chaos.schedule as ref_schedule
import ray_tpu.devtools.explore as ref_explore
import ray_tpu_torch.chaos.runner as port_runner
import ray_tpu_torch.chaos.scenarios_explore as port_scenarios
import ray_tpu_torch.chaos.schedule as port_schedule
import ray_tpu_torch.devtools.explore as port_explore
from ray_tpu.devtools import aio_lint as ref_aio_lint
from ray_tpu.devtools import exc_flow as ref_exc_flow
from ray_tpu.devtools import lifecycle as ref_lifecycle
from ray_tpu.devtools import lint as ref_lint
from ray_tpu.devtools import protocols as ref_protocols
from ray_tpu.devtools import rpc_check as ref_rpc_check
from ray_tpu.devtools import rpc_flow as ref_rpc_flow
from ray_tpu.devtools import telemetry_lint as ref_telemetry_lint
from ray_tpu_torch.devtools import aio_lint, exc_flow, lifecycle, lint, protocols, rpc_check
from ray_tpu_torch.devtools import rpc_flow, telemetry_lint

REF_TREE = os.path.dirname(os.path.abspath(ray_tpu.__file__))
SEEDS = range(20)


def _as_ref(text: str) -> str:
    """The port's output with its package's name put back to the reference's."""
    return text.replace("ray_tpu_torch", "ray_tpu")


# -- chaos schedules -----------------------------------------------------------


def test_both_packages_catalog_the_same_scenarios_and_suites():
    assert list(port_runner.SCENARIOS) == list(ref_runner.SCENARIOS)
    assert port_runner.SUITES == ref_runner.SUITES


@pytest.mark.parametrize("name", sorted(ref_runner.SCENARIOS))
def test_schedules_and_plans_are_byte_identical(name):
    ref, port = ref_runner.SCENARIOS[name], port_runner.SCENARIOS[name]
    assert port.steps == ref.steps and list(port.nemesis) == list(ref.nemesis)
    for seed in SEEDS:
        want = ref_schedule.FaultSchedule(seed, ref.specs)
        got = port_schedule.FaultSchedule(seed, port.specs)
        assert got.to_bytes() == want.to_bytes(), (name, seed)
        assert got.digest() == want.digest(), (name, seed)
        want_plan = ref_schedule.NemesisPlan(seed, ref.nemesis, ref.steps)
        got_plan = port_schedule.NemesisPlan(seed, port.nemesis, port.steps)
        assert got_plan.points == want_plan.points, (name, seed)
        assert got_plan.to_wire() == want_plan.to_wire(), (name, seed)


# -- static passes over the reference tree -------------------------------------

# Each pass of the lint gate as (reference's, port's), over the given paths.
PASSES = {
    "aio-lint": (lambda p: list(ref_aio_lint.lint_paths(p)),
                 lambda p: list(aio_lint.lint_paths(p))),
    "rpc-check": (ref_rpc_check.check, rpc_check.check),
    "rpc-flow": (ref_rpc_flow.check, rpc_flow.check),
    "exc-flow": (ref_exc_flow.check, exc_flow.check),
    "lifecycle": (ref_lifecycle.lint_paths, lifecycle.lint_paths),
    "protocols": (ref_protocols.check, protocols.check),
    "telemetry-lint": (ref_telemetry_lint.lint_paths, telemetry_lint.lint_paths),
    "suppression-audit": (ref_lint.audit_suppressions, lint.audit_suppressions),
}


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", list(PASSES))
def test_port_pass_over_reference_tree_gives_reference_findings(name):
    ref_pass, port_pass = PASSES[name]
    want = [str(f) for f in ref_pass([REF_TREE])]
    got = [_as_ref(str(f)) for f in port_pass([REF_TREE])]
    assert got == want


@pytest.mark.parametrize("mutate, ref_check, port_check", [
    ("back_call", ref_rpc_flow.check, rpc_flow.check),
    ("swallow_cancel", ref_exc_flow.check, exc_flow.check),
], ids=["rpc_flow-back_call", "exc_flow-swallow_cancel"])
def test_mutation_gates_fire_alike_over_reference_tree(mutate, ref_check, port_check):
    want = [str(f) for f in ref_check([REF_TREE], mutate=mutate)]
    got = [_as_ref(str(f)) for f in port_check([REF_TREE], mutate=mutate)]
    assert want and got == want


def test_port_wire_table_over_reference_tree_is_the_reference_table():
    assert _as_ref(rpc_check.markdown_table([REF_TREE])) == \
        ref_rpc_check.markdown_table([REF_TREE])


def test_port_blocking_graph_over_reference_tree_is_the_reference_graph():
    assert _as_ref(rpc_flow.markdown([REF_TREE])) == ref_rpc_flow.markdown([REF_TREE])


def test_port_protocol_document_is_the_reference_document():
    assert _as_ref(protocols.markdown()) == ref_protocols.markdown()


# -- the explorer --------------------------------------------------------------


async def _toy_writer_a(shared):
    shared["a"] = shared.get("a", 0) + 1


async def _toy_writer_b(shared):
    shared["b"] = shared.get("b", 0) + 1


TOY_FOOTPRINTS = {
    "_toy_writer_a": {"reads": set(), "writes": {"self.a"}},
    "_toy_writer_b": {"reads": set(), "writes": {"self.b"}},
}


class _ToyScenario:
    """Three tasks: two that conflict, one independent of both."""

    def __init__(self, mutations=()):
        self.shared = {}

    async def run(self):
        await asyncio.gather(
            _toy_writer_a(self.shared),
            _toy_writer_b(self.shared),
            _toy_writer_a(self.shared),
        )
        return []

    def cleanup(self):
        pass


def _summary(report):
    return (report.schedules, report.pruned, report.violations, report.complete,
            report.stopped_on_violation, report.digest)


@pytest.mark.parametrize("dpor", [True, False], ids=["dpor", "naive"])
def test_explorers_agree_on_the_toy_scenario(dpor):
    reports = [
        mod.Explorer(_ToyScenario, oracle=mod.IndependenceOracle(TOY_FOOTPRINTS),
                     dpor=dpor).explore("toy", budget=10000)
        for mod in (ref_explore, port_explore)
    ]
    assert reports[0].complete and reports[0].violations == 0
    assert _summary(reports[1]) == _summary(reports[0])


@pytest.mark.parametrize("name, budget, mutations", [
    ("lease_exactly_once", 6000, ()),
    ("lease_exactly_once", 2000, ("double_grant",)),
    ("quorum_election", 2000, ()),
    ("resubscribe_gap", 300, ()),
    ("ha_promotion", 400, ()),
])
def test_explorers_agree_on_control_plane_scenarios(name, budget, mutations):
    """Each package's explorer drives its own raylet, GCS, store and pub/sub
    under the virtual loop; the spaces, the verdicts and the digests match."""
    reports = []
    for mod, scenarios in ((ref_explore, ref_scenarios), (port_explore, port_scenarios)):
        spec = scenarios.SCENARIOS[name]
        ex = mod.Explorer(lambda: spec.factory(mutations=list(mutations)),
                          oracle=mod.IndependenceOracle(mod.repo_footprints()), dpor=True)
        reports.append(ex.explore(name, budget=budget, stop_on_violation=bool(mutations)))
    ref, port = reports
    assert _summary(port) == _summary(ref)
    assert (ref.violations > 0) == bool(mutations)
    if mutations:
        assert port.first_violation.violations == ref.first_violation.violations
