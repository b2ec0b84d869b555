"""Repo-specific static analysis for the asyncio control plane.

Five passes (run the static ones via ``python -m ray_tpu_torch.devtools.lint``):

- :mod:`ray_tpu_torch.devtools.aio_lint` — AST linter for asyncio hazards
  (blocking calls in ``async def``, raw ``create_task`` outside
  ``rpc.spawn()``, unawaited coroutines, await-interleaving TOCTOU).
- :mod:`ray_tpu_torch.devtools.rpc_check` — wire-protocol cross-checker for the
  msgpack RPC layer (call-site method names vs. handler registries, payload
  key drift against the :mod:`ray_tpu_torch._private.wire` schema registry).
- :mod:`ray_tpu_torch.devtools.lifecycle` — paired-resource dataflow pass over an
  acquire/release registry (pull quota, lease pool, store pins, object
  holds, grant ledger, resource ledger): leaks on exception / early return,
  releases not protected by ``finally`` across ``await`` cancellation
  points, double release.
- :mod:`ray_tpu_torch.devtools.protocols` — protocol FSM checker: the actor,
  placement-group, node, and lease-ledger state machines as data; every
  static ``.state = X`` assignment is verified as a legal edge, the spec is
  cross-checked against the chaos convergence invariants, and
  ``docs/protocols.md`` is generated from it (``make protocols``).
- :mod:`ray_tpu_torch._private.aiocheck` — runtime interleaving probe enabled by
  ``RAY_TPU_AIOCHECK=1``; validates the static pass dynamically in tests.

Every static rule supports inline suppression on the flagged line or the
line directly above it: ``# aio-lint: disable=<rule>[,...]`` for
aio_lint/rpc_check, ``# lifecycle: disable=<rule>`` and
``# protocol: disable=<rule>`` for the lifecycle/protocol passes. Rule IDs
and examples: ``docs/static_analysis.md``.
"""
