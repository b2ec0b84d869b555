"""Parity of ray_tpu_torch.parallel with ray_tpu.parallel on the CPU: the
mesh spec, make_mesh's layout and batch split, the ZeRO-3 leaf rule, and
ring and Ulysses attention (4 gloo processes) against the reference's
sharded entry points and full attention on the JAX 8-device CPU mesh,
forward and gradients; the ring's one-process loopback schedule against
the gloo ring."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ray_tpu import parallel as ref  # noqa: E402
from ray_tpu_torch.parallel import (  # noqa: E402
    MeshSpec,
    full_attention,
    host_local_device_count,
    ring_attention,
    ring_attention_loopback,
)
from ray_tpu_torch.testing import attention_worker, mesh_worker, run_in_processes  # noqa: E402

# Port against JAX, both f32 on the CPU, inputs and outputs O(1): the two
# sum the same products in other orders (measured <= 2e-6).
ATOL = 1e-5
# The loopback against the gloo ring: the same hops, the same arithmetic.
LOOPBACK_ATOL = 1e-6

B, T, H, D = 4, 32, 4, 16
CASES = [  # (fn, axes of 4 ranks, causal, impl)
    ("ring", {"sequence": 4}, False, "plain"),
    ("ring", {"sequence": 4}, True, "plain"),
    ("ring", {"data": 2, "sequence": 2}, True, "plain"),
    ("ring", {"sequence": 4}, True, "kernel"),
    ("ring", {"sequence": 2, "tensor": 2}, False, "kernel"),
    ("ring", {"tensor": 2, "sequence": 2}, True, "kernel"),
    ("ulysses", {"sequence": 4}, False, "auto"),
    ("ulysses", {"sequence": 4}, True, "auto"),
    ("ulysses", {"data": 2, "sequence": 2}, True, "kernel"),
]
IDS = [f"{fn}-{'x'.join(f'{k}{v}' for k, v in axes.items())}-{'causal' if c else 'full'}-{impl}"
       for fn, axes, c, impl in CASES]
RING = [i for i, case in enumerate(CASES) if case[0] == "ring"]


def _inputs(i):
    rng = np.random.RandomState(i)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))  # q, k, v, g


@pytest.fixture(scope="module")
def port_attention():
    """Every case through the port on 4 gloo ranks, in one run."""
    cases = [(fn, axes, *_inputs(i), causal, impl)
             for i, (fn, axes, causal, impl) in enumerate(CASES)]
    return run_in_processes(attention_worker, 4, cases, timeout=240)


@functools.lru_cache(maxsize=None)
def _jax_fwd_bwd(fn: str, causal: bool):
    """jit of (q, k, v, g) -> (out, dq, dk, dv) of the reference's `fn`
    ('ring' or 'ulysses' sharded on a {data: 2, sequence: 4} mesh, or
    'full'), one compile per (fn, causal)."""
    jmesh = ref.make_mesh({"data": 2, "sequence": 4})
    f = {"ring": lambda q, k, v: ref.ring_attention_sharded(q, k, v, jmesh, causal=causal),
         "ulysses": lambda q, k, v: ref.ulysses_attention_sharded(q, k, v, jmesh, causal=causal),
         "full": lambda q, k, v: ref.full_attention(q, k, v, causal=causal)}[fn]

    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(g))

    return jax.jit(fwd_bwd)


@pytest.mark.timeout(60)
def test_mesh_spec_infer():
    assert MeshSpec({"data": -1, "tensor": 2}).resolve(8) == {"data": 4, "tensor": 2}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("axes", [{"data": 3, "tensor": 2}, {"data": -1, "fsdp": -1},
                                  {"data": -1, "tensor": 3}])
def test_mesh_spec_rejects_as_reference(axes):
    with pytest.raises(ValueError):
        ref.MeshSpec(dict(axes)).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dict(axes)).resolve(8)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("axes", [{"data": -1, "tensor": 2}, {"sequence": 2, "fsdp": -1},
                                  {"data": 8}, {}])
def test_mesh_spec_matches_reference(axes):
    n = 8 if axes else 1
    assert MeshSpec(dict(axes)).resolve(n) == ref.MeshSpec(dict(axes)).resolve(n)


MESHES = [{"tensor": 2, "data": 2}, {"sequence": 2, "fsdp": 2}, {"fsdp": 4}]
LEAVES = [(128, 64), (64, 128), (3, 8), (5,), (), (8, 8), (12, 16), (2, 6, 4)]


@pytest.fixture(scope="module")
def port_meshes():
    return run_in_processes(mesh_worker, 4, MESHES, LEAVES, timeout=180)


@pytest.mark.timeout(200)
@pytest.mark.parametrize("i", range(len(MESHES)))
def test_make_mesh_layout_and_batch_slice(port_meshes, i):
    """Canonical axis order and each rank's batch block equal the
    reference's: the device at a mesh coordinate holds the same block of a
    [B, T] batch under P(("data", "fsdp"), "sequence")."""
    got = port_meshes[i]
    jmesh = ref.make_mesh(MESHES[i], devices=jax.devices()[:4])
    assert got["names"] == tuple(jmesh.axis_names)
    assert got["shape"] == tuple(jmesh.devices.shape)
    names = jmesh.axis_names
    batch = tuple(a for a in ("data", "fsdp") if a in names) or None
    seq = "sequence" if "sequence" in names else None
    x = np.arange(64).reshape(8, 8)
    placed = jax.device_put(x, NamedSharding(jmesh, P(batch, seq)))
    for coord, block in got["slices"]:
        device = jmesh.devices[tuple(coord)]
        shard = next(s for s in placed.addressable_shards if s.device == device)
        np.testing.assert_array_equal(np.asarray(block), np.asarray(shard.data))


@pytest.mark.timeout(200)
def test_fsdp_sharding_for_leaf_matches_reference(port_meshes):
    for axes, got in zip(MESHES, port_meshes):
        jmesh = ref.make_mesh(axes, devices=jax.devices()[:4])
        for shape, dim in zip(LEAVES, got["fsdp_dims"]):
            spec = tuple(ref.fsdp_sharding_for_leaf(jmesh, np.zeros(shape, np.float32)).spec)
            want = spec.index("fsdp") if "fsdp" in spec else None
            assert dim == want, (axes, shape, dim, spec)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_attention_matches_reference(port_attention, i):
    """Output and gradients of sum(out * g), port on 4 gloo ranks, against
    the reference's sharded entry point on a {data: 2, sequence: 4} JAX
    mesh and against its full attention."""
    fn, _, causal, _ = CASES[i]
    want_sharded, want_full = ([np.asarray(x) for x in _jax_fwd_bwd(f, causal)(*_inputs(i))]
                               for f in (fn, "full"))
    for name, got, a, b in zip(("out", "dq", "dk", "dv"), port_attention[i], want_sharded, want_full):
        np.testing.assert_allclose(got, a, atol=ATOL, rtol=0, err_msg=f"{name} vs sharded")
        np.testing.assert_allclose(got, b, atol=ATOL, rtol=0, err_msg=f"{name} vs full")


@pytest.mark.timeout(240)
@pytest.mark.parametrize("i", RING, ids=[IDS[i] for i in RING])
def test_ring_loopback_matches_gloo_ring(port_attention, i):
    """The ring's schedule run in one process (shards by indexing) gives
    what the gloo ring gives, output and gradients."""
    _, axes, causal, impl = CASES[i]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in _inputs(i)[:3]]
    out = ring_attention_loopback(*leaves, axes["sequence"], causal=causal, impl=impl)
    got = [out, *torch.autograd.grad(out, leaves, torch.from_numpy(_inputs(i)[3]))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, port_attention[i]):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=LOOPBACK_ATOL, rtol=0, err_msg=name)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_ring_loopback_matches_full_attention(causal, impl):
    """Both routes of the hop math against plain full attention, S = 4."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(99))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention_loopback(*leaves, 4, causal=causal, impl=impl)
    got = [out, *torch.autograd.grad(out, leaves, g)]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = full_attention(*leaves, causal=causal)
    want = [out, *torch.autograd.grad(out, leaves, g)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.timeout(60)
def test_ring_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="repeat kv heads"):
        ring_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, q, q, impl="xla")
    with pytest.raises(ValueError, match="shards"):
        ring_attention_loopback(q, q, q, 3)


@pytest.mark.timeout(60)
def test_host_local_device_count():
    """One device per process on the CPU; the card's count, or a refusal
    without a card, by default."""
    assert host_local_device_count("cpu") == 1
    if torch.cuda.is_available():
        assert host_local_device_count() == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            host_local_device_count()


@pytest.mark.timeout(120)
def test_port_parallel_and_dryrun_import_no_jax():
    code = ("import sys, ray_tpu_torch.parallel, ray_tpu_torch.dryrun, ray_tpu_torch.testing; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'ray_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]", out.stdout
