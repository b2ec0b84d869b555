"""Test helpers for the port (counterpart of ray_tpu/testing.py, whose JAX
CPU-mesh helpers have no place here).

Test files import the fixtures they use:

    from ray_tpu_torch.testing import torch_cluster  # noqa: F401

Tests that need a CUDA card carry the `cuda` marker (pyproject.toml) and
decide inside the test whether there is one, never while the module is
imported.

A CPU mesh of n devices is n processes, one device each: `run_in_processes`
runs a function in n spawned gloo processes and returns rank 0's result;
the tests and `ray_tpu_torch.dryrun` share it, and the workers the tests
run through it live here, so the spawned processes import neither jax nor
the test files.
"""

from __future__ import annotations

import datetime
import queue as queue_lib
import time

import numpy as np
import pytest


@pytest.fixture
def torch_cluster():
    """Fresh single-node port cluster per test: 4 CPUs and the GPUs the
    node has."""
    import ray_tpu_torch

    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------ gloo processes

def _child(fn, inbox, rank: int, world: int, port: int, results) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        args = inbox.get(timeout=120)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=datetime.timedelta(seconds=120))
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))


def run_in_processes(fn, n: int, *args, timeout: float = 300.0):
    """fn(*args) in n spawned processes joined in one gloo process group
    (rank r of n; the rendezvous store listens here, on a port the OS
    picks); returns rank 0's result. Raises with the traceback of the first
    rank that fails, or when the ranks do not finish within `timeout`
    seconds; every process is ended before it returns. `fn` must be
    importable by name (module level)."""
    import multiprocessing

    import torch.distributed as dist

    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    # The arguments go through a queue, whose feeder thread does not block
    # start(): arguments larger than a pipe's buffer, passed to Process,
    # would hold each start() until that child has imported what fn needs.
    inbox, results = ctx.Queue(), ctx.Queue()
    for _ in range(n):
        inbox.put(args)
    procs = [ctx.Process(target=_child, args=(fn, inbox, r, n, store.port, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    done = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < n:
            try:
                rank, err, out = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0]}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish in {timeout} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            done[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        # Arguments no child took stay in the inbox's pipe: do not let the
        # queue's feeder thread hold this process's exit on them.
        inbox.cancel_join_thread()
    return done[0]


# ------------------------------------------------------- workers of the tests

def attention_worker(cases):
    """Each case (fn, axes, q, k, v, g, causal, impl): `fn` ('ring' or
    'ulysses') on a CPU mesh of `axes` from the global numpy inputs, the
    loss sum(out * g) over this rank's block. Returns, per case, the global
    output and the gradients of q, k, v, summed over the ranks (every
    axis of `axes` must split the inputs, so each block has one owner)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh, shard_of
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    out = []
    for fn, axes, q, k, v, g, causal, impl in cases:
        mesh = make_mesh(axes, device="cpu")
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        if fn == "ring":
            o = ring_attention_sharded(*leaves, mesh, causal=causal, impl=impl)
            dims = {0: ("data", "fsdp"), 1: ("sequence",), 2: ("tensor",)}
        else:
            o = ulysses_attention_sharded(*leaves, mesh, causal=causal, impl=impl)
            dims = {0: ("data", "fsdp"), 1: ("sequence",)}
        grads = torch.autograd.grad(o, leaves, shard_of(mesh, torch.from_numpy(g), dims))
        whole = torch.zeros(q.shape)
        shard_of(mesh, whole, dims).copy_(o.detach())
        results = [whole, *grads]
        for t in results:
            dist.all_reduce(t)
        out.append([t.numpy() for t in results])
    return out


def sharded_steps_worker(runs, tree, tokens, steps: int, lr: float, wd: float,
                         record_at=(1, 3)):
    """For each (axes, cfg_kwargs) of `runs`: make_train_step on a CPU mesh
    of `axes` from the JAX-shaped param tree `tree` and the global batch
    `tokens` ([B, T+1] numpy), AdamW(lr, weight_decay=wd). Returns per run
    ({parameter name: this rank's shard shape} as placed, and per step
    (loss, grad_norm) and, at the steps in `record_at`, every parameter
    whole)."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.convert import params_from_jax, params_to_numpy
    from ray_tpu_torch.models import transformer as tr
    from ray_tpu_torch.parallel import make_mesh

    out = []
    for axes, cfg_kwargs in runs:
        cfg = tr.TransformerConfig(**cfg_kwargs)
        mesh = make_mesh(axes, device="cpu")
        init_state, step = tr.make_train_step(
            cfg, optimizer=lambda p: tr.adamw(p, lr=lr, weight_decay=wd), mesh=mesh)
        state = init_state(model=params_from_jax(tree, cfg, device="cpu"))
        shapes = {n: tuple((p.to_local() if isinstance(p, DTensor) else p).shape)
                  for n, p in state["model"].named_parameters()}
        batch = {"tokens": torch.from_numpy(np.asarray(tokens)).long()}
        trace = []
        for i in range(1, steps + 1):
            state, m = step(state, batch)
            params = params_to_numpy(state["model"]) if i in record_at else None
            trace.append((float(m["loss"]), float(m["grad_norm"]), params))
        out.append((shapes, trace))
    return out


def mesh_worker(axes_list, shapes):
    """For each axes of `axes_list`, make_mesh(axes) on the CPU: its dim
    names and sizes, every rank's (mesh coordinate, batch_slice of a global
    [8, 8] arange as a list), and fsdp_sharding_for_leaf's dim for each
    shape of `shapes`."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import batch_slice, fsdp_sharding_for_leaf, make_mesh

    out = []
    for axes in axes_list:
        mesh = make_mesh(axes, device="cpu")
        block = batch_slice(mesh, torch.arange(64).reshape(8, 8))
        slices = [None] * dist.get_world_size()
        dist.all_gather_object(slices, (mesh.get_coordinate(), block.tolist()))
        out.append({"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
                    "slices": slices,
                    "fsdp_dims": [fsdp_sharding_for_leaf(mesh, torch.empty(s)) for s in shapes]})
    return out
