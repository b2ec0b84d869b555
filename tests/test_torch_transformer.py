"""Parity of ray_tpu_torch.models.transformer with ray_tpu.models.transformer
on the CPU, at a tiny size with GQA: logits, loss and every gradient from
the same weights (carried over by params_from_jax), the ported causality
test, the flop accounting, and the port's own rules: its import pulls in no
jax and no ray_tpu module, and its entry points never fall back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as jax_tr  # noqa: E402
from ray_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as tr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
# f32 on both sides through two blocks and the LM head; the frameworks sum in
# different orders, so values agree to a few f32 ulps of their scale.
ATOL, RTOL = 2e-5, 1e-4


def _configs(remat=False, impl="torch"):
    jcfg = jax_tr.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="xla", remat=remat)
    tcfg = tr.TransformerConfig(**TINY, dtype=torch.float32, attention_impl=impl, remat=remat)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.array, jax_tr.transformer_init(jax.random.PRNGKey(seed), jcfg))


def _tokens(shape, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path], err_msg=str(path), **tol)


def test_params_from_jax_round_trips():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    model = params_from_jax(params, tcfg, device="cpu")
    _assert_trees_close(params_to_numpy(model), params, rtol=0, atol=0)
    with pytest.raises(ValueError):
        params_from_jax(params, dataclasses.replace(tcfg, n_layers=3), device="cpu")


@pytest.mark.parametrize("impl,remat", [("torch", False), ("kernel", True)])
def test_logits_loss_and_grads_match_jax(impl, remat):
    jcfg, tcfg = _configs(remat=remat, impl=impl)
    params = _jax_params(jcfg)
    toks = _tokens((2, 17), jcfg.vocab_size)

    ref_logits = jax_tr.transformer_apply(params, jnp.asarray(toks[:, :-1]), jcfg)
    ref_loss, ref_grads = jax.value_and_grad(jax_tr.transformer_loss)(
        params, {"tokens": jnp.asarray(toks)}, jcfg)

    model = params_from_jax(params, tcfg, device="cpu")
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits = model(t[:, :-1])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=RTOL)
    loss = tr.transformer_loss(model, {"tokens": t})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-6)
    _assert_trees_close(params_to_numpy(model, grads=True),
                        jax.tree.map(np.asarray, ref_grads), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_transformer_causality(impl):
    """Changing a future token must not change past logits (port of
    tests/test_models.py::test_transformer_causality)."""
    jcfg, tcfg = _configs(impl=impl)
    model = params_from_jax(_jax_params(jcfg), tcfg, device="cpu")
    toks = torch.from_numpy(_tokens((1, 16), tcfg.vocab_size)).long()
    toks2 = toks.clone()
    toks2[0, -1] = (toks[0, -1] + 1) % tcfg.vocab_size
    with torch.no_grad():
        a = tr.transformer_apply(model, toks)
        b = tr.transformer_apply(model, toks2)
    np.testing.assert_allclose(a[0, :-1].numpy(), b[0, :-1].numpy(), atol=1e-5)
    assert (a[0, -1] - b[0, -1]).abs().max() > 1e-4


def test_rope_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 9, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)) + 3
    ref = jax_tr._rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = tr._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12, remat=True),  # the bench cell
    dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2),
    dict(vocab_size=1000, d_model=200, n_layers=3, n_heads=5, d_ff=333),
])
def test_flop_accounting_and_ff_dim_match_jax(kw):
    jcfg, tcfg = jax_tr.TransformerConfig(**kw), tr.TransformerConfig(**kw)
    assert tcfg.ff_dim == jcfg.ff_dim and tcfg.head_dim == jcfg.head_dim
    for seq in (64, 1024):
        assert tr.flops_per_token(tcfg, seq) == jax_tr.flops_per_token(jcfg, seq)
        for remat in (None, False, True):
            assert (tr.hardware_flops_per_token(tcfg, seq, remat)
                    == jax_tr.hardware_flops_per_token(jcfg, seq, remat))


def test_import_leaves_jax_and_ray_tpu_out():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.convert, ray_tpu_torch.ops._build\n"
        "import ray_tpu_torch.models.transformer, ray_tpu_torch.ops.flash_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_port_sources_import_no_jax_or_ray_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "optax", "ray_tpu"), (path, mod)


def test_entry_points_without_device_raise_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    for call in (lambda: tr.transformer_init(tcfg),
                 lambda: tr.Transformer(tcfg),
                 lambda: tr.make_train_step(tcfg),
                 lambda: params_from_jax(params, tcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
