"""Parity of ray_tpu_torch.models.resnet with ray_tpu.models.resnet on the
CPU, in f32, at width 8: depth 18 (basic blocks) and 50 (bottlenecks), each
with the 7x7 stem and the space-to-depth stem. From the same weights
(carried over by resnet_params_from_jax): train-mode logits and running
statistics, eval-mode logits, every parameter's gradient, and at depth 18
the parameters after one and after three SGD-momentum steps of the bench's
step; the ported test of tests/test_models.py, the flop accounting, and the
no-card rule.

Sizes. Each case runs where the reference itself is well conditioned in
f32, measured by tests/resnet_conditioning.py as how far the reference's
own result moves when every pixel moves by one ulp (x * (1 +- 2^-23)):
- depth 18 at 32x32, batch 2, leaves the last stage 1x1, so its batch norms
  take statistics over two values, and the reference's train-mode
  gradients move by 7.7e-4 (worst relative L2); at 64x64 by 8e-6 (1.3e-5
  with the space-to-depth stem);
- depth 50 in train mode moves its logits by 2.1 times the 1e-4 + 1e-4 |x|
  limit at 32x32, batch 2, and by 0.23-0.40 of it at 128x128, batch 4,
  where the port, whose convolutions round differently at each of 53
  layers, ends 0.73-1.15 of that limit from it; so depth 50's train-mode
  logits and statistics are held to 5e-4 + 5e-4 |x|. Its train-mode
  gradients move by 1.5e-2 to 7.7e-2 (batch norm's gradient explosion at
  initialisation, through 16 blocks), so no two f32 implementations agree
  on them, nor on the SGD steps that follow. At depth 50 the gradients are
  taken in eval mode, where the batch norms are fixed affine maps (the
  port agrees with the reference to 3.4e-6 there), and the train-mode
  gradients and steps are held at depth 18, through the same code.
That depth 50's f32 gap is rounding and nothing else: run in float64 on
both sides (the reference's own code, its float32 casts read as float64),
the same cases agree in train-mode logits and statistics to ~2e-13, in
every train-mode gradient to ~3e-12 and after an SGD step to ~1e-12,
where f32 leaves them 1e-4 and 1e-2 apart.
"""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from ray_tpu.models import resnet as jax_resnet  # noqa: E402
from ray_tpu_torch.convert import resnet_params_from_jax, resnet_params_to_numpy  # noqa: E402
from ray_tpu_torch.models import resnet  # noqa: E402

# (depth, space_to_depth, batch, image size)
CASES = [(18, False, 2, 64), (18, True, 2, 64), (50, False, 4, 128), (50, True, 4, 128)]
SMALL = dict(num_classes=10, width=8)
# f32 on both sides; the frameworks sum convolutions and batch statistics
# in different orders, so values agree to a few f32 ulps of their scale.
ATOL = RTOL = 1e-4
# Depth 50's train-mode logits and running statistics (module docstring).
DEEP_TRAIN_TOL = 5e-4
GRAD_REL_L2 = 1e-4
# Parameters after SGD steps (lr 0.1): the gradients' f32 differences,
# scaled by the learning rate.
PARAM_ATOL = 1e-5
# Depth 50 in float64 on both sides (test_depth50_in_f64_agrees_to_f64_rounding):
# logits, statistics and parameters after a step agree to ~2e-13, gradients
# to ~3e-12 (relative L2); the limits leave two orders of magnitude.
F64_TOL = 1e-10
F64_GRAD_REL_L2 = 1e-9


@pytest.fixture(autouse=True)
def _no_onednn():
    """PyTorch 2.13's CPU build corrupts the heap in oneDNN's 1x1 stride-2
    channels_last convolution with 8 input channels (the depth-18 width-8
    projection); its native CPU convolutions compute the same function."""
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


def _configs(depth, s2d):
    jcfg = jax_resnet.ResNetConfig(depth=depth, dtype=jnp.float32, space_to_depth=s2d, **SMALL)
    tcfg = resnet.ResNetConfig(depth=depth, dtype=torch.float32, space_to_depth=s2d, **SMALL)
    return jcfg, tcfg


def _jax_loss_fn(jcfg):
    """The bench's loss (bench.py phase_step): softmax cross entropy on the
    logits, with the updated statistics as aux."""

    def loss_fn(params, images, labels, train):
        logits, new_params = jax_resnet.resnet_apply(params, images, jcfg, train=train)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean(), new_params

    return loss_fn


@pytest.fixture(scope="module", params=CASES,
                ids=[f"depth{d}-s2d{int(s)}" for d, s, _, _ in CASES])
def case(request):
    """The JAX side of one case, computed once: its config pair, weights,
    inputs, train and eval forwards, gradients (train mode at depth 18,
    eval mode at 50) and, at depth 18, the parameters after one and three
    SGD steps."""
    depth, s2d, batch, size = request.param
    jcfg, tcfg = _configs(depth, s2d)
    train_grads = depth == 18
    params = jax.tree.map(np.array, jax_resnet.resnet_init(jax.random.PRNGKey(0), jcfg))
    images = np.random.RandomState(1).standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, SMALL["num_classes"], batch).astype(np.int32)
    apply = jax.jit(jax_resnet.resnet_apply, static_argnums=(2, 3))
    train_logits, train_params = apply(params, images, jcfg, True)
    eval_logits, _ = apply(params, images, jcfg, False)
    loss_fn = _jax_loss_fn(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=3)(
        params, images, labels, train_grads)
    out = dict(jcfg=jcfg, tcfg=tcfg, params=params, images=images, labels=labels,
               train_grads=train_grads, train_logits=np.array(train_logits),
               train_params=jax.tree.map(np.array, train_params),
               eval_logits=np.array(eval_logits), loss=float(loss),
               grads=jax.tree.map(np.array, grads))
    if train_grads:
        tx = optax.sgd(0.1, momentum=0.9)

        @jax.jit
        def step(params, opt):
            (_, new_params), g = jax.value_and_grad(loss_fn, has_aux=True)(
                params, images, labels, True)
            updates, opt = tx.update(g, opt, params)
            return optax.apply_updates(new_params, updates), opt

        stepped, opt = params, tx.init(params)
        out["after"] = {}
        for k in range(1, 4):
            stepped, opt = step(stepped, opt)
            out["after"][k] = jax.tree.map(np.array, stepped)
    return out


def _model(case):
    return resnet_params_from_jax(case["params"], case["tcfg"], device="cpu")


def _images(case):
    return torch.from_numpy(case["images"]).permute(0, 3, 1, 2)  # NHWC -> NCHW view


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_close(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, want[path], err_msg=jax.tree_util.keystr(path), **tol)


def test_params_round_trip(case):
    model = _model(case)
    assert model.stem_conv.is_contiguous(memory_format=torch.channels_last)
    got, want = _leaves(resnet_params_to_numpy(model)), _leaves(case["params"])
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert np.array_equal(leaf, want[path]), jax.tree_util.keystr(path)


def test_train_forward_and_running_stats(case):
    model = _model(case)
    logits = resnet.resnet_apply(model, _images(case), train=True)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (len(case["images"]), SMALL["num_classes"])
    tol = ATOL if case["train_grads"] else DEEP_TRAIN_TOL
    np.testing.assert_allclose(logits.detach().numpy(), case["train_logits"], atol=tol, rtol=tol)
    # Every leaf after the forward: the running mean and var moved, the rest did not.
    _assert_trees_close(resnet_params_to_numpy(model), case["train_params"], atol=tol, rtol=tol)


def test_eval_forward(case):
    model = _model(case)
    with torch.no_grad():
        logits = resnet.resnet_apply(model, _images(case), train=False)
    np.testing.assert_allclose(logits.numpy(), case["eval_logits"], atol=ATOL, rtol=RTOL)
    _assert_trees_close(resnet_params_to_numpy(model), case["params"], atol=0, rtol=0)


def test_gradients(case):
    model = _model(case)
    logits = resnet.resnet_apply(model, _images(case), train=case["train_grads"])
    loss = F.cross_entropy(logits, torch.from_numpy(case["labels"]).long())
    loss.backward()
    assert abs(float(loss.detach()) - case["loss"]) <= ATOL + RTOL * case["loss"]
    got, want = _leaves(resnet_params_to_numpy(model, grads=True)), _leaves(case["grads"])
    # Every parameter has its gradient; the running statistics have none.
    assert got.keys() == {p for p in want if p[-1].key not in ("mean", "var")}
    for path, g in got.items():
        w = want[path]
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("case", CASES[:2], indirect=True,
                         ids=[f"depth{d}-s2d{int(s)}" for d, s, _, _ in CASES[:2]])
def test_sgd_steps(case):
    init_state, step = resnet.make_train_step(case["tcfg"], device="cpu")
    state = init_state(model=_model(case))
    batch = {"images": _images(case), "labels": torch.from_numpy(case["labels"]).long()}
    for k in range(1, 4):
        state, m = step(state, batch)
        if k == 1:
            assert abs(float(m["loss"]) - case["loss"]) <= ATOL
        if k in (1, 3):
            _assert_trees_close(resnet_params_to_numpy(state["model"]), case["after"][k],
                                atol=PARAM_ATOL, rtol=0)
    assert state["step"] == 3


def test_resnet_forward():
    """tests/test_models.py test_resnet_forward, through the port."""
    cfg = resnet.ResNetConfig(depth=18, num_classes=10, width=8, dtype=torch.float32)
    model = resnet.resnet_init(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = model.stem_bn.mean.clone()
    imgs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    logits = resnet.resnet_apply(model, imgs, train=True)
    assert tuple(logits.shape) == (2, 10)
    assert not torch.allclose(model.stem_bn.mean, before)  # BN stats updated


def test_images_from_uint8_is_a_channels_last_view():
    raw = torch.arange(2 * 4 * 4 * 3, dtype=torch.int64).remainder(256).to(torch.uint8)
    raw = raw.view(2, 4 * 4 * 3)
    x = resnet.images_from_uint8(raw, 4, torch.float32)
    assert tuple(x.shape) == (2, 3, 4, 4) and x.is_contiguous(memory_format=torch.channels_last)
    want = raw.view(2, 4, 4, 3).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    assert torch.equal(x, want)


@pytest.mark.parametrize("s2d", [False, True])
def test_flop_count(s2d):
    """The analytic forward count equals what FlopCounterMode counts for a
    forward (convolutions and the fc layer, 2 per multiply-add), and a
    train step counts three forwards less the stem's input gradient, which
    nothing needs. ResNet-50 at 224 is ~8.2 GFLOP a forward."""
    cfg = resnet.ResNetConfig(depth=50, num_classes=10, width=8, dtype=torch.float32,
                              space_to_depth=s2d)
    batch, size = 2, 32
    model = resnet.resnet_init(cfg, device="cpu")
    imgs = torch.randn(batch, 3, size, size)
    with FlopCounterMode(display=False) as fwd, torch.no_grad():
        resnet.resnet_apply(model, imgs, train=False)
    fwd_image = resnet.forward_flops_per_image(cfg, size)
    assert fwd.get_total_flops() == batch * fwd_image
    init_state, step = resnet.make_train_step(cfg, device="cpu")
    state = init_state(model=model)
    with FlopCounterMode(display=False) as train:
        step(state, {"images": imgs, "labels": torch.tensor([1, 2])})
    assert train.get_total_flops() == batch * resnet.train_flops_per_image(cfg, size)
    full = resnet.forward_flops_per_image(resnet.ResNetConfig(space_to_depth=s2d), 224)
    assert 8.1e9 < full < 8.3e9


def test_entry_points_without_device_raise_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _configs(18, False)
    params = jax.tree.map(np.array, jax_resnet.resnet_init(jax.random.PRNGKey(0), jcfg))
    for call in (lambda: resnet.resnet_init(tcfg),
                 lambda: resnet.ResNet(tcfg),
                 lambda: resnet.make_train_step(tcfg),
                 lambda: resnet_params_from_jax(params, tcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.fixture
def reference_in_f64(monkeypatch):
    """The reference's own code in float64: x64 on, and its module's jnp
    reading float32 as float64 (it takes statistics and pools in float32)."""

    class Wide:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    monkeypatch.setattr(jax_resnet, "jnp", Wide())
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.mark.parametrize("s2d", [False, True], ids=["s2d0", "s2d1"])
def test_depth50_in_f64_agrees_to_f64_rounding(reference_in_f64, s2d):
    """Depth 50's f32 gap (module docstring) is rounding: the same cases in
    float64 on both sides, from the same f32-drawn weights, agree in
    train-mode logits, running statistics, every train-mode gradient and
    the parameters after one SGD step."""
    depth, _, batch, size = CASES[2]
    jcfg = jax_resnet.ResNetConfig(depth=depth, dtype=jnp.float64, space_to_depth=s2d, **SMALL)
    tcfg = resnet.ResNetConfig(depth=depth, dtype=torch.float64, space_to_depth=s2d, **SMALL)
    # Drawn under the fixture, in f64: rounded to f32 on both sides.
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jax_resnet.resnet_init(jax.random.PRNGKey(0), jcfg))
    params = jax.tree.map(lambda a: a.astype(np.float64), params32)
    images = np.random.RandomState(1).standard_normal((batch, size, size, 3))
    labels = np.random.RandomState(2).randint(0, SMALL["num_classes"], batch)
    loss_fn = _jax_loss_fn(jcfg)
    (_, train_params), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                                       static_argnums=3)(params, images, labels, True)
    train_logits, _ = jax.jit(jax_resnet.resnet_apply, static_argnums=(2, 3))(
        params, images, jcfg, True)
    tx = optax.sgd(0.1, momentum=0.9)
    updates, _ = tx.update(grads, tx.init(params), params)
    after = optax.apply_updates(train_params, updates)

    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    model = resnet_params_from_jax(params32, tcfg, device="cpu").double()
    logits = resnet.resnet_apply(model, x, train=True)
    assert logits.dtype == torch.float64
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(train_logits),
                               atol=F64_TOL, rtol=F64_TOL)
    _assert_trees_close(resnet_params_to_numpy(model), train_params, atol=F64_TOL, rtol=F64_TOL)
    F.cross_entropy(logits, torch.from_numpy(labels)).backward()
    got, want = _leaves(resnet_params_to_numpy(model, grads=True)), _leaves(grads)
    for path, g in got.items():
        rel = np.linalg.norm(g - want[path]) / np.linalg.norm(want[path])
        assert rel <= F64_GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
    init_state, step = resnet.make_train_step(tcfg, device="cpu")
    state = init_state(model=resnet_params_from_jax(params32, tcfg, device="cpu").double())
    step(state, {"images": x, "labels": torch.from_numpy(labels)})
    _assert_trees_close(resnet_params_to_numpy(state["model"]), after, atol=F64_TOL, rtol=0)


def test_smoke_profile_puts_each_backward_op_in_its_forward_scope():
    """chip_smoke.py's attribution by op (scope_times), on the host events
    of a CPU train step: every op of the batch norms and convolutions,
    forward and backward, lands in its scope; ReLU, the residual adds and
    the optimizer keep their own names; the wrapped functions come back."""
    from torch.profiler import ProfilerActivity, profile

    cs = importlib.import_module("chip_smoke")
    cfg = resnet.ResNetConfig(depth=18, num_classes=10, width=8, dtype=torch.float32)
    init_state, step = resnet.make_train_step(cfg, device="cpu")
    state = init_state(torch.Generator().manual_seed(0))
    batch = {"images": torch.randn(2, 3, 32, 32), "labels": torch.tensor([1, 2])}
    bn, conv = resnet._bn, resnet._conv
    with cs.scoped({"batch_norm": (resnet, "_bn"), "conv": (resnet, "_conv")}), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert resnet._bn is bn and resnet._conv is conv
    # Each leaf op counts once, under its name.
    by_op = cs.scope_times(prof.events(), lambda e: [] if e.cpu_children else [(e.name, 1)])
    assert sum(sum(row.values()) for row in by_op.values()) == sum(
        1 for e in prof.events() if not e.cpu_children and e.device_type.name == "CPU")
    bwd = {op for op in by_op if op.startswith("bwd ")}
    # _bn's ops and the convolutions leave no backward outside a scope
    # (the pool's mean, outside _bn, keeps its MeanBackward1).
    for name in ("Sub", "Pow", "Rsqrt", "Mul", "Unsqueeze", "Convolution"):
        assert not any(op.startswith(f"bwd {name}Backward") for op in bwd), (name, bwd)
    assert "bwd ReluBackward0" in bwd and "bwd AddBackward0" in bwd
    assert "aten::relu" in by_op and any(op.startswith("Optimizer.step") for op in by_op)
    assert by_op["batch_norm"] and by_op["conv"]
