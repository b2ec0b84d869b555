"""How well conditioned the ResNet parity of test_torch_resnet.py is.

For each (depth, space_to_depth, batch, image size) it prints, in f32 on the
CPU at width 8: how far the JAX reference's own train-mode logits and
gradients and eval-mode gradients move when every pixel moves by one ulp
(x * (1 +- 2^-23), random signs), and how far the port is from the
reference on the same weights and images. Logits are measured against the
tests' limit 1e-4 + 1e-4 |x| (worst element / its limit); gradients by the
worst relative L2 over the parameters. test_torch_resnet.py's sizes and
tolerances rest on these numbers.

    JAX_PLATFORMS=cpu python tests/resnet_conditioning.py
"""

import json

import numpy as np
import torch
import torch.nn.functional as F

import jax

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import resnet as jax_resnet  # noqa: E402
from ray_tpu_torch.convert import resnet_params_from_jax, resnet_params_to_numpy  # noqa: E402
from ray_tpu_torch.models import resnet  # noqa: E402

CASES = [(18, False, 2, 32), (18, False, 2, 64), (18, True, 2, 64),
         (50, False, 2, 32), (50, False, 4, 128), (50, True, 4, 128)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _limit_share(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))).max())


def measure(depth, s2d, batch, size) -> dict:
    jcfg = jax_resnet.ResNetConfig(depth=depth, num_classes=10, width=8, dtype=jnp.float32,
                                   space_to_depth=s2d)
    tcfg = resnet.ResNetConfig(depth=depth, num_classes=10, width=8, dtype=torch.float32,
                               space_to_depth=s2d)
    params = jax.tree.map(np.array, jax_resnet.resnet_init(jax.random.PRNGKey(0), jcfg))
    images = np.random.RandomState(1).standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 10, batch).astype(np.int32)
    signs = np.sign(np.random.RandomState(9).standard_normal(images.shape)).astype(np.float32)
    moved = images * (1 + np.float32(2.0 ** -23) * signs)

    def loss_fn(p, x, train):
        logits, _ = jax_resnet.resnet_apply(p, x, jcfg, train=train)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean(), logits

    grad = jax.jit(jax.grad(loss_fn, has_aux=True), static_argnums=2)

    def leaves(tree):
        return dict(jax.tree_util.tree_leaves_with_path(tree))

    out = {"case": [depth, s2d, batch, size]}
    for train in (True, False):
        g, logits = grad(params, images, train)
        g_moved, logits_moved = grad(params, moved, train)
        model = resnet_params_from_jax(params, tcfg, device="cpu")
        port_logits = resnet.resnet_apply(model, torch.from_numpy(images).permute(0, 3, 1, 2),
                                          train=train)
        F.cross_entropy(port_logits, torch.from_numpy(labels).long()).backward()
        port_g = leaves(resnet_params_to_numpy(model, grads=True))
        g, g_moved = leaves(g), leaves(g_moved)
        mode = "train" if train else "eval"
        out[f"{mode}_logits_ref_moved"] = _limit_share(logits_moved, logits)
        out[f"{mode}_logits_port"] = _limit_share(port_logits.detach().numpy(), logits)
        out[f"{mode}_grads_ref_moved"] = max(_rel(g_moved[k], g[k]) for k in port_g)
        out[f"{mode}_grads_port"] = max(_rel(port_g[k], g[k]) for k in port_g)
    return out


if __name__ == "__main__":
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # see test_torch_resnet.py's _no_onednn
    try:
        for case in CASES:
            print(json.dumps(measure(*case)), flush=True)
    finally:
        torch.backends.mkldnn.enabled = enabled
