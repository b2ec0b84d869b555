"""Small fused ops: RMSNorm and large-vocab cross entropy.

Port of ray_tpu/ops/fused.py. These were plain jnp there (XLA fuses them)
and are plain torch ops here: (a) RMSNorm with f32 statistics on bf16
activations, output in the input dtype, (b) cross entropy over the LM head
that never materializes [B*T, V] logits, by recomputing each token chunk's
logits in the backward (torch.utils.checkpoint).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def fused_rmsnorm(x, weight, *, eps: float = 1e-6):
    """RMSNorm with f32 statistics on any-dtype input; output in input dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _ce_terms(logits, labels, ignore_index: int):
    """Per-token (logsumexp - label logit) in f32, and the valid-token mask."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    safe = labels.masked_fill(labels == ignore_index, 0)
    picked = lf.gather(-1, safe[..., None]).squeeze(-1)
    return lse - picked, (labels != ignore_index).float()


def softmax_cross_entropy(logits, labels, *, ignore_index: int = -100):
    """Token-level CE on [..., V] logits and integer labels.

    Positions equal to ignore_index contribute 0 and are excluded from the
    mean. Returns (mean_loss, valid_token_count).
    """
    per_tok, mask = _ce_terms(logits, labels, ignore_index)
    n = mask.sum().clamp_min(1.0)
    return (per_tok * mask).sum() / n, n


def _chunk_loss(hc, tc, w, ignore_index: int):
    per_tok, mask = _ce_terms(hc @ w, tc, ignore_index)
    return (per_tok * mask).sum(), mask.sum()


def lm_head_cross_entropy(hidden, unembed, targets, *, chunk_tokens: int = 2048,
                          ignore_index: int = -100):
    """Fused LM-head + token CE that never materializes [B*T, V] logits.

    `hidden` [B, T, d] (compute dtype) is cut into token chunks; each chunk
    computes its logits ([chunk, d] @ [d, V]), reduces them to
    logsumexp - label_logit in f32, and is recomputed in the backward, so
    peak logits memory is chunk_tokens*V*4 bytes. Returns
    (mean_loss, valid_token_count).
    """
    B, T, d = hidden.shape
    n = B * T
    h = hidden.reshape(n, d)
    t = targets.reshape(n)
    pad = (-n) % chunk_tokens
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        t = F.pad(t, (0, pad), value=ignore_index)
    w = unembed.to(h.dtype)
    loss_sum = h.new_zeros((), dtype=torch.float32)
    count = h.new_zeros((), dtype=torch.float32)
    for hc, tc in zip(h.split(chunk_tokens), t.split(chunk_tokens)):
        ls, ns = checkpoint(_chunk_loss, hc, tc, w, ignore_index, use_reentrant=False)
        loss_sum = loss_sum + ls
        count = count + ns
    count = count.clamp_min(1.0)
    return loss_sum / count, count
