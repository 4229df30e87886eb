"""Cross-entropy (the counterpart of ``cross_entropy`` and
``_maybe_fused_cross_entropy`` in ``paddle_tpu/nn/functional/loss.py``).

The routing is the JAX package's: a hard-label call (softmax, integer
labels, no class ``weight``, the class axis last) goes to the fused
softmax cross-entropy, :func:`...ops.fused_kernels.fused_softmax_xent`:
the CUDA kernel pair on the card, its plain version on the CPU.  The JAX
package takes its Pallas kernel there on the TPU and its XLA path
elsewhere; the port has no fallback.  Soft labels, class weights,
``use_softmax=False`` and a class axis other than the last take the
plain path below, as they do in the JAX package.
"""
from __future__ import annotations

import torch

from ...ops.fused_kernels import fused_softmax_xent

__all__ = ["cross_entropy"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _is_soft(input, label, axis):
    return (label.dim() == input.dim()
            and label.shape[axis] == input.shape[axis]
            and label.is_floating_point())


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of ``input`` against hard (int) or soft
    labels, as the JAX package's ``F.cross_entropy``: f32 losses, rows
    whose label is ``ignore_index`` count 0, and ``"mean"`` over hard
    labels divides by the number of valid rows (at least 1)."""
    ax = axis % input.dim()
    if (use_softmax and not soft_label and weight is None
            and ax == input.dim() - 1 and not _is_soft(input, label, ax)
            and not label.is_floating_point() and label.dtype != torch.bool):
        return _fused(input, label, ignore_index, reduction, label_smoothing)

    n_class = input.shape[ax]
    logits = input.float()
    logp = (torch.log_softmax(logits, dim=ax) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    if soft_label or _is_soft(input, label, ax):
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        loss = -(soft * logp).sum(ax)
        if weight is not None:
            loss = loss * (soft * weight.float()).sum(ax)
        return _reduce(loss, reduction)
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(ax)
    lab_c = lab.clamp(0, n_class - 1)
    loss = -torch.take_along_dim(logp, lab_c.unsqueeze(ax), ax).squeeze(ax)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss \
            + label_smoothing * (-logp.mean(ax))
    valid = lab != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        sample_w = torch.where(valid, weight.float()[lab_c],
                               torch.zeros_like(loss))
        loss = loss * sample_w
        if reduction == "mean":
            return loss.sum() / torch.clamp(sample_w.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def _fused(input, label, ignore_index, reduction, label_smoothing):
    """The hard-label route: per-row losses from the fused kernels."""
    n_class = input.shape[-1]
    lab = label.squeeze(-1) if label.dim() == input.dim() else label
    rows = lab.numel()
    loss = fused_softmax_xent(input.reshape(rows, n_class),
                              lab.reshape(rows), ignore_index=ignore_index,
                              label_smoothing=label_smoothing)
    loss = loss.reshape(lab.shape)
    if reduction == "mean":
        valid = (lab != ignore_index).float()
        return loss.sum() / torch.clamp(valid.sum(), min=1.0)
    return _reduce(loss, reduction)
