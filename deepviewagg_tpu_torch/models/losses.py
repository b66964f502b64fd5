"""Segmentation losses: masked cross-entropy and Lovász-softmax.

The port of ``deepviewagg_tpu/models/losses.py``: the reference trains with
NLL on log-softmax logits plus an optional Lovász hinge on the softmax
(models/segmentation/sparseconv3d.py:44-56, metrics/lovasz_loss.py).  Both
are static-shape with validity masks (padding rows and ``IGNORE_LABEL`` = -1
contribute exactly zero).
"""

from __future__ import annotations

import torch

__all__ = ["IGNORE_LABEL", "cross_entropy", "lovasz_softmax",
           "segmentation_loss", "sqrt_inverse_class_weights",
           "view_level_loss"]

IGNORE_LABEL = -1


def _mask(labels, valid):
    mask = labels != IGNORE_LABEL
    return mask if valid is None else mask & valid


def cross_entropy(logits, labels, valid=None, class_weights=None):
    """Mean masked CE.  ``labels`` integer with -1 = ignore; optional
    per-class weights (the reference's sqrt-inverse-frequency weights,
    datasets/base_dataset.py:558)."""
    safe = torch.clamp(labels, min=0).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    w = _mask(labels, valid).to(torch.float32)
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=logits.device)[safe]
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-6)


def _lovasz_grad(fg_sorted):
    """Gradient of the Lovász extension of the Jaccard loss, along the
    sorted errors (dim 0)."""
    gts = torch.sum(fg_sorted, dim=0, keepdim=True)
    inter = gts - torch.cumsum(fg_sorted, dim=0)
    union = gts + torch.cumsum(1.0 - fg_sorted, dim=0)
    jaccard = 1.0 - inter / torch.clamp(union, min=1.0)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(logits, labels, valid=None):
    """Multi-class Lovász-softmax (present-classes mean).

    Invalid rows get error exactly 0, so they sort to the tail and contribute
    nothing to the per-class dot product (metrics/lovasz_loss.py semantics
    without its dynamic filtering).  All classes are handled at once, one
    column each."""
    mask = _mask(labels, valid)
    probs = torch.softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    fg = ((labels[:, None] == classes) & mask[:, None]).to(torch.float32)
    err = torch.where(mask[:, None], torch.abs(fg - probs), 0.0)
    err_s, order = torch.sort(err, dim=0, descending=True, stable=True)
    fg_s = torch.gather(fg, 0, order)
    loss_c = torch.sum(err_s * _lovasz_grad(fg_s), dim=0)
    present = torch.sum(fg, dim=0) > 0
    losses = torch.where(present, loss_c, 0.0)
    return torch.sum(losses) / torch.clamp(
        torch.sum(present.to(torch.float32)), min=1.0)


def segmentation_loss(logits, labels, valid=None, lovasz_weight: float = 0.0,
                      class_weights=None):
    loss = cross_entropy(logits, labels, valid, class_weights)
    if lovasz_weight > 0:
        loss = loss + lovasz_weight * lovasz_softmax(logits, labels, valid)
    return loss


def sqrt_inverse_class_weights(label_counts) -> torch.Tensor:
    """``1/sqrt(freq)`` normalized class weights
    (datasets/base_dataset.py:558-575)."""
    counts = torch.clamp(torch.as_tensor(label_counts, dtype=torch.float32),
                         min=1.0)
    w = 1.0 / torch.sqrt(counts / counts.sum())
    return w / w.mean()


def view_level_loss(view_logits, labels, point_id, view_valid):
    """Per-view NLL against the owning point's label — the reference's
    view-level loss option (labels repeat_interleave'd per view,
    models/segmentation/multimodal/no3d.py:139-155)."""
    n = labels.shape[0]
    pid = torch.clamp(point_id, max=n - 1).to(torch.int64)
    view_labels = torch.where(
        view_valid, labels[pid],
        torch.full_like(labels[:1], IGNORE_LABEL))
    return cross_entropy(view_logits, view_labels)
