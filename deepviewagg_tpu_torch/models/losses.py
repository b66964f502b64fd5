"""Segmentation losses: masked cross-entropy and Lovász-softmax.

The port of ``deepviewagg_tpu/models/losses.py``: the reference trains with
NLL on log-softmax logits plus an optional Lovász hinge on the softmax
(models/segmentation/sparseconv3d.py:44-56, metrics/lovasz_loss.py).  Both
are static-shape with validity masks (padding rows and ``IGNORE_LABEL`` = -1
contribute exactly zero).

The Lovász-softmax runs over a class-major sort on every device: each
class's ``[N]`` errors a contiguous row, the scan and the products through
``ops/lovasz.py`` (the hand-written kernel on a CUDA card, its plain version
on the CPU; PyTorch's cumsum along dim 0 of ``[N, C]`` is an
outer-dimension scan, one thread block a class).
"""

from __future__ import annotations

import torch

from ..ops.lovasz import lovasz_dot
from ..utils import trace

__all__ = ["IGNORE_LABEL", "cross_entropy", "lovasz_softmax",
           "segmentation_loss", "sqrt_inverse_class_weights",
           "view_level_loss", "propagate_unseen"]

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


def lovasz_softmax(logits, labels, valid=None):
    """Multi-class Lovász-softmax (present-classes mean).

    Invalid rows get error exactly 0, so they sort to the tail and contribute
    nothing to the per-class dot product (metrics/lovasz_loss.py semantics
    without its dynamic filtering).  All classes are handled at once, in a
    class-major layout: the errors as ``[C, N]`` rows, each sorted along its
    row (stable), the foreground as uint8 gathered by that order, and
    :func:`ops.lovasz.lovasz_dot` for the scan and the products.  Traced, a
    call is the device span ``loss.lovasz``."""
    with trace.span("loss.lovasz", device=logits):
        mask = _mask(labels, valid)
        probs_t = torch.softmax(logits, dim=-1).t()
        classes = torch.arange(logits.shape[-1], device=logits.device)
        fg_t = ((labels[None, :] == classes[:, None])
                & mask[None, :]).to(torch.uint8)
        err_t = torch.where(mask[None, :], torch.abs(fg_t - probs_t),
                            0.0).contiguous()
        err_s, order = torch.sort(err_t, dim=1, descending=True, stable=True)
        loss_c = lovasz_dot(err_s, torch.gather(fg_t, 1, order))
        return _present_mean(loss_c, torch.sum(fg_t, dim=1) > 0)


def _present_mean(loss_c, present):
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


def propagate_unseen(logits, pos, x_seen, k: int = 1):
    """Eval-time semantics for points no view reaches: copy the logits of
    the nearest *seen* point (KeOps 1-NN in the reference, no3d.py:105-126)
    by :func:`ops.knn.knn` on the tensors' device.  Returns ``logits``
    itself when every point is seen or none is."""
    from ..ops.knn import knn

    if bool(x_seen.all()) or not bool(x_seen.any()):
        return logits
    _, idx = knn(pos[~x_seen], pos, k=k, valid=x_seen)
    out = logits.clone()
    out[~x_seen] = logits[idx[:, 0]]
    return out
