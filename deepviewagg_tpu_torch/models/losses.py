"""Segmentation losses: masked cross-entropy and Lovász-softmax.

The port of ``deepviewagg_tpu/models/losses.py``: the reference trains with
NLL on log-softmax logits plus an optional Lovász hinge on the softmax
(models/segmentation/sparseconv3d.py:44-56, metrics/lovasz_loss.py).  Both
are static-shape with validity masks (padding rows and ``IGNORE_LABEL`` = -1
contribute exactly zero).

The Lovász-softmax's scan runs where its tensors lie: on the CPU the plain
formula over the ``[N, C]`` errors sorted on dim 0 (``_lovasz_grad``); on
a CUDA card over a class-major sort, each class's ``[N]`` errors a
contiguous row, through the hand-written kernel of ``ops/lovasz.py``
(PyTorch's cumsum on dim 0 is an outer-dimension scan, one thread block a
class: the largest item of a large batch's step).  Both give the same weights
bit for bit on the same sorted input.
"""

from __future__ import annotations

import torch

from ..ops.lovasz import lovasz_dot
from ..ops.lovasz import lovasz_grad as _lovasz_grad
from ..utils import trace

__all__ = ["IGNORE_LABEL", "cross_entropy", "lovasz_softmax",
           "lovasz_softmax_class_major", "segmentation_loss",
           "sqrt_inverse_class_weights", "view_level_loss", "propagate_unseen"]

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
    without its dynamic filtering).  All classes are handled at once.  A
    CUDA tensor takes :func:`lovasz_softmax_class_major` (the kernel), a CPU
    tensor the plain formula, one column a class.  Traced, a call is the
    device span ``loss.lovasz`` and one count of ``loss.lovasz_kernel`` or
    ``loss.lovasz_plain``."""
    with trace.span("loss.lovasz", device=logits):
        if logits.device.type == "cuda":
            trace.count("loss.lovasz_kernel")
            return lovasz_softmax_class_major(logits, labels, valid)
        trace.count("loss.lovasz_plain")
        return _lovasz_softmax_plain(logits, labels, valid)


def _lovasz_softmax_plain(logits, labels, valid=None):
    mask = _mask(labels, valid)
    probs = torch.softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    fg = ((labels[:, None] == classes) & mask[:, None]).to(torch.float32)
    err = torch.where(mask[:, None], torch.abs(fg - probs), 0.0)
    err_s, order = torch.sort(err, dim=0, descending=True, stable=True)
    fg_s = torch.gather(fg, 0, order)
    loss_c = torch.sum(err_s * _lovasz_grad(fg_s), dim=0)
    return _present_mean(loss_c, torch.sum(fg, dim=0) > 0)


def lovasz_softmax_class_major(logits, labels, valid=None):
    """:func:`lovasz_softmax` over a class-major layout: the errors as
    ``[C, N]`` rows, each sorted along its contiguous row (stable, so the
    order and every weight are the plain path's), the foreground as uint8
    gathered by that order, and :func:`ops.lovasz.lovasz_dot` for the scan
    and the products (the kernel on a card, its plain version on the
    CPU)."""
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
