"""Runtime image/mapping selection transforms, host numpy.

The port of the part of ``deepviewagg_tpu/data/transforms2d.py`` that
``SphereDataset.__getitem__`` reaches by default (the reference's
__getitem__-time 2D chain, core/data_transform/multimodal/image.py):

  * :func:`pick_images_by_area` — ``PickImagesFromMappingArea`` (:713);
  * :func:`pick_images_by_credit` — ``PickImagesFromMemoryCredit`` (:765),
    the train-time stochastic knapsack, and :func:`select_images_by_credit`
    / :func:`select_images_by_coverage`, its deterministic eval-time form;
  * :func:`normalize_images` (``ToFloatImage`` + ``Normalize``).

Copied so that the same ``np.random.Generator`` draws give the same arrays.
The roll, flip, mapping jitter and radiometric transforms are not ported
(``SphereDataset`` refuses the options that would call them).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .mapping import MultiViewMapping

__all__ = [
    "pick_images_by_area",
    "pick_images_by_credit",
    "select_images_by_coverage",
    "select_images_by_credit",
    "normalize_images",
]


def _points_per_image(m: MultiViewMapping) -> np.ndarray:
    counts = np.zeros(m.num_images, np.int64)
    np.add.at(counts, m.image_id[m.view_valid], 1)
    return counts


def pick_images_by_area(
    cloud: dict, min_points: int = 64, use_bbox: bool = False,
    area_ratio: float = 0.02,
) -> dict:
    """Drop images whose mappings cover too little of the view.

    ``use_bbox=False``: count criterion — fewer than ``min_points`` mapped
    sample points (PickImagesFromMappingArea's scatter_add leg, image.py:
    737-739, with the pixel-count -> point-count simplification).

    ``use_bbox=True`` (what every published recipe runs when
    exact_splatting_2d is on, s3disfused-sparse.yaml:148): the bbox of the
    image's mapped pixels must exceed ``area_ratio`` of the image area
    (image.py:740-754)."""
    m: MultiViewMapping = cloud["mapping"]
    if use_bbox and cloud.get("images") is not None:
        w, h = cloud["images"].shape[1], cloud["images"].shape[2]
        img_of_pix = m.image_id[np.minimum(m.pix_view,
                                           len(m.image_id) - 1)]
        n = m.num_images
        x_min = np.full(n, w, np.int64); x_max = np.zeros(n, np.int64)
        y_min = np.full(n, h, np.int64); y_max = np.zeros(n, np.int64)
        ok = m.pix_valid
        np.minimum.at(x_min, img_of_pix[ok], m.pix_x[ok])
        np.maximum.at(x_max, img_of_pix[ok], m.pix_x[ok])
        np.minimum.at(y_min, img_of_pix[ok], m.pix_y[ok])
        np.maximum.at(y_max, img_of_pix[ok], m.pix_y[ok])
        areas = np.maximum(x_max - x_min, 0) * np.maximum(y_max - y_min, 0)
        keep = np.nonzero(areas > area_ratio * w * h)[0]
        if len(keep) == 0:     # keep the largest mapping, never go empty
            keep = np.asarray([int(areas.argmax())])
    else:
        counts = _points_per_image(m)
        keep = np.nonzero(counts >= min_points)[0]
    if len(keep) == m.num_images:
        return cloud
    return _select_cloud_images(cloud, keep)


def select_images_by_coverage(m: MultiViewMapping, n: int) -> np.ndarray:
    """Deterministic greedy max-coverage subset of ``n`` images (sorted ids).

    Preprocess-time counterpart of :func:`pick_images_by_credit` (reference
    selects preprocessing images by mapping area / pixel credit,
    data_transform/multimodal/image.py:713,765): each step keeps the image
    seeing the most not-yet-covered points, tie-broken by total view count
    then index — so a ``max_images`` cap keeps the views that matter instead
    of the first N cameras."""
    if m.num_images <= n:
        return np.arange(m.num_images)
    v = m.view_valid
    img_of_view = m.image_id[v].astype(np.int64)
    pid_of_view = m.point_id[v].astype(np.int64)
    totals = np.bincount(img_of_view, minlength=m.num_images).astype(np.int64)

    # incremental greedy max-coverage: each view row is decremented from the
    # gain table exactly once (when its point first becomes covered), so the
    # whole selection is O(V + n * num_images) instead of O(n * V)
    by_img = np.argsort(img_of_view, kind="stable")
    img_ptr = np.searchsorted(img_of_view[by_img], np.arange(m.num_images + 1))
    by_pid = np.argsort(pid_of_view, kind="stable")
    pid_ptr = np.searchsorted(pid_of_view[by_pid], np.arange(m.num_points + 1))

    def _ragged_take(order, ptr, keys):
        starts, lengths = ptr[keys], ptr[keys + 1] - ptr[keys]
        total = int(lengths.sum())
        if total == 0:
            return np.empty(0, np.int64)
        offs = np.repeat(np.cumsum(lengths) - lengths, lengths)
        return order[np.repeat(starts, lengths) + np.arange(total) - offs]

    gain = np.bincount(img_of_view, minlength=m.num_images).astype(np.int64)
    unseen = np.ones(m.num_points, bool)
    remaining = np.ones(m.num_images, bool)
    picked = []
    for _ in range(n):
        # lexicographic argmax (gain, totals, -index) over remaining images
        score = np.where(remaining, gain * (totals.max() + 1) + totals, -1)
        choice = int(np.argmax(score))
        if score[choice] < 0:
            break
        picked.append(choice)
        remaining[choice] = False
        pids = pid_of_view[_ragged_take(by_img, img_ptr, np.array([choice]))]
        new = np.unique(pids[unseen[pids]])
        unseen[new] = False
        if len(new):
            aff = _ragged_take(by_pid, pid_ptr, new)
            np.subtract.at(gain, img_of_view[aff], 1)
    return np.sort(np.asarray(picked, np.int64))


def select_images_by_credit(
    m: MultiViewMapping, budget_px: int, image_px: np.ndarray
) -> np.ndarray:
    """Deterministic greedy max-coverage selection under a PIXEL budget —
    the reference's eval-time ``PickImagesFromMemoryCredit`` semantics
    (image.py:765-874: total pixel credit, drop images exceeding the
    remaining credit) with the stochastic sampling replaced by the
    deterministic coverage argmax.  With uniform ``image_px`` this
    degenerates to :func:`select_images_by_coverage` with
    ``n = budget_px // image_px``; with camera families / crop buckets,
    cheap (small) images stop competing against panoramas for slots."""
    image_px = np.asarray(image_px, np.int64)
    if image_px.sum() <= budget_px:
        return np.arange(m.num_images)
    v = m.view_valid
    img_of_view = m.image_id[v].astype(np.int64)
    pid_of_view = m.point_id[v].astype(np.int64)
    totals = np.bincount(img_of_view, minlength=m.num_images).astype(np.int64)
    unseen = np.ones(m.num_points, bool)
    remaining = np.ones(m.num_images, bool)
    budget = int(budget_px)
    picked = []
    while True:
        fits = remaining & (image_px <= budget)
        if not fits.any():
            break
        gain = np.bincount(
            img_of_view, weights=unseen[pid_of_view].astype(np.float64),
            minlength=m.num_images)
        score = np.where(fits, gain * (totals.max() + 1) + totals, -1.0)
        choice = int(np.argmax(score))
        if score[choice] < 0:
            break
        picked.append(choice)
        remaining[choice] = False
        budget -= int(image_px[choice])
        unseen[pid_of_view[img_of_view == choice]] = False
    if not picked:   # budget below the smallest image: keep the best one
        return select_images_by_coverage(m, 1)
    return np.sort(np.asarray(picked, np.int64))


def pick_images_by_credit(
    cloud: dict,
    n_slots: int,
    rng: np.random.Generator,
    k_coverage: float = 2.0,
) -> dict:
    """Stochastic greedy selection of exactly ``<= n_slots`` images.

    Reference semantics (image.py:765-874): iteratively sample an image with
    probability ∝ ``w_size + k_coverage * w_unseen`` where ``w_unseen`` is
    the normalized count of sample points not covered by already-picked
    images; here every image has equal pixel size (bucketed), so ``w_size``
    is uniform and the coverage term drives selection.
    """
    m: MultiViewMapping = cloud["mapping"]
    n_img = m.num_images
    if n_img <= n_slots:
        return cloud
    v = m.view_valid
    img_of_view = m.image_id[v]
    pid_of_view = m.point_id[v]

    unseen = np.ones(m.num_points, bool)
    remaining = np.ones(n_img, bool)
    picked = []
    for _ in range(n_slots):
        idx = np.nonzero(remaining)[0]
        if len(idx) == 0:
            break
        w_unseen = np.zeros(n_img, np.float64)
        np.add.at(w_unseen, img_of_view, unseen[pid_of_view].astype(np.float64))
        w = 1.0 + k_coverage * (w_unseen / max(w_unseen.max(), 1e-9))
        w = np.where(remaining, w, 0.0)
        p = w / w.sum()
        choice = rng.choice(n_img, p=p)
        picked.append(choice)
        remaining[choice] = False
        unseen[pid_of_view[img_of_view == choice]] = False
    picked = np.sort(np.array(picked, np.int64))
    return _select_cloud_images(cloud, picked)



def normalize_images(
    images: np.ndarray,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
) -> np.ndarray:
    """ToFloatImage + Normalize (image.py:1221,1235) — ImageNet statistics."""
    integer = np.issubdtype(np.asarray(images).dtype, np.integer)
    img = np.asarray(images, np.float32)
    if integer or (img.size and img.max() > 1.5):
        img = img / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)



def _select_cloud_images(cloud: dict, keep: np.ndarray) -> dict:
    out = dict(cloud)
    if cloud.get("mapping") is not None:
        out["mapping"] = cloud["mapping"].select_images(keep).compact()
    if cloud.get("images") is not None:
        out["images"] = cloud["images"][keep]
    if cloud.get("image_family") is not None:
        out["image_family"] = np.asarray(cloud["image_family"])[keep]
    if cloud.get("cameras") is not None:
        out["cameras"] = [cloud["cameras"][i] for i in keep]
    if cloud.get("cam_pos") is not None:
        out["cam_pos"] = np.asarray(cloud["cam_pos"])[keep]
    return out
