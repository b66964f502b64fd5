"""Runtime image/mapping selection transforms, host numpy.

The port of the part of ``deepviewagg_tpu/data/transforms2d.py`` that
``SphereDataset.__getitem__`` reaches by default (the reference's
__getitem__-time 2D chain, core/data_transform/multimodal/image.py):

  * :func:`pick_images_by_area` — ``PickImagesFromMappingArea`` (:713);
  * :func:`pick_images_by_credit` — ``PickImagesFromMemoryCredit`` (:765),
    the train-time stochastic knapsack, and :func:`select_images_by_credit`
    / :func:`select_images_by_coverage`, its deterministic eval-time form;
  * :func:`normalize_images` (``ToFloatImage`` + ``Normalize``);
  * :func:`center_roll` (``CenterRoll``, :962), :func:`random_horizontal_flip`
    (``RandomHorizontalFlip``, :1195), :func:`jitter_mapping_features`
    (``JitterMappingFeatures``, :934), and the radiometric
    :func:`color_jitter` / :func:`gaussian_blur` (:1249-1269): the S3DIS
    recipe's options.

Then the rest of the JAX module: the static crop :func:`crop_images`
(``CropImageGroups``' single-size stand-in, :1040), :func:`non_static_mask`
/ :func:`mask_mapping_pixels` (``NonStaticMask``, :106, which the S3DIS
preprocess applies), the image-set reductions :func:`drop_images_outside_bbox`
/ :func:`pick_k_images` / :func:`grid_sample_images` (:647-712), the pixel
coordinate channels :func:`add_pixel_height_feature` /
:func:`add_pixel_width_feature` (:1163-1192) and
:func:`pick_mappings_by_features` (:877).

Copied so that the same ``np.random.Generator`` draws give the same arrays
(the draws are made in the same order).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .mapping import MultiViewMapping

__all__ = [
    "pick_images_by_area",
    "pick_images_by_credit",
    "select_images_by_coverage",
    "select_images_by_credit",
    "normalize_images",
    "jitter_mapping_features",
    "center_roll",
    "random_horizontal_flip",
    "color_jitter",
    "draw_color_jitter",
    "apply_color_jitter",
    "gaussian_blur",
    "crop_images",
    "non_static_mask",
    "mask_mapping_pixels",
    "drop_images_outside_bbox",
    "pick_k_images",
    "grid_sample_images",
    "add_pixel_height_feature",
    "add_pixel_width_feature",
    "pick_mappings_by_features",
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


def jitter_mapping_features(
    cloud: dict, sigma: float = 0.02, clip: float = 0.03,
    rng: Optional[np.random.Generator] = None
) -> dict:
    """Clamped gaussian jitter on the viewing-condition features
    (JitterMappingFeatures, image.py:934-957: sigma=0.02, noise clamped to
    +-clip=0.03)."""
    m: MultiViewMapping = cloud["mapping"]
    out = dict(cloud)
    noise = rng.normal(0, sigma, m.view_feats.shape)
    feats = m.view_feats + np.clip(noise, -clip, clip).astype(
        np.float32
    )
    out["mapping"] = dataclasses.replace(m, view_feats=feats)
    return out


def center_roll(cloud: dict, angular_res: int = 16) -> dict:
    """Circular-roll each equirectangular image so its mapped pixels are
    centered (``CenterRoll``, data_transform/multimodal/image.py:962-1037):
    among ``angular_res`` candidate rolls (256-bin coordinates), pick the one
    minimizing ``span + |center - 128|`` of the mapped x coordinates; roll
    pixel mappings and the image columns accordingly.  Enables tight crops
    on panoramas."""
    m: MultiViewMapping = cloud["mapping"]
    if cloud.get("images") is None or m.num_pixels == 0:
        return cloud
    images = cloud["images"]
    w = images.shape[1]
    vc = m.view_capacity
    pv = np.minimum(m.pix_view, vc - 1)
    pix_img = np.where(m.pix_valid, m.image_id[pv], -1)

    new_x = m.pix_x.copy()
    new_images = images.copy()
    candidates = (np.arange(angular_res) * 256) // angular_res
    for i in range(m.num_images):
        sel = pix_img == i
        if not sel.any():
            continue
        bins = (m.pix_x[sel].astype(np.int64) * 256) // w
        best_cost, best_r = None, 0
        for r in candidates:
            rolled = (bins + r) % 256
            lo, hi = rolled.min(), rolled.max()
            cost = (hi - lo) + abs((hi + lo) / 2 - 128)
            if best_cost is None or cost < best_cost:
                best_cost, best_r = cost, int(r)
        shift = (best_r * w) // 256
        if shift == 0:
            continue
        new_x[sel] = (m.pix_x[sel].astype(np.int64) + shift) % w
        new_images[i] = np.roll(images[i], shift, axis=0)
    out = dict(cloud)
    out["mapping"] = dataclasses.replace(m, pix_x=new_x.astype(np.int32))
    out["images"] = new_images
    return out


def random_horizontal_flip(cloud: dict, rng: np.random.Generator,
                           p: float = 0.5) -> dict:
    """Flip images along x and mirror the pixel mappings
    (``RandomHorizontalFlip``, image.py:1195-1219)."""
    if rng.random() > p or cloud.get("images") is None:
        return cloud
    m: MultiViewMapping = cloud["mapping"]
    w = cloud["images"].shape[1]
    out = dict(cloud)
    out["images"] = cloud["images"][:, ::-1].copy()
    out["mapping"] = dataclasses.replace(
        m, pix_x=np.where(m.pix_valid, w - 1 - m.pix_x, m.pix_x).astype(np.int32)
    )
    return out


def crop_images(cloud: dict, crop_size: Tuple[int, int]) -> dict:
    """Crop every image to one static ``(w, h)`` window centered on its
    mapped-pixel bbox; mappings shift into crop coordinates and the few
    pixels falling outside become padding.

    Static-shape stand-in for ``CropImageGroups``' power-of-two families
    (image.py:1040-1141): one bucketed crop size per batch instead of
    per-sample families (SURVEY.md §7 move 1).
    """
    m: MultiViewMapping = cloud["mapping"]
    images = cloud.get("images")
    if images is None:
        return cloud
    full_w, full_h = images.shape[1], images.shape[2]
    cw, ch = crop_size
    if cw >= full_w and ch >= full_h:
        return cloud
    cw, ch = min(cw, full_w), min(ch, full_h)
    vc = m.view_capacity
    pv = np.minimum(m.pix_view, vc - 1)
    pix_img = np.where(m.pix_valid, m.image_id[pv], -1)

    new_images = np.zeros((len(images), cw, ch, images.shape[3]),
                          images.dtype)
    new_x = m.pix_x.copy()
    new_y = m.pix_y.copy()
    keep = m.pix_valid.copy()
    for i in range(m.num_images):
        sel = pix_img == i
        if sel.any():
            # clamp so the crop window [x0, x0+cw) stays inside the image
            # for odd sizes too (x0 <= full_w - cw)
            cx = int(np.clip((m.pix_x[sel].min() + m.pix_x[sel].max()) // 2,
                             cw // 2, full_w - (cw - cw // 2)))
            cy = int(np.clip((m.pix_y[sel].min() + m.pix_y[sel].max()) // 2,
                             ch // 2, full_h - (ch - ch // 2)))
        else:
            cx, cy = cw // 2, ch // 2
        x0, y0 = cx - cw // 2, cy - ch // 2
        new_images[i] = images[i, x0:x0 + cw, y0:y0 + ch]
        nx = m.pix_x[sel] - x0
        ny = m.pix_y[sel] - y0
        inside = (nx >= 0) & (nx < cw) & (ny >= 0) & (ny < ch)
        new_x[sel] = np.clip(nx, 0, cw - 1)
        new_y[sel] = np.clip(ny, 0, ch - 1)
        keep[sel] &= inside
    # invariant: every valid view keeps >= 1 pixel — views whose pixels all
    # fell outside the crop retain their first pixel with clamped coords
    # (the reference sizes crops to contain the bbox, image.py:1082-1118;
    # a static single-size crop can cut corners instead)
    kept_per_view = np.zeros(vc + 1, np.int64)
    np.add.at(kept_per_view, np.where(m.pix_valid, pv, vc), keep.astype(np.int64))
    uviews, first_idx = np.unique(
        np.where(m.pix_valid, pv, vc), return_index=True
    )
    for v, fi in zip(uviews, first_idx):
        if v < vc and m.view_valid[v] and kept_per_view[v] == 0:
            keep[fi] = True

    out = dict(cloud)
    # pixels outside the crop become pads (re-point at view capacity, tail)
    pix_view = np.where(keep, m.pix_view, vc)
    order = np.argsort(pix_view, kind="stable")
    out["mapping"] = dataclasses.replace(
        m,
        pix_view=pix_view[order].astype(np.int32),
        pix_x=new_x[order].astype(np.int32),
        pix_y=new_y[order].astype(np.int32),
        pix_valid=keep[order],
    )
    out["images"] = new_images
    return out


# --------------------------------------------------------------------------
# Radiometric augmentations (reference TorchvisionTransform family,
# image.py:1249-1269 — flagship recipes use ColorJitter(0.6, 0.6, 0.7))
# --------------------------------------------------------------------------

def _to_unit_float(images: np.ndarray) -> np.ndarray:
    img = np.asarray(images, np.float32)
    if img.size and img.min() < -0.01:
        # ImageNet-normalized stacks reach here only through a caller bug —
        # dividing them by 255 silently collapses them to near-black
        raise ValueError(
            "radiometric transform applied to already-normalized images "
            "(negative values present); apply it before normalize_images"
        )
    if np.issubdtype(np.asarray(images).dtype, np.integer) or (
        img.size and img.max() > 1.5
    ):
        img = img / 255.0
    return img


def _grayscale(img: np.ndarray) -> np.ndarray:
    # ITU-R 601 luma, matching torchvision rgb_to_grayscale
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def color_jitter(
    images: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.6,
    contrast: float = 0.6,
    saturation: float = 0.7,
) -> np.ndarray:
    """torchvision-semantics ColorJitter on a [I, W, H, 3] stack in [0, 1]
    (ref image.py:1249: per call one factor per property, uniform in
    [max(0, 1-s), 1+s], applied in random order).  Factors are drawn PER
    IMAGE here — strictly more augmentation diversity at equal cost."""
    return apply_color_jitter(images, draw_color_jitter(
        rng, len(images), brightness, contrast, saturation))


def draw_color_jitter(
    rng: np.random.Generator,
    n: int,
    brightness: float = 0.6,
    contrast: float = 0.6,
    saturation: float = 0.7,
) -> List[Tuple[str, np.ndarray]]:
    """:func:`color_jitter`'s draws for ``n`` images, in its order: the
    order of the ops of non-zero strength, then one float32 ``[n, 1, 1, 1]``
    factor per op as applied.  Returns ``[(op, factor), ...]`` in that
    order, ``op`` one of ``'brightness'``, ``'contrast'``,
    ``'saturation'``."""
    ops = [(op, s) for op, s in (("brightness", brightness),
                                 ("contrast", contrast),
                                 ("saturation", saturation)) if s > 0]
    return [(ops[i][0], rng.uniform(max(0.0, 1.0 - ops[i][1]),
                                    1.0 + ops[i][1], size=(n, 1, 1, 1)
                                    ).astype(np.float32))
            for i in rng.permutation(len(ops))]


def apply_color_jitter(images: np.ndarray,
                       draws: Sequence[Tuple[str, np.ndarray]]) -> np.ndarray:
    """:func:`color_jitter` with its draws made beforehand
    (:func:`draw_color_jitter`)."""
    img = _to_unit_float(images)
    for op, fac in draws:
        if op == "brightness":
            img = img * fac
        elif op == "contrast":
            mean = _grayscale(img).mean(axis=(1, 2, 3), keepdims=True)
            img = (img - mean) * fac + mean
        else:
            g = _grayscale(img)
            img = img * fac + g * (1.0 - fac)
    return np.clip(img, 0.0, 1.0)


def gaussian_blur(
    images: np.ndarray,
    rng: np.random.Generator,
    kernel_size: int = 9,
    sigma: Tuple[float, float] = (0.1, 2.0),
) -> np.ndarray:
    """Separable Gaussian blur with a per-call random sigma
    (ref GaussianBlur, image.py:1262: torchvision T.GaussianBlur)."""
    img = _to_unit_float(images)
    s = float(rng.uniform(*sigma))
    half = kernel_size // 2
    xs = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / s) ** 2)
    k /= k.sum()

    def conv_axis(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (half, half)
        xp = np.pad(x, pad, mode="edge")
        out = np.zeros_like(x)
        for i, w in enumerate(k):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + x.shape[axis])
            out += w * xp[tuple(sl)]
        return out

    return conv_axis(conv_axis(img, 1), 2)


def non_static_mask(images: np.ndarray, n_sample: int = 5,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """bool [W, H]: pixels that DIFFER somewhere across ``n_sample`` images
    (ref NonStaticMask, image.py:106-158: static pixels — e.g. the capture
    rig in equirectangular panoramas — are identical in every image and
    must not contribute mappings)."""
    n = min(n_sample, len(images))
    w, h = images.shape[1], images.shape[2]
    if n < 2:
        return np.ones((w, h), bool)
    rng = rng or np.random.default_rng(0)
    idx = rng.choice(len(images), size=n, replace=False)
    ref = images[idx[0]]
    mask = np.zeros((w, h), bool)
    for i in idx[1:]:
        mask |= (images[i] != ref).any(axis=-1)
    return mask


def mask_mapping_pixels(cloud: dict, mask: np.ndarray) -> dict:
    """Invalidate mapping pixels falling on masked-out (static) pixels —
    the consumption side of :func:`non_static_mask` (the reference bakes the
    mask into projection, image.py:158)."""
    m: MultiViewMapping = cloud["mapping"]
    keep = mask[np.clip(m.pix_x, 0, mask.shape[0] - 1),
                np.clip(m.pix_y, 0, mask.shape[1] - 1)]
    out = dict(cloud)
    out["mapping"] = m.drop_pixels(keep)
    return out


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


def drop_images_outside_bbox(cloud: dict, margin: float = 0.0,
                             ignore_z: bool = False) -> dict:
    """Drop images whose camera sits outside the cloud's bounding box
    (+margin/2 per side) — ref DropImagesOutsideDataBoundingBox
    (image.py:647-664).  Camera positions come from ``cloud['cam_pos']``
    [I, 3] or ``cloud['cameras']``."""
    cam_pos = cloud.get("cam_pos")
    if cam_pos is None:
        cam_pos = np.stack([c.pos for c in cloud["cameras"]])
    cam_pos = np.asarray(cam_pos, np.float32)
    b_min = cloud["pos"].min(axis=0) - margin / 2
    b_max = cloud["pos"].max(axis=0) + margin / 2
    inside = (cam_pos > b_min) & (cam_pos < b_max)
    dims = 2 if ignore_z else 3
    keep = np.nonzero(inside[:, :dims].all(axis=1))[0]
    return _select_cloud_images(cloud, keep)


def pick_k_images(cloud: dict, k: int, random: bool = False,
                  rng: Optional[np.random.Generator] = None) -> dict:
    """Keep K images: random without replacement, or one-every-K strided
    (ref PickKImages, image.py:689-712 — note the strided branch keeps
    every k-th image, matching ``slice(0, n, k)``)."""
    m: MultiViewMapping = cloud["mapping"]
    if random:
        rng = rng or np.random.default_rng(0)
        keep = np.sort(rng.choice(m.num_images, size=min(k, m.num_images),
                                  replace=False))
    else:
        keep = np.arange(0, m.num_images, k)
    return _select_cloud_images(cloud, keep)


def grid_sample_images(cloud: dict, size: float) -> dict:
    """Keep one image per ``size``-cell of camera positions (mode='last') —
    ref GridSampleImages (image.py:669-686): close-by redundant viewpoints
    collapse to a single representative."""
    cam_pos = cloud.get("cam_pos")
    if cam_pos is None:
        cam_pos = np.stack([c.pos for c in cloud["cameras"]])
    cells = np.floor(np.asarray(cam_pos, np.float64) / size).astype(np.int64)
    # last image per cell (stable unique on reversed order)
    _, first_rev = np.unique(cells[::-1], axis=0, return_index=True)
    keep = np.sort(len(cells) - 1 - first_rev)
    return _select_cloud_images(cloud, keep)


def add_pixel_height_feature(images: np.ndarray) -> np.ndarray:
    """Append a [0, 1] row-coordinate channel (ref AddPixelHeightFeature,
    image.py:1163-1176).  Images are [I, W, H, C]; "height" is the H axis.
    (The reference's PadImages, image.py:1153, is an empty stub — not
    replicated.)"""
    img = np.asarray(images, np.float32)
    i, w, h, _ = img.shape
    feat = np.broadcast_to(
        np.linspace(0.0, 1.0, h, dtype=np.float32)[None, None, :, None],
        (i, w, h, 1),
    )
    return np.concatenate([img, feat], axis=3)


def add_pixel_width_feature(images: np.ndarray) -> np.ndarray:
    """Append a [0, 1] column-coordinate channel (ref AddPixelWidthFeature,
    image.py:1179-1192)."""
    img = np.asarray(images, np.float32)
    i, w, h, _ = img.shape
    feat = np.broadcast_to(
        np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None, None],
        (i, w, h, 1),
    )
    return np.concatenate([img, feat], axis=3)


def pick_mappings_by_features(cloud: dict, feat, lower=None,
                              upper=None) -> dict:
    """``PickMappingsFromMappingFeatures`` (image.py:877-933): drop views
    whose mapping feature ``feat[i]`` falls outside the open interval
    (lower[i], upper[i]); views keep the reference's strict-inequality
    semantics.  Points that lose every view become unseen."""
    m: MultiViewMapping = cloud["mapping"]

    def _san(x, n):
        if x is None:
            return [None] * n
        if not isinstance(x, (list, tuple)):
            x = [x]
        return list(x)

    feat = _san(feat, 0)
    lower = _san(lower, len(feat))
    upper = _san(upper, len(feat))
    assert len(lower) == len(feat) and len(upper) == len(feat)
    keep = np.ones(m.view_capacity, bool)
    for i, lo, up in zip(feat, lower, upper):
        if lo is not None:
            keep &= m.view_feats[:, i] > lo
        if up is not None:
            keep &= m.view_feats[:, i] < up
    out = dict(cloud)
    out["mapping"] = m.drop_views(keep)
    return out
