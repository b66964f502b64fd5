"""Shared dataset machinery: preprocess caches, sphere sampling, batching.

The port of ``deepviewagg_tpu/data/datasets/base.py`` (the reference's L2
data engine, SURVEY.md §2.5): one-time preprocessing (voxelize + PCA
features + mapping factory) into per-area ``.npz`` caches in the JAX
package's format (a cache written by either package loads in the other),
class-balanced random spheres at train time and fixed grid spheres at eval
(S3DISSphereMM, s3dis.py:622-757), and ``BatchLoader``, which fills
fixed-capacity buckets greedily, splits over-cap samples and prefetches one
batch on a worker thread.  Everything here is host numpy; batches leave as
numpy and :func:`~deepviewagg_tpu_torch.data.collate.batch_to_torch` moves
them.  The same ``seed`` gives the same samples and batches as the JAX
package, the recipe's roll, flip, mapping-jitter and radiometric
augmentations included.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ...native import images as native_images
from ...utils import trace
from ..collate import Bucket, Sample, collate
from ..mapping import MultiViewMapping
from .. import transforms2d, transforms3d

__all__ = ["AreaCache", "SphereDataset", "BatchLoader", "save_area",
           "load_area", "dataset_aug_kwargs", "build_augment"]


def dataset_aug_kwargs(aug_params: Optional[Dict], train: bool) -> Dict:
    """Ingested ``aug_params`` (reference_ingest.load_data_cfg) ->
    :class:`SphereDataset` field overrides.

    Selection/roll knobs apply to train AND eval (the reference's
    test_transforms run CenterRoll / PickImagesFromMappingArea /
    PickImagesFromMemoryCredit too, s3disfused-sparse.yaml:172-186);
    stochastic augmentations are train-only."""
    ap = aug_params or {}
    out: Dict = {}
    for src, dst in (("k_coverage", "k_coverage"),
                     ("roll_angular_res", "roll_angular_res"),
                     ("use_bbox", "use_bbox_area_pick"),
                     ("center_roll", "center_roll")):
        if src in ap:
            out[dst] = ap[src]
    if train:
        for src, dst in (("jitter_mapping", "jitter_mapping"),
                         ("jitter_clip", "jitter_clip"),
                         ("flip_p", "flip_p")):
            if src in ap:
                out[dst] = ap[src]
        if "color_jitter" in ap:
            out["color_jitter"] = tuple(ap["color_jitter"])
    return out


def build_augment(aug_params: Optional[Dict],
                  default: Optional[transforms3d.Compose]):
    """Ingested 3D augmentation params -> a transform chain; falls back to
    the dataset's published default chain when no params were ingested."""
    ap = aug_params or {}
    if not any(k in ap for k in ("noise_sigma", "rotate_axis", "scales",
                                 "symmetry_axes")):
        return default
    tfs: List = []
    if ap.get("noise_sigma"):
        tfs.append(transforms3d.RandomNoise(sigma=ap["noise_sigma"]))
    axis = {0: "x", 1: "y", 2: "z"}.get(int(ap.get("rotate_axis", 2)), "z")
    degrees = ap.get("rotate_degrees")
    # the reference's degrees=180 means uniform in [-180, 180] — a full
    # circle, the RandomRotate(degrees=None) default
    tfs.append(transforms3d.RandomRotate(
        axis=axis,
        degrees=None if degrees in (None, 180, 180.0) else degrees))
    if "scales" in ap:
        lo, hi = ap["scales"][0], ap["scales"][-1]
        tfs.append(transforms3d.RandomScaleAnisotropic(lo, hi))
    if "symmetry_axes" in ap:
        tfs.append(transforms3d.RandomSymmetry(tuple(ap["symmetry_axes"])))
    return transforms3d.Compose(tfs)


def _images_sidecar(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + "_images.npy"


# Preprocessing cache version: bump whenever the OUTPUT of area
# preprocessing changes (mapping features, voxelization, feature order...).
# The reference warns when a dataset's stored pre_transform differs from
# the configured one (torch_points3d/datasets/base_dataset.py pre_transform
# hash check); without a stamp a stale cache silently serves old mappings
# — e.g. round 5's inf-density fix was invisible under a pre-fix cache.
# v2: density guard covers all non-finite values (mapping_factory.py).
PREPROC_VERSION = 2


def stale_area_cache(path: str) -> bool:
    """True if ``path`` exists but was written by a different preprocessing
    version (a cache build should redo it instead of skipping it)."""
    if not os.path.exists(path):
        return False
    try:
        with np.load(path, allow_pickle=True) as z:
            if "_preproc_version" not in z.files:
                return True
            return int(z["_preproc_version"]) != PREPROC_VERSION
    except Exception:
        return True  # unreadable/partial file: rebuild


def save_area(path: str, cloud: Dict) -> None:
    """Serialize a preprocessed area/scan/window: voxelized cloud + mapping
    arrays + images (or image paths).

    uint8 image stacks go to an UNCOMPRESSED ``<area>_images.npy`` sidecar
    that ``load_area`` memory-maps — images never need to be resident in
    RAM, and per-getitem fancy-indexing reads only the selected images'
    pages (the reference keeps images on disk and loads per getitem,
    image.py:973-1102; at its ≥400 GB dataset scale an in-RAM float32 bake
    is impossible)."""
    m: Optional[MultiViewMapping] = cloud.get("mapping")
    payload = {k: v for k, v in cloud.items()
               if isinstance(v, np.ndarray) and k != "mapping"}
    imgs = payload.get("images")
    if isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8:
        np.save(_images_sidecar(path), payload.pop("images"))
    if m is not None:
        for f in ("point_id", "image_id", "view_feats", "view_valid",
                  "pix_view", "pix_x", "pix_y", "pix_valid"):
            payload[f"mapping_{f}"] = getattr(m, f)
        payload["mapping_meta"] = np.array([m.num_points, m.num_images])
    if cloud.get("image_paths") is not None:
        payload["image_paths"] = np.array(cloud["image_paths"], dtype=object)
    payload["_preproc_version"] = np.array(PREPROC_VERSION)
    np.savez_compressed(path, **payload)


def load_area(path: str) -> Dict:
    z = np.load(path, allow_pickle=True)
    stored = int(z["_preproc_version"]) if "_preproc_version" in z.files \
        else None
    if stored != PREPROC_VERSION:
        import warnings

        warnings.warn(
            f"{path}: preprocessed with version {stored}, code is at "
            f"{PREPROC_VERSION} — delete the cache (and its _images.npy "
            "sidecar) to re-preprocess", stacklevel=2)
    cloud = {}
    mapping_fields = {}
    for k in z.files:
        if k == "_preproc_version":
            pass
        elif k.startswith("mapping_") and k != "mapping_meta":
            mapping_fields[k[len("mapping_"):]] = z[k]
        elif k == "mapping_meta":
            pass
        elif k == "image_paths":
            cloud[k] = list(z[k])
        else:
            cloud[k] = z[k]
    if mapping_fields:
        n_pts, n_img = z["mapping_meta"]
        cloud["mapping"] = MultiViewMapping(
            num_points=int(n_pts), num_images=int(n_img), **mapping_fields
        )
    sidecar = _images_sidecar(path)
    if "images" not in cloud and os.path.exists(sidecar):
        cloud["images"] = np.load(sidecar, mmap_mode="r")
    return cloud


class AreaCache:
    """Lazily-loaded preprocessed areas with an LRU bound — generalizes the
    KITTI-360 ``WindowBuffer`` (kitti360.py:146) to every dataset."""

    def __init__(self, paths: Sequence[str], max_loaded: int = 2,
                 loader: Callable[[str], Dict] = load_area):
        self.paths = list(paths)
        self.max_loaded = max_loaded
        self.loader = loader
        self._cache: Dict[str, Dict] = {}
        self._order: List[str] = []

    def __len__(self):
        return len(self.paths)

    def get(self, idx: int) -> Dict:
        path = self.paths[idx]
        if path not in self._cache:
            if len(self._order) >= self.max_loaded:
                evict = self._order.pop(0)
                del self._cache[evict]
            self._cache[path] = self.loader(path)
            self._order.append(path)
        else:
            self._order.remove(path)
            self._order.append(path)
        return self._cache[path]


@dataclasses.dataclass
class SphereDataset:
    """Random class-balanced spheres at train time; fixed grid spheres at
    eval (S3DISSphereMM semantics, s3dis.py:622-757).

    ``areas`` is an AreaCache of preprocessed clouds (each with pos/rgb/
    labels/mapping/images).  ``__getitem__`` runs: sphere select -> 3D
    augment -> quantize -> image selection -> Sample.
    """

    areas: AreaCache
    radius: float = 2.0
    voxel_size: float = 0.05
    num_classes: int = 13
    train: bool = True
    augment: Optional[transforms3d.Compose] = None
    image_slots: int = 4
    min_points_per_image: int = 32
    eval_grid_step: Optional[float] = None   # defaults to radius
    samples_per_epoch: int = 2000
    seed: int = 0
    select_shape: str = "sphere"             # 'sphere' | 'cylinder'
    center_roll: bool = False                # equirect roll centering
    roll_angular_res: int = 16               # CenterRoll angular_res
    flip_p: float = 0.0                      # horizontal flip probability
    jitter_mapping: float = 0.0              # view-feature jitter sigma
    jitter_clip: float = 0.03                # jitter noise clamp (ref :934)
    k_coverage: float = 2.0                  # PickImagesFromMemoryCredit
    use_bbox_area_pick: bool = False         # PickImagesFromMappingArea
    # radiometric augmentation (ref ColorJitter in every flagship recipe,
    # s3disfused-sparse.yaml:162: brightness/contrast/saturation)
    color_jitter: Optional[Sequence[float]] = None
    blur_p: float = 0.0                      # GaussianBlur probability
    # camera-family native sizes [(w, h), ...] when samples carry
    # image_family (per-family shape buckets, ref SameSettingImageData
    # settings groups image.py:1208-1219); None = single image shape
    image_families: Optional[Sequence[Sequence[int]]] = None
    # Point Transformer V3's crop: the point_max cells nearest a centre
    # (a uniformly drawn point at train time, the grid centre at eval)
    # instead of the radius; 0 = off
    point_max: int = 0
    # the points' features: colour and a column of ones ("rgb1"), or
    # colour * 2 - 1 (Pointcept's 8-bit colour / 127.5 - 1) and the normal
    # ("color_normal")
    point_feats: str = "rgb1"

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._centers = None          # eval: (area_idx, center) list
        self._class_centers = None    # train: per-class candidate centers
        self._warned_normalized_cache = False

    # -- center selection ---------------------------------------------------
    def _build_eval_centers(self):
        step = self.eval_grid_step or self.radius
        centers = []
        for ai in range(len(self.areas)):
            cloud = self.areas.get(ai)
            pos = cloud["pos"]
            grid = np.floor(pos[:, :2] / step).astype(np.int64)
            _, first = np.unique(grid, axis=0, return_index=True)
            for i in first:
                centers.append((ai, pos[i].copy()))
        self._centers = centers

    def _random_center(self):
        """Class-balanced: pick a class, then a random point of that class
        (s3dis.py:671-704)."""
        ai = int(self._rng.integers(len(self.areas)))
        cloud = self.areas.get(ai)
        labels = cloud["labels"]
        cls = int(self._rng.integers(self.num_classes))
        idx = np.nonzero(labels == cls)[0]
        if len(idx) == 0:
            idx = np.arange(len(labels))
        i = int(self._rng.choice(idx))
        return ai, cloud["pos"][i].copy()

    def __len__(self):
        if self.train:
            return self.samples_per_epoch
        if self._centers is None:
            self._build_eval_centers()
        return len(self._centers)

    def __getitem__(self, idx: int) -> Optional[Sample]:
        if self.train and self.point_max:
            ai = int(self._rng.integers(len(self.areas)))
            center = None
        elif self.train:
            ai, center = self._random_center()
        else:
            if self._centers is None:
                self._build_eval_centers()
            ai, center = self._centers[idx]
        with trace.span("sample.select3d"):
            cloud = self.areas.get(ai)
            select = (transforms3d.cylinder_select
                      if self.select_shape == "cylinder"
                      else transforms3d.sphere_select)
            if self.point_max:
                sub = transforms3d.sphere_crop_count(
                    cloud, self.point_max, self._rng, center)
            else:
                sub = select(cloud, center, self.radius)
            if len(sub["pos"]) < 16:
                return None
            if self.train and self.augment is not None:
                sub = self.augment(sub, self._rng)
            sub = transforms3d.quantize_cloud(sub, self.voxel_size)
        with trace.span("sample.images"):
            sub, normalize, jitter = self._images(sub)
        if normalize is not None:
            imgs = sub["images"]
            with trace.span("sample.normalize"):
                # materialize only the selected slots as normalized float32;
                # the native pass gives the numpy chain's bytes
                if normalize == "fused":
                    sub["images"] = native_images.jitter_normalize(
                        imgs, jitter)
                else:
                    sub["images"] = transforms2d.normalize_images(imgs)
                trace.count("images." + normalize, len(imgs))
        rgb = sub.get("rgb", np.zeros((len(sub["pos"]), 3), np.float32))
        if self.point_feats == "color_normal":
            feats = np.concatenate(
                [rgb * np.float32(2.0) - np.float32(1.0), sub["normal"]],
                axis=1).astype(np.float32)
        else:
            feats = np.concatenate(
                [rgb, np.ones((len(sub["pos"]), 1), np.float32)], axis=1)
        return Sample(
            coords=sub["coords"], feats=feats, labels=sub.get("labels"),
            images=sub.get("images"), mapping=sub.get("mapping"),
            image_family=sub.get("image_family"),
            pos=sub["pos"], origin_id=sub.get("origin_id"),
            cloud=self.areas.paths[ai],
        )

    def _images(self, sub: Dict):
        """Image picks, centre roll and the 2D augmentations of a sample;
        returns the sample, how its images are to be normalized (None: they
        are not; ``"fused"``: a raw stack that the native pass takes and no
        blur was drawn for; ``"plain"``: the numpy chain) and, when fused,
        the colour jitter drawn but not applied yet (or None)."""
        # Cache taxonomy (ref chain order: ColorJitter -> flip ->
        # ToFloatImage -> Normalize): uint8 and non-negative float caches
        # are RAW — radiometric augments apply and ImageNet normalization
        # runs at the END of the 2D chain; a float cache holding already-
        # NORMALIZED stacks (negative values) gets neither (re-normalizing
        # or jittering it would corrupt the statistics).  Only float caches
        # pay the min() scan; uint8 (the mmap'd format) classifies by dtype.
        imgs0 = sub.get("images")
        already_normalized = (
            imgs0 is not None and imgs0.dtype != np.uint8
            and imgs0.size > 0 and float(imgs0.min()) < -0.01
        )
        needs_normalize = imgs0 is not None and not already_normalized
        radiometric_ok = needs_normalize
        jitter, blur = None, False
        if (already_normalized and self.train
                and (self.color_jitter is not None or self.blur_p > 0)
                and not self._warned_normalized_cache):
            print("[dataset] images are cached pre-normalized: skipping "
                  "color_jitter/gaussian_blur (re-preprocess with the uint8 "
                  "cache to enable them)", file=sys.stderr)
            self._warned_normalized_cache = True
        if sub.get("mapping") is not None:
            sub = transforms2d.pick_images_by_area(
                sub, min_points=self.min_points_per_image,
                use_bbox=self.use_bbox_area_pick,
            )
            if self.center_roll and sub.get("images") is not None:
                # panoramas: circular-roll so mapped pixels center (enables
                # tight crop-ladder buckets)
                sub = transforms2d.center_roll(
                    sub, angular_res=self.roll_angular_res)
            if self.train:
                sub = transforms2d.pick_images_by_credit(
                    sub, n_slots=self.image_slots,
                    k_coverage=self.k_coverage, rng=self._rng
                )
                if self.flip_p > 0:
                    sub = transforms2d.random_horizontal_flip(
                        sub, self._rng, p=self.flip_p
                    )
                if self.jitter_mapping > 0:
                    sub = transforms2d.jitter_mapping_features(
                        sub, sigma=self.jitter_mapping,
                        clip=self.jitter_clip, rng=self._rng
                    )
                if (self.color_jitter is not None and radiometric_ok
                        and sub.get("images") is not None):
                    jitter = transforms2d.draw_color_jitter(
                        self._rng, len(sub["images"]), *self.color_jitter
                    )
                blur = (self.blur_p > 0 and radiometric_ok
                        and sub.get("images") is not None
                        and self._rng.uniform() < self.blur_p)
                if jitter is not None and (
                        blur or not native_images.takes(sub["images"])):
                    # the numpy chain: before a blur, or for a stack the
                    # native pass does not take
                    sub["images"] = transforms2d.apply_color_jitter(
                        sub["images"], jitter)
                    jitter = None
                if blur:
                    sub["images"] = transforms2d.gaussian_blur(
                        sub["images"], self._rng
                    )
            else:
                # eval: deterministic max-coverage selection under the
                # PIXEL budget (the reference applies its memory credit at
                # eval too, PickImagesFromMemoryCredit image.py:765-874);
                # budget = image_slots x base-image pixels, per-image cost
                # from the camera-family size when families exist
                fam = sub.get("image_family")
                if fam is not None and self.image_families is not None:
                    unit = int(np.prod(self.image_families[0]))
                    image_px = np.array(
                        [int(np.prod(self.image_families[int(f)]))
                         for f in fam], np.int64)
                elif sub.get("images") is not None and len(sub["images"]):
                    unit = int(np.prod(sub["images"].shape[1:3]))
                    image_px = np.full(sub["mapping"].num_images, unit,
                                       np.int64)
                else:
                    unit, image_px = 1, np.ones(
                        sub["mapping"].num_images, np.int64)
                budget = self.image_slots * unit
                if image_px.sum() > budget:
                    keep = transforms2d.select_images_by_credit(
                        sub["mapping"], budget, image_px
                    )
                    sub = transforms2d._select_cloud_images(sub, keep)
        imgs = sub.get("images")
        if not needs_normalize or imgs is None:
            return sub, None, None
        if blur or not native_images.takes(imgs):
            return sub, "plain", None
        return sub, "fused", jitter


class BatchLoader:
    """Collate a SphereDataset into bucket-shaped device batches.

    Greedy filling: accumulate samples until any capacity (voxels / views /
    pixels / images) would overflow, then emit.  The static-shape replacement
    for the reference's dynamic DataLoader batching.
    """

    def __init__(self, dataset, bucket: Bucket, batch_size: int,
                 branch_levels: Sequence[int] = (), shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 conv0_kernel: int = 3, graph: str = "unet"):
        self.dataset = dataset
        self.bucket = bucket
        self.batch_size = batch_size
        self.branch_levels = list(branch_levels)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.conv0_kernel = conv0_kernel
        self.graph = graph
        self._rng = np.random.default_rng(seed)
        # over-cap handling diagnostics (samples are split, never silently
        # dropped — VERDICT r1: dropping over-cap eval spheres biases mIoU)
        self.stats = {"split": 0, "dropped": 0}

    def _fits(self, group: List[Sample], s: Sample) -> bool:
        n0 = sum(len(g.coords) for g in group) + len(s.coords)
        if n0 > self.bucket.level_caps[0]:
            return False
        if s.mapping is not None:
            views = sum(g.mapping.num_views for g in group) + s.mapping.num_views
            pix = sum(g.mapping.num_pixels for g in group) + s.mapping.num_pixels
            imgs = sum(len(g.images) for g in group) + len(s.images)
            if views > self.bucket.view_cap or pix > self.bucket.pix_cap:
                return False
            if imgs > self.bucket.image_cap:
                return False
        return True

    def _split_sample(self, s: Sample, depth: int = 0) -> List[Sample]:
        """Bisect an over-cap sample along its longest axis until every part
        fits the bucket alone.  The reference scores every point (fixed eval
        grid, trackers over full clouds); silently dropping over-cap spheres
        would bias mIoU, so splitting — with mapping/image subsets carried
        through ``select_points``/``select_images`` — is the static-shape
        equivalent."""
        if self._fits([], s):
            return [s]
        if depth == 0:
            with trace.span("loader.split"):
                return self._split_parts(s, depth)
        return self._split_parts(s, depth)

    def _split_parts(self, s: Sample, depth: int) -> List[Sample]:
        """The parts of an over-cap sample (:meth:`_split_sample`)."""
        import dataclasses as _dc
        import warnings

        if depth >= 8 or len(s.coords) < 32:
            warnings.warn(
                f"sample with {len(s.coords)} voxels cannot fit bucket caps "
                "even after splitting; dropped"
            )
            self.stats["dropped"] += 1
            return []
        spans = s.coords.max(axis=0) - s.coords.min(axis=0)
        ax = int(np.argmax(spans))
        cut = np.median(s.coords[:, ax])
        left = s.coords[:, ax] <= cut
        if left.all() or not left.any():
            order = np.argsort(s.coords[:, ax], kind="stable")
            left = np.zeros(len(s.coords), bool)
            left[order[: len(order) // 2]] = True
        self.stats["split"] += 1
        parts: List[Sample] = []
        for mask in (left, ~left):
            idx = np.nonzero(mask)[0]
            if len(idx) == 0:
                continue
            images, mapping, family = s.images, s.mapping, s.image_family
            if mapping is not None:
                m = mapping.select_points(idx).compact()
                # drop images no surviving view references (an empty image
                # set stays a valid, zero-image mapping for collate)
                keep = np.unique(m.image_id[m.view_valid])
                mapping = m.select_images(keep).compact()
                images = s.images[keep]
                if family is not None:
                    family = np.asarray(family)[keep]
            parts.extend(self._split_sample(_dc.replace(
                s,
                coords=s.coords[idx],
                feats=s.feats[idx],
                labels=None if s.labels is None else s.labels[idx],
                pos=None if s.pos is None else s.pos[idx],
                origin_id=None if s.origin_id is None else s.origin_id[idx],
                images=images,
                mapping=mapping,
                image_family=family,
            ), depth + 1))
        return parts

    def _collate(self, group: List[Sample]) -> Dict:
        with trace.span("loader.collate"):
            return collate(group, self.bucket, self.branch_levels,
                           conv0_kernel=self.conv0_kernel, graph=self.graph)

    def _iter_sync(self) -> Iterator[Dict]:
        """The pass's batches in order.  The work of the k-th, from the
        hand-over of the one before to this one being ready, is its
        ``loader.produce`` span: its samples, splits and collate, the spans
        of this thread carrying batch index ``k`` (``utils/trace.py``)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        group: List[Sample] = []
        k = 0
        trace.set_batch(k)
        produce = trace.span("loader.produce").__enter__()

        def ready():
            nonlocal produce
            done, produce = produce, None
            done.__exit__(None, None, None)

        try:
            for i in order:
                with trace.span("loader.sample"):
                    s0 = self.dataset[int(i)]
                if s0 is None:
                    continue
                for s in self._split_sample(s0):
                    if len(group) == self.batch_size or (
                        group and not self._fits(group, s)
                    ):
                        batch = self._collate(group)
                        ready()
                        yield batch
                        k += 1
                        trace.set_batch(k)
                        produce = trace.span("loader.produce").__enter__()
                        group = []
                    group.append(s)
            if group and not self.drop_last:
                batch = self._collate(group)
                ready()
                yield batch
        finally:
            if produce is not None:
                ready()

    def __iter__(self) -> Iterator[Dict]:
        """Prefetch one batch ahead on a worker thread so host collate
        (voxel hashing, mapping reindex) overlaps device compute — the role
        of the reference's DataLoader workers (base_dataset.py:211-288).  An
        error of the worker is raised in the consumer; a consumer that stops
        early stops the worker.  The worker's time blocked on a full queue
        is its ``loader.put_wait`` span, the consumer's wait for the k-th
        batch its ``loader.get`` span (batch index ``k``: the queue is
        first in, first out)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = object()
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in self._iter_sync():
                    trace.count("loader.batches")
                    with trace.span("loader.put_wait"):
                        handed = put(b)
                    if not handed:
                        return
                put(stop)
            except BaseException as e:  # surface errors in the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="BatchLoader")
        t.start()
        try:
            k = 0
            while True:
                trace.set_batch(k)
                with trace.span("loader.get"):
                    starved = trace.enabled() and q.empty()
                    b = q.get()
                if b is stop:
                    break
                if isinstance(b, BaseException):
                    raise b
                if starved:
                    trace.count("loader.starved")
                yield b
                k += 1
        finally:
            closed.set()
            t.join()
