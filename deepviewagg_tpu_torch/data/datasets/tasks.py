"""Non-segmentation task datasets: classification, detection, panoptic,
registration.

The port of ``deepviewagg_tpu/data/datasets/tasks.py`` (the reference ships
full dataset machinery per task,
``datasets/{classification,object_detection,panoptic,registration}/``:
ModelNet OFF meshes, ScanNet boxes, panoptic instance ids, 3DMatch fragment
pairs).  Each task gets one loader that (a) reads the on-disk layout when
``root`` holds it (``<class>/<train|test>/*.off``, ``scene_*.npz``,
``pair_*.npz``), (b) otherwise generates procedural data from the synthetic
scene engine, so that every head trains end to end without downloads.
Items and collates are the JAX package's arrays, byte for byte, but for the
detection graph's neighbour tables (FPS and ball queries through
:mod:`...ops.spatial`, on CPU tensors).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...nn.pointnet2 import build_pointnet_graph
from ...ops import spatial as sp
from ...ops import voxel as _voxel
from .. import synthetic
from ..collate import Bucket, Sample, collate, device_view

__all__ = [
    "make_classification_dataset", "make_detection_dataset",
    "make_panoptic_dataset", "make_registration_dataset",
    "sample_off_mesh", "MODELNET_SYNTH_CLASSES",
]


# ==========================================================================
# Classification (ref datasets/classification/modelnet.py: ModelNet OFF
# meshes, per-mesh surface sampling, per-sample class label)
# ==========================================================================

MODELNET_SYNTH_CLASSES = (
    "box", "sphere", "cylinder", "cone", "torus", "plane", "pyramid", "cross",
)


def sample_off_mesh(path: str, n_points: int = 1024,
                    seed: int = 0) -> np.ndarray:
    """Area-weighted surface sampling of an OFF mesh (the reference relies
    on torch_geometric's ModelNet sampling; same math)."""
    with open(path) as f:
        header = f.readline().strip()
        if header != "OFF":
            # some ModelNet files glue counts onto the OFF line
            counts = header[3:].split()
        else:
            counts = f.readline().split()
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.array(
            [[float(x) for x in f.readline().split()[:3]] for _ in range(nv)],
            np.float32,
        )
        faces = []
        for _ in range(nf):
            row = f.readline().split()
            k = int(row[0])
            poly = [int(i) for i in row[1:k + 1]]
            for j in range(1, k - 1):   # fan-triangulate
                faces.append((poly[0], poly[j], poly[j + 1]))
    faces = np.asarray(faces, np.int64)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(faces), size=n_points, p=p)
    u, v = rng.uniform(0, 1, (2, n_points, 1)).astype(np.float32)
    flip = (u + v) > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    return (a[tri] + u * (b[tri] - a[tri]) + v * (c[tri] - a[tri]))


def _synth_shape(cls: int, rng: np.random.Generator,
                 n: int = 1024) -> np.ndarray:
    """Procedural point clouds, one shape family per class."""
    u = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    v = rng.uniform(-1, 1, n).astype(np.float32)
    name = MODELNET_SYNTH_CLASSES[cls]
    if name == "box":
        p, _ = synthetic._box(rng, (0, 0, 0), rng.uniform(0.6, 1.4, 3),
                              density=n, color=np.zeros(3))
        idx = rng.choice(len(p), n, replace=len(p) < n)
        pts = p[idx]
    elif name == "sphere":
        z = v
        r = np.sqrt(np.maximum(0, 1 - z ** 2))
        pts = np.stack([r * np.cos(u), r * np.sin(u), z], 1)
    elif name == "cylinder":
        pts = np.stack([np.cos(u), np.sin(u), v], 1)
    elif name == "cone":
        h = rng.uniform(0, 1, n).astype(np.float32)
        pts = np.stack([(1 - h) * np.cos(u), (1 - h) * np.sin(u), h], 1)
    elif name == "torus":
        w = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        pts = np.stack([(1 + 0.3 * np.cos(w)) * np.cos(u),
                        (1 + 0.3 * np.cos(w)) * np.sin(u),
                        0.3 * np.sin(w)], 1)
    elif name == "plane":
        pts = np.stack([v, rng.uniform(-1, 1, n), 0.02 * rng.normal(size=n)], 1)
    elif name == "pyramid":
        h = rng.uniform(0, 1, n).astype(np.float32)
        s = 1 - h
        pts = np.stack([s * rng.uniform(-1, 1, n), s * rng.uniform(-1, 1, n),
                        h], 1)
    else:  # cross: two orthogonal slabs
        half = n // 2
        x = np.concatenate([rng.uniform(-1, 1, half),
                            rng.uniform(-0.2, 0.2, n - half)])
        y = np.concatenate([rng.uniform(-0.2, 0.2, half),
                            rng.uniform(-1, 1, n - half)])
        pts = np.stack([x, y, rng.uniform(-0.2, 0.2, n)], 1)
    pts = pts.astype(np.float32)
    # random rotation + scale, like ModelNet training augmentation
    theta = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                    [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    return (pts @ rot.T) * rng.uniform(0.8, 1.2)


@dataclasses.dataclass
class ClassificationDataset:
    """ModelNet layout ``root/<class>/<train|test>/*.off`` when present,
    procedural shapes otherwise."""

    root: Optional[str]
    train: bool = True
    n_points: int = 1024
    voxel_size: float = 0.05
    samples_per_epoch: int = 512
    seed: int = 0

    def __post_init__(self):
        self.files: List[Tuple[str, int]] = []
        self.classes: Sequence[str] = MODELNET_SYNTH_CLASSES
        if self.root and os.path.isdir(self.root):
            names = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            )
            split = "train" if self.train else "test"
            for ci, name in enumerate(names):
                for f in sorted(glob.glob(
                    os.path.join(self.root, name, split, "*.off")
                )):
                    self.files.append((f, ci))
            if self.files:
                self.classes = names

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self):
        return len(self.files) or self.samples_per_epoch

    def __getitem__(self, idx: int) -> Sample:
        if self.files:
            path, cls = self.files[idx]
            pts = sample_off_mesh(path, self.n_points, seed=idx)
            pts = pts - pts.mean(0)
            pts = pts / max(np.abs(pts).max(), 1e-9)
        else:
            rng = np.random.default_rng(
                self.seed + idx + (0 if self.train else 10_000)
            )
            cls = int(rng.integers(self.num_classes))
            pts = _synth_shape(cls, rng, self.n_points)
        g = _voxel.grid_sample(pts, self.voxel_size)
        feats = np.concatenate(
            [g["pos"], np.ones((len(g["pos"]), 1), np.float32)], axis=1
        )
        return Sample(coords=g["coords"][:, 1:], feats=feats,
                      labels=np.full(len(g["pos"]), cls, np.int32),
                      pos=g["pos"])


def collate_classification(samples: List[Sample], bucket: Bucket,
                           conv0_kernel: int = 3) -> Dict:
    batch = collate(samples, bucket, conv0_kernel=conv0_kernel)
    labels = np.full(bucket.num_batches, -1, np.int32)
    labels[: len(samples)] = [int(s.labels[0]) for s in samples]
    batch["cls_label"] = labels
    return batch


def make_classification_dataset(root: Optional[str] = None, train: bool = True,
                                **kw) -> ClassificationDataset:
    """ModelNet-style classification (ref datasets/classification/)."""
    return ClassificationDataset(root=root, train=train, **kw)


# ==========================================================================
# Detection (ref datasets/object_detection/scannet.py: per-scene boxes;
# here synthetic rooms or ``scene_*.npz`` dumps with pos/rgb/boxes)
# ==========================================================================

@dataclasses.dataclass
class DetectionDataset:
    """Scenes with axis-aligned GT boxes, collated straight into the
    VoteNet batch layout (pn_graph + seed clusters are host-built tables,
    nn/pointnet2.py)."""

    root: Optional[str]
    train: bool = True
    n_scenes: int = 16
    n_points: int = 4096
    n_proposals: int = 32
    max_boxes: int = 8
    seed: int = 0

    def __post_init__(self):
        self.files = sorted(glob.glob(os.path.join(self.root, "scene_*.npz"))) \
            if self.root and os.path.isdir(self.root) else []

    num_classes: int = 2   # thing vs clutter in the synthetic rooms

    def __len__(self):
        return len(self.files) or self.n_scenes

    def _scene(self, idx: int):
        if self.files:
            z = np.load(self.files[idx])
            return z["pos"], z["rgb"], z["boxes"]
        seed = self.seed + idx + (0 if self.train else 10_000)
        sc = synthetic.make_scene(seed=seed, density=60.0, n_cameras=1,
                                  n_boxes=int(1 + idx % self.max_boxes),
                                  image_size=(32, 16))
        return sc.pos, sc.rgb, sc.boxes

    def __getitem__(self, idx: int) -> Dict:
        pos, rgb, boxes = self._scene(idx)
        rng = np.random.default_rng(idx)
        take = rng.choice(len(pos), self.n_points, replace=len(pos) < self.n_points)
        pos, rgb = pos[take], rgb[take]
        n = len(pos)
        valid = np.ones(n, bool)
        feats = np.concatenate([rgb, np.ones((n, 1), np.float32)], 1)
        graph = build_pointnet_graph(pos, np.zeros(n, np.int32), valid,
                                     n_points=(512, 128), radii=(0.4, 0.8),
                                     k=16)
        seed_pos = graph["pos"][-1]
        centers = sp.farthest_point_sample(seed_pos, self.n_proposals).numpy()
        group, counts = sp.ball_query(seed_pos[centers], seed_pos, 1.2, 16)
        group, counts = group.numpy(), counts.numpy()
        gt = np.zeros((self.max_boxes, 6), np.float32)
        gt[: len(boxes)] = boxes[: self.max_boxes]
        return {
            "pn_graph": graph, "feats": feats, "valid": valid,
            "det_clusters": {
                "centers": centers.astype(np.int32), "group": group,
                "group_count": counts,
                "center_valid": np.ones(self.n_proposals, bool),
            },
            "gt_boxes": gt,
        }


def make_detection_dataset(root: Optional[str] = None, train: bool = True,
                           **kw) -> DetectionDataset:
    """Box-detection scenes (ref datasets/object_detection/)."""
    return DetectionDataset(root=root, train=train, **kw)


# ==========================================================================
# Panoptic (ref datasets/panoptic/: semantic labels + per-point instance
# ids for thing classes; synthetic boxes become the instances)
# ==========================================================================

@dataclasses.dataclass
class PanopticDataset:
    root: Optional[str]
    train: bool = True
    n_scenes: int = 16
    voxel_size: float = 0.1
    num_classes: int = 4
    thing_classes: Tuple[int, ...] = (3,)
    seed: int = 0

    def __post_init__(self):
        self.files = sorted(glob.glob(os.path.join(self.root, "scene_*.npz"))) \
            if self.root and os.path.isdir(self.root) else []

    def __len__(self):
        return len(self.files) or self.n_scenes

    def __getitem__(self, idx: int) -> Sample:
        if self.files:
            z = np.load(self.files[idx])
            pos, rgb, labels, inst = (z["pos"], z["rgb"], z["labels"],
                                      z["instance"])
        else:
            seed = self.seed + idx + (0 if self.train else 10_000)
            sc = synthetic.make_scene(seed=seed, density=60.0, n_cameras=1,
                                      n_boxes=3, image_size=(32, 16))
            pos, rgb, labels = sc.pos, sc.rgb, sc.labels
            # instance id = which box the point belongs to (-1 = stuff)
            inst = np.full(len(pos), -1, np.int32)
            for bi, box in enumerate(sc.boxes):
                c, s = box[:3], box[3:]
                inside = (np.abs(pos - c) <= s / 2 + 0.05).all(axis=1) \
                    & (labels == 3)
                inst[inside] = bi
        g = _voxel.grid_sample(pos, self.voxel_size, feats=rgb, labels=labels)
        # majority instance per voxel via a second label pass
        gi = _voxel.grid_sample(pos, self.voxel_size, labels=inst)
        feats = np.concatenate(
            [g["feats"], np.ones((len(g["pos"]), 1), np.float32)], axis=1
        )
        s = Sample(coords=g["coords"][:, 1:], feats=feats, labels=g["labels"],
                   pos=g["pos"])
        s.instance = gi["labels"]      # ragged extra, shipped via collate meta
        return s


def collate_panoptic(samples: List[Sample], bucket: Bucket,
                     conv0_kernel: int = 3) -> Dict:
    batch = collate(samples, bucket, conv0_kernel=conv0_kernel)
    cap = bucket.level_caps[0]
    inst = np.full(cap, -1, np.int32)
    off = 0
    shift = 0
    for s in samples:
        ids = s.instance.astype(np.int32)
        shifted = np.where(ids >= 0, ids + shift, -1)
        inst[off: off + len(ids)] = shifted
        shift += int(ids.max(initial=-1)) + 1
        off += len(ids)
    batch["instance"] = inst
    return batch


def make_panoptic_dataset(root: Optional[str] = None, train: bool = True,
                          **kw) -> PanopticDataset:
    """Panoptic scenes: semantics + thing instances (ref datasets/panoptic/)."""
    return PanopticDataset(root=root, train=train, **kw)


# ==========================================================================
# Registration (ref datasets/registration/: 3DMatch fragment pairs with
# overlap correspondences; synthetic pairs = two noisy rigid views)
# ==========================================================================

@dataclasses.dataclass
class RegistrationDataset:
    """Pairs of fragments + ground-truth correspondence indices.

    On-disk: ``pair_*.npz`` with pos_a/pos_b/pairs (3DMatch-style fragment
    dumps).  Synthetic: a scene sphere duplicated, one side rigidly moved +
    noised — correspondences are the shared origin rows."""

    root: Optional[str]
    train: bool = True
    n_pairs: int = 8
    n_points: int = 2048
    voxel_size: float = 0.08
    max_pairs: int = 256
    seed: int = 0

    def __post_init__(self):
        self.files = sorted(glob.glob(os.path.join(self.root, "pair_*.npz"))) \
            if self.root and os.path.isdir(self.root) else []

    def __len__(self):
        return len(self.files) or self.n_pairs

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng(
            self.seed + idx + (0 if self.train else 10_000)
        )
        if self.files:
            z = np.load(self.files[idx])
            pos_a, pos_b, pairs = z["pos_a"], z["pos_b"], z["pairs"]
            rt = z.get("transform", np.eye(4, dtype=np.float32))
        else:
            sc = synthetic.make_scene(seed=self.seed + idx, density=40.0,
                                      n_cameras=1, image_size=(32, 16))
            take = rng.choice(len(sc.pos), self.n_points,
                              replace=len(sc.pos) < self.n_points)
            pos_a = sc.pos[take]
            theta = rng.uniform(0, 2 * np.pi)
            r = np.array([[np.cos(theta), -np.sin(theta), 0],
                          [np.sin(theta), np.cos(theta), 0],
                          [0, 0, 1]], np.float32)
            t = rng.uniform(-2, 2, 3).astype(np.float32)
            pos_b = pos_a @ r.T + t + rng.normal(0, 0.005, pos_a.shape
                                                 ).astype(np.float32)
            pairs = np.stack([np.arange(len(pos_a))] * 2, 1)
            rt = np.eye(4, dtype=np.float32)
            rt[:3, :3] = r
            rt[:3, 3] = t
        ga = _voxel.grid_sample(pos_a, self.voxel_size)
        gb = _voxel.grid_sample(pos_b, self.voxel_size)
        # voxel-level correspondences: raw pairs -> voxel ids of each side
        va = ga["inverse"][pairs[:, 0]]
        vb = gb["inverse"][pairs[:, 1]]
        uniq, first = np.unique(va, return_index=True)
        vox_pairs = np.stack([uniq, vb[first]], 1)
        if len(vox_pairs) > self.max_pairs:
            vox_pairs = vox_pairs[
                rng.choice(len(vox_pairs), self.max_pairs, replace=False)
            ]
        # pad by repeating the first pair (static shape; duplicated positives
        # only reweight the mean slightly) and keep the true count
        n_valid_pairs = len(vox_pairs)
        pad = np.repeat(vox_pairs[:1], self.max_pairs - len(vox_pairs), axis=0)
        return {
            "num_pairs": n_valid_pairs,
            "frag_a": Sample(
                coords=ga["coords"][:, 1:],
                feats=np.ones((len(ga["pos"]), 1), np.float32),
                labels=np.zeros(len(ga["pos"]), np.int32), pos=ga["pos"],
            ),
            "frag_b": Sample(
                coords=gb["coords"][:, 1:],
                feats=np.ones((len(gb["pos"]), 1), np.float32),
                labels=np.zeros(len(gb["pos"]), np.int32), pos=gb["pos"],
            ),
            "pairs": np.concatenate([vox_pairs, pad]),
            "transform": rt,
        }


def collate_registration(item: Dict, bucket: Bucket,
                         conv0_kernel: int = 3) -> Dict:
    """One fragment pair -> two collated single-sample batches + pair table
    (the reference feeds fragment pairs through a shared backbone,
    datasets/registration/pair.py)."""
    ba = collate([item["frag_a"]], bucket, conv0_kernel=conv0_kernel)
    bb = collate([item["frag_b"]], bucket, conv0_kernel=conv0_kernel)
    return {
        "a": device_view(ba), "b": device_view(bb),
        "pairs": item["pairs"].astype(np.int32),
        "transform": item["transform"],
    }


def make_registration_dataset(root: Optional[str] = None, train: bool = True,
                              **kw) -> RegistrationDataset:
    """Fragment-pair registration (ref datasets/registration/)."""
    return RegistrationDataset(root=root, train=train, **kw)
