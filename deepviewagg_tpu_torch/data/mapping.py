"""Flat-array point->view->pixel mappings (the TPU ``ImageMapping``).

The reference stores the two-level ragged relation point -> views -> pixels
in nested CSR objects (``ImageMapping``, core/multimodal/image.py:1707).  Here
it is a pair of sorted segment-id tables with validity masks and static
capacities — directly consumable by the sorted-segment reductions of
:mod:`deepviewagg_tpu_torch.ops.segment` on device:

  view level   one row per (point, image) pair that sees the point:
               ``point_id`` (sorted; pad = num_points), ``image_id``,
               ``view_feats [*, 8]`` (viewing conditions, SURVEY.md §A.3);
  pixel level  one row per (view, pixel): ``pix_view`` (sorted; pad =
               view capacity), integer pixel coords at the camera's
               reference resolution.

Reindex operations (the reference's ``select_points`` / batching machinery,
image.py:2029-2345) are host-side numpy: they happen at collate / graph-build
time, never inside the forward.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.csr import pad_to

__all__ = ["MultiViewMapping", "concatenate_mappings"]

NUM_VIEW_FEATURES = 8  # SURVEY.md §A.3 fixed order
VIEW_FEATURE_NAMES = (
    "normalized_depth",
    "linearity",
    "planarity",
    "scattering",
    "orientation_to_the_surface",
    "normalized_pixel_height",
    "density",
    "occlusion",
)


@dataclasses.dataclass
class MultiViewMapping:
    """Host (numpy) mapping arrays; ``to_device()`` yields the batch dict."""

    point_id: np.ndarray      # int32 [Vc], sorted asc, pad = num_points
    image_id: np.ndarray      # int32 [Vc], pad = 0 (masked)
    view_feats: np.ndarray    # f32 [Vc, F]
    view_valid: np.ndarray    # bool [Vc]
    pix_view: np.ndarray      # int32 [Qc], sorted asc, pad = Vc
    pix_x: np.ndarray         # int32 [Qc]
    pix_y: np.ndarray         # int32 [Qc]
    pix_valid: np.ndarray     # bool [Qc]
    num_points: int           # point-index capacity this mapping addresses
    num_images: int

    @property
    def num_views(self) -> int:
        return int(self.view_valid.sum())

    @property
    def num_pixels(self) -> int:
        return int(self.pix_valid.sum())

    @property
    def view_capacity(self) -> int:
        return len(self.point_id)

    @property
    def pixel_capacity(self) -> int:
        return len(self.pix_view)

    def check(self):
        """Invariant assertions (the reference's ``ImageMapping.debug``,
        image.py:1797)."""
        v = self.view_valid
        q = self.pix_valid
        assert np.all(np.diff(self.point_id) >= 0), "views not sorted by point"
        assert np.all(self.point_id[~v] == self.num_points)
        assert np.all(self.point_id[v] < self.num_points)
        assert np.all(np.diff(self.pix_view) >= 0), "pixels not sorted by view"
        assert np.all(self.pix_view[~q] == self.view_capacity)
        assert np.all(self.pix_view[q] < self.view_capacity)
        # every valid view must own >= 1 pixel
        owned = np.zeros(self.view_capacity + 1, np.int64)
        np.add.at(owned, self.pix_view.astype(np.int64), q.astype(np.int64))
        assert np.all(owned[: self.view_capacity][v] >= 1), "pixel-less view"

    def pad(self, view_cap: int, pix_cap: int) -> "MultiViewMapping":
        """Grow (never shrink valid rows) to the given static capacities.

        Pixel pad rows must point at the *new* view capacity, and existing
        pixel pads are re-pointed too.
        """
        if view_cap < self.num_views or pix_cap < self.num_pixels:
            raise ValueError("capacity below live rows")
        pix_view = np.where(self.pix_valid, self.pix_view, view_cap)
        return MultiViewMapping(
            point_id=pad_to(self.point_id, view_cap, fill=self.num_points),
            image_id=pad_to(self.image_id, view_cap, fill=0),
            view_feats=pad_to(self.view_feats, view_cap, fill=0.0),
            view_valid=pad_to(self.view_valid, view_cap, fill=False),
            pix_view=pad_to(pix_view, pix_cap, fill=view_cap),
            pix_x=pad_to(self.pix_x, pix_cap, fill=0),
            pix_y=pad_to(self.pix_y, pix_cap, fill=0),
            pix_valid=pad_to(self.pix_valid, pix_cap, fill=False),
            num_points=self.num_points,
            num_images=self.num_images,
        )

    def with_num_points(self, num_points: int) -> "MultiViewMapping":
        """Re-target the point index space (e.g. after padding the voxel
        arrays to a larger capacity)."""
        pid = np.where(self.view_valid, self.point_id, num_points)
        return dataclasses.replace(self, point_id=pid, num_points=num_points)

    def merge_points(self, parent: np.ndarray, new_num_points: int) -> "MultiViewMapping":
        """Follow a point-merge reindex (strided conv): ``parent[i]`` is the
        coarse index of fine point ``i`` (pad -> >= new_num_points).

        The reference's ``ImageMapping.select_points(idx, mode='merge')``
        (image.py:2167-2277): fine views of the same coarse (point, image)
        pair MERGE into one view whose features are the unweighted mean of
        the duplicates (``scatter_mean`` over composite view ids,
        image.py:2231-2246), and duplicate (view, pixel) rows collapse
        (``lexargunique``, image.py:2262-2267).  Host-side because parents
        are known at graph-build time; static capacities are preserved
        (merged rows become padding).
        """
        parent = np.asarray(parent, np.int64)
        vc = self.view_capacity
        new_pid = np.where(
            self.view_valid, parent[np.minimum(self.point_id, len(parent) - 1)],
            new_num_points,
        )
        new_pid = np.minimum(new_pid, new_num_points)

        # composite (point, image) key; pads sort last
        n_img = max(int(self.num_images), 1)
        key = np.where(self.view_valid, new_pid * n_img + self.image_id,
                       new_num_points * n_img)
        uniq, inv_v, counts = np.unique(key, return_inverse=True,
                                        return_counts=True)
        n_groups = len(uniq)
        has_pad = bool((uniq == new_num_points * n_img).any())
        n_valid = n_groups - int(has_pad)

        # unweighted mean of duplicate view features (reference
        # scatter_mean semantics)
        feats = np.zeros((n_groups, self.view_feats.shape[1]), np.float64)
        np.add.at(feats, inv_v, self.view_feats.astype(np.float64))
        feats = (feats / np.maximum(counts, 1)[:, None]).astype(np.float32)

        point_id = np.minimum(uniq // n_img, new_num_points).astype(np.int32)
        image_id = np.where(np.arange(n_groups) < n_valid,
                            uniq % n_img, 0).astype(np.int32)
        point_id[n_valid:] = new_num_points

        # pixel rows re-point to merged views, then (view, x, y) dedupe
        pix_group = np.where(
            self.pix_valid, inv_v[np.minimum(self.pix_view, vc - 1)],
            n_groups,
        )
        pix_ok = self.pix_valid & (pix_group < n_valid)
        w = max(int(self.pix_x.max(initial=0)), int(self.pix_y.max(initial=0))) + 2
        pix_key = np.where(
            pix_ok,
            (pix_group.astype(np.int64) * w + self.pix_x) * w + self.pix_y,
            np.int64(n_groups) * w * w,
        )
        puniq, pfirst = np.unique(pix_key, return_index=True)
        p_has_pad = bool((puniq == np.int64(n_groups) * w * w).any())
        p_valid = len(puniq) - int(p_has_pad)

        qc = self.pixel_capacity
        pix_view = np.full(qc, vc, np.int32)
        pix_x = np.zeros(qc, self.pix_x.dtype)
        pix_y = np.zeros(qc, self.pix_y.dtype)
        pix_valid = np.zeros(qc, bool)
        src = pfirst[:p_valid]
        pix_view[:p_valid] = pix_group[src]
        pix_x[:p_valid] = self.pix_x[src]
        pix_y[:p_valid] = self.pix_y[src]
        pix_valid[:p_valid] = True

        return MultiViewMapping(
            point_id=pad_to(point_id, vc, fill=new_num_points),
            image_id=pad_to(image_id, vc, fill=0),
            view_feats=pad_to(feats, vc, fill=0.0),
            view_valid=pad_to(np.arange(n_groups) < n_valid, vc, fill=False),
            pix_view=pix_view,
            pix_x=pix_x,
            pix_y=pix_y,
            pix_valid=pix_valid,
            num_points=new_num_points,
            num_images=self.num_images,
        )

    def to_device(self) -> dict:
        """The dict the branch consumes.

        ``point_ptr`` / ``pix_ptr`` are the CSR pointers of the sorted id
        columns (the reference's ``segment_csr`` indptr) — host-computed so
        the CUDA segment kernel never pays for an on-device searchsorted.
        """
        return {
            "point_id": self.point_id,
            "point_ptr": np.searchsorted(
                self.point_id, np.arange(self.num_points + 2)
            ).astype(np.int32),
            "image_id": self.image_id,
            "view_feats": self.view_feats,
            "view_valid": self.view_valid,
            "pix_view": self.pix_view,
            "pix_ptr": np.searchsorted(
                self.pix_view, np.arange(self.view_capacity + 2)
            ).astype(np.int32),
            "pix_x": self.pix_x,
            "pix_y": self.pix_y,
            "pix_valid": self.pix_valid,
        }


def concatenate_mappings(
    mappings: Sequence[MultiViewMapping],
    point_offsets: Sequence[int],
    total_points: int,
) -> MultiViewMapping:
    """Collate per-sample mappings (the reference's ``ImageMappingBatch.
    from_csr_list`` with is_index_value re-offsetting, image.py:1318-1395).

    ``point_offsets[s]`` is sample s's start row in the collated (unpadded)
    point arrays; image ids are offset by cumulative image counts.  Only
    valid rows are kept, then the result can be ``pad()``-ed to batch caps.
    """
    pid, img, vf, pv, px, py = [], [], [], [], [], []
    img_off = 0
    view_off = 0
    for m, poff in zip(mappings, point_offsets):
        v = m.view_valid
        q = m.pix_valid
        pid.append(m.point_id[v].astype(np.int64) + poff)
        img.append(m.image_id[v].astype(np.int64) + img_off)
        vf.append(m.view_feats[v])
        # compact view index: position among valid views of this sample
        old_to_new = np.full(m.view_capacity, -1, np.int64)
        old_to_new[np.nonzero(v)[0]] = np.arange(v.sum()) + view_off
        pv.append(old_to_new[np.minimum(m.pix_view[q], m.view_capacity - 1)])
        px.append(m.pix_x[q])
        py.append(m.pix_y[q])
        img_off += m.num_images
        view_off += int(v.sum())
    point_id = np.concatenate(pid) if pid else np.zeros(0, np.int64)
    total_views = len(point_id)
    out = MultiViewMapping(
        point_id=point_id.astype(np.int32),
        image_id=(np.concatenate(img) if img else np.zeros(0)).astype(np.int32),
        view_feats=np.concatenate(vf) if vf else np.zeros((0, NUM_VIEW_FEATURES), np.float32),
        view_valid=np.ones(total_views, bool),
        pix_view=(np.concatenate(pv) if pv else np.zeros(0)).astype(np.int32),
        pix_x=(np.concatenate(px) if px else np.zeros(0)).astype(np.int32),
        pix_y=(np.concatenate(py) if py else np.zeros(0)).astype(np.int32),
        pix_valid=np.ones(sum(len(a) for a in pv), bool) if pv else np.zeros(0, bool),
        num_points=total_points,
        num_images=img_off,
    )
    # per-sample mappings are point-sorted; offsets keep the global sort
    assert np.all(np.diff(out.point_id) >= 0) or len(out.point_id) == 0
    return out
