"""``data/geometric.py::pca_features`` past 100,000 points, where both
packages take the host's grid kNN (``knn_grid`` on the native builders)
instead of the brute force: the port against the JAX package on 120,000
points of a synthetic room.

Bounds.  ``nn_idx`` equal (both grid kNNs give the same bytes).  The
normals (up to sign) and the features within 1e-5 at every point whose
covariance eigenvalue gaps both exceed 2% of its largest eigenvalue; the
features within 1e-4 (the brute-force path's bound,
``test_torch_port_data.py``) at the others, and every normal of unit
length.  At those points (0.3% of this cloud)
``(s1 - s2) / s1`` is ill-conditioned in float32, each package lying up to
2-4e-5 from the float64 features on the same neighbourhoods, and so is the
smallest eigenvalue's vector when the two smallest nearly meet.
"""

import functools

import numpy as np
import pytest

from deepviewagg_tpu.data import geometric as jgeo
from deepviewagg_tpu.data import synthetic as jsyn
from deepviewagg_tpu_torch.data import geometric as tgeo
from deepviewagg_tpu_torch.ops import knn as tknn
from torch_port_util import _torch_threads  # noqa: F401

POINTS, K = 120_000, 50
FEATURES = ("linearity", "planarity", "scattering")


@functools.lru_cache(maxsize=None)
def _cloud():
    scene = jsyn.make_scene(seed=0, density=1200.0, n_cameras=1,
                            image_size=(32, 16))
    assert len(scene.pos) > POINTS > tgeo.HOST_KNN_POINTS
    return np.ascontiguousarray(scene.pos[:POINTS], np.float32)


def _well_conditioned(pos, idx):
    """Points whose float64 covariance eigenvalues (on the neighbourhoods
    ``idx``) are apart by more than 2% of the largest, both gaps."""
    p = pos.astype(np.float64)[idx]
    c = p - p.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c) / idx.shape[1])
    ev = ev[:, ::-1]
    gap = np.minimum(ev[:, 0] - ev[:, 1], ev[:, 1] - ev[:, 2])
    return gap > 2e-2 * np.maximum(ev[:, 0], 1e-30)


@pytest.mark.parametrize("r_search", [None, 0.1])
def test_pca_features_on_the_grid_knn_match_jax(monkeypatch, r_search):
    pos = _cloud()
    calls = []
    inner = tknn.knn_grid
    monkeypatch.setattr(tknn, "knn_grid",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("the brute force ran past 100,000 points")

    monkeypatch.setattr(tknn, "knn", refuse)
    got = tgeo.pca_features(pos, k=K, r_search=r_search, device="cpu")
    want = jgeo.pca_features(pos, k=K, r_search=r_search)
    assert calls == [1]
    assert np.array_equal(got["nn_idx"].numpy(), want["nn_idx"])
    if r_search is not None:
        # some neighbourhoods are cut by the radius
        assert (want["nn_idx"] == np.arange(POINTS)[:, None]).sum() > POINTS
    well = _well_conditioned(pos, want["nn_idx"])
    assert well.mean() > 0.99
    g, w = got["normal"].numpy(), want["normal"]
    err = np.minimum(np.abs(g - w).max(1), np.abs(g + w).max(1))
    assert err[well].max() <= 1e-5
    assert np.abs(np.linalg.norm(g, axis=1) - 1).max() <= 1e-5
    for key in FEATURES:
        err = np.abs(got[key].numpy() - want[key])
        assert err[well].max() <= 1e-5, key
        assert err.max() <= 1e-4, key
