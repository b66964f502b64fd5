"""The image branch of the PyTorch port against the JAX package, on the
mapping of the JAX package's tiny flagship batch: the pixel gather through
each of its paths, the group-attention view pool and the whole
``UnimodalBranch`` (eval, float32 tower).  Tolerance 1e-5: only summation
orders differ."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepviewagg_tpu.modules import branch as jbranch
from deepviewagg_tpu.modules import gather as jgather
from deepviewagg_tpu.modules import image_encoders as jt
from deepviewagg_tpu.modules import pooling as jpool
from deepviewagg_tpu_torch.modules import branch as tbranch
from deepviewagg_tpu_torch.modules import gather as tgather
from deepviewagg_tpu_torch.modules import image_encoders as tt
from deepviewagg_tpu_torch.modules import pooling as tpool
from deepviewagg_tpu_torch.utils.from_jax import load_flax_variables
from torch_port_util import (_torch_threads, jax_tiny_batch,  # noqa: F401
                             jax_variables, rel_err, torch_batch)


def _mapping(rows=None):
    """The tiny batch's level-0 mapping and its reference size (W, H);
    ``rows`` keeps only the first pixel rows (a sparse mapping)."""
    batch, _ = jax_tiny_batch()
    m = dict(batch["mappings"][0])
    if rows is not None:
        for k in ("pix_view", "pix_x", "pix_y", "pix_valid"):
            m[k] = m[k][:rows]
    return m, tuple(batch["images"].shape[1:3])


def _maps(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("path", ["bilinear", "upsampled", "nearest",
                                  "scale1"])
def test_gather_pixel_features_matches_jax(path):
    m, (w, h) = _mapping(rows=40 if path == "bilinear" else None)
    size = (w, h) if path == "scale1" else (w // 4, h // 4)
    maps = _maps((1,) + size + (6,))
    n_rows = len(m["pix_x"])
    want_up = path == "upsampled"
    if path in ("bilinear", "upsampled"):
        assert jgather._use_upsample(1, w, h, 6, n_rows, 4) == want_up
        assert tgather._use_upsample(1, w, h, 6, n_rows, 4) == want_up
    interpolate = path != "nearest"
    ref = np.asarray(jgather.gather_pixel_features(
        jnp.asarray(maps), {k: jnp.asarray(v) for k, v in m.items()}, (w, h),
        interpolate=interpolate))
    got = tgather.gather_pixel_features(
        torch.from_numpy(maps), torch_batch(m), (w, h),
        interpolate=interpolate).numpy()
    assert got.shape == ref.shape == (n_rows, 6)
    assert rel_err(got, ref) <= 1e-5
    if path == "scale1":
        # at scale 1 the gather indexes exactly, even with interpolation on
        ok = m["pix_valid"]
        exact = maps[0, m["pix_x"][ok], m["pix_y"][ok]]
        np.testing.assert_array_equal(got[ok], exact)


def test_resize_matrix_matches_jax():
    for n_out, n_in in ((64, 16), (33, 8), (7, 7)):
        np.testing.assert_array_equal(
            tgather._resize_matrix(n_out, n_in, "cpu").numpy(),
            np.asarray(jgather._resize_matrix(n_out, n_in)))


def test_group_helpers_match_jax():
    for c, g in ((64, 4), (10, 3), (8, 1)):
        assert tpool.group_sizes(c, g) == jpool.group_sizes(c, g)
        x = _maps((5, g))
        np.testing.assert_array_equal(
            tpool.expand_group_feat(torch.from_numpy(x), g, c).numpy(),
            np.asarray(jpool.expand_group_feat(jnp.asarray(x), g, c)))
    for x in (3, 17, 48, 100):
        assert tpool.nearest_power_of_2(x) == jpool.nearest_power_of_2(x)


@pytest.mark.parametrize("num_groups", [1, 4])
def test_group_view_pool_matches_jax(num_groups):
    m, _ = _mapping()
    batch, _ = jax_tiny_batch()
    s = len(batch["graph"]["levels"][0]["valid"]) + 1
    x_view = _maps((len(m["view_valid"]), 24), seed=2)
    args = (x_view, m["view_feats"], m["point_id"], m["view_valid"], s)
    seg_ok = np.arange(s) < s - 1
    jp = jpool.GroupViewPool(16, num_groups=num_groups)
    variables = jax_variables(jp, *args, seed=3, train=False,
                              ptr=m["point_ptr"], seg_valid=seg_ok)
    tp = tpool.GroupViewPool(24, 16, num_groups=num_groups).eval()
    load_flax_variables(tp, variables)
    ref, ref_attn = jp.apply(variables, *args, train=False,
                             ptr=m["point_ptr"], seg_valid=seg_ok)
    tm = torch_batch(m)
    with torch.no_grad():
        got, attn = tp(torch.from_numpy(x_view), tm["view_feats"],
                       tm["point_id"], tm["view_valid"], s,
                       ptr=tm["point_ptr"], seg_valid=torch.from_numpy(seg_ok))
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    assert rel_err(attn.numpy(), np.asarray(ref_attn)) <= 1e-5


def test_unimodal_branch_matches_jax():
    batch, _ = jax_tiny_batch()
    m = batch["mappings"][0]
    images = batch["images"]
    ref_size = tuple(images.shape[1:3])
    x3d = batch["feats"]
    jb = jbranch.UnimodalBranch(
        tower=functools.partial(jt.ResNet18, out_level=1, name="tower"),
        out_channels=64, num_groups=4, tower_bf16=False,
        fusion_mode="concatenation")
    variables = jax_variables(jb, x3d, images, m, ref_size, seed=4,
                              train=False)
    with jt.f32_convs():
        ref, ref_seen, _ = jb.apply(variables, x3d, images, m, ref_size,
                                    train=False)
    tb = tbranch.UnimodalBranch(
        tt.ResNet18(out_level=1), 64, x3d.shape[1], 64, num_groups=4,
        tower_bf16=False, fusion_mode="concatenation").eval()
    load_flax_variables(tb, variables)
    tbatch = torch_batch(batch)
    with torch.no_grad(), tt.f32_convs():
        got, seen = tb(tbatch["feats"], tbatch["images"], tbatch["mappings"][0],
                       ref_size)
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), np.asarray(ref)) <= 1e-5
    np.testing.assert_array_equal(seen.numpy(), np.asarray(ref_seen))
    assert seen.numpy().any()
