"""The whole slice: ``MultimodalSeg`` eval forward of the JAX package and of
the PyTorch port on the same numpy batch, with parameters converted by
``deepviewagg_tpu_torch.utils.from_jax``; plus the converter's strictness on
the full-width flagship tree."""

import jax
import numpy as np
import pytest
import torch

from deepviewagg_tpu.data.toy import flagship_spec as jax_flagship_spec
from deepviewagg_tpu.models.segmentation import MultimodalSeg as JaxSeg
from deepviewagg_tpu.modules import image_encoders as jax_towers
from deepviewagg_tpu_torch.data.toy import flagship_spec
from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg
from deepviewagg_tpu_torch.modules import image_encoders as torch_towers
from deepviewagg_tpu_torch.utils.from_jax import flatten, load_flax_variables
from torch_port_util import (TINY_SPEC, _torch_threads,  # noqa: F401
                             f32_sparse_convs, jax_tiny_batch,
                             jax_model_variables, rel_err,
                             torch_batch)


def _models(tower_bf16: bool):
    import dataclasses

    jspec = jax_flagship_spec(**TINY_SPEC)
    tspec = flagship_spec(**TINY_SPEC)
    if not tower_bf16:
        jspec = dataclasses.replace(jspec, branches=tuple(
            (lvl, dataclasses.replace(b, tower_bf16=False))
            for lvl, b in jspec.branches))
        tspec = dataclasses.replace(tspec, branches=tuple(
            (lvl, dataclasses.replace(b, tower_bf16=False))
            for lvl, b in tspec.branches))
    batch, _ = jax_tiny_batch()
    jmodel = JaxSeg(jspec)
    variables = jax_model_variables(jmodel, seed=1)
    tmodel = MultimodalSeg(tspec, device="cpu", seed=None).eval()
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel, batch


@pytest.mark.parametrize("tower_bf16", [False, True])
def test_multimodal_seg_logits_match_jax(tower_bf16, monkeypatch):
    if not tower_bf16:
        # float32 operands in the sparse convs as well: with bf16 operands
        # rounding flips alone move these logits by ~2e-3 (f32_sparse_convs)
        f32_sparse_convs(monkeypatch)
    jmodel, variables, tmodel, batch = _models(tower_bf16)
    tb = torch_batch(batch)
    if tower_bf16:
        ref = np.asarray(jmodel.apply(variables, batch, train=False)["logits"])
        with torch.no_grad():
            out = tmodel(tb)
    else:
        with jax_towers.f32_convs():
            ref = np.asarray(jmodel.apply(variables, batch, train=False)["logits"])
        with torch.no_grad(), torch_towers.f32_convs():
            out = tmodel(tb)
    got = out["logits"].numpy()
    n = int(np.asarray(batch["graph"]["levels"][0]["valid"]).sum())
    assert np.isfinite(got).all()
    err = rel_err(got[:n], ref[:n])
    if tower_bf16:
        # bf16 tower operands round at other places in the two frameworks
        assert err <= 3e-2, err
        agree = (got[:n].argmax(1) == ref[:n].argmax(1)).mean()
        assert agree >= 0.99, agree
    else:
        # f32 everywhere: only summation orders differ
        assert err <= 1e-4, err


def test_from_jax_maps_full_flagship_tree_leaf_for_leaf():
    batch, _ = jax_tiny_batch()
    shapes = jax.eval_shape(
        lambda: JaxSeg(jax_flagship_spec()).init(jax.random.PRNGKey(0), batch,
                                                 train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = MultimodalSeg(flagship_spec(), device="cpu", seed=None)
    load_flax_variables(tmodel, variables)

    leaves = flatten(variables)
    n_params = sum(v.size for k, v in leaves.items() if k[0] == "params")
    n_stats = sum(v.size for k, v in leaves.items() if k[0] == "batch_stats")
    assert n_params == sum(p.numel() for p in tmodel.parameters())
    assert n_stats == sum(b.numel() for b in tmodel.buffers())
    # spot-check each layout rule
    sd = tmodel.state_dict()
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["head.weight"].numpy(), p["head"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["branch_l0.tower.ResNet18_0.Conv2dWS_0.weight"].numpy(),
        p["branch_l0"]["tower"]["ResNet18_0"]["Conv2dWS_0"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["stem.SparseConvNormRelu_0.SparseConv_0.weight"].numpy(),
        p["stem"]["SparseConvNormRelu_0"]["SparseConv_0"]["kernel"])
    np.testing.assert_array_equal(
        sd["down1.ResBlock_0.MaskedBatchNorm_0.running_var"].numpy(),
        variables["batch_stats"]["down1"]["ResBlock_0"]["MaskedBatchNorm_0"]["var"])


def test_from_jax_is_strict():
    variables = jax_model_variables(JaxSeg(jax_flagship_spec(**TINY_SPEC)))
    tmodel = MultimodalSeg(flagship_spec(**TINY_SPEC), device="cpu", seed=None)
    load_flax_variables(tmodel, variables)

    missing = jax.tree_util.tree_map(lambda v: v, variables)
    del missing["params"]["head"]["bias"]
    with pytest.raises(KeyError, match="not filled"):
        load_flax_variables(tmodel, missing)
    extra = jax.tree_util.tree_map(lambda v: v, variables)
    extra["params"]["head"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        load_flax_variables(tmodel, extra)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["head"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tmodel, bad)


def test_seeded_init_is_device_independent_and_finite():
    a = MultimodalSeg(flagship_spec(**TINY_SPEC), device="cpu", seed=3)
    b = MultimodalSeg(flagship_spec(**TINY_SPEC), device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)
    batch, _ = jax_tiny_batch()
    with torch.no_grad():
        out = a.eval()(torch_batch(batch))
    assert torch.isfinite(out["logits"]).all()
    assert out["x_seen"].dtype == torch.bool
