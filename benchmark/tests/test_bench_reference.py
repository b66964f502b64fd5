"""The plain reference against the port at a tiny size on the CPU, and the
control (the reference with float8 operands where the configuration states
bfloat16) off by far more."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference.model import (Precision, forward,
                                       inputs_from_batch, loss_fn)


def _coords(samples):
    return np.concatenate([
        np.concatenate([np.full((len(s.coords), 1), b), s.coords], 1)
        for b, s in enumerate(samples)])


@pytest.mark.parametrize("layout", ["flat", "ladder"])
def test_reference_agrees_with_the_port_and_the_control_does_not(layout):
    from deepviewagg_tpu_torch.data.collate import batch_to_torch, device_view
    from deepviewagg_tpu_torch.data.toy import (flagship_spec, recipe_batch,
                                                toy_batch)
    from deepviewagg_tpu_torch.models.segmentation import build_model
    from deepviewagg_tpu_torch.modules.image_encoders import f32_convs

    torch.set_num_threads(2)
    kw = dict(n_samples=2, density=60.0, image_size=(64, 32), n_cameras=2,
              voxel_size=0.15, device="cpu")
    if layout == "flat":
        batch, _, samples = toy_batch(**kw)
    else:
        batch, _, samples = recipe_batch(min_size=16, **kw)
    spec = flagship_spec(num_classes=5, backbone="Res16UNetTest",
                         tower="resnet18_l1")
    b = dataclasses.replace(spec.branches[0][1], tower_deep_stem=True,
                            tower_bf16=False)
    model = build_model(dataclasses.replace(spec, branches=((0, b),)),
                        device="cpu", seed=3)
    P = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with f32_convs():
        model.train()
        got = model(batch_to_torch(device_view(batch), "cpu"))["logits"]
    n = int(batch["meta"]["num_valid"])
    got = got[:n].detach()
    inp = inputs_from_batch(batch, _coords(samples), "cpu")
    # the port's towers in float32 here, its sparse convolutions bfloat16
    stated = Precision(tower="f32", sparse="bf16")
    with torch.no_grad():
        ref = forward(P, inp, 4, True, stated)
        ctl = forward(P, inp, 4, True, stated.lower())
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / scale
    err_ctl = float((ctl - ref).abs().max()) / scale
    assert err < 2e-2
    assert err_ctl > 10 * err
    lr = float(loss_fn(ref, inp["labels"]))
    gap = abs(float(loss_fn(got, inp["labels"])) - lr) / lr
    gap_ctl = abs(float(loss_fn(ctl, inp["labels"])) - lr) / lr
    assert gap < 1e-3 and gap_ctl > 3 * gap
