"""Point Transformer V3 in the port (``nn/ptv3.py``, ``ops/serialize.py``,
the ``"ptv3"`` collate route, ``sphere_crop_count``, the one-cycle AdamW)
against plain versions and against the benchmark's plain reference
(``benchmark/reference/ptv3.py``), on the CPU.

Bounds.  The serialization, the patch indices, the pooling's clusters and
the crop are exact.  The model against the reference, both in float32:
the two sum in different orders (gather-GEMMs against per-offset
``index_add``, one attention call against a softmax written out, BatchNorm
from sums against means), so logits, losses and gradients agree to float32
round-off carried through the net's depth: 2e-5 of the tensor's largest
magnitude (observed 1e-6 to 4e-6), a gradient's floored at a hundredth of
the net's largest (a leaf whose true gradient is zero, the bias of a
linear layer before a BatchNorm, holds round-off alone).  The parameters after three
AdamW steps: Adam divides each gradient by its own root mean square, so an
element whose gradient is round-off sized can move by a different amount;
the change is held to 1e-3 of the learning rate per element, on the
elements whose first gradient is above round-off (1e-5 of the net's
largest: a zero gradient, as of the keys' bias, moves by the sign of
round-off), at least 95% of them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import ptv3 as ref
from deepviewagg_tpu_torch.config.zoo import (get_model_spec,
                                              recipe_lr_keywords)
from deepviewagg_tpu_torch.data import transforms3d
from deepviewagg_tpu_torch.data.collate import (Bucket, Sample,
                                                batch_to_torch, collate,
                                                device_view)
from deepviewagg_tpu_torch.models.losses import segmentation_loss
from deepviewagg_tpu_torch.models.segmentation import build_model
from deepviewagg_tpu_torch.nn import ptv3 as tp
from deepviewagg_tpu_torch.ops import segment as seg
from deepviewagg_tpu_torch.ops import serialize as ser
from deepviewagg_tpu_torch.ops import voxel
from deepviewagg_tpu_torch.train.optimizers import (make_optimizer,
                                                    make_schedule,
                                                    one_cycle_beta1)
from deepviewagg_tpu_torch.train.step import TrainState, make_train_step

LR, TOTAL = 0.006, 40


# --- serialization ----------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3, 5])
def test_z_order_is_the_bit_interleave_and_trans_swaps_x_y(depth):
    rng = np.random.default_rng(depth)
    g = torch.as_tensor(rng.integers(0, 2 ** depth, (300, 3)))
    s = torch.as_tensor(rng.integers(0, 3, 300))
    z = ser.encode(g, s, depth, "z")
    want = [(int(b) << 3 * depth) | ser.z_order_plain(*map(int, p), depth)
            for p, b in zip(g, s)]
    assert z.tolist() == want
    zt = ser.encode(g, s, depth, "z-trans")
    assert zt.tolist() == ser.encode(g[:, [1, 0, 2]], s, depth, "z").tolist()
    assert z.tolist() == ref.codes(g, s, depth, "z").tolist()


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hilbert_is_a_bijection_walking_face_adjacent_cells(depth):
    side = 2 ** depth
    g = torch.as_tensor(np.stack(np.meshgrid(
        *[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3))
    zero = torch.zeros(len(g), dtype=torch.int64)
    for order in ("hilbert", "hilbert-trans"):
        h = ser.encode(g, zero, depth, order)
        assert sorted(h.tolist()) == list(range(side ** 3))
        walk = g[torch.argsort(h)]
        assert ((walk[1:] - walk[:-1]).abs().sum(1) == 1).all()
        assert h.tolist() == ref.codes(g, zero, depth, order).tolist()
    h = ser.encode(g, zero, depth, "hilbert")
    assert h.tolist() == [ser.hilbert_plain(*map(int, p), depth) for p in g]
    assert ser.encode(g, zero, depth, "hilbert-trans").tolist() == \
        ser.encode(g[:, [1, 0, 2]], zero, depth, "hilbert").tolist()


@pytest.mark.parametrize("order", ser.ORDERS)
def test_coarse_codes_are_the_fine_codes_shifted(order):
    rng = np.random.default_rng(7)
    depth = 6
    g = torch.as_tensor(rng.integers(0, 2 ** depth, (500, 3)))
    s = torch.as_tensor(rng.integers(0, 4, 500))
    fine = ser.encode(g, s, depth, order)
    coarse = ser.encode(g >> 1, s, depth - 1, order)
    assert (fine >> 3).tolist() == coarse.tolist()


@pytest.mark.parametrize("counts", [[5, 3], [8], [10, 7, 20], [16, 17, 3, 25],
                                    [9, 0, 30]])
def test_pad_unpad_round_trip_every_point(counts):
    k = 8
    pad, unpad, total = ser.patch_indices(counts, k, "cpu")
    want_pad, want_unpad = ser.patch_indices_plain(counts, k)
    assert pad.tolist() == want_pad.tolist()
    assert unpad.tolist() == want_unpad.tolist()
    n = sum(counts)
    assert pad[unpad].tolist() == list(range(n))
    assert sorted(set(pad.tolist())) == list(range(n))
    runs = ser.patch_runs(counts, k)
    assert sum(p * length for _, p, length in runs) == total
    at = 0
    for c in counts:
        if c == 0:
            continue
        if c > k:
            # the last patch is filled with the points just before it
            p = -(-c // k) * k
            tail = pad[at + p - k:at + p] - pad[at]
            r = c % k or k
            assert tail[:r].tolist() == list(range(c - r, c))
            assert tail[r:].tolist() == list(range(c - k, c - r))
            at += p
        else:
            at += c
    assert at == total


def test_pooling_matches_a_per_cluster_max():
    rng = np.random.default_rng(3)
    coords = np.unique(np.concatenate([
        np.full((400, 1), 0), rng.integers(0, 12, (400, 3))], 1), axis=0)
    coords = coords.astype(np.int32)
    bucket = Bucket(level_caps=[512, 256], num_batches=2)
    s = Sample(coords=coords[:, 1:], feats=rng.normal(
        size=(len(coords), 6)).astype(np.float32),
        labels=np.zeros(len(coords), np.int32))
    g = collate([s], bucket, conv0_kernel=5, graph="ptv3")["graph"]
    info = g["levels"][0]
    n, n1 = g["counts"][0][0], g["counts"][1][0]
    x = torch.randn(512, 5)
    got = seg.segment_csr(x[torch.as_tensor(info["pool_perm"])],
                          torch.as_tensor(info["pool_ptr"]), None,
                          "max")[:n1]
    _, parent = voxel.downsample_coords(coords, 2)
    want = torch.stack([x[:n][torch.as_tensor(parent == j)].max(0).values
                        for j in range(n1)])
    assert torch.equal(got, want)
    assert (info["parent"][:n] == parent).all()
    head = info["pool_head"][:n1]
    assert (parent[head] == np.arange(n1)).all()


# --- data -------------------------------------------------------------------

def test_sphere_crop_count_takes_the_nearest_points():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 5, (1000, 3)).astype(np.float32)
    cloud = {"pos": pos, "rgb": rng.uniform(0, 1, (1000, 3)),
             "labels": np.arange(1000)}
    out = transforms3d.sphere_crop_count(cloud, 100, np.random.default_rng(1))
    centre = pos[int(np.random.default_rng(1).integers(1000))]
    d = ((pos - centre) ** 2).sum(1)
    assert sorted(out["labels"].tolist()) == sorted(
        np.argsort(d, kind="stable")[:100].tolist())
    assert (out["pos"] == pos[out["labels"]]).all()
    small = {"pos": pos[:50]}
    assert transforms3d.sphere_crop_count(small, 100, rng) is small


def _samples(counts, seed=0, extent=12):
    rng = np.random.default_rng(seed)
    out = []
    for n in counts:
        c = np.unique(rng.integers(0, extent, (n, 3)), axis=0)[:n]
        out.append(Sample(
            coords=(c + rng.integers(-20, 20, 3)).astype(np.int32),
            feats=rng.normal(size=(len(c), 6)).astype(np.float32),
            labels=rng.integers(-1, 4, len(c)).astype(np.int32)))
    return out


def test_ptv3_collate_route():
    samples = _samples([120, 7, 60])
    bucket = Bucket(level_caps=[256, 192, 128], num_batches=4)
    b = collate(samples, bucket, conv0_kernel=5, graph="ptv3")
    g = b["graph"]
    n0 = sum(len(s.coords) for s in samples)
    assert g["counts"][0] == [len(s.coords) for s in samples] + [0]
    assert g["conv0_nbr"].shape == (125, 256)
    assert g["levels"][0]["sub_nbr"].shape == (27, 256)
    assert len(g["levels"]) == 3 and "pool_ptr" not in g["levels"][2]
    grid = g["grid"][:n0]
    start = 0
    for s in samples:
        part = grid[start:start + len(s.coords)]
        assert (part.min(0) == 0).all()
        assert (part == s.coords - s.coords.min(0)).all()
        start += len(s.coords)
    assert g["depth"] == int(grid.max()).bit_length()
    assert b["feats"].shape == (256, 6) and (b["labels"][n0:] == -1).all()
    for lvl in range(2):
        info, nxt = g["levels"][lvl], g["levels"][lvl + 1]
        n, n1 = sum(g["counts"][lvl]), sum(g["counts"][lvl + 1])
        assert info["pool_ptr"][n1] == n and info["pool_ptr"][-1] == 256 \
            if lvl == 0 else info["pool_ptr"][-1] == 192
        assert nxt["valid"].sum() == n1
    with pytest.raises(ValueError, match="exceed"):
        collate(samples, Bucket(level_caps=[128, 128, 128], num_batches=4),
                graph="ptv3")
    # the UNet route by default
    unet = collate(samples, Bucket(level_caps=[256, 192, 128],
                                   num_batches=4), conv0_kernel=5)
    assert "counts" not in unet["graph"]


# --- the model against the reference ---------------------------------------

ARCH = {k: list(v) if isinstance(v, tuple) else v for k, v in
        dataclasses.asdict(tp.PTV3_PRESETS["PTv3Test"]).items()}


def _tiny(seed=0):
    spec = get_model_spec("PTv3-m1-base", 4, 6, {"backbone": "PTv3Test"})
    model = build_model(spec, device="cpu", seed=seed)
    model.compute_dtype = torch.float32
    return model


def _batches(n=3):
    bucket = Bucket(level_caps=[256, 160, 64], num_batches=3)
    out = []
    for k in range(n):
        out.append(collate(_samples([90, 6, 45], seed=10 + k, extent=6),
                           bucket, conv0_kernel=5, graph="ptv3"))
    return out


def _close(a, b, tol, what):
    scale = max(float(b.abs().max()), 1e-12)
    err = float((a - b).abs().max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of its largest magnitude"


def test_ptv3_matches_the_reference_in_logits_loss_and_gradients():
    torch.manual_seed(0)
    model = _tiny()
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batches(1)[0]
    dev = batch_to_torch(device_view(batch), "cpu")
    model.train()
    model.record = []
    out = model(dev, generator=torch.Generator().manual_seed(5))
    valid = dev["graph"]["levels"][0]["valid"]
    loss = segmentation_loss(out["logits"], dev["labels"], valid, 1.0)
    loss.backward()
    assert any(r[0] == "keep" for r in model.record)
    inp = ref.inputs_from_batch(batch, "cpu", 2)
    draws = ref.map_draws(model.record, inp)
    P = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    logits = ref.forward(P, inp, ARCH, ref.Precision("f32"), draws)
    rloss = ref.loss_fn(logits, inp["labels"])
    rloss.backward()
    n = int(valid.sum())
    _close(out["logits"][:n].detach(), logits.detach(), 2e-5, "logits")
    got, want = float(loss.detach()), float(rloss.detach())
    assert abs(got - want) <= 2e-5 * abs(want)
    # a leaf whose true gradient is zero (the bias of a linear layer right
    # before a BatchNorm) holds round-off alone: each leaf is held against
    # the larger of its own largest magnitude and a hundredth of the net's
    top = max(float(P[k].grad.abs().max()) for k in P)
    errs = {}
    for name, p in model.named_parameters():
        scale = max(float(P[name].grad.abs().max()), 1e-2 * top)
        errs[name] = float((p.grad - P[name].grad).abs().max()) / scale
    assert max(errs.values()) <= 2e-5, max(errs.items(), key=lambda kv: kv[1])


def test_ptv3_three_adamw_one_cycle_steps_match_the_reference():
    model = _tiny(seed=1)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    kw = recipe_lr_keywords("PTv3-m1-base")
    assert kw == {"block": 0.1}
    tx = make_optimizer(make_schedule("one_cycle", LR, TOTAL), "adamw",
                        weight_decay=0.05, grad_clip=None, lr_keywords=kw,
                        beta1_schedule=one_cycle_beta1(TOTAL))
    state = TrainState.create(model, tx)
    step = make_train_step(model, lovasz_weight=1.0)
    gen = torch.Generator().manual_seed(9)
    batches = _batches(3)
    records, losses = [], []
    for b in batches:
        model.record = []
        state, metrics = step(state, batch_to_torch(device_view(b), "cpu"),
                              gen)
        records.append(model.record)
        losses.append(float(metrics["loss"]))
    inputs = [ref.inputs_from_batch(b, "cpu", 2) for b in batches]
    draws = [ref.map_draws(r, i) for r, i in zip(records, inputs)]
    hp = {"base_lr": LR, "weight_decay": 0.05, "total_steps": TOTAL,
          "block_lr_scale": 0.1}
    out = ref.train_steps(init, inputs, ARCH, hp, ref.Precision("f32"),
                          draws)
    for a, b in zip(losses, out["loss"]):
        assert abs(a - b) <= 2e-5 * abs(b)
    # an element whose true gradient is zero (the key's bias: softmax does
    # not see it; a bias right before a BatchNorm) takes Adam steps of the
    # sign of round-off: such elements (first gradient under 1e-5 of the
    # net's largest) are left out, every other one held
    top = max(float(g.abs().max()) for g in out["grad"].values())
    held = 0
    for name, p in model.named_parameters():
        keep = out["grad"][name].abs() >= 1e-5 * top
        got = p.detach() - init[name]
        err = float(((got - out["delta"][name]) * keep).abs().max())
        assert err <= 1e-3 * LR, (name, err)
        held += int(keep.sum())
    assert held >= 0.95 * sum(p.numel() for p in model.parameters())


def test_one_cycle_follows_torch_one_cycle_lr():
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=LR)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=LR, total_steps=TOTAL, pct_start=0.05,
        div_factor=10.0, final_div_factor=1000.0)
    lr = make_schedule("one_cycle", LR, TOTAL)
    beta1 = one_cycle_beta1(TOTAL)
    for k in range(TOTAL):
        g = opt.param_groups[0]
        assert lr(k) == pytest.approx(g["lr"], rel=1e-12)
        assert beta1(k) == pytest.approx(g["betas"][0], rel=1e-12)
        opt.step()
        sched.step()


def test_block_parameters_take_a_tenth_of_the_rate():
    model = _tiny()
    tx = make_optimizer(make_schedule("constant", 1.0), "adamw",
                        lr_keywords={"block": 0.1})
    tx.init(model.named_parameters())
    scales = {id(p): g.scale for g in tx.groups for p in g.params}
    for name, p in model.named_parameters():
        assert scales[id(p)] == (0.1 if "block" in name else 1.0), name


def test_base_model_has_the_published_widths():
    spec = get_model_spec("PTv3-m1-base", 13, 6)
    model = build_model(spec, device="meta", seed=None)
    n = sum(p.numel() for p in model.parameters())
    assert n == 46_167_117                      # the paper: 46.2M
    assert model.head.weight.shape == (13, 64)
    blk = model.enc.enc3.block5.attn
    assert (blk.heads, blk.patch, blk.order_index) == (16, 1024, 1)
    assert model.stem.conv.weight.shape == (125, 6, 32)
    enc, dec = tp.drop_path_rates(tp.PTV3_PRESETS["PTv3-m1-base"])
    assert enc[0][0] == 0.0 and enc[-1][-1] == pytest.approx(0.3)
    assert dec[0] == pytest.approx([0.3 / 7, 0.0])


def test_cli_train_two_steps_on_a_tiny_synthetic_room(tmp_path):
    from deepviewagg_tpu_torch.cli import train as cli

    metrics = cli.main([
        "--config", "conf/s3dis_ptv3.yaml", "--device", "cpu",
        "training.epochs=1", "data.samples_per_epoch=4", "data.batch_size=2",
        "data.voxel_size=0.1", f"data.root={tmp_path}/areas",
        f"training.run_dir={tmp_path}/run", "training.tensorboard=false",
        "'model.overrides={backbone: PTv3Test}'".strip("'"),
        "data.kwargs={n_areas: 1, density: 100.0, n_cameras: 0, "
        "cache_voxel_size: 0.1, point_max: 600, point_feats: color_normal}"])
    assert metrics["train_batches"] == 2
    assert np.isfinite(metrics["train_loss"])
