"""Point Transformer V2 in the port (``nn/ptv2.py``, the ``"ptv2"``
collate route, the zoo's ``PTv2-m2-base``, ``cli.train``) against the
benchmark's plain reference (``benchmark/reference/ptv2.py``), on the CPU.

Weights: seeded, and then every bias and norm scale drawn around its
initial value (a zero bias before a BatchNorm meets zero-offset neighbour
slots in exact ties at the ReLU, whose gradient either side may take).

Bounds.  Neighbour tables, clusters, cluster sizes and mean positions are
exact (the same float32 arithmetic, float64 sums).  The model against the
reference, both in float32: the two sum in different orders (BatchNorm from
Welford against means, ``index_select`` and its scattered backward against
indexing, the cluster maximum's kernel against ``scatter_reduce``), so
logits, losses and gradients agree to float32 round-off carried through
the net's depth: 1e-4 of the tensor's largest magnitude (observed up to
3.0e-5 on the two threads the tests pin, 4.1e-5 on one, where a
BatchNorm's statistics sum the N x S rows in one sequence), a gradient's
floored at a hundredth of the net's largest (a leaf
whose true gradient is zero holds round-off alone: the bias of a linear
layer right before a BatchNorm, the last bias of the weight encoding, which
the softmax over the neighbours does not see, and, where no slot is
missing, the value's and the positional bias's, whose sum the BatchNorm
after the attention takes out); the biases right before a BatchNorm, whose
round-off sums over every row, to 1e-4 of the net's largest gradient.  The
parameters after three AdamW steps: Adam
divides each gradient by its own root mean square, so an element whose
gradient is round-off sized moves by a sign of round-off; the change is
held to 2e-3 of the learning rate per element on the elements whose first
gradient is above 1e-4 of the net's largest, at least 95% of them (below,
an element's float32 round-off is within a few hundredths of its gradient,
and Adam's first step divides by the gradient's own size; above, observed
up to 1.0e-3 on the tests' two threads: Adam carries each step's relative
round-off of the gradient into a step of the rate's size).  The
reference run whole in bfloat16 is held to the same bounds and fails them
(its logits move by about 1e-2: bfloat16's 8 bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import ptv2 as ref
from deepviewagg_tpu_torch.config.zoo import get_model_spec
from deepviewagg_tpu_torch.data.collate import (Bucket, Sample,
                                                batch_to_torch, collate,
                                                device_view)
from deepviewagg_tpu_torch.models.losses import segmentation_loss
from deepviewagg_tpu_torch.models.segmentation import build_model
from deepviewagg_tpu_torch.nn import ptv2 as tp
from deepviewagg_tpu_torch.nn.norm import PointBatchNorm
from deepviewagg_tpu_torch.train.optimizers import (make_optimizer,
                                                    make_schedule)
from deepviewagg_tpu_torch.train.step import TrainState, make_train_step

LR = 0.006
TOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads, whatever the machine has: the CPU's reductions
    then sum in one order on every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
ARCH = {k: list(v) if isinstance(v, tuple) else v for k, v in
        dataclasses.asdict(tp.PTV2_PRESETS["PTv2Test"]).items()}


def _samples(sizes, seed, extent=3.0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        pos = (rng.random((n, 3)) * np.array([extent, extent, 1.0])
               ).astype(np.float32)
        out.append(Sample(coords=(pos / 0.05).astype(np.int32),
                          feats=rng.normal(size=(n, 6)).astype(np.float32),
                          labels=rng.integers(-1, 4, n).astype(np.int32),
                          pos=pos))
    return out


def _batch(sizes, seed, cap=None):
    cap = cap or sum(sizes)
    return collate(_samples(sizes, seed), Bucket(level_caps=[cap],
                                                 num_batches=4),
                   graph="ptv2")


def _tiny(seed=0, dtype=torch.float32):
    spec = get_model_spec("PTv2-m2-base", 4, 6, {"backbone": "PTv2Test"})
    model = build_model(spec, device="cpu", seed=seed)
    model.compute_dtype = dtype
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                d = torch.randn(p.shape, generator=gen) * 0.1
                p.copy_(d if name.endswith("bias") else 1.0 + d)
    return model


def _run(model, batch, gen_seed=5):
    dev = batch_to_torch(device_view(batch), "cpu")
    model.train()
    model.record = []
    out = model(dev, generator=torch.Generator().manual_seed(gen_seed))
    valid = dev["graph"]["levels"][0]["valid"]
    loss = segmentation_loss(out["logits"], dev["labels"], valid, 0.0)
    model.zero_grad()
    loss.backward()
    record, model.record = model.record, None
    return out["logits"].detach(), float(loss.detach()), record, valid


def _reference(model, init, batch, record, prec):
    inp = ref.inputs_from_batch(batch, "cpu", ARCH)
    draws = ref.map_draws(record, inp)
    P = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    logits = ref.forward(P, inp, ARCH, prec, draws)
    loss = ref.loss_fn(logits, inp["labels"])
    loss.backward()
    return logits.detach(), float(loss.detach()), P, inp


def _gaps(model, logits, loss, rlogits, rloss, P, n):
    lg = float((logits[:n] - rlogits).abs().max() / rlogits.abs().max())
    top = max(float(P[k].grad.abs().max()) for k in P)
    errs = {}
    for name, p in model.named_parameters():
        scale = (top if name.endswith(PRE_BN_BIAS)
                 else max(float(P[name].grad.abs().max()), 1e-2 * top))
        errs[name] = float((p.grad - P[name].grad).abs().max()) / scale
    return lg, abs(loss - rloss) / abs(rloss), errs


# the biases of the linear layers right before a BatchNorm: their true
# gradient is zero, and their round-off is a sum over every row (N x S in
# the attention's encodings)
PRE_BN_BIAS = (".q.bias", ".k.bias", ".pe1.bias", ".we1.bias",
               "up.proj.bias", "up.proj_skip.bias", "head.fc1.bias")


# sample sizes: one sample below the patch embedding's 4 neighbours and
# one below the stages' 8 at every level
SIZES = {"plain": [260, 7, 180], "small": [3, 200, 150, 40]}


@pytest.mark.parametrize("case", sorted(SIZES))
def test_ptv2_matches_the_reference_in_logits_loss_and_gradients(case):
    model = _tiny()
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch(SIZES[case], seed=len(case))
    logits, loss, record, valid = _run(model, batch)
    assert any(r[0] == "keep" for r in record)
    rlogits, rloss, P, inp = _reference(model, init, batch, record,
                                        ref.Precision("f32"))
    if case == "small":
        assert any(c < 8 for c in inp["levels"].counts[0])
        assert (inp["levels"].knn[0][0] < 0).any()
    lg, ls, errs = _gaps(model, logits, loss, rlogits, rloss, P,
                         int(valid.sum()))
    assert lg <= TOL and ls <= TOL
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda kv: kv[1])


def test_the_reference_in_bfloat16_fails_the_bounds():
    model = _tiny()
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch(SIZES["plain"], seed=5)
    logits, loss, record, valid = _run(model, batch)
    rlogits, rloss, P, _ = _reference(model, init, batch, record,
                                      ref.Precision("bf16"))
    lg, ls, errs = _gaps(model, logits, loss, rlogits, rloss, P,
                         int(valid.sum()))
    assert lg > TOL and max(errs.values()) > TOL


def test_ptv2_three_adamw_steps_match_the_reference():
    model = _tiny(seed=1)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    tx = make_optimizer(make_schedule("multi_step", LR, milestones=(2,),
                                      gamma=0.1), "adamw",
                        weight_decay=0.05, grad_clip=None)
    state = TrainState.create(model, tx)
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(9)
    batches = [_batch([150, 90, 6], seed=20 + k) for k in range(3)]
    records, losses = [], []
    for b in batches:
        model.record = []
        state, metrics = step(state, batch_to_torch(device_view(b), "cpu"),
                              gen)
        records.append(model.record)
        losses.append(float(metrics["loss"]))
    inputs = [ref.inputs_from_batch(b, "cpu", ARCH) for b in batches]
    draws = [ref.map_draws(r, i) for r, i in zip(records, inputs)]
    hp = {"base_lr": LR, "weight_decay": 0.05, "lr_milestones": [2],
          "lr_gamma": 0.1}
    out = ref.train_steps(init, inputs, ARCH, hp, ref.Precision("f32"),
                          draws)
    for a, b in zip(losses, out["loss"]):
        assert abs(a - b) <= TOL * abs(b)
    top = max(float(g.abs().max()) for g in out["grad"].values())
    held = 0
    for name, p in model.named_parameters():
        keep = out["grad"][name].abs() >= 1e-4 * top
        err = ((p.detach() - init[name] - out["delta"][name]) * keep).abs()
        assert float(err.max()) <= 2e-3 * LR, (name, float(err.max()))
        held += int(keep.sum())
    assert held >= 0.95 * sum(p.numel() for p in model.parameters())


def test_padding_rows_change_no_output_and_no_statistic():
    outs = []
    for cap in (None, 700):
        model = _tiny(seed=2)
        batch = _batch([260, 7, 180], seed=3, cap=cap)
        logits, loss, _, valid = _run(model, batch)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        outs.append((logits, loss, stats, grads, valid))
    (l0, s0, st0, g0, v0), (l1, s1, st1, g1, v1) = outs
    n = int(v0.sum())
    assert l1.shape[0] == 700 and int(v1.sum()) == n
    assert torch.equal(l0, l1[:n]) and (l1[n:] == 0).all()
    # the loss's masked mean adds the padding rows' zeros too, in an order
    # of the thread count's: one float32 rounding apart at most
    assert abs(s0 - s1) <= 1e-6 * abs(s0)
    for k in st0:
        assert torch.equal(st0[k], st1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_grid_pooling_matches_the_reference():
    batch = _batch([400, 3, 250, 60], seed=7)
    inp = ref.inputs_from_batch(batch, "cpu", ARCH, search=False)
    lv = inp["levels"]
    counts = batch["graph"]["counts"][0]
    pos = torch.as_tensor(batch["pos"][:sum(counts)])
    sample = torch.as_tensor(batch["graph"]["levels"][0]["batch_idx"]
                             [:sum(counts)])
    x = torch.randn(pos.shape[0], 5)
    for lvl, grid in enumerate(ARCH["grid_sizes"]):
        order, ptr, cluster, nxt, offsets, nsample, mean = \
            tp.grid_clusters(pos, sample, counts, grid)
        assert nxt == lv.counts[lvl + 1]
        assert offsets.tolist() == [0] + np.cumsum(nxt).tolist()
        assert torch.equal(cluster, lv.cluster[lvl])
        assert torch.equal(mean, lv.pos[lvl + 1])
        assert torch.equal(nsample.long(), lv.sample[lvl + 1])
        from deepviewagg_tpu_torch.ops import segment as seg
        got = seg.segment_csr(x[order], ptr, None, "max")
        want = torch.full((len(mean), 5), -torch.inf).scatter_reduce(
            0, cluster[:, None].expand_as(x), x, "amax")
        assert torch.equal(got, want)
        x = want
        pos, sample, counts = mean, nsample, nxt


def test_point_batch_norm_is_batchnorm1d_over_every_row():
    torch.manual_seed(0)
    bn = PointBatchNorm(5)
    ref_bn = torch.nn.BatchNorm1d(5)
    x = torch.randn(40, 3, 5)
    got = bn(x)
    want = ref_bn(x.transpose(1, 2)).transpose(1, 2)
    assert torch.allclose(got, want, atol=1e-6)
    assert torch.allclose(bn.running_var, ref_bn.running_var)
    assert bn(x.to(torch.bfloat16)).dtype == torch.bfloat16
    assert bn(x.to(torch.bfloat16), torch.float32).dtype == torch.float32


def test_base_model_has_the_published_widths():
    spec = get_model_spec("PTv2-m2-base", 13, 6)
    model = build_model(spec, device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == 11_323_461
    cfg = tp.PTV2_PRESETS["PTv2-m2-base"]
    assert model.stem.proj.weight.shape == (48, 6)
    assert model.stem.blocks.k == 8 and model.stem.blocks.depth == 1
    assert model.stem.blocks.block0.attn.groups == 6
    for s, (d, c, g) in enumerate(zip(cfg.enc_depths, cfg.enc_channels,
                                      cfg.enc_groups)):
        stage = getattr(model.enc, f"enc{s}")
        assert stage.blocks.depth == d and stage.blocks.k == 16
        assert stage.blocks.block0.attn.groups == g
        assert stage.blocks.block0.fc1.weight.shape == (c, c)
        assert stage.down.grid == cfg.grid_sizes[s]
        assert stage.blocks.block0.fc1.bias is None
    widths = list(cfg.dec_channels) + [cfg.enc_channels[-1]]
    for s, (c, g) in enumerate(zip(cfg.dec_channels, cfg.dec_groups)):
        stage = getattr(model.dec, f"dec{s}")
        assert stage.up.proj.weight.shape == (c, widths[s + 1])
        assert stage.blocks.block0.attn.groups == g
    assert model.head.fc1.weight.shape == (48, 48)
    assert model.head.fc2.weight.shape == (13, 48)
    enc, dec = tp.drop_path_rates(cfg)
    assert enc[0][0] == 0.0 and enc[-1][-1] == pytest.approx(0.3)
    assert [r[0] for r in dec] == pytest.approx([0.0, 0.1, 0.2, 0.3])


def test_the_route_carries_points_offsets_and_no_structure():
    batch = _batch([30, 0, 12], seed=1, cap=64)
    g = batch["graph"]
    assert set(g) == {"levels", "offset", "counts"}
    assert g["offset"].tolist() == [0, 30, 30, 42, 42]
    assert g["counts"] == [[30, 0, 12, 0]]
    assert g["levels"][0]["valid"].sum() == 42
    assert batch["pos"].shape == (64, 3) and batch["labels"][42:].max() == -1
    with pytest.raises(ValueError, match="positions"):
        s = _samples([5], 0)
        s[0].pos = None
        collate(s, Bucket(level_caps=[8], num_batches=1), graph="ptv2")


def test_cli_train_two_steps_on_a_tiny_synthetic_room(tmp_path):
    from deepviewagg_tpu_torch.cli import train as cli

    metrics = cli.main([
        "--config", "conf/s3dis_ptv2.yaml", "--device", "cpu",
        "training.epochs=1", "data.samples_per_epoch=4", "data.batch_size=2",
        "data.voxel_size=0.1", f"data.root={tmp_path}/areas",
        f"training.run_dir={tmp_path}/run", "training.tensorboard=false",
        "model.overrides={backbone: PTv2Test}",
        "data.kwargs={n_areas: 1, density: 100.0, n_cameras: 0, "
        "cache_voxel_size: 0.1, point_max: 600, point_feats: color_normal}"])
    assert metrics["train_batches"] == 2
    assert np.isfinite(metrics["train_loss"])
