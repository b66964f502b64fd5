"""End-to-end demo: build a synthetic multimodal scene, train a small
flagship briefly, and export the interactive HTML viewer and a PLY snapshot
(the role of the reference's synthetic / inference notebooks, SURVEY.md
§4.2-4):

    python -m deepviewagg_tpu_torch.cli.demo_synthetic --out /tmp/dva_demo

The port of the root ``scripts/demo_synthetic.py``, with its settings: two
toy samples (density 100, two cameras of 128 x 64), the flagship with a
``Res16UNetTest`` backbone, a ``resnet18_l2`` tower and four groups, the
``Trainer`` at a constant LR of 0.05 over eight copies of the batch per
epoch, then the eval step's predictions of the first sample written as
``sample.ply`` and ``viewer.html`` under ``--out``.  It trains on the card
unless ``--device cpu``; every step runs both segment kernels there.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .train import setup_device

__all__ = ["main"]


def main(argv=None) -> dict:
    """Returns the last epoch's metrics, the two files' paths, the first
    sample and its predictions."""
    p = argparse.ArgumentParser(
        prog="python -m deepviewagg_tpu_torch.cli.demo_synthetic")
    p.add_argument("--out", default="/tmp/dva_demo")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = setup_device(args.device)

    from ..data.toy import flagship_spec, toy_batch
    from ..models.segmentation import MultimodalSeg
    from ..train.trainer import Trainer, TrainerConfig
    from ..visualization import export_html, save_ply_snapshot

    os.makedirs(args.out, exist_ok=True)
    batch, _, samples = toy_batch(
        n_samples=2, density=100.0, image_size=(128, 64), n_cameras=2,
        device=device,
    )
    spec = flagship_spec(backbone="Res16UNetTest", tower="resnet18_l2",
                         num_groups=4)
    model = MultimodalSeg(spec, device=device, seed=0)
    cfg = TrainerConfig(epochs=args.epochs, base_lr=0.05,
                        lr_schedule="constant", track_every=1,
                        run_dir=args.out)
    tr = Trainer(model, spec.num_classes, cfg)
    metrics = tr.fit(lambda: [batch] * 8, lambda: [batch])
    print({k: round(v, 2) for k, v in metrics.items()})

    out = tr._eval_step(tr.state, tr._to_device(batch))
    preds = out["preds"].cpu().numpy()
    s = samples[0]
    n0 = len(s.coords)
    ply = os.path.join(args.out, "sample.ply")
    save_ply_snapshot(ply, s.pos, rgb=s.feats[:, :3], labels=s.labels,
                      preds=preds[:n0])
    html = export_html(
        os.path.join(args.out, "viewer.html"), s.pos, rgb=s.feats[:, :3],
        labels=s.labels, preds=preds[:n0], images=s.images,
        mapping=s.mapping, title="deepviewagg_tpu synthetic demo",
    )
    print("wrote", ply, "and", html)
    return {"metrics": metrics, "ply": ply, "html": html, "sample": s,
            "preds": np.asarray(preds[:n0])}


if __name__ == "__main__":
    main()
