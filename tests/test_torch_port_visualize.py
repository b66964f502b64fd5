"""The port's per-epoch ``.ply`` sample dump against the JAX package's
``visualization.viewer.save_ply_snapshot``: the same arrays give the same
bytes, with and without colours, labels and predictions."""

import numpy as np
import pytest

from deepviewagg_tpu.visualization import save_ply_snapshot as jax_snapshot
from deepviewagg_tpu_torch.visualization import save_ply_snapshot


@pytest.mark.parametrize("fields", [("rgb", "labels", "preds"),
                                    ("labels", "preds"), ("rgb",), ()])
def test_ply_snapshot_is_byte_identical_to_jax(tmp_path, fields):
    rng = np.random.default_rng(0)
    n = 257
    arrays = {"rgb": rng.random((n, 3)) * 1.1 - 0.05,      # clipped
              "labels": rng.integers(-1, 13, n),
              "preds": rng.integers(0, 13, n)}
    pos = rng.normal(size=(n, 3)) * 5
    kw = {k: arrays[k] for k in fields}
    jax_snapshot(str(tmp_path / "jax.ply"), pos, **kw)
    save_ply_snapshot(str(tmp_path / "sub" / "port.ply"), pos, **kw)
    assert (tmp_path / "sub" / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
