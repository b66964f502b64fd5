"""The PyTorch port stands alone: no module of ``deepviewagg_tpu_torch``
imports JAX, flax or the JAX package, and its entry points default to the
card."""

import ast
import inspect
from pathlib import Path

import pytest

import deepviewagg_tpu_torch

PKG = Path(deepviewagg_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepviewagg_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_the_card():
    from deepviewagg_tpu_torch.data import collate, geometric, mapping_factory, toy
    from deepviewagg_tpu_torch.models.segmentation import MultimodalSeg

    for fn in (toy.toy_batch, toy.toy_samples, mapping_factory.build_mappings,
               geometric.pca_features, collate.batch_to_torch,
               MultimodalSeg.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
