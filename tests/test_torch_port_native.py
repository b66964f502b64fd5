"""The port's native host builders (``deepviewagg_tpu_torch/native``: the
C ABI copy of ``kernelmap.cpp``, built by g++ at first use) against the JAX
package's CPython extension and against the port's own numpy versions
(``*_plain``), on the same inputs.

Bounds.  Voxel hashing, kernel maps and the grid kNN are byte-equal to the
JAX extension (ties included) and to the numpy paths; the grid kNN against
the brute-force ``knn`` (expanded-form distances, another rounding) at the
JAX package's own bounds (``tests/test_native.py``): distances within
``rtol 1e-3, atol 2e-4``, ids at least 99.9% equal.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepviewagg_tpu import native as jnative
from deepviewagg_tpu.ops import knn as jknn
from deepviewagg_tpu.ops import sparse_graph as jsg
from deepviewagg_tpu_torch import native as tnative
from deepviewagg_tpu_torch.ops import kernel_map as tkm
from deepviewagg_tpu_torch.ops import knn as tknn
from deepviewagg_tpu_torch.ops import sparse_graph as tsg
from deepviewagg_tpu_torch.ops import voxel as tvox
from deepviewagg_tpu_torch.utils import cuda_build
from torch_port_util import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jlib():
    assert jnative.lib is not None, "the JAX package's extension is not built"
    return jnative.lib


def _coords(seed=0, n=4000, batches=3, span=20, unique=False):
    """Voxel rows ``[b, x, y, z]`` with repeats (``unique=False``) or not."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.integers(0, batches, (n, 1)),
                        rng.integers(-span, span, (n, 3))], 1).astype(np.int32)
    return np.unique(c, axis=0) if unique else c


def _identical(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# --- against the JAX extension ----------------------------------------------

@pytest.mark.parametrize("span", [3, 20, (1 << 18) - 1])
def test_unique_inverse_matches_jax(jlib, span):
    c = _coords(1, span=span)
    if span > 100:      # the key range's extremes
        c[:4, 1:] = [[span] * 3, [-span] * 3, [span, -span, 0],
                     [0, 0, -span]]
    for got, want in zip(tnative.unique_inverse(c), jlib.unique_inverse(c)):
        _identical(got, want)


def test_query_coords_matches_jax(jlib):
    table = _coords(2, unique=True)
    queries = np.concatenate([table[::3], _coords(3, n=500)])
    _identical(tnative.query_coords(table, queries),
               jlib.query_coords(table, queries))


@pytest.mark.parametrize("ks,stride,pad", [(3, 1, 0), (3, 1, 37), (2, 2, 0),
                                           (2, 2, 11), (5, 1, 3), (3, 4, 0)])
def test_build_kernel_map_matches_jax(jlib, ks, stride, pad):
    c_in = _coords(4, unique=True)
    c_out = (tvox.downsample_coords(c_in, stride)[0] if stride > 1
             else c_in)
    offsets = tkm.kernel_offsets(ks)
    caps = ((len(c_in) + pad, len(c_out) + 2 * pad) if pad else ())
    want = jlib.build_kernel_map(c_in, c_out, offsets, stride, *caps)
    _identical(tnative.build_kernel_map(c_in, c_out, offsets, stride, *caps),
               want)


@pytest.mark.parametrize("case", ["uniform", "duplicates", "clustered",
                                  "fewer_than_k"])
def test_knn_grid_matches_jax(case):
    """Byte-equal to the JAX package's ``knn_grid`` with its default cell,
    ties included (exact duplicates tie at distance 0)."""
    rng = np.random.default_rng(5)
    pos = (rng.random((6000, 3)) * 4).astype(np.float32)
    if case == "duplicates":
        pos[:300] = pos[300:600]
    elif case == "clustered":
        pos = np.concatenate([np.zeros((5, 3), np.float32),
                              rng.normal(0, 0.01, (100, 3)).astype(np.float32),
                              pos[:2000]])
    elif case == "fewer_than_k":
        pos = pos[:5]
    queries = np.concatenate([pos[::2], pos[:50] + 0.01])
    for k in (1, 8, 16):
        want = jknn.knn_grid(queries, pos, k)
        got = tknn.knn_grid(queries, pos, k)
        for g, w in zip(got, want):
            _identical(g, np.asarray(w))


# --- against the numpy versions ---------------------------------------------

def test_unique_and_query_match_plain():
    c = _coords(6)
    for got, want in zip(tvox.unique_coords(c), tvox.unique_coords_plain(c)):
        _identical(got, want)
    table = _coords(7, unique=True)
    queries = np.concatenate([table[::2], _coords(8, n=300)])
    _identical(tvox.query_coords(table, queries),
               tvox.query_coords_plain(table, queries))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("ks,stride", [(3, 1), (2, 2), (5, 1)])
def test_kernel_maps_match_plain(padded, ks, stride):
    c_in = _coords(9, unique=True)
    c_out = (tvox.downsample_coords(c_in, stride)[0] if stride > 1
             else c_in)
    if padded:
        caps = (len(c_in) + 100, len(c_out) + 60)
        got = tsg._build_padded_map(c_in, c_out, ks, stride, *caps)
        want = tsg._build_padded_map_plain(c_in, c_out, ks, stride, *caps)
    else:
        got = tkm.build_kernel_map(c_in, c_out, ks, stride)
        want = tkm.build_kernel_map_plain(c_in, c_out, ks, stride)
    _identical(got.nbr, want.nbr)
    assert (got.n_in, got.n_out, got.kernel_size, got.stride) == (
        want.n_in, want.n_out, want.kernel_size, want.stride)


def _plain_builders(monkeypatch):
    monkeypatch.setattr(tvox, "unique_coords", tvox.unique_coords_plain)
    monkeypatch.setattr(tvox, "query_coords", tvox.query_coords_plain)
    monkeypatch.setattr(tkm, "build_kernel_map", tkm.build_kernel_map_plain)
    monkeypatch.setattr(tsg, "_build_padded_map", tsg._build_padded_map_plain)


def test_unet_graph_matches_plain_and_jax(monkeypatch):
    """The whole UNet graph (every level's coordinates, maps and parents)
    built by the native builders, by the numpy versions, and by the JAX
    package (which takes its extension)."""
    c = _coords(10, n=3000, unique=True)
    kw = dict(num_levels=5, num_batches=3, conv0_kernel=5, cap_multiple=128)
    native = tsg.graph_to_device(tsg.build_unet_graph(c, **kw))
    want = jsg.graph_to_device(jsg.build_unet_graph(c, **kw))
    with monkeypatch.context() as mp:
        _plain_builders(mp)
        plain = tsg.graph_to_device(tsg.build_unet_graph(c, **kw))
    for other in (plain, want):
        for a, b in zip(native["levels"], other["levels"]):
            assert sorted(a) == sorted(b)
            for key in a:
                _identical(a[key], b[key])
        _identical(native["conv0_nbr"], other["conv0_nbr"])


def test_collate_takes_the_native_builders(monkeypatch):
    """``build_unet_graph`` reaches the native builders and not the numpy
    versions."""
    def refuse(*a, **k):
        raise AssertionError("a numpy builder ran on the main path")

    for mod, name in ((tvox, "unique_coords_plain"),
                      (tvox, "query_coords_plain"),
                      (tkm, "build_kernel_map_plain"),
                      (tsg, "_build_padded_map_plain")):
        monkeypatch.setattr(mod, name, refuse)
    calls = []
    inner = tnative.build_kernel_map
    monkeypatch.setattr(tnative, "build_kernel_map",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    tsg.build_unet_graph(_coords(11, n=800, unique=True), 3, num_batches=3,
                         conv0_kernel=3, cap_multiple=128)
    # three submanifold maps and two down maps
    assert len(calls) == 5


# --- threads ------------------------------------------------------------------

def test_bytes_do_not_depend_on_the_thread_count():
    """Above the sizes where the builders split their work (K * M >= 2^18
    probes, M >= 4096 kNN queries)."""
    c = _coords(12, n=30000, span=40, unique=True)
    offsets = tkm.kernel_offsets(3)
    assert len(offsets) * len(c) >= 1 << 18
    one = tnative.build_kernel_map(c, c, offsets, 1, threads=1)
    for threads in (2, 7, 16):
        _identical(tnative.build_kernel_map(c, c, offsets, 1,
                                            threads=threads), one)
    pos = (np.random.default_rng(13).random((9000, 3)) * 3).astype(
        np.float32)
    d1, i1 = tnative.knn_grid(pos, pos, 12, 0.2, threads=1)
    for threads in (3, 16):
        d, i = tnative.knn_grid(pos, pos, 12, 0.2, threads=threads)
        _identical(d, d1)
        _identical(i, i1)


# --- errors -------------------------------------------------------------------

@pytest.mark.parametrize("row", [[0, 1 << 18, 0, 0], [0, 0, -(1 << 18), 0],
                                 [-1, 0, 0, 0], [64, 0, 0, 0]])
def test_out_of_range_rows_raise(jlib, row):
    bad = _coords(14, n=50, unique=True)
    bad[7] = row
    good = _coords(15, n=50, unique=True)
    offsets = tkm.kernel_offsets(3)
    cases = [
        (lambda lib: lib.unique_inverse(bad), "coords row 7"),
        (lambda lib: lib.query_coords(bad, good), "table row 7"),
        (lambda lib: lib.query_coords(good, bad), "queries row 7"),
        (lambda lib: lib.build_kernel_map(bad, good, offsets, 1),
         "in_coords row 7"),
        (lambda lib: lib.build_kernel_map(good, bad, offsets, 1),
         "out_coords row 7")]
    for call, what in cases:
        with pytest.raises(ValueError) as want:
            call(jlib)
        with pytest.raises(ValueError) as got:
            call(tnative)
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith(what + " out of 19-bit key range")


def test_bad_arguments_raise():
    c = _coords(16, n=100, unique=True)
    with pytest.raises(ValueError, match="capacity below row count"):
        tnative.build_kernel_map(c, c, tkm.kernel_offsets(3), 1, len(c) - 1)
    with pytest.raises(ValueError, match=r"int32 \[N, 4\]"):
        tnative.unique_inverse(c[:, :3])
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="empty points"):
        tnative.knn_grid(pts[:0], pts, 2, 1.0)
    with pytest.raises(ValueError, match="cell>0"):
        tnative.knn_grid(pts, pts, 2, 0.0)
    # a query more than 16 cells from every point
    with pytest.raises(ValueError, match="query 1 has no point"):
        tnative.knn_grid(pts, np.array([[0, 0, 0], [50, 0, 0]], np.float32),
                         2, 1.0)


# --- the grid kNN against the brute force -----------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_knn_grid_against_brute_force(seed):
    """The JAX package's own check (``tests/test_native.py``) on the port:
    the same neighbour sets as ``knn`` within float32 rounding; self first
    at distance 0; ascending distances."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((20000, 3)) * 10).astype(np.float32)
    d2g, ig = tknn.knn_grid(pos, pos, 30)
    d2b, ib = tknn.knn(torch.from_numpy(pos[:400]), torch.from_numpy(pos),
                       30)
    np.testing.assert_allclose(np.sort(d2g[:400], axis=1),
                               np.sort(d2b.numpy(), axis=1),
                               rtol=1e-3, atol=2e-4)
    agree = np.sort(ig[:400], axis=1) == np.sort(ib.numpy(), axis=1)
    assert agree.mean() > 0.999
    np.testing.assert_array_equal(ig[:, 0], np.arange(len(pos)))
    assert (np.diff(d2g, axis=1) >= 0).all()
    assert d2g.dtype == np.float32 and ig.dtype == np.int32


# --- the build ----------------------------------------------------------------

def test_two_processes_building_at_once_leave_one_library(tmp_path):
    """Two processes build the library into an empty directory at the same
    time: one ``.so`` is left, no temporary file, and it loads."""
    script = ("import sys; from pathlib import Path; "
              "from deepviewagg_tpu_torch.utils import cuda_build as c; "
              "c._BUILD = Path(sys.argv[1]); c.load('kernelmap'); "
              "print('loaded')")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("loaded" in o for o in outs)
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == [cuda_build._target("kernelmap").name], left


def test_a_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    src = tmp_path / "native" / "kernelmap.cpp"
    src.parent.mkdir()
    src.write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "_PKG", tmp_path)
    monkeypatch.setattr(cuda_build, "_BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="kernelmap.cpp failed to build"):
        cuda_build.build(["kernelmap"])
    assert not any((tmp_path / "_build").iterdir())


def test_the_source_needs_no_python_headers():
    """The library includes the C++ standard library only (no ``Python.h``,
    no numpy headers) and exports a C ABI."""
    text = (ROOT / "deepviewagg_tpu_torch" / "native" / "kernelmap.cpp"
            ).read_text()
    includes = set(re.findall(r"#include\s*[<\"]([^>\"]+)", text))
    assert includes <= {"algorithm", "climits", "cmath", "cstdint", "cstdlib",
                        "cstring", "thread", "utility", "vector"}, includes
    assert 'extern "C"' in text
