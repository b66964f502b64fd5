"""Shared helpers of the ``test_torch_port_*`` parity tests: the same numpy
inputs go through the JAX package and the PyTorch port on the CPU."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from deepviewagg_tpu_torch.data.collate import batch_to_torch

TINY_SPEC = dict(backbone="Res16UNetTest", tower="resnet18_l1", num_groups=2)
TINY_BATCH = dict(n_samples=1, density=25.0, image_size=(64, 32), n_cameras=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Tier-1 runs several workers at once: keep torch to two threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def jax_tiny_batch():
    """The JAX package's tiny flagship batch (the ``__graft_entry__``
    ``_build(tiny=True)`` request): ``(numpy batch without meta, samples)``."""
    from deepviewagg_tpu.data.toy import toy_batch

    batch, _, samples = toy_batch(**TINY_BATCH)
    return {k: v for k, v in batch.items() if k != "meta"}, samples


def torch_batch(np_batch):
    return batch_to_torch(np_batch, device="cpu")


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Random flax variables of ``module`` applied to ``args``: fan-in-scaled
    normal kernels and non-trivial norm scales, biases and running
    statistics (see :func:`randomize_variables`).  Built from
    ``jax.eval_shape``: a real flax ``init`` of a model costs a minute on the
    CPU."""
    import jax

    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.normal(size=v.shape)
                          * np.sqrt(2.0 / fan_in)).astype(np.float32)
            else:
                out[k] = np.zeros(v.shape, np.float32)
        return out

    return randomize_variables(walk(shapes), seed)


@functools.lru_cache(maxsize=None)
def _model_variables(module, seed):
    return jax_variables(module, jax_tiny_batch()[0], seed=seed, train=False)


def jax_model_variables(module, seed: int = 0):
    """:func:`jax_variables` of a JAX model on the tiny batch (cached)."""
    return _model_variables(module, seed)


def randomize_variables(variables, seed: int = 0):
    """Non-trivial norm scales / biases and running statistics, so eval-mode
    norms are far from the identity; kernels are kept."""
    rng = np.random.default_rng(seed + 1)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = rng.normal(0.0, 0.2, v.shape)
            elif k == "mean":
                v = rng.normal(0.0, 0.3, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "weight":          # Gating
                v = rng.uniform(0.5, 1.5, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(variables)


def f32_sparse_convs(monkeypatch):
    """Make the sparse convolutions of both packages' blocks use float32
    operands instead of bf16-rounded ones, as ``f32_convs`` does for the
    towers.  With bf16 operands, a summation-order difference of 1e-7 in
    one layer flips the bf16 rounding of about 2.4e-4 of the next layer's
    operands by one ulp (2^-8), so a chain of layers drifts to 1e-4 .. 2e-3
    relative although every layer agrees to 1e-6; in float32 the chains
    agree to 1e-6."""
    import jax.numpy as jnp

    from deepviewagg_tpu.nn import sparse_blocks as jb
    from deepviewagg_tpu_torch.nn import sparse_blocks as tb

    j_plain, j_subm, j_pair = (jb.sparse_conv, jb.sparse_conv_submanifold,
                               jb.sparse_conv_pair)
    monkeypatch.setattr(jb, "sparse_conv", lambda f, w, n, bias=None, compute_dtype=None:
                        j_plain(f, w, n, bias=bias, compute_dtype=jnp.float32))
    monkeypatch.setattr(jb, "sparse_conv_submanifold", lambda f, w, n, cd=None:
                        j_subm(f, w, n, jnp.float32))
    monkeypatch.setattr(jb, "sparse_conv_pair", lambda f, w, n, nt, cd=None:
                        j_pair(f, w, n, nt, jnp.float32))
    t_plain, t_subm, t_pair = (tb.sparse_conv, tb.sparse_conv_submanifold,
                               tb.sparse_conv_pair)
    monkeypatch.setattr(tb, "sparse_conv", lambda f, w, n, bias=None, compute_dtype=None:
                        t_plain(f, w, n, bias, torch.float32))
    monkeypatch.setattr(tb, "sparse_conv_submanifold", lambda f, w, n, cd=None:
                        t_subm(f, w, n, torch.float32))
    monkeypatch.setattr(tb, "sparse_conv_pair", lambda f, w, n, nt, cd=None:
                        t_pair(f, w, n, nt, torch.float32))


def segment_case(seed, e=700, s=120, c=16, one_d=False, empty_tail=False):
    """Sorted segment ids with a masked drop segment ``s - 1``, some empty
    segments and (when ``empty_tail``) segments whose rows are all masked:
    ``(x [e, c] or [e], ids, valid, ptr, s)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s // 2 if empty_tail else s - 1, e)
    drop = rng.random(e) < 0.15
    ids = np.where(drop, s - 1, ids)
    valid = ~drop
    if empty_tail:
        valid &= ids % 7 != 3           # every 7th segment fully masked
    order = np.argsort(ids, kind="stable")
    ids, valid = ids[order].astype(np.int32), valid[order]
    x = rng.normal(size=(e,) if one_d else (e, c)).astype(np.float32)
    ptr = np.searchsorted(ids, np.arange(s + 1)).astype(np.int32)
    return x, ids, valid, ptr, s


def backward_node_names(t):
    """Type names of every node in the autograd graph below tensor ``t``."""
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def flat_leaves(tree, prefix=()):
    """``{"a/b/leaf": leaf}`` of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def rel_err(a, b) -> float:
    """Largest absolute difference over the largest magnitude of ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
