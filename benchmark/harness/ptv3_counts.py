"""The yardstick's arithmetic for Point Transformer V3: model FLOPs of a
forward, the attention calls' roofline bound, and the program's spans per
forward.

Model FLOPs count two per multiply-add of the model's mathematics over the
real points (padding rows of a bucket do not count; the copies that fill
an attention patch do, as the attention computes them): the sparse
convolutions as ``2 x pairs x C_in x C_out``, the pairs counted from the
points' coordinates by the reference's own lookup
(:class:`..reference.ptv3.Levels`); every linear layer (xCPE, qkv,
projection, MLP, pooling, unpooling, head) as ``2 x rows x C_in x C_out``;
the attention as ``4 x T_padded x L x C`` a block (``q k^T`` and the
weighted sum over patches of length ``L``).  A training step counts three
times its forward.

The attention's bound: each call of the patch attention (one per run of
consecutive samples longer than a patch, one per shorter sample, as the
program makes them) takes at least the larger of its FLOPs at the card's
dense bfloat16 peak and the bytes of q, k, v and the output (bfloat16) at
its memory bandwidth; the calls' sum over the window's forwards is the
bound that ``attention_core_roofline.train`` holds against their device
time.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .counts import peak_for

__all__ = ["level_counts", "forward_flops", "attention_calls",
           "attention_bound_s", "WindowFlops", "program_spans",
           "per_forward_ms"]


def _runs(counts: Sequence[int], patch: int) -> List[Tuple[int, int]]:
    """``(patches, length)`` of each attention call over samples of
    ``counts`` points."""
    out: List[Tuple[int, int]] = []
    joined = False
    for c in counts:
        if c == 0:
            continue
        if c > patch:
            n = -(-c // patch)
            if joined:
                out[-1] = (out[-1][0] + n, patch)
            else:
                out.append((n, patch))
            joined = True
        else:
            out.append((1, c))
            joined = False
    return out


def level_counts(levels) -> List[List[int]]:
    """Per level, the points of each sample (:class:`Levels` rows)."""
    return [np.bincount(c[:, 0].cpu().numpy(), minlength=16).tolist()
            for c in levels.coords]


def _stages(arch: Dict):
    """``(level, channels, heads, patch, blocks)`` of every stage, the
    encoder's then the decoder's."""
    out = []
    for s, d in enumerate(arch["enc_depths"]):
        out.append((s, arch["enc_channels"][s], arch["enc_num_head"][s],
                    arch["enc_patch_size"][s], d))
    for s, d in enumerate(arch["dec_depths"]):
        out.append((s, arch["dec_channels"][s], arch["dec_num_head"][s],
                    arch["dec_patch_size"][s], d))
    return out


def attention_calls(arch: Dict, counts: List[List[int]]):
    """``(patches, length, channels)`` of every attention call of one
    forward."""
    out = []
    for lvl, c, _, patch, blocks in _stages(arch):
        for n, length in _runs(counts[lvl], patch):
            out.extend([(n, length, c)] * blocks)
    return out


def forward_flops(arch: Dict, in_channels: int, num_classes: int,
                  levels) -> float:
    """Model FLOPs of one forward over the reference's ``levels`` of a
    batch."""
    counts = level_counts(levels)
    rows = [sum(c) for c in counts]
    pairs = [sum(int(i.numel()) for i, _ in p) for p in levels.pairs]
    stem_pairs = sum(int(i.numel()) for i, _ in levels.stem)
    ec, dc = arch["enc_channels"], arch["dec_channels"]
    hidden = arch["mlp_ratio"]
    f = 2.0 * stem_pairs * in_channels * ec[0]
    for lvl, c, _, _, blocks in _stages(arch):
        n = rows[lvl]
        per = (2.0 * pairs[lvl] * c * c            # xCPE conv
               + 2.0 * n * c * c * (1 + 3 + 1)     # xCPE linear, qkv, proj
               + 2.0 * n * c * c * hidden * 2)     # MLP
        f += per * blocks
    for n, length, c in attention_calls(arch, counts):
        f += 4.0 * n * length * length * c
    for s in range(1, len(ec)):
        f += 2.0 * rows[s - 1] * ec[s - 1] * ec[s]
    widths = list(dc) + [ec[-1]]
    for s in range(len(dc)):
        f += 2.0 * rows[s + 1] * widths[s + 1] * dc[s]
        f += 2.0 * rows[s] * ec[s] * dc[s]
    f += 2.0 * rows[0] * dc[0] * num_classes
    return f


def attention_bound_s(arch: Dict, counts: List[List[int]],
                      device_name: str) -> float:
    """The sum over one forward's attention calls of the larger of their
    FLOPs at the dense bfloat16 peak and their q, k, v and output bytes at
    the memory bandwidth."""
    peak = peak_for(device_name)
    total = 0.0
    for n, length, c in attention_calls(arch, counts):
        flops = 4.0 * n * length * length * c
        nbytes = 4.0 * n * length * c * 2
        total += max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])
    return total


class WindowFlops(float):
    """The window's model FLOPs (a float, as the MFU reader takes it), with
    the window's attention bound beside it (``attention_core_bound_s``)."""

    attention_core_bound_s = None


def program_spans() -> Dict:
    """The program's spans of the traced window (``utils/trace.py``);
    empty for a program without that tracer."""
    try:
        from deepviewagg_tpu_torch.utils.trace import snapshot
    except ImportError:
        return {}
    return snapshot()


def per_forward_ms(names: Sequence[str]):
    """Mean over the window's train forwards of the device ms of the spans
    ``names`` under each ``step.forward``, or None where the program kept
    none of them."""
    spans = program_spans().get("spans", {})
    if "step.forward" not in spans or not any(n in spans for n in names):
        return None
    parent = {}
    for t in spans.values():
        parent.update(zip(t["id"], t["parent_id"]))
    per = dict.fromkeys(spans["step.forward"]["id"], 0.0)
    timed = False
    for name in names:
        t = spans.get(name)
        if t is None:
            continue
        for i, ms in zip(t["id"], t["device_ms"]):
            up = parent.get(i)
            while up is not None and up not in per:
                up = parent.get(up)
            if ms is not None and up is not None:
                per[up] += ms
                timed = True
    return float(np.mean(list(per.values()))) if timed else None
