"""The yardstick's arithmetic for Point Transformer V2: model FLOPs of a
forward and the neighbour search's byte bound.

Model FLOPs count two per multiply-add of the model's mathematics over the
real points (padding rows do not count), the level sizes worked out by the
reference's own pooling (:class:`..reference.ptv2.Levels`): every linear
layer as ``2 x rows x C_in x C_out``, its rows the level's points or, in
the attention's positional and weight encodings, the points times the
stage's ``k`` neighbours; the weighted sum over the neighbours as ``2 x
rows x k x C``.  A training step counts three times its forward.

The neighbour search's bound: a table of ``k`` over ``n`` points must read
the points (12 bytes a row) and write the table (``4 k`` bytes a row), at
the card's memory bandwidth, whatever implements it.  A forward builds one
table a level, as wide as the widest stage of the level takes (the
program's tables: the patch embedding's 8 are the first 8 of level 0's
16); their sum over the window's forwards is the bound that
``knn_roofline.train`` holds against the search kernel's device time.
"""

from __future__ import annotations

from typing import Dict, List

from .counts import peak_for

__all__ = ["level_sizes", "stages", "forward_flops", "knn_bytes",
           "WindowFlops"]


def level_sizes(levels) -> List[int]:
    """Points of each level of the reference's :class:`Levels`."""
    return [int(p.shape[0]) for p in levels.pos]


def stages(arch: Dict):
    """``(level, channels, groups, k, blocks)`` of every block sequence:
    the patch embedding's, the encoder's, the decoder's."""
    out = [(0, arch["patch_embed_channels"], arch["patch_embed_groups"],
            arch["patch_embed_neighbours"], arch["patch_embed_depth"])]
    for s, d in enumerate(arch["enc_depths"]):
        out.append((s + 1, arch["enc_channels"][s], arch["enc_groups"][s],
                    arch["enc_neighbours"][s], d))
    for s, d in enumerate(arch["dec_depths"]):
        out.append((s, arch["dec_channels"][s], arch["dec_groups"][s],
                    arch["dec_neighbours"][s], d))
    return out


def forward_flops(arch: Dict, in_channels: int, num_classes: int,
                  sizes: List[int]) -> float:
    """Model FLOPs of one forward over levels of ``sizes`` points."""
    ec = [arch["patch_embed_channels"]] + list(arch["enc_channels"])
    dc = list(arch["dec_channels"]) + [ec[-1]]
    f = 2.0 * sizes[0] * in_channels * ec[0]
    for lvl, c, g, k, blocks in stages(arch):
        n = sizes[lvl]
        per = (2.0 * n * c * c * 5                 # fc1, q, k, v, fc3
               + 2.0 * n * k * (3 * c + c * c)     # positional encoding
               + 2.0 * n * k * (c * g + g * g)     # weight encoding
               + 2.0 * n * k * c)                  # the weighted sum
        f += per * blocks
    for s in range(len(arch["enc_depths"])):
        f += 2.0 * sizes[s] * ec[s] * ec[s + 1]            # grid pooling
        f += 2.0 * sizes[s + 1] * dc[s + 1] * dc[s]        # unpooling
        f += 2.0 * sizes[s] * ec[s] * dc[s]                # its skip
    f += 2.0 * sizes[0] * dc[0] * (dc[0] + num_classes)    # head
    return f


def knn_bytes(arch: Dict, sizes: List[int]) -> float:
    """The bytes one forward's neighbour tables must move."""
    total = 0.0
    for lvl, n in enumerate(sizes):
        ks = [k for l_, _, _, k, _ in stages(arch) if l_ == lvl]
        total += n * (12.0 + 4.0 * max(ks))
    return total


class WindowFlops(float):
    """The window's model FLOPs (a float, as the MFU reader takes it), with
    the window's neighbour-search bound beside it (``knn_bound_s``)."""

    knn_bound_s = None

    @staticmethod
    def of(flops: float, knn_nbytes: float, device_name: str):
        out = WindowFlops(flops)
        out.knn_bound_s = knn_nbytes / peak_for(device_name)["hbm_bytes"]
        return out
