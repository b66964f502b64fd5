"""Device milliseconds per train forward of PTv3's attention sublayers: the
``ptv3.attention`` spans' CUDA events (qkv, gather, padding, the attention,
unpadding, projection) under each ``step.forward`` summed, averaged over
the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv3.attention"])
