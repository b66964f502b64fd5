"""Device milliseconds per train forward of PTv2's grouped vector
attention: the ``ptv2.attention`` spans' CUDA events (q, k and v, the
gathers, the positional and weight encodings, the softmax and the weighted
sum) under each ``step.forward`` summed, averaged over the forwards
(traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv2.attention"])
