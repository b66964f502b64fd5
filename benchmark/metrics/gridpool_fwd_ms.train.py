"""Device milliseconds per train forward of PTv2's grid pooling and
unpooling: the ``ptv2.pool`` and ``ptv2.unpool`` spans under each
``step.forward`` summed, averaged over the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv2.pool", "ptv2.unpool"])
