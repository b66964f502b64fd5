"""Device milliseconds per train forward of PTv3's serialized pooling and
unpooling: the ``ptv3.pool`` and ``ptv3.unpool`` spans under each
``step.forward`` summed, averaged over the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv3.pool", "ptv3.unpool"])
