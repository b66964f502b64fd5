"""Device milliseconds per train forward of PTv3's serialization (codes,
orders, inverses and patch indices at level 0 and at each pooling): the
``ptv3.serialize`` spans under each ``step.forward`` summed, averaged over
the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv3.serialize"])
