"""Device milliseconds per train forward of PTv3's xCPE sublayers (sparse
conv, linear, LayerNorm, residual): the ``ptv3.cpe`` spans under each
``step.forward`` summed, averaged over the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv3.cpe"])
