"""Device milliseconds per train forward of PTv2's neighbour search: the
``ptv2.knn`` spans (a table's cell keys, sort and search kernel) under each
``step.forward`` summed, averaged over the forwards (traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["ptv2.knn"])
