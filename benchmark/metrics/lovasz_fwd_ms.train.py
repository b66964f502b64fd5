"""Device milliseconds per train forward of the Lovász-softmax loss (the
class-major sort, the scan kernel and the products): the ``loss.lovasz``
spans under each ``step.forward`` summed, averaged over the forwards
(traced run)."""

from benchmark.harness.ptv3_counts import per_forward_ms


def read(run):
    return per_forward_ms(["loss.lovasz"])
