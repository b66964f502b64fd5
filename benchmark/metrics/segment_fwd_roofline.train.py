"""The forward sorted-segment kernels' share of their byte bound, in %: the
bytes each call has to move (counted by ``harness.counts`` from its inputs)
over the card's HBM bandwidth, summed, over the device seconds of the
kernels (the union of the tile and finish kernels' intervals) in the trace."""

from benchmark.harness.counts import peak_for


def _roofline(run, which, key):
    if not run.trace or not run.trace.get(key):
        return None
    nbytes = run.extra["segment_bytes"][which]
    if not nbytes:
        return None
    peak = peak_for(run.device.get("kind", "H100"))["hbm_bytes"]
    return 100.0 * nbytes / peak / run.trace[key]


def read(run):
    return _roofline(run, 0, "segment_fwd_s")
