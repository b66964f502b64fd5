"""The backward sorted-segment kernel's share of its byte bound, in %, as
``segment_fwd_roofline.train`` counts it."""

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
    return _roofline(run, 1, "segment_bwd_s")
