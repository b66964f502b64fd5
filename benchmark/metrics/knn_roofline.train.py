"""The neighbour search kernel's share of its byte bound, in %: for each
table of the window's forwards, the points read once (12 bytes a row) and
the table written (4 k bytes a row) at the card's memory bandwidth
(``harness/ptv2_counts.py``, from the window's batches), summed, over the
device seconds of the ``ptv2.knn.core`` spans (the search kernel alone).
The bound counts the work whatever computes it."""

from benchmark.harness.ptv3_counts import program_spans


def read(run):
    bound = getattr(run.extra.get("flops"), "knn_bound_s", None)
    t = program_spans().get("spans", {}).get("ptv2.knn.core")
    if not bound or not t:
        return None
    ms = [v for v in t["device_ms"] if v is not None]
    if not ms:
        return None
    return 100.0 * bound / (sum(ms) * 1e-3)
