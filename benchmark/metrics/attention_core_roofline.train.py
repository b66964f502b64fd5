"""The attention calls' share of their roofline, in %: for each call of
PTv3's patch attention in the window's forwards, the larger of its FLOPs
(``4 x T_padded x L x C``) at the card's dense bfloat16 peak and its q, k,
v and output bytes at the card's memory bandwidth (``harness/
ptv3_counts.py``, from the window's batches), summed, over the device
seconds of the ``ptv3.attention.core`` spans (the attention call alone).
The bound counts the work whatever computes it."""

from benchmark.harness.ptv3_counts import program_spans


def read(run):
    bound = getattr(run.extra.get("flops"), "attention_core_bound_s", None)
    t = program_spans().get("spans", {}).get("ptv3.attention.core")
    if not bound or not t:
        return None
    ms = [v for v in t["device_ms"] if v is not None]
    if not ms:
        return None
    return 100.0 * bound / (sum(ms) * 1e-3)
