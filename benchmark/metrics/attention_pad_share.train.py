"""The padding copies' share of the tokens through PTv3's attention in the
traced window, in %: ``ptv3.pad_tokens / (ptv3.tokens +
ptv3.pad_tokens)``, the program's counters."""

from benchmark.harness.ptv3_counts import program_spans


def read(run):
    counters = program_spans().get("counters", {})
    real = counters.get("ptv3.tokens")
    pad = counters.get("ptv3.pad_tokens", 0)
    if not real:
        return None
    return 100.0 * pad / (real + pad)
