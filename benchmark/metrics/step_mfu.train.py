"""The window's model FLOPs (``harness.counts``) over the traced window's
seconds times the card's dense bfloat16 peak, in %."""

from benchmark.harness.counts import peak_for


def read(run):
    flops = run.extra.get("flops")
    if not flops or not run.trace:
        return None
    peak = peak_for(run.device.get("kind", "H100"))["bf16_flops"]
    return 100.0 * flops / (run.trace["window_s"] * peak)
