"""Valid voxels voted in the window over the window's seconds (host clock;
the loader and the vote accumulation included)."""


def read(run):
    if not run.window_s or "voxels" not in run.counters:
        return None
    return run.counters["voxels"] / run.window_s
