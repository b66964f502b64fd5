"""Valid voxels of every training step completed in the window over the
window's seconds (host clock, closed by a synchronisation)."""


def read(run):
    if not run.window_s or "voxels" not in run.counters:
        return None
    return run.counters["voxels"] / run.window_s
