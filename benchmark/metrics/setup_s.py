"""From the process's start to the window's start: data, model, weights, the
check steps (warm-up and every kernel build or compile) included."""


def read(run):
    return run.setup_s
