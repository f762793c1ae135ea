"""setup_s (s): from the process's start to the end of the warm-up (imports,
CUDA start, model build, weights, data, the cell's shapes warmed up)."""


def read(run):
    return run["setup_s"]
