"""step_ms (ms): the window's wall time over the training steps completed in it."""


def read(run):
    rec = run["record"]
    return rec["window_s"] * 1e3 / rec["count"]
