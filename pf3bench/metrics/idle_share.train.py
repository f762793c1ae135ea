"""idle_share.train (%): the share of the profiled sub-window in which no
kernel, copy or memset ran on the device."""


def read(run):
    t = run["record"].get("trace")
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
