"""peak_gb.serve (GB): `torch.cuda.max_memory_allocated()` over the window,
reset at its start."""


def read(run):
    peak = run["record"]["peak_bytes"]
    if peak is None:
        return None
    return peak / 1e9
