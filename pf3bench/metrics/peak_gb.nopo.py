"""peak_gb.nopo (GB): `torch.cuda.max_memory_allocated()` over the window,
reset at its start: NoPoSplat's parameters, gradients, Adam's moments and a
step's activations."""


def read(run):
    peak = run["record"]["peak_bytes"]
    if peak is None:
        return None
    return peak / 1e9
