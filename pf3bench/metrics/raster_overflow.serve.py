"""raster_overflow.serve (%): the share of the rasterizer's wanted pairs
that kernel B1's static budget dropped over the profiled sub-window,
100 x (wanted - written) / wanted from the program's counters
(`raster.pairs_wanted`, `raster.pairs_written`)."""
from pf3bench import spans


def read(run):
    return spans.raster_overflow(run)
