"""perceive_idle_share.serve (%): the share of the `pf3.perceive` ranges'
summed time in the profiled sub-window in which no kernel, copy or memset
ran on the device: how far frozen perception's launches hold the card
back."""
from pf3bench import spans


def read(run):
    return spans.idle_share_in(run, "pf3.perceive")
