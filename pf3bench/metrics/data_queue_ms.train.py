"""data_queue_ms.train (ms): the time the training loop waits on the data
pipeline inside `main.batch_iterator` (`pf3.data.wait` ranges: the next
example from `ExamplePipeline`), summed over the profiled sub-window and
divided by its steps (`pf3.train_step` ranges). `data_wait_ms.train` times
the same layer from outside, with the collation and the pinned copies."""
from pf3bench import spans


def read(run):
    return spans.span_ms_per(run, "pf3.data.wait", "pf3.train_step")
