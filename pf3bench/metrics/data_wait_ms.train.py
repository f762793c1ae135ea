"""data_wait_ms.train (ms): host time the loop waits for its next batch
(`main.batch_iterator` and the pinned copies), averaged over the window's steps."""


def read(run):
    waits = run["record"].get("data_wait_ms")
    return sum(waits) / len(waits) if waits else None
