"""End-to-end: the rows of work the cell's entry completed in the timed
window over the window's seconds (host clock, the window bounded by device
synchronizes). In a train cell the batch rows of every optimizer step, with
the host's loading, the producer thread and the logging included."""


def read(run):
    return run["samples"] / run["window_s"]
