"""Train loop: the share of the timed window in which the loop waited for
its next megabatch from the producer thread (a span the benchmark records
around the program's prefetcher), in %."""


def read(run):
    if "wait_s" not in run:
        return None
    return 100.0 * run["wait_s"] / run["window_s"]
