"""Device: the peak of the memory the program allocated on the card while
the loop ran (``torch.cuda.max_memory_allocated``, its count reset just
before the loop starts), in GiB."""


def read(run):
    return run["peak_bytes"] / 2 ** 30
