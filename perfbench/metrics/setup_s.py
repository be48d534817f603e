"""End-to-end: seconds from the process's start to the timed window's start
(host clock): imports, the kernel library, the corpus, the store and its
cache, the model, the warm-up."""


def read(run):
    return run["setup_s"]
