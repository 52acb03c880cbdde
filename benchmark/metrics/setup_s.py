"""Process start to the window's start: kernel builds, data generation,
preload, flush, compaction, the node's open and the warm-up."""


def read(run):
    return run.setup_s
