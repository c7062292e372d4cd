"""The program's host reads of a loss (``zigp.train.sync`` spans) in the
stretch, over its blocks."""

from portbench.harness.spans import blocks, named


def read(r):
    n = blocks(r)
    if not n:
        return None
    return len(named(r.view, "train.sync")) / n
