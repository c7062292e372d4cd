"""Device idle inside the program's own block work over the stretch's
blocks, µs a block: the union of its ``zigp.train.fill``, ``replay``,
``eager``, ``sync``, ``log`` and ``checkpoint`` spans. The caller's
``zigp.train.callback`` is left out."""

from portbench.harness.spans import blocks, idle_us, named

PARTS = ("fill", "replay", "eager", "sync", "log", "checkpoint")


def read(r):
    n = blocks(r)
    if not n:
        return None
    spans = [s for part in PARTS for s in named(r.view, f"train.{part}")]
    return idle_us(r.view, spans) / n
