"""``bf16x3_mm.cu``'s share of its roofline over the traced blocks (``rooflines/bf16x3_mm.py``)."""


def read(r):
    return r.roofline("bf16x3_mm")
