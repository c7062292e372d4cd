"""Device time of the ``elementwise`` family (``harness.families``) in the traced blocks, a step."""


def read(r):
    us = r.view.family_us().get("elementwise")
    return us / r.steps if us and r.steps else None
