"""Model FLOPs (``counts.py``) of the window's batches over its seconds, as a
percentage of the card's bf16 peak."""

from bench import shares


def read(rec):
    return shares.mfu(rec, "serve")
