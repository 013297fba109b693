"""The least time of the profiled steps's counted work (FLOPs at the bf16
peak, bytes at the memory's; ``counts.py``) over the seconds some
operation ran on the device, as a percentage."""

from bench import shares


def read(rec):
    return shares.roofline(rec, "train")
