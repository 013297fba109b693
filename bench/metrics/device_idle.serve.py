"""The share of the profiled sub-window in which no operation ran on the
device, as a percentage."""

from bench import shares


def read(rec):
    return shares.idle(rec, "serve")
