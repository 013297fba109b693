"""Seconds from the start of the process to the first timed step:
imports, CUDA start, kernel builds found in the checkout's cache, the
weights made on the card, the shards written, every shape warmed."""


def read(rec):
    return rec["t_window"] - rec["t0"]
