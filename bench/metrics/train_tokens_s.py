"""Tokens of every training step completed in the window over the
window's seconds (the window ends with a synchronise)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "train" else None
