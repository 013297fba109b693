"""Prompt and generated tokens of every request completed in the window
over the window's seconds."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "serve" else None
