"""Mean host milliseconds of a window batch's prefill and argmax,
ended by a synchronise."""


def read(rec):
    if rec["kind"] != "serve" or not rec["prefill_s"]:
        return None
    return 1e3 * sum(rec["prefill_s"]) / len(rec["prefill_s"])
