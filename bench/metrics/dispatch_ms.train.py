"""Mean host milliseconds from a window step's call to its return, with
no synchronise: the host's time to enqueue the step."""


def read(rec):
    if rec["kind"] != "train" or not rec["dispatch_s"]:
        return None
    return 1e3 * sum(rec["dispatch_s"]) / len(rec["dispatch_s"])
