"""Mean host milliseconds of a decode step: a window batch's decode
seconds, to its tokens on the host, over its steps."""


def read(rec):
    if rec["kind"] != "serve" or not rec["decode_s"]:
        return None
    return 1e3 * sum(rec["decode_s"]) / len(rec["decode_s"]) / rec["decode_steps"]
