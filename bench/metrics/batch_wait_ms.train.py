"""Mean host milliseconds a window step spent in
``TokenBatcher.next_batch``: shard decode, packing and the upload, which
from pageable memory waits for the card."""


def read(rec):
    if rec["kind"] != "train" or not rec["batch_wait_s"]:
        return None
    return 1e3 * sum(rec["batch_wait_s"]) / len(rec["batch_wait_s"])
