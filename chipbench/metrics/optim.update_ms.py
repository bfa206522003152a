"""Device milliseconds a step inside the program's profiler range
``train_step.update`` (AdamW)."""


def read(rec):
    t = rec.trace
    if not t or not t["range_n"].get("train_step.update"):
        return None
    return 1e3 * t["range_s"]["train_step.update"] \
        / t["range_n"]["train_step.update"]
