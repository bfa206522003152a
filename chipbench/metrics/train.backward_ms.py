"""Device milliseconds a training step in the backward (with full
remat's recompute): the step's device busy time less the device time
inside the ranges ``train_step.forward`` and ``train_step.update``.  It
is a remainder because autograd launches the backward's CUDA work from
its own device thread: the range ``train_step.backward``, entered on the
calling thread, carries only the gradient's seed (about a microsecond a
step on an H100)."""

from chipbench.metrics._ranges import range_ms


def read(rec):
    rest = range_ms(rec, ("train_step.forward", "train_step.update"),
                    "steps")
    if rest is None or not rec.trace["busy_s"]:
        return None
    return 1e3 * rec.trace["busy_s"] / rec.counters["steps"] - rest
