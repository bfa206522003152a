"""Training traffic: the port's training step (``make_train_step``, in
place, as ``run_training`` calls it) on packed synthetic documents.

Traffic keys: ``batch`` rows of ``seq_len`` tokens a step, ``remat``,
``optimizer`` (``OptConfig``'s fields), ``documents`` (see
``lm_common.token_rows``), ``pool_rows`` (rows drawn in set-up; step i
takes rows ``i * batch ..`` of the pool, round it), ``reference_steps``,
``limits``.

Set-up makes the weights and the optimizer state, then drives the one
step object through its first ``reference_steps`` steps, on rows that
all differ, keeping each step's loss, each leaf's gradient norm as the
optimizer took it at step 1 (its first moment over ``1 - b1``), and
each leaf's change over those steps.  The window runs the same object
on.  Once the window has closed and the program's state is freed, the
reference follows the same steps from the same weights.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

from chipbench.drivers import lm_common as C
from chipbench.lib import trace
from chipbench.lib.spec import load_module
from chipbench.metrics import _arith


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's and the median leaf's
    reference norm."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def readings(prog: dict, ref: dict) -> dict:
    """The three numbers a run is judged by: the loss of each followed
    step, relative; the first gradient's norm by leaf; the change's norm
    by leaf, over the leaves whose reference gradient is above a
    thousandth of the median leaf's (others move under AdamW by
    round-off alone)."""
    g = ref["grad_norm"]
    floor = 1e-3 * statistics.median(g.values())
    return {"loss_rel_gap": max(abs(p - r) / abs(r) for p, r in
                                zip(prog["loss"], ref["loss"])),
            "grad_norm_gap": leaf_gap(prog["grad_norm"], g),
            "change_norm_gap": leaf_gap(prog["change"], ref["change"],
                                        {n for n, x in g.items()
                                         if x > floor})}


class Program:
    """The port's training step, its weights and optimizer state, driven
    from the seed through the steps the reference follows."""

    def __init__(self, cell, seed: int, dev, feed=None):
        import torch
        from repro_torch.runtime import optim as O
        from repro_torch.runtime.steps import make_train_step
        cfg_file, tr = cell.config, cell.traffic
        self.ref = load_module(cell.reference_path)
        self.d = d = self.ref.dims(cfg_file)
        cfg = C.model_config(cfg_file, remat=tr["remat"])
        oc = O.OptConfig(**tr["optimizer"])
        self.B, self.S = tr["batch"], tr["seq_len"]
        self.rows = torch.from_numpy(C.token_rows(
            seed, 11, tr["pool_rows"], self.S, d["vocab"], tr["documents"])
        ).to(dev)
        self.feed = feed or (lambda b: b)
        self.params = C.port_params(cfg, self.ref.make_weights(d, seed, dev))
        self.opt_state = O.init_opt(self.params)
        self.step_fn = make_train_step(cfg, oc, donate=True)
        self.n = 0
        losses = []
        for _ in range(tr["reference_steps"]):
            losses.append(self.step()["loss"])
            if self.n == 1:
                first = {n: C.get(self.opt_state["m"], p).norm() / (1 - oc.b1)
                         for n, p in C.PATHS.items()}
        with torch.no_grad():
            change = {n: (C.get(self.params, p)
                          - self.ref.make_leaf(d, n, seed, dev)).norm()
                      for n, p in C.PATHS.items()}
        self.readings = {"loss": [float(x) for x in losses],
                         "grad_norm": {n: float(x) for n, x in first.items()},
                         "change": {n: float(x) for n, x in change.items()}}

    def _rows_of(self, i: int):
        import torch
        idx = (i * self.B + torch.arange(self.B, device=self.rows.device)) \
            % self.rows.shape[0]
        return self.rows[idx]

    def batch(self, i: int) -> dict:
        return self.feed({"tokens": self._rows_of(i)})

    def step(self) -> dict:
        self.params, self.opt_state, met = self.step_fn(
            self.params, self.opt_state, self.batch(self.n))
        self.n += 1
        return met

    def followed_tokens(self, n: int) -> list:
        """The token rows of the first ``n`` steps, as the reference
        takes them (the whole batch, whatever the feed did)."""
        return [self._rows_of(i) for i in range(n)]

    def free(self) -> None:
        import torch
        self.params = self.opt_state = self.step_fn = None
        gc.collect()
        if self.rows.is_cuda:
            torch.cuda.empty_cache()


def reference(cell, seed: int, tokens: list, dev, mm: str = "float32"):
    ref = load_module(cell.reference_path)
    return ref.train(ref.dims(cell.config), seed, tokens,
                     cell.traffic["optimizer"], dev, mm)


def run(cell, rec) -> None:
    import torch
    tr = cell.traffic
    dev = rec.device
    prog = Program(cell, rec.seed, dev)
    rec.setup_done()
    out: dict = {}
    with trace.profiled(rec.traced, out):
        t0 = now = time.perf_counter()
        n = 0
        while now < t0 + rec.window_s(tr):
            with trace.span("bench.train_step"):
                met = prog.step()
            n += 1
            now = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    B, S = prog.B, prog.S
    rec.e2e["train_tokens_per_s"] = B * S * n / (t1 - t0)
    rec.attempted = prog.n
    rec.counters.update({"steps": n, "window_s": t1 - t0,
                         "step_flops": _arith.train_step_flops(prog.d, B, S)})
    rec.trace = out.get("trace")
    print(f"chipbench: {n} steps in {t1 - t0:.3f} s; losses "
          f"{prog.readings['loss']}, last {float(met['loss'])}",
          file=sys.stderr)
    tokens = prog.followed_tokens(tr["reference_steps"])
    got = prog.readings
    del met
    prog.free()
    want = reference(cell, rec.seed, tokens, dev)
    for name, value in readings(got, want).items():
        rec.check(name, value, tr["limits"][name])
