"""Runs of each cell with the timed path broken underneath come out not
correct, and the controls (the reference in the precision below the
configuration's) fail the limits: on the CPU at small sizes, the look
for a card skipped.  A sound run of each comes out correct."""

import numpy as np
import pytest
import torch

from chipbench.tests.support import TINY_LIMITS, run_tiny, tiny_cell

CELLS = ["tmfu-paper9.bulk", "deepseek-7b.train", "deepseek-7b.decode"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    rec = run_tiny(tiny_cell(workload))
    assert rec.correct, rec.checks
    assert rec.failed == 0 and rec.attempted > 0 and rec.setup_s > 0


@pytest.mark.parametrize("where", ["first", "middle"])
def test_overlay_answer_altered(where, monkeypatch):
    """One lane of one output, the first or the middle one, one ulp
    off."""
    from repro_torch.core.overlay import Overlay
    collect = Overlay.collect

    def altered(self, plan, ys, host=False):
        outs = collect(self, plan, ys, host)
        y = np.array(outs[0][0])
        i = 0 if where == "first" else len(y) // 2
        y[i] = np.nextafter(y[i], np.inf)
        outs[0] = [y] + list(outs[0][1:])
        return outs

    monkeypatch.setattr(Overlay, "collect", altered)
    rec = run_tiny(tiny_cell("tmfu-paper9.bulk"))
    assert not rec.correct and rec.checks["max_ulp"]["value"] >= 1


def test_overlay_half_lanes_left_out(monkeypatch):
    from repro_torch.core.overlay import Overlay
    collect = Overlay.collect

    def half(self, plan, ys, host=False):
        outs = collect(self, plan, ys, host)
        for out in outs:
            for y in out:
                y = np.asarray(y)
                y[len(y) // 2:] = 0
        return outs

    monkeypatch.setattr(Overlay, "collect", half)
    rec = run_tiny(tiny_cell("tmfu-paper9.bulk"))
    assert not rec.correct


def test_train_step_returns_state_unchanged(monkeypatch):
    import copy
    from repro_torch.runtime import steps
    make = steps.make_train_step

    def unchanged(cfg, oc, **kw):
        step = make(cfg, oc, **kw)

        def fn(params, opt_state, batch):
            _, _, met = step(copy.deepcopy(params), copy.deepcopy(opt_state),
                             batch)
            return params, opt_state, met
        return fn

    monkeypatch.setattr(steps, "make_train_step", unchanged)
    rec = run_tiny(tiny_cell("deepseek-7b.train"))
    assert not rec.correct
    assert rec.checks["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out(monkeypatch):
    from chipbench.drivers import lm_train
    init = lm_train.Program.__init__

    def half(self, cell, seed, dev, feed=None):
        init(self, cell, seed, dev, feed=lambda b: {
            "tokens": b["tokens"][:b["tokens"].shape[0] // 2]})

    monkeypatch.setattr(lm_train.Program, "__init__", half)
    rec = run_tiny(tiny_cell("deepseek-7b.train"))
    assert not rec.correct


def test_decode_token_altered(monkeypatch):
    from repro_torch.runtime import steps
    make = steps.make_decode_step

    def altered(cfg):
        step = make(cfg)

        def fn(params, caches, token, pos):
            logits, nt, caches = step(params, caches, token, pos)
            return logits, (nt + 1) % cfg.vocab, caches
        return fn

    monkeypatch.setattr(steps, "make_decode_step", altered)
    rec = run_tiny(tiny_cell("deepseek-7b.decode"))
    assert not rec.correct


def test_train_control_fails_the_limits():
    from chipbench.drivers import lm_train
    cell = tiny_cell("deepseek-7b.train")
    prog = lm_train.Program(cell, 21, torch.device("cpu"))
    tokens = prog.followed_tokens(cell.traffic["reference_steps"])
    prog.free()
    want = lm_train.reference(cell, 21, tokens, "cpu")
    ctl = lm_train.reference(cell, 21, tokens, "cpu", mm="fp8")
    got = lm_train.readings(ctl, want)
    assert any(v > TINY_LIMITS[k] for k, v in got.items()), got


def test_decode_control_fails_the_limit():
    from chipbench.drivers import lm_decode
    cell = tiny_cell("deepseek-7b.decode")
    prog = lm_decode.Program(cell, 21, torch.device("cpu"))
    served = prog.generate(prog.G)
    gap = lm_decode.reference_gap(cell, 21, prog.prompts, served, "cpu",
                                  by="fp8")
    assert gap > TINY_LIMITS["served_logit_gap"]
