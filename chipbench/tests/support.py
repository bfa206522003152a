"""What the benchmark's tests share: small cells the CPU runs in a second,
and one run of a cell through the harness with the look for a card
skipped."""

import copy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: a DeepSeek-shaped model small enough for the CPU
TINY_LM = {"hidden_size": 64, "intermediate_size": 128,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "num_hidden_layers": 2, "vocab_size": 256}


#: limits for the tiny LM cells, set as the full-size ones are: above
#: the program's readings there, below the float8 control's
#: (train: program <= 3.0e-4 / 1.6e-3 / 1.0e-3, control >= 2.0e-3 /
#: 7.2e-3 / 5.3e-3; decode: program <= 1.8e-3, control >= 0.2)
TINY_LIMITS = {"loss_rel_gap": 1e-3, "grad_norm_gap": 4e-3,
               "change_norm_gap": 2.5e-3, "served_logit_gap": 0.05}


def tiny_cell(workload: str):
    """The cell cut to a size the CPU runs in a second: the LM cells at
    ``TINY_LM``'s widths, the overlay cell at few lanes."""
    from chipbench.lib.spec import load_benchmark, resolve
    cell = resolve(load_benchmark(ROOT), workload, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    tr = cell.traffic
    tr["warmup_s"] = 0.2
    if "hidden_size" in cell.config:
        cell.config.update(TINY_LM)
    if "limits" in tr:
        tr["limits"] = {k: TINY_LIMITS[k] for k in tr["limits"]}
    if "seq_len" in tr:
        tr.update(seq_len=32, pool_rows=8)
    if "prompt_len" in tr:
        tr.update(batch=4, prompt_len=16, gen_len=6, prefill_rows=2,
                  check_rows=2, warmup_steps=2)
    if "lanes" in tr:
        tr["lanes"] = 512
    return cell


def run_tiny(cell, seed: int = 2 ** 31 + 3, seconds: float = 0.3):
    """One run of ``cell`` on the CPU through the harness (the look for
    a card skipped): its record."""
    import argparse
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "chipbench_run_main", ROOT / "chipbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=0)
    return run.run_cell(cell, args, torch.device("cpu"))
