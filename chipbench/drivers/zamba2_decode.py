"""Decode traffic on Zamba2: ``lm_decode``'s static batch (prompts
prefilled in set-up by ``make_prefill_step``, then greedy generations
through the caches by ``make_decode_step``, one after another from the
prompts' end) on the published configuration, whose cache holds the 81
layers' SSM and conv states beside the 13 sites' K/V.

Traffic keys as ``lm_decode``'s.  The port's ``ModelConfig`` is built
from the configuration's published keys (``model_config``), and the
reference's weights are placed in its parameter tree (``port_params``).
The program's cache has shapes the reference's checks do not see, so the
check is ``lm_decode``'s: at each served position of the checked rows,
how far the served token's logit lies below the reference's best.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from chipbench.drivers import lm_common as C
from chipbench.drivers import lm_decode as LD
from chipbench.lib.spec import load_module
from chipbench.metrics import _zamba2_arith as Z

#: where each reference leaf sits in the port's tree: the Mamba layers'
#: (stacked over layers), the shared blocks' (over blocks), the sites'
#: (over sites)
PATHS = {"embed": ("embed",), "final_norm": ("final_norm", "g"),
         "ln": ("stacks", 0, 0, "ln", "g"),
         "in_proj": ("stacks", 0, 0, "mixer", "in_proj", "w"),
         "conv_w": ("stacks", 0, 0, "mixer", "conv_w"),
         "conv_b": ("stacks", 0, 0, "mixer", "conv_b"),
         "A_log": ("stacks", 0, 0, "mixer", "A_log"),
         "dt_bias": ("stacks", 0, 0, "mixer", "dt_bias"),
         "D": ("stacks", 0, 0, "mixer", "D"),
         "norm": ("stacks", 0, 0, "mixer", "norm", "g"),
         "out_proj": ("stacks", 0, 0, "mixer", "out_proj", "w"),
         "ln1": ("shared", "blocks", "ln1", "g"),
         "wq": ("shared", "blocks", "attn", "wq", "w"),
         "wk": ("shared", "blocks", "attn", "wk", "w"),
         "wv": ("shared", "blocks", "attn", "wv", "w"),
         "wo": ("shared", "blocks", "attn", "wo", "w"),
         "ln2": ("shared", "blocks", "ln2", "g"),
         "gate": ("shared", "blocks", "mlp", "gate", "w"),
         "up": ("shared", "blocks", "mlp", "up", "w"),
         "down": ("shared", "blocks", "mlp", "down", "w"),
         "adapter": ("shared", "sites", "adapter", "w"),
         "adapter_gate": ("shared", "sites", "adapter_gate", "w"),
         "adapter_up": ("shared", "sites", "adapter_up", "w"),
         "linear": ("shared", "sites", "linear", "w")}


def model_config(config: dict):
    """The port's ``ModelConfig`` of a published Zamba2 configuration.
    Raises ImportError at once where the port has no shared blocks."""
    from repro_torch.configs.zamba2_7b_instruct import hybrid_model
    if config.get("use_shared_attention_adapter") \
            or config.get("hidden_act", "gelu") != "gelu" \
            or not config.get("use_mem_rope", True) \
            or config.get("add_bias_linear") \
            or not config.get("use_conv_bias", True) \
            or config.get("tie_word_embeddings", True) is False:
        raise ValueError("a Zamba2 variant the port does not build")
    D, H = config["hidden_size"], config["num_attention_heads"]
    if config.get("num_key_value_heads", H) != H \
            or config.get("attention_head_dim", 2 * D // H) != 2 * D // H:
        raise ValueError("the shared blocks' attention has kv heads = "
                         "heads of 2 hidden_size / heads")
    cfg = hybrid_model(
        config["name"], config["layers_block_type"],
        d_model=D, n_heads=H,
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        d_state=config["mamba_d_state"],
        ssm_head_dim=config["mamba_expand"] * D // config["n_mamba_heads"],
        n_groups=config["mamba_ngroups"],
        n_blocks=config["num_mem_blocks"],
        adapter_rank=config["adapter_rank"],
        norm_eps=float(config["rms_norm_eps"]),
        rope_theta=float(config.get("rope_theta", 10000.0)))
    want = (config["time_step_min"], config["time_step_max"],
            config["time_step_floor"])
    if cfg.ssm.dt_limits != want or cfg.ssm.d_conv != config["mamba_d_conv"]:
        raise ValueError("a Zamba2 variant the port does not build")
    return cfg


def port_params(cfg, weights: dict) -> dict:
    """The port's parameter tree holding ``weights``' tensors themselves
    (no copy), checked against the port's own ``init_params``."""
    from repro_torch.models.blocks import tree_leaves, tree_map
    from repro_torch.models.model import init_params
    want = init_params(cfg, device="meta")
    tree = tree_map(lambda _: None, want)
    for name, path in PATHS.items():
        C.get(tree, path[:-1])[path[-1]] = weights[name]
    leaves, shapes = tree_leaves(tree), tree_leaves(want)
    if any(x is None for x in leaves) or len(leaves) != len(shapes):
        raise ValueError("the port's parameter tree has leaves the "
                         "benchmark does not make")
    for x, w in zip(leaves, shapes):
        if tuple(x.shape) != tuple(w.shape):
            raise ValueError(f"weight of shape {tuple(x.shape)} where the "
                             f"port wants {tuple(w.shape)}")
    return tree


class Program(LD.Program):
    """``lm_decode.Program`` on Zamba2: the port's prefill and decode
    steps on the seed's weights, the prompts prefilled and the first
    steps warmed up.  ``cfg`` (default: ``model_config`` of the cell's
    configuration) and ``edit`` (a function of the parameter tree, run
    before prefill) are for the control tool's planted faults."""

    def __init__(self, cell, seed: int, dev, cfg=None, edit=None):
        import torch
        from repro_torch.runtime.steps import (make_decode_step,
                                               make_prefill_step)
        cfg_file, tr = cell.config, cell.traffic
        cfg = cfg or model_config(cfg_file)
        self.cfg = cfg
        self.ref = load_module(cell.reference_path)
        self.d = d = self.ref.dims(cfg_file)
        self.B, self.P, self.G = tr["batch"], tr["prompt_len"], tr["gen_len"]
        self.dev = dev
        self.prompts = torch.from_numpy(C.token_rows(
            seed, 21, self.B, self.P, d["vocab"], tr["documents"])).to(dev)
        self.params = port_params(cfg, self.ref.make_weights(d, seed, dev))
        if edit is not None:
            edit(self.params)
        prefill = make_prefill_step(cfg, cache_len=self.P + self.G)
        self.decode = make_decode_step(cfg)
        first, parts = [], []
        for r0 in range(0, self.B, tr["prefill_rows"]):
            lg, c = prefill(self.params, {
                "tokens": self.prompts[r0:r0 + tr["prefill_rows"]]})
            first.append(torch.argmax(lg, -1).to(torch.int32))
            parts.append(c)
        self.caches = LD.cat_caches(parts) if len(parts) > 1 else parts[0]
        self.tok0 = torch.cat(first)
        del parts, lg, c
        self.generate(tr["warmup_steps"])
        self.sync()


def run(cell, rec) -> None:
    import torch
    from chipbench.lib import trace
    tr = cell.traffic
    dev = rec.device
    prog = Program(cell, rec.seed, dev)
    B, P, G = prog.B, prog.P, prog.G
    rec.setup_done()
    out: dict = {}
    stamps, positions = [], []
    served, cur = None, [prog.tok0]
    with trace.profiled(rec.traced, out):
        t0 = time.perf_counter()
        t_end = t0 + rec.window_s(tr)
        c, i = prog.caches, 0
        while True:
            nt, c = prog.step(c, cur[-1], i)
            positions.append(P + i)
            cur.append(nt)
            i += 1
            if i == G:
                served, cur = cur, [prog.tok0]
                c, i = prog.caches, 0
            stamps.append(time.perf_counter())
            if stamps[-1] >= t_end:
                break
        prog.sync()
        t1 = time.perf_counter()
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    steps = len(positions)
    rec.e2e["decode_tokens_per_s"] = B * steps / (t1 - t0)
    gaps_ms = 1e3 * np.diff([t0] + stamps)
    d = prog.d
    rec.counters.update({
        "steps": steps, "window_s": t1 - t0,
        "step_ms_p95": float(np.percentile(gaps_ms, 95)),
        "flops": sum(Z.decode_step_flops(d, B, p) for p in positions),
        "bytes": sum(Z.decode_step_bytes(d, B, p) for p in positions),
        "ssm_step_bytes": Z.ssm_step_bytes(d, B),
        "attn_kv_bytes": sum(Z.attn_core_bytes(d, B, p)
                             for p in positions)})
    rec.trace = out.get("trace")
    served = torch.stack(served if served is not None else cur, 1)
    rec.attempted = B
    print(f"chipbench: {steps} decode steps in {t1 - t0:.3f} s; "
          f"{served.shape[1]} tokens served a sequence, rows "
          f"{LD.check_rows(cell, rec.seed)} checked", file=sys.stderr)
    prompts = prog.prompts
    del c, nt, cur
    prog.free()
    rec.check("served_logit_gap",
              LD.reference_gap(cell, rec.seed, prompts, served, dev),
              tr["limits"]["served_logit_gap"])
