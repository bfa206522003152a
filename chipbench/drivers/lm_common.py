"""What the LM drivers share: the port's model configuration built from
a Hugging Face style configuration file, the benchmark's weights placed
in the port's parameter tree, and token rows drawn from the seed."""

from __future__ import annotations

import numpy as np

from chipbench.lib.record import seed_int

#: where each of the reference's weights sits in the port's tree
PATHS = {"embed": ("embed",), "head": ("head",),
         "final_norm": ("final_norm", "g"),
         "ln1": ("stacks", 0, 0, "ln1", "g"),
         "wq": ("stacks", 0, 0, "attn", "wq", "w"),
         "wk": ("stacks", 0, 0, "attn", "wk", "w"),
         "wv": ("stacks", 0, 0, "attn", "wv", "w"),
         "wo": ("stacks", 0, 0, "attn", "wo", "w"),
         "ln2": ("stacks", 0, 0, "ln2", "g"),
         "up": ("stacks", 0, 0, "mlp", "up", "w"),
         "gate": ("stacks", 0, 0, "mlp", "gate", "w"),
         "down": ("stacks", 0, 0, "mlp", "down", "w")}


def model_config(config: dict, remat: str = "full"):
    """The port's ``ModelConfig`` of a dense Llama-style configuration."""
    import dataclasses
    from repro_torch.models import ModelConfig, dense_stacks
    d, h = config["hidden_size"], config["num_attention_heads"]
    cfg = ModelConfig(name=config["name"], d_model=d, n_heads=h,
                      n_kv_heads=config.get("num_key_value_heads", h),
                      d_ff=config["intermediate_size"],
                      vocab=config["vocab_size"],
                      head_dim=config.get("head_dim", d // h),
                      stacks=dense_stacks(config["num_hidden_layers"]),
                      rope_theta=float(config.get("rope_theta", 10000.0)),
                      norm_eps=float(config.get("rms_norm_eps", 1e-6)),
                      full_attention=True)
    return dataclasses.replace(cfg, remat_policy=remat)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def port_params(cfg, weights: dict) -> dict:
    """The port's parameter tree holding ``weights``' tensors themselves
    (no copy); its structure and shapes are checked against the port's
    own ``init_params`` on the meta device."""
    from repro_torch.models.blocks import tree_leaves, tree_map
    from repro_torch.models.model import init_params
    want = init_params(cfg, device="meta")
    tree = tree_map(lambda _: None, want)
    for name, path in PATHS.items():
        parent = get(tree, path[:-1])
        parent[path[-1]] = weights[name]
    leaves, shapes = tree_leaves(tree), tree_leaves(want)
    if any(x is None for x in leaves) or len(leaves) != len(shapes):
        raise ValueError("the port's parameter tree has leaves the "
                         "benchmark does not make")
    for x, w in zip(leaves, shapes):
        if tuple(x.shape) != tuple(w.shape):
            raise ValueError(f"weight of shape {tuple(x.shape)} where the "
                             f"port wants {tuple(w.shape)}")
    return tree


def token_rows(seed: int, salt: int, n_rows: int, row_len: int, vocab: int,
               docs: dict) -> np.ndarray:
    """``[n_rows, row_len]`` int32 rows cut from a stream of documents
    joined by token 0: document lengths log-normal (``median``,
    ``sigma``, clipped to [``min_len``, ``max_len``]), tokens Zipf
    (``zipf``) over a seeded order of ids 1..vocab-1."""
    rng = np.random.default_rng(seed_int(seed, salt))
    order = rng.permutation(np.arange(1, vocab))
    need = n_rows * row_len
    parts, have = [], 0
    while have < need:
        n = int(np.clip(rng.lognormal(np.log(docs["median"]), docs["sigma"]),
                        docs["min_len"], docs["max_len"]))
        ranks = (rng.zipf(docs["zipf"], n) - 1) % (vocab - 1)
        parts.append(order[ranks])
        parts.append(np.zeros(1, dtype=order.dtype))
        have += n + 1
    return np.concatenate(parts)[:need].reshape(n_rows, row_len) \
        .astype(np.int32)
