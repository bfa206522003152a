"""The port's data pipeline and checkpoints (``repro_torch.data.pipeline``,
``repro_torch.distributed.checkpoint``) on the CPU.

* ``MemmapCorpus``: the same file gives the same tokens as the
  reference's, bit for bit (uint16 and uint32 files, several hosts).
* ``SyntheticCorpus``: its own counter-based stream (the reference's
  threefry cannot be reproduced), deterministic in (seed, step,
  host_index); the cursor / resume contract.
* checkpoints: one format for both packages — a checkpoint written by
  the reference restores in the port and one written by the port in the
  reference, bit for bit, bfloat16 leaves included, crc checked;
  ``AsyncCheckpointer``'s ``keep``; a corrupted leaf is refused.
* the reference's ``test_resume_is_bitwise_deterministic`` on the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import MemmapCorpus as JMemmap
from repro.distributed import checkpoint as JC
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, MemmapCorpus, SyntheticCorpus
from repro_torch.data import make_corpus
from repro_torch.distributed import checkpoint as C
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.runtime import optim as O
from repro_torch.runtime.steps import make_train_step
from torch_port_support import assert_trees_bitwise, jax_bits, leaf_pairs
from torch_port_support import torch_bits


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("hosts", [1, 2])
def test_memmap_corpus_matches_reference(tmp_path, dtype, hosts):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "tokens.bin")
    rng.randint(0, 60000, 16 * 37 + 5).astype(dtype).tofile(path)
    for host in range(hosts):
        kw = dict(global_batch=4, seq_len=37, vocab=1000, num_hosts=hosts,
                  host_index=host)
        mine = MemmapCorpus(DataConfig(**kw), path, dtype=dtype)
        ref = JMemmap(JDataConfig(**kw), path, dtype=dtype)
        for step in (0, 1, 3, 9):     # wraps past the file's 16 rows
            got, want = mine.batch(step)["tokens"], ref.batch(step)["tokens"]
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert mine.cursor(5) == ref.cursor(5)
    assert isinstance(make_corpus(DataConfig(**kw), path), MemmapCorpus)
    assert isinstance(make_corpus(DataConfig(**kw)), SyntheticCorpus)


def test_synthetic_corpus_is_deterministic_and_resumable():
    dc = DataConfig(global_batch=4, seq_len=16, vocab=50, seed=3)
    a, b = SyntheticCorpus(dc), SyntheticCorpus(dc)
    for step in (0, 1, 7):
        x, y = a.batch(step)["tokens"], b.batch(step)["tokens"]
        assert x.shape == (4, 16) and x.dtype == torch.int32
        assert torch.equal(x, y)
        assert int(x.min()) >= 0 and int(x.max()) < 50
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    other = SyntheticCorpus(DataConfig(4, 16, 50, seed=4))
    assert not torch.equal(a.batch(0)["tokens"], other.batch(0)["tokens"])
    # hosts draw disjoint streams, each its local share of the batch
    h0 = SyntheticCorpus(DataConfig(4, 16, 50, seed=3, num_hosts=2))
    h1 = SyntheticCorpus(DataConfig(4, 16, 50, seed=3, num_hosts=2,
                                    host_index=1))
    assert h0.batch(2)["tokens"].shape == (2, 16)
    assert not torch.equal(h0.batch(2)["tokens"], h1.batch(2)["tokens"])
    # cursor -> resume: the same stream from the same step
    cur = a.cursor(5)
    assert cur == {"kind": "synthetic", "seed": 3, "step": 5}
    again, step = SyntheticCorpus.resume(DataConfig(4, 16, 50), cur)
    assert step == 5 and again.dc.seed == 3
    assert torch.equal(again.batch(step)["tokens"], a.batch(5)["tokens"])
    # the tokens cover the vocabulary about uniformly
    big = SyntheticCorpus(DataConfig(64, 512, 50)).batch(0)["tokens"]
    counts = torch.bincount(big.flatten().long(), minlength=50)
    assert int(counts.min()) > 0.8 * big.numel() / 50


# ------------------------------------------------------------- checkpoints
def _trees(seed=0):
    """The same small training state in both packages: params, opt
    state with int32 count, and a bfloat16 tree (mixed params)."""
    cfg = get_smoke_config("deepseek-7b")
    tree = numpy_params(cfg, seed)
    tp = params_from_numpy(cfg, tree, "cpu")
    topt = O.init_opt(tp)
    topt["m"] = tree_map(lambda x: x * 0.5 + 0.25, tp)
    topt["count"] = torch.tensor(7, dtype=torch.int32)
    tbf = tree_map(lambda x: x.to(torch.bfloat16), tp)
    # JAX gets the same bits: bf16 as its 16-bit patterns
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = {"m": jax.tree.map(lambda x: jnp.asarray(x.numpy()), topt["m"],
                              is_leaf=lambda x: isinstance(x, torch.Tensor)),
            "v": jax.tree.map(jnp.zeros_like, jp),
            "count": jnp.asarray(7, jnp.int32)}
    jbf = jax.tree.map(lambda t: jax.lax.bitcast_convert_type(
        jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16), tbf,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    return (tp, topt, tbf), (jp, jopt, jbf)


def _assert_cross(port_tree, jax_tree):
    for path, t, j in leaf_pairs(port_tree, jax_tree):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        np.testing.assert_array_equal(torch_bits(t), jax_bits(j),
                                      err_msg=path)


def test_checkpoint_reference_to_port(tmp_path):
    port, ref = _trees()
    JC.save(str(tmp_path), 3, ref, extra={"kind": "synthetic", "step": 3})
    like = tree_map(lambda x: x.to("meta"), port)
    got, step, extra = C.restore(str(tmp_path), like)
    assert step == 3 and extra == {"kind": "synthetic", "step": 3}
    assert tree_leaves(got)[0].device.type == "cpu"
    _assert_cross(got, ref)
    assert_trees_bitwise(got, port, "restored")


def test_checkpoint_port_to_reference(tmp_path):
    port, ref = _trees(1)
    path = C.save(str(tmp_path), 12, port, extra={"step": 12})
    assert os.path.basename(path) == "step_00000012"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    # names and files are the reference's
    names = [k for k in manifest["leaves"]]
    want = [JC._leaf_name(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert names == want
    assert manifest["leaves"]["2_embed"]["dtype"] == "bfloat16"
    got, step, extra = JC.restore(str(tmp_path),
                                  jax.eval_shape(lambda: ref))
    assert step == 12 and extra == {"step": 12}
    _assert_cross(port, got)
    # and the port reads its own
    back, _, _ = C.restore(str(tmp_path), port)
    assert_trees_bitwise(back, port, "round trip")


def test_checkpoint_refuses_a_corrupted_leaf(tmp_path):
    port, _ = _trees()
    path = C.save(str(tmp_path), 1, port)
    f = os.path.join(path, "1_count.npy")
    arr = np.load(f)
    np.save(f, arr + 1)
    with pytest.raises(IOError, match="checksum"):
        C.restore(str(tmp_path), port)
    C.restore(str(tmp_path), port, verify=False)      # the check is optional
    with pytest.raises(ValueError, match="shape"):
        C.restore(str(tmp_path), (port[0], {**port[1], "count":
                                            torch.zeros(2)}, port[2]),
                  verify=False)
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path / "none"), port)


def test_async_checkpointer_keeps_the_last(tmp_path):
    port, _ = _trees()
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    params = port[0]
    for step in (2, 4, 6, 8):
        ck.save_async(step, params, extra={"step": step})
        saved = tree_map(torch.clone, params)
        # an in-place update right after the call does not reach the
        # snapshot being written
        tree_map(lambda x: x.add_(1.0), params)
    ck.wait()
    assert C.list_steps(str(tmp_path)) == [6, 8]
    got, step, _ = C.restore(str(tmp_path), params)
    assert step == 8
    assert_trees_bitwise(got, saved, "step 8")
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def _run_steps(params, opt, step_fn, corpus, start, n):
    losses = []
    for s in range(start, start + n):
        params, opt, m = step_fn(params, opt, corpus.batch(s))
        losses.append(float(m["loss"]))
    return params, opt, losses


def test_resume_is_bitwise_deterministic(tmp_path):
    """train 6 steps straight == train 3, checkpoint, restore, train 3."""
    cfg = get_smoke_config("deepseek-7b")
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    corpus = SyntheticCorpus(DataConfig(global_batch=2, seq_len=32,
                                        vocab=cfg.vocab))
    step_fn = make_train_step(cfg, oc)
    tree = numpy_params(cfg, 0)

    p0 = params_from_numpy(cfg, tree, "cpu")
    pA, oA, lossA = _run_steps(p0, O.init_opt(p0), step_fn, corpus, 0, 6)

    p1 = params_from_numpy(cfg, tree, "cpu")
    p1, o1, _ = _run_steps(p1, O.init_opt(p1), step_fn, corpus, 0, 3)
    C.save(str(tmp_path), 3, (p1, o1), extra=corpus.cursor(3))
    (p2, o2), step, extra = C.restore(
        str(tmp_path), tree_map(lambda x: x.to("meta"), (p1, o1)))
    assert step == 3 and extra["step"] == 3
    pB, oB, lossB = _run_steps(p2, o2, step_fn, corpus, 3, 3)

    assert_trees_bitwise(pA, pB, "params")
    assert_trees_bitwise(oA, oB, "opt_state")
    assert lossA[-1] == lossB[-1]
