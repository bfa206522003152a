"""The port's microbatch pipeline ring (``repro_torch.runtime.pipeline``)
on four ``gloo`` ranks on the CPU, held against the reference's
``pipeline_apply`` on four fake XLA devices and against the port's own
``pipeline_reference``.

The reference runs in a subprocess with
``--xla_force_host_platform_device_count=4``, as
``tests/test_runtime_distributed.py`` runs its pipeline: the reference
test's tanh stage (S 4, M 8, mb 2, d 16) on numpy inputs drawn here, plus
M 2 < S 4, a bfloat16 input with ``collect_dtype`` float32, and S 1 (one
device a ring).  Then ``torchrun --standalone`` starts four ranks of
``tests/torch_pipeline_worker.py`` on the same inputs.  Every rank's
``y`` is held to the reference's within 2e-5 (the reference test's own
tolerance; the bfloat16 case within one bfloat16 rounding) and to the
port's ``pipeline_reference`` bit for bit.  Each subprocess has a
timeout.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.runtime import pipeline as P

ROOT = Path(__file__).resolve().parent.parent
S_, M_, MB, D = 4, 8, 2, 16
CASES = ("base", "dtensor", "m_lt_s", "collect", "s1")
#: the reference test's tolerance; bfloat16 outputs: one rounding of 2^-8
TOL = {"collect": dict(rtol=2 ** -8, atol=2 ** -8)}
F32 = dict(rtol=2e-5, atol=2e-5)

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.runtime.pipeline import pipeline_apply

d = sys.argv[1]
inp = np.load(os.path.join(d, "inputs.npz"))
params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
x = jnp.asarray(inp["x"])

def stage_fn(p, h):
    return jnp.tanh(h.astype(jnp.float32) @ p["w"] + p["b"])

ring = jax.make_mesh((4,), ("stage",))
one = jax.make_mesh((1,), ("stage",))
out = {"base": pipeline_apply(ring, stage_fn, params, x),
       "m_lt_s": pipeline_apply(ring, stage_fn, params, x[:2]),
       "collect": pipeline_apply(ring, stage_fn, params,
                                 x.astype(jnp.bfloat16),
                                 collect_dtype=jnp.float32)}
for r in range(4):
    own = {k: v[r:r + 1] for k, v in params.items()}
    out[f"s1_{r}"] = pipeline_apply(one, stage_fn, own, x)
np.savez(os.path.join(d, "jax.npz"),
         **{k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()})
print("REF_OK")
"""


def _run(cmd, timeout, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, env=full, capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))


def _inputs():
    rs = np.random.RandomState(0)
    return {"w": (rs.standard_normal((S_, D, D)) * 0.3).astype(np.float32),
            "b": (rs.standard_normal((S_, D)) * 0.1).astype(np.float32),
            "x": rs.standard_normal((M_, MB, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The reference's outputs and every rank's: ({case: y}, [{case: y}],
    [{case: ref}], [{case: link counts}])."""
    tmp = tmp_path_factory.mktemp("pipeline")
    np.savez(tmp / "inputs.npz", **_inputs())
    ref = _run([sys.executable, "-c", _REF_SCRIPT, str(tmp)], timeout=300,
               JAX_PLATFORMS="cpu")
    assert "REF_OK" in ref.stdout, ref.stdout + ref.stderr
    proc = _run([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "4",
                 str(ROOT / "tests" / "torch_pipeline_worker.py"), str(tmp)],
                timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    jx = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    counts = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(4)]
    return jx, ranks, counts


def _jax_want(jx, case, rank):
    if case == "s1":
        return jx[f"s1_{rank}"]
    return jx["base" if case == "dtensor" else case]


def _ref_key(case):
    return "ref_base" if case == "dtensor" else f"ref_{case}"


@pytest.mark.parametrize("case", CASES)
def test_ring_matches_the_references(ring, case):
    """Every rank: the reference's ``pipeline_apply`` within its own
    tolerance, the port's ``pipeline_reference`` bit for bit."""
    jx, ranks, _ = ring
    for r, got in enumerate(ranks):
        y = got[f"y_{case}"]
        np.testing.assert_allclose(y, _jax_want(jx, case, r),
                                   **TOL.get(case, F32))
        assert np.array_equal(y, got[_ref_key(case)]), (case, r)


@pytest.mark.parametrize("case", [c for c in CASES if c != "s1"])
def test_every_rank_returns_the_same_y(ring, case):
    _, ranks, _ = ring
    for got in ranks[1:]:
        assert np.array_equal(got[f"y_{case}"], ranks[0][f"y_{case}"])


@pytest.mark.parametrize("case", CASES)
def test_link_counts(ring, case):
    """A ring of S sends M + S - 1 states a rank, none staged on the
    CPU; a one-stage ring sends nothing; one all-reduce at the end."""
    _, _, counts = ring
    M = 2 if case == "m_lt_s" else M_
    S = 1 if case == "s1" else S_
    state = MB * D * 4                     # the float32 state a hop
    for c in counts:
        got = c[case]
        hops = M + S - 1 if S > 1 else 0
        assert got["hops"] == hops, got
        assert got["bytes"] == hops * state, got
        assert got["staged_hops"] == got["staged_reduces"] == 0, got
        assert got["reduces"] == 1, got


@pytest.mark.parametrize("n_microbatches", [1, 2, 7, 8, 256])
@pytest.mark.parametrize("n_stages", [1, 2, 4, 5, 16])
def test_pipeline_ii_is_the_references(n_microbatches, n_stages):
    from repro.runtime.pipeline import pipeline_ii
    assert P.pipeline_ii(n_microbatches, n_stages) == \
        pipeline_ii(n_microbatches, n_stages)


def test_pipeline_reference_matches_jax():
    """The reference test's tanh stage through both ``pipeline_reference``s
    on the same numpy inputs, within 2e-5."""
    import jax.numpy as jnp
    from repro.runtime.pipeline import pipeline_reference
    inp = _inputs()

    def jstage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def tstage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    want = pipeline_reference(jstage, {k: jnp.asarray(inp[k])
                                       for k in ("w", "b")},
                              jnp.asarray(inp["x"]))
    got = P.pipeline_reference(tstage, {k: torch.from_numpy(inp[k])
                                        for k in ("w", "b")},
                               torch.from_numpy(inp["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _example():
    spec = importlib.util.spec_from_file_location(
        "pipeline_lm_torch", ROOT / "examples" / "pipeline_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_stage_matches_the_reference_examples_math():
    """``examples/pipeline_lm_torch.py``'s transformer stage against the
    reference example's (``repro.models.layers``) on the same float32
    weights and input, within 1e-5."""
    import jax.numpy as jnp
    from repro.models.layers import (AttnDims, attention_apply, mlp_apply,
                                     rms_norm)
    ex = _example()
    d, seq = ex.D, ex.SEQ
    rs = np.random.RandomState(5)

    def w(i, o):
        return {"w": (rs.standard_normal((i, o)) * i ** -0.5)
                .astype(np.float32)}

    p = {"ln1": {"g": (1 + 0.1 * rs.standard_normal(d)).astype(np.float32)},
         "attn": {"wq": w(d, 64), "wk": w(d, 32), "wv": w(d, 32),
                  "wo": w(64, d)},
         "ln2": {"g": (1 + 0.1 * rs.standard_normal(d)).astype(np.float32)},
         "mlp": {"up": w(d, 4 * d), "gate": w(d, 4 * d),
                 "down": w(4 * d, d)}}
    h = (rs.standard_normal((ex.MB, seq, d)) * 0.1).astype(np.float32)

    def jax_stage(p, h):           # the reference example's stage_fn
        dims = AttnDims(4, 2, 16)
        pos = jnp.broadcast_to(jnp.arange(seq)[None], h.shape[:2])
        h = h + attention_apply(p["attn"], rms_norm(p["ln1"], h), dims=dims,
                                positions=pos, causal=True)
        return h + mlp_apply(p["mlp"], rms_norm(p["ln2"], h))

    want = jax_stage(_jax_tree(p), jnp.asarray(h))
    got = ex.stage_fn(_torch_tree(p), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _jax_tree(t):
    import jax.numpy as jnp
    return {k: _jax_tree(v) for k, v in t.items()} if isinstance(t, dict) \
        else jnp.asarray(t)


def _torch_tree(t):
    return {k: _torch_tree(v) for k, v in t.items()} if isinstance(t, dict) \
        else torch.from_numpy(t)


def _run_example(*args):
    return _run([sys.executable, str(ROOT / "examples" /
                                     "pipeline_lm_torch.py"), *args],
                timeout=180)


def test_example_on_the_cpu_prints_the_references_lines():
    proc = _run_example("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["example"] == "pipeline_lm"
    assert report["device"] == "cpu"
    assert report["max_err"] < 5e-4 and report["every_rank_same_y"]
    assert report["ii"] == P.pipeline_ii(8, 4)
    assert sum(report["launches"].values()) == 0
    assert report["link"]["hops"] == 11 and report["link"]["staged_hops"] == 0
    assert lines[-3].startswith("4-stage transformer pipeline on a device "
                                "ring: max|err| vs sequential = ")
    assert lines[-2] == ("II model: 11 slots for 8 microbatches, bubble "
                         "27.3%, II/output 1.375 (paper: replication drives "
                         "II -> 1)")


def test_example_without_a_device_raises_where_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_example()
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
