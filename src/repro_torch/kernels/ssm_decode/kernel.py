"""A Mamba2 layer's decode step on the card: the launch wrappers of
``csrc/ssm_decode.cu``.

``ssm_step`` takes one token's in-projection ``proj`` [B, d_in_proj] (z,
then the convolution's x, B and C, then dt) and a layer's caches — the
conv state [B, K-1, C] and the float32 SSM state [B, H, N, P] — and
returns the gated, normed output [B, d_inner] in ``proj``'s type with
the new conv and SSM states, leaving the caches as they were: the
convolution, the state's update, the output, the gate and the gated norm
(over each SSM group with ``SSMDims.group_norm``, else the whole row) in
two launches.  ``rms_norm`` is ``models.layers.rms_norm`` of ``x`` (plus
``extra``) in one.  Their plain versions are ``models.ssm._step_plain``
and ``models.layers.rms_norm``: the callers take them for a tensor on
the CPU; for a CUDA tensor these wrappers launch the kernels or raise.

The kernels are float32 inside and round each output once; the plain
versions round to the activations' type after several steps, so the two
differ by that rounding (``tolerance``).  The conv is the exception: it
runs in the conv state's type, as the plain version's does, with its
roundings.  One library serves every
width, compiled with ``nvcc`` at first use and loaded with ``ctypes``;
nothing is built when this module is imported.  ``launch_counts`` counts
launches of each entry.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

#: activation and cache types the kernels take
TYPES = (torch.float32, torch.bfloat16)
#: the widest P or N the step kernel's threads cover (one block's threads)
MAX_WIDTH = 1024

launch_counts = {"ssm_decode_step": 0, "rms_norm": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def tolerance(dtype, want) -> dict:
    """``torch.testing.assert_close``'s ``rtol`` and ``atol`` that a
    kernel's output in ``dtype`` keeps to against ``want``, the plain
    version's run on the same inputs with the activations widened to
    float32 (the conv state keeps its type: the conv runs in it, with its
    roundings, in both).  The kernels are that arithmetic in another
    order of its float32 sums (1e-5), then round once: a bfloat16 output
    lies within one bfloat16 step of ``want`` (rtol 2^-7), and 2^-12
    max|want| covers the sums' order near zero."""
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    return dict(rtol=2 ** -7, atol=2 ** -12 * float(want.abs().max()))


# ------------------------------------------------------------------ build
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_decode.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
#: the signatures (shapes, types, device) checked already: a decode step
#: calls the same few 81 times, and the host's work a call is its pace
_checked: set = set()


def build_library(verbose: bool = False) -> Path:
    return _nvcc.build(SOURCE, NVCC_FLAGS, "ssm_decode",
                       _nvcc.build_dir(SOURCE.parent.parent),
                       "the Mamba2 decode-step kernels", verbose)


def load_library(verbose: bool = False):
    """Build (if needed) and load the library; cached per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(verbose)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ssm_decode_step.argtypes = [p] * 14 + [i] * 8 + [f, f, i, i,
                                                                p]
            lib.ssm_decode_step.restype = i
            lib.rms_norm.argtypes = [p] * 6 + [i, i, f, i, p]
            lib.rms_norm.restype = i
            _lib = lib
    return _lib


# ----------------------------------------------------------------- checks
def _check(name, t, shape, dtypes, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")


def check_step(p, proj, conv_state, ssm_state, dims) -> None:
    """What ``ssm_step`` takes (raises on anything else): ``proj`` [B,
    d_in_proj], the caches of ``dims``' shapes, float32 parameters of the
    mixer's shapes, all contiguous on one CUDA device; P and N at most
    ``MAX_WIDTH``.  The wrappers check a signature once (a model's layers
    share their shapes and types)."""
    B, dev = proj.shape[0], proj.device
    din, N, G, H, P, K = (dims.d_inner, dims.d_state, dims.n_groups,
                          dims.n_heads, dims.head_dim, dims.d_conv)
    C = din + 2 * G * N
    if max(P, N) > MAX_WIDTH or H % G:
        raise ValueError(f"head dim {P} / state {N} / {H} heads in {G} "
                         "groups: not a shape the kernel takes")
    _check("proj", proj, (B, din + C + H), TYPES, dev)
    _check("conv_state", conv_state, (B, K - 1, C), TYPES, dev)
    _check("ssm_state", ssm_state, (B, H, N, P), (torch.float32,), dev)
    f32 = (torch.float32,)
    for name, shape in (("conv_w", (K, C)), ("conv_b", (C,)),
                        ("dt_bias", (H,)), ("A_log", (H,)), ("D", (H,))):
        _check(name, p[name], shape, f32, dev)
    _check("norm", p["norm"]["g"], (din,), f32, dev)


# --------------------------------------------------------------- wrappers
def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ssm_step(p, proj, conv_state, ssm_state, dims, eps: float):
    """One token through the mixer's core on the card: (y [B, d_inner] in
    ``proj``'s type, new conv state, new SSM state); ``eps`` the gated
    norm's."""
    proj, conv_state, ssm_state = (t.contiguous() for t in
                                   (proj, conv_state, ssm_state))
    key = ("step", dims, proj.shape, proj.dtype, conv_state.dtype,
           ssm_state.dtype, proj.device)
    if key not in _checked:
        check_step(p, proj, conv_state, ssm_state, dims)
        _checked.add(key)
    B, din, H = proj.shape[0], dims.d_inner, dims.n_heads
    lib = load_library()
    y = torch.empty((B, din), dtype=proj.dtype, device=proj.device)
    conv = torch.empty_like(conv_state)
    ssm = torch.empty_like(ssm_state)
    ws = torch.empty(B * (din + H), dtype=torch.float32, device=proj.device)
    lim = dims.dt_limits
    with torch.cuda.device(proj.device):
        status = lib.ssm_decode_step(
            proj.data_ptr(), conv_state.data_ptr(), ssm_state.data_ptr(),
            p["conv_w"].data_ptr(), p["conv_b"].data_ptr(),
            p["dt_bias"].data_ptr(), p["A_log"].data_ptr(),
            p["D"].data_ptr(), p["norm"]["g"].data_ptr(), conv.data_ptr(),
            ssm.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * B * din,
            y.data_ptr(), B, din, dims.d_state, dims.n_groups, H,
            dims.head_dim, dims.d_conv,
            dims.n_groups if dims.group_norm else 1,
            0.0 if lim is None else lim[0], eps,
            int(proj.dtype == torch.bfloat16),
            int(conv_state.dtype == torch.bfloat16), _stream(proj.device))
    if status != 0:
        raise RuntimeError(f"ssm_decode_step: launch failed with CUDA error "
                           f"{status}")
    launch_counts["ssm_decode_step"] += 1
    return y, conv, ssm


def rms_norm(x, g, eps: float, extra=None):
    """``(x + extra)`` RMS-normed over its last dim with gain ``g``
    (float32) on the card, in ``x``'s type."""
    D = x.shape[-1]
    x = x.contiguous()
    key = ("norm", x.shape, x.dtype, x.device, extra is None)
    if key not in _checked:
        _check("x", x, x.shape, TYPES, x.device)
        if extra is not None:
            _check("extra", extra, x.shape, (x.dtype,), x.device)
        _check("g", g, (D,), (torch.float32,), x.device)
        _checked.add(key)
    if extra is not None:
        extra = extra.contiguous()
    lib = load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.rms_norm(
            x.data_ptr(), None, None if extra is None else extra.data_ptr(),
            g.data_ptr(), out.data_ptr(), None, x.numel() // D, D, eps,
            int(x.dtype == torch.bfloat16), _stream(x.device))
    if status != 0:
        raise RuntimeError(f"rms_norm: launch failed with CUDA error "
                           f"{status}")
    launch_counts["rms_norm"] += 1
    return out


class MambaStack:
    """A decode step over a stack of Mamba2 layers on the card, with the
    host's work a layer cut to two launches beside the projections:
    ``norm(i, ...)`` folds the previous layer's residual add into layer
    ``i``'s input norm (the residual stream ``h`` updated in place), and
    ``step(i, proj)`` runs the step between the projections, reading
    layer ``i``'s slices of the stacked params and caches and writing its
    new states into the step's stacked caches, ``conv`` and ``ssm`` (made
    here).  Layer slices are addresses, not tensor views; shapes, types
    and devices are checked once, on the stacked tensors.  ``x`` (the
    normed input) and ``y`` (the step's output) are scratch, reused by
    every layer in stream order.

    ``p``: the stack's mixer params (leaves [L, ...]); ``ln``: its norm
    gains [L, D]; ``caches``: its ``{"conv", "ssm"}`` [L, B, ...];
    ``eps``: the model's, of the input norms and the gated norms."""

    def __init__(self, p, ln, caches, dims, eps: float, h):
        L, B, D = ln.shape[0], h.shape[0], h.shape[-1]
        conv_in, ssm_in = (caches[k].contiguous() for k in ("conv", "ssm"))
        key = ("stack", dims, L, B, h.dtype, conv_in.dtype, h.device)
        if key not in _checked:
            proj = torch.empty((B, 2 * dims.d_inner + dims.n_heads
                                + 2 * dims.n_groups * dims.d_state),
                               dtype=h.dtype, device=h.device)
            check_step({k: v[0] for k, v in p.items() if torch.is_tensor(v)}
                       | {"norm": {"g": p["norm"]["g"][0]}}, proj,
                       conv_in[0], ssm_in[0], dims)
            for t in (*p.values(), p["norm"]["g"], ln, conv_in, ssm_in):
                if torch.is_tensor(t) and (not t.is_contiguous()
                                           or t.shape[0] != L):
                    raise ValueError("stacked leaves must be contiguous "
                                     f"[{L}, ...]")
            _check("ln", ln, (L, D), (torch.float32,), h.device)
            _checked.add(key)
        self.lib, self.dims, self.eps = load_library(), dims, eps
        self.B, self.D, self.bf16 = B, D, int(h.dtype == torch.bfloat16)
        self.cache_bf16 = int(conv_in.dtype == torch.bfloat16)
        self.conv, self.ssm = torch.empty_like(conv_in), \
            torch.empty_like(ssm_in)
        self.x = torch.empty((B, D), dtype=h.dtype, device=h.device)
        self.y = torch.empty((B, dims.d_inner), dtype=h.dtype,
                             device=h.device)
        self.ws = torch.empty(B * (dims.d_inner + dims.n_heads),
                              dtype=torch.float32, device=h.device)
        self.stream = _stream(h.device)
        self.device = h.device

        def layer(t):
            """(address of layer 0, bytes a layer) of a stacked tensor."""
            return t.data_ptr(), t[0].numel() * t.element_size()
        self.at = {k: layer(v) for k, v in p.items() if torch.is_tensor(v)}
        self.at["norm"] = layer(p["norm"]["g"])
        self.at["ln"] = layer(ln)
        for k, t in (("conv_in", conv_in), ("ssm_in", ssm_in),
                     ("conv_out", self.conv), ("ssm_out", self.ssm)):
            self.at[k] = layer(t)

    def _ptr(self, name: str, i: int) -> int:
        base, step = self.at[name]
        return base + i * step

    def norm(self, i: int, h, add=None, extra=None):
        """Layer ``i``'s normed input [B, D] (``self.x``) of ``h`` [B, 1,
        D], plus ``add`` (then written to ``h``) and ``extra``."""
        with torch.cuda.device(self.device):
            status = self.lib.rms_norm(
                h.data_ptr(), None if add is None else add.data_ptr(),
                None if extra is None else extra.data_ptr(),
                self._ptr("ln", i), self.x.data_ptr(),
                None if add is None else h.data_ptr(), self.B, self.D,
                self.eps, self.bf16, self.stream)
        if status != 0:
            raise RuntimeError(f"rms_norm: launch failed with CUDA error "
                               f"{status}")
        launch_counts["rms_norm"] += 1
        return self.x

    def step(self, i: int, proj):
        """Layer ``i``'s step from its in-projection ``proj`` [B,
        d_in_proj]: its output [B, d_inner] (``self.y``); its new states
        in ``self.conv[i]`` and ``self.ssm[i]``."""
        d, B = self.dims, self.B
        lim = d.dt_limits
        with torch.cuda.device(self.device):
            status = self.lib.ssm_decode_step(
                proj.data_ptr(), self._ptr("conv_in", i),
                self._ptr("ssm_in", i), self._ptr("conv_w", i),
                self._ptr("conv_b", i), self._ptr("dt_bias", i),
                self._ptr("A_log", i), self._ptr("D", i),
                self._ptr("norm", i), self._ptr("conv_out", i),
                self._ptr("ssm_out", i), self.ws.data_ptr(),
                self.ws.data_ptr() + 4 * B * d.d_inner, self.y.data_ptr(),
                B, d.d_inner, d.d_state, d.n_groups, d.n_heads, d.head_dim,
                d.d_conv, d.n_groups if d.group_norm else 1,
                0.0 if lim is None else lim[0], self.eps, self.bf16,
                self.cache_bf16, self.stream)
        if status != 0:
            raise RuntimeError(f"ssm_decode_step: launch failed with CUDA "
                               f"error {status}")
        launch_counts["ssm_decode_step"] += 1
        return self.y
