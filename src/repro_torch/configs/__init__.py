"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines the exact published config (``config()``), a reduced
``smoke_config()`` of the same family for CPU tests, ``FAMILY``, and
``SKIP_SHAPES`` (shape -> reason) for cells the assignment excludes.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe",
    "whisper-base": "repro_torch.configs.whisper_base",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
}

ARCHS = tuple(_MODULES)

#: assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()


def get_family(arch: str) -> str:
    return _mod(arch).FAMILY


def skip_reason(arch: str, shape: str) -> str | None:
    return _mod(arch).SKIP_SHAPES.get(shape)


def cells():
    """All 40 (arch, shape) cells with skip annotations."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            out.append((a, s, skip_reason(a, s)))
    return out
