"""Shared test configuration: multi-device CPU CI via fake host devices.

Setting ``JAX_DEVICES=N`` (N > 1) in the environment makes the whole test
session run against N fake CPU devices by injecting
``--xla_force_host_platform_device_count=N`` into ``XLA_FLAGS`` *before*
jax initialises — the same mechanism ``launch/dryrun.py`` uses for its
512-chip dry runs.  CI runs the suite both ways (see the ``JAX_DEVICES=8``
matrix job in .github/workflows/ci.yml); locally::

    JAX_DEVICES=8 PYTHONPATH=src python -m pytest tests/test_sharded_serving.py

This must happen at conftest IMPORT time: pytest imports conftest before
any test module, but once any module imports jax the backend is fixed and
the flag is ignored.  The injection is guarded — it does nothing when
JAX_DEVICES is unset/1 (plain single-device runs are the default) or when
the flag is already present (e.g. a caller exported XLA_FLAGS itself).
"""

import os

import pytest

_FLAG = "--xla_force_host_platform_device_count"


def _force_fake_devices() -> int | None:
    n = os.environ.get("JAX_DEVICES", "")
    if not n.isdigit() or int(n) <= 1:
        return None
    if "jax" in __import__("sys").modules:  # pragma: no cover - ordering bug
        raise RuntimeError(
            "conftest must run before jax is imported for JAX_DEVICES "
            "to take effect")
    flags = os.environ.get("XLA_FLAGS", "")
    if _FLAG not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {_FLAG}={int(n)}".strip()
    return int(n)


_REQUESTED_DEVICES = _force_fake_devices()


@pytest.fixture(scope="session")
def device_count() -> int:
    """Live JAX device count (after any JAX_DEVICES forcing)."""
    import jax
    n = jax.device_count()
    if _REQUESTED_DEVICES is not None:
        assert n == _REQUESTED_DEVICES, (
            f"JAX_DEVICES={_REQUESTED_DEVICES} requested but jax reports "
            f"{n} devices — something imported jax before conftest")
    return n


@pytest.fixture(scope="session")
def multi_device(device_count) -> int:
    """Skip the test unless the session really has >= 2 devices."""
    if device_count < 2:
        pytest.skip("needs >= 2 devices (run with JAX_DEVICES=8)")
    return device_count


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")
