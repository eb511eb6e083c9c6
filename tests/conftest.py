"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding/collective tests use XLA's host-platform device-count override
(SURVEY.md §4.3). These env vars must be set before the first
``import jax`` anywhere in the test process.  Tests that need a GPU
carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them here; ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
runs them on a card.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

import sys
from pathlib import Path

# Make the repo root importable without an editable install.
_REPO_ROOT = str(Path(__file__).resolve().parent.parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np
import pytest


def pytest_configure(config):
    """Build the native C++ tools once per session so the native
    cross-check tests run instead of silently skipping (VERDICT r1 #9).

    Runs at configure time (before collection) because the skipif marker
    in ``test_native_tools.py`` is evaluated during collection/setup.
    Skips the build only when no toolchain is available; a *failing*
    build is a hard error (the library is a first-class component, not
    an optional extra).
    """
    import shutil
    import subprocess

    from warmup_fir_filter_tpu import native

    if native.native_available():
        return
    if shutil.which("cmake") is None:
        return  # no toolchain — native tests skip with their own reason
    for cmd in (
        ["cmake", "--preset", "release"],
        ["cmake", "--build", "--preset", "release"],
    ):
        proc = subprocess.run(
            cmd, cwd=_REPO_ROOT, capture_output=True, text=True,
            timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"Native tools build failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
    assert native.native_available(), "build succeeded but library not found"


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(20260817)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never at import or collection)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {device.platform!r}")
    return device


@pytest.fixture
def require_devices():
    """Take the first n devices, skipping when fewer exist (e.g. one
    GPU instead of the 8-device virtual CPU mesh)."""

    def _take(n: int):
        devs = jax.devices()
        if len(devs) < n:
            pytest.skip(f"needs {n} devices, have {len(devs)}")
        return devs[:n]

    return _take


@pytest.fixture
def synthetic_rows() -> np.ndarray:
    """Deterministic 4x8 uint8 test matrix.

    Same coverage intent as the reference's test fixture
    (``output_test_common.py:12-25``): a ramp, an inverted ramp, an
    alternating row, and a saturation-prone row with hard edges.
    """
    return np.array(
        [
            [0, 32, 64, 96, 128, 160, 192, 224],
            [224, 192, 160, 128, 96, 64, 32, 0],
            [0, 255, 0, 255, 0, 255, 0, 255],
            [255, 200, 255, 0, 0, 0, 25, 75],
        ],
        dtype=np.uint8,
    )
