"""``chip_smoke.py``: its phases at tiny sizes on the CPU, its refusal to
run without a GPU, and the four-device phases on virtual CPU devices."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke

_REPO_ROOT = Path(__file__).resolve().parent.parent
_TINY_SPECS = (("a", "gradient", (20, 30)), ("b", "noise", (16, 16)),
               ("c", "mix", (40, 64)))


def test_pipeline_phase(tmp_path):
    rec = chip_smoke.phase_pipeline(tmp_path / "w", specs=_TINY_SPECS)
    assert rec["fixed_cases"] == 3 * 8  # 3 images × (4 + 4) filters
    assert rec["samples_per_case_set"] == 20 * 30 + 16 * 16 + 40 * 64


def test_headline_phase():
    rec = chip_smoke.phase_headline(batch=16, width=512, chunk=5)
    assert rec["shape"] == [16, 512]
    assert rec["run_s"] > 0


def test_tap_sweep_phase():
    rec = chip_smoke.phase_taps(taps=(63, 257, 4096), batch=2, width=4096)
    assert sorted(rec["per_taps"]) == ["257", "4096", "63"]


def test_fir2d_phase():
    rec = chip_smoke.phase_fir2d(size=64)
    assert sorted(rec["per_filter"]) == ["gauss5", "sharpen5"]


def test_overlap_save_phase():
    rec = chip_smoke.phase_overlap_save(channels=3, time_len=20_000)
    assert rec["snr_db"] > chip_smoke.OVERLAP_SAVE_SNR_DB


def test_chain_phase():
    rec = chip_smoke.phase_chain(channels=2, time_len=20_000)
    assert rec["snr_db"] > chip_smoke.CHAIN_SNR_DB
    assert rec["message_corr"] > chip_smoke.CHAIN_MIN_CORR
    assert rec["out_shape"] == [2, 13334]


def test_streaming_phase(tmp_path):
    rec = chip_smoke.phase_streaming(tmp_path, channels=3, block=500,
                                     num_blocks=4)
    assert rec["blocks"] == 4
    assert (tmp_path / "stream_state.npz").exists()


def test_chain_golden_catches_a_wrong_filter():
    """The chain check is not vacuous: a wrong channelizer fails it."""
    import dataclasses

    import numpy as np

    from warmup_fir_filter_tpu.ops.fftfilt import snr_db

    cfg = chip_smoke.ChainConfig()
    re, im, _ = chip_smoke.chain_signal(2, 20_000, cfg)
    wrong = dataclasses.replace(cfg, channelizer_cutoff=0.05)
    got = np.asarray(chip_smoke.chain_forward(re, im, wrong), np.float64)
    assert snr_db(chip_smoke.chain_forward_golden(re, im, cfg), got) < 40.0


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_four_halo", {"channels": 4, "time_len": 4 * 1000}),
    ("phase_four_overlap_save", {"channels": 2, "time_len": 4 * 5000}),
    ("phase_four_chain", {"channels": 4, "time_len": 6000}),
])
def test_four_device_phases(require_devices, phase, kwargs):
    rec = getattr(chip_smoke, phase)(require_devices(4), **kwargs)
    assert "check" in rec


def _run_script(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_exits_nonzero_without_gpu(args):
    proc = _run_script(_REPO_ROOT, *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(_REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_headline_phase_on_gpu(gpu_device):
    """Run on a card with ``JAX_PLATFORMS=cuda pytest -m gpu``."""
    rec = chip_smoke.phase_headline(batch=256, width=8192, chunk=256)
    assert rec["shape"] == [256, 8192]
    assert jax.devices()[0] == gpu_device
