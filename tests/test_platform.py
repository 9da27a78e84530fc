"""Platform plumbing: the roofline peaks table, the compile-cache location,
and the native parser built from source at first use."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest

from fedrann_jax.io import native
from fedrann_jax.metrics import DEVICE_PEAKS, device_peaks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind, peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
    ("NVIDIA H100 NVL", (835e12, 3.9e12)),
])
def test_device_peaks_h100(kind, peaks):
    dev = types.SimpleNamespace(platform="gpu", device_kind=kind)
    assert device_peaks(dev) == peaks == DEVICE_PEAKS[kind]


def test_device_peaks_cpu_is_none():
    assert device_peaks() is None  # the test mesh is the CPU


def test_device_peaks_unknown_gpu_raises():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA A100")
    with pytest.raises(ValueError, match="NVIDIA A100"):
        device_peaks(dev)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    expect = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        expect = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = expect
    out = subprocess.run(
        [sys.executable, "-c",
         "import fedrann_jax, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
        check=True)
    assert out.stdout.strip().splitlines()[-1] == expect


@pytest.fixture
def native_src(tmp_path):
    for name in ("fastxpack.cpp", "Makefile"):
        shutil.copy(os.path.join(native.NATIVE_DIR, name), tmp_path / name)
    return tmp_path


def test_native_built_when_missing(native_src):
    so = native.ensure_built(str(native_src))
    assert so == str(native_src / "libfastxpack.so")
    assert os.path.exists(so)
    assert not [p for p in os.listdir(native_src) if ".tmp" in p]


def test_native_rebuilt_when_stale(native_src):
    so = native.ensure_built(str(native_src))
    stale = os.path.getmtime(native_src / "fastxpack.cpp") - 100
    os.utime(so, (stale, stale))
    assert native.ensure_built(str(native_src)) == so
    assert os.path.getmtime(so) > stale + 50
    # fresh: no rebuild
    mtime = os.path.getmtime(so)
    native.ensure_built(str(native_src))
    assert os.path.getmtime(so) == mtime


def test_summary_without_peaks_keeps_results(monkeypatch):
    """A GPU with no published peaks loses only the utilization figures."""
    from fedrann_jax import metrics

    def unknown(device=None):
        raise ValueError("no published peaks for device kind 'X'")

    monkeypatch.setattr(metrics, "device_peaks", unknown)
    m = metrics.StageMetrics()
    with m.stage("knn"):
        pass
    m.stages["knn"]["seconds"] = 2.0
    m.add_work("knn", flops=4e12)
    knn = m.summary()["knn"]
    assert knn["tflops_per_s"] == 2.0
    assert "mfu_pct" not in knn
