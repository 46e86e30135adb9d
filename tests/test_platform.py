"""Per-platform implementation choice, the compile-cache helper, the
benchmark's peak table and chip_smoke.py's refusals off the GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import jax

from meteor_scatter_tpu import platform

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def backend(monkeypatch):
    def set_backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_backend


class TestPlatform:
    def test_cpu_keeps_reference_formulations(self, backend):
        backend("cpu")
        assert platform.platform() == "cpu"
        assert (platform.stream_front(), platform.stream_solver()) == ("welch", "scan")

    def test_gpu_takes_its_table_entries(self, backend):
        backend("gpu")
        assert platform.platform() == "gpu"
        gpu = platform._DEFAULTS["gpu"]
        assert platform.stream_front() == gpu["stream_front"]
        assert platform.stream_solver() == gpu["stream_solver"]
        assert gpu["stream_front"] in ("welch", "bins")
        assert gpu["stream_solver"] in ("scan", "jump", "hop", "fused")

    @pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
    def test_other_backends_raise(self, backend, name):
        backend(name)
        with pytest.raises(ValueError, match="unsupported JAX backend"):
            platform.platform()
        with pytest.raises(ValueError):
            platform.stream_solver()

    @pytest.mark.parametrize("name", ["cpu", "gpu"])
    def test_scan_unroll(self, backend, name):
        backend(name)
        u = platform.scan_unroll()
        assert u == platform._DEFAULTS[name]["scan_unroll"]
        assert isinstance(u, int) and u >= 1

    @pytest.mark.parametrize("name,want", [("cpu", True), ("gpu", False)])
    def test_interpret_only_on_cpu(self, backend, name, want):
        backend(name)
        assert platform.interpret_kernels() is want


class TestCompileCache:
    def test_env_variable_left_to_jax(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
        assert platform.enable_compile_cache() == "/some/cache"
        assert calls == []

    def test_fixed_path_in_checkout(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = platform.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        assert platform.enable_compile_cache() == path  # no time, no pid in it


class TestPeakTable:
    def test_h100_kind(self):
        import bench

        assert bench.peak_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3.35e12
        art = {"value": 1e12, "stations64_samples_per_sec": 1e9}
        assert bench.implausible_metrics(art, "NVIDIA H100 80GB HBM3") == ["value"]

    def test_unknown_kind_raises(self):
        import bench

        with pytest.raises(ValueError, match="no published memory bandwidth"):
            bench.peak_bytes_per_sec("Some Accelerator 9000")


def run_smoke(*args, devices=1):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )


def no_json_result(stdout):
    for line in stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


class TestChipSmoke:
    def test_refuses_cpu(self):
        r = run_smoke()
        assert r.returncode != 0
        assert "needs a GPU" in r.stderr
        assert no_json_result(r.stdout)

    def test_four_needs_four_devices(self):
        r = run_smoke("--four", devices=2)
        assert r.returncode != 0
        assert "needs 4 devices" in r.stderr
        assert no_json_result(r.stdout)
