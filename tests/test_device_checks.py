"""The device and reporting rules of the measurement paths: the published
peak table, the refusal to measure anywhere but on a GPU (bench.py,
chip_smoke.py), chip_smoke's tolerance checks and last line, the
compile-cache directory rule, and the native library's rebuild rule."""

import json
import os
import subprocess
import sys
import types

import jax
import pytest

from supernet_tpu import flops as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _dev(kind):
    return types.SimpleNamespace(device_kind=kind, platform="gpu")


def test_peak_table_h100_row():
    assert F.peak_tflops(_dev(H100)) == 989.0
    assert F.peak_hbm_gbps(_dev(H100)) == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_peak_table_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peak"):
        F.peak_tflops(_dev(kind))
    with pytest.raises(KeyError, match="no published peak"):
        F.peak_hbm_gbps(_dev(kind))


def test_utilization_uses_the_row():
    assert F.mfu(989e12 / 2, _dev(H100)) == pytest.approx(0.5)
    assert F.hbm_utilization(3.35e12 / 4, _dev(H100)) == pytest.approx(0.25)
    # this host's CPU has no published peak: utilization raises, never 0
    with pytest.raises(KeyError):
        F.mfu(1e12)


def _run(cmd, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_bench_refuses_cpu():
    r = _run([sys.executable, "bench.py"], ROOT)
    assert r.returncode != 0
    assert "refusing" in r.stderr
    assert r.stdout.strip() == ""


def test_chip_smoke_refuses_cpu():
    r = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails before it prints a result."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = _run([sys.executable, "chip_smoke.py"], str(tmp_path),
             {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_ok_line_format():
    sys.path.insert(0, ROOT)
    import chip_smoke

    line = chip_smoke.ok_line("gpu", H100, 1)
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": H100, "count": 1}}
    assert "\n" not in line


def test_chip_smoke_tolerance_checker():
    sys.path.insert(0, ROOT)
    import chip_smoke

    tol = chip_smoke.TOLERANCES["bench"]
    good = {"probs": 1e-3, "sigma": 1e-2, "grads": 1e-2, "argmax": 1.0,
            "confident_share": 0.5}
    assert chip_smoke.within(good, tol) == []
    bad = dict(good, sigma=0.5, argmax=0.5)
    assert sorted(chip_smoke.within(bad, tol)) == ["argmax", "sigma"]
    # NaN is never within a bound
    assert chip_smoke.within(dict(good, grads=float("nan")), tol) == ["grads"]
    assert chip_smoke.rel_l2([1.0, 2.0], [1.0, 2.0]) == 0.0


def test_compile_cache_dir_set_wins(monkeypatch):
    from supernet_tpu.utils import use_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    from supernet_tpu.utils import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        path = use_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert os.environ["JAX_COMPILATION_CACHE_DIR"] == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_rebuild_rule(tmp_path):
    from supernet_tpu.native import needs_build

    src, so = tmp_path / "io.cc", tmp_path / "lib.so"
    src.write_text("// source")
    assert needs_build(str(so), str(src))  # missing
    so.write_text("lib")
    os.utime(src, (1000, 1000))
    os.utime(so, (2000, 2000))
    assert not needs_build(str(so), str(src))  # newer than its source
    os.utime(src, (3000, 3000))
    assert needs_build(str(so), str(src))  # source changed since
