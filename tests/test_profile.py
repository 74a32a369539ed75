"""Backend profile resolution, compile-cache placement, and the chip
smoke test's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from dataclasses import replace

import jax
import pytest

from za_tpu.engine import engine as E
from za_tpu.engine.profile import PROFILES, resolve_profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "metal"])
def test_resolve_profile(platform):
    if platform not in PROFILES:
        with pytest.raises(RuntimeError, match="'metal'"):
            resolve_profile(platform)
        return
    prof = resolve_profile(platform)
    assert prof.name == platform
    if platform == "cpu":  # the test configuration, unchanged
        assert prof.msm_style == "grouped"
    else:  # the H100 choices, made by elimination (PERF.md)
        assert prof.msm_style == "rns"
    assert not (prof.msm_tree or prof.ntt_fourstep)


def test_engine_takes_backend_profile():
    eng = E.TpuEngine()
    assert eng.profile is PROFILES[jax.default_backend()]
    assert (eng.msm_style, eng.reduce_style, eng.layout) == (
        "grouped", "scan", "limb")
    assert not eng.msm_tree and not eng.use_grouped
    gpu = E.TpuEngine(profile=PROFILES["gpu"])
    assert gpu.msm_style == "rns" and gpu.use_grouped
    assert gpu.msm_tree == PROFILES["gpu"].msm_tree
    four = E.TpuEngine(profile=replace(PROFILES["gpu"], ntt_fourstep=True))
    assert four._domain(1 << 12).fourstep is not None
    assert eng._domain(1 << 12).fourstep is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, env_set):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    E._enable_compilation_cache()
    if env_set:
        assert calls == {}  # JAX reads the variable itself
    else:
        assert calls["jax_compilation_cache_dir"] == os.path.join(
            REPO, ".jax_cache")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr
