"""chip_smoke.py: refuses to run without a GPU, its phases pass at tiny
sizes on the CPU, and (marked ``gpu``) its kernel phase on the card."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    p = _run(REPO, SCRIPT)
    assert p.returncode != 0
    assert "no GPU visible" in p.stderr
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    p = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


_PHASES = {
    "kernels": lambda c: c.phase_kernels(0, nbs=(16,), batch=4, m2d=10,
                                         nb2d=8),
    "first_compile": lambda c: c.phase_first_compile(5, 0),
    "main": lambda c: c.phase_main(5, 0),
    "float64": lambda c: c.phase_float64(5, 0),
    "four": lambda c: c.phase_four(5, 0, ndev=2),
}


@pytest.mark.parametrize("phase", sorted(_PHASES))
def test_chip_smoke_phase_on_cpu(phase, monkeypatch):
    c = _load()
    # tiny grids need small tiles (the main options use nb=128)
    monkeypatch.setattr(c, "MAIN_OPTS", dict(c.MAIN_OPTS, nb=8, nemin=4))
    out = _PHASES[phase](c)
    assert isinstance(out, dict) and out


def test_chip_smoke_check_raises():
    c = _load()
    c.check("x", 1e-6, 1e-5)
    with pytest.raises(AssertionError):
        c.check("x", 1e-4, 1e-5)


@pytest.mark.gpu
def test_chip_smoke_kernels_on_gpu(gpu):
    import jax

    jax.config.update("jax_enable_x64", True)
    _load().phase_kernels(0)      # raises when a kernel misses 1e-5
