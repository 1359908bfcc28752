"""Platform detection, option validation, compile-cache placement and the
no-fallback rule for device counts."""

import dataclasses
import os
import types

import numpy as np
import pytest

from spllt_tpu import Options, analyse, factor, poisson2d
from spllt_tpu.utils.jaxconfig import compilation_cache_dir, device_platform


@pytest.mark.parametrize("plat", ["cpu", "gpu"])
def test_device_platform_known(plat):
    assert device_platform(types.SimpleNamespace(platform=plat)) == plat


@pytest.mark.parametrize("plat", ["rocm", "METAL", "sycl"])
def test_device_platform_unknown_raises(plat):
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        device_platform(types.SimpleNamespace(platform=plat))


def test_device_platform_default_is_cpu_in_tests():
    # conftest routes every computation to a CPU device
    assert device_platform() == "cpu"


@pytest.mark.parametrize("field,value", [("pallas_updates", "auto"),
                                         ("pallas_hmax", 2048),
                                         ("solve_group", 8)])
def test_removed_option_fields_raise(field, value):
    with pytest.raises(TypeError):
        Options(**{field: value})


def test_schedule_mega_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        Options(schedule="mega")


def test_compilation_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache_dir() == str(tmp_path)


def test_compilation_cache_dir_default_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compilation_cache_dir() == os.path.join(repo, ".jax_cache")


def test_ndevices_above_visible_raises():
    import jax

    nvis = len(jax.devices())
    a = poisson2d(8)
    symb = analyse(a, Options(ordering="amd", nb=8, nemin=4,
                              ndevices=nvis + 1, prune_tree=True))
    with pytest.raises(ValueError, match="devices are visible"):
        factor(symb)


def test_load_symbolic_ignores_removed_fields(tmp_path):
    from spllt_tpu.utils.persist import load_symbolic, save_symbolic

    a = poisson2d(6)
    symb = analyse(a, Options(ordering="amd", nb=8, nemin=2))
    path = str(tmp_path / "s.npz")
    save_symbolic(path, symb)
    # rewrite the options as an older version saved them
    z = dict(np.load(path, allow_pickle=True))
    opts = dict(z["options"][0], solve_group=8)
    z["options"] = np.array([opts], dtype=object)
    np.savez_compressed(path, **z)
    got = load_symbolic(path)
    assert dataclasses.asdict(got.options) == dataclasses.asdict(
        symb.options)
