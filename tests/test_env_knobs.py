"""Expert env-knob layer tests (reference: ~60-var JX_* layer, SURVEY §5)."""

import numpy as np
import pytest

from janusx_tpu import config


def test_registry_types_and_defaults():
    assert len(config.KNOBS) >= 25
    for name, (typ, default, help_) in config.KNOBS.items():
        assert help_ and isinstance(help_, str)
        if default is not None:
            assert isinstance(default, typ) or (typ is float and
                                                isinstance(default, (int, float)))
    # defaults match the documented reference-parity constants
    assert config.knob("JX_TPU_SPARSE_CUTOFF") == 0.05
    assert config.knob("JX_TPU_HASH_SEED") == 520
    assert config.knob("JX_TPU_GBLUP_MAX_N") == 15_000


def test_knob_env_override(monkeypatch):
    monkeypatch.setenv("JX_TPU_HE_PROBES", "64")
    assert config.knob("JX_TPU_HE_PROBES") == 64
    monkeypatch.setenv("JX_TPU_PROGRESS", "0")
    assert config.knob("JX_TPU_PROGRESS") is False
    monkeypatch.setenv("JX_TPU_CG_TOL", "1e-4")
    assert config.knob("JX_TPU_CG_TOL") == pytest.approx(1e-4)
    monkeypatch.delenv("JX_TPU_HE_PROBES")
    assert config.knob("JX_TPU_HE_PROBES") == 16


def test_blup_dispatch_respects_knobs(monkeypatch):
    from janusx_tpu.gs.workflow import _dispatch_blup_route

    assert _dispatch_blup_route(1000, 5000) == "GBLUP(add)"
    monkeypatch.setenv("JX_TPU_GBLUP_MAX_N", "500")
    assert _dispatch_blup_route(1000, 5000) == "rrBLUP(exact)"
    monkeypatch.setenv("JX_TPU_RRBLUP_EXACT_MAX_M", "100")
    assert _dispatch_blup_route(1000, 5000) == "rrBLUP(PCG)"


def test_progress_knob_silences_stage(monkeypatch, caplog):
    import logging

    from janusx_tpu.utils.progress import stage

    with caplog.at_level(logging.INFO, logger="janusx_tpu.progress"):
        with stage("noisy"):
            pass
    assert any("noisy" in r.message for r in caplog.records)
    caplog.clear()
    monkeypatch.setenv("JX_TPU_PROGRESS", "0")
    with caplog.at_level(logging.INFO, logger="janusx_tpu.progress"):
        with stage("silent"):
            pass
    assert not caplog.records


def test_env_cli_lists_knobs(capsys, monkeypatch):
    from janusx_tpu.cli.env import main

    monkeypatch.setenv("JX_TPU_HASH_DIM", "4096")
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "JX_TPU_HASH_DIM" in out and "4096" in out
    assert "JX_TPU_SCAN_METHOD" in out
    assert main(["-set-only"]) == 0
    out = capsys.readouterr().out
    assert "JX_TPU_HASH_DIM" in out
    assert "JX_TPU_CG_TOL" not in out


def test_eigh_backend_knob(monkeypatch):
    from janusx_tpu.core.spectral import eigh_grm

    K = np.eye(8) + 0.1
    monkeypatch.setenv("JX_TPU_EIGH_BACKEND", "device")
    b_dev = eigh_grm(K)
    monkeypatch.setenv("JX_TPU_EIGH_BACKEND", "host")
    b_host = eigh_grm(K)
    np.testing.assert_allclose(np.sort(b_dev.S), np.sort(b_host.S),
                               rtol=1e-10)


def test_choice_knob_rejects_unknown_values(monkeypatch):
    """Enumerated knobs error on typos instead of silently picking the
    `else` branch (JX_TPU_EIGH_BACKEND=devcie must not select host)."""
    from janusx_tpu.core.spectral import eigh_grm

    monkeypatch.setenv("JX_TPU_EIGH_BACKEND", "devcie")
    with pytest.raises(ValueError, match="JX_TPU_EIGH_BACKEND"):
        config.choice_knob("JX_TPU_EIGH_BACKEND", ("host", "device"))
    with pytest.raises(ValueError, match="JX_TPU_EIGH_BACKEND"):
        eigh_grm(np.eye(4))
    monkeypatch.setenv("JX_TPU_EIGH_BACKEND", "DEVICE")  # case-folded ok
    assert config.choice_knob("JX_TPU_EIGH_BACKEND",
                              ("host", "device")) == "device"


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/xla"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left in charge (the package
    names no other directory); otherwise the cache is <checkout>/.jax_cache."""
    import os

    import janusx_tpu

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            janusx_tpu.__file__)))
        assert janusx_tpu._compile_cache_dir() == os.path.join(root, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert janusx_tpu._compile_cache_dir() is None
