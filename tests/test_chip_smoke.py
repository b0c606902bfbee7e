"""chip_smoke.py and bench.py on the CPU: their comparison helpers, phase
selection and device checks, and that neither measures on a device it
was not asked for. The runs themselves need a GPU (marker `gpu`)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import bench
import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan(rng, m=500):
    p = 10.0 ** -rng.uniform(0, 8, m)
    beta = rng.normal(size=m)
    se = rng.uniform(0.05, 0.2, m)
    return p, beta, se


def test_scan_agreement_passes_identical_scans(rng):
    p, beta, se = _scan(rng)
    dlp, dbeta = cs.scan_agreement(p * (1 + 1e-6), beta + 1e-5 * se, p, beta, se)
    cs.check("dlp", dlp, cs.SCAN_TOL_LOG10P)
    cs.check("dbeta", dbeta, cs.SCAN_TOL_BETA_SE)


@pytest.mark.parametrize("field", ["p", "beta", "nan"])
def test_scan_agreement_catches_a_perturbed_snp(rng, field):
    p, beta, se = _scan(rng)
    p2, beta2 = p.copy(), beta.copy()
    if field == "p":
        p2[7] *= 1.2  # 0.079 in -log10 p
    elif field == "beta":
        beta2[7] += 0.02 * se[7]
    else:
        p2[7] = np.nan
    dlp, dbeta = cs.scan_agreement(p2, beta2, p, beta, se)
    with pytest.raises(cs.SmokeFailure):
        cs.check("dlp", dlp, cs.SCAN_TOL_LOG10P)
        cs.check("dbeta", dbeta, cs.SCAN_TOL_BETA_SE)


def test_grm_agreement_against_numpy(rng):
    C = rng.normal(size=(300, 40))
    K_ref = C.T @ C / 300
    K = (C.astype(np.float32).T @ C.astype(np.float32) / 300).astype(np.float64)
    cs.check("grm", cs.grm_agreement(K, K_ref), cs.GRM_TOL_REL)
    K[3, 5] += 1e-3 * np.abs(K_ref).max()
    with pytest.raises(cs.SmokeFailure):
        cs.check("grm", cs.grm_agreement(K, K_ref), cs.GRM_TOL_REL)


def test_four_cards_selects_only_the_sharded_phase():
    assert cs.phases(cs.parse_args(["--four-cards"])) == [
        "device", "data", "four_cards"]
    assert "four_cards" not in cs.phases(cs.parse_args([]))


@pytest.mark.parametrize("devices,count,ok", [
    (["gpu"] * 2, 4, False),
    (["gpu"] * 4, 4, True),
    (["cpu"] * 8, 1, False),
    (["gpu"], 1, True),
])
def test_require_devices(devices, count, ok):
    devs = [SimpleNamespace(platform=p) for p in devices]
    if ok:
        cs.require_devices(devs, count)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.require_devices(devs, count)


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                        capture_output=True, text=True, env=env, cwd=ROOT,
                        timeout=120)
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout


def test_bench_toy_measurement_on_cpu(capsys):
    assert bench.main(["--platform", "cpu", "--n", "48", "--m", "256",
                       "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu" and out["card"] is None
    assert out["m"] == 256 and out["value"] > 0
    text = json.dumps(out).lower()
    assert "mfu" not in text and "peak" not in text


def test_bench_trace_reduces_to_scope_shares(capsys, monkeypatch, tmp_path):
    """The trace reduction attributes the scan's kernels to its named
    scopes; on the CPU the host plane stands in for the device's."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setenv("JX_TPU_SNP_BLOCK", "256")
    assert bench.main(["--platform", "cpu", "--n", "64", "--m", "1024",
                       "--reps", "1",
                       "--trace", str(tmp_path)]) == 0
    tr = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["trace"]
    assert tr["blocks"] == 4 and tr["device_ms_per_block"] > 0
    assert abs(sum(tr["share"].values()) - 1.0) < 1e-9
    assert {"rotate", "lattice_grams", "lattice_schur"} <= set(tr["share"])


def test_bench_refuses_a_missing_device():
    with pytest.raises(SystemExit):
        bench.main(["--platform", "gpu", "--n", "48", "--m", "256"])


@pytest.mark.gpu
def test_chip_smoke_on_the_card():
    """The full smoke run in its own process (this one is held to the CPU
    by conftest.py); skips where `nvidia-smi` finds no card."""
    try:
        subprocess.run(["nvidia-smi", "-L"], check=True, capture_output=True,
                       timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU on this host")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    cp = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                        capture_output=True, text=True, env=env, cwd=ROOT,
                        timeout=1200)
    assert cp.returncode == 0, cp.stderr[-4000:]
    assert json.loads(cp.stdout.strip().splitlines()[-1])["ok"] is True
