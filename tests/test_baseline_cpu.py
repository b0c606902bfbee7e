"""The measured-CPU-baseline scanner (native/jxbaseline.cpp) must agree
with the production brent-path scan — it is the denominator of the judged
vs_baseline ratio, so its numerics are part of the contract."""

import numpy as np
import pytest

from janusx_tpu.utils import baseline_cpu


@pytest.fixture(scope="module")
def problem():
    from janusx_tpu.core.spectral import eigh_grm

    rng = np.random.default_rng(17)
    m, n = 200, 120
    G = rng.binomial(2, 0.3, size=(m, n)).astype(np.int8)
    Gc = G.astype(np.float64) - G.mean(axis=1, keepdims=True)
    K = Gc.T @ Gc / m
    basis = eigh_grm(K, diag_ridge=1e-6)
    y = rng.normal(size=n) + Gc[11] * 0.5
    return basis, y, G, Gc


def test_baseline_builds(problem):
    assert baseline_cpu.available(), "g++ build of jxbaseline.cpp failed"


def test_baseline_matches_production_brent_scan(problem):
    """Per-SNP lambda*, beta, se vs the reference-faithful brent path of
    models.lmm.lmm_scan (method='brent') on identical inputs."""
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu.io.packed import QcParams, pack_genotypes
    from janusx_tpu.models.lmm import lmm_scan

    basis, y, G, Gc = problem
    m, n = Gc.shape
    lg, beta, se = baseline_cpu.baseline_scan(basis, y, Gc)
    assert np.isfinite(beta).all() and np.isfinite(se).all()

    g8 = G
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    pg = pack_genotypes(
        GenotypeData(g8, sites, np.array([f"i{j}" for j in range(n)], object)),
        QcParams(maf=0.0, geno=1.0),
    )
    res, _ = lmm_scan(pg, basis, y, method="brent")
    # both are Brent chains at tol 1e-2 over a flat-near-optimum objective:
    # lambda* may differ within the stop tolerance, shifting beta/se ~1%
    # on flat lanes — p-value parity below is the real contract
    np.testing.assert_allclose(beta, res.beta, rtol=2e-2, atol=1e-8)
    np.testing.assert_allclose(se, res.se, rtol=2e-2, atol=1e-8)
    # -log10 p parity within the project's scan envelope
    from janusx_tpu.core import stats as jstats

    p_base = jstats.pwald_from_beta_se(beta, se)
    dlogp = np.abs(np.log10(p_base) - np.log10(res.pwald))
    assert np.nanmax(dlogp) < 5e-2


def test_baseline_thread_invariance(problem):
    """The warm-start chain is per-chunk: results must be identical across
    thread counts (each chunk re-seeds from the null lambda)."""
    basis, y, _, Gc = problem
    lg1, b1, s1 = baseline_cpu.baseline_scan(basis, y, Gc, n_threads=1)
    lg4, b4, s4 = baseline_cpu.baseline_scan(basis, y, Gc, n_threads=4)
    # chunk boundaries change warm starts; betas at each converged optimum
    # still agree to scan tolerance
    np.testing.assert_allclose(b4, b1, rtol=2e-3, atol=1e-10)
    np.testing.assert_allclose(s4, s1, rtol=2e-3, atol=1e-10)
