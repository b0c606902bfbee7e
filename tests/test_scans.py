"""GWAS scan tests vs independent numpy/scipy implementations."""

import numpy as np
import pytest
import scipy.optimize
import scipy.stats

from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io.gdata import GenotypeData, SiteInfo
from janusx_tpu.io.packed import QcParams, pack_genotypes
from janusx_tpu.models.grm import grm_from_packed
from janusx_tpu.models.lm import lm_scan
from janusx_tpu.models.fvlmm import fvlmm_scan
from janusx_tpu.models.lmm import lmm_scan

from tests.test_reml import np_reml, np_beta_se


@pytest.fixture(scope="module")
def scan_problem():
    rng = np.random.default_rng(7)
    m, n = 200, 100
    p = rng.uniform(0.1, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    pg = pack_genotypes(gd, QcParams(maf=0.05, geno=0.05))
    K = grm_from_packed(pg, method=1)
    basis = eigh_grm(K, diag_ridge=1e-6)
    cov = rng.normal(size=(n, 1))
    y = 0.3 + 0.2 * cov[:, 0] + pg.centered()[3] * 0.9 + rng.normal(size=n)
    return pg, K, basis, cov, y


def test_lm_scan_vs_numpy(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res = lm_scan(pg, y, cov, block=64)
    X = np.concatenate([np.ones((pg.n, 1)), cov], axis=1)
    n, p = X.shape
    df = n - p - 1
    H = X @ np.linalg.inv(X.T @ X) @ X.T
    M = np.eye(n) - H
    G = pg.centered()
    for i in range(0, pg.m, 17):
        gv = G[i]
        gMy = gv @ M @ y
        gMg = gv @ M @ gv
        beta = gMy / gMg
        rss = y @ M @ y - gMy**2 / gMg
        se = np.sqrt(rss / df / gMg)
        t = beta / se
        pexp = 2 * scipy.stats.t.sf(abs(t), df)
        assert res.beta[i] == pytest.approx(beta, rel=1e-6)
        assert res.se[i] == pytest.approx(se, rel=1e-6)
        assert res.pwald[i] == pytest.approx(pexp, rel=1e-5)


def test_fvlmm_scan_vs_numpy(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res, null = fvlmm_scan(pg, basis, y, cov, block=64)
    # independent: weighted regression at the null lambda on rotated scale
    X = np.concatenate([np.ones((pg.n, 1)), cov], axis=1)
    Xr = basis.U.T @ X
    yr = basis.U.T @ y
    w = 1.0 / (basis.S + null.lbd)
    n, p = Xr.shape
    df = n - p - 1
    W = np.diag(w)
    P = W - W @ Xr @ np.linalg.inv(Xr.T @ W @ Xr + 1e-6 * np.eye(p)) @ Xr.T @ W
    G = pg.centered()
    for i in range(0, pg.m, 23):
        gr = basis.U.T @ G[i]
        gPg = gr @ P @ gr
        beta = (gr @ P @ yr) / gPg
        se = np.sqrt((yr @ P @ yr / df) / gPg)
        assert res.beta[i] == pytest.approx(beta, rel=1e-5)
        assert res.se[i] == pytest.approx(se, rel=1e-5)


def test_lmm_scan_vs_scipy_per_snp(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res, null = lmm_scan(pg, basis, y, cov, block=64, lmm2=True)
    X = np.concatenate([np.ones((pg.n, 1)), cov], axis=1)
    Xr = basis.U.T @ X
    yr = basis.U.T @ y
    G = pg.centered()
    checked = 0
    for i in range(0, pg.m, 29):
        gr = basis.U.T @ G[i]
        opt = scipy.optimize.minimize_scalar(
            lambda lg: -np_reml(lg, basis.S, Xr, yr, gr),
            bounds=(-5, 5),
            method="bounded",
            options={"xatol": 1e-10},
        )
        eb, es = np_beta_se(opt.x, basis.S, Xr, yr, gr)
        # Brent scan tol is 1e-2 in log10(lambda): compare p-values loosely
        # and beta/se at matched lambda tightly
        ob, os_ = np_beta_se(np.log10(res.lbd[i]), basis.S, Xr, yr, gr)
        # genotype rotation runs in f32 (as in the reference's sgemm path):
        # beta/se agree to f32-rotation noise
        assert res.beta[i] == pytest.approx(ob, rel=1e-5)
        assert res.se[i] == pytest.approx(os_, rel=1e-5)
        p_ref = 2 * scipy.stats.norm.sf(abs(eb / es))
        lp_ours = -np.log10(res.pwald[i])
        lp_ref = -np.log10(p_ref)
        assert lp_ours == pytest.approx(lp_ref, abs=2e-2)
        checked += 1
    assert checked > 5
    # lambda column is the per-SNP optimum; plrt present and in (0, 1]
    assert np.all(res.plrt > 0) and np.all(res.plrt <= 1)
    assert np.all(res.lbd > 0)


def test_lmm_detects_causal_snp(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res, _ = lmm_scan(pg, basis, y, cov, block=64)
    # SNP index 3 of the packed set was causal with large effect
    assert res.pwald[3] <= np.partition(res.pwald, 4)[4]  # among top-5
    assert res.pwald[3] < 1e-3


def test_tsv_output(scan_problem, tmp_path):
    pg, K, basis, cov, y = scan_problem
    res, _ = lmm_scan(pg, basis, y, cov, block=64, lmm2=True)
    path = str(tmp_path / "out.assoc.tsv")
    res.write_tsv(path)
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = fh.readlines()
    assert header == [
        "chrom", "pos", "snp", "allele0", "allele1", "af", "miss",
        "beta", "se", "chisq", "pwald", "lambda", "ml", "plrt",
    ]
    assert len(rows) == pg.m
    first = rows[0].split("\t")
    assert len(first) == 14
    float(first[10])  # pwald parses


def test_lmm_grid_matches_brent(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res_g, null = lmm_scan(pg, basis, y, cov, block=64, method="grid")
    res_b, _ = lmm_scan(pg, basis, y, cov, block=64, method="brent", null=null)
    lg_g = np.log10(res_g.lbd) if res_g.lbd is not None else None
    # p-values agree to well under the scan tolerance
    lp_g = -np.log10(res_g.pwald)
    lp_b = -np.log10(res_b.pwald)
    np.testing.assert_allclose(lp_g, lp_b, atol=5e-3)
    ok = np.isfinite(res_g.beta) & np.isfinite(res_b.beta)
    assert ok.mean() > 0.95
    # on near-flat likelihood surfaces (null SNPs) lambda* is ill-defined to
    # the scan tolerance, so beta can move slightly with the optimizer
    np.testing.assert_allclose(res_g.beta[ok], res_b.beta[ok], rtol=1e-2, atol=1e-3)


def test_lmm_superblock_streaming_matches(scan_problem):
    pg, K, basis, cov, y = scan_problem
    res_full, null = lmm_scan(pg, basis, y, cov, block=64)
    res_stream, _ = lmm_scan(
        pg, basis, y, cov, block=64, null=null, superblock=128
    )
    np.testing.assert_allclose(res_stream.pwald, res_full.pwald, rtol=1e-6)
    ok = np.isfinite(res_full.beta)
    np.testing.assert_allclose(res_stream.beta[ok], res_full.beta[ok], rtol=1e-6)


@pytest.mark.parametrize("n,p_cov,h2", [
    (80, 0, 0.1), (80, 2, 0.9), (300, 0, 0.5), (300, 1, 0.9), (150, 3, 0.3),
])
def test_grid_vs_brent_parity_sweep(n, p_cov, h2):
    """ROADMAP parity hardening: the fast grid path must match the
    reference-faithful batched Brent across sample sizes, covariate
    counts, and heritability regimes."""
    rng = np.random.default_rng(n * 7 + p_cov * 13 + int(h2 * 10))
    m = 120
    p = rng.uniform(0.1, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    pg = pack_genotypes(gd, QcParams(maf=0.05, geno=0.05))
    K = grm_from_packed(pg, method=1)
    basis = eigh_grm(K, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p_cov)) if p_cov else None
    # simulate at the requested heritability via a polygenic draw on K
    L = np.linalg.cholesky(K + 1e-4 * np.eye(n))
    u = L @ rng.normal(size=n)
    u = u / u.std() * np.sqrt(h2)
    e = rng.normal(size=n) * np.sqrt(1 - h2)
    y = u + e + (cov.sum(axis=1) * 0.2 if p_cov else 0.0)
    res_g, null = lmm_scan(pg, basis, y, cov, block=64, method="grid")
    res_b, _ = lmm_scan(pg, basis, y, cov, block=64, method="brent", null=null)
    ok = np.isfinite(res_g.pwald) & np.isfinite(res_b.pwald)
    lg = -np.log10(np.clip(res_g.pwald[ok], 1e-300, 1))
    lb = -np.log10(np.clip(res_b.pwald[ok], 1e-300, 1))
    assert np.max(np.abs(lg - lb)) < 0.1
    # at low n/h2 the REML is flat in λ, so λ* (and with it beta) can move
    # between equally-likely optima; the Wald p (asserted above) is the
    # scientific contract — betas only need to agree loosely
    np.testing.assert_allclose(res_g.beta[ok], res_b.beta[ok], rtol=0.1, atol=1e-3)


def test_lm_scan_multi_matches_single(scan_problem, rng):
    """Batched multi-trait LM == per-trait scans (f32-gram noise only)."""
    from janusx_tpu.models.lm import lm_scan, lm_scan_multi

    pg = scan_problem[0]
    Y = rng.normal(size=(pg.n, 3))
    cov = rng.normal(size=(pg.n, 2))
    multi = lm_scan_multi(pg, Y, cov)
    for t in range(3):
        single = lm_scan(pg, Y[:, t], cov)
        np.testing.assert_allclose(multi[t].beta, single.beta,
                                   rtol=2e-4, atol=1e-8, equal_nan=True)
        lp_m = -np.log10(multi[t].pwald)
        lp_s = -np.log10(single.pwald)
        np.testing.assert_allclose(lp_m, lp_s, atol=5e-3)


@pytest.mark.parametrize("multi", [False, True], ids=["lmm_scan", "lmm_scan_multi"])
def test_scan_takes_one_route_on_every_backend(multi, monkeypatch):
    """No backend chooses a kernel: with jax.default_backend() reporting a
    GPU the grid scans run the same XLA body and agree bit for bit."""
    import jax

    from janusx_tpu.models.lmm import lmm_scan_multi

    rng = np.random.default_rng(11)
    m, n = 1024, 64  # whole 512-SNP blocks
    g = rng.binomial(2, rng.uniform(0.1, 0.5, (m, 1)), size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    pg = pack_genotypes(
        GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)),
        QcParams(maf=0.0))
    basis = eigh_grm(grm_from_packed(pg), diag_ridge=1e-6)
    Y = rng.normal(size=(n, 2))

    def run():
        if multi:
            return lmm_scan_multi(pg, basis, Y, block=512)[0]
        return [lmm_scan(pg, basis, Y[:, 0], block=512)[0]]

    cpu = run()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    gpu = run()
    for a, b in zip(cpu, gpu):
        np.testing.assert_array_equal(a.beta, b.beta)
        np.testing.assert_array_equal(a.se, b.se)
        np.testing.assert_array_equal(a.pwald, b.pwald)
