"""Independent numpy re-implementation cross-check for FarmCPU.

The recovery grid (tests/test_farmcpu_recovery.py) anchors the selection
DYNAMICS and the frozen-seed goldens anchor reproducibility — but both
are self-referential. This file is the rMVP-independent second opinion
(VERDICT r4 item 6): a deliberately naive, loop-per-SNP numpy FarmCPU
(direct OLS per marker, dense-eigenbasis REM scoring, explicit binning /
pruning) with NO shared code with janusx_tpu/models/farmcpu.py beyond
the packed-decode input, run on planted panels and compared
per-iteration.

Checked against the production `farmcpu_scan`:
  - per-loop pseudo-QTN index sets (exact equality, every loop),
  - the final QTN set and loop count,
  - final per-SNP p-values/beta (to the f32-gram envelope of lm_scan).

Reference semantics being validated: /root/reference/src/stats/farmcpu.rs
(FEM conditional scan :1-40; select_lead_indices :832 — no p cut on REM
lead sets; farmcpu_raw_prepare_seq_qtn :899-911 — threshold on the
winning union with saved QTNs kept; QTNbound default :4340-4358).
"""

from __future__ import annotations

import numpy as np
import pytest

from janusx_tpu.io.packed import QcParams, pack_genotypes
from janusx_tpu.models.farmcpu import farmcpu_scan
from janusx_tpu.models.sim import simulate_genotypes, simulate_phenotype

# -- the naive re-implementation (numpy only, no janusx farmcpu imports) ----


def _t_sf_two_sided(t, df):
    """Two-sided Student-t p via the regularized incomplete beta
    (scipy.special — not the production student_t_p_two_sided)."""
    from scipy.special import betainc

    t = np.asarray(t, np.float64)
    x = df / (df + t * t)
    return betainc(df / 2.0, 0.5, x)


def naive_fem_scan(G, y, X0):
    """Direct per-SNP OLS: y ~ [X0, g_j]; returns (beta, se, p) of g_j."""
    m, n = G.shape
    k = X0.shape[1] + 1
    df = n - k
    beta = np.empty(m)
    se = np.empty(m)
    for j in range(m):
        X = np.concatenate([X0, G[j][:, None]], axis=1)
        coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ coef
        sigma2 = float(r @ r) / df
        XtX_inv = np.linalg.pinv(X.T @ X)
        beta[j] = coef[-1]
        se[j] = np.sqrt(max(sigma2 * XtX_inv[-1, -1], 1e-300))
    p = _t_sf_two_sided(beta / se, df)
    return beta, se, p


def naive_qtn_tests(Zq, y, X_base):
    """Joint background model: each pseudo-QTN's own covariate t-test,
    as (beta, se, p)."""
    X = np.concatenate([X_base, Zq.T], axis=1)
    n, k = X.shape
    df = n - k
    coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ coef
    sigma2 = float(r @ r) / df
    Cinv = np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.maximum(sigma2 * np.diag(Cinv), 1e-300))
    p = _t_sf_two_sided(coef / se, df)
    q = slice(X_base.shape[1], None)
    return coef[q], se[q], p[q]


def naive_qtn_pvalues(Zq, y, X_base):
    return naive_qtn_tests(Zq, y, X_base)[2]


def naive_rem_score(Zq, y):
    """-REML loglik of y ~ N(1μ, vg(K_q + λI)), K_q = Zq'Zq/q — computed
    the EXPENSIVE way: dense n x n eigendecomposition (vs the production
    low-rank q x q route), grid + parabolic refine over log10 λ (vs the
    production scipy bounded minimizer)."""
    q, n = Zq.shape
    yc = y - y.mean()
    K = Zq.T @ Zq / q
    s, U = np.linalg.eigh(K)  # full dense spectrum, zeros included
    yu = U.T @ yc

    def score(lg):
        lbd = 10.0 ** lg
        w = s + lbd
        quad = float(yu @ (yu / w))
        if quad <= 0:
            return 1e8
        return 0.5 * ((n - 1) * np.log(quad) + float(np.log(w).sum()))

    grid = np.linspace(-5, 5, 2001)
    vals = np.array([score(g) for g in grid])
    i = int(np.argmin(vals))
    # parabolic refinement around the grid minimum
    if 0 < i < len(grid) - 1:
        x0, x1, x2 = grid[i - 1: i + 2]
        f0, f1, f2 = vals[i - 1: i + 2]
        den = (f0 - 2 * f1 + f2)
        if den > 0:
            xs = x1 + 0.5 * (f0 - f2) / den * (grid[1] - grid[0])
            return min(float(vals[i]), score(float(np.clip(xs, -5, 5))))
    return float(vals[i])


def naive_bin_leads(chrom_idx, pos, pvals, window, n_lead):
    bins = [(int(c), int(p) // window) for c, p in zip(chrom_idx, pos)]
    order = np.argsort(pvals, kind="stable")
    seen, leads = set(), []
    for i in order:
        if bins[i] in seen:
            continue
        seen.add(bins[i])
        leads.append(int(i))
        if len(leads) >= n_lead:
            break
    return np.array(sorted(leads), dtype=np.int64)


def naive_prune(G, cand, pvals, r_cut=0.7):
    if len(cand) <= 1:
        return cand
    Z = G[cand]
    Zc = Z - Z.mean(axis=1, keepdims=True)
    nrm = np.sqrt((Zc * Zc).sum(axis=1))
    nrm[nrm == 0] = 1.0
    R = (Zc / nrm[:, None]) @ (Zc / nrm[:, None]).T
    order = np.argsort(pvals[cand], kind="stable")
    keep = []
    for i in order:
        if all(abs(R[i, j]) <= r_cut for j in keep):
            keep.append(i)
    return np.sort(cand[np.array(keep, dtype=np.int64)])


def naive_farmcpu(G, chrom, pos, y, max_loops=10,
                  windows=(500_000, 5_000_000, 50_000_000), nbin=5):
    """The full raw-route loop, naive at every stage. G is the centered
    (m, n) dosage matrix (same decode as production — decode is covered
    by IO tests; everything downstream here is independent)."""
    m, n = G.shape
    y = np.asarray(y, np.float64)
    p_threshold = 1.0 / m
    qtn_threshold = 0.01
    qb = max(int(np.floor(np.sqrt(n / np.log10(n)))), 1)
    step = max(qb // nbin, 1)
    lead_counts = tuple(range(step, qb + 1, step)) or (qb,)
    chrom_ids = {c: i for i, c in enumerate(dict.fromkeys(chrom))}
    chrom_idx = np.array([chrom_ids[c] for c in chrom])
    ones = np.ones((n, 1))

    qtns = np.array([], dtype=np.int64)
    history, loop_sets = [], []
    pvals = None
    for loop in range(max_loops):
        X0 = ones if not len(qtns) else np.concatenate(
            [ones, G[qtns].T], axis=1)
        _, _, pvals = naive_fem_scan(G, y, X0)
        if len(qtns):
            pvals[qtns] = naive_qtn_pvalues(G[qtns], y, ones)
        if loop == 0 and np.nanmin(pvals) >= p_threshold:
            return qtns, loop_sets, pvals, loop + 1
        best_score, best_leads = np.inf, np.array([], dtype=np.int64)
        for win in windows:
            for nb in lead_counts:
                leads = naive_bin_leads(chrom_idx, pos, pvals, win, nb)
                if not len(leads):
                    continue
                sc = naive_rem_score(G[leads], y)
                if sc < best_score:
                    best_score, best_leads = sc, leads
        best_leads = best_leads[pvals[best_leads] < qtn_threshold]
        cand = np.unique(np.concatenate([qtns, best_leads]))
        cand = naive_prune(G, cand, pvals, 0.7)
        key = tuple(cand.tolist())
        loop_sets.append(key)
        if np.array_equal(cand, qtns) or key in history:
            qtns = cand
            break
        history.append(key)
        qtns = cand

    X0 = ones if not len(qtns) else np.concatenate([ones, G[qtns].T], axis=1)
    beta, se, pvals = naive_fem_scan(G, y, X0)
    if len(qtns):
        pvals[qtns] = naive_qtn_pvalues(G[qtns], y, ones)
    return qtns, loop_sets, pvals, None


# -- the cross-check -------------------------------------------------------


def _problem(n, m, h2, seed):
    gd = simulate_genotypes(n, m, seed=seed)
    sim = simulate_phenotype(gd, n_qtl=8, h2=h2, seed=seed + 77)
    pg = pack_genotypes(gd, QcParams())
    return pg, np.asarray(sim.phenotypes, np.float64).reshape(-1)


@pytest.mark.parametrize("h2,seed", [(0.5, 3), (0.4, 9)])
def test_farmcpu_matches_independent_numpy(h2, seed):
    pg, y = _problem(260, 1600, h2, seed)
    out = farmcpu_scan(pg, y)

    G = pg.centered()
    qtns, loop_sets, pvals, _ = naive_farmcpu(
        G, list(pg.sites.chrom), np.asarray(pg.sites.pos), y)

    # per-iteration pseudo-QTN sets: exact agreement, every loop
    assert len(out.loop_sets) == len(loop_sets), (
        f"loop count differs: {len(out.loop_sets)} vs {len(loop_sets)}\n"
        f"prod={out.loop_sets}\nnaive={loop_sets}")
    for t, (a, b) in enumerate(zip(out.loop_sets, loop_sets)):
        assert a == b, f"loop {t}: prod {a} != naive {b}"
    assert np.array_equal(out.qtns, qtns)
    assert len(out.qtns) > 0, "test panel should select pseudo-QTNs"

    # final p-values: agree to the f32-gram envelope of the device scan
    pw = out.result.pwald
    ok = np.isfinite(pw) & np.isfinite(pvals) & (pw > 0) & (pvals > 0)
    assert ok.sum() > 0.95 * pg.m
    dlogp = np.abs(np.log10(pw[ok]) - np.log10(pvals[ok]))
    assert np.nanmax(dlogp) < 5e-3, f"max dlogp {np.nanmax(dlogp)}"


def test_farmcpu_qtn_rows_report_the_joint_model():
    """QTN rows carry the joint background model's beta, se and p: the
    final scan, conditioned on each QTN, has no defined effect for it."""
    pg, y = _problem(260, 1600, 0.5, 3)
    out = farmcpu_scan(pg, y)
    q = out.qtns
    assert len(q) > 0
    beta, se, p = naive_qtn_tests(pg.centered()[q], y, np.ones((pg.n, 1)))
    r = out.result
    np.testing.assert_allclose(r.beta[q], beta, rtol=1e-6)
    np.testing.assert_allclose(r.se[q], se, rtol=1e-6)
    np.testing.assert_allclose(r.pwald[q], p, rtol=1e-6)


def test_rem_score_lowrank_matches_dense(rng):
    """The production low-rank REM scorer (q x q eigenproblem +
    complement term) equals the dense n x n eigendecomposition route at
    matched λ-optimum, across q << n and q ~ n shapes."""
    from janusx_tpu.models.farmcpu import _rem_score

    n = 120
    y = rng.normal(size=n)
    for q in (3, 17, 80):
        Z = rng.normal(size=(q, n))
        prod = _rem_score(Z, y)
        naive = naive_rem_score(Z, y)
        # both optimize the same objective with different optimizers /
        # linear algebra; the MINIMA must coincide
        assert abs(prod - naive) < 1e-3, (q, prod, naive)
