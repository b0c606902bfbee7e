"""FaST-LMM low-rank exact LMM scan (``-lowrank``).

Reference: /root/reference/src/stats/fastlmm_lowrank.rs (per-SNP Brent on
the low-rank spectral REML, U1/U2 split, add/dom/rec/het genetic models)
and /root/reference/src/math/FaST.rs (fastlmm_prepare_lowrank_f64).

When the kinship is built from q selected SNPs with q < n, K = W W' has
rank k <= q and its eigensystem is the economy SVD of W — O(n q^2)
instead of the O(n^3) dense eigh, and the per-SNP rotation drops from
O(n^2) to O(n k). With V = diag(S) + λ I in the eigenbasis, every
quadratic form splits into the k-dim rotated part plus the (n-k)-dim
complement, where all eigenvalues equal the kinship diag ridge r:

    a' V^-1 b = Σ_i ar_i br_i / (S_i + r + λ)  +  (a'b − ar'br)/(r + λ)
    log|V|    = Σ_i log(S_i + r + λ)  +  (n − k) log(r + λ)

so the complement never needs its eigenvectors — only raw-minus-rotated
Gram corrections (the reference's U2 projections, fastlmm_lowrank.rs
precompute_u2_base/precompute_u2_snp, collapse into these corrections).

Device mapping: instead of the reference's rayon per-SNP scalar Brent, a
whole SNP block shares one fine log10-λ grid — per-SNP grid pieces are
(B, k) @ (k, G) device matmuls plus rank-1 correction outer products, and
λ* selection reuses the Schur-complement closed form of the full-rank
resident scan (core.reml.grid_argmin_schur). beta/se are then evaluated
at λ* per lane. Genetic models (add/dom/rec/het) transform the decoded
dosage on device before projection (fastlmm_lowrank.rs GeneticModel).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core import stats as jstats
from janusx_tpu.core.reml import GridShared, NullFit, grid_argmin_schur
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu.ops import decode

_BAD = 1e8


class LowRankBasis(NamedTuple):
    """Economy eigensystem of a rank-deficient kinship K = U diag(S) U'.

    ``ridge`` is the implicit eigenvalue of the (n-k)-dim complement —
    the diag ridge the dense route adds before eigh (spectral.eigh_grm),
    kept here so low-rank and dense scans agree numerically."""

    U: np.ndarray  # (n, k) top eigenvectors
    S: np.ndarray  # (k,) eigenvalues (descending), EXCLUDING the ridge
    n: int
    ridge: float = 1e-6
    snp_idx: np.ndarray | None = None  # SNPs the kinship was built from

    @property
    def k(self) -> int:
        return self.U.shape[1]


def select_kinship_snps(m: int, q: int) -> np.ndarray:
    """Evenly-spaced kinship SNP subset (deterministic; the reference
    leaves selection to the caller — fastlmm_lowrank.rs takes eigvecs)."""
    if q >= m:
        return np.arange(m)
    return np.unique(np.round(np.linspace(0, m - 1, q)).astype(np.int64))


def select_kinship_snps_ld(pg: PackedGenotypes, q: int,
                           r2_threshold: float = 0.2) -> np.ndarray:
    """LD-pruned kinship SNP subset: windowed greedy prune (the standard
    FaST-LMM practice — kinship markers in approximate linkage
    equilibrium give a better-conditioned low-rank K than evenly-spaced
    picks in high-LD regions), then thin the survivors evenly to q."""
    from janusx_tpu.models.ldprune import ld_prune

    kept = ld_prune(pg, r2_threshold=r2_threshold)
    if len(kept) <= q:
        return kept
    take = np.unique(np.round(np.linspace(0, len(kept) - 1, q)).astype(np.int64))
    return kept[take]


def lowrank_basis_from_snps(
    pg: PackedGenotypes,
    q: int | None = None,
    snp_idx: np.ndarray | None = None,
    method: int = 1,
    ridge: float = 1e-6,
    rel_tol: float = 1e-12,
    ld_prune: bool = False,
) -> LowRankBasis:
    """Build the low-rank kinship basis from q SNP columns via economy SVD.

    method 1 (cGRM): K = Σ x x' / Σ 2p(1-p); method 2 (sGRM): K = Σ z z'/q
    (models/grm.py conventions). Mirrors fastlmm_prepare_lowrank_f64's
    eigenvalue thresholding (math/FaST.rs rel_tol) on the squared
    singular values."""
    if snp_idx is None:
        q = q or min(pg.m, 4096)
        snp_idx = (select_kinship_snps_ld(pg, q) if ld_prune
                   else select_kinship_snps(pg.m, q))
    sel = pg.take_snps(np.asarray(snp_idx, np.int64))
    Xc = sel.centered().astype(np.float64).T  # (n, q) centered columns
    if method == 2:
        var = 2.0 * sel.af * (1.0 - sel.af)
        with np.errstate(divide="ignore"):
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
        Xc = Xc * inv_sd[None, :]
        c0 = float(len(snp_idx))
    else:
        c0 = float(np.sum(2.0 * sel.af * (1.0 - sel.af)))
    W = Xc / math.sqrt(max(c0, 1e-30))
    # economy SVD on host (n x q, q small); K = U diag(sv^2) U'
    U, sv, _ = np.linalg.svd(W, full_matrices=False)
    S = sv * sv
    keep = S > (S[0] * rel_tol if S.size else 0.0)
    keep &= S > 0
    return LowRankBasis(
        U=np.ascontiguousarray(U[:, keep]),
        S=S[keep],
        n=pg.n,
        ridge=ridge,
        snp_idx=np.asarray(snp_idx, np.int64),
    )


class RotatedLR(NamedTuple):
    """Host-side rotated design + complement corrections (all float64)."""

    S: np.ndarray  # (k,) eigenvalues INCLUDING the ridge shift
    Xr: np.ndarray  # (k, p)
    yr: np.ndarray  # (k,)
    PXX: np.ndarray  # (k, p*p)
    PXy: np.ndarray  # (k, p)
    Pyy: np.ndarray  # (k,)
    cXX: np.ndarray  # (p, p)  X'X − Xr'Xr
    cXy: np.ndarray  # (p,)
    cyy: float
    X: np.ndarray  # (n, p) raw design (for per-SNP raw products)
    y: np.ndarray  # (n,)
    n: int
    ridge: float

    @property
    def k(self) -> int:
        return self.S.shape[0]

    @property
    def p(self) -> int:
        return self.Xr.shape[1]


def make_rotated_lr(
    lrb: LowRankBasis, y: np.ndarray, X_cov: np.ndarray | None
) -> RotatedLR:
    n = lrb.n
    y = np.asarray(y, np.float64).reshape(-1)
    ones = np.ones((n, 1), np.float64)
    X = ones if X_cov is None else np.concatenate(
        [ones, np.asarray(X_cov, np.float64)], axis=1
    )
    # Exact reparameterization, mirroring core.reml.make_rotated: subtract
    # the f64 OLS projection of y onto span(X) BEFORE building the rotated
    # and complement pieces. REML/ML values, λ, vg/ve and every per-SNP
    # statistic are mathematically invariant (GLS effects are
    # translation-invariant in span(X)), but without it a constant
    # phenotype offset is only absorbed through the GRAM_RIDGE'd null
    # solve — inexactly — which on flat boundary optima (weak low-rank
    # kinship signal) moved λ̂ by ~0.5 log10 units, and a large phenotype
    # mean leaked into the f32 per-SNP G-side products
    # (tests/test_metamorphic_r5b.py::test_lowrank_affine_equivariance).
    # Downstream: the null fit's beta is ~0 by construction, as on the
    # dense route (fit_null_reml_lr docstring).
    c, *_ = np.linalg.lstsq(X, y, rcond=None)
    y = y - X @ c
    Xr = lrb.U.T @ X  # (k, p)
    yr = lrb.U.T @ y
    k = Xr.shape[0]
    return RotatedLR(
        S=lrb.S + lrb.ridge,
        Xr=Xr,
        yr=yr,
        PXX=(Xr[:, :, None] * Xr[:, None, :]).reshape(k, -1),
        PXy=Xr * yr[:, None],
        Pyy=yr * yr,
        cXX=X.T @ X - Xr.T @ Xr,
        cXy=X.T @ y - Xr.T @ yr,
        cyy=float(y @ y - yr @ yr),
        X=X,
        y=y,
        n=n,
        ridge=lrb.ridge,
    )


def _null_pieces_lr(rot: RotatedLR, lg: float):
    """Weighted null grams at log10 λ (host, float64)."""
    lbd = 10.0 ** lg
    v = rot.S + lbd
    v0 = rot.ridge + lbd
    if not (np.all(v > 0) and v0 > 0):
        return None
    w = 1.0 / v
    w0 = 1.0 / v0
    p = rot.p
    M = (rot.Xr * w[:, None]).T @ rot.Xr + w0 * rot.cXX
    rhs = rot.Xr.T @ (w * rot.yr) + w0 * rot.cXy
    ayy = float((w * rot.yr) @ rot.yr + w0 * rot.cyy)
    logdetV = float(np.sum(np.log(v)) + (rot.n - rot.k) * math.log(v0))
    return M, rhs, ayy, logdetV


def fit_null_reml_lr(rot: RotatedLR) -> tuple[NullFit, np.ndarray, float]:
    """Host Brent null REML fit on the low-rank objective.

    Same profiled-REML formulas as core.reml.fit_null_reml_host (reference
    src/stats/reml.rs:255,364,572), with low-rank weighted grams. Returns
    (NullFit, beta_null, vg). NOTE: make_rotated_lr residualizes y onto
    span(X), so beta_null is ~0 by construction (as on the dense route);
    vg (a residual quadratic form, invariant to the residualization) is
    the meaningful output."""
    import scipy.linalg as sla
    from scipy.optimize import minimize_scalar

    n, p = rot.n, rot.p
    ridge = config.GRAM_RIDGE * np.eye(p)

    def solve(lg: float):
        pc = _null_pieces_lr(rot, float(lg))
        if pc is None:
            return None
        M, rhs, ayy, logdetV = pc
        try:
            L = sla.cholesky(M + ridge, lower=True)
        except sla.LinAlgError:
            return None
        beta = sla.cho_solve((L, True), rhs)
        logdetA = 2.0 * float(np.sum(np.log(np.diag(L))))
        rtwr = float(ayy - 2.0 * beta @ rhs + beta @ (M @ beta))
        return beta, rtwr, logdetV, logdetA

    def neg_reml(lg: float) -> float:
        pc = solve(lg)
        if pc is None:
            return _BAD
        _, rtwr, logdetV, logdetA = pc
        if not np.isfinite(rtwr) or rtwr <= 0:
            return _BAD
        c = (n - p) * (math.log(n - p) - 1.0 - math.log(2.0 * math.pi)) / 2.0
        return -(c - 0.5 * ((n - p) * math.log(rtwr) + logdetV + logdetA))

    res = minimize_scalar(
        neg_reml,
        bounds=(config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH),
        method="bounded",
        options={"xatol": config.NULL_BRENT_TOL,
                 "maxiter": config.NULL_BRENT_MAX_ITER},
    )
    lg = float(res.x)
    pc = solve(lg)
    if pc is None:
        raise ValueError(
            "low-rank null REML fit failed: covariate Gram is not positive"
            " definite at the optimum (collinear or constant covariates?)"
        )
    beta, rtwr, logdetV, _ = pc
    cm = n * (math.log(n) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = cm - 0.5 * (n * math.log(rtwr) + logdetV)
    fit = NullFit(
        lbd=10.0 ** lg, log10_lbd=lg, reml=float(-neg_reml(lg)), ml=float(ml)
    )
    return fit, np.asarray(beta), float(rtwr / (n - p))


def lowrank_switch_p(rot: RotatedLR) -> tuple[float, NullFit]:
    """Boundary LRT p for Va=0 (LMM->LM auto-switch) from the low-rank
    null — mirrors workflows.gwas.lmm_to_lm_switch_p semantics. Returns
    (p, null_fit) so the caller can reuse the null in the scan."""
    null, _, _ = fit_null_reml_lr(rot)
    X, y = rot.X, rot.y
    n = rot.n
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    rss = float(np.sum((y - X @ beta) ** 2))
    ml_lm = -0.5 * n * (math.log(2.0 * math.pi * rss / n) + 1.0)
    stat = 2.0 * (null.ml - ml_lm)
    stat = max(stat, 0.0) if np.isfinite(stat) else 0.0
    p = 0.5 * float(jstats.chi2_sf_df1(np.asarray(stat)))
    p = min(max(p if np.isfinite(p) else 1.0, np.finfo(np.float64).tiny), 1.0)
    return p, null


def _grid_shared_lr(rot: RotatedLR, grid_lg: np.ndarray) -> GridShared:
    """Shared λ-grid pieces (host numpy f64 → f32 device arrays).

    w32 carries the (G, k) LOW-RANK weights; the complement weight w0 is
    folded into the shared grams here and applied to the per-SNP pieces
    on device via rank-1 outer products."""
    p = rot.p
    G = len(grid_lg)
    lbd = 10.0 ** grid_lg
    v = rot.S[None, :] + lbd[:, None]  # (G, k)
    v0 = rot.ridge + lbd  # (G,)
    w = 1.0 / v
    w0 = 1.0 / v0
    logdetV = np.sum(np.log(v), axis=1) + (rot.n - rot.k) * np.log(v0)
    Axx = (w @ rot.PXX).reshape(G, p, p) + w0[:, None, None] * rot.cXX
    axy = w @ rot.PXy + w0[:, None] * rot.cXy
    ayy = w @ rot.Pyy + w0 * rot.cyy
    Ar = Axx + config.GRAM_RIDGE * np.eye(p)
    try:
        L = np.linalg.cholesky(Ar)
    except np.linalg.LinAlgError as e:
        raise ValueError(
            "low-rank grid setup failed: covariate Gram is not positive"
            " definite on the λ grid (collinear or constant covariates?)"
        ) from e
    logdetAr = 2.0 * np.sum(np.log(np.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    Ar_inv = np.linalg.inv(Ar)
    Ainv_axy = np.einsum("gpq,gq->gp", Ar_inv, axy)
    f32 = jnp.float32
    return GridShared(
        grid_lg=jnp.asarray(grid_lg, jnp.float64),
        w32=jnp.asarray(w, f32),
        logdetV32=jnp.asarray(logdetV, f32),
        Axx32=jnp.asarray(Axx, f32),
        axy32=jnp.asarray(axy, f32),
        ayy32=jnp.asarray(ayy, f32),
        Ar_inv32=jnp.asarray(Ar_inv, f32),
        Ainv_axy32=jnp.asarray(Ainv_axy, f32),
        logdetAr32=jnp.asarray(logdetAr, f32),
    )


def _transform_codes(codes, model: str):
    """Genetic-model indicator on TRUE hardcall codes 0/1/2
    (fastlmm_lowrank.rs GeneticModel::apply). Missing (3) handled by the
    caller — indicators must never see imputed means."""
    f32 = jnp.float32
    if model == "add":
        return codes.astype(f32)
    if model == "dom":
        return ((codes == 1) | (codes == 2)).astype(f32)
    if model == "rec":
        return (codes == 2).astype(f32)
    if model == "het":
        return (codes == 1).astype(f32)
    raise ValueError(f"unknown genetic model: {model}")


def _decode_transformed_centered(packed, n: int, model: str):
    """(B, nb) packed -> (B, n) centered genetic-model values.

    The transform is applied to the RAW codes; missing genotypes are
    imputed with the per-SNP mean of the TRANSFORMED non-missing values
    (then centering sends them to exactly 0). Applying indicators to
    mean-imputed dosages would instead code every missing sample as a
    deterministic carrier/non-carrier."""
    codes = decode.unpack_codes(packed)[:, :n]
    obs = codes != 3
    t = _transform_codes(jnp.where(obs, codes, 0), model)
    cnt = jnp.maximum(jnp.sum(obs, axis=-1, keepdims=True), 1)
    tm = jnp.sum(jnp.where(obs, t, 0.0), axis=-1, keepdims=True) / cnt
    return jnp.where(obs, t - tm, 0.0)


class _LrConsts(NamedTuple):
    """Device-resident per-trait constants for the low-rank scan."""

    Uk: jax.Array  # (n, k) f32
    X: jax.Array  # (n, p) f32
    y: jax.Array  # (n,) f32
    Xr: jax.Array  # (k, p) f32
    yr: jax.Array  # (k,) f32
    S64: jax.Array  # (k,) f64 (ridge-shifted)
    PXX64: jax.Array  # (k, p*p) f64
    PXy64: jax.Array  # (k, p) f64
    Pyy64: jax.Array  # (k,) f64
    cXX64: jax.Array  # (p, p) f64
    cXy64: jax.Array  # (p,) f64
    cyy64: jax.Array  # () f64
    ridge64: jax.Array  # () f64


def _lr_consts(rot: RotatedLR) -> _LrConsts:
    f32, f64 = jnp.float32, jnp.float64
    return _LrConsts(
        Uk=None,  # filled by caller (depends on the basis, not the trait)
        X=jnp.asarray(rot.X, f32),
        y=jnp.asarray(rot.y, f32),
        Xr=jnp.asarray(rot.Xr, f32),
        yr=jnp.asarray(rot.yr, f32),
        S64=jnp.asarray(rot.S, f64),
        PXX64=jnp.asarray(rot.PXX, f64),
        PXy64=jnp.asarray(rot.PXy, f64),
        Pyy64=jnp.asarray(rot.Pyy, f64),
        cXX64=jnp.asarray(rot.cXX, f64),
        cXy64=jnp.asarray(rot.cXy, f64),
        cyy64=jnp.asarray(rot.cyy, f64),
        ridge64=jnp.asarray(rot.ridge, f64),
    )


def _final_stats_lr(cs: _LrConsts, Gr, cgX, cgy, cgg, lg_star, n: int,
                    with_ml: bool):
    """(beta, se[, ml]) at per-lane λ* — low-rank twin of
    core.reml.final_stats_f32: f32 (B,k) grams + f64 corrections, then the
    small (p+1) Schur algebra in f64."""
    f64 = jnp.float64
    hp = jax.lax.Precision.HIGHEST
    p = cs.Xr.shape[1]
    lbd = jnp.power(10.0, lg_star)  # (B,) f64
    v = cs.S64[None, :] + lbd[:, None]  # (B, k) f64
    v0 = cs.ridge64 + lbd  # (B,)
    w = (1.0 / v).astype(jnp.float32)
    w0 = 1.0 / v0  # f64
    Gw = Gr * w  # (B, k) f32
    Axx = (
        jnp.dot(w, cs.PXX64.astype(jnp.float32), precision=hp).astype(f64)
        .reshape(-1, p, p)
        + w0[:, None, None] * cs.cXX64
    )
    axy = (
        jnp.dot(w, cs.PXy64.astype(jnp.float32), precision=hp).astype(f64)
        + w0[:, None] * cs.cXy64
    )
    ayy = (
        jnp.dot(w, cs.Pyy64.astype(jnp.float32), precision=hp).astype(f64)
        + w0 * cs.cyy64
    )
    axg = (
        jnp.dot(Gw, cs.Xr, precision=hp).astype(f64) + w0[:, None] * cgX
    )
    agy = jnp.dot(Gw, cs.yr, precision=hp).astype(f64) + w0 * cgy
    agg = jnp.sum(Gw * Gr, axis=-1).astype(f64) + w0 * cgg

    ridge = config.GRAM_RIDGE
    Ar = Axx + ridge * jnp.eye(p, dtype=f64)
    L = jnp.linalg.cholesky(Ar)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    badA = jnp.any(~jnp.isfinite(diag) | (diag <= 0), axis=-1)
    Ls = jnp.where(badA[:, None, None], jnp.eye(p, dtype=f64), L)

    def chosolve(b):
        z = jax.lax.linalg.triangular_solve(
            Ls, b[..., None], left_side=True, lower=True, transpose_a=False
        )
        return jax.lax.linalg.triangular_solve(
            Ls, z, left_side=True, lower=True, transpose_a=True
        )[..., 0]

    u = chosolve(axg)
    Ainv_axy = chosolve(axy)
    schur = (agg + ridge) - jnp.sum(axg * u, axis=-1)
    beta_g = (agy - jnp.sum(axg * Ainv_axy, axis=-1)) / schur
    beta_X = Ainv_axy - beta_g[:, None] * u
    lin = jnp.sum(beta_X * axy, axis=-1) + beta_g * agy
    quad = (
        jnp.einsum("bp,bpq,bq->b", beta_X, Axx, beta_X)
        + 2.0 * beta_g * jnp.sum(axg * beta_X, axis=-1)
        + beta_g * beta_g * agg
    )
    rtwr = ayy - 2.0 * lin + quad
    p1 = p + 1
    sigma2 = rtwr / (float(n) - float(p1))
    var_k = sigma2 / schur
    ok = ~badA & (schur > 0) & (var_k > 0) & jnp.isfinite(var_k) & (rtwr > 0)
    beta = jnp.where(ok, beta_g, jnp.nan)
    se = jnp.where(ok, jnp.sqrt(jnp.where(ok, var_k, 1.0)), jnp.nan)
    if not with_ml:
        return beta, se, jnp.zeros_like(beta)
    k = cs.S64.shape[0]
    logdetV = (
        jnp.sum(jnp.log(v.astype(jnp.float32)), axis=-1).astype(f64)
        + (float(n) - float(k)) * jnp.log(v0)
    )
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * jnp.log(rtwr) + logdetV)
    ml = jnp.where(ok, ml, -_BAD)
    return beta, se, ml


def _lr_block(packed, cs: _LrConsts, sh: GridShared, n: int,
              model: str, with_ml: bool):
    """One SNP block: decode → genetic-model transform → project to the
    k-space → grid λ* → per-lane beta/se. Returns (lg, beta, se, ml, ssq)."""
    hp = jax.lax.Precision.HIGHEST
    f32 = jnp.float32
    G = _decode_transformed_centered(packed, n, model)  # (B, n)
    Gr = jnp.dot(G, cs.Uk, precision=hp)  # (B, k)
    gX = jnp.dot(G, cs.X, precision=hp)  # (B, p)
    gy = jnp.dot(G, cs.y, precision=hp)  # (B,)
    gg = jnp.sum(G * G, axis=-1)
    # complement corrections (raw − rotated), carried in f64
    f64 = jnp.float64
    cgX = gX.astype(f64) - jnp.dot(Gr, cs.Xr, precision=hp).astype(f64)
    cgy = gy.astype(f64) - jnp.dot(Gr, cs.yr, precision=hp).astype(f64)
    cgg = gg.astype(f64) - jnp.sum(Gr * Gr, axis=-1).astype(f64)
    # (B, G) grid pieces: ONE stacked ((2+p)B, k) @ (k, G) device matmul
    # (same fusion as core.reml.lmm_grid_scan_with) + rank-1 complement
    # corrections
    wT = sh.w32.T  # (k, G)
    lbdg = jnp.power(10.0, sh.grid_lg).astype(f32)
    w0g = (1.0 / (cs.ridge64.astype(f32) + lbdg))[None, :]  # (1, G)
    p = cs.Xr.shape[1]
    B = Gr.shape[0]
    E = jnp.concatenate(
        [Gr * Gr, Gr * cs.yr[None, :]]
        + [Gr * cs.Xr[None, :, j] for j in range(p)],
        axis=0,
    )
    A = jnp.dot(E, wT, precision=hp)  # ((2+p)B, G)
    agg = A[:B] + cgg.astype(f32)[:, None] * w0g
    agy = A[B:2 * B] + cgy.astype(f32)[:, None] * w0g
    axg = jnp.stack(
        [
            A[(2 + j) * B:(3 + j) * B] + cgX[:, j].astype(f32)[:, None] * w0g
            for j in range(p)
        ],
        axis=-1,
    )  # (B, G, p)
    lg_star = grid_argmin_schur(sh, agg, agy, axg, n)
    beta, se, ml = _final_stats_lr(
        cs, Gr, cgX, cgy, cgg, lg_star, n, with_ml
    )
    return lg_star, beta, se, ml, gg.astype(f64)


@partial(jax.jit, static_argnames=("n", "model", "with_ml"))
def _lr_scan_resident(pk, cs: _LrConsts, sh: GridShared, n: int,
                      model: str, with_ml: bool):
    """Whole-scan resident form: lax.scan over pre-blocked (nblk, B, K)
    packed rows, one dispatch, one stacked (5, nblk, B) fetch — the
    low-rank twin of models.lmm._lmm_scan_resident (per-block python
    dispatch costs ~ms of round-trips per block, which adds up at
    chromosome-scale m)."""

    def body(_, pkb):
        return None, _lr_block(pkb, cs, sh, n, model, with_ml)

    _, outs = jax.lax.scan(body, None, pk)
    return jnp.stack(outs)


@lru_cache(maxsize=8)
def _lr_scan_sharded(mesh, n: int, model: str, with_ml: bool):
    """SNP-sharded low-rank scan: shard_map over the mesh 'snp' axis —
    pk arrives with its per-block SNP axis sharded; the per-trait
    constants and grid pieces are replicated (the twin of
    models.lmm._lmm_scan_sharded for the `-lowrank` route)."""
    from jax.sharding import PartitionSpec as P

    def core(pk, cs, sh):
        def body(_, pkb):
            return None, _lr_block(pkb, cs, sh, n, model, with_ml)

        _, outs = jax.lax.scan(body, None, pk)
        return jnp.stack(outs)

    mapped = jax.shard_map(
        core,
        mesh=mesh,
        in_specs=(P(None, "snp", None), P(), P()),
        out_specs=P(None, None, "snp"),
    )
    return jax.jit(mapped)


def fastlmm_scan(
    pg: PackedGenotypes,
    lrb: LowRankBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    grid_points: int | None = None,
    model: str = "add",
    rot: RotatedLR | None = None,
    null: NullFit | None = None,
    mesh=None,
    _sh=None,  # precomputed grid-shared state (threaded through chunking)
    _cs=None,  # precomputed device constants incl. the (n, k) Uk upload
) -> tuple[ScanResult, NullFit]:
    """Low-rank exact LMM scan over all SNPs (FaST-LMM semantics).

    ``rot``/``null`` accept a precomputed rotation and null fit (the
    workflow computes both for the LMM->LM switch — avoids repeating the
    O(n k p) rotation + Brent null per trait, as lmm_scan's ``null=``
    does for the dense route)."""
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    if rot is None:
        rot = make_rotated_lr(lrb, y, covariates)
    if null is None:
        null, _, _ = fit_null_reml_lr(rot)
    # grid-shared state + device constants (incl. the (n, k) f32 Uk
    # upload) are per-trait, NOT per-chunk: build once and thread through
    # the chunked recursion below — recomputing per superblock re-ran the
    # host grid setup and re-transferred n*k*4 bytes every chunk
    if _sh is None:
        grid_lg = np.linspace(
            config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH, grid_points
        )
        _sh = _grid_shared_lr(rot, grid_lg)
    if _cs is None:
        _cs = _lr_consts(rot)._replace(Uk=jnp.asarray(lrb.U, jnp.float32))
    # lazy (windowed low-memory) or huge inputs: chunk through the
    # resident scan like every other route (nulls/rotation reused)
    superblock = min(1 << 20, getattr(pg, "max_resident_snps", 1 << 20))
    if pg.m > superblock:
        from janusx_tpu.utils.prefetch import prefetch_one_ahead

        sb = max((superblock // block) * block, block)
        spans = [(s0, min(s0 + sb, pg.m)) for s0 in range(0, pg.m, sb)]
        parts = []
        for sub in prefetch_one_ahead(
                spans, lambda se: pg.take_snps(np.arange(se[0], se[1]))):
            r, null = fastlmm_scan(sub, lrb, y, covariates, block=block,
                                   lmm2=lmm2, grid_points=grid_points,
                                   model=model, rot=rot, null=null, mesh=mesh,
                                   _sh=_sh, _cs=_cs)
            parts.append(r)
        return ScanResult.concat(parts), null
    if not hasattr(pg, "packed"):
        pg = pg.take_snps(np.arange(pg.m))
    sh = _sh
    cs = _cs
    n, m = pg.n, pg.m
    from janusx_tpu.parallel.mesh import mesh_step
    from janusx_tpu.utils import devcache

    block = mesh_step(min(block, m) if m else block, mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    if mesh is not None:
        cs_d, sh_d = devcache.replicate_tree((cs, sh), mesh)
        out = np.asarray(
            _lr_scan_sharded(mesh, n, model, lmm2)(pk, cs_d, sh_d)
        ).reshape(5, m_pad)
    else:
        out = np.asarray(
            _lr_scan_resident(pk, cs, sh, n, model, lmm2)
        ).reshape(5, m_pad)
    lbd = 10.0 ** out[0, :m]
    beta = out[1, :m]
    se = out[2, :m]
    ml = out[3, :m]
    ssq = out[4, :m]
    pwald = jstats.pwald_from_beta_se(beta, se)
    if lmm2:
        plrt = jstats.plrt_from_ml(ml, null.ml)
        beta, se, pwald, plrt = finalize_invalid(beta, se, pwald, ssq, plrt)
        res = ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald, plrt=plrt, lbd=lbd, ml=ml,
            extras={"lambda_null": null.lbd, "ml_null": null.ml,
                    "rank": lrb.k},
        )
    else:
        beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq)
        res = ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald, extras={"lambda_null": null.lbd, "rank": lrb.k},
        )
    return res, null
