"""Spectral-scale REML/ML machinery, batched over SNPs.

Re-derivation of the reference objectives
(/root/reference/src/stats/reml.rs: reml_loglike :255, ml_loglike :364,
final_beta_se :472, lmm_reml_null_f32 :572) in a batched device form:
instead of a per-SNP scalar loop, a whole SNP block evaluates one λ step
together.

For eigenvalues s, rotated design Xr (n, p) (intercept included), rotated
phenotype yr and rotated SNP rows Gr (B, n), each λ evaluation needs only
weighted sums over the sample axis with weights w = 1/(s + λ_b). All
contractions are expressed as (B, n) @ (n, k) matmuls:

    A_XX = w @ (X⊗X),  a_Xy = w @ (X*y),  a_yy = w @ y²      (shared pairs)
    a_Xg = (w*g) @ X,  a_gy = (w*g) @ y,  a_gg = Σ w g²      (per-SNP pairs)

followed by batched (p+1)x(p+1) Cholesky solves on device.

Objectives (profiled σ², exact match to the reference):
    REML = c_r - ½[(n-p')·ln(r'Wr) + ln|V| + ln|X'WX + ridge·I|]
    ML   = c_m - ½[ n    ·ln(r'Wr) + ln|V|]
with r'Wr = a_yy - 2β'b + β'A₀β, β from the ridged Gram (ridge 1e-6),
A₀ the unridged Gram, c_r = (n-p')(ln(n-p')-1-ln2π)/2, c_m analogous.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core.spectral import SpectralBasis
from janusx_tpu.ops.brent import brent_minimize_batched

_BAD = 1e8  # reference sentinel: invalid loglik = -1e8


class RotatedData(NamedTuple):
    """Device-resident rotated quantities (float64).

    NOTE: `yr` is the rotation of y AFTER an exact f64 OLS
    residualization onto span(X) (see make_rotated). All variance
    components, λ, REML/ML values, and per-SNP beta/se/p are unchanged
    by that reparameterization, but the null-model fixed-effect
    coefficients fitted against `yr` are ~0 by construction — do not
    use them to reconstruct fitted values or intercepts."""

    s: jax.Array  # (n,)
    Xr: jax.Array  # (n, p)
    yr: jax.Array  # (n,)
    PXX: jax.Array  # (n, p*p) pairwise X products
    PXy: jax.Array  # (n, p)
    Pyy: jax.Array  # (n,)

    @property
    def n(self) -> int:
        return self.s.shape[0]

    @property
    def p(self) -> int:
        return self.Xr.shape[1]


def make_rotated(
    basis: SpectralBasis, y: np.ndarray, X_cov: np.ndarray | None
) -> RotatedData:
    """Rotate y and the design (intercept prepended) into the eigenbasis.

    Mirrors LMM.from_spectral (reference python/janusx/pyBLUP/assoc.py:1702):
    X_design = [1, X_cov].
    """
    n = basis.n
    ones = np.ones((n, 1), dtype=np.float64)
    X = ones if X_cov is None else np.concatenate([ones, np.asarray(X_cov, np.float64)], axis=1)
    y = np.asarray(y, np.float64).reshape(-1)
    # Exact reparameterization: subtract the (f64) OLS projection of y
    # onto span(X) BEFORE rotating. REML is the likelihood of error
    # contrasts and GLS SNP effects are translation-invariant in span(X),
    # so every reported statistic (λ, vg/ve, REML/ML values, per-SNP
    # beta/se/p, LRTs) is mathematically unchanged — but the downstream
    # f32 G-side grams (fused decode+rotate scans) no longer lose
    # precision to a large phenotype mean. Without this, a constant
    # offset of ~10σ on y corrupted -log10 p by >1 unit (fuzz-found;
    # tests/test_metamorphic.py::test_phenotype_affine_equivariance).
    c, *_ = np.linalg.lstsq(X, y, rcond=None)
    y = y - X @ c
    Xr = basis.U.T @ X
    yr = basis.U.T @ y
    PXX = (Xr[:, :, None] * Xr[:, None, :]).reshape(n, -1)
    PXy = Xr * yr[:, None]
    Pyy = yr * yr
    return RotatedData(
        s=jnp.asarray(basis.S, jnp.float64),
        Xr=jnp.asarray(Xr, jnp.float64),
        yr=jnp.asarray(yr, jnp.float64),
        PXX=jnp.asarray(PXX, jnp.float64),
        PXy=jnp.asarray(PXy, jnp.float64),
        Pyy=jnp.asarray(Pyy, jnp.float64),
    )


def _chol_pieces(M_ridged: jax.Array, rhs: jax.Array):
    """Batched Cholesky solve + logdet + (A^-1)_kk of the last index.

    M_ridged: (B, q, q); rhs: (B, q). Returns (beta, logdet, inv_kk, bad).
    """
    L = jnp.linalg.cholesky(M_ridged)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    bad = jnp.any(~jnp.isfinite(diag) | (diag <= 0), axis=-1)
    Ls = jnp.where(bad[:, None, None], jnp.eye(L.shape[-1], dtype=L.dtype), L)
    z = jax.lax.linalg.triangular_solve(
        Ls, rhs[..., None], left_side=True, lower=True, transpose_a=False
    )
    beta = jax.lax.linalg.triangular_solve(
        Ls, z, left_side=True, lower=True, transpose_a=True
    )[..., 0]
    logdet = 2.0 * jnp.sum(jnp.log(jnp.where(bad[:, None], 1.0, diag)), axis=-1)
    # (A^-1)_kk for the last coordinate: || L^-1 e_k ||^2
    q = L.shape[-1]
    ek = jnp.zeros((q,), L.dtype).at[q - 1].set(1.0)
    ek = jnp.broadcast_to(ek, rhs.shape)
    zk = jax.lax.linalg.triangular_solve(
        Ls, ek[..., None], left_side=True, lower=True, transpose_a=False
    )[..., 0]
    inv_kk = jnp.sum(zk * zk, axis=-1)
    return beta, logdet, inv_kk, bad


def _snp_grams(log10_lbd: jax.Array, rot: RotatedData, Gr: jax.Array):
    """Weighted Gram pieces for the per-SNP design [X, g].

    log10_lbd: (B,), Gr: (B, n) float64. Returns dict of batched pieces.
    """
    p = rot.p
    lbd = jnp.power(10.0, log10_lbd)
    v = rot.s[None, :] + lbd[:, None]  # (B, n)
    valid = jnp.all(v > 0, axis=-1) & jnp.isfinite(lbd) & (lbd > 0)
    vsafe = jnp.where(v > 0, v, 1.0)
    w = 1.0 / vsafe
    logdetV = jnp.sum(jnp.log(vsafe), axis=-1)
    hp = jax.lax.Precision.HIGHEST
    Axx = jnp.dot(w, rot.PXX, precision=hp).reshape(-1, p, p)
    axy = jnp.dot(w, rot.PXy, precision=hp)
    ayy = jnp.dot(w, rot.Pyy, precision=hp)
    wg = w * Gr
    axg = jnp.dot(wg, rot.Xr, precision=hp)
    agy = jnp.dot(wg, rot.yr, precision=hp)
    agg = jnp.sum(wg * Gr, axis=-1)
    top = jnp.concatenate([Axx, axg[:, :, None]], axis=2)  # (B, p, p+1)
    bot = jnp.concatenate([axg, agg[:, None]], axis=1)[:, None, :]
    M = jnp.concatenate([top, bot], axis=1)  # (B, p+1, p+1)
    rhs = jnp.concatenate([axy, agy[:, None]], axis=1)
    return M, rhs, ayy, logdetV, valid


def _quad_rtwr(M: jax.Array, rhs: jax.Array, ayy: jax.Array, beta: jax.Array):
    return (
        ayy
        - 2.0 * jnp.sum(beta * rhs, axis=-1)
        + jnp.einsum("bi,bij,bj->b", beta, M, beta,
                     precision=jax.lax.Precision.HIGHEST)
    )


def neg_reml_snp_batch(log10_lbd: jax.Array, rot: RotatedData, Gr: jax.Array):
    """-REML(log10 λ) per SNP lane; invalid lanes return +1e8."""
    n, p = rot.n, rot.p
    p1 = p + 1
    M, rhs, ayy, logdetV, valid = _snp_grams(log10_lbd, rot, Gr)
    Mr = M + config.GRAM_RIDGE * jnp.eye(p1, dtype=M.dtype)
    beta, logdetA, _, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf, pf = float(n), float(p1)
    c = (nf - pf) * (math.log(nf - pf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    total = (nf - pf) * jnp.log(rtwr) + logdetV + logdetA
    reml = c - 0.5 * total
    ok = valid & ~badchol & jnp.isfinite(reml) & (rtwr > 0)
    return jnp.where(ok, -reml, _BAD)


def ml_snp_batch(log10_lbd: jax.Array, rot: RotatedData, Gr: jax.Array):
    """ML loglik per SNP lane (for LMM2 LRT); invalid lanes -> -1e8."""
    n = rot.n
    M, rhs, ayy, logdetV, valid = _snp_grams(log10_lbd, rot, Gr)
    p1 = M.shape[-1]
    Mr = M + config.GRAM_RIDGE * jnp.eye(p1, dtype=M.dtype)
    beta, _, _, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * jnp.log(rtwr) + logdetV)
    ok = valid & ~badchol & jnp.isfinite(ml) & (rtwr > 0)
    return jnp.where(ok, ml, -_BAD)


def beta_se_snp_batch(log10_lbd: jax.Array, rot: RotatedData, Gr: jax.Array):
    """Final (beta, se) of the SNP term at the per-lane optimum λ.

    Mirrors final_beta_se (reference src/stats/reml.rs:472): σ² from the
    profiled quadratic with dof n-p', var(β_k) = σ² (A_ridged^{-1})_kk.
    """
    n, p = rot.n, rot.p
    p1 = p + 1
    M, rhs, ayy, logdetV, valid = _snp_grams(log10_lbd, rot, Gr)
    Mr = M + config.GRAM_RIDGE * jnp.eye(p1, dtype=M.dtype)
    beta, _, inv_kk, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    sigma2 = rtwr / (float(n) - float(p1))
    var_k = sigma2 * inv_kk
    ok = valid & ~badchol & (var_k > 0) & jnp.isfinite(var_k)
    b = jnp.where(ok, beta[:, -1], jnp.nan)
    se = jnp.where(ok, jnp.sqrt(jnp.where(ok, var_k, 1.0)), jnp.nan)
    return b, se


# ------------------------------------------------------- grid scan (shared λ grid)
class GridShared(NamedTuple):
    """λ-grid quantities independent of the SNP block (computed once per
    scan and reused by every block — they carry all the f64 transcendental
    work on the (G, n) lattice)."""

    grid_lg: jax.Array  # (G,)
    w32: jax.Array  # (G, n) f32 weights
    logdetV32: jax.Array  # (G,) f32
    Axx32: jax.Array  # (G, p, p) f32
    axy32: jax.Array  # (G, p)
    ayy32: jax.Array  # (G,)
    Ar_inv32: jax.Array  # (G, p, p)
    Ainv_axy32: jax.Array  # (G, p)
    logdetAr32: jax.Array  # (G,)


def grid_shared(rot: RotatedData, grid_lg: jax.Array) -> GridShared:
    p = rot.p
    G = grid_lg.shape[0]
    lbd = jnp.power(10.0, grid_lg)
    v = rot.s[None, :] + lbd[:, None]  # (G, n) f64
    w64 = 1.0 / v
    logdetV = jnp.sum(jnp.log(v), axis=-1)
    hp = jax.lax.Precision.HIGHEST
    Axx = jnp.dot(w64, rot.PXX, precision=hp).reshape(G, p, p)
    axy = jnp.dot(w64, rot.PXy, precision=hp)
    ayy = jnp.dot(w64, rot.Pyy, precision=hp)
    Ar = Axx + config.GRAM_RIDGE * jnp.eye(p, dtype=Axx.dtype)
    L = jnp.linalg.cholesky(Ar)
    logdetAr = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    eyeP = jnp.broadcast_to(jnp.eye(p, dtype=Ar.dtype), Ar.shape)
    Zi = jax.lax.linalg.triangular_solve(
        L, eyeP, left_side=True, lower=True, transpose_a=False
    )
    Ar_inv = jax.lax.linalg.triangular_solve(
        L, Zi, left_side=True, lower=True, transpose_a=True
    )
    Ainv_axy = jnp.einsum("gpq,gq->gp", Ar_inv, axy, precision=hp)
    f32 = jnp.float32
    return GridShared(
        grid_lg=grid_lg,
        w32=w64.astype(f32),
        logdetV32=logdetV.astype(f32),
        Axx32=Axx.astype(f32),
        axy32=axy.astype(f32),
        ayy32=ayy.astype(f32),
        Ar_inv32=Ar_inv.astype(f32),
        Ainv_axy32=Ainv_axy.astype(f32),
        logdetAr32=logdetAr.astype(f32),
    )


def grid_argmin_schur(sh: GridShared, agg, agy, axg, n: int):
    """λ*-selection from per-SNP (B, G) grid pieces + shared pieces.

    Shared by the full-rank resident scan and the FaST-LMM low-rank scan
    (models/fastlmm.py), which differ only in how agg/agy/axg and the
    shared grams are produced. Schur-complement closed form on the ridged
    covariate Gram -> profiled REML per (SNP, λ) cell -> argmin + 3-point
    parabolic refinement. Returns lg_star (B,)."""
    grid_lg = sh.grid_lg
    G = grid_lg.shape[0]
    p = axg.shape[-1]
    f32 = jnp.float32
    ein = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    ridge32 = jnp.asarray(config.GRAM_RIDGE, f32)
    u = ein("gpq,bgq->bgp", sh.Ar_inv32, axg)
    schur = (agg + ridge32) - ein("bgp,bgp->bg", axg, u)
    beta_g = (agy - ein("bgp,gp->bg", axg, sh.Ainv_axy32)) / schur
    beta_X = sh.Ainv_axy32[None] - beta_g[..., None] * u
    bX_axy = ein("bgp,gp->bg", beta_X, sh.axy32)
    lin = bX_axy + beta_g * agy
    quad = (
        ein("bgp,gpq,bgq->bg", beta_X, sh.Axx32, beta_X)
        + 2.0 * beta_g * ein("bgp,bgp->bg", axg, beta_X)
        + beta_g * beta_g * agg
    )
    rtwr = sh.ayy32[None] - 2.0 * lin + quad
    p1 = p + 1
    nf, pf = float(n), float(p1)
    logdetMr32 = sh.logdetAr32[None] + jnp.log(schur)
    neg_reml = 0.5 * (
        jnp.asarray(nf - pf, f32) * jnp.log(rtwr)
        + sh.logdetV32[None]
        + logdetMr32
    )
    bad = ~jnp.isfinite(neg_reml) | (rtwr <= 0) | (schur <= 0)
    neg_reml = jnp.where(bad, jnp.asarray(jnp.inf, f32), neg_reml)
    return argmin_parabolic(neg_reml, grid_lg)


def argmin_parabolic(neg_reml: jax.Array, grid_lg: jax.Array):
    """Per-row argmin over the λ grid + 3-point parabolic refinement.

    neg_reml: (B, G) objective lattice (inf on invalid cells) from the
    closed form in grid_argmin_schur."""
    G = neg_reml.shape[-1]
    idx = jnp.argmin(neg_reml, axis=-1)
    i0 = jnp.clip(idx, 1, G - 2)
    fm = jnp.take_along_axis(neg_reml, (i0 - 1)[:, None], axis=1)[:, 0]
    f0 = jnp.take_along_axis(neg_reml, i0[:, None], axis=1)[:, 0]
    fp = jnp.take_along_axis(neg_reml, (i0 + 1)[:, None], axis=1)[:, 0]
    h = grid_lg[1] - grid_lg[0]
    denom = fm - 2.0 * f0 + fp
    shift = jnp.where(
        jnp.isfinite(denom) & (denom > 0),
        0.5 * (fm - fp) / jnp.where(denom == 0, 1.0, denom),
        0.0,
    )
    shift = jnp.clip(shift, -1.0, 1.0)
    lg_star = grid_lg[i0] + shift.astype(grid_lg.dtype) * h
    lg_star = jnp.where((idx == 0) | (idx == G - 1), grid_lg[idx], lg_star)
    return lg_star


def lmm_grid_scan_with(sh: GridShared, rot: RotatedData, Gr: jax.Array):
    """Per-block grid scan against precomputed shared pieces.

    The 2+p per-SNP grid pieces (agg, agy, axg_k) share the same (n, G)
    weight operand, so they run as ONE ((2+p)B, n) @ (n, G) matmul
    instead of 2+p separate launches (one wide product, one weight read).
    The named scopes are what a profiler trace of the scan is reduced by.
    """
    n, p = rot.n, rot.p
    hp = jax.lax.Precision.HIGHEST
    f32 = jnp.float32
    Gr32 = Gr.astype(f32)
    yr32 = rot.yr.astype(f32)
    Xr32 = rot.Xr.astype(f32)
    wT = sh.w32.T  # (n, G)
    B = Gr32.shape[0]
    with jax.named_scope("lattice_operand"):
        E = jnp.concatenate(
            [Gr32 * Gr32, Gr32 * yr32[None, :]]
            + [Gr32 * Xr32[None, :, k] for k in range(p)],
            axis=0,
        )
    with jax.named_scope("lattice_grams"):
        A = jnp.dot(E, wT, precision=hp)  # ((2+p)B, G)
    agg = A[:B]
    agy = A[B:2 * B]
    axg = jnp.stack(
        [A[(2 + k) * B:(3 + k) * B] for k in range(p)], axis=-1
    )
    with jax.named_scope("lattice_schur"):
        return grid_argmin_schur(sh, agg, agy, axg, n)


def lmm_grid_scan(rot: RotatedData, Gr: jax.Array, grid_lg: jax.Array):
    """Per-SNP REML λ optimization over a SHARED fine log10-λ grid.

    Thin composition of grid_shared + lmm_grid_scan_with (the fused
    stacked-matmul form), so the Schur closed form lives in one place.
    Returns lg_star (B,) float64."""
    return lmm_grid_scan_with(grid_shared(rot, grid_lg), rot, Gr)

def final_grams_f32(rot: RotatedData, Gr32: jax.Array, log10_lbd: jax.Array,
                    with_ml: bool):
    """f32 gram pieces at per-lane λ* — the PER-BLOCK half of the
    final-stats pass. Returns (A1 (B, p^2+p+1), A2 (B, p+1), agg (B,)
    [, logdetV (B,)]) all f32; the f64 Schur epilogue runs ONCE over the
    whole scan (final_stats_from_grams), which keeps f64 work out of the
    block loop. Whether that split pays on the H100, whose f64 rate is
    native, is not measured."""
    p = rot.p
    f32 = jnp.float32
    hp = jax.lax.Precision.HIGHEST
    s32 = rot.s.astype(f32)
    lbd32 = jnp.power(10.0, log10_lbd).astype(f32)
    v = s32[None, :] + lbd32[:, None]  # (B, n) f32
    w = 1.0 / v
    Gw = Gr32 * w
    # the shared-side grams stack into ONE (B, n) @ (n, p^2+p+1) matmul
    # and the SNP-side pair into ONE (B, n) @ (n, p+1): two thin products
    # instead of five launches
    P1 = jnp.concatenate(
        [rot.PXX.astype(f32), rot.PXy.astype(f32),
         rot.Pyy.astype(f32)[:, None]], axis=1,
    )  # (n, p*p + p + 1) — loop-invariant: hoisted out of the block scan
    P2 = jnp.concatenate(
        [rot.Xr.astype(f32), rot.yr.astype(f32)[:, None]], axis=1
    )  # (n, p + 1)
    A1 = jnp.dot(w, P1, precision=hp)
    A2 = jnp.dot(Gw, P2, precision=hp)
    agg = jnp.sum(Gw * Gr32, axis=-1)
    if not with_ml:
        return A1, A2, agg, jnp.zeros_like(agg)
    logdetV = jnp.sum(jnp.log(v), axis=-1)
    return A1, A2, agg, logdetV


def final_stats_from_grams(n: int, p: int, A1, A2, agg64, with_ml: bool,
                           logdetV=None):
    """f64 Schur epilogue over the WHOLE scan's stacked (N, ...) grams."""
    A1 = A1.astype(jnp.float64)
    A2 = A2.astype(jnp.float64)
    Axx = A1[..., : p * p].reshape(-1, p, p)
    axy = A1[..., p * p: p * p + p]
    ayy = A1[..., p * p + p]
    axg = A2[..., :p]
    agy = A2[..., p]
    agg = agg64.astype(jnp.float64)

    ridge = config.GRAM_RIDGE
    if p == 1:
        # intercept-only design (the common case): the 1x1 "Cholesky
        # solve" is a scalar division — skip the batched linalg custom
        # calls entirely
        Ar1 = Axx[..., 0, 0] + ridge
        badA = ~jnp.isfinite(Ar1) | (Ar1 <= 0)
        Ars = jnp.where(badA, 1.0, Ar1)
        u = (axg[..., 0] / Ars)[..., None]
        Ainv_axy = (axy[..., 0] / Ars)[..., None]
    else:
        Ar = Axx + ridge * jnp.eye(p, dtype=jnp.float64)
        L = jnp.linalg.cholesky(Ar)
        diag = jnp.diagonal(L, axis1=-2, axis2=-1)
        badA = jnp.any(~jnp.isfinite(diag) | (diag <= 0), axis=-1)
        Ls = jnp.where(badA[:, None, None], jnp.eye(p, dtype=jnp.float64), L)

        def chosolve(b):
            z = jax.lax.linalg.triangular_solve(
                Ls, b[..., None], left_side=True, lower=True,
                transpose_a=False
            )
            return jax.lax.linalg.triangular_solve(
                Ls, z, left_side=True, lower=True, transpose_a=True
            )[..., 0]

        u = chosolve(axg)  # (B, p) = Ar^-1 axg
        Ainv_axy = chosolve(axy)
    schur = (agg + ridge) - jnp.sum(axg * u, axis=-1)
    beta_g = (agy - jnp.sum(axg * Ainv_axy, axis=-1)) / schur
    beta_X = Ainv_axy - beta_g[:, None] * u
    lin = jnp.sum(beta_X * axy, axis=-1) + beta_g * agy
    quad = (
        jnp.einsum("bp,bpq,bq->b", beta_X, Axx, beta_X,
                   precision=jax.lax.Precision.HIGHEST)
        + 2.0 * beta_g * jnp.sum(axg * beta_X, axis=-1)
        + beta_g * beta_g * agg
    )
    rtwr = ayy - 2.0 * lin + quad
    p1 = p + 1
    sigma2 = rtwr / (float(n) - float(p1))
    var_k = sigma2 / schur  # (Mr^-1)_kk = 1/schur for the last coordinate
    ok = ~badA & (schur > 0) & (var_k > 0) & jnp.isfinite(var_k) & (rtwr > 0)
    beta = jnp.where(ok, beta_g, jnp.nan)
    se = jnp.where(ok, jnp.sqrt(jnp.where(ok, var_k, 1.0)), jnp.nan)
    if not with_ml:
        return beta, se, jnp.zeros_like(beta)
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * jnp.log(rtwr) + logdetV.astype(jnp.float64))
    ml = jnp.where(ok, ml, -_BAD)
    return beta, se, ml


def final_stats_f32(
    sh_rot: RotatedData, Gr32: jax.Array, log10_lbd: jax.Array, with_ml: bool
):
    """Final (beta, se[, ml]) at per-lane λ* with f32 grams.

    Composition of final_grams_f32 + final_stats_from_grams for callers
    outside the resident scan (the scan itself splits them: grams per
    block, ONE f64 epilogue over the whole scan). Gram rounding (~1e-7
    relative) perturbs beta/se by ~1e-6 — far inside the λ-search
    tolerance."""
    rot = sh_rot
    A1, A2, agg, logdetV = final_grams_f32(rot, Gr32, log10_lbd, with_ml)
    return final_stats_from_grams(rot.n, rot.p, A1, A2, agg, with_ml,
                                  logdetV)


# --------------------------------------------------------------- null model
def _null_grams(log10_lbd: jax.Array, rot: RotatedData):
    p = rot.p
    lbd = jnp.power(10.0, log10_lbd)
    v = rot.s[None, :] + lbd[:, None]
    valid = jnp.all(v > 0, axis=-1) & jnp.isfinite(lbd) & (lbd > 0)
    vsafe = jnp.where(v > 0, v, 1.0)
    w = 1.0 / vsafe
    logdetV = jnp.sum(jnp.log(vsafe), axis=-1)
    hp = jax.lax.Precision.HIGHEST
    M = jnp.dot(w, rot.PXX, precision=hp).reshape(-1, p, p)
    rhs = jnp.dot(w, rot.PXy, precision=hp)
    ayy = jnp.dot(w, rot.Pyy, precision=hp)
    return M, rhs, ayy, logdetV, valid


def neg_reml_null(log10_lbd: jax.Array, rot: RotatedData):
    n, p = rot.n, rot.p
    M, rhs, ayy, logdetV, valid = _null_grams(log10_lbd, rot)
    Mr = M + config.GRAM_RIDGE * jnp.eye(p, dtype=M.dtype)
    beta, logdetA, _, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf, pf = float(n), float(p)
    c = (nf - pf) * (math.log(nf - pf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    reml = c - 0.5 * ((nf - pf) * jnp.log(rtwr) + logdetV + logdetA)
    ok = valid & ~badchol & jnp.isfinite(reml) & (rtwr > 0)
    return jnp.where(ok, -reml, _BAD)


def ml_null(log10_lbd: jax.Array, rot: RotatedData):
    n = rot.n
    M, rhs, ayy, logdetV, valid = _null_grams(log10_lbd, rot)
    p = M.shape[-1]
    Mr = M + config.GRAM_RIDGE * jnp.eye(p, dtype=M.dtype)
    beta, _, _, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * jnp.log(rtwr) + logdetV)
    ok = valid & ~badchol & jnp.isfinite(ml) & (rtwr > 0)
    return jnp.where(ok, ml, -_BAD)


def null_fit_stats(rot: RotatedData, log10_lbd: float):
    """(beta, sigma2) of the null (covariates-only) model at a given λ.

    sigma2 is the profiled REML variance rtWr/(n-p) — the genetic variance
    vg in the V = vg(K + λI) parameterization (ve = λ·vg), as used by the
    reference GBLUP fit (src/stats/gblup.rs doc).

    beta is fitted against the span(X)-residualized `rot.yr` (see
    RotatedData) and is therefore ~0; it is returned only for shape
    compatibility — sigma2 (a residual quadratic form, invariant to the
    residualization) is the meaningful output."""
    lg = jnp.asarray([log10_lbd], jnp.float64)
    M, rhs, ayy, logdetV, valid = _null_grams(lg, rot)
    p = M.shape[-1]
    Mr = M + config.GRAM_RIDGE * jnp.eye(p, dtype=M.dtype)
    beta, _, _, badchol = _chol_pieces(Mr, rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    sigma2 = rtwr[0] / (rot.n - p)
    return np.asarray(beta[0], np.float64), float(sigma2)


class NullFit(NamedTuple):
    lbd: float  # λ at the REML optimum
    log10_lbd: float
    reml: float
    ml: float  # ML loglik evaluated at the REML-optimal λ


@partial(jax.jit, static_argnames=("low", "high", "tol", "max_iter"))
def _null_fit_device(rot: RotatedData, low: float, high: float, tol: float, max_iter: int):
    f = lambda x: neg_reml_null(x, rot)
    x, fx = brent_minimize_batched(f, low, high, tol, max_iter, batch_shape=(1,))
    ml = ml_null(x, rot)
    return x[0], -fx[0], ml[0]


def fit_null_reml(
    rot: RotatedData,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = config.NULL_BRENT_TOL,
    max_iter: int = config.NULL_BRENT_MAX_ITER,
) -> NullFit:
    """Null REML fit via Brent over log10 λ — reference lmm_reml_null_f32
    (src/stats/reml.rs:572; returns (λ, ml, reml))."""
    x, reml, ml = _null_fit_device(rot, low, high, tol, max_iter)
    x = float(x)
    return NullFit(lbd=10.0 ** x, log10_lbd=x, reml=float(reml), ml=float(ml))


def fit_null_reml_host(
    S: np.ndarray,
    Xr: np.ndarray,
    yr: np.ndarray,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = config.NULL_BRENT_TOL,
    max_iter: int = config.NULL_BRENT_MAX_ITER,
):
    """Host (numpy/LAPACK) twin of fit_null_reml — same objective, scipy
    bounded-Brent over log10 λ. Returns (NullFit, beta, vg).

    For small-n covariates-only fits (GS per-fold GBLUP, LMM->LM switch
    tests) the device path pays one XLA compile per distinct sample count
    plus dispatch round-trips, while the host evaluation is microseconds.
    Which is faster on the H100 is not measured. Objective mirrors neg_reml_null/ml_null exactly (reference
    src/stats/reml.rs:255,364,572)."""
    import scipy.linalg as sla
    from scipy.optimize import minimize_scalar

    S = np.asarray(S, np.float64).reshape(-1)
    Xr = np.asarray(Xr, np.float64)
    yr = np.asarray(yr, np.float64).reshape(-1)
    n, p = Xr.shape
    ridge = config.GRAM_RIDGE * np.eye(p)

    def pieces(lg: float):
        lbd = 10.0 ** lg
        v = S + lbd
        if not np.all(v > 0):
            return None
        w = 1.0 / v
        Xw = Xr * w[:, None]
        M = Xw.T @ Xr
        rhs = Xw.T @ yr
        ayy = float((w * yr) @ yr)
        try:
            L = sla.cholesky(M + ridge, lower=True)
        except sla.LinAlgError:
            return None
        beta = sla.cho_solve((L, True), rhs)
        logdetA = 2.0 * float(np.sum(np.log(np.diag(L))))
        rtwr = float(ayy - 2.0 * beta @ rhs + beta @ (M @ beta))
        logdetV = float(np.sum(np.log(v)))
        return beta, rtwr, logdetV, logdetA

    def neg_reml(lg: float) -> float:
        pc = pieces(float(lg))
        if pc is None:
            return _BAD
        _, rtwr, logdetV, logdetA = pc
        if not np.isfinite(rtwr) or rtwr <= 0:
            return _BAD
        c = (n - p) * (math.log(n - p) - 1.0 - math.log(2.0 * math.pi)) / 2.0
        return -(c - 0.5 * ((n - p) * math.log(rtwr) + logdetV + logdetA))

    res = minimize_scalar(
        neg_reml, bounds=(low, high), method="bounded",
        options={"xatol": tol, "maxiter": max_iter},
    )
    lg = float(res.x)
    out = pieces(lg)
    if out is None or not np.isfinite(out[1]) or out[1] <= 0.0:
        # degenerate phenotype (e.g. all-zero/constant y) or a V that is
        # never PD over the search range: degrade to NaN like the device
        # twin instead of crashing (callers treat NaN ml/reml as "no
        # mixed-model evidence" — the LMM->LM switch then picks LM)
        fit = NullFit(lbd=10.0 ** lg, log10_lbd=lg, reml=float("nan"),
                      ml=float("nan"))
        return fit, np.zeros(p), float("nan")
    beta, rtwr, logdetV, _ = out
    cm = n * (math.log(n) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = cm - 0.5 * (n * math.log(rtwr) + logdetV)
    fit = NullFit(
        lbd=10.0 ** lg, log10_lbd=lg, reml=float(-neg_reml(lg)), ml=float(ml)
    )
    return fit, np.asarray(beta, np.float64), float(rtwr / (n - p))
