"""G×E / G×C interaction scans (the reference's hidden ``-lm2`` and
``-fvlmm2`` routes — src/stats/glm2.rs per-SNP interaction covariates,
fvlmm2.rs joint rotated variant).

Model per SNP:  y = X b + g βg + (g ∘ c) βi + e   (c = interaction covariate)

Reported per SNP: βi, se(βi), pwald = two-sided t test of the interaction
term, plrt = joint 2-df test of (βg, βi) (chi2). ``fvlmm2`` runs the same
design on the rotated scale with the null-model λ fixed (weighted case).

Device mapping: both regressors are residualized against X by closed
form, so the whole scan is four (B, n) x (n, k) matmuls per block plus
2x2 solves vectorized over SNPs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core.reml import NullFit, fit_null_reml, make_rotated
from janusx_tpu.core.spectral import SpectralBasis
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.lm import design_matrix, student_t_p_two_sided
from janusx_tpu.models.scan_common import ScanResult, iter_blocks, pad_rows
from janusx_tpu.ops import decode
from janusx_tpu.parallel.mesh import mesh_step


@partial(jax.jit, static_argnames=("n",))
def _gxe_block(packed, mean, X, Cinv, My, cvec, w, n: int):
    """Weighted residualized 2-regressor stats for one padded block.

    w: (n,) weights (ones for lm2; 1/(s+λ) for fvlmm2 — inputs already
    rotated in that case via U premultiplied into X/My/cvec path).
    Returns per-SNP Gram entries and rhs for [g, g*c].
    """
    hp = jax.lax.Precision.HIGHEST
    G = decode.decode_centered(packed, mean, dtype=jnp.float32)[:, :n].astype(
        jnp.float64
    )
    GC = G * cvec[None, :]
    Xw = X * w[:, None]

    def proj_stats(A, B):
        # A' M_X^w B per SNP where M = W - WX (X'WX)^-1 X'W
        AwB = jnp.sum(A * w[None, :] * B, axis=-1)
        AX = jnp.dot(A * w[None, :], X, precision=hp)
        BX = jnp.dot(B * w[None, :], X, precision=hp)
        return AwB - jnp.einsum("bp,pq,bq->b", AX, Cinv, BX)

    a11 = proj_stats(G, G)
    a12 = proj_stats(G, GC)
    a22 = proj_stats(GC, GC)
    b1 = jnp.dot(G, My, precision=hp)
    b2 = jnp.dot(GC, My, precision=hp)
    return a11, a12, a22, b1, b2


@partial(jax.jit, static_argnames=("n",))
def _gxe_block_mixed(packed, mean, X, Cinv, My, cvec, WhT, n: int):
    """fvlmm2 variant: G is pulled to the whitened scale via W^(1/2) = U w^(1/2) U'
    (decode yields original-space genotypes; the interaction product must be
    formed BEFORE whitening, so the weighted case cannot reuse _gxe_block)."""
    hp = jax.lax.Precision.HIGHEST
    G0 = decode.decode_centered(packed, mean, dtype=jnp.float32)[:, :n].astype(jnp.float64)
    GC0 = G0 * cvec[None, :]
    G = jnp.dot(G0, WhT, precision=hp)
    GC = jnp.dot(GC0, WhT, precision=hp)

    def proj(A, B):
        AwB = jnp.sum(A * B, axis=-1)
        AX = jnp.dot(A, X, precision=hp)
        BX = jnp.dot(B, X, precision=hp)
        return AwB - jnp.einsum("bp,pq,bq->b", AX, Cinv, BX)

    return (proj(G, G), proj(G, GC), proj(GC, GC),
            jnp.dot(G, My, precision=hp), jnp.dot(GC, My, precision=hp))


def _finalize_gxe(a11, a12, a22, b1, b2, yMy, n, p):
    """Reference-exact lm2 statistics from per-SNP projected Gram pieces
    (src/stats/glm2.rs lm2_fit_single_snp :165-311).

    Design per SNP: Z = [g, g*c]; Schur = Z' M_X Z (a11..a22), rhs e =
    Z' M_X y (b1, b2); beta = Schur^-1 e; rss = rss0 - e.beta;
    sigma2 = rss / df with df = n - (q_base + 1 + n_interactions)
    (glm2.rs:149-161: p = q_base + m, df = n - p — the FULL fitted
    design rank). Per-coefficient: se_k = sqrt(sigma2 * SchurInv_kk),
    t-test with df. Joint tests: interaction chisq = beta_i^2 /
    (SchurInv_11 sigma2) ~ chi2(1) (:294-297); full chisq = e.beta /
    sigma2 ~ chi2(2) (:306-310)."""
    from scipy import stats as sps

    det = a11 * a22 - a12 * a12
    ok = np.isfinite(det) & (det > 1e-12 * np.maximum(a11 * a22, 1e-300))
    det_s = np.where(ok, det, 1.0)
    # SchurInv = [[a22, -a12], [-a12, a11]] / det
    bg = (a22 * b1 - a12 * b2) / det_s
    bi = (a11 * b2 - a12 * b1) / det_s
    explained = bg * b1 + bi * b2
    rss = np.maximum(yMy - explained, 0.0)
    df = n - p - 2  # base rank + [g, g*c] (glm2.rs:150 p = q_base + m)
    sigma2 = rss / df
    with np.errstate(invalid="ignore", divide="ignore"):
        se_g = np.sqrt(np.maximum(sigma2 * a22 / det_s, 0))
        se_i = np.sqrt(np.maximum(sigma2 * a11 / det_s, 0))
        t_g = bg / se_g
        t_i = bi / se_i
    pw_g = student_t_p_two_sided(np.where(np.isfinite(t_g), t_g, 0.0), df)
    pw_i = student_t_p_two_sided(np.where(np.isfinite(t_i), t_i, 0.0), df)
    # joint interaction (K=1): chisq = bi^2 / (SchurInv_11 * sigma2)
    with np.errstate(invalid="ignore", divide="ignore"):
        chisq_int = np.where(
            ok & (sigma2 > 0), bi * bi * det_s / (a11 * sigma2), np.nan
        )
        chisq_joint = np.where(ok & (sigma2 > 0), explained / sigma2, np.nan)
    chisq_int = np.maximum(chisq_int, 0.0)
    chisq_joint = np.maximum(chisq_joint, 0.0)
    p_int = sps.chi2.sf(chisq_int, df=1)
    p_joint = sps.chi2.sf(chisq_joint, df=2)

    def clean(beta, se, pw):
        bad = ~ok | ~np.isfinite(beta) | ~np.isfinite(se) | (se <= 0)
        return (np.where(bad, np.nan, beta), np.where(bad, np.nan, se),
                np.where(bad, 1.0, np.clip(pw, np.finfo(float).tiny, 1.0)))

    bg, se_g, pw_g = clean(bg, se_g, pw_g)
    bi, se_i, pw_i = clean(bi, se_i, pw_i)
    p_int = np.where(np.isfinite(p_int), np.clip(p_int, np.finfo(float).tiny, 1.0), 1.0)
    p_joint = np.where(np.isfinite(p_joint), np.clip(p_joint, np.finfo(float).tiny, 1.0), 1.0)
    return (bg, se_g, pw_g, bi, se_i, pw_i,
            chisq_int, p_int, chisq_joint, p_joint)


def gxe_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    inter_cov: np.ndarray,
    covariates: np.ndarray | None = None,
    basis: SpectralBasis | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
) -> tuple[ScanResult, NullFit | None]:
    """Interaction scan. Plain OLS (lm2) when basis is None; fixed-λ mixed
    (fvlmm2) when an eigenbasis of the GRM subset is supplied. With a
    ``mesh`` the per-SNP block stats run SNP-sharded over its 'snp' axis
    (per-SNP work only — the shared design constants replicate)."""
    y = np.asarray(y, np.float64).reshape(-1)
    # interaction covariate stays RAW: the reference builds z = g * cv from
    # the covariate column as loaded (glm2.rs:216); centering it would shift
    # the reported SNP main effect by beta_i * mean(c)
    cvec = np.asarray(inter_cov, np.float64).reshape(-1)
    n = pg.n
    Xcov = (
        cvec[:, None]
        if covariates is None
        else np.concatenate([np.asarray(covariates, np.float64), cvec[:, None]], axis=1)
    )
    null = None
    if basis is None:
        X = design_matrix(n, Xcov)
        w = np.ones(n)
        y_use, X_use, c_use = y, X, cvec
    else:
        rot = make_rotated(basis, y, Xcov)
        null = fit_null_reml(rot)
        w = 1.0 / (basis.S + null.lbd)
        c_use = cvec  # the interaction product must be built in the ORIGINAL
        # space (decode gives g there), so the weighted case whitens with
        # W^(1/2) = U w^(1/2) U' instead of rotating first.
        Wh = (basis.U * np.sqrt(w)[None, :]) @ basis.U.T
        y_use = Wh @ y
        X_use = Wh @ design_matrix(n, Xcov)
        w = np.ones(n)

    p = X_use.shape[1]
    XtWX = X_use.T @ (X_use * w[:, None])
    Cinv = np.linalg.inv(XtWX + config.GRAM_RIDGE * np.eye(p))
    My = w * y_use - (w[:, None] * X_use) @ (Cinv @ (X_use.T @ (w * y_use)))
    yMy = float(y_use @ My)

    m = pg.m
    block = mesh_step(min(block, m), mesh)
    packed = decode.pad_packed_cols(pg.packed)
    Xd = jnp.asarray(X_use)
    Cd = jnp.asarray(Cinv)
    Myd = jnp.asarray(My)
    wd = jnp.asarray(w)
    # for the mixed case G itself must be transformed by Wh too: decode is
    # in original space, so pass Wh through cvec trick: we instead fold Wh
    # into the per-block step by rotating G via matmul with Wh^T.
    cd = jnp.asarray(c_use)
    a11 = np.empty(m); a12 = np.empty(m); a22 = np.empty(m)
    b1 = np.empty(m); b2 = np.empty(m)
    if basis is not None:
        WhT = jnp.asarray(Wh.T)

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        specs = dict(
            mesh=mesh, in_specs=(P("snp", None), P("snp")),
            out_specs=(P("snp"),) * 5,
        )
        if basis is None:
            blockfn = jax.jit(jax.shard_map(
                lambda pk, mn: _gxe_block.__wrapped__(
                    pk, mn, Xd, Cd, Myd, cd, wd, n), **specs))
        else:
            blockfn = jax.jit(jax.shard_map(
                lambda pk, mn: _gxe_block_mixed.__wrapped__(
                    pk, mn, Xd, Cd, Myd, cd, WhT, n), **specs))
    else:
        blockfn = None

    for s0, e0 in iter_blocks(m, block):
        pk = jnp.asarray(pad_rows(packed[s0:e0], block, 0xFF))
        mn = jnp.asarray(pad_rows(pg.mean[s0:e0].astype(np.float32), block))
        if blockfn is not None:
            r = blockfn(pk, mn)
        elif basis is None:
            r = _gxe_block(pk, mn, Xd, Cd, Myd, cd, wd, n)
        else:
            r = _gxe_block_mixed(pk, mn, Xd, Cd, Myd, cd, WhT, n)
        k = e0 - s0
        for arr, out in zip(r, (a11, a12, a22, b1, b2)):
            out[s0:e0] = np.asarray(arr)[:k]

    (bg, se_g, pw_g, bi, se_i, pw_i, chisq_int, p_int, chisq_joint,
     p_joint) = _finalize_gxe(a11, a12, a22, b1, b2, yMy, n, p)
    # reference lm2 column layout (glm2.rs lm2_header :58-67): base
    # columns carry the SNP main effect; interaction + joint tests follow
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=bg, se=se_g,
        pwald=pw_g,
        extra_cols={
            "beta_i1": bi, "se_i1": se_i, "pwald_i1": pw_i,
            "chisq_int_joint": chisq_int, "p_int_joint": p_int,
            "chisq_joint": chisq_joint, "p_joint": p_joint,
        },
        extras={"interaction": True, "lambda_null": None if null is None else null.lbd},
    )
    return res, null
