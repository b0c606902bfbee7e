"""SparseLMM: sparse-GRM mixed-model scans for biobank-scale n.

Reference: /root/reference/src/stats/spgrm.rs (thresholded sparse GRM),
splmm.rs (exact scan), splmm_approx.rs (GRAMMAR-gamma residualized scan),
spreml.rs (sparse REML null fits).

GRAMMAR-gamma (``-splmm``, the default approx route — splmm_approx.rs:1-18):
    M_X = I - X(X'X)^-1 X';  y~ = M_X y;  V_λ = K_sparse + λI
    λ from REML-style fit of y~ under V_λ;  a = V_λ^-1 y~
    γ = mean over sampled null markers (χ² < 5) of (g~'V^-1 g~)/(g~'g~)
    β ≈ (g~'a)/(γ g~'g~);  se ≈ 1/sqrt(γ g~'g~);  χ² = (g~'a)²/(γ g~'g~)

Device split: the sparse factorizations (SuperLU on CSC, the host-native
replacement for the reference's faer LLT) run on host — they are O(n)
with a sparse K — while the per-SNP scan is pure device matmuls (the same
residualized machinery as the LM scan: one pass over packed blocks).

Default sparse cutoff 0.05 (reference workflow.py:6701); negative cutoff
disables off-diagonal thresholding.
"""

from __future__ import annotations

from dataclasses import dataclass

from functools import partial

import jax
import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from janusx_tpu import config
from janusx_tpu.core import stats as jstats
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.lm import design_matrix
from janusx_tpu.models.scan_common import ScanResult, finalize_invalid, iter_blocks
from janusx_tpu.ops import decode
from janusx_tpu.parallel.mesh import mesh_step

import jax.numpy as jnp

DEFAULT_SPARSE_CUTOFF = 0.05
NULL_CHI2_CUTOFF = 5.0  # fastGWA-style null-marker filter
N_GAMMA_MARKERS = 500


@partial(jax.jit, static_argnames=("block", "n_rows"))
def _grm_rowband(packed, mean, inv_sd, row_lo: int, n_rows: int, block: int):
    """One row-band of the GRM: C[rows]^T-style partial — computed as
    (n_rows, n_pad) accumulation over SNP blocks without ever holding the
    dense (n, n) matrix (reference tiled builder, src/stats/spgrm.rs:33-45).
    """
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])
    mn = mean.reshape(nblk, block)
    iv = inv_sd.reshape(nblk, block)
    n_pad = packed.shape[1] * 4
    hp = jax.lax.Precision.HIGHEST

    def body(acc, xs):
        p, m, s = xs
        c = decode.decode_standardized(p, m, s, dtype=jnp.float32)  # (B, n_pad)
        rows = jax.lax.dynamic_slice(c, (0, row_lo), (c.shape[0], n_rows))
        acc = acc + jnp.dot(rows.T, c, precision=hp)
        return acc, None

    acc0 = jnp.zeros((n_rows, n_pad), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, (pk, mn, iv))
    return acc


def _rowband_accum(sub, method: int, lo: int, band: int, block: int):
    """One chunk's contribution to GRM rows [lo, lo+band): f64 (band, n_pad)."""
    from janusx_tpu.models.grm import _snp_scales
    from janusx_tpu.utils import devcache

    mean, inv_sd, _ = _snp_scales(sub, method)
    blk = min(block, sub.m)
    m_pad = -(-sub.m // blk) * blk
    pk = devcache.device_packed(sub, m_pad, lane_align=band)
    mn = devcache.to_device_padded_rows(
        mean.astype(np.float32), m_pad, 0.0, dtype=jnp.float32
    )
    iv = devcache.to_device_padded_rows(
        inv_sd.astype(np.float32), m_pad, 0.0, dtype=jnp.float32
    )
    return np.asarray(_grm_rowband(pk, mn, iv, lo, band, blk), np.float64)


def build_sparse_grm(
    pg,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    method: int = 1,
    row_band: int = 4096,
    block: int = config.DEFAULT_SNP_BLOCK,
) -> scipy.sparse.csr_matrix:
    """Thresholded sparse GRM built band-by-band — memory O(row_band x n)
    instead of O(n²), for biobank n (reference spgrm tile pipeline,
    src/stats/spgrm.rs:33-45).

    Accepts in-RAM PackedGenotypes or the disk-backed WindowedPacked: lazy
    inputs stream materialized windows per row-band, so neither the dense
    n² matrix nor the full packed matrix is ever resident.

    Diagonal entries always kept; off-diagonals kept when |K_ij| >= cutoff
    (negative cutoff keeps everything — then prefer the dense builder).
    """
    if method == 3:
        # _grm_rowband decodes standardized-additive only; the dominance
        # het-indicator decode lives in the dense builder. Fail loudly
        # instead of silently returning an additive matrix.
        raise ValueError("build_sparse_grm supports methods 1/2 "
                         "(dominance kinship: use the dense grm builder)")
    n = pg.n_samples
    m = pg.m
    lazy = not hasattr(pg, "packed")
    # denominator from the handle's per-SNP stats: methods 1/2 need only
    # af (held in RAM even for disk-backed inputs) — no materialize pass
    if method == 1:
        var = 2.0 * pg.af * (1.0 - pg.af)
        denom = float(var.sum())
    else:
        denom = float(m)
    if denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    block = min(block, m)
    # band must be a lane multiple AND divide n_pad so every row-band slice
    # is a full in-bounds dynamic_slice (pad lanes decode to zero)
    band = max(128, (min(row_band, n) // 128) * 128)
    parts = []
    for lo in range(0, n, band):
        if lazy:
            tile = None
            for _, _, sub in pg.iter_materialized():
                part = _rowband_accum(sub, method, lo, band, block)
                tile = part if tile is None else tile + part
        else:
            tile = _rowband_accum(pg, method, lo, band, block)
        tile = tile[: max(0, min(band, n - lo)), :n] / denom
        if cutoff >= 0:
            mask = np.abs(tile) >= cutoff
            rr = np.arange(lo, lo + tile.shape[0])
            mask[np.arange(tile.shape[0]), rr] = True  # keep diagonal
            tile = np.where(mask, tile, 0.0)
        parts.append(scipy.sparse.csr_matrix(tile))
    K = scipy.sparse.vstack(parts).tocsr()
    return K


def sparsify_grm(K: np.ndarray, cutoff: float = DEFAULT_SPARSE_CUTOFF):
    """Threshold off-diagonals (keep |K_ij| >= cutoff); diagonal always kept.

    Negative cutoff keeps everything (reference rule)."""
    K = np.asarray(K, np.float64)
    if cutoff < 0:
        return scipy.sparse.csc_matrix(K)
    mask = np.abs(K) >= cutoff
    np.fill_diagonal(mask, True)
    return scipy.sparse.csc_matrix(np.where(mask, K, 0.0))


class _SpectralFactor:
    """Drop-in ``.solve(b)`` handle for a fixed lambda over BlockSpectralK."""

    def __init__(self, bs, lbd: float):
        self.bs = bs
        self.lbd = lbd

    def solve(self, b: np.ndarray) -> np.ndarray:
        return self.bs.solve(self.lbd, b)


@dataclass
class SparseNullFit:
    lbd: float
    sigma2: float
    loglik: float
    factor: _SpectralFactor  # V_lambda^-1 apply (block-spectral)


def fit_sparse_null(
    Ks: scipy.sparse.spmatrix,
    ytilde: np.ndarray,
    n_eff: int,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = 1e-6,
    max_iter: int = 100,
    bs=None,
) -> SparseNullFit:
    """Profiled-variance null fit of the residualized phenotype over
    log10 λ.

    The reference pays one sparse LLT factorization per λ evaluation
    (spreml.rs golden search over cholesky.rs LLT); here the thresholded
    K is eigendecomposed ONCE per connected component (sparse_spectral),
    after which every λ evaluation is O(n) elementwise — and the returned
    factor solves V^-1 b with batched tiny matmuls at any λ for free."""
    from janusx_tpu.models.sparse_spectral import (
        BlockSpectralK, profiled_null_fit,
    )

    if bs is None:
        bs = BlockSpectralK.from_sparse(Ks)
    lbd, sigma2, loglik = profiled_null_fit(
        bs, ytilde, n_eff, low, high, tol=tol, max_iter=max_iter
    )
    return SparseNullFit(
        lbd=lbd, sigma2=sigma2, loglik=loglik, factor=_SpectralFactor(bs, lbd)
    )


def _coerce_sparse(K, cutoff: float) -> scipy.sparse.csc_matrix:
    """Accept a dense kinship (thresholded here) or an already-sparse one."""
    if scipy.sparse.issparse(K):
        return K.tocsc()
    return sparsify_grm(K, cutoff)


def _calibrate_gamma(pg, proj, null: SparseNullFit, a, seed: int):
    """GRAMMAR-gamma calibration on sampled null markers, batched: one
    take_snps + dense proj/solve for the whole sample (the reference's
    per-marker loop, splmm_approx.rs gamma pass — here a single batched
    V^-1 apply over all sampled markers)."""
    rng = np.random.default_rng(seed)
    m = pg.m
    n_samp = min(N_GAMMA_MARKERS, m)
    samp = np.sort(rng.choice(m, size=n_samp, replace=False))
    G = pg.take_snps(samp).centered()  # (k, n)
    Gt = proj(G.T).T  # (k, n)
    gg = np.einsum("kn,kn->k", Gt, Gt)
    VG = null.factor.solve(Gt.T)  # (n, k)
    gPg = np.einsum("kn,nk->k", Gt, VG) / null.sigma2
    ga = Gt @ a
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(gPg > 0, ga * ga / gPg, np.inf)
    mask = (gg > 1e-12) & (chi2 < NULL_CHI2_CUTOFF) & (gPg > 0)
    if not mask.any():
        return 1.0, 0
    gammas = gPg[mask] / gg[mask] * null.sigma2
    return float(np.mean(gammas)), int(mask.sum())


def _scan_ga_gmg(sub, X, C, Ma, n: int, block: int, mesh):
    """(g~'a, g~'g~) for every SNP of one resident superblock — the same
    projected grams as the LM scan with Ma in place of My, so the resident
    single-dispatch kernel and its SNP-sharded shard_map twin are reused
    verbatim (models.lm)."""
    from janusx_tpu.models.lm import _lm_scan_resident, _lm_scan_sharded
    from janusx_tpu.utils import devcache

    m = sub.m
    blk = mesh_step(min(block, m), mesh)
    m_pad = -(-m // blk) * blk
    nblk = m_pad // blk
    pk = devcache.device_packed_blocks(sub, (nblk, blk), mesh=mesh)
    mn = devcache.to_device_blocks(
        sub.mean, (nblk, blk), 0.0, dtype=jnp.float32, mesh=mesh
    )
    args = (jnp.asarray(X), jnp.asarray(C), jnp.asarray(Ma))
    if mesh is not None:
        args = devcache.replicate_tree(args, mesh)
        out = np.asarray(_lm_scan_sharded(mesh, n)(pk, mn, *args))
    else:
        out = np.asarray(_lm_scan_resident(pk, mn, *args, n))
    out = out.reshape(2, m_pad)
    return out[0, :m], out[1, :m]


def splmm_grammar_scan(
    pg: PackedGenotypes,
    K,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    block: int = config.DEFAULT_SNP_BLOCK,
    seed: int = 0,
    superblock: int = 1 << 20,
    mesh=None,
) -> tuple[ScanResult, dict]:
    """GRAMMAR-gamma approximate scan (the ``-splmm`` route).

    ``K`` may be a dense kinship (thresholded at ``cutoff`` here) or an
    already-thresholded scipy sparse matrix (the biobank path — the dense
    n² matrix is then never formed). ``pg`` may be in-RAM or the
    disk-backed WindowedPacked (chunk-streamed through the scan); with a
    ``mesh`` the per-SNP grams run SNP-sharded over the device mesh."""
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    X = design_matrix(n, covariates)
    p = X.shape[1]
    C = np.linalg.inv(X.T @ X)
    proj = lambda v: v - X @ (C @ (X.T @ v))
    ytilde = proj(y)
    n_eff = n - p

    Ks = _coerce_sparse(K, cutoff)
    null = fit_sparse_null(Ks, ytilde, n_eff)
    a = null.factor.solve(ytilde) / null.sigma2
    gamma, n_markers = _calibrate_gamma(pg, proj, null, a, seed)
    gamma_eff = gamma / null.sigma2

    # device scan: g~'a and g~'g~ via the residualized LM machinery
    Ma = proj(a)  # so that G @ Ma = g~' a
    m = pg.m
    block = min(block, m)
    beta = np.empty(m)
    se = np.empty(m)
    gMg_all = np.empty(m)
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    sb = max((superblock // block) * block, block)
    from janusx_tpu.utils.prefetch import prefetch_one_ahead

    def _materialize(span):
        c0, c1 = span
        if c0 == 0 and c1 == m and hasattr(pg, "packed"):
            return c0, c1, pg
        return c0, c1, pg.take_snps(np.arange(c0, c1))

    spans = [(c0, min(c0 + sb, m)) for c0 in range(0, m, sb)]
    # chunk k+1's host IO/decode overlaps chunk k's device work
    for c0, c1, sub in prefetch_one_ahead(spans, _materialize):
        gA, gMgb = _scan_ga_gmg(sub, X, C, Ma, n, block, mesh)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta[c0:c1] = gA / (gamma_eff * gMgb)
            se[c0:c1] = 1.0 / np.sqrt(gamma_eff * gMgb)
        gMg_all[c0:c1] = gMgb

    pwald = jstats.pwald_from_beta_se(beta, se)
    beta, se, pwald, _ = finalize_invalid(beta, se, pwald, gMg_all)
    info = {
        "lambda_null": null.lbd,
        "sigma2": null.sigma2,
        "gamma": gamma,
        "nnz_frac": Ks.nnz / (n * n),
        "n_gamma_markers": n_markers,
        "max_component": null.factor.bs.max_comp,
    }
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se, pwald=pwald,
        extras=info,
    )
    return res, info


def splmm_exact_scan(
    pg: PackedGenotypes,
    K,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    block: int = config.DEFAULT_SNP_BLOCK,
    superblock: int = 1 << 20,
    mesh=None,
) -> tuple[ScanResult, dict]:
    """Exact SparseLMM scan (the ``-splmm-exact`` route).

    Reference semantics (/root/reference/src/stats/splmm.rs:1-9):
        V = K_sparse + lambda I   (lambda from the null fit, fixed)
        P = V^-1 - V^-1 X (X'V^-1X)^-1 X'V^-1
        beta = (g'Py)/(g'Pg);  sigma2 = (y'Py)/(n - p - 1)
        se = sqrt(sigma2/(g'Pg));  chisq = (beta/se)^2 -> Wald p

    The reference runs one sparse triangular solve per SNP; here
    ``g'V^-1 g`` is a bucketed block-spectral einsum over SNP blocks on
    device (models.sparse_spectral) and everything else is two device
    matmuls per block against precomputed V^-1 y and V^-1 X.
    """
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    X = design_matrix(n, covariates)
    p = X.shape[1]
    C0 = np.linalg.inv(X.T @ X)
    proj = lambda v: v - X @ (C0 @ (X.T @ v))
    n_eff = n - p

    Ks = _coerce_sparse(K, cutoff)
    null = fit_sparse_null(Ks, proj(y), n_eff)
    bs = null.factor.bs
    lbd = null.lbd

    a_y = bs.solve(lbd, y)  # V^-1 y
    A_X = bs.solve(lbd, X)  # V^-1 X  (n, p)
    XVX = X.T @ A_X
    Cv = np.linalg.inv(XVX)  # (X'V^-1X)^-1
    Xa = X.T @ a_y  # (p,)
    CvXa = Cv @ Xa
    Py_host = a_y - A_X @ CvXa  # f64, mean-free: P y
    yPy = float(y @ a_y) - float(Xa @ CvXa)
    df = n - p - 1
    sigma2 = yPy / max(df, 1)

    if bs.sparse_comps:
        # percolation fallback: g'V^-1 g rides the per-lambda sparse-LU
        # factor on host (the spectral device einsum needs the dense
        # eigenbasis a giant component can't afford); the factor at the
        # converged lambda is already cached from the null fit
        _block = None
    else:
        quad_fn = bs.device_quad_fn(lbd)
        # Form Py = V^-1 y - V^-1 X (X'V^-1X)^-1 X'V^-1 y in f64 ON HOST
        # before the f32 cast: a_y carries the full phenotype mean in its
        # span(X) component, and computing g'Py on device as the small
        # difference t1 - T2.CvXa of two large f32 dots leaked that mean
        # (metamorphic-found: |dlogp| scaled linearly with a y offset).
        # Py is mean-free, so one f32 dot per block is now exact-class —
        # and one device op cheaper.
        Pyd = jnp.asarray(Py_host, jnp.float32)
        AXd = jnp.asarray(A_X, jnp.float32)
        Cvd = jnp.asarray(Cv, jnp.float32)

        def _block_core(pk, mn):
            G = decode.decode_centered(pk, mn, dtype=jnp.float32)[:, :n]
            hp = jax.lax.Precision.HIGHEST
            T2 = jnp.dot(G, AXd, precision=hp)  # g'V^-1 X  (B, p)
            gVg = quad_fn(G)
            gPg = gVg - jnp.einsum("bp,pq,bq->b", T2, Cvd, T2, precision=hp)
            gPy = jnp.dot(G, Pyd, precision=hp)  # g'Py directly
            return gPy.astype(jnp.float64), gPg.astype(jnp.float64)

        if mesh is not None:
            # per-SNP work only: shard the block's SNP axis over the mesh
            # (closed-over solve constants replicate)
            from jax.sharding import PartitionSpec as P

            _block = jax.jit(jax.shard_map(
                _block_core, mesh=mesh,
                in_specs=(P("snp", None), P("snp")),
                out_specs=(P("snp"), P("snp")),
            ))
        else:
            _block = jax.jit(_block_core)

    m = pg.m
    block = mesh_step(min(block, m), mesh if _block is not None else None)
    beta = np.empty(m)
    se = np.empty(m)
    gPg_all = np.empty(m)
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    sb = max((superblock // block) * block, block)
    from janusx_tpu.models.scan_common import pad_rows

    from janusx_tpu.utils.prefetch import prefetch_one_ahead

    def _materialize_exact(span):
        c0_, c1_ = span
        if c0_ == 0 and c1_ == m and hasattr(pg, "packed"):
            return c0_, c1_, pg
        return c0_, c1_, pg.take_snps(np.arange(c0_, c1_))

    spans_exact = [(c0_, min(c0_ + sb, m)) for c0_ in range(0, m, sb)]
    # chunk k+1's host IO/decode overlaps chunk k's device work — same
    # double-buffering as the grammar route above (reference gblup.rs
    # mpsc overlap); the exact route was the one sibling missing it
    for c0, c1, sub in prefetch_one_ahead(spans_exact, _materialize_exact):
        if _block is None:
            for s0, e0 in iter_blocks(c1 - c0, block):
                G = sub.take_snps(np.arange(s0, e0)).centered()  # (b, n)
                T2 = G @ A_X  # (b, p)
                gVg = bs.quad(lbd, G.T)
                gPgb = gVg - np.einsum("bp,pq,bq->b", T2, Cv, T2)
                gPy = G @ Py_host
                with np.errstate(divide="ignore", invalid="ignore"):
                    beta[c0 + s0:c0 + e0] = gPy / gPgb
                    se[c0 + s0:c0 + e0] = np.sqrt(sigma2 / gPgb)
                gPg_all[c0 + s0:c0 + e0] = gPgb
            continue
        packed = decode.pad_packed_cols(sub.packed)
        for s0, e0 in iter_blocks(c1 - c0, block):
            pk = pad_rows(packed[s0:e0], block, 0xFF)
            mn = pad_rows(sub.mean[s0:e0].astype(np.float32), block)
            gPy, gPg = _block(jnp.asarray(pk), jnp.asarray(mn))
            gPy = np.asarray(gPy)[: e0 - s0]
            gPgb = np.asarray(gPg)[: e0 - s0]
            with np.errstate(divide="ignore", invalid="ignore"):
                beta[c0 + s0:c0 + e0] = gPy / gPgb
                se[c0 + s0:c0 + e0] = np.sqrt(sigma2 / gPgb)
            gPg_all[c0 + s0:c0 + e0] = gPgb

    pwald = jstats.pwald_from_beta_se(beta, se)
    beta, se, pwald, _ = finalize_invalid(beta, se, pwald, gPg_all)
    info = {
        "lambda_null": null.lbd,
        "sigma2": sigma2,
        "nnz_frac": Ks.nnz / (n * n),
        "max_component": bs.max_comp,
    }
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se, pwald=pwald,
        extras=info,
    )
    return res, info
