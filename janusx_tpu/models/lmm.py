"""Exact per-SNP REML LMM scan (GEMMA-semantics, ``-lmm`` / ``-lmm2``).

The flagship model. Per SNP, λ is optimized by Brent over log10 λ in
(−5, 5) against the profiled REML (reference /root/reference/src/stats/
lmm.rs + reml.rs; tol 1e-2, 50 iters, seeded from the null λ), then
beta/se at the optimum give the Wald test; ``lmm2`` additionally reports
per-SNP λ, the ML loglik at the optimum, and an LRT p against the null ML
(columns lambda/ml/plrt — src/io/assoc2tsv.rs Lmm2_6).

Device mapping: a whole SNP block optimizes in lockstep — the batched
Brent (janusx_tpu.ops.brent) drives the batched spectral REML objective
(janusx_tpu.core.reml), whose λ-step cost is a few (B, n) x (n, k)
matmuls. This replaces the reference's rayon per-row scalar Brent loops;
warm starts are per-block (null λ) instead of per-row-sequential, which
changes nothing beyond the Brent tolerance.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core import stats as jstats
from janusx_tpu.core.reml import (
    NullFit,
    RotatedData,
    beta_se_snp_batch,
    final_grams_f32,
    final_stats_from_grams,
    fit_null_reml,
    grid_shared,
    lmm_grid_scan,
    lmm_grid_scan_with,
    make_rotated,
    ml_snp_batch,
    neg_reml_snp_batch,
)
from janusx_tpu.core.spectral import SpectralBasis
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.scan_common import ScanResult, finalize_invalid, iter_blocks, pad_rows
from janusx_tpu.ops import decode
from janusx_tpu.ops.brent import brent_minimize_batched
from janusx_tpu.parallel.mesh import mesh_step
from janusx_tpu.utils import devcache


@partial(jax.jit, static_argnames=("n", "with_ml", "max_iter"))
def _lmm_block(
    packed, mean, U32, rot: RotatedData, init_lg, n: int, with_ml: bool,
    max_iter: int = config.SCAN_BRENT_MAX_ITER,
):
    """Brent-mode block: lockstep batched Brent (reference-faithful path)."""
    Graw = decode.decode_centered(packed, mean, dtype=jnp.float32)[:, :n]
    Gr = jnp.dot(Graw, U32, precision=jax.lax.Precision.HIGHEST).astype(jnp.float64)
    ssq = jnp.sum(Gr * Gr, axis=-1)
    B = Gr.shape[0]

    f = lambda lg: neg_reml_snp_batch(lg, rot, Gr)
    lgs, _ = brent_minimize_batched(
        f,
        config.LOG10_LAMBDA_LOW,
        config.LOG10_LAMBDA_HIGH,
        config.SCAN_BRENT_TOL,
        max_iter,
        init_x=jnp.full((B,), init_lg, jnp.float64),
    )
    beta, se = beta_se_snp_batch(lgs, rot, Gr)
    ml = ml_snp_batch(lgs, rot, Gr) if with_ml else jnp.zeros_like(lgs)
    return lgs, beta, se, ml, ssq


def _lmm_scan_core(pk, mn, U32, rot: RotatedData, sh, n: int, with_ml: bool):
    """Whole-scan body on pre-blocked (nblk, B, K) packed genotypes:
    lax.scan streams SNP blocks through decode -> rotate -> grid λ-search
    -> f32-gram beta/se -> device Wald p. Under shard_map the B axis is
    the per-device slice; per-SNP statistics need no communication.
    Returns ((3, nblk, B) beta/se/p, (nblk, B) log10 λ*, (nblk, B) ml) —
    the block structure is kept so the sharded axis reassembles in SNP
    order.

    ``sh`` is the precomputed GridShared state (cached across calls — its
    f64 (G, n) lattice work is per-trait, not per-scan).
    """

    p = rot.p

    def body(_, xs):
        pkb, mnb = xs
        with jax.named_scope("decode"):
            Graw = decode.decode_centered(pkb, mnb, dtype=jnp.float32)[:, :n]
        with jax.named_scope("rotate"):
            Gr32 = jnp.dot(Graw, U32, precision=jax.lax.Precision.HIGHEST)
        ssq = jnp.sum(Gr32 * Gr32, axis=-1)  # f32; cast post-scan
        lgs = lmm_grid_scan_with(sh, rot, Gr32)  # casts to f32 inside
        # per-block work stays f32; the f64 Schur epilogue runs ONCE
        # post-scan over the stacked grams
        with jax.named_scope("final_grams"):
            A1, A2, agg, ldV = final_grams_f32(rot, Gr32, lgs, with_ml)
        return None, (lgs, A1, A2, agg, ldV, ssq)

    _, (lgs, A1, A2, agg, ldV, ssq) = jax.lax.scan(body, None, (pk, mn))
    nblk, B = lgs.shape
    beta, se, ml = final_stats_from_grams(
        n, p, A1.reshape(nblk * B, -1), A2.reshape(nblk * B, -1),
        agg.reshape(-1), with_ml, ldV.reshape(-1),
    )
    beta = beta.reshape(nblk, B)
    se = se.reshape(nblk, B)
    # monomorphic/degenerate-lane sanitize on device (reference rules,
    # src/math/linalg.rs:99-108 + ssq<=eps), so ssq never leaves the card
    bad = ~jnp.isfinite(beta) | ~jnp.isfinite(se) | (se <= 0) | (ssq <= 1e-12)
    beta = jnp.where(bad, jnp.nan, beta)
    se = jnp.where(bad, jnp.nan, se)
    # Wald χ²(1) p on device: merges the scipy host step into the same
    # dispatch (reference p-value semantics, src/math/linalg.rs:99-108)
    pwald = jstats.pwald_from_beta_se_device(beta, se)
    # one stacked f32 output -> a single host fetch. f32 carries the full
    # precision of every printed column (beta/se %.4f, p %.4e; p-values at
    # the f32 floor are recomputed exactly on host via _PWALD_F32_FLOOR).
    # lgs/ml are fetched ONLY on the lmm2 route (the plain-LMM TSV has no
    # lambda column; ml stays f64 — LRT differences of O(n) logliks).
    f32 = jnp.float32
    stack = jnp.stack([beta.astype(f32), se.astype(f32), pwald.astype(f32)])
    # shapes kept (nblk, B) for the shard_map out_spec; the caller only
    # FETCHES these on the lmm2 route
    ml64 = (ml.reshape(nblk, B) if with_ml
            else jnp.zeros((nblk, B), f32))
    return stack, lgs.astype(f32), ml64


@partial(jax.jit, static_argnames=("n", "with_ml"))
def _lmm_scan_resident(pk, mn, U32, rot, sh, n, with_ml):
    return _lmm_scan_core(pk, mn, U32, rot, sh, n, with_ml)


@lru_cache(maxsize=8)
def _lmm_scan_sharded(mesh, n: int, with_ml: bool):
    """SNP-sharded whole scan: shard_map over the mesh 'snp' axis.

    pk/mn arrive with their per-block SNP axis sharded; U32/rot/sh are
    replicated. Each device scans its SNP rows — the device-mesh
    replacement for the reference's rayon x BLAS two-level thread plan
    (reference python/janusx/assoc/workflow.py:5296-5460)."""
    from jax.sharding import PartitionSpec as P

    fn = partial(_lmm_scan_core, n=n, with_ml=with_ml)
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, "snp", None), P(None, "snp"), P(), P(), P()),
        out_specs=(P(None, None, "snp"), P(None, "snp"), P(None, "snp")),
    )
    return jax.jit(mapped)


# Per-trait scan state cache: rotated data + λ-grid shared pieces stay
# device-resident across repeated scans of the same (basis, y, cov) —
# multi-model runs, CV folds, FarmCPU iterations, bench re-runs. The
# reference analog is FvLmmAssocCache (src/stats/fvlmm.rs cached rotated
# covariates); here it also avoids remote-link re-uploads.
_state_cache: dict = {}
_STATE_CACHE_MAX = 8


_grid_shared_jit = jax.jit(grid_shared)


def _scan_state(basis: SpectralBasis, y: np.ndarray, covariates, grid_points: int):
    # strong digests, not Python hash(): a 64-bit siphash collision would
    # silently serve one trait's rotated data to another (no error, wrong
    # betas); blake2b makes that impossible in practice and costs ~us
    import hashlib

    key = (
        id(basis.U),
        hashlib.blake2b(y.tobytes(), digest_size=16).digest(),
        None if covariates is None else hashlib.blake2b(
            np.ascontiguousarray(covariates).tobytes(),
            digest_size=16).digest(),
        grid_points,
    )
    hit = _state_cache.get(key)
    if hit is not None:
        return hit
    rot = make_rotated(basis, y, covariates)
    grid_lg = jnp.asarray(
        np.linspace(
            config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH, grid_points
        ),
        jnp.float64,
    )
    sh = _grid_shared_jit(rot, grid_lg)
    if len(_state_cache) >= _STATE_CACHE_MAX:
        _state_cache.pop(next(iter(_state_cache)))
    _state_cache[key] = (rot, grid_lg, sh)
    # id(basis.U) is only unique while basis.U is alive: evict on GC so a
    # recycled address can never serve another basis's rotations
    # (devcache.py's finalizer discipline)
    import weakref

    try:
        weakref.finalize(basis.U, _state_cache.pop, key, None)
    except TypeError:
        _state_cache.pop(key)  # not weakref-able: don't cache at all
        return rot, grid_lg, sh
    return rot, grid_lg, sh


# -log10 p beyond which the device f32 erfc has underflowed: recompute
# those (few) lanes exactly on host.
_PWALD_F32_FLOOR = 1e-30


def lmm_scan(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    null: NullFit | None = None,
    method: str = "grid",  # "grid" (shared λ grid) | "brent" (reference-faithful)
    grid_points: int | None = None,  # None = JX_TPU_GRID_POINTS (default 256)
    superblock: int = 1 << 20,  # SNPs resident on device per host chunk
    mesh=None,  # jax.sharding.Mesh with a 'snp' axis: SNP-shard the scan
) -> tuple[ScanResult, NullFit]:
    """Exact LMM scan over all SNPs of the (subset) packed genotypes.

    ``block`` is the SNPs each device scans per step (with a mesh, one
    step covers ``block`` x devices SNPs)."""
    if method not in ("grid", "brent"):
        # a typo ('Grid', 'GRID', ...) must not silently select the
        # orders-of-magnitude-slower reference-faithful Brent loop
        raise ValueError(
            f"unknown lmm scan method {method!r} (expected 'grid' or 'brent')")
    if method == "brent" and mesh is not None:
        import warnings

        warnings.warn(
            "lmm_scan(method='brent') runs single-device; the mesh argument "
            "is ignored on this path (use method='grid' for sharded scans)",
            stacklevel=2)
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    rot, grid_lg, sh = _scan_state(basis, y, covariates, grid_points)
    if null is None:
        null = fit_null_reml(rot)

    U32 = devcache.to_device(basis.U, jnp.float32)
    m = pg.m
    block = min(block, m) if m else block
    # lazy disk-backed inputs (io.windowed.WindowedPacked) bound their
    # resident-SNP chunk; in-RAM inputs chunk only above `superblock`
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if m > superblock:
        # streaming superblock mode: chunk the (possibly disk-backed)
        # matrix through the resident scan so neither host RAM nor HBM
        # ever holds more than `superblock` materialized SNPs
        # (reference analog: WindowedBedMatrix streaming, src/io/gload.rs).
        # Host IO/decode of chunk k+1 overlaps chunk k's device work
        # (reference double-buffer overlap, src/stats/gblup.rs:27-28).
        from janusx_tpu.utils.prefetch import prefetch_one_ahead

        parts = []
        sb = max((superblock // block) * block, block)
        spans = [(s0, min(s0 + sb, m)) for s0 in range(0, m, sb)]
        for sub in prefetch_one_ahead(
                spans, lambda se: pg.take_snps(np.arange(se[0], se[1]))):
            r, null = lmm_scan(
                sub, basis, y, covariates, block=block, lmm2=lmm2, null=null,
                method=method, grid_points=grid_points, mesh=mesh,
            )
            parts.append(r)
        return ScanResult.concat(parts), null
    if not hasattr(pg, "packed"):  # lazy input small enough: materialize
        pg = pg.take_snps(np.arange(m))
    packed = None if method == "grid" else decode.pad_packed_cols(pg.packed)
    if method == "grid":
        block = mesh_step(block, mesh)
        m_pad = -(-m // block) * block
        nblk = m_pad // block
        pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
        mn = devcache.to_device_blocks(
            pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
        )
        if mesh is not None:
            U_d, rot_d, sh_d = devcache.replicate_tree((U32, rot, sh), mesh)
            stack, lgs_dev, ml_dev = _lmm_scan_sharded(mesh, n, lmm2)(
                pk, mn, U_d, rot_d, sh_d)
        else:
            stack, lgs_dev, ml_dev = _lmm_scan_resident(
                pk, mn, U32, rot, sh, n, lmm2)
        out = np.asarray(stack).astype(np.float64).reshape(3, m_pad)
        beta = out[0, :m]
        se = out[1, :m]
        pwald_dev = out[2, :m]
        # lambda/ml are fetched ONLY for the LRT route (the plain-LMM TSV
        # has no lambda column)
        if lmm2:
            lbd = 10.0 ** np.asarray(lgs_dev, np.float64).reshape(m_pad)[:m]
            ml = np.asarray(ml_dev, np.float64).reshape(m_pad)[:m]
        else:
            lbd = np.full(m, np.nan)
            ml = np.zeros(m)
        # degenerate lanes already sanitized on device (ssq mask folded in)
        ssq = np.ones(m)
    else:
        pwald_dev = None
        lbd = np.empty(m)
        beta = np.empty(m)
        se = np.empty(m)
        ml = np.empty(m)
        ssq = np.empty(m)
        for s0, e0 in iter_blocks(m, block):
            pk = pad_rows(packed[s0:e0], block, 0xFF)
            mn = pad_rows(pg.mean[s0:e0].astype(np.float32), block)
            lgs_b, beta_b, se_b, ml_b, ssq_b = _lmm_block(
                jnp.asarray(pk),
                jnp.asarray(mn),
                U32,
                rot,
                null.log10_lbd,
                n,
                lmm2,
            )
            k = e0 - s0
            lbd[s0:e0] = 10.0 ** np.asarray(lgs_b)[:k]
            beta[s0:e0] = np.asarray(beta_b)[:k]
            se[s0:e0] = np.asarray(se_b)[:k]
            ml[s0:e0] = np.asarray(ml_b)[:k]
            ssq[s0:e0] = np.asarray(ssq_b)[:k]

    if pwald_dev is not None:
        # device f32 erfc is exact to ~1e-7 relative; lanes at/below the
        # f32 underflow floor get the exact host value
        pwald = pwald_dev
        tiny = pwald <= _PWALD_F32_FLOOR
        if tiny.any():
            pwald = pwald.copy()
            pwald[tiny] = jstats.pwald_from_beta_se(beta[tiny], se[tiny])
    else:
        pwald = jstats.pwald_from_beta_se(beta, se)
    if lmm2:
        plrt = jstats.plrt_from_ml(ml, null.ml)
        beta, se, pwald, plrt = finalize_invalid(beta, se, pwald, ssq, plrt)
        res = ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald, plrt=plrt, lbd=lbd, ml=ml,
            extras={"lambda_null": null.lbd, "ml_null": null.ml},
        )
    else:
        beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq)
        res = ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald, extras={"lambda_null": null.lbd},
        )
    return res, null


# ------------------------------------------------------------ multi-trait


def _lmm_scan_core_multi(pk, mn, U32, rots, shs, n: int, with_ml: bool):
    """Multi-trait grid scan: decode + rotate once per SNP block, vmapped
    per-trait λ-grid search + final stats (the trait-level LMM fast path —
    decode+rotate is the per-SNP cost that dominates at deployment n, and
    is amortized over T). rots/shs carry a leading trait axis on every
    leaf."""
    p = int(rots.Xr.shape[-1])

    def body(_, xs):
        pkb, mnb = xs
        with jax.named_scope("decode"):
            Graw = decode.decode_centered(pkb, mnb, dtype=jnp.float32)[:, :n]
        with jax.named_scope("rotate"):
            Gr32 = jnp.dot(Graw, U32, precision=jax.lax.Precision.HIGHEST)
        ssq = jnp.sum(Gr32 * Gr32, axis=-1)  # f32; cast once post-scan

        def per_trait(rot, sh):
            lgs = lmm_grid_scan_with(sh, rot, Gr32)
            with jax.named_scope("final_grams"):
                return (lgs,) + final_grams_f32(rot, Gr32, lgs, with_ml)

        lgs, A1, A2, agg, ldV = jax.vmap(per_trait)(rots, shs)  # (T, ...)
        return None, (lgs, A1, A2, agg, ldV, ssq)

    _, (lgs, A1, A2, agg, ldV, ssq) = jax.lax.scan(body, None, (pk, mn))
    nblk, T_, B = lgs.shape
    N = nblk * T_ * B
    beta, se, ml = final_stats_from_grams(
        n, p, A1.reshape(N, -1), A2.reshape(N, -1), agg.reshape(-1),
        with_ml, ldV.reshape(-1),
    )
    beta = beta.reshape(nblk, T_, B)
    se = se.reshape(nblk, T_, B)
    bad = (~jnp.isfinite(beta) | ~jnp.isfinite(se) | (se <= 0)
           | (ssq[:, None, :] <= 1e-12))
    beta = jnp.where(bad, jnp.nan, beta)
    se = jnp.where(bad, jnp.nan, se)
    pwald = jstats.pwald_from_beta_se_device(beta, se)
    f32 = jnp.float32
    stack = jnp.stack([beta.astype(f32), se.astype(f32),
                       pwald.astype(f32)])  # (3, nblk, T, B)
    ml64 = (ml.reshape(nblk, T_, B) if with_ml
            else jnp.zeros((nblk, T_, B), f32))
    return stack, lgs.astype(f32), ml64


@partial(jax.jit, static_argnames=("n", "with_ml"))
def _lmm_scan_resident_multi(pk, mn, U32, rots, shs, n: int, with_ml: bool):
    return _lmm_scan_core_multi(pk, mn, U32, rots, shs, n, with_ml)


@lru_cache(maxsize=8)
def _lmm_scan_sharded_multi(mesh, n: int, with_ml: bool):
    from jax.sharding import PartitionSpec as P

    fn = partial(_lmm_scan_core_multi, n=n, with_ml=with_ml)
    rot_spec = RotatedData(*([P()] * len(RotatedData._fields)))
    from janusx_tpu.core.reml import GridShared

    sh_spec = GridShared(*([P()] * len(GridShared._fields)))
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, "snp", None), P(None, "snp"), P(),
                      rot_spec, sh_spec),
            out_specs=(P(None, None, None, "snp"), P(None, None, "snp"),
                       P(None, None, "snp")),
        )
    )


def lmm_scan_multi(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    grid_points: int | None = None,
    mesh=None,
    superblock: int = 1 << 20,
    _prepared=None,
) -> tuple[list[ScanResult], list[NullFit]]:
    """Batched exact-LMM scan for traits sharing one sample mask/basis.

    One resident dispatch covers every trait; numerics match per-trait
    `lmm_scan(method="grid")` exactly (same kernels, vmapped)."""
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, T = pg.n, Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {n}")
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    # per-trait rotations/null fits are SNP-independent: computed once and
    # threaded through the superblock chunks via _prepared
    if _prepared is None:
        states = [_scan_state(basis, Y[:, t].copy(), covariates, grid_points)
                  for t in range(T)]
        nulls = [fit_null_reml(rot) for rot, _, _ in states]
    else:
        states, nulls = _prepared
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if pg.m > superblock:
        sb = max((superblock // block) * block, block)
        parts = []
        for s0 in range(0, pg.m, sb):
            sub = pg.take_snps(np.arange(s0, min(s0 + sb, pg.m)))
            rs, _ = lmm_scan_multi(sub, basis, Y, covariates, block=block,
                                   lmm2=lmm2, grid_points=grid_points,
                                   mesh=mesh, _prepared=(states, nulls))
            parts.append(rs)
        return ([ScanResult.concat([p[t] for p in parts]) for t in range(T)],
                nulls)
    if not hasattr(pg, "packed"):
        pg = pg.take_snps(np.arange(pg.m))
    rots = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[0] for s in states])
    shs = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[2] for s in states])

    m = pg.m
    block = mesh_step(min(block, m) if m else block, mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    U32 = devcache.to_device(basis.U, jnp.float32)
    mn = devcache.to_device_blocks(
        pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
    )
    if mesh is not None:
        U_d, rots_d, shs_d = devcache.replicate_tree((U32, rots, shs), mesh)
        stack, lgs_dev, ml_dev = _lmm_scan_sharded_multi(mesh, n, lmm2)(
            pk, mn, U_d, rots_d, shs_d)
    else:
        stack, lgs_dev, ml_dev = _lmm_scan_resident_multi(
            pk, mn, U32, rots, shs, n, lmm2)
    # (3, nblk, T, B) -> (3, T, m_pad); lgs/ml fetch only for lmm2
    out = np.asarray(stack).astype(np.float64).transpose(0, 2, 1, 3)
    out = out.reshape(3, T, m_pad)
    if lmm2:
        lbd_all = 10.0 ** np.asarray(lgs_dev, np.float64).transpose(
            1, 0, 2).reshape(T, m_pad)
        ml_all = np.asarray(ml_dev, np.float64).transpose(
            1, 0, 2).reshape(T, m_pad)
    else:
        lbd_all = np.full((T, m_pad), np.nan)
        ml_all = np.zeros((T, m_pad))
    results = []
    for t in range(T):
        null = nulls[t]
        lbd = lbd_all[t, :m]
        beta, se = out[0, t, :m], out[1, t, :m]
        ssq = np.ones(m)  # degenerate lanes sanitized on device
        ml = ml_all[t, :m]
        pwald = out[2, t, :m]
        tiny = pwald <= _PWALD_F32_FLOOR
        if tiny.any():
            pwald = pwald.copy()
            pwald[tiny] = jstats.pwald_from_beta_se(beta[tiny], se[tiny])
        if lmm2:
            plrt = jstats.plrt_from_ml(ml, null.ml)
            beta_f, se_f, pwald_f, plrt = finalize_invalid(beta, se, pwald, ssq, plrt)
            results.append(ScanResult(
                sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta_f, se=se_f,
                pwald=pwald_f, plrt=plrt, lbd=lbd, ml=ml,
                extras={"lambda_null": null.lbd, "ml_null": null.ml},
            ))
        else:
            beta_f, se_f, pwald_f, _ = finalize_invalid(beta, se, pwald, ssq)
            results.append(ScanResult(
                sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta_f, se=se_f,
                pwald=pwald_f, extras={"lambda_null": null.lbd},
            ))
    return results, nulls
