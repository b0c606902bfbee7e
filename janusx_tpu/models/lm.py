"""Linear-model GWAS scan (``-lm``), residualized OLS on device.

Math (reference /root/reference/src/stats/glm.rs:1-8):
    M_X = I - X(X'X)^{-1}X'
    beta = (g'M_X y)/(g'M_X g)
    rss  = y'M_X y - (g'M_X y)^2/(g'M_X g)
    se   = sqrt(rss/(n - p - 1) / (g'M_X g))
    p    = two-sided Student-t with df = n - p - 1 (glm.rs:458,786)

Device step per SNP block: decode packed 2-bit to centered f32, then two
matmuls (G @ M_X y and G @ X) + row reductions; centering makes the pad
lanes exact zeros so no masking is needed. The per-block cost is dominated
by (B, n) x (n, p+1) device work.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy import special as sp_special

from janusx_tpu import config
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.scan_common import ScanResult
from janusx_tpu.ops import decode
from janusx_tpu.parallel.mesh import mesh_step

_DBL_MIN = np.finfo(np.float64).tiny


def student_t_p_two_sided(t: np.ndarray, df: int) -> np.ndarray:
    """Two-sided t-test p via the regularized incomplete beta
    (reference glm.rs:458: betai(df/2, 1/2, df/(df+t^2)))."""
    t = np.asarray(t, dtype=np.float64)
    if df <= 0:
        return np.full_like(t, np.nan)
    x = df / (df + t * t)
    p = sp_special.betainc(df / 2.0, 0.5, x)
    p = np.where(np.isfinite(p), p, 1.0)
    p = np.clip(p, _DBL_MIN, 1.0)
    # non-finite t: NaN -> NaN handled by caller; +/-inf -> min positive
    p = np.where(np.isnan(t), np.nan, p)
    p = np.where(np.isinf(t), _DBL_MIN, p)
    return p


@partial(jax.jit, static_argnames=("n",))
def _lm_step(packed, mean, X, C, My, n: int):
    G = decode.decode_centered(packed, mean, dtype=jnp.float32)[:, :n].astype(
        jnp.float64
    )
    hp = jax.lax.Precision.HIGHEST
    gMy = jnp.dot(G, My, precision=hp)
    GX = jnp.dot(G, X, precision=hp)
    gg = jnp.sum(G * G, axis=-1)
    gMg = gg - jnp.einsum("bp,pq,bq->b", GX, C, GX)
    return gMy, gMg


def _lm_scan_core(pk, mn, X, C, My, n: int):
    """Whole LM scan body on pre-blocked (nblk, B, K) packed rows: f32 device
    grams (the projection is exact linear algebra; f32-HIGHEST rounding
    ~1e-7 relative). Returns (2, nblk, B)."""
    f32 = jnp.float32
    X32 = X.astype(f32)
    C32 = C.astype(f32)
    My32 = My.astype(f32)
    hp = jax.lax.Precision.HIGHEST

    def body(_, xs):
        pkb, mnb = xs
        G = decode.decode_centered(pkb, mnb, dtype=f32)[:, :n]
        gMy = jnp.dot(G, My32, precision=hp)
        GX = jnp.dot(G, X32, precision=hp)
        gg = jnp.sum(G * G, axis=-1)
        gMg = gg - jnp.einsum("bp,pq,bq->b", GX, C32, GX)
        return None, (gMy.astype(jnp.float64), gMg.astype(jnp.float64))

    _, (gMy, gMg) = jax.lax.scan(body, None, (pk, mn))
    return jnp.stack([gMy, gMg])


@partial(jax.jit, static_argnames=("n",))
def _lm_scan_resident(pk, mn, X, C, My, n: int):
    return _lm_scan_core(pk, mn, X, C, My, n)


@lru_cache(maxsize=8)
def _lm_scan_sharded(mesh, n: int):
    """SNP-sharded LM scan (shard_map over the mesh 'snp' axis)."""
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    fn = partial(_lm_scan_core, n=n)
    return jax.jit(
        shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, "snp", None), P(None, "snp"), P(), P(), P()),
            out_specs=P(None, None, "snp"),
        )
    )


def design_matrix(n: int, covariates: np.ndarray | None) -> np.ndarray:
    ones = np.ones((n, 1), dtype=np.float64)
    if covariates is None:
        return ones
    return np.concatenate([ones, np.asarray(covariates, np.float64)], axis=1)


def lm_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
) -> ScanResult:
    """Run the LM scan over all SNPs of an (already subset) PackedGenotypes."""
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if pg.m > superblock:
        # host IO/decode of chunk k+1 overlaps chunk k's device work
        from janusx_tpu.utils.prefetch import prefetch_one_ahead

        sb = max((superblock // block) * block, block)
        spans = [(s, min(s + sb, pg.m)) for s in range(0, pg.m, sb)]
        parts = [
            lm_scan(sub, y, covariates, block=block, mesh=mesh)
            for sub in prefetch_one_ahead(
                spans, lambda se: pg.take_snps(np.arange(se[0], se[1])))
        ]
        return ScanResult.concat(parts)
    if not hasattr(pg, "packed"):  # lazy input small enough: materialize
        pg = pg.take_snps(np.arange(pg.m))
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n = pg.n
    if len(y) != n:
        raise ValueError(f"y length {len(y)} != samples {n}")
    X = design_matrix(n, covariates)
    p = X.shape[1]
    df = n - p - 1
    if df <= 0:
        raise ValueError("not enough samples for LM scan (df <= 0)")
    XtX = X.T @ X
    C = np.linalg.inv(XtX)
    My = y - X @ (C @ (X.T @ y))
    yMy = float(y @ My)
    # shape bucketing: multi-locus routes (FarmCPU/frgwas/ALGWAS) issue
    # MANY small conditional scans with varying (m, cov-width) — each
    # distinct shape would cost a fresh XLA compile (seconds), which is
    # the dominant wall-clock of the whole route. Pad the design with
    # exact-zero columns to a width bucket (zero columns add +0.0 to every
    # f32 gram term — bitwise-identical stats; C uses pinv, which on the
    # block-diagonal [[XtX, 0], [0, 0]] Gram is exactly [[XtX^-1, 0],
    # [0, 0]]) and keep `block` fixed so small m pads up to one block.
    _PBUCKET = 8
    if p % _PBUCKET:
        pad = _PBUCKET - p % _PBUCKET
        X = np.concatenate([X, np.zeros((n, pad))], axis=1)
        C = np.zeros((p + pad, p + pad))
        C[:p, :p] = np.linalg.inv(XtX)

    from janusx_tpu.utils import devcache

    m = pg.m
    block = mesh_step(block, mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    mn = devcache.to_device_blocks(
        pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
    )
    args = (jnp.asarray(X), jnp.asarray(C), jnp.asarray(My))
    if mesh is not None:
        args = devcache.replicate_tree(args, mesh)
        out = np.asarray(_lm_scan_sharded(mesh, n)(pk, mn, *args))
    else:
        out = np.asarray(_lm_scan_resident(pk, mn, *args, n))
    out = out.reshape(2, m_pad)
    gMy_all, gMg_all = out[0, :m], out[1, :m]
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = gMy_all / gMg_all
        rss = yMy - gMy_all * gMy_all / gMg_all
        se = np.sqrt(rss / df / gMg_all)

    ok = np.isfinite(beta) & np.isfinite(se) & (se > 0) & (gMg_all > 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(ok, beta / se, 0.0)
    pwald = student_t_p_two_sided(t, df)
    pwald = np.where(ok, pwald, 1.0)
    beta = np.where(ok, beta, np.nan)
    se = np.where(ok, se, np.nan)
    return ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se, pwald=pwald
    )


def _lm_scan_core_multi(pk, mn, X, C, MY, n: int):
    """Multi-trait LM core: MY is (n, T); decode + GX grams are shared
    across traits, the numerators come from ONE (B, n) x (n, T) matmul
    (the reference -trait-level additive fast path, workflow.py
    trait-level docstring)."""
    f32 = jnp.float32
    X32 = X.astype(f32)
    C32 = C.astype(f32)
    MY32 = MY.astype(f32)
    hp = jax.lax.Precision.HIGHEST

    def body(_, xs):
        pkb, mnb = xs
        G = decode.decode_centered(pkb, mnb, dtype=f32)[:, :n]
        gMY = jnp.dot(G, MY32, precision=hp)  # (B, T)
        GX = jnp.dot(G, X32, precision=hp)
        gg = jnp.sum(G * G, axis=-1)
        gMg = gg - jnp.einsum("bp,pq,bq->b", GX, C32, GX)
        return None, (gMY.astype(jnp.float64), gMg.astype(jnp.float64))

    _, (gMY, gMg) = jax.lax.scan(body, None, (pk, mn))
    return gMY, gMg


@partial(jax.jit, static_argnames=("n",))
def _lm_scan_resident_multi(pk, mn, X, C, MY, n: int):
    return _lm_scan_core_multi(pk, mn, X, C, MY, n)


@lru_cache(maxsize=8)
def _lm_scan_sharded_multi(mesh, n: int):
    from jax.sharding import PartitionSpec as P

    fn = partial(_lm_scan_core_multi, n=n)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, "snp", None), P(None, "snp"), P(), P(), P()),
            out_specs=(P(None, "snp", None), P(None, "snp")),
        )
    )


def lm_scan_multi(
    pg: PackedGenotypes,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
) -> list[ScanResult]:
    """Batched multi-trait LM scan: all columns of Y share the sample set
    and covariates; one device dispatch covers every trait."""
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, T = pg.n, Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {n}")
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if pg.m > superblock:
        from janusx_tpu.utils.prefetch import prefetch_one_ahead

        sb = max((superblock // block) * block, block)
        spans = [(s0, min(s0 + sb, pg.m)) for s0 in range(0, pg.m, sb)]
        parts = [
            lm_scan_multi(sub, Y, covariates, block=block, mesh=mesh)
            for sub in prefetch_one_ahead(
                spans, lambda se: pg.take_snps(np.arange(se[0], se[1])))
        ]
        return [ScanResult.concat([p[t] for p in parts]) for t in range(T)]
    if not hasattr(pg, "packed"):
        pg = pg.take_snps(np.arange(pg.m))
    X = design_matrix(n, covariates)
    p = X.shape[1]
    df = n - p - 1
    if df <= 0:
        raise ValueError("not enough samples for LM scan (df <= 0)")
    C = np.linalg.inv(X.T @ X)
    MY = Y - X @ (C @ (X.T @ Y))  # (n, T)
    yMy = np.einsum("nt,nt->t", Y, MY)

    from janusx_tpu.utils import devcache

    m = pg.m
    block = mesh_step(min(block, m), mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    mn = devcache.to_device_blocks(
        pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
    )
    args = (jnp.asarray(X), jnp.asarray(C), jnp.asarray(MY))
    if mesh is not None:
        args = devcache.replicate_tree(args, mesh)
        gMY, gMg = _lm_scan_sharded_multi(mesh, n)(pk, mn, *args)
    else:
        gMY, gMg = _lm_scan_resident_multi(pk, mn, *args, n)
    gMY = np.asarray(gMY).reshape(m_pad, T)[:m]
    gMg = np.asarray(gMg).reshape(m_pad)[:m]
    results = []
    for t_idx in range(T):
        gMy_all = gMY[:, t_idx]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = gMy_all / gMg
            rss = yMy[t_idx] - gMy_all * gMy_all / gMg
            se = np.sqrt(rss / df / gMg)
        ok = np.isfinite(beta) & np.isfinite(se) & (se > 0) & (gMg > 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = np.where(ok, beta / se, 0.0)
        pw = student_t_p_two_sided(tt, df)
        results.append(ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss,
            beta=np.where(ok, beta, np.nan),
            se=np.where(ok, se, np.nan),
            pwald=np.where(ok, pw, 1.0),
        ))
    return results
