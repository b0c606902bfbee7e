"""FvLMM: fixed-λ mixed-model scan (EMMAX-style, ``-fvlmm``).

One REML null fit gives λ for the whole GWAS; each SNP is then a weighted
regression on the rotated scale (reference /root/reference/src/stats/
fvlmm.rs:1-8):

    beta = (g'P y)/(g'P g),  se = sqrt((y'P y / df)/(g'P g)),  df = n-p-1
    P = W - W X (X'WX)^{-1} X'W,  W = diag(1/(s_i + λ))
    pwald = 2*Phi_bar(|beta/se|)  (fvlmm.rs:1774-1778)

Device step: decode block -> rotate via U (f32 device matmul) -> two small
matmuls against precomputed P-pieces. Everything after rotation is f64.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core import stats as jstats
from janusx_tpu.core.reml import NullFit, fit_null_reml, make_rotated
from janusx_tpu.core.spectral import SpectralBasis
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu.ops import decode
from janusx_tpu.parallel.mesh import mesh_step


def _fvlmm_scan_core(pk, mn, U32, w, X, Cw, Py, n: int):
    """Whole fixed-λ scan body on pre-blocked (nblk, B, K) packed rows
    (lax.scan over blocks, f32 grams — weights are shared, so
    everything is matmuls).

    w: (n,) weights; X: (n, p) rotated design; Cw = (X'WX + ridge)^{-1};
    Py: (n,) = P y. Returns stacked (3, nblk, B): gPy, gPg, ssq.
    """
    f32 = jnp.float32
    w32 = w.astype(f32)
    X32 = X.astype(f32)
    Cw32 = Cw.astype(f32)
    Py32 = Py.astype(f32)
    hp = jax.lax.Precision.HIGHEST

    def body(_, xs):
        pkb, mnb = xs
        Graw = decode.decode_centered(pkb, mnb, dtype=f32)[:, :n]
        Gr = jnp.dot(Graw, U32, precision=hp)
        ssq = jnp.sum(Gr * Gr, axis=-1)
        wG = Gr * w32[None, :]
        gPy = jnp.dot(Gr, Py32, precision=hp)
        XWg = jnp.dot(wG, X32, precision=hp)
        gWg = jnp.sum(wG * Gr, axis=-1)
        gPg = gWg - jnp.einsum("bp,pq,bq->b", XWg, Cw32, XWg)
        return None, (gPy.astype(jnp.float64), gPg.astype(jnp.float64),
                      ssq.astype(jnp.float64))

    _, (gPy, gPg, ssq) = jax.lax.scan(body, None, (pk, mn))
    return jnp.stack([gPy, gPg, ssq])


@partial(jax.jit, static_argnames=("n",))
def _fvlmm_scan_resident(pk, mn, U32, w, X, Cw, Py, n: int):
    return _fvlmm_scan_core(pk, mn, U32, w, X, Cw, Py, n)


@lru_cache(maxsize=8)
def _fvlmm_scan_sharded(mesh, n: int):
    """SNP-sharded fixed-λ scan (shard_map over the mesh 'snp' axis)."""
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    fn = partial(_fvlmm_scan_core, n=n)
    return jax.jit(
        shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, "snp", None), P(None, "snp"),
                      P(), P(), P(), P(), P()),
            out_specs=P(None, None, "snp"),
        )
    )


def fvlmm_scan(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    null: NullFit | None = None,
    mesh=None,
    superblock: int = 1 << 20,
) -> tuple[ScanResult, NullFit]:
    """Fixed-λ scan. ``basis`` must be the eigh of the (ridged) GRM on the
    same sample subset as ``pg``."""
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if pg.m > superblock:
        sb = max((superblock // block) * block, block)
        parts = []
        for s in range(0, pg.m, sb):
            sub = pg.take_snps(np.arange(s, min(s + sb, pg.m)))
            r, null = fvlmm_scan(sub, basis, y, covariates, block=block,
                                 null=null, mesh=mesh)
            parts.append(r)
        return ScanResult.concat(parts), null
    if not hasattr(pg, "packed"):  # lazy input small enough: materialize
        pg = pg.take_snps(np.arange(pg.m))
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    rot = make_rotated(basis, y, covariates)
    if null is None:
        null = fit_null_reml(rot)
    p = rot.p
    df = n - p - 1
    if df <= 0:
        raise ValueError("df <= 0 in fvlmm scan")

    s = basis.S
    w = 1.0 / (s + null.lbd)
    Xr = np.asarray(rot.Xr)
    yr = np.asarray(rot.yr)
    XWX = Xr.T * w @ Xr + config.GRAM_RIDGE * np.eye(p)
    Cw = np.linalg.inv(XWX)
    XWy = Xr.T @ (w * yr)
    Py = w * yr - (w[:, None] * Xr) @ (Cw @ XWy)
    yPy = float(yr @ Py)

    from janusx_tpu.utils import devcache

    U32 = devcache.to_device(basis.U, jnp.float32)
    m = pg.m
    block = mesh_step(min(block, m), mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    mn = devcache.to_device_blocks(
        pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
    )
    args = (U32, jnp.asarray(w), jnp.asarray(Xr), jnp.asarray(Cw),
            jnp.asarray(Py))
    if mesh is not None:
        args = devcache.replicate_tree(args, mesh)
        out = np.asarray(_fvlmm_scan_sharded(mesh, n)(pk, mn, *args))
    else:
        out = np.asarray(_fvlmm_scan_resident(pk, mn, *args, n))
    out = out.reshape(3, m_pad)
    gPy_all, gPg_all, ssq_all = out[0, :m], out[1, :m], out[2, :m]
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = gPy_all / gPg_all
        se = np.sqrt((yPy / df) / gPg_all)

    pwald = jstats.pwald_from_beta_se(beta, se)
    beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq_all)
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se, pwald=pwald,
        extras={"lambda_null": null.lbd, "reml_null": null.reml},
    )
    return res, null


# ------------------------------------------------------------ multi-trait


def _fvlmm_scan_core_multi(pk, mn, U32, W, X, CW, PY, n: int):
    """Multi-trait fixed-λ scan: one decode+rotate per block, vmapped
    per-trait weighted grams (each trait carries its own null λ weights).
    W (T, n), CW (T, p, p), PY (T, n); X is shared."""
    f32 = jnp.float32
    W32 = W.astype(f32)
    X32 = X.astype(f32)
    CW32 = CW.astype(f32)
    PY32 = PY.astype(f32)
    hp = jax.lax.Precision.HIGHEST

    def body(_, xs):
        pkb, mnb = xs
        Graw = decode.decode_centered(pkb, mnb, dtype=f32)[:, :n]
        Gr = jnp.dot(Graw, U32, precision=hp)
        ssq = jnp.sum(Gr * Gr, axis=-1).astype(jnp.float64)

        def per_trait(w32, Cw32, Py32):
            wG = Gr * w32[None, :]
            gPy = jnp.dot(Gr, Py32, precision=hp)
            XWg = jnp.dot(wG, X32, precision=hp)
            gWg = jnp.sum(wG * Gr, axis=-1)
            gPg = gWg - jnp.einsum("bp,pq,bq->b", XWg, Cw32, XWg)
            return gPy.astype(jnp.float64), gPg.astype(jnp.float64)

        gPy, gPg = jax.vmap(per_trait)(W32, CW32, PY32)  # (T, B)
        return None, (gPy, gPg, ssq)

    _, (gPy, gPg, ssq) = jax.lax.scan(body, None, (pk, mn))
    ssq_t = jnp.broadcast_to(ssq[:, None, :], gPy.shape)
    return jnp.stack([gPy, gPg, ssq_t])  # (3, nblk, T, B)


@partial(jax.jit, static_argnames=("n",))
def _fvlmm_scan_resident_multi(pk, mn, U32, W, X, CW, PY, n: int):
    return _fvlmm_scan_core_multi(pk, mn, U32, W, X, CW, PY, n)


@lru_cache(maxsize=8)
def _fvlmm_scan_sharded_multi(mesh, n: int):
    from jax.sharding import PartitionSpec as P

    fn = partial(_fvlmm_scan_core_multi, n=n)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, "snp", None), P(None, "snp"),
                      P(), P(), P(), P(), P()),
            out_specs=P(None, None, None, "snp"),
        )
    )


def fvlmm_scan_multi(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
) -> tuple[list[ScanResult], list[NullFit]]:
    """Batched fixed-λ scan for traits sharing one sample mask/basis."""
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, T = pg.n, Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {n}")
    s = basis.S
    Xr = None
    Ws, CWs, PYs, yPys, nulls = [], [], [], [], []
    p = None
    for t in range(T):
        rot = make_rotated(basis, Y[:, t], covariates)
        null = fit_null_reml(rot)
        nulls.append(null)
        p = rot.p
        Xr = np.asarray(rot.Xr)
        yr = np.asarray(rot.yr)
        w = 1.0 / (s + null.lbd)
        XWX = Xr.T * w @ Xr + config.GRAM_RIDGE * np.eye(p)
        Cw = np.linalg.inv(XWX)
        XWy = Xr.T @ (w * yr)
        Py = w * yr - (w[:, None] * Xr) @ (Cw @ XWy)
        Ws.append(w)
        CWs.append(Cw)
        PYs.append(Py)
        yPys.append(float(yr @ Py))
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if pg.m > superblock:
        # the per-trait weights above are SNP-independent; the chunked
        # calls rebuild them from the same rotations (cheap O(n p) work —
        # the O(n^2) rotation itself lives inside make_rotated, which the
        # recursion repeats; acceptable for the rare windowed case) and
        # every chunk returns identical nulls
        sb = max((superblock // block) * block, block)
        parts = []
        for s0 in range(0, pg.m, sb):
            sub = pg.take_snps(np.arange(s0, min(s0 + sb, pg.m)))
            rs, _ = fvlmm_scan_multi(sub, basis, Y, covariates,
                                     block=block, mesh=mesh)
            parts.append(rs)
        return ([ScanResult.concat([p_[t] for p_ in parts]) for t in range(T)],
                nulls)
    if not hasattr(pg, "packed"):
        pg = pg.take_snps(np.arange(pg.m))
    df = n - p - 1
    if df <= 0:
        raise ValueError("df <= 0 in fvlmm scan")

    from janusx_tpu.utils import devcache

    U32 = devcache.to_device(basis.U, jnp.float32)
    m = pg.m
    block = mesh_step(min(block, m), mesh)
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), mesh=mesh)
    mn = devcache.to_device_blocks(
        pg.mean, (nblk, block), 0.0, dtype=jnp.float32, mesh=mesh
    )
    args = (U32, jnp.asarray(np.stack(Ws)), jnp.asarray(Xr),
            jnp.asarray(np.stack(CWs)), jnp.asarray(np.stack(PYs)))
    if mesh is not None:
        args = devcache.replicate_tree(args, mesh)
        out = np.asarray(_fvlmm_scan_sharded_multi(mesh, n)(pk, mn, *args))
    else:
        out = np.asarray(_fvlmm_scan_resident_multi(pk, mn, *args, n))
    out = out.transpose(0, 2, 1, 3).reshape(3, T, m_pad)
    results = []
    for t in range(T):
        gPy_all, gPg_all, ssq_all = out[0, t, :m], out[1, t, :m], out[2, t, :m]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = gPy_all / gPg_all
            se = np.sqrt((yPys[t] / df) / gPg_all)
        pwald = jstats.pwald_from_beta_se(beta, se)
        beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq_all)
        results.append(ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald,
            extras={"lambda_null": nulls[t].lbd, "reml_null": nulls[t].reml},
        ))
    return results, nulls
