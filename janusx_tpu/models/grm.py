"""Genomic relationship matrix build, blocked on the device.

Replaces the reference's streamed Rust GRM (/root/reference/src/stats/grm.rs:
block decode -> cblas_dsyrk accumulate) with jit-compiled blocked matmuls:
for each SNP block the packed 2-bit buffer is decoded on device to a
centered (method 1) or standardized (method 2) f32 block C (B, n_pad) and
K_acc += C^T C runs as a device matmul; the accumulator is carried in f64 across
blocks (matmul f32-HIGHEST, accumulate f64 — mirrors the reference's
f32-block/f64-accumulate split).

Definitions (reference src/stats/spgrm.rs:8-22):
  method 1 (cGRM): K = sum_j x_j x_j' / sum_j 2 p_j (1-p_j),  x = g - 2p
  method 2 (sGRM): K = sum_j z_j z_j' / m,  z = x / sqrt(2p(1-p))

Multi-chip: SNP blocks are sharded across the mesh with shard_map; each
device accumulates its local partial K and a single psum (an all-reduce
across the cards) merges them (see janusx_tpu.parallel.mesh).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.ops import decode
from janusx_tpu.parallel.mesh import mesh_step


def _snp_scales(pg: PackedGenotypes, method: int):
    """Per-SNP (mean, inv_sd, var) with monomorphic guard.

    method 1: centered additive; 2: standardized additive;
    3: centered dominance (het indicator — reference grm.rs method 3).
    For method 3 the "mean" is the per-SNP heterozygote frequency and the
    decode swaps to the het-indicator (handled by the caller)."""
    if method == 3:
        from janusx_tpu.io import bitcodec

        nm, alt, het = bitcodec.row_stats(pg.packed, pg.n_samples)
        with np.errstate(divide="ignore", invalid="ignore"):
            hf = np.where(nm > 0, het / nm, 0.0)
        var = hf * (1.0 - hf)
        return hf, np.ones_like(var), var
    p = pg.af
    var = 2.0 * p * (1.0 - p)
    if method == 1:
        inv_sd = np.ones_like(var)
    else:
        with np.errstate(divide="ignore"):
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
    return pg.mean, inv_sd, var


@partial(jax.jit, donate_argnums=(0,), static_argnames=("dom",))
def _grm_accum_step(acc, packed, mean, inv_sd, dom: bool = False):
    if dom:
        c = decode.decode_dominance(packed, mean, dtype=jnp.float32)
    else:
        c = decode.decode_standardized(packed, mean, inv_sd, dtype=jnp.float32)
    part = jnp.dot(c.T, c, precision=jax.lax.Precision.HIGHEST)
    return acc + part.astype(acc.dtype)


# blocks per f32 flush to the f64 accumulator (bounds rounding at
# ~FLUSH·eps32); JX_TPU_GRM_FLUSH overrides
_FLUSH = config.knob("JX_TPU_GRM_FLUSH")


def _grm_core(pk, mn, iv, acc_dtype, dom: bool, axis_name: str | None = None):
    """Whole-matrix GRM body on pre-blocked (n_super, FLUSH, B, K) packed
    rows — ONE dispatch, two-level accumulation.

    Inner level: FLUSH SNP blocks accumulate their C^T C products in f32.
    Outer level: one f64 add per superblock, which keeps f64 work out of
    the per-block loop (the split's cost on the H100 is not measured).

    Under shard_map (``axis_name``) the B axis is the per-device SNP
    slice; partial products merge with ONE psum at the end.
    """
    n_pad = pk.shape[3] * 4

    def inner(acc32, xs):
        p, m, sd = xs
        if dom:
            c = decode.decode_dominance(p, m, dtype=jnp.float32)
        else:
            c = decode.decode_standardized(p, m, sd, dtype=jnp.float32)
        part = jnp.dot(c.T, c, precision=jax.lax.Precision.HIGHEST)
        return acc32 + part, None

    def outer(acc, xs):
        p, m, sd = xs
        acc32 = jnp.zeros((n_pad, n_pad), jnp.float32)
        if axis_name is not None:
            acc32 = jax.lax.pcast(acc32, (axis_name,), to="varying")
        acc32, _ = jax.lax.scan(inner, acc32, (p, m, sd))
        return acc + acc32.astype(acc_dtype), None

    acc0 = jnp.zeros((n_pad, n_pad), dtype=acc_dtype)
    if axis_name is not None:
        acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
    acc, _ = jax.lax.scan(outer, acc0, (pk, mn, iv))
    if axis_name is not None:
        acc = jax.lax.psum(acc, axis_name)
    return acc


@partial(jax.jit, static_argnames=("acc_dtype", "dom"))
def _grm_resident(pk, mn, iv, acc_dtype, dom: bool = False):
    return _grm_core(pk, mn, iv, acc_dtype, dom)


@lru_cache(maxsize=8)
def _grm_sharded(mesh, acc_dtype, dom: bool):
    """SNP-sharded GRM accumulate: each device reduces its SNP rows, one
    psum merges the (n, n) partials."""
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    fn = partial(_grm_core, acc_dtype=acc_dtype, dom=dom, axis_name="snp")
    return jax.jit(
        shard_map(
            fn, mesh=mesh,
            in_specs=(P(None, None, "snp", None), P(None, None, "snp"),
                      P(None, None, "snp")),
            out_specs=P(),
        )
    )


# Packed buffers below this many bytes go device-resident in one dispatch
# (JX_TPU_GRM_RESIDENT_MB).
RESIDENT_LIMIT_BYTES = config.knob("JX_TPU_GRM_RESIDENT_MB") * (1 << 20)


def _fetch_symmetric(acc, n: int, dtype=np.float64, row_block: int = 2048):
    """Download the (n, n) GRM as upper-triangle row blocks and mirror.

    K is symmetric, so fetching only the triangle halves device->host
    bytes (the n=10k f64 matrix is 800 MB). Small matrices (< 32 MB)
    fetch in one piece."""
    if n * n * np.dtype(dtype).itemsize < (32 << 20):
        return np.asarray(acc[:n, :n], dtype=dtype)
    K = np.empty((n, n), dtype)
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        blk = np.asarray(acc[s:e, s:n], dtype=dtype)
        K[s:e, s:n] = blk
        K[s:n, s:e] = blk.T
    return K


def grm_from_packed(
    pg: PackedGenotypes,
    method: int = 1,
    block: int = config.DEFAULT_SNP_BLOCK,
    dtype=np.float64,
    mesh=None,
) -> np.ndarray:
    """Build the dense (n, n) GRM from packed genotypes, streaming SNP blocks.

    Returns float64 host array. With ``mesh``, SNP blocks shard across the
    mesh's 'snp' axis and partial C^T C products merge with one psum.
    """
    if not hasattr(pg, "packed"):
        # disk-backed lazy input (io.windowed.WindowedPacked): stream
        # materialized windows through the resident accumulate, summing
        # the f64 partial K on device (reference analog: streamed GRM,
        # src/stats/grm.rs block decode -> syrk loop)
        n = pg.n_samples
        acc = None
        denom = 0.0
        from janusx_tpu.utils.prefetch import prefetch_iter

        # window k+1's disk IO/decode overlaps window k's device syrk
        # (reference decode/compute double buffering, gblup.rs:27-28)
        for _, _, sub in prefetch_iter(pg.iter_materialized()):
            mean, inv_sd, var = _snp_scales(sub, method)
            blk = mesh_step(min(block, sub.m), mesh)
            nblk = -(-sub.m // blk)
            n_super = -(-nblk // _FLUSH)
            shape = (n_super, _FLUSH, blk)
            from janusx_tpu.utils import devcache

            pk_dev = devcache.device_packed_blocks(sub, shape, mesh=mesh, shard_axis=2)
            mn_dev = devcache.to_device_blocks(
                mean.astype(np.float32), shape, 0.0, dtype=jnp.float32,
                mesh=mesh, shard_axis=2,
            )
            iv_dev = devcache.to_device_blocks(
                inv_sd.astype(np.float32), shape, 0.0, dtype=jnp.float32,
                mesh=mesh, shard_axis=2,
            )
            acc_dtype = jnp.float64 if dtype == np.float64 else jnp.float32
            if mesh is not None:
                part = _grm_sharded(mesh, acc_dtype, method == 3)(pk_dev, mn_dev, iv_dev)
            else:
                part = _grm_resident(pk_dev, mn_dev, iv_dev, acc_dtype, method == 3)
            acc = part if acc is None else acc + part
            denom += float(var.sum()) if method in (1, 3) else float(sub.m)
        if acc is None or denom <= 0:
            raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
        return _fetch_symmetric(acc, n) / denom
    K, denom = grm_partial(pg, method=method, block=block, dtype=dtype,
                           mesh=mesh)
    if denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return K / denom


def grm_partial(
    pg: PackedGenotypes,
    method: int = 1,
    block: int = config.DEFAULT_SNP_BLOCK,
    dtype=np.float64,
    mesh=None,
) -> tuple:
    """Numerator/denominator split of the resident GRM build: the
    UNNORMALIZED (n, n) sum of scaled outer products over pg's SNPs plus
    this slice's denominator contribution (sum of per-SNP variances for
    methods 1/3, SNP count for method 2). Both are additive over disjoint
    SNP slices — the multi-host accumulation contract used by
    parallel.distributed.distributed_grm (each host contributes its
    host_snp_range slice; reference analog: the rayon partial-K merge in
    src/stats/grm.rs, re-expressed as cross-host psum)."""
    mean, inv_sd, var = _snp_scales(pg, method)
    n = pg.n_samples
    packed = decode.pad_packed_cols(pg.packed)
    m = pg.m
    block = mesh_step(min(block, m), mesh)
    acc_dtype = jnp.float64 if dtype == np.float64 else jnp.float32
    mn = mean.astype(np.float32)
    iv = inv_sd.astype(np.float32)
    if packed.nbytes <= RESIDENT_LIMIT_BYTES:
        from janusx_tpu.utils import devcache

        nblk = -(-m // block)
        n_super = -(-nblk // _FLUSH)
        shape = (n_super, _FLUSH, block)
        pk_dev = devcache.device_packed_blocks(pg, shape, mesh=mesh, shard_axis=2)
        mn_dev = devcache.to_device_blocks(
            mn, shape, 0.0, dtype=jnp.float32, mesh=mesh, shard_axis=2
        )
        iv_dev = devcache.to_device_blocks(
            iv, shape, 0.0, dtype=jnp.float32, mesh=mesh, shard_axis=2
        )
        if mesh is not None:
            acc = _grm_sharded(mesh, acc_dtype, method == 3)(pk_dev, mn_dev, iv_dev)
        else:
            acc = _grm_resident(pk_dev, mn_dev, iv_dev, acc_dtype, method == 3)
    else:
        n_pad = packed.shape[1] * 4
        acc = jnp.zeros((n_pad, n_pad), dtype=acc_dtype)
        for s in range(0, m, block):
            e = min(s + block, m)
            pk = packed[s:e]
            mb, ib = mn[s:e], iv[s:e]
            if e - s < block:
                pad = block - (e - s)
                pk = np.concatenate([pk, np.full((pad, pk.shape[1]), 0xFF, np.uint8)])
                mb = np.concatenate([mb, np.zeros(pad, np.float32)])
                ib = np.concatenate([ib, np.zeros(pad, np.float32)])
            acc = _grm_accum_step(
                acc, jnp.asarray(pk), jnp.asarray(mb), jnp.asarray(ib), method == 3
            )
    K = _fetch_symmetric(acc, n)
    denom = float(var.sum()) if method in (1, 3) else float(m)
    return K, denom


def grm_denominator(pg: PackedGenotypes, method: int = 1) -> float:
    """Normalizer matching grm_from_packed's accumulation: method 1
    sum 2p(1-p); method 2 m; method 3 (dominance het-indicator)
    sum hf(1-hf)."""
    if method == 3:
        _, _, var = _snp_scales(pg, 3)
        return float(var.sum())
    if method == 1:
        var = 2.0 * pg.af * (1.0 - pg.af)
        return float(var.sum())
    return float(pg.m)


def grm_strip_from_packed(
    pg: PackedGenotypes,
    rows: np.ndarray,
    method: int = 1,
    block: int = config.DEFAULT_SNP_BLOCK,
) -> np.ndarray:
    """Row strip K[rows, :] of the GRM without materializing the full
    (n, n) matrix — the engine behind GCTA-style -part/-part-group
    builds (reference grm.py -part: dense lower-triangle partitioning
    for n too large for one matrix). Per SNP block the strip accumulates
    C[:, rows]^T @ C; device memory is O(|rows| * n)."""
    rows = np.asarray(rows, np.int64)
    mean, inv_sd, var = _snp_scales(pg, method)
    n = pg.n_samples
    packed = decode.pad_packed_cols(pg.packed)
    m = pg.m
    block = min(block, m)
    rows_d = jnp.asarray(rows, jnp.int32)

    @partial(jax.jit, donate_argnums=(0,), static_argnames=("dom",))
    def step(acc, pk, mn, iv, dom: bool = False):
        if dom:
            c = decode.decode_dominance(pk, mn, dtype=jnp.float32)
        else:
            c = decode.decode_standardized(pk, mn, iv, dtype=jnp.float32)
        part = jnp.dot(c[:, rows_d].T, c,
                       precision=jax.lax.Precision.HIGHEST)
        return acc + part.astype(acc.dtype)

    n_pad = packed.shape[1] * 4
    acc = jnp.zeros((len(rows), n_pad), jnp.float64)
    mn32 = mean.astype(np.float32)
    iv32 = inv_sd.astype(np.float32)
    from janusx_tpu.models.scan_common import pad_rows

    for s in range(0, m, block):
        e = min(s + block, m)
        acc = step(
            acc,
            jnp.asarray(pad_rows(packed[s:e], block, 0xFF)),
            jnp.asarray(pad_rows(mn32[s:e], block)),
            jnp.asarray(pad_rows(iv32[s:e], block)),
            method == 3,
        )
    denom = float(var.sum()) if method in (1, 3) else float(m)
    if denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return np.asarray(acc)[:, :n] / denom


def balanced_part_bounds(n: int, n_parts: int) -> list:
    """GCTA-like work-balanced row partition of the lower triangle:
    row i contributes i+1 cells, so part boundaries equalize cumulative
    i(i+1)/2 shares. Returns [(start, end), ...]."""
    total = n * (n + 1) / 2.0
    bounds = []
    start = 0
    for k in range(1, n_parts + 1):
        target = total * k / n_parts
        # smallest e with e(e+1)/2 >= target
        e = int(np.ceil((-1 + np.sqrt(1 + 8 * target)) / 2))
        e = min(max(e, start + 1), n)
        if k == n_parts:
            e = n
        bounds.append((start, e))
        start = e
    return bounds
