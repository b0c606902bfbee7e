"""Signed feature hashing (count-sketch) of the marker matrix — the GS
``-hash`` preprocessing.

Reference: /root/reference/src/stats/packed.rs bed_packed_signed_hash_f32
(splitmix64 bucket+sign per SNP row :24-41, bucket accumulation :930-1060,
output normalized so the hashed GRM has mean diagonal 1) wired in
gs/workflow.py _hash_packed_for_gs (:17720; CLI -hash, defaults
dim=2048 seed=520 :19199).

Each kept SNP row j gets a deterministic (bucket b_j, sign s_j) from
splitmix64(seed, j); the sketch is H[b] = sum_{j: b_j=b} s_j z_j with
z the centered (or standardized) genotype row. E[H H'] equals the GRM
numerator, so GS models fit on the D-dimensional H instead of m markers.

Device mapping: per SNP block, the (B, D) signed one-hot matrix S turns the
bucket scatter into H += S^T C — two device matmuls per block instead of the
reference's rayon per-bucket row loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.ops import decode
from janusx_tpu.utils import devcache

DEFAULT_HASH_DIM = config.knob("JX_TPU_HASH_DIM")  # reference gs/workflow.py:19207
DEFAULT_HASH_SEED = config.knob("JX_TPU_HASH_SEED")

_M1 = np.uint64(0x9E3779B97F4A7C15)
_M2 = np.uint64(0xBF58476D1CE4E5B9)
_M3 = np.uint64(0x94D049BB133111EB)
_SIGN_K = np.uint64(0x517CC1B727220A95)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (reference packed.rs:24-31), wrapping u64."""
    with np.errstate(over="ignore"):
        x = (x + _M1).astype(np.uint64)
        z = x
        z = ((z ^ (z >> np.uint64(30))) * _M2).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(27))) * _M3).astype(np.uint64)
        return (z ^ (z >> np.uint64(31))).astype(np.uint64)


def hash_bucket_sign(seed: int, row_idx: np.ndarray, n_buckets: int):
    """Exact mirror of signed_hash_bucket_sign (packed.rs:33-41):
    bucket = splitmix64(seed ^ (j * M1)) % D,
    sign from splitmix64((seed + K) ^ rotl(j * M1, 17)) parity."""
    seed = np.uint64(seed)
    j = np.asarray(row_idx, np.uint64)
    with np.errstate(over="ignore"):
        key = (j * _M1).astype(np.uint64)
        bucket = _splitmix64(seed ^ key) % np.uint64(n_buckets)
        rot = ((key << np.uint64(17)) | (key >> np.uint64(47))).astype(np.uint64)
        h_sign = _splitmix64((seed + _SIGN_K).astype(np.uint64) ^ rot)
    sign = np.where((h_sign & np.uint64(1)) == 0, 1.0, -1.0).astype(np.float32)
    return bucket.astype(np.int32), sign


@partial(jax.jit, static_argnames=("n_buckets",))
def _hash_accum(pk, mn, iv, bucket, sign, n_buckets: int):
    """Streamed sketch: per block decode (B, n) + signed one-hot (B, D)
    -> H += S^T C on the device. Dropped rows carry sign 0."""
    hi = jax.lax.Precision.HIGHEST

    def step(acc, xs):
        p, m, sd, b, s = xs
        c = decode.decode_standardized(p, m, sd, dtype=jnp.float32)
        S = jax.nn.one_hot(b, n_buckets, dtype=jnp.float32) * s[:, None]
        return acc + jnp.dot(S.T, c, precision=hi), None

    n_pad = pk.shape[-1] * 4
    acc0 = jnp.zeros((n_buckets, n_pad), jnp.float32)
    acc, _ = jax.lax.scan(step, acc0, (pk, mn, iv, bucket, sign))
    return acc


def signed_hash_features(
    pg,
    n_buckets: int = DEFAULT_HASH_DIM,
    seed: int = DEFAULT_HASH_SEED,
    standardize: bool = True,
    min_maf: float = 0.0,
    max_missing: float = 1.0,
    block: int = config.DEFAULT_SNP_BLOCK,
):
    """Hash the packed genotype matrix into (n, D) signed-sketch features.

    Returns (H (n_samples, n_buckets) f32, scale, kept_snps). H is
    normalized so mean(diag(H H^T)) = 1 (reference scale semantics,
    packed.rs:1060)."""
    if n_buckets <= 0:
        raise ValueError("hash dim must be > 0")
    m, n = pg.m, pg.n_samples
    af = np.asarray(pg.af, np.float64)
    maf = np.minimum(af, 1.0 - af)
    keep = np.isfinite(maf) & (maf >= min_maf) & (maf <= 0.5)
    miss = np.asarray(getattr(pg, "miss", np.zeros(m)), np.float64)
    keep &= np.isfinite(miss) & (miss <= max_missing)
    var = 2.0 * maf * (1.0 - maf)
    if standardize:
        keep &= var > 1e-12
        inv_sd = np.where(keep, 1.0 / np.sqrt(np.maximum(var, 1e-12)), 0.0)
    else:
        inv_sd = np.where(keep, 1.0, 0.0)
    kept = int(keep.sum())
    if kept == 0:
        raise ValueError(
            "No SNPs left after signed-hash filters; relax min_maf/max_missing."
        )
    bucket, sign = hash_bucket_sign(seed, np.arange(m), n_buckets)
    sign = np.where(keep, sign, 0.0).astype(np.float32)

    blk = min(block, m)
    nblk = -(-m // blk)
    shape = (nblk, blk)
    pk = devcache.device_packed_blocks(pg, shape)
    mn = devcache.to_device_blocks(
        pg.mean.astype(np.float32), shape, 0.0, dtype=jnp.float32
    )
    iv = devcache.to_device_blocks(
        inv_sd.astype(np.float32), shape, 0.0, dtype=jnp.float32
    )
    bk = devcache.to_device_blocks(bucket, shape, 0, dtype=jnp.int32)
    sg = devcache.to_device_blocks(sign, shape, 0.0, dtype=jnp.float32)
    H = np.asarray(_hash_accum(pk, mn, iv, bk, sg, n_buckets))[:, :n]
    if not standardize:
        # reference hashes RAW dosages (missing -> mean_g) when !standardize
        # (packed.rs:1016-1022); the kernel accumulates centered values, and
        # raw = centered + mean_g uniformly across samples, so the bucket
        # sketch differs by the constant column sum(sign_j * mean_j)
        offs = np.zeros(n_buckets, np.float64)
        np.add.at(offs, bucket[keep], sign[keep].astype(np.float64) * pg.mean[keep])
        H = H + offs[:, None].astype(np.float32)
    mean_diag = float(np.mean(np.sum(H.astype(np.float64) ** 2, axis=0)))
    scale = np.sqrt(mean_diag)
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0
    else:
        H = H / np.float32(scale)
    return H.T.copy(), float(scale), kept
