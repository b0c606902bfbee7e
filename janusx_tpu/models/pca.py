"""PCA of the genotype matrix: GRM-eigh route and randomized SVD route.

Replaces the reference's `jx pca` (python/janusx/script/pca.py: eigh of
GRM via LAPACK, or streamed RSVD src/stats/rsvd.rs:1-28).

RSVD on the device: the sketch Y = A Ω, power iterations Y <- A (A' Y), and the
final projection are all blocked matmuls against the on-device packed
genotypes — the standardized SNP-major matrix A is (m, n), so every
product streams SNP blocks through the 2-bit decode exactly like the GRM
build. Output convention matches the reference: eigenvectors scaled by
sqrt(eigenvalue) are NOT applied; {prefix}.eigenvec rows are samples.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.grm import _snp_scales
from janusx_tpu.ops import decode
from janusx_tpu.utils import devcache


def pca_from_grm(K: np.ndarray, n_pc: int = 10):
    """Top-k PCs from a precomputed GRM. Returns (eigvals desc, eigvecs)."""
    basis = eigh_grm(K, diag_ridge=0.0)
    vals = basis.S[::-1][:n_pc]
    vecs = basis.U[:, ::-1][:, :n_pc]
    return vals, vecs


@partial(jax.jit, static_argnames=("block",))
def _rsvd_av(packed, mean, inv_sd, V, block: int):
    """A' (A V): two streamed passes fused in one scan; A is (m, n_pad)."""
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])
    mn = mean.reshape(nblk, block)
    iv = inv_sd.reshape(nblk, block)

    def body(acc, xs):
        p, m, s = xs
        a = decode.decode_standardized(p, m, s, dtype=jnp.float32)  # (B, n_pad)
        av = jnp.dot(a, V, precision=jax.lax.Precision.HIGHEST)  # (B, k)
        return acc + jnp.dot(a.T, av, precision=jax.lax.Precision.HIGHEST), None

    k = V.shape[1]
    acc0 = jnp.zeros((packed.shape[1] * 4, k), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, (pk, mn, iv))
    return acc


def rsvd_pca(
    pg: PackedGenotypes,
    n_pc: int = 10,
    oversample: int = 10,
    power_iters: int = 4,
    method: int = 2,
    seed: int = 0,
    block: int = config.DEFAULT_SNP_BLOCK,
):
    """Randomized PCA of the standardized genotype matrix.

    Computes the top eigenpairs of K = A'A/denom (A = standardized (m, n))
    via subspace iteration on device. Returns (eigvals desc (k,), PCs
    (n, k)).
    """
    n = pg.n_samples
    k = min(n_pc + oversample, n)
    mean, inv_sd, var = _snp_scales(pg, method)
    m = pg.m
    block = min(block, m)
    m_pad = -(-m // block) * block
    pk = devcache.device_packed(pg, m_pad)
    mn = devcache.to_device_padded_rows(pg.mean, m_pad, 0.0, dtype=jnp.float32)
    iv = devcache.to_device_padded_rows(
        inv_sd.astype(np.float32), m_pad, 0.0, dtype=jnp.float32
    )
    n_pad = pk.shape[1] * 4
    rng = np.random.default_rng(seed)
    V = np.zeros((n_pad, k), np.float32)
    V[:n] = rng.normal(size=(n, k)).astype(np.float32)
    V = jnp.asarray(V)
    for _ in range(power_iters):
        W = _rsvd_av(pk, mn, iv, V, block)
        # orthonormalize on host in f64 (small: n x k)
        Q, _ = np.linalg.qr(np.asarray(W, np.float64))
        V = jnp.asarray(Q.astype(np.float32))
    W = np.asarray(_rsvd_av(pk, mn, iv, V, block), np.float64)  # = K_unnorm V
    Vh = np.asarray(V, np.float64)
    B = Vh.T @ W  # (k, k) projected operator
    B = 0.5 * (B + B.T)
    evals, evecs = np.linalg.eigh(B)
    order = np.argsort(evals)[::-1][:n_pc]
    denom = float(var.sum()) if method == 1 else float(m)
    vals = evals[order] / denom
    vecs = (Vh @ evecs[:, order])[:n]
    return vals, vecs


def write_pca_outputs(prefix: str, sample_ids, vals, vecs) -> None:
    """{prefix}.eigenvec / {prefix}.eigenval in reference layout."""
    with open(prefix + ".eigenval", "wt") as fh:
        for v in vals:
            fh.write(f"{v:.6g}\n")
    with open(prefix + ".eigenvec", "wt") as fh:
        for i, sid in enumerate(sample_ids):
            cols = "\t".join(f"{vecs[i, j]:.6g}" for j in range(vecs.shape[1]))
            fh.write(f"{sid}\t{cols}\n")
