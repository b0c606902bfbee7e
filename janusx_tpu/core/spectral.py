"""Eigendecomposition of the GRM and spectral rotation.

Replaces the reference's LAPACK dsyevd/dsyevr wrappers
(/root/reference/src/math/eigh.rs) and the Python EVD stage
(python/janusx/assoc/workflow.py:5509 ``_gwas_eigh_from_grm``,
diag_ridge=1e-6 on the GRM diagonal before decomposition).

Backends:
- "host": scipy.linalg.eigh in float64 (LAPACK dsyevd) — default for
  n <= ~20k, mirrors the reference's accuracy; U then ships to device once.
- "device": jnp.linalg.eigh — useful when the GRM already lives in
  device memory.

Rotation convention: K = U diag(S) U^T with S ascending; rotated vectors
are U^T v; rotated SNP-major genotype blocks are G @ U (device matmul).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg


@dataclass
class SpectralBasis:
    """Eigenbasis of the (ridged) GRM restricted to analysis samples."""

    S: np.ndarray  # (n,) eigenvalues, ascending
    U: np.ndarray  # (n, n) eigenvectors (columns)

    @property
    def n(self) -> int:
        return len(self.S)

    def rotate_vec(self, v: np.ndarray) -> np.ndarray:
        return self.U.T @ np.asarray(v, dtype=np.float64)

    def rotate_mat(self, X: np.ndarray) -> np.ndarray:
        return self.U.T @ np.asarray(X, dtype=np.float64)


def eigh_grm(
    K: np.ndarray,
    diag_ridge: float = 1e-6,
    backend: str | None = None,
) -> SpectralBasis:
    if backend is None:
        from janusx_tpu import config

        backend = config.choice_knob("JX_TPU_EIGH_BACKEND", ("host", "device"))
    K = np.asarray(K, dtype=np.float64)
    if diag_ridge:
        K = K + diag_ridge * np.eye(K.shape[0])
    if backend == "device":
        S, U = jnp.linalg.eigh(jnp.asarray(K))
        return SpectralBasis(np.asarray(S, np.float64), np.asarray(U, np.float64))
    S, U = scipy.linalg.eigh(
        K, driver="evd", check_finite=False, overwrite_a=bool(diag_ridge)
    )
    return SpectralBasis(S, U)


def rotate_genotype_block(
    g_block: jax.Array, U: jax.Array, precision=jax.lax.Precision.HIGHEST
) -> jax.Array:
    """Rotate a decoded SNP-major block: (B, n) @ (n, n) -> (B, n) on device."""
    return jnp.dot(g_block, U, precision=precision)
