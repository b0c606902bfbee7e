"""Distribution tails and p-value sanitization.

P-value rules mirror the reference exactly
(/root/reference/src/math/linalg.rs:99-108 sanitize; src/stats/lmm.rs
pwald = 2*normal_sf(|beta/se|) clamped to [f64::MIN_POSITIVE, 1]):

- non-finite beta/se or se<=0  ->  p = 1.0
- finite p clamped to [DBL_MIN, 1.0]

Both numpy (host finalize) and jnp (in-kernel) versions are provided.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from scipy import special as sp_special

_DBL_MIN = np.finfo(np.float64).tiny


# ---------------------------------------------------------------- numpy side
def normal_sf(z: np.ndarray) -> np.ndarray:
    return 0.5 * sp_special.erfc(np.asarray(z) / np.sqrt(2.0))


def chi2_sf_df1(x: np.ndarray) -> np.ndarray:
    return sp_special.erfc(np.sqrt(np.maximum(np.asarray(x), 0.0) / 2.0))


def pwald_from_beta_se(beta: np.ndarray, se: np.ndarray) -> np.ndarray:
    """2-sided Wald p with reference sanitize rules."""
    beta = np.asarray(beta, dtype=np.float64)
    se = np.asarray(se, dtype=np.float64)
    ok = np.isfinite(beta) & np.isfinite(se) & (se > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.abs(beta / np.where(ok, se, 1.0))
    p = 2.0 * normal_sf(z)
    p = np.clip(p, _DBL_MIN, 1.0)
    return np.where(ok & np.isfinite(p), p, 1.0)


def sanitize_pvalue(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    return np.where(np.isfinite(p), np.clip(p, _DBL_MIN, 1.0), 1.0)


def plrt_from_ml(ml: np.ndarray, null_ml: float) -> np.ndarray:
    """LRT p from per-SNP ML loglik vs null ML (reference src/stats/lmm.rs:186)."""
    stat = 2.0 * (np.asarray(ml, dtype=np.float64) - null_ml)
    stat = np.where(np.isfinite(stat) & (stat > 0), stat, 0.0)
    p = chi2_sf_df1(stat)
    return np.where(np.isfinite(np.asarray(ml, dtype=np.float64)), p, 1.0)


# ------------------------------------------------------------------ jnp side
def normal_sf_jnp(z):
    return 0.5 * jax_erfc(z / jnp.sqrt(jnp.asarray(2.0, z.dtype)))


def jax_erfc(x):
    import jax.scipy.special as jsp

    return jsp.erfc(x)


def chi2_sf_df1_jnp(x):
    import jax.scipy.special as jsp

    return jsp.erfc(jnp.sqrt(jnp.maximum(x, 0.0) / 2.0))


def pwald_from_beta_se_device(beta, se):
    """Device Wald p with the reference sanitize rules (f64 lanes).

    The erfc runs in f32 (the f32/f64 split predates the H100 port; its
    cost there is not measured); the returned p is f64. For |z| where p underflows f32 (~1e-38, i.e.
    -log10 p > 37.9) the host fallback recomputes exactly — callers keep
    the numpy path for lanes with p at the f32 floor.
    """
    beta = beta.astype(jnp.float64)
    se = se.astype(jnp.float64)
    ok = jnp.isfinite(beta) & jnp.isfinite(se) & (se > 0)
    z = jnp.abs(beta / jnp.where(ok, se, 1.0))
    p = (2.0 * normal_sf_jnp(z.astype(jnp.float32))).astype(jnp.float64)
    p = jnp.clip(p, _DBL_MIN, 1.0)
    return jnp.where(ok & jnp.isfinite(p), p, 1.0)
