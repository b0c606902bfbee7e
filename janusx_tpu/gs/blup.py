"""GBLUP / rrBLUP fitting and prediction.

Device redesign of the reference kernels
(/root/reference/src/stats/gblup.rs: streamed GRM -> eigen REML ->
α = (K+λI)^{-1}(y-Xβ) -> cross-kernel predict -> marker back-projection;
src/stats/rrblup.rs: PCG route for large m, exact spectral for small m).

Parameterization: V = vg (K + λ I) with λ = ve/vg; the profiled spectral
REML (janusx_tpu.core.reml) gives λ and vg = rtWr/(n-p). Predictions:
u_s = K[s, t] α. Marker effects (rrBLUP export / back-projection):
a = Z' α / denom with Z the centered (method-1) genotype rows, streamed
through the on-device 2-bit decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.core.reml import fit_null_reml_host
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.ops import decode
from janusx_tpu.ops.cg import cg_solve
from janusx_tpu.utils import devcache

# reference dispatch thresholds (gs/workflow.py:251, :19506; README.md:104-107)
GBLUP_MAX_N = 15_000
RRBLUP_EXACT_MAX_MARKERS = 15_000


@dataclass
class GblupModel:
    train_idx: np.ndarray
    beta: np.ndarray  # fixed effects (intercept [+ covariates])
    alpha: np.ndarray  # (n_train,) kernel weights
    lbd: float
    vg: float
    ve: float
    pve: float
    reml: float


def fit_gblup(
    K: np.ndarray,
    y: np.ndarray,
    train_idx: np.ndarray,
    covariates: np.ndarray | None = None,
    basis=None,
) -> GblupModel:
    """Fit additive GBLUP on the training subset of a dense GRM.

    Runs entirely on host (LAPACK eigh + scipy-Brent REML): at GS fold
    sizes (n <= GBLUP_MAX_N) the device path pays one XLA compile per
    distinct fold shape plus dispatch round-trips against O(n^2) algebra
    (see core.reml.fit_null_reml_host); host against device on the H100
    is not measured. ``basis`` accepts a
    precomputed spectral basis of K[train, train] + 1e-6 I. The knob
    JX_TPU_GS_EIGH32 runs the eigh in f32 (ssyevd, ~2x faster — the fold
    eighs ARE the measured CV wall clock) with the REML itself still in
    f64 on the cast-back spectrum; lambda shifts by ~1e-5 in log10."""
    train_idx = np.asarray(train_idx)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    cov_t = None if covariates is None else np.asarray(covariates)[train_idx]
    if basis is None:
        Ktt = K[np.ix_(train_idx, train_idx)]
        if config.knob("JX_TPU_GS_EIGH32"):
            import scipy.linalg

            from janusx_tpu.core.spectral import SpectralBasis

            Kr = (Ktt + 1e-6 * np.eye(len(train_idx))).astype(np.float32)
            S32, U32 = scipy.linalg.eigh(
                Kr, driver="evd", check_finite=False, overwrite_a=True
            )
            basis = SpectralBasis(
                np.maximum(S32.astype(np.float64), 0.0),
                U32.astype(np.float64),
            )
        else:
            basis = eigh_grm(Ktt, diag_ridge=1e-6)
    n_t = len(train_idx)
    X = np.ones((n_t, 1)) if cov_t is None else np.concatenate(
        [np.ones((n_t, 1)), cov_t], axis=1
    )
    null, beta, vg = fit_null_reml_host(basis.S, basis.U.T @ X, basis.U.T @ y_t)
    ve = null.lbd * vg
    r = y_t - X @ beta
    w = 1.0 / (basis.S + null.lbd)
    alpha = basis.U @ (w * (basis.U.T @ r))
    trace_mean = float(np.clip(basis.S, 0, None).sum() / max(1, n_t))
    pve = vg * trace_mean / (vg * trace_mean + ve) if vg * trace_mean + ve > 0 else 0.0
    return GblupModel(
        train_idx=train_idx, beta=beta, alpha=alpha, lbd=null.lbd,
        vg=vg, ve=ve, pve=pve, reml=null.reml,
    )


def predict_gblup(
    model: GblupModel,
    K: np.ndarray,
    test_idx: np.ndarray,
    covariates: np.ndarray | None = None,
) -> np.ndarray:
    """gebv = X_s β + K[s, t] α."""
    test_idx = np.asarray(test_idx)
    Kst = K[np.ix_(test_idx, model.train_idx)]
    n_s = len(test_idx)
    X = np.ones((n_s, 1)) if covariates is None else np.concatenate(
        [np.ones((n_s, 1)), np.asarray(covariates)[test_idx]], axis=1
    )
    return X @ model.beta + Kst @ model.alpha


@partial(jax.jit, static_argnames=("block",))
def _marker_effects_resident(packed, mean, alpha_pad, block: int):
    """a = Z' α streamed over SNP blocks: (m,) centered-dosage projections."""
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])
    mn = mean.reshape(nblk, block)

    def body(_, xs):
        p, m = xs
        z = decode.decode_centered(p, m, dtype=jnp.float32)
        return None, jnp.dot(z, alpha_pad, precision=jax.lax.Precision.HIGHEST)

    _, eff = jax.lax.scan(body, None, (pk, mn))
    return eff.reshape(-1)


def marker_effects(
    pg_train: PackedGenotypes,
    alpha: np.ndarray,
    denom: float,
    block: int = config.DEFAULT_SNP_BLOCK,
) -> np.ndarray:
    """Back-project kernel weights to per-marker additive effects:
    a = Z'α / denom (reference gblup.rs marker back-projection)."""
    m = pg_train.m
    block = min(block, m)
    m_pad = -(-m // block) * block
    pk = devcache.device_packed(pg_train, m_pad)
    mn = devcache.to_device_padded_rows(pg_train.mean, m_pad, 0.0, dtype=jnp.float32)
    n_pad = pk.shape[1] * 4
    a_pad = np.zeros(n_pad, np.float32)
    a_pad[: pg_train.n] = np.asarray(alpha, np.float32)
    eff = _marker_effects_resident(pk, mn, jnp.asarray(a_pad), block)
    return np.asarray(eff, np.float64)[:m] / denom


@dataclass
class MultiKernelModel:
    train_idx: np.ndarray
    beta: np.ndarray
    Py: np.ndarray  # (n_train,)
    sigma2: dict  # kernel name -> variance
    h2: dict
    kernels: list  # names in order


def fit_gblup_kernels(
    Ks: dict,
    y: np.ndarray,
    train_idx: np.ndarray,
    covariates: np.ndarray | None = None,
) -> MultiKernelModel:
    """Multi-kernel GBLUP (additive + dominance 'ad' mode — reference
    gs/workflow.py GBLUP kernels a/d/ad) via AI-REML.

    Predictions: u_r(test) = σ_r² K_r[test, train] · Py."""
    from janusx_tpu.models.vcomp import RandomTerm, ai_reml

    train_idx = np.asarray(train_idx)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    n_t = len(train_idx)
    cov_t = None if covariates is None else np.asarray(covariates)[train_idx]
    X = np.ones((n_t, 1)) if cov_t is None else np.concatenate(
        [np.ones((n_t, 1)), cov_t], axis=1
    )
    terms = [
        # Z=None: identity incidence — skips the (n_t, n_t) eye and the
        # O(n_t^3) Z @ L identity product per kernel term
        RandomTerm(name=nm, Z=None, K=K[np.ix_(train_idx, train_idx)])
        for nm, K in Ks.items()
    ]
    res = ai_reml(y_t, X, terms)
    return MultiKernelModel(
        train_idx=train_idx, beta=res.blue, Py=res.Py,
        sigma2=res.sigma2, h2=res.h2, kernels=list(Ks.keys()),
    )


def predict_gblup_kernels(
    model: MultiKernelModel,
    Ks: dict,
    test_idx: np.ndarray,
    covariates: np.ndarray | None = None,
) -> np.ndarray:
    test_idx = np.asarray(test_idx)
    n_s = len(test_idx)
    X = np.ones((n_s, 1)) if covariates is None else np.concatenate(
        [np.ones((n_s, 1)), np.asarray(covariates)[test_idx]], axis=1
    )
    pred = X @ model.beta
    for nm in model.kernels:
        Kst = Ks[nm][np.ix_(test_idx, model.train_idx)]
        pred = pred + model.sigma2[nm] * (Kst @ model.Py)
    return pred


@partial(jax.jit, static_argnames=("max_iter",))
def _gblup_cg_solve(Ktt, r, diag, lbd, tol, max_iter: int):
    mv = lambda v: jnp.dot(Ktt, v, precision=jax.lax.Precision.HIGHEST) + lbd * v
    return cg_solve(mv, r, diag_precond=diag, tol=tol, max_iter=max_iter)


def fit_gblup_cg(
    K: np.ndarray,
    y: np.ndarray,
    train_idx: np.ndarray,
    lbd: float,
    covariates: np.ndarray | None = None,
    tol: float | None = None,
    max_iter: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """α via Jacobi-PCG on (K_tt + λI) — the large-n route that avoids the
    O(n^3) eigendecomposition (reference rrblup_pcg/splmm PCG analog).

    Returns (alpha, beta): beta is the OLS fixed-effect fit used to
    residualize y, so callers can form consistent predictions
    X_new @ beta + K[new, train] @ alpha. The solver is a module-level
    jit (lbd/tol traced) — one compile per (shape, max_iter), not per
    call/fold."""
    tol = config.knob("JX_TPU_CG_TOL") if tol is None else tol
    max_iter = config.knob("JX_TPU_CG_MAX_ITER") if max_iter is None else max_iter
    train_idx = np.asarray(train_idx)
    Ktt = jnp.asarray(K[np.ix_(train_idx, train_idx)], jnp.float32)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    n_t = len(train_idx)
    X = np.ones((n_t, 1)) if covariates is None else np.concatenate(
        [np.ones((n_t, 1)), np.asarray(covariates)[train_idx]], axis=1
    )
    beta, *_ = np.linalg.lstsq(X, y_t, rcond=None)
    r = jnp.asarray(y_t - X @ beta, jnp.float32)
    diag = jnp.diag(Ktt) + jnp.float32(lbd)
    res = _gblup_cg_solve(Ktt, r, diag, jnp.float32(lbd), jnp.float32(tol),
                          int(max_iter))
    return np.asarray(res.x, np.float64), np.asarray(beta, np.float64)
