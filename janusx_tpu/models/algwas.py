"""ALGWAS: adaptive-lasso two-stage GWAS.

Functional re-design of the reference's `-algwas` route
(/root/reference/src/stats/algwas.rs: stage-1 lasso path with EBIC
selection — 64 path steps, λ_min ratio 1e-3, standardized design — then a
stage-2 conditional scan).

Device mapping: the reference's active-set coordinate-descent path becomes a
FISTA proximal-gradient path run entirely on device — one jit, lax.scan
over λ steps with warm starts; each inner iteration is two (m, n) device
matmuls. EBIC(γ=0.5) selects the path point; stage 2 re-scans all markers
with the selected set as covariates (pseudo-QTN p-values from their joint
model, as in FarmCPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.models.lm import lm_scan
from janusx_tpu.models.farmcpu import _decode_rows, _qtn_tests
from janusx_tpu.models.scan_common import ScanResult

PATH_STEPS = 64
LAMBDA_MIN_RATIO = 1e-3
EBIC_GAMMA = 0.5


@partial(jax.jit, static_argnames=("n_steps", "inner_iters"))
def _lasso_path(Zt, y, lambdas, n_steps: int, inner_iters: int = 150):
    """FISTA over a λ path with warm starts.

    Zt: (m, n) standardized marker rows; y: (n,) centered.
    Returns betas (n_steps, m) and rss (n_steps,).
    """
    m, n = Zt.shape
    hp = jax.lax.Precision.HIGHEST
    # Lipschitz bound: power iteration on Z'Z
    v = jnp.ones((m,), jnp.float32) / jnp.sqrt(m)

    def pw(_, v):
        w = jnp.dot(jnp.dot(v, Zt, precision=hp), Zt.T, precision=hp)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-12)

    v = jax.lax.fori_loop(0, 30, pw, v)
    L = jnp.maximum(
        jnp.linalg.norm(jnp.dot(jnp.dot(v, Zt, precision=hp), Zt.T, precision=hp)),
        1e-6,
    )
    step = 1.0 / L

    def fista(beta0, lam):
        def body(i, st):
            b, z, t = st
            resid = jnp.dot(z, Zt, precision=hp) - y  # (n,)
            grad = jnp.dot(Zt, resid, precision=hp)  # (m,)
            b_new = z - step * grad
            b_new = jnp.sign(b_new) * jnp.maximum(jnp.abs(b_new) - step * lam, 0.0)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            z_new = b_new + ((t - 1.0) / t_new) * (b_new - b)
            return b_new, z_new, t_new

        b, _, _ = jax.lax.fori_loop(
            0, inner_iters, body, (beta0, beta0, jnp.asarray(1.0, jnp.float32))
        )
        return b

    def scan_body(beta, lam):
        b = fista(beta, lam)
        resid = jnp.dot(b, Zt, precision=hp) - y
        rss = jnp.dot(resid, resid, precision=hp)
        return b, (b, rss)

    beta0 = jnp.zeros((m,), jnp.float32)
    _, (betas, rss) = jax.lax.scan(scan_body, beta0, lambdas)
    return betas, rss


def active_set_polish(
    Zs: np.ndarray, r: np.ndarray, lam: float, b0: np.ndarray,
    max_iter: int = 500, tol: float = 1e-10,
) -> np.ndarray:
    """Exact coordinate descent on the active set (reference
    src/math/active_path.rs role: CD restricted to the current support).

    FISTA's fixed iteration budget leaves tiny non-zero coefficients and
    slightly biased values; polishing the EBIC-selected path point with
    exact CD drives true zeros to zero (sharper support) and satisfies
    the KKT conditions on the support. The support is small (q <= a few
    hundred), so f64 host CD is exact and effectively free."""
    Zs = np.asarray(Zs, np.float64)
    b = np.asarray(b0, np.float64).copy()
    resid = r - Zs.T @ b
    d = np.einsum("qn,qn->q", Zs, Zs)
    d = np.where(d > 0, d, 1.0)
    for _ in range(max_iter):
        delta = 0.0
        for j in range(len(b)):
            rho = Zs[j] @ resid + d[j] * b[j]
            bj = np.sign(rho) * max(abs(rho) - lam, 0.0) / d[j]
            if bj != b[j]:
                resid += Zs[j] * (b[j] - bj)
                delta = max(delta, abs(bj - b[j]))
                b[j] = bj
        if delta < tol:
            break
    return b


@dataclass
class AlgwasResult:
    result: ScanResult
    selected: np.ndarray  # stage-1 selected marker indices
    ebic_path: np.ndarray
    lambda_path: np.ndarray


def algwas_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    path_steps: int = PATH_STEPS,
    max_selected: int = 200,
    block: int = config.DEFAULT_SNP_BLOCK,
    pg_qtn: PackedGenotypes | None = None,
    mesh=None,
) -> AlgwasResult:
    """pg_qtn (reference -qbfile/-qvcf/...): an alternate panel for the
    stage-1 lasso QTN search; the stage-2 conditional scan still runs on
    the main panel. `selected` then indexes the QTN panel.

    ``mesh``: jax.sharding.Mesh with a 'snp' axis — the stage-2
    conditional scan (the O(m) hot pass) SNP-shards across the mesh;
    the reference runs both stages under its full thread plan
    (src/stats/algwas.rs)."""
    y = np.asarray(y, np.float64).reshape(-1)
    pgq = pg if pg_qtn is None else pg_qtn
    n, m = pg.n, pgq.m
    if pgq.n != pg.n:
        raise ValueError("QTN-search panel sample count differs from the main panel")
    # residualize y on [1, covariates] (stage 1 operates on the centered scale)
    X = np.ones((n, 1)) if covariates is None else np.concatenate(
        [np.ones((n, 1)), np.asarray(covariates, np.float64)], axis=1
    )
    b0, *_ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ b0

    var = 2.0 * pgq.af * (1.0 - pgq.af)
    inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
    Zt = (pgq.centered() * inv_sd[:, None]).astype(np.float32)  # (m, n)
    rj = jnp.asarray(r, jnp.float32)
    Ztj = jnp.asarray(Zt)
    lam_max = float(np.abs(Zt @ r).max())
    lambdas = jnp.asarray(
        np.geomspace(lam_max * 0.98, lam_max * LAMBDA_MIN_RATIO, path_steps),
        jnp.float32,
    )
    betas, rss = _lasso_path(Ztj, rj, lambdas, path_steps)
    betas = np.asarray(betas)
    rss = np.asarray(rss, np.float64)
    k = (np.abs(betas) > 1e-8).sum(axis=1)
    with np.errstate(divide="ignore"):
        ebic = (
            n * np.log(np.maximum(rss, 1e-12) / n)
            + k * np.log(n)
            + 2.0 * EBIC_GAMMA * k * np.log(max(m, 2))
        )
    ebic = np.where(k <= max_selected, ebic, np.inf)
    best = int(np.argmin(ebic))
    support = np.nonzero(np.abs(betas[best]) > 1e-8)[0]
    if len(support):
        # exact active-set CD polish at the chosen λ, then re-evaluate the
        # support and EBIC from the polished solution
        b_pol = active_set_polish(
            Zt[support].astype(np.float64), r,
            float(lambdas[best]), betas[best][support],
        )
        keep = np.abs(b_pol) > 1e-8
        selected = support[keep]
        resid = r - Zt[support].astype(np.float64).T @ b_pol
        rss_pol = float(resid @ resid)
        kq = int(keep.sum())
        ebic[best] = (
            n * np.log(max(rss_pol, 1e-12) / n)
            + kq * np.log(n)
            + 2.0 * EBIC_GAMMA * kq * np.log(max(m, 2))
        )
    else:
        selected = support

    # stage 2: conditional LM scan with selected markers as covariates
    cov2 = covariates
    if len(selected):
        Zsel = _decode_rows(pgq, selected).T
        cov2 = Zsel if cov2 is None else np.concatenate([cov2, Zsel], axis=1)
    res = lm_scan(pg, y, cov2, block=block, mesh=mesh)
    if len(selected) and pg_qtn is None:
        # QTN rows get conditional refit stats only when they live in the
        # scanned panel (indices refer to the QTN panel otherwise)
        res.beta[selected], res.se[selected], res.pwald[selected] = (
            _qtn_tests(pg, y, covariates, selected))
    return AlgwasResult(
        result=res, selected=selected, ebic_path=ebic,
        lambda_path=np.asarray(lambdas, np.float64),
    )
