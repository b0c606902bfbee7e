"""Bayes A / B / Cπ marker-effect models — device-resident blocked Gibbs.

Model and priors follow the reference (/root/reference/src/stats/bayes.rs
doc + BGLR-style hyperparameter defaults: r2=0.5, df0_b=5, df0_e=5,
prob_in=0.5, counts=10):

    y = 1μ + Z a + e,  e ~ N(0, σe² I),  Z standardized (n, m)
    BayesA  : a_j ~ N(0, σ_j²),  σ_j² ~ scaled-inv-χ²(df0_b, S0_b)
    BayesB  : δ_j ~ Bern(π) spike-and-slab over the BayesA hierarchy
    BayesCπ : shared slab variance, π ~ Beta-Binomial posterior

Device design (replaces the reference's rayon/BLAS per-marker sweep,
bayes.rs bayesb_core_impl — exact same Markov chain, restructured for a
systolic machine):

- All random draws for a full sweep (normals, uniforms, χ²) are generated
  VECTORIZED once per iteration — no RNG in the sequential chain.
- Markers are processed in blocks of C: per block one (C, n) matvec gives
  the initial right-hand sides, and the within-block sequential updates
  use the precomputed block Gram G_b = Z_b Z_b' (C, C) so each marker
  step is O(C) VPU work instead of O(n); the residual is updated once per
  block with a (C, n) matvec. The serial dependency chain per sweep is m
  steps of ~10 small ops instead of m threefry trees + m length-n dots.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n_iter", "burnin", "thin", "method", "n_blocks"))
def _gibbs(
    Zb,  # (n_blocks, C, n) f32 standardized marker rows, zero-padded
    Gb,  # (n_blocks, C, C) block Grams Z_b Z_b'
    x2,  # (n_blocks, C) per-marker sum of squares (0 for padding)
    y,  # (n,) f64
    key,
    n_iter: int,
    burnin: int,
    thin: int,
    method: str,  # "A" | "B" | "Cpi"
    n_blocks: int,
    n_real: int,  # true sample count (padding excluded by zero rows)
    m_real: int,
    r2=0.5,
    df0_b=5.0,
    df0_e=5.0,
    prob_in=0.5,
    counts=10.0,
):
    f = jnp.float32
    C = Zb.shape[1]
    n = n_real
    m = m_real
    y32 = y.astype(f)
    real = x2 > 0  # (n_blocks, C) mask of non-padding, polymorphic markers
    msx = jnp.sum(x2) / n - 0.0  # standardized, means ~0
    var_y = jnp.var(y32, ddof=1)
    prob_eff = 1.0 if method == "A" else prob_in
    s0_b = var_y * r2 / msx * (df0_b + 2.0) / prob_eff
    var_e0 = var_y * (1.0 - r2)
    s0_e = var_e0 * (df0_e + 2.0)
    counts_in = prob_in * counts
    counts_out = counts - counts_in

    mu0 = jnp.mean(y32)
    beta0 = jnp.zeros((n_blocks, C), f)
    var_b0 = jnp.full((n_blocks, C), s0_b / (df0_b + 2.0), f)
    r0 = jnp.broadcast_to(y32 - mu0, (y32.shape[0],))

    def sweep_block(carry, xs):
        r, var_e, var_slab, pi = carry
        Z1, G1, x21, b_old, vb_old, rn, ru, rca, rci = xs
        hp = jax.lax.Precision.HIGHEST
        rhs0 = jnp.dot(Z1, r, precision=hp) + x21 * b_old  # (C,)

        def inner(j, st):
            b_new, delta_acc = st
            # corrected rhs: subtract Gram-weighted effect changes so far
            corr = jnp.dot(G1[j], b_new - b_old, precision=hp) - G1[j, j] * (
                b_new[j] - b_old[j]
            )
            rhs = rhs0[j] - corr
            vb_eff = vb_old[j] if method in ("A", "B") else var_slab
            Cj = x21[j] / var_e + 1.0 / vb_eff
            mean = rhs / var_e / Cj
            var = 1.0 / Cj
            if method == "A":
                d = jnp.asarray(1.0, f)
            else:
                logbf = 0.5 * (mean * mean / var + jnp.log(var) - jnp.log(vb_eff))
                logit = jnp.log(pi) - jnp.log1p(-pi) + logbf
                d = (ru[j] < jax.nn.sigmoid(logit)).astype(f)
            bj = jnp.where(d > 0, mean + jnp.sqrt(var) * rn[j], 0.0)
            bj = jnp.where(x21[j] > 0, bj, 0.0)
            return b_new.at[j].set(bj), delta_acc.at[j].set(d)

        b_new, delta = jax.lax.fori_loop(
            0, C, inner, (b_old, jnp.zeros((C,), f))
        )
        r = r - jnp.dot(b_new - b_old, Z1, precision=hp)
        if method in ("A", "B"):
            vb_new = jnp.where(
                delta > 0,
                (s0_b + b_new * b_new) / rca,
                s0_b / rci,
            ).astype(f)
            vb_new = jnp.where(x21 > 0, vb_new, s0_b / (df0_b + 2.0))
        else:  # Cpi: var_b is dead state — carry it unchanged
            vb_new = vb_old
        return (r, var_e, var_slab, pi), (b_new, vb_new, delta)

    def iter_body(it, state):
        (mu, r, beta, var_b, var_e, var_slab, pi, key, acc_b, acc_mu,
         n_acc, tr) = state
        key, km, kn, ku, kca, kci, ke, kp, kc = jax.random.split(key, 9)
        # vectorized randoms for the whole sweep
        rn = jax.random.normal(kn, (n_blocks, C), f)
        ru = jax.random.uniform(ku, (n_blocks, C), dtype=f)
        if method in ("A", "B"):
            rca = 2.0 * jax.random.gamma(
                kca, (df0_b + 1.0) / 2.0, (n_blocks, C), f)
            rci = 2.0 * jax.random.gamma(kci, df0_b / 2.0, (n_blocks, C), f)
        else:
            # Cpi uses the shared slab variance only: var_b is never read,
            # so the per-marker scaled-inv-chi2 draws are dead work. kca/kci
            # are independent subkeys — skipping them leaves every other
            # stream (and therefore all Cpi outputs) bitwise unchanged.
            rca = rci = jnp.ones((n_blocks, C), f)
        # intercept
        r_mu = r + mu
        mu_new = (
            jnp.mean(r_mu)
            + jax.random.normal(km, dtype=f) * jnp.sqrt(var_e / n)
        ).astype(f)
        r = r_mu - mu_new
        (r, _, _, _), (beta, var_b, delta) = jax.lax.scan(
            sweep_block,
            (r, var_e, var_slab, pi),
            (Zb, Gb, x2, beta, var_b, rn, ru, rca, rci),
        )
        sse = jnp.dot(r, r, precision=jax.lax.Precision.HIGHEST)
        var_e = (
            (sse + s0_e) / (2.0 * jax.random.gamma(ke, (n + df0_e) / 2.0, (), f))
        ).astype(f)
        n_active = jnp.sum(delta * real)
        if method == "Cpi":
            ssb = jnp.sum(beta * beta)
            var_slab = (
                (ssb + s0_b)
                / (2.0 * jax.random.gamma(kc, (df0_b + n_active) / 2.0, (), f))
            ).astype(f)
        if method in ("B", "Cpi"):
            pi = jax.random.beta(
                kp, counts_in + n_active, counts_out + m - n_active, dtype=f
            )
            pi = jnp.clip(pi, 1e-6, 1.0 - 1e-6)
        take = (it >= burnin) & (((it - burnin) % thin) == 0)
        acc_b = acc_b + jnp.where(take, beta, 0.0)
        acc_mu = acc_mu + jnp.where(take, mu_new, 0.0)
        n_acc = n_acc + jnp.where(take, 1, 0)
        # global-parameter trace (mu, var_e) for multi-chain R-hat
        # convergence diagnostics (reference bayesbench trace mode)
        tr = tr.at[it, 0].set(mu_new)
        tr = tr.at[it, 1].set(var_e)
        return (mu_new, r, beta, var_b, var_e, var_slab, pi, key,
                acc_b, acc_mu, n_acc, tr)

    state0 = (
        mu0, r0, beta0, var_b0, jnp.asarray(var_e0, f),
        jnp.asarray(s0_b / (df0_b + 2.0), f), jnp.asarray(prob_in, f), key,
        jnp.zeros((n_blocks, C), f), jnp.asarray(0.0, f),
        jnp.asarray(0, jnp.int32), jnp.zeros((n_iter, 2), f),
    )
    out = jax.lax.fori_loop(0, n_iter, iter_body, state0)
    acc_b, acc_mu, n_acc, tr = out[8], out[9], out[10], out[11]
    denom = jnp.maximum(n_acc, 1).astype(f)
    return acc_b / denom, acc_mu / denom, tr


@partial(
    jax.jit, static_argnames=("n_iter", "burnin", "thin", "n_blocks")
)
def _gibbs_blocked_a(
    Zb, Gb, x2, y, key, n_iter: int, burnin: int, thin: int, n_blocks: int,
    n_real: int, r2=0.5, df0_b=5.0, df0_e=5.0,
):
    """BayesA via JOINT block updates: each block of C markers is drawn in
    one multivariate-normal step, β_b ~ N(C_b^{-1} rhs, σe² C_b^{-1}) with
    C_b = G_b + σe² D_b^{-1} — a standard blocked-Gibbs scheme with the
    same stationary posterior as the per-marker sweep but m/C serial steps
    per iteration instead of m (each step = one C×C Cholesky + triangular
    solves on device)."""
    f = jnp.float32
    C = Zb.shape[1]
    n = n_real
    y32 = y.astype(f)
    var_y = jnp.var(y32, ddof=1)
    msx = jnp.sum(x2) / n
    s0_b = var_y * r2 / msx * (df0_b + 2.0)
    var_e0 = var_y * (1.0 - r2)
    s0_e = var_e0 * (df0_e + 2.0)
    mu0 = jnp.mean(y32)
    beta0 = jnp.zeros((n_blocks, C), f)
    var_b0 = jnp.full((n_blocks, C), s0_b / (df0_b + 2.0), f)
    r0 = y32 - mu0
    eyeC = jnp.eye(C, dtype=f)

    def sweep_block(carry, xs):
        r, var_e = carry
        Z1, G1, x21, b_old, vb, zdraw, rchi = xs
        hp = jax.lax.Precision.HIGHEST
        rhs = jnp.dot(Z1, r, precision=hp) + jnp.dot(G1, b_old, precision=hp)
        dinv = jnp.where(x21 > 0, var_e / jnp.maximum(vb, 1e-12), 1.0)
        Cb = G1 + jnp.diag(dinv) + 1e-4 * eyeC
        L = jnp.linalg.cholesky(Cb)
        mean = jax.lax.linalg.triangular_solve(
            L, jax.lax.linalg.triangular_solve(
                L, rhs[:, None], left_side=True, lower=True
            ),
            left_side=True, lower=True, transpose_a=True,
        )[:, 0]
        noise = jnp.sqrt(var_e) * jax.lax.linalg.triangular_solve(
            L, zdraw[:, None], left_side=True, lower=True, transpose_a=True
        )[:, 0]
        b_new = jnp.where(x21 > 0, mean + noise, 0.0)
        r = r - jnp.dot(b_new - b_old, Z1, precision=hp)
        vb_new = jnp.where(
            x21 > 0, (s0_b + b_new * b_new) / rchi, s0_b / (df0_b + 2.0)
        ).astype(f)
        return (r, var_e), (b_new, vb_new)

    def iter_body(it, state):
        mu, r, beta, var_b, var_e, key, acc_b, acc_mu, n_acc, tr = state
        key, km, kn, kca, ke = jax.random.split(key, 5)
        zdraws = jax.random.normal(kn, (n_blocks, C), f)
        rchis = 2.0 * jax.random.gamma(kca, (df0_b + 1.0) / 2.0, (n_blocks, C), f)
        r_mu = r + mu
        mu_new = (jnp.mean(r_mu) + jax.random.normal(km, dtype=f)
                  * jnp.sqrt(var_e / n)).astype(f)
        r = r_mu - mu_new
        (r, _), (beta, var_b) = jax.lax.scan(
            sweep_block, (r, var_e), (Zb, Gb, x2, beta, var_b, zdraws, rchis)
        )
        sse = jnp.dot(r, r, precision=jax.lax.Precision.HIGHEST)
        var_e = ((sse + s0_e)
                 / (2.0 * jax.random.gamma(ke, (n + df0_e) / 2.0, (), f))).astype(f)
        take = (it >= burnin) & (((it - burnin) % thin) == 0)
        acc_b = acc_b + jnp.where(take, beta, 0.0)
        acc_mu = acc_mu + jnp.where(take, mu_new, 0.0)
        n_acc = n_acc + jnp.where(take, 1, 0)
        tr = tr.at[it, 0].set(mu_new)
        tr = tr.at[it, 1].set(var_e)
        return (mu_new, r, beta, var_b, var_e, key, acc_b, acc_mu, n_acc, tr)

    state0 = (mu0, r0, beta0, var_b0, jnp.asarray(var_e0, f), key,
              jnp.zeros((n_blocks, C), f), jnp.asarray(0.0, f),
              jnp.asarray(0, jnp.int32), jnp.zeros((n_iter, 2), f))
    out = jax.lax.fori_loop(0, n_iter, iter_body, state0)
    acc_b, acc_mu, n_acc, tr = out[6], out[7], out[8], out[9]
    denom = jnp.maximum(n_acc, 1).astype(f)
    return acc_b / denom, acc_mu / denom, tr


def bayes_fit(
    Z: np.ndarray,  # (n, m) standardized sample-major
    y: np.ndarray,
    method: str,  # "BayesA" | "BayesB" | "BayesCpi"
    n_iter: int = 400,
    burnin: int = 200,
    thin: int = 1,
    seed: int = 0,
    block: int = 128,
    r2: float = 0.5,
    df0_b: float = 5.0,
    df0_e: float = 5.0,
    prob_in: float = 0.5,
    counts: float = 10.0,
    return_trace: bool = False,
):
    """Returns (marker_effects (m,), mu); with ``return_trace`` also the
    (n_iter, 2) per-iteration (mu, var_e) global-parameter trace used for
    multi-chain R-hat diagnostics (reference bayesbench trace mode)."""
    tag = {"BayesA": "A", "BayesB": "B", "BayesCpi": "Cpi"}[method]
    if burnin >= n_iter:
        raise ValueError(
            f"bayes burnin ({burnin}) must be smaller than n_iter "
            f"({n_iter}): no posterior samples would be collected")
    Z = np.asarray(Z, np.float32)
    n, m = Z.shape
    C = min(block, max(8, m))
    n_blocks = -(-m // C)
    m_pad = n_blocks * C
    Zt = np.zeros((m_pad, n), np.float32)
    Zt[:m] = Z.T
    Zb = Zt.reshape(n_blocks, C, n)
    # batched BLAS sgemm — einsum(optimize=False) would run this O(m*C*n)
    # contraction as a scalar loop
    Gb = (Zb @ Zb.transpose(0, 2, 1)).astype(np.float32)
    x2 = (Zb * Zb).sum(axis=2).astype(np.float32)
    if tag == "A":
        # joint block-MVN sampler (same posterior, ~C x fewer serial steps)
        beta, mu, tr = _gibbs_blocked_a(
            jnp.asarray(Zb), jnp.asarray(Gb), jnp.asarray(x2),
            jnp.asarray(y, jnp.float64), jax.random.PRNGKey(seed),
            n_iter, burnin, thin, n_blocks, n,
            r2=r2, df0_b=df0_b, df0_e=df0_e,
        )
    else:
        beta, mu, tr = _gibbs(
            jnp.asarray(Zb),
            jnp.asarray(Gb),
            jnp.asarray(x2),
            jnp.asarray(y, jnp.float64),
            jax.random.PRNGKey(seed),
            n_iter,
            burnin,
            thin,
            tag,
            n_blocks,
            n,
            m,
            r2=r2,
            df0_b=df0_b,
            df0_e=df0_e,
            prob_in=prob_in,
            counts=counts,
        )
    beta = np.asarray(beta, np.float64).reshape(-1)[:m]
    if return_trace:
        return beta, float(mu), np.asarray(tr, np.float64)
    return beta, float(mu)


def bayes_fit_predict(cfg, method, Xml, y, train, test, folds):
    """GS-workflow adapter: CV + final fit + test prediction.

    ``folds`` is a precomputed list of (train_loc, val_loc) index pairs
    (empty = CV disabled)."""
    from janusx_tpu.gs.metrics import regression_metrics

    fold_metrics = []
    oof = np.full(len(train), np.nan)
    for fold, (tr_loc, va_loc) in enumerate(folds):
        t0 = time.monotonic()
        beta, mu = bayes_fit(
            Xml[train[tr_loc]], y[train[tr_loc]], method,
            cfg.bayes_iters, cfg.bayes_burnin, cfg.bayes_thin, cfg.seed + fold,
        )
        pv = mu + Xml[train[va_loc]] @ beta
        oof[va_loc] = pv
        mets = regression_metrics(y[train[va_loc]], pv)
        mets.update(fold=fold, elapsed_sec=round(time.monotonic() - t0, 3))
        fold_metrics.append(mets)
    t1 = time.monotonic()
    beta, mu = bayes_fit(
        Xml[train], y[train], method,
        cfg.bayes_iters, cfg.bayes_burnin, cfg.bayes_thin, cfg.seed,
    )
    test_pred = mu + Xml[test] @ beta if len(test) else np.empty(0)
    info = {"fit_seconds": time.monotonic() - t1, "mu": mu, "beta_std": beta,
            "oof_pred": oof}
    return test_pred, fold_metrics, info
