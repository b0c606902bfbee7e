"""FastPop / ADMIXTURE-style ancestry decomposition.

Device re-design of the reference's adamixture engine
(/root/reference/src/stats/adamixture.rs: EM + Adam updates of P/Q over
streamed BED log-likelihood, RSVD init, CV error;
python/janusx/adamixture/core.py train_adamixture).

Model: binomial likelihood of dosages g_ij in {0,1,2}
    L = Σ_ij [ g_ij ln f_ij + (2 - g_ij) ln(1 - f_ij) ],  F = Q P
with Q (n, K) on the simplex per sample and P (K, m) in (0, 1).

Both reference solvers run as single jitted device loops over 2-bit
packed SNP blocks (missing genotypes contribute zero):

- "adam-em" (the reference default): each iteration computes the closed-
  form EM target (p_em, q_em) with device matmul contractions and feeds the
  EM delta through Adam moments — the reference's Adam-accelerated-EM
  update (adamixture.rs em_step_packed_f32_impl /
  adam_optimize_packed_*_impl), with clip-to-[1e-5,1-1e-5], Q-row
  renormalization, best-loglik keeping and lr decay on non-improvement.
- "adam": full-likelihood Adam on softmax(Q)/sigmoid(P) logits via
  autodiff — replacing the hand-written Rust update kernels wholesale.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.ops import decode
from janusx_tpu.utils import devcache

_EPS = 1e-6


_EM_EPS = 1e-5  # reference EPS32/EPS64 clip bound (adamixture.rs:49-59)


@dataclass
class AdmixtureFit:
    Q: np.ndarray  # (n, K) ancestry fractions
    P: np.ndarray  # (K, m) allele frequencies
    loglik: float
    loglik_path: np.ndarray
    n_iter: int
    solver: str = "adam"


def _block_loglik(params, pk, n: int):
    """Negative loglik contribution of one packed SNP block."""
    qlogit, plogit = params
    Q = jax.nn.softmax(qlogit, axis=1)  # (n, K)
    codes = decode.unpack_codes(pk)[:, :n]  # (B, n)
    g = codes.astype(jnp.float32)
    mask = (codes != 3).astype(jnp.float32)
    Pb = jax.nn.sigmoid(plogit)  # (B, K)
    F = jnp.clip(
        jnp.dot(Pb, Q.T, precision=jax.lax.Precision.HIGHEST), _EPS, 1.0 - _EPS
    )  # (B, n)
    ll = mask * (g * jnp.log(F) + (2.0 - g) * jnp.log1p(-F))
    return -jnp.sum(ll)


@partial(jax.jit, static_argnames=("n", "block", "n_iter", "lr", "tol",
                                   "check_every"))
def _train(qlogit0, plogit0, packed, n: int, block: int, n_iter: int,
           lr: float, tol: float = 0.0, check_every: int = 0):
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])

    def loss_fn(qlogit, plogit):
        def body(acc, xs):
            pkb, plb = xs
            return acc + _block_loglik((qlogit, plb), pkb, n), None

        pl = plogit.reshape(nblk, block, -1)
        total, _ = jax.lax.scan(body, jnp.asarray(0.0, jnp.float32), (pk, pl))
        return total

    # Adam state
    def adam_update(g, m_, v_, t):
        b1, b2, eps = 0.9, 0.999, 1e-8
        m_ = b1 * m_ + (1 - b1) * g
        v_ = b2 * v_ + (1 - b2) * g * g
        mhat = m_ / (1 - b1**t)
        vhat = v_ / (1 - b2**t)
        return mhat / (jnp.sqrt(vhat) + eps), m_, v_

    def step(state):
        i, ql, pl, mq, vq, mp, vp, lls, last_ll, done = state
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(ql, pl)
        gq, gp = grads
        t = (i + 1).astype(jnp.float32)
        dq, mq, vq = adam_update(gq, mq, vq, t)
        dp, mp, vp = adam_update(gp, mp, vp, t)
        ql = ql - lr * dq
        pl = pl - lr * dp
        ll = -loss
        lls = lls.at[i].set(ll)
        if check_every > 0:
            # reference -check/-tol: test relative log-likelihood
            # improvement every check_every iterations, stop when < tol
            do_check = ((i + 1) % check_every) == 0
            rel = jnp.abs(ll - last_ll) / (jnp.abs(last_ll) + 1.0)
            done = do_check & (i + 1 >= 2 * check_every) & (rel < tol)
            last_ll = jnp.where(do_check, ll, last_ll)
        return i + 1, ql, pl, mq, vq, mp, vp, lls, last_ll, done

    def cond(state):
        i, *_, done = state
        return (i < n_iter) & (~done)

    z = lambda x: jnp.zeros_like(x)
    state0 = (
        jnp.asarray(0, jnp.int32),
        qlogit0, plogit0, z(qlogit0), z(qlogit0), z(plogit0), z(plogit0),
        jnp.zeros((n_iter,), jnp.float32),
        jnp.asarray(-jnp.inf, jnp.float32), jnp.asarray(False),
    )
    n_done, ql, pl, *_, lls, _last, _done = jax.lax.while_loop(
        cond, step, state0)
    return ql, pl, lls, n_done


def _em_targets_and_loglik(p, q, pk_blocks, n: int):
    """One EM sweep (reference em_step_packed_f32_impl semantics,
    adamixture.rs:5434+): returns (p_em (m_pad,K), t (n,K), loglik).

    Per cell aa = g/f, bb = (2-g)/(1-f) with f = p·q clipped to
    [1e-6, 1-1e-6]; per SNP j: a_k = Σ_i q_ik aa, b_k = Σ_i q_ik bb,
    p_em = a p / (p(a-b)+b); per sample i: t_ik = Σ_j p_jk(aa-bb)+bb, and
    q_em = q·t / (2·n_obs) (the caller divides and renormalizes). Missing
    cells (code 3, incl. SNP-row padding) contribute zero everywhere; a
    fully padded row has denom 0 and keeps p_em = p. All contractions are
    (B,n)x(n,K) / (B,n)^T x (B,K) device matmuls."""

    def body(carry, xs):
        t_acc, ll_acc = carry
        pkb, pb = xs  # (B, bytes), (B, K)
        codes = decode.unpack_codes(pkb)[:, :n]  # (B, n)
        g = codes.astype(jnp.float32)
        mask = (codes != 3)
        F = jnp.clip(
            jnp.dot(pb, q.T, precision=jax.lax.Precision.HIGHEST),
            _EPS, 1.0 - _EPS)  # (B, n)
        AA = jnp.where(mask, g / F, 0.0)
        BB = jnp.where(mask, (2.0 - g) / (1.0 - F), 0.0)
        a = jnp.dot(AA, q, precision=jax.lax.Precision.HIGHEST)  # (B, K)
        b = jnp.dot(BB, q, precision=jax.lax.Precision.HIGHEST)
        denom = pb * (a - b) + b
        p_em_b = jnp.where(jnp.abs(denom) < 1e-8, pb, a * pb / denom)
        d = AA - BB  # (B, n)
        t_acc = t_acc + (
            jnp.dot(d.T, pb, precision=jax.lax.Precision.HIGHEST)
            + BB.sum(axis=0)[:, None]
        )
        ll_b = jnp.sum(jnp.where(
            mask, g * jnp.log(F) + (2.0 - g) * jnp.log1p(-F), 0.0))
        return (t_acc, ll_acc + ll_b), p_em_b

    K = q.shape[1]
    (t, ll), p_em = jax.lax.scan(
        body,
        (jnp.zeros((n, K), jnp.float32), jnp.asarray(0.0, jnp.float32)),
        (pk_blocks, p),
    )
    return p_em, t, ll


@partial(jax.jit, static_argnames=("n", "block", "n_iter", "lr", "tol",
                                  "check_every", "lr_decay", "min_lr"))
def _train_adam_em(p0, q0, packed, nobs2, n: int, block: int, n_iter: int,
                   lr: float, tol: float, check_every: int,
                   lr_decay: float = 0.5, min_lr: float = 1e-6):
    """Adam-accelerated EM (reference solver "adam-em", the default:
    adamixture.rs adam_optimize_packed_*_impl): each iteration computes
    the EM target (p_em, q_em) and feeds the EM DELTA through Adam
    moments (beta1=0.80, beta2=0.88 per ADAMixtureConfig), clips to
    [1e-5, 1-1e-5], renormalizes Q rows, and every `check_every`
    iterations keeps the best-loglik (p, q), decays the lr on
    non-improvement (x lr_decay, floor min_lr, stop after 2 misses) and
    stops when the relative improvement drops below tol."""
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])
    b1, b2, eps = 0.80, 0.88, 1e-8

    def em(p, q):
        pb = p.reshape(nblk, block, -1)
        p_em, t, ll = _em_targets_and_loglik(pb, q, pk, n)
        p_em = p_em.reshape(p.shape)
        q_em = jnp.clip(q * t / nobs2[:, None], _EM_EPS, 1.0 - _EM_EPS)
        qs = q_em.sum(axis=1, keepdims=True)
        K = q.shape[1]
        q_em = jnp.where(
            (qs <= 0) | ~jnp.isfinite(qs), 1.0 / K, q_em / qs)
        return p_em, q_em, ll

    def adam(delta, m_, v_, t_step, lr_cur):
        m_ = b1 * m_ + (1 - b1) * delta
        v_ = b2 * v_ + (1 - b2) * delta * delta
        mhat = m_ / (1 - b1 ** t_step)
        vhat = v_ / (1 - b2 ** t_step)
        return lr_cur * mhat / (jnp.sqrt(vhat) + eps), m_, v_

    def step(state):
        (i, p, q, mp, vp, mq, vq, lr_cur, ll_best, p_best, q_best,
         no_imp, lls, done) = state
        p_in, q_in = p, q
        p_em, q_em, ll = em(p, q)  # ll is at the PRE-update (p, q)
        t_step = (i + 1).astype(jnp.float32)
        dp, mp, vp = adam(p_em - p, mp, vp, t_step, lr_cur)
        dq, mq, vq = adam(q_em - q, mq, vq, t_step, lr_cur)
        p = jnp.clip(p + dp, _EM_EPS, 1.0 - _EM_EPS)
        q = jnp.clip(q + dq, _EM_EPS, 1.0 - _EM_EPS)
        qs = q.sum(axis=1, keepdims=True)
        q = jnp.where((qs <= 0) | ~jnp.isfinite(qs), 1.0 / q.shape[1], q / qs)
        lls = lls.at[i].set(ll)
        if check_every > 0:
            do_check = ((i + 1) % check_every) == 0
            improved = ll > ll_best
            rel = jnp.abs(ll - ll_best) / (jnp.abs(ll_best) + 1.0)
            converged = do_check & (i + 1 >= 2 * check_every) & (rel < tol)
            keep = do_check & improved
            # save the state the loglik was EVALUATED at (pre-update)
            p_best = jnp.where(keep, p_in, p_best)
            q_best = jnp.where(keep, q_in, q_best)
            new_no_imp = jnp.where(
                do_check, jnp.where(improved, 0, no_imp + 1), no_imp)
            lr_next = jnp.where(
                do_check & ~improved,
                jnp.maximum(lr_cur * lr_decay, min_lr), lr_cur)
            ll_best = jnp.where(keep, ll, ll_best)
            done = converged | (new_no_imp >= 2)
            no_imp, lr_cur = new_no_imp, lr_next
        else:
            p_best, q_best = p, q
        return (i + 1, p, q, mp, vp, mq, vq, lr_cur, ll_best, p_best,
                q_best, no_imp, lls, done)

    def cond(state):
        i, *_, done = state
        return (i < n_iter) & (~done)

    z = lambda x: jnp.zeros_like(x)
    state0 = (
        jnp.asarray(0, jnp.int32), p0, q0, z(p0), z(p0), z(q0), z(q0),
        jnp.asarray(lr, jnp.float32), jnp.asarray(-jnp.inf, jnp.float32),
        p0, q0, jnp.asarray(0, jnp.int32),
        jnp.zeros((n_iter,), jnp.float32), jnp.asarray(False),
    )
    (n_done, p, q, _mp, _vp, _mq, _vq, _lr, ll_best, p_best, q_best,
     _ni, lls, _done) = jax.lax.while_loop(cond, step, state0)
    # return the best-seen (p, q) when checks ran, else the last iterate —
    # and the loglik THAT STATE was evaluated at, so AdmixtureFit.loglik
    # always describes the returned parameters
    use_best = jnp.isfinite(ll_best)
    p = jnp.where(use_best, p_best, p)
    q = jnp.where(use_best, q_best, q)
    return p, q, lls, n_done, ll_best


def train_admixture(
    pg: PackedGenotypes,
    n_pops: int,
    n_iter: int = 300,
    lr: float | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    seed: int = 0,
    rsvd_init: bool = True,
    tol: float = 0.0,
    check_every: int = 0,
    solver: str = "adam",
) -> AdmixtureFit:
    n, m, K = pg.n, pg.m, int(n_pops)
    if K < 2:
        raise ValueError("n_pops must be >= 2")
    rng = np.random.default_rng(seed)
    block = min(block, m)
    m_pad = -(-m // block) * block
    pk = devcache.device_packed(pg, m_pad)

    # init: RSVD PCs -> kmeans-ish soft assignment, P from af
    qlogit0 = rng.normal(0, 0.1, size=(n, K)).astype(np.float32)
    if rsvd_init and K > 1:
        try:
            from janusx_tpu.models.pca import rsvd_pca

            _, pcs = rsvd_pca(pg, n_pc=min(K - 1, 8), block=block)
            # soft clusters from quantile splits of PC1..; simple + stable
            z = (pcs - pcs.mean(0)) / (pcs.std(0) + 1e-9)
            centers = z[rng.choice(n, K, replace=False)]
            d2 = ((z[:, None, :] - centers[None]) ** 2).sum(-1)
            qlogit0 = (-0.5 * d2).astype(np.float32)
        except Exception:
            pass
    af = np.clip(pg.af, 0.02, 0.98)
    p0 = np.clip(
        af[:, None] + rng.normal(0, 0.05, size=(m, K)), 0.02, 0.98
    )
    plogit0 = np.log(p0 / (1 - p0)).astype(np.float32)
    plogit0 = np.concatenate(
        [plogit0, np.zeros((m_pad - m, K), np.float32)], axis=0
    )

    solver = {"auto": "adam-em"}.get(solver, solver)
    if solver not in ("adam", "adam-em"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "adam-em":
        # reference ADAMixtureConfig adam-em defaults (core.py:120-125)
        lr_em = 0.005 if lr is None else lr
        q0 = jax.nn.softmax(jnp.asarray(qlogit0), axis=1)
        p0 = jax.nn.sigmoid(jnp.asarray(plogit0))
        nobs2 = 2.0 * (pg.dosages() >= 0).sum(axis=0).astype(np.float32)
        nobs2 = np.maximum(nobs2, 1.0)
        p_fit, q_fit, lls, n_done, ll_best = _train_adam_em(
            jnp.clip(p0, _EM_EPS, 1 - _EM_EPS),
            jnp.clip(q0, _EM_EPS, 1 - _EM_EPS),
            pk, jnp.asarray(nobs2), n, block, n_iter, lr_em,
            tol=float(tol), check_every=int(check_every),
        )
        Q = np.asarray(q_fit, np.float64)
        Q /= Q.sum(axis=1, keepdims=True)
        P = np.asarray(p_fit, np.float64)[:m].T
        fit_ll = float(ll_best) if np.isfinite(float(ll_best)) else None
    else:
        fit_ll = None
        ql, pl, lls, n_done = _train(
            jnp.asarray(qlogit0), jnp.asarray(plogit0), pk, n, block, n_iter,
            0.05 if lr is None else lr,
            tol=float(tol), check_every=int(check_every),
        )
        Q = np.asarray(jax.nn.softmax(ql, axis=1), np.float64)
        P = np.asarray(jax.nn.sigmoid(pl), np.float64)[:m].T
    n_done = int(n_done)
    lls = np.asarray(lls, np.float64)[:n_done]
    if fit_ll is None:
        fit_ll = float(lls[-1]) if n_done else float("nan")
    return AdmixtureFit(
        Q=Q, P=P, loglik=fit_ll,
        loglik_path=lls, n_iter=n_done, solver=solver,
    )


def cv_error(
    pg: PackedGenotypes,
    n_pops: int,
    holdout_frac: float = 0.1,
    seed: int = 0,
    **kwargs,
) -> float:
    """ADMIXTURE-style CV: mask a random subset of genotype cells, fit, and
    measure binomial deviance on the held-out cells (host evaluation)."""
    rng = np.random.default_rng(seed)
    d = pg.dosages().astype(np.float64)
    obs = d >= 0
    hold = obs & (rng.random(d.shape) < holdout_frac)
    codes = d.copy()
    codes[hold] = -1
    from janusx_tpu.io.gdata import GenotypeData
    from janusx_tpu.io.packed import QcParams, pack_genotypes

    gd = GenotypeData(codes.astype(np.int8), pg.sites, pg.samples)
    pg_masked = pack_genotypes(gd, QcParams(maf=0.0, geno=1.0))
    if pg_masked.m != pg.m:
        raise RuntimeError("cv mask unexpectedly dropped SNP rows")
    fit = train_admixture(pg_masked, n_pops, seed=seed, **kwargs)
    F = np.clip(fit.P.T @ fit.Q.T, 1e-6, 1 - 1e-6)  # (m, n)
    # masking can push alt_freq past 0.5, so the re-pack may flip rows:
    # the fitted frequency then models 2-g; map back to pg's coding
    flipped = pg_masked.sites.allele1 != pg.sites.allele1
    F[flipped] = 1.0 - F[flipped]
    g = d[hold]
    f = F[hold]
    dev = -np.mean(g * np.log(f) + (2 - g) * np.log1p(-f))
    return float(dev)


def write_admixture_outputs(prefix: str, samples, fit: AdmixtureFit) -> None:
    K = fit.Q.shape[1]
    with open(f"{prefix}.{K}.Q", "wt") as fh:
        for i, s in enumerate(samples):
            fh.write(" ".join(f"{v:.6f}" for v in fit.Q[i]) + "\n")
    with open(f"{prefix}.{K}.P", "wt") as fh:
        for j in range(fit.P.shape[1]):
            fh.write(" ".join(f"{fit.P[k, j]:.6f}" for k in range(K)) + "\n")
