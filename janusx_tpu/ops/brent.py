"""Batched lockstep Brent minimizer.

The reference minimizes -REML per SNP with a scalar Brent
(reference src/math/brent.rs) under rayon row-parallelism. On the device,
per-row dynamic control flow would serialize, so instead ALL SNPs in a
block run the SAME Brent iteration in lockstep: the state is a batch of
(a, c, x, w, v, fx, fw, fv, d, e, done) vectors carried through
``lax.while_loop``, and the objective is evaluated for the whole batch at
once — each iteration is a handful of (B, n) x (n, k) matmuls. Converged
lanes freeze their state via masking; the loop exits when every lane is
done or max_iter is reached.

The bracket/parabolic logic mirrors the reference implementation step for
step (including its quirk of leaving ``e`` untouched on accepted parabolic
steps) so that per-SNP optima match the Rust path to its tolerance.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

_GOLD = 0.3819660


class _BrentState(NamedTuple):
    a: jax.Array
    c: jax.Array
    x: jax.Array
    w: jax.Array
    v: jax.Array
    fx: jax.Array
    fw: jax.Array
    fv: jax.Array
    d: jax.Array
    e: jax.Array
    done: jax.Array
    it: jax.Array


def brent_minimize_batched(
    f: Callable[[jax.Array], jax.Array],
    low: float,
    high: float,
    tol: float,
    max_iter: int,
    init_x: jax.Array | None = None,
    batch_shape: tuple | None = None,
    dtype=jnp.float64,
):
    """Minimize ``f`` elementwise over a batch of scalar lanes in [low, high].

    f maps a (B,) array of positions to a (B,) array of objective values
    (each lane independent). Returns (x_best, f_best), both (B,).
    """
    if batch_shape is None:
        if init_x is None:
            raise ValueError("need init_x or batch_shape")
        batch_shape = init_x.shape
    lo = jnp.asarray(min(low, high), dtype)
    hi = jnp.asarray(max(low, high), dtype)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tol_ = jnp.maximum(jnp.asarray(abs(tol), dtype), 1e-12)

    mid = 0.5 * (lo + hi)
    if init_x is None:
        x0 = jnp.full(batch_shape, mid, dtype)
    else:
        init_x = init_x.astype(dtype)
        ok = jnp.isfinite(init_x) & (init_x >= lo) & (init_x <= hi)
        x0 = jnp.where(ok, init_x, mid)
    fx0 = f(x0)
    zero = jnp.zeros(batch_shape, dtype)
    st = _BrentState(
        a=jnp.full(batch_shape, lo, dtype),
        c=jnp.full(batch_shape, hi, dtype),
        x=x0,
        w=x0,
        v=x0,
        fx=fx0,
        fw=fx0,
        fv=fx0,
        d=zero,
        e=zero,
        done=jnp.zeros(batch_shape, bool),
        it=jnp.zeros((), jnp.int32),
    )

    def cond(st: _BrentState):
        return (st.it < max_iter) & (~jnp.all(st.done))

    def body(st: _BrentState) -> _BrentState:
        a, c, x, w, v, fx, fw, fv, d, e, done = (
            st.a, st.c, st.x, st.w, st.v, st.fx, st.fw, st.fv, st.d, st.e, st.done,
        )
        m = 0.5 * (a + c)
        tol1 = tol_ * jnp.abs(x) + eps
        tol2 = 2.0 * tol1
        newly_done = jnp.abs(x - m) <= tol2 - 0.5 * (c - a)
        done = done | newly_done

        # --- parabolic trial (reference brent.rs:58-92)
        p = (x - v) * ((x - w) * (fx - fv)) - (x - w) * ((x - v) * (fx - fw))
        q = 2.0 * (((x - v) * (fx - fw)) - ((x - w) * (fx - fv)))
        p = jnp.where(q > 0, -p, p)
        q = jnp.abs(q)
        safe_q = jnp.where(jnp.abs(q) > eps, q, 1.0)
        sstep = p / safe_q
        u_try = x + sstep
        par_ok = (
            (jnp.abs(e) > tol1)
            & (jnp.abs(q) > eps)
            & ((u_try - a) >= tol2)
            & ((c - u_try) >= tol2)
            & (jnp.abs(sstep) < 0.5 * jnp.abs(e))
        )
        d_par = sstep
        # clamp if the accepted parabolic u lands too near the bounds
        near_edge = ((x + d_par - a) < tol2) | ((c - (x + d_par)) < tol2)
        d_par = jnp.where(near_edge, jnp.where(x < m, tol1, -tol1), d_par)

        # --- golden fallback (updates e)
        e_gold = jnp.where(x < m, c - x, a - x)
        d_gold = _GOLD * e_gold

        d = jnp.where(par_ok, d_par, d_gold)
        e = jnp.where(par_ok, e, e_gold)
        d = jnp.where(jnp.abs(d) < tol1, jnp.where(d >= 0, tol1, -tol1), d)

        u = x + d
        fu = f(jnp.where(done, x, u))  # frozen lanes re-evaluate at x (discarded)

        better = fu <= fx
        # bracket update
        a_n = jnp.where(better, jnp.where(u >= x, x, a), jnp.where(u >= x, a, u))
        c_n = jnp.where(better, jnp.where(u >= x, c, x), jnp.where(u >= x, u, c))
        # point shuffles
        v_n = jnp.where(better, w, v)
        fv_n = jnp.where(better, fw, fv)
        w_n = jnp.where(better, x, w)
        fw_n = jnp.where(better, fx, fw)
        x_n = jnp.where(better, u, x)
        fx_n = jnp.where(better, fx, fx)  # placeholder, fixed below
        fx_n = jnp.where(better, fu, fx)
        # not-better secondary updates
        repl_w = (~better) & ((fu <= fw) | (w == x))
        v_n = jnp.where(repl_w, w_n, v_n)
        fv_n = jnp.where(repl_w, fw_n, fv_n)
        w_n = jnp.where(repl_w, u, w_n)
        fw_n = jnp.where(repl_w, fu, fw_n)
        repl_v = (~better) & (~repl_w) & ((fu <= fv) | (v == x) | (v == w))
        v_n = jnp.where(repl_v, u, v_n)
        fv_n = jnp.where(repl_v, fu, fv_n)

        keep = done

        def sel(new, old):
            return jnp.where(keep, old, new)

        return _BrentState(
            a=sel(a_n, a), c=sel(c_n, c), x=sel(x_n, x), w=sel(w_n, w),
            v=sel(v_n, v), fx=sel(fx_n, fx), fw=sel(fw_n, fw), fv=sel(fv_n, fv),
            d=sel(d, st.d), e=sel(e, st.e), done=done, it=st.it + 1,
        )

    out = jax.lax.while_loop(cond, body, st)
    return out.x, out.fx
