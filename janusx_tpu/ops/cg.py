"""Jacobi-preconditioned conjugate gradient (device-resident).

Device replacement for the reference's PCG solver
(/root/reference/src/math/pcg.rs: Jacobi-preconditioned CG with streamed
GRM·v products): the matvec is a jit-traceable callable, so callers can
pass a dense on-device kernel product or a streamed decode-matmul over
packed genotype blocks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CgResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    rel_res: jax.Array


def cg_solve(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    diag_precond: jax.Array | None = None,
    tol: float = 1e-8,
    max_iter: int = 500,
    x0: jax.Array | None = None,
) -> CgResult:
    """Solve A x = b for SPD A. All state stays on device; traceable."""
    b = jnp.asarray(b)
    minv = 1.0 / diag_precond if diag_precond is not None else jnp.ones_like(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = minv * r
    p = z
    rz = jnp.vdot(r, z)
    bnorm = jnp.linalg.norm(b)
    bnorm = jnp.where(bnorm > 0, bnorm, 1.0)

    def cond(state):
        x, r, z, p, rz, it = state
        return (it < max_iter) & (jnp.linalg.norm(r) / bnorm > tol)

    def body(state):
        x, r, z, p, rz, it = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    x, r, z, p, rz, it = jax.lax.while_loop(cond, body, (x, r, z, p, rz, 0))
    return CgResult(x=x, iters=it, rel_res=jnp.linalg.norm(r) / bnorm)
