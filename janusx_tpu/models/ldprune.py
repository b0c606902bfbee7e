"""Windowed LD pruning (PLINK --indep-pairwise semantics).

Replaces the reference's SIMD LD-prune kernels
(/root/reference/src/stats/ld.rs: count-window pruning, MAF-priority
variant). Device mapping: correlations for a whole SNP chunk come from ONE
(C, n) x (n, C) device matmul of standardized rows; the greedy window
sweep over the precomputed r² matrix runs on host (tiny).

Greedy rule per window: scan pairs (i < j); if r² > threshold, drop the
member with the smaller MAF (maf-priority, ties drop j).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.ops import decode


@jax.jit
def _corr_chunk(packed, mean):
    z = decode.decode_centered(packed, mean, dtype=jnp.float32)
    norms = jnp.sqrt(jnp.sum(z * z, axis=1))
    zn = z / jnp.maximum(norms, 1e-12)[:, None]
    return jnp.dot(zn, zn.T, precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _r2_chunk_pairwise(packed):
    """Pairwise-complete r² matrix for one packed chunk (the reference falls
    back to r2_pairwise_complete_bitplanes whenever either SNP has missing
    calls — ld.rs:211,357; zero-filled correlations deflate r² and let
    high-LD pairs with missingness slip under the prune threshold).

    All pair statistics restricted to jointly-observed samples come from
    four (C, n) x (n, C) matmuls of dosage/indicator planes.
    """
    hp = jax.lax.Precision.HIGHEST
    codes = decode.unpack_codes(packed)
    obs = (codes != 3).astype(jnp.float32)  # padding cols are code 3
    x = codes.astype(jnp.float32) * obs  # missing -> 0
    x2 = x * x
    N = jnp.dot(obs, obs.T, precision=hp)  # pair counts
    SX = jnp.dot(x, obs.T, precision=hp)  # sum x_i over joint obs
    SXY = jnp.dot(x, x.T, precision=hp)
    SXX = jnp.dot(x2, obs.T, precision=hp)  # sum x_i^2 over joint obs
    cov = N * SXY - SX * SX.T
    var_i = N * SXX - SX * SX
    denom = var_i * var_i.T
    return jnp.where(denom > 0, (cov * cov) / jnp.maximum(denom, 1e-30), 0.0)


def r2_matrix(pg: PackedGenotypes) -> np.ndarray:
    """Full pairwise r² matrix of a (small) packed subset — the shared LD
    kernel behind region plots and -ldblock heatmaps. Pairwise-complete
    when any marker has missing calls (reference ld.rs semantics)."""
    import jax.numpy as jnp

    packed = decode.pad_packed_cols(pg.packed)
    if np.any(pg.miss > 0):
        return np.asarray(_r2_chunk_pairwise(jnp.asarray(packed)))
    r = np.asarray(_corr_chunk(
        jnp.asarray(packed), jnp.asarray(pg.mean.astype(np.float32))
    ))
    return r * r


def ld_prune(
    pg: PackedGenotypes,
    window: int = 50,
    step: int = 5,
    r2_threshold: float = 0.2,
    chunk: int = 4096,
    window_bp: int | None = None,
) -> np.ndarray:
    """Returns indices of SNPs kept.

    `window` counts variants; `window_bp` (reference gformat kb/bp
    suffixes, gformat.py:_parse_prune_window) switches to a physical
    window — each anchor's window spans the SNPs within window_bp
    downstream of its position.
    """
    m = pg.m
    if m == 0:
        return np.empty(0, np.int64)
    step = max(1, int(step))
    pos = np.asarray(pg.sites.pos, np.int64)
    if window_bp is not None:
        window_bp = max(1, int(window_bp))
    else:
        window = max(2, int(window))
    removed = np.zeros(m, dtype=bool)
    packed = decode.pad_packed_cols(pg.packed)
    maf = pg.af

    # process per chromosome (windows never span chromosomes)
    chrom = pg.sites.chrom
    boundaries = [0]
    for i in range(1, m):
        if chrom[i] != chrom[i - 1]:
            boundaries.append(i)
    boundaries.append(m)

    for c0, c1 in zip(boundaries[:-1], boundaries[1:]):
        if window_bp is not None:
            # widest physical window on this chromosome, in variants
            ends = np.searchsorted(pos[c0:c1], pos[c0:c1] + window_bp, "right")
            max_extent = int(np.max(ends - np.arange(c1 - c0))) if c1 > c0 else 1
            ov = max(2, max_extent)
        else:
            ov = window
        s = c0
        while s < c1:
            e = min(s + chunk, c1)
            # include window overlap to the right
            e_ov = min(e + ov, c1)
            if np.any(pg.miss[s:e_ov] > 0):
                r2 = np.asarray(_r2_chunk_pairwise(jnp.asarray(packed[s:e_ov])))
            else:
                r = np.asarray(
                    _corr_chunk(
                        jnp.asarray(packed[s:e_ov]),
                        jnp.asarray(pg.mean[s:e_ov].astype(np.float32)),
                    )
                )
                r2 = r * r
            local_removed = removed[s:e_ov].copy()
            w0 = 0
            limit = e_ov - s
            while w0 < (e - s):
                if window_bp is not None:
                    w1 = min(int(np.searchsorted(
                        pos[s:e_ov], pos[s + w0] + window_bp, "right")), limit)
                else:
                    w1 = min(w0 + window, limit)
                if w1 <= w0 + 1:
                    # no in-window neighbor: the reference keeps the anchor
                    # untested (ld.rs `if end <= li + 1 { continue; }`)
                    w0 += step
                    continue
                for i in range(w0, w1):
                    if local_removed[i]:
                        continue
                    for j in range(i + 1, w1):
                        if local_removed[j]:
                            continue
                        if r2[i, j] > r2_threshold:
                            gi, gj = s + i, s + j
                            if maf[gi] < maf[gj]:
                                local_removed[i] = True
                                break
                            local_removed[j] = True
                w0 += step
            removed[s:e_ov] |= local_removed
            s = e
    return np.nonzero(~removed)[0]


def ld_clump(
    pg: PackedGenotypes,
    chrom: np.ndarray,
    pos: np.ndarray,
    pvals: np.ndarray,
    thr: float,
    window_bp: int = 250_000,
    r2_cut: float = 0.5,
):
    """PLINK-style LD clumping of significant hits (reference postgwas
    -LDclump WINDOW R2): walk hits by ascending p; each unclaimed index
    SNP claims every unclaimed significant SNP within +-window_bp on the
    same chromosome with r^2 >= r2_cut against the INDEX genotype
    (pairwise-complete r, same missingness convention as r2_matrix).

    ``chrom``/``pos``/``pvals`` come from the assoc TSV; markers are
    matched to ``pg`` by (chrom, pos) — unmatched hits clump by position
    only (r^2 treated as 1 inside the window, flagged in the output).

    Returns a list of dicts: lead assoc-row index, chrom, pos, p,
    members (assoc-row indices incl. the lead), n_genotyped.
    """
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos, np.int64)
    pvals = np.asarray(pvals, np.float64)
    sig = np.nonzero(np.isfinite(pvals) & (pvals < thr))[0]
    if sig.size == 0:
        return []
    sig = sig[np.argsort(pvals[sig], kind="stable")]

    geno_row = {}
    if pg is not None:
        # match only the significant hits against the panel (the panel is
        # biobank-sized; a per-marker Python dict would dominate wall
        # time): lexsort the panel (chrom, pos) keys once, searchsorted
        # each hit
        pchrom = pg.sites.chrom.astype(str)
        ppos = np.asarray(pg.sites.pos, np.int64)
        order = np.lexsort((ppos, pchrom))
        sc, sp = pchrom[order], ppos[order]
        hc, hp = chrom[sig], pos[sig]
        lo = np.searchsorted(sc, hc, side="left")
        hi = np.searchsorted(sc, hc, side="right")
        for i, l, h, p_want in zip(sig, lo, hi, hp):
            k = l + np.searchsorted(sp[l:h], p_want, side="left")
            if k < h and sp[k] == p_want:
                geno_row[int(i)] = int(order[k])

    claimed: set = set()
    clumps = []
    for i in sig:
        i = int(i)
        if i in claimed:
            continue
        near = sig[
            (chrom[sig] == chrom[i])
            & (np.abs(pos[sig] - pos[i]) <= window_bp)
        ]
        cand = [int(j) for j in near if int(j) not in claimed and int(j) != i]
        members = [i]
        gi = geno_row.get(i)
        if gi is not None and cand:
            cand_g = [c for c in cand if c in geno_row]
            if cand_g:
                rows = pg.take_snps(
                    np.asarray([gi] + [geno_row[c] for c in cand_g]))
                Z = rows.centered()
                Zs = Z - Z.mean(axis=1, keepdims=True)
                nrm = np.sqrt((Zs * Zs).sum(axis=1))
                nrm[nrm == 0] = 1.0
                r = (Zs[1:] @ Zs[0]) / (nrm[1:] * nrm[0])
                for c, rv in zip(cand_g, r):
                    if rv * rv >= r2_cut:
                        members.append(c)
            # hits absent from the genotype panel stay unclaimed
        elif gi is None:
            # no genotype for the index: claim the whole window by
            # position (flagged via n_genotyped=0)
            members.extend(cand)
        claimed.update(members)
        clumps.append({
            "lead": i, "chrom": chrom[i], "pos": int(pos[i]),
            "p": float(pvals[i]), "members": members,
            "n_genotyped": int(gi is not None),
        })
    return clumps
