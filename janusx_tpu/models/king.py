"""KING-robust relatedness and unrelated-set pruning.

Replaces the reference's KING module (/root/reference/src/math/KING.rs:
KING-robust estimates from bitplanes, related-pair graph, unrelated-set
pruning).

KING-robust estimator between samples i, j over jointly observed sites:

    φ_ij = (N_het,het − 2·N_opposing_hom) / (N_het_i + N_het_j)

All pair counts are indicator matmuls on device (het/hom planes, one
(n, m) x (m, n) product each), exactly like the IBS distance kernel.
Default relatedness threshold 0.0884 (2nd-degree cutoff).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config
from janusx_tpu.io.packed import PackedGenotypes
from janusx_tpu.ops import decode
from janusx_tpu.utils import devcache

DEGREE2_THRESHOLD = 0.0884  # kinship > 2^-3.5 -> 2nd degree or closer


@partial(jax.jit, static_argnames=("block",))
def _king_counts(packed, block: int):
    nblk = packed.shape[0] // block
    pk = packed.reshape(nblk, block, packed.shape[1])
    hp = jax.lax.Precision.HIGHEST

    def body(carry, pkb):
        hh, opp, het_shared_i = carry
        codes = decode.unpack_codes(pkb)
        obs = (codes != 3).astype(jnp.float32)
        h = (codes == 1).astype(jnp.float32)
        a0 = (codes == 0).astype(jnp.float32)
        a2 = (codes == 2).astype(jnp.float32)
        hh = hh + jnp.dot(h.T, h, precision=hp)
        o = jnp.dot(a0.T, a2, precision=hp)
        opp = opp + o + o.T
        # het count of sample i over sites observed in j
        het_shared_i = het_shared_i + jnp.dot(h.T, obs, precision=hp)
        return (hh, opp, het_shared_i), None

    n_pad = packed.shape[1] * 4
    z = jnp.zeros((n_pad, n_pad), jnp.float32)
    (hh, opp, hsi), _ = jax.lax.scan(body, (z, z, z), pk)
    return hh, opp, hsi


def king_kinship(pg: PackedGenotypes, block: int = config.DEFAULT_SNP_BLOCK):
    """(n, n) KING-robust kinship matrix (diagonal set to 0.5)."""
    m = pg.m
    block = min(block, m)
    m_pad = -(-m // block) * block
    pk = devcache.device_packed(pg, m_pad)
    hh, opp, hsi = _king_counts(pk, block)
    n = pg.n
    hh = np.asarray(hh, np.float64)[:n, :n]
    opp = np.asarray(opp, np.float64)[:n, :n]
    hsi = np.asarray(hsi, np.float64)[:n, :n]
    denom = hsi + hsi.T
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = np.where(denom > 0, (hh - 2.0 * opp) / denom, 0.0)
    np.fill_diagonal(phi, 0.5)
    return phi


def unrelated_set(
    phi: np.ndarray, threshold: float = DEGREE2_THRESHOLD
) -> np.ndarray:
    """Greedy max-independent-set pruning: repeatedly drop the sample with
    the most relatives above threshold (reference king_unrelated_set)."""
    n = phi.shape[0]
    adj = (phi > threshold).astype(np.int64)
    np.fill_diagonal(adj, 0)
    alive = np.ones(n, dtype=bool)
    deg = adj.sum(axis=1)
    while True:
        deg_alive = np.where(alive, deg, -1)
        worst = int(np.argmax(deg_alive))
        if deg_alive[worst] <= 0:
            break
        alive[worst] = False
        deg = deg - adj[:, worst]
    return np.nonzero(alive)[0]


@partial(jax.jit, static_argnames=("block",))
def _king_counts_pair(pk_i, pk_j, block: int):
    """Pairwise KING counts between two sample tiles: per SNP block,
    indicator matmuls between tile-i planes and tile-j planes (the matmul is
    the device's popcount — reference KING.rs bitplane AND-popcounts)."""
    nblk = pk_i.shape[0] // block
    pi = pk_i.reshape(nblk, block, pk_i.shape[1])
    pj = pk_j.reshape(nblk, block, pk_j.shape[1])
    hp = jax.lax.Precision.HIGHEST

    def body(carry, xs):
        hh, opp, hsi, hsj = carry
        bi, bj = xs
        ci = decode.unpack_codes(bi)
        cj = decode.unpack_codes(bj)
        obs_i = (ci != 3).astype(jnp.float32)
        obs_j = (cj != 3).astype(jnp.float32)
        h_i = (ci == 1).astype(jnp.float32)
        h_j = (cj == 1).astype(jnp.float32)
        a0_i = (ci == 0).astype(jnp.float32)
        a2_i = (ci == 2).astype(jnp.float32)
        a0_j = (cj == 0).astype(jnp.float32)
        a2_j = (cj == 2).astype(jnp.float32)
        hh = hh + jnp.dot(h_i.T, h_j, precision=hp)
        opp = opp + jnp.dot(a0_i.T, a2_j, precision=hp) + jnp.dot(
            a2_i.T, a0_j, precision=hp
        )
        hsi = hsi + jnp.dot(h_i.T, obs_j, precision=hp)
        hsj = hsj + jnp.dot(obs_i.T, h_j, precision=hp)
        return (hh, opp, hsi, hsj), None

    ti = pk_i.shape[1] * 4
    tj = pk_j.shape[1] * 4
    z = jnp.zeros((ti, tj), jnp.float32)
    (hh, opp, hsi, hsj), _ = jax.lax.scan(body, (z, z, z, z), (pi, pj))
    denom = hsi + hsj
    phi = jnp.where(denom > 0, (hh - 2.0 * opp) / denom, 0.0)
    return phi


@partial(jax.jit, static_argnames=("block", "cap", "same"))
def _king_pair_sparse(pk_i, pk_j, threshold, block: int, cap: int, same: bool):
    """Tile-pair kinship, thresholded ON DEVICE: only (row, col, phi) of
    pairs above threshold leave HBM (the dense tile never crosses the
    host link — at biobank n the download would dominate otherwise)."""
    phi = _king_counts_pair(pk_i, pk_j, block)
    if same:  # keep strict upper triangle only
        ti = phi.shape[0]
        iu = jnp.arange(ti)
        phi = jnp.where(iu[:, None] < iu[None, :], phi, 0.0)
    mask = phi > threshold
    count = mask.sum()
    r, c = jnp.nonzero(mask, size=cap, fill_value=-1)
    vals = jnp.where(r >= 0, phi[jnp.maximum(r, 0), jnp.maximum(c, 0)], 0.0)
    return count, r, c, vals


def king_related_pairs(
    pg: PackedGenotypes,
    threshold: float = DEGREE2_THRESHOLD,
    tile: int = 8192,
    block: int = config.DEFAULT_SNP_BLOCK,
):
    """Biobank-scale KING: sample-tile x sample-tile sweep with
    thresholded sparse output — never materializes the (n, n) kinship.
    Memory is O(tile^2) device + O(related pairs) host (related pairs are
    sparse in cohort data). Returns (i_idx, j_idx, phi) arrays with i < j.

    Reference analog: king_unrelated_set_from_bed's streaming pair graph
    (src/math/KING.rs)."""
    from janusx_tpu.io import bitcodec

    n = pg.n
    m = pg.m
    block = min(block, m)
    m_pad = -(-m // block) * block
    tile = min(tile, n)
    tiles = [np.arange(s, min(s + tile, n)) for s in range(0, n, tile)]
    # per-tile packed columns, row-padded once; the LAST tile is padded to
    # the full tile width with all-missing samples (denominator 0 -> phi 0)
    # so every tile pair shares ONE compiled program
    packs = []
    nb_tile = (tile + 3) // 4
    for idx in tiles:
        sub = bitcodec.subset_columns(pg.packed, n, idx)
        if sub.shape[1] < nb_tile:
            sub = np.concatenate(
                [sub, np.full((sub.shape[0], nb_tile - sub.shape[1]), 0xFF,
                              np.uint8)], axis=1,
            )
        if m_pad != m:
            sub = np.concatenate(
                [sub, np.full((m_pad - m, sub.shape[1]), 0xFF, np.uint8)]
            )
        packs.append(jnp.asarray(decode.pad_packed_cols(sub)))
    # per-tile-pair capacity for device-side sparse extraction; related
    # pairs are sparse in cohort data (reference prunes to 2nd degree)
    cap = max(4096, 16 * tile)
    ii, jj, vv = [], [], []
    for a in range(len(tiles)):
        for b in range(a, len(tiles)):
            count, r, c, vals = _king_pair_sparse(
                packs[a], packs[b], threshold, block, cap, a == b
            )
            count = int(count)
            if count > cap:
                # overflow (heavily related block): dense fallback
                phi = np.asarray(_king_counts_pair(packs[a], packs[b], block))
                phi = phi[: len(tiles[a]), : len(tiles[b])]
                if a == b:
                    phi = np.triu(phi, k=1)
                r, c = np.nonzero(phi > threshold)
                vals = phi[r, c]
            else:
                r = np.asarray(r)[:count]
                c = np.asarray(c)[:count]
                vals = np.asarray(vals)[:count]
                keep_rc = (r < len(tiles[a])) & (c < len(tiles[b]))
                r, c, vals = r[keep_rc], c[keep_rc], vals[keep_rc]
            if len(r):
                ii.append(tiles[a][r])
                jj.append(tiles[b][c])
                vv.append(np.asarray(vals, np.float64))
    if not ii:
        z = np.empty(0, np.int64)
        return z, z.copy(), np.empty(0)
    return (np.concatenate(ii), np.concatenate(jj),
            np.concatenate(vv).astype(np.float64))


def unrelated_set_from_pairs(
    i_idx: np.ndarray, j_idx: np.ndarray, n: int
) -> np.ndarray:
    """Greedy max-independent-set pruning over a sparse related-pair
    graph (same policy as ``unrelated_set``, without the dense matrix)."""
    from collections import defaultdict

    adj = defaultdict(set)
    for i, j in zip(i_idx, j_idx):
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    alive = np.ones(n, dtype=bool)
    deg = {v: len(s) for v, s in adj.items()}
    import heapq

    heap = [(-d, v) for v, d in deg.items()]
    heapq.heapify(heap)
    while heap:
        negd, v = heapq.heappop(heap)
        if not alive[v] or deg.get(v, 0) != -negd:
            continue  # stale entry
        if -negd <= 0:
            break
        alive[v] = False
        for u in adj[v]:
            if alive[u] and deg.get(u, 0) > 0:
                deg[u] -= 1
                heapq.heappush(heap, (-deg[u], u))
        deg[v] = 0
    return np.nonzero(alive)[0]
