"""Multi-host initialization and host-sharded input loading.

The reference is single-node; this module is the framework's scale-out
story (SURVEY §2.3): jax.distributed for process coordination, SNP-axis
sharding over the global mesh, host-local file reads of each host's SNP
slice (ship bits over the network, never floats), and XLA collectives
(NCCL between cards) for the GRM partial-product merge.

Typical multi-host driver:

    from janusx_tpu.parallel import distributed as dist
    dist.initialize_from_env()            # MUST run before any jax call
    mesh = dist.global_snp_mesh()
    m_pad = dist.padded_snp_total(m_total)
    lo, hi = dist.host_snp_range(m_total) # this host's PADDED slice
    block = reader.rows(lo, min(hi, m_total))  # range-limited host read
    block = pad_rows(block, hi - lo)      # rows >= m_total are padding
    g = dist.make_global_snp_array(mesh, block, m_total)
    # g.shape[0] == m_pad; mask or trim rows >= m_total after compute
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

log = logging.getLogger("janusx_tpu.distributed")

SNP_AXIS = "snp"


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_ids: list[int] | None = None) -> None:
    """jax.distributed.initialize with an explicit cluster description.

    Nothing on a GPU host describes the cluster to JAX, so the coordinator
    address (``host:port``), the process count and this process's id are
    required, and a failed initialization raises: a run asked to be
    distributed never carries on as a single process. Processes that
    share a host pass ``local_device_ids`` so each owns its own cards.

    Must run before ANY jax call that initializes the XLA backend — even
    jax.process_count() counts, so the only safe pre-check is
    jax.distributed.is_initialized() (pure Python state).
    """
    if jax.distributed.is_initialized():  # pragma: no cover
        return
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "distributed init needs a coordinator address, the process "
            "count and this process's id (JX_DIST_COORDINATOR, "
            "JX_DIST_NPROCS, JX_DIST_PROC_ID)")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def initialize_from_env() -> None:
    """initialize() from JX_DIST_COORDINATOR / JX_DIST_NPROCS /
    JX_DIST_PROC_ID, plus JX_DIST_LOCAL_DEVICES (comma-separated card ids)
    for processes that share a host. Missing variables raise."""
    import os

    env = os.environ
    local = env.get("JX_DIST_LOCAL_DEVICES")
    initialize(
        coordinator=env.get("JX_DIST_COORDINATOR"),
        num_processes=(int(env["JX_DIST_NPROCS"])
                       if "JX_DIST_NPROCS" in env else None),
        process_id=(int(env["JX_DIST_PROC_ID"])
                    if "JX_DIST_PROC_ID" in env else None),
        local_device_ids=([int(i) for i in local.split(",")]
                          if local else None),
    )


def _mesh_devices() -> list:
    """Global device order: process-major, so each host's shard rows are
    one contiguous block of the sharded axis (required for
    make_array_from_process_local_data with contiguous host reads)."""
    return sorted(jax.devices(), key=lambda d: (d.process_index, d.id))


def global_snp_mesh() -> Mesh:
    """1-D mesh over ALL devices (all hosts); SNP-axis data parallelism."""
    return Mesh(np.array(_mesh_devices()), (SNP_AXIS,))


def padded_snp_total(m_total: int) -> int:
    """SNP-axis length padded up to a device-count multiple (SPMD shards
    must be equal-sized; rows >= m_total are padding)."""
    d = jax.device_count()
    return -(-m_total // d) * d


def host_snp_range(m_total: int) -> tuple[int, int]:
    """This host's contiguous slice [lo, hi) of the PADDED SNP axis,
    weighted by its device count. Rows at index >= m_total (only possible
    on the last hosts) are padding the caller fills with code-3 bytes."""
    m_pad = padded_snp_total(m_total)
    devs = _mesh_devices()
    per_dev = m_pad // len(devs)
    pi = jax.process_index()
    before = sum(1 for d in devs if d.process_index < pi)
    mine = sum(1 for d in devs if d.process_index == pi)
    lo = before * per_dev
    return lo, lo + mine * per_dev


def make_global_snp_array(mesh: Mesh, local_block: np.ndarray, m_total: int):
    """Assemble a globally SNP-sharded array from per-host local blocks.

    local_block holds this host's host_snp_range(m_total) rows (padded —
    its leading dim must be exactly hi - lo). The returned global array
    has leading dim padded_snp_total(m_total); callers mask or trim the
    tail rows after compute."""
    lo, hi = host_snp_range(m_total)
    if local_block.shape[0] != hi - lo:
        raise ValueError(
            f"local block rows {local_block.shape[0]} != host slice {hi - lo}"
            f" (host_snp_range({m_total}) = [{lo}, {hi}))"
        )
    sharding = NamedSharding(mesh, P(SNP_AXIS))
    global_shape = (padded_snp_total(m_total),) + local_block.shape[1:]
    return jax.make_array_from_process_local_data(
        sharding, local_block, global_shape
    )


def distributed_grm(source, method: int = 1, block: int | None = None,
                    dtype=np.float64) -> np.ndarray:
    """Multi-host dense GRM: the production entry point for the recipe
    documented above.

    ``source`` is the QC'd genotype source every host can open — a
    PackedGenotypes or a disk-backed io.windowed.WindowedPacked (then
    each host's take_snps is a range-limited host-local read: bits move
    over the filesystem, floats never cross hosts). Each host computes
    the unnormalized partial GRM of its host_snp_range slice on its own
    devices (models.grm.grm_partial — the same decode/psum kernels as
    grm_from_packed), and the (n, n) partials + denominators sum across
    processes in ONE host all-gather. Single-process
    runs reduce to grm_from_packed exactly (the equivalence is tested in
    tests/test_sharding.py and exercised cross-process by
    tests/dist_worker.py).

    Reference analog: src/stats/grm.rs rayon partial-K merge, scaled out
    host-wise."""
    from janusx_tpu import config
    from janusx_tpu.models.grm import grm_partial

    if block is None:
        block = config.DEFAULT_SNP_BLOCK
    m_total = int(source.m)
    n = int(getattr(source, "n_samples", None) or source.n)
    lo, hi = host_snp_range(m_total)
    hi = min(hi, m_total)
    part, denom = np.zeros((n, n), np.float64), 0.0
    # stream the host slice in bounded windows: a disk-backed
    # WindowedPacked slice must NEVER materialize whole (grm_partial is
    # additive, so windowing preserves the result up to f32 regrouping)
    win = _host_window(source)
    for s in range(lo, hi, win):
        e = min(s + win, hi)
        sub = source.take_snps(np.arange(s, e))
        p_i, d_i = grm_partial(sub, method=method, block=block, dtype=dtype)
        part += p_i
        denom += d_i
    if jax.process_count() == 1:
        if denom <= 0:
            raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
        return part / denom
    from jax.experimental import multihost_utils

    payload = np.concatenate(
        [np.asarray(part, np.float64).ravel(), [float(denom)]])
    gathered = np.asarray(multihost_utils.process_allgather(payload))
    tot = gathered.sum(axis=0)
    denom_g = float(tot[-1])
    if denom_g <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return tot[:-1].reshape(n, n) / denom_g


_SCAN_BASE_COLS = ("af", "miss", "beta", "se", "pwald")
_SCAN_OPT_COLS = ("plrt", "lbd", "ml")
_DIST_WINDOW = 1 << 17  # host-local streaming window (SNP rows)


def _host_window(source) -> int:
    cap = getattr(source, "max_resident_snps", None)
    return max(int(min(_DIST_WINDOW, cap) if cap else _DIST_WINDOW), 1)


def distributed_scan(source, scan):
    """Multi-host per-SNP scan driver: ``scan(sub)`` runs a production
    scan (lm_scan / lmm_scan / fvlmm_scan / ...) on this host's
    host_snp_range slice of ``source`` and returns a ScanResult; the
    per-SNP numeric columns all-gather across processes and reassemble
    in SNP order (process-major host slices are contiguous by
    construction). Padding rows beyond source.m are dropped.

    The per-SNP statistics need no cross-host communication (the same
    independence the in-host shard_map scans exploit) — only the final
    result columns cross the network, as float64 rows. Requires homogeneous
    local device counts (equal host slice widths).

        res = distributed_scan(wp, lambda sub: lm_scan(sub, y))
    """
    from janusx_tpu.models.scan_common import ScanResult

    m_total = int(source.m)
    lo, hi = host_snp_range(m_total)
    hi_eff = min(hi, m_total)
    # stream the host slice in bounded windows (disk-backed sources must
    # never materialize the whole slice); per-SNP scans window cleanly
    win = _host_window(source)
    parts = []
    for s in range(lo, hi_eff, win):
        e = min(s + win, hi_eff)
        sub = source.take_snps(np.arange(s, e))
        res = scan(sub)
        if res.m != e - s:
            raise ValueError(
                f"scan returned {res.m} rows for a {e - s}-row window — "
                "distributed_scan needs a scan that keeps all input SNPs")
        parts.append(res)
    width = hi - lo
    if parts:
        col_src = parts[0]
    else:
        # pure-padding host slice: probe one SNP so this host still
        # agrees with the others on the gathered column set
        col_src = scan(source.take_snps(np.arange(0, 1)))
    have_opt = [f for f in _SCAN_OPT_COLS if getattr(col_src, f) is not None]
    names = list(_SCAN_BASE_COLS) + have_opt

    def padto(vals):
        out = np.full(width, np.nan)
        if vals:
            cat = np.concatenate([np.asarray(v, np.float64) for v in vals])
            out[: len(cat)] = cat
        return out

    cols = {f: padto([getattr(r, f) for r in parts]) for f in names}

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        payload = np.stack([cols[f] for f in names])  # (F, width)
        g = np.asarray(multihost_utils.process_allgather(payload))
        concat = np.concatenate(list(g), axis=1)[:, :m_total]
        cols = {nm: concat[i] for i, nm in enumerate(names)}
    else:
        cols = {nm: cols[nm][:m_total] for nm in names}

    sites = source.sites
    if len(sites) != m_total:
        sites = sites.take(np.arange(m_total))
    return ScanResult(
        sites=sites,
        af=cols["af"], miss=cols["miss"], beta=cols["beta"],
        se=cols["se"], pwald=cols["pwald"],
        plrt=cols.get("plrt"), lbd=cols.get("lbd"), ml=cols.get("ml"),
    )
