"""Device mesh + sharding layer.

The reference is single-node (rayon threads + BLAS threads, SURVEY.md
§2.3); this module is its device replacement and the framework's only
distribution story: a 1-D ``snp`` mesh (optionally 2-D ``host x chip``)
over which

- GWAS scans shard the SNP-block axis (embarrassingly parallel: each chip
  scans its SNP rows; per-SNP statistics are independent);
- GRM accumulation shards the SNP axis and merges partial C^T C products
  with a single psum (XLA inserts it from the sharded-contraction
  pattern);
- the eigenbasis / rotated null-model state is replicated per chip.

Multi-host: jax.distributed initialization + host-sharded file reads feed
each host its SNP slice; collectives run over NVLink within a host and the network
across, all generated by XLA from these shardings.
"""

from __future__ import annotations

import re

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SNP_AXIS = "snp"


def all_reduce_lines(hlo_text: str) -> list:
    """The all-reduce instructions of compiled HLO text, one line each: a
    synchronous `all-reduce(` (CPU) or the `all-reduce-start(` of an async
    start/done pair (GPU), whose done and operand names do not count."""
    return [ln.strip() for ln in hlo_text.splitlines()
            if re.search(r"\ball-reduce(?:-start)?\(", ln)]


def mesh_step(block: int, mesh: Mesh | None) -> int:
    """SNPs per step of a scan or GRM pass, given ``block``, the SNPs one
    device would take per step.

    Over a mesh every device takes ``block`` rows, so a step covers
    ``block`` x devices SNPs (the tail step is padded) and each device runs
    the shapes one device runs. Blocks of another height are rounded
    differently by the device's matmul, and the f32 λ-grid argmin turns
    that last-bit noise into ~1e-3 of −log10 p."""
    return block if mesh is None else block * mesh.devices.size


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (SNP_AXIS,))


def snp_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (SNP) axis, replicate the rest."""
    return NamedSharding(mesh, P(SNP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_snp_block(mesh: Mesh, arr) -> jax.Array:
    """Device_put a host SNP-major block with its leading axis sharded.

    The leading axis must be divisible by the mesh size (pad first)."""
    return jax.device_put(arr, snp_sharding(mesh))


def put_replicated(mesh: Mesh, arr) -> jax.Array:
    return jax.device_put(arr, replicated(mesh))


def pad_to_multiple(arr: np.ndarray, mult: int, fill=0) -> np.ndarray:
    m = arr.shape[0]
    target = -(-m // mult) * mult
    if target == m:
        return arr
    pad = np.full((target - m,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
