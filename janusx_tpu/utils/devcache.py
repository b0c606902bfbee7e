"""Host->device transfer cache.

Repeated scans over the same trait/basis (multi-model runs, CV folds,
FarmCPU iterations) would otherwise re-upload identical large buffers
(rotation matrix, packed genotypes) on every call. Whether the cache
pays over the H100's PCIe link is not measured. Keyed by (id(array), dtype, shape) with a weakref finalizer so
entries die with their host array; id() values can only be reused after
the original array is garbage collected, at which point the finalizer has
already evicted the stale entry.
"""

from __future__ import annotations

import weakref

import jax.numpy as jnp
import numpy as np

_cache: dict = {}


def to_device(arr: np.ndarray, dtype=None):
    """jnp.asarray with caching for numpy inputs."""
    if not isinstance(arr, np.ndarray):
        return jnp.asarray(arr, dtype) if dtype is not None else jnp.asarray(arr)
    key = (id(arr), np.dtype(dtype) if dtype is not None else arr.dtype, arr.shape)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    dev = jnp.asarray(arr, dtype) if dtype is not None else jnp.asarray(arr)
    try:
        weakref.finalize(arr, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass  # not weakref-able; skip caching
    return dev


def to_device_padded_rows(arr: np.ndarray, rows: int, fill, dtype=None):
    """Pad the leading axis to ``rows`` then upload, cached on the SOURCE
    array identity (padding allocates a fresh host array every call, which
    would defeat the plain cache)."""
    if not isinstance(arr, np.ndarray):
        arr = np.asarray(arr)
    key = (
        id(arr),
        rows,
        fill,
        np.dtype(dtype) if dtype is not None else arr.dtype,
        arr.shape,
    )
    hit = _cache.get(key)
    if hit is not None:
        return hit
    if arr.shape[0] != rows:
        pad = np.full((rows - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
        padded = np.concatenate([arr, pad], axis=0)
    else:
        padded = arr
    dev = jnp.asarray(padded, dtype) if dtype is not None else jnp.asarray(padded)
    try:
        weakref.finalize(arr, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass
    return dev


def device_packed(pg, m_pad: int, lane_align: int = 128):
    """Lane-pad + row-pad + upload a PackedGenotypes buffer, cached on the
    identity of pg.packed (both paddings allocate fresh arrays)."""
    from janusx_tpu.ops import decode as _decode

    src = pg.packed
    key = (id(src), "packed", m_pad, lane_align, src.shape)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    padded = _decode.pad_packed_cols(src, lane_align)
    if padded.shape[0] != m_pad:
        pad = np.full((m_pad - padded.shape[0], padded.shape[1]), 0xFF, np.uint8)
        padded = np.concatenate([padded, pad], axis=0)
    dev = jnp.asarray(padded)
    try:
        weakref.finalize(src, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass
    return dev


def _put(host: np.ndarray, sharding=None):
    import jax

    if sharding is None:
        return jnp.asarray(host)
    return jax.device_put(host, sharding)


def _block_sharding(mesh, ndim: int, axis: int):
    """NamedSharding sharding ``axis`` over the mesh 'snp' axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = [None] * ndim
    spec[axis] = "snp"
    return NamedSharding(mesh, P(*spec))


def device_packed_blocks(
    pg, shape: tuple, lane_align: int = 128, mesh=None, shard_axis: int = 1
):
    """Lane-pad + row-pad + reshape + upload a PackedGenotypes buffer as a
    pre-blocked array of ``shape`` (last dim inferred as the lane-padded
    byte width). With ``mesh``, ``shard_axis`` (the per-block SNP axis) is
    sharded over the mesh's 'snp' axis so every scan step runs SPMD."""
    from janusx_tpu.ops import decode as _decode

    src = pg.packed
    m_pad = int(np.prod(shape))
    key = (id(src), "packedb", shape, lane_align, src.shape,
           None if mesh is None else tuple(mesh.devices.flat))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    padded = _decode.pad_packed_cols(src, lane_align)
    if padded.shape[0] != m_pad:
        pad = np.full((m_pad - padded.shape[0], padded.shape[1]), 0xFF, np.uint8)
        padded = np.concatenate([padded, pad])
    host = padded.reshape(shape + (padded.shape[1],))
    sh = None if mesh is None else _block_sharding(mesh, host.ndim, shard_axis)
    dev = _put(host, sh)
    try:
        weakref.finalize(src, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass
    return dev


def to_device_blocks(
    arr: np.ndarray, shape: tuple, fill, dtype=None, mesh=None, shard_axis: int = 1
):
    """Pad the 1-D per-SNP array to prod(shape), reshape, upload (sharded
    on ``shard_axis`` when a mesh is given). Cached on source identity."""
    if not isinstance(arr, np.ndarray):
        arr = np.asarray(arr)
    m_pad = int(np.prod(shape))
    key = (id(arr), "blocks", shape, fill,
           np.dtype(dtype) if dtype is not None else arr.dtype,
           arr.shape, None if mesh is None else tuple(mesh.devices.flat))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    host = arr
    if host.shape[0] != m_pad:
        pad = np.full((m_pad - host.shape[0],) + host.shape[1:], fill, host.dtype)
        host = np.concatenate([host, pad])
    if dtype is not None:
        host = host.astype(dtype)
    host = host.reshape(shape)
    sh = None if mesh is None else _block_sharding(mesh, host.ndim, shard_axis)
    dev = _put(host, sh)
    try:
        weakref.finalize(arr, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass
    return dev


def replicate_tree(tree, mesh):
    """device_put every leaf replicated over the mesh (no-op w/o mesh)."""
    if mesh is None:
        return tree
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, repl), tree)


def clear() -> None:
    _cache.clear()
