"""On-device 2-bit genotype decode.

The packed dosage-code buffer (janusx_tpu.io.bitcodec conventions: 0/1/2 =
dosage, 3 = missing, tail padded with 3) ships to device memory 16x smaller
than f32; these jittable ops expand it to centered / standardized f32 blocks
right before the consuming matmul. XLA fuses the shift/mask/select chain
into the surrounding computation.

Replaces the reference's host-side LUT decode
(reference src/math/bedmath.rs, src/decode/decode.rs) — we ship
bits, not floats, over PCIe and decode on device.

Pad-and-mask convention: decoded blocks have width ``4 * nb`` (a multiple
of 4, usually padded further to 128 lanes); padding lanes hold code 3 which
decodes to exactly 0.0 in centered/standardized form, so downstream matmul
reductions over the sample axis need no masking.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu import config


def pad_packed_cols(packed: np.ndarray, lane_align: int = config.SAMPLE_ALIGN) -> np.ndarray:
    """Pad packed byte columns so the decoded width is a lane multiple.

    Pad bytes are 0xFF (four code-3 entries = missing = decodes to 0).
    """
    nb = packed.shape[-1]
    byte_align = max(lane_align // 4, 1)
    nb_pad = -(-nb // byte_align) * byte_align
    if nb_pad == nb:
        return packed
    pad = np.full(packed.shape[:-1] + (nb_pad - nb,), 0xFF, dtype=np.uint8)
    return np.concatenate([packed, pad], axis=-1)


def unpack_codes(packed: jax.Array) -> jax.Array:
    """(B, nb) uint8 packed -> (B, 4*nb) int8 codes (0,1,2,3)."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    codes = (packed[..., None] >> shifts) & jnp.uint8(3)
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def decode_centered(
    packed: jax.Array, mean: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Decode to mean-centered values; missing (and padding) -> 0.0.

    packed: (B, nb) uint8; mean: (B,) per-SNP mean dosage.
    Returns (B, 4*nb) ``dtype``.
    """
    codes = unpack_codes(packed)
    x = codes.astype(dtype) - mean.astype(dtype)[:, None]
    return jnp.where(codes == 3, jnp.zeros((), dtype), x)


def decode_standardized(
    packed: jax.Array, mean: jax.Array, inv_sd: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Centered then scaled by per-SNP 1/sd; missing/padding -> 0.0."""
    return decode_centered(packed, mean, dtype) * inv_sd.astype(dtype)[:, None]


def decode_dominance(
    packed: jax.Array, het_freq: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Centered heterozygosity indicator: het -> 1-hf, hom -> -hf,
    missing/padding -> 0 (reference dominance kernel decode,
    src/stats/gblup.rs decode_subset_dom_row value_lut)."""
    codes = unpack_codes(packed)
    hf = het_freq.astype(dtype)[:, None]
    h = jnp.where(codes == 1, 1.0 - hf, -hf).astype(dtype)
    return jnp.where(codes == 3, jnp.zeros((), dtype), h)


def decode_dosage(
    packed: jax.Array, mean: jax.Array, dtype=jnp.float32
) -> jax.Array:
    """Raw dosage with mean imputation for missing (reference scan input:
    decode_mean_imputed_additive_packed_block_rows_f32, src/math/bedmath.rs).

    Padding lanes decode to the mean — callers relying on zero padding must
    use the centered variants or mask explicitly.
    """
    codes = unpack_codes(packed)
    return jnp.where(codes == 3, mean.astype(dtype)[:, None], codes.astype(dtype))
