"""Global configuration for janusx-tpu.

Precision policy (mirrors the reference's split of f32 genotype blocks with
f64 likelihood scalars, /root/reference/src/stats/lmm.rs + reml.rs):

- Genotype block matmuls (rotation, GRM accumulation, scan Gram assembly)
  run in float32 at ``Precision.HIGHEST`` (full f32, never TF32).
- Log-likelihood scalars (REML/ML objectives, beta/se solves) run in float64
  when ``jax_enable_x64`` is active (the default here), matching the
  reference to ~1e-12; set ``JX_TPU_X64=0`` to run everything in f32
  (-log10(p) parity to ~1e-3).

Environment knobs use the ``JX_`` prefix for familiarity with the reference
CLI (reference: ~60 JX_* expert env vars, SURVEY.md §5).
"""

from __future__ import annotations

import os


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off", "no", "")


# Must be consulted before the first jax import in janusx_tpu/__init__.py.
ENABLE_X64: bool = _env_flag("JX_TPU_X64", True)

# Default SNP-block size for streamed device kernels (rows of the SNP-major
# matrix processed per jit step; a multiple of 128).
DEFAULT_SNP_BLOCK: int = int(os.environ.get("JX_TPU_SNP_BLOCK", "2048"))

# Default sample-axis padding multiple (lane alignment).
SAMPLE_ALIGN: int = 128

# QC defaults — reference: python/janusx/assoc/config.py:55-57.
DEFAULT_MAF: float = 0.02
DEFAULT_GENO: float = 0.05  # max missing rate
DEFAULT_HET: float = 1.0  # disabled by default

# λ search space, log10 scale — reference: python/janusx/pyBLUP/assoc.py:1808.
LOG10_LAMBDA_LOW: float = -5.0
LOG10_LAMBDA_HIGH: float = 5.0

# Brent defaults — reference: src/stats/lmm.rs:334 (scan), src/stats/reml.rs:650 (null).
SCAN_BRENT_MAX_ITER: int = 50
SCAN_BRENT_TOL: float = 1e-2
NULL_BRENT_MAX_ITER: int = 100
NULL_BRENT_TOL: float = 1e-6

# Ridge added to X'V^-1 X diagonal — reference: src/stats/reml.rs:316.
GRAM_RIDGE: float = 1e-6

# Cache directory override (reference: JANUSX_CACHE_DIR, gfreader.py:348).
CACHE_DIR_ENV: str = "JANUSX_CACHE_DIR"


def cache_dir_override() -> str | None:
    return os.environ.get(CACHE_DIR_ENV) or None


# ---------------------------------------------------------------------------
# Expert env-knob registry (reference: the ~60-variable JX_* layer,
# SURVEY.md §5). Knobs are read lazily at use sites via ``knob()`` so they
# can be flipped per-process; ``jx env`` lists them with current values.
# Entries: name -> (type, default, help). A default of None means "auto".
# ---------------------------------------------------------------------------

KNOBS: dict = {
    "JX_TPU_X64": (bool, True, "float64 likelihood scalars (0 = all-f32, ~1e-3 -log10 p accuracy)"),
    "JX_TPU_PLATFORM": (str, None, "force the JAX platform (cpu|cuda); wins over the ambient JAX_PLATFORMS"),
    "JX_TPU_DEVICES": (int, None, "cap the number of devices used on the 'snp' mesh axis"),
    "JX_TPU_SNP_BLOCK": (int, 2048, "SNP rows each device takes per step in streamed kernels (a multiple of 128)"),
    "JX_TPU_SCAN_METHOD": (str, "grid", "LMM per-SNP lambda search: grid | brent"),
    "JX_TPU_GRID_POINTS": (int, 256, "shared log10-lambda grid size for the grid scan (3-point parabolic refinement localizes lambda* to ~1e-3, inside the 1e-2 Brent tol; raise for finer search)"),
    "JX_TPU_SCAN_BRENT_TOL": (float, 1e-2, "per-SNP Brent tolerance (reference lmm.rs:334)"),
    "JX_TPU_SCAN_BRENT_MAX_ITER": (int, 50, "per-SNP Brent iteration cap"),
    "JX_TPU_NULL_BRENT_TOL": (float, 1e-6, "null-REML Brent tolerance (reference reml.rs:650)"),
    "JX_TPU_NULL_BRENT_MAX_ITER": (int, 100, "null-REML Brent iteration cap"),
    "JX_TPU_LAMBDA_LOW": (float, -5.0, "log10 lambda search lower bound"),
    "JX_TPU_LAMBDA_HIGH": (float, 5.0, "log10 lambda search upper bound"),
    "JX_TPU_EIGH_BACKEND": (str, "host", "GRM eigendecomposition backend: host (LAPACK) | device"),
    "JX_TPU_GRM_RESIDENT_MB": (int, 2048, "packed-buffer size below which the GRM builds in one resident dispatch"),
    "JX_TPU_GRM_FLUSH": (int, 16, "SNP blocks accumulated in f32 before each f64 flush in the GRM build"),
    "JX_TPU_GBLUP_MAX_N": (int, 15_000, "BLUP auto-dispatch: max train n for the GBLUP kernel route"),
    "JX_TPU_GS_EIGH32": (bool, False, "GS fold eighs in f32 (ssyevd, ~2x faster CV; lambda precision ~1e-5 in log10)"),
    "JX_TPU_RRBLUP_EXACT_MAX_M": (int, 15_000, "BLUP auto-dispatch: max markers for exact rrBLUP (else PCG)"),
    "JX_TPU_HE_PROBES": (int, 16, "Hutchinson probes in the streamed HE variance-component pre-fit"),
    "JX_TPU_HASH_DIM": (int, 2048, "signed-hash sketch buckets (-hash default dim)"),
    "JX_TPU_HASH_SEED": (int, 520, "signed-hash seed (reference default 520)"),
    "JX_TPU_CG_TOL": (float, 1e-8, "Jacobi-PCG convergence tolerance"),
    "JX_TPU_CG_MAX_ITER": (int, 1000, "Jacobi-PCG iteration cap"),
    "JX_TPU_SPARSE_CUTOFF": (float, 0.05, "sparse-GRM off-diagonal threshold (-splmm default)"),
    "JX_TPU_SPARSE_MAX_DENSE_COMP": (int, 4096, "largest kinship component eigendecomposed densely; bigger (percolated) ones take per-lambda sparse-LU factors"),
    "JX_TPU_ML_SITE_BUDGET": (int, 2000, "site subsample budget for the approximate-ML tree"),
    "JX_TPU_LOWMEM": (bool, False, "force the disk-backed windowed genotype path regardless of size"),
    "JX_TPU_LOWMEM_BYTES": (int, None, "packed-size threshold (bytes) above which inputs stream from disk"),
    "JX_TPU_HISTORY_DB": (str, "~/.janusx_tpu/history.db", "SQLite run-history location (0 disables)"),
    "JX_TPU_CACHE_BESIDE_SOURCE": (bool, False, "place ~name genotype caches next to the source (reference layout)"),
    "JANUSX_CACHE_DIR": (str, None, "cache directory override (reference-compatible name)"),
    "JX_TPU_PROGRESS": (bool, True, "stage progress lines in workflow logs (0 silences)"),
}


def knob(name: str):
    """Current value of an expert knob: env override if set, else default.
    Read lazily so tests/processes can flip knobs without reimport."""
    typ, default, _help = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if typ is bool:
        return raw.strip().lower() not in ("0", "false", "off", "no")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


def choice_knob(name: str, allowed: tuple) -> str:
    """knob() for enumerated string knobs: unknown values raise instead
    of silently falling into whichever branch `else` happens to pick."""
    v = str(knob(name)).lower()
    if v not in allowed:
        raise ValueError(
            f"{name}={v!r}: expected one of {', '.join(allowed)}")
    return v


def knob_table() -> list:
    """(name, current, default, overridden, help) rows for `jx env`."""
    rows = []
    for name, (typ, default, help_) in KNOBS.items():
        cur = knob(name)
        rows.append((name, cur, default, os.environ.get(name) is not None,
                     help_))
    return rows


# Re-resolve the tunable constants through the knob registry so a JX_TPU_*
# env var set at process launch overrides the defaults above.
SCAN_BRENT_MAX_ITER = knob("JX_TPU_SCAN_BRENT_MAX_ITER")
SCAN_BRENT_TOL = knob("JX_TPU_SCAN_BRENT_TOL")
NULL_BRENT_MAX_ITER = knob("JX_TPU_NULL_BRENT_MAX_ITER")
NULL_BRENT_TOL = knob("JX_TPU_NULL_BRENT_TOL")
LOG10_LAMBDA_LOW = knob("JX_TPU_LAMBDA_LOW")
LOG10_LAMBDA_HIGH = knob("JX_TPU_LAMBDA_HIGH")
