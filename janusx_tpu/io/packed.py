"""QC + 2-bit packing: the one-pass prepare stage.

Device equivalent of the reference's ``prepare_bed_2bit_packed``
(/root/reference/src/io/gfreader.rs:7029; filter semantics
gfreader.rs:1830-1872): one pass over SNP-major dosage data applying
missing-rate / heterozygosity / MAF filters, flipping rows so allele1 is
always the minor allele, and emitting a 2-bit packed buffer plus per-SNP
stats (af, missing rate, mean dosage) that every device kernel consumes.

The packed buffer is the array that ships to device memory: 16x smaller than
f32, decoded on device (janusx_tpu.ops.decode).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from janusx_tpu.io import bitcodec
from janusx_tpu.io.gdata import GenotypeData, SiteInfo
from janusx_tpu import config


@dataclass
class QcParams:
    maf: float = config.DEFAULT_MAF
    geno: float = config.DEFAULT_GENO  # max missing rate
    het: float = config.DEFAULT_HET  # max het rate; >=1.0 disables
    snps_only: bool = False

    @property
    def apply_het(self) -> bool:
        return self.het < 1.0


@dataclass
class PackedGenotypes:
    """QC'd, minor-allele-flipped, 2-bit packed SNP-major genotypes."""

    packed: np.ndarray  # (m, ceil(n/4)) uint8 dosage codes
    n_samples: int
    sites: SiteInfo
    samples: np.ndarray
    af: np.ndarray  # (m,) f64 — freq of allele1 (minor, counted) over non-missing
    miss: np.ndarray  # (m,) f64 — missing rate
    mean: np.ndarray  # (m,) f64 — mean dosage over non-missing (= 2*af)

    @property
    def m(self) -> int:
        return self.packed.shape[0]

    @property
    def n(self) -> int:
        return self.n_samples

    def dosages(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Host decode of rows [start:stop) to int8 dosages (-1 missing)."""
        stop = self.m if stop is None else stop
        codes = bitcodec.unpack_codes(self.packed[start:stop], self.n_samples)
        out = codes.astype(np.int8)
        out[codes == bitcodec.CODE_MISSING] = -1
        return out

    def centered(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Host decode to mean-centered f64 (missing imputed to 0)."""
        stop = self.m if stop is None else stop
        codes = bitcodec.unpack_codes(self.packed[start:stop], self.n_samples)
        x = codes.astype(np.float64) - self.mean[start:stop, None]
        x[codes == bitcodec.CODE_MISSING] = 0.0
        return x

    def take_snps(self, idx: np.ndarray) -> "PackedGenotypes":
        return PackedGenotypes(
            packed=self.packed[idx],
            n_samples=self.n_samples,
            sites=self.sites.take(idx),
            samples=self.samples,
            af=self.af[idx],
            miss=self.miss[idx],
            mean=self.mean[idx],
        )

    @staticmethod
    def concat(parts: list["PackedGenotypes"]) -> "PackedGenotypes":
        n = parts[0].n_samples
        if any(p.n_samples != n for p in parts):
            raise ValueError("sample counts differ")
        s0 = np.asarray(parts[0].samples)
        for p in parts[1:]:
            # equal COUNTS are not enough: different cohorts of the same
            # size would concatenate with silently misaligned columns
            if not np.array_equal(np.asarray(p.samples), s0):
                raise ValueError("sample ID sets differ between parts")
        return PackedGenotypes(
            packed=np.concatenate([p.packed for p in parts], axis=0),
            n_samples=n,
            sites=SiteInfo.concat([p.sites for p in parts]),
            samples=parts[0].samples,
            af=np.concatenate([p.af for p in parts]),
            miss=np.concatenate([p.miss for p in parts]),
            mean=np.concatenate([p.mean for p in parts]),
        )


def _is_snp_allele(a: np.ndarray) -> np.ndarray:
    # vectorized: a per-element Python loop costs tens of seconds at
    # biobank m when snps_only QC is on (exact match against the 1-char
    # bases, so indels/multi-char alleles fail naturally)
    s = np.asarray(a).astype("U8")
    return np.isin(s, ("A", "C", "G", "T", "a", "c", "g", "t"))


def qc_evaluate(
    n_samples: int,
    non_missing: np.ndarray,
    alt_sum: np.ndarray,
    het_count: np.ndarray,
    qc: QcParams,
):
    """Vectorized keep/flip decision.

    Mirrors reference semantics exactly
    (src/io/gfreader.rs:1830 ``evaluate_packed_row_keep_and_flip``).
    Returns (keep, flip, af, miss_rate, mean) where af/mean are post-flip
    and computed over non-missing samples.
    """
    non_missing = non_missing.astype(np.float64)
    miss_rate = 1.0 - non_missing / float(n_samples)
    keep = miss_rate <= qc.geno + 0.0

    has_obs = non_missing > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        alt_freq = np.where(has_obs, alt_sum / (2.0 * non_missing), 0.0)
        het_rate = np.where(has_obs, het_count / non_missing, 0.0)

    if qc.apply_het:
        keep &= ~(has_obs & (het_rate > qc.het))

    flip = alt_freq > 0.5
    af = np.where(flip, 1.0 - alt_freq, alt_freq)
    maf = np.minimum(af, 1.0 - af)
    # all-missing rows: keep only when maf filter is disabled (reference rule)
    keep &= np.where(has_obs, maf >= qc.maf, qc.maf <= 0.0)
    mean = 2.0 * af
    return keep, flip & keep, af, miss_rate, mean


def pack_genotypes(
    gdata: GenotypeData,
    qc: QcParams | None = None,
) -> PackedGenotypes:
    """QC + flip + pack an int8 dosage matrix."""
    qc = qc or QcParams()
    g = gdata.genotypes
    codes = np.where(g < 0, np.uint8(bitcodec.CODE_MISSING), g.astype(np.uint8))
    packed = bitcodec.pack_codes(codes)
    return pack_from_codes(packed, gdata.n, gdata.sites, gdata.samples, qc)


def subset_samples_keep_stats(
    pg: "PackedGenotypes", sample_idx: np.ndarray
) -> "PackedGenotypes":
    """Column-subset WITHOUT re-evaluating per-SNP stats: af/miss/mean
    (and the flip already baked into the codes) stay those of the FULL
    sample set — the reference's `-global` row-stat mode
    (assoc/workflow.py:6895 "reuse a single full-sample row-stat pass
    across traits/folds instead of recomputing on each training subset";
    default remains strict-train re-preparation)."""
    sample_idx = np.asarray(sample_idx)
    if not hasattr(pg, "packed"):
        # disk-backed lazy view (io.windowed.WindowedPacked): compose the
        # sample subset into the materializer and keep the full-sample
        # stats — the -global low-memory route crashes here otherwise
        import dataclasses

        base = getattr(pg, "sample_idx", None)
        new_idx = (sample_idx if base is None
                   else np.asarray(base)[sample_idx])
        return dataclasses.replace(
            pg,
            sample_idx=new_idx,
            n_samples=len(new_idx),
            samples=np.asarray(pg.samples)[sample_idx],
        )
    return PackedGenotypes(
        packed=bitcodec.subset_columns(pg.packed, pg.n_samples, sample_idx),
        n_samples=len(sample_idx),
        sites=pg.sites,
        samples=np.asarray(pg.samples)[sample_idx],
        af=pg.af,
        miss=pg.miss,
        mean=pg.mean,
    )


def pack_from_codes(
    packed: np.ndarray,
    n_samples: int,
    sites: SiteInfo,
    samples: np.ndarray,
    qc: QcParams | None = None,
    sample_idx: np.ndarray | None = None,
) -> PackedGenotypes:
    """QC + flip already-packed dosage codes (tail must be code-3 padded).

    ``sample_idx`` restricts to an analysis-sample subset BEFORE computing
    stats and filters — per-trait re-preparation exactly as the reference's
    prepare_bed_2bit_packed_owned_for_stats_samples
    (src/io/gfreader.rs:6784): af/miss/flip and the QC decisions are all
    evaluated on the subset.
    """
    qc = qc or QcParams()
    if sample_idx is not None:
        sample_idx = np.asarray(sample_idx)
        packed = bitcodec.subset_columns(packed, n_samples, sample_idx)
        samples = np.asarray(samples, dtype=object)[sample_idx]
        n_samples = len(sample_idx)
    non_missing, alt_sum, het = bitcodec.row_stats(packed, n_samples)
    keep, flip, af, miss_rate, mean = qc_evaluate(
        n_samples, non_missing, alt_sum, het, qc
    )
    if qc.snps_only:
        keep &= _is_snp_allele(sites.allele0) & _is_snp_allele(sites.allele1)

    idx = np.nonzero(keep)[0]
    packed_kept = bitcodec.flip_rows(packed[idx], flip[idx])
    sites_kept = sites.take(idx).swap_alleles(flip[idx])
    return PackedGenotypes(
        packed=packed_kept,
        n_samples=n_samples,
        sites=sites_kept,
        samples=np.asarray(samples, dtype=object),
        af=af[idx],
        miss=miss_rate[idx],
        mean=mean[idx],
    )
