"""Windowed low-memory genotype access (biobank-scale m x n).

The device analog of the reference's mmap-windowed BED layer
(/root/reference/src/io/gload.rs:1-12 ``WindowedBedMatrix`` /
``BedMmapMatrix``): the packed genotype matrix never lives in host RAM.
Per-SNP QC statistics (one streaming pass), the QC keep/flip decisions and
site metadata are held (O(m) small arrays); genotype bytes are pread
directly from the BED file per window when a scan or GRM pass asks for
them. BED rows are contiguous byte ranges (SNP-major), so a window read is
one seek + one read.

Two classes:

- ``WindowedBed``: the pre-QC handle (mirrors gfreader.RawPacked's
  interface: .prepare(qc, sample_idx) -> WindowedPacked).
- ``WindowedPacked``: duck-types io.packed.PackedGenotypes (m/n/sites/
  af/miss/mean/take_snps) but materializes genotype bytes only for the
  requested SNP ranges. Model scans stream it through their superblock
  paths (``max_resident_snps`` bounds per-chunk residency).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from janusx_tpu.io import bitcodec, plink
from janusx_tpu.io.gdata import SiteInfo
from janusx_tpu.io.packed import PackedGenotypes, QcParams, qc_evaluate

# SNPs materialized per window in streaming passes
DEFAULT_WINDOW = 1 << 17
# resident-SNP bound handed to scan superblock loops
DEFAULT_MAX_RESIDENT = 1 << 18


def _resident_cap(nb_full: int) -> int:
    """Resident-SNP bound, honoring a `-mem` budget when set
    (cli.common.apply_mem_budget exports JX_TPU_MEM_BUDGET_BYTES): the
    materialized window (m_w x nb bytes) is kept within a quarter of the
    budget — the rest is decode/result working space."""
    budget = os.environ.get("JX_TPU_MEM_BUDGET_BYTES")
    if not budget:
        return DEFAULT_MAX_RESIDENT
    cap = int(budget) // 4 // max(nb_full, 1)
    return max(min(cap, DEFAULT_MAX_RESIDENT), 256)


def _read_rows(path: str, nb: int, start: int, stop: int,
               fh=None) -> np.ndarray:
    """pread BED rows [start, stop) as raw bytes (m_w, nb)."""
    count = (stop - start) * nb
    own = fh is None
    if own:
        fh = open(path, "rb")
    try:
        fh.seek(3 + start * nb)
        buf = np.fromfile(fh, dtype=np.uint8, count=count)
    finally:
        if own:
            fh.close()
    if buf.size != count:
        raise IOError(f"{path}: short read at rows [{start},{stop})")
    return buf.reshape(stop - start, nb)


class WindowedBed:
    """Pre-QC windowed handle on a PLINK BED fileset."""

    def __init__(self, prefix: str, window: int = DEFAULT_WINDOW):
        self.prefix = prefix
        self.samples = plink.read_fam(prefix + ".fam")
        self.sites = plink.read_bim(prefix + ".bim")
        self.n_samples = len(self.samples)
        self._nb = bitcodec.n_bytes(self.n_samples)
        self.window = window
        path = prefix + ".bed"
        size = os.path.getsize(path)
        m = len(self.sites)
        if size != 3 + m * self._nb:
            raise ValueError(f"{path}: size mismatch (SNP-major v1 BED expected)")
        with open(path, "rb") as fh:
            if fh.read(3) != plink.BED_MAGIC:
                raise ValueError(f"{path}: bad BED magic")
        self._m = m
        self._path = path

    @property
    def m(self) -> int:
        return self._m

    def read_window_codes(self, start: int, stop: int) -> np.ndarray:
        """Dosage-code packed rows [start, stop), tail masked."""
        raw = _read_rows(self._path, self._nb, start, stop)
        packed = bitcodec.translate(raw, bitcodec.BED_TO_DOSAGE_LUT)
        return bitcodec.mask_tail(packed, self.n_samples, copy=False)

    def to_raw_packed(self):
        """Materialize the full packed matrix in RAM (= .bed size) for
        consumers that need random whole-matrix access (gstats -ldsc/-king,
        view). Streaming consumers should iterate read_window_codes."""
        from janusx_tpu.io.gfreader import RawPacked

        blocks = [
            self.read_window_codes(s, min(s + self.window, self._m))
            for s in range(0, self._m, self.window)
        ]
        packed = (
            np.concatenate(blocks, axis=0) if blocks
            else np.empty((0, self._nb), np.uint8)
        )
        return RawPacked(packed, self.n_samples, self.sites, self.samples)

    def prepare(
        self, qc: QcParams | None = None, sample_idx: np.ndarray | None = None
    ) -> "WindowedPacked":
        """One streaming QC pass -> lazy QC'd view (genotypes stay on disk).

        Mirrors pack_from_codes semantics exactly (stats/filters evaluated
        on the sample subset, reference gfreader.rs:6784) without ever
        holding more than one window of genotype bytes.
        """
        qc = qc or QcParams()
        if sample_idx is not None:
            sample_idx = np.asarray(sample_idx)
            samples = np.asarray(self.samples, object)[sample_idx]
            n_sub = len(sample_idx)
        else:
            samples = np.asarray(self.samples, object)
            n_sub = self.n_samples

        keep_parts, flip_parts, af_parts, miss_parts, mean_parts = [], [], [], [], []
        for s in range(0, self._m, self.window):
            e = min(s + self.window, self._m)
            pk = self.read_window_codes(s, e)
            if sample_idx is not None:
                pk = bitcodec.subset_columns(pk, self.n_samples, sample_idx)
            nm, alt, het = bitcodec.row_stats(pk, n_sub)
            keep, flip, af, miss, mean = qc_evaluate(n_sub, nm, alt, het, qc)
            keep_parts.append(keep)
            flip_parts.append(flip)
            af_parts.append(af)
            miss_parts.append(miss)
            mean_parts.append(mean)
        keep = np.concatenate(keep_parts)
        flip = np.concatenate(flip_parts)
        if qc.snps_only:
            from janusx_tpu.io.packed import _is_snp_allele

            keep &= _is_snp_allele(self.sites.allele0) & _is_snp_allele(
                self.sites.allele1
            )
        rows = np.nonzero(keep)[0]
        af = np.concatenate(af_parts)[rows]
        miss = np.concatenate(miss_parts)[rows]
        mean = np.concatenate(mean_parts)[rows]
        flip_kept = flip[rows]
        sites_kept = self.sites.take(rows).swap_alleles(flip_kept)
        return WindowedPacked(
            bed_path=self._path,
            nb_full=self._nb,
            n_full=self.n_samples,
            sample_idx=sample_idx,
            n_samples=n_sub,
            file_rows=rows.astype(np.int64),
            flip=flip_kept,
            sites=sites_kept,
            samples=samples,
            af=af,
            miss=miss,
            mean=mean,
            max_resident_snps=_resident_cap(self._nb),
        )


@dataclass
class WindowedPacked:
    """QC'd lazy genotype view: PackedGenotypes semantics, disk-backed."""

    bed_path: str
    nb_full: int
    n_full: int
    sample_idx: np.ndarray | None
    n_samples: int
    file_rows: np.ndarray  # (m,) kept-row -> BED row
    flip: np.ndarray  # (m,) bool
    sites: SiteInfo
    samples: np.ndarray
    af: np.ndarray
    miss: np.ndarray
    mean: np.ndarray

    # scans chunk their work to at most this many resident SNPs
    max_resident_snps: int = DEFAULT_MAX_RESIDENT

    @property
    def m(self) -> int:
        return len(self.file_rows)

    @property
    def n(self) -> int:
        return self.n_samples

    def _materialize_rows(self, idx: np.ndarray) -> np.ndarray:
        """Packed dosage codes for kept-space indices ``idx`` (flip applied)."""
        rows = self.file_rows[idx]
        out = np.empty((len(rows), self.nb_full), np.uint8)
        # group into consecutive-file-row runs: one pread per run
        if len(rows):
            brk = np.nonzero(np.diff(rows) != 1)[0] + 1
            starts = np.concatenate([[0], brk])
            ends = np.concatenate([brk, [len(rows)]])
            # one shared handle: scattered index sets (LD-pruned picks)
            # have ~no consecutive runs, so per-run open() would cost one
            # open/seek/read syscall triple per SNP
            with open(self.bed_path, "rb") as fh:
                for a, b in zip(starts, ends):
                    out[a:b] = _read_rows(self.bed_path, self.nb_full,
                                          rows[a], rows[b - 1] + 1, fh=fh)
        packed = bitcodec.translate(out, bitcodec.BED_TO_DOSAGE_LUT)
        packed = bitcodec.mask_tail(packed, self.n_full, copy=False)
        if self.sample_idx is not None:
            packed = bitcodec.subset_columns(packed, self.n_full, self.sample_idx)
        return bitcodec.flip_rows(packed, self.flip[idx])

    def take_snps(self, idx: np.ndarray) -> PackedGenotypes:
        """Materialize the given kept-SNP rows as real PackedGenotypes."""
        idx = np.asarray(idx)
        return PackedGenotypes(
            packed=self._materialize_rows(idx),
            n_samples=self.n_samples,
            sites=self.sites.take(idx),
            samples=self.samples,
            af=self.af[idx],
            miss=self.miss[idx],
            mean=self.mean[idx],
        )

    def iter_materialized(self, window: int | None = None):
        """Yield (start, stop, PackedGenotypes) over kept SNPs."""
        w = window or min(self.max_resident_snps, DEFAULT_WINDOW)
        for s in range(0, self.m, w):
            e = min(s + w, self.m)
            yield s, e, self.take_snps(np.arange(s, e))

    def dosages(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        stop = self.m if stop is None else stop
        return self.take_snps(np.arange(start, stop)).dosages()

    def centered(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        stop = self.m if stop is None else stop
        return self.take_snps(np.arange(start, stop)).centered()
