"""Windowed (disk-backed, low-memory) genotype path vs in-RAM path.

The WindowedBed/WindowedPacked layer must produce byte-identical QC
decisions, stats, and scan results to the in-RAM RawPacked path
(reference analog: src/io/gload.rs windowed BED)."""

import numpy as np
import pytest

from janusx_tpu.io import plink
from janusx_tpu.io.gdata import GenotypeData, SiteInfo
from janusx_tpu.io.gfreader import RawPacked, load_raw_packed
from janusx_tpu.io.packed import QcParams, pack_genotypes
from janusx_tpu.io.windowed import WindowedBed


@pytest.fixture(scope="module")
def plink_files(tmp_path_factory):
    rng = np.random.default_rng(77)
    m, n = 1000, 121  # n % 4 != 0: tail-byte handling matters
    p = rng.uniform(0.01, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.03] = -1
    g[5] = 0  # monomorphic row
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(m, dtype=np.int64) + 1,
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    prefix = str(tmp_path_factory.mktemp("wbed") / "toy")
    plink.write_plink_genotypes(prefix, gd)
    return prefix, gd


def test_windowed_prepare_matches_inram(plink_files):
    prefix, gd = plink_files
    qc = QcParams(maf=0.02, geno=0.05)
    ram = pack_genotypes(gd, qc)
    wb = WindowedBed(prefix, window=173)  # deliberately awkward window
    wp = wb.prepare(qc)
    assert wp.m == ram.m
    np.testing.assert_allclose(wp.af, ram.af)
    np.testing.assert_allclose(wp.miss, ram.miss)
    np.testing.assert_allclose(wp.mean, ram.mean)
    assert list(wp.sites.snp) == list(ram.sites.snp)
    assert list(wp.sites.allele1) == list(ram.sites.allele1)  # flips applied
    # materialized bytes identical
    full = wp.take_snps(np.arange(wp.m))
    np.testing.assert_array_equal(full.packed, ram.packed)


def test_windowed_prepare_sample_subset(plink_files):
    prefix, gd = plink_files
    qc = QcParams(maf=0.05)
    idx = np.arange(7, 100, 3)
    from janusx_tpu.io.packed import pack_from_codes
    from janusx_tpu.io import bitcodec

    codes = np.where(gd.genotypes < 0, np.uint8(3), gd.genotypes.astype(np.uint8))
    ram = pack_from_codes(
        bitcodec.pack_codes(codes), gd.n, gd.sites, gd.samples, qc, sample_idx=idx
    )
    wp = WindowedBed(prefix, window=89).prepare(qc, sample_idx=idx)
    assert wp.m == ram.m
    np.testing.assert_allclose(wp.af, ram.af)
    np.testing.assert_array_equal(
        wp.take_snps(np.arange(wp.m)).packed, ram.packed
    )
    assert list(wp.samples) == list(ram.samples)


def test_windowed_grm_and_scans_match(plink_files):
    prefix, gd = plink_files
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.models.grm import grm_from_packed
    from janusx_tpu.models.lm import lm_scan
    from janusx_tpu.models.lmm import lmm_scan

    qc = QcParams()
    ram = pack_genotypes(gd, qc)
    wp = WindowedBed(prefix, window=211).prepare(qc)
    wp.max_resident_snps = 256  # force multi-chunk streaming

    # window boundaries regroup the f32 partial-product flushes, so
    # agreement is at f32 rounding level
    K1 = grm_from_packed(ram, block=128)
    K2 = grm_from_packed(wp, block=128)
    np.testing.assert_allclose(K2, K1, rtol=2e-3, atol=1e-8)

    rng = np.random.default_rng(3)
    y = rng.normal(size=ram.n) + ram.centered()[11] * 0.5
    r1 = lm_scan(ram, y, block=128)
    r2 = lm_scan(wp, y, block=128)
    np.testing.assert_allclose(r2.beta, r1.beta, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(r2.pwald, r1.pwald, rtol=1e-6)

    basis = eigh_grm(K1, diag_ridge=1e-6)
    l1, n1 = lmm_scan(ram, basis, y, block=128)
    l2, n2 = lmm_scan(wp, basis, y, block=128)
    assert n1.lbd == n2.lbd
    np.testing.assert_allclose(l2.beta, l1.beta, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(l2.pwald, l1.pwald, rtol=1e-6)


def test_load_raw_packed_lowmem_switch(plink_files):
    prefix, _ = plink_files
    raw = load_raw_packed(prefix + ".bed")
    assert isinstance(raw, RawPacked)
    wb = load_raw_packed(prefix + ".bed", low_memory=True)
    assert isinstance(wb, WindowedBed)
    qc = QcParams()
    a = raw.prepare(qc)
    b = wb.prepare(qc)
    assert a.m == b.m and a.n == b.n
    np.testing.assert_array_equal(b.take_snps(np.arange(b.m)).packed, a.packed)


def test_run_gwas_lowmem_matches(plink_files, tmp_path):
    """The actual run_gwas entry with a windowed (low-memory) input."""
    prefix, gd = plink_files
    from janusx_tpu.workflows.gwas import GwasConfig, run_gwas
    import os

    rng = np.random.default_rng(5)
    ram = pack_genotypes(gd, QcParams())
    y = rng.normal(size=gd.n) + ram.centered()[11] * 0.5
    pheno = tmp_path / "t.pheno"
    with open(pheno, "wt") as fh:
        fh.write("id\ty\n")
        for s, v in zip(gd.samples, y):
            fh.write(f"{s}\t{v:.6f}\n")
    common = dict(genotype=prefix + ".bed", phenotype=str(pheno),
                  models=("lmm",), force_model=True, block=128,
                  use_cache=False, n_devices=1)
    r1 = run_gwas(GwasConfig(out_prefix=str(tmp_path / "a"), **common))
    os.environ["JX_TPU_LOWMEM"] = "1"
    try:
        r2 = run_gwas(GwasConfig(out_prefix=str(tmp_path / "b"), **common))
    finally:
        del os.environ["JX_TPU_LOWMEM"]
    a, b = r1[0].result, r2[0].result
    np.testing.assert_allclose(b.beta, a.beta, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(b.pwald, a.pwald, rtol=1e-6)


def test_mem_flag_selects_windowed_path(tmp_path, monkeypatch):
    """-mem translates to lowmem env knobs: small budgets force the
    disk-backed windowed loader with a budget-derived resident cap."""
    import argparse
    import os

    from janusx_tpu.cli import common as cli_common
    from janusx_tpu.cli.sim import main as sim_main
    from janusx_tpu.io.gfreader import load_raw_packed
    from janusx_tpu.io.windowed import WindowedPacked

    out = str(tmp_path / "d")
    # BED must exceed the 1 MB lowmem floor: 50k x ceil(100/4) B = 1.25 MB
    assert sim_main(["-nind", "100", "-nsnp", "50000", "-nqtl", "3",
                     "-h2", "0.5", "-o", out]) == 0
    base = os.path.join(out, "sim")
    ns = argparse.Namespace(mem=0.001)  # ~1 MB budget
    monkeypatch.delenv("JX_TPU_LOWMEM_BYTES", raising=False)
    monkeypatch.delenv("JX_TPU_MEM_BUDGET_BYTES", raising=False)
    cli_common.apply_mem_budget(ns)
    assert int(os.environ["JX_TPU_MEM_BUDGET_BYTES"]) == int(0.001 * (1 << 30))
    raw = load_raw_packed(base + ".bed")
    from janusx_tpu.io.packed import QcParams

    pg = raw.prepare(QcParams(maf=0.0))
    assert isinstance(pg, WindowedPacked)
    # budget/4 / nb; nb = ceil(100/4) = 25 -> cap ~10485
    assert 256 <= pg.max_resident_snps <= (int(0.001 * (1 << 30)) // 4) // 25
    # scans still work end-to-end on the windowed view
    import numpy as np

    from janusx_tpu.models.lm import lm_scan

    rng = np.random.default_rng(0)
    y = rng.normal(size=pg.n)
    res = lm_scan(pg.take_snps(np.arange(min(pg.m, 2000))), y, block=128)
    assert np.isfinite(res.pwald).all()
    # plain pops — monkeypatch.delenv here would snapshot the leaked value
    # and RESTORE it at teardown, poisoning later tests with a ~1 MB budget
    os.environ.pop("JX_TPU_LOWMEM_BYTES", None)
    os.environ.pop("JX_TPU_MEM_BUDGET_BYTES", None)


def test_gstats_and_view_on_windowed_input(tmp_path, rng, monkeypatch, capsys):
    """gstats/view must work when load_raw_packed returns the low-memory
    WindowedBed handle (they previously crashed on the missing .packed)."""
    import numpy as np

    from janusx_tpu.cli.main import main as jx_main
    from janusx_tpu.io import plink
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo

    m, n = 300, 40
    g = rng.binomial(2, 0.3, size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object),
    )
    prefix = str(tmp_path / "w")
    plink.write_plink_genotypes(
        prefix, GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    )
    monkeypatch.setenv("JX_TPU_LOWMEM", "1")
    rc = jx_main(["gstats", "-bfile", prefix, "-freq", "-miss", "-ind",
                  "-ldsc", "50", "-o", str(tmp_path), "-prefix", "gs"])
    assert rc == 0
    freq = open(tmp_path / "gs.freq").read().splitlines()
    assert len(freq) == m + 1
    assert (tmp_path / "gs.50snp.ldsc").exists()
    rc = jx_main(["view", str(prefix), "-head", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "s0" in out and "format=bed" in out


def test_prefetch_one_ahead_order_errors_and_overlap():
    """prefetch_one_ahead: results in order, exceptions surface at the
    right yield, and item k+1 really materializes while k is consumed."""
    import threading
    import time as _t

    from janusx_tpu.utils.prefetch import prefetch_one_ahead

    assert list(prefetch_one_ahead([], lambda x: x)) == []
    assert list(prefetch_one_ahead([1, 2, 3], lambda x: x * 10)) == [10, 20, 30]

    def boom(x):
        if x == 2:
            raise ValueError("x2")
        return x

    it = prefetch_one_ahead([1, 2, 3], boom)
    assert next(it) == 1
    import pytest as _pytest

    with _pytest.raises(ValueError, match="x2"):
        next(it)

    # overlap: the worker starts item k+1 before the consumer finishes k
    started = []
    gate = threading.Event()

    def make(x):
        started.append(x)
        return x

    out = []
    for v in prefetch_one_ahead([1, 2, 3], make):
        _t.sleep(0.05)  # consumer busy: worker should already be on v+1
        if v < 3:
            assert len(started) >= v + 1, started
        out.append(v)
    assert out == [1, 2, 3]


def test_prefetch_iter_matches_plain_iteration():
    from janusx_tpu.utils.prefetch import prefetch_iter

    assert list(prefetch_iter(range(7))) == list(range(7))
    assert list(prefetch_iter([])) == []

    def gen():
        yield 1
        raise RuntimeError("mid-stream")

    import pytest as _pytest

    it = prefetch_iter(gen())
    assert next(it) == 1
    with _pytest.raises(RuntimeError, match="mid-stream"):
        next(it)


def test_subset_samples_keep_stats_windowed(tmp_path, rng):
    """subset_samples_keep_stats on a disk-backed WindowedPacked (the
    -global low-memory route) composes the sample subset lazily and
    keeps full-sample stats — matching the in-RAM PackedGenotypes
    behavior (round-5 review: this path crashed with AttributeError)."""
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu.io.packed import (
        QcParams, pack_genotypes, subset_samples_keep_stats,
    )
    from janusx_tpu.io.plink import write_plink_genotypes
    from janusx_tpu.io.windowed import WindowedBed

    m, n = 120, 22
    g = rng.integers(0, 3, size=(m, n)).astype(np.int8)
    g[rng.random(size=g.shape) < 0.05] = -1
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    prefix = str(tmp_path / "wsub")
    write_plink_genotypes(prefix, gd)

    qc = QcParams(maf=0.02, geno=0.2)
    wp = WindowedBed(prefix).prepare(qc)
    pg = pack_genotypes(gd, qc)
    keep = np.sort(rng.choice(n, size=13, replace=False))

    sub_w = subset_samples_keep_stats(wp, keep)
    sub_p = subset_samples_keep_stats(pg, keep)
    assert sub_w.n == 13 and list(sub_w.samples) == list(sub_p.samples)
    # stats stay FULL-sample on both routes
    np.testing.assert_array_equal(sub_w.af, pg.af)
    np.testing.assert_array_equal(sub_w.mean, pg.mean)
    # materialized codes agree with the in-RAM subset
    idx = np.arange(sub_w.m)
    np.testing.assert_array_equal(
        sub_w.take_snps(idx).dosages(), sub_p.dosages())
    # and it composes with an existing sample_idx (prepare(sample_idx=...))
    wp2 = WindowedBed(prefix).prepare(qc, sample_idx=np.arange(2, n))
    sub2 = subset_samples_keep_stats(wp2, np.arange(5))
    assert list(sub2.samples) == [f"i{j}" for j in range(2, 7)]
    assert sub2.take_snps(np.arange(sub2.m)).dosages().shape[1] == 5
