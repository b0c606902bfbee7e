"""Pipeline executor + k-mer counter tests."""

import json
import os

import numpy as np
import pytest

from janusx_tpu.pipeline.executor import Pipeline, PipelineOptions, Step, check_tool


def test_pipeline_resume_and_skip(tmp_path):
    od = str(tmp_path)
    marker = lambda i, s: os.path.join(od, f"{s}.{i['id']}.out")
    steps = [
        Step("s1", lambda i: f"echo one > {marker(i, 's1')}",
             lambda i: [marker(i, "s1")]),
        Step("s2", lambda i: f"echo two > {marker(i, 's2')}",
             lambda i: [marker(i, "s2")]),
    ]
    items = [{"id": "a"}, {"id": "b"}]
    state = os.path.join(od, "state.json")
    p = Pipeline("test", steps, items, state)
    rep = p.run()
    assert rep["ran"] == 4 and rep["failed"] == 0
    assert p.first_incomplete_step() == 2
    # re-run: everything skips via the state file
    rep2 = Pipeline("test", steps, items, state).run()
    assert rep2["ran"] == 0 and rep2["skipped"] == 4
    # corrupt one completion -> resumes only that item, outputs skip rest
    st = json.load(open(state))
    st["completed"]["s2"].remove("b")
    json.dump(st, open(state, "wt"))
    os.remove(marker({"id": "b"}, "s2"))
    rep3 = Pipeline("test", steps, items, state).run()
    assert rep3["ran"] == 1


def test_pipeline_failure_stops(tmp_path):
    steps = [
        Step("bad", lambda i: "false", lambda i: []),
        Step("never", lambda i: "echo no", lambda i: []),
    ]
    p = Pipeline("t", steps, [{"id": "x"}], str(tmp_path / "st.json"))
    rep = p.run()
    assert rep["failed"] == 1
    assert len(rep["steps"]) == 1  # stopped before step 2


def test_check_tool():
    info = check_tool("ls")
    assert info["found"]
    info = check_tool("definitely_not_a_tool_xyz")
    assert not info["found"]


def test_fastq2vcf_dry_run(tmp_path):
    from janusx_tpu.pipeline.fastq2vcf import Fastq2VcfConfig, build_pipeline

    cfg = Fastq2VcfConfig(
        ref_fasta="ref.fa", out_dir=str(tmp_path),
        samples=[{"id": "s1", "fq1": "a_1.fq", "fq2": "a_2.fq"}],
    )
    per_sample, cohort = build_pipeline(cfg)
    per_sample.options.dry_run = True
    cohort.options.dry_run = True
    rep = per_sample.run()
    assert rep["ran"] == 3  # clean, align, call
    cmd = per_sample.steps[1].command(cfg.samples[0])
    assert "bwa mem" in cmd and "samblaster" in cmd and "samtools sort" in cmd


def test_kmer_counter(tmp_path):
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    # known sequence: k-mers of "ACGTACGTAC" with k=4
    fa = tmp_path / "x.fa"
    fa.write_text(">r1\nACGTACGTAC\n")
    codes, counts = kmer.count_kmers(str(fa), k=4)
    kmers = {kmer.decode_kmer(c, 4): int(n) for c, n in zip(codes, counts)}
    # canonical forms: ACGT(palindromic-ish) appears at pos 0 and 4 ...
    total = sum(kmers.values())
    assert total == 7  # 10 - 4 + 1 windows
    # reverse-complement canonicalization: CGTA's canonical is CGTA vs TACG
    assert all(len(s) == 4 for s in kmers)

    # round-trip through the presence-matrix path
    fb = tmp_path / "y.fa"
    fb.write_text(">r1\nACGTACGTAC\nTTTTTTTTTT\n")
    ca, _ = kmer.count_kmers(str(fa), k=4)
    cb, _ = kmer.count_kmers(str(fb), k=4)
    codes, mat, samples = kmer.merge_to_matrix(
        {"a": (ca, None), "b": (cb, None)}, min_samples=1, max_samples=2
    )
    assert mat.shape[1] == 2
    gd = kmer.kmer_matrix_to_genotypes(codes, mat, samples, 4)
    assert gd.m == len(codes)


def test_kmer_revcomp_invariance(tmp_path):
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    fa = tmp_path / "f.fa"
    fa.write_text(">r\nACGGTTCAGGCAT\n")
    fb = tmp_path / "r.fa"
    fb.write_text(">r\nATGCCTGAACCGT\n")  # reverse complement
    ca, na = kmer.count_kmers(str(fa), k=5)
    cb, nb = kmer.count_kmers(str(fb), k=5)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(na, nb)


def test_graceful_interrupts_scope():
    import signal

    from janusx_tpu.utils.interrupt import graceful_interrupts, interrupted

    with graceful_interrupts():
        assert not interrupted()
        # simulate first Ctrl-C: cooperative flag set, no exception
        signal.raise_signal(signal.SIGINT)
        assert interrupted()
    assert not interrupted()  # cleared on exit


def test_kmer_multiline_fasta_spanning(tmp_path):
    """k-mers spanning FASTA line wraps are counted (KMC semantics)."""
    kmer = pytest.importorskip("janusx_tpu.models.kmer")
    if not kmer.available():
        pytest.skip("no native counter")
    seq = "ACGTACGTACGTACGT"
    k = 8
    # one-line vs wrapped every 5 bases: identical k-mer multiset
    p1 = tmp_path / "a.fa"
    p1.write_text(">s\n" + seq + "\n")
    p2 = tmp_path / "b.fa"
    wrapped = "\n".join(seq[i:i + 5] for i in range(0, len(seq), 5))
    p2.write_text(">s\n" + wrapped + "\n")
    c1, n1 = kmer.count_kmers(str(p1), k=k)
    c2, n2 = kmer.count_kmers(str(p2), k=k)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(n1, n2)
    assert int(n1.sum()) == len(seq) - k + 1


def test_kmer_streaming_chunks_match_oneshot(tmp_path):
    kmer = pytest.importorskip("janusx_tpu.models.kmer")
    if not kmer.available():
        pytest.skip("no native counter")
    rng = np.random.default_rng(5)
    reads = []
    for i in range(400):
        s = "".join("ACGT"[b] for b in rng.integers(0, 4, 80))
        reads.append(f"@r{i}\n{s}\n+\n{'I' * 80}\n")
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(reads))
    c_big, n_big = kmer.count_kmers(str(fq), k=15)
    c_small, n_small = kmer.count_kmers(str(fq), k=15, chunk_bytes=1 << 12)
    np.testing.assert_array_equal(c_big, c_small)
    np.testing.assert_array_equal(n_big, n_small)
    # cross-check total k-mer mass: 400 reads x (80-15+1)
    assert int(n_big.sum()) == 400 * 66


def test_kmer_threaded_matches_python_reference(tmp_path):
    kmer = pytest.importorskip("janusx_tpu.models.kmer")
    if not kmer.available():
        pytest.skip("no native counter")
    rng = np.random.default_rng(6)
    k = 9
    seqs = ["".join("ACGT"[b] for b in rng.integers(0, 4, 120)) for _ in range(60)]
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">c{i}\n{s}\n" for i, s in enumerate(seqs)))

    def canon(s):
        rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        return min(s, rc)

    from collections import Counter

    ref = Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            ref[canon(s[i:i + k])] += 1
    codes, counts = kmer.count_kmers(str(fa), k=k, threads=8)
    got = {kmer.decode_kmer(c, k): int(n) for c, n in zip(codes, counts)}
    assert got == dict(ref)


def test_kmer_giant_fasta_record_streaming(tmp_path):
    """A single FASTA record larger than chunk_bytes streams with bounded
    carry and identical counts to a one-shot read."""
    kmer = pytest.importorskip("janusx_tpu.models.kmer")
    if not kmer.available():
        pytest.skip("no native counter")
    rng = np.random.default_rng(8)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 40_000))
    fa = tmp_path / "giant.fa"
    wrapped = "\n".join(seq[i:i + 70] for i in range(0, len(seq), 70))
    fa.write_text(">chr1\n" + wrapped + "\n")
    k = 13
    c1, n1 = kmer.count_kmers(str(fa), k=k)
    c2, n2 = kmer.count_kmers(str(fa), k=k, chunk_bytes=4096)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(n1, n2)
    assert int(n1.sum()) == len(seq) - k + 1


def test_kstats_pair_venn(tmp_path):
    """-pair lower-triangle set matrices and -venn presence patterns."""
    import numpy as np

    from janusx_tpu.cli.kmer import kstats_main

    sets = {"A": [1, 2, 3, 4, 5, 10], "B": [3, 4, 5, 6, 7], "C": [5, 10, 20]}
    paths = []
    for sid, codes in sets.items():
        p = tmp_path / f"x.{sid}.k21.npz"
        np.savez_compressed(p, codes=np.array(codes, np.uint64),
                            counts=np.ones(len(codes), np.int64), k=21)
        paths.append(str(p))
    rc = kstats_main(["-i", *paths, "-pair", "both", "-venn",
                      "-o", str(tmp_path), "-prefix", "ks"])
    assert rc == 0
    inter = [l.split("\t") for l in
             open(tmp_path / "ks.pair.intersection.tsv").read().splitlines()]
    assert inter[2][0] == "B" and inter[2][1] == "3"   # |A ∩ B|
    assert inter[3][1] == "2" and inter[3][2] == "1"   # |A ∩ C|, |B ∩ C|
    venn = {l.split("\t")[0]: int(l.split("\t")[-1]) for l in
            open(tmp_path / "ks.venn.tsv").read().splitlines()[1:]}
    assert venn["110"] == 2 and venn["111"] == 1 and venn["001"] == 1


def test_kmer_spill_matches_inram(tmp_path):
    """A tiny memory budget forces the KMC-lite spill route; results must
    equal the unbounded in-RAM count exactly (keys, counts, min_count)."""
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    reads = []
    for i in range(400):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 80))
        reads.append(f"@r{i}\n{seq}\n+\n{'I' * 80}\n")
    fq = tmp_path / "x.fastq"
    fq.write_text("".join(reads))

    ref_c, ref_n = kmer.count_kmers(str(fq), k=17, min_count=1)
    spill_c, spill_n = kmer.count_kmers(
        str(fq), k=17, min_count=1,
        mem_budget_bytes=64 << 10,  # 64 KB: far below the table size
        spill_dir=str(tmp_path / "spill"),
    )
    np.testing.assert_array_equal(spill_c, ref_c)
    np.testing.assert_array_equal(spill_n, ref_n)
    # spill buckets are cleaned up after finalization
    leftovers = list((tmp_path / "spill").glob("jxkmer_part*"))
    assert not leftovers

    # min_count filtering agrees too
    ref2 = kmer.count_kmers(str(fq), k=17, min_count=2)
    sp2 = kmer.count_kmers(str(fq), k=17, min_count=2,
                           mem_budget_bytes=64 << 10,
                           spill_dir=str(tmp_path / "spill2"))
    np.testing.assert_array_equal(sp2[0], ref2[0])
    np.testing.assert_array_equal(sp2[1], ref2[1])


def test_kmer_budget_fails_fast_without_spill(tmp_path):
    """spill_dir='' + a tiny budget must raise a clean MemoryError (the
    pre-guard DRAM-death failure mode) instead of swapping."""
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 200_000))
    fa = tmp_path / "big.fa"
    fa.write_text(f">chr\n{seq}\n")
    with pytest.raises(MemoryError, match="memory budget"):
        kmer.count_kmers(str(fa), k=21, mem_budget_bytes=64 << 10,
                         spill_dir="")


def test_kmer_wide_keys_k_up_to_64(tmp_path):
    """Two-word (k > 32) keys: counts match a pure-python canonical
    reference for k in {33, 40, 64}, spill agrees, merge + genotype wrap
    handle the structured codes (KMC supports large k; the old one-word
    path stopped at 32)."""
    from collections import Counter

    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 1500))
    fa = tmp_path / "w.fa"
    fa.write_text(f">c\n{seq}\n")

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def pyref(k):
        c = Counter()
        for i in range(len(seq) - k + 1):
            f = seq[i:i + k]
            r = "".join(comp[x] for x in reversed(f))
            c[min(f, r)] += 1
        return dict(c)

    for k in (33, 64):
        codes, counts = kmer.count_kmers(str(fa), k=k, min_count=1)
        assert codes.dtype == kmer.WIDE_DTYPE
        got = {kmer.decode_kmer(c, k): int(n) for c, n in zip(codes, counts)}
        assert got == pyref(k)
        sp_c, sp_n = kmer.count_kmers(str(fa), k=k, min_count=1,
                                      mem_budget_bytes=64 << 10)
        np.testing.assert_array_equal(sp_c, codes)
        np.testing.assert_array_equal(sp_n, counts)

    per = {"a": kmer.count_kmers(str(fa), k=40),
           "b": kmer.count_kmers(str(fa), k=40)}
    codes, mat, samples = kmer.merge_to_matrix(per, min_samples=2,
                                               max_samples=2)
    assert len(codes) and mat.shape == (len(codes), 2)
    gd = kmer.kmer_matrix_to_genotypes(codes[:3], mat[:3], samples, 40)
    assert all(len(s) == 40 for s in gd.sites.snp)

    with pytest.raises(RuntimeError, match="bad k"):
        kmer.count_kmers(str(fa), k=65)


def test_kmer_cli_reference_flags_and_tree(tmp_path):
    """Reference kmer CLI spellings (-fa/-ci/-cx/-m/--tmp-dir) and the
    hidden -tree mode: presence-Jaccard NJ over the counted samples."""
    import numpy as np

    from janusx_tpu.cli.kmer import main as kmer_main
    from janusx_tpu.models import kmer as kmod

    if not kmod.available():
        import pytest

        pytest.skip("native counter unavailable")
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), 400))
    mut = list(base)
    for i in range(0, 400, 9):
        mut[i] = "ACGT"[(("ACGT".index(mut[i])) + 1) % 4]
    far = "".join(rng.choice(list("ACGT"), 400))
    for name, seq in (("s1", base), ("s2", base), ("s3", "".join(mut)),
                      ("s4", far)):
        (tmp_path / f"{name}.fa").write_text(f">r\n{seq}\n")
    rc = kmer_main([
        "-fa", str(tmp_path / "s1.fa"), str(tmp_path / "s2.fa"),
        str(tmp_path / "s3.fa"), str(tmp_path / "s4.fa"),
        "--kmer-len", "15", "-ci", "1", "-cx", "1000000",
        "-m", "1", "--tmp-dir", str(tmp_path / "spill"),
        "-tree", "-o", str(tmp_path), "-p", "km",
    ])
    assert rc == 0
    for s in ("s1", "s2", "s3", "s4"):
        assert (tmp_path / f"km.{s}.k15.npz").exists()
    nwk = (tmp_path / "km.kmer.nwk").read_text().strip()
    assert nwk.endswith(";") and all(s in nwk for s in ("s1", "s2", "s3", "s4"))
    # identical samples s1/s2 must be siblings in the Jaccard NJ tree
    import re

    sib = re.search(r"\((s1|s2):[^,]*,(s1|s2):", nwk)
    assert sib, nwk
    # -cx filters high-count k-mers: a cx=1 run drops repeated k-mers
    rc = kmer_main(["-i", str(tmp_path / "s1.fa"), "-k", "15",
                    "-ci", "1", "-cx", "1",
                    "-o", str(tmp_path), "-p", "kx"])
    assert rc == 0
    d_all = np.load(tmp_path / "km.s1.k15.npz")
    d_cx = np.load(tmp_path / "kx.s1.k15.npz")
    assert (d_cx["counts"] <= 1).all()
    assert len(d_cx["codes"]) <= len(d_all["codes"])


def test_kstats_kbin_compare_and_min_count(tmp_path):
    """-kbin mode reads a kmerge bitmatrix for per-sample presence stats
    and -compare group tables; --min-count filters every view."""
    import numpy as np

    from janusx_tpu.cli.kmer import kmerge_main, kstats_main

    sets = {
        "A": ([1, 2, 3, 10], [5, 1, 3, 2]),
        "B": ([2, 3, 7], [2, 2, 9]),
        "C": ([3, 10, 20], [1, 4, 4]),
    }
    paths = []
    for sid, (codes, counts) in sets.items():
        p = tmp_path / f"x.{sid}.k21.npz"
        np.savez_compressed(p, codes=np.array(codes, np.uint64),
                            counts=np.array(counts, np.uint32), k=21)
        paths.append(str(p))
    rc = kmerge_main(["-db", *paths, "-min-samples", "1",
                      "-o", str(tmp_path), "-prefix", "km"])
    assert rc == 0
    rc = kstats_main(["-kbin", str(tmp_path / "km"),
                      "-compare", "AB=A,B", "C",
                      "-o", str(tmp_path), "-prefix", "kb"])
    assert rc == 0
    rows = [l.split("\t") for l in
            open(tmp_path / "kb.compare.tsv").read().splitlines()]
    assert rows[0] == ["group_a", "group_b", "only_a", "only_b", "shared",
                       "jaccard"]
    ga, gb, only_a, only_b, shared, _ = rows[1]
    # kmerge keeps SEGREGATING k-mers only, so k-mer 3 (present in every
    # sample) is absent from the matrix: group AB = {1,2,7,10}, C = {10,20}
    assert (ga, gb) == ("AB", "group2")
    assert (int(only_a), int(only_b), int(shared)) == (3, 1, 1)
    # --min-count drops low-count k-mers from -pair/-venn too
    rc = kstats_main(["-db", *paths, "--min-count", "3", "-pair",
                      "intersection", "-venn",
                      "-o", str(tmp_path), "-prefix", "mc"])
    assert rc == 0
    # after count >= 3: A={1,3}, B={7}, C={10,20} -> all intersections 0
    inter = [l.split("\t") for l in
             open(tmp_path / "mc.pair.intersection.tsv").read().splitlines()]
    assert inter[2][1] == "0" and inter[3][1] == "0" and inter[3][2] == "0"


def _random_fastq(path, n_reads=4000, readlen=100, seed=0):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as fh:
        q = b"I" * readlen + b"\n"
        for i in range(n_reads):
            seq = bases[rng.integers(0, 4, readlen)].tobytes()
            fh.write(b"@r%d\n" % i + seq + b"\n+\n" + q)


def test_kmer_sorted_phase2_matches_hash(tmp_path, monkeypatch):
    """Round-5 phase-2 redesign: radix+RLE run vectors (default) must be
    byte-identical to the hash-table path across single/multi-chunk
    feeds and min_count filters."""
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    fq = tmp_path / "r.fastq"
    _random_fastq(fq, seed=3)
    for kwargs in ({}, {"chunk_bytes": 1 << 17}, {"min_count": 2}):
        monkeypatch.setenv("JX_KMER_PHASE2", "hash")
        c1, n1 = kmer.count_kmers(str(fq), k=21, **kwargs)
        monkeypatch.setenv("JX_KMER_PHASE2", "sort")
        c2, n2 = kmer.count_kmers(str(fq), k=21, **kwargs)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(n1, n2)
        if kwargs.get("min_count", 1) == 1:
            assert len(c1) > 0
            # sorted order preserved (the count_kmers API contract)
            assert np.all(np.diff(c2.astype(np.int64)) > 0)


def test_kmer_stream_db_matches_count(tmp_path):
    """stream_kmer_count + load_kmer_db == count_kmers, in RAM mode,
    spill mode, and wide-key mode (the KMC-style streamed output that
    unbinds the all-distinct case from RAM)."""
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    fq = tmp_path / "r.fastq"
    _random_fastq(fq, seed=5)

    c, n = kmer.count_kmers(str(fq), k=21)
    w = kmer.stream_kmer_count(str(fq), str(tmp_path / "a.jxkdb"), k=21)
    cs, ns, kk = kmer.load_kmer_db(str(tmp_path / "a.jxkdb"))
    assert w == len(c) and kk == 21
    np.testing.assert_array_equal(np.asarray(cs), c)
    np.testing.assert_array_equal(np.asarray(ns), n)

    # spill mode (tiny budget forces bucket files)
    w2 = kmer.stream_kmer_count(str(fq), str(tmp_path / "b.jxkdb"), k=21,
                                mem_budget_bytes=1 << 20)
    cs2, ns2, _ = kmer.load_kmer_db(str(tmp_path / "b.jxkdb"))
    np.testing.assert_array_equal(np.asarray(cs2), c)
    np.testing.assert_array_equal(np.asarray(ns2), n)

    # wide keys (k > 32 -> two-word codes, hash phase 2); the loaded
    # codes must be DTYPE-IDENTICAL to count_kmers' wide output so the
    # downstream merge/sort/concat paths treat both sources the same
    c3, n3 = kmer.count_kmers(str(fq), k=33)
    kmer.stream_kmer_count(str(fq), str(tmp_path / "c.jxkdb"), k=33)
    cs3, ns3, k3 = kmer.load_kmer_db(str(tmp_path / "c.jxkdb"))
    assert k3 == 33
    assert cs3.dtype == c3.dtype == kmer.WIDE_DTYPE
    np.testing.assert_array_equal(cs3, c3)
    np.testing.assert_array_equal(np.asarray(ns3), n3)
    # mixing .jxkdb and .npz wide tables concatenates cleanly
    assert np.concatenate([cs3, c3]).dtype == kmer.WIDE_DTYPE

    # min_count filter at stream time
    c4, n4 = kmer.count_kmers(str(fq), k=21, min_count=2)
    kmer.stream_kmer_count(str(fq), str(tmp_path / "d.jxkdb"), k=21,
                           min_count=2)
    cs4, ns4, _ = kmer.load_kmer_db(str(tmp_path / "d.jxkdb"))
    np.testing.assert_array_equal(np.asarray(cs4), c4)
    np.testing.assert_array_equal(np.asarray(ns4), n4)


def test_kmer_cli_stream_db_and_kstats(tmp_path):
    """`jx kmer -stream-db` writes .jxkdb and kstats/kmerge consume it
    interchangeably with .npz."""
    from janusx_tpu.cli.kmer import kstats_main, main as kmer_main
    from janusx_tpu.models import kmer

    if not kmer.available():
        pytest.skip("no native toolchain")
    fq = tmp_path / "s1.fastq"
    _random_fastq(fq, n_reads=500, seed=7)
    rc = kmer_main(["-i", str(fq), "-k", "15", "-ci", "1", "-stream-db",
                    "-o", str(tmp_path), "-prefix", "kdb"])
    assert rc == 0
    db = tmp_path / "kdb.s1.k15.jxkdb"
    assert db.exists()
    rc = kmer_main(["-i", str(fq), "-k", "15", "-ci", "1",
                    "-o", str(tmp_path), "-prefix", "knpz"])
    assert rc == 0
    npz = tmp_path / "knpz.s1.k15.npz"
    # kstats over the two formats produces identical tables (stdout)
    import io
    from contextlib import redirect_stdout

    buf1, buf2 = io.StringIO(), io.StringIO()
    with redirect_stdout(buf1):
        rc = kstats_main(["-db", str(db), "-o", str(tmp_path),
                          "-prefix", "st1"])
    assert rc == 0
    with redirect_stdout(buf2):
        rc = kstats_main(["-db", str(npz), "-o", str(tmp_path),
                          "-prefix", "st2"])
    assert rc == 0
    rows1 = [l.split("\t")[1:] for l in buf1.getvalue().splitlines()]
    rows2 = [l.split("\t")[1:] for l in buf2.getvalue().splitlines()]
    assert rows1 == rows2 and len(rows1) >= 2


def test_jxkdb_malformed_inputs_rejected(tmp_path):
    """load_kmer_db: wrong magic / truncated header / version drift are
    loud ValueErrors, and a truncated record tail doesn't crash."""
    from janusx_tpu.models import kmer

    bad = tmp_path / "bad.jxkdb"
    bad.write_bytes(b"NOTMAGIC" + b"\0" * 8)
    with pytest.raises(ValueError, match="jxkdb"):
        kmer.load_kmer_db(str(bad))
    bad.write_bytes(b"JXKMERDB")  # truncated header
    with pytest.raises(ValueError):
        kmer.load_kmer_db(str(bad))
    bad.write_bytes(b"JXKMERDB" + bytes([9, 21, 0]) + b"\0" * 5)  # bad ver
    with pytest.raises(ValueError):
        kmer.load_kmer_db(str(bad))
    # valid header + whole records round-trips; np.fromfile path too
    ok = tmp_path / "ok.jxkdb"
    rec = np.zeros(3, dtype=[("code", "<u8"), ("count", "<u4")])
    rec["code"] = [5, 9, 11]
    rec["count"] = [2, 1, 7]
    with open(ok, "wb") as fh:
        fh.write(b"JXKMERDB" + bytes([1, 21, 0]) + b"\0" * 5)
        rec.tofile(fh)
    codes, counts, k = kmer.load_kmer_db(str(ok))
    assert k == 21
    np.testing.assert_array_equal(np.asarray(codes), [5, 9, 11])
    np.testing.assert_array_equal(np.asarray(counts), [2, 1, 7])
    codes2, counts2, _ = kmer.load_kmer_db(str(ok), mmap=False)
    np.testing.assert_array_equal(np.asarray(codes2), [5, 9, 11])
