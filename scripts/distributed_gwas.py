#!/usr/bin/env python
"""Multi-host GWAS demo driver (the distributed primitives end-to-end).

Run the SAME command in every process, with the cluster described by the
environment (processes that share a host also name their cards):

    JX_DIST_COORDINATOR=host0:8476 JX_DIST_NPROCS=2 JX_DIST_PROC_ID=0 \
    JX_DIST_LOCAL_DEVICES=0 \
        python scripts/distributed_gwas.py --bfile panel --pheno panel.pheno

Flow (parallel/distributed.py production surfaces):
  1. jax.distributed init (must precede any backend touch),
  2. every host opens the same QC'd genotype (disk-backed windowed reads
     — only this host's host_snp_range rows are ever materialized),
  3. distributed_grm: per-host partial GRMs, one cross-process merge,
  4. eigh of the (replicated) GRM on every host,
  5. distributed_scan(lmm_scan): each host scans its slice, per-SNP
     columns all-gather in SNP order,
  6. process 0 writes the reference-format TSV.

The 2-process CPU-backend version of exactly this flow runs in CI
(tests/dist_worker.py via tests/test_sharding.py).
"""

from __future__ import annotations

import argparse


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bfile", required=True, help="PLINK prefix (QC'd)")
    ap.add_argument("--pheno", required=True)
    ap.add_argument("--trait", type=int, default=0)
    ap.add_argument("--out", default="./dist_gwas")
    ap.add_argument("--maf", type=float, default=0.02)
    ap.add_argument("--geno", type=float, default=0.05)
    args = ap.parse_args()

    import jax

    from janusx_tpu.parallel import distributed as dist

    dist.initialize_from_env()
    pid = jax.process_index()

    import numpy as np

    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.io.packed import QcParams
    from janusx_tpu.io.pheno import load_phenotype
    from janusx_tpu.io.windowed import WindowedBed
    from janusx_tpu.models.lmm import lmm_scan
    from janusx_tpu.models.scan_common import analysis_sample_index
    from janusx_tpu.utils.tsv import HEADER_BASIC, format_assoc_rows

    wp = WindowedBed(args.bfile).prepare(
        QcParams(maf=args.maf, geno=args.geno))
    ph = load_phenotype(args.pheno)
    y_all, names = ph.align(wp.samples)
    y = np.asarray(y_all[:, args.trait], np.float64)
    keep = analysis_sample_index(y)
    if len(keep) != wp.n:
        raise SystemExit(
            "NA phenotypes present: subset the panel first (the demo "
            "keeps the flow minimal; run_gwas handles NA masking)")

    K = dist.distributed_grm(wp)
    basis = eigh_grm(K, diag_ridge=1e-6)  # replicated: every host
    res = dist.distributed_scan(
        wp, lambda sub: lmm_scan(sub, basis, y)[0])

    if pid == 0:
        out = f"{args.out}.lmm.assoc.tsv"
        with open(out, "wt") as fh:
            fh.write(HEADER_BASIC + "\n")
            fh.write(format_assoc_rows(
                res.sites, res.af, res.miss, res.beta, res.se, res.pwald))
        print(f"{out}\t{res.m} SNPs\t{jax.process_count()} hosts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
