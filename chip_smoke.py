#!/usr/bin/env python
"""Smoke run of `jx gwas -lmm` on an NVIDIA GPU, with parity checks.

    python chip_smoke.py                 # one card (the default)
    python chip_smoke.py --four-cards    # the 4-card 'snp' mesh path only

The default run:

1. checks that JAX's first device is a GPU (there is no CPU path);
2. writes a seeded `jx sim` PLINK cohort of n=5,000 samples x m=500,000
   SNPs (the reference's comparative benchmark shape) under
   `.smoke_data/`, reusing it when the seed and shape match;
3. runs `jx gwas -bfile ... -lmm` in this process through
   `janusx_tpu.cli.main`, and checks the TSV (11 columns, one row per
   QC'd SNP, finite p in (0, 1]);
4. compares, on the card, the TSV's first 8,192 SNPs with the batched
   Brent route (`lmm_scan(method="brent")`, same basis and null), and the
   device GRM of a 1,000-sample x 20,000-SNP slice with numpy f64.

`--four-cards` runs the same cohort through `jx gwas -lmm` on one card,
then on a 4-card mesh (its own GRM), then on the mesh again with the
1-card run's GRM, all in this process; it compares the GRMs and the TSVs,
and checks that every SNP-axis upload is split over the four cards and
that the sharded GRM program holds exactly one all-reduce.

The last line of standard output is a JSON object with "ok" and the device
JAX reports; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, ".smoke_data")  # listed in .gitignore

# Tolerances. The scan's is the golden tolerance of
# tests/test_golden_mouse.py (grid λ* against Brent λ*, both exact REML);
# the GRM's allows f32 block products with an f64 flush every
# JX_TPU_GRM_FLUSH blocks; the four-card ones compare the same arithmetic
# regrouped over the mesh. The mesh scan is held to MESH_TOL_LOG10P on the
# 1-card run's own GRM. End to end, the 4-card GRM differs from the 1-card
# one in its last f32 bits, which moves the f32 λ-grid argmin by a grid
# step for a few SNPs: on 4 H100s that read 1.85e-3 (n=5,000, m=500,000)
# and 2.08e-3 (m=20,000), so MESH_TOL_E2E_LOG10P is set at about five
# times those readings.
SCAN_TOL_LOG10P = 0.05
SCAN_TOL_BETA_SE = 0.01
GRM_TOL_REL = 1e-4
MESH_TOL_GRM_REL = 1e-6
MESH_TOL_LOG10P = 1e-3
MESH_TOL_E2E_LOG10P = 1e-2
N_SAMPLES = 5000
PARITY_SNPS = 8192
GRM_SLICE = (1000, 20000)  # samples, SNPs


class SmokeFailure(RuntimeError):
    pass


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card snp-mesh path and the 1-card "
                    "run it is compared with")
    ap.add_argument("--nsnp", type=int, default=500_000,
                    help="SNPs to simulate; a smaller value is printed as a cut")
    ap.add_argument("--seed", type=int, default=1)
    return ap.parse_args(argv)


def phases(args) -> list:
    return ["device", "data", "four_cards"] if args.four_cards else [
        "device", "data", "main_path", "scan_parity", "grm_parity"]


def require_devices(devices, count: int) -> None:
    """The run needs `count` GPUs; anything else is a failure, not a
    fallback."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SmokeFailure(f"first JAX device is {plat!r}, not a GPU")
    if len(devices) < count:
        raise SmokeFailure(f"need {count} GPUs, JAX sees {len(devices)}")


def check(name: str, value: float, limit: float) -> None:
    print(f"{name}: {value!r} (limit {limit!r})", flush=True)
    if not value <= limit:  # NaN fails too
        raise SmokeFailure(f"{name} = {value!r} exceeds {limit!r}")


def scan_agreement(p, beta, p_ref, beta_ref, se_ref) -> tuple:
    """(max |Δ -log10 p|, max |Δβ|/se) between a scan and its reference."""
    p, p_ref = np.asarray(p, np.float64), np.asarray(p_ref, np.float64)
    dlp = np.abs(np.log10(p) - np.log10(p_ref))
    dbeta = np.abs(np.asarray(beta) - np.asarray(beta_ref)) / np.asarray(se_ref)
    if not (np.all(np.isfinite(dlp)) and np.all(np.isfinite(dbeta))):
        return float("nan"), float("nan")
    return float(dlp.max()), float(dbeta.max())


def grm_agreement(K, K_ref) -> float:
    """max |K - K_ref| / max |K_ref|."""
    K, K_ref = np.asarray(K), np.asarray(K_ref)
    return float(np.abs(K - K_ref).max() / np.abs(K_ref).max())


def read_tsv(path: str) -> dict:
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    if len(header) != 11 or any(len(r) != 11 for r in rows):
        raise SmokeFailure(f"{path}: expected 11 columns")
    cols = dict(zip(header, zip(*rows))) if rows else {h: () for h in header}
    out = {"snp": np.asarray(cols["snp"], object)}
    for k in ("beta", "se", "pwald"):
        out[k] = np.asarray(cols[k], np.float64)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_cohort(args) -> str:
    """Seeded `jx sim` PLINK cohort; reused when seed and shape match."""
    from janusx_tpu.cli.main import main as jx

    d = os.path.join(DATA_DIR, f"n{N_SAMPLES}_m{args.nsnp}_s{args.seed}")
    prefix = os.path.join(d, "cohort")
    if not os.path.exists(prefix + ".done"):
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.monotonic()
        rc = jx(["sim", "-nind", str(N_SAMPLES), "-nsnp", str(args.nsnp),
                 "-seed", str(args.seed), "-o", d, "-prefix", "cohort"])
        if rc:
            raise SmokeFailure(f"jx sim exited {rc}")
        open(prefix + ".done", "w").close()
        print(f"data: jx sim wall {time.monotonic() - t0:.1f}s", flush=True)
    else:
        print(f"data: reusing {d}", flush=True)
    return prefix


def grm_cache_path(prefix: str) -> str:
    from janusx_tpu import config
    from janusx_tpu.utils.cache import grm_cache_paths

    return grm_cache_paths(prefix, config.DEFAULT_MAF, config.DEFAULT_GENO)[0]


def run_gwas(prefix: str, out_dir: str, n_devices: int,
             grm_from: str | None = None) -> dict:
    """`jx gwas -lmm` in this process on `n_devices` cards; returns the
    summary, the TSV and the stage lines of its log. The GRM cache is
    cleared first so the device GRM runs, unless ``grm_from`` names an
    earlier run's out dir whose GRM the run is to reuse."""
    from janusx_tpu.cli.main import main as jx

    cache = (grm_cache_path(prefix), grm_cache_path(prefix)[:-4] + ".id")
    for p in cache:
        if grm_from:
            shutil.copy(os.path.join(grm_from, os.path.basename(p)), p)
        elif os.path.exists(p):
            os.remove(p)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.environ["JX_TPU_DEVICES"] = str(n_devices)
    t0 = time.monotonic()
    rc = jx(["gwas", "-bfile", prefix, "-p", prefix + ".pheno", "-lmm",
             "-o", out_dir, "-prefix", "smoke"])
    wall = time.monotonic() - t0
    root = logging.getLogger()
    for h in list(root.handlers):  # close the CLI's log file
        h.close()
        root.removeHandler(h)
    if rc:
        raise SmokeFailure(f"jx gwas exited {rc}")
    base = os.path.join(out_dir, "smoke")
    with open(base + ".gwas.summary.json") as fh:
        summary = json.load(fh)
    with open(base + ".gwas.log") as fh:
        stages = [ln.split("[stage] ", 1)[1].strip() for ln in fh
                  if "[stage]" in ln and "done:" in ln]
    runs = summary["runs"]
    if len(runs) != 1 or runs[0]["model"] != "lmm":
        raise SmokeFailure(f"expected one lmm run, got {runs}")
    for p in cache:  # keep this run's GRM beside its outputs
        shutil.copy(p, out_dir)
    return {"wall": wall, "summary": summary, "stages": stages,
            "tsv": read_tsv(runs[0]["tsv"]), "K": np.load(grm_cache_path(prefix))}


def load_cohort(prefix: str):
    from janusx_tpu.io.gfreader import load_raw_packed
    from janusx_tpu.io.packed import QcParams
    from janusx_tpu.io.pheno import load_phenotype

    raw = load_raw_packed(prefix)
    y_all, _ = load_phenotype(prefix + ".pheno").align(raw.samples)
    return raw, raw.prepare(QcParams()), y_all[:, 0]


def main_path(prefix: str) -> dict:
    import jax

    run = run_gwas(prefix, os.path.join(os.path.dirname(prefix), "out"), 1)
    for s in run["stages"]:
        print(f"stage: {s}", flush=True)
    print(f"jx gwas wall: {run['wall']:.2f}s "
          f"(workflow total {run['summary']['total_seconds']}s)", flush=True)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"peak device memory: {peak} bytes", flush=True)
    raw, pg, y = load_cohort(prefix)
    tsv = run["tsv"]
    if len(tsv["snp"]) != pg.m or not np.array_equal(tsv["snp"], pg.sites.snp):
        raise SmokeFailure(f"TSV has {len(tsv['snp'])} rows, QC kept {pg.m} SNPs")
    p = tsv["pwald"]
    if not (np.all(np.isfinite(p)) and np.all((p > 0) & (p <= 1))):
        raise SmokeFailure("TSV p-values are not all finite in (0, 1]")
    print(f"TSV: {pg.m} rows x 11 columns, p finite in (0, 1]", flush=True)
    return {"run": run, "raw": raw, "pg": pg, "y": y}


def scan_parity(ctx) -> None:
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.models.lmm import lmm_scan

    pg, tsv = ctx["pg"], ctx["run"]["tsv"]
    k = min(PARITY_SNPS, pg.m)
    basis = eigh_grm(ctx["run"]["K"], diag_ridge=1e-6)  # the workflow's basis
    ref, _ = lmm_scan(pg.take_snps(np.arange(k)), basis, ctx["y"],
                      method="brent")
    dlp, dbeta = scan_agreement(tsv["pwald"][:k], tsv["beta"][:k],
                                ref.pwald, ref.beta, ref.se)
    check(f"scan vs brent, first {k} SNPs: max |d -log10 p|", dlp,
          SCAN_TOL_LOG10P)
    check(f"scan vs brent, first {k} SNPs: max |d beta|/se", dbeta,
          SCAN_TOL_BETA_SE)


def grm_parity(ctx) -> None:
    from janusx_tpu.io.packed import QcParams
    from janusx_tpu.models.grm import grm_denominator, grm_from_packed

    n_s, m_s = GRM_SLICE
    sub = ctx["raw"].prepare(QcParams(), sample_idx=np.arange(n_s))
    sub = sub.take_snps(np.arange(min(m_s, sub.m)))
    K = grm_from_packed(sub, method=1)
    C = sub.centered()
    K_ref = C.T @ C / grm_denominator(sub, 1)
    check(f"GRM {sub.n}x{sub.m} slice vs numpy f64: max|dK|/max|K|",
          grm_agreement(K, K_ref), GRM_TOL_REL)


def four_cards(prefix: str) -> None:
    """1 card, then a 4-card mesh, through `jx gwas -lmm`; compares both
    and checks the sharding invariants of the mesh run."""
    import jax.numpy as jnp

    from janusx_tpu.models.grm import _grm_sharded
    from janusx_tpu.parallel.mesh import all_reduce_lines, make_mesh
    from janusx_tpu.utils import devcache

    d = os.path.dirname(prefix)
    one = run_gwas(prefix, os.path.join(d, "out1"), 1)
    uploads = []
    put = devcache._put

    def recording_put(host, sharding=None):
        arr = put(host, sharding)
        uploads.append(arr)
        return arr

    devcache._put = recording_put  # keep the mesh run's SNP-axis uploads
    try:
        four = run_gwas(prefix, os.path.join(d, "out4"), 4)
    finally:
        devcache._put = put
    same = run_gwas(prefix, os.path.join(d, "out4k1"), 4,
                    grm_from=os.path.join(d, "out1"))
    for name, r in (("1 card", one), ("4 cards", four),
                    ("4 cards, 1-card GRM", same)):
        print(f"{name}: jx gwas wall {r['wall']:.2f}s; "
              + "; ".join(r["stages"]), flush=True)
    check("GRM 4 cards vs 1 card: max|dK|/max|K|",
          grm_agreement(four["K"], one["K"]), MESH_TOL_GRM_REL)

    def dlp(r):
        return scan_agreement(r["tsv"]["pwald"], r["tsv"]["beta"],
                              one["tsv"]["pwald"], one["tsv"]["beta"],
                              one["tsv"]["se"])[0]

    check("scan 4 cards vs 1 card, same GRM: max |d -log10 p|", dlp(same),
          MESH_TOL_LOG10P)
    check("scan 4 cards vs 1 card, end to end: max |d -log10 p|", dlp(four),
          MESH_TOL_E2E_LOG10P)

    if not uploads:
        raise SmokeFailure("the mesh run uploaded no SNP-axis buffer")
    for a in uploads:
        devs = {s.device for s in a.addressable_shards}
        split = [ax for ax in range(a.ndim)
                 if a.addressable_shards[0].data.shape[ax] * 4 == a.shape[ax]]
        if len(devs) != 4 or not split:
            raise SmokeFailure(f"upload {a.shape} is not split in quarters "
                               f"over 4 cards: {a.sharding}")
    print(f"sharding: {len(uploads)} SNP-axis uploads, each split in "
          "quarters over 4 cards", flush=True)
    pk = next(a for a in uploads if a.ndim == 4)
    vec = [a for a in uploads if a.shape == pk.shape[:3]][:2]
    ar = all_reduce_lines(_grm_sharded(make_mesh(4), jnp.float64, False)
                          .lower(pk, *vec).compile().as_text())
    print(f"sharded GRM HLO all-reduces: {len(ar)}", flush=True)
    for ln in ar:
        print(f"  {ln[:160]}", flush=True)
    if len(ar) != 1:
        raise SmokeFailure(f"expected 1 all-reduce in the sharded GRM, got {len(ar)}")


def main(argv=None) -> int:
    args = parse_args(argv)
    count = 4 if args.four_cards else 1
    import jax

    devices = jax.devices()
    require_devices(devices, count)
    import janusx_tpu

    if os.path.dirname(os.path.abspath(janusx_tpu.__file__)) != os.path.join(
            HERE, "janusx_tpu"):
        raise SmokeFailure("janusx_tpu must be the package beside this script")
    os.environ.setdefault("JX_TPU_PROGRESS", "1")
    print(f"phases: {', '.join(phases(args))}", flush=True)
    print(f"jax {jax.__version__}; compile cache: "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"precision: x64={jax.config.jax_enable_x64}; every dot on the "
          "path at Precision.HIGHEST (full f32, no TF32)", flush=True)
    if args.nsnp != 500_000:
        print(f"cut: n={N_SAMPLES} m={args.nsnp} (full shape n=5000 "
              "m=500000)", flush=True)
    prefix = make_cohort(args)
    if args.four_cards:
        four_cards(prefix)
    else:
        ctx = main_path(prefix)
        scan_parity(ctx)
        grm_parity(ctx)
    card = card_line()
    print(f"card: {card}", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
