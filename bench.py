"""Exact-LMM scan throughput: one in-process measurement of `lmm_scan`.

    python bench.py [--platform gpu] [--n 5000] [--m 65536] [--reps 5]
                    [--trace DIR]

Builds a seeded synthetic cohort (n samples x m SNPs, `models/sim.py`),
its device GRM and host eigenbasis, then times the resident grid scan
(`janusx_tpu.models.lmm.lmm_scan`: 2-bit decode -> eigenbasis rotate ->
shared λ-grid search -> beta/se/Wald p -> host fetch) after one warm-up
call, and prints ONE JSON line with the device JAX reports and the card's
name and power limit. The device it is asked for (`--platform`) must be
present: a run that finds another device exits non-zero and measures
nothing.

With `--trace DIR` it also records one `jax.profiler` trace of a scan and
prints each named scope's share of the scan's device time (decode,
rotate, lattice_operand, lattice_grams, lattice_schur, final_grams, and
the rest as other), per block as well as in total. Tracing turns XLA's
command buffers off for the whole process (inside a CUDA graph every
kernel reports the graph, not its HLO instruction), so take end-to-end
times from a run without `--trace`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

SCOPES = ("decode", "rotate", "lattice_operand", "lattice_grams",
          "lattice_schur", "final_grams")
SCAN_MODULE = "_lmm_scan_resident"
TRACE_XLA_FLAG = "--xla_gpu_enable_command_buffer="


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="gpu",
                    help="JAX platform the measurement must run on")
    ap.add_argument("--n", type=int, default=5000, help="samples")
    ap.add_argument("--m", type=int, default=65536, help="SNPs")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="also trace one scan into DIR and print scope shares")
    return ap.parse_args(argv)


def card_line(platform: str) -> str | None:
    """`nvidia-smi` name and power limit of the card (None off a GPU)."""
    if platform != "gpu":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cohort(n: int, m: int, seed: int):
    """Seeded synthetic cohort: QC'd packed genotypes, phenotype, basis."""
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.io.packed import QcParams, pack_genotypes
    from janusx_tpu.models.grm import grm_from_packed
    from janusx_tpu.models.sim import simulate_genotypes, simulate_phenotype

    gd = simulate_genotypes(n, m, seed=seed)
    y = simulate_phenotype(gd, n_qtl=20, h2=0.5, seed=seed).phenotypes[:, 0]
    pg = pack_genotypes(gd, QcParams())
    basis = eigh_grm(grm_from_packed(pg), diag_ridge=1e-6)
    return pg, y, basis


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the first of SCOPES in its op_name."""
    out = {}
    for name, op_name in re.findall(
            r'^\s*(?:ROOT\s+)?%?([^\s=]+) = [^\n]*?op_name="([^"]*)"',
            hlo_text, re.M):
        parts = op_name.split("/")
        out[name] = next((s for s in SCOPES if s in parts), "other")
    return out


def scope_times(xplane_path: str, scopes: dict) -> dict:
    """Device nanoseconds per scope of the scan module's events.

    The planes are the `/device:*` ones (the host CPU plane when there is
    no device plane, as on the CPU backend); an event belongs to the scan
    when its `hlo_module` stat names it, and to the scope of its `hlo_op`.
    A GPU plane's stream lines carry the kernels (its other lines repeat
    them), so only those are summed there."""
    from jax.profiler import ProfileData

    planes = list(ProfileData.from_file(xplane_path).planes)
    planes = [p for p in planes if p.name.startswith("/device:")] or [
        p for p in planes if p.name == "/host:CPU"]
    lines = [ln for p in planes for ln in p.lines]
    lines = [ln for ln in lines if ln.name.startswith("Stream")] or lines
    tot = defaultdict(float)
    for line in lines:
        for ev in line.events:
            st = dict(ev.stats)
            if SCAN_MODULE in str(st.get("hlo_module", "")):
                tot[scopes.get(str(st.get("hlo_op")), "other")] += ev.duration_ns
    return dict(tot)


def trace_scan(trace_dir, pg, y, basis, block, null) -> dict:
    """Trace one scan; per-scope device time, total and per block."""
    import jax
    import jax.numpy as jnp

    from janusx_tpu import config
    from janusx_tpu.models import lmm
    from janusx_tpu.utils import devcache

    lmm.lmm_scan(pg, basis, y, block=block, null=null)  # warm
    with jax.profiler.trace(trace_dir):
        lmm.lmm_scan(pg, basis, y, block=block, null=null)
    rot, _, sh = lmm._scan_state(basis, np.asarray(y, np.float64), None,
                                 config.knob("JX_TPU_GRID_POINTS"))
    nblk = -(-pg.m // block)
    pk = devcache.device_packed_blocks(pg, (nblk, block))
    mn = devcache.to_device_blocks(pg.mean, (nblk, block), 0.0,
                                   dtype=jnp.float32)
    U32 = devcache.to_device(basis.U, jnp.float32)
    hlo = lmm._lmm_scan_resident.lower(
        pk, mn, U32, rot, sh, pg.n, False).compile().as_text()
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    ns = scope_times(path, hlo_scopes(hlo))
    total = sum(ns.values())
    return {
        "xplane": path,
        "blocks": nblk,
        "device_ms_per_block": total / nblk / 1e6 if total else None,
        "share": {k: v / total for k, v in sorted(ns.items())} if total else {},
    }


def measure(args) -> dict:
    import jax

    from janusx_tpu import config
    from janusx_tpu.models.lmm import lmm_scan

    devs = jax.devices()
    if devs[0].platform != args.platform:
        raise SystemExit(f"bench: asked for {args.platform!r}, JAX's first "
                         f"device is {devs[0].platform!r}")
    block = config.knob("JX_TPU_SNP_BLOCK")
    t0 = time.monotonic()
    pg, y, basis = cohort(args.n, args.m, args.seed)
    t_setup = time.monotonic() - t0
    t0 = time.monotonic()
    _, null = lmm_scan(pg, basis, y, block=block)  # compile + upload
    t_first = time.monotonic() - t0
    times = []
    for _ in range(args.reps):
        t0 = time.monotonic()
        res, _ = lmm_scan(pg, basis, y, block=block, null=null)
        times.append(time.monotonic() - t0)  # ends in the host fetch
    if not np.all(np.isfinite(res.pwald)):
        raise SystemExit("bench: non-finite p-values")
    out = {
        "metric": "lmm_scan_snps_per_sec",
        "value": pg.m / float(np.median(times)),
        "unit": "SNPs/s",
        "n": pg.n, "m": pg.m, "block": block,
        "seconds": times,
        "setup_s": t_setup, "first_call_s": t_first,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card_line(devs[0].platform),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    if args.trace:
        out["trace"] = trace_scan(args.trace, pg, y, basis, block, null)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.trace:  # before the backend starts
        os.environ["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""), TRACE_XLA_FLAG]).strip()
    print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
