"""`jx` — top-level CLI dispatcher.

Mirrors the reference dispatcher surface
(/root/reference/python/janusx/script/JanusX.py:157-168 module table,
:396-461 dispatch): `jx <module> [args...]`, with `jx gwas` and `jx gs`
routed to the workflow implementations.
"""

from __future__ import annotations

import importlib
import sys

from janusx_tpu import __version__

_MODULES: dict[str, tuple[str, str]] = {
    # name -> (module path, description)
    "gwas": ("janusx_tpu.cli.gwas", "GWAS scans: lm/lmm/lmm2/fvlmm/splmm/farmcpu"),
    "gs": ("janusx_tpu.cli.gs", "Genomic selection: BLUP/GBLUP/rrBLUP/Bayes/ML"),
    "grm": ("janusx_tpu.cli.grm", "Genomic relationship matrix"),
    "pca": ("janusx_tpu.cli.pca", "Principal components (eigh or randomized SVD)"),
    "gstats": ("janusx_tpu.cli.gstats", "Per-site / per-sample genotype statistics"),
    "sim": ("janusx_tpu.cli.sim", "Simulate genotypes + phenotypes"),
    "gformat": ("janusx_tpu.cli.gformat", "Convert genotype files across formats"),
    "postgwas": ("janusx_tpu.cli.postgwas", "Manhattan/QQ plots + annotation"),
    "reml": ("janusx_tpu.cli.reml", "Variance components / BLUE / BLUP"),
    "fastpop": ("janusx_tpu.cli.fastpop", "ADMIXTURE-style ancestry inference"),
    "tree": ("janusx_tpu.cli.tree", "Neighbor-joining phylogeny from genotypes"),
    "bsa": ("janusx_tpu.cli.bsa", "Bulked-segregant analysis preprocessing"),
    "postbsa": ("janusx_tpu.cli.postbsa", "BSA thresholds (CI/G' FDR) + genome plots"),
    "gmerge": ("janusx_tpu.cli.gmerge", "Merge genotype panels"),
    "webui": ("janusx_tpu.cli.webui", "Local web UI: history dashboard + job manager"),
    "env": ("janusx_tpu.cli.env", "List JX_* expert environment knobs"),
    "garfield": ("janusx_tpu.cli.garfield", "Logic-rule (epistasis) association search"),
    "kmer": ("janusx_tpu.cli.kmer", "Count k-mers per sample (native C++)"),
    "fastq2vcf": ("janusx_tpu.cli.fastq2vcf", "Reads-to-variants pipeline (external tools)"),
    "fastq2count": ("janusx_tpu.cli.fastq2count", "RNA-seq reads-to-counts pipeline (external tools)"),
    "postgs": ("janusx_tpu.cli.postgs", "GS CV plots + metric tables"),
    "hybrid": ("janusx_tpu.cli.hybrid", "F1 hybrid performance prediction"),
    "view": ("janusx_tpu.cli.view", "Inspect genotype/matrix artifacts"),
    "refcheck": ("janusx_tpu.cli.refcheck", "Input consistency checks"),
    "ggval": ("janusx_tpu.cli.ggval", "End-to-end install validation (simulate + run + check)"),
    "fvlmm2": ("janusx_tpu.cli.fvlmm2", "G-by-E joint interaction scan (= jx gwas -fvlmm2)"),
    "treeplot": ("janusx_tpu.cli.treeplot", "Render a Newick tree"),
    "gspredict": ("janusx_tpu.cli.gspredict", "Predict gebv from a saved model"),
    "benchmark": ("janusx_tpu.cli.benchmark", "Time core kernels on simulated data"),
    "postgarfield": ("janusx_tpu.cli.postgarfield", "GARFIELD rule plots"),
}

# secondary entry points living inside a module file
_SUBENTRY = {
    "kmerge": ("janusx_tpu.cli.kmer", "kmerge_main", "Merge k-mer counts to a presence matrix"),
    "kstats": ("janusx_tpu.cli.kmer", "kstats_main", "K-mer count statistics"),
    "gblupbench": ("janusx_tpu.cli.benchmark", "gblupbench_main",
                   "GBLUP/rrBLUP route timing + accuracy benchmark"),
    "bayesbench": ("janusx_tpu.cli.benchmark", "bayesbench_main",
                   "Bayes A/B/Cpi vs BLUP chain benchmark"),
    "garfieldbench": ("janusx_tpu.cli.benchmark", "garfieldbench_main",
                      "Planted-epistasis recovery power benchmark"),
}

_ALIASES = {"simulation": "sim", "adamixture": "fastpop"}


def _help() -> str:
    lines = [
        f"janusx-tpu {__version__} — accelerator-native GWAS + genomic selection",
        "",
        "usage: jx <module> [options]",
        "",
        "modules:",
    ]
    for name, (_, desc) in _MODULES.items():
        lines.append(f"  {name:<10} {desc}")
    for name, (_, _fn, desc) in _SUBENTRY.items():
        lines.append(f"  {name:<10} {desc}")
    lines.append("")
    lines.append("run `jx <module> -h` for module options")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_help())
        return 0
    if argv[0] in ("-V", "--version", "version"):
        print(__version__)
        return 0
    name = _ALIASES.get(argv[0], argv[0])
    if name in _SUBENTRY:
        modpath, fn, _desc = _SUBENTRY[name]
        mod = importlib.import_module(modpath)
        return int(getattr(mod, fn)(argv[1:]) or 0)
    entry = _MODULES.get(name)
    if entry is None:
        print(f"unknown module: {argv[0]}\n\n{_help()}", file=sys.stderr)
        return 2
    try:
        mod = importlib.import_module(entry[0])
    except ImportError as e:
        print(f"module {name} unavailable: {e}", file=sys.stderr)
        return 2
    return int(mod.main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
