"""GWAS pipeline orchestration.

Device re-design of the reference pipeline
(/root/reference/python/janusx/assoc/workflow.py:_run_gwas_pipeline :7159):

  load genotype -> QC/pack -> GRM (all genotyped samples w/ QC on full set)
  -> optional PCs -> per trait: subset samples (pheno+cov non-missing),
  re-prepare packed subset, eigh(K_subset + 1e-6 I), null REML fit,
  LMM->LM auto-switch (null LRT p >= 0.05 unless force_model,
  workflow.py:848), scan, TSV + summary.

Caching follows the reference naming contract where applicable
(~prefix genotype cache, {prefix}.maf{..}.geno{..}.cGRM.npy + .id).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np

from janusx_tpu import config
from janusx_tpu.core import stats as jstats
from janusx_tpu.core.reml import fit_null_reml_host
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io.gfreader import load_raw_packed
from janusx_tpu.io.packed import QcParams
from janusx_tpu.io.pheno import load_phenotype, load_covariates
from janusx_tpu.models import lm as lm_mod
from janusx_tpu.models import fvlmm as fvlmm_mod
from janusx_tpu.models import lmm as lmm_mod
from janusx_tpu.models.scan_common import ScanResult, analysis_sample_index


log = logging.getLogger("janusx_tpu.gwas")


@dataclass
class GwasConfig:
    """Mirrors the reference AssociationConfig (assoc/config.py:39) surface."""

    genotype: str
    phenotype: str
    out_prefix: str = "./jx_out"
    models: tuple[str, ...] = ("lmm",)  # lm | lmm | lmm2 | fvlmm
    traits: list | None = None  # indices or names; None = all
    covariates: str | None = None  # covariate file
    n_pcs: int = 0
    maf: float = config.DEFAULT_MAF
    geno: float = config.DEFAULT_GENO
    het: float = config.DEFAULT_HET
    grm_method: int = 1
    force_model: bool = False
    block: int = config.DEFAULT_SNP_BLOCK
    write_tsv: bool = True
    splmm_cutoff: float = config.knob("JX_TPU_SPARSE_CUTOFF")  # reference default 0.05 (workflow.py:6701)
    # -splmm-exact's own cutoff (None = splmm_cutoff); the reference keeps
    # one cutoff per run config, so the two routes may differ in one run
    splmm_exact_cutoff: float | None = None
    lowrank_snps: int = 4096  # kinship SNPs for the -lowrank FaST-LMM route
    # -global: reuse the full-sample row-stat pass for trait subsets
    # instead of strict-train re-preparation (reference workflow.py:6895)
    global_stats: bool = False
    genetic_model: str = "add"  # add|dom|rec|het (fastlmm_lowrank.rs)
    lowrank_ld_prune: bool = False  # LD-prune the kinship SNP picks
    scan_method: str = config.knob("JX_TPU_SCAN_METHOD")  # lmm lambda search: "grid" | "brent"
    # -spk: sparse-GRM source for the splmm routes — "1" centered,
    # "2" standardized, or a precomputed .jxgrm/.spgrm path
    # (reference workflow.py -spk/--grm-sparse)
    sparse_grm: str = "1"
    # -bimrange chr:start-end (repeatable): restrict only the final scan;
    # GRM/PCA/covariate prep still use the full genotype
    scan_ranges: tuple = ()
    # --farmcpu-* dev knobs (reference parse_args)
    farmcpu_iter: int = 10
    farmcpu_threshold: float | None = None
    farmcpu_qtn_bound: int | None = None
    # reference --farmcpu-nbin: candidate-grid denominator (default 5,
    # validated >= 1 — assoc/workflow.py:6842,6988)
    farmcpu_nbin: int = 5
    farmcpu_bin_sizes: tuple = (500_000, 5_000_000, 50_000_000)
    # -trait-level: single combined multi-trait TSV in addition to the
    # per-trait files (reference trait-level fast path; our subset/basis
    # sharing across identical masks is always on)
    trait_level: bool = False
    # -qvcf/-qhmp/-qbfile/-qfile: alternate QTN-search panel for the
    # FarmCPU/ALGWAS stage-1 selection (reference dev flags)
    qtn_genotype: str | None = None
    use_cache: bool = True  # GRM npy+id cache with reference naming
    # devices over the 'snp' mesh axis: None = all local devices (mesh is
    # skipped when only 1 is available), 1 = force single-device
    n_devices: int | None = None


@dataclass
class TraitRunResult:
    trait: str
    model: str  # model actually run (after any LMM->LM switch)
    requested_model: str
    result: ScanResult
    n_samples: int
    n_snps: int
    lambda_null: float | None = None
    switch_lrt_p: float | None = None
    tsv_path: str | None = None
    seconds: float = 0.0


def lmm_to_lm_switch_p(basis, y, covariates) -> float:
    """Boundary LRT p for H0: Va = 0 (mixed null vs OLS null).

    Mirrors the reference exactly (workflow.py:848 +
    src/stats/gwas_unified.rs:121-175): stat = 2*(ML_lmm0 - ML_lm0) with
    ML_lm0 the Gaussian OLS loglik, p = 0.5*chi2_sf_df1(stat) (boundary
    mixture), switch to LM when p >= 0.05. Uses the host null fit — a
    covariates-only fit is microseconds on host but costs one XLA compile
    per distinct sample count on device (core.reml.fit_null_reml_host)."""
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = lm_mod.design_matrix(n, covariates)
    null, _, _ = fit_null_reml_host(basis.S, basis.U.T @ X, basis.U.T @ y)
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    rss = float(np.sum((y - X @ beta) ** 2))
    ml_lm = -0.5 * n * (np.log(2.0 * np.pi * rss / n) + 1.0)
    stat = 2.0 * (null.ml - ml_lm)
    stat = max(stat, 0.0) if np.isfinite(stat) else 0.0
    p = 0.5 * float(jstats.chi2_sf_df1(np.asarray(stat)))
    if not np.isfinite(p):
        p = 1.0
    return min(max(p, np.finfo(np.float64).tiny), 1.0)


def _range_mask(sites, ranges) -> np.ndarray:
    """Indices of SNPs inside any -bimrange spec (chr:start-end or
    chr:start:end; values < 1e5 are Mb, larger are bp — reference
    workflow.py -bimrange help)."""
    chrom = np.asarray(sites.chrom, dtype=object).astype(str)
    pos = np.asarray(sites.pos, np.int64)
    mask = np.zeros(len(pos), bool)
    for spec in ranges:
        txt = str(spec).strip()
        if ":" not in txt:
            raise ValueError(f"-bimrange wants chr:start-end, got {spec!r}")
        c, rest = txt.split(":", 1)
        sep = ":" if ":" in rest else "-"
        a_s, b_s = rest.split(sep, 1)
        a, b = float(a_s), float(b_s)
        # Mb by default; large values treated as bp
        lo = int(a * 1e6) if a < 1e5 else int(a)
        hi = int(b * 1e6) if b < 1e5 else int(b)
        mask |= (chrom == c.strip()) & (pos >= lo) & (pos <= hi)
    return np.nonzero(mask)[0]


def resolve_mesh(n_devices: int | None):
    """The production device mesh: all local devices on the 'snp' axis
    (None when that degenerates to a single device). JX_TPU_DEVICES caps
    the count when the caller does not."""
    import jax

    from janusx_tpu.parallel.mesh import make_mesh

    avail = jax.device_count()
    if n_devices is None:
        n_devices = config.knob("JX_TPU_DEVICES")
    nd = avail if n_devices is None else min(n_devices, avail)
    if nd <= 1:
        return None
    return make_mesh(nd)


def run_gwas(cfg: GwasConfig) -> list[TraitRunResult]:
    t0 = time.monotonic()
    if "farmcpu" in cfg.models and "frgwas" in cfg.models:
        # reference parity (assoc/workflow.py:6979: "Only one of
        # -farmcpu / -frgwas may be specified") — and both share the
        # FarmCPU TSV tag, so running both would overwrite one output
        raise ValueError("only one of farmcpu / frgwas may be requested")
    qc = QcParams(maf=cfg.maf, geno=cfg.geno, het=cfg.het)
    mesh = resolve_mesh(cfg.n_devices)
    if mesh is not None:
        log.info("device mesh: %d devices on the 'snp' axis", mesh.devices.size)
    from janusx_tpu.utils.progress import stage

    with stage("genotype read", log):
        raw = load_raw_packed(cfg.genotype)
    log.info("genotype: %d SNPs x %d samples", raw.m, raw.n_samples)
    qraw = None
    if cfg.qtn_genotype:
        qraw = load_raw_packed(cfg.qtn_genotype)
        log.info("QTN-search panel: %d SNPs x %d samples", qraw.m, qraw.n_samples)

    ph = load_phenotype(cfg.phenotype).select(cfg.traits)
    y_all, matched = ph.align(raw.samples)
    if not matched.any():
        raise ValueError("no phenotype sample IDs match the genotype samples")

    cov_all = (
        load_covariates(cfg.covariates, raw.samples) if cfg.covariates else None
    )

    # GRM on all genotyped samples with full-set QC (reference:
    # load_or_build_grm_with_cache, workflow.py:3123). Sparse-only model
    # sets (-splmm/-splmm-exact) skip the dense n^2 GRM entirely and build
    # the thresholded sparse GRM band-streamed with a .jxgrm cache
    # (reference _ensure_splmm_sparse_grm, workflow_model_packed.py:807).
    from janusx_tpu.utils.cache import load_or_build_grm, load_or_build_sparse_grm

    with stage("QC/pack (full sample set)", log):
        pg_full = raw.prepare(qc)
    need_sparse = any(m in ("splmm", "splmm-exact") for m in cfg.models)
    need_dense = cfg.n_pcs > 0 or any(
        m in ("lmm", "lmm2", "fvlmm", "fvlmm2") for m in cfg.models
    )
    K = None
    Ksp = None
    Ksp_exact = None  # -splmm-exact with its own cutoff; else aliases Ksp
    if need_dense:
        with stage("GRM", log):
            K = load_or_build_grm(
                cfg.genotype, pg_full, cfg.maf, cfg.geno,
                method=cfg.grm_method, block=cfg.block,
                use_cache=cfg.use_cache, mesh=mesh,
            )
    if need_sparse:
        if cfg.sparse_grm not in ("1", "2"):
            # precomputed sparse GRM path (reference -spk FILE)
            from janusx_tpu.io.jxgrm import read_jxgrm

            with stage("sparse GRM (precomputed)", log):
                Ksp = read_jxgrm(cfg.sparse_grm).tocsr()
            id_candidates = [cfg.sparse_grm + ".id",
                             os.path.splitext(cfg.sparse_grm)[0] + ".id"]
            id_path = next((c for c in id_candidates if os.path.exists(c)), None)
            if id_path is not None:
                # align GRM rows to the genotype sample order by ID
                from janusx_tpu.utils.cache import _read_id_column

                grm_ids = _read_id_column(id_path)
                if len(grm_ids) != Ksp.shape[0]:
                    raise ValueError(
                        f"-spk id sidecar has {len(grm_ids)} ids, GRM dim "
                        f"{Ksp.shape[0]}")
                pos = {g: i for i, g in enumerate(grm_ids)}
                missing = [str(s_) for s_ in raw.samples if str(s_) not in pos]
                if missing:
                    raise ValueError(
                        f"{len(missing)} genotype samples absent from the "
                        f"-spk GRM ids, e.g. {missing[:3]}")
                perm = np.array([pos[str(s_)] for s_ in raw.samples])
                if not np.array_equal(perm, np.arange(len(perm))):
                    Ksp = Ksp[perm][:, perm].tocsr()
            elif Ksp.shape[0] != raw.n_samples:
                raise ValueError(
                    f"-spk GRM has {Ksp.shape[0]} samples, genotype has "
                    f"{raw.n_samples} (and no .id sidecar to align by)")
            else:
                log.warning("-spk GRM has no .id sidecar: assuming its rows "
                            "already match the genotype sample order")
        else:
            sp_method = 2 if cfg.sparse_grm == "2" else cfg.grm_method
            with stage("sparse GRM (band-streamed)", log):
                Ksp = load_or_build_sparse_grm(
                    cfg.genotype, pg_full, cfg.maf, cfg.geno, cfg.splmm_cutoff,
                    method=sp_method, block=cfg.block, use_cache=cfg.use_cache,
                )
            exact_cut = (
                cfg.splmm_exact_cutoff
                if cfg.splmm_exact_cutoff is not None else cfg.splmm_cutoff
            )
            if "splmm-exact" in cfg.models and exact_cut != cfg.splmm_cutoff:
                with stage("sparse GRM (exact-route cutoff)", log):
                    Ksp_exact = load_or_build_sparse_grm(
                        cfg.genotype, pg_full, cfg.maf, cfg.geno, exact_cut,
                        method=sp_method, block=cfg.block,
                        use_cache=cfg.use_cache,
                    )

    pcs_full = None
    if cfg.n_pcs > 0:
        from janusx_tpu.utils.cache import load_or_build_pcs

        pcs_full = load_or_build_pcs(
            cfg.genotype, K, raw.samples, cfg.maf, cfg.geno, cfg.n_pcs,
            method=cfg.grm_method, use_cache=cfg.use_cache,
        )

    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_prefix)) or ".", exist_ok=True)
    out: list[TraitRunResult] = []
    summary = []
    # traits with identical analysis-sample masks share the prepared subset
    # and eigenbasis (common case: fully-observed multi-trait tables)
    prep_cache: dict = {}
    # -trait-level fast path: batch all 'lm' traits with a shared sample
    # mask into ONE device dispatch (decode + G-grams amortized across
    # traits — reference trait-level additive fast path)
    lm_batch: dict = {}  # (trait, model) -> ScanResult (+ null for lmm)
    batchable = {m for m in cfg.models if m in ("lm", "lmm", "lmm2", "fvlmm")}
    if cfg.trait_level and batchable and len(ph.traits) > 1:
        groups: dict = {}
        for ti, trait in enumerate(ph.traits):
            y = y_all[:, ti]
            cov_parts = []
            if pcs_full is not None:
                cov_parts.append(pcs_full)
            if cov_all is not None:
                cov_parts.append(cov_all)
            cov_full = np.concatenate(cov_parts, axis=1) if cov_parts else None
            keep = analysis_sample_index(y, cov_full)
            if len(keep) < 10:
                continue
            groups.setdefault(keep.tobytes(), []).append((ti, trait, keep, cov_full))
        for mask_key, members in groups.items():
            if len(members) < 2:
                continue
            _, _, keep, cov_full = members[0]
            if cfg.global_stats and len(keep) < raw.n_samples:
                from janusx_tpu.io.packed import subset_samples_keep_stats

                pg_b = subset_samples_keep_stats(pg_full, keep)
            elif len(keep) == raw.n_samples:
                pg_b = pg_full  # all samples kept: identical to pg_full
            else:
                pg_b = raw.prepare(qc, sample_idx=keep)
            entry_b = {"pg": pg_b, "basis": None}
            prep_cache[mask_key] = entry_b  # the loop reuses subset + basis
            if cfg.scan_ranges:
                idx = _range_mask(pg_b.sites, cfg.scan_ranges)
                if idx.size == 0:
                    continue
                entry_b["ranges_idx"] = idx
                entry_b["pg_ranges"] = pg_b.take_snps(idx)
                pg_b = entry_b["pg_ranges"]
            cov_b = None if cov_full is None else cov_full[keep]
            if "lm" in batchable:
                Yb = np.stack([y_all[:, ti][keep] for ti, *_ in members], axis=1)
                log.info("trait-level lm batch: %d traits in one dispatch",
                         len(members))
                for (ti, trait, *_), r in zip(members, lm_mod.lm_scan_multi(
                        pg_b, Yb, cov_b, block=cfg.block, mesh=mesh)):
                    lm_batch[(str(trait), "lm")] = r
            mixed = [m for m in ("lmm", "lmm2", "fvlmm") if m in batchable]
            if cfg.scan_method != "grid":
                # lmm_scan_multi is grid-only; honor -scan-method brent by
                # falling back to the per-trait path for the mixed models
                mixed = [m for m in mixed if m == "fvlmm"]
            if mixed:
                Ksub = K[np.ix_(keep, keep)]
                entry_b["basis"] = eigh_grm(Ksub, diag_ridge=1e-6)
                mem = members
                if not cfg.force_model:
                    # the LMM->LM switch is per trait: batch only the
                    # traits that keep the mixed model
                    mem = [mm for mm in members if lmm_to_lm_switch_p(
                        entry_b["basis"], y_all[:, mm[0]][keep], cov_b) < 0.05]
                if len(mem) >= 2:
                    Yb = np.stack([y_all[:, ti][keep] for ti, *_ in mem], axis=1)
                    for model_b in mixed:
                        log.info("trait-level %s batch: %d traits in one "
                                 "dispatch", model_b, len(mem))
                        if model_b == "fvlmm":
                            res_b, nulls_b = fvlmm_mod.fvlmm_scan_multi(
                                pg_b, entry_b["basis"], Yb, cov_b,
                                block=cfg.block, mesh=mesh)
                        else:
                            res_b, nulls_b = lmm_mod.lmm_scan_multi(
                                pg_b, entry_b["basis"], Yb, cov_b,
                                block=cfg.block, lmm2=(model_b == "lmm2"),
                                mesh=mesh)
                        for (ti, trait, *_), r, nl in zip(mem, res_b, nulls_b):
                            lm_batch[(str(trait), model_b)] = (r, nl)
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        cov_parts = []
        if pcs_full is not None:
            cov_parts.append(pcs_full)
        if cov_all is not None:
            cov_parts.append(cov_all)
        cov_full = np.concatenate(cov_parts, axis=1) if cov_parts else None
        keep = analysis_sample_index(y, cov_full)
        if len(keep) < 10:
            log.warning("trait %s: only %d usable samples, skipping", trait, len(keep))
            continue
        y_t = y[keep]
        cov_t = None if cov_full is None else cov_full[keep]
        mask_key = keep.tobytes()
        if mask_key in prep_cache:
            entry = prep_cache[mask_key]
            pg_t = entry["pg"]
        elif cfg.global_stats and len(keep) < raw.n_samples:
            from janusx_tpu.io.packed import subset_samples_keep_stats

            with stage(f"subset columns, global stats ({trait})", log):
                pg_t = subset_samples_keep_stats(pg_full, keep)
            entry = {"pg": pg_t, "basis": None}
            prep_cache[mask_key] = entry
        elif len(keep) == raw.n_samples:
            # fully-observed trait: re-preparing would recompute exactly
            # pg_full (a second O(m n) QC/pack pass per distinct mask)
            pg_t = pg_full
            entry = {"pg": pg_t, "basis": None}
            prep_cache[mask_key] = entry
        else:
            with stage(f"prepare subset ({trait})", log):
                pg_t = raw.prepare(qc, sample_idx=keep)
            entry = {"pg": pg_t, "basis": None}
            prep_cache[mask_key] = entry
        if qraw is not None and "pg_qtn" not in entry:
            qpos = {str(s_): i for i, s_ in enumerate(qraw.samples)}
            want = [str(raw.samples[i]) for i in keep]
            missing = [w for w in want if w not in qpos]
            if missing:
                raise ValueError(
                    f"{len(missing)} analysis samples absent from the "
                    f"QTN-search panel, e.g. {missing[:3]}")
            entry["pg_qtn"] = qraw.prepare(
                qc, sample_idx=np.array([qpos[w] for w in want]))
        pg_qtn_t = entry.get("pg_qtn")
        if cfg.scan_ranges:
            # -bimrange: restrict only the scan; GRM/PCA used the full set
            if "ranges_idx" not in entry:
                entry["ranges_idx"] = _range_mask(pg_t.sites, cfg.scan_ranges)
            idx = entry["ranges_idx"]
            if idx.size == 0:
                log.warning("trait %s: no SNPs inside -bimrange, skipping", trait)
                continue
            if "pg_ranges" not in entry:
                entry["pg_ranges"] = pg_t.take_snps(idx)
            pg_t = entry["pg_ranges"]
        log.info(
            "trait %s: n=%d m=%d models=%s", trait, len(keep), pg_t.m, cfg.models
        )

        def get_basis():
            if entry["basis"] is None:
                Ksub = K[np.ix_(keep, keep)]
                with stage(f"eigh ({trait})", log):
                    entry["basis"] = eigh_grm(Ksub, diag_ridge=1e-6)
            return entry["basis"]

        for model in cfg.models:
            t1 = time.monotonic()
            requested = model
            switch_p = None
            if model in ("lmm", "lmm2", "fvlmm") and not cfg.force_model:
                switch_p = lmm_to_lm_switch_p(get_basis(), y_t, cov_t)
                if switch_p >= 0.05:
                    log.info(
                        "trait %s: null LRT p=%.3g >= 0.05, switching %s -> lm",
                        trait, switch_p, model,
                    )
                    model = "lm"
                else:
                    log.info(
                        "trait %s: null LRT p=%.3g < 0.05, keeping %s",
                        trait, switch_p, model,
                    )
            if model == "lm":
                if requested == "lm" and (str(trait), "lm") in lm_batch:
                    res = lm_batch[(str(trait), "lm")]
                else:
                    res = lm_mod.lm_scan(pg_t, y_t, cov_t, block=cfg.block,
                                         mesh=mesh)
                lbd_null = None
            elif model in ("lmm", "lmm2", "fvlmm") and (str(trait), model) in lm_batch:
                res, null = lm_batch[(str(trait), model)]
                lbd_null = null.lbd
            elif model == "fvlmm":
                res, null = fvlmm_mod.fvlmm_scan(
                    pg_t, get_basis(), y_t, cov_t, block=cfg.block, mesh=mesh
                )
                lbd_null = null.lbd
            elif model in ("lmm", "lmm2"):
                basis = get_basis()
                with stage(f"{model} scan ({trait})", log):
                    res, null = lmm_mod.lmm_scan(
                        pg_t, basis, y_t, cov_t, block=cfg.block,
                        lmm2=(model == "lmm2"), method=cfg.scan_method,
                        mesh=mesh,
                    )
                lbd_null = null.lbd
            elif model == "splmm":
                from janusx_tpu.models.splmm import splmm_grammar_scan

                Ksub = Ksp[keep][:, keep].tocsc()
                res, info = splmm_grammar_scan(
                    pg_t, Ksub, y_t, cov_t, cutoff=cfg.splmm_cutoff,
                    block=cfg.block, mesh=mesh,
                )
                lbd_null = info["lambda_null"]
            elif model == "splmm-exact":
                # exact fixed-V scan under the thresholded kinship via
                # block-spectral per-SNP solves (models.splmm_exact_scan;
                # reference splmm.rs per-SNP sparse-Cholesky solves)
                from janusx_tpu.models.splmm import splmm_exact_scan

                Ksp_e = Ksp_exact if Ksp_exact is not None else Ksp
                exact_cut = (
                    cfg.splmm_exact_cutoff
                    if cfg.splmm_exact_cutoff is not None else cfg.splmm_cutoff
                )
                Ksub = Ksp_e[keep][:, keep].tocsc()
                res, info = splmm_exact_scan(
                    pg_t, Ksub, y_t, cov_t, cutoff=exact_cut,
                    block=cfg.block, mesh=mesh,
                )
                lbd_null = info["lambda_null"]
            elif model == "lowrank":
                # FaST-LMM low-rank exact scan: kinship from q SNP columns,
                # O(n q^2) basis + O(n k) per-SNP rotation — never forms
                # the dense n^2 GRM (src/stats/fastlmm_lowrank.rs)
                from janusx_tpu.models import fastlmm as fl

                lrb = entry.get("lrb")
                if lrb is None:
                    with stage(f"low-rank kinship basis ({trait})", log):
                        # kinship picks come from the full SNP set even
                        # under -bimrange (scan-only restriction)
                        lrb = fl.lowrank_basis_from_snps(
                            entry["pg"], q=cfg.lowrank_snps,
                            method=cfg.grm_method,
                            ld_prune=cfg.lowrank_ld_prune,
                        )
                    entry["lrb"] = lrb
                rot_lr = fl.make_rotated_lr(lrb, y_t, cov_t)
                null_lr = None
                if not cfg.force_model:
                    switch_p, null_lr = fl.lowrank_switch_p(rot_lr)
                    if switch_p >= 0.05:
                        log.info(
                            "trait %s: null LRT p=%.3g >= 0.05, switching lowrank -> lm",
                            trait, switch_p,
                        )
                        model = "lm"
                        res = lm_mod.lm_scan(
                            pg_t, y_t, cov_t, block=cfg.block, mesh=mesh
                        )
                        lbd_null = None
                if model == "lowrank":
                    res, null = fl.fastlmm_scan(
                        pg_t, lrb, y_t, cov_t, block=cfg.block,
                        model=cfg.genetic_model, rot=rot_lr, null=null_lr,
                        mesh=mesh,
                    )
                    lbd_null = null.lbd
            elif model == "farmcpu":
                from janusx_tpu.models.farmcpu import farmcpu_scan

                out_f = farmcpu_scan(
                    pg_t, y_t, cov_t, block=cfg.block,
                    p_threshold=cfg.farmcpu_threshold,
                    max_loops=cfg.farmcpu_iter,
                    window_sizes=tuple(cfg.farmcpu_bin_sizes),
                    qtn_bound=cfg.farmcpu_qtn_bound,
                    nbin=cfg.farmcpu_nbin,
                    pg_qtn=pg_qtn_t,
                    mesh=mesh,
                )
                res = out_f.result
                lbd_null = None
            elif model == "frgwas":
                from janusx_tpu.models.farmcpu import farmcpu_unified_scan

                out_f = farmcpu_unified_scan(
                    pg_t, y_t, cov_t, block=cfg.block,
                    p_threshold=cfg.farmcpu_threshold,
                    max_loops=cfg.farmcpu_iter,
                    qtn_bound=cfg.farmcpu_qtn_bound,
                    nbin=cfg.farmcpu_nbin,
                    window_sizes=tuple(cfg.farmcpu_bin_sizes),
                    mesh=mesh,
                )
                res = out_f.result
                lbd_null = None
            elif model == "algwas":
                from janusx_tpu.models.algwas import algwas_scan

                out_a = algwas_scan(pg_t, y_t, cov_t, block=cfg.block,
                                    pg_qtn=pg_qtn_t, mesh=mesh)
                res = out_a.result
                lbd_null = None
            elif model in ("lm2", "fvlmm2"):
                # interaction covariate = LAST covariate column (reference
                # hidden G-by-C routes, src/stats/glm2.rs / fvlmm2.rs)
                from janusx_tpu.models.gxe import gxe_scan

                if cov_t is None or cov_t.shape[1] == 0:
                    raise ValueError(f"{model} needs a covariate (-c/-q) for the interaction term")
                inter = cov_t[:, -1]
                main = cov_t[:, :-1] if cov_t.shape[1] > 1 else None
                res, null2 = gxe_scan(
                    pg_t, y_t, inter, main,
                    basis=get_basis() if model == "fvlmm2" else None,
                    block=cfg.block, mesh=mesh,
                )
                lbd_null = None if null2 is None else null2.lbd
            else:
                raise ValueError(f"unknown model: {model}")
            secs = time.monotonic() - t1
            tsv_path = None
            if cfg.write_tsv:
                tag = {
                    "lm": "LM", "lmm": "LMM", "lmm2": "LMM2", "fvlmm": "FvLMM",
                    "splmm": "SparseLMM", "splmm-exact": "SparseLMM2",
                    "farmcpu": "FarmCPU", "frgwas": "FarmCPU", "algwas": "ALGWAS",
                    "lm2": "LM2", "fvlmm2": "FvLMM2", "lowrank": "FaSTLMM",
                }[requested if requested != model and model == "lm" else model]
                tsv_path = f"{cfg.out_prefix}.{trait}.{tag}.assoc.tsv"
                with stage(f"write TSV ({trait})", log):
                    res.write_tsv(tsv_path)
            out.append(
                TraitRunResult(
                    trait=str(trait), model=model, requested_model=requested,
                    result=res, n_samples=len(keep), n_snps=pg_t.m,
                    lambda_null=lbd_null, switch_lrt_p=switch_p,
                    tsv_path=tsv_path, seconds=secs,
                )
            )
            summary.append(
                {
                    "trait": str(trait), "model": model, "requested": requested,
                    "n": len(keep), "m": pg_t.m, "seconds": round(secs, 3),
                    "lambda_null": lbd_null, "tsv": tsv_path,
                }
            )
    if cfg.write_tsv and cfg.trait_level:
        # -trait-level: combined multi-trait TSVs with a leading `trait`
        # column. Runs are grouped by output schema (lmm2 carries extra
        # plrt/lambda/ml columns) so every file is rectangular; the first
        # schema keeps the plain name, extra schemas get a model suffix.
        by_header: dict = {}
        for r in out:
            if not r.tsv_path or not os.path.exists(r.tsv_path):
                continue
            with open(r.tsv_path) as src:
                hdr = src.readline()
            by_header.setdefault(hdr, []).append(r)
        for gi, (hdr, runs_h) in enumerate(by_header.items()):
            tag = "" if gi == 0 else f".{runs_h[0].model}"
            path = f"{cfg.out_prefix}.traitlevel{tag}.assoc.tsv"
            with open(path, "wt") as fh:
                fh.write("trait\tmodel\t" + hdr)
                for r in runs_h:
                    with open(r.tsv_path) as src:
                        src.readline()
                        for line in src:
                            fh.write(f"{r.trait}\t{r.model}\t" + line)
            log.info("trait-level combined TSV: %s", path)
    if cfg.write_tsv:
        with open(f"{cfg.out_prefix}.gwas.summary.json", "wt") as fh:
            json.dump(
                {"runs": summary, "total_seconds": round(time.monotonic() - t0, 3)},
                fh, indent=2,
            )
        from janusx_tpu.utils.history import record_run

        record_run("gwas", cfg.out_prefix,
                   {"models": list(cfg.models), "genotype": cfg.genotype},
                   [r.tsv_path for r in out if r.tsv_path],
                   round(time.monotonic() - t0, 3))
    return out
