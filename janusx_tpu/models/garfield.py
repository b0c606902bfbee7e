"""GARFIELD: logic-rule (epistasis) association search.

Device re-design of the reference's GARFIELD engine
(/root/reference/src/garfield/: packed 0/1 homozygote bitsets, AND/XOR
beam search with negation, correlation/MCC scoring, permutation null
calibration, GRM residualization — ~38k LoC of Rust/Metal).

Redesign: binary SNP features (hom-alt indicators) are rows of a 0/1
matrix B (m, n). Scoring every AND/AND-NOT/XOR extension of a beam seed
against every marker reduces to two device matmuls:

    num[s, j]  = (b_s ∘ t) · b_j     -> (S, n) @ (n, m)
    cnt[s, j]  = b_s · b_j           -> (S, n) @ (n, m)

where t is the centered residual (continuous traits, point-biserial
corr^2 score) or the 0/1 phenotype (binary traits, MCC^2 score — the
confusion matrix is fully determined by tp, rule support, case count
and n). AND-NOT derives from the same products via complements
(cnt_andn = seed_cnt - cnt_and), XOR from inclusion-exclusion. The beam
keeps the top-B rules per depth; significance comes from a maxT
permutation null (the reference's permutation calibration).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from janusx_tpu.io.packed import PackedGenotypes

_EPS = 1e-9
_OPS = ("AND", "ANDN", "XOR")


@partial(jax.jit, static_argnames=("mode",))
def _extension_scores(Bseed, B, t, t2sum, n_real: float, mode: str):
    """Scores of AND / AND-NOT / XOR extensions for each (seed, marker).

    Bseed: (S, n) 0/1 seed rule vectors; B: (m, n) 0/1 marker features;
    t: (n,) centered residual (mode="corr") or 0/1 phenotype
    (mode="mcc"). Returns dict op -> ((S, m) score, (S, m) support).
    """
    hp = jax.lax.Precision.HIGHEST
    bt = Bseed * t[None, :]
    num_and = jnp.dot(bt, B.T, precision=hp)  # (S, m)
    cnt_and = jnp.dot(Bseed, B.T, precision=hp)  # (S, m)
    seed_cnt = jnp.sum(Bseed, axis=1)[:, None]
    seed_num = jnp.sum(bt, axis=1)[:, None]
    mark_cnt = jnp.sum(B, axis=1)[None, :]
    mark_num = jnp.dot(B, t, precision=hp)[None, :]
    pairs = {
        "AND": (num_and, cnt_and),
        "ANDN": (seed_num - num_and, seed_cnt - cnt_and),
        "XOR": (
            seed_num + mark_num - 2.0 * num_and,
            seed_cnt + mark_cnt - 2.0 * cnt_and,
        ),
    }

    if mode == "corr":

        def score(num, cnt):
            # point-biserial: corr^2 = num^2 / (t't · cnt (1 - cnt/n))
            var = cnt * (1.0 - cnt / n_real)
            return (num * num) / (t2sum * jnp.maximum(var, _EPS))

    else:  # mcc: num = tp, t2sum = #cases

        def score(tp, cnt):
            fp = cnt - tp
            fn = t2sum - tp
            tn = n_real - cnt - fn
            num = tp * tn - fp * fn
            den = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
            return (num * num) / jnp.maximum(den, _EPS)

    return {
        op: (score(num, cnt), cnt) for op, (num, cnt) in pairs.items()
    }


@dataclass
class Rule:
    snps: tuple  # marker indices
    ops: tuple  # "VAR"/"NOT", then "AND"/"ANDN"/"XOR" per extension
    score: float  # corr^2 (continuous) or MCC^2 (binary) vs target
    support: int  # carriers

    def describe(self, snp_names) -> str:
        head = str(snp_names[self.snps[0]])
        parts = [f"NOT {head}" if self.ops[0] == "NOT" else head]
        for op, idx in zip(self.ops[1:], self.snps[1:]):
            shown = "AND NOT" if op == "ANDN" else op
            parts.append(f"{shown} {snp_names[idx]}")
        return " ".join(parts)


@dataclass
class GarfieldResult:
    rules: list  # Rule, sorted by score desc
    perm_max_scores: np.ndarray  # maxT null distribution
    pvalues: np.ndarray  # empirical p per rule
    mode: str = "corr"


def _residualize(y, covariates, K=None):
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = np.ones((n, 1)) if covariates is None else np.concatenate(
        [np.ones((n, 1)), np.asarray(covariates, np.float64)], axis=1
    )
    if K is not None:
        from janusx_tpu.gs.blup import fit_gblup

        mdl = fit_gblup(K, y, np.arange(n), None if covariates is None else covariates)
        u = K @ mdl.alpha
        # subtract the REML (GLS) fixed-effect fit — the one alpha was
        # computed against — not an OLS refit, which would leave
        # covariate-direction signal in the residual under structure
        r = y - X @ mdl.beta - u
    else:
        b, *_ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ b
    return r - r.mean()


def _single_scores(B, t, t2sum, mode, n):
    """Depth-1 scores for every marker and its negation."""
    cnt = B.sum(axis=1).astype(np.float64)
    num = B @ t
    t_sum = float(t.sum())
    # negated literal: support n - cnt, num t_sum - num
    cnts = np.concatenate([cnt, n - cnt])
    nums = np.concatenate([num, t_sum - num])
    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "corr":
            var = cnts * (1.0 - cnts / n)
            s = nums**2 / (t2sum * np.maximum(var, _EPS))
        else:
            tp = nums
            fp = cnts - tp
            fn = t2sum - tp
            tn = n - cnts - fn
            den = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
            s = (tp * tn - fp * fn) ** 2 / np.maximum(den, _EPS)
    return s, cnts


def _score_np(num, cnt, t2sum, n, mode):
    """Host-side twin of _extension_scores' score closure (same formula,
    numpy) — used by the elementwise pair screen."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "corr":
            var = cnt * (1.0 - cnt / n)
            return (num * num) / (t2sum * np.maximum(var, _EPS))
        tp = num
        fp = cnt - tp
        fn = t2sum - tp
        tn = n - cnt - fn
        s = tp * tn - fp * fn
        den = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
        return (s * s) / np.maximum(den, _EPS)


def _beam_search(B, t, depth, beam, snp_min_support, mode="corr", Bj=None):
    m, n = B.shape
    t = np.asarray(t, np.float64)
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    tj = jnp.asarray(t, jnp.float32)
    if Bj is None:
        # callers looping permutations pass the device matrix in once —
        # re-transferring the whole (m, n) f32 matrix per permutation
        # cost ~m*n*4 bytes x n_perm of redundant host->device traffic
        Bj = jnp.asarray(B, jnp.float32)

    s1, cnts1 = _single_scores(B, t, t2sum, mode, n)
    valid = (cnts1 >= snp_min_support) & (cnts1 <= n - snp_min_support)
    s1 = np.where(valid, s1, 0.0)
    order = np.argsort(s1)[::-1]
    rules: list[Rule] = []
    for i in order[:beam]:
        neg = i >= m
        j = int(i % m)
        rules.append(
            Rule((j,), ("NOT" if neg else "VAR",), float(s1[i]), int(cnts1[i]))
        )
    frontier = [
        (ru, (1 - B[ru.snps[0]] if ru.ops[0] == "NOT" else B[ru.snps[0]]))
        for ru in rules
    ]
    all_rules = list(rules)
    for _d in range(1, depth):
        seeds = np.stack([v for _, v in frontier]).astype(np.float32)
        ext = _extension_scores(
            jnp.asarray(seeds), Bj, tj, t2sum, float(n), mode
        )
        ext = {op: (np.asarray(s), np.asarray(c)) for op, (s, c) in ext.items()}
        cand = []
        for si, (ru, vec) in enumerate(frontier):
            for op in _OPS:
                scores, counts = ext[op][0][si], ext[op][1][si]
                ok = (counts >= snp_min_support) & (counts <= n - snp_min_support)
                scr = np.where(ok, scores, 0.0)
                top = np.argsort(scr)[::-1][: max(4, beam // len(frontier))]
                for j in top:
                    if int(j) in ru.snps or scr[j] <= ru.score + 1e-9:
                        continue
                    cand.append((float(scr[j]), si, int(j), op))
        cand.sort(reverse=True)
        next_frontier = []
        seen = set()
        for score, si, j, op in cand:
            ru, vec = frontier[si]
            key = (tuple(sorted(ru.snps + (j,))), op, ru.ops[0])
            if key in seen:
                continue
            seen.add(key)
            if op == "AND":
                newvec = vec & B[j]
            elif op == "ANDN":
                newvec = vec & (1 - B[j])
            else:
                newvec = vec ^ B[j]
            newvec = newvec.astype(np.uint8)
            new_rule = Rule(
                ru.snps + (j,), ru.ops + (op,), score, int(newvec.sum())
            )
            next_frontier.append((new_rule, newvec))
            if len(next_frontier) >= beam:
                break
        if not next_frontier:
            break
        frontier = next_frontier
        all_rules.extend(ru for ru, _ in frontier)
    all_rules.sort(key=lambda ru: ru.score, reverse=True)
    return all_rules


def preselect_features(
    B: np.ndarray, t: np.ndarray, mode: str, top_k: int,
    pair_sample: int = 2000, seed: int = 0,
) -> np.ndarray:
    """ML feature pre-selection (reference src/ml/engine.rs:14-27):
    univariate scores plus a sampled pairwise-AND interaction screen —
    keeps markers that score well alone OR inside a sampled AND pair."""
    m, n = B.shape
    if m <= top_k:
        return np.arange(m)
    t = np.asarray(t, np.float64)
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    s1, _ = _single_scores(B, t, t2sum, mode, n)
    uni = np.maximum(s1[:m], s1[m:])  # best of literal / negated literal
    rng = np.random.default_rng(seed)
    n_pairs = min(pair_sample, m * (m - 1) // 2)
    ii = rng.integers(0, m, size=n_pairs)
    jj = rng.integers(0, m, size=n_pairs)
    pair_best = np.zeros(m)
    if n_pairs:
        # elementwise per-pair scores: the earlier (P, P) cross-product
        # matmuls computed P^2 scores of which only the P diagonal
        # entries were used — O(P n) here, same numbers
        Bi = B[ii].astype(np.float64)
        Bjp = B[jj].astype(np.float64)
        num_and = np.einsum("pn,pn->p", Bi * t[None, :], Bjp)
        cnt_and = np.einsum("pn,pn->p", Bi, Bjp)
        seed_cnt, seed_num = Bi.sum(axis=1), Bi @ t
        mark_cnt, mark_num = Bjp.sum(axis=1), Bjp @ t
        pairs = {
            "AND": (num_and, cnt_and),
            "ANDN": (seed_num - num_and, seed_cnt - cnt_and),
            "XOR": (seed_num + mark_num - 2.0 * num_and,
                    seed_cnt + mark_cnt - 2.0 * cnt_and),
        }
        for op in _OPS:
            num_o, cnt_o = pairs[op]
            d = _score_np(num_o, cnt_o, t2sum, float(n), mode)
            np.maximum.at(pair_best, ii, d)
            np.maximum.at(pair_best, jj, d)
    combined = np.maximum(uni, 0.5 * pair_best)
    return np.sort(np.argsort(combined)[::-1][:top_k])


def garfield_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    K: np.ndarray | None = None,
    depth: int = 2,
    beam: int = 64,
    n_perm: int = 100,
    top_rules: int = 50,
    min_support: int = 5,
    seed: int = 0,
    trait_type: str = "auto",
    preselect: int = 0,
    snp_subset: np.ndarray | None = None,
) -> GarfieldResult:
    """Search AND/AND-NOT/XOR rules over hom-alt indicators.

    Continuous traits score by residualized point-biserial corr^2
    (optionally GRM-residualized via K); binary 0/1 traits score by MCC^2
    on the raw phenotype (reference beam_search_and_binary_mcc).
    ``preselect`` > 0 screens markers with the ML feature scorer first;
    ``snp_subset`` restricts the search to those marker rows (window
    scans)."""
    d = pg.dosages()
    if snp_subset is not None:
        d = d[np.asarray(snp_subset)]
    B = (d == 2).astype(np.uint8)  # hom-alt bitplanes (reference bitsets)
    return garfield_scan_features(
        B, y, covariates=covariates, K=K, depth=depth, beam=beam,
        n_perm=n_perm, top_rules=top_rules, min_support=min_support,
        seed=seed, trait_type=trait_type, preselect=preselect,
        snp_subset=snp_subset,
    )


def garfield_scan_features(
    B: np.ndarray,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    K: np.ndarray | None = None,
    depth: int = 2,
    beam: int = 64,
    n_perm: int = 100,
    top_rules: int = 50,
    min_support: int = 5,
    seed: int = 0,
    trait_type: str = "auto",
    preselect: int = 0,
    snp_subset: np.ndarray | None = None,
) -> GarfieldResult:
    """Rule search over an explicit (m, n) 0/1 feature matrix ``B`` —
    e.g. BIN01 k-mer presence/absence rows (reference
    garfield_scan_windows_bin_py, src/lib.rs:751-767)."""
    B = np.asarray(B, np.uint8)
    y = np.asarray(y, np.float64).reshape(-1)
    uniq = np.unique(y[np.isfinite(y)])
    binary = trait_type == "binary" or (
        trait_type == "auto" and len(uniq) <= 2 and set(uniq) <= {0.0, 1.0}
    )
    if binary:
        mode = "mcc"
        t = y.astype(np.float64)
    else:
        mode = "corr"
        t = _residualize(y, covariates, K)

    B_full = B
    if preselect and preselect < B.shape[0]:
        kept = preselect_features(B, t, mode, preselect, seed=seed)
        B = B[kept]
    else:
        kept = None

    Bj = jnp.asarray(B, jnp.float32)  # device matrix uploaded ONCE
    rules = _beam_search(B, t, depth, beam, min_support, mode,
                         Bj=Bj)[:top_rules]

    # permutation null: max score under shuffled target (maxT)
    rng = np.random.default_rng(seed)
    null_max = np.empty(n_perm)
    for p_i in range(n_perm):
        tp = rng.permutation(t)
        # the null search must repeat the WHOLE observed pipeline —
        # including the ML preselection step: selecting once on the
        # observed t and only permuting inside that subset lets the
        # observed selection advantage leak into the null (lower null
        # maxima -> anti-conservative maxT p-values), the same failure
        # mode the fixed-beam comment below guards against
        if kept is not None:
            kept_p = preselect_features(B_full, tp, mode, preselect,
                                        seed=seed)
            B_p, Bj_p = B_full[kept_p], None
        else:
            B_p, Bj_p = B, Bj
        # the null search must use the SAME beam as the observed search:
        # a weaker null search finds lower maxima and makes the maxT
        # p-values anti-conservative
        null_rules = _beam_search(B_p, tp, depth, beam, min_support, mode,
                                  Bj=Bj_p)
        null_max[p_i] = null_rules[0].score if null_rules else 0.0
    scores = np.array([ru.score for ru in rules])
    pvals = np.array(
        [(1 + np.sum(null_max >= s)) / (n_perm + 1) for s in scores]
    )
    if kept is not None:  # map pre-selection indices back to marker rows
        rules = [
            Rule(tuple(int(kept[s]) for s in ru.snps), ru.ops, ru.score, ru.support)
            for ru in rules
        ]
    if snp_subset is not None:
        sub = np.asarray(snp_subset)
        rules = [
            Rule(tuple(int(sub[s]) for s in ru.snps), ru.ops, ru.score, ru.support)
            for ru in rules
        ]
    return GarfieldResult(
        rules=rules, perm_max_scores=null_max, pvalues=pvals, mode=mode
    )


def garfield_window_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    window_kb: float = 500.0,
    step_kb: float | None = None,
    top_per_window: int = 3,
    **kw,
) -> list[tuple[str, int, int, GarfieldResult]]:
    """Window-restricted rule scans (reference garfield_scan_windows_bin):
    the rule search runs independently inside each genomic window, so
    rules stay local (cis-epistasis) and windows parallelize trivially.

    Returns [(chrom, start_bp, end_bp, GarfieldResult), ...]."""
    win = int(window_kb * 1000)
    step = int((step_kb or window_kb) * 1000)
    out = []
    chroms = pg.sites.chrom
    pos = pg.sites.pos
    for c in dict.fromkeys(chroms):
        on_c = np.nonzero(chroms == c)[0]
        if len(on_c) == 0:
            continue
        lo, hi = int(pos[on_c].min()), int(pos[on_c].max())
        for start in range(lo, hi + 1, step):
            end = start + win
            rows = on_c[(pos[on_c] >= start) & (pos[on_c] < end)]
            if len(rows) < 2:
                continue
            res = garfield_scan(pg, y, snp_subset=rows, **kw)
            res.rules = res.rules[:top_per_window]
            res.pvalues = res.pvalues[:top_per_window]
            out.append((str(c), start, end, res))
    return out


def parse_pm_spec(spec) -> tuple[str, float]:
    """Parse the reference `-pm/--permutation` threshold spec
    (script/garfield.py:2010-2051 _parse_rule_null_penalty_spec):
    None/'gev'/'gumbel'/'auto' -> GEV at q=0.99; 'gNN[.N]' -> GEV at
    NN/100; 'qNN[.N]' -> empirical quantile; a float in (0,1) ->
    empirical quantile. Returns (method, quantile)."""
    if spec is None:
        return "gev", 0.99
    text = str(spec).strip().lower()
    if text in ("gev", "gumbel", "auto"):
        return "gev", 0.99
    if text and text[0] in ("g", "q"):
        try:
            q = float(text[1:]) / 100.0
        except ValueError:
            raise ValueError(
                f"-pm: bad spec {spec!r} (want gev, g99, g99.9, q99, or a "
                f"float in (0,1))")
        method = "gev" if text[0] == "g" else "quantile"
    else:
        try:
            q = float(text)
        except ValueError:
            raise ValueError(
                f"-pm: bad spec {spec!r} (want gev, g99, g99.9, q99, or a "
                f"float in (0,1))")
        method = "quantile"
    if not (0.0 < q < 1.0):
        raise ValueError(f"-pm: quantile must be in (0,1), got {q}")
    return method, q


def rule_null_threshold(perm_max_scores: np.ndarray, method: str = "gev",
                        quantile: float = 0.99) -> float:
    """Permutation-null score threshold for rule significance.

    'gev': Gumbel (GEV type-I) method-of-moments fit to the permutation
    max scores — scale = std*sqrt(6)/pi, loc = mean - gamma*scale,
    threshold = loc - scale*ln(-ln(q)) (reference
    src/garfield/permutation.rs:468 gumbel_penalty_from_maxima).
    'quantile': nearest-rank empirical quantile of the max scores."""
    s = np.asarray(perm_max_scores, np.float64)
    s = s[np.isfinite(s)]
    if s.size == 0:
        return float("inf")
    if method == "quantile":
        k = min(max(int(np.ceil(quantile * s.size)), 1), s.size)
        return float(np.sort(s)[k - 1])
    mean = float(s.mean())
    std = float(s.std(ddof=1)) if s.size > 1 else 0.0
    if not std > 0:
        return mean
    euler_gamma = 0.5772156649015329
    scale = std * np.sqrt(6.0) / np.pi
    loc = mean - euler_gamma * scale
    log_term = -np.log(quantile)
    if not (np.isfinite(log_term) and log_term > 0):
        return loc
    thr = loc - scale * np.log(log_term)
    return float(thr) if np.isfinite(thr) else loc


def bh_fdr(pvalues: np.ndarray, n_tests: int | None = None) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values; ``n_tests`` overrides the
    test count (the reference `-m/--meff` effective-test correction,
    script/garfield.py:2674)."""
    p = np.asarray(pvalues, np.float64)
    m = int(n_tests) if n_tests else p.size
    order = np.argsort(p)
    adj = np.empty_like(p)
    running = 1.0
    for rank_from_end, i in enumerate(order[::-1]):
        rank = p.size - rank_from_end
        running = min(running, p[i] * m / rank)
        adj[i] = min(running, 1.0)
    return adj


def write_garfield_tsv(path: str, res: GarfieldResult, sites,
                       score_threshold: float | None = None,
                       meff: int | None = None) -> None:
    """``score_threshold`` (from -pm) adds a `sig` column; ``meff`` adds a
    `pfdr` column (BH over pperm with meff as the test count)."""
    extra = ""
    if score_threshold is not None:
        extra += "\tsig"
    pfdr = None
    if meff is not None:
        pfdr = bh_fdr(np.asarray(res.pvalues), n_tests=meff)
        extra += "\tpfdr"
    with open(path, "wt") as fh:
        fh.write("rule\tdepth\tsupport\tscore\tpperm" + extra + "\n")
        for k, (ru, p) in enumerate(zip(res.rules, res.pvalues)):
            row = (f"{ru.describe(sites.snp)}\t{len(ru.snps)}\t{ru.support}"
                   f"\t{ru.score:.6g}\t{p:.4g}")
            if score_threshold is not None:
                row += f"\t{int(ru.score >= score_threshold)}"
            if pfdr is not None:
                row += f"\t{pfdr[k]:.4g}"
            fh.write(row + "\n")
