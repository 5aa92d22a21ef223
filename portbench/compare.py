"""Comparisons of what the program produced with what the reference works
out, each reduced to one number that a limit holds."""

from __future__ import annotations

import math

import torch


def words_differing(a, b) -> int:
    """Elements that differ between two game states (any NamedTuple of
    tensors with the same fields in the same order), compared as int64 on
    the first's device; a field whose shape differs counts whole."""
    n = 0
    for x, y in zip(a, b):
        y = y.to(x.device)
        if x.shape != y.shape:
            n += max(x.numel(), y.numel())
        else:
            n += int((x.to(torch.int64) != y.to(torch.int64)).sum())
    return n


def leaf_norm_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """Each leaf's gap between the program's and the reference's norms,
    over the larger of that leaf's reference norm and the median leaf's:
    | |prog_k| - |ref_k| | / max(|ref_k|, median_j |ref_j|). A leaf that
    the program did not give counts with norm 0."""
    keys = list(ref) if leaves is None else list(leaves)
    ref_n = {k: float(ref[k].double().norm()) for k in ref}
    med = float(torch.tensor(sorted(ref_n.values()), dtype=torch.float64).median())
    return {k: abs((float(prog[k].double().norm()) if k in prog else 0.0) - ref_n[k])
            / max(ref_n[k], med, 1e-30) for k in keys}


def worst(gaps: dict) -> tuple:
    """(the largest gap, its leaf); NaN where any gap is NaN."""
    k = max(gaps, key=lambda j: math.inf if gaps[j] != gaps[j] else gaps[j])
    return gaps[k], k


def median(gaps: dict) -> float:
    """The median leaf's gap (the lower middle of an even count); NaN where any is."""
    vals = list(gaps.values())
    if any(v != v for v in vals):
        return math.nan
    return sorted(vals)[(len(vals) - 1) // 2]
