"""The numbers that decide ``correct``, each held against a limit of its
own from ``spedbench/limits/<cell>.json``.

* ``eigvec_err``: ||V - V_ref||_F / ||V_ref - V0||_F, the distance of a
  job's final panel from the reference's, as a share of how far the
  reference's steps moved the panel from the initial one (the panels
  themselves barely move in a few steps, so their own norm would hide
  an operator or step that is wrong).
* ``label_mismatch``: the share of nodes whose k-means label differs from
  the reference k-means' on the job's own final panel (same seeds, so
  the same label ids).  A few steps from a random panel leave the
  embedding without clusters, where any change of rounding in the panel
  flips about 0.1 % of the labels (PERF.md), so the labels are judged on
  the program's own panel, which ``eigvec_err`` judges: the comparison
  is exact.
"""
from __future__ import annotations

import math

import torch

from spedbench.reference.pipeline import Solve


def numbers(v: torch.Tensor, labels: torch.Tensor, ref: Solve,
            ref_labels: torch.Tensor) -> dict:
    """``v`` and ``labels``, a job's answer, against the reference's panel
    ``ref`` and the reference's labels of ``v``."""
    moved = float((ref.v.double() - ref.v0.double()).norm())
    gap = float((v.double() - ref.v.double()).norm())
    mismatch = float((labels.to(ref_labels.device).long()
                      != ref_labels.long()).double().mean())
    return {"eigvec_err": gap / moved if moved > 0 else math.inf,
            "label_mismatch": mismatch}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}}); a missing or
    non-finite value fails."""
    checks = {name: {"value": values.get(name, math.nan), "limit": lim}
              for name, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
