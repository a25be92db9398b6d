"""The numbers ``correct`` compares, each against the limit the cell's
workload file gives it.

Training (the first ``checked_steps`` steps, which set-up drives through
the window's own step and feed): each step's loss; each leaf's norm of the
first step's gradient as the optimizer got it (AdamW's first moment after
one step over ``1 - b1``); each leaf's norm of the change of the master
weights over the checked steps.  A norm is compared by its worst leaf: the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.

Prefill (a sample of the window's requests, the longest among them): the
widest gap by which the served token's reference logit (the program's
argmax) lies below the reference's best; the relative L2 error of the
last-token logits; of each leaf of the packed serve state.
"""
from __future__ import annotations

import math
import statistics

import torch

#: A leaf's reference gradient under this share of the median leaf's.
STILL = 1e-3


def _rel_gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def worst_leaf(got: dict, want: dict, skip=()) -> tuple[float, str]:
    med = statistics.median(want.values())
    best = (0.0, "")
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        gap = math.inf if not math.isfinite(g) else _rel_gap(g, w, med)
        if gap > best[0] or not best[1]:
            best = (gap, k)
    return best


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``losses``, ``grad_norms`` and
    ``update_norms`` (leaf -> norm)."""
    gaps = [math.inf if not math.isfinite(p) else _rel_gap(p, r, 0.0)
            for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    loss = max(gaps)
    med = statistics.median(ref["grad_norms"].values())
    still = {k for k, g in ref["grad_norms"].items() if g < STILL * med}
    grad, grad_leaf = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    upd, upd_leaf = worst_leaf(prog["update_norms"], ref["update_norms"],
                               skip=still)
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "update_norm_gap": upd,
            "_where": {"loss_gaps": gaps, "grad_norm_gap": grad_leaf,
                       "update_norm_gap": upd_leaf,
                       "left_out": sorted(still)}}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    num = float(torch.linalg.vector_norm(got - want))
    den = float(torch.linalg.vector_norm(want))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def prefill_numbers(pairs: list) -> dict:
    """``pairs``: per compared request ``(prog_state, prog_logits,
    ref_state, ref_logits)`` with the logits ``(b, vocab)``."""
    gap = logit = state = 0.0
    where = ""
    for p_state, p_logits, r_state, r_logits in pairs:
        r = r_logits.double()
        served = torch.argmax(p_logits.float(), dim=-1)
        g = float((r.max(-1).values - r.gather(-1, served[:, None])[:, 0]
                   ).max())
        gap = max(gap, g if math.isfinite(g) else math.inf)
        logit = max(logit, rel_l2(p_logits, r_logits))
        for k, want in r_state.items():
            if not torch.is_tensor(want):
                if p_state[k] != want:
                    state, where = math.inf, k
                continue
            e = rel_l2(p_state[k], want)
            if e > state:
                state, where = e, k
    return {"logit_gap": gap, "logits_rel": logit, "state_rel": state,
            "_where": {"state_rel": where}}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(every number the cell's limits name is within its limit, {name:
    {"value", "limit"}})``.  A number the limits do not name is reported
    but not judged (a training cell's number with no upper reading)."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
