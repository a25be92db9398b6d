"""The command line: ``python -m repro_torch.analysis``.

Runs the three passes, merges findings against the baseline, writes the
JSON report, prints the text summary, and exits non-zero iff any finding
is not covered by a waiver.  ``--device`` defaults to the card, as every
entry point of the port does, and raises without one: there the dispatch
pass runs on the card (sync-debug window, HtoD bytes per call, allocator
counts) and the kernel-budget pass holds its mirror to each library's own
plan and attributes.  ``--device cpu`` runs the dispatch pass on the CPU
and the budget mirror alone; the AST pass needs no device.
``--update-baseline`` rewrites the baseline to waive every current
finding; NEW waivers take their justification from the mandatory
``--reason`` flag (prior waivers keep theirs), and ``load_baseline``
rejects empty or ``TODO`` justifications.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import ast_lint, dispatch_checks, kernel_budget
from repro_torch.analysis.report import Report, Waiver, dump_baseline, load_baseline


def build_report(root: str = ".", *, run_dispatch: bool = True,
                 run_ast: bool = True, run_budget: bool = True,
                 max_const_bytes: int | None = None,
                 smem_budget: int | None = None,
                 device=None) -> Report:
    """Run the selected passes over ``root`` (the dispatch pass and the
    budget's card checks on ``device``, the card when ``None``) and
    collect one Report."""
    from repro_torch.device import resolve_device

    report = Report()
    if run_dispatch or run_budget:
        device = resolve_device(device)
    on_card = (run_dispatch or run_budget) and device.type == "cuda"

    if run_ast:
        findings, info = ast_lint.lint_tree(root)
        report.extend(findings)
        report.info["ast_lint"] = info

    if run_dispatch:
        from repro_torch.analysis.entrypoints import build_registry

        entry_infos = []
        for entry in build_registry(device):
            if max_const_bytes is not None:
                entry.max_upload_bytes = max_const_bytes
            findings, info = dispatch_checks.run_entrypoint(
                entry, on_card=on_card)
            report.extend(findings)
            entry_infos.append(info)
        report.info["dispatch_checks"] = {"device": str(device),
                                          "entrypoints": entry_infos}

    if run_budget:
        findings, info = kernel_budget.check_kernels(
            smem_budget=smem_budget, on_card=on_card)
        report.extend(findings)
        report.info["kernel_budget"] = info

    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant analyzer of the port: dispatch "
                    "contracts, convention lint, kernel shared-memory and "
                    "register budgets.")
    ap.add_argument("--root", default=".", help="repo root to scan")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full JSON report here")
    ap.add_argument("--baseline", metavar="PATH",
                    help="committed waiver baseline "
                         "(analysis_baseline_torch.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline waiving every current finding "
                         "(new waivers need --reason)")
    ap.add_argument("--reason", metavar="TEXT", default=None,
                    help="justification recorded on NEW waivers written by "
                         "--update-baseline (prior waivers keep theirs)")
    ap.add_argument("--no-dispatch", action="store_true",
                    help="skip Pass 1 (the hot entry points)")
    ap.add_argument("--no-ast", action="store_true",
                    help="skip Pass 2 (AST lint)")
    ap.add_argument("--no-budget", action="store_true",
                    help="skip Pass 3 (kernel budgets)")
    ap.add_argument("--max-const-bytes", type=int, default=None,
                    help="UPLOAD-PER-CALL threshold (default 1 MiB)")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="SMEM-BUDGET threshold in bytes (default: the "
                         "card's opt-in shared memory per block, the "
                         "H100's 232,448 on the CPU)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where Pass 1 runs and whether Pass 3 asks the "
                         "card (default: the card; raises without one)")
    args = ap.parse_args(argv)

    report = build_report(
        args.root, run_dispatch=not args.no_dispatch, run_ast=not args.no_ast,
        run_budget=not args.no_budget, max_const_bytes=args.max_const_bytes,
        smem_budget=args.smem_budget, device=args.device)

    if args.update_baseline:
        if not args.baseline:
            ap.error("--update-baseline requires --baseline")
        old = load_baseline(args.baseline)
        waivers, seen = [], set()
        for f in report.findings:
            prior = next((w for w in old if w.covers(f)), None)
            if prior is None:
                reason = (args.reason or "").strip()
                if not reason or reason.upper().startswith("TODO"):
                    ap.error(
                        f"new finding {f.rule}::{f.site} needs a real "
                        "justification: pass --reason \"why this is "
                        "acceptable\" (TODO placeholders are rejected)")
                w = Waiver(rule=f.rule, match=f.site, reason=reason)
            else:
                w = prior
            if (w.rule, w.match) not in seen:
                seen.add((w.rule, w.match))
                waivers.append(w)
        dump_baseline(args.baseline, waivers)
        print(f"wrote {len(waivers)} waiver(s) to {args.baseline}")
        return 0

    report.waivers = load_baseline(args.baseline)
    if args.json:
        report.dump_json(args.json)
    print(report.format_text())
    for w in report.unused_waivers():
        print(f"note: unused waiver {w.rule}::{w.match}")
    return 1 if report.new_findings else 0


if __name__ == "__main__":
    sys.exit(main())
