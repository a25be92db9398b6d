"""Static invariant analyzer of the port (twin of ``repro.analysis``).

Three passes over the port, all waivable through the committed baseline
``analysis_baseline_torch.json``:

1. ``dispatch_checks`` — run the registered hot entry points
   (``entrypoints``) under a dispatch recorder, and on a card under the
   sync-debug window (F64-IN-HOT, HOST-SYNC, UPLOAD-PER-CALL, SLOT-REUSE).
2. ``ast_lint``        — AST convention rules over the port's files
   (GEN-REUSE, DEVICE-THREAD, DEVICE-MOVE, BANNED-IN-HOT).
3. ``kernel_budget``   — the Hopper kernels' launch plans, mirrored from
   their host code (SMEM-BUDGET, GRID-COVERS, FUSED-VS-ORACLE; on a card
   also REG-BUDGET and REG-SPILL from the card's own attributes).

CLI: ``python -m repro_torch.analysis --json report.json --baseline
analysis_baseline_torch.json [--device cpu]`` — on the card unless
``--device cpu`` is given; exit 0 iff every finding is waived.
"""
from repro_torch.analysis.report import (  # noqa: F401
    Finding,
    Report,
    Waiver,
    dump_baseline,
    load_baseline,
)

RULES = (
    "F64-IN-HOT", "HOST-SYNC", "UPLOAD-PER-CALL", "SLOT-REUSE",
    "GEN-REUSE", "DEVICE-THREAD", "DEVICE-MOVE", "BANNED-IN-HOT",
    "SMEM-BUDGET", "GRID-COVERS", "FUSED-VS-ORACLE", "REG-BUDGET",
    "REG-SPILL",
)
#: Rules only a card can decide (nothing is uploaded, and no attribute is
#: read, on the CPU): on the CPU their waivers stay unused.
CARD_RULES = ("UPLOAD-PER-CALL", "REG-BUDGET", "REG-SPILL")
