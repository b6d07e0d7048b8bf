"""``twophase_phase2_calls_per_batch``: phase 2's decoder calls a batch in
the two-phase sweep's window, from the program's counter
``twophase.stats`` read at the window's open and close
(``layer["twophase"]``): ``phase2_calls`` (one a dispatch, one a repair)
over ``batches``.  None where the program has no such counter."""


def read(ctx):
    tp = ctx.layer.get("twophase")
    if not tp or "phase2_calls" not in tp or not tp.get("batches"):
        return None
    return tp["phase2_calls"] / tp["batches"]
