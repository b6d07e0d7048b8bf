"""``twophase_iters_per_frame``: the decoder's iterations a frame in the
two-phase sweep's window, from the program's counter ``twophase.stats``
read at the window's open and close (``layer["twophase"]``): k1 on every
frame, the full budget on phase 2's tail, and each repair's phase 1 (k1
on its batch) and phase 2 (the full budget on its unconverged frames).
None where the run has no such counts."""


def read(ctx):
    tp, layer = ctx.layer.get("twophase"), ctx.layer
    if not tp or not tp.get("frames"):
        return None
    k1, iters = layer["k1"], layer["iters"]
    work = (k1 * (tp["frames"] + tp["repairs"] * layer["batch"])
            + iters * (tp["tail_frames"] + tp["repaired_frames"]))
    return work / tp["frames"]
