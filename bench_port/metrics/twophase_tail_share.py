"""``twophase_tail_share``: the device time of two-phase early
termination's tail over all device time in the traced window: phase 2's
QC-kernel calls (the kernel at phase 2's tile, ``layer["phase2_tile"]``,
which its name carries), the compaction (the stable sort of the mask: cub's
radix sort and its indices; the gathers of the unconverged frames' LLRs,
bits and mask) and the merge (the select and the copy back).  The casts,
fills and the unconverged count's reduction, whose kernels other
operations share, are not counted.  None where the run has no phase-2
tile apart from phase 1's, or no such kernel ran."""

KERNEL = "layered_minsum_kernel<{}, "
# the compaction's and the merge's PyTorch kernels (torch 2.11 on the
# H100), by a part of their names
PARTS = ("DeviceRadixSort", "fill_reverse_indices", "vectorized_gather_kernel",
         "_scatter_gather_elementwise_kernel", "where_kernel",
         "index_copy_kernel")


def read(ctx):
    tl, layer = ctx.timeline, ctx.layer
    tile = layer.get("phase2_tile")
    if tl is None or tile is None or tile == layer.get("phase1_tile"):
        return None
    total = sum(sec for sec, _ in tl.kernels.values())
    tail, n = tl.kernel(KERNEL.format(tile))
    if total <= 0 or n == 0:
        return None
    tail += sum(sec for name, (sec, _) in tl.kernels.items()
                if any(p in name for p in PARTS))
    return 100.0 * tail / total
