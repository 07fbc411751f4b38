"""The whole step's share of the card's bf16 peak: the model operations of
the frames completed in the traced slice (counted once in set-up over the
benchmark's own reference, ``reference.flops_per_frame``) over the slice's
seconds times the peak."""

import peaks

KIND = "per_layer"
UNIT = "%"


def read(run):
    tr = run.trace
    if not tr or tr.busy_s <= 0 or not run.flops_per_frame:
        return None
    return 100.0 * run.flops_per_frame * run.traced_frames / (tr.window_s * peaks.STEP_PEAK)
