"""mfu.train: the operations of the window's steps counted from the
configuration alone (6 x parameters x tokens and causal attention's
products, no recompute; ``reference.counts.train_step_flops``), over the
window's wall time, as a share of the H100's 989 TFLOP/s (bf16, dense)."""
from reference import counts


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    flops = rec["steps"] * counts.train_step_flops(rec["model"], rec["rows"],
                                                   rec["seq"])
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
