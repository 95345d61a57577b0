"""mfu.serve: the operations the window's tokens need, counted from the
configuration alone (``reference.counts``: each prompt's prefill at its
real length, each decoded token at its context), over the window's wall
time, as a share of the H100's 989 TFLOP/s (bf16, dense)."""
from reference import counts


def read(rec):
    if rec["kind"] != "serve":
        return None
    m = rec["model"]
    flops = 0
    for s in rec["steps"]:
        for _, _, lens in s["prefills"]:
            flops += sum(counts.prefill_flops(m, n) for n in lens)
        flops += sum(counts.decode_flops(m, k) for k in s["decode_keys"])
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
