"""k2_roofline: the least time the card could take for the attention of the
traced prefills (each call's operations and bytes at its prompts' real
lengths, the larger of the compute and the memory bound;
``reference.counts``), over the device time of the kernels that the
configuration's attention source defines (its ``__global__`` names), as a
percentage.  None without a trace, a traced prefill or such a kernel."""
import common
from reference import counts


def read(rec):
    tr = rec.get("trace")
    src = rec["config"].get("kernel_sources", {}).get("attention")
    if rec["kind"] != "serve" or tr is None or src is None:
        return None
    names = common.kernel_names(common.ROOT / src)
    kernel_s = sum(t for op, t in tr["device_ops"].items()
                   if common.is_kernel(op, names))
    m = rec["model"]
    bound = sum(m["n_layers"] * counts.bound_s(
        *counts.causal_attention_call(m, lens))
        for s in rec["traced_steps"] for _, _, lens in s["prefills"])
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
