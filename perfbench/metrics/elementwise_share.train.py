"""elementwise_share.train: the traced device time in ATen's elementwise,
copy and reduction kernels (by the profiler's kernel name) over all the
traced device time."""
import re

ATEN = re.compile(r"at::native::.*(elementwise|reduce_kernel|CatArray|copy)")


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or tr is None:
        return None
    total = sum(tr["device_ops"].values())
    if total <= 0:
        return None
    ew = sum(t for op, t in tr["device_ops"].items() if ATEN.search(op))
    return 100.0 * ew / total
