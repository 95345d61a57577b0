"""The numbers that decide ``correct``, each from the program's readings
and the reference's."""
from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               skip=()) -> Tuple[float, Optional[str]]:
    """The largest gap between the program's and the reference's norm of
    a leaf, against the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves in ``skip`` are left out."""
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for n, want in ref.items():
        if n in skip:
            continue
        gap = abs(prog[n] - want) / max(want, med)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def still_leaves(grads: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is under ``share`` of the median
    leaf's: AdamW moves them by round-off alone, so their change is not
    compared."""
    med = statistics.median(grads.values())
    return {n for n, g in grads.items() if g < share * med}
