"""``kernel.k1_roofline``: K1's share of its roofline in the profiled
window: the sum over its launches of each launch's least time (the larger
of its bytes over 3.35 TB/s and its operations over the float32 peak,
``bmk.flops.k1_least_seconds``) over the sum of K1's kernel times."""

import numpy as np

from bmk.flops import k1_least_seconds


def read(run):
    if run.device is None:
        return None
    t = run.kernel_seconds(lambda n: "crop_resize" in n)
    launches = [k for k in run.k1 if run.in_profiled(k[0])]
    if t <= 0 or not launches:
        return None
    least = sum(k1_least_seconds(hw, np.asarray(b.detach().cpu()), n)
                for _t, hw, b, n in launches)
    return 100.0 * least / t
