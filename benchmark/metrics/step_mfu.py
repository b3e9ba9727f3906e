"""``step_mfu``: the whole step's share of the card's peak in the profiled
window: the ideal seconds of every model forward that started in it (its
operations, counted from the shapes it ran at, over the peak of its dtype:
a detector's or an extractor's forward as its part counts it, e.g. YOLOX and
the GHOST ReID in float32 at 67 TFLOP/s; BUSCA's ResNet-50 and Transformer
in bf16 at 989 TFLOP/s) over the window's seconds."""

from bmk import parts
from bmk.flops import PEAKS, busca_call_flops


def read(run):
    if run.device is None:
        return None
    cfg = run.config
    ideal = 0.0
    for f in run.forwards:
        if not run.in_profiled(f[1]):
            continue
        if f[0] == "busca":
            b = cfg["busca"]
            ideal += (busca_call_flops(b, f[2], f[3], f[4], b["crop_hw"])
                      / PEAKS[b["dtype"]])
        elif f[0] != "tracks":
            ops, dtype = parts.of(cfg, f[0]).flops(cfg, *f[2:])
            ideal += ops / PEAKS[dtype]
    window = run.profiled_seconds()
    return 100.0 * ideal / window if ideal > 0 and window > 0 else None
