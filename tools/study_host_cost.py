#!/usr/bin/env python3
"""Where the deviation studies' time goes (``eval/memcap_delta.py``,
``eval/frozen_delta.py``): the host's share, on the card's host.

    python3 tools/study_host_cost.py [--device cpu]

Prints the card's name and power limit, then:

- the time of one ``trackers/cmc.py::ecc_align`` call (cv2's
  ``findTransformECC``, the camera-motion compensation every BUSCA-attached
  ByteTracker of the studies runs per frame) over consecutive frames of
  the studies' first synthetic sequence, at cv2's default threads and at
  one thread;
- a cProfile of ``measure_memcap_delta(caps=(8,), num_frames=60,
  seq_seeds=(0,))`` with a demo model trained for 5 steps (a warm-up run
  first): its wall seconds, the share inside ``findTransformECC``, and the
  top functions by internal time.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import cv2

    from busca_tpu_torch.eval.frozen_delta import _random_dropout_sequence
    from busca_tpu_torch.eval.memcap_delta import measure_memcap_delta
    from busca_tpu_torch.train.demo import train_demo_model
    from busca_tpu_torch.trackers.cmc import ecc_align
    from busca_tpu_torch.utils.device import set_card_precision
    from chip_smoke import card_name_and_limit

    if args.device == "cuda":
        print(card_name_and_limit())
    set_card_precision()
    print(f"cv2 {cv2.__version__}, {cv2.getNumThreads()} threads, "
          f"{os.cpu_count()} cpus")
    seq = _random_dropout_sequence(0, 40)
    frames = [seq.frame(t) for t in range(12)]
    for threads in (cv2.getNumThreads(), 1):
        cv2.setNumThreads(threads)
        t0 = time.perf_counter()
        for a, b in zip(frames[:-1], frames[1:]):
            ecc_align(a, b)
        ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 1)
        print(f"ecc_align at {frames[0].shape[0]}x{frames[0].shape[1]}, cv2 "
              f"threads {threads}: {ms:.2f} ms per call")
    cv2.setNumThreads(-1)

    cfg, model, _ = train_demo_model(steps=5, batch=12, seed=3,
                                     device=args.device)
    kw = dict(caps=(8,), seq_seeds=(0,), cfg=cfg, model=model,
              device=args.device)
    measure_memcap_delta(num_frames=30, **kw)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    measure_memcap_delta(num_frames=60, **kw)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = [v for k, v in stats.stats.items() if "findTransformECC" in k[2]]
    ecc = sum(v[2] for v in rows)  # internal time
    calls = sum(v[1] for v in rows)
    print(f"measure_memcap_delta(caps=(8,), num_frames=60, seq_seeds=(0,)) "
          f"on {args.device}: {wall:.2f} s; findTransformECC {ecc:.2f} s "
          f"over {calls} calls ({100 * ecc / wall:.1f}%, "
          f"{ecc * 1e3 / max(calls, 1):.1f} ms a call)")
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
