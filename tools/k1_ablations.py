#!/usr/bin/env python3
"""Where kernel K1's time goes on an NVIDIA GPU, and how it compares with K1
of other checkouts.

    python3 tools/k1_ablations.py [--against DIR ...]

At chip_smoke.py's three K1 cases (64 crops of a 1080x1920 frame, the
letterbox, the 2160x3840 pad path), with the main path's flags:

- this checkout's K1 alone (``crop_cuda.launch`` on preallocated buffers)
  beside builds of busca_tpu_torch/csrc/crop_resize.cu with ``-D
  K1_NO_READS=1`` (no frame reads), ``-D K1_NO_STORES=1`` (no output
  stores) or both, all built with one nvcc each, started together.  It
  prints each build's device time per launch (chip_smoke.device_time_ms),
  the time of writing the same output with ``out.zero_()`` (the floor the
  stores alone set), and the split between K1's two kernels
  (torch.profiler).  A variant computes another function: only the op's
  build is checked against the plain version.
- with ``--against DIR``: K1 alone of each other checkout DIR (for example
  the parent commit unpacked with ``git archive``), each checkout in a
  process of its own, in the order DIR..., this, this, ...DIR, on the same
  inputs: device time and back-to-back time (chip_smoke.cuda_time_ms),
  checked bit for bit against the plain version.  A checkout whose K1 takes
  precomputed box parameters (before K1's redesign) is timed with them
  computed ahead by its own ``box_params``.

``--tree DIR`` times DIR's K1 alone and prints one JSON line (the child
process of ``--against``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"no frame reads": ("K1_NO_READS=1",),
            "no stores": ("K1_NO_STORES=1",),
            "neither": ("K1_NO_READS=1", "K1_NO_STORES=1")}


def chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases(cs):
    """{label: (frame, boxes, out_hw)} on the card, as chip_smoke.py's K1
    phases make them."""
    specs = {
        "64 crops": (1, lambda rng, h, w: cs.smoke_boxes(rng, cs.N_BOXES, h,
                                                         w), cs.CROP_HW,
                     cs.FRAME_HW, 0),
        "letterbox": (3, lambda rng, h, w: [[0.0, 0.0, float(w), float(h)]],
                      cs.LETTERBOX_HW, cs.FRAME_HW, 0),
        "pad path": (4, cs.pad_path_boxes, cs.CROP_HW, cs.PAD_FRAME_HW, 200),
    }
    out = {}
    for label, (seed, boxes_fn, out_hw, frame_hw, low) in specs.items():
        frame, _, boxes = cs.k1_inputs("cuda", seed, boxes_fn, frame_hw, low)
        out[label] = (frame, boxes, out_hw)
    return out


def time_tree(tree: str) -> dict:
    """K1 alone of the checkout at ``tree`` at each case: device and
    back-to-back ms, max |diff| to that checkout's plain version."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from busca_tpu_torch.ops import crop, crop_cuda

    cs = chip_smoke()
    kw = cs.K1_MAIN_KW
    result = {}
    for label, (frame, boxes, out_hw) in cases(cs).items():
        want = crop.crop_resize_normalize_plain(frame, boxes, out_hw, **kw)
        if hasattr(crop_cuda, "buffers"):  # K1 takes the boxes
            out, scratch = crop_cuda.buffers(len(boxes), out_hw, "cuda")
            args = (frame, boxes, scratch, out)
        else:  # before the redesign: box parameters computed ahead
            iparams, pad = crop.box_params(frame, boxes, kw["quantize_uint8"])
            out = torch.empty((len(boxes), *out_hw, 3), dtype=torch.float32,
                              device="cuda")
            args = (frame, iparams.contiguous(), pad.contiguous(), out)
        crop_cuda.launch(*args, **kw)
        torch.cuda.synchronize()
        result[label] = {
            "max_abs_err": float((out - want).abs().max()),
            "device_ms": cs.device_time_ms(
                lambda: crop_cuda.launch(*args, **kw), reps=50),
            "b2b_ms": cs.cuda_time_ms(
                lambda: crop_cuda.launch(*args, **kw), reps=50),
        }
    return result


def ablations(cs) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from busca_tpu_torch.ops import crop_cuda
    from busca_tpu_torch.ops.crop import crop_resize_normalize_plain
    from busca_tpu_torch.ops.cuda_build import CudaLibrary

    libs = {"op's build": crop_cuda.LIBRARY}
    for name, defines in VARIANTS.items():
        libs[name] = CudaLibrary("crop_resize.cu", crop_cuda._declare, defines)
    with ThreadPoolExecutor(len(libs)) as pool:
        reports = pool.map(lambda lib: lib.build()[1], libs.values())
        for name, report in zip(libs, reports):
            regs = [ln.split("ptxas info    :")[-1].strip()
                    for ln in report.splitlines() if "registers" in ln]
            print(f"{name}: {'; '.join(regs)}")

    kw = cs.K1_MAIN_KW
    for label, (frame, boxes, out_hw) in cases(cs).items():
        want = crop_resize_normalize_plain(frame, boxes, out_hw, **kw)
        out, scratch = crop_cuda.buffers(len(boxes), out_hw, "cuda")
        parts = []
        for name, lib in libs.items():
            def run(lib=lib):
                crop_cuda.launch(frame, boxes, scratch, out, library=lib, **kw)

            run()
            torch.cuda.synchronize()
            if lib is crop_cuda.LIBRARY and not torch.equal(out, want):
                print(f"k1_ablations: K1 disagrees with the plain version at "
                      f"{label}", file=sys.stderr)
                return 1
            parts.append(f"{name} {cs.device_time_ms(run, reps=50):.4f}")
        zero_ms = cs.device_time_ms(out.zero_, reps=50)
        print(f"{label}, device ms per launch: {', '.join(parts)}; "
              f"out.zero_() {zero_ms:.4f}")

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                crop_cuda.launch(frame, boxes, scratch, out, **kw)
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kind = "P" if "pad_sum" in e.name else "R"
                split[kind] = split.get(kind, 0.0) + \
                    e.time_range.elapsed_us() / 10
        print(f"{label}, K1 by kernel (torch.profiler): " +
              ", ".join(f"{k} {v:.2f} us" for k, v in sorted(split.items())))
    return 0


def against(trees) -> int:
    """Times each tree's K1 in its own process: trees..., this, this,
    ...trees."""
    order = [*trees, ROOT, ROOT, *reversed(trees)]
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True)
        name = "this checkout" if tree == ROOT else tree
        if proc.returncode != 0:
            print(f"k1_ablations: {name} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, r in result.items():
            print(f"{name}, {label}: device {r['device_ms']:.4f} ms, back to "
                  f"back {r['b2b_ms']:.4f} ms, max|diff| "
                  f"{r['max_abs_err']:.3g}")
        if any(r["max_abs_err"] != 0 for r in result.values()):
            print(f"k1_ablations: {name}'s K1 disagrees with the plain "
                  f"version", file=sys.stderr)
            return 1
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", action="append", default=[],
                        metavar="DIR", help="another checkout to time")
    parser.add_argument("--tree", metavar="DIR",
                        help="time DIR's K1 alone, print one JSON line")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_ablations: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        print(json.dumps(time_tree(args.tree)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sys.path.insert(0, ROOT)
    rc = ablations(chip_smoke())
    if rc == 0 and args.against:
        rc = against(args.against)
    return rc


if __name__ == "__main__":
    sys.exit(main())
