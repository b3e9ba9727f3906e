"""The port's benchmark: one run of one cell.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the checkout's root, where ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs``), its traffic mix
(``benchmark/mixes``) and its metrics (per-layer readers in
``benchmark/metrics``); the configuration names its models' parts
(``benchmark/bmk/parts``).  The run makes its inputs and weights from the seed,
builds the program (``busca_tpu_torch``) and warms up every shape the cell
uses (``setup_s``), drives it for ``--seconds``, then checks what the timed
path produced against the plain reference (``benchmark/benchref``) and
prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), ``device`` and, traced, ``breakdown``;
``checks`` comes last, each compared number beside its limit, as do the
last lines of standard error.

Without a CUDA card (or with fewer than the cell's chips) it exits with 3
and prints no result.  ``--rehearse`` runs the whole path on the CPU at the
configuration's and mix's small rehearsal sizes and prints no metric;
``--control`` runs the precision control in the program's place (TF32 for
its float32 models, the reference BUSCA with its bf16 operands rounded
through float8) so that the check must come out false.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))  # the checkout: the program

FORBIDDEN = ("jax", "jaxlib", "flax", "busca_tpu")
BUILD = os.path.join(HERE, "_build")


def forbidden_modules():
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole (``busca_tpu_torch`` is not
    ``busca_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the CPU rehearsal at the small sizes; no metrics")
    p.add_argument("--control", action="store_true",
                   help="the precision control in the program's place")
    p.add_argument("--fault", default=None,
                   help="(rehearsal tests) break the timed path: "
                        "state_unchanged, half_batch, altered_answer, "
                        "crossed_requests or wrong_memory")
    return p.parse_args(argv)


def fail(code: int, msg: str):
    print(msg, file=sys.stderr, flush=True)
    return code


def end_to_end(bench, workload, win, seconds):
    from bmk import spec, stats

    values = {
        "frames_per_s": win.completed / seconds,
        "frame_ms_p50": stats.percentile(win.latencies_ms, 50),
        "frame_ms_p95": stats.percentile(win.latencies_ms, 95),
        "setup_s": win.setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics_for(bench, workload, "end_to_end")}


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(BUILD, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    from bmk import parts, spec, traffic

    try:
        bench = spec.load_benchmark()
        cell, config, mix = spec.resolve_cell(bench, args.workload)
        parts.require(config)
    except (OSError, KeyError, ValueError) as e:
        return fail(2, f"benchmark: {e}")
    import torch

    if args.rehearse:
        config = merged(config, config["rehearse"])
        mix = traffic.rehearsal(mix)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            return fail(3, "benchmark: no CUDA card; the benchmark measures "
                           "the card and prints no result without one")
        if torch.cuda.device_count() < int(cell["chips"]):
            return fail(3, f"benchmark: the cell needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    try:
        import busca_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(2, f"benchmark: the program is not in this checkout: "
                       f"{e}")

    from bmk import check, drivers, faults, probe

    rec = probe.Recorder(args.seed, mix["sample"], bool(args.trace))
    run = drivers.Run(args, cell, config, mix, rec, T0, device)
    if args.fault:
        faults.install(args.fault)
    win = drivers.DRIVERS[mix["driver"]](run)
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    found = forbidden_modules()
    if found:
        return fail(4, f"benchmark: loaded after the window: {found}")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from bmk.program import set_precision

    set_precision()
    numbers = check.compare(run, win)
    correct = (win.failed == 0 and win.attempted > 0 and win.completed > 0
               and all(v <= lim for _n, v, lim in numbers))
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(cell["chips"]), "memory_peak_bytes": peak} \
        if device.type == "cuda" else {"platform": "cpu", "count": 0}
    if args.trace:
        from bmk.tracing import TraceRun

        tr = TraceRun(rec.spans, win.profiled, win.device_trace,
                      rec.forwards, rec.k1, config,
                      [a - b for a, b in zip(win.round_trip_ms,
                                             win.server_ms)])
        print(f"K1 launches: {rec.k1_launches} over {win.completed} frames, "
              f"{rec.k1_launches / max(win.completed, 1):.3f} per frame; "
              f"{tr.profiled_frames()} frames profiled", flush=True)
        result["metrics"] = spec.read_per_layer(bench, args.workload, tr)
        if device.type == "cuda":
            dev.update(busy_s=tr.busy_seconds(),
                       window_s=tr.profiled_seconds())
            result["breakdown"] = tr.breakdown()
    else:
        result["metrics"] = end_to_end(bench, args.workload, win,
                                       args.seconds)
    result["device"] = dev
    if args.rehearse:
        # a CPU run's numbers never stand under a device metric's name
        for name, m in result["metrics"].items():
            print(f"rehearsal (CPU, not a device reading) {name} "
                  f"{m['value']!r}", file=sys.stderr)
        result.update(metrics={}, rehearsal=True)
    found = forbidden_modules()
    if found:
        return fail(4, f"benchmark: loaded in this process: {found}")
    print(f"set-up: {run.setup_split()}; window {win.completed} frames "
          f"completed, {win.attempted} attempted", file=sys.stderr)
    for e in win.errors[:5]:
        print(f"failed frame: {e}", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in numbers}
    for n, v, lim in numbers:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
