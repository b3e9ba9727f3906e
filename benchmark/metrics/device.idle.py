"""``device.idle``: the share of the profiled window in which no kernel
ran (the union of the kernel intervals in the profiler trace)."""


def read(run):
    if run.device is None or not run.device.kernels:
        return None
    window = run.profiled_seconds()
    return 100.0 * (1.0 - run.busy_seconds() / window)
