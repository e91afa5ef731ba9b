"""What the per-layer readers know of the port's kernels: the names their
device events carry in the profiler, and the launch counter of each."""

KERNELS = {"k1": "bounce_culled_kernel", "k2": "bounce_kernel",
           "k3": "nearest_kernel"}
COUNTER = {"k1": "bounce_reflect_culled", "k2": "bounce_reflect",
           "k3": "nearest_hit"}


def kernel_time(run, k: str):
    """Seconds of the kernel's device events in the profiled slice."""
    if run.slice is None:
        return None
    return sum(t for name, t in run.slice.device_ops.items()
               if KERNELS[k] in name)


def slice_work(run, k: str):
    """(source rays, ray segments, the kernel's launches) of the profiled
    slice: the segments are the rays times the reference's segments a
    ray."""
    emitted = sum(c["emitted"] for c in run.slice_calls)
    segments = int(round(emitted * run.stats.segments / run.stats.n))
    return emitted, segments, run.slice.counters[COUNTER[k]]
