"""Device: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start."""


def read(run):
    return None if run.window_peak_bytes is None else (
        run.window_peak_bytes / 2 ** 30)
