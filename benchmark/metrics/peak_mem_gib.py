"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window
in GiB, the largest over the ranks. The benchmark's own matrix and pool are
a fixed part of it. None off the card."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 2.0 ** 30
