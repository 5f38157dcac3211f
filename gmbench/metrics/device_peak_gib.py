"""``torch.cuda.max_memory_allocated()`` from the end of the graph's build
to the end of the window: the resident graph and lengths, and what the
program allocates in warm-up and window (GiB)."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
