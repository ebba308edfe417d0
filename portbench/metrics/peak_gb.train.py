"""The most device memory the program held during the window
(`torch.cuda.max_memory_allocated`, less the logits the harness keeps on
the card for the check), in GB (1e9 bytes)."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes > 0 else None
