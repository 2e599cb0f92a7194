"""torch.cuda.max_memory_allocated over set-up and window, the largest
rank's, in GiB."""
UNIT = "GiB"


def read(rec):
    if rec.trace is not None or not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2 ** 30
