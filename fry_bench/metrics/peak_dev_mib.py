"""The largest ``torch.cuda.max_memory_allocated()`` of a job in the
window (reset before each job), in MiB."""


def read(run):
    return max(run.peaks) / 2 ** 20 if run.peaks else None
