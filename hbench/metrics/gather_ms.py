"""gather_ms: device ms of one of the mesh's all-gathers of the rows (one
a call), its wait for the slowest peer included, in NCCL's kernels by name:
the mean over the traced slice of the window, which every rank traces
alike, averaged over the cards."""


def read(run):
    return run.slice.get("gather_ms") if run.slice else None
