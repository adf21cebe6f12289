"""torch.cuda.max_memory_allocated() over the window (reset after
set-up) on the fullest of the cards the run uses, in MiB."""


def read(run: dict):
    return run["peak_bytes"] / 2**20 if run["peak_bytes"] else None
