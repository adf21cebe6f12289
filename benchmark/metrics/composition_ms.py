"""The synced `composition` phase of stark_tpu_torch.stark.prove, mean ms a
proof (each phase ends in a device synchronise)."""

from benchmark.readers import phase_ms


def read(run: dict):
    return phase_ms(run, "composition")
