"""Proofs completed in the window over the window's seconds."""


def read(run: dict):
    return run["proofs"] / run["window_s"] if run["proofs"] else None
