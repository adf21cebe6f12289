"""Seconds from the process start to the first timed prove."""


def read(run: dict):
    return run["setup_s"]
