"""100 x (1 - the union of device-operation intervals / the traced
window), over the profiled proves, in %."""


def read(run: dict):
    prof = run["profile"]
    if not prof or not prof["device_events"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["traced_window_s"])
