"""100 x (1 - the union of device-operation intervals / the traced
window), over the profiled proves, in %.  Over several cards the union
is each card's own and the busy time their mean, so this is the cards'
mean idle share; on one card it is that card's union."""


def read(run: dict):
    prof = run["profile"]
    if not prof or not prof["device_events"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["traced_window_s"])
