"""The 95th percentile of the window's prove walls, in ms (the walls
sorted, the value at rank ceil(0.95 n))."""

import math


def read(run: dict):
    walls = sorted(run["walls_s"])
    if not walls:
        return None
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
