"""What the metric readers (``benchmark/metrics/``) share: the run
record's synced phase walls and profiled kernel times."""

from __future__ import annotations

from benchmark import roofline


def phase_ms(run: dict, name: str):
    """The mean synced wall of phase `name` a proof, in ms (traced runs;
    None where no prove recorded it)."""
    walls = run["phases"].get(name)
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)


def roofline_share(run: dict, patterns, least_s) -> float | None:
    """100 x (least seconds a prove, times the profiled proves) / the
    device seconds of the kernels whose names hold one of `patterns`;
    None without a profile, a card or such kernels."""
    prof, card = run["profile"], run["card"]
    if not prof or not card:
        return None
    spent = sum(s for name, s in prof["kernel_s"].items()
                if any(p in name for p in patterns))
    if spent <= 0:
        return None
    c = roofline.Card(card["sms"], card["sm_clock_max_mhz"])
    return 100.0 * prof["proves"] * least_s(run["spec"], c) / spent
