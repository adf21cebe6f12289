# Copied from stark_tpu/utils/regression.py (host-only): the port must
# not import stark_tpu, whose package init imports JAX.
"""Criterion-style bench regression comparison (SURVEY §4: "benchmarks
double as regression tests").

The reference relied on Criterion's saved baselines and statistical
change detection (its results/ screenshots show "Performance has
regressed" flags).  Equivalent here: ``compare(current, baseline_path)``
loads a stored JSON baseline (benches/baseline.json), compares each
metric, and flags regressions beyond a noise threshold.
"""

from __future__ import annotations

import json
import os

DEFAULT_THRESHOLD = 0.10  # 10% — wall-clock noise on shared machines

# metrics where larger is better (throughputs); others are times (smaller
# is better)
_THROUGHPUT_KEYS = ("ops_per_s", "leaves_per_s", "per_s")


def _is_throughput(name: str) -> bool:
    return any(k in name for k in _THROUGHPUT_KEYS)


def compare(
    current: dict, baseline_path: str, threshold: float = DEFAULT_THRESHOLD
) -> list[dict]:
    """Returns a verdict per shared numeric metric:
    {metric, current, baseline, change, verdict} with verdict one of
    improved / regressed / unchanged."""
    if not os.path.exists(baseline_path):
        return []
    with open(baseline_path) as fh:
        base = json.load(fh)
    out = []
    for k, cur in current.items():
        if not isinstance(cur, (int, float)) or k not in base:
            continue
        prev = base[k]
        if not isinstance(prev, (int, float)) or prev == 0:
            continue
        change = (cur - prev) / prev
        better = change > 0 if _is_throughput(k) else change < 0
        if abs(change) <= threshold:
            verdict = "unchanged"
        else:
            verdict = "improved" if better else "regressed"
        out.append(
            {
                "metric": k,
                "current": cur,
                "baseline": prev,
                "change_pct": round(change * 100, 2),
                "verdict": verdict,
            }
        )
    return out


def save_baseline(current: dict, baseline_path: str) -> None:
    os.makedirs(os.path.dirname(baseline_path) or ".", exist_ok=True)
    with open(baseline_path, "w") as fh:
        json.dump(current, fh, indent=2)
