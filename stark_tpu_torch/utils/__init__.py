"""Host utilities: logging and the profile scope, per-phase metrics,
the bench regression gate, the debug invariant checks and packed
fetches."""

from stark_tpu_torch.utils.logging import (get_logger, profile_trace,
                                           setup_logging)
from stark_tpu_torch.utils.metrics import MetricsCollector
from stark_tpu_torch.utils.regression import compare, save_baseline
from stark_tpu_torch.utils.debug import (assert_canonical, check_canonical,
                                         maybe_assert_canonical)

__all__ = ["setup_logging", "get_logger", "profile_trace",
           "MetricsCollector", "compare", "save_baseline",
           "assert_canonical", "check_canonical", "maybe_assert_canonical"]
