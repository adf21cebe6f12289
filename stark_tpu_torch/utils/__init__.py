"""Host utilities: per-phase metrics and logging."""
