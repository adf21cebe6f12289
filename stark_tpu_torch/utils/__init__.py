"""Host utilities: per-phase metrics, logging and packed fetches."""
