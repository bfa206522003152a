"""Per-layer metric readers, one file a metric, found by its name."""
