"""Per-layer metric readers, one module per metric name: `read(rec)`
returns the metric from the traced run's records, or None where the
records hold nothing to read."""
