"""Per-layer metric readers, one file a metric, named as the metric.

Each has `read(reading) -> float | None` (harness.Reading: the cell, the
untraced window, the traced window and its profile) and returns None
where it finds nothing to read; the harness then leaves the metric out."""
