"""Readers of the per-layer metrics, one file a metric, found by name."""
