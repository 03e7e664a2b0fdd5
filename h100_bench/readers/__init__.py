"""Readers of per-layer metrics: one module per ``reader`` of a metric file."""
