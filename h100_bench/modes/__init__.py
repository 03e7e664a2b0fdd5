"""Run modes of the benchmark: one module per ``mode`` of a workload file."""
