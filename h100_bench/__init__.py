"""The benchmark of nextou_tpu_torch on the H100 (see BENCHMARK.json)."""
