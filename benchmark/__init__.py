"""The benchmark of gsplat_tpu_torch: see BENCHMARK.json and benchmark/run.py."""
