"""The repo's tools on the port: the synthetic scenes, the training
self-check, the quality proxy, the step profiler, the step A/B timer and
the GPU parity check. Each runs with `python -m gsplat_tpu_torch.tools.<name>`
on the CUDA card unless its device flag names the CPU."""
