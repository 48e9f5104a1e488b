"""The benchmark of `zig_vulkan_tpu_torch`, the voxel path tracer on PyTorch
and CUDA.

One command runs one cell of `BENCHMARK.json` once, from the root of a
checkout:

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The harness is driven by data. `BENCHMARK.json` names the configurations,
the traffic mixes, the cells and the metrics; each configuration is a file
`rtbench/configs/<name>.json`, each traffic mix `rtbench/traffic/<name>.json`
(read by the one generator, `rtbench.traffic`) and each per-layer metric a
reader `rtbench/metrics/<name>.py`. A new cell is new files and new entries,
with no edit of a file that is here.

What the benchmark owns, and a later change to the program cannot move:
the scene's generator and cache (`rtbench.scene`), the traffic
(`rtbench.traffic`), the reading of the profiler's trace
(`rtbench.devtrace`), the table of peaks and kernel F's operations and
bytes (`rtbench.roofline`), the plain reference of a frame (`rtbench.ref`,
a frozen copy of the port's plain torch twins that imports nothing of the
port) and the comparison that decides `correct` (`rtbench.check`).

Nothing here imports `jax`, `zig_vulkan_tpu` (the JAX package) or the old
`benchmarks/` folder; a run that finds one of them loaded fails.
"""
