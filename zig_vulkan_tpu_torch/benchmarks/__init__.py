"""The benchmark layer of the port: the BASELINE configurations
(`configs`), the full-length fly-through (`flythrough`) and the 1080p
headline bench (`bench`), each a module with a `main(argv)` that runs as
`python -m zig_vulkan_tpu_torch.benchmarks.<name>`.

Every entry point takes the device to run on, `cuda` by default, and stops
without a CUDA device unless the caller names `cpu` (`utils/device.py`).
"""
