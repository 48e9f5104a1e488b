"""denoise_roofline: kernel F's share of its roofline, in %: the least
time of the denoiser's work for one frame of the configuration at the
card's published peaks (`rtbench.roofline.denoise_bound_ms`: its live
taps, every input pixel read and output pixel written once) over kernel
F's device ms a frame in the traced stretch (zig_vulkan_tpu_torch/ops/
denoise.py -> csrc/denoise.cu). Nothing to read where the configuration
runs no denoiser or the trace shows no kernel F. It moves frame_ms."""

NAME = "denoise_roofline"
UNIT = "%"
LAYER = "kernel F (ops/denoise.py, csrc/denoise.cu)"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["default_flythrough"]


def read(stretch):
    from rtbench.roofline import denoise_bound_ms

    engine = stretch.engine
    if not engine or not engine["denoiser"]["enabled"]:
        return None
    ms = stretch.kernel_ms({"F"})
    if ms <= 0:
        return None
    return 100.0 * denoise_bound_ms(engine) / ms
