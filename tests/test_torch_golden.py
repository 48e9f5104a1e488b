"""The default-scene golden on the port: tests/golden/default_scene_render.npz
["primary_sun"], the 96x54 primary-with-sun view of the default
512x256x512 scene that tests/test_golden.py holds the JAX package to,
rendered by zig_vulkan_tpu_torch on the CPU with the same camera, sun and
tolerance. The scene comes from the port's `cached_default_scene` on the
same cache file as the JAX test's (each package reads the other's)."""

import os

import numpy as np
import torch

from zig_vulkan_tpu_torch.config import CameraConfig, SunConfig
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.core.sun import Sun
from zig_vulkan_tpu_torch.models.scenes import cached_default_scene
from zig_vulkan_tpu_torch.ops import trace

torch.set_num_threads(2)

_TESTS = os.path.dirname(os.path.abspath(__file__))


def test_default_scene_golden_on_the_port():
    """share(max channel |delta| > 1e-3) < 1%, test_golden.py's bound: the
    golden is the numpy oracle's exact DDA, the render skips empty space,
    and grazing rays may flip."""
    ref = np.load(os.path.join(_TESTS, "golden",
                               "default_scene_render.npz"))["primary_sun"]
    sc = cached_default_scene(os.path.join(os.path.dirname(_TESTS),
                                           ".bench_scene_cache.npz"))
    cam = Camera(75.0, 96, 54, CameraConfig(origin=(0.0, 0.0, 0.0),
                                            samples_per_pixel=1,
                                            max_bounce=0))
    sun = Sun(SunConfig(enabled=True)).device_data
    img = trace.render_image(
        sc.grid.static, sc.grid.device_arrays("cpu"),
        trace.materials_to_device(sc.materials, "cpu"), cam.d_camera,
        sun.position, sun.color, sun.radius, True).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01, float((diff > 1e-3).mean())
