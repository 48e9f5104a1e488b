"""The sun-shadow probe (kernel A's shadow build) against the JAX package's.

With `shadow_probe` the port traces each bounce level's sun ray in the
same kernel A launch as the scatter ray (for CPU tensors the wrapper runs
the traversal twin twice). The sun ray's target is computed before the
traversal and its direction is rounded as the separate-launch path rounds
it, so the port's two paths give the same colours bit for bit. The JAX
probe normalizes with an approximate rsqrt and runs jitted, so against it
the frame is held statistically, at its own test's bound
(tests/test_tile_tracer.py:805-831: share(|Δ| > 1e-3) < 1%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu.ops.tile_tracer import build_region_tables
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

# a low, slanted sun: the hit points are partly lit, partly in shadow
SUN = np.asarray([900.0, 40.0, 900.0], np.float32)
SUN_COLOR = np.asarray([1.0, 1.1, 1.0], np.float32)


class _Scene:
    def __init__(self):
        from test_tile_tracer import _rays, dielectric_scene

        grid, self.materials = dielectric_scene()
        self.static = grid.static
        self.rarrays = grid.device_arrays()
        arrays = GridArrays.to_device(grid.arrays, "cpu")
        self.tables = ttrace.build_trace_tables(self.static, arrays)
        self.material_indices = arrays.material_indices
        self.mats = ttrace.materials_to_device(self.materials, "cpu")
        self.ro, self.rd = _rays(self.static, (16.0, 25.0, 70.0))

    def port_colour(self, probe: bool, max_bounce: int):
        rays = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for a in (self.ro, self.rd) for i in range(3)]
        rgb = ttrace._ray_color_soa(
            self.static, self.tables, self.material_indices, self.mats,
            *rays, max_bounce, SUN, True, SUN_COLOR, np.float32(5.0),
            shadow_probe=probe)
        return torch.stack(rgb, -1).numpy()


@pytest.fixture(scope="module")
def scene():
    return _Scene()


def test_probe_path_matches_reference_probe(scene):
    """One bounce level (the interpreted TPU kernel costs about 15 s a
    level on the CPU)."""
    st = scene.static
    rtables = rtrace.build_trace_tables(st, scene.rarrays)
    blocks = build_region_tables(st, scene.rarrays, rtables)
    want = rtrace._ray_color_soa(
        st, scene.rarrays, rtrace.materials_to_device(scene.materials),
        *(jnp.asarray(scene.ro[:, i]) for i in range(3)),
        *(jnp.asarray(scene.rd[:, i]) for i in range(3)), 1,
        jnp.asarray(SUN), True, jnp.asarray(SUN_COLOR), jnp.float32(5.0),
        768, rtables, True, region_blocks=blocks, tile_interpret=True,
        shadow_probe=True)
    got = scene.port_colour(probe=True, max_bounce=1)
    d = np.abs(got - np.asarray(want)).max(axis=-1)
    assert (d > 1e-3).mean() < 0.01, float((d > 1e-3).mean())


@pytest.mark.parametrize("max_bounce", [1, 3])
def test_probe_equals_separate_launches(scene, max_bounce):
    """Bounce levels after the first carry the dielectric key."""
    np.testing.assert_array_equal(
        scene.port_colour(probe=True, max_bounce=max_bounce),
        scene.port_colour(probe=False, max_bounce=max_bounce))


def test_wrapper_occluded_is_the_sun_ray_traversal(scene):
    """`occluded` is the twin's first hit of the ray from each hit point
    toward its target, for the lanes that hit; the hit outputs are those
    of the build without the probe."""
    n = scene.ro.shape[0]
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
            for a in (scene.ro, scene.rd) for i in range(3)]
    active = torch.ones(n, dtype=torch.bool)
    targets = ttrace.sun_targets(rays[3], rays[4], rays[5], SUN,
                                 np.float32(5.0))
    args = (scene.static, scene.tables, scene.material_indices, *rays, active)
    got = ttile.grid_hit_tiles(*args, shadow_targets=targets)
    plain = ttile.grid_hit_tiles(*args)
    for k, v in plain.items():
        assert torch.equal(got[k], v), k
    sd = ttrace.shadow_dirs(plain, targets)
    sh = ttrace._grid_hit_soa(scene.static, scene.tables,
                              scene.material_indices, plain["px"],
                              plain["py"], plain["pz"], *sd,
                              plain["found"])
    assert got["occluded"].dtype == torch.bool
    assert torch.equal(got["occluded"], sh["found"])
    assert not got["occluded"][~plain["found"]].any()
    share = got["occluded"][plain["found"]].float().mean().item()
    assert 0.0 < share < 1.0
