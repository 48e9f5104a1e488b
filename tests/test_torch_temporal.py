"""Temporal accumulation and resolution changes of zig_vulkan_tpu_torch's
engine against the JAX package's.

With temporal accumulation on, frame k of a static pose traces its samples
with jitter seeds k*spp + s (`render_rows(sample_base=...)`) and the engine
keeps the running mean of the traced frames. The seeds' camera rays are
bit-exact against the reference run op by op; accumulated path-traced
frames are compared statistically with the bounds of
tests/test_torch_engine.py (the jitted reference contracts multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.engine.engine import VoxelRT as RefVoxelRT
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

ORIGIN = (4.0, 6.5, 15.0)


def _parity_scene(scenes):
    """tests/test_trace_parity.py's water pool + metal pillar scene."""
    sc = scenes.flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                         np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    sc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                         np.full(ys.size, 7, dtype=np.uint8))
    return sc


def _config(m, spp=1, max_bounce=1):
    return m.EngineConfig(
        internal_resolution_width=48, internal_resolution_height=48,
        camera=m.CameraConfig(origin=ORIGIN, samples_per_pixel=spp,
                              max_bounce=max_bounce),
        sun=m.SunConfig(enabled=True, animate=False),
        denoiser=m.DenoiserConfig(enabled=False))


def _port_engine(**kw):
    sc = _parity_scene(tscenes)
    return VoxelRT(sc.grid, sc.materials, _config(tconfig, **kw), device="cpu")


@pytest.mark.parametrize("sample_base", [0.0, 2.0, 9.0])
def test_sample_base_camera_rays_bit_exact(monkeypatch, sample_base):
    """The camera rays `render_rows` traces for each sample, against the
    reference's seeds (sample_base + s in float32, trace.py:1423-1425)
    evaluated op by op."""
    rt = _port_engine(spp=2, max_bounce=0)
    cam = rt.camera
    cam.turn_yaw(0.3)
    seen = []
    real = ttrace._camera_rays_soa

    def spy(c, w, h, sample_index):
        out = real(c, w, h, sample_index)
        seen.append((sample_index, out))
        return out

    monkeypatch.setattr(ttrace, "_camera_rays_soa", spy)
    ttrace.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(cam.d_camera, "cpu"), 48, 48, 2, 1,
        rt.sun.device_data.position, rt.sun.device_data.color,
        rt.sun.device_data.radius, False, sample_base=sample_base)
    assert len(seen) == 2
    rcam = rtrace.camera_vectors(cam.d_camera)
    for s, (_, got) in enumerate(seen):
        want = rtrace._camera_rays_soa(
            rcam, 48, 48, jnp.asarray(sample_base, jnp.float32)
            + jnp.float32(s))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def accumulated():
    """Three accumulated frames of a static pose from both engines."""
    rsc = _parity_scene(rscenes)
    ref = RefVoxelRT(rsc.grid, rsc.materials, _config(rconfig))
    port = _port_engine()
    ref.set_temporal(True)
    port.set_temporal(True)
    frames = [(np.asarray(ref.render()), port.render().numpy())
              for _ in range(3)]
    return ref, port, frames


def test_accumulated_frames_match_reference(accumulated):
    ref, port, frames = accumulated
    assert ref._accum_count == port._accum_count == 3
    for want, got in frames:
        assert got.shape == (48, 48, 3) and np.isfinite(got).all()
        diff = np.abs(got - want).max(axis=-1)
        assert diff.mean() < 5e-3
        assert (diff > 1e-3).mean() < 0.01
    # fresh jitter every frame: the mean moves, by less each time
    d1 = np.abs(frames[1][1] - frames[0][1]).mean()
    d2 = np.abs(frames[2][1] - frames[1][1]).mean()
    assert 0.0 < d2 < d1


def test_accumulation_is_the_running_mean():
    """Frame k is the mean of the k traced frames with seeds k*spp + s."""
    rt = _port_engine(spp=2)
    rt.set_temporal(True)
    d = rt.camera.d_camera
    sun = rt.sun.device_data
    traced = [ttrace.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(d, "cpu"), 48, 48, 2, int(d.max_bounce),
        sun.position, sun.color, sun.radius, True, sample_base=2 * k)
        for k in range(3)]
    mean = torch.zeros_like(traced[0])
    for k, img in enumerate(traced):
        mean = mean + ttrace._div(img - mean, k + 1)
        torch.testing.assert_close(rt.render(), mean, rtol=0, atol=0)


def test_pose_change_and_toggle_reset_the_mean():
    rt = _port_engine()
    rt.set_temporal(True)
    rt.render()
    rt.render()
    assert rt._accum_count == 2
    rt.camera.translate(0.1, [1.0, 0.0, 0.0])
    rt.render()
    assert rt._accum_count == 1
    sun = rt.sun.device_data
    sun.position = sun.position + np.float32(1.0)  # the sun moved
    rt.render()
    assert rt._accum_count == 1
    rt.set_temporal(False)
    assert rt._accum_count == 0
    a, b = rt.render(), rt.render()
    assert torch.equal(a, b) and rt._accum_count == 0


def test_set_resolutions_rescales_and_keeps_the_pose():
    """The swapchain-rebuild analog (Pipeline.zig:657-710)."""
    rt = _port_engine()
    rt.camera.translate(1.0, [1.0, 0.0, 0.0])
    rt.camera.turn_yaw(0.2)
    origin = rt.camera.d_camera.origin.copy()
    yaw = rt.camera.yaw.copy()
    rt.set_temporal(True)
    rt.render()
    rt.set_resolutions(internal=(40, 24), output=(80, 48))
    img = rt.render()
    assert img.shape == (48, 80, 3)
    assert rt._accum_count == 1  # the accumulator follows the new size
    np.testing.assert_array_equal(rt.camera.d_camera.origin, origin)
    np.testing.assert_array_equal(rt.camera.yaw, yaw)
    assert rt.camera.d_camera.image_width == 40
    assert rt.metrics.rays_per_frame == 40 * 24
    rt.set_resolutions(output=(20, 12))
    assert rt.render().shape == (12, 20, 3)
    host = rt.device_image_to_host(rt.render())
    assert isinstance(host, np.ndarray) and host.shape == (12, 20, 3)
