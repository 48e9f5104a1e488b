"""BASELINE configs 1, 2, 4 and 5 (benchmarks/configs.py:81-252) in
zig_vulkan_tpu_torch against the JAX package, at the small `scale` of
tests/test_bench_configs.py. The port's engines come from the
`build_config*` functions of `zig_vulkan_tpu_torch.benchmarks.configs`, the
reference's from the JAX harness itself, stopped before its first frame.

Tolerances, as in tests/test_torch_engine.py: primary-ray frames (config 1)
to 1e-5; path-traced frames against the jitted JAX engine statistically
(mean |d| < 5e-3 and fewer than 1% of pixels further than 1e-3 on traced
frames; the mean bound alone once the denoiser has spread each differing
pixel over its 21 taps). Config 4's emissive, temporally accumulated traced
frames are also held bit for bit against the reference run op by op with
both packages' square roots made exact (tests/test_torch_parallel.py says
why). Config 5's streamed scene is equal array for array, and its sharded
frame equals the unsharded one bit for bit.
"""

import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.io.streaming as rstreaming
import zig_vulkan_tpu.ops.trace as rtrace
import zig_vulkan_tpu_torch.core.grid as tgrid
import zig_vulkan_tpu_torch.core.materials as tmaterials
import zig_vulkan_tpu_torch.ops.trace as ttrace
from zig_vulkan_tpu_torch.benchmarks import configs as tconfigs
from zig_vulkan_tpu_torch.ops import denoise as tdenoise

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import configs as rconfigs  # noqa: E402  (the JAX harness)

torch.set_num_threads(2)

FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")
EMISSIVE = tconfigs.EMISSIVE


class _Stop(Exception):
    """Raised to leave the JAX harness where it would start rendering."""


def reference_engine(number, scale):
    """The JAX engine of config `number` at `scale`, as benchmarks/configs.py
    itself sets it up: the harness's function runs up to its first frame
    (configs 1-4: `_timed_frames`; config 5: the end of the streaming, the
    streamed count left in `rt.streamed`) and is stopped there."""
    box = {}

    def grab(rt, *args, **kw):
        box["rt"] = rt
        raise _Stop

    def grab_streamed(rt, regions, **kw):
        box["rt"] = rt
        rt.streamed = stream(rt, regions, **kw)
        raise _Stop

    stream = rstreaming.stream_into_engine
    patch = (mock.patch.object(rstreaming, "stream_into_engine",
                               grab_streamed) if number == 5
             else mock.patch.object(rconfigs, "_timed_frames", grab))
    with patch, pytest.raises(_Stop):
        rconfigs.ALL_CONFIGS[number - 1](scale=scale)
    return box["rt"]


def port_engine(number, scale):
    """The port's engine of config 1, 2 or 4 on the CPU."""
    return getattr(tconfigs, f"build_config{number}")(scale, "cpu")


def _diff(a, b):
    assert a.shape == b.shape
    return np.abs(a - b).max(axis=-1)


def _scene_equal(port_arrays, ref_arrays):
    want = tgrid.GridArrays.to_device(ref_arrays, "cpu")
    for name in FIELDS:
        got, exp = getattr(port_arrays, name), getattr(want, name)
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           exp.reshape(-1).view(torch.uint8)), name


def test_config1_dense_primary_matches_reference():
    ref, port = reference_engine(1, 0.15), port_engine(1, 0.15)
    assert port.grid_static.scale == 1.0 and port.grid_static.dims == (2, 2, 2)
    _scene_equal(port.arrays, ref.arrays)
    got, want = port.render().numpy(), np.asarray(ref.render())
    assert got.shape == (38, 38, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the solid lower half and the sky above it
    assert len(np.unique((got * 255).astype(np.uint8).reshape(-1, 3),
                         axis=0)) > 4


def test_config2_sparse_diffuse_shadows_matches_reference():
    ref, port = reference_engine(2, 0.05), port_engine(2, 0.05)
    assert port.trace_config.max_steps == 160
    assert bool(port.sun.device_data.enabled)
    _scene_equal(port.arrays, ref.arrays)
    got, want = port.render().numpy(), np.asarray(ref.render())
    assert got.shape == (36, 64, 3) and np.isfinite(got).all()
    diff = _diff(got, want)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01


@pytest.fixture(scope="module")
def config4():
    """Config 4's engines and their first three accumulated frames."""
    ref, port = reference_engine(4, 0.05), port_engine(4, 0.05)
    frames = [(np.asarray(ref.render()), port.render().numpy())
              for _ in range(3)]
    return ref, port, frames


def _traced(rt, sample_base):
    d, sun = rt.camera.d_camera, rt.sun.device_data
    w, h = rt.internal_resolution
    return ttrace.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(d, "cpu"), w, h, int(d.samples_per_pixel),
        int(d.max_bounce), sun.position, sun.color, sun.radius, True,
        max_steps=160, sample_base=sample_base)


def test_config4_scene_and_emissive_hits(config4):
    ref, port, _ = config4
    _scene_equal(port.arrays, ref.arrays)
    assert port.temporal_enabled and port.denoiser.enabled
    assert int(port.camera.d_camera.max_bounce) == 4  # config + 1
    assert port.materials_host.mtype[EMISSIVE] == tmaterials.MAT_EMISSIVE
    # lanes of the primary wavefront hit the emissive block
    d = port.camera.d_camera
    w, h = port.internal_resolution
    r = ttrace._camera_rays_soa(ttrace.camera_vectors(d, "cpu"), w, h, 0.0)
    from zig_vulkan_tpu_torch.ops import tile_tracer as ttile

    hit = ttile.grid_hit_tiles(
        port.grid_static, port.tables(), port.arrays.material_indices,
        *r[:3], *ttrace._norm3(*r[3:]),
        torch.ones(w * h, dtype=torch.bool), max_steps=160)
    emissive = hit["found"] & (hit["index"] == EMISSIVE)
    assert int(emissive.sum()) > 0


def test_config4_accumulated_frames_match_jitted_reference(config4):
    """Temporal accumulation, then the denoiser: held to the mean bound."""
    ref, port, frames = config4
    assert ref._accum_count == port._accum_count == 3
    for want, got in frames:
        assert got.shape == want.shape == (54, 96, 3)
        assert np.isfinite(got).all()
        assert _diff(got, want).mean() < 5e-3
    assert not np.array_equal(frames[0][1], frames[2][1])
    # the port's frame is its running mean put through the reference's
    # denoiser (the stages compose as the reference's step composes them)
    from zig_vulkan_tpu.ops import denoise as rdn

    want = np.asarray(rdn.denoise(port._accum.numpy(), samples=20,
                                  out_shape=(54, 96)))
    np.testing.assert_allclose(frames[2][1], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sample_base", [0.0, 2.0])
def test_config4_traced_frame_bit_equal_op_by_op(monkeypatch, config4,
                                                 sample_base):
    """The emissive, sun-lit, four-level traced frame of accumulation step
    0 and step 1 (jitter seeds from 2), against the reference's
    `render_rows` run op by op; both packages with exact square roots."""
    ref, port, _ = config4
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    d, sun = ref.camera.d_camera, ref.sun.device_data
    w, h = ref.internal_resolution
    with jax.disable_jit():
        want = np.asarray(rtrace.render_rows(
            ref.grid_static, ref.arrays, ref.mats, rtrace.camera_vectors(d),
            w, h, int(d.samples_per_pixel), int(d.max_bounce),
            sun.position, sun.color, sun.radius, True, max_steps=160,
            use_skip=True, sample_base=sample_base))
    got = _traced(port, sample_base).numpy()
    np.testing.assert_array_equal(got, want)


def test_config5_streamed_scene_equals_reference_array_for_array():
    ref = reference_engine(5, 0.05)
    c = tconfigs.build_config5(0.05, ["cpu"] * 8)
    port = c.rt
    assert c.streamed == ref.streamed > 0
    assert port.grid_static.dims == (12, 4, 12)
    assert port.grid_static.min_point == (-64.0, -16.0, -64.0)
    _scene_equal(port.arrays, ref.arrays)

    # the frame as config 5 renders it: the exact field, then the sharded
    # step with max_bounce=1 and no sun over 8 shards
    st = port.grid_static
    w, h = port.internal_resolution
    assert (w, h) == (c.width, c.height) == ref.internal_resolution
    tables, cam = c.tables, c.cam
    zeros3, ones3 = np.zeros(3, np.float32), np.ones(3, np.float32)
    got = c.sharded_step()()
    assert torch.equal(c.unsharded(), got)
    whole = ttrace.render_rows(
        st, tables, port.arrays.material_indices, port.mats, cam, w, h, 1, 1,
        zeros3, ones3, np.float32(1.0), False)
    assert got.shape == (h, w, 3) == (104, 192, 3)
    assert torch.equal(got, tdenoise.bilinear_resample(whole, h, w))

    rtab = rtrace.build_trace_tables(
        ref.grid_static, ref.arrays,
        rtrace.distance_field(ref.grid_static, ref.arrays, True))
    np.testing.assert_array_equal(tables.numpy(), np.asarray(rtab))
    want = np.asarray(rtrace.render_rows(
        ref.grid_static, ref.arrays, ref.mats,
        rtrace.camera_vectors(ref.camera.d_camera), w, h, 1, 1,
        jnp.zeros(3), jnp.ones(3), jnp.float32(1.0), False, tables=rtab,
        use_skip=True))
    diff = _diff(got.numpy(), want)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01
