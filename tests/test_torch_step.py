"""The compiled frame step of zig_vulkan_tpu_torch's engine against the JAX
engine's (`_step_key`, `_step_cache`, `_build_step`, `_push_constants`).

On the CPU a step's body runs op by op, so these tests hold what the CUDA
graph captures: the push constants (bit for bit against the JAX engine's),
the key, the body fed from the push constants against the frame rendered
from host values (bit for bit), the scene tensors a step reads after
edits, reloads and material changes, and the images it returns. The
replays themselves are tested on the card (`tests/test_torch_kernels.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.engine.engine import VoxelRT as RefVoxelRT
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch.benchmarks import bench as tbench
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.engine import step as tstep
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import denoise as tdn
from zig_vulkan_tpu_torch.ops import lookup as tlookup
from zig_vulkan_tpu_torch.ops import rng as trng
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace
from zig_vulkan_tpu_torch.utils import profiling as tprof

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


def _config(m, out=64, spp=2, max_bounce=2, denoise=True, animate=True,
            **trace):
    return m.EngineConfig(
        internal_resolution_width=48, internal_resolution_height=48,
        output_resolution_width=out, output_resolution_height=out,
        camera=m.CameraConfig(origin=ORIGIN, samples_per_pixel=spp,
                              max_bounce=max_bounce),
        sun=m.SunConfig(enabled=True, animate=animate),
        denoiser=m.DenoiserConfig(enabled=denoise),
        trace=m.TraceConfig(**trace))


def _engines(**kw):
    rsc, tsc = _parity_scene(rscenes), _parity_scene(tscenes)
    return (RefVoxelRT(rsc.grid, rsc.materials, _config(rconfig, **kw)),
            VoxelRT(tsc.grid, tsc.materials, _config(tconfig, **kw),
                    device="cpu"))


def _port(**kw):
    return _engines(**kw)[1]


def _both(rts, fn):
    for rt in rts:
        fn(rt)


_PC_CASES = {
    "static": lambda rt: None,
    "moved_camera": lambda rt: (rt.camera.turn_yaw(0.3),
                                rt.camera.translate(0.5, [1.0, 0.0, -1.0])),
    "moved_sun": lambda rt: (rt.update_sun(2.0), rt.update_sun(7.5)),
    "temporal_count_0": lambda rt: rt.set_temporal(True),
    "temporal_count_3": lambda rt: (rt.set_temporal(True),
                                    setattr(rt, "_accum_count", 3)),
    "samples_above_32": lambda rt: rt.set_denoiser(samples=40,
                                                   distribution_bias=0.45,
                                                   inverse_hue_tolerance=7.0),
    "samples_4": lambda rt: rt.set_denoiser(samples=4),
}


@pytest.mark.parametrize("case", sorted(_PC_CASES))
def test_push_constants_match_reference(case):
    """The f32[24] array of one frame, bit for bit, for the same camera,
    sun, denoiser and temporal state (the JAX engine clips `samples` to
    MAX_RUNTIME_SAMPLES in pc[23]; so does the port's)."""
    ref, port = _engines()
    _both((ref, port), _PC_CASES[case])
    want = ref._push_constants()
    got = port._push_constants()
    assert got.dtype == np.float32 and got.shape == (24,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "samples_above_32":
        assert got[23] == 32.0


# the JAX key's fields by position (zig_vulkan_tpu/engine/engine.py:130-133)
_REF_KEY = ("internal_width", "internal_height", "output_width",
            "output_height", "samples_per_pixel", "max_bounce",
            "sun_enabled", "denoiser_enabled", "pixel_multiplier",
            "max_steps", "empty_skip", "temporal", None, None, None, None,
            None, "sun_in_kernel", None)


@pytest.mark.parametrize("temporal", [False, True])
def test_step_key_holds_the_reference_fields(temporal):
    ref, port = _engines(max_steps=200, empty_skip=False)
    _both((ref, port), lambda rt: rt.set_temporal(temporal))
    rkey, key = ref._step_key(), port._step_key()
    assert isinstance(key, tstep.StepKey)
    for i, name in enumerate(_REF_KEY):
        if name is not None and name != "sun_in_kernel":
            assert getattr(key, name) == rkey[i], name
    # the JAX step reads sun_in_kernel only with the Pallas tracer; the
    # port's step reads it always
    assert key.sun_in_kernel is False
    assert key.temporal is temporal and key.max_steps == 200
    assert key.empty_skip is False


@pytest.mark.parametrize("knob, value", [("samples", 8),
                                         ("distribution_bias", 0.3),
                                         ("inverse_hue_tolerance", 5.0)])
def test_step_key_changes_with_the_denoiser_push_constants(knob, value):
    """The port's key holds the three values the JAX step reads from pc[19],
    pc[20] and pc[23]: a change is a new step (a new capture on a card),
    where the JAX key stays the same."""
    ref, port = _engines()
    rkey, key = ref._step_key(), port._step_key()
    before = port.step()
    _both((ref, port), lambda rt: rt.set_denoiser(**{knob: value}))
    assert ref._step_key() == rkey
    assert port._step_key() != key
    field = {"samples": "denoiser_samples"}.get(knob, knob)
    assert getattr(port._step_key(), field) == value
    port.render()
    assert port.step() is not before
    assert list(port._step_cache) == [port._step_key()]  # the old one freed


def _host_frame(rt, sample_base=0.0):
    """The frame from host values: the camera basis copied to the device,
    the sun as numpy values, the sample base as a float."""
    d, sun = rt.camera.d_camera, rt.sun.device_data
    iw, ih = rt.internal_resolution
    ow, oh = rt.output_resolution
    img = ttrace.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(d, rt.device), iw, ih,
        int(d.samples_per_pixel), int(d.max_bounce), sun.position,
        sun.color, sun.radius, bool(sun.enabled),
        max_steps=rt.trace_config.max_steps, sample_base=sample_base,
        shadow_probe=bool(rt.trace_config.sun_in_kernel),
        use_skip=rt.trace_config.empty_skip)
    return img, tdn.postprocess(img, rt.denoiser, oh, ow)


@pytest.mark.parametrize("probe", [False, True])
def test_body_from_push_constants_equals_host_value_frame(probe):
    """The step's body, fed the f32[24] push constants, renders the frame
    that host values render, bit for bit (a moved camera and sun)."""
    rt = _port(sun_in_kernel=probe)
    _PC_CASES["moved_camera"](rt)
    _PC_CASES["moved_sun"](rt)
    _, want = _host_frame(rt)
    step = rt.step()
    rt._push.upload(rt._push_constants(), step.pc)
    assert torch.equal(step.body(step.pc, step.accum), want)
    assert torch.equal(rt.render(), want)
    assert torch.equal(rt.render_op_by_op(), want)


def test_temporal_body_is_the_running_mean_of_host_value_frames():
    """Frame k of a static pose is the running mean of the traced frames
    with sample base k * spp, accumulated in the step's buffer in place."""
    rt = _port(denoise=False, out=48, animate=False)
    rt.set_temporal(True)
    mean = None
    for k in range(3):
        img, _ = _host_frame(rt, sample_base=2.0 * k)
        mean = img.clone() if mean is None else mean + ttrace._div(
            img - mean, k + 1)
        got = rt.render()
        assert torch.equal(got, mean)
    assert rt._accum is rt.step().accum and rt._accum_count == 3
    assert torch.equal(rt._accum, mean)


def test_moved_frame_matches_the_jax_step():
    """A frame after a move of the camera and the sun, through the port's
    step and the JAX engine's jitted step, within tests/test_torch_engine.py's
    bound for the denoised default frame."""
    ref, port = _engines()
    for m in ("moved_camera", "moved_sun"):
        _both((ref, port), _PC_CASES[m])
    want = np.asarray(ref.render())
    got = port.render().numpy()
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got - want).max(axis=-1).mean() < 5e-3


def _fresh(grid, materials, config):
    return VoxelRT(grid, materials, config, device="cpu").render()


def _edited_grid():
    sc = _parity_scene(tscenes)
    xs, zs = np.meshgrid(np.arange(0, 12), np.arange(0, 12), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 10), zs.ravel(),
                         np.full(xs.size, 3, dtype=np.uint8))
    return sc


def test_flush_grid_drops_the_steps():
    rt = _port()
    before = rt.render()
    step = rt.step()
    sc = _edited_grid()
    rt.flush_grid(sc.grid)
    assert rt._step_cache == {}
    got = rt.render()
    assert rt.step() is not step
    assert torch.equal(got, _fresh(sc.grid, rt.materials_host, rt.config))
    assert not torch.equal(got, before)


@pytest.mark.parametrize("how", ["push_materials", "push_albedo"])
def test_material_changes_write_in_place(how):
    """The step keeps its table: a new albedo shows in the next frame
    through the same step (on a card, the same graph)."""
    rt = _port()
    rt.render()
    step, table = rt.step(), rt.mats
    sc = _parity_scene(tscenes)
    mats = sc.materials
    mats.albedo[7] = np.asarray([0.1, 0.9, 0.2], np.float32)
    if how == "push_materials":
        rt.push_materials(mats)
    else:
        rt.push_albedo(7, [0.1, 0.9, 0.2])
    got = rt.render()
    assert rt.step() is step and rt.mats is table
    assert torch.equal(got, _fresh(sc.grid, mats, rt.config))


def test_empty_skip_flip_rebuilds_records_and_steps():
    rt = _port()
    rt.render()
    step = rt.step()
    rt.trace_config = dataclasses.replace(rt.trace_config, empty_skip=False)
    got = rt.render()
    assert rt.step() is not step and not rt.step().key.empty_skip
    assert len(rt._step_cache) == 1  # the rebuild dropped the old step
    sc = _parity_scene(tscenes)
    assert torch.equal(got, _fresh(sc.grid, sc.materials, dataclasses.replace(
        rt.config, trace=rt.trace_config)))


def test_set_resolutions_gives_a_new_key():
    rt = _port()
    rt.render()
    key = rt._step_key()
    rt.set_resolutions(internal=(32, 24), output=(40, 30))
    assert rt._step_key() != key
    assert rt.render().shape == (30, 40, 3)
    assert list(rt._step_cache) == [rt._step_key()]
    rt.set_resolutions(internal=(48, 48), output=(64, 64))
    assert rt._step_key() == key


def test_edits_between_frames_show_through_the_same_step():
    """Inserts and removals write the scene tensors and the records in
    place: the next frame sees them through the same step."""
    rt = _port(denoise=False, out=48)
    first = rt.render()
    step = rt.step()
    xs, zs = np.meshgrid(np.arange(2, 30), np.arange(2, 30), indexing="ij")
    xyz = np.stack([xs.ravel(), np.full(xs.size, 9), zs.ravel()], -1)
    rt.insert_voxels(xyz, np.full(xs.size, 3, dtype=np.uint8))
    inserted = rt.render()
    assert rt.step() is step
    assert not torch.equal(inserted, first)
    assert torch.equal(inserted, _host_frame(rt)[1])
    rt.remove_voxels(xyz)
    removed = rt.render()
    assert rt.step() is step
    assert torch.equal(removed, _host_frame(rt)[1])
    assert not torch.equal(removed, inserted)


@pytest.mark.parametrize("temporal", [False, True])
def test_returned_image_survives_later_frames(temporal):
    """With temporal accumulation, no denoiser and equal sizes the step's
    output is a view of its accumulator: the engine returns a copy."""
    rt = _port(denoise=False, out=48, animate=False)
    rt.set_temporal(temporal)
    a = rt.render()
    kept = a.clone()
    rt.camera.translate(0.2, [1.0, 0.0, 0.0])
    b = rt.render()
    rt.render()
    assert torch.equal(a, kept) and not torch.equal(a, b)


def test_render_op_by_op_counts_temporal_frames():
    rt = _port(denoise=False, out=48, animate=False)
    rt.set_temporal(True)
    a = rt.render_op_by_op()
    b = rt.render()
    assert rt._accum_count == 2 and not torch.equal(a, b)


@pytest.mark.parametrize("value", [0.0, 0.25, 1.0])
def test_rand2_range_tensor_bounds_round_as_float_bounds(value):
    """`hi - lo` rounds to float32 alike for host and 0-d tensor bounds (the
    sun radius as a push constant)."""
    co = torch.from_numpy(np.random.default_rng(3).uniform(
        -50, 50, (4096, 2)).astype(np.float32))
    r = np.float32(value)
    t = torch.tensor(r)
    assert torch.equal(trng.rand2_range(co, -t, t),
                       trng.rand2_range(co, -r, r))


def test_render_rows_takes_per_frame_values_as_tensors():
    """Sun, camera and sample base as 0-d / f32[3] tensors give the frame
    that host values give, bit for bit."""
    rt = _port(animate=False)
    _PC_CASES["moved_sun"](rt)
    d, sun = rt.camera.d_camera, rt.sun.device_data
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
            ttrace.camera_vectors(d, "cpu"), 48, 48, 2, 3)
    want = ttrace.render_rows(*args, sun.position, sun.color, sun.radius,
                              True, sample_base=6.0)
    got = ttrace.render_rows(
        *args, torch.from_numpy(sun.position.copy()),
        torch.from_numpy(np.asarray(sun.color).copy()),
        torch.tensor(np.float32(sun.radius)), True,
        sample_base=torch.tensor(np.float32(6.0)))
    assert torch.equal(got, want)


def test_graphed_call_and_launch_counters_on_the_cpu():
    """On the CPU a GraphedCall runs its body on every call and captures
    nothing; the frames' wrappers run the plain versions and count no
    launch."""
    calls = []
    x = torch.arange(4.0)
    g = tstep.GraphedCall(lambda t: calls.append(1) or t * 2, x)
    captures = tstep.GraphedCall.captures
    assert torch.equal(g(), x * 2) and torch.equal(g(), x * 2)
    assert len(calls) == 2 and g.graph is None
    assert tstep.GraphedCall.captures == captures
    before = (ttile.grid_hit_tiles.launches, tlookup.table_lookup.launches)
    rt = _port()
    rt.render()
    rt.render()
    assert (ttile.grid_hit_tiles.launches,
            tlookup.table_lookup.launches) == before


# kernel names as a torch.profiler trace of the card shows them
_TRACE_NAMES = (
    "void traverse_kernel<false, false, true, true>(TraceParams, Inverses, "
    "Buffers)",
    "void traverse_kernel<true, false, true, true>(TraceParams, Inverses, "
    "Buffers)",
    "void traverse_kernel<false, true, false, false>(TraceParams, Inverses, "
    "Buffers)",
    "_Z15traverse_kernelILb0ELb0ELb1ELb1EEv11TraceParams8Inverses7Buffers",
    "void lookup_kernel<true>(float const*, int, int, int const*, long, "
    "long, float*)",
    "void lookup_kernel<false>(float const*, int, int, int const*, long, "
    "long, float*)",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::FillFunctor<float>>(int, float*)",
    "Memcpy HtoD (Pinned -> Device)",
)


def test_kernel_launches_counts_trace_names_by_build():
    got = tprof.kernel_launches(_TRACE_NAMES)
    assert got["A"] == 4 and got["B"] == 2
    assert got["default"] == 2 and got["shadow"] == 1
    assert got["exact+stats"] == 1
    assert set(got) == set(ttile.grid_hit_tiles.build_launches) | {"A", "B"}
    assert tprof.kernel_launches([])["A"] == 0


def test_step_cache_keeps_one_step_over_denoiser_values():
    """A slider sweep of the denoiser makes a key a value; the cache keeps
    the current key's step alone, so no old graph stays behind."""
    rt = _port(denoise=True, out=48)
    seen = set()
    for i in range(10):
        rt.set_denoiser(distribution_bias=0.05 * (i + 1))
        rt.render()
        seen.add(rt._step_key())
        assert len(rt._step_cache) == 1
    assert len(seen) == 10


def test_temporal_mean_carries_over_a_denoiser_change():
    """A new step of the same resolution takes the running mean on, as the
    JAX engine's accumulator does: three frames with a denoiser change
    after the second accumulate what three frames without it do."""
    a, b = _port(out=48, animate=False), _port(out=48, animate=False)
    for rt in (a, b):
        rt.set_temporal(True)
        rt.render()
        rt.render()
    step = a.step()
    a.set_denoiser(distribution_bias=0.3)
    a.render()
    b.render()
    assert a.step() is not step and a._accum is a.step().accum
    assert a._accum_count == b._accum_count == 3
    assert torch.equal(a._accum, b._accum)
    a.camera.translate(0.2, [1.0, 0.0, 0.0])  # a move starts it again
    a.render()
    assert a._accum_count == 1


def test_camera_basis_is_the_push_constant_basis():
    """One packer of the basis: `camera_basis` is pc[0:12], and
    `camera_vectors` are its four f32[3] views on the device."""
    rt = _port()
    _PC_CASES["moved_camera"](rt)
    d = rt.camera.d_camera
    basis = ttrace.camera_basis(d)
    np.testing.assert_array_equal(basis, rt._push_constants()[0:12])
    cv = ttrace.camera_vectors(d, "cpu")
    for name in ttrace.CAMERA_BASIS:
        np.testing.assert_array_equal(
            cv[name].numpy(), np.asarray(getattr(d, name), np.float32))


def test_push_ring_on_the_cpu_copies():
    ring = tstep.PushRing("cpu")
    dst = torch.zeros(24)
    values = np.arange(24, dtype=np.float32)
    ring.upload(values, dst)
    values[:] = 0  # the host array may change after the upload
    assert torch.equal(dst, torch.arange(24.0))


def test_pose_frame_equals_the_eager_pose():
    """The bench's compiled pose frame (op by op on the CPU) against the
    rays made from `camera_vectors` and traced as before."""
    sc = tscenes.small_test_scene()
    st = sc.grid.static
    arrays = sc.grid.arrays.to_device("cpu")
    tables = ttrace.build_trace_tables(st, arrays)
    d = Camera(75.0, 40, 24, tconfig.CameraConfig(origin=ORIGIN)).d_camera
    frame = tbench.PoseFrame(st, tables, arrays.material_indices, 40, 24)
    got = frame(torch.from_numpy(ttrace.camera_basis(d)))
    r = ttrace._camera_rays_soa(ttrace.camera_vectors(d, "cpu"), 40, 24, 0)
    rays = (a.contiguous() for a in (*r[:3], *ttrace._norm3(*r[3:])))
    want = ttile.grid_hit_tiles(st, tables, arrays.material_indices, *rays,
                                torch.ones(40 * 24, dtype=torch.bool))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(got["found"].sum()) > 0
