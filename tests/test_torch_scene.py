"""Host scene modules of zig_vulkan_tpu_torch against the JAX package's.

The port owns numpy copies of the host-side builders (core.grid.BrickGrid,
models.scenes, core.materials, core.camera, core.sun, io.vox, utils.quat).
Built from the same inputs they must give bit-identical arrays, and
`GridArrays.to_device` must take arrays built by either package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_vulkan_tpu import config as rconfig
from zig_vulkan_tpu.core import camera as rcamera
from zig_vulkan_tpu.core import sun as rsun
from zig_vulkan_tpu.io import vox as rvox
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.utils import quat as rquat
from zig_vulkan_tpu_torch import config as tconfig
from zig_vulkan_tpu_torch.core import camera as tcamera
from zig_vulkan_tpu_torch.core import sun as tsun
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.io import vox as tvox
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.utils import quat as tquat

torch.set_num_threads(2)

_FIELDS = ("statuses", "indices", "occupancy", "start_indices",
           "material_indices", "active_bricks", "material_cursor",
           "diel_mask", "brick_ir")


def _assert_scenes_equal(ref, port):
    assert dataclasses.astuple(ref.grid.static) == \
        dataclasses.astuple(port.grid.static)
    for name in _FIELDS:
        a = np.asarray(getattr(ref.grid.arrays, name))
        b = np.asarray(getattr(port.grid.arrays, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b, equal_nan=True), name
    for name in ("mtype", "albedo", "type_data"):
        assert np.array_equal(getattr(ref.materials, name),
                              getattr(port.materials, name)), name


@pytest.mark.parametrize("build", [
    lambda m: m.default_scene(dims=(16, 8, 16)),
    lambda m: m.default_scene(dims=(16, 8, 16), with_model=False),
    lambda m: m.flat_test_scene(8),
    lambda m: m.flat_test_scene(8, fill_material=2, scale=0.5),
], ids=["default_16x8x16", "terrain_only", "flat_8", "flat_8_water"])
def test_scene_builders_bit_identical(build):
    _assert_scenes_equal(build(rscenes), build(tscenes))


def test_random_inserts_bit_identical():
    """Batch inserts with repeated coordinates (last writer wins) and
    dielectrics of two different ir in one brick (brick_ir NaN)."""
    rng = np.random.default_rng(3)
    n = 3000
    xyz = [rng.integers(0, 32, n), rng.integers(0, 16, n),
           rng.integers(0, 32, n)]
    mats = rng.integers(0, 9, n).astype(np.uint8)
    ref = rscenes.flat_test_scene(8)
    port = tscenes.flat_test_scene(8)
    # material 0 is water (ir 1.333); give material 9 another ir
    for sc in (ref, port):
        sc.materials.set(9, 2, (0.5, 0.5, 0.5), 1.5)
        sc.grid.attach_materials(sc.materials)
        sc.grid.insert_batch(*xyz, mats)
        sc.grid.insert_batch(np.array([0, 1]), np.array([5, 5]),
                             np.array([0, 0]), np.array([0, 9], np.uint8))
    _assert_scenes_equal(ref, port)
    assert np.isnan(port.grid.arrays.brick_ir).any()


def test_to_device_takes_reference_arrays():
    ref = rscenes.default_scene(dims=(16, 8, 16))
    port = tscenes.default_scene(dims=(16, 8, 16))
    from_ref = GridArrays.to_device(ref.grid.arrays, "cpu")
    from_port = port.grid.arrays.to_device("cpu")
    for name in _FIELDS:
        a, b = getattr(from_ref, name), getattr(from_port, name)
        assert a.dtype == b.dtype and a.device.type == "cpu", name
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name
    # uint32 fields are int32 bit views: same bytes, no value conversion
    for name in GridArrays._U32_FIELDS:
        host = np.asarray(getattr(ref.grid.arrays, name), dtype=np.uint32)
        dev = getattr(from_ref, name)
        assert dev.dtype == torch.int32, name
        assert np.array_equal(dev.numpy().view(np.uint32), host), name
    assert from_ref.material_indices.dtype == torch.uint8
    assert from_ref.brick_ir.dtype == torch.float32


def test_to_device_bit_views_sentinel_and_bit31():
    """The empty-cell sentinel reads -1 and occupancy bit 31 the sign bit."""
    sc = tscenes.flat_test_scene(8)
    a = sc.grid.arrays
    a.indices[0] = np.uint32(0xFFFFFFFF)
    a.occupancy[0] = np.uint32(1 << 31)
    dev = a.to_device("cpu")
    assert int(dev.indices[0]) == -1
    assert int(dev.occupancy[0]) == -(1 << 31)
    assert int((dev.occupancy[0] >> 31) & 1) == 1


def test_materials_and_palette_identical():
    assert np.array_equal(rvox.default_palette(), tvox.default_palette())
    rm, tm = rscenes.demo_model(), tscenes.demo_model()
    assert rm.sizes == tm.sizes
    assert np.array_equal(rm.models[0], tm.models[0])


def test_vox_roundtrip_through_port_writer(tmp_path):
    """A file written by the port's writer parses identically in both."""
    rng = np.random.default_rng(5)
    xyzi = rng.integers(0, 8, (40, 4)).astype(np.uint8)
    xyzi[:, 3] = rng.integers(1, 255, 40)
    path = str(tmp_path / "m.vox")
    tvox.write(path, [(8, 8, 8)], [xyzi])
    r, t = rvox.load(path, strict=True), tvox.load(path, strict=True)
    assert r.sizes == t.sizes
    assert np.array_equal(r.models[0], t.models[0])
    assert np.array_equal(r.palette, t.palette)


def _camera_moves(mod_camera, mod_config):
    cam = mod_camera.Camera(75.0, 96, 54, mod_config.CameraConfig(
        origin=(1.0, 2.0, 3.0), max_bounce=2))
    cam.turn_yaw(0.4)
    cam.turn_pitch(-0.2)
    cam.translate(0.25, [0.0, 0.0, -1.0])
    cam.activate_sprint()
    cam.translate(0.5, [1.0, 0.0, 0.0])
    return cam.d_camera


def test_camera_identical():
    r = _camera_moves(rcamera, rconfig)
    t = _camera_moves(tcamera, tconfig)
    for name in ("horizontal", "vertical", "lower_left_corner", "origin"):
        assert np.array_equal(getattr(r, name), getattr(t, name)), name
    assert (r.max_bounce, r.samples_per_pixel) == (t.max_bounce,
                                                   t.samples_per_pixel)


def test_sun_identical():
    r = rsun.Sun(rconfig.SunConfig())
    t = tsun.Sun(tconfig.SunConfig())
    for dt in (0.0, 0.7, 3.1, 11.0):
        r.update(dt)
        t.update(dt)
        rd, td = r.device_data, t.device_data
        assert np.array_equal(rd.position, td.position)
        assert np.array_equal(rd.color, td.color)
        assert rd.radius == td.radius and rd.enabled == td.enabled


def test_quat_identical():
    for e in ((0, 45, 0), (10, -20, 0), (80, -90, 0)):
        assert np.array_equal(rquat.quat_from_euler_angles(*e),
                              tquat.quat_from_euler_angles(*e))


def test_config_defaults_match_reference():
    r, t = rconfig.EngineConfig(), tconfig.EngineConfig()
    for name in ("internal_resolution_width", "internal_resolution_height",
                 "camera", "sun", "denoiser"):
        assert dataclasses.asdict(r)[name] == dataclasses.asdict(t)[name]
    assert t.trace.max_steps == r.trace.max_steps
    assert t.trace.empty_skip == r.trace.empty_skip
    assert t.debug_validation == r.debug_validation
    # the exact cell-by-cell DDA is a valid configuration in both packages
    assert not tconfig.TraceConfig(empty_skip=False).empty_skip


def test_device_arrays_is_to_device():
    """`BrickGrid.device_arrays(device)`: field by field what
    `GridArrays.to_device` gives (dtypes and the uint32 fields' int32 bit
    views), and the JAX package's `device_arrays()` of the same grid
    viewed back; without a device it asks for CUDA and never takes the
    CPU on its own."""
    from zig_vulkan_tpu_torch.utils.device import NoCudaDevice

    ref = rscenes.flat_test_scene(dim=8)
    port = tscenes.flat_test_scene(dim=8)
    got = port.grid.device_arrays("cpu")
    want = port.grid.arrays.to_device("cpu")
    jax_arrays = ref.grid.device_arrays()
    for name in _FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.device.type == "cpu" and g.dtype == w.dtype, name
        # bit for bit: brick_ir holds NaN for bricks without a dielectric
        assert g.numpy().tobytes() == w.numpy().tobytes(), name
        j = np.asarray(getattr(jax_arrays, name))
        if name in GridArrays._U32_FIELDS:
            assert g.dtype == torch.int32, name
            j = np.array(j, dtype=np.uint32).view(np.int32)
        assert g.numpy().dtype == j.dtype, name
        assert g.numpy().tobytes() == j.tobytes(), name
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(NoCudaDevice):
                port.grid.device_arrays(device)
