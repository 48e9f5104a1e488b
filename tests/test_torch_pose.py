"""The camera's pose through the native routine (core/pose_host.py,
csrc/pose_host.cpp) against its numpy twin
(`Camera.propagate_pitch_change_plain`), bit for bit: seeded poses over the
yaws, pitches and origins a user and the benchmark path give, every move of
the camera and the engine's resolution setter, the float64 origin the
routine leaves to the twin, fresh arrays a pose, and the `pose_native`
counter. The routine compiles with g++; without it these tests skip.

Runs without the JAX package's conftest too (`--noconftest`), so the card's
machine holds its own numpy against the routine."""

from __future__ import annotations

import copy
import shutil

import numpy as np
import pytest

from zig_vulkan_tpu_torch import config as pc
from zig_vulkan_tpu_torch.core import pose_host
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.utils import profiling
from zig_vulkan_tpu_torch.utils import quat as q

F32 = np.float32
BASIS = ("horizontal", "vertical", "lower_left_corner")
POSES_PER_CASE = 2_500


@pytest.fixture
def routine():
    """The loaded routine; skips where g++ is absent."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the camera keeps its numpy twin")
    fn = pose_host.routine()
    assert fn is not None, "g++ is installed but the routine did not build"
    return fn


@pytest.fixture
def tracing():
    """Tracing on for the test, off after it."""
    profiling.enable(False)
    profiling.enable(True)
    yield profiling
    profiling.enable(False)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == F32 and a.shape == (3,), (a.dtype, a.shape)
    return a.view(np.uint32)


def _basis(cam: Camera) -> tuple:
    return tuple(np.array(getattr(cam.d_camera, n)) for n in BASIS)


def _assert_same(got: tuple, want: tuple, what) -> None:
    for name, g, w in zip(BASIS, got, want):
        assert np.array_equal(_bits(g), _bits(w)), (what, name, g, w)


def _twin_of(cam: Camera) -> tuple:
    """What the numpy twin gives for cam's current state, cam left as it
    was."""
    kept = _basis(cam)
    cam.propagate_pitch_change_plain()
    twin = _basis(cam)
    for name, value in zip(BASIS, kept):
        setattr(cam.d_camera, name, value)
    return twin


def _poses(seed: int, n: int):
    """n seeded (yaw, pitch, origin): yaw quaternions lerped, unnormalised,
    between two about Y over +-360 degrees (as the benchmark path makes
    them), a pitch about X up to the +-90 degree clamp, origins over +-300;
    every tenth pose a general quaternion pair."""
    rng = np.random.default_rng([seed, 18])
    for k in range(n):
        if k % 10 == 9:
            yaw = rng.standard_normal(4).astype(F32)
            pitch = rng.standard_normal(4).astype(F32)
        else:
            a, b = rng.uniform(-360.0, 360.0, 2)
            yaw = q.quat_lerp(q.quat_from_euler_angles(0.0, a, 0.0),
                              q.quat_from_euler_angles(0.0, b, 0.0),
                              F32(rng.uniform(0.0, 1.0)))
            pitch = q.quat_from_axis_angle(rng.uniform(-89.999, 89.999),
                                           [1.0, 0.0, 0.0])
        origin = rng.uniform(-300.0, 300.0, 3).astype(F32)
        yield yaw, pitch, origin


def _pose_both(cam: Camera, yaw, pitch, origin, what) -> None:
    cam.yaw, cam.pitch, cam.d_camera.origin = yaw, pitch, origin
    cam.propagate_pitch_change()
    _assert_same(_basis(cam), _twin_of(cam), what)


@pytest.mark.parametrize("seed", range(4))
def test_routine_equals_twin_on_seeded_poses(routine, tracing, seed):
    cam = Camera(75.0, 1024, 576)
    for k, (yaw, pitch, origin) in enumerate(_poses(seed, POSES_PER_CASE)):
        _pose_both(cam, yaw, pitch, origin, (seed, k))
    assert tracing.snapshot()["counters"]["pose_native"] == POSES_PER_CASE


@pytest.mark.parametrize("size", [(1024, 576), (1920, 1080), (64, 48)])
def test_routine_equals_twin_on_the_benchmark_path(routine, size):
    from rtbench.traffic import path_poses

    cam = Camera(75.0, *size)
    origins, yaws = path_poses(120, 0.5, 60.0)
    for k in range(len(origins)):
        _pose_both(cam, yaws[k], q.quat_identity(), origins[k], (size, k))


def _engine():
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.models import scenes

    sc = scenes.flat_test_scene(dim=8)
    return VoxelRT(sc.grid, sc.materials, pc.EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=pc.CameraConfig(samples_per_pixel=1, max_bounce=1),
        sun=pc.SunConfig(enabled=False),
        denoiser=pc.DenoiserConfig(enabled=False)), device="cpu")


MOVES = {
    "translate": lambda cam: cam.translate(0.25, [0.3, -1.0, 2.0]),
    "turn_pitch": lambda cam: cam.turn_pitch(0.7),
    "turn_yaw": lambda cam: cam.turn_yaw(-1.3),
    "reset": lambda cam: cam.reset(),
    "set_origin": lambda cam: cam.set_origin([12.5, -40.25, 299.0]),
}


@pytest.mark.parametrize("move", [*MOVES, "set_resolutions"])
def test_each_move_leaves_the_twins_camera(routine, tracing, move):
    """After a few turns, each move through the routine leaves the
    d_camera the twin gives for the same state; the routine took it."""
    rt = _engine() if move == "set_resolutions" else None
    cam = rt.camera if rt else Camera(75.0, 640, 360)
    for k in range(6):
        cam.turn_yaw(0.37 * (k + 1))
        cam.turn_pitch(-0.21 * k)
    before = tracing.snapshot()["counters"]["pose_native"]
    for _ in range(3):
        if rt:
            rt.set_resolutions(internal=(48, 27))
            cam = rt.camera
        else:
            MOVES[move](cam)
        _assert_same(_basis(cam), _twin_of(cam), move)
    snap = tracing.snapshot()
    assert snap["counters"]["pose_native"] - before >= 3
    assert snap["counters"]["pose_native"] == snap["zones"]["pose"]["count"]


def test_float64_origin_takes_the_twin(routine, tracing):
    """A float64 origin makes the twin's float64 corner; the routine leaves
    it to the twin and counts nothing."""
    cam = Camera(75.0, 1024, 576)
    cam.d_camera.origin = np.array([1.1, -2.2, 3.3], np.float64)
    cam.turn_yaw(0.4)
    corner = cam.d_camera.lower_left_corner
    assert corner.dtype == np.float64
    cam.propagate_pitch_change_plain()
    assert np.array_equal(corner.view(np.uint64),
                          cam.d_camera.lower_left_corner.view(np.uint64))
    assert cam.d_camera.horizontal.dtype == F32
    snap = tracing.snapshot()
    assert snap["counters"]["pose_native"] == 0
    assert snap["zones"]["pose"]["count"] == 1


def test_without_the_library_the_camera_keeps_the_twin(monkeypatch,
                                                       tracing):
    monkeypatch.setattr(pose_host, "_ROUTINE", None)
    monkeypatch.setattr(pose_host, "_FAILED", True)
    cam = Camera(75.0, 1024, 576)
    cam.turn_yaw(0.4)
    cam.turn_pitch(0.2)
    assert cam.d_camera.horizontal.dtype == F32
    snap = tracing.snapshot()
    assert snap["counters"]["pose_native"] == 0
    assert snap["zones"]["pose"]["count"] == 2


def test_a_pose_returns_fresh_arrays(routine):
    """The next pose writes no array an earlier pose handed out (the
    engine's `_pose_key` and `camera_basis` keep them)."""
    cam = Camera(75.0, 1024, 576)
    cam.turn_yaw(0.4)
    first = [getattr(cam.d_camera, n) for n in BASIS]
    kept = [a.copy() for a in first]
    cam.turn_yaw(0.9)
    cam.set_origin([5.0, 6.0, 7.0])
    for name, a, k in zip(BASIS, first, kept):
        assert np.array_equal(a, k), name
        assert not np.shares_memory(a, getattr(cam.d_camera, name)), name
        assert not np.shares_memory(a, cam._pose.out), name
    assert not np.array_equal(first[0], cam.d_camera.horizontal)


@pytest.mark.parametrize("copy_of", [copy.copy, copy.deepcopy])
def test_a_copied_camera_poses_on_its_own(routine, copy_of):
    """A copy of a camera (the step cache's tests and chip_smoke.py
    deep-copy one) poses through buffers of its own: its basis is the
    twin's, the original's stays as it was."""
    cam = Camera(75.0, 1024, 576)
    cam.turn_yaw(0.4)
    twin = copy_of(cam)
    kept = _basis(cam)
    twin.d_camera = copy.copy(cam.d_camera)
    twin.turn_yaw(-1.1)
    twin.set_origin([3.0, -4.0, 5.0])
    _assert_same(_basis(twin), _twin_of(twin), copy_of.__name__)
    _assert_same(_basis(cam), kept, copy_of.__name__)
    cam.turn_pitch(0.3)
    _assert_same(_basis(cam), _twin_of(cam), copy_of.__name__)


def test_pose_native_counts_a_pose_only_while_tracing(routine):
    cam = Camera(75.0, 1024, 576)
    profiling.enable(False)
    profiling.enable(True)
    try:
        for k in range(5):
            cam.turn_yaw(0.1 * k)
    finally:
        profiling.enable(False)
    counters = profiling.snapshot()["counters"]
    assert counters["pose_native"] == 5
    for k in range(5):
        cam.turn_yaw(0.1 * k)
    assert profiling.snapshot()["counters"] == counters
