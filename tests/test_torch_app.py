"""The app layer of zig_vulkan_tpu_torch against the JAX package's.

- `app.input`: the same events give the same camera pose, exactly.
- `engine.controls.ControlPanel`: the same setters give the same engine
  host state, exactly.
- `app.live`: `frame_to_ansi`, `parse_sgr_mouse`, `LiveViewer.feed` and
  `paint` give the same strings and state.
- `app.run.main`: runs on `--device cpu` at a tiny grid and resolution in
  every mode, exits non-zero without CUDA unless `--device cpu` is given,
  and its frame 0 (fixed dt 1e-3) matches the JAX app's frame 0 at the same
  arguments with the statistical bounds of tests/test_torch_engine.py (the
  denoised frame: mean |Δ| < 5e-3 over the 8-bit PNGs; the port rounds
  once per operation, the jitted JAX reference contracts FMAs).
"""

import contextlib
import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from zig_vulkan_tpu import config as rconfig
from zig_vulkan_tpu.app import input as rinput
from zig_vulkan_tpu.app import live as rlive
from zig_vulkan_tpu.core.camera import Camera as RCamera
from zig_vulkan_tpu.engine.controls import ControlPanel as RControlPanel
from zig_vulkan_tpu.engine.engine import VoxelRT as RVoxelRT
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch import config as tconfig
from zig_vulkan_tpu_torch.app import input as tinput
from zig_vulkan_tpu_torch.app import live as tlive
from zig_vulkan_tpu_torch.app import run as trun
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.engine.controls import ControlPanel
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.utils import profiling

torch.set_num_threads(2)

_CAMERA_FIELDS = ("origin", "horizontal", "vertical", "lower_left_corner",
                  "samples_per_pixel", "max_bounce", "image_width",
                  "image_height")


def _camera_state(cam):
    d = cam.d_camera
    state = {f: np.asarray(getattr(d, f)) for f in _CAMERA_FIELDS}
    state.update(yaw=np.asarray(cam.yaw), pitch=np.asarray(cam.pitch),
                 movement_speed=np.asarray(cam.movement_speed),
                 normal_speed=np.asarray(cam.normal_speed),
                 user_input_disabled=np.asarray(cam.user_input_disabled))
    return state


def _assert_same_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _engines():
    """The same small engine in both packages (16x16, no sun, no
    denoiser); nothing renders until a test asks."""
    def cfg(m):
        return m.EngineConfig(
            internal_resolution_width=16, internal_resolution_height=16,
            camera=m.CameraConfig(origin=(4.0, 6.5, 15.0),
                                  samples_per_pixel=1, max_bounce=0),
            sun=m.SunConfig(enabled=False),
            denoiser=m.DenoiserConfig(enabled=False))

    rsc = rscenes.flat_test_scene(dim=8)
    tsc = tscenes.flat_test_scene(dim=8)
    return (RVoxelRT(rsc.grid, rsc.materials, cfg(rconfig)),
            VoxelRT(tsc.grid, tsc.materials, cfg(tconfig), device="cpu"))


def _event_script(inp_mod, seed):
    """A seeded script of key and cursor events with the frame dts."""
    rng = np.random.default_rng(seed)
    keys = list(inp_mod.Key)
    steps = []
    for _ in range(60):
        r = rng.random()
        if r < 0.45:
            k = keys[rng.integers(len(keys))]
            a = (inp_mod.Action.PRESS if rng.random() < 0.6
                 else inp_mod.Action.RELEASE)
            steps.append(("key", k.name, a.name))
        elif r < 0.8:
            steps.append(("cursor", float(rng.normal() * 40),
                          float(rng.normal() * 40)))
        else:
            steps.append(("frame", float(rng.uniform(1e-3, 0.05))))
    return steps


def _drive(inp_mod, cam_cls, cfg_mod, steps):
    cam = cam_cls(75.0, 64, 48, cfg_mod.CameraConfig(turn_rate=0.5))
    inp = inp_mod.Input()
    for step in steps:
        if step[0] == "key":
            inp.key_event(inp_mod.Key[step[1]], inp_mod.Action[step[2]])
        elif step[0] == "cursor":
            inp.cursor_event(step[1], step[2])
        else:
            inp.apply_to_camera(cam, step[1])
    state = _camera_state(cam)
    state.update(
        menu_mode=np.asarray(inp.menu_mode),
        cursor_visible=np.asarray(inp.cursor_visible),
        mouse_delta=inp.mouse_delta.copy(),
        camera_translate=inp.camera_translate.copy(),
        call_translate=np.asarray(inp.call_translate),
        mouse_ignore_frames=np.asarray(inp.mouse_ignore_frames))
    return state


# -- app.input --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_input_events_drive_the_camera_like_reference(seed):
    steps = _event_script(rinput, seed)
    want = _drive(rinput, RCamera, rconfig, steps)
    got = _drive(tinput, Camera, tconfig, steps)
    _assert_same_state(got, want)


def test_input_bindings_and_enums_equal_reference():
    assert [k.value for k in tinput.Key] == [k.value for k in rinput.Key]
    assert ([s.value for s in tinput.CursorShape]
            == [s.value for s in rinput.CursorShape])
    assert ({k.value: v for k, v in tinput.Input._TRANSLATE.items()}
            == {k.value: v for k, v in rinput.Input._TRANSLATE.items()})


# -- engine.controls ------------------------------------------------------------------

def _panel_state(panel):
    e = panel.engine
    sun = e.sun
    state = _camera_state(e.camera)
    state.update(
        rays_per_frame=np.asarray(e.metrics.rays_per_frame),
        denoiser=np.asarray(json.dumps(dataclasses.asdict(e.denoiser))),
        sun_enabled=np.asarray(sun.device_data.enabled),
        sun_position=np.asarray(sun.device_data.position),
        sun_color=np.asarray(sun.device_data.color),
        sun_radius=np.asarray(sun.device_data.radius),
        sun_animate=np.asarray(sun.animate),
        sun_animate_speed=np.asarray(sun.animate_speed),
        sun_slerp=np.asarray([sun.slerp_index, sun.slerp_pos]),
        benchmark_active=np.asarray(panel.active_benchmark is not None))
    return state


def _drive_panel(panel):
    states = []
    panel.set_max_bounce(100)
    panel.set_samples_per_pixel(64)
    states.append(_panel_state(panel))
    panel.set_max_bounce(0)
    panel.set_samples_per_pixel(3)
    panel.set_movement_speed(2.5)
    panel.set_camera_origin([1.0, 2.0, 3.0])
    panel.set_denoiser(samples=8, distribution_bias=0.4)
    panel.set_sun_enabled(True)
    panel.set_sun_position([10.0, 20.0, 30.0])
    panel.set_sun_color([1.0, 0.5, 0.25])
    panel.set_sun_radius(2.5)
    panel.set_sun_animate(False, speed=0.3)
    states.append(_panel_state(panel))
    panel.engine.sun.slerp_pos = np.float32(0.7)
    panel.start_benchmark(duration=0.1)
    states.append(_panel_state(panel))
    for _ in range(5):
        panel.new_frame(0.05)
        states.append(_panel_state(panel))
    return states


def test_control_panel_setters_like_reference(capsys):
    rt_ref, rt_port = _engines()
    want = _drive_panel(RControlPanel(rt_ref))
    ref_report = capsys.readouterr().out
    got = _drive_panel(ControlPanel(rt_port))
    port_report = capsys.readouterr().out
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_state(g, w)
    assert "BENCHMARK REPORT" in port_report
    # the same report, but for the device line
    strip = [ln for ln in port_report.splitlines() if not ln.startswith("GPU")]
    assert strip == [ln for ln in ref_report.splitlines()
                     if not ln.startswith("GPU")]


def test_control_panel_metrics_text_names_the_engine_device():
    _, rt = _engines()
    panel = ControlPanel(rt)
    rt.draw(0.02)
    rt.draw(0.03)
    text = panel.metrics_text()
    assert text.splitlines()[0] == "device: cpu (cpu)"
    assert "avg 25.000" in text and "resolution: 16x16" in text


# -- app.live ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,cols,rows", [((32, 48), 24, 8),
                                             ((4, 4), 80, 40),
                                             ((37, 61), 160, 46)])
def test_frame_to_ansi_equals_reference(shape, cols, rows):
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(-0.2, 1.2, size=(*shape, 3)).astype(np.float32)
    assert (tlive.frame_to_ansi(img, cols, rows)
            == rlive.frame_to_ansi(img, cols, rows))


def test_parse_sgr_mouse_equals_reference():
    for seq in ("0;10;20M", "35;1;1m", "0;10;20", "", "0;x;1M", "1;2M",
                "64;300;200M", "0;10;20;30M"):
        assert tlive.parse_sgr_mouse(seq) == rlive.parse_sgr_mouse(seq), seq


_LIVE_EVENTS = [
    ([("char", "w")], 0.0), ([("char", "W")], 0.1), ([("arrow", "C")], 0.2),
    ([("arrow", "A"), ("arrow", "Z")], 0.3), ([("mouse", (10.0, 5.0))], 0.4),
    ([("mouse", (14.0, 3.0))], 0.5), ([("char", "2"), ("char", "4")], 0.6),
    ([("char", "1")], 0.7), ([("esc", None)], 0.8), ([("char", "d")], 0.9),
    ([("esc", None)], 1.0), ([("char", " ")], 1.4), ([("char", "c")], 1.5),
    ([("arrow", "D")] * 6, 1.6), ([("char", "3")], 1.7),
    ([("char", "x"), ("char", "q")], 1.8),
]


def _drive_viewer(live_mod, rt):
    out = io.StringIO()
    v = live_mod.LiveViewer(rt, out=out, max_cols=16, max_rows=8)
    img = np.random.default_rng(5).uniform(size=(16, 16, 3)).astype(np.float32)
    log = []
    for events, now in _LIVE_EVENTS:
        alive = v.feed(events, now)
        v.expire_holds(now)
        v.inp.apply_to_camera(rt.camera, 0.016)
        v.paint(img)
        log.append((alive, sorted(k.value for k in v._held),
                    list(v._cursor), v.hud()))
    return log, out.getvalue(), _camera_state(rt.camera)


def test_live_viewer_feed_and_paint_like_reference():
    rt_ref, rt_port = _engines()
    want_log, want_out, want_cam = _drive_viewer(rlive, rt_ref)
    got_log, got_out, got_cam = _drive_viewer(tlive, rt_port)
    assert got_log == want_log
    assert got_out == want_out
    _assert_same_state(got_cam, want_cam)
    assert not got_log[-1][0]  # "q" quits


def test_live_viewer_runs_frames_on_the_engine():
    _, rt = _engines()
    out = io.StringIO()
    v = tlive.LiveViewer(rt, out=out, max_cols=16, max_rows=8)
    assert v.run(max_frames=2) == 2
    assert out.getvalue().count("frame ") == 2
    assert rt.metrics.summary()["frames"] == 2


# -- app.run ---------------------------------------------------------------------

_TINY = ["--width", "24", "--height", "16", "--grid", "4", "2", "4",
         "--spp", "1", "--bounces", "1"]


def _read_png(path) -> np.ndarray:
    """Decode the 8-bit RGB PNGs io.image.write_png writes (filter 0)."""
    data = path.read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_app_frame0_matches_reference_app(tmp_path):
    from zig_vulkan_tpu.app import run as rrun

    args = _TINY + ["--frames", "1"]
    assert rrun.main(args + ["--out", str(tmp_path / "ref")]) == 0
    assert trun.main(args + ["--device", "cpu",
                             "--out", str(tmp_path / "port")]) == 0
    want = _read_png(tmp_path / "ref" / "frame_0000.png")
    got = _read_png(tmp_path / "port" / "frame_0000.png")
    assert got.shape == want.shape == (16, 24, 3)
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32)) / 255.0
    assert diff.max(axis=-1).mean() < 5e-3
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 4


def test_app_stops_without_cuda_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trun.main(_TINY + ["--frames", "1"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert trun.main(_TINY + ["--frames", "1", "--device", "cuda:0"]) != 0


def test_app_flags_and_defaults_equal_reference():
    import argparse

    from zig_vulkan_tpu.app import run as rrun

    port = vars(trun.parse_args([]))
    assert port.pop("device") == "cuda"
    # the JAX app parses inside main(); rebuild its parser's defaults
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.update(vars(parse(self, [])))
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        mp.setattr("zig_vulkan_tpu.utils.jitcache.enable", lambda: None)
        with pytest.raises(Stop):
            rrun.main([])
    assert port == seen


@pytest.mark.parametrize("mode", ["frames", "script", "benchmark", "live",
                                  "profile"])
def test_app_modes_on_cpu(tmp_path, capsys, mode):
    args = _TINY + ["--device", "cpu", "--frames", "3"]
    if mode == "frames":
        args += ["--out", str(tmp_path)]
    elif mode == "script":
        args += ["--script", "demo", "--out", str(tmp_path)]
    elif mode == "benchmark":
        args += ["--benchmark", "--benchmark-duration", "60"]
    elif mode == "live":
        args += ["--live", "--live-cols", "12", "--live-rows", "6"]
    else:
        args += ["--profile", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert trun.main(args) == 0
    err = capsys.readouterr().err
    assert "scene + engine ready in" in err and "on cpu (cpu)" in err
    if mode in ("frames", "script"):
        assert "rendered 3 frames; metrics:" in err
        pngs = sorted(p.name for p in tmp_path.glob("*.png"))
        assert pngs == [f"frame_{i:04d}.png" for i in range(3)]
        assert _read_png(tmp_path / pngs[-1]).shape == (16, 24, 3)
    elif mode == "benchmark":
        assert "BENCHMARK REPORT" in out.getvalue()
    elif mode == "live":
        assert "live session ended after 3 frames" in err
        assert out.getvalue().count("\x1b[H") == 3
    else:
        trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"draw", "render_step", "device_sync"} <= names
        assert not profiling.enabled()
