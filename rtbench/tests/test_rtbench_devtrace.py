"""The reading of a traced stretch, on a trace written by hand: the range
between the marker kernels, the busy union, the idle pieces by host range,
each per-layer reader and the breakdown."""

from __future__ import annotations

import pytest

from rtbench import devtrace, spec

A = "void (anonymous namespace)::traverse_kernel<false, false, true, true>(x)"
D = "(anonymous namespace)::shade_kernel(ShadeArgs)"
F = "void (anonymous namespace)::denoise_kernel_runtime<0, true>(DenoiseArgs)"
ENGINE = {"internal_resolution_width": 1024,
          "internal_resolution_height": 576,
          "output_resolution_width": 1024, "output_resolution_height": 576,
          "denoiser": {"enabled": True, "samples": 20}}


def _k(name, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def _zone(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _trace():
    """Two frames between the markers: each A 100 us, D 20 us (overlapping
    A by 10), F 30 us, a copy of 5; idle between the frames."""
    ev = [_k("spin_kernel", 0, 1), _k("spin_kernel", 10, 1),
          _k(A, 5, 3)]  # before the range: not counted
    for f, t0 in enumerate((100, 400)):
        ev += [_k("Memcpy HtoD", t0, 5, "gpu_memcpy"),
               _k(A, t0 + 10, 100), _k(D, t0 + 100, 20),
               _k(F, t0 + 130, 30),
               _zone("rtbench.frame", t0 - 80, 260),
               _zone("draw", t0 - 5, 170),
               _zone("device_sync", t0 + 20, 145)]
    ev += [_k("spin_kernel", 700, 20), _k("spin_kernel", 730, 20)]
    return ev


def test_range_busy_and_gaps():
    st = devtrace.read(_trace(), frames=2, engine=ENGINE)
    assert st.window_us == pytest.approx(700 - 11)
    # a frame: copy 5, gap 5, A..D 110, gap 10, F 30
    assert st.busy_us == pytest.approx(2 * (5 + 110 + 30))
    idle = sum(length for _, length, _ in st.gaps)
    assert idle == pytest.approx(st.window_us - st.busy_us)
    names = {host for _, _, host in st.gaps}
    assert names <= {"rtbench.frame", "draw", "device_sync",
                     "no host range"}
    assert st.kernel_ms({"A"}) == pytest.approx(0.1)
    assert st.kernel_ms({"D"}) == pytest.approx(0.02)


def test_lost_markers():
    with pytest.raises(devtrace.LostMarkers):
        devtrace.read([e for e in _trace() if e["dur"] < 5
                       or e["name"] != "spin_kernel"], frames=2)
    with pytest.raises(devtrace.LostMarkers):
        devtrace.read([e for e in _trace() if e["name"] != "spin_kernel"],
                      frames=2)


def test_readers():
    bench = spec.load()
    st = devtrace.read(_trace(), frames=2, action_ms={"edit": [0.5, 0.25]},
                       engine=ENGINE)
    readers = {m.name: spec.reader(m.name)
               for m in spec.metrics(bench, "per_layer")}
    got = devtrace.per_layer(st, readers)
    assert got["device.busy_ms"] == pytest.approx(0.145)
    assert got["device.idle_share"] == pytest.approx(
        100 * (1 - 290 / 689))
    assert got["traverse.ms"] == pytest.approx(0.1)
    assert got["shade.ms"] == pytest.approx(0.02)
    assert got["edit.ms"] == pytest.approx(0.375)
    from rtbench.roofline import denoise_bound_ms
    assert got["denoise_roofline"] == pytest.approx(
        100 * denoise_bound_ms(ENGINE) / 0.03)
    # nothing to read: no edits, no denoiser
    quiet = devtrace.read(_trace(), frames=2, engine=dict(
        ENGINE, denoiser={"enabled": False, "samples": 20}))
    got = devtrace.per_layer(quiet, readers)
    assert "edit.ms" not in got and "denoise_roofline" not in got


def test_denoise_bound_of_the_default_frame():
    """21 live taps over 589,824 pixels bound by operations: 18.2 us."""
    from rtbench.roofline import denoise_bound_ms

    assert denoise_bound_ms(ENGINE) == pytest.approx(
        589_824 * (21 * 98 + 13) / 67e12 * 1e3)
    assert denoise_bound_ms(ENGINE) == pytest.approx(0.01823, abs=1e-5)


def test_breakdown():
    st = devtrace.read(_trace(), frames=2, engine=ENGINE)
    b = st.breakdown()
    assert [n for n, _ in b["device_ops"]][0] == A
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    assert len(b["device_ops"]) <= devtrace.TOP
    assert len(b["idle_gaps"]) <= devtrace.TOP
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        (st.window_us - st.busy_us) / 1e6)
