"""The reference (`rtbench.ref`) against the port's CPU path, layer by
layer, at a size the CPU runs: the scene and its file, the records and the
skip field, the edits, the camera rays, the traversal, the material lookup,
the shading, the resolve, the post-process and whole frames."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import scene, spec, traffic
from rtbench.ref.core.grid import dense_materials
from rtbench.ref.engine import RefEngine
from rtbench.ref.ops import denoise as r_denoise
from rtbench.ref.ops import lookup as r_lookup
from rtbench.ref.ops import shade as r_shade
from rtbench.ref.ops import tile_tracer as r_tile
from rtbench.run import Program, engine_config
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.config import DenoiserConfig
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io import scene_io as p_scene_io
from zig_vulkan_tpu_torch.models import scenes as p_scenes
from zig_vulkan_tpu_torch.ops import denoise as p_denoise
from zig_vulkan_tpu_torch.ops import lookup as p_lookup
from zig_vulkan_tpu_torch.ops import shade as p_shade
from zig_vulkan_tpu_torch.ops import tile_tracer as p_tile

CPU = torch.device("cpu")


def _fields(arrays):
    return {f.name: np.asarray(getattr(arrays, f.name))
            for f in dataclasses.fields(arrays)}


def _same_arrays(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def cell():
    return small_cell("edit_brush_1080p")


@pytest.fixture(scope="module")
def scene_file(cell, tmp_path_factory):
    from rtbench.ref.io import scene_io

    grid, materials = scene.build(cell.config["scene"])
    path = tmp_path_factory.mktemp("scene") / "scene.npz"
    scene_io.save_scene(str(path), grid.static, grid.arrays, materials)
    return path


def test_scene_generator_is_the_ports(cell):
    """The generator `default_scene` against the port's, at the small
    size and the configuration's own placement."""
    full = spec.cell(spec.load(), cell.name).config["scene"]
    grid, materials = scene.build(dict(cell.config["scene"],
                                       min_point=full["min_point"]))
    want = p_scenes.default_scene(dims=tuple(cell.config["scene"]
                                             ["grid_dims"]))
    assert (dataclasses.astuple(grid.static)
            == dataclasses.astuple(want.grid.static))
    _same_arrays(grid.arrays, want.grid.arrays)
    for k in ("mtype", "albedo", "type_data"):
        np.testing.assert_array_equal(getattr(materials, k),
                                      getattr(want.materials, k))


def test_scene_file_reads_alike(scene_file):
    rg, _ = scene.load_reference(scene_file)
    pg, _ = p_scene_io.load_scene(str(scene_file))
    _same_arrays(rg.arrays, pg.arrays)


@pytest.fixture(scope="module")
def both(cell, scene_file):
    """(reference engine, port engine) on the same scene file, CPU."""
    rg, rm = scene.load_reference(scene_file)
    pg, pm = p_scene_io.load_scene(str(scene_file))
    ref = RefEngine(rg, rm, cell.config["engine"], CPU)
    rt = VoxelRT(pg, pm, engine_config(cell.config["engine"]), device=CPU)
    return ref, rt


def test_records_and_skip_field(both):
    ref, rt = both
    _, field, records = ref.scene()
    assert torch.equal(records, rt.tables())
    assert torch.equal(field, rt._dist)


def test_edits_records_and_frames_follow_the_port(cell, scene_file):
    """A cycle and a half of batches through both sides: the program's
    incremental records and field after every batch against the
    reference's, worked out from its own scene from scratch (the field of
    every cell, which cells are empty, every other lane of a loaded cell;
    an empty cell's other lanes are not read), the scenes decoded, and the
    frame of every other batch, bit for bit."""
    rg, rm = scene.load_reference(scene_file)
    pg, pm = p_scene_io.load_scene(str(scene_file))
    ref = RefEngine(rg, rm, cell.config["engine"], CPU)
    rt = VoxelRT(pg, pm, engine_config(cell.config["engine"]), device=CPU)
    program = Program(rt)
    tables = traffic.build(cell.traffic, cell.config["engine"], 11,
                           rg.static, rg.arrays)
    program.pose(tables.frame(0))
    rt.draw()
    for g in range(tables.scene_period + tables.scene_period // 2):
        fr = tables.frame(g)
        img = program.step(fr)
        ref.advance(fr)
        arrays, field, records = ref.scene()
        assert torch.equal(dense_materials(ref.static, arrays),
                           dense_materials(ref.static, rt.arrays))
        assert torch.equal(field, rt._dist)
        # lane 0, a material window's start, depends on the order in which
        # each side allocated the windows: only where it is empty counts
        loaded = records[:, 0] != -1
        assert torch.equal(loaded, rt._tables[:, 0] != -1)
        assert torch.equal(records[:, 3], rt._tables[:, 3])
        assert torch.equal(records[loaded, 1:], rt._tables[loaded, 1:])
        if g % 2 == 0:
            assert torch.equal(img, ref.image(fr))


def _camera(cell, both):
    ref, rt = both
    fr = traffic.build(small_cell("fly_1080p").traffic, cell.config["engine"],
                       3).frame(1)
    return ref.basis(fr.origin, fr.yaw), fr


def test_camera_rays(cell, both):
    cam, _ = _camera(cell, both)
    kw = dict(width=64, height=36, spp=2, sample_base=3.0,
              sun=(np.array([1.0, -900.0, 5.0], np.float32),
                   np.float32(5.0)))
    want = r_shade.camera_rays(cam, **kw)
    got = p_shade.camera_rays(cam, **kw)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("use_skip", [True, False])
@pytest.mark.parametrize("shadow", [False, True])
def test_traversal(cell, both, use_skip, shadow):
    ref, rt = both
    cam, fr = _camera(cell, both)
    rays = r_shade.camera_rays(cam, 64, 36, 1,
                               sun=(fr.sun_position, np.float32(5.0)))
    args = (ref.static, ref.scene()[2], ref.scene()[0].material_indices,
            *(rays[k] for k in r_shade.RAY_KEYS),
            torch.ones(64 * 36, dtype=torch.bool))
    kw = dict(max_steps=160, use_skip=use_skip, stats=True,
              shadow_targets=(tuple(rays[k] for k in r_shade.TARGET_KEYS)
                              if shadow else None))
    want = r_tile.grid_hit_tiles(*args, **kw)
    got = p_tile.grid_hit_tiles(*args, **kw)
    assert int(want["found"].sum()) > 0
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_lookup(both):
    ref, _ = both
    idx = torch.randint(-4, 260, (4096,), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    for w, g in zip(r_lookup.table_lookup(ref.mats, idx),
                    p_lookup.table_lookup(ref.mats, idx)):
        assert torch.equal(w, g)


@pytest.mark.parametrize("mode", [r_shade.SUN_OFF, r_shade.SUN_DEFERRED,
                                  r_shade.SUN_PROBE])
def test_shading_and_resolve(cell, both, mode):
    """Two levels of shading from the same hits, then the resolve."""
    ref, _ = both
    cam, fr = _camera(cell, both)
    sun = (fr.sun_position, fr.sun_color, np.float32(5.0))
    probe = mode == r_shade.SUN_PROBE
    states = []
    for shade_mod in (r_shade, p_shade):
        rays = r_shade.camera_rays(cam, 64, 36, 2,
                                   sun=(sun[0], sun[2]) if probe else None)
        state = r_shade.new_state(rays, mode)
        targets = (tuple(rays[k] for k in r_shade.TARGET_KEYS) if probe
                   else None)
        occluded = key = None
        for level in range(2):
            h = r_tile.grid_hit_tiles(
                ref.static, ref.scene()[2], ref.scene()[0].material_indices,
                *(state[k] for k in r_shade.RAY_KEYS), state["bouncing"],
                ray_key=key, max_steps=160, shadow_targets=targets)
            looked = r_lookup.table_lookup(ref.mats, h["index"])
            out = shade_mod.shade(state, h, looked, mode, *sun,
                                  prev_occluded=occluded,
                                  next_key=level == 0,
                                  next_targets=probe and level == 0)
            key = out.get("key")
            targets = (tuple(out[k] for k in r_shade.TARGET_KEYS)
                       if "tx" in out else None)
            if mode == r_shade.SUN_DEFERRED:
                occluded = r_tile.grid_hit_tiles(
                    ref.static, ref.scene()[2], ref.scene()[0].material_indices,
                    h["px"], h["py"], h["pz"],
                    *(out[k] for k in r_shade.SHADOW_KEYS), out["active"],
                    max_steps=160)["found"]
        color = shade_mod.resolve(state, 2, sun[1] if mode else None,
                                  occluded)
        states.append((state, color))
    (ws, wc), (gs, gc) = states
    for k in ws:
        assert torch.equal(ws[k], gs[k]), k
    assert torch.equal(wc, gc)


@pytest.mark.parametrize("out_size", [(36, 64), (45, 80)])
def test_postprocess(out_size):
    """The reference's static sirBird against the port's runtime path (the
    engine's: the knobs as 0-d tensors, 33 taps) and its static one."""
    g = torch.Generator().manual_seed(5)
    img = torch.rand(36, 64, 3, generator=g)
    dn = DenoiserConfig()
    want = r_denoise.postprocess(img, dn, *out_size)
    static = p_denoise.postprocess(img, dn, *out_size)
    runtime = p_denoise.postprocess(img, DenoiserConfig(
        samples=torch.tensor(20.0), distribution_bias=torch.tensor(0.6),
        inverse_hue_tolerance=torch.tensor(20.0)), *out_size,
        max_samples=p_denoise.MAX_RUNTIME_SAMPLES)
    assert torch.equal(want, static)
    assert float((want - runtime).abs().max()) <= 1e-6


def test_frame_of_the_default_settings(scene_file):
    """A frame of the default configuration's settings (2 spp, three
    levels, the denoiser) through the port's engine and the reference."""
    cell = small_cell("default_flythrough")
    e = cell.config["engine"]
    rg, rm = scene.load_reference(scene_file)
    pg, pm = p_scene_io.load_scene(str(scene_file))
    ref = RefEngine(rg, rm, e, CPU)
    program = Program(VoxelRT(pg, pm, engine_config(e), device=CPU))
    tables = traffic.build(cell.traffic, e, 9)
    for g in (0, 4):
        fr = tables.frame(g)
        img = program.step(fr)
        want = ref.image(fr)
        assert float((img - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("name", ["default_flythrough", "fly_1080p"])
def test_engine_entry_is_passed_whole(name):
    """Every key of a configuration's "engine" entry reaches the port: a
    field of EngineConfig (a group through its dataclass) by value, any
    other key through the engine's setter of that name."""
    import dataclasses as dc

    from rtbench.run import engine_setters

    e = spec.cell(spec.load(), name).config["engine"]
    conf = engine_config(e)
    for k, v in e.items():
        if not hasattr(conf, k):
            continue
        got = getattr(conf, k)
        if isinstance(v, dict):
            for kk, vv in v.items():
                want = tuple(vv) if isinstance(vv, list) else vv
                assert getattr(got, kk) == want, (k, kk)
        else:
            assert got == v, k
    assert {f.name for f in dc.fields(conf)} >= set(e) - {"temporal"}

    class Engine:
        made = []

        def set_temporal(self, on):
            self.made.append(("temporal", on))

    rt = Engine()
    engine_setters(rt, dict(e, temporal=True))
    assert rt.made == [("temporal", True)]
    with pytest.raises(AttributeError):
        engine_setters(rt, dict(e, no_such_setting=1))
