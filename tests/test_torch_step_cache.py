"""The compiled-step cache of zig_vulkan_tpu_torch's engine against the JAX
engine's jit cache.

The JAX engine compiles a step once a key (`_build_step`, kept in
`_step_cache`, which nothing clears) and an edit program once a padded
batch size; scene arrays, records and materials are arguments, so a
`flush_grid`, a records rebuild or a return to an earlier key compiles
nothing. The port keeps a step (on a card, a captured graph) for every key
and an `EditStep` for every padded size, and writes a flush and a records
rebuild into the tensors its graphs read.

Both engines go through the same key tour (`engine.key_tour`). The JAX
engine is not rendered (its XLA compiles cost tens of seconds): its device
work is replaced by stand-ins, so `render()` runs only its host logic, the
key, the cache and the temporal accumulator's reset rule. With
`use_pallas=True` its key carries `sun_in_kernel`, as on a TPU. Every
port frame is held bit for bit against a fresh engine with the same scene
and state. The replays themselves are tested on the card
(`tests/test_torch_kernels.py`).
"""

import copy
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from tests.test_torch_step import _parity_scene
from zig_vulkan_tpu.engine import controls as rcontrols
from zig_vulkan_tpu.engine.engine import VoxelRT as RefVoxelRT
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.engine import controls as tcontrols
from zig_vulkan_tpu_torch.engine import engine as tengine
from zig_vulkan_tpu_torch.engine import key_tour
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

# the edits stay in the lower half of the 32^3-voxel scene: its one
# non-empty region of two, so neither engine's scene degrades (the JAX key
# holds the degraded flag; the port's does not)
BOX = ((0, 0, 0), (32, 16, 32))


def _config(m, **trace):
    return m.EngineConfig(
        internal_resolution_width=32, internal_resolution_height=24,
        output_resolution_width=40, output_resolution_height=30,
        camera=m.CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=2,
                              max_bounce=2),
        sun=m.SunConfig(enabled=True, animate=False),
        trace=m.TraceConfig(**trace))


def _edited_grid(scenes):
    """The parity scene with a slab of material 3 at y = 10: a same-geometry
    grid to flush in."""
    sc = _parity_scene(scenes)
    xs, zs = np.meshgrid(np.arange(0, 12), np.arange(0, 12), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 10), zs.ravel(),
                         np.full(xs.size, 3, dtype=np.uint8))
    return sc.grid


def _jax_engine():
    """The JAX engine on its Pallas path's key, with stand-ins for its
    device work: `built` lists the keys it compiles a step for."""
    sc = _parity_scene(rscenes)
    ref = RefVoxelRT(sc.grid, sc.materials,
                     _config(rconfig, use_pallas=True))
    built = []

    def build_step(key):
        built.append(key)

        def step(arrays, tables, blocks, mats, pc, accum=None):
            # the accumulator counts the frames since its last reset
            return (None, accum + 1.0) if accum is not None else None
        return step

    dummy = jnp.zeros((1,))
    ref._build_step = build_step
    ref._dist_fn = lambda *a: dummy
    ref._tables_fn = lambda *a: dummy
    ref._blocks_fn = lambda *a: dummy
    ref._edit_step = ref._remove_step = lambda st, arrays, *a: arrays
    ref._refresh_insert_fn = lambda st, arrays, tables, *a: (tables, dummy)
    ref._refresh_remove_fn = lambda st, arrays, tables, *a: tables
    ref._refresh_blocks_fn = lambda st, blocks, *a: blocks
    return ref, built


def _port_engine(monkeypatch):
    """The port's engine, counting its `_build_step` calls and the
    `EditStep`s it makes (`built`, `edit_steps`)."""
    sc = _parity_scene(tscenes)
    rt = VoxelRT(sc.grid, sc.materials, _config(tconfig), device="cpu")
    built, edit_steps = [], []
    build = rt._build_step

    def counted(key):
        built.append(key)
        return build(key)

    class CountedEditStep(tengine.EditStep):
        def __init__(self, size, *args):
            edit_steps.append(size)
            super().__init__(size, *args)

    rt._build_step = counted
    monkeypatch.setattr(tengine, "EditStep", CountedEditStep)
    return rt, built, edit_steps


def _host_grid(rt):
    """`rt`'s scene read back from its tensors as a host grid."""
    fields = {}
    for f in dataclasses.fields(rt.arrays):
        a = getattr(rt.arrays, f.name).cpu().numpy()
        fields[f.name] = (a.view(np.uint32) if f.name in GridArrays._U32_FIELDS
                          else a)
    return types.SimpleNamespace(static=rt.grid_static,
                                 arrays=GridArrays(**fields))


def _fresh(rt):
    """A new engine on `rt`'s scene with its settings, pose and temporal
    state (taken before `rt`'s next frame)."""
    fresh = VoxelRT(_host_grid(rt), rt.materials_host, rt.config,
                    device="cpu")
    fresh.camera = copy.deepcopy(rt.camera)
    fresh.sun = copy.deepcopy(rt.sun)
    fresh.denoiser = rt.denoiser
    fresh.trace_config = rt.trace_config
    fresh.set_temporal(rt.temporal_enabled)
    if rt._accum is not None:
        fresh._accum = rt._accum.clone()
        fresh._accum_count, fresh._pose_key = rt._accum_count, rt._pose_key
    return fresh


def _flush(grids):
    return lambda rt: rt.flush_grid(grids[isinstance(rt, VoxelRT)])


def test_tour_builds_one_step_a_jax_key_and_one_edit_step_a_size(
        monkeypatch):
    """Two rounds of the key tour: the port builds one step for each key
    the JAX engine compiles and one EditStep for each padded size, all in
    the first round; the flush, the records rebuilds and the flip of
    empty_skip and back build none. Every frame equals a fresh engine's bit
    for bit, and the temporal count follows the JAX accumulator's."""
    ref, ref_built = _jax_engine()
    port, built, edit_steps = _port_engine(monkeypatch)
    grids = (_edited_grid(rscenes), _edited_grid(tscenes))
    uis = (rcontrols.ControlPanel(ref), tcontrols.ControlPanel(port))
    ref.render()
    port.render()
    for rnd in range(2):
        tours = [key_tour.key_tour(rt, _flush(grids), BOX, seed=rnd)
                 for rt in (ref, port)]
        builds = len(built)
        for (label, ref_move), (_, move) in zip(*tours):
            made = len(built)
            ref_move(ref, uis[0])
            move(port, uis[1])
            fresh = _fresh(port)
            ref.render()
            got = port.render()
            assert torch.equal(got, fresh.render()), (rnd, label)
            assert port._accum_count == ref._accum_count, (rnd, label)
            if ref._accum is not None:
                assert float(ref._accum[0, 0, 0]) == ref._accum_count
            if label in ("flush_grid", "empty_skip back"):
                assert len(built) == made, label
        assert set(built) == set(port._step_cache)
        if rnd == 1:
            assert len(built) == builds
    assert len(built) == len(set(built)) == len(ref_built) == len(
        set(ref_built))
    assert sorted(edit_steps) == sorted(port._edit_cache) == [
        1024 << k for k in range(6)]


@pytest.mark.parametrize("move", ["spp", "pixel_multiplier"])
def test_temporal_return_to_a_key_carries_or_resets_as_jax(move):
    """Temporal frames over two keys and back: at the same pose the mean
    goes on into the kept step (its accumulator takes the running mean),
    after a camera move it starts again, in step with the JAX engine's one
    accumulator; the frames equal a fresh engine's bit for bit."""
    ref, _ = _jax_engine()
    sc = _parity_scene(tscenes)
    port = VoxelRT(sc.grid, sc.materials, _config(tconfig), device="cpu")
    panels = {ref: rcontrols.ControlPanel(ref),
              port: tcontrols.ControlPanel(port)}
    knob = {"spp": (lambda rt, v: panels[rt].set_samples_per_pixel(v), 3, 2),
            "pixel_multiplier": (lambda rt, v: panels[rt].set_denoiser(
                pixel_multiplier=v), 2.0, 1.5)}[move]
    set_knob, other, start = knob
    steps = [lambda rt: rt.set_temporal(True), lambda rt: None,
             lambda rt: set_knob(rt, other), lambda rt: None,
             lambda rt: set_knob(rt, start), lambda rt: None,
             lambda rt: rt.camera.translate(0.3, [0.0, 0.0, -1.0]),
             lambda rt: set_knob(rt, other), lambda rt: set_knob(rt, start)]
    counts = []
    for step in steps:
        step(ref)
        step(port)
        fresh = _fresh(port)
        ref.render()
        assert torch.equal(port.render(), fresh.render())
        assert port._accum is port.step().accum
        counts.append(port._accum_count)
        assert port._accum_count == ref._accum_count
    assert counts == [1, 2, 3, 4, 5, 6, 1, 2, 3]
    assert len(port._step_cache) == 2


def test_flush_grid_writes_the_scene_tensors_in_place():
    """A flush copies the new grid into the tensors the graphs read and
    raises ValueError, touching nothing, where a field's shape or the
    geometry differs."""
    sc = _parity_scene(tscenes)
    rt = VoxelRT(sc.grid, sc.materials, _config(tconfig), device="cpu")
    rt.render()
    tensors = {f.name: getattr(rt.arrays, f.name)
               for f in dataclasses.fields(rt.arrays)}
    records = (rt._tables, rt._dist)
    edited = _edited_grid(tscenes)
    rt.flush_grid(edited)
    for name, t in tensors.items():
        assert getattr(rt.arrays, name) is t, name
    want = edited.arrays.to_device("cpu")
    assert torch.equal(rt.arrays.occupancy, want.occupancy)
    assert rt.tables() is records[0] and rt._dist is records[1]
    bad = _edited_grid(tscenes)
    bad.arrays = dataclasses.replace(bad.arrays,
                                     brick_ir=bad.arrays.brick_ir[:-1])
    before = rt.arrays.brick_ir.clone()
    with pytest.raises(ValueError, match="brick_ir"):
        rt.flush_grid(bad)
    assert torch.equal(rt.arrays.brick_ir.view(torch.int32),
                       before.view(torch.int32))
    with pytest.raises(ValueError, match="geometry"):
        rt.flush_grid(tscenes.flat_test_scene(dim=4).grid)


def test_empty_skip_flip_keeps_the_records_and_the_edit_graphs():
    """empty_skip flipped, edits, flipped back, as the JAX engine: each
    flip keeps the records and the field bit for bit, the flipped edits
    replay the unflipped edit graphs (an insert refreshes the conservative
    field whatever empty_skip is), and after the flip back the field is the
    conservative one of the edited grid (on this scene, 8 cells tall, it
    equals the exact one: tests/test_torch_engine_session.py holds the
    session against the JAX engine on a scene where they differ)."""
    sc = _parity_scene(tscenes)
    rt = VoxelRT(sc.grid, sc.materials, _config(tconfig), device="cpu")
    rt.render()
    tables, dist = rt._tables, rt._dist
    rng = np.random.default_rng(4)
    xyz, mats = key_tour.edit_batch(rng, 700, BOX)
    rt.insert_voxels(xyz[:100], mats[:100])
    rt.remove_voxels(xyz[:30])
    graphs = dict(rt._edit_cache[1024].graphs)
    assert set(graphs) == {("insert", True), ("remove", True)}
    for skip in (False, True):
        before = (tables.clone(), dist.clone())
        rt.trace_config = dataclasses.replace(rt.trace_config,
                                              empty_skip=skip)
        rt.render()
        assert rt._tables is tables and rt._dist is dist
        assert torch.equal(tables, before[0]) and torch.equal(dist, before[1])
        if not skip:
            rt.insert_voxels(xyz, mats)
            rt.remove_voxels(xyz[::3])
    assert rt._edit_cache[1024].graphs == graphs
    assert torch.equal(dist, ttrace.distance_field(rt.grid_static, rt.arrays))
    assert len(rt._step_cache) == 2
