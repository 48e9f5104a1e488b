"""Scene tables of zig_vulkan_tpu_torch against the JAX package's.

`build_trace_tables` (the per-cell int32[cells, 8] traversal records) and
`distance_field` (the Chebyshev skip field, exact and conservative builds)
are integer computations: the port must reproduce them bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)


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


def _sparse_scene(scenes):
    """A few isolated voxels in a larger grid: distances up to the cap."""
    sc = scenes.flat_test_scene(dim=8)
    grid = type(sc.grid)(40, 12, 36)
    grid.attach_materials(sc.materials)
    grid.insert_batch(np.array([3, 150, 90]), np.array([5, 40, 2]),
                      np.array([7, 100, 141]),
                      np.array([1, 0, 5], dtype=np.uint8))
    sc.grid = grid
    return sc


_SCENES = {
    "parity": _parity_scene,
    "default_16x8x16": lambda m: m.default_scene(dims=(16, 8, 16)),
    "sparse": _sparse_scene,
}


@pytest.fixture(scope="module", params=sorted(_SCENES))
def scenes(request):
    build = _SCENES[request.param]
    ref, port = build(rscenes), build(tscenes)
    return ref, port


@pytest.mark.parametrize("exact", [False, True], ids=["conservative", "exact"])
def test_distance_field_bit_exact(scenes, exact):
    ref, port = scenes
    st = ref.grid.static
    want = np.asarray(rtrace.distance_field(st, ref.grid.device_arrays(),
                                            exact=exact))
    got = ttrace.distance_field(st, port.grid.arrays.to_device("cpu"),
                                exact=exact)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("exact", [False, True], ids=["conservative", "exact"])
def test_trace_tables_bit_exact(scenes, exact):
    ref, port = scenes
    st = ref.grid.static
    ra = ref.grid.device_arrays()
    rdist = rtrace.distance_field(st, ra, exact=exact)
    want = np.asarray(rtrace.build_trace_tables(st, ra, rdist))
    ta = port.grid.arrays.to_device("cpu")
    got = ttrace.build_trace_tables(st, ta,
                                    ttrace.distance_field(st, ta, exact=exact))
    assert got.dtype == torch.int32 and tuple(got.shape) == (st.cells, 8)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_tables_default_field_is_conservative(scenes):
    ref, port = scenes
    st = ref.grid.static
    want = np.asarray(rtrace.build_trace_tables(st, ref.grid.device_arrays()))
    got = ttrace.build_trace_tables(st, port.grid.arrays.to_device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tables_from_reference_built_arrays():
    """The converter takes the JAX package's arrays; the records equal the
    reference's, including the -1 sentinel and NaN-ir bit patterns."""
    ref = _parity_scene(rscenes)
    # a brick mixing two dielectric ir values has brick_ir NaN
    ref.materials.set(9, 2, (0.5, 0.5, 0.5), 1.5)
    ref.grid.attach_materials(ref.materials)
    ref.grid.insert_batch(np.array([0, 1]), np.array([6, 6]),
                          np.array([0, 0]), np.array([0, 9], np.uint8))
    st = ref.grid.static
    want = np.asarray(rtrace.build_trace_tables(st, ref.grid.device_arrays()))
    got = ttrace.build_trace_tables(
        st, GridArrays.to_device(ref.grid.arrays, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == -1).any() and (got[:, 0] >= 0).any()
    ir = got[:, 6].copy().view(np.float32)
    assert np.isnan(ir).any() and (ir == np.float32(1.333)).any()
