"""Material-table lookup of zig_vulkan_tpu_torch against the JAX package's.

`ops.lookup.table_lookup` runs its plain torch version for CPU tensors and
kernel B (csrc/lookup.cu) for CUDA tensors. It must return what the
reference's Pallas `table_lookup` returns (run here with interpret=True,
as tests/test_lookup.py runs it): exactly the table values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zig_vulkan_tpu.core.materials import terrain_materials
from zig_vulkan_tpu.ops import lookup as rlookup
from zig_vulkan_tpu_torch.ops import lookup as tlookup
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)


def _reference(tables, idx):
    out = rlookup.table_lookup(tuple(jnp.asarray(t) for t in tables),
                               jnp.asarray(idx), interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n_tables,size,n", [
    (1, 256, 3000), (2, 512, 1537), (5, 256, 4099)])
def test_plain_matches_reference(n_tables, size, n):
    rng = np.random.default_rng(n)
    tables = rng.standard_normal((n_tables, size)).astype(np.float32)
    idx = rng.integers(0, size, n).astype(np.int32)
    got = tlookup.table_lookup(torch.from_numpy(tables), torch.from_numpy(idx))
    assert len(got) == n_tables
    for g, w in zip(got, _reference(tables, idx)):
        assert g.dtype == torch.float32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), w)


def test_out_of_range_reads_zero_like_reference():
    tables = np.random.default_rng(2).random((2, 256)).astype(np.float32) + 1
    idx = np.array([-300, -1, 0, 255, 256, 1000], np.int32)
    got = tlookup.table_lookup(torch.from_numpy(tables), torch.from_numpy(idx))
    want = _reference(tables, idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[0].numpy()[[0, 1, 4, 5]], 0.0)


def test_material_tables_as_the_frame_reads_them():
    """The five 256-entry tables of the bounce loop, looked up by every
    material byte value."""
    mats = terrain_materials()
    dev = ttrace.materials_to_device(mats, "cpu")
    assert tuple(dev.shape) == (5, 256) and dev.dtype == torch.float32
    assert dev.is_contiguous()
    ref_tables = (mats.albedo[:, 0], mats.albedo[:, 1], mats.albedo[:, 2],
                  mats.mtype.astype(np.float32), mats.type_data)
    idx = np.random.default_rng(4).integers(0, 256, 5000).astype(np.int32)
    got = tlookup.table_lookup(dev, torch.from_numpy(idx))
    for g, w in zip(got, _reference(ref_tables, idx)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cpu_wrapper_does_not_count_launches():
    before = tlookup.table_lookup.launches
    tlookup.table_lookup(torch.zeros(5, 256), torch.zeros(7, dtype=torch.int32))
    assert tlookup.table_lookup.launches == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="tables must be"):
        tlookup.table_lookup(torch.zeros(256), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tlookup.table_lookup(torch.zeros(5, 256, device="meta"),
                             torch.zeros(3, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("kernel B runs only on a CUDA device")
    rng = np.random.default_rng(9)
    tables = torch.from_numpy(rng.random((5, 256)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-8, 264, 1 << 20).astype(np.int32))
    want = tlookup.table_lookup(tables, idx)
    before = tlookup.table_lookup.launches
    got = tlookup.table_lookup(tables.cuda(), idx.cuda())
    torch.cuda.synchronize()
    assert tlookup.table_lookup.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
