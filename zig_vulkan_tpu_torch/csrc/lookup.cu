// Kernel B: look int32 indices up in a few small float32 tables.
//
// Replaces the TPU kernel zig_vulkan_tpu/ops/lookup.py:_lookup_kernel
// (launched by table_lookup, called once per bounce level at
// zig_vulkan_tpu/ops/trace.py:1179). On the frame's path the tables are the
// material albedo r, g, b, mtype and type_data, 256 entries each, looked up
// by each lane's material index. The plain torch version is
// zig_vulkan_tpu_torch/ops/lookup.py:_table_lookup_plain.
//
// What bounds it on an H100: memory traffic, 4 bytes read and 20 bytes
// written per lane; the tables themselves are 5 KiB.
//
// What the design does about it: each block stages the tables in shared
// memory once and serves a grid-stride range of indices from there, so the
// only device-memory traffic is the index stream in and the value streams
// out, both coalesced. An index outside [0, size) yields 0, as the Pallas
// kernel's row select does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
lookup_kernel(const float* __restrict__ tables, int n_tables, int size,
              const int32_t* __restrict__ idx, int64_t n,
              float* __restrict__ out) {
  extern __shared__ float staged[];
  for (int j = threadIdx.x; j < n_tables * size; j += blockDim.x)
    staged[j] = tables[j];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int k = idx[i];
    const bool ok = k >= 0 && k < size;
    for (int t = 0; t < n_tables; ++t)
      out[t * n + i] = ok ? staged[t * size + k] : 0.0f;
  }
}

}  // namespace

extern "C" int zvt_table_lookup(const void* tables, int n_tables, int size,
                                const void* idx, int64_t n, void* out,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 8) blocks = 132 * 8;  // 8 resident blocks per SM
    const size_t smem = (size_t)n_tables * size * sizeof(float);
    lookup_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const float*)tables, n_tables, size, (const int32_t*)idx, n,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
