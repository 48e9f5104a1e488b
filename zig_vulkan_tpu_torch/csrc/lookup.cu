// Kernel B: look int32 indices up in a few small float32 tables.
//
// Replaces the TPU kernel zig_vulkan_tpu/ops/lookup.py:_lookup_kernel
// (launched by table_lookup, called once per bounce level at
// zig_vulkan_tpu/ops/trace.py:1179). On the frame's path the tables are the
// material albedo r, g, b, mtype and type_data, 256 entries each, looked up
// by each lane's material index. The plain torch version is
// zig_vulkan_tpu_torch/ops/lookup.py:_table_lookup_plain.
//
// What bounds it on an H100: memory traffic, 4 bytes read and 4 bytes
// written per table a lane; the tables themselves are a few KiB.
//
// What the design does about it: one resident wave of blocks (the
// occupancy query times the SM count) serves a grid-stride range of
// 4-lane groups. Each block stages the tables in shared memory once, four
// tables to a float4 entry, so that looking up one lane in the frame's five
// tables is one 16-byte LDS ({r, g, b, mtype}) and one 4-byte LDS
// (type_data). A thread loads the 4 indices of its group with one 16-byte
// load and stores each table's 4 values with one 16-byte store, so every
// device-memory access is a full, coalesced 16 bytes a lane group. Where
// `idx` or a row `t * n` of the output breaks 16-byte alignment, the lanes
// before the first aligned index (the head) and after the last whole group
// (the tail) go one by one, and a row that stays misaligned is stored one
// value at a time. An index outside [0, size) yields 0, as the Pallas
// kernel's row select does.
//
// With a queue of lanes (kernel D's appends, read by the frame's bounce
// levels after the first) of at most half the lanes, the same resident
// wave strides over the queue's entries, looks up each queued lane and
// stores its values one by one; a lane outside the queue keeps what its
// outputs held, and a block whose first entry lies past the queue's end
// stages nothing. A queue of more lanes (the count is read on the card)
// takes the path above over every lane: its 16-byte loads and stores cost
// less than the queue's scattered ones (0.024 against 0.033 ms for 88% of
// 2,073,600 lanes on an H100), and what it writes for a lane outside the
// queue, the entry its stale index selects, no kernel reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// blocks per SM the launch bounds ask for: at most 64 registers a thread,
// so that no build spills
constexpr int MIN_BLOCKS = 4;

// out[0..3] = a, b, c, d: one 16-byte store where `out` is aligned (always,
// when ALIGNED)
template <bool ALIGNED>
__device__ __forceinline__ void store4(float* out, float a, float b, float c,
                                       float d) {
  if (ALIGNED || ((uintptr_t)out & 15u) == 0u) {
    *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
  } else {
    out[0] = a;
    out[1] = b;
    out[2] = c;
    out[3] = d;
  }
}

// ALIGNED: every output row is 16-byte aligned at every 4-lane group (the
// output is aligned, n % 4 == 0 and idx needs no head), so no store checks.
// QUEUED: the lanes of `queue`, `*count` of them (every lane, where that
// is more than half of them).
template <bool ALIGNED, bool QUEUED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
lookup_kernel(const float* __restrict__ tables, int n_tables, int size,
              const int32_t* __restrict__ idx, int64_t n, int64_t head,
              float* __restrict__ out, const int32_t* __restrict__ queue,
              const int32_t* __restrict__ count) {
  // quads[g * size + k] = tables 4g..4g+3 at entry k; rest[c * size + k] =
  // table 4q+c at entry k
  extern __shared__ float4 quads[];
  const int q = n_tables >> 2, r = n_tables & 3;
  float* rest = reinterpret_cast<float*>(quads + q * size);
  const int64_t queued = QUEUED ? (int64_t)*count : 0;
  const bool by_queue = QUEUED && 2 * queued <= n;
  if (by_queue && (int64_t)blockIdx.x * THREADS >= queued) return;
  const int64_t n_vec = (n - head) >> 2;  // whole 4-lane groups from head
  const int64_t tail = head + 4 * n_vec;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  // the first group's indices are in flight while the block stages
  int4 k4 = !by_queue && v < n_vec ? __ldg(idx4 + v) : make_int4(0, 0, 0, 0);

  for (int k = threadIdx.x; k < size; k += THREADS) {
    for (int g = 0; g < q; ++g) {
      const float* t = tables + 4 * g * size + k;
      quads[g * size + k] =
          make_float4(t[0], t[size], t[2 * size], t[3 * size]);
    }
    for (int c = 0; c < r; ++c)
      rest[c * size + k] = tables[(4 * q + c) * size + k];
  }
  __syncthreads();

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (by_queue) {
    for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < queued;
         j += stride) {
      const int64_t i = queue[j];
      const bool ok = (unsigned)idx[i] < (unsigned)size;
      const int k = ok ? idx[i] : 0;
      for (int g = 0; g < q; ++g) {
        const float4 a = ok ? quads[g * size + k] : zero;
        out[(4 * g) * n + i] = a.x;
        out[(4 * g + 1) * n + i] = a.y;
        out[(4 * g + 2) * n + i] = a.z;
        out[(4 * g + 3) * n + i] = a.w;
      }
      for (int c = 0; c < r; ++c)
        out[(4 * q + c) * n + i] = ok ? rest[c * size + k] : 0.0f;
    }
    return;
  }
  for (; v < n_vec; v += stride) {
    if (v != (int64_t)blockIdx.x * THREADS + threadIdx.x)
      k4 = __ldg(idx4 + v);
    // an index outside [0, size) reads entry 0 and yields 0
    const bool ok0 = (unsigned)k4.x < (unsigned)size;
    const bool ok1 = (unsigned)k4.y < (unsigned)size;
    const bool ok2 = (unsigned)k4.z < (unsigned)size;
    const bool ok3 = (unsigned)k4.w < (unsigned)size;
    const int k0 = ok0 ? k4.x : 0, k1 = ok1 ? k4.y : 0;
    const int k2 = ok2 ? k4.z : 0, k3 = ok3 ? k4.w : 0;
    float* row = out + head + 4 * v;  // table 0's values of the group
    for (int g = 0; g < q; ++g) {
      const float4* quad = quads + g * size;
      const float4 a0 = ok0 ? quad[k0] : zero, a1 = ok1 ? quad[k1] : zero;
      const float4 a2 = ok2 ? quad[k2] : zero, a3 = ok3 ? quad[k3] : zero;
      store4<ALIGNED>(row, a0.x, a1.x, a2.x, a3.x);
      store4<ALIGNED>(row + n, a0.y, a1.y, a2.y, a3.y);
      store4<ALIGNED>(row + 2 * n, a0.z, a1.z, a2.z, a3.z);
      store4<ALIGNED>(row + 3 * n, a0.w, a1.w, a2.w, a3.w);
      row += 4 * n;
    }
    for (int c = 0; c < r; ++c) {
      const float* t = rest + c * size;
      store4<ALIGNED>(row, ok0 ? t[k0] : 0.0f, ok1 ? t[k1] : 0.0f,
                      ok2 ? t[k2] : 0.0f, ok3 ? t[k3] : 0.0f);
      row += n;
    }
  }

  // the head and the tail, one lane at a time
  const int64_t singles = head + (n - tail);
  for (int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x; s < singles;
       s += stride) {
    const int64_t i = s < head ? s : tail + (s - head);
    const bool ok = (unsigned)idx[i] < (unsigned)size;
    const int k = ok ? idx[i] : 0;
    for (int g = 0; g < q; ++g) {
      const float4 a = ok ? quads[g * size + k] : zero;
      out[(4 * g) * n + i] = a.x;
      out[(4 * g + 1) * n + i] = a.y;
      out[(4 * g + 2) * n + i] = a.z;
      out[(4 * g + 3) * n + i] = a.w;
    }
    for (int c = 0; c < r; ++c)
      out[(4 * q + c) * n + i] = ok ? rest[c * size + k] : 0.0f;
  }
}

// Blocks of one resident wave with `smem` bytes of tables a block.
template <bool ALIGNED, bool QUEUED>
int wave_blocks(size_t smem) {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lookup_kernel<ALIGNED, QUEUED>, THREADS, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace

extern "C" int zvt_table_lookup(const void* tables, int n_tables, int size,
                                const void* idx, int64_t n, void* out,
                                const void* queue, const void* count,
                                void* stream) {
  if ((queue == nullptr) != (count == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t smem = (size_t)n_tables * size * sizeof(float);
    // lanes before the first 16-byte aligned index
    int64_t head = (int64_t)((16u - ((uintptr_t)idx & 15u)) & 15u) / 4;
    if (head > n) head = n;
    const bool aligned = head == 0 && n % 4 == 0 && ((uintptr_t)out & 15u) == 0;
    const bool queued = queue != nullptr;
    int64_t blocks = aligned ? (queued ? wave_blocks<true, true>(smem)
                                       : wave_blocks<true, false>(smem))
                             : (queued ? wave_blocks<false, true>(smem)
                                       : wave_blocks<false, false>(smem));
    if (blocks <= 0) {
      const int status = (int)cudaGetLastError();
      return status != 0 ? status : (int)cudaErrorInvalidConfiguration;
    }
    // groups, plus at most 6 singles; a queue's entries, up to n / 2
    int64_t work = (n - head) / 4 + 6;
    if (queued && n / 2 + 1 > work) work = n / 2 + 1;
    const int64_t need = (work + THREADS - 1) / THREADS;
    if (blocks > need) blocks = need;
    const float* t = (const float*)tables;
    const int32_t* k = (const int32_t*)idx;
    const int32_t *q = (const int32_t*)queue, *c = (const int32_t*)count;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned g = (unsigned)blocks;
    if (aligned && queued)
      lookup_kernel<true, true><<<g, THREADS, smem, s>>>(t, n_tables, size, k,
                                                         n, head, o, q, c);
    else if (aligned)
      lookup_kernel<true, false><<<g, THREADS, smem, s>>>(t, n_tables, size,
                                                          k, n, head, o, q, c);
    else if (queued)
      lookup_kernel<false, true><<<g, THREADS, smem, s>>>(t, n_tables, size,
                                                          k, n, head, o, q, c);
    else
      lookup_kernel<false, false><<<g, THREADS, smem, s>>>(
          t, n_tables, size, k, n, head, o, q, c);
  }
  return (int)cudaGetLastError();
}
