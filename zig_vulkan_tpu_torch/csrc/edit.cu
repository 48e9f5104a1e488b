// The voxel edits: an insert, a removal and the insert's skip field, each a
// few launches over the engine's edit buffer.
//
// Replaces no Pallas kernel. The JAX package compiles its edits into XLA
// programs: zig_vulkan_tpu/core/grid.py:393-591 (apply_edits, remove_edits)
// and zig_vulkan_tpu/ops/trace.py:193-385 (the conservative distance field,
// its write into lane 3 of the records, the rows of the touched cells). The
// port's plain versions, the ATen chains these kernels take the place of on
// a card, are zig_vulkan_tpu_torch/core/grid.py:apply_edits, remove_edits
// and ops/trace.py:_distance_field, refresh_tables_after_insert,
// _refresh_rows; the wrappers are ops/edit.py.
//
// What bounds it on an H100: bytes, and little of them. A brush stroke of
// 1,024 lanes reads 16 KB of lanes and changes a few hundred bytes of
// bricks; the insert's field reads the 128 KB status bitmap of a 1M-cell
// grid and writes the 4 MB field and lane 3 of the 32 MB records: about
// 3-5 us at 3.35 TB/s. As ~300 ATen kernels an insert (~100 a removal) the
// edit ran at well under 1% of that: each dependent launch costs a few us.
//
// What the design does about it: it works against launch latency.
//
// - The insert's lane work is one block (INSERT_THREADS threads), its phases
//   separated by __syncthreads, so nothing waits on a launch: cells marked
//   in a touched and a fresh (unloaded) bitmap; a scan of the bitmaps gives
//   each fresh cell its rank in cell order (new brick ids and material
//   windows follow it, from the device-side counters) and each touched cell
//   a slot; a per-slot table of each voxel's last lane picks the lane whose
//   material and dielectric bit a voxel takes; occupancy and dielectric bits
//   go in with atomic OR / AND, which is order-free, and a brick's ir is a
//   min and max over its lanes. No sort: every rank comes from the bitmaps.
//   The bitmaps are not cleared whole: a summary bitmap (one bit a word,
//   4 KB for 1M cells) is, and each lane clears the two words of its cell,
//   so only marked words are ever read.
// - The field is three launches, one per axis (x, then z, then y, as
//   ops/trace.py:_distance_field), each block loading whole lines into
//   shared memory and evaluating the exact +-3 minima and the four windowed
//   minima with their floors: integer arithmetic, exact. The last pass
//   writes the field and lane 3 together where a cell's distance changed
//   (lane 3 holds the cached field, so the 1M scattered 4-byte stores of a
//   whole rewrite become the few of the cells the batch moved), and the
//   whole row of each touched cell, which is the insert's row refresh.
// - The removal is one block: atomic AND-NOT on occupancy and dielectric
//   words, a barrier, then the touched rows.
//
// The edit buffer (engine/step.py:EditStep) is int32[4 * size + 1]: voxel
// coordinates [size, 3], materials [size], the count of live lanes. Lanes
// at and past the count are padding and write nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BRICK_BITS = 64;
constexpr int BRICK_WORDS = 2;
constexpr int DIST_CAP = 31;
constexpr int INSERT_THREADS = 1024;
constexpr int REMOVE_THREADS = 1024;
constexpr int FIELD_THREADS = 512;
constexpr int FIELD_PER_THREAD = 8;
constexpr int FIELD_TILE = FIELD_THREADS * FIELD_PER_THREAD;  // cells a block

}  // namespace

// Mirror of `EditArgs` in zig_vulkan_tpu_torch/_build.py.
struct EditArgs {
  int32_t* statuses;
  int32_t* indices;
  int32_t* occupancy;
  int32_t* start_indices;
  uint8_t* material_indices;
  int32_t* active_bricks;
  int32_t* material_cursor;
  int32_t* diel_mask;
  float* brick_ir;
  const uint8_t* mat_is_diel;  // bool[256], NULL: no voxel is dielectric
  const float* mat_ir;         // f32[256], NULL with mat_is_diel
  const int32_t* buf;          // the edit buffer
  int32_t* tables;             // int32[cells, 8], NULL: records not current
  int32_t* dist;               // int32[cells], with tables
  uint32_t* scratch;           // scratch_words(cells, size) words
  int64_t size;                // lanes
  int64_t material_bytes;      // material_indices' length
  int dims[3];                 // cells along x, y, z
  int cells;
  int brick_alloc;
};

namespace {

// The scratch of an insert, carved from `scratch` in this order; its length
// in words is ops/edit.py:scratch_words.
struct Scratch {
  uint32_t* summary;     // [ceil(words / 32)]: bit w: word w was marked
  uint32_t* touched;     // [words]: cells of live lanes
  uint32_t* fresh;       // [words]: those not loaded before the batch
  uint32_t* word_slot;   // [words]: slots of the touched cells before word w
  uint32_t* vox_last;    // [size * 64]: per slot and voxel, last lane + 1
  uint32_t* ir_lo;       // [size]: per slot, ~(least ordered ir key)
  uint32_t* ir_hi;       // [size]: per slot, greatest ordered ir key
  int32_t* slot_brick;   // [size]
  int32_t* lane_slot;    // [size]
  int32_t* lane_brick;   // [size]
  uint8_t* field;        // [cells]: the field between its passes
};

__host__ __device__ inline int64_t status_words(int cells) {
  return ((int64_t)cells + 31) / 32;
}

__host__ __device__ inline int64_t summary_words(int cells) {
  return (status_words(cells) + 31) / 32;
}

__host__ __device__ inline Scratch carve(const EditArgs& a) {
  const int64_t w = status_words(a.cells), s = a.size;
  Scratch c;
  c.summary = a.scratch;
  c.touched = c.summary + summary_words(a.cells);
  c.fresh = c.touched + w;
  c.word_slot = c.fresh + w;
  c.vox_last = c.word_slot + w;
  c.ir_lo = c.vox_last + s * BRICK_BITS;
  c.ir_hi = c.ir_lo + s;
  c.slot_brick = reinterpret_cast<int32_t*>(c.ir_hi + s);
  c.lane_slot = c.slot_brick + s;
  c.lane_brick = c.lane_slot + s;
  c.field = reinterpret_cast<uint8_t*>(c.lane_brick + s);
  return c;
}

// Lanes [0, live) of the batch are live.
__device__ inline int64_t live_lanes(const EditArgs& a) {
  const int32_t count = a.buf[4 * a.size];
  return count < 0 ? 0 : (count > a.size ? a.size : (int64_t)count);
}

// (cell, voxel bit) of a lane, Y flipped (Grid.zig:135, :198-211); the cell
// clamped into the grid, as the plain versions clamp their reads.
__device__ inline void lane_voxel(const EditArgs& a, int64_t lane, int& cell,
                                  int& nth) {
  const int32_t* v = a.buf + 3 * lane;
  const int x = v[0], fy = (a.dims[1] * 4 - 1) - v[1], z = v[2];
  const int64_t c =
      (int64_t)(x >> 2) +
      (int64_t)a.dims[0] * ((z >> 2) + (int64_t)a.dims[2] * (fy >> 2));
  cell = (int)(c < 0 ? 0 : (c >= a.cells ? a.cells - 1 : c));
  nth = (x & 3) + 4 * ((z & 3) + 4 * (fy & 3));
}

__device__ inline bool bit_at(const int32_t* words, int i) {
  return ((uint32_t)words[i >> 5] >> (i & 31)) & 1u;
}

// The order of the lanes whose bytes share the last brick's window: by
// brick, then by lane.
__device__ inline unsigned long long clamp_key(int brick, int64_t lane) {
  return ((unsigned long long)(uint32_t)brick << 32) | (uint64_t)lane;
}

// float -> unsigned key of the same order (-0 below +0)
__device__ inline uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Block-wide exclusive scan of two counts (blockDim.x a multiple of 32, at
// most 1024); the totals land in *total_a, *total_b.
__device__ void scan2(uint32_t& a, uint32_t& b, uint32_t* total_a,
                      uint32_t* total_b) {
  __shared__ uint32_t warp_a[32], warp_b[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t ia = a, ib = b;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ua = __shfl_up_sync(0xFFFFFFFFu, ia, d);
    const uint32_t ub = __shfl_up_sync(0xFFFFFFFFu, ib, d);
    if (lane >= d) {
      ia += ua;
      ib += ub;
    }
  }
  if (lane == 31) {
    warp_a[warp] = ia;
    warp_b[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t sa = lane < warps ? warp_a[lane] : 0u;
    uint32_t sb = lane < warps ? warp_b[lane] : 0u;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t ua = __shfl_up_sync(0xFFFFFFFFu, sa, d);
      const uint32_t ub = __shfl_up_sync(0xFFFFFFFFu, sb, d);
      if (lane >= d) {
        sa += ua;
        sb += ub;
      }
    }
    warp_a[lane] = sa;  // inclusive over the warps
    warp_b[lane] = sb;
    if (lane == 31) {
      *total_a = sa;
      *total_b = sb;
    }
  }
  __syncthreads();
  const uint32_t before_a = warp == 0 ? 0u : warp_a[warp - 1];
  const uint32_t before_b = warp == 0 ? 0u : warp_b[warp - 1];
  a = before_a + ia - a;
  b = before_b + ib - b;
}

// The traversal record of `cell` with skip distance `d`
// (ops/trace.py:_rows_for_cells); an empty cell carries brick 0's words.
__device__ inline void write_row(const EditArgs& a, int cell, int32_t d) {
  const bool loaded = bit_at(a.statuses, cell);
  int brick = loaded ? a.indices[cell] : 0;
  if ((unsigned)brick >= (unsigned)a.brick_alloc) brick = a.brick_alloc - 1;
  const int64_t w = (int64_t)brick * BRICK_WORDS;
  const int4 lo = make_int4(loaded ? a.start_indices[brick] : -1,
                            a.occupancy[w], a.occupancy[w + 1], d);
  const int4 hi = make_int4(a.diel_mask[w], a.diel_mask[w + 1],
                            __float_as_int(a.brick_ir[brick]), 0);
  int4* row = reinterpret_cast<int4*>(a.tables + (int64_t)cell * 8);
  row[0] = lo;
  row[1] = hi;
}

// -- the insert: core/grid.py:apply_edits, one block -------------------------

__global__ void __launch_bounds__(INSERT_THREADS)
insert_kernel(EditArgs a) {
  __shared__ unsigned long long clamp_last[BRICK_BITS];
  __shared__ uint32_t active, cursor, n_touched, n_fresh;
  const Scratch s = carve(a);
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t live = live_lanes(a);
  const int64_t n_summary = summary_words(a.cells);
  const int alloc = a.brick_alloc;

  // 0: clear the summary, and the two words of each live lane's cell
  for (int64_t i = t; i < n_summary; i += T) s.summary[i] = 0u;
  for (int i = t; i < BRICK_BITS; i += T) clamp_last[i] = 0ull;
  if (t == 0) {
    active = (uint32_t)*a.active_bricks;
    cursor = (uint32_t)*a.material_cursor;
  }
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    s.touched[cell >> 5] = 0u;
    s.fresh[cell >> 5] = 0u;
  }
  __syncthreads();

  // 1: mark the touched cells, and those not loaded before the batch
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    const int w = cell >> 5;
    const uint32_t bit = 1u << (cell & 31);
    atomicOr(&s.touched[w], bit);
    if (!bit_at(a.statuses, cell)) atomicOr(&s.fresh[w], bit);
    atomicOr(&s.summary[w >> 5], 1u << (w & 31));
  }
  __syncthreads();

  // 2: ranks in cell order: thread t scans a run of summary words
  const int64_t per = (n_summary + T - 1) / T;
  const int64_t q0 = t * per, q1 = q0 + per < n_summary ? q0 + per : n_summary;
  uint32_t ct = 0u, cf = 0u;
  for (int64_t q = q0; q < q1; ++q) {
    for (uint32_t m = s.summary[q]; m; m &= m - 1) {
      const int64_t w = q * 32 + __ffs(m) - 1;
      ct += __popc(s.touched[w]);
      cf += __popc(s.fresh[w]);
    }
  }
  scan2(ct, cf, &n_touched, &n_fresh);
  // new bricks take active + rank, their windows cursor + 64 * rank
  // (MaterialAllocator.zig:34-43); a brick past brick_alloc is counted and
  // its cell marked, and gets no window
  for (int64_t q = q0; q < q1; ++q) {
    for (uint32_t m = s.summary[q]; m; m &= m - 1) {
      const int64_t w = q * 32 + __ffs(m) - 1;
      s.word_slot[w] = ct;
      ct += __popc(s.touched[w]);
      const uint32_t f = s.fresh[w];
      for (uint32_t b = f; b; b &= b - 1) {
        const int cell = (int)(w * 32 + __ffs(b) - 1);
        const uint32_t id = active + cf;
        a.indices[cell] = (int32_t)id;
        if ((int32_t)id < alloc)
          a.start_indices[id] = (int32_t)(cursor + cf * BRICK_BITS);
        ++cf;
      }
      a.statuses[w] = (int32_t)((uint32_t)a.statuses[w] | f);
    }
  }
  __syncthreads();
  if (t == 0) {
    *a.active_bricks = (int32_t)(active + n_fresh);
    *a.material_cursor = (int32_t)(cursor + n_fresh * BRICK_BITS);
  }
  for (int64_t i = t; i < (int64_t)n_touched * BRICK_BITS; i += T)
    s.vox_last[i] = 0u;
  for (int64_t i = t; i < n_touched; i += T) {
    s.ir_lo[i] = 0u;
    s.ir_hi[i] = 0u;
  }
  __syncthreads();

  // 3: each voxel's last lane; the last lane at each voxel bit among the
  // bricks from brick_alloc - 1 on (their bytes share that brick's window)
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    const int w = cell >> 5;
    const uint32_t below = s.touched[w] & ((1u << (cell & 31)) - 1u);
    const int slot = (int)(s.word_slot[w] + __popc(below));
    const int brick = a.indices[cell];
    s.lane_slot[lane] = slot;
    s.lane_brick[lane] = brick;
    s.slot_brick[slot] = brick;
    atomicMax(&s.vox_last[(int64_t)slot * BRICK_BITS + nth],
              (uint32_t)lane + 1u);
    if (brick >= alloc - 1) atomicMax(&clamp_last[nth], clamp_key(brick, lane));
  }
  __syncthreads();

  // 4: bits, bytes and the bricks' ir
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    const int slot = s.lane_slot[lane], brick = s.lane_brick[lane];
    const uint8_t mat = (uint8_t)a.buf[3 * a.size + lane];
    const bool take =
        s.vox_last[(int64_t)slot * BRICK_BITS + nth] == (uint32_t)lane + 1u;
    const bool diel = a.mat_is_diel != nullptr && a.mat_is_diel[mat] != 0;
    const int64_t word = (int64_t)brick * BRICK_WORDS + (nth >> 5);
    const uint32_t bit = 1u << (nth & 31);
    const bool fits = (unsigned)brick < (unsigned)alloc;
    if (fits) {
      atomicOr(reinterpret_cast<uint32_t*>(a.occupancy + word), bit);
      if (take) {
        uint32_t* d = reinterpret_cast<uint32_t*>(a.diel_mask + word);
        if (diel)
          atomicOr(d, bit);
        else
          atomicAnd(d, ~bit);
      }
    }
    const int safe = brick < 0 ? 0 : (brick > alloc - 1 ? alloc - 1 : brick);
    const int64_t addr =
        (int64_t)((uint32_t)a.start_indices[safe] & 0x7FFFFFFFu) + nth;
    if (addr < a.material_bytes) {
      if (brick < alloc - 1) {
        if (take) a.material_indices[addr] = mat;
      } else if (clamp_last[nth] == clamp_key(brick, lane)) {
        a.material_indices[addr] = mat;
      }
    }
    if (take && diel && fits) {
      // a brick with no ir adopts the lane's, a differing ir poisons it
      const float prev = a.brick_ir[brick], ir = a.mat_ir[mat];
      const float next =
          isnan(prev) ? ir : (prev != ir ? __int_as_float(0x7FC00000) : prev);
      const uint32_t key = ordered(isnan(next) ? INFINITY : next);
      atomicMax(&s.ir_hi[slot], key);
      atomicMax(&s.ir_lo[slot], ~key);
    }
  }
  __syncthreads();

  // 5: a brick whose lanes agree on a finite ir keeps it, else NaN
  for (int64_t i = t; i < n_touched; i += T) {
    const uint32_t hk = s.ir_hi[i];
    if (hk == 0u) continue;  // no dielectric voxel of the brick
    const float lo = unordered(~s.ir_lo[i]), hi = unordered(hk);
    if (!(hi > -INFINITY)) continue;
    a.brick_ir[s.slot_brick[i]] =
        (lo == hi && isfinite(lo)) ? lo : __int_as_float(0x7FC00000);
  }
}

// -- the removal: core/grid.py:remove_edits and the rows, one block ----------

__global__ void __launch_bounds__(REMOVE_THREADS)
remove_kernel(EditArgs a) {
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t live = live_lanes(a);
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    if (!bit_at(a.statuses, cell)) continue;
    const int brick = a.indices[cell];
    if ((unsigned)brick >= (unsigned)a.brick_alloc) continue;
    const int64_t word = (int64_t)brick * BRICK_WORDS + (nth >> 5);
    const uint32_t keep = ~(1u << (nth & 31));
    atomicAnd(reinterpret_cast<uint32_t*>(a.occupancy + word), keep);
    atomicAnd(reinterpret_cast<uint32_t*>(a.diel_mask + word), keep);
  }
  if (a.tables == nullptr) return;
  __syncthreads();
  for (int64_t lane = t; lane < live; lane += T) {
    int cell, nth;
    lane_voxel(a, lane, cell, nth);
    write_row(a, cell, a.dist[cell]);
  }
}

// -- the conservative field: ops/trace.py:_distance_field, one axis a pass ----

// Lines of `len` cells, `inner` apart, `count` of them: the cell of line g at
// position i is (g / inner) * len * inner + i * inner + g % inner.
struct Lines {
  int len, inner;
  int64_t count;
};

__host__ __device__ inline Lines pass_lines(const EditArgs& a, int pass) {
  const int dx = a.dims[0], dy = a.dims[1], dz = a.dims[2];
  if (pass == 0) return Lines{dx, 1, (int64_t)dy * dz};
  if (pass == 1) return Lines{dz, dx, (int64_t)dy * dx};
  return Lines{dy, dx * dz, (int64_t)dx * dz};
}

// PASS 0 reads the status bits and PASS 1 the field of pass 0 (x), each
// writing the field in place (a block reads and writes only its own
// lines); PASS 2 (y) brings the engine's field and lane 3 of the records
// up to date where a cell's distance changed (lane 3 holds the field the
// records were built or last refreshed with, `dist`), and writes the whole
// row of each touched cell.
template <int PASS>
__global__ void __launch_bounds__(FIELD_THREADS)
field_kernel(EditArgs a) {
  __shared__ uint8_t d[FIELD_TILE];
  __shared__ uint8_t win[FIELD_TILE];
  __shared__ int line_cell[FIELD_TILE];  // a line's first cell, -1: none
  const Scratch s = carve(a);
  const Lines ln = pass_lines(a, PASS);
  const int L = ln.len, inner = ln.inner;
  const int per_block = FIELD_TILE / L;  // lines a block
  const int64_t g0 = (int64_t)blockIdx.x * per_block;
  const int t = threadIdx.x;
  const bool along = inner == 1;  // a line's cells are adjacent
  const int step = along ? 1 : per_block;  // tile distance of i and i + 1

  for (int l = t; l < per_block; l += FIELD_THREADS) {
    const int64_t g = g0 + l;
    line_cell[l] = g < ln.count ? (int)((g / inner) * L * inner + g % inner)
                                : -1;
  }
  __syncthreads();

  // the tile holds position i of line l at f = l * L + i (along) or
  // f = i * per_block + l; thread t holds f = t + e * FIELD_THREADS, its
  // (quotient, remainder) by D stepped from t's. Cell -1: no cell (past
  // the lines, or the tile's end).
  const int D = along ? L : per_block;
  const int Q = FIELD_THREADS / D, R = FIELD_THREADS % D;
  int q = t / D, r = t % D;
  int cell[FIELD_PER_THREAD], pos[FIELD_PER_THREAD];
  int out[FIELD_PER_THREAD], w[FIELD_PER_THREAD];
#pragma unroll
  for (int e = 0; e < FIELD_PER_THREAD; ++e) {
    const int f = t + e * FIELD_THREADS;
    const int l = along ? q : r, i = along ? r : q;
    pos[e] = i;
    cell[e] = -1;
    uint8_t v = DIST_CAP;
    if (f < per_block * L && line_cell[l] >= 0) {
      cell[e] = line_cell[l] + i * inner;
      if (PASS == 0)
        v = bit_at(a.statuses, cell[e]) ? 0 : DIST_CAP;
      else
        v = s.field[cell[e]];
    }
    d[f] = v;
    r += R;
    q += Q;
    if (r >= D) {
      r -= D;
      ++q;
    }
  }
  __syncthreads();

  // exact to radius 3; `w` the windowed minimum of radius 3. A cell's
  // neighbours within its line are cells of the tile; other tile positions
  // are never read.
#pragma unroll
  for (int e = 0; e < FIELD_PER_THREAD; ++e) {
    const int f = t + e * FIELD_THREADS, i = pos[e];
    int o = DIST_CAP, m = DIST_CAP;
    if (cell[e] >= 0) {
      o = m = d[f];
#pragma unroll
      for (int k = 1; k <= 3; ++k) {
        const int left = i - k >= 0 ? d[f - k * step] : DIST_CAP;
        const int right = i + k < L ? d[f + k * step] : DIST_CAP;
        const int near = min(left, right);
        o = min(o, max(near, k));
        m = min(m, near);
      }
    }
    out[e] = o;
    w[e] = m;
    win[f] = (uint8_t)m;
  }
  __syncthreads();

  // the windowed minima of radius 6, 12, 24 and 30 with their floors
  const int steps[4] = {3, 6, 12, 6}, floors[4] = {4, 7, 13, 25};
#pragma unroll
  for (int lv = 0; lv < 4; ++lv) {
    const int r = steps[lv];
#pragma unroll
    for (int e = 0; e < FIELD_PER_THREAD; ++e) {
      if (cell[e] < 0) continue;
      const int f = t + e * FIELD_THREADS, i = pos[e];
      const int left = i - r >= 0 ? win[f - r * step] : DIST_CAP;
      const int right = i + r < L ? win[f + r * step] : DIST_CAP;
      w[e] = min(w[e], min(left, right));
      out[e] = min(out[e], max(w[e], floors[lv]));
    }
    if (lv == 3) break;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < FIELD_PER_THREAD; ++e)
      win[t + e * FIELD_THREADS] = (uint8_t)w[e];
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < FIELD_PER_THREAD; ++e) {
    const int c = cell[e];
    if (c < 0) continue;
    if (PASS < 2) {
      s.field[c] = (uint8_t)out[e];
      continue;
    }
    const int w32 = c >> 5;
    const bool touched = ((s.summary[w32 >> 5] >> (w32 & 31)) & 1u) &&
                         ((s.touched[w32] >> (c & 31)) & 1u);
    if (touched) {
      a.dist[c] = out[e];
      write_row(a, c, out[e]);
    } else if (a.dist[c] != out[e]) {
      a.dist[c] = out[e];
      a.tables[(int64_t)c * 8 + 3] = out[e];
    }
  }
}

template <int PASS>
int launch_field(const EditArgs& a, cudaStream_t stream) {
  const Lines ln = pass_lines(a, PASS);
  const int per_block = FIELD_TILE / ln.len;
  const int64_t blocks = (ln.count + per_block - 1) / per_block;
  field_kernel<PASS><<<(unsigned)blocks, FIELD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zvt_edit_insert(const EditArgs* args, void* stream) {
  insert_kernel<<<1, INSERT_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int zvt_edit_field(const EditArgs* args, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int status = launch_field<0>(*args, s);
  if (status == 0) status = launch_field<1>(*args, s);
  if (status == 0) status = launch_field<2>(*args, s);
  return status;
}

extern "C" int zvt_edit_remove(const EditArgs* args, void* stream) {
  remove_kernel<<<1, REMOVE_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

