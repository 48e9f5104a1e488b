// Kernel A: first voxel hit of the two-level grid+brick DDA, one thread per
// ray (GLSL GridHit + BrickHit, brick_raytracer.comp:271-471).
//
// Replaces the TPU kernel zig_vulkan_tpu/ops/tile_tracer.py:_tile_kernel
// (launched by trace_tiles_regions, wrapped by grid_hit_tiles) and computes
// what zig_vulkan_tpu/ops/trace.py:_grid_hit_soa computes with
// use_skip=True, bounded_t=False and the per-ray dielectric key; its
// NO_SKIP builds compute the same with use_skip=False (the exact DDA, an
// XLA wavefront in the JAX package). The plain torch version is
// zig_vulkan_tpu_torch/ops/trace.py:_grid_hit_soa.
//
// What bounds it on an H100: the instructions of its loop and the latency
// of its longest rays. The frame's primary launch keeps 88% of its lanes'
// loop iterations busy (warp-use share) and an L2 flush costs it 1%, so
// neither divergence nor record bytes hold it back; with 32 warps resident
// an SM issues about one instruction a cycle a scheduler through the loop's
// enter / leap / step / voxel paths. The launches with only their slowest
// 1% of rays live take 55-67% of their full time (chip_smoke.py phase 6b,
// `ms_tail_only`): a grid step is a dependent record read and a few dozen
// dependent operations, and rays of up to 74 (primary) and 159 (keyed
// bounce) steps end each launch.
//
// What the design does about it: one thread walks one ray over the
// per-cell records, as the GLSL reference does, so every ray starts as
// soon as its block does; the hardware's block scheduler refills the SMs.
// A record is two 16-byte read-only loads, the second only when a
// dielectric key needs it; the brick's occupancy words live in registers
// once the ray enters it, so every voxel test is a register bit test; the
// material byte is read once, after the traversal. Where the cell size is
// a power of two (every scene of the repo), the POW2 builds turn the six
// divisions of a brick entry or an empty-space leap into multiplies by the
// exact reciprocal, bit for bit the same quotients: the loop loses the
// divisions' range checks and slow-path calls, the register spill around
// those calls goes, and the frame's six launches take 12% less time on an
// H100 (PERF.md, Findings). Persistent warps that fetch lane ids (with and
// without refilling retired lanes, with and without queueing the live
// lanes into full warps), a pass that queues the live lanes first, a
// 16-byte hot record plane, prefetching the next cell's record on brick
// entry and branch-free DDA steps were built and measured on the frame's
// launches and lost or tied (PERF.md, Findings). The TPU kernel's region
// blocks, region vote, pixel tiles and bin sorts existed because a TPU has
// no fast per-lane gather and are left out.
//
// Builds (template flags, one instantiation each, each in a POW2 and a
// dividing version): the default; SHADOW, the TPU kernel's sun-shadow
// probe, where a thread that hits traces its own sun ray as the GLSL
// reference does (brick_raytracer.comp:240-249); STATS, per-ray loop
// iterations; NO_SKIP (SKIP=false), the exact cell-by-cell DDA: the
// empty-space leap is compiled out, so every empty cell costs one loop
// iteration and the records' distance lane is never read. Each of the
// four skip builds has its NO_SKIP twin. The TPU kernel's sparse_roam build
// changes only its region park schedule; on a sprayed scene this kernel
// computes the same first hits as everywhere else.
//
// Step bound: one loop iteration is one iteration of the reference's
// while loop (one grid-level action, then up to BRICK_UNROLL brick steps),
// and a lane stops after max_steps of them with the reference's verdict,
// so every lane retires and no retrace path exists.
//
// Float parity: built with --fmad=false and without fast math, every
// expression below keeps the reference's operation order, one rounding per
// operation; min/max propagate NaN as XLA's and torch's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

// The scene constants of one launch; mirrored by _build.TraceParams.
struct TraceParams {
  float g0[3];        // grid min point
  float g1[3];        // grid max point
  float scale;        // cell size
  float voxel_scale;  // scale / 4
  float park;         // 1e-4 * scale, the cursor re-derivation offset
  float enter_eps;    // 0.01 * scale, the brick entry offset
  float t_off;        // voxel_scale * 0.05, the hit offset
  int dims[3];
  int cells;
  int mat_cap;        // material_indices length - 1
  int max_steps;
  int use_skip;       // 0: the NO_SKIP builds
  int64_t n;
};

namespace {

constexpr int BRICK_DIM = 4;
constexpr int BRICK_UNROLL = 4;  // brick steps per iteration (brick_unroll)

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float safe_inverse(float v) {
  return v == 0.0f ? 1e12f : 1.0f / v;
}

// 1 / scale and 1 / voxel_scale, used where both scales are powers of two
// (the POW2 builds): there x * (1 / size) is x / size to the last bit, as
// both are the one rounding of the same real number, and it costs one
// multiply where an IEEE division costs a reciprocal, its refinement, a
// range check and a slow-path call.
struct Inverses {
  float scale;
  float voxel_scale;
};

// DDA cursor from the ray position at t0 (brick_raytracer.comp:287-311 at
// grid level, :389-405 at brick level)
template <bool POW2>
__device__ __forceinline__ void cursor(float t0, float g0, float stf,
                                       float ad, float o, float d,
                                       float size, float inv, float& s,
                                       int& l) {
  const float r = o + d * t0 - g0;
  float f = POW2 ? r * inv : r / size;
  float fl = floorf(f);
  s = (stf * (fl - f) + (stf * 0.5f + 0.5f)) * ad;
  l = (int)fl;
}

// What one traversal reports: hit flag, hit t, the face code of the normal
// (axis 0..2, +4 for the negative sign), the clamped material address and
// the loop iterations it ran.
struct Hit {
  bool found;
  float t;
  int ncode;
  int addr;
  int steps;
};

// One ray through the two-level DDA. `has_key` selects the dielectric key
// (the second record read); STATS counts the loop iterations; SKIP leaps
// empty space by the records' distance lane.
template <bool STATS, bool SKIP, bool POW2>
__device__ __forceinline__ Hit trace_ray(const TraceParams& p,
                                         const Inverses& inv,
                                         const int4* __restrict__ tables,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         bool active, bool has_key,
                                         float ray_key) {
  const float scale = p.scale, voxel_scale = p.voxel_scale;
  const float ix = safe_inverse(dx), iy = safe_inverse(dy),
              iz = safe_inverse(dz);

  // slab entry with normal (AdvNormIntersect, brick_raytracer.comp:522-536)
  const float tlx = (p.g0[0] - ox) * ix, tux = (p.g1[0] - ox) * ix;
  const float tly = (p.g0[1] - oy) * iy, tuy = (p.g1[1] - oy) * iy;
  const float tlz = (p.g0[2] - oz) * iz, tuz = (p.g1[2] - oz) * iz;
  const float tminx = min_nan(tlx, tux), tmaxx = max_nan(tlx, tux);
  const float tminy = min_nan(tly, tuy), tmaxy = max_nan(tly, tuy);
  const float tminz = min_nan(tlz, tuz), tmaxz = max_nan(tlz, tuz);
  // indexOfMaxComponent tie-breaking (brick_raytracer.comp:501-503)
  const bool is_y = (tminy > tminx) && (tminy > tminz);
  const bool is_z = (tminz > tminx) && (tminz > tminy);
  const bool is_x = !(is_y || is_z);
  const float entry_tmin = is_x ? tminx : (is_y ? tminy : tminz);
  const float grid_t_min = max_nan(1e-5f, entry_tmin);
  const float grid_t_max =
      min_nan(__int_as_float(0x7f800000), min_nan(tmaxx, min_nan(tmaxy, tmaxz)));
  const bool slab_ok = grid_t_min <= grid_t_max;

  const float adx = fabsf(ix), ady = fabsf(iy), adz = fabsf(iz);
  const int stx = (dx > 0.0f) - (dx < 0.0f);
  const int sty = (dy > 0.0f) - (dy < 0.0f);
  const int stz = (dz > 0.0f) - (dz < 0.0f);
  const float stxf = (float)stx, styf = (float)sty, stzf = (float)stz;
  const float inv_max_abs_d =
      1.0f / max_nan(fabsf(dx), max_nan(fabsf(dy), fabsf(dz)));

  // normal code: axis (0, 1, 2) + 4 for the negative sign
  int ncode = is_x ? (ix >= 0.0f ? 0 : 4)
                   : (is_y ? (iy >= 0.0f ? 1 : 5) : (iz >= 0.0f ? 2 : 6));
  const int code_x = stx < 0 ? 0 : 4;  // normal +x when stepping -x
  const int code_y = sty < 0 ? 1 : 5;
  const int code_z = stz < 0 ? 2 : 6;

  bool running = active && slab_ok;
  bool found = false;
  float out_t = 0.0f;
  int out_addr = 0;
  int steps = 0;

  // grid-level DDA state
  float t_base = grid_t_min, t_value = 0.0f;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  int lx = 0, ly = 0, lz = 0;
  if (running) {
    const float t0 = t_base + p.park;
    cursor<POW2>(t0, p.g0[0], stxf, adx, ox, dx, scale, inv.scale, sx, lx);
    cursor<POW2>(t0, p.g0[1], styf, ady, oy, dy, scale, inv.scale, sy, ly);
    cursor<POW2>(t0, p.g0[2], stzf, adz, oz, dz, scale, inv.scale, sz, lz);
  }

  // brick-level DDA state, loaded on entry
  bool in_brick = false;
  float bsx = 0.0f, bsy = 0.0f, bsz = 0.0f, b_t = 0.0f;
  int blx = 0, bly = 0, blz = 0;
  float entry_t = 0.0f, local_t_max = 0.0f;
  unsigned occ_lo = 0u, occ_hi = 0u, dmask_lo = 0u, dmask_hi = 0u;
  int mat_start = 0;
  float brick_key = __int_as_float(0x7fc00000);

  for (int step = 0; step < p.max_steps && running; ++step) {
    if (STATS) ++steps;
    // ---------------- grid level: cell check ----------------
    bool g_act = false, enter = false, do_skip = false;
    if (!in_brick) {
      const bool in_b_g = lx >= 0 && lx < p.dims[0] && ly >= 0 &&
                          ly < p.dims[1] && lz >= 0 && lz < p.dims[2];
      if (!in_b_g) {
        running = false;  // left the grid: a miss
        break;
      }
      g_act = true;
      const int cell = lx + p.dims[0] * (lz + p.dims[2] * ly);
      const int4 rec = __ldg(tables + 2 * (int64_t)cell);
      if (rec.x != -1) {
        enter = true;
        occ_lo = (unsigned)rec.y;
        occ_hi = (unsigned)rec.z;
        mat_start = rec.x & 0x7FFFFFFF;
        if (has_key) {
          const int4 rec2 = __ldg(tables + 2 * (int64_t)cell + 1);
          dmask_lo = (unsigned)rec2.x;
          dmask_hi = (unsigned)rec2.y;
          brick_key = __int_as_float(rec2.z);
        }
        const float bminx = (float)lx * scale + p.g0[0];
        const float bminy = (float)ly * scale + p.g0[1];
        const float bminz = (float)lz * scale + p.g0[2];
        entry_t = t_value + t_base + p.enter_eps;
        cursor<POW2>(entry_t, bminx, stxf, adx, ox, dx, voxel_scale,
                     inv.voxel_scale, bsx, blx);
        cursor<POW2>(entry_t, bminy, styf, ady, oy, dy, voxel_scale,
                     inv.voxel_scale, bsy, bly);
        cursor<POW2>(entry_t, bminz, stzf, adz, oz, dz, voxel_scale,
                     inv.voxel_scale, bsz, blz);
        b_t = 0.0f;
        local_t_max = grid_t_max - entry_t;
        in_brick = true;
      } else if (SKIP && rec.w >= 2) {
        // empty-space skip: leap dist-1 cells, re-derive the DDA cursor
        do_skip = true;
        const float cur_t = t_base + p.park + t_value;
        t_base = cur_t + ((float)rec.w - 1.0f) * scale * inv_max_abs_d;
        const float t0 = t_base + p.park;
        cursor<POW2>(t0, p.g0[0], stxf, adx, ox, dx, scale, inv.scale, sx, lx);
        cursor<POW2>(t0, p.g0[1], styf, ady, oy, dy, scale, inv.scale, sy, ly);
        cursor<POW2>(t0, p.g0[2], stzf, adz, oz, dz, scale, inv.scale, sz, lz);
        t_value = 0.0f;
      }
    }

    // ------- brick level: voxel checks from the register words -------
    bool b_exit = false;
    for (int u = 0; u < BRICK_UNROLL && in_brick; ++u) {
      if (!(blx >= 0 && blx < BRICK_DIM && bly >= 0 && bly < BRICK_DIM &&
            blz >= 0 && blz < BRICK_DIM && b_t <= local_t_max)) {
        in_brick = false;
        b_exit = true;
        break;
      }
      const int vi = blx + BRICK_DIM * (blz + BRICK_DIM * bly);
      const unsigned bit = 1u << (vi & 31);
      const bool vhit = ((vi < 32 ? occ_lo : occ_hi) & bit) != 0u;
      // same-dielectric skip (brick_raytracer.comp:427)
      const bool ignore = ((vi < 32 ? dmask_lo : dmask_hi) & bit) != 0u &&
                          brick_key == ray_key;
      if (vhit && !ignore) {
        found = true;
        out_t = entry_t + b_t - p.t_off;
        out_addr = min(max(mat_start + vi, 0), p.mat_cap);
        running = false;
        break;
      }
      const bool bax = (bsx < bsy) && (bsx < bsz);
      const bool bay = !(bsx < bsy) && (bsy < bsz);
      if (bax) {
        b_t = bsx * voxel_scale;
        bsx = bsx + adx;
        blx += stx;
        ncode = code_x;
      } else if (bay) {
        b_t = bsy * voxel_scale;
        bsy = bsy + ady;
        bly += sty;
        ncode = code_y;
      } else {
        b_t = bsz * voxel_scale;
        bsz = bsz + adz;
        blz += stz;
        ncode = code_z;
      }
    }

    // ---------------- grid advance ----------------
    if ((g_act && !enter && !do_skip) || b_exit) {
      const bool gax = (sx < sy) && (sx < sz);
      const bool gay = !(sx < sy) && (sy < sz);
      if (gax) {
        t_value = sx * scale;
        sx = sx + adx;
        lx += stx;
        ncode = code_x;
      } else if (gay) {
        t_value = sy * scale;
        sy = sy + ady;
        ly += sty;
        ncode = code_y;
      } else {
        t_value = sz * scale;
        sz = sz + adz;
        lz += stz;
        ncode = code_z;
      }
    }
  }
  return Hit{found, out_t, ncode, out_addr, steps};
}

// The buffers of one launch (see zvt_traverse).
struct Buffers {
  const int4* tables;
  const uint8_t* material_indices;
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* ray_key;  // nullptr: no dielectric key
  const bool* active;
  const float *tx, *ty, *tz;  // sun targets (SHADOW builds)
  bool* found;
  float *t, *px, *py, *pz, *nx, *ny, *nz;
  int32_t* index;
  bool* occluded;   // SHADOW builds
  int32_t* n_step;  // STATS builds
};

// Lane i from start to end: its ray, the traversal (none when !LIVE: the
// twin's values of a masked-off lane, whose loop never runs), the epilogue
// (normal from the face code, hit point, material byte) and, in the SHADOW
// builds, the sun ray of a lane that hits.
template <bool SHADOW, bool STATS, bool SKIP, bool POW2, bool LIVE>
__device__ __forceinline__ void run_lane(const TraceParams& p,
                                         const Inverses& inv,
                                         const Buffers& b, int i) {
  const float ox = b.ox[i], oy = b.oy[i], oz = b.oz[i];
  const float dx = b.dx[i], dy = b.dy[i], dz = b.dz[i];
  const bool has_key = b.ray_key != nullptr;
  const float nan = __int_as_float(0x7fc00000);
  const Hit h = trace_ray<STATS, SKIP, POW2>(
      p, inv, b.tables, ox, oy, oz, dx, dy, dz, LIVE, has_key,
      LIVE && has_key ? b.ray_key[i] : nan);

  const float sign = h.ncode < 4 ? 1.0f : -1.0f;
  const int axis = h.ncode & 3;
  const float nx = axis == 0 ? sign : 0.0f;
  const float ny = axis == 1 ? sign : 0.0f;
  const float nz = axis == 2 ? sign : 0.0f;
  const float px = ox + dx * h.t + nx * p.t_off;
  const float py = oy + dy * h.t + ny * p.t_off;
  const float pz = oz + dz * h.t + nz * p.t_off;
  b.found[i] = h.found;
  b.t[i] = h.t;
  b.px[i] = px;
  b.py[i] = py;
  b.pz[i] = pz;
  b.nx[i] = nx;
  b.ny[i] = ny;
  b.nz[i] = nz;
  b.index[i] = (int32_t)b.material_indices[h.found ? h.addr : 0];
  if (STATS) b.n_step[i] = h.steps;
  if (SHADOW) {
    bool occluded = false;
    if (LIVE && h.found) {
      // toward the target, normalized as ops/trace.py:shadow_dirs rounds
      // it; no dielectric key, as the separate shadow launch has none
      const float sx = b.tx[i] - px, sy = b.ty[i] - py, sz = b.tz[i] - pz;
      const float r = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz);
      occluded = trace_ray<false, SKIP, POW2>(p, inv, b.tables, px, py, pz,
                                              sx * r, sy * r, sz * r, true,
                                              false, nan)
                     .found;
    }
    b.occluded[i] = occluded;
  }
}

constexpr int THREADS = 128;

// One thread per lane, blocks in lane order. The launch bounds cap the
// builds without the sun ray at 64 registers (8 blocks of 128 threads,
// half the SM's warps, resident) and the SHADOW builds at 72 (7 blocks).
template <bool SHADOW, bool STATS, bool SKIP, bool POW2>
__global__ void __launch_bounds__(THREADS, SHADOW ? 7 : 8)
traverse_kernel(TraceParams p, Inverses inv, Buffers b) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.n) return;
  if (b.active[i])
    run_lane<SHADOW, STATS, SKIP, POW2, true>(p, inv, b, i);
  else
    run_lane<SHADOW, STATS, SKIP, POW2, false>(p, inv, b, i);
}

template <bool SHADOW, bool STATS, bool SKIP, bool POW2>
void launch(const TraceParams& p, const Inverses& inv, const Buffers& b,
            cudaStream_t s) {
  const unsigned blocks = (unsigned)((p.n + THREADS - 1) / THREADS);
  traverse_kernel<SHADOW, STATS, SKIP, POW2><<<blocks, THREADS, 0, s>>>(
      p, inv, b);
}

template <bool SKIP, bool POW2>
void launch(const TraceParams& p, const Inverses& inv, const Buffers& b,
            bool shadow, bool stats, cudaStream_t s) {
  if (shadow && stats)
    launch<true, true, SKIP, POW2>(p, inv, b, s);
  else if (shadow)
    launch<true, false, SKIP, POW2>(p, inv, b, s);
  else if (stats)
    launch<false, true, SKIP, POW2>(p, inv, b, s);
  else
    launch<false, false, SKIP, POW2>(p, inv, b, s);
}

// x a power of two whose reciprocal is a normal float
bool power_of_two(float x) {
  int e = 0;
  return std::isfinite(x) && x > 0.0f && std::frexp(x, &e) == 0.5f &&
         std::isnormal(1.0f / x);
}

}  // namespace

extern "C" int zvt_traverse(const TraceParams* params, const void* tables,
                            const void* material_indices, const void* ox,
                            const void* oy, const void* oz, const void* dx,
                            const void* dy, const void* dz,
                            const void* ray_key, const void* active,
                            const void* tx, const void* ty, const void* tz,
                            void* found, void* t, void* px, void* py,
                            void* pz, void* nx, void* ny, void* nz,
                            void* index, void* occluded, void* n_step,
                            void* stream) {
  const TraceParams p = *params;
  const Buffers b{(const int4*)tables, (const uint8_t*)material_indices,
                  (const float*)ox, (const float*)oy, (const float*)oz,
                  (const float*)dx, (const float*)dy, (const float*)dz,
                  (const float*)ray_key, (const bool*)active,
                  (const float*)tx, (const float*)ty, (const float*)tz,
                  (bool*)found, (float*)t, (float*)px, (float*)py,
                  (float*)pz, (float*)nx, (float*)ny, (float*)nz,
                  (int32_t*)index, (bool*)occluded, (int32_t*)n_step};
  const bool shadow = tx != nullptr;
  const bool stats = n_step != nullptr;
  if (shadow && (ty == nullptr || tz == nullptr || occluded == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.n > INT32_MAX - THREADS) return (int)cudaErrorInvalidValue;
  if (p.n > 0) {
    const Inverses inv{1.0f / p.scale, 1.0f / p.voxel_scale};
    const bool pow2 = power_of_two(p.scale) && power_of_two(p.voxel_scale);
    cudaStream_t s = (cudaStream_t)stream;
    if (p.use_skip && pow2)
      launch<true, true>(p, inv, b, shadow, stats, s);
    else if (p.use_skip)
      launch<true, false>(p, inv, b, shadow, stats, s);
    else if (pow2)
      launch<false, true>(p, inv, b, shadow, stats, s);
    else
      launch<false, false>(p, inv, b, shadow, stats, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zvt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
