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
// What bounds it on an H100: random 32-byte record reads (one per grid
// step) and warp divergence (lanes of a warp take different numbers of
// grid and brick steps). The default scene's record table (1M cells x 32 B
// = 32 MiB) and its material bytes (64 MiB) compete for the 50 MB L2.
//
// What the design does about it: one thread walks one ray over the
// per-cell records, as the GLSL reference does; a record is two 16-byte
// read-only loads, the second only when a dielectric key needs it; the
// brick's occupancy words live in registers once the ray enters it, so
// every voxel test is a register bit test; the material byte is read once,
// after the traversal. The TPU kernel's region blocks, region vote, pixel
// tiles and bin sorts existed because a TPU has no fast per-lane gather and
// are left out. Coherence sorting and persistent blocks are later work.
//
// Builds (template flags, one instantiation each): the default; SHADOW, the
// TPU kernel's sun-shadow probe, where a thread that hits traces its own
// sun ray as the GLSL reference does (brick_raytracer.comp:240-249); STATS,
// per-ray loop iterations; NO_SKIP (SKIP=false), the exact cell-by-cell
// DDA: the empty-space leap is compiled out, so every empty cell costs one
// loop iteration and the records' distance lane is never read. Each of the
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

// DDA cursor from the ray position at t0 (brick_raytracer.comp:287-311 at
// grid level, :389-405 at brick level)
__device__ __forceinline__ void cursor(float t0, float g0, float stf,
                                       float ad, float o, float d,
                                       float size, float& s, int& l) {
  float f = (o + d * t0 - g0) / size;
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
template <bool STATS, bool SKIP>
__device__ __forceinline__ Hit trace_ray(const TraceParams& p,
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
    cursor(t0, p.g0[0], stxf, adx, ox, dx, scale, sx, lx);
    cursor(t0, p.g0[1], styf, ady, oy, dy, scale, sy, ly);
    cursor(t0, p.g0[2], stzf, adz, oz, dz, scale, sz, lz);
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
        cursor(entry_t, bminx, stxf, adx, ox, dx, voxel_scale, bsx, blx);
        cursor(entry_t, bminy, styf, ady, oy, dy, voxel_scale, bsy, bly);
        cursor(entry_t, bminz, stzf, adz, oz, dz, voxel_scale, bsz, blz);
        b_t = 0.0f;
        local_t_max = grid_t_max - entry_t;
        in_brick = true;
      } else if (SKIP && rec.w >= 2) {
        // empty-space skip: leap dist-1 cells, re-derive the DDA cursor
        do_skip = true;
        const float cur_t = t_base + p.park + t_value;
        t_base = cur_t + ((float)rec.w - 1.0f) * scale * inv_max_abs_d;
        const float t0 = t_base + p.park;
        cursor(t0, p.g0[0], stxf, adx, ox, dx, scale, sx, lx);
        cursor(t0, p.g0[1], styf, ady, oy, dy, scale, sy, ly);
        cursor(t0, p.g0[2], stzf, adz, oz, dz, scale, sz, lz);
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

// SHADOW: a thread whose ray hits traces the sun ray from the hit point
// toward its target and writes `occluded` (the TPU kernel's shadow=True
// probe, tile_tracer.py:381-391). STATS: writes the first traversal's loop
// iterations (the TPU kernel's stats=True n_step). Both are compile-time
// flags, so the default build carries neither; SKIP=false is the NO_SKIP
// build. The launch bounds hold the default and stats builds to 64
// registers, so 8 blocks of 128 threads (half the SM's warps) stay
// resident.
template <bool SHADOW, bool STATS, bool SKIP>
__global__ void __launch_bounds__(128, SHADOW ? 7 : 8)
traverse_kernel(TraceParams p, Buffers b) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float ox = b.ox[i], oy = b.oy[i], oz = b.oz[i];
  const float dx = b.dx[i], dy = b.dy[i], dz = b.dz[i];
  const bool has_key = b.ray_key != nullptr;
  const float nan = __int_as_float(0x7fc00000);
  const Hit h = trace_ray<STATS, SKIP>(p, b.tables, ox, oy, oz, dx, dy, dz,
                                 b.active[i], has_key,
                                 has_key ? b.ray_key[i] : nan);

  // epilogue: normal from the face code, hit point, material byte
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
    if (h.found) {
      // toward the target, normalized as ops/trace.py:shadow_dirs rounds
      // it; no dielectric key, as the separate shadow launch has none
      const float sx = b.tx[i] - px, sy = b.ty[i] - py, sz = b.tz[i] - pz;
      const float inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz);
      occluded = trace_ray<false, SKIP>(p, b.tables, px, py, pz, sx * inv,
                                  sy * inv, sz * inv, true, false, nan)
                     .found;
    }
    b.occluded[i] = occluded;
  }
}

template <bool SKIP>
void launch(const TraceParams& p, const Buffers& b, bool shadow, bool stats,
            unsigned blocks, int threads, cudaStream_t s) {
  if (shadow && stats)
    traverse_kernel<true, true, SKIP><<<blocks, threads, 0, s>>>(p, b);
  else if (shadow)
    traverse_kernel<true, false, SKIP><<<blocks, threads, 0, s>>>(p, b);
  else if (stats)
    traverse_kernel<false, true, SKIP><<<blocks, threads, 0, s>>>(p, b);
  else
    traverse_kernel<false, false, SKIP><<<blocks, threads, 0, s>>>(p, b);
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
  if (p.n > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((p.n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (p.use_skip)
      launch<true>(p, b, shadow, stats, blocks, threads, s);
    else
      launch<false>(p, b, shadow, stats, blocks, threads, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zvt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
