// Kernel F: the post-process of a frame, the sirBird spiral denoiser and
// the clamp-to-edge bilinear resample, in one launch.
//
// Replaces the XLA fusion of zig_vulkan_tpu/ops/denoise.py:_sir_bird (167;
// its postprocess, 242, bilinear_sample_shifted, 61, and
// bilinear_resample, 86) inside the JAX engine's jitted step
// (zig_vulkan_tpu/engine/engine.py:179). The plain torch versions are
// zig_vulkan_tpu_torch/ops/denoise.py:denoise_plain,
// bilinear_resample_plain and postprocess_plain.
//
// Three modes, chosen by the wrapper from the shapes and the denoiser:
// SHIFTED, the denoiser at equal input and output size (each tap a uniform
// shift of the image: integer row and column shifts clamped at the image's
// edges and two lerps); RESAMPLE, the denoiser at another output size (each
// tap and the centre a bilinear sample of the input at the output pixel's
// texture coordinate, offset by the tap); RESAMPLE_ONLY, the bilinear
// resample alone (the denoiser off).
//
// The spiral's taps are uniform across pixels, so the wrapper computes them
// on the host, one row a tap in float32 as the torch version computes its
// scalars (`ops.denoise.spiral_taps`), and passes them by value in the
// argument struct: a captured graph holds them with its launch. The static
// builds get the live taps with their influences. The runtime builds (the
// engine's step, as the JAX step's `denoise(..., max_samples=32)`) get the
// geometry of every tap of the MAX_RUNTIME_SAMPLES spiral, which depends on
// pixel_multiplier and the sizes alone, and pointers to three floats in
// device memory, the frame's push constants samples (pc[23]),
// distribution_bias (pc[19]) and inverse_hue_tolerance (pc[20]): a captured
// launch reads whatever values they hold when it runs. Each block computes
// the taps' influences from them into shared memory, runs the live taps
// (index <= samples) in full and the rest as masked taps, which add
// tap * 0 to the weighted sums as the JAX path's zero-influence selects do
// (a NaN or an infinity under a masked tap's footprint makes the pixel
// NaN). The slab
// `img` holds image rows from `a` on of an image of `height` rows;
// output rows [r0, r1) are written and read image rows [row_lo, row_hi)
// (`ops.denoise.rows_read`). Row indices are clamped at the image's edges
// and then shifted into the slab, so a band of rows equals the same rows
// of the whole image's result bit for bit.
//
// What bounds it on an H100: operations. A tap is about 60 float
// operations a pixel (the bilinear sample, its length and normal, the dot
// product, the running sums), three IEEE divisions, an IEEE root and two
// calls of powf; 21 taps at the defaults. The bytes are 12 a pixel read and
// 12 written.
//
// What the design does about it. Each build is a template instantiation
// of (mode, the hue's pow branch, tiled or not), picked on the host before
// the launch (`zvt_denoise`, from `ops.denoise.launch_plan`): the tap loop
// holds no mode test and no switch. One thread an output pixel: the tap
// loop issues near the card's instruction rate (about 330 SASS
// instructions a pixel and tap, two thirds of them in the two accurate
// powf), so more pixels a thread buy little and cost registers.
//  - SHIFTED, tiled ("shifted_tile"): a block of 32 x block_rows threads
//    owns an output tile of as many pixels and loads it once into shared
//    memory with its halo (the taps' extent
//    [hx0, hx1] x [hy0, hy1], computed on the host), as three channel
//    planes. Rows and columns are clamped at load time in whole-image
//    coordinates, then clamped to the rows the launch reads and shifted into
//    the slab; a tap then reads the tile at one uniform offset, with no
//    per-tap clamp or 64-bit address, a warp's 32 reads falling on 32
//    consecutive words.
//  - SHIFTED, untiled ("shifted_global"): a halo whose tile outgrows the
//    shared memory a block can opt into (a large pixel_multiplier) reads
//    the image in global memory with the clamps in the loop; the host picks
//    it from the taps before the launch.
//  - RESAMPLE ("resample"): a tap's neighbours and fractions vary from
//    pixel to pixel; the samples are gathered from global memory.
//  - RESAMPLE_ONLY ("resample_only"): the resample alone.
//
// The runtime builds ("shifted_tile_runtime", "shifted_global_runtime",
// "resample_runtime") add to a tap's work only a load of its influence from
// shared memory; a masked tap is its bilinear sample and three products and
// sums. The tiled runtime build votes while it loads its tile: a block
// whose tile holds no value of magnitude 2^126 or more (no NaN, no
// infinity, nothing a lerp could carry past the float range) skips its
// masked taps, since each would add +-0 to sums that are never -0.
//
// Float parity: built with --fmad=false and without fast math, each torch
// operation one rounding in the torch version's order; division and square
// root are IEEE (__fdiv_rn, __fsqrt_rn); the clamps keep NaN as
// torch.clamp does; the sums start at +0.0 and add tap 0 first; in the
// static builds the hue's power takes the branch ATen's tensor-scalar pow
// takes for its exponent (0 and 1, then 0.5, -0.5, -1, 2, 3, -2 as special
// cases, otherwise powf); the runtime builds' exponents live in device
// memory, where ATen's pow runs powf for every value, and so do they; the
// saturation's exponent 8 stays a run-time powf argument.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int DENOISE_MAX_TAPS = 33;  // ops.denoise.MAX_RUNTIME_SAMPLES + 1

constexpr int TILE_W = 32;          // output columns a block: a warp a row
constexpr int MAX_BLOCK_ROWS = 8;   // threads a block along y, at most
constexpr int STATIC_SMEM = 48 * 1024;  // above: opt in (cudaFuncSetAttribute)
// the runtime builds' influences, one a tap, in static shared memory
constexpr int RUNTIME_SMEM = 4 * DENOISE_MAX_TAPS;
constexpr float FINITE_TAPS = 0x1p126f;  // a tile below it makes finite taps

// modes (ops.denoise.SHIFTED, RESAMPLE, RESAMPLE_ONLY)
enum Mode { SHIFTED = 0, RESAMPLE = 1, RESAMPLE_ONLY = 2 };

// ATen's branches of torch.pow(tensor, exponent) (PowKernel.cu and
// pow_Tensor_Scalar_out): the value a hue of base x gets
constexpr int POW_POWF = 0;        // powf(x, e)
constexpr int POW_ZERO = 1;        // 1
constexpr int POW_ONE = 2;         // x
constexpr int POW_SQRT = 3;        // sqrt(x)
constexpr int POW_RSQRT = 4;       // rsqrtf(x)
constexpr int POW_RECIPROCAL = 5;  // 1 / x
constexpr int POW_SQUARE = 6;      // x * x
constexpr int POW_CUBE = 7;        // x * x * x
constexpr int POW_INV_SQUARE = 8;  // 1 / (x * x)

// One launch's arguments; mirrored by _build.DenoiseArgs.
struct DenoiseArgs {
  const float* img;  // f32[rows_in, w_in, 3]
  float* out;        // f32[r1 - r0, w_out, 3]
  int w_in;
  int height;        // the whole image's input rows
  int a;             // the slab's first image row
  int row_lo;        // image rows [row_lo, row_hi) the launch reads
  int row_hi;
  int w_out;
  int h_out;
  int r0;            // output rows [r0, r1)
  int r1;
  int mode;
  int hue_pow;       // POW_*
  int n_taps;        // taps, in spiral order: the live ones (static),
                     // every one of the spiral (runtime)
  int tiled;         // SHIFTED: 1 through the shared-memory tile
  int hx0;           // the tile's halo: columns [hx0, hx1] and rows
  int hx1;           // [hy0, hy1] around an output pixel
  int hy0;
  int hy1;
  int block_rows;    // threads a block along y
  int smem;          // dynamic shared memory bytes a block
  float hue_exp;     // inverse_hue_tolerance
  float sat_exp;     // 8: the saturation's exponent, a runtime value as
                     // torch's pow kernel has it
  // a row a tap: the integer shift and its fractions (SHIFTED), the
  // texture-coordinate offsets (RESAMPLE), pixel_influence cubed (static),
  // ox * ox + oy * oy (runtime). The runtime builds' fields come last, so
  // the static builds read theirs where they always have.
  int x0[DENOISE_MAX_TAPS];
  int y0[DENOISE_MAX_TAPS];
  float fx[DENOISE_MAX_TAPS];
  float fy[DENOISE_MAX_TAPS];
  float gx[DENOISE_MAX_TAPS];   // 1 - fx
  float gy[DENOISE_MAX_TAPS];   // 1 - fy
  float ou[DENOISE_MAX_TAPS];   // ox / w_in
  float ov[DENOISE_MAX_TAPS];   // oy / height
  float influence[DENOISE_MAX_TAPS];
  float r2[DENOISE_MAX_TAPS];
  int runtime;       // 1: a runtime build (every tap, knobs from memory)
  // the runtime builds' knobs, a float each in device memory: samples,
  // distribution_bias, inverse_hue_tolerance (NULL in the static builds)
  const float* samples;
  const float* bias;
  const float* hue;
};

namespace {

constexpr float MIN_LEN = 0x1.197998p-40f;  // float32(1e-12)

// torch.clamp(x, min=lo): NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// the slab row of image row y (any int): clamped at the image's edges, then
// to the rows the launch reads (a no-op for the band's own pixels; it keeps
// the pixels past the band's last row, never stored, inside the slab)
__device__ __forceinline__ int slab_row(const DenoiseArgs& a, int y) {
  return min(max(clampi(y, a.height - 1), a.row_lo), a.row_hi - 1) - a.a;
}

// _length3: sqrt((x*x + y*y) + z*z)
__device__ __forceinline__ float length3(const float* v) {
  return __fsqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// _sample_coords of one output pixel: the clamped neighbours i0, i1 and
// the fractions f, 1 - f of texture coordinate `u` (a tap's offset added)
// over n input pixels
__device__ __forceinline__ void coords(float u, int n, int& i0, int& i1,
                                       float& f, float& g) {
  const float x = u * (float)n - 0.5f;
  const float x0 = floorf(x);
  f = x - x0;
  g = 1.0f - f;
  const int xi = (int)x0;
  i0 = clampi(xi, n - 1);
  i1 = clampi(xi + 1, n - 1);
}

// _lerp2d of one channel: top = p00 * gx + p01 * fx, the same of the lower
// row, then top * gy + bot * fy
__device__ __forceinline__ float row_lerp(float p0, float p1, float fx,
                                          float gx) {
  return p0 * gx + p1 * fx;
}

// bilinear sample of the slab at slab rows (y0, y1), columns (x0, x1)
__device__ __forceinline__ void sample(const DenoiseArgs& a, int y0, int y1,
                                       int x0, int x1, float fx, float gx,
                                       float fy, float gy, float* t) {
  const int64_t w = a.w_in;
  const float* p00 = a.img + ((int64_t)y0 * w + x0) * 3;
  const float* p01 = a.img + ((int64_t)y0 * w + x1) * 3;
  const float* p10 = a.img + ((int64_t)y1 * w + x0) * 3;
  const float* p11 = a.img + ((int64_t)y1 * w + x1) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t[k] = row_lerp(p00[k], p01[k], fx, gx) * gy +
           row_lerp(p10[k], p11[k], fx, gx) * fy;
  }
}

// _pow_clamped(x, e) as ATen computes torch.pow(clamp(x, min=0), e), for
// the branch POW its exponent takes
template <int POW>
__device__ __forceinline__ float pow_clamped(float x, float e) {
  x = clamp_min(x, 0.0f);
  if constexpr (POW == POW_ZERO) return 1.0f;
  else if constexpr (POW == POW_ONE) return x;
  else if constexpr (POW == POW_SQRT) return __fsqrt_rn(x);
  else if constexpr (POW == POW_RSQRT) return rsqrtf(x);
  else if constexpr (POW == POW_RECIPROCAL) return __fdiv_rn(1.0f, x);
  else if constexpr (POW == POW_SQUARE) return x * x;
  else if constexpr (POW == POW_CUBE) return x * x * x;
  else if constexpr (POW == POW_INV_SQUARE) return __fdiv_rn(1.0f, x * x);
  else return powf(x, e);
}

// the taps i with (float)i <= samples: a prefix of the n-tap spiral, none
// for a NaN
__device__ __forceinline__ int live_taps(float samples, int n) {
  if (samples >= (float)(n - 1)) return n;
  if (samples >= 0.0f) return (int)floorf(samples) + 1;
  return 0;
}

// a tap's influence from the knobs (ops.denoise.runtime_influences):
// (1 - 0.5 / (sqrt(s) * sqrt(s)) * pow(max(r2, 0), bias))^3
__device__ __forceinline__ float tap_influence(float samples, float bias,
                                               float r2) {
  const float radius = __fsqrt_rn(samples);
  const float true_radius = __fdiv_rn(0.5f, radius * radius);
  const float p = 1.0f - true_radius * pow_clamped<POW_POWF>(r2, bias);
  return p * p * p;
}

// one output pixel's running state: its centre's length and normal, the
// influence sum and the weighted sums
struct Pixel {
  float len, n0, n1, n2, sum, d0, d1, d2;

  __device__ __forceinline__ void start(const float* centre) {
    len = length3(centre);
    const float cl = clamp_min(len, MIN_LEN);
    n0 = __fdiv_rn(centre[0], cl);
    n1 = __fdiv_rn(centre[1], cl);
    n2 = __fdiv_rn(centre[2], cl);
    sum = 0.0f;
    d0 = 0.0f;
    d1 = 0.0f;
    d2 = 0.0f;
  }

  // add tap `tap` of influence `influence`
  template <int POW>
  __device__ __forceinline__ void add(const float* tap, float influence,
                                      float hue_exp, float sat_exp) {
    const float tap_len = length3(tap);
    const float tl = clamp_min(tap_len, MIN_LEN);
    const float tn0 = __fdiv_rn(tap[0], tl);
    const float tn1 = __fdiv_rn(tap[1], tl);
    const float tn2 = __fdiv_rn(tap[2], tl);
    const float dot = n0 * tn0 + n1 * tn1 + n2 * tn2;
    const float hue = pow_clamped<POW>(0.5f + 0.5f * dot, hue_exp);
    const float sat = pow_clamped<POW_POWF>(1.0f - fabsf(tap_len - len),
                                            sat_exp);
    const float infl = influence * hue * sat;
    sum = sum + infl;
    d0 = d0 + tap[0] * infl;
    d1 = d1 + tap[1] * infl;
    d2 = d2 + tap[2] * infl;
  }

  // a masked tap: its influence is 0, the sums gain tap * 0 (0 unless the
  // tap is NaN or infinite); the influence sum gains +0 and keeps its bits
  __device__ __forceinline__ void mask(const float* tap) {
    d0 = d0 + tap[0] * 0.0f;
    d1 = d1 + tap[1] * 0.0f;
    d2 = d2 + tap[2] * 0.0f;
  }

  __device__ __forceinline__ void store(float* o) const {
    o[0] = __fdiv_rn(d0, sum);
    o[1] = __fdiv_rn(d1, sum);
    o[2] = __fdiv_rn(d2, sum);
  }
};

// The denoiser (SHIFTED or RESAMPLE): one output pixel a thread, row
// r = r0 + (block row) * block_rows + threadIdx.y.
template <int MODE, int POW, bool TILED>
__global__ void __launch_bounds__(TILE_W * MAX_BLOCK_ROWS)
denoise_kernel(const __grid_constant__ DenoiseArgs a) {
  extern __shared__ float tile[];  // three channel planes (tiled build)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile_h = blockDim.y;
  const int cb = blockIdx.x * TILE_W;
  const int rb = a.r0 + blockIdx.y * tile_h;
  const int c = cb + tx;
  const int r = rb + ty;
  const int wmax = a.w_in - 1;
  const int sw = TILE_W + a.hx1 - a.hx0;  // the tile's row pitch
  const int plane = sw * (tile_h + a.hy1 - a.hy0);

  if constexpr (TILED) {
    // the output tile and its halo, clamped at load time; tile row s,
    // column x hold image row rb + hy0 + s, column cb + hx0 + x
    for (int s = ty; s < tile_h + a.hy1 - a.hy0; s += blockDim.y) {
      const float* src =
          a.img + (int64_t)slab_row(a, rb + a.hy0 + s) * a.w_in * 3;
      for (int x = tx; x < sw; x += TILE_W) {
        const float* p = src + clampi(cb + a.hx0 + x, wmax) * 3;
        const int at = s * sw + x;
        tile[at] = p[0];
        tile[plane + at] = p[1];
        tile[2 * plane + at] = p[2];
      }
    }
    __syncthreads();
  }

  // the tile word of this thread's tap offset (0, 0): a tap adds its
  // uniform offset y0 * sw + x0
  const float* base = tile + (ty - a.hy0) * sw + tx - a.hx0;
  Pixel px;
  float u = 0.0f, v = 0.0f;
  {
    float centre[3];
    if constexpr (MODE == SHIFTED && TILED) {
      centre[0] = base[0];
      centre[1] = base[plane];
      centre[2] = base[2 * plane];
    } else if constexpr (MODE == SHIFTED) {
      const float* p =
          a.img + ((int64_t)slab_row(a, r) * a.w_in + clampi(c, wmax)) * 3;
      centre[0] = p[0];
      centre[1] = p[1];
      centre[2] = p[2];
    } else {
      // the texture coordinates of the output pixel's centre
      u = __fdiv_rn((float)c + 0.5f, (float)a.w_out);
      v = __fdiv_rn((float)r + 0.5f, (float)a.h_out);
      int x0, x1, y0, y1;
      float fx, gx, fy, gy;
      coords(u, a.w_in, x0, x1, fx, gx);
      coords(v, a.height, y0, y1, fy, gy);
      sample(a, slab_row(a, y0), slab_row(a, y1), x0, x1, fx, gx, fy, gy,
             centre);
    }
    px.start(centre);
  }

#pragma unroll 1
  for (int i = 0; i < a.n_taps; ++i) {
    float tap[3];
    if constexpr (MODE == SHIFTED) {
      const float fx = a.fx[i], gx = a.gx[i], fy = a.fy[i], gy = a.gy[i];
      if constexpr (TILED) {
        const float* s0 = base + a.y0[i] * sw + a.x0[i];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* p = s0 + ch * plane;
          tap[ch] = row_lerp(p[0], p[1], fx, gx) * gy +
                    row_lerp(p[sw], p[sw + 1], fx, gx) * fy;
        }
      } else {
        sample(a, slab_row(a, r + a.y0[i]), slab_row(a, r + a.y0[i] + 1),
               clampi(c + a.x0[i], wmax), clampi(c + a.x0[i] + 1, wmax), fx,
               gx, fy, gy, tap);
      }
    } else {
      int x0, x1, y0, y1;
      float fx, gx, fy, gy;
      coords(u + a.ou[i], a.w_in, x0, x1, fx, gx);
      coords(v + a.ov[i], a.height, y0, y1, fy, gy);
      sample(a, slab_row(a, y0), slab_row(a, y1), x0, x1, fx, gx, fy, gy,
             tap);
    }
    px.add<POW>(tap, a.influence[i], a.hue_exp, a.sat_exp);
  }

  if (c >= a.w_out || r >= a.r1) return;
  px.store(a.out + ((int64_t)(r - a.r0) * a.w_out + c) * 3);
}

// The runtime builds of the denoiser (SHIFTED or RESAMPLE): the static
// kernel's pixel-to-thread map and tile, with the knobs read from device
// memory: each block computes the taps' influences into shared memory,
// runs the live taps (index <= samples) with powf's hue and the rest as
// masked taps; the tiled build skips the masked taps of a block whose tile
// holds no value of magnitude 2^126 or more (voted at load time).
template <int MODE, bool TILED>
__global__ void __launch_bounds__(TILE_W * MAX_BLOCK_ROWS)
denoise_kernel_runtime(const __grid_constant__ DenoiseArgs a) {
  extern __shared__ float tile[];  // three channel planes (tiled build)
  __shared__ float influence[DENOISE_MAX_TAPS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile_h = blockDim.y;
  const int cb = blockIdx.x * TILE_W;
  const int rb = a.r0 + blockIdx.y * tile_h;
  const int c = cb + tx;
  const int r = rb + ty;
  const int wmax = a.w_in - 1;
  const int sw = TILE_W + a.hx1 - a.hx0;  // the tile's row pitch
  const int plane = sw * (tile_h + a.hy1 - a.hy0);

  const float samples = *a.samples;
  const float hue_exp = *a.hue;
  const int live = live_taps(samples, a.n_taps);
  {
    const float bias = *a.bias;
    for (int i = ty * TILE_W + tx; i < a.n_taps; i += TILE_W * tile_h) {
      influence[i] = tap_influence(samples, bias, a.r2[i]);
    }
  }

  int nonfinite = 1;  // whether a masked tap may add a NaN
  if constexpr (TILED) {
    // the output tile and its halo, clamped at load time, as the static
    // kernel's, and the vote
    bool large = false;
    for (int s = ty; s < tile_h + a.hy1 - a.hy0; s += blockDim.y) {
      const float* src =
          a.img + (int64_t)slab_row(a, rb + a.hy0 + s) * a.w_in * 3;
      for (int x = tx; x < sw; x += TILE_W) {
        const float* p = src + clampi(cb + a.hx0 + x, wmax) * 3;
        const int at = s * sw + x;
        tile[at] = p[0];
        tile[plane + at] = p[1];
        tile[2 * plane + at] = p[2];
        large = large || !(fabsf(p[0]) < FINITE_TAPS) ||
                !(fabsf(p[1]) < FINITE_TAPS) || !(fabsf(p[2]) < FINITE_TAPS);
      }
    }
    nonfinite = __syncthreads_or(large);
  } else {
    __syncthreads();  // the influences
  }

  const float* base = tile + (ty - a.hy0) * sw + tx - a.hx0;
  Pixel px;
  float u = 0.0f, v = 0.0f;
  {
    float centre[3];
    if constexpr (MODE == SHIFTED && TILED) {
      centre[0] = base[0];
      centre[1] = base[plane];
      centre[2] = base[2 * plane];
    } else if constexpr (MODE == SHIFTED) {
      const float* p =
          a.img + ((int64_t)slab_row(a, r) * a.w_in + clampi(c, wmax)) * 3;
      centre[0] = p[0];
      centre[1] = p[1];
      centre[2] = p[2];
    } else {
      u = __fdiv_rn((float)c + 0.5f, (float)a.w_out);
      v = __fdiv_rn((float)r + 0.5f, (float)a.h_out);
      int x0, x1, y0, y1;
      float fx, gx, fy, gy;
      coords(u, a.w_in, x0, x1, fx, gx);
      coords(v, a.height, y0, y1, fy, gy);
      sample(a, slab_row(a, y0), slab_row(a, y1), x0, x1, fx, gx, fy, gy,
             centre);
    }
    px.start(centre);
  }

  // tap i's bilinear sample, as the static kernel's loop takes it
  auto tap_at = [&](int i, float* tap) {
    if constexpr (MODE == SHIFTED) {
      const float fx = a.fx[i], gx = a.gx[i], fy = a.fy[i], gy = a.gy[i];
      if constexpr (TILED) {
        const float* s0 = base + a.y0[i] * sw + a.x0[i];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* p = s0 + ch * plane;
          tap[ch] = row_lerp(p[0], p[1], fx, gx) * gy +
                    row_lerp(p[sw], p[sw + 1], fx, gx) * fy;
        }
      } else {
        sample(a, slab_row(a, r + a.y0[i]), slab_row(a, r + a.y0[i] + 1),
               clampi(c + a.x0[i], wmax), clampi(c + a.x0[i] + 1, wmax), fx,
               gx, fy, gy, tap);
      }
    } else {
      int x0, x1, y0, y1;
      float fx, gx, fy, gy;
      coords(u + a.ou[i], a.w_in, x0, x1, fx, gx);
      coords(v + a.ov[i], a.height, y0, y1, fy, gy);
      sample(a, slab_row(a, y0), slab_row(a, y1), x0, x1, fx, gx, fy, gy,
             tap);
    }
  };

#pragma unroll 1
  for (int i = 0; i < live; ++i) {
    float tap[3];
    tap_at(i, tap);
    px.add<POW_POWF>(tap, influence[i], hue_exp, a.sat_exp);
  }
  if (nonfinite) {
#pragma unroll 1
    for (int i = live; i < a.n_taps; ++i) {
      float tap[3];
      tap_at(i, tap);
      px.mask(tap);
    }
  }

  if (c >= a.w_out || r >= a.r1) return;
  px.store(a.out + ((int64_t)(r - a.r0) * a.w_out + c) * 3);
}

// The resample alone: one thread an output pixel.
__global__ void __launch_bounds__(TILE_W * MAX_BLOCK_ROWS)
resample_kernel(const __grid_constant__ DenoiseArgs a) {
  const int c = blockIdx.x * TILE_W + threadIdx.x;
  const int r = a.r0 + blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= a.w_out || r >= a.r1) return;
  const float u = __fdiv_rn((float)c + 0.5f, (float)a.w_out);
  const float v = __fdiv_rn((float)r + 0.5f, (float)a.h_out);
  int x0, x1, y0, y1;
  float fx, gx, fy, gy;
  coords(u, a.w_in, x0, x1, fx, gx);
  coords(v, a.height, y0, y1, fy, gy);
  // sampled into registers first: a store between the loads would order
  // them (the output may alias the image, as far as the compiler knows)
  float t[3];
  sample(a, y0 - a.a, y1 - a.a, x0, x1, fx, gx, fy, gy, t);
  float* o = a.out + ((int64_t)(r - a.r0) * a.w_out + c) * 3;
  o[0] = t[0];
  o[1] = t[1];
  o[2] = t[2];
}

using Kernel = void (*)(DenoiseArgs);

template <int MODE, bool TILED>
Kernel build(int pow) {
  switch (pow) {
    case POW_ZERO: return denoise_kernel<MODE, POW_ZERO, TILED>;
    case POW_ONE: return denoise_kernel<MODE, POW_ONE, TILED>;
    case POW_SQRT: return denoise_kernel<MODE, POW_SQRT, TILED>;
    case POW_RSQRT: return denoise_kernel<MODE, POW_RSQRT, TILED>;
    case POW_RECIPROCAL: return denoise_kernel<MODE, POW_RECIPROCAL, TILED>;
    case POW_SQUARE: return denoise_kernel<MODE, POW_SQUARE, TILED>;
    case POW_CUBE: return denoise_kernel<MODE, POW_CUBE, TILED>;
    case POW_INV_SQUARE: return denoise_kernel<MODE, POW_INV_SQUARE, TILED>;
    default: return denoise_kernel<MODE, POW_POWF, TILED>;
  }
}

// The build `args` names (mode, runtime or hue_pow, tiled) in `k`, its
// shared memory opted into; cudaSuccess or the error.
cudaError_t pick(const DenoiseArgs& a, Kernel& k) {
  if (a.block_rows < 1 || a.block_rows > MAX_BLOCK_ROWS) {
    return cudaErrorInvalidValue;
  }
  if (a.runtime && a.mode != RESAMPLE_ONLY) {
    k = a.mode == RESAMPLE ? denoise_kernel_runtime<RESAMPLE, false>
        : a.tiled          ? denoise_kernel_runtime<SHIFTED, true>
                           : denoise_kernel_runtime<SHIFTED, false>;
  } else {
    k = a.mode == RESAMPLE_ONLY ? resample_kernel
        : a.mode == RESAMPLE    ? build<RESAMPLE, false>(a.hue_pow)
        : a.tiled               ? build<SHIFTED, true>(a.hue_pow)
                                : build<SHIFTED, false>(a.hue_pow);
  }
  if (a.smem + (a.runtime ? RUNTIME_SMEM : 0) > STATIC_SMEM) {
    return cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  }
  return cudaSuccess;
}

}  // namespace

// Launches the build `args` names in blocks of TILE_W x block_rows threads
// with its shared memory; returns cudaGetLastError(). A runtime build's
// launch holds the knobs' addresses, not their values.
extern "C" int zvt_denoise(const DenoiseArgs* args, void* stream) {
  const int rows = args->r1 - args->r0;
  if (rows <= 0 || args->w_out <= 0) return (int)cudaGetLastError();
  if (args->runtime && (!args->samples || !args->bias || !args->hue)) {
    return (int)cudaErrorInvalidValue;
  }
  Kernel k;
  const cudaError_t e = pick(*args, k);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((args->w_out + TILE_W - 1) / TILE_W,
                  (rows + args->block_rows - 1) / args->block_rows);
  k<<<grid, dim3(TILE_W, args->block_rows), args->smem,
      (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// The blocks an SM holds of the build `args` names at its block shape and
// shared memory, as the runtime reckons them, in `blocks`.
extern "C" int zvt_denoise_occupancy(const DenoiseArgs* args, int* blocks) {
  Kernel k;
  cudaError_t e = pick(*args, k);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k, TILE_W * args->block_rows, args->smem);
  }
  return (int)e;
}
