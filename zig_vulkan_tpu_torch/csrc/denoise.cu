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
// on the host, one row a live tap in float32 as the torch version computes
// its scalars (`ops.denoise.spiral_taps`), and passes them by value in the
// argument struct: a captured graph holds them with its launch. The slab
// `img` holds image rows [a, a + rows_in) of an image of `height` rows;
// output rows [r0, r1) are written. Row indices are clamped at the image's
// edges and then shifted into the slab, so a band of rows equals the same
// rows of the whole image's result bit for bit.
//
// What bounds it on an H100: operations. A tap is about 60 float operations
// a pixel (the bilinear sample, its length and normal, the dot product, the
// running sums) and two calls of powf; 21 taps at the defaults. The bytes
// are 12 a pixel read and 12 written.
//
// What the design does about it: one thread an output pixel in blocks of
// 32 x 8, the taps in a loop over the argument struct (a warp-uniform read
// of the constant bank, `__grid_constant__`), every intermediate in
// registers, where the torch version runs some 30 launches a tap over
// whole-image temporaries. A warp's reads of a tap are a row of 33
// neighbouring pixels, served by L1 and L2 (a 1080p image is 24.9 MB,
// under the 50 MB L2); no shared-memory tiling yet.
//
// Float parity: built with --fmad=false and without fast math, each torch
// operation one rounding in the torch version's order; division and square
// root are IEEE (__fdiv_rn, __fsqrt_rn); the clamps keep NaN as
// torch.clamp does; the sums start at +0.0 and add tap 0 first; the hue's
// power takes the branch ATen's tensor-scalar pow takes for its exponent
// (0 and 1, then 0.5, -0.5, -1, 2, 3, -2 as special cases, otherwise powf).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int DENOISE_MAX_TAPS = 33;  // ops.denoise.MAX_RUNTIME_SAMPLES + 1

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
  int w_out;
  int h_out;
  int r0;            // output rows [r0, r1)
  int r1;
  int mode;
  int hue_pow;       // POW_*
  int n_taps;        // live taps, in spiral order
  float hue_exp;     // inverse_hue_tolerance
  float sat_exp;     // 8: the saturation's exponent, a runtime value as
                     // torch's pow kernel has it
  // a row a tap: the integer shift and its fractions (SHIFTED), the
  // texture-coordinate offsets (RESAMPLE), pixel_influence cubed
  int x0[DENOISE_MAX_TAPS];
  int y0[DENOISE_MAX_TAPS];
  float fx[DENOISE_MAX_TAPS];
  float fy[DENOISE_MAX_TAPS];
  float gx[DENOISE_MAX_TAPS];   // 1 - fx
  float gy[DENOISE_MAX_TAPS];   // 1 - fy
  float ou[DENOISE_MAX_TAPS];   // ox / w_in
  float ov[DENOISE_MAX_TAPS];   // oy / height
  float influence[DENOISE_MAX_TAPS];
};

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr float MIN_LEN = 0x1.197998p-40f;  // float32(1e-12)

// torch.clamp(x, min=lo): NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// _length3: sqrt((x*x + y*y) + z*z)
__device__ __forceinline__ float length3(const float* v) {
  return __fsqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// _lerp2d of the four neighbours' channel k
__device__ __forceinline__ float lerp2d(const float* p00, const float* p01,
                                        const float* p10, const float* p11,
                                        int k, float fx, float gx, float fy,
                                        float gy) {
  const float top = p00[k] * gx + p01[k] * fx;
  const float bot = p10[k] * gx + p11[k] * fx;
  return top * gy + bot * fy;
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

// bilinear sample of the slab at rows (y0, y1) and columns (x0, x1)
__device__ __forceinline__ void sample(const DenoiseArgs& a, int y0, int y1,
                                       int x0, int x1, float fx, float gx,
                                       float fy, float gy, float* t) {
  const int64_t w = a.w_in;
  const float* p00 = a.img + ((int64_t)y0 * w + x0) * 3;
  const float* p01 = a.img + ((int64_t)y0 * w + x1) * 3;
  const float* p10 = a.img + ((int64_t)y1 * w + x0) * 3;
  const float* p11 = a.img + ((int64_t)y1 * w + x1) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = lerp2d(p00, p01, p10, p11, k, fx, gx, fy, gy);
}

// _pow_clamped(x, e) as ATen computes torch.pow(clamp(x, min=0), e)
__device__ __forceinline__ float pow_clamped(float x, int branch, float e) {
  x = clamp_min(x, 0.0f);
  switch (branch) {
    case POW_ZERO: return 1.0f;
    case POW_ONE: return x;
    case POW_SQRT: return __fsqrt_rn(x);
    case POW_RSQRT: return rsqrtf(x);
    case POW_RECIPROCAL: return __fdiv_rn(1.0f, x);
    case POW_SQUARE: return x * x;
    case POW_CUBE: return x * x * x;
    case POW_INV_SQUARE: return __fdiv_rn(1.0f, x * x);
    default: return powf(x, e);
  }
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
denoise_kernel(const __grid_constant__ DenoiseArgs a) {
  const int c = blockIdx.x * BLOCK_X + threadIdx.x;
  const int r = a.r0 + blockIdx.y * BLOCK_Y + threadIdx.y;
  if (c >= a.w_out || r >= a.r1) return;
  const int hmax = a.height - 1, wmax = a.w_in - 1;

  // the texture coordinates of the output pixel's centre
  float u = 0.0f, v = 0.0f;
  float centre[3];
  if (a.mode == SHIFTED) {
    const float* p = a.img + ((int64_t)(r - a.a) * a.w_in + c) * 3;
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
    sample(a, y0 - a.a, y1 - a.a, x0, x1, fx, gx, fy, gy, centre);
  }
  float* o = a.out + ((int64_t)(r - a.r0) * a.w_out + c) * 3;
  if (a.mode == RESAMPLE_ONLY) {
    o[0] = centre[0];
    o[1] = centre[1];
    o[2] = centre[2];
    return;
  }

  const float centre_len = length3(centre);
  const float cl = clamp_min(centre_len, MIN_LEN);
  const float cn0 = __fdiv_rn(centre[0], cl);
  const float cn1 = __fdiv_rn(centre[1], cl);
  const float cn2 = __fdiv_rn(centre[2], cl);

  float influence_sum = 0.0f;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  for (int i = 0; i < a.n_taps; ++i) {
    float tap[3];
    if (a.mode == SHIFTED) {
      const int y0 = clampi(r + a.y0[i], hmax) - a.a;
      const int y1 = clampi(r + a.y0[i] + 1, hmax) - a.a;
      const int x0 = clampi(c + a.x0[i], wmax);
      const int x1 = clampi(c + a.x0[i] + 1, wmax);
      sample(a, y0, y1, x0, x1, a.fx[i], a.gx[i], a.fy[i], a.gy[i], tap);
    } else {
      int x0, x1, y0, y1;
      float fx, gx, fy, gy;
      coords(u + a.ou[i], a.w_in, x0, x1, fx, gx);
      coords(v + a.ov[i], a.height, y0, y1, fy, gy);
      sample(a, y0 - a.a, y1 - a.a, x0, x1, fx, gx, fy, gy, tap);
    }
    const float tap_len = length3(tap);
    const float tl = clamp_min(tap_len, MIN_LEN);
    const float tn0 = __fdiv_rn(tap[0], tl);
    const float tn1 = __fdiv_rn(tap[1], tl);
    const float tn2 = __fdiv_rn(tap[2], tl);
    const float dot = cn0 * tn0 + cn1 * tn1 + cn2 * tn2;
    const float hue = pow_clamped(0.5f + 0.5f * dot, a.hue_pow, a.hue_exp);
    const float sat = pow_clamped(1.0f - fabsf(tap_len - centre_len),
                                  POW_POWF, a.sat_exp);
    const float infl = a.influence[i] * hue * sat;
    influence_sum = influence_sum + infl;
    d0 = d0 + tap[0] * infl;
    d1 = d1 + tap[1] * infl;
    d2 = d2 + tap[2] * infl;
  }
  o[0] = __fdiv_rn(d0, influence_sum);
  o[1] = __fdiv_rn(d1, influence_sum);
  o[2] = __fdiv_rn(d2, influence_sum);
}

}  // namespace

extern "C" int zvt_denoise(const DenoiseArgs* args, void* stream) {
  const int rows = args->r1 - args->r0;
  if (rows > 0 && args->w_out > 0) {
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((args->w_out + BLOCK_X - 1) / BLOCK_X,
                    (rows + BLOCK_Y - 1) / BLOCK_Y);
    denoise_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
