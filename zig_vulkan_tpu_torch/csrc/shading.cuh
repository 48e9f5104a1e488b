// Device functions shared by kernels C (camera.cu) and D (shade.cu): the
// shader-hash random functions of zig_vulkan_tpu_torch/ops/rng.py and the
// vector helpers of zig_vulkan_tpu_torch/ops/trace.py, written out one
// float32 rounding per operation in the torch versions' order.
//
// Float parity: the files that include this one build with --fmad=false
// and without fast math, so `a * b + c` is two roundings, division and
// square root are IEEE. The constants are the float32 values the torch
// versions round theirs to (`float(np.float32(c))`), written as hex floats
// so that no decimal literal is rounded twice.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zvt {

// ops/rng.py's _INV_TWO_PI, _TWO_PI and _SIN_COEFFS
constexpr float INV_TWO_PI = 0x1.45f306p-3f;
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float SIN_C0 = 0x1p+0f;
constexpr float SIN_C1 = -0x1.555554p-3f;
constexpr float SIN_C2 = 0x1.1110e8p-7f;
constexpr float SIN_C3 = -0x1.a014dcp-13f;
constexpr float SIN_C4 = 0x1.71883ep-19f;
constexpr float SIN_C5 = -0x1.a85ef2p-26f;
constexpr float SIN_C6 = 0x1.299a08p-33f;
// rand1, rand2 and hash12's multipliers
constexpr float RAND1_IN = 0x1.6d621ap+6f;    // 91.3458
constexpr float RAND1_OUT = 0x1.72bb18p+15f;  // 47453.5453
constexpr float RAND2_X = 0x1.9fac72p+3f;     // 12.9898
constexpr float RAND2_Y = 0x1.38ee98p+6f;     // 78.233
constexpr float RAND2_OUT = 0x1.55dd18p+15f;  // 43758.5453
constexpr float HASH12_K = 0x1.a64c3p-4f;     // 0.1031
constexpr float HASH12_C = 0x1.0aa3d8p+5f;    // 33.33

// torch.full((), float("nan")) as float32: the quiet NaN 0x7fc00000
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float fract(float x) { return x - floorf(x); }

// rng.hsin: range reduction, then the odd polynomial in Horner order
__device__ __forceinline__ float hsin(float x) {
  const float q = floorf(x * INV_TWO_PI + 0.5f);
  const float r = x - q * TWO_PI;
  const float r2 = r * r;
  float acc = SIN_C6;
  acc = acc * r2 + SIN_C5;
  acc = acc * r2 + SIN_C4;
  acc = acc * r2 + SIN_C3;
  acc = acc * r2 + SIN_C2;
  acc = acc * r2 + SIN_C1;
  acc = acc * r2 + SIN_C0;
  return r * acc;
}

// rng.rand1
__device__ __forceinline__ float rand1(float co) {
  return fract(hsin(co * RAND1_IN) * RAND1_OUT);
}

// rng.rand2 of (x, y)
__device__ __forceinline__ float rand2(float x, float y) {
  const float d = x * RAND2_X + y * RAND2_Y;
  return fract(hsin(d) * RAND2_OUT);
}

// rng.rand3 of (x, y, z)
__device__ __forceinline__ float rand3(float x, float y, float z) {
  const float r = rand1(z);
  return rand2(x + r, y + r);
}

// rng.rand_vec3_range of (x, y) with lo and span = hi - lo: chained
// dependent hashes, each lo + span * rand2
__device__ __forceinline__ void rand_vec3_range(float x, float y, float lo,
                                                float span, float& ox,
                                                float& oy, float& oz) {
  ox = lo + span * rand2(x, y);
  oy = lo + span * rand2(x + ox, y + ox);
  oz = lo + span * rand2(x + oy, y + oy);
}

// rng.hash12 of (x, y)
__device__ __forceinline__ float hash12(float x, float y) {
  float p3x = fract(x * HASH12_K);
  float p3y = fract(y * HASH12_K);
  float p3z = fract(x * HASH12_K);
  const float d = p3x * (p3y + HASH12_C) + p3y * (p3z + HASH12_C) +
                  p3z * (p3x + HASH12_C);
  p3x = p3x + d;
  p3y = p3y + d;
  p3z = p3z + d;
  return fract((p3x + p3y) * p3z);
}

// trace._norm3: x * (1 / sqrt(x*x + y*y + z*z)), the root and the
// reciprocal each correctly rounded (never rsqrtf)
__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = __frcp_rn(__fsqrt_rn(x * x + y * y + z * z));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// trace.sun_targets of a direction: the jittered sun-disk target, seeded by
// the direction, lo = -radius and span = radius - lo as rand2_range has them
__device__ __forceinline__ void sun_target(float dx, float dy, float dz,
                                           const float* sun_p, float radius,
                                           float& tx, float& ty, float& tz) {
  const float lo = -radius;
  float jx, jy, jz;
  rand_vec3_range(dx + dz, dy + dz, lo, radius - lo, jx, jy, jz);
  tx = sun_p[0] + jx;
  ty = sun_p[1] + jy;
  tz = sun_p[2] + jz;
}

// a per-frame value: on the device where the pointer is given (the
// engine's push constants), else the host value passed by value
__device__ __forceinline__ float frame_value(const float* ptr, float value,
                                             int i) {
  return ptr != nullptr ? ptr[i] : value;
}

}  // namespace zvt
