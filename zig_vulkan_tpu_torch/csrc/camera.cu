// Kernel C: the camera rays of a frame's wavefront, normalized.
//
// Replaces the XLA fusion of zig_vulkan_tpu/ops/trace.py:_camera_rays_soa
// (per-pixel jittered rays, brick_raytracer.comp:162-171 + CameraGetRay
// :474-477), the concatenation of the spp samples in render_rows and the
// normalization at the top of _ray_color_soa. The plain torch version is
// zig_vulkan_tpu_torch/ops/shade.py:camera_rays_plain.
//
// Lane i of the spp * rows * width lanes is sample i / (rows * width),
// pixel i % (rows * width) in row-major order: the order of the samples'
// concatenation. Each lane writes its origin (the camera origin, as
// contiguous arrays: kernel A takes no expanded views) and its direction,
// normalized once; with sun targets it also writes the target of the
// lane's sun ray (trace.sun_targets), which the sun_in_kernel build of
// kernel A reads at the first bounce level. The camera basis, the sample
// base, the sun position and radius are read on the device when they are
// given as device pointers (the engine's push constants), so a frame reads
// nothing back to the host.
//
// What bounds it on an H100: the bytes it writes, 24 a lane (36 with sun
// targets); it reads only the 12-float basis. The hashes are about 60
// operations a lane, far below the card's float32 rate.
//
// What the design does about it: one thread a lane, the stores of a warp to
// 32 consecutive floats of each output array, so every store is a full,
// coalesced 128-byte line; no intermediate goes to device memory (the torch
// version writes and reads some 40 temporaries a lane).
//
// Float parity: built with --fmad=false and without fast math; every
// expression keeps the torch version's operation order.

#include "shading.cuh"

// One launch's arguments; mirrored by _build.CameraArgs.
struct CameraArgs {
  const float* origin;      // f32[3] each, on the device
  const float* horizontal;
  const float* vertical;
  const float* lower_left;
  const float* base_ptr;    // the 0-d sample base, or NULL: `base`
  const float* sun_p_ptr;   // f32[3], or NULL: `sun_p`
  const float* radius_ptr;  // 0-d, or NULL: `radius`
  float* ox;
  float* oy;
  float* oz;
  float* dx;
  float* dy;
  float* dz;
  float* tx;                // NULL: no sun targets
  float* ty;
  float* tz;
  int64_t n;                // spp * rows * width lanes
  int width;
  int rows;
  int spp;
  float row0;               // the band's first row, as float32
  float w1;                 // float32(width - 1)
  float h1;                 // float32(height - 1) of the whole frame
  float base;
  float sun_p[3];
  float radius;
};

namespace {

constexpr int THREADS = 256;
constexpr float JITTER = 0x1.99999ap-3f;  // float32(0.2)

__global__ void __launch_bounds__(THREADS)
camera_rays_kernel(const CameraArgs a) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const int64_t per_sample = (int64_t)a.rows * a.width;
  const int64_t s = i / per_sample;
  const int64_t j = i - s * per_sample;
  const int64_t row = j / a.width;
  const float xs = (float)(j - row * a.width);
  const float ys = (float)row + a.row0;
  // the sample's jitter seed: sample_base + s in float32
  const float seed = zvt::frame_value(a.base_ptr, a.base, 0) + (float)s;
  const float sf = JITTER * (seed > 0.0f ? 1.0f : 0.0f);
  const float noise_x = zvt::hash12((xs + seed) * sf, ys * sf);
  const float noise_y = zvt::hash12(xs * sf, (ys + seed) * sf);
  const float u = __fdiv_rn(xs + noise_x, a.w1);
  const float v = __fdiv_rn(ys + noise_y, a.h1);
  const float* h = a.horizontal;
  const float* ll = a.lower_left;
  const float* vv = a.vertical;
  const float* o = a.origin;
  float rx = h[0] * u + ll[0] + vv[0] * v - o[0];
  float ry = h[1] * u + ll[1] + vv[1] * v - o[1];
  float rz = h[2] * u + ll[2] + vv[2] * v - o[2];
  zvt::norm3(rx, ry, rz);
  a.ox[i] = o[0];
  a.oy[i] = o[1];
  a.oz[i] = o[2];
  a.dx[i] = rx;
  a.dy[i] = ry;
  a.dz[i] = rz;
  if (a.tx != nullptr) {
    const float sun_p[3] = {zvt::frame_value(a.sun_p_ptr, a.sun_p[0], 0),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[1], 1),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[2], 2)};
    float tx, ty, tz;
    zvt::sun_target(rx, ry, rz, sun_p,
                    zvt::frame_value(a.radius_ptr, a.radius, 0), tx, ty, tz);
    a.tx[i] = tx;
    a.ty[i] = ty;
    a.tz[i] = tz;
  }
}

}  // namespace

extern "C" int zvt_camera_rays(const CameraArgs* args, void* stream) {
  if (args->n > 0) {
    const int64_t blocks = (args->n + THREADS - 1) / THREADS;
    camera_rays_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
