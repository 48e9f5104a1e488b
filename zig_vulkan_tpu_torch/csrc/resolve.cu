// Kernel E: the resolve of a traced wavefront into pixels.
//
// Replaces the XLA fusions of the end of zig_vulkan_tpu/ops/trace.py:
// _ray_color_soa (the background of never-hit rays and the c / (c + 1) tone
// map, trace.py:1298-1312) and of render_rows (trace.py:1382-1470: the sum
// of the spp samples, the division by spp and the square root). The plain
// torch version is zig_vulkan_tpu_torch/ops/shade.py:resolve_plain.
//
// One thread a pixel of the `m` lanes of one sample: for each sample s in
// order it takes lane s * m + j, adds the last bounce level's pending lit
// term (where kernel D left one and the shadow ray was not occluded) and
// the sky of a ray that never hit, tone-maps, and adds the sample to the
// running sum (sample 0, then + sample 1, ...); it then writes
// sqrt(sum / spp) as f32[m, 3]. Without `gamma` it writes each lane's
// tone-mapped colour (spp 1: `ray_color`'s per-lane result).
//
// The sky reads the ray's final direction: a ray that never hit a known
// material never bounced, so its direction is the camera ray's, the one
// the torch version keeps for it (trace.py:1117).
//
// What bounds it on an H100: memory traffic, 20 bytes a lane read (colour,
// loop count, direction's y; 33 with a pending sun term) and 12 bytes a
// pixel written.
//
// What the design does about it: one pass over the lanes with every
// intermediate in registers (the torch version writes and reads some 30
// temporaries a lane); a warp reads 32 consecutive lanes of each array and
// writes 384 consecutive bytes.
//
// Float parity: built with --fmad=false and without fast math; the
// division by spp is a true division, and the sum keeps the torch version's
// order.

#include "shading.cuh"

// One launch's arguments; mirrored by _build.ResolveArgs.
struct ResolveArgs {
  const float* cr;
  const float* cg;
  const float* cb;
  const int32_t* loop_count;
  const float* dy;
  const float* pr;                // the pending lit term, or NULL
  const float* pg;
  const float* pb;
  const uint8_t* occluded;        // its shadow hits (with `pr`)
  const float* sun_c_ptr;         // f32[3] on the device, or NULL: `sun_c`
  float* out;                     // f32[m, 3]
  int64_t m;                      // lanes of one sample: pixels
  int spp;
  int sun;                        // 1: the sky is lit by the sun colour
  int gamma;                      // 1: sum, / spp, sqrt; 0: per lane
  float sun_c[3];
};

namespace {

constexpr int THREADS = 256;
constexpr float SKY_G = 0x1.666666p-1f;  // float32(0.7)

__global__ void __launch_bounds__(THREADS) resolve_kernel(const ResolveArgs a) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.m) return;
  float sc0 = 1.0f, sc1 = 1.0f, sc2 = 1.0f;
  if (a.sun) {
    sc0 = zvt::frame_value(a.sun_c_ptr, a.sun_c[0], 0);
    sc1 = zvt::frame_value(a.sun_c_ptr, a.sun_c[1], 1);
    sc2 = zvt::frame_value(a.sun_c_ptr, a.sun_c[2], 2);
  }
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  for (int s = 0; s < a.spp; ++s) {
    const int64_t i = (int64_t)s * a.m + j;
    float cr = a.cr[i], cg = a.cg[i], cb = a.cb[i];
    if (a.pr != nullptr) {
      const bool occ = a.occluded[i] != 0;
      cr = cr + (occ ? 0.0f : a.pr[i]);
      cg = cg + (occ ? 0.0f : a.pg[i]);
      cb = cb + (occ ? 0.0f : a.pb[i]);
    }
    // background for never-hit rays (brick_raytracer.comp:260-262)
    const bool never = a.loop_count[i] == 0;
    const float t = 0.5f * (a.dy[i] + 1.0f);
    float bgr = (1.0f - t) + t * 0.5f;
    float bgg = (1.0f - t) + t * SKY_G;
    float bgb = (1.0f - t) + t * 1.0f;
    if (a.sun) {
      bgr = bgr * sc0;
      bgg = bgg * sc1;
      bgb = bgb * sc2;
    }
    cr = cr + (never ? bgr : 0.0f);
    cg = cg + (never ? bgg : 0.0f);
    cb = cb + (never ? bgb : 0.0f);
    // color / (color + 1) tone map (brick_raytracer.comp:264)
    cr = __fdiv_rn(cr, cr + 1.0f);
    cg = __fdiv_rn(cg, cg + 1.0f);
    cb = __fdiv_rn(cb, cb + 1.0f);
    if (s == 0) {
      sr = cr;
      sg = cg;
      sb = cb;
    } else {
      sr = sr + cr;
      sg = sg + cg;
      sb = sb + cb;
    }
  }
  if (a.gamma) {
    const float spp = (float)a.spp;
    sr = __fsqrt_rn(__fdiv_rn(sr, spp));
    sg = __fsqrt_rn(__fdiv_rn(sg, spp));
    sb = __fsqrt_rn(__fdiv_rn(sb, spp));
  }
  float* o = a.out + 3 * j;
  o[0] = sr;
  o[1] = sg;
  o[2] = sb;
}

}  // namespace

extern "C" int zvt_resolve(const ResolveArgs* args, void* stream) {
  if (args->m > 0) {
    const int64_t blocks = (args->m + THREADS - 1) / THREADS;
    resolve_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        *args);
  }
  return (int)cudaGetLastError();
}
