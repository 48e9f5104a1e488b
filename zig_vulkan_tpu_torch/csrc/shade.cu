// Kernel D: the shading of one bounce level, one launch a level.
//
// Replaces the XLA fusion of the level body of
// zig_vulkan_tpu/ops/trace.py:_ray_color_soa (trace.py:1141-1297: the
// lambertian, metal and dielectric scatter, the emissive and sun terms and
// the ray-state update, brick_raytracer.comp:203-259, 539-596). The plain
// torch version is zig_vulkan_tpu_torch/ops/shade.py:shade_plain.
//
// A level is: kernel A's scatter launch, kernel B's material lookup, this
// kernel, then (sun on, not traced in kernel A) kernel A's shadow launch.
// This kernel reads kernel A's hit and kernel B's five looked-up values and
// updates the ray state in place: origin, direction, the dielectric state
// (internal reflection, ignore type), the loop count, the bouncing mask and
// the colour. It also writes what the next launches read, so that no other
// work runs between them: the shadow launch's mask (`active`) and
// directions, and the next level's dielectric key and (sun_in_kernel) sun
// targets.
//
// The sun term of a level needs its shadow launch's `occluded`, which runs
// after this kernel. So, with a separate shadow launch, this kernel writes
// the level's lit term as pending (albedo * sun colour where the lane is
// lit by sun or sky, else 0) and the next level's launch (or kernel E after
// the last) adds it, where the shadow ray was not occluded, before its own
// emissive term: the float adds keep the torch version's order per lane
// (colour + emitted, then + lit, level after level). With the sun traced in
// kernel A, `occluded` comes from this level's scatter launch and the lit
// term is added here.
//
// With its queues given, this kernel also appends each lane it leaves
// bouncing to the next level's scatter queue and each lane it marks
// `active` to this level's shadow queue, lane ids of int32 after a count on
// the card that starts the frame at 0 (one atomic a block and queue, the
// block's lanes in lane order): kernel A's later launches and kernel B
// take those queues instead of the whole wavefront, so the shadow launch's
// directions and the next level's key and sun targets are written only for
// the lanes of their queue (the shadow launch's mask for every lane). This
// kernel still reads every lane: a lane outside the last scatter queue is
// not bouncing, so every value of its that kernels A and B left unwritten
// is read under a select that drops it, and a lane outside the last shadow
// queue has a pending term of 0, so its unwritten `occluded` adds +0
// either way.
//
// What bounds it on an H100: memory traffic, about 190 bytes a lane with a
// separate shadow launch (the hit, the five looked-up values, the state
// read and written, the pending term, the shadow directions and the key);
// its four chained RNG hashes and three square roots are some 400 float
// operations a lane, an eighth of what the card could do in that time.
//
// What the design does about it: one thread a lane, every array SoA, so a
// warp's loads and stores of each array are full 128-byte lines; every
// intermediate (the three candidate scatter directions, the random numbers)
// stays in registers, where the torch version writes and reads some 250
// temporaries a lane. The state writes that do not change a lane (origin
// and dielectric state of a lane that did not hit, the direction of a lane
// that stops bouncing) are skipped; they would store the value read.
//
// Float parity: built with --fmad=false and without fast math; every
// expression keeps the torch version's operation order; the clamp before
// the square root keeps a NaN as torch.clamp does; selects never let the
// unselected side's garbage through, as torch.where does not.

#include "shading.cuh"

// One launch's arguments; mirrored by _build.ShadeArgs. Bools are bytes.
struct ShadeArgs {
  // kernel A's hit and kernel B's looked-up values of this level
  const uint8_t* found;
  const float* px;
  const float* py;
  const float* pz;
  const float* nx;
  const float* ny;
  const float* nz;
  const uint8_t* occluded;       // sun traced in kernel A, else NULL
  const float* albedo_r;
  const float* albedo_g;
  const float* albedo_b;
  const float* mtype;
  const float* type_data;
  // the ray state, updated in place
  float* ox;
  float* oy;
  float* oz;
  float* dx;
  float* dy;
  float* dz;
  float* internal_refl;
  int32_t* ignore_type;
  int32_t* loop_count;
  uint8_t* bouncing;
  float* cr;
  float* cg;
  float* cb;
  // the pending lit term (separate shadow launch), read and written
  float* pr;
  float* pg;
  float* pb;
  const uint8_t* prev_occluded;  // the previous level's shadow hits, or NULL
  // outputs for the next launches (NULL: not written)
  uint8_t* active;               // the shadow launch's mask
  float* shx;                    // the shadow launch's directions
  float* shy;
  float* shz;
  float* key;                    // the next level's dielectric key
  float* tx;                     // the next level's sun targets
  float* ty;
  float* tz;
  // per-frame values on the device, or NULL: the host values below
  const float* sun_p_ptr;
  const float* sun_c_ptr;
  const float* radius_ptr;
  // the queues this level fills (NULL: not filled): lane ids and counts
  int32_t* next_queue;           // the lanes left bouncing
  int32_t* next_count;
  int32_t* shadow_queue;         // the lanes marked active
  int32_t* shadow_count;
  int64_t n;
  int sun;                       // SUN_OFF, SUN_PROBE or SUN_DEFERRED
  float sun_p[3];
  float sun_c[3];
  float radius;
};

namespace {

constexpr int THREADS = 256;
constexpr int SUN_OFF = 0;       // no sun: the diffuse term is the albedo
constexpr int SUN_PROBE = 1;     // `occluded` from this level's scatter
constexpr int SUN_DEFERRED = 2;  // a shadow launch follows this kernel
// core/materials.py's material types
constexpr int MAT_LAMBERTIAN = 0;
constexpr int MAT_METAL = 1;
constexpr int MAT_DIELECTRIC = 2;
constexpr int MAT_NONE = 3;
constexpr int MAT_EMISSIVE = 4;
constexpr float LAMBERT = 0x1.99999ap-2f;  // float32(0.4)
constexpr float DIEL = 0x1.99999ap-5f;     // float32(0.05)

// Lane i's shading; sets `bouncing_out` and `active_out` to the lane's new
// bouncing flag and its shadow mask. QUEUED: the launch fills its queues,
// so the shadow directions and the next level's key and sun targets are
// written only for the lanes that their queue holds.
template <bool QUEUED, typename Index>
__device__ __forceinline__ void shade_lane(const ShadeArgs& a, Index i,
                                           bool& bouncing_out,
                                           bool& active_out) {
  const bool active = a.bouncing[i] != 0 && a.found[i] != 0;
  const float ar = a.albedo_r[i], ag = a.albedo_g[i], ab = a.albedo_b[i];
  const float type_data = a.type_data[i];
  const int mtype = (int)a.mtype[i];  // as torch's .to(torch.int32)
  const bool is_emissive = mtype == MAT_EMISSIVE;
  const bool known = mtype <= MAT_DIELECTRIC || is_emissive;
  a.loop_count[i] = a.loop_count[i] + ((active && known) ? 1 : 0);

  const float px = a.px[i], py = a.py[i], pz = a.pz[i];
  const float nx = a.nx[i], ny = a.ny[i], nz = a.nz[i];
  const float dx = a.dx[i], dy = a.dy[i], dz = a.dz[i];
  const float internal = a.internal_refl[i];
  const float cox = px + pz;
  const float coy = py + pz;

  // lambertian (brick_raytracer.comp:539-544)
  float lamx, lamy, lamz;
  zvt::rand_vec3_range(cox, coy, -LAMBERT, LAMBERT - -LAMBERT, lamx, lamy,
                       lamz);
  lamx = nx + lamx;
  lamy = ny + lamy;
  lamz = nz + lamz;
  zvt::norm3(lamx, lamy, lamz);

  // metal (brick_raytracer.comp:546-551)
  const float dn = zvt::dot3(dx, dy, dz, nx, ny, nz);
  const float fuzz_lo = -type_data;
  float metx, mety, metz;
  zvt::rand_vec3_range(cox, coy, fuzz_lo, type_data - fuzz_lo, metx, mety,
                       metz);
  metx = (dx - 2.0f * dn * nx) + metx;
  mety = (dy - 2.0f * dn * ny) + mety;
  metz = (dz - 2.0f * dn * nz) + metz;
  zvt::norm3(metx, mety, metz);
  const bool met_ok = zvt::dot3(metx, mety, metz, nx, ny, nz) > 0.0f;

  // dielectric (brick_raytracer.comp:576-596)
  float dnx, dny, dnz;
  zvt::rand_vec3_range(cox, coy, -DIEL, DIEL - -DIEL, dnx, dny, dnz);
  dnx = nx + dnx;
  dny = ny + dny;
  dnz = nz + dnz;
  zvt::norm3(dnx, dny, dnz);
  const float ir = type_data;
  const float eta = __fdiv_rn(ir, internal);
  const float c1 = -zvt::dot3(dx, dy, dz, dnx, dny, dnz);
  const float w = eta * c1;
  const float c2m = (w - eta) * (w + eta);
  const bool should_refract = c2m >= -1.0f;
  float root = 1.0f + c2m;
  root = root < 0.0f ? 0.0f : root;  // torch.clamp(min=0): NaN stays NaN
  const float wk = w - __fsqrt_rn(root);
  const bool do_refract = should_refract && zvt::rand3(px, py, pz) > 0.5f;
  const float ddn = zvt::dot3(dx, dy, dz, dnx, dny, dnz);
  float diex = do_refract ? eta * dx + wk * dnx : dx - 2.0f * ddn * dnx;
  float diey = do_refract ? eta * dy + wk * dny : dy - 2.0f * ddn * dny;
  float diez = do_refract ? eta * dz + wk * dnz : dz - 2.0f * ddn * dnz;
  zvt::norm3(diex, diey, diez);

  const bool is_lam = mtype == MAT_LAMBERTIAN;
  const bool is_met = mtype == MAT_METAL;
  const bool is_die = mtype == MAT_DIELECTRIC;
  // emissive paths terminate (superset; see core.materials)
  const bool result = is_lam || (is_met && met_ok) ||
                      (!is_lam && !is_met && is_die);
  const bool refracted = is_die && do_refract;

  // the colour: the previous level's pending lit term, this level's
  // emissive term, then its diffuse or lit term
  float cr = a.cr[i], cg = a.cg[i], cb = a.cb[i];
  if (a.prev_occluded != nullptr) {
    const bool occ = a.prev_occluded[i] != 0;
    cr = cr + (occ ? 0.0f : a.pr[i]);
    cg = cg + (occ ? 0.0f : a.pg[i]);
    cb = cb + (occ ? 0.0f : a.pb[i]);
  }
  const bool emit = active && is_emissive;
  cr = cr + (emit ? ar * type_data : 0.0f);
  cg = cg + (emit ? ag * type_data : 0.0f);
  cb = cb + (emit ? ab * type_data : 0.0f);
  const bool sun_or_diffuse = active && !is_emissive;
  if (a.sun == SUN_OFF) {
    cr = cr + (sun_or_diffuse ? ar : 0.0f);
    cg = cg + (sun_or_diffuse ? ag : 0.0f);
    cb = cb + (sun_or_diffuse ? ab : 0.0f);
  } else {
    const float sc0 = zvt::frame_value(a.sun_c_ptr, a.sun_c[0], 0);
    const float sc1 = zvt::frame_value(a.sun_c_ptr, a.sun_c[1], 1);
    const float sc2 = zvt::frame_value(a.sun_c_ptr, a.sun_c[2], 2);
    const float sun_p[3] = {zvt::frame_value(a.sun_p_ptr, a.sun_p[0], 0),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[1], 1),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[2], 2)};
    const float radius = zvt::frame_value(a.radius_ptr, a.radius, 0);
    if (a.sun == SUN_PROBE) {
      const bool lit = sun_or_diffuse && a.occluded[i] == 0;
      cr = cr + (lit ? ar * sc0 : 0.0f);
      cg = cg + (lit ? ag * sc1 : 0.0f);
      cb = cb + (lit ? ab * sc2 : 0.0f);
    } else if (a.sun == SUN_DEFERRED) {
      a.pr[i] = sun_or_diffuse ? ar * sc0 : 0.0f;
      a.pg[i] = sun_or_diffuse ? ag * sc1 : 0.0f;
      a.pb[i] = sun_or_diffuse ? ab * sc2 : 0.0f;
      // the shadow ray toward this level's jittered sun target, seeded by
      // the incoming direction; with a shadow queue the shadow launch reads
      // only the queued (active) lanes' rays
      if (!QUEUED || active) {
        float tx, ty, tz;
        zvt::sun_target(dx, dy, dz, sun_p, radius, tx, ty, tz);
        float sx = tx - px, sy = ty - py, sz = tz - pz;
        zvt::norm3(sx, sy, sz);
        a.shx[i] = sx;
        a.shy[i] = sy;
        a.shz[i] = sz;
      }
      a.active[i] = active ? 1 : 0;
    }
  }
  a.cr[i] = cr;
  a.cg[i] = cg;
  a.cb[i] = cb;

  // the ray-state update
  const bool bouncing = active && result;
  a.bouncing[i] = bouncing ? 1 : 0;
  float ndx = dx, ndy = dy, ndz = dz;
  if (active) {
    a.ox[i] = px;
    a.oy[i] = py;
    a.oz[i] = pz;
  }
  if (bouncing) {
    ndx = is_lam ? lamx : (is_met ? metx : diex);
    ndy = is_lam ? lamy : (is_met ? mety : diey);
    ndz = is_lam ? lamz : (is_met ? metz : diez);
    a.dx[i] = ndx;
    a.dy[i] = ndy;
    a.dz[i] = ndz;
  }
  const float new_internal = active ? (refracted ? ir : 1.0f) : internal;
  const int new_ignore =
      active ? (refracted ? MAT_DIELECTRIC : MAT_NONE) : a.ignore_type[i];
  if (active) {
    a.internal_refl[i] = new_internal;
    a.ignore_type[i] = new_ignore;
  }
  // the next level's dielectric key: the ir of a refracted ray, NaN (skip
  // nothing) otherwise (brick_raytracer.comp:427)
  // with a next queue the next scatter launch reads only the queued
  // (bouncing) lanes' key and sun targets
  const bool read_next = !QUEUED || bouncing || a.next_queue == nullptr;
  if (a.key != nullptr && read_next)
    a.key[i] = new_ignore == MAT_DIELECTRIC ? new_internal : zvt::quiet_nan();
  if (a.tx != nullptr && read_next) {
    const float sun_p[3] = {zvt::frame_value(a.sun_p_ptr, a.sun_p[0], 0),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[1], 1),
                            zvt::frame_value(a.sun_p_ptr, a.sun_p[2], 2)};
    float tx, ty, tz;
    zvt::sun_target(ndx, ndy, ndz, sun_p,
                    zvt::frame_value(a.radius_ptr, a.radius, 0), tx, ty, tz);
    a.tx[i] = tx;
    a.ty[i] = ty;
    a.tz[i] = tz;
  }
  bouncing_out = bouncing;
  active_out = active;
}

// Appends lane i to the next queue where `bouncing` and to the shadow
// queue where `active`: one atomic a block and queue (the counts of the
// block's warps scanned in shared memory), so the block's lanes go in lane
// order after the count's value. Every thread of the block calls it.
__device__ __forceinline__ void append(const ShadeArgs& a, int i,
                                       bool bouncing, bool active) {
  // each warp's count of lanes for the two queues, then their offsets
  __shared__ int taken[2][THREADS / 32];
  __shared__ int base[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned m0 = __ballot_sync(0xffffffffu, bouncing);
  const unsigned m1 = __ballot_sync(0xffffffffu, active);
  if (lane == 0) {
    taken[0][warp] = __popc(m0);
    taken[1][warp] = __popc(m1);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int k = threadIdx.x;
    int32_t* count = k == 0 ? a.next_count : a.shadow_count;
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = taken[k][w];
      taken[k][w] = total;  // the warp's offset in the block's run
      total += c;
    }
    base[k] = count != nullptr && total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (bouncing && a.next_queue != nullptr)
    a.next_queue[base[0] + taken[0][warp] + __popc(m0 & below)] = i;
  if (active && a.shadow_queue != nullptr)
    a.shadow_queue[base[1] + taken[1][warp] + __popc(m1 & below)] = i;
}

// One thread a lane. The QUEUED build (a launch with a queue) is held to
// 48 registers, 5 blocks of 256 threads resident, as the build without
// one takes: unbounded, the appends' barriers take it to 64 and 4 blocks,
// and a level's launch runs 4-8% longer on an H100.
template <bool QUEUED>
__global__ void __launch_bounds__(THREADS, QUEUED ? 5 : 1)
shade_kernel(const ShadeArgs a) {
  bool bouncing = false, active = false;
  if (!QUEUED) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) shade_lane<false>(a, i, bouncing, active);
    return;
  }
  // the wrapper takes fewer than 2^31 lanes: 32-bit lane ids, as the
  // queues hold them
  const int i = (int)blockIdx.x * THREADS + (int)threadIdx.x;
  if (i < a.n) shade_lane<true>(a, i, bouncing, active);
  append(a, i, bouncing, active);
}

}  // namespace

// Zeroes `bytes` bytes at `ptr` on the stream (a memset node in a
// captured graph): the queues' counts at the start of a frame.
extern "C" int zvt_zero(void* ptr, int64_t bytes, void* stream) {
  const cudaError_t status =
      bytes > 0 ? cudaMemsetAsync(ptr, 0, (size_t)bytes, (cudaStream_t)stream)
                : cudaSuccess;
  return status != cudaSuccess ? (int)status : (int)cudaGetLastError();
}

extern "C" int zvt_shade(const ShadeArgs* args, void* stream) {
  if ((args->next_queue == nullptr) != (args->next_count == nullptr) ||
      (args->shadow_queue == nullptr) != (args->shadow_count == nullptr))
    return (int)cudaErrorInvalidValue;
  if (args->n > 0) {
    const unsigned blocks = (unsigned)((args->n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (args->next_queue != nullptr || args->shadow_queue != nullptr)
      shade_kernel<true><<<blocks, THREADS, 0, s>>>(*args);
    else
      shade_kernel<false><<<blocks, THREADS, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}
