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
// block's lanes in the order it read them): kernel A's later launches and
// kernel B take those queues instead of the whole wavefront, so the shadow
// launch's directions and the next level's key and sun targets are written
// only for the lanes of their queue. From the second level on, this kernel
// takes a queue too and shades only its lanes: with a shadow launch the
// previous level's shadow queue, else the previous level's scatter queue
// (the queue kernels A and B took). A lane outside it changes nothing
// here: it is not bouncing (the bouncing lanes are a subset of the last
// active ones), so it is not active, its loop count, ray and dielectric
// state stay, its pending term and shadow mask already hold 0 (written at
// the last level that shaded it), and its colour would gain +0 twice,
// which leaves a colour that started at +0 and only ever added terms as
// it was. So the lanes outside the queue are neither read nor written,
// the shadow mask included, and every lane of the queue is shaded as over
// the whole wavefront. The grid is the whole wavefront's, as the queue's
// length is known only on the card; a block past the count exits at once.
// The first level's launch and kernel E take every lane.
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
// that stops bouncing) are skipped; they would store the value read. In
// the build that takes or fills queues, a lane that did not hit (most of a
// first level's lanes are sky) reads only its colour, pending term and
// masks: on an H100 that takes the first level's launch from 0.213 to
// 0.127 ms at 4,147,200 lanes.
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
  // the queue this level shades (NULL: every lane): lane ids and count
  const int32_t* in_queue;
  const int32_t* in_count;
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
// written only for the lanes that their queue holds, and a lane that is
// not active (a level's queue or wavefront holds many such lanes: rays
// gone to the sky) reads none of its hit, material and ray, unless the
// launch writes every lane's next key or sun targets (it has no next
// queue). Such a lane's colour, pending term and masks take the same
// writes either way, and its loop count, which would store the value
// read, is not written.
template <bool QUEUED, typename Index>
__device__ __forceinline__ void shade_lane(const ShadeArgs& a, Index i,
                                           bool& bouncing_out,
                                           bool& active_out) {
  const bool active = a.bouncing[i] != 0 && a.found[i] != 0;
  const bool reads = !QUEUED || active ||
                     (a.next_queue == nullptr &&
                      (a.key != nullptr || a.tx != nullptr));
  // what the colour and the state update read of a lane that is read; a
  // lane that is not read is not active, so they select none of it
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, type_data = 0.0f;
  bool is_emissive = false, is_lam = false, is_met = false;
  bool result = false, refracted = false;
  float px = 0.0f, py = 0.0f, pz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float internal = 0.0f, ir = 0.0f;
  float lamx = 0.0f, lamy = 0.0f, lamz = 0.0f;
  float metx = 0.0f, mety = 0.0f, metz = 0.0f;
  float diex = 0.0f, diey = 0.0f, diez = 0.0f;
  if (reads) {
    ar = a.albedo_r[i];
    ag = a.albedo_g[i];
    ab = a.albedo_b[i];
    type_data = a.type_data[i];
    const int mtype = (int)a.mtype[i];  // as torch's .to(torch.int32)
    is_emissive = mtype == MAT_EMISSIVE;
    const bool known = mtype <= MAT_DIELECTRIC || is_emissive;
    a.loop_count[i] = a.loop_count[i] + ((active && known) ? 1 : 0);

    px = a.px[i];
    py = a.py[i];
    pz = a.pz[i];
    const float nx = a.nx[i], ny = a.ny[i], nz = a.nz[i];
    dx = a.dx[i];
    dy = a.dy[i];
    dz = a.dz[i];
    internal = a.internal_refl[i];
    const float cox = px + pz;
    const float coy = py + pz;

    // lambertian (brick_raytracer.comp:539-544)
    zvt::rand_vec3_range(cox, coy, -LAMBERT, LAMBERT - -LAMBERT, lamx, lamy,
                         lamz);
    lamx = nx + lamx;
    lamy = ny + lamy;
    lamz = nz + lamz;
    zvt::norm3(lamx, lamy, lamz);

    // metal (brick_raytracer.comp:546-551)
    const float dn = zvt::dot3(dx, dy, dz, nx, ny, nz);
    const float fuzz_lo = -type_data;
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
    ir = type_data;
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
    diex = do_refract ? eta * dx + wk * dnx : dx - 2.0f * ddn * dnx;
    diey = do_refract ? eta * dy + wk * dny : dy - 2.0f * ddn * dny;
    diez = do_refract ? eta * dz + wk * dnz : dz - 2.0f * ddn * dnz;
    zvt::norm3(diex, diey, diez);

    is_lam = mtype == MAT_LAMBERTIAN;
    is_met = mtype == MAT_METAL;
    const bool is_die = mtype == MAT_DIELECTRIC;
    // emissive paths terminate (superset; see core.materials)
    result = is_lam || (is_met && met_ok) ||
             (!is_lam && !is_met && is_die);
    refracted = is_die && do_refract;
  }

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
      active ? (refracted ? MAT_DIELECTRIC : MAT_NONE)
             : reads ? a.ignore_type[i] : MAT_NONE;  // not read: unused
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
// block's warps scanned in shared memory), so the block's lanes go in
// thread order (lane order, or the order of the queue it shades) after the
// count's value. Every thread of the block calls it.
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

// One thread a lane, or a queued lane. The QUEUED build (a launch that
// takes or fills a queue) is held to 48 registers, 5 blocks of 256 threads
// resident, as the build without one takes: unbounded, the appends'
// barriers take it to 64 and 4 blocks, and a level's launch runs 4-8%
// longer on an H100.
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
  const int j = (int)blockIdx.x * THREADS + (int)threadIdx.x;
  int i = j;
  if (a.in_queue != nullptr) {
    // thread j shades lane in_queue[j]; the whole block exits past the
    // count, before the appends' barriers
    const int count = *a.in_count;
    if ((int)blockIdx.x * THREADS >= count) return;
    i = j < count ? a.in_queue[j] : (int)a.n;
  }
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
      (args->shadow_queue == nullptr) != (args->shadow_count == nullptr) ||
      (args->in_queue == nullptr) != (args->in_count == nullptr))
    return (int)cudaErrorInvalidValue;
  if (args->n > 0) {
    const unsigned blocks = (unsigned)((args->n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (args->next_queue != nullptr || args->shadow_queue != nullptr ||
        args->in_queue != nullptr)
      shade_kernel<true><<<blocks, THREADS, 0, s>>>(*args);
    else
      shade_kernel<false><<<blocks, THREADS, 0, s>>>(*args);
  }
  return (int)cudaGetLastError();
}
