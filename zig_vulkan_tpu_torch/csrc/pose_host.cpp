// The camera's pose on the host: the basis update of
// core/camera.py:Camera.propagate_pitch_change (reference Camera.zig:167-175)
// as one routine, called through ctypes by core/pose_host.py.
//
// It computes what the numpy body (Camera.propagate_pitch_change_plain, with
// utils/quat.py) computes, operation for operation and in the same order, so
// the two agree bit for bit:
//   - every operation is one float32 rounding: built with -ffp-contract=off
//     (no a*b + c fused) and without fast-math; sqrtf and division are IEEE;
//   - a product is rounded before the add or subtract that uses it;
//   - a sum over a vector runs as numpy's float32 reduction of a short
//     vector does: from +0, left to right (quat_norm, normalize, the dot
//     product of quat_rotate_vec);
//   - the constant vectors (world up, forward) enter the arithmetic as
//     numpy's do, so a 0 * x keeps its sign and its NaN.
//
// Built with g++ (no CUDA), so that a CPU test holds it against the twin.

#include <cmath>

namespace {

// numpy's float32 sum of a short contiguous vector
inline float sum(const float* a, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += a[i];
  return s;
}

// quat_norm / normalize: v / sqrt(sum(v * v)), in place
inline void unit(float* v, int n) {
  float sq[4];
  for (int i = 0; i < n; ++i) sq[i] = v[i] * v[i];
  const float len = std::sqrt(sum(sq, n));
  for (int i = 0; i < n; ++i) v[i] = v[i] / len;
}

// np.cross of two 3-vectors
inline void cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// quat_mul: the Hamilton product a * b of (w, x, y, z) quaternions
inline void quat_mul(const float* a, const float* b, float* q) {
  q[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  q[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  q[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  q[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// quat_rotate_vec: normalizes q (in place), then
// v * (w*w - b.b) + b * (2 v.b) + cross(b, v) * (2 w)
inline void rotate(float* q, const float* v, float* out) {
  unit(q, 4);
  const float w = q[0];
  const float* b = q + 1;
  float bb[3], vb[3], c[3];
  for (int i = 0; i < 3; ++i) bb[i] = b[i] * b[i];
  for (int i = 0; i < 3; ++i) vb[i] = v[i] * b[i];
  const float along = w * w - sum(bb, 3);
  const float dot2 = sum(vb, 3) * 2.0f;
  const float w2 = w * 2.0f;
  cross(b, v, c);
  for (int i = 0; i < 3; ++i) out[i] = v[i] * along + b[i] * dot2 + c[i] * w2;
}

const float kWorldUp[3] = {0.0f, 1.0f, 0.0f};
const float kForward[3] = {0.0f, 0.0f, 1.0f};

}  // namespace

// yaw, pitch: f32[4] (w, x, y, z); origin: f32[3]; out: f32[9], the
// horizontal, vertical and lower-left corner of the device camera
extern "C" void zvt_pose(const float* yaw, const float* pitch,
                         const float* origin, float viewport_width,
                         float viewport_height, float* out) {
  // orientation(): quat_norm(quat_mul(yaw, pitch)); forward_dir()
  float q[4], forward[3], right[3], up[3];
  quat_mul(yaw, pitch, q);
  unit(q, 4);
  rotate(q, kForward, forward);
  cross(kWorldUp, forward, right);
  unit(right, 3);
  cross(forward, right, up);
  unit(up, 3);
  for (int i = 0; i < 3; ++i) {
    const float h = right[i] * viewport_width;
    const float v = up[i] * viewport_height;
    out[i] = h;
    out[3 + i] = v;
    out[6 + i] = origin[i] - h * 0.5f - v * 0.5f - forward[i];
  }
}
