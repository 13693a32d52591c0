// Native motion-feature pipeline of the training data path.
//
// The reference runs its per-item preprocessing (raw 62-joint motion ->
// canonicalised 262-d feature vectors, reference utils/utils.py:92
// process_motion_interhuman) in Python inside torch Dataset workers.  Here
// the same math is C++ called through ctypes (mixermdm_tpu_torch/data/
// native.py), which releases the interpreter lock for the call, so the
// loader's worker threads run items in parallel while the card trains.
// The numpy functions of mixermdm_tpu_torch/utils/features.py are its plain
// version.
//
// Layout contracts (as utils/features.py):
//   input  motion: (T, 22*3 + 21*6) f32 — the reduced layout produced by
//                  load_raw_motion (preprocess.py:6-34): 22 joint positions
//                  then 21 6d rotations
//   output feats:  (T-1, 262) f32 = [66 pos | 66 vel | 126 rot6d | 4 contact]
//
// Build (data/native.py does it at first use):
//   g++ -O3 -shared -fPIC motion_ops.cpp -o libmotion_ops.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kJoints = 22;
constexpr int kRotDims = 21 * 6;
constexpr int kReducedStride = 22 * 3 + 21 * 6;
constexpr int kFeatDim = 262;

// Face-direction joints (paramUtil.py:89): r_hip, l_hip.
constexpr int kRHip = 2;
constexpr int kLHip = 1;
// Foot joint ids (paramUtil.py:88): FID_L = {7, 10}, FID_R = {8, 11}.
constexpr int kFidL[2] = {7, 10};
constexpr int kFidR[2] = {8, 11};

struct Vec3 {
  double x, y, z;
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

struct Quat {
  double w, x, y, z;
};

// qbetween (quaternion.py:386-397): minimal rotation v0 -> v1.
Quat qbetween(const Vec3& v0, const Vec3& v1) {
  Vec3 v = cross(v0, v1);
  double w = std::sqrt(dot(v0, v0) * dot(v1, v1)) + dot(v0, v1) + 1e-8;
  double n = std::sqrt(w * w + dot(v, v));
  return {w / n, v.x / n, v.y / n, v.z / n};
}

// qrot (quaternion.py:54-74): rotate v by unit quaternion q.
inline Vec3 qrot(const Quat& q, const Vec3& v) {
  Vec3 qv = {q.x, q.y, q.z};
  Vec3 uv = cross(qv, v);
  Vec3 uuv = cross(qv, uv);
  return {v.x + 2.0 * (q.w * uv.x + uuv.x),
          v.y + 2.0 * (q.w * uv.y + uuv.y),
          v.z + 2.0 * (q.w * uv.z + uuv.z)};
}

// Hamilton product (quaternion.py:24-38).
inline Quat qmul(const Quat& a, const Quat& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

}  // namespace

extern "C" {

// Canonicalise one clip.  motion: (T, raw_stride) f32.  out: (T-1, 262) f32.
// Returns 0 on success.
int process_motion_interhuman(const float* motion, int64_t T, int raw_stride,
                              float feet_thre, int prev_frames, int flip,
                              float* out, float* root_quat_out,
                              float* root_pos_out) {
  if (T < 2 || raw_stride < kReducedStride || prev_frames < 0 || prev_frames >= T)
    return 1;

  // Positions with optional axis flip (TRANS_MATRIX, utils.py:87-100):
  // (x, y, z) -> (x, z, -y).
  std::vector<double> pos(static_cast<size_t>(T) * kJoints * 3);
  for (int64_t t = 0; t < T; ++t) {
    for (int j = 0; j < kJoints; ++j) {
      const float* p = motion + t * raw_stride + j * 3;
      double x = p[0], y = p[1], z = p[2];
      double* q = &pos[(t * kJoints + j) * 3];
      if (flip) {
        q[0] = x;
        q[1] = z;
        q[2] = -y;
      } else {
        q[0] = x;
        q[1] = y;
        q[2] = z;
      }
    }
  }

  // Floor height = min y over all frames/joints (utils.py:103-104).
  double floor_y = pos[1];
  for (int64_t i = 0; i < T * kJoints; ++i)
    floor_y = std::min(floor_y, pos[i * 3 + 1]);
  for (int64_t i = 0; i < T * kJoints; ++i) pos[i * 3 + 1] -= floor_y;

  // XZ origin at the root of `prev_frames` (utils.py:108-110).
  const double* root_init = &pos[(static_cast<int64_t>(prev_frames) * kJoints) * 3];
  double rx = root_init[0], rz = root_init[2];
  for (int64_t i = 0; i < T * kJoints; ++i) {
    pos[i * 3 + 0] -= rx;
    pos[i * 3 + 2] -= rz;
  }

  // Face Z+ (utils.py:113-125).  root_init now reflects the translation.
  Vec3 across = {
      pos[(static_cast<int64_t>(prev_frames) * kJoints + kRHip) * 3 + 0] -
          pos[(static_cast<int64_t>(prev_frames) * kJoints + kLHip) * 3 + 0],
      pos[(static_cast<int64_t>(prev_frames) * kJoints + kRHip) * 3 + 1] -
          pos[(static_cast<int64_t>(prev_frames) * kJoints + kLHip) * 3 + 1],
      pos[(static_cast<int64_t>(prev_frames) * kJoints + kRHip) * 3 + 2] -
          pos[(static_cast<int64_t>(prev_frames) * kJoints + kLHip) * 3 + 2]};
  double an = norm(across);
  across = {across.x / an, across.y / an, across.z / an};
  Vec3 up = {0.0, 1.0, 0.0};
  Vec3 forward = cross(up, across);
  double fn = norm(forward);
  forward = {forward.x / fn, forward.y / fn, forward.z / fn};
  Quat rq = qbetween(forward, {0.0, 0.0, 1.0});

  for (int64_t i = 0; i < T * kJoints; ++i) {
    Vec3 v = {pos[i * 3], pos[i * 3 + 1], pos[i * 3 + 2]};
    Vec3 r = qrot(rq, v);
    pos[i * 3] = r.x;
    pos[i * 3 + 1] = r.y;
    pos[i * 3 + 2] = r.z;
  }

  // Foot contacts (utils.py:128-144).
  const double heightfactor[2] = {0.12, 0.05};
  auto contact = [&](int64_t t, const int* fid, int k) -> float {
    const double* a = &pos[(t * kJoints + fid[k]) * 3];
    const double* b = &pos[((t + 1) * kJoints + fid[k]) * 3];
    double d2 = 0;
    for (int c = 0; c < 3; ++c) {
      double d = b[c] - a[c];
      d2 += d * d;
    }
    bool hit = d2 < static_cast<double>(feet_thre) && a[1] < heightfactor[k];
    return hit ? 1.0f : 0.0f;
  };

  // Emit features for frames [0, T-1).
  for (int64_t t = 0; t < T - 1; ++t) {
    float* row = out + t * kFeatDim;
    for (int j = 0; j < kJoints; ++j) {
      const double* p = &pos[(t * kJoints + j) * 3];
      const double* pn = &pos[((t + 1) * kJoints + j) * 3];
      row[j * 3 + 0] = static_cast<float>(p[0]);
      row[j * 3 + 1] = static_cast<float>(p[1]);
      row[j * 3 + 2] = static_cast<float>(p[2]);
      row[66 + j * 3 + 0] = static_cast<float>(pn[0] - p[0]);
      row[66 + j * 3 + 1] = static_cast<float>(pn[1] - p[1]);
      row[66 + j * 3 + 2] = static_cast<float>(pn[2] - p[2]);
    }
    // Rotations pass through from the raw layout (utils.py:146-147).
    const float* rot = motion + t * raw_stride + kJoints * 3;
    std::memcpy(row + 132, rot, sizeof(float) * kRotDims);
    // Contacts: FID_L then FID_R.
    row[258] = contact(t, kFidL, 0);
    row[259] = contact(t, kFidL, 1);
    row[260] = contact(t, kFidR, 0);
    row[261] = contact(t, kFidR, 1);
  }

  if (root_quat_out) {
    root_quat_out[0] = static_cast<float>(rq.w);
    root_quat_out[1] = static_cast<float>(rq.x);
    root_quat_out[2] = static_cast<float>(rq.y);
    root_quat_out[3] = static_cast<float>(rq.z);
  }
  if (root_pos_out) {
    root_pos_out[0] = static_cast<float>(rx);
    root_pos_out[1] = 0.0f;
    root_pos_out[2] = static_cast<float>(rz);
  }
  return 0;
}

// Fused two-person item: canonicalise BOTH persons, express person 2 in
// person 1's canonical frame (the reference's per-item relative rigid
// transform, interhuman.py:208-216 + utils.py:244-258), and zero-pad both to
// max_len rows — the entire per-item hot path of InterHuman training items in
// ONE GIL-released call.  m1/m2: (T, raw_stride) f32 (same cropped window);
// out1/out2: (max_len, 262) f32.  gt_len_out receives T-1.
int process_pair_interhuman(const float* m1, const float* m2, int64_t T,
                            int raw_stride, float feet_thre, int prev_frames,
                            int flip, int64_t max_len, float* out1,
                            float* out2, int32_t* gt_len_out) {
  const int64_t rows = T - 1;
  if (T < 2 || rows > max_len) return 1;
  // Round the per-person root quat/pos through f32, exactly like the Python
  // caller of process_motion_interhuman_native does (native.py returns f32).
  float q1f[4], p1f[3], q2f[4], p2f[3];
  int rc = process_motion_interhuman(m1, T, raw_stride, feet_thre,
                                     prev_frames, flip, out1, q1f, p1f);
  if (rc != 0) return rc;
  rc = process_motion_interhuman(m2, T, raw_stride, feet_thre, prev_frames,
                                 flip, out2, q2f, p2f);
  if (rc != 0) return rc;

  // relative = [atan2(r_rel.y, r_rel.w), qrot(q1, p2-p1).xz]
  // (interhuman.py:201-205).
  Quat q1 = {q1f[0], q1f[1], q1f[2], q1f[3]};
  Quat q2 = {q2f[0], q2f[1], q2f[2], q2f[3]};
  Quat q1inv = {q1.w, -q1.x, -q1.y, -q1.z};
  Quat rrel = qmul(q2, q1inv);
  double angle = std::atan2(rrel.y, rrel.w);
  Vec3 d = {static_cast<double>(p2f[0]) - p1f[0],
            static_cast<double>(p2f[1]) - p1f[1],
            static_cast<double>(p2f[2]) - p1f[2]};
  Vec3 e = qrot(q1, d);
  const double tx = e.x, tz = e.z;

  // rigid_transform (utils.py:244-258): rotate person-2 positions and
  // velocities by the INVERSE of the y-rotation quat, translate positions.
  Quat rinv = {std::cos(angle), 0.0, -std::sin(angle), 0.0};
  for (int64_t t = 0; t < rows; ++t) {
    float* row = out2 + t * kFeatDim;
    for (int j = 0; j < kJoints; ++j) {
      float* p = row + j * 3;
      Vec3 r = qrot(rinv, {p[0], p[1], p[2]});
      p[0] = static_cast<float>(r.x + tx);
      p[1] = static_cast<float>(r.y);
      p[2] = static_cast<float>(r.z + tz);
      float* v = row + 66 + j * 3;
      Vec3 s = qrot(rinv, {v[0], v[1], v[2]});
      v[0] = static_cast<float>(s.x);
      v[1] = static_cast<float>(s.y);
      v[2] = static_cast<float>(s.z);
    }
  }

  if (rows < max_len) {
    std::memset(out1 + rows * kFeatDim, 0,
                sizeof(float) * (max_len - rows) * kFeatDim);
    std::memset(out2 + rows * kFeatDim, 0,
                sizeof(float) * (max_len - rows) * kFeatDim);
  }
  if (gt_len_out) *gt_len_out = static_cast<int32_t>(rows);
  return 0;
}

}  // extern "C"
