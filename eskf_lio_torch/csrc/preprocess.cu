// Scan preprocessing between its key sorts, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA, which
// fuses `eskf_lio_tpu/ops/preprocess.py`'s elementwise chains into a few
// programs.  Run eagerly (or captured op by op into a CUDA graph), the
// port's plain version of it (`ops/preprocess.py::preprocess_ref`) is ~730
// small kernels over [24,576, 3] and [12,288, 10] tensors a scan, each a
// few microseconds of launch latency for nanoseconds of work: 41 % of the
// captured step.  Here each chain between two of its key sorts is one
// kernel, and each kernel reads its rows through the previous sort's
// permutation, so the sort's row gathers are gone too.  The key sorts stay
// `torch.sort(stable=True)` (stability keeps the first point of each
// voxel), and the per-voxel moment sums stay kernel B (`csrc/segscan.cu`).
//
// The six kernels, in launch order (N raw rows, K = min(N, max_scan_points)):
//   key       raw points: extrinsics, deskew (`key_deskew`) or not (`key`),
//             voxel key, packing, voxel-centred offset, masked sort key
//   moments   key-sorted rows: segment heads, the [N, 10] moment rows
//             (kernel B's input) and the head-compaction key
//   compact   the first K head-compaction-sorted rows: their packed key
//   pass_z    the z neighbour pass in ascending packed order, and the key
//             that puts y in the minor bits
//   pass_y    the y pass, and the key that puts x in the minor bits
//   pass_x    the x pass, the covariance of the 27-voxel neighbourhood, its
//             closed-form plane regularisation, the output points, and the
//             padding to max_scan_points; each row is written at its place
//             in ascending packed order, which the plain version reaches
//             with one more sort
//
// Bound on the H100: bytes.  At the mid360 shapes (N = 24,576, K = 12,288)
// the six read and write ~3.1 MB together, ~1 us at 3.35 TB/s, and a launch
// is ~2-3 us of latency whatever it moves: the kernels are latency-bound by
// design, one thread a row and no shared state between rows, so no launch
// waits on another block.  The deskew's per-scan end pose and [M+1, 12]
// transform table are rebuilt by every block of `key_deskew` in shared
// memory (M+1 = 65 states: a few hundred flops a block) instead of a launch
// of their own.
//
// Numerics: the plain version's float32 arithmetic in its order, so that
// keys, masks, row order and points equal it bit for bit on the card.  The
// source is built with -fmad=false (no a*b+c contracted where torch rounds
// twice) and without fast math; where torch's CUDA kernels themselves fuse
// or reorder (cuBLAS's 3x3 products, the reductions over a last dimension
// of 3 or 4, linalg.cross, division by a Python number), the helpers below
// say which order they take, as measured on the card against torch 2.11.
//
// Capture-safe: no scratch, no atomics, no host reads; any N >= 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 10;
constexpr int kMask = (1 << kBits) - 1;
constexpr int kDead = 2147483647;  // INT32_MAX: empty / out-of-range key
constexpr int kOrigin = -512;      // the packing origin, in voxels
constexpr int kMaxStates = 512;    // M + 1 of the deskew's state history

typedef long long i64;

// ---- torch's float32 rounding of the plain version's small ops ----------

// x / <Python number>: torch's CUDA division multiplies by the reciprocal
__device__ __forceinline__ float div_by_number(float x, float s) { return x * (1.0f / s); }

// one output of a cuBLAS product with an inner size of 3 (`a @ b` of
// [N, 3] @ [3, 3] and [3, 3] @ [M, 3, 3]): fma chain from k = 0
__device__ __forceinline__ float gemm3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// one output of cuBLAS's [3, 3] @ [3] (a matrix-vector product)
__device__ __forceinline__ float gemv3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// torch.sum over a last dimension of 3, one output a row
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return (x0 + x2) + x1; }

// torch.linalg.norm over a last dimension of 3, one output a row
__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return sqrtf(sum3(x0 * x0, x1 * x1, x2 * x2));
}

// torch.sum / torch.linalg.norm of a single 4-vector
__device__ __forceinline__ float sum4(float x0, float x1, float x2, float x3) {
  return (x0 + x2) + (x1 + x3);
}

// torch.linalg.cross of two 3-vectors
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  c[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  c[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

// torch.clamp and torch.maximum: NaN propagates
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// lie.quat_to_mat of (w, x, y, z), row-major
__device__ void quat_to_mat(float w, float x, float y, float z, float R[9]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

// ---- keys ---------------------------------------------------------------

// voxel key, packing, voxel-centred offset and masked sort key of one
// (deskewed) point: `downsample_and_covariances` up to its first sort
__device__ __forceinline__ void key_point(const float p[3], bool valid, float vs, int i,
                                          int* skey, float* q) {
  int rel[3];
  float off[3];
  bool in_range = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int key = static_cast<int>(floorf(div_by_number(p[c], vs)));
    rel[c] = static_cast<int>(static_cast<unsigned>(key) - static_cast<unsigned>(kOrigin));
    in_range = in_range && rel[c] >= 0 && rel[c] < (1 << kBits);
    off[c] = p[c] - (static_cast<float>(key) + 0.5f) * vs;
  }
  const bool ok = valid && in_range;
  skey[i] = ok ? (rel[0] << (2 * kBits)) | (rel[1] << kBits) | rel[2] : kDead;
#pragma unroll
  for (int c = 0; c < 3; ++c) q[3 * static_cast<i64>(i) + c] = ok ? off[c] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
key_kernel(const float* __restrict__ pts, const bool* __restrict__ valid, int n, float vs,
           int* __restrict__ skey, float* __restrict__ q) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {pts[3 * static_cast<i64>(i)], pts[3 * static_cast<i64>(i) + 1],
                      pts[3 * static_cast<i64>(i) + 2]};
  key_point(p, valid[i], vs, i, skey, q);
}

// The deskew's end pose: the state history's pose interpolated at scan end
// (t_rel = 0) and inverted, as `deskew` computes it (`lie.interpolate_pose`,
// `quat_slerp`, `Pose.inverse`).  Rinv row-major, tinv.
__device__ void end_pose_inverse(const float* ts, const float* __restrict__ hp,
                                 const float* __restrict__ hq, int m1, int last_valid,
                                 float Rinv[9], float tinv[3]) {
  // torch.searchsorted(ts, 0, right=True): its binary search
  int lo = 0, hi = m1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(ts[mid] > 0.0f)) lo = mid + 1; else hi = mid;
  }
  const int ib = min(max(lo - 1, 0), m1 - 1);
  const int ia = min(min(max(ib + 1, 0), m1 - 1), last_valid);
  const float t0 = ts[ib], t1 = ts[ia];
  const float u = (0.0f - t0) / ((t1 - t0) + 1e-6f);
  float pe[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) pe[c] = hp[3 * ib + c] + u * (hp[3 * ia + c] - hp[3 * ib + c]);

  float q0[4], q1[4], pr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q0[c] = hq[4 * ib + c];
    q1[c] = hq[4 * ia + c];
    pr[c] = q0[c] * q1[c];
  }
  const float dot = sum4(pr[0], pr[1], pr[2], pr[3]);
  if (dot < 0.0f) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q1[c] = -q1[c];
  }
  const float cl = clampf(fabsf(dot), -1.0f, 1.0f);
  const float theta = acosf(clampf(cl, 0.0f, 1.0f));
  const bool small = theta < 1e-6f;
  const float sin_theta = small ? 1.0f : sinf(theta);
  const float w0 = small ? 1.0f - u : sinf((1.0f - u) * theta) / sin_theta;
  const float w1 = small ? u : sinf(u * theta) / sin_theta;
  float qe[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) qe[c] = w0 * q0[c] + w1 * q1[c];
  const float nq = sqrtf(sum4(qe[0] * qe[0], qe[1] * qe[1], qe[2] * qe[2], qe[3] * qe[3]));
#pragma unroll
  for (int c = 0; c < 4; ++c) qe[c] = qe[c] / nq;

  float R[9];
  quat_to_mat(qe[0], qe[1], qe[2], qe[3], R);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) Rinv[3 * r + c] = R[3 * c + r];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    tinv[r] = -gemv3(Rinv[3 * r], Rinv[3 * r + 1], Rinv[3 * r + 2], pe[0], pe[1], pe[2]);
  }
}

// extrinsics + deskew + keys.  Every block rebuilds the end pose and the
// per-state table T_end^-1 * T_state ([M+1, 12]: R row-major, t) in shared
// memory from the state history, then each thread takes one raw point.
__global__ void __launch_bounds__(kThreads)
key_deskew_kernel(const float* __restrict__ pts, const float* __restrict__ t_rel,
                  const bool* __restrict__ valid, const float* __restrict__ R_il,
                  const float* __restrict__ t_il, const float* __restrict__ h_t,
                  const float* __restrict__ h_p, const float* __restrict__ h_q,
                  const bool* __restrict__ h_valid, int m1, int n, float vs,
                  int* __restrict__ skey, float* __restrict__ q) {
  extern __shared__ float smem[];
  float* ts = smem;             // [m1]: state times, +inf where invalid
  float* table = smem + m1;     // [m1, 12]
  __shared__ float pose[12];    // Rinv, tinv
  __shared__ int s_last_valid;

  for (int s = threadIdx.x; s < m1; s += kThreads) ts[s] = h_valid[s] ? h_t[s] : INFINITY;
  __syncthreads();
  if (threadIdx.x == 0) {
    int count = 0;
    for (int s = 0; s < m1; ++s) count += h_valid[s] ? 1 : 0;
    s_last_valid = count - 1;
    end_pose_inverse(ts, h_p, h_q, m1, count - 1, pose, pose + 9);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < m1; s += kThreads) {
    float Q[9];
    quat_to_mat(h_q[4 * s], h_q[4 * s + 1], h_q[4 * s + 2], h_q[4 * s + 3], Q);
    float* row = table + 12 * s;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        row[3 * r + c] = gemm3(pose[3 * r], pose[3 * r + 1], pose[3 * r + 2], Q[c], Q[3 + c], Q[6 + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      row[9 + c] = gemm3(h_p[3 * s], h_p[3 * s + 1], h_p[3 * s + 2],
                         pose[3 * c], pose[3 * c + 1], pose[3 * c + 2]) + pose[9 + c];
    }
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* pr = pts + 3 * static_cast<i64>(i);
  const float x = pr[0], y = pr[1], z = pr[2];
  float pi[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) pi[r] = gemm3(x, y, z, R_il[3 * r], R_il[3 * r + 1], R_il[3 * r + 2]) + t_il[r];
  const bool v = valid[i];
  float p[3] = {pi[0], pi[1], pi[2]};
  if (v) {
    // the first state with a time after the point's
    const float tp = t_rel[i];
    int idx = 0;
    for (int s = 0; s < m1; ++s) idx += (tp >= ts[s]) ? 1 : 0;
    idx = min(max(idx, 1), s_last_valid);
    const float* row = table + 12 * idx;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      p[r] = sum3(row[3 * r] * pi[0], row[3 * r + 1] * pi[1], row[3 * r + 2] * pi[2]) + row[9 + r];
    }
  }
  key_point(p, v, vs, i, skey, q);
}

// ---- between the sorts ----------------------------------------------------

// key-sorted rows: the moments about the voxel centre (kernel B sums them
// per voxel) and the key that compacts segment heads to the front: a
// multiplicative hash of the voxel key where the scan budget may overflow,
// else the row's position
__global__ void __launch_bounds__(kThreads)
moments_kernel(const int* __restrict__ skey_s, const i64* __restrict__ perm,
               const float* __restrict__ q, int n, int overflow, float* __restrict__ raw,
               int* __restrict__ hkey) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int k = skey_s[j];
  const bool ok = k != kDead;
  const bool head = ok && !(j > 0 && skey_s[j - 1] == k);
  const float* qs = q + 3 * perm[j];
  const float qx = qs[0], qy = qs[1], qz = qs[2];
  const float w = ok ? 1.0f : 0.0f;
  float* r = raw + 10 * static_cast<i64>(j);
  r[0] = w;
  r[1] = qx * w;
  r[2] = qy * w;
  r[3] = qz * w;
  r[4] = (qx * qx) * w;
  r[5] = (qx * qy) * w;
  r[6] = (qx * qz) * w;
  r[7] = (qy * qy) * w;
  r[8] = (qy * qz) * w;
  r[9] = (qz * qz) * w;
  int h = j;
  if (overflow) {
    h = static_cast<int>((static_cast<i64>(k) * -1640531527LL) & 0x7FFFFFFFLL);
    if (h == kDead) h = 0;
  }
  hkey[j] = head ? h : kDead;
}

// the first K rows in head-compaction order: their packed key (dead rows
// kDead)
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ h_sorted, const i64* __restrict__ perm,
               const int* __restrict__ skey_s, int kcap, int* __restrict__ t_packed) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= kcap) return;
  t_packed[r] = h_sorted[r] != kDead ? skey_s[perm[r]] : kDead;
}

// ---- the separable 3x3x3 neighbourhood -----------------------------------

// `_shift_moments(m, d)`: moments about c re-centred on c - d, added to acc
__device__ __forceinline__ void add_shifted(float acc[10], const float* m, float dx, float dy,
                                            float dz) {
  const float m0 = m[0], x = m[1], y = m[2], z = m[3];
  const float s[10] = {
      m0,
      x + m0 * dx,
      y + m0 * dy,
      z + m0 * dz,
      (m[4] + (2.0f * dx) * x) + (m0 * dx) * dx,
      ((m[5] + dx * y) + dy * x) + (m0 * dx) * dy,
      ((m[6] + dx * z) + dz * x) + (m0 * dx) * dz,
      (m[7] + (2.0f * dy) * y) + (m0 * dy) * dy,
      ((m[8] + dy * z) + dz * y) + (m0 * dy) * dz,
      (m[9] + (2.0f * dz) * z) + (m0 * dz) * dz,
  };
#pragma unroll
  for (int c = 0; c < 10; ++c) acc[c] = acc[c] + s[c];
}

__device__ __forceinline__ void add_zero(float acc[10]) {
#pragma unroll
  for (int c = 0; c < 10; ++c) acc[c] = acc[c] + 0.0f;
}

// `_axis_pass` for one row of a table sorted by `key` (the pass axis in the
// minor bits, kDead tail): the row's moments plus those of its +-1
// minor-axis neighbours, which are the adjacent rows when present.  `row`
// gives a row's moments (a pointer to 10 floats) or nullptr for a dead row;
// d is +voxel_size along the pass axis.
template <typename Row>
__device__ __forceinline__ void axis_pass(const int* key, int r, int kcap, Row row, float dx,
                                          float dy, float dz, float out[10]) {
  const int k = key[r];
  const bool live = k != kDead;
  const int minor = k & kMask;
  const bool plus_ok = live && r + 1 < kcap && key[r + 1] != kDead && key[r + 1] == k + 1 &&
                       minor != kMask;
  const bool minus_ok = live && r > 0 && key[r - 1] != kDead && key[r - 1] == k - 1 &&
                        minor != 0;
  const float* m = live ? row(r) : nullptr;
#pragma unroll
  for (int c = 0; c < 10; ++c) out[c] = m ? m[c] : 0.0f;
  if (plus_ok) add_shifted(out, row(r + 1), dx, dy, dz); else add_zero(out);
  if (minus_ok) add_shifted(out, row(r - 1), -dx, -dy, -dz); else add_zero(out);
  if (!live) {
#pragma unroll
    for (int c = 0; c < 10; ++c) out[c] = 0.0f;
  }
}

// `_rotate_key`: the packed (x, y, z) key with `axis` in the minor bits
__device__ __forceinline__ int rotate_key(int p, int axis) {
  if (p == kDead) return kDead;
  const int x = (p >> (2 * kBits)) & kMask, y = (p >> kBits) & kMask, z = p & kMask;
  return axis == 1 ? (x << (2 * kBits)) | (z << kBits) | y
                   : (y << (2 * kBits)) | (z << kBits) | x;
}

__device__ __forceinline__ void store10(float* dst, const float v[10]) {
#pragma unroll
  for (int c = 0; c < 10; ++c) dst[c] = v[c];
}

// z pass over the ascending packed order `fk` [K]; a row's moments are
// kernel B's head sums, reached through the compaction (perm2) and, where
// the budget overflows, the sort back to packed order (perm3, else null)
__global__ void __launch_bounds__(kThreads)
pass_z_kernel(const int* __restrict__ fk, const i64* __restrict__ perm3,
              const i64* __restrict__ perm2, const float* __restrict__ table_m, int kcap,
              float vs, float* __restrict__ m_out, int* __restrict__ key_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= kcap) return;
  auto row = [&](int i) { return table_m + 10 * perm2[perm3 ? perm3[i] : i]; };
  float out[10];
  axis_pass(fk, r, kcap, row, 0.0f, 0.0f, vs, out);
  store10(m_out + 10 * static_cast<i64>(r), out);
  key_out[r] = rotate_key(fk[r], 1);
}

// y pass over the rows sorted by the y-minor key; also the x-minor key of
// each row's packed key, for the next sort
__global__ void __launch_bounds__(kThreads)
pass_y_kernel(const int* __restrict__ ky, const i64* __restrict__ perm4,
              const float* __restrict__ m_z, const int* __restrict__ fk, int kcap, float vs,
              float* __restrict__ m_out, int* __restrict__ key_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= kcap) return;
  auto row = [&](int i) { return m_z + 10 * perm4[i]; };
  float out[10];
  axis_pass(ky, r, kcap, row, 0.0f, vs, 0.0f, out);
  store10(m_out + 10 * static_cast<i64>(r), out);
  key_out[r] = rotate_key(fk[perm4[r]], 0);
}

// `eig3.plane_regularize` of one symmetric matrix: I - (1 - eps) n n^T with
// n the unit eigenvector of the smallest eigenvalue (Smith's closed form,
// the best of three row cross products, z for a degenerate matrix)
__device__ void plane_regularize(float a00, float a01, float a02, float a11, float a12,
                                 float a22, float one_minus_eps, float out[9]) {
  const float p1 = (a01 * a01 + a02 * a02) + a12 * a12;
  const float qm = div_by_number((a00 + a11) + a22, 3.0f);
  const float b00 = a00 - qm, b11 = a11 - qm, b22 = a22 - qm;
  const float p2 = ((b00 * b00 + b11 * b11) + b22 * b22) + 2.0f * p1;
  const float p = sqrtf(clampf(div_by_number(p2, 6.0f), 1e-12f, INFINITY));
  const float inv_p = 1.0f / p;
  const float c00 = b00 * inv_p, c11 = b11 * inv_p, c22 = b22 * inv_p;
  const float c01 = a01 * inv_p, c02 = a02 * inv_p, c12 = a12 * inv_p;
  const float detB = (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)) +
                     c02 * (c01 * c12 - c11 * c02);
  const float rr = clampf(div_by_number(detB, 2.0f), -1.0f, 1.0f);
  const float phi = div_by_number(acosf(rr), 3.0f);
  const float lam = qm + (2.0f * p) * cosf(phi + static_cast<float>(2.0 * M_PI / 3.0));

  const float r0[3] = {a00 - lam, a01, a02};
  const float r1[3] = {a01, a11 - lam, a12};
  const float r2[3] = {a02, a12, a22 - lam};
  float ca[3], cb[3], cc[3];
  cross3(r0, r1, ca);
  cross3(r0, r2, cb);
  cross3(r1, r2, cc);
  const float na = sum3(ca[0] * ca[0], ca[1] * ca[1], ca[2] * ca[2]);
  const float nb = sum3(cb[0] * cb[0], cb[1] * cb[1], cb[2] * cb[2]);
  const float nc = sum3(cc[0] * cc[0], cc[1] * cc[1], cc[2] * cc[2]);
  const bool a_over_b = na >= nb;
  const float n_ab = maximum(na, nb);
  const bool ab_over_c = n_ab >= nc;
  const bool degenerate = maximum(n_ab, nc) < 1e-12f;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = degenerate ? (c == 2 ? 1.0f : 0.0f) : (ab_over_c ? (a_over_b ? ca[c] : cb[c]) : cc[c]);
  }
  const float nrm = norm3(v[0], v[1], v[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = v[c] / nrm;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[3 * r + c] = (r == c ? 1.0f : 0.0f) - one_minus_eps * (v[r] * v[c]);
    }
  }
}

// x pass, then the output row: each pass row lands at its place P in the
// ascending packed order; threads past K write the padding rows
__global__ void __launch_bounds__(kThreads)
pass_x_kernel(const int* __restrict__ kx, const i64* __restrict__ perm5,
              const float* __restrict__ m_y, const i64* __restrict__ perm4,
              const int* __restrict__ fk, const i64* __restrict__ perm3,
              const i64* __restrict__ perm2, const i64* __restrict__ perm1,
              const float* __restrict__ q, int kcap, int k_out, float vs, float one_minus_eps,
              float min_neighbors, float* __restrict__ out_points, float* __restrict__ out_covs,
              bool* __restrict__ out_valid) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= k_out) return;
  if (j >= kcap) {
    float* pts = out_points + 3 * static_cast<i64>(j);
    float* cov = out_covs + 9 * static_cast<i64>(j);
#pragma unroll
    for (int c = 0; c < 3; ++c) pts[c] = 0.0f;
#pragma unroll
    for (int c = 0; c < 9; ++c) cov[c] = (c % 4 == 0) ? 1.0f : 0.0f;
    out_valid[j] = false;
    return;
  }
  auto row = [&](int i) { return m_y + 10 * perm5[i]; };
  float nb[10];
  axis_pass(kx, j, kcap, row, vs, 0.0f, 0.0f, nb);

  const i64 P = perm4[perm5[j]];
  const int pk = fk[P];
  const bool live = pk != kDead;
  const float* tq = q + 3 * perm1[perm2[perm3 ? perm3[P] : P]];
  float* pts = out_points + 3 * P;
  const int rel[3] = {(pk >> (2 * kBits)) & kMask, (pk >> kBits) & kMask, pk & kMask};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float center = (static_cast<float>(rel[c] + kOrigin) + 0.5f) * vs;
    pts[c] = live ? center + tq[c] : 0.0f;
  }
  out_valid[P] = live;

  const float cnt = nb[0];
  const float denom = clampf(cnt, 1.0f, INFINITY);
  const float mu0 = nb[1] / denom, mu1 = nb[2] / denom, mu2 = nb[3] / denom;
  const float exx = nb[4] / denom - mu0 * mu0;
  const float exy = nb[5] / denom - mu0 * mu1;
  const float exz = nb[6] / denom - mu0 * mu2;
  const float eyy = nb[7] / denom - mu1 * mu1;
  const float eyz = nb[8] / denom - mu1 * mu2;
  const float ezz = nb[9] / denom - mu2 * mu2;
  float cov[9];
  plane_regularize(exx, exy, exz, eyy, eyz, ezz, one_minus_eps, cov);
  if (cnt < min_neighbors) {
#pragma unroll
    for (int c = 0; c < 9; ++c) cov[c] = (c % 4 == 0) ? 1.0f : 0.0f;
  }
  float* dst = out_covs + 9 * P;
#pragma unroll
  for (int c = 0; c < 9; ++c) dst[c] = cov[c];
}

inline int blocks(int rows) { return (rows + kThreads - 1) / kThreads; }

inline int status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// The largest M + 1 (state history rows) that `preprocess_key_deskew` takes.
int preprocess_max_states() { return kMaxStates; }

// pts [n, 3], valid [n] (bool): points already in the body frame.
// Writes skey [n] (the masked packed key) and q [n, 3] (the offset from the
// voxel centre, 0 where masked).
int preprocess_key(const float* pts, const bool* valid, int n, float vs, int* skey, float* q,
                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  key_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(pts, valid, n, vs,
                                                                            skey, q);
  return status();
}

// The same from raw sensor points: extrinsics (R_il row-major [3, 3], t_il
// [3]) and deskew by the state history (h_t [m1], h_p [m1, 3], h_q [m1, 4]
// wxyz, h_valid [m1]; 1 <= m1 <= preprocess_max_states()).
int preprocess_key_deskew(const float* pts, const float* t_rel, const bool* valid,
                          const float* R_il, const float* t_il, const float* h_t,
                          const float* h_p, const float* h_q, const bool* h_valid, int m1, int n,
                          float vs, int* skey, float* q, void* stream) {
  if (n < 1 || m1 < 1 || m1 > kMaxStates) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(m1) * 13;
  key_deskew_kernel<<<blocks(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, t_rel, valid, R_il, t_il, h_t, h_p, h_q, h_valid, m1, n, vs, skey, q);
  return status();
}

// skey_s [n] sorted, perm [n] its permutation, q [n, 3] unsorted.  Writes
// raw [n, 10] and hkey [n].
int preprocess_moments(const int* skey_s, const i64* perm, const float* q, int n, int overflow,
                       float* raw, int* hkey, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  moments_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      skey_s, perm, q, n, overflow, raw, hkey);
  return status();
}

// h_sorted, perm: the first kcap rows of the head-compaction sort.  Writes
// t_packed [kcap].
int preprocess_compact(const int* h_sorted, const i64* perm, const int* skey_s, int kcap,
                       int* t_packed, void* stream) {
  if (kcap < 1) return static_cast<int>(cudaErrorInvalidValue);
  compact_kernel<<<blocks(kcap), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h_sorted, perm, skey_s, kcap, t_packed);
  return status();
}

// fk [kcap] ascending packed keys; perm3 may be null.  Writes m_out [kcap,
// 10] and key_out [kcap] (y in the minor bits).
int preprocess_pass_z(const int* fk, const i64* perm3, const i64* perm2, const float* table_m,
                      int kcap, float vs, float* m_out, int* key_out, void* stream) {
  if (kcap < 1) return static_cast<int>(cudaErrorInvalidValue);
  pass_z_kernel<<<blocks(kcap), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fk, perm3, perm2, table_m, kcap, vs, m_out, key_out);
  return status();
}

// ky [kcap] sorted, perm4 its permutation.  Writes m_out [kcap, 10] and
// key_out [kcap] (x in the minor bits).
int preprocess_pass_y(const int* ky, const i64* perm4, const float* m_z, const int* fk, int kcap,
                      float vs, float* m_out, int* key_out, void* stream) {
  if (kcap < 1) return static_cast<int>(cudaErrorInvalidValue);
  pass_y_kernel<<<blocks(kcap), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ky, perm4, m_z, fk, kcap, vs, m_out, key_out);
  return status();
}

// kx [kcap] sorted, perm5 its permutation.  Writes out_points [k_out, 3],
// out_covs [k_out, 3, 3] and out_valid [k_out]; k_out >= kcap.
int preprocess_pass_x(const int* kx, const i64* perm5, const float* m_y, const i64* perm4,
                      const int* fk, const i64* perm3, const i64* perm2, const i64* perm1,
                      const float* q, int kcap, int k_out, float vs, float one_minus_eps,
                      float min_neighbors, float* out_points, float* out_covs, bool* out_valid,
                      void* stream) {
  if (kcap < 1 || k_out < kcap) return static_cast<int>(cudaErrorInvalidValue);
  pass_x_kernel<<<blocks(k_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      kx, perm5, m_y, perm4, fk, perm3, perm2, perm1, q, kcap, k_out, vs, one_minus_eps,
      min_neighbors, out_points, out_covs, out_valid);
  return status();
}

const char* preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
