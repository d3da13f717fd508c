// One Gauss-Newton pass of `models/registration.py::align`, around kernel A,
// hand-written for Hopper (sm_90a): the correspondence lookup before kernel A
// and the increment after it.
//
// Replaces no Pallas kernel: the JAX package leaves both to XLA, which fuses
// `eskf_lio_tpu/map/voxel_map.py::lookup_packed`'s key arithmetic and two
// bucket-row gathers into a few programs, and `ops/lie.py::se3_exp` with the
// 6x6 solve and the compose into a few more.  Captured op by op into the
// port's CUDA graph, the same chain (`lie.transform_points`,
// `voxel_map.lookup`, `solve_increment`, `se3_exp`, the compose,
// `converged_check`) was ~100 small kernels a pass inside the GN loop's
// WHILE node, ~0.42 ms a pass at 12,288 and at 24,576 rows alike: launches,
// not work.  Here a pass is three launches: `lookup`, kernel A
// (`csrc/gn_normal_eq.cu`, unchanged), `increment`.
//
// lookup (one launch over the align rows, eight lanes a row):
//   pts_w = R p + t (the loop's carry read on the device), the voxel key
//   floor(pts_w / voxel_size), packed around the map's origin under the
//   capture's key split, the span test, the skey (the bijective 32-bit mixer
//   in native uint32 arithmetic, `sortmerge.skey_of`'s bits and sentinel
//   remap), the bucket (`sortmerge.bucket_of`), then one probe of the main
//   view and one of the delta view: each of a row's eight lanes reads its
//   slot's skey word in both tiers, a ballot gives the first match, and the
//   row's first lane reads the two hit slots' 10-word payloads and combines
//   the tiers under the point cap in `voxel_map._combine`'s order of
//   operations.  It writes pts_w, mu [N,3], the packed map covariance [N,6]
//   and mask = valid & hit, which kernel A reads as they are.
//   Bound on the H100: bytes, and the latency of two dependent random reads.
//   The main view is 128 MiB at C = 2^19, beyond the 50 MB L2; a row touches
//   8 sectors of skey words and the hit slot's in each tier, ~15 MB a pass
//   at 24,576 rows, ~5 us at 3.35 TB/s.  So the design keeps many loads in
//   flight: 8 lanes a row (196,608 threads at 24,576 rows), both tiers' skey
//   loads issued before either is used, and both hit payloads (three vector
//   loads each, within the slot's 64 bytes) issued before either is used.
//
// increment (one block, one thread): reads J^T W J, J^T W r and the count
//   that kernel A wrote, adds `solve_increment`'s regulariser
//   1e-3 (1 - ok) + 1e-8 on the diagonal, solves the 6x6 system by LU with
//   partial pivoting (as `torch.linalg.solve_ex` does on the card; SPD after
//   the regulariser), sets xi = 0 below 6 correspondences, takes se3_exp(xi)
//   with `lie._sinc` / `_cosc`'s small-angle forms and the left Jacobian,
//   left-composes R, t, and writes the loop's next carry: converged,
//   it + 1, active, R, t, the count, and (for the adaptive re-match) R_d,
//   t_d.  Bound: the latency of one thread's dependent chain (~300 flops,
//   two IEEE divisions a pivot, sinf/cosf), ~1-2 us; no block-wide step
//   would shorten it, and the matrix stays in registers (every index is a
//   compile-time constant; a pivot swap is a select).
//
// Numerics: float32 throughout, no fast math, IEEE division and square
// root, built with -fmad=false so that no a*b+c is contracted where torch
// rounds twice.  The lookup gives `voxel_map.lookup`'s mu, covariance and
// hit bit for bit for the same pts_w, and pts_w equals
// `lie.transform_points`' (cuBLAS's inner-3 product as an fma chain from
// k = 0, as `csrc/preprocess.cu` measured).  The increment gives the plain
// chain's bits too: each op in the order torch's kernels on the card take
// (the solve's, the reductions' over 3 and the 3x3 products' were found
// against torch 2.11's on an H100 and are named where they are used), and
// sinf / cosf, the functions torch.sin / torch.cos call.  So the GN loop's
// passes, iterations and pose are the torch chain's, bit for bit.
//
// Capture-safe: no scratch, no host reads, no allocation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // one lane per slot of a view's bucket row
constexpr int kRowsPerBlock = kThreads / kLanes;
constexpr int kSlotWords = 16;  // int32 words a slot: skey, row, payload x10, pad
constexpr int kRowWords = kLanes * kSlotWords;  // 128 words: one 512-byte bucket row
constexpr int kDead = 2147483647;  // INT32_MAX: empty / out-of-span key
constexpr unsigned kSign = 0x80000000u;
constexpr unsigned kFull = 0xffffffffu;

typedef long long i64;

// torch.clamp(x, min=lo) and torch.minimum: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// one output of a cuBLAS product with an inner size of 3, as an fma chain
// from k = 0 (`csrc/preprocess.cu`)
__device__ __forceinline__ float gemm3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// one output of cuBLAS's [3, 3] @ [3], [3, 3] @ [3, 1] and [3, 3] @ [3, 3]
// (measured on the card: these small products take one order, the
// [N, 3] @ [3, 3] of `transform_points` the other)
__device__ __forceinline__ float gemv3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// torch.sum over a last dimension of 3
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return (x0 + x2) + x1; }

// sortmerge.mix32: the lowbias32 finalizer
__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the hit slot's payload words 2..11 (count, mean or sums, covariance) as
// floats: three vector loads inside the slot's 64 bytes
__device__ __forceinline__ void load_payload(const int* slot, float pay[10]) {
  const int2 a = *reinterpret_cast<const int2*>(slot + 2);
  const int4 b = *reinterpret_cast<const int4*>(slot + 4);
  const int4 c = *reinterpret_cast<const int4*>(slot + 8);
  pay[0] = __int_as_float(a.x);
  pay[1] = __int_as_float(a.y);
  pay[2] = __int_as_float(b.x);
  pay[3] = __int_as_float(b.y);
  pay[4] = __int_as_float(b.z);
  pay[5] = __int_as_float(b.w);
  pay[6] = __int_as_float(c.x);
  pay[7] = __int_as_float(c.y);
  pay[8] = __int_as_float(c.z);
  pay[9] = __int_as_float(c.w);
}

struct LookupArgs {
  const float* pts;       // [n, 3] body-frame scan points
  const uint8_t* valid;   // [n]
  const float* R;         // [3, 3] row-major, the loop's carry
  const float* t;         // [3]
  const int* origin;      // [3] the map's packing origin
  const int* view;        // [nb, 128] main tier
  const int* d_view;      // [d_nb, 128] delta tier
  int view_bits, d_view_bits;  // log2 of each view's bucket count (0: one bucket)
  int bx, by, bz;         // the key split
  float voxel_size, cap;  // max_points_per_voxel as a float
  const uint8_t* need;    // or null: look up only where need[0] (adaptive re-match)
  const i64* it;          // without need, with relook > 1: only where it % relook == 0
  int relook;
  int n;
  float* pts_w;           // [n, 3]
  float* mu;              // [n, 3]
  float* covm;            // [n, 6]
  uint8_t* mask;          // [n]
};

__global__ void __launch_bounds__(kThreads) lookup_kernel(const LookupArgs a) {
  __shared__ float s_rt[12];
  __shared__ int s_origin[3];
  __shared__ int s_do;
  const int tid = threadIdx.x;
  if (tid < 9) s_rt[tid] = a.R[tid];
  else if (tid < 12) s_rt[tid] = a.t[tid - 9];
  else if (tid < 15) s_origin[tid - 12] = a.origin[tid - 12];
  else if (tid == 15) {
    // the adaptive re-match, where it is on, decides alone (as the chain's test)
    s_do = a.need != nullptr ? a.need[0] != 0 : a.relook <= 1 || (*a.it % a.relook) == 0;
  }
  __syncthreads();

  const int lane = tid & (kLanes - 1);
  const int group = (tid & 31) / kLanes;  // the row's place in its warp
  const i64 row = static_cast<i64>(blockIdx.x) * kRowsPerBlock + tid / kLanes;
  const bool live = row < a.n;
  const i64 r = live ? row : 0;

  float pw[3];
  {
    const float x = a.pts[3 * r], y = a.pts[3 * r + 1], z = a.pts[3 * r + 2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pw[c] = gemm3(x, y, z, s_rt[3 * c], s_rt[3 * c + 1], s_rt[3 * c + 2]) + s_rt[9 + c];
    }
  }
  if (live && lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.pts_w[3 * row + c] = pw[c];
  }
  if (!s_do) return;  // the same for the whole block: no lane waits in a ballot

  // voxel key, packing and span test (`vx.voxel_key`, `sortmerge.pack_keys`)
  const int bits[3] = {a.bx, a.by, a.bz};
  unsigned rel[3];
  bool in_range = true;
  // torch divides by a Python number as a product with its reciprocal
  const float inv = 1.0f / a.voxel_size;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int key = static_cast<int>(floorf(pw[c] * inv));
    rel[c] = static_cast<unsigned>(key) - static_cast<unsigned>(s_origin[c]);
    in_range = in_range && (rel[c] >> bits[c]) == 0u;
  }
  int packed = static_cast<int>((rel[0] << (a.by + a.bz)) | (rel[1] << a.bz) | rel[2]);
  if (a.bx + a.by + a.bz == 31) in_range = in_range && packed != kDead;
  if (!in_range) packed = kDead;
  // `sortmerge.skey_of`
  int skey = static_cast<int>(mix32(static_cast<unsigned>(packed)) ^ kSign);
  if (skey == kDead) skey = kDead - 1;
  if (packed == kDead) skey = kDead;
  const unsigned order = static_cast<unsigned>(skey) ^ kSign;
  const i64 b = a.view_bits > 0 ? static_cast<i64>(order >> (32 - a.view_bits)) : 0;
  const i64 db = a.d_view_bits > 0 ? static_cast<i64>(order >> (32 - a.d_view_bits)) : 0;

  // both tiers' skey words in flight, then one ballot each
  const int* m_row = a.view + b * kRowWords;
  const int* d_row = a.d_view + db * kRowWords;
  const int m_word = m_row[lane * kSlotWords];
  const int d_word = d_row[lane * kSlotWords];
  const unsigned m_eq = (__ballot_sync(kFull, live && m_word == skey) >> (group * kLanes)) & 0xffu;
  const unsigned d_eq = (__ballot_sync(kFull, live && d_word == skey) >> (group * kLanes)) & 0xffu;
  if (!live || lane != 0) return;

  // `_view_probe`: the first match; found only for a real key
  const bool m_hit = m_eq != 0u && skey != kDead && in_range;
  const bool d_hit = d_eq != 0u && skey != kDead && in_range;
  float pm[10], pd[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) pm[k] = pd[k] = 0.0f;
  if (m_hit) load_payload(m_row + (__ffs(m_eq) - 1) * kSlotWords, pm);
  if (d_hit) load_payload(d_row + (__ffs(d_eq) - 1) * kSlotWords, pd);

  // `voxel_map._combine`: main stats + the delta's raw sums under the cap
  const float c_main = pm[0], c_add = pd[0];
  const float cap_add = minimum(clamp_min(a.cap - c_main, 0.0f), c_add);
  const float scale = c_add > 0.0f ? cap_add / clamp_min(c_add, 1.0f) : 0.0f;
  const float denom = clamp_min(c_main + cap_add, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) a.mu[3 * row + c] = (c_main * pm[1 + c] + scale * pd[1 + c]) / denom;
#pragma unroll
  for (int k = 0; k < 6; ++k) a.covm[6 * row + k] = (c_main * pm[4 + k] + scale * pd[4 + k]) / denom;
  a.mask[row] = (a.valid[row] != 0 && (m_hit || d_hit)) ? 1 : 0;
}

// `lie._sinc`, `_cosc` and the left Jacobian's (theta - sin)/theta^3, with
// their small-angle forms below 1e-6 rad
constexpr float kSmall = 1e-6f;

__device__ __forceinline__ float div_by_number(float x, float s) { return x * (1.0f / s); }

struct IncrementArgs {
  const float* JTJ;   // [6, 6] row-major
  const float* JTr;   // [6]
  const float* num;   // the correspondence count (f32)
  const float* R;     // [3, 3] row-major: the carry before the pass
  const float* t;     // [3]
  const i64* it;      // or null: 0
  int max_iterations;
  float cos_thr, tsq_thr;
  uint8_t* active;
  i64* it_out;
  uint8_t* conv;
  float* R_out;       // may be R
  float* t_out;       // may be t
  float* num_out;
  float* R_d;         // or null: the increment, for the adaptive re-match
  float* t_d;
};

__global__ void increment_kernel(const IncrementArgs a) {
  // every input into registers before any output is written (in place)
  float A[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = a.JTJ[6 * i + j];
    A[i][6] = -a.JTr[i];
  }
  const float num = *a.num;
  float R0[9], t0[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R0[k] = a.R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t0[k] = a.t[k];
  const i64 it = a.it != nullptr ? *a.it : 0;

  // `solve_increment`: JTJ + reg I, reg = 1e-3 (1 - ok) + 1e-8 (torch adds
  // reg * 0 off the diagonal too, which turns a -0 into +0)
  const bool ok = num >= 6.0f;
  const float reg = 1e-3f * (1.0f - (ok ? 1.0f : 0.0f)) + 1e-8f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = A[i][j] + (i == j ? reg : 0.0f);
  }

  // torch.linalg.solve_ex's rounding on the card (cuSOLVER's getrf, then
  // cuBLAS's row swaps and two triangular solves), as measured against it:
  // the first largest |pivot|, the column scaled by the pivot's reciprocal,
  // the trailing update as an fma; the right-hand side column swapped and
  // updated alongside (the unit-lower solve, by ascending column, fma); the
  // upper solve by descending column, fma, then a division by the diagonal
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool s = p == i;
#pragma unroll
      for (int j = k; j < 7; ++j) {
        const float u = A[k][j], v = A[i][j];
        A[k][j] = s ? v : u;
        A[i][j] = s ? u : v;
      }
    }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] = fmaf(-l, A[k][j], A[i][j]);
    }
  }
  float xi[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int j = 5; j > i; --j) s = fmaf(-A[i][j], xi[j], s);
    xi[i] = s / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = ok ? xi[i] : 0.0f;

  // `lie.se3_exp`: rho first, phi last; R = I + sinc K + cosc K^2,
  // t = J_l(phi) rho with J_l = I + cosc K + c2 K^2, K^2 = phi phi^T - |phi|^2 I
  const float rho[3] = {xi[0], xi[1], xi[2]};
  const float ph[3] = {xi[3], xi[4], xi[5]};
  const float nsq = sum3(ph[0] * ph[0], ph[1] * ph[1], ph[2] * ph[2]);
  const float theta = sqrtf(nsq);
  const bool small = fabsf(theta) < kSmall;
  const float ts = small ? 1.0f : theta;
  const float th2 = theta * theta;
  const float sinc = small ? 1.0f - div_by_number(th2, 6.0f) : sinf(ts) / ts;
  const float cosc = small ? 0.5f - div_by_number(th2, 24.0f) : (1.0f - cosf(ts)) / (ts * ts);
  const float c2 = small ? (1.0f / 6.0f) - div_by_number(th2, 120.0f)
                         : (ts - sinf(ts)) / ((ts * ts) * ts);
  const float K[9] = {0.0f, -ph[2], ph[1], ph[2], 0.0f, -ph[0], -ph[1], ph[0], 0.0f};
  float Rd[9], J[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float sq = ph[i] * ph[j] - nsq * eye;
      Rd[3 * i + j] = (eye + sinc * K[3 * i + j]) + cosc * sq;
      J[3 * i + j] = (eye + cosc * K[3 * i + j]) + c2 * sq;
    }
  }
  float td[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    td[i] = gemv3(J[3 * i], J[3 * i + 1], J[3 * i + 2], rho[0], rho[1], rho[2]);
  }

  // left-compose (`Registration.cpp:19`) and `converged_check`
  float R1[9], t1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R1[3 * i + j] = gemv3(Rd[3 * i], Rd[3 * i + 1], Rd[3 * i + 2], R0[j], R0[3 + j], R0[6 + j]);
    }
    t1[i] = gemv3(Rd[3 * i], Rd[3 * i + 1], Rd[3 * i + 2], t0[0], t0[1], t0[2]) + td[i];
  }
  const float cosine = 0.5f * (sum3(Rd[0], Rd[4], Rd[8]) - 1.0f);
  const float t_sq = sum3(td[0] * td[0], td[1] * td[1], td[2] * td[2]);
  const bool conv = cosine >= a.cos_thr && t_sq <= a.tsq_thr;
  const i64 it1 = it + 1;

#pragma unroll
  for (int k = 0; k < 9; ++k) a.R_out[k] = R1[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) a.t_out[k] = t1[k];
  *a.it_out = it1;
  *a.conv = conv ? 1 : 0;
  *a.active = (it1 < a.max_iterations && !conv) ? 1 : 0;
  *a.num_out = num;
  if (a.R_d != nullptr) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.R_d[k] = Rd[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.t_d[k] = td[k];
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

int bucket_bits(int n_buckets) {
  int bits = 0;
  while ((2LL << bits) <= n_buckets) ++bits;  // floor(log2), as `bucket_of`
  return n_buckets <= 1 ? 0 : bits;
}

}  // namespace

extern "C" {

// pts [n, 3] f32 and valid [n] bytes: the scan; R [3, 3] row-major and t [3]
// f32: the pose (device memory, read by the kernel); origin [3] int32 and
// the views [nb, 128] / [d_nb, 128] int32 of a `VoxelMap`; the key split
// (bx, by, bz); voxel_size; cap = max_points_per_voxel.  need (byte) or
// null, else it (int64) with relook > 1, choose whether the lookup runs
// (else only pts_w is written and mu, covm, mask keep what they hold).
// Writes pts_w, mu [n, 3], covm [n, 6] and mask [n].
int gn_lookup_launch(const float* pts, const uint8_t* valid, const float* R, const float* t,
                     const int* origin, const int* view, int nb, const int* d_view, int d_nb,
                     int bx, int by, int bz, float voxel_size, float cap, const uint8_t* need,
                     const i64* it, int relook, int n, float* pts_w, float* mu, float* covm,
                     uint8_t* mask, void* stream) {
  if (n < 1 || nb < 1 || d_nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const LookupArgs a{pts, valid, R, t, origin, view, d_view, bucket_bits(nb), bucket_bits(d_nb),
                     bx, by, bz, voxel_size, cap, need, it, relook, n, pts_w, mu, covm, mask};
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  lookup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return status();
}

// JTJ [36], JTr [6], num (f32): kernel A's sums; R [9], t [3]: the pose the
// pass started from; it (int64) or null for 0.  Writes active (byte),
// it_out (int64), conv (byte), R_out [9], t_out [3] (may be R, t), num_out
// and, when R_d is not null, R_d [9], t_d [3].
int gn_increment_launch(const float* JTJ, const float* JTr, const float* num, const float* R,
                        const float* t, const i64* it, int max_iterations, float cos_thr,
                        float tsq_thr, uint8_t* active, i64* it_out, uint8_t* conv,
                        float* R_out, float* t_out, float* num_out, float* R_d, float* t_d,
                        void* stream) {
  const IncrementArgs a{JTJ, JTr, num, R, t, it, max_iterations, cos_thr, tsq_thr, active,
                        it_out, conv, R_out, t_out, num_out, R_d, t_d};
  increment_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return status();
}

const char* gn_pass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
