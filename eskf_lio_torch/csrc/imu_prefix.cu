// The parallel-prefix IMU propagation of `models/eskf.py::predict_chunk_prefix`
// in one launch, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the prefix to XLA
// (`eskf_lio_tpu/models/eskf.py::predict_chunk_prefix`, two
// `jax.lax.associative_scan`s, two cumsums and an einsum, fused into a few
// programs).  Captured op by op into the port's CUDA graph, the same chain
// (`models/eskf.py::imu_prefix_ref`) is ~390 small kernels a call at M = 64
// or 32 IMU samples (two Hillis-Steele scans of log2 M rounds, each round a
// `cat` and a `quat_mul` or a batched 18x18 `matmul`; `_transition`'s slice
// writes; two cumsums; the [M, 18, 18] noise sum): ~0.45 ms of launches for
// a few microseconds of arithmetic.
//
// One block of 1024 threads, M <= 64 samples, every phase in shared memory,
// the outputs written where the caller reads them:
//   samples   a thread a sample: the masks, the bias-corrected rates,
//             quat_exp of each (identity where masked), the noise diagonal,
//             the base sample (an atomicMax)
//   attitude  the quaternion Hillis-Steele scan (log2 M rounds), q0 x prefix
//             normalised: the history's q
//   motion    R_{j-1}, R a + g, the blocks of the transition F_j
//             (`_transition`: R [a]x, R, quat_to_mat(conj dq)); then warp 0
//             takes the velocity and position cumsums (three lanes, M
//             dependent steps) while the other warps write the transitions'
//             dense blocks, in reverse order
//   scan      the reversed Hillis-Steele scan of 18x18 products on the
//             transitions' block pattern (below): a thread one 3x3 dense
//             block of one product, lanes on consecutive products, two
//             buffers of M tiles, a barrier a round
//   noise     (S_m D_m) S_m^T's 25 blocks for every m into the free buffer,
//             and S P beside it; then the sum over m and S P S^T, the sum of
//             both, and 0.5 (P + P^T)
// Bound on the H100: latency.  The dense products would be ~2.2 M fmas at
// M = 64 (the scan's 321 products and the noise's 64, 5,832 each); on the
// pattern they are ~0.2 M, spread over 6 dependent rounds, and the inputs
// and outputs are under 10 KB.  So the design keeps everything on chip
// (166 KB of tiles at M = 64), computes only what can be nonzero, unrolls
// each block's terms with constant offsets, keeps lanes on distinct banks
// (an odd tile stride), and overlaps the sequential cumsums with the
// transitions' construction.

// Numerics: the chain's bits on the card.  float32, no fast math, IEEE
// division and square root, built with -fmad=false so that no a*b+c is
// contracted where torch rounds twice; sinf / cosf, which torch.sin /
// torch.cos call.  Where torch's kernels fuse or reorder, the helpers below
// take their order, found by saving torch 2.11's inputs and outputs on an
// H100 for real and random chunks at M = 32, 48 and 64 and matching
// candidate orders in numpy:
//   * a batched [3,3] @ [3,3] and every batched [18,18] @ [18,18], plain or
//     with the right operand transposed (cuBLAS's sm80_xmma_gemm ... ffma
//     kernels): one fma chain from +0 over k = 0..K-1 (`product_block`,
//     `noise_block`, the transition's R [a]x);
//   * the batched [3,3] @ [3,1] (cuBLAS's gemvx): fma(a1, b1, fma(a0, b0, 0))
//     + fma(a2, b2, 0) (`gemvx3`);
//   * [18,18] @ [18,18] (CUTLASS's simt sgemm, split K, then cublasLt's
//     splitKreduce): chains from +0 over k in groups of 8, summed in order
//     (`split_k`, 8); with the right operand transposed, groups of 4;
//   * linalg.norm over 3: sqrt((x0^2 + x2^2) + x1^2); over 4:
//     sqrt((x0^2 + x2^2) + (x1^2 + x3^2)) (torch's reduce kernel, two or
//     four lanes and a shuffle);
//   * cumsum along dim 0 (tensor_kernel_scan_outer_dim): acc = 0, acc += x
//     in order;
//   * .sum(0) of [M, 18, 18] (reduce_kernel<128, 4>): row r into
//     accumulator r % 4, the four summed in order; at M = 64 the rows split
//     over four warps (warp y: rows y, y + 4, ..., its n-th row into
//     accumulator n % 4), each warp's four summed in order, the warps as
//     (w0 + w2) + (w1 + w3) (`sum_rows`);
//   * division by a Python number: a product with its reciprocal.
// The Hillis-Steele combine trees are the chain's: round k combines
// x[i - k] with x[i] for i >= k.
//
// Capture-safe: no scratch, no global atomics, no host reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxM = 64;
constexpr int kN = 18;              // error-state dimension
constexpr int kMat = kN * kN;       // the entries of one 18x18 tile
constexpr int kStride = kMat + 1;   // floats a tile in shared memory: odd, so that
                                    // lanes on consecutive tiles hit distinct banks
constexpr int kDense = 99;          // the entries of a product's dense blocks
constexpr int kNoise = 15 * 15;     // the entries of (S D) S^T that can be nonzero

// ---- torch's float32 rounding of the chain's small ops ------------------

// x / <Python number>: torch's CUDA division multiplies by the reciprocal
__device__ __forceinline__ float div_by_number(float x, float s) { return x * (1.0f / s); }

// one output of the batched [3,3] @ [3,1] (cuBLAS's gemvx)
__device__ __forceinline__ float gemvx3(float a0, float a1, float a2, float b0, float b1,
                                        float b2) {
  return fmaf(a1, b1, fmaf(a0, b0, 0.0f)) + fmaf(a2, b2, 0.0f);
}

// lie.quat_mul, each product and sum rounded as torch's elementwise ops
__device__ __forceinline__ void quat_mul(const float q[4], const float p[4], float o[4]) {
  o[0] = ((q[0] * p[0] - q[1] * p[1]) - q[2] * p[2]) - q[3] * p[3];
  o[1] = ((q[0] * p[1] + q[1] * p[0]) + q[2] * p[3]) - q[3] * p[2];
  o[2] = ((q[0] * p[2] - q[1] * p[3]) + q[2] * p[0]) + q[3] * p[1];
  o[3] = ((q[0] * p[3] + q[1] * p[2]) - q[2] * p[1]) + q[3] * p[0];
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

// ---- the transitions' block pattern ---------------------------------------
//
// In 3x3 blocks (p, v, theta, b_a, b_g, g) every F_j and every product of
// them has the pattern
//   [I * * * * *]      I: exactly the identity, *: dense, 0: exactly zero
//   [0 I * * * *]
//   [0 0 * 0 * 0]
//   [0 0 0 I 0 0]   (rows 9..17: the identity)
//   ...
// For finite factors a term with a factor that is exactly 0 changes no fma
// chain from +0 (its sum is never -0, and +-0 added to it leaves it), and a
// chain over the identity's entries is the identity.  So a product computes
// only its 11 dense blocks (99 entries), each entry over the k where both
// factors can be nonzero, in ascending k (an identity block gives the one
// term k = i or k = j, its factor exactly 1); its other entries are those of
// F and are not stored.  (S D) S^T likewise: D is 0 outside j = 3..14, so
// only its first 15 rows and columns can be nonzero.  With a factor that is
// not finite (a NaN or Inf input, or a product past float32's range) a
// skipped term is no longer +-0: the base P is then not finite, as the
// chain's is, but its entries need not be the chain's.

constexpr int kZero = 0, kIdentity = 1, kFull = 2;

// the kind of block (rb, kb) of the pattern
__host__ __device__ constexpr int block_kind(int rb, int kb) {
  return rb == 0   ? (kb == 0 ? kIdentity : kFull)
         : rb == 1 ? (kb == 0 ? kZero : (kb == 1 ? kIdentity : kFull))
         : rb == 2 ? ((kb == 2 || kb == 4) ? kFull : kZero)
                   : (kb == rb ? kIdentity : kZero);
}

// whether entry (i, j) lies in a dense block
__device__ __forceinline__ bool in_dense_block(int i, int j) {
  return block_kind(i / 3, j / 3) == kFull;
}

// the b-th dense block (0..10): (0, 1..5), (1, 2..5), (2, 2), (2, 4)
__device__ __forceinline__ void dense_block(int b, int& rb, int& cb) {
  if (b < 5) {
    rb = 0;
    cb = b + 1;
  } else if (b < 9) {
    rb = 1;
    cb = b - 3;
  } else {
    rb = 2;
    cb = b == 9 ? 2 : 4;
  }
}

// the n-th of the 99 dense entries as i * 18 + j, block by block
__device__ __forceinline__ int dense_entry(int n) {
  int rb, cb;
  dense_block(n / 9, rb, cb);
  return (3 * rb + (n % 9) / 3) * kN + 3 * cb + n % 3;
}

// block (RB, CB) of C = A @ B on the pattern: each entry one fma chain from
// +0 over its terms in ascending k (unrolled: every offset a constant)
template <int RB, int CB>
__device__ __forceinline__ void product_block(const float* A, const float* B, float* C) {
  float acc[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = 0.0f;
  }
#pragma unroll
  for (int kb = 0; kb < 6; ++kb) {
    const int ka = block_kind(RB, kb), kk = block_kind(kb, CB);
    if (ka == kZero || kk == kZero) continue;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (ka == kIdentity) {
            // the term k = i, A[i][i] = 1
            if (t == r) acc[r][c] = fmaf(1.0f, B[(3 * kb + r) * kN + 3 * CB + c], acc[r][c]);
          } else if (kk == kIdentity) {
            // the term k = j, B[j][j] = 1
            if (t == c) acc[r][c] = fmaf(A[(3 * RB + r) * kN + 3 * kb + c], 1.0f, acc[r][c]);
          } else {
            acc[r][c] = fmaf(A[(3 * RB + r) * kN + 3 * kb + t], B[(3 * kb + t) * kN + 3 * CB + c],
                             acc[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) C[(3 * RB + r) * kN + 3 * CB + c] = acc[r][c];
  }
}

// the b-th dense block of C = A @ B
__device__ void product_block(int b, const float* A, const float* B, float* C) {
  switch (b) {
    case 0: return product_block<0, 1>(A, B, C);
    case 1: return product_block<0, 2>(A, B, C);
    case 2: return product_block<0, 3>(A, B, C);
    case 3: return product_block<0, 4>(A, B, C);
    case 4: return product_block<0, 5>(A, B, C);
    case 5: return product_block<1, 2>(A, B, C);
    case 6: return product_block<1, 3>(A, B, C);
    case 7: return product_block<1, 4>(A, B, C);
    case 8: return product_block<1, 5>(A, B, C);
    case 9: return product_block<2, 2>(A, B, C);
    default: return product_block<2, 4>(A, B, C);
  }
}

// block (IB, LB) of (S D) S^T (IB, LB < 5) on the pattern, into T at entry
// i * 15 + l: each entry one fma chain from +0 over j in 3..14 where both
// S[i][j] and S[l][j] can be nonzero, S[i][j] D[j] rounded first
template <int IB, int LB>
__device__ __forceinline__ void noise_block(const float* S, const float* D, float* T) {
  float acc[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = 0.0f;
  }
#pragma unroll
  for (int jb = 1; jb < 5; ++jb) {
    const int ki = block_kind(IB, jb), kl = block_kind(LB, jb);
    if (ki == kZero || kl == kZero) continue;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * IB + r, l = 3 * LB + c;
        if (ki == kIdentity && kl == kIdentity) {
          if (r == c) acc[r][c] = fmaf(1.0f * D[i], 1.0f, acc[r][c]);  // j = i = l
        } else if (ki == kIdentity) {
          acc[r][c] = fmaf(1.0f * D[i], S[l * kN + i], acc[r][c]);  // j = i
        } else if (kl == kIdentity) {
          acc[r][c] = fmaf(S[i * kN + l] * D[l], 1.0f, acc[r][c]);  // j = l
        } else {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int j = 3 * jb + t;
            acc[r][c] = fmaf(S[i * kN + j] * D[j], S[l * kN + j], acc[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) T[(3 * IB + r) * 15 + 3 * LB + c] = acc[r][c];
  }
}

template <int IB>
__device__ __forceinline__ void noise_row(int lb, const float* S, const float* D, float* T) {
  switch (lb) {
    case 0: return noise_block<IB, 0>(S, D, T);
    case 1: return noise_block<IB, 1>(S, D, T);
    case 2: return noise_block<IB, 2>(S, D, T);
    case 3: return noise_block<IB, 3>(S, D, T);
    default: return noise_block<IB, 4>(S, D, T);
  }
}

// block b = 5 ib + lb of (S D) S^T; with S = I (`identity`) its one term
// on the diagonal, (1 D_i) 1, for i in 3..14
__device__ void noise_block(int b, const float* S, const float* D, float* T, bool identity) {
  const int ib = b / 5, lb = b - 5 * ib;
  if (identity) {
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        const int i = 3 * ib + r;
        T[i * 15 + 3 * lb + c] = (ib == lb && r == c && ib >= 1) ? fmaf(1.0f * D[i], 1.0f, 0.0f)
                                                                   : 0.0f;
      }
    }
    return;
  }
  switch (ib) {
    case 0: return noise_row<0>(lb, S, D, T);
    case 1: return noise_row<1>(lb, S, D, T);
    case 2: return noise_row<2>(lb, S, D, T);
    case 3: return noise_row<3>(lb, S, D, T);
    default: return noise_row<4>(lb, S, D, T);
  }
}

// one output of an [18,18] @ [18,18] product as CUTLASS's split-K gemm and
// cublasLt's reduce take it: fma chains from +0 over k in groups of
// `group`, the partial sums added in order.  a(k), b(k): the k-th terms.
template <int kGroup, typename FA, typename FB>
__device__ __forceinline__ float split_k(FA a, FB b) {
  float total = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kN; k0 += kGroup) {
    float acc = 0.0f;
#pragma unroll
    for (int k = k0; k < k0 + kGroup && k < kN; ++k) acc = fmaf(a(k), b(k), acc);
    total = k0 == 0 ? acc : total + acc;
  }
  return total;
}

// torch's .sum(0) over m tiles of entry e (tile r at T[r * kStride + e],
// reduce_kernel<128, 4>): row r into accumulator r % 4, the four added in
// order; from m = 64 warp y of four takes rows y, y + 4, ... (its n-th
// into accumulator n % 4), and the warps' sums are (w0 + w2) + (w1 + w3)
__device__ __forceinline__ float sum_rows(const float* T, int m, int e) {
  if (m < 64) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < m; ++r) acc[r & 3] = acc[r & 3] + T[r * kStride + e];
    return ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  float w[4];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int n = 0;
    for (int r = y; r < m; r += 4, ++n) acc[n & 3] = acc[n & 3] + T[r * kStride + e];
    w[y] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  return (w[0] + w[2]) + (w[1] + w[3]);
}

struct Args {
  // the filter state
  const float* p;      // [3]
  const float* v;      // [3]
  const float* q;      // [4]
  const float* ba;     // [3]
  const float* bg;     // [3]
  const float* g;      // [3]
  const float* P;      // [18, 18]
  // the chunk
  const float* dt;     // [m]
  const float* t_rel;  // [m]
  const float* gyro;   // [m, 3]
  const float* accel;  // [m, 3]
  const uint8_t* valid;      // [m]
  const uint8_t* base_mask;  // [m] or null: the valid samples
  const float* q_diag;       // [12]
  int m;
  // outputs
  float* hist_t;         // [m + 1]
  float* hist_p;         // [m + 1, 3]
  float* hist_q;         // [m + 1, 4]
  uint8_t* hist_valid;   // [m + 1]
  float* base_p;         // [3]
  float* base_v;         // [3]
  float* base_q;         // [4]
  float* base_P;         // [18, 18]
};

struct Shared {
  float st[22];             // p, v, q, ba, bg, g
  float P[kMat];            // the state's covariance
  float q_diag[12];
  float dt_ok[kMaxM];       // dt where the sample is used, else 0
  float dt_b[kMaxM];        // dt where the sample is in the base prefix, else 0
  uint8_t ok[kMaxM];
  uint8_t bm[kMaxM];
  float a[kMaxM][3];        // accel - ba (0 where masked)
  float dq[kMaxM][4];       // quat_exp of each sample
  float qs[2][kMaxM][4];    // the attitude scan's two buffers
  float q_hist[kMaxM + 1][4];
  float u[kMaxM][3];        // R_{j-1} a_j + g
  float blk[kMaxM][27];     // -(R [a]x) dt, -R dt, the attitude block
  float D[kMaxM][kN];       // the noise diagonal of each sample
  float SP[kMat];           // S P
  float SPS[kMat];          // S P S^T
  float Tsum[kMat];         // the noise sum
  float Pb[kMat];           // S P S^T + the noise sum
  float p_hist[kMaxM + 1][3];
  float v_hist[kMaxM + 1][3];
  int n_base;
};

__global__ void __launch_bounds__(kThreads) imu_prefix_kernel(const Args a) {
  extern __shared__ float4 dyn[];
  __shared__ Shared s;
  float* buf0 = reinterpret_cast<float*>(dyn);  // m tiles of kStride floats
  float* buf1 = buf0 + a.m * kStride;            // m tiles of kStride floats
  const int tid = threadIdx.x;
  const int m = a.m;

  // ---- inputs -------------------------------------------------------------
  // a sample's own inputs stay in its thread's registers
  float in_dt = 0.0f, in_acc[3] = {0.0f, 0.0f, 0.0f}, in_gyr[3] = {0.0f, 0.0f, 0.0f};
  bool in_valid = false, in_base = false;
  if (tid < m) {
    in_dt = a.dt[tid];
    in_valid = a.valid[tid] != 0;
    in_base = a.base_mask == nullptr || a.base_mask[tid] != 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in_acc[c] = a.accel[3 * tid + c];
      in_gyr[c] = a.gyro[3 * tid + c];
    }
  } else if (tid < m + 3) {
    const int c = tid - m;
    s.st[c] = a.p[c];
    s.st[3 + c] = a.v[c];
    s.st[10 + c] = a.ba[c];
    s.st[13 + c] = a.bg[c];
    s.st[16 + c] = a.g[c];
  } else if (tid < m + 7) {
    s.st[6 + tid - m - 3] = a.q[tid - m - 3];
  } else if (tid < m + 19) {
    s.q_diag[tid - m - 7] = a.q_diag[tid - m - 7];
  }
  if (tid >= 512 && tid < 512 + kMat) s.P[tid - 512] = a.P[tid - 512];
  if (tid == 1023) s.n_base = 0;
  __syncthreads();

  // ---- samples: masks, quat_exp, the noise diagonal ----------------------
  if (tid < m) {
    const float dt = in_dt;
    const bool ok = in_valid && dt >= 0.0f;
    const bool bm = ok && in_base;
    s.ok[tid] = ok;
    s.bm[tid] = bm;
    // the base state: after the last base sample (0: before the first)
    if (bm) atomicMax(&s.n_base, tid + 1);
    const float dt_ok = ok ? dt : 0.0f;
    const float dt_b = bm ? dt : 0.0f;
    s.dt_ok[tid] = dt_ok;
    s.dt_b[tid] = dt_b;
    float r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.a[tid][c] = ok ? in_acc[c] - s.st[10 + c] : 0.0f;
      const float w = ok ? in_gyr[c] - s.st[13 + c] : 0.0f;
      r[c] = w * dt_ok;
    }
    // lie.quat_exp: half = 0.5 |r|, [cos half, 0.5 sinc(half) r]
    const float half = 0.5f * sqrtf((r[0] * r[0] + r[2] * r[2]) + r[1] * r[1]);
    const bool small = fabsf(half) < 1e-6f;
    const float t = small ? 1.0f : half;
    const float sinc = small ? 1.0f - div_by_number(half * half, 6.0f) : sinf(t) / t;
    const float sh = 0.5f * sinc;
    const float dq[4] = {cosf(half), sh * r[0], sh * r[1], sh * r[2]};
#pragma unroll
    for (int c = 0; c < 4; ++c) s.dq[tid][c] = s.qs[0][tid][c] = dq[c];
    // D: 0, q_diag[0:6] dt^2, q_diag[6:12] dt, 0
    const float dt2 = dt_b * dt_b;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      s.D[tid][j] = (j < 3 || j >= 15) ? 0.0f : s.q_diag[j - 3] * (j < 9 ? dt2 : dt_b);
    }
  }
  __syncthreads();

  // ---- attitude: the log-step quaternion scan ----------------------------
  int cur = 0;
  for (int k = 1; k < m; k *= 2) {
    if (tid < m) {
      float o[4];
      if (tid >= k) {
        quat_mul(s.qs[cur][tid - k], s.qs[cur][tid], o);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = s.qs[cur][tid][c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) s.qs[cur ^ 1][tid][c] = o[c];
    }
    cur ^= 1;
    __syncthreads();
  }
  if (tid < m) {
    float qq[4];
    quat_mul(&s.st[6], s.qs[cur][tid], qq);
    const float n = sqrtf((qq[0] * qq[0] + qq[2] * qq[2]) + (qq[1] * qq[1] + qq[3] * qq[3]));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = qq[c] / n;
      s.q_hist[tid + 1][c] = x;
      a.hist_q[4 * (tid + 1) + c] = x;
    }
  } else if (tid == m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.q_hist[0][c] = s.st[6 + c];
      a.hist_q[c] = s.st[6 + c];
    }
  }
  __syncthreads();

  // ---- motion: R_{j-1}, R a + g, F's blocks --------------------------------
  if (tid < m) {
    float R[9];
    quat_to_mat(s.q_hist[tid][0], s.q_hist[tid][1], s.q_hist[tid][2], s.q_hist[tid][3], R);
    const float* av = s.a[tid];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.u[tid][i] = gemvx3(R[3 * i], R[3 * i + 1], R[3 * i + 2], av[0], av[1], av[2]) + s.st[16 + i];
    }
    // _transition: -(R @ skew(a)) dt, (-R) dt, quat_to_mat(conj dq) (or I)
    const float dt_b = s.dt_b[tid];
    const float sk[9] = {0.0f, -av[2], av[1], av[2], 0.0f, -av[0], -av[1], av[0], 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float x = fmaf(R[3 * i + 2], sk[6 + j],
                             fmaf(R[3 * i + 1], sk[3 + j], fmaf(R[3 * i], sk[j], 0.0f)));
        s.blk[tid][3 * i + j] = -x * dt_b;
        s.blk[tid][9 + 3 * i + j] = -R[3 * i + j] * dt_b;
      }
    }
    float Rq[9];
    quat_to_mat(s.dq[tid][0], -s.dq[tid][1], -s.dq[tid][2], -s.dq[tid][3], Rq);
#pragma unroll
    for (int e = 0; e < 9; ++e) s.blk[tid][18 + e] = s.bm[tid] ? Rq[e] : (e % 4 == 0 ? 1.0f : 0.0f);
  }
  __syncthreads();

  if (tid < 32) {
    // velocity and position cumsums (three lanes)
    if (tid < 3) {
      const int c = tid;
      const float v0 = s.st[3 + c], p0 = s.st[c];
      s.v_hist[0][c] = v0;
      s.p_hist[0][c] = p0;
      float cv = 0.0f, cp = 0.0f, v_prev = v0;
      // the next sample's inputs loaded a step ahead of the stores
      float dt_next = s.dt_ok[0], u_next = s.u[0][c];
      for (int j = 0; j < m; ++j) {
        const float dt = dt_next, u = u_next;
        if (j + 1 < m) {
          dt_next = s.dt_ok[j + 1];
          u_next = s.u[j + 1][c];
        }
        cv = cv + u * dt;
        const float v_all = v0 + cv;
        cp = cp + (v_prev * dt + (0.5f * u) * (dt * dt));
        const float p_all = p0 + cp;
        s.v_hist[j + 1][c] = v_all;
        s.p_hist[j + 1][c] = p_all;
        a.hist_p[3 * (j + 1) + c] = p_all;
        v_prev = v_all;
      }
      a.hist_p[c] = p0;
    }
  } else {
    // the dense blocks of F_j at tile m - 1 - j (the flipped chain): a block
    // of one F a thread
    for (int idx = tid - 32; idx < m * 11; idx += kThreads - 32) {
      const int b = idx / m, f = idx - b * m, j = m - 1 - f;
      int rb, cb;
      dense_block(b, rb, cb);
      const float dt_b = s.dt_b[j];
      float* F = buf0 + f * kStride + (3 * rb) * kN + 3 * cb;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float eye = r == c ? 1.0f : 0.0f;
          float x = 0.0f;  // F's zeros: (0, 2..5), (1, 4)
          if (b == 0 || b == 8) x = eye * dt_b;               // (0, 1), (1, 5): I dt
          else if (b == 5) x = s.blk[j][3 * r + c];            // (1, 2): -(R [a]x) dt
          else if (b == 6) x = s.blk[j][9 + 3 * r + c];        // (1, 3): -R dt
          else if (b == 9) x = s.blk[j][18 + 3 * r + c];       // (2, 2): the attitude block
          else if (b == 10) x = (r == c ? -1.0f : -0.0f) * dt_b;  // (2, 4): -I dt
          F[r * kN + c] = x;
        }
      }
    }
  }
  __syncthreads();

  // ---- covariance: the reversed log-step scan of 18x18 products -----------
  float* src = buf0;
  float* dst = buf1;
  for (int k = 1; k < m; k *= 2) {
    const int np = m - k;
    // tiles below k are final: their dense entries carried over
    for (int idx = tid; idx < k * kDense; idx += kThreads) {
      const int i = idx / kDense, e = dense_entry(idx - i * kDense);
      dst[i * kStride + e] = src[i * kStride + e];
    }
    // a dense block of one product a thread; lanes on consecutive products
    for (int item = tid; item < 11 * np; item += kThreads) {
      const int b = item / np, i = k + item - b * np;
      product_block(b, src + (i - k) * kStride, src + i * kStride, dst + i * kStride);
    }
    float* t = src;
    src = dst;
    dst = t;
    __syncthreads();
  }

  // ---- covariance: the noise and S P S^T ---------------------------------
  // src: prefix [m]; S_j = prefix[m - 2 - j] (j < m - 1), S_{m-1} = I;
  // S_full = prefix[m - 1].  dst is free: (S_j D_j) S_j^T goes there (its
  // first 15 rows and columns, 225 entries).
  const float* S_full = src + (m - 1) * kStride;
  // S_full's entry (i, k): outside the dense blocks that of the identity
  auto s_full = [&](int i, int k) {
    return in_dense_block(i, k) ? S_full[i * kN + k] : (i == k ? 1.0f : 0.0f);
  };
  const int noise_items = 25 * m;
  for (int item = tid; item < noise_items + kMat; item += kThreads) {
    if (item >= noise_items) {
      const int e = item - noise_items, i = e / kN, c = e - i * kN;
      s.SP[e] = split_k<8>([&](int k) { return s_full(i, k); },
                           [&](int k) { return s.P[k * kN + c]; });
    } else {
      // a block of one product a thread; lanes on consecutive products
      const int b = item / m, j = item - b * m;
      noise_block(b, src + (j < m - 1 ? m - 2 - j : 0) * kStride, s.D[j], dst + j * kStride,
                  j == m - 1);
    }
  }
  __syncthreads();

  // the noise sum over j in torch's order, and S P S^T
  for (int item = tid; item < kNoise + kMat; item += kThreads) {
    if (item < kNoise) {
      s.Tsum[(item / 15) * kN + item % 15] = sum_rows(dst, m, item);
    } else {
      const int e = item - kNoise, i = e / kN, l = e - i * kN;
      s.SPS[e] = split_k<4>([&](int k) { return s.SP[i * kN + k]; },
                            [&](int k) { return s_full(l, k); });
    }
  }
  __syncthreads();
  if (tid < kMat) {
    // the entries of (S D) S^T outside its first 15 rows and columns are +0
    // for every j, and so is their sum
    const int i = tid / kN, l = tid - i * kN;
    s.Pb[tid] = s.SPS[tid] + (i < 15 && l < 15 ? s.Tsum[tid] : 0.0f);
  }
  __syncthreads();

  // ---- outputs --------------------------------------------------------------
  if (tid < kMat) {
    const int i = tid / kN, j = tid - i * kN;
    a.base_P[tid] = 0.5f * (s.Pb[tid] + s.Pb[j * kN + i]);
  } else if (tid < kMat + m + 1) {
    const int j = tid - kMat;
    a.hist_t[j] = j == 0 ? -INFINITY : a.t_rel[j - 1];
    a.hist_valid[j] = j == 0 ? 1 : s.ok[j - 1];
  } else if (tid >= 512 && tid < 522) {
    const int c = tid - 512, n = s.n_base;
    if (c < 3) a.base_p[c] = s.p_hist[n][c];
    else if (c < 6) a.base_v[c - 3] = s.v_hist[n][c - 3];
    else a.base_q[c - 6] = s.q_hist[n][c - 6];
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

size_t dynamic_bytes(int m) { return static_cast<size_t>(2) * m * kStride * sizeof(float); }

}  // namespace

extern "C" {

// Lets the kernel use the shared memory of a chunk of kMaxM samples; call
// once, outside any graph capture, before the first launch.
int imu_prefix_prepare() {
  cudaFuncSetAttribute(imu_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dynamic_bytes(kMaxM)));
  return status();
}

// The state (p, v, q, ba, bg, g, P), the chunk (dt, t_rel, gyro, accel,
// valid as bytes), base_mask (bytes) or null, q_diag [12], m samples
// (1..64), all float32 device memory but the masks.  Writes the history
// (t_rel, p, q, valid: m + 1 rows each) and the base state (p, v, q, P).
int imu_prefix_launch(const float* p, const float* v, const float* q, const float* ba,
                      const float* bg, const float* g, const float* P, const float* dt,
                      const float* t_rel, const float* gyro, const float* accel,
                      const uint8_t* valid, const uint8_t* base_mask, const float* q_diag, int m,
                      float* hist_t, float* hist_p, float* hist_q, uint8_t* hist_valid,
                      float* base_p, float* base_v, float* base_q, float* base_P, void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p, v, q, ba, bg, g, P, dt, t_rel, gyro, accel, valid, base_mask, q_diag, m,
               hist_t, hist_p, hist_q, hist_valid, base_p, base_v, base_q, base_P};
  imu_prefix_kernel<<<1, kThreads, dynamic_bytes(m), static_cast<cudaStream_t>(stream)>>>(a);
  return status();
}

const char* imu_prefix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
