// VGICP Gauss-Newton normal equations, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gn_kernel` of
// eskf_lio_tpu/ops/gn_pallas.py (reached through
// `normal_equations_pallas_rotated`, once per GN iteration of `align`).
//
// What it computes, per correspondence i (mask[i] != 0):
//   Sigma_w = R Sigma_src R^T   (body-frame packed source covariance)
//   A = Sigma_w + Sigma_map,  W = adj(A) / det(A),  r = p - mu
//   J = [I | -[p]x]
// and over all i the 21 upper-triangle sums of J^T W J, the 6 sums of
// J^T W r and the correspondence count: 28 sums.  The block structure of
// gn_pallas.py:20-24 is used instead of forming J:
//   J^T W J = [[W, -W S], [S W, -S W S]],  J^T W r = [W r; S W r],  S = [p]x.
//
// Bound on the H100 (SXM, 3.35 TB/s): the inputs are 19 floats a point plus
// a 1-byte mask, 77 B/pt or 1.26 MB at N = 16,384 (the align budget):
// ~0.4 us of memory time, and ~211 flop per live point is ~2.4 Mflop, far
// below the f32 peak.  The bytes bound stays the stated bound, but at this N
// no launch reaches it: an empty <<<1,32>>> kernel alone takes longer (the
// source keeps one, `gn_normal_eq_empty_launch`, so a run can print it).
// The kernel is latency from end to end, so the design pays each latency
// once.
//
// Design:
// * ONE launch.  Every block writes its 28 partial sums; one of its threads
//   fences and takes an integer ticket (atomicAdd on an unsigned: no float
//   atomics).  The block that draws the last ticket sums the partials of all
//   blocks in block order with a fixed tree, writes JTJ [6,6] (both
//   triangles), JTr [6] and the count, and resets the ticket for the next
//   call.  The grouping of the adds does not depend on which block is last,
//   so the result is the same bits from run to run.  The partials lie
//   [28, blocks], so that the last block reads 128-byte lines: read as
//   [blocks, 28] its 3,584 scattered 4-byte loads took longer than all the
//   rest of the kernel.
// * Fill the card: 128 threads a block and one block per 128 rows, at most
//   two blocks an SM (128 blocks at N = 16,384 on 132 SMs); beyond that a
//   grid-stride loop over 128-row chunks, so any N works.
// * Layout: the kernel reads the [N,3]/[N,6] row-major arrays that the align
//   loop already holds, instead of the TPU's packed [19, N] operand (a
//   struct-of-arrays made for 128-lane vectors).  A chunk's rows are one
//   contiguous 16-byte-aligned span of each array (1,536 B of points,
//   3,072 B of covariances, ...): the block stages them through shared
//   memory with 16-byte loads, all in flight before any is stored, and each
//   thread then reads its own point without bank conflicts (rows of 3 words;
//   rows of 6 words as three 8-byte reads).  R is read through its strides,
//   so a transposed view costs no copy.
// * One point per thread computes its 28 products in registers (the same
//   closed form as gn_pallas.py:72-159); masked rows and the ragged tail
//   skip the arithmetic and add exactly 0, whatever they hold.
// * Block reduction through shared memory instead of 28 x 5 shuffles a
//   warp: the block writes its [28, 128] terms (padded, conflict-free), and
//   four threads a sum add 32 terms each in order, then combine by two
//   shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows per chunk = threads per block
constexpr int kSums = 28;  // 7 a warp in the last block's pass
constexpr int kOut = 43;  // JTJ[36] + JTr[6] + count
constexpr int kMaxBlocks = 1024;
constexpr int kRedStride = kThreads + kThreads / 32;  // one pad word per warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSums % (kThreads / 32) == 0, "the last pass takes kSums / warps sums a warp");

// Index of (a, b), a <= b, in the row-major upper triangle of a 6x6.
__device__ __forceinline__ int tri_index(int a, int b) {
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

// Copy a chunk's rows of one array (`words` floats, contiguous) into shared
// memory with 4-byte loads: the ragged last chunk and unaligned arrays.
__device__ __forceinline__ void stage_scalar(float4* dst4, const float* src,
                                             int words) {
  float* dst = reinterpret_cast<float*>(dst4);
  for (int j = threadIdx.x; j < words; j += kThreads) dst[j] = src[j];
}

__global__ void __launch_bounds__(kThreads)
gn_normal_eq_kernel(const float* __restrict__ pts, const float* __restrict__ covs,
                    const float* __restrict__ R, int r_stride0, int r_stride1,
                    const float* __restrict__ mu, const float* __restrict__ covm,
                    const uint8_t* __restrict__ mask, int n, int aligned,
                    float* partials, unsigned* ticket, float* __restrict__ out) {
  __shared__ float4 s_pts[kThreads * 3 / 4];
  __shared__ float4 s_covs[kThreads * 6 / 4];
  __shared__ float4 s_mu[kThreads * 3 / 4];
  __shared__ float4 s_covm[kThreads * 6 / 4];
  __shared__ float red[kSums][kRedStride];
  __shared__ float tot[kSums];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const float r0 = R[0], r1 = R[r_stride1], r2 = R[2 * r_stride1];
  const float r3 = R[r_stride0], r4 = R[r_stride0 + r_stride1];
  const float r5 = R[r_stride0 + 2 * r_stride1];
  const float r6 = R[2 * r_stride0], r7 = R[2 * r_stride0 + r_stride1];
  const float r8 = R[2 * r_stride0 + 2 * r_stride1];

  float c[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) c[k] = 0.f;

  const int chunks = (n + kThreads - 1) / kThreads;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int row0 = ch * kThreads;
    const int len = min(kThreads, n - row0);
    const bool vec = aligned && len == kThreads;
    if (ch != static_cast<int>(blockIdx.x)) __syncthreads();  // last chunk read
    const bool live = tid < len && mask[row0 + tid] != 0;
    if (vec) {
      // a full chunk is 96 + 192 + 96 + 192 16-byte words; every load is
      // started before the first store, so the chunk costs one round trip
      const float4* g_pts = reinterpret_cast<const float4*>(pts + 3L * row0);
      const float4* g_covs = reinterpret_cast<const float4*>(covs + 6L * row0);
      const float4* g_mu = reinterpret_cast<const float4*>(mu + 3L * row0);
      const float4* g_covm = reinterpret_cast<const float4*>(covm + 6L * row0);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const bool lo = tid < kThreads * 3 / 4, hi = tid < kThreads / 2;
      const float4 a = lo ? g_pts[tid] : zero;
      const float4 b0 = g_covs[tid];
      const float4 b1 = hi ? g_covs[tid + kThreads] : zero;
      const float4 c0 = lo ? g_mu[tid] : zero;
      const float4 d0 = g_covm[tid];
      const float4 d1 = hi ? g_covm[tid + kThreads] : zero;
      if (lo) s_pts[tid] = a;
      s_covs[tid] = b0;
      if (hi) s_covs[tid + kThreads] = b1;
      if (lo) s_mu[tid] = c0;
      s_covm[tid] = d0;
      if (hi) s_covm[tid + kThreads] = d1;
    } else {
      stage_scalar(s_pts, pts + 3L * row0, 3 * len);
      stage_scalar(s_covs, covs + 6L * row0, 6 * len);
      stage_scalar(s_mu, mu + 3L * row0, 3 * len);
      stage_scalar(s_covm, covm + 6L * row0, 6 * len);
    }
    __syncthreads();
    if (!live) continue;

    const float* p3 = reinterpret_cast<const float*>(s_pts) + 3 * tid;
    const float* m3 = reinterpret_cast<const float*>(s_mu) + 3 * tid;
    const float2* s6 = reinterpret_cast<const float2*>(s_covs) + 3 * tid;
    const float2* q6 = reinterpret_cast<const float2*>(s_covm) + 3 * tid;
    const float px = p3[0], py = p3[1], pz = p3[2];
    const float mx = m3[0], my = m3[1], mz = m3[2];
    const float2 sa = s6[0], sb = s6[1], sc = s6[2];
    const float2 qa = q6[0], qb = q6[1], qc = q6[2];
    const float s00 = sa.x, s01 = sa.y, s02 = sb.x;
    const float s11 = sb.y, s12 = sc.x, s22 = sc.y;
    const float q00 = qa.x, q01 = qa.y, q02 = qb.x;
    const float q11 = qb.y, q12 = qc.x, q22 = qc.y;

    // Sigma_w = R Sigma_src R^T
    const float m00 = r0 * s00 + r1 * s01 + r2 * s02;
    const float m01 = r0 * s01 + r1 * s11 + r2 * s12;
    const float m02 = r0 * s02 + r1 * s12 + r2 * s22;
    const float m10 = r3 * s00 + r4 * s01 + r5 * s02;
    const float m11 = r3 * s01 + r4 * s11 + r5 * s12;
    const float m12 = r3 * s02 + r4 * s12 + r5 * s22;
    const float m20 = r6 * s00 + r7 * s01 + r8 * s02;
    const float m21 = r6 * s01 + r7 * s11 + r8 * s12;
    const float m22 = r6 * s02 + r7 * s12 + r8 * s22;
    const float t00 = m00 * r0 + m01 * r1 + m02 * r2;
    const float t01 = m00 * r3 + m01 * r4 + m02 * r5;
    const float t02 = m00 * r6 + m01 * r7 + m02 * r8;
    const float t11 = m10 * r3 + m11 * r4 + m12 * r5;
    const float t12 = m10 * r6 + m11 * r7 + m12 * r8;
    const float t22 = m20 * r6 + m21 * r7 + m22 * r8;

    // A = Sigma_w + Sigma_map; W = adj(A) / det(A)
    const float a00 = t00 + q00, a01 = t01 + q01, a02 = t02 + q02;
    const float a11 = t11 + q11, a12 = t12 + q12, a22 = t22 + q22;
    const float co00 = a11 * a22 - a12 * a12;
    const float co01 = a02 * a12 - a01 * a22;
    const float co02 = a01 * a12 - a02 * a11;
    const float det = a00 * co00 + a01 * co01 + a02 * co02;
    const float idet = 1.f / det;
    const float w00 = co00 * idet, w01 = co01 * idet, w02 = co02 * idet;
    const float w11 = (a00 * a22 - a02 * a02) * idet;
    const float w12 = (a01 * a02 - a00 * a12) * idet;
    const float w22 = (a00 * a11 - a01 * a01) * idet;

    const float rx = px - mx, ry = py - my, rz = pz - mz;
    // v = W r
    const float vx = w00 * rx + w01 * ry + w02 * rz;
    const float vy = w01 * rx + w11 * ry + w12 * rz;
    const float vz = w02 * rx + w12 * ry + w22 * rz;
    // B = -W S
    const float b00 = -(w01 * pz - w02 * py);
    const float b10 = -(w11 * pz - w12 * py);
    const float b20 = -(w12 * pz - w22 * py);
    const float b01 = -(w02 * px - w00 * pz);
    const float b11 = -(w12 * px - w01 * pz);
    const float b21 = -(w22 * px - w02 * pz);
    const float b02 = -(w00 * py - w01 * px);
    const float b12 = -(w01 * py - w11 * px);
    const float b22 = -(w02 * py - w12 * px);
    // D = S^T W S = S B
    const float d00 = -pz * b10 + py * b20;
    const float d01 = -pz * b11 + py * b21;
    const float d02 = -pz * b12 + py * b22;
    const float d11 = pz * b01 - px * b21;
    const float d12 = pz * b02 - px * b22;
    const float d22 = -py * b02 + px * b12;
    // bottom of J^T W r = S W r
    const float g3 = py * vz - pz * vy;
    const float g4 = pz * vx - px * vz;
    const float g5 = px * vy - py * vx;

    c[0] += w00;  c[1] += w01;  c[2] += w02;  c[3] += b00;  c[4] += b01;
    c[5] += b02;  c[6] += w11;  c[7] += w12;  c[8] += b10;  c[9] += b11;
    c[10] += b12; c[11] += w22; c[12] += b20; c[13] += b21; c[14] += b22;
    c[15] += d00; c[16] += d01; c[17] += d02; c[18] += d11; c[19] += d12;
    c[20] += d22; c[21] += vx;  c[22] += vy;  c[23] += vz;  c[24] += g3;
    c[25] += g4;  c[26] += g5;  c[27] += 1.f;
  }

  // block reduction: [28, 128] terms through shared memory
  const int slot = tid + (tid >> 5);
#pragma unroll
  for (int k = 0; k < kSums; ++k) red[k][slot] = c[k];
  __syncthreads();
  // four threads a sum; threads 112..127 repeat the last sum and write nothing
  const int k = min(tid >> 2, kSums - 1), q = tid & 3;
  const bool writer = q == 0 && tid < 4 * kSums;
  {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += red[k][q * 33 + j];
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    if (writer) partials[k * kMaxBlocks + blockIdx.x] = s;
  }

  // the block that draws the last ticket finishes the sums.  One thread
  // fences for the block on both sides of the ticket: the barriers order
  // the block's stores before its fence and its loads after it.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned drawn = atomicAdd(ticket, 1u);
    __threadfence();
    s_last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // seven sums a warp, lane l over blocks l, l + 32, ...: the partials lie
  // [28, kMaxBlocks], so a warp's load is one 128-byte line (one SM cannot
  // pull thousands of scattered sectors through its memory pipe in time);
  // every load is in flight at once, then a fixed xor tree
  {
    const int lane = tid & 31, warp = tid >> 5;
    const int num_blocks = gridDim.x;
    float s[kSums / 4];
#pragma unroll
    for (int j = 0; j < kSums / 4; ++j) s[j] = 0.f;
    for (int b0 = lane; b0 < num_blocks; b0 += 128) {
      float x[4][kSums / 4];  // four blocks' partials loaded, then added
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + 32 * u;
#pragma unroll
        for (int j = 0; j < kSums / 4; ++j) {
          x[u][j] = b < num_blocks
                        ? __ldcg(&partials[(warp * (kSums / 4) + j) * kMaxBlocks + b])
                        : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < kSums / 4; ++j) s[j] += x[u][j];
      }
    }
    // the seven trees step together, so their shuffles overlap
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < kSums / 4; ++j) s[j] += __shfl_xor_sync(kFull, s[j], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kSums / 4; ++j) tot[warp * (kSums / 4) + j] = s[j];
    }
  }
  __syncthreads();
  if (tid < 36) {
    const int r = tid / 6, col = tid % 6;
    out[tid] = tot[r <= col ? tri_index(r, col) : tri_index(col, r)];
  } else if (tid < 42) {
    out[tid] = tot[21 + (tid - 36)];
  } else if (tid == 42) {
    out[tid] = tot[27];
  } else if (tid == 43) {
    *ticket = 0u;
  }
}

// Launches nothing but itself: its device duration is the least any launch
// takes on the card, the yardstick beside this latency-bound kernel's time.
__global__ void gn_empty_kernel() {}

}  // namespace

extern "C" {

// Bytes of the scratch buffer: [28, kMaxBlocks] partial sums and the ticket.
// Zeroed once by the caller, then left to the kernel.
int gn_normal_eq_scratch_bytes() {
  return static_cast<int>(sizeof(float)) * (kMaxBlocks * kSums + 1);
}

// pts, mu [n,3]; covs, covm [n,6] packed (xx,xy,xz,yy,yz,zz), row-major and
// contiguous; R [3,3] with its strides in elements; mask [n] bytes; scratch
// as above; out [43]: JTJ row-major [36], JTr [6], count.  All f32 device
// pointers except mask.  Calls that share a scratch buffer must be ordered
// (one stream).
int gn_normal_eq_launch(const float* pts, const float* covs, const float* R,
                        int r_stride0, int r_stride1, const float* mu,
                        const float* covm, const uint8_t* mask, int n,
                        float* scratch, float* out, void* stream) {
  static int num_sms = 0;
  if (num_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  int num_blocks = chunks < 2 * num_sms ? chunks : 2 * num_sms;
  if (num_blocks > kMaxBlocks) num_blocks = kMaxBlocks;
  const int aligned =
      (reinterpret_cast<uintptr_t>(pts) | reinterpret_cast<uintptr_t>(covs) |
       reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(covm)) % 16 == 0;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + kMaxBlocks * kSums);
  gn_normal_eq_kernel<<<num_blocks, kThreads, 0, s>>>(
      pts, covs, R, r_stride0, r_stride1, mu, covm, mask, n, aligned, scratch,
      ticket, out);
  return static_cast<int>(cudaGetLastError());
}

int gn_normal_eq_empty_launch(void* stream) {
  gn_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gn_normal_eq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
