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
// ~0.4 us of memory time, and ~300 flop/pt is ~5 Mflop, far below the f32
// peak.  At this N the kernel is bound by launch latency, not by bytes.
//
// Design:
// * Layout: the kernel reads the [N,3]/[N,6] row-major arrays that the align
//   loop already holds, instead of the TPU's packed [19, N] operand.  The
//   TPU packed a struct-of-arrays so its 128-lane vector unit had full
//   lanes; here one thread owns one point, and the rows of a warp are
//   contiguous, so the 3 or 6 loads of a row use every byte of the sectors
//   the warp fetches.  Skipping the pack saves a full write and read of
//   19 x 4 B/pt per GN iteration.
// * One point per thread computes its 28 products in registers (the same
//   closed form as gn_pallas.py:72-159); masked rows and the ragged tail
//   skip the arithmetic and add exactly 0.
// * Deterministic reduction, no float atomics: a fixed shuffle tree per
//   warp, a fixed-order sum of the warps into a [num_blocks, 28] partial
//   buffer, then a second launch that sums the partials in a fixed order
//   and writes JTJ [6,6] (both triangles), JTr [6] and the count.  The
//   result is the same bits from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;
constexpr int kOut = 43;  // JTJ[36] + JTr[6] + count

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gn_partials(const float* __restrict__ pts, const float* __restrict__ covs,
            const float* __restrict__ R, const float* __restrict__ mu,
            const float* __restrict__ covm, const uint8_t* __restrict__ mask,
            int n, float* __restrict__ partials) {
  __shared__ float red[kWarps][kSums];
  const int i = blockIdx.x * kThreads + threadIdx.x;

  float c[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) c[k] = 0.f;

  if (i < n && mask[i]) {
    const float px = pts[3 * i + 0], py = pts[3 * i + 1], pz = pts[3 * i + 2];
    const float s00 = covs[6 * i + 0], s01 = covs[6 * i + 1], s02 = covs[6 * i + 2];
    const float s11 = covs[6 * i + 3], s12 = covs[6 * i + 4], s22 = covs[6 * i + 5];
    const float mx = mu[3 * i + 0], my = mu[3 * i + 1], mz = mu[3 * i + 2];
    const float q00 = covm[6 * i + 0], q01 = covm[6 * i + 1], q02 = covm[6 * i + 2];
    const float q11 = covm[6 * i + 3], q12 = covm[6 * i + 4], q22 = covm[6 * i + 5];
    const float r0 = R[0], r1 = R[1], r2 = R[2];
    const float r3 = R[3], r4 = R[4], r5 = R[5];
    const float r6 = R[6], r7 = R[7], r8 = R[8];

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

    c[0] = w00;  c[1] = w01;  c[2] = w02;  c[3] = b00;  c[4] = b01;  c[5] = b02;
    c[6] = w11;  c[7] = w12;  c[8] = b10;  c[9] = b11;  c[10] = b12;
    c[11] = w22; c[12] = b20; c[13] = b21; c[14] = b22;
    c[15] = d00; c[16] = d01; c[17] = d02; c[18] = d11; c[19] = d12; c[20] = d22;
    c[21] = vx;  c[22] = vy;  c[23] = vz;  c[24] = g3;  c[25] = g4;  c[26] = g5;
    c[27] = 1.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const float s = warp_sum(c[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

// Index of (a, b), a <= b, in the row-major upper triangle of a 6x6.
__device__ __forceinline__ int tri_index(int a, int b) {
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

__global__ void __launch_bounds__(kThreads)
gn_finalize(const float* __restrict__ partials, int num_blocks,
            float* __restrict__ out) {
  __shared__ float tot[kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < kSums; k += kWarps) {
    float s = 0.f;
    for (int b = lane; b < num_blocks; b += 32) s += partials[b * kSums + k];
    s = warp_sum(s);
    if (lane == 0) tot[k] = s;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 36) {
    const int r = t / 6, col = t % 6;
    out[t] = tot[r <= col ? tri_index(r, col) : tri_index(col, r)];
  } else if (t < 42) {
    out[t] = tot[21 + (t - 36)];
  } else if (t == 42) {
    out[t] = tot[27];
  }
}

}  // namespace

extern "C" {

int gn_normal_eq_block_size() { return kThreads; }

int gn_normal_eq_num_sums() { return kSums; }

// pts, mu [n,3]; covs, covm [n,6] packed (xx,xy,xz,yy,yz,zz); R [3,3]
// row-major; mask [n] bytes; partials [num_blocks, 28] scratch with
// num_blocks = max(ceil(n / block_size), 1); out [43]: JTJ row-major [36],
// JTr [6], count.  All f32 device pointers except mask.
int gn_normal_eq_launch(const float* pts, const float* covs, const float* R,
                        const float* mu, const float* covm,
                        const uint8_t* mask, int n, float* partials,
                        float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  gn_partials<<<num_blocks, kThreads, 0, s>>>(pts, covs, R, mu, covm, mask,
                                               n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finalize<<<1, kThreads, 0, s>>>(partials, num_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

const char* gn_normal_eq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
