// Segmented head-row sums over key-sorted rows, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of eskf_lio_tpu/ops/segscan.py
// (reached through `segsum_sorted` from the downsampler's per-voxel moment
// sums, ops/preprocess.py:251, once per scan and once in the init step).
//
// Contract (the same as `segsum_sorted`): given skey [N] sorted ascending
// and vals [N, W] row-major, every segment's HEAD row (its first row) of
// out [N, W] holds the segment total.  This kernel writes, in every row,
// the sum from that row to the end of its segment (an inclusive segmented
// suffix sum), so heads hold totals; callers read head rows only.
//
// Bound on the H100 (SXM, 3.35 TB/s): one read of 4 + 4W bytes and one
// write of 4W bytes a row; at the main path's N = 131,072, W = 10 that is
// ~11 MB, ~3.3 us.  The arithmetic (W adds per row per doubling pass) is far
// below the f32 peak, so the kernel is bound by bytes.
//
// Design: the TPU kernel walks its grid in order and carries the running
// segment sum from one block to the next in scratch (segscan.py:65-76).
// Hopper's blocks run in no order, so this is a simple deterministic
// three-phase scan over tiles of 256 rows:
//   1. seg_tile_lead: each tile sums its LEADING run (rows equal to the
//      tile's first key) with a fixed-order block reduction.
//   2. seg_tile_carry: one block turns the tile lead sums into S(u), the
//      sum of the lead runs of tiles u, u+1, ... that share tile u's first
//      key (a segmented suffix scan over the tiles, keyed by each tile's
//      first key), walking chunks of 256 tiles from the end.
//   3. seg_tile_apply: each tile runs its in-tile segmented suffix scan in
//      shared memory (log2(256) = 8 doubling passes, val[i] += val[i+k]
//      iff key[i+k] == key[i], exact because equal keys are contiguous) and
//      adds S(t+1) to the rows of its trailing run when tile t+1 starts
//      with the same key.
// Reads of vals: phase 1 and phase 3, 2 x 44 B a row; one write of 40 B.
// No atomics: the sums are the same bits from run to run.  Any N >= 1 and
// any W <= kMaxW; the ragged last tile is masked.  A single-pass
// decoupled look-back scan would read the rows once; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // rows per tile = threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxW = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// In-block inclusive segmented SUFFIX scan of buf0 [len, W] keyed by keys
// [len] (sorted).  Returns the buffer (buf0 or buf1) holding the result.
__device__ float* tile_suffix_scan(const int* keys, float* buf0, float* buf1,
                                   int len, int W) {
  const int i = threadIdx.x;
  float* cur = buf0;
  float* nxt = buf1;
  for (int k = 1; k < kTile; k <<= 1) {
    const bool add = (i + k < len) && keys[i + k] == keys[i];
    if (i < len) {
      for (int w = 0; w < W; ++w) {
        float v = cur[i * W + w];
        if (add) v += cur[(i + k) * W + w];
        nxt[i * W + w] = v;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

__global__ void __launch_bounds__(kTile)
seg_tile_lead(const int* __restrict__ skey, const float* __restrict__ vals,
              int n, int W, float* __restrict__ lead) {
  __shared__ float red[kWarps][kMaxW];
  const long base = static_cast<long>(blockIdx.x) * kTile;
  const int len = min(kTile, static_cast<int>(n - base));
  const int i = threadIdx.x;
  const int k0 = skey[base];
  const bool in_lead = i < len && skey[base + i] == k0;
  const int lane = i & 31, warp = i >> 5;
  for (int w = 0; w < W; ++w) {
    const float v = warp_sum(in_lead ? vals[(base + i) * W + w] : 0.f);
    if (lane == 0) red[warp][w] = v;
  }
  __syncthreads();
  if (i < W) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k][i];
    lead[blockIdx.x * W + i] = s;
  }
}

// One block.  In place: lead [T, W] becomes S [T, W].
__global__ void __launch_bounds__(kTile)
seg_tile_carry(const int* __restrict__ skey, int n, int W,
               float* __restrict__ lead) {
  extern __shared__ float smem[];
  int* keys = reinterpret_cast<int*>(smem);
  float* buf0 = smem + kTile;
  float* buf1 = buf0 + kTile * W;
  __shared__ float s_end[kMaxW];
  __shared__ int key_end;
  __shared__ int has_end;

  const int T = (n + kTile - 1) / kTile;
  const int i = threadIdx.x;
  if (i == 0) has_end = 0;
  for (int c = (T + kTile - 1) / kTile - 1; c >= 0; --c) {
    const int base = c * kTile;
    const int len = min(kTile, T - base);
    __syncthreads();  // the previous chunk is done with shared memory
    keys[i] = i < len ? skey[static_cast<long>(base + i) * kTile] : 0;
    for (int j = i; j < len * W; j += kTile) buf0[j] = lead[base * W + j];
    __syncthreads();
    const float* res = tile_suffix_scan(keys, buf0, buf1, len, W);
    const bool chain = has_end != 0;
    const int kend = key_end;
    for (int j = i; j < len * W; j += kTile) {
      const int r = j / W, w = j - r * W;
      float v = res[j];
      if (chain && keys[r] == kend) v += s_end[w];
      lead[base * W + j] = v;
    }
    float next_s = 0.f;
    if (i < W) next_s = res[i] + ((chain && keys[0] == kend) ? s_end[i] : 0.f);
    const int next_key = keys[0];
    __syncthreads();
    if (i < W) s_end[i] = next_s;
    if (i == 0) {
      key_end = next_key;
      has_end = 1;
    }
  }
}

__global__ void __launch_bounds__(kTile)
seg_tile_apply(const int* __restrict__ skey, const float* __restrict__ vals,
               int n, int W, const float* __restrict__ S,
               float* __restrict__ out) {
  extern __shared__ float smem[];
  int* keys = reinterpret_cast<int*>(smem);
  float* buf0 = smem + kTile;
  float* buf1 = buf0 + kTile * W;

  const int t = blockIdx.x;
  const long base = static_cast<long>(t) * kTile;
  const int len = min(kTile, static_cast<int>(n - base));
  const int i = threadIdx.x;
  keys[i] = i < len ? skey[base + i] : 0;
  for (int j = i; j < len * W; j += kTile) buf0[j] = vals[base * W + j];
  __syncthreads();
  const float* res = tile_suffix_scan(keys, buf0, buf1, len, W);

  const int last = keys[len - 1];
  // the trailing run continues into the next tile iff it starts with `last`
  const bool carry = base + kTile < n && skey[base + kTile] == last;
  for (int j = i; j < len * W; j += kTile) {
    const int r = j / W, w = j - r * W;
    float v = res[j];
    if (carry && keys[r] == last) v += S[(t + 1) * W + w];
    out[base * W + j] = v;
  }
}

}  // namespace

extern "C" {

int segscan_tile_rows() { return kTile; }

int segscan_max_width() { return kMaxW; }

// skey [n] int32 sorted ascending; vals, out [n, w] f32 row-major;
// scratch [ceil(n / tile_rows), w] f32.  n >= 1, 1 <= w <= max_width.
int segscan_launch(const int* skey, const float* vals, int n, int w,
                   float* scratch, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || w < 1 || w > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = kTile * sizeof(int) + 2 * kTile * w * sizeof(float);
  seg_tile_lead<<<tiles, kTile, 0, s>>>(skey, vals, n, w, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_tile_carry<<<1, kTile, smem, s>>>(skey, n, w, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_tile_apply<<<tiles, kTile, smem, s>>>(skey, vals, n, w, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

const char* segscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
