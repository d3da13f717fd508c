// Segmented head-row sums over key-sorted rows, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of eskf_lio_tpu/ops/segscan.py
// (reached through `segsum_sorted` from the downsampler's per-voxel moment
// sums, ops/preprocess.py, once per scan and once in the init step).
//
// Contract (the same as `segsum_sorted`): given skey [N] sorted ascending
// and vals [N, W] row-major, every segment's HEAD row (its first row) of
// out [N, W] holds the segment total.  This kernel writes, in every row,
// the sum from that row to the end of its segment (an inclusive segmented
// suffix sum), so heads hold totals; callers read head rows only.
//
// Bound on the H100 (SXM, 3.35 TB/s): one read of 4 + 4W bytes and one
// write of 4W bytes a row; at the main path's N = 131,072, W = 10 that is
// ~11 MB, ~3.3 us.  The arithmetic (a few adds per value) is far below the
// f32 peak, so the kernel is bound by bytes; what it loses above the bound
// is latency: every dependent trip to memory and every barrier.
//
// Design: ONE launch, one read of vals, one write of out.  The TPU kernel
// walks its grid in order and carries the running segment sum from one
// block to the next in scratch; Hopper's blocks run in no order, so the
// carry is split three ways by how far a run reaches:
// * Tiles of 1,024 rows (W = 10, the template instance of the main path;
//   512 rows for any other 1 <= W <= 16), one block each, about one block
//   an SM at N = 131,072.  Tiles are handed out from the END of the array
//   by an integer ticket (atomicAdd on an int), so a tile only ever waits
//   on tiles that have already started: no deadlock whatever order the
//   blocks are scheduled in.  Few, large tiles also keep the tickets, which
//   serialise on one address, short.
// * A tile's rows are one contiguous span.  It comes into shared memory
//   with 16-byte loads, all in flight before the first is stored, and goes out
//   the same way.  Each of 256 threads owns R = 4 (or 2) consecutive rows
//   with their W values in registers; its 160 bytes sit at a stride of 176
//   in shared memory, so the threads' 16-byte accesses do not collide.
// * In-tile scan in registers: a thread sums its own rows, then the warp
//   runs a 5-step shuffle scan over per-thread pairs (sum of the thread's
//   leading run, `open`: the thread is one run that goes on past it) with
//   the operator  (a, b) -> (a.open ? a.sum + b.sum : a.sum, a.open && b.open),
//   and one step through shared memory chains the 8 warps.  That is one
//   shuffle per value for R rows instead of one per row.
// * Across the tile's end, near: a ninth warp loads the 32 rows after the
//   tile (the halo) beside the tile itself.  Where the tile's last run ends
//   inside the halo (about 4 points a voxel on a real scan: nearly always),
//   the warp sums the run's rows there and the tile needs no other block.
// * Across the tile's end, far: every tile publishes the sum of its LEADING
//   run as W words of (float, tag), each one 8-byte store, so a reader sees
//   value and tag together and no fence is needed.  The tag carries the
//   call's epoch and a `closed` bit: the run does not go on past this tile.
//   A tile whose last run outruns the halo sums the published leads of the
//   tiles after it up to and including the first closed one, 32 tiles a
//   window.  These are the padding rows at the end of a real scan and a
//   caller's long segments.
// * Deterministic: whether a tile takes the halo or the published leads
//   depends on the keys alone; a tile adds lead sums only, never another
//   tile's inclusive value, always in the same order (a fixed xor-shuffle
//   tree within a window with the tiles past the first closed one as 0,
//   windows left to right).  So the grouping of the float adds is a
//   function of the keys, and the result is the same bits from run to run.
//   No float atomics.  (Waiting for the neighbour's inclusive value would
//   also be deterministic, but serialises the padding tiles of a real scan.)
// * Scratch: one buffer the wrapper allocates (zeroed once) and reuses:
//   words [kMaxW, cap] and three ints (ticket, finished tiles, epoch).  The
//   last tile to finish resets the ticket and advances the epoch, which
//   invalidates every published word for the next call; nothing is zeroed
//   between calls, and no state lives on the host.  Calls that share a
//   buffer must be ordered (one stream).  The epoch has 30 bits.
// Any N >= 1; the ragged last tile and buffers that are not 16-byte
// aligned take scalar loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;  // threads that own rows
constexpr int kWarps = kScanThreads / 32;
constexpr int kHalo = 32;                        // rows after the tile, one a lane
constexpr int kThreads = kScanThreads + kHalo;   // plus the halo warp
constexpr int kMaxW = 16;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// A published word is written and read whole, at device scope and past L1.
__device__ __forceinline__ void store_word(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// WT > 0: W == WT at compile time; WT == 0: any W <= kMaxW at run time.
// R: rows a thread; a tile has kScanThreads * R rows.
template <int WT, int R>
__global__ void __launch_bounds__(kThreads, 1)
seg_suffix_scan(const int* __restrict__ skey, const float* __restrict__ vals,
                int n, int w_rt, int aligned, u64* pub, int cap, int* counters,
                float* __restrict__ out) {
  constexpr int WMAX = WT ? WT : kMaxW;
  constexpr int TR = kScanThreads * R;
  constexpr int kTileLoads = (TR * WMAX / 4 + kScanThreads - 1) / kScanThreads;
  constexpr int kHaloLoads = (kHalo * WMAX / 4 + 31) / 32;
  constexpr bool kVecRows = WT > 0 && (R * WT) % 4 == 0;  // a thread's rows by 16 bytes
  // 16-byte words of a thread's rows, and their stride in shared memory: one
  // word of padding (11 words for 10) keeps eight threads' 16-byte accesses
  // on eight different bank groups
  constexpr int kGroup = R * WMAX / 4;
  constexpr int kStride = kVecRows ? kGroup + 1 : kGroup;
  const int W = WT ? WT : w_rt;

  __shared__ float4 tile4[kScanThreads * kStride];
  __shared__ float4 halo4[kHalo * WMAX / 4];
  __shared__ float warp_lead[kWarps][WMAX];
  __shared__ int warp_open[kWarps];
  __shared__ float ext[WMAX];
  __shared__ int s_halo_closed;
  __shared__ int s_tile;
  __shared__ int s_epoch;
  float* tile = reinterpret_cast<float*>(tile4);
  float* halo = reinterpret_cast<float*>(halo4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool scan_thread = tid < kScanThreads;
  const int T = (n + TR - 1) / TR;
  if (tid == 0) {
    s_tile = T - 1 - atomicAdd(&counters[0], 1);
    s_epoch = *reinterpret_cast<volatile int*>(&counters[2]);
  }
  __syncthreads();
  const int t = s_tile;
  const unsigned epoch_tag = static_cast<unsigned>(s_epoch) + 1u;  // never 0
  const long base = static_cast<long>(t) * TR;
  const int len = min(TR, static_cast<int>(n - base));
  const bool full = aligned && len == TR;
  const int halo_rows = max(0, min(kHalo, static_cast<int>(n - base - TR)));

  // the tile's last key, and whether its run goes on into the next tile
  const int k_last = skey[base + len - 1];
  const bool chain = base + TR < n && skey[base + TR] == k_last;
  const bool uniform = skey[base] == k_last;

  int k[R];          // scan threads: the keys of this thread's rows
  bool chain_i = false;  // the thread's last run goes on into the next thread
  int key_h = 0;     // halo warp: the key of this lane's halo row
  if (scan_thread) {
    // the tile's rows, one contiguous span of vals; rows past the end take
    // the last key and add exactly 0
    const long row0 = base + static_cast<long>(tid) * R;
#pragma unroll
    for (int r = 0; r < R; ++r) k[r] = skey[min(row0 + r, static_cast<long>(n) - 1)];
    chain_i = row0 + R < n && skey[row0 + R] == k[R - 1];
    const float* src = vals + base * W;
    if (full) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      const int total = TR * W / 4;
      float4 buf[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int j = tid + u * kScanThreads;
        if (j < total) buf[u] = src4[j];
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int j = tid + u * kScanThreads;
        if (j < total) tile4[kVecRows ? j / kGroup * kStride + j % kGroup : j] = buf[u];
      }
    } else {
      for (int j = tid; j < len * W; j += kScanThreads) tile[j] = src[j];
    }
  } else {
    // the halo: the kHalo rows after the tile
    const long g = base + TR + lane;
    if (lane < halo_rows) key_h = skey[g];
    const float* src = vals + (base + TR) * W;
    if (aligned && halo_rows == kHalo) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      const int total = kHalo * W / 4;
      float4 buf[kHaloLoads];
#pragma unroll
      for (int u = 0; u < kHaloLoads; ++u) {
        const int j = lane + u * 32;
        if (j < total) buf[u] = src4[j];
      }
#pragma unroll
      for (int u = 0; u < kHaloLoads; ++u) {
        const int j = lane + u * 32;
        if (j < total) halo4[j] = buf[u];
      }
    } else {
      for (int j = lane; j < halo_rows * W; j += 32) halo[j] = src[j];
    }
  }
  __syncthreads();

  float x[R][WMAX];  // scan threads: suffix sums of this thread's rows
  float S[WMAX];     // then: what the rows of the thread's last run add
  bool open = false;  // the thread (later: the rest of its warp) is one open run
  if (scan_thread) {
    const int row0 = tid * R;
    if (kVecRows && full) {
      const float4* rows4 = tile4 + tid * kStride;
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const float4 a = rows4[p];
        x[(4 * p) / WMAX][(4 * p) % WMAX] = a.x;
        x[(4 * p + 1) / WMAX][(4 * p + 1) % WMAX] = a.y;
        x[(4 * p + 2) / WMAX][(4 * p + 2) % WMAX] = a.z;
        x[(4 * p + 3) / WMAX][(4 * p + 3) % WMAX] = a.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = row0 + r < len;
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
          x[r][w] = (in && w < W) ? tile[(row0 + r) * W + w] : 0.f;
        }
      }
    }
    // the thread's own rows
#pragma unroll
    for (int r = R - 2; r >= 0; --r) {
      if (k[r] == k[r + 1]) {
#pragma unroll
        for (int w = 0; w < WMAX; ++w) x[r][w] += x[r + 1][w];
      }
    }
    // warp scan over (sum of the thread's leading run, open)
    open = k[0] == k[R - 1] && chain_i;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) S[w] = x[0][w];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool there = lane + d < 32;
      const bool open_d = __shfl_down_sync(kFull, open, d);
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          const float s_d = __shfl_down_sync(kFull, S[w], d);
          if (open && there) S[w] += s_d;
        }
      }
      if (there) open = open && open_d;
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) warp_lead[warp][w] = S[w];
      }
      warp_open[warp] = open;
    }
    // the pair of the threads after this one in the warp
    const bool open_next = __shfl_down_sync(kFull, open, 1);
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) S[w] = __shfl_down_sync(kFull, S[w], 1);
    }
    // lane 31 has no thread after it in the warp: the next warps' pair alone
    if (lane == 31) {
#pragma unroll
      for (int w = 0; w < WMAX; ++w) S[w] = 0.f;
    }
    // from here `open` says: the run reaches past the warp's last thread
    open = lane == 31 ? true : open_next;
  } else {
    // halo warp: the rows of the tile's last run inside the halo, summed by
    // a fixed xor tree; closed when the run ends inside the halo
    const bool match = chain && lane < halo_rows && key_h == k_last;
    const bool other = lane < halo_rows && key_h != k_last;
    const bool closed = __any_sync(kFull, other) || base + TR + kHalo >= n;
    float h[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w) h[w] = (match && w < W) ? halo[lane * W + w] : 0.f;
    // the columns' trees step together, so their shuffles overlap
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) h[w] += __shfl_xor_sync(kFull, h[w], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) ext[w] = h[w];
      }
      s_halo_closed = closed;
    }
  }
  __syncthreads();

  if (scan_thread) {
    // chain the warps, lane c for column c: Tn = the sum, inside this tile,
    // of the run that starts at the first row of the next warp
    // (every lane computes a column; lanes past W repeat the last one)
    const int col = min(lane, W - 1);
    float lead_y[kWarps];
    bool open_y[kWarps];
#pragma unroll
    for (int y = 0; y < kWarps; ++y) {
      lead_y[y] = warp_lead[y][col];
      open_y[y] = warp_open[y] != 0;
    }
    float Tn = 0.f;
#pragma unroll
    for (int y = kWarps - 1; y >= 1; --y) {
      if (y > warp) Tn = open_y[y] ? lead_y[y] + Tn : lead_y[y];
    }
    if (warp == 0 && lane < W) {
      // the tile's lead-run sum, published with the epoch and the closed bit
      const float lead_tile = open_y[0] ? lead_y[0] + Tn : lead_y[0];
      const unsigned tag = (epoch_tag << 1) | ((uniform && chain) ? 0u : 1u);
      const u64 word = (static_cast<u64>(tag) << 32) | __float_as_uint(lead_tile);
      store_word(&pub[static_cast<long>(lane) * cap + t], word);
    }
    // what the rows of this thread's last run add from the rest of the tile
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        const float tn_w = __shfl_sync(kFull, Tn, w);
        S[w] = chain_i ? (open ? S[w] + tn_w : S[w]) : 0.f;
      }
    }

    if (chain && !s_halo_closed) {
      // the run outruns the halo: sum the published leads of the tiles after
      // this one, column c by warp c % kWarps, lanes over 32 tiles a window
      for (int c = warp; c < W; c += kWarps) {
        const u64* col = pub + static_cast<long>(c) * cap;
        float E = 0.f;
        int first = t + 1;
        bool done = false;
        while (!done) {
          const int tt = first + lane;
          float val = 0.f;
          unsigned closed_mask;
          unsigned need;
          do {
            bool valid = true, closed = false;
            if (tt < T) {
              const u64 word = load_word(col + tt);
              const unsigned tag = static_cast<unsigned>(word >> 32);
              valid = (tag >> 1) == epoch_tag;
              closed = valid && (tag & 1u);
              val = __uint_as_float(static_cast<unsigned>(word));
            } else {
              closed = true;  // past the end (the last tile is closed itself)
            }
            const unsigned valid_mask = __ballot_sync(kFull, valid);
            closed_mask = __ballot_sync(kFull, closed);
            // the lanes up to and including the first closed tile must be in
            need = closed_mask ? (2u << (__ffs(closed_mask) - 1)) - 1u : kFull;
            if ((valid_mask & need) == need) break;
          } while (true);
          float e = ((need >> lane) & 1u) ? val : 0.f;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
          E += e;
          done = closed_mask != 0u;
          first += 32;
        }
        if (lane == 0) ext[c] = E;
      }
    }
  }
  __syncthreads();

  if (scan_thread) {
    // every row: the sum of its run inside the thread, plus the rest of the
    // run in this tile, plus the rest of the run after the tile
    const int row0 = tid * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in_thread_tail = k[r] == k[R - 1];
      const bool in_tile_tail = chain && k[r] == k_last;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          if (in_thread_tail) x[r][w] += S[w];
          if (in_tile_tail) x[r][w] += ext[w];
        }
      }
    }
    if (full) {
      // back through shared memory, so the stores are 16 bytes a thread
      if (kVecRows) {
        float4* rows4 = tile4 + tid * kStride;
#pragma unroll
        for (int p = 0; p < kGroup; ++p) {
          rows4[p] = make_float4(x[(4 * p) / WMAX][(4 * p) % WMAX],
                                 x[(4 * p + 1) / WMAX][(4 * p + 1) % WMAX],
                                 x[(4 * p + 2) / WMAX][(4 * p + 2) % WMAX],
                                 x[(4 * p + 3) / WMAX][(4 * p + 3) % WMAX]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int w = 0; w < WMAX; ++w) {
            if (w < W) tile[(row0 + r) * W + w] = x[r][w];
          }
        }
      }
    } else {
      float* dst = out + base * W;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r < len) {
#pragma unroll
          for (int w = 0; w < WMAX; ++w) {
            if (w < W) dst[(row0 + r) * W + w] = x[r][w];
          }
        }
      }
    }
  }
  if (full) {
    __syncthreads();
    if (scan_thread) {
      float4* dst4 = reinterpret_cast<float4*>(out + base * W);
      const int total = TR * W / 4;
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int j = tid + u * kScanThreads;
        if (j < total) dst4[j] = tile4[kVecRows ? j / kGroup * kStride + j % kGroup : j];
      }
    }
  }

  // the last tile to finish resets the ticket and advances the epoch
  if (tid == 0) {
    if (atomicAdd(&counters[1], 1) == T - 1) {
      counters[0] = 0;
      counters[1] = 0;
      counters[2] = static_cast<int>(epoch_tag & 0x3fffffffu);
    }
  }
}

constexpr int kRowsMain = 4;     // rows a thread at W = 10: tiles of 1,024 rows
constexpr int kRowsGeneric = 2;  // any other W: tiles of 512 rows

}  // namespace

extern "C" {

// The fewest rows a tile holds: ceil(n / this) tiles are enough scratch.
int segscan_tile_rows() { return kScanThreads * kRowsGeneric; }

int segscan_max_width() { return kMaxW; }

// Bytes of the scratch buffer for `tiles` tiles: the published words
// [max_width, tiles] and the three counters.  Zeroed once by the caller.
int segscan_scratch_bytes(int tiles) {
  return static_cast<int>(sizeof(u64)) * (kMaxW * tiles + 2);
}

// skey [n] int32 sorted ascending; vals, out [n, w] f32 row-major; scratch:
// segscan_scratch_bytes(cap) bytes, 8-byte aligned, cap >= ceil(n /
// tile_rows), zeroed before its first use and then left to the kernel.
// n >= 1, 1 <= w <= max_width.
int segscan_launch(const int* skey, const float* vals, int n, int w,
                   void* scratch, int cap, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = kScanThreads * (w == 10 ? kRowsMain : kRowsGeneric);
  const int tiles = (n + rows - 1) / rows;
  if (n < 1 || w < 1 || w > kMaxW || cap < tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  u64* pub = static_cast<u64*>(scratch);
  int* counters = reinterpret_cast<int*>(pub + static_cast<long>(kMaxW) * cap);
  const int aligned =
      (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (w == 10) {
    seg_suffix_scan<10, kRowsMain><<<tiles, kThreads, 0, s>>>(
        skey, vals, n, w, aligned, pub, cap, counters, out);
  } else {
    seg_suffix_scan<0, kRowsGeneric><<<tiles, kThreads, 0, s>>>(
        skey, vals, n, w, aligned, pub, cap, counters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* segscan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
