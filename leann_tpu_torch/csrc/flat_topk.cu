// Streaming top-c select for the flat engine's stage 1, for Hopper
// (sm_90a): flat_topk.
//
// Replaces no TPU kernel. The reference fuses `jax.lax.approx_max_k` into
// its stage-1 product (`leann_tpu/ops/distance.py:_two_stage_jit`); the
// port multiplies with cuBLAS into float32 dots
// (`ops/distance.py:stage1_dots`) and selects here. For dots [rows, N]
// float32, bias [N] float32 and a scale (2 for l2, 1 for ip) it writes
// out[rows, c] int64: the columns of each row's c largest scores
//
//   score[r, j] = fl(fl(scale * dots[r, j]) + bias[j])
//
// in descending order, equal scores to the lower column: the ids of
// `topk_stable(scale * dots + bias[None, :], c)`, the `jax.lax.top_k`
// order. The product and the sum are rounded one at a time
// (__fmul_rn, __fadd_rn: never contracted into an FMA), as PyTorch's two
// elementwise passes round them; -0.0 counts as +0.0 and NaN above +inf,
// as torch.sort orders them. The score matrix itself is never written.
//
// Bound. Bytes: the dots read once (rows * N * 4; 1.07 GB for 256 x
// 1,048,576, 0.32 ms at 3.35 TB/s); the bias, the per-slab keys and the
// ids are small beside them. Operations are a few per score.
//
// Design. Each score becomes a 64-bit key: the float's bits mapped to an
// order-preserving uint32 in the high half, the complemented column in
// the low half. Keys are distinct, so "the c largest keys" is exactly the
// stable top-c, and its order is the key order.
//
// `flat_topk_select_kernel`: a CTA of 256 threads takes one row over one
// slab of columns; the wrapper cuts rows into slabs so that the CTAs fill
// the card in nearly whole waves at any row count
// (`ops/flat_topk.py:launch_plan`). The CTA streams its slab in tiles of
// 4096 columns. The dots go through a ring of three tiles in shared memory
// by cp.async, so two tiles are in flight while one is filtered; the bias
// comes from L2 into registers a tile ahead. The row keeps a running
// threshold, the c-th largest key admitted so far, and a buffer of `cap`
// keys. The threshold starts at the c-th largest of the threads' largest
// keys in the first tile (where c <= 256), which halves the keys admitted.
// A score is first tested in floats against the threshold's score (three
// instructions); only the few that pass get their exact key. Together the
// two cut the select's time at the flat cell's chunk by 12% (0.634 against
// 0.721 ms on the H100, PERF.md). A key above the threshold is admitted by
// a warp ballot and one shared atomic per warp and value. The round of a
// tile ends at a barrier; when the buffer overflowed, the CTA selects its
// c largest (`select_top`: an MSB radix select on 8-bit digits, the
// histogram in shared memory, warp-aggregated by __match_any_sync), raises
// the threshold to the least of them and admits what the overflow left
// waiting. On rows in no particular order a few thousand of a slab's keys
// are ever admitted (`flat_topk.admitted`); a row sorted ascending admits
// most of them, slowly but correctly. At the slab's end the row's top c
// keys go to the per-slab scratch [rows, slabs * c] (or, with one slab,
// are sorted by a bitonic network and written as ids).
//
// `flat_topk_merge_kernel`: one CTA per row streams the row's slabs * c
// keys through the same admission and selection, sorts the final c and
// writes the ids.
//
// Buffers. Where the buffer of cap keys and the compaction's keep area
// of c keys fit in shared memory beside the ring (c up to 6,378 on the
// H100), they live there (`kResident`); above that each CTA gets a region
// of a global scratch instead, which L2 mostly holds. Both variants run
// the same code.
//
// Limits: c <= 2^29, N a multiple of 4 below 2^31 - 2 * 4096, dots and
// bias 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                 // 16-byte chunks a thread per tile
constexpr int kPer = 4 * kVec;          // scores a thread per tile
constexpr int kTile = kThreads * kPer;  // 4096 columns a tile
constexpr int kStages = 3;              // tiles of dots in the ring
constexpr int kStageBytes = kTile * 4;
constexpr int kBins = 256;              // == kThreads: one bin a thread
constexpr int kMaxC = 1 << 29;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBins == kThreads, "select_top clears one bin a thread");

struct Shared {
  int count;             // keys admitted into the buffer
  unsigned over[3];      // whether it overflowed, by round mod 3
  u64 prefix;            // select_top: digits fixed so far
  int need;              // select_top: keys still to take in that bin
  int done;
  int kept;
  u64 wmin[kWarps];
  u64 wsum[kWarps];
};

// The score's key: order-preserving bits of the float above the
// complemented column.
__device__ __forceinline__ u64 score_key(float d, float b, float scale,
                                         unsigned col) {
  const float s = __fadd_rn(__fmul_rn(scale, d), b);
  unsigned f = __float_as_uint(s);
  unsigned u;
  if (s != s) {
    u = 0xffffffffu;                    // NaN first, as torch.sort
  } else {
    if (f == 0x80000000u) f = 0u;       // -0.0 == +0.0
    u = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  }
  return (static_cast<u64>(u) << 32) | static_cast<u64>(~col);
}

// The least score a key above k can have, for a first test in floats:
// `!(score < key_floor(k))` holds for every score whose key exceeds k
// (NaN and either zero included); -inf below the first key.
__device__ __forceinline__ float key_floor(u64 k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  if (k == 0) return __uint_as_float(0xff800000u);  // -inf
  if (u == 0xffffffffu) return __uint_as_float(0x7fffffffu);  // NaN
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// Moves the c largest of buf[0, m) (distinct keys, m > c) to buf[0, c),
// in no order, and returns the least of them. Block-wide: every thread
// calls it; it begins and ends at a barrier.
__device__ u64 select_top(Shared& s, u64* buf, int m, int c, u64* keep,
                          int* hist) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s.prefix = 0;
    s.need = c;
    s.done = 0;
    s.kept = 0;
  }
  int shift = 56;
  for (;; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    const u64 prefix = s.prefix;
    const u64 hi = shift == 56 ? 0ull : (~0ull << (shift + 8));
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      int digit = kBins;                // no bin
      if (i < m) {
        const u64 k = buf[i];
        if ((k & hi) == (prefix & hi)) digit = (int)((k >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // the bin holding the need-th largest key: lane L sums bins
      // [8L, 8L + 8), a suffix scan over the lanes counts the keys above
      const int need = s.need;
      int own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) own += hist[lane * 8 + b];
      int incl = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(kFull, incl, off);
        if (lane + off < 32) incl += v;
      }
      int above = incl - own;
      if (above < need && need <= incl) {
        for (int b = lane * 8 + 7;; --b) {
          const int h = hist[b];
          if (above + h >= need) {
            s.prefix = prefix | (static_cast<u64>(b) << shift);
            s.need = need - above;
            s.done = (h == need - above) || shift == 0;
            break;
          }
          above += h;
        }
      }
    }
    __syncthreads();
    if (s.done) break;
  }
  // keep every key whose top (64 - shift) bits reach the prefix: those
  // above its bin and the whole bin, c keys in all
  const u64 mask = ~0ull << shift;
  const u64 pre = s.prefix;
  const unsigned lt = (1u << lane) - 1u;
  u64 least = ~0ull;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    u64 k = 0;
    bool take = false;
    if (i < m) {
      k = buf[i];
      take = (k & mask) >= pre;
    }
    const unsigned bal = __ballot_sync(kFull, take);
    if (bal) {
      const int lead = __ffs(bal) - 1;
      int pos = 0;
      if (lane == lead) pos = atomicAdd(&s.kept, __popc(bal));
      pos = __shfl_sync(kFull, pos, lead) + __popc(bal & lt);
      if (take) {
        if (pos < c) keep[pos] = k;
        least = umin64(least, k);
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    least = umin64(least, __shfl_xor_sync(kFull, least, off));
  if (lane == 0) s.wmin[warp] = least;
  __syncthreads();
  for (int i = tid; i < c; i += kThreads) buf[i] = keep[i];
  u64 t = s.wmin[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = umin64(t, s.wmin[w]);
  __syncthreads();
  return t;
}

// Admits each thread's pending values (bit j of pend: value j, key(j),
// lies above thr) into the buffer, one round at a time: a round that
// overflows it ends with select_top, a higher threshold and the waiting
// values filtered by it. Every thread calls it; it returns after a
// barrier.
template <int P, class Key>
__device__ __forceinline__ void offer(Shared& s, u64* buf, u64* keep,
                                      int* hist, int cap, int c,
                                      unsigned pend, u64& thr,
                                      unsigned& round, u64& admitted,
                                      const Key& key) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (;;) {
    if (__any_sync(kFull, pend)) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const bool want = (pend >> j) & 1u;
        const unsigned bal = __ballot_sync(kFull, want);
        if (bal) {
          const int lead = __ffs(bal) - 1;
          int pos = 0;
          if (lane == lead) pos = atomicAdd(&s.count, __popc(bal));
          pos = __shfl_sync(kFull, pos, lead) + __popc(bal & lt);
          if (want) {
            if (pos < cap) {
              buf[pos] = key(j);
              pend &= ~(1u << j);
              ++admitted;
            } else {
              s.over[round % 3] = 1;
            }
          }
        }
      }
    }
    __syncthreads();
    const unsigned over = s.over[round % 3];
    // the slot of round + 2 was last read before this barrier and is next
    // written after the following one
    if (threadIdx.x == 0) s.over[(round + 2) % 3] = 0;
    ++round;
    if (!over) return;
    thr = select_top(s, buf, cap, c, keep, hist);
    if (threadIdx.x == 0) s.count = c;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (((pend >> j) & 1u) && !(key(j) > thr)) pend &= ~(1u << j);
    __syncthreads();
  }
}

// Sorts buf[0, m) (m <= c) descending, zero keys padding it to a power of
// two, and writes the first c as ids (-1 for a padding key). Block-wide.
__device__ void write_ids(u64* buf, int m, int c, long long* out) {
  int p = 1;
  while (p < c) p <<= 1;
  for (int i = m + threadIdx.x; i < p; i += kThreads) buf[i] = 0;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += kThreads) {
        const int x = i ^ j;
        if (x > i) {
          const u64 a = buf[i], b = buf[x];
          if (((i & k) == 0) == (a < b)) {
            buf[i] = b;
            buf[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const u64 k = buf[i];
    out[i] = k ? static_cast<long long>(~static_cast<unsigned>(k)) : -1;
  }
  __syncthreads();
}

// The CTA's row total of `admitted` added to *total. Block-wide.
__device__ void add_admitted(Shared& s, u64 admitted, u64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    admitted += __shfl_xor_sync(kFull, admitted, off);
  if (lane == 0) s.wsum[warp] = admitted;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s.wsum[w];
    atomicAdd(total, sum);
  }
}

struct Args {
  const float* dots;    // [rows, n]
  const float* bias;    // [n]
  float scale;
  int rows, n, c, cap, slab_cols;
  long long* out;       // [rows, c] ids (one slab)
  u64* keys;            // [rows, ldk] per-slab keys (several slabs)
  int ldk;
  u64* scratch;         // nullptr (buffers in shared memory), or
                        // [rows * slabs, ld_scratch]: a CTA's buffer of
                        // cap keys and keep area
  long long ld_scratch;
  u64* admitted;        // nullptr, or the admitted keys' device total
};

// A CTA's buffer of cap keys and the compaction's keep area of c keys.
inline size_t buffer_bytes(int cap, int c) {
  return (size_t)cap * 8 + (size_t)((c + 1) & ~1) * 8;
}

// Dynamic shared memory of a merge CTA: the buffers where they are
// resident, then the histogram. A select CTA has the ring of kStages
// tiles of its row's dots before them. (Each kernel addresses them
// inline: a helper that took the arguments by reference gave the select
// kernel a 32-byte stack frame and cost it 4% on the H100.)
inline size_t merge_smem_bytes(bool resident, int cap, int c) {
  return kBins * 4 + (resident ? buffer_bytes(cap, c) : 0);
}

inline size_t select_smem_bytes(bool resident, int cap, int c) {
  return (size_t)kStages * kStageBytes + merge_smem_bytes(resident, cap, c);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// One CTA per (row, slab): the slab's c largest keys, as keys into the
// per-slab scratch or, with one slab, as the row's ids. The dots stream
// through a ring of kStages tiles in shared memory, kStages - 1 tiles
// ahead of the one being filtered; each thread copies its own 16-byte
// chunks (cp.async, past L1) and reads back only those, so the ring needs
// no barrier of its own. The bias, which every row reads, comes from L2
// into registers one tile ahead.
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
    flat_topk_select_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared s;
  float4* ring = reinterpret_cast<float4*>(smem_raw);
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  u64* buf = kResident
                 ? reinterpret_cast<u64*>(smem_raw + kStages * kStageBytes)
                 : a.scratch + ((size_t)row * gridDim.y + blockIdx.y) *
                                   (size_t)a.ld_scratch;
  u64* keep = buf + a.cap;
  int* hist = kResident
                  ? reinterpret_cast<int*>(keep + ((a.c + 1) & ~1))
                  : reinterpret_cast<int*>(smem_raw + kStages * kStageBytes);
  const int col0 = blockIdx.y * a.slab_cols;
  const int col1 = (int)min((long long)a.n, (long long)col0 + a.slab_cols);
  const float4* dots4 =
      reinterpret_cast<const float4*>(a.dots + (size_t)row * a.n);
  const float4* bias4 = reinterpret_cast<const float4*>(a.bias);
  if (tid == 0) s.count = 0;
  if (tid < 3) s.over[tid] = 0;

  // tile i (columns start(i) ...) into stage i % kStages: this thread's
  // chunk v at ring[stage][v][tid]; one commit group per tile, empty past
  // the slab's end
  const int tiles = (col1 - col0 + kTile - 1) / kTile;
  const auto start = [&](int i) { return col0 + i * kTile; };
  const auto issue = [&](int i) {
    if (i < tiles) {
      float4* st = ring + (i % kStages) * (kVec * kThreads);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int g = start(i) + (v * kThreads + tid) * 4;
        if (g < col1) cp_async16(st + v * kThreads + tid, dots4 + g / 4);
      }
    }
    cp_async_commit();
  };
  const auto load_bias = [&](int i, float4 (&bv)[kVec]) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int g = start(i) + (v * kThreads + tid) * 4;
      if (i < tiles && g < col1) bv[v] = __ldg(bias4 + g / 4);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float4 d[kVec], b[kVec], bn[kVec];
  load_bias(0, b);
  int t = start(0);
  const auto fetch = [&](int i) {      // tile i's dots, once landed
    cp_async_wait<kStages - 2>();
    const float4* st = ring + (i % kStages) * (kVec * kThreads);
#pragma unroll
    for (int v = 0; v < kVec; ++v) d[v] = st[v * kThreads + tid];
  };
  const auto valid = [&](int j) {
    return t + ((j >> 2) * kThreads + tid) * 4 < col1;
  };
  const auto score = [&](int j) {
    return __fadd_rn(__fmul_rn(a.scale, lane_of(d[j >> 2], j & 3)),
                     lane_of(b[j >> 2], j & 3));
  };
  const auto key = [&](int j) -> u64 {
    const int v = j >> 2, e = j & 3;
    return score_key(lane_of(d[v], e), lane_of(b[v], e), a.scale,
                     (unsigned)(t + (v * kThreads + tid) * 4 + e));
  };

  // Seed the threshold from the first tile: the c-th largest of the
  // threads' largest keys, where more than c threads hold keys; c
  // distinct keys lie at or above it, so every key below it is out of
  // the slab's top c.
  u64 thr = 0;
  const int seeds = min(kThreads, (col1 - t) / 4);
  if (a.c <= kThreads && seeds > a.c) {
    fetch(0);
    u64 top = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const u64 k = valid(j) ? key(j) : 0;
      top = k > top ? k : top;
    }
    if (tid < seeds) buf[tid] = top;
    thr = select_top(s, buf, seeds, a.c, keep, hist) - 1;
  }
  __syncthreads();

  unsigned round = 0;
  u64 admitted = 0;
  for (int i = 0; i < tiles; ++i) {
    t = start(i);
    issue(i + kStages - 1);
    fetch(i);
    load_bias(i + 1, bn);
    const float lo = key_floor(thr);
    unsigned pend = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      pend |= static_cast<unsigned>(!(score(j) < lo)) << j;
    if (t + kTile > col1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (!valid(j)) pend &= ~(1u << j);
    }
    if (pend) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (((pend >> j) & 1u) && !(key(j) > thr)) pend &= ~(1u << j);
    }
    offer<kPer>(s, buf, keep, hist, a.cap, a.c, pend, thr, round, admitted,
                key);
#pragma unroll
    for (int v = 0; v < kVec; ++v) b[v] = bn[v];
  }
  cp_async_wait<0>();

  int m = min(s.count, a.cap);
  if (m > a.c) {
    select_top(s, buf, m, a.c, keep, hist);
    m = a.c;
  }
  if (gridDim.y == 1) {
    write_ids(buf, m, a.c, a.out + (size_t)row * a.c);
  } else {
    u64* dst = a.keys + (size_t)row * a.ldk + (size_t)blockIdx.y * a.c;
    for (int i = tid; i < a.c; i += kThreads) dst[i] = i < m ? buf[i] : 0;
  }
  if (a.admitted != nullptr) add_admitted(s, admitted, a.admitted);
}

// One CTA per row: the row's `total` per-slab keys (zero keys are padding
// and never admitted) down to its c largest, written as ids.
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
    flat_topk_merge_kernel(const Args a, int total) {
  constexpr int P = 8;                  // keys a thread per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  // run after the select kernel on the same stream, so every region of
  // the scratch is free: the row takes region `row`
  u64* buf = kResident ? reinterpret_cast<u64*>(smem_raw)
                       : a.scratch + (size_t)row * (size_t)a.ld_scratch;
  u64* keep = buf + a.cap;
  int* hist = kResident ? reinterpret_cast<int*>(keep + ((a.c + 1) & ~1))
                        : reinterpret_cast<int*>(smem_raw);
  if (tid == 0) s.count = 0;
  if (tid < 3) s.over[tid] = 0;
  __syncthreads();

  u64 thr = 0;
  unsigned round = 0;
  u64 admitted = 0;
  const uint4* src =
      reinterpret_cast<const uint4*>(a.keys + (size_t)row * a.ldk);
  for (int t = 0; t < total; t += kThreads * P) {
    u64 kv[P];
#pragma unroll
    for (int v = 0; v < P / 2; ++v) {
      const int i = t + (v * kThreads + tid) * 2;
      kv[2 * v] = kv[2 * v + 1] = 0;
      if (i < total) {
        const uint4 w = __ldcs(src + i / 2);
        kv[2 * v] = (static_cast<u64>(w.y) << 32) | w.x;
        if (i + 1 < total)
          kv[2 * v + 1] = (static_cast<u64>(w.w) << 32) | w.z;
      }
    }
    unsigned pend = 0;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (kv[j] > thr) pend |= 1u << j;
    offer<P>(s, buf, keep, hist, a.cap, a.c, pend, thr, round, admitted,
             [&](int j) { return kv[j]; });
  }
  int m = min(s.count, a.cap);
  if (m > a.c) {
    select_top(s, buf, m, a.c, keep, hist);
    m = a.c;
  }
  write_ids(buf, m, a.c, a.out + (size_t)row * a.c);
}

std::atomic<bool> g_smem_set[kMaxDevices];
int g_dynamic_limit[kMaxDevices];

// Raise each kernel's dynamic shared-memory cap to what the card allows a
// block beside the kernel's static shared memory, once per device; *limit
// is the least such cap.
int ensure_smem_cap(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_smem_set[dev].load(std::memory_order_acquire)) {
    *limit = g_dynamic_limit[dev];
    return 0;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const void* kernels[] = {
      reinterpret_cast<const void*>(flat_topk_select_kernel<true>),
      reinterpret_cast<const void*>(flat_topk_select_kernel<false>),
      reinterpret_cast<const void*>(flat_topk_merge_kernel<true>),
      reinterpret_cast<const void*>(flat_topk_merge_kernel<false>)};
  int least = optin;
  for (const void* k : kernels) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return (int)err;
    const int cap = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return (int)err;
    if (cap < least) least = cap;
  }
  g_dynamic_limit[dev] = least;
  *limit = least;
  g_smem_set[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The shared memory the select and merge CTAs may take: *per_block, the
// dynamic shared memory a CTA may ask for beside the kernels' static
// state, and *per_sm, an SM's whole shared memory. Returns a cudaError_t.
extern "C" int leann_flat_topk_smem(int* per_block, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(
      per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;
  return ensure_smem_cap(per_block);
}

// The ids of each row's c largest scale * dots + bias, on `stream`, with
// the wrapper's launch plan (`ops/flat_topk.py:launch_plan`): `slabs`
// slabs of slab_cols columns a row, buffers of cap keys (cap >= 2 * the
// power of two >= c), in shared memory where `scratch` is null, else in
// `scratch` [rows * slabs, ld_scratch] (ld_scratch >= cap + c). With one
// slab the select kernel writes out [rows, c] itself; with more it
// writes `keys` [rows, ldk] (ldk even, >= slabs * c) and the merge kernel
// writes out. `admitted`, when not null, gets the admitted keys' total
// added. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int leann_flat_topk(const float* dots, const float* bias,
                               float scale, int rows, int n, int c,
                               int slabs, int slab_cols, int cap,
                               long long* out, unsigned long long* keys,
                               int ldk, unsigned long long* scratch,
                               long long ld_scratch,
                               unsigned long long* admitted, void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < c) p <<= 1;
  if (n < c || n % 4 || n > 0x7fffffff - 2 * kTile ||
      rows < 0 || slabs < 1 || slabs > 65535 || slab_cols < 4 ||
      slab_cols % 4 || (long long)slabs * slab_cols < n ||
      (long long)(slabs - 1) * slab_cols >= n ||
      cap < 2 * p ||
      (reinterpret_cast<uintptr_t>(dots) & 15) ||
      (reinterpret_cast<uintptr_t>(bias) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 7))
    return (int)cudaErrorInvalidValue;
  if (slabs > 1 && (ldk % 2 || (long long)ldk < (long long)slabs * c ||
                    (reinterpret_cast<uintptr_t>(keys) & 15)))
    return (int)cudaErrorInvalidValue;
  const bool resident = scratch == nullptr;
  if (!resident && (ld_scratch < (long long)cap + ((c + 1) & ~1) ||
                    (reinterpret_cast<uintptr_t>(scratch) & 7)))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int err = ensure_smem_cap(&limit);
  if (err) return err;
  const size_t merge_smem = merge_smem_bytes(resident, cap, c);
  const size_t smem = select_smem_bytes(resident, cap, c);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Args a{dots, bias, scale, rows, n, c, cap, slab_cols, out,
               reinterpret_cast<u64*>(keys), ldk,
               reinterpret_cast<u64*>(scratch), ld_scratch,
               reinterpret_cast<u64*>(admitted)};
  cudaStream_t st = (cudaStream_t)stream;
  if (resident)
    flat_topk_select_kernel<true>
        <<<dim3(rows, slabs), kThreads, smem, st>>>(a);
  else
    flat_topk_select_kernel<false>
        <<<dim3(rows, slabs), kThreads, smem, st>>>(a);
  if (slabs > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (resident)
      flat_topk_merge_kernel<true>
          <<<rows, kThreads, merge_smem, st>>>(a, slabs * c);
    else
      flat_topk_merge_kernel<false>
          <<<rows, kThreads, merge_smem, st>>>(a, slabs * c);
  }
  return (int)cudaGetLastError();
}
