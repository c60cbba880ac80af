// Exact top-C select of IVF stage 1, for Hopper (sm_90a): ivf_topc.
//
// Replaces no TPU kernel. The reference scores the probed buckets with
// its bucket kernel (`leann_tpu/ops/pallas_kernels.py:_bucket_dots_kernel`)
// and keeps the candidates with `jax.lax.top_k` over the flattened scores
// (`leann_tpu/ops/pallas_kernels.py:265`). On the card the
// port's `ivf_search` hands kernel B4's dots to this kernel, which folds,
// masks and selects as it reads them once. For dots [P, B, cap] float32
// (query b's probe p at dots[(p * B + b) * cap + slot]), probes [B, P]
// int32 (the bucket of each), bucket_sq [K', cap] float32 and bucket_ids
// [K', cap] int32, the score of query b at position i = p * cap + slot is
//
//   s = fl(fl(2 * dot) - bucket_sq[probe[b, p], slot])   (l2)
//   s = dot                                             (ip)
//
// and -inf where bucket_ids[probe[b, p], slot] == sentinel (or the probe
// lies outside [0, K')). It writes scores [B, c] float32 and ids [B, c]
// int64: each query's c largest scores in descending order, equal scores
// to the lower position, with their bucket ids; a score of -inf, and the
// tail where a query has fewer than c positions, writes id -1. That is
// `topk_stable` over the flattened [B, P * cap] scores, and also what the
// running merge over the probes of `ops/ivf.py:ivf_search` returns on the
// CPU, whose first fill of (-inf, -1) ranks before every later -inf. The
// product and the difference are rounded one at a time (__fmul_rn,
// __fsub_rn), as PyTorch's two elementwise passes round them; -0.0 counts
// as +0.0 and NaN above +inf, as torch.sort orders them.
//
// Bound. Bytes: the dots read once (B * P * cap * 4; 42.6 MB at the IVF
// benchmark cell, 1M x 128, B = 2048, P = 8, cap 650), the probed buckets'
// ids and |v|^2 once each, the probes, and the [B, c] output. Operations
// are a few per score.
//
// Design. Each score becomes a 64-bit key: the float's bits mapped to an
// order-preserving uint32 in the high half, the complemented position in
// the low half. Keys are distinct, so "the c largest keys" is exactly the
// stable top-c, and its order is the key order. One CTA of 256 threads per
// query streams the query's P * cap positions in tiles of 3,072 (12 a
// thread, at tid + 256 j, so a warp reads 32 consecutive slots of one
// bucket): each thread issues every load of its tile (the dot, then the
// slot's id and |v|^2 through its probe's bucket) before it scores any,
// and keeps the 12 scores in registers. The CTA's steps wait on loads and
// barriers, so what sets the pace is how many CTAs an SM holds: at 48
// registers five (0.081 ms at the IVF cell on the H100), against 0.101 ms
// with 24 positions a thread at 80 registers and three (PERF.md). The
// query keeps a running threshold, the c-th largest key admitted so far,
// and a buffer of `capb` keys. In the first tile the threshold starts at
// the least of the 8 warps' ceil(c / 8)-th largest thread maximum (where
// c <= 256): each warp holds that many keys at or above it, c in all, so
// no key below it is in the top c (at the IVF cell 73 keys a query passed
// it at c = 40, in a run with 24 positions a thread). A score is first tested in floats against the threshold's
// score; only those that pass get their exact key, and a key above the
// threshold is admitted by a warp ballot and one shared atomic per warp.
// A round that overflows the buffer selects its c largest (an MSB radix
// select on 8-bit digits, the histogram in shared memory), raises the
// threshold and admits what waited. At the end, where at most 256 keys
// were admitted, each thread counts the keys above one of them, which is
// that key's place in the output: one barrier where a radix select and a
// sort take dozens. Otherwise the c largest are selected and sorted by a
// bitonic network. Each survivor's score and id are read again from its
// position: the scores are the same bits, and only the survivors' ids are
// written out.
//
// Buffers. Where the buffer and the compaction's keep area of c keys fit
// in shared memory (c up to 8,192 on the H100) they live there
// (`kResident`); above that each CTA gets a region of a global scratch.
//
// Limits: c <= 2^29, P * cap and K' * cap below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 12;                // positions a thread per tile
constexpr int kTile = kThreads * kPer;  // 3,072 positions a tile
constexpr int kMinCtas = 5;             // CTAs an SM holds: 48 registers
constexpr int kBins = 256;              // == kThreads: one bin a thread
constexpr int kMaxC = 1 << 29;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBins == kThreads, "select_top clears one bin a thread");
static_assert(kPer <= 32, "a thread's pending positions are bits of a word");

struct Shared {
  int count;             // keys admitted into the buffer
  unsigned over[3];      // whether it overflowed, by round mod 3
  u64 prefix;            // select_top: digits fixed so far
  int need;              // select_top: keys still to take in that bin
  int done;
  int kept;
  u64 wmin[kWarps];
};

struct Args {
  const float* dots;    // [p, b, cap]
  const int* probe;     // [b, p]
  const float* sq;      // [kp, cap] (l2)
  const int* ids;       // [kp, cap]
  int b, p, cap, kp, c, capb, sentinel, l2;
  float* out_scores;    // [b, c]
  long long* out_ids;   // [b, c]
  u64* scratch;         // nullptr (buffers in shared memory), or [b,
                        // ld_scratch]: a CTA's buffer of capb keys and
                        // keep area
  long long ld_scratch;
};

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// The score's key: order-preserving bits of the float above the
// complemented position. Never 0 (-inf maps to 0x007fffff), so a zero key
// pads.
__device__ __forceinline__ u64 score_key(float s, unsigned pos) {
  unsigned f = __float_as_uint(s);
  unsigned u;
  if (s != s) {
    u = 0xffffffffu;                    // NaN first, as torch.sort
  } else {
    if (f == 0x80000000u) f = 0u;       // -0.0 == +0.0
    u = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  }
  return (static_cast<u64>(u) << 32) | static_cast<u64>(~pos);
}

// The least score a key above k can have, for a first test in floats:
// `!(score < key_floor(k))` holds for every score whose key exceeds k
// (NaN and either zero included); -inf below the first key.
__device__ __forceinline__ float key_floor(u64 k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  if (k == 0) return neg_inf();
  if (u == 0xffffffffu) return __uint_as_float(0x7fffffffu);  // NaN
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// The number of keys of keys[0, m) above k: k's place in descending order
// among distinct keys. Every thread reads the same address at once.
__device__ __forceinline__ int rank_of(const u64* keys, int m, u64 k) {
  int r = 0;
#pragma unroll 8
  for (int i = 0; i < m; ++i) r += keys[i] > k;
  return r;
}

// Score of query q at position i (< p * cap), and the slot's id in *id
// (-1 for an empty slot or a probe outside [0, kp), whose score is -inf).
__device__ __forceinline__ float score_at(const Args& a, int q, unsigned i,
                                          int* id) {
  const unsigned pr = i / static_cast<unsigned>(a.cap);
  const unsigned slot = i - pr * static_cast<unsigned>(a.cap);
  const float d = __ldcs(a.dots + ((size_t)pr * a.b + q) * a.cap + slot);
  const int bucket = __ldg(a.probe + (size_t)q * a.p + pr);
  const bool in = bucket >= 0 && bucket < a.kp;
  const size_t at = (size_t)(in ? bucket : 0) * a.cap + slot;
  const int v = __ldg(a.ids + at);
  const float s = a.l2 ? __fsub_rn(__fmul_rn(2.0f, d), __ldg(a.sq + at)) : d;
  const bool live = in && v != a.sentinel;
  *id = live ? v : -1;
  return live ? s : neg_inf();
}

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

// Admits each thread's pending positions (bit j of pend: position j,
// key(j), lies above thr) into the buffer, one round at a time: a round
// that overflows it ends with select_top, a higher threshold and the
// waiting positions filtered by it. Every thread calls it; it returns
// after a barrier.
template <class Key>
__device__ __forceinline__ void offer(Shared& s, u64* buf, u64* keep,
                                      int* hist, int capb, int c,
                                      unsigned pend, u64& thr,
                                      unsigned& round, const Key& key) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (;;) {
    if (__any_sync(kFull, pend)) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool want = (pend >> j) & 1u;
        const unsigned bal = __ballot_sync(kFull, want);
        if (bal) {
          const int lead = __ffs(bal) - 1;
          int pos = 0;
          if (lane == lead) pos = atomicAdd(&s.count, __popc(bal));
          pos = __shfl_sync(kFull, pos, lead) + __popc(bal & lt);
          if (want) {
            if (pos < capb) {
              buf[pos] = key(j);
              pend &= ~(1u << j);
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
    thr = select_top(s, buf, capb, c, keep, hist);
    if (threadIdx.x == 0) s.count = c;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (((pend >> j) & 1u) && !(key(j) > thr)) pend &= ~(1u << j);
    __syncthreads();
  }
}

// One CTA per query: its c largest keys over the P * cap positions,
// written as scores and ids.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    ivf_topc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  u64* buf = kResident ? reinterpret_cast<u64*>(smem_raw)
                       : a.scratch + (size_t)q * (size_t)a.ld_scratch;
  u64* keep = buf + a.capb;
  int* hist = kResident ? reinterpret_cast<int*>(keep + ((a.c + 1) & ~1))
                        : reinterpret_cast<int*>(smem_raw);
  const unsigned n = static_cast<unsigned>(a.p) * static_cast<unsigned>(a.cap);
  if (tid == 0) s.count = 0;
  if (tid < 3) s.over[tid] = 0;

  float sc[kPer];
  unsigned t = 0;                       // the tile's first position
  const unsigned cap = static_cast<unsigned>(a.cap);
  const float* dots_q = a.dots + (size_t)q * cap;  // probe 0's row
  const size_t stride = (size_t)a.b * cap;         // one probe's rows
  const int* probe_q = a.probe + (size_t)q * a.p;
  // every load of the tile first, then the scores (`score_at`'s, with the
  // probe and slot carried from one position to the next, 256 on); a
  // position past the end reads position 0 again and is never admitted
  const auto load = [&]() {
    unsigned pr = (t + tid) / cap;
    unsigned slot = t + tid - pr * cap;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = t + j * kThreads + tid < n;
      const unsigned pj = ok ? pr : 0u, sj = ok ? slot : 0u;
      const float d = __ldcs(dots_q + pj * stride + sj);
      const int bucket = __ldg(probe_q + pj);
      const bool in = bucket >= 0 && bucket < a.kp;
      const unsigned at = static_cast<unsigned>(in ? bucket : 0) * cap + sj;
      const int v = __ldg(a.ids + at);
      const float s2 =
          a.l2 ? __fsub_rn(__fmul_rn(2.0f, d), __ldg(a.sq + at)) : d;
      sc[j] = in && v != a.sentinel ? s2 : neg_inf();
      slot += kThreads;
      if (slot >= cap) {
        slot -= cap;
        ++pr;
        if (slot >= cap) {              // cap < 256
          const unsigned w = slot / cap;
          pr += w;
          slot -= w * cap;
        }
      }
    }
  };
  const auto valid = [&](int j) { return t + j * kThreads + tid < n; };
  const auto key = [&](int j) -> u64 {
    return score_key(sc[j], t + j * kThreads + tid);
  };

  // Seed the threshold from the first tile, where every thread holds a
  // key: each warp sorts its threads' largest keys (a bitonic network of
  // shuffles) and offers its r-th largest, r = ceil(c / 8); the least
  // offer has r keys of each warp, at least c, at or above it, so every
  // key below it is out of the query's top c.
  u64 thr = 0;
  if (n > 0) load();
  if (a.c <= kThreads && n >= static_cast<unsigned>(kThreads)) {
    const int lane = tid & 31;
    u64 v = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const u64 k = valid(j) ? key(j) : 0;
      v = k > v ? k : v;
    }
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const u64 o = __shfl_xor_sync(kFull, v, j);
        // descending where lane & k is 0: the lower lane keeps the larger
        const bool larger = ((lane & j) == 0) == ((lane & k) == 0);
        v = larger ? (o > v ? o : v) : (o < v ? o : v);
      }
    }
    if (lane == (a.c + kWarps - 1) / kWarps - 1) s.wmin[tid >> 5] = v;
    __syncthreads();
    u64 least = s.wmin[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) least = umin64(least, s.wmin[w]);
    thr = least - 1;
  }
  __syncthreads();

  unsigned round = 0;
  for (; t < n; t += kTile) {
    if (t > 0) load();
    const float lo = key_floor(thr);
    unsigned pend = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      pend |= static_cast<unsigned>(valid(j) && !(sc[j] < lo)) << j;
    if (pend) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (((pend >> j) & 1u) && !(key(j) > thr)) pend &= ~(1u << j);
    }
    offer(s, buf, keep, hist, a.capb, a.c, pend, thr, round, key);
    if (n - t <= (unsigned)kTile) break;  // t + kTile may wrap
  }

  // Each survivor's score and id are read again from its position; a
  // zero key (no position) and a score of -inf write (-inf, -1).
  float* out_s = a.out_scores + (size_t)q * a.c;
  long long* out_i = a.out_ids + (size_t)q * a.c;
  const auto put = [&](int i, u64 k) {
    float score = neg_inf();
    int id = -1;
    if (k != 0) score = score_at(a, q, ~static_cast<unsigned>(k), &id);
    const bool keep_id = id >= 0 && score != neg_inf();
    out_s[i] = keep_id ? score : neg_inf();
    out_i[i] = keep_id ? id : -1;
  };
  int m = min(s.count, a.capb);
  if (m > kThreads && m > a.c) {
    select_top(s, buf, m, a.c, keep, hist);
    m = a.c;
  }
  if (m <= kThreads) {
    // few keys (the IVF cell's c = 40 admits some 45): each thread ranks
    // one key among them, which is its place in the output
    const u64 k = tid < m ? buf[tid] : 0;
    const int r = tid < m ? rank_of(buf, m, k) : a.c;
    if (r < a.c) put(r, k);
    for (int i = m + tid; i < a.c; i += kThreads) put(i, 0);
    return;
  }
  // sort the c largest descending, zero keys padding them to a power of
  // two, then write them
  int p2 = 1;
  while (p2 < a.c) p2 <<= 1;
  for (int i = m + tid; i < p2; i += kThreads) buf[i] = 0;
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += kThreads) {
        const int x = i ^ j;
        if (x > i) {
          const u64 u = buf[i], v = buf[x];
          if (((i & k) == 0) == (u < v)) {
            buf[i] = v;
            buf[x] = u;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < a.c; i += kThreads) put(i, buf[i]);
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
      reinterpret_cast<const void*>(ivf_topc_kernel<true>),
      reinterpret_cast<const void*>(ivf_topc_kernel<false>)};
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

// The dynamic shared memory a CTA may ask for beside the kernel's static
// state, in *per_block. Returns a cudaError_t.
extern "C" int leann_ivf_topc_smem(int* per_block) {
  return ensure_smem_cap(per_block);
}

// Each query's c largest scores of B4's dots with the l2 fold (l2 = 1) and
// the sentinel mask, on `stream` (see the top of this file): buffers of
// capb keys (capb >= 2 * the power of two >= c), in shared memory where
// `scratch` is null, else in `scratch` [b, ld_scratch] (ld_scratch >=
// capb + c). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int leann_ivf_topc(const float* dots, const int* probe,
                              const float* sq, const int* ids, int b, int p,
                              int cap, int kp, int c, int capb, int sentinel,
                              int l2, float* out_scores, long long* out_ids,
                              unsigned long long* scratch,
                              long long ld_scratch, void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  if (b < 0 || p < 0 || cap < 1 || kp < 1 ||
      (long long)p * cap > 0x7fffffffLL ||
      (long long)kp * cap > 0x7fffffffLL || capb < 2 * p2 ||
      (reinterpret_cast<uintptr_t>(out_ids) & 7))
    return (int)cudaErrorInvalidValue;
  const bool resident = scratch == nullptr;
  if (!resident && (ld_scratch < (long long)capb + ((c + 1) & ~1) ||
                    (reinterpret_cast<uintptr_t>(scratch) & 7)))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const int err = ensure_smem_cap(&limit);
  if (err) return err;
  const size_t smem = kBins * 4 + (resident ? ((size_t)capb +
                                               ((c + 1) & ~1)) * 8 : 0);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const Args a{dots, probe, sq, ids, b, p, cap, kp, c, capb, sentinel, l2,
               out_scores, out_ids, reinterpret_cast<u64*>(scratch),
               ld_scratch};
  cudaStream_t st = (cudaStream_t)stream;
  if (resident)
    ivf_topc_kernel<true><<<b, kThreads, smem, st>>>(a);
  else
    ivf_topc_kernel<false><<<b, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
