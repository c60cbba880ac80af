// Fused whole-traversal graph beam search for Hopper (sm_90a).
//
// Replaces the TPU kernel `leann_tpu/ops/fused_beam.py:_make_kernel` (with
// `_bitonic_desc` and `_first_k_unexpanded`), launched there by
// `fused_beam_search`. It computes the same best-first search, hop by hop:
//
//   state   beam (score, id, expanded flag) at sort width P2 =
//           next_pow2(L + E*128); seeds pre-placed in [0, S)
//   rings   one visited ring of V ids per expansion row t; the seeds
//           enter every ring; each hop shifts 128 lanes in, so a ring
//           covers the last floor(V/128) hops
//   hop     pick the E <= 2 best unexpanded live entries and mark them;
//           load their records blocks[u] ([R, D] int8) and meta[u]
//           ([3, 128] int32: ids, scale bits, |v|^2 bits); score every
//           candidate as sum(bf16(q) * int8) in fp32 times the scale
//           (l2: 2*s - |v|^2); mask sentinel, exclude, duplicates within
//           the row (first lane wins), odd row vs ANY id of the even
//           row's raw list, ids already in the beam, ids in this row's
//           ring; shift the admitted ids into the ring (-1 elsewhere);
//           bitonic-merge beam | candidates | pad, descending, lower
//           position first on ties; entries past L die
//   vlog    when VT > 0: vlog[it*E + t] = u_t (sentinel when inactive)
//   stop    no unexpanded live entry, or max_iters
//
// Query groups. The TPU program runs qb queries together and merges all
// of them while any is active: a query whose beam is fully expanded
// takes empty merges (its candidates all (-inf, sentinel), its ring
// shifting in -1s), which permute entries of equal score through the
// bitonic network (duplicate vectors give equal int8 scores). Here one
// CTA owns one query and stops when it converges, recording its active
// hop count; a second kernel then applies the empty merges a query of
// its group would have taken (max hops of the group minus its own), only
// where its beam holds a tie, since without ties an empty merge changes
// nothing. The visited log is unaffected: inactive hops log the
// sentinel, its initial value.
//
// Design. The TPU grouped qb queries per program to feed its matrix unit;
// here one CTA of 256 threads owns one query and keeps the whole state in
// shared memory (~31 KB at L=64, E=2, R=48, D=128: state 6 KB, rings
// 8 KB, records 15 KB). Records are staged with 16-byte vector loads;
// each warp scores whole rows (lane l takes bytes 4l..4l+3 of every
// 128-byte slice, then a shuffle reduction). Each candidate lane is one
// thread that scans the beam, its ring and its row with broadcast
// shared-memory reads. The merge is a bitonic network over P2 entries,
// one compare-exchange per thread per stage.
//
// Bound. Memory and latency: per query the search must read its
// expanded records once each at 3.35 TB/s. The stored record is
// R*D + 3*128*4 bytes (meta is lane-padded, and this kernel reads all
// of it); the function needs only the R live lanes, so the bound counts
// hops * E * (R*D + 3*R*4) bytes. Every hop is a dependent round trip to device memory
// (the next hop's nodes are known only after this hop's merge), so a
// CTA waits on one record fetch per hop; the design hides that latency
// by keeping several CTAs (queries) resident per SM, not by pipelining
// inside a query. Prefetching records across hops (cp.async / TMA), a
// hashed ring and a cheaper merge are later work.
//
// Record offsets are 64-bit: at N=1M, R=48, D=128 the blocks take 6.1 GB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;          // lane-padded candidates per row (RP)
constexpr int kMetaInts = 3 * kLanes;

struct Params {
  const float* q;          // [B, D]
  const int8_t* blocks;    // [N+1, R, D]
  const int32_t* meta;     // [N+1, 3, 128]
  const int32_t* seed_ids; // [B, S]
  const float* seed_sc;    // [B, S]
  const int32_t* exclude;  // [B]
  int32_t* out_ids;        // [B, L]
  float* out_sc;           // [B, L]
  int32_t* vlog;           // [B, VT] or null
  int32_t* hops;           // [B] active hops per query
  int B, D, R, S, L, E, P2, V, Vs, VT, max_iters, metric_l2, n_sentinel, qb;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Descending bitonic sort of P2 (score, id[, exp]) entries in shared
// memory; lower position keeps its entry on ties in descending blocks.
__device__ void bitonic_desc(float* sc, int32_t* id, int32_t* ex, int P2) {
  const int tid = threadIdx.x;
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (P2 >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int up = lo | j;
        const float a = sc[lo], bb = sc[up];
        const bool swap = (lo & k) == 0 ? (bb > a) : (a >= bb);
        if (swap) {
          sc[lo] = bb;
          sc[up] = a;
          const int32_t ti = id[lo];
          id[lo] = id[up];
          id[up] = ti;
          if (ex) {
            const int32_t te = ex[lo];
            ex[lo] = ex[up];
            ex[up] = te;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.D, R = p.R, L = p.L, E = p.E, P2 = p.P2, V = p.V,
            Vs = p.Vs;
  const int32_t sentinel = p.n_sentinel;
  const float NEG_INF = __int_as_float(0xff800000);

  // ---- shared layout (16-byte aligned pieces first) ----
  int8_t* rec = reinterpret_cast<int8_t*>(smem);               // [E, R, D]
  size_t off = (size_t)E * R * D;
  int32_t* meta_s = reinterpret_cast<int32_t*>(smem + off);    // [E, 384]
  off += (size_t)E * kMetaInts * 4;
  float* qf = reinterpret_cast<float*>(smem + off);            // [D]
  off += (size_t)D * 4;
  float* st_sc = reinterpret_cast<float*>(smem + off);         // [P2]
  off += (size_t)P2 * 4;
  int32_t* st_id = reinterpret_cast<int32_t*>(smem + off);     // [P2]
  off += (size_t)P2 * 4;
  int32_t* st_exp = reinterpret_cast<int32_t*>(smem + off);    // [P2]
  off += (size_t)P2 * 4;
  float* cand_dot = reinterpret_cast<float*>(smem + off);      // [E, 128]
  off += (size_t)E * kLanes * 4;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + off);      // [E, Vs]
  off += (size_t)E * Vs * 4;
  int32_t* sel = reinterpret_cast<int32_t*>(smem + off);       // [4]: u0 u1 n_active

  const int32_t excl = p.exclude[b];

  // ---- init: query (bf16-rounded), state, rings, vlog ----
  for (int i = tid; i < D; i += kThreads)
    qf[i] = bf16_round(p.q[(size_t)b * D + i]);
  for (int i = tid; i < P2; i += kThreads) {
    const bool seed = i < p.S;
    st_sc[i] = seed ? p.seed_sc[(size_t)b * p.S + i] : NEG_INF;
    st_id[i] = seed ? p.seed_ids[(size_t)b * p.S + i] : sentinel;
    st_exp[i] = 0;
  }
  for (int i = tid; i < E * Vs; i += kThreads) {
    const int pos = i % Vs;
    int32_t v = -1;
    if (pos < P2) v = pos < p.S ? p.seed_ids[(size_t)b * p.S + pos] : sentinel;
    ring[i] = v;
  }
  if (p.VT > 0)
    for (int i = tid; i < p.VT; i += kThreads)
      p.vlog[(size_t)b * p.VT + i] = sentinel;
  int head = 0;  // ring[t][(head + j) % V] holds logical position j
  int hops = p.max_iters;
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
    // ---- 1. select the E best unexpanded live entries (warp 0) ----
    if (warp == 0) {
      int found = 0;
      int pos[2] = {0, 0};
      for (int base = 0; base < P2 && found < E; base += 32) {
        const int i = base + lane;
        const bool ok = st_exp[i] == 0 && st_sc[i] > NEG_INF;
        unsigned m = __ballot_sync(0xffffffffu, ok);
        while (m && found < E) {
          pos[found++] = base + __ffs(m) - 1;
          m &= m - 1;
        }
      }
      if (lane == 0) {
        for (int t = 0; t < E; ++t) {
          int32_t u = sentinel;
          if (t < found) {
            u = st_id[pos[t]];
            st_exp[pos[t]] = 1;
          }
          sel[t] = u;
          const int idx = it * E + t;
          if (p.VT > 0 && idx < p.VT) p.vlog[(size_t)b * p.VT + idx] = u;
        }
        sel[2] = found;
      }
    }
    __syncthreads();
    if (sel[2] == 0) {
      hops = it;
      break;
    }

    // ---- 2. stage the expanded nodes' records (16-byte loads) ----
    {
      const int rec_vec = R * D / 16;
      for (int i = tid; i < E * rec_vec; i += kThreads) {
        const int t = i / rec_vec, j = i - t * rec_vec;
        const int4* src = reinterpret_cast<const int4*>(
            p.blocks + (int64_t)sel[t] * R * D);
        reinterpret_cast<int4*>(rec + (size_t)t * R * D)[j] = src[j];
      }
      const int meta_vec = kMetaInts / 4;
      for (int i = tid; i < E * meta_vec; i += kThreads) {
        const int t = i / meta_vec, j = i - t * meta_vec;
        const int4* src = reinterpret_cast<const int4*>(
            p.meta + (int64_t)sel[t] * kMetaInts);
        reinterpret_cast<int4*>(meta_s + t * kMetaInts)[j] = src[j];
      }
    }
    __syncthreads();

    // ---- 3. int8 scores: one warp per candidate row ----
    for (int row = warp; row < E * R; row += kThreads / 32) {
      const int t = row / R, j = row - t * R;
      const int8_t* x = rec + ((size_t)t * R + j) * D;
      float acc = 0.f;
      for (int d0 = lane * 4; d0 < D; d0 += 128) {
        const char4 c = *reinterpret_cast<const char4*>(x + d0);
        const float4 qq = *reinterpret_cast<const float4*>(qf + d0);
        acc += qq.x * (float)c.x;
        acc += qq.y * (float)c.y;
        acc += qq.z * (float)c.z;
        acc += qq.w * (float)c.w;
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) cand_dot[t * kLanes + j] = acc;
    }
    __syncthreads();

    // ---- 4. admission masks: one thread per candidate lane ----
    const bool has_lane = tid < E * kLanes;
    const int t = tid >> 7, c = tid & (kLanes - 1);
    int32_t my_id = sentinel;
    float my_sc = NEG_INF;
    bool valid = false;
    if (has_lane) {
      const int32_t* nbr = meta_s + t * kMetaInts;
      my_id = nbr[c];
      valid = my_id != sentinel && my_id != excl;
      for (int j = 0; valid && j < c; ++j) valid = nbr[j] != my_id;
      if (t == 1)  // the odd row defers to every id of the even row
        for (int j = 0; valid && j < kLanes; ++j)
          valid = meta_s[j] != my_id;
      for (int j = 0; valid && j < L; ++j) valid = st_id[j] != my_id;
      const int4* rg = reinterpret_cast<const int4*>(ring + t * Vs);
      for (int j = 0; valid && j < Vs / 4; ++j) {
        const int4 w = rg[j];
        valid = w.x != my_id && w.y != my_id && w.z != my_id && w.w != my_id;
      }
      if (valid) {
        const float s = __fmul_rn(cand_dot[tid],
                                  __int_as_float(nbr[kLanes + c]));
        my_sc = p.metric_l2
            ? __fsub_rn(__fmul_rn(2.f, s), __int_as_float(nbr[2 * kLanes + c]))
            : s;
      }
    }
    __syncthreads();

    // ---- 5. ring shift + merge input [beam(L) | candidates | pad] ----
    head = (head - kLanes + V) % V;
    if (has_lane) {
      ring[t * Vs + (head + c) % V] = valid ? my_id : -1;
      st_sc[L + tid] = valid ? my_sc : NEG_INF;
      st_id[L + tid] = valid ? my_id : sentinel;
      st_exp[L + tid] = 0;
    }
    for (int i = L + E * kLanes + tid; i < P2; i += kThreads) {
      st_sc[i] = NEG_INF;
      st_id[i] = sentinel;
      st_exp[i] = 0;
    }
    __syncthreads();

    // ---- 6. bitonic sort, descending; lower position wins ties ----
    bitonic_desc(st_sc, st_id, st_exp, P2);

    // ---- 7. entries past L die ----
    for (int i = L + tid; i < P2; i += kThreads) {
      st_sc[i] = NEG_INF;
      st_id[i] = sentinel;
      st_exp[i] = 1;
    }
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[(size_t)b * L + i] = st_id[i];
    p.out_sc[(size_t)b * L + i] = st_sc[i];
  }
  if (tid == 0) p.hops[b] = hops;
}

// The empty merges of a converged query whose group was still active:
// (max active hops of the group) - (its own), each a bitonic sort of
// [beam(L) | (-inf, sentinel) ...] over P2, entries past L dying. Every
// live entry of a converged beam is expanded, so the flags need no
// replay.
__global__ void __launch_bounds__(kThreads)
fused_settle_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = p.L, P2 = p.P2;
  const float NEG_INF = __int_as_float(0xff800000);
  const int g0 = (b / p.qb) * p.qb;
  const int g1 = min(p.B, g0 + p.qb);
  int group_hops = 0;
  for (int q = g0; q < g1; ++q) group_hops = max(group_hops, p.hops[q]);
  const int idle = group_hops - p.hops[b];
  if (idle <= 0) return;

  float* sc = reinterpret_cast<float*>(smem);                  // [P2]
  int32_t* id = reinterpret_cast<int32_t*>(smem + (size_t)P2 * 4);
  for (int i = tid; i < P2; i += kThreads) {
    sc[i] = i < L ? p.out_sc[(size_t)b * L + i] : NEG_INF;
    id[i] = i < L ? p.out_ids[(size_t)b * L + i] : p.n_sentinel;
  }
  __syncthreads();
  // without a tie among live entries an empty merge is the identity
  bool tie = false;
  for (int i = tid; i + 1 < L; i += kThreads)
    tie |= sc[i] > NEG_INF && sc[i] == sc[i + 1];
  if (!__syncthreads_or(tie)) return;

  for (int k = 0; k < idle; ++k) {
    bitonic_desc(sc, id, nullptr, P2);
    for (int i = L + tid; i < P2; i += kThreads) {
      sc[i] = NEG_INF;
      id[i] = p.n_sentinel;
    }
    __syncthreads();
  }
  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[(size_t)b * L + i] = id[i];
    p.out_sc[(size_t)b * L + i] = sc[i];
  }
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" size_t leann_fused_beam_smem_bytes(int D, int R, int E, int P2,
                                              int Vs) {
  return (size_t)E * R * D + (size_t)E * kMetaInts * 4 + (size_t)D * 4 +
         (size_t)3 * P2 * 4 + (size_t)E * kLanes * 4 + (size_t)E * Vs * 4 +
         16;
}

// Launches the traversal (one CTA per query) and then the group settle
// pass on `stream`. Returns the first cudaError_t met (0 = both
// launched). `vlog` may be null when VT == 0.
extern "C" int leann_fused_beam_search(
    const float* q, const int8_t* blocks, const int32_t* meta,
    const int32_t* seed_ids, const float* seed_sc, const int32_t* exclude,
    int32_t* out_ids, float* out_sc, int32_t* vlog, int32_t* hops, int B,
    int D, int R, int S, int L, int E, int P2, int V, int VT, int max_iters,
    int metric_l2, int n_sentinel, int qb, void* stream) {
  if (qb < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.blocks = blocks;
  p.meta = meta;
  p.seed_ids = seed_ids;
  p.seed_sc = seed_sc;
  p.exclude = exclude;
  p.out_ids = out_ids;
  p.out_sc = out_sc;
  p.vlog = vlog;
  p.hops = hops;
  p.B = B;
  p.D = D;
  p.R = R;
  p.S = S;
  p.L = L;
  p.E = E;
  p.P2 = P2;
  p.V = V;
  p.Vs = (V + 3) & ~3;
  p.VT = VT;
  p.max_iters = max_iters;
  p.metric_l2 = metric_l2;
  p.n_sentinel = n_sentinel;
  p.qb = qb;
  const size_t smem = leann_fused_beam_smem_bytes(D, R, E, P2, p.Vs);
  cudaError_t err = cudaFuncSetAttribute(
      fused_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  fused_beam_kernel<<<B, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_settle_kernel<<<B, kThreads, (size_t)P2 * 8, s>>>(p);
  return (int)cudaGetLastError();
}
