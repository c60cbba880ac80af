// PQ-scored whole-traversal graph beam search for Hopper (sm_90a).
//
// Replaces the TPU kernel `leann_tpu/ops/pq_beam.py:_make_pq_kernel`
// (with `_bitonic_desc` and `_first_k_unexpanded` of ops/fused_beam.py),
// launched there by `pq_beam_search`. It computes the same best-first
// search, hop by hop:
//
//   state   beam (score, id, expanded flag) at sort width P2 =
//           next_pow2(L + E*128); seeds pre-placed in [0, S)
//   rings   one visited ring of V ids per expansion row t; the seeds
//           enter every ring; each hop shifts 128 lanes in
//   hop     pick the E <= 2 best unexpanded live entries and mark them;
//           load their records ([CP, 128] int32: plane-0 lanes [0, R)
//           are neighbour ids, every other lane holds code words and
//           reads as the sentinel); score neighbour i as the ADC sum
//           over subspaces j of LUT[j*KSUB + code_j(i)], code_j(i) in
//           word slot[j] + i / cpl at bit shift (i % cpl) * BITS;
//           mask sentinel, exclude, duplicates within the row (first
//           lane wins), odd row vs any id of the even row, ids in the
//           beam, ids in this row's ring; shift the admitted ids into
//           the ring (-1 elsewhere); bitonic-merge beam | candidates |
//           pad, descending, lower position first on ties; entries past
//           L die
//   vlog    when VT > 0 it wraps: vlog[(it*E + t) % VT] = u_t on every
//           hop up to max_iters, the sentinel once the query is inactive
//           (a query that stops early still applies those writes)
//   stop    no unexpanded live entry, or max_iters
//
// Rounding that decides the merge order, reproduced bit for bit:
//   narrow (KSUB <= 16): score = sum_j bf16(LUT[j, c_j]), float32 adds in
//                        order j = 0..M-1
//   wide   (KSUB > 16):  score = bf16(sum_j LUT[j, c_j]), the float32
//                        sequential sum rounded once
//   a code >= KSUB adds 0 (the reference's one-hot finds no match).
//
// Query groups. The TPU program runs qb queries together and merges all
// of them while any is active: a query whose beam is fully expanded
// takes empty merges, which permute entries of equal score through the
// bitonic network (ties are common: the wide path's scores are bf16).
// Here one CTA owns one query and stops when it converges, recording its
// active hop count; a second kernel then applies the empty merges a
// query of its group would have taken (max hops of the group minus its
// own), only where its beam holds a tie, since without ties an empty
// merge changes nothing.
//
// Design. One CTA of 256 threads per query, the whole state in shared
// memory: the LUT (M*KSUB floats, 16 KB at M=16/KSUB=256, 64 KB at
// M=64), the E records (CP*512 bytes each), the beam (3*P2 ints), the
// rings (E*V ints) and the visited log. Each of the E*R <= 256 candidate
// scores is one thread's sequential M-term sum over the LUT in shared
// memory; each candidate lane is one thread that scans the beam, its
// ring and its row; the merge is a bitonic network over P2 entries, one
// compare-exchange per thread per stage.
//
// Bound. Memory and latency: each hop fetches E records (1 KB each at
// R=48, M=16, 8-bit), and every hop is a dependent round trip to device
// memory (the next hop's nodes are known only after this hop's merge).
// The function needs only the R id lanes and the M*R/cpl code words of
// each expanded record, the LUTs, seeds and outputs once, at 3.35 TB/s.
// The design hides latency by keeping several CTAs (queries) resident
// per SM. Prefetching across hops and a hashed ring are later work.
//
// Record offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;          // lane-padded candidates per row (RP)
constexpr int kMaxM = 256;           // code columns per record

struct Params {
  const float* lut;        // [B, M*KSUB]
  const int32_t* rec;      // [N+1, CP, 128]
  const int32_t* seed_ids; // [B, S]
  const float* seed_sc;    // [B, S]
  const int32_t* exclude;  // [B]
  int32_t* out_ids;        // [B, L]
  float* out_sc;           // [B, L]
  int32_t* vlog;           // [B, VT] or null
  int32_t* hops;           // [B] active hops per query
  int B, R, M, KSUB, BITS, CP, S, L, E, P2, V, Vs, VT, max_iters, qb,
      n_sentinel;
  int16_t slot[kMaxM];     // first word of subspace j within a record
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
pq_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = p.R, M = p.M, KSUB = p.KSUB, L = p.L, E = p.E, P2 = p.P2,
            V = p.V, Vs = p.Vs, VT = p.VT;
  const int CPW = p.CP * kLanes;     // int32 words per record
  const int32_t sentinel = p.n_sentinel;
  const float NEG_INF = __int_as_float(0xff800000);
  const bool wide = KSUB > 16;
  const int cpl = 32 / p.BITS;
  const uint32_t cmask = (1u << p.BITS) - 1u;

  // ---- shared layout (16-byte aligned pieces first) ----
  int32_t* rec = reinterpret_cast<int32_t*>(smem);             // [E, CPW]
  size_t off = (size_t)E * CPW * 4;
  float* lut = reinterpret_cast<float*>(smem + off);           // [M*KSUB]
  off += (size_t)M * KSUB * 4;
  float* st_sc = reinterpret_cast<float*>(smem + off);         // [P2]
  off += (size_t)P2 * 4;
  int32_t* st_id = reinterpret_cast<int32_t*>(smem + off);     // [P2]
  off += (size_t)P2 * 4;
  int32_t* st_exp = reinterpret_cast<int32_t*>(smem + off);    // [P2]
  off += (size_t)P2 * 4;
  float* cand_sc = reinterpret_cast<float*>(smem + off);       // [E, 128]
  off += (size_t)E * kLanes * 4;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + off);      // [E, Vs]
  off += (size_t)E * Vs * 4;
  int32_t* vlog = reinterpret_cast<int32_t*>(smem + off);      // [VT]
  off += (size_t)VT * 4;
  int32_t* sel = reinterpret_cast<int32_t*>(smem + off);       // u0 u1 found

  const int32_t excl = p.exclude[b];

  // ---- init: LUT (narrow path: bf16-rounded), state, rings, vlog ----
  const float* lut_g = p.lut + (size_t)b * M * KSUB;
  for (int i = tid; i < M * KSUB; i += kThreads)
    lut[i] = wide ? lut_g[i] : bf16_round(lut_g[i]);
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
  for (int i = tid; i < VT; i += kThreads) vlog[i] = sentinel;
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
          if (VT > 0) vlog[(it * E + t) % VT] = u;
        }
        sel[2] = found;
      }
    }
    __syncthreads();
    if (sel[2] == 0) {
      // the reference's remaining hops log the sentinel
      hops = it;
      const long rest = (long)(p.max_iters - it - 1) * E;
      const int n_rest = rest < VT ? (int)rest : VT;
      for (int i = tid; i < n_rest; i += kThreads)
        vlog[(int)(((long)(it + 1) * E + i) % VT)] = sentinel;
      break;
    }

    // ---- 2. stage the expanded nodes' records (16-byte loads) ----
    {
      const int rec_vec = CPW / 4;
      for (int i = tid; i < E * rec_vec; i += kThreads) {
        const int t = i / rec_vec, j = i - t * rec_vec;
        const int4* src = reinterpret_cast<const int4*>(
            p.rec + (int64_t)sel[t] * CPW);
        reinterpret_cast<int4*>(rec + t * CPW)[j] = src[j];
      }
    }
    __syncthreads();

    // ---- 3. ADC scores: one thread per (row, neighbour) ----
    if (tid < E * R) {
      const int t = tid / R, i = tid - t * R;
      const int32_t* rw = rec + t * CPW + i / cpl;
      const int sh = (i % cpl) * p.BITS;
      float acc = 0.f;
      for (int j = 0; j < M; ++j) {
        const uint32_t code = ((uint32_t)rw[p.slot[j]] >> sh) & cmask;
        acc = __fadd_rn(acc, code < (uint32_t)KSUB ? lut[j * KSUB + code]
                                                   : 0.f);
      }
      cand_sc[t * kLanes + i] = wide ? bf16_round(acc) : acc;
    }
    __syncthreads();

    // ---- 4. admission masks: one thread per candidate lane ----
    const bool has_lane = tid < E * kLanes;
    const int t = tid >> 7, c = tid & (kLanes - 1);
    int32_t my_id = sentinel;
    bool valid = false;
    if (has_lane) {
      const int32_t* nbr = rec + t * CPW;   // ids in lanes [0, R)
      my_id = c < R ? nbr[c] : sentinel;
      valid = my_id != sentinel && my_id != excl;
      for (int j = 0; valid && j < c; ++j) valid = nbr[j] != my_id;
      if (t == 1)  // the odd row defers to every id of the even row
        for (int j = 0; valid && j < R; ++j) valid = rec[j] != my_id;
      for (int j = 0; valid && j < L; ++j) valid = st_id[j] != my_id;
      const int4* rg = reinterpret_cast<const int4*>(ring + t * Vs);
      for (int j = 0; valid && j < Vs / 4; ++j) {
        const int4 w = rg[j];
        valid = w.x != my_id && w.y != my_id && w.z != my_id && w.w != my_id;
      }
    }
    const float my_sc = valid ? cand_sc[tid] : NEG_INF;
    __syncthreads();

    // ---- 5. ring shift + merge input [beam(L) | candidates | pad] ----
    head = (head - kLanes + V) % V;
    if (has_lane) {
      ring[t * Vs + (head + c) % V] = valid ? my_id : -1;
      st_sc[L + tid] = my_sc;
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
  __syncthreads();

  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[(size_t)b * L + i] = st_id[i];
    p.out_sc[(size_t)b * L + i] = st_sc[i];
  }
  for (int i = tid; i < VT; i += kThreads)
    p.vlog[(size_t)b * VT + i] = vlog[i];
  if (tid == 0) p.hops[b] = hops;
}

// The empty merges of a converged query whose group was still active:
// (max active hops of the group) - (its own), each a bitonic sort of
// [beam(L) | (-inf, sentinel) ...] over P2, entries past L dying.
__global__ void __launch_bounds__(kThreads)
pq_settle_kernel(const Params p) {
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

extern "C" size_t leann_pq_beam_smem_bytes(int MK, int CP, int E, int P2,
                                           int Vs, int VT) {
  return (size_t)E * CP * kLanes * 4 + (size_t)MK * 4 + (size_t)3 * P2 * 4 +
         (size_t)E * kLanes * 4 + (size_t)E * Vs * 4 + (size_t)VT * 4 + 16;
}

// Launches the traversal (one CTA per query) and then the group settle
// pass on `stream`. `slot` holds M host ints. Returns the first
// cudaError_t met (0 = both launched). `vlog` may be null when VT == 0.
extern "C" int leann_pq_beam_search(
    const float* lut, const int32_t* rec, const int32_t* seed_ids,
    const float* seed_sc, const int32_t* exclude, int32_t* out_ids,
    float* out_sc, int32_t* vlog, int32_t* hops, const int* slot, int B,
    int R, int M, int KSUB, int BITS, int CP, int S, int L, int E, int P2,
    int V, int VT, int max_iters, int qb, int n_sentinel, void* stream) {
  if (M > kMaxM || M < 1 || E < 1 || E > 2 || R > kLanes || qb < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.lut = lut;
  p.rec = rec;
  p.seed_ids = seed_ids;
  p.seed_sc = seed_sc;
  p.exclude = exclude;
  p.out_ids = out_ids;
  p.out_sc = out_sc;
  p.vlog = vlog;
  p.hops = hops;
  p.B = B;
  p.R = R;
  p.M = M;
  p.KSUB = KSUB;
  p.BITS = BITS;
  p.CP = CP;
  p.S = S;
  p.L = L;
  p.E = E;
  p.P2 = P2;
  p.V = V;
  p.Vs = (V + 3) & ~3;
  p.VT = VT;
  p.max_iters = max_iters;
  p.qb = qb;
  p.n_sentinel = n_sentinel;
  for (int j = 0; j < M; ++j) p.slot[j] = (int16_t)slot[j];
  const size_t smem = leann_pq_beam_smem_bytes(M * KSUB, CP, E, P2, p.Vs, VT);
  cudaError_t err = cudaFuncSetAttribute(
      pq_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  pq_beam_kernel<<<B, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pq_settle_kernel<<<B, kThreads, (size_t)P2 * 8, s>>>(p);
  return (int)cudaGetLastError();
}
