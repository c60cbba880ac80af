// PQ-scored whole-traversal graph beam search for Hopper (sm_90a).
//
// Replaces the TPU kernel `leann_tpu/ops/pq_beam.py:_make_pq_kernel`
// (with `_bitonic_desc` and `_first_k_unexpanded` of ops/fused_beam.py),
// launched there by `pq_beam_search`. It computes the same best-first
// search, hop by hop:
//
//   state   beam (score, id, expanded flag) of L entries; seeds in [0, S)
//   rings   one visited ring of V ids per expansion row t; the seeds
//           enter every ring; each hop shifts 128 lanes in
//   hop     pick the E <= 2 best unexpanded live entries and mark them;
//           load their records ([CP, 128] int32: plane-0 lanes [0, R)
//           are neighbour ids, every other lane holds code words and
//           reads as the sentinel); mask sentinel, exclude, duplicates
//           within the row (first lane wins), odd row vs any id of the
//           even row, ids in the beam, ids in this row's ring; shift the
//           admitted ids into the ring (-1 elsewhere); score neighbour i
//           as the ADC sum over subspaces j of LUT[j*KSUB + code_j(i)],
//           code_j(i) in word slot[j] + i / cpl at bit shift (i % cpl) *
//           BITS; merge: the descending bitonic sort of beam | candidates
//           | pad over P2 = next_pow2(L + E*128), lower position first on
//           ties in descending blocks; entries past L die
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
// active hop count; a second kernel then applies the `idle` empty merges
// a query of its group would have taken (max hops of the group minus its
// own). A converged beam is sorted, so an empty merge leaves its score
// sequence as it was, and the network's decisions depend on the scores
// alone: every empty merge applies one permutation pi to the live
// prefix, and `idle` of them apply pi^idle. The settle pass runs the
// network once to get pi and raises it to the power by squaring (about
// 2 log2(idle) barriers instead of 45 * idle). A beam that is not
// ordinary (unsorted, or a -inf entry that is not the sentinel: only a
// query that never expanded) takes the empty merges one by one.
//
// Design. One CTA of 256 threads owns one query and keeps its state in
// shared memory: the LUT (M*KSUB floats, 16 KB at M=16/KSUB=256), the E
// records, two beam buffers (read one, write the other), the rings and
// the visited log. Per hop:
//   stage   the records go to shared memory by cp.async, waited for only
//           after admission; each lane thread loads its own id from
//           plane 0 of its row's record
//   admit   set membership asked the other way round: the <= E*R ids go
//           into an open-addressed table in shared memory (2*E*128
//           slots, atomicCAS on the key; per row t the lowest lane
//           holding the id by atomicMin, with flag bits "in the beam" and
//           "in ring t"); all threads probe it with the L beam ids and
//           the E*V ring ids; a lane is admitted by reading its own slot.
//           (The TPU kernel's masks scan the beam, the row and the whole
//           ring per candidate.)
//   score   only the admitted lanes, listed by a ballot: one thread per
//           candidate sums its M terms in order j = 0..M-1
//   merge   the same network, run in registers: each thread holds EPT =
//           P2/256 consecutive positions as (score, input position);
//           stages whose pairs lie in one thread swap registers, stages
//           within a warp go by __shfl_xor_sync, and only the 6 stages
//           that cross warps (the top three position bits) go through
//           shared memory, one barrier each. Within a stage the pairs are
//           disjoint and each applies the per-pair rule of position and
//           scores, so the order of work does not change the result. The
//           ids and flags follow by the final input positions.
// Barriers per hop: 12 (the earlier design: ~50 at P2=512).
//
// Bound. Memory and latency: each hop fetches E records (1 KB each at
// R=48, M=16, 8-bit), and every hop is a dependent round trip to device
// memory (the next hop's nodes are known only after this hop's merge).
// The function needs only the R id lanes and the M*R/cpl code words of
// each expanded record, the LUTs, seeds and outputs once, at 3.35 TB/s.
// The hop's latency, its barriers and the CTAs that fit on an SM set the
// pace.
//
// Record offsets are 64-bit. P2 is at most 4096 (L + E*128 <= 4096).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;          // lane-padded candidates per row (RP)
constexpr int kMaxM = 256;           // code columns per record
constexpr int32_t kEmpty = -1;       // a free slot of the candidate table
constexpr int kNoLane = 0xFFFF;      // lane field: the id is not in the row
constexpr int kInBeam = 1 << 16;     // flag bits above the lane field
constexpr int kInRing = 1 << 17;

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
  int B, R, M, KSUB, BITS, CP, S, L, E, V, Vs, VT, max_iters, qb,
      n_sentinel;
  int T, tshift;           // table slots (a power of two), 32 - log2(T)
  int16_t slot[kMaxM];     // first word of subspace j within a record
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of the shared-memory pieces. `u` is one region used by
// turns in a hop: the candidate table (admission), then the exchange
// buffers of the network's cross-warp stages (merge).
struct Layout {
  size_t rec, lut, beam, cand, ring, vlog, u, ctl, total;
};

__host__ __device__ inline Layout layout(int MK, int CP, int E, int L,
                                         int P2, int Vs, int VT, int T) {
  Layout s;
  size_t off = 0;
  s.rec = off;  off = align16(off + (size_t)E * CP * kLanes * 4);  // [E, CP*128]
  s.lut = off;  off = align16(off + (size_t)MK * 4);               // [M*KSUB]
  s.beam = off; off = align16(off + (size_t)2 * 3 * L * 4);  // 2 x sc|id|exp [L]
  // candidate scores and ids by lane, and the admitted lanes in order
  s.cand = off; off = align16(off + (size_t)3 * E * kLanes * 4);
  s.ring = off; off = align16(off + (size_t)E * Vs * 4);           // [E, Vs]
  s.vlog = off; off = align16(off + (size_t)VT * 4);               // [VT]
  s.u = off;
  const size_t xchg = (size_t)2 * P2 * 8, table = (size_t)(1 + E) * T * 4;
  off = align16(off + (xchg > table ? xchg : table));
  s.ctl = off;  off += 8 * 4;  // u0 u1 found n_live
  s.total = off;
  return s;
}

inline int table_slots(int E) { return 2 * E * kLanes; }  // 256 or 512

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int table_home(int32_t id, int tshift) {
  return (int)(((uint32_t)id * 2654435761u) >> tshift);
}

// The slot of `id`, inserted if absent (linear probing; the table holds
// at most E*R <= T/2 ids, so a free slot is always found).
__device__ __forceinline__ int table_insert(int32_t* key, int32_t id,
                                            int tshift, int tmask) {
  int h = table_home(id, tshift);
  while (true) {
    const int32_t prev = atomicCAS(&key[h], kEmpty, id);
    if (prev == kEmpty || prev == id) return h;
    h = (h + 1) & tmask;
  }
}

// Sets `flag` on the slot of `id` when it is in the table.
__device__ __forceinline__ void mark(const int32_t* key, int* w, int32_t id,
                                     int flag, int tshift, int tmask) {
  int h = table_home(id, tshift);
  while (true) {
    const int32_t k = key[h];
    if (k == id) {
      atomicOr(&w[h], flag);
      return;
    }
    if (k == kEmpty) return;
    h = (h + 1) & tmask;
  }
}

// One compare-exchange seen from one side: this thread holds the entry
// (s, q), the other side (os, oq). The pair (lo, up = lo | j) swaps when
// (lo & k) == 0 ? sc[up] > sc[lo] : sc[lo] >= sc[up], the rule of the
// shared-memory network; `upper` says this side is `up`, `asc` that
// (lo & k) != 0. By cases that is (upper ? s > os : os > s) ^ asc, and
// both sides, seeing the same two scores, take the same decision.
__device__ __forceinline__ void exchange(float& s, int& q, float os, int oq,
                                         bool upper, bool asc) {
  if ((upper ? s > os : os > s) != asc) {
    s = os;
    q = oq;
  }
}

// The descending bitonic network over P2 = 256 * EPT positions; thread
// `tid` holds positions tid*EPT + r in (sc[r], pos[r]). `xbuf` holds 2 *
// P2 entries of shared memory for the stages that cross warps (two
// buffers by turns, so one barrier each). Ends with no barrier pending
// on `xbuf` reads.
template <int EPT>
__device__ __forceinline__ void network(float (&sc)[EPT], int (&pos)[EPT],
                                        uint2* xbuf) {
  constexpr int kLog = EPT == 1 ? 8 : EPT == 2 ? 9 : EPT == 4 ? 10
                     : EPT == 8 ? 11 : 12;
  constexpr int P2 = kThreads * EPT;
  const int tid = threadIdx.x;
  int turn = 0;
#pragma unroll
  for (int kb = 1; kb <= kLog; ++kb) {
    const int k = 1 << kb;
#pragma unroll
    for (int jb = kb - 1; jb >= 0; --jb) {
      const int j = 1 << jb;
      if (j < EPT) {                         // inside the thread
#pragma unroll
        for (int r = 0; r < EPT; ++r) {
          if (r & j) continue;
          const int lo = tid * EPT + r;
          const float a = sc[r], bb = sc[r | j];
          const bool swap = (lo & k) == 0 ? (bb > a) : (a >= bb);
          if (swap) {
            sc[r] = bb;
            sc[r | j] = a;
            const int t = pos[r];
            pos[r] = pos[r | j];
            pos[r | j] = t;
          }
        }
      } else if (j < 32 * EPT) {             // inside the warp
        // k > j >= EPT: bits j and k of a position are bits of tid
        const bool upper = tid & (j / EPT), asc = tid & (k / EPT);
#pragma unroll
        for (int r = 0; r < EPT; ++r) {
          const float os = __shfl_xor_sync(0xffffffffu, sc[r], j / EPT);
          const int oq = __shfl_xor_sync(0xffffffffu, pos[r], j / EPT);
          exchange(sc[r], pos[r], os, oq, upper, asc);
        }
      } else {                               // across warps
        uint2* buf = xbuf + turn * P2;
        turn ^= 1;
#pragma unroll
        for (int r = 0; r < EPT; ++r)
          buf[tid * EPT + r] = make_uint2(__float_as_uint(sc[r]), pos[r]);
        __syncthreads();
        const int other = (tid ^ (j / EPT)) * EPT;
        const bool upper = tid & (j / EPT), asc = tid & (k / EPT);
#pragma unroll
        for (int r = 0; r < EPT; ++r) {
          const uint2 o = buf[other + r];
          exchange(sc[r], pos[r], __uint_as_float(o.x), (int)o.y, upper,
                   asc);
        }
      }
    }
  }
}

template <int EPT>
__global__ void __launch_bounds__(kThreads)
pq_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P2 = kThreads * EPT;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = p.R, M = p.M, KSUB = p.KSUB, L = p.L, E = p.E, V = p.V,
            Vs = p.Vs, VT = p.VT, T = p.T, tshift = p.tshift, tmask = T - 1;
  const int CPW = p.CP * kLanes;     // int32 words per record
  const int C = E * kLanes;          // candidate lanes
  const int32_t sentinel = p.n_sentinel;
  const float NEG_INF = __int_as_float(0xff800000);
  const bool wide = KSUB > 16;
  const int cpl = 32 / p.BITS;
  const uint32_t cmask = (1u << p.BITS) - 1u;

  const Layout lay = layout(M * KSUB, p.CP, E, L, P2, Vs, VT, T);
  int32_t* rec = reinterpret_cast<int32_t*>(smem + lay.rec);
  float* lut = reinterpret_cast<float*>(smem + lay.lut);
  float* beam = reinterpret_cast<float*>(smem + lay.beam);  // 2 x [3, L]
  float* cand_sc = reinterpret_cast<float*>(smem + lay.cand);  // [C]
  int32_t* cand_id = reinterpret_cast<int32_t*>(cand_sc + C);  // [C]
  int32_t* adm = cand_id + C;                                  // [C]
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.ring);
  int32_t* vlog = reinterpret_cast<int32_t*>(smem + lay.vlog);
  int32_t* key = reinterpret_cast<int32_t*>(smem + lay.u);     // [T]
  int* lanes = reinterpret_cast<int*>(key + T);                // [E, T]
  uint2* xbuf = reinterpret_cast<uint2*>(smem + lay.u);        // [2, P2]
  int32_t* ctl = reinterpret_cast<int32_t*>(smem + lay.ctl);

  const int32_t excl = p.exclude[b];

  // ---- init: LUT (narrow path: bf16-rounded), beam, rings, vlog ----
  const float* lut_g = p.lut + (size_t)b * M * KSUB;
  for (int i = tid; i < M * KSUB; i += kThreads)
    lut[i] = wide ? lut_g[i] : bf16_round(lut_g[i]);
  for (int i = tid; i < L; i += kThreads) {
    const bool seed = i < p.S;
    beam[i] = seed ? p.seed_sc[(size_t)b * p.S + i] : NEG_INF;
    reinterpret_cast<int32_t*>(beam)[L + i] =
        seed ? p.seed_ids[(size_t)b * p.S + i] : sentinel;
    reinterpret_cast<int32_t*>(beam)[2 * L + i] = 0;
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
  int cur = 0;   // the beam buffer this hop reads
  const int t = tid >> 7, c = tid & (kLanes - 1);  // this thread's lane
  const bool has_lane = tid < C && c < R;
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
    float* a_sc = beam + cur * 3 * L;
    int32_t* a_id = reinterpret_cast<int32_t*>(a_sc + L);
    int32_t* a_ex = a_id + L;
    // ---- 1. select the E best unexpanded live entries (warp 0); the
    //         other warps clear the candidate table ----
    if (warp == 0) {
      int found = 0, pos0 = 0, pos1 = 0;
      for (int base = 0; base < L && found < E; base += 32) {
        const int i = base + lane;
        const bool ok = i < L && a_ex[i] == 0 && a_sc[i] > NEG_INF;
        unsigned m = __ballot_sync(0xffffffffu, ok);
        while (m && found < E) {
          (found == 0 ? pos0 : pos1) = base + __ffs(m) - 1;
          ++found;
          m &= m - 1;
        }
      }
      if (lane == 0) {
        for (int k = 0; k < E; ++k) {
          int32_t u = sentinel;
          if (k < found) {
            const int pk = k == 0 ? pos0 : pos1;
            u = a_id[pk];
            a_ex[pk] = 1;
          }
          ctl[k] = u;
          if (VT > 0) vlog[(it * E + k) % VT] = u;
        }
        ctl[2] = found;
        ctl[3] = 0;
      }
    } else {
      for (int i = tid - 32; i < T; i += kThreads - 32) {
        key[i] = kEmpty;
        for (int k = 0; k < E; ++k) lanes[k * T + i] = kNoLane;
      }
    }
    __syncthreads();
    if (ctl[2] == 0) {
      // the reference's remaining hops log the sentinel
      hops = it;
      const long rest = (long)(p.max_iters - it - 1) * E;
      const int n_rest = rest < VT ? (int)rest : VT;
      for (int i = tid; i < n_rest; i += kThreads)
        vlog[(int)(((long)(it + 1) * E + i) % VT)] = sentinel;
      break;
    }

    // ---- 2. the records by cp.async (waited for after admission); each
    //         lane's id into the table ----
    {
      const int rec_vec = CPW / 4;
      for (int i = tid; i < E * rec_vec; i += kThreads) {
        const int k = i / rec_vec, j = i - k * rec_vec;
        cp_async16(rec + k * CPW + j * 4,
                   p.rec + (int64_t)ctl[k] * CPW + j * 4);
      }
    }
    int32_t my_id = sentinel;
    int slot = -1;
    if (has_lane) {
      my_id = __ldg(p.rec + (int64_t)ctl[t] * CPW + c);
      if (my_id != sentinel) {
        slot = table_insert(key, my_id, tshift, tmask);
        atomicMin(&lanes[t * T + slot], c);
      }
    }
    __syncthreads();

    // ---- 3. probe the table with the beam ids and the ring ids ----
    for (int i = tid; i < L; i += kThreads) {
      const int32_t id = a_id[i];
      if (id != sentinel) mark(key, lanes, id, kInBeam, tshift, tmask);
    }
    for (int k = 0; k < E; ++k) {
      const int4* rg = reinterpret_cast<const int4*>(ring + k * Vs);
      int* w = lanes + k * T;
      for (int j = tid; j < Vs / 4; j += kThreads) {
        const int4 v = rg[j];
        if (v.x >= 0) mark(key, w, v.x, kInRing, tshift, tmask);
        if (v.y >= 0) mark(key, w, v.y, kInRing, tshift, tmask);
        if (v.z >= 0) mark(key, w, v.z, kInRing, tshift, tmask);
        if (v.w >= 0) mark(key, w, v.w, kInRing, tshift, tmask);
      }
    }
    __syncthreads();

    // ---- 4. admission, ring shift, the admitted lanes listed ----
    bool valid = false;
    if (slot >= 0 && my_id != excl) {
      const int wt = lanes[t * T + slot], w0 = lanes[slot];
      valid = (wt & 0xFFFF) == c && !(wt & kInRing) && !(w0 & kInBeam) &&
              (t == 0 || (w0 & 0xFFFF) == kNoLane);
    }
    head = (head - kLanes + V) % V;
    if (tid < C) {
      ring[t * Vs + (head + c) % V] = valid ? my_id : -1;
      cand_sc[tid] = NEG_INF;
      cand_id[tid] = valid ? my_id : sentinel;
    }
    {
      const unsigned vb = __ballot_sync(0xffffffffu, valid);
      int base = 0;
      if (lane == 0 && vb) base = atomicAdd(&ctl[3], __popc(vb));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (valid) adm[base + __popc(vb & ((1u << lane) - 1))] = tid;
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 5. ADC scores of the admitted lanes, one thread each ----
    for (int k = tid; k < ctl[3]; k += kThreads) {
      const int ln = adm[k];
      const int i = ln & (kLanes - 1);
      const int32_t* rw = rec + (ln >> 7) * CPW + i / cpl;
      const int sh = (i % cpl) * p.BITS;
      float acc = 0.f;
      for (int j = 0; j < M; ++j) {
        const uint32_t code = ((uint32_t)rw[p.slot[j]] >> sh) & cmask;
        acc = __fadd_rn(acc, code < (uint32_t)KSUB ? lut[j * KSUB + code]
                                                   : 0.f);
      }
      cand_sc[ln] = wide ? bf16_round(acc) : acc;
    }
    __syncthreads();

    // ---- 6. merge [beam(L) | candidates | pad] in registers; the next
    //         beam takes the first L outputs, the rest die ----
    float sc[EPT];
    int pos[EPT];
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int i = tid * EPT + r;
      sc[r] = i < L ? a_sc[i] : i < L + C ? cand_sc[i - L] : NEG_INF;
      pos[r] = i;
    }
    network<EPT>(sc, pos, xbuf);
    float* n_sc = beam + (cur ^ 1) * 3 * L;
    int32_t* n_id = reinterpret_cast<int32_t*>(n_sc + L);
    int32_t* n_ex = n_id + L;
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int f = tid * EPT + r, q = pos[r];
      if (f < L) {
        n_sc[f] = sc[r];
        n_id[f] = q < L ? a_id[q] : q < L + C ? cand_id[q - L] : sentinel;
        n_ex[f] = q < L ? a_ex[q] : 0;
      }
    }
    cur ^= 1;
    __syncthreads();
  }
  __syncthreads();  // the sentinel writes of a query that stopped early

  const float* a_sc = beam + cur * 3 * L;
  const int32_t* a_id = reinterpret_cast<const int32_t*>(a_sc + L);
  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[(size_t)b * L + i] = a_id[i];
    p.out_sc[(size_t)b * L + i] = a_sc[i];
  }
  for (int i = tid; i < VT; i += kThreads)
    p.vlog[(size_t)b * VT + i] = vlog[i];
  if (tid == 0) p.hops[b] = hops;
}

inline size_t settle_smem_bytes(int L, int P2) {
  return align16((size_t)4 * L * 4) + (size_t)2 * P2 * 8;
}

// The empty merges of a converged query whose group was still active:
// (max active hops of the group) - (its own), each the network over
// [beam(L) | (-inf, sentinel) ...], entries past L dying. On an ordinary
// beam (live prefix non-increasing, then (-inf, sentinel) entries) they
// are pi^idle on the live prefix, pi being the network's permutation of
// this score sequence; without a tie pi is the identity.
template <int EPT>
__global__ void __launch_bounds__(kThreads)
pq_settle_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = p.L;
  const int32_t sentinel = p.n_sentinel;
  const float NEG_INF = __int_as_float(0xff800000);
  const int g0 = (b / p.qb) * p.qb;
  const int g1 = min(p.B, g0 + p.qb);
  int group_hops = 0;
  for (int q = g0; q < g1; ++q) group_hops = max(group_hops, p.hops[q]);
  const int idle = group_hops - p.hops[b];
  if (idle <= 0) return;

  __shared__ int n_live;  // the first -inf position of an ordinary beam
  float* sc = reinterpret_cast<float*>(smem);                  // [L]
  int32_t* id = reinterpret_cast<int32_t*>(sc + L);            // [L]
  int32_t* perm = id + L;                                      // [2, L]
  uint2* xbuf = reinterpret_cast<uint2*>(
      smem + align16((size_t)4 * L * 4));                      // [2, P2]
  if (tid == 0) n_live = L;
  for (int i = tid; i < L; i += kThreads) {
    sc[i] = p.out_sc[(size_t)b * L + i];
    id[i] = p.out_ids[(size_t)b * L + i];
  }
  __syncthreads();
  bool tie = false, odd = false;
  for (int i = tid; i < L; i += kThreads) {
    const float s = sc[i];
    if (s == NEG_INF) {
      odd |= id[i] != sentinel;
      atomicMin(&n_live, i);
    } else if (i > 0) {
      odd |= !(sc[i - 1] >= s);    // also a live entry after a -inf one
      tie |= sc[i - 1] == s;
    }
  }
  odd = __syncthreads_or(odd);
  if (!__syncthreads_or(tie) && !odd) return;

  float s[EPT];
  int q[EPT];
  if (odd) {
    // one empty merge after another, as the group's program takes them
    for (int n = 0; n < idle; ++n) {
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const int i = tid * EPT + r;
        s[r] = i < L ? sc[i] : NEG_INF;
        q[r] = i;
      }
      network<EPT>(s, q, xbuf);
      int32_t nid[EPT];
#pragma unroll
      for (int r = 0; r < EPT; ++r) nid[r] = q[r] < L ? id[q[r]] : sentinel;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < EPT; ++r) {
        const int f = tid * EPT + r;
        if (f < L) {
          sc[f] = s[r];
          id[f] = nid[r];
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < L; i += kThreads) {
      p.out_ids[(size_t)b * L + i] = id[i];
      p.out_sc[(size_t)b * L + i] = sc[i];
    }
    return;
  }

  // pi on the live prefix [0, nl), which it maps onto itself: output
  // position f takes input position perm[f]
  const int nl = n_live;
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int i = tid * EPT + r;
    s[r] = i < L ? sc[i] : NEG_INF;
    q[r] = i;
  }
  network<EPT>(s, q, xbuf);
#pragma unroll
  for (int r = 0; r < EPT; ++r)
    if (tid * EPT + r < nl) perm[tid * EPT + r] = q[r];
  __syncthreads();
  // pi^idle by squaring: acc[f] = pi^(the bits of idle done so far)[f]
  int acc[EPT];
#pragma unroll
  for (int r = 0; r < EPT; ++r) acc[r] = tid * EPT + r;
  int turn = 0;
  for (int n = idle; n > 0; n >>= 1) {
    const int32_t* base = perm + turn * L;
    if (n & 1) {
#pragma unroll
      for (int r = 0; r < EPT; ++r)
        if (acc[r] < nl) acc[r] = base[acc[r]];
    }
    if (n > 1) {
      int32_t* next = perm + (turn ^ 1) * L;
      for (int i = tid; i < nl; i += kThreads) next[i] = base[base[i]];
      turn ^= 1;
      __syncthreads();
    }
  }
  // entries past the live prefix stay (-inf, sentinel)
#pragma unroll
  for (int r = 0; r < EPT; ++r) {
    const int f = tid * EPT + r;
    if (f < nl) {
      p.out_ids[(size_t)b * L + f] = id[acc[r]];
      p.out_sc[(size_t)b * L + f] = sc[acc[r]];
    }
  }
}

template <int EPT>
inline void kernels_of(void** trav, void** settle) {
  *trav = reinterpret_cast<void*>(&pq_beam_kernel<EPT>);
  *settle = reinterpret_cast<void*>(&pq_settle_kernel<EPT>);
}

// The traversal and settle kernels of sort width P2 (nulls when P2 is
// not supported).
inline void kernels_for(int P2, void** trav, void** settle) {
  *trav = *settle = nullptr;
  switch (P2) {
    case 256: kernels_of<1>(trav, settle); break;
    case 512: kernels_of<2>(trav, settle); break;
    case 1024: kernels_of<4>(trav, settle); break;
    case 2048: kernels_of<8>(trav, settle); break;
    case 4096: kernels_of<16>(trav, settle); break;
  }
}

}  // namespace

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" size_t leann_pq_beam_smem_bytes(int MK, int CP, int E, int L,
                                           int P2, int Vs, int VT) {
  return layout(MK, CP, E, L, P2, Vs, VT, table_slots(E)).total;
}

// Resident CTAs of the traversal kernel per SM at these sizes (shared
// memory, registers and threads), or -(cudaError_t) on failure.
extern "C" int leann_pq_beam_ctas_per_sm(int MK, int CP, int E, int L,
                                         int P2, int Vs, int VT) {
  void *trav, *settle;
  kernels_for(P2, &trav, &settle);
  if (!trav) return -(int)cudaErrorInvalidValue;
  const int smem = (int)leann_pq_beam_smem_bytes(MK, CP, E, L, P2, Vs, VT);
  cudaError_t err = cudaFuncSetAttribute(
      trav, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, trav, kThreads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
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
  void *trav, *settle;
  kernels_for(P2, &trav, &settle);
  if (!trav || M > kMaxM || M < 1 || E < 1 || E > 2 || R > kLanes ||
      qb < 1 || L < 1 || L + E * kLanes > P2)
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
  p.V = V;
  p.Vs = (V + 3) & ~3;
  p.VT = VT;
  p.max_iters = max_iters;
  p.qb = qb;
  p.n_sentinel = n_sentinel;
  p.T = table_slots(E);
  p.tshift = 32 - (E == 2 ? 9 : 8);
  for (int j = 0; j < M; ++j) p.slot[j] = (int16_t)slot[j];
  const size_t smem =
      leann_pq_beam_smem_bytes(M * KSUB, CP, E, L, P2, p.Vs, VT);
  const size_t smem_settle = settle_smem_bytes(L, P2);
  cudaError_t err = cudaFuncSetAttribute(
      trav, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(settle,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_settle);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {&p};
  err = cudaLaunchKernel(trav, dim3(B), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(settle, dim3(B), dim3(kThreads), args, smem_settle,
                         s);
  return (int)err;
}
