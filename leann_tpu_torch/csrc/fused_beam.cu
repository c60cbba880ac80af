// Fused whole-traversal graph beam search for Hopper (sm_90a).
//
// Replaces the TPU kernel `leann_tpu/ops/fused_beam.py:_make_kernel` (with
// `_bitonic_desc` and `_first_k_unexpanded`), launched there by
// `fused_beam_search`. It computes the same best-first search, hop by hop:
//
//   state   beam (score, id, expanded flag) of L entries; seeds in [0, S)
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
//           merge: the descending bitonic sort of beam | candidates | pad
//           over P2 = next_pow2(L + E*128), lower position first on ties;
//           entries past L die
//   vlog    when VT > 0: vlog[it*E + t] = u_t (sentinel when inactive)
//   stop    no unexpanded live entry, or max_iters
//   counts  per query: the active hops, the hops merged by the bitonic
//           network, and the nodes expanded (the sum of every hop's
//           picks, the non-sentinel entries of a full visited log)
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
// Design. One CTA of 256 threads owns one query and keeps its state in
// shared memory. Every hop is a dependent round trip to device memory
// (the next nodes are known only after the merge), so the card is kept
// busy by several resident CTAs per SM, and what bounds a CTA is the
// arithmetic and the barriers of a hop. Per hop:
//   stage   the two records go to shared memory by cp.async, waited for
//           only after admission; each lane thread loads its own meta
//           (id, scale, |v|^2) into registers (the R live lanes: the
//           padding lanes are the sentinel, which no admission test passes)
//   admit   set membership, asked the other way round: the <= E*R raw
//           neighbour ids go into an open-addressed table in shared
//           memory (2*E*128 slots, keyed by atomicCAS; per row t the
//           lowest lane holding the id by atomicMin, with flag bits "in
//           the beam" and "in ring t"); then all threads probe it with the
//           L beam ids and the E*V ring ids, a few lookups each. A lane
//           is admitted by reading its own slot. (The TPU kernel's masks
//           scan the beam, the row and the whole ring per candidate: ~500
//           dependent loads per thread in a literal translation.)
//   score   only the admitted lanes (at steady state a small share of
//           E*R), one warp per four rows: lane l adds bytes 4l..4l+3 of
//           each 128-byte slice (int8 widened by byte permutes), then the
//           butterfly xor 16, 8, 4, 2, 1 of the four rows in 6 shuffles,
//           each row's additions in the butterfly's own order (the plain
//           version sums in this order)
//   merge   where no two live entries of [beam | candidates] have equal
//           scores, the descending order is unique, so any correct merge
//           gives the bitonic network's output bit for bit: each admitted
//           candidate's position is the beam entries above it (binary
//           search of the sorted beam) plus the candidates above it, each
//           beam entry's its index plus the candidates above it. Any
//           equality (-0.0 against +0.0 included), a beam that is not
//           strictly descending, or a -inf entry that is not (sentinel,
//           unexpanded) sets a CTA-wide flag, and that hop runs the
//           bitonic network over P2 as before (the "slow" merges,
//           counted per query). The settle pass relies on the same fact.
//
// Bound. Memory: per query the search must read its expanded records
// once each at 3.35 TB/s, hops * E * (R*D + 3*R*4) bytes. The hop's
// latency (one dependent fetch), its arithmetic, its 8 barriers and the
// CTAs that fit on an SM (shared memory and registers) set the pace. A
// smaller state for more CTAs per SM is later work.
//
// Record offsets are 64-bit: at N=1M, R=48, D=128 the blocks take 6.1 GB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;          // lane-padded candidates per row (RP)
constexpr int32_t kEmpty = -1;       // a free slot of the candidate table
constexpr int kNoLane = 0xFFFF;      // lane field: the id is not in the row
constexpr int kInBeam = 1 << 16;     // flag bits above the lane field
constexpr int kInRing = 1 << 17;

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
  int32_t* slow;           // [B] hops merged by the bitonic network
  int32_t* expanded;       // [B] nodes expanded per query
  int B, D, R, S, L, E, P2, V, Vs, VT, max_iters, metric_l2, n_sentinel, qb;
  int T, tshift;           // table slots (a power of two), 32 - log2(T)
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of the shared-memory pieces. `u` is one region used by
// turns in a hop: the candidate table (admission), then the next beam
// (fast merge) or the P2 sort buffer (bitonic merge).
struct Layout {
  size_t rec, qf, beam, adm, ring, u, ctl, total;
};

__host__ __device__ inline Layout layout(int D, int R, int E, int L, int P2,
                                         int Vs, int T) {
  Layout s;
  size_t off = 0;
  s.rec = off;  off = align16(off + (size_t)E * R * D);      // [E, R, D]
  s.qf = off;   off = align16(off + (size_t)D * 4);          // [D]
  s.beam = off; off = align16(off + (size_t)3 * L * 4);      // sc|id|exp [L]
  // the admitted lanes, in admission order: lane, scale bits, |v|^2 bits,
  // score (at most E*128 each)
  s.adm = off;  off = align16(off + (size_t)4 * E * kLanes * 4);
  s.ring = off; off = align16(off + (size_t)E * Vs * 4);     // [E, Vs]
  s.u = off;
  const size_t sort = (size_t)3 * P2 * 4, table = (size_t)(1 + E) * T * 4;
  off = align16(off + (sort > table ? sort : table));
  s.ctl = off;  off += 8 * 4;  // u0 u1 found n_live n_beam
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

// Byte `sel & 3` of a word of int8 values biased by 128 (w ^ 0x80808080)
// as a float, exactly: the bits of 2^23 + b + 128, less 2^23 + 128.
__device__ __forceinline__ float widen(unsigned biased, unsigned sel) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

// The butterfly sum (xor 16, 8, 4, 2, 1; each lane adds what it receives
// to what it holds) of four rows' lane partials in 6 shuffles instead of
// 20. Every row sees the butterfly's own additions in its own order, and
// a butterfly leaves the same bits in every lane, so lanes 0-7 end with
// row 0's sum, 16-23 row 1's, 8-15 row 2's and 24-31 row 3's.
__device__ __forceinline__ float reduce4(const float (&a)[4], int lane) {
  const unsigned full = 0xffffffffu;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const float r01 = (hi16 ? a[1] : a[0]) +
                    __shfl_xor_sync(full, hi16 ? a[0] : a[1], 16);
  const float r23 = (hi16 ? a[3] : a[2]) +
                    __shfl_xor_sync(full, hi16 ? a[2] : a[3], 16);
  float r = (hi8 ? r23 : r01) + __shfl_xor_sync(full, hi8 ? r01 : r23, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) r += __shfl_xor_sync(full, r, o);
  return r;
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

// The slot of `id`, or -1 when it is not in the table.
__device__ __forceinline__ int table_find(const int32_t* key, int32_t id,
                                          int tshift, int tmask) {
  int h = table_home(id, tshift);
  while (true) {
    const int32_t k = key[h];
    if (k == id) return h;
    if (k == kEmpty) return -1;
    h = (h + 1) & tmask;
  }
}

__device__ __forceinline__ void mark(const int32_t* key, int* w, int32_t id,
                                     int flag, int tshift, int tmask) {
  const int h = table_find(key, id, tshift, tmask);
  if (h >= 0) atomicOr(&w[h], flag);
}

__global__ void __launch_bounds__(kThreads)
fused_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.D, R = p.R, L = p.L, E = p.E, P2 = p.P2, V = p.V,
            Vs = p.Vs, T = p.T, tshift = p.tshift, tmask = p.T - 1;
  const int32_t sentinel = p.n_sentinel;
  const float NEG_INF = __int_as_float(0xff800000);

  const Layout lay = layout(D, R, E, L, P2, Vs, T);
  int8_t* rec = reinterpret_cast<int8_t*>(smem + lay.rec);
  float* qf = reinterpret_cast<float*>(smem + lay.qf);
  float* a_sc = reinterpret_cast<float*>(smem + lay.beam);
  int32_t* a_id = reinterpret_cast<int32_t*>(a_sc + L);
  int32_t* a_ex = a_id + L;
  int32_t* adm_lane = reinterpret_cast<int32_t*>(smem + lay.adm);
  int32_t* adm_scale = adm_lane + E * kLanes;
  int32_t* adm_nsq = adm_scale + E * kLanes;
  float* live_sc = reinterpret_cast<float*>(adm_nsq + E * kLanes);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.ring);
  int32_t* key = reinterpret_cast<int32_t*>(smem + lay.u);   // [T]
  int* lanes = reinterpret_cast<int*>(key + T);              // [E, T]
  float* s_sc = reinterpret_cast<float*>(smem + lay.u);      // [P2]
  int32_t* s_id = reinterpret_cast<int32_t*>(s_sc + P2);
  int32_t* s_ex = s_id + P2;
  int32_t* ctl = reinterpret_cast<int32_t*>(smem + lay.ctl);

  const int32_t excl = p.exclude[b];

  // ---- init: query (bf16-rounded), beam, rings, vlog ----
  for (int i = tid; i < D; i += kThreads)
    qf[i] = bf16_round(p.q[(size_t)b * D + i]);
  for (int i = tid; i < L; i += kThreads) {
    const bool seed = i < p.S;
    a_sc[i] = seed ? p.seed_sc[(size_t)b * p.S + i] : NEG_INF;
    a_id[i] = seed ? p.seed_ids[(size_t)b * p.S + i] : sentinel;
    a_ex[i] = 0;
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
  int slow = 0;
  int expanded = 0;
  const int t = tid >> 7, c = tid & (kLanes - 1);  // this thread's lane
  const bool has_lane = tid < E * kLanes && c < R;
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
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
          const int idx = it * E + k;
          if (p.VT > 0 && idx < p.VT) p.vlog[(size_t)b * p.VT + idx] = u;
        }
        ctl[2] = found;
        ctl[3] = 0;
        ctl[4] = 0;
      }
    } else {
      for (int i = tid - 32; i < T; i += kThreads - 32) {
        key[i] = kEmpty;
        for (int k = 0; k < E; ++k) lanes[k * T + i] = kNoLane;
      }
    }
    __syncthreads();
    if (ctl[2] == 0) {
      hops = it;
      break;
    }
    expanded += ctl[2];

    // ---- 2. the records by cp.async (waited for after admission); each
    //         lane's meta into registers and its id into the table ----
    {
      const int rec_vec = R * D / 16;
      for (int i = tid; i < E * rec_vec; i += kThreads) {
        const int k = i / rec_vec, j = i - k * rec_vec;
        cp_async16(rec + (size_t)k * R * D + (size_t)j * 16,
                   p.blocks + (int64_t)ctl[k] * R * D + (int64_t)j * 16);
      }
    }
    int32_t my_id = sentinel, my_scale = 0, my_nsq = 0;
    int slot = -1;
    if (has_lane) {
      const int32_t* m = p.meta + (int64_t)ctl[t] * 3 * kLanes + c;
      my_id = m[0];
      my_scale = m[kLanes];
      my_nsq = m[2 * kLanes];
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

    // ---- 4. admission, ring shift, the admitted lanes listed, beam checks ----
    bool valid = false;
    if (slot >= 0 && my_id != excl) {
      const int wt = lanes[t * T + slot], w0 = lanes[slot];
      valid = (wt & 0xFFFF) == c && !(wt & kInRing) && !(w0 & kInBeam) &&
              (t == 0 || (w0 & 0xFFFF) == kNoLane);
    }
    head = (head - kLanes + V) % V;
    if (tid < E * kLanes) ring[t * Vs + (head + c) % V] = valid ? my_id : -1;
    int my_k = 0;  // this lane's place in the admitted list
    {
      const unsigned vb = __ballot_sync(0xffffffffu, valid);
      int base = 0;
      if (lane == 0 && vb) base = atomicAdd(&ctl[3], __popc(vb));
      my_k = __shfl_sync(0xffffffffu, base, 0) +
             __popc(vb & ((1u << lane) - 1));
      if (valid) {
        adm_lane[my_k] = tid;
        adm_scale[my_k] = my_scale;
        adm_nsq[my_k] = my_nsq;
      }
    }
    // the fast merge needs a strictly descending live prefix and a tail
    // of (-inf, sentinel, unexpanded) entries; anything else is a tie
    bool tie = false;
    for (int i = tid; i < L; i += kThreads) {
      const float s = a_sc[i];
      if (s != NEG_INF) {
        if (i + 1 == L || a_sc[i + 1] == NEG_INF) ctl[4] = i + 1;
      } else {
        tie |= a_id[i] != sentinel || a_ex[i] != 0;
      }
      if (i + 1 < L && a_sc[i + 1] != NEG_INF && !(s > a_sc[i + 1]))
        tie = true;
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 5. int8 scores of the admitted lanes, one warp per four ----
    const int n_live = ctl[3], n_beam = ctl[4];
    for (int k0 = warp * 4; k0 < n_live; k0 += kThreads / 8) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k0 + k < n_live) {
          const int ln = adm_lane[k0 + k];
          const int8_t* x =
              rec + (size_t)((ln >> 7) * R + (ln & (kLanes - 1))) * D;
          for (int d0 = lane * 4; d0 < D; d0 += 128) {
            const unsigned w =
                *reinterpret_cast<const unsigned*>(x + d0) ^ 0x80808080u;
            const float4 qq = *reinterpret_cast<const float4*>(qf + d0);
            acc[k] += qq.x * widen(w, 0x7540);
            acc[k] += qq.y * widen(w, 0x7541);
            acc[k] += qq.z * widen(w, 0x7542);
            acc[k] += qq.w * widen(w, 0x7543);
          }
        }
      }
      const float dot = reduce4(acc, lane);
      const int k = k0 + (((lane >> 4) & 1) | ((lane >> 2) & 2));
      if ((lane & 7) == 0 && k < n_live) {
        const float s = __fmul_rn(dot, __int_as_float(adm_scale[k]));
        live_sc[k] = p.metric_l2
            ? __fsub_rn(__fmul_rn(2.f, s), __int_as_float(adm_nsq[k]))
            : s;
      }
    }
    __syncthreads();

    // ---- 6. ranks of the admitted candidates; any equal score -> tie ----
    float my_sc = NEG_INF;
    int my_pos = 0;
    if (valid) {
      my_sc = live_sc[my_k];
      tie |= !(my_sc > NEG_INF);
      int lo = 0, hi = n_beam;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a_sc[mid] > my_sc) lo = mid + 1;
        else hi = mid;
      }
      if (lo < n_beam && a_sc[lo] == my_sc) tie = true;
      int greater = 0, equal = 0;
      for (int k = 0; k < n_live; ++k) {
        const float v = live_sc[k];
        greater += v > my_sc;
        equal += v == my_sc;
      }
      if (equal != 1) tie = true;
      my_pos = lo + greater;
    }
    const bool tied = __syncthreads_or(tie);

    // ---- 7. merge: ranks where scores are distinct, else the network ----
    if (!tied) {
      if (valid && my_pos < L) {
        s_sc[my_pos] = my_sc;
        s_id[my_pos] = my_id;
        s_ex[my_pos] = 0;
      }
      for (int j = tid; j < n_beam; j += kThreads) {
        const float s = a_sc[j];
        int above = j;
        for (int k = 0; k < n_live; ++k) above += live_sc[k] > s;
        if (above < L) {
          s_sc[above] = s;
          s_id[above] = a_id[j];
          s_ex[above] = a_ex[j];
        }
      }
      for (int i = n_beam + n_live + tid; i < L; i += kThreads) {
        s_sc[i] = NEG_INF;
        s_id[i] = sentinel;
        s_ex[i] = 0;
      }
      __syncthreads();
    } else {
      ++slow;
      for (int i = tid; i < L; i += kThreads) {
        s_sc[i] = a_sc[i];
        s_id[i] = a_id[i];
        s_ex[i] = a_ex[i];
      }
      if (tid < E * kLanes) {
        s_sc[L + tid] = valid ? my_sc : NEG_INF;
        s_id[L + tid] = valid ? my_id : sentinel;
        s_ex[L + tid] = 0;
      }
      for (int i = L + E * kLanes + tid; i < P2; i += kThreads) {
        s_sc[i] = NEG_INF;
        s_id[i] = sentinel;
        s_ex[i] = 0;
      }
      __syncthreads();
      bitonic_desc(s_sc, s_id, s_ex, P2);
    }
    // entries past L die
    for (int i = tid; i < L; i += kThreads) {
      a_sc[i] = s_sc[i];
      a_id[i] = s_id[i];
      a_ex[i] = s_ex[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[(size_t)b * L + i] = a_id[i];
    p.out_sc[(size_t)b * L + i] = a_sc[i];
  }
  if (tid == 0) {
    p.hops[b] = hops;
    p.slow[b] = slow;
    p.expanded[b] = expanded;
  }
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

extern "C" size_t leann_fused_beam_smem_bytes(int D, int R, int E, int L,
                                              int P2, int Vs) {
  return layout(D, R, E, L, P2, Vs, table_slots(E)).total;
}

// Resident CTAs of the traversal kernel per SM at these sizes (shared
// memory, registers and threads), or -(cudaError_t) on failure.
extern "C" int leann_fused_beam_ctas_per_sm(int D, int R, int E, int L,
                                            int P2, int Vs) {
  const int smem = (int)leann_fused_beam_smem_bytes(D, R, E, L, P2, Vs);
  cudaError_t err = cudaFuncSetAttribute(
      fused_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_beam_kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the traversal (one CTA per query) and then the group settle
// pass on `stream`. Returns the first cudaError_t met (0 = both
// launched). `vlog` may be null when VT == 0.
extern "C" int leann_fused_beam_search(
    const float* q, const int8_t* blocks, const int32_t* meta,
    const int32_t* seed_ids, const float* seed_sc, const int32_t* exclude,
    int32_t* out_ids, float* out_sc, int32_t* vlog, int32_t* hops,
    int32_t* slow, int32_t* expanded, int B, int D, int R, int S, int L,
    int E, int P2, int V, int VT, int max_iters, int metric_l2,
    int n_sentinel, int qb, void* stream) {
  if (qb < 1 || E < 1 || E > 2 || R > kLanes) return (int)cudaErrorInvalidValue;
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
  p.slow = slow;
  p.expanded = expanded;
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
  p.T = table_slots(E);
  p.tshift = 32 - (E == 2 ? 9 : 8);
  const size_t smem = leann_fused_beam_smem_bytes(D, R, E, L, P2, p.Vs);
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
