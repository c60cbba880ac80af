// IVF bucket dot products for Hopper (sm_90a): kernel B4.
//
// Replaces the TPU kernel `leann_tpu/ops/pallas_kernels.py:92`
// (`_bucket_dots_kernel`, launched by `ivf_bucket_dots` :130; the scan of
// `ivf_search_pallas`, which `IvfEngine.search_pallas` runs). It computes
//
//   out[j, b, r] = sum_d bf16(q[b, d]) * vecs[probe[b, j], r, d]
//
// for q [B, D] f32, probe [B, P] int32 and the bf16 bucket table
// vecs [K, cap, D], with float32 accumulation; out is [P, B, cap] f32.
// The caller folds in |v|^2 (l2), masks the sentinel slots and takes the
// top-k over [B, P*cap].
//
// Bound. Bytes: each probed bucket's rows (cap * D * 2 bytes) read once,
// and the output (4 * cap bytes per pair) written once; the products
// (2 * cap * D per pair) are far below the byte time. At ivf search (1M
// x 128, B = 2048, P = 8, cap 650) some 7 queries probe each bucket, so a
// grid of one CTA per (query, probe), the earlier design kept in
// `ivf_bucket_dots_pairs.cu`, read ~7x the bytes that the bound counts
// and kept one 16-byte load per thread in flight.
//
// Design: the bucket-major scan of `bucket_scan.cuh`. One CTA per item of
// the work list (one bucket, up to 32 of the queries that probe it): a
// producer warp streams the bucket's rows once through a ring of
// shared-memory tiles with bulk copies (cp.async.bulk on mbarriers), and 8
// consumer warps score every query of the item from the same tile with
// mma.sync m16n8k16 (bf16 in, float32 sums).

#include "bucket_scan.cuh"

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// skey [B * P] int32: the flattened probes' keys (K outside [0, K)),
// sorted stably; pairs [B * P] int64: their positions (b * P + j); start
// [K + 2] and items [n_items, 3] int32 scratch, n_items = ceil(B * P /
// qmax) + min(K, B * P); qmax must equal bucket_scan::qmax_for(D); vec = 1
// allows bulk copies (needs D * 2 % 16 == 0 and a 16-byte aligned
// table), vec = 0 single elements. Launches the items kernel, then the
// scan, on `stream`.
extern "C" int leann_ivf_bucket_dots(const float* q, const int32_t* skey,
                                     const long long* pairs, int32_t* start,
                                     int32_t* items,
                                     const __nv_bfloat16* vecs, float* out,
                                     int B, int P, int K, int cap, int D,
                                     int n_items, int qmax, int vec,
                                     void* stream) {
  bucket_scan::Args a = {};
  a.q = q; a.pairs = pairs; a.rows = vecs; a.out = out;
  a.B = B; a.P = P; a.K = K; a.cap = cap; a.D = D;
  return bucket_scan::launch<false>(a, skey, start, items, n_items, qmax, vec,
                                    stream);
}

extern "C" int leann_ivf_bucket_dots_ctas_per_sm(int D) {
  return bucket_scan::ctas_per_sm<false>(D);
}
