// Residual-int8 IVF bucket scan for Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel `leann_tpu/ops/pallas_kernels.py:167`
// (`_make_ivf8_kernel`, launched by `ivf8_bucket_scores` :203; the scan of
// `IvfInt8Engine` under LEANN_IVF8_PALLAS=1). For every (query b, probe
// j) with bucket c = probe[b, j] and slot r it computes
//
//   dots  = <cent[c], q[b]> + scale[c, r] * <bf16(q[b]), payload[c, r]>
//   score = 2 * dots - nsq[c, r]   (l2)   or   dots   (ip)
//   out[b, j, r] = -inf where ids[c, r] == -1, else score
//
// for q [B, D] f32, payload [K, cap, D] int8 (row residuals against the
// bucket centroid), scale / nsq [K, cap] f32, ids [K, cap] int32 and
// cent [K, D] f32; out is [B, P, cap] f32. The centroid term is a float32
// dot over the unrounded query, once per (query, bucket), as the
// reference computes it.
//
// Bound. Bytes: each probed bucket's payload (cap * D), scale, nsq and
// ids (12 * cap) and centroid (4 * D) read once, and the output (4 * cap
// per pair) written once. At ivf8 search (10M x 96, B = 2048, P = 8, cap
// 2056) some 2.5 queries probe each bucket; a grid of one CTA per (query,
// probe), the earlier design kept in `ivf8_scan_pairs.cu`, read each
// bucket once per query, converted every int8 element once per query and
// kept one 16-byte load per thread in flight.
//
// Design: the bucket-major scan of `bucket_scan.cuh`. One CTA per item of
// the work list (one bucket, up to 32 of the queries that probe it): a
// producer warp streams the bucket's payload and its scale / nsq / ids
// once through a ring of shared-memory tiles with bulk copies
// (cp.async.bulk on mbarriers); each of 8 consumer warps widens its int8 A
// fragments to fp16 once per tile (exact: a byte permute and one
// subtraction) and scores every query of the item, staged as bf16(q)
// times a power of two in fp16, with mma.sync m16n8k16 (float32 sums;
// the power of two is undone after the sum).

#include "bucket_scan.cuh"

extern "C" const char* leann_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// skey [B * P] int32: the flattened probes' keys (K outside [0, K)),
// sorted stably; pairs [B * P] int64: their positions (b * P + j); start
// [K + 2] and items [n_items, 3] int32 scratch, n_items = ceil(B * P /
// qmax) + min(K, B * P); qmax must equal bucket_scan::qmax_for(D); vec = 1
// allows bulk copies (needs D % 16 == 0 and a 16-byte aligned
// payload), vec = 0 single bytes. Launches the items kernel, then the
// scan, on `stream`.
extern "C" int leann_ivf8_bucket_scores(
    const float* q, const int32_t* skey, const long long* pairs,
    int32_t* start, int32_t* items, const int8_t* payload,
    const float* scale, const float* nsq, const int32_t* ids,
    const float* cent, float* out, int B, int P, int K, int cap, int D,
    int n_items, int qmax, int vec, int l2, void* stream) {
  bucket_scan::Args a = {};
  a.q = q; a.pairs = pairs; a.rows = payload;
  a.scale = scale; a.nsq = nsq; a.ids = ids; a.cent = cent; a.out = out;
  a.B = B; a.P = P; a.K = K; a.cap = cap; a.D = D; a.l2 = l2;
  return bucket_scan::launch<true>(a, skey, start, items, n_items, qmax, vec,
                                   stream);
}

extern "C" int leann_ivf8_bucket_scores_ctas_per_sm(int D) {
  return bucket_scan::ctas_per_sm<true>(D);
}
