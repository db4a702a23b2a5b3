// selectHost on the card: one CTA per row.  Two entries share the
// block reductions below.
//
// kt_select_rows -- the fused select of the sequential-greedy scan.
// Replaces the Pallas kernel of the JAX package,
// kubernetes_tpu/engine/fused.py:_pallas_kernel (launched by
// select_pallas, pl.pallas_call at fused.py:86).  For each row of a
// [P, N] float32 plane (-inf marks an infeasible node) and its round-robin
// counter it computes selectHost (generic_scheduler.go:124-141):
//
//   mx     = max(row)
//   ties   = (row == mx) & isfinite(mx)
//   n      = number of ties
//   ix     = (uint32) counter % max(n, 1)
//   choice = the ix-th tie in node order, or -1 when n == 0
//
// and writes (choice, n) as int32.  A row holding a NaN has no finite
// maximum (torch.max propagates NaN), so it gives n = 0 like a +inf or
// all -inf row.
//
// kt_select_hosts -- the selectHost of the single-pod path, the JAX
// package's kubernetes_tpu/ops/combine.py:select_hosts (an XLA program
// there, not a Pallas one).  It takes a separate feasible plane and the
// per-row counter (last + feasible rows before this one, worked out by
// the wrapper), and follows that function's edge cases exactly:
//
//   masked = feasible ? score : -inf
//   mx     = max(masked), NaN if any feasible score is NaN
//   ties   = feasible & (masked == mx)     (no isfinite term: a row whose
//                                           feasible scores are all -inf
//                                           picks among them)
//   ix     = (uint32) counter % max(n, 1)
//   choice = the ix-th tie in node order; node 0 when there is no tie
//            (a NaN maximum: argmax of an all-false row); -1 when the
//            row has no feasible node
//
// Bound: a row is N x 4 bytes (plus N x 1 for the feasible plane) -- about
// 20-25 KB at the north-star N = 5,000 -- which is a few nanoseconds at the
// H100's 3.35 TB/s.  Called with P = 1 (once per scan step, or once per
// single-pod decision), both entries are bound by launch latency, not by
// bytes or operations.  The scan's fix was to inline the select into the
// persistent scan kernel (scan.cu).
//
// Design: each thread owns a contiguous segment of the node axis, so the
// tie it needs to pick lies in one thread's segment.  Block max-reduce
// (warp shuffles, then one value per warp in shared memory), a per-thread
// tie count, a block exclusive scan of the counts (which also gives n),
// then the thread whose range of tie ranks holds ix rescans its segment.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: the comparisons must be exact).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Maximum of v over the block (every thread gets it).
__device__ __forceinline__ float block_max(float v, int lane, int warp,
                                           float* s_max, float* s_mx) {
  v = warp_max(v);
  if (lane == 0) s_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? s_max[lane] : -INFINITY;
    w = warp_max(w);
    if (lane == 0) *s_mx = w;
  }
  __syncthreads();
  return *s_mx;
}

// Exclusive prefix sum of c over the block in thread order; *total gets
// the sum.
__device__ __forceinline__ int block_exclusive_scan(int c, int lane,
                                                    int warp, int* s_off,
                                                    int* s_total,
                                                    int* total) {
  const int incl = warp_inclusive_sum(c, lane);
  if (lane == 31) s_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_off[lane] : 0;
    const int vi = warp_inclusive_sum(v, lane);
    if (lane < kWarps) s_off[lane] = vi - v;
    if (lane == kWarps - 1) *s_total = vi;
  }
  __syncthreads();
  *total = *s_total;
  return s_off[warp] + incl - c;
}

// The thread whose tie ranks [excl, excl + c) hold ix writes the node of
// rank ix: its (ix - excl)-th tie, rescanning its segment [lo, hi).
template <typename IsTie>
__device__ __forceinline__ void pick_tie(uint32_t ix, int excl, int c,
                                         int lo, int hi, IsTie is_tie,
                                         int* out) {
  if (c > 0 && ix >= static_cast<uint32_t>(excl) &&
      ix < static_cast<uint32_t>(excl + c)) {
    int want = static_cast<int>(ix) - excl;
    for (int k = lo; k < hi; ++k) {
      if (is_tie(k)) {
        if (want == 0) {
          *out = k;
          return;
        }
        --want;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
select_rows_kernel(const float* __restrict__ masked,
                   const long long* __restrict__ counter,
                   int* __restrict__ out, int n) {
  __shared__ float s_max[kWarps];
  __shared__ int s_off[kWarps];
  __shared__ float s_mx;
  __shared__ int s_total;

  const int row = blockIdx.x;
  const float* x = masked + static_cast<size_t>(row) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * seg, n);
  const int hi = min(lo + seg, n);

  // 1. Row maximum.
  float m = -INFINITY;
  int has_nan = 0;
  for (int k = lo; k < hi; ++k) {
    const float v = x[k];
    has_nan |= (v != v);
    m = v > m ? v : m;
  }
  const int any_nan = __syncthreads_or(has_nan);
  const float mx = block_max(m, lane, warp, s_max, &s_mx);
  const bool finite = !any_nan && isfinite(mx);

  // 2. Ties in this thread's segment.
  int c = 0;
  if (finite) {
    for (int k = lo; k < hi; ++k) c += (x[k] == mx);
  }

  // 3. Block exclusive scan of the tie counts; the total is n.
  int total;
  const int excl = block_exclusive_scan(c, lane, warp, s_off, &s_total,
                                        &total);

  // 4. Round-robin pick among the ties (uint32 arithmetic, as the
  // reference's lastNodeIndex).
  if (total == 0) {
    if (tid == 0) {
      out[2 * row] = -1;
      out[2 * row + 1] = 0;
    }
    return;
  }
  const uint32_t ctr = static_cast<uint32_t>(
      static_cast<unsigned long long>(counter[row]));
  const uint32_t ix = ctr % static_cast<uint32_t>(total);
  if (tid == 0) out[2 * row + 1] = total;
  pick_tie(ix, excl, c, lo, hi, [&](int k) { return x[k] == mx; },
           out + 2 * row);
}

__global__ void __launch_bounds__(kThreads)
select_hosts_kernel(const float* __restrict__ scores,
                    const unsigned char* __restrict__ feasible,
                    const long long* __restrict__ counter,
                    int* __restrict__ out, int n) {
  __shared__ float s_max[kWarps];
  __shared__ int s_off[kWarps];
  __shared__ float s_mx;
  __shared__ int s_total;

  const int row = blockIdx.x;
  const float* x = scores + static_cast<size_t>(row) * n;
  const unsigned char* f = feasible + static_cast<size_t>(row) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * seg, n);
  const int hi = min(lo + seg, n);

  // 1. Maximum over the feasible scores; a feasible NaN makes it NaN.
  float m = -INFINITY;
  int has_nan = 0;
  int has_feasible = 0;
  for (int k = lo; k < hi; ++k) {
    if (f[k]) {
      const float v = x[k];
      has_feasible = 1;
      has_nan |= (v != v);
      m = v > m ? v : m;
    }
  }
  const int any_feasible = __syncthreads_or(has_feasible);
  const int any_nan = __syncthreads_or(has_nan);
  const float mx = block_max(m, lane, warp, s_max, &s_mx);

  // 2. Ties in this thread's segment: feasible nodes at mx (none when mx
  // is NaN; the -inf nodes when every feasible score is -inf).
  int c = 0;
  if (!any_nan) {
    for (int k = lo; k < hi; ++k) c += (f[k] && x[k] == mx);
  }

  // 3. Block exclusive scan of the tie counts; the total is n_ties.
  int total;
  const int excl = block_exclusive_scan(c, lane, warp, s_off, &s_total,
                                        &total);

  // 4. The ix-th tie; node 0 when there is none; -1 when nothing is
  // feasible.
  if (!any_feasible || total == 0) {
    if (tid == 0) out[row] = any_feasible ? 0 : -1;
    return;
  }
  const uint32_t ctr = static_cast<uint32_t>(
      static_cast<unsigned long long>(counter[row]));
  const uint32_t ix = ctr % static_cast<uint32_t>(total);
  pick_tie(ix, excl, c, lo, hi,
           [&](int k) { return f[k] && x[k] == mx; }, out + row);
}

}  // namespace

// masked: [rows, n] float32, contiguous; counter: [rows] int64 (the low
// 32 bits are the round-robin counter); out: [rows, 2] int32.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kt_select_rows(const float* masked, const long long* counter,
                              int* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  select_rows_kernel<<<rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(masked, counter,
                                                            out, n);
  return static_cast<int>(cudaGetLastError());
}

// scores: [rows, n] float32, feasible: [rows, n] bool (one byte each),
// counter: [rows] int64 (the low 32 bits are the row's round-robin
// counter), all contiguous; out: [rows] int32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int kt_select_hosts(const float* scores,
                               const unsigned char* feasible,
                               const long long* counter, int* out, int rows,
                               int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  select_hosts_kernel<<<rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      scores, feasible, counter, out, n);
  return static_cast<int>(cudaGetLastError());
}
