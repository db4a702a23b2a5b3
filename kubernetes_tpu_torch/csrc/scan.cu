// The sequential-greedy scan of one chunk of pods in ONE launch.
//
// Replaces, on the card, the per-step launches of the JAX package's
// Pallas select (kubernetes_tpu/engine/fused.py:_pallas_kernel, via
// select_pallas) and the XLA scan body around it
// (kubernetes_tpu/engine/solver.py:_fused_scan, the `step` closure).  It
// runs the P dependent steps of the port's step loop
// (kubernetes_tpu_torch/engine/solver.py:Solver._fused_scan) for the
// `mixed` family set, decision- and bit-identical to that loop:
//
//   dynamic PodFitsResources; LeastRequested, MostRequested and
//   BalancedResourceAllocation, template-factored (a carried [T, N]
//   plane D) or computed in the step; selector/service spread from
//   carried per-group maxima, with the zone blend; the round-robin
//   counter.
//
// For each pod i, in order:
//   1. widen the encoded row enc[i, :] (f32 or f16; -inf marks a node
//      that is statically infeasible) to f32;
//   2. add D[tmpl[i], :], then each dynamic priority in the step loop's
//      order (acc + w * plane; the multiply is skipped when w == 1);
//   3. fold dynamic PodFitsResources into -inf;
//   4. selectHost (the body of csrc/select.cu): max, ties when the max is
//      finite (a NaN anywhere gives none), ix = (uint32) counter %
//      max(n, 1), the ix-th tie in node order or -1;
//   5. when placed at j: packed[j] += [request, nonzero]; recompute
//      D[:, j]; sp_node[:, j] += incr and fold sp_maxn; the zone column
//      and sp_maxz when node j has a zone;
//   6. bump the counter when there were ties.
// Pad rows are -inf everywhere: they place nothing and bump nothing.
// The carried state is updated in place; `choices` gets one int32 per
// pod and `counter` the final value (low 32 bits, as a uint32).
//
// Exactness: every f32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), the library is built
// with --fmad=false besides, and no fast math.  Constants are the f32
// roundings of the step loop's Python constants.  Integer priorities
// keep int32 wrap-around and floor division (ops/priorities.py).
//
// Bound.  Per chunk the kernel must read enc once (P x N x 4 bytes in
// f32: 2,048 x 5,000 x 4 = 41 MB at the north star) and the carried
// state once and write it once (packed, D, the spread planes: about
// 1 MB), about 12.5 us at 3.35 TB/s.  Its real limit is elsewhere: the
// steps are serially dependent, so one CTA runs them all, and each step
// is a serial chain -- the per-node work of K nodes per thread, one
// block barrier for the pick, two more when a pod is placed -- on one
// SM.  (Measured on an H100 with perf/scan_ablation.py: the per-node
// work, not the barriers, takes most of the step.)  What the design
// does about it:
//
//   * one CTA of up to 1,024 threads; each warp owns a contiguous run of
//     32 * K nodes, lane l the nodes l, l + 32, ... of it (loads stay
//     coalesced, and the tie rank is in node order: warps in order,
//     rounds in order, lanes in order);
//   * the block max and the tie count are ONE barrier: each warp
//     publishes (its max, its ties at that max, a NaN flag) and every
//     warp reduces the published values itself with shuffles, so every
//     thread learns the maximum, the tie total and its warp's offset at
//     once; the warp holding the ix-th tie finds it with ballots;
//   * the step's scores stay in registers (K per thread), and the next
//     pod's enc values are loaded into registers while the current step
//     runs, so the HBM read of enc is off the serial chain; no dynamic
//     shared memory is needed (under 1 KB of static shared memory);
//   * the commit is spread over threads: the picking lane adds the
//     request to packed[j], thread t recomputes D[t, j], thread s
//     updates spread group s;
//   * the published per-warp values are double-buffered, so a step that
//     places nothing needs no barrier after the pick.
//
// The small carried state (packed, D, sp_node, the maxima) lives in
// device memory and stays in the SM's L1 and the L2: only this CTA
// touches it.  Since the per-node work of K nodes per thread sets the
// step time, the next moves are cheaper per-node work (node-invariant
// data and fit state in shared memory, a per-(group, zone) spread table,
// the next pod's D and sp_node values loaded a step ahead), then a
// thread-block cluster with the node axis split over its CTAs' shared
// memory (distributed shared memory), at the cost of a cluster barrier
// per step.
//
// Limits: N <= 16,384 (K <= 16 nodes per thread at 1,024 threads),
// at most 8 dynamic priority terms.  The wrapper checks both.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Term kinds (engine/scan.py TERM_KINDS).
constexpr int kLeast = 0;
constexpr int kMost = 1;
constexpr int kBalanced = 2;
constexpr int kSpread = 3;

// f32 roundings of the step loop's Python constants.
constexpr float kNodeShare = static_cast<float>(1.0 - 2.0 / 3.0);
constexpr float kZoneShare = static_cast<float>(2.0 / 3.0);
constexpr float kClampMin = static_cast<float>(1e-9);
constexpr float kTruncEps = static_cast<float>(1e-5);

}  // namespace

// Mirrors engine/scan.py:_ScanArgs field for field.
struct ScanArgs {
  const void* enc;                    // [P, N] f32 or f16
  const int* request;                 // [P, 4]
  const int* nonzero;                 // [P, 2]
  const unsigned char* zero_request;  // [P] bool
  const int* tmpl_idx;                // [P] (templates)
  const int* templates;               // [T, 2] (templates)
  const int* spread_group;            // [P] (spread)
  const unsigned char* spread_incr;   // [P, S] bool (spread)
  const unsigned char* has_zones;     // [S] bool (zones)
  const int* node_zone;               // [N] (zones)
  const int* alloc;                   // [N, 4]
  int* packed;                        // [N, 6] carried
  float* d_plane;                     // [T, N] carried (templates)
  float* sp_node;                     // [S, N] carried (spread)
  float* sp_maxn;                     // [S] carried (spread)
  float* sp_zone;                     // [S, Z] carried (zones)
  float* sp_maxz;                     // [S] carried (zones)
  long long* counter;                 // [1] carried
  int* choices;                       // [P] out
  int p, n, t, s, z;
  int half;
  int use_resources, use_templates, track_spread, track_zones;
  int n_terms, n_tmpl_terms;
  int term_kind[kMaxTerms];
  float term_w[kMaxTerms];
  int tmpl_kind[kMaxTerms];
  float tmpl_w[kMaxTerms];
};

namespace {

// int32 arithmetic with torch's wrap-around (signed overflow is
// undefined in C++, so through uint32).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// torch's integer floor division (C's `/` truncates toward zero).  b is
// never 0 or -1 here (it is clamped to >= 1 or is 2).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.maximum: NaN propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// _trunc (ops/priorities.py): trunc(x + 1e-5).
__device__ __forceinline__ float trunc_eps(float x) {
  return truncf(__fadd_rn(x, kTruncEps));
}

// _add_weighted (engine/solver.py): acc + w * plane, no multiply at 1.
__device__ __forceinline__ float add_weighted(float acc, float w, float plane) {
  return w == 1.0f ? __fadd_rn(acc, plane)
                   : __fadd_rn(acc, __fmul_rn(w, plane));
}

// calculateUnusedScore / calculateUsedScore (ops/priorities.py).
__device__ __forceinline__ int unused_score(int req, int cap) {
  const int safe = cap < 1 ? 1 : cap;
  const int score = floordiv(wmul(wsub(cap, req), 10), safe);
  return (cap == 0 || req > cap) ? 0 : score;
}
__device__ __forceinline__ int used_score(int req, int cap) {
  const int safe = cap < 1 ? 1 : cap;
  const int score = floordiv(wmul(req, 10), safe);
  return (cap == 0 || req > cap) ? 0 : score;
}

// One resource priority at one (pod or template, node): pod nonzero
// (p0, p1), node nonzero aggregates (q0, q1), allocatable cpu and memory.
__device__ float resource_prio(int kind, int p0, int p1, int q0, int q1,
                               int cap_cpu, int cap_mem) {
  const int t0 = wadd(p0, q0);
  const int t1 = wadd(p1, q1);
  if (kind == kLeast) {
    return static_cast<float>(floordiv(
        wadd(unused_score(t0, cap_cpu), unused_score(t1, cap_mem)), 2));
  }
  if (kind == kMost) {
    return static_cast<float>(
        floordiv(wadd(used_score(t0, cap_cpu), used_score(t1, cap_mem)), 2));
  }
  // BalancedResourceAllocation.
  const float f0 = static_cast<float>(t0);
  const float f1 = static_cast<float>(t1);
  const float cc = static_cast<float>(cap_cpu);
  const float cm = static_cast<float>(cap_mem);
  const float cpu_frac = cc == 0.0f ? 1.0f : __fdiv_rn(f0, clamp_min(cc, 1.0f));
  const float mem_frac = cm == 0.0f ? 1.0f : __fdiv_rn(f1, clamp_min(cm, 1.0f));
  const float diff = fabsf(__fsub_rn(cpu_frac, mem_frac));
  const float score = trunc_eps(__fsub_rn(10.0f, __fmul_rn(diff, 10.0f)));
  return (cpu_frac >= 1.0f || mem_frac >= 1.0f) ? 0.0f : score;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename EncT>
__device__ __forceinline__ EncT load_enc(const EncT* p) { return __ldg(p); }

template <typename EncT>
__device__ __forceinline__ EncT neg_inf_enc();
template <>
__device__ __forceinline__ float neg_inf_enc<float>() { return -INFINITY; }
template <>
__device__ __forceinline__ __half neg_inf_enc<__half>() {
  return __ushort_as_half(static_cast<unsigned short>(0xFC00u));
}

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

template <int K, typename EncT>
__global__ void __launch_bounds__(kMaxThreads)
scan_chunk_kernel(const ScanArgs a) {
  // Per-warp (max, ties at that max, NaN flag), double-buffered by step
  // parity so that a step that places nothing needs no barrier after
  // its pick.
  __shared__ float s_wmax[2][kMaxWarps];
  __shared__ int s_wcnt[2][kMaxWarps];
  __shared__ int s_wnan[2][kMaxWarps];
  __shared__ int s_choice;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = a.n;
  const int wbase = warp * 32 * K;  // this warp's first node
  const EncT* enc = static_cast<const EncT*>(a.enc);

  uint32_t ctr = static_cast<uint32_t>(
      static_cast<unsigned long long>(a.counter[0]));

  EncT nxt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = wbase + 32 * k + lane;
    nxt[k] = j < n ? load_enc(enc + j) : neg_inf_enc<EncT>();
  }

  for (int i = 0; i < a.p; ++i) {
    const int buf = i & 1;
    float sc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sc[k] = widen(nxt[k]);
    // Prefetch the next pod's row; it is consumed one step later.
    if (i + 1 < a.p) {
      const EncT* row = enc + static_cast<size_t>(i + 1) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = wbase + 32 * k + lane;
        if (j < n) nxt[k] = load_enc(row + j);
      }
    }

    // The pod's scalars (uniform across the block).
    const int r0 = a.request[4 * i + 0];
    const int r1 = a.request[4 * i + 1];
    const int r2 = a.request[4 * i + 2];
    const int pn0 = a.nonzero[2 * i + 0];
    const int pn1 = a.nonzero[2 * i + 1];
    const bool zero_req = a.zero_request[i] != 0;
    const float* d_row =
        a.use_templates ? a.d_plane + static_cast<size_t>(a.tmpl_idx[i]) * n
                        : nullptr;
    int g = 0;
    float maxn = 0.0f, maxz = 0.0f;
    bool g_zones = false;
    if (a.track_spread) {
      g = a.spread_group[i];
      maxn = a.sp_maxn[g];
      if (a.track_zones) {
        maxz = a.sp_maxz[g];
        g_zones = a.has_zones[g] != 0;
      }
    }

    // 1-3. Scores of this thread's nodes.
    float tmax = -INFINITY;
    int tnan = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = wbase + 32 * k + lane;
      if (j >= n) continue;  // sc[k] stays -inf
      float acc = sc[k];
      if (d_row != nullptr) acc = __fadd_rn(acc, d_row[j]);
      const int* pk = a.packed + 6 * j;
      const int* al = a.alloc + 4 * j;
      for (int q = 0; q < a.n_terms; ++q) {
        const int kind = a.term_kind[q];
        float plane;
        if (kind == kSpread) {
          const float cnt = a.sp_node[static_cast<size_t>(g) * n + j];
          float fsc = 10.0f;
          if (maxn > 0.0f) {
            fsc = __fmul_rn(10.0f, __fdiv_rn(__fsub_rn(maxn, cnt),
                                             clamp_min(maxn, kClampMin)));
          }
          if (a.track_zones) {
            const int zj = __ldg(a.node_zone + j);
            const bool node_zone = zj >= 0;
            const float zcl = clamp_min(maxz, kClampMin);
            // A node without a zone scores 10 * (maxz / maxz).
            const float zdiff =
                node_zone ? __fsub_rn(maxz, a.sp_zone[g * a.z + zj]) : maxz;
            const float zs_n = __fmul_rn(10.0f, __fdiv_rn(zdiff, zcl));
            const float blended = __fadd_rn(__fmul_rn(fsc, kNodeShare),
                                            __fmul_rn(kZoneShare, zs_n));
            if (g_zones && node_zone && maxz > 0.0f) fsc = blended;
          }
          plane = trunc_eps(fsc);
        } else {
          plane = resource_prio(kind, pn0, pn1, pk[4], pk[5], __ldg(al + 0),
                                __ldg(al + 1));
        }
        acc = add_weighted(acc, a.term_w[q], plane);
      }
      if (a.use_resources) {
        const bool fits_pods = wadd(pk[3], 1) <= __ldg(al + 3);
        const bool fits_res = r0 <= wsub(__ldg(al + 0), pk[0]) &&
                              r1 <= wsub(__ldg(al + 1), pk[1]) &&
                              r2 <= wsub(__ldg(al + 2), pk[2]);
        if (!(fits_pods && (zero_req || fits_res))) acc = -INFINITY;
      }
      sc[k] = acc;
      tnan |= acc != acc;
      tmax = acc > tmax ? acc : tmax;
    }

    // 4. selectHost.  Each warp publishes its max, its ties at that max
    // and a NaN flag ...
    const float wm = warp_max(tmax);
    const int wnan = __any_sync(kFull, tnan);
    int wc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) wc += __popc(__ballot_sync(kFull, sc[k] == wm));
    if (lane == 0) {
      s_wmax[buf][warp] = wm;
      s_wcnt[buf][warp] = wc;
      s_wnan[buf][warp] = wnan;
    }
    __syncthreads();
    // ... and every warp reduces them: the block max, the tie total and
    // this warp's offset among the ties.
    const float m = lane < nwarps ? s_wmax[buf][lane] : -INFINITY;
    const int cnt = lane < nwarps ? s_wcnt[buf][lane] : 0;
    const int any_nan = __any_sync(kFull, lane < nwarps && s_wnan[buf][lane]);
    const float mx = warp_max(m);
    const bool finite = !any_nan && isfinite(mx);
    const int c_eff = (finite && m == mx) ? cnt : 0;
    const int incl = warp_inclusive_sum(c_eff, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    const int my_off = __shfl_sync(kFull, incl - c_eff, warp);
    const int my_cnt = __shfl_sync(kFull, c_eff, warp);
    const uint32_t ix = total > 0 ? ctr % static_cast<uint32_t>(total) : 0u;

    if (total == 0) {
      if (threadIdx.x == 0) a.choices[i] = -1;
      continue;
    }
    if (my_cnt > 0 && ix >= static_cast<uint32_t>(my_off) &&
        ix < static_cast<uint32_t>(my_off + my_cnt)) {
      // This warp holds the pick: walk its rounds in node order.
      int want = static_cast<int>(ix) - my_off;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool tie = sc[k] == mx;
        const unsigned b = __ballot_sync(kFull, tie);
        const int c = __popc(b);
        if (want >= 0 && want < c) {
          if (tie && __popc(b & ((1u << lane) - 1u)) == want) {
            const int j = wbase + 32 * k + lane;
            s_choice = j;
            a.choices[i] = j;
            int* pk = a.packed + 6 * j;
            pk[0] = wadd(pk[0], a.request[4 * i + 0]);
            pk[1] = wadd(pk[1], a.request[4 * i + 1]);
            pk[2] = wadd(pk[2], a.request[4 * i + 2]);
            pk[3] = wadd(pk[3], a.request[4 * i + 3]);
            pk[4] = wadd(pk[4], pn0);
            pk[5] = wadd(pk[5], pn1);
          }
          want = -1;
        } else if (want >= 0) {
          want -= c;
        }
      }
    }
    __syncthreads();

    // 5. Commit at j (packed[j] is already updated).
    const int j = s_choice;
    if (a.use_templates) {
      const int q0 = a.packed[6 * j + 4];
      const int q1 = a.packed[6 * j + 5];
      const int cap_cpu = __ldg(a.alloc + 4 * j + 0);
      const int cap_mem = __ldg(a.alloc + 4 * j + 1);
      for (int t = threadIdx.x; t < a.t; t += blockDim.x) {
        const int p0 = a.templates[2 * t + 0];
        const int p1 = a.templates[2 * t + 1];
        float col = 0.0f;
        for (int q = 0; q < a.n_tmpl_terms; ++q) {
          col = add_weighted(col, a.tmpl_w[q],
                             resource_prio(a.tmpl_kind[q], p0, p1, q0, q1,
                                           cap_cpu, cap_mem));
        }
        a.d_plane[static_cast<size_t>(t) * n + j] = col;
      }
    }
    if (a.track_spread) {
      const int zj = a.track_zones ? __ldg(a.node_zone + j) : -1;
      const int zc = zj < 0 ? 0 : zj;
      for (int s = threadIdx.x; s < a.s; s += blockDim.x) {
        const bool incr = a.spread_incr[static_cast<size_t>(i) * a.s + s];
        const float inc = incr ? 1.0f : 0.0f;
        float* col = a.sp_node + static_cast<size_t>(s) * n + j;
        const float nv = __fadd_rn(*col, inc);
        *col = nv;
        a.sp_maxn[s] = nan_max(a.sp_maxn[s], nv);
        if (a.track_zones) {
          // As the step loop: the clamped zone column takes inc * 0 when
          // the node has no zone, and the maximum moves only when it has.
          float* zcol = a.sp_zone + s * a.z + zc;
          const float zv = __fadd_rn(*zcol, zj >= 0 ? inc : 0.0f);
          *zcol = zv;
          if (zj >= 0) a.sp_maxz[s] = nan_max(a.sp_maxz[s], zv);
        }
      }
    }
    // 6. The counter.
    ++ctr;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.counter[0] = static_cast<long long>(ctr);
  }
}

template <int K>
cudaError_t launch_k(const ScanArgs& a, int threads, cudaStream_t stream) {
  if (a.half) {
    scan_chunk_kernel<K, __half><<<1, threads, 0, stream>>>(a);
  } else {
    scan_chunk_kernel<K, float><<<1, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Nodes per thread the kernel is instantiated for; the launch takes the
// smallest that covers N with at most 1,024 threads.
#define KT_SCAN_KS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(12) X(16)

// One chunk: `args` as engine/scan.py fills it.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kt_scan_chunk(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.p <= 0 || a.n <= 0 || a.n > 16 * kMaxThreads ||
      a.n_terms > kMaxTerms || a.n_tmpl_terms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int need = (a.n + kMaxThreads - 1) / kMaxThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_SCAN_CASE(KV)                                   \
  if (need <= KV) {                                        \
    const int warps = (a.n + 32 * KV - 1) / (32 * KV);     \
    return static_cast<int>(launch_k<KV>(a, 32 * warps, st)); \
  }
  KT_SCAN_KS(KT_SCAN_CASE)
#undef KT_SCAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
