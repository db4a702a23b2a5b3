// The sequential-greedy scan of one chunk of pods in ONE launch.
//
// Replaces, on the card, the per-step launches of the JAX package's
// Pallas select (kubernetes_tpu/engine/fused.py:_pallas_kernel, via
// select_pallas) and the XLA scan body around it
// (kubernetes_tpu/engine/solver.py:_fused_scan, the `step` closure).  It
// runs the P dependent steps of the port's step loop
// (kubernetes_tpu_torch/engine/solver.py:Solver._fused_scan), decision-
// and bit-identical to that loop, for every family the loop carries:
//
//   mixed: dynamic PodFitsResources; LeastRequested, MostRequested and
//     BalancedResourceAllocation, template-factored (a carried [T, N]
//     plane D) or computed in the step; selector/service spread from
//     carried per-group maxima, with the zone blend; the round-robin
//     counter;
//   rich (the RICH instantiation): PodFitsHostPorts against the carried
//     ports_used; NoDiskConflict against vol_any / vol_rw; MaxEBS and
//     MaxGCE volume counts against carried per-node counts;
//     MatchInterPodAffinity (required affinity with the self-match
//     escape, required anti-affinity, existing pods' anti-affinity);
//     InterPodAffinityPriority (a 0-anchored min-max over the
//     schedulable nodes); ServiceAntiAffinityPriority; and the commit of
//     each, including the topology rows of ops/interpod.py:place_update.
//
// For each pod i, in order:
//   1. widen the encoded row enc[i, :] (f32 or f16; -inf marks a node
//      that is statically infeasible) to f32;
//   2. (rich) when the pod has inter-pod priority terms, its counts on
//      this thread's nodes and, in one barrier, their maximum and
//      minimum over the schedulable nodes;
//   3. add D[tmpl[i], :], then each dynamic priority in the step loop's
//      order (acc + w * plane; the multiply is skipped when w == 1);
//   4. fold dynamic PodFitsResources and the rich predicates into -inf;
//   5. selectHost (the body of csrc/select.cu): max, ties when the max is
//      finite (a NaN anywhere gives none), ix = (uint32) counter %
//      max(n, 1), the ix-th tie in node order or -1;
//   6. when placed at j: packed[j] += [request, nonzero]; recompute
//      D[:, j]; sp_node[:, j] += incr and fold sp_maxn; the zone column
//      and sp_maxz when node j has a zone; (rich) set the pod's port,
//      volume and disk bits in row j, bump the disk counts, add the pod
//      to the affinity rows of every node in j's topology, and to the
//      service anti-affinity counts;
//   7. bump the counter when there were ties.
// Pad rows are -inf everywhere: they place nothing and bump nothing.
// The carried state is updated in place; `choices` gets one int32 per
// pod and `counter` the final value (low 32 bits, as a uint32).
//
// Sparse term lists.  A rich family's per-pod operand is a row of a
// [P, S] bool (or weight) table, with S in the hundreds at full width
// (one affinity signature per anti-affinity replica group), while a pod
// has 0-2 set entries.  The wrapper (engine/scan.py:term_lists) turns
// each table into a per-pod list once per chunk, with torch ops on the
// card and no host sync: offsets [P + 1] and the set columns, in order.
// A step walks only its pod's entries, each over the thread's nodes,
// instead of a dense [S] x [S, N] contraction.
//
// Exactness: every f32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), the library is built
// with --fmad=false besides, and no fast math.  Constants are the f32
// roundings of the step loop's Python constants.  Integer priorities
// keep int32 wrap-around and floor division (ops/priorities.py).  The
// rich families add only sums of whole numbers: 0/1 incidences,
// integer weights and integer counts.  The disk totals are computed in
// int32 (the step loop's f32 sums of the same integers are exact below
// 2^24); the inter-pod priority counts are summed in f64, exact below
// 2^53, and rounded to f32 once, as ops/interpod.py:priority_counts
// does, so the order of the terms cannot move a bit; every carried
// count gains 1.0 by one __fadd_rn, as the step loop's add does.  A
// pod without inter-pod priority terms skips that term: its plane is
// 0.0 on every node, and adding it changes no comparison of the step.
//
// Bound.  Per chunk the kernel must read enc once (P x N x 4 bytes in
// f32: 2,048 x 5,000 x 4 = 41 MB at the north star) and the carried
// state once and write it once (packed, D, the spread planes: about
// 1 MB; the rich planes only in the rows and columns the chunk's terms
// name), about 12.5 us at 3.35 TB/s.  Its real limit is elsewhere: the
// steps are serially dependent, so one CTA runs them all, and each step
// is a serial chain -- the per-node work of K nodes per thread, one
// block barrier for the pick (two with inter-pod priority terms), two
// more when a pod is placed -- on one SM.  (Measured on an H100 with
// perf/scan_ablation.py: the per-node work, not the barriers, takes
// most of a mixed step.)  What the design does about it:
//
//   * one CTA of up to 1,024 threads; each warp owns a contiguous run of
//     32 * K nodes, lane l the nodes l, l + 32, ... of it (loads stay
//     coalesced, and the tie rank is in node order: warps in order,
//     rounds in order, lanes in order);
//   * the block max and the tie count are ONE barrier: each warp
//     publishes (its max, its ties at that max, a NaN flag) and every
//     warp reduces the published values itself with shuffles, so every
//     thread learns the maximum, the tie total and its warp's offset at
//     once; the warp holding the ix-th tie finds it with ballots; the
//     inter-pod priority's maximum and minimum are published the same
//     way, in one more barrier;
//   * the step's scores stay in registers (K per thread), and the next
//     pod's enc values are loaded into registers while the current step
//     runs, so the HBM read of enc is off the serial chain; no dynamic
//     shared memory is needed (under 2 KB of static shared memory);
//   * the rich per-node work walks each of the pod's term lists once,
//     with the thread's K node slots inside: the predicates leave a
//     bitmask of failing slots, the inter-pod counts K f64 sums, so the
//     list loads are shared by the slots and the slots' loads overlap;
//   * the commit is spread over threads: the picking lane adds the
//     request to packed[j], thread t recomputes D[t, j], thread s
//     updates spread group s, thread q sets the pod's q-th port, volume
//     or disk bit, and the whole block walks the N nodes for each
//     topology row of the placed pod;
//   * the published per-warp values are double-buffered, so a step that
//     places nothing needs no barrier after the pick;
//   * the rich code is a template parameter: the mixed instantiations
//     are the kernel as it was, with no extra registers or branches.
//
// The small carried state (packed, D, sp_node, the maxima, the rich
// planes) lives in device memory and stays in the SM's L1 and the L2:
// only this CTA touches it.  A rich step of the rich north star costs
// about twice a mixed one (17.3 against 9.1 us at 5,000 nodes on an
// H100 80GB HBM3, chip_smoke.py phase 2b): a pod matching a service
// carries up to 9 symmetric priority rows, summed over its nodes, and a
// second barrier for their maximum and minimum, and each matching row
// of a placed pod is committed over all N nodes.  Since the per-node
// work of K nodes per thread sets the step time, the next moves are
// cheaper per-node work (node-invariant data and fit state in shared
// memory, a per-(group, zone) spread table, the next pod's D, sp_node
// and term offsets loaded a step ahead, a commit that visits only the
// nodes of the placed node's domain), then a thread-block cluster with
// the node axis split over its CTAs' shared memory (distributed shared
// memory), at the cost of a cluster barrier per step.
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
constexpr int kInterPod = 4;
constexpr int kServiceAnti = 5;

// f32 roundings of the step loop's Python constants.
constexpr float kNodeShare = static_cast<float>(1.0 - 2.0 / 3.0);
constexpr float kZoneShare = static_cast<float>(2.0 / 3.0);
constexpr float kClampMin = static_cast<float>(1e-9);
constexpr float kTruncEps = static_cast<float>(1e-5);

}  // namespace

// One per-pod term list (engine/scan.py:term_lists): row i's set
// columns of a [P, S] table, in order, at idx[off[i]] .. idx[off[i+1]-1].
struct TermList {
  const int* off;  // [P + 1]
  const int* idx;  // [P * S]
};

// One disk family of MaxEBSVolumeCount / MaxGCEPDVolumeCount.
struct PdArgs {
  TermList pod;                   // the pod's volume ids [P, W]
  const int* extra;               // [P] un-dedupable new volumes
  const int* node_extra;          // [N]
  const unsigned char* node_err;  // [N] bool
  unsigned char* node;            // [N, W] bool carried
  int* count;                     // [N] set bits of each node row, carried
  int w, limit, on;
};

// The rich families' arguments (RICH instantiation only).
struct RichArgs {
  TermList ports;                    // PodFitsHostPorts: [P, Cp]
  unsigned char* ports_used;         // [N, Cp] carried
  TermList vol_rw, vol_ro;           // NoDiskConflict: [P, W]
  unsigned char* vol_any;            // [N, W] carried
  unsigned char* node_vol_rw;        // [N, W] carried
  PdArgs ebs, gce;
  TermList aff_need, anti_need;      // MatchInterPodAffinity: [P, Sm]
  TermList decl_match;               // [P, Sd]
  const unsigned char* aff_self;     // [P, Sm] bool
  const int* node_dom;               // [Kd, N] domain ids, -1 absent
  const int* match_key;              // [Sm] key row, -1 = any default
  const int* decl_key;               // [Sd]
  const int* sym_key;                // [Ss]
  float* match_cnt;                  // [Sm, N] carried
  float* match_total;                // [Sm] carried
  unsigned char* decl_reach;         // [Sd, N] bool carried
  float* sym_cnt;                    // [Ss, N] carried
  TermList match_src, decl_src;      // the placed pod's rows: [P, Sm/Sd]
  TermList sym_src;                  // [P, Ss]
  TermList pref, sym_match;          // InterPodAffinityPriority
  const float* pref_w;               // [P, Sm]
  const float* sym_w;                // [Ss]
  const unsigned char* schedulable;  // [N] bool
  const int* saa_group;              // ServiceAntiAffinityPriority: [P]
  TermList saa_src;                  // [P, Gy]
  const int* saa_dom;                // [L, N]
  const unsigned char* saa_labeled;  // [L, N] bool
  float* saa_cnt;                    // [L, Gy, D] carried
  float* saa_num;                    // [Gy] carried
  int cp, vw, sm, sd, ss, kd, n_default, l, gy, dd;
  int use_ports, use_volumes, use_interpod, track_affinity, track_saa;
  int use_interpod_prio;
};

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
  int term_aux[kMaxTerms];            // policy-argument row (service anti)
  int rich;
  RichArgs r;
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

// -- the rich families ------------------------------------------------------

// The node slots of a thread: slot k is node wbase + 32 k + lane.
template <int K>
struct Slots {
  int base, lane, n;
  __device__ __forceinline__ int node(int k) const {
    return base + 32 * k + lane;
  }
  __device__ __forceinline__ bool live(int k) const { return node(k) < n; }
};

// MaxEBSVolumeCount / MaxGCEPDVolumeCount on the thread's slots
// (engine/solver.py: sum(node row) + node extra + new - overlap <= limit
// and no node error; a pod bringing no new volume passes).  Sets bit k
// of `bad` where slot k fails.
template <int K>
__device__ __forceinline__ void pd_mask(const PdArgs& f, int i,
                                        const Slots<K>& sl, unsigned& bad) {
  const int lo = f.pod.off[i];
  const int hi = f.pod.off[i + 1];
  const int fresh = hi - lo + f.extra[i];
  if (fresh == 0) return;
  int overlap[K];
#pragma unroll
  for (int k = 0; k < K; ++k) overlap[k] = 0;
  for (int q = lo; q < hi; ++q) {
    const int c = f.pod.idx[q];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sl.live(k)) {
        overlap[k] += f.node[static_cast<size_t>(sl.node(k)) * f.w + c] != 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!sl.live(k)) continue;
    const int j = sl.node(k);
    const int total = f.count[j] + f.node_extra[j] + fresh - overlap[k];
    if (!(total <= f.limit && !f.node_err[j])) bad |= 1u << k;
  }
}

// A node-major [N, W] bool plane tested at the listed columns of pod i:
// bit k of `bad` where slot k has any of them set.
template <int K>
__device__ __forceinline__ void column_mask(const TermList& t,
                                            const unsigned char* plane,
                                            int w, int i, const Slots<K>& sl,
                                            unsigned& bad) {
  for (int q = t.off[i]; q < t.off[i + 1]; ++q) {
    const int c = t.idx[q];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sl.live(k) && plane[static_cast<size_t>(sl.node(k)) * w + c]) {
        bad |= 1u << k;
      }
    }
  }
}

// The rich predicates of pod i on the thread's slots, each term list
// walked once with all K slots inside: bit k set where slot k fails.
template <int K>
__device__ __forceinline__ unsigned rich_mask(const RichArgs& r, int i,
                                              const Slots<K>& sl) {
  unsigned bad = 0;
  const int n = sl.n;
  if (r.use_ports) column_mask(r.ports, r.ports_used, r.cp, i, sl, bad);
  if (r.use_volumes) {
    column_mask(r.vol_rw, r.vol_any, r.vw, i, sl, bad);
    column_mask(r.vol_ro, r.node_vol_rw, r.vw, i, sl, bad);
  }
  if (r.ebs.on) pd_mask(r.ebs, i, sl, bad);
  if (r.gce.on) pd_mask(r.gce, i, sl, bad);
  if (r.use_interpod) {
    // ops/interpod.py:predicate_mask: a required term is live unless it
    // matches the pod itself and nothing matches it yet.
    for (int q = r.aff_need.off[i]; q < r.aff_need.off[i + 1]; ++q) {
      const int s = r.aff_need.idx[q];
      if (r.aff_self[static_cast<size_t>(i) * r.sm + s] &&
          r.match_total[s] == 0.0f) {
        continue;
      }
      const float* row = r.match_cnt + static_cast<size_t>(s) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl.live(k) && !(row[sl.node(k)] > 0.0f)) bad |= 1u << k;
      }
    }
    for (int q = r.anti_need.off[i]; q < r.anti_need.off[i + 1]; ++q) {
      const float* row =
          r.match_cnt + static_cast<size_t>(r.anti_need.idx[q]) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl.live(k) && row[sl.node(k)] > 0.0f) bad |= 1u << k;
      }
    }
    for (int q = r.decl_match.off[i]; q < r.decl_match.off[i + 1]; ++q) {
      const unsigned char* row =
          r.decl_reach + static_cast<size_t>(r.decl_match.idx[q]) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl.live(k) && row[sl.node(k)]) bad |= 1u << k;
      }
    }
  }
  return bad;
}

// ops/interpod.py:priority_counts of pod i on the thread's slots: the
// pod's preferred weights against the matching pods, plus the symmetric
// terms, summed exactly in f64 and rounded once.
template <int K>
__device__ __forceinline__ void interpod_counts(const RichArgs& r, int i,
                                                const Slots<K>& sl,
                                                float* out) {
  const int n = sl.n;
  double c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0.0;
  for (int q = r.pref.off[i]; q < r.pref.off[i + 1]; ++q) {
    const int s = r.pref.idx[q];
    const double w = r.pref_w[static_cast<size_t>(i) * r.sm + s];
    const float* row = r.match_cnt + static_cast<size_t>(s) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sl.live(k)) {
        c[k] = __dadd_rn(c[k], __dmul_rn(w, row[sl.node(k)]));
      }
    }
  }
  for (int q = r.sym_match.off[i]; q < r.sym_match.off[i + 1]; ++q) {
    const int s = r.sym_match.idx[q];
    const double w = r.sym_w[s];
    const float* row = r.sym_cnt + static_cast<size_t>(s) * n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sl.live(k)) {
        c[k] = __dadd_rn(c[k], __dmul_rn(w, row[sl.node(k)]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = __double2float_rn(c[k]);
}

// engine/solver.py:saa_plane at node j for label row l and service
// group gy with peer total num.
__device__ __forceinline__ float saa_score(const RichArgs& r, int l, int gy,
                                           float num, int j, int n) {
  const size_t at = static_cast<size_t>(l) * n + j;
  if (!r.saa_labeled[at]) return 0.0f;
  if (!(num > 0.0f)) return 10.0f;
  const float per =
      r.saa_cnt[(static_cast<size_t>(l) * r.gy + gy) * r.dd + r.saa_dom[at]];
  return trunc_eps(__fdiv_rn(__fmul_rn(10.0f, __fsub_rn(num, per)),
                             clamp_min(num, 1.0f)));
}

// ops/interpod.py:topo_rows: is node x in the same topology as node j
// under key row `key` (-1: any default failure-domain key)?
__device__ __forceinline__ bool same_topology(const RichArgs& r, int n,
                                              int key, int x, int j) {
  if (key >= 0) {
    const int* row = r.node_dom + static_cast<size_t>(key) * n;
    const int dx = row[x];
    return dx >= 0 && dx == row[j];
  }
  for (int d = 0; d < r.n_default; ++d) {
    const int* row = r.node_dom + static_cast<size_t>(d) * n;
    const int dx = row[x];
    if (dx >= 0 && dx == row[j]) return true;
  }
  return false;
}

// Topology rows of the placed pod's terms in `src`, over all nodes:
// counts gain 1.0 (match_cnt, sym_cnt) or reach is set (decl_reach).
__device__ void commit_rows(const RichArgs& r, const TermList& src,
                            const int* keys, float* cnt,
                            unsigned char* reach, int i, int j, int n) {
  for (int q = src.off[i]; q < src.off[i + 1]; ++q) {
    const int s = src.idx[q];
    const int key = keys[s];
    const size_t row = static_cast<size_t>(s) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      if (!same_topology(r, n, key, x, j)) continue;
      if (cnt != nullptr) cnt[row + x] = __fadd_rn(cnt[row + x], 1.0f);
      if (reach != nullptr) reach[row + x] = 1;
    }
  }
}

// The pod's new disks in row j, one thread per disk; the row's count
// gains one per bit that was not set.
__device__ __forceinline__ void pd_commit(const PdArgs& pd, int i, int j) {
  unsigned char* row = pd.node + static_cast<size_t>(j) * pd.w;
  for (int q = pd.pod.off[i] + threadIdx.x; q < pd.pod.off[i + 1];
       q += blockDim.x) {
    unsigned char* bit = row + pd.pod.idx[q];
    if (!*bit) {
      *bit = 1;
      atomicAdd(pd.count + j, 1);
    }
  }
}

// The rich commit of pod i at node j, spread over the block.
__device__ __forceinline__ void rich_commit(const RichArgs& r, int i, int j,
                                            int n) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  if (r.use_ports) {
    unsigned char* used = r.ports_used + static_cast<size_t>(j) * r.cp;
    for (int q = r.ports.off[i] + t; q < r.ports.off[i + 1]; q += nt) {
      used[r.ports.idx[q]] = 1;
    }
  }
  if (r.use_volumes) {
    const size_t row = static_cast<size_t>(j) * r.vw;
    for (int q = r.vol_rw.off[i] + t; q < r.vol_rw.off[i + 1]; q += nt) {
      r.vol_any[row + r.vol_rw.idx[q]] = 1;
      r.node_vol_rw[row + r.vol_rw.idx[q]] = 1;
    }
    for (int q = r.vol_ro.off[i] + t; q < r.vol_ro.off[i + 1]; q += nt) {
      r.vol_any[row + r.vol_ro.idx[q]] = 1;
    }
  }
  if (r.ebs.on) pd_commit(r.ebs, i, j);
  if (r.gce.on) pd_commit(r.gce, i, j);
  if (r.track_affinity) {
    for (int q = r.match_src.off[i] + t; q < r.match_src.off[i + 1];
         q += nt) {
      const int s = r.match_src.idx[q];
      r.match_total[s] = __fadd_rn(r.match_total[s], 1.0f);
    }
    commit_rows(r, r.match_src, r.match_key, r.match_cnt, nullptr, i, j, n);
    commit_rows(r, r.decl_src, r.decl_key, nullptr, r.decl_reach, i, j, n);
    commit_rows(r, r.sym_src, r.sym_key, r.sym_cnt, nullptr, i, j, n);
  }
  if (r.track_saa) {
    for (int q = r.saa_src.off[i] + t; q < r.saa_src.off[i + 1]; q += nt) {
      const int g = r.saa_src.idx[q];
      r.saa_num[g] = __fadd_rn(r.saa_num[g], 1.0f);
      for (int l = 0; l < r.l; ++l) {
        const size_t at = static_cast<size_t>(l) * n + j;
        if (!r.saa_labeled[at]) continue;
        float* c = r.saa_cnt +
                   (static_cast<size_t>(l) * r.gy + g) * r.dd + r.saa_dom[at];
        *c = __fadd_rn(*c, 1.0f);
      }
    }
  }
}

// -- the kernel -------------------------------------------------------------

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

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
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

template <int K, typename EncT, bool RICH>
__global__ void __launch_bounds__(kMaxThreads)
scan_chunk_kernel(const ScanArgs a) {
  // Per-warp (max, ties at that max, NaN flag), double-buffered by step
  // parity so that a step that places nothing needs no barrier after
  // its pick; with RICH, the inter-pod counts' (max, min) likewise.
  __shared__ float s_wmax[2][kMaxWarps];
  __shared__ int s_wcnt[2][kMaxWarps];
  __shared__ int s_wnan[2][kMaxWarps];
  __shared__ float s_cmax[2][RICH ? kMaxWarps : 1];
  __shared__ float s_cmin[2][RICH ? kMaxWarps : 1];
  __shared__ int s_choice;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = a.n;
  const int wbase = warp * 32 * K;  // this warp's first node
  const EncT* enc = static_cast<const EncT*>(a.enc);
  const RichArgs& r = a.r;

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
    int saa_g = 0;
    float saa_n = 0.0f;
    if constexpr (RICH) {
      if (r.track_saa) {
        saa_g = r.saa_group[i];
        saa_n = r.saa_num[saa_g];
      }
    }

    // 2. The inter-pod priority counts of this thread's nodes, and their
    // block max and min over the schedulable nodes (one barrier).  A pod
    // without terms has counts 0.0 everywhere, hence a 0.0 plane.
    float ipc[RICH ? K : 1] = {};
    float ip_min = 0.0f, ip_den = 0.0f;
    bool ip_on = false;
    const Slots<K> sl{wbase, lane, n};
    if constexpr (RICH) {
      if (r.use_interpod_prio) {
        ip_on = r.pref.off[i] < r.pref.off[i + 1] ||
                r.sym_match.off[i] < r.sym_match.off[i + 1];
      }
      if (ip_on) {
        interpod_counts(r, i, sl, ipc);
        float cmax = -INFINITY, cmin = INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = sl.node(k);
          if (j >= n || !r.schedulable[j]) continue;
          cmax = ipc[k] > cmax ? ipc[k] : cmax;
          cmin = ipc[k] < cmin ? ipc[k] : cmin;
        }
        cmax = warp_max(cmax);
        cmin = warp_min(cmin);
        if (lane == 0) {
          s_cmax[buf][warp] = cmax;
          s_cmin[buf][warp] = cmin;
        }
        __syncthreads();
        const float gmax =
            warp_max(lane < nwarps ? s_cmax[buf][lane] : -INFINITY);
        const float gmin =
            warp_min(lane < nwarps ? s_cmin[buf][lane] : INFINITY);
        // torch.clamp(max, min=0) and torch.clamp(min, max=0).
        const float max_c = gmax < 0.0f ? 0.0f : gmax;
        ip_min = gmin > 0.0f ? 0.0f : gmin;
        ip_den = __fsub_rn(max_c, ip_min);
      }
    }

    // The rich predicates of this thread's nodes (bit k: slot k fails).
    unsigned rich_bad = 0;
    if constexpr (RICH) rich_bad = rich_mask(r, i, sl);

    // 3-4. Scores of this thread's nodes.
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
        } else if (RICH && kind == kInterPod) {
          if (!ip_on) continue;  // a 0.0 plane
          plane = ip_den > 0.0f
                      ? trunc_eps(__fdiv_rn(
                            __fmul_rn(10.0f, __fsub_rn(ipc[RICH ? k : 0],
                                                       ip_min)),
                            clamp_min(ip_den, kClampMin)))
                      : 0.0f;
        } else if (RICH && kind == kServiceAnti) {
          plane = saa_score(r, a.term_aux[q], saa_g, saa_n, j, n);
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
      if (RICH && ((rich_bad >> k) & 1u)) acc = -INFINITY;
      sc[k] = acc;
      tnan |= acc != acc;
      tmax = acc > tmax ? acc : tmax;
    }

    // 5. selectHost.  Each warp publishes its max, its ties at that max
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

    // 6. Commit at j (packed[j] is already updated).
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
    if constexpr (RICH) rich_commit(r, i, j, n);
    // 7. The counter.
    ++ctr;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.counter[0] = static_cast<long long>(ctr);
  }
}

template <int K, bool RICH>
cudaError_t launch_kr(const ScanArgs& a, int threads, cudaStream_t stream) {
  if (a.half) {
    scan_chunk_kernel<K, __half, RICH><<<1, threads, 0, stream>>>(a);
  } else {
    scan_chunk_kernel<K, float, RICH><<<1, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const ScanArgs& a, int threads, cudaStream_t stream) {
  return a.rich ? launch_kr<K, true>(a, threads, stream)
                : launch_kr<K, false>(a, threads, stream);
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

// sizeof(ScanArgs), for the wrapper's check that its ctypes mirror has
// the same layout.
extern "C" int kt_scan_args_size() {
  return static_cast<int>(sizeof(ScanArgs));
}
