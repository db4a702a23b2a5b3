// The sequential-greedy scan of one chunk of pods in ONE launch: one
// thread-block cluster whose CTAs split the node axis.
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
//      each node and their maximum and minimum over the schedulable
//      nodes;
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
// [P, S] bool (or weight) table, with S in the hundreds at full width,
// while a pod has 0-2 set entries.  The wrapper (engine/scan.py:
// term_lists) turns each table into a per-pod list once per chunk:
// offsets [P + 1] and the set columns, in order.  A step walks only its
// pod's entries.
//
// Exactness: every f32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), the library is built
// with --fmad=false besides, and no fast math.  Constants are the f32
// roundings of the step loop's Python constants.  Integer priorities
// keep int32 wrap-around and floor division (ops/priorities.py).  The
// rich families add only sums of whole numbers; the disk totals are
// int32, the inter-pod priority counts f64 (exact below 2^53) rounded
// to f32 once, as ops/interpod.py:priority_counts does, and each is a
// sum over one node's terms, so splitting the node axis cannot reorder
// it.  Maxima and minima are exact in any order.
//
// Bound.  Per chunk the kernel must read enc once (P x N x 4 bytes in
// f32: 2,048 x 5,000 x 4 = 41 MB at the north star) and the carried
// state once and write it once (packed, D, the spread planes: about
// 1 MB; the rich planes only in the rows and columns the chunk's terms
// name): 12.834 us per mixed north-star chunk at 3.35 TB/s
// (chip_smoke.py scan_bound), the bound PERF.md's kernel table keeps.
// Its real limit is the chain of P dependent steps: each is the
// per-node work of the step, a reduction over all N nodes, and the
// commit, and the next step needs the commit.  On one SM (C = 1) the
// chain takes ~10 us per mixed step at 5,000 nodes, most of it the
// per-node work of 8 nodes per thread.  Split over C SMs, the per-node
// work shrinks C-fold and the step is set by its fixed costs: the two
// cross-CTA exchanges (the pick's cluster barrier and the commit's
// signal, about 2,400 and 2,300 cycles of an H100 SM each, the copies
// and the owner's commit in their shadow) and the reductions around
// them.  The step floor -- a step with the per-node work cut,
// perf/scan_ablation.py's "select and commit only" -- is 3.58 us per
// mixed north-star step at the rule's C = 16, against 4.03 us for the
// whole step, and 3.80 against 7.20 us per rich one (an H100 80GB HBM3
// at 700 W; PERF.md).  Below ~640 nodes the exchanges cost more than
// the per-node work they split, and the rule takes one CTA, whose
// exchanges are CTA barriers.
//
// The design: ONE cluster of C CTAs (C in 1, 2, 4, 8, 16; the wrapper's
// engine/scan.py:cluster_plan chooses C from N, and the shared-memory
// plan), launched with cudaLaunchKernelEx and a cluster dimension:
//
//   * CTA rank r owns the contiguous node slice [r * slice, min(N,
//     (r + 1) * slice)); inside a CTA each warp owns a contiguous run of
//     32 * K nodes, lane l the nodes l, l + 32, ... of it.  So the tie
//     rank stays in node order: CTAs in rank order, then warps, then
//     rounds, then lanes.
//   * The pick.  Each warp publishes (its max, its ties at that max, a
//     NaN flag, and its K tie ballots); one CTA barrier; every warp
//     reduces the CTA's warps and thread 0 publishes the CTA's record
//     (max, ties, NaN) as one 16-byte word; ONE cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire, with the copies
//     of the next ring row issued between the two); warp 0 reads the C
//     records through distributed shared memory and leaves the maximum,
//     the tie total, the owner of the ix-th tie and its offset in its
//     CTA's shared memory for one CTA barrier.  Every thread of the
//     owner CTA then finds the node from its own CTA's ballots.  The
//     records are double-buffered by step parity, so a step that places
//     nothing needs no other exchange.  The rich inter-pod maximum and
//     minimum are published and reduced the same way, in one more CTA
//     and cluster barrier, only for pods with inter-pod priority terms.
//     The score maxima are one redux.sync each (floats mapped to
//     unsigned ints in the same order).
//   * The commit.  In the owner CTA, warp 0 commits packed[j] and
//     D[:, j] (its own node); a team of the other warps, one lane per
//     (spread group, CTA), writes the new spread maximum, zone count,
//     zone maximum and zone-blend entries into every CTA's replica
//     (distributed shared memory stores), then meets at a named barrier
//     and signals: lane c arrives on CTA c's commit mbarrier with
//     release at cluster scope.  Rich also writes the owner's rows and
//     the counts that are not node-indexed, and the whole owner CTA
//     meets before the signal.  Every CTA waits for the signal (acquire
//     at cluster scope) and one CTA barrier before its next step reads
//     what the commit wrote.  Rich topology rows are committed by every
//     CTA over its own slice, after reading j from the owner.
//   * A final cluster barrier before any CTA exits, so that no CTA reads
//     the shared memory of one that has gone.
//
// Coherence rule.  Every node-indexed plane is read and written only by
// the CTA that owns the node: packed, alloc, node_zone, D's columns,
// sp_node's columns, and in rich the rows of ports_used, vol_any,
// vol_rw, pd_* and the disk counts, and the columns of match_cnt,
// decl_reach and sym_cnt.  So the SMs' non-coherent L1s never serve a
// stale line of them.  The state that is not node-indexed lives either
// as a replica in each CTA's shared memory, written by the owner of the
// placed node into every replica before its release signal (sp_maxn,
// sp_zone, sp_maxz and the zone-blend table), or in device memory,
// written only by the owner of the placed node before its release
// signal and read by every CTA through ld.global.cg, never through L1
// (match_total, saa_num, saa_cnt).  The counter is replicated: every
// thread keeps it in a register.
//
// Shared memory holds each CTA's slice of the small carried planes
// (packed, alloc, node_zone, sp_node, D: 204 bytes per node at T = 32
// and S = 8), loaded at chunk start and written back at chunk end, as
// far as the byte budget of the plan allows; a plane that does not fit
// stays in device memory, read by its owner alone (the plan says which).
// The rich planes stay in device memory and L2.
//
// Loads leave the serial chain.  Each CTA's slice of enc row i goes into
// a ring of `stages` buffers in shared memory, `stages` steps ahead, by
// 4-byte cp.async (whatever the row's alignment; a TMA bulk copy for
// 16-byte aligned slices measured no faster than the call-to-call spread
// and was removed, PERF.md), in the same copy group as the pod's
// scalars (request, nonzero, zero_request, tmpl_idx, spread_group, the
// spread_incr row and every term list's offsets), which go into a ring
// of `stages` + 1 slots.  Every thread waits for the group of step i + 1
// before step i's CTA barrier, so a step starts without a dependent load
// from device memory and without a wait of its own.  zero_request and
// spread_incr are bool tables, and a chunk is a view that may start at
// any pod, so at any byte: their slot words are the aligned words that
// hold the row's bytes, found from the address, and a word that would
// reach outside its table is assembled byte by byte.
//
// The zone blend is a table: for every (group, zone) the zone term
// 2/3 * 10 * ((maxz - zone count) / max(maxz, 1e-9)), with the same _rn
// operations on the same operands as the per-node form; the commit
// rewrites the entries whose operands moved.  Per node the blend is one
// shared-memory lookup.
//
// Limits: N <= 16,384 (K <= 16 nodes per thread at 1,024 threads, the
// C = 1 case), at most 8 dynamic priority terms.  The wrapper checks
// both, and checks cudaOccupancyMaxActiveClusters >= 1 before the first
// launch of each configuration.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxTerms = 8;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxK = 16;
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;
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

// The pod slot (engine/scan.py SLOT_HEAD): int words.
constexpr int kSlotReq = 0;     // request [4]
constexpr int kSlotNz = 4;      // nonzero [2]
constexpr int kSlotZero = 6;    // zero_request
constexpr int kSlotTmpl = 7;    // tmpl_idx
constexpr int kSlotGroup = 8;   // spread_group
constexpr int kSlotSaa = 9;     // saa_group
constexpr int kSlotEbs = 10;    // ebs extra
constexpr int kSlotGce = 11;    // gce extra
constexpr int kSlotOff = 12;    // [lo, hi) of each term list
// The term lists, in slot order.
constexpr int kPorts = 0, kVolRw = 1, kVolRo = 2, kEbs = 3, kGce = 4,
              kAffNeed = 5, kAntiNeed = 6, kDeclMatch = 7, kMatchSrc = 8,
              kDeclSrc = 9, kSymSrc = 10, kPref = 11, kSymMatch = 12,
              kSaaSrc = 13, kLists = 14;
constexpr int kSlotIncr = kSlotOff + 2 * kLists;  // the spread_incr bytes

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

// The launch plan (engine/scan.py:cluster_plan): the cluster, the CTA
// shape and each CTA's dynamic shared memory, by byte offset (-1: the
// plane stays in device memory).
struct SmemPlan {
  int cluster;      // CTAs of the cluster, C
  int slice;        // nodes per CTA; the last CTA takes the rest
  int threads;      // per CTA
  int k;            // nodes per thread
  int stages;       // enc ring depth
  int bytes;        // dynamic shared memory per CTA
  int slot_words;   // int words of a pod slot
  int off_slots;    // pod slots: one per ring stage and one more
  int off_repl;     // sp_maxn, sp_maxz, has_zones, sp_zone, zone table,
                    // templates
  int off_ring;     // the enc ring
  int stage_bytes;  // one ring stage
  int off_packed, off_alloc, off_zone, off_sp, off_d;
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
  SmemPlan plan;
};

namespace {

// The fixed head of each CTA's dynamic shared memory: the published
// records (double-buffered by step parity) and the ring's mbarriers.
struct Records {
  float wmax[2][kMaxWarps];              // per warp: max
  int wcnt[2][kMaxWarps];                // ties at it
  int wnan[2][kMaxWarps];                // a NaN seen
  unsigned ball[2][kMaxWarps][kMaxK];    // tie ballots per round
  float cwmax[2][kMaxWarps];             // per warp: inter-pod max, min
  float cwmin[2][kMaxWarps];
  int4 cta[2];                           // per CTA: (max bits, ties, NaN, 0)
  float2 cta_ip[2];                      // per CTA: inter-pod (max, min)
  int commit_j;                          // the node the owner placed
  int pad;
  unsigned long long commit_bar;         // the owner's commit signal
  int4 pick;                             // (total, owner, offset, ix)
};

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

// The zone term of the spread blend for zone count zc under zone
// maximum maxz: 2/3 * (10 * ((maxz - zc) / max(maxz, 1e-9))).
__device__ __forceinline__ float zone_term(float maxz, float zc) {
  return __fmul_rn(kZoneShare,
                   __fmul_rn(10.0f, __fdiv_rn(__fsub_rn(maxz, zc),
                                              clamp_min(maxz, kClampMin))));
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

// -- asynchronous copies, barriers, the cluster ------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `stages` - 2 of this thread's newest copy groups
// are pending: the rows up to the next step's are in.
__device__ __forceinline__ void cp_async_wait_ahead(int stages) {
  if (stages >= 4) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (stages == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive, with release at cluster scope, on CTA `rank`'s copy of `bar`.
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar,
                                                   int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// Wait, with acquire at cluster scope, for the phase of `bar` with
// `parity` (the writes released by the arrivals become visible).  A
// signal that never comes is a fault: after ~2^26 polls (seconds) the
// kernel traps, and the launch reports an error instead of hanging.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The cluster barrier: every thread of every CTA; release/acquire at
// cluster scope, so it also orders shared (local and distributed) and
// global memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The CTAs' exchange barrier: the cluster barrier, or, for a cluster of
// one CTA, where every write is this CTA's own, a CTA barrier (which
// orders shared and global memory for the CTA's threads) in place of the
// cluster-scope release and acquire.
__device__ __forceinline__ void exchange_sync(int ncta) {
  if (ncta > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// CTA c's copy of a replica at p (this CTA's, whose rank is `self`).
template <typename T>
__device__ __forceinline__ T* replica_of(T* p, int c, int self) {
  return c == self ? p : peer(p, c);
}

// -- the rich families ------------------------------------------------------

// The node slots of a thread: slot k is node base + 32 k + lane, live
// while inside the CTA's slice (< hi).
template <int K>
struct Slots {
  int base, lane, hi;
  __device__ __forceinline__ int node(int k) const {
    return base + 32 * k + lane;
  }
  __device__ __forceinline__ bool live(int k) const { return node(k) < hi; }
};

// A term list's [lo, hi) for the step's pod, from its slot.
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool empty() const { return lo >= hi; }
};
__device__ __forceinline__ Span span(const int* slot, int list) {
  return Span{slot[kSlotOff + 2 * list], slot[kSlotOff + 2 * list + 1]};
}

// MaxEBSVolumeCount / MaxGCEPDVolumeCount on the thread's slots
// (engine/solver.py: sum(node row) + node extra + new - overlap <= limit
// and no node error; a pod bringing no new volume passes).  Sets bit k
// of `bad` where slot k fails.
template <int K>
__device__ __forceinline__ void pd_mask(const PdArgs& f, Span sp, int extra,
                                        const Slots<K>& sl, unsigned& bad) {
  const int fresh = sp.hi - sp.lo + extra;
  if (fresh == 0) return;
  int overlap[K];
#pragma unroll
  for (int k = 0; k < K; ++k) overlap[k] = 0;
  for (int q = sp.lo; q < sp.hi; ++q) {
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

// A node-major [N, W] bool plane tested at the listed columns of the
// pod: bit k of `bad` where slot k has any of them set.
template <int K>
__device__ __forceinline__ void column_mask(const TermList& t, Span sp,
                                            const unsigned char* plane,
                                            int w, const Slots<K>& sl,
                                            unsigned& bad) {
  for (int q = sp.lo; q < sp.hi; ++q) {
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
                                              int n, const int* slot,
                                              const Slots<K>& sl) {
  unsigned bad = 0;
  if (r.use_ports) {
    column_mask(r.ports, span(slot, kPorts), r.ports_used, r.cp, sl, bad);
  }
  if (r.use_volumes) {
    column_mask(r.vol_rw, span(slot, kVolRw), r.vol_any, r.vw, sl, bad);
    column_mask(r.vol_ro, span(slot, kVolRo), r.node_vol_rw, r.vw, sl, bad);
  }
  if (r.ebs.on) pd_mask(r.ebs, span(slot, kEbs), slot[kSlotEbs], sl, bad);
  if (r.gce.on) pd_mask(r.gce, span(slot, kGce), slot[kSlotGce], sl, bad);
  if (r.use_interpod) {
    // ops/interpod.py:predicate_mask: a required term is live unless it
    // matches the pod itself and nothing matches it yet.  match_total is
    // written by other CTAs: read through L2 only.
    const Span aff = span(slot, kAffNeed);
    for (int q = aff.lo; q < aff.hi; ++q) {
      const int s = r.aff_need.idx[q];
      if (r.aff_self[static_cast<size_t>(i) * r.sm + s] &&
          __ldcg(r.match_total + s) == 0.0f) {
        continue;
      }
      const float* row = r.match_cnt + static_cast<size_t>(s) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl.live(k) && !(row[sl.node(k)] > 0.0f)) bad |= 1u << k;
      }
    }
    const Span anti = span(slot, kAntiNeed);
    for (int q = anti.lo; q < anti.hi; ++q) {
      const float* row =
          r.match_cnt + static_cast<size_t>(r.anti_need.idx[q]) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (sl.live(k) && row[sl.node(k)] > 0.0f) bad |= 1u << k;
      }
    }
    const Span decl = span(slot, kDeclMatch);
    for (int q = decl.lo; q < decl.hi; ++q) {
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
                                                int n, const int* slot,
                                                const Slots<K>& sl,
                                                float* out) {
  double c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0.0;
  const Span pref = span(slot, kPref);
  for (int q = pref.lo; q < pref.hi; ++q) {
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
  const Span sym = span(slot, kSymMatch);
  for (int q = sym.lo; q < sym.hi; ++q) {
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
// group gy with peer total num (saa_cnt through L2 only).
__device__ __forceinline__ float saa_score(const RichArgs& r, int l, int gy,
                                           float num, int j, int n) {
  const size_t at = static_cast<size_t>(l) * n + j;
  if (!r.saa_labeled[at]) return 0.0f;
  if (!(num > 0.0f)) return 10.0f;
  const float per = __ldcg(
      r.saa_cnt + (static_cast<size_t>(l) * r.gy + gy) * r.dd + r.saa_dom[at]);
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

// Topology rows of the placed pod's terms in `src`, over this CTA's
// nodes [lo, hi): counts gain 1.0 (match_cnt, sym_cnt) or reach is set
// (decl_reach).
__device__ void commit_rows(const RichArgs& r, const TermList& src, Span sp,
                            const int* keys, float* cnt,
                            unsigned char* reach, int j, int n, int lo,
                            int hi) {
  for (int q = sp.lo; q < sp.hi; ++q) {
    const int s = src.idx[q];
    const int key = keys[s];
    const size_t row = static_cast<size_t>(s) * n;
    for (int x = lo + threadIdx.x; x < hi; x += blockDim.x) {
      if (!same_topology(r, n, key, x, j)) continue;
      if (cnt != nullptr) cnt[row + x] = __fadd_rn(cnt[row + x], 1.0f);
      if (reach != nullptr) reach[row + x] = 1;
    }
  }
}

// The pod's new disks in row j, one thread per disk; the row's count
// gains one per bit that was not set.
__device__ __forceinline__ void pd_commit(const PdArgs& pd, Span sp, int j) {
  unsigned char* row = pd.node + static_cast<size_t>(j) * pd.w;
  for (int q = sp.lo + threadIdx.x; q < sp.hi; q += blockDim.x) {
    unsigned char* bit = row + pd.pod.idx[q];
    if (!*bit) {
      *bit = 1;
      atomicAdd(pd.count + j, 1);
    }
  }
}

// The rich commit of pod i at node j that the owner of j makes: row j
// of the node-major planes, and the counts that are not node-indexed
// (match_total, saa_num, saa_cnt; read by every CTA through L2 only).
__device__ __forceinline__ void rich_commit_owner(const RichArgs& r,
                                                  const int* slot, int j,
                                                  int n) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  if (r.use_ports) {
    const Span sp = span(slot, kPorts);
    unsigned char* used = r.ports_used + static_cast<size_t>(j) * r.cp;
    for (int q = sp.lo + t; q < sp.hi; q += nt) used[r.ports.idx[q]] = 1;
  }
  if (r.use_volumes) {
    const size_t row = static_cast<size_t>(j) * r.vw;
    const Span rw = span(slot, kVolRw);
    for (int q = rw.lo + t; q < rw.hi; q += nt) {
      r.vol_any[row + r.vol_rw.idx[q]] = 1;
      r.node_vol_rw[row + r.vol_rw.idx[q]] = 1;
    }
    const Span ro = span(slot, kVolRo);
    for (int q = ro.lo + t; q < ro.hi; q += nt) {
      r.vol_any[row + r.vol_ro.idx[q]] = 1;
    }
  }
  if (r.ebs.on) pd_commit(r.ebs, span(slot, kEbs), j);
  if (r.gce.on) pd_commit(r.gce, span(slot, kGce), j);
  if (r.track_affinity) {
    const Span ms = span(slot, kMatchSrc);
    for (int q = ms.lo + t; q < ms.hi; q += nt) {
      const int s = r.match_src.idx[q];
      r.match_total[s] = __fadd_rn(__ldcg(r.match_total + s), 1.0f);
    }
  }
  if (r.track_saa) {
    const Span ss = span(slot, kSaaSrc);
    for (int q = ss.lo + t; q < ss.hi; q += nt) {
      const int g = r.saa_src.idx[q];
      r.saa_num[g] = __fadd_rn(__ldcg(r.saa_num + g), 1.0f);
      for (int l = 0; l < r.l; ++l) {
        const size_t at = static_cast<size_t>(l) * n + j;
        if (!r.saa_labeled[at]) continue;
        float* c = r.saa_cnt +
                   (static_cast<size_t>(l) * r.gy + g) * r.dd + r.saa_dom[at];
        *c = __fadd_rn(__ldcg(c), 1.0f);
      }
    }
  }
}

// -- the kernel -------------------------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// The warp's maximum of scores that are never NaN, in one redux: floats
// mapped to unsigned ints in the same order (-0.0 below +0.0, which
// every later use compares as equal).
__device__ __forceinline__ float warp_max_score(float v) {
  const unsigned b = __float_as_uint(v);
  const unsigned u = b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
  const unsigned m = __reduce_max_sync(kFull, u);
  return __uint_as_float(m ^ ((m >> 31) ? 0x80000000u : 0xffffffffu));
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

// The offsets of the term list at slot position `list`, or nullptr when
// its family is off.
__device__ __forceinline__ const int* list_off(const RichArgs& r, int list) {
  switch (list) {
    case kPorts: return r.use_ports ? r.ports.off : nullptr;
    case kVolRw: return r.use_volumes ? r.vol_rw.off : nullptr;
    case kVolRo: return r.use_volumes ? r.vol_ro.off : nullptr;
    case kEbs: return r.ebs.on ? r.ebs.pod.off : nullptr;
    case kGce: return r.gce.on ? r.gce.pod.off : nullptr;
    case kAffNeed: return r.use_interpod ? r.aff_need.off : nullptr;
    case kAntiNeed: return r.use_interpod ? r.anti_need.off : nullptr;
    case kDeclMatch: return r.use_interpod ? r.decl_match.off : nullptr;
    case kMatchSrc: return r.track_affinity ? r.match_src.off : nullptr;
    case kDeclSrc: return r.track_affinity ? r.decl_src.off : nullptr;
    case kSymSrc: return r.track_affinity ? r.sym_src.off : nullptr;
    case kPref: return r.use_interpod_prio ? r.pref.off : nullptr;
    case kSymMatch: return r.use_interpod_prio ? r.sym_match.off : nullptr;
    default: return r.track_saa ? r.saa_src.off : nullptr;
  }
}

// Where int word q of pod i's slot comes from, or nullptr when its
// family is off (the word is 0).  The byte words (zero_request and the
// spread_incr row) are placed by slot_word.
template <bool RICH>
__device__ __forceinline__ const void* slot_src(const ScanArgs& a, int i,
                                                int q) {
  if (q < kSlotNz) return a.request + 4 * i + q;
  if (q < kSlotZero) return a.nonzero + 2 * i + q - kSlotNz;
  if (q == kSlotTmpl) return a.use_templates ? a.tmpl_idx + i : nullptr;
  if (q == kSlotGroup) return a.track_spread ? a.spread_group + i : nullptr;
  if (q < kSlotOff) {
    if (!RICH) return nullptr;
    if (q == kSlotSaa) return a.r.track_saa ? a.r.saa_group + i : nullptr;
    if (q == kSlotEbs) return a.r.ebs.on ? a.r.ebs.extra + i : nullptr;
    return a.r.gce.on ? a.r.gce.extra + i : nullptr;
  }
  if (!RICH) return nullptr;
  const int* off = list_off(a.r, (q - kSlotOff) >> 1);
  return off != nullptr ? off + i + ((q - kSlotOff) & 1) : nullptr;
}

// Where a slot word comes from for any pod, in three registers (warp 0
// keeps two across the whole chunk).  An int word: pod i's is at base +
// i * stride, 4-byte aligned as its tensor is.  A byte word: pod i's row
// of `stride` bytes starts at base + i * stride, in a [P, stride] bool
// table whose pointer may have any alignment (a chunk is a view that
// starts at any pod); slot word q is the aligned word q - kSlotIncr
// words on (0 for zero_request) from the one that holds the row's first
// byte (see byte_lane).  desc packs stride << 1 | (1 for a byte word);
// base is nullptr for a word that is always 0.
struct SlotWord {
  const unsigned char* base;
  int desc;
};

template <bool RICH>
__device__ __forceinline__ SlotWord slot_word(const ScanArgs& a, int q) {
  if (q == kSlotZero) return {a.zero_request, 1 << 1 | 1};
  if (q >= kSlotIncr) {
    if (!a.track_spread) return {nullptr, 0};
    return {a.spread_incr, a.s << 1 | 1};
  }
  const auto* at = static_cast<const unsigned char*>(slot_src<RICH>(a, 0, q));
  const int stride = q < kSlotNz ? 16 : (q < kSlotZero ? 8 : 4);
  return {at, stride << 1};
}

// The byte lane of `at` in its aligned word.
__device__ __forceinline__ int byte_lane(const void* at) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3);
}

// Byte b of the slot's bytes from word w0 on.
__device__ __forceinline__ int slot_byte(const int* slot, int w0, int b) {
  return (slot[w0 + (b >> 2)] >> (8 * (b & 3))) & 0xff;
}

// Pod `row`'s slot word q (from `w`) into *dst: an int word by
// cp.async; a byte word by cp.async when the whole aligned word lies in
// its table of p rows, else byte by byte (a stored word; bytes outside
// the table are 0), so no byte outside the table is read.  A byte word
// past the row is not copied.
__device__ __forceinline__ void copy_slot_word(int* dst, int row, int p,
                                               int q, const SlotWord& w) {
  if (w.base == nullptr) return;
  const int stride = w.desc >> 1;
  const long long first = static_cast<long long>(row) * stride;
  if (!(w.desc & 1)) {
    cp_async4(dst, w.base + first);
    return;
  }
  const int lane0 = byte_lane(w.base + first);
  const int word = q >= kSlotIncr ? q - kSlotIncr : 0;
  if (4 * word >= lane0 + stride) return;
  const long long b0 = first - lane0 + 4 * word;  // offset in the table
  const long long len = static_cast<long long>(p) * stride;
  if (b0 >= 0 && b0 + 4 <= len) {
    cp_async4(dst, w.base + b0);
    return;
  }
  int v = 0;
  for (int b = 0; b < 4; ++b) {
    if (b0 + b >= 0 && b0 + b < len) v |= w.base[b0 + b] << (8 * b);
  }
  *dst = v;
}

// One CTA's view of the node-indexed planes: node j's entries, j in
// [lo, hi), in shared memory (the CTA's slice) or in device memory.
struct Planes {
  int* packed;       // + 6 * (j - lo)
  const int* alloc;  // + 4 * (j - lo)
  const int* zone;   // + (j - lo)
  float* sp;         // + s * sp_stride + (j - lo)
  float* d;          // + t * d_stride + (j - lo)
  int sp_stride, d_stride;
};

// The replicated state that is not node-indexed, in each CTA, and the
// templates' nonzero requests.
struct Replica {
  float* maxn;  // [S]
  float* maxz;  // [S]
  int* hz;      // [S]
  float* zone;  // [S, Z]
  float* ztab;  // [S, Z]
  int* tmpl;    // [T, 2]
};

template <int K, typename EncT, bool RICH>
__global__ void __launch_bounds__(kMaxThreads)
scan_chunk_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Records& rec = *reinterpret_cast<Records*>(smem);
  const SmemPlan& pl = a.plan;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int ncta = pl.cluster;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int n = a.n;
  const int p = a.p;
  const int lo = rank * pl.slice;
  const int hi = min(n, lo + pl.slice);
  const int nloc = hi - lo;
  const int wbase = lo + warp * 32 * K;  // this warp's first node
  const EncT* enc = static_cast<const EncT*>(a.enc);
  const RichArgs& r = a.r;
  const int ns = pl.stages;
  const int sw = pl.slot_words;
  int* slots = reinterpret_cast<int*>(smem + pl.off_slots);
  const Slots<K> sl{wbase, lane, hi};

  // -- prologue: node planes, replicas, the first rows and pod slots ------
  Planes P;
  P.packed = pl.off_packed >= 0 ? reinterpret_cast<int*>(smem + pl.off_packed)
                                : a.packed + 6 * lo;
  P.alloc = pl.off_alloc >= 0 ? reinterpret_cast<const int*>(smem + pl.off_alloc)
                              : a.alloc + 4 * lo;
  P.zone = pl.off_zone >= 0 ? reinterpret_cast<const int*>(smem + pl.off_zone)
                            : (a.track_zones ? a.node_zone + lo : nullptr);
  P.sp = pl.off_sp >= 0 ? reinterpret_cast<float*>(smem + pl.off_sp)
                        : (a.track_spread ? a.sp_node + lo : nullptr);
  P.sp_stride = pl.off_sp >= 0 ? pl.slice : n;
  P.d = pl.off_d >= 0 ? reinterpret_cast<float*>(smem + pl.off_d)
                      : (a.use_templates ? a.d_plane + lo : nullptr);
  P.d_stride = pl.off_d >= 0 ? pl.slice : n;
  if (pl.off_packed >= 0) {
    for (int x = tid; x < 6 * nloc; x += nt) P.packed[x] = a.packed[6 * lo + x];
  }
  if (pl.off_alloc >= 0) {
    int* dst = reinterpret_cast<int*>(smem + pl.off_alloc);
    for (int x = tid; x < 4 * nloc; x += nt) dst[x] = a.alloc[4 * lo + x];
  }
  if (pl.off_zone >= 0) {
    int* dst = reinterpret_cast<int*>(smem + pl.off_zone);
    for (int x = tid; x < nloc; x += nt) dst[x] = a.node_zone[lo + x];
  }
  if (pl.off_sp >= 0) {
    for (int x = tid; x < a.s * nloc; x += nt) {
      const int s = x / nloc;
      const int c = x - s * nloc;
      P.sp[s * pl.slice + c] = a.sp_node[static_cast<size_t>(s) * n + lo + c];
    }
  }
  if (pl.off_d >= 0) {
    for (int x = tid; x < a.t * nloc; x += nt) {
      const int t = x / nloc;
      const int c = x - t * nloc;
      P.d[t * pl.slice + c] = a.d_plane[static_cast<size_t>(t) * n + lo + c];
    }
  }
  Replica R;
  R.maxn = reinterpret_cast<float*>(smem + pl.off_repl);
  R.maxz = R.maxn + a.s;
  R.hz = reinterpret_cast<int*>(R.maxz + a.s);
  R.zone = reinterpret_cast<float*>(R.hz + a.s);
  R.ztab = R.zone + a.s * a.z;
  R.tmpl = reinterpret_cast<int*>(R.ztab + a.s * a.z);
  if (a.use_templates) {
    for (int q = tid; q < 2 * a.t; q += nt) R.tmpl[q] = a.templates[q];
  }
  if (a.track_spread) {
    for (int s = tid; s < a.s; s += nt) R.maxn[s] = a.sp_maxn[s];
  }
  if (a.track_zones) {
    for (int s = tid; s < a.s; s += nt) {
      R.maxz[s] = a.sp_maxz[s];
      R.hz[s] = a.has_zones[s] != 0;
    }
    for (int q = tid; q < a.s * a.z; q += nt) {
      const float zc = a.sp_zone[q];
      R.zone[q] = zc;
      R.ztab[q] = zone_term(a.sp_maxz[q / a.z], zc);
    }
  }
  // The slots' words that no pod copies stay 0.
  for (int q = tid; q < (ns + 1) * sw; q += nt) slots[q] = 0;
  if (tid == 0) {
    mbar_init(&rec.commit_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The enc ring: row `row` of this CTA's slice into stage row % ns.
  constexpr int epw = 4 / static_cast<int>(sizeof(EncT));  // per word
  const long long total_elems = static_cast<long long>(p) * n;
  unsigned char* const ring = smem + pl.off_ring;
  const int stage_bytes = pl.stage_bytes;
  auto stage_of = [&](int row) {
    return reinterpret_cast<EncT*>(ring + (row % ns) * stage_bytes);
  };
  auto row_base = [&](int row) {  // first element held by the stage
    const long long e0 = static_cast<long long>(row) * n + lo;
    return e0 & ~static_cast<long long>(epw - 1);
  };
  // Warp 0's lanes hold where their slot words come from (words 64 and
  // up, for more than 92 spread groups, are looked up every time).
  const SlotWord sw0 = slot_word<RICH>(a, lane < sw ? lane : 0);
  const SlotWord sw1 = slot_word<RICH>(a, lane + 32 < sw ? lane + 32 : 0);
  auto copy_word = [&](int* slot, int row, int q, const SlotWord& w) {
    if (q < sw) copy_slot_word(slot + q, row, p, q, w);
  };
  // Row `row` of enc and pod `row`'s slot, in one copy group: the slot's
  // words by warp 0, one cp.async each, or a store for a bool word at the
  // edge of its table (a word of an absent family stays 0).
  auto issue = [&](int row) {
    if (row < p && warp == 0) {
      int* slot = slots + (row % (ns + 1)) * sw;
      copy_word(slot, row, lane, sw0);
      copy_word(slot, row, lane + 32, sw1);
      for (int q = 64 + lane; q < sw; q += 32) {
        copy_slot_word(slot + q, row, p, q, slot_word<RICH>(a, q));
      }
    }
    if (row < p) {
      EncT* dst = stage_of(row);
      const long long e0 = static_cast<long long>(row) * n + lo;
      const long long base = e0 & ~static_cast<long long>(epw - 1);
      const int words = static_cast<int>((e0 + nloc - base + epw - 1) / epw);
      for (int w = tid; w < words; w += nt) {
        const long long g = base + static_cast<long long>(w) * epw;
        if (g + epw <= total_elems) {
          cp_async4(dst + w * epw, enc + g);
        } else {
          for (int e = 0; e < epw; ++e) {
            if (g + e < total_elems) dst[w * epw + e] = enc[g + e];
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int row = 0; row < ns; ++row) issue(row);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // Every CTA of the cluster has started (its shared memory exists) and
  // holds its slice, replicas and the first slot.
  cluster_sync();

  uint32_t ctr = static_cast<uint32_t>(
      static_cast<unsigned long long>(a.counter[0]));
  unsigned placed = 0;  // steps placed so far: the commit signal's phase

  for (int i = 0; i < p; ++i) {
    const int buf = i & 1;
    // Pod i's slot and enc row i are in: their copy group was waited for
    // by every thread before the previous step's CTA barrier (below, and
    // the prologue's wait for the first step).
    const int* slot = slots + (i % (ns + 1)) * sw;
    const EncT* row = stage_of(i) + (static_cast<long long>(i) * n + lo -
                                     row_base(i));

    // The pod's scalars, from its slot (uniform across the cluster).
    const int pn0 = slot[kSlotNz + 0];
    const int pn1 = slot[kSlotNz + 1];
    const int r0 = slot[kSlotReq + 0];
    const int r1 = slot[kSlotReq + 1];
    const int r2 = slot[kSlotReq + 2];
    const bool zero_req =
        slot_byte(slot, kSlotZero, byte_lane(a.zero_request + i)) != 0;
    const int incr0 =
        a.track_spread
            ? byte_lane(a.spread_incr + static_cast<long long>(i) * a.s)
            : 0;
    const float* d_row =
        a.use_templates ? P.d + slot[kSlotTmpl] * P.d_stride : nullptr;
    const int g = slot[kSlotGroup];
    float maxn = 0.0f, maxz = 0.0f;
    bool g_zones = false;
    if (a.track_spread) {
      maxn = R.maxn[g];
      if (a.track_zones) {
        maxz = R.maxz[g];
        g_zones = R.hz[g] != 0;
      }
    }
    const float* ztab = R.ztab + g * a.z;
    int saa_g = 0;
    float saa_n = 0.0f;
    if constexpr (RICH) {
      if (r.track_saa) {
        saa_g = slot[kSlotSaa];
        saa_n = __ldcg(r.saa_num + saa_g);
      }
    }

    // 2. The inter-pod priority counts of this thread's nodes, and their
    // max and min over the schedulable nodes of the cluster: one CTA
    // barrier, one cluster barrier.  A pod without terms has counts 0.0
    // everywhere, hence a 0.0 plane.
    float ipc[RICH ? K : 1] = {};
    float ip_min = 0.0f, ip_den = 0.0f;
    bool ip_on = false;
    if constexpr (RICH) {
      if (r.use_interpod_prio) {
        ip_on = !span(slot, kPref).empty() || !span(slot, kSymMatch).empty();
      }
      if (ip_on) {
        interpod_counts(r, i, n, slot, sl, ipc);
        float cmax = -INFINITY, cmin = INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = sl.node(k);
          if (j >= hi || !r.schedulable[j]) continue;
          cmax = ipc[k] > cmax ? ipc[k] : cmax;
          cmin = ipc[k] < cmin ? ipc[k] : cmin;
        }
        cmax = warp_max(cmax);
        cmin = warp_min(cmin);
        if (lane == 0) {
          rec.cwmax[buf][warp] = cmax;
          rec.cwmin[buf][warp] = cmin;
        }
        __syncthreads();
        const float bmax =
            warp_max(lane < nwarps ? rec.cwmax[buf][lane] : -INFINITY);
        const float bmin =
            warp_min(lane < nwarps ? rec.cwmin[buf][lane] : INFINITY);
        if (tid == 0) rec.cta_ip[buf] = make_float2(bmax, bmin);
        exchange_sync(ncta);
        float2 cr = make_float2(-INFINITY, INFINITY);
        if (lane < ncta) cr = peer(&rec, lane)->cta_ip[buf];
        const float gmax = warp_max(cr.x);
        const float gmin = warp_min(cr.y);
        // torch.clamp(max, min=0) and torch.clamp(min, max=0).
        const float max_c = gmax < 0.0f ? 0.0f : gmax;
        ip_min = gmin > 0.0f ? 0.0f : gmin;
        ip_den = __fsub_rn(max_c, ip_min);
      }
    }

    // The rich predicates of this thread's nodes (bit k: slot k fails).
    unsigned rich_bad = 0;
    if constexpr (RICH) rich_bad = rich_mask(r, i, n, slot, sl);

    // 3-4. Scores of this thread's nodes.
    float sc[K];
    float tmax = -INFINITY;
    int tnan = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sl.node(k);
      sc[k] = -INFINITY;
      if (j >= hi) continue;
      const int x = j - lo;
      float acc = widen(row[x]);
      if (d_row != nullptr) acc = __fadd_rn(acc, d_row[x]);
      const int* pk = P.packed + 6 * x;
      const int* al = P.alloc + 4 * x;
      for (int q = 0; q < a.n_terms; ++q) {
        const int kind = a.term_kind[q];
        float plane;
        if (kind == kSpread) {
          const float cnt = P.sp[g * P.sp_stride + x];
          float fsc = 10.0f;
          if (maxn > 0.0f) {
            fsc = __fmul_rn(10.0f, __fdiv_rn(__fsub_rn(maxn, cnt),
                                             clamp_min(maxn, kClampMin)));
          }
          if (a.track_zones) {
            // The zone blend: the node share plus the table's zone term.
            const int zj = P.zone[x];
            if (g_zones && zj >= 0 && maxz > 0.0f) {
              fsc = __fadd_rn(__fmul_rn(fsc, kNodeShare), ztab[zj]);
            }
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
          plane = resource_prio(kind, pn0, pn1, pk[4], pk[5], al[0], al[1]);
        }
        acc = add_weighted(acc, a.term_w[q], plane);
      }
      if (a.use_resources) {
        const bool fits_pods = wadd(pk[3], 1) <= al[3];
        const bool fits_res = r0 <= wsub(al[0], pk[0]) &&
                              r1 <= wsub(al[1], pk[1]) &&
                              r2 <= wsub(al[2], pk[2]);
        if (!(fits_pods && (zero_req || fits_res))) acc = -INFINITY;
      }
      if (RICH && ((rich_bad >> k) & 1u)) acc = -INFINITY;
      sc[k] = acc;
      tnan |= acc != acc;
      tmax = acc > tmax ? acc : tmax;
    }

    // 5. selectHost.  Each warp publishes its max, its ties at that max,
    // a NaN flag and its tie ballots ...
    const float wm = warp_max_score(tmax);
    const int wnan = __any_sync(kFull, tnan);
    unsigned ball[K];
    int wc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ball[k] = __ballot_sync(kFull, sc[k] == wm);
      wc += __popc(ball[k]);
    }
    if (lane == 0) {
      rec.wmax[buf][warp] = wm;
      rec.wcnt[buf][warp] = wc;
      rec.wnan[buf][warp] = wnan;
#pragma unroll
      for (int k = 0; k < K; ++k) rec.ball[buf][warp][k] = ball[k];
    }
    cp_async_wait_ahead(ns);
    __syncthreads();
    // ... every warp reduces the CTA's warps: its max, its tie total
    // (warps at that max) and each warp's offset among them ...
    const float m = lane < nwarps ? rec.wmax[buf][lane] : -INFINITY;
    const int cnt = lane < nwarps ? rec.wcnt[buf][lane] : 0;
    const int cnan = __any_sync(kFull, lane < nwarps && rec.wnan[buf][lane]);
    const float cmx = warp_max_score(m);
    const int wc_eff = m == cmx ? cnt : 0;
    const int wincl = warp_inclusive_sum(wc_eff, lane);
    const int ctot = __shfl_sync(kFull, wincl, 31);
    if (tid == 0) rec.cta[buf] = make_int4(__float_as_int(cmx), ctot, cnan, 0);
    if (ncta > 1) cluster_arrive();
    // In the barrier's shadow: the copies of enc row and pod i + ns (the
    // stage of row i is read, and pod i keeps its own slot).  One CTA
    // meets at a CTA barrier instead (exchange_sync).
    issue(i + ns);
    if (ncta > 1) {
      cluster_wait();
    } else {
      __syncthreads();
    }
    // ... and warp 0 reduces the CTAs' records (one 16-byte load per CTA
    // through distributed shared memory) for its CTA: the maximum, the
    // tie total, and the CTA that holds the ix-th tie with its offset.
    if (warp == 0) {
      int4 cr = make_int4(__float_as_int(-INFINITY), 0, 0, 0);
      if (lane < ncta) cr = peer(&rec, lane)->cta[buf];
      const float rm = __int_as_float(cr.x);
      const int any_nan = __any_sync(kFull, cr.z != 0);
      const float mx = warp_max_score(rm);
      const bool finite = !any_nan && isfinite(mx);
      const int c_eff = (finite && rm == mx) ? cr.y : 0;
      const int incl = warp_inclusive_sum(c_eff, lane);
      const int total = __shfl_sync(kFull, incl, 31);
      const uint32_t ix =
          total > 0 ? ctr % static_cast<uint32_t>(total) : 0u;
      const unsigned hit = __ballot_sync(
          kFull, c_eff > 0 && ix >= static_cast<uint32_t>(incl - c_eff) &&
                     ix < static_cast<uint32_t>(incl));
      const int owner = hit != 0 ? __ffs(hit) - 1 : 0;
      const int coff = __shfl_sync(kFull, incl - c_eff, owner);
      if (lane == 0) {
        rec.pick = make_int4(total, owner, coff, static_cast<int>(ix));
      }
    }
    __syncthreads();
    const int4 pick = rec.pick;
    const int total = pick.x;
    if (total == 0) {
      if (rank == 0 && tid == 0) a.choices[i] = -1;
      continue;
    }
    const int owner = pick.y;
    const int coff = pick.z;
    const uint32_t ix = static_cast<uint32_t>(pick.w);

    // 6. Commit at j, by the owner CTA.
    if (owner == rank) {
      // Every thread finds j from the CTA's ballots: the warp, then the
      // round, then the lane.
      const int want = static_cast<int>(ix) - coff;
      const unsigned wh = __ballot_sync(
          kFull, wc_eff > 0 && want >= wincl - wc_eff && want < wincl);
      const int ww = __ffs(wh) - 1;
      int rest = want - __shfl_sync(kFull, wincl - wc_eff, ww);
      int j = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned b = rec.ball[buf][ww][k];
        const int c = __popc(b);
        if (j < 0 && rest < c) {
          const unsigned sel = __ballot_sync(
              kFull, ((b >> lane) & 1u) &&
                         __popc(b & ((1u << lane) - 1u)) == rest);
          j = lo + ww * 32 * K + 32 * k + (__ffs(sel) - 1);
        }
        if (j < 0) rest -= c;
      }
      const int x = j - lo;
      // Warp 0: packed[j] and D[:, j], from the old aggregates read
      // before lane 0 writes the new ones.
      if (warp == 0) {
        int* pk = P.packed + 6 * x;
        const int q0 = wadd(pk[4], pn0);
        const int q1 = wadd(pk[5], pn1);
        int old[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) old[c] = pk[c];
        __syncwarp();
        if (lane == 0) {
          rec.commit_j = j;
#pragma unroll
          for (int c = 0; c < 4; ++c) pk[c] = wadd(old[c], slot[kSlotReq + c]);
          pk[4] = q0;
          pk[5] = q1;
        }
        if (a.use_templates) {
          const int cap_cpu = P.alloc[4 * x + 0];
          const int cap_mem = P.alloc[4 * x + 1];
          for (int t = lane; t < a.t; t += 32) {
            float col = 0.0f;
            for (int q = 0; q < a.n_tmpl_terms; ++q) {
              col = add_weighted(
                  col, a.tmpl_w[q],
                  resource_prio(a.tmpl_kind[q], R.tmpl[2 * t],
                                R.tmpl[2 * t + 1], q0, q1, cap_cpu, cap_mem));
            }
            P.d[t * P.d_stride + x] = col;
          }
        }
      }
      // The spread commit: lane (s, c) of the team (warps 1.., or warp 0
      // alone in a one-warp CTA) for group s and CTA c; the lanes of one
      // group share a warp, read the old values, then write CTA c's
      // replica (and, c == 0, the owner's column).
      if (a.track_spread && (warp > 0 || nwarps == 1)) {
        const int team0 = nwarps > 1 ? 32 : 0;
        const int zj = a.track_zones ? P.zone[x] : -1;
        const int zc = zj < 0 ? 0 : zj;
        for (int base = 0; base < a.s * ncta; base += nt - team0) {
          const int u = base + tid - team0;
          const bool mine = u < a.s * ncta;
          const int sg = mine ? u / ncta : 0;
          const int c = u - sg * ncta;
          float inc = 0.0f, nv = 0.0f, mn = 0.0f, zv = 0.0f, mz = 0.0f;
          float oldmz = 0.0f;
          if (mine) {
            inc = slot_byte(slot, kSlotIncr, incr0 + sg) ? 1.0f : 0.0f;
            nv = __fadd_rn(P.sp[sg * P.sp_stride + x], inc);
            mn = nan_max(R.maxn[sg], nv);
            // As the step loop: the clamped zone column takes inc * 0
            // when the node has no zone, and the maximum moves only when
            // it has.
            if (a.track_zones) {
              zv = __fadd_rn(R.zone[sg * a.z + zc], zj >= 0 ? inc : 0.0f);
              oldmz = R.maxz[sg];
              mz = zj >= 0 ? nan_max(oldmz, zv) : oldmz;
            }
          }
          __syncwarp();
          if (mine) {
            if (c == 0) P.sp[sg * P.sp_stride + x] = nv;
            replica_of(R.maxn, c, rank)[sg] = mn;
            if (a.track_zones) {
              replica_of(R.zone, c, rank)[sg * a.z + zc] = zv;
              replica_of(R.maxz, c, rank)[sg] = mz;
              // The zone table moves only in a row whose zone count
              // grew: at its zone, or everywhere when its maximum moved.
              if (inc != 0.0f && zj >= 0) {
                float* tab = replica_of(R.ztab, c, rank) + sg * a.z;
                if (__float_as_uint(mz) == __float_as_uint(oldmz)) {
                  tab[zc] = zone_term(mz, zv);
                } else {
                  for (int z = 0; z < a.z; ++z) {
                    tab[z] = zone_term(mz, z == zc ? zv : R.zone[sg * a.z + z]);
                  }
                }
              }
            }
          }
          __syncwarp();
        }
      }
      // Every write the other CTAs read, then the signal: lane c arrives
      // on CTA c's commit barrier with release at cluster scope.  In
      // mixed only the spread team's replica stores go to other CTAs, so
      // its warps signal after their own barrier while warp 0 finishes
      // the owner's own D column; rich also writes the counts that are
      // not node-indexed, so the whole CTA meets first.
      if constexpr (RICH) {
        rich_commit_owner(r, slot, j, n);
        __syncthreads();
        if (ncta > 1 && warp == 0 && lane < ncta) {
          mbar_arrive_remote(&rec.commit_bar, lane);
        }
      } else if (ncta == 1) {
        // One CTA: the CTA barrier below orders the commit.
      } else if (nwarps == 1) {
        __syncwarp();
        if (lane < ncta) mbar_arrive_remote(&rec.commit_bar, lane);
      } else if (warp > 0) {
        asm volatile("bar.sync 1, %0;\n" ::"r"(nt - 32) : "memory");
        if (warp == 1 && lane < ncta) {
          mbar_arrive_remote(&rec.commit_bar, lane);
        }
      }
      // Off the signal's release: the choice is read by the host only.
      if (tid == 0) a.choices[i] = j;
    }
    // Every CTA takes the owner's signal (thread 0, with acquire at
    // cluster scope) before the next step reads what the commit wrote.
    if (ncta > 1 && tid == 0) {
      mbar_wait_cluster(&rec.commit_bar, placed & 1u);
    }
    __syncthreads();
    ++placed;
    if constexpr (RICH) {
      if (r.track_affinity &&
          !(span(slot, kMatchSrc).empty() && span(slot, kDeclSrc).empty() &&
            span(slot, kSymSrc).empty())) {
        // Every CTA commits the placed pod's topology rows over its own
        // nodes.
        const int j = peer(&rec, owner)->commit_j;
        commit_rows(r, r.match_src, span(slot, kMatchSrc), r.match_key,
                    r.match_cnt, nullptr, j, n, lo, hi);
        commit_rows(r, r.decl_src, span(slot, kDeclSrc), r.decl_key, nullptr,
                    r.decl_reach, j, n, lo, hi);
        commit_rows(r, r.sym_src, span(slot, kSymSrc), r.sym_key, r.sym_cnt,
                    nullptr, j, n, lo, hi);
        __syncthreads();
      }
    }
    // 7. The counter.
    ++ctr;
  }

  // No CTA leaves while another may still read its shared memory.
  cluster_sync();
  if (rank == 0 && tid == 0) {
    a.counter[0] = static_cast<long long>(ctr);
  }
  if (pl.off_packed >= 0) {
    for (int x = tid; x < 6 * nloc; x += nt) a.packed[6 * lo + x] = P.packed[x];
  }
  if (pl.off_sp >= 0) {
    for (int x = tid; x < a.s * nloc; x += nt) {
      const int s = x / nloc;
      const int c = x - s * nloc;
      a.sp_node[static_cast<size_t>(s) * n + lo + c] = P.sp[s * pl.slice + c];
    }
  }
  if (pl.off_d >= 0) {
    for (int x = tid; x < a.t * nloc; x += nt) {
      const int t = x / nloc;
      const int c = x - t * nloc;
      a.d_plane[static_cast<size_t>(t) * n + lo + c] = P.d[t * pl.slice + c];
    }
  }
  if (rank == 0) {
    if (a.track_spread) {
      for (int s = tid; s < a.s; s += nt) a.sp_maxn[s] = R.maxn[s];
    }
    if (a.track_zones) {
      for (int s = tid; s < a.s; s += nt) a.sp_maxz[s] = R.maxz[s];
      for (int q = tid; q < a.s * a.z; q += nt) a.sp_zone[q] = R.zone[q];
    }
  }
}

// The launch configuration of one instantiation: its dynamic shared
// memory allowed, and one cluster of `plan.cluster` CTAs.
template <int K, typename EncT, bool RICH>
cudaError_t configure(const ScanArgs& a, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto kern = scan_chunk_kernel<K, EncT, RICH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.bytes);
  if (err != cudaSuccess) return err;
  if (a.plan.cluster > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.plan.cluster, 1, 1);
  cfg->blockDim = dim3(a.plan.threads, 1, 1);
  cfg->dynamicSmemBytes = a.plan.bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.plan.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launch (clusters == nullptr) or ask how many such clusters can be
// resident at once (cudaOccupancyMaxActiveClusters into *clusters).
template <int K, typename EncT, bool RICH>
cudaError_t run(const ScanArgs& a, cudaStream_t stream, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K, EncT, RICH>(a, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if (clusters != nullptr) {
    return cudaOccupancyMaxActiveClusters(
        clusters, scan_chunk_kernel<K, EncT, RICH>, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, scan_chunk_kernel<K, EncT, RICH>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int K>
cudaError_t run_k(const ScanArgs& a, cudaStream_t stream, int* clusters) {
  if (a.rich) {
    return a.half ? run<K, __half, true>(a, stream, clusters)
                  : run<K, float, true>(a, stream, clusters);
  }
  return a.half ? run<K, __half, false>(a, stream, clusters)
                : run<K, float, false>(a, stream, clusters);
}

// The plan's shape is one the kernel takes.
bool valid(const ScanArgs& a) {
  const SmemPlan& pl = a.plan;
  const int c = pl.cluster;
  if (a.p <= 0 || a.n <= 0 || a.n > 16 * kMaxThreads ||
      a.n_terms > kMaxTerms || a.n_tmpl_terms > kMaxTerms) {
    return false;
  }
  if (!(c == 1 || c == 2 || c == 4 || c == 8 || c == kMaxCluster)) {
    return false;
  }
  if (pl.slice <= 0 || static_cast<long long>(pl.slice) * c < a.n ||
      static_cast<long long>(pl.slice) * (c - 1) >= a.n) {
    return false;
  }
  if (pl.threads <= 0 || pl.threads > kMaxThreads || pl.threads % 32 != 0 ||
      pl.k <= 0 || pl.k > kMaxK || pl.threads * pl.k < pl.slice) {
    return false;
  }
  if (pl.stages < 2 || pl.stages > kMaxStages || pl.bytes > kSmemLimit ||
      pl.off_slots < static_cast<int>(sizeof(Records)) ||
      pl.slot_words < kSlotIncr + (a.s > 0 ? (a.s + 3) / 4 + 1 : 0)) {
    return false;
  }
  return true;
}

// Nodes per thread the kernel is instantiated for; the plan takes the
// smallest that covers a CTA's slice with at most 1,024 threads.  The
// rule's cluster sizes always give K = 1 (a slice of at most 1,024
// nodes); K = 2 .. 16 serve the checks' forced smaller clusters, a power
// of two each, so a CTA of a slice above 1,024 nodes still runs 512 to
// 1,024 threads (K = 16 only at C = 1 with more than 8,192 nodes).
#define KT_SCAN_KS(X) X(1) X(2) X(4) X(8) X(16)

cudaError_t dispatch(const ScanArgs& a, void* stream, int* clusters) {
  if (!valid(a)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_SCAN_CASE(KV) \
  if (a.plan.k == KV) return run_k<KV>(a, st, clusters);
  KT_SCAN_KS(KT_SCAN_CASE)
#undef KT_SCAN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// One chunk: `args` as engine/scan.py fills it.  Launches one cluster on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kt_scan_chunk(const ScanArgs* args, void* stream) {
  return static_cast<int>(dispatch(*args, stream, nullptr));
}

// cudaOccupancyMaxActiveClusters for the launch `args` describes, into
// *clusters; returns the CUDA error (0 on success).
extern "C" int kt_scan_max_clusters(const ScanArgs* args, void* stream,
                                    int* clusters) {
  *clusters = 0;
  return static_cast<int>(dispatch(*args, stream, clusters));
}

// sizeof(ScanArgs), for the wrapper's check that its ctypes mirror has
// the same layout.
extern "C" int kt_scan_args_size() {
  return static_cast<int>(sizeof(ScanArgs));
}

// sizeof(Records), the fixed head of each CTA's shared memory, for the
// wrapper's check that its plan reserves it.
extern "C" int kt_scan_fixed_smem() {
  return static_cast<int>(sizeof(Records));
}
