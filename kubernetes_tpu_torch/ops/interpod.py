"""Inter-pod (anti-)affinity functions (torch counterpart of
``kubernetes_tpu/ops/interpod.py``).

The quadratic (pods x pods via topology) computation of
``predicates.go:825-1068`` and ``interpod_affinity.go:117-260`` is three
[P,S] @ [S,N] contractions over the sig tables built by
``features/affinity.py``.  The predicate's contractions are float32
matmuls of 0/1 incidences, exact at any matmul precision; the priority's
weighted counts are summed in float64 (``priority_counts``).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.api.types import DEFAULT_FAILURE_DOMAINS

# node_dom's first rows are always the default failure domains
# (pkg/api/types.go:3053-3063); static so empty-topology-key terms can slice.
N_DEFAULT_KEYS = len(DEFAULT_FAILURE_DOMAINS)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P,S] bool x [S,N] bool -> [P,N] bool any-pair contraction."""
    return (a.float() @ b.float()) > 0


def topo_rows(node_dom: torch.Tensor, keys: torch.Tensor,
              choice: torch.Tensor) -> torch.Tensor:
    """[S, N] bool — per-sig "same topology as node ``choice``" rows.

    ``choice`` is a one-element int64 tensor (a device value: reading it
    on the host would stall the scan).  NodesHaveSameTopologyKey
    (topologies.go:66-76): key row >= 0 compares that key's domain ids;
    -1 (empty topologyKey) matches under ANY default failure-domain
    key."""
    return topo_rows_col(node_dom, keys,
                         node_dom.index_select(1, choice)[:, 0])


def topo_rows_col(node_dom: torch.Tensor, keys: torch.Tensor,
                  col: torch.Tensor) -> torch.Tensor:
    """:func:`topo_rows` from the chosen node's domain column ``col``
    [K] (``node_dom[:, choice]``), which a node shard of
    ``parallel/mesh.py`` receives from the shard holding the node."""
    dom_sel = node_dom[torch.clamp(keys, min=0).long()]          # [S, N]
    dom_c = col[torch.clamp(keys, min=0).long()][:, None]        # [S, 1]
    specific = (dom_sel == dom_c) & (dom_sel >= 0)
    ddom = node_dom[:N_DEFAULT_KEYS]                             # [D, N]
    ddc = col[:N_DEFAULT_KEYS][:, None]                          # [D, 1]
    any_default = torch.any((ddom == ddc) & (ddom >= 0), dim=0)
    return torch.where((keys >= 0)[:, None], specific, any_default[None, :])


def predicate_mask(aff_need: torch.Tensor, aff_self: torch.Tensor,
                   anti_need: torch.Tensor, decl_match: torch.Tensor,
                   match_cnt: torch.Tensor, match_total: torch.Tensor,
                   decl_reach: torch.Tensor) -> torch.Tensor:
    """MatchInterPodAffinity (predicates.go:825-853) -> [P,N] bool."""
    reach = match_cnt > 0.0                                      # [Sm, N]
    live = aff_need & ~(aff_self & (match_total == 0.0)[None, :])
    violate = _bmm(live, ~reach) | _bmm(anti_need, reach) | \
        _bmm(decl_match, decl_reach)
    return ~violate


def priority_counts(pref_w: torch.Tensor, match_cnt: torch.Tensor,
                    sym_match: torch.Tensor, sym_w: torch.Tensor,
                    sym_cnt: torch.Tensor) -> torch.Tensor:
    """CalculateInterPodAffinityPriority's raw counts
    (interpod_affinity.go:148-196): the candidate's preferred +-w terms
    against matching existing pods, plus the symmetric part.

    Every operand is a whole number, so the sums are taken in float64,
    exact below 2^53 in any order, and rounded to f32 once: an f32
    product would round a count past 2,048 under TF32 matmul precision,
    and past 2^24 in an order of its own; the scan kernel sums the same
    terms in f64 and rounds once too."""
    f64 = torch.float64
    own = pref_w.to(f64) @ match_cnt.to(f64)
    sym = (sym_match.to(f64) * sym_w.to(f64)[None, :]) @ sym_cnt.to(f64)
    return (own + sym).float()


def priority_score(counts: torch.Tensor, schedulable: torch.Tensor,
                   trunc, bounds: "tuple | None" = None) -> torch.Tensor:
    """0-anchored min-max to 0-10 ints (interpod_affinity.go:222-244),
    normalized over the ready nodes only.  ``bounds``, when given, is
    (max, min) [P] of the ready nodes' counts over a wider node axis
    than these columns (a node shard of parallel/mesh.py)."""
    inf = float("inf")
    if bounds is None:
        bounds = (torch.where(schedulable[None, :], counts, -inf)
                  .amax(dim=1),
                  torch.where(schedulable[None, :], counts, inf)
                  .amin(dim=1))
    max_c = torch.clamp(bounds[0], min=0.0)
    min_c = torch.clamp(bounds[1], max=0.0)
    denom = (max_c - min_c)[:, None]
    score = trunc(10.0 * (counts - min_c[:, None])
                  / torch.clamp(denom, min=1e-9))
    return torch.where(denom > 0, score, 0.0)


def place_update(node_dom: torch.Tensor,
                 match_key: torch.Tensor, match_cnt: torch.Tensor,
                 match_total: torch.Tensor, match_src_i: torch.Tensor,
                 decl_key: torch.Tensor, decl_reach: torch.Tensor,
                 decl_src_i: torch.Tensor,
                 sym_key: torch.Tensor, sym_cnt: torch.Tensor,
                 sym_src_i: torch.Tensor,
                 choice: torch.Tensor, placed: torch.Tensor):
    """Sequential-visibility state update: pod i placed on ``choice``
    becomes an existing pod for every later pod (the batched AssumePod).
    ``choice`` and ``placed`` are one-element device tensors.  Returns
    (match_cnt, match_total, decl_reach, sym_cnt) updated."""
    ok = placed.float()
    safe = torch.clamp(choice, min=0).long()
    m_rows = topo_rows(node_dom, match_key, safe).float()
    match_cnt = match_cnt + ok * match_src_i.float()[:, None] * m_rows
    match_total = match_total + ok * match_src_i.float()
    d_rows = topo_rows(node_dom, decl_key, safe)
    decl_reach = decl_reach | (placed & decl_src_i[:, None] & d_rows)
    y_rows = topo_rows(node_dom, sym_key, safe).float()
    sym_cnt = sym_cnt + ok * sym_src_i.float()[:, None] * y_rows
    return match_cnt, match_total, decl_reach, sym_cnt
