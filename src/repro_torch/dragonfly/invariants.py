"""Cross-topology structural invariants (docs/topology.md).

Every topology in the family must satisfy the same battery of checks,
whatever its internal link-id arithmetic.  The battery is shared by the
property-test harness (tests/test_topology_family.py) and the headless
CI gate (``scripts/ci_lint.py --topology``): each ``check_*`` function
raises ``InvariantViolation`` with a topology-labelled message, and
``check_all`` runs the full battery on sampled (src, dst) pairs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.dragonfly.topology import PAD, Topology

__all__ = [
    "InvariantViolation",
    "check_all",
    "check_candidates",
    "check_capacity_scale",
    "check_fault_mask",
    "check_link_ranges",
    "check_router_radix",
    "sample_pairs",
]


class InvariantViolation(AssertionError):
    """A topology broke one of the family-wide structural invariants."""


def _fail(topo: Topology, msg: str):
    raise InvariantViolation(f"[{topo.spec_str()}] {msg}")


def sample_pairs(topo: Topology, n: int = 256, seed: int = 1):
    """Deterministic (src, dst) sample with src != dst, covering intra-
    and inter-group pairs."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.n_nodes, size=n)
    dst = (src + rng.integers(1, topo.n_nodes, size=n)) % topo.n_nodes
    return src, dst


def check_link_ranges(topo: Topology) -> None:
    """link_ranges() partitions [0, n_links) with no gaps or overlaps,
    and one 'nic' range of n_nodes injection links comes last."""
    ranges = topo.link_ranges()
    if "nic" not in ranges:
        _fail(topo, "link_ranges() has no 'nic' class")
    spans = sorted(ranges.values())
    if not spans or spans[0][0] != 0 or spans[-1][1] != topo.n_links:
        _fail(topo, f"link ranges {ranges} do not span [0, {topo.n_links})")
    for (_, b), (c, _) in zip(spans, spans[1:]):
        if b != c:
            _fail(topo, f"link ranges {ranges} gap/overlap at {b} vs {c}")
    lo, hi = ranges["nic"]
    if hi - lo != topo.n_nodes or hi != topo.n_links:
        _fail(topo, f"nic range {ranges['nic']} is not the trailing "
                    f"{topo.n_nodes} links")
    nic = topo.nic_link(np.arange(topo.n_nodes))
    if not (np.array_equal(nic, np.arange(lo, hi))):
        _fail(topo, "nic_link() disagrees with the 'nic' link range")
    for kind, (lo, hi) in ranges.items():
        if topo.link_kind(lo) != kind or topo.link_kind(hi - 1) != kind:
            _fail(topo, f"link_kind() disagrees with range for {kind!r}")


def check_router_radix(topo: Topology) -> None:
    """Measured outgoing router->router degree (from link_endpoints)
    matches the spec-side expected_router_degree."""
    sr, dr = topo.link_endpoints()
    if sr.shape != (topo.n_links,) or dr.shape != (topo.n_links,):
        _fail(topo, "link_endpoints() arrays are not [n_links]")
    lo, hi = topo.link_ranges()["nic"]
    if not (sr[lo:hi] == -1).all():
        _fail(topo, "nic links must have src_router == -1 (node side)")
    want_dr = topo.router_of_node(np.arange(topo.n_nodes))
    if not np.array_equal(dr[lo:hi], want_dr):
        _fail(topo, "nic links must land on router_of_node")
    deg = np.bincount(sr[sr >= 0], minlength=topo.n_routers)
    exp = np.asarray(topo.expected_router_degree())
    if exp.shape != (topo.n_routers,):
        _fail(topo, "expected_router_degree() is not [n_routers]")
    if not np.array_equal(deg, exp):
        bad = np.flatnonzero(deg != exp)[:5]
        _fail(topo, f"router radix mismatch at routers {bad.tolist()}: "
                    f"measured {deg[bad].tolist()} vs spec "
                    f"{exp[bad].tolist()}")


def check_candidates(topo: Topology, src, dst, *, rng=None,
                     n_min: int = 2, n_nonmin: int = 2) -> None:
    """candidates() paths are valid link-id sequences: in range, on
    physical router-router links, contiguous (consecutive links share a
    router), starting/ending at the src/dst routers, within the hop
    bounds, and (when the topology claims it) inter-group Valiant paths
    transit exactly one intermediate group."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    links, is_nonmin = topo.candidates(src, dst, rng, n_min=n_min,
                                       n_nonmin=n_nonmin)
    n = src.shape[0]
    if links.shape != (n, n_min + n_nonmin, topo.MAX_HOPS):
        _fail(topo, f"candidates() shape {links.shape} != "
                    f"{(n, n_min + n_nonmin, topo.MAX_HOPS)}")
    if list(is_nonmin) != [False] * n_min + [True] * n_nonmin:
        _fail(topo, f"is_nonmin {is_nonmin} is not minimal-then-Valiant")
    valid = links != PAD
    flat = links[valid]
    if flat.size and (flat.min() < 0 or flat.max() >= topo.n_links):
        _fail(topo, "candidate entries outside [0, n_links)")
    sr, dr = topo.link_endpoints()
    nic_lo, _ = topo.link_ranges()["nic"]
    if flat.size and (flat >= nic_lo).any():
        _fail(topo, "candidate paths must not contain NIC links")
    if flat.size and (sr[flat] < 0).any():
        _fail(topo, "candidate paths use non-physical link slots")
    hops = valid.sum(axis=2)
    if hops[:, ~is_nonmin].max(initial=0) > topo.max_minimal_hops:
        _fail(topo, f"minimal path exceeds max_minimal_hops="
                    f"{topo.max_minimal_hops}")
    if hops[:, is_nonmin].max(initial=0) > topo.max_nonmin_hops:
        _fail(topo, f"Valiant path exceeds max_nonmin_hops="
                    f"{topo.max_nonmin_hops}")
    r_src = np.asarray(topo.router_of_node(src))
    r_dst = np.asarray(topo.router_of_node(dst))
    g_src = np.asarray(topo.group_of_node(src))
    g_dst = np.asarray(topo.group_of_node(dst))
    for i in range(n):
        for c in range(links.shape[1]):
            path = links[i, c][valid[i, c]]
            if path.size == 0:
                if src[i] != dst[i] and r_src[i] != r_dst[i]:
                    _fail(topo, f"empty path for cross-router pair "
                                f"({src[i]}, {dst[i]})")
                continue
            if sr[path[0]] != r_src[i]:
                _fail(topo, f"path for ({src[i]},{dst[i]}) cand {c} does "
                            f"not start at the src router")
            if dr[path[-1]] != r_dst[i]:
                _fail(topo, f"path for ({src[i]},{dst[i]}) cand {c} does "
                            f"not end at the dst router")
            if (dr[path[:-1]] != sr[path[1:]]).any():
                _fail(topo, f"path for ({src[i]},{dst[i]}) cand {c} is "
                            f"not contiguous")
            if (topo.valiant_transits_group and is_nonmin[c]
                    and g_src[i] != g_dst[i]):
                routers = np.concatenate([sr[path], dr[path]])
                grp = np.unique(topo.group_of_router(routers))
                mid = set(grp.tolist()) - {int(g_src[i]), int(g_dst[i])}
                if int(g_src[i]) not in grp or int(g_dst[i]) not in grp \
                        or len(mid) != 1:
                    _fail(topo, f"Valiant path for ({src[i]},{dst[i]}) "
                                f"cand {c} transits groups {sorted(mid)} "
                                f"(want exactly one)")


def check_capacity_scale(topo: Topology, state) -> None:
    """A FaultState's capacity_scale is a well-formed per-link scale:
    float64 [n_links], finite, in [0, 1], with ``dead`` exactly the
    (near-)zero entries."""
    scale = np.asarray(state.capacity_scale)
    if scale.shape != (topo.n_links,):
        _fail(topo, f"capacity_scale shape {scale.shape} != "
                    f"({topo.n_links},)")
    if scale.dtype != np.float64:
        _fail(topo, f"capacity_scale dtype {scale.dtype} != float64")
    if not np.isfinite(scale).all():
        _fail(topo, "capacity_scale has non-finite entries")
    if scale.min(initial=1.0) < 0.0 or scale.max(initial=0.0) > 1.0:
        _fail(topo, "capacity_scale outside [0, 1]")
    dead = np.asarray(state.dead)
    if dead.shape != scale.shape or dead.dtype != bool:
        _fail(topo, "dead mask shape/dtype mismatch with capacity_scale")
    if not np.array_equal(dead, scale <= 1e-9):
        _fail(topo, "dead mask disagrees with capacity_scale zeros")


def check_fault_mask(topo: Topology, dead, src, dst, *, rng=None,
                     n_min: int = 2, n_nonmin: int = 2) -> None:
    """Fault-mask semantics over the PAD-padded candidate tensors
    (docs/faults.md): the vectorized mask the simulator derives from a
    dead-link flag array must agree with a per-path scalar recheck —

      * a candidate survives iff NO link on its path is dead (PAD
        entries never count: the mask gather must not be poisoned by
        the `safe` placeholder link 0, even when link 0 itself dies);
      * masking never rewrites the candidate tensor: the PAD layout is
        untouched (the mask lives beside the tensor, never inside it),
        so surviving candidates keep their exact PAD-masked paths;
      * reachability accounting: a flow is stranded iff every candidate
        crosses a dead link (endpoint-NIC deaths are checked by the
        simulator on top of this).
    """
    dead = np.asarray(dead, dtype=bool)
    if dead.shape != (topo.n_links,):
        _fail(topo, f"dead mask shape {dead.shape} != ({topo.n_links},)")
    src = np.asarray(src)
    dst = np.asarray(dst)
    links, is_nonmin = topo.candidates(src, dst, rng, n_min=n_min,
                                       n_nonmin=n_nonmin)
    frozen = links.copy()
    valid = links != PAD
    safe = np.where(valid, links, 0)
    cand_alive = ~((dead[safe] & valid).any(axis=-1))
    stranded = ~cand_alive.any(axis=-1)
    if not np.array_equal(links, frozen):
        _fail(topo, "mask computation mutated the candidate tensor")
    # PAD-placeholder immunity: PAD slots gather link 0 through `safe`;
    # killing link 0 must only ever change candidates whose PATH truly
    # contains link 0 — never a candidate that merely has PAD slots
    dead0 = dead.copy()
    dead0[0] = True
    alive0 = ~((dead0[safe] & valid).any(axis=-1))
    contains0 = ((links == 0) & valid).any(axis=-1)
    if ((alive0 != cand_alive) & ~contains0).any():
        _fail(topo, "PAD placeholder poisons the fault mask when link 0 "
                    "is dead")
    # scalar recheck, flow by flow
    for i in range(src.shape[0]):
        for c in range(links.shape[1]):
            path = links[i, c][valid[i, c]]
            want = not dead[path].any() if path.size else True
            if bool(cand_alive[i, c]) != want:
                _fail(topo, f"fault mask disagrees with scalar recheck "
                            f"for pair ({src[i]},{dst[i]}) cand {c}")
        if bool(stranded[i]) != (not any(
                not dead[links[i, c][valid[i, c]]].any()
                if valid[i, c].any() else True
                for c in range(links.shape[1]))):
            _fail(topo, f"stranded accounting wrong for pair "
                        f"({src[i]},{dst[i]})")
    # the mask must never kill a candidate on a healthy machine
    if not dead.any() and not cand_alive.all():
        _fail(topo, "mask kills candidates with no dead links")


def check_all(topo: Topology, *, n_pairs: int = 256, seed: int = 1) -> None:
    """The full battery on a deterministic pair sample."""
    check_link_ranges(topo)
    check_router_radix(topo)
    src, dst = sample_pairs(topo, n=n_pairs, seed=seed)
    check_candidates(topo, src, dst, rng=np.random.default_rng(seed + 6))
