"""Cray Aries Dragonfly topology — paper §2.1.

Connectivity tiers (Aries/Cascade):
  * group: 6 chassis x 16 blades; each blade has one Aries router + 4 nodes;
  * intra-chassis: every router connects to the other 15 in its chassis
    (15 tiles);
  * intra-group "row" links: every router connects to the 5 routers in the
    same blade slot of the other chassis (3 tiles per connection);
  * inter-group: up to 10 optical links per router; systems bundle several
    tiles per group pair.  We expose `global_links_per_pair` parallel links
    per group pair, attached to deterministic (chassis, blade) gateway slots.

Link ids are arithmetic so the simulator can vectorize over flows:
  [0, n_chassis_links)                 chassis links  (g, c, min(b), max(b))
  [+0, n_row_links)                    row links      (g, min(c), max(c), b)
  [+0, n_global_links)                 global links   (min(g), max(g), k)
  [+0, n_nodes)                        NIC injection links (one per node)

A *path* is a sequence of link ids (NIC link excluded; the simulator charges
injection separately).  Minimal inter-group paths have <= 5 router-router
hops, matching Figure 1's 5-hop example; non-minimal (Valiant) paths go
through an intermediate group and have <= 8 hops (10 on the largest systems
per §2.2 — we cap per topology size).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

PAD = -1  # path padding entry


def balanced_global_count(a: int, h: int) -> int:
    """The balanced-dragonfly rule ``g = a*h + 1`` (every pair of groups
    gets exactly one global link when each of the `a` routers per group
    owns `h` global ports)."""
    return a * h + 1


class Topology:
    """Abstract base of the topology family (docs/topology.md).

    A concrete topology is a router graph with arithmetic DIRECTED link
    ids plus one NIC injection link per node, exposing exactly the
    surface the simulator, allocations, and the invariant harness
    consume.  Subclasses set in ``__init__``:

      n_links, n_nodes, n_routers, n_groups   sizes
      nodes_per_group                         node ids are contiguous per
                                              group: node // nodes_per_group
                                              is its group
      nodes_per_router, n_node_routers        node ids are contiguous per
                                              node-hosting router
      capacity_gbs                            float64 [n_links], GB/s/dir
      hop_latency_ns, nic_latency_ns          fixed per-hop / NIC latency
      max_minimal_hops, max_nonmin_hops       hop bounds checked by
                                              repro.dragonfly.invariants
      valiant_transits_group                  True when inter-group Valiant
                                              paths visit exactly one
                                              intermediate group

    and implement ``link_ranges``, ``link_endpoints``,
    ``expected_router_degree``, ``router_of_node`` and
    ``candidate_paths``.  ``candidates()`` is the stable front door.
    """

    name: str = "abstract"
    MAX_HOPS = 8
    valiant_transits_group: bool = True

    # ------------------------------------------------------------- structure
    def link_ranges(self) -> dict:
        """{kind: (lo, hi)} — half-open link-id ranges, one per link
        class, partitioning [0, n_links)."""
        raise NotImplementedError

    def link_endpoints(self):
        """(src_router, dst_router) int64 [n_links] arrays.

        NIC links have ``src == -1`` (node side) and ``dst`` the host
        router; arithmetic slots that no physical link occupies (e.g.
        diagonal / non-canonical pair encodings) are (-1, -1)."""
        raise NotImplementedError

    def expected_router_degree(self) -> np.ndarray:
        """Spec-side outgoing router-router degree per router, checked
        against the measured ``link_endpoints`` degrees."""
        raise NotImplementedError

    def router_of_node(self, node):
        raise NotImplementedError

    def group_of_node(self, node):
        return np.asarray(node) // self.nodes_per_group

    def group_of_router(self, router):
        raise NotImplementedError

    def link_kind(self, link: int) -> str:
        for kind, (lo, hi) in self.link_ranges().items():
            if lo <= link < hi:
                return kind
        raise ValueError(f"link id {link} out of range")

    def nic_link(self, node):
        raise NotImplementedError

    # --------------------------------------------------------------- routing
    def candidate_paths(self, src, dst, rng, n_min: int = 2,
                        n_nonmin: int = 2):
        """(links [n, n_min+n_nonmin, MAX_HOPS] PAD-padded,
        is_nonmin [n_min+n_nonmin]) — minimal then Valiant candidates."""
        raise NotImplementedError

    def candidates(self, src, dst, rng=None, *, n_min: int = 2,
                   n_nonmin: int = 2):
        """The Topology front door: padded minimal + Valiant path arrays
        for each (src, dst) node pair.  ``rng`` seeds the per-flow
        candidate draw (global-link / intermediate-group choices); None
        means a fresh deterministic generator."""
        if rng is None:
            rng = np.random.default_rng(0)
        return self.candidate_paths(src, dst, rng, n_min=n_min,
                                    n_nonmin=n_nonmin)

    # ------------------------------------------------------------------ misc
    def spec_str(self) -> str:
        """Short human/JSON label, e.g. ``dragonfly(p=2,a=4,h=2,g=9)``."""
        return self.name

    def describe(self) -> dict:
        """JSON-able summary for benchmark records."""
        return {"spec": self.spec_str(), "n_links": int(self.n_links),
                "n_nodes": int(self.n_nodes),
                "n_routers": int(self.n_routers),
                "n_groups": int(self.n_groups)}


# ----------------------------------------------------------------- registry
@dataclass(frozen=True)
class TopologyEntry:
    """One registered topology: a factory plus small-scale kwargs the
    invariant harness (tests + ``ci_lint.py --topology``) instantiates."""

    name: str
    factory: Callable
    small: Mapping


TOPOLOGY_REGISTRY: dict = {}


def register_topology(name: str, factory: Callable, *, small: Mapping
                      ) -> None:
    TOPOLOGY_REGISTRY[name] = TopologyEntry(name, factory, dict(small))


def registered_topologies() -> list:
    _load_families()
    return sorted(TOPOLOGY_REGISTRY)


def small_topology(name: str) -> "Topology":
    """The registered small-scale instance (invariant harness scale)."""
    _load_families()
    e = TOPOLOGY_REGISTRY[name]
    return e.factory(**e.small)


def _load_families():
    # families.py registers itself on import; imported lazily to avoid a
    # topology <-> families cycle at module load.
    import repro_torch.dragonfly.families  # noqa: F401


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def make_topology(spec, **overrides) -> "Topology":
    """Build a topology from a spec.

    spec: a Topology instance (returned as-is), a registered name
    ("aries", "dragonfly", ...), or "name:k=v,k2=v2" with int/float/str
    values (e.g. ``"dragonfly:p=2,a=4,h=2"``).  The ``name(k=v,...)``
    form emitted by ``Topology.spec_str()`` is accepted too, so recorded
    specs round-trip.  Keyword overrides win over the spec string's
    kwargs."""
    if isinstance(spec, Topology):
        return spec
    _load_families()
    spec = str(spec)
    if "(" in spec and spec.endswith(")"):
        name, _, argstr = spec[:-1].partition("(")
    else:
        name, _, argstr = spec.partition(":")
    if name not in TOPOLOGY_REGISTRY:
        raise ValueError(f"unknown topology {name!r}; registered: "
                         f"{registered_topologies()}")
    kwargs = {}
    if argstr:
        for item in argstr.split(","):
            k, _, v = item.partition("=")
            if not _ or not k:
                raise ValueError(f"bad topology spec item {item!r} "
                                 f"(want k=v)")
            kwargs[k.strip()] = _coerce(v.strip())
    kwargs.update(overrides)
    return TOPOLOGY_REGISTRY[name].factory(**kwargs)


@dataclass(frozen=True)
class TopologyParams:
    n_groups: int = 12
    chassis_per_group: int = 6
    blades_per_chassis: int = 16
    nodes_per_blade: int = 4
    global_links_per_pair: int = 4
    # Bandwidths, paper §2.1: 4.7 (optical) .. 5.25 (electrical) GB/s/dir.
    electrical_gbs: float = 5.25
    optical_gbs: float = 4.7
    nic_gbs: float = 10.0           # x16 PCIe Gen3 ~ 10+ GB/s effective
    hop_latency_ns: float = 100.0   # per router-router hop
    nic_latency_ns: float = 600.0   # NIC+PCIe fixed overhead per direction

    @property
    def routers_per_group(self) -> int:
        return self.chassis_per_group * self.blades_per_chassis

    @property
    def n_routers(self) -> int:
        return self.n_groups * self.routers_per_group

    @property
    def n_nodes(self) -> int:
        return self.n_routers * self.nodes_per_blade


class DragonflyTopology(Topology):
    """The canonical Cray Aries layout (the paper's machine) — the
    topology-family default; link ids, capacities and candidate paths
    are pinned bit-identical to the pre-family code by
    tests/test_topology_family.py."""

    name = "aries"
    max_minimal_hops = 5     # Fig. 1's 5-hop example
    max_nonmin_hops = 8

    def __init__(self, params: TopologyParams = TopologyParams()):
        p = self.params = params
        G, C, B = p.n_groups, p.chassis_per_group, p.blades_per_chassis
        # Links are DIRECTED (Aries links are full duplex: one channel per
        # direction) — each undirected pair gets 2 ids via a parity bit.
        self.n_chassis_links = G * C * B * B * 2      # (g,c,b1,b2,dir)
        self.n_row_links = G * C * C * B * 2          # (g,c1,c2,b,dir)
        self.n_global_links = G * G * p.global_links_per_pair * 2
        self._row_off = self.n_chassis_links
        self._glob_off = self._row_off + self.n_row_links
        self._nic_off = self._glob_off + self.n_global_links
        self.n_links = self._nic_off + p.n_nodes
        # per-link capacity (GB/s)
        cap = np.full(self.n_links, p.electrical_gbs, dtype=np.float64)
        cap[self._glob_off:self._nic_off] = p.optical_gbs
        cap[self._nic_off:] = p.nic_gbs
        self.capacity_gbs = cap

    # -------------------------------------------------- Topology protocol
    @property
    def n_nodes(self) -> int:
        return self.params.n_nodes

    @property
    def n_routers(self) -> int:
        return self.params.n_routers

    @property
    def n_groups(self) -> int:
        return self.params.n_groups

    @property
    def nodes_per_group(self) -> int:
        return self.params.routers_per_group * self.params.nodes_per_blade

    @property
    def nodes_per_router(self) -> int:
        return self.params.nodes_per_blade

    @property
    def n_node_routers(self) -> int:
        return self.params.n_routers    # every Aries router hosts nodes

    @property
    def hop_latency_ns(self) -> float:
        return self.params.hop_latency_ns

    @property
    def nic_latency_ns(self) -> float:
        return self.params.nic_latency_ns

    def router_of_node(self, node):
        return np.asarray(node) // self.params.nodes_per_blade

    def group_of_router(self, router):
        return np.asarray(router) // self.params.routers_per_group

    def spec_str(self) -> str:
        p = self.params
        return (f"aries(n_groups={p.n_groups},"
                f"chassis_per_group={p.chassis_per_group},"
                f"blades_per_chassis={p.blades_per_chassis},"
                f"nodes_per_blade={p.nodes_per_blade},"
                f"global_links_per_pair={p.global_links_per_pair})")

    def link_ranges(self) -> dict:
        return {"chassis": (0, self._row_off),
                "row": (self._row_off, self._glob_off),
                "global": (self._glob_off, self._nic_off),
                "nic": (self._nic_off, self.n_links)}

    def link_endpoints(self):
        p = self.params
        G, C, B = p.n_groups, p.chassis_per_group, p.blades_per_chassis
        K = p.global_links_per_pair
        src = np.full(self.n_links, -1, dtype=np.int64)
        dst = np.full(self.n_links, -1, dtype=np.int64)
        # chassis: base = ((g*C + c)*B + lo)*B + hi, id = base*2 + (b1>b2)
        ids = np.arange(self.n_chassis_links)
        base, dirb = np.divmod(ids, 2)
        hi = base % B
        lo = (base // B) % B
        c = (base // (B * B)) % C
        g = base // (B * B * C)
        ok = lo < hi
        r_lo = (g * C + c) * B + lo
        r_hi = (g * C + c) * B + hi
        src[ids[ok]] = np.where(dirb[ok] == 1, r_hi[ok], r_lo[ok])
        dst[ids[ok]] = np.where(dirb[ok] == 1, r_lo[ok], r_hi[ok])
        # row: base = ((g*C + lo)*C + hi)*B + b, id = off + base*2 + (c1>c2)
        ids = np.arange(self.n_row_links)
        base, dirb = np.divmod(ids, 2)
        b = base % B
        hi = (base // B) % C
        lo = (base // (B * C)) % C
        g = base // (B * C * C)
        ok = lo < hi
        r_lo = (g * C + lo) * B + b
        r_hi = (g * C + hi) * B + b
        src[self._row_off + ids[ok]] = np.where(dirb[ok] == 1,
                                                r_hi[ok], r_lo[ok])
        dst[self._row_off + ids[ok]] = np.where(dirb[ok] == 1,
                                                r_lo[ok], r_hi[ok])
        # global: base = (lo*G + hi)*K + k, id = off + base*2 + (g1>g2)
        ids = np.arange(self.n_global_links)
        base, dirb = np.divmod(ids, 2)
        k = base % K
        hi = (base // K) % G
        lo = base // (K * G)
        ok = lo < hi
        g_src = np.where(dirb == 1, hi, lo)
        g_dst = np.where(dirb == 1, lo, hi)
        sc, sb = self.gateway_router(g_src, g_dst, k)
        dc, db = self.gateway_router(g_dst, g_src, k)
        R, Bc = self.params.routers_per_group, B
        src[self._glob_off + ids[ok]] = (g_src * C + sc)[ok] * Bc + sb[ok]
        dst[self._glob_off + ids[ok]] = (g_dst * C + dc)[ok] * Bc + db[ok]
        del R
        # nic: node-side injection (src = -1 marks the node end)
        nodes = np.arange(p.n_nodes)
        dst[self._nic_off:] = self.router_of_node(nodes)
        return src, dst

    def expected_router_degree(self) -> np.ndarray:
        """(B-1) chassis + (C-1) row + owned gateway slots, per router."""
        p = self.params
        G, K = p.n_groups, p.global_links_per_pair
        deg = np.full(p.n_routers,
                      (p.blades_per_chassis - 1) + (p.chassis_per_group - 1),
                      dtype=np.int64)
        for g_here in range(G):
            for g_there in range(G):
                if g_here == g_there:
                    continue
                ks = np.arange(K)
                c, b = self.gateway_router(g_here, np.full(K, g_there), ks)
                r = (g_here * p.chassis_per_group + c) \
                    * p.blades_per_chassis + b
                np.add.at(deg, r, 1)
        return deg

    # ------------------------------------------------------------- addressing
    def node_coords(self, node: np.ndarray | int):
        """node id -> (group, chassis, blade, slot)."""
        p = self.params
        node = np.asarray(node)
        router, slot = divmod(node, p.nodes_per_blade)
        group, r_in_g = divmod(router, p.routers_per_group)
        chassis, blade = divmod(r_in_g, p.blades_per_chassis)
        return group, chassis, blade, slot

    def node_id(self, group: int, chassis: int, blade: int, slot: int) -> int:
        p = self.params
        return ((group * p.chassis_per_group + chassis)
                * p.blades_per_chassis + blade) * p.nodes_per_blade + slot

    def nic_link(self, node: np.ndarray | int):
        return self._nic_off + np.asarray(node)

    def chassis_link(self, g, c, b1, b2):
        """Directed b1 -> b2 channel of the (g, c, {b1,b2}) chassis link."""
        B = self.params.blades_per_chassis
        lo, hi = np.minimum(b1, b2), np.maximum(b1, b2)
        base = ((g * self.params.chassis_per_group + c) * B + lo) * B + hi
        return base * 2 + (b1 > b2)

    def row_link(self, g, c1, c2, b):
        """Directed c1 -> c2 channel of the (g, {c1,c2}, b) row link."""
        C = self.params.chassis_per_group
        B = self.params.blades_per_chassis
        lo, hi = np.minimum(c1, c2), np.maximum(c1, c2)
        base = ((g * C + lo) * C + hi) * B + b
        return self._row_off + base * 2 + (c1 > c2)

    def global_link(self, g1, g2, k):
        """Directed g1 -> g2 channel of global link k between the groups."""
        G = self.params.n_groups
        K = self.params.global_links_per_pair
        lo, hi = np.minimum(g1, g2), np.maximum(g1, g2)
        base = (lo * G + hi) * K + k
        return self._glob_off + base * 2 + (g1 > g2)

    def link_kind(self, link: int) -> str:
        if link < self._row_off:
            return "chassis"
        if link < self._glob_off:
            return "row"
        if link < self._nic_off:
            return "global"
        return "nic"

    # ---------------------------------------------------------- gateway slots
    def gateway_router(self, g_here, g_there, k):
        """(chassis, blade) of the router in g_here owning global link k
        toward g_there.  Deterministic spread over the group's routers."""
        R = self.params.routers_per_group
        h = (np.asarray(g_there) * self.params.global_links_per_pair
             + np.asarray(k)) * np.int64(2654435761) + np.asarray(g_here)
        r = np.abs(h) % R
        return divmod(r, self.params.blades_per_chassis)

    # ------------------------------------------------- scalar path enumeration
    def intra_group_hops(self, g, c1, b1, c2, b2, order_cb: bool = True):
        """<=2-hop minimal route within a group; `order_cb` picks
        chassis-then-row vs row-then-chassis for the 2-hop case."""
        if c1 == c2 and b1 == b2:
            return []
        if c1 == c2:
            return [self.chassis_link(g, c1, b1, b2)]
        if b1 == b2:
            return [self.row_link(g, c1, c2, b1)]
        if order_cb:
            return [self.chassis_link(g, c1, b1, b2),
                    self.row_link(g, c1, c2, b2)]
        return [self.row_link(g, c1, c2, b1),
                self.chassis_link(g, c2, b1, b2)]

    def minimal_path(self, src_node: int, dst_node: int, k: int = 0,
                     order_seed: int = 0) -> list[int]:
        """One minimal path (router-router links only) using global link k
        for the inter-group hop."""
        g1, c1, b1, _ = self.node_coords(src_node)
        g2, c2, b2, _ = self.node_coords(dst_node)
        if g1 == g2:
            return self.intra_group_hops(g1, c1, b1, c2, b2,
                                         order_cb=bool((order_seed + k) % 2))
        gc1, gb1 = self.gateway_router(g1, g2, k)
        gc2, gb2 = self.gateway_router(g2, g1, k)
        path = self.intra_group_hops(g1, c1, b1, int(gc1), int(gb1),
                                     order_cb=bool(order_seed % 2))
        path.append(int(self.global_link(g1, g2, k)))
        path += self.intra_group_hops(g2, int(gc2), int(gb2), c2, b2,
                                      order_cb=bool((order_seed // 2) % 2))
        return path

    def nonminimal_path(self, src_node: int, dst_node: int, gi: int,
                        k1: int = 0, k2: int = 0) -> list[int]:
        """Valiant path through intermediate group gi (for intra-group flows
        gi is interpreted as an intermediate *router* seed)."""
        g1, c1, b1, _ = self.node_coords(src_node)
        g2, c2, b2, _ = self.node_coords(dst_node)
        if g1 == g2:
            # Non-minimal within a group: detour via intermediate router.
            R = self.params.routers_per_group
            r = (gi * 40503 + 7) % R
            ci, bi = divmod(r, self.params.blades_per_chassis)
            return (self.intra_group_hops(g1, c1, b1, ci, bi) +
                    self.intra_group_hops(g1, ci, bi, c2, b2, order_cb=False))
        gi = gi % self.params.n_groups
        if gi in (g1, g2):
            gi = (gi + 1) % self.params.n_groups
            if gi in (g1, g2):
                gi = (gi + 1) % self.params.n_groups
        # src group -> gi
        gc1, gb1 = self.gateway_router(g1, gi, k1)
        path = self.intra_group_hops(g1, c1, b1, int(gc1), int(gb1))
        path.append(int(self.global_link(g1, gi, k1)))
        # across gi: entry router -> exit gateway
        ec, eb = self.gateway_router(gi, g1, k1)
        xc, xb = self.gateway_router(gi, g2, k2)
        path += self.intra_group_hops(gi, int(ec), int(eb), int(xc), int(xb))
        path.append(int(self.global_link(gi, g2, k2)))
        # entry in g2 -> dst
        gc2, gb2 = self.gateway_router(g2, gi, k2)
        path += self.intra_group_hops(g2, int(gc2), int(gb2), c2, b2,
                                      order_cb=False)
        return path

    # ------------------------------------------------ vectorized candidates
    MAX_HOPS = 8

    def _intra_vec(self, g, c1, b1, c2, b2, order_cb):
        """Vectorized <=2-hop intra-group route. All args int64 [n];
        order_cb bool [n]. Returns [n, 2] PAD-padded link ids."""
        n = g.shape[0]
        out = np.full((n, 2), PAD, dtype=np.int64)
        same = (c1 == c2) & (b1 == b2)
        samec = (c1 == c2) & ~same
        sameb = (b1 == b2) & ~same
        two = ~(same | samec | sameb)
        cl = self.chassis_link(g, c1, b1, b2)
        rl = self.row_link(g, c1, c2, b1)
        out[samec, 0] = cl[samec]
        out[sameb, 0] = rl[sameb]
        cb2 = self.row_link(g, c1, c2, b2)
        rc2 = self.chassis_link(g, c2, b1, b2)
        use_cb = two & order_cb
        use_rc = two & ~order_cb
        out[use_cb, 0] = cl[use_cb]
        out[use_cb, 1] = cb2[use_cb]
        out[use_rc, 0] = rl[use_rc]
        out[use_rc, 1] = rc2[use_rc]
        return out

    def _minimal_vec(self, g1, c1, b1, g2, c2, b2, k, order_seed):
        """Vectorized minimal path -> [n, MAX_HOPS] (slots 5.. are PAD)."""
        n = g1.shape[0]
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        intra = g1 == g2
        gc1, gb1 = self.gateway_router(g1, g2, k)
        # src-side target: dst coords for intra flows, gateway otherwise
        tc = np.where(intra, c2, gc1)
        tb = np.where(intra, b2, gb1)
        out[:, 0:2] = self._intra_vec(g1, c1, b1, tc, tb,
                                      ((order_seed + k) % 2 == 1) & intra
                                      | (order_seed % 2 == 1) & ~intra)
        gl = self.global_link(g1, g2, k)
        inter = ~intra
        out[inter, 2] = gl[inter]
        gc2, gb2 = self.gateway_router(g2, g1, k)
        dst_side = self._intra_vec(g2, gc2, gb2, c2, b2,
                                   (order_seed // 2) % 2 == 1)
        out[inter, 3:5] = dst_side[inter]
        return out

    def _nonmin_vec(self, g1, c1, b1, g2, c2, b2, gi, k1, k2):
        """Vectorized Valiant path -> [n, MAX_HOPS]."""
        n = g1.shape[0]
        G = self.params.n_groups
        R = self.params.routers_per_group
        B = self.params.blades_per_chassis
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        intra = g1 == g2
        # --- intra-group detour via intermediate router (seed = raw gi)
        r = (gi * 40503 + 7) % R
        ci, bi = divmod(r, B)
        seg_a = self._intra_vec(g1, c1, b1, ci, bi, np.ones(n, dtype=bool))
        seg_b = self._intra_vec(g1, ci, bi, c2, b2, np.zeros(n, dtype=bool))
        out[intra, 0:2] = seg_a[intra]
        out[intra, 2:4] = seg_b[intra]
        # --- inter-group Valiant through gi (collision-adjusted like scalar)
        gim = gi % G
        gim = np.where((gim == g1) | (gim == g2), (gim + 1) % G, gim)
        gim = np.where((gim == g1) | (gim == g2), (gim + 1) % G, gim)
        ones = np.ones(n, dtype=bool)
        gc1, gb1 = self.gateway_router(g1, gim, k1)
        seg1 = self._intra_vec(g1, c1, b1, gc1, gb1, ones)
        glob1 = self.global_link(g1, gim, k1)
        ec, eb = self.gateway_router(gim, g1, k1)
        xc, xb = self.gateway_router(gim, g2, k2)
        seg2 = self._intra_vec(gim, ec, eb, xc, xb, ones)
        glob2 = self.global_link(gim, g2, k2)
        gc2, gb2 = self.gateway_router(g2, gim, k2)
        seg3 = self._intra_vec(g2, gc2, gb2, c2, b2, ~ones)
        inter = ~intra
        out[inter, 0:2] = seg1[inter]
        out[inter, 2] = glob1[inter]
        out[inter, 3:5] = seg2[inter]
        out[inter, 5] = glob2[inter]
        out[inter, 6:8] = seg3[inter]
        return out

    def candidate_paths(self, src: np.ndarray, dst: np.ndarray,
                        rng: np.random.Generator, n_min: int = 2,
                        n_nonmin: int = 2):
        """Vectorized candidate generation (paper §2.2: two minimal and two
        non-minimal paths are randomly selected per packet).

        Returns (links, is_nonmin):
          links:     int64 [n_flows, n_min+n_nonmin, MAX_HOPS], PAD-filled
          is_nonmin: bool  [n_min+n_nonmin]
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n = src.shape[0]
        K = self.params.global_links_per_pair
        G = self.params.n_groups
        ncand = n_min + n_nonmin
        g1, c1, b1, _ = self.node_coords(src)
        g2, c2, b2, _ = self.node_coords(dst)
        # Aries draws 2 minimal + 2 non-minimal candidates PER PACKET; over a
        # whole message the union of draws covers all K global links.  The
        # fluid equivalent: the n_min minimal candidates use DISTINCT global
        # links ((k0+j) mod K), so spray weights can spread over all of them.
        k0 = rng.integers(0, K, size=n)
        gis = rng.integers(0, max(G, 1), size=(n_nonmin, n))
        knm = rng.integers(0, K, size=(2 * n_nonmin, n))
        seeds = rng.integers(0, 4, size=(n_min, n))
        cands = []
        for j in range(n_min):
            cands.append(self._minimal_vec(g1, c1, b1, g2, c2, b2,
                                           (k0 + j) % K, seeds[j]))
        for j in range(n_nonmin):
            cands.append(self._nonmin_vec(g1, c1, b1, g2, c2, b2, gis[j],
                                          knm[2 * j], knm[2 * j + 1]))
        links = np.stack(cands, axis=1)
        # same-node flows have no hops at all
        links[src == dst] = PAD
        is_nonmin = np.array([False] * n_min + [True] * n_nonmin)
        return links, is_nonmin

    def candidate_paths_scalar(self, src: int, dst: int, *, k: int = 0,
                               gi: int = 0, order_seed: int = 0):
        """Scalar oracle for property tests: (minimal, nonminimal) paths
        built with the pure-python enumerators."""
        mn = self.minimal_path(src, dst, k=k, order_seed=order_seed) \
            if src != dst else []
        nm = self.nonminimal_path(src, dst, gi=gi, k1=k, k2=k) \
            if src != dst else []
        return mn, nm


@dataclass(frozen=True)
class Allocation:
    """A fixed process->node mapping (paper §3.1: fix the allocation)."""

    allocation_id: str
    nodes: tuple  # node ids, rank r runs on nodes[r]

    @property
    def n_ranks(self) -> int:
        return len(self.nodes)

    def node_of(self, rank: int) -> int:
        return self.nodes[rank]


def make_allocation(topo: Topology, n_ranks: int, *, spread: str,
                    seed: int = 0, allocation_id: str | None = None
                    ) -> Allocation:
    """Build allocations matching the paper's placement tiers.

    spread: 'inter_nodes' (same blade/router), 'inter_blades' (same
            chassis; generic: same group, distinct routers),
            'inter_chassis' (same group, different chassis; generic:
            same group, strided routers),
            'inter_groups' (different groups),
            'scattered' (random over the machine — production-like),
            'contiguous' (fill blades in order).

    Works on every topology in the family: the chassis/blade tiers use
    the Aries coordinates when available and degrade to group/router
    equivalents elsewhere (RNG draws for the generic tiers are identical
    on Aries, so pre-family allocations replay bit-for-bit).
    """
    rng = np.random.default_rng(seed)
    aries = isinstance(topo, DragonflyTopology)
    npg, npr = topo.nodes_per_group, topo.nodes_per_router
    if spread == "inter_nodes":
        assert n_ranks <= npr
        base = int(rng.integers(0, topo.n_node_routers)) * npr
        nodes = [base + i for i in range(n_ranks)]
    elif spread == "inter_blades":
        p = topo.params if aries else None
        g = int(rng.integers(0, topo.n_groups))
        if aries:
            c = int(rng.integers(0, p.chassis_per_group))
            blades = rng.choice(p.blades_per_chassis,
                                size=min(n_ranks, p.blades_per_chassis),
                                replace=False)
            nodes = [topo.node_id(g, c, int(blades[i % len(blades)]),
                                  i // len(blades)) for i in range(n_ranks)]
        else:
            rpg = npg // npr            # node-routers per group
            rs = rng.choice(rpg, size=min(n_ranks, rpg), replace=False)
            nodes = [g * npg + int(rs[i % len(rs)]) * npr + i // len(rs)
                     for i in range(n_ranks)]
    elif spread == "inter_chassis":
        p = topo.params if aries else None
        g = int(rng.integers(0, topo.n_groups))
        if aries:
            cs = rng.permutation(p.chassis_per_group)
            nodes = [topo.node_id(g, int(cs[i % p.chassis_per_group]),
                                  (i // p.chassis_per_group)
                                  % p.blades_per_chassis,
                                  0) for i in range(n_ranks)]
        else:
            rpg = npg // npr
            rs = rng.permutation(rpg)
            nodes = [g * npg + int(rs[i % rpg]) * npr
                     + (i // rpg) % npr for i in range(n_ranks)]
    elif spread == "inter_groups":
        gs = rng.permutation(topo.n_groups)
        nodes = []
        for i in range(n_ranks):
            g = int(gs[i % topo.n_groups])
            j = i // topo.n_groups
            if aries:
                p = topo.params
                c, rem = divmod(j, p.blades_per_chassis)
                nodes.append(topo.node_id(g, c % p.chassis_per_group,
                                          rem, 0))
            else:
                nodes.append(g * npg + (j * npr) % npg)
    elif spread.startswith("groups:"):
        # production-style: ranks packed into a random subset of k groups
        # (paper Fig. 8: 1024 nodes on 257 routers spanning 6 groups)
        k = min(int(spread.split(":")[1]), topo.n_groups)
        # widen the subset when k groups cannot hold n_ranks (small
        # non-Aries machines): capacity first, requested locality second
        k = min(topo.n_groups, max(k, -(-n_ranks // npg)))
        gs = rng.choice(topo.n_groups, size=k, replace=False)
        pool = np.stack([
            g * npg + rng.permutation(npg)
            for g in gs])                       # [k, nodes_per_group]
        # interleave across the chosen groups (rank i -> group i mod k)
        nodes = list(pool.T.ravel()[:n_ranks])
    elif spread == "scattered":
        nodes = list(rng.choice(topo.n_nodes, size=n_ranks, replace=False))
    elif spread == "contiguous":
        start = int(rng.integers(0, max(1, topo.n_nodes - n_ranks)))
        nodes = list(range(start, start + n_ranks))
    else:
        raise ValueError(f"unknown spread {spread!r}")
    return Allocation(
        allocation_id=allocation_id or f"{spread}-{seed}",
        nodes=tuple(int(x) for x in nodes),
    )


register_topology(
    "aries",
    lambda **kw: DragonflyTopology(TopologyParams(**kw)),
    small=dict(n_groups=4, chassis_per_group=2, blades_per_chassis=4,
               nodes_per_blade=2, global_links_per_pair=2),
)
