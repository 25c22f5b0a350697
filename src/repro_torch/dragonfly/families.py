"""The non-Aries members of the topology family (docs/topology.md).

Three implementations of the :class:`repro_torch.dragonfly.topology.Topology`
protocol:

* :class:`DragonflyFamily` — the standard ``(p, a, h, g)`` dragonfly
  parameterization (RAPS / MPINET style) with one router tier per group
  and either *palmtree* or *consecutive* global-link arrangement.  The
  balanced rule ``g = a*h + 1`` is the default group count (``g=0``).
* :class:`DragonflyPlusFamily` — Dragonfly+ per 2406.15097: two-tier
  leaf/spine groups, nodes on leaves, global links on spines.
* :class:`FatTreeControl` — a degenerate 2-level fat-tree used as the
  experimental control (no group locality at all; every inter-router
  route is leaf-spine-leaf).

All three use arithmetic directed link ids like the Aries layout:
local links first, then global links, then one NIC injection link per
node.  Unused arithmetic slots (local diagonals, out-of-round global
channels) decode to (-1, -1) in ``link_endpoints`` and simply never
appear in candidate paths.

Global-link arrangements (channel ``c`` of a group, ``m = c % (g-1)``,
round ``j = c // (g-1)``):

* consecutive: channel ``m`` points at group ``(grp + m + 1) % g``
* palmtree:    channel ``m`` points at group ``(grp - m - 1) % g``

Either way the reverse direction of round ``j``'s link between two
groups is that round's channel ``m' = g - 2 - m`` on the peer — which
is what makes the directed global ids consistent between the two ends.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.dragonfly.topology import (PAD, Topology, balanced_global_count,
                                      register_topology)

__all__ = [
    "DragonflyFamily",
    "DragonflyParams",
    "DragonflyPlusFamily",
    "DragonflyPlusParams",
    "FatTreeControl",
    "FatTreeParams",
]

_ARRANGEMENTS = ("palmtree", "consecutive")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# =========================================================== Dragonfly(p,a,h,g)
@dataclass(frozen=True)
class DragonflyParams:
    """p nodes/router, a routers/group, h global ports/router, g groups
    (0 means the balanced rule g = a*h + 1)."""

    p: int = 2
    a: int = 4
    h: int = 2
    g: int = 0
    arrangement: str = "palmtree"
    local_gbs: float = 5.25
    global_gbs: float = 4.7
    nic_gbs: float = 10.0
    hop_latency_ns: float = 100.0
    nic_latency_ns: float = 600.0


class DragonflyFamily(Topology):
    """Parameterized single-tier dragonfly.

    Link-id layout (directed):
      local   [0, g*a*a)        (grp*a + r1)*a + r2   (diagonal unused)
      global  [+, + g*a*h)      grp*(a*h) + c,  c < rounds*(g-1) used
      nic     [+, + n_nodes)    one injection link per node
    """

    name = "dragonfly"
    max_minimal_hops = 3     # local, global, local
    max_nonmin_hops = 5      # local, global, local, global, local

    def __init__(self, params: DragonflyParams):
        p, a, h = params.p, params.a, params.h
        g = params.g or balanced_global_count(a, h)
        _require(p >= 1 and a >= 1 and h >= 1,
                 f"dragonfly wants p,a,h >= 1, got {p},{a},{h}")
        _require(g >= 3, f"dragonfly wants g >= 3 groups, got {g}")
        _require(params.arrangement in _ARRANGEMENTS,
                 f"arrangement must be one of {_ARRANGEMENTS}, "
                 f"got {params.arrangement!r}")
        _require(a * h >= g - 1,
                 f"g={g} groups need a*h >= g-1 global ports/group, "
                 f"got a*h={a * h}")
        self.params = params
        self.p, self.a, self.h, self.g = p, a, h, g
        self.arrangement = params.arrangement
        # rounds = parallel global links between every ordered group pair
        self.rounds = (a * h) // (g - 1)
        self.n_groups = g
        self.n_routers = g * a
        self.n_nodes = g * a * p
        self.nodes_per_router = p
        self.nodes_per_group = a * p
        self.n_node_routers = self.n_routers
        self.hop_latency_ns = params.hop_latency_ns
        self.nic_latency_ns = params.nic_latency_ns
        self._glob_off = g * a * a
        self._nic_off = self._glob_off + g * a * h
        self.n_links = self._nic_off + self.n_nodes
        cap = np.empty(self.n_links, dtype=np.float64)
        cap[:self._glob_off] = params.local_gbs
        cap[self._glob_off:self._nic_off] = params.global_gbs
        cap[self._nic_off:] = params.nic_gbs
        self.capacity_gbs = cap

    # ------------------------------------------------------------- structure
    def spec_str(self) -> str:
        return (f"dragonfly(p={self.p},a={self.a},h={self.h},g={self.g},"
                f"arrangement={self.arrangement})")

    def link_ranges(self) -> dict:
        return {"local": (0, self._glob_off),
                "global": (self._glob_off, self._nic_off),
                "nic": (self._nic_off, self.n_links)}

    def router_of_node(self, node):
        return np.asarray(node) // self.p

    def group_of_router(self, router):
        return np.asarray(router) // self.a

    def nic_link(self, node):
        return self._nic_off + np.asarray(node)

    def _used_channels(self) -> int:
        return self.rounds * (self.g - 1)

    def _peer_group(self, grp, m):
        if self.arrangement == "consecutive":
            return (grp + m + 1) % self.g
        return (grp - m - 1) % self.g

    def _chan(self, g_from, g_to, j):
        """Channel index in g_from of round-j's global link toward g_to."""
        if self.arrangement == "consecutive":
            m = (g_to - g_from - 1) % self.g
        else:
            m = (g_from - g_to - 1) % self.g
        return j * (self.g - 1) + m

    def _local(self, grp, r1, r2):
        return (grp * self.a + r1) * self.a + r2

    def _global(self, grp, c):
        return self._glob_off + grp * (self.a * self.h) + c

    def link_endpoints(self):
        sr = np.full(self.n_links, -1, dtype=np.int64)
        dr = np.full(self.n_links, -1, dtype=np.int64)
        a, h, g = self.a, self.h, self.g
        # local
        ids = np.arange(self._glob_off)
        grp, rem = divmod(ids, a * a)
        r1, r2 = divmod(rem, a)
        ok = r1 != r2
        sr[:self._glob_off][ok] = (grp * a + r1)[ok]
        dr[:self._glob_off][ok] = (grp * a + r2)[ok]
        # global
        ids = np.arange(self._nic_off - self._glob_off)
        grp, c = divmod(ids, a * h)
        j, m = divmod(c, g - 1)
        used = c < self._used_channels()
        peer = self._peer_group(grp, m)
        rev = j * (g - 1) + (g - 2 - m)
        gsl = slice(self._glob_off, self._nic_off)
        sr[gsl][used] = (grp * a + c // h)[used]
        dr[gsl][used] = (peer * a + rev // h)[used]
        # nic: node side has no router
        dr[self._nic_off:] = self.router_of_node(np.arange(self.n_nodes))
        return sr, dr

    def expected_router_degree(self) -> np.ndarray:
        l = np.arange(self.a)
        used = np.clip(self._used_channels() - l * self.h, 0, self.h)
        return np.tile((self.a - 1) + used, self.g)

    # --------------------------------------------------------------- routing
    def _decode(self, node):
        r = np.asarray(node, dtype=np.int64) // self.p
        return r // self.a, r % self.a          # (group, router-in-group)

    def _minimal_vec(self, src, dst, j):
        n = src.shape[0]
        g1, l1 = self._decode(src)
        g2, l2 = self._decode(dst)
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        intra = g1 == g2
        m = intra & (l1 != l2)
        out[m, 0] = self._local(g1, l1, l2)[m]
        inter = ~intra
        c1 = self._chan(g1, g2, j)
        c2 = self._chan(g2, g1, j)
        gw1, gw2 = c1 // self.h, c2 // self.h
        m = inter & (l1 != gw1)
        out[m, 0] = self._local(g1, l1, gw1)[m]
        out[inter, 1] = self._global(g1, c1)[inter]
        m = inter & (gw2 != l2)
        out[m, 2] = self._local(g2, gw2, l2)[m]
        return out

    def _pick_transit(self, gi, g1, g2):
        """Collision-adjusted intermediate group (Aries-style double bump)."""
        gim = gi % self.g
        for _ in range(2):
            gim = np.where((gim == g1) | (gim == g2), (gim + 1) % self.g, gim)
        return gim

    def _nonmin_vec(self, src, dst, gi, j1, j2):
        n = src.shape[0]
        g1, l1 = self._decode(src)
        g2, l2 = self._decode(dst)
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        intra = g1 == g2
        # intra-group: detour via a hashed intermediate router
        ri = (gi * 40503 + 7) % self.a
        m = intra & (l1 != ri)
        out[m, 0] = self._local(g1, l1, ri)[m]
        m = intra & (ri != l2)
        out[m, 1] = self._local(g1, ri, l2)[m]
        # inter-group Valiant through gim
        inter = ~intra
        gim = self._pick_transit(gi, g1, g2)
        c_a = self._chan(g1, gim, j1)
        ea = self._chan(gim, g1, j1) // self.h     # entry router at gim
        c_b = self._chan(gim, g2, j2)
        eb = self._chan(g2, gim, j2) // self.h     # entry router at g2
        gwa, xb = c_a // self.h, c_b // self.h
        m = inter & (l1 != gwa)
        out[m, 0] = self._local(g1, l1, gwa)[m]
        out[inter, 1] = self._global(g1, c_a)[inter]
        m = inter & (ea != xb)
        out[m, 2] = self._local(gim, ea, xb)[m]
        out[inter, 3] = self._global(gim, c_b)[inter]
        m = inter & (eb != l2)
        out[m, 4] = self._local(g2, eb, l2)[m]
        return out

    def candidate_paths(self, src, dst, rng, n_min: int = 2,
                        n_nonmin: int = 2):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n = src.shape[0]
        R = self.rounds
        k0 = rng.integers(0, R, size=n)
        gis = rng.integers(0, self.g, size=(n_nonmin, n))
        knm = rng.integers(0, R, size=(2 * n_nonmin, n))
        cands = [self._minimal_vec(src, dst, (k0 + j) % R)
                 for j in range(n_min)]
        cands += [self._nonmin_vec(src, dst, gis[j], knm[2 * j],
                                   knm[2 * j + 1])
                  for j in range(n_nonmin)]
        links = np.stack(cands, axis=1)
        links[src == dst] = PAD
        is_nonmin = np.array([False] * n_min + [True] * n_nonmin)
        return links, is_nonmin


# ============================================================== Dragonfly+
@dataclass(frozen=True)
class DragonflyPlusParams:
    """Two-tier groups: a_leaf leaf routers (p nodes each) bipartitely
    wired to a_spine spine routers; the spines own the h-per-router
    global ports.  g=0 means the balanced rule g = a_spine*h + 1."""

    p: int = 2
    a_leaf: int = 2
    a_spine: int = 2
    h: int = 2
    g: int = 0
    arrangement: str = "palmtree"
    local_gbs: float = 5.25
    global_gbs: float = 4.7
    nic_gbs: float = 10.0
    hop_latency_ns: float = 100.0
    nic_latency_ns: float = 600.0


class DragonflyPlusFamily(Topology):
    """Dragonfly+ (leaf/spine groups per 2406.15097).

    Link-id layout (directed):
      local   [0, g*a_leaf*a_spine*2)   ((grp*a_leaf + l)*a_spine + s)*2
                                        + dir  (0 = up leaf->spine)
      global  [+, + g*a_spine*h)        grp*(a_spine*h) + c
      nic     [+, + n_nodes)

    Router ids: group grp owns [grp*R, (grp+1)*R) with R = a_leaf +
    a_spine; leaves first, spines after.
    """

    name = "dragonfly_plus"
    max_minimal_hops = 3     # up, global, down
    max_nonmin_hops = 6      # up, global, down, up, global, down

    def __init__(self, params: DragonflyPlusParams):
        p, al, asp, h = params.p, params.a_leaf, params.a_spine, params.h
        g = params.g or balanced_global_count(asp, h)
        _require(p >= 1 and al >= 1 and asp >= 1 and h >= 1,
                 f"dragonfly+ wants p,a_leaf,a_spine,h >= 1, "
                 f"got {p},{al},{asp},{h}")
        _require(g >= 3, f"dragonfly+ wants g >= 3 groups, got {g}")
        _require(params.arrangement in _ARRANGEMENTS,
                 f"arrangement must be one of {_ARRANGEMENTS}, "
                 f"got {params.arrangement!r}")
        _require(asp * h >= g - 1,
                 f"g={g} groups need a_spine*h >= g-1, got {asp * h}")
        self.params = params
        self.p, self.a_leaf, self.a_spine, self.h = p, al, asp, h
        self.g = g
        self.arrangement = params.arrangement
        self.rounds = (asp * h) // (g - 1)
        self._R = al + asp                       # routers per group
        self.n_groups = g
        self.n_routers = g * self._R
        self.n_nodes = g * al * p
        self.nodes_per_router = p
        self.nodes_per_group = al * p
        self.n_node_routers = g * al
        self.hop_latency_ns = params.hop_latency_ns
        self.nic_latency_ns = params.nic_latency_ns
        self._glob_off = g * al * asp * 2
        self._nic_off = self._glob_off + g * asp * h
        self.n_links = self._nic_off + self.n_nodes
        cap = np.empty(self.n_links, dtype=np.float64)
        cap[:self._glob_off] = params.local_gbs
        cap[self._glob_off:self._nic_off] = params.global_gbs
        cap[self._nic_off:] = params.nic_gbs
        self.capacity_gbs = cap

    # ------------------------------------------------------------- structure
    def spec_str(self) -> str:
        return (f"dragonfly_plus(p={self.p},a_leaf={self.a_leaf},"
                f"a_spine={self.a_spine},h={self.h},g={self.g},"
                f"arrangement={self.arrangement})")

    def link_ranges(self) -> dict:
        return {"local": (0, self._glob_off),
                "global": (self._glob_off, self._nic_off),
                "nic": (self._nic_off, self.n_links)}

    def router_of_node(self, node):
        nrf = np.asarray(node) // self.p         # flat leaf index
        return (nrf // self.a_leaf) * self._R + nrf % self.a_leaf

    def group_of_router(self, router):
        return np.asarray(router) // self._R

    def nic_link(self, node):
        return self._nic_off + np.asarray(node)

    def _used_channels(self) -> int:
        return self.rounds * (self.g - 1)

    def _peer_group(self, grp, m):
        if self.arrangement == "consecutive":
            return (grp + m + 1) % self.g
        return (grp - m - 1) % self.g

    def _chan(self, g_from, g_to, j):
        if self.arrangement == "consecutive":
            m = (g_to - g_from - 1) % self.g
        else:
            m = (g_from - g_to - 1) % self.g
        return j * (self.g - 1) + m

    def _up(self, grp, l, s):
        return ((grp * self.a_leaf + l) * self.a_spine + s) * 2

    def _down(self, grp, s, l):
        return ((grp * self.a_leaf + l) * self.a_spine + s) * 2 + 1

    def _global(self, grp, c):
        return self._glob_off + grp * (self.a_spine * self.h) + c

    def link_endpoints(self):
        sr = np.full(self.n_links, -1, dtype=np.int64)
        dr = np.full(self.n_links, -1, dtype=np.int64)
        al, asp, h, g, R = (self.a_leaf, self.a_spine, self.h, self.g,
                           self._R)
        # local (every slot physical)
        ids = np.arange(self._glob_off)
        half, dirn = divmod(ids, 2)
        s = half % asp
        l = (half // asp) % al
        grp = half // (asp * al)
        leaf = grp * R + l
        spine = grp * R + al + s
        sr[:self._glob_off] = np.where(dirn == 0, leaf, spine)
        dr[:self._glob_off] = np.where(dirn == 0, spine, leaf)
        # global
        ids = np.arange(self._nic_off - self._glob_off)
        grp, c = divmod(ids, asp * h)
        j, m = divmod(c, g - 1)
        used = c < self._used_channels()
        peer = self._peer_group(grp, m)
        rev = j * (g - 1) + (g - 2 - m)
        gsl = slice(self._glob_off, self._nic_off)
        sr[gsl][used] = (grp * R + al + c // h)[used]
        dr[gsl][used] = (peer * R + al + rev // h)[used]
        # nic
        dr[self._nic_off:] = self.router_of_node(np.arange(self.n_nodes))
        return sr, dr

    def expected_router_degree(self) -> np.ndarray:
        si = np.arange(self.a_spine)
        used = np.clip(self._used_channels() - si * self.h, 0, self.h)
        per_group = np.concatenate([
            np.full(self.a_leaf, self.a_spine, dtype=np.int64),
            self.a_leaf + used])
        return np.tile(per_group, self.g)

    # --------------------------------------------------------------- routing
    def _decode(self, node):
        nrf = np.asarray(node, dtype=np.int64) // self.p
        return nrf // self.a_leaf, nrf % self.a_leaf   # (group, leaf idx)

    def _minimal_vec(self, src, dst, j, sk):
        n = src.shape[0]
        g1, l1 = self._decode(src)
        g2, l2 = self._decode(dst)
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        intra = (g1 == g2) & (l1 != l2)
        s = sk % self.a_spine
        out[intra, 0] = self._up(g1, l1, s)[intra]
        out[intra, 1] = self._down(g1, s, l2)[intra]
        inter = g1 != g2
        c1 = self._chan(g1, g2, j)
        c2 = self._chan(g2, g1, j)
        out[inter, 0] = self._up(g1, l1, c1 // self.h)[inter]
        out[inter, 1] = self._global(g1, c1)[inter]
        out[inter, 2] = self._down(g2, c2 // self.h, l2)[inter]
        return out

    def _pick_transit(self, gi, g1, g2):
        gim = gi % self.g
        for _ in range(2):
            gim = np.where((gim == g1) | (gim == g2), (gim + 1) % self.g, gim)
        return gim

    def _nonmin_vec(self, src, dst, gi, j1, j2):
        n = src.shape[0]
        g1, l1 = self._decode(src)
        g2, l2 = self._decode(dst)
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        lt = (gi * 40503 + 7) % self.a_leaf       # transit leaf
        # intra-group: down to a transit leaf, back up, down to dst
        intra = (g1 == g2) & (src != dst)
        sa = j1 % self.a_spine
        sb = j2 % self.a_spine
        out[intra, 0] = self._up(g1, l1, sa)[intra]
        out[intra, 1] = self._down(g1, sa, lt)[intra]
        out[intra, 2] = self._up(g1, lt, sb)[intra]
        out[intra, 3] = self._down(g1, sb, l2)[intra]
        # inter-group Valiant through gim's transit leaf
        inter = g1 != g2
        gim = self._pick_transit(gi, g1, g2)
        jr1, jr2 = j1 % self.rounds, j2 % self.rounds
        c_a = self._chan(g1, gim, jr1)
        s_in = self._chan(gim, g1, jr1) // self.h
        c_b = self._chan(gim, g2, jr2)
        s2 = self._chan(g2, gim, jr2) // self.h
        out[inter, 0] = self._up(g1, l1, c_a // self.h)[inter]
        out[inter, 1] = self._global(g1, c_a)[inter]
        out[inter, 2] = self._down(gim, s_in, lt)[inter]
        out[inter, 3] = self._up(gim, lt, c_b // self.h)[inter]
        out[inter, 4] = self._global(gim, c_b)[inter]
        out[inter, 5] = self._down(g2, s2, l2)[inter]
        return out

    def candidate_paths(self, src, dst, rng, n_min: int = 2,
                        n_nonmin: int = 2):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n = src.shape[0]
        R = self.rounds
        k0 = rng.integers(0, R, size=n)
        sks = rng.integers(0, self.a_spine, size=(n_min, n))
        gis = rng.integers(0, self.g, size=(n_nonmin, n))
        knm = rng.integers(0, max(R, self.a_spine), size=(2 * n_nonmin, n))
        cands = [self._minimal_vec(src, dst, (k0 + j) % R, sks[j])
                 for j in range(n_min)]
        cands += [self._nonmin_vec(src, dst, gis[j], knm[2 * j],
                                   knm[2 * j + 1])
                  for j in range(n_nonmin)]
        links = np.stack(cands, axis=1)
        links[src == dst] = PAD
        is_nonmin = np.array([False] * n_min + [True] * n_nonmin)
        return links, is_nonmin


# ============================================================ fat-tree control
@dataclass(frozen=True)
class FatTreeParams:
    """Degenerate 2-level fat tree: n_leaf leaf routers (p nodes each)
    fully wired to n_spine spines.  No groups, no global tier — the
    control arm for 'does group locality matter at all'."""

    p: int = 2
    n_leaf: int = 4
    n_spine: int = 2
    local_gbs: float = 5.25
    nic_gbs: float = 10.0
    hop_latency_ns: float = 100.0
    nic_latency_ns: float = 600.0


class FatTreeControl(Topology):
    """2-level fat tree; every leaf is its own 'group' of p nodes.

    Link-id layout (directed):
      up    [0, n_leaf*n_spine)     l*n_spine + s
      down  [+, + n_spine*n_leaf)   s*n_leaf + l
      nic   [+, + n_nodes)
    """

    name = "fattree"
    max_minimal_hops = 2
    max_nonmin_hops = 2
    valiant_transits_group = False   # no intermediate groups exist

    def __init__(self, params: FatTreeParams):
        p, nl, ns = params.p, params.n_leaf, params.n_spine
        _require(p >= 1 and nl >= 2 and ns >= 1,
                 f"fattree wants p>=1, n_leaf>=2, n_spine>=1, "
                 f"got {p},{nl},{ns}")
        self.params = params
        self.p, self.n_leaf, self.n_spine = p, nl, ns
        self.n_groups = nl
        self.n_routers = nl + ns
        self.n_nodes = nl * p
        self.nodes_per_router = p
        self.nodes_per_group = p
        self.n_node_routers = nl
        self.hop_latency_ns = params.hop_latency_ns
        self.nic_latency_ns = params.nic_latency_ns
        self._down_off = nl * ns
        self._nic_off = 2 * nl * ns
        self.n_links = self._nic_off + self.n_nodes
        cap = np.empty(self.n_links, dtype=np.float64)
        cap[:self._nic_off] = params.local_gbs
        cap[self._nic_off:] = params.nic_gbs
        self.capacity_gbs = cap

    # ------------------------------------------------------------- structure
    def spec_str(self) -> str:
        return (f"fattree(p={self.p},n_leaf={self.n_leaf},"
                f"n_spine={self.n_spine})")

    def link_ranges(self) -> dict:
        return {"up": (0, self._down_off),
                "down": (self._down_off, self._nic_off),
                "nic": (self._nic_off, self.n_links)}

    def router_of_node(self, node):
        return np.asarray(node) // self.p

    def group_of_router(self, router):
        # leaves are their own group; spines belong to none
        r = np.asarray(router)
        return np.where(r < self.n_leaf, r, -1)

    def nic_link(self, node):
        return self._nic_off + np.asarray(node)

    def _up(self, l, s):
        return l * self.n_spine + s

    def _down(self, s, l):
        return self._down_off + s * self.n_leaf + l

    def link_endpoints(self):
        sr = np.full(self.n_links, -1, dtype=np.int64)
        dr = np.full(self.n_links, -1, dtype=np.int64)
        nl, ns = self.n_leaf, self.n_spine
        ids = np.arange(nl * ns)
        l, s = divmod(ids, ns)
        sr[:self._down_off] = l
        dr[:self._down_off] = nl + s
        s, l = divmod(ids, nl)
        sr[self._down_off:self._nic_off] = nl + s
        dr[self._down_off:self._nic_off] = l
        dr[self._nic_off:] = self.router_of_node(np.arange(self.n_nodes))
        return sr, dr

    def expected_router_degree(self) -> np.ndarray:
        return np.concatenate([
            np.full(self.n_leaf, self.n_spine, dtype=np.int64),
            np.full(self.n_spine, self.n_leaf, dtype=np.int64)])

    # --------------------------------------------------------------- routing
    def _via_spine(self, src, dst, s):
        n = src.shape[0]
        l1 = src // self.p
        l2 = dst // self.p
        out = np.full((n, self.MAX_HOPS), PAD, dtype=np.int64)
        inter = l1 != l2
        out[inter, 0] = self._up(l1, s)[inter]
        out[inter, 1] = self._down(s, l2)[inter]
        return out

    def candidate_paths(self, src, dst, rng, n_min: int = 2,
                        n_nonmin: int = 2):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n = src.shape[0]
        ns = self.n_spine
        s0 = rng.integers(0, ns, size=n)
        snm = rng.integers(0, ns, size=(n_nonmin, n))
        cands = [self._via_spine(src, dst, (s0 + j) % ns)
                 for j in range(n_min)]
        # the 'Valiant' arm is just an independent spine draw
        cands += [self._via_spine(src, dst, snm[j]) for j in range(n_nonmin)]
        links = np.stack(cands, axis=1)
        links[src == dst] = PAD
        is_nonmin = np.array([False] * n_min + [True] * n_nonmin)
        return links, is_nonmin


# --------------------------------------------------------------- registration
register_topology(
    "dragonfly",
    lambda **kw: DragonflyFamily(DragonflyParams(**kw)),
    small=dict(p=2, a=4, h=2, g=9, arrangement="palmtree"),
)
register_topology(
    "dragonfly_consecutive",
    lambda **kw: DragonflyFamily(
        DragonflyParams(**{"arrangement": "consecutive", **kw})),
    small=dict(p=2, a=4, h=2, g=9),
)
register_topology(
    "dragonfly_plus",
    lambda **kw: DragonflyPlusFamily(DragonflyPlusParams(**kw)),
    small=dict(p=2, a_leaf=2, a_spine=2, h=2, g=5),
)
register_topology(
    "fattree",
    lambda **kw: FatTreeControl(FatTreeParams(**kw)),
    small=dict(p=2, n_leaf=4, n_spine=2),
)
