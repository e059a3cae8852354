"""BVH: flattened node model + host-side builder.

Node semantics match the reference `BvhNode`
(shared/src/lib.rs:152-161): AABB bounds, left/right child
indices with a leaf sentinel, and a contiguous (start, count) range of
triangle indices. The reference builds with an external crate's parallel
builder at 1 triangle per leaf (src/bvh.rs:125-151) and a
chunked strategy above 100k triangles (bvh.rs:154-189); we build a binned-SAH
tree in C++ (csrc/bvh_builder.cpp; a vectorised NumPy twin stays here), and
**reorder the triangles into leaf order** so that device-side leaf tests are
contiguous reads instead of gathers — the indirection list
(`triangle_indices`, bvh.rs:366-369) becomes the identity and is folded away.

Device-side sentinel: the reference uses 0xFFFFFFFF (u32); we use -1 (int32).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .geometry import triangle_aabbs

LEAF = -1  # child sentinel (reference: 0xFFFFFFFF, shared/src/lib.rs:157-158)


@pytree_dataclass(meta_fields=("max_leaf", "depth"))
class Bvh:
    node_min: jnp.ndarray   # [N,3] f32
    node_max: jnp.ndarray   # [N,3] f32
    left: jnp.ndarray       # [N] i32, -1 if leaf
    right: jnp.ndarray      # [N] i32, -1 if leaf
    tri_start: jnp.ndarray  # [N] i32: first triangle (in leaf-ordered arrays)
    tri_count: jnp.ndarray  # [N] i32: triangles in leaf (0 for internal)
    # Threaded (stackless) traversal links: on AABB hit continue at
    # hit_link (= left child, or the miss target for leaves), on AABB miss
    # jump to miss_link (next-sibling-or-ancestor's-sibling); -1 = done.
    # Stands in for the reference's 64-deep per-thread stack
    # (shader/src/bvh.rs:35-38) with the same left-first visit order.
    hit_link: jnp.ndarray   # [N] i32
    miss_link: jnp.ndarray  # [N] i32
    # Static upper bound on triangles per leaf — the unroll bound device
    # traversals MUST cover (a smaller static leaf_size would silently skip
    # triangles in fuller leaves).
    max_leaf: int = 4
    # Static max tree depth (bounds the refit sweep count; 64 default).
    depth: int = 64

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]

    @staticmethod
    def single_leaf(num_triangles: int) -> "Bvh":
        """Degenerate one-node BVH covering everything (brute-force in a box)."""
        big = np.float32(3.0e38)
        return Bvh(
            node_min=jnp.asarray([[-big] * 3], jnp.float32),
            node_max=jnp.asarray([[big] * 3], jnp.float32),
            left=jnp.asarray([LEAF], jnp.int32),
            right=jnp.asarray([LEAF], jnp.int32),
            tri_start=jnp.asarray([0], jnp.int32),
            tri_count=jnp.asarray([num_triangles], jnp.int32),
            hit_link=jnp.asarray([-1], jnp.int32),
            miss_link=jnp.asarray([-1], jnp.int32),
        )


def compute_links(left: np.ndarray, right: np.ndarray):
    """Thread the tree for stackless traversal (left-first DFS order — the
    same visit order as the reference's push-right-then-left stack,
    shader/src/bvh.rs:74-83). Returns (hit_link, miss_link)."""
    n = left.shape[0]
    miss = np.full(n, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        node, succ = stack.pop()
        miss[node] = succ
        l, r = int(left[node]), int(right[node])
        if l >= 0:
            stack.append((r, succ))
            stack.append((l, r))
    hit = np.where(left >= 0, left, miss).astype(np.int32)
    return hit, miss


class BvhBuildResult:
    """Host-side build output (NumPy)."""

    def __init__(self, node_min, node_max, left, right, tri_start, tri_count,
                 tri_order, max_depth):
        self.node_min = node_min
        self.node_max = node_max
        self.left = left
        self.right = right
        self.tri_start = tri_start
        self.tri_count = tri_count
        self.tri_order = tri_order      # [T] slot -> original id (-1 = pad)
        self.max_depth = max_depth

    def to_device(self) -> Bvh:
        hit_link, miss_link = compute_links(self.left, self.right)
        leaf_counts = np.asarray(self.tri_count)[np.asarray(self.left) < 0]
        max_leaf = int(leaf_counts.max()) if leaf_counts.size else 0
        return Bvh(
            node_min=jnp.asarray(self.node_min),
            node_max=jnp.asarray(self.node_max),
            left=jnp.asarray(self.left),
            right=jnp.asarray(self.right),
            tri_start=jnp.asarray(self.tri_start),
            tri_count=jnp.asarray(self.tri_count),
            hit_link=jnp.asarray(hit_link),
            miss_link=jnp.asarray(miss_link),
            max_leaf=max(max_leaf, 1),
            depth=max(self.max_depth + 2, 8),
        )


_SAH_BINS = 16


def build_bvh(vertices: np.ndarray, indices: np.ndarray, leaf_size: int = 4,
              use_native: bool = True) -> BvhBuildResult:
    """Binned-SAH top-down build. Returns flattened nodes + triangle order.

    Root is node 0 (same invariant the reference's conversion establishes,
    src/bvh.rs:282-290).
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    T = indices.shape[0]
    if T == 0:
        r = Bvh.single_leaf(0)
        return BvhBuildResult(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.asarray([LEAF], np.int32), np.asarray([LEAF], np.int32),
            np.asarray([0], np.int32), np.asarray([0], np.int32),
            np.zeros((0,), np.int64), 1)

    if use_native:
        from .bvh_native import build_bvh_native
        return build_bvh_native(vertices, indices, leaf_size)

    tmin, tmax = triangle_aabbs(vertices, indices)
    centroid = 0.5 * (tmin + tmax)

    order = np.arange(T, dtype=np.int64)
    # Pre-size output arrays: every leaf holds >=1 triangle, so a binary
    # tree has at most T leaves and 2T-1 nodes total.
    cap = max(2 * T + 2, 16)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.full(cap, LEAF, np.int32)
    right = np.full(cap, LEAF, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    n_nodes = 1  # node 0 = root
    max_depth = 1

    # Explicit stack of (node_idx, lo, hi, depth) over ranges of `order`.
    stack = [(0, 0, T, 1)]
    while stack:
        node, lo, hi, depth = stack.pop()
        max_depth = max(max_depth, depth)
        ids = order[lo:hi]
        bmin = tmin[ids].min(axis=0)
        bmax = tmax[ids].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        count = hi - lo
        if count <= leaf_size:
            tri_start[node] = lo
            tri_count[node] = count
            continue

        cen = centroid[ids]
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 0.0:
            # All centroids identical: split in the middle by index.
            mid = lo + count // 2
        else:
            # Binned SAH along the widest centroid axis.
            scale = _SAH_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((cen[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bins = np.clip(bins, 0, _SAH_BINS - 1)
            bin_cnt = np.bincount(bins, minlength=_SAH_BINS)
            bin_min = np.full((_SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((_SAH_BINS, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(bin_min[:, a], bins, tmin[ids][:, a])
                np.maximum.at(bin_max[:, a], bins, tmax[ids][:, a])
            # Prefix/suffix sweeps for SAH cost of the B-1 split planes.
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = count - lcnt

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

            cost = area(lmin, lmax)[:-1] * lcnt[:-1] + area(rmin[1:], rmax[1:]) * rcnt[:-1]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = lo + count // 2
            else:
                go_left = bins <= best
                sel = np.concatenate([ids[go_left], ids[~go_left]])
                order[lo:hi] = sel
                mid = lo + int(np.count_nonzero(go_left))
                if mid == lo or mid == hi:
                    mid = lo + count // 2

        if mid == lo or mid == hi:  # degenerate guard
            mid = lo + count // 2
        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        if n_nodes > cap:
            raise RuntimeError("BVH node capacity exceeded")
        left[node] = l_idx
        right[node] = r_idx
        stack.append((r_idx, mid, hi, depth + 1))
        stack.append((l_idx, lo, mid, depth + 1))

    return BvhBuildResult(
        node_min[:n_nodes].copy(), node_max[:n_nodes].copy(),
        left[:n_nodes].copy(), right[:n_nodes].copy(),
        tri_start[:n_nodes].copy(), tri_count[:n_nodes].copy(),
        order, max_depth,
    )


def validate_bvh(res: BvhBuildResult, num_triangles: int,
                 allow_refs: bool = False) -> None:
    """Property checks (SURVEY.md §4): every triangle reachable, parent
    bounds contain child bounds, leaf ranges disjoint-contiguous. Spatial
    (SBVH) builds duplicate triangle REFERENCES across leaves —
    `allow_refs=True` checks coverage instead of exactly-once."""
    seen = np.zeros(num_triangles, bool)
    stack = [0]
    while stack:
        n = stack.pop()
        if res.left[n] == LEAF:
            s, c = res.tri_start[n], res.tri_count[n]
            ids = res.tri_order[s:s + c]
            if not allow_refs:
                assert not seen[ids].any(), "triangle in two leaves"
            seen[ids] = True
        else:
            for ch in (res.left[n], res.right[n]):
                assert (res.node_min[ch] >= res.node_min[n] - 1e-6).all()
                assert (res.node_max[ch] <= res.node_max[n] + 1e-6).all()
                stack.append(int(ch))
    assert seen.all(), "unreachable triangle"


def build_bvh_spatial(vertices: np.ndarray, indices: np.ndarray,
                      leaf_size: int = 8, bins: int = 16,
                      alpha: float = 1e-5,
                      max_dup: float = 1.35) -> BvhBuildResult:
    """SBVH-style top-down build with CHOPPED spatial splits (Stich et al.
    2009, binned variant): at each node the binned-SAH object split competes
    with a spatial split that bins the CLIPPED reference boxes along the
    widest axis; straddling triangles are referenced in BOTH children with
    their boxes clipped at the plane. Spatial splits are only evaluated when
    the object split's child boxes overlap (SA(L∩R)/SA(root) > alpha) and
    total references stay under `max_dup`·T.

    Returns a BvhBuildResult whose `tri_order` may reference a triangle
    MORE THAN ONCE (every downstream consumer — _expand_triangles, refit —
    gathers by id and is duplication-safe;
    closest-hit/any-hit correctness is unaffected, duplicates only add
    candidate tests). Tighter clipped bounds cut node overlap on content
    with large triangles spanning many cells — fewer traversal steps on
    every bounce for the same geometry."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.uint32)
    T = indices.shape[0]
    if T == 0:
        return build_bvh(vertices, indices, leaf_size)
    tmin, tmax = triangle_aabbs(vertices, indices)

    max_refs = int(T * max_dup) + 64
    rtri = np.empty(max_refs, np.int64)
    rmin = np.empty((max_refs, 3), np.float32)
    rmax = np.empty((max_refs, 3), np.float32)
    rtri[:T] = np.arange(T)
    rmin[:T] = tmin
    rmax[:T] = tmax
    n_refs = T

    cap = 2 * max_refs + 2
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.full(cap, LEAF, np.int32)
    right = np.full(cap, LEAF, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    out_order = np.empty(max_refs, np.int64)
    out_n = 0
    n_nodes = 1
    max_depth = 1

    def sa(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    root_sa = max(sa(tmin.min(0), tmax.max(0)), 1e-30)

    stack = [(0, np.arange(T, dtype=np.int64), 1)]
    while stack:
        node, ids, depth = stack.pop()
        max_depth = max(max_depth, depth)
        bmin = rmin[ids].min(axis=0)
        bmax = rmax[ids].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        count = ids.shape[0]
        if count <= leaf_size:
            tri_start[node] = out_n
            tri_count[node] = count
            out_order[out_n:out_n + count] = rtri[ids]
            out_n += count
            continue

        # ---- object split: binned SAH on reference centroids ----
        cen = 0.5 * (rmin[ids] + rmax[ids])
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        obj_mask = None
        obj_cost = np.inf
        obj_overlap = np.inf
        if extent[axis] > 0.0:
            scale = bins * (1.0 - 1e-6) / extent[axis]
            b = np.clip(((cen[:, axis] - cmin[axis]) * scale).astype(np.int32),
                        0, bins - 1)
            bin_cnt = np.bincount(b, minlength=bins)
            bin_min = np.full((bins, 3), np.inf, np.float32)
            bin_max = np.full((bins, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(bin_min[:, a], b, rmin[ids][:, a])
                np.maximum.at(bin_max[:, a], b, rmax[ids][:, a])
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            gmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            gmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = count - lcnt

            def areas(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            cost = (areas(lmin, lmax)[:-1] * lcnt[:-1]
                    + areas(gmin[1:], gmax[1:]) * rcnt[:-1])
            cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf,
                            cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                obj_cost = float(cost[best])
                obj_mask = b <= best
                omn = np.maximum(lmin[best], gmin[best + 1])
                omx = np.minimum(lmax[best], gmax[best + 1])
                obj_overlap = sa(omn, omx) if (omx > omn).all() else 0.0

        # ---- spatial split: chopped binning along the widest NODE axis,
        # evaluated only when the object split leaves overlapping children
        # and the duplication budget has headroom ----
        sp_cost = np.inf
        sp_plane = 0.0
        sp_axis = int(np.argmax(bmax - bmin))
        headroom = max_refs - n_refs - count
        if (headroom > 0 and (not np.isfinite(obj_cost)
                              or obj_overlap / root_sa > alpha)
                and bmax[sp_axis] - bmin[sp_axis] > 0.0):
            ext = bmax[sp_axis] - bmin[sp_axis]
            inv = bins / ext
            lo = rmin[ids][:, sp_axis]
            hi = rmax[ids][:, sp_axis]
            eb = np.clip(((lo - bmin[sp_axis]) * inv).astype(np.int32),
                         0, bins - 1)
            xb = np.clip(((hi - bmin[sp_axis]) * inv - 1e-9).astype(np.int32),
                         0, bins - 1)
            xb = np.maximum(xb, eb)
            edges = bmin[sp_axis] + np.arange(bins + 1) * (ext / bins)
            sbin_min = np.full((bins, 3), np.inf, np.float32)
            sbin_max = np.full((bins, 3), -np.inf, np.float32)
            for bi in range(bins):
                m = (eb <= bi) & (xb >= bi)
                if not m.any():
                    continue
                cm = rmin[ids][m].copy()
                cM = rmax[ids][m].copy()
                cm[:, sp_axis] = np.maximum(cm[:, sp_axis], edges[bi])
                cM[:, sp_axis] = np.minimum(cM[:, sp_axis], edges[bi + 1])
                sbin_min[bi] = np.minimum(sbin_min[bi], cm.min(axis=0))
                sbin_max[bi] = np.maximum(sbin_max[bi], cM.max(axis=0))
            ecnt = np.bincount(eb, minlength=bins)
            xcnt = np.bincount(xb, minlength=bins)
            slmin = np.minimum.accumulate(sbin_min, axis=0)
            slmax = np.maximum.accumulate(sbin_max, axis=0)
            srmin = np.minimum.accumulate(sbin_min[::-1], axis=0)[::-1]
            srmax = np.maximum.accumulate(sbin_max[::-1], axis=0)[::-1]
            nl = np.cumsum(ecnt)                 # refs entering at <= i
            nr = count - np.cumsum(xcnt)         # refs exiting after i

            def areas2(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            scost = (areas2(slmin, slmax)[:-1] * nl[:-1]
                     + areas2(srmin[1:], srmax[1:]) * nr[:-1])
            dup = nl[:-1] + nr[:-1] - count      # straddler copies per plane
            scost = np.where((nl[:-1] == 0) | (nr[:-1] == 0)
                             | (dup > headroom), np.inf, scost)
            sbest = int(np.argmin(scost))
            if np.isfinite(scost[sbest]):
                sp_cost = float(scost[sbest])
                sp_plane = float(edges[sbest + 1])

        # ---- apply the cheaper split ----
        if sp_cost < obj_cost:
            lo = rmin[ids][:, sp_axis]
            hi = rmax[ids][:, sp_axis]
            left_only = hi <= sp_plane
            # & ~left_only: an axis-flat ref lying exactly ON the plane
            # (lo == hi == sp_plane) satisfies both masks — without the
            # exclusion it would land in BOTH children as the SAME mutable
            # ref record (aliased clips, ref-count overflow)
            right_only = (lo >= sp_plane) & ~left_only
            strad = ~(left_only | right_only)
            n_l = int(left_only.sum() + strad.sum())
            n_r = int(right_only.sum() + strad.sum())
            if n_l == 0 or n_r == 0 or (n_l >= count and n_r >= count):
                # degenerate (incl. every ref straddling: children would
                # both equal the parent and recurse forever): median split.
                # Decided BEFORE any mutation — clipping rmax first and
                # then discarding the right-side copies would leave leaf
                # boxes that under-cover their triangles (silent misses).
                lids, rids = ids[: count // 2], ids[count // 2:]
            else:
                sid = ids[strad]
                # left keeps the straddler refs, clipped at the plane...
                rmax[sid, sp_axis] = sp_plane
                # ...the right side gets fresh clipped COPIES
                k = sid.shape[0]
                new_ids = np.arange(n_refs, n_refs + k, dtype=np.int64)
                rtri[new_ids] = rtri[sid]
                rmin[new_ids] = rmin[sid]
                rmin[new_ids, sp_axis] = sp_plane
                rmax[new_ids] = rmax[sid]
                # rmax[sid] was clipped above; `hi` is a pre-clip copy
                # (fancy indexing), so the right box recovers its original
                # high edge
                rmax[new_ids, sp_axis] = hi[strad]
                n_refs += k
                lids = np.concatenate([ids[left_only], sid])
                rids = np.concatenate([ids[right_only], new_ids])
        elif obj_mask is not None:
            lids, rids = ids[obj_mask], ids[~obj_mask]
            if lids.size == 0 or rids.size == 0:
                lids, rids = ids[: count // 2], ids[count // 2:]
        else:
            lids, rids = ids[: count // 2], ids[count // 2:]

        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        if n_nodes > cap:
            raise RuntimeError("SBVH node capacity exceeded")
        left[node] = l_idx
        right[node] = r_idx
        stack.append((r_idx, rids, depth + 1))
        stack.append((l_idx, lids, depth + 1))

    return BvhBuildResult(
        node_min[:n_nodes].copy(), node_max[:n_nodes].copy(),
        left[:n_nodes].copy(), right[:n_nodes].copy(),
        tri_start[:n_nodes].copy(), tri_count[:n_nodes].copy(),
        out_order[:out_n].copy(), max_depth,
    )
