"""The plain reference's shared parts: neighbour searches, k-NN normals,
voxel representatives, nearest-neighbour match gaps and point-to-plane ICP.

Written from the semantics the configuration states, in plain PyTorch:
no kernel, no grid, nothing of the program.  Every function takes the
``dtype`` it computes in: ``torch.float64`` for the reference, and a lower
one (``torch.bfloat16``) for the control, which puts the same code in the
program's place at a lower precision.  Operations PyTorch does not offer in
bfloat16 (``eigh``, ``solve``) take their bfloat16 operands in float32.

Neighbour searches cut the points into a strip along x: with both sides
sorted by x, a block of queries sees only the points whose x lies within
the search radius of the block's x range, and every distance is taken
exactly (``|q|² + |p|² − 2 q·p`` in ``dtype``) against all of them.
"""

from __future__ import annotations

import math

import torch

QUERY_BLOCK = 1024


def solver_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the linear-algebra calls (eigh, solve)."""
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


class Strips:
    """``points`` sorted by x once, for strip searches of many query blocks."""

    def __init__(self, points: torch.Tensor):
        self.points = points
        self.order = torch.argsort(points[:, 0])
        # searched in float32 or wider (searchsorted has no bfloat16)
        self.x = points[self.order, 0].to(torch.promote_types(points.dtype, torch.float32))
        self.norm2 = (points * points).sum(-1)

    def candidates(self, q: torch.Tensor, half_width: float) -> torch.Tensor:
        """Indices of the points with x within ``half_width`` of the
        block's x range."""
        qx = q[:, 0].to(self.x.dtype)
        lo = torch.searchsorted(self.x, (qx.min() - half_width).reshape(1))
        hi = torch.searchsorted(self.x, (qx.max() + half_width).reshape(1), right=True)
        return self.order[int(lo):int(hi)]

    def dist2(self, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """``(B, C)`` squared distances of the block to the candidates."""
        p = self.points[cand]
        d2 = (q * q).sum(-1)[:, None] + self.norm2[cand][None, :] - 2.0 * (q @ p.T)
        return torch.clamp(d2, min=0.0)


def query_blocks(queries: torch.Tensor, block: int = QUERY_BLOCK):
    """Query indices in blocks of ``block``, sorted by x (tight strips)."""
    order = torch.argsort(queries[:, 0])
    for s in range(0, queries.shape[0], block):
        yield order[s:s + block]


def radius_pairs(queries: torch.Tensor, strips: Strips, radius: float):
    """Every (query, point) pair within ``radius`` (distance ``<= radius``),
    as ``(query index, point index, distance)`` per block of queries.

    ``dist2``'s expanded form only finds the candidates, with a margin for
    its rounding: it cancels, so a point may lie at a distance of ~1e-7 from
    itself there (and count as its own neighbour, at a weight of 1/d).  Each
    candidate's distance is then taken from the difference of the two
    points, exactly 0 for a point and itself."""
    r2 = radius * radius
    eps = torch.finfo(strips.points.dtype).eps
    for qi in query_blocks(queries):
        q = queries[qi]
        cand = strips.candidates(q, radius)
        if cand.numel() == 0:
            continue
        d2 = strips.dist2(q, cand)
        scale = float((q * q).sum(-1).max()) + float(strips.norm2[cand].max())
        bq, bc = torch.nonzero(d2 <= r2 + 8.0 * eps * scale, as_tuple=True)
        diff = strips.points[cand[bc]] - q[bq]
        d = torch.sqrt((diff * diff).sum(-1))
        keep = d <= radius
        yield qi[bq][keep], cand[bc][keep], d[keep]


def knn(queries: torch.Tensor, strips: Strips, k: int, half_width: float = 0.5):
    """``(B, k)`` indices of each query's ``k`` nearest points (ascending
    distance), exact: a query whose k-th distance exceeds the strip's half
    width is searched again in a strip twice as wide."""
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=queries.device)
    todo = torch.arange(queries.shape[0], device=queries.device)
    width = half_width
    while todo.numel():
        again = []
        for qi_local in query_blocks(queries[todo]):
            qi = todo[qi_local]
            q = queries[qi]
            cand = strips.candidates(q, width)
            d2 = strips.dist2(q, cand)
            kk = min(k, cand.numel())
            top = torch.topk(d2, kk, dim=1, largest=False)
            ok = (top.values[:, -1] <= width * width) & (kk == k)
            out[qi[ok]] = cand[top.indices[ok]]
            again.append(qi[~ok])
        todo = torch.cat(again)
        width *= 2.0
    return out


def nearest(queries: torch.Tensor, strips: Strips, max_dist: float):
    """``(dist, index)`` of each query's nearest point; exact wherever the
    nearest lies within ``max_dist`` (farther ones report ``inf``)."""
    n = queries.shape[0]
    dist = torch.full((n,), math.inf, dtype=queries.dtype, device=queries.device)
    idx = torch.zeros(n, dtype=torch.int64, device=queries.device)
    for qi in query_blocks(queries):
        q = queries[qi]
        cand = strips.candidates(q, max_dist)
        if cand.numel() == 0:
            continue
        d2 = strips.dist2(q, cand)
        best = torch.min(d2, dim=1)
        d = torch.sqrt(best.values)
        hit = d <= max_dist
        dist[qi[hit]] = d[hit]
        idx[qi[hit]] = cand[best.indices[hit]]
    return dist, idx


def pca_normals(points: torch.Tensor, nbr_idx: torch.Tensor, dtype) -> torch.Tensor:
    """The smallest-eigenvalue eigenvector of each neighbourhood's
    mean-centred covariance."""
    nb = points[nbr_idx]
    centred = nb - nb.mean(dim=1, keepdim=True)
    cov = torch.einsum("qki,qkj->qij", centred, centred) / nbr_idx.shape[1]
    _, vec = torch.linalg.eigh(cov.to(solver_dtype(dtype)))
    return vec[:, :, 0]


def knn_normals(cloud: torch.Tensor, query_idx: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """k-NN PCA normals of the cloud points ``query_idx`` (sign free)."""
    pts = cloud.to(dtype)
    nbr = knn(pts[query_idx], Strips(pts), k)
    return pca_normals(pts, nbr, dtype)


def _sqnorm_f32(d: torch.Tensor) -> torch.Tensor:
    """``x² + y² + z²`` of float32 rows as ``fma(z, z, fma(y, y, x·x))``,
    each step rounded once to float32 (the products are exact in float64)."""
    x, y, z = (d[:, i].double() for i in range(3))
    t = (x * x).float().double()
    t = (y * y + t).float().double()
    return (z * z + t).float()


def voxel_representatives(points: torch.Tensor, voxel: float, dtype):
    """``(indices, populations)``: in each non-empty voxel (cells of
    ``voxel`` from the cloud's minimum corner) the point nearest the
    voxel's barycentre, ties to the earlier point in (cell, index) order,
    with the voxel's point count; ascending index.

    The rule is float32's, as the configuration states: a voxel of two
    points has them at the same distance from its barycentre, and the
    float32 roundings of the barycentre and of the distances decide, so
    they are taken as float32 takes them (true division, ``fma`` sums,
    correctly rounded roots).  A ``dtype`` of bfloat16 (the control) takes
    every step in bfloat16 instead."""
    low = dtype == torch.bfloat16
    pts = points.to(torch.bfloat16 if low else torch.float32)
    cell = torch.floor((pts - pts.min(dim=0).values) / voxel).to(torch.int64)
    dims = cell.max(dim=0).values + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    n_seg = int(seg[-1]) + 1
    counts = torch.zeros(n_seg, dtype=torch.int64, device=pts.device).index_add_(
        0, seg, torch.ones_like(seg))
    acc = pts.dtype if low else torch.float64
    sums = torch.zeros((n_seg, 3), dtype=acc, device=pts.device).index_add_(
        0, seg, pts[order].to(acc)).to(pts.dtype)
    bary = sums / counts[:, None].to(pts.dtype)
    diff = pts[order] - bary[seg]
    if low:
        d = torch.sqrt((diff * diff).sum(-1))
    else:
        d = torch.sqrt(_sqnorm_f32(diff).double()).float()
    pos = torch.sort(d, stable=True).indices
    pos = pos[torch.sort(seg[pos], stable=True).indices]
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = seg[pos][1:] != seg[pos][:-1]
    reps = order[pos[first]]
    pops = counts[seg[pos[first]]]
    asc = torch.argsort(reps)
    return reps[asc], pops[asc]


def density_keypoints(points: torch.Tensor, voxel: float, min_n_neighbors: int, dtype):
    """The voxel representatives whose voxel holds more than
    ``min_n_neighbors`` points (``subsampling_with_density``)."""
    reps, pops = voxel_representatives(points, voxel, dtype)
    return reps[pops > min_n_neighbors]


def euler_xyz_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles as a rotation matrix (Rz Ry Rx)."""
    cx, cy, cz = torch.cos(angles)
    sx, sy, sz = torch.sin(angles)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    return rz @ ry @ rx


def icp_point_to_plane(scan: torch.Tensor, ref: torch.Tensor, ref_normals: torch.Tensor,
                       rotation: torch.Tensor, translation: torch.Tensor, *, d_max: float,
                       voxel: float, max_iter: int, rms_threshold: float, dtype):
    """Point-to-plane ICP of the scan's voxel representatives onto the ref
    from ``(rotation, translation)``: each iteration pairs every moved point
    with its nearest ref point, keeps the pairs within ``d_max``, solves the
    linearised problem ``min Σ ((R s + t − r)·n)²`` for a small rotation
    (extrinsic x-y-z angles) and a translation, and composes it; it stops
    after ``max_iter`` iterations or after the iteration whose mean
    |residual| is under ``rms_threshold``.  Returns ``(R, t, iterations)``
    in ``dtype`` (the solve in ``solver_dtype``)."""
    sub_idx, _ = voxel_representatives(scan, voxel, dtype)
    sub = scan.to(dtype)[sub_idx]
    ref_d, nrm = ref.to(dtype), ref_normals.to(dtype)
    strips = Strips(ref_d)
    rot, t = rotation.to(dtype), translation.to(dtype)
    sdt = solver_dtype(dtype)
    it = 0
    while it < max_iter:
        moved = sub @ rot.T + t
        dist, nn = nearest(moved, strips, d_max)
        w = (dist <= d_max).to(dtype)
        n_j = nrm[nn]
        g = torch.cat([torch.linalg.cross(moved, n_j, dim=-1), n_j], dim=-1)
        h = ((ref_d[nn] - moved) * n_j).sum(-1)
        gtg = (g * w[:, None]).T @ g
        gth = (g * w[:, None]).T @ h
        gtg, gth = gtg.to(sdt), gth.to(sdt)
        gtg = gtg + torch.eye(6, dtype=sdt, device=gtg.device) * 1e-8 * torch.trace(gtg)
        x = torch.linalg.solve(gtg, gth)
        d_rot = euler_xyz_matrix(x[:3]).to(dtype)
        rms = (h.abs() * w).sum() / torch.clamp(w.sum(), min=1.0)
        rot, t = d_rot @ rot, d_rot @ t + x[3:].to(dtype)
        it += 1
        if float(rms) < rms_threshold:
            break
    return rot, t, it


def angle_between(r1: torch.Tensor, r2: torch.Tensor) -> float:
    """The angle of ``r1 r2ᵀ`` in radians, in float64, from
    ``|r1 r2ᵀ − I|_F = 2√2 sin(θ/2)`` (exact near 0, where the trace's
    arccos is not)."""
    m = r1.to(torch.float64) @ r2.to(torch.float64).T
    dev = torch.linalg.norm(m - torch.eye(3, dtype=torch.float64, device=m.device))
    return float(2.0 * torch.asin(torch.clamp(dev / (2.0 * math.sqrt(2.0)), max=1.0)))


def match_gaps(scan_desc: torch.Tensor, ref_desc: torch.Tensor, rows: torch.Tensor,
               chosen: torch.Tensor) -> torch.Tensor:
    """For the scan descriptors ``rows``, how far the chosen ref descriptor
    lies beyond the nearest one, as a share of the nearest distance (float64,
    every ref row compared)."""
    a = scan_desc[rows].to(torch.float64)
    b = ref_desc.to(torch.float64)
    bn = (b * b).sum(-1)
    gaps = []
    for s in range(0, a.shape[0], 512):
        ab = a[s:s + 512]
        d2 = torch.clamp((ab * ab).sum(-1)[:, None] + bn[None, :] - 2.0 * ab @ b.T, min=0.0)
        best = torch.sqrt(d2.min(dim=1).values)
        diff = ab - b[chosen[s:s + 512]]
        got = torch.sqrt((diff * diff).sum(-1))
        gaps.append((got - best) / torch.clamp(best, min=1e-12))
    return torch.cat(gaps)


def nearest_rows(scan_desc: torch.Tensor, ref_desc: torch.Tensor, rows: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The nearest ref row of each scan row ``rows`` with the operands
    rounded to ``dtype`` and the distances summed in float32: the match a
    lower operand precision would make."""
    a = scan_desc[rows].to(dtype).to(torch.float32)
    b = ref_desc.to(dtype).to(torch.float32)
    bn = (b * b).sum(-1)
    out = []
    for s in range(0, a.shape[0], 512):
        ab = a[s:s + 512]
        d2 = (ab * ab).sum(-1)[:, None] + bn[None, :] - 2.0 * ab @ b.T
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def ransac_draws(m: int, n_draws: int, draw_size: int, seed: int) -> torch.Tensor:
    """The configuration's draws of ``draw_size`` distinct matches out of
    ``m``: the stream its RANSAC ``seed`` names, ``torch.randint`` on a CPU
    ``torch.Generator`` seeded with it, a row with a repeated match drawn
    again (every such row at once, in row order) until none is left."""
    gen = torch.Generator().manual_seed(int(seed))
    draws = torch.randint(m, (n_draws, draw_size), generator=gen)
    while True:
        s = torch.sort(draws, dim=1).values
        dup = (s[:, 1:] == s[:, :-1]).any(dim=1)
        n_dup = int(dup.sum())
        if n_dup == 0:
            return draws
        draws[dup] = torch.randint(m, (n_dup, draw_size), generator=gen)


def kabsch(src: torch.Tensor, dst: torch.Tensor, dtype):
    """``(R, t)`` minimising ``Σ |R s + t − d|²`` over ``[..., K, 3]``
    correspondences (SVD, reflections excluded), in ``dtype``."""
    src, dst = src.to(dtype), dst.to(dtype)
    s_bar, d_bar = src.mean(dim=-2), dst.mean(dim=-2)
    h = (src - s_bar[..., None, :]).transpose(-1, -2) @ (dst - d_bar[..., None, :])
    u, _, vt = torch.linalg.svd(h.to(solver_dtype(dtype)))
    v = vt.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    d = torch.ones(h.shape[:-1], dtype=v.dtype, device=v.device)
    d[..., 2] = sign
    rot = ((v * d[..., None, :]) @ u.transpose(-1, -2)).to(dtype)
    return rot, d_bar - (rot @ s_bar[..., :, None])[..., 0]


def inlier_counts(scan_m, ref_m, rot, t, threshold: float) -> torch.Tensor:
    """Matches within ``threshold`` of their ref point once moved, for each
    ``(B, 3, 3)`` rotation and ``(B, 3)`` translation."""
    moved = torch.einsum("bij,mj->bmi", rot, scan_m) + t[:, None, :]
    return (((moved - ref_m[None]) ** 2).sum(-1) <= threshold * threshold).sum(-1)


def draw_transforms(scan_m: torch.Tensor, ref_m: torch.Tensor, draws: torch.Tensor,
                    threshold: float, dtype, chunk: int = 512):
    """Every draw's Kabsch transform and inlier count, in ``dtype``:
    ``(R (D, 3, 3), t (D, 3), counts (D,))``."""
    s, r = scan_m.to(dtype), ref_m.to(dtype)
    rots, ts, counts = [], [], []
    for c in range(0, draws.shape[0], chunk):
        idx = draws[c:c + chunk].to(s.device)
        rot, t = kabsch(s[idx], r[idx], dtype)
        rots.append(rot)
        ts.append(t)
        counts.append(inlier_counts(s, r, rot, t, threshold))
    return torch.cat(rots), torch.cat(ts), torch.cat(counts)


def ransac(scan_m: torch.Tensor, ref_m: torch.Tensor, draws: torch.Tensor,
           threshold: float, dtype):
    """The transform of the first draw with the most inliers, in ``dtype``."""
    rot, t, counts = draw_transforms(scan_m, ref_m, draws, threshold, dtype)
    best = int(torch.argmax(counts))
    return rot[best], t[best]


def within(queries: torch.Tensor, points: torch.Tensor, threshold: float) -> torch.Tensor:
    """Share of the queries with a point within ``threshold``."""
    dist, _ = nearest(queries, Strips(points), threshold)
    return (dist <= threshold).to(torch.float64).mean()
