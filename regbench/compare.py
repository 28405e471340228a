"""The comparison that decides ``correct``: the program's outputs for the
window's pairs, held to the motions that made them and to the plain
reference.

Numbers compared (each against the limit of the same name in the
configuration's ``limits``):

- ``truth_rot_err_rad``, ``truth_t_err``: over every pair of the window,
  the widest rotation angle and translation distance between the final
  transform and the motion that made the pair;
- over the last registration of each pair of the pool (the largest
  reading of the pool):
  - ``normals_p90_rad``: the 90th percentile, over ``check.normals_sample``
    points of each cloud drawn from the seed, of the angle between the
    program's normal and the exact k-NN PCA normal (sign free);
  - ``keypoint_mismatch``: the keypoints of either cloud that the program
    and the reference do not share, as a share of the reference's;
  - ``descriptor_err_p90``: the 90th percentile, over
    ``check.descriptor_sample`` keypoints both selected, of
    ``|d_program − d_reference| / |d_reference|``;
  - ``match_gap_max``: over ``check.match_sample`` matched scan rows, the
    widest share by which the chosen ref descriptor lies farther than the
    nearest non-empty one (the program's descriptors, in float64);
  - ``ransac_rot_gap_rad``, ``ransac_t_gap``: the program's RANSAC
    transform against the float64 Kabsch transform of the nearest best draw
    (the most inliers over the program's matches and the configuration's
    draws, or one fewer);
  - ``icp_rot_gap_rad``, ``icp_t_gap``: the program's ICP transform against
    the reference's ICP from the program's RANSAC transform;
  - ``overlap_gap``, ``inlier_gap``: the evaluation's overlap and keypoint
    inlier shares of the program's final transform against the reference's.

The reference follows the program step by step where a stage needs what
the one before it made: its descriptors and ICP take the program's
normals (a normal's sign is left open by PCA, and SHOT's cosines and
FPFH's angles depend on it; the normals are checked by themselves, sign
free), matching is judged on the program's descriptors, RANSAC on the
program's matches, ICP from the program's RANSAC transform and the
evaluation on the program's final transform and keypoints.  The truth
numbers check the whole chain end to end.

The control (``control_readings``) puts the reference in the program's
place one precision lower: bfloat16 for the float32 stages (the
descriptors on each neighbour's offset from its keypoint), and for the
bfloat16 match product float8 (e4m3) operands.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .reference import common, descriptor_module

F64 = torch.float64
TRUTH = ("truth_rot_err_rad", "truth_t_err")


@dataclass
class PairOutputs:
    """What the timed path produced for one pair."""

    scan: np.ndarray
    ref: np.ndarray
    rotation: np.ndarray          # the motion that made the pair
    translation: np.ndarray
    scan_normals: np.ndarray
    ref_normals: np.ndarray
    scan_keypoints: np.ndarray
    ref_keypoints: np.ndarray
    scan_descriptors: torch.Tensor
    ref_descriptors: torch.Tensor
    matches: tuple[np.ndarray, np.ndarray]
    ransac: tuple[torch.Tensor, torch.Tensor]
    icp: tuple[torch.Tensor, torch.Tensor]
    overlap: float
    inliers: float


def transform_errors(rot, t, truth_rot, truth_t) -> tuple[float, float]:
    """(rotation angle, translation distance) between two transforms."""
    r = torch.as_tensor(rot, dtype=F64).cpu()
    tr = torch.as_tensor(truth_rot, dtype=F64)
    dt = torch.as_tensor(t, dtype=F64).cpu() - torch.as_tensor(truth_t, dtype=F64)
    return common.angle_between(r, tr), float(torch.linalg.norm(dt))


def normal_angles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angles between the lines of two sets of vectors (sign free), as
    ``atan2(|a × b|, |a · b|)``: exact near 0."""
    a, b = a.to(F64), b.to(F64)
    cross = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
    return torch.atan2(cross, (a * b).sum(-1).abs())


def _p90(x: torch.Tensor) -> float:
    return float(torch.quantile(x.to(F64).cpu(), 0.9))


def _mismatch(got: torch.Tensor, want: torch.Tensor) -> int:
    g, w = set(got.cpu().tolist()), set(want.cpu().tolist())
    return len(g ^ w)


class Check:
    """The reference's readings for pool pair ``index``, on ``device``;
    samples come from ``np.random.default_rng([seed, index])``."""

    def __init__(self, out: PairOutputs, cfg: dict, traffic: dict, seed: int, device,
                 index: int = 0):
        self.out, self.cfg, self.traffic = out, cfg, traffic
        self.device = torch.device(device)
        self.rng = np.random.default_rng([seed % (1 << 63), index])
        self.clouds = {side: torch.as_tensor(getattr(out, side), dtype=F64, device=self.device)
                       for side in ("scan", "ref")}
        self.normals = {side: torch.as_tensor(getattr(out, f"{side}_normals"), dtype=F64,
                                              device=self.device) for side in ("scan", "ref")}
        sample = int(cfg["check"]["normals_sample"])
        self.normal_idx = {side: torch.as_tensor(self.rng.choice(len(c), sample, replace=False),
                                                 device=self.device)
                           for side, c in self.clouds.items()}
        self._kp = {}
        self._desc_rows = None
        self._icp = None

    # ------------------------------------------------------------- normals --
    def normals_p90(self, dtype) -> float:
        k = int(self.cfg["normals"]["k"])
        angles = []
        for side, cloud in self.clouds.items():
            idx = self.normal_idx[side]
            want = common.knn_normals(cloud, idx, k, F64)
            got = (self.normals[side][idx] if dtype is None
                   else common.knn_normals(cloud, idx, k, dtype))
            angles.append(normal_angles(got, want))
        return _p90(torch.cat(angles))

    # ----------------------------------------------------------- keypoints --
    def keypoints(self, side: str, dtype) -> torch.Tensor:
        if dtype not in self._kp.setdefault(side, {}):
            kp = self.traffic["keypoint_selection"]
            self._kp[side][dtype] = common.density_keypoints(
                self.clouds[side].to(torch.float32), float(kp["neighborhood_size"]),
                int(kp["min_n_neighbors"]), dtype)
        return self._kp[side][dtype]

    def keypoint_mismatch(self, dtype) -> float:
        bad = total = 0
        for side in ("scan", "ref"):
            want = self.keypoints(side, torch.float32)
            got = (torch.as_tensor(getattr(self.out, f"{side}_keypoints"))
                   if dtype is None else self.keypoints(side, dtype))
            bad += _mismatch(got, want)
            total += want.numel()
        return bad / max(total, 1)

    # --------------------------------------------------------- descriptors --
    def descriptor_rows(self):
        """Per cloud, ``(cloud indices, rows of the program's descriptors)``
        of the sampled keypoints both sides selected."""
        if self._desc_rows is None:
            n = int(self.cfg["check"]["descriptor_sample"]) // 2
            self._desc_rows = {}
            for side in ("scan", "ref"):
                prog = np.asarray(getattr(self.out, f"{side}_keypoints"))
                common_idx = np.intersect1d(prog, self.keypoints(side, torch.float32).cpu().numpy())
                pick = np.sort(self.rng.choice(common_idx, min(n, len(common_idx)),
                                               replace=False))
                self._desc_rows[side] = (pick, np.searchsorted(prog, pick))
        return self._desc_rows

    def descriptor_err_p90(self, dtype) -> float:
        module = descriptor_module(self.cfg["reference"])
        errs = []
        for side, (idx, rows) in self.descriptor_rows().items():
            idx_t = torch.as_tensor(idx, device=self.device)
            want = module.descriptors(self.clouds[side], self.normals[side], idx_t, self.cfg, F64)
            if dtype is None:
                got = getattr(self.out, f"{side}_descriptors")[
                    torch.as_tensor(rows, device=self.device)].to(self.device)
            else:
                got = module.descriptors(self.clouds[side], self.normals[side], idx_t,
                                         self.cfg, dtype)
            diff = torch.linalg.norm((got.to(F64) - want), dim=-1)
            errs.append(diff / torch.clamp(torch.linalg.norm(want, dim=-1), min=1e-12))
        return _p90(torch.cat(errs))

    # ------------------------------------------------------------ matching --
    def match_gap_max(self, operand_dtype) -> float:
        scan_d = self.out.scan_descriptors.to(self.device)
        ref_d = self.out.ref_descriptors.to(self.device)
        ref_nz = torch.nonzero((ref_d != 0).any(dim=1))[:, 0]
        scan_rows, ref_rows = (torch.as_tensor(np.asarray(m), device=self.device)
                               for m in self.out.matches)
        n = min(int(self.cfg["check"]["match_sample"]), scan_rows.numel())
        pick = torch.as_tensor(np.sort(self.rng.choice(scan_rows.numel(), n, replace=False)),
                               device=self.device)
        position = torch.full((ref_d.shape[0],), -1, dtype=torch.int64, device=self.device)
        position[ref_nz] = torch.arange(ref_nz.numel(), device=self.device)
        rows = scan_rows[pick]
        if operand_dtype is None:
            chosen = position[ref_rows[pick]]
        else:
            chosen = common.nearest_rows(scan_d, ref_d[ref_nz], rows, operand_dtype)
        if bool((chosen < 0).any()):
            return math.inf
        return float(common.match_gaps(scan_d, ref_d[ref_nz], rows, chosen).max())

    # -------------------------------------------------------------- RANSAC --
    def matched(self):
        """The program's matched keypoint coordinates, scan and ref."""
        (scan_rows, ref_rows), out = self.out.matches, self.out
        scan_kp = np.asarray(out.scan_keypoints)[np.asarray(scan_rows)]
        ref_kp = np.asarray(out.ref_keypoints)[np.asarray(ref_rows)]
        return (self.clouds["scan"][torch.as_tensor(scan_kp, device=self.device)],
                self.clouds["ref"][torch.as_tensor(ref_kp, device=self.device)])

    def ransac_gaps(self, dtype) -> tuple[float, float]:
        """(rotation gap, translation gap) of the RANSAC transform to the
        nearest float64 Kabsch transform of a best draw: one with the most
        inliers over the configuration's draws, or one fewer (a match on the
        threshold may count on either side of it in float32)."""
        ransac = self.cfg["ransac"]
        thr = float(ransac["max_inliers_distance"])
        scan_m, ref_m = self.matched()
        draws = common.ransac_draws(scan_m.shape[0], int(ransac["n_draws"]),
                                    int(ransac["draw_size"]), int(ransac["seed"]))
        rot, t, counts = common.draw_transforms(scan_m, ref_m, draws, thr, F64)
        best = torch.nonzero(counts >= counts.max() - 1)[:, 0]
        got_r, got_t = (self.out.ransac if dtype is None
                        else common.ransac(scan_m, ref_m, draws, thr, dtype))
        gaps = [transform_errors(got_r, got_t, rot[b].cpu(), t[b].cpu()) for b in best.tolist()]
        return min(gaps)

    # ----------------------------------------------------------------- ICP --
    def icp(self, dtype):
        icp = self.cfg["icp"]
        rot, t = (x.to(self.device, F64) for x in self.out.ransac)
        return common.icp_point_to_plane(
            self.clouds["scan"], self.clouds["ref"], self.normals["ref"], rot, t,
            d_max=float(icp["d_max"]), voxel=float(icp["voxel_size"]),
            max_iter=int(icp["max_iter"]), rms_threshold=float(icp["rms_threshold"]),
            dtype=dtype)

    def icp_gaps(self, got=None) -> tuple[float, float]:
        """(rotation gap, translation gap) of ``got`` (the program's ICP
        transform when None) to the reference's ICP."""
        if self._icp is None:
            self._icp = self.icp(F64)
        want_r, want_t, _ = self._icp
        got_r, got_t = self.out.icp if got is None else got
        return transform_errors(got_r, got_t, want_r.cpu(), want_t.cpu())

    # ---------------------------------------------------------- evaluation --
    def evaluation_gaps(self, dtype) -> tuple[float, float]:
        """(overlap gap, keypoint-inlier gap): the shares of moved scan
        points, and of moved scan keypoints, within the evaluation's
        distance of the ref (keypoints), for the program's final transform."""
        thr = float(self.cfg["registration_evaluation"]["distance_to_map_threshold"])
        rot, t = (x.to(self.device, F64) for x in self.out.icp)
        moved = self.clouds["scan"] @ rot.T + t
        scan_kp = torch.as_tensor(np.asarray(self.out.scan_keypoints), device=self.device)
        ref_kp = torch.as_tensor(np.asarray(self.out.ref_keypoints), device=self.device)
        shares = []
        for dt in (F64, dtype):
            if dt is None:
                shares.append((self.out.overlap, self.out.inliers))
                continue
            ref = self.clouds["ref"].to(dt)
            shares.append((float(common.within(moved.to(dt), ref, thr)),
                           float(common.within(moved.to(dt)[scan_kp], ref[ref_kp], thr))))
        (o_ref, i_ref), (o_got, i_got) = shares
        return abs(o_got - o_ref), abs(i_got - i_ref)


def truth_errors(truths: list[tuple]) -> list[tuple[float, float]]:
    """The (rotation, translation) error of each final transform against the
    motion that made its pair: ``truths`` holds ``(rotation, translation,
    true rotation, true translation)``."""
    return [transform_errors(*t) for t in truths]


def truth_readings(truths: list[tuple]) -> dict[str, float]:
    """The widest truth errors over ``truths``."""
    errs = truth_errors(truths)
    return {"truth_rot_err_rad": max((e[0] for e in errs), default=math.inf),
            "truth_t_err": max((e[1] for e in errs), default=math.inf)}


def truth_failures(truths: list[tuple], limits: dict[str, float]) -> int:
    """The registrations whose truth errors pass their limits."""
    rot_lim, t_lim = (limits.get(name, -math.inf) for name in TRUTH)
    return sum(not (r <= rot_lim and t <= t_lim) for r, t in truth_errors(truths))


def pair_readings(out: PairOutputs, cfg: dict, traffic: dict, seed: int, device,
                  index: int = 0) -> dict[str, float]:
    """The reference's numbers for the program's outputs ``out`` of pool
    pair ``index``."""
    check = Check(out, cfg, traffic, seed, device, index)
    ransac_rot, ransac_t = check.ransac_gaps(None)
    rot_gap, t_gap = check.icp_gaps()
    overlap_gap, inlier_gap = check.evaluation_gaps(None)
    return {
        "normals_p90_rad": check.normals_p90(None),
        "keypoint_mismatch": check.keypoint_mismatch(None),
        "descriptor_err_p90": check.descriptor_err_p90(None),
        "match_gap_max": check.match_gap_max(None),
        "ransac_rot_gap_rad": ransac_rot,
        "ransac_t_gap": ransac_t,
        "icp_rot_gap_rad": rot_gap,
        "icp_t_gap": t_gap,
        "overlap_gap": overlap_gap,
        "inlier_gap": inlier_gap,
    }


def program_readings(outs: dict[int, PairOutputs], truths: list[tuple], cfg: dict,
                     traffic: dict, seed: int, device) -> dict[str, float]:
    """The numbers of a run: the truth errors over every registration in
    ``truths``, and the largest reading of each other number over the last
    registration of each pool pair (``outs``, by pool index)."""
    readings = truth_readings(truths)
    for index in sorted(outs):
        for name, value in pair_readings(outs[index], cfg, traffic, seed, device,
                                         index).items():
            readings[name] = max(readings.get(name, -math.inf), value)
    return readings


def control_readings(out: PairOutputs, cfg: dict, traffic: dict, seed: int,
                     device) -> dict[str, float]:
    """The same numbers for one pair with the reference, one precision lower,
    in the program's place (its final transform is its ICP's)."""
    check = Check(out, cfg, traffic, seed, device)
    low = torch.bfloat16
    ransac_rot, ransac_t = check.ransac_gaps(low)
    final_r, final_t, _ = check.icp(low)
    rot_gap, t_gap = check.icp_gaps((final_r, final_t))
    overlap_gap, inlier_gap = check.evaluation_gaps(low)
    return {
        **truth_readings([(final_r, final_t, out.rotation, out.translation)]),
        "normals_p90_rad": check.normals_p90(low),
        "keypoint_mismatch": check.keypoint_mismatch(low),
        "descriptor_err_p90": check.descriptor_err_p90(low),
        "match_gap_max": check.match_gap_max(torch.float8_e4m3fn),
        "ransac_rot_gap_rad": ransac_rot,
        "ransac_t_gap": ransac_t,
        "icp_rot_gap_rad": rot_gap,
        "icp_t_gap": t_gap,
        "overlap_gap": overlap_gap,
        "inlier_gap": inlier_gap,
    }


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: every number within its
    limit (a NaN or a missing limit fails)."""
    rows = [(name, value, limits.get(name)) for name, value in readings.items()]
    ok = all(limit is not None and value == value and value <= limit
             for _, value, limit in rows)
    return ok, rows
