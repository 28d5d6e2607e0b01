"""DeepSORT and ByteTrack in float32 NumPy with SciPy's Hungarian solver.

Frozen from the repository's independent oracles of the two trackers
(``tests/test_tracker_differential.py``: the deep_sort reference's predict,
gated appearance cascade by age, IoU stage, Kalman update, gallery, lifecycle
and sequential ids; ``tests/test_bytetrack.py``: the official
``BYTETracker.update``), which share no code with the program. Changed here,
with the same numbers: the appearance and IoU costs are computed a track at
a time with NumPy, the gallery is kept unit-normalized in a ring, and the
cascade visits only the ages that hold a track. Added: each track keeps the
class and score of the detection that last updated it, which the output
reports.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

TENTATIVE, CONFIRMED = 1, 2          # deep_sort's TrackState
TRACKED, LOST = 1, 2                 # ByteTrack's
CHI2_4 = 9.487729036781154
WP, WV = 1.0 / 20, 1.0 / 160
INFTY = 1e5


def _motion():
    f = np.eye(8, dtype=np.float32)
    f[np.arange(4), np.arange(4) + 4] = 1.0
    return f


_F = _motion()
_H = np.eye(4, 8, dtype=np.float32)


def kf_initiate(m):
    mean = np.concatenate([m, np.zeros(4, np.float32)]).astype(np.float32)
    h = m[3]
    std = np.array([2 * WP * h, 2 * WP * h, 1e-2, 2 * WP * h,
                    10 * WV * h, 10 * WV * h, 1e-5, 10 * WV * h], np.float32)
    return mean, np.diag(std * std).astype(np.float32)


def kf_predict_many(means, covs):
    """:func:`kf_predict` of ``n`` tracks at once."""
    h = means[:, 3]
    std = np.stack([WP * h, WP * h, np.full_like(h, 1e-2), WP * h,
                    WV * h, WV * h, np.full_like(h, 1e-5), WV * h], 1)
    q = np.zeros((len(h), 8, 8), np.float32)
    i = np.arange(8)
    q[:, i, i] = (std * std).astype(np.float32)
    return (means @ _F.T).astype(np.float32), \
        (_F @ covs @ _F.T + q).astype(np.float32)


def _project_many(means, covs):
    h = means[:, 3]
    std = np.stack([WP * h, WP * h, np.full_like(h, 1e-1), WP * h], 1)
    s = covs[:, :4, :4].copy()
    i = np.arange(4)
    s[:, i, i] += (std * std).astype(np.float32)
    return means[:, :4], s


def kf_gate_many(means, covs, meas):
    """Squared Mahalanobis distances ``(n, m)`` of ``m`` measurements to
    ``n`` tracks (:func:`kf_gate` at once)."""
    pm, s = _project_many(means, covs)
    l_ = np.linalg.cholesky(s.astype(np.float64))
    d = (meas[None, :, :] - pm[:, None, :]).transpose(0, 2, 1)
    z = np.linalg.solve(l_, d.astype(np.float64))
    return np.sum(z * z, axis=1)


def kf_update_many(means, covs, meas):
    """:func:`kf_update` of ``n`` tracks at once."""
    pm, s = _project_many(means, covs)
    s64 = s.astype(np.float64)
    gain = np.linalg.solve(s64, covs[:, :, :4].astype(np.float64)
                           .transpose(0, 2, 1)).transpose(0, 2, 1)
    new_mean = means + (gain @ (meas - pm)[..., None])[..., 0].astype(
        np.float32)
    new_cov = covs - (gain @ s64 @ gain.transpose(0, 2, 1)).astype(
        np.float32)
    return new_mean.astype(np.float32), new_cov.astype(np.float32)


def to_tlwh(mean):
    cx, cy, a, h = mean[:4]
    w = a * h if h > 0 else 0.0
    h = max(h, 0.0)
    return np.array([cx - w / 2, cy - h / 2, w, h], np.float32)


def xyah(tlwh):
    x, y, w, h = tlwh
    return np.array([x + w / 2, y + h / 2, (w / h if h else 0.0), h],
                    np.float32)


def iou_cost(a_tlwh, b_tlwh):
    """1 - IoU with the 1e-7 union floor, float32."""
    a = np.asarray(a_tlwh, np.float32).reshape(-1, 4)
    b = np.asarray(b_tlwh, np.float32).reshape(-1, 4)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, :2] + a[:, None, 2:],
                    b[None, :, :2] + b[None, :, 2:])
    wh = np.maximum(0.0, br - tl)
    inter = wh[..., 0] * wh[..., 1]
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] \
        - inter
    return (1.0 - inter / np.maximum(union, 1e-7)).astype(np.float32)


def _outputs(tracks, emit):
    """``[(x1, y1, x2, y2, id, class, conf), ...]`` of the emitted tracks,
    boxes clamped to a non-negative size."""
    out = []
    for t in tracks:
        if emit(t):
            x, y, w, h = to_tlwh(t["mean"])
            w, h = max(w, 0.0), max(h, 0.0)
            out.append((float(x), float(y), float(x + w), float(y + h),
                        t["id"], int(t["cls"]), float(t["conf"])))
    return out


class DeepSort:
    """deep_sort's ``Tracker``: ``step(tlwhs, confs, classes, feats)`` with
    ``feats[j]`` a unit vector or None; ``outputs()`` the confirmed tracks
    updated this frame."""

    def __init__(self, p: dict):
        self.p = p
        self.tracks = []
        self.next_id = 1

    def _min_cost(self, cost, rows, cols, max_dist):
        if not rows or not cols:
            return [], list(rows), list(cols)
        sub = cost[np.ix_(rows, cols)].copy()
        sub[sub > max_dist] = max_dist + 1e-5
        ri, ci = linear_sum_assignment(sub)
        matches, ur, uc = [], list(rows), list(cols)
        for r, c in zip(ri, ci):
            if sub[r, c] <= max_dist:
                matches.append((rows[r], cols[c]))
                ur.remove(rows[r])
                uc.remove(cols[c])
        return matches, ur, uc

    def _match(self, dets):
        nt, nd = len(self.tracks), len(dets)
        meas = np.stack([d["xyah"] for d in dets]) if nd else \
            np.zeros((0, 4), np.float32)
        have = [j for j, d in enumerate(dets) if d["feat"] is not None]
        fmat = (np.stack([dets[j]["feat"] / max(np.linalg.norm(
            dets[j]["feat"]), 1e-7) for j in have]) if have else None)
        app = np.full((nt, nd), INFTY, np.float32)
        rows = [i for i, t in enumerate(self.tracks) if t["gn"]]
        for i in rows:
            if have:
                g = self.tracks[i]["gal"][:self.tracks[i]["gn"]]
                app[i, have] = np.maximum(0.0, np.min(1.0 - g @ fmat.T, 0))
        if rows and nd:
            gd = kf_gate_many(
                np.stack([self.tracks[i]["mean"] for i in rows]),
                np.stack([self.tracks[i]["cov"] for i in rows]), meas)
            for r, i in enumerate(rows):
                app[i, gd[r] > CHI2_4] = INFTY

        confirmed = [i for i, t in enumerate(self.tracks)
                     if t["state"] == CONFIRMED]
        matches, unmatched = [], list(range(nd))
        # the cascade by age, over the levels that hold a track (a level
        # with none matches nothing)
        levels = sorted({self.tracks[i]["tsu"] - 1 for i in confirmed
                         if 0 <= self.tracks[i]["tsu"] - 1
                         < self.p["max_age"]})
        for level in levels:
            if not unmatched:
                break
            rows = [i for i in confirmed
                    if self.tracks[i]["tsu"] == level + 1]
            m, _, unmatched = self._min_cost(
                app, rows, unmatched, self.p["max_cosine_distance"])
            matches += m

        matched_rows = {i for i, _ in matches}
        iou_rows = [i for i, t in enumerate(self.tracks)
                    if t["state"] == TENTATIVE or (
                        t["state"] == CONFIRMED and i not in matched_rows
                        and t["tsu"] == 1)]
        iou = np.full((nt, nd), INFTY, np.float32)
        if nt and nd:
            iou = iou_cost(np.stack([to_tlwh(t["mean"]) for t in
                                     self.tracks]),
                           np.stack([d["tlwh"] for d in dets]))
        m, _, unmatched = self._min_cost(
            iou, iou_rows, unmatched, self.p["max_iou_distance"])
        matches += m
        all_matched = {i for i, _ in matches}
        unmatched_tracks = [i for i in range(nt) if i not in all_matched]
        return matches, unmatched_tracks, unmatched

    def _append(self, t, feat):
        """The gallery: the last ``nn_budget`` features, unit-normalized,
        in a ring (their order does not enter a minimum)."""
        f = np.asarray(feat, np.float32)
        if t["gal"] is None:
            t["gal"] = np.zeros((self.p["nn_budget"], f.shape[0]),
                                np.float32)
        t["gal"][t["gi"]] = f / max(np.linalg.norm(f), 1e-7)
        t["gi"] = (t["gi"] + 1) % self.p["nn_budget"]
        t["gn"] = min(t["gn"] + 1, self.p["nn_budget"])

    def step(self, tlwhs, confs, classes, feats):
        if self.tracks:
            means, covs = kf_predict_many(
                np.stack([t["mean"] for t in self.tracks]),
                np.stack([t["cov"] for t in self.tracks]))
            for t, m, c in zip(self.tracks, means, covs):
                t["mean"], t["cov"] = m, c
                t["tsu"] += 1
        dets = [dict(tlwh=np.asarray(b, np.float32), xyah=xyah(b),
                     conf=float(s), cls=int(c), feat=f)
                for b, s, c, f in zip(tlwhs, confs, classes, feats)]
        matches, um_tracks, um_dets = self._match(dets)
        if matches:
            means, covs = kf_update_many(
                np.stack([self.tracks[i]["mean"] for i, _ in matches]),
                np.stack([self.tracks[i]["cov"] for i, _ in matches]),
                np.stack([dets[j]["xyah"] for _, j in matches]))
            for (i, _), m, c in zip(matches, means, covs):
                self.tracks[i]["mean"], self.tracks[i]["cov"] = m, c
        for i, j in matches:
            t, d = self.tracks[i], dets[j]
            if d["feat"] is not None:
                self._append(t, d["feat"])
            t["hits"] += 1
            t["tsu"] = 0
            t["conf"], t["cls"] = d["conf"], d["cls"]
            if t["state"] == TENTATIVE and t["hits"] >= self.p["n_init"]:
                t["state"] = CONFIRMED
        for i in um_tracks:
            t = self.tracks[i]
            if t["state"] == TENTATIVE or t["tsu"] > self.p["max_age"]:
                t["dead"] = True
        for j in um_dets:
            d = dets[j]
            mean, cov = kf_initiate(d["xyah"])
            t = dict(id=self.next_id, mean=mean, cov=cov, hits=1, tsu=0,
                     state=TENTATIVE, conf=d["conf"], cls=d["cls"],
                     gal=None, gn=0, gi=0, dead=False)
            if d["feat"] is not None:
                self._append(t, d["feat"])
            self.tracks.append(t)
            self.next_id += 1
        self.tracks = [t for t in self.tracks if not t.get("dead")]

    def outputs(self):
        return _outputs(self.tracks, lambda t: t["state"] == CONFIRMED
                        and t["tsu"] == 0)


def _assign(cost, max_dist):
    """SciPy's Hungarian with the solver's clamp and post-check."""
    nr, nc = cost.shape
    if nr == 0 or nc == 0:
        return [], list(range(nr)), list(range(nc))
    sub = cost.copy()
    sub[sub > max_dist] = max_dist + 1e-5
    ri, ci = linear_sum_assignment(sub)
    matches, ur, uc = [], list(range(nr)), list(range(nc))
    for r, c in zip(ri, ci):
        if cost[r, c] <= max_dist:
            matches.append((r, c))
            ur.remove(r)
            uc.remove(c)
    return matches, ur, uc


class ByteTrack:
    """The official ``BYTETracker.update``: ``step(tlwhs, scores,
    classes)``; ``outputs()`` the activated tracks updated this frame."""

    def __init__(self, p: dict):
        self.p = p
        self.tracks = []
        self.frame_id = 0
        self.next_id = 1

    def _tlwhs(self, tracks):
        if not tracks:
            return np.zeros((0, 4), np.float32)
        return np.stack([to_tlwh(t["mean"]) for t in tracks])

    @staticmethod
    def _apply(updates):
        """One stage's matches ``[(track, tlwh, score, class), ...]``."""
        if not updates:
            return
        means, covs = kf_update_many(
            np.stack([t["mean"] for t, *_ in updates]),
            np.stack([t["cov"] for t, *_ in updates]),
            np.stack([xyah(b) for _, b, _, _ in updates]))
        for (t, _, score, cls), m, c in zip(updates, means, covs):
            t["mean"], t["cov"] = m, c
            t["state"] = TRACKED
            t["is_activated"] = True
            t["tsu"] = 0
            t["conf"] = score
            t["cls"] = cls

    def step(self, tlwhs, scores, classes, feats=None):
        p = self.p
        tlwhs = np.asarray(tlwhs, np.float32).reshape(-1, 4)
        scores = [float(s) for s in scores]
        clss = [int(c) for c in classes]
        self.frame_id += 1
        fid = self.frame_id
        det_thresh = p["track_thresh"] + 0.1 if p["det_thresh"] < 0 \
            else p["det_thresh"]

        pool = [t for t in self.tracks if t["is_activated"]]
        unconfirmed = [t for t in self.tracks if not t["is_activated"]]
        for t in pool:
            if t["state"] != TRACKED:
                t["mean"][7] = 0.0
        if pool:
            means, covs = kf_predict_many(np.stack([t["mean"] for t in pool]),
                                          np.stack([t["cov"] for t in pool]))
            for t, m, c in zip(pool, means, covs):
                t["mean"], t["cov"] = m, c
        for t in self.tracks:
            t["tsu"] += 1

        hi = [j for j in range(len(scores)) if scores[j] > p["track_thresh"]]
        lo = [j for j in range(len(scores))
              if p["low_thresh"] < scores[j] < p["track_thresh"]]
        sc = np.asarray(scores, np.float32)

        cost = iou_cost(self._tlwhs(pool), tlwhs[hi])
        if p["fuse_score"]:
            cost = 1.0 - (1.0 - cost) * sc[hi][None, :]
        m1, ur1, uc1 = _assign(cost, p["match_thresh"])
        self._apply([(pool[r], tlwhs[hi[c]], scores[hi[c]], clss[hi[c]])
                     for r, c in m1])
        u_high = [hi[c] for c in uc1]

        r_tracked = [pool[r] for r in ur1 if pool[r]["state"] == TRACKED]
        cost = iou_cost(self._tlwhs(r_tracked), tlwhs[lo])
        m2, ur2, _ = _assign(cost, p["second_match_thresh"])
        self._apply([(r_tracked[r], tlwhs[lo[c]], scores[lo[c]],
                      clss[lo[c]]) for r, c in m2])
        for r in ur2:
            r_tracked[r]["state"] = LOST

        cost = iou_cost(self._tlwhs(unconfirmed), tlwhs[u_high])
        if p["fuse_score"]:
            cost = 1.0 - (1.0 - cost) * sc[u_high][None, :]
        m3, ur3, uc3 = _assign(cost, p["unconfirmed_match_thresh"])
        self._apply([(unconfirmed[r], tlwhs[u_high[c]], scores[u_high[c]],
                      clss[u_high[c]]) for r, c in m3])
        for r in ur3:
            unconfirmed[r]["dead"] = True

        for c in uc3:
            j = u_high[c]
            if scores[j] < det_thresh:
                continue
            mean, cov = kf_initiate(xyah(tlwhs[j]))
            self.tracks.append(dict(
                mean=mean, cov=cov, state=TRACKED,
                is_activated=(fid == 1), tsu=0, start_frame=fid,
                id=self.next_id, cls=clss[j], conf=scores[j]))
            self.next_id += 1

        for t in self.tracks:
            if t["state"] == LOST and t["tsu"] > p["max_time_lost"]:
                t["dead"] = True
        self.tracks = [t for t in self.tracks if not t.get("dead")]

        a = [t for t in self.tracks if t["state"] == TRACKED]
        b = [t for t in self.tracks if t["state"] == LOST]
        d = iou_cost(self._tlwhs(a), self._tlwhs(b))
        dup = set()
        for i, j in zip(*np.where(d < p["dup_iou_cost"])):
            life_a = (fid - a[i]["tsu"]) - a[i]["start_frame"]
            life_b = (fid - b[j]["tsu"]) - b[j]["start_frame"]
            dup.add(id(b[j]) if life_a > life_b else id(a[i]))
        self.tracks = [t for t in self.tracks if id(t) not in dup]

    def outputs(self):
        return _outputs(self.tracks, lambda t: t["state"] == TRACKED
                        and t["is_activated"] and t["tsu"] == 0)


TRACKERS = {"deepsort": DeepSort, "bytetrack": ByteTrack}


def track_stream(job):
    """One stream's tracker over its frames: ``job = (params, frames)``,
    each frame ``(tlwhs, scores, classes, feats)``; returns each frame's
    outputs. A module-level function, so that a process pool can run one
    stream a worker."""
    params, frames = job
    trk = TRACKERS[params["kind"]](params)
    out = []
    for tlwhs, scores, classes, feats in frames:
        trk.step(tlwhs, scores, classes, feats)
        out.append(trk.outputs())
    return out
