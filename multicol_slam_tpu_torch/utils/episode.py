"""The organic loop-closure episode in the baffle world.

The episode of tests/test_organic_loop.py's fast variant on the in-repo
rig ``synth_rig3`` at its full 754x480: the baffle world (two walls with
offset doors, ``synthetic.BAFFLE_WALLS``) with the place-distinctive
texture, ``baffle_revisit_trajectory_short(112)`` (a lap of room A, the
corridor, a dip into room B, back, and the lap retraced), and the
tracker's pose replaced by dead reckoning (``synthetic.make_dead_reckoner``)
that drifts in translation from frame 10 and in heading from frame 48
(``DRIFT``, retuned for this rig; see there), so that the rig comes back
to room A with a drift no matching window absorbs. ``MultiColSLAM`` runs
with loop closing on, at ``SETTINGS`` and ``CAPACITY``; frames are
rendered by the port's renderer and rounded to uint8.

``run_episode`` drives a MultiColSLAM of either package (the harness
reads and wraps only what both have) and ``summary`` holds its outcome
to the bars of tests/test_organic_loop.py:296-352. ``resume`` restarts a
system from a map and relocalizes. tools/organic_loop.py runs the episode
from the command line, in either package; chip_smoke.py's phase 10 runs
it on the card.
"""

from __future__ import annotations

import copy
import os
import time
import types

import numpy as np
import torch

from ..ops import se3_np
from . import config_io, synthetic
from .checkpoint import _POOLS
from .trajectory import ate_rmse

# The drift, retuned from tests/test_organic_loop.py's fast variant
# (:189-190: 0.006 m and 0.004 rad a frame from frame 10, and 0.0135 rad a
# frame over frames 52-66). On this rig that uniform heading drift loses
# the track in the corridor (frames 44-73, in both packages); without it
# the tracker re-derives its pose from the images every frame, so a
# heading pulse alone never bends the map, tracking re-associates room A
# through the corridor and no loop is left to close. Here: the fast
# variant's body-frame translation drift, no uniform heading drift, and a
# heading drift of 0.004 rad a frame from frame 48 (room B) to the end.
# PERF.md (section 6) has the sweep.
N_FRAMES = 112
DRIFT = dict(drift_step=0.006, yaw_step=0.0, yaw_pulse=0.004, pulse_frames=(48, 112))
SETTINGS = dict(n_features=300, n_levels=4, fps=8.0)
CAPACITY = dict(capacity_pts=25000, capacity_kfs=96)
WIDE_SPAN = 20          # a wide loop's fired pair spans more frames than this
# the bars of tests/test_organic_loop.py:296-352
MIN_WORKING = 0.85
PAIR_T_RATIO, PAIR_T_ABS = 0.35, 0.05     # after < 0.35x before, or < 5 cm
PAIR_R_RATIO, PAIR_R_ABS = 0.5, 1.0       # after < 0.5x before, or < 1 degree
ATE_RATIO = 1.005


def make_frames(rig, n_frames: int = N_FRAMES):
    """(ground truth (n, 4, 4), frame(t) -> uint8 (C, H, W) tensor on the
    rig's device): the baffle episode's world and tour."""
    gt = synthetic.baffle_revisit_trajectory_short(n_frames)
    render = synthetic.make_renderer(rig, room_half=synthetic.BAFFLE_ROOM_HALF,
                                     door_wall=list(synthetic.BAFFLE_WALLS),
                                     place_texture=True)
    dev = rig.M_c.device

    def frame(t):
        return torch.round(render(torch.tensor(gt[t], dtype=torch.float32,
                                               device=dev))).to(torch.uint8)
    return gt, frame


def hom(mt) -> np.ndarray:
    return se3_np.cayley2hom(np.asarray(mt, np.float64))


def pair_error(poses, gt, m, kf, loop_kf):
    """(m, degrees): the fired pair's relative pose in ``poses`` (keyframe
    -> Cayley pose) against ground truth's."""
    d = np.linalg.inv(np.linalg.inv(hom(poses[kf])) @ hom(poses[loop_kf])) @ (
        np.linalg.inv(gt[int(m.kf_frame_id[kf])]) @ gt[int(m.kf_frame_id[loop_kf])])
    c = (np.trace(d[:3, :3]) - 1.0) / 2.0
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def keyframe_ate(poses, gt, m, kfs):
    """Sim3-aligned ATE of the keyframes ``kfs`` at ``poses``."""
    est = np.stack([hom(poses[k])[:3, 3] for k in kfs])
    return ate_rmse(est, np.stack([gt[int(m.kf_frame_id[k])][:3, 3] for k in kfs]))


def trimmed_map(m):
    """A copy of a MapStore's saved state (either package) with its pools
    cut to the live rows (capacities ``_next_pt`` and ``_next_kf``), in a
    form both packages' ``save_map`` take."""
    P, N = int(m._next_pt), int(m._next_kf)
    out = types.SimpleNamespace(
        capacity_pts=P, capacity_kfs=N, n_cams=m.n_cams, k_per_cam=m.k_per_cam,
        desc_words=m.desc_words, _next_pt=P, _next_kf=N,
        pt_obs=copy.deepcopy(dict(m.pt_obs)), pt_replaced=dict(m.pt_replaced),
        kf_loop_edges=copy.deepcopy(dict(m.kf_loop_edges)),
        kf_features=list(m.kf_features[:N]))
    for name in _POOLS:
        setattr(out, name, np.array(getattr(m, name)[:P if name.startswith("pt_") else N]))
    return out


def loop_state(lc, kf: int, frame_id: int) -> dict:
    """What the loop closer needs to replay ``insert_keyframe(kf)``: the
    vocabulary, the keyframe database's keyframes in insertion order, the
    consistency groups, ``last_loop_kf``, the query keyframe and frame,
    and, for the JAX package, its Sim3 RANSAC key."""
    voc = lc.voc
    arr = lambda a: np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)
    out = dict(
        vocabulary=dict(centroids=arr(voc.centroids).view(np.uint32).tolist(),
                        children=arr(voc.children).tolist(),
                        word_of_node=arr(voc.word_of_node).tolist(),
                        weights=arr(voc.weights).astype(float).tolist(),
                        k=int(voc.k), levels=int(voc.levels), n_words_=int(voc.n_words_)),
        db_kfs=[int(k) for k in lc.db.kf_bow],
        consistent_groups=[[sorted(int(g) for g in grp), int(c)]
                           for grp, c in lc.consistent_groups],
        last_loop_kf=int(lc.last_loop_kf), query_kf=int(kf), frame_id=int(frame_id))
    if hasattr(lc, "key"):
        out["jax_key"] = [int(v) for v in np.asarray(lc.key)]
    return out


def run_episode(slam, frame, gt, drift=None, save_map=None, fixture=None,
                seed_closer=None, sync=lambda: None, log=print, n_frames=None,
                on_frame=None):
    """Drive ``slam`` (a MultiColSLAM of either package, its tracker's pose
    replaced by the dead reckoner at ``drift``, default ``DRIFT``) over the
    episode. ``frame(t)`` gives the images the system takes;
    ``save_map``/``fixture`` write the loop closer's replay fixture: the
    map trimmed to its live rows as it stood just before the
    ``insert_keyframe`` call whose detection led to the wide correction,
    and in ``extra`` the loop closer's state (``loop_state``).
    ``seed_closer(lc)`` seeds the loop closer once it exists; ``sync()``
    waits for the device before a frame's clock stops; ``on_frame(t)`` is
    called after frame t is tracked. Keyframe poses are snapshotted
    around the first correction, and again around each later one until a
    wide loop (a fired pair more than WIDE_SPAN frames apart) has been
    corrected, as ``_run_organic_loop`` does
    (tests/test_organic_loop.py:226-292). Returns ``summary``'s dict."""
    n_frames = len(gt) if n_frames is None else n_frames
    pre, post = {}, {}
    ep = {"wide": False, "fired": None, "all_fired": [], "sim3_ms": [], "correct_ms": [],
          "wrapped": False, "fixture_written": False}
    slam.tracker.perturb_pose_fn = synthetic.make_dead_reckoner(
        slam, gt, **(DRIFT if drift is None else drift), stop_fn=lambda: ep["wide"])
    m = slam.map

    def wrap(lc):
        correct, compute, insert = lc._correct_loop, lc._compute_sim3_and_correct, \
            lc.insert_keyframe
        match_pairs = lc._matched_point_pairs

        def snap_then_correct(kf, loop_kf, S12):
            fresh = not ep["wide"]
            if fresh:
                pre.clear()
                post.clear()
                pre.update({k: m.kf_pose[k].copy() for k in m.keyframe_ids().tolist()})
                ep["fired"] = (kf, loop_kf)
            sync()
            t0 = time.perf_counter()
            out = correct(kf, loop_kf, S12)
            sync()
            ep["correct_ms"].append((time.perf_counter() - t0) * 1e3)
            ep["all_fired"].append((int(kf), int(loop_kf)))
            if fresh:
                post.update({k: m.kf_pose[k].copy() for k in m.keyframe_ids().tolist()})
                if m.kf_frame_id[kf] > m.kf_frame_id[loop_kf] + WIDE_SPAN:
                    ep["wide"] = True
            return out

        def counted_pairs(kf1, kf2):
            pairs = match_pairs(kf1, kf2)
            ep["pairs"] = (len(pairs), sum(p[0] == p[1] for p in pairs))
            return pairs

        def timed_compute(kf, cand):
            n_corr = len(ep["correct_ms"])
            sync()
            t0 = time.perf_counter()
            ok = compute(kf, cand)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            ep["sim3_ms"].append(ms - sum(ep["correct_ms"][n_corr:]))
            log(f"  ComputeSim3 keyframe {kf} (frame {m.kf_frame_id[kf]}) against {cand} "
                f"(frame {m.kf_frame_id[cand]}): BoW pairs {ep['pairs'][0]}, of them "
                f"{ep['pairs'][1]} one landmark; {'accepted' if ok else 'rejected'}, "
                f"{ms:.1f} ms")
            return ok

        def snap_then_insert(kf):
            state = None
            if fixture and not ep["wide"]:
                state = (trimmed_map(m), loop_state(lc, kf, slam.tracker.frame_id))
            out = insert(kf)
            if state is not None and ep["wide"] and not ep["fixture_written"]:
                save_map(fixture, state[0], extra=state[1])
                ep["fixture_written"] = True
                log(f"fixture: {fixture} ({os.path.getsize(fixture)} bytes), the map "
                    f"before insert_keyframe({kf}) at frame {state[1]['frame_id']}")
            return out

        lc._correct_loop = snap_then_correct
        lc._compute_sim3_and_correct = timed_compute
        lc._matched_point_pairs = counted_pairs
        lc.insert_keyframe = snap_then_insert
        if seed_closer is not None:
            seed_closer(lc)
        ep["wrapped"] = True

    states, kinds, frame_ms = [], [], []
    t_start = time.perf_counter()
    for t in range(n_frames):
        images = frame(t)
        was_working = slam.state.name == "WORKING"
        n_passes = len(slam.mapping_ms)
        sync()
        t0 = time.perf_counter()
        slam.track(images, t / SETTINGS["fps"])
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(slam.state.name)
        kinds.append("init" if not was_working and slam.tracker.frame_path[-1] == "init" else
                     "reloc" if slam.tracker.frame_path[-1] == "reloc" else
                     "lost" if states[-1] != "WORKING" else
                     "keyframe" if len(slam.mapping_ms) > n_passes else "working")
        lc = slam.loop_closer
        if lc is not None and not ep["wrapped"]:
            wrap(lc)
        log(f"frame {t}: {states[-1]} kfs={m.n_keyframes()} pts={m.n_points()} "
            f"loop={lc.last_loop_kf if lc is not None else None} {kinds[-1]} "
            f"{frame_ms[-1]:.1f} ms", flush=True)
        if on_frame is not None:
            on_frame(t)
    wall_s = time.perf_counter() - t_start
    return summary(slam, gt, states, kinds, frame_ms, pre, post, ep, wall_s)


def summary(slam, gt, states, kinds, frame_ms, pre, post, ep, wall_s) -> dict:
    """The episode's outcome. ``bars`` holds the bars of
    tests/test_organic_loop.py and ``ok`` says all six were met;
    ``repaired`` says the weaker outcome of a working loop path: WORKING
    share above MIN_WORKING, a wide loop fired, and after its correction
    the pair's errors and the keyframe ATE no worse than before (the same
    bars with both ratios 1)."""
    m, lc = slam.map, slam.loop_closer
    out = dict(frames=len(states), wall_s=wall_s, keyframes=int(m.n_keyframes()),
               points=int(m.n_points()),
               last_loop_kf=None if lc is None else int(lc.last_loop_kf),
               corrections=ep["all_fired"], sim3_ms=ep["sim3_ms"], correct_ms=ep["correct_ms"],
               frame_ms={k: [round(x, 3) for x, kd in zip(frame_ms, kinds) if kd == k]
                         for k in sorted(set(kinds))})
    first = states.index("WORKING") if "WORKING" in states else None
    out["init_frame"] = first
    out["working_share"] = (float(np.mean([s == "WORKING" for s in states[first:]]))
                            if first is not None else 0.0)
    bars = {"working": out["working_share"] > MIN_WORKING,
            "fired": lc is not None and lc.last_loop_kf >= 0 and ep["fired"] is not None}
    no_worse = False
    if bars["fired"]:
        kf, loop_kf = ep["fired"]
        out["fired"] = [int(kf), int(loop_kf)]
        out["fired_frames"] = [int(m.kf_frame_id[kf]), int(m.kf_frame_id[loop_kf])]
        bars["wide"] = bool(ep["wide"])
        t0, r0 = pair_error(pre, gt, m, kf, loop_kf)
        t1, r1 = pair_error(post, gt, m, kf, loop_kf)
        kfs = sorted(set(pre) & set(post))
        a0, a1 = keyframe_ate(pre, gt, m, kfs), keyframe_ate(post, gt, m, kfs)
        out.update(pair_t=[t0, t1], pair_deg=[r0, r1], ate=[a0, a1])
        bars["pair_t"] = t1 < PAIR_T_RATIO * t0 or t1 < PAIR_T_ABS
        bars["pair_r"] = r1 < PAIR_R_RATIO * r0 or r1 < PAIR_R_ABS
        bars["ate"] = a1 < ATE_RATIO * a0
        no_worse = ((t1 < t0 or t1 < PAIR_T_ABS) and (r1 < r0 or r1 < PAIR_R_ABS)
                    and bars["ate"])
    out["bars"] = bars
    out["ok"] = all(bars.values()) and len(bars) == 6
    out["repaired"] = bars["working"] and bars.get("wide", False) and no_worse
    return out


def describe(seed, res) -> str:
    s = (f"seed {seed}: init at frame {res['init_frame']}, WORKING share "
         f"{res['working_share']:.4f}, {res['keyframes']} keyframes, {res['points']} points, "
         f"corrections {res['corrections']}")
    if "fired" in res:
        s += (f"; fired pair {res['fired']} (frames {res['fired_frames']}), pair error "
              f"{res['pair_t'][0]:.4f} -> {res['pair_t'][1]:.4f} m, {res['pair_deg'][0]:.3f} -> "
              f"{res['pair_deg'][1]:.3f} deg; keyframe ATE {res['ate'][0]:.5f} -> "
              f"{res['ate'][1]:.5f} m")
    s += (f"; ComputeSim3 ms {[round(x, 1) for x in res['sim3_ms']]}, CorrectLoop ms "
          f"{[round(x, 1) for x in res['correct_ms']]}; bars {res['bars']}; "
          f"{'OK' if res['ok'] else 'MISSED'}; loop repaired: {res['repaired']}; "
          f"wall {res['wall_s']:.1f} s")
    return s


def resume(slam, m, frame_id: int):
    """Load map ``m`` into ``slam`` (the port's or the JAX package's
    MultiColSLAM), set the tracker LOST and feed the episode's two frames
    after ``frame_id``, as tests/test_persistence.py resumes. Returns for
    each returned pose its (m, degrees) error against ground truth's step
    from its reference keyframe (``reference_keyframe``, ``step_error``)
    and the frame that keyframe was made at; None for a frame without a
    pose."""
    gt, frame = make_frames(slam.rig)
    slam.map = slam.tracker.map = slam.mapper.map = m
    tr = slam.tracker
    tr.state = type(tr.state).LOST
    tr.frame_id = frame_id
    tr.cur_pt = np.full(m.kf_pt.shape[1:3], -1, np.int32)
    errs = []
    for t in (frame_id + 1, frame_id + 2):
        M = slam.track(frame(t), t / SETTINGS["fps"])
        kf = None if M is None else reference_keyframe(tr, m, frame_id)
        errs.append(None if kf is None else (
            *step_error(m, gt, kf, t, np.asarray(M, np.float64)), int(m.kf_frame_id[kf])))
    return errs


def reference_keyframe(tracker, m, frame_id: int):
    """The keyframe of map ``m`` made at or before frame ``frame_id`` that
    shares the most landmarks with the tracker's current frame (its inlier
    associations), as ORB-SLAM picks a frame's reference keyframe; None if
    none shares one. Until a loop is corrected the map holds a revisited
    place twice, the first pass and the drifted revisit, and a
    relocalized pose is right only against the copy it matched."""
    saved = set(int(k) for k in m.keyframe_ids() if m.kf_frame_id[k] <= frame_id)
    votes = {}
    for p in tracker.cur_pt[(tracker.cur_pt >= 0) & ~tracker.cur_outlier].tolist():
        for kf, _, _ in m.pt_obs.get(p, ()):
            if kf in saved:
                votes[kf] = votes.get(kf, 0) + 1
    return max(votes, key=lambda k: (votes[k], -k)) if votes else None


def step_error(m, gt, kf: int, t: int, M: np.ndarray):
    """(m, degrees): pose M (4, 4) of frame t against ground truth, both
    relative to keyframe ``kf`` of map m, so that the map's drift up to
    that keyframe does not count."""
    est = np.linalg.inv(hom(m.kf_pose[kf])) @ M
    true = np.linalg.inv(gt[int(m.kf_frame_id[kf])]) @ gt[t]
    c = (np.trace(est[:3, :3].T @ true[:3, :3]) - 1.0) / 2.0
    return (float(np.linalg.norm(est[:3, 3] - true[:3, 3])),
            float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))


def port_system(device, seed):
    """(system, ground truth, frame(t), seed_closer, sync): the port's
    MultiColSLAM at the episode's settings on ``device``, seeded. A seed
    sets the tracker's generator and the loop closer's; seed 42 is the
    system's defaults (tracker 42, loop closer 7)."""
    from ..models.system import MultiColSLAM
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR,
                        settings=config_io.SlamSettings(**SETTINGS), device=device,
                        enable_loop_closing=True, **CAPACITY)
    slam.tracker.gen.manual_seed(seed)
    gt, frame = make_frames(slam.rig)
    seed_closer = None if seed == 42 else (lambda lc: lc.gen.manual_seed(seed))
    sync = (lambda: torch.cuda.synchronize()) if slam.device.type == "cuda" else (lambda: None)
    return slam, gt, frame, seed_closer, sync
