#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multicol_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the Hamming-NN kernel from multicol_slam_tpu_torch/csrc with
     nvcc, timed;
  3. both entries of the kernel against their plain PyTorch versions on
     the card, both variants: the dense-gate entry (hamming_nn) at the
     WORKING frame's shapes and ragged ones, with fully gated rows and
     duplicate minima; the window-gated entry (hamming_nn_radius) on the
     adversarial cases of tests/_radius_cases.py (points exactly on the
     radius, both edges of the level window, fully gated rows, duplicate
     minima, queries shared by every camera, 4, 8 and 16 words). Exact
     equality;
  4. the WORKING frame (extraction, motion-model tracking, local-map
     tracking) at the default SlamSettings: the in-repo 3-camera rig at
     754x480, 8 levels x 1.2, 400 features per camera, against a map lifted
     from frame 0 at the true pose, over 16 frames rendered on the card.
     Every frame must keep >= 15 local-map inliers and stay within 5 cm
     and 1 degree of ground truth, and the main path must launch the
     window-gated entry twice per frame and the dense-gate entry never;
  5. the first frames of that run against the port's CPU path (the plain
     Hamming-NN versions) on the same frames and map;
  6. the system from the first frame: MultiColSLAM(calib_dir=...) at its
     defaults, so on the card and with loop closing on, at the default
     SlamSettings on the same rig, fed the first 40 of 43 frames of
     synthetic.bench_trajectory rendered on the card, with no ground-truth
     map: bootstrap (mutual matching, 5-point RANSAC), the Tracker state
     machine, keyframes mapped synchronously (triangulation, cross-camera
     points, fuse, Schur local BA) and handed to the loop closer. It must
     initialize within 20 frames, stay WORKING on >= 90% of the frames
     after that, create and map >= 3 keyframes, reach an ATE (Sim3-aligned)
     of at most 5 cm, build the loop closer with a trained vocabulary, put
     every keyframe in the keyframe database, fire no loop on this
     loop-free path, and launch the kernel at every call site of the
     system's path: the window-gated entry at initialization and its
     mutual check, the previous-frame window search, motion-model and
     local-map tracking and fuse; the dense-gate entry at triangulation
     and cross-camera triangulation. Each site's entry must equal its plain
     version exactly on the site's recorded inputs. Per-frame times by kind
     and per-pass mapping times are printed beside the card's name and
     power limit;
  7. relocalization on the card, on phase 6's system: (a) a forced
     relocalization on frame 40 (BoW candidates, SearchByBoW, GP3P RANSAC,
     pose LM) that recovers, frame 41 on the "reloc_recent" path, the ATE
     over all 43 frames at most 5 cm; (b), run first, frame 20's images
     again under a forced relocalization (a kidnap), recovered within 5 cm
     and 1 degree of the pose phase 6 tracked there; (d), run second, the
     same kidnap with the tracker's BoW hooks unset, as in a system built
     with enable_loop_closing=False: the recent keyframes matched by a
     window search over the whole image, to the same bar; (c)
     tests/test_full_slam.py's second-chance round: 16 BoW triples, half
     corrupted, defeat the single-pass fit, and the projection round
     (reloc_projection_match) recovers, alone too;
  8. loop closing on the card, on the same map, at the bars of
     tests/test_loop_closing.py: SearchByBoW between the first two
     keyframes (>= 15 pairs, > 60% the same landmark); ComputeSim3 between
     them (Sim3 RANSAC, OptimizeSim3, the guided SearchBySim3 round, the
     neighbourhood support) near their own relative pose; the guided round
     adding inliers to a starved seed set; CorrectLoop on an injected
     drift, exact with the essential graph neutralized and improving every
     keyframe with it, then once through the system's own loop closer
     (SearchAndFuse on); the 14-keyframe out-and-back chain; global
     bundle adjustment taking 3 cm of point noise at least halfway back.
     The map is restored after each step;
  9. the system at the reference's own extractor options:
     MultiColSLAM(calib_dir=..., settings=SlamSettings(use_mdbrief=True,
     learn_masks=True, use_agast=True, fast_agast_type=2)), mdBRIEF with
     its learned stability masks over AGAST 7_12 corners, otherwise at the
     defaults, on phase 6's frames with a relocalization forced on frame
     MDBRIEF_RELOC_AT (33) and another on frames 40-42, then phase 7's
     second-chance round. Phase 6's bars but the ATE's (MDBRIEF_MAX_ATE,
     see there), masked matching in the tracker and the mapper; the
     relocalization on frame 33 run through SearchByBoW and GP3P and
     recovered by frame 35, every returned pose within 5 cm and 1 degree
     of ground truth's step from frame 32 (the one on frames
     40-42 is printed, not held: see MDBRIEF_RELOC_AT); every call site
     but SearchByBoW launched with the stability masks on every launch,
     and SearchByBoW with none (as in the JAX package); each masked site
     equal to its plain version. On one frame, both extractors on the card
     against the port's CPU extractors: identical keypoints, levels and
     validity, at most MAX_MDBRIEF_BIT_DIFF of the descriptor and of the
     mask bits different;
 10. the organic loop closure (multicol_slam_tpu_torch/utils/episode.py,
     the counterpart of tests/test_organic_loop.py's fast variant):
     MultiColSLAM on the card with loop closing on, at
     SlamSettings(n_features=300, n_levels=4, fps=8.0) on the same rig,
     over the 112 frames of the baffle world's short revisit tour with
     the place-distinctive texture, its pose replaced by dead reckoning
     (episode.DRIFT: translation drift from frame 10, heading drift from
     frame 48, room A out of sight), at the eight seeds of ORGANIC_SEEDS:
     the tracker's default (42) alone in this process, then the other
     seven side by side, one worker process each. Every run launches
     entry A at the tracking and mapping sites, and a run that fires a
     wide loop (a pair more than 20 frames apart) at the four loop sites
     too (loop SearchByBoW, guided SearchBySim3, neighbourhood support,
     loop SearchAndFuse), each site equal to its plain version. At least
     ORGANIC_MIN_REPAIRED runs must repair a wide loop: WORKING on more
     than 85% of the frames after init, a wide loop fired by the system
     itself, and after the correction the pair's relative-pose errors and
     the keyframe ATE no worse than before (the bars of
     tests/test_organic_loop.py with both ratios 1; their own count of
     runs, which on this rig meet them at a rate of about 0.2, is
     printed and not held). Then a resume: the seed-42 run's map as it
     stood after frame ORGANIC_RESUME_AT (104, in the revisit) saved with
     utils/checkpoint.py, loaded onto the card (every part equal to the
     saved map) into a fresh MultiColSLAM, the tracker set LOST and
     frames 105-106, which no keyframe of that map saw, fed; a returned
     pose must lie within 5 cm and 1 degree of ground truth's step from
     its reference keyframe (the saved map's keyframe sharing the most
     landmarks with it). Frame ms by kind (the seed-42 run alone)
     and the ms of each ComputeSim3 and CorrectLoop call are printed;
 11. the system's other modes on phase 6's frames at the default settings:
     (a) MultiColSLAM(calib_dir=..., async_mapping=True), its mapper in a
     thread of its own on a CUDA stream of its own, to phase 6's bars;
     the two bootstrap passes inline and every later pass on the mapper
     thread and its stream, the mapper's launches (triangulation and
     cross-camera on entry B, fuse on entry A) all on that stream, each
     site equal to its plain version, no failure in the mapper, the queue
     empty and the thread joined after shutdown; the keyframes refused
     while the mapper was busy, the interrupted passes and the WORKING
     frame's median and p90 against phase 6's are printed; (b) a fresh
     system's track_batch(chunk=8) over the same frames, held to
     tests/test_chunked_tracking.py's bars against phase 6's per-frame
     run (the same frames tracked, ATE under twice the per-frame one or 2
     cm, at least 0.6x the keyframes and 0.5x the points, each pose within
     0.15 m, at least a third of the steady frames with no dispatch),
     entry A launched inside the chunk scan at the motion and local-map
     sites, each equal to plain; ms a frame chunked against per frame and
     the dispatches a frame are printed; (c) under async mapping, reset()
     called while a keyframe's pass runs: the pass ends on the map as it
     was, then the queue, the map, the mapper and the loop closer are
     empty, and the system initializes again within 20 frames; (d)
     python3 -m multicol_slam_tpu_torch.cli --synthetic 24 --async-mapping
     on the card as a subprocess: exit 0, the trajectory and map.npz
     written, the map loading onto the card, the ATE it prints matched by
     python3 -m multicol_slam_tpu_torch.evaluate against the ground truth
     saved here;
 12. the stretch configuration (BASELINE.json's fifth) and a dynamic
     scene: (a) the eight-camera surround rig of tests/test_eight_camera.py
     (eight copies of the in-repo rig's camera 0 on a 0.3 m ring, 45
     degrees apart about y), built on the card, its projection checked
     against the CPU's, then MultiColSLAM(rig=<that ring>,
     settings=SlamSettings(use_mdbrief=True, learn_masks=True,
     use_agast=True, fast_agast_type=2), capacity_pts=20000,
     capacity_kfs=64, enable_loop_closing=False) at full width (8 x
     754x480, 400 features, 8 levels) over that test's tour (10 lateral
     frames at 0.08 m, then a 17-frame arc of radius 0.6) in its 2.5 m
     room, held to its bars: at least 3 keyframes, over 400 points, at
     least 60% of the frames tracked, and an ATE under RING_MAX_ATE (25
     cm; that test's 5 cm is printed: neither package meets it at these
     settings, see RING_MAX_ATE); the system on the card, every launch
     masked and on the card, each site equal to its plain version; (b)
     self-calibrating MultiCol BA on that map: every keyframe through
     assemble_ba_problem, the first two and camera 0 the gauge
     (SELFCAL_FIXED_KFS; one keyframe fixed is printed), cameras 1-7
     perturbed by tests/test_optimizer.py's offsets (odd cameras by camera
     1's, even ones by camera 2's), self_calibrating_bundle_adjustment and
     bundle_adjustment(free_mc=True): camera 0 unchanged exactly, the cost
     no higher, every perturbed camera at least 4x closer to where the same
     BA takes the rig the map was built with, and, with every measurement
     projected through that rig, at least 4x closer to the rig itself; the
     extrinsic and intrinsics Jacobians on the card against the CPU's;
     then refine_intrinsics with every principal point off by (+1.5,
     -1.0) px, each at least 3x closer; every output on the card, ms per
     call printed; (c) tests/test_dynamic_scene.py's run on
     the in-repo rig at full width: MultiColSLAM (loop closing on) at
     SlamSettings(n_features=300, n_levels=4, fps=8.0) over
     bench_trajectory(48, radius=0.7) with that test's three textured
     spheres crossing the room, held to its bars (WORKING share at least
     0.85 from the first tracked frame, ATE under 4 cm, no loop fired, at
     least one landmark culled), each site equal to its plain version.
 13. the two-room tour and the sharded global BA: (a) tests/test_two_room.py's
     run on the in-repo rig at full width: MultiColSLAM (loop closing on)
     at SlamSettings(n_features=250, n_levels=4, fps=8.0),
     capacity_pts=25000, capacity_kfs=96, over 64 frames of
     two_room_loop_trajectory through the door wall, held to that test's
     bars (WORKING share from the first WORKING frame above 0.9, at least
     10 keyframes, more than 500 points, no loop fired), each site equal
     to its plain version, frame ms by kind printed; (b) on copies of the
     two-room map and of phase 6's map (as phase 8 leaves it),
     run_global_ba with the default mesh (one card: the single-device
     branch) and with devices=[cuda:0] * D for D = 2, 4, 8: the summed
     chi2 within 2% of the single-device run's and keyframe 0 unmoved, the
     largest pose and point differences printed; the same problems in
     float64 through make_sharded_ba and bundle_adjustment within 1e-8;
     (c) the JAX package's map-scale dry run (make_ba_problem(rig, 64,
     8192, max_obs_per_pt=8), about 59k observations, float32, 4
     iterations): the sharded BA at D = 8 within 2% of the single path's
     robust cost, both below 0.8 of the start; the per-iteration costs of
     make_sharded_ba_step and the single path, each step taken or not; ms
     per iteration of the single path and of D = 1, 2, 4, 8 on the one
     card (the cost of sharding: the shards share one card), the peak
     memory of the D = 8 run; every output on the card.

Each of phases 6, 7, 8, 9, 10, 11 (a) and (b), 12 (a) and (c) and 13 (a)
sets the launch counts to 0 just before it drives its path and reads them
just after. For each call site (phases 4, 6-13) the script times, on the
card: the entry's device time per launch (CUDA-graph replay, so no host
enqueue in it), one call between two events as earlier versions timed
(host enqueue included), the plain version, and at the window-gated sites the path the
site ran before the in-kernel gate (the torch gate build plus the
dense-gate entry). It computes each site's bound from the inputs (bytes
over 3.35 TB/s, float operations over 67 TFLOP/s, popcounts over 16 per
clock per SM at 1.98 GHz on 132 SMs) and its gate density. Phases 7 and 8
also print the time of a relocalization, of the ComputeSim3 stage (its
first, cold call and the warm ones, each split into its stages and the
forward-mode Jacobians inside OptimizeSim3), of CorrectLoop, of the
essential-graph optimization (its edge Jacobians apart) and of the
vocabulary transform.

Prints the wall seconds of every phase and of the whole script, the card
line, a JSON line of the kernels (one entry per call site), and last
{"ok": true, "device": {...}}. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch

B = 16                 # frames of the main run
B_REF = 2              # frames checked against the CPU path
MAX_T_ERR = 0.05       # m, the bar of tests/test_e2e_slice.py
MAX_R_ERR = 1.0        # degrees
SYS_FRAMES = 40        # frames of the system run (phase 6)
SYS_INIT_BY = 20       # it must initialize within this many frames
SYS_WORKING_FRAC = 0.9
SYS_MIN_KFS = 3
SYS_MAX_ATE = 0.05     # m, Sim3-aligned
RELOC_FRAMES = 3       # frames after the system run, the first relocalized (phase 7)
KIDNAP_FRAME = 20      # the frame fed again under a forced relocalization
DRIFT = [0.01, -0.01, 0.02, 0.05, 0.08, -0.05, 0.0]   # tests/test_loop_closing.py
# the kernel's call sites: the innermost function on the call stack that
# names each (the mapper's fuse under CorrectLoop is "loop_fuse")
SITES = {"search_for_initialization": "init", "_track_previous_frame": "window_search",
         "_motion_track_core": "motion", "_local_map_core": "local_map",
         "triangulation_batch": "triangulation", "cross_camera_batch": "cross_camera",
         "fuse_targets_batch": "fuse", "_reloc_matches": "reloc_window",
         "bow_match_frame": "reloc_bow", "_reloc_project_candidate": "reloc_projection",
         "_matched_point_pairs": "loop_bow", "_guided_sim3_pairs": "guided_sim3",
         "_count_neighborhood_support": "support"}
SITE_KIND = {"init": "radius", "init_mutual": "radius", "window_search": "radius",
             "motion": "radius", "local_map": "radius", "triangulation": "dense",
             "cross_camera": "dense", "fuse": "radius", "reloc_window": "radius",
             "reloc_bow": "radius", "reloc_projection": "radius", "loop_bow": "radius",
             "guided_sim3": "radius", "support": "radius", "loop_fuse": "radius",
             "chunk_motion": "radius", "chunk_local_map": "radius"}
# a launch from the async mapper's thread names its site with this suffix
MAPPER = "_mapper"
# the sites each phase's path must launch
SYS_SITES = ("init", "init_mutual", "window_search", "motion", "local_map",
             "triangulation", "cross_camera", "fuse")
RELOC_SITES = ("reloc_bow", "reloc_projection", "reloc_window")
LOOP_SITES = ("loop_bow", "guided_sim3", "support", "loop_fuse")
# phase 9: the reference's extractor options, mdBRIEF with learned masks
# over AGAST 7_12 corners; every site it reaches takes the masked distance
# but SearchByBoW, unmasked as in the JAX package (loop_closing.py:267, :308)
MDBRIEF = dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=2)
MDBRIEF_SITES = ("init", "init_mutual", "window_search", "motion", "local_map",
                 "triangulation", "cross_camera", "fuse", "reloc_projection")
# Phase 9 holds a relocalization forced on this frame, the one after the
# keyframe every run makes at frame 32: it must recover by two frames
# later, every returned pose within MAX_T_ERR / MAX_R_ERR of ground
# truth's step from that keyframe (reloc_error). It prints, and does not hold,
# a second one forced on frames 40-42, 0.64 m from that keyframe, where at
# these settings the outcome turns on a few bits: GP3P keeps 3-9 of about
# 30 SearchByBoW matches, the pose LM from the keyframe's pose fails, and
# the projection round that starts from the failed pose finds 4-47
# associations, 10 of which pass. tools/mdbrief_study.py, seeds 42 and
# 1-7: the relocalized frame lands within 5 cm at 7 of 8 in the JAX
# package on its own features, at 2 of 8 in the JAX package on the port's
# CPU features (a few bits in 1e5 apart), at 1 of 8 in the port on the
# card; on frame 33 the port recovers at 8 of 8 within 1.73 cm.
MDBRIEF_RELOC_AT = 33
UNMASKED_SITES = ("reloc_bow", "loop_bow")
# card against CPU extraction at phase 9's settings: share of descriptor and
# of mask bits that may differ (float32 atan2/cos/sin differ in the last
# ulp between the card and the CPU, and a pattern point within an ulp of .5
# rounds the other way)
MAX_MDBRIEF_BIT_DIFF = 1e-4
# phase 9's ATE bar, m: over the same 40 frames at these settings the JAX
# package's ATE spans 3.37-16.08 cm across sixteen RANSAC seeds on the
# CPU (42, 1-15), the port's 2.50-11.52 cm across sixteen runs on the card
# (tools/mdbrief_study.py), so the default's 5 cm fails the reference at
# most seeds; the bar lies above both spreads, where a broken path lands
MDBRIEF_MAX_ATE = 0.20
# phase 10: the episode's seeds, the tracker's default first, run in this
# process; the others run side by side on the card, one worker process
# each (chip_smoke.py --organic-worker SEED DIR)
ORGANIC_SEEDS = (42, 1, 2, 3, 4, 5, 6, 7)
# phase 10 holds the loop path to the rate at which it repairs a wide loop
# (episode.summary's "repaired": WORKING share above 0.85, a wide loop
# fired, the pair's errors and the keyframe ATE no worse after the
# correction): at least this many of the eight runs. On the card at
# episode.DRIFT 20 of 28 runs repaired the loop (PERF.md, section 6), a
# rate of 0.71, at which eight runs give fewer than 3 with probability
# 0.009; a loop path that never fires, or that corrects the pair away
# from the truth, repairs none. The six bars of tests/test_organic_loop.py
# were met by 6 of those 28 runs, and by 3 of 6 runs of the JAX package on
# the CPU: phase 10 prints their count and does not hold it.
ORGANIC_MIN_REPAIRED = 3
ORGANIC_WORKER_S = 900          # s the workers may take once started
# phase 10's resume: the map of the seed-42 run as it stood after this
# frame of the revisit, the tracker then set LOST on the two frames after.
# Frames 105-106 look at the tour's start, which the first lap mapped
# before the drift began, so their reference keyframes agree whether or
# not the run closed its wide loop. Earlier in the revisit a map without
# the loop holds the place twice (the first lap and the drifted revisit),
# and a relocalized pose there can straddle both: over 8 card runs of
# seed 42 (tools/resume_study.py, PERF.md section 6) every frame after
# 104 lay within 4.0 mm and 0.114 degree, while after frame 80 two runs
# relocalized nothing and two missed the bars.
ORGANIC_RESUME_AT = 104
# phase 10: the sites every run of the organic episode must launch; a run
# that fires a wide loop must also launch LOOP_SITES (a relocalization adds
# the relocalization sites, which are then timed too)
ORGANIC_SITES = ("init", "init_mutual", "motion", "local_map", "triangulation",
                 "cross_camera", "fuse")
# phase 11: the sites of the async run, the tracking thread's and the mapper
# thread's (whose launches must all go on the mapper's stream), and of the
# chunked run's scan
ASYNC_MAPPER_SITES = tuple(s + MAPPER for s in ("triangulation", "cross_camera", "fuse"))
ASYNC_SITES = ("init", "init_mutual", "window_search", "motion", "local_map") + ASYNC_MAPPER_SITES
CHUNK_SITES = ("chunk_motion", "chunk_local_map")
CHUNK = 8              # frames a chunk of track_batch
RESET_AT = 12          # phase 11 (c): frames before the reset with a pass in flight
CLI_FRAMES = 24        # phase 11 (d): synthetic frames of the CLI run
# phase 12 (a): the stretch configuration (BASELINE.json's fifth), the
# eight-camera surround rig of tests/test_eight_camera.py (eight copies of
# the in-repo rig's camera 0 on a 0.3 m ring, 45 degrees apart) at full
# width, mdBRIEF with learned masks at the defaults otherwise, in that
# test's room and over its tour, held to its bars
RING_CAMS = 8
RING_RADIUS = 0.3
RING_ROOM_HALF = 2.5
RING_LATERAL, RING_ARC = 10, 17   # lateral frames at 0.08 m, then the arc's frames
RING_SETTINGS = dict(MDBRIEF, fps=8.0)   # the test's frame rate: a keyframe at most 8 frames apart
RING_MIN_KFS, RING_MIN_PTS, RING_TRACKED_FRAC = 3, 400, 0.6
# the ring's ATE bar, m. tests/test_eight_camera.py holds 5 cm (RING_TEST_ATE,
# Lafida's camera at half width with ORB); on this ring at full width with
# mdBRIEF neither package meets it: the first 5-11 steps after the
# bootstrap are 1.5-6.0x ground truth's before local BA pulls the scale in
# (every later step within 10%), so the Sim3-aligned ATE over
# the tour spans 7.84-21.22 cm in the JAX package (CPU, seeds 42 and 1-4)
# and 7.27-18.12 cm in the port (card, seeds 42 and 1-7; tools/ring_study.py,
# PERF.md, PR 8).
# The bar lies above both spreads; the comparison with 5 cm is printed.
RING_MAX_ATE, RING_TEST_ATE = 0.25, 0.05
RING_SITES = ("init", "init_mutual", "motion", "local_map", "triangulation",
              "cross_camera", "fuse")
# phase 12 (b): tests/test_optimizer.py's offsets of cameras 1 and 2 (odd
# cameras take camera 1's, even ones camera 2's), its iterations, and how
# much closer each perturbed camera and principal point must come back
SELFCAL_OFFSET = {1: [0.002, -0.002, 0.002, 0.004, -0.004, 0.004],
                  0: [-0.002, 0.002, 0.001, -0.004, 0.004, 0.002]}
SELFCAL_ITERS, INTRINSICS_ITERS = 10, 8
# the keyframes held fixed beside camera 0: with one, the whole map and the
# extrinsics' translations can scale about camera 0's first centre at no
# cost, only lambda holds the LM along that free scale, and where it ends
# changes with the card's unordered sums (phase 12 (b) prints that run);
# tests/test_optimizer.py fixes two
SELFCAL_FIXED_KFS = 2
SELFCAL_MIN_GAIN, INTRINSICS_MIN_GAIN = 4.0, 3.0
# phase 12 (c): tests/test_dynamic_scene.py's run and bars on the in-repo rig
DYN_FRAMES, DYN_RADIUS = 48, 0.7
DYN_SETTINGS = dict(n_features=300, n_levels=4, fps=8.0)
DYN_SPHERES = [dict(center=(0.9, 0.1, 0.9), velocity=(-0.06, 0.0, -0.03), radius=0.22),
               dict(center=(-1.0, -0.2, 0.6), velocity=(0.08, 0.01, 0.0), radius=0.18),
               dict(center=(0.2, 0.4, -1.0), velocity=(0.0, -0.02, 0.07), radius=0.25)]
DYN_WORKING_FRAC, DYN_MAX_ATE = 0.85, 0.04
DYN_NOT_HELD = ()       # bars printed and not held
DYN_SITES = ("init", "init_mutual", "motion", "local_map", "triangulation",
             "cross_camera", "fuse")
# phase 13 (a): tests/test_two_room.py's tour on the in-repo rig at full
# width (Lafida is absent), held to that test's bars
TWO_ROOM_SETTINGS = dict(n_features=250, n_levels=4, fps=8.0)
TWO_ROOM_FRAMES = 64
TWO_ROOM_HALF = (2.2, 2.2, 3.6)
TWO_ROOM_DOOR = dict(z=0.0, door_half_x=0.8, door_half_y=1.3)
TWO_ROOM_WORKING_FRAC, TWO_ROOM_MIN_KFS, TWO_ROOM_MIN_PTS = 0.9, 10, 500
TWO_ROOM_SITES = ("init", "init_mutual", "motion", "local_map", "triangulation",
                  "cross_camera", "fuse")
# phase 13 (b), (c): the sharded global BA. Shards share the one card, so
# they measure what sharding costs, not how it scales. Float32 runs are
# held at the objective, the JAX package's documented bound (VERDICT.md:
# 62-64: sums in another order flip accept / reject in a flat valley);
# float64 runs element-wise, at tests/test_sharding.py:193-194's bar
SHARDS = (2, 4, 8)
GBA_ITERS = 10
SHARD_MAX_REL = 0.02
SHARD_F64_TOL = 1e-8
# (c) the JAX package's map-scale dry run (__graft_entry__.py:76-96): its
# problem, offsets (poses 0.002, points 0.01, keyframe 0 fixed) and
# iterations, and its bar that the LM lowers the cost below 0.8 of the start
MAP_KF, MAP_PT, MAP_OBS, MAP_ITERS = 64, 8192, 8, 4
MAP_MIN_GAIN = 0.8
# the stages of a ComputeSim3 call timed apart (phase 8); "its_jacobians"
# is the forward-mode Jacobian time inside optimize_sim3
SIM3_STAGES = ("draws", "horn", "score", "optimize_sim3", "its_jacobians", "guided", "support")
ENTRY = {"radius": "hamming_nn_radius", "dense": "hamming_nn"}
SOURCE = "multicol_slam_tpu_torch/csrc/hamming_nn.cu"
REPLACES = "multicol_slam_tpu/ops/pallas/hamming_nn.py:146"
REPLACES_MASKED = "multicol_slam_tpu/ops/pallas/hamming_nn.py:206"
LIBRARY = ("none: torch has no popcount, and no call reduces to a gated best, "
           "second-best and argmin")
HBM_BYTES_S = 3.35e12          # H100 SXM device memory
F32_OPS_S = 67e12              # H100 SXM float32 outside the tensor cores
POPC_S = 16 * 132 * 1.98e9     # popcounts per clock per SM x SMs x boost clock


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median time of one fn() call between two CUDA events, host enqueue
    included (how the kernel's first version was timed)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median device time of one fn(): reps calls captured in one CUDA
    graph, the graph replayed between two events, divided by reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def random_case(C, N, M, dev, gen):
    """Random words with duplicate minima (the second half of db repeats
    the first, and queries copy db rows) and fully gated rows (every
    fifth row)."""
    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64, device=dev).to(torch.int32)
    q, db = words(C, N, 8), words(C, M, 8)
    half = M // 2
    db[:, half:2 * half] = db[:, :half]
    n_copy = min(N, half)
    q[:, :n_copy] = db[:, :n_copy]
    gate = torch.rand((C, N, M), generator=gen, device=dev) < 0.3
    gate[:, :n_copy, :half] = True
    gate[:, ::5] = False
    return q, db, gate, words(C, N, 8), words(C, M, 8)


def compare(knn, kind, args) -> int:
    """An entry against its plain version on the same tensors; returns max
    |diff| (0)."""
    got = getattr(knn, ENTRY[kind])(*args)
    want = getattr(knn, ENTRY[kind] + "_reference")(*args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if err:
        fail(f"{ENTRY[kind]} differs from its plain version at {tuple(args[0].shape)} x "
             f"{tuple(args[1].shape)} ({len(args)} arguments): max |diff| {err}")
    return err


def radius_cases():
    """tests/_radius_cases.py: entry A's adversarial inputs, made with
    numpy from a seed."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _radius_cases
    return _radius_cases


def radius_args(case, dev, masked):
    """A case of tests/_radius_cases.py as entry A's arguments on dev."""
    words = lambda a: torch.from_numpy(a.view(np.int32).copy()).to(dev)
    args = [words(case["q"]), words(case["db"])] + [
        torch.from_numpy(case[k]).to(dev) for k in ("q_uv", "q_r2", "q_lvl_lo", "q_lvl_hi",
                                                 "q_ok", "db_xy", "db_lvl", "db_ok")]
    return args + ([words(case["q_mask"]), words(case["db_mask"])] if masked else [])


def split(kind, args):
    """(q, db, gate fields or gate, masks) of an entry's arguments."""
    n = 10 if kind == "radius" else 3
    return args[0], args[1], args[2:n], args[n:]


def gate_counts(knn, kind, args):
    """(pairs the gate allows, pairs whose distance test runs, all pairs)."""
    _, _, fields, _ = split(kind, args)
    if kind == "dense":
        gate = fields[0].bool()
        return int(gate.sum()), 0, gate.numel()
    q_uv, q_r2, lo, hi, q_ok, db_xy, db_lvl, db_ok = fields
    lvl = db_lvl[:, None, :]
    cand = (lvl >= lo[..., None]) & (lvl <= hi[..., None]) & q_ok[..., None] & db_ok[:, None]
    gate = knn.radius_gate(*fields)
    return int(gate.sum()), int(cand.sum()), gate.numel()


def bound(knn, kind, args):
    """(bound ms, 'bytes' or 'operations', gate density): the least time
    for this call's work on an H100 SXM. Bytes: every input read once and
    the outputs written once. Operations: popcounts for the pairs the gate
    allows, and for entry A the five float operations of the distance test
    for the pairs that pass the validity and level tests."""
    q, db, fields, masks = split(kind, args)
    C, N = db.shape[0], q.shape[1]
    n_gate, n_cand, n_all = gate_counts(knn, kind, args)
    nbytes = sum(t.numel() * t.element_size() for t in [q, db, *fields, *masks]) + 12 * C * N
    popc = n_gate * q.shape[2] * (2 if masks else 1)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(popc / POPC_S, 5 * n_cand / F32_OPS_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_gate / n_all)


def previous_path(knn, args):
    """What a window-gated site ran before the in-kernel gate: the dense
    gate built by the torch expressions, queries copied to every camera,
    then the dense-gate entry."""
    q, db, fields, masks = split("radius", args)
    wide = lambda t: t.expand((db.shape[0],) + tuple(t.shape[1:])).contiguous()
    masks = (wide(masks[0]), masks[1]) if masks else ()
    return knn.hamming_nn(wide(q), db, knn.radius_gate(*fields).contiguous(), *masks)


def site_entry(knn, site, kind, args, launches, card):
    """Compare, time and bound one call site's recorded inputs; returns
    its entry of the kernels line."""
    entry = getattr(knn, ENTRY[kind])
    plain = getattr(knn, ENTRY[kind] + "_reference")
    err = compare(knn, kind, args)
    ms = device_ms(lambda: entry(*args))
    call = cuda_ms(lambda: entry(*args))
    plain_ms = device_ms(lambda: plain(*args))
    prev = device_ms(lambda: previous_path(knn, args)) if kind == "radius" else None
    bound_ms, bound_by, density = bound(knn, kind, args)
    q, db, _, masks = split(kind, args)
    print(f"{ENTRY[kind]} at {site}: q {tuple(q.shape)} db {tuple(db.shape)}, {launches} "
          f"launches, gate density {density:.6f}: device {ms * 1e3:.2f} us a launch "
          f"(bound {bound_ms * 1e3:.3f} us, {bound_by}), one call {call * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us" + (f", previous path {prev * 1e3:.2f} us" if prev else "")
          + f" ({card})")
    if prev is not None and not ms < prev:
        print(f"note: at {site} the entry ({ms:.5f} ms) is not below the previous path "
              f"({prev:.5f} ms)")
    return {"name": f"{ENTRY[kind]}@{site}", "entry": "A" if kind == "radius" else "B",
            "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_MASKED if masks else REPLACES,
            "launches": launches, "max_abs_err": err, "ms": ms, "call_ms": call,
            "plain_ms": plain_ms, "prev_path_ms": prev, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by, "library_ms": None,
            "library": LIBRARY, "gate_density": density,
            "shape": [list(q.shape), list(db.shape)]}


class SiteSpy:
    """Stands in for the matcher module's two kernel entries: names each
    launch's call site (with MAPPER appended on the async mapper's thread),
    counts it, keeps each site's first inputs and the CUDA streams its
    launches went on; the wrappers still launch and count. Launches may
    come from two threads at once."""

    def __init__(self, knn, matcher):
        self.knn, self.matcher = knn, matcher
        self.launches, self.masked, self.args = Counter(), Counter(), {}
        self.streams = {}
        self.lock = threading.Lock()

    def _call(self, kind, args):
        site = call_site()
        if threading.current_thread().name == "multicol-mapper":
            site += MAPPER
        with self.lock:
            if site == "init" and self.launches["init"] > self.launches["init_mutual"]:
                site = "init_mutual"           # the swapped second launch
            self.launches[site] += 1
            self.masked[site] += len(args) > (10 if kind == "radius" else 3)
            self.args.setdefault(site, (kind, args))
            self.streams.setdefault(site, set()).add(
                torch.cuda.current_stream().cuda_stream if torch.cuda.is_available() else None)
        return getattr(self.knn, ENTRY[kind])(*args)

    def __enter__(self):
        self.matcher.hamming_nn = lambda *a: self._call("dense", a)
        self.matcher.hamming_nn_radius = lambda *a: self._call("radius", a)
        return self

    def __exit__(self, *exc):
        self.matcher.hamming_nn = self.knn.hamming_nn
        self.matcher.hamming_nn_radius = self.knn.hamming_nn_radius


def call_site() -> str:
    """The call site of the current Hamming-NN call."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        names.append(f.f_code.co_name)
        f = f.f_back
    site = next((SITES[n] for n in names if n in SITES), None)
    if site is None:
        fail("a Hamming-NN entry was called from an unknown call site")
    if site in ("motion", "local_map") and "working_scan_chunk" in names:
        return "chunk_" + site
    return "loop_fuse" if site == "fuse" and "_correct_loop" in names else site


def site_kind(site: str) -> str:
    return SITE_KIND[site[:-len(MAPPER)] if site.endswith(MAPPER) else site]


def reset_launches(knn):
    knn.hamming_nn.launches = 0
    knn.hamming_nn_radius.launches = 0


def make_slice(settings, rig):
    """The extractor and match parameters MultiColSLAM builds from
    SlamSettings (system.py), for the WORKING frame."""
    from multicol_slam_tpu_torch.models import extractor, matcher
    from multicol_slam_tpu_torch.ops.camera import make_extraction_masks
    from multicol_slam_tpu_torch.ops.pyramid import level_sizes

    s = settings
    w, h = int(rig.cams.width[0]), int(rig.cams.height[0])
    masks = []
    for c in range(rig.n_cams):
        if float(rig.cams.mirror[c]) > 0.5:
            masks.append(make_extraction_masks(float(rig.cams.u0[c]),
                                               float(rig.cams.v0[c]), w, h,
                                               s.n_levels, s.scale_factor))
        else:
            masks.append([np.full(sz, 255, np.uint8) for sz in
                          level_sizes(h, w, s.n_levels, s.scale_factor)])
    masks_lvl = [np.stack([m[lvl] for m in masks]) for lvl in range(s.n_levels)]
    cfg = extractor.ExtractorConfig(
        n_features=s.n_features, scale_factor=s.scale_factor,
        n_levels=s.n_levels, fast_th=s.fast_th, desc_bytes=s.desc_size,
        use_harris=s.score_harris)
    extract = extractor.make_extractor(cfg, rig.cams, masks_lvl, (h, w))
    params = matcher.MatchParams(desc_bytes=s.desc_size,
                                 masked=s.use_mdbrief and s.learn_masks,
                                 scale_factor=s.scale_factor)
    return extract, params


def run_chunk(extract, rig, frames, st, params, settings, tcfg):
    from multicol_slam_tpu_torch.models import tracking
    return tracking.working_scan_chunk(
        extract, rig, frames, st["mt0"], st["V0"], st["last"], st["slot_X0"],
        st["slot_lp0"], st["slot_has0"], st["X"], st["normal"], st["mind"],
        st["maxd"], st["cand_base"], st["pt_desc"], st["pt_mask"], params,
        th_motion=tcfg.motion_th, th_local=tcfg.local_map_th,
        n_levels=settings.n_levels, scale_factor=settings.scale_factor)


def percentiles(xs):
    return (f"median {statistics.median(xs):.3f} p90 {float(np.percentile(xs, 90)):.3f} "
            f"(n={len(xs)})") if xs else "none"


def check_launches(knn, spy, sites, card, tag=""):
    """The launches of a phase's path: each entry's count equals the sum
    over its call sites, and every site of ``sites`` launched. Returns the
    sites' kernel JSON entries (compared, timed and bounded), each named
    by its site and ``tag``."""
    launches = {k: getattr(knn, ENTRY[k]).launches for k in ENTRY}
    for kind in ENTRY:
        by_site = sum(n for s, n in spy.launches.items() if site_kind(s) == kind)
        if by_site != launches[kind]:
            fail(f"call-site launches {dict(spy.launches)} do not add up to "
                 f"{ENTRY[kind]}'s {launches[kind]}")
    print(f"launches {launches} by call site: {dict(spy.launches)}")
    entries = []
    for site in sites:
        if not spy.launches[site]:
            fail(f"the kernel was not launched at call site {site}")
        got_kind, args = spy.args[site]
        if got_kind != site_kind(site):
            fail(f"call site {site} used {ENTRY[got_kind]}, want {ENTRY[site_kind(site)]}")
        entries.append(site_entry(knn, site + tag, got_kind, args, spy.launches[site], card))
    return entries


def timed(fn):
    """(fn(), host ms around it, ending in a sync of this thread's stream:
    an async mapper's stream runs on)."""
    torch.cuda.current_stream().synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.current_stream().synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class StageClock:
    """Host ms (each call ended by a device sync) spent in named functions
    while the clock is entered. A target is (owner, attribute, label) or,
    for a function that returns the function to time (``jacfwd``),
    (owner, attribute, label, True). A stage's time includes the stages
    it calls."""

    def __init__(self, *targets):
        self.targets = targets
        self.ms = Counter()

    def _timed(self, f, label):
        def stage(*a, **k):
            out, ms = timed(lambda: f(*a, **k))
            self.ms[label] += ms
            return out
        return stage

    def __enter__(self):
        self.saved = []
        for owner, attr, label, *factory in self.targets:
            f = getattr(owner, attr)
            self.saved.append((owner, attr, f, attr in vars(owner)))
            g = (lambda *a, _f=f, _l=label, **k: self._timed(_f(*a, **k), _l)) if factory \
                else self._timed(f, label)
            setattr(owner, attr, g)
        return self

    def __exit__(self, *exc):
        for owner, attr, f, own in reversed(self.saved):
            if own:
                setattr(owner, attr, f)
            else:
                delattr(owner, attr)

    def line(self, labels):
        return ", ".join(f"{lb} {self.ms[lb]:.3f}" for lb in labels)


def system_phase(dev, knn, card):
    """Phase 6: MultiColSLAM.track from the first frame. Returns (the
    system, the frames and ground truth of all three system phases, the
    pose returned at each frame, the kernel JSON entries of the system
    path's call sites, and what phase 11 compares with: the poses, map
    sizes, dispatches and frame ms by kind of this per-frame run)."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.loop_closing import MIN_KFS_BETWEEN_LOOPS
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    if slam.rig.M_c.device != dev:
        fail(f"MultiColSLAM with no device runs on {slam.rig.M_c.device}, not {dev}")
    gt = synthetic.bench_trajectory(SYS_FRAMES + RELOC_FRAMES)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)

    # the main path, counted: every launch goes through the wrappers; the
    # spy names its call site and keeps each site's first inputs
    kinds, times, init_frame, returned = [], [], None, {}
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        for i in range(SYS_FRAMES):
            was_working = slam.state == TrackState.WORKING
            n_passes = len(slam.mapping_ms)
            returned[i], ms = timed(lambda: slam.track(frames[i], i / 25.0))
            times.append(ms)
            if returned[i] is not None and init_frame is None:
                init_frame = i
            kinds.append(frame_kind(slam, was_working, n_passes))

    tr = slam.tracker
    m = slam.map
    print(f"system: init at frame {init_frame}, {m.n_keyframes()} keyframes "
          f"({len(slam.mapping_ms)} mapping passes), {m.n_points()} points, "
          f"frame paths {dict(Counter(tr.frame_path))}")
    if init_frame is None or init_frame >= SYS_INIT_BY:
        fail(f"the system did not initialize within {SYS_INIT_BY} frames")
    after = SYS_FRAMES - init_frame - 1
    n_work = len(tr.all_poses) - 1
    if n_work < SYS_WORKING_FRAC * after:
        fail(f"WORKING on {n_work} of the {after} frames after init")
    if len(slam.mapping_ms) < SYS_MIN_KFS or m.n_keyframes() < SYS_MIN_KFS:
        fail(f"{m.n_keyframes()} keyframes, {len(slam.mapping_ms)} mapped; "
             f"want >= {SYS_MIN_KFS}")
    poses = np.stack(tr.all_poses)
    if not np.isfinite(poses).all():
        fail("non-finite poses")
    k = len(poses)
    ate = ate_rmse(poses[:, :3, 3], gt[SYS_FRAMES - k:SYS_FRAMES, :3, 3])
    print(f"system ATE (Sim3-aligned, {k} frames) {ate:.5f} m")
    if ate > SYS_MAX_ATE:
        fail(f"ATE {ate:.4f} m above {SYS_MAX_ATE} m")
    for kind in ("init", "working", "keyframe"):
        xs = [t for t, kd in zip(times, kinds) if kd == kind]
        print(f"system frame ms, {kind}: {percentiles(xs)} ({card})")
    print(f"system mapping_ms per pass: "
          f"{[round(x, 3) for x in slam.mapping_ms]} ({card})")

    # loop closing: built with the first keyframe, a vocabulary trained
    # from it, every keyframe in the database, no loop on this path
    lc = slam.loop_closer
    if lc is None or slam._vocabulary_path is not None or lc.voc.n_words < 100:
        fail("the system built no loop closer with a trained vocabulary")
    kfs = sorted(m.keyframe_ids().tolist())
    if sorted(lc.db.kf_bow) != kfs:
        fail(f"keyframe database {sorted(lc.db.kf_bow)}, keyframes {kfs}")
    if lc.last_loop_kf != -MIN_KFS_BETWEEN_LOOPS or any(m.kf_loop_edges[k] for k in kfs):
        fail("a loop fired on a loop-free trajectory")
    print(f"system loop closer: vocabulary of {lc.voc.n_words} words (k={lc.voc.k}, "
          f"{lc.voc.levels} levels), keyframe database {kfs}, no loop")
    ref = dict(poses=[returned[i] for i in range(SYS_FRAMES)], n_kf=m.n_keyframes(),
               n_pt=m.n_points(), ate=ate, disp=list(tr.dispatches_per_frame),
               frame_ms={kd: [t for t, k2 in zip(times, kinds) if k2 == kd]
                         for kd in ("init", "working", "keyframe")})
    return slam, frames, gt, returned, check_launches(knn, spy, SYS_SITES, card), ref


def reloc_phase(knn, card, slam, frames, gt, poses):
    """Phase 7: relocalization on the card. Returns the kernel JSON entries
    of its call sites."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.ops import ransac, se3_np
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    tr, m = slam.tracker, slam.map
    calls, cands, reloc_ms = Counter(), [], []
    orig = {"gpnp": ransac.ransac_gpnp, "cands": tr.reloc_candidates_fn}

    def gpnp(*a, **k):
        calls["ransac_gpnp"] += 1
        return orig["gpnp"](*a, **k)

    def candidates(feats):
        cands.append(orig["cands"](feats))
        return cands[-1]

    def optimize(*a, _f=tr._optimize_current_pose):
        calls["pose_lm"] += 1
        return _f(*a)

    def relocalize(_f=tr._relocalize):
        ok, ms = timed(_f)
        reloc_ms.append(ms)
        return ok

    ransac.ransac_gpnp = gpnp
    tr.reloc_candidates_fn = candidates
    tr._optimize_current_pose = optimize
    tr._relocalize = relocalize
    reset_launches(knn)
    try:
        with SiteSpy(knn, matcher) as spy:
            # (b) a kidnap: frame KIDNAP_FRAME's images again, first, while
            # the map is phase 6's (a relocalized frame can become a
            # keyframe, and its local BA moves the map)
            before = {k: se3_np.cayley2hom(m.kf_pose[k]) for k in m.keyframe_ids()}
            tr.force_reloc = True
            t = SYS_FRAMES / 25.0
            M, ms = timed(lambda: slam.track(frames[KIDNAP_FRAME], t))
            d_t, d_r = pose_errors_hom(M, poses[KIDNAP_FRAME]) if M is not None else (None, None)
            print(f"reloc (b): kidnapped to frame {KIDNAP_FRAME}: path {tr.frame_path[-1]}, "
                  f"pose against phase 6's {d_t} m {d_r} deg, frame ms {ms:.3f}, "
                  f"{keyframes_moved(m, before)} ({card})")
            if tr.frame_path[-1] != "reloc" or M is None or d_t > MAX_T_ERR or d_r > MAX_R_ERR:
                fail("the kidnapped frame did not relocalize within "
                     f"{MAX_T_ERR} m / {MAX_R_ERR} deg")

            # (d) the kidnap again with the BoW hooks unset, the path of a
            # system built with enable_loop_closing=False: the ten most
            # recent keyframes matched by a window search over the image
            hooks = tr.reloc_candidates_fn, tr.reloc_bow_match_fn
            tr.reloc_candidates_fn = tr.reloc_bow_match_fn = None
            tr.force_reloc = True
            try:
                M, ms = timed(lambda: slam.track(frames[KIDNAP_FRAME], t + 0.5 / 25.0))
            finally:
                tr.reloc_candidates_fn, tr.reloc_bow_match_fn = hooks
            d_t, d_r = pose_errors_hom(M, poses[KIDNAP_FRAME]) if M is not None else (None, None)
            print(f"reloc (d): kidnapped to frame {KIDNAP_FRAME} with no BoW hooks: path "
                  f"{tr.frame_path[-1]}, pose against phase 6's {d_t} m {d_r} deg, "
                  f"reloc_window launches {spy.launches['reloc_window']}, frame ms {ms:.3f} "
                  f"({card})")
            if tr.frame_path[-1] != "reloc" or M is None or d_t > MAX_T_ERR \
                    or d_r > MAX_R_ERR or not spy.launches["reloc_window"]:
                fail("with no BoW hooks the kidnapped frame did not relocalize within "
                     f"{MAX_T_ERR} m / {MAX_R_ERR} deg through the window search")

            # (a) a forced relocalization on the next frames
            tr.force_reloc = True
            frame_ms = []
            for i in range(SYS_FRAMES, SYS_FRAMES + RELOC_FRAMES):
                poses[i], ms = timed(lambda: slam.track(frames[i], (i + 1) / 25.0))
                frame_ms.append(ms)
            paths = tr.frame_path[-RELOC_FRAMES:]
            print(f"reloc (a): frame paths {paths}, BoW candidates {cands}, "
                  f"{dict(calls)}, frame ms {[round(x, 3) for x in frame_ms]}, "
                  f"{keyframes_moved(m, before)} ({card})")
            if paths[:2] != ["reloc", "reloc_recent"] or tr.force_reloc:
                fail(f"forced relocalization took the paths {paths}")
            if len(cands) < 2 or not cands[1] or not calls["ransac_gpnp"] or not calls["pose_lm"] \
                    or not spy.launches["reloc_bow"]:
                fail("the relocalization skipped BoW candidates, SearchByBoW, GP3P "
                     "RANSAC or the pose LM")
            tracked = [i for i in sorted(poses) if poses[i] is not None]
            if any(poses[i] is None for i in range(SYS_FRAMES, SYS_FRAMES + RELOC_FRAMES)):
                fail("a frame after the forced relocalization was lost")
            ate = ate_rmse(np.stack([poses[i][:3, 3] for i in tracked]), gt[tracked, :3, 3])
            print(f"reloc (a): ATE (Sim3-aligned, {len(tracked)} frames) {ate:.5f} m")
            if ate > SYS_MAX_ATE:
                fail(f"ATE {ate:.4f} m above {SYS_MAX_ATE} m after the relocalization")

            # (c) the second-chance round on a weak match set
            n_proj = spy.launches["reloc_projection"]
            single, full, proj_only = second_chance(tr, m)
            print(f"reloc (c): single pass {single}, second chance {full}, projection "
                  f"round alone {proj_only}, reloc_projection launches "
                  f"{spy.launches['reloc_projection'] - n_proj}")
            if single or not full or not proj_only \
                    or spy.launches["reloc_projection"] == n_proj:
                fail("the second-chance round did not recover the weak match set "
                     "through the projection search")
    finally:
        ransac.ransac_gpnp = orig["gpnp"]
        tr.reloc_candidates_fn = orig["cands"]
        del tr._optimize_current_pose, tr._relocalize
    print(f"relocalization ms (_relocalize, host clock to a device sync): "
          f"{[round(x, 3) for x in reloc_ms]}, median {statistics.median(reloc_ms):.3f} "
          f"({card})")
    return check_launches(knn, spy, RELOC_SITES, card)


def map_state(m):
    """A deep copy of a MapStore's state, its callbacks left out; restore
    it with ``vars(m).update(copy.deepcopy(state))``."""
    return copy.deepcopy({k: v for k, v in vars(m).items() if not callable(v)})


def loop_phase(knn, card, slam):
    """Phase 8: loop closing on the card on the system's map, at the bars
    of tests/test_loop_closing.py, the map restored after each step.
    Returns the kernel JSON entries of its call sites."""
    from multicol_slam_tpu_torch.models import loop_closing as lcm
    from multicol_slam_tpu_torch.models import matcher, sim3_opt
    from multicol_slam_tpu_torch.models import vocabulary as tv
    from multicol_slam_tpu_torch.models.keyframe_database import KeyFrameDatabase
    from multicol_slam_tpu_torch.ops import se3_np
    from multicol_slam_tpu_torch.ops import sim3 as s3

    m, lc = slam.map, slam.loop_closer
    dev = lc.dev
    state = map_state(m)
    restore = lambda: vars(m).update(copy.deepcopy(state))
    kfs = m.keyframe_ids().tolist()
    kf1, kf2 = kfs[0], kfs[1]
    M = {k: se3_np.cayley2hom(m.kf_pose[k]) for k in kfs}
    T12 = np.linalg.inv(M[kf1]) @ M[kf2]              # kf2 body -> kf1 body
    sim3_dev = lambda T: s3.sim3_from_se3(torch.tensor(T, dtype=torch.float32, device=dev))

    # the vocabulary transform of one keyframe's 2400 slots
    f = m.kf_features[kf1]
    desc, valid = f.desc.reshape(-1, f.desc.shape[-1]), f.valid.reshape(-1)
    voc_fn = lambda: tv.transform_words(lc.voc, desc, valid, levelsup=lc.voc.levels - 1)
    print(f"transform_words, {tuple(desc.shape)} descriptors, {lc.voc.n_words} words: device "
          f"{device_ms(voc_fn):.4f} ms, one call {cuda_ms(voc_fn):.4f} ms ({card})")

    graph_ms, sim3_ms, correct_ms = [], [], []
    sim3_stages = [(lcm, "sample_sim3_sets", "draws"), (lcm, "horn_alignment", "horn"),
                   (sim3_opt, "sim3_chi2", "score"), (sim3_opt, "optimize_sim3", "optimize_sim3"),
                   (sim3_opt, "jacfwd", "its_jacobians", True),
                   (lc, "_guided_sim3_pairs", "guided"),
                   (lc, "_count_neighborhood_support", "support")]
    graph_jac_ms = []
    optimize_graph = sim3_opt.optimize_essential_graph

    def timed_graph(*a, **k):
        with StageClock((sim3_opt, "_edge_jacobians", "edge_jacobians")) as clock:
            out, ms = timed(lambda: optimize_graph(*a, **k))
        graph_ms.append(ms)
        graph_jac_ms.append(clock.ms["edge_jacobians"])
        return out

    reset_launches(knn)
    sim3_opt.optimize_essential_graph = timed_graph
    try:
        with SiteSpy(knn, matcher) as spy:
            # SearchByBoW between the first two keyframes
            pairs = lc._matched_point_pairs(kf1, kf2)
            same = sum(p[0] == p[1] for p in pairs)
            print(f"loop: SearchByBoW keyframes {kf1}-{kf2}: {len(pairs)} pairs, {same} "
                  f"the same landmark")
            if len(pairs) < lcm.MIN_BOW_MATCHES or same <= 0.6 * len(pairs):
                fail("SearchByBoW between the first two keyframes: want >= "
                     f"{lcm.MIN_BOW_MATCHES} pairs, > 60% the same landmark")

            # the process's first forward-mode Jacobian on the card, on a
            # tiny function apart from the Sim3 code, cold and then warm
            v = torch.linspace(0.1, 0.7, 7, device=dev)
            tiny = lambda: torch.func.jacfwd(lambda x: torch.sin(x * x).sum(0, keepdim=True))(v)
            (_, cold), (_, warm) = timed(tiny), timed(tiny)
            print(f"loop: first torch.func.jacfwd on the card, 7 -> 1: cold {cold:.3f} ms, "
                  f"warm {warm:.3f} ms ({card})")
            # ComputeSim3 between them: near their own relative pose. The
            # first call is the process's first use of the Sim3 code; each
            # call is split into its stages
            for i in range(3):
                with StageClock(*sim3_stages) as clock:
                    S12, ms = timed(lambda: lc._compute_sim3(kf1, kf2, pairs))
                sim3_ms.append(ms)
                print(f"loop: _compute_sim3 call {i + 1}{' (cold)' if i == 0 else ''}: "
                      f"{ms:.3f} ms; stages ms: {clock.line(SIM3_STAGES)} ({card})")
            if S12 is None:
                fail("ComputeSim3 between the first two keyframes failed a gate")
            s, R = float(S12.s), S12.R.double().cpu().numpy()
            print(f"loop: ComputeSim3 s {s:.6f}, |R - R12| {np.abs(R - T12[:3, :3]).max():.2e}, "
                  f"ms {[round(x, 3) for x in sim3_ms]} ({card})")
            if abs(s - 1.0) > 0.05 or np.abs(R - T12[:3, :3]).max() > 0.05:
                fail("ComputeSim3 between adjacent keyframes is not near their relative pose")
            n_support, ms = timed(lambda: lc._count_neighborhood_support(kf1, kf2, S12))
            print(f"loop: neighbourhood support {n_support} matches, {ms:.3f} ms ({card})")

            guided_round(lc, slam.rig, kf1, kf2, pairs, T12)

            # CorrectLoop on an injected drift, with the essential graph
            # neutralized (exact) and with it (every keyframe improves),
            # through a closer built as the JAX tests build theirs
            closer = lcm.LoopCloser(slam.rig, m, lc.voc, KeyFrameDatabase(), slam._loop_params,
                                    scale_factor=lc.scale_factor, n_levels=lc.n_levels)
            sim3_opt.optimize_essential_graph = lambda logs, graph, iters=20, fix_scale=True: logs
            eb, ea, pb, pa = drift_and_correct(closer, m, kfs, sim3_dev)
            restore()
            print(f"loop: CorrectLoop, graph neutralized: pose error after "
                  f"{max(ea.values()):.2e} (before {max(eb.values()):.4f}), point error "
                  f"{pa:.2e} (before {pb:.4f})")
            if max(ea.values()) >= 1e-4 or pa >= 1e-3:
                fail("CorrectLoop did not restore the drifted map exactly")
            sim3_opt.optimize_essential_graph = timed_graph
            eb, ea, pb, pa = drift_and_correct(closer, m, kfs, sim3_dev)
            restore()
            print("loop: CorrectLoop with the graph, pose error before/after per keyframe "
                  + ", ".join(f"{k}: {eb[k]:.4f}/{ea[k]:.4f}" for k in kfs[1:]))
            if any(ea[k] >= eb[k] for k in kfs[1:]) or ea[kfs[-1]] >= 0.95 * eb[kfs[-1]]:
                fail("CorrectLoop with the essential graph did not improve every keyframe")
            # once through the system's own closer: SearchAndFuse on
            _, _, _, _ = drift_and_correct(lc, m, kfs, sim3_dev, correct_ms)
            restore()

            chain_graph(slam.rig, lc, sim3_dev)

            global_ba_repairs(slam, m, restore, card)
    finally:
        sim3_opt.optimize_essential_graph = optimize_graph
        restore()
    print(f"loop: _compute_sim3 ms median {statistics.median(sim3_ms):.3f}, _correct_loop ms "
          f"{[round(x, 3) for x in correct_ms]}, optimize_essential_graph ms "
          f"{[round(x, 3) for x in graph_ms]}, of which edge Jacobians "
          f"{[round(x, 3) for x in graph_jac_ms]} ({card})")
    return check_launches(knn, spy, LOOP_SITES, card)


def guided_round(lc, rig, kf1, kf2, pairs, T12):
    """tests/test_loop_closing.py's guided SearchBySim3 round: a seed of
    every third BoW pair, its OptimizeSim3, then the guided pairs must add
    inliers, their reverse measurements p2's own observations, most of
    them within the chi2 gate at the true transform."""
    from multicol_slam_tpu_torch.models import sim3_opt
    from multicol_slam_tpu_torch.ops import sim3 as s3

    def obs_of(ps):
        return lc._make_sim3_obs(kf1, kf2, ps, lc._body_frame_points(kf1, [p[0] for p in ps]),
                                 lc._body_frame_points(kf2, [p[1] for p in ps]))

    seed = pairs[::3]
    obs = obs_of(seed)
    S0 = s3.horn_alignment(obs.X1, obs.X2, fix_scale=lc.fix_scale)
    S12, _, n_in = sim3_opt.optimize_sim3(rig, S0, obs, iters=10, fix_scale=lc.fix_scale)
    extra = lc._guided_sim3_pairs(kf1, kf2, S12, {(a, b) for a, b, *_ in seed})
    own = all((kf2, c2, s2) in lc.map.pt_obs[p2] for _, p2, _, _, c2, s2 in extra)
    dev = obs.X1.device
    S_true = s3.Sim3(torch.ones((), device=dev),
                     torch.tensor(T12[:3, :3], dtype=torch.float32, device=dev),
                     torch.tensor(T12[:3, 3], dtype=torch.float32, device=dev))
    frac_rev = float((sim3_opt.sim3_chi2(rig, S_true, obs_of(extra))[1] <= 9.21)
                     .float().mean()) if extra else 0.0
    _, _, n_in2 = sim3_opt.optimize_sim3(rig, S12, obs_of(seed + extra), iters=10,
                                         fix_scale=lc.fix_scale)
    print(f"loop: guided round: seed {len(seed)} pairs, {int(n_in)} inliers; {len(extra)} "
          f"guided pairs, own reverse observations {own}, {frac_rev:.2f} within the gate at "
          f"the true transform; {int(n_in2)} inliers after")
    if int(n_in) < 3 or len(extra) < 3 or not own or frac_rev <= 0.5 \
            or int(n_in2) <= int(n_in):
        fail("the guided SearchBySim3 round added no inliers")


def global_ba_repairs(slam, m, restore, card):
    """tests/test_loop_closing.py's global-BA bar on the system's map (off
    the default path: the loop closer runs none after a loop): the map
    first brought to the global-BA optimum, every point then moved 3 cm,
    and ``MultiColSLAM.global_bundle_adjustment`` must take the points at
    least halfway back, keyframe 0 unmoved."""
    slam.global_bundle_adjustment(iters=10)
    kf0 = int(m.keyframe_ids()[0])
    pose0 = m.kf_pose[kf0].copy()
    pts = np.nonzero(m.pt_valid)[0]
    opt = m.pt_pos[pts].copy()
    noise = np.random.default_rng(7).standard_normal(opt.shape)
    noise *= 0.03 / np.linalg.norm(noise, axis=1, keepdims=True)
    m.pt_pos[pts] = (opt + noise).astype(np.float32)
    cost, ms = timed(lambda: slam.global_bundle_adjustment(iters=10))
    err = float(np.linalg.norm(m.pt_pos[pts] - opt, axis=1).mean())
    moved = not np.array_equal(m.kf_pose[kf0], pose0)
    restore()
    print(f"loop: global_bundle_adjustment, 10 iterations, {len(pts)} points moved 3 cm: "
          f"mean error after {err:.2e} m, chi2 {cost:.3f}, {ms:.3f} ms ({card})")
    if not np.isfinite(cost) or err >= 0.015 or moved:
        fail("global bundle adjustment did not repair the perturbed points")


def drift_and_correct(closer, m, kfs, sim3_dev, correct_ms=None):
    """tests/test_loop_closing.py's drift: every keyframe but the first
    misplaced as S_k o D and every point by D^-1, then CorrectLoop between
    the last and the first keyframe at their true relative pose. Returns
    (pose error before, after, by keyframe; mean point error before,
    after). The caller restores the map."""
    from multicol_slam_tpu_torch.ops import se3_np
    from multicol_slam_tpu_torch.ops import sim3 as s3

    kf_new, kf_old = kfs[-1], kfs[0]
    true = {k: se3_np.cayley2hom(m.kf_pose[k]) for k in kfs}
    pts = np.unique(np.concatenate([m.kf_pt[k][m.kf_pt[k] >= 0] for k in kfs]))
    pts = pts[m.pt_valid[pts]]
    pt_true = m.pt_pos[pts].copy()
    D = s3.sim3_exp(torch.tensor(DRIFT, dtype=torch.float64))
    for k in kfs[1:]:
        S_k = s3.sim3_from_se3(torch.from_numpy(np.linalg.inv(true[k]))).compose(D)
        m.kf_pose[k] = se3_np.hom2cayley(np.linalg.inv(S_k.to_se3().numpy()))
    m.pt_pos[pts] = D.inverse().apply(torch.from_numpy(pt_true.astype(np.float64))
                                      ).numpy().astype(np.float32)

    def kf_err(k):
        return np.linalg.norm(np.linalg.inv(se3_np.cayley2hom(m.kf_pose[k]))
                              - np.linalg.inv(true[k]))

    eb = {k: kf_err(k) for k in kfs[1:]}
    pb = float(np.linalg.norm(m.pt_pos[pts] - pt_true, axis=1).mean())
    S12 = sim3_dev(np.linalg.inv(true[kf_new]) @ true[kf_old])
    _, ms = timed(lambda: closer._correct_loop(kf_new, kf_old, S12))
    if correct_ms is not None:
        correct_ms.append(ms)
    ea = {k: kf_err(k) for k in kfs[1:]}
    pa = float(np.linalg.norm(m.pt_pos[pts] - pt_true, axis=1).mean())
    if not all(np.isfinite(m.kf_pose[k]).all() for k in kfs):
        fail("CorrectLoop left non-finite poses")
    return eb, ea, pb, pa


def chain_graph(rig, lc, sim3_dev):
    """tests/test_loop_closing.py's 14-keyframe out-and-back chain: drift
    accumulated along the chain, the loop closed between the last and the
    first keyframe; the essential graph must repair the middle keyframe 3x,
    the mean 5x and the points 3x."""
    from multicol_slam_tpu_torch.models import loop_closing as lcm
    from multicol_slam_tpu_torch.models.keyframe_database import KeyFrameDatabase
    from multicol_slam_tpu_torch.models.map import MapStore
    from multicol_slam_tpu_torch.ops import se3_np

    N, G = 14, 30
    rng = np.random.default_rng(11)
    M_true = np.tile(np.eye(4), (N, 1, 1))
    half = N // 2
    xs = np.concatenate([np.arange(half) * 0.4, (half - 1 - np.arange(N - half)) * 0.4])
    M_true[:, 0, 3] = xs
    c, sn = np.cos(0.02), np.sin(0.02)
    T_noise = np.eye(4)
    T_noise[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
    T_noise[:3, 3] = [0.015, -0.01, 0.02]
    M_drift = M_true.copy()
    for k in range(1, N):
        M_drift[k] = M_drift[k - 1] @ np.linalg.inv(M_true[k - 1]) @ M_true[k] @ T_noise
    m = MapStore(capacity_pts=N * G + 16, capacity_kfs=N + 2, n_cams=1, k_per_cam=2 * G + 8)
    X_true = rng.uniform(-1.5, 1.5, (N * G, 3))
    X_true[:, 0] += np.repeat(xs, G)
    X_true[:, 2] += 2.0
    for k in range(N):
        m.alloc_keyframe(se3_np.hom2cayley(M_drift[k]), None, k)
        if k > 0:
            m.kf_parent[k] = k - 1
    ids = m.alloc_points(N * G)
    A = np.stack([M_drift[g] @ np.linalg.inv(M_true[g]) for g in range(N)])
    for g in range(N):
        grp = ids[g * G:(g + 1) * G]
        m.pt_pos[grp] = (X_true[g * G:(g + 1) * G] @ A[g, :3, :3].T
                         + A[g, :3, 3]).astype(np.float32)
        for i, p in enumerate(grp):
            m.add_observation(int(p), g, 0, i)
            if g + 1 < N:
                m.add_observation(int(p), g + 1, 0, G + i)
    closer = lcm.LoopCloser(rig, m, lc.voc, KeyFrameDatabase(), lc.params)
    closer._correct_loop(N - 1, 0, sim3_dev(np.linalg.inv(M_true[N - 1]) @ M_true[0]))
    pos = np.stack([se3_np.cayley2hom(m.kf_pose[k])[:3, 3] for k in range(N)])
    err_after = np.linalg.norm(pos - M_true[:, :3, 3], axis=1)
    err_before = np.linalg.norm(M_drift[:, :3, 3] - M_true[:, :3, 3], axis=1)
    X_drift = np.einsum("gij,gpj->gpi", A[:, :3, :3], X_true.reshape(N, G, 3)) \
        + A[:, None, :3, 3]
    pt_before = np.linalg.norm(X_drift.reshape(-1, 3) - X_true, axis=1).mean()
    pt_after = np.linalg.norm(m.pt_pos[ids] - X_true, axis=1).mean()
    print(f"loop: chain of {N} keyframes: mid {err_before[half]:.4f} -> {err_after[half]:.4f} "
          f"m, mean {err_before.mean():.4f} -> {err_after.mean():.4f} m, points "
          f"{pt_before:.4f} -> {pt_after:.4f} m")
    if not (err_after[half] < err_before[half] / 3.0 and err_after.mean() < err_before.mean() / 5.0
            and pt_after < pt_before / 3.0):
        fail("the essential graph did not repair the chain")


def mdbrief_phase(dev, knn, card, frames, gt):
    """Phase 9: the system at the reference's extractor options (mdBRIEF
    with learned masks over AGAST 7_12) on phase 6's frames with a
    relocalization forced on frame MDBRIEF_RELOC_AT (held), then one
    forced on frames 40-42 (printed) and the second-chance round. Returns
    the kernel JSON entries of its masked call sites."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.ops import ransac
    from multicol_slam_tpu_torch.ops.hamming import unpack_bits_u32
    from multicol_slam_tpu_torch.utils import config_io
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    settings = config_io.SlamSettings(**MDBRIEF)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings)
    tr, m = slam.tracker, slam.map
    if slam.rig.M_c.device != dev or not tr.params.masked or not slam.mapper.params.masked:
        fail("the mdBRIEF system is not on the card with masked matching")

    at, late = MDBRIEF_RELOC_AT, SYS_FRAMES
    kinds, times, init_frame, poses, errs = [], [], None, {}, {}
    gpnp_calls, gpnp = [], ransac.ransac_gpnp

    def counted_gpnp(*a, **k):
        gpnp_calls.append(1)
        return gpnp(*a, **k)

    reset_launches(knn)
    ransac.ransac_gpnp = counted_gpnp
    try:
        with SiteSpy(knn, matcher) as spy:
            for i in range(SYS_FRAMES + RELOC_FRAMES):
                was_working = slam.state == TrackState.WORKING
                n_passes = len(slam.mapping_ms)
                tr.force_reloc |= i in (at, late)
                M, ms = timed(lambda: slam.track(frames[i], i / 25.0))
                poses[i] = None if M is None else np.asarray(M, np.float64)
                if at <= i < at + RELOC_FRAMES or i >= late:
                    errs[i] = reloc_error(m, poses, gt, at if i < late else late, i)
                if i < SYS_FRAMES:
                    times.append(ms)
                    if poses[i] is not None and init_frame is None:
                        init_frame = i
                    kinds.append("init" if not was_working and tr.frame_path[-1] == "init" else
                                 "reloc" if tr.frame_path[-1] == "reloc" else
                                 "keyframe" if len(slam.mapping_ms) > n_passes else "working")
            late_paths = tr.frame_path[late:]
            single, full, proj_only = second_chance(tr, m)
    finally:
        ransac.ransac_gpnp = gpnp

    paths = tr.frame_path[at:at + RELOC_FRAMES]
    held = [errs[i] for i in range(at, at + RELOC_FRAMES)]
    print(f"mdbrief: init at frame {init_frame}, {m.n_keyframes()} keyframes "
          f"({len(slam.mapping_ms)} mapping passes), {m.n_points()} points, frame paths "
          f"{dict(Counter(tr.frame_path))}; relocalization forced on frame {at}: paths {paths}, "
          f"frame ms {[round(times[i], 3) for i in range(at, at + RELOC_FRAMES)]}, each "
          f"returned pose's error (m, deg) against ground truth's step from frame {at - 1} "
          f"{held}; forced on frame {late} (not held): paths {late_paths}, errors against "
          f"ground truth's step from frame {late - 1} "
          f"{[errs[i] for i in range(late, late + RELOC_FRAMES)]}; second chance: single pass "
          f"{single}, with the round {full}, projection round alone {proj_only} ({card})")
    if init_frame is None or init_frame >= SYS_INIT_BY:
        fail(f"the mdBRIEF system did not initialize within {SYS_INIT_BY} frames")
    after = SYS_FRAMES - init_frame - 1
    tracked = [i for i in range(init_frame, SYS_FRAMES) if poses[i] is not None]
    n_work = len(tracked) - 1
    if n_work < SYS_WORKING_FRAC * after:
        fail(f"the mdBRIEF system was WORKING on {n_work} of the {after} frames after init")
    if len(slam.mapping_ms) < SYS_MIN_KFS or m.n_keyframes() < SYS_MIN_KFS:
        fail(f"the mdBRIEF system made {m.n_keyframes()} keyframes; want >= {SYS_MIN_KFS}")
    est = np.stack([poses[i] for i in tracked])
    ate = ate_rmse(est[:, :3, 3], gt[tracked, :3, 3])
    print(f"mdbrief: ATE (Sim3-aligned, {len(tracked)} of frames 0-{SYS_FRAMES - 1}) {ate:.5f} m")
    if not np.isfinite(est).all() or ate > MDBRIEF_MAX_ATE:
        fail(f"the mdBRIEF system's ATE {ate:.4f} m is above {MDBRIEF_MAX_ATE} m")
    if paths[0] != "reloc" or not gpnp_calls or not spy.launches["reloc_bow"]:
        fail(f"the relocalization forced on frame {at} took the paths {paths}, "
             f"{len(gpnp_calls)} GP3P calls, {spy.launches['reloc_bow']} SearchByBoW launches")
    if all(e is None for e in held) or any(
            e is not None and (e[0] > MAX_T_ERR or e[1] > MAX_R_ERR) for e in held):
        fail(f"the relocalization forced on frame {at} did not recover by frame "
             f"{at + RELOC_FRAMES - 1} within {MAX_T_ERR} m / {MAX_R_ERR} deg: {held}")
    if single or not full or not proj_only:
        fail("the mdBRIEF system's second-chance round did not recover")
    for kind in ("init", "working", "keyframe", "reloc"):
        xs = [t for t, kd in zip(times, kinds) if kd == kind]
        print(f"mdbrief frame ms, {kind}: {percentiles(xs)} ({card})")
    print(f"mdbrief mapping_ms per pass: {[round(x, 3) for x in slam.mapping_ms]} ({card})")

    # every masked site launched with masks, SearchByBoW without
    print(f"mdbrief: launches by call site {dict(spy.launches)}, of them with the masks "
          f"{dict(spy.masked)}")
    for site, n in spy.launches.items():
        want = 0 if site in UNMASKED_SITES else n
        if spy.masked[site] != want:
            fail(f"call site {site} passed masks on {spy.masked[site]} of {n} launches, "
                 f"want {want}")
    sites = MDBRIEF_SITES + (("reloc_window",) if spy.launches["reloc_window"] else ())
    entries = check_launches(knn, spy, sites, card, tag="_masked")

    # extraction: the card's extractors against the port's CPU extractors
    cpu = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings, device="cpu",
                       enable_loop_closing=False)
    frame = frames[init_frame]
    for name in ("extract_init", "extract"):
        got = getattr(slam, name)(frame)
        want = getattr(cpu, name)(frame.cpu())
        for field in ("xy", "level", "valid"):
            if not torch.equal(getattr(got, field).cpu(), getattr(want, field)):
                fail(f"{name}: the card's keypoint {field} differ from the CPU's")
        ok = want.valid
        off_axis = torch.rad2deg(torch.arccos(want.ray[..., 2].clamp(-1, 1)))[ok]
        diff, where = {}, set()
        for field in ("desc", "desc_mask"):
            a = unpack_bits_u32(getattr(got, field).cpu())[ok]
            b = unpack_bits_u32(getattr(want, field))[ok]
            diff[field] = (int((a != b).sum()), a.numel())
            where.update(round(float(x), 1) for x in off_axis[(a != b).any(-1)])
        print(f"mdbrief {name} on frame {init_frame}, card against CPU: keypoints, levels and "
              f"validity identical; bits that differ: descriptor {diff['desc'][0]} of "
              f"{diff['desc'][1]}, mask {diff['desc_mask'][0]} of {diff['desc_mask'][1]}, in "
              f"keypoints at {sorted(where)} degrees off axis (float32 atan2/cos/sin differ "
              f"in the last ulp between the card and the CPU, and a pattern point within an "
              f"ulp of .5 rounds the other way)")
        if any(n > MAX_MDBRIEF_BIT_DIFF * tot for n, tot in diff.values()):
            fail(f"{name}: more than {MAX_MDBRIEF_BIT_DIFF} of the bits differ from the CPU's")
    return entries


def organic_run(dev, knn, seed, on_frame=None):
    """One run of the organic loop episode (multicol_slam_tpu_torch/utils/
    episode.py) on the card at ``seed``, the launch counts set to 0 just
    before it: every call site's launches add up to the wrappers' counts,
    every site it launched equals its plain version on its first inputs,
    and the run launched ORGANIC_SITES, and LOOP_SITES when it fired a wide
    loop. ``on_frame(slam, t)`` runs after frame t. Returns (system,
    episode.summary's outcome, the SiteSpy)."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.utils import episode

    slam, gt, frame, seed_closer, sync = episode.port_system(dev, seed)
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        res = episode.run_episode(slam, frame, gt, seed_closer=seed_closer, sync=sync,
                                  log=lambda *a, **k: None,
                                  on_frame=on_frame and (lambda t: on_frame(slam, t)))
    launches = {k: getattr(knn, ENTRY[k]).launches for k in ENTRY}
    for kind in ENTRY:
        by_site = sum(n for s, n in spy.launches.items() if site_kind(s) == kind)
        if by_site != launches[kind]:
            fail(f"organic seed {seed}: call-site launches {dict(spy.launches)} do not add "
                 f"up to {ENTRY[kind]}'s {launches[kind]}")
    need = ORGANIC_SITES + (LOOP_SITES if res["bars"].get("wide") else ())
    missing = [s for s in need if not spy.launches[s]]
    if missing:
        fail(f"organic seed {seed}: the kernel was not launched at call sites {missing}")
    for site, (kind, args) in spy.args.items():
        if kind != site_kind(site):
            fail(f"call site {site} used {ENTRY[kind]}, want {ENTRY[site_kind(site)]}")
        compare(knn, kind, args)
    return slam, res, spy


def organic_worker(seed: int, out_dir: str) -> None:
    """A worker of phase 10: one run at ``seed``; writes its outcome and
    launches (JSON) and each site's first inputs (torch) to ``out_dir``."""
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, res, spy = organic_run(dev, knn, seed)
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a
    torch.save({s: (k, [cpu(a) for a in args]) for s, (k, args) in spy.args.items()},
               os.path.join(out_dir, f"args{seed}.pt"))
    with open(os.path.join(out_dir, f"run{seed}.json"), "w") as f:
        json.dump({"res": res, "launches": dict(spy.launches)}, f)


def organic_workers(seeds, out_dir):
    """Start one worker process a seed (one thread each); returns
    {seed: (process, log file)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for seed in seeds:
        log = open(os.path.join(out_dir, f"worker{seed}.log"), "w")
        procs[seed] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--organic-worker", str(seed),
             out_dir], stdout=log, stderr=subprocess.STDOUT, env=env), log)
    return procs


def organic_phase(dev, knn, card):
    """Phase 10: the organic loop closure. MultiColSLAM on the card (loop
    closing on, default ORB extractor at the episode's settings) over the
    baffle episode at the seeds of ORGANIC_SEEDS: seed 42 alone in this
    process, timed, its map checkpointed after frame ORGANIC_RESUME_AT;
    then the other seeds side by side in worker processes while this one
    resumes a fresh system from that checkpoint. Holds the count of runs
    that repaired a wide loop to ORGANIC_MIN_REPAIRED and prints the count
    that met every bar of tests/test_organic_loop.py. Returns the kernel
    JSON entries of the organic sites (launches summed over the runs)."""
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import checkpoint, config_io, episode

    tmp = tempfile.mkdtemp(prefix="organic_")
    procs = {}
    try:
        saved = {}

        def checkpoint_at(slam, t):
            if t != ORGANIC_RESUME_AT:
                return
            path = os.path.join(tmp, "organic_map.npz")
            _, saved["save_ms"] = timed(lambda: checkpoint.save_map(path, slam.map))
            saved["bytes"] = os.path.getsize(path)
            (saved["map"], _), saved["load_ms"] = timed(
                lambda: checkpoint.load_map(path, device=dev))
            differ = checkpoint.map_differences(saved["map"], slam.map)
            if differ:
                fail(f"organic resume: the reloaded map differs from the saved one: {differ}")

        seed0 = ORGANIC_SEEDS[0]
        _, res0, spy0 = organic_run(dev, knn, seed0, on_frame=checkpoint_at)
        runs = {seed0: (res0, dict(spy0.launches), spy0.args)}
        for kind, xs in res0["frame_ms"].items():
            print(f"organic frame ms, seed {seed0} alone, {kind}: {percentiles(xs)} ({card})")

        procs = organic_workers(ORGANIC_SEEDS[1:], tmp)
        t_workers = time.perf_counter()

        # the resume: the checkpoint of the seed-42 run onto the card into a
        # fresh system, the tracker LOST, the two frames after it fed
        m2 = saved["map"]
        fed = (ORGANIC_RESUME_AT + 1, ORGANIC_RESUME_AT + 2)
        if set(fed) & set(m2.kf_frame_id[m2.keyframe_ids()].tolist()):
            fail(f"organic resume: a frame of {fed} is a keyframe of the saved map")
        fresh = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR,
                             settings=config_io.SlamSettings(**episode.SETTINGS),
                             enable_loop_closing=False, **episode.CAPACITY)
        errs = episode.resume(fresh, m2, ORGANIC_RESUME_AT)
        print(f"organic resume: checkpoint after frame {ORGANIC_RESUME_AT} of seed {seed0}, "
              f"{saved['bytes']} bytes, save {saved['save_ms']:.3f} ms, load "
              f"{saved['load_ms']:.3f} ms, every part equal; frames {fed} with the tracker "
              f"LOST: paths {fresh.tracker.frame_path[-2:]}, errors (m, deg, the reference "
              f"keyframe's frame) against ground truth's step from the reference keyframe "
              f"{errs} ({card})")
        if not any(e is not None and e[0] < MAX_T_ERR and e[1] < MAX_R_ERR for e in errs):
            fail(f"organic resume: no frame relocalized within {MAX_T_ERR} m / {MAX_R_ERR} deg")

        for seed, (p, log) in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, ORGANIC_WORKER_S
                                        - (time.perf_counter() - t_workers)))
            except subprocess.TimeoutExpired:
                fail(f"organic worker {seed} did not finish in {ORGANIC_WORKER_S} s")
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                fail(f"organic worker {seed} exited {rc}:\n{tail}")
            with open(os.path.join(tmp, f"run{seed}.json")) as f:
                run = json.load(f)
            args = torch.load(os.path.join(tmp, f"args{seed}.pt"))
            runs[seed] = (run["res"], Counter(run["launches"]), {
                s: (k, tuple(a.to(dev) if torch.is_tensor(a) else a for a in xs))
                for s, (k, xs) in args.items()})
        print(f"organic: seeds {ORGANIC_SEEDS[1:]} side by side in worker processes, "
              f"{time.perf_counter() - t_workers:.3f} s")
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)

    for seed, (res, _, _) in runs.items():
        print(f"organic: {episode.describe(seed, res)} ({card})")
        print(f"organic: seed {seed}: ComputeSim3 {len(res['sim3_ms'])} calls, ms "
              f"{[round(x, 3) for x in res['sim3_ms']]}; CorrectLoop "
              f"{len(res['correct_ms'])} calls, ms {[round(x, 3) for x in res['correct_ms']]}"
              f"{' (alone)' if seed == seed0 else ' (beside the other workers)'} ({card})")
    repaired = [s for s, r in runs.items() if r[0]["repaired"]]
    ok = [s for s, r in runs.items() if r[0]["ok"]]
    print(f"organic: {len(repaired)} of {len(runs)} runs repaired a wide loop {repaired} "
          f"(held: at least {ORGANIC_MIN_REPAIRED}); {len(ok)} of {len(runs)} met every bar "
          f"of tests/test_organic_loop.py {ok} (not held) ({card})")
    if len(repaired) < ORGANIC_MIN_REPAIRED:
        fail(f"organic: {len(repaired)} of {len(runs)} runs repaired a wide loop, fewer than "
             f"{ORGANIC_MIN_REPAIRED}")

    total = Counter()
    for _, launches, _ in runs.values():
        total.update(launches)
    print(f"organic launches by call site, summed over the runs: {dict(total)}")
    sites = ORGANIC_SITES + LOOP_SITES + tuple(
        s for s in RELOC_SITES + ("window_search",) if total[s])
    entries = []
    for site in sites:
        kind, args = next(r[2][site] for r in runs.values() if site in r[2])
        entries.append(site_entry(knn, site + "_organic", kind, args, total[site], card))
    return entries


def async_phase(dev, knn, card, frames, gt, ref):
    """Phase 11: (a) async mapping, (b) the chunked path, (c) a reset with
    a mapping pass in flight, (d) the command line. Returns the kernel JSON
    entries of (a)'s and (b)'s call sites."""
    t0 = time.perf_counter()
    entries = async_mapping_run(dev, knn, card, frames, gt, ref)
    t1 = time.perf_counter()
    entries += chunked_run(knn, card, frames, gt, ref)
    t2 = time.perf_counter()
    reset_in_flight(dev, frames)
    t3 = time.perf_counter()
    cli_run(card)
    t4 = time.perf_counter()
    print(f"phase 11 wall s: async {t1 - t0:.3f}, chunked {t2 - t1:.3f}, reset {t3 - t2:.3f}, "
          f"CLI {t4 - t3:.3f}, all {t4 - t0:.3f} ({card})")
    return entries


def async_mapping_run(dev, knn, card, frames, gt, ref):
    """Phase 11 (a): MultiColSLAM(async_mapping=True) over phase 6's frames
    to phase 6's bars; every pass after the bootstrap on the mapper thread
    and its stream, the mapper's launches on that stream, each site equal
    to its plain version, no failure in the mapper, the queue empty and the
    thread joined after shutdown."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True)
    mapper_thread, stream = slam._mapper_thread, slam._mapper_stream.cuda_stream
    passes, count = [], Counter()
    process, ba = slam.mapper.process_keyframe, slam.mapper._local_bundle_adjustment
    refuse = slam.tracker.interrupt_ba_fn

    def recorded_pass(kf):
        passes.append((threading.get_ident(), torch.cuda.current_stream(dev).cuda_stream))
        return process(kf)

    def recorded_ba(kf):
        count["ba"] += 1
        return ba(kf)

    def refused():
        count["refused"] += 1
        return refuse()

    slam.mapper.process_keyframe = recorded_pass
    slam.mapper._local_bundle_adjustment = recorded_ba
    slam.tracker.interrupt_ba_fn = refused
    kinds, times, init_frame, returned = [], [], None, {}
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        try:
            for i in range(SYS_FRAMES):
                was_working = slam.state == TrackState.WORKING
                n_kf = slam.map.n_keyframes()
                returned[i], ms = timed(lambda: slam.track(frames[i], i / 25.0))
                times.append(ms)
                if returned[i] is not None and init_frame is None:
                    init_frame = i
                kinds.append("init" if not was_working else
                             "keyframe" if slam.map.n_keyframes() > n_kf else "working")
        finally:
            t0 = time.perf_counter()
            slam.shutdown()
            join_s = time.perf_counter() - t0
    tr, m = slam.tracker, slam.map
    if mapper_thread.is_alive() or slam._mapper_thread is not None:
        fail("the mapper thread did not stop on shutdown")
    if slam._kf_queue.unfinished_tasks or not slam._kf_queue.empty():
        fail(f"{slam._kf_queue.unfinished_tasks} keyframes left in the queue after shutdown")
    main_id = threading.main_thread().ident
    on_mapper = [p for p in passes[2:] if p == (mapper_thread.ident, stream)]
    print(f"async: init at frame {init_frame}, {m.n_keyframes()} keyframes, {len(passes)} passes "
          f"({len(on_mapper)} after the bootstrap on the mapper thread and its stream), "
          f"{m.n_points()} points, {count['refused']} keyframes refused while the mapper was "
          f"busy, {len(passes) - count['ba']} passes interrupted, shutdown joined in "
          f"{join_s:.3f} s, frame paths {dict(Counter(tr.frame_path))}")
    if init_frame is None or init_frame >= SYS_INIT_BY:
        fail(f"async: the system did not initialize within {SYS_INIT_BY} frames")
    after = SYS_FRAMES - init_frame - 1
    if len(tr.all_poses) - 1 < SYS_WORKING_FRAC * after:
        fail(f"async: WORKING on {len(tr.all_poses) - 1} of the {after} frames after init")
    if len(slam.mapping_ms) < SYS_MIN_KFS or m.n_keyframes() < SYS_MIN_KFS:
        fail(f"async: {m.n_keyframes()} keyframes, {len(slam.mapping_ms)} mapped")
    if len(passes) < SYS_MIN_KFS or any(p[0] != main_id for p in passes[:2]) \
            or len(on_mapper) != len(passes) - 2:
        fail(f"async: the bootstrap passes ran inline and every later pass on the mapper "
             f"thread's stream, want; got {passes}")
    poses = np.stack(tr.all_poses)
    ate = ate_rmse(poses[:, :3, 3], gt[SYS_FRAMES - len(poses):SYS_FRAMES, :3, 3])
    print(f"async ATE (Sim3-aligned, {len(poses)} frames) {ate:.5f} m (per frame, "
          f"synchronous mapping: {ref['ate']:.5f} m)")
    if not np.isfinite(poses).all() or ate > SYS_MAX_ATE:
        fail(f"async: ATE {ate:.4f} m above {SYS_MAX_ATE} m")
    for kind in ("working", "keyframe"):
        xs = [t for t, kd in zip(times, kinds) if kd == kind]
        print(f"async frame ms, {kind}: {percentiles(xs)}; synchronous mapping (phase 6): "
              f"{percentiles(ref['frame_ms'][kind])} ({card})")
    print(f"async mapping_ms per pass: {[round(x, 3) for x in slam.mapping_ms]} ({card})")
    for site in ASYNC_MAPPER_SITES:
        if spy.streams.get(site) != {stream}:
            fail(f"async: the launches at {site} went on streams {spy.streams.get(site)}, "
                 f"not only the mapper's {stream}")
    return check_launches(knn, spy, ASYNC_SITES, card, tag="_async")


def chunked_run(knn, card, frames, gt, ref):
    """Phase 11 (b): a fresh system's track_batch(chunk=8) over phase 6's
    frames, held to tests/test_chunked_tracking.py's bars against phase 6's
    per-frame run; entry A launched inside the chunk scan at the motion and
    local-map sites, each equal to its plain version."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    chunk_ms = []
    track_chunk = slam.tracker.track_chunk

    def timed_chunk(images, timestamps):
        r, ms = timed(lambda: track_chunk(images, timestamps))
        if r is not None:
            chunk_ms.append((r[0], ms))
        return r

    slam.tracker.track_chunk = timed_chunk
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        res, wall = timed(lambda: slam.track_batch(frames[:SYS_FRAMES],
                                                   [i / 25.0 for i in range(SYS_FRAMES)],
                                                   chunk=CHUNK))
    slam.shutdown()
    m, tr = slam.map, slam.tracker
    ref_used = [i for i, M in enumerate(ref["poses"]) if M is not None]
    used = [i for i, M in enumerate(res) if M is not None]
    ate = ate_rmse(np.stack([res[i][:3, 3] for i in used]), gt[used, :3, 3])
    ref_ate = ate_rmse(np.stack([ref["poses"][i][:3, 3] for i in ref_used]), gt[ref_used, :3, 3])
    steady = tr.dispatches_per_frame[used[0] + 2:] if used else []
    dist = [float(np.linalg.norm(res[i][:3, 3] - ref["poses"][i][:3, 3])) for i in used
            if ref["poses"][i] is not None]
    n_chunk = sum(a for a, _ in chunk_ms)
    print(f"chunked: {len(used)} frames tracked ({len(ref_used)} per frame), ATE {ate:.5f} m "
          f"(per frame {ref_ate:.5f}), {m.n_keyframes()} keyframes ({ref['n_kf']}), "
          f"{m.n_points()} points ({ref['n_pt']}), largest pose distance to the per-frame run "
          f"{max(dist):.5f} m, frame paths {dict(Counter(tr.frame_path))}, accepted per chunk "
          f"{[a for a, _ in chunk_ms]}")
    print(f"chunked ms a frame: {sum(ms for _, ms in chunk_ms) / max(n_chunk, 1):.3f} over the "
          f"{n_chunk} chunk frames, the whole batch {wall / SYS_FRAMES:.3f}; per frame (phase 6) "
          f"WORKING {percentiles(ref['frame_ms']['working'])}; dispatches a steady frame "
          f"{np.mean(steady):.4f} chunked, {np.mean(ref['disp'][ref_used[0] + 2:]):.4f} per "
          f"frame ({card})")
    if used != ref_used:
        fail(f"chunked: tracked frames {used}, per frame {ref_used}")
    if not ate < max(2.0 * ref_ate, 0.02):
        fail(f"chunked: ATE {ate:.4f} m against {ref_ate:.4f} per frame")
    if m.n_keyframes() < 0.6 * ref["n_kf"] or m.n_points() < 0.5 * ref["n_pt"]:
        fail("chunked: too few keyframes or points against the per-frame run")
    if max(dist) >= 0.15:
        fail(f"chunked: a pose {max(dist):.3f} m from the per-frame run's")
    if steady.count(0) < len(steady) // 3:
        fail(f"chunked: {steady.count(0)} of {len(steady)} steady frames without a dispatch")
    return check_launches(knn, spy, CHUNK_SITES, card, tag="_batch")


def reset_in_flight(dev, frames):
    """Phase 11 (c): under async mapping, a keyframe enqueued and reset()
    called while its pass runs; the pass ends on the uncleared map, then
    the queue, the map, the mapper and the loop closer are empty; the
    system initializes again on the next frames."""
    from multicol_slam_tpu_torch.models.loop_closing import MIN_KFS_BETWEEN_LOOPS
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True)
    try:
        for i in range(RESET_AT):
            slam.track(frames[i], i / 25.0)
        slam._kf_queue.join()
        kf = slam.tracker.last_kf_id
        if kf < 0:
            fail(f"reset: no keyframe after {RESET_AT} frames")
        ended_on = []
        process = slam.mapper.process_keyframe

        def recorded_pass(k):
            process(k)
            ended_on.append(slam.map.n_keyframes())

        slam.mapper.process_keyframe = recorded_pass
        slam._enqueue_kf(kf)
        if not slam._mapper_busy.wait(30):
            fail("reset: the mapper did not start the pass")
        n_kf = slam.map.n_keyframes()
        busy = slam._mapper_busy.is_set()
        _, ms = timed(slam.reset)
        lc = slam.loop_closer
        print(f"reset: called with a pass in flight {busy} on a map of {n_kf} keyframes; the "
              f"pass ended on {ended_on} keyframes; reset took {ms:.3f} ms; after it {slam.map.n_keyframes()} "
              f"keyframes, {slam._kf_queue.unfinished_tasks} queued")
        if not busy or ended_on != [n_kf]:
            fail("reset: the pass in flight did not end on the map as it was")
        if slam._kf_queue.unfinished_tasks or slam.map.n_keyframes() or slam.mapper.recent_pts:
            fail("reset: the queue, the map or the mapper's probation list is not empty")
        if lc is not None and (lc.db.kf_bow or lc.kf_words or lc.consistent_groups
                               or lc.last_loop_kf != -MIN_KFS_BETWEEN_LOOPS):
            fail("reset: the loop closer's state was not cleared")
        slam.mapper.process_keyframe = process
        again = None
        for i in range(RESET_AT, RESET_AT + SYS_INIT_BY):
            if slam.track(frames[i], i / 25.0) is not None:
                again = i
                break
        print(f"reset: initialized again at frame {again}")
        if again is None:
            fail(f"reset: no initialization within {SYS_INIT_BY} frames of the reset")
    finally:
        slam.shutdown()


def cli_run(card):
    """Phase 11 (d): python3 -m multicol_slam_tpu_torch.cli on the card with
    async mapping over CLI_FRAMES synthetic frames: exit 0, the trajectory
    and map.npz written, the map loading onto the card, its ATE printed and
    matched by python3 -m multicol_slam_tpu_torch.evaluate against the
    ground truth saved here."""
    from multicol_slam_tpu_torch import cli
    from multicol_slam_tpu_torch.utils import checkpoint, config_io
    from multicol_slam_tpu_torch.utils.trajectory import save_tum

    repo = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="cli_")
    try:
        cmd = [sys.executable, "-m", "multicol_slam_tpu_torch.cli", "--calib",
               config_io.SYNTH_RIG_DIR, "--synthetic", str(CLI_FRAMES), "--async-mapping",
               "--out-dir", out]
        run, ms = timed(lambda: subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                                               timeout=600))
        print("\n".join("cli: " + line for line in run.stdout.strip().splitlines()[-6:]))
        if run.returncode != 0:
            fail(f"the CLI exited {run.returncode}: {run.stderr[-2000:]}")
        found = [line for line in run.stdout.splitlines() if line.startswith("ATE RMSE")]
        if not found:
            fail("the CLI printed no ATE")
        ate = float(found[0].split(":")[1].split()[0])
        traj, npz = os.path.join(out, "MKFTrajectory.txt"), os.path.join(out, "map.npz")
        m, _ = checkpoint.load_map(npz, device="cuda")
        if m.n_keyframes() < 2 or not all(
                t.is_cuda for kf in m.keyframe_ids() for t in m.kf_features[kf]):
            fail("the CLI's map.npz did not load onto the card with its keyframes")
        gt_path = os.path.join(out, "gt.txt")
        save_tum(gt_path, np.arange(CLI_FRAMES) / config_io.SlamSettings().fps,
                 cli.synthetic_trajectory(CLI_FRAMES))
        ev = subprocess.run([sys.executable, "-m", "multicol_slam_tpu_torch.evaluate", traj,
                             gt_path], cwd=repo, capture_output=True, text=True, timeout=120)
        if ev.returncode != 0:
            fail(f"evaluate exited {ev.returncode}: {ev.stderr[-2000:]}")
        rec = json.loads(ev.stdout.strip().splitlines()[-1])
        n_rows = len(np.loadtxt(traj, ndmin=2))
        print(f"cli: {ms / 1e3:.3f} s, {m.n_keyframes()} keyframes in map.npz, evaluate {rec} "
              f"({card})")
        if rec["n_associated"] != n_rows or abs(rec["ate_rmse_m"] - ate) > 1e-4:
            fail(f"evaluate scored {rec}, the CLI printed an ATE of {ate} over {n_rows} rows")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def ring_cayley() -> np.ndarray:
    """(RING_CAMS, 6) float32 minimal extrinsics of the stretch
    configuration's ring: RING_RADIUS from the body's origin, yawed 45
    degrees apart about y (tests/test_eight_camera.py's fixture)."""
    mc = np.zeros((RING_CAMS, 6))
    for c in range(RING_CAMS):
        ang = 2 * np.pi * c / RING_CAMS
        mc[c, 1] = np.tan(ang / 2.0)           # cayley of a yaw about y
        mc[c, 3] = RING_RADIUS * np.sin(ang)
        mc[c, 5] = RING_RADIUS * np.cos(ang)
    return mc.astype(np.float32)


def ring_rig(dev):
    """The stretch configuration's rig, built on ``dev``: eight copies of
    the in-repo rig's camera 0 on the ring of ring_cayley() (Lafida's
    camera in tests/test_eight_camera.py)."""
    from multicol_slam_tpu_torch.ops.camera import stack_cameras
    from multicol_slam_tpu_torch.ops.rig import rig_from_cayley
    from multicol_slam_tpu_torch.utils import config_io

    base = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    return rig_from_cayley(torch.from_numpy(ring_cayley()).to(dev),
                           stack_cameras([base.cams.index(0)] * RING_CAMS))


def ring_tour():
    """tests/test_eight_camera.py's tour: RING_LATERAL lateral frames at
    0.08 m, then a RING_ARC-frame arc of radius 0.6 from the last of them."""
    from multicol_slam_tpu_torch.utils import synthetic

    lat = synthetic.lateral_trajectory(RING_LATERAL, step=0.08, yaw_rate=0.0)
    arc = synthetic.smooth_trajectory(RING_ARC, radius=0.6)
    return np.concatenate([lat, np.einsum("ij,njk->nik", lat[-1], arc[1:])])


def ring_phase(dev, knn, card):
    """Phase 12 (a): the stretch configuration, MultiColSLAM on the ring
    built on the card at the mdBRIEF settings (RING_SETTINGS), loop
    closing off, over ring_tour() in the RING_ROOM_HALF room. Holds
    tests/test_eight_camera.py's bars, its ATE's at RING_MAX_ATE, and the
    masked launches at every site the run reaches, each equal to its
    plain version. Returns (the
    system, the ring, the kernel JSON entries of its call sites)."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.ops import rig as rig_ops
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    ring = ring_rig(dev)
    # the surround ring sees almost every direction (tests/test_eight_camera.py::
    # test_rig_projection_roundtrip), on the card as on the CPU
    gen = torch.Generator().manual_seed(0)
    X = torch.randn((64, 3), generator=gen) * 3
    uv, ok = rig_ops.world_to_img_rig(ring, torch.eye(4, device=dev), X.to(dev))
    uv_c, ok_c = rig_ops.world_to_img_rig(ring.to("cpu"), torch.eye(4), X)
    if uv.device != dev or ok.float().any(0).float().mean() <= 0.9 or not torch.equal(
            ok.cpu(), ok_c) or not torch.allclose(uv.cpu(), uv_c, rtol=0, atol=1e-2):
        fail("the ring's projection on the card is wrong")

    settings = config_io.SlamSettings(**RING_SETTINGS)
    slam = MultiColSLAM(rig=ring, settings=settings, capacity_pts=20000, capacity_kfs=64,
                        enable_loop_closing=False)
    if slam.device != dev or slam.rig.M_c.device != dev or \
            slam.rig.n_cams != RING_CAMS or not slam.tracker.params.masked:
        fail(f"the ring system runs on {slam.device} with {slam.rig.n_cams} cameras")
    gt = ring_tour()
    render = synthetic.make_renderer(ring, room_half=RING_ROOM_HALF)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    times, kinds, est, used = [], [], [], []
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        for i in range(len(gt)):
            n_passes = len(slam.mapping_ms)
            M, ms = timed(lambda: slam.track(frames[i], i / settings.fps))
            times.append(ms)
            kinds.append("init" if not used and M is not None else
                         slam.tracker.frame_path[-1] if len(slam.mapping_ms) == n_passes
                         else "keyframe")
            if M is not None:
                est.append(np.asarray(M, np.float64)[:3, 3])
                used.append(i)
    m = slam.map
    init = used[0] if used else None
    print(f"ring: {RING_CAMS} cameras {tuple(frames.shape[-2:])}, {settings.n_features} "
          f"features, {settings.n_levels} levels, {len(gt)} frames: init at frame {init}, "
          f"{m.n_keyframes()} keyframes ({len(slam.mapping_ms)} mapping passes), "
          f"{m.n_points()} points, {len(est)} frames tracked, frame paths "
          f"{dict(Counter(slam.tracker.frame_path))}")
    if not est:
        fail("the ring system never initialized")
    ate = ate_rmse(np.stack(est), gt[used, :3, 3])
    print(f"ring: ATE (Sim3-aligned, {len(est)} frames) {ate:.5f} m (held under {RING_MAX_ATE} m; "
          f"tests/test_eight_camera.py's {RING_TEST_ATE} m met: {bool(ate < RING_TEST_ATE)})")
    for kind in sorted(set(kinds)):
        print(f"ring frame ms, {kind}: "
              f"{percentiles([t for t, k in zip(times, kinds) if k == kind])} ({card})")
    print(f"ring mapping_ms per pass: {[round(x, 3) for x in slam.mapping_ms]} ({card})")
    if m.n_keyframes() < RING_MIN_KFS or m.n_points() <= RING_MIN_PTS:
        fail(f"the ring's map stalled: {m.n_keyframes()} keyframes, {m.n_points()} points")
    if len(est) < RING_TRACKED_FRAC * len(gt) or not np.isfinite(ate) or ate >= RING_MAX_ATE:
        fail(f"the ring tracked {len(est)} of {len(gt)} frames, ATE {ate:.4f} m")

    # masked matching at every site the run reached
    print(f"ring: launches by call site {dict(spy.launches)}, of them with the masks "
          f"{dict(spy.masked)}")
    for site, n in spy.launches.items():
        if spy.masked[site] != n:
            fail(f"ring: call site {site} passed masks on {spy.masked[site]} of {n} launches")
        if any(torch.is_tensor(a) and a.device != dev for a in spy.args[site][1]):
            fail(f"ring: call site {site} launched on tensors off the card")
    sites = RING_SITES + tuple(sorted(set(spy.launches) - set(RING_SITES)))
    return slam, ring, check_launches(knn, spy, sites, card, tag="_ring")


def robust_cost(chi2, obs):
    from multicol_slam_tpu_torch.models.optimizer import HUBER_GLOBAL as h
    e = torch.sqrt(chi2.double())
    rho = torch.where(e <= h, e * e, 2 * h * e - h * h)
    return float(torch.where(obs.valid, rho, torch.zeros_like(rho)).sum())


def selfcal_phase(dev, card, slam, ring):
    """Phase 12 (b): self-calibrating MultiCol BA and the intrinsics
    refinement on the ring's map, on the card. Every keyframe goes
    through assemble_ba_problem, cameras 1-7 are perturbed by
    tests/test_optimizer.py's offsets (odd cameras by camera 1's, even
    ones by camera 2's), and the BA runs in the gauge of that test: the
    first two keyframes and camera 0 fixed (with one keyframe fixed the
    map's scale is free: see SELFCAL_FIXED_KFS). Holds, on the map as
    tracked: camera 0 unchanged exactly, the cost no higher, and every
    perturbed camera SELFCAL_MIN_GAIN times closer to where the same BA
    takes the rig the map was built with; on the same keyframes, points
    and observations with every measurement projected through that rig:
    every perturbed camera SELFCAL_MIN_GAIN times closer to the rig. Then
    refine_intrinsics on the map as tracked with every principal point
    off by (+1.5, -1.0) px: each INTRINSICS_MIN_GAIN times closer. Every
    output on the card; ms per call printed."""
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.models.local_mapping import assemble_ba_problem
    from multicol_slam_tpu_torch.ops.camera import world_to_img
    from multicol_slam_tpu_torch.ops.geometry import cayley2hom, inv_se3
    from multicol_slam_tpu_torch.ops.rig import Rig, rig_from_cayley

    m = slam.map
    kfs = sorted(int(k) for k in m.keyframe_ids())

    def problem_with(n_fixed):
        fixed = np.zeros(len(kfs), bool)
        fixed[:n_fixed] = True
        problem, mt0, X0, pts, _ = assemble_ba_problem(
            m, kfs, fixed, slam.settings.scale_factor, device=dev)
        return problem, torch.from_numpy(mt0).to(dev), torch.from_numpy(X0).to(dev), len(pts)

    def error(mc, ref):
        """Per camera sqrt(|t - t_ref|^2 + angle^2) (m, rad) between the
        extrinsics mc and ref (C, 6), from their matrices in float64: camera
        4 sits at a yaw of 180 degrees, where the Cayley vector is singular
        (its c1 is tan(pi/2)), so a difference of Cayley vectors means
        nothing there."""
        M, R = cayley2hom(mc.double()), cayley2hom(ref.double())
        dR = R[:, :3, :3].transpose(-1, -2) @ M[:, :3, :3] - torch.eye(3, dtype=M.dtype,
                                                                        device=M.device)
        ang = dR.flatten(1).norm(dim=-1) / np.sqrt(2.0)
        return torch.sqrt(ang ** 2 + (M[:, :3, 3] - R[:, :3, 3]).norm(dim=-1) ** 2)

    dist = lambda mc, ref: [round(float(x), 6) for x in error(mc, ref)]
    problem, mt0, X0, n_pts = problem_with(SELFCAL_FIXED_KFS)
    obs = problem.obs
    mc_true = ring.M_c_min
    off = torch.tensor([SELFCAL_OFFSET[c % 2] for c in range(RING_CAMS)], dtype=torch.float32,
                       device=dev)
    off[0] = 0.0
    rig_pert = rig_from_cayley(mc_true + off, ring.cams)
    mc_pert = rig_pert.M_c_min
    print(f"selfcal: {len(kfs)} keyframes (padded to {mt0.shape[0]}), {n_pts} points "
          f"(padded to {X0.shape[0]}), {int(obs.valid.sum())} observations, "
          f"{problem.pt_obs.shape[1]} a point at most; cameras 1-7 start "
          f"{dist(mc_pert, mc_true)} from the rig the map was built with")

    def selfcal(rig, prob, label, warm=False):
        out, ms = timed(lambda: opt.self_calibrating_bundle_adjustment(
            rig, mt0, X0, prob, iters=SELFCAL_ITERS))
        msg = f"ms cold {ms:.3f}"
        if warm:
            msg += f", warm {timed(lambda: opt.self_calibrating_bundle_adjustment(rig, mt0, X0, prob, iters=SELFCAL_ITERS))[1]:.3f}"
        if any(t.device != dev for t in out):
            fail(f"selfcal: an output of the self-calibrating BA ({label}) lies off the card")
        cost0 = robust_cost(opt.self_calibrating_bundle_adjustment(
            rig, mt0, X0, prob, iters=0)[3], prob.obs)
        print(f"selfcal: {label}, {SELFCAL_ITERS} iterations, {msg}; robust cost {cost0:.3f} "
              f"-> {robust_cost(out[3], prob.obs):.3f} ({card})")
        return out, cost0

    # one keyframe fixed, as a local BA would: printed, not held
    p1 = problem_with(1)[0]
    (_, _, mc1, _), _ = selfcal(rig_pert, p1, "the first keyframe and camera 0 fixed")
    print(f"selfcal: with one keyframe fixed the cameras end {dist(mc1, mc_true)} from the "
          f"rig the map was built with (not held: the scale is free)")

    # the map as tracked, from the perturbed rig and from the rig it was built with
    (mt, X, mc, chi2), cost0 = selfcal(rig_pert, problem, "perturbed rig", warm=True)
    (_, _, mc_ref, _), _ = selfcal(ring, problem, "the rig the map was built with")
    (r_mt, r_X, r_chi2), ms_r = timed(lambda: opt.bundle_adjustment(
        rig_pert, mt0, X0, problem, iters=SELFCAL_ITERS, free_mc=True))
    if any(t.device != dev for t in (r_mt, r_X, r_chi2)):
        fail("selfcal: an output of bundle_adjustment(free_mc=True) lies off the card")
    cost1, cost_r = robust_cost(chi2, obs), robust_cost(r_chi2, obs)
    before, after = error(mc_pert, mc_ref), error(mc, mc_ref)
    print(f"selfcal: from the perturbed rig the cameras end {dist(mc, mc_ref)} from where the "
          f"BA takes the rig the map was built with (started {dist(mc_pert, mc_ref)}), "
          f"{dist(mc, mc_true)} from that rig, which itself ends {dist(mc_ref, mc_true)} from "
          f"it; bundle_adjustment(free_mc=True) {ms_r:.3f} ms, cost {cost_r:.3f}, poses within "
          f"{float((r_mt - mt).abs().max()):.2e} ({card})")
    if not torch.equal(mc[0], mc_pert[0]) or not torch.equal(mc_ref[0], mc_true[0]):
        fail("selfcal: camera 0, the gauge, moved")
    if not bool((SELFCAL_MIN_GAIN * after[1:] <= before[1:]).all()):
        fail(f"selfcal: a perturbed camera came back less than {SELFCAL_MIN_GAIN}x closer to "
             f"the BA's calibration from the rig the map was built with")
    if not cost1 <= cost0 or not cost_r <= cost0:
        fail(f"selfcal: the cost rose from {cost0} to {cost1} / {cost_r}")

    # the same keyframes, points and observations, measured through the rig
    kf, cam, pt = obs.kf.long(), obs.cam.long(), obs.pt.long()
    cams = ring.cams.index(cam)
    T = inv_se3(cayley2hom(mt0[kf]) @ cayley2hom(mc_true[cam]))
    Xc = torch.einsum("kij,kj->ki", T[:, :3, :3], X0[pt]) + T[:, :3, 3]
    exact = problem._replace(obs=obs._replace(uv=world_to_img(cams, Xc)))
    (_, _, mc_x, _), _ = selfcal(rig_pert, exact, "measurements projected through the rig")
    before_x, after_x = error(mc_pert, mc_true), error(mc_x, mc_true)
    print(f"selfcal: on measurements projected through the rig the cameras end "
          f"{dist(mc_x, mc_true)} from it ({card})")
    if not torch.equal(mc_x[0], mc_pert[0]) or not bool(
            (SELFCAL_MIN_GAIN * after_x[1:] <= before_x[1:]).all()):
        fail(f"selfcal: on exact measurements a perturbed camera came back less than "
             f"{SELFCAL_MIN_GAIN}x closer to the rig")

    # the two new Jacobians on the card against the CPU, on the problem's rows
    cpu = lambda t: t.cpu()
    for name, a, b in (
            ("extrinsic", opt.extrinsic_jacobian(mt0[kf], mc_true[cam], X0[pt], cams),
             opt.extrinsic_jacobian(cpu(mt0[kf]), cpu(mc_true[cam]), cpu(X0[pt]),
                                    cams.to("cpu"))),
            ("intrinsics", opt.intrinsics_jacobian(Xc, cams),
             opt.intrinsics_jacobian(cpu(Xc), cams.to("cpu")))):
        err = float(((a.cpu() - b).abs() / (b.abs().amax(dim=(1, 2), keepdim=True) + 1e-12)).max())
        print(f"selfcal: {name}_jacobian {tuple(a.shape)} on the card against the CPU: max "
              f"relative difference {err:.2e}")
        if a.device != dev or not err < 1e-3:
            fail(f"selfcal: {name}_jacobian on the card differs from the CPU's")

    # the intrinsics: every camera's principal point off by (+1.5, -1.0) px
    v_true = ring.cams.to_vector17()
    v_pert = v_true.clone()
    v_pert[:, 3] += 1.5
    v_pert[:, 4] -= 1.0
    rig_i = Rig(M_c=ring.M_c, cams=ring.cams.with_vector17(v_pert))
    (cams_r, v17, cost_i), cold = timed(lambda: opt.refine_intrinsics(
        rig_i, mt0, X0, obs, iters=INTRINSICS_ITERS))
    _, warm = timed(lambda: opt.refine_intrinsics(rig_i, mt0, X0, obs, iters=INTRINSICS_ITERS))
    if any(t.device != dev for t in (v17, cost_i, *cams_r)):
        fail("selfcal: an output of refine_intrinsics lies off the card")
    d_u, d_v = (v17[:, 3] - v_true[:, 3]).abs(), (v17[:, 4] - v_true[:, 4]).abs()
    print(f"selfcal: refine_intrinsics {INTRINSICS_ITERS} iterations, ms cold {cold:.3f}, warm "
          f"{warm:.3f}; |u0 - truth| per camera {[round(float(x), 4) for x in d_u]} px (from "
          f"1.5), |v0 - truth| {[round(float(x), 4) for x in d_v]} px (from 1.0); cost "
          f"{float(cost_i):.3f} ({card})")
    if not bool((INTRINSICS_MIN_GAIN * d_u <= 1.5).all() & (INTRINSICS_MIN_GAIN * d_v <= 1.0).all()):
        fail(f"selfcal: a principal point came back less than {INTRINSICS_MIN_GAIN}x closer")


def dynamic_phase(dev, knn, card):
    """Phase 12 (c): tests/test_dynamic_scene.py's run on the in-repo rig
    at full width on the card: MultiColSLAM (loop closing on) at
    DYN_SETTINGS over bench_trajectory(DYN_FRAMES, radius=DYN_RADIUS)
    with DYN_SPHERES crossing the room. Holds that test's bars (WORKING
    share from the first tracked frame, ATE, no loop fired, a landmark
    culled) and the launches of its path, each site equal to plain.
    Returns the kernel JSON entries of its call sites."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, synthetic
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    settings = config_io.SlamSettings(**DYN_SETTINGS)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings,
                        capacity_pts=25000, capacity_kfs=64)
    if slam.rig.M_c.device != dev or not slam._enable_loops:
        fail("the dynamic-scene system is not on the card with loop closing on")
    gt = synthetic.bench_trajectory(DYN_FRAMES, radius=DYN_RADIUS)
    render = synthetic.make_renderer(slam.rig, distractors=DYN_SPHERES)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev),
                                time=torch.arange(DYN_FRAMES, dtype=torch.float32)))
    frames = frames.to(torch.uint8)
    est, used, times = [], [], []
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        for t in range(DYN_FRAMES):
            M, ms = timed(lambda: slam.track(frames[t], t / settings.fps))
            times.append(ms)
            if M is not None:
                est.append(np.asarray(M, np.float64)[:3, 3])
                used.append(t)
    if not used:
        fail(f"the dynamic-scene system never tracked: {slam.tracker.frame_path}")
    m, lc = slam.map, slam.loop_closer
    frac = len(est) / (DYN_FRAMES - used[0])
    ate = ate_rmse(np.stack(est), gt[used, :3, 3])
    culled = int((~m.pt_valid[:m._next_pt]).sum())
    fired = lc is not None and lc.last_loop_kf >= 0
    bars = {"working": frac >= DYN_WORKING_FRAC, "ate": bool(ate < DYN_MAX_ATE),
            "no_loop": not fired, "culled": culled > 0}
    print(f"dynamic: {DYN_FRAMES} frames, first tracked {used[0]}, WORKING share {frac:.4f}, "
          f"ATE {ate:.5f} m, {m.n_keyframes()} keyframes, {m.n_points()} points, {culled} "
          f"landmarks culled, loop fired {fired}; frame paths "
          f"{dict(Counter(slam.tracker.frame_path))}; frame ms {percentiles(times)}; bars "
          f"{bars} ({card})")
    missed = [k for k, ok in bars.items() if not ok and k not in DYN_NOT_HELD]
    if missed:
        fail(f"the dynamic scene missed the bars {missed}")
    sites = DYN_SITES + tuple(sorted(set(spy.launches) - set(DYN_SITES)))
    return check_launches(knn, spy, sites, card, tag="_dynamic")


def frame_kind(slam, was_working, n_passes):
    """A frame's kind once tracked: init, keyframe (a mapping pass ran) or
    working."""
    return ("init" if not was_working else
            "keyframe" if len(slam.mapping_ms) > n_passes else "working")


def two_room_phase(dev, knn, card):
    """Phase 13 (a): tests/test_two_room.py's tour on the card at full
    width: MultiColSLAM (loop closing on) at TWO_ROOM_SETTINGS over the
    two-room tour through the door wall. Holds that test's bars (WORKING
    share from the first WORKING frame, keyframes, points, no loop fired)
    and the launches of its path, each site equal to plain. Returns (the
    system, the kernel JSON entries of its call sites)."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    settings = config_io.SlamSettings(**TWO_ROOM_SETTINGS)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings,
                        capacity_pts=25000, capacity_kfs=96, enable_loop_closing=True)
    if slam.rig.M_c.device != dev or not slam._enable_loops:
        fail("the two-room system is not on the card with loop closing on")
    gt = synthetic.two_room_loop_trajectory(TWO_ROOM_FRAMES)
    render = synthetic.make_renderer(slam.rig, room_half=TWO_ROOM_HALF, door_wall=TWO_ROOM_DOOR)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    states, times, kinds = [], [], []
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        for t in range(TWO_ROOM_FRAMES):
            was_working, n_passes = slam.state == TrackState.WORKING, len(slam.mapping_ms)
            _, ms = timed(lambda: slam.track(frames[t], t / settings.fps))
            states.append(slam.state)
            times.append(ms)
            kinds.append(frame_kind(slam, was_working, n_passes))
    slam.shutdown()
    m, lc = slam.map, slam.loop_closer
    if TrackState.WORKING not in states:
        fail(f"the two-room system never tracked: {slam.tracker.frame_path}")
    first = states.index(TrackState.WORKING)
    frac = float(np.mean([s == TrackState.WORKING for s in states[first:]]))
    fired = lc is None or lc.last_loop_kf >= 0
    bars = {"working": frac > TWO_ROOM_WORKING_FRAC,
            "keyframes": m.n_keyframes() >= TWO_ROOM_MIN_KFS,
            "points": m.n_points() > TWO_ROOM_MIN_PTS, "no_loop": not fired}
    print(f"two rooms: {TWO_ROOM_FRAMES} frames, first WORKING {first}, WORKING share "
          f"{frac:.4f}, {m.n_keyframes()} keyframes ({len(slam.mapping_ms)} mapping passes), "
          f"{m.n_points()} points, loop fired {fired}; frame paths "
          f"{dict(Counter(slam.tracker.frame_path))}; bars {bars} ({card})")
    for kind in ("init", "working", "keyframe"):
        xs = [t for t, k in zip(times, kinds) if k == kind]
        print(f"two rooms frame ms, {kind}: {percentiles(xs)} ({card})")
    missed = [k for k, ok in bars.items() if not ok]
    if missed:
        fail(f"the two-room tour missed the bars {missed}")
    sites = TWO_ROOM_SITES + tuple(sorted(set(spy.launches) - set(TWO_ROOM_SITES)))
    return slam, check_launches(knn, spy, sites, card, tag="_two_room")


def map_copy(m):
    """A MapStore with m's state deep-copied and m's callbacks."""
    c = copy.copy(m)
    vars(c).update(map_state(m))
    return c


def rig_f64(rig):
    from multicol_slam_tpu_torch.ops.camera import CameraModel
    from multicol_slam_tpu_torch.ops.rig import Rig
    return Rig(M_c=rig.M_c.double(), cams=CameraModel(
        *(f.double() if f.is_floating_point() else f for f in rig.cams)))


class ShardSpy:
    """Counts the meshes ``ba_sharding.make_sharded_ba`` is built for."""

    def __init__(self):
        from multicol_slam_tpu_torch.parallel import ba_sharding
        self.bs, self.meshes = ba_sharding, []

    def __enter__(self):
        self.orig = self.bs.make_sharded_ba
        self.bs.make_sharded_ba = lambda devices, *a, **k: (
            self.meshes.append(len(devices)), self.orig(devices, *a, **k))[1]
        return self

    def __exit__(self, *exc):
        self.bs.make_sharded_ba = self.orig


def sharded_map_ba(dev, card, name, slam):
    """Phase 13 (b) on one system's map: run_global_ba on copies of the
    map with the default mesh (one card: single-device) and with
    devices=[card] * D, D in SHARDS, keyframe 0 the gauge: the summed
    chi2 within SHARD_MAX_REL of the single-device run's and the gauge
    unmoved exactly, the largest pose and point differences printed; then
    the same problem in float64 through make_sharded_ba and
    bundle_adjustment, poses and points within SHARD_F64_TOL."""
    from multicol_slam_tpu_torch.models import global_ba
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.models.local_mapping import assemble_ba_problem
    from multicol_slam_tpu_torch.parallel import ba_sharding as bs

    m = slam.map
    kfs = sorted(int(k) for k in m.keyframe_ids())
    pts = np.nonzero(m.pt_valid)[0]
    sf = slam.settings.scale_factor
    if global_ba.default_mesh(slam.rig) != [dev]:
        fail(f"the default mesh is {global_ba.default_mesh(slam.rig)}, not [{dev}]")
    runs = {}
    for D in (1,) + SHARDS:
        c = map_copy(m)
        with ShardSpy() as spy:
            chi2, ms = timed(lambda: global_ba.run_global_ba(
                slam.rig, c, [kfs[0]], sf, iters=GBA_ITERS, devices=None if D == 1 else [dev] * D))
        if spy.meshes != ([] if D == 1 else [D]):
            fail(f"{name}: run_global_ba at D={D} built sharded BAs for {spy.meshes}")
        runs[D] = (c, chi2, ms)
    ref, chi2_1, ms_1 = runs[1]
    print(f"sharded BA, {name}: {len(kfs)} keyframes, {len(pts)} points, {GBA_ITERS} "
          f"iterations, float32: single-device chi2 {chi2_1:.4f} in {ms_1:.3f} ms ({card})")
    for D in SHARDS:
        c, chi2, ms = runs[D]
        rel = abs(chi2 - chi2_1) / chi2_1
        d_pose = float(np.abs(c.kf_pose[kfs] - ref.kf_pose[kfs]).max())
        d_pt = float(np.abs(c.pt_pos[pts] - ref.pt_pos[pts]).max())
        gauge = np.array_equal(c.kf_pose[kfs[0]], m.kf_pose[kfs[0]])
        print(f"sharded BA, {name}, D={D} on one card: chi2 {chi2:.4f} (relative to "
              f"single-device {rel:.3e}), largest pose difference {d_pose:.3e}, point "
              f"difference {d_pt:.3e} m, gauge unmoved {gauge}, {ms:.3f} ms ({card})")
        if not np.isfinite(chi2) or rel > SHARD_MAX_REL or not gauge:
            fail(f"{name}: the sharded BA at D={D} is off the single-device run")

    # the same problem in float64, element-wise
    fixed = np.arange(len(kfs)) == 0
    problem, mt0, X0, _, _ = assemble_ba_problem(m, kfs, fixed, sf, device=dev)
    f64 = lambda t: t.double() if t.is_floating_point() else t
    obs = opt.BAObservations(*(f64(t) for t in problem.obs))
    problem = problem._replace(obs=obs)
    rig = rig_f64(slam.rig)
    mt0 = torch.as_tensor(mt0, dtype=torch.float64, device=dev)
    X0 = torch.as_tensor(X0, dtype=torch.float64, device=dev)
    N, P = mt0.shape[0], X0.shape[0]
    mt1, X1, _ = opt.bundle_adjustment(rig, mt0, X0, problem, iters=GBA_ITERS)
    worst = 0.0
    for D in SHARDS:
        devs = [dev] * D
        ba = bs.make_sharded_ba(devs, rig, N, P, iters=GBA_ITERS)
        mt, X, _ = ba(mt0, X0, bs.shard_obs(bs.pad_obs_to_multiple(obs, D), devs),
                      problem.pt_obs, problem.fixed_kf, problem.fixed_pt)
        if mt.device != dev or X.device != dev:
            fail(f"{name}: the float64 sharded BA's outputs lie off the card")
        d = max(float((mt - mt1).abs().max()), float((X - X1).abs().max()))
        worst = max(worst, d)
        print(f"sharded BA, {name}, float64, D={D}: poses {float((mt - mt1).abs().max()):.3e}, "
              f"points {float((X - X1).abs().max()):.3e} from the single-device run")
    if not worst <= SHARD_F64_TOL:
        fail(f"{name}: the float64 sharded BA is {worst:.3e} off the single-device run")


def lm_trace(step, cost, mt, X, iters):
    """``iters`` steps of the BA's schedule (optimizer.lm_accept) from
    (mt, X), step(mt, X, lam) -> (mt', X') and cost(mt, X) -> robust cost
    given. Returns the costs, one a step after the start, and which steps
    were taken."""
    from multicol_slam_tpu_torch.models import optimizer as opt

    c = cost(mt, X)
    costs, taken = [float(c)], []
    lam = torch.full((), 1e-4, dtype=X.dtype, device=X.device)
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    for _ in range(iters):
        mt_n, X_n = step(mt, X, lam)
        take, c, lam, done = opt.lm_accept(c, cost(mt_n, X_n), lam, done)
        mt, X = torch.where(take, mt_n, mt), torch.where(take, X_n, X)
        costs.append(float(c))
        taken.append(bool(take))
    return costs, taken


def map_scale_ba(dev, card):
    """Phase 13 (c): the JAX package's map-scale dry run
    (__graft_entry__.py:76-96) on the card: make_ba_problem(rig, 64, 8192,
    max_obs_per_pt=8) in float32 from its offsets, MAP_ITERS iterations,
    the sharded BA at D = 8 within SHARD_MAX_REL of the single-device
    robust cost and both below MAP_MIN_GAIN of the start; the per-iteration
    costs of both, each step taken or not, printed; ms per iteration of the
    single path and of D = 1, 2, 4, 8 on the one card; the peak memory of
    the D = 8 run above what the process held before it."""
    from multicol_slam_tpu_torch.models import optimizer as opt
    from multicol_slam_tpu_torch.parallel import ba_sharding as bs
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    rig = config_io.load_mcs(config_io.SYNTH_RIG_DIR)[0].to(dev)
    (mt_true, X_true, uv, kf, cam, pt, valid, pt_obs), build_ms = timed(
        lambda: synthetic.make_ba_problem(rig, MAP_KF, MAP_PT, max_obs_per_pt=MAP_OBS))
    K = int(valid.sum())
    on = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    obs = opt.BAObservations(uv=on(uv, torch.float32), kf=on(kf), cam=on(cam), pt=on(pt),
                             inv_sigma2=torch.ones(len(kf), device=dev), valid=on(valid))
    rng = np.random.default_rng(1)
    mt0 = mt_true + rng.standard_normal(mt_true.shape) * 0.002
    mt0[0] = mt_true[0]
    X0 = X_true + rng.standard_normal(X_true.shape) * 0.01
    fixed_kf = torch.zeros(MAP_KF, dtype=torch.bool, device=dev)
    fixed_kf[0] = True
    fixed_pt = torch.zeros(MAP_PT, dtype=torch.bool, device=dev)
    mt0, X0, pt_obs = on(mt0, torch.float32), on(X0, torch.float32), on(pt_obs)
    problem = opt.BAProblem(obs, pt_obs, fixed_kf, fixed_pt)
    h = opt.HUBER_GLOBAL
    blocks, cost_of = opt.make_ba_blocks(rig, obs, fixed_kf, fixed_pt, MAP_KF, MAP_PT, h)
    start = float(cost_of(mt0, X0)[0])
    print(f"map-scale BA: {MAP_KF} keyframes x {MAP_PT} points x {K} observations (at most "
          f"{MAP_OBS} a point), built in {build_ms:.3f} ms; start robust cost {start:.3f}")

    # the per-iteration traces: the single path's two halves, and
    # make_sharded_ba_step at D = 8 (its cost: the cost at a step's input)
    solve = opt.make_schur_solve(obs.kf, obs.valid, pt_obs, fixed_kf, fixed_pt, MAP_KF)

    def single_step(mt, X, lam):
        dp, dx = solve(*blocks(mt, X)[:5], lam)
        return mt - dp, X - dx

    devs = [dev] * SHARDS[-1]
    shards = bs.shard_obs(bs.pad_obs_to_multiple(obs, len(devs)), devs)
    step8 = bs.make_sharded_ba_step(devs, rig, MAP_KF, MAP_PT)
    traces = {
        "single": lm_trace(single_step, lambda mt, X: cost_of(mt, X)[0], mt0, X0, MAP_ITERS),
        f"D={len(devs)}": lm_trace(
            lambda mt, X, lam: step8(mt, X, shards, pt_obs, fixed_kf, fixed_pt, lam)[:2],
            lambda mt, X: step8(mt, X, shards, pt_obs, fixed_kf, fixed_pt, 0.0)[2],
            mt0, X0, MAP_ITERS)}
    for name, (costs, taken) in traces.items():
        print(f"map-scale BA, {name}: robust cost by iteration "
              f"{[round(c, 4) for c in costs]}, steps taken {taken}")

    # the full LMs, warm, timed: the single path and D = 1, 2, 4, 8
    def single():
        mt, X, _ = opt.bundle_adjustment(rig, mt0, X0, problem, iters=MAP_ITERS)
        return mt, X, cost_of(mt, X)[0]

    runs = {"single": single}
    for D in (1,) + SHARDS:
        devs = [dev] * D
        sh = bs.shard_obs(bs.pad_obs_to_multiple(obs, D), devs)
        ba = bs.make_sharded_ba(devs, rig, MAP_KF, MAP_PT, iters=MAP_ITERS)
        runs[f"D={D}"] = lambda ba=ba, sh=sh: ba(mt0, X0, sh, pt_obs, fixed_kf, fixed_pt)
    out, ms = {}, {}
    for name, run in runs.items():
        run()
        if name == f"D={SHARDS[-1]}":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        out[name], ms[name] = timed(run)
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 20
    print(f"map-scale BA ms an iteration ({MAP_ITERS} iterations, warm): "
          f"{ {k: round(v / MAP_ITERS, 3) for k, v in ms.items()} }; shards share one card, "
          f"so this is the cost of sharding, not scaling; peak memory of the D={SHARDS[-1]} "
          f"run {peak:.1f} MiB above the {held / 2 ** 20:.1f} MiB held before it ({card})")
    c1 = float(out["single"][2])
    for name, (mt, X, c) in out.items():
        if any(t.device != dev for t in (mt, X, c)):
            fail(f"map-scale BA, {name}: an output lies off the card")
        rel = abs(float(c) - c1) / c1
        print(f"map-scale BA, {name}: final robust cost {float(c):.4f} (relative to the "
              f"single path {rel:.3e}, {float(c) / start:.4f} of the start), largest pose "
              f"difference {float((mt - out['single'][0]).abs().max()):.3e}")
        if not np.isfinite(float(c)) or rel > SHARD_MAX_REL or float(c) >= MAP_MIN_GAIN * start:
            fail(f"map-scale BA, {name}: cost {float(c):.4f} against {c1:.4f} single, "
                 f"{start:.4f} at the start")


def reloc_error(m, poses, gt, at, i):
    """(m, degrees): frame i's returned pose (poses: frame -> (4, 4) or
    None) against ground truth, both relative to frame at - 1: its pose in
    map m when it is a keyframe (local BA may have moved it since it was
    returned), else the pose returned for it; so the map's drift before
    frame at - 1 does not count. None without a pose."""
    from multicol_slam_tpu_torch.ops import se3_np

    if poses[i] is None:
        return None
    kf = [k for k in m.keyframe_ids() if m.kf_frame_id[k] == at - 1]
    ref = se3_np.cayley2hom(m.kf_pose[kf[0]]) if kf else poses[at - 1]
    t, r = pose_errors_hom(np.linalg.inv(ref) @ poses[i], np.linalg.inv(gt[at - 1]) @ gt[i])
    return round(t, 5), round(r, 4)


def keyframes_moved(m, before):
    """How many keyframes there are now against ``before`` (keyframe ->
    pose), and how far the ones of ``before`` have moved since."""
    from multicol_slam_tpu_torch.ops import se3_np

    moved = max(pose_errors_hom(se3_np.cayley2hom(m.kf_pose[k]), M)[0]
                for k, M in before.items() if m.kf_valid[k])
    return (f"keyframes {len(before)} -> {m.n_keyframes()}, the earlier ones moved up to "
            f"{moved:.5f} m since phase 6")


def second_chance(tr, m):
    """tests/test_full_slam.py's second-chance round: 16 BoW triples
    against the last keyframe's own features, every other slot corrupted.
    Returns whether the single-pass fit, the second-chance round, and the
    projection round alone (the widened local-map re-match off) recover."""
    kf = int(m.keyframe_ids()[-1])
    feats = m.kf_features[kf]
    cams, slots = np.nonzero(m.kf_pt[kf] >= 0)
    order = np.argsort(slots, kind="stable")
    cams, slots = cams[order][:16], slots[order][:16]
    K = m.kf_pt.shape[2]
    triples = [(int(m.kf_pt[kf, c, s]), int(c), int(s) if i % 2 == 0 else int((s + 37) % K))
               for i, (c, s) in enumerate(zip(cams, slots))]
    fns = (tr.reloc_candidates_fn, tr.reloc_bow_match_fn)

    def run(second: bool) -> bool:
        tr.cfg.reloc_second_chance = second
        tr.cur_feats = feats
        tr.cur_pt = np.full_like(m.kf_pt[kf], -1)
        tr.cur_outlier = np.zeros(tr.cur_pt.shape, bool)
        tr.cur_mt = m.kf_pose[kf].copy()
        tr.reloc_candidates_fn = lambda f: [kf]
        tr.reloc_bow_match_fn = lambda k, f: triples if k == kf else []
        try:
            return bool(tr._relocalize())
        finally:
            tr.cfg.reloc_second_chance = True
            tr.reloc_candidates_fn, tr.reloc_bow_match_fn = fns

    single, full = run(False), run(True)
    tr._track_local_map = lambda *a, **k: False
    try:
        proj_only = run(True)
    finally:
        del tr._track_local_map
    return single, full, proj_only


def cayley_to_hom(mt):
    from multicol_slam_tpu_torch.ops.geometry import cayley2hom
    return cayley2hom(mt.detach().double().cpu()).numpy()


def pose_errors(mt, gt):
    """(translation m, rotation deg) of pose mt (6,) against gt (4, 4)."""
    return pose_errors_hom(cayley_to_hom(mt), gt)


def pose_errors_hom(M, gt):
    """(translation m, rotation deg) of pose M (4, 4) against gt (4, 4)."""
    t = float(np.linalg.norm(M[:3, 3] - gt[:3, 3]))
    c = (np.trace(M[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    return t, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on an NVIDIA GPU only")
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn
    from multicol_slam_tpu_torch.models import matcher, tracking
    from multicol_slam_tpu_torch.utils import config_io, synthetic

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_script = last = time.perf_counter()
    phase_s = {}

    def mark(name):
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = round(now - last, 3)
        last = now

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    mark("1 card")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    knn.load_library()
    print(f"kernel build s {time.perf_counter() - t0:.3f} ({card})")
    mark("2 build")

    # -- 3. both entries against plain: random and adversarial inputs -------
    gen = torch.Generator(device=dev).manual_seed(0)
    for C, N, M in [(3, 400, 400), (3, 2048, 400), (2, 1, 1), (2, 1, 257),
                    (2, 129, 1), (2, 129, 257)]:
        q, db, gate, qm, dbm = random_case(C, N, M, dev, gen)
        for masks in [(), (qm, dbm)]:
            compare(knn, "dense", (q, db, gate) + masks)
        print(f"hamming_nn == plain at C={C} N={N} M={M}, both variants")
    rc = radius_cases()
    for name in rc.CASES:
        case = rc.radius_case(name, seed=len(name))
        for masked in (False, True):
            compare(knn, "radius", radius_args(case, dev, masked))
        print(f"hamming_nn_radius == plain on case {name}, both variants")

    mark("3 entries")

    # -- 4. the WORKING frame at the default configuration ------------------
    settings = config_io.SlamSettings()
    tcfg = tracking.TrackerConfig()
    rig_cpu, _ = config_io.load_mcs(config_io.SYNTH_RIG_DIR)
    rig = rig_cpu.to(dev)
    extract, params = make_slice(settings, rig_cpu)
    gt = synthetic.smooth_trajectory(100, radius=0.6)[:B + 1]
    render = synthetic.make_renderer(rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)
    st = synthetic.gt_bootstrap(rig, torch.tensor(gt[0], dtype=torch.float32, device=dev),
                                extract(frames[0]), settings.n_levels,
                                settings.scale_factor)
    C, K = st["slot_has0"].shape
    print(f"slice: {C} cameras {tuple(frames.shape[-2:])}, {settings.n_levels} levels, "
          f"K={K} slots/camera, map P={st['P']} padded to {st['X'].shape[0]}")

    # warm-up frame
    run_chunk(extract, rig, frames[1:2], st, params, settings, tcfg)
    torch.cuda.synchronize()
    # the main path, counted: one chunk over B frames
    reset_launches(knn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SiteSpy(knn, matcher) as spy:
        carry, ys = run_chunk(extract, rig, frames[1:], st, params, settings, tcfg)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    launches = knn.hamming_nn_radius.launches
    if launches != 2 * B or knn.hamming_nn.launches:
        fail(f"hamming_nn_radius launched {launches} times and hamming_nn "
             f"{knn.hamming_nn.launches} over {B} frames, want {2 * B} and 0")
    wf_entries = [site_entry(knn, f"working_{site}", *spy.args["chunk_" + site],
                             spy.launches["chunk_" + site], card)
                  for site in ("motion", "local_map")]
    # the masked (mdBRIEF) variant, off the default path: the local-map
    # inputs with random stability masks, printed only
    args = spy.args["chunk_local_map"][1]
    site_entry(knn, "working_local_map_masked", "radius",
               args + tuple(torch.randint(-2 ** 31, 2 ** 31, args[i].shape, generator=gen,
                                          dtype=torch.int64, device=dev).to(torch.int32)
                            for i in (0, 1)), 0, card)

    n_in2 = ys["n_in2"].tolist()
    errs = [pose_errors(ys["mt"][b], gt[b + 1]) for b in range(B)]
    for b in range(B):
        print(f"frame {b + 1}: n_m1 {int(ys['n_m1'][b])} n_in1 {int(ys['n_in1'][b])} "
              f"n_in2 {n_in2[b]} t_err {errs[b][0]:.5f} m r_err {errs[b][1]:.4f} deg")
    if not torch.isfinite(ys["mt"]).all() or ys["mt"].shape != (B, 6):
        fail(f"poses of shape {tuple(ys['mt'].shape)}, finite "
             f"{bool(torch.isfinite(ys['mt']).all())}")
    if min(n_in2) < tcfg.min_inliers_local:
        fail(f"local-map inliers {n_in2}: below {tcfg.min_inliers_local}")
    worst_t = max(e[0] for e in errs)
    worst_r = max(e[1] for e in errs)
    if worst_t > MAX_T_ERR or worst_r > MAX_R_ERR:
        fail(f"pose error {worst_t:.4f} m / {worst_r:.3f} deg beyond "
             f"{MAX_T_ERR} m / {MAX_R_ERR} deg")

    # per-frame latency: the same frames one chunk of one frame at a time
    frame_ms = []
    state = dict(st)
    for b in range(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, y = run_chunk(extract, rig, frames[b + 1:b + 2], state, params,
                         settings, tcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        state.update(last=c[0], slot_X0=c[1], slot_lp0=c[2], slot_has0=c[3],
                     mt0=c[4], V0=c[5])
    d_t, d_r = pose_errors(ys["mt"][B - 1], cayley_to_hom(c[4]))
    p90 = float(np.percentile(frame_ms, 90))
    print(f"WORKING frame ms, one frame per call: median "
          f"{statistics.median(frame_ms):.3f} p90 {p90:.3f}; one {B}-frame "
          f"chunk: {chunk_s * 1e3 / B:.3f} ms/frame ({card})")
    print(f"frame {B}: frame-by-frame vs chunk pose diff {d_t:.2e} m {d_r:.2e} deg")

    mark("4 working frame")

    # -- 5. the first frames against the port's CPU path --------------------
    extract_cpu, _ = make_slice(settings, rig_cpu)
    st_cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in st.items()}
    st_cpu["last"] = type(st["last"])(*(t.cpu() for t in st["last"]))
    _, ys_cpu = run_chunk(extract_cpu, rig_cpu, frames[1:1 + B_REF].cpu(), st_cpu,
                          params, settings, tcfg)
    for b in range(B_REF):
        t_d, r_d = pose_errors(ys["mt"][b], cayley_to_hom(ys_cpu["mt"][b]))
        agree = (ys["lp"][b].cpu() == ys_cpu["lp"][b]).float().mean().item()
        a, r = int(ys["n_in2"][b]), int(ys_cpu["n_in2"][b])
        print(f"frame {b + 1} card vs CPU: pose diff {t_d:.2e} m {r_d:.2e} deg, "
              f"slot agreement {agree:.4f}, n_in2 {a} vs {r}")
        if t_d > 1e-3 or r_d > 0.05 or agree < 0.98 or abs(a - r) > 0.02 * r:
            fail(f"frame {b + 1}: the card's run disagrees with the CPU path")

    mark("5 against the CPU")

    # -- 6. the system from the first frame ---------------------------------
    slam, frames, gt, poses, sys_entries, sys_ref = system_phase(dev, knn, card)
    mark("6 system")

    # -- 7. relocalization ---------------------------------------------------
    reloc_entries = reloc_phase(knn, card, slam, frames, gt, poses)
    mark("7 relocalization")

    # -- 8. loop closing -----------------------------------------------------
    loop_entries = loop_phase(knn, card, slam)
    mark("8 loop closing")

    # -- 9. the mdBRIEF system -------------------------------------------------
    md_entries = mdbrief_phase(dev, knn, card, frames, gt)
    mark("9 mdBRIEF system")

    # -- 10. the organic loop closure ------------------------------------------
    organic_entries = organic_phase(dev, knn, card)
    mark("10 organic loop")

    # -- 11. async mapping, the chunked path, reset in flight, the CLI ---------
    async_entries = async_phase(dev, knn, card, frames, gt, sys_ref)
    mark("11 async, chunked, CLI")

    # -- 12. the stretch configuration, self-calibration, a dynamic scene -----
    ring_slam, ring, ring_entries = ring_phase(dev, knn, card)
    mark("12a eight-camera ring")
    selfcal_phase(dev, card, ring_slam, ring)
    mark("12b self-calibrating BA")
    dyn_entries = dynamic_phase(dev, knn, card)
    mark("12c dynamic scene")

    # -- 13. the two-room tour, the sharded global BA ----------------------------
    t13 = time.perf_counter()
    room_slam, room_entries = two_room_phase(dev, knn, card)
    mark("13a two-room tour")
    for name, system in (("two-room map", room_slam), ("phase 6's map", slam)):
        sharded_map_ba(dev, card, name, system)
    mark("13b sharded BA on maps")
    map_scale_ba(dev, card)
    mark("13c map-scale BA")
    print(f"phase 13 wall s {time.perf_counter() - t13:.3f} ({card})")

    print(f"wall s by phase {phase_s}, whole script {time.perf_counter() - t_script:.3f} "
          f"({card})")
    print(json.dumps({"kernels": wf_entries + sys_entries + reloc_entries + loop_entries
                      + md_entries + organic_entries + async_entries + ring_entries
                      + dyn_entries + room_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--organic-worker":
        organic_worker(int(sys.argv[2]), sys.argv[3])
    else:
        main()
