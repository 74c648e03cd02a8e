#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multicol_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the Hamming-NN kernel, the small eigensolvers, the pose LM
     and the two extraction kernels (fast_detect.cu, orb_describe.cu) from
     multicol_slam_tpu_torch/csrc with nvcc, one process a source, started
     together, timed;
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
     window-gated entry twice per frame, the dense-gate entry never, the
     pose LM kernel (csrc/pose_lm.cu) once at each of its two sites a
     frame (PoseSpy), and the extraction kernels (kernels/extract.py:
     detection's two launches and the descriptor's one) each frame;
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
     keyframe with it, then twice through the system's own loop closer
     (SearchAndFuse on); the 14-keyframe out-and-back chain; global
     bundle adjustment taking 3 cm of point noise at least halfway back.
     The map is restored after each step. The loop closers' four units
     (OptimizeSim3, the essential graph, fuse_candidates, the post-loop
     global BA) are CUDA graphs, the system's in the mapper's pool;
     MultiColSLAM.global_bundle_adjustment graphs in the shared pool;
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
 14. the compiled main path. On the card the tracker runs its WORKING
     frame (working_track_step) and the chunk scan's body
     (working_scan_body) as CUDA graphs (utils/graphs.py): one capture
     per set of static arguments and input shapes, one replay a frame;
     phases 6, 9, 10, 11 (a)-(b), 12 and 13 (a) run so, each to its bars
     (11 (a) counts the captures made while a mapping pass ran). (a)
     phase 4's 16 frames at the default SlamSettings through
     MultiColSLAM's extractor and match parameters, the slots rolled
     eagerly frame by frame: the graphed and the eager working_track_step
     on identical inputs, all 14 outputs identical (integers and flags
     equal, floats with max |diff| 0), entry A launched twice a frame
     inside the graph; then 3 frames at phase 9's mdBRIEF settings, every
     launch masked; (b) torch.profiler and the host clock over 8 of those
     frames, eager against graphed: device operations and device ms a
     frame, busy share, ms a frame (median, p90; in turns eager, graphed,
     graphed, eager); then the eager step's device us and operations by
     stage (extraction, motion matching, the motion pose LM, the frustum
     check, local-map matching, the local-map pose LM; record_function
     ranges, stage_device) over 4 frames with the pose LM kernel and with
     its plain version (the parent's path: Part 0), and with the plain
     extraction chain in place of the extraction kernels, and the graphed
     step with each; the extraction alone by sub-stage (the pyramid, per
     level FAST with the fallback and suppression, Harris and the
     selection, the patches, the descriptor, the rays; or the two kernels
     and the sort and gathers; extraction_split), the kernels' path
     against the plain chain; the step and its two pose LM calls are
     each captured into
     a CUDA graph of their own, whose kernel, copy and fill nodes count
     its device operations exactly: the step's must fall by at least the
     plain pose LM calls' less eight, at most four a kernel call; (c) every chunk of phase 11 (b)'s track_batch run
     again through the eager scan body on copies of its inputs:
     identical. After each system phase the script prints the graphs
     held, the captures (function, local-map bucket, seconds), their
     seconds in all, the replays and the pool's MiB. (c) also splits one
     steady chunk's ms: working_scan_chunk with the graphed body against the
     body's graph replayed alone (the rest: input copies, output clones,
     the Python loop, the stack).
 15. local mapping compiled: on the card LocalMapper runs its four units
     (triangulation_batch, cross_camera_batch, fuse_targets_batch, the
     local bundle_adjustment) as CUDA graphs in a pool of its own, on the
     mapper's thread and stream under async mapping. Phases 6 and 11 (a)
     record the first calls of each unit; each runs again eagerly and
     through its graph (a replay) on copies of its inputs: the recorded
     output, the replay and the eager run identical, the BA included (its
     block sums are ordered); entry B (triangulation, cross-camera) and
     entry A (fuse) counted at each replay and equal to their plain
     versions; each unit's ms eager against graphed, every graphed
     function's captures and replays, the pools' MiB. (b) the bench's
     headline (multicol_slam_tpu_torch.bench.production_tracker) at a
     small size. Phase 11 (b) prints the chunk scan's ms a frame (its
     scan and fetch, apart from the walk's keyframe passes), steady chunks
     apart from those that captured, beside phase 6's WORKING median.
 16. loop closing compiled: on the card LoopCloser runs OptimizeSim3,
     the essential graph, fuse_candidates (guided SearchBySim3 and the
     neighbourhood support, entry A inside the graph) and the post-loop
     global BA as CUDA graphs, the system's in the mapper's pool and its
     BA the mapper's BA graph; a later key of a graphed function captures
     with no warm-up and returns one replay's outputs. Phases 8, 10 (seed
     42, and every worker on its own run) and 16 record each unit's first
     calls (LoopUnits); (a) each runs
     again eagerly and through its graph (a replay) on copies of its
     inputs: the recorded output (a warm-up's, a replay's or a later
     key's first call's), the replay and the eager run identical in every
     output; entry A at guided_sim3 and support counted at each replay and
     equal to its plain version; (b) ms a call, graphed and eager, first
     call and replays: ComputeSim3, CorrectLoop, the essential graph, the
     global BA (the system's, and the closer's post-loop BA at
     GBA_ITERS, its map-size key captured with no warm-up), beside the
     bars first ComputeSim3 <= 2 s, later <= 0.5 s, the essential graph
     <= 0.5 s (printed, not held); (c) phase 11 (a)'s slowest pass after
     the first split into warm-up, capture, waiting for another thread's
     capture, the interpreter lock and the rest, and the card's idle
     share over that run (nvidia-smi's utilization.gpu every 100 ms).
     Phase 10 prints each loop unit's captures and replays over its runs.
 17. the tracker's units off the fused path compiled: on the card the
     tracker runs the standalone extraction, motion_track_step,
     extract_motion_track_step, window_search, pose_optimization,
     local_map_track_step, the relocalization's projection round,
     initialize_device and ransac_gpnp (drawing from the tracker's
     generator, registered with their graphs) and the frame's BoW
     transform as CUDA graphs of the shared pool, the capture-ahead after
     the bootstrap capturing the relocalization's keys. Phases 6, 7 and 9
     record each unit's first calls (TrackerUnits); (a) each runs again
     eagerly and through its graph on copies of its inputs, the
     generator's state restored: every output identical and the
     generator's state after each the same; (b) the small eigensolvers'
     kernel (csrc/small_eig.cu: sym_eig, svd3) at each call site of phases
     6-7 (the 8-point refit, the decomposition, the DLT, Horn's alignment
     in GP3P) and of phase 8 (Horn's alignment in the loop closer's Sim3
     RANSAC) against torch.linalg to its bars, launched at every site,
     timed beside torch.linalg, its bound and the launch floor (an empty
     kernel, tools/empty_kernel.cu, built with the others in phase 2),
     with the registers and local bytes of each kernel instance, none in
     float32; (c) the frames by path and
     the relocalization against the eager tree's (printed), each unit's ms
     eager and graphed, captures and replays by unit and phase, what the
     capture-ahead took and what captured after it; GP3P and the pose LM
     capture nothing on phase 7's relocalized frames.
 18. the pose LM kernel (csrc/pose_lm.cu: both LM rounds, the gate and
     the final count in one launch of a thread-block cluster, each round
     stopping on the device) at
     every call of phases 6-9: PoseSpy counts its launches by site
     (motion, local_map, reloc_local_map, previous_frame, reloc,
     reloc_second_chance, capture_ahead) and PoseUnits keeps the inputs
     of every unit call that reaches it; each is run again eagerly and
     every pose LM call it makes is held to the plain version in float32
     (pose within 1e-4, flipped inliers only with chi2 within 1e-3 of
     huber^2; the iterations, over all calls, within the most the plain
     version's or the kernel's move when the same rows run in four other
     orders, or 2; costs printed) and, on the same rows in
     float64, exactly (masks, counts and iterations equal, pose within
     1e-10); the worst case per site is printed. Each site's first call
     (and phase 4's two sites) is timed: device us a launch by CUDA-graph
     replay beside the launch floor (an empty cluster of the kernel's
     shape, tools/empty_kernel.cu), its bound (about 520 operations a row
     a pass), the plain version's device us and device operations a call;
     each instance's cluster size, CTA width, registers and local bytes
     are printed.
 19. the extraction kernels (kernels/extract.py: csrc/fast_detect.cu,
     FAST/AGAST as a bit-mask segment test with the minima where it
     passes, the fallback, suppression, Harris over compacted survivors
     and the bucket maxima in two launches; csrc/orb_describe.cu, two
     warps a keypoint: the window, IC angle, ORB bits from the blur at the
     sampled points) at every extractor configuration that phases 4-12 (a)
     ran (ExtractSpy: the tracking and init extractors at the default,
     mdBRIEF, organic and eight-camera settings), on its first recorded
     frame: the kernels' features against the plain chain's on the card
     (keypoints, levels, responses, validity, rays, angles at every level,
     descriptor and mask bits identical, each level's bucket maxima and
     indices identical), each kernel's device us by CUDA-graph replay
     beside the launch floor (PR 17's time in the text), its bound from
     this input with PR 17's count beside it, and the plain version's us, the whole
     extraction both ways in device us and operations, launches over
     phases 4-12 (a) on the card (held to the wrappers' own counts),
     registers, local bytes and the descriptor's CTAs an SM; no single
     PyTorch call computes either.
     Their bound takes operations over 33.5 T float32 instructions a
     second: built with --fmad=false, they issue no FMA.

Each of phases 6, 7, 8, 9, 10, 11 (a) and (b), 12 (a) and (c), 13 (a)
and 14 (a) sets the launch counts to 0 just before it drives its path and
reads them just after. A launch inside a graph is counted at every replay
(the wrappers and SiteSpy count through graphs.on_launch); a graphed
site's inputs, held against the plain version, are those of the graph's
warm-up, the eager run that precedes its capture. For each call site (phases 4, 6-13) the script times, on the
card: the entry's device time per launch (CUDA-graph replay, so no host
enqueue in it), one call between two events as earlier versions timed
(host enqueue included), the plain version, and at the window-gated sites the path the
site ran before the in-kernel gate (the torch gate build plus the
dense-gate entry). It computes each site's bound from the inputs (bytes
over 3.35 TB/s, float operations over 67 TFLOP/s, popcounts over 16 per
clock per SM at 1.98 GHz on 132 SMs) and its gate density. Phases 7 and 8
also print the time of a relocalization, of the ComputeSim3 stage (its
first, cold call and the warm ones, each split into its host stages: the
Sim3 RANSAC's draws, Horn and scoring, the OptimizeSim3 graph's calls,
the guided and support rounds), of CorrectLoop, of the essential-graph
optimization, of the written-out Jacobians eagerly apart, and of the
vocabulary transform.

Prints the wall seconds of every phase and of the whole script, the card
line, a JSON line of the kernels (one entry per call site), and last
{"ok": true, "device": {...}}. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
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
         "_count_neighborhood_support": "support", "reloc_projection_round": "reloc_projection",
         "capture_ahead": "window_search"}
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
GRAPH_MD_FRAMES = 3    # phase 14 (a): frames at phase 9's mdBRIEF settings
PROFILE_FRAMES = 8     # phase 14 (b): frames profiled, eager and graphed
STAGE_FRAMES = 4       # phase 14 (b): frames profiled by stage, each pose LM variant
STAGE = "stage:"       # the prefix of a record_function range that names a stage
# phase 14 (b): the WORKING step's stages (ROADMAP section 2 item 1 (a));
# the pose LM's two calls are named by the function that makes them
WORKING_STAGES = ("extraction", "motion_matching", "pose_lm_motion", "frustum",
                  "local_map_matching", "pose_lm_local_map")
POSE_LM_CALLERS = {"_motion_track_core": "pose_lm_motion",
                   "_local_map_core": "pose_lm_local_map"}
CHUNK = 8              # frames a chunk of track_batch
# phase 15: LocalMapper's graphed units, the copies kept of each one's calls
# in each recorded phase, and the bench's headline at a small size
MAPPING_UNITS = ("_triangulate", "_cross_camera", "_fuse", "_bundle_adjust")
UNIT_SITE = {"_triangulate": "triangulation", "_cross_camera": "cross_camera",
             "_fuse": "fuse", "_bundle_adjust": None}
UNIT_RECORDS_PER_PHASE = 4
UNIT_RECORDS: list = []
HEADLINE_SMALL = dict(n_build=40, snap_at=24, n_scan=4, n_reps=1)
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
# the stages of a ComputeSim3 call timed apart (phase 8): the eager Sim3
# RANSAC (draws, Horn, scoring), then the graphed units' calls
# (optimize_sim3; guided and support each project landmarks through S12
# and call the fuse_candidates graph)
SIM3_STAGES = ("draws", "horn", "score", "optimize_sim3", "guided", "support")
# phase 16: the loop closer's graphed units, and the copies kept of each
# one's calls in each recorded phase (8, and 10's seed 42)
LOOP_UNITS = ("optimize_sim3", "optimize_essential_graph", "fuse_candidates",
              "bundle_adjustment")
LOOP_RECORDS_PER_PHASE = 3
# the call sites of the fuse_candidates graph: one graph serves both, so
# a replay is named by its caller
PROJECTED_SITES = ("guided_sim3", "support")
# phase 17: the tracker's graphed units, the copies kept of each one's
# calls in each recorded phase (6, 7 and 9), and each phase's counts
TRACKER_UNITS = ("_extract_unit", "_extract_init_unit", "_motion_step",
                 "_extract_motion_step", "_window_search", "_pose_opt", "_local_map_step",
                 "_reloc_projection", "_init_device", "_gpnp", "bow_transform")
TRACKER_RECORDS_PER_PHASE = 3
TRACKER_RECORDS: list = []
TRACKER_PHASES: dict = {}     # phase -> its TrackerUnits (calls and captures by unit)
PATH_MS: dict = {}            # phase 6's (frame path, ms) and phase 7's _relocalize ms
# the medians (ms) of the tree before the tracker's units were graphed, on
# an NVIDIA H100 80GB HBM3 at 700.00 W: two runs of tools/path_study.py
# (PERF.md section 6)
PARENT_MS = {"init": (315.976, 268.087), "velocity": (416.538, 317.372),
             "reloc_recent": (410.201, 315.827), "_relocalize": (228.029, 169.060),
             "fused": (52.246, 51.885)}
# the small eigensolvers' call sites (the function that names each), the
# JAX package's XLA calls they stand for (no Pallas kernel), their bars
EIG_SITES = {"essential_8pt": "eight_point", "decompose_essential": "decompose",
             "_dlt_pose": "dlt", "horn_alignment": "horn"}
# a caller that renames its callees' site: the loop closer's Sim3 RANSAC
# (Horn on 256 x 3 pairs, eager; recorded in phase 8)
EIG_CONTEXT = {"_compute_sim3": "sim3_ransac"}
EIG_PATH_SITES = ("sym_eig@eight_point", "sym_eig@horn", "svd3@eight_point",
                  "svd3@decompose", "svd3@dlt")
EIG_LOOP_SITES = ("sym_eig@sim3_ransac",)       # phase 8's
EMPTY_SOURCE = "tools/empty_kernel.cu"         # the launch floor's yardstick
EMPTY: dict = {}                               # its library, built in phase 2
EIG_SOURCE = "multicol_slam_tpu_torch/csrc/small_eig.cu"
EIG_REPLACES = {"sym_eig@eight_point": "multicol_slam_tpu/ops/ransac.py:56",
                "sym_eig@horn": "multicol_slam_tpu/ops/sim3.py:169",
                "svd3@eight_point": "multicol_slam_tpu/ops/ransac.py:59",
                "svd3@decompose": "multicol_slam_tpu/ops/ransac.py:135",
                "svd3@dlt": "multicol_slam_tpu/ops/ransac.py:310",
                "sym_eig@sim3_ransac": "multicol_slam_tpu/ops/sim3.py:169"}
EIG_VAL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
EIG_VEC_TOL = 1e-4
EIG_GAP = 1e-3
F64_OPS_S = 34e12              # H100 SXM float64 outside the tensor cores
# the pose LM kernel (csrc/pose_lm.cu): the JAX package's compiled unit it
# stands for (no Pallas kernel), its call sites (the function that calls
# pose_optimization; the tracker's _pose_opt unit is named by its caller at
# the call: PoseSpy.site), its bars against the plain version, its work
POSE_SOURCE = "multicol_slam_tpu_torch/csrc/pose_lm.cu"
POSE_REPLACES = "multicol_slam_tpu/models/optimizer.py:82"
POSE_BASE = {"_motion_track_core": "motion", "_local_map_core": "local_map"}
# the tracker's units that run pose_optimization, by their function's name
POSE_UNIT_FNS = ("working_track_step", "working_scan_body", "_motion_track_core",
                 "extract_motion_track_step", "_local_map_core", "pose_optimization")
POSE_F64_POSE = 1e-10          # float64: pose; masks, counts, iterations equal
POSE_F32_POSE = 1e-4           # float32: pose
# a final robust cost under this (px^2) is an exact fit: there a step's gain
# is rounding noise in float64 too, and the iterations are not held
POSE_EXACT_COST = 1e-12
POSE_F32_BAND = 1e-3           # float32: a flipped row's chi2 within this of huber^2
# float32: the row orders, besides the recorded one, that measure how far
# the iterations move when the same terms are summed in another order
# (reversed, then seeded permutations); the kernel's iterations against the
# plain version's are held within the largest such move, or 2
POSE_ORDERS = 4
POSE_F32_ITERS = 2
POSE_PASS_OPS = 520            # floating-point operations a row a pass (csrc/pose_lm.cu)
POSE_RECORDS: list = []        # phases 6-9: every call of a unit that runs the pose LM
# phase 19: the extraction kernels (kernels/extract.py), the JAX package's
# jnp chains they stand for (no Pallas kernel: XLA fuses them), and the
# work the bounds count, the least the exact method needs (detect_work
# says where): the segment test as bit masks (bit_test_ops: n
# differences, a compare and a mask OR a polarity and ring pixel, each
# polarity's run test by shift-and-AND doubling) at each pixel whose score
# suppression reads and, at th_hi, at the cells' other pixels that must
# be tested; FAST_PIXEL_OPS (the score's and thresholds' compares, the
# cell's flag, the suppression, the mask and border, the bucket's
# compare) inside mask and border; at each needed pixel and polarity
# whose mask passes at th_lo the arc minima and their maximum
# (arc_min_ops + n - 1); Harris at a survivor (49 x (two differences, two halvings, three products, three
# sums), the row sums, the response and + 1e-6); the descriptor's a
# keypoint: the moments (MOMENT_OPS: a product, a widening and a float64
# sum a term and moment), atan2, cos and sin (ANGLE_OPS), and either the
# blur at each sampled point (BLUR_POINT_OPS: 25 sums, 5 more, the scale
# and the rounding) with an ORB test a pair (ORB_TEST_OPS: two rotated
# points, each four products, two sums, two roundings and four clamps,
# then the compare) or the whole blurred patch (BLUR_PATCH_OPS). Built
# with --fmad=false, each is one instruction, so the bound divides by
# F32_INSTR_S. PR 17's counts (the ring's 16 differences and both
# polarities' minima at every pixel, the whole blur on the ORB path, the
# moments in float32) are printed beside them.
DETECT_SOURCE = "multicol_slam_tpu_torch/csrc/fast_detect.cu"
DESCRIBE_SOURCE = "multicol_slam_tpu_torch/csrc/orb_describe.cu"
DETECT_REPLACES = "multicol_slam_tpu/ops/fast.py:150"
DESCRIBE_REPLACES = "multicol_slam_tpu/ops/brief.py:69"
EXTRACT_NOTE = ("no Pallas kernel: the JAX package's jnp chain, which XLA fuses "
                "(multicol_slam_tpu/models/extractor.py:140-212)")
FAST_PIXEL_OPS = 22
HARRIS_OPS = 49 * 10 + 21 + 9
MOMENT_OPS = 6 * 961
ANGLE_OPS = 60
BLUR_POINT_OPS = 32
BLUR_PATCH_OPS = 53 * 49 * 5 + 49 * 49 * 7
ORB_TEST_OPS = 25
DESCRIBE_KP_OPS_EARLIER = 4 * 961 + BLUR_PATCH_OPS + ANGLE_OPS
# PR 17's kernels' device us a call, detection and the descriptor, by
# (ring, descriptor, features, levels, cameras): PERF.md section 6's
# "Earlier (PR 17)" column (H100 80GB HBM3, 700.00 W), printed in phase
# 19's text beside this run's times and not measured here
EXTRACT_EARLIER_US = {
    ("fast_9_16", "orb", 400, 8, 3): (203.54, 20.98),
    ("fast_9_16", "orb", 800, 8, 3): (219.00, 35.48),
    ("agast_7_12", "mdbrief", 400, 8, 3): (183.23, 21.24),
    ("agast_7_12", "mdbrief", 800, 8, 3): (198.98, 36.47),
    ("fast_9_16", "orb", 300, 4, 3): (155.34, 14.69),
    ("fast_9_16", "orb", 600, 4, 3): (171.99, 26.96),
    ("agast_7_12", "mdbrief", 400, 8, 8): (437.16, 51.46),
    ("agast_7_12", "mdbrief", 800, 8, 8): (500.23, 88.96),
}
ENTRY = {"radius": "hamming_nn_radius", "dense": "hamming_nn"}
SOURCE = "multicol_slam_tpu_torch/csrc/hamming_nn.cu"
REPLACES = "multicol_slam_tpu/ops/pallas/hamming_nn.py:146"
REPLACES_MASKED = "multicol_slam_tpu/ops/pallas/hamming_nn.py:206"
LIBRARY = ("none: torch has no popcount, and no call reduces to a gated best, "
           "second-best and argmin")
HBM_BYTES_S = 3.35e12          # H100 SXM device memory
F32_OPS_S = 67e12              # H100 SXM float32 outside the tensor cores
F32_INSTR_S = F32_OPS_S / 2    # the same in instructions: 67e12 counts an FMA as two
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
    come from two threads at once.

    A launch inside a CUDA-graph capture (utils/graphs.py) is counted
    through graphs.on_launch, as the wrappers count theirs: at every
    replay of the graph, with the stream the replay runs on, by the spy
    active at the replay (a graph a phase captured replays in later
    phases on the same system). The function that names the site is
    fixed at the capture; what the site's name takes from its caller
    (the chunk scan, CorrectLoop, the mapper's thread) is read at the
    replay, since one graph serves every caller of its unit. Its inputs
    are not kept (at capture they hold no values yet): a site's first
    inputs come from the graph's warm-up, the eager run that precedes
    each capture (on the tracker's thread for a mapper's unit first
    called by a bootstrap pass); a later key captured with no warm-up
    keeps its inputs from the graph's first replay."""

    active = None
    first_args: dict = {}      # site -> its first inputs, over every spy
    forced = None              # a site named by the caller (phase 16's reruns)
    # base site -> inputs held at a capture with no warm-up (a later key):
    # their values exist after the graph's first replay, which copies them
    pending: dict = {}

    def __init__(self, knn, matcher):
        self.knn, self.matcher = knn, matcher
        self.launches, self.masked, self.args = Counter(), Counter(), {}
        self.streams = {}
        self.lock = threading.Lock()

    def _call(self, kind, args):
        from multicol_slam_tpu_torch.utils import graphs

        base = SiteSpy.forced or call_site(context=False)
        with self.lock:
            if base == "init" and self.launches["init"] > self.launches["init_mutual"]:
                base = "init_mutual"           # the swapped second launch
            if not graphs.capturing():
                self.args.setdefault(site_in_context(base), (kind, args))
                SiteSpy.first_args.setdefault(site_in_context(base), (kind, args))
            else:
                SiteSpy.pending.setdefault(base, (kind, args))
        masked = len(args) > (10 if kind == "radius" else 3)
        graphs.on_launch(lambda: SiteSpy.active and SiteSpy.active._count(base, masked))
        return getattr(self.knn, ENTRY[kind])(*args)

    def _count(self, base, masked):
        if SiteSpy.forced:
            base = SiteSpy.forced
        elif base in PROJECTED_SITES:
            # the fuse_candidates graph replayed under either caller
            base = next((SITES[n] for n in _stack_names() if SITES.get(n) in PROJECTED_SITES),
                        base)
        site = site_in_context(base)
        with self.lock:
            if site not in self.args and base in SiteSpy.pending:
                kind, args = SiteSpy.pending.pop(base)
                rec = (kind, clone_tree(args))       # after the replay, on its stream
                self.args[site] = rec
                SiteSpy.first_args.setdefault(site, rec)
            self.launches[site] += 1
            self.masked[site] += masked
            self.streams.setdefault(site, set()).add(
                torch.cuda.current_stream().cuda_stream if torch.cuda.is_available() else None)

    def __enter__(self):
        self.matcher.hamming_nn = lambda *a: self._call("dense", a)
        self.matcher.hamming_nn_radius = lambda *a: self._call("radius", a)
        SiteSpy.active = self
        return self

    def __exit__(self, *exc):
        SiteSpy.active = None
        self.matcher.hamming_nn = self.knn.hamming_nn
        self.matcher.hamming_nn_radius = self.knn.hamming_nn_radius


class UnitRecorder:
    """Stands in for one of LocalMapper's graphed units (phase 15): calls
    it, and keeps copies of the inputs and outputs of the first
    UNIT_RECORDS_PER_PHASE calls of ``phase``, whether the call replayed
    a graph, and the thread that made it."""

    def __init__(self, unit, name, phase):
        self.unit, self.name, self.phase = unit, name, phase

    def __call__(self, *a, **k):
        replays = self.unit.replays
        out = self.unit(*a, **k)
        if sum(r["unit"] == self.name and r["phase"] == self.phase
               for r in UNIT_RECORDS) < UNIT_RECORDS_PER_PHASE:
            torch.cuda.current_stream().synchronize()
            UNIT_RECORDS.append(dict(
                unit=self.name, unit_obj=self.unit, phase=self.phase,
                inputs=clone_tree((a, k)),
                out=clone_tree(out), replayed=self.unit.replays > replays,
                thread=threading.current_thread().name))
            torch.cuda.current_stream().synchronize()
        return out


def record_units(slam, phase):
    """Put a UnitRecorder before each graphed unit of the system's mapper."""
    from multicol_slam_tpu_torch.utils import graphs
    for name in MAPPING_UNITS:
        unit = getattr(slam.mapper, name)
        if not isinstance(unit, graphs.jit):
            fail(f"{phase}: the mapper's {name} is {unit!r}, not a CUDA graph on the card")
        setattr(slam.mapper, name, UnitRecorder(unit, name, phase))


LOOP_RECORDS: list = []
ASYNC_SPLIT: dict = {}       # phase 11 (a)'s pass split and idle share, for phase 16


class LoopUnits:
    """While entered, stands before every loop closer's graphed units
    (``LoopCloser.unit``; phases 8, 10 and 16): each call is timed (host
    ms ended by a sync of this thread's stream) by unit, and of the first
    LOOP_RECORDS_PER_PHASE calls of each unit in ``phase`` copies of the
    inputs and outputs are kept, with whether the call captured or
    replayed and, for fuse_candidates, its caller's site. A unit the phase
    replaced (the neutralized essential graph) is left alone."""

    def __init__(self, phase):
        self.phase = phase
        self.ms = {u: [] for u in LOOP_UNITS}

    def __enter__(self):
        from multicol_slam_tpu_torch.models import loop_closing as lcm
        from multicol_slam_tpu_torch.utils import graphs

        self.owner, self.orig = lcm.LoopCloser, lcm.LoopCloser.unit

        def unit(closer, name, _orig=self.orig):
            g = _orig(closer, name)
            inner = getattr(g, "unit", g)     # a UnitRecorder before the mapper's BA graph
            return self._wrap(g, inner, name) if isinstance(inner, graphs.jit) else g

        self.owner.unit = unit
        return self

    def __exit__(self, *exc):
        self.owner.unit = self.orig

    def _wrap(self, unit, g, name):
        def call(*a, **k):
            replays, captures = g.replays, g.captures
            warm = not g._warmed           # a first key on the device runs a warm-up
            site = (next((SITES[n] for n in _stack_names() if SITES.get(n) in PROJECTED_SITES),
                         None) if name == "fuse_candidates" else None)
            out, ms = timed(lambda: unit(*a, **k))
            self.ms[name].append(ms)
            if sum(r["unit"] == name and r["phase"] == self.phase
                   for r in LOOP_RECORDS) < LOOP_RECORDS_PER_PHASE:
                LOOP_RECORDS.append(dict(
                    unit=name, unit_obj=g, phase=self.phase, site=site,
                    inputs=clone_tree((a, k)), out=clone_tree(out), ms=ms,
                    replayed=g.replays > replays, captured=g.captures > captures,
                    warm_up=g.captures > captures and warm))
                torch.cuda.current_stream().synchronize()
            return out
        return call


class TrackerUnits:
    """While entered, stands before a system's graphed tracker units
    (TRACKER_UNITS; ``graphs.jit.__call__`` patched at the class, so the
    tracker still holds its graphs): counts each unit's calls and the
    captures they made, and keeps copies of the first
    TRACKER_RECORDS_PER_PHASE calls of each unit in ``phase``: inputs, the
    generator's state before and after (the RANSAC units), outputs, and
    whether the call replayed or captured. Calls from other threads pass
    through."""

    def __init__(self, slam, phase):
        from multicol_slam_tpu_torch.utils import graphs

        self.phase = phase
        self.names = {}
        for name in TRACKER_UNITS:
            unit = getattr(slam.tracker, name)
            if not isinstance(unit, graphs.jit):
                fail(f"{phase}: the tracker's {name} is {unit!r}, not a CUDA graph on the card")
            self.names[id(unit)] = name
        self.calls, self.captures = Counter(), Counter()
        self.thread = threading.current_thread()
        TRACKER_PHASES[phase] = self

    def __enter__(self):
        from multicol_slam_tpu_torch.utils import graphs

        self.orig = orig = graphs.jit.__call__

        def call(g, *a, **k):
            name = self.names.get(id(g))
            if name is None or threading.current_thread() is not self.thread:
                return orig(g, *a, **k)
            self.calls[name] += 1
            captures, replays = g.captures, g.replays
            keep = sum(r["unit"] == name and r["phase"] == self.phase
                       for r in TRACKER_RECORDS) < TRACKER_RECORDS_PER_PHASE
            gen = next((x for x in a if isinstance(x, torch.Generator)), None)
            if keep:
                torch.cuda.current_stream().synchronize()
                state = None if gen is None else gen.get_state()
                inputs = clone_tree((a, k))
            out = orig(g, *a, **k)
            self.captures[name] += g.captures - captures
            if keep:
                torch.cuda.current_stream().synchronize()
                TRACKER_RECORDS.append(dict(
                    unit=name, unit_obj=g, phase=self.phase, inputs=inputs, state=state,
                    state_after=None if gen is None else gen.get_state(),
                    out=clone_tree(out), replayed=g.replays > replays,
                    captured=g.captures > captures))
            return out

        graphs.jit.__call__ = call
        return self

    def __exit__(self, *exc):
        from multicol_slam_tpu_torch.utils import graphs
        graphs.jit.__call__ = self.orig


class EigSpy:
    """While entered, stands before the small eigensolvers where the RANSAC
    solvers call them (``ops/ransac.py``'s ``sym_eig`` and ``svd3``,
    ``ops/sim3.py``'s ``sym_eig``): names each call's site by its caller
    (EIG_SITES), keeps each site's first input (outside a capture: a
    graph's warm-up) and counts its launches through graphs.on_launch, so
    at every replay of a graph that holds it, while a spy is active."""

    active = None

    def __init__(self):
        self.launches, self.args = Counter(), {}
        self.lock = threading.Lock()

    def _wrap(self, entry, fn):
        def call(A, *rest):
            from multicol_slam_tpu_torch.utils import graphs

            names = _stack_names()
            site = entry + "@" + next((EIG_CONTEXT[n] for n in names if n in EIG_CONTEXT),
                                      next((EIG_SITES[n] for n in names if n in EIG_SITES),
                                           "other"))
            if not graphs.capturing():
                self.args.setdefault(site, A.clone())
            graphs.on_launch(lambda: EigSpy.active is not None and EigSpy.active._count(site))
            return fn(A, *rest)
        return call

    def _count(self, site):
        with self.lock:
            self.launches[site] += 1

    def __enter__(self):
        from multicol_slam_tpu_torch.ops import ransac, sim3

        self.saved = [(ransac, "sym_eig"), (ransac, "svd3"), (sim3, "sym_eig")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        EigSpy.active = self
        return self

    def __exit__(self, *exc):
        EigSpy.active = None
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class ExtractSpy:
    """While entered, every extractor that ``make_extractor`` builds (the
    systems' through ``system.make_extractor``, this script's through
    ``extractor.make_extractor``) keeps its arguments and the first images
    it extracts on the card at each configuration and camera count
    (outside a capture), and counts that configuration's calls on the card
    through graphs.on_launch, so at every replay of a graph that holds it,
    until the spy exits. Each such call launches detection twice and the
    descriptor once: ``mark`` (where the wrappers' counts are set to 0) and
    ``__exit__`` hold the calls counted in between to the wrappers' own
    counts, so ``launches`` gives each configuration's launches."""

    def __init__(self):
        self.first = {}            # (cfg, C) -> (cfg, cams, masks, hw, extract, images)
        self.calls = Counter()
        self.marked = Counter()
        self.open = True
        self.lock = threading.Lock()

    def _count(self, key):
        with self.lock:
            if self.open:
                self.calls[key] += 1

    def launches(self, key) -> tuple:
        """(detection, descriptor) launches of a configuration."""
        return 2 * self.calls[key], self.calls[key]

    def mark(self):
        """The wrappers' counts were set to 0 here."""
        with self.lock:
            self.marked = Counter(self.calls)

    def __enter__(self):
        from multicol_slam_tpu_torch.models import extractor, system
        from multicol_slam_tpu_torch.utils import graphs

        real = self.real = extractor.make_extractor
        spy = self

        def make_extractor(cfg, cams, masks, hw):
            ex = real(cfg, cams, masks, hw)

            def extract(images):
                key = (cfg, images.shape[0])
                if images.is_cuda:
                    if not graphs.capturing():
                        with spy.lock:
                            if key not in spy.first:
                                spy.first[key] = (cfg, cams, masks, hw, ex, images.clone())
                    graphs.on_launch(lambda: spy._count(key))
                return ex(images)
            extract.plain = ex.plain
            return extract

        extractor.make_extractor = system.make_extractor = make_extractor
        return self

    def __exit__(self, *exc):
        from multicol_slam_tpu_torch.kernels import extract as extract_k
        from multicol_slam_tpu_torch.models import extractor, system

        extractor.make_extractor = system.make_extractor = self.real
        torch.cuda.synchronize()
        with self.lock:
            self.open = False
            calls = sum((self.calls - self.marked).values())
        counted = (extract_k.detect.launches, extract_k.describe.launches)
        if exc[0] is None and counted != (2 * calls, calls):
            fail(f"the extractors' {calls} calls on the card since phase 4's count was set "
                 f"to 0 do not account for the wrappers' launches {counted}")


class PoseSpy:
    """While entered, stands before ``optimizer.pose_optimization`` (the
    kernel on the card): names each call's site (``site``), keeps each
    site's first inputs (outside a capture), with ``keep_all`` every
    call's, and counts its launches through graphs.on_launch, so at every
    replay of a graph that holds it, by the spy active at the replay. The
    tracker's relocalization is watched so that the second-chance round's
    pose LM is told from the first (``second``). ``context`` adds a
    recorded call's stack when a unit's call is run again (phase 18)."""

    active = None
    real = None                    # optimizer.pose_optimization, unpatched

    def __init__(self, keep_all=False):
        self.launches, self.first, self.calls = Counter(), {}, []
        self.keep_all = keep_all
        self.lock = threading.Lock()
        self.second = False
        self.context = ()

    def site(self, base, names):
        if base == "pose_opt":
            if "capture_ahead" in names:
                return "capture_ahead"
            if "_relocalize" in names:
                return "reloc_second_chance" if self.second else "reloc"
            if "_track_previous_frame" in names:
                return "previous_frame"
            return base
        if "working_scan_chunk" in names:
            return "chunk_" + base
        return ("reloc_" + base) if "_relocalize" in names else base

    def _count(self, base):
        site = self.site(base, _stack_names())
        with self.lock:
            self.launches[site] += 1

    def __enter__(self):
        from multicol_slam_tpu_torch.models import optimizer, tracking
        from multicol_slam_tpu_torch.utils import graphs

        if PoseSpy.real is None:
            PoseSpy.real = optimizer.pose_optimization
        real = PoseSpy.real

        def pose_optimization(*a, **k):
            base = POSE_BASE.get(sys._getframe(1).f_code.co_name, "pose_opt")
            spy = PoseSpy.active
            if spy is not None and not graphs.capturing():
                site = spy.site(base, _stack_names() + list(spy.context))
                rec = clone_tree((a, k))
                with spy.lock:
                    spy.first.setdefault(site, rec)
                    if spy.keep_all:
                        spy.calls.append((site, rec))
            graphs.on_launch(lambda: PoseSpy.active is not None and PoseSpy.active._count(base))
            return real(*a, **k)

        T = tracking.Tracker
        self.saved = (optimizer.pose_optimization, T._relocalize, T._reloc_project_candidate)
        reloc, project = self.saved[1:]

        def relocalize(tr):
            self.second = False
            try:
                return reloc(tr)
            finally:
                self.second = False

        def reloc_project(tr, kf):
            self.second = True
            return project(tr, kf)

        optimizer.pose_optimization = pose_optimization
        T._relocalize, T._reloc_project_candidate = relocalize, reloc_project
        PoseSpy.active = self
        return self

    def __exit__(self, *exc):
        from multicol_slam_tpu_torch.models import optimizer, tracking

        PoseSpy.active = None
        optimizer.pose_optimization = self.saved[0]
        tracking.Tracker._relocalize, tracking.Tracker._reloc_project_candidate = self.saved[1:]


class PoseUnits:
    """While entered (inside a PoseSpy), keeps a copy of the inputs of every
    call of a graphed unit that runs the pose LM (POSE_UNIT_FNS) made on
    this thread, with the stack and the spy's ``second`` at the call, in
    POSE_RECORDS; ``graphs.jit.__call__`` patched at the class, as
    TrackerUnits does."""

    def __init__(self, phase):
        self.phase = phase
        self.thread = threading.current_thread()

    def __enter__(self):
        from multicol_slam_tpu_torch.utils import graphs

        self.orig = orig = graphs.jit.__call__

        def call(g, *a, **k):
            spy = PoseSpy.active
            if spy is not None and threading.current_thread() is self.thread \
                    and getattr(g.fn, "__name__", "") in POSE_UNIT_FNS:
                POSE_RECORDS.append(dict(fn=g.fn, inputs=clone_tree((a, k)), phase=self.phase,
                                         names=tuple(_stack_names()), second=spy.second))
            return orig(g, *a, **k)

        graphs.jit.__call__ = call
        return self

    def __exit__(self, *exc):
        from multicol_slam_tpu_torch.utils import graphs
        graphs.jit.__call__ = self.orig


def _stack_names():
    names = []
    f = sys._getframe(2)
    while f is not None:
        names.append(f.f_code.co_name)
        f = f.f_back
    return names


def call_site(context: bool = True) -> str:
    """The call site of the current Hamming-NN call: the innermost function
    on the stack that names one, then (with ``context``) what its callers
    add (site_in_context)."""
    site = next((SITES[n] for n in _stack_names() if n in SITES), None)
    if site is None:
        fail("a Hamming-NN entry was called from an unknown call site")
    return site_in_context(site) if context else site


def site_in_context(site: str) -> str:
    """A site named by its function, in the context of the current call
    stack and thread: the chunk scan's tracking sites, the fuse under
    CorrectLoop, and MAPPER appended on the async mapper's thread."""
    names = _stack_names()
    if site in ("motion", "local_map") and "working_scan_chunk" in names:
        site = "chunk_" + site
    elif site == "fuse" and "_correct_loop" in names:
        site = "loop_fuse"
    if threading.current_thread().name == "multicol-mapper":
        site += MAPPER
    return site


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
        # a graphed unit's first call (its warm-up) may have run in an
        # earlier phase, or under another context than the site's replays
        got_kind, args = first_inputs(site, spy.args, SiteSpy.first_args)
        if got_kind != site_kind(site):
            fail(f"call site {site} used {ENTRY[got_kind]}, want {ENTRY[site_kind(site)]}")
        entries.append(site_entry(knn, site + tag, got_kind, args, spy.launches[site], card))
    return entries


def first_inputs(site, *recorded):
    """(kind, args) of a site's first recorded inputs, from the first of
    the ``recorded`` dicts that has them: the site's own; else those of
    the site the graph's warm-up ran at, for a site whose launches were
    all replays of a graph another site's call captured (the mapper's
    units on its thread, CorrectLoop's fuse, the fuse_candidates graph
    between guided SearchBySim3 and the support count)."""
    base = site.replace(MAPPER, "").replace("loop_", "")
    names = [site, base] + [s for s in PROJECTED_SITES if base in PROJECTED_SITES and s != base]
    for name in names:
        for d in recorded:
            if name in d:
                return d[name]
    fail(f"no recorded inputs of call site {site}")


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
    while the clock is entered. A target is (owner, attribute, label). A
    stage's time includes the stages it calls."""

    def __init__(self, *targets):
        self.targets = targets
        self.ms = Counter()
        self.calls: list = []      # (label, ms) of every call, in order

    def _timed(self, f, label):
        def stage(*a, **k):
            out, ms = timed(lambda: f(*a, **k))
            self.ms[label] += ms
            self.calls.append((label, ms))
            return out
        return stage

    def __enter__(self):
        self.saved = []
        for owner, attr, label in self.targets:
            f = getattr(owner, attr)
            self.saved.append((owner, attr, f, attr in vars(owner)))
            setattr(owner, attr, self._timed(f, label))
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
    record_units(slam, "phase 6")
    gt = synthetic.bench_trajectory(SYS_FRAMES + RELOC_FRAMES)
    render = synthetic.make_renderer(slam.rig)
    frames = torch.round(render(torch.tensor(gt, dtype=torch.float32, device=dev)))
    frames = frames.to(torch.uint8)

    # the main path, counted: every launch goes through the wrappers; the
    # spy names its call site and keeps each site's first inputs
    kinds, times, init_frame, returned = [], [], None, {}
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy, TrackerUnits(slam, "phase 6"):
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
    PATH_MS["phase 6"] = list(zip(tr.frame_path, times))
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
    from multicol_slam_tpu_torch.ops import se3_np
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    tr, m = slam.tracker, slam.map
    calls, cands, reloc_ms = Counter(), [], []
    orig = {"cands": tr.reloc_candidates_fn}
    units = TrackerUnits(slam, "phase 7")

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

    tr.reloc_candidates_fn = candidates
    tr._optimize_current_pose = optimize
    tr._relocalize = relocalize
    reset_launches(knn)
    try:
        with SiteSpy(knn, matcher) as spy, units:
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
            PATH_MS["phase 7"] = list(zip(paths, frame_ms))
            calls["ransac_gpnp"] = units.calls["_gpnp"]
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
        tr.reloc_candidates_fn = orig["cands"]
        del tr._optimize_current_pose, tr._relocalize
    PATH_MS["_relocalize"] = reloc_ms
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
    of tests/test_loop_closing.py, the map restored after each step; the
    loop closers' units are CUDA graphs (LoopUnits records and times their
    calls for phase 16). Returns (the kernel JSON entries of its call
    sites, the times phase 16 prints)."""
    from multicol_slam_tpu_torch.models import loop_closing as lcm
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models import vocabulary as tv
    from multicol_slam_tpu_torch.models.keyframe_database import KeyFrameDatabase
    from multicol_slam_tpu_torch.ops import se3_np
    from multicol_slam_tpu_torch.ops import sim3 as s3
    from multicol_slam_tpu_torch.utils import graphs

    m, lc = slam.map, slam.loop_closer
    dev = lc.dev
    held = {u: getattr(lc.graphs.get(u), "unit", lc.graphs.get(u)) for u in LOOP_UNITS}
    if not all(isinstance(g, graphs.jit) and g.pool is slam.mapper.pool for g in held.values()) \
            or held["bundle_adjustment"] is not getattr(slam.mapper._bundle_adjust, "unit", None):
        fail(f"loop: the system's closer holds {lc.graphs}, not CUDA graphs in the mapper's pool "
             f"and the mapper's BA graph")
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

    sim3_ms, correct_ms = [], []
    sim3_stages = [(lcm, "sample_sim3_sets", "draws"), (lcm, "horn_alignment", "horn"),
                   (lcm.sim3_opt, "sim3_chi2", "score"),
                   (lc, "_guided_sim3_pairs", "guided"),
                   (lc, "_count_neighborhood_support", "support")]

    reset_launches(knn)
    units = LoopUnits("phase 8")
    try:
        with SiteSpy(knn, matcher) as spy, units:
            # SearchByBoW between the first two keyframes
            pairs = lc._matched_point_pairs(kf1, kf2)
            same = sum(p[0] == p[1] for p in pairs)
            print(f"loop: SearchByBoW keyframes {kf1}-{kf2}: {len(pairs)} pairs, {same} "
                  f"the same landmark")
            if len(pairs) < lcm.MIN_BOW_MATCHES or same <= 0.6 * len(pairs):
                fail("SearchByBoW between the first two keyframes: want >= "
                     f"{lcm.MIN_BOW_MATCHES} pairs, > 60% the same landmark")

            # ComputeSim3 between them: near their own relative pose. The
            # first call is the process's first use of the Sim3 code and
            # captures its units' graphs; each call is split into its
            # stages (a graph cannot be split: OptimizeSim3 is one stage)
            for i in range(3):
                n_opt = len(units.ms["optimize_sim3"])
                with StageClock(*sim3_stages) as clock:
                    S12, ms = timed(lambda: lc._compute_sim3(kf1, kf2, pairs))
                clock.ms["optimize_sim3"] = sum(units.ms["optimize_sim3"][n_opt:])
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
            # through a closer built as the JAX tests build theirs (its
            # graphs in a pool of its own)
            closer = lcm.LoopCloser(slam.rig, m, lc.voc, KeyFrameDatabase(), slam._loop_params,
                                    scale_factor=lc.scale_factor, n_levels=lc.n_levels)
            graph_unit = closer.graphs["optimize_essential_graph"]
            closer.graphs["optimize_essential_graph"] = \
                lambda logs, graph, iters=20, fix_scale=True: logs
            eb, ea, pb, pa = drift_and_correct(closer, m, kfs, sim3_dev)
            restore()
            print(f"loop: CorrectLoop, graph neutralized: pose error after "
                  f"{max(ea.values()):.2e} (before {max(eb.values()):.4f}), point error "
                  f"{pa:.2e} (before {pb:.4f})")
            if max(ea.values()) >= 1e-4 or pa >= 1e-3:
                fail("CorrectLoop did not restore the drifted map exactly")
            closer.graphs["optimize_essential_graph"] = graph_unit
            eb, ea, pb, pa = drift_and_correct(closer, m, kfs, sim3_dev)
            restore()
            print("loop: CorrectLoop with the graph, pose error before/after per keyframe "
                  + ", ".join(f"{k}: {eb[k]:.4f}/{ea[k]:.4f}" for k in kfs[1:]))
            if any(ea[k] >= eb[k] for k in kfs[1:]) or ea[kfs[-1]] >= 0.95 * eb[kfs[-1]]:
                fail("CorrectLoop with the essential graph did not improve every keyframe")
            # twice through the system's own closer: SearchAndFuse on, the
            # second call at the first's keys
            for _ in range(2):
                drift_and_correct(lc, m, kfs, sim3_dev, correct_ms)
                restore()

            chain_graph(slam.rig, lc, sim3_dev)

            global_ms = global_ba_repairs(slam, m, restore, card)
    finally:
        restore()
    graph_ms = units.ms["optimize_essential_graph"]
    print(f"loop: _compute_sim3 ms median {statistics.median(sim3_ms):.3f}, _correct_loop ms "
          f"{[round(x, 3) for x in correct_ms]}, optimize_essential_graph ms (20 iterations, "
          f"graphed) {[round(x, 3) for x in graph_ms]} ({card})")
    jac = written_out_jacobian_ms(card)
    times = dict(sim3=sim3_ms, correct=correct_ms, graph=graph_ms, global_ba=global_ms,
                 units=units.ms, jacobians=jac)
    return check_launches(knn, spy, LOOP_SITES, card), times


def written_out_jacobian_ms(card):
    """The written-out linearizations (residuals and Jacobians) timed
    eagerly, apart from the graphs that hold them, on phase 8's first
    recorded inputs: OptimizeSim3's at its initial iterate, and the
    essential graph's edges at its initial logs. Returns {name: ms a
    call}."""
    from multicol_slam_tpu_torch.models import sim3_opt

    out = {}
    for r in LOOP_RECORDS:
        if r["phase"] != "phase 8":
            continue
        a, _ = r["inputs"]
        if r["unit"] == "optimize_sim3" and "sim3" not in out:
            rig, S0, obs = a
            v7 = torch.zeros(7, dtype=obs.X1.dtype, device=obs.X1.device)
            out["sim3"] = cuda_ms(lambda: sim3_opt.sim3_linearize(rig, v7, S0, obs), reps=10)
            shape = tuple(obs.X1.shape)
        if r["unit"] == "optimize_essential_graph" and "edges" not in out:
            logs, g = a
            ei, ej, M = g.edge_i.long(), g.edge_j.long(), sim3_opt.sim3_exp(g.meas)
            out["edges"] = cuda_ms(lambda: sim3_opt.edge_linearize(logs, ei, ej, M), reps=10)
            edges = tuple(g.meas.shape)
    print(f"loop: written-out Jacobians, eager, ms a call: OptimizeSim3's over {shape} pairs "
          f"{out['sim3']:.3f}, the essential graph's {edges} edges {out['edges']:.3f} ({card})")
    return out


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
    obs = obs_of(seed)                    # padded: the first len(seed) rows are the pairs
    S0 = s3.horn_alignment(obs.X1[:len(seed)], obs.X2[:len(seed)], fix_scale=lc.fix_scale)
    S12, _, n_in = sim3_opt.optimize_sim3(rig, S0, obs, iters=10, fix_scale=lc.fix_scale)
    extra = lc._guided_sim3_pairs(kf1, kf2, S12, {(a, b) for a, b, *_ in seed})
    own = all((kf2, c2, s2) in lc.map.pt_obs[p2] for _, p2, _, _, c2, s2 in extra)
    dev = obs.X1.device
    S_true = s3.Sim3(torch.ones((), device=dev),
                     torch.tensor(T12[:3, :3], dtype=torch.float32, device=dev),
                     torch.tensor(T12[:3, 3], dtype=torch.float32, device=dev))
    frac_rev = float((sim3_opt.sim3_chi2(rig, S_true, obs_of(extra))[1][:len(extra)] <= 9.21)
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
    and ``MultiColSLAM.global_bundle_adjustment`` (a graph in the shared
    pool: the first call captures, the second replays) must take the
    points at least halfway back, keyframe 0 unmoved. Returns both calls'
    ms."""
    _, first_ms = timed(lambda: slam.global_bundle_adjustment(iters=10))
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
    return [first_ms, ms]


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
    units = TrackerUnits(slam, "phase 9")
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy, units:
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
    gpnp_calls = units.calls["_gpnp"]

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
             f"{gpnp_calls} GP3P calls, {spy.launches['reloc_bow']} SearchByBoW launches")
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


def loop_unit_counts():
    """{loop unit: [captures, replays]} of the process's graphs so far."""
    from multicol_slam_tpu_torch.utils import graphs
    by_fn = graphs.stats()["by_fn"]
    return {u: [by_fn.get(u, {}).get("captures", 0), by_fn.get(u, {}).get("replays", 0)]
            for u in LOOP_UNITS}


def organic_run(dev, knn, seed, on_frame=None, record=False):
    """One run of the organic loop episode (multicol_slam_tpu_torch/utils/
    episode.py) on the card at ``seed``, the launch counts set to 0 just
    before it: every call site's launches add up to the wrappers' counts,
    every site it launched equals its plain version on its first inputs,
    and the run launched ORGANIC_SITES, and LOOP_SITES when it fired a wide
    loop. ``on_frame(slam, t)`` runs after frame t; with ``record`` the
    loop closer's unit calls are recorded for phase 16. Returns (system,
    episode.summary's outcome with the loop units' captures and replays
    over the run, the SiteSpy)."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.utils import episode

    slam, gt, frame, seed_closer, sync = episode.port_system(dev, seed)
    before = loop_unit_counts()
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy, \
            (LoopUnits("phase 10") if record else contextlib.nullcontext()):
        res = episode.run_episode(slam, frame, gt, seed_closer=seed_closer, sync=sync,
                                  log=lambda *a, **k: None,
                                  on_frame=on_frame and (lambda t: on_frame(slam, t)))
    res["loop_units"] = {u: [a - b for a, b in zip(c, before[u])]
                         for u, c in loop_unit_counts().items()}
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
    """A worker of phase 10: one run at ``seed``, its loop closer's unit
    calls held to their eager selves (phase 16 (a)); writes its outcome,
    that check and the launches (JSON) and each site's first inputs
    (torch) to ``out_dir``."""
    from multicol_slam_tpu_torch.kernels import hamming_nn as knn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, res, spy = organic_run(dev, knn, seed, record=True)
    # phase 16 (a) on this run's loop-unit calls, in this process
    _, kinds = check_loop_records(LOOP_RECORDS, f"organic seed {seed}")
    res["loop_graph_check"] = {f"{u}: {kd}": n for (u, kd), n in kinds.items()}
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
        _, res0, spy0 = organic_run(dev, knn, seed0, on_frame=checkpoint_at, record=True)
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
    units = {u: [sum(r[0]["loop_units"][u][i] for r in runs.values()) for i in (0, 1)]
             for u in LOOP_UNITS}
    print(f"organic: the loop units' graphs over the {len(runs)} runs, [captures, replays] "
          f"{units}; by run {({s: r[0]['loop_units'] for s, r in runs.items()})}; a unit "
          f"capturing more often than it replays: "
          f"{[u for u, (c, r) in units.items() if c > r] or 'none'} ({card})")
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
    checks = {s: r[0].get("loop_graph_check") for s, r in runs.items() if s != seed0}
    print(f"organic: loop-unit calls held to their eager selves in the workers (phase 16 "
          f"(a)), identical: {checks}")
    sites = ORGANIC_SITES + LOOP_SITES + tuple(
        s for s in RELOC_SITES + ("window_search",) if total[s])
    entries = []
    for site in sites:
        kind, args = first_inputs(site, *(r[2] for r in runs.values()))
        entries.append(site_entry(knn, site + "_organic", kind, args, total[site], card))
    return entries, checks


def async_phase(dev, knn, card, frames, gt, ref):
    """Phase 11: (a) async mapping, (b) the chunked path, (c) a reset with
    a mapping pass in flight, (d) the command line. Returns the kernel JSON
    entries of (a)'s and (b)'s call sites, and (b)'s recorded chunk scans
    for phase 14 (c)."""
    t0 = time.perf_counter()
    entries = async_mapping_run(dev, knn, card, frames, gt, ref)
    t1 = time.perf_counter()
    chunk_entries, scans = chunked_run(knn, card, frames, gt, ref)
    entries += chunk_entries
    t2 = time.perf_counter()
    reset_in_flight(dev, frames)
    t3 = time.perf_counter()
    cli_run(card)
    t4 = time.perf_counter()
    print(f"phase 11 wall s: async {t1 - t0:.3f}, chunked {t2 - t1:.3f}, reset {t3 - t2:.3f}, "
          f"CLI {t4 - t3:.3f}, all {t4 - t0:.3f} ({card})")
    return entries, scans


def async_mapping_run(dev, knn, card, frames, gt, ref):
    """Phase 11 (a): MultiColSLAM(async_mapping=True) over phase 6's frames
    to phase 6's bars; every pass after the bootstrap on the mapper thread
    and its stream, the mapper's launches on that stream, each site equal
    to its plain version, no failure in the mapper, the queue empty and the
    thread joined after shutdown."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.models.tracking import TrackState
    from multicol_slam_tpu_torch.utils import config_io, graphs
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    from multicol_slam_tpu_torch.bench import Utilization, pass_split

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, async_mapping=True)
    record_units(slam, "phase 11 (a)")
    mapper_thread, stream = slam._mapper_thread, slam._mapper_stream.cuda_stream
    passes, count, split = [], Counter(), []
    process, ba = slam.mapper.process_keyframe, slam.mapper._local_bundle_adjustment
    refuse = slam.tracker.interrupt_ba_fn

    # the first pass on the mapper thread waits until the tracker starts a
    # capture (the loop below drops the tracker's graphs to make one), so
    # one capture runs beside a mapping pass
    held, go = threading.Event(), threading.Event()

    def recorded_pass(kf):
        passes.append((threading.get_ident(), torch.cuda.current_stream(dev).cuda_stream))
        if threading.current_thread() is mapper_thread and not held.is_set():
            held.set()
            go.wait(timeout=60)
        # the pass's split (after the hold): bench.pass_split's parts
        g0, c0, t0 = graphs.thread_seconds(), time.thread_time(), time.perf_counter()
        try:
            return process(kf)
        finally:
            wall, cpu, g1 = time.perf_counter() - t0, time.thread_time() - c0, \
                graphs.thread_seconds()
            split.append(dict(thread=threading.current_thread().name, wall=wall, cpu=cpu,
                              **{k: g1[k] - g0[k] for k in g1}))

    def recorded_ba(kf):
        count["ba"] += 1
        return ba(kf)

    def refused():
        count["refused"] += 1
        return refuse()

    def mapper_launches():
        return sum(spy.launches[site] for site in ASYNC_MAPPER_SITES)

    def capture_noted(run, device, pool, **kw):
        # a capture on the tracker's thread; the held pass starts with it
        if threading.current_thread() is mapper_thread:
            count["mapper_captures"] += 1
            return capture(run, device, pool, **kw)
        count["captures"] += 1
        busy = slam._mapper_busy.is_set()
        if held.is_set():
            go.set()
        before = mapper_launches()
        out = capture(run, device, pool, **kw)
        count["captures_in_pass"] += busy
        count["mapper_launches_in_capture"] += mapper_launches() - before
        return out

    slam.mapper.process_keyframe = recorded_pass
    slam.mapper._local_bundle_adjustment = recorded_ba
    slam.tracker.interrupt_ba_fn = refused
    capture = graphs._capture
    graphs._capture = capture_noted
    kinds, times, init_frame, returned = [], [], None, {}
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy, Utilization(dev) as util:
        try:
            for i in range(SYS_FRAMES):
                if held.is_set() and not go.is_set():
                    slam.tracker._working_step.clear()
                was_working = slam.state == TrackState.WORKING
                n_kf = slam.map.n_keyframes()
                returned[i], ms = timed(lambda: slam.track(frames[i], i / 25.0))
                times.append(ms)
                if returned[i] is not None and init_frame is None:
                    init_frame = i
                kinds.append("init" if not was_working else
                             "keyframe" if slam.map.n_keyframes() > n_kf else "working")
        finally:
            graphs._capture = capture
            go.set()
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
          f"{join_s:.3f} s, frame paths {dict(Counter(tr.frame_path))}; "
          f"{count['mapper_captures']} graph captures on the mapper's thread, "
          f"{count['captures']} on the tracker's thread, {count['captures_in_pass']} of them while "
          f"a mapping pass ran, {count['mapper_launches_in_capture']} mapper launches during "
          f"the captures")
    ASYNC_SPLIT.update(split=pass_split(split), idle=None if util.busy is None else 1 - util.busy,
                       samples=util.samples, passes_ms=[round(p["wall"] * 1e3, 3) for p in split])
    print(f"async: the slowest pass after the first, split (ms) {ASYNC_SPLIT['split']}; the "
          f"card's idle share over the run {ASYNC_SPLIT['idle']} ({util.samples} samples of "
          f"nvidia-smi utilization.gpu) ({card})")
    if init_frame is None or init_frame >= SYS_INIT_BY:
        fail(f"async: the system did not initialize within {SYS_INIT_BY} frames")
    if not count["captures_in_pass"]:
        fail("async: no graph was captured while a mapping pass ran")
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
    # a replay runs on the mapper's stream; the warm-up before a capture on
    # the mapper's thread runs on the side stream of the mapper's pool
    side = slam.mapper._fuse.unit.pool.state(dev)[1].cuda_stream
    for site in ASYNC_MAPPER_SITES:
        got = spy.streams.get(site, set())
        if stream not in got or not got <= {stream, side}:
            fail(f"async: the launches at {site} went on streams {got}, not only the "
                 f"mapper's {stream} (and its pool's side stream {side})")
    return check_launches(knn, spy, ASYNC_SITES, card, tag="_async")


def chunked_run(knn, card, frames, gt, ref):
    """Phase 11 (b): a fresh system's track_batch(chunk=8) over phase 6's
    frames, held to tests/test_chunked_tracking.py's bars against phase 6's
    per-frame run; entry A launched inside the chunk scan at the motion and
    local-map sites, each equal to its plain version."""
    from multicol_slam_tpu_torch.models import matcher, tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs
    from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR)
    chunk_ms, scans = [], []
    track_chunk = slam.tracker.track_chunk
    scan = tracking.working_scan_chunk

    def timed_chunk(images, timestamps):
        r, ms = timed(lambda: track_chunk(images, timestamps))
        if r is not None:
            chunk_ms.append((r[0], ms))
        return r

    def recorded_scan(*a, **k):
        # phase 14 (c) runs each chunk again eagerly on copies of its inputs
        inputs = clone_tree((a, {n: v for n, v in k.items() if n != "body"}))
        out = scan(*a, **k)
        scans.append((inputs, k["body"], (out[0], dict(out[1]))))   # the tracker pops feats
        return out

    slam.tracker.track_chunk = timed_chunk
    tracking.working_scan_chunk = recorded_scan
    reset_launches(knn)
    try:
        with SiteSpy(knn, matcher) as spy:
            res, wall = timed(lambda: slam.track_batch(frames[:SYS_FRAMES],
                                                       [i / 25.0 for i in range(SYS_FRAMES)],
                                                       chunk=CHUNK))
    finally:
        tracking.working_scan_chunk = scan
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
    scan_ms = lambda xs: (f"{sum(t for _, t in xs) * 1e3 / sum(b for b, _ in xs):.3f} over "
                          f"{sum(b for b, _ in xs)} frames" if xs else "none")
    scan_steady = [(b, t) for b, t, cap in tr.chunk_scans if not cap]
    scan_first = [(b, t) for b, t, cap in tr.chunk_scans if cap]
    print(f"chunked: {len(used)} frames tracked ({len(ref_used)} per frame), ATE {ate:.5f} m "
          f"(per frame {ref_ate:.5f}), {m.n_keyframes()} keyframes ({ref['n_kf']}), "
          f"{m.n_points()} points ({ref['n_pt']}), largest pose distance to the per-frame run "
          f"{max(dist):.5f} m, frame paths {dict(Counter(tr.frame_path))}, accepted per chunk "
          f"{[a for a, _ in chunk_ms]}")
    print(f"chunked: the chunk scan (working_scan_chunk and its fetch, apart from the walk's "
          f"keyframe passes) ms a frame: steady chunks {scan_ms(scan_steady)}, chunks that "
          f"captured {scan_ms(scan_first)}; per frame (phase 6) WORKING "
          f"{percentiles(ref['frame_ms']['working'])} ({card})")
    print(f"chunked ms a frame: {sum(ms for _, ms in chunk_ms) / max(n_chunk, 1):.3f} over the "
          f"{n_chunk} chunk frames (keyframe passes included), the whole batch "
          f"{wall / SYS_FRAMES:.3f}; per frame (phase 6) "
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
    if not scans or not all(isinstance(body, graphs.jit) for _, body, _ in scans):
        fail("chunked: the tracker's chunks did not run the graphed scan body")
    return check_launches(knn, spy, CHUNK_SITES, card, tag="_batch"), scans


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


def clone_tree(tree):
    """A copy of every tensor in nested tuples (NamedTuples kept), lists
    and dicts; other leaves as they are."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x) for x in tree)
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree


def tree_err(got, want, what):
    """Fail unless every tensor of got equals want's: the same dtype and
    shape, integers and flags equal, floats with max |diff| 0 (NaN where
    NaN). Returns (tensors compared, max |diff| over the floats)."""
    from multicol_slam_tpu_torch.utils import graphs

    a, b = [], []
    graphs._flatten(got, a)
    graphs._flatten(want, b)
    if len(a) != len(b):
        fail(f"{what}: {len(a)} output tensors against {len(b)}")
    err = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{what}: output {i} is {x.dtype} {tuple(x.shape)}, want {y.dtype} "
                 f"{tuple(y.shape)}")
        if x.is_floating_point():
            d = (x.double() - y.double()).abs()
            d = torch.where(torch.isnan(x) & torch.isnan(y), torch.zeros_like(d), d)
            e = float(d.max()) if d.numel() else 0.0
            err = max(err, e)
            if not e == 0.0:
                fail(f"{what}: float output {i} differs, max |diff| {e}")
        elif not torch.equal(x, y):
            fail(f"{what}: output {i} ({x.dtype}) differs at "
                 f"{int((x != y).sum())} of {x.numel()} elements")
    return len(a), err


def graph_line(tag):
    """Print the graph module's counters: graphs held, captures, capture
    seconds, replays, the pool's MiB, and each capture since ``tag``'s
    previous print (function, local-map bucket cap, seconds)."""
    from multicol_slam_tpu_torch.utils import graphs

    st = graphs.stats()
    new = st["log"][graph_line.seen:]
    graph_line.seen = len(st["log"])
    caps = [(c["fn"], max((s[0] for s in c["shapes"] if len(s) == 1), default=0),
             round(c["seconds"], 3)) for c in new]
    print(f"graphs after {tag}: {st['graphs_held']} held, {st['captures']} captures in "
          f"{st['capture_s']:.3f} s, {st['replays']} replays, pool "
          f"{st['pool_bytes'] / 2 ** 20:.1f} MiB; new captures (function, cap, s) {caps}")
    return st


graph_line.seen = 0


def graph_runs(dev, knn, card, settings, frames, gt, n, tag):
    """Phase 14 (a) for one configuration: MultiColSLAM's tracker inputs
    (its padded extractor and match parameters) over a map lifted from
    frame 0 at the true pose; frames 1..n rolled eagerly
    (scan_step_inputs, working_track_step, slot_roll), each frame's step
    inputs kept; then the graphed working_track_step on the same inputs,
    counted, each of its 14 outputs identical to the eager step's.
    Returns (the per-frame step arguments, keywords, the graphed step, the
    sites' kernel JSON entries, the spy)."""
    from multicol_slam_tpu_torch.models import matcher, tracking
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io, graphs, synthetic

    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings,
                        enable_loop_closing=False)
    tr, s = slam.tracker, slam.settings
    st = synthetic.gt_bootstrap(slam.rig, torch.tensor(gt[0], dtype=torch.float32,
                                                       device=dev),
                                slam._extract_padded(frames[0]), s.n_levels, s.scale_factor)
    maps = [st[k] for k in ("X", "normal", "mind", "maxd", "cand_base", "pt_desc", "pt_mask")]
    cap = st["X"].shape[0]
    kw = dict(th_motion=tr.cfg.motion_th, th_local=tr.cfg.local_map_th,
              n_levels=s.n_levels, scale_factor=s.scale_factor)
    carry = (st["last"], st["slot_X0"], st["slot_lp0"], st["slot_has0"], st["mt0"], st["V0"])
    args, eager = [], []
    for b in range(1, n + 1):
        M_last, mt_pred, lp_slot = tracking.scan_step_inputs(carry, cap)
        a = (slam._extract_padded, slam.rig, frames[b], mt_pred, carry[1], carry[3],
             carry[0], lp_slot, *maps, tr.params)
        out = tracking.working_track_step(*a, **kw)
        carry, _ = tracking.slot_roll(carry, out, st["X"], M_last)
        args.append(a)
        eager.append(out)
    step = graphs.jit(tracking.working_track_step)
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        graphed = [step(*a, **kw) for a in args]
    torch.cuda.synchronize()
    n_out, err = 0, 0.0
    for b in range(n):
        n_out, e = tree_err(graphed[b], eager[b], f"{tag} frame {b + 1}: graphed step")
        err = max(err, e)
    launches = knn.hamming_nn_radius.launches
    if launches != 2 * n or knn.hamming_nn.launches or len(step) != 1:
        fail(f"{tag}: {launches} window-gated and {knn.hamming_nn.launches} dense-gate "
             f"launches, {len(step)} graphs over {n} frames; want {2 * n}, 0 and 1")
    print(f"{tag}: the graphed working_track_step equals the eager step over {n} frames: "
          f"all 14 outputs ({n_out} tensors a frame) identical, max |diff| of the floats "
          f"{err} (cap {cap}, K {st['slot_has0'].shape[1]}); launches {dict(spy.launches)}, "
          f"masked {dict(spy.masked)}")
    entries = check_launches(knn, spy, ("motion", "local_map"), card, tag="_" + tag)
    return args, kw, step, entries, spy


def profiled(fn, n):
    """torch.profiler (device activity only) over fn(i) for i < n: (device
    operations, device ms, profiled wall ms, the five kernels with the
    most device time as (name, launches, device ms))."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    attr = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    on_dev = [e for e in ka if e.device_type != torch.autograd.DeviceType.CPU]
    top = sorted(on_dev, key=lambda e: getattr(e, attr), reverse=True)[:5]
    return (sum(e.count for e in on_dev), sum(getattr(e, attr) for e in on_dev) / 1e3, wall,
            [(e.key[:60], e.count, round(getattr(e, attr) / 1e3, 3)) for e in top])


class Ranges:
    """While entered, each target (owner, attribute, label) runs inside a
    ``record_function`` range named STAGE + label, and each of
    ``wrapped`` (owner, attribute, replacement) is replaced."""

    def __init__(self, *targets, wrapped=()):
        self.targets = targets
        self.wrapped = wrapped

    def __enter__(self):
        self.saved = []
        for owner, attr, label in self.targets:
            f = getattr(owner, attr)

            def ranged(*a, _f=f, _label=label, **k):
                with torch.profiler.record_function(STAGE + _label):
                    return _f(*a, **k)
            self.saved.append((owner, attr, f, attr in vars(owner)))
            setattr(owner, attr, ranged)
        for owner, attr, replacement in self.wrapped:
            self.saved.append((owner, attr, getattr(owner, attr), attr in vars(owner)))
            setattr(owner, attr, replacement)
        return self

    def __exit__(self, *exc):
        for owner, attr, f, own in reversed(self.saved):
            if own:
                setattr(owner, attr, f)
            else:
                delattr(owner, attr)


def stage_device(prof, within: str | None = None) -> tuple:
    """({stage: device us}, {stage: device operations}, all device us, all
    device operations, {stage: us from the stage's first kernel's start to
    its last kernel's end}) of a profile. A device activity (kernel, copy,
    fill) is traced to the host operation that launched it (its linked
    correlation id) and counts in every STAGE range open on that thread at
    that host moment. A kernel with no such link (a ctypes kernel: its
    launch is no PyTorch operation) counts, if UNLINKED_KERNELS names it,
    in the stage ranges of its label by order (the n-th launch of that
    kernel in the n-th such range on the host, and in the ranges open
    around that one); any other such
    kernel in every stage whose range holds it on the device's timeline,
    where the profiler draws each range from its first kernel's start to
    its last kernel's end. With ``within``, only activity inside that
    stage counts in the others."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): (e.start_ns(), e.start_thread_id()) for e in evs
            if e.device_type() == DeviceType.CPU}
    ranges = [(e.name()[len(STAGE):], e.start_ns(), e.end_ns(), e.start_thread_id())
              for e in evs if e.device_type() == DeviceType.CPU and e.name().startswith(STAGE)]
    dev_ranges = [(e.name()[len(STAGE):], e.start_ns(), e.end_ns()) for e in evs
                  if e.device_type() == DeviceType.CUDA and e.name().startswith(STAGE)]
    by_stage, ops, span = Counter(), Counter(), Counter()
    total, n_ops = 0.0, 0
    for lb, start, end in dev_ranges:
        span[lb] += (end - start) / 1e3
    acts = [e for e in evs
            if e.device_type() == DeviceType.CUDA and not e.name().startswith(STAGE)]
    own = {}
    for kernel, label in UNLINKED_KERNELS.items():
        launched = sorted((e for e in acts if kernel in e.name()
                           and host.get(e.linked_correlation_id()) is None),
                          key=lambda e: e.start_ns())
        held = sorted((r for r in ranges if r[0].startswith(label)), key=lambda r: r[1])
        if len(launched) == len(held):
            own.update({id(e): r for e, r in zip(launched, held)})
    for e in acts:
        us = e.duration_ns() / 1e3
        total += us
        n_ops += 1
        at = host.get(e.linked_correlation_id())
        hit = set() if at is None else {lb for lb, start, end, th in ranges
                                        if th == at[1] and start <= at[0] <= end}
        if not hit and id(e) in own:
            _, at0, _, th0 = own[id(e)]          # its range, and those around it
            hit = {lb for lb, start, end, th in ranges if th == th0 and start <= at0 <= end}
        if not hit:
            hit = {lb for lb, start, end in dev_ranges
                   if start <= e.start_ns() and e.end_ns() <= end}
        if within is not None and within not in hit:
            continue
        for lb in hit or {"(no stage)"}:
            by_stage[lb] += us
            ops[lb] += 1
    return dict(by_stage), dict(ops), total, n_ops, dict(span)


@contextlib.contextmanager
def working_ranges(pose_fn):
    """While entered, the WORKING step's stages (WORKING_STAGES but the
    extraction, which is the step's argument) run inside STAGE ranges, and
    ``pose_fn`` takes ``optimizer.pose_optimization``'s place, its two
    calls named by their caller (POSE_LM_CALLERS)."""
    from multicol_slam_tpu_torch.models import matcher, optimizer, tracking

    def pose_lm(*a, **k):
        label = POSE_LM_CALLERS.get(sys._getframe(1).f_code.co_name, "pose_lm_other")
        with torch.profiler.record_function(STAGE + label):
            return pose_fn(*a, **k)

    saved = optimizer.pose_optimization
    optimizer.pose_optimization = pose_lm
    try:
        with Ranges((tracking, "frustum_check", "frustum"),
                    (matcher, "match_frame_to_frame", "motion_matching"),
                    (matcher, "match_local_map", "local_map_matching")):
            yield
    finally:
        optimizer.pose_optimization = saved


# ctypes kernels (their launches have no PyTorch operation to link them
# to a range) by a part of their name, and the label of the ranges that
# launch each once
UNLINKED_KERNELS = {"pose_lm": "pose_lm", "cell_flags": "x_detect", "tile_maxima": "x_detect",
                    "describe": "x_describe"}
# the extraction's sub-stages (phase 14 (b), tools/measure_system.py): the
# plain chain's (per level: FAST with the fallback and the suppression,
# Harris, the selection) and the kernels' path's (x_detect, x_describe);
# what no range holds is the rest
EXTRACT_PER_LEVEL = ("x_fast_nms", "x_harris", "x_selection")


def extraction_ranges(sizes):
    """While entered, the extractor's sub-stages run inside STAGE ranges:
    x_pyramid, x_fast_nms@l, x_harris@l and x_selection@l (the plain
    chain's per level; ``sizes`` the levels' (H, W)), x_patches (the patch
    gather, IC angle and blur), x_descriptor, x_detect and x_selection (the
    kernels' path: the detection kernel, the sort and gathers), x_describe
    (the descriptor kernel), x_rays."""
    from multicol_slam_tpu_torch.kernels import extract as extract_k
    from multicol_slam_tpu_torch.models import extractor
    from multicol_slam_tpu_torch.ops import brief, fast, pyramid

    level_of = {tuple(hw): lvl for lvl, hw in enumerate(sizes)}
    per_level = []
    for (owner, attr), label in zip(((fast, "fast_with_fallback"), (fast, "harris_score"),
                                     (fast, "select_uniform_topk")), EXTRACT_PER_LEVEL):
        f = getattr(owner, attr)

        def ranged(img, *a, _f=f, _label=label, **k):
            with torch.profiler.record_function(
                    f"{STAGE}{_label}@{level_of.get(tuple(img.shape[-2:]), '?')}"):
                return _f(img, *a, **k)
        per_level.append((owner, attr, ranged))
    targets = [(pyramid, "build_pyramid", "x_pyramid"), (brief, "extract_patches", "x_patches"),
               (brief, "ic_angle_patches", "x_patches"), (brief, "blur_patches_valid", "x_patches"),
               (brief, "orb_from_patches", "x_descriptor"),
               (brief, "dbrief_from_patches", "x_descriptor"),
               (brief, "mdbrief_from_patches", "x_descriptor"),
               (extract_k, "detect", "x_detect"), (extractor, "select_keypoints", "x_selection"),
               (extract_k, "describe", "x_describe"), (extractor, "img_to_world", "x_rays")]
    return Ranges(*targets, wrapped=per_level)


def extraction_split(extract, images, sizes, n: int = STAGE_FRAMES) -> tuple:
    """Medians over ``images`` (n frames, each profiled alone after an
    unprofiled call) of ``extract``'s device us and device operations by
    sub-stage (extraction_ranges over the pyramid's level ``sizes``;
    "extraction" the whole call's, "(rest)" what no sub-stage holds)."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for i in range(n):
        with extraction_ranges(sizes):
            extract(images[i])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(STAGE + "extraction"):
                    extract(images[i])
                torch.cuda.synchronize()
        us, ops, total, n_ops, _ = stage_device(prof)
        us["(rest)"] = us.get("extraction", 0.0) - sum(v for k, v in us.items()
                                                        if k.startswith("x_"))
        ops["(rest)"] = ops.get("extraction", 0) - sum(v for k, v in ops.items()
                                                        if k.startswith("x_"))
        runs.append((us, ops))
    labels = sorted({k for us, _ in runs for k in us})
    med = lambda j: {lb: round(statistics.median(r[j].get(lb, 0) for r in runs), 3)
                     for lb in labels}
    return med(0), med(1)


def ranged_extract(extract):
    def extraction(images):
        with torch.profiler.record_function(STAGE + "extraction"):
            return extract(images)
    return extraction


def working_stages(args, kw, pose_fn, n):
    """The eager working_track_step on the recorded step arguments of n
    frames, each frame profiled alone with ``pose_fn`` as the pose LM:
    medians a frame of (device us by stage, device operations by stage,
    all device us, all device operations, pose LM calls)."""
    from multicol_slam_tpu_torch.models import tracking
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for i in range(n):
        a = (ranged_extract(args[i][0]),) + tuple(args[i][1:])
        with working_ranges(pose_fn):
            tracking.working_track_step(*a, **kw)     # outside the profile: warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tracking.working_track_step(*a, **kw)
                torch.cuda.synchronize()
        us, ops, total, n_ops, _ = stage_device(prof)
        calls = sum(1 for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CPU
                    and e.name().startswith(STAGE + "pose_lm"))
        runs.append((us, ops, total, n_ops, calls))
    med = lambda i: {lb: round(statistics.median(r[i].get(lb, 0) for r in runs), 3)
                     for lb in WORKING_STAGES + ("(no stage)",)}
    return (med(0), med(1), round(statistics.median(r[2] for r in runs), 3),
            statistics.median(r[3] for r in runs), statistics.median(r[4] for r in runs))


def plain_working_step(*a, **k):
    """working_track_step with the pose LM's plain version in place of its
    kernel: the step as the parent tree ran it."""
    from multicol_slam_tpu_torch.models import optimizer, tracking

    saved = optimizer.pose_optimization
    optimizer.pose_optimization = optimizer.pose_optimization_reference
    try:
        return tracking.working_track_step(*a, **k)
    finally:
        optimizer.pose_optimization = saved


# CUgraphNodeType: the nodes that are device operations; a child graph's
# nodes count in their own types
GRAPH_NODE_TYPES = {0: "kernel", 1: "copy", 2: "fill"}
GRAPH_CHILD = 4


def graph_nodes(cu, graph, counts: Counter) -> Counter:
    """Add the nodes of the CUgraph ``graph`` to ``counts`` by type (a
    child graph's nodes by theirs), through the driver library ``cu``."""
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            fail("cuGraphNodeGetType failed")
        if kind.value == GRAPH_CHILD:
            child = ctypes.c_void_p()
            if cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node), ctypes.byref(child)):
                fail("cuGraphChildGraphNodeGetGraph failed")
            graph_nodes(cu, child, counts)
        else:
            counts[GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")] += 1
    return counts


def graph_operations(run, side) -> tuple:
    """(device operations, nodes by type) of a CUDA graph captured from
    ``run()`` on the stream ``side``, after a warm-up run there (which makes
    the libraries' handles for that stream, as a capture cannot). A
    graph's kernel, copy and fill nodes are the device operations ``run``
    enqueues, counted exactly, where a profile of a replay of 25,000
    kernels may drop records."""
    cur = torch.cuda.current_stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
    cur.wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        run()
    counts = graph_nodes(ctypes.CDLL("libcuda.so.1"), ctypes.c_void_p(graph.raw_cuda_graph()),
                         Counter())
    del graph
    return sum(counts[k] for k in GRAPH_NODE_TYPES.values()), dict(counts)


def step_pose_calls(args, kw) -> list:
    """The (arguments, keywords) of each pose LM call of one eager
    working_track_step on ``args``."""
    from multicol_slam_tpu_torch.models import optimizer, tracking

    calls, saved = [], optimizer.pose_optimization

    def keep(*a, **k):
        calls.append((a, k))
        return saved(*a, **k)
    optimizer.pose_optimization = keep
    try:
        tracking.working_track_step(*args, **kw)
    finally:
        optimizer.pose_optimization = saved
    return calls


@contextlib.contextmanager
def plain_extraction(slam):
    """While entered, ``slam``'s extractor runs its plain chain (the
    parent's path) on the card."""
    saved = slam.extract
    slam.extract = saved.plain
    try:
        yield
    finally:
        slam.extract = saved


def stage_report(args, kw, card, n, variants) -> dict:
    """Phase 14 (b)'s breakdown, for each variant (label, the pose LM, a
    graphed working_track_step that runs it, and a context it runs in or
    None): the eager step's device us
    and operations a frame by stage over n frames (working_stages,
    profiled); the device operations of the step, and of each of its pose
    LM calls, captured on the first frame's inputs into a CUDA graph of
    its own (graph_operations: exact); the graphed step's device ms a
    frame over the n frames (each replay profiled alone). Printed;
    returned by label."""
    side = torch.cuda.Stream()
    calls = step_pose_calls(args[0], kw)
    out = {}
    for label, pose_fn, graphed, ctx in variants:
        with ctx or contextlib.nullcontext():
            us, ops, total, n_ops, n_calls = working_stages(args, kw, pose_fn, n)
            step_ops, step_nodes = graph_operations(lambda: graphed.fn(*args[0], **kw), side)
            lm_graph_ops = sum(graph_operations(lambda a=a, k=k: pose_fn(*a, **k), side)[0]
                               for a, k in calls)
            graphed(*args[0], **kw)               # a first call captures outside the profile
            runs = [profiled(lambda _, i=i: graphed(*args[i], **kw), 1) for i in range(n)]
        g_ms, g_wall = sum(r[1] for r in runs), sum(r[2] for r in runs)
        top = runs[-1][3]
        lm_us = sum(us[s] for s in WORKING_STAGES if s.startswith("pose_lm"))
        lm_ops = sum(ops[s] for s in WORKING_STAGES if s.startswith("pose_lm"))
        print(f"graph (b) {label}: the eager step by stage over {n} frames (median a frame): "
              f"device us {us}, device operations {ops}; all {total} us, {n_ops} operations; "
              f"pose LM calls a frame {n_calls}: {lm_us:.3f} us ({lm_us / max(total, 1e-9):.4f} "
              f"of the step), {lm_ops} operations profiled. Captured on frame 1: the step "
              f"{step_ops} device operations (nodes {step_nodes}), its {len(calls)} pose LM "
              f"calls {lm_graph_ops} ({lm_graph_ops / max(len(calls), 1):.1f} a call). The "
              f"graphed step: {g_ms / n:.3f} device ms a frame, busy {g_ms / g_wall:.4f}; top "
              f"kernels {top} ({card})")
        out[label] = dict(us=us, ops=ops, total_us=total, n_ops=n_ops, calls=n_calls,
                          lm_us=lm_us, lm_ops=lm_ops, step_ops=step_ops,
                          lm_graph_ops=lm_graph_ops, lm_graph_calls=len(calls),
                          graphed_ms=g_ms / n)
    return out


def graph_phase(dev, knn, card, frames, gt, scans):
    """Phase 14: the compiled main path. (a) the graphed working_track_step
    against the eager one on phases 4-5's frames at the default settings
    (B frames) and at phase 9's mdBRIEF settings (3 frames, masked entry A
    inside the graph); (b) torch.profiler and the host clock over
    PROFILE_FRAMES frames, eager against graphed; (c) phase 11 (b)'s
    track_batch chunks, each run again through the eager scan on copies of
    its inputs: identical. Returns the sites' kernel JSON entries."""
    from multicol_slam_tpu_torch.models import optimizer, tracking
    from multicol_slam_tpu_torch.ops import pyramid
    from multicol_slam_tpu_torch.utils import config_io, graphs

    t_a = time.perf_counter()
    args, kw, step, entries, _ = graph_runs(
        dev, knn, card, config_io.SlamSettings(), frames, gt, B, "graph")
    _, _, _, md_entries, spy = graph_runs(
        dev, knn, card, config_io.SlamSettings(**MDBRIEF), frames, gt, GRAPH_MD_FRAMES,
        "graph_mdbrief")
    if any(spy.masked[k] != spy.launches[k] for k in ("motion", "local_map")):
        fail(f"graph_mdbrief: masked launches {dict(spy.masked)} of {dict(spy.launches)}")

    # (b) eager against graphed, the same inputs, in turns
    t_b = time.perf_counter()
    runs = {"eager": lambda i: tracking.working_track_step(*args[i], **kw),
            "graphed": lambda i: step(*args[i], **kw)}
    ms = {k: [] for k in runs}
    for name in ("eager", "graphed", "graphed", "eager"):
        for i in range(PROFILE_FRAMES):
            ms[name].append(timed(lambda: runs[name](i))[1])
    for name, fn in runs.items():
        ops, dev_ms, wall, top = profiled(fn, PROFILE_FRAMES)
        print(f"graph (b) {name} working_track_step over {PROFILE_FRAMES} frames: "
              f"{ops / PROFILE_FRAMES:.2f} device operations a frame, "
              f"{dev_ms / PROFILE_FRAMES:.3f} device ms a frame, busy {dev_ms / wall:.4f} of "
              f"{wall / PROFILE_FRAMES:.3f} profiled ms a frame; unprofiled ms a frame "
              f"{percentiles(ms[name])}; top kernels (name, launches, device ms) {top} ({card})")
    print(f"graph (b) one graphed call between two events: "
          f"{cuda_ms(lambda: runs['graphed'](0), reps=10, warm=2):.3f} ms ({card})")
    # Part 0 and the step by stage: the kernel's pose LM against the plain
    # version's (the parent's path), eager by stage and each in a graph
    slam = args[0][0].__self__
    report = stage_report(args, kw, card, STAGE_FRAMES, [
        ("kernel", optimizer.pose_optimization, step, None),
        ("plain", optimizer.pose_optimization_reference, graphs.jit(plain_working_step), None),
        ("plain extraction", optimizer.pose_optimization,
         graphs.jit(tracking.working_track_step), plain_extraction(slam))])
    k, p, x = report["kernel"], report["plain"], report["plain extraction"]
    print(f"graph (b): extraction in the step {x['us']['extraction']:.1f} -> "
          f"{k['us']['extraction']:.1f} device us and {x['ops']['extraction']} -> "
          f"{k['ops']['extraction']} operations a frame (eager, the plain chain -> the "
          f"kernels); the step {x['total_us']:.1f} -> {k['total_us']:.1f} us; its graph "
          f"{x['step_ops']} -> {k['step_ops']} device operations; graphed device ms a frame "
          f"{x['graphed_ms']:.3f} -> {k['graphed_ms']:.3f} ({card})")
    s = slam.settings
    sizes = pyramid.level_sizes(frames.shape[-2], frames.shape[-1], s.n_levels,
                                s.scale_factor)
    for label, fn in (("the plain chain", slam.extract.plain), ("the kernels", slam.extract)):
        us, ops = extraction_split(fn, frames[1:], sizes)
        print(f"graph (b) extraction by sub-stage, {label} (eager, medians of {STAGE_FRAMES} "
              f"frames): device us {us}; device operations {ops} ({card})")
    drop, need = p["step_ops"] - k["step_ops"], p["lm_graph_ops"] - 8
    per_call = k["lm_graph_ops"] / max(k["lm_graph_calls"], 1)
    print(f"graph (b): the step's device operations a frame (its CUDA graph's nodes) "
          f"{p['step_ops']} with the plain pose LM, {k['step_ops']} with the kernel: down "
          f"{drop}, against Part 0's pose LM operations a frame (the plain calls' graphs) less "
          f"eight, {need}; the kernel's pose LM device operations a call {per_call:.2f}; "
          f"graphed device ms a frame {p['graphed_ms']:.3f} -> {k['graphed_ms']:.3f}; eager "
          f"step device us {p['total_us']:.1f} -> {k['total_us']:.1f}, pose LM "
          f"{p['lm_us']:.1f} -> {k['lm_us']:.1f} ({card})")
    if drop < need or per_call > 4 or k["calls"] != 2 or k["lm_graph_calls"] != 2:
        fail(f"graph (b): the kernel's step dropped {drop} device operations a frame "
             f"(want >= {need}), {per_call:.2f} a pose LM call (want <= 4) over "
             f"{k['calls']} calls a frame profiled, {k['lm_graph_calls']} recorded")
    t_c = time.perf_counter()

    # (c) the tracker's chunks against the eager scan on the same inputs
    for c, ((a, k), body, out) in enumerate(scans):
        want = tracking.working_scan_chunk(*a, **k)
        n_out, err = tree_err(out, want, f"graph (c) chunk {c}")
        print(f"graph (c) track_batch chunk {c} ({a[2].shape[0]} frames, cap "
              f"{a[9].shape[0]}): the graphed scan equals the eager scan, {n_out} tensors "
              f"identical, max |diff| of the floats {err}")
    torch.cuda.synchronize()
    if scans:
        chunk_split(scans[-1])
    print(f"phase 14 wall s: (a) {t_b - t_a:.3f}, (b) {t_c - t_b:.3f}, (c) "
          f"{time.perf_counter() - t_c:.3f} ({card})")
    return entries + md_entries


def chunk_split(scan):
    """Where a steady chunk's ms go (phase 14 (c)): one recorded chunk
    through working_scan_chunk with the graphed body (a replay a frame),
    between two events and as host enqueue alone, against the body's
    graph replayed as many times with no input copies, output clones or
    stack around it."""
    from multicol_slam_tpu_torch.models import tracking

    (a, k), body, _ = scan
    n = a[2].shape[0]
    run = lambda: tracking.working_scan_chunk(*a, body=body, **k)
    run()
    whole = statistics.median(cuda_ms(run, reps=5, warm=1) for _ in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    replays = [e.replay for e in body._graphs.values()]
    if len(replays) != 1:
        fail(f"graph (c): the scan body holds {len(replays)} graphs at the recorded chunk's key")

    def bare():
        for _ in range(n):
            replays[0]()
    bare_ms = cuda_ms(bare, reps=5, warm=1)
    print(f"graph (c) where a steady chunk's time goes ({n} frames): working_scan_chunk "
          f"{whole / n:.3f} ms a frame between two events, host enqueue {enqueue / n:.3f} ms a "
          f"frame; the body's graph replayed alone {bare_ms / n:.3f} ms a frame; the input "
          f"copies, output clones, Python loop and stack {(whole - bare_ms) / n:.3f} ms a "
          f"frame")


MAPPING_STAGES = (("_update_point_stats_for_kf", "point_stats"), ("_cull_map_points", "cull_points"),
                  ("_create_new_map_points", "triangulation"),
                  ("_create_cross_camera_points", "cross_camera"),
                  ("_fuse_in_neighbors", "fuse"), ("_local_bundle_adjustment", "local_ba"),
                  ("_cull_keyframes", "cull_keyframes"))


def mapping_stages(dev, card, frames):
    """Phase 15 (c): the mapping pass's ms by stage, graphed against eager:
    phase 6's frames through fresh synchronous systems (loop closing off),
    one per mode, the mapper's units graphed (the card's default) or their
    eager functions, a StageClock over the pass's stages and units (each
    call ended by a sync). Prints each stage's and unit's ms a call
    (median over the passes after the bootstrap's two, and the first
    call apart) and each pass's ms."""
    from multicol_slam_tpu_torch.models import local_mapping
    from multicol_slam_tpu_torch.models.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils import config_io

    out = {}
    for mode in ("graphed", "eager"):
        slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, enable_loop_closing=False)
        if mode == "eager":
            for name in MAPPING_UNITS:
                setattr(slam.mapper, name, getattr(slam.mapper, name).fn)
        targets = [(slam.mapper, a, lb) for a, lb in MAPPING_STAGES] + \
            [(slam.mapper, u, "unit" + u) for u in MAPPING_UNITS] + \
            [(local_mapping, "assemble_ba_problem", "assemble_ba")]
        with StageClock(*targets) as clock:
            for i in range(SYS_FRAMES):
                slam.track(frames[i], i / 25.0)
        slam.shutdown()
        by = {}
        for label, ms in clock.calls:
            by.setdefault(label, []).append(ms)
        line = ", ".join(f"{lb} first {xs[0]:.3f} then {percentiles(xs[1:])}"
                         for lb, xs in by.items())
        print(f"phase 15 (c) {mode} mapping: passes ms {[round(x, 3) for x in slam.mapping_ms]}; "
              f"ms a call by stage and unit: {line} ({card})")
        out[mode] = (list(slam.mapping_ms), by)
    return out


def mapping_phase(dev, knn, card, frames):
    """Phase 15: LocalMapper's four graphed units. Every call recorded in
    phases 6 and 11 (a) (UnitRecorder) runs again eagerly (the unit's own
    function) and through its graph (a replay: the key was captured) on
    copies of its inputs: the recorded output, the replay and the eager
    run identical (integers and flags equal, floats max |diff| 0: the BA's
    block sums run in a fixed order), each replay a replay
    and not a capture, entry B at triangulation and cross-camera and entry
    A at fuse launched once a replay inside the graph and counted at the
    replay. Prints each unit's ms, eager against graphed, the captures and
    replays of every graphed function and the pools' MiB. Then (b) the
    bench's headline at a small size, and (c) mapping_stages on phase 6's
    frames. Returns the sites' kernel JSON entries."""
    from multicol_slam_tpu_torch import bench
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.utils import graphs

    if not UNIT_RECORDS:
        fail("phase 15: no mapping unit call was recorded")
    by_unit = Counter(r["unit"] for r in UNIT_RECORDS)
    for name in MAPPING_UNITS:
        if not by_unit[name]:
            fail(f"phase 15: {name} was never called in phases 6 and 11 (a)")
    units = {}
    ms = {name: {"eager": [], "graphed": []} for name in MAPPING_UNITS}
    reset_launches(knn)
    n_replayed = Counter()
    with SiteSpy(knn, matcher) as spy:
        for i, r in enumerate(UNIT_RECORDS):
            a, k = r["inputs"]
            unit = r["unit_obj"]
            units[r["unit"]] = unit
            replays, captures = unit.replays, unit.captures
            want, t_e = timed(lambda: unit.fn(*a, **k))
            got, t_g = timed(lambda: unit(*a, **k))
            if unit.captures != captures or unit.replays != replays + 1:
                fail(f"phase 15: {r['unit']} call {i} did not replay its graph")
            ms[r["unit"]]["eager"].append(t_e)
            ms[r["unit"]]["graphed"].append(t_g)
            tree_err(got, want, f"phase 15: {r['unit']} ({r['phase']}) replay against eager")
            tree_err(r["out"], want, f"phase 15: {r['unit']} ({r['phase']}, "
                                     f"{'a replay' if r['replayed'] else 'the warm-up'} on "
                                     f"{r['thread']}) recorded against eager")
            n_replayed[r["unit"]] += r["replayed"]
    # the eager reruns launched outside any graph; the replays inside
    for name, site in UNIT_SITE.items():
        if site is None:
            continue
        want_n = 2 * by_unit[name]            # one launch eager, one at the replay
        if spy.launches[site] != want_n:
            fail(f"phase 15: {spy.launches[site]} launches at {site}, want {want_n}")
    entries = check_launches(knn, spy, [s for s in UNIT_SITE.values() if s], card,
                             tag="_mapping_graph")
    for name in MAPPING_UNITS:
        print(f"phase 15: {name} ({units[name].name}): {by_unit[name]} recorded calls "
              f"({n_replayed[name]} of them replays in their phase), each recorded output, "
              f"its replay now and its eager run identical; ms a call eager "
              f"{percentiles(ms[name]['eager'])}, graphed {percentiles(ms[name]['graphed'])} "
              f"({card})")
    st = graphs.stats()
    for fn, c in sorted(st["by_fn"].items()):
        print(f"phase 15: graphs of {fn}: {c['captures']} captures in {c['capture_s']:.3f} s, "
              f"{c['replays']} replays, {c['graphs_held']} held, pool {c['pool']}")
    print(f"phase 15: pools MiB {({k: round(v / 2 ** 20, 1) for k, v in st['pools'].items()})} "
          f"({card})")

    # (b) the bench's headline at a small size, on the card
    t0 = time.perf_counter()
    fps, diag = bench.production_tracker(dev, **HEADLINE_SMALL)
    print(f"phase 15 (b): the bench's headline at {HEADLINE_SMALL}: {fps:.3f} frames/s, "
          f"{diag['ms_per_frame']:.3f} ms a frame, local-map inliers median "
          f"{diag['inliers_median']}, map {diag['map_keyframes']} keyframes "
          f"{diag['map_points']} points, scan body {diag['scan_body']}, "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    if not np.isfinite(fps) or fps <= 0:
        fail(f"phase 15 (b): the headline gave {fps} frames/s")
    mapping_stages(dev, card, frames)
    return entries


def check_loop_records(records, tag):
    """Every recorded loop-unit call (LoopUnits) again eagerly (the unit's
    function) and through its graph (a replay: the key was captured) on
    copies of its inputs: the recorded output, the replay and the eager
    run identical in every output. A fuse_candidates call's launches are
    named by its recorded site. Returns ({unit: {"eager", "graphed": ms
    a call}}, Counter of (unit, what the recorded call was))."""
    ms = {u: {"eager": [], "graphed": []} for u in LOOP_UNITS}
    kinds = Counter()
    for i, r in enumerate(records):
        a, k = r["inputs"]
        unit = r["unit_obj"]
        SiteSpy.forced = r["site"]
        try:
            want, t_e = timed(lambda: unit.fn(*a, **k))
            replays, captures = unit.replays, unit.captures
            got, t_g = timed(lambda: unit(*a, **k))
        finally:
            SiteSpy.forced = None
        if unit.captures != captures or unit.replays != replays + 1:
            fail(f"{tag}: {r['unit']} call {i} did not replay its graph")
        ms[r["unit"]]["eager"].append(t_e)
        ms[r["unit"]]["graphed"].append(t_g)
        kind = ("a warm-up" if r["warm_up"] else "a later key's first call, no warm-up"
                if r["captured"] else "a replay")
        kinds[(r["unit"], kind)] += 1
        tree_err(got, want, f"{tag}: {r['unit']} ({r['phase']}) replay against eager")
        tree_err(r["out"], want, f"{tag}: {r['unit']} ({r['phase']}, {kind}) recorded "
                                 f"against eager")
    return ms, kinds


def loop_graph_phase(dev, knn, card, slam, times, organic_checks):
    """Phase 16: loop closing compiled. (b) first: the system's closer's
    post-loop global BA on phase 6's map, twice (its graph is the mapper's
    BA graph: the map-size key captures with no warm-up, the wrapper having
    warmed at the bootstrap; then a replay), its units recorded; ComputeSim3
    and CorrectLoop through the system's closer with its graphs set aside
    (the units eager on the card) against phase 8's graphed calls. (a)
    every recorded call of the four loop units (phases 8, 10's seed 42 and
    16) runs again eagerly (the unit's function) and through its graph (a
    replay: the key was captured) on copies of its inputs: the recorded
    output (a warm-up's, a replay's, or a later key's first call's, which
    ran no warm-up), the replay and the eager run identical in every
    output (check_loop_records; phase 10's workers ran it on their own
    runs' calls, ``organic_checks``); entry A at fuse_candidates counted
    at each replay and held to its plain version. (c) phase 11 (a)'s pass
    split and the card's idle share. Returns the kernel JSON entries of
    its sites."""
    from multicol_slam_tpu_torch.models import matcher
    from multicol_slam_tpu_torch.models.global_ba import run_global_ba
    from multicol_slam_tpu_torch.ops import sim3 as s3

    m, lc = slam.map, slam.loop_closer
    state = map_state(m)
    restore = lambda: vars(m).update(copy.deepcopy(state))
    kfs = m.keyframe_ids().tolist()
    kf1, kf2 = kfs[0], kfs[1]
    sim3_dev = lambda T: s3.sim3_from_se3(torch.tensor(T, dtype=torch.float32, device=dev))
    units = LoopUnits("phase 16")
    global_ms, global_eager = [], []
    try:
        with units:
            # the post-loop BA, off by default (0 iterations): run here
            # with GBA_ITERS, as a user sets it
            lc.global_ba_iters = GBA_ITERS
            for _ in range(2):
                _, ms = timed(lambda: lc._global_ba(kfs[0]))
                global_ms.append(ms)
                restore()
        for _ in range(2):
            _, ms = timed(lambda: run_global_ba(slam.rig, m, [kfs[0]], lc.scale_factor,
                                                iters=GBA_ITERS))
            global_eager.append(ms)
            restore()
        # ComputeSim3 and CorrectLoop with the units eager on the card
        saved, lc.graphs = lc.graphs, {}
        sim3_eager, correct_eager = [], []
        try:
            pairs = lc._matched_point_pairs(kf1, kf2)
            for _ in range(3):
                _, ms = timed(lambda: lc._compute_sim3(kf1, kf2, pairs))
                sim3_eager.append(ms)
            for _ in range(2):
                drift_and_correct(lc, m, kfs, sim3_dev, correct_eager)
                restore()
        finally:
            lc.graphs = saved
    finally:
        lc.global_ba_iters = 0
        restore()

    # (a) every recorded call graphed against eager
    by_unit = Counter(r["unit"] for r in LOOP_RECORDS)
    missing = [u for u in LOOP_UNITS if not by_unit[u]]
    if missing:
        fail(f"phase 16: no recorded call of {missing}")
    if not any(r["captured"] and not r["warm_up"] for r in LOOP_RECORDS):
        fail("phase 16: no recorded call of a later key captured with no warm-up")
    reset_launches(knn)
    with SiteSpy(knn, matcher) as spy:
        ms, kinds = check_loop_records(LOOP_RECORDS, "phase 16")
    sites = sorted({r["site"] for r in LOOP_RECORDS if r["unit"] == "fuse_candidates"})
    for site in sites:
        want_n = 2 * sum(r["site"] == site for r in LOOP_RECORDS)
        if spy.launches[site] != want_n:
            fail(f"phase 16: {spy.launches[site]} launches at {site}, want {want_n}")
    entries = check_launches(knn, spy, sites, card, tag="_loop_graph")
    for u in LOOP_UNITS:
        print(f"phase 16 (a): {u}: {by_unit[u]} recorded calls "
              f"({ {kd: n for (uu, kd), n in kinds.items() if uu == u} }), each recorded output, "
              f"its replay now and its eager run identical; ms a call eager "
              f"{percentiles(ms[u]['eager'])}, graphed (a replay) "
              f"{percentiles(ms[u]['graphed'])} ({card})")

    fired = {s: c for s, c in organic_checks.items() if c}
    print(f"phase 16 (a): phase 10's workers held their loop-unit calls to their eager "
          f"selves, identical, at the seeds that fired a loop: {fired}")
    if not fired and not any(r["phase"] == "phase 10" for r in LOOP_RECORDS):
        fail("phase 16: no organic run recorded a loop-unit call")
    # (b) the times
    first, later = times["sim3"][0], times["sim3"][1:]
    graph = times["graph"]
    print(f"phase 16 (b): ComputeSim3 ms, graphed: first {first:.3f}, later {later} (phase 8); "
          f"eager on the card: {[round(x, 3) for x in sim3_eager]} ({card})")
    print(f"phase 16 (b): CorrectLoop ms (SearchAndFuse, the essential graph), graphed "
          f"{[round(x, 3) for x in times['correct']]} (phase 8: the first captures); eager "
          f"{[round(x, 3) for x in correct_eager]} ({card})")
    print(f"phase 16 (b): the essential graph (20 iterations) ms, graphed {graph} (phase 8); "
          f"eager {percentiles(ms['optimize_essential_graph']['eager'])}; OptimizeSim3 "
          f"eager {percentiles(ms['optimize_sim3']['eager'])}, graphed "
          f"{percentiles(ms['optimize_sim3']['graphed'])}; written-out Jacobians eager "
          f"{times['jacobians']} ({card})")
    print(f"phase 16 (b): global BA ({GBA_ITERS} iterations) ms: the system's "
          f"global_bundle_adjustment graphed {times['global_ba']} (phase 8, first captures), "
          f"the closer's post-loop BA graphed {[round(x, 3) for x in global_ms]} (first "
          f"captures with no warm-up), eager {[round(x, 3) for x in global_eager]} ({card})")
    bars = dict(first_compute_sim3=(first, 2000.0), later_compute_sim3=(max(later), 500.0),
                essential_graph=(max(graph), 500.0))
    print(f"phase 16 (b): against the loop-closing bars (ms, bar): "
          f"{ {k: (round(v, 3), b, 'met' if v <= b else 'NOT met') for k, (v, b) in bars.items()} } "
          f"({card})")
    # (c) the async mapper's pass split
    print(f"phase 16 (c): phase 11 (a)'s slowest pass after the first, split (ms) "
          f"{ASYNC_SPLIT.get('split')}; passes ms {ASYNC_SPLIT.get('passes_ms')}; the card's "
          f"idle share over the run {ASYNC_SPLIT.get('idle')} ({card})")
    return entries


def eig_errors(entry, A, got, want):
    """(values' error relative to the largest, vectors' error after a
    per-column sign alignment, compared columns) of a small eigensolver's
    output against its plain version's on the matrices A, over the
    matrices whose entries are finite; vectors are compared where their
    value is apart from its neighbours by EIG_GAP of the largest."""
    ok = torch.isfinite(A).flatten(-2).all(-1).reshape(-1)
    if entry == "sym_eig":
        vals, vals_ref = got[0], want[0]
        vecs, vecs_ref = [got[1]], [want[1]]
    else:
        vals, vals_ref = got[1], want[1]
        vecs = [got[0], got[2].transpose(-1, -2)]
        vecs_ref = [want[0], want[2].transpose(-1, -2)]
    n = vals.shape[-1]
    vals, vals_ref = vals.double().reshape(-1, n)[ok], vals_ref.double().reshape(-1, n)[ok]
    scale = vals_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    val_err = float(((vals - vals_ref).abs() / scale).max()) if len(vals) else 0.0
    gap = torch.full_like(vals_ref, float("inf"))
    d = (vals_ref[:, 1:] - vals_ref[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    apart = gap > EIG_GAP * scale
    vec_err = 0.0
    for V, V_ref in zip(vecs, vecs_ref):
        V, V_ref = V.double().reshape(-1, n, n)[ok], V_ref.double().reshape(-1, n, n)[ok]
        sign = torch.sign((V * V_ref).sum(-2, keepdim=True))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        err = (V * sign - V_ref).abs().amax(-2)
        if len(err):
            vec_err = max(vec_err, float(torch.where(apart, err, torch.zeros_like(err)).max()))
    return val_err, vec_err, int(apart.sum())


def empty_library(knn):
    """The empty kernels (EMPTY_SOURCE), built as the port's kernels are."""
    import ctypes

    here = os.path.dirname(os.path.abspath(__file__))
    lib = ctypes.CDLL(knn.build(os.path.join(here, EMPTY_SOURCE), "libempty"))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_cluster_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for f in (lib.empty_launch, lib.empty_cluster_launch, lib.empty_init):
        f.restype = ctypes.c_int
    if lib.empty_init() != 0:
        fail("the empty cluster kernels' init failed")
    return lib


def launch_floor_ms(lib, threads: int = 32, cluster: int = 0) -> float:
    """Device ms of one launch of an empty kernel (one block of
    ``threads``, or with ``cluster`` one thread-block cluster of that many
    such blocks), timed as device_ms times an entry: the least a launch of
    the small eigensolvers, or of the pose LM, can take on this card."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if cluster:
        return device_ms(lambda: lib.empty_cluster_launch(cluster, threads, stream()))
    return device_ms(lambda: lib.empty_launch(threads, stream()))


def pose_floor_ms(card) -> float:
    """The pose LM's launch floor: an empty cluster of the kernel's shape
    (its float32 instance's, as the kernel reports it), after printing
    each instance's cluster, CTA width, registers and local bytes."""
    from multicol_slam_tpu_torch.kernels import pose_lm

    attrs = {dt: pose_lm.kernel_attributes(dt) for dt in (torch.float32, torch.float64)}
    shape = attrs[torch.float32]
    if shape["cluster"] < 2:
        fail(f"the pose LM launches clusters of {shape['cluster']} CTA: want more than one")
    floor_ms = launch_floor_ms(EMPTY["lib"], threads=shape["threads"],
                               cluster=shape["cluster"])
    for dt, at in attrs.items():
        print(f"pose LM instance {str(dt).replace('torch.', '')}: a cluster of {at['cluster']} "
              f"CTAs of {at['threads']} threads, {at['registers']} registers and "
              f"{at['local_bytes']} local bytes a thread, {at['max_active_clusters']} such "
              f"clusters at once; launch floor (an empty cluster of that shape) "
              f"{floor_ms * 1e3:.3f} us ({card})")
    return floor_ms


def eig_entry(site, A, launches, card, floor_ms):
    """Compare, time and bound one small-eigensolver site's recorded input
    on the card, beside the launch floor and the registers and local bytes
    of the kernel instance it launches; returns its entry of the kernels
    line."""
    from multicol_slam_tpu_torch.kernels import small_eig

    entry = site.split("@")[0]
    kernel = getattr(small_eig, entry)
    plain = getattr(small_eig, entry + "_reference")
    got, want = kernel(A), plain(A)
    torch.cuda.synchronize()
    val_err, vec_err, cols = eig_errors(entry, A, got, want)
    if val_err > EIG_VAL_TOL[A.dtype] or vec_err > EIG_VEC_TOL:
        fail(f"{site}: the kernel differs from its plain version at {tuple(A.shape)} "
             f"{A.dtype}: values {val_err:.3g} of the largest (bar "
             f"{EIG_VAL_TOL[A.dtype]}), vectors {vec_err:.3g} (bar {EIG_VEC_TOL})")
    n = A.shape[-1]
    batch = A.numel() // (n * n)
    sweeps = torch.zeros(batch, dtype=torch.int32, device=A.device)
    kernel(A, sweeps)
    n_sweeps = int(sweeps.sum())
    ms = device_ms(lambda: kernel(A))
    plain_ms = cuda_ms(lambda: plain(A))
    size = A.element_size()
    out_elems = batch * (n + n * n) if entry == "sym_eig" else batch * 21
    moved = A.numel() * size + out_elems * size
    # a rotation updates rows, columns and vectors (18 n flops; svd3: two
    # columns' dot products and updates, about 55), a sweep n (n - 1) / 2 of
    # them; then the sort and the normalization
    flops = (n_sweeps * (n * (n - 1) // 2) * 18 * n if entry == "sym_eig"
             else n_sweeps * 3 * 55 + batch * 60)
    peak = F32_OPS_S if A.dtype == torch.float32 else F64_OPS_S
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / peak * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    attrs = small_eig.kernel_attributes(entry, n, A.dtype, A.device)
    dtype = str(A.dtype).replace("torch.", "")
    instance = f"{entry}<{dtype}, {n}>" if entry == "sym_eig" else f"svd3<{dtype}>"
    print(f"{site}: {tuple(A.shape)} {A.dtype}, {launches} launches on the main path, "
          f"{n_sweeps / batch:.2f} Jacobi sweeps a matrix: device {ms * 1e3:.2f} us a launch "
          f"(the launch floor {floor_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.4f} us, "
          f"{bound_by}), torch.linalg {plain_ms * 1e3:.2f} us a call; {instance}: "
          f"{attrs['registers']} registers, {attrs['local_bytes']} local bytes a thread; "
          f"against torch.linalg values {val_err:.3g} of the largest, vectors {vec_err:.3g} "
          f"over {cols} columns ({card})")
    return {"name": f"{entry}@{site.split('@')[1]}", "route": "cuda", "source": EIG_SOURCE,
            "replaces": EIG_REPLACES[site],
            "replaces_note": "no Pallas kernel: XLA's eigh / svd inside the JAX package's "
                             "jitted unit, which torch.linalg cannot replay in a CUDA graph",
            "launches": launches, "max_abs_err": max(val_err, vec_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": plain_ms, "library": f"torch.linalg.{'eigh' if entry == 'sym_eig' else 'svd'}",
            "floor_ms": floor_ms, "instance": instance, "registers": attrs["registers"],
            "local_bytes": attrs["local_bytes"], "shape": list(A.shape), "dtype": dtype}


def eig_cases(dev):
    """Seeded matrices the solvers must also get right: repeated and zero
    eigenvalues, an essential matrix's singular values (s, s, 0), rank 1
    and 0."""
    g = torch.Generator().manual_seed(5)
    q = torch.linalg.qr(torch.randn(4, 4, 4, generator=g, dtype=torch.float64))[0]
    vals = torch.tensor([[1, 1, 2, 3], [0, 0, 1, 5], [2, 2, 2, 2], [0, 1, 1, 0]],
                        dtype=torch.float64)
    sym = q @ torch.diag_embed(vals) @ q.transpose(-1, -2)
    u = torch.linalg.qr(torch.randn(4, 3, 3, generator=g, dtype=torch.float64))[0]
    v = torch.linalg.qr(torch.randn(4, 3, 3, generator=g, dtype=torch.float64))[0]
    s = torch.tensor([[1, 1, 0], [2, 1, 0], [3, 0, 0], [0, 0, 0]], dtype=torch.float64)
    mats = u @ torch.diag_embed(s) @ v.transpose(-1, -2)
    return [(e, a.to(dev, dt)) for dt in (torch.float32, torch.float64)
            for e, a in (("sym_eig", sym), ("svd3", mats))]


def eig_phase(dev, card, eig_spies, eig_launches):
    """Phase 17 (b): the small eigensolvers' kernel at each call site the
    spies recorded (phases 6-7's, then phase 8's Sim3 RANSAC), launched
    at every site, against torch.linalg to its bars, timed beside it, its
    bound and the launch floor (an empty kernel), the registers and local
    bytes of each instance (none in float32); and on seeded adversarial
    matrices. Returns the kernel JSON entries."""
    from multicol_slam_tpu_torch.kernels import small_eig

    entries = []
    floor_ms = launch_floor_ms(EMPTY["lib"])
    print(f"phase 17 (b): the launch floor, an empty kernel of 32 threads, 20 launches "
          f"in a CUDA graph: {floor_ms * 1e3:.2f} us a launch ({card})")
    for entry, n in (("sym_eig", 4), ("sym_eig", 9), ("svd3", 3)):
        for dt in (torch.float32, torch.float64):
            attrs = small_eig.kernel_attributes(entry, n, dt, dev)
            print(f"phase 17 (b): {entry} n={n} {dt}: {attrs}")
            if dt == torch.float32 and attrs["local_bytes"]:
                fail(f"phase 17: the float32 {entry} instance at n={n} uses "
                     f"{attrs['local_bytes']} bytes of local memory a thread")
    for spy, (sym_n, svd_n), sites, phases in zip(eig_spies, eig_launches,
                                                  (EIG_PATH_SITES, EIG_LOOP_SITES),
                                                  ("phases 6-7", "phase 8")):
        for entry, total in (("sym_eig", sym_n), ("svd3", svd_n)):
            by_site = sum(n for st, n in spy.launches.items() if st.startswith(entry + "@"))
            if by_site != total or (entry in {s.split("@")[0] for s in sites} and not total):
                fail(f"phase 17: {entry} launched {total} times over {phases}, its sites "
                     f"{dict(spy.launches)}")
        for site in sites:
            if not spy.launches[site] or site not in spy.args:
                fail(f"phase 17: the small eigensolver was not launched at {site} in {phases}")
            entries.append(eig_entry(site, spy.args[site], spy.launches[site], card, floor_ms))
    for entry, A in eig_cases(dev):
        got = getattr(small_eig, entry)(A)
        want = getattr(small_eig, entry + "_reference")(A)
        val_err, vec_err, cols = eig_errors(entry, A, got, want)
        if val_err > EIG_VAL_TOL[A.dtype] or vec_err > EIG_VEC_TOL:
            fail(f"phase 17: {entry} on the seeded cases ({A.dtype}): values {val_err:.3g}, "
                 f"vectors {vec_err:.3g}")
        print(f"phase 17 (b): {entry} on seeded repeated, zero and rank-deficient cases "
              f"({A.dtype}): values {val_err:.3g} of the largest, vectors {vec_err:.3g} over "
              f"{cols} columns")
    return entries


def tracker_graph_phase(dev, card, slam, frames, eig_spies, eig_launches):
    """Phase 17: the tracker's graphs. (a) every call of the tracker's units
    recorded in phases 6, 7 and 9 (TrackerUnits) runs again eagerly (the
    unit's function) and through its graph (a replay) on copies of its
    inputs, the generator's state set to what it was before the call: the
    recorded output, the replay and the eager run identical in every
    output, and the generator's state after each equal to its state after
    the recorded call; a unit no phase called (the motion-model steps off
    the fused path) is called on phase 6's tracker state, a capture then a
    replay, each identical to eager. (b) the small eigensolvers' kernel at
    each call site of phases 6-7 against its plain version (values within
    1e-5 of the largest in float32, 1e-12 in float64; vectors within 1e-4
    after sign alignment where their value stands apart), launched at
    every site on that path and at phase 8's Sim3 RANSAC (eig_phase:
    ``eig_spies`` and ``eig_launches`` are phases 6-7's, then phase 8's).
    (c) the frames by path and the
    relocalization against the eager tree's (PARENT_MS, printed), each unit's ms eager
    against graphed, the captures and replays of each unit by phase, the
    capture-ahead and what captured after it; GP3P and the pose LM must
    capture nothing on phase 7's relocalized frames. Returns the kernel
    JSON entries."""
    from multicol_slam_tpu_torch.utils import graphs

    # (a) the recorded calls
    by_unit = Counter(r["unit"] for r in TRACKER_RECORDS)
    ms = {u: {"eager": [], "graphed": []} for u in TRACKER_UNITS}
    for i, r in enumerate(TRACKER_RECORDS):
        a, k = r["inputs"]
        g = r["unit_obj"]
        gen = next((x for x in a if isinstance(x, torch.Generator)), None)

        def run(f):
            if gen is not None:
                gen.set_state(r["state"])
            out, t = timed(lambda: f(*a, **k))
            return out, t, None if gen is None else gen.get_state()

        want, t_e, st_e = run(g.fn)
        captures, replays = g.captures, g.replays
        got, t_g, st_g = run(g)
        what = f"phase 17: {r['unit']} ({r['phase']}, call {i})"
        if g.captures != captures or g.replays != replays + 1:
            fail(f"{what} did not replay its graph")
        tree_err(r["out"], want, f"{what}: the recorded "
                                 f"{'replay' if r['replayed'] else 'first call'} against eager")
        tree_err(got, want, f"{what}: a replay against eager")
        if gen is not None and not (torch.equal(st_e, r["state_after"])
                                    and torch.equal(st_g, st_e)):
            fail(f"{what}: the generator's state after the eager call, the replay and the "
                 f"recorded call differ")
        ms[r["unit"]]["eager"].append(t_e)
        ms[r["unit"]]["graphed"].append(t_g)
    tr = slam.tracker
    pts, has = tr._gather_last_slot_points()
    mt = tr._to_dev(tr.last_mt.astype(np.float32))
    direct = {"_motion_step": ((tr.rig, mt, tr._to_dev(pts), tr._to_dev(has), tr.cur_feats,
                                tr.last_feats, tr._to_dev(tr.cur_pt >= 0), tr.params),
                               dict(th=tr.cfg.motion_th)),
              "_extract_motion_step": ((tr.extract, tr.rig, frames[SYS_FRAMES - 1], mt,
                                        tr._to_dev(pts), tr._to_dev(has), tr.last_feats,
                                        tr.params), dict(th=tr.cfg.motion_th))}
    for name in TRACKER_UNITS:
        if by_unit[name]:
            continue
        if name not in direct:
            fail(f"phase 17: {name} was never called in phases 6, 7 and 9")
        g, (a, k) = getattr(tr, name), direct[name]
        want, t_e = timed(lambda: g.fn(*a, **k))
        first = g(*a, **k)
        replays = g.replays
        got, t_g = timed(lambda: g(*a, **k))
        if g.replays != replays + 1:
            fail(f"phase 17: {name}'s second call on phase 6's state did not replay")
        tree_err(first, want, f"phase 17: {name}'s first call on phase 6's state")
        tree_err(got, want, f"phase 17: {name}'s replay on phase 6's state")
        ms[name]["eager"].append(t_e)
        ms[name]["graphed"].append(t_g)
        print(f"phase 17 (a): {name}, called in no phase, on phase 6's tracker state: its "
              f"first call and a replay identical to eager")
    for name in TRACKER_UNITS:
        print(f"phase 17 (a): {name}: {by_unit[name]} recorded calls (phases "
              f"{sorted({r['phase'] for r in TRACKER_RECORDS if r['unit'] == name})}), each "
              f"recorded output, its replay now and its eager run identical; ms a call eager "
              f"{percentiles(ms[name]['eager'])}, graphed {percentiles(ms[name]['graphed'])} "
              f"({card})")

    # (b) the small eigensolvers
    entries = eig_phase(dev, card, eig_spies, eig_launches)

    # (c) frames by path against the parent, captures and replays
    med = lambda xs: round(statistics.median(xs), 3) if xs else None
    paths = {}
    for path, t in PATH_MS["phase 6"] + PATH_MS["phase 7"]:
        paths.setdefault(path, []).append(t)
    line = {p: (med(paths.get(p, [])), len(paths.get(p, [])), PARENT_MS[p])
            for p in ("init", "velocity", "reloc_recent", "fused")}
    line["_relocalize"] = (med(PATH_MS["_relocalize"]), len(PATH_MS["_relocalize"]),
                           PARENT_MS["_relocalize"])
    print(f"phase 17 (c): ms (median, n, the eager tree's in two runs) by frame path in phases "
          f"6-7 and of phase 7's relocalizations, graphed: {line}; reloc frames "
          f"{[round(t, 3) for t in paths.get('reloc', [])]}; at most half the parent's: "
          f"{ {p: v[0] is not None and v[0] <= 0.5 * min(v[2]) for p, v in line.items() if p != 'fused'} } "
          f"({card})")
    for phase, units in TRACKER_PHASES.items():
        print(f"phase 17 (c): {phase}: calls {dict(units.calls)}, captures {dict(units.captures)}")
    st = graphs.stats()["by_fn"]
    names = {getattr(tr, u).name for u in TRACKER_UNITS}
    print(f"phase 17 (c): the tracker's graphs over the process (captures, replays, "
          f"generators) {({n: (c['captures'], c['replays'], c['generators']) for n, c in st.items() if n in names})} "
          f"({card})")
    print(f"phase 17 (c): phase 6's capture-ahead captured {tr.captured_ahead}; captured "
          f"after it (frame, unit, captures): {tr.late_captures}")
    late7 = TRACKER_PHASES["phase 7"].captures
    if late7["_gpnp"] or late7["_pose_opt"]:
        fail(f"phase 17: GP3P or the pose LM captured on phase 7's relocalizations: {dict(late7)}")
    if not tr.captured_ahead:
        fail("phase 17: phase 6's bootstrap captured nothing ahead")
    return entries


def pose_f64(a, k):
    """pose_optimization's arguments (rig, mt0, obs, X) with every float in
    float64."""
    from multicol_slam_tpu_torch.models import optimizer

    rig, mt0, obs, X = a[:4]
    up = lambda t: t.double() if t.is_floating_point() else t
    return (rig_f64(rig), up(mt0), optimizer.BAObservations(*(up(t) for t in obs)),
            up(X)) + tuple(a[4:]), k


def pose_cost(rig, obs, X, mt, inlier, huber):
    """The robust cost at ``mt`` over ``inlier``, in float64."""
    from multicol_slam_tpu_torch.models import optimizer

    (rig, mt, obs, X), _ = pose_f64((rig, mt, obs, X), {})
    return float(optimizer.pose_lm_parts(rig, obs, X, huber)[0](mt, inlier)[1])


def flip_band(rig, obs, X, huber, mt, flipped):
    """The largest |chi2 - huber^2| / huber^2 at ``mt`` over the rows
    ``flipped`` (0 when there is none)."""
    from multicol_slam_tpu_torch.models import optimizer

    if not bool(flipped.any()):
        return 0.0
    chi2 = optimizer.pose_lm_parts(rig, obs, X, huber)[0](mt, obs.valid)[0]
    d2 = huber * huber
    return float(((chi2[flipped] - d2).abs() / d2).max())


def graphed_plain_pose():
    """optimizer.pose_optimization_reference under one graphs.jit wrapper,
    made at the first call: a replay gives the eager call's outputs bit for
    bit (pose_compare checks it on every recorded call) at its device time,
    without its 11,000 dispatches from the host."""
    if not hasattr(graphed_plain_pose, "jit"):
        from multicol_slam_tpu_torch.models import optimizer
        from multicol_slam_tpu_torch.utils import graphs
        graphed_plain_pose.jit = graphs.jit(optimizer.pose_optimization_reference)
    return graphed_plain_pose.jit


def row_orders(n, device) -> list:
    """POSE_ORDERS orders of n rows: reversed, then seeded permutations."""
    gen = torch.Generator().manual_seed(0)
    return [torch.arange(n - 1, -1, -1, device=device)] + [
        torch.randperm(n, generator=gen).to(device) for _ in range(POSE_ORDERS - 1)]


def pose_compare(what, a, k):
    """The kernel (PoseSpy.real on CUDA tensors) against the plain version
    on one recorded call's inputs, on the same rows in float64 and in their
    own dtype; fails beyond the bars (POSE_*). Float64: masks, counts and
    iterations equal, pose within POSE_F64_POSE; where the inliers fit
    exactly (the plain version's final cost under POSE_EXACT_COST), a gain
    compares rounding noise, so there the iterations are printed and not
    held. Float32: round 1 alone
    (iters2=0, whose inliers are the gate round 2 runs on) within
    POSE_F32_POSE; a row on which the two gates or the two final masks
    differ within POSE_F32_BAND of huber^2 (at the plain version's pose);
    and, where the two gates agree, the final poses within POSE_F32_POSE.
    Where a gate row flips, round 2 solves another problem, so the final
    poses are printed and not held. In float32 a round stops at the first
    accepted step that gains under 1e-6, below the rounding of a float32
    cost sum, so where it stops depends on the order of the sums: the
    plain version (graphed_plain_pose, first held to its eager call on the
    recorded rows) and the kernel each run again on the rows in
    POSE_ORDERS other orders (row_orders), and their moves in iterations
    (``order_it_diff``, ``kernel_order_it_diff``) are measured beside the
    kernel's against the plain version (``it_delta``), which pose_phase
    holds to them. The robust costs at the two poses (``cost_rel``) are
    printed. Returns the measures."""
    from multicol_slam_tpu_torch.models import optimizer

    huber = k.get("huber", optimizer.HUBER_POSE)
    out = {}
    for tag, (aa, kk) in (("f64", pose_f64(a, k)), ("f32", (a, k))):
        rig, mt0, obs, X = aa[:4]
        got = PoseSpy.real(*aa, **kk)
        want = optimizer.pose_optimization_reference(*aa, **kk)
        mt, inl, n_in, it = got
        p_mt, p_inl, p_n, p_it = want
        err = float((mt.double() - p_mt.double()).abs().max())
        flipped = inl != p_inl
        m = dict(pose_err=err, flipped=int(flipped.sum()), iterations=(int(it), int(p_it)),
                 rows=int(obs.uv.shape[0]), valid=int(obs.valid.sum()))
        if [t.dtype for t in got] != [t.dtype for t in want] \
                or [t.shape for t in got] != [t.shape for t in want]:
            fail(f"{what}: the kernel's outputs {[(t.dtype, tuple(t.shape)) for t in got]} "
                 f"against the plain version's {[(t.dtype, tuple(t.shape)) for t in want]}")
        if mt0.dtype == torch.float64:
            m["exact_fit"] = pose_cost(rig, obs, X, p_mt, p_inl, huber) < POSE_EXACT_COST
            if err > POSE_F64_POSE or m["flipped"] or int(n_in) != int(p_n) \
                    or (int(it) != int(p_it) and not m["exact_fit"]):
                fail(f"{what} (float64): the kernel against the plain version {m}; bars: "
                     f"pose {POSE_F64_POSE}, masks, counts and, short of an exact fit, "
                     f"iterations equal")
        else:
            one = dict(kk, iters2=0)
            r1, p_r1 = PoseSpy.real(*aa, **one), optimizer.pose_optimization_reference(*aa, **one)
            gate = r1[1] != p_r1[1]
            m.update(round1_err=float((r1[0].double() - p_r1[0].double()).abs().max()),
                     gate_flipped=int(gate.sum()),
                     gate_band=flip_band(rig, obs, X, huber, p_r1[0], gate))
            if not m["gate_flipped"]:
                m["flip_band"] = flip_band(rig, obs, X, huber, p_mt, flipped)
            plain = graphed_plain_pose()
            replay = plain(*aa, **kk)
            if any(not torch.equal(x, y) for x, y in zip(replay, want)):
                fail(f"{what}: the graphed plain version's replay differs from its eager call")
            moved = [(rig, mt0, optimizer.BAObservations(*(t[rows] for t in obs)), X)
                     + tuple(aa[4:]) for rows in row_orders(obs.uv.shape[0], obs.uv.device)]
            m.update(it_delta=int(it) - int(p_it),
                     order_deltas=[int(plain(*b, **kk)[3]) - int(p_it) for b in moved],
                     kernel_order_deltas=[int(PoseSpy.real(*b, **kk)[3]) - int(it)
                                          for b in moved])
            ca = pose_cost(rig, obs, X, mt, p_inl, huber)
            cb = pose_cost(rig, obs, X, p_mt, p_inl, huber)
            m["cost_rel"] = abs(ca - cb) / max(abs(cb), 1e-30)
            if m["round1_err"] > POSE_F32_POSE or m["gate_band"] > POSE_F32_BAND \
                    or m.get("flip_band", 0.0) > POSE_F32_BAND \
                    or (not m["gate_flipped"] and err > POSE_F32_POSE):
                fail(f"{what} (float32): the kernel against the plain version {m}; bars: "
                     f"round 1 and, where the gates agree, the pose within {POSE_F32_POSE}; "
                     f"flipped gate or final rows within {POSE_F32_BAND} of huber^2")
        out[tag] = m
    return out


def pose_entry(site, inputs, launches, card, floor_ms, worst=None):
    """Compare, time and bound the pose LM kernel on one call site's
    recorded input on the card: device us a launch by CUDA-graph replay,
    beside the launch floor, the plain version's device us and device
    operations a call, the bound (operations: POSE_PASS_OPS a row a pass
    over this input's passes; bytes: each input read once, each output
    written once), registers and local bytes. Returns its entry of the
    kernels line; ``worst`` (the site's worst measures over its recorded
    calls) goes into it."""
    from multicol_slam_tpu_torch.kernels import pose_lm
    from multicol_slam_tpu_torch.models import optimizer

    a, k = inputs
    m = pose_compare(f"pose_lm@{site}", a, k)
    rig, mt0, obs, X = a[:4]
    kernel = lambda: PoseSpy.real(*a, **k)
    plain = lambda: optimizer.pose_optimization_reference(*a, **k)
    ms = device_ms(kernel)
    plain_ms = device_ms(plain, reps=2, rounds=3)
    plain_ops = profiled(lambda i: plain(), 1)[0]
    it = int(kernel()[3])
    K = obs.uv.shape[0]
    passes = it + 3
    size = mt0.element_size()
    floats_in = (rig.M_c.numel() + sum(f.numel() for f in rig.cams[:5])
                 + rig.cams.inv_poly.numel() + 6 + obs.uv.numel() + K + X.numel())
    # floats, the int32 camera and point indices and the bool validity in;
    # the pose, the bool inliers, the int64 count and int32 iterations out
    moved = floats_in * size + 8 * K + K + 6 * size + K + 8 + 4
    flops = K * passes * POSE_PASS_OPS
    peak = F32_OPS_S if mt0.dtype == torch.float32 else F64_OPS_S
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, flops / peak * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    attrs = pose_lm.kernel_attributes(mt0.dtype, mt0.device)
    worst = worst or m
    print(f"pose_lm@{site}: {K} rows ({int(obs.valid.sum())} valid) {mt0.dtype}, {launches} "
          f"launches, {it} iterations ({passes} passes): device {ms * 1e3:.2f} us a launch "
          f"(the launch floor {floor_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.4f} us, "
          f"{bound_by}), the plain version {plain_ms * 1e3:.2f} device us and {plain_ops} "
          f"device operations a call; {attrs}; against the plain version {m}; worst over "
          f"the site's calls {worst} ({card})")
    return {"name": f"pose_lm@{site}", "route": "cuda", "source": POSE_SOURCE,
            "replaces": POSE_REPLACES,
            "replaces_note": "no Pallas kernel: the JAX package's jitted pose LM "
                             "(multicol_slam_tpu/models/optimizer.py:82-165, two "
                             "lax.while_loop rounds), which XLA compiles into a few fused "
                             "device loops",
            "launches": launches, "max_abs_err": max(worst["f32"]["pose_err"],
                                                     worst["f64"]["pose_err"]),
            "ms": ms, "plain_ms": plain_ms, "plain_ops": plain_ops, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes it", "floor_ms": floor_ms,
            "registers": attrs["registers"], "local_bytes": attrs["local_bytes"],
            "cluster": attrs["cluster"], "threads": attrs["threads"], "rows": K,
            "iterations": it, "dtype": str(mt0.dtype).replace("torch.", ""),
            "worst": worst}


def pose_phase(card, spy, floor_ms):
    """Phase 18: every pose_optimization call of phases 6-9. Each recorded
    call of a unit that runs the pose LM (PoseUnits) runs again eagerly
    under a PoseSpy that keeps every pose LM call's inputs, named by the
    recorded call's stack; each of those calls, the kernel against the
    plain version in its dtype and in float64 (pose_compare), the worst
    case per site printed; then each site's first call timed and bounded
    (pose_entry) with the launches ``spy`` counted over phases 6-9, beside
    the launch floor ``floor_ms``. Returns the kernel JSON entries."""
    rerun = PoseSpy(keep_all=True)
    with rerun:
        for r in POSE_RECORDS:
            a, k = r["inputs"]
            rerun.context, rerun.second = r["names"], r["second"]
            if r["fn"].__name__ == "pose_optimization":
                rerun.calls.append((rerun.site("pose_opt", r["names"]), (a, k)))
            else:
                r["fn"](*a, **k)
    POSE_RECORDS.clear()
    by_site = {}
    for site, (a, k) in rerun.calls:
        m = pose_compare(f"phase 18: pose_lm@{site}", a, k)
        w = by_site.setdefault(site, dict(calls=0, f32=dict(pose_err=0.0, flipped=0,
                                                            round1_err=0.0, gate_flipped=0,
                                                            gate_flips_calls=0,
                                                            cost_rel=0.0),
                                          f64=dict(pose_err=0.0), deltas={}, first=(a, k)))
        w["calls"] += 1
        for key in ("pose_err", "flipped", "round1_err", "gate_flipped", "cost_rel"):
            w["f32"][key] = max(w["f32"][key], m["f32"][key])
        w["f32"]["gate_flips_calls"] += bool(m["f32"]["gate_flipped"])
        for key in ("it_delta", "order_deltas", "kernel_order_deltas"):
            w["deltas"].setdefault(key, []).extend(np.atleast_1d(m["f32"][key]).tolist())
        w["f64"]["exact_fits"] = w["f64"].get("exact_fits", 0) + m["f64"]["exact_fit"]
        w["f64"]["it_diff"] = max(w["f64"].get("it_diff", 0),
                                  abs(m["f64"]["iterations"][0] - m["f64"]["iterations"][1]))
        w["f64"]["pose_err"] = max(w["f64"]["pose_err"], m["f64"]["pose_err"])
    spread = lambda ds: dict(max_abs=max(map(abs, ds)), mean=round(statistics.mean(ds), 3))
    for site, w in by_site.items():
        w["f32"]["iterations"] = {key: spread(ds) for key, ds in w["deltas"].items()}
        print(f"phase 18: pose_lm@{site}: {w['calls']} recorded calls, each within the bars; "
              f"worst float32 {w['f32']} (gate_flips_calls: calls whose round-2 gate differs "
              f"on a row at huber^2, whose final pose is not held; iterations: the kernel's "
              f"against the plain version's (it_delta), the plain version's and the "
              f"kernel's own under {POSE_ORDERS} other row orders; the costs' relative "
              f"difference printed, not held), float64 {w['f64']} with equal masks and, "
              f"short of an exact fit, iterations")
    pooled = {key: spread([d for w in by_site.values() for d in w["deltas"][key]])
              for key in ("it_delta", "order_deltas", "kernel_order_deltas")}
    allowed = max(POSE_F32_ITERS, pooled["order_deltas"]["max_abs"],
                  pooled["kernel_order_deltas"]["max_abs"])
    print(f"phase 18: float32 iterations over all {sum(w['calls'] for w in by_site.values())} "
          f"calls: the kernel against the plain version {pooled['it_delta']}; the plain "
          f"version against itself under {POSE_ORDERS} other row orders "
          f"{pooled['order_deltas']}, the kernel against itself {pooled['kernel_order_deltas']}"
          f"; held within {allowed} (the larger move under reordering, or {POSE_F32_ITERS})")
    if pooled["it_delta"]["max_abs"] > allowed:
        fail(f"phase 18: the kernel's float32 iterations part from the plain version's by "
             f"{pooled['it_delta']['max_abs']}, beyond the {allowed} a reordering of the "
             f"rows moves them")
    missing = [s for s in spy.launches if s not in by_site]
    if missing or not {"motion", "local_map", "previous_frame", "reloc",
                       "reloc_second_chance"} <= set(by_site):
        fail(f"phase 18: pose LM sites launched {dict(spy.launches)}, recorded "
             f"{sorted(by_site)}")
    return [pose_entry(site, w["first"], spy.launches[site], card, floor_ms,
                       worst={"f32": w["f32"], "f64": w["f64"]})
            for site, w in by_site.items()]


def extraction_name(cfg, C: int) -> str:
    kind = "mdbrief" if cfg.learn_masks else "dbrief" if cfg.use_dbrief else "orb"
    return (f"{cfg.detector_mask}-{kind}{cfg.desc_bytes}-{cfg.n_features}f-{cfg.n_levels}l-"
            f"th{cfg.fast_th}/{cfg.fast_th_min}-{'harris' if cfg.use_harris else 'fast'}-{C}cam")


def hold_extraction(name, plain, kernel) -> dict:
    """The kernels' features against the plain chain's on the card (phase
    19's bar): every output identical, the angles at every level, the
    descriptor and mask bits. Returns the measures."""
    from multicol_slam_tpu_torch.ops.hamming import unpack_bits_u32

    out = {}
    for field in ("xy", "level", "response", "valid", "ray", "angle"):
        if not torch.equal(getattr(plain, field), getattr(kernel, field)):
            fail(f"extraction {name}: the kernels' {field} differs from the plain chain's")
    out["angle_err"] = float((plain.angle - kernel.angle).abs().max())
    out["upper_level_angles"] = int((plain.level > 0).sum())
    for field in ("desc", "desc_mask"):
        a, b = unpack_bits_u32(getattr(plain, field)), unpack_bits_u32(getattr(kernel, field))
        out[field + "_bits_apart"] = int((a != b).sum())
        if out[field + "_bits_apart"]:
            fail(f"extraction {name}: the kernels' {field} differs from the plain chain's {out}")
    return out


def ring_passes(img, th, ring) -> torch.Tensor:
    """(C, H, W) int: at each pixel of ``img`` the polarities (0, 1 or 2)
    whose segment test passes at th (fl(best arc's minimum - 1) >= th, as
    fast.fast_score takes it)."""
    import functools

    from multicol_slam_tpu_torch.ops import fast

    circle, arc, r = fast.DETECTOR_MASKS[ring]
    h, w = img.shape[-2:]
    pad = fast._pad2(img, ((r, r), (r, r)), "replicate")
    d = [pad[..., r + dy: r + dy + h, r + dx: r + dx + w] - img for dy, dx in circle]
    n = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    for ring_d in (d, [-v for v in d]):
        best = functools.reduce(torch.maximum, fast._ring_min_arc(ring_d, arc))
        n += (best - 1.0 >= th).long()
    return n


def detect_work(img, m, cfg) -> dict:
    """What detection's exact method must do on one level ``img`` (C, H, W)
    with its mask ``m``, counted from this input. Only the pixels inside
    mask and border ("inner") reach a bucket; their suppression reads the
    score one pixel around them ("need": inner dilated by one pixel), and
    a needed pixel's score takes its cell's th_hi flag. So: the th_lo bit
    test at each needed pixel ("need"), the arc minima at each needed
    pixel and polarity that passes ("passes"), the th_hi bit test at the
    other pixels of a cell that holds a needed pixel and no th_hi corner
    among them ("hi_tests": only there must every pixel be tested; where a
    needed pixel passes th_hi, none need be), FAST_PIXEL_OPS at each inner
    pixel ("inner") and Harris at each inner NMS survivor ("survivors")."""
    from multicol_slam_tpu_torch.ops import fast

    h, w = img.shape[-2:]
    b, cell = cfg.border, cfg.cell
    yy, xx = torch.arange(h, device=img.device)[:, None], torch.arange(w, device=img.device)
    inner = m & (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    need = torch.nn.functional.max_pool2d(inner[:, None].float(), 3, 1, 1)[:, 0] > 0
    passes = ring_passes(img, cfg.fast_th_min, cfg.detector_mask)
    hi = ring_passes(img, cfg.fast_th, cfg.detector_mask) > 0
    hp, wp = -(-h // cell) * cell, -(-w // cell) * cell

    def cell_any(x):
        xp = torch.nn.functional.pad(x.float(), (0, wp - w, 0, hp - h))
        has = xp.reshape(x.shape[0], hp // cell, cell, wp // cell, cell).amax((-3, -1)) > 0
        return has.repeat_interleave(cell, -2).repeat_interleave(cell, -1)[..., :h, :w]

    hi_tests = cell_any(need) & ~cell_any(hi & need) & ~need
    survivors = 0
    if cfg.use_harris:
        nms = fast.fast_with_fallback(img, cfg.fast_th, cfg.fast_th_min, cell,
                                      cfg.detector_mask) > 0
        survivors = int((nms & inner).sum())
    return dict(need=int(need.sum()), passes=int(passes[need].sum()),
                hi_tests=int(hi_tests.sum()), inner=int(inner.sum()), survivors=survivors)


def bit_test_ops(n: int, arc: int) -> int:
    """A pixel's segment test as bit masks: n differences, a compare and a
    mask OR a polarity and ring pixel, each polarity's run of arc bits by
    doubling (a shift and an AND a step) and its test."""
    steps, width = 0, 1
    while 2 * width <= arc:
        steps, width = steps + 1, width * 2
    return n + 4 * n + 2 * (2 * (steps + (arc > width)) + 1)


def window_pixels(sizes, yx, level) -> int:
    """Distinct canvas pixels of the keypoints' 53 x 53 windows (the
    descriptor kernel's reads), clamped as extract_patches clamps them."""
    rows = torch.tensor(np.cumsum([0] + [h for h, _ in sizes[:-1]]), device=yx.device)
    canvas_h, w0, side = sum(h for h, _ in sizes), sizes[0][1], 53
    y0 = (rows[level.long()] + yx[..., 0] - 26).clamp(0, canvas_h - side)
    x0 = (yx[..., 1] - 26).clamp(0, w0 - side)
    ar = torch.arange(side, device=yx.device)
    idx = ((y0[..., None] + ar)[..., :, None] * w0 + (x0[..., None] + ar)[..., None, :])
    C = yx.shape[0]
    seen = torch.zeros(C, canvas_h * w0, dtype=torch.bool, device=yx.device)
    seen.scatter_(1, idx.reshape(C, -1), True)
    return int(seen.sum())


def extraction_entries(card, spy, floor_ms) -> list:
    """Phase 19: at every extractor configuration that phases 4-12 (a) ran
    (ExtractSpy: its first recorded images), the kernels' path against
    the plain chain on the card (hold_extraction; and each level's bucket
    maxima and indices identical), then each kernel timed on those inputs
    (device us by CUDA-graph replay) beside its launch floor (empty
    kernels of 256 threads, two for detection's two launches), its bound
    (bytes over 3.35 TB/s or operations over 33.5 T float32 instructions
    a second, the larger; counted from this input: pixels, detect_work's
    counts, keypoints, the windows' distinct pixels; PR 17's count beside
    it) and its plain version, and PR 17's time in the text; the whole
    extraction
    both ways; launches (the spy's calls of that configuration, two
    detection launches and one descriptor launch a call), registers and
    local bytes. Returns the kernels line's entries."""
    from multicol_slam_tpu_torch.kernels import extract as ek
    from multicol_slam_tpu_torch.models import extractor
    from multicol_slam_tpu_torch.ops import brief, fast, pyramid

    entries = []
    for key, (cfg, cams, masks, hw, ex, images) in spy.first.items():
        C = key[1]
        name = extraction_name(cfg, C)
        dev = images.device
        plain, kernel = ex.plain(images), ex(images)
        torch.cuda.synchronize()
        held = hold_extraction(name, plain, kernel)
        sizes = pyramid.level_sizes(*hw, cfg.n_levels, cfg.scale_factor)
        budgets = extractor.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        lv = [lvl for lvl in range(cfg.n_levels) if budgets[lvl] > 0]
        buckets = [extractor._level_buckets(*sizes[lvl], budgets[lvl]) for lvl in lv]
        pyr = pyramid.build_pyramid(images.to(torch.float32), cfg.n_levels, cfg.scale_factor)
        levels = [pyr[lvl] for lvl in lv]
        mk = [torch.from_numpy(np.asarray(masks[lvl]) > 0).to(dev) for lvl in lv]
        kw = dict(th_hi=cfg.fast_th, th_lo=cfg.fast_th_min, cell=cfg.cell, border=cfg.border,
                  ring=cfg.detector_mask, harris=cfg.use_harris)
        got, want = ek.detect(levels, mk, buckets, **kw), ek.detect_reference(levels, mk,
                                                                               buckets, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"extraction {name}: the bucket maxima or their indices differ from plain")
        scales = torch.tensor(pyramid.scale_factors(cfg.n_levels, cfg.scale_factor),
                              device=dev)[plain.level.long()]
        yx = torch.round(plain.xy.flip(-1) / scales[..., None]).to(torch.int32).contiguous()
        pattern = None if cfg.use_dbrief else torch.from_numpy(
            brief.make_pattern(cfg.n_pairs)).to(dev)
        lvl32 = plain.level.contiguous()
        times = dict(
            detect=device_ms(lambda: ek.detect(levels, mk, buckets, **kw)),
            detect_plain=device_ms(lambda: ek.detect_reference(levels, mk, buckets, **kw),
                                   reps=2, rounds=3),
            describe=device_ms(lambda: ek.describe(pyr, yx, lvl32, pattern)),
            describe_plain=device_ms(lambda: ek.describe_reference(pyr, yx, lvl32, pattern),
                                     reps=2, rounds=3),
            extraction=device_ms(lambda: ex(images), reps=3, rounds=5),
            extraction_plain=device_ms(lambda: ex.plain(images), reps=1, rounds=3))
        ops = dict(extraction=profiled(lambda i: ex(images), 1)[0],
                   extraction_plain=profiled(lambda i: ex.plain(images), 1)[0])
        # the bounds, from this input: the least work (phase 19's note,
        # detect_work) and PR 17's count (every pixel scored)
        circle, arc, _ = fast.DETECTOR_MASKS[cfg.detector_mask]
        n = len(circle)
        pixels = sum(C * h * w for h, w in (sizes[lvl] for lvl in lv))
        dw = Counter()
        for img, m in zip(levels, mk):
            dw.update(detect_work(img, m, cfg))
        det_ops = (dw["need"] + dw["hi_tests"]) * bit_test_ops(n, arc) \
            + dw["passes"] * (arc_min_ops(n, arc) + n - 1) + dw["inner"] * FAST_PIXEL_OPS \
            + dw["survivors"] * HARRIS_OPS
        det_ops_pr17 = pixels * (n + 2 * arc_min_ops(n, arc) + 2 * (n - 1) + FAST_PIXEL_OPS) \
            + dw["survivors"] * HARRIS_OPS
        T = got[0].shape[-1]
        det_bytes = pixels * 5 + C * len(lv) * T * 8
        kps = C * plain.level.shape[1]
        out_b = kps * (4 + (4 * cfg.n_words if pattern is not None else 49 * 49 * 4))
        desc_bytes = 4 * window_pixels(sizes, yx, lvl32) + 12 * kps + out_b + (
            0 if pattern is None else pattern.numel() * 4)
        desc_ops = kps * (MOMENT_OPS + ANGLE_OPS + (
            cfg.n_pairs * (2 * BLUR_POINT_OPS + ORB_TEST_OPS) if pattern is not None
            else BLUR_PATCH_OPS))
        desc_ops_pr17 = kps * (DESCRIBE_KP_OPS_EARLIER + (
            ORB_TEST_OPS * cfg.n_pairs if pattern is not None else 0))
        kind = "mdbrief" if cfg.learn_masks else "dbrief" if cfg.use_dbrief else "orb"
        pr17_us = EXTRACT_EARLIER_US.get((cfg.detector_mask, kind, cfg.n_features, cfg.n_levels,
                                          C), (None, None))
        n_detect, n_describe = spy.launches(key)
        desc_kernel = "describe" if pattern is not None else "describe_patches"
        for kernel_name, work, work_pr17, t, t_plain, t_pr17, launches, source, replaces, \
                attrs, floor in (
                ("fast_detect", (det_bytes, det_ops), det_ops_pr17, times["detect"],
                 times["detect_plain"], pr17_us[0], n_detect, DETECT_SOURCE, DETECT_REPLACES,
                 {k: ek.kernel_attributes(k, cfg.detector_mask) for k in ("cell_flags",
                                                                          "tile_maxima")},
                 2 * floor_ms),
                ("orb_describe", (desc_bytes, desc_ops), desc_ops_pr17, times["describe"],
                 times["describe_plain"], pr17_us[1], n_describe, DESCRIBE_SOURCE,
                 DESCRIBE_REPLACES, {desc_kernel: ek.kernel_attributes(desc_kernel)},
                 floor_ms)):
            t_bytes, t_ops = work[0] / HBM_BYTES_S * 1e3, work[1] / F32_INSTR_S * 1e3
            bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                                              "operations")
            bound_pr17_ms = max(t_bytes, work_pr17 / F32_INSTR_S * 1e3)
            entries.append({
                "name": f"{kernel_name}@{name}", "route": "cuda", "source": source,
                "replaces": replaces, "replaces_note": EXTRACT_NOTE, "launches": launches,
                "max_abs_err": held["angle_err"] if kernel_name == "orb_describe" else 0.0,
                "ms": t, "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "library": "none: no single PyTorch call computes it",
                "floor_ms": floor, "attributes": attrs, "bytes": work[0],
                "operations": work[1]})
            print(f"{kernel_name}@{name}: {launches} launches over phases 4-12 (a); device "
                  f"{t * 1e3:.2f} us a call (launch floor {floor * 1e3:.2f} us; bound "
                  f"{bound_ms * 1e3:.3f} us, {bound_by}: {work[0]} bytes, {work[1]} "
                  f"operations; PR 17's count {work_pr17} operations, bound "
                  f"{bound_pr17_ms * 1e3:.3f} us), the plain version {t_plain * 1e3:.2f} us; "
                  f"{attrs}; PR 17's kernel, from PERF.md, not timed here: {t_pr17} us "
                  f"({card})")
        print(f"extraction@{name}: {C} cameras, {kps} keypoints, {pixels} pixels, detection's "
              f"work {dict(dw)}: the kernels' path {times['extraction'] * 1e3:.2f} device us "
              f"and {ops['extraction']} device operations a call, the plain chain "
              f"{times['extraction_plain'] * 1e3:.2f} us and {ops['extraction_plain']}; "
              f"against the plain chain {held} ({card})")
    return entries


def arc_min_ops(n: int, arc: int) -> int:
    """The elementwise minima fast._ring_min_arc takes over a ring of n."""
    width, ops = 1, 0
    while 2 * width <= arc:
        ops += n
        width *= 2
    rest = arc - width
    return ops + (n + arc_min_ops(n, rest) if rest else 0)


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
    from multicol_slam_tpu_torch.kernels import extract as extract_k
    from multicol_slam_tpu_torch.kernels import pose_lm, small_eig
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

    # -- 2. build: one nvcc a source, all started together -------------------
    t0 = time.perf_counter()
    builds = [threading.Thread(target=lib.load_library) for lib in (knn, small_eig, pose_lm)]
    builds += [threading.Thread(target=extract_k.load_library, args=(which,))
               for which in ("detect", "describe")]
    builds.append(threading.Thread(target=lambda: EMPTY.update(lib=empty_library(knn))))
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    knn.load_library()          # raises here if its build failed
    small_eig.load_library()
    pose_lm.load_library()
    extract_k.load_library()
    if "lib" not in EMPTY:
        EMPTY["lib"] = empty_library(knn)
    print(f"kernel build s {time.perf_counter() - t0:.3f}, the five kernel sources and "
          f"{EMPTY_SOURCE} at once ({card})")
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
    # every extractor of phases 4-12 (a) keeps its first inputs (phase 19)
    extract_spy = ExtractSpy().__enter__()
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
    pose_lm.pose_lm.launches = 0
    extract_k.detect.launches = extract_k.describe.launches = 0
    extract_spy.mark()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SiteSpy(knn, matcher) as spy, PoseSpy() as pose_spy:
        carry, ys = run_chunk(extract, rig, frames[1:], st, params, settings, tcfg)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    extract_launches = (extract_k.detect.launches, extract_k.describe.launches)
    if extract_launches != (2 * B, B):
        fail(f"the extraction kernels launched {extract_launches} times (detection's two "
             f"launches, the descriptor) over {B} frames; want {(2 * B, B)}")
    launches = knn.hamming_nn_radius.launches
    if launches != 2 * B or knn.hamming_nn.launches:
        fail(f"hamming_nn_radius launched {launches} times and hamming_nn "
             f"{knn.hamming_nn.launches} over {B} frames, want {2 * B} and 0")
    if pose_lm.pose_lm.launches != 2 * B or dict(pose_spy.launches) != {
            "chunk_motion": B, "chunk_local_map": B}:
        fail(f"pose_lm launched {pose_lm.pose_lm.launches} times over {B} frames, by site "
             f"{dict(pose_spy.launches)}; want {B} at each of the two")
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
    frames4, gt4 = frames, gt          # phase 14 runs these frames again

    # -- 6. the system from the first frame ---------------------------------
    # the small eigensolvers' path is the bootstrap and the relocalization:
    # their counts from 0 over phases 6-7; the pose LM's every call over
    # phases 6-9, each site's launches counted (phase 18)
    small_eig.sym_eig.launches = small_eig.svd3.launches = 0
    pose_lm.pose_lm.launches = 0
    with PoseSpy() as sys_pose_spy, PoseUnits("phases 6-9"):
        with EigSpy() as eig_spy:
            slam, frames, gt, poses, sys_entries, sys_ref = system_phase(dev, knn, card)
            graph_line("phase 6")
            mark("6 system")

            # -- 7. relocalization -------------------------------------------
            reloc_entries = reloc_phase(knn, card, slam, frames, gt, poses)
            mark("7 relocalization")
        eig_launches = (small_eig.sym_eig.launches, small_eig.svd3.launches)

        # -- 8. loop closing -------------------------------------------------
        # the small eigensolvers' third path: the loop closer's Sim3 RANSAC
        small_eig.sym_eig.launches = small_eig.svd3.launches = 0
        with EigSpy() as loop_eig_spy:
            loop_entries, loop_times = loop_phase(knn, card, slam)
        loop_eig_launches = (small_eig.sym_eig.launches, small_eig.svd3.launches)
        mark("8 loop closing")

        # -- 9. the mdBRIEF system ---------------------------------------------
        md_entries = mdbrief_phase(dev, knn, card, frames, gt)
        graph_line("phase 9")
        mark("9 mdBRIEF system")
    if pose_lm.pose_lm.launches != sum(sys_pose_spy.launches.values()) \
            or not pose_lm.pose_lm.launches:
        fail(f"pose_lm launched {pose_lm.pose_lm.launches} times over phases 6-9, its sites "
             f"{dict(sys_pose_spy.launches)}")

    # -- 10. the organic loop closure ------------------------------------------
    organic_entries, organic_checks = organic_phase(dev, knn, card)
    graph_line("phase 10")
    mark("10 organic loop")

    # -- 11. async mapping, the chunked path, reset in flight, the CLI ---------
    async_entries, scans = async_phase(dev, knn, card, frames, gt, sys_ref)
    graph_line("phase 11")
    mark("11 async, chunked, CLI")

    # -- 12. the stretch configuration, self-calibration, a dynamic scene -----
    ring_slam, ring, ring_entries = ring_phase(dev, knn, card)
    extract_spy.__exit__(None, None, None)
    mark("12a eight-camera ring")
    selfcal_phase(dev, card, ring_slam, ring)
    mark("12b self-calibrating BA")
    dyn_entries = dynamic_phase(dev, knn, card)
    graph_line("phase 12")
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
    graph_line("phase 13")

    # -- 14. the compiled main path -------------------------------------------------
    graph_entries = graph_phase(dev, knn, card, frames4, gt4, scans)
    graph_line("phase 14")
    del scans
    mark("14 graphs")

    # -- 15. local mapping's graphed units, the bench's headline ---------------------
    mapping_entries = mapping_phase(dev, knn, card, frames)
    UNIT_RECORDS.clear()
    graph_line("phase 15")
    mark("15 mapping graphs")

    # -- 16. loop closing's graphed units ----------------------------------------------
    loop_graph_entries = loop_graph_phase(dev, knn, card, slam, loop_times, organic_checks)
    LOOP_RECORDS.clear()
    graph_line("phase 16")
    mark("16 loop graphs")

    # -- 17. the tracker's graphed units and the small eigensolvers -----------------
    tracker_entries = tracker_graph_phase(dev, card, slam, frames, (eig_spy, loop_eig_spy),
                                          (eig_launches, loop_eig_launches))
    TRACKER_RECORDS.clear()
    graph_line("phase 17")
    mark("17 tracker graphs")

    # -- 18. the pose LM kernel at every call site of phases 6-9 -------------------
    floor_ms = pose_floor_ms(card)
    pose_entries = [pose_entry(f"working_{site}", pose_spy.first["chunk_" + site],
                               pose_spy.launches["chunk_" + site], card, floor_ms)
                    for site in ("motion", "local_map")]
    pose_entries += pose_phase(card, sys_pose_spy, floor_ms)
    mark("18 pose LM")

    # -- 19. the extraction kernels at every extractor configuration of phases 4-12 (a) -----
    extract_entries = extraction_entries(card, extract_spy, launch_floor_ms(EMPTY["lib"], 256))
    mark("19 extraction kernels")

    print(f"wall s by phase {phase_s}, whole script {time.perf_counter() - t_script:.3f} "
          f"({card})")
    print(json.dumps({"kernels": wf_entries + sys_entries + reloc_entries + loop_entries
                      + md_entries + organic_entries + async_entries + ring_entries
                      + dyn_entries + room_entries + graph_entries + mapping_entries
                      + loop_graph_entries + tracker_entries + pose_entries
                      + extract_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--organic-worker":
        organic_worker(int(sys.argv[2]), sys.argv[3])
    else:
        main()
