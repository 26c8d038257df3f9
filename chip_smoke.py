#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the WORKING tracking step, the
whole system (`Slam.process`) from the first frame, the vocabulary trainer
and the multi-device solvers.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. device      card name and power limit (nvidia-smi), torch and CUDA versions
  2. build       compile the FAST CUDA kernel from the checkout's sources
  3. kernel      the kernel vs its plain PyTorch version, torch.equal: one
                 level a launch (`fast_detect`) at the 8 pyramid-level shapes
                 of a 480x640 frame, thresholds 7 and 20, on random images,
                 the fixture's pyramid levels and a smooth ramp; all 8 levels
                 in one launch with the per-cell select (`fast_level_scores`)
                 on the fixture's pyramid, random levels and a frame with
                 weak and flat regions (both arms of the cell vote), against
                 the plain version and against 8 one-level launches. Then
                 times per frame (CUDA events, warm, median of 20 batches of
                 10; device time from torch.profiler): one launch, 8
                 one-level launches, the plain version; and the kernel's
                 bound from the level shapes. Then `small_linalg` (the
                 solvers' Jacobi kernel) on every call of one `solve_pnp`,
                 `solve_sim3` and `initialize` and on degenerate inputs,
                 against its plain version (the same vector in each
                 position, the same signs, where rounding cannot decide
                 them) and torch.linalg in float64, timed with its bound
                 (`kernel_small_linalg`; tools/small_linalg_compare.py
                 times it against an earlier commit's build); what
                 EPnP's N = 1 case costs on every set (`epnp_n1_cost`);
                 and `pose_lm` (the pose LM kernel) on the step's two
                 passes and a relocalization candidate's LM against its
                 plain version, timed on the step's passes
                 (`kernel_pose_lm`)
  4. slice       the fused step (FusedContext/FusedStep) on the card over the
                 fixture's frames from the JAX reference's recorded state,
                 checked against the reference's recorded outputs; the FAST
                 kernel must have run once per frame, the pose LM kernel
                 twice. Then one frame from
                 a perturbed seed pose, where the step must take its wide
                 recovery pass, against the reference's outputs there. The
                 step runs as its captured programs (utils/program.py),
                 captured by `FusedContext.capture` before the first frame,
                 here and in the next two phases
  5. throughput  100 steps cycling the fixture, re-seeding the pose at each
                 wrap: p50/p95 ms per frame, frames/s, peak device memory
  6. breakdown   the step's layers timed alone at the step's shapes, and a
                 torch.profiler window over 9 steps (device busy share,
                 launches from the host)
  6b. graphs     each captured program against its eager run on the card:
                 the step (torch.equal on every output and on the state it
                 feeds forward) on the fixture's 10 frames fed forward, the
                 recovery frame and a low-texture frame (a flat grey frame
                 with one 96 x 96 window of fixture frame 0: levels take the
                 extractor's slow path); both arms of both host tests must
                 run. The step's launches from the host (torch.profiler's
                 runtime events: at most 11 graph replays and 40 launches)
                 and host reads by source line (sync debug mode), captured
                 against eager. A warmed system over 10 system fixture
                 frames with the map mirror's stage programs
                 (map/device_map.py: the point scatter, triangulation,
                 fusion, local BA with its gathers, the attrs pass, the
                 slice) held at each first call per shape against their
                 functions run eagerly right after the replay
                 (`hold_mirror_programs`: equal bits, the BA by chi2 and
                 outlier flags, the scatter by the mirror's rows), each
                 replayed; what a 4096-row bucket's capture costs mid-run.
                 The local-BA stages (5 and 10 iterations) on
                 the last keyframe's problem after those frames:
                 chi2 and outlier flags against two eager runs, ms. The
                 host path's programs (extraction, frame-to-frame and
                 local-map tracking, the relocalization candidate's two
                 programs, the ladder rungs) are held the same way inside
                 the reloc_async phase on Run R's inputs, and loop
                 closing's (matchers, Sim3 refinement, essential graph)
                 inside the loop phase on the closure's (`hold_programs`:
                 each program's first call per variant, equal bits; the
                 essential graph within the larger of twice the largest
                 difference between four eager runs and 16 float32 ulps),
                 logged as "[graphs] run_r" and "[graphs] loop"
  7. system      `Slam(cfg, vocab=None, device="cuda")` at the shipping widths,
                 after `Slam.warmup()` (timed; every phase below that builds a
                 `Slam` warms it up first, run.py included, and counts FAST
                 launches and frames from the warmup's end)
                 over the 28 frames of the system fixture, from the first
                 frame (initialization, keyframes, triangulation, fusion,
                 local BA, culling), the reference's RANSAC minimal sets
                 injected, then `finish()`; held to the JAX reference's
                 recorded outcome (states, keyframe and point counts, camera
                 centres, keyframe ATE; the initialization's frame, pose and
                 map, which the Jacobi kernel's SVDs decide, within the
                 initializer test's bounds); the FAST kernel must run once on
                 each initialization frame and each fused frame. Reports ms
                 per `process` call (initialization / keyframe / other
                 frames), the tracer's stage summary, host reads per frame
                 and peak device memory. Before it the same system, untimed,
                 takes the same frames counting host synchronisations per
                 frame (CUDA sync debug mode), and is put back as a fresh
                 one (`Slam._restart`, what warmup ends with); the two runs
                 show how far runs on the card agree (both runs' keyframe
                 ATE). Last, the first system's map takes frames 28-32 of
                 the sequence with each mapping stage run alone under
                 torch.profiler (`stage_profile`): per `*_d`/`*_m` stage,
                 ms to the end of its device work, kernels, kernel time and
                 launches from the host, beside the eager stages'; the
                 `*_d` stages (one replay each) at most STAGE_LAUNCHES_MAX
                 launches a call.
  8. reloc_async `Slam` at the shipping widths with the 64k-word tree
                 vocabulary, twice. Run R (`enable_loop_closing=False`,
                 synchronous mapping): the 28 frames, 3 noise frames
                 (the camera covered), then frames 28-44 of the sequence;
                 the tracker must go LOST, relocalize through the keyframe
                 database and PnP, and come back on the frame the JAX
                 reference did (its initialization and PnP minimal sets
                 injected); held to the reference's states, first candidate
                 list, camera centres after recovery and keyframe ATE. Run A
                 is the default constructor call, `Slam(cfg, vocab=tree64k)`
                 (`async_mapping=True` and loop closing on, the reference
                 package's defaults): the 45 frames without the noise;
                 keyframes only when the mapper-busy gate allows, the eleven
                 stages of each (the mapper's ten, then "loop") worked off
                 over later frames and never waited for; held to outcomes,
                 to the stage queue's invariants, to 0 loops closed (as the
                 reference on this sequence) and to one `loop_detect` for
                 every "loop" stage that ran. Reports ms per `process`
                 by frame group (initialization, keyframe, other, lost),
                 keyframes, queue depth, BAs cancelled and aborted, host
                 reads and synchronisations per frame by group, the
                 relocalization attempts, the keyframe database's times, the
                 batched library solves of one PnP call alone, the
                 launches from the host and device ops of each LOST frame
                 (torch.profiler, Run R's untimed run) per
                 candidate tried and of one eager `solve_pnp` alone, the
                 `loop_closing` stage's ms per keyframe, and peak device
                 memory. The FAST kernel must run once on every frame.
                 Each system runs its frames twice: first untimed under
                 sync debug mode, then put back as a fresh one
                 (`Slam._restart`) for the timed run.
  9. loop        a constructed loop at the shipping capacity (max_kf 256,
                 max_mp 16384, 2000 feature rows, eg_edges 2048, the 64k-word
                 vocabulary; tools/loop_scene.py builds it from a seed: 46
                 keyframes, 11,310 points, a tail that revisits the start
                 through drifted duplicates). The map of a default
                 `Slam(cfg, vocab=tree64k)` becomes that scene, and
                 `Slam._loop_close` runs over the tail keyframes with the
                 JAX reference's Sim3 minimal sets injected; held to the
                 reference's recorded outcome (the closing and the loop
                 keyframe, candidate lists, match and inlier counts, the
                 Sim3 after RANSAC and after refinement, the essential
                 graph's edges by kind and its chi2, camera centres after
                 the correction, loop edges; the centres must also be nearer
                 the truth than before). Then global BA at the full (256,
                 16384, 65536) capacity: chi2 falls to within 5 % of the
                 reference's, held cameras do not move, and `Slam.global_ba`
                 writes it back. Reports ms per stage (detect_loop; per
                 candidate mutual match, RANSAC, search by Sim3, refinement,
                 guided matches; the correction and inside it the fuse
                 search and the essential graph's 20 iterations; global BA's
                 20 x 64), kernels launched by the last two (torch.profiler),
                 host synchronisations by source line (none may lie inside
                 the solvers' iterations), peak device memory; the
                 system's `_compile_programs` part by part (seconds, memory
                 left reserved), the essential graph captured against
                 eager (ms, kernels) and its capture alone. One warmed
                 system makes both passes: the untimed one under sync
                 debug mode, then, put back as a fresh one and given the
                 scene anew, the timed one. The FAST kernel is not on this
                 phase's path.
 10. sequence    the command line and the renderer on the card. The
                 renderer (`io/dataset.py:SyntheticSequence`, no cv2) draws
                 frames 0-27 of `xyz` seed 3 on the card, held to the
                 cv2-rendered frames of the system fixture (equal bits, the
                 CPU test's bound) and to its own CPU render; ms per frame.
                 Then, in a process of its own, `python -m
                 orbslam_jpminipc_torch.run --dataset synthetic:xyz --frames
                 300 --seed 0 --save-world ...` twice: with
                 `pipelined_tracking=False`, then as it stands (the default
                 system, pipelined; frames rendered on the card). The
                 second run's files and numbers are held to EVAL_r05.json
                 with margins:
                 at least 290 of 300 frames tracked, keyframe ATE at most 5.9
                 mm, no loop closed, one TUM line per keyframe; ms per
                 `Slam.process` by frame group and one FAST launch a frame.
                 Last the resume: a fresh default `Slam` loads the saved
                 world (arrays equal to the file, tracker LOST) and takes
                 frames 100-160 of the same sequence; it must be WORKING
                 again within 10 frames.

 10b. pipelined  the default frame loop (`cfg.pipelined_tracking`): a WORKING
                 frame's step dispatched as one chain of the step's graphs
                 whose branches the device decides (`FusedContext.dispatch`,
                 utils/graph_chain.py, csrc/graph_chain.cu), its host half
                 run frames later. First the chain against the segments
                 with their host reads on the step fixture's 10 frames
                 (equal bits), the branch kernel timed alone (CUDA
                 events) against the host read it replaces, and a dispatch's
                 launches from the host and kernel time (torch.profiler,
                 10 frames). Then Run P: a
                 warmed `Slam` under the default config, `vocab=None`, over
                 the system fixture's 28 frames with a noise frame after
                 frame 3 (LOST, reset, the records in flight tracked again
                 on the host path), untimed under sync debug mode and
                 torch.profiler (waits by source line, filed as forced head,
                 drain, host path or other; launches from the host per
                 pipelined call), then put back as a fresh one and timed:
                 ms per `process` call (to its return) by group (host path,
                 pipelined keyframe, pipelined other), frames a second,
                 the in-flight depth at every drain, stale records; every
                 frame completed once, in frame order; one FAST launch a
                 frame and one branch launch a branch. Last, the sequence
                 phase's two `run.py --dataset synthetic:xyz --frames 300`
                 runs (a process of its own when that phase did not run),
                 pipelined and synchronous: ms per call by frame group,
                 frames a second of both; pipelined held to >= 295
                 tracked and kf-ATE <= 2 mm
 11. vocab       the vocabulary trainer and the builders on the card. In a
                 process of its own, `python -m orbslam_jpminipc_torch.vocab.train`
                 at its defaults but 4 of its 8 seeds (flat, 8192 words; 60
                 frames of xyz and loop for each seed rendered on the card,
                 every 4th frame extracted: 120 frames); reports the descriptors, seconds by
                 part (render, extract, k-medians) and the FAST launches,
                 which must be one a training frame. `build_vocabulary` on
                 the card against the CPU on 20,000 of those descriptors at
                 1024 words and 3 iterations: equal bytes. The tree (`--tree
                 --k 16 --depth 4 --seeds 2`), timed. Last `python -m
                 orbslam_jpminipc_torch.run --dataset synthetic:xyz --frames
                 60 --vocab <the flat file>`: at least 58 of 60 frames tracked
 12. multichip   the multi-device solvers of `parallel/`. The card's machine
                 has one card, so this is the in-process mesh of one device
                 and a world of one: the N-device evidence is the CPU tests'
                 (tests/test_torch_parallel.py, test_torch_multihost.py).
                 `dryrun_multichip(torch.cuda.device_count())` and its
                 asserts; the loop phase's global-BA problem at (256, 16384,
                 65536) through `sharded_bundle_adjust` (`cfg.gba_iterations`
                 iterations) on the mesh of the process's cards: chi2 within
                 0.5 % of the PCG solver's on the same problem, each
                 keyframe's chi2 within 1 % of the single-device LM's and
                 the PCG's, held cameras unmoved,
                 no host synchronisation (CUDA sync debug mode);
                 ms, kernels (torch.profiler), peak memory. The loop's
                 essential graph through `sharded_optimize_essential_graph`
                 against `optimize_essential_graph` (t within 2e-3, s 1e-4).
                 A process that joins an NCCL world of one through
                 `initialize_distributed` and holds the multihost problem
                 within 5e-4 of the single-device BA. No FAST launch.

`--phases a,b` runs only the named phases (after device and build) and
prints no result line. `--compare TREE TREE ...` runs the throughput,
system and reloc_async phases of several checkouts one after another, each tree's own code
in a process of its own, and prints one JSON line per tree: times on the
card move with the host between calls, so two commits are compared only
inside one call, in the order parent, change, change, parent:

    git archive <parent> | tar -x -C chip_archive/parent   # a directory .gitignore lists
    python3 chip_smoke.py --compare chip_archive/parent . . chip_archive/parent

The fixtures (orbslam_jpminipc_torch/data/track_fixture_xyz.npz,
slam_fixture_xyz.npz and reloc_fixture_xyz.npz) carry real frames and the
reference's state and outputs, loop_fixture.npz the reference's outcome on
the constructed loop; tools/make_torch_fixture.py,
tools/make_torch_slam_fixture.py, tools/make_torch_reloc_fixture.py and
tools/make_torch_loop_fixture.py write them. Details go to chiprun_out/chip_smoke.json. The last line of
standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
RELOC_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "reloc_fixture_xyz.npz")
LOOP_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "loop_fixture.npz")
VOCAB = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "vocab_tree64k.npz")
LEVEL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370),
                (231, 309), (193, 257), (161, 214), (134, 179)]
# parity with the reference's recorded outputs on the card: pose entries,
# share of features with the same binding, relative pass-2 inlier count
TOL_POSE = 1e-3
TOL_BIND = 0.95
TOL_INLIERS = 0.03
# the whole system against the reference's recorded outcome on the card
SYS_STATES_MIN = 27       # of 28 frames with the reference's state
SYS_KF_TOL = 2            # keyframes, absolute
SYS_POINTS_REL = 0.10     # map points, relative
SYS_CENTRE_TOL = 1e-2     # camera centre per frame (median depth is 1)
SYS_ATE_MARGIN = 5e-3     # keyframe ATE above the reference's
SYS_INIT_R_TOL = 1e-4     # the initial pose's R and t against the reference's
SYS_INIT_T_TOL = 1e-2     # (tests/test_torch_initializer.py's POSE_TOL, T_TOL)
# the forced-loss run against the reference's recorded outcome on the card
RELOC_STATE_MISMATCH_MAX = 2   # frames whose state may differ
RELOC_WITHIN_FRAMES = 20       # WORKING again within this many frames of the loss
# the constructed loop against the reference's recorded outcome
LOOP_COUNT_REL = 0.03     # mutual matches, inlier counts, guided total
LOOP_SIM3_TOL = 1e-3      # scale, rotation entries, translation over the median depth
LOOP_CHI2_REL = 0.05      # the essential graph's and global BA's final chi2
LOOP_CENTRE_TOL = 1e-2    # camera centres after the correction, over the median depth
# the pipelined phase: Run P's noise frame goes in after frame 3, while the
# map holds at most 5 keyframes (on the card the first WORKING frame is frame
# 1, on the CPU frame 3): LOST, reset, records in flight tracked again on the
# host path, initialized again, as tests/test_torch_pipelined.py holds on the
# CPU; run.py xyz:300 pipelined against EVAL_r05.json (298/300, kf-ATE 0.9 mm,
# measured pipelined) with margins
PIPE_NOISE_AT = 4
PIPE_TRACKED_MIN = 295
PIPE_KF_ATE_MAX = 2e-3
# the sequence phase: the renderer against cv2's frames (tests/test_torch_dataset.py
# holds it to equal bits on the CPU), and run.py's xyz:300 against EVAL_r05.json
# (298/300 tracked, kf-ATE 0.9 mm, 0 loops closed) with margins; run.py runs
# the default frame loop, pipelined, as the reference's run did
RENDER_EQUAL_SHARE = 1.0
RENDER_MAX_DIFF = 0
SEQ_FRAMES = 300
SEQ_TRACKED_MIN = 290
SEQ_KF_ATE_MAX = 0.9e-3 + SYS_ATE_MARGIN
RESUME_FROM, RESUME_TO = 100, 160   # frames fed to the resumed system
RESUME_WITHIN = 10                  # WORKING again within this many (tests/test_torch_checkpoint.py)
# the graphs phase: the captured programs against their eager runs. A WORKING
# step is at most 11 replays (detect, 8 picks, pass 1, pass 2) and 40 launches
# from the host with the copies; the local-BA stages within the spread the
# card's atomics (index_add_) give two eager runs: chi2 relative, and the
# share of observations whose outlier flag differs. The low-texture frame's
# window, and the system fixture frames that build the BA's map
GRAPH_REPLAYS_MAX = 11
GRAPH_LAUNCHES_MAX = 40
GRAPH_BA_CHI2_REL = 1e-3
GRAPH_BA_FLAG_SHARE = 2e-3
GRAPH_FLAT_WINDOW = 96
GRAPH_BA_FRAMES = 10
# the host path's and loop closing's programs against their eager runs on a
# real run's inputs (Run R, the loop phase's closure): equal bits; the
# essential graph, whose scatter-adds are atomic, leaf by leaf (s, R, t,
# chi2) within the larger of EG_SPREAD_FACTOR times the largest difference
# between EG_EAGER_RUNS eager runs and EG_ULPS float32 ulps of the leaf's
# largest entry. The floor is there because the captured run rounds apart
# from the eager ones by more than they round apart from each other: on an
# H100 80GB HBM3 the closure's chi2 (0.00196) came 9.3e-10 and 1.4e-9 (4-6
# ulps) from the first eager run where the eager runs spread 7.0e-10 and
# 2.3e-10
EG_EAGER_RUNS = 4
EG_SPREAD_FACTOR = 2.0
EG_ULPS = 16
# the mapping stages profiled one call at a time after the system run, on
# these frames of the forced-loss fixture (frames 28-32 of the sequence)
STAGE_PROFILE_FRAMES = 5
# launches from the host a *_d stage may make: its inputs' one packed copy,
# one replay, the outputs' copy, the read's gather and copy, and an attrs
# pass applied on the way in (its scatter's copy and replay)
STAGE_LAUNCHES_MAX = 10
# stage_profile of the eager stages (before they ran as captured programs)
# on the same frames, PERF.md section 5: launches and host ms per call
EAGER_STAGES = {"triangulate_d": (400, "16.7-28.6"), "fuse_d": (145, "27.7-41.1"),
              "fuse_m": (68, "22.7-35.3"), "ba_d": (49, "19.1-28.2"), "ba2_d": (36, "15.6-22.1")}
# the card's published peaks (NVIDIA H100 SXM data sheet) for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per pixel of the FAST score, nonmax and select in the cheapest
# exact form known, the one csrc/fast.cu ships: 2 x 40 three-input integer
# min/max for the 9-arcs of both polarities (16 + 16 + 5 + 3 each), 3 to turn
# a pixel into an integer key of the same order, 3 x 3 to turn the centre and
# the two arc results back, 2 subtractions of the centre, 1 negation, 1 max of
# the two, compare + select + -1 for the threshold, 8 max for the 3x3 nonmax,
# 7 compares and selects for the nonmax test, the border mask and the cell
# select. Counted at the card's float32 rate.
FAST_OPS_PER_PIXEL = 2 * 40 + 3 + 3 * 3 + 2 + 1 + 1 + 3 + 8 + 7
EDGE = 19                 # the extractor's border (EDGE_THRESHOLD)
# the vocab phase: vocab/train.py's defaults (flat, 8192 words, 60 frames of
# xyz and loop for each seed, every 4th frame) at 4 of its 8 seeds (a depth
# cut for the script's 1,000 s: rendering took 62 s of the 8 seeds' 76 s),
# the card's k-medians against the CPU's on a subset (equal bytes), run.py
# with the trained file
VOCAB_DEFAULT_FRAMES, VOCAB_TRAIN_SEEDS, VOCAB_DEFAULT_WORDS = 60, 4, 8192
VOCAB_SUBSET = 20000
VOCAB_RUN_FRAMES = 60
VOCAB_RUN_TRACKED_MIN = 58
# the multichip phase: the sharded global BA at full width against the PCG
# solver and the single-device Schur LM (the same algorithm unsharded) on the
# same problem: the total chi2 within 0.5 % of the PCG's (0.04-0.06 % apart on
# the H100), and each keyframe's robust chi2 (the sum over its observations)
# within 1 % of the LM's and the PCG's. Per keyframe is what tells a finished
# solve: on the CPU the sharded solve is 3e-4 from the LM, the PCG 3.5e-3,
# the sharded solve stopped after 10 of 20 iterations 2.1e-2, the start 79.
# Poses and points are reported, not held: one camera is held, so the
# monocular scale gauge is free, and solves at equal chi2 end apart along it
# by as much as the start is from them, by an amount the card's atomics
# change run to run. The sharded pose graph against the single-device one
# (tests/test_sharded_pose_graph.py's bounds) and the NCCL world of one
# against the single-device BA (tests/multihost_worker.py's bound)
GBA_CHI2_REL = 5e-3
GBA_KF_CHI2_REL = 1e-2
EG_T_TOL, EG_S_TOL = 2e-3, 1e-4
MULTIHOST_TOL = 5e-4


def log(msg: str):
    print(msg, flush=True)


@contextlib.contextmanager
def _patch(obj, name, make):
    """`obj.name = make(obj.name)` for the block, put back after it: the
    attribute of the object itself, or none there (a method of its class)."""
    own = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


def _reads() -> int:
    """The device -> host reads made so far (the tracer's counter `reads`)."""
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    return get_tracer().counts["reads"]


def _labelled(torch, label, reads=None):
    """make(orig): `orig` run inside a torch.profiler range named `label`
    (`_launches_in` counts the host's launches made inside such ranges);
    with `reads` (a list), the batched host reads of each call are
    appended to it."""

    def make(orig):
        def wrapped(*a, **k):
            r0 = _reads()
            with torch.profiler.record_function(label):
                out = orig(*a, **k)
            if reads is not None:
                reads.append(_reads() - r0)
            return out
        return wrapped
    return make


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build(fast_cuda):
    """The four CUDA sources of the main path, one nvcc each, started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from orbslam_jpminipc_torch.ops import pose_lm_cuda, small_linalg_cuda
    from orbslam_jpminipc_torch.utils import graph_chain

    t0 = time.perf_counter()
    libs = (fast_cuda, graph_chain, small_linalg_cuda, pose_lm_cuda)
    with ThreadPoolExecutor(len(libs)) as pool:
        for job in [pool.submit(lib.build) for lib in libs]:
            job.result()
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.library_path().name for lib in libs)} in {dt:.2f} s")
    for line in (fast_cuda.build_log + small_linalg_cuda.build_log
                 + pose_lm_cuda.build_log).splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "entry function" in line:
            log(f"[build] {line.strip()}")
    return dt


def _event_ms(torch, fn, n=20, batch=10, warm=5):
    """Median over n batches of the per-call time of `batch` back-to-back
    calls between two CUDA events (host launch cost included)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _is_device_event(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _device_time_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def _device_ms(torch, fn, n=10):
    """Device (kernel) time per call from torch.profiler, launch gaps
    excluded. A window whose kernel count is no multiple of the calls made
    has lost events (seen once: a frame's one launch read as 0.0065 ms,
    0.0178 in the calls before and after) and is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if _is_device_event(e)]
        if kernels and sum(e.count for e in kernels) % n == 0:
            break
    return sum(_device_time_us(e) for e in kernels) / n / 1e3


def phase_kernel(torch, fast, fast_cuda, pyramid, fx):
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    levels = pyramid.build_pyramid(
        torch.as_tensor(fx["images"][0]).to(dev).float(), 8, 1.2)
    if [tuple(l.shape) for l in levels] != LEVEL_SHAPES:
        raise AssertionError(f"pyramid shapes {[tuple(l.shape) for l in levels]}")

    def plain(img, th, border):
        return fast.border_mask(fast.nonmax_3x3(fast.fast_score_map(img, th)), border)

    n_cmp, max_err = 0, 0.0
    for (h, w), lvl in zip(LEVEL_SHAPES, levels):
        ramp = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w).contiguous()
        cases = {
            "random_u8": torch.randint(0, 256, (h, w), generator=gen, device=dev).float(),
            "random_f32": torch.rand((h, w), generator=gen, device=dev) * 255.0,
            "pyramid": lvl.contiguous(),
            "ramp": ramp,
        }
        for name, img in cases.items():
            for th in (7.0, 20.0):
                for border in (0, 19):
                    got = fast_cuda.fast_detect(img, th, border)
                    ref = plain(img, th, border)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    max_err = max(max_err, err)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"FAST kernel != plain at {(h, w)} {name} th={th} "
                            f"border={border}: max abs err {err}, "
                            f"{int((got != ref).sum())} pixels differ")
                    n_cmp += 1
        ramp_score = fast_cuda.fast_detect(ramp, 7.0, 0)
        if bool((ramp_score[5:-5, 5:-5] != 0).any()):
            raise AssertionError(f"corners on a smooth ramp at {(h, w)}")
    log(f"[kernel] {n_cmp} one-level comparisons torch.equal, max abs err {max_err}")

    per_level = []
    for (h, w), lvl in zip(LEVEL_SHAPES, levels):
        img = lvl.contiguous()
        kern = lambda: fast_cuda.fast_detect(img, 7.0, EDGE)
        ref = lambda: plain(img, 7.0, EDGE)
        row = {"shape": [h, w],
               "plain_ms": _event_ms(torch, ref, n=10, batch=5),
               "ms": _event_ms(torch, kern)}
        row["device_ms"] = _device_ms(torch, kern)
        row["plain_device_ms"] = _device_ms(torch, ref, n=5)
        per_level.append(row)
        log(f"[kernel] {h}x{w} alone: kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms (device "
            f"{row['plain_device_ms']:.4f})")

    # --- all levels in one launch, with the per-cell select ---------------
    def plain_levels(lv, fast_th, fast_min_th, border, cell=32):
        return [fast.cell_select(plain(l, fast_min_th, border), fast_th, cell) for l in lv]

    def mixed(h, w):
        # strong corners left, weak ones (between the thresholds) in the
        # middle, flat right: cells with and without a high corner
        img = torch.full((h, w), 128.0, device=dev)
        a, b = w // 3, 2 * w // 3
        img[:, :a] = torch.randint(0, 256, (h, a), generator=gen, device=dev).float()
        img[:, a:b] += torch.randint(-6, 7, (h, b - a), generator=gen, device=dev).float()
        return img

    level_sets = {
        "pyramid": [l.contiguous() for l in levels],
        "random": [torch.rand((h, w), generator=gen, device=dev) * 255.0 for h, w in LEVEL_SHAPES],
        "mixed": [mixed(h, w) for h, w in LEVEL_SHAPES],
    }
    n_multi, both_arms = 0, False
    for name, lv in level_sets.items():
        for fast_th, fast_min_th in ((20.0, 7.0), (7.0, 7.0)):
            ref = plain_levels(lv, fast_th, fast_min_th, EDGE)
            lo = [plain(l, fast_min_th, EDGE) for l in lv]
            n0 = fast_cuda.LAUNCHES
            got = fast_cuda.fast_level_scores(lv, fast_th, fast_min_th, EDGE, 32)
            if fast_cuda.LAUNCHES != n0 + 1:
                raise AssertionError("fast_level_scores did not launch exactly once")
            torch.cuda.synchronize()
            for k, (g, r) in enumerate(zip(got, ref)):
                err = float((g - r).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"one launch != plain on {name} level {k} ths "
                        f"{(fast_th, fast_min_th)}: max abs err {err}, "
                        f"{int((g != r).sum())} pixels differ")
            n_multi += 1
            single = [fast_cuda.fast_level_scores([l], fast_th, fast_min_th, EDGE, 32)[0]
                      for l in lv]
            other_cell = fast_cuda.fast_level_scores(lv, fast_th, fast_min_th, EDGE, 16)
            torch.cuda.synchronize()
            if not all(torch.equal(g, o) for g, o in zip(got, single)):
                raise AssertionError(f"one launch != 8 one-level launches on {name}")
            if not all(torch.equal(g, r) for g, r in zip(
                    other_cell, plain_levels(lv, fast_th, fast_min_th, EDGE, 16))):
                raise AssertionError(f"cell 16 != plain on {name}")
            if name == "mixed" and fast_th > fast_min_th:
                # the vote's two arms: low corners dropped from a cell
                # with a high corner, and kept in a cell without one
                dropped = any(bool(((l > 0) & (g == 0)).any()) for g, l in zip(got, lo))
                kept = any(bool(((l > 0) & (l + 1.0 <= fast_th) & (g > 0)).any())
                           for g, l in zip(got, lo))
                both_arms = dropped and kept
    if not both_arms:
        raise AssertionError("the cell vote did not take both arms on the mixed frame")
    log(f"[kernel] {n_multi} one-launch comparisons torch.equal, one launch == 8 launches, "
        f"cell 16 == plain, both arms of the vote taken")

    # --- times per frame, on the fixture's pyramid -------------------------
    lv = level_sets["pyramid"]
    one = lambda: fast_cuda.fast_level_scores(lv, 20.0, 7.0, EDGE, 32)
    eight = lambda: [fast_cuda.fast_level_scores([l], 20.0, 7.0, EDGE, 32) for l in lv]
    ref = lambda: plain_levels(lv, 20.0, 7.0, EDGE)
    frame = {
        "ms": _event_ms(torch, one),
        "device_ms": _device_ms(torch, one),
        "eight_launches_ms": _event_ms(torch, eight),
        "eight_launches_device_ms": _device_ms(torch, eight),
        "plain_ms": _event_ms(torch, ref, n=10, batch=5),
        "plain_device_ms": _device_ms(torch, ref, n=5),
    }
    frame.update(_fast_bound(lv))
    log(f"[kernel] per frame (8 levels, select included): one launch {frame['ms']:.4f} ms "
        f"(device {frame['device_ms']:.4f}), 8 one-level launches "
        f"{frame['eight_launches_ms']:.4f} ms (device {frame['eight_launches_device_ms']:.4f}), "
        f"plain {frame['plain_ms']:.4f} ms (device {frame['plain_device_ms']:.4f}); bound "
        f"{frame['bound_ms']:.5f} ms by {frame['bound_by']} ({frame['pixels']} pixels, "
        f"{frame['bytes']} bytes, {frame['operations']} operations)")
    return {"comparisons": n_cmp + n_multi, "max_abs_err": max_err, "frame": frame,
            "per_level": per_level}


def _fast_bound(levels):
    """The least time the card could take for one frame's score maps: each
    pixel read once and written once as float32 over the memory rate, or
    FAST_OPS_PER_PIXEL operations a pixel over the peak float32 rate,
    whichever is larger. The work does not depend on the data."""
    pixels = sum(l.numel() for l in levels)
    ops = pixels * FAST_OPS_PER_PIXEL
    n_bytes = pixels * 2 * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"pixels": pixels, "bytes": n_bytes, "operations": ops,
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---- the small-matrix Jacobi kernel (csrc/small_linalg.cu) -------------------

SL_TOL = 5e-6           # invariants, relative to |A| (tests/test_torch_small_linalg.py: 2e-6 on the CPU)


def _sl_flops(kind, n, sweeps):
    """The operations of `sweeps` matrix-sweeps (solvers/small_linalg.py:
    SWEEPS): per round of a sweep, m / 2 rotations (~25 operations each,
    sqrt and divisions counted as one) applied to A's and V's columns and
    A's rows (eigh: 9 m^2), or to U's n-row and V's m-row columns after
    three n-long dot products (svd); m - 1 rounds a sweep, m = n rounded up
    to even. The kernel runs every pair of a round, rotating or not."""
    m = n + n % 2
    per_round = (9 * m * m + 25 * m // 2) if kind == "eigh" else (m // 2) * (6 * n + 25 + 6 * n + 6 * m)
    return sweeps * (m - 1) * per_round


def _sl_bound(kind, batch, n, sweeps):
    """The least time for one call: its input read once and its outputs
    written once as float32 over the memory rate, or its operations
    (`_sl_flops`, from the plain version's sweeps on the same input) over
    the float32 rate, whichever is larger."""
    out = batch * (n + n * n) if kind == "eigh" else batch * (2 * n * n + n)
    n_bytes = 4 * (batch * n * n + out)
    ops = _sl_flops(kind, n, sweeps)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": ops, "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sl_main_path_calls(torch):
    """The small-matrix calls of the main path's solvers, recorded from one
    call each on the card on seeded scenes: `solve_pnp` (256 hypotheses
    over 1000 points, 600 on a pose; a relocalization candidate's RANSAC),
    `solve_sim3` (128 hypotheses over 300 pairs) and `initialize` (200
    hypotheses over 600 matches of two views). Each call: (site, kind, its
    input, its keyword arguments)."""
    from orbslam_jpminipc_torch.solvers import epnp, initializer, pnp, sim3solver

    calls, site = [], {"now": None}

    def recorder(fn, kind):
        def wrapped(A, *a, **kw):
            # as a flat batch of matrices (EPnP's four beta cases come stacked)
            calls.append((site["now"], kind, A.detach().reshape(-1, *A.shape[-2:]).clone(), kw))
            return fn(A, *a, **kw)
        return wrapped

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = "cuda"
    K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev)
    rnd = lambda *s: torch.rand(s, generator=gen, device=dev)
    stack = contextlib.ExitStack()
    for mod, names in ((epnp, ("eigh_small", "svd_small")), (sim3solver, ("eigh_small",)),
                       (initializer, ("eigh_small", "svd_small"))):
        for name in names:
            stack.enter_context(_patch(mod, name, lambda f, kind=name.split("_")[0]: recorder(f, kind)))
    with stack, torch.no_grad():
        # PnP: points in front of the camera, 600 of 1000 on the pose
        xw = rnd(1000, 3) * 2 - 1 + torch.tensor([0.0, 0.0, 4.0], device=dev)
        uv = 500.0 * xw[:, :2] / xw[:, 2:] + torch.tensor([320.0, 240.0], device=dev)
        mask = torch.arange(1000, device=dev) < 600
        uv = torch.where(mask[:, None], uv, uv + 40.0)
        site["now"] = "solve_pnp"
        pnp.solve_pnp(pnp.sample_minimal_sets(mask, pnp.N_HYP, gen), xw, uv, mask, K4,
                      torch.full((1000,), 5.991, device=dev))
        # Sim3: camera-1 points and their images in two views under a Sim3
        p1 = rnd(300, 3) * 2 - 1 + torch.tensor([0.0, 0.0, 5.0], device=dev)
        ang = torch.tensor(0.1, device=dev)
        c, s_ = torch.cos(ang), torch.sin(ang)
        z0, o1 = torch.zeros((), device=dev), torch.ones((), device=dev)
        R = torch.stack([torch.stack([c, -s_, z0]), torch.stack([s_, c, z0]),
                         torch.stack([z0, z0, o1])])
        p2 = (0.8 * (p1 - torch.tensor([0.1, 0.0, 0.2], device=dev))) @ R
        pmask = torch.arange(300, device=dev) < 250
        proj = lambda p: 500.0 * p[:, :2] / p[:, 2:] + torch.tensor([320.0, 240.0], device=dev)
        gate = torch.full((300,), 9.21, device=dev)
        site["now"] = "solve_sim3"
        sim3solver.solve_sim3(sim3solver.sample_minimal_sets(pmask, sim3solver.N_HYP, gen),
                              p1, p2, proj(p1), proj(p2), pmask, K4, gate, gate)
        # two views of 600 points: frame 1 at the origin, frame 2 moved
        X = rnd(600, 3) * 4 - 2 + torch.tensor([0.0, 0.0, 6.0], device=dev)
        t2 = torch.tensor([0.4, 0.05, 0.0], device=dev)
        site["now"] = "initialize"
        initializer.initialize(initializer.sample_minimal_sets(gen, torch.ones(600, dtype=torch.bool, device=dev), 200),
                               proj(X), proj(X @ R.T + t2), torch.ones(600, dtype=torch.bool, device=dev), K4)
    torch.cuda.synchronize()
    return calls


def _sl_degenerate(torch):
    """Inputs the scenes above may not reach: repeated eigenvalues (12x12),
    coplanar point scatters (3x3, LAPACK signs), a planar set's C (rank 3
    under the 1e-6 cut), and NaN rows (12x12 and 3x3)."""
    g = np.random.default_rng(12)
    Q = np.linalg.qr(g.normal(size=(16, 12, 12)))[0]
    lam = np.concatenate([[1.0, 1.0, 1.0], 2.0 + np.arange(9)])
    rep = ((Q * lam) @ np.swapaxes(Q, 1, 2)).astype(np.float32)
    pts = g.normal(size=(64, 12, 3))
    pts[..., 2] = 0.3 * pts[..., 0] - 0.2 * pts[..., 1]
    d = pts - pts.mean(1, keepdims=True)
    cop = np.einsum("bmi,bmj->bij", d, d).astype(np.float32)
    C = []
    for _ in range(32):
        p = g.normal(size=(12, 3)) * [2.0, 1.5, 1.0] + [0.1, -0.2, 4.0]
        p[:, 2] = 4.0
        c0 = p.mean(0)
        lam3, vec = np.linalg.eigh((p - c0).T @ (p - c0))
        k = np.sqrt(np.maximum(lam3, 1e-12) / 12)
        ctrl = np.concatenate([c0[None], c0 + (k[::-1, None] * vec.T[::-1])])
        C.append(np.concatenate([ctrl.T, np.ones((1, 4))]))
    C = np.array(C, np.float32)
    nan12 = rep[:8].copy()
    nan12[[2, 5], 3, 4] = np.nan
    nan3 = g.normal(size=(8, 3, 3)).astype(np.float32)
    nan3[[1, 6], 0, 0] = np.nan
    t = lambda a: torch.as_tensor(a).cuda()
    return [("repeated", "eigh", t(rep), {}), ("coplanar", "eigh", t(cop), {"lapack_signs": True}),
            ("planar_C", "svd", t(C), {}), ("nan_rows", "eigh", t(nan12), {}),
            ("nan_rows", "svd", t(nan3), {})]


def _sl_hold(torch, kind, A, kw):
    """The kernel against its plain version and the library in float64 on
    one input: the worst invariant (relative to |A|), and the rank the
    pseudo-inverse keeps where the input is C."""
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k
    from orbslam_jpminipc_torch.solvers import small_linalg as plain

    n = A.shape[-1]
    bad = ~torch.isfinite(A).flatten(-2).all(-1)
    good = ~bad
    A64 = A.double()
    norm = torch.linalg.matrix_norm(A64[good]).clamp_min(1e-30)
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    row = {"batch": int(A.shape[0]), "n": n}
    sweeps0 = dict(plain.SWEEPS)
    if kind == "eigh":
        w, V = (x.double() for x in k.eigh_small(A, **kw))
        wp, Vp = (x.double() for x in plain.eigh_small(A, **kw))
        row["sweeps"] = plain.SWEEPS["eigh"] - sweeps0["eigh"]
        Ag, wg, Vg = A64[good], w[good], V[good]
        res = (torch.linalg.matrix_norm(Ag @ Vg - Vg * wg[:, None, :]) / norm).max()
        orth = (Vg.mT @ Vg - eye).abs().amax((-2, -1)).max()
        wl = torch.linalg.eigvalsh(Ag)
        apart = _sl_apart(torch, wl, norm, Vp[good], kw.get("lapack_signs", False))
        row.update(residual=float(res), orthogonality=float(orth),
                   dw_plain=float(((wg - wp[good]).abs().amax(-1) / norm).max()),
                   dw_library=float(((wg - wl).abs().amax(-1) / norm).max()),
                   **_sl_same(torch.einsum("bij,bij->bj", Vg, Vp[good]), apart))
        out_bad = (~torch.isfinite(w[bad])).all() and (~torch.isfinite(V[bad])).all()
    else:
        U, S, Vt = (x.double() for x in k.svd_small(A))
        Sp, Vtp = (x.double() for x in plain.svd_small(A)[1:])
        row["sweeps"] = plain.SWEEPS["svd"] - sweeps0["svd"]
        Ug, Sg, Vtg = U[good], S[good], Vt[good]
        rec = (torch.linalg.matrix_norm(Ug * Sg[:, None, :] @ Vtg - A64[good]) / norm).max()
        orth = max(float((Ug.mT @ Ug - eye).abs().max()), float((Vtg @ Vtg.mT - eye).abs().max()))
        Sl = torch.linalg.svdvals(A64[good])
        rank = (Sg > 1e-6 * Sg[:, :1]).sum(-1)
        row.update(reconstruction=float(rec), orthogonality=orth,
                   ds_plain=float(((Sg - Sp[good]).abs().amax(-1) / norm).max()),
                   ds_library=float(((Sg - Sl).abs().amax(-1) / norm).max()),
                   rank_1e6=sorted(set(rank.tolist())),
                   rank_equal_plain=bool(torch.equal(rank, (Sp[good] > 1e-6 * Sp[good][:, :1]).sum(-1))),
                   rank_equal_library=bool(torch.equal(rank, (Sl > 1e-6 * Sl[:, :1]).sum(-1))))
        apart = _sl_apart(torch, Sl, norm, Vtp[good].mT, False)
        row.update(_sl_same(torch.einsum("bji,bji->bj", Vtg, Vtp[good]), apart))
        out_bad = (~torch.isfinite(U[bad])).all() and (~torch.isfinite(S[bad])).all()
    row["nan_rows"] = int(bad.sum())
    row["nan_rows_give_nan"] = bool(out_bad) if bad.any() else None
    inv = [v for key, v in row.items() if key in (
        "residual", "orthogonality", "dw_plain", "dw_library", "reconstruction", "ds_plain",
        "ds_library")]
    row["worst"] = max(inv)
    row["ok"] = (row["worst"] <= SL_TOL and row.get("rank_equal_plain", True)
                 and row.get("rank_equal_library", True) and row["nan_rows_give_nan"] is not False
                 and row.get("signs_differ", 0) == 0 and row.get("same_order", True))
    return row


def _sl_same(dots, apart):
    """Order and signs against the plain version, from the dot products of
    each output vector with the plain version's at its position, over the
    columns `_sl_apart` keeps: the same vector (|dot| near 1) and the same
    sign (dot > 0)."""
    d = dots[apart]
    return {"same_order": bool((d.abs() > 0.99).all()), "signs_differ": int((d <= 0).sum()),
            "columns_held": int(apart.sum())}


def _sl_apart(torch, values, norm, vectors, lapack):
    """The columns whose sign convention is decided beyond rounding: the
    value stands apart from the others (1e-3 of |A|: in a cluster the
    vectors are any basis of its space, and two versions' rounding picks
    another) and, under the largest-component rule, that component leads
    the next by 1e-4 (a near tie is decided by rounding)."""
    n = values.shape[-1]
    eye = torch.eye(n, dtype=values.dtype, device=values.device)
    gap = (values[:, :, None] - values[:, None, :]).abs() + eye * 1e30
    apart = gap.amin(-1) > 1e-3 * norm[:, None]
    if not lapack:
        top = vectors.abs().sort(dim=-2, descending=True).values
        if n > 1:
            apart &= top[:, 0] - top[:, 1] > 1e-4
    return apart


def epnp_n1_cost(torch, smi):
    """What EPnP's N = 1 case (its planar departure, solvers/epnp.py) adds on
    every set, planar or not: the poses and reprojection errors of the four
    beta cases against those of the reference's three alone, on a
    relocalization candidate's 256 minimal sets (the scene of
    `_sl_main_path_calls`), device time by torch.profiler; and the whole
    `epnp_pose` on the same sets."""
    from orbslam_jpminipc_torch.solvers import epnp, pnp

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    xw = (torch.rand((1000, 3), generator=gen, device=dev) * 2 - 1
          + torch.tensor([0.0, 0.0, 4.0], device=dev))
    uv = 500.0 * xw[:, :2] / xw[:, 2:] + torch.tensor([320.0, 240.0], device=dev)
    mask = torch.arange(1000, device=dev) < 600
    sets = pnp.sample_minimal_sets(mask, pnp.N_HYP, gen)
    xs, us = xw[sets], uv[sets]
    w = torch.ones(sets.shape, device=dev)
    K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev)
    with torch.no_grad():
        V, alphas, betas, planar = epnp._beta_cases(xs, us, w, K4)
        three = _device_ms(torch, lambda: epnp._pose_errors(betas[:3], V, alphas, xs, us, w, K4), n=5)
        four = _device_ms(torch, lambda: epnp._pose_errors(betas, V, alphas, xs, us, w, K4), n=5)
        whole = _device_ms(torch, lambda: epnp.epnp_pose(xs, us, w, K4), n=5)
    res = {"sets": int(sets.shape[0]), "planar_sets": int(planar.sum()),
           "three_cases_device_ms": three, "four_cases_device_ms": four,
           "added_device_ms": four - three, "epnp_pose_device_ms": whole}
    log(f"[kernel] {smi}: EPnP's N = 1 case on {res['sets']} minimal sets ({res['planar_sets']} "
        f"planar): the cases' poses and errors {four:.4f} ms of device time against {three:.4f} "
        f"for the reference's three (+{four - three:.4f} ms); the whole epnp_pose {whole:.4f} ms")
    return res


def kernel_small_linalg(torch, smi):
    """`small_linalg` on the card: every call of the main path's solvers
    (`_sl_main_path_calls`) and the degenerate inputs held to the plain
    version and to torch.linalg in float64 (`_sl_hold`); then the calls of
    one `solve_pnp` (a relocalization candidate's EPnP, 8 launches) timed
    as one: the kernel (CUDA events, and the profiler's device time), the
    plain version, the library call on the same float32 inputs
    (`library_ms`: torch.linalg.eigh / svd / pinv, which also read the host)
    and the bound (`_sl_bound`, from the plain version's sweeps)."""
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k
    from orbslam_jpminipc_torch.solvers import small_linalg as plain

    calls = _sl_main_path_calls(torch)
    rows = []
    for site, kind, A, kw in calls + _sl_degenerate(torch):
        row = _sl_hold(torch, kind, A, kw)
        row.update(site=site, kind=kind, **{k_: v for k_, v in kw.items()})
        row.update(_sl_bound(kind, row["batch"], row["n"], row["sweeps"]))
        rows.append(row)
    shapes = sorted({(r["site"], r["kind"], r["n"], r["batch"]) for r in rows})
    log(f"[kernel] small_linalg: {len(rows)} calls held against the plain version and "
        f"torch.linalg in float64 (bound {SL_TOL} of |A|), shapes {shapes}: "
        f"{json.dumps(rows)}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"[kernel] small_linalg off its plain version: {bad}")
    pnp_calls = [(kind, A, kw) for site, kind, A, kw in calls if site == "solve_pnp"]

    def kernel_all():
        for kind, A, kw in pnp_calls:
            (k.eigh_small if kind == "eigh" else k.svd_small)(A, **kw)

    def plain_all():
        for kind, A, kw in pnp_calls:
            (plain.eigh_small if kind == "eigh" else plain.svd_small)(A, **kw)

    def library_all():
        for kind, A, kw in pnp_calls:
            (torch.linalg.eigh if kind == "eigh" else torch.linalg.svd)(A)

    bound = [r for r in rows if r["site"] == "solve_pnp"]
    res = {
        "calls": rows, "shapes": [list(s) for s in shapes],
        "max_abs_err": max(r["worst"] for r in rows),
        "candidate_launches": len(pnp_calls),
        "ms": _event_ms(torch, kernel_all, n=10, batch=5, warm=3),
        "device_ms": _device_ms(torch, kernel_all, n=5),
        "plain_ms": _event_ms(torch, plain_all, n=3, batch=1, warm=1),
        "library_ms": _event_ms(torch, library_all, n=5, batch=2, warm=2),
        "bound_ms": sum(r["bound_ms"] for r in bound),
        "bytes": sum(r["bytes"] for r in bound), "operations": sum(r["operations"] for r in bound),
    }
    res["bound_by"] = ("bytes" if sum(r["bytes_ms"] for r in bound)
                       >= sum(r["operations_ms"] for r in bound) else "operations")
    per_site = {}
    for site, kind, A, kw in calls:
        f = lambda A=A, kw=kw, kind=kind: (k.eigh_small if kind == "eigh" else k.svd_small)(A, **kw)
        key = f"{site} {kind} {A.shape[-1]}x{A.shape[-1]} x{A.shape[0]}"
        per_site.setdefault(key, []).append(_event_ms(torch, f, n=5, batch=5, warm=2))
    res["ms_by_call"] = per_site
    log(f"[kernel] {smi}: small_linalg, one solve_pnp's {len(pnp_calls)} calls (256 hypotheses "
        f"and the refit): kernel {res['ms']:.4f} ms (device {res['device_ms']:.4f}), plain "
        f"{res['plain_ms']:.3f} ms, torch.linalg {res['library_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.6f} ms ({res['bound_by']}); worst invariant {res['max_abs_err']:.3g}; "
        f"ms by call {json.dumps(per_site)}")
    return res


# ---- the pose LM kernel (csrc/pose_lm.cu) -------------------------------------

PLM_POSE_TOL = 1e-5      # R and t against the plain version (tests/test_torch_pose_lm.py)
PLM_GATE_REL = 1e-4      # an edge this close to its gate may fall either way
PLM_DIFFER_MAX = 1       # such edges a call


def _plm_calls(torch, fx, FusedContext, SlamConfig):
    """The pose LM calls of the main path, recorded on the card: the step's
    two passes (2 and 4 rounds) on fixture frame 0, the step run eagerly
    from the fixture's seed, and one relocalization candidate's LM on a
    seeded scene (EPnP RANSAC over 1000 points, 600 on the pose, then 4
    rounds on its inliers, as `_reloc_candidate_prog`). Each call: (site,
    its arguments, its keyword arguments)."""
    from orbslam_jpminipc_torch.solvers import pnp, pose_opt

    calls, site = [], {"now": None}

    def recorder(fn):
        def wrapped(*a, **kw):
            calls.append((site["now"], [x.detach().clone() for x in a], dict(kw)))
            return fn(*a, **kw)
        return wrapped

    ctx = _context(FusedContext, SlamConfig, fx)
    _seed(ctx, fx)
    image = torch.as_tensor(fx["images"][0]).cuda()
    with _patch(pose_opt, "optimize_pose", recorder), torch.no_grad():
        site["now"] = "step"
        ctx.step(image, ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel, ctx.slice)
        dev = "cuda"
        gen = torch.Generator(device=dev).manual_seed(5)
        K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev)
        xw = torch.rand((1000, 3), generator=gen, device=dev) * 2 - 1 + torch.tensor(
            [0.0, 0.0, 4.0], device=dev)
        uv = 500.0 * xw[:, :2] / xw[:, 2:] + torch.tensor([320.0, 240.0], device=dev)
        mask = torch.arange(1000, device=dev) < 600
        uv = torch.where(mask[:, None], uv, uv + 40.0)
        res = pnp.solve_pnp(pnp.sample_minimal_sets(mask, pnp.N_HYP, gen), xw, uv, mask, K4,
                            torch.full((1000,), 5.991, device=dev))
        site["now"] = "reloc_candidate"
        pose_opt.optimize_pose(res.R, res.t, xw, uv, torch.ones(1000, device=dev),
                               mask & res.inliers, K4)
    torch.cuda.synchronize()
    return calls


def _plm_hold(torch, args, kw):
    """The kernel against the plain version on one call's inputs."""
    from orbslam_jpminipc_torch.ops import pose_lm_cuda as k
    from orbslam_jpminipc_torch.solvers import pose_opt
    from orbslam_jpminipc_torch.solvers.reproj import residuals

    got = k.optimize_pose(*args, **kw)
    again = k.optimize_pose(*args, **kw)
    ref = pose_opt.optimize_pose_plain(*args, **kw)
    torch.cuda.synchronize()
    differ = got.inliers != ref.inliers
    e, _ = residuals(got.R, got.t, args[2], args[3], args[6])
    c = torch.sum(e * e, -1) * args[4]
    gate = pose_opt._CHI2_GATES[kw.get("n_rounds", 4) - 1]
    near = (c - gate).abs() <= PLM_GATE_REL * gate
    row = {"n": int(args[2].shape[0]), "n_rounds": kw.get("n_rounds", 4),
           "valid": int(args[5].sum()),
           "dR": float((got.R - ref.R).abs().max()), "dt": float((got.t - ref.t).abs().max()),
           "inliers": int(got.n_inliers), "plain_inliers": int(ref.n_inliers),
           "differ": int(differ.sum()), "differ_off_gate": int((differ & ~near).sum()),
           "chi2": float(got.chi2), "plain_chi2": float(ref.chi2),
           "equal_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again))}
    row["ok"] = (max(row["dR"], row["dt"]) <= PLM_POSE_TOL and row["differ"] <= PLM_DIFFER_MAX
                 and row["differ_off_gate"] == 0 and row["equal_bits_twice"])
    return row


def kernel_pose_lm(torch, smi, fx, FusedContext, SlamConfig):
    """`pose_lm` on the card: the kernel against its plain version on the
    main path's calls (`_plm_calls`: R and t within PLM_POSE_TOL, the same
    inliers but edges at a gate, equal bits twice), then the step's pass 2
    (1000 rows, 4 rounds) and pass 1 (2 rounds) timed: the kernel (CUDA
    events, and the profiler's device time), its launches, the plain
    version (`pose_opt.optimize_pose_plain`). No PyTorch call computes the
    function (`library_ms` null). The bound is a latency floor, not bytes
    or operations (csrc/pose_lm.cu's header; PERF.md section 6)."""
    from orbslam_jpminipc_torch.ops import pose_lm_cuda as k
    from orbslam_jpminipc_torch.solvers import pose_opt

    calls = _plm_calls(torch, fx, FusedContext, SlamConfig)
    rows = []
    for site, args, kw in calls:
        row = _plm_hold(torch, args, kw)
        row["site"] = site
        rows.append(row)
    log(f"[kernel] pose_lm: {len(rows)} calls held against the plain version "
        f"(R, t within {PLM_POSE_TOL}): {json.dumps(rows)}")
    bad = [r for r in rows if not r["ok"]]
    if bad or [r["n_rounds"] for r in rows] != [2, 4, 4]:
        raise AssertionError(f"[kernel] pose_lm off its plain version: {rows}")
    res = {"calls": rows, "max_abs_err": max(max(r["dR"], r["dt"]) for r in rows)}
    for (site, args, kw), name in zip(calls[:2], ("pass1", "pass2")):
        n0 = k.LAUNCHES
        kern = lambda: k.optimize_pose(*args, **kw)
        res[name] = {
            "n_rounds": kw.get("n_rounds", 4),
            "ms": _event_ms(torch, kern),
            "device_ms": _device_ms(torch, kern),
            "plain_ms": _event_ms(torch, lambda: pose_opt.optimize_pose_plain(*args, **kw),
                                  n=3, batch=1, warm=1),
        }
        res[name]["launches"] = k.LAUNCHES - n0
    p1, p2 = res["pass1"], res["pass2"]
    res["library_ms"] = None
    log(f"[kernel] {smi}: pose_lm, the step's pass 2 (1000 rows, 4 rounds): kernel "
        f"{p2['ms']:.4f} ms (device {p2['device_ms']:.4f}), plain {p2['plain_ms']:.2f} ms; "
        f"pass 1 (2 rounds): kernel {p1['ms']:.4f} ms (device {p1['device_ms']:.4f}), "
        f"plain {p1['plain_ms']:.2f} ms; worst |dR|, |dt| {res['max_abs_err']:.3g}")
    return res


def _context(FusedContext, SlamConfig, fx):
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000,
                     pipelined_tracking=False)
    ctx = FusedContext(cfg, device="cuda")
    ctx.set_slice(fx["slice_buf"])
    # every program of the step captured before the first frame (the
    # context's part of Slam.warmup)
    ctx.capture()
    return ctx


def _seed(ctx, fx):
    vel = (fx["vel_R0"], fx["vel_t0"]) if bool(fx["has_vel0"]) else None
    ctx.set_pose(fx["R0"], fx["t0"], velocity=vel)


def phase_slice(torch, fast_cuda, FusedContext, SlamConfig, fx):
    ctx = _context(FusedContext, SlamConfig, fx)
    _seed(ctx, fx)
    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    K = len(images)
    from orbslam_jpminipc_torch.ops import pose_lm_cuda

    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = pose_lm_cuda.LAUNCHES = 0
    outs = []
    for k in range(K):
        out = ctx.track(images[k])
        outs.append(out)
    torch.cuda.synchronize()
    launches, lm_launches = fast_cuda.LAUNCHES, pose_lm_cuda.LAUNCHES
    rows = []
    for k, out in enumerate(outs):
        R, t = out.R.cpu().numpy(), out.t.cpu().numpy()
        bind = out.feat_bind.cpu().numpy()
        for name, a in (("R", R), ("t", t), ("xy_un", out.xy_un.cpu().numpy())):
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"non-finite {name} at frame {k}")
        if (R.shape, t.shape, bind.shape, tuple(out.flags.shape)) != (
                (3, 3), (3,), (1000,), (fx["slice_buf"].shape[0],)):
            raise AssertionError(f"output shapes at frame {k}")
        n_inl2 = int(out.n_inl2)
        ref_inl2 = int(fx["out_stats"][k][0])
        row = {
            "frame": k,
            "dR": float(np.abs(R - fx["out_R"][k]).max()),
            "dt": float(np.abs(t - fx["out_t"][k]).max()),
            "bind_eq": float(np.mean(bind == fx["out_feat_bind"][k])),
            "flags_eq": float(np.mean(out.flags.cpu().numpy() == fx["out_flags"][k])),
            "desc_eq": float(np.mean(np.all(
                out.feats.desc.cpu().numpy() == fx["out_desc"][k], axis=1))),
            "stats": [n_inl2, int(out.n_inl1), int(out.n_match2), int(out.n_match1)],
            "ref_stats": fx["out_stats"][k].tolist(),
            "inl2_rel": abs(n_inl2 - ref_inl2) / max(ref_inl2, 1),
        }
        rows.append(row)
        log(f"[slice] frame {k}: dR {row['dR']:.3g} dt {row['dt']:.3g} "
            f"bind_eq {row['bind_eq']:.4f} desc_eq {row['desc_eq']:.4f} "
            f"stats {row['stats']} ref {row['ref_stats']}")
    worst = {
        "dR": max(r["dR"] for r in rows), "dt": max(r["dt"] for r in rows),
        "bind_eq": min(r["bind_eq"] for r in rows),
        "inl2_rel": max(r["inl2_rel"] for r in rows),
    }
    log(f"[slice] worst over {K} frames: {json.dumps(worst)}; FAST launches {launches}, "
        f"pose LM launches {lm_launches}")
    if launches != K:
        raise AssertionError(f"FAST kernel launched {launches} times, expected {K} "
                             f"(one launch per frame)")
    if lm_launches != 2 * K:
        raise AssertionError(f"pose LM kernel launched {lm_launches} times, expected {2 * K} "
                             f"(pass 1 and pass 2 a frame)")
    if max(worst["dR"], worst["dt"]) > TOL_POSE:
        raise AssertionError(f"pose off the reference by {worst}")
    if worst["bind_eq"] < TOL_BIND or worst["inl2_rel"] > TOL_INLIERS:
        raise AssertionError(f"bindings off the reference: {worst}")
    recovery = _recovery_frame(torch, ctx, images[0], fx)
    return {"frames": K, "fast_launches": launches, "pose_lm_launches": lm_launches,
            "worst": worst, "rows": rows, "recovery": recovery}


def _recovery_frame(torch, ctx, image, fx):
    """One step from the system fixture's perturbed seed pose: pass 1 must
    collapse, the wide recovery pass run, and the result agree with the
    reference's outputs for that frame. The step's pass 1 count is its
    recovery test's read; the kept count (`n_inl1`) is then the recovery
    pass's."""
    sf = dict(np.load(SLAM_FIXTURE))
    ctx.set_pose(sf["recovery_R0"], sf["recovery_t0"], velocity=(fx["vel_R0"], fx["vel_t0"]))
    out = ctx.track(image)
    inliers = [ctx.last_pass1_inliers, int(out.n_inl1)]
    stats = [int(out.n_inl2), int(out.n_inl1), int(out.n_match2), int(out.n_match1)]
    ref = sf["recovery_out_stats"].tolist()
    row = {
        "pass_inliers": inliers, "stats": stats, "ref_stats": ref,
        "dR": float(np.abs(out.R.cpu().numpy() - sf["recovery_out_R"]).max()),
        "dt": float(np.abs(out.t.cpu().numpy() - sf["recovery_out_t"]).max()),
        "bind_eq": float(np.mean(out.feat_bind.cpu().numpy() == sf["recovery_out_feat_bind"])),
    }
    log(f"[slice] recovery frame: {json.dumps(row)}")
    if not inliers[0] < 20 <= inliers[1]:
        raise AssertionError(f"the recovery pass did not run as expected: {inliers}")
    if max(row["dR"], row["dt"]) > TOL_POSE or row["bind_eq"] < TOL_BIND:
        raise AssertionError(f"recovery frame off the reference: {row}")
    if abs(stats[0] - ref[0]) > TOL_INLIERS * ref[0]:
        raise AssertionError(f"recovery frame inliers off the reference: {row}")
    return row


def phase_throughput(torch, FusedContext, SlamConfig, fx, n_steps=100):
    ctx = _context(FusedContext, SlamConfig, fx)
    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    K = len(images)
    _seed(ctx, fx)
    for k in range(3):  # warm
        ctx.track(images[k])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    t_all = time.perf_counter()
    for i in range(n_steps):
        if i % K == 0:
            _seed(ctx, fx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.track(images[i % K])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    res = {
        "steps": n_steps,
        "p50_ms": float(np.percentile(times, 50)),
        "p95_ms": float(np.percentile(times, 95)),
        "mean_ms": float(np.mean(times)),
        "fps": n_steps / wall,
        "peak_mem_bytes": int(peak),
    }
    log(f"[throughput] {n_steps} steps: {json.dumps(res)}")
    return res


def phase_breakdown(torch, fx, FusedContext, SlamConfig):
    from orbslam_jpminipc_torch.ops import extractor, fast, matching, pyramid
    from orbslam_jpminipc_torch.solvers import pose_opt

    ctx = _context(FusedContext, SlamConfig, fx)
    _seed(ctx, fx)
    img = torch.as_tensor(fx["images"][0]).cuda().float()
    slc = ctx.slice
    feats = extractor.extract(img)
    levels = pyramid.build_pyramid(img, 8, 1.2)
    m = slc.desc.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    uv = torch.rand((m, 2), generator=gen, device="cuda") * torch.tensor(
        [640.0, 480.0], device="cuda")
    pred = torch.randint(0, 8, (m,), generator=gen, device="cuda", dtype=torch.int32)
    sf = ctx.step.scale_factors
    xw = slc.xyz[:1000]
    valid = torch.ones(1000, dtype=torch.bool, device="cuda")

    def host_ms(fn, n=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    parts = {
        "pyramid": host_ms(lambda: pyramid.build_pyramid(img, 8, 1.2)),
        "fast_8_levels": host_ms(lambda: fast.level_scores(levels, 20.0, 7.0, EDGE, 32)),
        "extract": host_ms(lambda: extractor.extract(img)),
        "search_by_projection_4096x1000": host_ms(lambda: matching.search_by_projection(
            slc.desc, uv, pred, slc.max_dist > 0, feats.desc, feats.xy, feats.level,
            feats.valid, sf, 4.0, level_window=(-1, 1))),
        # on the card `optimize_pose` is the kernel (ops/pose_lm_cuda.py)
        "optimize_pose_4_rounds_1000": host_ms(lambda: pose_opt.optimize_pose(
            ctx.R, ctx.t, xw, feats.xy, torch.ones(1000, device="cuda"), valid,
            ctx.step.K4)),
        "optimize_pose_plain_4_rounds_1000": host_ms(lambda: pose_opt.optimize_pose_plain(
            ctx.R, ctx.t, xw, feats.xy, torch.ones(1000, device="cuda"), valid,
            ctx.step.K4), n=3, warm=1),
    }
    log(f"[breakdown] ms (host clock, synchronised): {json.dumps(parts)}")

    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    from torch.profiler import ProfilerActivity, profile

    _seed(ctx, fx)
    ctx.track(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(1, 1 + min(10, len(images) - 1)):
            ctx.track(images[k])
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if _is_device_event(e)]
    dev_us = sum(_device_time_us(e) for e in kernels)
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    n_steps = min(10, len(images) - 1)
    prof_res = {
        "steps": n_steps,
        "wall_us_profiled": wall_us,
        "device_us": dev_us,
        "device_ms_per_step": dev_us / n_steps / 1e3,
        "kernels_per_step": sum(e.count for e in kernels) / n_steps,
        "host_launches_per_step": _launch_counts(prof, n_steps)["host_launches_per_call"],
        "top_kernels": [
            {"name": e.key, "device_us": _device_time_us(e), "count": e.count}
            for e in top],
    }
    log(f"[breakdown] profiler: {prof_res['device_ms_per_step']:.2f} ms of "
        f"kernel time and {prof_res['kernels_per_step']:.0f} kernels per step, "
        f"{prof_res['host_launches_per_step']:.1f} launches from the host "
        f"(wall under the profiler {wall_us / 1e3:.1f} ms for {n_steps} steps)")
    for e in prof_res["top_kernels"][:8]:
        log(f"[breakdown]   {e['device_us'] / 1e3:9.3f} ms x{e['count']:5d}  {e['name'][:90]}")
    return {"layers_ms": parts, "profile": prof_res}


# host calls that put work on the card (torch.profiler's CUDA runtime events)
_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy2DAsync")


def _launch_counts(prof, n):
    """Per call over a profiled window of `n` calls: the host's calls that
    put work on the card, by name (a graph replay is one `cudaGraphLaunch`),
    and the device's kernels and copies with their time."""
    host, device, dev_us = {}, 0, 0.0
    for e in prof.key_averages():
        if _is_device_event(e):
            device += e.count
            dev_us += _device_time_us(e)
        else:
            base = e.key.split("_v")[0]
            if base in _LAUNCH_APIS:
                host[base] = host.get(base, 0) + e.count
    return {"host_launches_per_call": sum(host.values()) / n,
            "host_by_api_per_call": {k: v / n for k, v in sorted(host.items())},
            "device_ops_per_call": device / n, "device_ms_per_call": dev_us / n / 1e3}


def _launches_in(prof, label):
    """Per call labelled `label` (a `record_function` range): the host's
    calls that put work on the card, by name, made inside those ranges."""
    events = [e for e in prof.events() if not _is_device_event(e)]
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == label]
    host = {}
    for e in events:
        base = e.name.split("_v")[0]
        if base in _LAUNCH_APIS and any(a <= e.time_range.start <= b for a, b in spans):
            host[base] = host.get(base, 0) + 1
    n = max(len(spans), 1)
    return {"calls": len(spans), "host_launches_per_call": sum(host.values()) / n,
            "host_by_api_per_call": {k: v / n for k, v in sorted(host.items())}}


def hold_programs(torch, calls, tag):
    """The captured programs against their eager runs on the inputs of a
    real run: each call a `CallLog` kept (its first per program and
    variant), the outputs the caller got (unchanged by the calls after it)
    against the function run eagerly on the same inputs, equal bits; the
    essential graph (atomic scatter-adds) within the larger of
    EG_SPREAD_FACTOR times the largest difference between EG_EAGER_RUNS
    eager runs and EG_ULPS float32 ulps of the leaf's largest entry, leaf
    by leaf. Raises where one is off."""
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves
    rows = []
    for c in calls:
        eg = c.name.startswith("essential_graph")
        with torch.no_grad():
            runs = [leaves(c.eager(*c.inputs)) for _ in range(EG_EAGER_RUNS if eg else 1)]
        got = leaves(c.out)
        kept = all(torch.equal(a, b) for a, b in zip(got, leaves(c.out_copy)))
        equal = all(torch.equal(a, b) for a, b in zip(got, runs[0]))
        row = {"program": c.name, "variant": repr(c.variant), "equal_bits": equal, "kept": kept}
        ok = equal
        if eg:
            gap = lambda a, b: [float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)]
            spread = [max(v) for v in zip(*[gap(a, b) for a in runs for b in runs])]
            ulps = [EG_ULPS * float(torch.finfo(torch.float32).eps) * float(x.abs().max())
                    for x in runs[0]]
            bound = [max(EG_SPREAD_FACTOR * e, u) for e, u in zip(spread, ulps)]
            row.update(diff=gap(got, runs[0]), eager_spread=spread, bound=bound)
            ok = all(d <= b for d, b in zip(row["diff"], bound))
        row["ok"] = ok and kept
        rows.append(row)
    log(f"[graphs] {tag}: {len(rows)} programs captured against eager on the run's inputs: "
        f"{json.dumps(rows)}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"[graphs] {tag}: captured programs off their eager runs: {bad}")
    return rows


def hold_mirror_programs(torch, dm, fn):
    """Run `fn` with the map mirror's stage programs (map/device_map.py)
    held at their first call per shape and variant: right after the replay,
    while the mirror is as it read it, the stage's function runs eagerly on
    the same inputs. Equal bits for the triangulation, fusion, attrs and
    slice programs; the local BA (index_add_ atomics) within GRAPH_BA_CHI2_REL
    of the eager chi2 and GRAPH_BA_FLAG_SHARE of its outlier flags; the
    scatter by the mirror's rows against the rows it was given. Every other
    result (copied out) must be unchanged at the end (no later replay
    overwrote it).
    Returns (rows, fn's result); raises where one is off."""
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves
    rows, kept = [], []
    seen = set()

    def hold(key, ps, variant, inputs, out):
        prog = ps.program(inputs)
        dev = [x.to(dm.device) for x in inputs]
        row = {"program": prog.name, "variant": repr(variant),
               "replayed": variant in prog.variants}
        if key == "scatter":
            ids = dev[0].long()
            mirror = (dm.mp_xyz, dm.mp_desc, dm.mp_normal, dm.mp_min_dist, dm.mp_max_dist,
                      dm.mp_valid)
            row["equal_bits"] = all(torch.equal(t[ids], x) for t, x in zip(mirror, dev[1:]))
        else:
            with torch.no_grad():
                eager = leaves(ps.fn(variant, *dev))
            got = leaves(out)
            if key == "local_ba":
                chi2 = [float(got[3]), float(eager[3])]
                flags = int((got[4] != eager[4]).sum())
                row.update(chi2_captured=chi2[0], chi2_eager=chi2[1],
                           chi2_rel=abs(chi2[0] - chi2[1]) / max(abs(chi2[1]), 1e-30),
                           flags_differ=flags, observations=int(eager[4].numel()))
                row["equal_bits"] = all(torch.equal(a, b) for a, b in zip(got, eager))
                row["ok"] = (row["chi2_rel"] <= GRAPH_BA_CHI2_REL
                             and flags <= GRAPH_BA_FLAG_SHARE * int(inputs[9].sum()))
            else:
                row["equal_bits"] = all(torch.equal(a, b) for a, b in zip(got, eager))
            kept.append((len(rows), got, [x.clone() for x in got]))
        row.setdefault("ok", row["equal_bits"])
        row["ok"] = row["ok"] and row["replayed"]
        rows.append(row)

    for key, ps in dm.programs.items():
        def run(variant, *inputs, ps=ps, key=key, orig=ps.run):
            out = orig(variant, *inputs)
            sig = (ps.program(inputs).name, variant)
            if sig not in seen:
                seen.add(sig)
                hold(key, ps, variant, inputs, out)
            return out
        ps.run = run
    try:
        result = fn()
    finally:
        for ps in dm.programs.values():
            del ps.run
    for i, got, copy in kept:
        rows[i]["kept"] = all(torch.equal(a, b) for a, b in zip(got, copy))
        rows[i]["ok"] = rows[i]["ok"] and rows[i]["kept"]
    return rows, result


def timed_compile(torch, slam):
    """`Slam._compile_programs` part by part: seconds and the device memory
    each part leaves reserved (its graph pool and input buffers), the
    allocator's cache emptied around each; and what each capture of the map
    mirror's one pool adds to it, in capture order."""
    parts = {"step": slam.tracker.fused.capture, "mapping": slam.mapper.capture_programs,
             "host_path": slam.tracker.capture_programs}
    if slam.loop_closer is not None:
        parts["loop_closing"] = slam.loop_closer.capture_programs
    dm, by_stage = slam.mapper.dmap, {}

    def measured(fn, key):
        def capture(*a):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            fn(*a)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            by_stage[key(*a)] = torch.cuda.memory_reserved() - r0
        return capture

    dm.capture = measured(dm.capture, lambda name, variant, *a: (
        name if variant is None else f"{name}[{variant}]") + f"[{_mirror_rows(a)}]")
    dm.capture_scatter = measured(dm.capture_scatter, lambda n: f"scatter[{n}]")
    out = {}
    try:
        for name, fn in parts.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            torch.cuda.empty_cache()
            out[name] = {"capture_s": dt, "reserved_bytes": torch.cuda.memory_reserved() - r0}
    finally:
        del dm.capture, dm.capture_scatter
    log(f"[graphs] the map mirror's pool, bytes each capture adds (in capture order): "
        f"{json.dumps(by_stage)}")
    out["mapping"]["reserved_bytes_by_capture"] = by_stage
    progs = {k: sorted(p.name for s in sets.values() for p in s.programs.values())
             for k, sets in (("host_path", slam.tracker.programs),
                             ("loop_closing", slam.loop_closer.programs
                              if slam.loop_closer is not None else {}))}
    progs["host_path"] += [p.name for p in slam.tracker.extraction.all_programs]
    progs["mapping"] = sorted(p.name for s in slam.mapper.dmap.programs.values()
                              for p in s.programs.values())
    log(f"[graphs] _compile_programs by part: {json.dumps(out)}; programs {json.dumps(progs)}")
    return {"parts": out, "programs": progs}


def _mirror_rows(args) -> int:
    """The leading size of a mirror stage's first array argument (its rows)."""
    return next(np.shape(a)[0] for a in args if np.ndim(a))


def _low_texture_frame(image, window=GRAPH_FLAT_WINDOW):
    """A mostly flat frame: mid-grey, with one `window` x `window` square of
    a fixture frame at its centre. Its corners crowd into a few cells, so
    their candidates cannot fill the finest level's quota: that level takes
    the extractor's slow path (its fast-path flag is false)."""
    out = np.full_like(image, 128)
    y, x = (image.shape[0] - window) // 2, (image.shape[1] - window) // 2
    out[y:y + window, x:x + window] = image[y:y + window, x:x + window]
    return out


def _step_fields(out):
    d = {k: getattr(out, k) for k in out._fields if k != "feats"}
    d.update({f"feats.{k}": getattr(out.feats, k) for k in out.feats._fields})
    return d


def phase_graphs(torch, fast_cuda, FusedContext, SlamConfig, fx, smi):
    """The captured programs against their eager runs on the card, in this
    process: the WORKING step (equal bits) on the fixture's 10 frames fed
    forward, the recovery frame and a low-texture frame; its launches from
    the host and host reads per step; the local-BA stages (chi2, outlier
    flags, ms) on a problem from the system fixture's map."""
    from torch.profiler import ProfilerActivity, profile

    from orbslam_jpminipc_torch.map import device_map
    from orbslam_jpminipc_torch.map.device_map import local_ba_kernel
    from orbslam_jpminipc_torch.pipeline.system import Slam

    res = {"card": smi}
    sf = dict(np.load(SLAM_FIXTURE))
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                     n_features=1000, pipelined_tracking=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # as each capture does: what stays reserved is the pools'
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_reserved()
    ctx = FusedContext(cfg, device="cuda")
    ctx.set_slice(fx["slice_buf"])
    t0 = time.perf_counter()
    ctx.capture()
    torch.cuda.synchronize()
    res["step_capture_s"] = time.perf_counter() - t0
    res["step_programs"] = {p.name: [str(v) for v in p.variants] for p in ctx.programs}
    res["step_reserved_bytes"] = torch.cuda.memory_reserved() - mem0
    log(f"[graphs] {smi}: the step's programs captured in {res['step_capture_s']:.2f} s: "
        f"{json.dumps(res['step_programs'])}; memory reserved by them "
        f"{res['step_reserved_bytes']} bytes")

    # -- the step, captured against eager: equal bits -------------------------
    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    flat = torch.as_tensor(_low_texture_frame(fx["images"][0])).cuda()
    frames = [(f"fixture {k}", im, None) for k, im in enumerate(images)]
    frames += [("recovery", images[0], (sf["recovery_R0"], sf["recovery_t0"],
                                        (fx["vel_R0"], fx["vel_t0"]))),
               ("low texture", flat, None)]
    _seed(ctx, fx)
    state = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
    rows = []
    l_graph = l_eager = 0
    for name, img, seed in frames:
        if seed is not None:
            ctx.set_pose(seed[0], seed[1], velocity=seed[2])
            state = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
        n0 = fast_cuda.LAUNCHES
        with torch.no_grad():
            eager = ctx.step(img, *state, ctx.slice)
        n1 = fast_cuda.LAUNCHES
        got = ctx.track(img)
        n2 = fast_cuda.LAUNCHES
        l_eager, l_graph = l_eager + n1 - n0, l_graph + n2 - n1
        want = _step_fields(eager)
        differ = [k for k, v in _step_fields(got).items() if not torch.equal(v, want[k])]
        state_eq = all(torch.equal(a, b) for a, b in zip(
            (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t), (eager.R, eager.t, eager.vel_R, eager.vel_t)))
        rows.append({"frame": name, "differ": differ, "state_equal": state_eq,
                     "pass1_inliers": ctx.last_pass1_inliers,
                     "recovery": ctx.last_pass1_inliers < 20,
                     "slow_levels": [k for k, ok in enumerate(ctx.last_fast_ok) if not ok],
                     "n_inl2": int(got.n_inl2)})
        log(f"[graphs] {name}: captured vs eager, fields differing {differ}, state equal "
            f"{state_eq}; pass 1 inliers {ctx.last_pass1_inliers}, recovery "
            f"{rows[-1]['recovery']}, slow-path levels {rows[-1]['slow_levels']}, "
            f"pass 2 inliers {rows[-1]['n_inl2']}")
        state = [eager.R, eager.t, eager.vel_R, eager.vel_t,
                 torch.tensor(cfg.use_motion_model, device="cuda")]
    res["step_frames"] = rows
    res["fast_launches"] = {"captured": l_graph, "eager": l_eager}
    if any(r["differ"] or not r["state_equal"] for r in rows):
        raise AssertionError(f"[graphs] the captured step differs from the eager one: {rows}")
    if not any(r["recovery"] for r in rows) or not any(r["slow_levels"] for r in rows):
        raise AssertionError("[graphs] the frames did not take both arms of both host tests")
    if l_graph != len(frames) or l_eager != len(frames):
        raise AssertionError(f"[graphs] FAST launches {l_graph} captured, {l_eager} eager, "
                             f"expected one a frame over {len(frames)}")

    # -- launches from the host and host reads per step ------------------------
    n = len(images) - 1

    eager_state = []

    def eager_step(img):
        with torch.no_grad():
            out = ctx.step(img, *eager_state, ctx.slice)
        eager_state[:] = [out.R, out.t, out.vel_R, out.vel_t, eager_state[4]]

    def window(step):
        _seed(ctx, fx)
        eager_state[:] = [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)]
        step(images[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(1, len(images)):
                step(images[k])
            torch.cuda.synchronize()
        return _launch_counts(prof, n)

    captured = window(ctx.track)
    eager = window(eager_step)
    sites, stacks = _sync_stacks(torch, lambda: [ctx.track(im) for im in images[1:]])
    # a wait with no line of the port on its stack is not the step's
    ours = {k: v for k, v in sites.items() if stacks.get(k)}
    res["launches"] = {"captured": captured, "eager": eager}
    res["host_reads_per_step"] = sum(ours.values()) / n
    res["host_read_sites"] = sites
    res["host_read_stacks"] = stacks
    graphs = captured["host_by_api_per_call"].get("cudaGraphLaunch", 0)
    log(f"[graphs] {smi}: per step, captured: {json.dumps(captured)}")
    log(f"[graphs] {smi}: per step, eager: {json.dumps(eager)}")
    log(f"[graphs] host reads per step (FusedContext.track; the tracker's fetch is a third): "
        f"{res['host_reads_per_step']:.2f} at {json.dumps(ours)}; all waits in the window "
        f"{json.dumps(sites)}, the port's lines on their stacks {json.dumps(stacks)}")
    if graphs > GRAPH_REPLAYS_MAX or captured["host_launches_per_call"] > GRAPH_LAUNCHES_MAX:
        raise AssertionError(f"[graphs] {graphs} replays and {captured['host_launches_per_call']} "
                             f"launches from the host a step")
    if res["host_reads_per_step"] > 2:
        raise AssertionError(f"[graphs] {res['host_reads_per_step']} host reads a step: {ours}")

    # -- each segment's replay alone (CUDA events, the copies included) ------
    _seed(ctx, fx)
    ctx.track(images[0])
    det = ctx._detect.run(None, images[0])
    state = (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t, ctx.has_vel)
    p1 = ctx._pass1.run(None, det, ctx._picks_out, *state, ctx._slice)
    res["segment_ms"] = {
        "detect": _event_ms(torch, lambda: ctx._detect.run(None, images[0]), n=10, batch=5),
        "picks": _event_ms(torch, lambda: ctx._picks(det, ctx.last_fast_ok), n=10, batch=5),
        "pass1": _event_ms(torch, lambda: ctx._pass1.run(None, det, ctx._picks_out, *state,
                                                         ctx._slice), n=10, batch=5),
        "pass2": _event_ms(torch, lambda: ctx._pass2.run(False, p1, ctx._slice, *state),
                           n=10, batch=5),
        "pass2_recovery": _event_ms(torch, lambda: ctx._pass2.run(True, p1, ctx._slice, *state),
                                    n=10, batch=5),
    }
    log(f"[graphs] {smi}: ms per replay of each segment (CUDA events): "
        f"{json.dumps(res['segment_ms'])}")

    # -- the local-BA stages on a real problem ---------------------------------
    slam = Slam(SlamConfig(**json.loads(str(sf["meta"]))["config"]), vocab=None, device="cuda")
    t0 = time.perf_counter()
    slam.warmup()
    torch.cuda.synchronize()
    res["warmup_s"] = time.perf_counter() - t0
    sets = iter(torch.as_tensor(x).cuda() for x in sf["init_sets"])
    slam.tracker.sampler = lambda mask, n_hyp: next(sets)

    def drive():
        for img, ts in zip(sf["images"][:GRAPH_BA_FRAMES], sf["timestamps"][:GRAPH_BA_FRAMES]):
            slam.process(img, float(ts))
        slam.finish()

    # -- the map mirror's stage programs against their eager runs ------------
    dm = slam.mapper.dmap
    mapping, _ = hold_mirror_programs(torch, dm, drive)
    res["mapping_programs"] = mapping
    res["mapping_variants"] = {p.name: [repr(v) for v in p.variants]
                               for s in dm.programs.values() for p in s.programs.values()}
    log(f"[graphs] {smi}: the map mirror's stage programs, each first call per shape held "
        f"against its eager run on the run's inputs: {json.dumps(mapping)}; captured "
        f"{json.dumps(res['mapping_variants'])}")
    held = {r["program"].split("[")[0] for r in mapping}
    if any(not r["ok"] for r in mapping) or held != set(
            ("map_scatter", "map_tri", "map_fuse", "local_ba", "map_attrs", "map_slice")):
        raise AssertionError(f"[graphs] mapping programs off their eager runs or not run: "
                             f"{mapping}")
    # what a bucket past 2048 costs when its first call captures it mid-run
    cap = {}
    for name, capture in (
            ("map_attrs[4096]", lambda: dm.capture(
                "attrs", None, np.full((4096, slam.map.max_obs), -1, np.int32),
                np.zeros((4096, slam.map.max_obs), np.int32), np.zeros((4096, 3)),
                np.zeros(4096, np.int32), slam.cfg.scale_factors)),
            ("map_scatter[4096]", lambda: dm.capture_scatter(4096))):
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        capture()
        torch.cuda.synchronize()
        cap[name] = {"capture_s": time.perf_counter() - t0,
                     "reserved_bytes": torch.cuda.memory_reserved() - r0}
    res["bucket_4096_capture"] = cap
    log(f"[graphs] {smi}: a 4096-row bucket captured at its first call: {json.dumps(cap)}")
    m = slam.mapper
    kf = int(np.nonzero(slam.map.kf_valid)[0].max())
    prob, _, _, obs_src, (obs_feat, obs_src_kf) = m.build_local_ba_problem(kf)
    inv_sigma2 = slam.cfg.inv_sigma2.astype(np.float32)

    def stage(iterations, R, t, pts, valid, captured):
        args = (R, t, prob.kf_fixed, pts, prob.point_valid, prob.obs_kf, prob.obs_pt,
                obs_feat, obs_src_kf, valid, prob.K4, inv_sigma2)
        if captured:
            return local_ba_kernel(m.dmap, *args, iterations=iterations)
        inputs = [x.to("cuda") for x in device_map._INPUTS["local_ba"](*args)]
        with torch.no_grad():
            return m.dmap.programs["local_ba"].fn(iterations, *inputs)

    def timed_ms(fn, reps=5):
        out, ms = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms)

    ba = {"kf": kf, "observations": len(obs_src), "shape": [int(prob.kf_R.shape[0]),
                                                            int(prob.points.shape[0]),
                                                            int(prob.obs_kf.shape[0])]}
    valid = np.asarray(prob.obs_valid)
    start = (prob.kf_R, prob.kf_t, prob.points, valid)
    for iterations in (5, 10):
        g, g_ms = timed_ms(lambda: stage(iterations, *start, True))
        e, e_ms = timed_ms(lambda: stage(iterations, *start, False))
        e2 = stage(iterations, *start, False)
        chi2 = [float(x.chi2) for x in (g, e, e2)]
        flags = [x.obs_outlier.cpu().numpy() for x in (g, e, e2)]
        row = {"captured_ms": g_ms, "eager_ms": e_ms,
               "chi2_captured": chi2[0], "chi2_eager": chi2[1], "chi2_eager_again": chi2[2],
               "chi2_rel": abs(chi2[0] - chi2[1]) / max(abs(chi2[1]), 1e-30),
               "chi2_rel_eager_again": abs(chi2[2] - chi2[1]) / max(abs(chi2[1]), 1e-30),
               "outliers": int(flags[1].sum()),
               "flags_differ": int((flags[0] != flags[1]).sum()),
               "flags_differ_eager_again": int((flags[2] != flags[1]).sum()),
               "dR": float((g.kf_R - e.kf_R).abs().max()),
               "dt": float((g.kf_t - e.kf_t).abs().max())}
        ba[f"stage_{iterations}"] = row
        log(f"[graphs] {smi}: local BA {iterations} iterations at {ba['shape']}, "
            f"{ba['observations']} observations: {json.dumps(row)}")
        if row["chi2_rel"] > GRAPH_BA_CHI2_REL or (
                row["flags_differ"] > GRAPH_BA_FLAG_SHARE * len(obs_src)):
            raise AssertionError(f"[graphs] the captured local BA is off the eager one: {row}")
        # stage 2 starts from stage 1's eager result, outliers cut
        start = (e.kf_R, e.kf_t, e.points, valid & ~flags[1])
    res["local_ba"] = ba
    res["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    res["reserved_bytes"] = int(torch.cuda.memory_reserved())
    log(f"[graphs] {smi}: Slam.warmup {res['warmup_s']:.1f} s; peak device memory "
        f"{res['peak_mem_bytes']} bytes allocated, {res['reserved_bytes']} reserved")
    return res


def _percentiles(xs, unit="_ms"):
    if not xs:
        return None
    return {"n": len(xs), f"p50{unit}": float(np.percentile(xs, 50)),
            f"p95{unit}": float(np.percentile(xs, 95)), f"mean{unit}": float(np.mean(xs))}


def _centre(P):
    return -P[:3, :3].T @ P[:3, 3]


def _kf_ate(slam, sf):
    """Sim3-aligned ATE of the keyframe trajectory against ground truth."""
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse

    index = {round(float(ts), 6): i for i, ts in enumerate(sf["timestamps"])}
    kft = slam.keyframe_trajectory()
    est = np.stack([-R.T @ t for _, R, t in kft]).astype(np.float64)
    gi = [index[round(ts, 6)] for ts, _, _ in kft]
    gt = np.stack([-sf["gt_R"][i].T @ sf["gt_t"][i] for i in gi]).astype(np.float64)
    return ate_rmse(est, gt)


def phase_system(torch, fast_cuda, smi):
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.tracking import TrackState
    from orbslam_jpminipc_torch.ops import small_linalg_cuda
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    sf = dict(np.load(SLAM_FIXTURE))
    meta = json.loads(str(sf["meta"]))
    cfg = SlamConfig(**meta["config"])
    images = [torch.as_tensor(im).cuda() for im in sf["images"]]
    n = len(images)

    warmup_s = []

    def make(slam=None):
        """A warmed system, or `slam` put back as a fresh one (`_restart`,
        what `Slam.warmup` ends with: its programs kept)."""
        if slam is None:
            slam = Slam(cfg, vocab=None, device="cuda")
            # the programs captured and the first-call costs taken before
            # the first frame; the reference's minimal sets injected after it
            t0 = time.perf_counter()
            slam.warmup()
            torch.cuda.synchronize()
            warmup_s.append(time.perf_counter() - t0)
        else:
            slam._restart()
            slam.mapper.__dict__.pop("process", None)
        sets = iter(torch.as_tensor(x).cuda() for x in sf["init_sets"])
        slam.tracker.sampler = lambda mask, n_hyp: next(sets)
        kf_events = []
        process = slam.mapper.process
        slam.mapper.process = lambda frame: (kf_events.append(frame.frame_id), process(frame))[1]
        return slam, kf_events

    def drive(slam, kf_events, count_syncs):
        """Feed the frames through `Slam.process`, one synchronised call
        each. With `count_syncs` every host synchronisation is recorded
        (CUDA sync debug mode), which slows the calls: that pass is not
        timed; in it each frame before WORKING runs under torch.profiler,
        with the initialization attempt (`Tracker._attempt_init`: the draw,
        the program, its read) in a range of its own."""
        rows = []
        attempt_reads = []
        for i in range(n):
            was = slam.tracker.state
            fused = slam.tracker.fused_usable(slam.frame_count)
            reads0, launches0, kf0 = _reads(), fast_cuda.LAUNCHES, len(kf_events)
            profiled = count_syncs and was != TrackState.WORKING
            stack = contextlib.ExitStack()
            if profiled:
                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                stack.enter_context(_patch(slam.tracker, "_attempt_init",
                                           _labelled(torch, "init_attempt", attempt_reads)))
            with stack, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                if count_syncs:
                    torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    state, frame = slam.process(images[i], float(sf["timestamps"][i]))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            sites = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                     if "synchroniz" in str(w.message)]
            syncs = len(sites)
            attempt = _launches_in(prof, "init_attempt") if profiled else None
            pose = np.full((3, 4), np.nan, np.float32)
            if frame is not None and frame.R is not None:
                pose[:, :3], pose[:, 3] = frame.R, frame.t
            ref = sf["poses"][i]
            both = np.isfinite(pose).all() and np.isfinite(ref).all()
            kind = ("init" if was != TrackState.WORKING
                    else "keyframe" if len(kf_events) > kf0 else "other")
            rows.append({
                "frame": i, "kind": kind, "ms": ms, "state": state.value,
                "ref_state": int(sf["states"][i]), "n_inliers": slam.tracker.n_inliers,
                "ref_n_inliers": int(sf["n_inliers"][i]),
                "n_keyframes": slam.n_keyframes, "n_points": slam.n_points,
                "centre": _centre(pose).tolist() if np.isfinite(pose).all() else None,
                "pose": pose.tolist() if np.isfinite(pose).all() else None,
                "dcentre": float(np.abs(_centre(pose) - _centre(ref)).max()) if both else None,
                "has_pose": bool(np.isfinite(pose).all()), "ref_has_pose": bool(np.isfinite(ref).all()),
                "fetches": _reads() - reads0, "syncs": syncs if count_syncs else None,
                "sync_sites": sites, "init_attempt": attempt,
                "fast_launches": fast_cuda.LAUNCHES - launches0, "fused": fused,
            })
        slam.finish()
        torch.cuda.synchronize()
        if attempt_reads:
            rows[0]["attempt_reads"] = attempt_reads
        return rows

    # first, untimed, the host synchronisations per frame; then the same
    # system, put back as a fresh one, takes the main path: timed, with the
    # kernel's launch count from 0
    slam, kf_events = make()
    rows2 = drive(slam, kf_events, count_syncs=True)
    ate_rerun = _kf_ate(slam, sf)
    init = _init_attempts(rows2)
    log(f"[system] {smi}: initialization attempts (untimed run, torch.profiler): "
        f"{json.dumps(init)}")
    if not init["attempts"] or init["graph_launches_per_attempt"] != 1.0 or any(
            r != 1 for r in init["reads_per_attempt"]):
        raise AssertionError(f"[system] an initialization attempt is not one replay and one "
                             f"read: {json.dumps(init)}")
    if init["waits_in_solvers"]:
        raise AssertionError(f"[system] the initializer waited: {init['waits_in_solvers']}")
    slam, kf_events = make(slam)
    tracer = get_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fast_cuda.LAUNCHES = small_linalg_cuda.LAUNCHES = 0
    rows = drive(slam, kf_events, count_syncs=False)
    launches, sl_launches = fast_cuda.LAUNCHES, small_linalg_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = tracer.summary()
    for r in rows:
        log(f"[system] frame {r['frame']} {r['kind']}: {TrackState(r['state']).name} (ref "
            f"{TrackState(r['ref_state']).name}) {r['ms']:.1f} ms, inl {r['n_inliers']} "
            f"(ref {r['ref_n_inliers']}), kf {r['n_keyframes']}, pts {r['n_points']}, "
            f"dcentre {r['dcentre']}, fetches {r['fetches']}, FAST {r['fast_launches']}")
    for r, r2 in zip(rows, rows2):
        r["syncs"] = r2["syncs"]
        r.pop("sync_sites")
    rerun = {
        "states_equal": sum(a["state"] == b["state"] for a, b in zip(rows, rows2)),
        "max_dcentre": max((float(np.abs(np.subtract(a["centre"], b["centre"])).max())
                            for a, b in zip(rows, rows2)
                            if a["centre"] is not None and b["centre"] is not None),
                           default=None),
    }

    ate = _kf_ate(slam, sf)
    ref_ate = float(sf["kf_ate"])
    init_hold = _init_hold(rows, sf)
    n_kf, ref_kf = slam.n_keyframes, int(sf["n_keyframes"])
    n_pts, ref_pts = slam.n_points, int(sf["n_points"])
    states_eq = sum(r["state"] == r["ref_state"] for r in rows)
    pose_mismatch = [r["frame"] for r in rows if r["has_pose"] != r["ref_has_pose"]]
    dc = [r["dcentre"] for r in rows if r["dcentre"] is not None]
    groups = {k: _percentiles([r["ms"] for r in rows if r["kind"] == k])
              for k in ("init", "keyframe", "other")}
    res = {
        "card": smi, "frames": n, "states_equal": states_eq,
        "n_keyframes": n_kf, "ref_n_keyframes": ref_kf,
        "n_points": n_pts, "ref_n_points": ref_pts,
        "max_dcentre": max(dc) if dc else None, "kf_ate": ate, "ref_kf_ate": ref_ate,
        "kf_ate_untimed_run": ate_rerun, "initialization": init_hold,
        "ms_per_frame": groups,
        "syncs_per_frame": _percentiles([r["syncs"] for r in rows], unit=""),
        "fetches_per_frame": _percentiles([r["fetches"] for r in rows], unit=""),
        "fast_launches": launches, "small_linalg_launches": sl_launches,
        "peak_mem_bytes": int(peak), "warmup_s": warmup_s,
        "stages": stages, "rerun_vs_main": rerun, "rows": rows, "init_attempts": init,
    }
    for k, g in groups.items():
        log(f"[system] {smi}: {k} frames ms per process: {json.dumps(g)}")
    log(f"[system] {smi}: host synchronisations per frame (sync debug mode, untimed "
        f"run) "
        f"{json.dumps(res['syncs_per_frame'])}; batched reads per frame "
        f"{json.dumps(res['fetches_per_frame'])}")
    log(f"[system] {smi}: peak device memory {peak} bytes; Slam.warmup "
        f"{[round(x, 2) for x in warmup_s]} s")
    log(f"[system] {smi}: stage summary {json.dumps(res['stages'])}")
    log(f"[system] outcome: states equal {states_eq}/{n}, keyframes {n_kf} (ref {ref_kf}), "
        f"points {n_pts} (ref {ref_pts}), max centre diff {res['max_dcentre']}, "
        f"kf ATE {ate:.6f} (ref {ref_ate:.6f}), FAST launches {launches}")
    log(f"[system] the untimed run vs the timed one: states equal {rerun['states_equal']}/{n}, "
        f"max centre diff {rerun['max_dcentre']}")
    log(f"[system] small_linalg launches over the run: {sl_launches}")
    if sl_launches == 0:
        raise AssertionError("[system] the small_linalg kernel was not launched")

    if states_eq < SYS_STATES_MIN:
        raise AssertionError(f"states equal on only {states_eq}/{n} frames")
    if pose_mismatch:
        raise AssertionError(f"pose present/absent differs on frames {pose_mismatch}")
    if abs(n_kf - ref_kf) > SYS_KF_TOL:
        raise AssertionError(f"{n_kf} keyframes, reference {ref_kf}")
    log(f"[system] {smi}: the initialization against the JAX outcome (the Jacobi kernel's "
        f"SVDs and eigendecompositions): {json.dumps(init_hold)}; kf ATE {ate * 1e3:.4f} mm, "
        f"the untimed run's {ate_rerun * 1e3:.4f} mm (reference {ref_ate * 1e3:.4f})")
    if not init_hold["ok"]:
        raise AssertionError(f"[system] the initialization is off the JAX outcome: "
                             f"{json.dumps(init_hold)}")
    if abs(n_pts - ref_pts) > SYS_POINTS_REL * ref_pts:
        raise AssertionError(f"{n_pts} points, reference {ref_pts}")
    if not dc or max(dc) > SYS_CENTRE_TOL:
        raise AssertionError(f"camera centres off the reference by {res['max_dcentre']}")
    if not np.isfinite(ate) or ate > ref_ate + SYS_ATE_MARGIN:
        raise AssertionError(f"keyframe ATE {ate} above the reference's {ref_ate} + {SYS_ATE_MARGIN}")
    # both frame paths extract through the kernel: build_frame on the
    # initialization frames, the fused step on every tracked frame
    no_fast = [r["frame"] for r in rows
               if (r["kind"] == "init" or r["fused"]) and r["fast_launches"] != 1]
    if no_fast or not any(r["fused"] for r in rows):
        raise AssertionError(f"FAST kernel not launched exactly once on frames {no_fast}")
    res["mapping_stages"] = stage_profile(torch, slam, smi)
    return res


def _init_hold(rows, sf):
    """The system run's initialization against the JAX outcome recorded in
    the fixture: the frame that first tracks, its pose (R and t, largest
    absolute difference, within the initializer test's bounds), and the
    initial map (keyframes and points at that frame, equal)."""
    from orbslam_jpminipc_torch.frontend.tracking import TrackState

    working = TrackState.WORKING.value
    first = next((r["frame"] for r in rows if r["state"] == working), None)
    ref_first = int(np.argmax(sf["states"] == working))
    out = {"frame": first, "ref_frame": ref_first, "ok": False}
    if first is None or rows[first]["pose"] is None:
        return out
    r = rows[first]
    pose, ref = np.array(r["pose"], np.float64), sf["poses"][ref_first].astype(np.float64)
    out.update(dR=float(np.abs(pose[:, :3] - ref[:, :3]).max()),
               dt=float(np.abs(pose[:, 3] - ref[:, 3]).max()),
               n_keyframes=r["n_keyframes"],
               ref_n_keyframes=int(sf["n_keyframes_per_frame"][ref_first]),
               n_points=r["n_points"], ref_n_points=int(sf["n_points_per_frame"][ref_first]))
    out["ok"] = (first == ref_first and out["dR"] <= SYS_INIT_R_TOL
                 and out["dt"] <= SYS_INIT_T_TOL and out["n_keyframes"] == out["ref_n_keyframes"]
                 and out["n_points"] == out["ref_n_points"])
    return out


def _init_attempts(rows):
    """The untimed system run's initialization attempts: launches from the
    host and graph replays per attempt (its profiled range), host reads per
    attempt, and the frames' waits by source line (sync debug mode), those
    in the RANSAC solvers apart."""
    frames = [r for r in rows if r["init_attempt"] is not None]
    calls = [r["init_attempt"] for r in frames if r["init_attempt"]["calls"]]
    n = sum(c["calls"] for c in calls)
    per = lambda f: sum(f(c) * c["calls"] for c in calls) / max(n, 1)
    sites = {}
    for r in frames:
        for site in r["sync_sites"]:
            sites[site] = sites.get(site, 0) + 1
    return {"frames": len(frames), "attempts": n,
            "host_launches_per_attempt": per(lambda c: c["host_launches_per_call"]),
            "graph_launches_per_attempt": per(
                lambda c: c["host_by_api_per_call"].get("cudaGraphLaunch", 0.0)),
            "by_api": {k: per(lambda c: c["host_by_api_per_call"].get(k, 0.0))
                       for k in sorted({a for c in calls for a in c["host_by_api_per_call"]})},
            "reads_per_attempt": rows[0].get("attempt_reads", []),
            "waits_by_site": dict(sorted(sites.items(), key=lambda kv: -kv[1])),
            "waits_in_solvers": {k: v for k, v in sites.items()
                                 if k.rpartition(":")[0].endswith(_WAIT_FREE)}}


def stage_profile(torch, slam, smi):
    """The mapping stages one call at a time under torch.profiler, on the
    system run's map fed the next STAGE_PROFILE_FRAMES frames of the
    sequence (the forced-loss fixture's frames 28 on, each a keyframe
    here): per stage, host ms to the end of its device work, the device's
    kernels and their time, and the host's launches. Where a keyframe
    frame's mapping time goes: device launches or host numpy."""
    from torch.profiler import ProfilerActivity, profile

    rf = dict(np.load(RELOC_FIXTURE))
    m = slam.mapper
    run_stage = m.run_stage
    by = {}

    def profiled(kf, stage):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_stage(kf, stage)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        c = _launch_counts(prof, 1)
        acc = by.setdefault(stage, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                    "kernels": 0, "host_launches": 0})
        acc["calls"] += 1
        acc["host_ms"] += ms
        acc["device_ms"] += c["device_ms_per_call"]
        acc["kernels"] += c["device_ops_per_call"]
        acc["host_launches"] += c["host_launches_per_call"]

    m.run_stage = profiled
    try:
        for img, ts in zip(rf["images"][:STAGE_PROFILE_FRAMES],
                           rf["seq_timestamps"][28:28 + STAGE_PROFILE_FRAMES]):
            slam.process(torch.as_tensor(img).cuda(), float(ts))
        slam.finish()
    finally:
        del m.run_stage
    rows = {k: {"calls": v["calls"], **{f: v[f] / v["calls"] for f in v if f != "calls"}}
            for k, v in by.items()}
    for k, v in rows.items():
        if k in EAGER_STAGES:
            v["eager_host_launches"], v["eager_host_ms"] = EAGER_STAGES[k]
        log(f"[system] {smi}: mapping stage {k} per call, profiled alone: {json.dumps(v)}")
    many = {k: rows[k]["host_launches"] for k in ("triangulate_d", "fuse_d", "ba_d", "ba2_d")
            if k in rows and rows[k]["host_launches"] > STAGE_LAUNCHES_MAX}
    if many:
        raise AssertionError(f"[system] mapping stages launching more than "
                             f"{STAGE_LAUNCHES_MAX} times from the host a call: {many}")
    return rows


def _pnp_launches(torch):
    """One eager `solve_pnp` (256 hypotheses over 1000 points, 600 of them
    on a pose) under torch.profiler: what the relocalization candidate's
    program holds, run op by op, its launches from the host and device ops
    counted apart."""
    from torch.profiler import ProfilerActivity, profile

    from orbslam_jpminipc_torch.solvers import pnp

    gen = torch.Generator(device="cuda").manual_seed(3)
    xw = torch.rand((1000, 3), generator=gen, device="cuda") * 2 - 1 + torch.tensor(
        [0.0, 0.0, 4.0], device="cuda")
    uv = 500.0 * xw[:, :2] / xw[:, 2:] + torch.tensor([320.0, 240.0], device="cuda")
    mask = torch.arange(1000, device="cuda") < 600
    uv = torch.where(mask[:, None], uv, uv + 40.0)
    K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], device="cuda")
    err = torch.full((1000,), 5.991, device="cuda")
    call = lambda: pnp.solve_pnp(pnp.sample_minimal_sets(mask, pnp.N_HYP, gen), xw, uv, mask,
                                 K4, err)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return _launch_counts(prof, 1)


def _feed_n2(slam, image, timestamp):
    """One frame at 2 n features (the initialization's extraction) through
    each host-path program at that shape, on a system that is WORKING:
    frame-to-frame tracking from the last (n1) frame, local-map tracking
    against the slice's 4096 rows, relocalization (its candidates from the
    keyframe database) and both ladder rungs from the frame's pose. Returns
    the programs' names at the n2 shapes."""
    from orbslam_jpminipc_torch.frontend.frame import build_frame

    tr, cfg = slam.tracker, slam.cfg
    n1, n2 = cfg.n_features, 2 * cfg.n_features
    last = tr.last_frame
    frame = build_frame(image, cfg, frame_id=last.frame_id + 1, timestamp=timestamp,
                        n_features=n2, extraction=tr.extraction)
    tr._track_frame(frame)
    if frame.R is None:
        frame.R, frame.t = last.R.copy(), last.t.copy()
    tr._track_local_map(frame)
    kf = tr.ref_kf
    tr.pnp_sampler = None     # the run's injected sets are used up: draw
    tr._relocalize(frame)
    if frame.R is None:
        frame.R, frame.t = last.R.copy(), last.t.copy()
    for radius, max_dist in ((10.0, 100), (3.0, 64)):
        tr._reloc_refine_rung(frame, kf, radius, max_dist)
    return {f"track_frame[{n1}x{n2}]", f"track_local_map[4096x{n2}]",
            f"reloc_candidate[256x{n2}]", f"reloc_refine[{n2}]"}


def _kf_ate_seq(slam, timestamps, gt_R, gt_t):
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse

    index = {round(float(ts), 6): i for i, ts in enumerate(timestamps)}
    kft = slam.keyframe_trajectory()
    est = np.stack([-R.T @ t for _, R, t in kft]).astype(np.float64)
    gi = [index[round(ts, 6)] for ts, _, _ in kft]
    gt = np.stack([-gt_R[i].T @ gt_t[i] for i in gi]).astype(np.float64)
    return ate_rmse(est, gt)


def phase_reloc_async(torch, fast_cuda, smi):
    import warnings

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.tracking import TrackState
    from orbslam_jpminipc_torch.ops import small_linalg_cuda
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.utils.program import CallLog
    from orbslam_jpminipc_torch.utils.tracing import StageQueueAudit, get_tracer
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    sf = dict(np.load(SLAM_FIXTURE))
    rf = dict(np.load(RELOC_FIXTURE))
    meta = json.loads(str(rf["meta"]))
    n_before, n_noise = int(meta["before"]), int(meta["noise"])
    rng = np.random.default_rng(int(meta["noise_seed"]))
    noise = [rng.integers(0, 256, (480, 640)).astype(np.uint8) for _ in range(n_noise)]
    seq_images = [torch.as_tensor(im).cuda() for im in sf["images"][:n_before]] + [
        torch.as_tensor(im).cuda() for im in rf["images"]]
    seq_ts = rf["seq_timestamps"]
    if len(seq_images) != len(seq_ts):
        raise AssertionError(f"{len(seq_images)} frames for {len(seq_ts)} timestamps")
    run_r_images = (seq_images[:n_before] + [torch.as_tensor(im).cuda() for im in noise]
                    + seq_images[int(meta["resume"]):])
    run_r_ts = rf["timestamps"]
    tracer = get_tracer()

    t0 = time.perf_counter()
    vocab = load_vocabulary(VOCAB)
    torch.cuda.synchronize()
    log(f"[reloc_async] vocabulary: {vocab.n_words} words, k {vocab.k}, depth {vocab.depth}, "
        f"{vocab.node_desc.shape[0]} nodes on {vocab.device}, loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    pnp_alone = _pnp_launches(torch)
    log(f"[reloc_async] {smi}: one eager solve_pnp (256 hypotheses, 1000 points) under the "
        f"profiler: {json.dumps(pnp_alone)}")

    warmup_s = []

    def make(async_mapping, inject_pnp, slam=None):
        """A warmed system, or `slam` put back as a fresh one (`_restart`,
        what `Slam.warmup` ends with: its programs kept)."""
        if slam is None:
            cfg = SlamConfig(**dict(meta["config"], async_mapping=async_mapping))
            # Run A is the default constructor call (loop closing on); Run R
            # keeps one path without the "loop" stage's work covered
            slam = (Slam(cfg, vocab=vocab) if async_mapping
                    else Slam(cfg, vocab=vocab, enable_loop_closing=False))
            t0 = time.perf_counter()
            slam.warmup()
            torch.cuda.synchronize()
            warmup_s.append(time.perf_counter() - t0)
        else:
            slam._restart()
            # the last run's wrappers off (the queue audit's, the keyframe
            # hook's)
            for name in ("_run_pending_stage", "_on_new_keyframe"):
                slam.__dict__.pop(name, None)
            slam.tracker.on_new_keyframe = slam._on_new_keyframe
            slam.mapper.__dict__.pop("insert_keyframe", None)
        isets = iter(torch.as_tensor(x).cuda() for x in rf["init_sets"])
        slam.tracker.sampler = lambda mask, n_hyp: next(isets)
        if inject_pnp:
            psets = iter(torch.as_tensor(x).cuda() for x in rf["pnp_sets"])
            slam.tracker.pnp_sampler = lambda mask, n_hyp: next(psets)
        kf_events, events = [], []
        insert = slam.mapper.insert_keyframe
        slam.mapper.insert_keyframe = lambda frame: (kf_events.append(frame.frame_id),
                                                     insert(frame))[1]
        return slam, kf_events, events, StageQueueAudit(slam)

    def drive(slam, kf_events, events, images, timestamps, count_syncs, sync_each,
              profile_lost=False):
        """Feed the frames through `Slam.process`. With `sync_each` every
        call is timed to the end of its device work; without, to its return
        only, and the device is never waited for between frames (a mapping
        program launched in one frame is still running in the next, as in
        use). With `count_syncs` every host synchronisation is recorded
        (CUDA sync debug mode), which slows the calls: that pass is not
        timed. With `profile_lost` each frame that starts LOST runs under
        torch.profiler: its launches from the host, its relocalization
        candidates."""
        from torch.profiler import ProfilerActivity, profile

        rows, lost_prof = [], []
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        orig_log = tracer.log
        tracer.log = lambda event, **f: (events.append({"event": event, **f}),
                                         orig_log(event, **f))[1]
        try:
            for i, (img, ts) in enumerate(zip(images, timestamps)):
                was = slam.tracker.state
                fused = slam.tracker.fused_usable(slam.frame_count)
                reads0, launches0, kf0 = _reads(), fast_cuda.LAUNCHES, len(kf_events)
                ev0 = len(events)
                prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        if profile_lost and was == TrackState.LOST else None)
                with warnings.catch_warnings(record=True) as caught, \
                        (prof if prof is not None else contextlib.nullcontext()):
                    warnings.simplefilter("always")
                    if sync_each:
                        torch.cuda.synchronize()
                    if count_syncs:
                        torch.cuda.set_sync_debug_mode("warn")
                    t0 = time.perf_counter()
                    try:
                        state, frame = slam.process(img, float(ts))
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    ms_host = (time.perf_counter() - t0) * 1e3
                    if sync_each:
                        torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                if prof is not None:
                    lost_prof.append({"frame": i, "candidates": sum(
                        e["event"] == "reloc_attempt" for e in events[ev0:]),
                        **_launch_counts(prof, 1),
                        "candidate_call": _launches_in(prof, "reloc_candidate")})
                sites = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                         if "synchroniz" in str(w.message)]
                syncs = len(sites)
                pose = np.full((3, 4), np.nan, np.float32)
                if frame is not None and frame.R is not None:
                    pose[:, :3], pose[:, 3] = frame.R, frame.t
                kind = ("lost" if TrackState.LOST in (was, state)
                        else "init" if was != TrackState.WORKING
                        else "keyframe" if len(kf_events) > kf0 else "other")
                rows.append({
                    "frame": i, "kind": kind, "ms": ms, "ms_until_return": ms_host,
                    "state": state.value, "n_inliers": slam.tracker.n_inliers,
                    "n_keyframes": slam.n_keyframes, "n_points": slam.n_points,
                    "queue_depth": sum(len(st) for _, st in slam.pending),
                    "centre": _centre(pose).tolist() if np.isfinite(pose).all() else None,
                    "fetches": _reads() - reads0, "syncs": syncs if count_syncs else None,
                    "sync_sites": sites,
                    "fast_launches": fast_cuda.LAUNCHES - launches0, "fused": fused,
                })
            t0 = time.perf_counter()
            slam.finish()
            torch.cuda.synchronize()
            finish_ms = (time.perf_counter() - t0) * 1e3
            wall_s = time.perf_counter() - t_run
        finally:
            del tracer.log
        return rows, finish_ms, wall_s, lost_prof

    def groups_of(rows, key, unit):
        return {k: _percentiles([r[key] for r in rows if r["kind"] == k and r[key] is not None],
                                unit=unit)
                for k in ("init", "keyframe", "other", "lost")}

    def run(name, async_mapping, inject_pnp, images, timestamps):
        """The run untimed under CUDA sync debug mode for the
        synchronisations, then the same system, put back as a fresh one,
        timed from the kernel's launch count 0."""
        # the untimed run: with the forced loss, the LOST frames profiled
        # and the host path's programs logged, then held against their eager
        # runs on the logged inputs
        slam, kf_events2, events2, _ = make(async_mapping, inject_pnp)
        with CallLog() as calls, _patch(slam.tracker, "_reloc_candidate",
                                        _labelled(torch, "reloc_candidate")):
            rows2, _, _, lost_prof = drive(slam, kf_events2, events2, images, timestamps, True,
                                           sync_each=not async_mapping,
                                           profile_lost=not async_mapping)
            if not async_mapping:
                # the ladder's rungs (the run's relocalization took >= 50
                # inliers without them): from the last frame's pose against
                # its reference keyframe
                tr2 = slam.tracker
                for radius, max_dist in ((10.0, 100), (3.0, 64)):
                    tr2._reloc_refine_rung(tr2.last_frame, tr2.ref_kf, radius, max_dist)
                n2_names = _feed_n2(slam, images[-1], float(timestamps[-1]))
        programs = hold_programs(torch, calls.calls, name) if not async_mapping else None
        del calls
        if programs is not None:
            held = {r["program"] for r in programs}
            log(f"[graphs] {name}: the n2 programs held: {sorted(n2_names & held)}")
            if not n2_names <= held:
                raise AssertionError(f"[graphs] {name}: n2 programs not held: "
                                     f"{sorted(n2_names - held)}")
        slam, kf_events, events, audit = make(async_mapping, inject_pnp, slam)
        tracer.reset()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fast_cuda.LAUNCHES = small_linalg_cuda.LAUNCHES = 0
        rows, finish_ms, wall_s, _ = drive(slam, kf_events, events, images, timestamps, False,
                                           sync_each=not async_mapping)
        launches, sl_launches = fast_cuda.LAUNCHES, small_linalg_cuda.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        stages = tracer.summary()
        # every frame's row is in the report file; here the frames around
        # initialization and loss, and the run at a glance
        for r in rows:
            if r["kind"] in ("init", "lost"):
                log(f"[{name}] frame {r['frame']} {r['kind']}: {TrackState(r['state']).name} "
                    f"{r['ms']:.1f} ms, inl {r['n_inliers']}, kf {r['n_keyframes']}, pts "
                    f"{r['n_points']}, reads {r['fetches']}, FAST {r['fast_launches']}")
        log(f"[{name}] frames by kind (i init, K keyframe, o other, L lost): "
            f"{''.join({'init': 'i', 'keyframe': 'K', 'other': 'o', 'lost': 'L'}[r['kind']] for r in rows)}"
            f"; queue depth after each frame: {[r['queue_depth'] for r in rows]}")
        depth = [r["queue_depth"] for r in rows]
        # where the untimed run's synchronisations were made: the source
        # line of the call that waited, summed over each group's frames
        sync_sites = {}
        for r in rows2:
            tally = sync_sites.setdefault(r["kind"], {})
            for site in r.pop("sync_sites"):
                tally[site] = tally.get(site, 0) + 1
        for r in rows:
            r.pop("sync_sites")
        res = {
            "card": smi, "frames": len(rows), "async_mapping": async_mapping,
            "ms_per_frame": groups_of(rows, "ms", "_ms"),
            "ms_until_return": groups_of(rows, "ms_until_return", "_ms"),
            "fetches_per_frame": groups_of(rows, "fetches", ""),
            # the untimed run's counts, grouped by that run's own kinds
            "syncs_per_frame": groups_of(rows2, "syncs", ""),
            "sync_sites": sync_sites,
            "keyframes_inserted": len(kf_events), "n_keyframes": slam.n_keyframes,
            "n_points": slam.n_points,
            "queue_depth": {"p50": float(np.percentile(depth, 50)), "max": audit.max_depth},
            "queue": audit.counts(),
            "not_ready_skips": sum(e["event"] == "mapping_not_ready" for e in events),
            "finish_ms": finish_ms, "wall_s": wall_s, "synchronised_each_frame": not async_mapping,
            "fast_launches": launches, "small_linalg_launches": sl_launches,
            "peak_mem_bytes": int(peak),
            "stages": {k: v for k, v in stages.items()
                       if k.startswith(("kfdb", "bow", "reloc", "mapping", "map_", "track",
                                        "loop_"))},
            "rows": rows, "events": [e for e in events if e["event"].startswith(
                ("reloc_", "ba_", "mapping_not_ready"))],
            "programs": programs, "lost_frames_profiled": lost_prof,
        }
        tried = sum(r["candidates"] for r in lost_prof)
        if tried:
            res["host_launches_per_candidate"] = sum(
                r["host_launches_per_call"] for r in lost_prof if r["candidates"]) / tried
            res["device_kernels_per_candidate"] = sum(
                r["device_ops_per_call"] for r in lost_prof if r["candidates"]) / tried
            # the candidate's own call (the draw, the program's copies in,
            # its replay, its copy out): launches from the host and graph
            # replays per candidate
            calls_ = [r["candidate_call"] for r in lost_prof if r["candidate_call"]["calls"]]
            n_calls = sum(c["calls"] for c in calls_)
            per_call = lambda f: sum(f(c) * c["calls"] for c in calls_) / max(n_calls, 1)
            res["candidate_call"] = {
                "calls": n_calls,
                "host_launches": per_call(lambda c: c["host_launches_per_call"]),
                "graph_launches": per_call(lambda c: c["host_by_api_per_call"].get(
                    "cudaGraphLaunch", 0.0)),
                "by_api": {k: per_call(lambda c: c["host_by_api_per_call"].get(k, 0.0))
                           for k in sorted({a for c in calls_ for a in c["host_by_api_per_call"]})}}
            log(f"[{name}] {smi}: LOST frames under the profiler (untimed run): "
                f"{tried} candidates, {res['host_launches_per_candidate']:.1f} launches from "
                f"the host and {res['device_kernels_per_candidate']:.1f} device ops a "
                f"candidate, the frame's other work included; the candidate's own call: "
                f"{json.dumps(res['candidate_call'])}; per frame {json.dumps(lost_prof)}")
            if n_calls != tried or res["candidate_call"]["graph_launches"] != 1.0:
                raise AssertionError(f"[{name}] a candidate is not one replay: "
                                     f"{json.dumps(res['candidate_call'])}")
        for k, g in res["ms_per_frame"].items():
            log(f"[{name}] {smi}: {k} frames ms per process: {json.dumps(g)}; until the call "
                f"returned: {json.dumps(res['ms_until_return'][k])}; reads per frame "
                f"{json.dumps(res['fetches_per_frame'][k])}; host synchronisations per frame "
                f"(sync debug mode, untimed run) {json.dumps(res['syncs_per_frame'][k])}")
        log(f"[{name}] {smi}: keyframes inserted {res['keyframes_inserted']}, in the map "
            f"{res['n_keyframes']}, points {res['n_points']}; queue depth p50 "
            f"{res['queue_depth']['p50']} max {res['queue_depth']['max']}; "
            f"{json.dumps(res['queue'])}; ticks that skipped a stage not ready "
            f"{res['not_ready_skips']}; finish() {finish_ms:.1f} ms; the whole run "
            f"{wall_s:.2f} s ({'each frame timed to the end of its device work' if not async_mapping else 'frames timed to the return of the call, the device never waited for between frames'}); FAST launches {launches}; "
            f"peak device memory {peak} bytes")
        for k, tally in sync_sites.items():
            top = sorted(tally.items(), key=lambda kv: -kv[1])[:10]
            log(f"[{name}] synchronisations of the {k} frames by source line (untimed run, "
                f"{sum(r['kind'] == k for r in rows2)} frames): {json.dumps(top)}")
        for k in ("kfdb_add", "bow_word_ids", "kfdb_query_bow", "kfdb_detect_reloc",
                  "reloc_candidate", "reloc_refine", "loop_closing", "loop_detect"):
            if k in stages:
                log(f"[{name}] {smi}: stage {k}: {json.dumps(stages[k])}")
        if launches != len(rows) or any(r["fast_launches"] != 1 for r in rows):
            raise AssertionError(f"[{name}] FAST kernel launched {launches} times over "
                                 f"{len(rows)} frames, expected once a frame")
        log(f"[{name}] small_linalg launches over the run: {sl_launches}")
        if sl_launches == 0:
            raise AssertionError(f"[{name}] the small_linalg kernel was not launched")
        return slam, rows, res, events, audit

    # ---- Run R: forced loss, synchronous mapping, held to the reference ----
    slam, rows, res_r, events, _ = run("run_r", False, True, run_r_images, run_r_ts)
    ref_states = rf["states"].tolist()
    states = [r["state"] for r in rows]
    mismatch = [i for i, (a, b) in enumerate(zip(states, ref_states)) if a != b]
    lost = [i for i, st in enumerate(states) if st == TrackState.LOST.value]
    ref_lost = [i for i, st in enumerate(ref_states) if st == TrackState.LOST.value]
    back = next((i for i in range(lost[0], len(states))
                 if states[i] == TrackState.WORKING.value), None) if lost else None
    ref_back = next(i for i in range(ref_lost[0], len(ref_states))
                    if ref_states[i] == TrackState.WORKING.value)
    ref_log = json.loads(str(rf["reloc_log"]))
    cands = [e["cands"] for e in events if e["event"] == "reloc_candidates"]
    ref_cands = [e["cands"] for e in ref_log if e["event"] == "reloc_candidates"]
    dc = [float(np.abs(np.subtract(r["centre"], _centre(rf["poses"][r["frame"]]))).max())
          for r in rows if back is not None and r["frame"] >= back and r["centre"] is not None
          and np.isfinite(rf["poses"][r["frame"]]).all()]
    ate = _kf_ate_seq(slam, seq_ts, rf["gt_R"], rf["gt_t"])
    ref_ate = float(rf["kf_ate"])
    attempts = []
    for e in events:
        if e["event"] == "reloc_candidates":
            attempts.append({"frame": e["frame"], "cands": e["cands"], "tried": 0,
                             "accepted_by": None})
        elif e["event"] == "reloc_attempt":
            attempts[-1]["tried"] += 1
        elif e["event"] == "reloc_opt" and e["n_inliers"] >= 50:
            attempts[-1]["accepted_by"] = "pnp + pose optimization"
        elif e["event"] == "reloc_refine" and e["n_inliers"] >= 50:
            attempts[-1]["accepted_by"] = f"rung {e['radius']} px"
    enter_fused = next((r["frame"] for r in rows if back is not None and r["frame"] > back
                        and r["fused"]), None)
    res_r.update({
        "state_mismatch_frames": mismatch, "lost_frames": lost, "ref_lost_frames": ref_lost,
        "working_again": back, "ref_working_again": ref_back, "candidates": cands,
        "ref_candidates": ref_cands, "max_dcentre_after_recovery": max(dc) if dc else None,
        "kf_ate": ate, "ref_kf_ate": ref_ate, "relocalizations": attempts,
        "reloc_log": [e for e in events if e["event"].startswith("reloc_")], "ref_reloc_log": ref_log,
    })
    log(f"[run_r] outcome: states differ on frames {mismatch}; LOST on {lost} (ref {ref_lost}); "
        f"WORKING again on {back} (ref {ref_back}); candidate lists {cands} (ref {ref_cands}); "
        f"max centre diff after recovery {res_r['max_dcentre_after_recovery']}; kf ATE "
        f"{ate:.6f} (ref {ref_ate:.6f}); keyframes {slam.n_keyframes} (ref "
        f"{int(rf['n_keyframes'])}), points {slam.n_points} (ref {int(rf['n_points'])})")
    log(f"[run_r] relocalizations: {json.dumps(attempts)}; log "
        f"{json.dumps(res_r['reloc_log'])}")
    if len(mismatch) > RELOC_STATE_MISMATCH_MAX:
        raise AssertionError(f"[run_r] states differ from the reference on frames {mismatch}")
    if not lost or back is None:
        raise AssertionError(f"[run_r] no loss and recovery: LOST on {lost}, back on {back}")
    if back != ref_back or back - lost[0] > RELOC_WITHIN_FRAMES:
        raise AssertionError(f"[run_r] WORKING again on frame {back}, reference {ref_back}, "
                             f"lost on {lost[0]}")
    if not cands or cands[0] != ref_cands[0]:
        raise AssertionError(f"[run_r] first candidate list {cands[:1]}, reference {ref_cands[:1]}")
    if not dc or max(dc) > SYS_CENTRE_TOL:
        raise AssertionError(f"[run_r] camera centres after recovery off by {max(dc, default=None)}")
    if not np.isfinite(ate) or ate > ref_ate + SYS_ATE_MARGIN:
        raise AssertionError(f"[run_r] keyframe ATE {ate} above the reference's {ref_ate}")
    if enter_fused is None:
        raise AssertionError("[run_r] the fused path was not re-entered after relocalization")
    log(f"[run_r] fused path re-entered on frame {enter_fused}")
    init_frame_r = next(r["frame"] for r in rows if r["state"] == TrackState.WORKING.value)
    del slam

    # ---- Run A: asynchronous mapping, held to outcomes and invariants ----
    slam, rows, res_a, events, audit = run("run_a", True, False, seq_images, seq_ts)
    states = [r["state"] for r in rows]
    init_frame_a = next((r["frame"] for r in rows if r["state"] == TrackState.WORKING.value), None)
    not_working = [r["frame"] for r in rows
                   if init_frame_a is not None and r["frame"] >= init_frame_a
                   and r["state"] != TrackState.WORKING.value]
    other = [r["frame"] for r in rows if r["kind"] == "other"]
    ate = _kf_ate_seq(slam, seq_ts, rf["gt_R"], rf["gt_t"])
    res_a.update({"init_frame": init_frame_a, "other_frames": other, "kf_ate": ate,
                  "ref_kf_ate_run_r": ref_ate})
    log(f"[run_a] outcome: WORKING from frame {init_frame_a} (run R {init_frame_r}); frames not "
        f"WORKING after it {not_working}; {len(other)} WORKING frames that insert no keyframe; "
        f"kf ATE {ate:.6f} (run R's reference {ref_ate:.6f})")
    if init_frame_a != init_frame_r:
        raise AssertionError(f"[run_a] initialised on frame {init_frame_a}, run R on {init_frame_r}")
    if not_working:
        raise AssertionError(f"[run_a] not WORKING on frames {not_working}")
    if not other:
        raise AssertionError("[run_a] every WORKING frame inserted a keyframe")
    audit.check(Slam.STAGES)
    if not np.isfinite(ate) or ate > ref_ate + SYS_ATE_MARGIN:
        raise AssertionError(f"[run_a] keyframe ATE {ate} above run R's reference {ref_ate}")
    # the eleventh stage: queued for every keyframe, run at most once, one
    # `loop_detect` for each that ran, and no loop closed on this sequence
    # (as the reference: its 300-frame run of it closes none either)
    loops_run = sum(e["ran"].count("loop") for e in audit.entries)
    n_detect = res_a["stages"].get("loop_detect", {}).get("count", 0)
    res_a.update({"loop_stages_run": loops_run, "loop_detect_count": n_detect,
                  "n_loops_closed": slam.n_loops_closed})
    log(f"[run_a] {loops_run} \"loop\" stages ran for {len(audit.entries)} keyframes queued, "
        f"{n_detect} loop_detect traced, {slam.n_loops_closed} loops closed")
    if any(e["queued"] != list(Slam.STAGES) for e in audit.entries):
        raise AssertionError("[run_a] a keyframe was queued without the eleven stages")
    if loops_run == 0 or n_detect != loops_run or slam.n_loops_closed != 0:
        raise AssertionError(f"[run_a] {loops_run} loop stages, {n_detect} loop_detect, "
                             f"{slam.n_loops_closed} loops closed")
    for name, res in (("run_r", res_r), ("run_a", res_a)):
        res["upload_and_epnp_waits"] = _upload_and_epnp_waits(res["sync_sites"])
        log(f"[{name}] waits at an upload or in the RANSAC solvers: "
            f"{res['upload_and_epnp_waits'] or 'none'}")
        if res["upload_and_epnp_waits"]:
            raise AssertionError(f"[{name}] an upload or a RANSAC solver waited for the device: "
                                 f"{res['upload_and_epnp_waits']}")
    log(f"[reloc_async] {smi}: Slam.warmup of the two systems "
        f"{[round(x, 2) for x in warmup_s]} s")
    return {"solve_pnp_alone": pnp_alone, "run_r": res_r, "run_a": res_a,
            "warmup_s": warmup_s}


# the solvers the relocalization candidate, the Sim3 RANSAC and the
# initialization attempt run inside their programs: none may wait
_WAIT_FREE = ("solvers/epnp.py", "solvers/pnp.py", "solvers/initializer.py",
              "solvers/sim3solver.py", "solvers/small_linalg.py", "ops/small_linalg_cuda.py")


def _upload_and_epnp_waits(sync_sites):
    """The synchronisations (by frame group, source line) made by a host ->
    device upload (`utils/host.py:upload`, which every upload of the
    tracking path goes through, pinned and queued) or anywhere in the
    RANSAC solvers (`_WAIT_FREE`: EPnP, PnP, the initializer, the Sim3
    solver and the small-matrix kernel's wrapper)."""
    import linecache

    bad = {}
    for kind, tally in sync_sites.items():
        for site, n in tally.items():
            path, _, line = site.rpartition(":")
            text = linecache.getline(os.path.join(REPO, path), int(line)) if line.isdigit() else ""
            upload = path.endswith("utils/host.py") and "pin_memory" in text
            if upload or path.endswith(_WAIT_FREE):
                bad.setdefault(kind, {})[site] = n
    return bad


# ---- the constructed loop ------------------------------------------------------

def loop_system(device, vocab, warmup=False, before_warmup=None, slam=None):
    """A default-constructor `Slam(cfg, vocab=vocab)` on `device` whose map
    is the constructed loop scene the fixture names (tools/loop_scene.py
    builds it from the seed), after `Slam.warmup()` when `warmup`
    (`before_warmup(slam)` first, when given); or `slam`, a system of an
    earlier call, put back as a fresh one (`Slam._restart`, its programs
    kept) and given the scene anew. Returns (slam, info, fixture arrays,
    meta)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loop_scene

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.map.map_state import MapState
    from orbslam_jpminipc_torch.pipeline.system import Slam

    lf = dict(np.load(LOOP_FIXTURE))
    meta = json.loads(str(lf["meta"]))
    st, info = loop_scene.build_loop_scene(MapState, meta["scene"], int(meta["seed"]),
                                           device=device)
    if info["cfg"] != meta["config"]:
        raise AssertionError(f"the scene's config {info['cfg']} is not the fixture's")
    cfg = SlamConfig(**info["cfg"])
    if slam is not None:
        slam._restart()
    else:
        slam = Slam(cfg, vocab=vocab, device=device)
        if warmup:
            if before_warmup is not None:
                before_warmup(slam)
            slam.warmup()
    if slam.loop_closer is None:
        raise AssertionError("the default constructor call built no loop closer")
    shape = (slam.map.max_kf, slam.map.max_mp, slam.map.n_feat, slam.map.max_obs)
    if shape != (st.max_kf, st.max_mp, st.n_feat, st.max_obs):
        raise AssertionError(f"the scene's capacities are not the system's {shape}")
    # the scene takes the place of the system's empty map
    slam.map = slam.tracker.map = slam.mapper.map = slam.loop_closer.map = st
    dm = slam.mapper.dmap
    dm.sync_all(st)
    loop_scene.finish_scene(st, info, slam.kfdb,
                            lambda ids: st.update_point_attributes(ids, cfg.scale_factors, dm))
    dm.sync_all(st)
    info["centres_before"] = loop_scene.camera_centres(st)
    return slam, info, lf, meta


def loop_run(slam, info, lf):
    """`Slam._loop_close` over the scene's tail keyframes until the loop
    closes, the reference's Sim3 minimal sets injected. Returns what
    happened, from the tracer's records and the map."""
    from orbslam_jpminipc_torch.utils.program import ProgramSet
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loop_scene

    st, closer, tracer = slam.map, slam.loop_closer, get_tracer()
    sets = iter(lf["sim3_sets"])
    closer.sim3_sampler = lambda mask, n_hyp: closer.dmap.put(next(sets))
    events, problems = [], []
    eg = closer.programs["essential_graph"]

    def keep_problem(iterations, prob):
        # a copy: the program's buffers take the next call's problem
        problems.append(type(prob)(*(x.clone() for x in prob)))
        return ProgramSet.run(eg, iterations, prob)

    tracer.log = lambda event, **f: events.append({"event": event, **f})
    eg.run = keep_problem
    per_kf = []
    try:
        for k in info["tail"]:
            n0, closed0 = len(events), slam.n_loops_closed
            slam._loop_close(k)
            ev = {e["event"]: e for e in events[n0:]}
            per_kf.append({"kf": int(k), "closed": slam.n_loops_closed > closed0,
                           "cands": ev.get("loop_detect", {}).get("cands", []),
                           "enough": ev.get("loop_consistency", {}).get("enough", [])})
            if per_kf[-1]["closed"]:
                break
    finally:
        del tracer.log
        del eg.run
    last = lambda name: next((e for e in reversed(events) if e["event"] == name), None)
    out = {"per_kf": per_kf, "events": events, "eg_problem": problems[-1] if problems else None,
           "closed_kf": next((r["kf"] for r in per_kf if r["closed"]), -1)}
    if out["closed_kf"] < 0:
        return out
    kf = out["closed_kf"]
    kinds = last("essential_graph_edges")
    out.update({
        "loop_kf": int(next(iter(st.kf_loop_edges[kf]))),
        "n_mutual": [e["n_match"] for e in events if e["event"] == "sim3_mutual" and e["kf"] == kf],
        "ransac": last("sim3_ransac"), "opt": last("sim3_opt"),
        "guided_total": [e["total"] for e in events if e["event"] == "sim3_guided" and e["kf"] == kf],
        "eg_kinds": {k: kinds[k] for k in ("loop", "spanning", "prior_loop", "covisibility")},
        "eg_n_edges": min(kinds["total"], kinds["cap"]), "eg_chi2": last("essential_graph_done")["chi2"],
        "loop_edges": sorted([int(a), int(b)] for a in range(st.max_kf)
                             for b in st.kf_loop_edges[a] if a < b),
        "centres_after": loop_scene.camera_centres(st),
        "lost_after": slam.tracker.state.name,
    })
    return out


def loop_hold(out, info, lf, meta):
    """Hold a `loop_run` outcome to the reference's recorded one. Returns
    the readings; raises where one is out of its bound."""
    if [(r["kf"], r["closed"], r["cands"], r["enough"]) for r in out["per_kf"]] != [
            (r["kf"], r["closed"], r["cands"], r["enough"]) for r in meta["per_kf"]]:
        raise AssertionError(f"[loop] per keyframe {out['per_kf']}, reference {meta['per_kf']}")
    if (out["closed_kf"], out["loop_kf"]) != (meta["closed_kf"], meta["loop_kf"]):
        raise AssertionError(f"[loop] closed on {out['closed_kf']} with {out['loop_kf']}, reference "
                             f"{meta['closed_kf']} with {meta['loop_kf']}")
    depth = info["median_depth"]
    r, o = out["ransac"], out["opt"]
    live = lf["kf_valid"]
    true_c = info["true_centres"]
    n = len(true_c)
    mean_err = lambda c: float(np.linalg.norm(c[:n] - true_c, axis=1).mean())
    ref_c = -np.einsum("kji,kj->ki", lf["kf_R"], lf["kf_t"])
    got = {
        "n_mutual": out["n_mutual"][-1], "ransac_inliers": r["n_inliers"],
        "opt_inliers": o["n_inliers"], "guided_total": out["guided_total"][-1],
        "ransac_ds": abs(r["s"] - float(lf["ransac_s"])),
        "ransac_dR": float(np.abs(np.array(r["R"]) - lf["ransac_R"]).max()),
        "ransac_dt": float(np.abs(np.array(r["t"]) - lf["ransac_t"]).max()) / depth,
        "opt_ds": abs(o["s"] - float(lf["opt_s"])),
        "opt_dR": float(np.abs(np.array(o["R"]) - lf["opt_R"]).max()),
        "opt_dt": float(np.abs(np.array(o["t"]) - lf["opt_t"]).max()) / depth,
        "eg_kinds": out["eg_kinds"], "eg_n_edges": out["eg_n_edges"], "eg_chi2": out["eg_chi2"],
        "max_dcentre": float(np.abs(out["centres_after"][live] - ref_c[live]).max()) / depth,
        "mean_centre_error_before": mean_err(info["centres_before"]),
        "mean_centre_error_after": mean_err(out["centres_after"]),
        "loop_edges": out["loop_edges"], "tracker_after": out["lost_after"],
    }
    ref = {"n_mutual": meta["n_mutual"][-1], "ransac_inliers": meta["ransac_n_inliers"][-1],
           "opt_inliers": meta["opt_n_inliers"][-1], "guided_total": meta["guided_total"][-1]}
    for k, v in ref.items():
        if abs(got[k] - v) > LOOP_COUNT_REL * v:
            raise AssertionError(f"[loop] {k} {got[k]}, reference {v}")
    for k in ("ransac_ds", "ransac_dR", "ransac_dt", "opt_ds", "opt_dR", "opt_dt"):
        if not got[k] <= LOOP_SIM3_TOL:
            raise AssertionError(f"[loop] {k} = {got[k]} above {LOOP_SIM3_TOL}")
    if got["eg_kinds"] != meta["eg_kinds"] or got["eg_n_edges"] != meta["eg_n_edges"]:
        raise AssertionError(f"[loop] essential-graph edges {got['eg_kinds']}, reference "
                             f"{meta['eg_kinds']}")
    if not abs(got["eg_chi2"] - meta["eg_chi2"]) <= LOOP_CHI2_REL * meta["eg_chi2"]:
        raise AssertionError(f"[loop] essential-graph chi2 {got['eg_chi2']}, reference "
                             f"{meta['eg_chi2']}")
    if not got["max_dcentre"] <= LOOP_CENTRE_TOL:
        raise AssertionError(f"[loop] camera centres off the reference's by {got['max_dcentre']} "
                             f"of the median depth")
    if not got["mean_centre_error_after"] < got["mean_centre_error_before"]:
        raise AssertionError(f"[loop] the correction moved the centres away from the truth: "
                             f"{got['mean_centre_error_before']} -> {got['mean_centre_error_after']}")
    if got["loop_edges"] != meta["loop_edges"]:
        raise AssertionError(f"[loop] loop edges {got['loop_edges']}, reference {meta['loop_edges']}")
    if got["tracker_after"] != "LOST":
        raise AssertionError("[loop] the closure did not force a relocalization")
    return got


def loop_global_ba(slam, meta, solve=None):
    """Global BA on the corrected map at full capacity: the problem
    `Slam.global_ba` builds, solved (through `solve(prob)` when given, e.g.
    to time it), held to the reference's chi2, then `Slam.global_ba`
    itself, which writes the result back."""
    import torch

    from orbslam_jpminipc_torch.solvers import ba, gba
    from orbslam_jpminipc_torch.utils.host import fetch

    st, cfg = slam.map, slam.cfg
    prob, n_obs = slam.build_global_ba_problem()
    shape = [prob.kf_R.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]]
    solve = solve or (lambda p: gba.bundle_adjust_large(
        p, iterations=cfg.gba_iterations, cg_iters=cfg.gba_cg_iters))
    res = solve(prob)
    chi0, chi1, kf_R, kf_t, fixed, R0, t0 = fetch(
        ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points), res.chi2, res.kf_R, res.kf_t,
        prob.kf_fixed, prob.kf_R, prob.kf_t)
    got = {"shape": shape, "n_obs": int(n_obs), "chi2_before": float(chi0),
           "chi2_after": float(chi1), "ref_chi2_before": meta["gba_chi2_before"],
           "ref_chi2_after": meta["gba_chi2_after"], "held_cameras": int(fixed.sum())}
    if shape != meta["gba_shape"] or n_obs != meta["gba_n_obs"]:
        raise AssertionError(f"[loop] global BA shape {shape} with {n_obs} observations, reference "
                             f"{meta['gba_shape']} with {meta['gba_n_obs']}")
    if not chi1 < chi0:
        raise AssertionError(f"[loop] global BA did not lower chi2: {chi0} -> {chi1}")
    if not abs(chi1 - meta["gba_chi2_after"]) <= LOOP_CHI2_REL * meta["gba_chi2_after"]:
        raise AssertionError(f"[loop] global BA ends at chi2 {chi1}, reference "
                             f"{meta['gba_chi2_after']}")
    if not (np.array_equal(kf_R[fixed], R0[fixed]) and np.array_equal(kf_t[fixed], t0[fixed])):
        raise AssertionError("[loop] global BA moved a held camera")
    if not (np.isfinite(kf_R).all() and np.isfinite(kf_t).all()):
        raise AssertionError("[loop] global BA returned non-finite poses")
    # the entry point: solves the same problem again and writes it back
    gauge = int(np.nonzero(st.kf_valid)[0][np.argmin(st.kf_frame_id[st.kf_valid])])
    R_g, t_g = st.kf_R[gauge].copy(), st.kf_t[gauge].copy()
    res2 = slam.global_ba()
    got["entry_point_chi2"] = float(fetch(res2.chi2)[0])
    moved = float(np.abs(st.kf_t[st.kf_valid] - t0[st.kf_valid]).max())
    if not (np.array_equal(st.kf_R[gauge], R_g) and np.array_equal(st.kf_t[gauge], t_g)) \
            or moved == 0.0 or not np.isfinite(st.mp_xyz[st.mp_valid]).all():
        raise AssertionError(f"[loop] Slam.global_ba wrote back wrongly (largest move {moved})")
    return got


def _profile_kernels(torch, fn):
    """Run `fn` once under torch.profiler: kernels launched and their time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _is_device_event(e)]
    top = sorted(kernels, key=_device_time_us, reverse=True)[:6]
    return {"kernels": sum(e.count for e in kernels),
            "device_ms": sum(_device_time_us(e) for e in kernels) / 1e3,
            "top": [{"name": e.key[:80], "device_ms": _device_time_us(e) / 1e3, "count": e.count}
                    for e in top]}


def phase_loop(torch, fast_cuda, smi):
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from orbslam_jpminipc_torch.ops import small_linalg_cuda
    from orbslam_jpminipc_torch.solvers import essential_graph, gba
    from orbslam_jpminipc_torch.utils.program import CallLog, ProgramSet
    from orbslam_jpminipc_torch.utils.tracing import get_tracer
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    vocab = load_vocabulary(VOCAB)
    tracer = get_tracer()
    launches0 = fast_cuda.LAUNCHES

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    # a first pass, untimed, under CUDA sync debug mode: where the host
    # waits. Its system's programs are captured part by part first
    # (seconds, memory), then Slam.warmup; the same system, put back as a
    # fresh one, makes the timed pass
    compiled = []
    slam2, info2, lf2, _ = loop_system(
        "cuda", vocab, warmup=True,
        before_warmup=lambda s: compiled.append(timed_compile(torch, s)))
    ransac = slam2.loop_closer.programs["sim3_ransac"]
    with warnings.catch_warnings(record=True) as caught, CallLog() as calls, \
            _patch(ransac, "run", _labelled(torch, "sim3_ransac")):
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out2 = loop_run(slam2, info2, lf2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            slam2.global_ba()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    closure = _launch_counts(prof, 1)
    log(f"[loop] {smi}: the closure pass ({len(out2['per_kf'])} keyframes: detection, Sim3, "
        f"correction; first pass, under the profiler): {json.dumps(closure)}")
    ransac_calls = _launches_in(prof, "sim3_ransac")
    log(f"[loop] {smi}: the Sim3 RANSAC program (first pass): {json.dumps(ransac_calls)}")
    if not ransac_calls["calls"] or ransac_calls["host_by_api_per_call"].get(
            "cudaGraphLaunch") != 1.0:
        raise AssertionError(f"[loop] the Sim3 RANSAC is not one replay: {ransac_calls}")
    # loop closing's programs against their eager runs on the closure's inputs
    programs = hold_programs(torch, calls.calls, "loop")
    del calls
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    log(f"[loop] host synchronisations by source line (first pass, sync debug mode, "
        f"{len(out2['per_kf'])} keyframes and one global BA): "
        f"{json.dumps(sorted(sites.items(), key=lambda kv: -kv[1]))}")
    in_solvers = {k: v for k, v in sites.items() if any(
        f"solvers/{m}.py" in k for m in ("essential_graph", "sim3_opt", "gba", "ba", "linalg3"))
        or "geometry/" in k or k.rpartition(":")[0].endswith(_WAIT_FREE)}
    if in_solvers:
        raise AssertionError(f"[loop] a solver's iterations wait for the host: {in_solvers}")
    # the main pass: timed by stage, held to the reference
    (slam, info, lf, meta), build_ms = timed(lambda: loop_system("cuda", vocab, slam=slam2))
    del slam2
    # the phase's own path starts here: Slam.warmup drove frames through FAST
    launches0 = fast_cuda.LAUNCHES
    log(f"[loop] scene {meta['scene']} seed {meta['seed']}: {slam.n_keyframes} keyframes, "
        f"{slam.n_points} points, capacities {slam.map.max_kf} x {slam.map.max_mp} x "
        f"{slam.map.n_feat}, eg_edges {slam.cfg.eg_edges}, built in {build_ms:.0f} ms "
        f"(the first pass's system put back as a fresh one)")
    tracer.reset()
    torch.cuda.reset_peak_memory_stats()   # (allocated bytes: the cache stays warm)
    reads0 = _reads()
    small_linalg_cuda.LAUNCHES = 0
    out, run_ms = timed(lambda: loop_run(slam, info, lf))
    sl_launches = small_linalg_cuda.LAUNCHES
    log(f"[loop] small_linalg launches over the timed pass: {sl_launches}")
    if sl_launches == 0:
        raise AssertionError("[loop] the small_linalg kernel was not launched")
    if out["closed_kf"] < 0:
        raise AssertionError(f"[loop] the loop did not close: {out['per_kf']}")
    held = loop_hold(out, info, lf, meta)
    if out2["closed_kf"] != out["closed_kf"]:
        raise AssertionError(f"[loop] the first pass closed on {out2['closed_kf']}")
    stages = {k: v for k, v in tracer.summary().items()
              if k.startswith(("loop_", "sim3_", "kfdb", "attrs"))}
    log(f"[loop] outcome: {json.dumps(held)}")
    for k, v in stages.items():
        log(f"[loop] {smi}: stage {k}: {json.dumps(v)}")
    gba_ms = []

    def timed_solve(p):
        res, ms = timed(lambda: gba.bundle_adjust_large(
            p, iterations=slam.cfg.gba_iterations, cg_iters=slam.cfg.gba_cg_iters))
        gba_ms.append(ms)
        return res

    ba_held = loop_global_ba(slam, meta, solve=timed_solve)
    peak = torch.cuda.max_memory_allocated()
    log(f"[loop] {smi}: global BA {slam.cfg.gba_iterations} x {slam.cfg.gba_cg_iters} at "
        f"{ba_held['shape']} with {ba_held['n_obs']} observations: {gba_ms[0]:.1f} ms; "
        f"{json.dumps(ba_held)}")
    log(f"[loop] {smi}: the whole pass over {len(out['per_kf'])} keyframes {run_ms:.1f} ms, "
        f"{_reads() - reads0} batched reads; peak device memory {peak} bytes")

    # the two long solvers alone, under the profiler: kernels launched; the
    # essential graph captured (its replay, the copies in and out) and eager,
    # and its capture alone: seconds, the memory its pool holds
    prob = out["eg_problem"]
    eg_prog = slam.loop_closer.programs["essential_graph"]
    eg_prof = _profile_kernels(torch, lambda: eg_prog.run(20, prob))
    _, eg_ms = timed(lambda: eg_prog.run(20, prob))
    eg_eager_prof = _profile_kernels(torch, lambda: essential_graph.optimize_essential_graph(
        prob, iterations=20))
    _, eg_eager_ms = timed(lambda: essential_graph.optimize_essential_graph(prob, iterations=20))
    alone = ProgramSet(lambda v, p: essential_graph.optimize_essential_graph(p, iterations=v),
                       "cuda", "essential_graph_alone")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    _, eg_capture_ms = timed(lambda: alone.capture(20, prob))
    torch.cuda.empty_cache()
    eg_capture = {"capture_s": eg_capture_ms / 1e3,
                  "reserved_bytes": torch.cuda.memory_reserved() - r0}
    del alone
    ba_prob, _ = slam.build_global_ba_problem()
    ba_prof = _profile_kernels(torch, lambda: gba.bundle_adjust_large(
        ba_prob, iterations=slam.cfg.gba_iterations, cg_iters=slam.cfg.gba_cg_iters))
    log(f"[loop] {smi}: essential graph alone (20 iterations, K = {prob.s.shape[0]}, "
        f"{held['eg_n_edges']} edges in {prob.e_i.shape[0]} slots): captured {eg_ms:.1f} ms, "
        f"{json.dumps(eg_prof)}; eager {eg_eager_ms:.1f} ms, {json.dumps(eg_eager_prof)}; its "
        f"capture alone {json.dumps(eg_capture)}")
    log(f"[loop] {smi}: global BA under the profiler: {json.dumps(ba_prof)}")

    if fast_cuda.LAUNCHES != launches0:
        raise AssertionError("[loop] the FAST kernel ran: it is not on this phase's path")
    log("[loop] the FAST kernel is not on this phase's path: 0 launches")
    return {"card": smi, "scene": {k: meta[k] for k in ("scene", "seed", "n_keyframes",
                                                       "n_points_before", "config")},
            "held": held, "per_kf": out["per_kf"], "stages": stages, "pass_ms": run_ms,
            "global_ba": ba_held, "global_ba_ms": gba_ms[0], "global_ba_profile": ba_prof,
            "essential_graph_ms": eg_ms, "essential_graph_profile": eg_prof,
            "essential_graph_eager_ms": eg_eager_ms,
            "essential_graph_eager_profile": eg_eager_prof,
            "essential_graph_capture": eg_capture, "compile": compiled[0],
            "closure_pass_profile": closure, "sim3_ransac_call": ransac_calls,
            "small_linalg_launches": sl_launches,
            "programs": programs, "sync_sites": sites, "peak_mem_bytes": int(peak),
            "fast_launches": 0}


# ---- the sequence: renderer, command line, resume ---------------------------

# run in a process of its own: the command line's main path, once per mode
# named in argv[2] ("default", or "synchronous": `pipelined_tracking=False`),
# each `Slam.process` call timed to its return and sorted by frame group, the
# FAST kernel's and the branch kernel's launches counted from 0 over the run
# after run.py's warmup (timed apart: `wall_s` is run.main without it)
_SEQUENCE_RUN = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from orbslam_jpminipc_torch import run
from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.ops import fast_cuda
from orbslam_jpminipc_torch.pipeline import system
from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils import graph_chain
rows, kfs = [], []
process, insert = Slam.process, LocalMapper.insert_keyframe

def timed(self, image, timestamp=0.0):
    was, k0 = self.tracker.state, len(kfs)
    t0 = time.perf_counter()
    out = process(self, image, timestamp)
    ms = (time.perf_counter() - t0) * 1e3
    kind = ("lost" if TrackState.LOST in (was, out[0]) else "init" if was != TrackState.WORKING
            else "keyframe" if len(kfs) > k0 else "other")
    rows.append({"ms": ms, "kind": kind, "state": out[0].value, "t0": t0})
    return out

warm, warm_s, mem = Slam.warmup, [], {}
compile_programs, build_chain = Slam._compile_programs, FusedContext._build_chain


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def timed_part(key, fn):
    def wrapped(self):
        t0 = time.perf_counter()
        fn(self)
        torch.cuda.synchronize()
        mem[key] = mem.get(key, 0.0) + time.perf_counter() - t0
    return wrapped


def warmup(self):
    # run.py's warmup: timed on its own, with its parts (the captures, the
    # step's chain) and the host's resident memory around it; the rows,
    # keyframes and FAST launches count from its end
    mem["rss_before_warmup"] = rss()
    t0 = time.perf_counter()
    warm(self)
    torch.cuda.synchronize()
    warm_s.append(time.perf_counter() - t0)
    mem.update(rss_after_warmup=rss(), reserved_after_warmup=torch.cuda.memory_reserved())
    rows.clear()
    kfs.clear()
    fast_cuda.LAUNCHES = graph_chain.LAUNCHES = 0


class Synchronous(Slam):
    def __init__(self, cfg, *a, **k):
        cfg.pipelined_tracking = False
        super().__init__(cfg, *a, **k)


Slam.process = timed
Slam.warmup = warmup
Slam._compile_programs = timed_part("compile_programs_s", compile_programs)
FusedContext._build_chain = timed_part("chain_build_s", build_chain)
LocalMapper.insert_keyframe = lambda self, frame: (kfs.append(frame.frame_id), insert(self, frame))[1]
fast_cuda.build()
graph_chain.build()
for mode in json.loads(sys.argv[2]):
    system.Slam = Synchronous if mode == "synchronous" else Slam
    rows, kfs, warm_s = [], [], []
    mem.clear()
    fast_cuda.LAUNCHES = graph_chain.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam = run.main(sys.argv[3:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - sum(warm_s)
    kft = slam.keyframe_trajectory()
    print("RESULT " + json.dumps({
        "mode": mode, "tracking": "pipelined" if slam.cfg.pipelined_tracking else "synchronous",
        "rows": rows, "fast_launches": fast_cuda.LAUNCHES,
        "branch_launches": graph_chain.LAUNCHES, "wall_s": wall, "warmup_s": warm_s,
        "frames_tracked": len(slam.trajectory), "n_keyframes": slam.n_keyframes,
        "n_points": slam.n_points, "loops_closed": slam.n_loops_closed,
        "keyframes_inserted": len(kfs), "kf_ts": [t for t, _, _ in kft],
        "kf_centres": [(-R.T @ t).tolist() for _, R, t in kft],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "warmup_parts": dict(mem)}),
        flush=True)
    del slam
"""


def _wait_sites(torch, slam, fn):
    """Run `fn` (which drives `slam`) counting every wait for the device by
    source line: host synchronisations (CUDA sync debug mode) and the takes
    of a queued read that had not landed (`AsyncFetch.result`, an event
    wait the debug mode does not see). Each wait is filed under what the
    system was doing: completing a forced head or draining the queue
    ("forced"), the host tracking path ("host path"), a hard mapping drain
    or `finish` ("drain"), else "other": a pipelined `process` call that
    should not have waited. A wait inside `utils/host.py` (a read) names
    the port's line that asked for the read ("via ...")."""
    import traceback
    import warnings

    from orbslam_jpminipc_torch.pipeline import system as psystem
    from orbslam_jpminipc_torch.utils import host

    active, sites = [], {}

    def note(filename, lineno):
        kind = next((k for k in ("forced", "drain", "host path") if k in active), "other")
        site = f"{kind} {os.path.relpath(filename, REPO)}:{lineno}"
        if filename.endswith(os.path.join("utils", "host.py")):
            inside = False
            for f in reversed(traceback.extract_stack()):
                if f.filename.endswith(os.path.join("utils", "host.py")):
                    inside = True
                elif inside:
                    site += f" via {os.path.relpath(f.filename, REPO)}:{f.lineno}"
                    break
        if filename.endswith(os.path.join("map", "map_state.py")):
            # an attrs read taken before it landed: who forced it
            port = [f for f in traceback.extract_stack()[:-2]
                    if "orbslam_jpminipc_torch" in f.filename
                    and not f.filename.endswith(os.path.join("map", "map_state.py"))]
            site += " via " + " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                                         for f in reversed(port[-3:]))
        sites[site] = sites.get(site, 0) + 1

    def labelled(label):
        def make(orig):
            def wrapped(*a, **k):
                active.append(label(*a, **k) if callable(label) else label)
                try:
                    return orig(*a, **k)
                finally:
                    active.pop()
            return wrapped
        return make

    tr = slam.tracker
    stack = contextlib.ExitStack()
    for obj, name, label in (
            (slam, "_drain_inflight", lambda force=False, drain_all=False:
             "forced" if force or drain_all else "completion"),
            (slam, "_drain_mapping_hard", "drain"), (slam, "finish", "drain"),
            (tr, "process_frame", "host path"), (tr, "_track_frame", "host path"),
            (tr, "_track_local_map", "host path"), (psystem, "build_frame", "host path")):
        stack.enter_context(_patch(obj, name, labelled(label)))
    result = host.AsyncFetch.result

    def taken(self):
        if self._arrays is None and not self.done():
            f = traceback.extract_stack()[-2]
            note(f.filename, f.lineno)
        return result(self)

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            note(filename, lineno)

    stack.enter_context(_patch(host.AsyncFetch, "result", lambda result: taken))
    with stack, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def _branch_kernel(torch, fx, smi):
    """The chain's branch kernel held against its plain version, the host
    read `FusedContext.track` makes: the step as one chain (`dispatch`)
    against its segments (`track`), equal bits, on the frames of the graphs
    phase: the tracking fixture's fed forward, the recovery frame and a
    low-texture frame, so that each predicate takes both values (a level's
    fast-path flag, the recovery test). Then the kernel's device time inside
    the step's chain (torch.profiler, 10 dispatches) against the plain
    version's (one host read of a predicate, host clock)."""
    from torch.profiler import ProfilerActivity, profile

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.fused_track import FusedContext

    sf = dict(np.load(SLAM_FIXTURE))
    frames = [(f"fixture {k}", im, None) for k, im in enumerate(fx["images"])]
    frames += [("recovery", fx["images"][0], (sf["recovery_R0"], sf["recovery_t0"],
                                              (fx["vel_R0"], fx["vel_t0"]))),
               ("low texture", _low_texture_frame(fx["images"][0]), None)]
    outs, arms = [], []
    for name in ("track", "dispatch"):
        ctx = _context(FusedContext, SlamConfig, fx)
        _seed(ctx, fx)
        run = []
        for _, img, seed in frames:
            if seed is not None:
                ctx.set_pose(seed[0], seed[1], velocity=seed[2])
            out = getattr(ctx, name)(torch.as_tensor(img).cuda())
            run.append(list(_step_fields(out).values())
                       + [x.clone() for x in (ctx.R, ctx.t, ctx.vel_R, ctx.vel_t)])
            if name == "track":
                arms.append({"slow_levels": [k for k, ok in enumerate(ctx.last_fast_ok)
                                             if not ok],
                             "recovery": ctx.last_pass1_inliers < 20})
        outs.append(run)
    per_frame = [max(float((a.double() - b.double()).abs().max()) if a.is_floating_point()
                     else float((a.long() - b.long()).abs().max()) for a, b in zip(fa, fb))
                 for fa, fb in zip(*outs)]
    unequal = [f[0] for f, fa, fb in zip(frames, *outs)
               if not all(torch.equal(a, b) for a, b in zip(fa, fb))]
    err = max(per_frame)
    n_levels = len(ctx.step.plan)
    slow = sum(len(r["slow_levels"]) for r in arms)
    recovered = sum(r["recovery"] for r in arms)
    # the pipelined step's own launches from the host and kernel time, and
    # the branch kernel's device time inside it: the last context's
    # dispatch over 10 frames under the profiler
    img = torch.as_tensor(fx["images"][0]).cuda()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ctx.dispatch(img)
        torch.cuda.synchronize()
    step = _launch_counts(prof, 10)
    kern = [e for e in prof.key_averages()
            if _is_device_event(e) and "chain_branch_kernel" in e.key]
    n_kern = sum(e.count for e in kern)
    if n_kern == 0:
        raise AssertionError("[pipelined] no branch kernel in the profiled dispatches")
    ms = sum(_device_time_us(e) for e in kern) / n_kern / 1e3
    pred = ctx._detect.captured(None).out.fast_ok[:1]
    torch.cuda.synchronize()
    reads = []
    for _ in range(50):
        t0 = time.perf_counter()
        bool(pred)
        reads.append((time.perf_counter() - t0) * 1e3)
    plain_ms = float(np.median(reads[10:]))
    # the least time: the predicate byte read once; its compare and the two
    # handle writes at the card's float32 rate
    bound_b, bound_o = 1 / HBM_BYTES_PER_S * 1e3, 3 / FP32_OPS_PER_S * 1e3
    res = {"max_abs_err": err, "frames": len(frames), "unequal_frames": unequal,
           "arms": {"slow_levels": slow, "fast_levels": n_levels * len(frames) - slow,
                    "recovery": recovered, "no_recovery": len(frames) - recovered},
           "ms": ms, "profiled_launches": n_kern, "plain_ms": plain_ms,
           "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations", "dispatch": step}
    log(f"[pipelined] {smi}: the step's chain against its segments with their host reads "
        f"over {len(frames)} frames (fixture, recovery, low texture): max abs difference "
        f"{err}, frames not equal {unequal}; arms taken by track: {json.dumps(res['arms'])}; "
        f"the branch kernel {ms:.4f} ms per launch inside the step's chain (torch.profiler, "
        f"{n_kern} launches), the host read it replaces {plain_ms:.4f} ms (host clock); a "
        f"dispatch (torch.profiler, 10 frames): "
        f"{step['host_launches_per_call']:.1f} launches from the host "
        f"{json.dumps(step['host_by_api_per_call'])}, {step['device_ops_per_call']:.0f} device "
        f"ops, {step['device_ms_per_call']:.2f} ms of kernel time")
    if unequal or err != 0:
        raise AssertionError(f"[pipelined] the chain's step is off the segments' on {unequal}")
    if not (slow and n_levels * len(frames) - slow and recovered and len(frames) - recovered):
        raise AssertionError(f"[pipelined] the frames did not take both arms of both "
                             f"branches: {res['arms']}")
    return res


def phase_pipelined(torch, fast_cuda, smi, sequence=None):
    """Run P: the default config (pipelined tracking, asynchronous mapping)
    on a warmed system over the system fixture's 28 frames with a noise
    frame after frame 3; then run.py xyz:300 pipelined and synchronous in
    one process (`sequence`: the sequence phase's result, whose runs these
    are when it ran)."""
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.utils import graph_chain

    res = {"card": smi, "branch_kernel": _branch_kernel(torch, dict(np.load(FIXTURE)), smi)}
    sf = dict(np.load(SLAM_FIXTURE))
    meta = json.loads(str(sf["meta"]))
    cfg = SlamConfig(**dict(meta["config"], pipelined_tracking=True, async_mapping=True))
    if cfg != SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000):
        raise AssertionError("[pipelined] Run P's config is not the default one")
    images = [torch.as_tensor(im).cuda() for im in sf["images"]]
    ts = [float(t) for t in sf["timestamps"]]
    noise = np.random.default_rng(7).integers(0, 256, (480, 640)).astype(np.uint8)
    images.insert(PIPE_NOISE_AT, torch.as_tensor(noise).cuda())
    ts.insert(PIPE_NOISE_AT, 0.5 * (ts[PIPE_NOISE_AT - 1] + ts[PIPE_NOISE_AT]))
    n = len(images)

    slam = Slam(cfg, vocab=None, device="cuda")
    t0 = time.perf_counter()
    slam.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    def drive(slam=slam):
        """The frames through `process`; completions, depths and stale
        records counted. Timed: each call to its return (it queues device
        work), the whole run to the end of its device work."""
        done, depths, stale, kfs, rows = [], [], [], [], []
        stack = contextlib.ExitStack()
        stack.enter_context(_patch(slam, "_after_track", lambda after: lambda st, fr, t: (
            done.append(None if fr is None else fr.frame_id), after(st, fr, t))[1]))
        stack.enter_context(_patch(slam, "_drain_inflight", lambda drain: lambda force=False,
                                   drain_all=False: (depths.append(len(slam._inflight)),
                                                     drain(force, drain_all))[1]))
        stack.enter_context(_patch(slam.tracker, "reprocess_stale", lambda reproc: lambda rec: (
            stale.append(rec.frame_id), reproc(rec))[1]))
        stack.enter_context(_patch(slam.mapper, "insert_keyframe", lambda insert: lambda fr: (
            kfs.append(fr.frame_id), insert(fr))[1]))
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        with stack:
            for img, t in zip(images, ts):
                pipelined = slam.tracker.fused_usable(slam.frame_count)
                k0 = len(kfs)
                t0 = time.perf_counter()
                with torch.profiler.record_function("pipelined_call" if pipelined else "call"):
                    state, frame = slam.process(img, t)
                ms = (time.perf_counter() - t0) * 1e3
                kind = ("pipelined_keyframe" if pipelined and len(kfs) > k0
                        else "pipelined_other" if pipelined else "host")
                rows.append({"ms": ms, "kind": kind, "state": state.value,
                             "depth": len(slam._inflight),
                             "completed": None if frame is None else frame.frame_id})
            slam.finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
        return {"rows": rows, "completed": done, "depths": depths, "stale": stale,
                "keyframes_inserted": kfs, "wall_s": wall}

    # first the waits by source line and the launches from the host, untimed
    # (sync debug mode and the profiler slow the calls); then, the system put
    # back as a fresh one, the timed run with every count from 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        waits_box = {}
        waits_box["sites"] = _wait_sites(torch, slam, lambda: waits_box.update(run=drive()))
    launches = _launches_in(prof, "pipelined_call")
    untimed = waits_box["run"]
    slam._restart()
    fast_cuda.LAUNCHES = graph_chain.LAUNCHES = 0
    run = drive()
    fast_launches, branch_launches = fast_cuda.LAUNCHES, graph_chain.LAUNCHES
    rows = run["rows"]
    groups = {k: _percentiles([r["ms"] for r in rows if r["kind"] == k])
              for k in ("host", "pipelined_keyframe", "pipelined_other")}
    hist = {}
    for d in run["depths"]:
        hist[d] = hist.get(d, 0) + 1
    waits = waits_box["sites"]
    other_waits = {k: v for k, v in waits.items() if k.startswith("other ")}
    n_pipelined = sum(r["kind"] != "host" for r in rows)
    p = {"frames": n, "warmup_s": warmup_s, "wall_s": run["wall_s"],
         "frames_per_s": n / run["wall_s"], "ms_per_frame": groups,
         "depth_histogram": {str(k): v for k, v in sorted(hist.items())},
         "stale_reprocessed": len(run["stale"]), "stale_untimed_run": len(untimed["stale"]),
         "pipelined_calls": n_pipelined, "waits_by_site": waits,
         "waits_outside_forced_drain_host": sum(other_waits.values()),
         "launches_from_host_per_call": launches["host_launches_per_call"],
         "launches_by_api_per_call": launches["host_by_api_per_call"],
         "fast_launches": fast_launches, "branch_launches": branch_launches,
         "frames_tracked": len(slam.trajectory), "n_keyframes": slam.n_keyframes,
         "n_points": slam.n_points, "keyframes_inserted": len(run["keyframes_inserted"]),
         "states": [r["state"] for r in rows], "completed_per_call": [r["completed"] for r in rows]}
    res["run_p"] = p
    for k, g in groups.items():
        log(f"[pipelined] {smi}: Run P {k} calls, ms per process (to the call's return): "
            f"{json.dumps(g)}")
    log(f"[pipelined] {smi}: Run P {n} frames (noise after frame {PIPE_NOISE_AT - 1}) in "
        f"{run['wall_s']:.3f} s = {p['frames_per_s']:.2f} frames a second after a "
        f"{warmup_s:.1f} s warmup; {n_pipelined} pipelined calls; in-flight depth at each "
        f"drain {json.dumps(p['depth_histogram'])}; stale records tracked again "
        f"{p['stale_reprocessed']} (untimed run {p['stale_untimed_run']}); tracked "
        f"{p['frames_tracked']}, keyframes {p['n_keyframes']} (inserted "
        f"{p['keyframes_inserted']}), points {p['n_points']}; FAST launches {fast_launches}, "
        f"branch kernel launches {branch_launches}")
    log(f"[pipelined] {smi}: Run P waits by source line (untimed run): {json.dumps(waits)}; "
        f"outside a forced head, a drain or the host path: {p['waits_outside_forced_drain_host']}")
    log(f"[pipelined] {smi}: Run P launches from the host per pipelined process call "
        f"(untimed run, torch.profiler, {launches['calls']} calls): "
        f"{launches['host_launches_per_call']:.1f} {json.dumps(launches['host_by_api_per_call'])}")
    if sorted(run["completed"]) != list(range(n)) or run["completed"] != sorted(run["completed"]):
        raise AssertionError(f"[pipelined] frames completed {run['completed']}: every one of "
                             f"0..{n - 1} once, in frame order")
    tss = [t for t, _, _ in slam.trajectory]
    if tss != sorted(tss) or len(slam._inflight) != 0:
        raise AssertionError("[pipelined] trajectory out of frame order or records left in flight")
    links = len(slam.tracker.fused.step.plan) + 1
    if n_pipelined == 0 or branch_launches != links * n_pipelined:
        raise AssertionError(f"[pipelined] {branch_launches} branch launches for "
                             f"{n_pipelined} pipelined calls")
    if fast_launches != n:
        raise AssertionError(f"[pipelined] {fast_launches} FAST launches for {n} frames")

    # -- Run P again with the 64k-word tree (the default call with a
    # vocabulary: keyframe database, loop closing), untimed: its waits by
    # source line, the keyframe database's among them
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    slam_v = Slam(cfg, vocab=load_vocabulary(VOCAB), device="cuda")
    t0 = time.perf_counter()
    slam_v.warmup()
    torch.cuda.synchronize()
    warmup_v = time.perf_counter() - t0
    box = {}
    waits_v = _wait_sites(torch, slam_v, lambda: box.update(run=drive(slam_v)))
    kfdb_v = {k: v for k, v in waits_v.items() if "map/keyframe_db.py" in k}
    res["run_p_tree64k"] = {
        "warmup_s": warmup_v, "waits_by_site": waits_v, "keyframe_db_waits": kfdb_v,
        "waits_in_solvers": {k: v for k, v in waits_v.items()
                             if k.split(" ", 1)[-1].rpartition(":")[0].endswith(_WAIT_FREE)},
        "frames_tracked": len(slam_v.trajectory), "n_keyframes": slam_v.n_keyframes,
        "states": [r["state"] for r in box["run"]["rows"]]}
    log(f"[pipelined] {smi}: Run P with the 64k-word tree (untimed, after a {warmup_v:.1f} s "
        f"warmup): waits by source line {json.dumps(waits_v)}; the keyframe database's "
        f"{json.dumps(kfdb_v)}; tracked {len(slam_v.trajectory)}, keyframes "
        f"{slam_v.n_keyframes}")
    if res["run_p_tree64k"]["waits_in_solvers"]:
        raise AssertionError(f"[pipelined] a RANSAC solver waited: "
                             f"{res['run_p_tree64k']['waits_in_solvers']}")
    del slam_v

    # -- run.py xyz:300, pipelined (the default) and synchronous, one process:
    # the sequence phase's two runs, or runs of its own without that phase
    if sequence is not None:
        runs = {"default": sequence["run"], "synchronous": sequence["run_synchronous"]}
    else:
        tmp = os.path.join(REPO, "build", "chip_smoke_pipelined")   # .gitignore lists build/
        os.makedirs(tmp, exist_ok=True)
        runs = _run_modes(["synchronous", "default"],
                          ["--dataset", "synthetic:xyz", "--frames", str(SEQ_FRAMES), "--seed",
                           "0", "--out", os.path.join(tmp, "kf.txt")], "[pipelined]")
    for mode, r in runs.items():
        res[mode] = {k: v for k, v in r.items() if k not in ("kf_ts", "kf_centres")}
        for k, g in r["ms_per_frame"].items():
            log(f"[pipelined] {smi}: run.py xyz:{SEQ_FRAMES} {mode} {k} frames ms per "
                f"process (to the call's return): {json.dumps(g)}")
        log(f"[pipelined] {smi}: run.py xyz:{SEQ_FRAMES} {mode} ({r['tracking']} "
            f"tracking): {r['frames_per_s']:.2f} frames a second over the frame loop "
            f"({r['loop_s']:.2f} s; {r['main_frames_per_s']:.2f} over run.main's "
            f"{r['wall_s']:.2f} s after its warmup {r['warmup_s']} s), tracked "
            f"{r['frames_tracked']}/{r['frames']}, "
            f"keyframes {r['n_keyframes']}, kf ATE {r['kf_ate_run'] * 1e3:.3f} mm, loops closed "
            f"{r['loops_closed']}, FAST launches {r['fast_launches']}, branch kernel launches "
            f"{r['branch_launches']}")
        w = r["warmup_parts"]
        log(f"[pipelined] {smi}: run.py xyz:{SEQ_FRAMES} {mode} warmup {r['warmup_s']} s: "
            f"_compile_programs {w.get('compile_programs_s', 0.0):.2f} s, the step's chain "
            f"built in {w.get('chain_build_s', 0.0):.3f} s; host resident memory "
            f"{w['rss_before_warmup']} bytes before it, {w['rss_after_warmup']} after; "
            f"device memory reserved after it {w['reserved_after_warmup']} bytes")
    pl, sy = res["default"], res["synchronous"]
    if pl["tracking"] != "pipelined" or sy["tracking"] != "synchronous":
        raise AssertionError("[pipelined] run.py ran the wrong frame loops")
    if pl["frames_tracked"] < PIPE_TRACKED_MIN or not pl["kf_ate_run"] <= PIPE_KF_ATE_MAX:
        raise AssertionError(f"[pipelined] run.py xyz:{SEQ_FRAMES} pipelined tracked "
                             f"{pl['frames_tracked']}, kf ATE {pl['kf_ate_run']}: needs >= "
                             f"{PIPE_TRACKED_MIN} and <= {PIPE_KF_ATE_MAX}")
    # the synchronous loop as the sequence phase holds it
    if (sy["frames_tracked"] < SEQ_TRACKED_MIN or not sy["kf_ate_run"] <= SEQ_KF_ATE_MAX
            or sy["fast_launches"] != SEQ_FRAMES):
        raise AssertionError(f"[pipelined] run.py xyz:{SEQ_FRAMES} synchronous tracked "
                             f"{sy['frames_tracked']}, kf ATE {sy['kf_ate_run']}, FAST "
                             f"launches {sy['fast_launches']}: needs >= {SEQ_TRACKED_MIN}, "
                             f"<= {SEQ_KF_ATE_MAX} and one a frame")
    log(f"[pipelined] {smi}: run.py xyz:{SEQ_FRAMES} frames a second over the frame loop: "
        f"pipelined {pl['frames_per_s']:.2f}, synchronous {sy['frames_per_s']:.2f} (over "
        f"run.main: {pl['main_frames_per_s']:.2f}, {sy['main_frames_per_s']:.2f})")
    res["fast_launches"] = fast_launches
    return res


def _run_modes(modes, args, tag):
    """`_SEQUENCE_RUN` over `modes` in one process of its own: per mode its
    RESULT with ms per call by frame group, frames a second and the keyframe
    trajectory's ATE against the xyz:SEQ_FRAMES ground truth (`kf_ate_run`)."""
    from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse

    out = subprocess.run([sys.executable, "-c", _SEQUENCE_RUN, REPO, json.dumps(modes), *args],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or len(lines) != len(modes):
        sys.stderr.write(out.stdout[-3000:] + out.stderr[-5000:])
        raise AssertionError(f"{tag} python -m orbslam_jpminipc_torch.run failed")
    for ln in out.stdout.splitlines():
        if not ln.startswith("RESULT "):
            log(f"{tag} run.py: {ln}")
    gt = SyntheticSequence._trajectory(None, SEQ_FRAMES, "xyz")
    by_ts = {round(i / 30.0, 6): gt[i] for i in range(SEQ_FRAMES)}
    runs = {}
    for ln in lines:
        r = json.loads(ln[len("RESULT "):])
        rows = r.pop("rows")
        gtc = np.stack([-by_ts[round(t, 6)][0].T @ by_ts[round(t, 6)][1]
                        for t in r["kf_ts"]]).astype(np.float64)
        # the frame loop's rate: the first call's start to the last call's
        # return (run.main's wall time adds the vocabulary, `finish()` and
        # the files)
        loop_s = rows[-1]["t0"] + rows[-1]["ms"] / 1e3 - rows[0]["t0"]
        r.update(kf_ate_run=ate_rmse(np.array(r["kf_centres"], np.float64), gtc),
                 frames=len(rows), loop_s=loop_s, frames_per_s=len(rows) / loop_s,
                 main_frames_per_s=len(rows) / r["wall_s"],
                 ms_per_frame={k: _percentiles([x["ms"] for x in rows if x["kind"] == k])
                               for k in ("init", "keyframe", "other", "lost")})
        runs[r["mode"]] = r
    return runs


def _tum_centres(path):
    rows = np.array([line.split() for line in open(path) if line.strip()], np.float64)
    if rows.ndim != 2 or rows.shape[1] != 8:
        raise AssertionError(f"[sequence] {path} is not a TUM trajectory file")
    return rows[:, 0], rows[:, 1:4]


def phase_sequence(torch, fast_cuda, smi):
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.tracking import TrackState
    from orbslam_jpminipc_torch.io.checkpoint import _ARRAY_FIELDS, load_slam
    from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    res = {"card": smi}
    # -- the renderer against cv2's frames and its own CPU render ----------
    sf = dict(np.load(SLAM_FIXTURE))
    t0 = time.perf_counter()
    seq45 = SyntheticSequence(45, trajectory="xyz", seed=3, device="cuda")
    build_s = time.perf_counter() - t0
    n_eq = n_px = worst = 0
    for i in range(len(sf["images"])):
        got = seq45.render(i).cpu().numpy()
        d = np.abs(got.astype(np.int64) - sf["images"][i].astype(np.int64))
        n_eq, n_px, worst = n_eq + int((d == 0).sum()), n_px + d.size, max(worst, int(d.max()))
    cpu_seq = SyntheticSequence(45, trajectory="xyz", seed=3, device="cpu")
    cpu_equal = all(torch.equal(seq45.render(i).cpu(), cpu_seq.render(i)) for i in (0, 13, 27))
    for i in range(3):
        seq45.render(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        seq45.render(i)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) / 20 * 1e3
    res["renderer"] = {"frames": len(sf["images"]), "equal_share": n_eq / n_px,
                       "max_diff": worst, "card_equals_cpu_render": cpu_equal,
                       "ms_per_frame": render_ms, "build_s": build_s}
    log(f"[sequence] {smi}: renderer on the card vs cv2's frames 0-27 of xyz seed 3: equal "
        f"share {n_eq / n_px:.9f}, max diff {worst}; card == CPU render on 3 frames: "
        f"{cpu_equal}; {render_ms:.2f} ms per frame (host clock, synchronised); the "
        f"sequence's textures built in {build_s:.2f} s")
    if n_eq / n_px < RENDER_EQUAL_SHARE or worst > RENDER_MAX_DIFF or not cpu_equal:
        raise AssertionError(f"[sequence] renderer off cv2's frames: {res['renderer']}")

    # -- run.py xyz:300, in a process of its own ------------------------------
    tmp = os.path.join(REPO, "build", "chip_smoke_sequence")   # .gitignore lists build/
    os.makedirs(tmp, exist_ok=True)
    kf_txt, world = os.path.join(tmp, "kf.txt"), os.path.join(tmp, "w.npz")
    args = ["--dataset", "synthetic:xyz", "--frames", str(SEQ_FRAMES), "--seed", "0",
            "--out", kf_txt, "--save-world", world]
    # the synchronous frame loop first, then the default (pipelined) one,
    # whose trajectory and world the files keep; the pipelined phase
    # compares the two runs' frames a second
    t0 = time.perf_counter()
    runs = _run_modes(["synchronous", "default"], args, "[sequence]")
    wall = time.perf_counter() - t0
    r = runs["default"]
    res["run_synchronous"] = runs["synchronous"]
    groups = r["ms_per_frame"]
    gt = SyntheticSequence._trajectory(None, SEQ_FRAMES, "xyz")
    by_ts = {round(i / 30.0, 6): gt[i] for i in range(SEQ_FRAMES)}
    ts, est = _tum_centres(kf_txt)
    gtc = np.stack([-by_ts[round(t, 6)][0].T @ by_ts[round(t, 6)][1] for t in ts]).astype(np.float64)
    kf_ate = ate_rmse(est, gtc)
    r.update({"process_wall_s": wall, "kf_ate": kf_ate, "tum_lines": len(ts)})
    res["run"] = r
    for k, g in groups.items():
        log(f"[sequence] {smi}: run.py xyz:{SEQ_FRAMES} {k} frames ms per process (to the "
            f"call's return): {json.dumps(g)}")
    log(f"[sequence] {smi}: run.py xyz:{SEQ_FRAMES}: tracked {r['frames_tracked']}/{r['frames']}, "
        f"keyframes {r['n_keyframes']} (inserted {r['keyframes_inserted']}), points "
        f"{r['n_points']}, loops closed {r['loops_closed']}, kf ATE {kf_ate * 1e3:.3f} mm "
        f"(EVAL_r05: 298/300, 0.9 mm, 0), TUM lines {len(ts)}; run.main {r['wall_s']:.1f} s "
        f"({SEQ_FRAMES / r['wall_s']:.2f} frames a second) after its warmup "
        f"{r['warmup_s']} s, "
        f"the process {wall:.1f} s; FAST launches {r['fast_launches']}; peak device memory "
        f"{r['peak_mem_bytes']} bytes")
    sy = runs["synchronous"]
    log(f"[sequence] {smi}: run.py xyz:{SEQ_FRAMES} synchronous: tracked "
        f"{sy['frames_tracked']}/{sy['frames']}, keyframes {sy['n_keyframes']}, kf ATE "
        f"{sy['kf_ate_run'] * 1e3:.3f} mm, FAST launches {sy['fast_launches']}")
    # both frame loops held alike: the file's trajectory is the default run's
    for mode, run_, ate in (("default", r, kf_ate), ("synchronous", sy, sy["kf_ate_run"])):
        if run_["frames"] != SEQ_FRAMES or run_["fast_launches"] != SEQ_FRAMES:
            raise AssertionError(f"[sequence] {mode}: {run_['frames']} frames, "
                                 f"{run_['fast_launches']} FAST launches, expected one a "
                                 f"frame over {SEQ_FRAMES}")
        if run_["frames_tracked"] < SEQ_TRACKED_MIN:
            raise AssertionError(f"[sequence] {mode}: tracked {run_['frames_tracked']} < "
                                 f"{SEQ_TRACKED_MIN}")
        if not np.isfinite(ate) or ate > SEQ_KF_ATE_MAX:
            raise AssertionError(f"[sequence] {mode}: keyframe ATE {ate} above {SEQ_KF_ATE_MAX}")
    if r["loops_closed"] != 0:
        raise AssertionError(f"[sequence] {r['loops_closed']} loops closed, the reference closes 0")
    if len(ts) != r["n_keyframes"]:
        raise AssertionError(f"[sequence] {len(ts)} TUM lines for {r['n_keyframes']} keyframes")

    # -- resume: a fresh default system loads the world ------------------------
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0,
                     n_features=1000, pipelined_tracking=False)
    slam = Slam(cfg, vocab=load_vocabulary(VOCAB))
    t0 = time.perf_counter()
    slam.warmup()
    torch.cuda.synchronize()
    res["resume_warmup_s"] = time.perf_counter() - t0
    load_slam(world, slam)
    z = np.load(world)
    differ = [f for f in _ARRAY_FIELDS if not np.array_equal(getattr(slam.map, f), z[f])]
    differ += [f for f in ("bow_ids", "bow_vals", "bow_n", "present")
               if not np.array_equal(getattr(slam.kfdb, f), z["kfdb_" + f])]
    n_loaded = slam.n_keyframes
    if differ or slam.tracker.state != TrackState.LOST:
        raise AssertionError(f"[sequence] loaded arrays differ ({differ}) or the tracker is "
                             f"{slam.tracker.state.name}")
    seq = SyntheticSequence(SEQ_FRAMES, trajectory="xyz", seed=0, device="cuda")
    frames = [seq.get(i) for i in range(RESUME_FROM, RESUME_TO + 1)]
    torch.cuda.synchronize()
    states, ms = [], []
    fast_cuda.LAUNCHES = 0
    for img, t, _ in frames:
        t0 = time.perf_counter()
        state, _ = slam.process(img, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        states.append(state)
    launches = fast_cuda.LAUNCHES
    back = next((k for k, st in enumerate(states) if st == TrackState.WORKING), None)
    lost_ms = ms[:back + 1] if back is not None else ms
    after = states[back:] if back is not None else []
    res["resume"] = {
        "keyframes_loaded": n_loaded, "frames": len(states),
        "working_again_after": back, "frame": None if back is None else RESUME_FROM + back,
        "lost_frame_ms": lost_ms, "working_after_resume": sum(st == TrackState.WORKING for st in after),
        "ms_after": _percentiles(ms[back + 1:] if back is not None else []),
        "fast_launches": launches,
    }
    log(f"[sequence] {smi}: resume: {res['resume']['keyframes_loaded']} keyframes loaded, arrays "
        f"equal to the file, LOST; WORKING again on frame {res['resume']['frame']} (after "
        f"{back} frames); ms of the frames until then (synchronised) "
        f"{[round(x, 1) for x in lost_ms]}; WORKING on {res['resume']['working_after_resume']} of "
        f"the {len(after)} frames from there; FAST launches {launches} for {len(states)} frames")
    if back is None or back >= RESUME_WITHIN:
        raise AssertionError(f"[sequence] the resumed system did not relocalize within "
                             f"{RESUME_WITHIN} frames: {[s.name for s in states[:RESUME_WITHIN]]}")
    if launches != len(states):
        raise AssertionError(f"[sequence] FAST launched {launches} times over {len(states)} frames")
    res["fast_launches"] = r["fast_launches"]
    return res


# ---- the vocabulary trainer ---------------------------------------------------

# run in a process of its own: `python -m orbslam_jpminipc_torch.vocab.train`'s
# main with the given flags, the FAST kernel's launches counted from 0 over
# it; the first `argv[3]` training descriptors are kept for the card/CPU check
_VOCAB_TRAIN_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from orbslam_jpminipc_torch.ops import fast_cuda
from orbslam_jpminipc_torch.vocab import train
kept = {}
collect = train.collect_descriptors

def keep(*a, **k):
    d = collect(*a, **k)
    kept["n"] = len(d)
    if int(sys.argv[3]):
        np.save(sys.argv[2], d[:int(sys.argv[3])])
    return d

train.collect_descriptors = keep
fast_cuda.build()
fast_cuda.LAUNCHES = 0
t0 = time.perf_counter()
vocab = train.main(sys.argv[4:])
torch.cuda.synchronize()
print("RESULT " + json.dumps({
    "fast_launches": fast_cuda.LAUNCHES, "wall_s": time.perf_counter() - t0,
    "n_descriptors": kept["n"], "n_words": int(vocab.n_words),
    "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
"""


def _run_script(script, args, what, timeout, env=None):
    """Run `script` in a process of its own; its RESULT line as a dict and
    the other lines of its output."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", script, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stdout[-3000:] + out.stderr[-5000:])
        raise AssertionError(f"{what} failed")
    r = json.loads(lines[-1][len("RESULT "):])
    r["process_wall_s"] = wall
    return r, [ln for ln in out.stdout.splitlines() if not ln.startswith("RESULT ")]


def _train_seconds(lines):
    """The trainer's 'seconds: render R, extract E, k-medians K' line."""
    line = next(ln for ln in lines if ln.startswith("seconds: "))
    parts = dict(p.strip().rsplit(" ", 1) for p in line[len("seconds: "):].split(","))
    return {k.replace("-", "") + "_s": float(v) for k, v in parts.items()}


def phase_vocab(torch, fast_cuda, smi):
    from orbslam_jpminipc_torch.vocab.tree import TreeVocabulary
    from orbslam_jpminipc_torch.vocab.vocabulary import (
        Vocabulary, build_vocabulary, load_vocabulary,
    )

    tmp = os.path.join(REPO, "build", "chip_smoke_vocab")   # .gitignore lists build/
    os.makedirs(tmp, exist_ok=True)
    flat, tree, subset = (os.path.join(tmp, n) for n in ("flat.npz", "tree.npz", "subset.npy"))
    res = {"card": smi}
    # -- the training: flat, 8192 words, 60 frames x 4 seeds -------------------
    frames, seeds = VOCAB_DEFAULT_FRAMES, VOCAB_TRAIN_SEEDS
    n_train_frames = seeds * 2 * len(range(0, frames, max(1, frames // 15)))
    r, lines = _run_script(_VOCAB_TRAIN_RUN, [REPO, subset, str(VOCAB_SUBSET), "--seeds",
                                              str(seeds), "--out", flat],
                           "[vocab] python -m orbslam_jpminipc_torch.vocab.train", 900)
    r.update(_train_seconds(lines), training_frames=n_train_frames)
    res["flat"] = r
    for ln in lines:
        log(f"[vocab] train: {ln}")
    log(f"[vocab] {smi}: the training ({frames} frames x {seeds} seeds, xyz and loop, "
        f"{n_train_frames} frames): {r['n_descriptors']} descriptors, {r['n_words']} words; "
        f"render {r['render_s']:.2f} s, extract {r['extract_s']:.2f} s, k-medians "
        f"{r['kmedians_s']:.2f} s; main {r['wall_s']:.1f} s, the process "
        f"{r['process_wall_s']:.1f} s; FAST launches {r['fast_launches']}; peak device memory "
        f"{r['peak_mem_bytes']} bytes")
    if r["fast_launches"] != n_train_frames:
        raise AssertionError(f"[vocab] {r['fast_launches']} FAST launches for {n_train_frames} "
                             f"training frames: one a frame expected")
    fv = load_vocabulary(flat, device="cpu")
    if r["n_words"] != VOCAB_DEFAULT_WORDS or not isinstance(fv, Vocabulary) \
            or fv.n_words != VOCAB_DEFAULT_WORDS:
        raise AssertionError(f"[vocab] the trained file holds {r['n_words']} words")

    # -- the card's k-medians against the CPU's on a subset: equal bytes -------
    sub = np.load(subset)
    t0 = time.perf_counter()
    v_card = build_vocabulary(sub, n_words=1024, iters=3, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_cpu = build_vocabulary(sub, n_words=1024, iters=3, device="cpu")
    cpu_s = time.perf_counter() - t0
    equal = (np.array_equal(v_card.words.cpu().numpy(), v_cpu.words.numpy())
             and np.array_equal(v_card.idf.cpu().numpy(), v_cpu.idf.numpy()))
    res["subset"] = {"descriptors": len(sub), "words": 1024, "iters": 3, "equal": equal,
                     "card_s": card_s, "cpu_s": cpu_s}
    log(f"[vocab] {smi}: build_vocabulary on {len(sub)} training descriptors, 1024 words, 3 "
        f"iterations: card {card_s:.2f} s, CPU {cpu_s:.2f} s, words and idf equal bytes: {equal}")
    if len(sub) != VOCAB_SUBSET or not equal:
        raise AssertionError("[vocab] the card's vocabulary differs from the CPU's")

    # -- the tree: k 16, depth 4, 2 seeds ------------------------------------
    r, lines = _run_script(_VOCAB_TRAIN_RUN, [REPO, subset, "0", "--tree", "--k", "16",
                                              "--depth", "4", "--seeds", "2", "--out", tree],
                           "[vocab] python -m orbslam_jpminipc_torch.vocab.train --tree", 900)
    r.update(_train_seconds(lines))
    res["tree"] = r
    tv = load_vocabulary(tree, device="cuda")
    log(f"[vocab] {smi}: the tree (k 16, depth 4, 2 seeds): {r['n_descriptors']} descriptors, "
        f"{r['n_words']} words; render {r['render_s']:.2f} s, extract {r['extract_s']:.2f} s, "
        f"k-medians {r['kmedians_s']:.2f} s; main {r['wall_s']:.1f} s; FAST launches "
        f"{r['fast_launches']}")
    if not isinstance(tv, TreeVocabulary) or tv.n_words != r["n_words"] or tv.n_words < 1000:
        raise AssertionError(f"[vocab] the tree file is not the tree built ({r['n_words']} words)")

    # -- run.py with the trained flat vocabulary --------------------------------
    kf_txt = os.path.join(tmp, "kf.txt")
    r, lines = _run_script(_SEQUENCE_RUN, [REPO, '["default"]', "--dataset", "synthetic:xyz",
                                           "--frames",
                                           str(VOCAB_RUN_FRAMES), "--seed", "0", "--vocab", flat,
                                           "--out", kf_txt],
                           "[vocab] run.py with the trained vocabulary", 600)
    rows = r.pop("rows")
    r["ms_per_frame"] = {k: _percentiles([x["ms"] for x in rows if x["kind"] == k])
                         for k in ("init", "keyframe", "other", "lost")}
    res["run"] = r
    log(f"[vocab] {smi}: run.py --dataset synthetic:xyz --frames {VOCAB_RUN_FRAMES} --vocab "
        f"<the trained file>: tracked {r['frames_tracked']}/{len(rows)}, keyframes "
        f"{r['n_keyframes']}, points {r['n_points']}, loops closed {r['loops_closed']}; run.main "
        f"{r['wall_s']:.1f} s; FAST launches {r['fast_launches']}")
    if r["frames_tracked"] < VOCAB_RUN_TRACKED_MIN or r["fast_launches"] != VOCAB_RUN_FRAMES:
        raise AssertionError(f"[vocab] tracked {r['frames_tracked']} < {VOCAB_RUN_TRACKED_MIN} "
                             f"or {r['fast_launches']} FAST launches")
    res["fast_launches"] = res["flat"]["fast_launches"]
    return res


# ---- the multi-device solvers -------------------------------------------------

# run in a process of its own: a torch.distributed world of one process over
# NCCL (initialize_distributed), the reference worker's problem
# (tests/test_torch_multihost.py:build_problem) through lift_sharded_problem
# and sharded_bundle_adjust, against the single-device solver
_NCCL_RUN = r"""
import importlib.util, json, socket, sys
sys.path.insert(0, sys.argv[1])
import torch
spec = importlib.util.spec_from_file_location("mh", sys.argv[2])
mh = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mh)
from orbslam_jpminipc_torch.parallel.multihost import (
    global_mesh, initialize_distributed, lift_sharded_problem)
from orbslam_jpminipc_torch.parallel.sharded_ba import shard_ba_problem, sharded_bundle_adjust
from orbslam_jpminipc_torch.solvers.ba import BAProblem, bundle_adjust
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
initialize_distributed(f"localhost:{port}", 1, 0)
dev = torch.device("cuda", torch.cuda.current_device())
prob = BAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in mh.build_problem().items()})
mesh = global_mesh()
sprob = lift_sharded_problem(shard_ba_problem(prob, 1), mesh)
R, t, pts, chi2, _ = sharded_bundle_adjust(sprob, mesh, iterations=10)
ref = bundle_adjust(prob, iterations=10)
out = {"backend": torch.distributed.get_backend(), "world": torch.distributed.get_world_size(),
       "chi2": float(chi2), "ref_chi2": float(ref.chi2),
       "max_dR": float((R - ref.kf_R).abs().max()), "max_dt": float((t - ref.kf_t).abs().max())}
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def _sync_stacks(torch, fn):
    """Run `fn` under CUDA sync debug mode: the host synchronisations by
    source line, and for each site the lines of the port's package on the
    Python stack when it waited (empty where none of its code was there)."""
    import traceback
    import warnings

    sites, stacks = {}, {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = f"{os.path.relpath(filename, REPO)}:{lineno}"
        sites[site] = sites.get(site, 0) + 1
        stacks[site] = [f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                        for f in traceback.extract_stack()
                        if "orbslam_jpminipc_torch" in f.filename]

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites, stacks


def phase_multichip(torch, fast_cuda, smi):
    from orbslam_jpminipc_torch.parallel import (
        DeviceMesh, mesh_devices, shard_ba_problem, shard_essential_graph,
        sharded_bundle_adjust, sharded_optimize_essential_graph,
    )
    from orbslam_jpminipc_torch.parallel.dryrun import dryrun_multichip
    from orbslam_jpminipc_torch.solvers import ba, essential_graph, gba
    from orbslam_jpminipc_torch.solvers.reproj import CHI2_MONO, residuals
    from orbslam_jpminipc_torch.utils.host import fetch
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    launches0 = fast_cuda.LAUNCHES
    n_dev = torch.cuda.device_count()
    res = {"card": smi, "devices": n_dev}
    res["dryrun"], dry_ms = timed(lambda: dryrun_multichip(n_dev))
    log(f"[multichip] {smi}: dryrun_multichip({n_dev}) held its asserts in {dry_ms:.0f} ms: "
        f"{json.dumps(res['dryrun'])}")

    # -- global BA at (256, 16384, 65536): the loop phase's corrected map -------
    slam, info, lf, meta = loop_system("cuda", load_vocabulary(VOCAB))
    out = loop_run(slam, info, lf)
    if out["closed_kf"] != meta["closed_kf"]:
        raise AssertionError(f"[multichip] the constructed loop closed on {out['closed_kf']}")
    prob, n_obs = slam.build_global_ba_problem()
    shape = [prob.kf_R.shape[0], prob.points.shape[0], prob.obs_kf.shape[0]]
    devices = mesh_devices(slam.device)
    mesh = DeviceMesh(devices)
    iters = slam.cfg.gba_iterations
    sprob = shard_ba_problem(prob, len(devices))
    solve = lambda: sharded_bundle_adjust(sprob, mesh, iterations=iters)
    # first under CUDA sync debug mode (also the warm-up): where the host
    # waits, with the lines of the port's code on the stack of each wait
    sites, stacks = _sync_stacks(torch, solve)
    torch.cuda.reset_peak_memory_stats()
    (R, t, pts, chi2, _), ms = timed(solve)
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_kernels(torch, solve)
    pcg, pcg_ms = timed(lambda: gba.bundle_adjust_large(prob, iterations=iters,
                                                        cg_iters=slam.cfg.gba_cg_iters))
    lm, lm_ms = timed(lambda: ba.bundle_adjust(prob, iterations=iters))
    chi0, chi_s, chi_p, chi_l, kf_R, kf_t, fixed, R0, t0, pv = fetch(
        ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points), chi2, pcg.chi2, lm.chi2, R, t,
        prob.kf_fixed, prob.kf_R, prob.kf_t, prob.point_valid)
    # the sharded points (S, Pl, 3) back in the problem's order: contiguous blocks
    pts_d = pts.reshape(-1, 3)[:pv.shape[0]]
    pts = fetch(pts_d)[0]
    free = ~fixed

    def kf_chi2(R_, t_, p_):
        """Each keyframe's robust chi2: `ba._robust_chi2`'s terms summed by keyframe."""
        e, _ = residuals(R_[prob.obs_kf], t_[prob.obs_kf], p_[prob.obs_pt], prob.obs_uv, prob.K4)
        c = torch.sum(e * e, dim=-1) * prob.obs_w
        rho = torch.where(c <= CHI2_MONO, c, 2.0 * torch.sqrt(CHI2_MONO * c) - CHI2_MONO)
        rho = torch.where(prob.obs_valid, rho, 0.0)
        return fetch(torch.zeros_like(prob.kf_t[:, 0]).index_add_(0, prob.obs_kf, rho))[0]

    seen = np.bincount(fetch(prob.obs_kf[prob.obs_valid])[0], minlength=len(fixed)) > 0
    c_s = kf_chi2(R, t, pts_d)

    def gaps(a, b, c_a):
        (aR, at, ap), (bR, bt, bp) = a, fetch(b.kf_R, b.kf_t, b.points)
        d = np.abs(ap - bp)[pv].max(1)
        c_b = kf_chi2(b.kf_R, b.kf_t, b.points)
        return {"kf_chi2_rel": float((np.abs(c_a - c_b)[seen] / c_b[seen]).max()),
                "max_dR": float(np.abs(aR - bR)[free].max()),
                "max_dt": float(np.abs(at - bt)[free].max()),
                "point_median": float(np.median(d)), "point_max": float(d.max())}

    vs_lm, vs_pcg = gaps((kf_R, kf_t, pts), lm, c_s), gaps((kf_R, kf_t, pts), pcg, c_s)
    start_vs_pcg = gaps((R0, t0, fetch(prob.points)[0]), pcg,
                        kf_chi2(prob.kf_R, prob.kf_t, prob.points))
    res["global_ba"] = {
        "shape": shape, "n_obs": int(n_obs), "shard_shape": list(sprob.points.shape[:2]) + [
            sprob.obs_kf.shape[1]], "iterations": iters, "chi2_before": float(chi0),
        "chi2_sharded": float(chi_s), "chi2_pcg": float(chi_p), "chi2_lm": float(chi_l),
        "free_keyframes": int(free.sum()), "points": int(pv.sum()), "vs_lm": vs_lm,
        "vs_pcg": vs_pcg, "start_vs_pcg": start_vs_pcg, "ms": ms, "pcg_ms": pcg_ms, "lm_ms": lm_ms,
        "peak_mem_bytes": int(peak), "profile": prof, "sync_sites": sites,
        "sync_stacks": stacks}
    log(f"[multichip] {smi}: sharded_bundle_adjust on {len(devices)} device(s), {iters} "
        f"iterations at {shape} ({n_obs} observations): {ms:.1f} ms, chi2 {float(chi0):.1f} -> "
        f"{float(chi_s):.4f} (PCG on the same problem: {float(chi_p):.4f} in {pcg_ms:.1f} ms; "
        f"single-device LM: {float(chi_l):.4f} in {lm_ms:.1f} ms); against the LM "
        f"{json.dumps(vs_lm)}, against the PCG {json.dumps(vs_pcg)} (the start "
        f"{json.dumps(start_vs_pcg)}); "
        f"{prof['kernels']} kernels, {prof['device_ms']:.1f} ms of kernel time; peak device "
        f"memory {peak} bytes; host synchronisations by source line {json.dumps(sites)}, "
        f"the port's lines on their stacks {json.dumps(stacks)}")
    if any(stacks.values()):
        raise AssertionError(f"[multichip] the sharded BA waits for the host: {stacks}")
    if not abs(chi_s - chi_p) <= GBA_CHI2_REL * chi_p or not chi_s < chi0:
        raise AssertionError(f"[multichip] sharded chi2 {chi_s}, PCG {chi_p}, before {chi0}")
    if not max(vs_lm["kf_chi2_rel"], vs_pcg["kf_chi2_rel"]) <= GBA_KF_CHI2_REL:
        raise AssertionError(f"[multichip] a keyframe's chi2 is off: against the LM {vs_lm}, "
                             f"against the PCG {vs_pcg}")
    if not (np.array_equal(kf_R[fixed], R0[fixed]) and np.array_equal(kf_t[fixed], t0[fixed])
            and np.isfinite(kf_R).all() and np.isfinite(kf_t).all() and np.isfinite(pts).all()):
        raise AssertionError("[multichip] the sharded BA moved a held camera or is not finite")

    # -- the essential graph, edge-sharded, against the single-device LM -------
    eg = out["eg_problem"]
    seg = shard_essential_graph(eg, len(devices))
    sharded = lambda: sharded_optimize_essential_graph(seg, mesh, iterations=20)
    sharded()
    got, eg_ms = timed(sharded)
    ref, ref_ms = timed(lambda: essential_graph.optimize_essential_graph(eg, iterations=20))
    gs, gt, rs, rt, gchi, rchi = fetch(got.s, got.t, ref.s, ref.t, got.chi2, ref.chi2)
    res["essential_graph"] = {"ms": eg_ms, "single_device_ms": ref_ms, "chi2": float(gchi),
                              "ref_chi2": float(rchi), "max_dt": float(np.abs(gt - rt).max()),
                              "max_ds": float(np.abs(gs - rs).max()),
                              "edge_slots": list(seg.e_i.shape)}
    log(f"[multichip] {smi}: sharded_optimize_essential_graph (K = {eg.s.shape[0]}, edge slots "
        f"{list(seg.e_i.shape)}): {eg_ms:.1f} ms, chi2 {float(gchi):.8f}; single-device "
        f"{ref_ms:.1f} ms, chi2 {float(rchi):.8f}; max |dt| {res['essential_graph']['max_dt']:.3g}, "
        f"max |ds| {res['essential_graph']['max_ds']:.3g}")
    if not (res["essential_graph"]["max_dt"] <= EG_T_TOL
            and res["essential_graph"]["max_ds"] <= EG_S_TOL):
        raise AssertionError(f"[multichip] the sharded pose graph is off: {res['essential_graph']}")

    # -- a torch.distributed world of one over NCCL -----------------------------
    # one host: NCCL's bootstrap on the loopback interface, which its
    # default interface choice leaves out
    r, _ = _run_script(_NCCL_RUN, [REPO, os.path.join(REPO, "tests", "test_torch_multihost.py")],
                       "[multichip] the NCCL world of one", 300,
                       env=dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get(
                           "NCCL_SOCKET_IFNAME", "lo")))
    res["nccl"] = r
    log(f"[multichip] {smi}: initialize_distributed -> {r['backend']} world of {r['world']}: "
        f"sharded chi2 {r['chi2']:.4f} (single device {r['ref_chi2']:.4f}), max |dR| "
        f"{r['max_dR']:.3g}, max |dt| {r['max_dt']:.3g}; the process {r['process_wall_s']:.1f} s")
    if r["backend"] != "nccl" or r["world"] != 1 or max(r["max_dR"], r["max_dt"]) > MULTIHOST_TOL:
        raise AssertionError(f"[multichip] the NCCL world is off: {r}")
    if fast_cuda.LAUNCHES != launches0:
        raise AssertionError("[multichip] the FAST kernel ran: it is not on this phase's path")
    res["fast_launches"] = 0
    return res


# what `--compare` runs in each tree: that tree's own phases, quietly
_COMPARE_RUN = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
from orbslam_jpminipc_torch.ops import fast_cuda
c.log = lambda msg: None
fast_cuda.build()
smi = c.phase_device(torch)
fx = dict(np.load(c.FIXTURE))
thr = c.phase_throughput(torch, FusedContext, SlamConfig, fx, n_steps=100)
sysr = c.phase_system(torch, fast_cuda, smi)
ra = c.phase_reloc_async(torch, fast_cuda, smi)["run_a"]
keep = ("ms_per_frame", "syncs_per_frame", "fetches_per_frame", "n_keyframes", "n_points",
        "kf_ate", "states_equal", "peak_mem_bytes")
keep_a = ("ms_per_frame", "ms_until_return", "syncs_per_frame", "keyframes_inserted",
          "queue_depth", "queue", "not_ready_skips", "wall_s", "kf_ate", "peak_mem_bytes")
run_a = {k: ra[k] for k in keep_a}
run_a["loop_stages"] = {k: v for k, v in ra["stages"].items() if k.startswith("loop_")}
print("RESULT " + json.dumps({"card": smi, "step": thr, "system": {k: sysr[k] for k in keep},
                              "run_a": run_a}))
"""


def compare(trees) -> int:
    """The step's p50/p95, the system phase's ms per `Slam.process` by
    frame group, synchronisations, reads and outcome, and Run A's ms by
    frame group, queue and loop-closing stages, for each tree in turn."""
    for i, tree in enumerate(trees):
        out = subprocess.run([sys.executable, "-c", _COMPARE_RUN], cwd=tree,
                             capture_output=True, text=True, timeout=2400)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-2000:] + out.stderr[-4000:])
            raise SystemExit(f"chip_smoke: --compare run {i} in {tree} failed")
        log(json.dumps({"run": i, "tree": os.path.normpath(tree),
                        **json.loads(lines[-1][len("RESULT "):])}))
    return 0


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    if "--compare" in sys.argv[1:]:
        return compare(sys.argv[sys.argv.index("--compare") + 1:])
    sys.path.insert(0, REPO)
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
    from orbslam_jpminipc_torch.ops import fast, fast_cuda, pyramid

    fx = dict(np.load(FIXTURE))
    report = {"device": phase_device(torch)}
    report["build_s"] = phase_build(fast_cuda)
    smi = report["device"]

    def busy_share():
        busy = (report["breakdown"]["profile"]["device_ms_per_step"]
                / report["throughput"]["mean_ms"])
        log(f"[breakdown] device busy share: {busy:.3f} (profiled kernel time per "
            f"step over the unprofiled mean step time)")
        return busy

    phases = {
        "kernel": lambda: dict(phase_kernel(torch, fast, fast_cuda, pyramid, fx),
                               small_linalg=kernel_small_linalg(torch, smi),
                               epnp_n1_case=epnp_n1_cost(torch, smi),
                               pose_lm=kernel_pose_lm(torch, smi, fx, FusedContext,
                                                      SlamConfig)),
        "slice": lambda: phase_slice(torch, fast_cuda, FusedContext, SlamConfig, fx),
        "throughput": lambda: phase_throughput(torch, FusedContext, SlamConfig, fx),
        "breakdown": lambda: phase_breakdown(torch, fx, FusedContext, SlamConfig),
        "graphs": lambda: phase_graphs(torch, fast_cuda, FusedContext, SlamConfig, fx, smi),
        "device_busy_share": busy_share,
        "system": lambda: phase_system(torch, fast_cuda, smi),
        "reloc_async": lambda: phase_reloc_async(torch, fast_cuda, smi),
        "loop": lambda: phase_loop(torch, fast_cuda, smi),
        "sequence": lambda: phase_sequence(torch, fast_cuda, smi),
        "pipelined": lambda: phase_pipelined(torch, fast_cuda, smi, report.get("sequence")),
        "vocab": lambda: phase_vocab(torch, fast_cuda, smi),
        "multichip": lambda: phase_multichip(torch, fast_cuda, smi),
    }
    # `--phases a,b` runs only those (after device and build), for work on
    # one phase; such a run prints no result line
    only = None
    if "--phases" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--phases") + 1].split(",")
        unknown = [p for p in only if p not in phases]
        if unknown:
            raise SystemExit(f"chip_smoke: unknown phases {unknown}; known: {list(phases)}")
    phase_s = {}
    for name, phase in phases.items():
        if only is None or name in only:
            t0 = time.perf_counter()
            report[name] = phase()
            phase_s[name] = time.perf_counter() - t0
            log(f"[time] phase {name}: {phase_s[name]:.1f} s")
    report["phase_s"] = phase_s

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    # a run of some phases does not overwrite a whole run's report
    name = "chip_smoke.json" if only is None else "chip_smoke_phases.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(report, f, indent=1)
    if only is not None:
        log(f"chip_smoke: phases {only} passed; a full run prints the result line")
        return 0

    k = report["kernel"]["frame"]
    sl = report["kernel"]["small_linalg"]
    plm = report["kernel"]["pose_lm"]
    b = report["pipelined"]["branch_kernel"]
    log(f"chip_smoke: {report['device']}: the whole script took "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "fast9_score_nonmax3x3",
        "route": "cuda",
        "source": "orbslam_jpminipc_torch/csrc/fast.cu",
        "replaces": "orbslam_jpminipc_tpu/ops/fast_pallas.py:82",
        # the system phase's count: Slam.process over the 28 frames
        "launches": report["system"]["fast_launches"],
        "launches_slice_phase": report["slice"]["fast_launches"],
        # the graphs phase's 12 frames through the captured step
        "launches_graphs_phase": report["graphs"]["fast_launches"]["captured"],
        "launches_reloc_run": report["reloc_async"]["run_r"]["fast_launches"],
        "launches_async_run": report["reloc_async"]["run_a"]["fast_launches"],
        "launches_loop_phase": report["loop"]["fast_launches"],
        "launches_sequence_phase": report["sequence"]["fast_launches"],
        # Run P, the pipelined frame loop on the system fixture
        "launches_pipelined_phase": report["pipelined"]["fast_launches"],
        # the default vocabulary training: one launch a training frame
        "launches_vocab_phase": report["vocab"]["fast_launches"],
        "launches_multichip_phase": report["multichip"]["fast_launches"],
        "max_abs_err": report["kernel"]["max_abs_err"],
        # per frame: one launch over the 8 pyramid levels, the select included
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        # no single PyTorch call computes this function
        "library_ms": None,
        "device_ms": k["device_ms"], "plain_device_ms": k["plain_device_ms"],
        "eight_launches_ms": k["eight_launches_ms"],
        "eight_launches_device_ms": k["eight_launches_device_ms"],
    }, {
        # the device's decision of a `lax.cond` in the pipelined step: one
        # launch per branch of the step's chain (a pick per pyramid level,
        # the recovery test), counted over Run P
        "name": "chain_branch_kernel",
        "route": "cuda",
        "source": "orbslam_jpminipc_torch/csrc/graph_chain.cu",
        # the recovery pass's lax.cond; the per-level pick's is the other
        "replaces": "orbslam_jpminipc_tpu/frontend/fused_track.py:220",
        "replaces_also": "orbslam_jpminipc_tpu/ops/extractor.py:133",
        "launches": report["pipelined"]["run_p"]["branch_launches"],
        # the sequence phase's run.py xyz:300, pipelined
        "launches_run_py_pipelined": report["pipelined"]["default"]["branch_launches"],
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        # no PyTorch call decides a graph's branch on the device
        "library_ms": None,
    }, {
        # the reference's jnp.linalg calls inside its jitted solvers (no
        # Pallas counterpart): eigh of EPnP's M^T M, and the others below
        "name": "small_linalg",
        "route": "cuda",
        "source": "orbslam_jpminipc_torch/csrc/small_linalg.cu",
        "replaces": "orbslam_jpminipc_tpu/solvers/epnp.py:214",
        "replaces_also": ["orbslam_jpminipc_tpu/solvers/epnp.py:32",
                          "orbslam_jpminipc_tpu/solvers/epnp.py:53",
                          "orbslam_jpminipc_tpu/solvers/epnp.py:198",
                          "orbslam_jpminipc_tpu/solvers/sim3solver.py:57",
                          "orbslam_jpminipc_tpu/solvers/initializer.py:78",
                          "orbslam_jpminipc_tpu/solvers/initializer.py:93",
                          "orbslam_jpminipc_tpu/solvers/initializer.py:95",
                          "orbslam_jpminipc_tpu/solvers/initializer.py:188",
                          "orbslam_jpminipc_tpu/solvers/initializer.py:237"],
        # the system phase's count (the initialization attempts' replays)
        "launches": report["system"]["small_linalg_launches"],
        "launches_reloc_run": report["reloc_async"]["run_r"]["small_linalg_launches"],
        "launches_loop_phase": report["loop"]["small_linalg_launches"],
        # the worst invariant of every held call, relative to |A|
        "max_abs_err": sl["max_abs_err"],
        # one solve_pnp's calls (a relocalization candidate's EPnP)
        "ms": sl["ms"], "plain_ms": sl["plain_ms"],
        "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"],
        # torch.linalg.eigh / svd on the same float32 inputs
        "library_ms": sl["library_ms"], "device_ms": sl["device_ms"],
    }, {
        # the reference's pose LM, left to XLA (no Pallas counterpart)
        "name": "pose_lm",
        "route": "cuda",
        "source": "orbslam_jpminipc_torch/csrc/pose_lm.cu",
        "replaces": "orbslam_jpminipc_tpu/solvers/pose_opt.py:60",
        # the slice phase's count: pass 1 and pass 2 a frame
        "launches": report["slice"]["pose_lm_launches"],
        "max_abs_err": plm["max_abs_err"],
        # the step's pass 2: 1000 rows, 4 rounds
        "ms": plm["pass2"]["ms"], "plain_ms": plm["pass2"]["plain_ms"],
        "device_ms": plm["pass2"]["device_ms"],
        # a latency floor (csrc/pose_lm.cu), not bytes or operations
        "bound_by": "latency",
        # no single PyTorch call computes this function
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
