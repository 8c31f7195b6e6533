#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (rocm_mpi_tpu_torch) on one GPU.

    python3 chip_smoke.py [--json PATH]
    python3 chip_smoke.py --gpus 4     # phases 1, 2 and 6-22 only, over NCCL

Run from the repository root on a machine with one CUDA GPU (an H100 is
the target). Phases, printed as they run (about nine minutes on one H100
80GB HBM3, the build included):

1. environment — torch, CUDA and nvcc versions, the card's name and power
   limit (nvidia-smi); [host] the hostname, driver, NCCL version and
   `nvidia-smi topo -m`, the facts a multi-card number depends on;
2. build — nvcc builds every csrc/*.cu, one process per source, all
   started together;
3. kernels — each kernel at the main paths' shapes, in f32, f64 and bf16
   (and the multi-step kernels' other body forms in f32), and each on a
   small 3D block, held bitwise against its plain PyTorch version on the
   card, and timed with CUDA events (median) beside the plain version and
   its bound; the region kernels also as the five boxes of the `hide`
   decomposition of a 6144² shard; the three kp kernels at 12288² and
   128², and kp_update at odd row lengths (12288×12287, 128×127) with
   its wrapper's host time per call; tb_sweep also at k = 16 on 12320²
   and ragged (1000×777, k = 5), with its strip/segment plan, and in 3D
   at 128³ and 144³ (k = 8), 64×96×96 (k = 16) and 96×64×48 (k = 1, 5,
   8, 13), with its tile/segment/thread plan and the cell updates a
   launch computes; kp_residual also at 12288×12287 and on a 12288² view
   with storage offset 1 (qx and Cp), printed with its layout;
   fused_step_padded and kp_flux at 12288², the 6144² block of a 2×2
   rank and smaller (252² and the 3D block; 128²);
   masked_step, kp_flux and fused_step_padded also at 12288×12287 and on
   a 12288² view with storage offset 1 (kp_flux: Tp and qx; the padded
   step: Tp and Cp), each printed with the layout its launch takes
   (16-byte vectors, scalar cells, or for kp_flux and fused_step_padded
   one cell a thread, as their launchers report it; the cases must reach
   all three), and
   masked_step at 252² with its wrapper's host µs a call; fused_step_cm
   in both of its callers' forms: from a padded block (its views, the
   scalar layout) and in the face form the sharded steps launch (the
   shard and contiguous faces: all present, none below on any axis as at
   a domain corner, or none), whole and as the hide boxes, at 252², a
   6144² shard, ragged 253×251, the small 3D block and a 128³ shard,
   three dtypes, and in f64 as the hide boxes of a 12288² rank (the
   benchmark's hide cell), each printed with its layout, the launches a
   call that took the f64 route (kernels.F64_ROUTE_LAUNCHES: every f64
   launch, no f32 or bf16 one) and, beside the per-call
   median, its device time queued behind torch.cuda._sleep and the time
   a launch of 200 queued between two CUDA events (the figure for the
   128³ shard, whose one launch is too short for a pair of events); the multi-step
   kernels (multi_step_cm, wave_multi_step, swe_multi_step) also on a
   ragged 253×251 block and at the capacity edges of their cluster route
   (the widest block of 724 (diffusion), 512 (wave) or 256 (SWE) rows one
   cluster holds, and one column more, which takes the cooperative
   route), each case printed with its route (cluster size and shared
   bytes a CTA, where Cm or the masks are read, or cooperative) and,
   beside the per-call median, the launch's device time (launches queued
   behind torch.cuda._sleep) and the wrapper's host µs a call; every
   main-path block of theirs must take the cluster route at the cluster
   size the card grants;
4. main path, one GPU — HeatDiffusion.run("perf") at 12288² f32 for 500
   steps and at 252² f32 for 1000: every step one masked_step launch, the field
   bitwise equal to the plain versions' run of the same steps, and the
   252² field within the analytic Gaussian bound;
   [kp] HeatDiffusion.run("kp") at 12288² f32 for 500 steps (one launch
   of each kp kernel a step, no other kernel, the field bitwise equal to
   the plain versions' run; the copy into the padded buffer, the three
   kernels and the select of a step timed alone) and at the kp app's
   default, 128² f64, also held against run("ap") within rtol 1e-13,
   atol 1e-15;
5. multi-step schedules, one GPU — run_vmem_resident at 252² (256 warmup
   + 4096 timed steps, chunk 256; its ms/step the median of three runs'
   timed windows), run_deep at 252² (32 + 1024, k = 32, and 200 + 1800,
   k = 8, the weak-scaling app's windows; vmem route), run_hbm_blocked at
   12288² (16 + 1000, k = 8) and run_deep at 12288² (16 + 1000, k = 8,
   hbm-tb route), all f32, each as CUDA graphs of its sweeps
   (models/scan.sweep_loop; loop route "scan-graph" asserted): each
   asserts its route, k and launch count, is bitwise equal to the same
   schedule run through the plain versions on the card and to the eager
   sweep loop the graphs replace (the ops' loops over launches, the deep
   schedule's sweeps one call after another), and prints the loop's q, c,
   graphs, capture host ms and the launches a replay records, graph and
   eager ms/step side by side, effective T_eff and Gpts/s; the 252²
   results within 1056 steps stay within the analytic Gaussian bound;
   [wave] the same for the acoustic wave: AcousticWave.run("perf") at
   12288² for 500 steps (one wave_step launch per step; the copy, kernel and select of
   a step timed alone), run_vmem_resident at 252² (256 + 4096, chunk 256)
   and run_deep at 252² (8 + 1024, k = 8), both also against their eager
   sweep loops as in phase 5, and time reversal at 252² f64;
   [swe] the same for the shallow water: ShallowWater.run("perf") at
   12288² f32 for 500 steps (one swe_step launch per step; the three copies into the
   padded buffers and the kernel of a step timed alone) and at 252² f64
   (the app's default), run_vmem_resident at 252² (256 + 4096, chunk 256),
   run_deep at 240² (8 + 1024, k = 8, vmem route on 256²) and at 252² (the
   jnp route: no kernel), the schedules also against their eager sweep
   loops as in phase 5, each with its mass drift |Σh − Σh₀|/|Σh₀|
   printed and held under 1e-13 (f64) or 1e-6 (f32);
   [scan] the scan driver (models/scan.py: the q-step chunks captured as
   CUDA graphs and replayed) beside the step driver on each small and
   large main path — diffusion `perf` 252² and 12288² f32, `kp` 128² f64,
   wave `perf` 252² and 12288² f32, SWE `perf` 252² f64 and 12288² f32,
   1000 steps after 10 (500 at 12288²) — and at the plan's edges: warmup
   0 (q = nt, capped), an odd c (two graphs) and the wave with c not a
   multiple of 3 (three graphs). Each: the fields bitwise equal, route "scan-graph", q,
   c and the graphs captured (and their host ms), the launch counts nt
   per kernel of the step under both drivers, ms/step of both the median
   of three timed windows;
6. main path, sharded — the 2×2 perf path (the face exchange, one batch
   a step, + fused_step_cm from the shard and its faces) run by 4 ranks
   that share this one card over a gloo group (faces staged through host
   memory): every step one fused_step_cm launch per rank, each shard
   bitwise equal to the plain versions' run and to the same steps over
   the padded route they replaced (exchange_halo + fused_step_cm on the
   block; its ms/step printed beside), the gathered
   field bitwise equal to the same kernel run over the whole zero-padded
   domain on one GPU; then `kp` on the same grid, each shard bitwise equal
   to its plain-version run and the gathered field bitwise equal to the
   one-GPU kp run; and `perf` through `run(driver="scan")`, bitwise
   equal to the step driver's field: over gloo the eager loop route
   ("scan-loop"), over NCCL (`--gpus 4`) the graphs ("scan-graph");
   with `--gpus 4` then [sharded-scan]: diffusion perf, kp and hide, wave
   and SWE perf and hide, diffusion perf on the bf16 wire, and diffusion
   perf and hide over the padded route (the yardstick of the face route,
   bitwise its fields), each on
   the 2×2 grid of 12288² (500 steps after 10) under the scan driver's
   graphs (the halo exchange captured with the steps), bitwise equal on
   every rank to the same rank's step-driver run with the same launch
   counts, its ms/step beside the step driver's and the eager loop's, its
   graphs and each rank's capture host ms;
7. deep schedule, sharded — run_deep on the 2×2 grid of 12288² (k = 8,
   hbm-tb route on 6160² padded shards) by the same 4 ranks over gloo,
   16 + 32 steps: each shard bitwise equal to its plain-version run and
   to the eager sweep loop, the gathered field bitwise equal to the
   one-GPU run_deep of the same k; then run_deep 16 + 32 in each wire
   mode (f32, bf16, int8, int8_delta), every shard bitwise equal to the
   same mode's eager sweep loop over the two calls (each starting from a
   zero wire state); the loop route "scan-loop" over gloo, "scan-graph"
   over NCCL, with graph and eager ms/step;
8. hide, sharded — diffusion, wave and shallow-water `perf` and `hide` on
   the 2×2 grid of 12288² (b_width (32, 4), five region launches per rank
   and step), 20 steps: each shard bitwise equal to its plain-version run,
   the diffusion and shallow-water hide fields bitwise equal to perf's,
   the diffusion hide bitwise equal to its padded route's, hide's
   ms/step beside perf's (and the padded route's);
9. wave deep schedule, sharded — run_deep on the 2×2 grid of 480² (k = 8,
   256² padded shards, vmem route), 16 + 32 steps: each shard bitwise equal
   to its plain-version run and to the eager sweep loop (loop route as in
   7), the gathered field bitwise equal to the one-GPU run_deep;
10. shallow-water deep schedule, sharded — the same for ShallowWater on
   the 2×2 grid of 480² (k = 8, 256² padded shards, vmem route): each
   shard also bitwise equal to the eager sweep loop, the gathered state
   bitwise equal to the one-GPU run_deep, whose 496² block takes the jnp
   route (the same arithmetic);
11. ring — the ring smoke test (parallel/ring.py): one rank (the identity,
   a copy), then 4 ranks each asserting it holds its left neighbour's
   rank, with the median µs of a ring round (1000 rounds between CUDA
   events) at 16 B and at a 6144-element f32 slab (a halo row of 2×2 of
   12288²);
12. host-staged — run("shard") with halo_transport="host" (the numpy
   oracle, the native engine for f64) within rtol 2e-5 / atol 2e-6 of the
   device run("perf") on 512²: on one rank (f32 and f64) and on 4 ranks of
   the 2×2 grid; the native engine (csrc/halostage.cpp, built with g++)
   bitwise equal to the numpy stepper at 2×2 of 512² f64, each one's ms
   per step;
13. wire — on the 2×2 grid of 512² f32, perf with an f32 and a bf16
   wire and run_deep k = 8 with bf16, int8 and int8_delta, each within its
   wire.TOLERANCE row of the f64 host-staged oracle; the same runs in f64
   within 1e-12 of 4 CPU gloo ranks, and six exchanges of each reduced
   mode, ghosts and state, bitwise equal to the CPU ranks'; the f32
   wire's exchange bitwise equal to the zero-padded global field; the
   bytes an interior rank sends per mode;
14. dryrun — rocm_mpi_tpu_torch.entry.dryrun_multichip(4), every leg
   launching its kernels;
15. weak scaling (run after phase 10, before the transport phases) — the
   weak-scaling app's rungs (rocm_mpi_tpu_torch/apps/weak_scaling.py,
   counts 1, 2 and 4 at 252² a rank, f32): diffusion perf, hide and deep
   under the scan driver and hide under the step driver, every row
   finite, the sharded per-step rows on their scan route, the deep rows
   on their loop route (graphs on one card and over NCCL), and the
   gathered 4-rank perf field bitwise equal to the whole-domain run of
   the same kernel on one GPU; then perf and hide under the scan driver
   over the padded route (their launches not counted with the main
   path's), printed beside; on one card 4 gloo ranks share it (120
   steps after 24, rows `mechanics_only`), with `--gpus 4` one rank a
   card over NCCL (the app's 2000 after 200: the north-star rows);
16. 3d (run after phase 5's [scan]) — BASELINE.json's diffusion_3D_perf_hide
   at 128³ f32: `perf` under the scan driver's graphs (masked_step in 3D,
   100 steps after 10) and run_deep k = 8 (112 after 16, graphs of
   sweeps; the JAX rule routes its 144³ block to plain steps, "jnp": no
   kernel), each bitwise against its plain-version run with its launches
   counted (run_deep also against its eager sweep loop), ms/step, Gpts/s
   and the bytes bound printed; run_hbm_blocked k = 8 (112 after 16,
   graphs of sweeps: route hbm-tb, one tb_sweep launch a sweep, bitwise
   its plain-version run and its eager sweep loop, ms/step beside
   perf's); tb_sweep at k = 16 on 160³ (128³ with its ghosts) bitwise
   its plain version; then the 3D app at its defaults as a subprocess. With `--gpus 4`: the 2×2×1
   grid of 256×256×128 (128³ a rank) over NCCL under the graphs — `perf`,
   `hide` at the app's shell (8, 8, 128), clamped to (8, 8, 64) with no
   interior box, and at (8, 8, 8), and run_deep k = 8 — every rank bitwise
   its plain-version run and `hide` bitwise `perf`, the boxes and each
   ms/step printed, `perf` and `hide` (8, 8, 8) also over the padded
   route, bitwise, their ms/step beside; then the app under torchrun on
   the four cards;
17. checkpoint (after 16) — utils/checkpoint.py: a run of 48 steps saved
   every 16, "crashed" after 32 and resumed from latest_valid_step into a
   fresh model, bitwise the straight 48-step run, for diffusion `perf`
   12288² f32 under the scan driver with exact segments, run_deep k = 8
   (--ckpt-every 10 rounded to 16) and SWE `perf` 252² f64 (a tuple
   state; mass drift held); a truncated newest step skipped by
   latest_valid_step and a flipped byte refused by restore_state; save
   ms, bytes a save and restore ms printed. With `--gpus 4`: 2×2 of
   12288² `perf` over NCCL graphs, each rank saving its 6144² shard,
   every rank resumed bitwise. Checkpoints go to a temporary directory
   that the phase removes;
18. telemetry (after 17; the four-card form after 15) — the telemetry
   plane (rocm_mpi_tpu_torch/telemetry/): diffusion `perf` at 12288²
   (200 after 10) and 252² (1000 after 10) f32 under the scan and the
   step driver with telemetry off, on, on, off: fields bitwise, LAUNCHES
   identical, the step_window span's dur_s == the run's wtime, each
   ms/step printed (telemetry's cost a step); the scan driver's captures
   counted by telemetry.compiles (== the plan's graphs, steady_state 0
   after a warmup; a warmup-0 run's in-window captures counted as
   steady-state recompiles); the wave's 252² perf under scan emitting its
   halo.exchange annotation once through its captures; --health
   (SIGUSR2 owned by neither torch nor NCCL, the heartbeat's step == nt,
   SIGUSR2 writing the traceback); the 12288² perf app with --profile
   (its trace names rmt_masked_step) and --telemetry (read by the port's
   `telemetry summarize`). With `--gpus 4`: the weak-scaling app (its
   main() on 4 ranks, one a card) with --telemetry --health at 252² a
   rank beside a telemetry-off ladder (merged summary of ranks 0-3 with
   halo, interior and checkpoint time, every rank's halo.probe bytes its
   face exchange's, the probes replaying captured calls as the scan
   driver's steps do, trace pids 0-3, each rank's probe and heartbeat
   times), then the profiling app under torchrun at 2×2 of 8192² as it
   runs by default, the scan driver (prof.txt lists rmt_fused_step_cm
   and NCCL's kernels; every rank's trace names rmt_fused_step_cm);
19. tune (after 18) — the tuning plane (rocm_mpi_tpu_torch/tuning/) with
   a cache file in a temporary directory: the search of the three VMEM
   loops and diffusion.deep at 252² f32 (each winner, its median µs a
   step, every candidate's, the candidates gated out, the build and
   capture seconds), the CLI's warm re-search (all hits: nothing built,
   captured or launched, the file byte-identical, compiles.steady_state
   0), `validate` (exit 0 on the file, 1 with a doctored pad entry, 140²
   padded to 256²), every config="auto" run bitwise its explicit run
   (the winners; a hand scan chunk of 16 for the three scan drivers) and
   on a cold cache its default run, and masked_step at 12288² f32 with
   run_rows 1, 2 and 4 (and from the cache) bitwise the default launch
   and the plain version, each timed. With `--gpus 4`: weak_scaling
   --autotune on 4 spawned ranks (hide, scan, 252² a rank) with the 2×2
   rung's scan chunk in rank 0's cache file alone: every rank of that
   rung runs the tuned q, the other rungs the default;
20. resilience (after 19) — the resilience plane
   (rocm_mpi_tpu_torch/resilience/) on diffusion `perf` at 12288² f32
   under the scan driver with exact segments (masked_step), each drill
   bitwise against the straight run of the same length: (a) the app's
   `--checkpoint --retries 2 --inject-fault crash@step=32` path (48 steps
   saved every 16) under run_supervised: the events attempt-failed,
   backoff, restored and recovered, no graph captured by the retry, the
   launches counted; (b) truncate-latest and a crash at step 32: the
   supervisor skips the torn step and restores 16; (c) real preemption:
   SIGTERM to the app as a child (4000 steps saved every 1000) with
   RMT_PREEMPT_GRACE_S 30 (above the p90 save wall: the emergency save,
   exit 75, a --resume run bitwise) and 0.2 (below it: preempt.skip-save,
   exit 75, no torn step directory); (d) a storage outage
   (io-error@step=16,times=3): degraded, then recovered, the result
   unchanged. The recovery walls, the save-wall p90 and the bytes a save
   printed. With `--gpus 4`: [elastic] — the app on 2×2 of 12288²
   (fused_step_cm's face form under the graphs, NCCL) through the argv
   launcher (parallel/launcher.spawn_app_ranks) and run_elastic: (a)
   die@step=32,rank=3: the vanish detected, the grid shrunk to
   plan_dims's (3, 1), the run resumed from step 32 through the reshard
   restore, then (device_budget 4) preempted at a boundary and grown back
   to 2×2; each grid's saves bitwise (per-shard crc32) those of a
   continuation twin of the same checkpoint on the same grid; (b)
   stall@step=32,rank=1,at=segment-pre: the watchdog names rank 1 by
   progress, writes the post-mortem bundle, and the run shrinks and
   completes; (c) crash@step=32,rank=3 with no retries, its peers
   waiting on it in NCCL: the crashing rank exits non-zero on its own,
   first (apps/_common.finalized: no teardown there), the peers are
   reaped after the peer grace, the run shrinks to (3, 1), resumes from
   step 32 and ends bitwise a continuation twin's. Each launch's dims,
   the resume steps, the time from the fault to the next launch's first
   step and the elastic.jsonl record count printed; no rank outlives its
   launch;
21. serve (after 20) — the serving core (rocm_mpi_tpu_torch/serving/): a
   trace of ~50 requests (diffusion, wave and SWE at 256², 1024² and
   4096², 1000² on its 1024² ladder rung, mostly f32 with f64 and bf16,
   nt 32-512, diffusion `hide` requests whose lanes launch fused_step_cm
   once a lane, box and step (exactly 5 × their steps), two session
   requests) through SimulationService with the ladder on at width 8; the
   hide lanes' kernel at the shapes serving gives it (1024² f32 and 256²
   f64 lane blocks, faces None) bitwise its plain version step by step;
   every lane bitwise equal to its standalone run on the card, the
   sessions resumed bitwise, a repeat
   trace building and capturing nothing with no growth of
   torch.cuda.memory_allocated, the trace without the ladder at pipeline
   depth 1 and 2 bitwise equal (and equal to the ladder's lanes), the
   manifest valid, and the serve app (a child process) serving the trace
   file with the same program keys; requests/s, lane-Gpts/s, occupancy,
   device_bubble and the peak memory printed. With `--gpus 4`: the trace
   without sessions on 4 ranks over NCCL at batch_dims 2 and 1, every
   rank's shard of every lane bitwise (by digest) the one-card service's
   lane;
22. fleet (after 21) — the fleet half of serving (serving/router.py,
   serving/journal.py, apps/fleet.py, apps/soak.py): (a) three
   SimulationService replicas behind a FleetRouter serve phase 21's trace
   (no ladder, width 8), paced in the fleet app's four waves under
   replica-kill@step=2,rank=1: replica 1 dies at tick 2 and lets its
   programs go, its open tickets are re-routed from the journal (replay
   idempotent), every ticket ends done exactly once, every lane bitwise
   equal to the same trace through one standalone service, fused_step_cm
   launched exactly 5 × the hide lane-steps, the two sessions resumed
   through the fleet bitwise, the fleet report valid with steady_state 0
   in every row, and torch.cuda.memory_allocated back to its level before
   the fleet once the router is dropped (the fleet's and the standalone
   service's walls, requests/s, each replica's served count, the
   re-routed count, the time from the kill tick to the last re-routed
   ticket's terminal state and the peak memory printed); (b) the fleet app
   as a child under the same fault: exit 0, both sidecars valid; (c) the
   bounded soak (apps/soak.py --bounded --device cuda) as a child: exit 0,
   its nine episodes ok, its report valid, no rank left behind. With
   `--gpus 4`: the fleet app on 4 ranks over NCCL (every rank the same
   replica map and journal digest, the books balanced), then the soak's
   full schedule with its four rank episodes on 4 ranks over NCCL (kill
   names rank 1 with rc 43, die is a vanish, stall a watchdog verdict on
   rank 1).

With `--gpus 4` phases 6-22 run one rank per GPU over NCCL (6 and 8 for
500 steps after 10 warmup, 7 for 1000 after 16; 8 also with the
exchange (the face exchange and the padded one), the interiors and the
slabs (the diffusion's from the faces and from the block) timed alone; 13
also with the
exchange alone per wire mode at 2×2 of 12288², widths 1 and 8), and
phases 3-5 are skipped. `chip_trace_hide.py` traces the phase-8 steps under
torch.profiler.

Then it prints the card line, one JSON line describing every kernel, and
last `{"ok": true, "device": {...}}`. Any failed phase raises: the script
exits non-zero and prints no result line. Whether it passes or fails, it
stops every process it started before it exits: the rank processes,
multiprocessing's resource tracker and anything orphaned under it (the
script is their subreaper). It exits 1 without CUDA and 2
when the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import pathlib
import shutil
import signal
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0

# Published peaks (NVIDIA data sheets; dense rates at the full power
# limit): memory bytes/s, and flop/s outside the tensor cores in f32 and
# f64. Matched on the card's name, first hit wins.
PEAKS = (
    ("H200", 4.8e12, 67e12, 34e12),
    ("H100 NVL", 3.9e12, 60e12, 30e12),
    ("H100 PCIe", 2.0e12, 51e12, 26e12),
    ("H100", 3.35e12, 67e12, 34e12),  # SXM, HBM3
)

BIG, SMALL = (12288, 12288), (252, 252)
BLOCK = (6144, 6144)  # one rank's block of a 2×2 decomposition of 12288²
DEEP_SMALL = (316, 316)  # 252² grown by the k = 32 deep ghosts
WAVE_DEEP_SMALL = (268, 268)  # 252² grown by the wave's k = 8 deep ghosts
TB_BIG = (12304, 12304)  # 12288² grown by the k = 8 deep ghosts
TB_BLOCK = (6160, 6160)  # a 6144² shard grown by the k = 8 deep ghosts
TB_K16 = (12320, 12320)  # 12288² grown by k = 16 ghosts, tb_geometry's other class
TB_RAGGED = (1000, 777)  # no dimension a multiple of a strip or a segment
KP_ODD, KP_SMALL_ODD = (12288, 12287), (128, 127)  # rows off the 16-byte grid
SMALL_3D = (96, 64, 48)
TB3_K16 = (64, 96, 96)  # a 3D block whose 64-plane k = 16 slab JAX admits: two stripes
KP_SMALL = (128, 128)  # the kp app's default grid
KP = ("kp_flux", "kp_residual", "kp_update")
SWE_DEEP_SMALL = (240, 240)  # run_deep's k = 8 sweep: 256² padded, the admission's edge
SWE_DEEP_PADDED = (256, 256)
SWE_F64 = (180, 180)  # the f64 multi-step admission takes at most 181²
SWE_3D = (32, 24, 24)  # a 3D block within the multi-step admission
RAGGED = (253, 251)  # n0 no multiple of a cluster: bands of 16 and 15 rows
# Rows of the multi-step kernels' capacity-edge blocks (the admission's
# largest 2D square in f32): the widest block of these rows that one
# cluster holds, and one column more, which takes the cooperative route.
EDGE_ROWS = {"multi_step_cm": 724, "wave_multi_step": 512, "swe_multi_step": 256}
# Blocks of the main paths that must take the multi-step kernels' cluster
# route, at the cluster size the card grants: the VMEM loops at 252² (and
# 180² f64 for the SWE), run_deep's 316² (diffusion), 268² (wave) and 256²
# (SWE) blocks, one GPU and per rank on the 2×2 grid of 480², and the 3D
# blocks (diffusion's in f32 only: f64's two buffers exceed a cluster).
RESIDENT_MAIN = {
    "multi_step_cm": ((252, 252), (316, 316)),
    "wave_multi_step": ((252, 252), (268, 268)),
    "swe_multi_step": ((252, 252), (256, 256), (180, 180), (32, 24, 24)),
}
RESIDENT_MAIN_F32 = {"multi_step_cm": (SMALL_3D,)}
HIDE_B_WIDTH = (32, 4)  # the reference's boundary frame (hide.jl:42)
# [3d]: BASELINE.json's diffusion_3D_perf_hide, 128³ a device, f32.
CUBE = (128, 128, 128)
CUBE_DEEP = (144, 144, 144)  # 128³ grown by the k = 8 deep ghosts: tb_sweep's block
CUBE_SHARDED, CUBE_DIMS = (256, 256, 128), (2, 2, 1)  # 128³ a rank on four cards
CUBE_NT, CUBE_WARMUP = 110, 10  # 100 steps after 10
CUBE_DEEP_NT, CUBE_DEEP_WARMUP = 128, 16  # 112 after 16: k = 8 divides both windows
APP_B_WIDTH_3D = (8, 8, 128)  # the app's shell: clamps to (8, 8, 64), no interior
HIDE_B_WIDTH_3D = (8, 8, 8)  # a shell that leaves an interior to hide
# [checkpoint]: a run of CKPT_NT steps saved every CKPT_EVERY, "crashed"
# after CKPT_CRASH and resumed.
CKPT_NT, CKPT_EVERY, CKPT_CRASH = 48, 16, 32
# [resilience]: the supervised drills reuse the checkpoint phase's run;
# the preemption drills run the app as a child, long enough segments
# (1000 steps, ~0.6 s at 12288²) that the SIGTERM lands inside one.
PREEMPT_NT, PREEMPT_EVERY = 4000, 1000
PREEMPT_GRACES = (30.0, 0.2)  # above and below the p90 save wall (under a second here)
# [elastic], four cards: the app on 2×2 of 12288², saves every 16 steps.
ELASTIC_NT, ELASTIC_EVERY, ELASTIC_FAULT = 320, 16, 32
# [sharded-scan]: (label, model, variant, wire mode) on the 2×2 grid of
# 12288², each under three drivers, in 500 timed steps (q = 10).
SHARDED_SCAN_NT, SHARDED_SCAN_WARMUP = 510, 10
SHARDED_SCAN_RUNS = (
    ("diffusion perf", "diffusion", "perf", "f32"),
    ("diffusion kp", "diffusion", "kp", "f32"),
    ("diffusion hide", "diffusion", "hide", "f32"),
    ("wave perf", "wave", "perf", "f32"),
    ("wave hide", "wave", "hide", "f32"),
    ("swe perf", "swe", "perf", "f32"),
    ("swe hide", "swe", "hide", "f32"),
    ("diffusion perf, bf16 wire", "diffusion", "perf", "bf16"),
    # The padded route the face exchange replaced (register_padded_variants):
    # the yardstick of the two diffusion rows above, bitwise their fields.
    ("diffusion perf, padded route", "diffusion", "perf-padded", "f32"),
    ("diffusion hide, padded route", "diffusion", "hide-padded", "f32"),
)
# [weak-scaling]: the north-star geometry, 252² a rank, the app's rungs.
WEAK_LOCAL, WEAK_COUNTS = 252, "1,2,4"
WEAK_RUNS = (("perf", "scan"), ("hide", "scan"), ("deep", "scan"), ("hide", "step"))
# The same ladder over the padded route the face exchange replaced
# (padded_route()): the yardstick of the sharded perf and hide rungs.
WEAK_PADDED_RUNS = (("perf", "scan"), ("hide", "scan"))
# (nt, warmup) by card count: the app's defaults on four cards; on one
# card the gloo ranks stage every exchange through host memory, so fewer.
WEAK_WINDOWS = {4: (2000, 200), 1: (120, 24)}
# [tune]: the search's setting and the auto runs' windows (64 | 320 - 64;
# a hand scan chunk of 16 gives q = 16 where the default is 64).
TUNE_SHAPE = (252, 252)
TUNE_OPS = ("diffusion.vmem_loop", "wave.vmem_loop", "swe.vmem_loop", "diffusion.deep")
TUNE_SCAN_OPS = ("diffusion.scan", "wave.scan", "swe.scan")
TUNE_REPEATS = 3
TUNE_NT, TUNE_WARMUP, TUNE_SCAN_CHUNK = 320, 64, 16
TUNE_RUN_ROWS = (1, 2, 4)  # masked_step's run lengths (csrc/stencil.cu kMsRunRows)
KERNELS = {
    # name: (source line of the TPU kernel it replaces, CUDA source)
    "masked_step": ("rocm_mpi_tpu/ops/pallas_kernels.py:1191", "stencil.cu"),
    "fused_step_cm": ("rocm_mpi_tpu/ops/pallas_kernels.py:290", "stencil.cu"),
    "multi_step_cm": ("rocm_mpi_tpu/ops/pallas_kernels.py:566", "multistep.cu"),
    "tb_sweep": ("rocm_mpi_tpu/ops/pallas_kernels.py:889", "multistep.cu"),
    "wave_step": ("rocm_mpi_tpu/ops/wave_kernels.py:76", "wave.cu"),
    "wave_step_masked": ("rocm_mpi_tpu/ops/wave_kernels.py:140", "wave.cu"),
    "wave_multi_step": ("rocm_mpi_tpu/ops/wave_kernels.py:244", "wave.cu"),
    "swe_step": ("rocm_mpi_tpu/ops/swe_kernels.py:142", "swe.cu"),
    "swe_multi_step": ("rocm_mpi_tpu/ops/swe_kernels.py:197", "swe.cu"),
    "kp_flux": ("rocm_mpi_tpu/ops/pallas_kernels.py:339", "kp.cu"),
    "kp_residual": ("rocm_mpi_tpu/ops/pallas_kernels.py:350", "kp.cu"),
    "kp_update": ("rocm_mpi_tpu/ops/pallas_kernels.py:359", "kp.cu"),
    "fused_step_padded": ("rocm_mpi_tpu/ops/pallas_kernels.py:136", "stencil.cu"),
}
ALL_DTYPES = ("f32", "f64", "bf16")
HOST_CALLS = 200  # back-to-back wrapper calls timed on the host clock
FUSED_LOOP = 200  # fused_step_cm launches queued between two CUDA events
# Kernel cases: (kernel, block shape, steps per launch, body form, dtypes).
# The block shape is the core; the padded kernels read it grown by one.
# "regions" launches one box per region of the hide decomposition of
# HIDE_B_WIDTH into one output (the interior from the raw block).
KERNEL_CASES = [
    ("masked_step", SMALL, 1, "direct", ALL_DTYPES),
    ("masked_step", BIG, 1, "direct", ALL_DTYPES),
    ("masked_step", KP_ODD, 1, "direct", ALL_DTYPES),  # rows off the 16-byte grid
    ("masked_step", BIG, 1, "offset", ALL_DTYPES),  # T a view at storage offset 1
    ("fused_step_cm", SMALL, 1, "direct", ALL_DTYPES),
    ("fused_step_cm", BLOCK, 1, "direct", ALL_DTYPES),  # the padded caller: scalar cells
    ("fused_step_cm", BLOCK, 1, "regions", ALL_DTYPES),
    # The face form, as the sharded perf and hide steps launch it.
    ("fused_step_cm", SMALL, 1, "faces", ALL_DTYPES),
    ("fused_step_cm", BLOCK, 1, "faces", ALL_DTYPES),
    ("fused_step_cm", BLOCK, 1, "faces-edge", ALL_DTYPES),
    ("fused_step_cm", BLOCK, 1, "faces-null", ALL_DTYPES),
    ("fused_step_cm", BLOCK, 1, "face-regions", ALL_DTYPES),
    ("fused_step_cm", RAGGED, 1, "faces", ALL_DTYPES),  # a ragged last axis: scalar cells
    ("fused_step_cm", BIG, 1, "face-regions", ("f64",)),  # the hide cell's rank
    ("multi_step_cm", DEEP_SMALL, 32, "eqc", ALL_DTYPES),
    ("multi_step_cm", SMALL, 256, "eqc", ALL_DTYPES),
    ("multi_step_cm", DEEP_SMALL, 32, "direct", ("f32",)),
    ("multi_step_cm", DEEP_SMALL, 32, "ac", ("f32",)),
    ("multi_step_cm", DEEP_SMALL, 32, "conly", ("f32",)),
    ("multi_step_cm", RAGGED, 8, "eqc", ALL_DTYPES),
    ("multi_step_cm", RAGGED, 8, "ac", ("f64",)),
    ("tb_sweep", TB_BIG, 8, "direct", ALL_DTYPES),
    ("tb_sweep", TB_BLOCK, 8, "direct", ALL_DTYPES),
    ("tb_sweep", TB_K16, 16, "direct", ALL_DTYPES),
    ("tb_sweep", TB_RAGGED, 5, "direct", ALL_DTYPES),
    ("wave_step", BIG, 1, "direct", ALL_DTYPES),
    ("wave_step", SMALL, 1, "direct", ALL_DTYPES),
    ("wave_step_masked", BLOCK, 1, "whole", ALL_DTYPES),
    ("wave_step_masked", BLOCK, 1, "regions", ALL_DTYPES),
    ("wave_step_masked", SMALL, 1, "whole", ALL_DTYPES),
    ("wave_multi_step", SMALL, 256, "aform", ALL_DTYPES),
    ("wave_multi_step", WAVE_DEEP_SMALL, 8, "aform", ALL_DTYPES),
    ("wave_multi_step", WAVE_DEEP_SMALL, 2, "direct", ("f32",)),
    ("wave_multi_step", RAGGED, 8, "aform", ALL_DTYPES),
    ("swe_step", BIG, 1, "whole", ALL_DTYPES),
    ("swe_step", SMALL, 1, "whole", ALL_DTYPES),
    ("swe_step", BLOCK, 1, "regions", ALL_DTYPES),
    ("swe_multi_step", SMALL, 256, "direct", ("f32", "bf16")),
    ("swe_multi_step", SWE_DEEP_PADDED, 8, "direct", ("f32", "bf16")),
    ("swe_multi_step", SWE_F64, 256, "direct", ("f64",)),
    ("swe_multi_step", RAGGED, 8, "direct", ALL_DTYPES),
    ("kp_flux", BIG, 1, "direct", ALL_DTYPES),
    ("kp_residual", BIG, 1, "direct", ALL_DTYPES),
    ("kp_update", BIG, 1, "direct", ALL_DTYPES),
    ("kp_flux", KP_SMALL, 1, "direct", ALL_DTYPES),
    ("kp_residual", KP_SMALL, 1, "direct", ALL_DTYPES),
    ("kp_update", KP_SMALL, 1, "direct", ALL_DTYPES),
    ("kp_update", KP_ODD, 1, "direct", ALL_DTYPES),
    ("kp_update", KP_SMALL_ODD, 1, "direct", ALL_DTYPES),
    # kp_flux, kp_residual and fused_step_padded on both lane-tiled
    # layouts: 12288² and a rank's 6144² block take the vectors (f32,
    # bf16), a ragged last axis and views at storage offset 1 (Tp and qx,
    # qx and Cp, Tp and Cp) the scalar cells (kp_flux's and kp_residual's
    # f64 always); fused_step_padded's f64 and every small case below the
    # fill take one cell a thread.
    ("kp_flux", KP_ODD, 1, "direct", ALL_DTYPES),
    ("kp_flux", BIG, 1, "offset", ALL_DTYPES),
    ("kp_residual", KP_ODD, 1, "direct", ALL_DTYPES),
    ("kp_residual", BIG, 1, "offset", ALL_DTYPES),
    ("kp_flux", BLOCK, 1, "direct", ALL_DTYPES),
    ("fused_step_padded", BIG, 1, "direct", ALL_DTYPES),
    ("fused_step_padded", KP_ODD, 1, "direct", ALL_DTYPES),
    ("fused_step_padded", BIG, 1, "offset", ALL_DTYPES),
    ("fused_step_padded", BLOCK, 1, "direct", ALL_DTYPES),
    ("fused_step_padded", SMALL, 1, "direct", ALL_DTYPES),
    # 3D, at small sizes: every kernel takes 3D blocks, which no main path
    # drives on the card yet.
    ("masked_step", SMALL_3D, 1, "direct", ALL_DTYPES),
    ("fused_step_cm", SMALL_3D, 1, "direct", ALL_DTYPES),
    ("fused_step_cm", SMALL_3D, 1, "faces", ALL_DTYPES),
    ("fused_step_cm", SMALL_3D, 1, "faces-edge", ALL_DTYPES),
    ("fused_step_cm", SMALL_3D, 1, "face-regions", ALL_DTYPES),
    ("multi_step_cm", SMALL_3D, 8, "eqc", ALL_DTYPES),
    ("multi_step_cm", SMALL_3D, 8, "ac", ("f32",)),
    ("multi_step_cm", SMALL_3D, 8, "direct", ("f32",)),
    ("multi_step_cm", SMALL_3D, 8, "conly", ("f32",)),
    ("tb_sweep", SMALL_3D, 8, "direct", ALL_DTYPES),
    ("tb_sweep", SMALL_3D, 1, "direct", ALL_DTYPES),
    ("tb_sweep", SMALL_3D, 5, "direct", ALL_DTYPES),
    ("tb_sweep", SMALL_3D, 13, "direct", ALL_DTYPES),
    ("tb_sweep", TB3_K16, 16, "direct", ALL_DTYPES),
    ("wave_step", SMALL_3D, 1, "direct", ALL_DTYPES),
    ("wave_step_masked", SMALL_3D, 1, "regions", ALL_DTYPES),
    ("wave_multi_step", SMALL_3D, 8, "direct", ALL_DTYPES),  # unequal spacing
    ("swe_step", SWE_3D, 1, "regions", ALL_DTYPES),
    ("swe_multi_step", SWE_3D, 8, "direct", ALL_DTYPES),
    ("fused_step_padded", SMALL_3D, 1, "direct", ALL_DTYPES),
    # The 3D main paths' blocks at 128³ a device ([3d]): masked_step on one
    # card, fused_step_cm and its hide boxes (HIDE_B_WIDTH_3D) a rank,
    # tb_sweep on run_hbm_blocked's 128³ and run_deep's k = 8 padded block.
    ("masked_step", CUBE, 1, "direct", ("f32",)),
    ("fused_step_cm", CUBE, 1, "direct", ("f32",)),
    ("fused_step_cm", CUBE, 1, "regions", ("f32",)),
    ("fused_step_cm", CUBE, 1, "faces", ALL_DTYPES),
    ("fused_step_cm", CUBE, 1, "face-regions", ALL_DTYPES),
    ("tb_sweep", CUBE, 8, "direct", ALL_DTYPES),
    ("tb_sweep", CUBE_DEEP, 8, "direct", ALL_DTYPES),
]
# The f32 case whose times stand for each kernel in the JSON line: the
# launch its main path makes most.
MAIN_CASE = {"masked_step": (BIG, "direct"), "fused_step_cm": (BLOCK, "faces"),
             "multi_step_cm": (SMALL, "eqc"), "tb_sweep": (TB_BIG, "direct"),
             "wave_step": (BIG, "direct"), "wave_step_masked": (BLOCK, "regions"),
             "wave_multi_step": (SMALL, "aform"), "swe_step": (BIG, "whole"),
             "swe_multi_step": (SMALL, "direct"), "kp_flux": (BIG, "direct"),
             "kp_residual": (BIG, "direct"), "kp_update": (BIG, "direct"),
             "fused_step_padded": (BIG, "direct")}
# Operations per cell and step of each kernel and body form (the
# per-launch A/c/eqc prologue, a few operations per cell, is left out).
FLOPS_PER_CELL_STEP = {
    ("masked_step", "direct"): lambda nd: 5 * nd + 1,
    ("masked_step", "offset"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "direct"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "regions"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "faces"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "faces-edge"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "faces-null"): lambda nd: 5 * nd + 1,
    ("fused_step_cm", "face-regions"): lambda nd: 5 * nd + 1,
    ("multi_step_cm", "direct"): lambda nd: 5 * nd + 1,
    ("tb_sweep", "direct"): lambda nd: 5 * nd + 1,
    ("multi_step_cm", "ac"): lambda nd: 3 * nd + 1,
    ("multi_step_cm", "eqc"): lambda nd: 2 * nd + 2,
    ("multi_step_cm", "conly"): lambda nd: 2 * nd + 3,
    ("wave_step", "direct"): lambda nd: 5 * nd + 4,
    ("wave_step_masked", "whole"): lambda nd: 5 * nd + 7,
    ("wave_step_masked", "regions"): lambda nd: 5 * nd + 7,
    ("wave_multi_step", "aform"): lambda nd: 2 * nd + 8,
    ("wave_multi_step", "direct"): lambda nd: 5 * nd + 4,
    # JAX's order: 3·ndim for h' (difference, product, sum per axis), 4 per
    # velocity (difference, product, difference, mask product).
    ("swe_step", "whole"): lambda nd: 7 * nd,
    ("swe_step", "regions"): lambda nd: 7 * nd,
    ("swe_multi_step", "direct"): lambda nd: 7 * nd,
    # kp, per core cell: flux a difference and two products on each of its
    # two faces; the residual two differences, two products, a sum, a
    # negation and a division; the update a product and a sum.
    ("kp_flux", "direct"): lambda nd: 6,
    ("kp_flux", "offset"): lambda nd: 6,
    ("kp_residual", "direct"): lambda nd: 7,
    ("kp_residual", "offset"): lambda nd: 7,
    ("kp_update", "direct"): lambda nd: 2,
    ("fused_step_padded", "direct"): lambda nd: 5 * nd + 2,
    ("fused_step_padded", "offset"): lambda nd: 5 * nd + 2,
}
MAIN_NT, MAIN_WARMUP = 1000, 10
# The 12288² runs of the per-step paths and their plain-version
# references: on one GPU [main], [kp], [wave], [swe] and [scan], with
# `--gpus 4` [sharded] and [hide]. Half of MAIN_NT keeps the whole
# script within its time.
BIG_NT = 500
SHARD_NT, SHARD_WARMUP = 20, 2
# Windows of the multi-step schedules: k divides both, so nothing degrades.
VMEM_NT, VMEM_WARMUP = 4352, 256
VMEM_CHECK_NT = 1024  # the analytic check's run: by 4352 steps the
# Gaussian has reached the held walls and the free-space solution no
# longer applies
DEEP_SMALL_NT, DEEP_SMALL_WARMUP = 1056, 32
TB_NT, TB_WARMUP = 1016, 16
SHARD_DEEP_NT, SHARD_DEEP_WARMUP = 48, 16
WAVE_DEEP_NT, WAVE_DEEP_WARMUP, WAVE_DEEP_K = 1032, 8, 8
REVERSAL_STEPS = 500
WAVE_DEEP_SHARDED = (480, 480)  # 2×2 shards of 240², 256² with the k = 8 ghosts
SWE_MASS_BOUND = {"f64": 1e-13, "f32": 1e-6}
# The transport plane's phases.
RING_ROUNDS = 1000  # ring rounds timed per message size
RING_SLAB = 6144  # one halo row of a 6144² shard (2×2 of 12288²)
HOST_SHAPE = (512, 512)
HOST_NT, HOST_WARMUP = 100, 10
HOST_TIMED_STEPS = 20  # steps timed for the native engine and the numpy stepper
HOST_TOL = dict(rtol=2e-5, atol=2e-6)  # the JAX dry run's tolerance against the oracle
WIRE_SHAPE = (512, 512)
WIRE_NT, WIRE_WARMUP, WIRE_K = 200, 8, 8  # k divides both windows
WIRE_CASES = (("perf", "f32"), ("perf", "bf16"), ("deep", "bf16"), ("deep", "int8"),
              ("deep", "int8_delta"))
# The card's f64 wire runs against the same runs on CPU gloo ranks, which
# tests/test_torch_wire.py holds to the JAX package within 1e-12 in f64.
WIRE_TWIN_TOL = 1e-12
WIRE_SENDS = 6  # exchanges threaded through each codec's state
# The kernels each leg of dryrun_multichip must launch on the card.
DRYRUN_LEGS = {
    "kp": ("kp_flux", "kp_residual", "kp_update"), "perf": ("fused_step_cm",),
    "hide": ("fused_step_cm",), "deep": ("multi_step_cm",), "hbm": ("tb_sweep",),
    "wave-perf": ("wave_step",), "wave-hide": ("wave_step_masked",),
    "wave-deep": ("wave_multi_step",), "swe-perf": ("swe_step",), "swe-hide": ("swe_step",),
    "swe-deep": ("swe_multi_step",), "3d-perf": ("fused_step_cm",),
    "3d-hide": ("fused_step_cm",), "3d-deep": ("multi_step_cm",),
    "wave-3d-perf": ("wave_step",), "wave-3d-hide": ("wave_step_masked",),
    "wave-3d-deep": ("wave_multi_step",), "swe-3d-perf": ("swe_step",),
    "swe-3d-hide": ("swe_step",), "swe-3d-deep": ("swe_multi_step",),
    "checkpoint": ("fused_step_cm",),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def adopt_orphans():
    """Make this process the subreaper of every process it starts
    (PR_SET_CHILD_SUBREAPER), so that a process orphaned by a rank's exit
    is reparented here and stopped by stop_children."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children() -> list[int]:
    """The pids of this process's live children (zombies included)."""
    me, pids = os.getpid(), []
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            pids.append(int(entry.name))
    return pids


def stop_children(grace: float = 10.0):
    """Stop every process this script started before it exits: join the
    rank processes, stop multiprocessing's resource tracker (which the
    spawned ranks start and which would otherwise outlive the script until
    it notices the closed pipe), then terminate and reap anything left,
    naming it on stderr."""
    import multiprocessing
    from multiprocessing import resource_tracker

    for p in multiprocessing.active_children():
        p.join(timeout=grace)
        if p.is_alive():
            p.kill()
            p.join()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    left = children()
    for pid in left:
        try:
            cmd = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            cmd = b"?"
        print(f"chip_smoke: stopping leftover process {pid}: {cmd.decode(errors='replace')}",
              file=sys.stderr, flush=True)
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    def running(pid):
        try:
            return os.waitpid(pid, os.WNOHANG) == (0, 0)
        except ChildProcessError:
            return False

    deadline = time.monotonic() + grace
    while left and time.monotonic() < deadline:
        left = [pid for pid in left if running(pid)]
        if left:
            time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


def only(kernel: str, count: int) -> dict:
    """The launch counts of a run that launched `kernel` `count` times and
    no other kernel."""
    from rocm_mpi_tpu_torch.ops import kernels

    return {name: count if name == kernel else 0 for name in kernels.LAUNCHES}


def peaks(name: str):
    for frag, bw, f32, f64 in PEAKS:
        if frag in name:
            return {"bytes_per_s": bw, "f32": f32, "f64": f64, "assumed": False}
    return {"bytes_per_s": PEAKS[-1][1], "f32": PEAKS[-1][2], "f64": PEAKS[-1][3],
            "assumed": True}


def bound_ms(pk, dtype: str, nbytes: int, cells: int, steps: int,
             flops_per_cell_step: int):
    """The least time the card could take: the larger of `nbytes` over the
    memory rate and cells·steps·flops_per_cell_step over the f32 (f32 and
    bf16, which computes in f32) or f64 peak. Returns (ms, "bytes" or
    "operations", flops)."""
    flops = cells * steps * flops_per_cell_step
    t_bytes = nbytes / pk["bytes_per_s"] * 1e3
    t_ops = flops / pk["f64" if dtype == "f64" else "f32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs a call of fn: `calls` calls back to back, no sync between
    them (the launches queue behind one another on the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_ms(fn, reps: int, host: float) -> float:
    """Median device time of `reps` launches of fn, each between two CUDA
    events, all enqueued while the card is held behind torch.cuda._sleep
    (long enough for the host to enqueue them, given its `host` µs a
    call), so that no launch waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    hold_s = 2 * reps * (host + 20.0) * 1e-6 + 1e-3
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles; the card clocks at most 2 GHz
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def loop_ms(fn, calls: int, host: float) -> float:
    """Device ms a call of fn over `calls` calls queued behind
    torch.cuda._sleep (long enough for the host to enqueue them at `host`
    µs a call), between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * calls * (host + 20.0) * 1e-6 + 1e-3) * 2e9))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` launches of fn, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment(torch, card):
    from rocm_mpi_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}", flush=True)
    print(f"[env] card: {card} (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)


def phase_build():
    from rocm_mpi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")), verbose=True)
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        print(f"[build] {name}.cu -> {info['path'].name} in {info['seconds']:.1f} s "
              "(nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false)", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)
    print(f"[build] total {seconds:.1f} s", flush=True)
    return seconds


def _kernel_case(torch, name, core, steps, form, dtype, device):
    """(kernel launch, plain version, bytes moved) of one kernel case, its
    inputs made as its path makes them: fields in [0, 1), coefficients from
    the grid's dt — edge-masked where the block's edge is the domain's
    (masked_step, and the multi-step kernels on one-GPU and deep-padded
    blocks, whose rings are held). The launches write a preallocated
    output; the bytes count each input read once and each output written
    once (the region case as the whole block it covers)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, WaveConfig
    from rocm_mpi_tpu_torch.ops import kernels, multistep, wave
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, ghost_free, region_boxes

    if name.startswith("swe_"):
        return _swe_kernel_case(torch, name, core, steps, form, dtype, device)
    if name in KP or name == "fused_step_padded":
        return _kp_kernel_case(torch, name, core, form, dtype, device)
    domain = (SMALL if core in (SMALL, DEEP_SMALL, WAVE_DEEP_SMALL)
              else core if len(core) == 3 else BIG)
    lengths = (10.0,) * len(domain)
    cfg = DiffusionConfig(global_shape=domain, lengths=lengths, dtype=dtype)
    tdt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(SEED)
    spacing = cfg.spacing
    inv_d2 = kernels.inv_d2_of(spacing)
    padded = tuple(n + 2 for n in core)

    def rand(shape, scale=1.0, offset=0.0):
        return (torch.rand(shape, generator=gen, device=device, dtype=torch.float64) * scale
                + offset).to(tdt)

    def regions(launch, plain, src, out):
        """The hide decomposition's boxes: the interior from the raw block
        (offset 0), the slabs from the padded one (offset 1)."""
        raw = src[tuple(slice(1, -1) for _ in core)].contiguous()
        bw = HIDE_B_WIDTH_3D if core == CUBE else HIDE_B_WIDTH
        boxes = region_boxes(core, effective_b_width(core, bw))

        def run():
            for box in boxes:
                inner = ghost_free(box, core)
                launch(raw if inner else src, 0 if inner else 1, box, out)
            return out

        def ref():
            res = torch.empty_like(out)
            for box in boxes:
                window, sl = kernels.region_slices(box, 1)
                plain(src[window], sl, res[sl])
            return res

        return run, ref

    item = torch.empty((), dtype=tdt).element_size()
    cells = 1
    for n in core:
        cells *= n
    if name in ("masked_step", "multi_step_cm", "tb_sweep"):
        T = rand(core)
        Cm = kernels.edge_masked_cm(T, torch.ones_like(T), cfg.lam,
                                    torch.tensor(cfg.dt, dtype=tdt, device=device))
        if form == "offset":  # the same values one element past an allocation's start
            T = torch.cat([T.new_zeros(1), T.flatten()])[1:].view(core)
        out = torch.empty_like(T)
        if name == "masked_step":
            calls = (lambda: kernels.masked_step(T, Cm, spacing, out=out),
                     lambda: kernels.masked_step_plain(T, Cm, inv_d2))
            calls[0].layout = ("16-byte vectors" if kernels.masked_layout(
                core[-1], tdt, T.data_ptr(), Cm.data_ptr(), out.data_ptr()) else "scalar cells")
        elif name == "multi_step_cm":
            calls = (lambda: multistep.multi_step(T, Cm, inv_d2, steps, form, out=out),
                     lambda: multistep.multi_step_cm_plain(T, Cm, inv_d2, steps, form))
        else:
            calls = (lambda: multistep.tb_sweep(T, Cm, inv_d2, steps, out=out),
                     lambda: multistep.tb_sweep_plain(T, Cm, inv_d2, steps))
        return (*calls, 3 * cells * item)
    if name == "fused_step_cm":
        # The face form reads the core, the 2·ndim faces and Cm once and
        # writes out once (no corner of a padded block): its bytes.
        Tp = rand(padded)
        Cm = rand(core, cfg.dt)
        out = torch.empty(core, dtype=tdt, device=device)
        nbytes = (3 * cells + 2 * sum(cells // n for n in core)) * item
        if form in ("direct", "regions"):
            # The padded-block caller: views one cell into the block, so the
            # scalar layout.
            layout = kernels.face_layout(*kernels.face_views(Tp), Cm, out)
            if form == "regions":
                run, ref = regions(
                    lambda src, off, box, o: kernels.fused_step_cm_region(src, off, Cm, spacing,
                                                                          box, o),
                    lambda win, sl, o: kernels.fused_step_cm_plain(win, Cm[sl], inv_d2, out=o),
                    Tp, out)
            else:
                run, ref = (lambda: kernels.fused_step_cm(Tp, Cm, spacing, out=out),
                            lambda: kernels.fused_step_cm_plain(Tp, Cm, inv_d2))
            run.layout = "16-byte vectors" if layout else "scalar cells"
            return run, ref, nbytes
        # The face form as the sharded steps call it: the shard and the
        # exchange's contiguous faces; at a domain edge (a corner rank: no
        # face below on any axis) or on one rank (none at all) a face is None.
        T = Tp[tuple(slice(1, -1) for _ in core)].contiguous()
        faces = [f.clone(memory_format=torch.contiguous_format)
                 for f in kernels.face_views(Tp)[1]]
        if form == "faces-edge":
            faces[0::2] = [None] * len(core)
        elif form == "faces-null":
            faces = [None] * len(faces)
        faces = tuple(faces)
        layout = kernels.face_layout(T, faces, Cm, out)
        if form == "face-regions":
            bw = HIDE_B_WIDTH_3D if core == CUBE else HIDE_B_WIDTH
            boxes = region_boxes(core, effective_b_width(core, bw))
            none = (None,) * len(faces)

            def run():
                for box in boxes:
                    kernels.fused_step_cm_faces(T, none if ghost_free(box, core) else faces, Cm,
                                                spacing, box=box, out=out)
                return out

            def ref():
                res = torch.empty_like(out)
                for box in boxes:
                    kernels.fused_step_cm_faces_plain(
                        T, none if ghost_free(box, core) else faces, Cm, inv_d2, box=box,
                        out=res)
                return res
        else:
            def run():
                return kernels.fused_step_cm_faces(T, faces, Cm, spacing, out=out)

            def ref():
                return kernels.fused_step_cm_faces_plain(T, faces, Cm, inv_d2)
        run.layout = "16-byte vectors" if layout else "scalar cells"
        return run, ref, nbytes
    wcfg = WaveConfig(global_shape=domain, lengths=lengths, dtype=dtype)
    dt = float(torch.tensor(wcfg.dt, dtype=tdt))
    dt2 = dt * dt
    if name == "wave_step":
        Up, Uprev, C2 = rand(padded), rand(core), rand(core, 1.0, 0.5)
        out = torch.empty(core, dtype=tdt, device=device)
        return (lambda: wave.wave_step(Up, Uprev, C2, dt, spacing, out=out),
                lambda: wave.wave_step_plain(Up, Uprev, C2, dt2, inv_d2),
                (Up.numel() + 3 * cells) * item)
    M = wave.interior_mask(core, tdt, device)
    if name == "wave_step_masked":
        Up, Uprev = rand(padded), rand(core)
        Cw = (dt2 * rand(core, 1.0, 0.5)) * M
        out = torch.empty(core, dtype=tdt, device=device)
        nbytes = (Up.numel() + 4 * cells) * item
        if form == "regions":
            run, ref = regions(
                lambda src, off, box, o: wave.wave_step_masked_region(src, off, Uprev, M, Cw,
                                                                      spacing, box, o),
                lambda win, sl, o: wave.wave_step_masked_plain(win, Uprev[sl], M[sl], Cw[sl],
                                                               inv_d2, out=o),
                Up, out)
            return run, ref, nbytes
        return (lambda: wave.wave_step_masked(Up, Uprev, M, Cw, spacing, out=out),
                lambda: wave.wave_step_masked_plain(Up, Uprev, M, Cw, inv_d2), nbytes)
    # wave_multi_step: on the deep block the off-domain ring is held
    # (padded_hold_mask of a one-rank grid), on the field its edge.
    if core == WAVE_DEEP_SMALL:
        from rocm_mpi_tpu_torch.parallel.deep_halo import padded_hold_mask
        from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

        k = (core[0] - SMALL[0]) // 2
        hold = padded_hold_mask(core, GlobalGrid(SMALL, lengths, (1, 1)), k, device=device)
        M = torch.where(hold, torch.zeros_like(M), torch.ones_like(M))
    U, Uprev = rand(core), rand(core)
    Cw = (dt2 * rand(core, 1.0, 0.5)) * M
    outs = (torch.empty_like(U), torch.empty_like(U))
    check(wave.wave_multi_step_form(steps, inv_d2) == form,
          f"{name} {core}: the JAX rule picks {wave.wave_multi_step_form(steps, inv_d2)}, "
          f"not {form}")
    return (lambda: wave.leapfrog_multi_step(U, Uprev, M, Cw, inv_d2, steps, form, out=outs),
            lambda: wave.wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, steps, form),
            6 * cells * item)


def _swe_kernel_case(torch, name, core, steps, form, dtype, device):
    """_kernel_case for the shallow-water kernels: random state leaves (h
    in [0, 1), velocities in [-0.5, 0.5)), the face masks the path gives
    the block — the domain's walls for a one-GPU field, the padded face
    masks of a one-rank grid for the deep block — and cH, cg from the
    domain's dt. Results are flat tuples (h, u0, …)."""
    from rocm_mpi_tpu_torch.config import SWEConfig
    from rocm_mpi_tpu_torch.ops import kernels, swe
    from rocm_mpi_tpu_torch.parallel.deep_halo import padded_face_mask
    from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, ghost_free, region_boxes

    nd = len(core)
    deep = core == SWE_DEEP_PADDED
    domain = SWE_DEEP_SMALL if deep else BIG if core == BLOCK else core
    lengths = (10.0,) * nd
    cfg = SWEConfig(global_shape=domain, lengths=lengths, dtype=dtype)
    tdt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(SEED)
    cH, cg = swe.swe_coeffs(cfg.dt, cfg.spacing, cfg.H0, cfg.g)

    def rand(shape, lo=0.0):
        return (torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
                + lo).to(tdt)

    # The masks' grid: the deep block's one-rank domain, else the block
    # itself (for the 6144² block, a rank at the domain's high corner).
    grid = GlobalGrid(domain if deep else core, lengths, (1,) * nd)
    width = (core[0] - domain[0]) // 2 if deep else 0
    Mus = tuple(padded_face_mask(core, grid, a, width, tdt, device=device) for a in range(nd))
    item = torch.empty((), dtype=tdt).element_size()
    cells = 1
    for n in core:
        cells *= n
    if name == "swe_multi_step":
        h = rand(core)
        us = tuple(rand(core, -0.5) * M for M in Mus)
        outs = tuple(torch.empty_like(h) for _ in range(nd + 1))

        def run():
            got = swe.fb_multi_step(h, us, Mus, cH, cg, steps, out=outs)
            return (got[0], *got[1])

        def plain():
            got = swe.swe_multi_step_plain(h, us, Mus, cH, cg, steps)
            return (got[0], *got[1])

        return run, plain, (3 * nd + 2) * cells * item
    padded = tuple(n + 2 for n in core)
    Sp = (rand(padded),) + tuple(rand(padded, -0.5) for _ in range(nd))
    out = tuple(torch.empty(core, dtype=tdt, device=device) for _ in Sp)
    nbytes = ((nd + 1) * Sp[0].numel() + (2 * nd + 1) * cells) * item
    if form == "regions":
        raw = tuple(t[tuple(slice(1, -1) for _ in core)].contiguous() for t in Sp)
        boxes = region_boxes(core, effective_b_width(core, HIDE_B_WIDTH))

        def run():
            for box in boxes:
                inner = ghost_free(box, core)
                swe.swe_step_region(raw if inner else Sp, 0 if inner else 1, box, Mus,
                                    (cH, cg), out)
            return out

        def plain():
            res = tuple(torch.empty_like(o) for o in out)
            for box in boxes:
                window, sl = kernels.region_slices(box, 1)
                swe.swe_step_plain(tuple(t[window] for t in Sp), tuple(M[sl] for M in Mus),
                                   cH, cg, out=tuple(r[sl] for r in res))
            return res

        return run, plain, nbytes
    return (lambda: swe.swe_step(Sp, Mus, (cfg.H0, cfg.g), cfg.dt, cfg.spacing, out=out),
            lambda: swe.swe_step_plain(Sp, Mus, cH, cg), nbytes)


def _kp_kernel_case(torch, name, core, form, dtype, device):
    """_kernel_case for the kp kernels and fused_step_padded: Tp in [0, 1),
    Cp in [1, 2), the residual's fluxes those the plain flux makes of Tp,
    the update's dTdt in [-0.5, 0.5), λ and the field-dtype dt of the
    domain's config (the 6144² block's domain is 12288²). The update also
    returns its one-call PyTorch form, `torch.add(core, dTdt, alpha=dt)`.
    Form "offset" puts Tp and qx (kp_flux), qx and Cp (kp_residual) or Tp
    and Cp (fused_step_padded) one element past an allocation's start, off
    the 16-byte grid; kp_flux's, kp_residual's and fused_step_padded's
    launches carry their layout (`run.layout`)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.ops import kernels, kp

    domain = BIG if core in (BLOCK, KP_ODD) else core
    cfg = DiffusionConfig(global_shape=domain, lengths=(10.0,) * len(core), dtype=dtype)
    tdt = cfg.torch_dtype
    lam, dt, spacing = cfg.lam, float(torch.tensor(cfg.dt, dtype=tdt)), cfg.spacing
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(shape, lo=0.0):
        return (torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
                + lo).to(tdt)

    def shifted(t):  # the same values one element past an allocation's start
        return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)

    item = torch.empty((), dtype=tdt).element_size()
    cells = 1
    for n in core:
        cells *= n
    Tp = rand(tuple(n + 2 for n in core))
    if form == "offset":
        Tp = shifted(Tp)
    out = torch.empty(core, dtype=tdt, device=device)
    if name == "fused_step_padded":
        Cp = rand(core, 1.0)
        if form == "offset":
            Cp = shifted(Cp)

        def run():
            return kernels.fused_step_padded(Tp, Cp, lam, dt, spacing, out=out)

        run.layout = kernels.padded_layout(Tp, Cp, out)
        return (run, lambda: kernels.fused_step_padded_plain(Tp, Cp, lam, dt,
                                                             kernels.inv_d2_of(spacing)),
                (Tp.numel() + 2 * cells) * item)
    inv_d = kp.inv_d_of(spacing)
    lx, ly = core
    if name == "kp_flux":
        outs = (torch.empty((lx + 1, ly), dtype=tdt, device=device),
                torch.empty((lx, ly + 1), dtype=tdt, device=device))
        if form == "offset":
            outs = (shifted(outs[0]), outs[1])

        def run():
            return kp.kp_flux(Tp, lam, spacing, out=outs)

        run.layout = kp.flux_layout(Tp, outs[0])
        return (run, lambda: kp.kp_flux_plain(Tp, lam, inv_d),
                (Tp.numel() + outs[0].numel() + outs[1].numel()) * item)
    if name == "kp_residual":
        qx, qy = kp.kp_flux_plain(Tp, lam, inv_d)
        Cp = rand(core, 1.0)
        if form == "offset":
            qx, Cp = shifted(qx), shifted(Cp)

        def run():
            return kp.kp_residual(qx, qy, Cp, spacing, out=out)

        run.layout = kp.residual_layout(qx, Cp, out)
        return (run, lambda: kp.kp_residual_plain(qx, qy, Cp, inv_d),
                (qx.numel() + qy.numel() + 2 * cells) * item)
    dTdt = rand(core, -0.5)
    core_view = Tp[1:-1, 1:-1]
    return (lambda: kp.kp_update(Tp, dTdt, dt, out=out),
            lambda: kp.kp_update_plain(Tp, dTdt, dt), (Tp.numel() + 2 * cells) * item,
            lambda: torch.add(core_view, dTdt, alpha=dt, out=out))


def _same(got, want) -> tuple[bool, float]:
    """(bitwise equal, max |difference|) of two tensors or two tuples of them."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    return equal, err


TORCH_DTYPE_NAMES = ("float32", "float64", "bfloat16")


def _tdt(torch, dtype: str):
    return getattr(torch, TORCH_DTYPE_NAMES[ALL_DTYPES.index(dtype)])


def resident_plan(torch, name, core, dtype, form):
    """The route the wrapper of multi-step kernel `name` takes for this
    block on card 0 (ops/resident.py), and the caps it was planned with."""
    from rocm_mpi_tpu_torch.ops import multistep, swe, wave

    tdt = _tdt(torch, dtype)
    if name == "multi_step_cm":
        return (multistep.device_plan(0, tuple(core), tdt, form),
                multistep.device_caps(0, tdt, len(core), form))
    if name == "wave_multi_step":
        return (wave.device_plan(0, tuple(core), tdt, form),
                wave.device_caps(0, tdt, len(core), form))
    return swe.device_plan(0, tuple(core), tdt), swe.device_caps(0, tdt, len(core))


def resident_edge_cases(torch):
    """Kernel cases at the multi-step kernels' capacity edges on this card,
    per dtype: the widest block of EDGE_ROWS rows that one cluster holds,
    and one column more, which takes the cooperative route. Returns the
    cases and {(kernel, block, dtype): the route each must take}."""
    from rocm_mpi_tpu_torch.ops import multistep, resident, swe, wave

    cases, routes = [], {}
    for name, n0 in EDGE_ROWS.items():
        form = {"multi_step_cm": "eqc", "wave_multi_step": "aform"}.get(name, "direct")
        for dtype in ALL_DTYPES:
            tdt = _tdt(torch, dtype)
            if name == "multi_step_cm":
                caps, kind = multistep.device_caps(0, tdt, 2, form), "diffusion"
            elif name == "wave_multi_step":
                caps, kind = wave.device_caps(0, tdt, 2, form), "wave"
            else:
                caps, kind = swe.device_caps(0, tdt, 2), "swe"
            edge = resident.edge_shape(kind, n0, tdt, caps)
            for core, route in ((edge, "cluster"), ((n0, edge[1] + 1), "cooperative")):
                cases.append((name, core, 8, form, (dtype,)))
                routes[(name, core, dtype)] = route
    return cases, routes


def phase_kernels(torch, card, pk):
    """Every kernel case: bitwise against its plain version on the card,
    then timed beside it and its bound."""
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.ops.kernels import LAYOUT_NAMES

    device = torch.device("cuda", 0)
    rows = []
    edges, edge_routes = resident_edge_cases(torch)
    # The layouts that kp_flux's, kp_residual's and fused_step_padded's
    # launches reported: the cases must reach every one.
    layouts_seen = {"kp_flux": set(), "kp_residual": set(), "fused_step_padded": set()}
    for name, core, steps, form, dtypes in KERNEL_CASES + edges:
        for dtype in dtypes:
            run, plain, nbytes, *library = _kernel_case(torch, name, core, steps, form, dtype,
                                                        device)
            got = run()
            want = plain()
            torch.cuda.synchronize()
            equal, err = _same(got, want)
            label = f"{name} {'x'.join(map(str, core))} {dtype}" + (
                f" n={steps} {form}" if steps > 1 else f" {form}" if form != "direct" else "")
            check(equal, f"{label}: kernel != plain version (max |diff| {err})")
            small = core in (SMALL, DEEP_SMALL, WAVE_DEEP_SMALL, SMALL_3D, SWE_DEEP_PADDED,
                             SWE_F64, SWE_3D, KP_SMALL, KP_SMALL_ODD, TB_RAGGED, RAGGED)
            reps = (200 if steps == 1 else 50) if small else (30 if steps == 1 else 20)
            ms = time_ms(run, reps)
            plain_ms = time_ms(plain, max(reps // 4, 5) if steps == 1 else 5)
            cells = 1
            for n in core:
                cells *= n
            b_ms, by, flops = bound_ms(pk, dtype, nbytes, cells, steps,
                                       FLOPS_PER_CELL_STEP[(name, form)](len(core)))
            row = dict(kernel=name, shape=list(core), dtype=dtype, steps=steps, form=form,
                       bitwise=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=by, bytes=nbytes, flops=flops,
                       fraction_of_bound=b_ms / ms, library_ms=None)
            if library:
                # One PyTorch call for the same function: timed as a yardstick,
                # held close to the plain version (it may contract a
                # multiply-add), never called by the port.
                lib_err = _same(library[0](), want)[1]
                scale = float(want.double().abs().max())
                check(lib_err <= 4 * torch.finfo(want.dtype).eps * max(1.0, scale),
                      f"{label}: the library call differs from the plain version by {lib_err}")
                row["library_ms"] = time_ms(library[0], reps)
                row["library_max_abs_err"] = lib_err
                lib = (f"library call {row['library_ms']:.4f} ms (max |diff| vs plain "
                       f"{lib_err:.3e})")
            else:
                lib = "no single PyTorch call computes this step, library_ms null"
            extra = ""
            if name == "kp_update" or (name == "masked_step" and core == SMALL):
                row["host_us_per_call"] = host_us(run)
                extra = f"; wrapper host time {row['host_us_per_call']:.2f} µs a call"
            if name in ("masked_step", "fused_step_cm", "kp_flux", "kp_residual",
                        "fused_step_padded"):
                row["layout"] = run.layout
                extra = f"; layout {run.layout}" + extra
            if name in layouts_seen:
                layouts_seen[name].add(run.layout)
            if name == "fused_step_cm":
                # The launches a call makes, and those of them that took the
                # f64 route: every one in f64, none in f32 or bf16.
                made, routed = kernels.LAUNCHES[name], kernels.F64_ROUTE_LAUNCHES
                run()
                made = kernels.LAUNCHES[name] - made
                routed = kernels.F64_ROUTE_LAUNCHES - routed
                check(routed == (made if dtype == "f64" else 0),
                      f"{label}: {routed} of {made} launches a call took the f64 route")
                row["f64_route_launches"] = routed
                extra += f"; f64 route {routed} of {made} launches a call"
                # Many launches: the device time of one queued behind the
                # card's sleep, and of FUSED_LOOP of them between two events
                # (a 3D shard's launch is too short for one pair of events).
                row["host_us_per_call"] = host_us(run)
                row["device_ms"] = device_ms(run, reps, row["host_us_per_call"])
                row["loop_ms"] = loop_ms(run, FUSED_LOOP, row["host_us_per_call"])
                extra += (f"; device {row['device_ms']:.4f} ms a launch, {FUSED_LOOP} queued "
                          f"{row['loop_ms']:.4f} ms a launch ({b_ms / row['loop_ms']:.3f} of "
                          f"bound), wrapper host {row['host_us_per_call']:.2f} µs a call")
            if name in EDGE_ROWS:
                # The route, decided by size before the launch; then the
                # per-call figure split into the wrapper's host time and the
                # launch's device time.
                plan, caps = resident_plan(torch, name, core, dtype, form)
                want = edge_routes.get((name, tuple(core), dtype))
                check(want in (None, plan.route),
                      f"{label}: route {plan.route} at the capacity edge, not {want}")
                if tuple(core) in RESIDENT_MAIN[name] or (
                        dtype == "f32" and tuple(core) in RESIDENT_MAIN_F32.get(name, ())):
                    check(plan.route == "cluster" and plan.cluster == min(caps.cluster, core[0]),
                          f"{label}: a main-path block takes the {plan.route} route with "
                          f"{plan.cluster} CTAs (the card grants {caps.cluster})")
                row.update(route=plan.route, cluster=plan.cluster, smem_bytes=plan.nbytes,
                           staged=plan.stage, registers=plan.registers)
                row["host_us_per_call"] = host_us(run)
                row["device_ms"] = device_ms(run, reps, row["host_us_per_call"])
                where = (f"cluster of {plan.cluster} CTAs, {plan.nbytes} B shared a CTA"
                         f"{', operands staged' if plan.stage else ''}"
                         f"{', Cm in registers' if plan.registers else ''}"
                         if plan.route == "cluster" else "cooperative (state in L2)")
                extra = (f"; route {where}; device {row['device_ms']:.4f} ms a launch, wrapper "
                         f"host {row['host_us_per_call']:.2f} µs a call")
            if name == "tb_sweep" and len(core) == 2:
                from rocm_mpi_tpu_torch.ops import multistep

                plan = multistep._device_plan(0, tuple(core), steps, _tdt(torch, dtype))
                row["plan"] = plan._asdict()
                extra = (f"; plan {plan.strips} strips × {plan.segments} segments of "
                         f"{plan.seg_rows} rows, {plan.waves} wave(s)")
            if name == "tb_sweep" and len(core) == 3:
                from rocm_mpi_tpu_torch.ops import multistep

                plan = multistep._device_plan3(0, tuple(core), steps, _tdt(torch, dtype))
                updates = multistep.tb3_updates(plan, core)
                row.update(plan=plan._asdict(), cell_updates=updates,
                           updates_per_core_update=updates / (cells * steps),
                           updates_per_s=updates / (ms * 1e-3))
                extra = (f"; plan tile {plan.e1}x{plan.e2} ({plan.e1 - 2 * steps}x"
                         f"{plan.e2 - 2 * steps} core) × {plan.tiles1 * plan.tiles2} tiles × "
                         f"{plan.segments} segments of {plan.seg} planes, {plan.threads} threads, "
                         f"{plan.smem} B shared, {plan.blocks_per_sm} block(s) an SM, "
                         f"{plan.waves} wave(s); {updates} cell updates a launch "
                         f"({row['updates_per_core_update']:.2f} per core cell and step, "
                         f"{row['updates_per_s'] / 1e9:.1f} G a second)")
            rows.append(row)
            print(f"[kernel] {label}: bitwise == plain; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({by}; "
                  f"{row['fraction_of_bound']:.3f} of bound) on {card}; {lib}{extra}",
                  flush=True)
            del run, plain, got, want, library
        torch.cuda.empty_cache()
    for name, seen in layouts_seen.items():
        check(seen == set(LAYOUT_NAMES), f"{name}: the cases reached the layouts {seen}, "
              f"not every one of {LAYOUT_NAMES}")
    return rows


def _single_gpu_run(torch, shape, card):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = DiffusionConfig(global_shape=shape, nt=BIG_NT if shape == BIG else MAIN_NT,
                          warmup=MAIN_WARMUP, dtype="f32", dims=(1, 1))
    grid = init_global_grid(*shape, dims=(1, 1), nprocs=1, rank=0)
    model = HeatDiffusion(cfg, grid=grid, device="cuda")

    kernels.reset_launches()
    res = model.run("perf")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    check(launches == only("masked_step", cfg.nt),
          f"perf {shape}: launches {launches}, expected {cfg.nt} masked_step")
    check(tuple(res.T.shape) == shape and bool(torch.isfinite(res.T).all()),
          f"perf {shape}: result not finite or misshapen")
    # The same steps through the plain version, on the card.
    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    for _ in range(cfg.nt):
        T = kernels.masked_step_plain(T, Cm, inv_d2)
    check(torch.equal(res.T, T), f"perf {shape}: kernel run != plain-version run")
    print(f"[main] perf {shape[0]}x{shape[1]} f32, {cfg.nt} steps ({cfg.warmup} warmup): "
          f"{res.wtime:.4f} s, {res.wtime_it * 1e3:.5f} ms/step, T_eff {res.t_eff:.1f} GB/s, "
          f"{res.gpts:.3f} Gpts/s on {card}; masked_step launches {launches['masked_step']}; "
          "bitwise == plain-version run", flush=True)
    return model, res, launches


def phase_main(torch, card):
    from rocm_mpi_tpu_torch.ops.diffusion import analytic_solution

    _, big, big_launches = _single_gpu_run(torch, BIG, card)
    big_row = dict(shape=list(BIG), wtime_s=big.wtime, ms_per_step=big.wtime_it * 1e3,
                   t_eff_gbs=big.t_eff, gpts=big.gpts, launches=big_launches)
    del big
    torch.cuda.empty_cache()
    model, small, small_launches = _single_gpu_run(torch, SMALL, card)
    cfg = model.config
    coords = model.grid.coord_mesh(dtype=torch.float64, device=small.T.device)
    exact = analytic_solution(coords, cfg.lengths, cfg.lam / cfg.cp0, cfg.nt * cfg.dt)
    rel = float((small.T.double() - exact).abs().max() / exact.max())
    check(rel < 2e-3, f"perf 252x252: relative error vs analytic Gaussian {rel}")
    print(f"[main] perf 252x252: relative max error vs the analytic Gaussian {rel:.3e} "
          "(bound 2e-3); at 762 KB a step this size is launch-bound", flush=True)
    small_row = dict(shape=list(SMALL), wtime_s=small.wtime, ms_per_step=small.wtime_it * 1e3,
                     t_eff_gbs=small.t_eff, gpts=small.gpts, launches=small_launches,
                     analytic_rel_err=rel)
    return big_row, small_row


# ---------------------------------------------------------------------------
# The kp rung
# ---------------------------------------------------------------------------


def kp_only(count: int) -> dict:
    """The launch counts of a run of `count` kp steps: one launch of each kp
    kernel a step, no other kernel."""
    from rocm_mpi_tpu_torch.ops import kernels

    return {name: count if name in KP else 0 for name in kernels.LAUNCHES}


def _kp_model(shape, nt, warmup, dtype):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = DiffusionConfig(global_shape=shape, nt=nt, warmup=warmup, dtype=dtype, dims=(1, 1))
    return HeatDiffusion(cfg, grid=init_global_grid(*shape, dims=(1, 1), nprocs=1, rank=0),
                         device="cuda")


def plain_kp_steps(model, T, Cp, n: int):
    """`n` kp steps through the plain versions on the card: the same
    exchange, the three plain stages, the same Dirichlet select."""
    import torch

    from rocm_mpi_tpu_torch.ops import kp
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo, global_boundary_mask

    cfg, grid = model.config, model.grid
    inv_d = kp.inv_d_of(cfg.spacing)
    mask = global_boundary_mask(grid, device=T.device)
    pad = torch.zeros(tuple(s + 2 for s in T.shape), dtype=T.dtype, device=T.device)
    for _ in range(n):
        Tp = exchange_halo(T, grid, out=pad)
        qx, qy = kp.kp_flux_plain(Tp, cfg.lam, inv_d)
        new = kp.kp_update_plain(Tp, kp.kp_residual_plain(qx, qy, Cp, inv_d), model.dt_value)
        T = torch.where(mask, T, new)
    return T


def _kp_parts(torch, model, T, Cp):
    """One kp step's device passes timed alone: the copy into the padded
    buffer, the three kernels and the Dirichlet select."""
    from rocm_mpi_tpu_torch.ops import kp
    from rocm_mpi_tpu_torch.parallel.halo import global_boundary_mask, place_core

    cfg = model.config
    sp, lam, dt = cfg.spacing, cfg.lam, model.dt_value
    pad = place_core(T)
    qx, qy = kp.kp_flux(pad, lam, sp)
    dTdt = kp.kp_residual(qx, qy, Cp, sp)
    new = kp.kp_update(pad, dTdt, dt)
    mask = global_boundary_mask(model.grid, device=T.device)
    out = torch.empty_like(T)
    return dict(
        place_core=time_ms(lambda: place_core(T, out=pad), 30),
        kp_flux=time_ms(lambda: kp.kp_flux(pad, lam, sp, out=(qx, qy)), 30),
        kp_residual=time_ms(lambda: kp.kp_residual(qx, qy, Cp, sp, out=dTdt), 30),
        kp_update=time_ms(lambda: kp.kp_update(pad, dTdt, dt, out=new), 30),
        where=time_ms(lambda: torch.where(mask, T, new, out=out), 30),
    )


def phase_kp(torch, card):
    """The kp variant on one GPU through HeatDiffusion.run: 12288² f32 (one
    launch of each kp kernel a step, the field bitwise equal to the plain
    versions' run, the step's parts timed alone) and the app's default,
    128² f64, held against run("ap") within the JAX package's kp-vs-ap
    bound."""
    from rocm_mpi_tpu_torch.ops import kernels

    rows = []
    for shape, dtype in ((BIG, "f32"), (KP_SMALL, "f64")):
        nt = BIG_NT if shape == BIG else MAIN_NT
        model = _kp_model(shape, nt, MAIN_WARMUP, dtype)
        kernels.reset_launches()
        res = model.run("kp")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        label = f"kp {shape[0]}x{shape[1]} {dtype}"
        check(launches == kp_only(nt),
              f"{label}: launches {launches}, expected {nt} of each kp kernel")
        check(tuple(res.T.shape) == shape and bool(torch.isfinite(res.T).all()),
              f"{label}: result not finite or misshapen")
        T, Cp = model.init_state()
        ref = plain_kp_steps(model, T, Cp, nt)
        check(torch.equal(res.T, ref), f"{label}: kernel run != plain-version run "
              f"(max |diff| {float((res.T.double() - ref.double()).abs().max())})")
        row = dict(shape=list(shape), dtype=dtype, nt=nt, warmup=MAIN_WARMUP,
                   launches=launches, wtime_s=res.wtime, ms_per_step=res.wtime_it * 1e3,
                   t_eff_gbs=res.t_eff, gpts=res.gpts)
        extra = ""
        if shape == BIG:
            row["parts_ms"] = _kp_parts(torch, model, T, Cp)
            extra = "; alone (ms): " + ", ".join(f"{k} {v:.4f}"
                                                for k, v in row["parts_ms"].items())
        else:
            ap = model.run("ap").T
            err = float((res.T - ap).abs().max())
            check(torch.allclose(res.T, ap, rtol=1e-13, atol=1e-15),
                  f"{label}: kp differs from ap by {err} (bound rtol 1e-13, atol 1e-15)")
            row["max_abs_vs_ap"] = err
            extra = f"; max |kp - ap| {err:.3e} (bound rtol 1e-13, atol 1e-15)"
        rows.append(row)
        print(f"[kp] {label}, {nt} steps ({MAIN_WARMUP} warmup): launches "
              f"{', '.join(f'{k} {launches[k]}' for k in KP)}; bitwise == plain-version run; "
              f"{res.wtime:.4f} s, {row['ms_per_step']:.5f} ms/step, T_eff {res.t_eff:.1f} "
              f"GB/s (3 passes per step counted), {res.gpts:.3f} Gpts/s on {card}{extra}",
              flush=True)
        del model, res, ref, T, Cp
        torch.cuda.empty_cache()
    return rows


def whole_domain_fused_step_cm(torch, shape, lengths, nt: int, device):
    """(the field after nt fused_step_cm steps over the whole zero-padded
    domain on one GPU, as numpy; its one-rank model). Every cell sees the
    neighbours a sharded perf run gives it, in the same order, so the
    gathered sharded field must match it bit for bit: a check of the
    exchange itself."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.halo import place_core
    from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

    one = DiffusionConfig(global_shape=shape, lengths=lengths, dtype="f32", dims=(1, 1))
    ref = HeatDiffusion(one, grid=GlobalGrid(shape, one.lengths, (1, 1)), device=device)
    T, Cp = ref.init_state()
    Cm = ref.prepare_fn("perf")(Cp)
    pad = torch.zeros(tuple(n + 2 for n in shape), dtype=T.dtype, device=device)
    for _ in range(nt):
        T = kernels.fused_step_cm(place_core(T, out=pad), Cm, one.spacing)
    return T.cpu().numpy(), ref


def register_padded_variants(model, names=("perf-padded", "hide-padded")):
    """Register, under `names`, a sharded HeatDiffusion's perf and hide
    steps over the padded route the face exchange replaced: exchange_halo
    (the shard copied into a padded buffer, then a batch an axis) and
    fused_step_cm on the block, or the hide boxes from it. Each step keeps
    its own padded buffer (made at its first call, before any capture), as
    the model's advance kept one for it. The yardstick of the face route's
    ms/step, run beside it in the same call; never a model path."""
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
    from rocm_mpi_tpu_torch.parallel.overlap import make_overlap_step

    cfg, grid = model.config, model.grid
    prepare = model.prepare_fn("perf")
    pads = {}

    def pad_of(T):
        key = (T.shape, T.dtype, T.device)
        if key not in pads:
            pads[key] = torch_zeros_padded(T)
        return pads[key]

    def perf(T, Cm, out=None, pad=None):
        Tp = exchange_halo(T, grid, out=pad_of(T), wire_mode=cfg.wire_mode)
        return kernels.fused_step_cm(Tp, Cm, cfg.spacing, out=out)

    def region_update(src, offset, box, Cm, out):
        kernels.fused_step_cm_region(src, offset, Cm, cfg.spacing, box, out)

    local = make_overlap_step(grid, region_update, cfg.b_width, wire_mode=cfg.wire_mode,
                              device=model.device)

    def hide(T, Cm, out=None, pad=None):
        return local(T, Cm, out=out, pad=pad_of(T))

    model.register_variant(names[0], perf, prepare)
    model.register_variant(names[1], hide, prepare)


def torch_zeros_padded(T):
    """A zero buffer of T grown by one cell on every axis."""
    import torch

    return torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=T.device)


@contextlib.contextmanager
def padded_route():
    """Within: every sharded HeatDiffusion built runs its perf and hide
    steps over the padded route (register_padded_variants under their own
    names), so an app's ladder can be timed on it beside the face route."""
    from rocm_mpi_tpu_torch.models import diffusion

    init = diffusion.HeatDiffusion.__init__

    def patched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if self.grid.nprocs > 1:
            register_padded_variants(self, names=("perf", "hide"))

    diffusion.HeatDiffusion.__init__ = patched
    try:
        yield
    finally:
        diffusion.HeatDiffusion.__init__ = init


def sharded_rank(rank, spec):
    """One rank of the sharded perf path (started by spawn_ranks)."""
    import numpy as np
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    import torch.distributed as dist

    # One card: every rank on cuda:0 (gloo). Several cards: rank r on
    # cuda:r, NCCL sending device to device.
    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape = tuple(spec["shape"])
    cfg = DiffusionConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"],
                          dtype="f32", dims=(2, 2))
    model = HeatDiffusion(cfg, device=device)

    kernels.reset_launches()
    res = model.run("perf")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # The same steps over the padded route the face exchange replaced: the
    # same field bit for bit, its ms/step beside (its launches not counted).
    register_padded_variants(model)
    pres = model.run("perf-padded")
    torch.cuda.synchronize()
    padded = dict(bitwise=bool(torch.equal(pres.T, res.T)), ms_per_step=pres.wtime_it * 1e3)
    del pres

    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    pad = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=device)
    for _ in range(cfg.nt):
        T = kernels.fused_step_cm_plain(exchange_halo(T, model.grid, out=pad), Cm, inv_d2)
    out = dict(rank=rank, launches=launches, bitwise=bool(torch.equal(res.T, T)),
               finite=bool(torch.isfinite(res.T).all()), wtime_s=res.wtime,
               t_eff_gbs=res.t_eff, padded=padded)
    full = gather_to_host0(res.T, model.grid)
    if rank == 0:
        Tr, ref = whole_domain_fused_step_cm(torch, shape, cfg.lengths, cfg.nt, device)
        out["max_abs_vs_one_gpu"] = float(np.abs(full - Tr).max())
        out["bitwise_vs_one_gpu"] = bool(np.array_equal(full, Tr))
        del Tr

    # The scan driver on the same grid, the same steps, so the field is
    # bitwise the step driver's: CUDA graphs over NCCL, the eager loop
    # over gloo.
    kernels.reset_launches()
    sres = model.run("perf", driver="scan")
    torch.cuda.synchronize()
    out["scan"] = dict(route=sres.route, k=sres.k, launches=dict(kernels.LAUNCHES),
                       bitwise=bool(torch.equal(sres.T, res.T)),
                       ms_per_step=sres.wtime_it * 1e3)
    del sres

    # The kp variant on the same grid, against its plain-version run and,
    # gathered, against the one-GPU kp run: every face flux takes the same
    # two cells in the same order, ghost or not.
    kernels.reset_launches()
    kres = model.run("kp")
    torch.cuda.synchronize()
    klaunches = dict(kernels.LAUNCHES)
    T, Cp = model.init_state()
    kref = plain_kp_steps(model, T, Cp, cfg.nt)
    out["kp"] = dict(launches=klaunches, bitwise=bool(torch.equal(kres.T, kref)),
                     finite=bool(torch.isfinite(kres.T).all()), wtime_s=kres.wtime,
                     ms_per_step=kres.wtime_it * 1e3, t_eff_gbs=kres.t_eff)
    del kref
    kfull = gather_to_host0(kres.T, model.grid)
    if rank == 0:
        T1, Cp1 = ref.init_state()
        T1 = ref.advance_fn("kp")(T1, Cp1, cfg.nt).cpu().numpy()
        out["kp"]["max_abs_vs_one_gpu"] = float(np.abs(kfull - T1).max())
        out["kp"]["bitwise_vs_one_gpu"] = bool(np.array_equal(kfull, T1))
    return out


def phase_sharded(card, gpus: int):
    """The 2×2 perf path on 4 ranks: sharing one card over gloo, or one
    rank per card over NCCL when `gpus` is 4."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup = (SHARD_NT, SHARD_WARMUP) if gpus == 1 else (BIG_NT, MAIN_WARMUP)
    spec = dict(shape=BIG, nt=nt, warmup=warmup, gpus=gpus)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, sharded_rank, (spec,), backend=backend, timeout=600)
    for r in ranks:
        check(r["launches"] == only("fused_step_cm", nt),
              f"sharded rank {r['rank']}: launches {r['launches']}, expected "
              f"{nt} fused_step_cm")
        check(r["bitwise"] and r["finite"],
              f"sharded rank {r['rank']}: kernel run != plain-version run or not finite")
        check(r["padded"]["bitwise"],
              f"sharded rank {r['rank']}: the face route != the padded route")
    check(ranks[0]["bitwise_vs_one_gpu"],
          f"sharded 2x2 field differs from the whole-domain run of the same kernel by "
          f"{ranks[0]['max_abs_vs_one_gpu']}")
    for r in ranks:
        check(r["kp"]["launches"] == kp_only(nt),
              f"sharded kp rank {r['rank']}: launches {r['kp']['launches']}, expected {nt} "
              "of each kp kernel")
        check(r["kp"]["bitwise"] and r["kp"]["finite"],
              f"sharded kp rank {r['rank']}: kernel run != plain-version run or not finite")
    check(ranks[0]["kp"]["bitwise_vs_one_gpu"],
          f"sharded 2x2 kp field differs from the one-GPU kp run by "
          f"{ranks[0]['kp']['max_abs_vs_one_gpu']}")
    scan_route = "scan-loop" if gpus == 1 else "scan-graph"
    for r in ranks:
        sc = r["scan"]
        check(sc["route"] == scan_route and sc["bitwise"]
              and sc["launches"] == only("fused_step_cm", nt),
              f"sharded scan rank {r['rank']}: route {sc['route']}, launches "
              f"{sc['launches']}, bitwise == step {sc['bitwise']}")
    total = sum(r["launches"]["fused_step_cm"] for r in ranks)
    kp_total = sum(r["kp"]["launches"]["kp_flux"] for r in ranks)
    r0 = ranks[0]
    where = (f"4 ranks sharing {card} (gloo, halo slabs staged through host memory: "
             "not a multi-GPU measurement)" if gpus == 1
             else f"4 GPUs, one rank each, NCCL ({card} each)")
    print(f"[sharded] perf 12288x12288 f32 on a 2x2 grid, {where}, {nt} steps "
          f"({warmup} warmup): the face exchange (one batch a step) and fused_step_cm from "
          f"the shard and its faces, launches {total} ({nt} per rank); each "
          "shard bitwise == plain-version run and == the padded route's (exchange_halo + "
          "fused_step_cm on the block); gathered field bitwise == the whole-domain "
          f"run of the same kernel on one GPU; rank 0: {r0['wtime_s']:.4f} s, "
          f"{r0['wtime_s'] / (nt - warmup) * 1e3:.5f} ms/step (padded route "
          f"{r0['padded']['ms_per_step']:.5f}), aggregate T_eff "
          f"{r0['t_eff_gbs']:.1f} GB/s", flush=True)
    print(f"[sharded] perf driver=\"scan\" on the same grid: route {r0['scan']['route']}, "
          f"q {r0['scan']['k']}, fused_step_cm launches {nt} per rank; each shard bitwise == "
          f"the step driver's; rank 0 {r0['scan']['ms_per_step']:.5f} ms/step (step driver "
          f"{r0['wtime_s'] / (nt - warmup) * 1e3:.5f})", flush=True)
    print(f"[sharded] kp 12288x12288 f32 on a 2x2 grid, {where}, {nt} steps ({warmup} "
          f"warmup): {kp_total} launches of each kp kernel ({nt} per rank); each shard "
          "bitwise == plain-version run; gathered field bitwise == the one-GPU kp run; rank "
          f"0: {r0['kp']['wtime_s']:.4f} s, {r0['kp']['ms_per_step']:.5f} ms/step, aggregate "
          f"T_eff {r0['kp']['t_eff_gbs']:.1f} GB/s", flush=True)
    return ranks, total, kp_total


@contextlib.contextmanager
def eager_scan_loop(name: str):
    """Within: `run(driver="scan")` of model `name` builds its ScanLoop on
    the route "scan-loop" (the chunks as an eager loop), the yardstick the
    graphs are held against."""
    import importlib

    module = importlib.import_module(f"rocm_mpi_tpu_torch.models.{name}")
    route = module.scan_route
    module.scan_route = lambda *args: "scan-loop"
    try:
        yield
    finally:
        module.scan_route = route


def sharded_scan_rank(rank, spec):
    """One rank of [sharded-scan]: each SHARDED_SCAN_RUNS case on the 2×2
    grid through the step driver, the scan driver (CUDA graphs over NCCL)
    and the scan driver's eager loop, each run's launch counts read just
    after it; then one more scan advance for its graphs and capture time."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    models = {"diffusion": (HeatDiffusion, DiffusionConfig),
              "wave": (AcousticWave, WaveConfig), "swe": (ShallowWater, SWEConfig)}
    out = dict(rank=rank)
    face_fields = {}  # the face route's step-driver fields, by variant
    for label, name, variant, mode in SHARDED_SCAN_RUNS:
        model_cls, cfg_cls = models[name]
        cfg = cfg_cls(global_shape=tuple(spec["shape"]), nt=spec["nt"], warmup=spec["warmup"],
                      dtype="f32", dims=(2, 2), b_width=HIDE_B_WIDTH, wire_mode=mode)
        model = model_cls(cfg, device=device)
        if name == "diffusion":
            register_padded_variants(model)
        runs = {}
        for driver in ("step", "scan", "scan-loop"):
            kernels.reset_launches()
            with eager_scan_loop(name) if driver == "scan-loop" else contextlib.nullcontext():
                res = model.run(variant, driver="step" if driver == "step" else "scan")
            torch.cuda.synchronize()
            runs[driver] = dict(launches=dict(kernels.LAUNCHES), route=res.route, k=res.k,
                                ms=res.wtime_it * 1e3, fields=_scan_fields(name, res))
            del res
        step = runs["step"]["fields"]
        loop = _scan_loop(torch, name, model, variant)
        if name == "diffusion" and mode == "f32" and variant in ("perf", "hide"):
            face_fields[variant] = step
        padded = variant.endswith("-padded")
        face = face_fields[variant.removesuffix("-padded")] if padded else step
        out[label] = dict(
            face_bitwise=all(torch.equal(a, b) for a, b in zip(step, face)),
            route=runs["scan"]["route"], loop_route=runs["scan-loop"]["route"],
            q=runs["scan"]["k"], c=loop.plan.c, graphs=len(loop.graphs),
            plan_graphs=loop.plan.graphs, capture_ms=loop.capture_s * 1e3,
            bitwise=all(torch.equal(a, b) for a, b in zip(step, runs["scan"]["fields"])),
            loop_bitwise=all(torch.equal(a, b)
                             for a, b in zip(step, runs["scan-loop"]["fields"])),
            finite=all(bool(torch.isfinite(f).all()) for f in runs["scan"]["fields"]),
            **{f"{d}_launches": runs[d]["launches"] for d in runs},
            **{f"{d}_ms": runs[d]["ms"] for d in runs})
        del loop, runs, step, model
        torch.cuda.empty_cache()
    return out


def phase_sharded_scan(card, gpus: int):
    """[sharded-scan] the scan driver on the 2×2 grid of 12288² over NCCL,
    one rank a card: every case replays CUDA graphs that hold the halo
    exchange, bitwise equal to the same rank's step-driver run, with the
    step driver's launch counts; ms/step beside the step driver's and the
    eager loop's, the graphs and each rank's capture host ms."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup = SHARDED_SCAN_NT, SHARDED_SCAN_WARMUP
    spec = dict(shape=BIG, nt=nt, warmup=warmup, gpus=gpus)
    ranks = spawn_ranks(4, sharded_scan_rank, (spec,), backend="nccl", timeout=600)
    totals: dict[str, int] = {}
    for label, *_ in SHARDED_SCAN_RUNS:
        for r in ranks:
            got = r[label]
            check(got["route"] == "scan-graph" and got["loop_route"] == "scan-loop",
                  f"[sharded-scan] {label} rank {r['rank']}: routes {got['route']}, "
                  f"{got['loop_route']}")
            check(got["bitwise"] and got["loop_bitwise"] and got["finite"]
                  and got["face_bitwise"],
                  f"[sharded-scan] {label} rank {r['rank']}: graph bitwise == step "
                  f"{got['bitwise']}, loop {got['loop_bitwise']}, finite {got['finite']}, "
                  f"padded route == face route {got['face_bitwise']}")
            check(got["scan_launches"] == got["step_launches"] == got["scan-loop_launches"]
                  and any(got["scan_launches"].values()),
                  f"[sharded-scan] {label} rank {r['rank']}: launches step "
                  f"{got['step_launches']}, graph {got['scan_launches']}, loop "
                  f"{got['scan-loop_launches']}")
            check(got["graphs"] == got["plan_graphs"],
                  f"[sharded-scan] {label} rank {r['rank']}: {got['graphs']} graphs, plan "
                  f"{got['plan_graphs']}")
            for name, count in got["scan_launches"].items():
                totals[name] = totals.get(name, 0) + count
        r0 = ranks[0][label]
        counts = ", ".join(f"{k} {v}" for k, v in r0["scan_launches"].items() if v)
        print(f"[sharded-scan] {label}, 2x2 of {BIG[0]}x{BIG[1]} f32, 4 GPUs over NCCL "
              f"({card} each), {nt} steps ({warmup} warmup): route scan-graph on every rank, "
              f"q {r0['q']}, c {r0['c']}, {r0['graphs']} graph(s); each rank bitwise == its "
              f"step-driver run, launches per rank == the step driver's ({counts}); rank 0 "
              f"ms/step graph {r0['scan_ms']:.5f}, step {r0['step_ms']:.5f}, eager loop "
              f"{r0['scan-loop_ms']:.5f}; capture host ms per rank " + ", ".join(
                  f"{r[label]['capture_ms']:.1f}" for r in ranks), flush=True)
    return ranks, totals


def weak_scaling_rank(rank, spec):
    """One rank of [weak-scaling]: the weak-scaling app's ladder
    (apps/weak_scaling.ladder) for each WEAK_RUNS case, the launch counts
    of each ladder read just after it; for perf under the scan driver, the
    4-rank field gathered and, on rank 0, the whole-domain run of the same
    kernel on one GPU."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.apps import weak_scaling
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    out = dict(rank=rank, runs={}, launches={})

    def ladder(variant, driver):
        args = weak_scaling.make_parser().parse_args([
            "--local", str(WEAK_LOCAL), "--nt", str(spec["nt"]), "--warmup",
            str(spec["warmup"]), "--counts", WEAK_COUNTS, "--variant", variant,
            "--driver", driver, "--dtype", "f32"])
        kernels.reset_launches()
        rows = weak_scaling.ladder(args, device, log=lambda msg: None)
        torch.cuda.synchronize()
        return rows, dict(kernels.LAUNCHES), [
            dict(row, route=rung.result.route, k=rung.result.k,
                 us_per_step=rung.result.wtime_it * 1e6,
                 finite=bool(torch.isfinite(rung.result.T).all())) for row, rung in rows]

    for variant, driver in WEAK_RUNS:
        key = f"{variant} {driver}"
        rows, out["launches"][key], out["runs"][key] = ladder(variant, driver)
        if (variant, driver) == ("perf", "scan"):
            last = rows[-1][1]
            full = gather_to_host0(last.result.T, last.model.grid)
            if rank == 0:
                ref, _ = whole_domain_fused_step_cm(torch, last.shape,
                                                    last.model.config.lengths,
                                                    last.model.config.nt, device)
                out["bitwise_vs_one_gpu"] = bool(np.array_equal(full, ref))
                out["max_abs_vs_one_gpu"] = float(np.abs(full - ref).max())
        del rows
    # The padded route's rungs: their launches are a comparison's, not
    # counted with the main path's.
    for variant, driver in WEAK_PADDED_RUNS:
        with padded_route():
            rows, _, out["runs"][f"{variant} {driver} padded"] = ladder(variant, driver)
        del rows
    return out


def phase_weak_scaling(card, gpus: int):
    """[weak-scaling] the weak-scaling app's rungs (counts 1, 2, 4 at 252²
    a rank, f32) for diffusion perf, hide and deep under the scan driver
    and hide under the step driver: over NCCL, one rank a card, the
    north-star rows; on one card, 4 gloo ranks sharing it, the mechanics
    only. Every row finite, the sharded per-step rows on their route, and
    the gathered 4-rank perf field bitwise equal to the whole-domain run of
    the same kernel on one GPU."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup = WEAK_WINDOWS[gpus]
    spec = dict(nt=nt, warmup=warmup, gpus=gpus)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, weak_scaling_rank, (spec,), backend=backend, timeout=600)
    sharded_route = "scan-loop" if gpus == 1 else "scan-graph"
    r0 = ranks[0]
    for variant, driver in WEAK_RUNS:
        key = f"{variant} {driver}"
        rows = r0["runs"][key]
        check([row["devices"] for row in rows] == [1, 2, 4],
              f"[weak-scaling] {key}: rows {[row['devices'] for row in rows]}")
        for row in rows:
            check(row["finite"] and all(math.isfinite(row[k]) for k in
                                        ("gpts", "gpts_per_device", "efficiency")),
                  f"[weak-scaling] {key} n={row['devices']}: not finite ({row})")
            check(row.get("mechanics_only", False) == (gpus == 1),
                  f"[weak-scaling] {key} n={row['devices']}: mechanics_only "
                  f"{row.get('mechanics_only')}")
            if driver == "scan" and variant != "deep" and row["devices"] > 1:
                check(row["route"] == sharded_route,
                      f"[weak-scaling] {key} n={row['devices']}: route {row['route']}")
            if variant == "deep":
                # One CUDA rank, or CUDA ranks over NCCL: graphs of sweeps.
                want = "scan-graph" if row["devices"] == 1 else sharded_route
                check(row["loop_route"] == want,
                      f"[weak-scaling] deep n={row['devices']}: loop route "
                      f"{row['loop_route']}, expected {want}")
    check(r0["bitwise_vs_one_gpu"],
          f"[weak-scaling] perf n=4 gathered field differs from the whole-domain run of the "
          f"same kernel by {r0['max_abs_vs_one_gpu']}")
    where = (f"4 ranks sharing {card} (gloo; mechanics only, the rates are not a multi-GPU "
             "measurement)" if gpus == 1 else f"4 GPUs, one rank each, NCCL ({card} each)")
    print(f"[weak-scaling] {WEAK_LOCAL}x{WEAK_LOCAL} f32 a rank, {nt} steps ({warmup} "
          f"warmup), counts {WEAK_COUNTS}, on {where}; the gathered perf n=4 field bitwise == "
          "the whole-domain run of the same kernel on one GPU", flush=True)
    for variant, driver in WEAK_PADDED_RUNS:
        for row in r0["runs"][f"{variant} {driver} padded"]:
            check(row["finite"], f"[weak-scaling] {variant} padded route n={row['devices']}: "
                  "not finite")
    for variant, driver, padded in ([(v, d, "") for v, d in WEAK_RUNS]
                                    + [(v, d, " padded") for v, d in WEAK_PADDED_RUNS]):
        for row in r0["runs"][f"{variant} {driver}{padded}"]:
            route = " over the padded route" if padded else ""
            print(f"[weak-scaling] {variant}{route} --driver {driver} n={row['devices']} dims "
                  f"{row['dims']}: {row['us_per_step']:.3f} us/step, {row['gpts']} Gpts/s, "
                  f"{row['gpts_per_device']} per device, efficiency {row['efficiency']} "
                  f"(route {row['route']}, k {row['k']}"
                  + (f", loop route {row['loop_route']}" if "loop_route" in row else "")
                  + ")", flush=True)
    totals: dict[str, int] = {}
    for r in ranks:
        for counts in r["launches"].values():
            for name, count in counts.items():
                totals[name] = totals.get(name, 0) + count
    return ranks, totals


def plain_deep(model, T, Cp, n: int, k: int, route: str):
    """`n` steps of the deep schedule through the plain versions: the same
    prepare, width-k exchange and crop as parallel.deep_halo, the local k
    steps by multi_step_cm_plain ("vmem"), tb_sweep_plain ("hbm-tb") or
    the plain steps of the "jnp" route."""
    from rocm_mpi_tpu_torch.ops import kernels, multistep
    from rocm_mpi_tpu_torch.parallel.deep_halo import jnp_k_steps, make_deep_sweep
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    cfg = model.config
    Cm = make_deep_sweep(model.grid, k, cfg.lam, model.dt, cfg.spacing).prepare(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    core = tuple(slice(k, -k) for _ in range(T.ndim))
    for _ in range(n // k):
        Tp = exchange_halo(T, model.grid, width=k)
        if route == "vmem":
            form = multistep.multi_step_form(Tp.shape, Tp.dtype, k, inv_d2)
            Tp = multistep.multi_step_cm_plain(Tp, Cm, inv_d2, k, form)
        elif route == "jnp":  # the JAX package's XLA route: plain steps, no kernel
            Tp = jnp_k_steps(Tp, Cm, inv_d2, k)
        else:
            Tp = multistep.tb_sweep_plain(Tp, Cm, inv_d2, k)
        T = Tp[core]
    return T.contiguous()


def plain_schedule(model, meth: str, route: str, k: int, nt: int):
    """The same `nt` steps of a one-GPU schedule through the plain versions."""
    from rocm_mpi_tpu_torch.ops import kernels, multistep

    cfg = model.config
    T, Cp = model.init_state()
    if meth == "run_deep":
        return plain_deep(model, T, Cp, nt, k, route)
    Cm = kernels.edge_masked_cm(T, Cp, cfg.lam, float(model.dt))
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    for _ in range(nt // k):
        if meth == "run_vmem_resident":
            T = multistep.multi_step_cm_plain(
                T, Cm, inv_d2, k, multistep.multi_step_form(T.shape, T.dtype, k, inv_d2))
        else:
            T = multistep.tb_sweep_plain(T, Cm, inv_d2, k)
    return T


@contextlib.contextmanager
def watch_loops():
    """The sweep and scan loops (models/scan.ScanLoop) made inside the
    block, in the order they were made: what a schedule's graphs
    recorded, read after its run."""
    from rocm_mpi_tpu_torch.models.scan import ScanLoop

    made = []
    init = ScanLoop.__init__

    def tracked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    ScanLoop.__init__ = tracked
    try:
        yield made
    finally:
        ScanLoop.__init__ = init


def loop_facts(loop) -> dict:
    """A schedule's loop as printed and recorded: q and c in sweeps, the
    graphs it captured, and the kernel launches each graph's replay adds."""
    return dict(q=loop.plan.q, c=loop.plan.c, graphs=len(loop.graphs),
                replay_launches={f"{phase}+{count}": dict(rec) for (phase, count), rec
                                 in loop.recorded.items()})


def loop_text(res, facts) -> str:
    return (f"loop route {res.loop_route}, q {facts['q']} and c {facts['c']} sweeps, "
            f"{facts['graphs']} graph(s), capture {res.capture_ms:.1f} host ms, a replay "
            f"launches {facts['replay_launches']}")


def eager_schedule(model, meth: str, k: int):
    """The eager sweep loop a schedule's graphs replace, over the model's
    windows from its initial state, timed like the run: the ops' Python
    loops over launches (run_vmem_resident, run_hbm_blocked), or the deep
    schedule's prepare once a call (with a zero wire state; the model's
    wire mode) and its sweeps one Python call after another. Returns (the
    state's leaves, seconds a step)."""
    from rocm_mpi_tpu_torch.ops import multistep, swe, wave
    from rocm_mpi_tpu_torch.parallel import deep_halo
    from rocm_mpi_tpu_torch.utils import metrics

    cfg, grid = model.config, model.grid
    kind = type(model).__name__
    wire_mode = cfg.wire_mode
    if meth == "run_deep":
        if kind == "HeatDiffusion":
            sched = deep_halo.make_deep_sweep(grid, k, cfg.lam, model.dt, cfg.spacing,
                                              wire_mode=wire_mode)
            T, Cp = model.init_state()
            state, coeff = (T,), (lambda s: Cp)

            def sweep(s, P, ws):
                out = sched.sweep(s[0], P, *ws)
                return ((out[0],), out[1:]) if ws else ((out,), ())
        elif kind == "AcousticWave":
            sched = deep_halo.make_wave_deep_sweep(grid, k, model.dt_value, cfg.spacing,
                                                   wire_mode=wire_mode)
            U, Uprev, C2 = model.init_state()
            state, coeff = (U, Uprev), (lambda s: C2)

            def sweep(s, P, ws):
                out = sched.sweep(*s, P, *ws)
                return tuple(out[:2]), tuple(out[2:])
        else:
            sched = deep_halo.make_swe_deep_sweep(grid, k, cfg.dt, cfg.spacing, cfg.H0, cfg.g,
                                                  wire_mode=wire_mode)
            h, us = model.init_state()
            state, coeff = (h, *us), (lambda s: s[0])

            def sweep(s, P, ws):
                out = sched.sweep(s[0], s[1:], P, *ws)
                return (out[0], *out[1]), tuple(out[2:])

        def advance(s, n):
            P = sched.prepare(coeff(s))
            ws = (sched.init_wire(s[0].dtype, s[0].device),) if sched.init_wire else ()
            for _ in range(n // k):
                s, ws = sweep(s, P, ws)
            return s
    elif kind == "HeatDiffusion":
        T, Cp = model.init_state()
        state = (T,)

        def advance(s, n):
            if meth == "run_vmem_resident":
                return (multistep.fused_multi_step(s[0], Cp, cfg.lam, model.dt_value,
                                                   cfg.spacing, n, chunk=k,
                                                   warn_on_cap=False),)
            return (multistep.fused_multi_step_hbm(s[0], Cp, cfg.lam, model.dt_value,
                                                   cfg.spacing, n, block_steps=k),)
    elif kind == "AcousticWave":
        U, Uprev, C2 = model.init_state()
        state = (U, Uprev)

        def advance(s, n):
            return wave.wave_multi_step(*s, C2, model.dt_value, cfg.spacing, n, chunk=k,
                                        warn_on_cap=False)
    else:
        h, us = model.init_state()
        Mus = model.face_masks()
        state = (h, *us)

        def advance(s, n):
            h2, us2 = swe.swe_multi_step(s[0], s[1:], Mus, cfg.dt, cfg.spacing, cfg.H0, cfg.g,
                                         n, chunk=k, warn_on_cap=False)
            return (h2, *us2)
    state, wtime = metrics.timed_window(advance, state, cfg.nt, cfg.warmup,
                                        sharded=grid.nprocs > 1, group=grid.group)
    return tuple(t.contiguous() for t in state), wtime / (cfg.nt - cfg.warmup)


def graph_against_eager(torch, model, meth: str, res, leaves, k: int, label: str,
                        loops) -> dict:
    """Hold a schedule's run's leaves bitwise to the eager sweep loop of
    the same schedule, windows and wire mode; the record of both times
    and of the run's loop (the last of `loops`)."""
    eager, eager_s = eager_schedule(model, meth, k)
    equal, err = _same(tuple(leaves), eager[:len(leaves)])
    check(equal, f"{label}: graph run != eager sweep loop (max |diff| {err})")
    torch.cuda.synchronize()
    return dict(loop_route=res.loop_route, capture_ms=res.capture_ms,
                graph_ms_per_step=res.wtime_it * 1e3, eager_ms_per_step=eager_s * 1e3,
                **loop_facts(loops[-1]))


# (method, shape, nt, warmup, expected route, expected k, kernel): the
# windows of PRs 2–8, and run_deep 252² at k = 8 with the weak-scaling
# app's windows (its n = 1 deep rung).
SCHEDULES = [
    ("run_vmem_resident", SMALL, VMEM_NT, VMEM_WARMUP, "vmem-loop", 256, "multi_step_cm"),
    ("run_deep", SMALL, DEEP_SMALL_NT, DEEP_SMALL_WARMUP, "vmem", 32, "multi_step_cm"),
    ("run_deep", SMALL, WEAK_WINDOWS[4][0], WEAK_WINDOWS[4][1], "vmem", 8, "multi_step_cm"),
    ("run_hbm_blocked", BIG, TB_NT, TB_WARMUP, "hbm-tb", 8, "tb_sweep"),
    ("run_deep", BIG, TB_NT, TB_WARMUP, "hbm-tb", 8, "tb_sweep"),
]


def _analytic_rel(torch, model, T):
    from rocm_mpi_tpu_torch.ops.diffusion import analytic_solution

    cfg = model.config
    coords = model.grid.coord_mesh(dtype=torch.float64, device=T.device)
    exact = analytic_solution(coords, cfg.lengths, cfg.lam / cfg.cp0, cfg.nt * cfg.dt)
    return float((T.double() - exact).abs().max() / exact.max())


def phase_schedules(torch, card):
    """The three multi-step schedules on one GPU, through their entry
    points, as CUDA graphs of sweeps: route, loop route, k and launches
    asserted, bitwise against the plain versions' run of the same
    schedule and against the eager sweep loop the graphs replace, both
    timed."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    rows = []
    for meth, shape, nt, warmup, route, k, kernel in SCHEDULES:
        cfg = DiffusionConfig(global_shape=shape, nt=nt, warmup=warmup, dtype="f32",
                              dims=(1, 1))
        model = HeatDiffusion(cfg, grid=init_global_grid(*shape, dims=(1, 1), nprocs=1,
                                                         rank=0), device="cuda")
        kernels.reset_launches()
        with watch_loops() as loops:
            res = (model.run_deep(block_steps=k) if meth == "run_deep"
                   else getattr(model, meth)())
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        label = f"{meth} {shape[0]}x{shape[1]} f32 k {k}"
        check((res.route, res.k, res.loop_route) == (route, k, "scan-graph"),
              f"{label}: route {res.route} k {res.k} loop {res.loop_route}, expected {route} "
              f"k {k} scan-graph")
        check(launches == only(kernel, nt // k),
              f"{label}: launches {launches}, expected {nt // k} {kernel}")
        check(tuple(res.T.shape) == shape and bool(torch.isfinite(res.T).all()),
              f"{label}: result not finite or misshapen")
        ref = plain_schedule(model, meth, route, k, nt)
        check(torch.equal(res.T, ref), f"{label}: kernel run != plain-version run "
              f"(max |diff| {float((res.T.double() - ref.double()).abs().max())})")
        item = res.T.element_size()
        cells = res.T.numel()
        if meth == "run_deep":
            padded = (shape[0] + 2 * k) * (shape[1] + 2 * k)
            # kernel I/O on the padded block + the core's copy into it
            per_sweep = 3 * padded * item + 2 * cells * item
        else:
            per_sweep = 3 * cells * item
        row = dict(method=meth, shape=list(shape), nt=nt, warmup=warmup, route=res.route,
                   k=res.k, launches=launches, wtime_s=res.wtime,
                   ms_per_step=res.wtime_it * 1e3, t_eff_gbs=res.t_eff, gpts=res.gpts,
                   bytes_per_sweep=per_sweep, bytes_per_step=per_sweep / k,
                   **graph_against_eager(torch, model, meth, res, (res.T,), k, label, loops))
        windows = ""
        if meth == "run_vmem_resident":
            # Its timed window is a few ms on the host clock, where one
            # window can read twice another: the median of three runs'.
            reads = [res.wtime_it] + [getattr(model, meth)().wtime_it for _ in range(2)]
            torch.cuda.synchronize()
            ratio = res.wtime_it / statistics.median(reads)
            row.update(window_ms_per_step=[w * 1e3 for w in reads],
                       ms_per_step=statistics.median(reads) * 1e3,
                       t_eff_gbs=res.t_eff * ratio, gpts=res.gpts * ratio)
            windows = (" (median of three runs' windows: "
                       + ", ".join(f"{w * 1e3:.5f}" for w in reads) + ")")
        if shape == SMALL and (meth == "run_vmem_resident" or nt <= DEEP_SMALL_NT):
            # (The weak-scaling windows' 2000 steps reach the held walls.)
            check_model = model
            T = res.T
            if meth == "run_vmem_resident":
                check_cfg = DiffusionConfig(global_shape=shape, nt=VMEM_CHECK_NT,
                                            warmup=VMEM_WARMUP, dtype="f32", dims=(1, 1))
                check_model = HeatDiffusion(check_cfg, grid=model.grid, device="cuda")
                T = check_model.run_vmem_resident().T
            row["analytic_rel_err"] = rel = _analytic_rel(torch, check_model, T)
            row["analytic_nt"] = check_model.config.nt
            check(rel < 2e-3, f"{label}: relative error vs analytic Gaussian {rel} "
                  f"after {check_model.config.nt} steps")
        rows.append(row)
        print(f"[schedule] {label}, {nt} steps ({warmup} warmup): route {res.route}, "
              f"k {res.k}, {kernel} launches {launches[kernel]}; bitwise == plain-version "
              f"run and == the eager sweep loop; {loop_text(res, row)}; graph "
              f"{row['graph_ms_per_step']:.5f} ms/step against the eager loop's "
              f"{row['eager_ms_per_step']:.5f}; "
              f"{res.wtime:.4f} s, {row['ms_per_step']:.5f} ms/step{windows}, effective "
              f"T_eff {row['t_eff_gbs']:.1f} GB/s (3 passes per step counted; device memory "
              f"moved: {per_sweep / 1e6:.1f} MB per sweep, {per_sweep / k / 1e6:.2f} MB per "
              f"step), {row['gpts']:.3f} Gpts/s on {card}"
              + (f"; vs analytic Gaussian after {row['analytic_nt']} steps: "
                 f"{row['analytic_rel_err']:.3e} (bound 2e-3)" if "analytic_rel_err" in row
                 else ""), flush=True)
        del model, res, ref, loops
        torch.cuda.empty_cache()
    return rows


def sharded_deep_rank(rank, spec):
    """One rank of the sharded deep schedule (started by spawn_ranks)."""
    import numpy as np
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0
    from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

    import torch.distributed as dist

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape = tuple(spec["shape"])
    cfg = DiffusionConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"],
                          dtype="f32", dims=(2, 2))
    model = HeatDiffusion(cfg, device=device)

    kernels.reset_launches()
    with watch_loops() as loops:
        res = model.run_deep()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    T, Cp = model.init_state()
    ref = plain_deep(model, T, Cp, cfg.nt, res.k, res.route)
    label = f"sharded deep rank {rank}"
    out = dict(rank=rank, launches=launches, route=res.route, k=res.k,
               bitwise=bool(torch.equal(res.T, ref)),
               finite=bool(torch.isfinite(res.T).all()), wtime_s=res.wtime,
               ms_per_step=res.wtime_it * 1e3, t_eff_gbs=res.t_eff, gpts=res.gpts,
               **graph_against_eager(torch, model, "run_deep", res, (res.T,), res.k, label,
                                     loops))
    del loops
    # Every wire mode, each held bitwise to its own eager sweep loop on the
    # card over two calls (the warmup and the timed window), each of which
    # starts from a zero wire state.
    out["wire"] = {}
    for mode in ("f32", "bf16", "int8", "int8_delta"):
        wcfg = DiffusionConfig(global_shape=shape, nt=SHARD_DEEP_NT, warmup=SHARD_DEEP_WARMUP,
                               dtype="f32", dims=(2, 2), wire_mode=mode)
        wmodel = HeatDiffusion(wcfg, device=device)
        with watch_loops() as loops:
            wres = wmodel.run_deep(block_steps=res.k)
        out["wire"][mode] = dict(
            route=wres.route, **graph_against_eager(torch, wmodel, "run_deep", wres, (wres.T,),
                                                    res.k, f"{label} {mode} wire", loops))
        del loops, wmodel, wres
    full = gather_to_host0(res.T, model.grid)
    if rank == 0:
        # The same schedule over the whole domain on one GPU, at the same k:
        # every core cell takes its k direct-form steps from the same
        # neighbours, so the gathered field must match bit for bit — a check
        # of the width-k exchange.
        one_cfg = DiffusionConfig(global_shape=shape, nt=cfg.nt, warmup=cfg.warmup,
                                  dtype="f32", dims=(1, 1))
        one = HeatDiffusion(one_cfg, grid=GlobalGrid(shape, one_cfg.lengths, (1, 1)),
                            device=device)
        advance, k1 = one.deep_advance_fn(block_steps=res.k, nt=cfg.nt, warmup=cfg.warmup)
        T1, Cp1 = one.init_state()
        T1 = advance(T1, Cp1, cfg.nt).cpu().numpy()
        out["one_gpu"] = dict(route=advance.schedule.route, k=k1)
        out["max_abs_vs_one_gpu"] = float(np.abs(full - T1).max())
        out["bitwise_vs_one_gpu"] = bool(np.array_equal(full, T1))
    return out


def phase_sharded_deep(card, gpus: int):
    """run_deep on the 2×2 grid of 12288² by 4 ranks: sharing one card over
    gloo, or one rank per card over NCCL when `gpus` is 4."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup = ((SHARD_DEEP_NT, SHARD_DEEP_WARMUP) if gpus == 1
                  else (TB_WARMUP + MAIN_NT, TB_WARMUP))
    spec = dict(shape=BIG, nt=nt, warmup=warmup, gpus=gpus)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, sharded_deep_rank, (spec,), backend=backend, timeout=900)
    loop_route = "scan-loop" if gpus == 1 else "scan-graph"
    for r in ranks:
        check((r["route"], r["k"]) == ("hbm-tb", 8),
              f"sharded deep rank {r['rank']}: route {r['route']} k {r['k']}, "
              "expected hbm-tb k 8")
        for mode, w in [("f32 (main)", r)] + list(r["wire"].items()):
            check(w["loop_route"] == loop_route,
                  f"sharded deep rank {r['rank']} {mode}: loop route {w['loop_route']}, "
                  f"expected {loop_route}")
        check(r["launches"] == only("tb_sweep", nt // 8),
              f"sharded deep rank {r['rank']}: launches {r['launches']}, expected "
              f"{nt // 8} tb_sweep")
        check(r["bitwise"] and r["finite"],
              f"sharded deep rank {r['rank']}: kernel run != plain-version run or not finite")
    r0 = ranks[0]
    check(r0["one_gpu"] == {"route": "hbm-tb", "k": 8},
          f"one-GPU deep reference took {r0['one_gpu']}")
    check(r0["bitwise_vs_one_gpu"],
          f"sharded 2x2 deep field differs from the one-GPU run_deep by "
          f"{r0['max_abs_vs_one_gpu']}")
    total = sum(r["launches"]["tb_sweep"] for r in ranks)
    where = (f"4 ranks sharing {card} (gloo, halo slabs staged through host memory: "
             "not a multi-GPU measurement)" if gpus == 1
             else f"4 GPUs, one rank each, NCCL ({card} each)")
    print(f"[sharded-deep] run_deep 12288x12288 f32 on a 2x2 grid, {where}, {nt} steps "
          f"({warmup} warmup): route hbm-tb, k 8, tb_sweep launches {total} ({nt // 8} per "
          "rank); each shard bitwise == plain-version run; gathered field bitwise == the "
          f"one-GPU run_deep (max |diff| {r0['max_abs_vs_one_gpu']}); rank 0: "
          f"{r0['wtime_s']:.4f} s, {r0['ms_per_step']:.5f} ms/step, aggregate effective "
          f"T_eff {r0['t_eff_gbs']:.1f} GB/s, {r0['gpts']:.3f} Gpts/s; every shard bitwise "
          f"== the eager sweep loop; {_loop_line(r0)}", flush=True)
    for mode, w in r0["wire"].items():
        print(f"[sharded-deep] {mode} wire, {SHARD_DEEP_NT} steps ({SHARD_DEEP_WARMUP} "
              f"warmup), k 8: every shard bitwise == its eager sweep loop over the two calls; "
              f"rank 0 {_loop_line(w)}", flush=True)
    return ranks, total


def _loop_line(r) -> str:
    """A rank's loop record (graph_against_eager) as one clause."""
    return (f"loop route {r['loop_route']}, q {r['q']} and c {r['c']} sweeps, {r['graphs']} "
            f"graph(s), capture {r['capture_ms']:.1f} host ms, a replay launches "
            f"{r['replay_launches']}; graph {r['graph_ms_per_step']:.5f} ms/step against the "
            f"eager loop's {r['eager_ms_per_step']:.5f}")


# ---------------------------------------------------------------------------
# The acoustic wave
# ---------------------------------------------------------------------------


def _wave_model(shape, nt, warmup, dtype="f32", device="cuda"):
    from rocm_mpi_tpu_torch.config import WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = WaveConfig(global_shape=shape, nt=nt, warmup=warmup, dtype=dtype, dims=(1, 1))
    return AcousticWave(cfg, grid=init_global_grid(*shape, dims=(1, 1), nprocs=1, rank=0),
                        device=device)


def plain_wave_steps(model, U, Uprev, C2, n: int, variant: str = "perf"):
    """`n` wave steps through the plain versions on the card: the same
    exchange, then perf's plain wave_step and Dirichlet select, or hide's
    plain wave_step_masked over the whole block (per cell the arithmetic
    of its region launches)."""
    import torch

    from rocm_mpi_tpu_torch.ops import kernels, wave
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo, global_boundary_mask

    cfg, grid = model.config, model.grid
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    mask = global_boundary_mask(grid, device=U.device)
    M = torch.where(mask, torch.zeros_like(C2), torch.ones_like(C2))
    Cw = ((model.dt * model.dt) * C2) * M
    pad = torch.zeros(tuple(s + 2 for s in U.shape), dtype=U.dtype, device=U.device)
    for _ in range(n):
        Up = exchange_halo(U, grid, out=pad)
        if variant == "hide":
            new = wave.wave_step_masked_plain(Up, Uprev, M, Cw, inv_d2)
        else:
            new = torch.where(mask, U, wave.wave_step_plain(Up, Uprev, C2, model.dt_value ** 2,
                                                           inv_d2))
        U, Uprev = new, U
    return U, Uprev


def plain_wave_schedule(model, meth: str, k: int, nt: int):
    """The same `nt` steps of a wave schedule through the plain versions:
    run_vmem_resident's chunks, or run_deep's prepare, width-k exchanges,
    local k steps and crops."""
    from rocm_mpi_tpu_torch.ops import kernels, wave
    from rocm_mpi_tpu_torch.parallel.deep_halo import make_wave_deep_sweep
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    cfg, grid = model.config, model.grid
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    form = wave.wave_multi_step_form(k, inv_d2)
    U, Uprev, C2 = model.init_state()
    if meth == "run_vmem_resident":
        M = wave.interior_mask(U.shape, U.dtype, U.device)
        Cw = ((model.dt_value * model.dt_value) * C2) * M
        for _ in range(nt // k):
            U, Uprev = wave.wave_multi_step_plain(U, Uprev, M, Cw, inv_d2, k, form)
        return U
    M, Cw = make_wave_deep_sweep(grid, k, model.dt_value, cfg.spacing).prepare(C2)
    core = tuple(slice(k, -k) for _ in range(U.ndim))
    for _ in range(nt // k):
        Up, Upp = (exchange_halo(t, grid, width=k) for t in (U, Uprev))
        U, Uprev = (t[core] for t in wave.wave_multi_step_plain(Up, Upp, M, Cw, inv_d2, k, form))
    return U.contiguous()


# (method, shape, nt, warmup, expected route, expected k, kernel, launches)
WAVE_RUNS = [
    ("run", BIG, BIG_NT, MAIN_WARMUP, None, None, "wave_step", BIG_NT),
    ("run_vmem_resident", SMALL, VMEM_NT, VMEM_WARMUP, "vmem-loop", 256, "wave_multi_step",
     VMEM_NT // 256),
    ("run_deep", SMALL, WAVE_DEEP_NT, WAVE_DEEP_WARMUP, "vmem", WAVE_DEEP_K, "wave_multi_step",
     WAVE_DEEP_NT // WAVE_DEEP_K),
]


def _wave_perf_parts(torch, model, U):
    """The one-GPU perf step's three device passes timed alone: the copy of
    the field into the padded buffer, the wave_step kernel, the Dirichlet
    select (XLA fuses the first and last into neighbours on a TPU)."""
    from rocm_mpi_tpu_torch.ops import wave
    from rocm_mpi_tpu_torch.parallel.halo import global_boundary_mask, place_core

    cfg = model.config
    pad = place_core(U)
    Uprev, C2 = U.clone(), torch.ones_like(U)
    mask = global_boundary_mask(model.grid, device=U.device)
    out = torch.empty_like(U)
    parts = dict(
        place_core=time_ms(lambda: place_core(U, out=pad), 30),
        wave_step=time_ms(lambda: wave.wave_step(pad, Uprev, C2, model.dt_value, cfg.spacing,
                                                 out=out), 30),
        where=time_ms(lambda: torch.where(mask, U, out, out=out), 30),
    )
    del pad, Uprev, C2, mask, out
    return parts


def phase_wave(torch, card):
    """The acoustic wave on one GPU, f32, through its entry points: perf at
    12288², the VMEM-resident loop and the deep schedule at 252². Each
    asserts route, k and launches, is bitwise equal to the plain versions'
    run of the same steps, and is timed."""
    from rocm_mpi_tpu_torch.ops import kernels

    rows = []
    for meth, shape, nt, warmup, route, k, kernel, count in WAVE_RUNS:
        model = _wave_model(shape, nt, warmup)
        kernels.reset_launches()
        with watch_loops() as loops:
            if meth == "run":
                res = model.run("perf")
            elif meth == "run_deep":
                res = model.run_deep(block_steps=k)
            else:
                res = model.run_vmem_resident()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        label = f"wave {meth} {shape[0]}x{shape[1]} f32"
        check((res.route, res.k) == (route, k),
              f"{label}: route {res.route} k {res.k}, expected {route} k {k}")
        check(meth == "run" or res.loop_route == "scan-graph",
              f"{label}: loop route {res.loop_route}, expected scan-graph")
        check(launches == only(kernel, count),
              f"{label}: launches {launches}, expected {count} {kernel}")
        check(tuple(res.U.shape) == shape and bool(torch.isfinite(res.U).all()),
              f"{label}: result not finite or misshapen")
        if meth == "run":
            U, Uprev, C2 = model.init_state()
            ref = plain_wave_steps(model, U, Uprev, C2, nt)[0]
        else:
            ref = plain_wave_schedule(model, meth, k, nt)
        check(torch.equal(res.U, ref), f"{label}: kernel run != plain-version run "
              f"(max |diff| {float((res.U.double() - ref.double()).abs().max())})")
        row = dict(method=meth, shape=list(shape), nt=nt, warmup=warmup, route=res.route,
                   k=res.k, launches=launches, wtime_s=res.wtime,
                   ms_per_step=res.wtime_it * 1e3, t_eff_gbs=res.t_eff, gpts=res.gpts,
                   max_abs_u=float(res.U.abs().max()))
        graphs = ""
        if meth != "run":
            row.update(graph_against_eager(torch, model, meth, res, (res.U,), k, label, loops))
            graphs = (f" and == the eager sweep loop; {loop_text(res, row)}; graph "
                      f"{row['graph_ms_per_step']:.5f} ms/step against the eager loop's "
                      f"{row['eager_ms_per_step']:.5f}")
        if meth == "run":
            row["parts_ms"] = _wave_perf_parts(torch, model, res.U)
            print("[wave] perf step's parts alone at "
                  f"{shape[0]}x{shape[1]} f32 (ms): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row["parts_ms"].items()) + f" on {card}",
                  flush=True)
        rows.append(row)
        print(f"[wave] {label}, {nt} steps ({warmup} warmup): route {res.route}, k {res.k}, "
              f"{kernel} launches {launches[kernel]}; bitwise == plain-version run{graphs}; "
              f"{res.wtime:.4f} s, {row['ms_per_step']:.5f} ms/step, T_eff {res.t_eff:.1f} "
              f"GB/s (4 passes per step counted), {res.gpts:.3f} Gpts/s on {card}", flush=True)
        del model, res, ref, loops
        torch.cuda.empty_cache()
    return rows


def phase_reversal(torch, card):
    """Time reversal on the card: 252² f64 perf, n steps forward, the pair
    swapped, n − 1 steps back, lands on the initial field."""
    from rocm_mpi_tpu_torch.ops import kernels

    n = REVERSAL_STEPS
    model = _wave_model(SMALL, 2 * n, 0, dtype="f64")
    U0, Uprev0, C2 = model.init_state()
    advance = model.advance_fn("perf")
    kernels.reset_launches()
    U, Uprev = advance(U0.clone(), Uprev0.clone(), C2, n)
    Ub, _ = advance(Uprev, U, C2, n - 1)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    err = float((Ub - U0).abs().max())
    check(launches == only("wave_step", 2 * n - 1), f"reversal: launches {launches}")
    check(err < 1e-10, f"reversal: max |U_back - U_0| = {err} (bound 1e-10)")
    print(f"[wave] time reversal 252x252 f64 perf: {n} steps forward, {n - 1} back, "
          f"{2 * n - 1} wave_step launches; max |U_back - U_0| = {err:.3e} (bound 1e-10) "
          f"on {card}", flush=True)
    return dict(steps=n, max_abs_err=err, launches=launches)


# ---------------------------------------------------------------------------
# The shallow water
# ---------------------------------------------------------------------------


def _swe_model(shape, nt, warmup, dtype="f32", device="cuda"):
    from rocm_mpi_tpu_torch.config import SWEConfig
    from rocm_mpi_tpu_torch.models import ShallowWater
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    cfg = SWEConfig(global_shape=shape, nt=nt, warmup=warmup, dtype=dtype, dims=(1, 1))
    return ShallowWater(cfg, grid=init_global_grid(*shape, dims=(1, 1), nprocs=1, rank=0),
                        device=device)


def _leaves(h, us) -> tuple:
    return (h, *us)


def plain_swe_steps(model, h, us, n: int):
    """`n` shallow-water steps through the plain versions on the card: the
    same exchange of every leaf, then swe_step's plain version over the
    whole block (per cell also the arithmetic of hide's region launches)."""
    import torch

    from rocm_mpi_tpu_torch.ops import swe
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    cH, cg = model.coeffs
    Mus = model.face_masks()
    pads = tuple(torch.zeros(tuple(s + 2 for s in h.shape), dtype=h.dtype, device=h.device)
                 for _ in range(len(us) + 1))
    for _ in range(n):
        Sp = tuple(exchange_halo(t, model.grid, out=p) for t, p in zip(_leaves(h, us), pads))
        h, *us = swe.swe_step_plain(Sp, Mus, cH, cg)
    return h, tuple(us)


def plain_swe_schedule(model, meth: str, k: int, nt: int):
    """The same `nt` steps of a shallow-water schedule through the plain
    versions: run_vmem_resident's chunks, or run_deep's padded masks,
    width-k exchanges of every leaf, local k steps and crops."""
    from rocm_mpi_tpu_torch.ops import swe
    from rocm_mpi_tpu_torch.parallel.deep_halo import make_swe_deep_sweep, swe_local_route
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    cfg, grid = model.config, model.grid
    cH, cg = model.coeffs
    h, us = model.init_state()
    if meth == "run_vmem_resident":
        Mus = model.face_masks()
        for _ in range(nt // k):
            h, us = swe.swe_multi_step_plain(h, us, Mus, cH, cg, k)
        return h, us
    Mp = make_swe_deep_sweep(grid, k, cfg.dt, cfg.spacing, cfg.H0, cfg.g).prepare(h)
    route = swe_local_route(Mp[0].shape, h.dtype)
    core = tuple(slice(k, -k) for _ in range(h.ndim))
    for _ in range(nt // k):
        hp, *ups = (exchange_halo(t, grid, width=k) for t in _leaves(h, us))
        if route == "vmem":
            hp, ups = swe.swe_multi_step_plain(hp, ups, Mp, cH, cg, k)
        else:
            for _ in range(k):
                hp, ups = swe.masked_swe_step(hp, ups, Mp, cH, cg)
        h, us = hp[core], tuple(u[core] for u in ups)
    return h.contiguous(), tuple(u.contiguous() for u in us)


# (method, shape, dtype, nt, warmup, expected route, expected k, kernel, launches)
SWE_RUNS = [
    ("run", BIG, "f32", BIG_NT, MAIN_WARMUP, None, None, "swe_step", BIG_NT),
    ("run", SMALL, "f64", MAIN_NT, MAIN_WARMUP, None, None, "swe_step", MAIN_NT),
    ("run_vmem_resident", SMALL, "f32", VMEM_NT, VMEM_WARMUP, "vmem-loop", 256,
     "swe_multi_step", VMEM_NT // 256),
    ("run_deep", SWE_DEEP_SMALL, "f32", WAVE_DEEP_NT, WAVE_DEEP_WARMUP, "vmem", WAVE_DEEP_K,
     "swe_multi_step", WAVE_DEEP_NT // WAVE_DEEP_K),
    # 268² padded: over the admission, so the jnp route and no kernel.
    ("run_deep", SMALL, "f32", WAVE_DEEP_NT, WAVE_DEEP_WARMUP, "jnp", WAVE_DEEP_K, None, 0),
]


def _swe_perf_parts(torch, model, h):
    """The one-GPU perf step's device passes timed alone: the three copies
    of the state into the padded buffers, and the swe_step kernel."""
    from rocm_mpi_tpu_torch.ops import swe
    from rocm_mpi_tpu_torch.parallel.halo import place_core

    cfg = model.config
    state = (h,) + tuple(h.clone() for _ in range(cfg.ndim))
    pads = tuple(place_core(t) for t in state)
    Mus = model.face_masks()
    out = tuple(torch.empty_like(h) for _ in state)
    parts = dict(
        place_core_x3=time_ms(lambda: [place_core(t, out=p) for t, p in zip(state, pads)], 30),
        swe_step=time_ms(lambda: swe.swe_step(pads, Mus, (cfg.H0, cfg.g), cfg.dt, cfg.spacing,
                                              out=out), 30),
    )
    del state, pads, Mus, out
    return parts


def phase_swe(torch, card):
    """The shallow water on one GPU through its entry points: perf at 12288²
    f32 and at the app's default 252² f64, the VMEM-resident loop and the
    deep schedule at 252² and 240². Each asserts route, k and launches, is
    bitwise equal to the plain versions' run of the same steps, holds its
    mass drift under its bound, and is timed."""
    from rocm_mpi_tpu_torch.ops import kernels

    rows = []
    for meth, shape, dtype, nt, warmup, route, k, kernel, count in SWE_RUNS:
        model = _swe_model(shape, nt, warmup, dtype)
        mass0 = float(model.init_state()[0].sum(dtype=torch.float64))
        kernels.reset_launches()
        with watch_loops() as loops:
            if meth == "run":
                res = model.run("perf")
            elif meth == "run_deep":
                res = model.run_deep(block_steps=k)
            else:
                res = model.run_vmem_resident()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        label = f"swe {meth} {shape[0]}x{shape[1]} {dtype}"
        check((res.route, res.k) == (route, k),
              f"{label}: route {res.route} k {res.k}, expected {route} k {k}")
        check(meth == "run" or res.loop_route == "scan-graph",
              f"{label}: loop route {res.loop_route}, expected scan-graph")
        check(launches == only(kernel or "swe_step", count),
              f"{label}: launches {launches}, expected {count} {kernel}")
        got = _leaves(res.h, res.us)
        check(all(tuple(t.shape) == shape and bool(torch.isfinite(t).all()) for t in got),
              f"{label}: result not finite or misshapen")
        ref = (plain_swe_steps(model, *model.init_state(), nt) if meth == "run"
               else plain_swe_schedule(model, meth, k, nt))
        equal, err = _same(got, _leaves(*ref))
        check(equal, f"{label}: kernel run != plain-version run (max |diff| {err})")
        drift = abs(float(res.h.sum(dtype=torch.float64)) - mass0) / abs(mass0)
        check(drift <= SWE_MASS_BOUND[dtype],
              f"{label}: mass drift {drift} over the bound {SWE_MASS_BOUND[dtype]}")
        row = dict(method=meth, shape=list(shape), dtype=dtype, nt=nt, warmup=warmup,
                   route=res.route, k=res.k, launches=launches, wtime_s=res.wtime,
                   ms_per_step=res.wtime_it * 1e3, t_eff_gbs=res.t_eff, gpts=res.gpts,
                   mass_drift=drift, max_abs_h=float(res.h.abs().max()))
        graphs = ""
        if meth != "run":
            row.update(graph_against_eager(torch, model, meth, res, got, k, label, loops))
            graphs = (f" and == the eager sweep loop; {loop_text(res, row)}; graph "
                      f"{row['graph_ms_per_step']:.5f} ms/step against the eager loop's "
                      f"{row['eager_ms_per_step']:.5f}")
        if meth == "run" and shape == BIG:
            row["parts_ms"] = _swe_perf_parts(torch, model, res.h)
            print("[swe] perf step's parts alone at "
                  f"{shape[0]}x{shape[1]} f32 (ms): " + ", ".join(
                      f"{name} {v:.4f}" for name, v in row["parts_ms"].items()) + f" on {card}",
                  flush=True)
        rows.append(row)
        print(f"[swe] {label}, {nt} steps ({warmup} warmup): route {res.route}, k {res.k}, "
              f"{kernel or 'no kernel'} launches {launches[kernel] if kernel else 0}; bitwise "
              f"== plain-version run{graphs}; {res.wtime:.4f} s, {row['ms_per_step']:.5f} "
              "ms/step, "
              f"T_eff {res.t_eff:.1f} GB/s ({2 * (len(shape) + 1)} passes per step counted), "
              f"{res.gpts:.3f} Gpts/s; mass drift {drift:.3e} (bound "
              f"{SWE_MASS_BOUND[dtype]:.0e}), max |h| {row['max_abs_h']:.6f} on {card}",
              flush=True)
        del model, res, ref, got, loops
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The scan driver (CUDA graphs)
# ---------------------------------------------------------------------------

# (label, model, variant, shape, dtype, nt, warmup): the main paths at
# their apps' windows (q = c = 10; the wave's three graphs), then the
# plan's edges — warmup 0 (q = nt = 1000, capped at c = 10), an odd c
# (q = c = 5: two graphs) and the wave with warmup 0 (c = 10, not a
# multiple of 3: three graphs).
SCAN_CASES = [
    ("diffusion perf", "diffusion", "perf", SMALL, "f32", MAIN_NT, MAIN_WARMUP),
    ("diffusion perf", "diffusion", "perf", BIG, "f32", BIG_NT, MAIN_WARMUP),
    ("diffusion kp", "diffusion", "kp", KP_SMALL, "f64", MAIN_NT, MAIN_WARMUP),
    ("wave perf", "wave", "perf", SMALL, "f32", MAIN_NT, MAIN_WARMUP),
    ("wave perf", "wave", "perf", BIG, "f32", BIG_NT, MAIN_WARMUP),
    ("SWE perf", "swe", "perf", SMALL, "f64", MAIN_NT, MAIN_WARMUP),
    ("SWE perf", "swe", "perf", BIG, "f32", BIG_NT, MAIN_WARMUP),
    ("diffusion perf, warmup 0", "diffusion", "perf", SMALL, "f32", MAIN_NT, 0),
    ("diffusion perf, odd c", "diffusion", "perf", SMALL, "f32", MAIN_NT + 5, 5),
    ("wave perf, warmup 0", "wave", "perf", SMALL, "f32", MAIN_NT, 0),
]
SCAN_KERNELS = {("diffusion", "perf"): ("masked_step",), ("diffusion", "kp"): KP,
                ("wave", "perf"): ("wave_step",), ("swe", "perf"): ("swe_step",)}
SCAN_WINDOWS = 3  # timed windows a driver, reported by their median


def _scan_fields(model_name, res) -> tuple:
    if model_name == "diffusion":
        return (res.T,)
    if model_name == "wave":
        return (res.U,)
    return (res.h, *res.us)


def _scan_loop(torch, name, model, variant):
    """The scan advance of `model`'s run windows after its first call (q
    steps, which captures): its ScanLoop, for the plan, the graphs and the
    capture's host time."""
    advance, q = model.scan_advance_fn(variant)
    if name == "diffusion":
        T, Cp = model.init_state()
        advance(T, Cp, q)
    elif name == "wave":
        advance(*model.init_state(), q)
    else:
        advance(*model.init_state(), model.face_masks(), q)
    torch.cuda.synchronize()
    return advance.loop


def phase_scan(torch, card):
    """Each SCAN_CASES run through `run(driver="scan")` beside
    `run(driver="step")` on one GPU: the fields bitwise equal, the scan
    route "scan-graph" with q, c and the graph count of its plan, the
    launch counts of both drivers nt per kernel of the step, and ms/step of
    both the median of SCAN_WINDOWS timed windows; then the captures of one
    more scan advance, timed on the host clock, with the graph count."""
    from rocm_mpi_tpu_torch.ops import kernels

    rows = []
    for label, name, variant, shape, dtype, nt, warmup in SCAN_CASES:
        if name == "diffusion":
            model = _kp_model(shape, nt, warmup, dtype)
        elif name == "wave":
            model = _wave_model(shape, nt, warmup, dtype)
        else:
            model = _swe_model(shape, nt, warmup, dtype)
        expect = {k: nt if k in SCAN_KERNELS[name, variant] else 0 for k in kernels.LAUNCHES}
        ms, fields, launches = {}, {}, {}
        for driver in ("step", "scan"):
            times = []
            for _ in range(SCAN_WINDOWS):
                kernels.reset_launches()
                res = model.run(variant, driver=driver)
                torch.cuda.synchronize()
                launches[driver] = dict(kernels.LAUNCHES)
                check(launches[driver] == expect,
                      f"[scan] {label} {shape} {driver}: launches {launches[driver]}, "
                      f"expected {expect}")
                times.append(res.wtime_it * 1e3)
                route, k = res.route, res.k
            ms[driver] = statistics.median(times)
            fields[driver] = _scan_fields(name, res)
            del res
        check(route == "scan-graph", f"[scan] {label}: route {route}")
        loop = _scan_loop(torch, name, model, variant)
        plan = loop.plan
        loop_graphs = len(loop.graphs)
        capture_ms = loop.capture_s * 1e3
        check(plan.q == k and loop_graphs == plan.graphs,
              f"[scan] {label}: q {plan.q} (run: {k}), {loop_graphs} graphs captured, plan "
              f"{plan}")
        del loop
        same = all(torch.equal(a, b) for a, b in zip(fields["step"], fields["scan"]))
        if not same:
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(fields["step"], fields["scan"]))
            check(False, f"[scan] {label} {shape} {dtype}: scan != step (max |diff| {diff})")
        check(all(bool(torch.isfinite(f).all()) for f in fields["scan"]),
              f"[scan] {label}: result not finite")
        row = dict(label=label, model=name, variant=variant, shape=list(shape), dtype=dtype,
                   nt=nt, warmup=warmup, q=k, c=plan.c, graphs=loop_graphs,
                   capture_ms=capture_ms,
                   launches=launches["scan"], step_ms_per_step=ms["step"],
                   scan_ms_per_step=ms["scan"], bitwise=same)
        rows.append(row)
        counts = ", ".join(f"{n} {launches['scan'][n]}" for n in SCAN_KERNELS[name, variant])
        print(f"[scan] {label} {shape[0]}x{shape[1]} {dtype}, {nt} steps ({warmup} warmup): "
              f"route {route}, q {k}, c {plan.c}, {loop_graphs} graph(s) captured in "
              f"{capture_ms:.1f} ms, launches "
              f"{counts}; scan bitwise == step; ms/step (median of {SCAN_WINDOWS} windows) "
              f"step {ms['step']:.6f}, scan {ms['scan']:.6f} ({ms['step'] / ms['scan']:.2f}x) "
              f"on {card}", flush=True)
        del model, fields
        torch.cuda.empty_cache()
    return rows


def _timed_loop(torch, fn, reps: int) -> float:
    """ms per call of `fn` over `reps` calls, host clock around
    synchronised work, every rank barriered on both sides."""
    from rocm_mpi_tpu_torch.parallel import distributed

    fn()
    torch.cuda.synchronize()
    distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    distributed.barrier()
    return (time.perf_counter() - t0) / reps * 1e3


def hide_rank(rank, spec):
    """One rank of the sharded hide phase (started by spawn_ranks):
    diffusion and wave `perf` and `hide` on the 2×2 grid, each against the
    plain versions' run of the same steps on this shard."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels, swe, wave
    from rocm_mpi_tpu_torch.parallel.halo import exchange_faces, exchange_halo
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, ghost_free, region_boxes

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape, nt, warmup = tuple(spec["shape"]), spec["nt"], spec["warmup"]
    out = dict(rank=rank)

    def runs(model):
        got = {}
        for variant in ("perf", "hide"):
            kernels.reset_launches()
            res = model.run(variant)
            torch.cuda.synchronize()
            got[variant] = (res, dict(kernels.LAUNCHES))
        return got

    cfg = DiffusionConfig(global_shape=shape, nt=nt, warmup=warmup, dtype="f32", dims=(2, 2),
                          b_width=HIDE_B_WIDTH)
    model = HeatDiffusion(cfg, device=device)
    got = runs(model)
    T, Cp = model.init_state()
    Cm = model.prepare_fn("hide")(Cp)
    inv_d2 = kernels.inv_d2_of(cfg.spacing)
    pad = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=device)
    for _ in range(nt):
        T = kernels.fused_step_cm_plain(exchange_halo(T, model.grid, out=pad), Cm, inv_d2)
    out["diffusion"] = {v: dict(launches=l, wtime_s=r.wtime, ms_per_step=r.wtime_it * 1e3,
                                bitwise=bool(torch.equal(r.T, T)),
                                finite=bool(torch.isfinite(r.T).all()))
                        for v, (r, l) in got.items()}
    out["diffusion"]["hide_eq_perf"] = bool(torch.equal(got["hide"][0].T, got["perf"][0].T))
    # The hide step over the padded route the face exchange replaced.
    register_padded_variants(model)
    pres = model.run("hide-padded")
    torch.cuda.synchronize()
    out["diffusion"]["hide_padded"] = dict(bitwise=bool(torch.equal(pres.T, got["hide"][0].T)),
                                           ms_per_step=pres.wtime_it * 1e3)
    del pres

    wcfg = WaveConfig(global_shape=shape, nt=nt, warmup=warmup, dtype="f32", dims=(2, 2),
                      b_width=HIDE_B_WIDTH)
    wmodel = AcousticWave(wcfg, device=device)
    wgot = runs(wmodel)
    refs = {v: plain_wave_steps(wmodel, *wmodel.init_state(), nt, v)[0] for v in wgot}
    out["wave"] = {v: dict(launches=l, wtime_s=r.wtime, ms_per_step=r.wtime_it * 1e3,
                           bitwise=bool(torch.equal(r.U, refs[v])),
                           finite=bool(torch.isfinite(r.U).all()))
                   for v, (r, l) in wgot.items()}
    out["wave"]["hide_minus_perf"] = float(
        (wgot["hide"][0].U.double() - wgot["perf"][0].U.double()).abs().max())

    scfg = SWEConfig(global_shape=shape, nt=nt, warmup=warmup, dtype="f32", dims=(2, 2),
                     b_width=HIDE_B_WIDTH)
    smodel = ShallowWater(scfg, device=device)
    sgot = runs(smodel)
    sref = _leaves(*plain_swe_steps(smodel, *smodel.init_state(), nt))
    out["swe"] = {v: dict(launches=l, wtime_s=r.wtime, ms_per_step=r.wtime_it * 1e3,
                          bitwise=_same(_leaves(r.h, r.us), sref)[0],
                          finite=all(bool(torch.isfinite(t).all()) for t in _leaves(r.h, r.us)))
                  for v, (r, l) in sgot.items()}
    out["swe"]["hide_eq_perf"] = _same(_leaves(sgot["hide"][0].h, sgot["hide"][0].us),
                                       _leaves(sgot["perf"][0].h, sgot["perf"][0].us))[0]
    del sref

    if spec["gpus"] > 1:
        # The overlap's parts alone: the exchange, the interior box from
        # the raw shard, the slab boxes from the shard and its faces (the
        # diffusion), or from the padded buffer (the wave and the SWE, and
        # the diffusion's padded route beside).
        local = model.grid.local_shape
        boxes = region_boxes(local, effective_b_width(local, HIDE_B_WIDTH))
        inner = [b for b in boxes if ghost_free(b, local)]
        slabs = [b for b in boxes if not ghost_free(b, local)]
        T = got["perf"][0].T
        res_out = torch.empty_like(T)
        U, Uprev, C2 = wmodel.init_state()
        M, Cw = wmodel.prepare_fn("hide")(C2)
        sp = cfg.spacing
        faces = exchange_faces(T, model.grid)
        none = (None,) * len(faces)
        parts = dict(
            face_exchange=_timed_loop(torch, lambda: exchange_faces(T, model.grid), 100),
            exchange=_timed_loop(torch, lambda: exchange_halo(T, model.grid, out=pad), 100),
            diffusion_interior=time_ms(lambda: [kernels.fused_step_cm_faces(
                T, none, Cm, sp, box=b, out=res_out) for b in inner], 100),
            diffusion_slabs=time_ms(lambda: [kernels.fused_step_cm_faces(
                T, faces, Cm, sp, box=b, out=res_out) for b in slabs], 100),
            diffusion_slabs_padded=time_ms(lambda: [kernels.fused_step_cm_region(
                pad, 1, Cm, sp, b, res_out) for b in slabs], 100),
            wave_interior=time_ms(lambda: [wave.wave_step_masked_region(
                U, 0, Uprev, M, Cw, sp, b, res_out) for b in inner], 100),
            wave_slabs=time_ms(lambda: [wave.wave_step_masked_region(
                pad, 1, Uprev, M, Cw, sp, b, res_out) for b in slabs], 100),
        )
        # The shallow water exchanges three leaves and launches each box once
        # for all of them.
        sstate = _leaves(sgot["perf"][0].h, sgot["perf"][0].us)
        spads = tuple(torch.zeros_like(pad) for _ in sstate)
        souts = tuple(torch.empty_like(t) for t in sstate)
        Mus = smodel.face_masks()
        parts["swe_exchange"] = _timed_loop(torch, lambda: [
            exchange_halo(t, smodel.grid, out=p) for t, p in zip(sstate, spads)], 100)
        parts["swe_interior"] = time_ms(lambda: [swe.swe_step_region(
            sstate, 0, b, Mus, smodel.coeffs, souts) for b in inner], 100)
        parts["swe_slabs"] = time_ms(lambda: [swe.swe_step_region(
            spads, 1, b, Mus, smodel.coeffs, souts) for b in slabs], 100)
        out["parts_ms"] = parts
    return out


def phase_hide(card, gpus: int):
    """Diffusion, wave and shallow-water `hide` beside `perf` on the 2×2
    grid of 12288²: 4 ranks sharing one card over gloo, or one per card
    over NCCL."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, region_boxes

    nt, warmup = (SHARD_NT, SHARD_WARMUP) if gpus == 1 else (BIG_NT, MAIN_WARMUP)
    spec = dict(shape=BIG, nt=nt, warmup=warmup, gpus=gpus)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, hide_rank, (spec,), backend=backend, timeout=420)
    local = BLOCK
    n_boxes = len(region_boxes(local, effective_b_width(local, HIDE_B_WIDTH)))
    expect = {("diffusion", "perf"): only("fused_step_cm", nt),
              ("diffusion", "hide"): only("fused_step_cm", n_boxes * nt),
              ("wave", "perf"): only("wave_step", nt),
              ("wave", "hide"): only("wave_step_masked", n_boxes * nt),
              ("swe", "perf"): only("swe_step", nt),
              ("swe", "hide"): only("swe_step", n_boxes * nt)}
    for r in ranks:
        for (model, variant), launches in expect.items():
            got = r[model][variant]
            check(got["launches"] == launches,
                  f"hide phase rank {r['rank']} {model} {variant}: launches "
                  f"{got['launches']}, expected {launches}")
            check(got["bitwise"] and got["finite"],
                  f"hide phase rank {r['rank']} {model} {variant}: kernel run != "
                  "plain-version run or not finite")
        check(r["diffusion"]["hide_eq_perf"],
              f"hide phase rank {r['rank']}: diffusion hide != perf")
        check(r["diffusion"]["hide_padded"]["bitwise"],
              f"hide phase rank {r['rank']}: diffusion hide != its padded route")
        check(r["swe"]["hide_eq_perf"],
              f"hide phase rank {r['rank']}: shallow-water hide != perf")
    where = (f"4 ranks sharing {card} (gloo, halo slabs staged through host memory: "
             "correctness only, the times are not a multi-GPU measurement)" if gpus == 1
             else f"4 GPUs, one rank each, NCCL ({card} each)")
    r0 = ranks[0]
    for model in ("diffusion", "wave", "swe"):
        h, p = r0[model]["hide"], r0[model]["perf"]
        extra = (f"; hide - perf max |diff| {r0['wave']['hide_minus_perf']:.3e}"
                 if model == "wave" else "; hide field bitwise == perf field")
        if model == "diffusion":
            extra += ("; the face exchange and the slabs from the shard and its faces, "
                      "bitwise == the padded route (hide "
                      f"{r0['diffusion']['hide_padded']['ms_per_step']:.5f} ms/step there)")
        print(f"[hide] {model} {BIG[0]}x{BIG[1]} f32 on a 2x2 grid, b_width {HIDE_B_WIDTH}, "
              f"{n_boxes} region launches per step per rank, {where}, {nt} steps ({warmup} "
              f"warmup): each shard bitwise == plain-version run (hide and perf){extra}; "
              f"rank 0 hide {h['ms_per_step']:.5f} ms/step, perf {p['ms_per_step']:.5f} "
              "ms/step", flush=True)
    if gpus > 1:
        for r in ranks:
            print(f"[hide] rank {r['rank']} parts alone (ms): " + ", ".join(
                f"{k} {v:.5f}" for k, v in r["parts_ms"].items())
                + f"; diffusion hide {r['diffusion']['hide']['ms_per_step']:.5f}, perf "
                f"{r['diffusion']['perf']['ms_per_step']:.5f}; wave hide "
                f"{r['wave']['hide']['ms_per_step']:.5f}, perf "
                f"{r['wave']['perf']['ms_per_step']:.5f}; swe hide "
                f"{r['swe']['hide']['ms_per_step']:.5f}, perf "
                f"{r['swe']['perf']['ms_per_step']:.5f} ms/step on {card}", flush=True)
    totals = {"fused_step_cm": sum(r["diffusion"]["hide"]["launches"]["fused_step_cm"]
                                   for r in ranks),
              "wave_step": sum(r["wave"]["perf"]["launches"]["wave_step"] for r in ranks),
              "wave_step_masked": sum(r["wave"]["hide"]["launches"]["wave_step_masked"]
                                      for r in ranks),
              "swe_step": sum(r["swe"][v]["launches"]["swe_step"] for r in ranks
                              for v in ("perf", "hide"))}
    return ranks, totals


def wave_deep_rank(rank, spec):
    """One rank of the sharded wave deep phase (started by spawn_ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape, k = tuple(spec["shape"]), spec["k"]
    cfg = WaveConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"], dtype="f32",
                     dims=(2, 2))
    model = AcousticWave(cfg, device=device)
    kernels.reset_launches()
    with watch_loops() as loops:
        res = model.run_deep(block_steps=k)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ref = plain_wave_schedule(model, "run_deep", k, cfg.nt)
    out = dict(rank=rank, launches=launches, route=res.route, k=res.k,
               bitwise=bool(torch.equal(res.U, ref)), finite=bool(torch.isfinite(res.U).all()),
               ms_per_step=res.wtime_it * 1e3, gpts=res.gpts,
               **graph_against_eager(torch, model, "run_deep", res, (res.U,), k,
                                     f"wave deep rank {rank}", loops))
    del loops
    full = gather_to_host0(res.U, model.grid)
    if rank == 0:
        # The same schedule over the whole domain on one GPU at the same k:
        # every core cell takes the same k steps from the same neighbours.
        one = _wave_model(shape, cfg.nt, cfg.warmup, device=device)
        advance, k1 = one.deep_advance_fn(block_steps=k)
        U1 = advance(*one.init_state(), cfg.nt)[0].cpu().numpy()
        out["one_gpu"] = dict(route=advance.schedule.route, k=k1)
        out["max_abs_vs_one_gpu"] = float(np.abs(full - U1).max())
        out["bitwise_vs_one_gpu"] = bool(np.array_equal(full, U1))
    return out


def phase_wave_deep(card, gpus: int):
    """The wave's run_deep on the 2×2 grid of 480² (k = 8, 256² padded
    shards on the vmem route): each shard bitwise against its plain
    version, the gathered field bitwise against the one-GPU run_deep."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup, k = SHARD_DEEP_NT, SHARD_DEEP_WARMUP, WAVE_DEEP_K
    spec = dict(shape=WAVE_DEEP_SHARDED, nt=nt, warmup=warmup, k=k, gpus=gpus)
    ranks = spawn_ranks(4, wave_deep_rank, (spec,), backend="gloo" if gpus == 1 else "nccl",
                        timeout=600)
    loop_route = "scan-loop" if gpus == 1 else "scan-graph"
    for r in ranks:
        check((r["route"], r["k"], r["loop_route"]) == ("vmem", k, loop_route),
              f"wave deep rank {r['rank']}: route {r['route']} k {r['k']} loop "
              f"{r['loop_route']}")
        check(r["launches"] == only("wave_multi_step", nt // k),
              f"wave deep rank {r['rank']}: launches {r['launches']}")
        check(r["bitwise"] and r["finite"],
              f"wave deep rank {r['rank']}: kernel run != plain-version run or not finite")
    r0 = ranks[0]
    check(r0["one_gpu"] == {"route": "vmem", "k": k}, f"one-GPU wave deep took {r0['one_gpu']}")
    check(r0["bitwise_vs_one_gpu"], "sharded 2x2 wave deep field differs from the one-GPU "
          f"run_deep by {r0['max_abs_vs_one_gpu']}")
    total = sum(r["launches"]["wave_multi_step"] for r in ranks)
    n = WAVE_DEEP_SHARDED[0]
    where = "gloo, one shared card" if gpus == 1 else "NCCL, 4 GPUs"
    print(f"[wave-deep] run_deep {n}x{n} f32 on a 2x2 grid ({where}), {nt} steps ({warmup} "
          f"warmup): route vmem, k {k}, wave_multi_step launches {total} ({nt // k} per "
          "rank); each shard bitwise == plain-version run; gathered field bitwise == the "
          f"one-GPU run_deep ({n + 2 * k}x{n + 2 * k} padded, vmem); every shard bitwise == "
          f"the eager sweep loop; rank 0 {_loop_line(r0)} on {card}", flush=True)
    return ranks, total


def swe_deep_rank(rank, spec):
    """One rank of the sharded shallow-water deep phase (started by
    spawn_ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import SWEConfig
    from rocm_mpi_tpu_torch.models import ShallowWater
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.gather import gather_to_host0

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape, k = tuple(spec["shape"]), spec["k"]
    cfg = SWEConfig(global_shape=shape, nt=spec["nt"], warmup=spec["warmup"], dtype="f32",
                    dims=(2, 2))
    model = ShallowWater(cfg, device=device)
    kernels.reset_launches()
    with watch_loops() as loops:
        res = model.run_deep(block_steps=k)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    got = _leaves(res.h, res.us)
    ref = _leaves(*plain_swe_schedule(model, "run_deep", k, cfg.nt))
    out = dict(rank=rank, launches=launches, route=res.route, k=res.k,
               bitwise=_same(got, ref)[0],
               finite=all(bool(torch.isfinite(t).all()) for t in got),
               ms_per_step=res.wtime_it * 1e3, gpts=res.gpts,
               **graph_against_eager(torch, model, "run_deep", res, got, k,
                                     f"swe deep rank {rank}", loops))
    del loops
    full = [gather_to_host0(t, model.grid) for t in got]
    if rank == 0:
        # The same schedule over the whole domain on one GPU at the same k:
        # its 496² block is over the admission, so the jnp route computes
        # the same operations in the same order as the kernel.
        one = _swe_model(shape, cfg.nt, cfg.warmup, device=device)
        advance, k1 = one.deep_advance_fn(block_steps=k)
        h0, us0 = one.init_state()
        mass0 = float(h0.sum(dtype=torch.float64))
        ones = [t.cpu().numpy() for t in _leaves(*advance(h0, us0, None, cfg.nt))]
        out["one_gpu"] = dict(route=advance.schedule.route, k=k1)
        out["max_abs_vs_one_gpu"] = max(float(np.abs(a - b).max()) for a, b in zip(full, ones))
        out["bitwise_vs_one_gpu"] = all(np.array_equal(a, b) for a, b in zip(full, ones))
        out["mass_drift"] = abs(float(full[0].astype(np.float64).sum()) - mass0) / abs(mass0)
    return out


def phase_swe_deep(card, gpus: int):
    """The shallow water's run_deep on the 2×2 grid of 480² (k = 8, 256²
    padded shards on the vmem route): each shard bitwise against its plain
    version, the gathered state bitwise against the one-GPU run_deep."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    nt, warmup, k = SHARD_DEEP_NT, SHARD_DEEP_WARMUP, WAVE_DEEP_K
    spec = dict(shape=WAVE_DEEP_SHARDED, nt=nt, warmup=warmup, k=k, gpus=gpus)
    ranks = spawn_ranks(4, swe_deep_rank, (spec,), backend="gloo" if gpus == 1 else "nccl",
                        timeout=600)
    loop_route = "scan-loop" if gpus == 1 else "scan-graph"
    for r in ranks:
        check((r["route"], r["k"], r["loop_route"]) == ("vmem", k, loop_route),
              f"swe deep rank {r['rank']}: route {r['route']} k {r['k']} loop "
              f"{r['loop_route']}")
        check(r["launches"] == only("swe_multi_step", nt // k),
              f"swe deep rank {r['rank']}: launches {r['launches']}")
        check(r["bitwise"] and r["finite"],
              f"swe deep rank {r['rank']}: kernel run != plain-version run or not finite")
    r0 = ranks[0]
    check(r0["one_gpu"] == {"route": "jnp", "k": k}, f"one-GPU swe deep took {r0['one_gpu']}")
    check(r0["bitwise_vs_one_gpu"], "sharded 2x2 swe deep state differs from the one-GPU "
          f"run_deep by {r0['max_abs_vs_one_gpu']}")
    check(r0["mass_drift"] <= SWE_MASS_BOUND["f32"],
          f"sharded 2x2 swe deep: mass drift {r0['mass_drift']}")
    total = sum(r["launches"]["swe_multi_step"] for r in ranks)
    n = WAVE_DEEP_SHARDED[0]
    where = "gloo, one shared card" if gpus == 1 else "NCCL, 4 GPUs"
    print(f"[swe-deep] run_deep {n}x{n} f32 on a 2x2 grid ({where}), {nt} steps ({warmup} "
          f"warmup): route vmem, k {k}, swe_multi_step launches {total} ({nt // k} per "
          "rank); each shard bitwise == plain-version run; gathered state bitwise == the "
          f"one-GPU run_deep ({n + 2 * k}x{n + 2 * k} padded, jnp route); mass drift "
          f"{r0['mass_drift']:.3e}; every shard bitwise == the eager sweep loop; rank 0 "
          f"{_loop_line(r0)} on {card}", flush=True)
    return ranks, total


# ---------------------------------------------------------------------------
# 3D at 128³ a device, and checkpointed runs
# ---------------------------------------------------------------------------


def _cube_model(shape, nt, warmup, dims=(1, 1, 1), b_width=(8, 8, 128), device="cuda"):
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion

    cfg = DiffusionConfig(global_shape=shape, lengths=(10.0,) * 3, nt=nt, warmup=warmup,
                          dtype="f32", dims=dims, b_width=b_width)
    return HeatDiffusion(cfg, device=device)


def _cube_rates(pk, res, cells_per_device: int, passes: int = 3) -> dict:
    """ms/step, Gpts/s a device and the share of one device's bytes bound
    (`passes` f32 passes over its cells a step) of a run."""
    ms = res.wtime_it * 1e3
    bound = passes * cells_per_device * 4 / pk["bytes_per_s"] * 1e3
    return dict(ms_per_step=ms, gpts=res.gpts, bound_ms=bound, of_bound=bound / ms,
                capture_ms=res.capture_ms, loop_route=res.loop_route)


def phase_3d(torch, card, pk):
    """[3d], one card: BASELINE.json's diffusion_3D_perf_hide at 128³ f32 —
    `perf` under the scan driver's graphs (masked_step in 3D), run_deep
    k = 8 as graphs of sweeps (the jnp route) and run_hbm_blocked k = 8
    as graphs of sweeps (the 3D tb_sweep, one launch a sweep), each
    bitwise against its plain-version run with its launches counted, the
    schedules also against their eager sweep loops; the 3D tb_sweep at
    k = 16 on 160³ bitwise its plain version; then the 3D app itself."""
    from rocm_mpi_tpu_torch.ops import kernels

    cells = math.prod(CUBE)
    model = _cube_model(CUBE, CUBE_NT, CUBE_WARMUP)
    kernels.reset_launches()
    res = model.run("perf", driver="scan")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches == only("masked_step", CUBE_NT),
          f"3D perf 128³: launches {launches}, expected {CUBE_NT} masked_step")
    check(res.route == "scan-graph", f"3D perf 128³: scan route {res.route}")
    T, Cp = model.init_state()
    Cm = model.prepare_fn("perf")(Cp)
    inv_d2 = kernels.inv_d2_of(model.config.spacing)
    for _ in range(CUBE_NT):
        T = kernels.masked_step_plain(T, Cm, inv_d2)
    check(torch.equal(res.T, T), "3D perf 128³: kernel run != plain-version run")
    perf = dict(launches=launches, q=res.k, **_cube_rates(pk, res, cells))
    print(f"[3d] perf 128x128x128 f32, {CUBE_NT - CUBE_WARMUP} steps after {CUBE_WARMUP}, "
          f"scan driver (route {res.route}, q {res.k}, capture {res.capture_ms:.1f} host ms): "
          f"masked_step launches {launches['masked_step']}; bitwise == plain-version run; "
          f"{perf['ms_per_step']:.5f} ms/step, {res.gpts:.3f} Gpts/s, bytes bound "
          f"{perf['bound_ms']:.5f} ms ({perf['of_bound']:.3f} of it) on {card}", flush=True)
    del res, T, Cm

    # run_deep k = 8: the 144³ padded block is past the VMEM budget, and its
    # 32-row slab (2.65 MB) past the temporal-blocked sweep's 2.5 MB slab
    # budget, so the JAX package's rule (deep_halo.local_route) takes the
    # "jnp" route: k plain steps a sweep, no kernel, under the graphs.
    model = _cube_model(CUBE, CUBE_DEEP_NT, CUBE_DEEP_WARMUP)
    kernels.reset_launches()
    with watch_loops() as loops:
        res = model.run_deep(block_steps=8)
    torch.cuda.synchronize()
    dlaunches = dict(kernels.LAUNCHES)
    check((res.route, res.k, res.loop_route) == ("jnp", 8, "scan-graph"),
          f"3D run_deep 128³: route {res.route} k {res.k} loop {res.loop_route}")
    check(dlaunches == only("tb_sweep", 0),
          f"3D run_deep 128³ (jnp route): launches {dlaunches}, expected none")
    T, Cp = model.init_state()
    ref = plain_deep(model, T, Cp, CUBE_DEEP_NT, 8, res.route)
    check(torch.equal(res.T, ref), "3D run_deep 128³: graph run != plain-version run")
    deep = {"launches": dlaunches, "route": res.route, **_cube_rates(pk, res, cells),
            **graph_against_eager(torch, model, "run_deep", res, (res.T,), 8,
                                  "3D run_deep 128³", loops)}
    print(f"[3d] run_deep 128x128x128 f32 k 8: route {res.route} (the JAX rule: the 144³ "
          f"block's 32-row slab exceeds the tb_sweep slab budget; plain steps, no kernel), "
          f"{CUBE_DEEP_NT - CUBE_DEEP_WARMUP} steps after {CUBE_DEEP_WARMUP}, graphs of "
          f"sweeps: bitwise == plain-version run and == the eager sweep loop; "
          f"{_loop_line(deep)}; {res.gpts:.3f} Gpts/s on {card}", flush=True)
    del res, T, ref, loops

    # run_hbm_blocked k = 8: 128³'s 32-plane slab (2.1 MB) is within the
    # slab budget, so each sweep is one launch of the 3D tb_sweep.
    model = _cube_model(CUBE, CUBE_DEEP_NT, CUBE_DEEP_WARMUP)
    kernels.reset_launches()
    with watch_loops() as loops:
        res = model.run_hbm_blocked(block_steps=8)
    torch.cuda.synchronize()
    hlaunches = dict(kernels.LAUNCHES)
    check((res.route, res.k, res.loop_route) == ("hbm-tb", 8, "scan-graph"),
          f"3D run_hbm_blocked 128³: route {res.route} k {res.k} loop {res.loop_route}")
    check(hlaunches == only("tb_sweep", CUBE_DEEP_NT // 8),
          f"3D run_hbm_blocked 128³: launches {hlaunches}, expected {CUBE_DEEP_NT // 8} tb_sweep")
    ref = plain_schedule(model, "run_hbm_blocked", res.route, 8, CUBE_DEEP_NT)
    check(torch.equal(res.T, ref), "3D run_hbm_blocked 128³: graph run != plain-version run")
    hbm = {"launches": hlaunches, "route": res.route, **_cube_rates(pk, res, cells),
           **graph_against_eager(torch, model, "run_hbm_blocked", res, (res.T,), 8,
                                 "3D run_hbm_blocked 128³", loops)}
    hbm["per_step_over_perf"] = hbm["ms_per_step"] / perf["ms_per_step"]
    print(f"[3d] run_hbm_blocked 128x128x128 f32 k 8: route {res.route}, "
          f"{CUBE_DEEP_NT - CUBE_DEEP_WARMUP} steps after {CUBE_DEEP_WARMUP}, graphs of sweeps: "
          f"tb_sweep launches {hlaunches['tb_sweep']} (one a sweep); bitwise == plain-version "
          f"run and == the eager sweep loop; {_loop_line(hbm)}; {hbm['ms_per_step']:.5f} "
          f"ms/step against perf's {perf['ms_per_step']:.5f} ({hbm['per_step_over_perf']:.3f} "
          f"of it), {res.gpts:.3f} Gpts/s on {card}", flush=True)
    del res, ref, loops

    # k = 16 in 3D on 128³ grown by its k = 16 ghosts: one launch, bitwise.
    from rocm_mpi_tpu_torch.ops import multistep

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T16 = torch.rand(tuple(n + 32 for n in CUBE), generator=gen, device="cuda")
    Cm16 = torch.rand(T16.shape, generator=gen, device="cuda") * 1e-4
    inv16 = kernels.inv_d2_of((0.1,) * 3)
    kernels.reset_launches()
    got = multistep.tb_sweep(T16, Cm16, inv16, 16)
    want = multistep.tb_sweep_plain(T16, Cm16, inv16, 16)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["tb_sweep"] == 1 and torch.equal(got, want),
          "3D tb_sweep k 16 on 160³: kernel != plain version")
    plan16 = multistep._device_plan3(0, tuple(T16.shape), 16, torch.float32)
    k16 = dict(ms=time_ms(lambda: multistep.tb_sweep(T16, Cm16, inv16, 16), 10),
               plain_ms=time_ms(lambda: multistep.tb_sweep_plain(T16, Cm16, inv16, 16), 3),
               plan=plan16._asdict())
    print(f"[3d] tb_sweep k 16 on 160³ (128³ with its ghosts) f32: bitwise == plain version; "
          f"{k16['ms']:.4f} ms, plain {k16['plain_ms']:.4f} ms; tile {plan16.e1}x{plan16.e2}, "
          f"{plan16.threads} threads, {plan16.segments} segments of {plan16.seg} on {card}",
          flush=True)
    del T16, Cm16, got, want

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    app_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the 3D app failed (rc {proc.returncode}):\n{proc.stdout}\n"
          f"{proc.stderr}")
    lines = proc.stdout.splitlines()
    executed = next((ln for ln in lines if ln.startswith("Executed 100 steps")), None)
    check(executed is not None and any("clamped to (8, 8, 64)" in ln for ln in lines),
          f"the 3D app printed no run line or clamp:\n{proc.stdout}")
    print(f"[3d] python -m rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide (its defaults: "
          f"128³ f32, 100 steps with 10 warmup, b_width (8, 8, 128)) in {app_s:.1f} s: "
          + next(ln for ln in lines if "clamped to" in ln), flush=True)
    print(f"[3d]   {executed}", flush=True)
    return dict(perf=perf, deep=deep, hbm=hbm, k16=k16, app_line=executed,
                app_seconds=app_s)


# [3d] on four cards: (label, variant, b_width), the padded routes the face
# exchange replaced last (register_padded_variants), their yardstick.
THREE_D_RUNS = (("perf", "perf", APP_B_WIDTH_3D),
                ("hide app b_width", "hide", APP_B_WIDTH_3D),
                ("hide (8, 8, 8)", "hide", HIDE_B_WIDTH_3D),
                ("perf, padded route", "perf-padded", APP_B_WIDTH_3D),
                ("hide (8, 8, 8), padded route", "hide-padded", HIDE_B_WIDTH_3D))


def three_d_rank(rank, spec):
    """One rank of [3d] on four cards (started by spawn_ranks): the 2×2×1
    grid of 256×256×128, 128³ a rank, over NCCL — perf, hide at two
    shells, run_deep k = 8 — each against its plain-version run."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    shape, dims = tuple(spec["shape"]), tuple(spec["dims"])
    out = dict(rank=rank, runs={})
    perf_T = None
    for label, variant, bw in THREE_D_RUNS:
        model = _cube_model(shape, CUBE_NT, CUBE_WARMUP, dims=dims, b_width=bw, device=device)
        register_padded_variants(model)
        kernels.reset_launches()
        res = model.run(variant, driver="scan")
        torch.cuda.synchronize()
        got = dict(launches=dict(kernels.LAUNCHES), route=res.route,
                   ms_per_step=res.wtime_it * 1e3, capture_ms=res.capture_ms,
                   finite=bool(torch.isfinite(res.T).all()))
        if variant == "perf":
            T, Cp = model.init_state()
            Cm = model.prepare_fn("perf")(Cp)
            inv_d2 = kernels.inv_d2_of(model.config.spacing)
            pad = torch.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype, device=device)
            for _ in range(CUBE_NT):
                T = kernels.fused_step_cm_plain(exchange_halo(T, model.grid, out=pad), Cm,
                                                inv_d2)
            got["bitwise"] = bool(torch.equal(res.T, T))
            perf_T = res.T
            del T, Cm, pad
        else:
            got["bitwise"] = bool(torch.equal(res.T, perf_T))  # hide == perf == plain
        out["runs"][label] = got
        out["local"] = model.grid.local_shape
    model = _cube_model(shape, CUBE_DEEP_NT, CUBE_DEEP_WARMUP, dims=dims, device=device)
    kernels.reset_launches()
    res = model.run_deep(block_steps=8)
    torch.cuda.synchronize()
    T, Cp = model.init_state()
    ref = plain_deep(model, T, Cp, CUBE_DEEP_NT, 8, res.route)
    out["runs"]["deep"] = dict(launches=dict(kernels.LAUNCHES), route=res.route, k=res.k,
                               loop_route=res.loop_route, ms_per_step=res.wtime_it * 1e3,
                               capture_ms=res.capture_ms, bitwise=bool(torch.equal(res.T, ref)),
                               finite=bool(torch.isfinite(res.T).all()))
    return out


def phase_3d_sharded(card, gpus: int):
    """[3d], four cards: 2×2×1 of 256×256×128 over NCCL (the z faces are
    the domain's: they exchange nothing; the 6-face exchange is held by
    the CPU tests on 8 gloo ranks), then the 3D app under torchrun."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, ghost_free, region_boxes

    spec = dict(shape=CUBE_SHARDED, dims=CUBE_DIMS, gpus=gpus)
    ranks = spawn_ranks(4, three_d_rank, (spec,), backend="nccl", timeout=600)
    boxes = {}
    for label, bw in (("hide app b_width", APP_B_WIDTH_3D), ("hide (8, 8, 8)", HIDE_B_WIDTH_3D)):
        eff = effective_b_width(CUBE, bw)
        regions = region_boxes(CUBE, eff)
        boxes[label] = (eff, len(regions), sum(ghost_free(b, CUBE) for b in regions))
    expect = {"perf": only("fused_step_cm", CUBE_NT),
              "perf, padded route": only("fused_step_cm", CUBE_NT),
              "deep": only("tb_sweep", 0)}  # the jnp route: no kernel
    for label, (_, n_boxes, _) in boxes.items():
        expect[label] = only("fused_step_cm", n_boxes * CUBE_NT)
    expect["hide (8, 8, 8), padded route"] = expect["hide (8, 8, 8)"]
    for r in ranks:
        check(tuple(r["local"]) == CUBE, f"[3d] rank {r['rank']} shard {r['local']}")
        for label, got in r["runs"].items():
            check(got["launches"] == expect[label],
                  f"[3d] rank {r['rank']} {label}: launches {got['launches']}, expected "
                  f"{expect[label]}")
            check(got["bitwise"] and got["finite"],
                  f"[3d] rank {r['rank']} {label}: not bitwise its plain-version run (hide: "
                  "perf's field) or not finite")
        check(r["runs"]["perf"]["route"] == "scan-graph"
              and (r["runs"]["deep"]["route"], r["runs"]["deep"]["loop_route"])
              == ("jnp", "scan-graph"),
              f"[3d] rank {r['rank']}: routes {r['runs']['perf']['route']}, "
              f"{r['runs']['deep']['route']}, {r['runs']['deep']['loop_route']}")
    r0 = ranks[0]["runs"]
    for label, (eff, n, inner) in boxes.items():
        print(f"[3d] {label}: b_width clamped to {eff} on 128³: {inner} interior box(es), "
              f"{n - inner} slab box(es), {n} fused_step_cm region launches a step", flush=True)
    print(f"[3d] 2x2x1 of 256x256x128 f32 (128³ a rank), 4 GPUs, NCCL ({card} each), "
          f"{CUBE_NT - CUBE_WARMUP} steps after {CUBE_WARMUP} under the scan driver's graphs: "
          "every rank bitwise its plain-version run, hide bitwise perf, the padded route "
          "bitwise the face route; rank 0 ms/step perf "
          f"{r0['perf']['ms_per_step']:.5f} (padded route "
          f"{r0['perf, padded route']['ms_per_step']:.5f}), hide app b_width "
          f"{r0['hide app b_width']['ms_per_step']:.5f}, hide (8, 8, 8) "
          f"{r0['hide (8, 8, 8)']['ms_per_step']:.5f} (padded route "
          f"{r0['hide (8, 8, 8), padded route']['ms_per_step']:.5f}); run_deep k 8 (jnp "
          "route, graphs of "
          f"sweeps, {CUBE_DEEP_NT - CUBE_DEEP_WARMUP} after {CUBE_DEEP_WARMUP}) "
          f"{r0['deep']['ms_per_step']:.5f}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide", "--nx", "256", "--ny",
         "256", "--nz", "128", "--dims", "2,2,1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    app_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the 3D app under torchrun failed (rc {proc.returncode}):\n"
          f"{proc.stdout}\n{proc.stderr[-4000:]}")
    executed = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("Executed 100 steps")), None)
    check(executed is not None, f"the 3D app under torchrun printed no run line:\n{proc.stdout}")
    print(f"[3d] torchrun --nproc-per-node 4 -m rocm_mpi_tpu_torch.apps.diffusion_3d_perf_hide "
          f"--nx 256 --ny 256 --nz 128 --dims 2,2,1 in {app_s:.1f} s: {executed}", flush=True)
    return dict(ranks=ranks, boxes=boxes, app_line=executed, app_seconds=app_s)


def _crash_and_resume(torch, make, nt: int, every: int, crash: int, directory,
                      grid=None):
    """A straight run of `nt` steps, then a run checkpointed every `every`
    steps that "crashes" after `crash`, and a fresh model resumed from
    latest_valid_step to `nt`. `make()` -> (advance(state, n) -> state,
    initial state); each call is a fresh model. Returns (straight,
    resumed, facts), the launches of the crashed and resumed runs
    counted with the counts set to 0 just before each."""
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    adv, state = make()
    straight = tuple(t.clone() for t in ckpt.tree_leaves(adv(state, nt)))
    del adv, state
    adv, state = make()
    ckpt._SAVE_WALLS.clear()
    kernels.reset_launches()
    ckpt.run_segmented(adv, state, crash, directory, every, grid=grid)
    torch.cuda.synchronize()
    crashed = dict(kernels.LAUNCHES)
    loop = getattr(adv, "loop", None)
    graphs = None if loop is None else len(loop.graphs)
    del adv, state
    adv, like = make()
    latest = ckpt.latest_valid_step(directory, grid=grid)
    check(latest == crash, f"latest_valid_step {latest}, expected {crash}")
    t0 = time.perf_counter()
    restored = ckpt.restore_state(directory, latest, like, grid=grid)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(all(r.data_ptr() != t.data_ptr() and r.device == t.device for r, t in
              zip(ckpt.tree_leaves(restored), ckpt.tree_leaves(like))),
          "restore_state returned a tensor of the template or off its device")
    del like
    kernels.reset_launches()
    final = ckpt.run_segmented(adv, restored, nt, directory, every, start_step=latest, grid=grid)
    torch.cuda.synchronize()
    resumed = dict(kernels.LAUNCHES)
    manifest = ckpt.read_manifest(directory, nt)
    facts = dict(save_ms=[w * 1e3 for w in ckpt._SAVE_WALLS], restore_ms=restore_ms,
                 bytes_per_save=sum(manifest["files"].values()) if manifest else None,
                 graphs_captured=graphs, crashed_launches=crashed, resumed_launches=resumed,
                 bitwise=all(torch.equal(a, b) for a, b in
                             zip(ckpt.tree_leaves(final), straight)))
    return straight, final, facts


def _ckpt_text(f) -> str:
    saves = f["save_ms"]
    return (f"save {statistics.median(saves):.1f} ms (median of {len(saves)}; "
            f"{f['bytes_per_save'] / 1e6:.1f} MB a save), restore {f['restore_ms']:.1f} ms")


def phase_checkpoint(torch, card):
    """[checkpoint], one card: checkpointed runs that "crash" and resume
    into a fresh model, bitwise the straight run — diffusion perf 12288²
    under the scan driver (exact segments), run_deep k = 8 with an
    interval rounded to the quantum, SWE perf 252² f64 (a tuple state) —
    then a truncated newest step (skipped) and a flipped byte (refused)."""
    import tempfile

    from rocm_mpi_tpu_torch.apps._common import checkpoint_interval
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    out = {}
    root = tempfile.mkdtemp(prefix="rmt-ckpt-")
    try:
        def diffusion(kind):
            def make():
                model = HeatDiffusion(DiffusionConfig(global_shape=BIG, nt=CKPT_NT, warmup=0,
                                                      dtype="f32", dims=(1, 1)), device="cuda")
                T, Cp = model.init_state()
                if kind == "deep":
                    advance, k = model.deep_advance_fn(block_steps=8, nt=CKPT_NT, warmup=0)
                    route = advance.schedule.route_of(torch.float32)
                    check(k == 8 and route == "hbm-tb", f"checkpoint deep: k {k} route {route}")
                else:
                    advance, _ = model.scan_advance_fn("perf", nt=CKPT_EVERY, warmup=0,
                                                       exact=True)

                def seg(s, n):
                    return (advance(s[0], Cp, n),)

                seg.loop = advance.loop
                return seg, (T,)

            return make

        _, _, f = _crash_and_resume(torch, diffusion("perf"), CKPT_NT, CKPT_EVERY,
                                    CKPT_CRASH, f"{root}/perf")
        check(f["bitwise"], "checkpoint perf 12288²: the resumed run != the straight run")
        check(f["crashed_launches"] == only("masked_step", CKPT_CRASH)
              and f["resumed_launches"] == only("masked_step", CKPT_NT - CKPT_CRASH),
              f"checkpoint perf: launches {f['crashed_launches']}, {f['resumed_launches']}")
        out["perf"] = f
        print(f"[checkpoint] perf 12288x12288 f32, scan driver with exact segments "
              f"({f['graphs_captured']} graph(s) captured for the run), {CKPT_NT} steps every "
              f"{CKPT_EVERY}: crashed after {CKPT_CRASH}, resumed from latest_valid_step into a "
              f"fresh model: bitwise == the straight run; masked_step launches "
              f"{CKPT_CRASH} + {CKPT_NT - CKPT_CRASH}; {_ckpt_text(f)} on {card}", flush=True)
        shutil.rmtree(f"{root}/perf", ignore_errors=True)

        said = []
        every = checkpoint_interval(argparse.Namespace(ckpt_every=10, nt=CKPT_NT), 8,
                                    said.append)
        check(every == 16 and said and "rounded to 16" in said[0],
              f"--ckpt-every 10 with k 8 gave {every} ({said})")
        _, _, f = _crash_and_resume(torch, diffusion("deep"), CKPT_NT, every,
                                    CKPT_CRASH, f"{root}/deep")
        check(f["bitwise"], "checkpoint run_deep 12288²: the resumed run != the straight run")
        check(f["crashed_launches"] == only("tb_sweep", CKPT_CRASH // 8)
              and f["resumed_launches"] == only("tb_sweep", (CKPT_NT - CKPT_CRASH) // 8),
              f"checkpoint deep: launches {f['crashed_launches']}, {f['resumed_launches']}")
        out["deep"] = f
        print(f"[checkpoint] run_deep 12288x12288 f32 k 8 (hbm-tb), {said[0]}: crashed after "
              f"{CKPT_CRASH}, resumed: bitwise == the straight run; tb_sweep launches "
              f"{CKPT_CRASH // 8} + {(CKPT_NT - CKPT_CRASH) // 8}; {_ckpt_text(f)} on {card}",
              flush=True)
        shutil.rmtree(f"{root}/deep", ignore_errors=True)

        def swe():
            model = _swe_model(SMALL, CKPT_NT, 0, dtype="f64")
            h, us = model.init_state()
            Mus = model.face_masks()
            advance, _ = model.scan_advance_fn("perf", nt=CKPT_EVERY, warmup=0, exact=True)

            def seg(s, n):
                return tuple(advance(s[0], s[1], Mus, n))

            seg.loop = advance.loop
            return seg, (h, us)

        straight, final, f = _crash_and_resume(torch, swe, CKPT_NT, CKPT_EVERY,
                                               CKPT_CRASH, f"{root}/swe")
        check(f["bitwise"], "checkpoint SWE 252² f64: the resumed run != the straight run")
        check(f["crashed_launches"] == only("swe_step", CKPT_CRASH)
              and f["resumed_launches"] == only("swe_step", CKPT_NT - CKPT_CRASH),
              f"checkpoint SWE: launches {f['crashed_launches']}, {f['resumed_launches']}")
        h0 = _swe_model(SMALL, CKPT_NT, 0, dtype="f64").init_state()[0]
        f["mass_drift"] = float(abs(final[0].double().sum() - h0.double().sum())
                                / h0.double().sum())
        check(f["mass_drift"] <= SWE_MASS_BOUND["f64"], f"checkpoint SWE mass drift "
              f"{f['mass_drift']}")
        out["swe"] = f
        print(f"[checkpoint] SWE perf 252x252 f64, state (h, (u0, u1)), {CKPT_NT} steps every "
              f"{CKPT_EVERY}: crashed after {CKPT_CRASH}, resumed: bitwise == the straight "
              f"run; swe_step launches {CKPT_CRASH} + {CKPT_NT - CKPT_CRASH}; mass drift "
              f"{f['mass_drift']:.3e}; {_ckpt_text(f)} on {card}", flush=True)

        # Corruption: a truncated newest step is skipped; a flipped byte
        # (sizes intact) is refused at restore.
        d = f"{root}/swe"
        leaf = pathlib.Path(d) / str(CKPT_NT) / "rank-0" / "leaf-0.npy"
        leaf.write_bytes(leaf.read_bytes()[:-100])
        lines = []
        fallback = ckpt.latest_valid_step(d, log=lines.append)
        check(fallback == CKPT_CRASH and lines,
              f"a truncated step {CKPT_NT}: latest_valid_step gave {fallback}")
        leaf = pathlib.Path(d) / str(CKPT_CRASH) / "rank-0" / "leaf-1.npy"
        raw = bytearray(leaf.read_bytes())
        raw[-3] ^= 0x10
        leaf.write_bytes(bytes(raw))
        try:
            ckpt.restore_state(d, CKPT_CRASH, _swe_model(SMALL, CKPT_NT, 0, "f64").init_state())
        except ckpt.CheckpointCorruptionError as err:
            refused = str(err)
        else:
            raise PhaseError("a flipped byte was restored without complaint")
        out["corruption"] = dict(fallback=fallback, refused=refused)
        print(f"[checkpoint] corruption: step {CKPT_NT} truncated -> latest_valid_step falls "
              f"back to {fallback} ({lines[0][:90]}); a flipped byte in step {CKPT_CRASH} -> "
              f"CheckpointCorruptionError ({refused[:90]})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def checkpoint_rank(rank, spec):
    """One rank of [checkpoint] on four cards: 2×2 of 12288² perf under the
    scan driver's graphs over NCCL, each rank saving its 6144² shard."""
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    dist.barrier()
    grid = init_global_grid(*BIG, dims=(2, 2))

    def make():
        model = HeatDiffusion(DiffusionConfig(global_shape=BIG, nt=CKPT_NT, warmup=0,
                                              dtype="f32", dims=(2, 2)), grid=grid,
                              device=device)
        T, Cp = model.init_state()
        advance, _ = model.scan_advance_fn("perf", nt=CKPT_EVERY, warmup=0, exact=True)

        def seg(s, n):
            return (advance(s[0], Cp, n),)

        seg.loop = advance.loop
        return seg, (T,)

    _, _, f = _crash_and_resume(torch, make, CKPT_NT, CKPT_EVERY, CKPT_CRASH, spec["dir"],
                                grid=grid)
    return dict(rank=rank, **f)


def phase_checkpoint_sharded(card, gpus: int):
    """[checkpoint], four cards: every rank resumes bitwise."""
    import tempfile

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="rmt-ckpt-") as d:
        ranks = spawn_ranks(4, checkpoint_rank, (dict(gpus=gpus, dir=d),), backend="nccl",
                            timeout=600)
    for r in ranks:
        check(r["bitwise"], f"[checkpoint] rank {r['rank']}: resumed != straight")
        check(r["crashed_launches"] == only("fused_step_cm", CKPT_CRASH)
              and r["resumed_launches"] == only("fused_step_cm", CKPT_NT - CKPT_CRASH),
              f"[checkpoint] rank {r['rank']}: launches {r['crashed_launches']}, "
              f"{r['resumed_launches']}")
        check(r["graphs_captured"], f"[checkpoint] rank {r['rank']}: no graph captured")
    r0 = ranks[0]
    print(f"[checkpoint] perf 2x2 of 12288x12288 f32, 4 GPUs, NCCL ({card} each), scan "
          f"driver's graphs with exact segments ({r0['graphs_captured']} graph(s) a rank), "
          f"{CKPT_NT} steps every {CKPT_EVERY}, each rank saving its 6144² shard: crashed after "
          f"{CKPT_CRASH}, resumed: every rank bitwise == its straight run; rank 0 "
          f"{_ckpt_text(r0)} (all four shards: {r0['bytes_per_save'] / 1e6:.1f} MB)",
          flush=True)
    return ranks


# ---------------------------------------------------------------------------
# The resilience plane: supervised restarts, preemption, storage, elastic
# ---------------------------------------------------------------------------


def _res_model(torch, nt: int, every: int):
    """(advance(state, n) -> state, (T,)): diffusion perf at 12288² f32 on
    one card, the scan driver with exact segments of `every` steps — the
    advance the app's checkpoint mode builds. Each call is a fresh model."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion

    model = HeatDiffusion(DiffusionConfig(global_shape=BIG, nt=nt, warmup=0, dtype="f32",
                                          dims=(1, 1)), device="cuda")
    T, Cp = model.init_state()
    advance, _ = model.scan_advance_fn("perf", nt=every, warmup=0, exact=True)

    def seg(s, n):
        return (advance(s[0], Cp, n),)

    seg.loop = advance.loop
    return seg, (T,)


def _supervised_drill(torch, spec: str, directory) -> dict:
    """One drill of [resilience] (a)/(b): the app's checkpoint mode with
    --retries 2 --inject-fault `spec` (apps/_common.checkpointed_run, so
    resilience.run_supervised), CKPT_NT steps saved every CKPT_EVERY, on
    a fresh model; the launches counted from 0, the graph captures
    counted, the supervisor's lines timed."""
    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.apps import _common
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.telemetry import compiles

    args = _common.make_parser("perf", nx=BIG[0], ny=BIG[1], nt=CKPT_NT, dtype="f32").parse_args(
        ["--nt", str(CKPT_NT), "--warmup", "0", "--checkpoint", str(directory),
         "--ckpt-every", str(CKPT_EVERY), "--retries", "2", "--inject-fault", spec])
    _common.setup_resilience(args)
    seg, init = _res_model(torch, CKPT_NT, CKPT_EVERY)
    lines, ends = [], []

    def log(msg):
        lines.append((time.perf_counter(), msg))

    def timed(s, n):
        out = seg(s, n)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    captured = []
    real_capture = compiles.record_capture
    compiles.record_capture = lambda label, s: (captured.append(label), real_capture(label, s))
    telemetry.clear_events()
    kernels.reset_launches()
    try:
        state, ran, _ = _common.checkpointed_run(args, timed, init, log)
        torch.cuda.synchronize()
    finally:
        compiles.record_capture = real_capture
        faults.install(None)
    launched = dict(kernels.LAUNCHES)
    failed_t = next(t for t, msg in lines if "failed" in msg)
    restored = next(msg for _, msg in lines if "restored step" in msg)
    return dict(state=state, ran=ran, launches=launched, captures=len(captured),
                graphs=len(seg.loop.graphs), restored=int(restored.split("restored step ")[1]
                                                          .split()[0]),
                events=[r["name"] for r in telemetry.records(kind="event")],
                recovery_s=next(t for t in ends if t > failed_t) - failed_t)


def _preempt_child(d, tel, nt: int, grace: float | None, resume: bool = False):
    """The diffusion perf app at 12288² f32 as a child process,
    checkpointing into `d` every PREEMPT_EVERY steps with its telemetry in
    `tel`; `grace` sets RMT_PREEMPT_GRACE_S. Started, not waited for."""
    env = dict(os.environ)
    env.pop("RMT_PREEMPT_GRACE_S", None)
    if grace is not None:
        env["RMT_PREEMPT_GRACE_S"] = str(grace)
    cmd = [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.diffusion_2d_perf", "--nt", str(nt),
           "--warmup", "0", "--checkpoint", str(d), "--ckpt-every", str(PREEMPT_EVERY),
           "--telemetry", str(tel)] + (["--resume"] if resume else [])
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _child_events(tel) -> list[dict]:
    path = pathlib.Path(tel) / "telemetry-rank0.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [r for r in recs if r.get("kind") == "event"]


def _preempt_drill(torch, root, grace: float) -> dict:
    """[resilience] (c): SIGTERM to the app child once its first save is
    on disk (the next boundary is ~0.6 s away), with a grace of `grace`
    seconds; returns its exit code, the steps on disk and its events."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    d, tel = pathlib.Path(root) / f"pre-{grace}", pathlib.Path(root) / f"tel-{grace}"
    child = _preempt_child(d, tel, PREEMPT_NT, grace)
    try:
        first = d / f"manifest-{PREEMPT_EVERY}.json"
        deadline = time.monotonic() + 300
        while not first.exists() and child.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.1)  # out of the save, into the next segment
        t_signal = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=300)
        exit_s = time.perf_counter() - t_signal
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    events = _child_events(tel)
    return dict(rc=child.returncode, steps=ckpt.all_steps(d), dir=d,
                partial=sorted(p.name for p in d.glob(".*.partial")),
                events=[e["name"] for e in events], exit_s=exit_s,
                detail={e["name"]: e for e in events}, stderr=err[-2000:], stdout=out[-2000:])


def phase_resilience(torch, card):
    """[resilience], one card: drills (a)-(d) (module docstring), each
    bitwise against the straight run of its length. Returns the record,
    with the drills' masked_step launches."""
    import tempfile

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    out = {"launches": {name: 0 for name in kernels.LAUNCHES}}
    root = tempfile.mkdtemp(prefix="rmt-res-")
    try:
        seg, init = _res_model(torch, CKPT_NT, CKPT_EVERY)
        straight = seg((init[0].clone(),), CKPT_NT)[0].clone()
        torch.cuda.synchronize()
        del seg, init
        ckpt._SAVE_WALLS.clear()
        for name, spec, restored, launched in (
                ("crash", f"crash@step={CKPT_CRASH}", CKPT_CRASH, CKPT_NT),
                ("truncate", f"truncate-latest@step={CKPT_CRASH};crash@step={CKPT_CRASH}",
                 CKPT_CRASH - CKPT_EVERY, CKPT_NT + CKPT_EVERY)):
            f = _supervised_drill(torch, spec, f"{root}/{name}")
            check(torch.equal(f.pop("state")[0], straight),
                  f"[resilience] {name}: the supervised run != the straight run")
            for ev in ("attempt-failed", "backoff", "restored", "recovered"):
                check(ev in f["events"], f"[resilience] {name}: no {ev} event ({f['events']})")
            check(f["restored"] == restored, f"[resilience] {name}: restored {f['restored']}")
            check(f["captures"] == f["graphs"] and f["graphs"] >= 1,
                  f"[resilience] {name}: {f['captures']} captures for {f['graphs']} graph(s)")
            check(f["launches"] == only("masked_step", launched),
                  f"[resilience] {name}: launches {f['launches']}")
            out["launches"]["masked_step"] += f["launches"]["masked_step"]
            out[name] = f
            print(f"[resilience] ({'a' if name == 'crash' else 'b'}) perf 12288x12288 f32, "
                  f"--checkpoint --ckpt-every {CKPT_EVERY} --retries 2 --inject-fault '{spec}' "
                  f"({CKPT_NT} steps): restored step {restored}, bitwise == the straight run; "
                  f"events {' '.join(f['events'])}; {f['captures']} graph capture(s) for "
                  f"{f['graphs']} graph(s) (the retry captured none); masked_step launches "
                  f"{f['launches']['masked_step']}; recovery wall {f['recovery_s']:.3f} s "
                  f"(the failure to the first segment after the restore, the 0.5 s backoff "
                  f"included) on {card}", flush=True)
            shutil.rmtree(f"{root}/{name}", ignore_errors=True)

        # (c) preemption: the emergency save, then the skip.
        seg, init = _res_model(torch, PREEMPT_NT, PREEMPT_EVERY)
        straight_long = seg((init[0].clone(),), PREEMPT_NT)[0].clone()
        torch.cuda.synchronize()
        del seg, init
        saved, skipped = (_preempt_drill(torch, root, g) for g in PREEMPT_GRACES)
        pre = 2 * PREEMPT_EVERY
        check(saved["rc"] == 75, f"[resilience] preempted child (grace 30 s) exited "
              f"{saved['rc']}:\n{saved['stderr']}")
        check(saved["steps"] == [PREEMPT_EVERY, pre] and not saved["partial"],
              f"[resilience] grace 30 s: steps on disk {saved['steps']} {saved['partial']}")
        check("preempt.noticed" in saved["events"] and "preempt.save" in saved["events"],
              f"[resilience] grace 30 s: events {saved['events']}")
        p90 = saved["detail"]["preempt.save"]["save_wall_p90_s"]
        res_dir = saved["dir"]
        resumed = _preempt_child(res_dir, pathlib.Path(root) / "tel-resume", PREEMPT_NT, None,
                                 resume=True)
        rout, rerr = resumed.communicate(timeout=600)
        check(resumed.returncode == 0, f"[resilience] the --resume child exited "
              f"{resumed.returncode}:\n{rerr[-2000:]}")
        (final,) = ckpt.restore_state(res_dir, PREEMPT_NT, None, devices="cuda")
        check(torch.equal(final, straight_long),
              "[resilience] preempted and resumed != straight")
        manifest_bytes = sum(ckpt.read_manifest(res_dir, PREEMPT_NT)["files"].values())
        del final, straight_long
        check(skipped["rc"] == 75, f"[resilience] preempted child (grace 0.2 s) exited "
              f"{skipped['rc']}:\n{skipped['stderr']}")
        check(skipped["steps"] == [PREEMPT_EVERY] and not skipped["partial"],
              f"[resilience] grace 0.2 s: steps on disk {skipped['steps']} "
              f"{skipped['partial']} (a torn or extra step)")
        check("preempt.skip-save" in skipped["events"] and "preempt.save" not in
              skipped["events"], f"[resilience] grace 0.2 s: events {skipped['events']}")
        skip = skipped["detail"]["preempt.skip-save"]
        out["preempt"] = dict(saved={k: v for k, v in saved.items() if k != "dir"},
                              skipped={k: v for k, v in skipped.items() if k != "dir"})
        print(f"[resilience] (c) SIGTERM to the perf app (12288x12288 f32, {PREEMPT_NT} steps "
              f"saved every {PREEMPT_EVERY}) after its first save: RMT_PREEMPT_GRACE_S 30 -> "
              f"the emergency save at step {pre} (p90 save wall {p90:.3f} s), exit 75 "
              f"{saved['exit_s']:.2f} s after the signal, --resume to {PREEMPT_NT} bitwise == "
              f"the straight run; RMT_PREEMPT_GRACE_S 0.2 -> preempt.skip-save (grace left "
              f"{skip['remaining_grace_s']:.3f} s < 1.5 x p90 {skip['save_wall_p90_s']:.3f} s), "
              f"exit 75 after {skipped['exit_s']:.2f} s, steps on disk {skipped['steps']}, no "
              f"torn step directory; on {card}", flush=True)

        # (d) a storage outage: the fault plan's storage kind at the save site.
        from rocm_mpi_tpu_torch import telemetry

        seg, init = _res_model(torch, CKPT_NT, CKPT_EVERY)
        telemetry.clear_events()
        faults.install(f"io-error@step={CKPT_EVERY},times=3")
        kernels.reset_launches()
        try:
            got = ckpt.run_segmented(seg, init, CKPT_NT, f"{root}/outage", CKPT_EVERY)
            torch.cuda.synchronize()
        finally:
            faults.install(None)
        check(kernels.LAUNCHES == only("masked_step", CKPT_NT),
              f"[resilience] (d) launches {kernels.LAUNCHES}")
        out["launches"]["masked_step"] += kernels.LAUNCHES["masked_step"]
        names = [r["name"] for r in telemetry.records(kind="event")]
        check(torch.equal(got[0], straight),
              "[resilience] (d) the run through the outage != straight")
        check(names.count("ckpt.retry") == 2 and "ckpt.degraded" in names
              and "ckpt.recovered" in names, f"[resilience] (d) events {names}")
        steps = ckpt.all_steps(f"{root}/outage")
        check(steps == [2 * CKPT_EVERY, CKPT_NT], f"[resilience] (d) steps on disk {steps}")
        out["outage"] = dict(events=names, steps=steps)
        walls = sorted(ckpt._SAVE_WALLS)
        out["save_wall_p90_s"] = ckpt.save_wall_p90()
        out["bytes_per_save"] = manifest_bytes
        print(f"[resilience] (d) io-error@step={CKPT_EVERY},times=3 over a {CKPT_NT}-step run: "
              f"2 retries, degraded at step {CKPT_EVERY}, recovered at {2 * CKPT_EVERY}; steps "
              f"on disk {steps}; the result bitwise unchanged. This process's save walls: p90 "
              f"{out['save_wall_p90_s']:.3f} s over {len(walls)} saves of "
              f"{manifest_bytes / 1e6:.1f} MB; on {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _elastic_app_argv(directory, nt: int) -> list[str]:
    """The perf app at 12288² f32, checkpointed and resumable: each
    launch of an elastic run resumes from the latest valid step on its
    own grid."""
    return ["-m", "rocm_mpi_tpu_torch.apps.diffusion_2d_perf", "--nt", str(nt), "--warmup",
            "0", "--checkpoint", str(directory), "--ckpt-every", str(ELASTIC_EVERY), "--resume"]


def _snapshot(directory, dest) -> int | None:
    """Copy `directory`'s latest valid step (and its manifest) into
    `dest`: the checkpoint a continuation twin starts from."""
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    step = ckpt.latest_valid_step(directory)
    if step is not None:
        dest = pathlib.Path(dest)
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copytree(pathlib.Path(directory) / str(step), dest / str(step))
        shutil.copy2(pathlib.Path(directory) / f"manifest-{step}.json", dest)
    return step


def _twin_crcs(start_dir, nprocs: int, nt: int) -> list:
    """Continue the checkpoint in `start_dir` to `nt` on `nprocs` ranks
    (the same app, the same launcher), and return the shard crc32s of its
    step-`nt` save, in rank order."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    res = spawn_app_ranks(_elastic_app_argv(start_dir, nt), nprocs=nprocs, timeout=600,
                          peer_grace_s=10.0)
    for rank, (p, (out, err)) in enumerate(res):
        check(p.returncode == 0, f"[elastic] twin rank {rank} exited {p.returncode}:\n"
              f"{err[-2000:]}")
    return [s["crc32"] for s in ckpt.read_manifest(start_dir, nt)["shards"]]


def _elastic_drill(root, name, spec, budget=None, timeout=900) -> dict:
    """One run_elastic drill on four cards (each launch cut at `timeout`
    s); every launch's results, start time and the snapshot of the
    checkpoint it left are kept, and each launch's first step after its
    resume point is timed from the health sidecars."""
    import threading

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks
    from rocm_mpi_tpu_torch.resilience import ElasticPolicy, run_elastic
    from rocm_mpi_tpu_torch.telemetry import health

    ck, hdir = pathlib.Path(root) / name, pathlib.Path(root) / f"{name}-health"
    launches = []

    def launch(argv, nprocs, **kw):
        rec = dict(nprocs=nprocs, start=time.monotonic(), first_step=None)
        from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

        resume = ckpt.latest_valid_step(ck) or 0
        stop = threading.Event()

        def first_step():
            while not stop.is_set():
                beats, _ = health.load_heartbeats(hdir)
                steps = [b.get("counters", {}).get("step", 0) for b in beats.values()]
                if any(s > resume for s in steps):
                    rec["first_step"] = time.monotonic()
                    return
                stop.wait(0.05)

        watcher = threading.Thread(target=first_step, daemon=True)
        chained = kw.get("on_spawn")

        def on_spawn(procs):
            # After the launcher cleared the last launch's sidecars.
            watcher.start()
            if chained is not None:
                chained(procs)

        kw["on_spawn"] = on_spawn
        try:
            rec["results"] = spawn_app_ranks(argv, nprocs=nprocs, **kw)
        finally:
            stop.set()
            if watcher.is_alive():
                watcher.join(timeout=5)
        rec["end"] = time.monotonic()
        rec["resume"] = resume
        rec["snapshot_step"] = _snapshot(ck, pathlib.Path(root) / f"{name}-snap{len(launches)}")
        launches.append(rec)
        return rec["results"]

    kwargs = dict(device_budget=budget, policy=ElasticPolicy(grow_poll_s=0.2)) if budget else {}
    report = run_elastic(_elastic_app_argv(ck, ELASTIC_NT), 4, checkpoint_dir=ck,
                         global_shape=BIG, health_dir=hdir, inject_fault=spec, launch=launch,
                         timeout=timeout, heartbeat_s=5.0, peer_grace_s=5.0, stall_grace_s=8.0,
                         postmortem_grace_s=1.0, vanish_grace_s=6.0, **kwargs)
    # No rank outlives its launch.
    for rec in launches:
        for p, _ in rec["results"]:
            check(p.poll() is not None and p.pid not in children(),
                  f"[elastic] {name}: rank pid {p.pid} outlived its launch")
    events, skipped = health.load_elastic_events(hdir)
    return dict(report=report, launches=launches, ck=ck, events=events, skipped=skipped)


def _fault_to_first_step(drill) -> float:
    """Seconds from the fault (the first launch's first failure, or its
    watchdog kill) to the next launch's first step past its resume point."""
    first, second = drill["launches"][:2]
    report = first["results"].report
    t_fault = first["start"] + report.first_failure[2]
    if report.watchdog_verdicts:  # the stall began that long before the kill
        t_fault -= report.watchdog_verdicts[0]["stalled_for_s"]
    check(second["first_step"] is not None, "[elastic] the relaunch never stepped")
    return second["first_step"] - t_fault


def phase_elastic(card, gpus: int):
    """[elastic], four cards: drills (a)-(c) (module docstring)."""
    import tempfile

    check(gpus == 4, "[elastic] needs 4 GPUs")
    out = {}
    # The ranks' host threads: a save's host copy and crc32 is their only
    # CPU work, and four ranks of the host's default thread count would
    # contend for its cores while the watchdog times their progress.
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(max((os.cpu_count() or 4) // gpus, 1))
    try:
        with tempfile.TemporaryDirectory(prefix="rmt-elastic-") as root:
            _elastic_drills(root, card, out)
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return out


def _elastic_drills(root, card, out) -> None:
    """[elastic]'s drills (a)-(c) in `root`, their records into `out`."""
    for drill in (_elastic_die, _elastic_stall, _elastic_crash):
        drill(root, card, out)


def _elastic_die(root, card, out) -> None:
    """(a) die, shrink to plan_dims's sub-grid, grow back to 2x2."""
    from rocm_mpi_tpu_torch.parallel.mesh import plan_dims
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    sub = list(plan_dims(BIG, 3))
    t0 = time.perf_counter()
    d = _elastic_drill(root, "die", f"die@step={ELASTIC_FAULT},rank=3", budget=4)
    rep = d["report"]
    dims = [launch["mesh"] for launch in rep.launches]
    check([launch["nprocs"] for launch in rep.launches] == [4, 3, 4]
          and dims == [[2, 2], sub, [2, 2]] and rep.shrinks == 1 and rep.grows == 1,
          f"[elastic] die: launches {rep.launches}")
    _, shrunk, grown = d["launches"]
    check("vanished" in rep.launches[0]["reason"] and rep.launches[0]["dead_ranks"] == [3],
          f"[elastic] die: {rep.launches[0]}")
    check(shrunk["resume"] == ELASTIC_FAULT, f"[elastic] die: resumed {shrunk['resume']}")
    grow_step = grown["resume"]
    check(rep.launches[1]["status"] == "preempted" and grow_step > ELASTIC_FAULT
          and grow_step % ELASTIC_EVERY == 0, f"[elastic] die: grew at {grow_step}")
    # Each grid's saves == a continuation twin's on the same grid.
    sub_crcs = _twin_crcs(pathlib.Path(root) / "die-snap0", 3, grow_step)
    got = [s["crc32"] for s in ckpt.read_manifest(pathlib.Path(root) / "die-snap1",
                                                  grow_step)["shards"]]
    check(got == sub_crcs, f"[elastic] die: the {sub} run's step-{grow_step} shards != "
          "the continuation twin's")
    full_crcs = _twin_crcs(pathlib.Path(root) / "die-snap1", 4, ELASTIC_NT)
    got = [s["crc32"] for s in ckpt.read_manifest(d["ck"], ELASTIC_NT)["shards"]]
    check(got == full_crcs, f"[elastic] die: the grown run's step-{ELASTIC_NT} shards != "
          "the 2x2 continuation twin's")
    fault_s = _fault_to_first_step(d)
    out["die"] = dict(launches=rep.launches, grow_step=grow_step, fault_to_step_s=fault_s,
                      records=len(d["events"]), seconds=time.perf_counter() - t0)
    print(f"[elastic] (a) perf 2x2 of 12288x12288 f32, 4 GPUs, NCCL ({card} each), the app "
          f"through spawn_app_ranks and run_elastic (device_budget 4), "
          f"die@step={ELASTIC_FAULT},rank=3: launches dims {dims} (resume steps "
          f"{[launch['resume'] for launch in d['launches']]}); the vanish judged "
          f"'{rep.launches[0]['reason']}', shrunk to plan_dims's {sub}, resumed from step "
          f"{ELASTIC_FAULT} through the reshard restore, bitwise == the {sub} continuation "
          f"twin at step {grow_step}; grown back to 2x2 at step {grow_step} (rc "
          f"{rep.launches[1]['returncodes']}), bitwise == the 2x2 twin at step "
          f"{ELASTIC_NT}; the fault to the next first step {fault_s:.2f} s; elastic.jsonl "
          f"{len(d['events'])} records; {out['die']['seconds']:.1f} s", flush=True)


def _elastic_stall(root, card, out) -> None:
    """(b) stall at the pre-save site: the watchdog names rank 1 by
    progress."""
    t0 = time.perf_counter()
    d = _elastic_drill(root, "stall", f"stall@step={ELASTIC_FAULT},rank=1,at=segment-pre")
    rep = d["report"]
    first = d["launches"][0]["results"].report
    verdict = first.watchdog_verdicts[0] if first.watchdog_verdicts else {}
    check(rep.launches[0]["reason"] == "watchdog-stall" and verdict.get("rank") == 1
          and verdict["step"] < verdict["median_step"],
          f"[elastic] stall: {rep.launches[0]} {first.watchdog_verdicts}")
    check(any("bundled post-mortem for rank(s) [1]" in e for e in first.events),
          f"[elastic] stall: no post-mortem bundle ({first.events})")
    check([launch["nprocs"] for launch in rep.launches] == [4, 3] and rep.shrinks == 1
          and rep.launches[-1]["ok"], f"[elastic] stall: launches {rep.launches}")
    check(d["launches"][1]["resume"] == ELASTIC_FAULT - ELASTIC_EVERY,
          f"[elastic] stall: resumed {d['launches'][1]['resume']}")
    fault_s = _fault_to_first_step(d)
    out["stall"] = dict(launches=rep.launches, verdict=verdict, fault_to_step_s=fault_s,
                        records=len(d["events"]), seconds=time.perf_counter() - t0)
    print(f"[elastic] (b) stall@step={ELASTIC_FAULT},rank=1,at=segment-pre: the watchdog "
          f"named rank {verdict['rank']} (step {verdict['step']} against the median "
          f"{verdict['median_step']}, no progress for {verdict['stalled_for_s']} s), wrote "
          f"the post-mortem bundle; shrunk to {rep.launches[1]['mesh']}, resumed from step "
          f"{d['launches'][1]['resume']} and completed; the fault to the next first step "
          f"{fault_s:.2f} s; elastic.jsonl {len(d['events'])} records; "
          f"{out['stall']['seconds']:.1f} s; no rank outlived its launch", flush=True)


def _elastic_crash(root, card, out) -> None:
    """(c) crash on one rank, no retries, while its peers wait on it over
    NCCL: it must exit first, on its own (apps/_common.finalized). A
    teardown that waited for the peers would hold the launch to its cut
    (short here) with no first failure."""
    from rocm_mpi_tpu_torch.parallel.mesh import plan_dims
    from rocm_mpi_tpu_torch.utils import checkpoint as ckpt

    sub = list(plan_dims(BIG, 3))
    t0 = time.perf_counter()
    d = _elastic_drill(root, "crash", f"crash@step={ELASTIC_FAULT},rank=3", timeout=150)
    rep = d["report"]
    first = d["launches"][0]
    res = first["results"]
    failure = res.report.first_failure
    rcs = [p.returncode for p, _ in res]
    check(failure is not None and failure[0] == 3 and failure[1] > 0 and rcs[3] == failure[1],
          f"[elastic] crash: first failure {failure}, returncodes {rcs}, rank 3's "
          f"stderr:\n{res[3][1][1][-2000:]}")
    check("InjectedCrash" in res[3][1][1], "[elastic] crash: rank 3 did not crash by the "
          f"injected fault:\n{res[3][1][1][-2000:]}")
    launch_s = first["end"] - first["start"]
    check(launch_s - failure[2] <= 5.0 + 10.0,
          f"[elastic] crash: the launch ended {launch_s - failure[2]:.2f} s after rank 3's "
          "exit, past the 5 s peer grace")
    check([launch["nprocs"] for launch in rep.launches] == [4, 3]
          and rep.launches[1]["mesh"] == sub and rep.shrinks == 1
          and rep.launches[0]["dead_ranks"] == [3] and rep.launches[-1]["ok"],
          f"[elastic] crash: launches {rep.launches}")
    check(d["launches"][1]["resume"] == ELASTIC_FAULT,
          f"[elastic] crash: resumed {d['launches'][1]['resume']}")
    crcs = _twin_crcs(pathlib.Path(root) / "crash-snap0", 3, ELASTIC_NT)
    got = [s["crc32"] for s in ckpt.read_manifest(d["ck"], ELASTIC_NT)["shards"]]
    check(got == crcs, f"[elastic] crash: the {sub} run's step-{ELASTIC_NT} shards != the "
          "continuation twin's")
    fault_s = _fault_to_first_step(d)
    out["crash"] = dict(launches=rep.launches, first_failure=list(failure), returncodes=rcs,
                        reaped_after_s=launch_s - failure[2], fault_to_step_s=fault_s,
                        records=len(d["events"]), seconds=time.perf_counter() - t0)
    print(f"[elastic] (c) crash@step={ELASTIC_FAULT},rank=3, no retries ({card} each): rank 3 "
          f"printed its traceback and exited rc {failure[1]} first, "
          f"{failure[2]:.2f} s into its launch; returncodes {rcs}, the launch over "
          f"{launch_s - failure[2]:.2f} s after (peer grace 5 s); judged "
          f"'{rep.launches[0]['reason']}', shrunk to {rep.launches[1]['mesh']}, resumed from "
          f"step {d['launches'][1]['resume']}, bitwise == the {sub} continuation twin at step "
          f"{ELASTIC_NT}; the fault to the next first step {fault_s:.2f} s; elastic.jsonl "
          f"{len(d['events'])} records; {out['crash']['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# The transport plane: ring, host-staged oracle, wire modes, dry run
# ---------------------------------------------------------------------------


def phase_host_facts(card):
    """[host] the machine a multi-card number was taken on: hostname,
    driver, NCCL version and the cards' topology (nvidia-smi topo -m)."""
    import socket

    import torch

    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi not found")

    def smi_out(*args):
        out = subprocess.run([smi, *args], capture_output=True, text=True, check=False)
        return out.stdout.strip()

    driver = smi_out("--query-gpu=driver_version", "--format=csv,noheader").splitlines()
    version = torch.cuda.nccl.version()
    nccl = ".".join(map(str, version)) if isinstance(version, tuple) else str(version)
    topo = smi_out("topo", "-m")
    facts = dict(hostname=socket.gethostname(), driver=driver[0] if driver else None,
                 nccl=nccl, cards=torch.cuda.device_count(), card=card, topo=topo)
    print(f"[host] hostname {facts['hostname']}, driver {facts['driver']}, NCCL {nccl}, "
          f"{facts['cards']} card(s) visible ({card}); nvidia-smi topo -m:", flush=True)
    for line in topo.splitlines():
        print(f"[host]   {line}", flush=True)
    return facts


def ring_round_us(torch, ring_exchange, x, rounds: int) -> float:
    """Median µs of one ring round of `x` between two CUDA events, over
    `rounds` rounds queued back to back after 20 untimed ones."""
    from rocm_mpi_tpu_torch.parallel import distributed

    for _ in range(20):
        x = ring_exchange(x)
    torch.cuda.synchronize()
    distributed.barrier()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(rounds)]
    for start, end in pairs:
        start.record()
        x = ring_exchange(x)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def ring_rank(rank, spec):
    """One rank of [ring]: the demo's left-neighbour check, then the round
    times at 16 bytes and at one halo row."""
    import torch

    from rocm_mpi_tpu_torch.parallel import distributed
    from rocm_mpi_tpu_torch.parallel.ring import ring_exchange, ring_exchange_demo

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    distributed.barrier()
    n = distributed.world_size()
    sent, received = ring_exchange_demo(4, device=device)
    expect = (rank - 1) % n
    out = dict(rank=rank, device=str(device), sent=sent.tolist(), received=received.tolist(),
               ok=bool((received == expect).all()) and received.is_cuda, expect=expect)
    small = torch.full((4,), float(rank), device=device)  # 16 bytes
    slab = torch.full((RING_SLAB,), float(rank), device=device)
    out["us_16B"] = ring_round_us(torch, ring_exchange, small, RING_ROUNDS)
    out["us_slab"] = ring_round_us(torch, ring_exchange, slab, RING_ROUNDS)
    return out


def phase_ring(torch, card, gpus: int):
    """[ring] the ring smoke test: one rank (the identity) in this process,
    then 4 ranks — sharing this card over gloo, or one a card over NCCL —
    each asserting its left neighbour, with the round's median µs at 16 B
    and at a 6144-element f32 slab."""
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.parallel.ring import ring_exchange_demo

    sent, received = ring_exchange_demo(4, device="cuda")
    check(torch.equal(sent, received) and received.data_ptr() != sent.data_ptr(),
          "one-rank ring is not a copy of the buffer")
    print(f"[ring] one rank: sent {sent.tolist()} received {received.tolist()} (the "
          "identity, a copy)", flush=True)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, ring_rank, (dict(gpus=gpus),), backend=backend, timeout=300)
    for r in ranks:
        check(r["ok"], f"ring rank {r['rank']}: received {r['received']}, expected "
              f"{float(r['expect'])} (its left neighbour)")
    where = (f"4 ranks sharing {card} (gloo, staged through host memory: not a multi-GPU "
             "measurement)" if gpus == 1 else f"4 GPUs, one rank each, NCCL ({card} each)")
    for r in ranks:
        print(f"[ring] rank {r['rank']} on {r['device']}: sent {r['sent']} received "
              f"{r['received']} (left neighbour {r['expect']}) ok; a round (median of "
              f"{RING_ROUNDS}, CUDA events): {r['us_16B']:.2f} us at 16 B, "
              f"{r['us_slab']:.2f} us at {RING_SLAB} f32 ({RING_SLAB * 4} B)", flush=True)
    print(f"[ring] 4-rank ring over {where}: every rank holds its left neighbour's rank; "
          f"slowest rank's median round {max(r['us_16B'] for r in ranks):.2f} us at 16 B, "
          f"{max(r['us_slab'] for r in ranks):.2f} us at {RING_SLAB} f32", flush=True)
    return ranks


def _host_vs_device(torch, cfg, device):
    """run("shard") through the host-staged oracle and run("perf") on the
    card for `cfg`: (host result, device result, device launches)."""
    import dataclasses

    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels

    host = HeatDiffusion(dataclasses.replace(cfg, halo_transport="host"), device=device)
    res_h = host.run("shard")
    kernels.reset_launches()
    res_d = HeatDiffusion(dataclasses.replace(cfg, halo_transport="ici"),
                          device=device).run("perf")
    torch.cuda.synchronize()
    return res_h, res_d, dict(kernels.LAUNCHES)


def _max_rel(torch, got, ref) -> tuple[float, bool]:
    """(max |got − ref| / max |ref|, allclose at HOST_TOL) in f64 on this
    rank's shard."""
    got, ref = got.double(), ref.double()
    rel = float((got - ref).abs().max() / ref.abs().max())
    return rel, bool(torch.allclose(got, ref, **HOST_TOL))


def host_staged_rank(rank, spec):
    """One rank of [host-staged] on the 2×2 grid: the host-staged run
    against the device perf run on this shard."""
    import torch

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.parallel import distributed

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    distributed.barrier()
    cfg = DiffusionConfig(global_shape=HOST_SHAPE, nt=HOST_NT, warmup=HOST_WARMUP,
                          dtype="f32", dims=(2, 2))
    res_h, res_d, launches = _host_vs_device(torch, cfg, device)
    rel, close = _max_rel(torch, res_h.T, res_d.T)
    return dict(rank=rank, route=res_h.route, rel=rel, close=close, launches=launches,
                host_ms=res_h.wtime_it * 1e3, device_ms=res_d.wtime_it * 1e3,
                on_card=res_h.T.is_cuda)


def phase_host_staged(torch, card, gpus: int):
    """[host-staged] run("shard") with halo_transport="host" against the
    device perf run: on this card alone (f32 and f64) and on 4 ranks of
    the 2×2 grid; the native engine bitwise against the numpy stepper, each
    one's ms per step, at 2×2 of 512² f64."""
    import numpy as np

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.parallel import native_halo, wire
    from rocm_mpi_tpu_torch.parallel.halo import HostStagedStepper
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    out = {"one_card": {}}
    launches = {name: 0 for name in ("masked_step", "fused_step_cm")}
    if gpus == 1:
        for dtype in ("f32", "f64"):
            cfg = DiffusionConfig(global_shape=HOST_SHAPE, nt=HOST_NT, warmup=HOST_WARMUP,
                                  dtype=dtype, dims=(1, 1))
            res_h, res_d, counts = _host_vs_device(torch, cfg, "cuda")
            rel, close = _max_rel(torch, res_h.T, res_d.T)
            check(res_h.route == "host-staged" and res_h.T.is_cuda,
                  f"host-staged run took route {res_h.route} on {res_h.T.device}")
            check(counts == only("masked_step", HOST_NT),
                  f"one-card perf beside the oracle: launches {counts}")
            check(close, f"one-card host-staged {dtype} run differs from the device perf run "
                  f"by {rel:.3e} (relative), beyond rtol {HOST_TOL['rtol']}")
            launches["masked_step"] += counts["masked_step"]
            out["one_card"][dtype] = dict(rel=rel, host_ms=res_h.wtime_it * 1e3,
                                          device_ms=res_d.wtime_it * 1e3)
            print(f"[host-staged] one card, {HOST_SHAPE[0]}x{HOST_SHAPE[1]} {dtype}, "
                  f"{HOST_NT} steps ({HOST_WARMUP} warmup): run(\"shard\") through the "
                  f"host-staged oracle within rtol {HOST_TOL['rtol']} / atol "
                  f"{HOST_TOL['atol']} of run(\"perf\") on the card (max rel diff {rel:.3e}); "
                  f"{res_h.wtime_it * 1e3:.4f} ms/step on the host against "
                  f"{res_d.wtime_it * 1e3:.5f} on {card}", flush=True)
    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, host_staged_rank, (dict(gpus=gpus),), backend=backend, timeout=300)
    for r in ranks:
        check(r["route"] == "host-staged" and r["on_card"],
              f"host-staged rank {r['rank']}: route {r['route']}")
        check(r["launches"] == only("fused_step_cm", HOST_NT),
              f"host-staged rank {r['rank']}: perf launches {r['launches']}")
        check(r["close"], f"host-staged rank {r['rank']}: shard differs from the device perf "
              f"run by {r['rel']:.3e} (relative)")
        launches["fused_step_cm"] += r["launches"]["fused_step_cm"]
    where = ("4 ranks sharing the card (gloo)" if gpus == 1
             else f"4 GPUs, NCCL ({card} each)")
    print(f"[host-staged] 2x2 of {HOST_SHAPE[0]}x{HOST_SHAPE[1]} f32 on {where}: every "
          f"shard of the host-staged run within rtol {HOST_TOL['rtol']} of the device perf "
          f"run (max rel diff {max(r['rel'] for r in ranks):.3e}); rank 0 "
          f"{ranks[0]['host_ms']:.4f} ms/step host-staged, {ranks[0]['device_ms']:.5f} "
          "device", flush=True)
    out["ranks"] = ranks

    # The native engine against the numpy stepper: bitwise, and timed.
    check(native_halo.available(), "the native halostage engine did not build (g++)")
    grid = wire.OracleGrid(HOST_SHAPE, (2, 2), tuple(10.0 / n for n in HOST_SHAPE))
    rng = np.random.default_rng(SEED)
    T0, Cp = rng.random(HOST_SHAPE), 1.0 + rng.random(HOST_SHAPE)
    dt = min(d * d for d in grid.spacing) / 4.1
    native = HostStagedStepper(grid, 1.0, dt, use_native=True)
    plain = HostStagedStepper(grid, 1.0, dt, use_native=False)
    check(native.use_native, "the stepper did not take the native engine")
    times = {}
    fields = {}
    for name, stepper in (("native", native), ("numpy", plain)):
        stepper.run(T0, Cp, 2)
        t0 = time.perf_counter()
        fields[name] = stepper.run(T0, Cp, HOST_TIMED_STEPS)
        times[name] = (time.perf_counter() - t0) / HOST_TIMED_STEPS * 1e3
    check(np.array_equal(fields["native"], fields["numpy"]),
          "native halostage engine differs from the numpy stepper")
    out["engine_ms"] = times
    print(f"[host-staged] native engine (csrc/halostage.cpp, a thread a shard) bitwise == "
          f"numpy stepper over {HOST_TIMED_STEPS} steps at 2x2 of {HOST_SHAPE[0]}x"
          f"{HOST_SHAPE[1]} f64: native {times['native']:.4f} ms/step, numpy "
          f"{times['numpy']:.4f} ms/step on the host ({os.cpu_count()} cores)", flush=True)
    return out, launches


def wire_twin(torch, device):
    """This rank's share of [wire]'s comparison of the card with the CPU,
    run on `device`: the f64 twin of each wire run, and WIRE_SENDS
    exchanges of a seeded f32 field scaled by (1 + send/10) in each reduced
    mode, at width 1 (the stateless modes) and WIRE_K, threading the
    state. Returns numpy arrays: {"runs": {case: shard}, "exchanges":
    {case: [(padded block, state), ...]}}."""
    import numpy as np

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.parallel import wire
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo

    base = dict(global_shape=WIRE_SHAPE, nt=WIRE_NT, warmup=WIRE_WARMUP, dims=(2, 2))
    out = dict(runs={}, exchanges={})
    for kind, mode in WIRE_CASES:
        model = HeatDiffusion(DiffusionConfig(**base, dtype="f64", wire_mode=mode),
                              device=device)
        res = model.run("perf") if kind == "perf" else model.run_deep(block_steps=WIRE_K)
        out["runs"][f"{kind}-{mode}"] = res.T.cpu().numpy()
    grid = model.grid
    G = np.random.default_rng(SEED).random(WIRE_SHAPE).astype(np.float32)
    for mode in wire.WIRE_MODES[1:]:
        for width in (1, WIRE_K):
            if width == 1 and wire.is_stateful(mode):
                continue  # the per-step exchange is stateless
            state = wire.init_exchange_state(grid.local_shape, width, mode, torch.float32,
                                             device=device)
            sends = []
            for t in range(WIRE_SENDS):
                u = torch.from_numpy(G[grid.shard_slices()] * np.float32(1 + t / 10))
                u = u.to(device)
                if wire.is_stateful(mode):
                    padded, state = exchange_halo(u, grid, width=width, wire_mode=mode,
                                                  wire_state=state)
                else:
                    padded = exchange_halo(u, grid, width=width, wire_mode=mode)
                sends.append((padded.cpu().numpy(), [x.cpu().numpy() for x in state]))
            out["exchanges"][f"{mode}-w{width}"] = sends
    return out


def wire_cpu_rank(rank, spec):
    """One CPU gloo rank of [wire]: wire_twin on the CPU."""
    import torch

    torch.set_num_threads(2)
    return wire_twin(torch, "cpu")


def wire_rank(rank, spec):
    """One rank of [wire] on the 2×2 grid: the f64 host-staged oracle, perf
    with an f32 and a bf16 wire and run_deep k = 8 with each reduced mode,
    each against the oracle; the f32 wire's exchange against the
    zero-padded global field; wire_twin on the card; with several cards,
    the exchange alone per mode at 2×2 of 12288²."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel import distributed, wire
    from rocm_mpi_tpu_torch.parallel.halo import exchange_halo
    from rocm_mpi_tpu_torch.parallel.mesh import GlobalGrid

    device = torch.device("cuda", rank % spec["gpus"])
    torch.cuda.set_device(device)
    distributed.barrier()
    base = dict(global_shape=WIRE_SHAPE, nt=WIRE_NT, warmup=WIRE_WARMUP, dims=(2, 2))
    oracle = HeatDiffusion(DiffusionConfig(**base, dtype="f64", halo_transport="host"),
                           device=device).run("shard").T

    def global_rel(T):
        diff = (T.double() - oracle).abs().max().reshape(1)
        peak = oracle.abs().max().reshape(1)
        both = torch.cat([diff, peak])
        if distributed.staged(both):
            both = both.cpu()
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        return float(both[0] / both[1])

    out = dict(rank=rank, runs={}, launches={name: 0 for name in kernels.LAUNCHES})

    def counted(fn):
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        for name, count in kernels.LAUNCHES.items():
            out["launches"][name] += count
        return res, dict(kernels.LAUNCHES)

    for kind, mode in WIRE_CASES:
        model = HeatDiffusion(DiffusionConfig(**base, dtype="f32", wire_mode=mode),
                              device=device)
        res, launches = counted(lambda: model.run("perf") if kind == "perf"
                                else model.run_deep(block_steps=WIRE_K))
        out["runs"][f"{kind}-{mode}"] = dict(
            kind=kind, mode=mode, rel=global_rel(res.T), route=res.route, k=res.k,
            launches=launches, ms_per_step=res.wtime_it * 1e3,
            finite=bool(torch.isfinite(res.T).all()))

    # The f32 wire's ghosts are the neighbours' cells bit for bit: a window
    # of the zero-padded global field.
    grid = model.grid
    G = np.random.default_rng(SEED).random(WIRE_SHAPE).astype(np.float32)
    out["f32_window"] = {}
    for width in (1, WIRE_K):
        window = tuple(slice(a, b + 2 * width) for a, b in grid.shard_bounds())
        padded = exchange_halo(torch.from_numpy(G[grid.shard_slices()]).to(device), grid,
                               width=width, wire_mode="f32")
        out["f32_window"][width] = bool(np.array_equal(padded.cpu().numpy(),
                                                       np.pad(G, width)[window]))
    out["twin"] = wire_twin(torch, device)

    if spec["gpus"] > 1:
        # The exchange alone per mode at 2×2 of 12288²: width 1 (perf) and
        # width 8 (the deep sweep), stateful modes threading their state.
        grid = GlobalGrid(BIG, (10.0, 10.0), (2, 2), rank)
        T = torch.rand(grid.local_shape, device=device)
        ms = {}
        for width in (1, WIRE_K):
            pad = torch.zeros(tuple(n + 2 * width for n in T.shape), device=device)
            for mode in wire.WIRE_MODES:
                if width == 1 and wire.is_stateful(mode):
                    continue  # the per-step exchange is stateless
                state = [wire.init_exchange_state(grid.local_shape, width, mode,
                                                  torch.float32, device=device)]

                def once(mode=mode, width=width, pad=pad, state=state):
                    if wire.is_stateful(mode):
                        _, state[0] = exchange_halo(T, grid, width=width, wire_mode=mode,
                                                    out=pad, wire_state=state[0])
                    else:
                        exchange_halo(T, grid, width=width, wire_mode=mode, out=pad)

                ms[f"{mode}-w{width}"] = _timed_loop(torch, once, 100)
        out["exchange_ms"] = ms
    return out


def _twin_diffs(card, cpu):
    """Card against CPU for one rank's wire_twin: {run: max |card − cpu|
    over this shard, and this shard's max |cpu|}, and the exchanges that
    differ in any bit, padded block or state."""
    import numpy as np

    runs = {k: (float(np.abs(card["runs"][k] - v).max()), float(np.abs(v).max()))
            for k, v in cpu["runs"].items()}
    differ = []
    for key, sends in cpu["exchanges"].items():
        for t, ((padded, state), (got, got_state)) in enumerate(
                zip(sends, card["exchanges"][key])):
            if not (np.array_equal(got, padded) and len(got_state) == len(state)
                    and all(np.array_equal(a, b) for a, b in zip(got_state, state))):
                worst = max(float(np.abs(a - b).max())
                            for a, b in zip((got, *got_state), (padded, *state)))
                differ.append(f"{key} send {t} (max |diff| {worst:.3e})")
    return runs, differ


def phase_wire(torch, card, gpus: int):
    """[wire] on the 2×2 grid of 512²: perf with an f32 and a bf16 wire
    and run_deep k = 8 with bf16, int8 and int8_delta, each within its
    TOLERANCE row of the f64 host-staged oracle; the same runs in f64 on
    the card within WIRE_TWIN_TOL of CPU gloo ranks, and each reduced
    mode's exchanges (ghosts and state) bitwise the CPU ranks'; the f32
    wire's exchange bitwise the zero-padded global field; each mode's
    exchange bytes, and with 4 cards its exchange alone at 2×2 of 12288²."""
    from rocm_mpi_tpu_torch.parallel import wire
    from rocm_mpi_tpu_torch.parallel.halo import exchange_nbytes
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    backend = "gloo" if gpus == 1 else "nccl"
    ranks = spawn_ranks(4, wire_rank, (dict(gpus=gpus),), backend=backend, timeout=600)
    cpu = spawn_ranks(4, wire_cpu_rank, ({},), backend="gloo", timeout=600)
    r0 = ranks[0]
    for r in ranks:
        for run in r["runs"].values():
            kind, mode = run["kind"], run["mode"]
            want = "fused_step_cm" if kind == "perf" else "multi_step_cm"
            check(run["finite"] and run["launches"][want] > 0,
                  f"wire rank {r['rank']} {kind} {mode}: launches {run['launches']}")
            check(run["rel"] <= wire.TOLERANCE[mode],
                  f"wire {kind} {mode}: relative error {run['rel']:.3e} against the f64 "
                  f"oracle beyond its TOLERANCE row {wire.TOLERANCE[mode]}")
        for width, same in r["f32_window"].items():
            check(same, f"wire rank {r['rank']}: the f32 wire's width-{width} exchange "
                  "differs from the zero-padded global field")
    twin = {}
    for r, c in zip(ranks, cpu):
        runs, differ = _twin_diffs(r.pop("twin"), c)
        check(not differ, f"wire rank {r['rank']}: the card's exchanges differ from the CPU "
              f"ranks': {', '.join(differ)}")
        for key, (diff, peak) in runs.items():
            d, p = twin.get(key, (0.0, 0.0))
            twin[key] = (max(d, diff), max(p, peak))
    twin = {key: d / p for key, (d, p) in twin.items()}
    for key, rel in twin.items():
        check(rel <= WIRE_TWIN_TOL, f"wire {key} f64 on the card differs from the CPU "
              f"ranks' run by {rel:.3e} (relative), beyond {WIRE_TWIN_TOL}")
    for run in r0["runs"].values():
        kind, mode = run["kind"], run["mode"]
        what = (f"perf, {WIRE_NT} steps" if kind == "perf"
                else f"run_deep k = {run['k']} ({run['route']} route), {WIRE_NT} steps")
        print(f"[wire] 2x2 of {WIRE_SHAPE[0]}x{WIRE_SHAPE[1]} f32, {mode} wire, {what}: "
              f"max rel err {run['rel']:.3e} against the f64 host-staged oracle (TOLERANCE "
              f"{wire.TOLERANCE[mode]}); rank 0 {run['ms_per_step']:.5f} ms/step; in f64 "
              f"{twin[f'{kind}-{mode}']:.3e} (relative) from the same run on 4 CPU gloo ranks "
              f"(bound {WIRE_TWIN_TOL})", flush=True)
    print(f"[wire] f32 wire: each rank's width-1 and width-{WIRE_K} exchange bitwise == the "
          f"zero-padded global field; bf16 (widths 1 and {WIRE_K}), int8 and int8_delta "
          f"(width {WIRE_K}): ghosts and state over {WIRE_SENDS} sends bitwise == the CPU "
          "ranks'", flush=True)
    nbytes = {}
    for local, width in (((WIRE_SHAPE[0] // 2, WIRE_SHAPE[1] // 2), 1), (BLOCK, 1),
                         (BLOCK, WIRE_K)):
        row = {m: exchange_nbytes(local, 4, width, wire_mode=m) for m in wire.WIRE_MODES}
        nbytes[f"{local[0]}x{local[1]}-w{width}"] = row
        print(f"[wire] bytes an interior rank sends per exchange, {local[0]}x{local[1]} f32 "
              f"shard, width {width}: " + ", ".join(f"{m} {b}" for m, b in row.items()),
              flush=True)
    if gpus > 1:
        for r in ranks:
            print(f"[wire] rank {r['rank']} exchange alone (ms, host clock around 100 "
                  f"synchronised exchanges, 2x2 of {BIG[0]}x{BIG[1]} f32 on {card}): "
                  + ", ".join(f"{k} {v:.5f}" for k, v in r["exchange_ms"].items()),
                  flush=True)
    launches = {}
    for r in ranks:
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return dict(ranks=ranks, nbytes=nbytes, twin=twin), launches


def phase_dryrun(torch, card, gpus: int):
    """[dryrun] dryrun_multichip(4): 4 ranks sharing this card over gloo,
    or one a card over NCCL; on the card each leg must launch its kernels."""
    from rocm_mpi_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    reports = dryrun_multichip(4, device="cuda")
    seconds = time.perf_counter() - t0
    for r in reports:
        for leg, kernels_ in DRYRUN_LEGS.items():
            got = r["launches"][leg]
            check(all(got[k] > 0 for k in kernels_),
                  f"dryrun rank {r['rank']} leg {leg}: launches {got}, expected "
                  f"{', '.join(kernels_)}")
    launches = {}
    for r in reports:
        for counts in r["launches"].values():
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
    where = "4 ranks sharing the card (gloo)" if gpus == 1 else f"4 GPUs, NCCL ({card} each)"
    print(f"[dryrun] dryrun_multichip(4) on {where} in {seconds:.1f} s; kernel launches "
          "over its legs (all ranks): " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                                    if v), flush=True)
    return dict(reports=reports, seconds=seconds), launches


def phase_transport(torch, card, gpus: int):
    """[ring], [host-staged], [wire] and [dryrun] in turn: (their records,
    the kernel launches of the model paths they drove)."""
    out = dict(ring=phase_ring(torch, card, gpus))
    launches = {}
    for name, phase in (("host_staged", phase_host_staged), ("wire", phase_wire),
                        ("dryrun", phase_dryrun)):
        out[name], counts = phase(torch, card, gpus)
        for kernel, count in counts.items():
            launches[kernel] = launches.get(kernel, 0) + count
    return out, launches


# [telemetry]: the telemetry plane on the card (rocm_mpi_tpu_torch/telemetry/).
TEL_CASES = ((BIG, 210, 10), (SMALL, 1010, 10))  # (shape, nt, warmup) of the off/on runs
TEL_ORDER = (False, True, True, False)  # telemetry off, on, on, off, in turns
TEL_WEAK_NT, TEL_WEAK_WARMUP = 2000, 200


def _tel_reset(telemetry, compiles, directory=None):
    """Telemetry off and empty, or on into `directory` with the compile
    accounting armed; the accounting reset either way."""
    telemetry.clear()
    compiles.reset()
    if directory is None:
        telemetry.configure(enabled=False)
    else:
        telemetry.configure(directory=directory, enabled=True, rank=0)
        compiles.install()


def phase_telemetry(torch, card):
    """[telemetry] the telemetry plane on one card. Diffusion `perf` at
    12288² (200 steps after 10) and 252² (1000 after 10), f32, under the
    scan and the step driver, telemetry off, on, on, off: every field
    bitwise the first's, LAUNCHES identical, the `step_window` span's
    dur_s equal to the run's wtime, ms/step of each run printed (the cost
    of telemetry a step). Under the scan driver: the captures happen with
    telemetry on, counted by telemetry.compiles as many as the plan's
    graphs, steady_state 0 (captured in the warmup); a warmup-0 run's
    in-window captures counted as steady-state recompiles; the wave's
    252² perf under scan (its step pads through exchange_halo) emits its
    halo.exchange annotation once. --health: neither torch nor NCCL owns
    SIGUSR2, the heartbeat's step equals nt, SIGUSR2 writes the
    traceback. The 12288² perf app with --profile names rmt_masked_step
    in its trace and with --telemetry leaves a directory the port's CLI
    `summarize` reads. Returns (record, the launches of the main-path
    runs)."""
    import faulthandler
    import tempfile

    import torch.distributed as dist

    from rocm_mpi_tpu_torch import telemetry
    from rocm_mpi_tpu_torch.config import DiffusionConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion
    from rocm_mpi_tpu_torch.models.scan import graph_plan
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.telemetry import compiles, flight

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-telemetry-"))
    totals = {name: 0 for name in kernels.LAUNCHES}
    record = {"runs": []}
    try:
        for shape, nt, warmup in TEL_CASES:
            cfg = DiffusionConfig(global_shape=shape, lengths=(10.0, 10.0), nt=nt,
                                  warmup=warmup, dtype="f32", dims=(1, 1))
            for driver in ("scan", "step"):
                first, rows = None, []
                for i, on in enumerate(TEL_ORDER):
                    d = root / f"{shape[0]}-{driver}-{i}"
                    _tel_reset(telemetry, compiles, d if on else None)
                    kernels.reset_launches()
                    res = HeatDiffusion(cfg, device="cuda").run("perf", driver=driver)
                    torch.cuda.synchronize()
                    launches = dict(kernels.LAUNCHES)
                    for name, n in launches.items():
                        totals[name] += n
                    row = dict(on=on, ms_per_step=res.wtime_it * 1e3, launches=launches)
                    if first is None:
                        first = (res.T.clone(), launches)
                    else:
                        equal, err = _same(res.T, first[0])
                        check(equal, f"[telemetry] perf {shape} {driver} run {i} (telemetry "
                              f"{'on' if on else 'off'}) != run 0 (max |diff| {err})")
                        check(launches == first[1], f"[telemetry] perf {shape} {driver} run "
                              f"{i}: launches {launches} != {first[1]}")
                    if on:
                        (window,) = [r for r in telemetry.records("span")
                                     if r["name"] == "step_window"]
                        check(window["dur_s"] == res.wtime, f"[telemetry] step_window "
                              f"dur_s {window['dur_s']} != wtime {res.wtime}")
                        snap = compiles.snapshot()
                        captures = sum(v["count"] for k, v in snap["programs"].items()
                                       if k.startswith("graph:"))
                        want = graph_plan(res.k, 2).graphs if driver == "scan" else 0
                        check(captures == want, f"[telemetry] perf {shape} {driver}: "
                              f"{captures} captures counted, the plan's graphs {want}")
                        check(compiles.steady_state() == 0, f"[telemetry] perf {shape} "
                              f"{driver}: steady_state {compiles.steady_state()} after a "
                              f"warmup of {warmup}")
                        row.update(captures=captures, records=len(telemetry.records()))
                    rows.append(row)
                ms = [r["ms_per_step"] for r in rows]
                print(f"[telemetry] perf {shape[0]}x{shape[1]} f32 --driver {driver}, {nt - warmup} "
                      f"steps after {warmup}, telemetry off/on/on/off: "
                      + " / ".join(f"{m:.6f}" for m in ms) + " ms/step (on − off: "
                      f"{(ms[1] + ms[2] - ms[0] - ms[3]) / 2 * 1e3:+.3f} µs a step); fields "
                      f"bitwise equal, launches identical {first[1]['masked_step']} "
                      f"masked_step; step_window dur_s == wtime"
                      + (f"; {rows[1]['captures']} capture(s) counted == the plan's graphs, "
                         "steady_state 0" if driver == "scan" else "")
                      + f", on {card}", flush=True)
                record["runs"].append(dict(shape=list(shape), driver=driver, rows=rows))

        # A warmup-0 run captures inside its timed window: recompiles.
        cfg0 = DiffusionConfig(global_shape=SMALL, lengths=(10.0, 10.0), nt=1000, warmup=0,
                               dtype="f32", dims=(1, 1))
        _tel_reset(telemetry, compiles, root / "warmup0")
        model = HeatDiffusion(cfg0, device="cuda")
        with watch_loops() as loops:
            res = model.run("perf", driver="scan")
        torch.cuda.synchronize()
        graphs = len(loops[-1].graphs)
        check(graphs >= 1 and compiles.steady_state() == graphs,
              f"[telemetry] warmup-0 scan run: steady_state {compiles.steady_state()}, "
              f"graphs captured {graphs}")
        compiles.emit_gauges()
        gauges = {r["name"]: r["value"] for r in telemetry.records("gauge")}
        check(gauges.get("compiles.steady_state") == graphs,
              f"[telemetry] warmup-0: gauges {gauges}")
        print(f"[telemetry] perf 252x252 --driver scan, warmup 0 (q {res.k}): {graphs} "
              f"graph(s) captured in the timed window, counted as compiles.steady_state "
              f"{gauges['compiles.steady_state']} (compiles.total {gauges['compiles.total']}); "
              f"{res.wtime_it * 1e3:.6f} ms/step with the captures in it", flush=True)
        record["warmup0"] = dict(graphs=graphs, gauges=gauges, ms_per_step=res.wtime_it * 1e3)

        # The wave's perf step pads through exchange_halo: its annotation
        # fires in the warm-up step and in the captures, and is kept once.
        wcfg = WaveConfig(global_shape=SMALL, lengths=(10.0, 10.0), nt=1010, warmup=10,
                          dtype="f32", dims=(1, 1))
        _tel_reset(telemetry, compiles, None)
        kernels.reset_launches()
        w_off = AcousticWave(wcfg, device="cuda").run("perf", driver="scan")
        off_launches = dict(kernels.LAUNCHES)
        _tel_reset(telemetry, compiles, root / "wave")
        kernels.reset_launches()
        w_on = AcousticWave(wcfg, device="cuda").run("perf", driver="scan")
        torch.cuda.synchronize()
        on_launches = dict(kernels.LAUNCHES)
        for counts in (off_launches, on_launches):
            for name, n in counts.items():
                totals[name] += n
        equal, err = _same(w_on.U, w_off.U)
        check(equal and on_launches == off_launches,
              f"[telemetry] wave perf scan: telemetry on != off ({err}; {on_launches} / "
              f"{off_launches})")
        traced = [r for r in telemetry.records("trace") if r["name"] == "halo.exchange"]
        captures = compiles.snapshot()["programs"].get("graph:step", {}).get("count", 0)
        check(len(traced) == 1 and captures >= 1,
              f"[telemetry] wave perf scan: {len(traced)} halo.exchange annotation(s), "
              f"{captures} capture(s)")
        print(f"[telemetry] wave perf 252x252 f32 --driver scan: {captures} capture(s) with "
              f"telemetry on, one halo.exchange annotation {traced[0]['attrs']}; field "
              f"bitwise and launches equal to the telemetry-off run; "
              f"{w_off.wtime_it * 1e3:.6f} / {w_on.wtime_it * 1e3:.6f} ms/step off / on",
              flush=True)

        # --health: SIGUSR2 is nobody's (torch, and NCCL once initialised),
        # the heartbeat reaches nt, and SIGUSR2 dumps every thread.
        check(signal.getsignal(signal.SIGUSR2) == signal.SIG_DFL,
              f"[telemetry] SIGUSR2 already handled: {signal.getsignal(signal.SIGUSR2)}")
        store = dist.TCPStore("localhost", 0, 1, is_master=True)  # a port the system picks
        dist.init_process_group("nccl", store=store, world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        dist.barrier()
        owned = signal.getsignal(signal.SIGUSR2)
        dist.destroy_process_group()
        check(owned == signal.SIG_DFL, f"[telemetry] NCCL's init took SIGUSR2: {owned}")
        hdir = root / "health"
        _tel_reset(telemetry, compiles, hdir)
        flight.enable(directory=hdir, rank=0)
        tb = pathlib.Path(flight.install_postmortem_handler())
        try:
            res = HeatDiffusion(cfg0, device="cuda").run("perf", driver="step")
            beat = json.loads((hdir / "heartbeat-rank0.json").read_text())
            check(beat["counters"].get("step") == cfg0.nt,
                  f"[telemetry] heartbeat step {beat['counters'].get('step')} != nt {cfg0.nt}")
            os.kill(os.getpid(), signal.SIGUSR2)
            time.sleep(0.2)
            dump = tb.read_text()
            check("thread" in dump.lower() and "phase_telemetry" in dump,
                  f"[telemetry] SIGUSR2 traceback: {dump[:400]!r}")
        finally:
            faulthandler.unregister(signal.SIGUSR2)
            flight.disable()
            flight.reset()
        print(f"[telemetry] --health: SIGUSR2 unhandled by torch and NCCL; heartbeat step "
              f"{beat['counters']['step']} == nt after 252x252 perf --driver step; SIGUSR2 wrote "
              f"{len(dump.splitlines())} traceback lines", flush=True)
        _tel_reset(telemetry, compiles, None)

        # The app: --profile names the kernel; --telemetry is read by the CLI.
        prof, tdir = root / "prof", root / "app"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "rocm_mpi_tpu_torch.apps.diffusion_2d_perf",
                               "--nt", "60", "--warmup", "10", "--profile", str(prof),
                               "--telemetry", str(tdir)],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        app_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"[telemetry] the perf app with --profile failed:\n"
              f"{proc.stdout}\n{proc.stderr[-4000:]}")
        doc = json.loads((prof / "trace-rank0.json").read_text())
        named = sorted({e["name"] for e in doc["traceEvents"] if "rmt_masked_step" in e["name"]})
        check(named, "[telemetry] the --profile trace names no rmt_masked_step kernel")
        cli = subprocess.run([sys.executable, "-m", "rocm_mpi_tpu_torch.telemetry", "summarize",
                              str(tdir), "--json"], cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        check(cli.returncode == 0, f"[telemetry] CLI summarize failed:\n{cli.stderr}")
        summary = json.loads(cli.stdout)
        check(summary["ranks"] == [0] and summary["steps"]["count"] == 50,
              f"[telemetry] CLI summary: ranks {summary['ranks']}, steps {summary['steps']}")
        print(f"[telemetry] diffusion_2d_perf 12288² --nt 60 --warmup 10 --profile --telemetry "
              f"in {app_s:.1f} s: the trace names {named[0][:70]}; `python -m "
              f"rocm_mpi_tpu_torch.telemetry summarize` read {summary['records']} records, "
              f"{summary['steps']['per_step_us']['mean']} µs a step, gauges "
              f"{ {k: round(v, 4) for k, v in summary['gauges'].items()} }", flush=True)
        record.update(profile_kernels=named, app_summary=summary, app_seconds=app_s)
    finally:
        _tel_reset(telemetry, compiles, None)
        shutil.rmtree(root, ignore_errors=True)
    return record, totals


def weak_scaling_app_rank(rank, argv):
    """One rank of the weak-scaling app's main(argv) on its own card, its
    stdout captured and returned with the exit code."""
    import io

    import torch

    from rocm_mpi_tpu_torch.apps import weak_scaling

    torch.cuda.set_device(torch.device("cuda", rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = weak_scaling.main(argv)
    return rc, out.getvalue()


def _torchrun(args, timeout=900):
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def phase_telemetry_sharded(card, gpus: int):
    """[telemetry] on four cards: the weak-scaling app (main() on 4 ranks,
    one a card, NCCL) with --telemetry DIR --health at 252² a rank,
    counts 1, 2, 4 (the app's 2000 steps after 200, hide under the scan
    driver), beside a
    telemetry-off ladder in the same call: the merged summary holds ranks
    0–3, halo, interior and checkpoint wall time, every rank's halo.probe
    bytes those of its face exchange; the Chrome trace's pids are 0–3;
    each rank's probe and heartbeat times printed (the arrival skew), the
    probes replaying their captured calls as the scan driver's steps do.
    Then the profiling app under torchrun, 2×2 of 8192², as it runs by
    default (the scan driver's graphs, the exchange inside): prof.txt
    lists rmt_fused_step_cm and NCCL's kernels with their device ms, and
    every rank's Chrome trace names rmt_fused_step_cm."""
    import tempfile

    from rocm_mpi_tpu_torch.parallel.halo import faces_nbytes
    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.parallel.mesh import init_global_grid

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-telemetry4-"))
    try:
        # The app's main() on 4 ranks of one NCCL group (spawn_ranks, as
        # [weak-scaling]): the card's torchrun reads `--local` as an
        # ambiguous abbreviation of its own --local-* options.
        common = ["--json", "--local", str(WEAK_LOCAL), "--counts", WEAK_COUNTS]
        tdir = root / "tel"
        runs = {}
        for label, extra in (("off", []), ("on", ["--telemetry", str(tdir), "--health"])):
            t0 = time.perf_counter()
            ranks = spawn_ranks(4, weak_scaling_app_rank, ([*common, *extra],),
                                backend="nccl", timeout=900)
            check([rc for rc, _ in ranks] == [0] * 4,
                  f"[telemetry] weak_scaling telemetry {label}: rcs {[rc for rc, _ in ranks]}")
            runs[label] = ([json.loads(ln) for ln in ranks[0][1].splitlines()
                            if ln.startswith("{")], time.perf_counter() - t0)
        summary = json.loads((tdir / "telemetry-summary.json").read_text())
        check(summary["ranks"] == [0, 1, 2, 3], f"[telemetry] merged ranks {summary['ranks']}")
        phases = summary["phases"]
        for ph in ("halo", "interior", "checkpoint"):
            check(phases[ph]["wall_s"] > 0, f"[telemetry] {ph} wall {phases[ph]['wall_s']}")
        trace_doc = json.loads((tdir / "telemetry-trace.json").read_text())
        pids = {e["pid"] for e in trace_doc["traceEvents"]}
        check(pids == {0, 1, 2, 3}, f"[telemetry] trace pids {pids}")
        streams = {rk: [json.loads(ln) for ln in
                        (tdir / f"telemetry-rank{rk}.jsonl").read_text().splitlines()]
                   for rk in range(4)}
        per_rank = {}
        for rk, recs in streams.items():
            grid = init_global_grid(2 * WEAK_LOCAL, 2 * WEAK_LOCAL, dims=(2, 2), nprocs=4,
                                    rank=rk)
            (probe,) = [r for r in recs if r["name"] == "halo.probe"]
            want = faces_nbytes(grid.local_shape, 4, grid) * probe["attrs"]["iters"]
            check(probe["attrs"]["bytes"] == want, f"[telemetry] rank {rk} halo.probe bytes "
                  f"{probe['attrs']['bytes']} != the face exchange's {want}")
            (interior,) = [r for r in recs if r["name"] == "interior.probe"]
            for r in (probe, interior):
                check(r["attrs"]["route"] == "graph" and r["attrs"]["driver"] == "scan",
                      f"[telemetry] rank {rk} {r['name']} ran {r['attrs']}, not as the "
                      "scan driver's captured steps")
            beats = [r["dur_s"] for r in recs if r["name"] == "halo.heartbeat"]
            per_rank[rk] = dict(probe_ms=probe["dur_s"] * 1e3 / probe["attrs"]["iters"],
                                interior_ms=interior["dur_s"] * 1e3 / probe["attrs"]["iters"],
                                heartbeat_ms=[b * 1e3 for b in beats],
                                ckpt_ms=sum(r["dur_s"] for r in recs
                                            if r["name"].startswith("checkpoint.")) * 1e3)
        for rk, r in per_rank.items():
            hb = r["heartbeat_ms"]
            print(f"[telemetry] rank {rk}: halo.probe {r['probe_ms']:.5f} ms an exchange "
                  f"(captured, one replay, barriered), interior.probe "
                  f"{r['interior_ms']:.5f} ms a launch (captured), "
                  f"halo.heartbeat {len(hb)}: median {statistics.median(hb):.5f}, max "
                  f"{max(hb):.5f} ms (unbarriered: the arrival skew), checkpoint spans "
                  f"{r['ckpt_ms']:.3f} ms", flush=True)
        for off, on in zip(runs["off"][0], runs["on"][0]):
            check("windows" not in off and on.get("windows", 0) > 1,
                  f"[telemetry] rows off {off} on {on}: only the windowed rows say windows")
            print(f"[telemetry] weak-scaling hide scan n={off['devices']}: telemetry off "
                  f"{off['gpts_per_device']} Gpts/s a device, efficiency {off['efficiency']}; "
                  f"on ({on['windows']} windows, a sync and barrier each) "
                  f"{on['gpts_per_device']}, {on['efficiency']}", flush=True)
        print(f"[telemetry] merged summary: ranks {summary['ranks']}, halo "
              f"{phases['halo']['wall_s']} s ({phases['halo']['bytes']} B), interior "
              f"{phases['interior']['wall_s']} s, checkpoint {phases['checkpoint']['wall_s']} s, "
              f"step p50 {summary['steps']['per_step_us']['p50']} µs, stragglers "
              f"{summary['stragglers']}; trace pids {sorted(pids)}; off {runs['off'][1]:.1f} s, "
              f"on {runs['on'][1]:.1f} s on 4 GPUs ({card} each)", flush=True)

        report = root / "prof.txt"
        # Its default on four CUDA ranks: the scan driver, its graphs (the
        # exchange captured inside) replayed in the profiled window.
        proc = _torchrun(["-m", "rocm_mpi_tpu_torch.apps.diffusion_2d_perf_hide_prof",
                          "--report", str(report), "--profile", str(root / "prof_trace")],
                         timeout=300)
        check(proc.returncode == 0, f"[telemetry] the profiling app failed:\n{proc.stdout}\n"
              f"{proc.stderr[-4000:]}")
        text = report.read_text()
        check("rmt_fused_step_cm" in text and "nccl" in text.lower()
              and "4 rank(s), driver scan)" in text,
              f"[telemetry] prof.txt lists no rmt_fused_step_cm or NCCL kernel:\n{text}")
        for rk in range(gpus):
            trace_file = root / "prof_trace" / f"trace-rank{rk}.json"
            names = {e.get("name", "") for e in
                     json.loads(trace_file.read_text()).get("traceEvents", [])}
            check(any("rmt_fused_step_cm" in n for n in names),
                  f"[telemetry] {trace_file.name} names no rmt_fused_step_cm kernel")
        for line in text.splitlines():
            if line.strip():
                print(f"[telemetry] prof.txt | {line}", flush=True)
        return dict(ranks=per_rank, summary_phases=phases, rows=runs, prof=text)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tune_models(shape, nt, warmup, dims=(1, 1)):
    """The three models at `shape` f32 on the card (the search's setting)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    common = dict(global_shape=shape, lengths=(10.0, 10.0), nt=nt, warmup=warmup,
                  dtype="f32", dims=dims)
    return {"diffusion": HeatDiffusion(DiffusionConfig(**common), device="cuda"),
            "wave": AcousticWave(WaveConfig(**common), device="cuda"),
            "swe": ShallowWater(SWEConfig(**common), device="cuda")}


def _tune_entry(config, backend="cuda"):
    """A cache entry written by hand for a knob the search does not
    measure (the scan chunk, masked_step's run length): the consumer's
    seam is what is checked, not a measurement."""
    from rocm_mpi_tpu_torch.tuning import keys

    return {"config": config, "median_us": 0.0, "compile_s": 0.0, "gate_ratio": 1.0,
            "fingerprint": keys.fingerprint(backend)}


def phase_tune(torch, card, pk):
    """[tune] the tuning plane on one card (rocm_mpi_tpu_torch/tuning/), with
    a cache file in a temporary directory, never the default file.

    The search of diffusion.vmem_loop, wave.vmem_loop, swe.vmem_loop and
    diffusion.deep at 252² f32 (three repeats a candidate): each winner,
    its median µs a step, every measured candidate's, the candidates the
    gate took out and the build and capture seconds. The CLI's search
    again: all hits, nothing built, captured or launched, the file
    byte-identical, compiles.steady_state 0. `validate` exits 0 on the
    file and 1 with a doctored pad entry (140² padded to 256²). Every
    config="auto" run bitwise equal to its explicit run (the winners of
    the three VMEM loops and of run_deep's k and wire mode; a scan chunk
    of 16 by hand for the three scan drivers, 320 steps after 64) and,
    on a cold cache, to its default run. masked_step at 12288² f32 with
    run_rows 1, 2 and 4 (and config="auto" from a hand entry): each
    bitwise the default launch and the plain version, its device ms
    beside the bytes bound. Returns the record."""
    import tempfile

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.telemetry import compiles
    from rocm_mpi_tpu_torch.tuning import cache, keys, resolve, search
    from rocm_mpi_tpu_torch.tuning.__main__ import main as tuning_cli

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-tune-"))
    record = {"search": {}, "auto": {}, "masked_step": {}}
    try:
        path = root / "cache_torch.json"
        for op in TUNE_OPS:
            t0 = time.perf_counter()
            r = search.search_op(op, TUNE_SHAPE, "f32", repeats=TUNE_REPEATS,
                                 cache_path=path)
            check(r["status"] == "tuned", f"[tune] search {op}: {r['status']}")
            e = r["entry"]
            rows = [(c, round(m * 1e6, 4), round(cs, 3)) for c, m, cs in r["measured"]]
            record["search"][op] = dict(winner=e["config"], median_us=e["median_us"],
                                        compile_s=e["compile_s"], gate_ratio=e["gate_ratio"],
                                        gated_out=[c for c, _ in r["rejected"]],
                                        measured=rows, seconds=time.perf_counter() - t0)
            print(f"[tune] {op} {TUNE_SHAPE[0]}² f32: winner {json.dumps(e['config'])} "
                  f"{e['median_us']} µs/step (median of {TUNE_REPEATS}), gate "
                  f"{e['gate_ratio']}x, {len(r['rejected'])} of {len(rows) + len(r['rejected'])} "
                  f"candidates gated out, builds and captures {e['compile_s']} s, search "
                  f"{time.perf_counter() - t0:.1f} s, on {card}", flush=True)
            for c, us, cs in rows:
                print(f"[tune]   {json.dumps(c)}: {us} µs/step, captures {cs} s", flush=True)
        blob = path.read_bytes()

        # The warm re-search: all hits, nothing built, captured or launched.
        compiles.reset()
        before = dict(kernels.LAUNCHES)
        rc = tuning_cli(["search", "--ops", ",".join(TUNE_OPS), "--shape", "252x252",
                         "--cache", str(path)])
        snap = compiles.snapshot()
        check(rc == 0 and path.read_bytes() == blob and compiles.steady_state() == 0
              and snap["totals"]["backend_compiles"] == 0 and dict(kernels.LAUNCHES) == before,
              f"[tune] warm re-search: rc {rc}, identical {path.read_bytes() == blob}, "
              f"compiles {snap['totals']}, steady {compiles.steady_state()}")
        print("[tune] warm re-search: every op a hit, nothing built, captured or launched, "
              "file byte-identical, compiles.steady_state=0", flush=True)
        check(tuning_cli(["validate", str(path)]) == 0, "[tune] validate of the search's file")
        doc = json.loads(blob)
        doc["entries"][keys.key_str(keys.tuning_key("diffusion.vmem_loop", (140, 140), "f32",
                                                    backend="cuda"))] = _tune_entry(
            {"body_form": "eqc", "pad_pow2": True, "chunk": 16})
        doctored = root / "doctored.json"
        doctored.write_text(json.dumps(doc))
        check(tuning_cli(["validate", str(doctored)]) == 1,
              "[tune] validate passed a doctored pad entry (140² -> 256²)")
        print("[tune] validate: exit 0 on the search's file, 1 on the doctored pad entry",
              flush=True)

        # config="auto", warm: bitwise the explicit knobs.
        def knobs(op):
            return record["search"][op]["winner"]

        for op in TUNE_SCAN_OPS:
            cache.store(path, keys.tuning_key(op, TUNE_SHAPE, "f32", backend="cuda"),
                        _tune_entry({"chunk": TUNE_SCAN_CHUNK}))
        resolve.configure(path)
        resolve.reset_stats()
        models = _tune_models(TUNE_SHAPE, TUNE_NT, TUNE_WARMUP)
        d, w, s = models["diffusion"], models["wave"], models["swe"]
        kd, kw, ks = knobs("diffusion.vmem_loop"), knobs("wave.vmem_loop"), knobs(
            "swe.vmem_loop")
        kdeep = knobs("diffusion.deep")
        pairs = {
            "diffusion.vmem_loop": (lambda: d.run_vmem_resident(config="auto").T,
                                    lambda: d.run_vmem_resident(**kd).T),
            "wave.vmem_loop": (lambda: w.run_vmem_resident(config="auto").U,
                               lambda: w.run_vmem_resident(**kw).U),
            "swe.vmem_loop": (lambda: s.run_vmem_resident(config="auto").h,
                              lambda: s.run_vmem_resident(**ks).h),
            "diffusion.deep": (lambda: d.run_deep(config="auto").T,
                               lambda: d.run_deep(block_steps=kdeep["k"],
                                                  wire_mode=kdeep["wire_mode"]).T),
        }
        for name, model, leaf in (("diffusion", d, "T"), ("wave", w, "U"), ("swe", s, "h")):
            advance, q = model.scan_advance_fn("perf", chunk=TUNE_SCAN_CHUNK)
            auto_q = model.scan_advance_fn("perf", config="auto")[1]
            check(auto_q == q != model.scan_advance_fn("perf")[1],
                  f"[tune] {name}.scan: auto q {auto_q}, explicit {q}")
            pairs[f"{name}.scan"] = (
                lambda m=model, lf=leaf: getattr(m.run("perf", driver="scan", config="auto"),
                                                 lf),
                lambda m=model, lf=leaf: getattr(m.run("perf", driver="scan"), lf))
        for op, (auto, explicit) in pairs.items():
            got, want = auto(), explicit()
            check(torch.equal(got, want), f"[tune] {op}: config='auto' != its explicit run")
            record["auto"][op] = "bitwise"
        stats = resolve.stats()
        check(stats["misses"] == 0 and stats["hits"] >= len(pairs),
              f"[tune] auto runs resolved {stats}")
        # Cold: bitwise the defaults.
        resolve.configure(root / "cold.json")
        for op, auto, default in (
                ("diffusion.vmem_loop", lambda: d.run_vmem_resident(config="auto").T,
                 lambda: d.run_vmem_resident().T),
                ("wave.vmem_loop", lambda: w.run_vmem_resident(config="auto").U,
                 lambda: w.run_vmem_resident().U),
                ("swe.vmem_loop", lambda: s.run_vmem_resident(config="auto").h,
                 lambda: s.run_vmem_resident().h),
                ("diffusion.deep", lambda: d.run_deep(config="auto").T,
                 lambda: d.run_deep().T)):
            check(torch.equal(auto(), default()), f"[tune] cold {op}: auto != default")
        print(f"[tune] config='auto' bitwise its explicit run with the cache warm "
              f"({', '.join(pairs)}; scan chunk {TUNE_SCAN_CHUNK} by hand, {TUNE_NT} steps "
              f"after {TUNE_WARMUP}) and its default run with the cache cold; resolves "
              f"{stats}", flush=True)

        # masked_step's run length at the main path's 12288².
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        T = torch.rand(BIG, generator=gen, device="cuda", dtype=torch.float32)
        Cm = torch.rand(BIG, generator=gen, device="cuda", dtype=torch.float32) * 1e-4
        sp = (10.0 / BIG[0], 10.0 / BIG[1])
        want = kernels.masked_step(T, Cm, sp)
        plain = kernels.masked_step_plain(T, Cm, kernels.inv_d2_of(sp))
        check(torch.equal(want, plain), "[tune] masked_step default != plain version")
        nbytes = 3 * T.numel() * T.element_size()
        bound, by, _ = bound_ms(pk, "f32", nbytes, T.numel(), 1,
                                FLOPS_PER_CELL_STEP[("masked_step", "direct")](2))
        out = torch.empty_like(T)
        for r in (0, *TUNE_RUN_ROWS):
            got = kernels.masked_step(T, Cm, sp, run_rows=r or None)
            check(torch.equal(got, want), f"[tune] masked_step run_rows {r} != default launch")
            ms = time_ms(lambda r=r: kernels.masked_step(T, Cm, sp, out=out, run_rows=r or None),
                         reps=50)
            record["masked_step"][r or "default"] = ms
            print(f"[tune] masked_step {BIG[0]}² f32 run_rows {r or 'default (4)'}: {ms:.4f} ms "
                  f"(bound {bound:.4f} ms by {by}, {bound / ms:.2f} of it), bitwise the "
                  f"default launch and the plain version, on {card}", flush=True)
        cache.store(path, keys.tuning_key("diffusion.masked_step", BIG, "f32", backend="cuda"),
                    _tune_entry({"run_rows": 2}))
        resolve.configure(path)
        check(kernels.masked_run_rows(T, config="auto") == 2
              and torch.equal(kernels.masked_step(T, Cm, sp, config="auto"), want),
              "[tune] masked_step config='auto' did not take run_rows 2 or differs")
        return record
    finally:
        from rocm_mpi_tpu_torch.tuning import resolve

        resolve.configure(None)
        resolve.reset_stats()
        shutil.rmtree(root, ignore_errors=True)


def tune_weak_scaling_rank(rank, spec):
    """One rank of the weak-scaling app's main(argv) with --autotune on its
    own card, its tuning plane pointed at its own cache file
    (spec["paths"][rank]: rank 0's holds the entry, the others' are
    empty). Returns the exit code, stdout and (count, q, route) of each
    rung this rank ran."""
    import io

    import torch

    from rocm_mpi_tpu_torch.apps import weak_scaling
    from rocm_mpi_tpu_torch.tuning import resolve

    torch.cuda.set_device(torch.device("cuda", rank))
    resolve.configure(spec["paths"][rank])
    ran = []
    run_rung = weak_scaling.run_rung

    def watched(args, n, group, device):
        rung = run_rung(args, n, group, device)
        if rung is not None:
            ran.append((n, rung.result.k, rung.result.route))
        return rung

    weak_scaling.run_rung = watched
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = weak_scaling.main(spec["argv"])
    return rc, out.getvalue(), ran, resolve.stats()


def phase_tune_sharded(card, gpus: int):
    """[tune] on four cards: weak_scaling --autotune (main() on 4 ranks, one
    a card, NCCL, hide under the scan driver at 252² a rank, the app's
    2000 steps after 200) with a cache entry for the 2×2 rung's scan
    chunk in rank 0's file only: every rank of that rung runs the tuned q
    (rank 0 decides for all), the 1- and 2-rank rungs (misses) the
    default q, and every rank's result is exit 0."""
    import tempfile

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
    from rocm_mpi_tpu_torch.tuning import cache, keys

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-tune4-"))
    try:
        paths = [str(root / f"rank{r}.json") for r in range(gpus)]
        doc = cache.empty_doc()
        key = keys.tuning_key("diffusion.scan", (WEAK_LOCAL, WEAK_LOCAL), "f32", (2, 2),
                              backend="cuda")
        doc["entries"][keys.key_str(key)] = _tune_entry({"chunk": TUNE_SCAN_CHUNK})
        cache.write_doc(paths[0], doc)
        for p in paths[1:]:
            cache.write_doc(p, cache.empty_doc())
        nt, warmup = WEAK_WINDOWS[4]
        argv = ["--autotune", "--json", "--local", str(WEAK_LOCAL), "--counts", WEAK_COUNTS]
        ranks = spawn_ranks(gpus, tune_weak_scaling_rank, ({"paths": paths, "argv": argv},),
                            backend="nccl", timeout=900)
        default_q = math.gcd(warmup, nt - warmup)
        tuned_q = math.gcd(default_q, TUNE_SCAN_CHUNK)
        for rk, (rc, _out, ran, stats) in enumerate(ranks):
            want = [(n, tuned_q if n == 4 else default_q, "scan-graph")
                    for n in (1, 2, 4) if rk < n]
            check(rc == 0 and ran == want, f"[tune] rank {rk}: rc {rc}, rungs {ran} != {want}")
            print(f"[tune] weak_scaling --autotune rank {rk}: rungs (count, q, route) {ran}, "
                  f"resolves {stats}", flush=True)
        rows = [json.loads(ln) for ln in ranks[0][1].splitlines() if ln.startswith("{")]
        for r in rows:
            print(f"[tune] weak-scaling hide scan --autotune n={r['devices']}: "
                  f"{r['gpts_per_device']} Gpts/s a device, efficiency {r['efficiency']} on "
                  f"{gpus} GPUs ({card} each)", flush=True)
        return dict(ranks=[r[2] for r in ranks], rows=rows, tuned_q=tuned_q,
                    default_q=default_q)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# [serve] the serving core: batched lanes behind SimulationService
# ---------------------------------------------------------------------------

SERVE_MAX_WIDTH = 8
SERVE_DEVICE = "cuda"


def serve_trace(multi: bool = False):
    """The [serve] trace: ~50 requests over the three workloads at 256²,
    1024² and 4096² (plus 1000², an off-rung shape its 1024² ladder rung
    serves), mostly f32 with some f64 and bf16, nt 32…512, some diffusion
    `hide` requests and two session requests. `multi`: the four-rank
    trace, without sessions (single-controller only)."""
    from rocm_mpi_tpu_torch.serving.queue import Request

    rows = []

    def add(wl, n, dtype, nts, variant="shard", session=False):
        for nt in nts:
            i = len(rows)
            rows.append(Request(request_id=f"serve-{i:03d}", workload=wl, global_shape=(n, n),
                                dtype=dtype, nt=nt, variant=variant,
                                ic_scale=1.0 + 0.01 * (i % 17),
                                session=f"sess-{i:03d}" if session else None))

    # Each class's steps share a steps bucket (the bin key's power of two
    # at or above nt), so a class fills a batch of heterogeneous lengths.
    add("diffusion", 256, "f32", (40, 48, 56, 64, 64, 60))
    add("diffusion", 1024, "f32", (300, 340, 400, 450, 512, 480))
    add("diffusion", 1000, "f32", (320, 400, 500))
    add("diffusion", 4096, "f32", (40, 50, 60, 64))
    add("diffusion", 256, "f64", (100, 128))
    add("diffusion", 256, "bf16", (100, 120))
    add("diffusion", 1024, "f32", (130, 160, 200, 256), variant="hide")
    add("diffusion", 256, "f64", (33, 64), variant="hide")
    if not multi:
        add("diffusion", 256, "f32", (40, 64), session=True)
    add("wave", 256, "f32", (200, 256, 230, 250))
    add("wave", 1024, "f32", (100, 128, 120))
    add("wave", 4096, "f32", (32, 32))
    add("swe", 256, "f32", (300, 400, 512))
    add("swe", 1024, "f32", (64, 50, 40))
    add("swe", 4096, "f32", (32, 32))
    add("swe", 256, "f64", (64,))
    add("swe", 256, "bf16", (64,))
    return rows


def serve_standalone(torch, req, device):
    """The port's standalone single-lane run of a request on `device`:
    its final state leaves (lane_advance_fn / advance_fn of its variant,
    from ic_scale × its model's initial state)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    kw = dict(global_shape=tuple(req.global_shape), dtype=req.dtype,
              lengths=(10.0,) * len(req.global_shape))
    if req.workload == "diffusion":
        m = HeatDiffusion(DiffusionConfig(**kw), device=device)
        T0, Cp = m.init_state()
        return (m.lane_advance_fn(req.variant)(T0 * req.ic_scale, Cp, req.nt),)
    if req.workload == "wave":
        w = AcousticWave(WaveConfig(**kw), device=device)
        U0, _, C2 = w.init_state()
        return tuple(w.advance_fn(req.variant)(U0 * req.ic_scale, U0 * req.ic_scale, C2,
                                               req.nt))
    sw = ShallowWater(SWEConfig(**kw), device=device)
    h0, us0 = sw.init_state()
    h, us = sw.advance_fn(req.variant)(h0 * req.ic_scale,
                                        tuple(torch.zeros_like(h0) for _ in us0),
                                        sw.face_masks(), req.nt)
    return (h, *us)


def _host_bits(torch, t):
    """A result leaf as numpy, bf16 widened to float32 exactly (the
    service's own host form)."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _serve(torch, reqs, **cfg):
    """Serve `reqs` through a fresh SimulationService on the card:
    (service, tickets, report, wall s)."""
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService

    svc = SimulationService(config=ServeConfig(max_width=SERVE_MAX_WIDTH, device=SERVE_DEVICE,
                                               **cfg))
    tickets = [svc.queue.submit(r) for r in reqs]
    t0 = time.perf_counter()
    report = svc._drain_all()
    torch.cuda.synchronize()
    return svc, tickets, report, time.perf_counter() - t0


def _lane_gpts(reqs) -> float:
    return sum(math.prod(r.global_shape) * r.nt for r in reqs) / 1e9


def serve_advance_costs(torch, card, n: int = 64, width: int = SERVE_MAX_WIDTH,
                        side: int = 1024):
    """The eager batched advances' cost at `side`² f32, `width` lanes,
    all lanes running every step: ms per batch-step (host clock around
    `n` steps ending in a device sync), the host ms to issue them (the
    call's return, before the sync), the device ms per step between two
    CUDA events, and the CUDA kernels a step launches (torch.profiler
    over 4 steps): the diffusion shard, hide and ladder forms, the wave
    and the SWE shard forms."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig, SWEConfig, WaveConfig
    from rocm_mpi_tpu_torch.models import AcousticWave, HeatDiffusion, ShallowWater

    kw = dict(global_shape=(side, side), dtype="f32", lengths=(10.0, 10.0))
    dev = SERVE_DEVICE
    m = HeatDiffusion(DiffusionConfig(**kw), device=dev)
    T0, Cp = m.init_state()
    w = AcousticWave(WaveConfig(**kw), device=dev)
    U0, _, C2 = w.init_state()
    sw = ShallowWater(SWEConfig(**kw), device=dev)
    h0, _ = sw.init_state()
    lanes = torch.stack([T0] * width)
    forms = {}
    for variant in ("shard", "hide"):
        adv, _ = m.batched_advance_fn(batch=width, variant=variant)
        forms[f"diffusion-{variant}"] = (lambda k, adv=adv: adv(lanes.clone(), Cp, [k] * width,
                                                                k))
    lad, _ = m.batched_ladder_advance_fn(batch=width)
    hold = torch.ones_like(lanes, dtype=torch.bool)
    hold[(slice(None),) + (slice(1, side - 1),) * 2] = False
    geom = [(m.dt, tuple(m.config.spacing))] * width
    forms["diffusion-ladder"] = lambda k: lad(lanes.clone(), Cp, hold, geom, [k] * width, k)
    wadv, _ = w.batched_advance_fn(batch=width)
    ub = torch.stack([U0] * width)
    forms["wave-shard"] = lambda k: wadv(ub.clone(), ub.clone(), C2, [k] * width, k)
    sadv, _ = sw.batched_advance_fn(batch=width)
    hb = torch.stack([h0] * width)
    forms["swe-shard"] = lambda k: sadv(hb.clone(), (torch.zeros_like(hb),
                                                     torch.zeros_like(hb)),
                                        sw.face_masks(), [k] * width, k)
    rows = {}
    for name, run in forms.items():
        run(4)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(n)
        t_host = time.perf_counter() - t0
        stop.record()
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        kernels_step = None
        if dev == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(4)
                torch.cuda.synchronize()
            cuda_events = [e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not e.name.startswith(("Memcpy", "Memset"))]
            kernels_step = len(cuda_events) / 4
        rows[name] = dict(ms_per_step=t_wall / n * 1e3, host_ms_per_step=t_host / n * 1e3,
                          device_ms_per_step=start.elapsed_time(stop) / n,
                          kernels_per_step=kernels_step)
        print(f"[serve] eager advance {name}, {width} lanes of {side}² f32: "
              f"{rows[name]['ms_per_step']:.4f} ms a batch-step (host issue "
              f"{rows[name]['host_ms_per_step']:.4f}, device "
              f"{rows[name]['device_ms_per_step']:.4f}), {kernels_step} kernels a step, "
              f"on {card}", flush=True)
    return rows


def serve_hide_vs_plain(torch, card, steps: int = 4) -> float:
    """The hide lanes' kernel at the shapes serving gives it — one-rank
    lane blocks of 1024² f32 and 256² f64, every face None — held bitwise
    against its plain version: `steps` batched hide steps of two lanes
    (batched_step_fn with batched_prepare_fn's coefficient), each beside
    fused_step_cm_faces_plain over the same boxes from the same input.
    Returns the largest |difference| (0.0)."""
    from rocm_mpi_tpu_torch.config import DiffusionConfig
    from rocm_mpi_tpu_torch.models import HeatDiffusion
    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.parallel.overlap import effective_b_width, region_boxes

    worst = 0.0
    for side, dtype in ((1024, "f32"), (256, "f64")):
        m = HeatDiffusion(DiffusionConfig(global_shape=(side, side), dtype=dtype,
                                          lengths=(10.0, 10.0)), device=SERVE_DEVICE)
        T0, Cp = m.init_state()
        bgrid = m.make_batched_grid(2, 1)
        step = m.batched_step_fn(bgrid, "hide")
        C = m.batched_prepare_fn(bgrid, "hide")(Cp)
        local = bgrid.space.local_shape
        boxes = region_boxes(local, effective_b_width(local, m.config.b_width))
        inv_d2 = kernels.inv_d2_of(m.config.spacing)
        none = (None,) * (2 * len(local))
        Tb = torch.stack([T0, T0 * 1.1])
        for i in range(steps):
            before = kernels.LAUNCHES["fused_step_cm"]
            got = step(Tb, C)
            check(kernels.LAUNCHES["fused_step_cm"] - before == 2 * len(boxes),
                  f"[serve] hide step {side}² {dtype}: "
                  f"{kernels.LAUNCHES['fused_step_cm'] - before} launches, not "
                  f"{2 * len(boxes)}")
            want = torch.empty_like(Tb)
            for j in range(Tb.shape[0]):
                for box in boxes:
                    kernels.fused_step_cm_faces_plain(Tb[j], none, C, inv_d2, box=box,
                                                      out=want[j])
            equal, err = _same(got, want)
            check(equal, f"[serve] hide lanes {side}² {dtype}, step {i}: kernel != plain "
                  f"version (max |diff| {err})")
            worst = max(worst, err)
            Tb = got
        print(f"[serve] hide lanes of {side}² {dtype} ({len(boxes)} boxes, faces None): "
              f"{steps} batched steps of 2 lanes bitwise equal to fused_step_cm_faces_plain "
              f"on {card}", flush=True)
    return worst


def phase_serve(torch, card):
    """[serve] the serving core on one card (module docstring, phase 21)."""
    import hashlib
    import subprocess
    import tempfile

    import numpy as np

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.serving import bins
    from rocm_mpi_tpu_torch.serving.queue import Request, request_to_record
    from rocm_mpi_tpu_torch.telemetry import compiles, regress

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-serve-"))
    try:
        # The compile accounting is process-wide: drop the earlier phases'
        # windows and recompiles, so that steady_state is this service's.
        compiles.reset()
        compiles.install()
        trace = serve_trace()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        svc, tickets, report, wall = _serve(torch, trace, ladder=True,
                                            sessions_dir=str(root / "sessions"))
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(report.served == len(trace) and report.failed == 0,
              f"[serve] served {report.served}/{len(trace)}, {report.failed} failed")
        check(report.compiles["steady_state"] == 0, f"[serve] steady {report.compiles}")
        check(any(p.endswith("|ladder") for p in report.programs)
              and any("|hide|" in p for p in report.programs), f"[serve] {report.programs}")
        # One launch a hide lane, box (the interior and four slabs) and step.
        n_hide = sum(r.nt for r in trace if r.variant == "hide")
        check(launches["fused_step_cm"] == 5 * n_hide and launches["masked_step"] == 0,
              f"[serve] hide lanes launched {launches}, not 5 x {n_hide} fused_step_cm")
        pipe = report.pipeline
        occ = report.continuous.get("occupancy")
        print(f"[serve] {len(trace)} requests, {report.n_bins} bins, {report.n_programs} "
              f"programs, {wall:.3f} s: {len(trace) / wall:.3f} requests/s, "
              f"{_lane_gpts(trace) / wall:.4f} lane-Gpts/s, occupancy "
              f"{min(st.occupancy for st in report.bins.values()):.3f} (classic bins min), "
              f"continuous occupancy {occ}, device_bubble {pipe['bubble']}, "
              f"peak memory {peak / 2**30:.3f} GiB on {card}", flush=True)
        print(f"[serve] pipeline depth {pipe['depth']}: {pipe['batches']} batches, assemble "
              f"{pipe['assemble_s']} s, dispatch {pipe['dispatch_s']} s, fetch "
              f"{pipe['fetch_s']} s, resolve {pipe['resolve_s']} s; hide lanes: "
              f"{launches['fused_step_cm']} fused_step_cm launches over {n_hide} lane-steps "
              f"(one a lane, box and step)", flush=True)

        hide_err = serve_hide_vs_plain(torch, card)

        # every lane bitwise to its standalone run on the card
        digests = {}
        for t in tickets:
            got = t.result(timeout=5)
            want = serve_standalone(torch, t.request, SERVE_DEVICE)
            for g, w in zip(got, want):
                check(np.array_equal(g, _host_bits(torch, w)),
                      f"[serve] {t.request.request_id} {t.request.workload} "
                      f"{t.request.global_shape} {t.request.variant}: lane != standalone")
            digests[t.request.request_id] = hashlib.sha256(
                b"".join(np.ascontiguousarray(g).tobytes() for g in got)).hexdigest()
            del want
        torch.cuda.empty_cache()
        print(f"[serve] all {len(tickets)} lanes bitwise equal to their standalone runs "
              f"on the card", flush=True)

        # sessions: resume each session to twice its steps, bitwise
        legs = [Request(request_id=f"{r.request_id}-resume", workload=r.workload,
                        global_shape=r.global_shape, dtype=r.dtype, nt=2 * r.nt,
                        ic_scale=r.ic_scale, session=r.session, resume=True)
                for r in trace if r.session]
        leg_t = [svc.queue.submit(r) for r in legs]
        svc._drain_all()
        for t in leg_t:
            want = serve_standalone(torch, dataclasses.replace(
                t.request, session=None, resume=False), SERVE_DEVICE)
            check(t.start_step == t.request.nt // 2
                  and np.array_equal(t.result(timeout=5)[0], _host_bits(torch, want[0])),
                  f"[serve] resumed {t.request.request_id} != its straight run")
        print(f"[serve] {len(legs)} sessions resumed at their saved step, bitwise equal "
              "to straight runs", flush=True)

        # the repeat trace: nothing built, nothing captured, no memory growth
        before = compiles.snapshot()["totals"]["backend_compiles"]
        mem0 = torch.cuda.memory_allocated()
        again = [dataclasses.replace(r, request_id=r.request_id + "-again",
                                     session=r.session and r.session + "-again")
                 for r in trace]
        t_again = [svc.queue.submit(r) for r in again]
        t0 = time.perf_counter()
        rep2 = svc._drain_all()
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        mem1 = torch.cuda.memory_allocated()
        built = compiles.snapshot()["totals"]["backend_compiles"] - before
        check(built == 0 and rep2.compiles["steady_state"] == 0,
              f"[serve] repeat trace built/captured {built}")
        check(mem1 <= mem0, f"[serve] memory_allocated grew {mem0} -> {mem1}")
        for t in t_again:
            rid = t.request.request_id[:-len("-again")]
            got = t.result(timeout=5)
            check(hashlib.sha256(b"".join(np.ascontiguousarray(g).tobytes() for g in got))
                  .hexdigest() == digests[rid], f"[serve] repeat {rid} differs")
        print(f"[serve] repeat trace: 0 programs built, 0 graphs captured, "
              f"memory_allocated {mem0} -> {mem1} B, {wall2:.3f} s "
              f"({len(again) / wall2:.3f} requests/s) on {card}", flush=True)

        # depth 1 against depth 2, bitwise
        nolad = [dataclasses.replace(r, session=None) for r in trace]
        d1 = _serve(torch, nolad, pipeline_depth=1)
        d2 = _serve(torch, nolad, pipeline_depth=2)
        for a, b in zip(d1[1], d2[1]):
            for x, y in zip(a.result(timeout=5), b.result(timeout=5)):
                check(np.array_equal(x, y), f"[serve] depth 1 != depth 2 "
                      f"({a.request.request_id})")
        for a in d2[1]:
            check(hashlib.sha256(b"".join(np.ascontiguousarray(g).tobytes()
                                          for g in a.result(timeout=5))).hexdigest()
                  == digests[a.request.request_id], f"[serve] {a.request.request_id}: "
                  "classic drain != ladder drain")
        print(f"[serve] pipeline depth 1 {d1[3]:.3f} s (bubble {d1[2].pipeline['bubble']}) "
              f"and depth 2 {d2[3]:.3f} s (bubble {d2[2].pipeline['bubble']}) without the "
              f"ladder: bitwise equal, and equal to the ladder drain's lanes, on {card}",
              flush=True)
        del d1, d2

        # the manifest, through both the service and the serve app
        man = svc.write_manifest(root / "serve-manifest.json")
        check(bins.validate_manifest_doc(man) == [], "[serve] manifest invalid")
        trace_path = root / "trace.jsonl"
        trace_path.write_text("".join(json.dumps(request_to_record(r)) + "\n" for r in trace))
        out = root / "app"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.serve", "--device", SERVE_DEVICE,
             "--trace", str(trace_path), "--max-width", str(SERVE_MAX_WIDTH), "--ladder", "--sessions",
             str(root / "app-sessions"), "--out", str(out)],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        app_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"[serve] app rc {proc.returncode}: {proc.stderr[-2000:]}")
        doc = json.loads((out / "serve-manifest.json").read_text())
        check(doc["served"] == len(trace) and doc["programs"] == report.programs
              and doc["compiles"]["steady_state"] == 0, f"[serve] app manifest {doc}")
        check(regress.check_schema([out / "serve-manifest.json",
                                    out / "serve-requests.jsonl"]) == [],
              "[serve] the app's sidecars fail the schema check")
        print(f"[serve] the serve app (child process) served the trace in {app_s:.3f} s: "
              f"{doc['served']} served, {len(doc['programs'])} programs, the service's "
              f"program keys; manifests valid", flush=True)
        costs = serve_advance_costs(torch, card)
        return dict(requests=len(trace), wall_s=wall, requests_per_s=len(trace) / wall,
                    lane_gpts_per_s=_lane_gpts(trace) / wall, peak_bytes=peak,
                    pipeline=pipe, continuous=report.continuous,
                    programs=report.programs, launches=launches, repeat_wall_s=wall2,
                    mem=(mem0, mem1), app_s=app_s, card=card, digests=digests,
                    advance_costs=costs, hide_max_abs_err=hide_err)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _shard_digest(arrays, slices) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(b"".join(np.ascontiguousarray(a[tuple(slices)]).tobytes()
                                   for a in arrays)).hexdigest()


def serve_rank(rank, spec):
    """One rank of [serve] on four cards: the multi trace through
    SimulationService over NCCL at spec["batch_dims"] rows, results
    fetched as each rank's shards; returns the digests of its lanes'
    shards, the programs, the counts and the walls."""
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
    from rocm_mpi_tpu_torch.telemetry import compiles

    import torch as torch_

    from rocm_mpi_tpu_torch.parallel import distributed

    torch_.cuda.set_device(distributed.local_device("cuda"))
    compiles.install()
    svc = SimulationService(config=ServeConfig(max_width=SERVE_MAX_WIDTH, device="cuda",
                                               fetch_results=True,
                                               batch_dims=spec["batch_dims"]))
    trace = serve_trace(multi=True)
    tickets = [svc.queue.submit(r) for r in trace]
    t0 = time.perf_counter()
    report = svc._drain_all()
    torch_.cuda.synchronize()
    wall = time.perf_counter() - t0
    from rocm_mpi_tpu_torch.serving.bins import bin_key

    out = {}
    for t in tickets:
        got = t.result(timeout=5)
        if got is None:
            continue
        space = svc._model_for(bin_key(t.request)).grid
        out[t.request.request_id] = (space.shard_slices(),
                                     _shard_digest(got, [slice(None)] * len(got[0].shape)))
    return dict(shards=out, programs=report.programs, served=report.served,
                failed=report.failed, steady=report.compiles["steady_state"], wall_s=wall,
                wall_slo=svc.queue.wall_slo, space=[list(svc._model_for(bin_key(r)).grid.dims)
                                                   for r in trace[:1]])


def phase_serve_sharded(card, gpus: int):
    """[serve] on four cards: the trace (no sessions) served on 4 ranks
    over NCCL at batch_dims 2 (two rows of a two-rank space grid) and 1
    (one row of 2×2); each rank's shard of every lane bitwise equal (by
    digest) to the one-card service's lane, computed first on card 0."""
    import torch as torch_

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks

    trace = serve_trace(multi=True)
    svc, tickets, report, wall = _serve(torch_, trace)
    check(report.served == len(trace), f"[serve] one card served {report.served}")
    full = {t.request.request_id: t.result(timeout=5) for t in tickets}
    del svc, tickets
    torch_.cuda.empty_cache()
    print(f"[serve] one-card reference: {len(trace)} requests in {wall:.3f} s "
          f"({len(trace) / wall:.3f} requests/s) on {card}", flush=True)
    out = {}
    for bd in (2, 1):
        ranks = spawn_ranks(gpus, serve_rank, ({"batch_dims": bd},), backend="nccl",
                            timeout=900)
        seen = set()
        for rk, r in enumerate(ranks):
            check(r["served"] == len(trace) and r["failed"] == 0 and r["steady"] == 0
                  and r["wall_slo"] is False, f"[serve] rank {rk} at bd {bd}: {r}")
            check(r["programs"] == [p.replace("|bd1", f"|bd{bd}") for p in report.programs],
                  f"[serve] rank {rk} programs {r['programs']}")
            for rid, (slices, digest) in r["shards"].items():
                check(_shard_digest(full[rid], slices) == digest,
                      f"[serve] rank {rk} bd {bd}: {rid} shard {slices} != the one-card lane")
                seen.add(rid)
        check(seen == set(full), f"[serve] bd {bd}: lanes seen {len(seen)}/{len(full)}")
        walls = [r["wall_s"] for r in ranks]
        print(f"[serve] {gpus} ranks over NCCL, batch_dims {bd} (space {ranks[0]['space']}): "
              f"{len(trace)} requests in {max(walls):.3f} s "
              f"({len(trace) / max(walls):.3f} requests/s), every lane's shards bitwise "
              f"the one-card lanes, on {gpus} GPUs ({card} each)", flush=True)
        out[bd] = dict(wall_s=max(walls), space=ranks[0]["space"])
    return out


# ---------------------------------------------------------------------------
# [fleet] the fleet half of serving: the router, the journal, the apps
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_FAULT = "replica-kill@step=2,rank=1"


def _fleet_paced(router, reqs) -> list:
    """Submit `reqs` in the fleet app's waves (a quarter of the trace, one
    drive tick between), so the tick-keyed kill fires mid-traffic; then
    drain. Returns the fleet tickets."""
    tickets = []
    wave = max(1, len(reqs) // 4)
    for i in range(0, len(reqs), wave):
        tickets += [router.submit(r) for r in reqs[i:i + wave]]
        if i + wave < len(reqs):
            router.drive_once()
    router.drive()
    return tickets


def _digest(arrays) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
                          ).hexdigest()


def phase_fleet(torch, card):
    """[fleet] the fleet half of serving on one card (module docstring,
    phase 22): (a) three replicas serve the [serve] trace under a replica
    kill, held against one standalone service; (b) the fleet app and (c)
    the bounded soak as child processes."""
    import gc
    import tempfile

    import numpy as np

    from rocm_mpi_tpu_torch.ops import kernels
    from rocm_mpi_tpu_torch.resilience import faults
    from rocm_mpi_tpu_torch.serving import journal as fleet_journal
    from rocm_mpi_tpu_torch.serving.queue import Request
    from rocm_mpi_tpu_torch.serving.router import FleetRouter
    from rocm_mpi_tpu_torch.serving.service import ServeConfig, SimulationService
    from rocm_mpi_tpu_torch.telemetry import compiles, regress

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-fleet-"))
    rec = dict(card=card)
    try:
        # (a) the in-process kill drill at full width
        t_part = time.perf_counter()
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        compiles.reset()
        compiles.install()
        trace = serve_trace()
        journal = fleet_journal.TicketJournal(root / "fleet-journal.jsonl")

        def replica(rid):
            return SimulationService(config=ServeConfig(
                max_width=SERVE_MAX_WIDTH, device=SERVE_DEVICE,
                sessions_dir=str(root / "sessions" / f"replica-{rid}")))

        router = FleetRouter(replica, FLEET_REPLICAS, journal=journal)
        marks = {}
        kill, record_terminal = router.kill_replica, journal.record_terminal

        def timed_kill(rid, verdict="killed"):
            marks["kill"] = time.perf_counter()
            kill(rid, verdict)

        def timed_terminal(request_id, state, replica=None):
            marks[request_id] = time.perf_counter()
            return record_terminal(request_id, state, replica=replica)

        router.kill_replica, journal.record_terminal = timed_kill, timed_terminal
        faults.install(FLEET_FAULT)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            tickets = _fleet_paced(router, trace)
            torch.cuda.synchronize()
        finally:
            faults.install(None)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        dead = [r.id for r in router.replicas if not r.alive]
        check(dead == [1] and router.replica(1).verdict == "injected-kill",
              f"[fleet] {FLEET_FAULT} killed {dead}")
        check(router.replica(1).svc._programs == {} and router.replica(1).svc._models == {},
              "[fleet] the dead replica kept its programs")
        state = router.journal_state()
        counts = state.counts()
        problems = router.check_accounting()
        check(counts["rerouted"] >= 1 and counts["open"] == 0 and problems == [],
              f"[fleet] journal {counts}, accounting {problems}")
        check(fleet_journal.replay(journal.segments()).counts() == counts,
              "[fleet] replaying the journal changed its counts")
        check(all(t.state == "done" for t in tickets),
              f"[fleet] not done: {[(t.request.request_id, t.state) for t in tickets if t.state != 'done']}")
        n_hide = sum(r.nt for r in trace if r.variant == "hide")
        check(launches["fused_step_cm"] == 5 * n_hide and launches["masked_step"] == 0,
              f"[fleet] hide lanes launched {launches}, not 5 x {n_hide} fused_step_cm")
        rerouted = sorted(rid for rid, t in state.tickets.items() if t["reroutes"])
        failover = max(marks[rid] for rid in rerouted) - marks["kill"]
        served = {r.id: r.svc.queue.counters()["completed"] for r in router.replicas}
        print(f"[fleet] {FLEET_REPLICAS} replicas, {len(trace)} requests paced in 4 waves under "
              f"{FLEET_FAULT}: replica 1 killed at tick 2, {counts['rerouted']} re-routed "
              f"({', '.join(rerouted)}), every ticket done once (journal {counts['tickets']} "
              f"tickets, 0 open, replay idempotent), served by replica {served}; fleet "
              f"{wall:.3f} s ({len(trace) / wall:.3f} requests/s), kill tick to the last "
              f"re-routed ticket's terminal {failover:.3f} s, peak memory "
              f"{peak / 2**30:.3f} GiB on {card}", flush=True)
        print(f"[fleet] hide lanes: {launches['fused_step_cm']} fused_step_cm launches over "
              f"{n_hide} lane-steps (5 a lane-step), masked_step 0", flush=True)

        # the same trace through one standalone service: every lane bitwise
        compiles.reset()
        compiles.install()
        solo = SimulationService(config=ServeConfig(
            max_width=SERVE_MAX_WIDTH, device=SERVE_DEVICE,
            sessions_dir=str(root / "solo-sessions")))
        solo_t = [solo.queue.submit(r) for r in trace]
        t0 = time.perf_counter()
        solo._drain_all()
        torch.cuda.synchronize()
        solo_wall = time.perf_counter() - t0
        for t, s in zip(tickets, solo_t):
            got, want = t.result(timeout=5), s.result(timeout=5)
            check(len(got) == len(want) and all(np.array_equal(g, w)
                                                 for g, w in zip(got, want)),
                  f"[fleet] {t.request.request_id}: fleet lane != standalone service lane")
        print(f"[fleet] all {len(tickets)} lanes bitwise equal to one standalone service's "
              f"({solo_wall:.3f} s, {len(trace) / solo_wall:.3f} requests/s) on {card}",
              flush=True)
        del solo, solo_t

        # sessions: resume each to twice its steps through the fleet, bitwise
        legs = [Request(request_id=f"{r.request_id}-resume", workload=r.workload,
                        global_shape=r.global_shape, dtype=r.dtype, nt=2 * r.nt,
                        ic_scale=r.ic_scale, session=r.session, resume=True)
                for r in trace if r.session]
        leg_t = [router.submit(r) for r in legs]
        router.drive()
        for t in leg_t:
            want = serve_standalone(torch, dataclasses.replace(
                t.request, session=None, resume=False), SERVE_DEVICE)
            check(t.state == "done" and t.start_step == t.request.nt // 2
                  and np.array_equal(t.result(timeout=5)[0], _host_bits(torch, want[0])),
                  f"[fleet] resumed {t.request.request_id} != its straight run")
            del want
        check(router.check_accounting() == [], "[fleet] accounting after the sessions")

        # the merged report: valid, steady_state 0 in every row
        doc = router.report_doc()
        fleet_journal.write_fleet_report(root / "fleet-report.json", doc)
        check(regress.check_schema([root / "fleet-report.json",
                                    root / "fleet-journal.jsonl"]) == [],
              "[fleet] the fleet sidecars fail the schema check")
        check(doc["accounting_ok"] and all(r["steady_state"] == 0 for r in doc["replicas"]),
              f"[fleet] report rows {doc['replicas']}")
        journal.close()
        del router, tickets, leg_t, journal, kill, record_terminal
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(mem1 <= mem0, f"[fleet] memory_allocated {mem0} -> {mem1} B after the fleet")
        part_a = time.perf_counter() - t_part
        print(f"[fleet] {len(legs)} sessions resumed on their replica bitwise; report valid, "
              f"steady_state 0 in every row; memory_allocated {mem0} -> {mem1} B once the "
              f"router is dropped; part (a) {part_a:.1f} s", flush=True)
        rec.update(requests=len(trace), wall_s=wall, requests_per_s=len(trace) / wall,
                   solo_wall_s=solo_wall, served=served, rerouted=counts["rerouted"],
                   failover_s=failover, peak_bytes=peak, mem=(mem0, mem1),
                   launches=launches, part_a_s=part_a)

        # (b) the fleet app as a child
        t0 = time.perf_counter()
        out = root / "app"
        proc = subprocess.run(
            [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.fleet", "--device", SERVE_DEVICE,
             "--inject-fault", FLEET_FAULT, "--out", str(out)],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        app_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"[fleet] app rc {proc.returncode}: {proc.stdout[-1500:]}"
              f"{proc.stderr[-2000:]}")
        sidecars = [out / "fleet-journal.jsonl", out / "fleet-report.json"]
        check(regress.check_schema(sidecars) == [], "[fleet] the app's sidecars fail the schema")
        app_doc = json.loads(sidecars[1].read_text())
        check(app_doc["accounting_ok"] and [r["alive"] for r in app_doc["replicas"]]
              == [True, False, True], f"[fleet] app report {app_doc['replicas']}")
        print(f"[fleet] the fleet app (child process) under {FLEET_FAULT}: exit 0, "
              f"{app_doc['journal']['tickets']} tickets, {app_doc['journal']['rerouted']} "
              f"re-routed, sidecars valid; {app_s:.1f} s", flush=True)
        rec["app_s"] = app_s

        # (c) the bounded soak as a child (its evict episode signals itself)
        rec["soak"] = _soak_child(root / "soak", ["--bounded"], 9)
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cmdline(pid: int) -> bytes:
    try:
        return pathlib.Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return b""


def _soak_child(out, extra, n_episodes: int, timeout: float = 900) -> dict:
    """apps/soak.py on the card as a child process: exit 0, its report
    valid, every episode ok, no rank of its launches left behind."""
    from rocm_mpi_tpu_torch.telemetry import regress

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rocm_mpi_tpu_torch.apps.soak", "--device", "cuda", "--out",
         str(out), *extra], capture_output=True, text=True, cwd=ROOT, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"[fleet] soak {extra} rc {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    report = out / "soak-report.json"
    check(regress.check_schema([report, out / "quarantine.jsonl"]) == [],
          "[fleet] the soak report fails the schema check")
    doc = json.loads(report.read_text())
    eps = doc["episodes"]
    check(len(eps) == n_episodes and all(ep["ok"] for ep in eps) and doc["accounting_ok"],
          f"[fleet] soak episodes {[(ep['name'], ep['ok'], ep.get('error')) for ep in eps]}")
    left = [pid for pid in children() if b"rocm_mpi_tpu_torch.apps" in _cmdline(pid)]
    check(not left, f"[fleet] the soak left app ranks behind: {left}")
    walls = {ep["name"]: ep["wall_s"] for ep in eps}
    print(f"[fleet] soak {' '.join(extra) or 'full'} --device cuda (child process): exit 0, "
          f"{len(eps)} episodes ok, report valid; {wall:.1f} s; episode walls {walls}; "
          f"slo p50 {doc['slo']['latency_s']['p50']} p99 {doc['slo']['latency_s']['p99']}",
          flush=True)
    return dict(wall_s=wall, episodes=walls, modes={ep["name"]: ep["mode"] for ep in eps},
                details={ep["name"]: {k: v for k, v in ep.items()
                                      if k in ("first_failure", "vanished", "watchdog_rank",
                                               "killed", "rerouted")} for ep in eps})


def phase_fleet_sharded(card, gpus: int):
    """[fleet] on four cards: the fleet app on 4 ranks over NCCL (every
    rank's replica map and journal the same, rank 0's report balanced),
    then the soak's full schedule with its multi-rank episodes on 4 ranks,
    one a card, over NCCL."""
    import re
    import tempfile

    from rocm_mpi_tpu_torch.parallel.launcher import spawn_app_ranks
    from rocm_mpi_tpu_torch.telemetry import regress

    root = pathlib.Path(tempfile.mkdtemp(prefix="rmt-fleet4-"))
    try:
        t0 = time.perf_counter()
        out = root / "app"
        res = spawn_app_ranks(["-m", "rocm_mpi_tpu_torch.apps.fleet", "--device", "cuda",
                               "--inject-fault", FLEET_FAULT, "--out", str(out)],
                              nprocs=gpus, timeout=600, peer_grace_s=20.0)
        app_s = time.perf_counter() - t0
        lines = []
        for rank, (p, (stdout, err)) in enumerate(res):
            check(p.returncode == 0, f"[fleet] app rank {rank} exited {p.returncode}:\n"
                  f"{stdout[-1500:]}{err[-2000:]}")
            found = re.findall(rf"rank {rank}: replica map (.*)", stdout)
            check(len(found) == 1, f"[fleet] app rank {rank} printed no map:\n{stdout[-1500:]}")
            lines.append(found[0])
        check(len(set(lines)) == 1, f"[fleet] the ranks' maps or journals differ: {lines}")
        sidecars = [out / "fleet-journal.jsonl", out / "fleet-report.json"]
        check(regress.check_schema(sidecars) == [], "[fleet] the app's sidecars fail the schema")
        doc = json.loads(sidecars[1].read_text())
        check(doc["accounting_ok"] and doc["journal"]["open"] == 0
              and doc["journal"]["rerouted"] >= 1, f"[fleet] app report {doc['journal']}")
        print(f"[fleet] the fleet app on {gpus} ranks over NCCL under {FLEET_FAULT}: every "
              f"rank exit 0 with the same replica map and journal digest "
              f"({lines[0].split('journal sha256 ')[-1]}), {doc['journal']['tickets']} tickets, "
              f"{doc['journal']['rerouted']} re-routed, the books balanced; {app_s:.1f} s on "
              f"{gpus} GPUs ({card} each)", flush=True)
        soak = _soak_child(root / "soak", ["--ranks", str(gpus)], 11, timeout=1500)
        check(set(soak["modes"][n] for n in ("gloo-serve", "gloo-kill", "gloo-die",
                                             "gloo-stall")) == {"nccl"},
              f"[fleet] the soak's rank episodes did not run over NCCL: {soak['modes']}")
        d = soak["details"]
        check(d["gloo-kill"]["first_failure"] == [1, 43] and d["gloo-die"]["vanished"] == 1
              and d["gloo-stall"]["watchdog_rank"] == 1, f"[fleet] soak details {d}")
        return dict(app_s=app_s, soak=soak)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write every measurement to PATH")
    parser.add_argument("--gpus", type=int, default=1, choices=[1, 4],
                        help="4: run only the sharded phases (perf, sharded scan, deep, hide, "
                        "wave and shallow-water deep, 3d, checkpoint, weak scaling, telemetry, "
                        "tune, elastic, ring, host-staged, wire, dryrun, serve, fleet), "
                        "one rank per GPU over NCCL, on a host with 4 GPUs")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import rocm_mpi_tpu_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: the port's package rocm_mpi_tpu_torch is not in {ROOT}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rocm_mpi_tpu_torch.apps._common import card_line

    card = card_line()
    check(card is not None, "nvidia-smi gave no card name and power limit")
    kind = torch.cuda.get_device_name(0)
    pk = peaks(kind)
    t0 = time.perf_counter()
    phase_environment(torch, card)
    host = phase_host_facts(card)
    if pk["assumed"]:
        print(f"[env] no published peaks on record for {kind!r}: bounds use the "
              "H100 SXM's", flush=True)
    build_s = phase_build()
    if args.gpus > 1:
        check(torch.cuda.device_count() >= args.gpus,
              f"--gpus {args.gpus} needs {args.gpus} GPUs, "
              f"{torch.cuda.device_count()} visible")
        record = dict(card=card, kind=kind, host=host, build_s=build_s)
        record["sharded_ranks"], _, _ = phase_sharded(card, args.gpus)
        record["sharded_scan_ranks"], _ = phase_sharded_scan(card, args.gpus)
        record["sharded_deep_ranks"], _ = phase_sharded_deep(card, args.gpus)
        record["hide_ranks"], _ = phase_hide(card, args.gpus)
        record["wave_deep_ranks"], _ = phase_wave_deep(card, args.gpus)
        record["swe_deep_ranks"], _ = phase_swe_deep(card, args.gpus)
        record["three_d"] = phase_3d_sharded(card, args.gpus)
        record["checkpoint_ranks"] = phase_checkpoint_sharded(card, args.gpus)
        record["weak_scaling_ranks"], _ = phase_weak_scaling(card, args.gpus)
        record["telemetry"] = phase_telemetry_sharded(card, args.gpus)
        record["tune"] = phase_tune_sharded(card, args.gpus)
        record["elastic"] = phase_elastic(card, args.gpus)
        record["transport"], _ = phase_transport(torch, card, args.gpus)
        record["serve"] = phase_serve_sharded(card, args.gpus)
        record["fleet"] = phase_fleet_sharded(card, args.gpus)
        if args.json:
            path = pathlib.Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(record, indent=1, default=str))
        print(f"[done] sharded phases passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    rows = phase_kernels(torch, card, pk)
    big_row, small_row = phase_main(torch, card)
    kp_rows = phase_kp(torch, card)
    schedule_rows = phase_schedules(torch, card)
    wave_rows = phase_wave(torch, card)
    reversal = phase_reversal(torch, card)
    swe_rows = phase_swe(torch, card)
    scan_rows = phase_scan(torch, card)
    cube = phase_3d(torch, card, pk)
    ckpt_rec = phase_checkpoint(torch, card)
    tel_rec, tel_launches = phase_telemetry(torch, card)
    tune_rec = phase_tune(torch, card, pk)
    res_rec = phase_resilience(torch, card)
    ranks, fused_launches, kp_sharded_launches = phase_sharded(card, 1)
    deep_ranks, deep_launches = phase_sharded_deep(card, 1)
    hide_ranks, hide_launches = phase_hide(card, 1)
    wave_deep_ranks, wave_deep_launches = phase_wave_deep(card, 1)
    swe_deep_ranks, swe_deep_launches = phase_swe_deep(card, 1)
    weak_ranks, weak_launches = phase_weak_scaling(card, 1)
    transport, transport_launches = phase_transport(torch, card, 1)
    serve_rec = phase_serve(torch, card)
    fleet_rec = phase_fleet(torch, card)

    # Launches on the main paths: each path ran with the counts set to 0
    # just before it and read just after.
    launches = {"masked_step": big_row["launches"]["masked_step"],
                "fused_step_cm": fused_launches + hide_launches["fused_step_cm"],
                "multi_step_cm": 0, "tb_sweep": deep_launches,
                "wave_step": hide_launches["wave_step"],
                "wave_step_masked": hide_launches["wave_step_masked"],
                "wave_multi_step": wave_deep_launches,
                "swe_step": hide_launches["swe_step"], "swe_multi_step": swe_deep_launches,
                # On no model path, as in the JAX package: the kernel cases only.
                "fused_step_padded": 0}
    for name in KP:
        launches[name] = kp_sharded_launches + sum(r["launches"][name] for r in kp_rows)
    for row in schedule_rows + wave_rows + swe_rows:
        for name in ("multi_step_cm", "tb_sweep", "wave_step", "wave_multi_step", "swe_step",
                     "swe_multi_step"):
            launches[name] += row["launches"][name]
    # The scan driver's runs: each case's last scan window.
    for row in scan_rows:
        for name, count in row["launches"].items():
            launches[name] += count
    # The weak-scaling rungs, then the transport phases: the host-staged
    # comparison's perf runs, the wire runs and every leg of the dry run.
    # [3d] and [checkpoint]: each run's counts, set to 0 just before it.
    for counts in (cube["perf"]["launches"], cube["deep"]["launches"], cube["hbm"]["launches"],
                   *(ckpt_rec[k][w] for k in ("perf", "deep", "swe")
                     for w in ("crashed_launches", "resumed_launches")),
                   weak_launches, transport_launches, tel_launches, res_rec["launches"],
                   serve_rec["launches"], fleet_rec["launches"]):
        for name, count in counts.items():
            launches[name] += count
    line = []
    for name, (replaces, source) in KERNELS.items():
        shape, form = MAIN_CASE[name]
        main = next(r for r in rows if r["kernel"] == name and r["dtype"] == "f32"
                    and r["shape"] == list(shape) and r["form"] == form)
        line.append(dict(
            name=name, route="cuda", source=f"rocm_mpi_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches[name],
            max_abs_err=max([r["max_abs_err"] for r in rows if r["kernel"] == name]
                            + ([serve_rec["hide_max_abs_err"]]
                               if name == "fused_step_cm" else [])),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
        ))
        if name == "masked_step":
            # The tuning plane's knob: the run lengths tried in [tune], ms each.
            line[-1]["run_rows_ms"] = {str(k): v for k, v in tune_rec["masked_step"].items()}
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            card=card, kind=kind, peaks=pk, build_s=build_s, kernel_phases=rows,
            main_12288=big_row, main_252=small_row, kp=kp_rows, schedules=schedule_rows,
            wave=wave_rows, reversal=reversal, swe=swe_rows, scan=scan_rows,
            sharded_ranks=ranks,
            sharded_deep_ranks=deep_ranks, hide_ranks=hide_ranks,
            wave_deep_ranks=wave_deep_ranks, swe_deep_ranks=swe_deep_ranks,
            weak_scaling_ranks=weak_ranks, three_d=cube, checkpoint=ckpt_rec, host=host,
            telemetry=tel_rec, tune=tune_rec, resilience=res_rec,
            transport=transport, serve=serve_rec, fleet=fleet_rec, kernels=line,
            seconds=time.perf_counter() - t0,
        ), indent=1, default=str))
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
