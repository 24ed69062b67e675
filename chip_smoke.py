#!/usr/bin/env python3
"""Smoke test of the tpu_qg_torch kernel routes on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card's name and power limit (nvidia-smi); no CUDA -> error.
2. build   — compiles the CUDA kernels of tpu_qg_torch/csrc at first use;
   the ptxas lines of the kernels that form a step point.
3. kernels — each kernel against its plain torch version on the card, on
   inputs made from a numpy seed: K1 (step, each launch by its
   row-streaming kernel, counted), K2 (y-DFT), K3 (mirror-pair
   x-kernel), K16 (the inversion in one launch, by its persistent
   kernel), K17 (the step in one launch) and K15 (the y-fused chain's
   step) at (2, 2048, 2048); K3 also
   at (2, 1024, 1024) and (2, 2048, 384) (its cluster kernel, counted), as
   "K3 mixed" at (2, 2432, 2048), (2, 1664, 256), (2, 896, 256) and (2,
   2304, 384) (its mixed cluster kernel, the mixed count checked) and at
   (2, 768, 256) and (2, 384, 256) (pair_x_kernel); K3's cluster
   kernel in every layout (G, Cw) at 1024^2 and 2048^2, and in six at
   4096^2 and 8192^2 (K7's grids), with the clusters the card holds and ms
   in turns beside pair_x_kernel (at 4096 and 8192 pair_cols_kernel on
   K7's self table), K4's and K5's cluster kernels in turn (the four-pass
   x-stage), one torch.fft.fft and torch.fft.ifft along x (a yardstick:
   not K3's function) and a copy, host-launched and replayed from a CUDA
   graph (k3_sweep); the block kernel (pair_cols_cluster_kernel) in every
   layout (G, Cw) for K13 at (2, 8192, 2048) and (2, 2048, 512) and K14 at
   (2, 2048, 512), and its mixed instance (pair_cols_cluster_mixed_kernel)
   for K13 at (2, 3072, 768) and K14 at (2, 1536, 512), with the clusters
   the card holds, its error and
   pair_cols_kernel's against plain, and ms in turns beside
   pair_cols_kernel, one torch.fft.fft of the own and mirror blocks and
   one torch.fft.ifft along x (a yardstick) and a copy, both ways of
   timing (k13_sweep); K8 (step +
   modes) at (2, 2048, 2048) with the pin gauge and (1, 2048, 2048) single
   layer; K2 on (2, 333, P) at P = 256 ... 8192 (its factored kernel, a
   ragged last block in every layout with Rb > 1, the factored count
   checked) and at P = 384, 768, 1536, 2432, 3072, 6144, 7808 and 8064 (its
   mixed-radix form, y_dft_mixed_kernel, as "K2 mixed", the mixed count
   checked) and at P = 96 and 128 (y_dft_kernel, neither count moving);
   K2's factored kernel in each
   layout (Rb rows, threads) of K2_SWEEP at n^2, n = 256 ... 8192, with the
   blocks an SM holds and ms each way in turns beside y_dft_kernel (the
   kernel it replaces there, checked), torch.fft.fft along y and a copy of
   the field, host-launched and replayed from a CUDA graph; K2's mixed extents
   on (2, 333, 384), (2, 333, 2432) and (2, n, n), n = 2432, 1536, 3072,
   6144 and 7808: the mixed-radix kernel in its launched layout (and at
   1536, 2432, 3072 and 6144 in each layout of K2_MIXED_SWEEP, checked),
   ms each way beside
   y_dft_kernel (the kernel it replaces, checked), torch.fft.fft along y and a copy,
   in turns, both ways of timing (k2_mixed); the mixed instances' ptxas
   lines in the build phase; K4's mixed extents on (2, n, n), n = 2560,
   3072, 4224, 6144 and 7808: the mixed cluster kernel
   (x_dft_cluster_mixed_kernel) in every layout (G, Cw) that fits, checked,
   with the clusters the card holds, ms each way beside x_dft_kernel (the
   kernel it replaces, checked), one torch.fft.fft along x and a copy, in
   turns, both ways of timing (k4_mixed); its ptxas line in the build
   phase; K5's mixed extents on (2, n, n), n = 2560, 3072, 6144 and 7808:
   the mixed cluster kernel (x_symbols_cluster_mixed_kernel) in every
   layout (G, Cw) that fits, checked, with the clusters the card holds, ms
   beside x_symbols_inverse_kernel (the kernel it replaces, checked), one
   torch.fft.ifft along x (a yardstick: not K5's function) and a copy, in
   turns, both ways of timing (k5_mixed); its ptxas line in the build
   phase; K3's mixed extents on (2, n, n), n = 1536, 1920 and 2432: the
   mixed cluster kernel (pair_x_cluster_mixed_kernel) in every layout (G,
   Cw) that fits, checked, with the clusters the card holds, ms beside
   pair_x_kernel (the kernel it replaces, checked), one torch.fft.fft and
   torch.fft.ifft along x (a yardstick) and a copy, in turns, both ways of
   timing (k3_mixed); its ptxas line in the build phase;
   K2, K4 (x-DFT, both ways,
   and its cluster kernel's first half, stage A) and K5 (symbols + inverse
   x-DFT) at (2, 4096, 4096) and
   (2, 8192, 8192), K4 also at (2, 8192, 252) (a ragged last cluster tile),
   as "K4 mixed" at (2, n, n), n = 2560, 3072, 4224 and 6144, (2, 7808,
   512) and (2, 6144, 2048) (its mixed cluster kernel, both ways and stage
   A, the mixed count checked) and at (2, 768, 384) (x_dft_kernel, M < 128
   G, neither cluster count moving), K5 also at
   (2, 8192, 384) (strip 0's ragged tile, an odd strip count; K5 by its
   cluster kernel at each of these, counted), as "K5 mixed" at (2, 2816,
   384), (2, 2944, 384) and (2, 6144, 384) (its mixed cluster kernel, the
   mixed count checked, the cluster count not moving) and at (2, 1536,
   384) (x_symbols_inverse_kernel, neither count moving); K4's cluster kernel
   in every layout (G, Cw) that fits at 4096^2 and 8192^2, with
   the clusters the card holds at once and ms each way in turns beside
   torch.fft.fft; K5's cluster kernel in every layout (G, Cw) that
   fits at 4096^2 and 8192^2, with the clusters the card holds and ms in
   turns beside x_symbols_inverse_kernel, torch.fft.ifft along x (a
   yardstick: not K5's function) and a copy, host-launched and replayed
   from a CUDA graph; K1 (bitwise the tile kernel on one step case) and
   K15 at (2, 8192, 8192); K1's row-streaming kernel in every layout (W, R,
   D, NT)
   at 2048^2 and 8192^2, bitwise the tile kernel, with its registers,
   spills and blocks an SM, graph-replayed in turns beside the tile kernel
   (step_kernel), K18 base and a copy of three fields, and K12's
   row-streaming kernel on the one-rank block (2, n, n) beside its tile
   kernel, bitwise K1 (k1_sweep); K17
   at (2, 6272, 128) (the x-stage's sequential groups, its first form). K17,
   K15, K16 and K15's sharded form by their persistent kernels
   (csrc/coop_rows.cuh) at COOP_SWEEP's grids (K17 2048^2, 1536^2, 2560^2;
   K15 2048^2, 3072^2, 8192^2; K16 2048^2, 1536^2; K15s on the blocks
   (2, 2048, 2048) and (2, 512, 2048)): bitwise the separate routes (K1 ->
   K2 -> K3 -> K2^-1; K2^-1 -> K1 -> K2; K2 -> K3 -> K2^-1; K2^-1 of the
   block and of each psi slab -> K12 -> K2), within TOL of the first forms
   and the plain versions (psi against float64 where 1/lambda lifts it
   past TOL), the launch grid (blocks, clusters, blocks an SM, the step
   units' rows), the grid barrier and the ptxas lines, graph-replayed in
   turns beside the first form, the separate route and a copy of the same
   bytes (K15s on (2, 512, 2048) also host-launched and its host enqueue
   ms: coop_sweep). On
   the real zeta of a grid-noise psi the inversions (K3; K16; K5; the
   four-pass K2 -> K4 -> K5 -> K2^-1) are held against float64. K10 (the
   multigrid smoother: restrict, residual and smooth-only forms) and K11
   (prolongation + smoother) at every level of the pod-8192-mg solver
   (8192^2 .. 64^2), turbulence-2048's (2048^2 .. 64^2) and its 1536^2
   grid's (1536^2 .. 48^2), with the level's spacing, alpha = (0, S_eig)
   and nu = 2: the row-streaming kernel (mg_rows_kernel) bitwise the tile
   kernel (mg_smooth_kernel, mg_prolong_kernel) and within TOL of the plain
   version, one line a solver; the row kernel's restrict form and K11 in
   every layout (R, D, NT) at the 8192^2 .. 512^2 and 64^2 levels,
   bitwise the tile kernel, with registers, spills and blocks an SM,
   graph-replayed in turns beside the tile kernel and a copy of the same
   bytes (mg_sweep); K9 (the tendency) at (2, 2048, 2048),
   (1, 2048, 2048) with the wind and (2, 8192, 8192); K9's row-streaming
   kernel in every layout at 2048^2 and 8192^2, bitwise across layouts and
   the tile kernel, with its registers, spills and blocks an SM,
   graph-replayed in turns beside the tile kernel and a copy of its bytes,
   and its two-layer tendency bitwise K1's euler_ab3 step-0 carry
   (k9_sweep). K18 (the stencil lab's step) in each of its six variants on
   the step cases at the lab's (2, 2048, 2048) by its row kernel, base,
   legacy and aligned bitwise K1, and every body, one and two layers, on
   the row kernel bitwise the tile kernel at (2, 2048, 2048) and
   (1, 256, 256).
4. slices  — through the normal entry point run_model, each with the
   kernels' launch counts set to 0 just before and read just after, the
   route QGModel resolves, a finite state with CFL < 1, and the same steps
   on the plain route (fft_impl="xla", use_pallas=False) from the same psi:
   turbulence-2048 (100 steps: K1, K2, K3; every K2 launch, here and on
   every path below, by its factored kernel, every K3 launch by its
   cluster kernel, every K1 launch, here and below, by its row-streaming
   kernel, "K1 rows" = K1), with the pin gauge (100: K8), with
   fft_mono="on" (100: K1, K16, every K16 launch by its persistent kernel,
   "K16 rows" = K16), step_full="on" (100: K17, every launch
   by its persistent kernel, "K17 rows" = K17) and step_chain="on" (100:
   K15, the same, "K15 rows" = K15, K3,
   K2 at the ends of each run call; the same);
   pod-8192 (50 steps: K1, K2, K4, K5, every K4 and K5 launch by its
   cluster kernel) and with step_chain="on" (20: K15, "K15 rows" = K15,
   K4, K5, K2; the same);
   turbulence-2048's configuration at 1536^2 (100 steps: K1, K2, K3, every
   K2 launch by the mixed-radix kernel, "K2 mixed" = K2, every K3 launch by
   its mixed cluster kernel, "K3 mixed" = K3)
   and at 3072^2 (50: K1, K2, K4, K5; the same, every K4 and K5 launch by
   its mixed cluster kernel, "K4 mixed" = K4, "K5 mixed" = K5);
   turbulence-2048 with fft_impl="matmul" (100: K1, every other count 0:
   the inversion is the matmul-factorized DFT on torch.matmul).
   Then, with the counts set to 0 again each time, two
   multigrid paths: 20 warm-started MultigridModalInverter calls on the zeta
   one default step after the pod-8192 slice (pod-8192-mg: 2 cycles a call,
   its 5 levels of extent >= 512 kernel levels, K10 = K11 = 200) and after
   the turbulence-2048 slice (4 cycles, 3 kernel levels, 240), every K10
   and K11 launch by the row-streaming kernel ("K10 rows" = K10, "K11
   rows" = K11),
   each against the plain MG route and a float64 spectral solve; and the
   tendency path (20 K9 calls on the turbulence-2048 state, every one by
   the row-streaming kernel, "K9 rows" = K9). The stencil lab's path
   through its own function (tpu_qg_torch.scripts.stencil_lab run_lab) at
   2048^2, chunk 50, reps 4, all six variants: K18 = "K18 rows" = 6 x 50 x
   5 = 1500, every other count 0; each variant's final zeta against a loop of
   its plain version from the same state.
   The sharded kernels against their plain versions, inputs from numpy
   seeds, relative to max|plain|: K12 on the row block (2, 512, 2048) of a
   2048^2 state with its 2-row slabs sliced from the global field (and
   against K1's rows of the whole field) and on (2, 2048, 8192) of an
   8192^2 state; K15's sharded form on the 2048^2 block; K13 on
   (2, 2048, 512) at strip offsets 0 and 12 and on (2, 8192, 2048) at 32
   (the block kernel), as "K13 mixed" on (2, 3072, 768) at 0 and 6 and on
   (2, 2432, 512) at 0 and 12 (its mixed instance), and on (2, 768, 256)
   at 0 and 6 (pair_cols_kernel); K14 on (2, 2048, 512) with the group
   indices of ranks 0 and 3 of strip_pair_order(16) (the block kernel), as
   "K14 mixed" on (2, 1536, 512) with ranks 0's and 2's and on
   (2, 2432, 512) with rank 0's (its mixed instance), and on (2, 768, 256)
   with ranks 0's and 3's of strip_pair_order(8) (pair_cols_kernel); K7 on
   (2, 4096, 4096) and (2, 8192, 8192) (K3's cluster kernel), as "K7
   mixed" on (2, 3072, 3072) and (2, 2432, 2048) (K3's mixed cluster
   kernel) and on (2, 768, 256) (pair_cols_kernel), each with its cluster
   and mixed counts checked, and on the real zeta of pod-8192's grid-noise
   psi against float64 (no worse than 2 x plain).
4b. mesh   — the halo stepper (tpu_qg_torch.parallel) through run_model
   (..., mesh=...), the launch counts set to 0 just before each slice and
   read just after, zeta against the single-device route of the same
   config from the same psi, every K12 launch by its row-streaming kernel
   ("K12 rows" = K12, on every rank): a one-rank NCCL mesh on cuda:0,
   turbulence-2048 (100 steps: K12, K2, K3, every K3 launch by its cluster
   kernel), pod-8192 (20: K12, K2, K4, K5, every K4 and K5 launch by its
   cluster kernel) and turbulence-2048 with step_chain="on" (20: K15
   sharded, every launch by its persistent kernel, "K15s rows" = K15s, K3
   (the same), K2
   at the ends), zeta within 1e-6, and pod-8192-mg (20 steps of the
   distributed multigrid, route "generic-mg", every count 0, zeta within
   1e-4 of a plain single-device MG reference and of the spectral route,
   else the float64 rule; run_model's checkpoint_mode="auto" writes its
   snapshots every 10 steps and its checkpoint as shard files, which
   load_checkpoint_sharded and load_checkpoint read back bit for bit; a 10-cycle
   DistributedMultigridInverter of the final zeta within 1e-5 of the
   spectral inversion, else the float64 rule); then four spawned ranks sharing cuda:0
   on gloo (the kernels built once, here, before they start): (4, 1)
   turbulence-2048 (10 steps: K12, K2, K14), its chain (10: K15 sharded,
   "K15s rows" = K15s, K14), (2, 2) turbulence-2048 (10: K12, K2, K13), (4, 1) pod-8192 (5:
   K12, K2, K13), (4, 1) turbulence-2048 at 3072^2 (10: K12, K2 by its
   mixed-radix form, K13 on (2, 3072, 768)) and at 1536 x 2048 (10: K12,
   K2, K14 on (2, 1536, 512)) and (2, 2) pod-8192-mg at 2048^2 (10 steps,
   every count 0, each rank writing its shard file, which rank 0's
   RunReader.load_checkpoint assembles bit for bit into the gathered
   state), the counts checked on every rank, zeta and
   psi gathered to rank 0 and zeta held within 1e-4 of the single-device
   route (else the float64 rule), every K13 and K14 launch by the block
   kernel ("K13 cluster" = K13, "K14 cluster" = K14), at the mixed extents
   by its mixed instance ("K13 mixed" = K13, "K14 mixed" = K14); K7's
   paths: 20 inversions with the inverter's pair_stream pinned on, of
   pod-8192's zeta (K2, K7, every K7 launch by K3's cluster kernel, "K7
   cluster" = K7, K3 = 0) and of the 3072^2 slice's (K2 by its mixed-radix
   form, K7, every K7 launch by K3's mixed cluster kernel, "K7 cluster" =
   "K7 mixed" = K7, K3 = 0), psi against float64. The gspmd route
   (tpu_qg_torch.parallel.gspmd: the single-device per-mode step on
   DTensors; route "gspmd", no kernel) through run_model(...,
   parallel_impl="gspmd"): turbulence-2048 on the one-rank mesh (20
   steps) and on the four ranks' (2, 2) mesh (5 steps), every count 0 on
   every rank, zeta within 1e-6 and psi within 1e-4 of the single-device
   per-mode step (make_step_fn(cfg, batched_fft=False)) on the card; the
   collectives of one step by type (CommDebugMode) and the bytes a rank
   sends in it, by kind. Each
   rank's process group and the parent's join have time limits; a rank
   that fails fails the script.
5. timing  — CUDA-event ms per step of each route by QGModel.run, in turns
   (the routes, then again in reverse), per kernel beside its plain version
   and, for K2 and K4, beside one torch.fft call on the same complex64
   field, at 2048^2 (every route; K8 too) and 8192^2 (default, chain and
   plain; K15 too);
   host enqueue ms per step; the device's busy share over CUDA-only traces
   of the default route (both grids) and the fullstep route (2048^2); ms per
   step of the default and plain routes at 1536^2 and 3072^2, in turns. For
   each multigrid path: ms per MG call on the kernel and plain routes
   beside the spectral inversion of the same zeta, the kernel route's call
   also replayed from a CUDA graph (its device time), K10/K11 per launch at
   every level and K9 beside their plain versions, K10's restrict form and
   K11 at every level graph-replayed in turns beside the tile kernels and a
   copy of the same bytes, host enqueue ms per call, and (8192^2) the busy
   share over one traced MG call. The mesh: ms per step of the one-rank mesh against the
   single-device route at 2048^2 and 8192^2, in turns; pod-8192-mg's ms per
   step on the one-rank mesh beside pod-8192's, in turns, with host enqueue
   ms per step and the calls that wait for the device in a step beside
   each, and the sharded checkpoint write (seconds, bytes) in phase 4b; K12, K13, K14, K15's
   sharded form and K7 per launch beside their plain versions at the
   mesh slices' shapes (K12 beside its tile kernel; K13, K14 and K7 beside
   pair_cols_kernel), and K13, K14 and K7 mixed at (2, 3072, 768),
   (2, 1536, 512) and (2, 3072, 3072), host-launched and graph-replayed
   beside pair_cols_kernel, the plain version and a yardstick (one
   torch.fft.fft and one torch.fft.ifft along x), and at (2, 768, 256) by
   pair_cols_kernel, which keeps that extent; the kernels of a (4, 1)
   pod-8192 rank's step at its
   shapes (K12, K2 both ways, K13 by each kernel) and their sum; ms per
   step of each
   four-rank slice (host-staged
   gloo transport on one card: not a scaling result); ms per step of the
   gspmd route beside the halo route's, in turns, on the one-rank mesh at
   2048^2 and on the four ranks' (2, 2) mesh. The lab: ms per
   launch of each K18 variant (the row kernel) beside K1 and each body's
   tile kernel in turns, host-launched and graph-replayed, each beside its
   plain version, and the lab path's own ms per step.
6. accuracy — the float64 checks (tpu_qg_torch.scripts and
   tpu_qg_torch.validation) on the card, one line each; a failed gate
   fails the script after every line is printed. At 2048^2 and 8192^2
   (the checks' configuration, Lx = Ly = 4000 km, float32): one packed
   inversion of a seeded zeta under the torch_fft, matmul and kernels tiers
   against the float64 inversion (inv_f64_check: matmul and kernels within
   2x torch_fft's error), the matmul inversion again with
   torch.backends.cuda.matmul.allow_tf32 = True (bitwise the same; beside
   it whether TF32 moves a plain complex64 matmul), ms per inversion of
   each tier in turns, and ms per step of the default route (the kernels),
   use_pallas with fft_impl="matmul" (K1 and the matmul inversion) and the
   plain route (torch.fft), in turns (time_routes); step_f64_check (10
   steps under each tier against float64, each within 2x torch_fft's
   error). allclose at 256^2, 500 steps, float64 on the card against the
   float64 NumPy twin on the host: rel_err below 1e-5 on zeta and psi.
   accuracy_drift at 2048^2, 1000 steps in chunks of 100, the kernels tier
   against the torch_fft tier: the largest relative energy and enstrophy
   differences and the final spectra's, printed, not gated.

The line before the last is {"kernels": [...]}, every kernel with its
launches in phase 4 (K2 mixed a row of its own, at (2, 2432, 2432), its
launches not in K2's; K3 mixed likewise, at (2, 1536, 1536); K4 mixed and
K5 mixed at (2, 3072, 3072); K13 mixed, K14 mixed and K7 mixed at
(2, 3072, 768), (2, 1536, 512) and (2, 3072, 3072), each with its
yardstick's ms), its largest error, its ms, its plain version's ms
(K10/K11: at the 8192 level, with every level of both solvers beside),
its bound (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
the larger) and its library call's ms; the last is {"ok": true, "device":
{...}}. Imports nothing of JAX or tpu_qg.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import shutil
import socket
import subprocess
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import tpu_qg_torch
from tpu_qg_torch import preset
from tpu_qg_torch.constants import DAY
from tpu_qg_torch.io import RunReader, RunWriter
from tpu_qg_torch.models.core import (QGModel, State, _next_state, init_state,
                                     make_step_fn)
from tpu_qg_torch.ops import _build, dft_kernels
from tpu_qg_torch.ops.dft_kernels import (
    mirror_companion, mono_invert, mono_invert_coop, mono_invert_plain,
    mono_invert_rows, mono_rows_plan, mono_rows_takes, pair_cols_cluster,
    pair_cols_cluster_launched, pair_cols_cluster_layout,
    pair_cols_cluster_occupancy, pair_cols_cluster_takes,
    pair_cols_whole_columns, pair_x_cluster, pair_x_cluster_layout,
    pair_x_cluster_occupancy, pair_x_cluster_takes, pair_x_symbols,
    pair_x_symbols_plain, pair_x_whole_columns, paired_x_symbols,
    paired_x_symbols_plain, stream_pair_cluster_takes,
    stream_pair_symbols, stream_pair_symbols_plain, x_dft, x_dft_cluster,
    x_dft_cluster_layout, x_dft_cluster_occupancy, x_dft_cluster_takes,
    x_dft_plain, x_dft_stage_a, x_dft_stage_a_plain, x_dft_whole_columns,
    x_fwd_symbols_offset,
    x_fwd_symbols_offset_plain, x_symbols_cluster, x_symbols_cluster_layout,
    x_symbols_cluster_occupancy, x_symbols_cluster_takes, x_symbols_inverse,
    x_symbols_inverse_plain, x_symbols_whole_columns, y_dft, y_dft_factored,
    y_dft_factored_layout, y_dft_factored_occupancy, y_dft_plain,
    y_dft_whole_row)
from tpu_qg_torch.ops import mg_kernels
from tpu_qg_torch.ops.mg_kernels import (mg_prolong_smooth,
                                         mg_prolong_smooth_plain,
                                         mg_prolong_tile, mg_rows,
                                         mg_rows_attributes, mg_rows_launched,
                                         mg_rows_layouts, mg_smooth,
                                         mg_smooth_plain, mg_smooth_tile)
from tpu_qg_torch.ops._stencil_lab import (lab_rows_attributes, lab_step,
                                           lab_step_plain, lab_step_rows,
                                           lab_step_tile)
from tpu_qg_torch.ops.multigrid import MultigridModalInverter, MultigridSolver
from tpu_qg_torch.ops.spectral import (PackedModalInverter,
                                       PackedModalInverterKernels)
from tpu_qg_torch.ops import step_kernel
from tpu_qg_torch.ops.step_kernel import (HALO_ROWS, fused_pre_inversion,
                                          fused_pre_inversion_plain,
                                          coop_rows_plan, coop_rows_takes,
                                          fused_step, fused_step_full,
                                          fused_step_full_coop,
                                          fused_step_full_plain,
                                          fused_step_full_rows,
                                          fused_step_plain, fused_step_rows,
                                          fused_step_sharded,
                                          fused_step_sharded_plain,
                                          fused_step_sharded_tile,
                                          fused_step_tile,
                                          fused_step_yspec,
                                          fused_step_yspec_coop,
                                          fused_step_yspec_plain,
                                          fused_step_yspec_rows,
                                          fused_step_yspec_sharded,
                                          fused_step_yspec_sharded_coop,
                                          fused_step_yspec_sharded_plain,
                                          fused_step_yspec_sharded_rows,
                                          fused_tendency,
                                          fused_tendency_plain,
                                          fused_tendency_rows,
                                          fused_tendency_tile,
                                          step_rows_attributes,
                                          step_rows_launched,
                                          step_rows_layouts,
                                          tendency_rows_attributes,
                                          tendency_rows_launched)
from tpu_qg_torch.parallel import (gather_state, gspmd, make_halo_run_fn,
                                   make_mesh, shard_state)
from tpu_qg_torch.parallel.multigrid import DistributedMultigridInverter
from tpu_qg_torch.parallel.paired import strip_pair_order
from tpu_qg_torch.run import make_gspmd_blocks_run_fn, run_model
from tpu_qg_torch.scripts import (accuracy_drift, inv_f64_check,
                                  stencil_lab, step_f64_check)
from tpu_qg_torch.utils.diagnostics import diagnostics
from tpu_qg_torch.utils.profiling import HBM_BANDWIDTH
from tpu_qg_torch.validation import allclose

SEED = 1234
# turbulence-2048's configuration on two grids whose extents are mixed (128
# n, n not a power of two): 1536^2 (n = 12) takes the three-pass inversion,
# 3072^2 (n = 24) the four-pass one.
MIXED_PATHS = ("turbulence-2048 at 1536^2", "turbulence-2048 at 3072^2")
# Phase 6's allclose (grid, steps) and drift (grid, steps, chunk).
ACCURACY = dict(allclose_M=256, allclose_steps=500, drift_M=2048,
                drift_steps=1000, drift_chunk=100)
# Relative to max|plain|: the 1/lambda symbol amplifies low-k float32
# rounding in K3/K5/K16 and K17's psi; K15's zeta_ys is a y-DFT (K2's
# gate); the slices' zeta after many steps on two routes.
# K9 is K1's body; K10/K11 carry tests/test_multigrid.py's kernel gate; an
# MG path's psi the dryrun multigrid gate (commit 26d1ffc) against the
# plain MG route.
TOL = {"K1": 1e-6, "K2": 1e-5, "K2 mixed": 1e-5, "K3": 1e-4,
       "K3 mixed": 1e-4, "K4": 1e-5,
       "K4 mixed": 1e-5, "K5": 1e-4, "K5 mixed": 1e-4,
       "K7": 1e-4, "K7 mixed": 1e-4, "K8": 1e-6, "K9": 1e-6, "K10": 1e-6,
       "K11": 1e-6,
       "K12": 1e-6, "K13": 1e-4, "K13 mixed": 1e-4, "K14": 1e-4,
       "K14 mixed": 1e-4, "K15": 1e-6,
       "K15 zeta_ys": 1e-5, "K15s": 1e-6, "K16": 1e-4, "K17": 1e-6,
       "K18": 1e-6,
       "K17 psi_new": 1e-4, "slice_zeta": 1e-4, "mesh1_zeta": 1e-6,
       "mg_psi": 1e-5, "gspmd_zeta": 1e-6, "gspmd_psi": 1e-4}
FUSED = "tpu_qg_torch/csrc/fused_kernels.cu"
COOP = "tpu_qg_torch/csrc/coop_rows.cuh"
MG = "tpu_qg_torch/csrc/mg_kernels.cu"
KERNELS = {
    "K1": ("fused_step", "tpu_qg_torch/csrc/step_kernel.cu",
           "tpu_qg/ops/pallas_tendency.py:555"),
    "K2": ("y_dft", "tpu_qg_torch/csrc/dft_kernels.cu",
           "tpu_qg/ops/pallas_fft.py:1100"),
    "K3": ("pair_x_symbols", "tpu_qg_torch/csrc/dft_kernels.cu",
           "tpu_qg/ops/pallas_fft.py:1270"),
    "K4": ("x_dft", "tpu_qg_torch/csrc/dft_kernels.cu",
           "tpu_qg/ops/pallas_fft.py:1153"),
    "K5": ("x_symbols_inverse", "tpu_qg_torch/csrc/dft_kernels.cu",
           "tpu_qg/ops/pallas_fft.py:1176"),
    "K8": ("fused_pre_inversion", "tpu_qg_torch/csrc/step_kernel.cu",
           "tpu_qg/ops/pallas_tendency.py:1059"),
    "K9": ("fused_tendency", "tpu_qg_torch/csrc/step_kernel.cu",
           "tpu_qg/ops/pallas_tendency.py:181"),
    "K10": ("mg_smooth", MG, "tpu_qg/ops/pallas_mg.py:340"),
    "K11": ("mg_prolong_smooth", MG, "tpu_qg/ops/pallas_mg.py:298"),
    "K15": ("fused_step_yspec", COOP, "tpu_qg/ops/pallas_tendency.py:839"),
    "K16": ("mono_invert", COOP, "tpu_qg/ops/pallas_fft.py:1342"),
    "K17": ("fused_step_full", COOP, "tpu_qg/ops/pallas_fullstep.py:308"),
    "K7": ("stream_pair_symbols", "tpu_qg_torch/csrc/dft_kernels.cu",
           "tpu_qg/ops/pallas_fft.py:1304"),
    "K12": ("fused_step_sharded", "tpu_qg_torch/csrc/step_kernel.cu",
            "tpu_qg/ops/pallas_tendency.py:608"),
    "K13": ("x_fwd_symbols_offset", "tpu_qg_torch/csrc/dft_kernels.cu",
            "tpu_qg/ops/pallas_fft.py:1204"),
    "K14": ("paired_x_symbols", "tpu_qg_torch/csrc/dft_kernels.cu",
            "tpu_qg/parallel/paired.py:226"),
    "K15s": ("fused_step_yspec_sharded (K15's sharded form)", COOP,
             "tpu_qg/ops/pallas_tendency.py:913"),
    "K18": ("lab_step", "tpu_qg_torch/csrc/lab_kernel.cu",
            "tpu_qg/ops/_stencil_lab.py:325"),
}


class KernelCount:
    """A wrapper's count of the launches that took one of its two kernels
    (x_dft.cluster_launches: K4's cluster kernel; x_dft.mixed_launches:
    its mixed-radix form;
    x_symbols_inverse.cluster_launches: K5's cluster kernel;
    x_symbols_inverse.mixed_launches: its mixed-radix form;
    pair_x_symbols.cluster_launches: K3's;
    pair_x_symbols.mixed_launches: its mixed-radix form;
    x_fwd_symbols_offset.cluster_launches and
    paired_x_symbols.cluster_launches: K13's and K14's block kernel, both
    instances; x_fwd_symbols_offset.mixed_launches and
    paired_x_symbols.mixed_launches: its mixed instance,
    pair_cols_cluster_mixed_kernel; stream_pair_symbols.cluster_launches:
    K7's launches of K3's cluster kernels; stream_pair_symbols.mixed_launches:
    of K3's mixed cluster kernel; y_dft.factored_launches: K2's factored
    kernel; y_dft.mixed_launches: its mixed-radix form; fused_step.rows_launches and fused_step_sharded.rows_launches:
    K1's and K12's row-streaming kernel; mg_smooth.rows_launches and
    mg_prolong_smooth.rows_launches: K10's and K11's, mg_rows_kernel;
    fused_step_yspec.rows_launches, fused_step_full.rows_launches,
    mono_invert.rows_launches and fused_step_yspec_sharded.rows_launches:
    K15's, K17's, K16's and K15's sharded persistent kernels,
    coop_yspec_rows_kernel, coop_fullstep_rows_kernel,
    coop_mono_rows_kernel and coop_yspec_sharded_rows_kernel;
    fused_tendency.rows_launches and lab_step.rows_launches: K9's and K18's
    row-streaming kernels, tendency_rows_kernel and lab_rows_kernel), as a
    counter with a ``launches`` field."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.wrapper, self.attr, n)


COUNTERS = {"K1": fused_step, "K2": y_dft, "K3": pair_x_symbols,
            "K4": x_dft, "K5": x_symbols_inverse, "K8": fused_pre_inversion,
            "K9": fused_tendency, "K10": mg_smooth,
            "K11": mg_prolong_smooth, "K15": fused_step_yspec,
            "K16": mono_invert, "K17": fused_step_full,
            "K7": stream_pair_symbols, "K12": fused_step_sharded,
            "K13": x_fwd_symbols_offset, "K14": paired_x_symbols,
            "K15s": fused_step_yspec_sharded, "K18": lab_step,
            "K4 cluster": KernelCount(x_dft, "cluster_launches"),
            "K4 mixed": KernelCount(x_dft, "mixed_launches"),
            "K5 cluster": KernelCount(x_symbols_inverse, "cluster_launches"),
            "K5 mixed": KernelCount(x_symbols_inverse, "mixed_launches"),
            "K3 cluster": KernelCount(pair_x_symbols, "cluster_launches"),
            "K3 mixed": KernelCount(pair_x_symbols, "mixed_launches"),
            "K13 cluster": KernelCount(x_fwd_symbols_offset,
                                       "cluster_launches"),
            "K13 mixed": KernelCount(x_fwd_symbols_offset, "mixed_launches"),
            "K14 cluster": KernelCount(paired_x_symbols, "cluster_launches"),
            "K14 mixed": KernelCount(paired_x_symbols, "mixed_launches"),
            "K7 cluster": KernelCount(stream_pair_symbols,
                                      "cluster_launches"),
            "K7 mixed": KernelCount(stream_pair_symbols, "mixed_launches"),
            "K2 factored": KernelCount(y_dft, "factored_launches"),
            "K2 mixed": KernelCount(y_dft, "mixed_launches"),
            "K1 rows": KernelCount(fused_step, "rows_launches"),
            "K12 rows": KernelCount(fused_step_sharded, "rows_launches"),
            "K10 rows": KernelCount(mg_smooth, "rows_launches"),
            "K11 rows": KernelCount(mg_prolong_smooth, "rows_launches"),
            "K15 rows": KernelCount(fused_step_yspec, "rows_launches"),
            "K17 rows": KernelCount(fused_step_full, "rows_launches"),
            "K16 rows": KernelCount(mono_invert, "rows_launches"),
            "K15s rows": KernelCount(fused_step_yspec_sharded,
                                     "rows_launches"),
            "K9 rows": KernelCount(fused_tendency, "rows_launches"),
            "K18 rows": KernelCount(lab_step, "rows_launches")}
# Kernel names in a profiler trace, the one-launch kernels, the
# row-streaming K9, K18, K1 and K12, K8, K9, K12 and K18 before K1's tile
# kernel: a mangled name of any kernel of step_kernel.cu holds the source
# file's name, step_kernel, and K18's lab_step_kernel holds it too. K13 and K14 are one
# kernel, pair_cols_cluster_kernel, and its mixed instance
# pair_cols_cluster_mixed_kernel (before pair_cols_kernel, which serves
# K7, K13 and K14 at other extents); K7's launches of K3's cluster kernels
# carry K3's names (the counters tell them apart).
TRACE_NAMES = (("K9 rows", "tendency_rows_kernel"),
               ("K18 rows", "lab_rows_kernel"),
               ("K12", "step_rows_sharded_kernel"),
               ("K1", "step_rows_kernel"),
               ("K17 rows", "coop_fullstep_rows_kernel"),
               ("K15 rows", "coop_yspec_rows_kernel"),
               ("K16 rows", "coop_mono_rows_kernel"),
               ("K15s rows", "coop_yspec_sharded_rows_kernel"),
               ("K17", "coop_fullstep_kernel"), ("K16", "coop_mono_kernel"),
               ("K15s", "coop_yspec_sharded_kernel"),
               ("K15", "coop_yspec_kernel"), ("K12", "step_sharded_kernel"),
               ("K13/K14 mixed", "pair_cols_cluster_mixed_kernel"),
               ("K13/K14", "pair_cols_cluster_kernel"),
               ("K7/K13/K14", "pair_cols_kernel"),
               ("K10/K11 rows", "mg_rows_kernel"),
               ("K11", "mg_prolong_kernel"),
               ("K10", "mg_smooth_kernel"), ("K9", "tendency_kernel"),
               ("K8", "pre_inversion_kernel"),
               ("K5 mixed", "x_symbols_cluster_mixed_kernel"),
               ("K5", "x_symbols_cluster_kernel"),
               ("K5", "x_symbols_inverse_kernel"),
               ("K4 mixed", "x_dft_cluster_mixed_kernel"),
               ("K4", "x_dft_cluster_kernel"), ("K4", "x_dft_kernel"),
               ("K3 mixed", "pair_x_cluster_mixed_kernel"),
               ("K3", "pair_x_cluster_kernel"), ("K3", "pair_x_kernel"),
               ("K2", "y_dft_factored_kernel"),
               ("K2 mixed", "y_dft_mixed_kernel"),
               ("K2", "y_dft_kernel"),
               ("K18", "lab_step_kernel"), ("K1", "step_kernel"))

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory bandwidth (the port's one table, utils/profiling.py) and the
# float32 rate without tensor cores.
PEAK_BYTES_PER_S = HBM_BANDWIDTH["NVIDIA H100 80GB HBM3"]
PEAK_F32_PER_S = 67e12
# Operations of the step per point and layer (step_tile: lap(psi) 6,
# del^4 7, the Arakawa Jacobian 32, d/dx terms and drag ~9, the AB3
# update ~9).
STEP_OPS = 63
# Operations of the multigrid kernels per fine point and mode: a sweep 13
# ((lap + alpha) w 10, f - that, the scaled update 2), the residual 11, the
# restriction 20 per coarse point, the prolongation ~3.
MG_SWEEP_OPS, MG_RESIDUAL_OPS, MG_RESTRICT_OPS, MG_PROLONG_OPS = 13, 11, 20, 3
MG_NU = 2


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max|a-b|, max|a-b| / max|b|)."""
    d = float((a - b).abs().max())
    return d, d / float(b.abs().max())


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device ms per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device ms per call over ``reps`` calls captured in one CUDA
    graph and replayed, by CUDA events: the device's time without the
    host's cost of each launch, which bounds time_ms on a small field."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def free_memory() -> None:
    """Drop the plain versions' cached tables and the allocator's cache."""
    dft_kernels._symbols.cache_clear()
    dft_kernels._strip_symbols.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def inverter(cfg) -> PackedModalInverterKernels:
    return PackedModalInverterKernels(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                      cfg.P_inv_matrix(),
                                      cfg.back_projection_matrix(),
                                      pair_x=cfg.fft_pairx != "off")


def bound(name: str, M: int, P: int) -> tuple[float, str, float]:
    """(bound ms, "bytes" or "operations", bytes) of one launch of kernel
    ``name`` on a two-layer (M, P) grid or block: each input field read once
    and each output written once, against 5 N log2 N operations per complex
    transform of length N and STEP_OPS per point and layer (K13 transforms
    two columns forward and one back per output column; K7 is K3's
    function)."""
    field = 2 * M * P * 4

    def ffts(n: int, count: int) -> float:
        return 5.0 * n * math.log2(n) * count

    step = 2 * STEP_OPS * M * P
    mono = 2 * ffts(P, M) + ffts(M, 2 * P)
    sweeps = 2 * MG_NU * MG_SWEEP_OPS * M * P
    residual = 2 * MG_RESIDUAL_OPS * M * P
    fields, ops = {
        "K1": (6, step), "K2": (2, ffts(P, M)), "K3": (2, ffts(M, 2 * P)),
        "K4": (2, ffts(M, P)), "K5": (2, ffts(M, P)), "K8": (7, step),
        "K9": (3, 2 * (STEP_OPS - 9) * M * P),
        "K10": (3.25, sweeps + residual + 2 * MG_RESTRICT_OPS * M * P / 4),
        "K10 residual": (4, sweeps + residual), "K10 smooth": (3, sweeps),
        "K11": (3.25, sweeps + 2 * MG_PROLONG_OPS * M * P),
        "K15": (7, step + 2 * ffts(P, M)), "K16": (2, mono),
        "K17": (7, step + mono), "K7": (2, ffts(M, 2 * P)),
        "K12": (6, step), "K13": (3, ffts(M, 3 * P)),
        "K14": (2, ffts(M, 2 * P)), "K15s": (7, step + 2 * ffts(P, M)),
        "K18": (6, step)}[name]
    t_bytes = fields * field / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", fields * field)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), package=tpu_qg_torch.__version__)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    lines = info["ptxas"].splitlines()
    regs = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    # K4's, K5's, K3's and K13/K14's cluster kernels, K4's, K5's, K3's and
    # K13/K14's mixed-radix cluster kernels, K2's factored kernel and its
    # mixed-radix form, K10/K11's row-streaming and tile kernels, the persistent kernels
    # and K9's and K18's row-streaming kernels: each instance's registers,
    # shared memory, spills.
    named = {"x_dft_cluster_kernel": {}, "x_dft_cluster_mixed_kernel": {},
             "x_symbols_cluster_kernel": {},
             "x_symbols_cluster_mixed_kernel": {},
             "pair_x_cluster_kernel": {}, "pair_x_cluster_mixed_kernel": {},
             "pair_cols_cluster_kernel": {},
             "pair_cols_cluster_mixed_kernel": {},
             "y_dft_factored_kernel": {}, "y_dft_mixed_kernel": {},
             "mg_rows_kernel": {}, "mg_smooth_kernel": {},
             "mg_prolong_kernel": {}, "coop_yspec_rows_kernel": {},
             "coop_fullstep_rows_kernel": {}, "coop_mono_rows_kernel": {},
             "coop_yspec_sharded_rows_kernel": {},
             "tendency_rows_kernel": {}, "lab_rows_kernel": {}}
    entry = None
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = next((k for k in named if k in ln), None)
            name = ln.split("'")[1] if entry else None
        elif entry and ("registers" in ln or "spill" in ln):
            named[entry].setdefault(name, []).append(
                ln.split(":", 1)[-1].strip())
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"], library=info["path"], ptxas=regs,
         k4_cluster_ptxas=named["x_dft_cluster_kernel"],
         k4_mixed_ptxas=named["x_dft_cluster_mixed_kernel"],
         k5_cluster_ptxas=named["x_symbols_cluster_kernel"],
         k5_mixed_ptxas=named["x_symbols_cluster_mixed_kernel"],
         k3_cluster_ptxas=named["pair_x_cluster_kernel"],
         k3_mixed_ptxas=named["pair_x_cluster_mixed_kernel"],
         k13_k14_cluster_ptxas=named["pair_cols_cluster_kernel"],
         k13_k14_mixed_ptxas=named["pair_cols_cluster_mixed_kernel"],
         k2_factored_ptxas=named["y_dft_factored_kernel"],
         k2_mixed_ptxas=named["y_dft_mixed_kernel"],
         mg_ptxas={k: named[k] for k in ("mg_rows_kernel",
                                         "mg_smooth_kernel",
                                         "mg_prolong_kernel")},
         coop_rows_ptxas={k: named[k] for k in (
             "coop_yspec_rows_kernel", "coop_fullstep_rows_kernel",
             "coop_mono_rows_kernel", "coop_yspec_sharded_rows_kernel")},
         k9_rows_ptxas=named["tendency_rows_kernel"],
         k18_rows_ptxas=named["lab_rows_kernel"],
         step_ptxas=step_ptxas(lines))
    return named


# The kernels that form a step point (step_device.cuh's body): the
# row-streaming K1 and K12, and the tile design's users.
STEP_KERNEL_NAMES = ("step_rows_kernel", "step_rows_sharded_kernel",
                     "tendency_rows_kernel", "lab_rows_kernel",
                     "step_kernel", "step_sharded_kernel",
                     "pre_inversion_kernel", "tendency_kernel",
                     "lab_step_kernel", "coop_yspec_kernel",
                     "coop_yspec_sharded_kernel", "coop_fullstep_kernel",
                     "coop_yspec_rows_kernel", "coop_fullstep_rows_kernel",
                     "coop_yspec_sharded_rows_kernel")


def step_ptxas(lines) -> dict:
    """ptxas's registers, spills and shared memory of every instance of
    STEP_KERNEL_NAMES, by kernel and mangled name (a name matches as its
    mangled length-prefixed form, so step_kernel is not every kernel of
    step_kernel.cu)."""
    out, entry = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entry = next((k for k in STEP_KERNEL_NAMES
                          if f"{len(k)}{k}" in name), None)
        elif entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, {}).setdefault(name, []).append(
                ln.split(":", 1)[-1].strip())
    return out


class Errors:
    """Each kernel's largest (abs, rel) error against its plain version."""

    def __init__(self):
        self.by_kernel = {}

    def record(self, name, case, got, want, tol=None, scale=0.0,
               quiet=False):
        """``scale`` floors max|want| where the plain output is zero by
        construction (K18's norot tendency); ``quiet`` prints no line (the
        caller prints a summary)."""
        tol = TOL[name] if tol is None else tol
        a = float((got - want).abs().max())
        r = a / max(float(want.abs().max()), scale)
        self.last_rel = r
        if not quiet:
            emit("kernels", kernel=name, case=case, shape=list(got.shape),
                 max_abs_err=a, rel_err=r, tol=tol)
        if not r <= tol:
            raise AssertionError(f"{name} {case}: rel err {r} > {tol}")
        prev = self.by_kernel.get(name, (0.0, 0.0))
        self.by_kernel[name] = (max(prev[0], a), max(prev[1], r))


def vs_float64(name, case, kern, plain, *args) -> None:
    """On a blue-spectrum input, hold the kernel and the plain version each
    against a float64 evaluation of the plain version: the kernel may not be
    less accurate by more than a factor 2 (1/lambda amplifies the float32
    rounding of weak low-k modes in ANY float32 transform)."""
    ref = plain(*(a.double() for a in args))
    _, e_kern = rel_err(kern(*args).double(), ref)
    _, e_plain = rel_err(plain(*args).double(), ref)
    del ref
    emit("kernels", kernel=name, case=case + " vs float64",
         shape=list(args[0].shape), rel_err_kernel=e_kern,
         rel_err_plain=e_plain, rule="kernel <= 2 x plain")
    if not e_kern <= 2.0 * e_plain:
        raise AssertionError(f"{name} {case}: kernel error {e_kern} vs "
                             f"float64 exceeds twice the plain version's "
                             f"{e_plain}")


def step_inputs(cfg, dev, rng):
    """zeta, psi of the model's initial state and history fields near the
    tendency's scale."""
    state = init_state(cfg, dev)
    tend0, _ = fused_step_plain(cfg, state.zeta, state.psi, state.f1,
                                state.f2, 0)
    scale = float(tend0.abs().max())

    def noisy():
        return tend0 + torch.as_tensor(
            0.1 * scale * rng.standard_normal(tuple(tend0.shape)),
            dtype=torch.float32, device=dev)

    return state.zeta, state.psi, noisy(), noisy()


STEP_CASES = (("euler_ab3 step 0", {}, 0), ("euler_ab3 step 5", {}, 5),
              ("leapfrog_ra+wind step 0",
               dict(time_scheme="leapfrog_ra", wind_tau0=0.1), 0),
              ("leapfrog_ra+wind step 3",
               dict(time_scheme="leapfrog_ra", wind_tau0=0.1), 3))


def check_step_kernel(errs, cfg, dev, rng, tag="", bitwise=()) -> None:
    """K1 against its plain version on the step cases, each launch by its
    row-streaming kernel (counted); on the cases named in ``bitwise`` also
    bitwise the tile design (fused_step_tile; k1_sweep holds every layout
    at 2048^2 and 8192^2)."""
    zeta, psi, f1, f2 = step_inputs(cfg, dev, rng)
    for case, over, step in STEP_CASES:
        c = cfg.replace(**over)
        n = fused_step.rows_launches
        got = fused_step(c, zeta, psi, f1, f2, step)
        if fused_step.rows_launches != n + 1:
            raise AssertionError(f"K1 {tag}{case}: not the row-streaming "
                                 "kernel")
        want = fused_step_plain(c, zeta, psi, f1, f2, step)
        errs.record("K1", tag + case + " zeta_new", got[0], want[0])
        errs.record("K1", tag + case + " carry", got[1], want[1])
        del want
        if case in bitwise:
            tile = fused_step_tile(c, zeta, psi, f1, f2, step)
            if not all(torch.equal(g, b) for g, b in zip(got, tile)):
                raise AssertionError(f"K1 {tag}{case}: not bitwise the tile "
                                     "kernel")
            emit("kernels", kernel="K1", case=tag + case,
                 bitwise_tile_kernel=True)
            del tile
        del got


def check_fullstep_kernel(errs, cfg, operands, consts, tag="") -> None:
    """K17 against its plain version on the step cases: zeta_new and carry
    1e-6; psi_new 1e-4 against the inversion of the kernel's own zeta_new
    (K16's gate: the step stage is gated on zeta_new), or, where 1/lambda
    lifts float32 rounding past that, held against float64."""
    for case, over, step in STEP_CASES:
        c = cfg.replace(**over)
        got = fused_step_full(c, *operands, step)
        want = fused_step_full_plain(c, *operands, step)
        errs.record("K17", tag + case + " zeta_new", got[0], want[0])
        errs.record("K17", tag + case + " carry", got[1], want[1])
        inverse = mono_invert_plain(got[0], consts)
        if rel_err(got[2], inverse)[1] <= TOL["K17 psi_new"]:
            errs.record("K17", tag + case + " psi_new", got[2], inverse,
                        TOL["K17 psi_new"])
        else:
            vs_float64("K17", tag + case + " psi_new", lambda z, p=got[2]: p,
                       lambda z: mono_invert_plain(z, consts), got[0])


def check_yspec_kernel(errs, cfg, operands, step_cases, tag="") -> None:
    """K15 against its plain version: zeta_new and carry 1e-6, zeta_ys
    1e-5."""
    zeta, psi, f1, f2 = operands
    psi_ys = y_dft_plain(psi, False)
    for case, over, step in step_cases:
        c = cfg.replace(**over)
        got = fused_step_yspec(c, zeta, psi_ys, f1, f2, step)
        want = fused_step_yspec_plain(c, zeta, psi_ys, f1, f2, step)
        for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
            errs.record("K15", f"{tag}{case} {part}", g, w,
                        TOL["K15 zeta_ys"] if part == "zeta_ys" else None)


def check_k3(errs, cfg, x, case) -> None:
    """K3 against its plain version on ``x`` (as "K3 mixed" where the mixed
    cluster kernel takes it), with the cluster count rising by 1 exactly
    where pair_x_symbols launches the power-of-two cluster kernel and the
    mixed count exactly where it launches the mixed one."""
    M = x.shape[1]
    consts = inverter(cfg.replace(M=M, P=x.shape[2]))._sym_consts
    mixed = pair_x_cluster_takes(M) and dft_kernels._mixed(M)
    n = (pair_x_symbols.cluster_launches, pair_x_symbols.mixed_launches)
    errs.record("K3 mixed" if mixed else "K3", case,
                pair_x_symbols(x, consts), pair_x_symbols_plain(x, consts))
    torch.cuda.synchronize()
    got = (pair_x_symbols.cluster_launches - n[0],
           pair_x_symbols.mixed_launches - n[1])
    if got != (int(pair_x_cluster_takes(M) and not mixed), int(mixed)):
        raise AssertionError(f"K3 {case}: (cluster, mixed) launches {got}")


# K3 beside the 2048^2 slices' field: the cluster kernel at 1024^2 and on a
# P with strip 0's ragged tile and an odd strip count; its mixed instance
# at 2432 = 128 * 19 and 1664 = 128 * 13 (plans that start with a prime
# pass), 896 = 128 * 7 (U = G = 4, the smallest extent it takes) and 2304
# = 128 * 18 (plan (2, 3, 3)); pair_x_kernel at 768 = 128 * 6 (U = 3 < 4)
# and below M = 256 G.
K3_SHAPES = ((1024, 1024), (2048, 384), (2432, 2048), (1664, 256),
             (896, 256), (2304, 384), (768, 256), (384, 256))


def phase_kernels(errs, cfg, dev) -> None:
    """K1, K2, K3, K8, K16, K17 and K15 at the 2048^2 slices' shapes; K3
    also at K3_SHAPES."""
    rng = np.random.default_rng(SEED)
    check_step_kernel(errs, cfg, dev, rng)

    x = torch.as_tensor(rng.standard_normal((2, cfg.M, cfg.P)),
                        dtype=torch.float32, device=dev)
    for inverse in (False, True):
        errs.record("K2", "inverse" if inverse else "forward",
                    y_dft(x, inverse), y_dft_plain(x, inverse))
    consts = inverter(cfg)._sym_consts
    check_k3(errs, cfg, x, "random y-spectrum")
    rng3 = np.random.default_rng(SEED + 13)
    for M, P in K3_SHAPES:
        check_k3(errs, cfg, torch.as_tensor(
            rng3.standard_normal((2, M, P)), dtype=torch.float32, device=dev),
            f"{M}x{P} random y-spectrum")
    errs.record("K16", "random field", mono_invert(x, consts),
                mono_invert_plain(x, consts))
    zeta = init_state(cfg, dev).zeta
    vs_float64("K3", "zeta y-spectrum", lambda z: pair_x_symbols(z, consts),
               lambda z: pair_x_symbols_plain(z, consts),
               y_dft_plain(zeta, False))
    vs_float64("K3", "zeta -> psi (K2, K3, K2^-1)", inverter(cfg),
               lambda z: y_dft_plain(pair_x_symbols_plain(
                   y_dft_plain(z, False), consts), True), zeta)
    vs_float64("K16", "zeta -> psi", lambda z: mono_invert(z, consts),
               lambda z: mono_invert_plain(z, consts), zeta)

    # K17 and K15 on the step cases of K1.
    operands = step_inputs(cfg, dev, rng)
    check_fullstep_kernel(errs, cfg, operands, consts)
    check_yspec_kernel(errs, cfg, operands, STEP_CASES)
    del operands

    # K8: the pin-gauge (two layers, modes P^-1 zeta_new) and single-layer
    # steps.
    for layers, over in ((2, dict(poisson_gauge="pin")), (1, dict(n_layers=1))):
        kcfg = cfg.replace(**over)
        zeta, psi, f1, f2 = step_inputs(kcfg, dev, rng)
        for case, o, step in STEP_CASES[1::2]:
            c = kcfg.replace(**o)
            got = fused_pre_inversion(c, zeta, psi, f1, f2, step)
            want = fused_pre_inversion_plain(c, zeta, psi, f1, f2, step)
            for part, g, w in zip(("zeta_new", "carry", "modes"), got, want):
                errs.record("K8", f"L={layers} {case} {part}", g, w)
    emit("kernels", grids={"K15": fused_step_yspec.rows_grid,
                           "K16": mono_invert.rows_grid,
                           "K17": fused_step_full.rows_grid},
         grid_is="(blocks, clusters, blocks an SM, the step units' rows) of "
         "K15's and K17's persistent kernels, (blocks, clusters, blocks an "
         "SM) of K16's")
    torch.cuda.synchronize()


# K2's extents beside the slices' grids: the factored kernel's powers of two
# on a row count that leaves every launched Rb a ragged last block, its
# mixed-radix form's extents 384 = 128 * 3, 768, 1536 = 128 * 12 (the
# 1536^2 path), 2432 = 128 * 19, 3072 = 128 * 24 (the 3072^2 path), 6144,
# 7808 = 128 * 61 (the largest prime pass) and 8064 = 128 * 63, and
# y_dft_kernel's 96 = 32 * 3 and 128 (K2_WHOLE_ROW: no factored form).
K2_POWERS = (256, 512, 1024, 2048, 4096, 8192)
K2_WHOLE_ROW = (96, 128)
K2_EXTENTS = K2_POWERS + (384, 768, 1536, 2432, 3072, 6144, 7808, 8064
                          ) + K2_WHOLE_ROW
K2_RAGGED_ROWS = 333


def check_k2_extents(errs, dev, rng) -> None:
    """K2 against its plain version both ways at each of K2_EXTENTS (the
    mixed extents as "K2 mixed"), with y_dft's count rising by 2 at each,
    the factored kernel's exactly at the powers of two, the mixed count
    exactly at the mixed extents, and neither at K2_WHOLE_ROW's (y_dft_kernel
    launched)."""
    for P in K2_EXTENTS:
        x = torch.as_tensor(rng.standard_normal((2, K2_RAGGED_ROWS, P)),
                            dtype=torch.float32, device=dev)
        n = (y_dft.launches, y_dft.factored_launches, y_dft.mixed_launches)
        mixed = P not in K2_POWERS + K2_WHOLE_ROW
        for inverse in (False, True):
            errs.record("K2 mixed" if mixed else "K2",
                        f"{K2_RAGGED_ROWS}x{P} " + (
                            "inverse" if inverse else "forward"),
                        y_dft(x, inverse), y_dft_plain(x, inverse))
        torch.cuda.synchronize()
        got = (y_dft.launches - n[0], y_dft.factored_launches - n[1],
               y_dft.mixed_launches - n[2])
        if got != (2, 2 * (P in K2_POWERS), 2 * mixed):
            raise AssertionError(f"K2 at P = {P}: (all, factored, mixed) "
                                 f"launches {got}")


# K2's mixed extents timed: the fields check_k2_extents checks at 384 and
# 2432, the largest grid of the pair-x route, 2432^2 (N2 = 19, a prime
# pass), the mixed paths' grids and 6144^2 (N2 = 12, 24, 48: radix 2^c and
# 3), and 7808^2 (the 61-point prime pass). K2_MIXED_SWEEP: the layouts
# (Rb, threads) timed at four of them, the launched one among them.
K2_MIXED_SHAPES = ((K2_RAGGED_ROWS, 384), (K2_RAGGED_ROWS, 2432),
                   (2432, 2432), (1536, 1536), (3072, 3072), (6144, 6144),
                   (7808, 7808))
K2_MIXED_SWEEP = {1536: ((2, 256), (4, 256), (8, 256), (4, 512)),
                  2432: ((1, 256), (2, 256), (4, 256), (2, 512)),
                  3072: ((1, 256), (2, 256), (4, 256), (2, 512)),
                  6144: ((1, 256), (2, 256))}


def timed_in_turns(calls: dict, reps: int, sweep: dict) -> dict:
    """ms a launch of each call keyed (name, inverse), in turns (in order,
    then in reverse), host-launched (time_ms) and replayed from a CUDA graph
    (graph_ms): the fields of a name in ``sweep`` go into its entry there,
    the others into the returned dict, by name."""
    runs = {k: ([], []) for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        runs[k][0].append(time_ms(calls[k], reps))
        runs[k][1].append(graph_ms(calls[k], reps))
    entry = {}
    for (key, inverse), (r, g) in runs.items():
        way = "inverse_" if inverse else ""
        fields = {f"{way}ms": sum(r) / 2, f"{way}graph_ms": sum(g) / 2,
                  f"{way}runs_ms": r, f"{way}graph_runs_ms": g}
        if key in sweep:
            sweep[key].update(fields)
        else:
            entry.setdefault(key, {}).update(fields)
    return entry


def time_k2_mixed(errs, dev, card, reps=20) -> dict:
    """K2 on a mixed extent, (2, rows, P) of K2_MIXED_SHAPES: its
    mixed-radix factored kernel (y_dft_mixed_kernel) in the launched layout
    and, at the grids of K2_MIXED_SWEEP, in each layout there (its error
    against the plain version both ways, the blocks an SM holds), ms a launch
    each way beside y_dft_kernel (the kernel it replaces, its error both
    ways recorded as K2's), one torch.fft.fft
    along y of the same complex64 field and a torch copy, in turns (in
    order, then in reverse), host-launched (time_ms) and replayed from a
    CUDA graph (graph_ms); the plain version host-launched, ms a launch over
    both ways, twice; the bound. Returns the entries by shape."""
    rng = np.random.default_rng(SEED + 12)
    out = {}
    for rows, P in K2_MIXED_SHAPES:
        x = torch.as_tensor(rng.standard_normal((2, rows, P)),
                            dtype=torch.float32, device=dev)
        c64 = torch.complex(x[0], x[1])
        launched = dft_kernels.y_dft_factored_launched(P)
        layouts = K2_MIXED_SWEEP.get(P, ()) if rows == P else ()
        layouts = (launched,) + tuple(v for v in layouts if v != launched)
        want = [y_dft_plain(x, inverse) for inverse in (False, True)]
        sweep, calls = {}, {}
        for lay in layouts:
            key = k2_layout_name(lay)
            occ = y_dft_factored_occupancy(P, lay, dev.index)
            sweep[key] = dict(smem=y_dft_factored_layout(P, *lay).smem,
                              blocks_per_sm=occ)
            if occ == 0:
                continue
            err = max(rel_err(y_dft_factored(x, inverse, lay), w)[1]
                      for inverse, w in enumerate(want))
            sweep[key]["rel_err"] = err
            if not err <= TOL["K2 mixed"]:
                raise AssertionError(f"K2 mixed {key} at {rows}x{P}: rel "
                                     f"err {err} > {TOL['K2 mixed']}")
            for inverse in (False, True):
                calls[(key, inverse)] = (
                    lambda lay=lay, inverse=inverse:
                    y_dft_factored(x, inverse, lay))
        for inverse, w in zip((False, True), want):
            errs.record("K2", f"y_dft_kernel {rows}x{P} " + (
                "inverse" if inverse else "forward"),
                y_dft_whole_row(x, inverse), w)
            calls[("y_dft_kernel", inverse)] = (
                lambda inverse=inverse: y_dft_whole_row(x, inverse))
        del want
        calls[("library", False)] = lambda: torch.fft.fft(c64, dim=1)
        calls[("copy", False)] = lambda: x.clone()
        entry = timed_in_turns(calls, reps, sweep)
        entry["mixed"] = sweep[k2_layout_name(launched)]
        entry["layouts"] = sweep
        entry["launched"] = k2_layout_name(launched)
        entry["plan"] = dft_kernels.y_dft_mixed_plan(P // 128)
        entry["plain_runs_ms"] = [time_ms(lambda: (
            y_dft_plain(x, False), y_dft_plain(x, True)), reps) / 2
            for _ in range(2)]
        entry["bound_ms"] = bound("K2", rows, P)[0]
        emit("k2_mixed", card=card, shape=[2, rows, P], **entry)
        out[f"{rows}x{P}"] = entry
        del x, c64, calls
        free_memory()
    return out


# K4's mixed extents timed: the square grids check_k4_extents checks and
# 7808^2 (the 61-point prime pass); every layout (G, Cw) that fits at each,
# the launched one among them.
K4_MIXED_GRIDS = (2560, 3072, 4224, 6144, 7808)


def time_k4_mixed(errs, dev, card, reps=20) -> dict:
    """K4 on a mixed extent, (2, n, n) of K4_MIXED_GRIDS: its mixed cluster
    kernel (x_dft_cluster_mixed_kernel) in every layout (G, Cw) that fits
    (its error against the plain version both ways, the clusters the card
    holds at once), ms a launch each way beside x_dft_kernel (the kernel it
    replaces, its error both ways recorded as K4's), one torch.fft.fft
    along x of the same complex64 field and a torch copy, in turns (in
    order, then in reverse), host-launched (time_ms) and replayed from a
    CUDA graph (graph_ms); the plain version host-launched, ms a launch
    over both ways, twice; the bound. Returns the entries by grid."""
    rng = np.random.default_rng(SEED + 13)
    out = {}
    for n in K4_MIXED_GRIDS:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        c64 = torch.complex(x[0], x[1])
        launched = k5_layout_name(dft_kernels.x_dft_cluster_launched(n))
        want = [x_dft_plain(x, inverse) for inverse in (False, True)]
        sweep, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.CLUSTER_SIZES
                    for c in dft_kernels.CLUSTER_WIDTHS):
            if not x_dft_cluster_takes(n, *lay):
                continue
            key = k5_layout_name(lay)
            occ = x_dft_cluster_occupancy(n, lay, dev.index)
            sweep[key] = dict(smem=x_dft_cluster_layout(n, *lay).smem,
                              max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = max(rel_err(x_dft_cluster(x, inverse, lay), w)[1]
                      for inverse, w in enumerate(want))
            sweep[key]["rel_err"] = err
            if not err <= TOL["K4 mixed"]:
                raise AssertionError(f"K4 mixed {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K4 mixed']}")
            for inverse in (False, True):
                calls[(key, inverse)] = (
                    lambda lay=lay, inverse=inverse:
                    x_dft_cluster(x, inverse, lay))
        for inverse, w in zip((False, True), want):
            errs.record("K4", f"x_dft_kernel {n}x{n} " + (
                "inverse" if inverse else "forward"),
                x_dft_whole_columns(x, inverse), w)
            calls[("x_dft_kernel", inverse)] = (
                lambda inverse=inverse: x_dft_whole_columns(x, inverse))
        del want
        calls[("library", False)] = lambda: torch.fft.fft(c64, dim=0)
        calls[("copy", False)] = lambda: x.clone()
        entry = timed_in_turns(calls, reps, sweep)
        entry["mixed"] = sweep[launched]
        entry["layouts"] = sweep
        entry["launched"] = launched
        entry["plan"] = dft_kernels.y_dft_mixed_plan(n // 128)
        entry["plain_runs_ms"] = [time_ms(lambda: (
            x_dft_plain(x, False), x_dft_plain(x, True)), reps) / 2
            for _ in range(2)]
        entry["bound_ms"] = bound("K4", n, n)[0]
        emit("k4_mixed", card=card, grid=[n, n], **entry)
        out[n] = entry
        del x, c64, calls
        free_memory()
    return out


# K5's mixed extents timed: the 3072^2 path's grid and the grids around it
# that K4 mixed was timed at (2560^2, 6144^2, 7808^2: N2 = 20, 48, 61);
# every layout (G, Cw) that fits at each, the launched one among them.
K5_MIXED_GRIDS = (2560, 3072, 6144, 7808)


def time_k5_mixed(errs, dev, card, cfg, reps=20) -> dict:
    """K5 on a mixed extent, (2, n, n) of K5_MIXED_GRIDS with ``cfg``'s
    symbols at n^2: its mixed cluster kernel (x_symbols_cluster_mixed_
    kernel) in every layout (G, Cw) that fits (its error against the plain
    version, the clusters the card holds at once), ms a launch beside
    x_symbols_inverse_kernel (the kernel it replaces, its error recorded as
    K5's), one torch.fft.ifft along x of the same complex64 field (a
    yardstick only: it does not compute K5's function) and a torch copy,
    in turns (in order, then in reverse), host-launched (time_ms) and
    replayed from a CUDA graph (graph_ms); the plain version host-launched,
    twice; the bound. Returns the entries by grid."""
    rng = np.random.default_rng(SEED + 15)
    out = {}
    for n in K5_MIXED_GRIDS:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        c64 = torch.complex(x[0], x[1])
        consts = inverter(cfg.replace(M=n, P=n))._sym_consts
        launched = k5_layout_name(dft_kernels.x_symbols_cluster_launched(n))
        want = x_symbols_inverse_plain(x, consts)
        sweep, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.X_SYMBOLS_CLUSTER_SIZES
                    for c in dft_kernels.X_SYMBOLS_CLUSTER_WIDTHS):
            if not x_symbols_cluster_takes(n, lay):
                continue
            key = k5_layout_name(lay)
            occ = x_symbols_cluster_occupancy(n, lay, dev.index)
            sweep[key] = dict(smem=x_symbols_cluster_layout(n, *lay).smem,
                              max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = rel_err(x_symbols_cluster(x, consts, lay), want)[1]
            sweep[key]["rel_err"] = err
            if not err <= TOL["K5 mixed"]:
                raise AssertionError(f"K5 mixed {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K5 mixed']}")
            calls[(key, False)] = (
                lambda lay=lay: x_symbols_cluster(x, consts, lay))
        errs.record("K5", f"x_symbols_inverse_kernel {n}x{n}",
                    x_symbols_whole_columns(x, consts), want)
        del want
        calls[("x_symbols_inverse_kernel", False)] = (
            lambda: x_symbols_whole_columns(x, consts))
        calls[("library ifft along x", False)] = (
            lambda: torch.fft.ifft(c64, dim=0))
        calls[("copy", False)] = lambda: x.clone()
        entry = timed_in_turns(calls, reps, sweep)
        entry["mixed"] = sweep[launched]
        entry["layouts"] = sweep
        entry["launched"] = launched
        entry["plan"] = dft_kernels.y_dft_mixed_plan(n // 128)
        entry["plain_runs_ms"] = [time_ms(
            lambda: x_symbols_inverse_plain(x, consts), reps)
            for _ in range(2)]
        entry["bound_ms"] = bound("K5", n, n)[0]
        emit("k5_mixed", card=card, grid=[n, n], **entry)
        out[n] = entry
        del x, c64, calls
        free_memory()
    return out


# K3's mixed extents timed: the 1536^2 path's grid (N2 = 12, G = 4 only),
# 1920^2 (N2 = 15, the least taken by G = 8) and 2432^2 (N2 = 19, a prime
# pass; the largest grid of the pair-x route); every layout (G, Cw) that
# fits at each, the launched one among them.
K3_MIXED_GRIDS = (1536, 1920, 2432)


def time_k3_mixed(errs, dev, card, cfg, reps=20) -> dict:
    """K3 on a mixed extent, (2, n, n) of K3_MIXED_GRIDS with ``cfg``'s
    symbols at n^2: its mixed cluster kernel (pair_x_cluster_mixed_kernel)
    in every layout (G, Cw) that fits (its error against the plain version,
    the clusters the card holds at once), ms a launch beside pair_x_kernel
    (the kernel it replaces, its error recorded as K3's), one torch.fft.fft
    and one torch.fft.ifft along x of the same complex64 field (a yardstick
    only: not K3's function) and a torch copy, in turns (in order, then in
    reverse), host-launched (time_ms) and replayed from a CUDA graph
    (graph_ms); the plain version host-launched, twice; the bound. Returns
    the entries by grid."""
    rng = np.random.default_rng(SEED + 16)
    out = {}
    for n in K3_MIXED_GRIDS:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        c64 = torch.complex(x[0], x[1])
        consts = inverter(cfg.replace(M=n, P=n))._sym_consts
        launched = k5_layout_name(dft_kernels.pair_x_cluster_launched(n))
        want = pair_x_symbols_plain(x, consts)
        sweep, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.PAIR_X_CLUSTER_SIZES
                    for c in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
            if not pair_x_cluster_takes(n, lay):
                continue
            key = k5_layout_name(lay)
            occ = pair_x_cluster_occupancy(n, lay, dev.index)
            sweep[key] = dict(smem=pair_x_cluster_layout(n, *lay).smem,
                              max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = rel_err(pair_x_cluster(x, consts, lay), want)[1]
            sweep[key]["rel_err"] = err
            if not err <= TOL["K3 mixed"]:
                raise AssertionError(f"K3 mixed {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K3 mixed']}")
            calls[(key, False)] = (
                lambda lay=lay: pair_x_cluster(x, consts, lay))
        errs.record("K3", f"pair_x_kernel {n}x{n}",
                    pair_x_whole_columns(x, consts), want)
        del want
        calls[("pair_x_kernel", False)] = (
            lambda: pair_x_whole_columns(x, consts))
        calls[("library fft + ifft along x", False)] = (
            lambda: torch.fft.ifft(torch.fft.fft(c64, dim=0), dim=0))
        calls[("copy", False)] = lambda: x.clone()
        entry = timed_in_turns(calls, reps, sweep)
        entry["mixed"] = sweep[launched]
        entry["layouts"] = sweep
        entry["launched"] = launched
        entry["plan"] = dft_kernels.y_dft_mixed_plan(n // 128)
        entry["plain_runs_ms"] = [time_ms(
            lambda: pair_x_symbols_plain(x, consts), reps) for _ in range(2)]
        entry["bound_ms"] = bound("K3", n, n)[0]
        emit("k3_mixed", card=card, grid=[n, n], **entry)
        out[n] = entry
        del x, c64, calls
        free_memory()
    return out


def check_k5(errs, cfg, x, case) -> None:
    """K5 against its plain version on ``x`` (as "K5 mixed" where the mixed
    cluster kernel takes it), with the cluster count rising by 1 exactly
    where x_symbols_inverse launches the power-of-two cluster kernel and the
    mixed count exactly where it launches the mixed one."""
    M = x.shape[1]
    consts = inverter(cfg.replace(M=M, P=x.shape[2]))._sym_consts
    mixed = x_symbols_cluster_takes(M) and dft_kernels._mixed(M)
    n = (x_symbols_inverse.cluster_launches, x_symbols_inverse.mixed_launches)
    errs.record("K5 mixed" if mixed else "K5", case,
                x_symbols_inverse(x, consts),
                x_symbols_inverse_plain(x, consts))
    torch.cuda.synchronize()
    got = (x_symbols_inverse.cluster_launches - n[0],
           x_symbols_inverse.mixed_launches - n[1])
    if got != (int(x_symbols_cluster_takes(M) and not mixed), int(mixed)):
        raise AssertionError(f"K5 {case}: (cluster, mixed) launches {got}")


# K5's mixed extents checked (check_k5), each by the mixed cluster kernel on
# strip 0's ragged tile and an odd strip count: 2816 = 128 * 22 (the plan
# (2, 11): the inverse runs the prime pass first), 2944 = 128 * 23 (one
# prime pass, odd N2) and 6144 = 128 * 48; K5_WHOLE_COLUMNS:
# x_symbols_inverse_kernel's extent 1536 = 128 * 12 (ceil(12 / 2) < G).
K5_MIXED_CHECKS = ((2816, 384), (2944, 384), (6144, 384))
K5_WHOLE_COLUMNS = ((1536, 384),)


# K4's mixed extents checked (check_k4_extents), each by the mixed cluster
# kernel: the grids K4_MIXED_GRIDS times (2560^2, the 3072^2 path's grid,
# the unfused route's 4224^2, 6144^2), 7808 x 512 (the 61-point prime pass)
# and 6144 x 2048; K4_WHOLE_COLUMNS: x_dft_kernel's extents (M < 128 G).
K4_MIXED_CHECKS = ((2560, 2560), (3072, 3072), (4224, 4224), (6144, 6144),
                   (7808, 512), (6144, 2048))
K4_WHOLE_COLUMNS = ((768, 384),)


def check_k4_extents(errs, dev, rng) -> None:
    """K4 against its plain version both ways at each of K4_MIXED_CHECKS
    (as "K4 mixed", its cluster kernel's first half, stage A, too) and
    K4_WHOLE_COLUMNS (as "K4"), with x_dft's count rising by 2 at each, the
    mixed count exactly at the mixed extents and the power-of-two cluster
    count at none."""
    for M, P in K4_MIXED_CHECKS + K4_WHOLE_COLUMNS:
        x = torch.as_tensor(rng.standard_normal((2, M, P)),
                            dtype=torch.float32, device=dev)
        mixed = (M, P) in K4_MIXED_CHECKS
        name = "K4 mixed" if mixed else "K4"
        n = (x_dft.launches, x_dft.mixed_launches, x_dft.cluster_launches)
        for inverse in (False, True):
            way = "inverse" if inverse else "forward"
            errs.record(name, f"{M}x{P} {way}", x_dft(x, inverse),
                        x_dft_plain(x, inverse))
            if mixed:
                errs.record(name, f"{M}x{P} {way} stage A (cluster kernel's "
                            "first half)", x_dft_stage_a(x, inverse),
                            x_dft_stage_a_plain(x, inverse))
        torch.cuda.synchronize()
        got = (x_dft.launches - n[0], x_dft.mixed_launches - n[1],
               x_dft.cluster_launches - n[2])
        if got != (2, 2 * mixed, 0):
            raise AssertionError(f"K4 at {M}x{P}: (all, mixed, cluster) "
                                 f"launches {got}")
        del x
        free_memory()


def phase_x_kernels(errs, pod, dev, sizes=(4096, 8192)) -> None:
    """K2 at K2_EXTENTS; K2, K4 and K5 at each n^2 of ``sizes`` on random
    input, K4 also on a ragged tile (8192 x 252) and at its mixed extents
    (check_k4_extents), K5 also on a ragged P (8192 x 384: strip 0's ragged
    tile, an odd strip count), at K5_MIXED_CHECKS (its mixed cluster
    kernel, as "K5 mixed") and at K5_WHOLE_COLUMNS
    (x_symbols_inverse_kernel);
    K5 and the whole four-pass inversion on pod-8192's zeta against float64;
    K1 and K15 at pod's grid; K17 at 6272 x 128."""
    rng = np.random.default_rng(SEED + 2)
    check_k2_extents(errs, dev, rng)
    for n in sizes:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        for inverse in (False, True):
            way = "inverse" if inverse else "forward"
            errs.record("K2", way, y_dft(x, inverse), y_dft_plain(x, inverse))
            errs.record("K4", way, x_dft(x, inverse), x_dft_plain(x, inverse))
            errs.record("K4", f"{way} stage A (cluster kernel's first half)",
                        x_dft_stage_a(x, inverse),
                        x_dft_stage_a_plain(x, inverse))
        check_k5(errs, pod, x, f"{n}x{n} random spectrum")
        del x
        free_memory()
    for M, P in ((8192, 384),) + K5_MIXED_CHECKS + K5_WHOLE_COLUMNS:
        x = torch.as_tensor(rng.standard_normal((2, M, P)),
                            dtype=torch.float32, device=dev)
        check_k5(errs, pod, x, f"{M}x{P} random spectrum")
        del x
        free_memory()
    # K4 on a ragged last cluster tile (the power-of-two cluster kernel).
    x = torch.as_tensor(rng.standard_normal((2, 8192, 252)),
                        dtype=torch.float32, device=dev)
    for inverse in (False, True):
        errs.record("K4", "8192x252 " + ("inverse" if inverse else "forward"),
                    x_dft(x, inverse), x_dft_plain(x, inverse))
    del x
    free_memory()
    check_k4_extents(errs, dev, rng)

    inv = inverter(pod)
    if inv.route != "four-pass":
        raise AssertionError(f"pod-8192 takes the {inv.route} route")
    consts = inv._sym_consts
    zeta = init_state(pod, dev).zeta
    W = x_dft_plain(y_dft_plain(zeta, False), False)
    vs_float64("K5", "zeta spectrum", lambda w: x_symbols_inverse(w, consts),
               lambda w: x_symbols_inverse_plain(w, consts), W)
    del W
    free_memory()
    vs_float64("K5", "zeta -> psi (K2, K4, K5, K2^-1)", inv,
               lambda z: y_dft_plain(x_symbols_inverse_plain(
                   x_dft_plain(y_dft_plain(z, False), False), consts), True),
               zeta)
    del zeta
    free_memory()
    tag = f"{pod.M}x{pod.P} "
    check_step_kernel(errs, pod, dev, rng, tag=tag,
                      bitwise=(STEP_CASES[1][0],))
    free_memory()
    check_yspec_kernel(errs, pod, step_inputs(pod, dev, rng),
                       STEP_CASES[1:2], tag=tag)
    free_memory()
    # K17 where the pair task takes the own and the mirror group in turn
    # (mixed M = 128 * 49 at small P, which the reference's gate admits),
    # on white fields as in tests/test_torch_cuda.py.
    cfg = preset("turbulence-2048").replace(M=6272, P=128)
    operands = [torch.as_tensor(s * rng.standard_normal((2, cfg.M, cfg.P)),
                                dtype=torch.float32, device=dev)
                for s in (1e-5, 1e3, 1e-9, 1e-9)]
    check_fullstep_kernel(errs, cfg, operands, inverter(cfg)._sym_consts,
                          tag="6272x128 white ")
    free_memory()


def phase_k4_sweep(dev, card, sizes=(4096, 8192), reps=20) -> dict:
    """K4's cluster kernel in every layout (G blocks a cluster, Cw y slots a
    cluster) that fits shared memory, at n^2: its bytes of
    shared memory, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters), its largest error against the plain
    version both ways, and CUDA-event ms a launch each way, the layouts in
    turns (in order, then in reverse), beside one torch.fft.fft along x of
    the same complex64 field, the launched layout's stage A alone, and
    torch copies of the field (plain, and reading 32- and 64-byte row
    runs). Returns the entries by grid."""
    rng = np.random.default_rng(SEED + 9)
    out = {}
    for n in sizes:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        want = [x_dft_plain(x, inverse) for inverse in (False, True)]
        rows, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.CLUSTER_SIZES
                    for c in dft_kernels.CLUSTER_WIDTHS):
            if not x_dft_cluster_takes(n, *lay):
                continue
            key = "G={} Cw={}".format(*lay)
            occ = x_dft_cluster_occupancy(n, lay, dev.index)
            rows[key] = dict(smem=x_dft_cluster_layout(n, *lay).smem,
                             max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = max(rel_err(x_dft_cluster(x, inverse, lay), w)[1]
                      for inverse, w in enumerate(want))
            rows[key]["rel_err"] = err
            if not err <= TOL["K4"]:
                raise AssertionError(f"K4 cluster {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K4']}")
            for inverse in (False, True):
                calls[(key, inverse)] = (
                    lambda lay=lay, inverse=inverse:
                    x_dft_cluster(x, inverse, lay))
        del want
        # Beside them: the launched layout's first half alone (stage A: the
        # same reads and writes, no pull), a copy of the field, and copies
        # that read it in the tiles' 32- and 64-byte row runs.
        launched = dft_kernels.x_dft_cluster_launched(n)
        for inverse in (False, True):
            calls[("stage A alone", inverse)] = (
                lambda inverse=inverse:
                x_dft_cluster(x, inverse, launched, stage_a=True))
        c64 = torch.complex(x[0], x[1])
        calls[("library", False)] = lambda: torch.fft.fft(c64, dim=0)
        calls[("copy", False)] = lambda: x.clone()
        for w in (8, 16):
            calls[(f"copy reading {4 * w}-byte row runs", False)] = (
                lambda w=w: x.view(2, n, n // w, w).transpose(1, 2)
                .contiguous())
        runs = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k].append(time_ms(calls[k], reps))
        refs = {}
        for (key, inverse), r in runs.items():
            if key in rows:
                rows[key]["inverse_ms" if inverse else "ms"] = sum(r) / 2
                rows[key]["inverse_runs_ms" if inverse else "runs_ms"] = r
            else:
                refs[key + (" inverse" if inverse else "")] = sum(r) / 2
        emit("k4_sweep", card=card, grid=[n, n],
             launched="G={} Cw={}".format(*launched), layouts=rows,
             library_ms=refs["library"], reference_ms=refs,
             bound_ms=bound("K4", n, n)[0])
        out[n] = rows
        del x, c64, calls
        free_memory()
    return out


def k5_layout_name(layout) -> str:
    return "G={} Cw={}".format(*layout)


def phase_k5_sweep(dev, pod, card, sizes=(4096, 8192), reps=20) -> dict:
    """K5's cluster kernel in every layout (G blocks a cluster, Cw y slots a
    tile) that fits shared memory, at n^2:
    its bytes of shared memory, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters), its largest error against the plain
    version, and ms a launch, the layouts in turns (in order, then in
    reverse), beside x_symbols_inverse_kernel (whole columns, the kernel it
    replaces there), one torch.fft.ifft along x of the same complex64 field
    (a yardstick only: it does not compute K5's function) and a torch copy
    of the field: host-launched (time_ms) and replayed from a CUDA graph
    (graph_ms). Returns the entries by grid."""
    rng = np.random.default_rng(SEED + 11)
    out = {}
    for n in sizes:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        consts = inverter(pod.replace(M=n, P=n))._sym_consts
        want = x_symbols_inverse_plain(x, consts)
        rows, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.X_SYMBOLS_CLUSTER_SIZES
                    for c in dft_kernels.X_SYMBOLS_CLUSTER_WIDTHS):
            if not x_symbols_cluster_takes(n, lay):
                continue
            key = k5_layout_name(lay)
            occ = x_symbols_cluster_occupancy(n, lay, dev.index)
            rows[key] = dict(smem=x_symbols_cluster_layout(n, *lay).smem,
                             max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = rel_err(x_symbols_cluster(x, consts, lay), want)[1]
            rows[key]["rel_err"] = err
            if not err <= TOL["K5"]:
                raise AssertionError(f"K5 cluster {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K5']}")
            calls[key] = lambda lay=lay: x_symbols_cluster(x, consts, lay)
        del want
        c64 = torch.complex(x[0], x[1])
        calls["x_symbols_inverse_kernel"] = (
            lambda: x_symbols_whole_columns(x, consts))
        calls["library ifft along x"] = lambda: torch.fft.ifft(c64, dim=0)
        calls["copy"] = lambda: x.clone()
        runs = {k: ([], []) for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k][0].append(time_ms(calls[k], reps))
            runs[k][1].append(graph_ms(calls[k], reps))
        refs = {}
        for key, (r, g) in runs.items():
            if key in rows:
                rows[key].update(ms=sum(r) / 2, graph_ms=sum(g) / 2,
                                 runs_ms=r, graph_runs_ms=g)
            else:
                refs[key] = sum(r) / 2
                refs[key + " graph"] = sum(g) / 2
        emit("k5_sweep", card=card, grid=[n, n],
             launched=k5_layout_name(
                 dft_kernels.x_symbols_cluster_launched(n)),
             layouts=rows, reference_ms=refs, bound_ms=bound("K5", n, n)[0])
        out[n] = dict(layouts=rows, reference_ms=refs)
        del x, c64, calls
        free_memory()
    return out


# K3's cluster kernel at 4096^2 and 8192^2, where K7 launches it: six
# layouts each (at 4096 the two of Cw = 4 with G < 16 left out: 16-byte
# runs a row, as K5's narrowest).
K3_SWEEP_LARGE = {4096: ((4, 8), (8, 8), (8, 16), (16, 4), (16, 8), (16, 16)),
                  8192: ((4, 4), (8, 4), (8, 8), (16, 4), (16, 8), (16, 16))}


def phase_k3_sweep(dev, turb, card, sizes=(1024, 2048, 4096, 8192),
                   reps=20) -> dict:
    """K3's cluster kernel in every layout (G blocks a cluster, Cw y slots a
    tile) that fits shared memory at n^2 (at 4096 and 8192 those of
    K3_SWEEP_LARGE): its bytes of shared memory, the clusters the card
    holds at once (cudaOccupancyMaxActiveClusters), its largest error
    against the plain version and ms a launch, the layouts in turns (in
    order, then in reverse), beside the kernel it replaces there
    (pair_x_kernel, whole columns; at 4096 and 8192 K7's, pair_cols_kernel
    on the whole field's self table, half the reps), K4's cluster kernel
    then K5's where both take n (the four-pass route's x-stage, two
    launches, the spectrum through device memory), one torch.fft.fft and
    one torch.fft.ifft along x of the same complex64 field (a yardstick
    only: not K3's function) and a torch copy of the field: host-launched
    (time_ms) and replayed from a CUDA graph (graph_ms). Returns the
    entries by grid."""
    rng = np.random.default_rng(SEED + 14)
    out = {}
    for n in sizes:
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        consts = inverter(turb.replace(M=n, P=n))._sym_consts
        want = pair_x_symbols_plain(x, consts)
        rows, calls, refs = {}, {}, {}
        large = n in K3_SWEEP_LARGE
        for lay in K3_SWEEP_LARGE.get(n) or (
                (g, c) for g in dft_kernels.PAIR_X_CLUSTER_SIZES
                for c in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
            if not pair_x_cluster_takes(n, lay):
                continue
            key = "G={} Cw={}".format(*lay)
            occ = pair_x_cluster_occupancy(n, lay, dev.index)
            rows[key] = dict(smem=pair_x_cluster_layout(n, *lay).smem,
                             max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = rel_err(pair_x_cluster(x, consts, lay), want)[1]
            rows[key]["rel_err"] = err
            if not err <= TOL["K3"]:
                raise AssertionError(f"K3 cluster {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K3']}")
            calls[key] = lambda lay=lay: pair_x_cluster(x, consts, lay)
        c64 = torch.complex(x[0], x[1])
        if large:
            old = "pair_cols_kernel (K7's self table)"
            calls[old] = lambda: pair_cols_whole_columns(x, x, "self", (n,),
                                                         consts)
            refs[old + " rel_err"] = rel_err(calls[old](), want)[1]
        else:
            calls["pair_x_kernel"] = lambda: pair_x_whole_columns(x, consts)
        if x_symbols_cluster_takes(n):
            pair = lambda: x_symbols_cluster(x_dft_cluster(x, False), consts)
            refs["K4 cluster + K5 cluster rel_err"] = rel_err(pair(), want)[1]
            calls["K4 cluster + K5 cluster"] = pair
        calls["library fft + ifft along x"] = (
            lambda: torch.fft.ifft(torch.fft.fft(c64, dim=0), dim=0))
        calls["copy"] = lambda: x.clone()
        r = reps // 2 if large else reps
        runs = {k: ([], []) for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k][0].append(time_ms(calls[k], r))
            runs[k][1].append(graph_ms(calls[k], r))
        for key, (t, g) in runs.items():
            if key in rows:
                rows[key].update(ms=sum(t) / 2, graph_ms=sum(g) / 2,
                                 runs_ms=t, graph_runs_ms=g)
            else:
                refs[key] = sum(t) / 2
                refs[key + " graph"] = sum(g) / 2
        del want, c64
        emit("k3_sweep", card=card, grid=[n, n],
             launched="G={} Cw={}".format(
                 *dft_kernels.pair_x_cluster_launched(n)),
             layouts=rows, reference_ms=refs, bound_ms=bound("K3", n, n)[0])
        out[n] = dict(layouts=rows, reference_ms=refs)
        del x, calls
        free_memory()
    return out


# The block kernel's sweep, at the four-rank slices' blocks (name, table,
# M, W, strip offset or rank, the y extent P): K13 on the (4, 1) pod-8192
# rank's (2, 8192, 2048) at strip offset 16 and the (2, 2) turbulence-2048
# rank's (2, 2048, 512) at 4; K14 on the (4, 1) turbulence-2048 rank 0's
# (2, 2048, 512), the self-mirror group's; the mixed instance's: K13 on the
# (4, 1) 3072^2 rank 1's (2, 3072, 768) at 6, K14 on the (4, 1) 1536 x
# 2048 rank 0's (2, 1536, 512).
K13_SWEEP = (("K13", "offset", 8192, 2048, 16, 8192),
             ("K13", "offset", 2048, 512, 4, 2048),
             ("K14", "paired", 2048, 512, 0, 2048),
             ("K13 mixed", "offset", 3072, 768, 6, 3072),
             ("K14 mixed", "paired", 1536, 512, 0, 2048))


def phase_k13_sweep(dev, turb, pod, card, reps=20) -> dict:
    """The block kernel (pair_cols_cluster_kernel, at the mixed extents
    pair_cols_cluster_mixed_kernel) in every layout (G, Cw) that fits
    shared memory, for each entry of K13_SWEEP (``pod``'s symbols at 8192,
    ``turb``'s configuration at (M, P) elsewhere): its bytes of
    shared memory, the clusters the card holds at once, its largest error
    against the plain version and ms a launch, the layouts in turns (in
    order, then in reverse), beside pair_cols_kernel (the kernel it
    replaces there; its error too), one torch.fft.fft along x of the own
    and mirror blocks then one torch.fft.ifft along x of a block (a
    yardstick only: not the function) and a torch copy of the block:
    host-launched (time_ms) and replayed from a CUDA graph (graph_ms).
    Returns the entries by kernel and shape."""
    rng = np.random.default_rng(SEED + 15)
    out = {}
    for name, kind, M, W, at, P in K13_SWEEP:
        cfg = (pod if M == pod.M else turb).replace(M=M, P=P)
        consts = inverter(cfg)._sym_consts
        x = torch.as_tensor(rng.standard_normal((2, M, W)),
                            dtype=torch.float32, device=dev)
        if kind == "offset":
            xm = torch.as_tensor(rng.standard_normal((2, M, W)),
                                 dtype=torch.float32, device=dev)
            key = (W, at)
            want = x_fwd_symbols_offset_plain(x, xm, consts, at)
        else:
            xm, s = x, W // 128
            idx = strip_pair_order(cfg.P // 128)[at * s:(at + 1) * s]
            key = (tuple(int(i) for i in idx), cfg.P // 128)
            want = paired_x_symbols_plain(x, idx, consts)
        rows, calls = {}, {}
        for lay in ((g, c) for g in dft_kernels.PAIR_X_CLUSTER_SIZES
                    for c in dft_kernels.PAIR_X_CLUSTER_WIDTHS):
            if not pair_cols_cluster_takes(M, W, lay):
                continue
            lkey = "G={} Cw={}".format(*lay)
            occ = pair_cols_cluster_occupancy(M, lay, kind == "offset",
                                              dev.index)
            rows[lkey] = dict(smem=pair_cols_cluster_layout(M, *lay).smem,
                              max_active_clusters=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = rel_err(pair_cols_cluster(x, xm, kind, key, consts, lay),
                          want)[1]
            rows[lkey]["rel_err"] = err
            if not err <= TOL[name]:
                raise AssertionError(f"{name} cluster {lkey} at {(M, W)}: "
                                     f"rel err {err} > {TOL[name]}")
            calls[lkey] = lambda lay=lay: pair_cols_cluster(x, xm, kind, key,
                                                            consts, lay)
        calls["pair_cols_kernel"] = lambda: pair_cols_whole_columns(
            x, xm, kind, key, consts)
        refs = {"pair_cols_kernel rel_err": rel_err(calls["pair_cols_kernel"](),
                                                    want)[1]}
        del want
        c64 = torch.complex(x[0], x[1])
        both = torch.stack([c64, torch.complex(xm[0], xm[1])]) \
            if kind == "offset" else c64[None]
        calls["library fft + ifft along x"] = (
            lambda: torch.fft.ifft(torch.fft.fft(both, dim=1)[0], dim=0))
        calls["copy"] = lambda: x.clone()
        runs = {k: ([], []) for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k][0].append(time_ms(calls[k], reps))
            runs[k][1].append(graph_ms(calls[k], reps))
        for lkey, (t, g) in runs.items():
            if lkey in rows:
                rows[lkey].update(ms=sum(t) / 2, graph_ms=sum(g) / 2,
                                  runs_ms=t, graph_runs_ms=g)
            else:
                refs[lkey] = sum(t) / 2
                refs[lkey + " graph"] = sum(g) / 2
        emit("k13_sweep", card=card, kernel=name, shape=[2, M, W],
             block=dict(strip_offset=at) if kind == "offset" else
             dict(groups_idx=list(key[0])),
             launched="G={} Cw={}".format(
                 *pair_cols_cluster_launched(M, W)),
             layouts=rows, reference_ms=refs,
             bound_ms=bound(name.split()[0], M, W)[0])
        out[f"{name} {M}x{W}"] = dict(layouts=rows, reference_ms=refs)
        del x, xm, c64, both, calls
        free_memory()
    return out


def k1_layout_name(layout) -> str:
    return "W={} R={} D={} NT={}".format(*layout)


def phase_k1_sweep(dev, card, sizes=(2048, 8192), reps=(20, 5)) -> dict:
    """K1's row-streaming kernel in every layout (W, R, D, NT) the source
    instantiates, on K1's (2, n, n) fields: its registers, spill bytes,
    shared memory and blocks an SM (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor), its outputs bitwise
    the tile design's (step_kernel, the kernel it replaces), and ms a launch
    replayed from a CUDA graph, the layouts in turns (in order, then in
    reverse), beside the tile kernel, K18 base (K1's row code in K1's
    launched layout in the lab kernel) and a torch copy of three (2, n, n)
    fields (a read and a write of K1's six fields' bytes); then K12 on the
    one-rank block (2, n, n) with its wrap rows as slabs, in its launched
    layout, beside its tile kernel (step_sharded_kernel), both bitwise K1.
    Returns the entries by grid."""
    rng = np.random.default_rng(SEED + 15)
    turb = preset("turbulence-2048")
    out = {}
    for n, r in zip(sizes, reps):
        cfg = turb.replace(M=n, P=n)
        zeta, psi, f1, f2 = step_inputs(cfg, dev, rng)
        tile = fused_step_tile(cfg, zeta, psi, f1, f2, 5)
        rows, calls = {}, {}
        for lay in step_rows_layouts():
            key = k1_layout_name(lay)
            rows[key] = dict(step_rows_attributes(lay, False, dev.index or 0))
            got = fused_step_rows(cfg, zeta, psi, f1, f2, 5, lay)
            if not all(torch.equal(g, t) for g, t in zip(got, tile)):
                raise AssertionError(f"K1 rows {key} at {n}^2: not bitwise "
                                     "the tile kernel")
            del got
            calls[key] = lambda lay=lay: fused_step_rows(cfg, zeta, psi, f1,
                                                         f2, 5, lay)
        src = torch.empty((3, 2, n, n), device=dev)
        dst = torch.empty_like(src)
        calls.update({
            "step_kernel (tile)": lambda: fused_step_tile(cfg, zeta, psi, f1,
                                                          f2, 5),
            "K18 base": lambda: lab_step(cfg, zeta, psi, f1, f2, 5, "base"),
            "copy": lambda: dst.copy_(src)})
        runs = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k].append(graph_ms(calls[k], r))
        for key, v in runs.items():
            rows.setdefault(key, {}).update(graph_ms=sum(v) / 2,
                                            graph_runs_ms=v)
        del src, dst, calls, tile
        free_memory()
        # K12 on the one-rank block: its wrap rows are its slabs.
        (zt, zb), (pt, pb) = slabs((zeta, psi), 0, n)
        k12 = {"K12 rows": lambda: fused_step_sharded(
                   cfg, zeta, psi, f1, f2, 5, zt, zb, pt, pb),
               "K12 step_sharded_kernel (tile)": lambda: fused_step_sharded_tile(
                   cfg, zeta, psi, f1, f2, 5, zt, zb, pt, pb)}
        k1 = fused_step(cfg, zeta, psi, f1, f2, 5)
        for key, fn in k12.items():
            if not all(torch.equal(g, t) for g, t in zip(fn(), k1)):
                raise AssertionError(f"{key} at {n}^2: not bitwise K1")
        del k1
        k12_runs = {k: [] for k in k12}
        for k in list(k12) + list(k12)[::-1]:
            k12_runs[k].append(graph_ms(k12[k], r))
        k12_ms = {k: sum(v) / 2 for k, v in k12_runs.items()}
        launched = k1_layout_name(step_rows_launched(n))
        least = min((k for k in rows if k.startswith("W=")),
                    key=lambda k: rows[k]["graph_ms"])
        emit("k1_sweep", card=card, grid=[2, n, n], launched=launched,
             least=least, layouts=rows, bound_ms=bound("K1", n, n)[0],
             k12_graph_ms=k12_ms, k12_graph_runs_ms=k12_runs,
             k12_layout=launched)
        out[n] = dict(launched=launched, least=least,
                      launched_ms=rows[launched]["graph_ms"],
                      least_ms=rows[least]["graph_ms"],
                      tile_ms=rows["step_kernel (tile)"]["graph_ms"],
                      k18_base_ms=rows["K18 base"]["graph_ms"],
                      copy_ms=rows["copy"]["graph_ms"],
                      k12_ms=k12_ms["K12 rows"],
                      k12_tile_ms=k12_ms["K12 step_sharded_kernel (tile)"])
        del zeta, psi, f1, f2, zt, zb, pt, pb, k12
        free_memory()
    return out


def phase_k9_sweep(dev, card, sizes=(2048, 8192), reps=(20, 5)) -> dict:
    """K9's row-streaming kernel (tendency_rows_kernel) in every layout
    (W, R, D, NT) of K1's sweep on two-layer (2, n, n) fields: registers,
    spill bytes, shared memory and blocks an SM; outputs bitwise across
    layouts and the tile kernel (tendency_kernel, the kernel it replaces);
    ms a launch replayed from a CUDA graph, the layouts in turns (in order,
    then in reverse), beside the tile kernel and a torch copy of K9's bytes
    (a (3, n, n) field read and written: zeta and psi read, the tendency
    written). At 2048^2 also one layer with the wind (its launched layout
    bitwise the tile kernel, both against plain) and the two-layer
    tendency, on rows and on the tile kernel, bitwise K1's carry under
    euler_ab3 at step 0 (the carry is the tendency there). Returns the
    entries by grid."""
    rng = np.random.default_rng(SEED + 23)
    turb = preset("turbulence-2048")
    out = {}
    for n, r in zip(sizes, reps):
        cfg = turb.replace(M=n, P=n)
        zeta, psi, f1, f2 = step_inputs(cfg, dev, rng)
        tile = fused_tendency_tile(cfg, zeta, psi)
        rows, calls = {}, {}
        for lay in step_rows_layouts():
            key = k1_layout_name(lay)
            rows[key] = dict(tendency_rows_attributes(lay, 2, dev.index or 0))
            got = fused_tendency_rows(cfg, zeta, psi, lay)
            if not torch.equal(got, tile):
                raise AssertionError(f"K9 rows {key} at {n}^2: not bitwise "
                                     "the tile kernel")
            del got
            calls[key] = lambda lay=lay: fused_tendency_rows(cfg, zeta, psi,
                                                             lay)
        extra = {}
        if n == 2048:
            k1_tile = fused_step_tile(cfg, zeta, psi, f1, f2, 0)[1]
            k1 = fused_step(cfg, zeta, psi, f1, f2, 0)[1]
            rows_now = fused_tendency_rows(cfg, zeta, psi)
            extra["bitwise_k1_carry"] = {"rows": torch.equal(rows_now, k1),
                                         "tile": torch.equal(tile, k1_tile)}
            if not all(extra["bitwise_k1_carry"].values()):
                raise AssertionError(f"K9 at {n}^2: not bitwise K1's "
                                     f"euler_ab3 carry {extra}")
            del k1_tile, k1, rows_now
            one = turb.replace(M=n, P=n, n_layers=1, wind_tau0=0.1)
            z1, p1 = zeta[:1].contiguous(), psi[:1].contiguous()
            got, t1 = (fused_tendency_rows(one, z1, p1),
                       fused_tendency_tile(one, z1, p1))
            if not torch.equal(got, t1):
                raise AssertionError(f"K9 rows one layer at {n}^2: not "
                                     "bitwise the tile kernel")
            _, rel = rel_err(got, fused_tendency_plain(one, z1, p1))
            if not rel <= TOL["K9"]:
                raise AssertionError(f"K9 rows one layer: rel err {rel}")
            extra["one_layer_wind"] = {
                "layout": k1_layout_name(tendency_rows_launched(n)),
                "bitwise_tile": True, "rel_err_vs_plain": rel,
                "attributes": tendency_rows_attributes(
                    tendency_rows_launched(n), 1, dev.index or 0)}
            del z1, p1, got, t1
        src = torch.empty((3, n, n), device=dev)
        dst = torch.empty_like(src)
        calls.update({
            "tendency_kernel (tile)": lambda: fused_tendency_tile(cfg, zeta,
                                                                  psi),
            "copy": lambda: dst.copy_(src)})
        runs = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k].append(graph_ms(calls[k], r))
        for key, v in runs.items():
            rows.setdefault(key, {}).update(graph_ms=sum(v) / 2,
                                            graph_runs_ms=v)
        launched = k1_layout_name(tendency_rows_launched(n))
        least = min((k for k in rows if k.startswith("W=")),
                    key=lambda k: rows[k]["graph_ms"])
        emit("k9_sweep", card=card, grid=[2, n, n], launched=launched,
             least=least, layouts=rows, bound_ms=bound("K9", n, n)[0],
             **extra)
        out[n] = dict(launched=launched, least=least,
                      launched_ms=rows[launched]["graph_ms"],
                      least_ms=rows[least]["graph_ms"],
                      tile_ms=rows["tendency_kernel (tile)"]["graph_ms"],
                      copy_ms=rows["copy"]["graph_ms"],
                      launched_attributes={
                          k: rows[launched][k]
                          for k in ("regs", "local_bytes", "smem",
                                    "blocks_per_sm")}, **extra)
        del zeta, psi, f1, f2, tile, src, dst, calls
        free_memory()
    return out


# The persistent K17, K15, K16 and K15's sharded form (csrc/coop_rows.cuh)
# and the grids coop_sweep holds them at: K17 at the slices' 2048^2 and the
# mixed 1536^2 and 2560^2 (the largest square its route gate admits); K15
# at 2048^2, the mixed 3072^2 and pod-8192's 8192^2 (its chain); K16 at the
# mono slice's 2048^2 and the mixed 1536^2; K15s on the row blocks of the
# 2048^2 mesh chain slices, the one rank's (2, 2048, 2048) and rank 0 of
# (4, 1)'s (2, 512, 2048) (n: the block's rows).
COOP_SWEEP = (("K17", 2048), ("K17", 1536), ("K17", 2560), ("K15", 2048),
              ("K15", 3072), ("K15", 8192), ("K16", 2048), ("K16", 1536),
              ("K15s", 2048), ("K15s", 512))
COOP_BARRIER = ("cooperative_groups this_grid().sync() in a cudaLaunchKernelEx "
                "launch with the cooperative attribute (K17, K16: and a "
                "cluster dimension of G), every block co-resident")
# Each persistent kernel's wrapper (its rows_grid), ptxas name and stages.
COOP_KERNELS = {"K17": (fused_step_full, "coop_fullstep_rows_kernel", 4),
                "K15": (fused_step_yspec, "coop_yspec_rows_kernel", 3),
                "K16": (mono_invert, "coop_mono_rows_kernel", 3),
                "K15s": (fused_step_yspec_sharded,
                         "coop_yspec_sharded_rows_kernel", 3)}


def separate_route(name, cfg, zeta, psi, f1, f2, step, sl=None):
    """The separate redesigned kernels that K17 (K1 -> K2 -> K3 -> K2^-1),
    K15 (K2^-1 -> K1 -> K2; psi as its y-spectrum) or K15's sharded form
    (K2^-1 of the block and of the psi slabs of sl -> K12 -> K2) fuses, each
    by its counting wrapper."""
    if name == "K17":
        zn, carry = fused_step(cfg, zeta, psi, f1, f2, step)
        consts = step_kernel.packed_symbol_consts(cfg)
        return zn, carry, y_dft(pair_x_symbols(y_dft(zn, False), consts),
                                True)
    if name == "K15s":
        zt, zb, pt, pb = sl
        zn, carry = fused_step_sharded(cfg, zeta, y_dft(psi, True), f1, f2,
                                       step, zt, zb, y_dft(pt, True),
                                       y_dft(pb, True))
    else:
        zn, carry = fused_step(cfg, zeta, y_dft(psi, True), f1, f2, step)
    return zn, carry, y_dft(zn, False)


def coop_entry(name, n, turb, dev, rng) -> dict:
    """One COOP_SWEEP entry: ``call(kind, case, **kw)`` runs the persistent
    kernel ("new"), its first form ("old"), the plain version ("plain") or
    the separate route ("separate") on a case (a step case of STEP_CASES;
    K16: a field), returning a tuple of outputs; "cases" the cases checked,
    "timed" the one timed, "parts" the outputs' names, "shape" the
    operands', "psi64" (case, plain outputs) -> (float64 psi, the plain
    version's float32 psi) for a psi part, "plan" the layouts, "takes" the
    take rule on these operands."""
    cases = {c: (over, step) for c, over, step in STEP_CASES}
    if name == "K16":
        cfg = turb.replace(M=n, P=n)
        consts = step_kernel.packed_symbol_consts(cfg)
        fields = {"zeta of a grid-noise psi": init_state(cfg, dev).zeta,
                  "random field": torch.as_tensor(
                      rng.standard_normal((2, n, n)), dtype=torch.float32,
                      device=dev)}
        fns = {"new": mono_invert_rows, "old": mono_invert_coop,
               "plain": mono_invert_plain,
               "separate": lambda z, c: y_dft(pair_x_symbols(
                   y_dft(z, False), c), True)}
        plan = mono_rows_plan(n, n)
        return dict(
            call=lambda kind, case, **kw: (fns[kind](fields[case], consts,
                                                     **kw),),
            cases=list(fields), timed=next(iter(fields)), parts=("psi",),
            shape=[2, n, n], plan={"y (Rb, threads)": plan.y,
                                   "x (G, Cw)": plan.x}, smem=plan.smem,
            psi64=lambda case, plain: (mono_invert_plain(
                fields[case].double(), consts), plain[0]),
            takes=mono_rows_takes(n, n, fields["random field"]),
            operands=fields)
    x = name == "K17"
    if name == "K15s":
        nx = turb.M // n
        block, ((zt, zb), (pt, pb)), _, _ = sharded_inputs(turb, dev, rng,
                                                           nx, 0)
        cfg = turb
        block[1] = y_dft_plain(block[1], False)
        sl = (zt, zb, y_dft_plain(pt, False), y_dft_plain(pb, False))
        M, P = n, turb.P
        fns = {"new": fused_step_yspec_sharded_rows,
               "old": fused_step_yspec_sharded_coop,
               "plain": fused_step_yspec_sharded_plain,
               "separate": lambda c, *a: separate_route(name, c, *a, sl=sl)}
        take = coop_rows_takes(M, P, False, *block, *sl)

        def call(kind, case, **kw):
            over, step = cases[case]
            extra = () if kind == "separate" else sl
            return fns[kind](cfg.replace(**over), *block, step, *extra, **kw)
    else:
        cfg = turb.replace(M=n, P=n)
        block = list(step_inputs(cfg, dev, rng))
        if not x:
            block[1] = y_dft_plain(block[1], False)
        M = P = n
        fns = {"new": fused_step_full_rows if x else fused_step_yspec_rows,
               "old": fused_step_full_coop if x else fused_step_yspec_coop,
               "plain": fused_step_full_plain if x else
               fused_step_yspec_plain,
               "separate": lambda c, *a: separate_route(name, c, *a)}
        take = coop_rows_takes(n, n, x, *block)

        def call(kind, case, **kw):
            over, step = cases[case]
            return fns[kind](cfg.replace(**over), *block, step, **kw)
    consts = step_kernel.packed_symbol_consts(cfg)
    plan = coop_rows_plan(M, P, x)
    return dict(
        call=call, timed=STEP_CASES[1][0],
        cases=[c for c, _, _ in (STEP_CASES if n == 2048 or name == "K15s"
                                 else STEP_CASES[1:2])],
        parts=("zeta_new", "carry", "psi_new" if x else "zeta_ys"),
        shape=[2, M, P], plan={"step (W, R, D, NT)": plan.step,
                               "y (Rb, threads)": plan.y, "x (G, Cw)": plan.x},
        smem=plan.smem,
        psi64=lambda case, plain: (mono_invert_plain(plain[0].double(),
                                                     consts),
                                   mono_invert_plain(plain[0], consts)),
        takes=take, operands=block)


def phase_coop_sweep(errs, turb, dev, card, named_ptxas, reps=20) -> dict:
    """K17, K15, K16 and K15's sharded form by their persistent kernels at
    COOP_SWEEP's grids (coop_entry: step_inputs, psi as its y-spectrum for
    K15 and K15s, K15s's slabs sliced from the whole fields; K16 on a
    grid-noise zeta and a random field): bitwise the separate routes
    (separate_route), on every step case at 2048^2 and on K15s's blocks and
    on one past the Euler start elsewhere; against the first form
    (fused_step_full_coop, fused_step_yspec_coop, mono_invert_coop,
    fused_step_yspec_sharded_coop) and the plain version: zeta_new and carry
    1e-6, zeta_ys 1e-5, psi_new and K16's psi 1e-4 or, where 1/lambda lifts
    float32 rounding past that, no less accurate against float64 than
    twice the plain version; the grid (blocks, clusters, blocks an SM), the
    barrier and the ptxas lines; and ms a launch replayed from a CUDA graph,
    in turns (in order, then in reverse), beside the first form, the
    separate route and a copy of the same bytes (a torch copy of 3.5 (2, M,
    P) fields, seven fields read or written; K16 one field, two), at 2048^2
    the persistent kernel cut after each of its first stages (its
    ``stages`` argument), and on K15s's (2, 512, 2048) block also ms
    host-launched (CUDA events) and the host's enqueue ms. Returns the
    entries by "name at n^2" ("K15s at (2, m, P)")."""
    rng = np.random.default_rng(SEED + 21)
    out = {}
    for name, n in COOP_SWEEP:
        e = coop_entry(name, n, turb, dev, rng)
        call, shape = e["call"], e["shape"]
        label = (f"{name} at {tuple(shape)}" if name == "K15s"
                 else f"{name} at {n}^2")
        if not e["takes"]:
            raise AssertionError(f"{label}: the persistent kernel does not "
                                 "take the grid")
        wrapper, kernel, stages = COOP_KERNELS[name]
        checks = []
        for case in e["cases"]:
            got = call("new", case)
            sep = call("separate", case)
            bitwise = [bool(torch.equal(g, w)) for g, w in zip(got, sep)]
            if not all(bitwise):
                raise AssertionError(f"{label} {case}: not bitwise the "
                                     f"separate route ({bitwise})")
            del sep
            old = call("old", case)
            plain = call("plain", case)
            rec = {"case": case, "bitwise_separate": bitwise}
            for part, g, o, w in zip(e["parts"], got, old, plain):
                tol = (TOL["K17 psi_new"] if part == "psi_new" else
                       TOL["K15 zeta_ys"] if part == "zeta_ys" else TOL[name])
                rel_old, rel_plain = rel_err(g, o)[1], rel_err(g, w)[1]
                rec[part] = {"rel_vs_first_form": rel_old,
                             "rel_vs_plain": rel_plain, "tol": tol}
                if part not in ("psi_new", "psi"):
                    errs.record(name, f"{case} {part} at {tuple(shape)} "
                                "(persistent)", g, w, tol, quiet=True)
                    if not rel_old <= tol:
                        raise AssertionError(f"{label} {case} {part}: "
                                             f"{rel_old} from the first form")
                elif not (rel_old <= tol and rel_plain <= tol):
                    # Both float32; hold both against float64.
                    ref, p32 = e["psi64"](case, plain)
                    e_new = rel_err(g.double(), ref)[1]
                    e_old = rel_err(p32.double(), ref)[1]
                    rec[part].update(rel_float64=e_new,
                                     rel_float64_plain_version=e_old)
                    if not e_new <= 2.0 * e_old:
                        raise AssertionError(
                            f"{label} {case} {part}: float64 error {e_new} "
                            f"exceeds twice the plain version's {e_old}")
                    del ref, p32
            checks.append(rec)
            del got, old, plain
        grid = wrapper.rows_grid
        copy_fields = 1 if name == "K16" else 3.5
        src = torch.empty((int(2 * copy_fields), *shape[1:]), device=dev)
        dst = torch.empty_like(src)
        case = e["timed"]
        calls = {
            "persistent": lambda: call("new", case),
            "first form": lambda: call("old", case),
            "separate route": lambda: call("separate", case),
            "copy": lambda: dst.copy_(src)}
        if n == 2048:
            # The first k stages alone (the plan's stage count), so that
            # the differences read each stage and its grid barrier.
            for k in range(1, stages):
                calls[f"stages 1-{k}"] = (
                    lambda k=k: call("new", case, stages=k))
        r = reps if shape[1] * shape[2] <= 3072 ** 2 else 5
        runs = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k].append(graph_ms(calls[k], r))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        b = bound(name, shape[1], shape[2])[0]
        entry = dict(kernel=name, grid=shape, card=card, checks=checks,
                     launch_grid=dict(zip(("blocks", "clusters",
                                           "blocks_per_sm", "step_rows"),
                                          grid)),
                     barrier=COOP_BARRIER, layouts=e["plan"], smem=e["smem"],
                     graph_ms=ms, graph_runs_ms=runs, bound_ms=b,
                     share=b / ms["persistent"], ptxas=named_ptxas[kernel])
        if name == "K16":
            entry["x_tile_pairs"] = mono_rows_plan(n, n).ints[9]
        if name == "K15s" and n != turb.M:
            # A small block: the host's cost of a launch may pass the
            # device's time.
            host = {k: [] for k in ("persistent", "first form",
                                    "separate route")}
            events = {k: [] for k in host}
            for k in list(host) + list(host)[::-1]:
                events[k].append(time_ms(calls[k], 2 * reps))
                host[k].append(host_enqueue(calls[k], 2 * reps))
            entry.update(host_launched_ms={k: sum(v) / 2
                                           for k, v in events.items()},
                         host_enqueue_ms={k: sum(v) / 2
                                          for k, v in host.items()})
        emit("coop_sweep", **entry)
        out[label] = entry
        del e, call, src, dst, calls
        free_memory()
    return out


# K2's factored kernel: the layouts (Rb rows a block, threads) timed at
# each n^2, the launched one (dft_kernels.Y_FACTORED_RB_BY_P) among them.
K2_SWEEP = {256: ((1, 256), (2, 256), (4, 256)),
            512: ((1, 256), (2, 256), (4, 256)),
            1024: ((1, 256), (2, 256), (4, 256)),
            2048: ((2, 256), (4, 256), (2, 512)),
            4096: ((1, 256), (2, 256), (2, 512)),
            8192: ((1, 256), (1, 512))}


def k2_layout_name(layout) -> str:
    return "Rb={} threads={}".format(*layout)


def phase_k2_sweep(errs, dev, card, reps=20) -> dict:
    """K2's factored kernel in each layout of K2_SWEEP at n^2: its bytes of
    shared memory, the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its largest error
    against the plain version both ways, and ms a launch each way, the
    layouts in turns (in order, then in reverse), beside y_dft_kernel (a
    block a whole row, the kernel it replaces, its error both ways recorded
    as K2's), one torch.fft.fft along y
    of the same complex64 field and a torch copy of the field: host-launched
    (time_ms) and replayed from a CUDA graph (graph_ms). Returns the entries
    by grid."""
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for n, layouts in K2_SWEEP.items():
        x = torch.as_tensor(rng.standard_normal((2, n, n)),
                            dtype=torch.float32, device=dev)
        want = [y_dft_plain(x, inverse) for inverse in (False, True)]
        rows, calls = {}, {}
        for lay in layouts:
            key = k2_layout_name(lay)
            occ = y_dft_factored_occupancy(n, lay, dev.index)
            rows[key] = dict(smem=y_dft_factored_layout(n, *lay).smem,
                             blocks_per_sm=occ)
            if occ == 0:                 # the card cannot schedule it
                continue
            err = max(rel_err(y_dft_factored(x, inverse, lay), w)[1]
                      for inverse, w in enumerate(want))
            rows[key]["rel_err"] = err
            if not err <= TOL["K2"]:
                raise AssertionError(f"K2 factored {key} at {n}^2: rel err "
                                     f"{err} > {TOL['K2']}")
            for inverse in (False, True):
                calls[(key, inverse)] = (
                    lambda lay=lay, inverse=inverse:
                    y_dft_factored(x, inverse, lay))
        for inverse, w in zip((False, True), want):
            errs.record("K2", f"y_dft_kernel {n}x{n} " + (
                "inverse" if inverse else "forward"),
                y_dft_whole_row(x, inverse), w)
            calls[("y_dft_kernel", inverse)] = (
                lambda inverse=inverse: y_dft_whole_row(x, inverse))
        del want
        c64 = torch.complex(x[0], x[1])
        calls[("library", False)] = lambda: torch.fft.fft(c64, dim=1)
        calls[("copy", False)] = lambda: x.clone()
        runs = {k: ([], []) for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k][0].append(time_ms(calls[k], reps))
            runs[k][1].append(graph_ms(calls[k], reps))
        refs = {}
        for (key, inverse), (r, g) in runs.items():
            way = "inverse_" if inverse else ""
            if key in rows:
                rows[key].update({f"{way}ms": sum(r) / 2,
                                  f"{way}graph_ms": sum(g) / 2,
                                  f"{way}runs_ms": r,
                                  f"{way}graph_runs_ms": g})
            else:
                name = key + (" inverse" if inverse else "")
                refs[name] = sum(r) / 2
                refs[name + " graph"] = sum(g) / 2
        emit("k2_sweep", card=card, grid=[n, n],
             launched=(k2_layout_name(dft_kernels.Y_FACTORED_RB_BY_P[n])
                       if n in dft_kernels.Y_FACTORED_RB_BY_P else
                       "y_dft_kernel"),
             layouts=rows, library_ms=refs["library"], reference_ms=refs,
             bound_ms=bound("K2", n, n)[0])
        out[n] = dict(layouts=rows, reference_ms=refs)
        del x, c64, calls
        free_memory()
    return out


def mg_inputs(n: int, dev, seed: int):
    """u, f (2, n, n) and ec (2, n/2, n/2) float32, white, at a solution's,
    a right-hand side's and a coarse correction's scale (uniform draws:
    four times quicker than normal ones at 8192^2)."""
    g = np.random.default_rng(seed)
    return [torch.as_tensor(g.random(shape, dtype=np.float32) - 0.5,
                            device=dev) * scale
            for scale, shape in ((1e-2, (2, n, n)), (1e-5, (2, n, n)),
                                 (1e-3, (2, n // 2, n // 2)))]


# The row-streaming kernel's forms, K10's three and K11's.
MG_ROW_FORMS = (("K10", "restrict"), ("K10", "residual"), ("K10", "smooth"),
                ("K11", "prolong"))


def mg_levels(cfg) -> list:
    """(m, p, h) of every level of cfg's MG solver (V(2, 2), cutoff 32)."""
    return MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig)).levels


def mg_form_calls(form, u, f, ec, h, alphas, layout=None):
    """(row kernel, tile kernel, plain version) of ``form`` at a level,
    each returning (u, r | rc | None)."""
    if form == "prolong":
        return (lambda: mg_rows(form, u, f, ec, h, alphas, MG_NU, 0.8,
                                layout),
                lambda: (mg_prolong_tile(u, ec, f, h, alphas, MG_NU), None),
                lambda: (mg_prolong_smooth_plain(u, ec, f, h, alphas, MG_NU),
                         None))
    res, rst = form != "smooth", form == "restrict"
    return (lambda: mg_rows(form, u, f, None, h, alphas, MG_NU, 0.8, layout),
            lambda: mg_smooth_tile(u, f, h, alphas, MG_NU, res, 0.8, rst),
            lambda: mg_smooth_plain(u, f, h, alphas, MG_NU, res, 0.8, rst))


def same_bits(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def phase_mg_kernels(errs, turb, pod_mg, dev, card) -> None:
    """K10 in its three forms and K11 at every level of the pod-8192-mg
    solver (8192^2 .. 64^2), of turbulence-2048's (2048^2 .. 64^2) and of
    its 1536^2 grid's (1536^2 .. 48^2), with the level's spacing, alpha =
    (0, S_eig) and nu = 2 on random inputs: the row-streaming kernel in its
    launched layout bitwise the tile kernel, and against the plain version
    under TOL; one line a solver. K9 on the model's initial state at
    (2, 2048, 2048), (1, 2048, 2048) with the wind, and (2, 8192, 8192)."""
    for name, cfg in (("pod-8192-mg", pod_mg), ("turbulence-2048", turb),
                      ("turbulence-2048 at 1536^2",
                       turb.replace(M=1536, P=1536))):
        alphas = (0.0, cfg.S_eig)
        worst = {}
        for m, _, h in mg_levels(cfg):
            u, f, ec = mg_inputs(m, dev, SEED + m)
            for kernel, form in MG_ROW_FORMS:
                rows, tile, plain = mg_form_calls(form, u, f, ec, h, alphas)
                got, ref, want = rows(), tile(), plain()
                if not same_bits(got, ref):
                    raise AssertionError(f"{kernel} rows {form} at {name} "
                                         f"level {m}^2: not bitwise the tile "
                                         "kernel")
                for part, g, w in zip(("u", "r"), got, want):
                    if w is None:
                        continue
                    errs.record(kernel, f"{name} level {m}^2 {form} {part}",
                                g, w, quiet=True)
                    worst[kernel] = max(worst.get(kernel, 0.0),
                                        errs.last_rel)
                del got, ref, want
            del u, f, ec
        free_memory()
        emit("mg_kernels", card=card, solver=name, grid=[cfg.M, cfg.P],
             levels=[lvl[0] for lvl in mg_levels(cfg)],
             forms=[f for _, f in MG_ROW_FORMS],
             layouts={m: mg_rows_launched(m) for m, _, _ in mg_levels(cfg)},
             bitwise_tile="every form at every level",
             max_rel_err_vs_plain=worst, tol={k: TOL[k] for k in worst})
    for case, cfg in (("two layers", turb),
                      ("one layer + wind",
                       turb.replace(n_layers=1, wind_tau0=0.1)),
                      ("two layers", pod_mg)):
        state = init_state(cfg, dev)
        errs.record("K9", f"{cfg.M}^2 {case}",
                    fused_tendency(cfg, state.zeta, state.psi),
                    fused_tendency_plain(cfg, state.zeta, state.psi))
        del state
        free_memory()
    torch.cuda.synchronize()


def mg_layout_name(layout) -> str:
    return "R={} D={} NT={}".format(*layout)


def phase_mg_sweep(dev, card, pod_mg, sizes=(8192, 4096, 2048, 1024, 512,
                                             64),
                   reps=(5, 10, 20, 40, 50, 50)) -> dict:
    """The row-streaming kernel's restrict form (K10 on the V-cycle) and
    K11 in every layout (R, D, NT) of mg_rows_layouts at the pod-8192-mg
    solver's levels of ``sizes``: registers, spills, shared memory and
    blocks an SM, outputs bitwise the tile kernel's, and ms a launch
    replayed from a CUDA graph in turns (in order, then in reverse) beside
    the tile kernel and a copy of the same bytes (3.25 (2, n, n) fields,
    a read and a write). Returns the entries by level."""
    levels = {m: h for m, _, h in mg_levels(pod_mg)}
    alphas = (0.0, pod_mg.S_eig)
    out = {}
    for n, r in zip(sizes, reps):
        u, f, ec = mg_inputs(n, dev, SEED + n + 2)
        h = levels[n]
        rows, calls = {}, {}
        for kernel, form in (("K10", "restrict"), ("K11", "prolong")):
            ref = mg_form_calls(form, u, f, ec, h, alphas)[1]()
            for lay in mg_rows_layouts():
                key = f"{kernel} {mg_layout_name(lay)}"
                rows[key] = mg_rows_attributes(form, MG_NU, lay,
                                               dev.index or 0)
                fn = mg_form_calls(form, u, f, ec, h, alphas, lay)[0]
                if not same_bits(fn(), ref):
                    raise AssertionError(f"{key} at {n}^2: not bitwise the "
                                         "tile kernel")
                calls[key] = fn
            calls[f"{kernel} tile"] = mg_form_calls(form, u, f, ec, h,
                                                    alphas)[1]
            del ref
        src = torch.empty(int(3.25 * n * n), device=dev)
        dst = torch.empty_like(src)
        calls["copy"] = lambda: dst.copy_(src)
        runs = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            runs[k].append(graph_ms(calls[k], r))
        for key, v in runs.items():
            rows.setdefault(key, {}).update(graph_ms=sum(v) / 2,
                                            graph_runs_ms=v)
        least = {k: min((key for key in rows if key.startswith(f"{k} R=")),
                        key=lambda key: rows[key]["graph_ms"])
                 for k in ("K10", "K11")}
        emit("mg_sweep", card=card, level=[2, n, n],
             launched=mg_layout_name(mg_rows_launched(n)), least=least,
             layouts=rows, bound_ms=bound("K10", n, n)[0])
        out[n] = dict(least=least, layouts=rows)
        del u, f, ec, src, dst, calls
        free_memory()
    return out


def slabs(fields, r0: int, m: int, h: int = HALO_ROWS):
    """(top, bottom) h-row slabs of whole fields around rows [r0, r0 + m),
    wrapped periodically: what the block's x-neighbours send."""
    M = fields[0].shape[1]
    top = torch.tensor([(r0 - h + i) % M for i in range(h)], device=fields[0].device)
    bot = torch.tensor([(r0 + m + i) % M for i in range(h)], device=fields[0].device)
    return [(a[:, top].contiguous(), a[:, bot].contiguous()) for a in fields]


def sharded_inputs(cfg, dev, rng, nx: int, k: int):
    """Rank k of nx's row block of step_inputs' fields and its slabs, and
    the whole fields."""
    whole = step_inputs(cfg, dev, rng)
    m = cfg.M // nx
    rows = slice(k * m, (k + 1) * m)
    block = [a[:, rows].contiguous() for a in whole]
    return block, slabs(whole[:2], k * m, m), whole, rows


def check_sharded_step(errs, cfg, dev, rng, nx, k, cases, tag="") -> None:
    """K12 on rank k's block against its plain version and against K1's
    rows of the whole field, 1e-6; its tile kernel (step_sharded_kernel,
    the route of P % 4 != 0 and misaligned operands) against the plain
    version too."""
    block, ((zt, zb), (pt, pb)), whole, rows = sharded_inputs(cfg, dev, rng,
                                                              nx, k)
    for case, over, step in cases:
        c = cfg.replace(**over)
        got = fused_step_sharded(c, *block, step, zt, zb, pt, pb)
        tile = fused_step_sharded_tile(c, *block, step, zt, zb, pt, pb)
        want = fused_step_sharded_plain(c, *block, step, zt, zb, pt, pb)
        k1 = fused_step(c, *whole, step)
        for part, g, t, w, w1 in zip(("zeta_new", "carry"), got, tile, want,
                                     k1):
            errs.record("K12", f"{tag}{case} {part}", g, w)
            errs.record("K12", f"{tag}{case} {part} vs K1's rows", g,
                        w1[:, rows])
            errs.record("K12", f"{tag}{case} {part} tile kernel", t, w)


def check_cols(errs, name, case, kern, plain, cluster: bool,
               mixed: bool = False) -> None:
    """A column x-stage (K13, K14 or K7) against its plain version, recorded
    as "K13 mixed" (...) where ``mixed``, with its cluster count ("K13
    cluster", ...) rising by 1 exactly where ``cluster`` (the block kernel's
    shapes; K3's cluster kernels' for K7) and its mixed count ("K13 mixed",
    ...) exactly where ``mixed`` (the mixed instance's)."""
    counters = [COUNTERS[f"{name} {kind}"] for kind in ("cluster", "mixed")]
    n = [c.launches for c in counters]
    errs.record(f"{name} mixed" if mixed else name, case, kern(), plain())
    torch.cuda.synchronize()
    moved = [c.launches - k for c, k in zip(counters, n)]
    if moved != [int(cluster), int(mixed)]:
        raise AssertionError(f"{name} {case}: {moved} cluster and mixed "
                             f"launches")


def phase_sharded_kernels(errs, turb, pod, dev) -> None:
    """K12, K15's sharded form, K13, K14 and K7 against their plain
    versions at the mesh slices' shapes (see the module docstring)."""
    rng = np.random.default_rng(SEED + 5)
    check_sharded_step(errs, turb, dev, rng, 4, 1, STEP_CASES,
                       "(2, 512, 2048) of 2048^2 ")
    block, ((zt, zb), (pt, pb)), _, _ = sharded_inputs(turb, dev, rng, 4, 1)
    z, p, f1, f2 = block
    whole_ys = [y_dft_plain(a, False) for a in (pt, pb)]
    p_ys = y_dft_plain(p, False)
    for case, over, step in STEP_CASES:
        c = turb.replace(**over)
        got = fused_step_yspec_sharded(c, z, p_ys, f1, f2, step, zt, zb,
                                       *whole_ys)
        want = fused_step_yspec_sharded_plain(c, z, p_ys, f1, f2, step, zt,
                                              zb, *whole_ys)
        for part, g, w in zip(("zeta_new", "carry", "zeta_ys"), got, want):
            errs.record("K15s", f"(2, 512, 2048) {case} {part}", g, w,
                        TOL["K15 zeta_ys"] if part == "zeta_ys" else None)
    del block, z, p, f1, f2, whole_ys, p_ys
    free_memory()
    check_sharded_step(errs, pod, dev, rng, 4, 2, STEP_CASES[1:2],
                       "(2, 2048, 8192) of 8192^2 ")
    free_memory()

    # K13 on random y-spectra: a rank's column block and its companion, by
    # the block kernel (pair_cols_cluster_kernel) at the power-of-two
    # slices' shapes, by its mixed instance (pair_cols_cluster_mixed_kernel)
    # at the 3072^2 slice's (2, 3072, 768) and at 2432 = 128 * 19, and by
    # pair_cols_kernel at 768 = 128 * 6 (U = 3 < G).
    for cfg, nx, offs in ((turb, 4, (0, 3)), (pod, 4, (2,)),
                          (turb.replace(M=3072, P=3072), 4, (0, 1)),
                          (turb.replace(M=2432), 4, (0, 3)),
                          (turb.replace(M=768, P=1024), 4, (0, 3))):
        consts = inverter(cfg)._sym_consts
        x = torch.as_tensor(rng.standard_normal((2, cfg.M, cfg.P)),
                            dtype=torch.float32, device=dev)
        xm = mirror_companion(x)
        w = cfg.P // nx
        for k in offs:
            cols = slice(k * w, (k + 1) * w)
            a, b = x[..., cols].contiguous(), xm[..., cols].contiguous()
            off = k * w // 128
            takes = pair_cols_cluster_takes(cfg.M, w)
            check_cols(errs, "K13", f"({cfg.M}, {w}) strip offset {off}",
                       lambda: x_fwd_symbols_offset(a, b, consts, off),
                       lambda: x_fwd_symbols_offset_plain(a, b, consts, off),
                       takes, takes and dft_kernels._mixed(cfg.M))
        del x, xm
        free_memory()

    # K14: ranks 0 (the self-mirror group) and 3 of 4 at 2048^2 (the block
    # kernel), ranks 0 and 2 at the 1536 x 2048 slice's (2, 1536, 512) and
    # rank 0 at 2432 x 2048 (its mixed instance), ranks 0 and 3 at 768 x
    # 1024 (pair_cols_kernel).
    for cfg, ranks in ((turb, (0, 3)), (turb.replace(M=1536), (0, 2)),
                       (turb.replace(M=2432), (0,)),
                       (turb.replace(M=768, P=1024), (0, 3))):
        consts = inverter(cfg)._sym_consts
        order = strip_pair_order(cfg.P // 128)
        w, strips = cfg.P // 4, cfg.P // 4 // 128
        x = torch.as_tensor(rng.standard_normal((2, cfg.M, cfg.P)),
                            dtype=torch.float32, device=dev)
        for k in ranks:
            blk = x[..., k * w:(k + 1) * w].contiguous()
            idx = order[k * strips:(k + 1) * strips]
            takes = pair_cols_cluster_takes(cfg.M, w)
            check_cols(errs, "K14",
                       f"({cfg.M}, {w}) rank {k} of 4, groups {list(idx)}",
                       lambda: paired_x_symbols(blk, idx, consts),
                       lambda: paired_x_symbols_plain(blk, idx, consts),
                       takes, takes and dft_kernels._mixed(cfg.M))

    # K7 on random y-spectra (K3's cluster kernel at 4096^2 and 8192^2, its
    # mixed cluster kernel at 3072^2 and 2432 x 2048, pair_cols_kernel at
    # 768 x 256), then on pod-8192's zeta against float64.
    for M, P in ((4096, 4096), (8192, 8192), (3072, 3072), (2432, 2048),
                 (768, 256)):
        cfg = pod.replace(M=M, P=P)
        consts = inverter(cfg)._sym_consts
        x = torch.as_tensor(rng.standard_normal((2, M, P)),
                            dtype=torch.float32, device=dev)
        takes = stream_pair_cluster_takes(M)
        check_cols(errs, "K7", f"random y-spectrum {M}x{P}",
                   lambda: stream_pair_symbols(x, consts),
                   lambda: stream_pair_symbols_plain(x, consts),
                   takes, takes and dft_kernels._mixed(M))
        del x
        free_memory()
    consts = inverter(pod)._sym_consts
    zy = y_dft_plain(init_state(pod, dev).zeta, False)
    vs_float64("K7", "pod-8192 zeta y-spectrum",
               lambda z: stream_pair_symbols(z, consts),
               lambda z: stream_pair_symbols_plain(z, consts), zy)
    del zy
    emit("kernels", grids={"K15s": fused_step_yspec_sharded.rows_grid},
         grid_is="(blocks, clusters, blocks an SM, the step units' rows) of "
         "its persistent kernel")
    free_memory()


def mg_inverter(cfg, cycles: int, use_pallas: str = "auto"):
    return MultigridModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                  cfg.P_inv_matrix(),
                                  cfg.back_projection_matrix(),
                                  n_cycles=cycles, use_pallas=use_pallas)


def mg_problem(cfg, state, dev):
    """(zeta, first seed): the zeta of one more default-route step from
    ``state``, seeded with ``state``'s psi, as the model's stepping would
    seed it."""
    nxt = QGModel(cfg, dev).step(state)
    return nxt.zeta, state.psi


def run_mg_path(name, cfg, dev, zeta, seed, cycles, calls,
                kernel_levels) -> dict:
    """``calls`` warm-started MultigridModalInverter calls on the same zeta,
    each seeded with the previous call's psi (scripts/decomp_r4.py's mg@C
    job), with every launch count set to 0 just before and read just after;
    then the plain MG route (use_pallas="off") the same way, and a float64
    spectral inversion of zeta. Gates: ``kernel_levels`` kernel levels
    (the port's gate, MultigridSolver._kernel_level: every level of extent
    >= 512, 5 at 8192^2, 3 at 2048^2) and exact K10/K11 counts (one each a
    kernel level a cycle), every launch by the row-streaming kernel ("K10
    rows" = K10, "K11 rows" = K11); the kernel route's float64 error no
    more than twice
    the plain route's or 1e-6 of max|psi|; and psi within TOL["mg_psi"] of
    the plain route, unless both routes sit at the float32 floor of this
    zeta: on a grid-noise state the low-k part of the residual's rounding
    (eps |f| per point) comes back through 1/lambda as ~eps n / 5 of
    max|psi| in ANY float32 inversion, 2e-5 at 2048^2, so two converged
    float32 routes differ by about that and only the float64 rule can tell
    them apart (as for K3 and the slices)."""
    kern = mg_inverter(cfg, cycles)
    levels = sum(kern.solver._kernel_level(i)
                 for i in range(len(kern.solver.levels)))
    for counter in COUNTERS.values():
        counter.launches = 0
    psi = seed
    for _ in range(calls):
        psi = kern(zeta, psi_prev=psi)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    want = {k: 0 for k in COUNTERS}
    n = calls * cycles * kernel_levels
    want.update({"K10": n, "K11": n, "K10 rows": n, "K11 rows": n})
    if levels != kernel_levels or launches != want:
        raise AssertionError(f"{name}: {levels} kernel levels, launch "
                             f"counts {launches} != {want}")
    plain = mg_inverter(cfg, cycles, "off")
    ref = seed
    for _ in range(calls):
        ref = plain(zeta, psi_prev=ref)
    finite = bool(torch.isfinite(psi).all())
    if not finite or tuple(psi.shape) != (2, cfg.M, cfg.P):
        raise AssertionError(f"{name}: psi finite={finite}, shape "
                             f"{tuple(psi.shape)}")
    _, d_plain = rel_err(psi, ref)
    psi64 = PackedModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                cfg.P_inv_matrix(),
                                cfg.back_projection_matrix())(zeta.double())
    _, e_kern = rel_err(psi.double(), psi64)
    _, e_plain = rel_err(ref.double(), psi64)
    _, e_seed = rel_err(seed.double(), psi64)
    del psi64, ref, plain
    free_memory()
    floor = 0.5 * cfg.M * float(torch.finfo(torch.float32).eps) / 5.0
    emit("mg_path", path=name, grid=[cfg.M, cfg.P], calls=calls,
         cycles_per_call=cycles, kernel_levels=levels,
         levels=[lvl[0] for lvl in kern.solver.levels], launches=launches,
         psi_rel_diff_vs_plain_mg=d_plain, tol=TOL["mg_psi"],
         float32_floor_estimate=floor,
         psi_rel_err_vs_float64={"kernel": e_kern, "plain": e_plain,
                                 "seed": e_seed},
         rule="kernel <= max(2 x plain, 1e-6)")
    if not e_kern <= max(2.0 * e_plain, 1e-6):
        raise AssertionError(f"{name}: kernel route's float64 error {e_kern} "
                             f"exceeds max(2 x plain {e_plain}, 1e-6)")
    if not (d_plain <= TOL["mg_psi"] or min(e_kern, e_plain) > TOL["mg_psi"]):
        raise AssertionError(f"{name}: psi differs from the plain MG route "
                             f"by {d_plain} > {TOL['mg_psi']} while a route "
                             "is within it of float64")
    return launches


def run_tendency_path(cfg, state, calls) -> dict:
    """``calls`` K9 calls on ``state`` with the counts set to 0 just before,
    each by the row-streaming kernel (K9 = K9 rows = calls, every other
    count 0); the last held against _tendencies."""
    for counter in COUNTERS.values():
        counter.launches = 0
    for _ in range(calls):
        tend = fused_tendency(cfg, state.zeta, state.psi)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in COUNTERS.items()}
    want = {k: 0 for k in COUNTERS}
    want["K9"] = want["K9 rows"] = calls
    if launches != want:
        raise AssertionError(f"tendency path: launch counts {launches} != "
                             f"{want}")
    a, r = rel_err(tend, fused_tendency_plain(cfg, state.zeta, state.psi))
    emit("tendency_path", grid=[cfg.M, cfg.P], calls=calls,
         launches=launches, max_abs_err=a, rel_err=r, tol=TOL["K9"])
    if not r <= TOL["K9"]:
        raise AssertionError(f"tendency path: rel err {r} > {TOL['K9']}")
    return launches


# --- The stencil lab (K18): tpu_qg_torch.scripts.stencil_lab's protocol.

LAB_VARIANTS = ("base", "legacy", "aligned", "norot", "noslice", "nojac")
LAB_K1_BITS = ("base", "legacy", "aligned")    # K1's instance
LAB_M, LAB_CHUNK, LAB_REPS = 2048, 50, 4


LAB_BODIES = ("base", "norot", "noslice", "nojac")    # the kernel bodies
LAB_BIT_SHAPES = ((2, 2048, 2048), (1, 256, 256))


def phase_lab_kernels(errs, dev) -> None:
    """K18 in every variant against its plain version on the step cases at
    the lab's (2, 2048, 2048), each launch by the row-streaming kernel
    (counted), relative to max|plain| (norot's euler_ab3 carry, its
    tendency, is zero apart from the wind: held against base's carry
    scale); base, legacy and aligned bitwise K1. Then every body on the
    row kernel bitwise the same body on the tile kernel (lab_step_tile),
    every step case, at (2, 2048, 2048) and (1, 256, 256) (the lab's
    configuration, one layer: the two-layer inputs' first layer), the
    one-layer outputs also against plain; and the row instances'
    registers, spills and blocks an SM."""
    cfg = stencil_lab.lab_config(LAB_M)
    zeta, psi, f1, f2 = step_inputs(cfg, dev, np.random.default_rng(SEED + 7))
    for case, over, step in STEP_CASES:
        c = cfg.replace(**over)
        k1 = fused_step(c, zeta, psi, f1, f2, step)
        scale = float(lab_step_plain(c, zeta, psi, f1, f2, step)[1].abs().max())
        for variant in LAB_VARIANTS:
            n = lab_step.rows_launches
            got = lab_step(c, zeta, psi, f1, f2, step, variant)
            if lab_step.rows_launches != n + 1:
                raise AssertionError(f"K18 {variant} {case}: not the "
                                     "row-streaming kernel")
            want = lab_step_plain(c, zeta, psi, f1, f2, step, variant)
            for part, g, w, w1 in zip(("zeta_new", "carry"), got, want, k1):
                errs.record("K18", f"{variant} {case} {part}", g, w,
                            scale=scale if (variant, part) == ("norot",
                                                               "carry")
                            else 0.0)
                if variant in LAB_K1_BITS and not torch.equal(g, w1):
                    raise AssertionError(f"K18 {variant} {case} {part}: not "
                                         "bitwise K1")
    emit("kernels", kernel="K18", bitwise_k1=list(LAB_K1_BITS),
         cases=[case for case, _, _ in STEP_CASES])
    differ = []
    for L, M, P in LAB_BIT_SHAPES:
        c0 = stencil_lab.lab_config(M).replace(n_layers=L)
        if M != LAB_M:
            del zeta, psi, f1, f2
            free_memory()
            zeta, psi, f1, f2 = (t[:L].contiguous() for t in step_inputs(
                stencil_lab.lab_config(M), dev,
                np.random.default_rng(SEED + 9)))
        for case, over, step in STEP_CASES:
            c = c0.replace(**over)
            scale = float(lab_step_plain(c, zeta, psi, f1, f2,
                                         step)[1].abs().max())
            for body in LAB_BODIES:
                rows = lab_step_rows(c, zeta, psi, f1, f2, step, body)
                tile = lab_step_tile(c, zeta, psi, f1, f2, step, body)
                for part, g, t in zip(("zeta_new", "carry"), rows, tile):
                    if not torch.equal(g, t):
                        differ.append(f"{body} L={L} {M}^2 {case} {part}: "
                                      f"{float((g - t).abs().max())}")
                if L == 1:
                    want = lab_step_plain(c, zeta, psi, f1, f2, step, body)
                    for part, g, w in zip(("zeta_new", "carry"), rows, want):
                        errs.record("K18", f"{body} one layer {M}^2 {case} "
                                    f"{part}", g, w, quiet=True,
                                    scale=scale if (body, part) == (
                                        "norot", "carry") else 0.0)
                del rows, tile
    layout = step_rows_launched(LAB_M)
    attrs = {f"{body} L={L}": lab_rows_attributes(L, body, layout,
                                                   dev.index or 0)
             for L in (1, 2) for body in LAB_BODIES}
    emit("kernels", kernel="K18", bitwise_tile_kernel=not differ,
         differ=differ, bodies=list(LAB_BODIES),
         shapes=[list(sh) for sh in LAB_BIT_SHAPES],
         cases=[case for case, _, _ in STEP_CASES],
         rows_layout=k1_layout_name(layout), rows_attributes=attrs)
    if differ:
        raise AssertionError(f"K18 rows not bitwise the tile kernel: "
                             f"{differ}")
    del zeta, psi, f1, f2
    free_memory()


def lab_plain_run(cfg, state, steps: int, variant: str) -> State:
    """``steps`` plain lab steps from ``state`` with psi held fixed (the
    lab's chunk, tpu_qg_torch.scripts.stencil_lab.run_chunk)."""
    for _ in range(steps):
        zeta_new, carry = lab_step_plain(cfg, state.zeta, state.psi, state.f1,
                                         state.f2, state.step, variant)
        state = State(zeta_new, state.psi, carry, state.f1, state.step + 1)
    return state


def run_lab_path(dev) -> tuple[dict, dict]:
    """The lab's protocol through its own function (run_lab) at 2048^2,
    chunk 50, reps 4, all six variants, the counts set to 0 just before and
    read just after: K18 = K18 rows = 6 x 50 x 5, every other count 0. Each variant's
    final zeta (250 steps, psi fixed) against a loop of its plain version
    from the same state within TOL["slice_zeta"], else both against a
    float64 loop (kernel <= 2 x plain). Returns (counts, the lab's jobs)."""
    steps = LAB_CHUNK * (1 + LAB_REPS)
    reset_counts()
    jobs, finals = stencil_lab.run_lab(LAB_M, LAB_CHUNK, LAB_REPS,
                                       LAB_VARIANTS, dev)
    torch.cuda.synchronize()
    launches = counts()
    want = {k: 0 for k in COUNTERS}
    want["K18"] = want["K18 rows"] = len(LAB_VARIANTS) * steps
    if launches != want:
        raise AssertionError(f"stencil lab: launch counts {launches} != "
                             f"{want}")
    cfg = stencil_lab.lab_config(LAB_M)
    state0 = init_state(cfg, dev, seed=stencil_lab.SEED)
    checks = {}
    for variant in LAB_VARIANTS:
        out = finals.pop(variant)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (out.zeta, out.f1, out.f2))
        if (not finite or out.step != steps
                or tuple(out.zeta.shape) != (2, LAB_M, LAB_M)):
            raise AssertionError(f"stencil lab {variant}: finite={finite}, "
                                 f"step {out.step}, shape "
                                 f"{tuple(out.zeta.shape)}")
        ref = lab_plain_run(cfg, state0, steps, variant)
        _, dz = rel_err(out.zeta, ref.zeta)
        checks[variant] = {"zeta_rel_diff_vs_plain": dz}
        if dz > TOL["slice_zeta"]:
            f64 = lab_plain_run(cfg, state0._replace(**{
                k: getattr(state0, k).double()
                for k in ("zeta", "psi", "f1", "f2")}), steps, variant)
            _, e_kern = rel_err(out.zeta.double(), f64.zeta)
            _, e_plain = rel_err(ref.zeta.double(), f64.zeta)
            checks[variant]["float64_adjudication"] = dict(
                zeta_rel_err_kernel=e_kern, zeta_rel_err_plain=e_plain,
                rule="kernel <= 2 x plain")
            if not e_kern <= 2.0 * e_plain:
                raise AssertionError(f"stencil lab {variant}: zeta differs "
                                     f"from the plain loop by {dz} and its "
                                     f"float64 error {e_kern} exceeds twice "
                                     f"the plain loop's {e_plain}")
        del out, ref
    emit("lab_path", grid=[LAB_M, LAB_M], chunk=LAB_CHUNK, reps=LAB_REPS,
         steps_per_variant=steps, launches=launches,
         tol_zeta=TOL["slice_zeta"], checks=checks, jobs=jobs)
    free_memory()
    return launches, jobs


def time_lab(dev, card, jobs) -> dict:
    """CUDA-event ms per launch of K1 and each K18 variant (the row kernel,
    as lab_step routes it) and each body on the tile kernel, on the lab's
    (2, 2048, 2048) inputs, host-launched and replayed from a CUDA graph
    (the device's time where the host's launch cost nears the kernel's), in
    turns (in order, then in reverse), each variant beside its plain
    version; the lab path's own ms per step (host clock, best of its reps)
    beside. Returns K18's row fields."""
    cfg = stencil_lab.lab_config(LAB_M)
    zeta, psi, f1, f2 = step_inputs(cfg, dev, np.random.default_rng(SEED + 8))
    calls = {"K1": lambda: fused_step(cfg, zeta, psi, f1, f2, 5)}
    for variant in LAB_VARIANTS:
        calls[variant] = lambda v=variant: lab_step(cfg, zeta, psi, f1, f2, 5,
                                                    v)
    for body in LAB_BODIES:
        calls[f"{body} (tile)"] = lambda b=body: lab_step_tile(
            cfg, zeta, psi, f1, f2, 5, b)
    runs = {k: [] for k in calls}
    graph_runs = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        runs[k].append(time_ms(calls[k], 50, warmup=5))
        graph_runs[k].append(graph_ms(calls[k], 20))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    graph = {k: sum(v) / len(v) for k, v in graph_runs.items()}
    plain = {v: time_ms(lambda v=v: lab_step_plain(cfg, zeta, psi, f1, f2, 5,
                                                   v), 10)
             for v in LAB_VARIANTS}
    lab_ms = {v: jobs[v]["ms_per_iter"] for v in LAB_VARIANTS}
    bound_ms = bound("K18", LAB_M, LAB_M)[0]
    emit("timing", card=card, path="stencil lab", grid=[LAB_M, LAB_M],
         launch_ms=ms, launch_ms_runs=runs, graph_ms=graph,
         graph_ms_runs=graph_runs, plain_ms=plain, bound_ms=bound_ms,
         lab_ms_per_iter=lab_ms,
         vs_base={v: ms[v] / ms["base"] for v in LAB_VARIANTS},
         vs_base_graph={v: graph[v] / graph["base"] for v in LAB_VARIANTS},
         first_call_s={v: jobs[v]["first_call_s"] for v in LAB_VARIANTS})
    del zeta, psi, f1, f2
    free_memory()
    return {"ms": ms["base"], "plain_ms": plain["base"],
            "variants_ms": {v: ms[v] for v in LAB_VARIANTS},
            "tile_ms": {b: ms[f"{b} (tile)"] for b in LAB_BODIES},
            "graph_ms": graph,
            "variants_plain_ms": plain, "k1_ms_same_turns": ms["K1"],
            "lab_ms_per_iter": lab_ms}


# --- The mesh: the halo stepper on a one-rank NCCL mesh and on four gloo
# ranks sharing the card.

PG_TIMEOUT_S = 300         # a collective that waits longer has lost a rank
SPAWN_TIMEOUT_S = 420      # the four-rank phase as a whole


def counts() -> dict:
    return {k: c.launches for k, c in COUNTERS.items()}


def reset_counts() -> None:
    for counter in COUNTERS.values():
        counter.launches = 0


def zeta_vs_single_device(name, cfg, dev, out_zeta, state0, steps, tol):
    """Relative difference of a mesh run's gathered zeta from the
    single-device route of the same config from the same state; past
    ``tol``, both held against a float64 single-device run (the mesh run no
    worse than 2 x the single-device route). Returns the emitted fields."""
    ref = run_model(cfg, save_results=False, n_steps=steps, device=dev,
                    state=state0, verbose=False)
    _, dz = rel_err(out_zeta, ref.zeta)
    fields = dict(zeta_rel_diff_vs_single_device=dz, tol_zeta=tol)
    if dz <= tol:
        return fields
    del ref
    free_memory()
    f64 = run_model(cfg.replace(dtype="float64", fft_impl="xla",
                                use_pallas=False),
                    save_results=False, n_steps=steps, device=dev,
                    state=state0._replace(**{
                        k: getattr(state0, k).double()
                        for k in ("zeta", "psi", "f1", "f2")}),
                    verbose=False)
    ref = run_model(cfg, save_results=False, n_steps=steps, device=dev,
                    state=state0, verbose=False)
    _, e_mesh = rel_err(out_zeta.double(), f64.zeta)
    _, e_single = rel_err(ref.zeta.double(), f64.zeta)
    fields["float64_adjudication"] = dict(
        zeta_rel_err_mesh=e_mesh, zeta_rel_err_single_device=e_single,
        rule="mesh <= 2 x single device")
    if not e_mesh <= 2.0 * e_single:
        raise AssertionError(f"{name}: zeta differs from the single-device "
                             f"route by {dz} and its float64 error {e_mesh} "
                             f"exceeds twice the route's {e_single}")
    return fields


def run_mesh_slice(name, cfg, mesh, dev, steps, expect, route) -> dict:
    """``steps`` steps through run_model on ``mesh`` with the launch counts
    set to 0 just before and read just after; zeta against the single-device
    route (TOL["mesh1_zeta"], the same arithmetic). Returns the counts."""
    got_route = make_halo_run_fn(cfg, mesh).route
    if got_route != route:
        raise AssertionError(f"{name}: route {got_route} != {route}")
    state0 = init_state(cfg, dev)
    reset_counts()
    out = run_model(cfg, save_results=False, n_steps=steps, state=state0,
                    verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    launches = counts()
    want = {k: expect.get(k, 0) for k in COUNTERS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    out = gather_state(out, mesh, ("zeta", "psi"))
    finite = bool(torch.isfinite(out.zeta).all() and
                  torch.isfinite(out.psi).all())
    if not finite or tuple(out.zeta.shape) != (2, cfg.M, cfg.P):
        raise AssertionError(f"{name}: final state finite={finite} shape "
                             f"{tuple(out.zeta.shape)}")
    fields = zeta_vs_single_device(name, cfg, dev, out.zeta, state0, steps,
                                   TOL["mesh1_zeta"])
    emit("mesh_slice", preset=name, mesh=list(mesh.shape), ranks=mesh.size,
         backend=mesh.backend, route=route, steps=steps, launches=launches,
         **fields)
    return launches


GSPMD_STEPS = 20          # the one-rank gspmd slice


def gspmd_vs_generic(name, cfg, dev, full, state0, steps) -> dict:
    """A gspmd run's gathered zeta and psi against the single-device
    per-mode step (make_step_fn(cfg, batched_fft=False), the step the
    route runs) from the same state on the card: zeta within
    TOL["gspmd_zeta"], psi within TOL["gspmd_psi"] of max|ref| (the dry
    run's gates, __graft_entry__.py:82-88)."""
    step = make_step_fn(cfg, batched_fft=False)
    ref = state0
    for _ in range(steps):
        ref = step(ref)
    _, dz = rel_err(full.zeta, ref.zeta)
    _, dp = rel_err(full.psi, ref.psi)
    del ref
    free_memory()
    if not (dz <= TOL["gspmd_zeta"] and dp <= TOL["gspmd_psi"]):
        raise AssertionError(f"{name}: zeta {dz} / psi {dp} from the "
                             f"single-device per-mode step")
    return dict(zeta_rel_diff_vs_per_mode_step=dz,
                psi_rel_diff_vs_per_mode_step=dp,
                tol_zeta=TOL["gspmd_zeta"], tol_psi=TOL["gspmd_psi"])


def gspmd_step_comms(cfg, mesh, local) -> dict:
    """The collectives of one gspmd step from this rank's blocks ``local``:
    CommDebugMode's count by op, and the bytes this rank sends, by kind
    (ring shifts of the rolls' slabs; the gathers of the per-mode solve,
    (n - 1) blocks each). A collective: call on every rank."""
    from unittest import mock

    from torch.distributed.tensor.debug import CommDebugMode

    step = gspmd.make_sharded_step_fn(cfg, mesh)
    state = gspmd.from_blocks(local, mesh)
    sent = {"ring_shift": 0, "all_gather_blocks": 0, "ring_shifts": 0,
            "gathers": 0}
    real_shift, real_gather = gspmd.ring_shift, gspmd.all_gather_blocks

    def shift(t, group, index, size, s, **kwargs):
        if size > 1:
            sent["ring_shift"] += t.numel() * t.element_size()
            sent["ring_shifts"] += 1
        return real_shift(t, group, index, size, s, **kwargs)

    def gather(t, m):
        if m.size > 1:
            sent["all_gather_blocks"] += (m.size - 1) * t.numel() \
                * t.element_size()
            sent["gathers"] += 1
        return real_gather(t, m)

    with CommDebugMode() as comm, \
            mock.patch.object(gspmd, "ring_shift", shift), \
            mock.patch.object(gspmd, "all_gather_blocks", gather):
        step(state)
    torch.cuda.synchronize()
    return {"by_op": {str(k): v for k, v in comm.get_comm_counts().items()},
            "bytes_sent_by_rank": sent}


def run_gspmd_slice(name, cfg, mesh, dev, card, steps) -> dict:
    """``steps`` steps through run_model(parallel_impl="gspmd") on the
    one-rank ``mesh``, the counts set to 0 just before and read just after
    (every count 0: the route launches no kernel); zeta and psi against the
    single-device per-mode step; then ms per step of the gspmd and halo
    routes in turns and one step's collectives. Returns the counts."""
    state0 = init_state(cfg, dev)
    reset_counts()
    out = run_model(cfg, save_results=False, n_steps=steps, state=state0,
                    verbose=False, mesh=mesh, parallel_impl="gspmd")
    torch.cuda.synchronize()
    launches = counts()
    if any(launches.values()):
        raise AssertionError(f"{name}: launch counts {launches} != 0")
    full = gather_state(out, mesh, ("zeta", "psi"))
    if not (torch.isfinite(full.zeta).all() and torch.isfinite(full.psi).all()
            and tuple(full.zeta.shape) == (2, cfg.M, cfg.P)):
        raise AssertionError(f"{name}: final state not finite or shaped "
                             f"{tuple(full.zeta.shape)}")
    fields = gspmd_vs_generic(name, cfg, dev, full, state0, steps)
    emit("mesh_slice", preset=name, mesh=list(mesh.shape), ranks=mesh.size,
         backend=mesh.backend, route="gspmd", steps=steps, launches=launches,
         **fields)
    del out, full
    local = shard_state(state0, mesh)
    runs = {"gspmd": make_gspmd_blocks_run_fn(cfg, mesh),
            "halo": make_halo_run_fn(cfg, mesh)}
    step_ms = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        step_ms[k].append(time_ms(lambda r=runs[k]: r(local, steps), 1,
                                  warmup=1) / steps)
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    emit("timing", path=name, card=card, grid=[cfg.M, cfg.P],
         mesh=list(mesh.shape), backend=mesh.backend, steps_per_run=steps,
         step_ms=mean, step_ms_runs=step_ms,
         routes={k: r.route for k, r in runs.items()},
         gspmd_over_halo=mean["gspmd"] / mean["halo"])
    emit("gspmd_comms", path=name, mesh=list(mesh.shape),
         **gspmd_step_comms(cfg, mesh, local))
    del local, runs, state0
    free_memory()
    return launches


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


MG_MESH_STEPS = 20
MG_CHECK_CYCLES = 10    # the dry run's inversion (__graft_entry__.py:196-210)


def shard_set_bytes(run_dir: str, kind: str, step: int) -> int:
    return sum(os.path.getsize(os.path.join(run_dir, f))
               for f in os.listdir(run_dir)
               if f.startswith(f"{kind}_{step:09d}-shard"))


def plain_mg_run(cfg, state, steps: int, levels) -> State:
    """The multigrid route's plain single-device reference: ``steps`` steps
    of the plain tendencies and time update (fused_step_plain), each
    inverted by MultigridSolver on the level-op chain (use_pallas="off")
    with the distributed solver's ``levels`` (coarse cutoff 64), seeded as
    make_halo_run_fn seeds it: psi_n at the first step, then 2 psi_n -
    psi_{n-1} under mg_extrapolate. Independent of tpu_qg_torch.parallel."""
    solver = MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig),
                             n_cycles=cfg.mg_cycles, coarse_cutoff=64,
                             use_pallas="off")
    if solver.levels != levels:
        raise AssertionError(f"plain MG levels {solver.levels} != the "
                             f"distributed solver's {levels}")
    p_back = np.asarray(cfg.back_projection_matrix(), np.float64)
    q, b, bi = (torch.as_tensor(m, dtype=state.zeta.dtype,
                                device=state.zeta.device)
                for m in (np.asarray(cfg.P_inv_matrix(), np.float64), p_back,
                          np.linalg.inv(p_back)))
    prev = None
    for _ in range(steps):
        zeta_new, carry = fused_step_plain(cfg, state.zeta, state.psi,
                                           state.f1, state.f2, state.step)
        seed = (state.psi if prev is None or not cfg.mg_extrapolate
                else 2.0 * state.psi - prev)
        modes = solver(torch.einsum("ab,bmp->amp", q, zeta_new),
                       x0=torch.einsum("ab,bmp->amp", bi, seed))
        prev, state = state.psi, _next_state(
            cfg, state, zeta_new, torch.einsum("ab,bmp->amp", b, modes),
            carry)
    return state


def mg_zeta_checks(name, cfg, dev, out_zeta, state0, steps, levels) -> dict:
    """A multigrid mesh run's gathered zeta against (1) the plain
    single-device MG reference of the same steps (plain_mg_run, float32:
    the same algorithm, within TOL["slice_zeta"]) and (2) the single-device
    spectral route: within TOL["slice_zeta"], or else the float64 rule for
    an algorithm whose lag is its own: the mesh run's error against a
    float64 spectral run no more than twice the float64 MG reference's
    distance from it. Two V-cycles a step lag the exact inversion by more
    than 1e-4 of zeta in 20 steps from a grid-noise state at 8192^2, in
    float64 too, and so does tpu_qg's route (PERF.md, PR 25). Returns the
    emitted fields."""
    ref = plain_mg_run(cfg, state0, steps, levels)
    _, d_plain = rel_err(out_zeta, ref.zeta)
    del ref
    free_memory()
    if not d_plain <= TOL["slice_zeta"]:
        raise AssertionError(f"{name}: zeta differs from the plain "
                             f"single-device MG reference by {d_plain}")
    spec = run_model(cfg, save_results=False, n_steps=steps, device=dev,
                     state=state0, verbose=False)
    _, d_spec = rel_err(out_zeta, spec.zeta)
    del spec
    free_memory()
    fields = dict(zeta_rel_diff_vs_plain_mg=d_plain,
                  zeta_rel_diff_vs_single_device=d_spec,
                  tol_zeta=TOL["slice_zeta"])
    if d_spec <= TOL["slice_zeta"]:
        return fields
    state64 = state0._replace(**{k: getattr(state0, k).double()
                                 for k in ("zeta", "psi", "f1", "f2")})
    spec64 = run_model(cfg.replace(dtype="float64", fft_impl="xla",
                                   use_pallas=False),
                       save_results=False, n_steps=steps, device=dev,
                       state=state64, verbose=False).zeta
    free_memory()
    mg64 = plain_mg_run(cfg.replace(dtype="float64"), state64, steps,
                        levels).zeta
    del state64
    _, e_mesh = rel_err(out_zeta.double(), spec64)
    _, e_alg = rel_err(mg64, spec64)
    del spec64, mg64
    free_memory()
    fields["float64_adjudication"] = dict(
        zeta_rel_err_mesh=e_mesh, zeta_rel_diff_mg_float64=e_alg,
        rule="mesh <= 2 x the float64 MG reference's distance from the "
             "float64 spectral run")
    if not e_mesh <= 2.0 * e_alg:
        raise AssertionError(f"{name}: zeta differs from the single-device "
                             f"route by {d_spec}; its float64 error {e_mesh} "
                             f"exceeds twice the float64 MG reference's "
                             f"{e_alg}")
    return fields


def check_mg_inversion(name, cfg, mesh, zeta) -> dict:
    """A MG_CHECK_CYCLES-cycle DistributedMultigridInverter of the one-rank
    mesh's ``zeta`` (cold) against the spectral inversion (the
    single-device route's kernels): within TOL["mg_psi"], else both against
    a float64 inversion (MG no worse than 2 x spectral: on a grid-noise
    state every float32 inversion sits near eps n / 5 of max|psi|, ~1e-4 at
    8192^2, see run_mg_path). Returns the emitted fields."""
    inv = DistributedMultigridInverter(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), mesh, n_cycles=MG_CHECK_CYCLES)
    psi_mg = inv(zeta)
    psi_sp = inverter(cfg)(zeta)
    _, d = rel_err(psi_mg, psi_sp)
    fields = dict(cycles=MG_CHECK_CYCLES, psi_rel_diff_vs_spectral=d,
                  tol_psi=TOL["mg_psi"])
    if d <= TOL["mg_psi"]:
        return fields
    psi64 = PackedModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                cfg.P_inv_matrix(),
                                cfg.back_projection_matrix())(zeta.double())
    _, e_mg = rel_err(psi_mg.double(), psi64)
    _, e_sp = rel_err(psi_sp.double(), psi64)
    fields["float64_adjudication"] = dict(
        psi_rel_err_mg=e_mg, psi_rel_err_spectral=e_sp,
        rule="mg <= 2 x spectral")
    del psi64
    if not e_mg <= 2.0 * e_sp:
        raise AssertionError(f"{name}: the {MG_CHECK_CYCLES}-cycle MG psi "
                             f"differs from the spectral inversion by {d} "
                             f"and its float64 error {e_mg} exceeds twice "
                             f"the spectral one's {e_sp}")
    return fields


def run_mg_mesh_slice(name, cfg, mesh, dev, card) -> dict:
    """pod-8192-mg on the one-rank mesh: MG_MESH_STEPS steps through
    run_model into a temporary run_dir under checkpoint_mode="auto" (shard
    files at 8192^2), snapshots every 10 steps and a checkpoint at the end,
    the launch
    counts set to 0 just before and read just after (every count 0: the
    route runs the generic tendencies and the MG level ops, as tpu_qg's);
    zeta against the single-device route (TOL["slice_zeta"]); the MG
    inversion check; the shard set read back bit for bit by
    load_checkpoint_sharded and load_checkpoint; then the sharded checkpoint
    write timed (the page cache takes it: no fsync). Returns the counts."""
    route = make_halo_run_fn(cfg, mesh).route
    if route != "generic-mg":
        raise AssertionError(f"{name}: route {route} != generic-mg")
    levels = DistributedMultigridInverter(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), mesh).solver.levels
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_mg_")
    try:
        state0 = init_state(cfg, dev)
        reset_counts()
        t0 = time.perf_counter()
        out = run_model(cfg, run_dir=run_dir, n_steps=MG_MESH_STEPS,
                        sample_interval=10 * cfg.dt, state=state0,
                        verbose=False, mesh=mesh, checkpoint_mode="auto")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        if any(launches.values()):
            raise AssertionError(f"{name}: launch counts {launches}, every "
                                 "count should be 0")
        finite = all(bool(torch.isfinite(getattr(out, k)).all())
                     for k in ("zeta", "psi", "f1", "f2"))
        if (not finite or tuple(out.zeta.shape) != (2, cfg.M, cfg.P)
                or out.step != MG_MESH_STEPS):
            raise AssertionError(f"{name}: final state finite={finite} shape "
                                 f"{tuple(out.zeta.shape)} step {out.step}")
        fields = mg_zeta_checks(name, cfg, dev, out.zeta, state0,
                                MG_MESH_STEPS, levels)
        del state0
        free_memory()
        files = sorted(os.listdir(run_dir))
        want_files = sorted(
            ["metadata.json"] + [f"{kind}_{step:09d}-shard00000.{ext}"
                                 for kind, step in (
                                     ("snap", 10), ("snap", MG_MESH_STEPS),
                                     ("checkpoint", MG_MESH_STEPS))
                                 for ext in ("npz", "index.json")])
        if files != want_files:
            raise AssertionError(f"{name}: run_dir holds {files}, not "
                                 f"{want_files}")
        reader = RunReader(run_dir)
        names = ("zeta", "psi", "f1", "f2")
        back = reader.load_checkpoint_sharded(mesh)
        same_blocks = back.step == out.step and all(
            torch.equal(getattr(back, k), getattr(out, k)) for k in names)
        del back
        whole = reader.load_checkpoint(device=dev)
        full = gather_state(out, mesh)
        same_whole = whole.step == out.step and all(
            torch.equal(getattr(whole, k), getattr(full, k)) for k in names)
        del whole, full
        free_memory()
        if not (same_blocks and same_whole):
            raise AssertionError(f"{name}: the shard set reads back "
                                 f"blocks={same_blocks} whole={same_whole}")
        inversion = check_mg_inversion(name, cfg, mesh, out.zeta)
        free_memory()
        writer = RunWriter(run_dir, cfg, write_metadata=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer.write_checkpoint_sharded(out, mesh)
        write_s = time.perf_counter() - t0
        nbytes = shard_set_bytes(run_dir, "checkpoint", out.step)
        emit("mesh_slice", card=card, preset=name, mesh=list(mesh.shape),
             ranks=mesh.size, backend=mesh.backend, route=route,
             steps=MG_MESH_STEPS, launches=launches, checkpoint_mode="auto",
             run_model_s=run_s,
             files=files, shard_set_bitwise={"load_checkpoint_sharded":
                                             same_blocks,
                                             "load_checkpoint": same_whole},
             mg_inversion=inversion,
             sharded_checkpoint_write={"s": write_s, "bytes": nbytes,
                                       "GB_per_s": nbytes / write_s / 1e9,
                                       "is": "device-to-host copy and "
                                             "np.savez into the page cache "
                                             "(no fsync), one rank"},
             **fields)
        return launches
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def count_syncs(fn) -> dict:
    """The calls that wait for the device during one call of ``fn``
    (torch.cuda's sync debug mode), by the source line that made each."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    lines = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught
                    if "synchronizing CUDA operation" in str(w.message))
    return dict(lines)


def time_mg_mesh(pod, pod_mg, mesh, dev, card, steps=5) -> dict:
    """ms per step of pod-8192-mg and pod-8192 on the one-rank mesh by CUDA
    events around one run of ``steps`` steps from the state after 3
    steps, in turns (in order, then in reverse), and host enqueue ms per
    step beside each (one step into an idle queue, 3 times), with the
    calls that wait for the device in one step."""
    model = QGModel(pod, dev)
    local = shard_state(model.run(model.init_state(), 3), mesh)
    del model
    runs = {"pod-8192-mg": make_halo_run_fn(pod_mg, mesh),
            "pod-8192": make_halo_run_fn(pod, mesh)}
    step_ms = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        step_ms[k].append(time_ms(lambda r=runs[k]: r(local, steps), 1,
                                  warmup=1) / steps)
    enqueue = {k: host_enqueue(lambda r=r: r(local, 1), 3)
               for k, r in runs.items()}
    syncs = {k: count_syncs(lambda r=r: r(local, 1)) for k, r in runs.items()}
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    fields = dict(card=card, grid=[pod.M, pod.P], mesh=list(mesh.shape),
                  backend=mesh.backend, steps_per_run=steps, step_ms=mean,
                  step_ms_runs=step_ms, host_enqueue_ms_per_step=enqueue,
                  syncs_per_step=syncs,
                  routes={k: r.route for k, r in runs.items()},
                  mg_over_spectral=mean["pod-8192-mg"] / mean["pod-8192"])
    emit("timing", path="pod-8192-mg mesh (1, 1)", **fields)
    del local, runs
    free_memory()
    return fields


def phase_mesh_one_rank(turb, pod, pod_mg, dev, card) -> tuple[dict, dict]:
    """The one-rank NCCL mesh on ``dev``: the three slices, pod-8192-mg's
    (run_mg_mesh_slice) and the gspmd route's (run_gspmd_slice), then ms
    per step of the mesh against the single-device route in turns, at
    2048^2 and 8192^2, and pod-8192-mg's beside pod-8192's
    (time_mg_mesh). Returns (launches by path, ms by
    grid and "multigrid")."""
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = make_mesh((1, 1), device=dev)
        chain = turb.replace(step_chain="on")
        launches = {}
        for name, cfg, steps, expect, route in (
                ("turbulence-2048 mesh (1, 1)", turb, 100,
                 {"K12": 100, "K12 rows": 100, "K2": 200,
                  "K2 factored": 200, "K3": 100, "K3 cluster": 100},
                 "fused"),
                ("pod-8192 mesh (1, 1)", pod, 20,
                 {"K12": 20, "K12 rows": 20, "K2": 40, "K2 factored": 40,
                  "K4": 20, "K5": 20, "K4 cluster": 20, "K5 cluster": 20},
                 "fused"),
                ("turbulence-2048 step_chain=on mesh (1, 1)", chain, 20,
                 {"K15s": 20, "K15s rows": 20, "K3": 20, "K3 cluster": 20,
                  "K2": 2 * run_chunks(chain, 20),
                  "K2 factored": 2 * run_chunks(chain, 20)}, "chain")):
            launches[name] = run_mesh_slice(name, cfg, mesh, dev, steps,
                                            expect, route)
            free_memory()
        name = "pod-8192-mg mesh (1, 1)"
        launches[name] = run_mg_mesh_slice(name, pod_mg, mesh, dev, card)
        free_memory()
        name = "turbulence-2048 gspmd (1, 1)"
        launches[name] = run_gspmd_slice(name, turb, mesh, dev, card,
                                         GSPMD_STEPS)
        ms = {}
        for cfg, steps in ((turb, 100), (pod, 20)):
            model = QGModel(cfg, dev)
            run = make_halo_run_fn(cfg, mesh)
            state0 = model.run(model.init_state(), 3)
            local = shard_state(state0, mesh)
            calls = {"single_device": lambda: model.run(state0, steps),
                     "mesh_1x1": lambda: run(local, steps)}
            runs = {k: [] for k in calls}
            for k in list(calls) + list(calls)[::-1]:
                runs[k].append(time_ms(calls[k], 1, warmup=1) / steps)
            ms[cfg.M] = {k: sum(v) / len(v) for k, v in runs.items()}
            emit("timing", card=card, grid=[cfg.M, cfg.P], mesh=[1, 1],
                 backend="nccl", steps_per_run=steps, step_ms=ms[cfg.M],
                 step_ms_runs=runs, routes={"single_device": model.route,
                                            "mesh_1x1": run.route},
                 mesh_over_single_device=ms[cfg.M]["mesh_1x1"]
                 / ms[cfg.M]["single_device"])
            del model, run, state0, local, calls
            free_memory()
        ms["multigrid"] = time_mg_mesh(pod, pod_mg, mesh, dev, card)
        return launches, ms
    finally:
        dist.destroy_process_group()


def run_k7_path(cfg, dev, calls: int) -> dict:
    """``calls`` inversions of ``cfg``'s initial zeta through
    PackedModalInverterKernels with pair_stream pinned on, the counts set to
    0 just before and read just after (K2 = 2 calls by its factored kernel,
    or at a mixed P by its mixed-radix form, "K2 mixed" = K2; K7 = calls,
    each K7 launch by K3's cluster kernel, "K7 cluster" = K7, at a mixed M
    by its mixed cluster kernel, "K7 mixed" = K7; K3 = 0); psi against a
    float64 inversion, no worse than 2 x the plain versions' route."""
    inv = inverter(cfg)
    inv.pair_stream = True
    zeta = init_state(cfg, dev).zeta
    reset_counts()
    for _ in range(calls):
        psi = inv(zeta)
    torch.cuda.synchronize()
    launches = counts()
    want = {k: 0 for k in COUNTERS}
    want.update({"K2": 2 * calls, "K7": calls, "K7 cluster": calls,
                 "K2 mixed" if dft_kernels._mixed(cfg.P) else "K2 factored":
                 2 * calls})
    if dft_kernels._mixed(cfg.M):
        want["K7 mixed"] = calls
    if launches != want:
        raise AssertionError(f"K7 path at {cfg.M}^2: launch counts "
                             f"{launches} != {want}")
    consts = inv._sym_consts
    plain = y_dft_plain(stream_pair_symbols_plain(y_dft_plain(zeta, False),
                                                  consts), True)
    psi64 = PackedModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                cfg.P_inv_matrix(),
                                cfg.back_projection_matrix())(zeta.double())
    _, e_kern = rel_err(psi.double(), psi64)
    _, e_plain = rel_err(plain.double(), psi64)
    emit("k7_path", grid=[cfg.M, cfg.P], calls=calls, launches=launches,
         psi_rel_err_vs_float64={"kernel": e_kern, "plain": e_plain},
         rule="kernel <= 2 x plain")
    del psi64, plain, psi, zeta
    free_memory()
    if not e_kern <= 2.0 * e_plain:
        raise AssertionError(f"K7 path at {cfg.M}^2: psi float64 error "
                             f"{e_kern} exceeds twice the plain route's "
                             f"{e_plain}")
    return launches


FOUR_RANK_SLICES = (
    # name, preset, overrides, mesh, steps, expected counts on every rank,
    # route
    ("turbulence-2048 mesh (4, 1)", "turbulence-2048", {}, (4, 1), 10,
     {"K12": 10, "K12 rows": 10, "K2": 20, "K2 factored": 20, "K14": 10,
      "K14 cluster": 10}, "fused"),
    ("turbulence-2048 step_chain=on mesh (4, 1)", "turbulence-2048",
     {"step_chain": "on"},
     (4, 1), 10, {"K15s": 10, "K15s rows": 10, "K14": 10,
                  "K14 cluster": 10, "K2": 2, "K2 factored": 2}, "chain"),
    ("turbulence-2048 mesh (2, 2)", "turbulence-2048", {}, (2, 2), 10,
     {"K12": 10, "K12 rows": 10, "K2": 20, "K2 factored": 20, "K13": 10,
      "K13 cluster": 10}, "fused-2d"),
    ("pod-8192 mesh (4, 1)", "pod-8192", {}, (4, 1), 5,
     {"K12": 5, "K12 rows": 5, "K2": 10, "K2 factored": 10, "K13": 5,
      "K13 cluster": 5}, "fused"),
    # The mixed extents: turbulence-2048's configuration with M and P
    # changed. At 3072^2 the paired gate is off (the companion scheme, K13
    # on (2, 3072, 768), N2 = 24); at 1536 x 2048 it is on (K14 on (2,
    # 1536, 512), N2 = 12); every launch by the block kernel's mixed
    # instance, K2 by its mixed-radix form at P = 3072.
    ("turbulence-2048 at 3072^2 mesh (4, 1)", "turbulence-2048",
     {"M": 3072, "P": 3072}, (4, 1), 10,
     {"K12": 10, "K12 rows": 10, "K2": 20, "K2 mixed": 20, "K13": 10,
      "K13 cluster": 10, "K13 mixed": 10}, "fused"),
    ("turbulence-2048 at 1536x2048 mesh (4, 1)", "turbulence-2048",
     {"M": 1536, "P": 2048}, (4, 1), 10,
     {"K12": 10, "K12 rows": 10, "K2": 20, "K2 factored": 20, "K14": 10,
      "K14 cluster": 10, "K14 mixed": 10}, "fused"),
    # The distributed multigrid on a 2-D mesh, a shape the paired spectral
    # route cannot take: the generic tendencies and the MG level ops, no
    # kernel.
    ("pod-8192-mg at 2048^2 mesh (2, 2)", "pod-8192-mg",
     {"M": 2048, "P": 2048}, (2, 2), 10, {}, "generic-mg"),
    # The gspmd route (run_model(parallel_impl="gspmd")): the per-mode step
    # on DTensors, no kernel; timed beside the halo route in turns.
    ("turbulence-2048 gspmd mesh (2, 2)", "turbulence-2048", {}, (2, 2), 5,
     {}, "gspmd"),
)
# The four-rank slices that run_model saves: each rank writes its shard
# files ("auto" at 2048^2 on a mesh), and rank 0 checks that
# RunReader.load_checkpoint assembles the gathered state bit for bit.
SHARDED_SLICES = ("pod-8192-mg at 2048^2 mesh (2, 2)",)


def mesh_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One of the four ranks sharing cuda:0 on gloo: every slice of
    FOUR_RANK_SLICES through run_model with the counts set to 0 just before
    and checked just after on this rank, zeta and psi gathered; rank 0
    holds zeta against the single-device route (a gspmd slice zeta and psi
    against the per-mode step); then ms per step of the same steps by the
    slice's run function (host clock, both ends behind a barrier), a gspmd
    slice's in turns with the halo route's, with one step's collectives.
    Rank 0 writes its report to ``out``."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        _build.load()
        report = []
        for row in FOUR_RANK_SLICES:
            name, preset_name, over, shape, steps, expect, route = row
            cfg = preset(preset_name).replace(**over)
            mesh = make_mesh(shape, device=dev, backend="gloo")
            impl = "gspmd" if route == "gspmd" else "halo"
            make_run = (make_gspmd_blocks_run_fn if impl == "gspmd"
                        else make_halo_run_fn)
            got_route = make_run(cfg, mesh).route
            if got_route != route:
                raise AssertionError(f"{name}: route {got_route} != {route}")
            state0 = init_state(cfg, dev)
            sharded = name in SHARDED_SLICES
            run_dir = os.path.join(os.path.dirname(rendezvous),
                                   f"run_{FOUR_RANK_SLICES.index(row)}")
            reset_counts()
            out_state = run_model(cfg, run_dir=run_dir if sharded else None,
                                  save_results=sharded, n_steps=steps,
                                  state=state0, verbose=False, mesh=mesh,
                                  checkpoint_mode="auto",
                                  parallel_impl=impl)
            torch.cuda.synchronize()
            launches = counts()
            want = {k: expect.get(k, 0) for k in COUNTERS}
            if launches != want:
                raise AssertionError(f"{name}: rank {rank} launch counts "
                                     f"{launches} != {want}")
            full = gather_state(out_state, mesh,
                                ("zeta", "psi", "f1", "f2") if sharded
                                else ("zeta", "psi"))
            shard_io = {}
            if sharded and rank == 0:
                files = sorted(os.listdir(run_dir))
                back = RunReader(run_dir).load_checkpoint(device=dev)
                same = back.step == steps and all(
                    torch.equal(getattr(back, k), getattr(full, k))
                    for k in ("zeta", "psi", "f1", "f2"))
                shard_io = dict(files=files, shard_set_bitwise=same)
                if not same or len(files) != 9:
                    raise AssertionError(f"{name}: the shard set {files} "
                                         f"reads back bitwise={same}")
                del back
            local = shard_state(state0, mesh)
            # ms per step by the host clock, both ends behind a barrier; the
            # gspmd route in turns with the halo route.
            runs = {impl: make_run(cfg, mesh)}
            if impl == "gspmd":
                runs["halo"] = make_halo_run_fn(cfg, mesh)
            runs_ms = {k: [] for k in runs}
            order = (["gspmd", "halo", "halo", "gspmd"] if impl == "gspmd"
                     else ["halo"])
            for k in order:
                runs[k](local, 1)                  # allocations warm
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                runs[k](local, steps)
                torch.cuda.synchronize()
                dist.barrier()
                runs_ms[k].append((time.perf_counter() - t0) * 1e3 / steps)
            step_ms = sum(runs_ms[impl]) / len(runs_ms[impl])
            gspmd_fields = {}
            if impl == "gspmd":
                gspmd_fields = dict(
                    halo_step_ms=sum(runs_ms["halo"]) / len(runs_ms["halo"]),
                    step_ms_runs=runs_ms,
                    comms=gspmd_step_comms(cfg, mesh, local))
            if rank == 0:
                finite = bool(torch.isfinite(full.zeta).all()
                              and torch.isfinite(full.psi).all())
                if not finite:
                    raise AssertionError(f"{name}: non-finite state")
                if impl == "gspmd":
                    fields = gspmd_vs_generic(name, cfg, dev, full, state0,
                                              steps)
                elif route == "generic-mg":
                    levels = DistributedMultigridInverter(
                        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
                        cfg.back_projection_matrix(), mesh).solver.levels
                    fields = mg_zeta_checks(name, cfg, dev, full.zeta,
                                            state0, steps, levels)
                else:
                    fields = zeta_vs_single_device(name, cfg, dev, full.zeta,
                                                   state0, steps,
                                                   TOL["slice_zeta"])
                report.append(dict(preset=name, mesh=list(shape), ranks=world,
                                   backend="gloo (host-staged, one card)",
                                   route=route, steps=steps,
                                   launches_per_rank=launches,
                                   step_ms=step_ms, **gspmd_fields,
                                   **shard_io, **fields))
            del state0, out_state, full, local, runs
            free_memory()
            dist.barrier()
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(report, fh)
    finally:
        dist.destroy_process_group()


def phase_mesh_four_ranks(card) -> list:
    """Spawn the four ranks (the kernels are already built: each loads the
    library), join them within SPAWN_TIMEOUT_S, kill any left; a rank that
    fails raises here. Returns rank 0's report."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        out = os.path.join(tmp, "report.json")
        ctx = mp.spawn(mesh_rank, args=(4, os.path.join(tmp, "rendezvous"),
                                        out), nprocs=4, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"four-rank mesh phase still running "
                                       f"after {SPAWN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        with open(out) as fh:
            report = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in report:
        emit("mesh_slice", card=card, **row,
             timing_is="host-staged gloo transport between 4 processes on "
                       "one card: not a scaling result")
    return report


def time_sharded_kernels(turb, pod, dev, card) -> dict:
    """K12, K13, K14, K15's sharded form and K7 per launch beside their plain
    versions, in turns, at the mesh slices' shapes: K12 and K15s on the
    one-rank 2048^2 block (2, 2048, 2048), K13 on the (4, 1) pod-8192
    block (2, 8192, 2048) and the (2, 2) turbulence-2048 block (2, 2048,
    512), K14 on the (4, 1) turbulence-2048 block (2, 2048, 512), K7 on
    (2, 8192, 8192); K13, K14 and K7 also by pair_cols_kernel, twice after
    the turns on the same inputs (whole_columns_ms); on the 2048 blocks
    also the host's enqueue ms a call and the graph-replayed ms; K13, K14
    and K7 at the mixed slices' shapes and at 768 (time_mixed_cols). Each
    entry carries its shape. Then the kernels of a (4, 1) pod-8192 rank
    (time_pod_rank)."""
    rng = np.random.default_rng(SEED + 6)
    out = {}
    zeta, psi, f1, f2 = step_inputs(turb, dev, rng)
    (zt, zb), (pt, pb) = slabs((zeta, psi), 0, turb.M)
    psi_ys = y_dft_plain(psi, False)
    pt_ys, pb_ys = y_dft_plain(pt, False), y_dft_plain(pb, False)
    out.update(time_kernels({
        "K12": (lambda: fused_step_sharded(turb, zeta, psi, f1, f2, 5, zt, zb,
                                           pt, pb),
                lambda: fused_step_sharded_plain(turb, zeta, psi, f1, f2, 5,
                                                 zt, zb, pt, pb), 1),
        "K15s": (lambda: fused_step_yspec_sharded(turb, zeta, psi_ys, f1, f2,
                                                  5, zt, zb, pt_ys, pb_ys),
                 lambda: fused_step_yspec_sharded_plain(
                     turb, zeta, psi_ys, f1, f2, 5, zt, zb, pt_ys, pb_ys), 1)},
        50, 10))
    for k in ("K12", "K15s"):
        out[k]["shape"] = [2, turb.M, turb.P]
    # K12's tile kernel (step_sharded_kernel) on the same block, in turns.
    tile = [time_ms(lambda: fused_step_sharded_tile(
        turb, zeta, psi, f1, f2, 5, zt, zb, pt, pb), 50) for _ in range(2)]
    out["K12"].update(tile_ms=sum(tile) / 2, tile_runs_ms=tile)
    del zeta, psi, f1, f2, psi_ys
    consts = inverter(turb)._sym_consts
    x = torch.as_tensor(rng.standard_normal((2, turb.M, turb.P // 4)),
                        dtype=torch.float32, device=dev)
    idx = strip_pair_order(turb.P // 128)[:4]
    key14 = (tuple(int(i) for i in idx), turb.P // 128)
    xm = torch.as_tensor(rng.standard_normal((2, turb.M, turb.P // 4)),
                         dtype=torch.float32, device=dev)
    out.update(time_kernels({
        "K14": (lambda: paired_x_symbols(x, idx, consts),
                lambda: paired_x_symbols_plain(x, idx, consts), 1),
        "K13 2048": (lambda: x_fwd_symbols_offset(x, xm, consts, 4),
                     lambda: x_fwd_symbols_offset_plain(x, xm, consts, 4),
                     1)}, 100, 20))
    whole = {"K14": lambda: pair_cols_whole_columns(x, x, "paired", key14,
                                                    consts),
             "K13 2048": lambda: pair_cols_whole_columns(
                 x, xm, "offset", (turb.P // 4, 4), consts)}
    routed = {"K14": lambda: paired_x_symbols(x, idx, consts),
              "K13 2048": lambda: x_fwd_symbols_offset(x, xm, consts, 4)}
    for k, fn in whole.items():
        out[k]["shape"] = list(x.shape)
        out[k].update(whole_columns(fn, 100))
        out[k]["host_enqueue_ms"] = host_enqueue(routed[k], 100)
        out[k]["graph_ms"] = graph_ms(routed[k], 100)
    consts = inverter(pod)._sym_consts
    x = torch.as_tensor(rng.standard_normal((2, pod.M, pod.P // 4)),
                        dtype=torch.float32, device=dev)
    xm = torch.as_tensor(rng.standard_normal((2, pod.M, pod.P // 4)),
                         dtype=torch.float32, device=dev)
    out.update(time_kernels({"K13": (
        lambda: x_fwd_symbols_offset(x, xm, consts, 16),
        lambda: x_fwd_symbols_offset_plain(x, xm, consts, 16), 1)}, 20, 5))
    out["K13"]["shape"] = list(x.shape)
    out["K13"].update(whole_columns(lambda: pair_cols_whole_columns(
        x, xm, "offset", (pod.P // 4, 16), consts), 20))
    del x, xm
    free_memory()
    x = torch.as_tensor(rng.standard_normal((2, pod.M, pod.P)),
                        dtype=torch.float32, device=dev)
    out.update(time_kernels({"K7": (
        lambda: stream_pair_symbols(x, consts),
        lambda: stream_pair_symbols_plain(x, consts), 1)}, 10, 3))
    out["K7"]["shape"] = list(x.shape)
    out["K7"].update(whole_columns(lambda: pair_cols_whole_columns(
        x, x, "self", (pod.P,), consts), 10))
    del x
    free_memory()
    out.update(time_mixed_cols(turb, dev, rng))
    for name, t in out.items():
        t["bound_ms"] = bound(name.split()[0], t["shape"][1],
                              t["shape"][2])[0]
    out["K13"]["at_2048"] = out.pop("K13 2048")
    out["pod-8192 (4, 1) rank"] = time_pod_rank(pod, dev, rng)
    emit("timing", card=card, kernel_ms=out, at="the mesh slices' shapes")
    return out


# K13, K14 and K7 where the mixed extents' paths run them, then at a shape
# pair_cols_kernel keeps (768 = 128 * 6): name, table, M, W, the y extent
# P, strip offset or rank, reps.
MIXED_COLS = (("K13 mixed", "offset", 3072, 768, 3072, 6, 50),
              ("K14 mixed", "paired", 1536, 512, 2048, 0, 100),
              ("K7 mixed", "self", 3072, 3072, 3072, 0, 20),
              ("K13 at 768", "offset", 768, 256, 1024, 2, 100),
              ("K14 at 768", "paired", 768, 256, 1024, 0, 100),
              ("K7 at 768", "self", 768, 256, 256, 0, 100))


def time_mixed_cols(turb, dev, rng) -> dict:
    """K13, K14 and K7 at each shape of MIXED_COLS (turb's configuration at
    (M, P)), ms per launch beside the plain version in turns
    (time_kernels), replayed from a CUDA graph (graph_ms, the device time:
    K14's host launch costs about its device time) with the host's enqueue
    ms a call, and beside its yardstick (not its function): one
    torch.fft.fft along x of the own and mirror blocks (K14, K7: of the
    block) then one torch.fft.ifft along x of a block (yardstick_ms,
    yardstick_graph_ms); where the mixed kernels run, also
    pair_cols_kernel twice after the turns (whole_columns_ms) and replayed
    from a graph."""
    out = {}
    for name, kind, M, W, P, at, reps in MIXED_COLS:
        consts = inverter(turb.replace(M=M, P=P))._sym_consts
        x = torch.as_tensor(rng.standard_normal((2, M, W)),
                            dtype=torch.float32, device=dev)
        if kind == "offset":
            xm = torch.as_tensor(rng.standard_normal((2, M, W)),
                                 dtype=torch.float32, device=dev)
            key = (W, at)
            routed = lambda: x_fwd_symbols_offset(x, xm, consts, at)
            plain = lambda: x_fwd_symbols_offset_plain(x, xm, consts, at)
        elif kind == "paired":
            xm, s = x, W // 128
            idx = strip_pair_order(P // 128)[at * s:(at + 1) * s]
            key = (tuple(int(i) for i in idx), P // 128)
            routed = lambda: paired_x_symbols(x, idx, consts)
            plain = lambda: paired_x_symbols_plain(x, idx, consts)
        else:
            xm, key = x, (P,)
            routed = lambda: stream_pair_symbols(x, consts)
            plain = lambda: stream_pair_symbols_plain(x, consts)
        blocks = torch.stack([torch.complex(x[0], x[1]),
                              torch.complex(xm[0], xm[1])]) \
            if kind == "offset" else torch.complex(x[0], x[1])[None]
        yardstick = lambda: torch.fft.ifft(torch.fft.fft(blocks, dim=1)[0],
                                           dim=0)
        out.update(time_kernels({name: (routed, plain, 1)}, reps,
                                max(reps // 10, 3)))
        t = out[name]
        t["shape"] = [2, M, W]
        t["graph_ms"] = graph_ms(routed, reps)
        t["host_enqueue_ms"] = host_enqueue(routed, reps)
        t["yardstick_ms"] = time_ms(yardstick, reps)
        t["yardstick_graph_ms"] = graph_ms(yardstick, reps)
        if "mixed" in name:
            whole = lambda: pair_cols_whole_columns(x, xm, kind, key, consts)
            t.update(whole_columns(whole, reps))
            t["whole_columns_graph_ms"] = graph_ms(whole, reps)
        del x, xm, blocks
        free_memory()
    return out


def host_enqueue(fn, calls: int) -> float:
    """Host ms to enqueue one call of ``fn`` (wrapper and launch) into an
    idle queue: ``calls`` calls after a synchronize, the host clock stopped
    before the device finishes. Where it reaches the kernel's device time,
    time_ms reads the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def whole_columns(fn, reps: int) -> dict:
    """pair_cols_kernel's ms (the kernel K7, K13 and K14 ran before the
    cluster forms took their power-of-two extents), twice."""
    runs = [time_ms(fn, reps) for _ in range(2)]
    return {"whole_columns_ms": sum(runs) / 2, "whole_columns_runs_ms": runs}


def time_pod_rank(pod, dev, rng) -> dict:
    """The kernels of one (4, 1) pod-8192 rank's step at its shapes, ms per
    launch by CUDA events, in turns: K12 on its (2, 2048, 8192) row block
    with its slabs, K2 forward and inverse on the same rows, and K13 on the
    (2, 8192, 2048) column block by the block kernel and by
    pair_cols_kernel; their sums with each K13 kernel."""
    block, ((zt, zb), (pt, pb)), whole, _ = sharded_inputs(pod, dev, rng, 4,
                                                           1)
    del whole
    free_memory()
    z, p, f1, f2 = block
    consts = inverter(pod)._sym_consts
    x = torch.as_tensor(rng.standard_normal((2, pod.M, pod.P // 4)),
                        dtype=torch.float32, device=dev)
    xm = torch.as_tensor(rng.standard_normal((2, pod.M, pod.P // 4)),
                         dtype=torch.float32, device=dev)
    calls = {
        "K12": lambda: fused_step_sharded(pod, z, p, f1, f2, 5, zt, zb, pt,
                                          pb),
        "K2 forward": lambda: y_dft(z, False),
        "K2 inverse": lambda: y_dft(z, True),
        "K13 cluster": lambda: x_fwd_symbols_offset(x, xm, consts, 16),
        "K13 pair_cols_kernel": lambda: pair_cols_whole_columns(
            x, xm, "offset", (pod.P // 4, 16), consts)}
    runs = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        runs[k].append(time_ms(calls[k], 10))
    ms = {k: sum(v) / 2 for k, v in runs.items()}
    rest = ms["K12"] + ms["K2 forward"] + ms["K2 inverse"]
    del block, z, p, f1, f2, x, xm
    free_memory()
    return {"ms": ms, "runs_ms": runs,
            "kernel_sum_ms": rest + ms["K13 cluster"],
            "kernel_sum_with_pair_cols_kernel_ms":
                rest + ms["K13 pair_cols_kernel"],
            "shapes": {"K12": [2, pod.M // 4, pod.P],
                       "K2": [2, pod.M // 4, pod.P],
                       "K13": [2, pod.M, pod.P // 4]}}


def run_chunks(cfg, steps: int) -> int:
    """QGModel.run calls that run_model makes for ``steps`` steps (one per
    one-day sample interval)."""
    return math.ceil(steps / max(int(DAY // cfg.dt), 1))


def run_slice(name, cfg, dev, steps, expect, route) -> dict:
    """``steps`` steps through run_model with every launch count set to 0
    just before and read just after; then the plain route from the same
    psi. Returns the launch counts and the final state."""
    got_route = QGModel(cfg, dev).route
    if got_route != route:
        raise AssertionError(f"{name}: route {got_route} != {route}")
    plain_cfg = cfg.replace(fft_impl="xla", use_pallas=False)
    state0 = init_state(cfg, dev)
    for counter in COUNTERS.values():
        counter.launches = 0
    out = run_model(cfg, save_results=False, n_steps=steps, device=dev,
                    state=state0, verbose=False)
    launches = {k: c.launches for k, c in COUNTERS.items()}
    want = {k: expect.get(k, 0) for k in COUNTERS}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    d = diagnostics(cfg, out)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.zeta, out.psi, out.f1, out.f2))
    if not finite or not d["cfl"] < 1.0:
        raise AssertionError(f"{name}: bad final state: finite={finite} "
                             f"cfl={d['cfl']}")
    if (tuple(out.zeta.shape) != (cfg.n_layers, cfg.M, cfg.P)
            or out.step != steps):
        raise AssertionError(f"{name}: final state has the wrong shape or "
                             "step")
    ref = run_model(plain_cfg, save_results=False, n_steps=steps, device=dev,
                    state=state0, verbose=False)
    _, dz = rel_err(out.zeta, ref.zeta)
    _, dp = rel_err(out.psi, ref.psi)
    fields = dict(preset=name, route=route, steps=out.step,
                  shape=list(out.zeta.shape), launches=launches,
                  finite=finite, cfl=d["cfl"], ke_1=d["ke_1"],
                  max_abs_zeta=d["max_abs_zeta"], zeta_rel_diff_vs_plain=dz,
                  psi_rel_diff_vs_plain=dp, psi_gauge=cfg.poisson_gauge,
                  tol_zeta=TOL["slice_zeta"])
    if dz <= TOL["slice_zeta"]:
        emit("slice", **fields)
        return launches, out
    # The gate failed: hold both routes against a float64 plain run of the
    # same steps instead, and say so.
    del ref
    free_memory()
    f64 = run_model(plain_cfg.replace(dtype="float64"), save_results=False,
                    n_steps=steps, device=dev,
                    state=state0._replace(**{
                        k: getattr(state0, k).double()
                        for k in ("zeta", "psi", "f1", "f2")}),
                    verbose=False)
    ref = run_model(plain_cfg, save_results=False, n_steps=steps, device=dev,
                    state=state0, verbose=False)
    _, e_kern = rel_err(out.zeta.double(), f64.zeta)
    _, e_plain = rel_err(ref.zeta.double(), f64.zeta)
    emit("slice", **fields, float64_adjudication=dict(
        zeta_rel_err_kernel=e_kern, zeta_rel_err_plain=e_plain,
        rule="kernel <= 2 x plain"))
    if not e_kern <= 2.0 * e_plain:
        raise AssertionError(f"{name}: kernel route zeta diff {dz} from the "
                             f"plain route, and its float64 error {e_kern} "
                             f"exceeds twice the plain route's {e_plain}")
    return launches, out


def time_routes(cfgs: dict, dev, steps) -> tuple[dict, object, dict]:
    """ms per step of each route by CUDA events around one QGModel.run of
    ``steps`` steps from the state after 3 steps (past the Euler start),
    the routes in turns: in order, then in reverse. The chain's run
    includes its two K2 conversions."""
    models = {name: QGModel(c, dev) for name, c in cfgs.items()}
    state0 = models["default"].run(models["default"].init_state(), 3)
    names = list(models)
    step_ms = {name: [] for name in names}
    for name in names + names[::-1]:
        step_ms[name].append(time_ms(
            lambda m=models[name]: m.run(state0, steps), 1, warmup=1) / steps)
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    cfg = cfgs["default"]
    return ({"step_ms": mean, "step_ms_runs": step_ms,
             "routes": {n: m.route for n, m in models.items()},
             "gridpoint_steps_per_s": {k: cfg.M * cfg.P / (v * 1e-3)
                                       for k, v in mean.items()}},
            state0, models)


def inversions_vs_float64(n: int, dev, reps: int) -> dict:
    """inv_f64_check's inversion at n^2 on the card, each float32 tier's
    error against float64; the matmul tier again with TF32 allowed; ms per
    inversion of each tier in turns (in order, then in reverse)."""
    cfg = inv_f64_check.check_config(n, n)
    zeta = init_state(cfg, dev, seed=inv_f64_check.SEED).zeta
    tiers = inv_f64_check.inverters(cfg)
    errs = inv_f64_check.errors_vs_float64(tiers, zeta)
    free_memory()
    psi_mm = tiers["matmul"](zeta)
    w = torch.complex(zeta[0, :1024, :1024], zeta[1, :1024, :1024])
    probe = w @ w
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        psi_tf32 = tiers["matmul"](zeta)
        probe_tf32 = w @ w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    names = list(tiers)
    runs = {k: [] for k in names}
    for k in names + names[::-1]:
        runs[k].append(time_ms(lambda inv=tiers[k]: inv(zeta), reps))
    return {"err_vs_f64": errs,
            "matmul_tf32_bitwise": torch.equal(psi_mm, psi_tf32),
            "tf32_moves_a_plain_complex64_matmul":
            not torch.equal(probe, probe_tf32),
            "inversion_ms": {k: sum(v) / len(v) for k, v in runs.items()},
            "inversion_runs_ms": runs}


def phase_accuracy(dev, card: str, turb, pod) -> None:
    """Phase 6 (see the module docstring): the float64 accuracy checks and
    the matmul tier's times, on turb's and pod's grids (2048^2, 8192^2).
    Raises after every line if a gate failed."""
    failed = []
    plain = dict(fft_impl="xla", use_pallas=False)
    for name, cfg, steps, reps in (("turbulence-2048", turb, 100, 50),
                                   ("pod-8192", pod, 20, 10)):
        n = cfg.M
        inv = inversions_vs_float64(n, dev, reps)
        free_memory()
        routes, _, _ = time_routes(
            {"default": cfg, "matmul": cfg.replace(fft_impl="matmul"),
             "plain": cfg.replace(**plain)}, dev, steps)
        free_memory()
        step = step_f64_check.step_f64_check(n, n, dev)
        free_memory()
        errs = inv["err_vs_f64"]
        limit = 2.0 * errs["torch_fft"]
        emit("accuracy", card=card, check="inversion and steps vs float64",
             grid=[n, n], **inv, inversion_limit=limit,
             rule="each tier within 2 x torch_fft's error vs float64",
             step_preset=name, step_ms=routes["step_ms"],
             step_ms_runs=routes["step_ms_runs"],
             step_routes=routes["routes"], step_f64_check=step)
        for tier in ("matmul", "kernels"):
            if not errs[tier] <= limit:
                failed.append(f"{n}^2 {tier} inversion error {errs[tier]} "
                              f"> 2 x torch_fft's {errs['torch_fft']}")
        if not inv["matmul_tf32_bitwise"]:
            failed.append(f"{n}^2 matmul inversion moved with TF32 allowed")
        if not step["passed"]:
            failed.append(f"{n}^2 step_f64_check: {step['tier_passed']}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "allclose.json")
        rc = allclose.main(["--device", str(dev), "--M",
                            str(ACCURACY["allclose_M"]), "--steps",
                            str(ACCURACY["allclose_steps"]), "--check-every",
                            str(ACCURACY["allclose_steps"]), "--out", out])
        with open(out) as f:
            verdict = json.load(f)
    emit("accuracy", card=card, check="allclose vs the float64 twin",
         rc=rc, **verdict)
    if rc != 0:
        failed.append(f"allclose: {verdict}")
    M, steps, chunk = (ACCURACY[k] for k in ("drift_M", "drift_steps",
                                              "drift_chunk"))
    drift = accuracy_drift.accuracy_drift(M, steps, chunk,
                                          ["torch_fft", "kernels"], dev)
    spectra = [np.asarray(r["spectrum"]).sum(axis=0)
               for r in drift["records"]]
    emit("accuracy", card=card, check="drift of the kernels tier",
         grid=[M, M], steps=steps, chunk=chunk,
         vs_torch_fft=drift["vs_torch_fft"],
         spectrum_rel_l2_diff=float(np.linalg.norm(spectra[1] - spectra[0])
                                    / np.linalg.norm(spectra[0])),
         series={r["tier"]: r["series"] for r in drift["records"]},
         wall_s={r["tier"]: r["wall_s"] for r in drift["records"]})
    free_memory()
    if failed:
        raise AssertionError("accuracy: " + "; ".join(failed))


def time_kernels(calls: dict, reps: int, plain_reps: int) -> dict:
    """Per-kernel ms beside the plain version's, in turns."""
    out = {}
    for name, (kern, plain, per) in calls.items():
        plain_a = time_ms(plain, plain_reps) / per
        kern_a = time_ms(kern, reps) / per
        kern_b = time_ms(kern, reps) / per
        plain_b = time_ms(plain, plain_reps) / per
        out[name] = {"ms": (kern_a + kern_b) / 2,
                     "plain_ms": (plain_a + plain_b) / 2,
                     "runs_ms": [kern_a, kern_b],
                     "plain_runs_ms": [plain_a, plain_b]}
    return out


def host_enqueue_ms(model, state, steps) -> float:
    """Host time to enqueue a step while the launch queue absorbs the run
    (the host returns before the device finishes)."""
    state = model.run(state, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.run(state, steps)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    return ms


def phase_timing(cfgs, dev, card, steps, reps, plain_reps, kernels) -> dict:
    """Every route's ms per step, per-kernel ms (``kernels`` among K1, K2,
    K3, K4 (forward and inverse), K5, K15, K16, K17) with the library
    calls of K2 and K4, host enqueue ms and traced busy shares at the
    default route's grid."""
    routes, state0, models = time_routes(cfgs, dev, steps)
    cfg = cfgs["default"]
    rng = np.random.default_rng(SEED + 1)
    x = torch.as_tensor(rng.standard_normal((2, cfg.M, cfg.P)),
                        dtype=torch.float32, device=dev)
    c64 = torch.complex(x[0], x[1])      # the same field as complex64
    consts = inverter(cfg)._sym_consts
    s = state0
    s_ys = y_dft_plain(s.psi, False)
    calls = {
        "K1": (lambda: fused_step(cfg, s.zeta, s.psi, s.f1, s.f2, 5),
               lambda: fused_step_plain(cfg, s.zeta, s.psi, s.f1, s.f2, 5), 1),
        "K2": (lambda: (y_dft(x, False), y_dft(x, True)),
               lambda: (y_dft_plain(x, False), y_dft_plain(x, True)), 2),
        "K3": (lambda: pair_x_symbols(x, consts),
               lambda: pair_x_symbols_plain(x, consts), 1),
        "K4": (lambda: x_dft(x, False), lambda: x_dft_plain(x, False), 1),
        "K4 inverse": (lambda: x_dft(x, True),
                       lambda: x_dft_plain(x, True), 1),
        "K5": (lambda: x_symbols_inverse(x, consts),
               lambda: x_symbols_inverse_plain(x, consts), 1),
        "K15": (lambda: fused_step_yspec(cfg, s.zeta, s_ys, s.f1, s.f2, 5),
                lambda: fused_step_yspec_plain(cfg, s.zeta, s_ys, s.f1,
                                               s.f2, 5), 1),
        "K16": (lambda: mono_invert(x, consts),
                lambda: mono_invert_plain(x, consts), 1),
        "K17": (lambda: fused_step_full(cfg, s.zeta, s.psi, s.f1, s.f2, 5),
                lambda: fused_step_full_plain(cfg, s.zeta, s.psi, s.f1,
                                              s.f2, 5), 1),
    }
    kernel_ms = time_kernels({k: calls[k] for k in kernels}, reps, plain_reps)
    # One PyTorch call computing the same transform (used nowhere in the
    # port): K2 along y, K4 along x.
    library = {"K2": lambda: torch.fft.fft(c64, dim=1),
               "K4": lambda: torch.fft.fft(c64, dim=0)}
    for k, fn in library.items():
        if k in kernel_ms:
            kernel_ms[k]["library_ms"] = (time_ms(fn, reps) + time_ms(fn, reps)) / 2
    del x, c64, s_ys
    compare = {}
    if {"K2", "K3", "K16"} <= kernel_ms.keys():
        compare["K16_vs_2xK2_plus_K3_ms"] = [
            kernel_ms["K16"]["ms"],
            2 * kernel_ms["K2"]["ms"] + kernel_ms["K3"]["ms"]]
    if "K17" in kernel_ms:
        compare["K17_vs_default_step_ms"] = [kernel_ms["K17"]["ms"],
                                             routes["step_ms"]["default"]]
    host = host_enqueue_ms(models["default"], state0, steps)
    emit("timing", card=card, grid=[cfg.M, cfg.P], steps_per_run=steps,
         **routes, host_enqueue_ms_per_step=host, kernel_ms=kernel_ms,
         compare=compare)
    for name in ("default", "fullstep"):
        if name in models:
            phase_trace(models[name], name, state0, card, steps)
    del routes, state0, models, s
    free_memory()
    return kernel_ms


def time_pre_inversion(cfg, dev, card) -> dict:
    """K8 ms per launch beside its plain version at cfg's grid."""
    zeta, psi, f1, f2 = step_inputs(cfg, dev, np.random.default_rng(SEED + 3))
    ms = time_kernels({"K8": (
        lambda: fused_pre_inversion(cfg, zeta, psi, f1, f2, 5),
        lambda: fused_pre_inversion_plain(cfg, zeta, psi, f1, f2, 5), 1)},
        50, 20)
    emit("timing", card=card, grid=[cfg.M, cfg.P], layers=cfg.n_layers,
         gauge=cfg.poisson_gauge, kernel_ms=ms)
    return ms["K8"]


def trace_device(fn, per: int) -> dict:
    """Device ms by kernel (per ``per`` units of work) and the device's busy
    share over one traced call of ``fn``. Only CUDA activity is traced (no
    host-op recording), so the host launches at close to its untraced
    rate."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {}
    for e in events:
        name = next((k for k, fn in TRACE_NAMES if fn in e.name), "other")
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / per
    busy = span = None
    if events:
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events)) / 1e3 / per
        busy = sum(by_kernel.values()) / span
    return dict(activities="cuda", device_events=len(events),
                device_ms_by_kernel=by_kernel, span_ms=span, busy_share=busy,
                idle_share=None if busy is None else 1.0 - busy)


def phase_trace(model, route, state, card: str, steps: int) -> None:
    """Device time by kernel and the device's busy share over a traced
    window of ``route`` steps, after a warm-up that settles the caching
    allocator."""
    state = model.run(state, 30)
    emit("trace", card=card, route=route, grid=[model.cfg.M, model.cfg.P],
         steps=steps, per="step",
         **trace_device(lambda: model.run(state, steps), steps))


def time_mg(name, cfg, dev, card, zeta, seed, state, cycles, reps,
            plain_reps, trace) -> dict:
    """At cfg's grid: ms per MG inversion call (warm-started from ``seed``)
    on the kernel route and the plain route beside the spectral inversion
    of the same zeta (PackedModalInverterKernels, the model's route), in
    turns, host-launched; the kernel route's call replayed from a CUDA graph
    (its device time: measurement only, the port captures no graph); host
    enqueue ms per call; at every level K10 (restrict form) and K11 per
    launch by their wrappers beside their plain versions, and replayed from
    a CUDA graph in turns: the row-streaming kernel (launched layout), the
    tile kernel and a copy of the same bytes (3.25 (2, m, m) fields); K9 on
    ``state`` beside its plain version; with ``trace``, the busy share over
    one traced MG call. Returns the per-kernel times at the top level, with
    the levels' times under "levels"."""
    kern, plain = mg_inverter(cfg, cycles), mg_inverter(cfg, cycles, "off")
    spectral = inverter(cfg)
    calls = {"mg_kernels": (lambda: kern(zeta, psi_prev=seed), reps),
             "mg_plain": (lambda: plain(zeta, psi_prev=seed), plain_reps),
             "spectral": (lambda: spectral(zeta), 5 * reps)}
    runs = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        fn, n = calls[k]
        runs[k].append(time_ms(fn, n, warmup=1))
    call_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    graph_runs = [graph_ms(calls["mg_kernels"][0], reps) for _ in range(2)]
    # Host time to enqueue one call into an idle queue (best of 3).
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(zeta, psi_prev=seed)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    alphas = kern.solver.alphas
    levels = {}
    for m, p, h in kern.solver.levels:
        u, f, ec = mg_inputs(m, dev, SEED + m + 1)
        k10 = mg_form_calls("restrict", u, f, ec, h, alphas)
        k11 = mg_form_calls("prolong", u, f, ec, h, alphas)
        levels[m] = time_kernels({
            "K10": (lambda: mg_smooth(u, f, h, alphas, MG_NU, True, 0.8,
                                      True), k10[2], 1),
            "K11": (lambda: mg_prolong_smooth(u, ec, f, h, alphas, MG_NU),
                    k11[2], 1)}, 5 * reps, plain_reps)
        src = torch.empty(int(3.25 * m * p), device=dev)
        dst = torch.empty_like(src)
        turns = {"K10 rows": k10[0], "K10 tile": k10[1], "K11 rows": k11[0],
                 "K11 tile": k11[1], "copy": lambda: dst.copy_(src)}
        g = {k: [] for k in turns}
        for k in list(turns) + list(turns)[::-1]:
            g[k].append(graph_ms(turns[k], 5 * reps))
        for k in ("K10", "K11"):
            levels[m][k].update(
                bound_ms=bound(k, m, p)[0],
                graph_ms=sum(g[f"{k} rows"]) / 2,
                tile_graph_ms=sum(g[f"{k} tile"]) / 2,
                copy_graph_ms=sum(g["copy"]) / 2,
                graph_runs_ms={t: g[f"{k} {t}"] for t in ("rows", "tile")},
                layout=mg_layout_name(mg_rows_launched(m)))
        del u, f, ec, src, dst, turns, k10, k11
    tend = time_kernels({"K9": (
        lambda: fused_tendency(cfg, state.zeta, state.psi),
        lambda: fused_tendency_plain(cfg, state.zeta, state.psi), 1)},
        5 * reps, plain_reps)
    traced = (trace_device(lambda: kern(zeta, psi_prev=seed), 1)
              if trace else None)
    emit("timing", card=card, path=name, grid=[cfg.M, cfg.P],
         cycles_per_call=cycles, call_ms=call_ms, call_ms_runs=runs,
         mg_kernels_graph_ms=sum(graph_runs) / 2,
         mg_kernels_graph_runs_ms=graph_runs,
         mg_kernels_vs_spectral=call_ms["mg_kernels"] / call_ms["spectral"],
         host_enqueue_ms_per_call=min(host), host_enqueue_runs_ms=host,
         kernel_ms_by_level=levels, kernel_ms=tend, trace_per_call=traced)
    free_memory()
    top = levels[cfg.M]
    return {"K9": tend["K9"], "K10": top["K10"], "K11": top["K11"],
            "levels": levels, "call_ms": call_ms,
            "call_graph_ms": sum(graph_runs) / 2,
            "host_enqueue_ms": min(host)}


def kernel_rows(errs, launches, ms_2048, ms_8192, extra, sharded) -> list:
    """The {"kernels": [...]} entries: launches summed over the paths
    (each counted from 0), errors, ms per launch beside the plain version's
    and the library call's, and the bound, at 2048^2 for K1-K3, K8, K9 and
    K15-K17, 8192^2 for K4/K5 and K10/K11 (the top level of the 8192^2
    solver), and at the mesh slices' shapes in ``sharded`` for K7, K12-K14
    and K15's sharded form; ``extra`` adds fields to a kernel's entry."""
    rows = []
    # K2's row counts y_dft_factored_kernel's and y_dft_kernel's launches,
    # K3's pair_x_cluster_kernel's and pair_x_kernel's, K4's
    # x_dft_cluster_kernel's and x_dft_kernel's, K5's
    # x_symbols_cluster_kernel's and x_symbols_inverse_kernel's;
    # y_dft_mixed_kernel's, pair_x_cluster_mixed_kernel's,
    # x_dft_cluster_mixed_kernel's and x_symbols_cluster_mixed_kernel's
    # (also in y_dft's, pair_x_symbols's, x_dft's and x_symbols_inverse's
    # counts) have rows of their own, as have K13's and K14's
    # pair_cols_cluster_mixed_kernel's and K7's launches of K3's mixed
    # cluster kernel (also in their wrappers' counts).
    launches = {p: dict(run, K2=run["K2"] - run["K2 mixed"],
                        K3=run["K3"] - run["K3 mixed"],
                        K4=run["K4"] - run["K4 mixed"],
                        K5=run["K5"] - run["K5 mixed"],
                        K7=run["K7"] - run["K7 mixed"],
                        K13=run["K13"] - run["K13 mixed"],
                        K14=run["K14"] - run["K14 mixed"])
                for p, run in launches.items()}
    for name, (fn, source, replaces) in KERNELS.items():
        if name in sharded:
            at, (_, rows_, cols) = sharded, sharded[name]["shape"]
        else:
            at = ms_2048 if name in ms_2048 else ms_8192
            rows_ = cols = 2048 if at is ms_2048 else 8192
        n = [rows_, cols]
        bound_ms, bound_by, nbytes = bound(name, rows_, cols)
        row = {"name": f"{name} {fn}", "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(run[name] for run in launches.values()),
               "launches_by_path": {p: run[name]
                                    for p, run in launches.items()
                                    if run[name]},
               "max_abs_err": errs.by_kernel[name][0],
               "rel_err": errs.by_kernel[name][1],
               "ms": at[name]["ms"], "plain_ms": at[name]["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "library_ms": at[name].get("library_ms"), "grid": n}
        if name in ("K1", "K2", "K9"):
            row.update(ms_8192=ms_8192[name]["ms"],
                       plain_ms_8192=ms_8192[name]["plain_ms"],
                       bound_ms_8192=bound(name, 8192, 8192)[0])
            if name == "K2":
                row.update(library_ms_8192=ms_8192[name]["library_ms"])
        if name == "K4":
            row.update(ms_inverse=ms_8192["K4 inverse"]["ms"],
                       plain_ms_inverse=ms_8192["K4 inverse"]["plain_ms"])
        row.update(extra.get(name, {}))
        rows.append(row)
    # tpu_qg's streaming x-kernel computes K4 (forward) and K5 (fused
    # inverse) where its strips outgrow VMEM; K4 and K5 run in its place.
    by_name = {r["name"].split()[0]: r for r in rows}
    k4, k5 = by_name["K4"], by_name["K5"]
    rows.append({"name": "K6 _call_x_stream (covered by K4/K5)",
                 "route": "cuda", "source": "tpu_qg_torch/csrc/dft_kernels.cu",
                 "replaces": "tpu_qg/ops/pallas_fft.py:1122",
                 "covered_by": ["K4", "K5"],
                 "launches": k4["launches"] + k5["launches"],
                 "max_abs_err": max(k4["max_abs_err"], k5["max_abs_err"]),
                 "ms": k4["ms"] + k5["ms"],
                 "plain_ms": k4["plain_ms"] + k5["plain_ms"],
                 "bound_ms": k4["bound_ms"] + k5["bound_ms"],
                 "bound_by": "bytes", "library_ms": None,
                 "grid": [8192, 8192]})
    # K2 on the mixed extents: its mixed-radix factored kernel, timed at
    # (2, 2432, 2432) (time_k2_mixed), ms a launch over both ways.
    m = extra["K2 mixed"]
    at = m["by_shape"]["2432x2432"]
    bound_ms, bound_by, nbytes = bound("K2", 2432, 2432)
    rows.append({
        "name": "K2 mixed y_dft (y_dft_mixed_kernel)", "route": "cuda",
        "source": "tpu_qg_torch/csrc/dft_kernels.cu",
        "replaces": KERNELS["K2"][2],
        "launches": sum(run["K2 mixed"] for run in launches.values()),
        "launches_by_path": {p: run["K2 mixed"] for p, run in launches.items()
                             if run["K2 mixed"]},
        "max_abs_err": errs.by_kernel["K2 mixed"][0],
        "rel_err": errs.by_kernel["K2 mixed"][1],
        "ms": (at["mixed"]["ms"] + at["mixed"]["inverse_ms"]) / 2,
        "plain_ms": sum(at["plain_runs_ms"]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "library_ms": at["library"]["ms"], "grid": [2432, 2432],
        "y_dft_kernel_ms": (at["y_dft_kernel"]["ms"]
                            + at["y_dft_kernel"]["inverse_ms"]) / 2,
        **m})
    # K4 on the mixed extents: its mixed cluster kernel, timed at (2, 3072,
    # 3072) (time_k4_mixed), ms a launch forward and inverse.
    m = extra["K4 mixed"]
    at = m["by_grid"][3072]
    bound_ms, bound_by, nbytes = bound("K4", 3072, 3072)
    rows.append({
        "name": "K4 mixed x_dft (x_dft_cluster_mixed_kernel)",
        "route": "cuda", "source": "tpu_qg_torch/csrc/dft_kernels.cu",
        "replaces": KERNELS["K4"][2],
        "launches": sum(run["K4 mixed"] for run in launches.values()),
        "launches_by_path": {p: run["K4 mixed"] for p, run in launches.items()
                             if run["K4 mixed"]},
        "max_abs_err": errs.by_kernel["K4 mixed"][0],
        "rel_err": errs.by_kernel["K4 mixed"][1],
        "ms": at["mixed"]["ms"], "ms_inverse": at["mixed"]["inverse_ms"],
        "plain_ms": sum(at["plain_runs_ms"]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "library_ms": at["library"]["ms"], "grid": [3072, 3072],
        "x_dft_kernel_ms": at["x_dft_kernel"]["ms"],
        "x_dft_kernel_ms_inverse": at["x_dft_kernel"]["inverse_ms"], **m})
    # K5 on the mixed extents: its mixed cluster kernel, timed at (2, 3072,
    # 3072) (time_k5_mixed). No library call computes K5's function; one
    # torch.fft.ifft along x stands beside it as a yardstick.
    m = extra["K5 mixed"]
    at = m["by_grid"][3072]
    bound_ms, bound_by, nbytes = bound("K5", 3072, 3072)
    rows.append({
        "name": "K5 mixed x_symbols_inverse (x_symbols_cluster_mixed_kernel)",
        "route": "cuda", "source": "tpu_qg_torch/csrc/dft_kernels.cu",
        "replaces": KERNELS["K5"][2],
        "launches": sum(run["K5 mixed"] for run in launches.values()),
        "launches_by_path": {p: run["K5 mixed"] for p, run in launches.items()
                             if run["K5 mixed"]},
        "max_abs_err": errs.by_kernel["K5 mixed"][0],
        "rel_err": errs.by_kernel["K5 mixed"][1],
        "ms": at["mixed"]["ms"], "graph_ms": at["mixed"]["graph_ms"],
        "plain_ms": sum(at["plain_runs_ms"]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "library_ms": None, "grid": [3072, 3072],
        "yardstick_ifft_ms": at["library ifft along x"]["ms"],
        "x_symbols_inverse_kernel_ms": at["x_symbols_inverse_kernel"]["ms"],
        **m})
    # K3 on the mixed extents: its mixed cluster kernel, timed at (2, 1536,
    # 1536), the 1536^2 path's grid (time_k3_mixed). No library call
    # computes K3's function; one torch.fft.fft and one torch.fft.ifft along
    # x stand beside it as a yardstick.
    m = extra["K3 mixed"]
    at = m["by_grid"][1536]
    bound_ms, bound_by, nbytes = bound("K3", 1536, 1536)
    rows.append({
        "name": "K3 mixed pair_x_symbols (pair_x_cluster_mixed_kernel)",
        "route": "cuda", "source": "tpu_qg_torch/csrc/dft_kernels.cu",
        "replaces": KERNELS["K3"][2],
        "launches": sum(run["K3 mixed"] for run in launches.values()),
        "launches_by_path": {p: run["K3 mixed"] for p, run in launches.items()
                             if run["K3 mixed"]},
        "max_abs_err": errs.by_kernel["K3 mixed"][0],
        "rel_err": errs.by_kernel["K3 mixed"][1],
        "ms": at["mixed"]["ms"], "graph_ms": at["mixed"]["graph_ms"],
        "plain_ms": sum(at["plain_runs_ms"]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "library_ms": None, "grid": [1536, 1536],
        "yardstick_fft_ifft_ms": at["library fft + ifft along x"]["ms"],
        "pair_x_kernel_ms": at["pair_x_kernel"]["ms"], **m})
    # K13, K14 and K7 on the mixed extents: the block kernel's mixed
    # instance (K13, K14) and K3's mixed cluster kernel (K7), timed at the
    # mixed slices' shapes (time_mixed_cols). No library call computes their
    # function; one torch.fft.fft and one torch.fft.ifft along x stand
    # beside each as a yardstick.
    cols_mixed = "tpu_qg_torch/csrc/pair_cols_mixed.cu"
    for name, kernel, source in (
            ("K13 mixed", "pair_cols_cluster_mixed_kernel", cols_mixed),
            ("K14 mixed", "pair_cols_cluster_mixed_kernel", cols_mixed),
            ("K7 mixed", "pair_x_cluster_mixed_kernel", KERNELS["K7"][1])):
        base = name.split()[0]
        at = sharded[name]
        _, rows_, cols = at["shape"]
        bound_ms, bound_by, nbytes = bound(base, rows_, cols)
        rows.append({
            "name": f"{name} {KERNELS[base][0]} ({kernel})", "route": "cuda",
            "source": source, "replaces": KERNELS[base][2],
            "launches": sum(run[name] for run in launches.values()),
            "launches_by_path": {p: run[name] for p, run in launches.items()
                                 if run[name]},
            "max_abs_err": errs.by_kernel[name][0],
            "rel_err": errs.by_kernel[name][1],
            "ms": at["ms"], "graph_ms": at["graph_ms"],
            "plain_ms": at["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
            "grid": [rows_, cols],
            "yardstick_fft_ifft_ms": at["yardstick_ms"],
            "yardstick_fft_ifft_graph_ms": at["yardstick_graph_ms"],
            "pair_cols_kernel_ms": at["whole_columns_ms"],
            "pair_cols_kernel_graph_ms": at["whole_columns_graph_ms"],
            **extra.get(name, {})})
    return rows


def mg_level_fields(times: dict) -> dict:
    """K10's and K11's per-level ms (by the wrapper, host-launched), plain
    ms, bound ms, and graph-replayed ms of the row-streaming kernel, the
    tile kernel and a copy of the same bytes, of one solver, by level
    extent."""
    keys = ("ms", "plain_ms", "bound_ms", "graph_ms", "tile_graph_ms",
            "copy_graph_ms", "layout")
    return {name: {key: {m: t[name][key] for m, t in times["levels"].items()}
                   for key in keys}
            for name in ("K10", "K11")}


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    named_ptxas = phase_build()
    turb = preset("turbulence-2048")
    pod = preset("pod-8192")
    pod_mg = preset("pod-8192-mg")
    forms = {"mono": turb.replace(fft_mono="on"),
             "fullstep": turb.replace(step_full="on"),
             "chain": turb.replace(step_chain="on")}
    pod_chain = pod.replace(step_chain="on")
    mixed_cfgs = {name: turb.replace(M=n, P=n)
                  for name, n in zip(MIXED_PATHS, (1536, 3072))}
    errs = Errors()
    phase_kernels(errs, turb, dev)
    phase_x_kernels(errs, pod, dev)
    k4_sweep = phase_k4_sweep(dev, card)
    k5_sweep = phase_k5_sweep(dev, pod, card)
    k3_sweep = phase_k3_sweep(dev, turb, card)
    k13_sweep = phase_k13_sweep(dev, turb, pod, card)
    k1_sweep = phase_k1_sweep(dev, card)
    k9_sweep = phase_k9_sweep(dev, card)
    coop_sweep = phase_coop_sweep(errs, turb, dev, card, named_ptxas)
    k2_sweep = phase_k2_sweep(errs, dev, card)
    k2_mixed = time_k2_mixed(errs, dev, card)
    k4_mixed = time_k4_mixed(errs, dev, card)
    k5_mixed = time_k5_mixed(errs, dev, card, turb)
    k3_mixed = time_k3_mixed(errs, dev, card, turb)
    phase_mg_kernels(errs, turb, pod_mg, dev, card)
    mg_sweep = phase_mg_sweep(dev, card, pod_mg)
    phase_sharded_kernels(errs, turb, pod, dev)
    phase_lab_kernels(errs, dev)

    slices = (
        ("turbulence-2048", turb, 100,
         {"K1": 100, "K1 rows": 100, "K2": 200, "K2 factored": 200,
          "K3": 100, "K3 cluster": 100}, "default"),
        ("turbulence-2048 pin", turb.replace(poisson_gauge="pin"), 100,
         {"K8": 100}, "default"),
        ("turbulence-2048 fft_mono=on", forms["mono"], 100,
         {"K1": 100, "K1 rows": 100, "K16": 100, "K16 rows": 100}, "mono"),
        ("turbulence-2048 step_full=on", forms["fullstep"], 100,
         {"K17": 100, "K17 rows": 100}, "fullstep"),
        ("turbulence-2048 step_chain=on", forms["chain"], 100,
         {"K15": 100, "K15 rows": 100, "K3": 100, "K3 cluster": 100,
          "K2": 2 * run_chunks(forms["chain"], 100),
          "K2 factored": 2 * run_chunks(forms["chain"], 100)}, "chain"),
        ("pod-8192", pod, 50, {"K1": 50, "K1 rows": 50, "K2": 100,
                               "K2 factored": 100, "K4": 50, "K5": 50,
                               "K4 cluster": 50, "K5 cluster": 50},
         "default"),
        ("pod-8192 step_chain=on", pod_chain, 20,
         {"K15": 20, "K15 rows": 20, "K4": 20, "K5": 20, "K2": 2 * run_chunks(pod_chain, 20),
          "K2 factored": 2 * run_chunks(pod_chain, 20), "K4 cluster": 20,
          "K5 cluster": 20}, "chain"),
        # The mixed extents' paths: every K2 launch by the mixed-radix
        # factored kernel, every K3, K4 and K5 launch by its mixed cluster
        # kernel.
        (MIXED_PATHS[0], mixed_cfgs[MIXED_PATHS[0]], 100,
         {"K1": 100, "K1 rows": 100, "K2": 200, "K2 mixed": 200, "K3": 100,
          "K3 mixed": 100}, "default"),
        (MIXED_PATHS[1], mixed_cfgs[MIXED_PATHS[1]], 50,
         {"K1": 50, "K1 rows": 50, "K2": 100, "K2 mixed": 100, "K4": 50,
          "K4 mixed": 50, "K5": 50, "K5 mixed": 50}, "default"),
        # The matmul-DFT tier: K1, then the inversion on torch.matmul.
        ("turbulence-2048 fft_impl=matmul", turb.replace(fft_impl="matmul"),
         100, {"K1": 100, "K1 rows": 100}, "default"),
    )
    launches, finals = {}, {}
    for name, cfg, steps, expect, route in slices:
        launches[name], out = run_slice(name, cfg, dev, steps, expect, route)
        if name in ("turbulence-2048", "pod-8192"):
            finals[name] = out
        del out
        free_memory()

    # The multigrid inversion on the state of each grid's default-route
    # run (pod-8192-mg runs that route on one device), and the tendency.
    mg_paths = (("pod-8192-mg MG inversion", pod_mg, finals["pod-8192"],
                 pod_mg.mg_cycles),
                ("turbulence-2048 MG inversion", turb,
                 finals["turbulence-2048"], 4))
    problems = {}
    for (name, cfg, state, cycles), kernel_levels in zip(mg_paths, (5, 3)):
        problems[name] = mg_problem(cfg, state, dev)
        launches[name] = run_mg_path(name, cfg, dev, *problems[name], cycles,
                                     20, kernel_levels)
    launches["turbulence-2048 tendency"] = run_tendency_path(
        turb, finals["turbulence-2048"], 20)
    free_memory()
    launches["stencil lab (6 variants)"], lab_jobs = run_lab_path(dev)

    # The mesh: one rank on NCCL, K7's path, then four ranks on gloo.
    mesh_launches, mesh_ms = phase_mesh_one_rank(turb, pod, pod_mg, dev,
                                                 card)
    launches.update(mesh_launches)
    launches["pod-8192 K7 path (pair_stream on)"] = run_k7_path(pod, dev, 20)
    launches[f"{MIXED_PATHS[1]} K7 path (pair_stream on)"] = run_k7_path(
        mixed_cfgs[MIXED_PATHS[1]], dev, 20)
    free_memory()
    for row in phase_mesh_four_ranks(card):
        launches[f"{row['preset']} (rank 0 of 4)"] = {
            k: row["launches_per_rank"].get(k, 0) for k in COUNTERS}

    plain = dict(fft_impl="xla", use_pallas=False)
    ms_2048 = phase_timing(
        {"default": turb, **forms, "plain": turb.replace(**plain)}, dev, card,
        100, 50, 20, ("K1", "K2", "K3", "K15", "K16", "K17"))
    ms_2048["K8"] = time_pre_inversion(turb.replace(poisson_gauge="pin"), dev,
                                       card)
    ms_8192 = phase_timing({"default": pod, "chain": pod_chain,
                            "plain": pod.replace(**plain)},
                           dev, card, 20, 10, 3,
                           ("K1", "K2", "K4", "K4 inverse", "K5", "K15"))
    mixed_steps = {}
    for (name, cfg), steps in zip(mixed_cfgs.items(), (100, 50)):
        routes, _, _ = time_routes(
            {"default": cfg, "plain": cfg.replace(**plain)}, dev, steps)
        emit("timing", card=card, path=name, grid=[cfg.M, cfg.P],
             steps_per_run=steps, **routes)
        mixed_steps[name] = routes["step_ms"]
        free_memory()
    mg_ms = {}
    for (name, cfg, state, cycles), (reps, plain_reps, trace) in zip(
            mg_paths, ((10, 2, True), (20, 3, False))):
        mg_ms[cfg.M] = time_mg(name, cfg, dev, card, *problems[name], state,
                               cycles, reps, plain_reps, trace)
    ms_2048["K9"], ms_8192["K9"] = mg_ms[2048]["K9"], mg_ms[8192]["K9"]
    ms_8192["K10"], ms_8192["K11"] = mg_ms[8192]["K10"], mg_ms[8192]["K11"]
    levels = {n: mg_level_fields(t) for n, t in mg_ms.items()}
    rows_kernel = "P % 4 == 0 (P % 8 == 0 for the restrict and prolong " \
        "forms), nu in {}, operands 16-byte aligned (layouts (R, D, NT): " \
        "{}, else {})".format(mg_kernels.MG_ROWS_NUS, mg_kernels.MG_ROWS_BY_M,
                              mg_kernels.MG_ROWS)
    extra = {k: {"rows_launches": sum(run[f"{k} rows"]
                                      for run in launches.values()),
                 "tile_launches": sum(run[k] - run[f"{k} rows"]
                                      for run in launches.values()),
                 "kernels": {"mg_rows_kernel": rows_kernel,
                             tile: "every other shape (the tile design)"},
                 "by_level_8192_solver": levels[8192][k],
                 "by_level_2048_solver": levels[2048][k],
                 "call_ms": {n: dict(t["call_ms"],
                                     mg_kernels_graph=t["call_graph_ms"],
                                     host_enqueue=t["host_enqueue_ms"])
                             for n, t in mg_ms.items()},
                 "sweep_least": {n: v["least"][k]
                                 for n, v in mg_sweep.items()}}
             for k, tile in (("K10", "mg_smooth_kernel"),
                             ("K11", "mg_prolong_kernel"))}

    extra["K4"] = {
        "cluster_launches": sum(run["K4 cluster"] for run in launches.values()),
        "kernels": {"x_dft_cluster_kernel": "M = 128 * 2^a, M >= 128 G "
                    "(layout at 8192: G={} Cw={})".format(
                        *dft_kernels.x_dft_cluster_launched(8192)),
                    "x_dft_cluster_mixed_kernel": "the other M = 128 n, "
                    "G <= n <= 63 (the K4 mixed row)",
                    "x_dft_kernel": "M < 128 G"},
        "sweep_8192": k4_sweep[8192]}
    extra["K4 mixed"] = {
        "mixed_launches": sum(run["K4 mixed"] for run in launches.values()),
        "kernels": {"x_dft_cluster_mixed_kernel": "M = 128 n, G <= n <= 63 "
                    "not a power of two (layouts: {}, else {})".format(
                        dft_kernels.X_CLUSTER_BY_M, dft_kernels.X_CLUSTER),
                    "x_dft_kernel": "M < 128 G"},
        "ptxas": named_ptxas["x_dft_cluster_mixed_kernel"],
        "by_grid": k4_mixed}
    extra["K5"] = {
        "cluster_launches": sum(run["K5 cluster"]
                                for run in launches.values()),
        "kernels": {"x_symbols_cluster_kernel": "M = 128 * 2^a, M >= 256 G "
                    "(layout at 8192: G={} Cw={})".format(
                        *dft_kernels.x_symbols_cluster_launched(8192)),
                    "x_symbols_cluster_mixed_kernel": "the other M = 128 n, "
                    "ceil(n / 2) >= G (the K5 mixed row)",
                    "x_symbols_inverse_kernel": "smaller M"},
        "sweep_8192": k5_sweep[8192]}
    extra["K5 mixed"] = {
        "mixed_launches": sum(run["K5 mixed"] for run in launches.values()),
        "kernels": {"x_symbols_cluster_mixed_kernel": "M = 128 n, n <= 63 "
                    "not a power of two, ceil(n / 2) >= G (layouts: {}, "
                    "else {})".format(dft_kernels.X_SYMBOLS_CLUSTER_BY_M,
                                      dft_kernels.X_SYMBOLS_CLUSTER),
                    "x_symbols_inverse_kernel": "smaller M"},
        "ptxas": named_ptxas["x_symbols_cluster_mixed_kernel"],
        "by_grid": k5_mixed}
    k3_kernels = {
        "pair_x_cluster_kernel": "M = 128 * 2^a, M >= 256 G (layouts: {}, "
        "else {})".format(dft_kernels.PAIR_X_CLUSTER_BY_M,
                          dft_kernels.PAIR_X_CLUSTER),
        "pair_x_cluster_mixed_kernel": "the other M = 128 n, n <= 63, "
        "ceil(n / 2) >= G: 896 ... 2432 on the pair-x route (the K3 mixed "
        "row; launched as above, else {} if it fits, else {})".format(
            dft_kernels.PAIR_X_CLUSTER, dft_kernels.PAIR_X_CLUSTER_SMALL),
        "pair_x_kernel": "384, 640, 768 and M < 256 G"}
    extra["K3"] = {
        "cluster_launches": sum(run["K3 cluster"]
                                for run in launches.values()),
        "kernels": k3_kernels, "sweep_2048": k3_sweep[2048]}
    extra["K3 mixed"] = {
        "mixed_launches": sum(run["K3 mixed"] for run in launches.values()),
        "kernels": k3_kernels,
        "ptxas": named_ptxas["pair_x_cluster_mixed_kernel"],
        "by_grid": k3_mixed}
    extra["K2"] = {
        "factored_launches": sum(run["K2 factored"]
                                 for run in launches.values()),
        "kernels": {"y_dft_factored_kernel": "P in {} (layouts (Rb, "
                    "threads): {})".format(
                        sorted(dft_kernels.Y_FACTORED_RB_BY_P),
                        dft_kernels.Y_FACTORED_RB_BY_P),
                    "y_dft_mixed_kernel": "the other P = 128 N2 (the K2 "
                    "mixed row)",
                    "y_dft_kernel": "P <= 128, P not a multiple of 128"},
        "sweep_8192": k2_sweep[8192]}
    extra["K2 mixed"] = {
        "mixed_launches": sum(run["K2 mixed"] for run in launches.values()),
        "kernels": {"y_dft_mixed_kernel": "P = 128 N2, 3 <= N2 <= 63 not a "
                    "power of two (layout: Rb the least power of two with "
                    "Rb N2 >= {}, 256 threads)".format(
                        dft_kernels.Y_MIXED_PROWS),
                    "y_dft_kernel": "P <= 128, P not a multiple of 128"},
        "ptxas": named_ptxas["y_dft_mixed_kernel"], "by_shape": k2_mixed,
        "path_step_ms": mixed_steps}
    takes = {"K15": "where coop_rows_takes: K1's row kernel and K2's "
             "factored kernel take the grid",
             "K17": "where coop_rows_takes: K1's row kernel, K2's factored "
             "kernel and K3's cluster kernel take the grid",
             "K16": "where mono_rows_takes: K2's factored kernel and K3's "
             "cluster kernel take the grid, z 16-byte aligned",
             "K15s": "where coop_rows_takes over the block's operands and "
             "its slabs: K1's row kernel and K2's factored kernel take the "
             "block"}
    for name, (_, kernel, _) in COOP_KERNELS.items():
        sweep = {k: v for k, v in coop_sweep.items()
                 if k.split()[0] == name}
        at = sweep["K15s at (2, 2048, 2048)" if name == "K15s"
                   else f"{name} at 2048^2"]
        extra[name] = {
            "rows_launches": sum(run[f"{name} rows"]
                                 for run in launches.values()),
            "first_form_launches": sum(run[name] - run[f"{name} rows"]
                                       for run in launches.values()),
            "kernels": {kernel: takes[name] + " (layouts: the separate "
                        "kernels' launched ones, the step's D = 8)",
                        kernel.replace("_rows", ""): "the first form, on "
                        "every other grid"},
            "graph_ms_2048": at["graph_ms"],
            "launch_grid_2048": at["launch_grid"],
            "coop_sweep": sweep}
    extra["K15"].update(ms_8192=ms_8192["K15"]["ms"],
                        plain_ms_8192=ms_8192["K15"]["plain_ms"],
                        bound_ms_8192=bound("K15", 8192, 8192)[0])
    extra["K1"] = {
        "rows_launches": sum(run["K1 rows"] for run in launches.values()),
        "kernels": {"step_rows_kernel": "P % 4 == 0, operands 16-byte "
                    "aligned (layouts (W, R, D, NT): {}, else {})".format(
                        step_kernel.STEP_ROWS_BY_M, step_kernel.STEP_ROWS),
                    "step_kernel": "every other shape (the tile design)"},
        "sweep": k1_sweep}
    sharded_ms = time_sharded_kernels(turb, pod, dev, card)
    cols = {"pair_cols_cluster_kernel": "M = 128 * 2^a, M >= 256 G, whole "
            "128-column strips (layouts: {}, else K3's at M)".format(
                dft_kernels.PAIR_COLS_CLUSTER_BY_MW),
            "pair_cols_cluster_mixed_kernel": "the other M = 128 n, n <= "
            "63, ceil(n / 2) >= G, whole 128-column strips (the K13 mixed "
            "and K14 mixed rows)",
            "pair_cols_kernel": "384, 640, 768, M < 256 G"}
    for name in ("K13", "K14"):
        extra[name] = {
            "cluster_launches": sum(run[f"{name} cluster"]
                                    for run in launches.values()),
            "kernels": cols,
            "whole_columns_ms": sharded_ms[name]["whole_columns_ms"],
            "pair_cols_kernel_at_768": sharded_ms[f"{name} at 768"],
            "sweep": {k: v for k, v in k13_sweep.items()
                      if k.split()[0] == name and "mixed" not in k}}
        extra[f"{name} mixed"] = {
            "mixed_launches": sum(run[f"{name} mixed"]
                                  for run in launches.values()),
            "kernels": cols,
            "ptxas": named_ptxas["pair_cols_cluster_mixed_kernel"],
            "sweep": {k: v for k, v in k13_sweep.items()
                      if k.startswith(f"{name} mixed")}}
    extra["K13"].update(at_2048=sharded_ms["K13"]["at_2048"],
                        pod_8192_rank=sharded_ms["pod-8192 (4, 1) rank"])
    k7_kernels = {"pair_x_cluster_kernel": "K3's cluster kernel where "
                  "stream_pair_cluster_takes(M), M = 128 * 2^a",
                  "pair_x_cluster_mixed_kernel": "K3's mixed cluster kernel "
                  "where stream_pair_cluster_takes(M), the other M = 128 n "
                  "(the K7 mixed row)",
                  "pair_cols_kernel": "384, 640, 768, M < 256 G"}
    extra["K7"] = {
        "cluster_launches": sum(run["K7 cluster"] for run in launches.values()),
        "kernels": k7_kernels,
        "whole_columns_ms": sharded_ms["K7"]["whole_columns_ms"],
        "pair_cols_kernel_at_768": sharded_ms["K7 at 768"],
        "sweep_8192": k3_sweep[8192]}
    # K7 at 3072^2 beside the four-pass x-stage there: K4 mixed forward then
    # K5 mixed, each timed at (2, 3072, 3072) in its own sweep.
    extra["K7 mixed"] = {
        "mixed_launches": sum(run["K7 mixed"] for run in launches.values()),
        "kernels": k7_kernels,
        "k4_mixed_plus_k5_mixed_ms_3072": k4_mixed[3072]["mixed"]["ms"]
        + k5_mixed[3072]["mixed"]["ms"],
        "k4_mixed_plus_k5_mixed_graph_ms_3072":
        k4_mixed[3072]["mixed"]["graph_ms"]
        + k5_mixed[3072]["mixed"]["graph_ms"]}
    extra["K12"] = {
        "mesh_step_ms": mesh_ms,
        "rows_launches": sum(run["K12 rows"] for run in launches.values()),
        "kernels": {"step_rows_sharded_kernel": "as K1's step_rows_kernel, "
                    "with the block's slabs (H >= 2)",
                    "step_sharded_kernel": "every other shape (the tile "
                    "design)"},
        "tile_ms": sharded_ms["K12"]["tile_ms"]}
    lab = time_lab(dev, card, lab_jobs)
    ms_2048["K18"] = {"ms": lab.pop("ms"), "plain_ms": lab.pop("plain_ms")}
    extra["K18"] = dict(
        lab, rows_launches=sum(run["K18 rows"] for run in launches.values()),
        tile_launches=sum(run["K18"] - run["K18 rows"]
                          for run in launches.values()),
        kernels={"lab_rows_kernel": "P % 4 == 0, operands 16-byte aligned "
                 "(K1's launched layout at M)",
                 "lab_step_kernel": "every other shape (the tile design)"},
        rows_ptxas=named_ptxas["lab_rows_kernel"])
    extra["K9"] = {
        "rows_launches": sum(run["K9 rows"] for run in launches.values()),
        "tile_launches": sum(run["K9"] - run["K9 rows"]
                             for run in launches.values()),
        "kernels": {"tendency_rows_kernel": "P % 4 == 0, operands 16-byte "
                    "aligned (layouts (W, R, D, NT): {}, else K1's)".format(
                        step_kernel.TENDENCY_ROWS_BY_M),
                    "tendency_kernel": "every other shape (the tile "
                    "design)"},
        "rows_ptxas": named_ptxas["tendency_rows_kernel"],
        "sweep": k9_sweep}

    rows = kernel_rows(errs, launches, ms_2048, ms_8192, extra, sharded_ms)
    free_memory()
    phase_accuracy(dev, card, turb, pod)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
