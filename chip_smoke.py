#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snsde_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Four main paths: the sepsis classification training path (Euler–Maruyama,
the fused EM kernels), the MuJoCo forecasting training path (SRIW1, the
fused SRK kernels), the robustness sweep with the Neural CDE (FinalTanh,
natural cubic control, rk4: the fused CDE kernels) and the sweep's
recurrent baselines `gru`, `grud`, `lstm` and `bilstm` (the fused GRU and
LSTM kernels); since the seed ensembles their packed runs, and since the
speech and latent slice Speech Commands (the EM kernels at L=161) and the
sweep's `latentsde`/`latentsde-kl` (the EM kernels' latent instances),
phase 7; since the ODE-RNN hybrids the sweep's `gru-dt`, `gru-d`,
`ode-rnn` and `ode-lstm` (the GRU and LSTM kernels' modes), phase 8; since
the time-aware LSTMs the sweep's `tlstm`, `plstm` and `tglstm` (the LSTM
kernels' sel, tg and TLSTM modes) and `cnn` and `transformer` (no kernel),
phase 9; since the CDE pair's GRU-ODE field and member axis the sweep's
`gru-ode` (the CDE kernels' gruode instances) and the seed-packed
`neuralcde` and `gru-ode` cells (one launch of the member-axis CDE kernels
for the three seeds), phase 10; since the linear controls and the solvers
without a kernel the sweep's `neuralcde-l` and `neuralcde-r` (the CDE
kernels on a LinearPath's stream) and `run_mujoco` with milstein and
heun (the eager sdeint), phase 11; since the rest of the model zoo the
sweep's `ancde`, `exit`, `leap`, `neuralrde-1/2/3` and the flow-CDE
families (the CDE kernels), `mtan` (the GRU kernels in both directions),
`sand`, `miam` and `neuralflow_*` (no kernel), phase 12; since the
interpolation and activity harnesses `run_interpolation` (the SDE-encoder
VAE: the EM kernels on a dense stream at H=128, the decoders' BiGRU on the
GRU kernels) and `run_activity` (the mTAN encoder's BiGRU on the GRU
kernels), phase 13.
Phases, each of which raises on failure:
  1. card: name, and name and power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the four paths from
     snsde_torch/csrc/ (sm_90a, one nvcc per source, all started together),
     with the build seconds and ptxas report;
  3. kernels vs their plain PyTorch versions on the card, on the same
     inputs: the EM pair at the sepsis shape (B=1024, L=72, C=69, H=HH=49,
     two hidden layers, neurallnsde (4,17)), then (2,16) and (6,17) at
     B=128; the SRK pair at the MuJoCo shape (B=1024, L=50, C=14, H=HH=32,
     two hidden layers, (4,17)), at (2,16) and (6,17) with B=128, and at
     the sepsis width; the CDE pair at both CDE bench shapes of the JAX
     package (tools/bench_cde.py:150-151: B=1024, L=72 (136 rk4 steps),
     H=HH=32, FinalTanh with one inner layer, C=6 and C=35), at the sweep's
     shape (B=64, L=60, C=6, H=16, no inner layer), and at B=128 for euler,
     midpoint and heun, SingleHiddenLayer, and FinalTanh with zero and two
     inner layers (each CDE shape's cluster plan printed; rows whose relu
     input lies within rounding of 0 judged apart, check_pair_rows); the
     EM, SRK and CDE pairs at H=HH=128 and 256 with one inner layer
     (B=128, L=24: the weights past a block's shared memory, each plan
     printed); the EM and SRK pairs' weight-gradient
     kernels alone against their plain versions at the sepsis and MuJoCo
     shapes and at H=HH=128 and 256 (B=128, L=24); the GRU pair (with and
     without the decay stream) and the LSTM pair at the sweep's shape
     (B=64, L=60, H=16, and H=8 for the bilstm's directions), at the JAX
     package's recurrent bench shapes (tools/bench_cde.py:159-177:
     B=1024, L=72, C=6, H=32, 64, 128), both pairs at their plans'
     boundaries (the LSTM at H=96: one CTA; 200: a cluster of 4; 256: of
     8; the GRU at H=96, 128, 200, 256, with and without its decay; each
     plan printed), at H=512 with B=16 (the W_hh slices in device memory)
     and at a ragged B=100; fused_gru_scan against the eager loop in both
     directions, with and without the decay, at the sweep's shape and at
     H=128; and the weight-gradient kernel alone (the GRU's, with and
     without the decay, and the LSTM's) at the sweep's shape and at
     H=128: the trajectory and every backward output, within
     stated tolerances of the float32 plain version, and no further from
     a float64 run of the plain version than a small multiple of the
     float32 plain version's own error; the GRU and LSTM kernels at
     the bench shapes against cuDNN (torch.nn.GRU/LSTM, same weights);
     and the EM and SRK pairs' new modes (compare_modes): the drift modes
     'yy' and 'xt' and the noise modes 'elem', 'net1' and 'net2', every
     drift mode with every new noise mode at least once (MODE_CONFIGS:
     (0,7) and (6,7) on states of either sign), at B=128, L=12 and the
     sweep's width (H=16) and the sepsis width (H=49, C=69), net2 (2,19)
     also at H=HH=128 and 256 with its plans printed, and the
     weight-gradient kernels alone for (1,18) and (3,15), their
     trajectories and cotangents by the float64 rule (sqrt noise near 0
     amplifies float32 rounding); and the configurations of phase 4's new
     paths at those paths' own shapes (compare_path_modes): naivesde
     (1,18) through the EM pair at the sepsis shape, and each SRK sweep
     name (SDE_SWEEP_MODELS) at the sweep's shape, with their
     weight-gradient kernels alone;
  4. main paths, each with every launch count set to 0 just before it and
     read just after: the sepsis harness `run_sepsis` (neurallnsde, H=49,
     batch 1024, C=69) on synthetic_sepsis(n=4096) for 2 epochs, which
     must launch both EM kernels; the forecasting harness `run_mujoco`
     (neurallnsde, H=32, two hidden layers, batch 1024, srk) on 4000
     synthetic MuJoCo windows for 2 epochs, which must launch the three
     SRK kernels; the robustness sweep `run_robustness_sweep` (neuralcde,
     hidden 16, batch 64, missing rate 0.3, seed 0) on the shape of
     tools/run_sweep_cd.py's uea_b_noisy set (320 series, L=60, 5
     channels, 2 classes) for 2 epochs, which must launch both CDE kernels
     and write records with an accuracy and no error; the losses must be
     finite, and each trained model's fused solve must match the eager
     solver on a small batch (the SDEs with the same Brownian increments);
     then the same sweep cell with `gru`, `grud`, `lstm` and `bilstm`, one
     model a run with the counts set to 0 before each, each of which must
     launch both kernels of its pair, write a record with an accuracy and
     no error, and whose trained recurrence through the kernels must match
     its eager loop on a small batch; the sweep cell with the SDE stream
     names neuralsde_2_16, neuralsde_4_17, neuralsde_6_17 and
     neuralsde_3_18 (srk), one model a run, each of which must launch the
     three SRK kernels, write a record with an accuracy and no error, give
     a finite loss, and whose trained field's fused solve must match the
     eager one; the sepsis harness at hidden 128 (the interpolation
     flagship encoder's width) for one epoch, which must launch the three
     EM kernels with finite losses; and the sepsis harness with naivesde
     (1,18: drift 'yy', noise 'net2') at the flagship width for one
     epoch, which must launch the three EM kernels with finite losses and
     whose trained field's fused solve must match the eager one;
  5. times: the natural cubic fit of the forecasting windows on the host
     by each of its two paths (host clock, median of 3); each kernel and
     its plain version (the CDE pair at the sweep's shape and at both
     bench shapes; the GRU and LSTM pairs, and cuDNN's forward, backward
     and both, at the sweep's shape and the bench shapes; each recurrent
     and SDE backward's recurrence and weight-gradient kernels apart, the
     weight gradient beside torch.matmul of its products, and fused_*_scan
     forward + backward, projection included, beside cuDNN's forward +
     backward), the wide route (the EM and SRK pairs at the sepsis shape
     and the CDE pair at uea_rk4, H=HH=128 and 256), and one full
     training step (forward + backward + Adam) of each path through the
     kernels and through the eager solver (CUDA events, median of 30
     after warm-up; the CDE step is the uea_rk4 classifier at B=1024, the
     recurrent steps the gru and lstm classifiers at B=1024, L=72, H=32);
     a torch.profiler window of each kernel step gives device time by
     kernel and the device's busy share; and the new modes' kernels
     (MODE_TIMES: (0,7), (3,15), (1,18)) at the sweep's shape and the
     sepsis width, with their bounds (mode_kernel_times);
  6. the member axis (seed ensembles), in phases 3-5's places: each
     MEMBER_CASES launch (the EM pair at the sepsis shape with five members,
     the SRK pair at the sweep's shape with three, each member on its own
     weights and streams, each pair with (4,17) and a noise net's
     configuration) bit for bit the solo launches of its
     members under forced plans, a one-member launch bit for bit the solo
     launch, and each member against the plain versions under the plan's
     own choice (compare_members); the whole sepsis model (C=69, H=49,
     two hidden layers, (4,17), B=32) through the EM kernels against the
     JAX package's loss and every gradient in
     tests/goldens/sepsis_whole_model.npz (whole_model_check); the sepsis
     flagship's five repeats as one ensemble (run_sepsis_ensemble) for 2
     epochs, which must launch the packed EM kernels and no solo one; the
     sweep cell with pack_seeds for neuralsde_4_17 (three seeds, the
     packed SRK kernels), and neuralcde and gru-ode (the packed CDE
     kernels, no solo CDE launch); the packed launches against as
     many solo launches and their plain versions, with their bounds
     (packed_kernel_times); and the ensemble's training step against five
     solo steps, wall and device time (ensemble_step_times);
  7. Speech Commands and the latent SDE, in phases 3-5's places: the EM
     pair at the speech flagship's shape (SPEECH: B=1024, L=161, C=21,
     H=HH=49, two hidden layers, (4,17)) against its plain versions; the
     latent pair (LatentSDE's augmented system, fused_latent_em_solve's
     inputs) at the sweep's shape (B=64, L=60: 106 steps, C=6, H=16, no
     inner layer) and at H=HH=128 with one inner layer, under the forced
     cluster sizes 1, 2 and 4 and the plan's own choice, its trajectory
     (the KL lane's) and cotangents by the float64 rule and its latent
     lanes by TOL_YS, the forward's bits the same under every plan
     (compare_latent), and its weight-gradient kernel alone; run_speech at
     full width on synthetic_speech(n=2048) for 2 epochs (the EM kernels,
     finite losses, the trained field's fused solve against the eager
     one), run_speech_ensemble with five repeats for 1 epoch (the packed
     EM kernels and no solo launch), and the sweep cell with latentsde and
     latentsde-kl, one model a run (the latent kernels, a record with an
     accuracy, a finite loss and KL term, the trained model's fused latent
     solve against the eager sdeint(f_aug, g_aug), KL lane included); the
     latent pair's times and bounds at the sweep's shape, the EM pair's at
     the speech shape, and one speech training step through the kernels
     and the eager solver with its profiler window;
  8. the ODE-RNN hybrids, in phases 3-5's places: each instance of the
     GRU pair's obs, decay-row and evolve modes and the LSTM pair's evolve
     (RNN_MODES) against its plain version by compare_rnn's rules, at the
     sweep's shape (B=64, L=60, H=16; the evolve also with three layers
     and two substeps) and at H=256 (B=128, L=24: a cluster of 8), its
     plan printed (compare_rnn_modes); the sweep cell with gru-dt, gru-d,
     ode-rnn and ode-lstm in phase 4's recurrent runs, each of which must
     launch its own instances (RNN_PAIRS) and the weight-gradient kernels
     once a backward; and the instances' times and bounds at both shapes
     (rnn_modes_times);
  9. the time-aware LSTMs, in phases 3-5's places: each instance of the
     LSTM pair's sel, tg and TLSTM modes (RNN_MODES) against its plain
     version by compare_rnn's rules at the sweep's shape, at the plan's
     boundaries (H=96, 200, 256; B=128, L=24), at H=512 with B=16 (the
     slices in device memory) and at a ragged B=100, each plan printed,
     TLSTM's W_d gradient among the cotangents; the sweep cell with tlstm,
     plstm and tglstm, one model a run, each of which must launch its own
     instances (RNN_PAIRS), the weight-gradient kernels once a backward
     (TLSTM's W_d gradient too) and no eager step of its cells, and whose
     trained layers through the kernels must match their eager loops; the
     sweep cell with cnn and transformer (no kernel: none may launch);
     the instances' times and bounds at the sweep's shape and at H=256,
     and one tlstm training step at the sweep cell through the kernels and
     through the eager loop with its profiler window;
 10. the CDE pair's GRU-ODE field and member axis, in phases 3-6's
     places: the gruode instances against their plain versions, the
     trajectory and every cotangent by the float64 rule (compare_gruode:
     the sweep cell B=64, L=60 (106 rk4 steps), C=6, H=16; the JAX
     package's gruode_rk4 bench shape B=1024, L=72 (136 steps), C=6,
     H=32; euler, midpoint and heun at B=128; H=128 and 256 at B=128,
     L=24, the gates past a CTA's shared memory; every plan level forced
     once; a ragged B=100; each plan printed); the member axis at the
     sweep cell with three FinalTanh and three GRU-ODE members, each on its
     own weights and control stream, each member bit for bit its solo
     launch under forced plans, at K=1 and under the packed launch's own
     plans (compare_cde_members), and the packed latent solve at the
     sweep's shape, each member bit for bit its solo latent launch, also
     through fused_latent_em_solve_packed (compare_latent_members); the
     sweep cell with gru-ode for 2 epochs, which must launch the gruode
     instances and never the eager cdeint, with a finite loss and its
     trained field's fused solve against the eager one
     (gruode_sweep_path); the seed-packed neuralcde and gru-ode cells in
     phase 6's run; the gruode instances' times and bounds at both
     shapes beside FinalTanh's, the packed launch against three solo
     launches (cde_packed_kernel_times), and one gru-ode training step at
     the sweep cell through the kernels and with use_fused=False, with its
     profiler window;
 11. the linear controls and the solvers no kernel takes, in phases
     3-5's places: the CDE pair against its plain versions on both linear
     streams at the sweep cell (compare_linear_cde: neuralcde-l's knot
     values over linspace(0, 1, 60), 106 rk4 steps, stage times on and
     within one ulp of knots; neuralcde-r's rectilinear knots stepped on
     their index, 118 steps; the trajectory and every cotangent, ddx
     included, by check_pair_rows); sdeint_adaptive and the five adaptive
     and extra ODE solvers at B=64, H=16 on the card against the CPU, in
     float64 (compare_solvers_card_vs_cpu); the sweep cell with
     neuralcde-l and neuralcde-r for 2 epochs each (linear_sweep_path:
     the CDE kernels launched, the eager cdeint never, a finite loss, the
     trained solve through the kernels against the eager one); run_mujoco
     with milstein and with heun for 1 epoch each at the MuJoCo shape
     (sde_method_mujoco_path: finite MSEs, no EM or SRK launch, the
     trained field's solve on the card against the CPU on one
     BrownianGrid); the pair's times and bounds on both linear streams
     (cde_linear_kernel_times, in the kernels line's CDE entries), one
     neuralcde-l training step through the kernels and with
     use_fused=False, one milstein training step at the MuJoCo shape with
     its profiler window, and each adaptive solver's time a solve and a
     trial step at B=1024, H=32 (adaptive_solver_times);
 12. the rest of the model zoo, in phases 3-5's places: the CDE pair
     against its plain versions on the streams the registry layers make
     at the sweep cell (compare_zoo_cde: NeuralRDE's log-signature stream
     at depths 1-3, C = 6, 21, 91, 23 rk4 steps; ANCDE's bottom field, H =
     C = 6, and its top field on the re-fit gated Hermite stream; every
     cotangent, ddx included, by check_pair_rows); a fresh ancde layer's
     gradients through the kernels against the eager solves, the gate's
     through the top stream's ddx (check_ancde_gate_grad); the GRU pair on
     mTAN's BiGRU (B=64, L=60, H=16) forward and reverse against the eager
     loop, every cotangent the input's included (compare_mtan_bigru); the
     sweep cell with ancde, exit, leap, neuralrde-1/2/3, mtan, sand and
     miam for 2 epochs and each family x flow option once for 1 epoch
     (zoo_sweep_path: a record with an accuracy and no error, the CDE
     pair's launches per layer call, no eager cdeint, mtan's GRU pair in
     both directions, no kernel for sand, miam and neuralflow_*; the
     trained ancde and neuralrde-3 layers through the kernels against
     use_fused=False on 16 rows), the other 32 flow names one forward
     each; the CDE pair's times and bounds on NeuralRDE-3's stream and
     ANCDE's two solves (zoo_cde_times), the GRU pair's in each direction
     at mTAN's shape (mtan_gru_times), both in the kernels line's CDE and
     GRU entries, and one training step of ancde, leap, neuralrde-3, mtan,
     sand, miam and neuralflowcde_z_c through the kernels and with
     use_fused=False, with its profiler window;
 13. the interpolation and activity harnesses, in phases 3-5's places: the
     EM pair against its plain versions at the interpolation encoder's
     shape (INTERP: B=64, 69 steps on the encoder's grid, C=37, H=HH=128,
     one hidden layer, a dense cotangent) for neuralsde_2_16, _4_17 and
     _6_17, each plan printed (compare_interp_em); the GRU pair at the VAE
     decoders' BiGRU (B=320, L=64, input 32, H=64) and the activity
     encoder's (B=128, L=50, H=32) against its plain versions and, through
     fused_gru_scan in both directions, against the eager loop, every
     cotangent the input's included (compare_interp_gru); scatter_to_ref
     on the card bit for bit its CPU result on records with a repeated
     bucket (check_interp_scatter); run_interpolation at the flagship
     width on n=8000 synthetic PhysioNet-shaped records (L=62, D=36;
     latent 32, gen_hidden 64, k_iwae 5, batch 64) for 2 iterations with
     neuralsde_2_16 and rnn3 and 1 each with _4_17, _6_17 and with
     mtan_rnn (interp_path: finite ELBOs and test_mse, the EM kernels once
     a batch and never the eager sdeint, the GRU kernels in both
     directions, the trained encoder's stream through the kernels against
     use_fused=False on 16 rows, a resume at n=256 against the straight
     run to 1e-4); run_activity at its published settings for 2 epochs
     (activity_path: finite losses, the GRU kernels in both directions,
     155623 parameters); the EM pair's times and bounds at the encoder's
     shape and the GRU pair's at both BiGRU shapes in each direction, in
     the kernels line's EM and GRU entries (interp_em_times,
     interp_gru_times), and one training step of interpolation (rnn3,
     mtan_rnn) and activity through the kernels and with use_fused=False,
     with its profiler window.
It prints one JSON line of the kernels (each SDE kernel with the `modes`
it takes; the packed launches, the hybrids' and the time-aware LSTMs'
instances, TLSTM's W_d gradient and the CDE pair's gruode instances and
packed launches as their own entries, the recurrent
modes with their H=256 times, the CDE pair's with its linear streams'
and phase 12's streams' times and launches, the GRU pair's with mTAN's
and phase 13's BiGRUs', the EM pair's with the interpolation encoder's),
the card's name and
power limit, and last `{"ok": true, "device": {...}}`. It exits non-zero,
printing no result, without a CUDA device or outside the repository.

    python3 chip_smoke.py --ab-steps PARENT_DIR [PAIRS [REPS]]
    python3 chip_smoke.py --ab-lstm PARENT_DIR [PAIRS [REPS]]
    python3 chip_smoke.py --ab-gru PARENT_DIR [PAIRS [REPS]]
    python3 chip_smoke.py --ab-kernels PARENT_DIR [PAIRS [REPS]]
    python3 chip_smoke.py --ab-cde PARENT_DIR [PAIRS [REPS]]
    python3 chip_smoke.py --phase-split [em|srk|cde] TREE [TREE ...]
    python3 chip_smoke.py --sweep-cd OUT [EPOCHS [SEEDS [PACK]]]
    python3 chip_smoke.py --sepsis-r5 [OUT]
    python3 chip_smoke.py --speech-r5 [OUT]
    python3 chip_smoke.py --interp-flagship [OUT]
    python3 chip_smoke.py --activity-r5 [OUT]

run none of the phases: they time the SDE paths' training steps
and the CDE classifier's (`ab_steps`), the LSTM or GRU kernels at the
sweep's and the bench shapes
(`ab_rnn`), the EM, SRK and CDE kernels at the main paths' shapes and the
EM and SRK pairs also at H=HH=128 and 256 (`ab_kernels`), or the CDE pair
at the sweep's shape, both bench shapes and H=HH=128 and 256 (`ab_cde`), of
a parent checkout against this one, in alternating processes; split one
EM, SRK or CDE launch of each tree by phase (`phase_split`); or run the
port's counterpart of tools/run_sweep_cd.py (`sweep_cd`: 5 datasets x 4
missing rates x 6 models x SEEDS, the SDE and CDE cells seed-packed
unless PACK is 0, then the critical-difference analysis, written to OUT
with SWEEP_CD.json's keys); or train the sepsis flagship's five repeats
for 40 epochs as one ensemble (`sepsis_r5`, RESULTS_sepsis_r5.json's
layout, to OUT, by default RESULTS_torch_sepsis_r5.json), or the speech
flagship's (`speech_r5`: n=8192, RESULTS_speech_r5.json's layout, by
default RESULTS_torch_speech_r5.json); or train the interpolation flagship
at rec_hidden 128 for 300 iterations (`interp_flagship`: its test_mse
beside RESULTS_interpolation_h128.json's and held to the interpolation
pin's ceiling, by default to RESULTS_torch_interpolation_h128.json), or
the activity flagship's five seeds for 200 epochs with warmup_epochs 5
(`activity_r5`: beside RESULTS_activity_k5.json, each seed held to the
activity pin's floor, by default to RESULTS_torch_activity_k5.json).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
MAIN = dict(B=1024, L=72, C=69, H=49, layers=2, model="neurallnsde")
# the MuJoCo forecasting path (tools/run_real_mujoco.py:42-56, --method srk)
SRK = dict(B=1024, L=50, C=14, H=32, layers=2, model="neurallnsde", T=10)
# the Neural CDE bench shapes (tools/bench_cde.py:150-151): FinalTanh with
# num_hidden_layers=2 (one inner layer), rk4 on the knots of
# linspace(0, 1, L) with dt their smallest gap (136 steps at L=72)
CDE = {"uea_rk4": dict(B=1024, L=72, C=6, H=32, n_inner=1),
       "sepsis_rk4": dict(B=1024, L=72, C=35, H=32, n_inner=1)}
# the sweep cell (tools/run_sweep_cd.py: uea_b_noisy, neuralcde, hidden 16)
SWEEP = dict(n=320, L=60, D=5, classes=2, seed=50, noise=0.8, H=16, B=64)
# the recurrent baselines of the sweep cell: each recurrence reads the
# embedded stream (hidden 16); the bilstm runs 8 units per direction; and
# the ODE-RNN hybrids (the GRU pair's obs, decay-row and evolve modes, the
# LSTM pair's evolve)
RNN_MODELS = ("gru", "grud", "lstm", "bilstm", "gru-dt", "gru-d", "ode-rnn",
              "ode-lstm")
# the launch counters (read_counts keys) each recurrent name must move:
# its instances' forward and backward, and the weight-gradient kernel
# once a backward (W_hh's; with the evolve, its layers' too)
RNN_PAIRS = {"gru": ("gru", "gru_wgrad"), "grud": ("gru", "gru_wgrad"),
             "lstm": ("lstm", "lstm_wgrad"), "bilstm": ("lstm", "lstm_wgrad"),
             "gru-dt": ("gru_obs", "gru_wgrad"),
             "gru-d": ("gru_dec1", "gru_wgrad"),
             "ode-rnn": ("gru_ode", "gru_wgrad", "mlp_wgrad"),
             "ode-lstm": ("lstm_ode", "lstm_wgrad", "mlp_wgrad"),
             "tlstm": ("lstm_tlstm", "lstm_wgrad", "lstm_wd_wgrad"),
             "plstm": ("lstm_sel", "lstm_wgrad"),
             "tglstm": ("lstm_tg", "lstm_wgrad")}
# phase 9's names on the sweep cell: the time-aware LSTMs (the LSTM pair's
# sel, tg and TLSTM modes), and the convolution and attention baselines,
# which run no kernel
TIME_MODELS = ("tlstm", "plstm", "tglstm")
BASELINE_MODELS = ("cnn", "transformer")
# the hybrids' and the time-aware LSTMs' kernel instances: (pair, mode,
# JSON name suffix); mode as fused_rnn's (GRU 1 obs, 2 the decay row, 3
# the evolve; LSTM 1 the evolve, 2 sel, 3 tg, 4 TLSTM)
RNN_MODES = (("gru", 1, "obs"), ("gru", 2, "dec1"), ("gru", 3, "ode"),
             ("lstm", 1, "ode"), ("lstm", 2, "sel"), ("lstm", 3, "tg"),
             ("lstm", 4, "tlstm"))
TIME_MODES = ("sel", "tg", "tlstm")
# the time-aware modes' further shapes (B, L, H): the LSTM plan's
# boundaries (one CTA at H=96, a cluster of 4 at 200; 8 at 256 is
# RNN_MODE_WIDE's), the slices in device memory (H=512, B=16) and a
# ragged batch
TIME_MODE_SHAPES = ((128, 24, 96), (128, 24, 200), (16, 20, 512),
                    (100, 30, 32))
# their shapes beside the sweep's: a width whose plan splits W_hh over a
# cluster of 8 (the evolve run by every CTA of it), at a cut batch and
# length
RNN_MODE_WIDE = dict(B=128, L=24, H=256)
RNN_SWEEP = dict(B=SWEEP["B"], L=SWEEP["L"], C=SWEEP["H"], H=SWEEP["H"])
# the JAX package's recurrent bench shapes (tools/bench_cde.py:159-177)
RNN_BENCH = {f"{kind}{sfx}": dict(kind=kind, B=1024, L=72, C=6, H=h)
             for sfx, h in (("", 32), ("_h64", 64), ("_h128", 128))
             for kind in ("gru", "lstm")}
# widths at the LSTM plan's boundaries (one CTA, clusters of 4 and 8), at
# the bench batch and length
LSTM_PLAN_H = (96, 200, 256)
# and the GRU's (one CTA, clusters of 2, 4 and 8, W_hh in device memory)
GRU_PLAN_H = (96, 128, 200, 256, 512)
# the SDE and CDE pairs past a block's shared memory: H = HH, one inner
# layer (the sepsis and CDE bench depth), at a cut batch and length
WIDE_H = (128, 256)
WIDE = dict(B=128, L=24)
# the sepsis path at the interpolation flagship encoder's width
# (RESULTS_interpolation_h128.json), one epoch
SEPSIS_WIDE = dict(H=128, epochs=1)
# Largest error of a trajectory against the float32 plain version, over
# the plain trajectory's largest entry: at most TOL_YS for the SDE pairs
# (and a trained SDE field's fused solve against the eager one); for the
# CDE pair, at most the larger of TOL_YS and YS_F64_FACTOR times the
# float32 plain version's own largest error from float64 at the same shape
# (both over max|ys|). (Before: 5e-5 absolute, which the plain version
# itself missed at the sepsis width.) Readings on an H100 (PERF.md,
# section 6), kernel vs plain / plain from float64:
#   EM sepsis 3.4e-7 / 3.9e-7; SRK MuJoCo 5.8e-7 / 6.4e-7, sepsis width
#   5.8e-7 / 1.8e-6 (max|ys| 70, 36, 72);
#   CDE sweep shape 2.1e-5 / 2.4e-5, uea_rk4 1.2e-6 / 1.2e-6, sepsis_rk4
#   4.8e-5 / 6.1e-5, the B=128 variants 7.5e-7-8.9e-6 / 7.1e-7-5.2e-6
#   (max|ys| 4-61).
# The CDE solves on a rough control amplify float32 rounding (~100x on
# the sweep shape: a 1e-7 relative change of every input moves ys by
# 1.1e-5 of max|ys|, in float64 on the CPU), so the floor alone would
# fail a correct kernel there. Two float32 runs differ by at most the sum
# of their errors from float64, and a run's largest error moves several-
# fold with the order of summation alone (4.7x on the EM pair), so 8x;
# the readings reach 1.8x. The SDE readings sit 8x or more under the
# floor, so it holds them alone.
TOL_YS = 5e-6
YS_F64_FACTOR = 8.0
# max abs error of a cotangent over its max (measured: EM 4.1e-7, SRK 4.6e-6)
TOL_GRAD = 1e-5
# every output against a float64 run of the plain version: the kernel's
# root-mean-square error, over the largest entry, may be at most
# F64_FACTOR times the float32 plain version's own, plus F64_FLOOR
# (tests/test_torch_cuda.py's rule, and why the mean square)
F64_FACTOR = 4.0
F64_FLOOR = 1e-5
REPS, WARMUP = 30, 5
EAGER_REPS = 5      # the eager training steps launch ~10^4 kernels each
N_SEPSIS = 4096     # samples of synthetic_sepsis on the main path
N_MUJOCO = 4000     # windows: 100 trajectories x 40, as the bank gives
DEV = "cuda"


# every kernel source
SOURCES = ["fused_em", "fused_srk", "fused_cde", "fused_rnn"]
# every mode the SDE pairs' kernels take
SDE_MODES = ["embm", "yy", "xt", "precomp", "elem", "net1", "net2"]
# phase 4's new paths: the sweep's SDE stream names (srk), and the sepsis
# harness with the README's naivesde (1,18) (euler) for one epoch
SDE_SWEEP_MODELS = ("neuralsde_2_16", "neuralsde_4_17", "neuralsde_6_17",
                    "neuralsde_3_18")
NAIVE = dict(model="naivesde", epochs=1)
# phase 5's new modes (each drift mode, each new noise mode) and shapes
MODE_TIMES = ((0, 7), (3, 15), (1, 18))


def card() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {name} | nvidia-smi: {smi}", flush=True)
    return smi


def build():
    from snsde_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")


def kernel_inputs(model_name, B, L, C, H, layers, seed=0, srk=False):
    """Detached kernel inputs of a random field on a random control path,
    with Brownian increments (and, for srk, the Lévy area) from numpy, on
    the card."""
    from snsde_torch.harness.classification import make_sde_model
    from snsde_torch.kernels.fused_em import fused_em_inputs
    from snsde_torch.kernels.fused_srk import fused_srk_inputs
    from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    sde, _ = make_sde_model(model_name, C, H, H, layers, 1, generator=gen)
    field = sde.func.to(DEV)
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times), x).to(DEV),
                     times)
    grid, _ = make_grid(times, 1.0)
    M = grid.shape[0] - 1
    dW = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32))
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    with torch.no_grad():
        if srk:
            I10 = torch.as_tensor(levy_area(rng, dW.numpy()))
            inp = fused_srk_inputs(field.bind(path), path, grid, y0,
                                   dW.to(DEV), I10.to(DEV))
        else:
            inp = fused_em_inputs(field.bind(path), path, grid, y0,
                                  dW.to(DEV))
    inp = {k: (v.detach().contiguous() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    # the cotangent of a batch-mean loss: O(1/B) per entry
    gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32) / B)
    return inp, gys.to(DEV)


def levy_area(rng, dW, dt=1.0):
    """I10 = dt/2 (dW + dZ sqrt(dt)/sqrt(3)) for unit steps, from numpy."""
    dZ = rng.normal(size=dW.shape) * np.sqrt(dt)
    return (0.5 * dt * (dW + dZ / np.sqrt(3.0))).astype(np.float32)


def _split(inp, srk=False):
    """(the forward's tensor inputs in order, None where the modes take
    none; the mode flags) of an SDE pair."""
    from snsde_torch.kernels import fused_em as fe
    from snsde_torch.kernels import fused_srk as fs

    mod = fs if srk else fe
    return ([inp[k] for k in mod._ARG_ORDER],
            {k: inp[k] for k in mod._MODE_KEYS})


def _dbl(t):
    """A float64 copy of a tensor, or of a NamedTuple's tensors (None
    kept)."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return type(t)(*(_dbl(v) for v in t))
    return t.double()


def _kernel_modules():
    from snsde_torch.kernels import fused_cde, fused_em, fused_srk

    return {"em": fused_em, "srk": fused_srk, "cde": fused_cde}


def kernel_fns(key):
    """(forward, plain forward, backward, plain backward) of the pair
    'em', 'srk' or 'cde', each forward returning (ys, the noise nets'
    streams or None) and each backward taking those streams as `ns` (the
    CDE pair's forwards, which return ys alone, and backwards, which take
    no streams, wrapped to that form)."""
    mod = _kernel_modules()[key]
    fns = tuple(getattr(mod, f"fused_{key}_{n}") for n in (
        "forward", "forward_reference", "backward", "backward_reference"))
    if key != "cde":
        return fns

    def fwd(f):
        return lambda *a, **k: (f(*a, **k), None)

    def bwd(f):
        return lambda *a, ns=None, **k: f(*a, **k)
    return fwd(fns[0]), fwd(fns[1]), bwd(fns[2]), bwd(fns[3])


def _errs64(a, ref):
    """(largest, root-mean-square) error of a float32 result from its
    float64 counterpart, each over the largest entry of the float64
    result."""
    d = a.double() - ref
    scale = max(float(ref.abs().max()), 1e-30)
    return (float(d.abs().max()) / scale,
            float(d.square().mean().sqrt()) / scale)


def check_pair(label, fns, fwd, flags, gys, ys_f64_factor=0.0,
               grad_f64_factor=0.0):
    """Kernel vs plain version on the same inputs; returns max abs errors
    of the forward and the backward (over all its outputs). The trajectory
    may differ by the larger of TOL_YS and ys_f64_factor times the float32
    plain version's own largest error from float64, both over its largest
    entry; each cotangent by the larger of TOL_GRAD and grad_f64_factor
    times the float32 plain version's own, over its largest entry. Each
    output is also held against a float64 run
    of the plain version: the kernel's root-mean-square error from it may
    be at most F64_FACTOR times the float32 plain version's own, plus
    F64_FLOOR (both over the largest entry)."""
    fwd_k, fwd_p, bwd_k, bwd_p = fns
    ys_k, ns_k = fwd_k(*fwd, **flags)
    ys_p, ns_p = fwd_p(*fwd, **flags)
    bwd_args = [fwd[0], ys_p, gys] + fwd[1:]
    g_k = bwd_k(*bwd_args, **flags, ns=ns_p)
    g_p = bwd_p(*bwd_args, **flags, ns=ns_p)
    in64 = [_dbl(t) for t in fwd]
    ys_64, ns_64 = fwd_p(*in64, **flags)
    g_64 = bwd_p(in64[0], ys_64, gys.double(), *in64[1:], **flags, ns=ns_64)
    torch.cuda.synchronize()

    def check64(name, k, p, ref):
        """Print and check the errors of k and p from float64; return the
        float32 plain version's largest error over the largest entry."""
        (k_max, k_rms), (p_max, p_rms) = _errs64(k, ref), _errs64(p, ref)
        print(f"      from float64 (max {float(ref.abs().max()):.3e}), "
              f"largest/rms: kernel {k_max:.3e}/{k_rms:.3e}, float32 plain "
              f"{p_max:.3e}/{p_rms:.3e} (tol rms {F64_FACTOR:g}x plain + "
              f"{F64_FLOOR:g})")
        if not k_rms <= F64_FACTOR * p_rms + F64_FLOOR:
            raise AssertionError(f"{label} {name}: kernel further from "
                                 f"float64 than the float32 plain version "
                                 f"allows")
        return p_max

    err_f = float((ys_k - ys_p).abs().max())
    rel_f = err_f / max(float(ys_p.abs().max()), 1e-30)
    print(f"  {label}: ys max abs err {err_f:.3e} rel {rel_f:.3e}")
    tol_f = max(TOL_YS, ys_f64_factor * check64("ys", ys_k, ys_p, ys_64))
    print(f"      ys tol rel {tol_f:.3e}")
    if not rel_f <= tol_f:
        raise AssertionError(f"{label}: forward kernel disagrees: {rel_f}")
    # a noise net's streams (stage states, outputs, hidden activations),
    # each by the trajectory's rule
    for name, a, b, ref in zip(ns_k._fields if ns_k else (), ns_k or (),
                               ns_p or (), ns_64 or ()):
        if b is None:
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        print(f"    {name:10s} max rel err {rel:.3e}")
        tol = max(TOL_YS, ys_f64_factor * check64(name, a, b, ref))
        if not rel <= tol:
            raise AssertionError(f"{label}: forward kernel disagrees on "
                                 f"{name}: {rel}")
    err_b = 0.0
    for name, a, b, ref in zip(g_k._fields, g_k, g_p, g_64):
        if b is None or b.numel() == 0:
            continue
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        err_b = max(err_b, err)
        p_max = check64(name, a, b, ref)
        tol_g = max(TOL_GRAD, grad_f64_factor * p_max)
        print(f"    d{name[1:]:9s} max abs err {err:.3e} rel {rel:.3e} "
              f"(tol rel {tol_g:.3g})")
        if not rel <= tol_g:
            raise AssertionError(f"{label}: backward kernel disagrees on "
                                 f"{name}")
    return err_f, err_b


def compare(model_name, B, L, C, H, layers, srk=False):
    """An SDE pair against its plain versions (check_pair)."""
    inp, gys = kernel_inputs(model_name, B, L, C, H, layers, srk=srk)
    fwd, flags = _split(inp, srk)
    return check_pair(f"{'SRK' if srk else 'EM'} {model_name} B={B} L={L} "
                      f"H={H}", kernel_fns("srk" if srk else "em"), fwd,
                      flags, gys)


def cde_kernel_inputs(B, L, C, H, n_inner, method="rk4", field="final_tanh",
                      seed=0):
    """Detached inputs of the CDE pair: a random field (FinalTanh with
    n_inner inner layers, SingleHiddenLayer, or with field "gruode" the
    GRU-ODE field, whose tensors of the MLP are None) on the natural cubic path
    of random series over linspace(0, 1, L), stepped with dt = the
    smallest knot gap (the NeuralCDE default), and a cotangent gys of a
    batch-mean loss; (tensors in the forward's order, flags, gys)."""
    from snsde_torch.kernels import fused_cde as fc
    from snsde_torch.models import (FinalTanh, GRUODEField,
                                    SingleHiddenLayer, resolve_dt)
    from snsde_torch.ops import CubicPath, make_grid, natural_cubic_coeffs

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    if field == "final_tanh":
        func = FinalTanh(C, H, H, n_inner + 1, generator=gen)
    elif field == "gruode":
        func = GRUODEField(C, H, generator=gen)
    else:
        func = SingleHiddenLayer(C, H, H, generator=gen)
    func = func.to(DEV)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    if field == "gruode":
        # a Brownian-like path (N(0, 1/L) steps): the GRU-ODE state feeds
        # back through its gates, and on independent N(0, 1) knots the
        # explicit solve itself diverges (past 1e11 in float64 at B=100,
        # L=30), where no float32 digit is left to compare
        x = np.cumsum(x / np.sqrt(L), axis=1, dtype=np.float32)
    x = torch.as_tensor(x)
    coeffs = natural_cubic_coeffs(torch.as_tensor(times), x, pack=True)
    path = CubicPath(coeffs.to(DEV), times)
    grid, _ = make_grid(times, resolve_dt(times, floor=0.0))
    z0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    with torch.no_grad():
        inp = fc.fused_cde_inputs(func, path, grid, z0, method)
    fwd = [None if inp[k] is None else inp[k].detach().contiguous()
           for k in fc._ARG_ORDER]
    M = len(grid) - 1
    gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32) / B)
    return fwd, dict(method=method, act=inp["act"]), gys.to(DEV)


def compare_cde(B, L, C, H, n_inner, method="rk4", field="final_tanh"):
    """The CDE pair's plan at the shape, and the pair against its plain
    versions (check_pair_rows; the GRU-ODE field's cotangents too by the
    float64 rule: its z feedback through three gates amplifies float32
    rounding)."""
    fwd, flags, gys = cde_kernel_inputs(B, L, C, H, n_inner, method, field)
    cde_plans([(B, H, C, n_inner)], method, flags["act"])
    return check_pair_rows(f"CDE {field} {method} n_inner={n_inner} B={B} "
                           f"L={L} (M={gys.shape[0]}) C={C} H={H}", "cde",
                           fwd, flags, gys, amplifies=field == "gruode")


def cde_plans(shapes, method="rk4", act="relu", members=1):
    """Print the CDE pair's plan at each (B, H, C, n_inner) (H = HH):
    level (0 everything in shared memory, 1 the hidden weights in device
    memory, 2 the hidden gradients too, 3 dWout too, 4 as 3 with the Wout
    slice in device memory and the hidden weights in shared memory, 5 every
    weight in device memory, 6 fewer rows), CTAs and batch rows a cluster,
    whether the backward keeps the stage activations, shared bytes a CTA
    and cudaOccupancyMaxActiveClusters; raise if one cannot be
    scheduled."""
    from snsde_torch.kernels import fused_cde as fc

    for B, H, C, n_inner in shapes:
        for backward in (False, True):
            p = fc.fused_cde_plan(B, H, H, C, n_inner, method, backward, act,
                                  members)
            print(f"  CDE plan B={B} H=HH={H} C={C} n_inner={n_inner} "
                  f"{act} K={members} "
                  f"{method} {'backward' if backward else 'forward'}: level "
                  f"{p['level']}, CS={p['cluster']}, {p['rows']} rows a "
                  f"cluster, stages {'kept' if p['keep'] else 'recomputed'}"
                  f", {p['smem_bytes']} shared bytes a CTA, "
                  f"cudaOccupancyMaxActiveClusters {p['active_clusters']}")
            if p["active_clusters"] < 1:
                raise AssertionError(f"CDE plan at B={B} H={H} C={C} cannot "
                                     f"be scheduled: {p}")


def sde_plans(key, shapes, drift="embm", noise="precomp"):
    """Print the EM or SRK pair's plan (key 'em' or 'srk') in a drift and
    noise mode at each (B, H, n_inner) (H = HH): level (0 the weight slices
    in shared memory, 1 the weights read from device memory), CTAs and
    batch rows a cluster, shared bytes a CTA and
    cudaOccupancyMaxActiveClusters; raise if one cannot be scheduled."""
    plan = getattr(_kernel_modules()[key], f"fused_{key}_plan")
    for B, H, n_inner in shapes:
        for backward in (False, True):
            p = plan(B, H, H, n_inner, backward, drift, noise)
            print(f"  {key.upper()} plan ({drift}, {noise}) B={B} H=HH={H} "
                  f"n_inner={n_inner} "
                  f"{'backward' if backward else 'forward'}: level "
                  f"{p['level']}, CS={p['cluster']}, {p['rows']} rows a "
                  f"cluster, {p['smem_bytes']} shared bytes a CTA, "
                  f"cudaOccupancyMaxActiveClusters {p['active_clusters']}")
            if p["active_clusters"] < 1:
                raise AssertionError(f"{key.upper()} plan at B={B} H={H} "
                                     f"cannot be scheduled: {p}")


def wgrad_plain(key, y0, ys, st, ns, flags):
    """The EM or SRK weight-gradient kernel's plain version on the
    recurrence's streams st and the forward's noise streams ns (None
    outside the nets' modes)."""
    mod = _kernel_modules()[key]
    plain = getattr(mod, f"fused_{key}_weight_grads_reference")
    mf = dict(drift=flags["drift"], noise=flags["noise"])
    nh = None if ns is None else ns.nh
    if key == "em":
        return plain(y0, ys, st.dxh, st.hs, st.es, st.dz3, st.q, st.dn,
                     st.dz2, nh, **mf)
    return plain(y0, ys, st.h01, st.dxh, st.hs, st.es, st.dz3, st.q,
                 None if ns is None else ns.nst, st.dn, st.dz2, nh, **mf)


def wgrad_kernel(key, y0, ys, st, ns, flags):
    """The EM or SRK weight-gradient kernel's wrapper on the streams."""
    fn = getattr(_kernel_modules()[key], f"fused_{key}_weight_grads")
    extra = (None if ns is None else ns.nh) if key == "em" else ns
    return fn(y0, ys, st, extra, drift=flags["drift"], noise=flags["noise"])


def sde_wgrad_args(key, model_name, B, L, C, H, layers):
    """An SDE weight-gradient kernel's inputs at a shape: y0, the plain
    trajectory, the plain backward recurrence's streams, the plain
    forward's noise streams (None outside the nets' modes) and the
    flags."""
    mod = _kernel_modules()[key]
    inp, gys = kernel_inputs(model_name, B, L, C, H, layers,
                             srk=key == "srk")
    fwd, flags = _split(inp, key == "srk")
    ys, ns = getattr(mod, f"fused_{key}_forward_reference")(*fwd, **flags)
    st = getattr(mod, f"fused_{key}_backward_recurrence_reference")(
        fwd[0], ys, gys, *fwd[1:], **flags, ns=ns)
    return fwd[0], ys, st, ns, flags


def compare_sde_wgrad(key, model_name, B, L, C, H, layers, args=None):
    """The EM or SRK weight-gradient kernel alone against its plain
    version on the plain recurrence's streams (`args`: sde_wgrad_args's,
    made here when None): every output within TOL_GRAD of its largest
    entry, and no further from a float64 run than the F64 rule allows.
    Returns the largest abs error."""
    y0, ys, st, ns, flags = args or sde_wgrad_args(key, model_name, B, L, C,
                                                   H, layers)
    k = wgrad_kernel(key, y0, ys, st, ns, flags)
    p = wgrad_plain(key, y0, ys, st, ns, flags)
    r = wgrad_plain(key, _dbl(y0), _dbl(ys), _dbl(st), _dbl(ns), flags)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b, ref in zip(p._fields, k, p, r):
        if b is None or not b.numel():
            continue
        e = float((a - b).abs().max())
        rel = e / max(float(b.abs().max()), 1e-30)
        (k_max, k_rms), (p_max, p_rms) = _errs64(a, ref), _errs64(b, ref)
        print(f"  {key.upper()} weight-gradient kernel {model_name} B={B} "
              f"L={L} H={H} "
              f"{name}: max abs err {e:.3e} rel {rel:.3e} (tol "
              f"{TOL_GRAD:g}); from float64 largest/rms: kernel "
              f"{k_max:.3e}/{k_rms:.3e}, float32 plain {p_max:.3e}/"
              f"{p_rms:.3e}")
        if not (rel <= TOL_GRAD and k_rms <= F64_FACTOR * p_rms + F64_FLOOR):
            raise AssertionError(f"{key.upper()} weight-gradient kernel "
                                 f"disagrees on {name}")
        worst = max(worst, e)
    return worst


# the batch axis of each SDE and CDE pair's batch-indexed forward inputs,
# by position, and of its batch-indexed cotangents, by name
BATCH_AXES = {"em": {0: 0, 1: 1, 2: 1}, "srk": {0: 0, 1: 1, 2: 1, 3: 1, 4: 1},
              "cde": {0: 0, 1: 1}}
ROW_GRADS = {"em": {"dy0": 0, "dxh": 1},
             "srk": {"dy0": 0, "dxh0": 1, "dxh1": 1},
             "cde": {"dz0": 0, "ddx": 1}}


class NearRelu:
    """A relu for the plain versions' `relu=` argument that finds the
    pre-activations float32 rounding may put on either side of 0: those
    within `margin` times the largest |pre-activation| of their evaluation
    (a sum of up to 256 products rounds to ~1e-7 of that scale). The
    relu's derivative jumps at 0, so where the kernel and a plain version
    round one to opposite sides, its row's cotangents differ by far more
    than rounding. `found` holds, evaluation by evaluation, the (row,
    unit) of each such pre-activation and its value over the scale; given
    `at` (another NearRelu's `found`), the values at those entries
    instead. With `flip` the near ones are taken on the other side of 0:
    a negative z as -z, a positive one as 0 (the plain backwards read the
    derivative from the output)."""

    def __init__(self, margin=1e-7, flip=False, at=None):
        self.margin, self.flip, self.at, self.found = margin, flip, at, []

    def __call__(self, z):
        a = z.abs()
        scale = max(float(a.max()), 1e-300)
        near = a < self.margin * scale
        idx = (self.at[len(self.found)][0] if self.at is not None
               else near.nonzero())
        self.found.append((idx, z[idx[:, 0], idx[:, 1]] / scale))
        h = torch.relu(z)
        return torch.where(near, torch.where(z > 0, 0.0, -z), h) \
            if self.flip else h

    def rows(self):
        """{row: [(evaluation, unit, pre-activation over its scale)]}."""
        out = {}
        for e, (idx, v) in enumerate(self.found):
            for (r, u), x in zip(idx.tolist(), v.tolist()):
                out.setdefault(r, []).append((e, u, x))
        return out


def check_near_rows(label, key, fwd, flags, gys, near, ys_f64_factor,
                    grad_f64_factor=0.0):
    """The rows check_pair_rows sets aside (`near`: NearRelu.rows() of a
    float64 run), each judged on the whole batch by its trajectory and
    its batch-indexed cotangents (ROW_GRADS) from the kernel against
    float64 runs of the plain version, one that takes the near relus as
    float64 does and one that takes them on the other side of 0 (NearRelu
    flip), and float32 runs of the plain version, the yardstick of every
    other row, taking its own near relus either way (at 136 rk4 steps on
    a rough control a float32 run's cotangents sit up to 1e-2 of their
    largest entry from float64's, so a float64 run cannot judge a row
    there). Each row must agree with one of the four: the trajectory
    within check_pair's limit, each cotangent within TOL_GRAD, over the
    largest entry of the batch. Prints for each row its near
    pre-activations in float64 and in the float32 plain version, and the
    errors from every run."""
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(key)
    ys_p, ns_p = fwd_p(*fwd, **flags)
    probe32 = NearRelu(at=near.found)
    fwd_p(*fwd, **flags, relu=probe32)
    ys_k, ns_k = fwd_k(*fwd, **flags)
    g_k = bwd_k(fwd[0], ys_k, gys, *fwd[1:], **flags, ns=ns_k)
    in64 = [_dbl(t) for t in fwd]
    rows = [n for n in ROW_GRADS[key] if getattr(g_k, n) is not None]
    refs = {}
    for side, flip, ins in (("as float64 rounds them", False, in64),
                            ("on the other side", True, in64),
                            ("as float32 rounds them", False, fwd),
                            ("on float32's other side", True, fwd)):
        g = gys.double() if ins is in64 else gys
        ys64, ns64 = fwd_p(*ins, **flags, relu=NearRelu(flip=flip))
        g64 = bwd_p(ins[0], ys64, g, *ins[1:], **flags,
                    relu=NearRelu(flip=flip), ns=ns64)
        refs[side] = {"ys": (ys64, 1), **{n: (getattr(g64, n),
                                              ROW_GRADS[key][n])
                                           for n in rows}}
    outs = {"ys": ys_k, **{n: getattr(g_k, n) for n in rows}}
    ys64 = refs["as float64 rounds them"]["ys"][0]
    g_p = bwd_p(fwd[0], ys_p, gys, *fwd[1:], **flags, ns=ns_p)
    tol = {"ys": max(TOL_YS, ys_f64_factor * _errs64(ys_p, ys64)[0]),
           **{n: max(TOL_GRAD, grad_f64_factor * _errs64(
               getattr(g_p, n), refs["as float64 rounds them"][n][0])[0])
              for n in rows}}
    z32 = probe32.rows()
    for r, entries in sorted(near.rows().items()):
        print(f"    {label} row {r}, near relus (evaluation, unit, float64 / "
              f"float32 plain pre-activation over its scale): " + ", ".join(
                  f"({e}, {u}, {x:.2e} / {x32:.2e})" for (e, u, x), (_, _, x32)
                  in zip(entries, z32[r])))
        worst = {}
        for side, ref in refs.items():
            errs = {n: float((outs[n].select(ax, r).double()
                              - v.select(ax, r)).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for n, (v, ax) in ref.items()}
            worst[side] = max(errs[n] / tol[n] for n in errs)
            print(f"      kernel from float64 with them {side}: " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (worst {worst[side]:.3g}x its tolerance)")
        if not min(worst.values()) <= 1.0:
            raise AssertionError(f"{label} row {r}: the kernel agrees with "
                                 f"neither side of its near relus")


def check_pair_rows(label, key, fwd, flags, gys, amplifies=False):
    """A pair against its plain versions: check_pair on the rows where
    float32 rounding cannot flip a relu (NearRelu on a float64 run of the
    plain forward; every row for a tanh field), and check_near_rows on
    the others. Returns check_pair's errors. The CDE pair's trajectory,
    and with `amplifies` (an SDE pair in the new modes, where sqrt noise
    near y = 0 amplifies float32 rounding) its trajectory and cotangents,
    are held by the float64 rule (YS_F64_FACTOR)."""
    factor = YS_F64_FACTOR if key == "cde" or amplifies else 0.0
    gfactor = YS_F64_FACTOR if amplifies else 0.0
    near = NearRelu()
    if flags.get("act", "relu") == "relu":
        kernel_fns(key)[1](*(_dbl(t) for t in fwd), **flags, relu=near)
    aside = sorted(near.rows())
    B = gys.shape[1]
    if aside:
        print(f"  {label}: rows {aside} of {B} set aside (a relu within "
              f"rounding of 0)")
    rows = torch.tensor([r for r in range(B) if r not in aside],
                        dtype=torch.long, device=gys.device)
    ins = BATCH_AXES[key]
    err = check_pair(f"{label} B={len(rows)}" if aside else label,
                     kernel_fns(key),
                     [t.index_select(ins[i], rows).contiguous()
                      if i in ins and aside and t is not None else t
                      for i, t in enumerate(fwd)],
                     flags, gys.index_select(1, rows).contiguous()
                     if aside else gys, ys_f64_factor=factor,
                     grad_f64_factor=gfactor)
    if aside:
        check_near_rows(label, key, fwd, flags, gys, near, factor, gfactor)
    return err


def compare_wide():
    """The EM, SRK and CDE pairs at H = HH in WIDE_H with one inner layer
    (their weights past a block's shared memory), at a
    cut batch and length, against their plain versions
    (check_pair_rows)."""
    for H in WIDE_H:
        for key in ("em", "srk"):
            sde_plans(key, [(WIDE["B"], H, 1), (MAIN["B"], H, 1)])
        cde_plans([(WIDE["B"], H, 6, 1), (CDE["uea_rk4"]["B"], H, 6, 1)])
        for key in ("em", "srk", "cde"):
            if key == "cde":
                fwd, flags, gys = cde_kernel_inputs(WIDE["B"], WIDE["L"], 6,
                                                    H, 1)
            else:
                sh = MAIN if key == "em" else SRK
                inp, gys = kernel_inputs(sh["model"], WIDE["B"], WIDE["L"],
                                         sh["C"], H, 2, srk=key == "srk")
                fwd, flags = _split(inp, key == "srk")
            check_pair_rows(f"{key.upper()} wide L={WIDE['L']} H=HH={H}",
                            key, fwd, flags, gys)


# Phase 3: the drift modes 'yy' and 'xt' and the noise modes 'elem', 'net1'
# and 'net2' of both SDE pairs, every drift mode with every new noise mode
# at least once ((0,7) and (6,7) on states of either sign), at a small
# batch and length
MODE_CONFIGS = ((0, 7), (1, 8), (3, 9), (5, 10), (0, 14), (3, 15), (1, 18),
                (5, 19), (6, 7), (4, 14), (2, 19))
MODE_SHAPE = dict(B=128, L=12, layers=2)


def mode_name(io, no):
    return f"neuralsde_{io}_{no}"


def compare_modes():
    """Both SDE pairs in every configuration of MODE_CONFIGS at the sweep's
    width (H=16) and the sepsis width (H=49, C=69), B=128, L=12, two
    hidden layers, against their plain versions (check_pair_rows: float32
    and float64); net2 (2,19) also at H=HH=128 and 256 with one inner
    layer (B=128, L=24), its plans printed; the weight-gradient kernels
    alone for (1,18) and (3,15) at the sepsis width. Returns the largest
    errors of each pair's forward and backward, and of its weight-gradient
    kernel."""
    err = {}
    for key in ("em", "srk"):
        worst = [0.0, 0.0]
        for io, no in MODE_CONFIGS:
            for H, C in ((SWEEP["H"], SWEEP["D"] + 1), (MAIN["H"], MAIN["C"])):
                inp, gys = kernel_inputs(mode_name(io, no), MODE_SHAPE["B"],
                                         MODE_SHAPE["L"], C, H,
                                         MODE_SHAPE["layers"],
                                         srk=key == "srk")
                fwd, flags = _split(inp, key == "srk")
                e = check_pair_rows(f"{key.upper()} ({io},{no}) "
                                    f"({flags['drift']}, {flags['noise']}) "
                                    f"B={MODE_SHAPE['B']} L={MODE_SHAPE['L']}"
                                    f" H={H}", key, fwd, flags, gys,
                                    amplifies=True)
                worst = [max(a, b) for a, b in zip(worst, e)]
        for H in WIDE_H:
            sde_plans(key, [(WIDE["B"], H, 1), (MAIN["B"], H, 1)],
                      drift="embm", noise="net2")
            inp, gys = kernel_inputs(mode_name(2, 19), WIDE["B"], WIDE["L"],
                                     MAIN["C"], H, 2, srk=key == "srk")
            fwd, flags = _split(inp, key == "srk")
            check_pair_rows(f"{key.upper()} (2,19) wide L={WIDE['L']} "
                            f"H=HH={H}", key, fwd, flags, gys,
                            amplifies=True)
        err[f"{key}_modes"] = tuple(worst)
        err[f"{key}_modes_wgrad"] = max(
            compare_sde_wgrad(key, mode_name(io, no), MODE_SHAPE["B"],
                              MODE_SHAPE["L"], MAIN["C"], MAIN["H"],
                              MODE_SHAPE["layers"])
            for io, no in ((1, 18), (3, 15)))
    return err


# phase 4's new paths at their own shapes: (pair, model, B, L, C, H, hidden
# layers) of naivesde on the sepsis harness (euler) and of each SDE stream
# name on the sweep cell (srk, one hidden layer)
PATH_MODES = ((("em", NAIVE["model"], MAIN["B"], MAIN["L"], MAIN["C"],
                MAIN["H"], MAIN["layers"]),)
              + tuple(("srk", name, SWEEP["B"], SWEEP["L"], SWEEP["D"] + 1,
                       SWEEP["H"], 1) for name in SDE_SWEEP_MODELS))


def compare_path_modes():
    """Each PATH_MODES configuration at its path's shape against the plain
    versions (check_pair_rows; the new modes by the float64 rule, the
    'embm'+'precomp' fields by the strict one), and its weight-gradient
    kernel alone (compare_sde_wgrad). Returns the largest errors of each
    pair's forward and backward, and of its weight-gradient kernel."""
    err = {}
    for key, name, B, L, C, H, layers in PATH_MODES:
        inp, gys = kernel_inputs(name, B, L, C, H, layers, srk=key == "srk")
        fwd, flags = _split(inp, key == "srk")
        new = (flags["drift"], flags["noise"]) != ("embm", "precomp")
        e = check_pair_rows(f"{key.upper()} path {name} "
                            f"({flags['drift']}, {flags['noise']}) B={B} "
                            f"L={L} H={H}", key, fwd, flags, gys,
                            amplifies=new)
        w = compare_sde_wgrad(key, name, B, L, C, H, layers)
        f, b = err.get(f"{key}_paths", (0.0, 0.0))
        err[f"{key}_paths"] = (max(f, e[0]), max(b, e[1]))
        err[f"{key}_paths_wgrad"] = max(err.get(f"{key}_paths_wgrad", 0.0),
                                        w)
    return err


def wide_kernel_times(reps=5):
    """ms per launch of the wide route: the EM and SRK pairs at the
    sepsis shape (B=1024, 71 steps, C=69) and the CDE pair at uea_rk4
    (B=1024, 136 rk4 steps, C=6), each at H = HH in WIDE_H with one inner
    layer (median of `reps`; kernels only)."""
    ms = {}
    for H in WIDE_H:
        for key in ("em", "srk"):
            fwd_k, _, bwd_k, _ = kernel_fns(key)
            inp, gys = kernel_inputs(MAIN["model"], MAIN["B"], MAIN["L"],
                                     MAIN["C"], H, 2, srk=key == "srk")
            fwd, flags = _split(inp, key == "srk")
            ys, _ = fwd_k(*fwd, **flags)
            args = [fwd[0], ys, gys] + fwd[1:]
            ms[f"{key} H={H} fwd"] = timed(lambda: fwd_k(*fwd, **flags),
                                           reps=reps, warmup=1)
            ms[f"{key} H={H} bwd"] = timed(lambda: bwd_k(*args, **flags),
                                           reps=reps, warmup=1)
        fwd_k, _, bwd_k, _ = kernel_fns("cde")
        sh = CDE["uea_rk4"]
        fwd, flags, gys = cde_kernel_inputs(sh["B"], sh["L"], sh["C"], H, 1)
        ys, _ = fwd_k(*fwd, **flags)
        args = [fwd[0], ys, gys] + fwd[1:]
        ms[f"cde H={H} fwd"] = timed(lambda: fwd_k(*fwd, **flags),
                                     reps=reps, warmup=1)
        ms[f"cde H={H} bwd"] = timed(lambda: bwd_k(*args, **flags),
                                     reps=reps, warmup=1)
        print(f"wide route at H=HH={H}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items() if f"H={H} " in k),
            flush=True)
    return ms


def main_config(H=None):
    from snsde_torch.harness.classification import HarnessConfig

    H = H or MAIN["H"]
    return HarnessConfig(model_name=MAIN["model"], hidden_channels=H,
                         hidden_hidden_channels=H,
                         num_hidden_layers=MAIN["layers"],
                         batch_size=MAIN["B"])


def _counters():
    """(key, module, attribute) of every kernel's launch count."""
    from snsde_torch.kernels import fused_rnn

    out = [(f"{key}_{part}", mod, f"{part.upper()}_LAUNCHES")
           for key, mod in _kernel_modules().items()
           for part in ("fwd", "bwd")]
    out += [(f"{key}_wgrad", _kernel_modules()[key], "WGRAD_LAUNCHES")
            for key in ("em", "srk")]
    out += [(f"{key}_packed_{part}", _kernel_modules()[key],
             f"PACKED_{part.upper()}_LAUNCHES")
            for key in ("em", "srk") for part in ("fwd", "bwd", "wgrad")]
    out += [(f"em_latent_{part}", _kernel_modules()["em"],
             f"LATENT_{part.upper()}_LAUNCHES") for part in ("fwd", "bwd")]
    out += [(f"cde_{kind}_{part}", _kernel_modules()["cde"],
             f"{kind.upper()}_{part.upper()}_LAUNCHES")
            for kind in ("gru", "packed") for part in ("fwd", "bwd")]
    out += [(f"{key}_{part}", fused_rnn,
             f"{key.upper()}_{part.upper()}_LAUNCHES")
            for key in ("gru", "lstm") for part in ("fwd", "bwd", "wgrad")]
    out += [(f"{key}_{part}", fused_rnn,
             f"{key.upper()}_{part.upper()}_LAUNCHES")
            for key in ("gru_obs", "gru_dec1", "gru_ode", "lstm_ode",
                        "lstm_sel", "lstm_tg", "lstm_tlstm")
            for part in ("fwd", "bwd")]
    return out + [("mlp_wgrad", fused_rnn, "MLP_WGRAD_LAUNCHES"),
                  ("lstm_wd_wgrad", fused_rnn, "LSTM_WD_WGRAD_LAUNCHES")]


def zero_counts():
    """Set the launch count of every kernel to 0."""
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def read_counts():
    return {key: getattr(mod, attr) for key, mod, attr in _counters()}


def main_path():
    """The sepsis path; returns the launch counts of its run."""
    from snsde_torch.harness.classification import run_sepsis

    cfg = main_config()
    zero_counts()
    t0 = time.perf_counter()
    res = run_sepsis(cfg, n=N_SEPSIS, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    losses = [h[s]["loss"] for h in res.history for s in ("train", "val")]
    losses += [res.train_metrics.loss, res.val_metrics.loss,
               res.test_metrics.loss]
    print(f"main path 1: run_sepsis 2 epochs in {wall:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, val AUROC "
          f"{res.val_metrics.auroc:.4f}, test AUROC "
          f"{res.test_metrics.auroc:.4f}, launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss on the sepsis path")
    if min(launches[f"em_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"sepsis path did not run the kernels: "
                             f"{launches}")
    check_trained_solve(res.model.sde.func, MAIN)
    return launches


def wide_sepsis_path():
    """The sepsis path at hidden SEPSIS_WIDE["H"] = 128 for one epoch: the
    EM kernels take the field in their plan for that width (printed); the
    losses must be finite and all three EM kernels launched."""
    from snsde_torch.harness.classification import run_sepsis

    H = SEPSIS_WIDE["H"]
    cfg = main_config(H)
    zero_counts()
    t0 = time.perf_counter()
    res = run_sepsis(cfg, n=N_SEPSIS, max_epochs=SEPSIS_WIDE["epochs"],
                     device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    losses = [h[s]["loss"] for h in res.history for s in ("train", "val")]
    losses += [res.train_metrics.loss, res.val_metrics.loss,
               res.test_metrics.loss]
    print(f"main path 1 at H={H}: run_sepsis {SEPSIS_WIDE['epochs']} epoch "
          f"in {wall:.1f} s, losses {[round(v, 4) for v in losses]}, val "
          f"AUROC {res.val_metrics.auroc:.4f}, launches {launches}",
          flush=True)
    sde_plans("em", [(MAIN["B"], H, MAIN["layers"] - 1)])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss on the sepsis path at H={H}")
    if min(launches[f"em_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"sepsis path at H={H} did not run the "
                             f"kernels: {launches}")
    return launches


def naive_sepsis_path():
    """The sepsis harness with naivesde (1,18: drift 'yy', noise 'net2')
    at the flagship width for NAIVE["epochs"] epoch: it must launch the
    three EM kernels with finite losses, and the trained field's fused
    solve must match the eager one. Returns the launch counts."""
    import dataclasses

    from snsde_torch.harness.classification import run_sepsis

    cfg = dataclasses.replace(main_config(), model_name=NAIVE["model"])
    zero_counts()
    t0 = time.perf_counter()
    res = run_sepsis(cfg, n=N_SEPSIS, max_epochs=NAIVE["epochs"], device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    losses = [h[s]["loss"] for h in res.history for s in ("train", "val")]
    losses += [res.train_metrics.loss, res.val_metrics.loss,
               res.test_metrics.loss]
    print(f"main path 1 with {NAIVE['model']}: run_sepsis {NAIVE['epochs']} "
          f"epoch in {wall:.1f} s, losses {[round(v, 4) for v in losses]}, "
          f"val AUROC {res.val_metrics.auroc:.4f}, launches {launches}",
          flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss on the sepsis path with "
                             f"{NAIVE['model']}")
    if min(launches[f"em_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"sepsis path with {NAIVE['model']} did not "
                             f"run the EM kernels: {launches}")
    check_trained_solve(res.model.sde.func, MAIN, amplifies=True)
    return launches


def mujoco_config():
    from snsde_torch.harness.forecasting import ForecastConfig

    return ForecastConfig(model_name=SRK["model"], hidden_channels=SRK["H"],
                          hidden_hidden_channels=SRK["H"],
                          num_hidden_layers=SRK["layers"], lr=1e-3,
                          batch_size=SRK["B"], time_augment=False,
                          step_mode="valloss", loss="mse", reg="l2",
                          reg_scale=0.01, method="srk")


def mujoco_path():
    """The MuJoCo forecasting path; returns the launch counts of its run."""
    from snsde_torch.harness.forecasting import run_mujoco

    cfg = mujoco_config()
    zero_counts()
    t0 = time.perf_counter()
    res = run_mujoco(cfg, n=N_MUJOCO, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mses = [h[s] for h in res["history"] for s in ("train", "val", "test")]
    mses.append(res["test_mse"])
    print(f"main path 2: run_mujoco (srk) 2 epochs in {wall:.1f} s "
          f"({res['steps']} steps), MSEs {[round(v, 4) for v in mses]}, "
          f"launches {launches}", flush=True)
    if not all(np.isfinite(mses)):
        raise AssertionError("non-finite MSE on the forecasting path")
    if min(launches[f"srk_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"forecasting path did not run the SRK "
                             f"kernels: {launches}")
    check_trained_solve(res["model"].func, SRK, srk=True)
    return launches


def uea_b_noisy(n=SWEEP["n"]):
    """The uea_b_noisy set of tools/run_sweep_cd.py, built with the port's
    own synthetic_uea: L=60, 5 channels, 2 classes, plus 0.8 N(0, 1)."""
    from snsde_torch.data import synthetic_uea

    X, y, t = synthetic_uea(n=n, length=SWEEP["L"], channels=SWEEP["D"],
                            num_classes=SWEEP["classes"], seed=SWEEP["seed"])
    rng = np.random.default_rng(SWEEP["seed"] + 1)
    X = X + SWEEP["noise"] * rng.normal(size=X.shape).astype(np.float32)
    return X, y, t


def sweep_path(out_dir):
    """The robustness sweep with the Neural CDE; returns the launch counts
    of its run."""
    from snsde_torch.harness.robustness import (SweepConfig, preprocess_ists,
                                                run_robustness_sweep)

    cfg = SweepConfig(models=("neuralcde",), missing_rates=(0.3,),
                      seeds=(0,), hidden_dim=SWEEP["H"],
                      batch_size=SWEEP["B"], max_epochs=2, out_dir=out_dir)
    trained = {}
    zero_counts()
    t0 = time.perf_counter()
    recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                dataset_name="uea_b_noisy", verbose=False,
                                device=DEV, models=trained)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    print(f"main path 3: run_robustness_sweep (neuralcde, rk4) 2 epochs in "
          f"{wall:.1f} s, records {recs}, launches {launches}", flush=True)
    if not recs or any("error" in r or "accuracy" not in r for r in recs):
        raise AssertionError(f"the sweep wrote a failed record: {recs}")
    if not all(np.isfinite(r["accuracy"]) for r in recs):
        raise AssertionError("non-finite accuracy on the sweep path")
    if launches["cde_fwd"] <= 0 or launches["cde_bwd"] <= 0:
        raise AssertionError(f"sweep path did not run the CDE kernels: "
                             f"{launches}")
    X, _, _ = uea_b_noisy()
    data = preprocess_ists(X[:16], missing_rate=0.3, seed=0,
                           interpolation="natural")
    check_trained_cde_solve(trained[(0.3, "neuralcde", 0)], data)
    return launches


def sde_sweep_path(out_dir):
    """The robustness sweep's SDE stream names (SDE_SWEEP_MODELS, srk) on
    the sweep cell, one model a run with every count set to 0 before it:
    each must launch the three SRK kernels, write a record with an accuracy
    and no error, give a finite loss on the validation rows, and its
    trained field's fused solve must match the eager one. Returns the
    launch counts of each run."""
    from snsde_torch.harness.robustness import (SweepConfig, preprocess_ists,
                                                run_robustness_sweep)
    from snsde_torch.train.loop import softmax_cross_entropy

    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:64], missing_rate=0.3, seed=0,
                           interpolation="hermite")
    out = {}
    for name in SDE_SWEEP_MODELS:
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=2, out_dir=out_dir)
        trained = {}
        zero_counts()
        t0 = time.perf_counter()
        recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                    dataset_name="uea_b_noisy",
                                    verbose=False, device=DEV,
                                    models=trained)
        torch.cuda.synchronize()
        launches = out[name] = read_counts()
        wall = time.perf_counter() - t0
        model = trained.get((0.3, name, 0))
        loss = float("nan")
        if model is not None:
            model.eval()
            with torch.no_grad():
                logits = model(torch.as_tensor(data["seq"], device=DEV),
                               torch.as_tensor(data["coeffs"], device=DEV),
                               generator=torch.Generator(DEV).manual_seed(0))
                loss = float(softmax_cross_entropy(
                    logits, torch.as_tensor(y[:64], device=DEV).long()))
        print(f"main path 3 with {name}: run_robustness_sweep (srk) 2 "
              f"epochs in {wall:.1f} s, records {recs}, validation-rows "
              f"loss {loss:.4f}, launches {launches}", flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           for r in recs):
            raise AssertionError(f"the sweep wrote a failed record: {recs}")
        if not (all(np.isfinite(r["accuracy"]) for r in recs)
                and np.isfinite(loss)):
            raise AssertionError(f"non-finite accuracy or loss with {name}")
        if min(launches[f"srk_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
            raise AssertionError(f"{name} did not run the SRK kernels: "
                                 f"{launches}")
        check_trained_solve(model.layer.inner.func,
                            dict(L=SWEEP["L"], C=SWEEP["D"] + 1,
                                 H=SWEEP["H"]), srk=True, amplifies=True)
    return out


def check_trained_cde_solve(model, data):
    """A trained classifier's CDE stream through the fused kernels vs the
    eager cdeint, on the same coefficients. The two are different solvers
    of one tableau (cdeint adds the rk4 update as (dt/6)(k1 + 2 k2 + 2 k3
    + k4), the kernel as four scaled adds), so they are held to each other
    as a kernel is to its plain version: within the larger of TOL_YS and
    YS_F64_FACTOR times the float32 eager stream's own largest error from
    a float64 run of it."""
    import copy

    inner = model.layer.inner
    inner64 = copy.deepcopy(inner).double()
    times = data["times"]
    coeffs = torch.as_tensor(data["coeffs"], device=DEV)
    with torch.no_grad():
        _, z_f = inner(times, coeffs, use_fused=True)
        _, z_e = inner(times, coeffs, use_fused=False)
        _, z_64 = inner64(times, coeffs.double(), use_fused=False)
    scale = float(z_64.abs().max())
    rel = float((z_f - z_e).abs().max()) / scale
    e_eager = float((z_e.double() - z_64).abs().max()) / scale
    tol = max(TOL_YS, YS_F64_FACTOR * e_eager)
    print(f"trained model: fused vs eager rk4 CDE solve, B={z_f.shape[0]}: "
          f"shape {tuple(z_f.shape)}, largest err over max|z| {rel:.3e} "
          f"(tol {tol:.3e}; the float32 eager solve from float64 "
          f"{e_eager:.3e})")
    if not (torch.isfinite(z_f).all() and rel <= tol):
        raise AssertionError("trained CDE model's fused solve disagrees")


def check_trained_solve(func, shape, srk=False, B=64, amplifies=False):
    """A trained field's fused solve vs the eager solver, on the same dW
    (and, for srk, the same Lévy area): within TOL_YS of max|ys|, or with
    `amplifies` (the new paths' trained fields, stepped at dt = 1 here,
    where their solves amplify float32 rounding) within the larger of that
    and YS_F64_FACTOR times the float32 eager solve's own largest error
    from a float64 run of it, as the CDE pair's trained solve is held."""
    import copy

    from snsde_torch.kernels.fused_em import fused_em_solve
    from snsde_torch.kernels.fused_srk import fused_srk_solve
    from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                                 make_grid, sdeint)

    rng = np.random.default_rng(1)
    L, C, H = shape["L"], shape["C"], shape["H"]
    label = f"({func.input_option},{func.noise_option})"
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times), x).to(DEV),
                     times)
    grid, _ = make_grid(times, 1.0)
    dW = rng.normal(size=(len(grid) - 1, B, H)).astype(np.float32)
    I10 = torch.as_tensor(levy_area(rng, dW)).to(DEV)
    dW = torch.as_tensor(dW).to(DEV)
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    field = func.bind(path)

    def eager(fld, pth, y, dw, i10):
        if srk:
            return sdeint(fld.f, fld.g, y, times, method="srk",
                          bm=BrownianGrid(grid, dw, i10))
        return sdeint(fld.f, fld.g, y, times, bm=BrownianGrid(grid, dw))

    with torch.no_grad():
        if srk:
            ys_f = fused_srk_solve(field, path, times, y0, dt=1.0,
                                   brownian_override=(dW, I10))
        else:
            ys_f = fused_em_solve(field, path, times, y0, dt=1.0,
                                  dW_override=dW)
        ys_e = eager(field, path, y0, dW, I10)
        tol, note = TOL_YS, ""
        if amplifies:
            path64 = CubicPath(hermite_cubic_coeffs(
                torch.as_tensor(times, dtype=torch.float64),
                x.double()).to(DEV), times)
            f64 = copy.deepcopy(func).double().bind(path64)
            ys_64 = eager(f64, path64, y0.double(), dW.double(),
                          I10.double())
            scale = float(ys_64.abs().max())
            e32 = float((ys_e.double() - ys_64).abs().max()) / scale
            ek = float((ys_f.double() - ys_64).abs().max()) / scale
            tol = max(TOL_YS, YS_F64_FACTOR * e32)
            note = (f"; from float64: the float32 eager solve {e32:.3e}, the "
                    f"fused {ek:.3e}")
    err = float((ys_f - ys_e).abs().max())
    rel = err / max(float(ys_e.abs().max()), 1e-30)
    print(f"trained model {label}: fused vs eager "
          f"{'srk' if srk else 'euler'} solve, B={B}: shape "
          f"{tuple(ys_f.shape)}, max abs err {err:.3e} rel {rel:.3e} (tol "
          f"rel {tol:.3e}{note})")
    if not (torch.isfinite(ys_f).all() and rel <= tol):
        raise AssertionError("trained model's fused solve disagrees")


# ---------------------------------------------------------------------------
# The recurrent baselines: the GRU and LSTM kernel pairs
# ---------------------------------------------------------------------------

def rnn_fns(kind):
    """(forward, backward, plain forward, plain backward) of the pair
    'gru' or 'lstm'."""
    from snsde_torch.kernels import fused_rnn as fr

    return tuple(getattr(fr, f"fused_{kind}_{n}") for n in (
        "forward", "backward", "forward_reference", "backward_reference"))


def rnn_kernel_inputs(kind, B, L, C, H, dec=False, seed=0):
    """A random cell (the port's init, U(-1/sqrt(H), 1/sqrt(H))) on a
    random sequence xs [L, B, C] ~ N(0, 1), and the pair's detached inputs:
    gi, the cell's input projection of xs, W_hh, b_hh, for the GRU h0 ~
    N(0, 1/4) and, with dec, a decay stream ~ U(0.2, 1); and the
    cotangent ghs of a batch-mean loss. (cell, xs, inputs, ghs)."""
    from snsde_torch.nn.layers import GRUCell, LSTMCell

    rng = np.random.default_rng(seed)
    cell = (GRUCell if kind == "gru" else LSTMCell)(
        C, H, generator=torch.Generator().manual_seed(seed)).to(DEV)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=DEV)
    xs = t(rng.normal(size=(L, B, C)))
    with torch.no_grad():
        inp = {"gi": (xs @ cell.w_ih + cell.b_ih).contiguous(),
               "whh": cell.w_hh.detach().clone(),
               "bhh": cell.b_hh.detach().clone()}
    if kind == "gru":
        inp["h0"] = t(0.5 * rng.normal(size=(B, H)))
        if dec:
            inp["hdec"] = t(rng.uniform(0.2, 1.0, size=(L, B, H)))
    return cell, xs, inp, t(rng.normal(size=(L, B, H)) / B)


def rnn_run(kind, fwd, bwd, inp, ghs):
    """{output name: tensor} of a pair's forward (hs, and cs for the LSTM)
    and backward on the same inputs."""
    if kind == "gru":
        hs = fwd(**inp)
        g = bwd(hs=hs, ghs=ghs, **inp)
        return {"hs": hs, **{n: v for n, v in zip(g._fields, g)
                             if v is not None}}
    hs, cs, _ = fwd(**inp)
    g = bwd(hs=hs, cs=cs, ghs=ghs, **inp)
    return {"hs": hs, "cs": cs, **{n: v for n, v in zip(g._fields, g)
                                   if v is not None}}


def compare_rnn(kind, B, L, C, H, dec=False):
    """The GRU or LSTM pair against its plain versions on the same inputs:
    hs (and cs) within TOL_YS of its largest entry, every cotangent within
    TOL_GRAD, and every output's rms error from a float64 run of the plain
    version at most F64_FACTOR times the float32 plain version's, plus
    F64_FLOOR (the recurrences are contractive: no float64 factor on the
    trajectory). Returns the largest abs errors of the forward's and the
    backward's outputs."""
    _, _, inp, ghs = rnn_kernel_inputs(kind, B, L, C, H, dec)
    fwd, bwd, fwd_p, bwd_p = rnn_fns(kind)
    k = rnn_run(kind, fwd, bwd, inp, ghs)
    p = rnn_run(kind, fwd_p, bwd_p, inp, ghs)
    r = rnn_run(kind, fwd_p, bwd_p, {n: v.double() for n, v in inp.items()},
                ghs.double())
    torch.cuda.synchronize()
    print(f"  {kind.upper()}{' + hdec' if dec else ''} B={B} L={L} C={C} "
          f"H={H}:")
    err = {"fwd": 0.0, "bwd": 0.0}
    for name in k:
        e = float((k[name] - p[name]).abs().max())
        rel = e / max(float(p[name].abs().max()), 1e-30)
        (k_max, k_rms), (p_max, p_rms) = (_errs64(k[name], r[name]),
                                          _errs64(p[name], r[name]))
        tol = TOL_YS if name in ("hs", "cs") else TOL_GRAD
        print(f"    {name:6s} max abs err {e:.3e} rel {rel:.3e} (tol "
              f"{tol:g}); from float64 largest/rms: kernel {k_max:.3e}/"
              f"{k_rms:.3e}, float32 plain {p_max:.3e}/{p_rms:.3e}")
        if not rel <= tol:
            raise AssertionError(f"{kind} kernel disagrees on {name}")
        if not k_rms <= F64_FACTOR * p_rms + F64_FLOOR:
            raise AssertionError(f"{kind} {name}: kernel further from "
                                 f"float64 than the plain version allows")
        part = "fwd" if name in ("hs", "cs") else "bwd"
        err[part] = max(err[part], e)
    return err["fwd"], err["bwd"]


def _plans(kind, shapes):
    """Print the GRU's or the LSTM's plan at each (B, H): CTAs per
    cluster, batch rows per cluster, where the W_hh slices live, shared
    bytes per CTA and cudaOccupancyMaxActiveClusters; raise if one cannot
    be scheduled."""
    from snsde_torch.kernels import fused_rnn as fr

    for B, H in shapes:
        for backward in (False, True):
            p = getattr(fr, f"fused_{kind}_plan")(H, B, backward)
            print(f"  {kind.upper()} plan B={B} H={H} "
                  f"{'backward' if backward else 'forward'}: CS={p['cluster']}"
                  f", {p['rows']} rows a cluster, W_hh slices in "
                  f"{'shared' if p['w_smem'] else 'device'} memory, "
                  f"{p['rows_per_thread']} rows a thread, {p['smem_bytes']} "
                  f"shared bytes a CTA, cudaOccupancyMaxActiveClusters "
                  f"{p['active_clusters']}")
            if p["active_clusters"] < 1:
                raise AssertionError(f"{kind} plan at B={B} H={H} cannot be "
                                     f"scheduled: {p}")


def lstm_plans():
    """The LSTM kernels' plan at every shape this script runs them at."""
    rs = RNN_SWEEP
    _plans("lstm", [(rs["B"], rs["H"]), (rs["B"], rs["H"] // 2), (100, 32),
                    (16, 512)] + [(1024, h) for h in (32, 64, 128)
                                  + LSTM_PLAN_H])


def gru_plans():
    """The GRU kernels' plan at every shape this script runs them at."""
    rs = RNN_SWEEP
    _plans("gru", [(rs["B"], rs["H"]), (100, 32)] + [
        (1024, h) for h in (32, 64) + GRU_PLAN_H])


def compare_wgrad(kind, B, L, C, H, dec=False):
    """The weight-gradient kernel alone against its plain version on the
    plain versions' streams (the LSTM's hs and dgi; the GRU's h0, hs, decay
    and dgh): dW_hh and db_hh within TOL_GRAD of their largest entries,
    and no further from a float64 run than the F64 rule allows. Returns
    the largest abs error."""
    from snsde_torch.kernels import fused_rnn as fr

    _, _, inp, ghs = rnn_kernel_inputs(kind, B, L, C, H, dec)
    if kind == "lstm":
        hs, cs, _ = fr.fused_lstm_forward_reference(**inp)
        args = (hs, fr.fused_lstm_backward_reference(hs=hs, cs=cs, ghs=ghs,
                                                     **inp).dgi)
    else:
        hs = fr.fused_gru_forward_reference(**inp)
        dgh = fr._gru_reverse(inp["gi"], hs, ghs, inp["h0"], inp["whh"],
                              inp["bhh"], inp.get("hdec")).dgh
        args = (inp["h0"], hs, dgh, inp.get("hdec"))
    k = getattr(fr, f"fused_{kind}_weight_grads")(*args)
    plain = getattr(fr, f"fused_{kind}_weight_grads_reference")
    p = plain(*args)
    r = plain(*(None if a is None else a.double() for a in args))
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b, ref in zip(("dwhh", "dbhh"), k, p, r):
        e = float((a - b).abs().max())
        rel = e / max(float(b.abs().max()), 1e-30)
        (k_max, k_rms), (p_max, p_rms) = _errs64(a, ref), _errs64(b, ref)
        print(f"  {kind.upper()} weight-gradient kernel B={B} L={L} H={H}"
              f"{' + hdec' if dec else ''} {name}: max abs err {e:.3e} rel "
              f"{rel:.3e} (tol {TOL_GRAD:g}); from float64 largest/rms: "
              f"kernel {k_max:.3e}/{k_rms:.3e}, float32 plain {p_max:.3e}/"
              f"{p_rms:.3e}")
        if not (rel <= TOL_GRAD and k_rms <= F64_FACTOR * p_rms + F64_FLOOR):
            raise AssertionError(f"{kind} weight-gradient kernel disagrees "
                                 f"on {name}")
        worst = max(worst, e)
    return worst


def compare_gru_scan(B, L, C, H, reverse, dec):
    """fused_gru_scan (projection, flips, the kernels) from a nonzero h0,
    with or without the decay stream, against the eager loop over the
    cell in the given direction: hs and every gradient (xs, h0, the decay
    and the cell's parameters) within TOL_GRAD of its largest entry."""
    from snsde_torch.kernels import fused_rnn as fr

    cell, xs, inp, w = rnn_kernel_inputs("gru", B, L, C, H, dec, seed=3)
    flip = (lambda a: torch.flip(a, (0,))) if reverse else (lambda a: a)
    outs = []
    for fused in (True, False):
        for p in cell.parameters():
            p.grad = None
        x = xs.clone().requires_grad_(True)
        h = inp["h0"].clone().requires_grad_(True)
        d = inp["hdec"].clone().requires_grad_(True) if dec else None
        if fused:
            hs = fr.fused_gru_scan(cell, x, h0=h, reverse=reverse, hdec=d)
        else:
            xr, dr, hh, out = flip(x), flip(d) if dec else None, h, []
            for t in range(L):
                hh = cell(xr[t], hh if dr is None else hh * dr[t])
                out.append(hh)
            hs = flip(torch.stack(out))
        (hs * w).sum().backward()
        outs.append([hs.detach(), x.grad, h.grad] + ([d.grad] if dec else [])
                    + [p.grad for p in cell.parameters()])
    torch.cuda.synchronize()
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(*outs))
    print(f"  GRU scan B={B} L={L} H={H}{' + hdec' if dec else ''}"
          f"{' reverse' if reverse else ''} vs the eager loop: largest err "
          f"over max {worst:.3e} (tol {TOL_GRAD:g})")
    if not worst <= TOL_GRAD:
        raise AssertionError("fused GRU scan disagrees with the eager loop")


def cudnn_module(kind, cell):
    """torch.nn.GRU / nn.LSTM (cuDNN) holding the cell's weights."""
    C, H = cell.w_ih.shape[0], cell.hidden_size
    lib = (torch.nn.GRU if kind == "gru" else torch.nn.LSTM)(C, H).to(DEV)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(cell.w_ih.T)
        lib.weight_hh_l0.copy_(cell.w_hh.T)
        lib.bias_ih_l0.copy_(cell.b_ih)
        lib.bias_hh_l0.copy_(cell.b_hh)
    return lib


def _scan_grads(kind, cell, xs, w, h0, lib=None):
    """hs and the gradients of sum(hs * w) w.r.t. w_ih, b_ih, w_hh, b_hh
    (and h0 for the GRU): through the kernels (fused_*_scan) for float32,
    the eager loop over the cell for float64, or cuDNN when lib is given."""
    from snsde_torch.kernels import fused_rnn as fr
    from snsde_torch.models.rnn import scan_cell

    h0 = h0.clone().requires_grad_(True)
    if lib is not None:
        hs, _ = lib(xs, h0[None]) if kind == "gru" else lib(xs)
        params = [lib.weight_ih_l0, lib.bias_ih_l0, lib.weight_hh_l0,
                  lib.bias_hh_l0]
    elif xs.dtype == torch.float64:
        if kind == "gru":
            h, hs = h0, []
            for t in range(xs.shape[0]):
                h = cell(xs[t], h)
                hs.append(h)
            hs = torch.stack(hs)
        else:
            hs = scan_cell(cell, xs)
        params = [cell.w_ih, cell.b_ih, cell.w_hh, cell.b_hh]
    else:
        hs = (fr.fused_gru_scan(cell, xs, h0=h0) if kind == "gru"
              else fr.fused_lstm_scan(cell, xs))
        params = [cell.w_ih, cell.b_ih, cell.w_hh, cell.b_hh]
    wrt = params + ([h0] if kind == "gru" else [])
    grads = torch.autograd.grad((hs * w).sum(), wrt)
    if lib is not None:          # torch's [out, in] layout
        grads = (grads[0].T, grads[1], grads[2].T) + grads[3:]
    return [hs.detach()] + list(grads)


def compare_rnn_cudnn(kind, B, L, C, H):
    """The kernel route (fused_*_scan) against cuDNN (torch.nn.GRU/LSTM,
    TF32 off) with the same weights: hs and the gradients of w_ih, b_ih,
    w_hh, b_hh (and h0). cuDNN rounds its sums and gate functions its own
    way, so each output may differ by the larger of its kernel tolerance
    and YS_F64_FACTOR times cuDNN's own largest error from a float64 run
    of the eager loop, and the kernel's rms error from float64 may be at
    most F64_FACTOR times cuDNN's, plus F64_FLOOR."""
    import copy

    torch.backends.cudnn.allow_tf32 = False
    cell, xs, inp, _ = rnn_kernel_inputs(kind, B, L, C, H, seed=1)
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.normal(size=(L, B, H)).astype(np.float32) / B,
                        device=DEV)
    h0 = inp.get("h0", torch.zeros(B, H, device=DEV))
    k = _scan_grads(kind, cell, xs, w, h0)
    lib = _scan_grads(kind, cell, xs, w, h0, lib=cudnn_module(kind, cell))
    ref = _scan_grads(kind, copy.deepcopy(cell).double(), xs.double(),
                      w.double(), h0.double())
    torch.cuda.synchronize()
    print(f"  {kind.upper()} B={B} L={L} C={C} H={H} vs cuDNN:")
    for name, a, b, r in zip(("hs", "dw_ih", "db_ih", "dw_hh", "db_hh",
                              "dh0"), k, lib, ref):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        (k_max, k_rms), (l_max, l_rms) = _errs64(a, r), _errs64(b, r)
        tol = max(TOL_YS if name == "hs" else TOL_GRAD, YS_F64_FACTOR * l_max)
        print(f"    {name:6s} rel {rel:.3e} (tol {tol:.3e}); from float64 "
              f"largest/rms: kernel {k_max:.3e}/{k_rms:.3e}, cuDNN "
              f"{l_max:.3e}/{l_rms:.3e}")
        if not (rel <= tol and k_rms <= F64_FACTOR * l_rms + F64_FLOOR):
            raise AssertionError(f"{kind} kernels disagree with cuDNN on "
                                 f"{name}")


class EagerSteps:
    """Counts the eager steps of the time-aware LSTM cells while active:
    a run through the kernels takes none."""

    def __enter__(self):
        from snsde_torch.models import time_rnn

        self.n, self.real = 0, {}
        for cls in (time_rnn.TLSTMCell, time_rnn.PLSTMCell,
                    time_rnn.TGLSTMCell):
            real = self.real[cls] = cls.forward

            def counted(cell, *a, real=real, **k):
                self.n += 1
                return real(cell, *a, **k)
            cls.forward = counted
        return self

    def __exit__(self, *exc):
        for cls, real in self.real.items():
            cls.forward = real


def rnn_sweep_path(out_dir, names=RNN_MODELS):
    """The robustness sweep's recurrent baselines and ODE-RNN hybrids (or
    `names`: phase 9's time-aware LSTMs) on the sweep cell, one model a
    run, the counts set to 0 just before each run and read just after; no
    eager step of a time-aware cell may run; returns the launch counts
    summed over the runs of each pair's names ({'gru': counts, 'lstm':
    counts})."""
    from snsde_torch.harness.robustness import (SweepConfig, coeff_family,
                                                preprocess_ists,
                                                run_robustness_sweep)

    X, _, _ = uea_b_noisy()
    total = {"gru": {}, "lstm": {}}
    for name in names:
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=2, out_dir=out_dir)
        trained = {}
        zero_counts()
        t0 = time.perf_counter()
        with EagerSteps() as eager:
            recs = run_robustness_sweep(cfg, n=SWEEP["n"],
                                        data_fn=uea_b_noisy,
                                        dataset_name="uea_b_noisy",
                                        verbose=False, device=DEV,
                                        models=trained)
        torch.cuda.synchronize()
        launches = read_counts()
        wall = time.perf_counter() - t0
        if eager.n:
            raise AssertionError(f"{name} took {eager.n} eager cell steps")
        pair, *grads = RNN_PAIRS[name]
        print(f"main path 4 ({name}): run_robustness_sweep 2 epochs in "
              f"{wall:.1f} s, records {recs}, launches {launches}",
              flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           for r in recs):
            raise AssertionError(f"the sweep wrote a failed record: {recs}")
        if not all(np.isfinite(r["accuracy"]) for r in recs):
            raise AssertionError(f"non-finite accuracy for {name}")
        if launches[f"{pair}_fwd"] <= 0 or launches[f"{pair}_bwd"] <= 0:
            raise AssertionError(f"{name} did not run the {pair} kernels: "
                                 f"{launches}")
        for key in grads:
            if launches[key] != launches[f"{pair}_bwd"]:
                raise AssertionError(f"{name}: the weight-gradient kernel "
                                     f"({key}) ran {launches[key]} times, "
                                     f"the recurrence "
                                     f"{launches[pair + '_bwd']}")
        small = preprocess_ists(X[:16], missing_rate=0.3,
                                interpolation=coeff_family(name), seed=0)
        check_trained_rnn(name, trained[(0.3, name, 0)], small)
        fam = total[pair.split("_")[0]]
        for key, v in launches.items():
            fam[key] = fam.get(key, 0) + v
    return total


def check_trained_rnn(name, model, data):
    """A trained classifier's recurrence through the kernels vs its eager
    loop over the cell, on the same batch: the stream within TOL_YS of its
    largest entry."""
    layer, inner = model.layer, model.layer.inner
    seq = torch.as_tensor(data["seq"], device=DEV)
    coeffs = torch.as_tensor(data["coeffs"], device=DEV)
    x, mask, delta = seq[:, 0], seq[:, 1], seq[:, 2]
    times = np.linspace(0.0, 1.0, seq.shape[2]).astype(np.float32)
    with torch.no_grad():
        if name == "grud":
            z_f, z_e = (inner(x, mask, delta, use_fused=f)
                        for f in (True, False))
        elif name == "ode-lstm":
            z_f, z_e = (inner(layer.in_proj(x), delta[..., 0], use_fused=f)
                        for f in (True, False))
        elif name in ("gru-dt", "gru-d", "ode-rnn"):
            z_f, z_e = (inner(times, coeffs, stream=True, use_fused=f)[1]
                        for f in (True, False))
        elif name in TIME_MODELS:
            z_f, z_e = (layer(seq, coeffs, use_fused=f)[1]
                        for f in (True, False))
        else:
            z_f, z_e = (inner(x, use_fused=f)[1] for f in (True, False))
    rel = float((z_f - z_e).abs().max()) / max(float(z_e.abs().max()), 1e-30)
    print(f"trained {name}: recurrence through the kernels vs the eager "
          f"loop, B={z_f.shape[0]}: shape {tuple(z_f.shape)}, largest err "
          f"over max|z| {rel:.3e} (tol {TOL_YS:g})")
    if not (torch.isfinite(z_f).all() and rel <= TOL_YS):
        raise AssertionError(f"trained {name} model's kernels disagree")


def baseline_sweep_path(out_dir):
    """The sweep cell with the convolution and attention baselines, one
    model a run: each must write a record with a finite accuracy and no
    error, and launch no kernel of the port (neither has one)."""
    from snsde_torch.harness.robustness import (SweepConfig,
                                                run_robustness_sweep)

    for name in BASELINE_MODELS:
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=2, out_dir=out_dir)
        zero_counts()
        t0 = time.perf_counter()
        recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                    dataset_name="uea_b_noisy",
                                    verbose=False, device=DEV)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"main path 9 ({name}): run_robustness_sweep 2 epochs in "
              f"{time.perf_counter() - t0:.1f} s, records {recs}",
              flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           or not np.isfinite(r["accuracy"]) for r in recs):
            raise AssertionError(f"the sweep wrote a failed record: {recs}")
        if any(launches.values()):
            raise AssertionError(f"{name} launched kernels: {launches}")


def rnn_mode_inputs(kind, mode, B, L, H, n=2, S=1, seed=0):
    """A random cell of the sweep's shape (the embedded stream of width H
    in, the port's init) on a random sequence, and a mode's detached
    inputs, as a hybrid of the sweep hands them over: gi, W_hh, b_hh (the
    GRU's h0 ~ N(0, 1/4)), the mask obs [L, B] ~ Bernoulli(0.5) (the
    GRU's), the decay row hrow [L, H] ~ U(0.2, 1), the evolve's MLP (n
    layers of the init's scale, hh = H) with the knots' spacing 1/(L-1)
    (GRU) or elapsed times ~ U(0, 2) per row (LSTM) over S substeps; the
    LSTM's openness sel [L, B, H] ~ U(0, 1), modifiers tg [L, B, 3H]
    sigmoids of N(0, 1), TLSTM's W_d and b_d of the init's scale with
    elapsed times tel [L, B] ~ U(0, 2); and the cotangent ghs of a
    batch-mean loss. (inputs, mode kwargs, ghs)."""
    from snsde_torch.kernels import fused_rnn as fr
    from snsde_torch.nn.layers import make_linear

    _, xs, inp, ghs = rnn_kernel_inputs(kind, B, L, H, H, seed=seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=DEV)
    kw = {}
    if kind == "gru":
        kw["obs"] = t(rng.uniform(size=(L, B)) < 0.5)
        if mode == 2:
            kw["hrow"] = t(rng.uniform(0.2, 1.0, size=(L, H)))
    if (kind, mode) in (("gru", 3), ("lstm", 1)):
        gen = torch.Generator().manual_seed(seed)
        layers = [make_linear(H, H, generator=gen) for _ in range(n)]
        with torch.no_grad():
            mlp = fr.pack_mlp(layers).to(DEV)
        dts = (t(np.full(L, 1.0 / (L - 1))) if kind == "gru"
               else t(rng.uniform(0.0, 2.0, size=(L, B))))
        kw["ode"] = fr.Evolve(mlp, (dts / S).contiguous(), n, H, S)
    if (kind, mode) == ("lstm", 2):
        kw["sel"] = t(rng.uniform(size=(L, B, H)))
    if (kind, mode) == ("lstm", 3):
        kw["tg"] = t(1.0 / (1.0 + np.exp(-rng.normal(size=(L, B, 3 * H)))))
    if (kind, mode) == ("lstm", 4):
        k = 1.0 / np.sqrt(H)
        kw["dec"] = fr.Decomp(t(rng.uniform(-k, k, size=(H, H))),
                              t(rng.uniform(-k, k, size=H)),
                              t(rng.uniform(0.0, 2.0, size=(L, B))))
    return inp, kw, ghs


def rnn_mode_run(kind, inp, kw, ghs, plain=False):
    """{output name: tensor} of a mode's forward (hs; the LSTM's cs and
    hcell) and backward on the same inputs: the kernels, or with plain
    their plain versions."""
    from snsde_torch.kernels import fused_rnn as fr

    sfx = "_reference" if plain else ""
    fwd = getattr(fr, f"fused_{kind}_forward{sfx}")
    bwd = getattr(fr, f"fused_{kind}_backward{sfx}")
    if kind == "gru":
        hs = fwd(**inp, **kw)
        out = {"hs": hs}
        g = bwd(hs=hs, ghs=ghs, **inp, **kw)
    else:
        hs, cs, hcell = fwd(**inp, save_cs=True, **kw)
        out = {"hs": hs, "cs": cs, "hcell": hcell}
        g = bwd(hs=hs, cs=cs, ghs=ghs, hcell=hcell, **inp, **kw)
    out.update(zip(g._fields, g))
    return {n: v for n, v in out.items() if v is not None}


def _dbl_mode(kw):
    from snsde_torch.kernels.fused_rnn import Decomp

    return {n: (v._replace(mlp=v.mlp.double(), dts=v.dts.double())
                if n == "ode" else Decomp(*(x.double() for x in v))
                if n == "dec" else v.double()) for n, v in kw.items()}


def compare_rnn_mode(kind, mode, B, L, H, n=2, S=1):
    """One of the hybrids' kernel instances against its plain version on
    the same inputs, by compare_rnn's rules (hs, cs and hcell within
    TOL_YS of their largest entries, every cotangent, the evolve's packed
    weight gradient dmlp and the decay row's dhrow included, within
    TOL_GRAD, and the float64 rms rule), with the plan it ran printed.
    Returns the largest abs errors of the forward's and the backward's
    outputs and of TLSTM's W_d gradient (0 without it)."""
    from snsde_torch.kernels import fused_rnn as fr

    inp, kw, ghs = rnn_mode_inputs(kind, mode, B, L, H, n, S)
    k = rnn_mode_run(kind, inp, kw, ghs)
    p = rnn_mode_run(kind, inp, kw, ghs, plain=True)
    r = rnn_mode_run(kind, {n_: v.double() for n_, v in inp.items()},
                     _dbl_mode(kw), ghs.double(), plain=True)
    torch.cuda.synchronize()
    ode = kw.get("ode")
    for backward in (False, True):
        plan = (fr.fused_gru_plan(H, B, backward, mode, ode)
                if kind == "gru" else
                fr.fused_lstm_plan(H, B, backward, ode, mode))
        print(f"  {kind.upper()} mode {mode} B={B} L={L} H={H}"
              f"{f' n={n} S={S}' if ode else ''}: "
              f"{'backward' if backward else 'forward'} plan CS="
              f"{plan['cluster']}, {plan['rows']} rows, W_hh slices in "
              f"{'shared' if plan['w_smem'] else 'device'} memory, "
              f"{plan['smem_bytes']} shared bytes, "
              f"cudaOccupancyMaxActiveClusters {plan['active_clusters']}")
        if plan["active_clusters"] < 1:
            raise AssertionError(f"{kind} mode {mode} plan at B={B} H={H} "
                                 f"cannot be scheduled: {plan}")
    err = {"fwd": 0.0, "bwd": 0.0, "wd": 0.0}
    for name in k:
        e = float((k[name] - p[name]).abs().max())
        rel = e / max(float(p[name].abs().max()), 1e-30)
        (k_max, k_rms), (p_max, p_rms) = (_errs64(k[name], r[name]),
                                          _errs64(p[name], r[name]))
        fwd = name in ("hs", "cs", "hcell")
        tol = TOL_YS if fwd else TOL_GRAD
        print(f"    {name:6s} max abs err {e:.3e} rel {rel:.3e} (tol "
              f"{tol:g}); from float64 largest/rms: kernel {k_max:.3e}/"
              f"{k_rms:.3e}, float32 plain {p_max:.3e}/{p_rms:.3e}")
        if not rel <= tol:
            raise AssertionError(f"{kind} mode {mode} kernel disagrees on "
                                 f"{name}")
        if not k_rms <= F64_FACTOR * p_rms + F64_FLOOR:
            raise AssertionError(f"{kind} mode {mode} {name}: kernel "
                                 f"further from float64 than the plain "
                                 f"version allows")
        part = "fwd" if fwd else "wd" if name in ("dwd", "dbd") else "bwd"
        err[part] = max(err[part], e)
    return err["fwd"], max(err["bwd"], err["wd"]), err["wd"]


def compare_rnn_modes():
    """Every hybrid and time-aware instance against its plain version at
    the sweep's shape and at H=256 (a cluster of 8 CTAs, each running the
    evolve on its full copy; TLSTM's keeping every unit of c), the evolve
    also with three layers and two substeps, the time-aware modes also at
    TIME_MODE_SHAPES. Returns {'<pair>_<suffix>': (fwd err, bwd err, W_d
    gradient err)}."""
    rs, wide = RNN_SWEEP, RNN_MODE_WIDE
    out = {}
    for kind, mode, sfx in RNN_MODES:
        errs = [compare_rnn_mode(kind, mode, rs["B"], rs["L"], rs["H"]),
                compare_rnn_mode(kind, mode, wide["B"], wide["L"],
                                 wide["H"])]
        if sfx == "ode":
            errs.append(compare_rnn_mode(kind, mode, rs["B"], rs["L"],
                                         rs["H"], n=3, S=2))
        if sfx in TIME_MODES:
            errs += [compare_rnn_mode(kind, mode, B, L, H)
                     for B, L, H in TIME_MODE_SHAPES]
        out[f"{kind}_{sfx}"] = tuple(max(e[i] for e in errs)
                                     for i in range(3))
    return out


def _numel(*ts):
    return sum(t.numel() for t in ts if torch.is_tensor(t))


def rnn_mode_kernel_times(kind, mode, B, L, H):
    """Times of one hybrid instance and its plain versions at one shape,
    and its bounds from the same inputs: the forward; the backward's
    recurrence and the W_hh weight gradient timed apart and summed
    ("bwd"); with the evolve its layers' weight gradient alone
    ("mlpgrad"). Bytes: every input read once and every output written
    once, the wrapper's (the backward writes dgi, dh0, dW_hh, db_hh and
    the decay row's cotangent; its streams for the evolve's weight
    gradient are that kernel's inputs, on its side of the split).
    Operations: the cell's products (2 L B G H^2 forward, 3x backward with
    W_hh's weight product) and the evolve's (2 L S B per layer in x out
    forward; the backward recomputes the substeps and runs the back
    product: 2x; its weight gradient 2 K in x out, K = L S B); TLSTM's
    c W_d (2 L B H^2 forward; recomputed and run back in the backward: 2x;
    its weight gradient, the "wdgrad" entry timed alone, 2 (L - 1) B H^2).
    The mode's streams (sel, tg, tel) and W_d, b_d are inputs; dsel and
    dtg written gradients; TLSTM's dW_d and the evolve's layers' gradients
    are their weight-gradient kernels'. No PyTorch call computes a masked,
    evolved or time-aware GRU/LSTM (cuDNN has no such mode): no library
    time for the pair; the evolve's and W_d's weight gradients have
    torch.matmul of each product (their bias sums left out)."""
    from snsde_torch.kernels import fused_rnn as fr

    inp, kw, ghs = rnn_mode_inputs(kind, mode, B, L, H)
    ode = kw.get("ode")
    G = 3 if kind == "gru" else 4
    fwd = getattr(fr, f"fused_{kind}_forward")
    fwd_p = getattr(fr, f"fused_{kind}_forward_reference")
    bwd = getattr(fr, f"fused_{kind}_backward")
    bwd_p = getattr(fr, f"fused_{kind}_backward_reference")
    rec_k = getattr(fr, f"fused_{kind}_backward_recurrence")
    fkw = kw if kind == "gru" else dict(save_cs=True, **kw)
    outs = fwd(**inp, **fkw)
    if kind == "gru":
        hs, fouts = outs, (outs,)
        bargs = dict(hs=hs, ghs=ghs, **inp)
    else:
        hs, cs, hcell = fouts = outs
        bargs = dict(hs=hs, cs=cs, ghs=ghs, hcell=hcell, **inp)
    rec = lambda: rec_k(**bargs, **kw)
    r = rec()
    wg = ((lambda: fr.fused_gru_weight_grads(inp["h0"], hs, r.dgh,
                                             xin=r.xin))
          if kind == "gru" else
          (lambda: fr.fused_lstm_weight_grads(hs, r.dgi)))
    g = bwd(**bargs, **kw)
    grads = [v for n, v in zip(g._fields, g)
             if v is not None and n not in ("dmlp", "dwd", "dbd")]
    ms = {"fwd": timed(lambda: fwd(**inp, **fkw)),
          "fwd_plain": timed(lambda: fwd_p(**inp, **fkw), reps=3, warmup=1),
          "bwd_recurrence": timed(rec), "bwd_wgrad": timed(wg),
          "bwd_plain": timed(lambda: bwd_p(**bargs, **kw), reps=3,
                             warmup=1)}
    ms["bwd"] = ms["bwd_recurrence"] + ms["bwd_wgrad"]
    prod = 2 * L * B * G * H * H
    mlp_pairs = 0
    if ode is not None:
        dims = fr._mlp_dims(H, ode.hh, ode.n)
        mlp_pairs = sum(i * j for i, j in dims)
        K = L * ode.steps * B
        av = fr._stream_views(r.acts, K, [i for i, _ in dims])
        zv = fr._stream_views(r.dzs, K, [j for _, j in dims])
        ms["mlpgrad"] = timed(lambda: fr.fused_mlp_weight_grads(
            r.acts, r.dzs, L, B, H, ode))
        ms["mlpgrad_plain"] = timed(lambda: fr.fused_mlp_weight_grads_reference(
            r.acts, r.dzs, L, B, H, ode), reps=5, warmup=1)
        ms["mlpgrad_lib"] = timed(lambda: [torch.matmul(a.T, z)
                                           for a, z in zip(av, zv)])
    dec = kw.get("dec")
    wdprod = 2 * L * B * H * H if dec is not None else 0
    if dec is not None:
        k_c = (L - 1) * B
        ms["wdgrad"] = timed(lambda: fr.fused_lstm_wd_grads(outs[1], r.dzd))
        ms["wdgrad_plain"] = timed(
            lambda: fr.fused_lstm_weight_grads_reference(outs[1], r.dzd),
            reps=5, warmup=1)
        ck, zk = outs[1][:-1].reshape(-1, H), r.dzd[1:].reshape(-1, H)
        ms["wdgrad_lib"] = timed(lambda: torch.matmul(ck.T, zk))
    evolve = 2 * L * B * (ode.steps if ode else 0) * mlp_pairs
    mode_ins = [kw.get("obs"), kw.get("hrow"), kw.get("sel"),
                kw.get("tg")] + ([ode.mlp, ode.dts] if ode else []) + (
                    list(dec) if dec is not None else [])
    ins = list(inp.values()) + mode_ins
    k_x = (L if kind == "gru" else L - 1) * B
    bounds = {
        "fwd": bound(4 * (_numel(*ins) + _numel(*fouts)),
                     prod + evolve + wdprod),
        "bwd": bound(4 * (_numel(*bargs.values(), *mode_ins)
                          + _numel(*grads)),
                     3 * prod + 2 * evolve + 2 * wdprod),
        "wgrad": bound(4 * (k_x * H + L * B * G * H + (H + 1) * G * H),
                       2 * k_x * H * G * H)}
    if ode is not None:
        ps = sum((i + 1) * j for i, j in dims)
        bounds["mlpgrad"] = bound(4 * (_numel(r.acts, r.dzs) + ps),
                                  2 * K * mlp_pairs)
    if dec is not None:
        bounds["wdgrad"] = bound(4 * (k_c * H + L * B * H + (H + 1) * H),
                                 2 * k_c * H * H)
    print(f"{kind.upper()} mode {mode} at B={B} L={L} H={H}: bounds "
          + ", ".join(f"{k} {v[0]:.6f} ms ({v[1]})" for k, v in
                      bounds.items()) + "; " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return ms, bounds


def rnn_modes_times():
    """The hybrids' and the time-aware instances timed at the sweep's shape
    and at H=256, beside the plain LSTM pair ('lstm_plain', mode 0) at
    both: ({'<pair>_<suffix>': ms}, {...: bounds}), the H=256 times under
    '<key> h256'."""
    rs, wide = RNN_SWEEP, RNN_MODE_WIDE
    ms, bounds = {}, {}
    for kind, mode, sfx in RNN_MODES + (("lstm", 0, "plain"),):
        key = f"{kind}_{sfx}"
        ms[key], bounds[key] = rnn_mode_kernel_times(kind, mode, rs["B"],
                                                     rs["L"], rs["H"])
        w_ms, w_bounds = rnn_mode_kernel_times(kind, mode, wide["B"],
                                               wide["L"], wide["H"])
        ms[key].update({f"{k} h256": v for k, v in w_ms.items()})
        bounds[key].update({f"{k} h256": v for k, v in w_bounds.items()})
    return ms, bounds


def rnn_kernel_times(kind, B, L, C, H):
    """Times of one recurrent pair, its plain versions and cuDNN at one
    shape, and the pair's bounds from the same inputs: the bytes of every
    input read once and every output written once (the LSTM forward of a
    training step writes cs too), and the fp32 operations of the recurrent
    products, 2 L B H G H for G gates (the gate math adds ~2%; the
    backward recomputes the product and runs two more: 3x). cuDNN is one
    call of torch.nn.GRU/LSTM on xs (its input projection, over C
    channels, included): the forward, the backward (autograd.grad of a
    retained graph, for xs, h0 and the weights) and both."""
    fwd, bwd, fwd_p, bwd_p = rnn_fns(kind)
    cell, xs, inp, ghs = rnn_kernel_inputs(kind, B, L, C, H)
    if kind == "gru":
        hs = fwd(**inp)
        bargs = dict(hs=hs, ghs=ghs, **inp)
    else:
        hs, cs, _ = fwd(**inp)
        bargs = dict(hs=hs, cs=cs, ghs=ghs, **inp)
    ms = {"fwd": timed(lambda: fwd(**inp)),
          "fwd_plain": timed(lambda: fwd_p(**inp), reps=5, warmup=1),
          "bwd": timed(lambda: bwd(**bargs)),
          "bwd_plain": timed(lambda: bwd_p(**bargs), reps=5, warmup=1)}
    ms["bwd_call"] = ms["bwd"]
    ms.update(backward_times(kind, cell, xs, bargs, ghs))
    torch.backends.cudnn.allow_tf32 = False
    lib = cudnn_module(kind, cell)
    x = xs.clone().requires_grad_(True)
    h0 = inp["h0"][None].clone().requires_grad_(True) if kind == "gru" \
        else None
    args = (x, h0) if kind == "gru" else (x,)
    wrt = [x] + ([h0] if kind == "gru" else []) + list(lib.parameters())
    ms["lib_fwd"] = timed(lambda: lib(*args))
    out, _ = lib(*args)
    ms["lib_bwd"] = timed(lambda: torch.autograd.grad(out, wrt, ghs,
                                                      retain_graph=True))
    ms["lib_fwd_bwd"] = timed(lambda: torch.autograd.grad(lib(*args)[0], wrt,
                                                          ghs))
    G = 3 if kind == "gru" else 4
    prod = 2 * L * B * H * G * H
    n_in = sum(t.numel() for t in inp.values())
    n_fwd_out = L * B * H * (1 if kind == "gru" else 2)
    grads = [g for g in bwd(**bargs) if g is not None]
    n_bwd = sum(t.numel() for t in bargs.values()) + sum(
        g.numel() for g in grads)
    # the weight gradient reads the cell's input states x_t (the GRU's h0
    # and hs[:-1]; the LSTM's hs[:-1], its zero state read from nowhere),
    # the decay where there is one, and W_hh's cotangent [L, B, G H], and
    # writes dW_hh and db_hh: an [H, K] x [K, G H] product over the K rows
    # of nonzero x
    k_x = (L if kind == "gru" else L - 1) * B
    n_wgrad = (k_x * H + (L * B * H if "hdec" in inp else 0)
               + L * B * G * H + (H + 1) * G * H)
    bounds = {"fwd": bound(4 * (n_in + n_fwd_out), prod),
              "bwd": bound(4 * n_bwd, 3 * prod),
              "wgrad": bound(4 * n_wgrad, 2 * k_x * H * G * H)}
    print(f"{kind.upper()} pair at B={B} L={L} H={H}: forward "
          f"{prod / 1e9:.4f} GFLOP, bound {bounds['fwd'][0]:.5f} ms "
          f"({bounds['fwd'][1]}), backward bound {bounds['bwd'][0]:.5f} ms "
          f"({bounds['bwd'][1]}); " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return ms, bounds


def backward_times(kind, cell, xs, bargs, ghs):
    """A recurrent backward's two kernels timed apart (the recurrence, and
    the weight gradient with its plain version and torch.matmul of dW_hh's
    product alone), "bwd" replaced by their sum ("bwd_call" keeps the
    wrapper's time, which adds the sums of the split partials); and
    fused_*_scan forward + backward, the input projection included, which
    is what cuDNN's "lib_fwd_bwd" computes."""
    from snsde_torch.kernels import fused_rnn as fr

    hs, H = bargs["hs"], bargs["hs"].shape[-1]
    rec = getattr(fr, f"fused_{kind}_backward_recurrence")
    wg = getattr(fr, f"fused_{kind}_weight_grads")
    wg_p = getattr(fr, f"fused_{kind}_weight_grads_reference")
    if kind == "lstm":
        dg = rec(**bargs).dgi
        args = (hs, dg)
        x = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    else:
        dg = rec(**bargs).dgh
        args = (bargs["h0"], hs, dg, bargs.get("hdec"))
        x = torch.cat([bargs["h0"][None], hs[:-1]])
    G = dg.shape[-1] // H
    ms = {"bwd_recurrence": timed(lambda: rec(**bargs)),
          "bwd_wgrad": timed(lambda: wg(*args)),
          "wgrad_plain": timed(lambda: wg_p(*args))}
    xk, d1 = x.reshape(-1, H), dg.reshape(-1, G * H)
    ms["wgrad_lib"] = timed(lambda: torch.matmul(xk.T, d1))
    xs_ = xs.clone().requires_grad_(True)
    wrt = [xs_, cell.w_ih, cell.b_ih, cell.w_hh, cell.b_hh]
    scan = (fr.fused_lstm_scan if kind == "lstm" else
            lambda c, v: fr.fused_gru_scan(c, v, h0=bargs["h0"]))
    ms["scan_fwd_bwd"] = timed(lambda: torch.autograd.grad(
        scan(cell, xs_), wrt, ghs))
    # the kernels line's backward: the recurrence and the weight gradient,
    # each timed alone, summed
    ms["bwd"] = ms["bwd_recurrence"] + ms["bwd_wgrad"]
    return ms


def rnn_step_fns(name):
    """One training step (cross-entropy, the 100x fc2 hook, the clip at
    10, Adam) of ISTSClassifier(name) at the recurrent bench width
    (B=1024, L=72, 5 channels, H=32, 4 classes): {label: step()} through
    the kernels and through the eager loop over the cell."""
    from snsde_torch.data import synthetic_uea
    from snsde_torch.harness.robustness import (ISTSClassifier,
                                                ists_train_step,
                                                preprocess_ists)
    from snsde_torch.train.loop import readout_grad_hook

    sh = RNN_BENCH[name]
    X, y, _ = synthetic_uea(n=sh["B"], length=sh["L"], channels=sh["C"] - 1,
                            num_classes=4, seed=0)
    data = preprocess_ists(X)
    dev = torch.device(DEV)
    batch = {"seq": torch.as_tensor(data["seq"], device=dev),
             "coeffs": torch.as_tensor(data["coeffs"], device=dev),
             "y": torch.as_tensor(y, device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = ISTSClassifier(name, sh["C"] - 1, sh["L"], sh["H"], 4,
                               generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        readout_grad_hook("fc2")(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out[label] = (lambda model=model, opt=opt, fused=fused:
                      ists_train_step(model, opt, batch, use_fused=fused))
    return out


def time_lstm_step_fns(name):
    """One training step (as rnn_step_fns) of ISTSClassifier(name) on one
    batch of the sweep cell (uea_b_noisy, B=64, L=60, 5 channels, hidden
    16, missing 0.3): {label: step()} through the kernels and through the
    eager loop over the cells."""
    from snsde_torch.harness.robustness import (ISTSClassifier,
                                                coeff_family,
                                                ists_train_step,
                                                preprocess_ists)
    from snsde_torch.train.loop import readout_grad_hook

    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:SWEEP["B"]], missing_rate=0.3,
                           interpolation=coeff_family(name), seed=0)
    dev = torch.device(DEV)
    batch = {"seq": torch.as_tensor(data["seq"], device=dev),
             "coeffs": torch.as_tensor(data["coeffs"], device=dev),
             "y": torch.as_tensor(y[:SWEEP["B"]], device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = ISTSClassifier(name, SWEEP["D"], SWEEP["L"], SWEEP["H"],
                               SWEEP["classes"],
                               generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        readout_grad_hook("fc2")(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out[label] = (lambda model=model, opt=opt, fused=fused:
                      ists_train_step(model, opt, batch, use_fused=fused))
    return out


def spline_times(reps=3):
    """Host seconds (median of `reps`) of the natural cubic fit of the
    forecasting path's input windows, 4000 x 14 = 56,000 series of 50
    knots, by each of `natural_cubic_coeffs`'s two paths: the clean fit it
    takes when no value is missing and the batched NaN-aware fit it takes
    otherwise; and how far apart their coefficients are on this input."""
    from snsde_torch.data import synthetic_mujoco
    from snsde_torch.ops.interp import (_natural_coeffs_clean,
                                        _natural_coeffs_missing)

    L = SRK["L"]
    X, _ = synthetic_mujoco(n=N_MUJOCO, length=L + SRK["T"], seed=0)
    x = torch.as_tensor(X[:, :L]).transpose(-1, -2).contiguous()  # [N, C, L]
    times = torch.arange(L, dtype=x.dtype)
    fits = {"clean": lambda: _natural_coeffs_clean(times, x),
            "NaN-aware": lambda: tuple(
                v.reshape(x.shape[:-1] + (L - 1,))
                for v in _natural_coeffs_missing(times, x.reshape(-1, L)))}
    out, sec = {}, {}
    for name, fit in fits.items():
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out[name] = fit()
            runs.append(time.perf_counter() - t0)
        sec[name] = statistics.median(runs)
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["clean"], out["NaN-aware"]))
    print(f"host: natural cubic fit of {x.shape[0] * x.shape[1]} series of "
          f"{L} knots: clean {sec['clean']:.4f} s, NaN-aware "
          f"{sec['NaN-aware']:.4f} s (median of {reps}); coefficients "
          f"differ by {diff:.3e} at most", flush=True)


def timed(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median ms of fn() over `reps` runs after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def kernel_times(shape, srk=False):
    """Times of one kernel pair and its plain versions at a path's shape,
    and the pair's bounds computed from the same inputs: the bytes of every
    input read once and every output written once, and the fp32 operations
    of the MLP products (one MLP evaluation per EM step, two per SRK step;
    the backward recomputes them and runs each evaluation's two products
    back: 3x)."""
    inp, gys = kernel_inputs(shape["model"], shape["B"], shape["L"],
                             shape["C"], shape["H"], shape["layers"], srk=srk)
    return sde_pair_times(inp, gys, srk)


def sde_pair_times(inp, gys, srk=False):
    """kernel_times on given inputs of the EM or SRK pair."""
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns("srk" if srk else "em")
    fwd, flags = _split(inp, srk)
    ys, _ = fwd_k(*fwd, **flags)
    bwd_args = [fwd[0], ys, gys] + fwd[1:]
    ms = {"fwd": timed(lambda: fwd_k(*fwd, **flags)),
          "fwd_plain": timed(lambda: fwd_p(*fwd, **flags)),
          "bwd": timed(lambda: bwd_k(*bwd_args, **flags)),
          "bwd_plain": timed(lambda: bwd_p(*bwd_args, **flags))}
    M, B, H = ys.shape
    HH = inp["wy"].shape[1]
    n_inner = inp["w_inner"].shape[0]
    evals = 2 if srk else 1
    products = 2 * evals * M * B * (H * HH + n_inner * HH * HH + HH * H)
    nbytes_in = 4 * sum(t.numel() for t in fwd if t is not None)
    grads = bwd_k(*bwd_args, **flags)
    bounds = {"fwd": bound(nbytes_in + 4 * ys.numel(), products),
              "bwd": bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                            + sum(g.numel() for g in grads
                                                  if g is not None)),
                           3 * products)}
    ms_w, bounds["wgrad"] = sde_backward_times("srk" if srk else "em", fwd,
                                               ys, gys, flags)
    ms.update(ms_w)
    return ms, bounds


def sde_products(key, flags, M, B, H, HH, NI):
    """fp32 operations of an SDE pair's forward: the drift MLP's products
    (one evaluation an EM step, two an SRK step; no first product in drift
    mode 'xt') and the noise nets' (one diffusion evaluation an EM step,
    four an SRK step; H x H a layer)."""
    evals, nevals = (2, 4) if key == "srk" else (1, 1)
    first = 0 if flags["drift"] == "xt" else H * HH
    nets = {"net1": 1, "net2": 2}.get(flags["noise"], 0)
    return 2 * M * B * (evals * (first + NI * HH * HH + HH * H)
                        + nevals * nets * H * H)


def mode_kernel_times(reps=10):
    """Phase 5's new modes: each pair's forward and backward (the wrapper:
    recurrence, weight gradient, sums) in MODE_TIMES at the sweep's shape
    (B=64, L=60, C=6, H=16) and the sepsis width (B=1024, L=72, C=69,
    H=49), two hidden layers, median of `reps`; the plain versions at the
    sweep's shape (3 runs); and the bounds of each from its inputs (the
    bytes of every input and output once, sde_products; the backward 3x
    the forward's operations). {name: ms}, {name: bound}."""
    ms, bounds = {}, {}
    shapes = {"sweep": (SWEEP["B"], SWEEP["L"], SWEEP["D"] + 1, SWEEP["H"]),
              "sepsis": (MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"])}
    for key in ("em", "srk"):
        fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(key)
        for io, no in MODE_TIMES:
            for sname, (B, L, C, H) in shapes.items():
                inp, gys = kernel_inputs(mode_name(io, no), B, L, C, H, 2,
                                         srk=key == "srk")
                fwd, flags = _split(inp, key == "srk")
                ys, ns = fwd_k(*fwd, **flags)
                args = [fwd[0], ys, gys] + fwd[1:]
                tag = f"{key} ({io},{no}) {sname}"
                ms[f"{tag} fwd"] = timed(lambda: fwd_k(*fwd, **flags),
                                         reps=reps, warmup=2)
                ms[f"{tag} bwd"] = timed(
                    lambda: bwd_k(*args, **flags, ns=ns), reps=reps,
                    warmup=2)
                if sname == "sweep":
                    ms[f"{tag} fwd_plain"] = timed(
                        lambda: fwd_p(*fwd, **flags), reps=3, warmup=1)
                    ms[f"{tag} bwd_plain"] = timed(
                        lambda: bwd_p(*args, **flags, ns=ns), reps=3,
                        warmup=1)
                M = ys.shape[0]
                flops = sde_products(key, flags, M, B, H, H, 1)
                n_in = sum(t.numel() for t in fwd if t is not None)
                n_ns = sum(t.numel() for t in (ns or ()) if t is not None)
                grads = bwd_k(*args, **flags, ns=ns)
                n_g = sum(g.numel() for g in grads if g is not None)
                bounds[f"{tag} fwd"] = bound(4 * (n_in + ys.numel() + n_ns),
                                             flops)
                bounds[f"{tag} bwd"] = bound(
                    4 * (n_in + 2 * ys.numel() + n_ns + n_g), 3 * flops)
                print(f"new mode times {tag} (B={B}, M={M}, H={H}): "
                      f"fwd {ms[tag + ' fwd']:.4f} ms, bwd "
                      f"{ms[tag + ' bwd']:.4f} ms; bounds "
                      f"{bounds[tag + ' fwd']}, {bounds[tag + ' bwd']}",
                      flush=True)
    return ms, bounds


def sde_backward_times(key, fwd, ys, gys, flags):
    """The EM or SRK backward's two kernels timed apart (the recurrence,
    and the weight gradient with its plain version and torch.matmul of its
    products), "bwd" then their sum ("bwd_call" the wrapper's time, which
    adds the sums of the partials); and the weight gradient's bound: its
    streams read once (the states each first layer read, dz1, the
    activations, the inner cotangents, dz3 and q) and its outputs written
    once, and 2 K (H HH + NI HH HH + HH H) operations over its K rows (M B
    for the EM, 2 M B over the SRK's two evaluations)."""
    mod = _kernel_modules()[key]
    fn = lambda n: getattr(mod, f"fused_{key}_{n}")
    y0 = fwd[0]
    rec_args = (y0, ys, gys) + tuple(fwd[1:])
    st = fn("backward_recurrence")(*rec_args, **flags)
    ms = {"bwd_call": timed(lambda: fn("backward")(*rec_args, **flags)),
          "bwd_recurrence": timed(lambda: fn("backward_recurrence")(
              *rec_args, **flags)),
          "bwd_wgrad": timed(lambda: fn("weight_grads")(y0, ys, st)),
          "wgrad_plain": timed(lambda: wgrad_plain(key, y0, ys, st, None,
                                                   flags))}
    M, B, H = ys.shape
    HH, NI = st.dxh.shape[-1], st.es.shape[0]
    xs = [y0[None], ys[:-1]] + ([st.h01] if key == "srk" else [])
    x = torch.cat(xs).reshape(-1, H)
    pairs = ([(x, st.dxh.reshape(-1, HH))]
             + [(st.hs[l].reshape(-1, HH), st.es[l].reshape(-1, HH))
                for l in range(NI)]
             + [(st.hs[NI].reshape(-1, HH), st.dz3.reshape(-1, H))])
    ms["wgrad_lib"] = timed(lambda: [torch.matmul(a.T, e) for a, e in pairs])
    ms["bwd"] = ms["bwd_recurrence"] + ms["bwd_wgrad"]
    evals = 2 if key == "srk" else 1
    K = evals * M * B
    n_in = K * (H + HH + (NI + 1) * HH + NI * HH + H) + st.q.numel()
    n_out = (H * HH + NI * (HH * HH + HH) + HH * H + H + evals * M * HH
             + st.q.numel() // B)
    flops = 2 * K * (H * HH + NI * HH * HH + HH * H)
    print(f"{key.upper()} backward at B={B} M={M} H={H} HH={HH}: " +
          ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return ms, bound(4 * (n_in + n_out), flops)


def cde_flops(flags, M, B, H, HH, C, n_inner):
    """The fp32 operations of a CDE forward (per stage and row: the MLP's
    products, or the GRU-ODE field's three gate products, and the [H, C]
    contraction with dX/dt)."""
    from snsde_torch.kernels import fused_cde as fc

    stages = len(fc._TABLEAUS[flags["method"]][2])
    if flags["act"] == "gruode":
        per_eval = 2 * 3 * H * H * C + 2 * H * C
    else:
        per_eval = 2 * (H * HH + n_inner * HH * HH + HH * H * C) + 2 * H * C
    return stages * M * B * per_eval


def cde_kernel_times(shape, method="rk4", field="final_tanh"):
    """Times of the CDE pair and its plain versions (fewer runs: the plain
    backward at 136 rk4 steps takes a large part of a second), and its
    bounds from the same inputs: the bytes of every input read once and
    every output written once, and the fp32 operations of the field
    (cde_flops; the backward recomputes each evaluation and runs its
    products back: 3x)."""
    fwd, flags, gys = cde_kernel_inputs(shape["B"], shape["L"], shape["C"],
                                        shape["H"], shape["n_inner"], method,
                                        field)
    return cde_times(fwd, flags, gys, field)


def cde_times(fwd, flags, gys, label):
    """cde_kernel_times on given inputs of the pair (`label` names them in
    the printed bounds)."""
    from snsde_torch.kernels import fused_cde as fc

    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns("cde")
    ys, _ = fwd_k(*fwd, **flags)
    bwd_args = [fwd[0], ys, gys] + fwd[1:]
    ms = {"fwd": timed(lambda: fwd_k(*fwd, **flags)),
          "fwd_plain": timed(lambda: fwd_p(*fwd, **flags), reps=5, warmup=1),
          "bwd": timed(lambda: bwd_k(*bwd_args, **flags)),
          "bwd_plain": timed(lambda: bwd_p(*bwd_args, **flags), reps=5,
                             warmup=1)}
    M, B, H, HH, C, n_inner = fc.check_kernel_inputs(*fwd, **flags)
    flops = cde_flops(flags, M, B, H, HH, C, n_inner)
    nbytes_in = 4 * sum(t.numel() for t in fwd if t is not None)
    grads = bwd_k(*bwd_args, **flags)
    bounds = {"fwd": bound(nbytes_in + 4 * ys.numel(), flops),
              "bwd": bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                            + sum(g.numel() for g in grads
                                                  if g is not None)),
                           3 * flops)}
    print(f"CDE pair ({label}) at B={B} M={M} C={C} H={H} n_inner={n_inner}: "
          f"forward {flops / 1e9:.3f} GFLOP, bound "
          f"{bounds['fwd'][0]:.5f} ms ({bounds['fwd'][1]}), backward bound "
          f"{bounds['bwd'][0]:.5f} ms ({bounds['bwd'][1]})", flush=True)
    return ms, bounds


def cde_step_fns():
    """One training step (cross-entropy, the 100x fc2 hook, the clip at
    10, Adam) of ISTSClassifier("neuralcde") at the uea_rk4 width (B=1024,
    L=72, 5 channels + time, H=32, FinalTanh with one inner layer, 4
    classes): {label: step()} through the CDE kernels and through the
    eager cdeint."""
    from snsde_torch.data import synthetic_uea
    from snsde_torch.harness.robustness import (ISTSClassifier,
                                                ists_train_step,
                                                preprocess_ists)
    from snsde_torch.train.loop import readout_grad_hook

    sh = CDE["uea_rk4"]
    X, y, _ = synthetic_uea(n=sh["B"], length=sh["L"], channels=sh["C"] - 1,
                            num_classes=4, seed=0)
    data = preprocess_ists(X, interpolation="natural")
    dev = torch.device(DEV)
    batch = {"seq": torch.as_tensor(data["seq"], device=dev),
             "coeffs": torch.as_tensor(data["coeffs"], device=dev),
             "y": torch.as_tensor(y, device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = ISTSClassifier("neuralcde", sh["C"] - 1, sh["L"], sh["H"], 4,
                               num_hidden_layers=sh["n_inner"] + 1,
                               generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        readout_grad_hook("fc2")(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out[label] = (lambda model=model, opt=opt, fused=fused:
                      ists_train_step(model, opt, batch, use_fused=fused))
    return out


def sepsis_step_fns():
    """One training step of the sepsis model on one batch of 1024
    sepsis-shaped samples: {label: step()} through the kernels and through
    the eager solver."""
    from snsde_torch.data import preprocess_classification, synthetic_sepsis
    from snsde_torch.harness.classification import build_sepsis_model
    from snsde_torch.train.loop import (TrainConfig, make_loss_fn,
                                        make_optimizer, readout_grad_hook,
                                        train_step)

    cfg = main_config()
    X, static, y, lengths, _ = synthetic_sepsis(n=MAIN["B"],
                                                length=MAIN["L"], seed=0)
    data = preprocess_classification(X, y, lengths, use_intensity=True,
                                     times=np.arange(MAIN["L"],
                                                     dtype=np.float32))
    times = data["times"]
    dev = torch.device(DEV)
    splits = ("train", "val", "test")
    cat = lambda k: np.concatenate([data[s][k] for s in splits])
    batch = {"coeffs": torch.as_tensor(cat("coeffs"), device=dev),
             "final_index": torch.as_tensor(cat("final_index"), device=dev),
             "y": torch.as_tensor(cat("y"), dtype=torch.float32, device=dev),
             "static": torch.as_tensor(static, device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = build_sepsis_model(cfg, data["input_channels"],
                                   static.shape[-1], dev)
        tc = TrainConfig(pos_weight=10.0)
        readout_grad_hook("sde.readout.linear2")(model)

        def apply_fn(m, b, g, fused=fused):
            return m(times, b["coeffs"], b["static"], b["final_index"],
                     generator=g, use_fused=fused)[..., 0]

        loss_fn = make_loss_fn(apply_fn, lambda m: m.sde.func, tc)
        opt = make_optimizer(model, tc)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[label] = (lambda model=model, opt=opt, loss_fn=loss_fn, gen=gen:
                      train_step(model, opt, loss_fn, batch, gen))
    return out


def mujoco_step_fns(method="srk"):
    """One training step of the forecasting model (mse + 0.01 L2, coupled-
    L2 Adam) on one batch of 1024 MuJoCo-shaped windows: {label: step()}
    through the SRK kernels and through the eager srk solver (with a
    method no kernel takes, both through the eager solver)."""
    from snsde_torch.data import synthetic_mujoco
    from snsde_torch.harness.forecasting import (forecast_coeffs,
                                                 make_forecast_model)
    from snsde_torch.train.loop import train_step, weight_regularization

    cfg = mujoco_config()
    L, T = SRK["L"], SRK["T"]
    X, _ = synthetic_mujoco(n=SRK["B"], length=L + T, seed=0)
    times = np.arange(L, dtype=np.float32)
    dev = torch.device(DEV)
    batch = {"coeffs": torch.as_tensor(forecast_coeffs(cfg, X[:, :L], times),
                                       device=dev),
             "y": torch.as_tensor(X[:, L:], device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model, reg_fn = make_forecast_model(
            cfg.model_name, SRK["C"], SRK["H"], SRK["H"], SRK["layers"],
            SRK["C"], T, method=method,
            generator=torch.Generator().manual_seed(0))
        model = model.to(dev)

        def loss_fn(m, b, g, fused=fused, reg_fn=reg_fn):
            pred = m(times, b["coeffs"], generator=g, use_fused=fused)
            return (torch.mean((pred - b["y"]) ** 2)
                    + weight_regularization(reg_fn(m), 0.01)), pred

        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                               weight_decay=cfg.weight_decay)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[label] = (lambda model=model, opt=opt, loss_fn=loss_fn, gen=gen:
                      train_step(model, opt, loss_fn, batch, gen))
    return out


def step_times(label, steps, eager_reps=EAGER_REPS):
    """Median step time through the kernels and through the eager solver,
    and a profiler window of the kernel step."""
    ms = {"train_step": timed(steps["train_step"]),
          "train_step_eager": timed(steps["train_step_eager"],
                                    reps=eager_reps, warmup=1)}
    profile_step(label, steps["train_step"])
    return ms


def profile_step(label, step, n=5):
    """Where one training step's time goes: device time by kernel over n
    steps (torch.profiler), and the device's busy share of the window (the
    profiler's own host cost inflates the wall time). Returns (wall ms,
    device ms) a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(n):
            step()
        b.record()
        b.synchronize()
    wall = a.elapsed_time(b) / n
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3 / n)
    busy = sum(by_name.values())
    print(f"profile of one {label} train step (mean of {n}): {wall:.3f} ms "
          f"wall, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.4f} ms {100 * ms / wall:5.1f}%  {name[:100]}")
    return wall, busy


_AB_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
print("AB", json.dumps({{name: c.timed(make()["train_step"], reps={reps})
                        for name, make in (("sepsis", c.sepsis_step_fns),
                                           ("mujoco", c.mujoco_step_fns),
                                           ("cde", c.cde_step_fns))}}),
      flush=True)
"""


def ab_steps(parent: str, pairs: int = 16, reps: int = 100) -> int:
    """A/B of the SDE paths' and the uea_rk4 Neural CDE classifier's
    training steps through the kernels between a parent checkout (the
    directory `parent`) and this one:

        python3 chip_smoke.py --ab-steps PARENT_DIR [PAIRS [REPS]]

    Each of `pairs` rounds runs one process per tree, in the order parent,
    change, then change, parent in the next round; each process times
    `reps` steps of the sepsis, the MuJoCo and the CDE step (`timed`,
    median)
    with that tree's own chip_smoke.py and package. Prints every process's
    medians, then per path the median and quartiles of each tree's
    process medians, the median of the per-round differences (change minus
    parent) and the rounds the change was faster in."""
    import os

    trees = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    got = {t: [] for t in trees}
    for i in range(pairs):
        for tree in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            code = _AB_CHILD.format(root=trees[tree], reps=reps)
            out = subprocess.run([sys.executable, "-c", code],
                                 cwd=trees[tree], capture_output=True,
                                 text=True, timeout=600, check=True).stdout
            ms = json.loads(out.split("AB ", 1)[1])
            got[tree].append(ms)
            print(f"AB round {i} {tree}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    for path in ("sepsis", "mujoco", "cde"):
        per = {t: [m[path] for m in got[t]] for t in trees}
        diff = [c - p for c, p in zip(per["change"], per["parent"])]
        for t, v in per.items():
            q1, q2, q3 = statistics.quantiles(v, n=4)
            print(f"AB {path} {t}: median {statistics.median(v):.4f} ms, "
                  f"quartiles {q1:.4f} / {q3:.4f} over {len(v)} processes")
        print(f"AB {path}: change minus parent per round, median "
              f"{statistics.median(diff):+.4f} ms; change faster in "
              f"{sum(d < 0 for d in diff)} of {len(diff)} rounds")
    return 0


_AB_RNN_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
from snsde_torch.kernels import fused_rnn as fr
kind = {kind!r}
fwd = getattr(fr, "fused_" + kind + "_forward")
bwd = getattr(fr, "fused_" + kind + "_backward")
out = {{}}
for name, (B, L, C, H, dec) in {shapes!r}.items():
    _, _, inp, ghs = c.rnn_kernel_inputs(kind, B, L, C, H, dec)
    res = fwd(**inp)
    extra = dict(hs=res[0], cs=res[1]) if kind == "lstm" else dict(hs=res)
    out[name + " fwd"] = c.timed(lambda: fwd(**inp), reps={reps})
    out[name + " bwd"] = c.timed(lambda: bwd(ghs=ghs, **extra, **inp),
                                 reps={reps})
    if kind == "lstm":  # its two backward kernels apart
        rec, wg = fr.fused_lstm_backward_recurrence, fr.fused_lstm_weight_grads
        dg = rec(ghs=ghs, **extra, **inp)
        dg = dg[0] if isinstance(dg, tuple) else dg  # a parent's: dgi alone
        out[name + " bwd rec"] = c.timed(
            lambda: rec(ghs=ghs, **extra, **inp), reps={reps})
        out[name + " bwd wgrad"] = c.timed(lambda: wg(extra["hs"], dg),
                                           reps={reps})
print("AB", json.dumps(out), flush=True)
"""


_AB_SDE_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
# a forward's ys (a parent tree's forwards may return ys alone)
ys_of = lambda o: o[0] if isinstance(o, tuple) else o
out = {{}}
for key, shape in (("em", c.MAIN), ("srk", c.SRK)):
    fwd_k, _, bwd_k, _ = c.kernel_fns(key)
    inp, gys = c.kernel_inputs(shape["model"], shape["B"], shape["L"],
                               shape["C"], shape["H"], shape["layers"],
                               srk=key == "srk")
    fwd, flags = c._split(inp, key == "srk")
    ys = ys_of(fwd_k(*fwd, **flags))
    args = [fwd[0], ys, gys] + fwd[1:]
    out[key + " fwd"] = c.timed(lambda: fwd_k(*fwd, **flags), reps={reps})
    out[key + " bwd"] = c.timed(lambda: bwd_k(*args, **flags), reps={reps})
for key in ("em", "srk"):
    fwd_k, _, bwd_k, _ = c.kernel_fns(key)
    for H in {wide!r}:
        inp, gys = c.kernel_inputs(c.MAIN["model"], c.MAIN["B"], c.MAIN["L"],
                                   c.MAIN["C"], H, 2, srk=key == "srk")
        fwd, flags = c._split(inp, key == "srk")
        ys = ys_of(fwd_k(*fwd, **flags))
        args = [fwd[0], ys, gys] + fwd[1:]
        out["%s H=HH=%d fwd" % (key, H)] = c.timed(
            lambda: fwd_k(*fwd, **flags), reps={wide_reps}, warmup=2)
        out["%s H=HH=%d bwd" % (key, H)] = c.timed(
            lambda: bwd_k(*args, **flags), reps={wide_reps}, warmup=2)
fwd_k, _, bwd_k, _ = c.kernel_fns("cde")
fwd, flags, gys = c.cde_kernel_inputs(c.SWEEP["B"], c.SWEEP["L"],
                                      c.SWEEP["D"] + 1, c.SWEEP["H"], 0)
ys = ys_of(fwd_k(*fwd, **flags))
args = [fwd[0], ys, gys] + fwd[1:]
out["cde sweep fwd"] = c.timed(lambda: fwd_k(*fwd, **flags), reps={reps})
out["cde sweep bwd"] = c.timed(lambda: bwd_k(*args, **flags), reps={reps})
print("AB", json.dumps(out), flush=True)
"""


def _ab_rounds(tag, child, parent, pairs):
    """Run child(tree's root) (a program's code) in one process per tree
    and round, in the order parent, change, then change, parent;
    print every process's medians, then per key and tree the median over
    processes and the rounds in which the change was faster."""
    import os

    trees = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    got = {t: [] for t in trees}
    for i in range(pairs):
        for tree in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            out = subprocess.run([sys.executable, "-c", child(trees[tree])],
                                 cwd=trees[tree], capture_output=True,
                                 text=True, timeout=600, check=True).stdout
            ms = json.loads(out.split("AB ", 1)[1])
            got[tree].append(ms)
            print(f"{tag} round {i} {tree}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    for key in got["change"][0]:
        per = {t: [m[key] for m in got[t]] for t in trees}
        faster = sum(c < p for c, p in zip(per["change"], per["parent"]))
        med = {t: statistics.median(v) for t, v in per.items()}
        print(f"{tag} {key}: parent median {med['parent']:.4f} ms (range "
              f"{min(per['parent']):.4f}-{max(per['parent']):.4f}), change "
              f"{med['change']:.4f} ms (range {min(per['change']):.4f}-"
              f"{max(per['change']):.4f}), change faster in {faster} of "
              f"{pairs} rounds")
    return 0


def ab_rnn(kind: str, parent: str, pairs: int = 4, reps: int = 30) -> int:
    """A/B of the GRU or LSTM kernels between a parent checkout (the
    directory `parent`) and this one:

        python3 chip_smoke.py --ab-gru PARENT_DIR [PAIRS [REPS]]
        python3 chip_smoke.py --ab-lstm PARENT_DIR [PAIRS [REPS]]

    Each of `pairs` rounds runs one process per tree, in the order parent,
    change, then change, parent; each times `fused_*_forward` and
    `fused_*_backward` (the whole wrapper: the backward kernel or kernels
    and the sums of their partials; the LSTM's recurrence and weight
    gradient also apart) with that tree's own package, at the sweep's
    shape (the GRU with and without the decay stream) and the bench shapes
    (`timed`, median of `reps`)."""
    shapes = {"sweep": (RNN_SWEEP["B"], RNN_SWEEP["L"], RNN_SWEEP["C"],
                        RNN_SWEEP["H"], False)}
    if kind == "gru":
        shapes["sweep hdec"] = shapes["sweep"][:4] + (True,)
    for name, sh in RNN_BENCH.items():
        if sh["kind"] == kind:
            shapes[f"bench H={sh['H']}"] = (sh["B"], sh["L"], sh["C"],
                                            sh["H"], False)
    return _ab_rounds(f"AB-{kind.upper()}", lambda root: _AB_RNN_CHILD.format(
        root=root, shapes=shapes, reps=reps, kind=kind), parent, pairs)


def ab_kernels(parent: str, pairs: int = 4, reps: int = 30) -> int:
    """A/B of the EM and SRK pairs at the sepsis and MuJoCo shapes, both
    also at the sepsis shape with H=HH=128 and 256 (one inner layer;
    median of 10), and the CDE pair at the sweep's shape (kernels only,
    `timed`, median of `reps`) between a parent checkout and this one, as
    ab_rnn:

        python3 chip_smoke.py --ab-kernels PARENT_DIR [PAIRS [REPS]]"""
    return _ab_rounds("AB-SDE", lambda root: _AB_SDE_CHILD.format(
        root=root, reps=reps, wide=WIDE_H, wide_reps=10), parent, pairs)


# the CDE pair's shapes of --ab-cde: (B, L, C, H, n_inner, reps)
AB_CDE = {"sweep": (SWEEP["B"], SWEEP["L"], SWEEP["D"] + 1, SWEEP["H"], 0,
                    REPS),
          **{name: (sh["B"], sh["L"], sh["C"], sh["H"], sh["n_inner"], REPS)
             for name, sh in CDE.items()},
          **{f"uea_rk4 H=HH={H}": (CDE["uea_rk4"]["B"], CDE["uea_rk4"]["L"],
                                   CDE["uea_rk4"]["C"], H, 1, 3)
             for H in WIDE_H}}

_AB_CDE_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
# a forward's ys (a parent tree's forwards may return ys alone)
ys_of = lambda o: o[0] if isinstance(o, tuple) else o
fwd_k, _, bwd_k, _ = c.kernel_fns("cde")
out = {{}}
for name, (B, L, C, H, n_inner, reps) in {shapes!r}.items():
    fwd, flags, gys = c.cde_kernel_inputs(B, L, C, H, n_inner)
    ys = ys_of(fwd_k(*fwd, **flags))
    args = [fwd[0], ys, gys] + fwd[1:]
    out[name + " fwd"] = c.timed(lambda: fwd_k(*fwd, **flags), reps=reps,
                                 warmup=min(reps, 3))
    out[name + " bwd"] = c.timed(lambda: bwd_k(*args, **flags), reps=reps,
                                 warmup=min(reps, 3))
print("AB", json.dumps(out), flush=True)
"""


def ab_cde(parent: str, pairs: int = 4, reps: int = REPS) -> int:
    """A/B of the CDE pair (kernels only, `timed`, median of `reps`; 3 at
    H=HH=128 and 256) at the sweep's shape, both bench shapes and
    `uea_rk4` at H=HH=128 and 256, between a parent checkout and this one,
    as ab_rnn:

        python3 chip_smoke.py --ab-cde PARENT_DIR [PAIRS [REPS]]"""
    shapes = {k: v[:5] + (reps if v[5] == REPS else v[5],)
              for k, v in AB_CDE.items()}
    return _ab_rounds("AB-CDE", lambda root: _AB_CDE_CHILD.format(
        root=root, shapes=shapes), parent, pairs)


# A source's barriers get a clock64() reading of block 0's thread 0 after
# them; the cycles since the previous reading are charged to the barrier's
# line (cde_ph), so each line's sum is the time of the phase it ends. The
# source's own headers are instrumented too, their lines PHASE_FILE apart.
PHASE_FILE = 4096
_PHASE_HEAD = """
__device__ unsigned long long cde_ph_cycles[16384];
__device__ long long cde_ph_last;
__device__ __forceinline__ void cde_ph(int line) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const long long t = clock64();
    if (line >= 0) cde_ph_cycles[line] += t - cde_ph_last;
    cde_ph_last = t;
  }
}
"""
_PHASE_TAIL = """
extern "C" int cde_phase_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, cde_ph_cycles, sizeof(cde_ph_cycles));
  static unsigned long long zero[16384];
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(cde_ph_cycles, zero, sizeof(zero));
  return (int)e;
}
"""


def instrument(src: str, base: int = 0, fname: str = ""):
    """A source with a clock reading after every barrier (the block's or
    the cluster's; not inside the helper that picks one) and at each
    kernel's start; and {base + line: (file: function, the nearest comment
    above)}. A .cu file gets the reading's definitions at its top and the
    read-out entry at its end; a header only the readings."""
    import re

    out, where, func, note, helper = [], {}, "", "", False
    for i, line in enumerate(src.splitlines()):
        names = [n for n in re.findall(r"(\w+)\(", line)
                 if n != "__launch_bounds__"]
        if names and not line.startswith((" ", "#", "//", "}")):
            func, note = names[0], ""
        helper = helper or "void cluster_or_block_sync(" in line
        if line.strip().startswith("//"):
            note = line.strip()[3:]
        barrier = ("__syncthreads();" in line or ".sync();" in line
                   or "cluster_sync();" in line
                   or re.search(r"cluster_or_block_sync\([^)]*\);", line))
        # the weight-gradient kernel runs after the loop, timed apart
        if barrier and not helper and "wgrad" not in func:
            line += f" cde_ph({base + i});"
            where[base + i] = (f"{fname}: {func}" if fname else func, note)
        if "extern __shared__" in line:
            line += " cde_ph(-1);"
        if helper and line == "}":
            helper = False
        out.append(line)
    text = "\n".join(out)
    if base == 0:
        text = _PHASE_HEAD + text + _PHASE_TAIL
    return text, where


_PHASE_CHILD = """
import ctypes, importlib.util, json, os, subprocess, sys, tempfile
sys.path.insert(0, {root!r})
import torch
import chip_smoke as c
from snsde_torch.kernels import _build
spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", os.path.join({here!r}, "chip_smoke.py"))
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
tmp = tempfile.mkdtemp()
name = "fused_" + {pair!r}
src, where = here.instrument(open(os.path.join(_build.CSRC,
                                               name + ".cu")).read())
open(os.path.join(tmp, name + ".cu"), "w").write(src)
heads = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cuh"))
for k, f in enumerate(heads):
    text, w = here.instrument(open(os.path.join(_build.CSRC, f)).read(),
                              (k + 1) * here.PHASE_FILE, f)
    where.update(w)
    open(os.path.join(tmp, f), "w").write(text)
lib_path = os.path.join(tmp, "libphase.so")
subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                os.path.join(tmp, name + ".cu")], check=True,
               capture_output=True)
lib = ctypes.CDLL(lib_path)
_build.load = lambda name: lib
buf = (ctypes.c_ulonglong * 16384)()
# a forward's ys (a tree's forwards may return ys alone)
ys_of = lambda o: o[0] if isinstance(o, tuple) else o
fwd_k, _, bwd_k, _ = c.kernel_fns({pair!r})
out = {{}}
for label, shape in {shapes!r}.items():
    if {pair!r} == "cde":
        fwd, flags, gys = c.cde_kernel_inputs(*shape)
    else:
        inp, gys = c.kernel_inputs(*shape, srk={pair!r} == "srk")
        fwd, flags = c._split(inp, {pair!r} == "srk")
    ys = ys_of(fwd_k(*fwd, **flags))
    args = [fwd[0], ys, gys] + fwd[1:]
    for part, fn in (("fwd", lambda: fwd_k(*fwd, **flags)),
                     ("bwd", lambda: bwd_k(*args, **flags))):
        fn()
        assert lib.cde_phase_read(buf) == 0
        fn()
        assert lib.cde_phase_read(buf) == 0
        out[label + " " + part] = {{i: [buf[i], *where[i]] for i in where
                                   if buf[i]}}
print("PHASES", json.dumps(out), flush=True)
"""


def phase_split(args) -> int:
    """Where one launch of a pair spends block 0's cycles, by phase (the
    barrier that ends it), for each tree's source and headers (instrument),
    one process a tree and pair:

        python3 chip_smoke.py --phase-split [em|srk|cde] TREE [TREE ...]

    The CDE pair at the sweep's shape and both bench shapes; the EM pair
    at the sepsis shape and the SRK pair at the MuJoCo shape, each also
    at H=HH=128 (one inner layer, the sepsis batch, length and channels);
    every pair when none is named. A launch's backward includes only the
    kernels the wrapper launches on the card: where the weight gradient
    runs apart, its kernel is timed by the other modes, not split here."""
    import os

    pairs = ("cde", "em", "srk")
    if args and args[0] in pairs:
        pairs, args = (args[0],), args[1:]
    shapes = {
        "cde": {"sweep": AB_CDE["sweep"][:5],
                **{n: AB_CDE[n][:5] for n in CDE}},
        "em": {"sepsis": (MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"],
                          MAIN["H"], MAIN["layers"]),
               **{f"sepsis H=HH={H}": (MAIN["model"], MAIN["B"], MAIN["L"],
                                       MAIN["C"], H, 2) for H in WIDE_H[:1]}},
        "srk": {"mujoco": (SRK["model"], SRK["B"], SRK["L"], SRK["C"],
                           SRK["H"], SRK["layers"]),
                **{f"sepsis H=HH={H}": (MAIN["model"], MAIN["B"], MAIN["L"],
                                        MAIN["C"], H, 2)
                   for H in WIDE_H[:1]}}}
    here = os.path.dirname(os.path.abspath(__file__))
    for tree in args:
        root = os.path.abspath(tree)
        for pair in pairs:
            code = _PHASE_CHILD.format(root=root, here=here, pair=pair,
                                       shapes=shapes[pair])
            res = subprocess.run([sys.executable, "-c", code], cwd=root,
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(res.stdout[-3000:], res.stderr[-6000:])
                return 1
            got = json.loads(res.stdout.split("PHASES ", 1)[1])
            for launch, lines in got.items():
                total = sum(v[0] for v in lines.values())
                print(f"PHASES {tree} {pair} {launch}: block 0 {total} "
                      f"cycles")
                for line, (cyc, func, note) in sorted(
                        lines.items(), key=lambda kv: -kv[1][0]):
                    ln = int(line) % PHASE_FILE + 1
                    print(f"  {100 * cyc / total:5.1f}% {cyc:12d}  line "
                          f"{ln:4d} {func}: {note[:70]}")
    return 0


# --sweep-cd: the grid of tools/run_sweep_cd.py:25-53 (5 UEA-shaped
# datasets x 4 missing rates x 6 models x seeds), the JAX package's
# SWEEP_CD.json experiment on the port
SWEEP_CD_MODELS = ("neuralsde_2_16", "neuralsde_4_17", "neuralsde_6_17",
                   "neuralcde", "gru", "grud")
SWEEP_CD_RATES = (0.0, 0.3, 0.5, 0.7)


def sweep_cd_datasets():
    """tools/run_sweep_cd.py's make_datasets, on the port's synthetic_uea:
    name -> data_fn(n) of (base seed, noise, length, channels, classes)."""
    from snsde_torch.data import synthetic_uea

    def variant(base_seed, noise, length, channels, classes):
        def fn(n=320, **kw):
            X, y, t = synthetic_uea(n=n, length=length, channels=channels,
                                    num_classes=classes, seed=base_seed)
            rng = np.random.default_rng(base_seed + 1)
            X = X + noise * rng.normal(size=X.shape).astype(np.float32)
            return X, y, t
        return fn

    return {"uea_a_clean": variant(10, 0.0, 40, 3, 4),
            "uea_a_noisy": variant(20, 0.5, 40, 3, 4),
            "uea_a_hard": variant(30, 1.0, 40, 3, 4),
            "uea_b_clean": variant(40, 0.2, 60, 5, 2),
            "uea_b_noisy": variant(50, 0.8, 60, 5, 2)}


def sweep_cd(out: str, epochs: int = 30, seeds: int = 3,
             pack: int = 1) -> int:
    """The port's counterpart of tools/run_sweep_cd.py:25-134 on the card:
    every dataset x rate x model x seed through run_robustness_sweep
    (hidden 16, batch 64, patience 10; with `pack`, the tool's default, a
    cell's seeds of the SDE names and `neuralcde` as one seed ensemble,
    pack_seeds; else one model a run), records beside `out` in
    <out>_runs/, then the score table (mean test accuracy over seeds per
    (dataset, rate) problem) through snsde_torch.analysis.cd_analysis,
    written to `out` with the keys of SWEEP_CD.json and the card's name
    and power limit:

        python3 chip_smoke.py --sweep-cd OUT [EPOCHS [SEEDS [PACK]]]"""
    import os

    from snsde_torch.analysis import cd_analysis
    from snsde_torch.harness.robustness import (SweepConfig,
                                                run_robustness_sweep)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    t0 = time.perf_counter()
    records = []
    for name, data_fn in sweep_cd_datasets().items():
        cfg = SweepConfig(models=SWEEP_CD_MODELS,
                          missing_rates=SWEEP_CD_RATES,
                          seeds=tuple(range(seeds)), hidden_dim=16,
                          batch_size=64, max_epochs=epochs, patience=10,
                          out_dir=os.path.splitext(out)[0] + "_runs")
        print(f"##### dataset {name} #####", flush=True)
        records += run_robustness_sweep(cfg, n=320, data_fn=data_fn,
                                        dataset_name=name, verbose=True,
                                        pack_seeds=bool(pack), device=DEV)
    ok = [r for r in records if "accuracy" in r]
    problems = sorted({(r["dataset"], r["missing_rate"]) for r in ok})
    models = list(SWEEP_CD_MODELS)
    acc = np.full((len(problems), len(models)), np.nan)
    f1 = np.full_like(acc, np.nan)
    for i, (ds, rate) in enumerate(problems):
        for j, m in enumerate(models):
            cell = [r for r in ok if (r["dataset"], r["missing_rate"],
                                      r["model"]) == (ds, rate, m)]
            if cell:
                acc[i, j] = float(np.mean([r["accuracy"] for r in cell]))
                f1[i, j] = float(np.mean([r["f1_weighted"] for r in cell]))
    keep = ~np.isnan(acc).any(axis=1)
    res = cd_analysis(acc[keep], models)
    payload = {
        "problems": [f"{d}@{r}" for (d, r), k in zip(problems, keep) if k],
        "models": models, "accuracy": acc[keep].tolist(),
        "f1_weighted": f1[keep].tolist(),
        "avg_ranks": res.avg_ranks.tolist(),
        "friedman_stat": res.friedman_stat, "friedman_p": res.friedman_p,
        "pairwise": res.pairwise, "cliques": res.cliques,
        "n_runs": len(ok), "n_errors": len(records) - len(ok),
        "epochs": epochs, "seeds": seeds, "packed": bool(pack), "card": smi,
        "seconds": time.perf_counter() - t0}
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps({"avg_ranks": dict(zip(models, res.avg_ranks.tolist())),
                      "friedman_p": res.friedman_p, "cliques": res.cliques,
                      "n_runs": len(ok), "n_errors": payload["n_errors"]}))
    print(f"wrote {out} ({len(ok)} runs, {payload['seconds']:.0f} s) "
          f"[{smi}]")
    return 0 if ok and not payload["n_errors"] else 1


# ---------------------------------------------------------------------------
# The member axis (seed ensembles): K members in one launch of a pair
# ---------------------------------------------------------------------------

# (pair, model, B, L, C, H, hidden layers, K): the EM pair at the sepsis
# shape with five members, the SRK pair at the sweep's shape with three,
# each member on its own weights and control streams (as the ensembles
# give them: kernels/multi.py); each pair with a noise net's
# configuration too
MEMBER_CASES = (
    ("em", MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"],
     MAIN["layers"], 5),
    ("em", "naivesde", MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"],
     MAIN["layers"], 5),
    ("srk", "neuralsde_4_17", SWEEP["B"], SWEEP["L"], SWEEP["D"] + 1,
     SWEEP["H"], 1, 3),
    ("srk", "neuralsde_1_18", SWEEP["B"], SWEEP["L"], SWEEP["D"] + 1,
     SWEEP["H"], 1, 3))
# forced plans (CTAs a cluster, rows a cluster) of the bitwise checks
MEMBER_PLANS = ((1, 8), (2, 4))
N_SEPSIS_R5, SEPSIS_R5_EPOCHS, REPEATS = 4096, 40, 5


def member_inputs(key, model_name, B, L, C, H, layers, K):
    """K members' kernel inputs (member k's field, path and noise from seed
    k), stacked on a leading axis but dts. (stacked forward inputs, flags,
    stacked gys, [(member's forward inputs, its gys)])."""
    members = []
    for k in range(K):
        inp, gys = kernel_inputs(model_name, B, L, C, H, layers, seed=k,
                                 srk=key == "srk")
        members.append((inp, gys))
    mod = _kernel_modules()[key]
    stacked = []
    for name in mod._ARG_ORDER:
        first = members[0][0][name]
        if first is None or name == "dts":
            stacked.append(first)
        else:
            stacked.append(torch.stack([m[0][name] for m in members]))
    flags = {k: members[0][0][k] for k in mod._MODE_KEYS}
    gys = torch.stack([g for _, g in members])
    return (stacked, flags, gys,
            [([m[0][n] for n in mod._ARG_ORDER], m[1]) for m in members])


def _run(key, fwd, flags, gys):
    """(ys, ns, cotangents) of one launch pair."""
    fwd_k, _, bwd_k, _ = kernel_fns(key)
    ys, ns = fwd_k(*fwd, **flags)
    g = bwd_k(fwd[0], ys, gys, *fwd[1:], **flags, ns=ns)
    torch.cuda.synchronize()
    return ys, ns, g


def _member_of(t, k, key):
    """Member k of a packed launch's output (its noise streams along the
    SRK's second axis)."""
    if t is None:
        return None
    if isinstance(t, tuple):
        axis = 1 if key == "srk" else 0
        return type(t)(*(None if v is None else v.select(axis, k)
                         for v in t))
    return t[k]


def _same_as_solo(label, key, packed, solo):
    """Raise unless every member of a packed launch's outputs is bit for
    bit its solo launch's."""
    ys, ns, g = packed
    for k, (ys_k, ns_k, g_k) in enumerate(solo):
        if not torch.equal(ys[k], ys_k):
            raise AssertionError(f"{label}: member {k} ys is not the solo "
                                 f"launch's")
        if ns is not None:
            for name, a, b in zip(ns._fields, _member_of(ns, k, key), ns_k):
                if b is not None and not torch.equal(a, b):
                    raise AssertionError(f"{label}: member {k} {name}")
        for name, a, b in zip(g._fields, g, g_k):
            if b is not None and not torch.equal(a[k], b):
                raise AssertionError(f"{label}: member {k} {name} is not "
                                     f"the solo launch's")


def compare_members(key, model_name, B, L, C, H, layers, K):
    """One member-axis case: (1) under each forced plan of MEMBER_PLANS,
    member k of the packed launch is bit for bit the launch of member k
    alone (the trajectory, the nets' streams, every cotangent); (2) a
    packed launch of one member is bit for bit the solo launch under the
    plan's own choice; (3) under the plan's own choice (waves over K x
    clusters) each member against the plain versions on its inputs
    (check_pair; the float64 rule in the modes that amplify float32 rounding). Returns the largest
    forward and backward errors of (3)."""
    from snsde_torch.kernels._solver import sde_mode, stack_members

    mod = _kernel_modules()[key]
    fwd, flags, gys, members = member_inputs(key, model_name, B, L, C, H,
                                             layers, K)
    label = f"{key.upper()} {model_name} B={B} L={L} H={H} K={K}"
    net = flags["noise"] in ("net1", "net2")
    for cs, rows in MEMBER_PLANS:
        if net and cs > 1:
            continue        # the nets' instances run one-CTA clusters
        mod._LIB.force_placement(0)
        getattr(mod, f"force_{key}_plan")(cs, rows)
        try:
            packed = _run(key, fwd, flags, gys)
            solo = [_run(key, f, flags, g) for f, g in members]
        finally:
            getattr(mod, f"force_{key}_plan")(0, 0)
        _same_as_solo(f"{label} plan ({cs}, {rows})", key, packed, solo)
    one = [t if t is None or name == "dts" else t[:1]
           for name, t in zip(mod._ARG_ORDER, fwd)]
    packed1 = _run(key, one, flags, gys[:1])
    _same_as_solo(f"{label} K=1", key, packed1,
                  [_run(key, members[0][0], flags, members[0][1])])
    shape = (B, H, H, layers - 1, *sde_mode(**flags).codes)
    for b in (False, True):
        p = getattr(mod, f"fused_{key}_plan")(*shape[:4], b, flags["drift"],
                                              flags["noise"], members=K)
        print(f"  {label} plan {'backward' if b else 'forward'}: {p}")
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(key)
    ys_k, ns_k = fwd_k(*fwd, **flags)
    # the backward on the plain forwards' trajectories, as check_pair
    # runs a solo kernel's
    plain = [fwd_p(*f, **flags) for f, _ in members]
    ns_p = stack_members([p[1] for p in plain],
                         {f: 1 for f in ("nst", "nb", "nh")}
                         if key == "srk" else None)
    g = bwd_k(fwd[0], torch.stack([p[0] for p in plain]), gys, *fwd[1:],
              **flags, ns=ns_p)
    amp = flags["noise"] != "precomp"
    err_f = err_b = 0.0
    for k, (f, gk) in enumerate(members):
        fns = (lambda *a, k=k, **kw: (ys_k[k], _member_of(ns_k, k, key)),
               fwd_p,
               lambda *a, k=k, **kw: type(g)(*(None if t is None else t[k]
                                               for t in g)), bwd_p)
        e = check_pair(f"{label} member {k}", fns, f, flags, gk,
                       ys_f64_factor=YS_F64_FACTOR if amp else 0.0,
                       grad_f64_factor=YS_F64_FACTOR if amp else 0.0)
        err_f, err_b = max(err_f, e[0]), max(err_b, e[1])
    print(f"  {label}: every member bit for bit its solo launch under plans "
          f"{[p for p in MEMBER_PLANS if not net or p[0] == 1]} and K=1; "
          f"largest error from the plain versions {err_f:.3e} / {err_b:.3e}",
          flush=True)
    return err_f, err_b


def packed_kernel_times(reps=10):
    """The packed launches against K solo launches: the EM pair with K=5
    at the sepsis shape, the SRK pair with K=3 at the sweep's shape, each
    member on its own weights and streams; each forward and backward (the
    wrapper: recurrence, weight gradient, sums) packed, as K solo launches
    in a row and as the plain versions member by member; the bounds from
    the packed launch's inputs (every input read once, every output
    written once; K x a solo launch's MLP products, 3x in the backward).
    ({key: {name: ms}}, {key: {part: bound}})."""
    ms, bounds = {}, {}
    for key, model, B, L, C, H, layers, K in (MEMBER_CASES[0],
                                              MEMBER_CASES[2]):
        fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(key)
        fwd, flags, gys, members = member_inputs(key, model, B, L, C, H,
                                                 layers, K)
        ys, ns = fwd_k(*fwd, **flags)
        args = [fwd[0], ys, gys] + fwd[1:]
        solo = [(f, fwd_k(*f, **flags)[0], g) for f, g in members]

        def solo_fwd():
            for f, _, _ in solo:
                fwd_k(*f, **flags)

        def solo_bwd():
            for f, y, g in solo:
                bwd_k(f[0], y, g, *f[1:], **flags)

        def plain_fwd():
            for f, _, _ in solo:
                fwd_p(*f, **flags)

        def plain_bwd():
            for f, y, g in solo:
                bwd_p(f[0], y, g, *f[1:], **flags)

        ms[key] = {"fwd": timed(lambda: fwd_k(*fwd, **flags), reps=reps),
                   "bwd": timed(lambda: bwd_k(*args, **flags), reps=reps),
                   "fwd_solo_k": timed(solo_fwd, reps=reps),
                   "bwd_solo_k": timed(solo_bwd, reps=reps),
                   "fwd_plain": timed(plain_fwd, reps=2, warmup=1),
                   "bwd_plain": timed(plain_bwd, reps=2, warmup=1)}
        M = ys.shape[1]
        HH = fwd[mod_index(key, "w_inner")].shape[-1]
        NI = fwd[mod_index(key, "w_inner")].shape[1]
        products = K * sde_products(key, flags, M, B, H, HH, NI)
        nbytes_in = 4 * sum(t.numel() for t in fwd if t is not None)
        grads = bwd_k(*args, **flags)
        bounds[key] = {
            "fwd": bound(nbytes_in + 4 * ys.numel(), products),
            "bwd": bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                          + sum(g.numel() for g in grads
                                                if g is not None)),
                         3 * products)}
        for part in ("fwd", "bwd"):
            print(f"time packed {key} K={K} {part}: {ms[key][part]:.4f} ms "
                  f"against {K} solo launches {ms[key][part + '_solo_k']:.4f}"
                  f" ms (plain, member by member, "
                  f"{ms[key][part + '_plain']:.2f} ms; bound "
                  f"{bounds[key][part][0]:.5f} ms by "
                  f"{bounds[key][part][1]})", flush=True)
    return ms, bounds


def mod_index(key, name):
    return _kernel_modules()[key]._ARG_ORDER.index(name)


def sepsis_ensemble_path():
    """The sepsis flagship's REPEATS repeats as one seed ensemble
    (run_sepsis_ensemble) for 2 epochs; every loss finite, the packed EM
    kernels launched, one result a member with the members' weights
    different. Returns the launch counts of its run."""
    from snsde_torch.harness.classification import run_sepsis_ensemble

    zero_counts()
    t0 = time.perf_counter()
    res = run_sepsis_ensemble(main_config(), repeats=REPEATS, n=N_SEPSIS,
                              max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    losses = [v for r in res for v in
              [h[s]["loss"] for h in r.history for s in ("train", "val")]
              + [r.train_metrics.loss, r.val_metrics.loss,
                 r.test_metrics.loss]]
    print(f"main path 4: run_sepsis_ensemble ({REPEATS} repeats) 2 epochs in "
          f"{wall:.1f} s, test AUROC "
          f"{[round(r.test_metrics.auroc, 4) for r in res]}, launches "
          f"{launches}", flush=True)
    if len(res) != REPEATS or not all(np.isfinite(losses)):
        raise AssertionError("the sepsis ensemble gave a non-finite loss")
    if min(launches[f"em_packed_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"the sepsis ensemble did not run the packed "
                             f"EM kernels: {launches}")
    if launches["em_fwd"] or launches["em_bwd"]:
        raise AssertionError(f"the sepsis ensemble ran solo EM launches: "
                             f"{launches}")
    m = res[0].model.members
    if torch.equal(m[0].field.linear_out.weight, m[1].field.linear_out.weight):
        raise AssertionError("the ensemble's members have one weight")
    return launches


# the solo launch counters a seed-packed CDE cell must leave at 0: each of
# its forwards and backwards is one launch for every seed
CDE_SOLO = ("cde_fwd", "cde_bwd", "cde_gru_fwd", "cde_gru_bwd")


def packed_sweep_path(out_dir, names=("neuralsde_4_17", "neuralcde",
                                       "gru-ode")):
    """The sweep cell with pack_seeds: `neuralsde_4_17` (its three seeds'
    solve one packed SRK launch), and `neuralcde` and `gru-ode` (their
    three seeds' solve one packed CDE launch: the packed counters move and
    no solo CDE launch is made), one model a run with every count set to 0
    before it; each writes a record a seed with `packed` and no error.
    Returns the launch counts of each run."""
    from snsde_torch.harness.robustness import (SweepConfig,
                                                run_robustness_sweep)

    out = {}
    cde = ("cde_packed_fwd", "cde_packed_bwd")
    need_of = {"neuralsde_4_17": ("srk_packed_fwd", "srk_packed_bwd",
                                  "srk_packed_wgrad"),
               "neuralcde": cde, "gru-ode": cde}
    for name in names:
        need = need_of[name]
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,),
                          seeds=(0, 1, 2), hidden_dim=SWEEP["H"],
                          batch_size=SWEEP["B"], max_epochs=2,
                          out_dir=out_dir)
        zero_counts()
        t0 = time.perf_counter()
        recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                    dataset_name="uea_b_noisy_packed",
                                    verbose=False, pack_seeds=True,
                                    device=DEV)
        torch.cuda.synchronize()
        launches = out[name] = read_counts()
        print(f"main path 5: the packed sweep cell with {name} (3 seeds) 2 "
              f"epochs in {time.perf_counter() - t0:.1f} s, records {recs}, "
              f"launches {launches}", flush=True)
        if (len(recs) != 3 or any("error" in r or r.get("packed") != 3
                                  or not np.isfinite(r["accuracy"])
                                  for r in recs)):
            raise AssertionError(f"the packed sweep cell failed: {recs}")
        if min(launches[k] for k in need) <= 0:
            raise AssertionError(f"the packed {name} cell did not launch "
                                 f"{need}: {launches}")
        if any(launches[k] for k in CDE_SOLO):
            raise AssertionError(f"the packed {name} cell made solo CDE "
                                 f"launches: {launches}")
    return out


def ensemble_step_fns():
    """One training step of the sepsis ensemble (REPEATS members) on one
    batch of 1024 sepsis-shaped samples: its solve one packed EM launch
    pair; {label: step()}."""
    from snsde_torch.data import preprocess_classification, synthetic_sepsis
    from snsde_torch.harness.classification import build_sepsis_ensemble
    from snsde_torch.train.ensemble_loop import (_per_member_loss,
                                                 ensemble_step,
                                                 member_generators)
    from snsde_torch.train.loop import readout_grad_hook

    cfg = main_config()
    X, static, y, lengths, _ = synthetic_sepsis(n=MAIN["B"],
                                                length=MAIN["L"], seed=0)
    data = preprocess_classification(X, y, lengths, use_intensity=True,
                                     times=np.arange(MAIN["L"],
                                                     dtype=np.float32))
    times, dev = data["times"], torch.device(DEV)
    cat = lambda k: np.concatenate([data[s][k]
                                    for s in ("train", "val", "test")])
    batch = {"coeffs": torch.as_tensor(cat("coeffs"), device=dev),
             "final_index": torch.as_tensor(cat("final_index"), device=dev),
             "y": torch.as_tensor(cat("y"), dtype=torch.float32, device=dev),
             "static": torch.as_tensor(static, device=dev)}
    model = build_sepsis_ensemble(cfg, data["input_channels"],
                                  static.shape[-1], REPEATS, dev)
    params = [list(model.member(k).parameters()) for k in range(REPEATS)]
    opts = [torch.optim.Adam(ps, lr=1e-3, weight_decay=1e-5)
            for ps in params]
    for k in range(REPEATS):
        readout_grad_hook("readout.linear2")(model.member(k))
    gens = member_generators(0, REPEATS, dev)
    active = np.ones(REPEATS, bool)

    def loss_fn(b):
        logits = model(times, b["coeffs"], b["static"], b["final_index"],
                       generators=gens)[..., 0]
        return _per_member_loss(logits, b["y"], torch.ones_like(b["y"]), 2,
                                10.0), logits

    return {"train_step": lambda: ensemble_step(model, opts, params, loss_fn,
                                                batch, active)}


def ensemble_step_times():
    """The sepsis ensemble's step (REPEATS members) against REPEATS x the
    solo step, timed in this process: wall (CUDA events, median) and the
    profiler's device time of each."""
    ens = ensemble_step_fns()["train_step"]
    solo = sepsis_step_fns()["train_step"]
    ms = {"ensemble_step": timed(ens), "solo_step": timed(solo)}
    ms["ensemble_wall"], ms["ensemble_device"] = profile_step(
        f"sepsis ensemble ({REPEATS} members)", ens)
    ms["solo_wall"], ms["solo_device"] = profile_step("sepsis solo", solo)
    print(f"time sepsis ensemble step ({REPEATS} members): "
          f"{ms['ensemble_step']:.3f} ms against {REPEATS} x the solo step "
          f"{REPEATS * ms['solo_step']:.3f} ms; device "
          f"{ms['ensemble_device']:.3f} ms against {REPEATS} x "
          f"{ms['solo_device']:.3f} ms", flush=True)
    return ms


def whole_model_check():
    """The whole sepsis model (C=69, H=49, two hidden layers, LNSDE (4,17))
    through the EM kernels against the JAX package's loss and every
    gradient, tests/goldens/sepsis_whole_model.npz (the check of
    tests/sepsis_whole_model.py: loss 1e-5 relative, gradients 1e-4 of
    their largest entry). Raises on a miss."""
    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "sepsis_whole_model", os.path.join(here, "tests",
                                           "sepsis_whole_model.py"))
    wm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wm)
    from snsde_torch.kernels import fused_em as fe

    d = wm.data()
    dW = torch.as_tensor(d["dW"], device=DEV)
    real, fe.brownian_increments = fe.brownian_increments, (
        lambda *a, **k: dW)
    try:
        n0 = fe.FWD_LAUNCHES + fe.BWD_LAUNCHES + fe.WGRAD_LAUNCHES
        model = wm.port_model(DEV)
        loss, grads = wm.port_loss_and_grads(
            model, d, torch.Generator(device=DEV))
        n = fe.FWD_LAUNCHES + fe.BWD_LAUNCHES + fe.WGRAD_LAUNCHES - n0
    finally:
        fe.brownian_increments = real
    if n != 3:
        raise AssertionError(f"the whole-model check launched {n} EM "
                             f"kernels, not 3")
    errs = wm.check(loss, grads, np.load(wm.GOLDEN))
    worst = max(errs, key=errs.get)
    print(f"whole sepsis model through the EM kernels against JAX: loss "
          f"{loss:.7f} (golden {float(np.load(wm.GOLDEN)['loss']):.7f}), "
          f"largest gradient error {errs[worst]:.2e} of its scale "
          f"({worst})", flush=True)


def sepsis_r5(out: str = "RESULTS_torch_sepsis_r5.json") -> int:
    """The flagship's five repeats for 40 epochs as one seed ensemble
    (n=4096 synthetic sepsis, H=49, two hidden layers, batch 1024, seed 0;
    the JAX package's tools/run_flagship_ensembles.py), per-repeat test
    AUROC and accuracy with the quality pins' verdicts, written to `out`
    in the layout of RESULTS_sepsis_r5.json:

        python3 chip_smoke.py --sepsis-r5 [OUT]"""
    from snsde_torch.harness.classification import run_sepsis_ensemble
    from snsde_torch.train.pins import FLAGSHIP_PINS, check_history

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    cfg = main_config()
    cfg.seed, cfg.data_seed = 0, 0
    t0 = time.time()
    res = run_sepsis_ensemble(cfg, repeats=REPEATS, n=N_SEPSIS_R5,
                              max_epochs=SEPSIS_R5_EPOCHS, device=DEV)

    def summary(metric):
        vals = [float(getattr(r.test_metrics, metric)) for r in res]
        pins = [check_history(r.history, FLAGSHIP_PINS["sepsis"])
                for r in res]
        return {"per_repeat": [round(v, 4) for v in vals],
                "mean": round(float(np.mean(vals)), 4),
                "std": round(float(np.std(vals)), 4),
                "pins_ok": [p["ok"] for p in pins],
                "pin_violations": sum((p["violations"] for p in pins), [])}

    rec = {"model": MAIN["model"], "H": MAIN["H"], "layers": MAIN["layers"],
           "batch": MAIN["B"], "n": N_SEPSIS_R5,
           "epochs": SEPSIS_R5_EPOCHS, "repeats": REPEATS, "packed": True,
           "auroc": summary("auroc"), "accuracy": summary("accuracy"),
           "wall_time_min": round((time.time() - t0) / 60.0, 2),
           "card": smi}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Speech Commands and the latent SDE (the EM pair's latent instances)
# ---------------------------------------------------------------------------

# the speech flagship (RESULTS_speech_r5.json): neurallnsde (4,17), H=HH=49,
# two hidden layers, batch 1024, L=161 (160 EM steps at dt=1), C=21 (20
# MFCC coefficients and time), 10 classes
SPEECH = dict(B=1024, L=161, C=21, H=49, layers=2, model="neurallnsde")
N_SPEECH = 2048     # samples of synthetic_speech on the speech path
N_SPEECH_R5, SPEECH_R5_EPOCHS = 8192, 40
# the latent pair at the sweep's shape (latentsde at hidden 16: 15 latent
# lanes and the KL lane, no inner layer) and at H=HH=128 with one inner
# layer, each under every cluster size sde_plan can pick there
LATENT = dict(B=SWEEP["B"], L=SWEEP["L"], C=SWEEP["D"] + 1, H=SWEEP["H"],
              layers=1)
LATENT_WIDE = dict(B=128, L=24, C=SWEEP["D"] + 1, H=128, layers=2)
LATENT_PLANS = (1, 2, 4)
LATENT_MODELS = ("latentsde", "latentsde-kl")


def latent_kernel_inputs(B, L, C, H, layers, seed=0):
    """The latent mode's inputs (detached, on the card) of a random
    LatentSDE (C channels, H = HH, `layers` hidden layers) on a random
    control path over the sweep's times linspace(0, 1, L), increments
    N(0, dt) and a cotangent N(0, 1) / B on every lane and step (the KL
    lane's too) from numpy: (forward inputs in _ARG_ORDER, flags, gys)."""
    from snsde_torch.kernels.fused_em import (_ARG_ORDER, _MODE_KEYS,
                                              latent_inputs)
    from snsde_torch.models.latent_sde import LatentSDE
    from snsde_torch.models.neuralsde import resolve_dt
    from snsde_torch.ops import make_grid

    rng = np.random.default_rng(seed)
    model = LatentSDE(C, H, H, layers, method="euler",
                      generator=torch.Generator().manual_seed(seed)).to(DEV)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    dt = resolve_dt(times)
    grid, _ = make_grid(times, dt)
    M = grid.shape[0] - 1
    dW = rng.normal(size=(M, B, H)) * np.sqrt(np.diff(grid))[:, None, None]
    z0 = rng.normal(size=(B, H - 1))
    aug0 = torch.as_tensor(np.concatenate([z0, np.zeros((B, 1))], -1),
                           dtype=torch.float32, device=DEV)
    with torch.no_grad():
        inp = latent_inputs(model, grid, aug0,
                            torch.as_tensor(dW, dtype=torch.float32))
    inp = {k: (v.detach().contiguous() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    gys = torch.as_tensor(rng.normal(size=(M, B, H)) / B,
                          dtype=torch.float32, device=DEV)
    return ([inp[k] for k in _ARG_ORDER],
            {k: inp[k] for k in _MODE_KEYS + ("latent",)}, gys)


def latent_plans(B, H, n_inner):
    """Print the latent instances' plans at (B, H = HH, n_inner); raise if
    one cannot be scheduled."""
    from snsde_torch.kernels.fused_em import fused_em_plan

    for backward in (False, True):
        p = fused_em_plan(B, H, H, n_inner, backward, "yy", "precomp",
                          latent=True)
        print(f"  EM latent plan B={B} H=HH={H} n_inner={n_inner} "
              f"{'backward' if backward else 'forward'}: level "
              f"{p['level']}, CS={p['cluster']}, {p['rows']} rows a "
              f"cluster, {p['smem_bytes']} shared bytes a CTA, "
              f"cudaOccupancyMaxActiveClusters {p['active_clusters']}")
        if p["active_clusters"] < 1:
            raise AssertionError(f"latent plan at B={B} H={H} cannot be "
                                 f"scheduled: {p}")


def compare_latent(B, L, C, H, layers):
    """The latent pair against its plain versions (check_pair) under each
    forced cluster size of LATENT_PLANS and under the plan's own choice:
    the latent lanes by the main paths' rule (TOL_YS of their largest
    entry), the whole trajectory (the KL lane's sum over a row) and the
    cotangents by the float64 rule (the larger of the main paths' limits
    and YS_F64_FACTOR times the float32 plain version's own error); the
    forward's trajectory must be the same bits under every plan (each
    product one FMA chain in ascending k, the KL rate summed by one thread
    in ascending q). Returns the largest forward and backward errors."""
    from snsde_torch.kernels import fused_em as fe

    fwd, flags, gys = latent_kernel_inputs(B, L, C, H, layers)
    fns = kernel_fns("em")
    label = f"EM latent B={B} L={L} H={H} n_inner={layers - 1}"
    latent_plans(B, H, layers - 1)
    worst, first = (0.0, 0.0), None
    for cs in LATENT_PLANS + (0,):
        fe.force_em_plan(cs, 0)
        try:
            e = check_pair(f"{label} CS={cs or 'plan'}", fns, fwd, flags, gys,
                           ys_f64_factor=YS_F64_FACTOR,
                           grad_f64_factor=YS_F64_FACTOR)
            ys_k = fns[0](*fwd, **flags)[0]
        finally:
            fe.force_em_plan(0, 0)
        ys_p = fns[1](*fwd, **flags)[0]
        lat = ys_p[..., :-1]
        rel = (float((ys_k[..., :-1] - lat).abs().max())
               / max(float(lat.abs().max()), 1e-30))
        print(f"    latent lanes max rel err {rel:.3e} (tol {TOL_YS:g}); "
              f"KL lane at the end {float(ys_k[-1, :, -1].mean()):.4f} "
              f"(mean over rows)")
        if not rel <= TOL_YS:
            raise AssertionError(f"{label} CS={cs}: latent lanes disagree")
        if first is None:
            first = ys_k
        elif not torch.equal(ys_k, first):
            raise AssertionError(f"{label}: the trajectory (KL lane "
                                 f"{torch.equal(ys_k[..., -1], first[..., -1])}"
                                 f") differs between plans CS=1 and CS={cs}")
        worst = tuple(max(a, b) for a, b in zip(worst, e))
    print(f"  {label}: the forward's bits are the same under CS="
          f"{', '.join(map(str, LATENT_PLANS))} and the plan's own choice")
    return worst


def compare_latent_wgrad(B, L, C, H, layers):
    """The weight-gradient kernel alone on the latent recurrence's plain
    streams (compare_sde_wgrad)."""
    from snsde_torch.kernels import fused_em as fe

    fwd, flags, gys = latent_kernel_inputs(B, L, C, H, layers)
    ys, _ = fe.fused_em_forward_reference(*fwd, **flags)
    st = fe.fused_em_backward_recurrence_reference(fwd[0], ys, gys, *fwd[1:],
                                                   **flags)
    return compare_sde_wgrad("em", "latent", B, L, C, H, layers,
                             args=(fwd[0], ys, st, None, flags))


def _losses(results):
    return [v for r in results for v in
            [h[s]["loss"] for h in r.history for s in ("train", "val")]
            + [r.train_metrics.loss, r.val_metrics.loss, r.test_metrics.loss]]


def speech_path():
    """The speech harness run_speech at full width (SPEECH) on
    synthetic_speech(n=N_SPEECH) for 2 epochs: it must launch the three EM
    kernels with finite losses, and the trained field's fused solve must
    match the eager one on the same increments. Returns the launch
    counts."""
    from snsde_torch.harness.classification import run_speech

    zero_counts()
    t0 = time.perf_counter()
    res = run_speech(main_config(), n=N_SPEECH, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = _losses([res])
    print(f"main path 6: run_speech 2 epochs in "
          f"{time.perf_counter() - t0:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, val accuracy "
          f"{res.val_metrics.accuracy:.4f}, test accuracy "
          f"{res.test_metrics.accuracy:.4f}, launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss on the speech path")
    if min(launches[f"em_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"the speech path did not run the EM kernels: "
                             f"{launches}")
    check_trained_solve(res.model.func, SPEECH)
    return launches


def speech_ensemble_path():
    """run_speech_ensemble with REPEATS repeats at full width for one
    epoch: the packed EM kernels and no solo launch, finite losses, the
    members' weights different. Returns the launch counts."""
    from snsde_torch.harness.classification import run_speech_ensemble

    zero_counts()
    t0 = time.perf_counter()
    res = run_speech_ensemble(main_config(), repeats=REPEATS, n=N_SPEECH,
                              max_epochs=1, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"main path 7: run_speech_ensemble ({REPEATS} repeats) 1 epoch in "
          f"{time.perf_counter() - t0:.1f} s, test accuracy "
          f"{[round(r.test_metrics.accuracy, 4) for r in res]}, launches "
          f"{launches}", flush=True)
    if len(res) != REPEATS or not all(np.isfinite(_losses(res))):
        raise AssertionError("the speech ensemble gave a non-finite loss")
    if min(launches[f"em_packed_{k}"] for k in ("fwd", "bwd", "wgrad")) <= 0:
        raise AssertionError(f"the speech ensemble did not run the packed "
                             f"EM kernels: {launches}")
    if launches["em_fwd"] or launches["em_bwd"] or launches["em_wgrad"]:
        raise AssertionError(f"the speech ensemble ran solo EM launches: "
                             f"{launches}")
    f = res[0].model.fields
    if torch.equal(f[0].linear_out.weight, f[1].linear_out.weight):
        raise AssertionError("the speech ensemble's members have one weight")
    return launches


def latent_sweep_path(out_dir):
    """The sweep cell (uea_b_noisy, hidden 16, batch 64, missing rate 0.3,
    seed 0) with LATENT_MODELS, one model a run with every count set to 0
    before it: each must launch the latent instances (and the weight
    gradient), write a record with an accuracy and no error, give a finite
    loss and KL term on the validation rows, and its trained model's fused
    latent solve must match the eager sdeint(f_aug, g_aug) on the same
    increments, the KL lane included. Returns the launch counts summed
    over the runs."""
    from snsde_torch.harness.robustness import (SweepConfig, ists_loss,
                                                preprocess_ists,
                                                run_robustness_sweep)

    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:64], missing_rate=0.3, seed=0,
                           interpolation="hermite")
    batch = {"seq": torch.as_tensor(data["seq"], device=DEV),
             "coeffs": torch.as_tensor(data["coeffs"], device=DEV),
             "y": torch.as_tensor(y[:64], device=DEV).long()}
    total = {}
    for name in LATENT_MODELS:
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=2, out_dir=out_dir)
        trained = {}
        zero_counts()
        t0 = time.perf_counter()
        recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                    dataset_name="uea_b_noisy",
                                    verbose=False, device=DEV,
                                    models=trained)
        torch.cuda.synchronize()
        launches = read_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        model = trained.get((0.3, name, 0))
        loss = kl = float("nan")
        if model is not None:
            model.eval()
            with torch.no_grad():
                gen = torch.Generator(DEV).manual_seed(0)
                loss = float(ists_loss(model, batch, gen,
                                       kl_weight=cfg.kl_weight)[0])
                kl = float(model(batch["seq"], batch["coeffs"],
                                 generator=gen, with_aux=True)[1])
        print(f"main path 8 with {name}: run_robustness_sweep (euler, the "
              f"latent kernels) 2 epochs in {time.perf_counter() - t0:.1f} "
              f"s, records {recs}, validation-rows loss {loss:.4f}, KL term "
              f"{kl:.4f}, launches {launches}", flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           for r in recs):
            raise AssertionError(f"the sweep wrote a failed record: {recs}")
        if not (all(np.isfinite(r["accuracy"]) for r in recs)
                and np.isfinite(loss) and np.isfinite(kl)):
            raise AssertionError(f"non-finite accuracy, loss or KL with "
                                 f"{name}")
        if min(launches[k] for k in ("em_latent_fwd", "em_latent_bwd",
                                     "em_wgrad")) <= 0:
            raise AssertionError(f"{name} did not run the latent kernels: "
                                 f"{launches}")
        check_trained_latent_solve(model.layer.inner)
    return total


def check_trained_latent_solve(model, B=64):
    """A trained LatentSDE's fused latent solve vs the eager
    sdeint(f_aug, g_aug) on the same increments over the sweep's times, the
    KL lane included: within the larger of TOL_YS and YS_F64_FACTOR times
    the float32 eager solve's own largest error from a float64 run of it,
    over max|ys| (the float64 rule)."""
    import copy

    from snsde_torch.kernels.fused_em import fused_latent_em_solve
    from snsde_torch.models.neuralsde import resolve_dt
    from snsde_torch.ops import BrownianGrid, make_grid, sdeint

    rng = np.random.default_rng(2)
    H = model.embedding.out_features
    times = np.linspace(0.0, 1.0, SWEEP["L"]).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dW = torch.as_tensor(rng.normal(size=(len(grid) - 1, B, H))
                         * np.sqrt(np.diff(grid))[:, None, None],
                         dtype=torch.float64, device=DEV)
    aug0 = torch.as_tensor(np.concatenate(
        [rng.normal(size=(B, H - 1)), np.zeros((B, 1))], -1),
        dtype=torch.float64, device=DEV)
    m64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ys_f = fused_latent_em_solve(model, times, aug0.float(),
                                     dW=dW.float())
        ys_e = sdeint(model.f_aug, model.g_aug, aug0.float(), times,
                      bm=BrownianGrid(grid, dW.float()))
        ys_64 = sdeint(m64.f_aug, m64.g_aug, aug0, times,
                       bm=BrownianGrid(grid, dW))
    scale = float(ys_64.abs().max())
    e32 = float((ys_e.double() - ys_64).abs().max()) / scale
    rel = float((ys_f - ys_e).abs().max()) / max(float(ys_e.abs().max()),
                                                 1e-30)
    kl = (float((ys_f[..., -1] - ys_e[..., -1]).abs().max())
          / max(float(ys_e[..., -1].abs().max()), 1e-30))
    tol = max(TOL_YS, YS_F64_FACTOR * e32)
    print(f"trained latent model: fused vs eager euler solve, B={B}: shape "
          f"{tuple(ys_f.shape)}, max rel err {rel:.3e} (KL lane {kl:.3e}; "
          f"tol {tol:.3e}; the float32 eager solve from float64 {e32:.3e})")
    if not (torch.isfinite(ys_f).all() and rel <= tol and kl <= tol):
        raise AssertionError("trained latent model's fused solve disagrees")


def latent_kernel_times():
    """The latent pair at the sweep's shape (LATENT): forward and backward
    (the wrapper), their plain versions, the recurrence and the weight
    gradient apart (sde_backward_times), and the bounds from its inputs:
    the bytes of every input and output once, the drift MLP's products
    (sde_products; the KL sum adds 2 B H a step) and 3x those for the
    backward."""
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns("em")
    sh = LATENT
    fwd, flags, gys = latent_kernel_inputs(sh["B"], sh["L"], sh["C"],
                                           sh["H"], sh["layers"])
    ys, _ = fwd_k(*fwd, **flags)
    args = [fwd[0], ys, gys] + fwd[1:]
    ms = {"fwd": timed(lambda: fwd_k(*fwd, **flags)),
          "fwd_plain": timed(lambda: fwd_p(*fwd, **flags), reps=5, warmup=1),
          "bwd_call": timed(lambda: bwd_k(*args, **flags)),
          "bwd_plain": timed(lambda: bwd_p(*args, **flags), reps=5,
                             warmup=1)}
    M, B, H = ys.shape
    flops = (sde_products("em", flags, M, B, H, H, sh["layers"] - 1)
             + 2 * M * B * H)
    n_in = sum(t.numel() for t in fwd if t is not None)
    n_g = sum(g.numel() for g in bwd_k(*args, **flags) if g is not None)
    bounds = {"fwd": bound(4 * (n_in + ys.numel()), flops),
              "bwd": bound(4 * (n_in + 2 * ys.numel() + n_g), 3 * flops)}
    ms_w, bounds["wgrad"] = sde_backward_times("em", fwd, ys, gys, flags)
    ms.update(ms_w)
    print(f"latent pair at the sweep's shape (B={B}, M={M}, H={H}): fwd "
          f"{ms['fwd']:.4f} ms, bwd {ms['bwd']:.4f} ms (recurrence "
          f"{ms['bwd_recurrence']:.4f} + weight gradient "
          f"{ms['bwd_wgrad']:.4f}); plain {ms['fwd_plain']:.2f} / "
          f"{ms['bwd_plain']:.2f} ms; bounds {bounds}", flush=True)
    return ms, bounds


def speech_step_fns():
    """One training step of the speech model (ten-class cross-entropy +
    0.01 L2, the 100x readout hook, coupled-L2 Adam) on one batch of 1024
    speech-shaped samples: {label: step()} through the kernels and through
    the eager solver."""
    from snsde_torch.data import preprocess_classification, synthetic_speech
    from snsde_torch.harness.classification import build_speech_model
    from snsde_torch.train.loop import (TrainConfig, make_loss_fn,
                                        make_optimizer, readout_grad_hook,
                                        train_step)

    X, y, lengths, _ = synthetic_speech(n=SPEECH["B"], seed=0)
    data = preprocess_classification(X, y, lengths, use_intensity=False,
                                     times=np.arange(SPEECH["L"],
                                                     dtype=np.float32))
    times, dev = data["times"], torch.device(DEV)
    cat = lambda k: np.concatenate([data[s][k]
                                    for s in ("train", "val", "test")])
    batch = {"coeffs": torch.as_tensor(cat("coeffs"), device=dev),
             "final_index": torch.as_tensor(cat("final_index"), device=dev),
             "y": torch.as_tensor(cat("y"), device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model, reg_fn = build_speech_model(main_config(),
                                           data["input_channels"], dev)
        tc = TrainConfig(num_classes=10, step_mode="valaccuracy")
        readout_grad_hook("readout.linear2")(model)

        def apply_fn(m, b, g, fused=fused):
            return m(times, b["coeffs"], b["final_index"], generator=g,
                     use_fused=fused)

        loss_fn = make_loss_fn(apply_fn, reg_fn, tc)
        opt = make_optimizer(model, tc)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[label] = (lambda model=model, opt=opt, loss_fn=loss_fn, gen=gen:
                      train_step(model, opt, loss_fn, batch, gen))
    return out


def speech_r5(out: str = "RESULTS_torch_speech_r5.json") -> int:
    """The speech flagship's five repeats for 40 epochs as one seed
    ensemble (n=8192 synthetic speech, H=49, two hidden layers, batch 1024,
    seed 0; the JAX package's tools/run_flagship_ensembles.py), per-repeat
    test accuracy and weighted F1 with the quality pins' verdicts, written
    to `out` in the layout of RESULTS_speech_r5.json:

        python3 chip_smoke.py --speech-r5 [OUT]"""
    from snsde_torch.harness.classification import run_speech_ensemble
    from snsde_torch.train.pins import FLAGSHIP_PINS, check_history

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    cfg = main_config()
    cfg.seed, cfg.data_seed = 0, 0
    t0 = time.time()
    res = run_speech_ensemble(cfg, repeats=REPEATS, n=N_SPEECH_R5,
                              max_epochs=SPEECH_R5_EPOCHS, device=DEV)

    def summary(metric):
        vals = [float(getattr(r.test_metrics, metric)) for r in res]
        pins = [check_history(r.history, FLAGSHIP_PINS["speech"])
                for r in res]
        return {"per_repeat": [round(v, 4) for v in vals],
                "mean": round(float(np.mean(vals)), 4),
                "std": round(float(np.std(vals)), 4),
                "pins_ok": [p["ok"] for p in pins],
                "pin_violations": sum((p["violations"] for p in pins), [])}

    rec = {"model": SPEECH["model"], "H": SPEECH["H"],
           "layers": SPEECH["layers"], "batch": SPEECH["B"],
           "n": N_SPEECH_R5, "epochs": SPEECH_R5_EPOCHS, "repeats": REPEATS,
           "packed": True, "accuracy": summary("accuracy"),
           "f1_weighted": summary("f1_weighted"),
           "wall_time_min": round((time.time() - t0) / 60.0, 2),
           "card": smi}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 10: the GRU-ODE field on the CDE kernels, the CDE pair's member
# axis and the packed latent solve
# ---------------------------------------------------------------------------

# the GRU-ODE field's shapes: the sweep cell's (106 rk4 steps) and the JAX
# package's gruode_rk4 bench shape (tools/bench_cde.py:153: B=1024, L=72,
# 136 rk4 steps, C=6, H=32)
GRU_SHAPES = {"sweep": dict(B=SWEEP["B"], L=SWEEP["L"], C=SWEEP["D"] + 1,
                            H=SWEEP["H"], n_inner=0),
              "gruode_rk4": dict(B=1024, L=72, C=6, H=32, n_inner=0)}
# the shape at which each plan level is forced once, and the plan's levels
# (csrc/fused_cde.cu: LEVELS)
GRU_LEVELS = dict(B=128, L=24, C=6, H=32, n_inner=0)
CDE_LEVELS = 7
# members of the packed CDE cells and launches: the sweep's three seeds
CDE_K = 3


def compare_gruode():
    """The GRU-ODE instances against their plain versions (compare_cde:
    the trajectory and every cotangent by the float64 rule) at both
    GRU_SHAPES, on euler, midpoint and heun (B=128 at the bench length), at
    H=128 and 256 (B=128, L=24: the gates past a CTA's shared memory), with
    every plan level forced once (GRU_LEVELS) and on a ragged B=100; each
    plan printed. Returns the largest forward and backward errors."""
    from snsde_torch.kernels import fused_cde as fc

    errs = [compare_cde(**sh, field="gruode") for sh in GRU_SHAPES.values()]
    sh = GRU_SHAPES["gruode_rk4"]
    for method in ("euler", "midpoint", "heun"):
        errs.append(compare_cde(128, sh["L"], sh["C"], sh["H"], 0, method,
                                field="gruode"))
    for H in WIDE_H:
        errs.append(compare_cde(WIDE["B"], WIDE["L"], 6, H, 0,
                                field="gruode"))
    for level in range(1, CDE_LEVELS):
        print(f"  the GRU-ODE instances with level {level} forced:")
        fc._LIB.force_placement(level)
        try:
            errs.append(compare_cde(**GRU_LEVELS, field="gruode"))
        finally:
            fc._LIB.force_placement(0)
    errs.append(compare_cde(100, 30, 6, 32, 0, field="gruode"))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def cde_member_inputs(field, K, B, L, C, H, n_inner):
    """K members' CDE inputs (member k's field, control path, z0 and
    cotangent from seed k: a control stream of its own), stacked on a
    leading axis but dts: (stacked forward inputs, flags, stacked gys,
    [(member's forward inputs, its gys)])."""
    from snsde_torch.kernels import fused_cde as fc

    members = [cde_kernel_inputs(B, L, C, H, n_inner, "rk4", field, seed=k)
               for k in range(K)]
    stacked = [t if t is None or name == "dts" else
               torch.stack([m[0][i] for m in members])
               for i, (name, t) in enumerate(zip(fc._ARG_ORDER,
                                                 members[0][0]))]
    return (stacked, members[0][1], torch.stack([m[2] for m in members]),
            [(m[0], m[2]) for m in members])


def compare_cde_members(field, K=CDE_K):
    """The CDE pair's member axis at the sweep cell (K members of `field`,
    each on its own weights, z0 and control stream): (1) under each forced
    plan of MEMBER_PLANS, member k of the packed launch is bit for bit the
    launch of member k alone (the trajectory and every cotangent); (2) a
    packed launch of one member is bit for bit the solo launch under the
    plan's own choice; (3) under the packed launch's own plans (waves over
    K x clusters; printed), the solo launches under the same plans forced
    are its members bit for bit, and each member's largest error from its
    float32 plain version is returned (forward, backward; the solo kernels
    are held to the plain versions at this shape by compare_cde)."""
    from snsde_torch.kernels import fused_cde as fc

    sh = GRU_SHAPES["sweep"]
    fwd, flags, gys, members = cde_member_inputs(field, K, **sh)
    label = (f"CDE {field} member axis B={sh['B']} L={sh['L']} H={sh['H']} "
             f"K={K}")
    for cs, rows in MEMBER_PLANS:
        fc.force_cde_plan(cs, rows)
        try:
            packed = _run("cde", fwd, flags, gys)
            solo = [_run("cde", f, flags, g) for f, g in members]
        finally:
            fc.force_cde_plan(0, 0)
        _same_as_solo(f"{label} plan ({cs}, {rows})", "cde", packed, solo)
    one = [t if t is None or name == "dts" else t[:1]
           for name, t in zip(fc._ARG_ORDER, fwd)]
    _same_as_solo(f"{label} K=1", "cde", _run("cde", one, flags, gys[:1]),
                  [_run("cde", members[0][0], flags, members[0][1])])
    cde_plans([(sh["B"], sh["H"], sh["C"], sh["n_inner"])], "rk4",
              flags["act"], K)
    plan = {b: fc.fused_cde_plan(sh["B"], sh["H"], sh["H"], sh["C"],
                                 sh["n_inner"], "rk4", b, flags["act"], K)
            for b in (False, True)}
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns("cde")
    ys = fwd_k(*fwd, **flags)[0]
    g = bwd_k(fwd[0], ys, gys, *fwd[1:], **flags)
    err_f = err_b = 0.0
    for k, (f, gk) in enumerate(members):
        solo = []
        for b, run in ((False, lambda: fwd_k(*f, **flags)[0]),
                       (True, lambda: bwd_k(f[0], ys[k], gk, *f[1:],
                                            **flags))):
            fc.force_cde_plan(plan[b]["cluster"], plan[b]["rows"])
            try:
                solo.append(run())
            finally:
                fc.force_cde_plan(0, 0)
        ys_s, g_s = solo
        torch.cuda.synchronize()
        _same_as_solo(f"{label} the packed plans", "cde",
                      (ys[k:k + 1], None, type(g)(*(None if t is None
                                                    else t[k:k + 1]
                                                    for t in g))),
                      [(ys_s, None, g_s)])
        ys_p = fwd_p(*f, **flags)[0]
        g_p = bwd_p(f[0], ys[k], gk, *f[1:], **flags)
        err_f = max(err_f, float((ys[k] - ys_p).abs().max()))
        err_b = max([err_b] + [float((a[k] - b).abs().max())
                               for a, b in zip(g, g_p)
                               if b is not None and b.numel()])
    print(f"  {label}: every member bit for bit its solo launch under plans "
          f"{list(MEMBER_PLANS)}, K=1 and the packed launch's own plans "
          f"(forward {plan[False]['cluster']} x {plan[False]['rows']}, "
          f"backward {plan[True]['cluster']} x {plan[True]['rows']}); "
          f"largest error from the float32 plain versions {err_f:.3e} / "
          f"{err_b:.3e}", flush=True)
    return err_f, err_b


def compare_latent_members(K=CDE_K):
    """The packed latent solve at the sweep's shape (LATENT): K LatentSDE
    members (member k's weights, increments, initial state and cotangent
    from seed k) in one launch of the EM kernels' latent instances, member
    k bit for bit its solo latent launch under each forced plan of
    MEMBER_PLANS (the trajectory with its KL lane and every cotangent, the
    weight gradient's included); and through the entry points,
    fused_latent_em_solve_packed on K generators against
    fused_latent_em_solve on each, bit for bit under a forced plan."""
    from snsde_torch.kernels import fused_em as fe
    from snsde_torch.kernels.multi import fused_latent_em_solve_packed
    from snsde_torch.models.latent_sde import LatentSDE
    from snsde_torch.models.neuralsde import resolve_dt

    members = [latent_kernel_inputs(**LATENT, seed=k) for k in range(K)]
    fwd = [t if t is None or name == "dts" else
           torch.stack([m[0][i] for m in members])
           for i, (name, t) in enumerate(zip(fe._ARG_ORDER, members[0][0]))]
    flags, gys = members[0][1], torch.stack([m[2] for m in members])
    label = (f"EM latent member axis B={LATENT['B']} L={LATENT['L']} "
             f"H={LATENT['H']} K={K}")
    for cs, rows in MEMBER_PLANS:
        fe.force_em_plan(cs, rows)
        try:
            packed = _run("em", fwd, flags, gys)
            solo = [_run("em", m[0], flags, m[2]) for m in members]
        finally:
            fe.force_em_plan(0, 0)
        _same_as_solo(f"{label} plan ({cs}, {rows})", "em", packed, solo)
    times = np.linspace(0.0, 1.0, LATENT["L"]).astype(np.float32)
    models = [LatentSDE(LATENT["C"], LATENT["H"], LATENT["H"],
                        LATENT["layers"], method="euler",
                        generator=torch.Generator().manual_seed(k)).to(DEV)
              for k in range(K)]
    aug0 = torch.zeros(K, LATENT["B"], LATENT["H"], device=DEV)
    aug0[..., :-1] = torch.randn(K, LATENT["B"], LATENT["H"] - 1,
                                 device=DEV)
    gen = lambda k: torch.Generator(DEV).manual_seed(100 + k)
    dt = resolve_dt(times)
    fe.force_em_plan(*MEMBER_PLANS[0])
    try:
        with torch.no_grad():
            ys = fused_latent_em_solve_packed(models, times, aug0,
                                              [gen(k) for k in range(K)],
                                              dt=dt)
            for k in range(K):
                solo = fe.fused_latent_em_solve(models[k], times, aug0[k],
                                                generator=gen(k), dt=dt)
                if not torch.equal(ys[k], solo):
                    raise AssertionError(f"{label}: member {k} of "
                                         f"fused_latent_em_solve_packed is "
                                         f"not its solo solve")
    finally:
        fe.force_em_plan(0, 0)
    if not torch.isfinite(ys).all():
        raise AssertionError(f"{label}: non-finite packed latent solve")
    print(f"  {label}: every member bit for bit its solo latent launch "
          f"under plans {list(MEMBER_PLANS)}; fused_latent_em_solve_packed "
          f"on {K} generators bit for bit fused_latent_em_solve on each "
          f"(KL lane at the end {float(ys[:, -1, :, -1].mean()):.4f})",
          flush=True)


def gruode_sweep_path(out_dir):
    """The sweep cell with `gru-ode` (rk4, hidden 16) for 2 epochs, every
    count set to 0 just before it: it must launch the CDE kernels' gruode
    instances (forward and backward), take the eager cdeint nowhere, write
    a record with an accuracy and no error, give a finite loss on the
    validation rows, and its trained field's fused solve must match the
    eager one (check_trained_cde_solve). Returns the launch counts of its
    run."""
    from snsde_torch.harness.robustness import (SweepConfig, preprocess_ists,
                                                run_robustness_sweep)
    from snsde_torch.models import neuralcde
    from snsde_torch.train.loop import softmax_cross_entropy

    cfg = SweepConfig(models=("gru-ode",), missing_rates=(0.3,), seeds=(0,),
                      hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                      max_epochs=2, out_dir=out_dir)
    trained, eager = {}, []
    real = neuralcde.cdeint

    def counted(*a, **k):
        eager.append(1)
        return real(*a, **k)

    neuralcde.cdeint = counted
    zero_counts()
    t0 = time.perf_counter()
    try:
        recs = run_robustness_sweep(cfg, n=SWEEP["n"], data_fn=uea_b_noisy,
                                    dataset_name="uea_b_noisy",
                                    verbose=False, device=DEV,
                                    models=trained)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        neuralcde.cdeint = real
    wall = time.perf_counter() - t0
    model = trained.get((0.3, "gru-ode", 0))
    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:64], missing_rate=0.3, seed=0,
                           interpolation="natural")
    loss = float("nan")
    if model is not None:
        model.eval()
        with torch.no_grad():
            logits = model(torch.as_tensor(data["seq"], device=DEV),
                           torch.as_tensor(data["coeffs"], device=DEV))
            loss = float(softmax_cross_entropy(
                logits, torch.as_tensor(y[:64], device=DEV).long()))
    print(f"main path 10: run_robustness_sweep (gru-ode, rk4) 2 epochs in "
          f"{wall:.1f} s, records {recs}, validation-rows loss {loss:.4f}, "
          f"eager cdeint calls {len(eager)}, launches {launches}",
          flush=True)
    if not recs or any("error" in r or "accuracy" not in r for r in recs):
        raise AssertionError(f"the gru-ode sweep wrote a failed record: "
                             f"{recs}")
    if not (all(np.isfinite(r["accuracy"]) for r in recs)
            and np.isfinite(loss)):
        raise AssertionError("non-finite accuracy or loss with gru-ode")
    if launches["cde_gru_fwd"] <= 0 or launches["cde_gru_bwd"] <= 0:
        raise AssertionError(f"gru-ode did not run the gruode instances: "
                             f"{launches}")
    if eager:
        raise AssertionError(f"gru-ode took the eager cdeint {len(eager)} "
                             f"times")
    check_trained_cde_solve(model, preprocess_ists(
        X[:16], missing_rate=0.3, seed=0, interpolation="natural"))
    return launches


def gruode_kernel_times():
    """The gruode instances' times, plain versions and bounds at both
    GRU_SHAPES (cde_kernel_times; the sweep's keys plain, the bench
    shape's with its name). ({name: ms}, {part: bound})."""
    ms, bounds = {}, {}
    for name, sh in GRU_SHAPES.items():
        m, b = cde_kernel_times(sh, field="gruode")
        sfx = "" if name == "sweep" else f" {name}"
        ms.update({f"{k}{sfx}": v for k, v in m.items()})
        bounds.update({f"{k}{sfx}": v for k, v in b.items()})
    return ms, bounds


def cde_packed_kernel_times(reps=10):
    """The packed CDE launch (CDE_K members at the sweep cell, each on its
    own weights and control stream; FinalTanh and GRU-ODE) against CDE_K
    solo launches in a row and the plain versions member by member, with
    bounds from the packed launch's inputs (every input read once, every
    output written once; CDE_K x a solo launch's operations, 3x in the
    backward). ({field: {name: ms}}, {field: {part: bound}})."""
    from snsde_torch.kernels import fused_cde as fc

    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns("cde")
    ms, bounds = {}, {}
    for field in ("final_tanh", "gruode"):
        fwd, flags, gys, members = cde_member_inputs(field, CDE_K,
                                                     **GRU_SHAPES["sweep"])
        ys = fwd_k(*fwd, **flags)[0]
        args = [fwd[0], ys, gys] + fwd[1:]
        solo = [(f, fwd_k(*f, **flags)[0], g) for f, g in members]

        def solo_fwd():
            for f, _, _ in solo:
                fwd_k(*f, **flags)

        def solo_bwd():
            for f, y, g in solo:
                bwd_k(f[0], y, g, *f[1:], **flags)

        def plain_fwd():
            for f, _, _ in solo:
                fwd_p(*f, **flags)

        def plain_bwd():
            for f, y, g in solo:
                bwd_p(f[0], y, g, *f[1:], **flags)

        ms[field] = {"fwd": timed(lambda: fwd_k(*fwd, **flags), reps=reps),
                     "bwd": timed(lambda: bwd_k(*args, **flags), reps=reps),
                     "fwd_solo_k": timed(solo_fwd, reps=reps),
                     "bwd_solo_k": timed(solo_bwd, reps=reps),
                     "fwd_plain": timed(plain_fwd, reps=2, warmup=1),
                     "bwd_plain": timed(plain_bwd, reps=2, warmup=1)}
        dims = fc.check_kernel_inputs(*members[0][0], **flags)
        flops = CDE_K * cde_flops(flags, *dims)
        nbytes_in = 4 * sum(t.numel() for t in fwd if t is not None)
        grads = bwd_k(*args, **flags)
        bounds[field] = {
            "fwd": bound(nbytes_in + 4 * ys.numel(), flops),
            "bwd": bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                          + sum(g.numel() for g in grads
                                                if g is not None)),
                         3 * flops)}
        for part in ("fwd", "bwd"):
            print(f"time packed CDE {field} K={CDE_K} {part}: "
                  f"{ms[field][part]:.4f} ms against {CDE_K} solo launches "
                  f"{ms[field][part + '_solo_k']:.4f} ms (plain, member by "
                  f"member, {ms[field][part + '_plain']:.2f} ms; bound "
                  f"{bounds[field][part][0]:.5f} ms by "
                  f"{bounds[field][part][1]})", flush=True)
    return ms, bounds


def gruode_step_fns():
    """One training step (cross-entropy, the 100x fc2 hook, the clip at
    10, Adam) of ISTSClassifier("gru-ode") at the sweep cell (64 rows of
    uea_b_noisy, 30% missing, natural coefficients, hidden 16, rk4):
    {label: step()} through the CDE kernels and with use_fused=False (the
    eager cdeint)."""
    from snsde_torch.harness.robustness import (ISTSClassifier,
                                                ists_train_step,
                                                preprocess_ists)
    from snsde_torch.train.loop import readout_grad_hook

    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:SWEEP["B"]], missing_rate=0.3, seed=0,
                           interpolation="natural")
    dev = torch.device(DEV)
    batch = {"seq": torch.as_tensor(data["seq"], device=dev),
             "coeffs": torch.as_tensor(data["coeffs"], device=dev),
             "y": torch.as_tensor(y[:SWEEP["B"]], device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = ISTSClassifier("gru-ode", SWEEP["D"], SWEEP["L"], SWEEP["H"],
                               SWEEP["classes"],
                               generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        readout_grad_hook("fc2")(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out[label] = (lambda model=model, opt=opt, fused=fused:
                      ists_train_step(model, opt, batch, use_fused=fused))
    return out


# ---------------------------------------------------------------------------
# Phase 11: the linear controls on the CDE kernels, and the solvers no
# kernel takes (milstein, heun, adaptive Euler–Maruyama, the adaptive and
# extra ODE solvers)
# ---------------------------------------------------------------------------

LINEAR_MODELS = ("neuralcde-l", "neuralcde-r")
# the sweep cell's CDE shape (hidden 16, FinalTanh with no inner layer)
LINEAR = dict(B=SWEEP["B"], L=SWEEP["L"], C=SWEEP["D"] + 1, H=SWEEP["H"],
              n_inner=0)
SDE_METHODS = ("milstein", "heun")
# the adaptive solvers' small card-vs-CPU problem, and their timing width
# (the MuJoCo path's B and H)
ADAPTIVE = dict(B=64, H=16)
ADAPTIVE_TIMES = dict(B=SRK["B"], H=SRK["H"])
ODE_METHODS = ("dopri5", "rk23", "rk12", "ode23s", "sym12")


def linear_cde_inputs(name, B, L, C, H, n_inner, seed=0):
    """Detached inputs of the CDE pair on the linear control the sweep's
    `name` layer builds: knot values (time ‖ x) over linspace(0, 1, L) of
    random series, a FinalTanh field; neuralcde-l steps at the smallest
    knot gap (106 rk4 steps at L=60), neuralcde-r on the rectilinear
    knots' index at dt = 1 (118 steps). Returns (tensors in the forward's
    order, flags, gys, (stage times on a knot, stage times within one ulp
    of a knot but not on it))."""
    from snsde_torch.kernels import fused_cde as fc
    from snsde_torch.models import FinalTanh, resolve_dt
    from snsde_torch.ops import (LinearPath, fill_missing_linear, make_grid,
                                 rectilinear_coeffs)

    rng = np.random.default_rng(seed)
    func = FinalTanh(C, H, H, n_inner + 1,
                     generator=torch.Generator().manual_seed(seed)).to(DEV)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    tt = torch.as_tensor(times)
    x = torch.as_tensor(rng.normal(size=(B, L, C - 1)).astype(np.float32))
    vals = fill_missing_linear(tt, torch.cat(
        [tt[None, :, None].expand(B, -1, 1), x], dim=-1))
    if name == "neuralcde-r":
        _, vals = rectilinear_coeffs(tt, vals)
        times = np.arange(2 * L - 1, dtype=np.float32)
    path = LinearPath(times, vals.to(DEV))
    grid, _ = make_grid(times, resolve_dt(times, floor=0.0))
    z0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    with torch.no_grad():
        inp = fc.fused_cde_inputs(func, path, grid, z0, "rk4")
    fwd = [None if inp[k] is None else inp[k].detach().contiguous()
           for k in fc._ARG_ORDER]
    stage = fc._stage_grid(grid, np.diff(grid), fc._stage_times("rk4")[0])
    knot = times[np.abs(stage[:, None] - times[None, :]).argmin(axis=1)]
    gap = np.abs(stage - knot)
    near = (int((gap == 0).sum()),
            int(((gap > 0) & (gap <= np.spacing(knot))).sum()))
    M = len(grid) - 1
    gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32) / B)
    return fwd, dict(method="rk4", act=inp["act"]), gys.to(DEV), near


def compare_linear_cde():
    """The CDE pair against its plain versions on both linear streams at
    the sweep cell (check_pair_rows: the trajectory and every cotangent,
    ddx included, by the rules of the cubic stream), the neuralcde-l grid
    with stage times within one ulp of knots. Returns the largest forward
    and backward errors."""
    errs = []
    for name in LINEAR_MODELS:
        fwd, flags, gys, (on, near) = linear_cde_inputs(name, **LINEAR)
        print(f"  {name} stream: {gys.shape[0]} rk4 steps, {on} stage times "
              f"on a knot, {near} within one ulp of a knot", flush=True)
        if name == "neuralcde-l" and near < 1:
            raise AssertionError("no stage time within one ulp of a knot")
        cde_plans([(LINEAR["B"], LINEAR["H"], LINEAR["C"],
                    LINEAR["n_inner"])])
        errs.append(check_pair_rows(
            f"CDE {name} linear stream B={LINEAR['B']} (M={gys.shape[0]}) "
            f"C={LINEAR['C']} H={LINEAR['H']}", "cde", fwd, flags, gys))
    return tuple(max(e[i] for e in errs) for i in range(2))


def check_trained_linear_cde(name, model, data):
    """A trained linear-control classifier's CDE solve (its layer's own
    path, field, z0 and grid) through the fused kernels against the eager
    cdeint: within the larger of TOL_YS and YS_F64_FACTOR times the
    float32 eager solve's own largest error from a float64 run of the
    plain version on the same control stream (over max|z|). The float64
    reference takes the stream the float32 stage times give: on a linear
    control a float64 stage time an ulp across a knot would take another
    slope, and another solve."""
    from snsde_torch.kernels import fused_cde as fc
    from snsde_torch.models import neuralcde
    from snsde_torch.ops import cdeint, make_grid

    seen = []
    real = neuralcde.cde_solve_dispatch

    def record(path, func, z0, ts, **kw):
        seen.append((path, func, z0, ts, kw))
        return real(path, func, z0, ts, **kw)

    neuralcde.cde_solve_dispatch = record
    try:
        with torch.no_grad():
            model.layer(torch.as_tensor(data["seq"], device=DEV), None)
    finally:
        neuralcde.cde_solve_dispatch = real
    (path, func, z0, ts, kw), = seen
    grid, out_idx = make_grid(ts, kw["dt"])
    with torch.no_grad():
        z_f = fc.fused_cde_solve(func, path, ts, z0, dt=kw["dt"],
                                 method=kw["method"])
        z_e = cdeint(path, func, z0, ts, dt=kw["dt"], method=kw["method"])
        inp = fc.fused_cde_inputs(func, path, grid, z0, kw["method"])
        ys64 = fc.fused_cde_forward_reference(
            *(_dbl(inp[k]) for k in fc._ARG_ORDER), method=inp["method"],
            act=inp["act"])
    z_64 = torch.cat([z0[None].double(), ys64])[
        torch.as_tensor(out_idx, device=z0.device)]
    scale = float(z_64.abs().max())
    rel = float((z_f - z_e).abs().max()) / scale
    e_eager = float((z_e.double() - z_64).abs().max()) / scale
    tol = max(TOL_YS, YS_F64_FACTOR * e_eager)
    print(f"trained {name}: fused vs eager rk4 CDE solve, B={z_f.shape[1]}: "
          f"shape {tuple(z_f.shape)}, largest err over max|z| {rel:.3e} "
          f"(tol {tol:.3e}; the float32 eager solve from float64 "
          f"{e_eager:.3e})")
    if not (torch.isfinite(z_f).all() and rel <= tol):
        raise AssertionError(f"trained {name} model's fused solve disagrees")


def linear_sweep_path(out_dir):
    """The sweep cell with neuralcde-l and neuralcde-r (rk4, hidden 16) for
    2 epochs each, every count set to 0 just before each run: each must
    launch the CDE kernels (forward and backward), take the eager cdeint
    nowhere, write a record with an accuracy and no error, give a finite
    loss on the validation rows, and its trained layer's fused solve must
    match the eager one (check_trained_linear_cde). Returns each run's
    launch counts."""
    from snsde_torch.harness.robustness import (SweepConfig, coeff_family,
                                                preprocess_ists,
                                                run_robustness_sweep)
    from snsde_torch.models import neuralcde
    from snsde_torch.train.loop import softmax_cross_entropy

    X, y, _ = uea_b_noisy()
    out = {}
    for name in LINEAR_MODELS:
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=2, out_dir=out_dir)
        trained, eager = {}, []
        real = neuralcde.cdeint

        def counted(*a, **k):
            eager.append(1)
            return real(*a, **k)

        neuralcde.cdeint = counted
        zero_counts()
        t0 = time.perf_counter()
        try:
            recs = run_robustness_sweep(cfg, n=SWEEP["n"],
                                        data_fn=uea_b_noisy,
                                        dataset_name="uea_b_noisy",
                                        verbose=False, device=DEV,
                                        models=trained)
            torch.cuda.synchronize()
            launches = out[name] = read_counts()
        finally:
            neuralcde.cdeint = real
        wall = time.perf_counter() - t0
        model = trained.get((0.3, name, 0))
        data = preprocess_ists(X[:64], missing_rate=0.3, seed=0,
                               interpolation=coeff_family(name))
        loss = float("nan")
        if model is not None:
            model.eval()
            with torch.no_grad():
                logits = model(torch.as_tensor(data["seq"], device=DEV),
                               torch.as_tensor(data["coeffs"], device=DEV))
                loss = float(softmax_cross_entropy(
                    logits, torch.as_tensor(y[:64], device=DEV).long()))
        print(f"main path 11: run_robustness_sweep ({name}, rk4) 2 epochs in "
              f"{wall:.1f} s, records {recs}, validation-rows loss "
              f"{loss:.4f}, eager cdeint calls {len(eager)}, launches "
              f"{launches}", flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           for r in recs):
            raise AssertionError(f"the {name} sweep wrote a failed record: "
                                 f"{recs}")
        if not (all(np.isfinite(r["accuracy"]) for r in recs)
                and np.isfinite(loss)):
            raise AssertionError(f"non-finite accuracy or loss with {name}")
        if launches["cde_fwd"] <= 0 or launches["cde_bwd"] <= 0:
            raise AssertionError(f"{name} did not run the CDE kernels: "
                                 f"{launches}")
        if eager:
            raise AssertionError(f"{name} took the eager cdeint "
                                 f"{len(eager)} times")
        check_trained_linear_cde(name, model, data)
    return out


def check_sde_card_vs_cpu(func, method, B=64):
    """A trained field's eager `method` solve at the MuJoCo shape on the
    card against the same solve on the CPU, on one injected BrownianGrid:
    within the larger of TOL_YS and YS_F64_FACTOR times the CPU float32
    solve's own largest error from a float64 run of it (over max|ys|)."""
    import copy

    from snsde_torch.ops import (BrownianGrid, CubicPath,
                                 hermite_cubic_coeffs, make_grid, sdeint)

    rng = np.random.default_rng(2)
    L, C, H = SRK["L"], SRK["C"], SRK["H"]
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    grid, _ = make_grid(times, 1.0)
    dW = torch.as_tensor(rng.normal(size=(len(grid) - 1, B, H)).astype(
        np.float32))
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32))

    def solve(dev, dtype):
        fld = copy.deepcopy(func).to(device=dev, dtype=dtype)
        path = CubicPath(hermite_cubic_coeffs(
            torch.as_tensor(times, dtype=dtype), x.to(dtype)).to(dev), times)
        fld.bind(path)
        with torch.no_grad():
            return sdeint(fld.f, fld.g, y0.to(device=dev, dtype=dtype),
                          times, method=method,
                          bm=BrownianGrid(grid, dW.to(device=dev,
                                                      dtype=dtype)))

    ys_card = solve(DEV, torch.float32).cpu()
    ys_cpu = solve("cpu", torch.float32)
    ys_64 = solve("cpu", torch.float64)
    scale = float(ys_64.abs().max())
    rel = float((ys_card - ys_cpu).abs().max()) / scale
    e32 = float((ys_cpu.double() - ys_64).abs().max()) / scale
    tol = max(TOL_YS, YS_F64_FACTOR * e32)
    print(f"trained field ({func.input_option},{func.noise_option}): "
          f"{method} solve on the card vs the CPU, B={B}: shape "
          f"{tuple(ys_card.shape)}, largest err over max|ys| {rel:.3e} (tol "
          f"{tol:.3e}; the CPU float32 solve from float64 {e32:.3e})")
    if not (torch.isfinite(ys_card).all() and rel <= tol):
        raise AssertionError(f"the {method} solve on the card disagrees with "
                             f"the CPU")


def sde_method_mujoco_path(method):
    """run_mujoco with `method` (milstein or heun: the eager sdeint, as the
    JAX package solves them) at the MuJoCo shape for 1 epoch, every count
    set to 0 just before it: the MSEs finite, no EM or SRK launch, and the
    trained field's solve on the card matching the CPU's
    (check_sde_card_vs_cpu). Returns the launch counts."""
    import dataclasses

    from snsde_torch.harness.forecasting import run_mujoco

    cfg = dataclasses.replace(mujoco_config(), method=method)
    zero_counts()
    t0 = time.perf_counter()
    res = run_mujoco(cfg, n=N_MUJOCO, max_epochs=1, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mses = [h[s] for h in res["history"] for s in ("train", "val", "test")]
    mses.append(res["test_mse"])
    print(f"main path 11: run_mujoco ({method}) 1 epoch in {wall:.1f} s "
          f"({res['steps']} steps), MSEs {[round(v, 4) for v in mses]}, "
          f"launches {launches}", flush=True)
    if not all(np.isfinite(mses)):
        raise AssertionError(f"non-finite MSE on the forecasting path with "
                             f"{method}")
    kernels = {k: v for k, v in launches.items()
               if k.startswith(("em_", "srk_")) and v}
    if kernels:
        raise AssertionError(f"run_mujoco with {method} launched SDE kernels: "
                             f"{kernels}")
    check_sde_card_vs_cpu(res["model"].func, method)
    return launches


def _solver_problem(B, H, dtype, dev, seed=0):
    """Weights, y0 and (f, g) of a small channel-mixing SDE/ODE."""
    rng = np.random.default_rng(seed)
    A, S = (torch.as_tensor(rng.normal(size=(H, H)) * 0.6 / np.sqrt(H),
                            dtype=dtype, device=dev) for _ in range(2))
    b = torch.as_tensor(rng.normal(size=(H,)) * 0.3, dtype=dtype, device=dev)
    y0 = torch.as_tensor(rng.normal(size=(B, H)), dtype=dtype, device=dev)
    f = lambda t, y: (0.5 * torch.tanh(y @ A + b) * (1.0 + 0.2 * torch.sin(t))
                      - 0.2 * y)
    g = lambda t, y: 0.4 * torch.sigmoid(y @ S)
    return f, g, y0


def _run_solver(name, f, g, y0, calls):
    """One solve of the adaptive EM or an ODE method over [0, 1] (five
    outputs), counting the drift's calls into `calls`."""
    from snsde_torch.ops import odeint, sdeint_adaptive

    def fc(t, y):
        calls.append(1)
        return f(t, y)

    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    with torch.no_grad():
        if name == "sdeint_adaptive":
            return sdeint_adaptive(fc, g, y0, ts, seed=0, rtol=1e-2,
                                   atol=1e-3, differentiable=True)
        kw = (dict(dt=0.05) if name in ("ode23s", "sym12")
              else dict(differentiable=True))
        return odeint(fc, y0, ts, method=name, **kw)


def compare_solvers_card_vs_cpu():
    """sdeint_adaptive (its Virtual Brownian Tree's counter draws the same
    on both devices) and the five adaptive and extra ODE solvers at a small
    size (ADAPTIVE), on the card against the CPU: in float64, where the
    step control sees the true errors on both devices (in float32 the
    first trial steps' error estimates are rounding noise, so the two
    devices' grids may part), the same count of drift calls and the
    outputs within 1e-9 of max|ys|; then in float32 on the card, finite."""
    for name in ("sdeint_adaptive",) + ODE_METHODS:
        out, calls = {}, {}
        for dev in (DEV, "cpu"):
            f, g, y0 = _solver_problem(**ADAPTIVE, dtype=torch.float64,
                                       dev=dev)
            calls[dev] = []
            out[dev] = _run_solver(name, f, g, y0, calls[dev]).cpu()
        f, g, y0 = _solver_problem(**ADAPTIVE, dtype=torch.float32, dev=DEV)
        ys32 = _run_solver(name, f, g, y0, [])
        scale = float(out["cpu"].abs().max())
        rel = float((out[DEV] - out["cpu"]).abs().max()) / scale
        rel32 = float((ys32.double().cpu() - out["cpu"]).abs().max()) / scale
        print(f"  {name}: card vs CPU (float64) largest err over max|ys| "
              f"{rel:.3e}, drift calls {len(calls[DEV])} / "
              f"{len(calls['cpu'])}; float32 on the card from the float64 "
              f"{rel32:.3e}", flush=True)
        if not (len(calls[DEV]) == len(calls["cpu"]) and rel <= 1e-9
                and torch.isfinite(out[DEV]).all()
                and torch.isfinite(ys32).all()):
            raise AssertionError(f"{name} on the card disagrees with the CPU")


def adaptive_solver_times(reps=3):
    """Wall ms of one solve of sdeint_adaptive and of each adaptive or
    extra ODE method at ADAPTIVE_TIMES in float32 on the card (host clock
    around the solve and a synchronise, median of `reps` after one
    warm-up), and per trial step: the adaptive loops read each trial's
    error back to the host. {name: (ms a solve, trial steps, ms a trial
    step)}."""
    out = {}
    for name in ("sdeint_adaptive",) + ODE_METHODS:
        f, g, y0 = _solver_problem(**ADAPTIVE_TIMES, dtype=torch.float32,
                                   dev=DEV)
        runs = []
        for i in range(reps + 1):
            calls = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _run_solver(name, f, g, y0, calls)
            torch.cuda.synchronize()
            if i:
                runs.append((time.perf_counter() - t0) * 1e3)
        # drift calls a trial step: 2 (EM: a full step, then the second
        # half step; the first half step reuses the full step's), 6
        # (dopri5, FSAL, plus one for the first step), 4 (rk23), 2 (rk12);
        # a fixed grid's step: 3 (ode23s: the Jacobian's, two stages), 2
        # (sym12, plus one for the first velocity)
        per = {"sdeint_adaptive": 2, "dopri5": 6, "rk23": 4, "rk12": 2,
               "ode23s": 3, "sym12": 2}[name]
        trials = max((len(calls) - (1 if name in ("dopri5", "sym12")
                                    else 0)) // per, 1)
        ms = statistics.median(runs)
        out[name] = (ms, trials, ms / trials)
        print(f"time {name} at B={ADAPTIVE_TIMES['B']} H={ADAPTIVE_TIMES['H']} "
              f"(float32, five outputs over [0, 1]): {ms:.2f} ms a solve, "
              f"{trials} trial steps, {ms / trials:.3f} ms a trial step",
              flush=True)
    return out


def cde_linear_kernel_times():
    """The CDE pair's times, plain versions and bounds on both linear
    streams at the sweep cell (cde_times: the rules of cde_kernel_times).
    ({name: {part: ms}}, {name: {part: bound}})."""
    ms, bounds = {}, {}
    for name in LINEAR_MODELS:
        fwd, flags, gys, _ = linear_cde_inputs(name, **LINEAR)
        ms[name], bounds[name] = cde_times(fwd, flags, gys, name)
    return ms, bounds


def sweep_step_fns(name="neuralcde-l"):
    """One training step (cross-entropy plus kl_weight x a LatentSDE's or
    LEAP's term, the 100x fc2 hook, the clip at 10, Adam) of
    ISTSClassifier(name) at the sweep cell (64 rows of uea_b_noisy, 30%
    missing, hidden 16, the name's default method): {label: step()}
    through the kernels and with use_fused=False (the eager solvers and
    loops)."""
    from snsde_torch.harness.robustness import (ISTSClassifier,
                                                coeff_family,
                                                ists_train_step,
                                                preprocess_ists)
    from snsde_torch.train.loop import readout_grad_hook

    X, y, _ = uea_b_noisy()
    data = preprocess_ists(X[:SWEEP["B"]], missing_rate=0.3, seed=0,
                           interpolation=coeff_family(name))
    dev = torch.device(DEV)
    batch = {"seq": torch.as_tensor(data["seq"], device=dev),
             "coeffs": torch.as_tensor(data["coeffs"], device=dev),
             "y": torch.as_tensor(y[:SWEEP["B"]], device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = ISTSClassifier(name, SWEEP["D"], SWEEP["L"], SWEEP["H"],
                               SWEEP["classes"],
                               generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        readout_grad_hook("fc2")(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out[label] = (lambda model=model, opt=opt, fused=fused:
                      ists_train_step(model, opt, batch, use_fused=fused))
    return out


def sde_method_step_time(method="milstein", reps=3):
    """One training step of the forecasting model at the MuJoCo shape
    (batch 1024, mse + 0.01 L2, coupled-L2 Adam) with `method`, which no
    kernel takes (the eager sdeint): its median ms (CUDA events, after one
    warm-up) and a profiler window of two steps."""
    steps = mujoco_step_fns(method)
    ms = timed(steps["train_step_eager"], reps=reps, warmup=1)
    profile_step(f"mujoco ({method}, eager)", steps["train_step_eager"], n=2)
    return ms


def linear_entry(part, launches, ms, bounds):
    """The CDE pair's entry's fields of the linear streams: per registry
    name, its sweep run's launches, and the pair's time, plain time and
    bound on that name's stream at the sweep cell."""
    out = {}
    for name, sfx in zip(LINEAR_MODELS, ("linear", "rectilinear")):
        out.update({f"launches_{sfx}": launches[name][f"cde_{part}"],
                    f"ms_{sfx}": ms[name][part],
                    f"plain_ms_{sfx}": ms[name][f"{part}_plain"],
                    f"bound_ms_{sfx}": bounds[name][part][0]})
    return out


# ---------------------------------------------------------------------------
# Phase 12: the rest of the model zoo: NeuralRDE, ANCDE, EXIT, LEAP and
# three flow families on the CDE kernels, mTAN's BiGRU on the GRU kernels,
# SAnD, MIAM and the pointwise flows on no kernel
# ---------------------------------------------------------------------------

ZOO_MODELS = ("ancde", "exit", "leap", "neuralrde-1", "neuralrde-2",
              "neuralrde-3", "mtan", "sand", "miam")
FLOW_FAMILIES = ("neuralflow", "neuralflowcde", "neuralmixture",
                 "neuralcontrolledflow")
# each family with each flow option once, the input option rotating
ZOO_FLOWS = tuple(f"{fam}_{'xyz'[(i + j) % 3]}_{fo}"
                  for i, fam in enumerate(FLOW_FAMILIES)
                  for j, fo in enumerate("nrgc"))
# the CDE launches of one layer call (ANCDE: its bottom and top solves)
ZOO_CDE_SOLVES = {"ancde": 2, "exit": 1, "leap": 1, "neuralrde-1": 1,
                  "neuralrde-2": 1, "neuralrde-3": 1}
ZOO_STEPS = ("ancde", "leap", "neuralrde-3", "mtan", "sand", "miam",
             "neuralflowcde_z_c")


def zoo_cde_solves(name):
    """1 or 2 CDE solves a call of the registry layer `name`, 0 for
    SAnD, MIAM, mTAN and the pointwise flows."""
    if name in ZOO_CDE_SOLVES:
        return ZOO_CDE_SOLVES[name]
    return 0 if name.split("_")[0] in ("neuralflow", "mtan", "sand",
                                       "miam") else 1


def zoo_batch(name, rows=SWEEP["B"], seed=0):
    """(seq, coeffs) on the card of `rows` rows of the sweep cell's data,
    30% missing, in the name's coefficient family."""
    from snsde_torch.harness.robustness import coeff_family, preprocess_ists

    X, _, _ = uea_b_noisy()
    data = preprocess_ists(X[:rows], missing_rate=0.3, seed=seed,
                           interpolation=coeff_family(name))
    return (torch.as_tensor(data["seq"], device=DEV),
            torch.as_tensor(data["coeffs"], device=DEV))


def zoo_layer(name, seed=0):
    from snsde_torch.registry import make_seq_layer

    return make_seq_layer(name, SWEEP["D"], SWEEP["L"], SWEEP["H"],
                          generator=torch.Generator().manual_seed(seed)
                          ).to(DEV)


def zoo_solve_inputs(name, seed=0):
    """The CDE pair's detached inputs of each solve the registry layer
    `name` makes on the sweep cell's batch (its own fields, initial
    states, grids and control streams: NeuralRDE's log-signature stream,
    ANCDE's raw and re-fit gated streams), and a cotangent gys of a
    batch-mean loss each: [(label, tensors in the forward's order, flags,
    gys)]."""
    from snsde_torch.kernels import fused_cde as fc
    from snsde_torch.models import ancde
    from snsde_torch.ops import make_grid

    layer = zoo_layer(name, seed)
    seq, coeffs = zoo_batch(name, seed=seed)
    seen, real = [], ancde.cde_solve_dispatch

    def record(path, func, z0, ts, **kw):
        seen.append((path, func, z0, ts, kw))
        return real(path, func, z0, ts, **kw)

    ancde.cde_solve_dispatch = record
    try:
        with torch.no_grad():
            layer(seq, coeffs)
    finally:
        ancde.cde_solve_dispatch = real
    rng = np.random.default_rng(seed)
    out = []
    for k, (path, func, z0, ts, kw) in enumerate(seen):
        grid, _ = make_grid(ts, kw["dt"])
        with torch.no_grad():
            inp = fc.fused_cde_inputs(func, path, grid, z0, kw["method"])
        fwd = [None if inp[n] is None else inp[n].detach().contiguous()
               for n in fc._ARG_ORDER]
        M, (B, H) = len(grid) - 1, z0.shape
        gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32)
                              / B, device=DEV)
        part = ("bottom" if k == 0 else "top") if name == "ancde" else name
        out.append((f"{name}" + (f" {part}" if name == "ancde" else ""),
                    fwd, dict(method=inp["method"], act=inp["act"]), gys))
    return out


def compare_zoo_cde():
    """The CDE pair against its plain versions (check_pair_rows: the
    trajectory and every cotangent, ddx included) on the streams of
    NeuralRDE at depths 1-3 (C = 6, 21, 91 log-signature channels, 23 rk4
    steps) and of ANCDE's two solves (the bottom field H = C = 6, the top
    field on the re-fit gated stream). Returns the largest forward and
    backward errors."""
    from snsde_torch.kernels import fused_cde as fc

    errs = []
    for name in ("neuralrde-1", "neuralrde-2", "neuralrde-3", "ancde"):
        for label, fwd, flags, gys in zoo_solve_inputs(name):
            M, B, H, HH, C, n_inner = fc.check_kernel_inputs(*fwd, **flags)
            cde_plans([(B, H, C, n_inner)])
            errs.append(check_pair_rows(
                f"CDE {label} stream B={B} (M={M}) C={C} H={H} HH={HH}",
                "cde", fwd, flags, gys))
    return tuple(max(e[i] for e in errs) for i in range(2))


def _f64_rule(label, fused, eager, ref64):
    """fused against eager, both float32, over max|ref64|: within the
    larger of TOL_YS and YS_F64_FACTOR times eager's own largest error
    from the float64 run. Returns the error."""
    fused, eager, ref64 = fused.detach(), eager.detach(), ref64.detach()
    scale = max(float(ref64.abs().max()), 1e-30)
    rel = float((fused.double() - eager.double()).abs().max()) / scale
    e32 = float((eager.double() - ref64).abs().max()) / scale
    tol = max(TOL_YS, YS_F64_FACTOR * e32)
    print(f"    {label}: largest err over max {rel:.3e} (tol {tol:.3e}; "
          f"the float32 eager run from float64 {e32:.3e})")
    if not (torch.isfinite(fused).all() and rel <= tol):
        raise AssertionError(f"{label}: the kernels disagree with the "
                             f"eager solve")
    return rel


def _layer_runs(layer, seq, coeffs, grads=False):
    """The layer's (out, hn) through the kernels, through the eager
    solvers and in float64 through the eager solvers (a copy), and with
    `grads` the parameter gradients of mean(out²) + mean(hn) of each."""
    import copy

    runs = []
    for fused, dtype in ((True, torch.float32), (False, torch.float32),
                         (False, torch.float64)):
        m = layer if dtype == torch.float32 else copy.deepcopy(
            layer).double()
        for p in m.parameters():
            p.grad = None
        with torch.set_grad_enabled(grads):
            res = m(seq.to(dtype), coeffs.to(dtype), use_fused=fused)
            if grads:
                ((res[0] ** 2).mean() + res[1].mean()).backward()
        runs.append((res, {n: p.grad for n, p in m.named_parameters()}))
    return runs


def check_ancde_gate_grad():
    """ANCDE's gate gets its gradient through the top solve's re-fit
    control stream, which here requires grad: a fresh `ancde` layer's
    outputs and every parameter gradient (time_attention's through the
    backward kernel's ddx) through the kernels against the eager solves
    on the sweep cell's batch, by the float64 rule (_f64_rule)."""
    layer = zoo_layer("ancde", seed=3)
    seq, coeffs = zoo_batch("ancde", seed=3)
    zero_counts()
    (rf, gf), (re_, ge), (r64, g64) = _layer_runs(layer, seq, coeffs, True)
    n = read_counts()
    print(f"  ANCDE gate gradient through the top control stream (B="
          f"{seq.shape[0]}), kernel launches {n['cde_fwd']} forward, "
          f"{n['cde_bwd']} backward:")
    if n["cde_fwd"] != 2 or n["cde_bwd"] != 2:
        raise AssertionError(f"ancde launched {n}")
    for i in range(2):
        _f64_rule(("out", "hn")[i], rf[i], re_[i], r64[i])
    worst = 0.0
    for name, g in gf.items():
        worst = max(worst, _f64_rule(f"d {name}", g, ge[name], g64[name]))
    return worst


def check_trained_zoo_layer(name, model, seq, coeffs):
    """A trained classifier's layer output through the kernels against
    use_fused=False on the same rows, by the float64 rule."""
    model.eval()
    (rf, _), (re_, _), (r64, _) = _layer_runs(model.layer, seq, coeffs)
    print(f"trained {name}: layer output through the kernels vs the eager "
          f"solves on {seq.shape[0]} rows:")
    _f64_rule("out", rf[0], re_[0], r64[0])


def mtan_bigru_inputs(seed=0):
    """mTAN's BiGRU at the sweep cell: a registry `mtan` layer's two GRU
    cells and its attention output xs [L, B, H] (detached) on the sweep
    cell's batch."""
    layer = zoo_layer("mtan", seed)
    seq, _ = zoo_batch("mtan", seed=seed)
    enc = layer.inner.enc
    D = SWEEP["D"]
    inp = torch.cat([seq[:, 0], seq[:, 1]], dim=-1)
    ts = torch.linspace(0.0, 1.0, seq.shape[2], device=DEV).expand(
        seq.shape[0], -1)
    with torch.no_grad():
        mk = inp[:, :, D:]
        out = enc.att(enc.time_emb(enc.query), enc.time_emb(ts), inp,
                      torch.cat([mk, mk], dim=2))
    return enc.gru_f, enc.gru_b, out.movedim(1, 0).contiguous()


def compare_mtan_bigru():
    """fused_gru_scan on mTAN's two cells (forward, and reverse=True)
    against the eager loop over the cell in that direction: hs and every
    gradient (xs, the cell's parameters) within TOL_GRAD of its largest
    entry. Returns the largest forward and backward errors."""
    from snsde_torch.kernels import fused_rnn as fr
    from snsde_torch.models.rnn import scan_cell

    cell_f, cell_b, xs = mtan_bigru_inputs()
    w = torch.randn(xs.shape[:2] + (cell_f.hidden_size,), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(1))
    err_f = err_b = 0.0
    for cell, reverse in ((cell_f, False), (cell_b, True)):
        outs = []
        for fused in (True, False):
            for p in cell.parameters():
                p.grad = None
            x = xs.clone().requires_grad_(True)
            hs = (fr.fused_gru_scan(cell, x, reverse=reverse) if fused
                  else scan_cell(cell, x, reverse))
            (hs * w).sum().backward()
            outs.append([hs.detach(), x.grad]
                        + [p.grad for p in cell.parameters()])
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(*outs)]
        print(f"  mTAN BiGRU B={xs.shape[1]} L={xs.shape[0]} "
              f"H={cell.hidden_size}{' reverse' if reverse else ''} vs the "
              f"eager loop: hs {errs[0]:.3e}, dxs {errs[1]:.3e}, d params "
              f"{max(errs[2:]):.3e} over max (tol {TOL_GRAD:g})")
        if not max(errs) <= TOL_GRAD:
            raise AssertionError("mTAN's fused GRU scan disagrees")
        err_f = max(err_f, float((outs[0][0] - outs[1][0]).abs().max()))
        err_b = max(err_b, max(float((a - b).abs().max())
                               for a, b in zip(outs[0][1:], outs[1][1:])))
    return err_f, err_b


def mtan_gru_times():
    """The GRU pair at mTAN's shape in each direction: the forward and
    backward kernels (each wrapper's call; the backward's its recurrence,
    weight gradient and sums) and their plain versions on mTAN's cells
    (the reverse cell's projected stream flipped, as fused_gru_scan
    launches it), from h0 = 0, and the bounds of rnn_kernel_times.
    {direction: ms}, {direction: bounds}."""
    return bigru_times(*mtan_bigru_inputs(), "mTAN's shape")


def bigru_times(cell_f, cell_b, xs, where):
    """mtan_gru_times on a BiGRU's two cells and its input xs [L, B, C]."""
    fwd, bwd, fwd_p, bwd_p = rnn_fns("gru")
    L, B, H = xs.shape[0], xs.shape[1], cell_f.hidden_size
    ghs = torch.randn(L, B, H, device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(2))
    ms, bounds = {}, {}
    for label, cell, reverse in (("forward", cell_f, False),
                                 ("reverse", cell_b, True)):
        with torch.no_grad():
            gi = xs @ cell.w_ih + cell.b_ih
            gi = (torch.flip(gi, (0,)) if reverse else gi).contiguous()
            inp = {"gi": gi, "h0": xs.new_zeros((B, H)),
                   "whh": cell.w_hh.detach().contiguous(),
                   "bhh": cell.b_hh.detach().contiguous()}
            hs = fwd(**inp)
            bargs = dict(hs=hs, ghs=ghs, **inp)
            ms[label] = {"fwd": timed(lambda: fwd(**inp)),
                         "fwd_plain": timed(lambda: fwd_p(**inp), reps=5,
                                            warmup=1),
                         "bwd": timed(lambda: bwd(**bargs)),
                         "bwd_plain": timed(lambda: bwd_p(**bargs), reps=5,
                                            warmup=1)}
            grads = [g for g in bwd(**bargs) if g is not None]
        prod = 2 * L * B * H * 3 * H
        n_in = sum(t.numel() for t in inp.values())
        n_bwd = sum(t.numel() for t in bargs.values()) + sum(
            g.numel() for g in grads)
        bounds[label] = {"fwd": bound(4 * (n_in + L * B * H), prod),
                         "bwd": bound(4 * n_bwd, 3 * prod)}
        print(f"GRU pair at {where} ({label}) B={B} L={L} H={H}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms[label].items())
              + f"; bounds {bounds[label]['fwd'][0]:.5f} / "
                f"{bounds[label]['bwd'][0]:.5f} ms", flush=True)
    return ms, bounds


def zoo_cde_times():
    """The CDE pair's times, plain versions and bounds (cde_times) on
    NeuralRDE-3's log-signature stream and on ANCDE's two solves at the
    sweep cell: {label: ms}, {label: bounds}."""
    ms, bounds = {}, {}
    for name in ("neuralrde-3", "ancde"):
        for label, fwd, flags, gys in zoo_solve_inputs(name):
            ms[label], bounds[label] = cde_times(fwd, flags, gys, label)
    return ms, bounds


class ZooWatch:
    """While active: the eager cdeint's calls (`eager`) and, through
    models.neuralsde, the eager sdeint's (`eager_sde`), the fused GRU
    scan's calls and directions, and the registry layer's calls."""

    def __enter__(self):
        from snsde_torch import registry
        from snsde_torch.models import neuralcde, neuralsde, rnn

        self.eager = self.eager_sde = self.scans = self.calls = 0
        self.directions = set()
        self.mods = ((neuralcde, "cdeint"), (neuralsde, "sdeint"),
                     (rnn, "fused_gru_scan"), (registry.SeqLayer, "forward"))
        self.real = [getattr(m, a) for m, a in self.mods]
        cdeint, sdeint, scan, fwd = self.real

        def counted_cdeint(*a, **k):
            self.eager += 1
            return cdeint(*a, **k)

        def counted_sdeint(*a, **k):
            self.eager_sde += 1
            return sdeint(*a, **k)

        def counted_scan(*a, reverse=False, **k):
            self.scans += 1
            self.directions.add(reverse)
            return scan(*a, reverse=reverse, **k)

        def counted_forward(layer, *a, **k):
            self.calls += 1
            return fwd(layer, *a, **k)

        for (m, a), f in zip(self.mods, (counted_cdeint, counted_sdeint,
                                         counted_scan, counted_forward)):
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for (m, a), f in zip(self.mods, self.real):
            setattr(m, a, f)


def check_zoo_launches(name, launches, watch):
    """The kernels of a run of registry layer `name`: the CDE pair (solves
    x layer calls forward launches, backward launches in training) and no
    eager cdeint for a CDE name; the GRU pair in both directions for mtan
    (two forward launches a call); no kernel for the others."""
    solves = zoo_cde_solves(name)
    others = {k: v for k, v in launches.items()
              if v and not (solves and k in ("cde_fwd", "cde_bwd"))
              and not (name == "mtan" and k in ("gru_fwd", "gru_bwd",
                                                "gru_wgrad"))}
    if others:
        raise AssertionError(f"{name} launched other kernels: {others}")
    if solves:
        if launches["cde_fwd"] != solves * watch.calls:
            raise AssertionError(f"{name}: {launches['cde_fwd']} CDE "
                                 f"forward launches in {watch.calls} layer "
                                 f"calls of {solves} solves")
        if watch.eager:
            raise AssertionError(f"{name} took the eager cdeint "
                                 f"{watch.eager} times")
    if name == "mtan" and (watch.directions != {False, True}
                           or launches["gru_fwd"] != 2 * watch.calls):
        raise AssertionError(f"mtan: GRU directions {watch.directions}, "
                             f"{launches['gru_fwd']} forward launches in "
                             f"{watch.calls} calls")


def zoo_sweep_path(out_dir):
    """The sweep cell (uea_b_noisy, hidden 16) with the nine non-flow
    names for 2 epochs each and ZOO_FLOWS for 1 epoch each, one model a
    run, every count set to 0 just before the run and read just after:
    each writes a record with a finite accuracy and no error, and launches
    the kernels where the JAX package has them (check_zoo_launches; a
    trained model's backward launches too, the CDE pair's). The trained
    ancde and neuralrde-3 layers' outputs through the kernels must match
    use_fused=False on 16 rows. Then each of the other 32 flow names runs
    one forward pass on the card, 64 rows. Returns each run's launches."""
    from snsde_torch.harness.robustness import (SweepConfig,
                                                run_robustness_sweep)
    from snsde_torch.registry import MODEL_NAMES

    t_phase = time.perf_counter()
    out = {}
    for name in ZOO_MODELS + ZOO_FLOWS:
        epochs = 2 if name in ZOO_MODELS else 1
        cfg = SweepConfig(models=(name,), missing_rates=(0.3,), seeds=(0,),
                          hidden_dim=SWEEP["H"], batch_size=SWEEP["B"],
                          max_epochs=epochs, out_dir=out_dir)
        trained = {}
        with ZooWatch() as watch:
            zero_counts()
            t0 = time.perf_counter()
            recs = run_robustness_sweep(cfg, n=SWEEP["n"],
                                        data_fn=uea_b_noisy,
                                        dataset_name="uea_b_noisy",
                                        verbose=False, device=DEV,
                                        models=trained)
            torch.cuda.synchronize()
            launches = out[name] = read_counts()
        moved = {k: v for k, v in launches.items() if v}
        print(f"main path 12 ({name}): run_robustness_sweep {epochs} "
              f"epoch(s) in {time.perf_counter() - t0:.1f} s, records "
              f"{recs}, {watch.calls} layer calls, launches {moved}",
              flush=True)
        if not recs or any("error" in r or "accuracy" not in r
                           or not np.isfinite(r["accuracy"]) for r in recs):
            raise AssertionError(f"the sweep wrote a failed record: {recs}")
        check_zoo_launches(name, launches, watch)
        if zoo_cde_solves(name) and launches["cde_bwd"] <= 0:
            raise AssertionError(f"{name} ran no CDE backward")
        if name == "mtan" and launches["gru_bwd"] <= 0:
            raise AssertionError("mtan ran no GRU backward")
        if name in ("ancde", "neuralrde-3"):
            seq, coeffs = zoo_batch(name, rows=16)
            check_trained_zoo_layer(name, trained[(0.3, name, 0)], seq,
                                    coeffs)
    rest = [n for n in MODEL_NAMES
            if n.split("_")[0] in FLOW_FAMILIES and n not in ZOO_FLOWS]
    for name in rest:
        layer = zoo_layer(name)
        seq, coeffs = zoo_batch(name)
        with ZooWatch() as watch, torch.no_grad():
            zero_counts()
            res = layer(seq, coeffs)
            torch.cuda.synchronize()
            launches = read_counts()
        if not all(torch.isfinite(r).all() for r in res):
            raise AssertionError(f"{name}: non-finite streams")
        check_zoo_launches(name, launches, watch)
    print(f"main path 12: {len(rest)} more flow names one forward pass "
          f"each; phase 12's runs in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def zoo_entry(part, launches, ms, bounds):
    """The CDE pair's entry's fields of phase 12: the CDE launches of its
    sweep runs, and the pair's time, plain time and bound on NeuralRDE-3's
    stream and on ANCDE's two solves."""
    out = {"launches_zoo": sum(v[f"cde_{part}"] for v in launches.values())}
    for label, ms_ in ms.items():
        sfx = label.replace("-", "").replace(" ", "_")
        out.update({f"ms_{sfx}": ms_[part],
                    f"plain_ms_{sfx}": ms_[f"{part}_plain"],
                    f"bound_ms_{sfx}": bounds[label][part][0]})
    return out


def mtan_entry(part, launches, ms, bounds):
    """The GRU pair's entry's fields of phase 12: mTAN's sweep run's
    launches, and the pair's reverse and forward times at mTAN's shape."""
    out = {"launches_mtan": launches["mtan"][f"gru_{part}"]}
    for label in ("reverse", "forward"):
        out.update({f"ms_{label}_mtan": ms[label][part],
                    f"plain_ms_{label}_mtan": ms[label][f"{part}_plain"],
                    f"bound_ms_{label}_mtan": bounds[label][part][0]})
    return out


# ---------------------------------------------------------------------------
# Phase 13: the interpolation and activity harnesses: the SDE-encoder VAE
# (the EM pair on a dense stream at H=HH=128, DecRNN3's and MTANDecoder's
# BiGRU on the GRU pair) and the activity classifier (MTANEncoder's BiGRU
# on the GRU pair)
# ---------------------------------------------------------------------------

# the interpolation flagship (tools/run_interpolation_flagship.py
# --rec-hidden 128, RESULTS_interpolation_h128.json): n=8000 synthetic
# PhysioNet-shaped records (L=62, D=36), the encoder neuralsde_2_16 at
# rec_hidden 128 with one hidden layer (C = D + 1 = 37), rnn3, latent 32,
# gen_hidden 64, k_iwae 5, batch 64, 64 reference points: 69 EM steps
# (float32 rounding of linspace(0, 1, 64) splits six of its 63 gaps in
# two, in the JAX package too), a decoder BiGRU over k_iwae x 64 = 320 rows
INTERP = dict(n=8000, L=62, D=36, B=64, H=128, latent=32, gen=64, k=5,
              ref=64)
INTERP_ENCODERS = ("neuralsde_2_16", "neuralsde_4_17", "neuralsde_6_17")
# phase 13's runs: (encoder, decoder, iterations)
INTERP_RUNS = (("neuralsde_2_16", "rnn3", 2), ("neuralsde_4_17", "rnn3", 1),
               ("neuralsde_6_17", "rnn3", 1),
               ("neuralsde_2_16", "mtan_rnn", 1))
INTERP_RESUME_N = 256
INTERP_FLAGSHIP_ITERS = 300
# the activity flagship (tools/run_activity.py): n=1024, batch 128, the
# mTAN encoder at latent 32, rec_hidden 32, embed_time 128, L=50; its
# trainable count (RESULTS_activity.json)
ACTIVITY = dict(n=1024, epochs=2)
ACTIVITY_PARAMS = 155623
ACTIVITY_R5 = dict(seeds=(0, 1, 2, 3, 4), epochs=200, warmup=5)
# the GRU pair's BiGRU shapes (B, L, C, H): the VAE decoders' over the
# k_iwae x batch latent rows, and the activity encoder's
INTERP_GRU = {"interp": (320, 64, 32, 64), "activity": (128, 50, 32, 32)}


def interp_config(enc="neuralsde_2_16", dec="rnn3", niters=2,
                  verbose=False, **kw):
    from snsde_torch.harness.interpolation import InterpolationConfig

    return InterpolationConfig(
        enc=enc, dec=dec, latent_dim=INTERP["latent"],
        rec_hidden=INTERP["H"], rec_num_hidden=1, gen_hidden=INTERP["gen"],
        num_ref_points=INTERP["ref"], k_iwae=INTERP["k"], std=0.01,
        niters=niters, lr=1e-3, batch_size=INTERP["B"], sample_tp=0.5,
        verbose=verbose, **kw)


def interp_data(n, seed):
    """The flagship's synthetic records (tools/run_interpolation_flagship.py
    without the archives)."""
    from snsde_torch.harness.interpolation import synthetic_physionet

    return synthetic_physionet(n=n, length=INTERP["L"], dim=INTERP["D"],
                               observe_rate=0.35, seed=seed)


def interp_control(rows, seed=0):
    """The encoder's control on `rows` records on the card, their keep mask
    from numpy: (times_ref, coeffs)."""
    from snsde_torch.harness.interpolation import encoder_control

    x, m, tp = (torch.as_tensor(a, device=DEV)
                for a in interp_data(rows, seed))
    keep = torch.as_tensor(
        np.random.default_rng(seed).random(tuple(m.shape)) < 0.5, device=DEV)
    return encoder_control(x, m, tp, INTERP["ref"], 0.5, keep=keep)


def interp_grid(times):
    from snsde_torch.models.neuralsde import resolve_dt
    from snsde_torch.ops import make_grid

    return make_grid(times, resolve_dt(times))[0]


def interp_em_inputs(model_name, seed=0):
    """The EM pair's detached inputs at the encoder's shape: a random field
    (C=37, H=HH=128, one hidden layer) on the control of 64 flagship
    records, on the encoder's 69-step grid, dW and y0 from numpy; and a
    dense cotangent gys [M, B, H] (every step feeds the head)."""
    from snsde_torch.fields import DiffusionField
    from snsde_torch.harness.classification import parse_model_name
    from snsde_torch.kernels.fused_em import fused_em_inputs
    from snsde_torch.ops import CubicPath

    B, C, H = INTERP["B"], INTERP["D"] + 1, INTERP["H"]
    times, coeffs = interp_control(B, seed)
    io, no = parse_model_name(model_name)
    field = DiffusionField(C, H, H, 1, input_option=io, noise_option=no,
                           generator=torch.Generator().manual_seed(seed))
    field = field.to(DEV)
    path = CubicPath(coeffs, times)
    grid = interp_grid(times)
    M = len(grid) - 1
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=DEV)
    dW = t(rng.normal(size=(M, B, H)) * np.sqrt(np.diff(grid))[:, None, None])
    y0 = t(rng.normal(size=(B, H)))
    with torch.no_grad():
        inp = fused_em_inputs(field.bind(path), path, grid, y0, dW)
    inp = {k: (v.detach().contiguous() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    return inp, t(rng.normal(size=(M, B, H)) / B)


def compare_interp_em():
    """The EM pair against its plain versions at the encoder's shape for
    each flagship encoder (check_pair_rows), its plans printed. Returns
    the largest forward and backward errors."""
    err = (0.0, 0.0)
    for name in INTERP_ENCODERS:
        inp, gys = interp_em_inputs(name)
        fwd, flags = _split(inp)
        sde_plans("em", [(INTERP["B"], INTERP["H"], 0)], flags["drift"],
                  flags["noise"])
        e = check_pair_rows(f"EM interpolation encoder {name} "
                            f"({flags['drift']}, {flags['noise']}"
                            f"{', mult_y' if flags['mult_y'] else ''}) "
                            f"B={INTERP['B']} M={gys.shape[0]} "
                            f"C={INTERP['D'] + 1} H=HH={INTERP['H']}", "em",
                            fwd, flags, gys)
        err = tuple(max(a, b) for a, b in zip(err, e))
    return err


def compare_interp_gru():
    """The GRU pair at the VAE decoders' and the activity encoder's BiGRU
    shapes: the kernels against their plain versions (compare_rnn: hs and
    every cotangent, the input projection's included), and fused_gru_scan
    in both directions against the eager loop (compare_gru_scan: the
    input's cotangent dxs too), the plans printed. Returns the largest
    forward and backward errors."""
    err = (0.0, 0.0)
    for B, L, C, H in INTERP_GRU.values():
        _plans("gru", [(B, H)])
        e = compare_rnn("gru", B, L, C, H)
        err = tuple(max(a, b) for a, b in zip(err, e))
        for reverse in (False, True):
            compare_gru_scan(B, L, C, H, reverse, False)
    return err


def check_interp_scatter():
    """scatter_to_ref on the card bit for bit its CPU result on 64 flagship
    records (bucket 0 holds two sources in every record)."""
    from snsde_torch.harness.interpolation import scatter_to_ref

    x, m, tp = interp_data(INTERP["B"], 2)
    keep = np.random.default_rng(2).random(m.shape) < 0.5
    idx = np.clip(np.round(tp[0] * INTERP["ref"]).astype(int) - 1, 0,
                  INTERP["ref"] - 1)
    out = [scatter_to_ref(*(torch.as_tensor(a, device=d)
                            for a in (x, m, tp)), INTERP["ref"], 0.5,
                          keep=torch.as_tensor(keep, device=d))
           for d in ("cpu", DEV)]
    same = all(torch.equal(a, b.cpu()) for a, b in zip(*out))
    print(f"  scatter_to_ref on the card vs the CPU, B={INTERP['B']} "
          f"L={INTERP['L']} D={INTERP['D']}, "
          f"{len(idx) - len(set(idx.tolist()))} repeated "
          f"bucket(s) a record: {'bit for bit' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("scatter_to_ref differs between card and CPU")


def check_harness_launches(label, launches, watch, sde_fwd, sde_bwd,
                           gru_bwd):
    """The kernels of a harness run: sde_fwd EM forward and sde_bwd EM
    backward and weight-gradient launches, no eager sdeint; one GRU forward
    launch a fused scan, both directions, gru_bwd backward and
    weight-gradient launches; no other kernel."""
    want = {"em_fwd": sde_fwd, "em_bwd": sde_bwd, "em_wgrad": sde_bwd,
            "gru_fwd": watch.scans, "gru_bwd": gru_bwd,
            "gru_wgrad": gru_bwd}
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v} or watch.eager_sde \
            or watch.directions != {False, True}:
        raise AssertionError(f"{label}: launches {got}, wanted {want}; "
                             f"{watch.eager_sde} eager sdeint calls, GRU "
                             f"directions {watch.directions}")


def check_trained_interp_encoder(model, rows=16):
    """The trained encoder's stream through the EM kernels against the
    eager sdeint (use_fused=False's solve) on the control of `rows` records
    and injected increments: within the larger of TOL_YS and YS_F64_FACTOR
    times the float32 eager solve's own error from float64 (a trained
    field, as check_trained_solve's `amplifies`)."""
    import copy

    from snsde_torch.kernels.fused_em import fused_em_solve
    from snsde_torch.ops import BrownianGrid, CubicPath, sdeint

    times, coeffs = interp_control(rows, seed=1)
    grid = interp_grid(times)
    rng = np.random.default_rng(1)
    dW = torch.as_tensor((rng.normal(size=(len(grid) - 1, rows, INTERP["H"]))
                          * np.sqrt(np.diff(grid))[:, None, None]
                          ).astype(np.float32), device=DEV)
    runs = {}
    with torch.no_grad():
        for label, sde, c, dw in (
                ("fused", model.rec.sde, coeffs, dW),
                ("eager", model.rec.sde, coeffs, dW),
                ("f64", copy.deepcopy(model.rec.sde).double(),
                 coeffs.double(), dW.double())):
            path = CubicPath(c, times)
            field = sde.func.bind(path)
            y0 = sde.initial_network(path.evaluate(path.times[0]))
            runs[label] = (fused_em_solve(field, path, times, y0,
                                          dW_override=dw)
                           if label == "fused" else
                           sdeint(field.f, field.g, y0, times,
                                  bm=BrownianGrid(grid, dw)))
    scale = float(runs["f64"].abs().max())
    e32 = float((runs["eager"].double() - runs["f64"]).abs().max()) / scale
    ek = float((runs["fused"].double() - runs["f64"]).abs().max()) / scale
    rel = float((runs["fused"] - runs["eager"]).abs().max()) / max(
        float(runs["eager"].abs().max()), 1e-30)
    tol = max(TOL_YS, YS_F64_FACTOR * e32)
    print(f"trained interpolation encoder: stream through the kernels vs "
          f"use_fused=False, {rows} rows, {len(grid) - 1} steps: rel "
          f"{rel:.3e} (tol {tol:.3e}; from float64: eager {e32:.3e}, "
          f"fused {ek:.3e})")
    if not (torch.isfinite(runs["fused"]).all() and rel <= tol):
        raise AssertionError("the trained encoder's fused stream disagrees")


def interp_path(out_dir):
    """run_interpolation at the flagship width (INTERP_RUNS: every count
    set to 0 just before each run and read just after): finite ELBOs and
    test_mse, the EM kernels once a batch (forward in training and
    evaluation, backward and weight gradient in training), never the eager
    sdeint, and the GRU kernels in both directions (two forward launches a
    decoder call, two backward a step); the trained (2,16) encoder against
    use_fused=False; then a resume at n=INTERP_RESUME_N, 22 iterations
    straight against 20 and a resume, to 1e-4. Returns each run's
    launches."""
    import os

    from snsde_torch.harness.interpolation import run_interpolation

    t_phase = time.perf_counter()
    n_tr = int(0.8 * INTERP["n"])
    nb_tr = -(-n_tr // INTERP["B"])
    nb_te = -(-(INTERP["n"] - n_tr) // INTERP["B"])
    out = {}
    for enc, dec, iters in INTERP_RUNS:
        with ZooWatch() as watch:
            zero_counts()
            t0 = time.perf_counter()
            res = run_interpolation(interp_config(enc, dec, iters),
                                    n=INTERP["n"], data_fn=interp_data,
                                    device=DEV)
            torch.cuda.synchronize()
            launches = out[(enc, dec)] = read_counts()
        elbos = [h["elbo"] for h in res["history"]]
        print(f"main path 13 ({enc}, {dec}): run_interpolation {iters} "
              f"iteration(s) at n={INTERP['n']} in "
              f"{time.perf_counter() - t0:.1f} s, ELBO {elbos}, test_mse "
              f"{res['test_mse']:.6f}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if not (np.isfinite(elbos).all() and np.isfinite(res["test_mse"])):
            raise AssertionError(f"{enc}/{dec}: non-finite ELBO or MSE")
        check_harness_launches(f"{enc}/{dec}", launches, watch,
                               iters * nb_tr + nb_te, iters * nb_tr,
                               2 * iters * nb_tr)
        if watch.scans != 2 * (iters * nb_tr + nb_te):
            raise AssertionError(f"{enc}/{dec}: {watch.scans} GRU scans")
        if (enc, dec) == INTERP_RUNS[0][:2]:
            check_trained_interp_encoder(res["model"])
    runs = {}
    for label, iters, resume in (("straight", 22, False), ("first", 20, False),
                                 ("resumed", 22, True)):
        runs[label] = run_interpolation(
            interp_config(niters=iters, resume=resume,
                          save_dir=(os.path.join(out_dir, "interp_ckpt")
                                    if label != "straight" else None)),
            n=INTERP_RESUME_N, data_fn=interp_data, device=DEV)
    tail = [h["elbo"] for h in runs["straight"]["history"][-2:]]
    got = [h["elbo"] for h in runs["resumed"]["history"]]
    print(f"resume at n={INTERP_RESUME_N}: straight ELBO {tail}, test_mse "
          f"{runs['straight']['test_mse']:.6f}; resumed {got}, "
          f"{runs['resumed']['test_mse']:.6f}")
    if not (len(got) == 2 and np.allclose(got, tail, rtol=1e-4, atol=0)
            and np.isclose(runs["resumed"]["test_mse"],
                           runs["straight"]["test_mse"], rtol=1e-4, atol=0)):
        raise AssertionError("the resumed run does not reproduce the "
                             "straight one")
    print(f"main path 13: the interpolation runs in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def activity_path():
    """run_activity at its published settings for ACTIVITY["epochs"]
    epochs, the counts set to 0 just before: finite losses, the GRU
    kernels in both directions (a forward launch a fused scan, two
    backward a step), no other kernel, and the trainable count of
    RESULTS_activity.json. Returns its launches."""
    from snsde_torch.harness.activity import (ActivityConfig,
                                              activity_splits, run_activity)

    cfg = ActivityConfig(max_epochs=ACTIVITY["epochs"], verbose=False)
    with ZooWatch() as watch:
        zero_counts()
        t0 = time.perf_counter()
        res = run_activity(cfg, n=ACTIVITY["n"], device=DEV)
        torch.cuda.synchronize()
        launches = read_counts()
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    losses.append(res.test_loss)
    print(f"main path 13 (activity): run_activity {cfg.max_epochs} epochs at "
          f"n={ACTIVITY['n']} in {time.perf_counter() - t0:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, val / test accuracy "
          f"{res.val_accuracy:.4f} / {res.test_accuracy:.4f}, "
          f"{res.parameters} parameters, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss on the activity path")
    if res.parameters != ACTIVITY_PARAMS:
        raise AssertionError(f"activity: {res.parameters} parameters")
    steps = cfg.max_epochs * -(-len(activity_splits(ACTIVITY["n"], 0)[0])
                               // cfg.batch_size)
    check_harness_launches("activity", launches, watch, 0, 0, 2 * steps)
    return launches


def interp_em_times():
    """The EM pair's times, plain versions and bounds (sde_pair_times) at
    the encoder's shape, neuralsde_2_16."""
    inp, gys = interp_em_inputs(INTERP_ENCODERS[0])
    return sde_pair_times(inp, gys)


def interp_gru_times():
    """The GRU pair's times in each direction at the VAE decoder's BiGRU
    (a fresh DecRNN3's cells on N(0, 1) latent rows) and the activity
    encoder's (a fresh MTANEncoder's cells on N(0, 1) attention outputs):
    {shape: ({direction: ms}, {direction: bounds})}."""
    from snsde_torch.nn.layers import GRUCell

    out = {}
    for label, (B, L, C, H) in INTERP_GRU.items():
        gen = torch.Generator().manual_seed(0)
        cells = [GRUCell(C, H, generator=gen).to(DEV) for _ in range(2)]
        xs = torch.randn(L, B, C, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(0))
        out[label] = bigru_times(*cells, xs, f"the {label} BiGRU")
    return out


def interp_step_fns(dec):
    """One training step (elbo_loss at KL weight 1, Adam) of the flagship
    VAE with decoder `dec` on one batch of 64 records: {label: step()}
    through the kernels and with use_fused=False (the eager sdeint and
    GRU loops)."""
    from snsde_torch.harness.interpolation import (build_interpolation_model,
                                                   elbo_loss)

    cfg = interp_config(dec=dec)
    batch = {k: torch.as_tensor(a, device=DEV) for k, a in
             zip(("x", "m", "tp"), interp_data(INTERP["B"], 3))}
    gen = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = build_interpolation_model(cfg, INTERP["D"], DEV)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step(model=model, opt=opt, fused=fused):
            opt.zero_grad(set_to_none=True)
            loss, _ = elbo_loss(model, batch, cfg, 1.0, generator=gen,
                                use_fused=fused)
            loss.backward()
            opt.step()
        out[label] = step
    return out


def activity_step_fns():
    """One training step (loss_fn, Adam) of the activity classifier at its
    published settings on one batch of 128: {label: step()} through the
    kernels and with use_fused=False."""
    from snsde_torch.data.person_activity import synthetic_person_activity
    from snsde_torch.harness.activity import _ActivityModel, loss_fn

    vals, mask, tp, labels = synthetic_person_activity(n=128)
    batch = {"x": torch.as_tensor(np.concatenate([vals, mask], -1),
                                  device=DEV),
             "tp": torch.as_tensor(tp, device=DEV),
             "y": torch.as_tensor(labels, device=DEV),
             "_mask": torch.ones(128, device=DEV)}
    gen = torch.Generator(device=DEV).manual_seed(0)
    query = np.linspace(0.0, 1.0, tp.shape[1], dtype=np.float32)
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = _ActivityModel(vals.shape[-1], query, 32, 32, 128, 1, 7, True,
                               generator=torch.Generator().manual_seed(0))
        model = model.to(DEV)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step(model=model, opt=opt, fused=fused):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, 5, generator=gen,
                              use_fused=fused)
            loss.backward()
            opt.step()
        out[label] = step
    return out


def interp_entry(part, launches, ms, bounds):
    """The EM pair's entry's fields of phase 13: the EM launches of the
    interpolation runs, and the pair's time, plain time and bound at the
    encoder's shape."""
    return {"launches_interp": sum(v[f"em_{part}"]
                                   for v in launches.values()),
            "ms_interp": ms[part], "plain_ms_interp": ms[f"{part}_plain"],
            "bound_ms_interp": bounds[part][0]}


def interp_gru_entry(part, launches, times):
    """The GRU pair's entry's fields of phase 13: the GRU launches of the
    interpolation runs and of the activity run, and the pair's times,
    plain times and bounds in each direction at both BiGRU shapes."""
    out = {"launches_interp": sum(v[f"gru_{part}"]
                                  for v in launches["interp"].values()),
           "launches_activity": launches["activity"][f"gru_{part}"]}
    for shape, (ms, bounds) in times.items():
        for label in ("forward", "reverse"):
            out.update({f"ms_{label}_{shape}": ms[label][part],
                        f"plain_ms_{label}_{shape}":
                            ms[label][f"{part}_plain"],
                        f"bound_ms_{label}_{shape}": bounds[label][part][0]})
    return out


def interp_flagship(out: str = "RESULTS_torch_interpolation_h128.json") -> int:
    """The interpolation flagship at rec_hidden 128 for 300 iterations
    (INTERP, neuralsde_2_16, rnn3, seed 0), its test_mse beside the JAX
    package's in RESULTS_interpolation_h128.json and held to the
    interpolation pin's ceiling (read from test_mse itself: the pin's
    min-mode check sees no MSE in the history, a known fault), written
    to `out`:

        python3 chip_smoke.py --interp-flagship [OUT]"""
    import os

    from snsde_torch.harness.interpolation import run_interpolation
    from snsde_torch.train.pins import FLAGSHIP_PINS

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    jax_mse = None
    if os.path.exists("RESULTS_interpolation_h128.json"):
        with open("RESULTS_interpolation_h128.json") as f:
            jax_mse = next((r["test_mse"] for r in json.load(f)
                            if r["enc"] == INTERP_ENCODERS[0]), None)
    cfg = interp_config(niters=INTERP_FLAGSHIP_ITERS, verbose=True)
    t0 = time.time()
    res = run_interpolation(cfg, n=INTERP["n"], data_fn=interp_data,
                            device=DEV)
    ceiling = FLAGSHIP_PINS["interpolation"].ceiling
    last = res["history"][-1]
    rec = {"enc": cfg.enc, "dec": cfg.dec,
           "data": "synthetic-benchmark-shaped (L=62 q=0.016 grid, D=36)",
           "n": INTERP["n"], "niters": cfg.niters,
           "rec_hidden": cfg.rec_hidden, "rec_num_hidden": 1,
           "gen_hidden": cfg.gen_hidden, "latent_dim": cfg.latent_dim,
           "k_iwae": cfg.k_iwae, "sample_tp": cfg.sample_tp,
           "test_mse": res["test_mse"], "final_elbo": last["elbo"],
           "final_logpx": last["logpx"], "final_kl": last["kl"],
           "wall_time_s": time.time() - t0, "jax_test_mse": jax_mse,
           "ceiling": ceiling,
           "ok": bool(np.isfinite(res["test_mse"])
                      and res["test_mse"] <= ceiling),
           "card": smi}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1), flush=True)
    return 0 if rec["ok"] else 1


def activity_r5(out: str = "RESULTS_torch_activity_k5.json") -> int:
    """The activity flagship's five seeds (ACTIVITY_R5: 200 epochs, n=1024,
    warmup_epochs 5) against RESULTS_activity_k5.json, each seed's test
    accuracy held to the activity pin's floor, written to `out`:

        python3 chip_smoke.py --activity-r5 [OUT]"""
    from snsde_torch.harness.activity import ActivityConfig, run_activity
    from snsde_torch.train.pins import FLAGSHIP_PINS

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    floor = FLAGSHIP_PINS["activity"].floor
    t0 = time.time()
    tests, vals = [], []
    for seed in ACTIVITY_R5["seeds"]:
        res = run_activity(ActivityConfig(
            max_epochs=ACTIVITY_R5["epochs"], k_iwae=5,
            warmup_epochs=ACTIVITY_R5["warmup"], seed=seed, verbose=False),
            n=ACTIVITY["n"], device=DEV)
        tests.append(res.test_accuracy)
        vals.append(res.val_accuracy)
        print(f"activity seed {seed}: test {res.test_accuracy:.4f}, val "
              f"{res.val_accuracy:.4f}, {res.wall_time:.1f} s", flush=True)

    def summary(v):
        return {"per_seed": [round(x, 4) for x in v],
                "mean": round(float(np.mean(v)), 4),
                "std": round(float(np.std(v)), 4)}

    rec = {"dataset": "person_activity(synthetic fallback)",
           "enc": "mtan_rnn", "latent_dim": 32, "rec_hidden": 32,
           "k_iwae": 5, "n": ACTIVITY["n"], "epochs": ACTIVITY_R5["epochs"],
           "warmup_epochs": ACTIVITY_R5["warmup"],
           "seeds": list(ACTIVITY_R5["seeds"]),
           "test_accuracy_pertp": summary(tests),
           "val_accuracy_pertp": summary(vals), "floor": floor,
           "ok": bool(min(tests) >= floor),
           "wall_time_min": round((time.time() - t0) / 60.0, 2),
           "card": smi}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1), flush=True)
    return 0 if rec["ok"] else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import snsde_torch  # noqa: F401  (fails outside the repository)

    smi = card()
    build()
    print("kernels vs plain versions:", flush=True)
    err = {"em": compare(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"],
                         MAIN["H"], MAIN["layers"])}
    for name in ("neurallsde", "neuralgsde"):
        compare(name, 128, MAIN["L"], MAIN["C"], MAIN["H"], MAIN["layers"])
    err["srk"] = compare(SRK["model"], SRK["B"], SRK["L"], SRK["C"],
                         SRK["H"], SRK["layers"], srk=True)
    for name in ("neurallsde", "neuralgsde"):
        compare(name, 128, SRK["L"], SRK["C"], SRK["H"], SRK["layers"],
                srk=True)
    compare(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"],
            MAIN["layers"], srk=True)
    sde_plans("em", [(MAIN["B"], MAIN["H"], MAIN["layers"] - 1)])
    sde_plans("srk", [(SRK["B"], SRK["H"], SRK["layers"] - 1)])
    for key, sh in (("em", MAIN), ("srk", SRK)):
        err[f"{key}_wgrad"] = compare_sde_wgrad(key, sh["model"], sh["B"],
                                                sh["L"], sh["C"], sh["H"],
                                                sh["layers"])
        for H in WIDE_H:
            compare_sde_wgrad(key, sh["model"], WIDE["B"], WIDE["L"],
                              sh["C"], H, 2)
    sweep_shape = dict(B=SWEEP["B"], L=SWEEP["L"], C=SWEEP["D"] + 1,
                       H=SWEEP["H"], n_inner=0)
    err["cde"] = compare_cde(**sweep_shape)
    for shape in CDE.values():
        compare_cde(**shape)
    sh = CDE["uea_rk4"]
    for method in ("euler", "midpoint", "heun"):
        compare_cde(128, sh["L"], sh["C"], sh["H"], 1, method)
    compare_cde(128, sh["L"], sh["C"], sh["H"], 0, field="single")
    for n_inner in (0, 2):
        compare_cde(128, sh["L"], sh["C"], sh["H"], n_inner)
    compare_wide()
    print("the SDE pairs' new modes vs their plain versions:", flush=True)
    err.update(compare_modes())
    print("the new paths' configurations at their own shapes:", flush=True)
    err.update(compare_path_modes())
    print("the EM pair at the speech shape, and the latent pair:", flush=True)
    sp = SPEECH
    err["em_speech"] = compare(sp["model"], sp["B"], sp["L"], sp["C"],
                               sp["H"], sp["layers"])
    err["em_latent"] = tuple(max(a, b) for a, b in zip(
        compare_latent(**LATENT), compare_latent(**LATENT_WIDE)))
    err["em_latent_wgrad"] = max(compare_latent_wgrad(**LATENT),
                                 compare_latent_wgrad(**LATENT_WIDE))
    print("the member axis (K members a launch) against the solo launches "
          "and the plain versions:", flush=True)
    for case in MEMBER_CASES:
        e = compare_members(*case)
        key = f"{case[0]}_packed"
        err[key] = tuple(max(a, b) for a, b in zip(err.get(key, (0, 0)), e))
    whole_model_check()
    rs = RNN_SWEEP
    err["gru"] = compare_rnn("gru", **rs)
    compare_rnn("gru", **rs, dec=True)
    err["lstm"] = compare_rnn("lstm", **rs)
    compare_rnn("lstm", rs["B"], rs["L"], rs["C"], rs["H"] // 2)
    for shape in RNN_BENCH.values():
        compare_rnn(**shape)
    for kind in ("gru", "lstm"):
        compare_rnn(kind, 16, 20, 6, 512, dec=kind == "gru")
        compare_rnn(kind, 100, 30, 6, 32, dec=kind == "gru")
    for H in LSTM_PLAN_H:
        compare_rnn("lstm", 1024, 72, 6, H)
    for H in GRU_PLAN_H[:-1]:
        for dec in (False, True):
            if dec or H != 128:          # H=128 without decay: a bench shape
                compare_rnn("gru", 1024, 72, 6, H, dec=dec)
    lstm_plans()
    gru_plans()
    for reverse in (False, True):
        for dec in (False, True):
            compare_gru_scan(rs["B"], rs["L"], rs["C"], rs["H"], reverse, dec)
            compare_gru_scan(256, 24, 6, 128, reverse, dec)
    err["gru_wgrad"] = compare_wgrad("gru", rs["B"], rs["L"], rs["C"],
                                     rs["H"])
    compare_wgrad("gru", rs["B"], rs["L"], rs["C"], rs["H"], dec=True)
    compare_wgrad("gru", 1024, 72, 6, 128, dec=True)
    err["lstm_wgrad"] = compare_wgrad("lstm", rs["B"], rs["L"], rs["C"],
                                      rs["H"])
    compare_wgrad("lstm", 1024, 72, 6, 128)
    print("the ODE-RNN hybrids' and the time-aware LSTMs' instances vs "
          "their plain versions:", flush=True)
    err.update(compare_rnn_modes())
    for shape in RNN_BENCH.values():
        compare_rnn_cudnn(**shape)
    print("phase 10: the GRU-ODE instances vs their plain versions, the CDE "
          "pair's member axis and the packed latent solve vs the solo "
          "launches:", flush=True)
    err["cde_gruode"] = compare_gruode()
    err["cde_packed"] = tuple(max(a, b) for a, b in zip(
        compare_cde_members("final_tanh"), compare_cde_members("gruode")))
    compare_latent_members()
    print("phase 11: the CDE pair on the linear streams vs its plain "
          "versions, and the solvers without a kernel on the card vs the "
          "CPU:", flush=True)
    err["cde_paths"] = compare_linear_cde()
    compare_solvers_card_vs_cpu()
    print("phase 12: the CDE pair on NeuralRDE's and ANCDE's streams and "
          "the GRU pair on mTAN's BiGRU vs their plain versions:",
          flush=True)
    err["cde_paths"] = tuple(max(a, b) for a, b in zip(err["cde_paths"],
                                                        compare_zoo_cde()))
    check_ancde_gate_grad()
    err["gru_paths"] = compare_mtan_bigru()
    print("phase 13: the EM pair at the interpolation encoder's shape and "
          "the GRU pair at the VAE decoders' and the activity encoder's "
          "BiGRU shapes vs their plain versions, the scatter on the card vs "
          "the CPU:", flush=True)
    err["em_paths"] = tuple(max(a, b) for a, b in zip(err["em_paths"],
                                                      compare_interp_em()))
    err["gru_paths"] = tuple(max(a, b) for a, b in zip(err["gru_paths"],
                                                       compare_interp_gru()))
    check_interp_scatter()
    with tempfile.TemporaryDirectory() as out_dir:
        launches = {"em": main_path(), "srk": mujoco_path(),
                    "cde": sweep_path(out_dir)}
        sde_sweep_path(out_dir)
        packed = packed_sweep_path(out_dir)
        launches["srk_packed"] = packed["neuralsde_4_17"]
        # the packed CDE kernels' launches: both packed CDE cells'
        launches["cde_packed"] = {k: packed["neuralcde"][k]
                                  + packed["gru-ode"][k]
                                  for k in ("cde_packed_fwd",
                                            "cde_packed_bwd")}
        launches["cde_gru"] = gruode_sweep_path(out_dir)
        launches.update(rnn_sweep_path(out_dir))
        launches["em_latent"] = latent_sweep_path(out_dir)
        launches["lstm_time"] = rnn_sweep_path(out_dir, TIME_MODELS)["lstm"]
        baseline_sweep_path(out_dir)
        launches["cde_linear"] = linear_sweep_path(out_dir)
        launches["zoo"] = zoo_sweep_path(out_dir)
        launches["interp"] = interp_path(out_dir)
    launches["activity"] = activity_path()
    for method in SDE_METHODS:
        sde_method_mujoco_path(method)
    launches["em_speech"] = speech_path()
    launches["em_speech_packed"] = speech_ensemble_path()
    launches["em_packed"] = sepsis_ensemble_path()
    wide_sepsis_path()
    naive_sepsis_path()
    spline_times()
    ms, bounds = {}, {}
    for key, shape, srk in (("em", MAIN, False), ("srk", SRK, True)):
        ms[key], bounds[key] = kernel_times(shape, srk=srk)
    ms["cde"], bounds["cde"] = cde_kernel_times(sweep_shape)
    for name, shape in CDE.items():
        for k, v in cde_kernel_times(shape)[0].items():
            ms["cde"][f"{name} {k}"] = v
    ms["em"].update(step_times("sepsis (euler)", sepsis_step_fns()))
    ms["srk"].update(step_times("mujoco (srk)", mujoco_step_fns()))
    ms["cde"].update(step_times("uea_rk4 neuralcde (rk4)", cde_step_fns(),
                                eager_reps=3))
    for kind in ("gru", "lstm"):
        ms[kind], bounds[kind] = rnn_kernel_times(kind, **RNN_SWEEP)
        for name, shape in RNN_BENCH.items():
            if shape["kind"] == kind:
                for k, v in rnn_kernel_times(**shape)[0].items():
                    ms[kind][f"{name} {k}"] = v
        ms[kind].update(step_times(f"{kind} classifier", rnn_step_fns(kind)))
    ms["wide"] = wide_kernel_times()
    ms["modes"], _ = mode_kernel_times()
    packed_ms, packed_bounds = packed_kernel_times()
    for key in ("em", "srk"):
        ms[f"{key}_packed"] = packed_ms[key]
        bounds[f"{key}_packed"] = packed_bounds[key]
    ms["ensemble"] = ensemble_step_times()
    ms["em_speech"], bounds["em_speech"] = kernel_times(SPEECH)
    ms["em_speech"].update(step_times("speech (euler)", speech_step_fns(),
                                      eager_reps=3))
    ms["em_latent"], bounds["em_latent"] = latent_kernel_times()
    mode_ms, mode_bounds = rnn_modes_times()
    ms.update(mode_ms)
    bounds.update(mode_bounds)
    ms["lstm_tlstm"].update(step_times("tlstm sweep-cell classifier",
                                       time_lstm_step_fns("tlstm"),
                                       eager_reps=3))
    ms["cde_gruode"], bounds["cde_gruode"] = gruode_kernel_times()
    packed_ms, packed_bounds = cde_packed_kernel_times()
    ms["cde_packed"], bounds["cde_packed"] = (packed_ms["final_tanh"],
                                              packed_bounds["final_tanh"])
    ms["cde_packed_gruode"] = packed_ms["gruode"]
    bounds["cde_packed_gruode"] = packed_bounds["gruode"]
    ms["cde_gruode"].update(step_times("gru-ode sweep-cell classifier",
                                       gruode_step_fns(), eager_reps=3))
    linear_ms, linear_bounds = cde_linear_kernel_times()
    ms["cde_linear"] = step_times("neuralcde-l sweep-cell classifier",
                                  sweep_step_fns(), eager_reps=3)
    ms["solvers"] = {"mujoco milstein train_step": sde_method_step_time()}
    for name, (solve_ms, _, trial_ms) in adaptive_solver_times().items():
        ms["solvers"][f"{name} solve"] = solve_ms
        ms["solvers"][f"{name} trial_step"] = trial_ms
    for name in LINEAR_MODELS:
        for k, v in linear_ms[name].items():
            ms["cde_linear"][f"{name} {k}"] = v
    zoo_ms, zoo_bounds = zoo_cde_times()
    mtan_ms, mtan_bounds = mtan_gru_times()
    ms["zoo"] = {}
    for name in ZOO_STEPS:
        for k, v in step_times(f"{name} sweep-cell classifier",
                               sweep_step_fns(name), eager_reps=3).items():
            ms["zoo"][f"{name} {k}"] = v
    interp_ms, interp_bounds = interp_em_times()
    igru_times = interp_gru_times()
    ms["interp"] = {}
    for label, steps in (("interpolation rnn3", interp_step_fns("rnn3")),
                         ("interpolation mtan_rnn",
                          interp_step_fns("mtan_rnn")),
                         ("activity", activity_step_fns())):
        for k, v in step_times(label, steps, eager_reps=3).items():
            ms["interp"][f"{label} {k}"] = v
    for key in ms:
        for k, v in ms[key].items():
            print(f"time {key} {k}: {v:.4f} ms  [{smi}]")
    kernels = []
    for key, pre, lines, src in (
            ("em", "fused_em", (688, 888), "fused_em"),
            ("srk", "fused_srk", (295, 527), "fused_srk"),
            ("cde", "fused_cde", (364, 505), "fused_cde"),
            ("gru", "fused_gru", (312, 396), "fused_rnn"),
            ("lstm", "fused_lstm", (837, 934), "fused_rnn")):
        for part, line in zip(("fwd", "bwd"), lines):
            # a recurrent or SDE backward's "ms" is its two kernels'
            # times summed: the recurrence and the weight gradient
            # (backward_times, sde_backward_times)
            kernels.append({
                "name": f"{pre}_{'forward' if part == 'fwd' else 'backward'}",
                "route": "cuda",
                "source": f"snsde_torch/csrc/{src}.cu",
                "replaces": f"snsde/kernels/{src}.py:{line}",
                "launches": launches[key][f"{key}_{part}"],
                # the largest error of the main path's shape and, for the
                # SDE pairs, of the new modes' and new paths' comparisons
                "max_abs_err": max(err[k][0 if part == "fwd" else 1]
                                   for k in (key, f"{key}_modes",
                                             f"{key}_paths")
                                   if k in err),
                "ms": ms[key][part], "plain_ms": ms[key][f"{part}_plain"],
                "bound_ms": bounds[key][part][0],
                "bound_by": bounds[key][part][1],
                # cuDNN at the same shape (torch.nn.GRU/LSTM); no single
                # PyTorch call computes a fused SDE or CDE solve
                "library_ms": ms[key].get(f"lib_{part}"),
                **({"modes": SDE_MODES} if key in ("em", "srk") else {}),
                **(linear_entry(part, launches["cde_linear"], linear_ms,
                                linear_bounds) if key == "cde" else {}),
                **(zoo_entry(part, launches["zoo"], zoo_ms, zoo_bounds)
                   if key == "cde" else {}),
                **(mtan_entry(part, launches["zoo"], mtan_ms, mtan_bounds)
                   if key == "gru" else {}),
                **(interp_entry(part, launches["interp"], interp_ms,
                                interp_bounds) if key == "em" else {}),
                **(interp_gru_entry(part, launches, igru_times)
                   if key == "gru" else {}),
            })
    for key, line, src in (("em", "fused_em.py:888", "fused_em"),
                           ("srk", "fused_srk.py:527", "fused_srk"),
                           ("gru", "fused_rnn.py:396", "fused_rnn"),
                           ("lstm", "fused_rnn.py:934", "fused_rnn")):
        kernels.append({
            "name": f"fused_{key}_weight_grads", "route": "cuda",
            "source": f"snsde_torch/csrc/{src}.cu",
            "replaces": f"snsde/kernels/{line}",
            "launches": launches[key][f"{key}_wgrad"],
            "max_abs_err": max(err[k] for k in (f"{key}_wgrad",
                                                f"{key}_modes_wgrad",
                                                f"{key}_paths_wgrad")
                               if k in err),
            "ms": ms[key]["bwd_wgrad"], "plain_ms": ms[key]["wgrad_plain"],
            "bound_ms": bounds[key]["wgrad"][0],
            "bound_by": bounds[key]["wgrad"][1],
            # torch.matmul of the weight products alone (the bias and
            # per-step sums not included): dW_hh's; the SDE pairs' NI + 2
            "library_ms": ms[key]["wgrad_lib"],
            **({"modes": SDE_MODES} if key in ("em", "srk") else {})})
    for key, K, shape in (("em", MEMBER_CASES[0][7], "sepsis"),
                          ("srk", MEMBER_CASES[2][7], "sweep")):
        src = f"fused_{key}"
        lines = (688, 888) if key == "em" else (295, 527)
        for part, line in zip(("fwd", "bwd"), lines):
            kernels.append({
                "name": (f"fused_{key}_"
                         f"{'forward' if part == 'fwd' else 'backward'}"
                         f"_packed"),
                "route": "cuda", "source": f"snsde_torch/csrc/{src}.cu",
                "replaces": f"snsde/kernels/{src}.py:{line}",
                # the main path's: the sepsis ensemble (EM), the packed
                # sweep cell (SRK); a backward is a recurrence and a
                # weight-gradient launch
                "launches": launches[f"{key}_packed"][f"{key}_packed_{part}"],
                "max_abs_err": err[f"{key}_packed"][0 if part == "fwd"
                                                    else 1],
                "ms": ms[f"{key}_packed"][part],
                "plain_ms": ms[f"{key}_packed"][f"{part}_plain"],
                "bound_ms": bounds[f"{key}_packed"][part][0],
                "bound_by": bounds[f"{key}_packed"][part][1],
                "library_ms": None, "members": K, "shape": shape,
                "solo_launches_ms": ms[f"{key}_packed"][f"{part}_solo_k"]})
    # the EM pair at the speech shape (its launches the speech path's), and
    # the latent instances at the sweep's shape (their launches the latent
    # sweep runs'; the weight-gradient kernel is the one the other modes
    # run, on the latent recurrence's streams)
    for key, shape, lk, modes in (("em_speech", "speech", "em", SDE_MODES),
                                  ("em_latent", "sweep", "em_latent",
                                   ["latent"])):
        for part, line in (("fwd", 688), ("bwd", 888)):
            kernels.append({
                "name": (f"fused_em_"
                         f"{'forward' if part == 'fwd' else 'backward'}"
                         f"_{key[3:]}"),
                "route": "cuda", "source": "snsde_torch/csrc/fused_em.cu",
                "replaces": f"snsde/kernels/fused_em.py:{line}",
                "launches": launches[key][f"{lk}_{part}"],
                "max_abs_err": err[key][0 if part == "fwd" else 1],
                "ms": ms[key][part], "plain_ms": ms[key][f"{part}_plain"],
                "bound_ms": bounds[key][part][0],
                "bound_by": bounds[key][part][1], "library_ms": None,
                "shape": shape, "modes": modes})
    kernels.append({
        "name": "fused_em_weight_grads_latent", "route": "cuda",
        "source": "snsde_torch/csrc/fused_em.cu",
        "replaces": "snsde/kernels/fused_em.py:888",
        "launches": launches["em_latent"]["em_wgrad"],
        "max_abs_err": err["em_latent_wgrad"],
        "ms": ms["em_latent"]["bwd_wgrad"],
        "plain_ms": ms["em_latent"]["wgrad_plain"],
        "bound_ms": bounds["em_latent"]["wgrad"][0],
        "bound_by": bounds["em_latent"]["wgrad"][1],
        "library_ms": ms["em_latent"]["wgrad_lib"], "shape": "sweep",
        "modes": ["latent"]})
    # the hybrids' instances at the sweep's shape (their launches the
    # sweep runs'; the H=256 times beside), and the evolve's weight
    # gradient on each pair's streams (one product kernel over its layers'
    # streams; its launches those of the pair's names' runs)
    for kind, mode, sfx in RNN_MODES:
        key = f"{kind}_{sfx}"
        lines = (312, 396) if kind == "gru" else (837, 934)
        # the time-aware modes' launches: phase 9's sweep runs
        runs = launches["lstm_time" if sfx in TIME_MODES else kind]
        for part, line in zip(("fwd", "bwd"), lines):
            kernels.append({
                "name": (f"fused_{kind}_"
                         f"{'forward' if part == 'fwd' else 'backward'}"
                         f"_{sfx}"),
                "route": "cuda", "source": "snsde_torch/csrc/fused_rnn.cu",
                "replaces": f"snsde/kernels/fused_rnn.py:{line}",
                "launches": runs[f"{key}_{part}"],
                "max_abs_err": err[key][0 if part == "fwd" else 1],
                "ms": ms[key][part], "plain_ms": ms[key][f"{part}_plain"],
                "bound_ms": bounds[key][part][0],
                "bound_by": bounds[key][part][1], "library_ms": None,
                "shape": "sweep", "mode": mode,
                "ms_h256": ms[key][f"{part} h256"],
                "plain_ms_h256": ms[key][f"{part}_plain h256"],
                "bound_ms_h256": bounds[key][f"{part} h256"][0]})
        if sfx == "ode":
            kernels.append({
                "name": f"fused_mlp_weight_grads_{kind}", "route": "cuda",
                "source": "snsde_torch/csrc/fused_rnn.cu",
                "replaces": f"snsde/kernels/fused_rnn.py:{lines[1]}",
                "launches": launches[kind]["mlp_wgrad"],
                "max_abs_err": err[key][1],
                "ms": ms[key]["mlpgrad"],
                "plain_ms": ms[key]["mlpgrad_plain"],
                "bound_ms": bounds[key]["mlpgrad"][0],
                "bound_by": bounds[key]["mlpgrad"][1],
                "library_ms": ms[key]["mlpgrad_lib"],
                "shape": "sweep", "mode": mode,
                "ms_h256": ms[key]["mlpgrad h256"],
                "plain_ms_h256": ms[key]["mlpgrad_plain h256"],
                "library_ms_h256": ms[key]["mlpgrad_lib h256"],
                "bound_ms_h256": bounds[key]["mlpgrad h256"][0]})
        if sfx == "tlstm":
            # TLSTM's W_d gradient: the weight-gradient kernel on c and dzd
            kernels.append({
                "name": "fused_lstm_weight_grads_wd", "route": "cuda",
                "source": "snsde_torch/csrc/fused_rnn.cu",
                "replaces": f"snsde/kernels/fused_rnn.py:{lines[1]}",
                "launches": runs["lstm_wd_wgrad"],
                "max_abs_err": err[key][2],
                "ms": ms[key]["wdgrad"],
                "plain_ms": ms[key]["wdgrad_plain"],
                "bound_ms": bounds[key]["wdgrad"][0],
                "bound_by": bounds[key]["wdgrad"][1],
                "library_ms": ms[key]["wdgrad_lib"],
                "shape": "sweep", "mode": mode,
                "ms_h256": ms[key]["wdgrad h256"],
                "plain_ms_h256": ms[key]["wdgrad_plain h256"],
                "library_ms_h256": ms[key]["wdgrad_lib h256"],
                "bound_ms_h256": bounds[key]["wdgrad h256"][0]})
    # the CDE pair's GRU-ODE instances at the sweep cell (their launches
    # the gru-ode sweep run's; the gruode_rk4 bench shape's times beside,
    # and FinalTanh's at both shapes: the sweep cell's field, and uea_rk4's
    # with one inner layer), and its member axis (K = CDE_K FinalTanh
    # members at the sweep cell; its launches both packed CDE cells', the
    # GRU-ODE members' times beside)
    for part, line in (("fwd", 364), ("bwd", 505)):
        name = "forward" if part == "fwd" else "backward"
        i = 0 if part == "fwd" else 1
        kernels.append({
            "name": f"fused_cde_{name}_gruode", "route": "cuda",
            "source": "snsde_torch/csrc/fused_cde.cu",
            "replaces": f"snsde/kernels/fused_cde.py:{line}",
            "launches": launches["cde_gru"][f"cde_gru_{part}"],
            "max_abs_err": err["cde_gruode"][i],
            "ms": ms["cde_gruode"][part],
            "plain_ms": ms["cde_gruode"][f"{part}_plain"],
            "bound_ms": bounds["cde_gruode"][part][0],
            "bound_by": bounds["cde_gruode"][part][1], "library_ms": None,
            "shape": "sweep", "field": "gruode",
            "ms_gruode_rk4": ms["cde_gruode"][f"{part} gruode_rk4"],
            "plain_ms_gruode_rk4":
                ms["cde_gruode"][f"{part}_plain gruode_rk4"],
            "bound_ms_gruode_rk4":
                bounds["cde_gruode"][f"{part} gruode_rk4"][0],
            "finaltanh_ms": ms["cde"][part],
            "finaltanh_ms_uea_rk4": ms["cde"][f"uea_rk4 {part}"]})
        kernels.append({
            "name": f"fused_cde_{name}_packed", "route": "cuda",
            "source": "snsde_torch/csrc/fused_cde.cu",
            "replaces": f"snsde/kernels/fused_cde.py:{line}",
            "launches": launches["cde_packed"][f"cde_packed_{part}"],
            "max_abs_err": err["cde_packed"][i],
            "ms": ms["cde_packed"][part],
            "plain_ms": ms["cde_packed"][f"{part}_plain"],
            "bound_ms": bounds["cde_packed"][part][0],
            "bound_by": bounds["cde_packed"][part][1], "library_ms": None,
            "members": CDE_K, "shape": "sweep", "field": "final_tanh",
            "solo_launches_ms": ms["cde_packed"][f"{part}_solo_k"],
            "ms_gruode": ms["cde_packed_gruode"][part],
            "solo_launches_ms_gruode":
                ms["cde_packed_gruode"][f"{part}_solo_k"],
            "plain_ms_gruode": ms["cde_packed_gruode"][f"{part}_plain"],
            "bound_ms_gruode": bounds["cde_packed_gruode"][part][0]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-steps"]:
        sys.exit(ab_steps(sys.argv[2], *map(int, sys.argv[3:5])))
    if sys.argv[1:2] in (["--ab-lstm"], ["--ab-gru"]):
        sys.exit(ab_rnn(sys.argv[1][5:], sys.argv[2],
                        *map(int, sys.argv[3:5])))
    if sys.argv[1:2] == ["--ab-kernels"]:
        sys.exit(ab_kernels(sys.argv[2], *map(int, sys.argv[3:5])))
    if sys.argv[1:2] == ["--ab-cde"]:
        sys.exit(ab_cde(sys.argv[2], *map(int, sys.argv[3:5])))
    if sys.argv[1:2] == ["--phase-split"]:
        sys.exit(phase_split(sys.argv[2:]))
    if sys.argv[1:2] == ["--sweep-cd"]:
        sys.exit(sweep_cd(sys.argv[2], *map(int, sys.argv[3:6])))
    if sys.argv[1:2] == ["--sepsis-r5"]:
        sys.exit(sepsis_r5(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--speech-r5"]:
        sys.exit(speech_r5(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--interp-flagship"]:
        sys.exit(interp_flagship(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--activity-r5"]:
        sys.exit(activity_r5(*sys.argv[2:3]))
    sys.exit(main())
