#!/usr/bin/env python3
"""Smoke run of bcm3_tpu_torch on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: the CUDA kernels (B1 with its reverse mode B1T, B2, and B2J,
   the transit solve with its Jacobian) compiled by nvcc from
   bcm3_tpu_torch/csrc;
3. each kernel against its plain PyTorch version at the slice's shapes, on
   inputs made by the slice's own likelihood from prior draws, with
   CUDA-event timings of both and each kernel's bound (the least time the
   card could take for the same work); for B2 also the per-lane trip
   counts of kernel and plain version (asserted equal), their
   distribution, the warp efficiency and the trips the early exit saves;
   B2J (the gradient mode's transit solve with its Jacobian in the lane
   rates) on `one_transit` at the NUTS width (2,048 draws x 16 patients,
   float32) and on both transit models at 64 draws in float64: `ok`, the
   trip counts, the central amounts and the Jacobian (limits B2J_*), the
   kernel's time, the wrapper's host time a call, the bound;
3b. `kernels_one_patient`: B1 and B2 at one patient (P = 1), on the inputs
   the single-patient likelihood (`pharmacokinetic_trajectory`) makes
   from prior draws at the slices' widths, bit for bit against their
   plain versions;
4. the slice, `one`: SamplerPT, 8 chains x 8192 ensembles, PopPK
   one-compartment over the bench trial (16 patients x 24 timepoints);
5. the slice, `one_transit`: 8 chains x 4096 ensembles;
   each slice runs once cold (its outputs checked), then twice more warm:
   the wall per iteration of the iterations alone, and under
   torch.profiler the device's busy time per iteration and its largest
   kernels;
6. the adapted slice, bench.py's `bench_adapted` protocol on the `one`
   configuration with proposal adaptation on (100 samples, the batched GMM
   EM on the card): a sampler's run() crosses one boundary, after 50
   samples (bench_adapted's two, at 33 and 66, and the protocol's cold
   sampler before it are cut for time), and one more run() of it, with the adapted proposals
   and no boundary, gives the wall, the device profile and ESS/s; each
   boundary's seconds are split into the history gather, the EM fits (and
   the eigendecompositions within them) and the proposal build;
7. the clustered slice, `slice_one_clustered`: the same protocol at half
   its depth (50 samples, boundaries after 16 and 32) with
   proposal_type "clustered_covariance" (one spectral clustering of the
   pooled T=1 history per boundary, shared by every chain; each mutate
   assigns the current and the proposed positions to clusters): each
   boundary's parts (T=1 pull, spectral fit, labelling, blocking, history
   gather, covariance fits, build) and cluster sizes, wall and device busy
   per adapted iteration, the card's ms per `assign_batch` call of the
   whole population, T=1 acceptance and ESS/s;
8. `assign_card_vs_cpu`: the clustered run's assigner labels the whole
   population (`assign_batch`) and every 8th row of the pooled T=1 history
   (`assign_history`) on the card and on the CPU, float64; rows may be
   labelled apart only where the CPU's top two centroid scores are within
   ASSIGN_MARGIN of each other, and on at most ASSIGN_SHARE of the rows;
9. `slice_one_autoblock`: the protocol again with "clustered_autoblock"
   blocking and clustered proposals, at 8 x 1024 chains and 30 samples
   (adaptations after 10 and 20), without the protocol's cold sampler: it
   starts with one block per variable and re-blocks at each boundary; the
   block sizes after each boundary;
10. `cli_one`, the port's CLI at bench width through its in-memory cores
   (`bcm3_tpu_torch.cli`; this machine has no h5py for the CLI's files): a
   config.txt parsed by the CLI's parser, the sampler built by its factory
   over `one` with global-covariance proposals (8 x 8192 chains, 40
   samples, boundaries after 10 and 20); resume identity (an uninterrupted
   run U with the console progress indicator, a run A of the first 10
   samples with a checkpoint, a run B resumed from it to 40: A + B equal U
   bit for bit), the checkpoint's bytes and the seconds of its saves and
   restore; the predict core on U's stored second half (B1) and on 32,768
   `one_transit` prior draws (B2), against U's stored values and the CPU;
   the importance sampler in batches of 65,536 draws; the bcmopt core at
   8 x 64 chains with one variable fixed;
10b. `sharded_one`: `one` at the slice's width and depth with global-
   covariance proposals and one boundary after 10 samples, unsharded, then
   sharded (`shard_over_devices`) in a one-rank NCCL group in this process,
   then unsharded again (a warm wall): bit for bit (samples, log
   densities, acceptance counters, the proposals after the boundary); the
   wall per iteration of each run and the boundary's gather seconds; the
   entry points, `bcm3_tpu_torch.entry.entry()`'s step on the card and
   `dryrun_multichip(1)` (a spawned NCCL rank);
10c. `sharded_two_process`: two processes share the card over gloo
   (`parallel.launch.spawn`): (a) `sharded_one`'s configuration at 4,096
   ensembles a rank (whole ladders, each rank emits its own), merged and
   held to sharded_one's unsharded run; (b) the banana fixture at 6 chains
   x 3 ensembles (its second ladder across the ranks, the exchange point
   to point between the processes), held to the one-process card run; bit
   for bit; each rank's backend, device and B1 launches;
11. the batched EM on the card (float64) against the same code on the CPU,
   on EM_HISTORIES histories of 2000 x 40 rows of the adapted run's T=1
   samples, fit by fit (see phase_em for what may differ and why), and
   torch.linalg.eigh on one EM step's largest batch under each CUDA
   linear-algebra backend and on the CPU;
12. the port on the card (float32, kernels) against the port on the CPU
   (float64 tables, plain versions) for 256 prior draws of each model;
13. `banana`, the analytic banana target of tests/fixtures/examples at
   bench.py bench_banana's width (6 chains x 8192 ensembles; 400 samples
   thinned by 5, the bench's 800 cut, one GMM adaptation after 200,
   float32): the cold run's
   boundary; its T=1 rows and acceptance before the boundary against the
   port's run on the CPU within MCSE_LIMIT standard errors; the distance
   of the rows after it, and of a second run's second half, from the
   quadrature moments over the prior box (logged: after a mixture
   adaptation the sampler misses them, as the JAX package's does,
   ROADMAP C); evals/s and ESS/s of the second run as bench.py computes
   them;
14. `multimodal_gaussians` with global covariance proposals (4 chains x
   1024 ensembles, 1000 samples thinned by 3 (the JAX test's 4000, cut),
   one adaptation after 250):
   the T=1 share with x1 > 0 against the quadrature mass;
15. `poppk_models`: `two` and `one_biphasic_uptake` at `one`'s width and
   depth (cold, warm and profiled runs), `two_transit` at one_transit's
   width in one evaluation (its profile is cut for the gradient phases'
   time), each against the port on the CPU on 256 prior draws
   (two_transit on TWO_TRANSIT_ORACLE_DRAWS);
16. `nuts_one`: bench.py bench_nuts's NUTS on `one` (2,048 chains, max tree
   depth 7, target acceptance 0.9, seed 5, float32; warmup and samples
   cut): every leaf one gradient evaluation of all chains through B1 and
   its reverse mode B1T; ESS/s by bench_nuts's formula, divergence rate,
   mean tree depth, step size, gradient evaluations per second, host
   reads per transition, and the wall, device busy time, launches per
   leaf and B1 + B1T's share of a few profiled transitions;
17. `hmc_one`: HMC on the same target, 2,048 chains, 16 leapfrog steps;
18. `smc_one`: SMC on the same target with 65,536 particles (the PT
   headline's width): stages, betas, log evidence;
19. `vi_one`: VI with the JAX package's defaults (32 samples per ELBO),
   in float64;
20. `banana_gradient`: NUTS and HMC on the banana fixture at 8,192 chains
   held to the quadrature oracle within 4 Monte Carlo standard errors;
   SMC at 8,192 particles (16 populations) held to the port's CPU run
   within 4 standard errors, its distance from the oracle logged (its
   reflection on the prior's bounds moves it off, ROADMAP C);
19b. `nuts_one_transit`: bench_nuts's NUTS on `one_transit` (2,048
   chains, target acceptance 0.9, seed 5, float32) at max tree depth 5,
   20 warmup and 10 sampling transitions from prior draws of finite
   density, every leaf one gradient evaluation through B2J: chains moved,
   the gradient finite wherever the density is at the run's end, leaf
   wall, gradient evaluations/s, ESS/s, B2J's launches and device ms a
   leaf;
21. `gradient_card_vs_cpu`: the card's float32 log-posterior and gradient
   in z against the CPU's float64 on 256 prior draws of `one`; the
   transit models' (the gradient mode, B2J) on 64 draws, the card's
   float64 against the CPU's float64 (computed meanwhile in a process of
   its own) and its float32 reported; B1T
   against its plain version, bit for bit (asserted), at the widths its
   paths launch it: NUTS and HMC's (32,768 lanes, float32), the PT
   headline's (1,048,576, float32) and VI's (512, float64), each with its
   device time a launch (a CUDA graph of 50 launches), the wrapper's host
   time a call, bound and roofline share;
22. `pharmaco_population` at bench.py bench_pharmaco's width (524,288 rows
   of its values with jitter 0.03, 16 patients x 24 observations, K = 29,
   n = 2, float32): evals/s over 3 evaluations after a warm-up, the finite
   count, the peak memory, the device's busy share under the profiler and
   the time by stage (parameters, step-matrix expm, recurrence, read-out
   and its expm, scoring); the card's float32 against the CPU's float64
   on 256 rows, and on 4,096 rows for n = 7 (peripheral + metabolite + 3
   transit, small_expm) and n = 9 (7 transit, matrix_exp);
23. `pharmaco_pt`: SamplerPT over that likelihood at `one`'s width and
   depth (prior XML in the work directory, uniform around bench's values);
24. `pk_single_one`: SamplerPT over the single-patient model `one` (the
   bench trial's patient 1) at `one`'s width and depth, through B1; the
   card against the CPU on 256 prior draws for `one` and `two`;
25. `pk_single_one_transit`: one evaluation at one_transit's width through
   B2; the card against the CPU on 64 prior draws, both float32 solves
   from float32 rows, the central compartment at B2's stack tolerance
   (rtol 3e-4, atol 3e-6 x dose) with equal finite sets, except on the
   rows where the CPU's own solve leaves that tolerance under its
   parameters' float32 rounding (at most 1 in 16, logged);
26. `ode_dll`: the ODE template with a harmonic derivative at 8,192 rows
   (float64), the card against the CPU on 64; the C plugin of
   tests/fixtures/plugins built with cc and evaluated at 65,536 rows of
   the card, its host time a row.

27. `incucyte`: incucyte_population at bench.py bench_incucyte's
   configuration (one experiment of 3 concentrations, 20 timepoints x 4
   replicates, D = 32, G = 96, a 16-row delay ring; rows with jitter
   0.002, float32), the batched DDE solve of ode/delay.py with every well
   of every row a lane: evals/s at 3,072 (bench's batch), 65,536 and
   524,288 rows, the finite count, peak memory, idle share, and at the
   widest the time by stage (well setup, solve, interpolation, scoring);
   the card's float32 and float64 against the CPU's float64 on 256 rows;
   the ring solve of 65,536 rows under
   torch.cuda.set_sync_debug_mode("error") (no host read); each of the
   four solvers at G = 256 on 4,096 rows (float32, timed), against the
   CPU's float64 on 64 of them;
28. `incucyte_pt`: SamplerPT over that likelihood at 8 x 8,192 chains,
   20 samples thinned by 5 (a uniform prior around bench's values), as
   the slices run but with no second run: wall (of the one run) and busy
   per iteration, idle share, acceptance;
29. `mitosis`: mitosis_time_estimation over 32 cells x 30 timepoints of
   boxcars from the model's own Sobol construction at 65,536 rows:
   evals/s split into the cost on the card, its copy to the host and the
   native Hungarian matching (native/lap.cpp, built with g++ at first
   use); the native matching against scipy on 1,024 rows; the card
   against the CPU on 256; one PT run of 8 x 8,192 chains, 4 samples
   thinned by 5;
30. `cell_cycle_marker`: the 220-point track at 65,536 rows: evals/s, the
   card against the CPU;
31. `cellpop`: cell_population at bench.py bench_cellpop's configuration
   (tools/bench_cellpop.py's 5-species dividing cell with a stiff kinase
   module and Sobol variability on k_div, built in memory; 512 rows x 128
   cells, 16 initial; adaptive RODAS3 at rtol = atol = 1e-6 through the
   sparse stage solver; population-average data; float32): a first
   evaluation under the profiler (device operations, busy time, host reads
   under the sync debug mode "warn", RODAS3 steps a lane by round, time by
   stage from CUDA events), then 3 timed evaluations (evals/s, idle share,
   peak memory);
32. `cellpop21`: bench_cellpop21's 21-species cascade (20 ODE species) the
   same way with 1 timed evaluation, and one step's stage solver at 65,536
   lanes, sparse against `lu_factor_ex` + `lu_solve`;
33. `cellpop_matched`: bench_cellpop_matched (16 observed cells scored by
   Hungarian-matched time courses), 1 timed evaluation, the evaluation
   split into the simulation and cost on the card, the cost's pinned copy
   and the native matching;
34. `cellpop_pt`: SamplerPT over the registry's cell_population at
   bench_cellpop's configuration, 8 x 64 chains, 3 iterations, and one more
   under the profiler;
35. `cellpop_card_vs_cpu` (after the main path): each of the three on 64
   rows, the card's float64 against the CPU's (computed meanwhile in a
   process of its own), lane by lane the step counts and row by row the
   log-density (1e-10 where every lane took the CPU's step count, the
   solver's rtol otherwise), float32 against the CPU's float64 within ten
   times the CPU's own float32 error; the budget RODAS3 form on the first
   round's 8,192 lanes under the sync debug mode "error" (no host read);
36. `fisa`: bench.py bench_fisa's network (A <-> B, mutually activating,
   under the logistic limit; 10 Sobol starts; built in memory, its data
   through `_data`) at 65,536 rows (bench's batch: 655,360 lanes) and
   524,288 rows of its values with jitter 0.01, float32: evals/s over 3
   evaluations after a warm one, device operations, busy time and idle
   share of one evaluation under the profiler, host reads of one (0),
   peak memory;
37. `fisa_card_vs_cpu`: the bistable network, a feedback network with
   every drug effect, conditions and expression levels, and an
   incucyte-sequential experiment relative to a single-condition one, on
   256 rows each: the card's float64 against the CPU's (1e-10 on every row;
   rows whose kept solve stopped short of its root after the 20 Newton
   steps counted), the card's float32 against the CPU's float64 within ten times
   the CPU's own float32 error on the rows with the same best roots (the
   others counted);
38. `fisa_pt`: SamplerPT over the registry's fISA at bench_fisa's
   configuration, 8 x 8,192 chains, 20 samples thinned by 5: s an
   iteration, evals/s;
39. `rbridge`: bcm3_tpu_torch.rbridge's handles on the card (its default)
   against handles with device="cpu": the banana fixture and the
   bench_fisa network through `_data`; likelihood, prior and the fISA
   accessors to float64 rounding.

The kernels' launch counters are set to 0 just before each slice of the
main path (phases 4-7, 9, 10, 10b, 10c, 13-20, 19b, 22-34 and 36-39) and read
just after it, so the counts show that each slice itself went through the
kernels (`cli_one` through B1 and B2; `sharded_one` through B1, and
`sharded_two_process`'s ranks, whose counts they return and the slice's
count adds; phases 13-15, 20, 22, 23, 26-34 and 36-39
run paths that no kernel serves, and 36-39 must launch none; phases 16, 17
and 19 through B1 and B1T, phases 18 and 24 through B1, phase 19b through
B2J, phase 25 through B2).
Any failed check raises, and the script exits non-zero without printing a
result.

`python3 chip_smoke.py --b1t-timing [TREE]` times B1T alone at those
widths, from this checkout's package or from TREE's (an earlier commit
unpacked with `git archive`), and prints one JSON line;
`python3 chip_smoke.py --b2j-timing [TREE]` does the same for B2J at the
widths of its checks (B2J_CHECKS), with the lanes' trips, the launch plan
and ptxas's registers and spills of B2J's instances. The last line is
{"ok": true, "device": {...}}; the line before it lists the four kernels.
JAX is neither needed nor imported.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

NUM_PATIENTS = 16
NUM_TIMEPOINTS = 24
NUM_CHAINS = 8
ENSEMBLES = {"one": 8192, "one_transit": 4096}
NUM_SAMPLES = {"one": 20, "one_transit": 4}
USE_EVERY_NTH = 5
ORACLE_DRAWS = 256
# slice_one, slice_one_transit, pharmaco_pt and pk_single_one: their
# profiles over this many iterations of a second sampler (cut from their
# runs' 100 and 20: the trace of 100 took ~30 s to process)
PT_PROFILE_ITERATIONS = 10
# pt_emission: `one`'s slice (8 x 8,192 chains, float32) emitting every
# temperature (11.0 MB an emission), PT_EMISSION_SAMPLES emissions, run with
# each emit_chunk_size of PT_EMISSION_CHUNKS (None: two emissions a pull)
PT_EMISSION_SAMPLES = 6
PT_EMISSION_CHUNKS = (0, 1, None)
# bench.py bench_adapted: NUM_SAMPLES 100, BENCH_ADAPT_TIMES 2, seed 2024
ADAPTED_SAMPLES = 100
ADAPT_TIMES = 2
# one history keeps the script, with its clustered slices and the gradient
# samplers, inside its time limit (it fitted 7, then 2)
EM_HISTORIES, EM_ROWS = 1, 2000
# the clustered slice at 30 samples with boundaries after 10 and 20
# (bench_adapted: 100, after 33 and 66; 108 ms an adapted iteration, ROADMAP
# B6), cut from 50 after 16 and 32 for the script's time limit
CLUSTERED = dict(proposal_type="clustered_covariance", num_samples=30,
                 adapt_proposal_samples=10)
# slice_one_autoblock: 8 x 1024 chains, 20 samples, adaptations after 5, 10
# (cut from 30 after 10 and 20)
AUTOBLOCK = dict(
    CLUSTERED, blocking_strategy="clustered_autoblock", num_ensembles=1024, num_samples=20,
    adapt_proposal_samples=5,
)
# card and CPU labels may differ only on rows whose top two centroid scores
# are this close (relative to the top), and on at most this share of rows
ASSIGN_MARGIN, ASSIGN_SHARE = 1e-9, 1e-4
# the CPU labels every 8th pooled history row (all 2.7 M take it 147 s)
ASSIGN_HISTORY_STRIDE = 8
# samples of the profiled runs of the adapted and clustered slices and of
# poppk_models' PT slices (cut from 4, the adapted slice's from 20): their
# iterations launch up to ~900 kernels more each, which the profiler's
# trace pays for
CLUSTERED_PROFILE_SAMPLES = 1
EM_RTOL = 1e-6
# singular-test margins (units of its tolerance) below this are at its edge
EM_EDGE = 1e3
# bench.py ess_stats: per-chain ESS over this many ensembles
ESS_ENSEMBLES = 256

# cli_one: the port's CLI at bench width, `one` with global-covariance
# proposals (the GMM boundaries take 60-77 s each on the card: ROADMAP B5)
CLI_CONFIG = """[sampler]
num_samples=40
use_every_nth=5
rngseed=2024

[ptmhsampler]
num_chains=8
num_ensembles=8192
proposal_type=global_covariance
adapt_proposal_samples=10
adapt_proposal_times=2
emit_fixed_only=true
"""
CLI_INTERRUPT = 10  # run A's samples: the first boundary
CLI_FIXED = "mean_excretion"  # the variable that the bcmopt prior leaves out
CLI_CPU_ROWS = 256
CLI_TRANSIT_ROWS = 32768
# the importance sampler keeps a prior draw only within ln(1e10) of the
# best log-likelihood so far, about 1 in 10^4 draws on `one`: 20,000 kept
# rows would take ~10^5 batches, so the run stops after this many
CLI_IS_ROUNDS = 500

# the analytic targets' prior and likelihood files (the repo's fixtures)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "examples")
# banana: bench.py bench_banana's shape (bench.py:587-620, :683-693), float32
# with 400 samples (the bench's 800, cut for time), the adaptation after 200
BANANA = dict(num_chains=6, num_ensembles=8192, num_samples=400, use_every_nth=5,
              adapt_proposal_samples=200, adapt_proposal_times=1, max_history_size=2000,
              seed=7)
BANANA_BOX = ((-5.0, 5.0), (-5.0, 15.0))  # tests/fixtures/examples/banana/prior.xml
# the port's CPU run that the card's rows before the boundary are held to
BANANA_CPU_ENSEMBLES = 64
# multimodal_gaussians: tests/test_sampler_banana.py:74-95 at 1024 ensembles,
# cut from 4000 samples to 500 (its 12,000 iterations took 95 s on the card,
# 6,000 took 46 s, 3,000 ~20 s), the adaptation after a quarter of them, as
# the test's
MULTIMODAL = dict(num_chains=4, num_ensembles=1024, num_samples=500, use_every_nth=3,
                  proposal_type="global_covariance", adapt_proposal_samples=125,
                  adapt_proposal_times=1, max_history_size=4000,
                  adapt_proposal_max_history_samples=2000, seed=99)
MULTIMODAL_BOX = (-10.0, 10.0)  # tests/fixtures/examples/multimodal_gaussians/prior.xml
# the limit, in standard errors, of the card's runs against the CPU's run and
# against the quadrature oracle; an sd's error comes from groups of this many
# ensembles
MCSE_LIMIT = 4.0
MOMENT_GROUP = 256
# poppk_models: two and the biphasic model at `one`'s width and depth,
# two_transit at one_transit's width in one evaluation: its eager DP5
# launches ~400 kernels per trip, 768 trips per evaluation
# its card-vs-CPU rows: the CPU's eager DP5 took about 155 s for 256 (all
# of 4,096 lanes), so two_transit is compared on this many prior draws
TWO_TRANSIT_ORACLE_DRAWS = 64
# two and one_biphasic_uptake through SamplerPT: emitted samples (cut from
# `one`'s 20)
POPPK_PT_SAMPLES = 10
# the gradient and population samplers on `one` (phases 16-19):
# bench.py bench_nuts's configuration (bench.py:286-358): 2,048 chains, max
# tree depth 7, target acceptance 0.9, seed 5, its 256 warmup and 256
# sampling transitions cut to fit the script's time limit (to 20 + 10 from
# 50 + 30: 20 warmup transitions are the fewest at which Stan's schedule
# works, see NUTS_ONE_TRANSIT)
NUTS_ONE = dict(num_chains=2048, max_tree_depth=7, target_accept=0.9, seed=5)
NUTS_WARMUP, NUTS_SAMPLES = 20, 10
HMC_ONE = dict(num_chains=2048, num_leapfrog_steps=16, seed=5)
HMC_WARMUP, HMC_SAMPLES = 30, 15  # cut from 60 + 30
# SMC at the PT headline's width, 8 x 8,192 chains
SMC_ONE = dict(num_particles=65536, seed=5)
# VI: the JAX package's defaults (bcm3_tpu/sampler/vi.py:31-36), its 2,000
# iterations cut to 500, in float64: in float32 a Monte Carlo row whose
# rate overflows has a NaN gradient, and the ELBO's mean carries it into
# every parameter within a few steps (ROADMAP C)
VI_ONE = dict(num_iterations=500, num_mc_samples=32, learning_rate=0.05, num_samples=1000,
              seed=5)
# transitions timed, then profiled, from where a run ended; NUTS's
# profiled trees are cut at this depth
PROFILED_TRANSITIONS = 2
PROFILED_DEPTH = 3
# nuts_one_transit: bench_nuts's configuration on `one_transit` (2,048
# chains, target acceptance 0.9, seed 5, float32) at max tree depth 5, every
# leaf one gradient evaluation through kernel B2J. Its warmup is 20
# transitions, the fewest at which Stan's schedule (nuts.warmup_windows)
# has no mass window: with fewer the one window ends at the last warmup
# transition, the dual averaging restarts there and the step size is 1
NUTS_ONE_TRANSIT = dict(NUTS_ONE, max_tree_depth=5)
NUTS_TRANSIT_WARMUP, NUTS_TRANSIT_SAMPLES = 20, 10
NUTS_STUCK_SHARE = 0.1
NUTS_START_DRAWS = 4  # prior draws a chain for the start search
# hmc_one_transit: hmc_one's configuration (HMC_ONE: 2,048 chains, 16
# leapfrog steps, float32) on `one_transit`, every leapfrog step one
# gradient evaluation through B2J, its depth cut for time; its starts are
# prior draws, as the JAX package's HMC draws them (bcm3_tpu/sampler/hmc.py
# :169). Both HMC phases profile steps cut to HMC_PROFILED_LEAPFROG leapfrog
# steps (hmc_one's were the run's 16)
HMC_TRANSIT_WARMUP, HMC_TRANSIT_SAMPLES = 20, 10
HMC_PROFILED_LEAPFROG = 4
# vi_two_transit: VI_ONE's configuration (32 samples an ELBO, Adam at
# 0.05, 1,000 draws, float64) on `two_transit`, B2J's float64 instance with
# n = 3, K = 7 at 32 x 16 = 512 lanes a launch; its Adam steps cut for time
VI_TWO_TRANSIT = dict(VI_ONE, num_iterations=150)
# B2J against its plain version (phase kernels): `one_transit` at the NUTS
# width (2,048 draws x 16 patients) in float32, both transit models on 64
# draws x 16 patients in float64. On the lanes that finish in both with the
# same trip count: the central amounts within B2J_VALUE_RTOL of the lane's
# largest, the Jacobian within B2J_JAC_RTOL of the largest entry of its
# lane and rate (the kernel follows the plain version's order of
# operations; a float32 tangent sums ~10^4 rounded terms over a solve). At
# most B2J_TRIP_SHARE of the lanes may take another number of trips (the
# mean of the n + 2 squared errors may round otherwise at n = 3) and
# B2J_OK_SHARE another `ok`
B2J_CHECKS = (("one_transit", NUTS_ONE["num_chains"], "float32"),
              ("one_transit", 64, "float64"), ("two_transit", 64, "float64"))
B2J_VALUE_RTOL = {"float32": 1e-4, "float64": 1e-10}
B2J_JAC_RTOL = {"float32": 1e-3, "float64": 1e-8}
B2J_TRIP_SHARE, B2J_OK_SHARE = 0.01, 0.001
# --b2j-timing: launches timed at each width, after a warm-up
B2J_TIMED = 20
# gradient_card_vs_cpu for the transit models: prior draws, the card's
# float64 against the CPU's float64 (the CPU's side computed meanwhile in a
# process of its own): the finite sets equal, the log-posterior within
# TRANSIT_GRAD_RTOL of itself on every row, the gradient within
# TRANSIT_GRAD_RTOL of the row's largest component on at least GRAD_SHARE
# of the rows (a lane whose step sequence the last bits change moves by up
# to the solver's rtol, 1e-6)
TRANSIT_GRAD_DRAWS = 64
TRANSIT_GRAD_RTOL = 1e-5
# gradient_card_vs_cpu: prior draws, and the card's float32 against the
# CPU's float64: the log-posterior within GRAD_RTOL of itself on every row,
# the gradient within GRAD_RTOL of the row's largest component on at least
# GRAD_SHARE of the rows
GRAD_DRAWS = 256
GRAD_RTOL, GRAD_SHARE = 1e-3, 0.95
# banana_gradient: chains or particles, and the runs' depths
BANANA_GRADIENT = 8192
# (cut from 60 + 40 and 60 + 60)
BANANA_NUTS = dict(num_warmup=40, num_samples=30, max_tree_depth=5, seed=3)
BANANA_HMC = dict(num_warmup=40, num_samples=40, num_leapfrog_steps=16, seed=1)
SMC_REPLICATES = 16
# the pharmacometric and generic likelihoods (phases 22-26):
# pharmaco_population at bench.py bench_pharmaco's width (bench.py:430-472:
# 524,288 rows of its values with _bench_batched_loglik's jitter 0.03, seed
# 0, over synthesize_trial(16, 24, seed=31)), timed over PHARMACO_REPS
# evaluations after a warm-up; the card's float32 against the CPU's float64
# on PHARMACO_CPU_ROWS of them, and for two more configurations on
# PHARMACO_WIDE_ROWS rows, within PHARMACO_RTOL with equal finite sets
PHARMACO_ROWS = 524288
PHARMACO_JITTER = 0.03
PHARMACO_REPS = 3
PHARMACO_CPU_ROWS = 256
PHARMACO_WIDE_ROWS = 4096
PHARMACO_RTOL = 1e-3
PHARMACO_WIDE = {
    # peripheral + metabolite + 3 transit: n = 7, small_expm
    "n7": dict(use_peripheral=True, use_metabolite=True, num_transit=3),
    # 7 transit: n = 9, torch.linalg.matrix_exp
    "n9": dict(num_transit=7),
}
# pk_single: the bench trial's (NUM_PATIENTS x NUM_TIMEPOINTS, seed 42)
# patient "1" at the slices' widths; card against CPU on this many prior
# draws (PK_SINGLE_TRANSIT_ROWS for one_transit, at B2's float32 stack
# tolerance, ROADMAP "Measured limits")
PK_SINGLE_PATIENT = "1"
PK_SINGLE_CPU_ROWS = 256
PK_SINGLE_TRANSIT_ROWS = 64
B2_STACK_RTOL, B2_STACK_ATOL = 3e-4, 3e-6  # the atol times the smallest dose
# ode_dll: the ODE template's rows (float64: its tolerances, 1e-8, are below
# float32's rounding), of which ODE_CPU_ROWS against the CPU to ODE_RTOL;
# the C plugin's rows
ODE_ROWS = 8192
ODE_CPU_ROWS = 64
ODE_RTOL = 1e-8
# dp5_fixed_trips: the ODE template's solve at ODE_ROWS rows with
# `fixed_trips`, tried at these counts until one covers every segment of
# every lane (the count before it, too small for some lanes, is held to the
# while form under the same per-segment budget)
FIXED_TRIPS = (1, 2, 4, 8, 16, 32)
PLUGIN_ROWS = 65536
PLUGIN_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "plugins", "gaussian_plugin.c")
# the cell likelihoods (phases 27-30). incucyte: bench.py bench_incucyte's
# configuration (bench.py:475-506: _incucyte_setup's experiment and values,
# G = 96, ring 16; rows by _bench_batched_loglik, jitter 0.002, seed 0) at
# bench's batch and two wider ones, float32, timed over INCUCYTE_REPS
# evaluations after a warm-up; the card's float32 against the CPU's float64
# on INCUCYTE_CPU_ROWS rows (within INCUCYTE_RTOL, equal finite sets) and
# its float64 at F64_RTOL; each solver at G = INCUCYTE_SOLVER_GRID on
# INCUCYTE_SOLVER_ROWS rows (float32, timed), held to the CPU's float64 on
# INCUCYTE_SOLVER_CPU_ROWS of them within INCUCYTE_RTOL, with at most
# SOLVER_FLIPS finite-set flips (a float32 step controller at rtol 1e-6
# can exhaust a lane's trips where float64 does not: 1 of 4,096 lanes in
# a first run on the card), and at most SOLVER_NONFINITE of the card's
# rows not finite, each of them not finite on the CPU in float64 too (1 of
# 4,096 for the adaptive solver in the runs so far: its 8 substeps an
# interval do not reach the interval's end, in float32 and float64 alike);
# the ring solve of INCUCYTE_SYNC_ROWS rows under the sync debug mode
# "error"
INCUCYTE_GRID, INCUCYTE_RING = 96, 16
INCUCYTE_JITTER = 0.002
INCUCYTE_WIDTHS = (3072, 65536, 524288)
INCUCYTE_REPS = 3
INCUCYTE_CPU_ROWS = 256
INCUCYTE_RTOL = 1e-4
F64_RTOL = 1e-10
INCUCYTE_SOLVER_GRID = 256
INCUCYTE_SOLVER_ROWS = 4096
INCUCYTE_SOLVER_CPU_ROWS = 64
# each solver's float64 on the card against the CPU's (tests/test_torch_gpu.py)
SOLVER_RTOL = {"ring": 1e-10, "fixed": 1e-10, "budget": 1e-8, "adaptive": 1e-8}
SOLVER_FLIPS = {"ring": 0, "fixed": 0, "budget": 1, "adaptive": 1}
SOLVER_NONFINITE = {"ring": 0, "fixed": 0, "budget": 2, "adaptive": 2}
INCUCYTE_SYNC_ROWS = 65536
# the PT runs of phases 28-29 (8 chains x 8192 ensembles, thin 5); the
# incucyte run profiled over INCUCYTE_PT_PROFILE_SAMPLES iterations of a
# second sampler (an iteration launches ~8,000 operations, each one event
# of the host's and one of the device's for the profiler to process)
INCUCYTE_PT_SAMPLES = 5  # cut from 20
INCUCYTE_PT_PROFILE_SAMPLES = 2
MITOSIS_PT_SAMPLES = 1  # cut from 4
# mitosis: 32 cells x 30 timepoints of boxcars from the model's own Sobol
# construction at MITOSIS_TRUTH (tests/test_cellmisc.py:82-103), rows the
# truth with normal jitter MITOSIS_JITTER; the native matching against
# scipy on MITOSIS_SCIPY_ROWS rows (MATCH_RTOL), the card against the CPU
# on MITOSIS_CPU_ROWS (float32 within MITOSIS_RTOL: the float32 rounding of
# 10^x in the noise sd moves the totals by up to ~3e-5 of their size;
# float64 at F64_RTOL)
MITOSIS_CELLS, MITOSIS_TIMEPOINTS = 32, 30
MITOSIS_TRUTH = (3.0, 1.5, 0.2)  # the sds; the variables are their log10
MITOSIS_JITTER = 0.1
MITOSIS_ROWS = 65536
MITOSIS_SCIPY_ROWS = 1024
MITOSIS_CPU_ROWS = 256
MATCH_RTOL = 1e-12
MITOSIS_RTOL = 1e-4
# cell_cycle_marker: the 220-point track of tests/test_cellmisc.py:41-79
# at CCM_ROWS rows of its truth with 10% normal jitter, float32; the card
# against the CPU on CCM_CPU_ROWS (float32 within CCM_RTOL)
CCM_TRUTH = (30.0, 60.0, 40.0, 6.0, 0.8, 0.3, 0.5, 0.4, 1.0, 0.02)
CCM_ROWS = 65536
CCM_CPU_ROWS = 256
CCM_RTOL = 1e-4
# the device of phases 13-15 (a rehearsal on the CPU sets "cpu")
CARD = "cuda"

# sharded_one and sharded_two_process (a): `one` at the slice's width and
# depth with global-covariance proposals and one boundary after 10 samples
# (a GMM boundary costs a minute at this width, ROADMAP B5)
SHARDED_ONE = dict(proposal_type="global_covariance", adapt_proposal_samples=10,
                   adapt_proposal_times=1)
# sharded_two_process (b): the banana fixture at 6 chains x 3 ensembles over
# two ranks, so that the second ladder straddles them
SHARDED_BANANA = dict(num_chains=6, num_ensembles=3, num_samples=40, use_every_nth=2,
                      adapt_proposal_samples=20, adapt_proposal_times=1, seed=9)

# published peaks of one H100 SXM (NVIDIA's data sheet): float32 and
# float64 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12


def bound_ms(ops, nbytes):
    """The least time for the work: operations at the float32 peak or bytes
    at the memory rate, whichever is longer; and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up run."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_model(pk_type, workdir):
    """Prior from its XML (as a user reads it) and the likelihood over the
    bench trial, built in memory: this machine may lack h5py, which the
    pkdata file needs."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.poppk import PopPKLikelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_prior_xml,
    )

    prior_xml = os.path.join(workdir, f"prior_{pk_type}.xml")
    write_poppk_prior_xml(prior_xml, NUM_PATIENTS, pk_type)
    varset = VariableSet.from_xml(prior_xml)
    prior = Prior.from_xml(prior_xml, varset)
    trial, _ = synthesize_trial(
        num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS, seed=42
    )
    pk = PopPKLikelihood(varset, trial, pk_type, "lapatinib")
    return prior, Likelihood("pop_pk_trajectory", pk.log_prob_batched, model=pk)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    from bcm3_tpu_torch.ops import build

    nvcc = subprocess.run(
        [build._nvcc(), "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def ptxas_summary(text):
    """Each kernel instance's registers and spills from ptxas's -v output:
    {entry function: dict(registers, spill_stores, spill_loads, stack)}."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(registers=None, spill_stores=0, spill_loads=0, stack=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and out[name]["registers"] is None:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def phase_build():
    """Build the kernels and print ptxas's registers and spills of every
    instance; returns them (`ptxas_summary`)."""
    from bcm3_tpu_torch.ops import build

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    seconds = time.perf_counter() - t0
    log(f"build: {path.name} in {seconds:.2f} s (nvcc {build.last_build_seconds})")
    summary = ptxas_summary(path.with_suffix(".log").read_text())
    for name, r in summary.items():
        log(f"  ptxas: {name}: {r['registers']} registers, {r['stack']} bytes stack frame, "
            f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")
    return summary


def b2_inputs(prior, lik, gen):
    """B2's inputs as a transit likelihood makes them from prior draws of
    one_transit's width, 4096 x 8 chains: for the population model 16
    patients, so L = 524,288 lanes, S = 38 stops, per-patient (P, S)
    tables; for the single-patient model L = 32,768 and one table."""
    import torch

    from bcm3_tpu_torch.ops.transit_kernels import LANE_PARAMS

    f32 = torch.float32
    pk = lik.model
    xs = prior.sample(gen, (ENSEMBLES["one_transit"] * NUM_CHAINS,), f32)
    tb = pk._tables(xs.device, f32)
    p, _, _ = pk._patient_params(xs)
    B, P = p["ka"].shape

    def flat(x):
        return (x if x.dim() == 2 else x[:, None]).expand(B, P).reshape(-1).contiguous()

    params = {k: flat(p[k]) for k in LANE_PARAMS}
    params["dose0"] = tb["tr_dose0"]
    kw = dict(
        trips=pk.solver_trips, rtol=1e-6, atol=float(pk.trial.dose.min()) * 1e-6,
        min_dt=1e-5,
    )
    return params, tb["tr_grid"], tb["tr_amt"], kw


def b2_trip_statistics(n, n_no_exit, slots, trips):
    """What the trip counts say: n, the trips each lane ran; n_no_exit, the
    trips it would run at this budget without the early exit; slots, the
    trip slots the kernel's warps issued."""
    total = int(n.sum())
    groups = n_no_exit.reshape(-1, 32).amax(dim=1).sum().item()  # L % 32 == 0
    nf = n.double()
    return {
        "mean_trips": nf.mean().item(),
        "median_trips": nf.median().item(),
        "share_at_budget_without_early_exit": (n_no_exit == trips).double().mean().item(),
        "trips_saved_by_early_exit": 1.0 - total / int(n_no_exit.sum()),
        # sum of lane trips over 32 x the slots the warps issued, under the
        # lane-refilling schedule; and the same over static warps of 32
        # consecutive lanes without the early exit (the earlier schedule)
        "warp_efficiency": total / (32 * slots),
        "warp_efficiency_static": int(n_no_exit.sum()) / (32 * groups),
    }


def phase_kernels(models, gen):
    """Each kernel against its plain version on the card, at the shapes and
    on the inputs the slice gives it."""
    import torch

    from bcm3_tpu_torch.ops.poppk_kernels import (
        propagate_intervals_one_compartment as b1,
        propagate_intervals_plain as b1_plain,
    )
    from bcm3_tpu_torch.ops.transit_kernels import (
        OPS_FIRST_STAGE,
        OPS_LANE_SETUP,
        OPS_PER_TRIP,
        transit_solve as b2,
        transit_solve_plain as b2_plain,
    )

    f32 = torch.float32
    results = {}

    # B1: B = 65,536 chains x P = 16 patients, K = 14 intervals
    prior, lik = models["one"]
    pk = lik.model
    xs = prior.sample(gen, (ENSEMBLES["one"] * NUM_CHAINS,), f32)
    tb = pk._tables(xs.device, f32)
    p, _, _ = pk._patient_params(xs)
    B, P = p["ka"].shape
    args = (
        p["ka"].contiguous(), p["ke"][:, None].expand(B, P).contiguous(),
        p["kel"].contiguous(), tb["initial_dose"], tb["interval"], tb["dose_amount"],
    )
    g, c = b1(*args)
    gp, cp = b1_plain(*args)
    torch.cuda.synchronize()
    assert g.shape == (pk.K, B, P) and torch.isfinite(gp).any()
    fin = torch.isfinite(gp) & torch.isfinite(cp)
    assert torch.equal(fin, torch.isfinite(g) & torch.isfinite(c)), "B1 finite sets differ"
    err = torch.maximum((g - gp).abs()[fin].max(), (c - cp).abs()[fin].max()).item()
    # float32; the kernel rounds like its plain version (no FMA contraction)
    scale = torch.maximum(gp.abs(), cp.abs())
    rel = torch.maximum((g - gp).abs(), (c - cp).abs())[fin] / (scale[fin] + 1e-6)
    max_rel = rel.max().item()
    assert max_rel <= 1e-5, f"B1 disagrees with its plain version: max rel {max_rel}"
    ms = cuda_ms(lambda: b1(*args), 50)
    plain_ms = cuda_ms(lambda: b1_plain(*args), 50)
    # each input read once, each output written once; per lane 12 float
    # operations of set-up and 5 per interval (csrc/poppk_propagate.cu)
    K = pk.K
    b1_bytes = sum(x.numel() * x.element_size() for x in args) + (g.numel() + c.numel()) * 4
    b1_bound, b1_by = bound_ms(B * P * (12 + 5 * K), b1_bytes)
    log(f"B1 poppk_propagate B={B} P={P} K={K}: max abs err {err:.3e}, "
        f"max rel err {max_rel:.3e} (limit 1e-5); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {b1_bound:.4f} ms by {b1_by} ({b1_bytes} bytes), "
        f"roofline share {b1_bound / ms:.3f}")
    results["poppk_propagate"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b1_bound, bound_by=b1_by
    )

    # B2: 524,288 lanes, S = 38 stops, on per-patient tables
    params, grid, amt, kw = b2_inputs(*models["one_transit"], gen)
    trips = kw["trips"]
    slots = torch.zeros(1, dtype=torch.int64, device="cuda")
    c, ok, n = b2(params, grid, amt, trip_counts=True, warp_slots=slots, **kw)
    cp, okp, n_p = b2_plain(params, grid, amt, trip_counts=True, **kw)
    torch.cuda.synchronize()
    L, S = c.shape
    P = grid.shape[0]
    mismatched = int((ok != okp).sum())
    trip_mismatches = int((n != n_p).sum())
    both = ok & okp
    n_ok = int(both.sum())
    assert n_ok > L // 10, f"B2: only {n_ok} of {L} lanes finished"
    diff = (c[both] - cp[both]).abs()
    err = diff.max().item()
    # Built without FMA contraction and with the accurate exp/log/pow, the
    # kernel rounds like its plain version and takes the same step
    # sequence: the trip counts must be equal on every lane. Limits on the
    # outputs: ok differs on <= 0.01% of lanes, and central within 1e-3 of
    # each lane's peak.
    peak = cp[both].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    worst = (diff / peak).max().item()
    assert trip_mismatches == 0, f"B2: {trip_mismatches} lanes ran another number of trips"
    assert mismatched <= L // 10000, f"B2: {mismatched} lanes differ in ok"
    assert worst <= 1e-3, f"B2 disagrees with its plain version: {worst}"

    # The same lanes with S more trips of budget: there the early exit
    # fires only past `trips`, so min(count, trips) is what each lane runs
    # at this budget without the early exit.
    _, _, n_long = b2(params, grid, amt, trip_counts=True, **dict(kw, trips=trips + S))
    n_no_exit = n_long.clamp(max=trips)
    stats = b2_trip_statistics(n, n_no_exit, int(slots), trips)
    stats["share_failed"] = 1.0 - int(ok.sum()) / L
    # least work for these inputs: every trip after a lane's first reuses
    # its first stage (csrc/transit_dp5.cu, the note); each input read once
    # and each output written once
    ops = L * OPS_LANE_SETUP + int((n > 0).sum()) * OPS_FIRST_STAGE + int(n.sum()) * OPS_PER_TRIP
    b2_bytes = (len(params) - 1) * L * 4 + (2 * P * S + P) * 4 + L * S * 4 + L
    b2_bound, b2_by = bound_ms(ops, b2_bytes)

    ms = cuda_ms(lambda: b2(params, grid, amt, **kw), 5)
    plain_ms = cuda_ms(lambda: b2_plain(params, grid, amt, **kw), 2)
    log(f"B2 transit_dp5 L={L} S={S} trips={trips}: ok {int(ok.sum())}/{L}, "
        f"ok mismatches {mismatched} (limit {L // 10000}), trip-count mismatches "
        f"{trip_mismatches} (limit 0), max abs err {err:.3e}, "
        f"worst err / lane peak {worst:.3e} (limit 1e-3); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    log("B2 trips: " + json.dumps(stats))
    log(f"B2 bound: {ops:.4e} float operations, {b2_bytes} bytes -> {b2_bound:.4f} ms "
        f"by {b2_by}; roofline share {b2_bound / ms:.4f}")
    results["transit_dp5"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, ok_mismatches=mismatched,
        bound_ms=b2_bound, bound_by=b2_by,
    )

    # B2J: the gradient mode's transit solve with its Jacobian
    b2j = {f"{pk_type} {rows} x {NUM_PATIENTS} {dtype}": b2j_against_plain(
               pk_type, *models[pk_type], rows, getattr(torch, dtype), gen)
           for pk_type, rows, dtype in B2J_CHECKS}
    # the kernels line's entry: the NUTS path's width
    results["transit_dp5_tangent"] = next(iter(b2j.values()))
    return results


def b2j_inputs(prior, lik, rows, gen, dtype):
    """B2J's inputs as the gradient mode makes them from `rows` prior draws
    (PopPKLikelihood.transit_jacobian_inputs): the lane rates by name, the
    per-patient tables and the solver's options."""
    from bcm3_tpu_torch.ops.transit_tangent_kernels import RATES

    pk = lik.model
    x = prior.sample(gen, (rows,), dtype)
    tb = pk._tables(x.device, dtype)
    p, _, _ = pk._patient_params(x)
    tables, options, rates = pk.transit_jacobian_inputs(p, tb)
    return dict(zip(RATES, rates)), tables, options


def b2j_bound(rates, tables, counts):
    """B2J's bound for these inputs: its float operations (per lane the
    set-up, and OPS_PER_TRIP for each trip the lane ran) at the float32 or
    float64 peak, or the bytes it must move (the rates, the tables, the
    central amounts, the Jacobian and ok) at the memory rate."""
    from bcm3_tpu_torch.ops.transit_tangent_kernels import (
        OPS_LANE_SETUP,
        OPS_PER_TRIP,
        num_states,
    )

    n = num_states(rates)
    L = counts.numel()
    P, T = tables["obs_pos"].shape
    sz = tables["grid"].element_size()
    ops = L * OPS_LANE_SETUP + int(counts.long().sum()) * OPS_PER_TRIP[n]
    nbytes = (len(rates) * L * sz + sum(x.numel() * x.element_size() for x in tables.values())
              + L * T * (1 + len(rates)) * sz + L)
    peak = PEAK_F32_OPS if sz == 4 else PEAK_F64_OPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes"), ops, nbytes


def b2j_against_plain(pk_type, prior, lik, rows, dtype, gen):
    """B2J against its plain version on the card, on the inputs the
    gradient mode makes from `rows` prior draws: `ok` and the trip counts
    lane by lane, the central amounts and the Jacobian on the lanes that
    finish in both with the same trip count (limits B2J_*); the kernel's
    time by CUDA events, the wrapper's host time a call, the plain
    version's time, the bound."""
    import torch

    from bcm3_tpu_torch.ops.transit_tangent_kernels import (
        transit_jacobian as b2j,
        transit_jacobian_plain as b2j_plain,
    )

    rates, tables, options = b2j_inputs(prior, lik, rows, gen, dtype)
    name = str(dtype).replace("torch.", "")
    c, jac, ok, n = b2j(rates, **tables, **options, trip_counts=True)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cp, jac_p, ok_p, n_p = b2j_plain(rates, **tables, **options, trip_counts=True)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    L, T, K = jac.shape
    ok_mismatches = int((ok != ok_p).sum())
    other_trips = (ok | ok_p) & (n != n_p)
    trip_mismatches = int(other_trips.sum())
    same = ok & ok_p & (n == n_p)
    assert int(same.sum()) > L // 4, f"B2J {pk_type} {name}: only {int(same.sum())} of {L}"
    tiny = torch.finfo(dtype).tiny
    # a Jacobian entry that is not finite must be the plain version's too
    nonfinite = ~torch.isfinite(jac_p[same]).all(dim=(1, 2))
    nonfinite_kernel = ~torch.isfinite(jac[same]).all(dim=(1, 2))
    fin_j = torch.isfinite(jac_p[same])
    jac_same_set = bool(torch.equal(fin_j, torch.isfinite(jac[same])))
    dc = (c - cp).abs()[same]
    dj = torch.where(fin_j, (jac - jac_p).abs()[same], 0.0)
    value_err = (dc / cp[same].abs().amax(dim=1, keepdim=True).clamp(min=tiny)).max().item()
    jscale = torch.where(fin_j, jac_p[same].abs(), 0.0).amax(dim=1, keepdim=True)
    jac_err = (dj / jscale.clamp(min=tiny)).max().item()
    max_abs = max(dc.max().item(), dj.max().item())
    bit_for_bit = bool(torch.equal(c[same], cp[same]) and jac_same_set
                       and torch.equal(jac[same][fin_j], jac_p[same][fin_j]))
    other = ""
    if trip_mismatches:
        both = other_trips & ok & ok_p
        if both.any():
            rel = ((c - cp).abs()[both] / cp[both].abs().amax(dim=1, keepdim=True)
                   .clamp(min=tiny)).max().item()
            other = f", their central amounts within {rel:.3e} of the lane's largest"
    ms = cuda_ms(lambda: b2j(rates, **tables, **options), 5)
    wrapper_us = host_us(lambda: b2j(rates, **tables, **options), reps=20)
    bound, by, ops, nbytes = b2j_bound(rates, tables, n)
    plan = b2j.last_plan
    log(f"B2J transit_dp5_tangent {pk_type} L={L} T={T} K={K} {name}: ok {int(ok.sum())}/{L}, "
        f"ok mismatches {ok_mismatches} (limit {int(B2J_OK_SHARE * L)}), lanes with another "
        f"trip count {trip_mismatches} (limit {int(B2J_TRIP_SHARE * L)}){other}; on the "
        f"{int(same.sum())} lanes that finish alike: {int(nonfinite.sum())} with a non-finite "
        f"Jacobian entry in the plain version, {int(nonfinite_kernel.sum())} in the kernel "
        f"(the same entries: {jac_same_set}, asserted), bit for bit elsewhere {bit_for_bit}, "
        f"central max rel "
        f"err {value_err:.3e} (limit {B2J_VALUE_RTOL[name]}), Jacobian max rel err "
        f"{jac_err:.3e} (limit {B2J_JAC_RTOL[name]}), max abs err {max_abs:.3e}; trips mean "
        f"{n.double().mean().item():.2f}, max {int(n.max())}; kernel {ms:.4f} ms (CUDA events), "
        f"wrapper {wrapper_us:.1f} us a call on the host, plain {plain_ms:.1f} ms; bound "
        f"{bound:.4f} ms by {by} ({ops:.4e} operations, {nbytes} bytes), roofline share "
        f"{bound / ms:.4f}; launch plan {plan}")
    assert ok_mismatches <= B2J_OK_SHARE * L
    assert trip_mismatches <= B2J_TRIP_SHARE * L
    assert jac_same_set
    assert value_err <= B2J_VALUE_RTOL[name] and jac_err <= B2J_JAC_RTOL[name]
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                host_us=wrapper_us, value_err=value_err, jac_err=jac_err,
                trip_mismatches=trip_mismatches, ok_mismatches=ok_mismatches)


def phase_slice(pk_type, models):
    return pt_slice(f"slice {pk_type}", *models[pk_type], ENSEMBLES[pk_type],
                    NUM_SAMPLES[pk_type], profile_samples=PT_PROFILE_ITERATIONS)


def pt_config(E, num_samples):
    """The slices' PTConfig: NUM_CHAINS x E chains, num_samples emitted
    samples thinned by USE_EVERY_NTH, no adaptation, float32 on CARD."""
    import torch

    from bcm3_tpu_torch.sampler import PTConfig

    return PTConfig(
        num_samples=num_samples,
        use_every_nth=USE_EVERY_NTH,
        num_chains=NUM_CHAINS,
        num_ensembles=E,
        adapt_proposal_samples=0,
        adapt_proposal_times=0,
        swapping_scheme="deterministic_even_odd",
        seed=7,
        emit_dtype=torch.float32,
        emit_fixed_only=True,
        device=CARD,
        dtype=torch.float32,
    )


def pt_slice(name, prior, lik, E, num_samples, profile_samples=None, warm=True):
    """SamplerPT over (prior, lik) with `pt_config`: a cold run (its
    outputs checked), a warm run for the wall of its iterations, and one
    more under the profiler for the device's busy time; with
    profile_samples, the profiled run is a second sampler's of that many
    iterations (the profile counts only the sampling span, not its
    start-position search); with warm=False, the wall is the cold run's
    (for a likelihood that builds no kernel and whose iterations take
    long enough that the first ones' allocations do not show)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import SamplerPT

    cfg = pt_config(E, num_samples)
    sampler = SamplerPT(prior, lik, cfg)
    res = sampler.run()
    torch.cuda.synchronize()
    S, D = cfg.num_samples, prior.num_variables
    assert res["samples"].shape == (S * E, 1, D), res["samples"].shape
    lpost = res["log_prior"] + res["log_likelihood"]
    assert np.isfinite(lpost).all(), "non-finite emitted log-posterior"
    assert np.isfinite(res["samples"]).all()
    mut, exc = sampler.acceptance_rates(sampler.state)
    assert 0.0 < mut[-1] < 1.0, f"T=1 mutate acceptance {mut[-1]}"
    log(f"{name}: {NUM_CHAINS} x {E} chains, {res['evaluations']} evaluations "
        f"in {res['elapsed_seconds']:.3f} s = {res['evals_per_second']:.1f} evals/s; "
        f"mutate acceptance by temperature {np.round(mut, 4).tolist()}, "
        f"exchange {np.round(exc, 4).tolist()}")

    # steady state: the same sampler runs again (kernels built, allocations
    # cached), once for the wall of its iterations and once under the profiler
    iterations = cfg.num_samples * cfg.use_every_nth
    timed_run = sampler.run() if warm else res
    wall_ms = timed_run["sampling_seconds"] * 1e3 / iterations
    if profile_samples is None:
        busy_ms, top = profile_sampling(sampler, iterations)
    else:
        short = SamplerPT(prior, lik, dataclasses.replace(cfg, num_samples=profile_samples,
                                                          use_every_nth=1))
        busy_ms, top = profile_sampling(short, profile_samples)
    idle = "not measured" if busy_ms is None else f"{1.0 - busy_ms / wall_ms:.4f}"
    log(f"{name} {'steady state' if warm else 'cold run'}: {iterations} iterations, wall "
        f"{wall_ms:.4f} ms per iteration = {E * NUM_CHAINS / wall_ms * 1e3:.1f} evals/s; "
        f"device busy {busy_ms if busy_ms is not None else 'not measured'} ms per "
        f"iteration (under the profiler), idle share {idle}")
    for kernel, ms in top:
        log(f"  device ms per iteration {ms:.4f}  {kernel[:120]}")
    return dict(res, wall_ms=wall_ms, busy_ms=busy_ms)


def adapted_sampler(prior, lik, adapt_times=ADAPT_TIMES, **override):
    """bench.py build_sampler(100, 2, 2024, "one", 8192, emit_fixed_only=True)
    in the port, on the card, with `adapt_times` boundaries; the GMM
    backend "auto" is the batched EM at D = 40. `override`: PTConfig
    fields that differ from it."""
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    cfg = PTConfig(
        num_samples=ADAPTED_SAMPLES,
        use_every_nth=USE_EVERY_NTH,
        num_chains=NUM_CHAINS,
        num_ensembles=ENSEMBLES["one"],
        adapt_proposal_samples=ADAPTED_SAMPLES // (adapt_times + 1),
        adapt_proposal_times=adapt_times,
        max_history_size=2000,
        swapping_scheme="deterministic_even_odd",
        seed=2024,
        emit_dtype=torch.float32,
        emit_fixed_only=True,
        gmm_fit_backend="auto",
        device="cuda",
        dtype=torch.float32,
    )
    return SamplerPT(prior, lik, dataclasses.replace(cfg, **override))


def check_run(res, sampler, boundaries):
    import numpy as np

    S, E, D = sampler.config.num_samples, sampler.num_ensembles, sampler.num_variables
    assert res["samples"].shape == (S * E, 1, D), res["samples"].shape
    assert res["adaptation_boundaries"] == boundaries, res["adaptation_boundaries"]
    lpost = res["log_prior"] + res["log_likelihood"]
    assert np.isfinite(lpost).all(), "non-finite emitted log-posterior"
    mut, _ = sampler.acceptance_rates(sampler.state)
    assert 0.0 < mut[-1] < 1.0, f"T=1 mutate acceptance {mut[-1]}"
    return mut


def log_boundaries(name, res, smi):
    """Each boundary's seconds by part (`SamplerPT._adapt_proposals`), the
    batched EM's counts where it ran, cluster and block sizes."""
    for i, b in enumerate(res["adaptation_breakdown"]):
        # the parts this boundary ran (a part it skipped is exactly 0)
        parts = {k[: -len("_seconds")]: v for k, v in b.items()
                 if k.endswith("_seconds") and v > 0.0}
        line = (f"{name} boundary {i + 1}: {sum(parts.values()):.3f} s = "
                + " + ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
        fs = b["fit_stats"]
        if fs:
            line += (f"; EM: torch.linalg.eigh {fs.get('eigh_seconds', 0.0):.3f} s, fits per "
                     f"k {fs.get('fits')}, batched EM steps per k {fs.get('em_steps')}, mean "
                     f"E-steps per fit "
                     f"{ {k: round(v, 2) for k, v in fs.get('em_steps_per_fit', {}).items()} }")
        if "cluster_sizes" in b:
            line += f"; cluster sizes {b['cluster_sizes']}"
        log(line + f"; blocks {len(b['block_sizes'])} of sizes {b['block_sizes']}; components "
            f"per ladder position {b['components']} on {smi}")
    log(f"{name} run: {res['adaptation_boundaries']} boundaries, "
        f"{res['adaptation_seconds']:.3f} s in them, run {res['elapsed_seconds']:.3f} s")


def ess_stats(res, num_ensembles, seconds):
    """bench.py ess_stats: per-chain ESS of the T=1 traces of the first
    ESS_ENSEMBLES ensembles (FFT-batched), mean over variables and chains
    and the worst variable's mean, and ESS per second over the population."""
    import numpy as np

    from bcm3_tpu_torch.analysis import effective_sample_size_batched

    samples = res["samples"]
    E = num_ensembles
    S, D = samples.shape[0] // E, samples.shape[2]
    Esub = min(E, ESS_ENSEMBLES)
    x = samples.reshape(S, E, samples.shape[1], D)[:, :Esub, -1, :]
    ess = effective_sample_size_batched(
        np.ascontiguousarray(x.reshape(S, Esub * D), dtype=np.float64)
    ).reshape(Esub, D)
    ess_mean, ess_min = float(ess.mean()), float(ess.mean(axis=0).min())
    return {
        "ess_per_chain_mean": ess_mean,
        "ess_per_chain_min_var": ess_min,
        "ess_per_sec": ess_mean * E / seconds,
        "ess_min_var_per_sec": ess_min * E / seconds,
    }


def adapted_protocol(name, models, smi, profile_samples=NUM_SAMPLES["one"], cold=True,
                     adapt_times=ADAPT_TIMES, **override):
    """bench_adapted's protocol on the card (bench.py:232-283), with
    `override`'s PTConfig fields: a cold sampler's run() crosses both
    boundaries (skipped with cold=False), a second sampler's run() gives
    the warm boundaries, and a third run() of it (the adapted proposals,
    no boundary) gives the wall per iteration; a fourth run() of
    `profile_samples` samples under torch.profiler gives the device's busy
    time. Returns the warm sampler, the third run's result and its state,
    and the measurements (with the warm run's boundaries)."""
    import numpy as np
    import torch

    prior, lik = models["one"]
    if cold:
        first = adapted_sampler(prior, lik, adapt_times, **override)
        res = first.run()
        check_run(res, first, adapt_times)
        log_boundaries(f"{name} cold", res, smi)
        del first, res
        torch.cuda.empty_cache()

    warm = adapted_sampler(prior, lik, adapt_times, **override)
    res = warm.run()
    check_run(res, warm, adapt_times)
    log_boundaries(f"{name} warm", res, smi)
    boundaries = res["adaptation_breakdown"]
    for p in warm.proposals:
        assert torch.isfinite(p.means).all() and torch.isfinite(p.chols).all()
    log(f"{name} proposals: components per ladder position "
        f"{[int(torch.isfinite(lw).sum()) for lw in warm.proposals[0].log_weights]}, "
        f"{len(warm.blocks)} blocks")

    # the adapted regime: no boundary left, the proposals from the fits with
    # fresh scales; the profile covers as many iterations as the unadapted
    # slice's (no boundary is left to cross at any length)
    res = warm.run()
    state = warm.state
    mut = check_run(res, warm, 0)
    samples = warm.config.num_samples
    iterations = samples * USE_EVERY_NTH
    wall_ms = res["sampling_seconds"] * 1e3 / iterations
    profiled = min(profile_samples, samples)
    warm.config = dataclasses.replace(warm.config, num_samples=profiled)
    busy_ms, top = profile_sampling(warm, profiled * USE_EVERY_NTH)
    assert warm.adaptation_boundaries == 0
    E = warm.num_ensembles
    ess = ess_stats(res, E, res["elapsed_seconds"])
    ess_sampling = ess_stats(res, E, res["sampling_seconds"])
    idle = "not measured" if busy_ms is None else f"{1.0 - busy_ms / wall_ms:.4f}"
    log(f"{name} steady state: {NUM_CHAINS} x {E} chains, {iterations} iterations, wall "
        f"{wall_ms:.4f} ms per iteration = {E * NUM_CHAINS / wall_ms * 1e3:.1f} evals/s, "
        f"device busy {busy_ms if busy_ms is not None else 'not measured'} ms per iteration "
        f"(under the profiler, {profiled * USE_EVERY_NTH} iterations), idle share {idle}; "
        f"on {smi}")
    for kernel, ms in top:
        log(f"  device ms per iteration {ms:.4f}  {kernel[:120]}")
    log(f"{name} run: {res['evaluations']} evaluations in {res['elapsed_seconds']:.3f} s = "
        f"{res['evals_per_second']:.1f} evals/s; mutate acceptance by temperature "
        f"{np.round(mut, 4).tolist()}")
    log(f"{name} ESS per chain: mean {ess['ess_per_chain_mean']:.4f}, worst variable "
        f"{ess['ess_per_chain_min_var']:.4f} of {samples} samples; ESS/s "
        f"{ess['ess_per_sec']:.1f} (worst variable {ess['ess_min_var_per_sec']:.1f}) over "
        f"the run's {res['elapsed_seconds']:.3f} s, {ess_sampling['ess_per_sec']:.1f} over "
        f"its iterations' {res['sampling_seconds']:.3f} s; on {smi}")
    return warm, res, state, dict(wall_ms=wall_ms, busy_ms=busy_ms, mutate=mut,
                                  boundaries=boundaries)


def phase_adapted(models, unadapted, smi):
    """bench_adapted on the card: GMM proposals, the batched EM. Its cold
    sampler is left out (its two boundaries took about 130 s of the
    script's time limit), and its warm sampler crosses one boundary, after
    50 of the 100 samples, where bench_adapted's crosses two (each takes
    about a minute, torch.linalg.eigh most of it, and the second runs the
    same path as the first)."""
    _, res, _, m = adapted_protocol("adapted", models, smi, cold=False, adapt_times=1,
                                    profile_samples=CLUSTERED_PROFILE_SAMPLES)
    log(f"adapted against unadapted `one`: wall {m['wall_ms']:.4f} against "
        f"{unadapted['wall_ms']:.4f} ms, busy {m['busy_ms']} against "
        f"{unadapted['busy_ms']} ms per iteration")
    return res


def phase_clustered(models, unadapted, smi):
    """bench_adapted's protocol with clustered proposals; also the card's
    time of one `assign_batch` of the whole population (two per mutate
    block). Returns what assign_card_vs_cpu compares: the assigner, the
    population's positions and the pooled T=1 history of the adapted run."""
    import torch

    from bcm3_tpu_torch.sampler import spectral

    # without the protocol's cold sampler (about 55 s), cut for time
    warm, res, state, m = adapted_protocol(
        "clustered", models, smi, profile_samples=CLUSTERED_PROFILE_SAMPLES, cold=False,
        **CLUSTERED
    )
    assert warm._assigner is not None, "no clustering was fitted"
    assert all(p.clustered for p in warm.proposals)
    sizes = [b["cluster_sizes"] for b in m["boundaries"]]
    x = state.x.to(torch.float64)
    ms = cuda_ms(lambda: spectral.assign_batch(warm._assigner, x), 5)
    n, D = warm._assigner.scaled_samples.shape
    log(f"clustered: assign_batch of {len(x)} chains against {n} stored samples in D = {D}, "
        f"{warm._assigner.num_clusters} clusters: {ms:.3f} ms per call (CUDA events), two "
        f"per mutate block; adapted iteration wall {m['wall_ms']:.4f} ms, busy "
        f"{m['busy_ms']} ms, against unadapted `one` {unadapted['wall_ms']:.4f} / "
        f"{unadapted['busy_ms']} ms; cluster sizes at the warm run's boundaries {sizes}; "
        f"T=1 mutate acceptance {m['mutate'][-1]:.4f}; on {smi}")
    count = warm._history_count(state)
    return dict(assigner=warm._assigner, x=x, pooled=warm._pooled_fixed_history(state, count),
                assign_ms=ms, res=res)


def phase_assign(clustered, smi):
    """The clustered run's assigner on the card against the same assigner
    on the CPU, float64: `assign_batch` on the whole population and
    `assign_history` on every ASSIGN_HISTORY_STRIDE-th row of the pooled
    T=1 history. A row's label may differ
    only where the CPU's two best centroid scores are within ASSIGN_MARGIN
    (relative to the best): there the two devices' rounding decides."""
    import torch

    from bcm3_tpu_torch.sampler import spectral

    card_a = clustered["assigner"]
    cpu_a = card_a.to("cpu")
    for name, fn, rows in (
        ("assign_batch", spectral.batch_scores, clustered["x"]),
        ("assign_history", spectral.history_scores,
         clustered["pooled"][::ASSIGN_HISTORY_STRIDE]),
    ):
        t0 = time.perf_counter()
        card = fn(card_a, rows).cpu()
        t1 = time.perf_counter()
        cpu = fn(cpu_a, rows.cpu())
        t2 = time.perf_counter()
        apart = card.argmax(-1) != cpu.argmax(-1)
        top2 = torch.topk(cpu, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()
        worst = margin[apart].max().item() if apart.any() else 0.0
        log(f"{name} card vs CPU: {len(rows)} rows, {int(apart.sum())} labelled apart "
            f"(limit {ASSIGN_SHARE:g} of rows), their largest relative top-two margin "
            f"{worst:.3e} (limit {ASSIGN_MARGIN:g}); least margin of all rows "
            f"{margin.min().item():.3e}, max |card - CPU| score {(card - cpu).abs().max().item():.3e}; "
            f"card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s; on {smi}")
        assert int(apart.sum()) <= ASSIGN_SHARE * len(rows), f"{name}: {int(apart.sum())} apart"
        assert worst < ASSIGN_MARGIN, f"{name}: labelled apart at margin {worst}"


def phase_autoblock(models, smi):
    """clustered_autoblock blocking with clustered proposals, narrowed: the
    run starts with one block per variable, and each boundary re-blocks
    the variables from the pooled T=1 history's within-cluster
    correlations."""
    # without the protocol's cold sampler (its boundaries run the same path)
    warm, res, _, m = adapted_protocol(
        "autoblock", models, smi, profile_samples=CLUSTERED_PROFILE_SAMPLES, cold=False,
        **AUTOBLOCK
    )
    blocks = [b["block_sizes"] for b in m["boundaries"]]
    log(f"autoblock: {warm.num_variables} blocks of 1 before the first boundary; after the "
        f"warm run's boundaries {[len(b) for b in blocks]} blocks of sizes {blocks}; cluster "
        f"sizes {[b.get('cluster_sizes') for b in m['boundaries']]}; T=1 mutate acceptance "
        f"{m['mutate'][-1]:.4f}; on {smi}")
    assert any(len(b) > 1 for b in blocks), (
        "autoblock: every boundary merged all variables into one block (every pair's "
        "within-cluster |correlation| was above the tree's cut at 0.5)")
    return res



def analytic_model(example):
    """Prior and likelihood of one of the repo's analytic fixtures, read as
    a user reads them."""
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood

    d = os.path.join(FIXTURES, example)
    vs = VariableSet.from_xml(os.path.join(d, "prior.xml"))
    return Prior.from_xml(os.path.join(d, "prior.xml"), vs), create_likelihood(
        os.path.join(d, "likelihood.xml"), vs)


def quadrature(log_density, box, n):
    """Trapezoid weights times the normalized density on an n x n grid of a
    2-D box; returns the two coordinate grids and the weights."""
    import numpy as np

    axes = [np.linspace(lo, hi, n) for lo, hi in box]
    w = np.ones(n)
    w[[0, -1]] = 0.5
    X1, X2 = np.meshgrid(*axes, indexing="ij")
    logp = log_density(X1, X2)
    p = np.outer(w, w) * np.exp(logp - logp.max())
    return X1, X2, p / p.sum()


def banana_oracle():
    """Posterior mean and sd of the banana fixture over its prior box."""
    import numpy as np

    def logp(x1, x2):  # sd1 2, sd2 1, the ridge mean as the reference writes it
        return -0.5 * (x1 / 2.0) ** 2 - 0.5 * (x2 - (x1 + 3.0 * x1 + (1.0 - x1) ** 2)) ** 2

    X1, X2, p = quadrature(logp, BANANA_BOX, 2001)
    mean = np.array([(p * X1).sum(), (p * X2).sum()])
    sd = np.sqrt([(p * (X1 - mean[0]) ** 2).sum(), (p * (X2 - mean[1]) ** 2).sum()])
    return mean, sd


def oracle_distance(name, x, smi, asserted=False):
    """Mean and sd of each coordinate of the rows x (S, E, D) against the
    banana oracle, with their Monte Carlo standard errors (a mean's: the
    spread of the per-ensemble (or per-chain) means over sqrt(E); an
    sd's: that of the sds of groups of MOMENT_GROUP ensembles); returns
    the z of the means, then of the sds. The caller asserts them where
    `asserted`; after a mixture adaptation PT, as the JAX package's, misses
    the oracle (ROADMAP C), and the distance is only logged."""
    import numpy as np

    S, E, D = x.shape
    per_ensemble = x.mean(axis=0)
    mean, mean_se = per_ensemble.mean(axis=0), per_ensemble.std(axis=0, ddof=1) / np.sqrt(E)
    groups = x.reshape(S, E // MOMENT_GROUP, MOMENT_GROUP, D).transpose(1, 0, 2, 3)
    group_sd = groups.reshape(E // MOMENT_GROUP, -1, D).std(axis=1)
    sd, sd_se = group_sd.mean(axis=0), group_sd.std(axis=0, ddof=1) / np.sqrt(len(group_sd))
    exact_mean, exact_sd = banana_oracle()
    z_mean, z_sd = (mean - exact_mean) / mean_se, (sd - exact_sd) / sd_se
    verdict = f"limit {MCSE_LIMIT}" if asserted else "not asserted (ROADMAP C)"
    log(f"{name}: mean {mean.tolist()} +- {mean_se.tolist()} (oracle {exact_mean.tolist()}, "
        f"z {z_mean.tolist()}); sd {sd.tolist()} +- {sd_se.tolist()} (oracle "
        f"{exact_sd.tolist()}, z {z_sd.tolist()}); {verdict}; {S} samples x {E} ensembles "
        f"or chains; on {smi}")
    return np.concatenate([z_mean, z_sd])


def run_to_the_boundary(sampler):
    """sampler.run(), with the T=1 rows and the acceptance counters as they
    stand at its (first) adaptation boundary kept in the result under
    "before"."""
    adapt, before = sampler._adapt_proposals, {}

    def adapt_and_keep(state):
        before.update({k: getattr(state, k).cpu().numpy().astype("float64")
                       for k in ("att_mut", "acc_mut", "att_exc", "acc_exc")})
        return adapt(state)

    sampler._adapt_proposals = adapt_and_keep
    try:
        res = sampler.run()
    finally:
        del sampler._adapt_proposals
    res["before"] = before
    return res


def same_law(name, card, cpu, smi):
    """The card's T=1 rows and acceptance counters before the adaptation
    (`card`, `cpu`: dicts of rows (S, E, D) and of "att_mut", "acc_mut",
    "att_exc", "acc_exc" per chain, ladder fastest) against the CPU's:
    each coordinate's mean and mean square over the second half of the
    rows, and each temperature's mutate and exchange acceptance, within
    MCSE_LIMIT standard errors of the difference (each the spread over
    independent ensembles over sqrt(ensembles))."""
    import numpy as np

    def per_ensemble(run):
        x = run["rows"][run["rows"].shape[0] // 2:]
        stats = [x.mean(axis=0), (x * x).mean(axis=0)]
        for move in ("mut", "exc"):
            att = run[f"att_{move}"].reshape(x.shape[1], -1)
            stats.append(np.where(att > 0, run[f"acc_{move}"].reshape(att.shape)
                                  / np.maximum(att, 1), 0.0))
        per = np.concatenate(stats, axis=1)  # (E, 2 D + 2 chains)
        return per.mean(axis=0), per.std(axis=0, ddof=1) / np.sqrt(len(per))

    (a, sa), (b, sb) = per_ensemble(card), per_ensemble(cpu)
    z = (a - b) / np.maximum(np.sqrt(sa**2 + sb**2), 1e-12)
    log(f"{name}: card {np.round(a, 4).tolist()}, CPU {np.round(b, 4).tolist()} "
        f"(E[x], E[x^2], then mutate and exchange acceptance by temperature), z "
        f"{np.round(z, 3).tolist()}, max |z| {np.abs(z).max():.3f} (limit {MCSE_LIMIT}); "
        f"on {smi}")
    assert np.all(np.abs(z) <= MCSE_LIMIT), f"{name}: z {z}"


def analytic_sampler(example, config):
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    prior, lik = analytic_model(example)
    cfg = PTConfig(**config, swapping_scheme="deterministic_even_odd", emit_fixed_only=True,
                   emit_dtype=torch.float32, device=CARD, dtype=torch.float32)
    return SamplerPT(prior, lik, cfg)


def phase_banana(smi):
    """bench.py bench_banana on the card: a cold run() crosses the GMM
    boundary (its breakdown). Before it, its T=1 rows and acceptance are
    held to the port's run on the CPU (float64, BANANA_CPU_ENSEMBLES
    ensembles, the same configuration up to the boundary); after it the
    rows' distance from the quadrature oracle is logged. A second run() of
    the sampler, with the adapted proposals, gives evals/s and ESS/s as
    bench.py computes them (the second half's T=1 traces of 256
    ensembles, over the run's wall)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    sampler = analytic_sampler("banana", BANANA)
    S, E = BANANA["num_samples"], BANANA["num_ensembles"]
    A = BANANA["adapt_proposal_samples"]
    cold = run_to_the_boundary(sampler)
    torch.cuda.synchronize()
    assert cold["adaptation_boundaries"] == 1, cold["adaptation_boundaries"]
    assert np.isfinite(cold["log_prior"] + cold["log_likelihood"]).all()
    log_boundaries("banana", cold, smi)
    rows = cold["samples"].reshape(S, E, -1).astype(np.float64)
    prior, lik = analytic_model("banana")
    t = time.perf_counter()
    cpu = SamplerPT(prior, lik, PTConfig(**dict(
        BANANA, num_ensembles=BANANA_CPU_ENSEMBLES, num_samples=A, adapt_proposal_samples=0,
        adapt_proposal_times=0), swapping_scheme="deterministic_even_odd", emit_fixed_only=True,
        device="cpu", dtype=torch.float64))
    res = cpu.run()
    log(f"banana on the CPU: {BANANA['num_chains']} x {BANANA_CPU_ENSEMBLES} chains, {A} "
        f"samples, {time.perf_counter() - t:.3f} s")
    same_law("banana before its boundary, card against CPU",
             dict(cold["before"], rows=rows[:A]),
             dict({k: v.astype(np.float64) for k, v in (
                 ("att_mut", res["acceptance"]["attempted_mutate"]),
                 ("acc_mut", res["acceptance"]["accepted_mutate"]),
                 ("att_exc", res["acceptance"]["attempted_exchange"]),
                 ("acc_exc", res["acceptance"]["accepted_exchange"]))},
                  rows=res["samples"].reshape(A, BANANA_CPU_ENSEMBLES, -1).astype(np.float64)),
             smi)
    half = S // 2
    oracle_distance("banana cold run, after its boundary", rows[half:], smi)
    warm = sampler.run()
    assert warm["adaptation_boundaries"] == 0
    mut, exc = sampler.acceptance_rates(sampler.state)
    ess = ess_stats({"samples": warm["samples"][half * E:]}, E, warm["elapsed_seconds"])
    log(f"banana adapted run: {BANANA['num_chains']} x {E} chains, {warm['evaluations']} "
        f"evaluations in {warm['elapsed_seconds']:.3f} s = {warm['evals_per_second']:.1f} "
        f"evals/s ({warm['sampling_seconds']:.3f} s of iterations); ESS per chain "
        f"{ess['ess_per_chain_mean']:.4f} of {S - half} samples, ESS/s "
        f"{ess['ess_per_sec']:.1f} (worst variable {ess['ess_min_var_per_sec']:.1f}); "
        f"mutate acceptance by temperature {np.round(mut, 4).tolist()}, exchange "
        f"{np.round(exc, 4).tolist()}; on {smi}")
    oracle_distance("banana adapted run, second half",
                    warm["samples"].reshape(S, E, -1)[half:].astype(np.float64), smi)
    return dict(evals_per_second=warm["evals_per_second"], ess_per_sec=ess["ess_per_sec"])


def multimodal_oracle():
    """Quadrature mass of x1 > 0 of the multimodal_gaussians posterior over
    its prior box (the fixed mixture of TestLikelihoodMultimodalGaussians)."""
    import numpy as np

    means = np.array([[-5.0, -5.0], [5.0, 5.0]])
    covs = np.array([[[1.0, -0.9], [-0.9, 1.0]], [[2.0, -0.5], [-0.5, 1.0]]])

    def logp(x1, x2):
        parts = []
        for m, c in zip(means, covs):
            ic = np.linalg.inv(c)
            d1, d2 = x1 - m[0], x2 - m[1]
            q = ic[0, 0] * d1 * d1 + 2 * ic[0, 1] * d1 * d2 + ic[1, 1] * d2 * d2
            parts.append(np.log(0.5) - 0.5 * q - 0.5 * np.log(np.linalg.det(c)))
        return np.logaddexp(*parts)

    X1, _, p = quadrature(logp, (MULTIMODAL_BOX, MULTIMODAL_BOX), 2001)
    return float(p[X1 > 0].sum())


def phase_multimodal(smi):
    """tests/test_sampler_banana.py's multimodal_gaussians run with global
    covariance proposals, on the card at 1024 ensembles: the T=1 share of
    the second half's rows with x1 > 0 against the quadrature mass."""
    import numpy as np

    sampler = analytic_sampler("multimodal_gaussians", MULTIMODAL)
    S, E = MULTIMODAL["num_samples"], MULTIMODAL["num_ensembles"]
    res = sampler.run()
    assert res["adaptation_boundaries"] == 1
    x = res["samples"].reshape(S, E, -1)[S // 2:]
    per_ensemble = (x[..., 0] > 0).mean(axis=0)
    share, se = per_ensemble.mean(), per_ensemble.std(ddof=1) / np.sqrt(E)
    exact = multimodal_oracle()
    mut, exc = sampler.acceptance_rates(sampler.state)
    log(f"multimodal_gaussians: T=1 share with x1 > 0 {share:.5f} +- {se:.5f} (quadrature "
        f"{exact:.6f}, z {(share - exact) / se:.3f}, limit {MCSE_LIMIT}); ensembles that "
        f"visited both modes {float(((per_ensemble > 0) & (per_ensemble < 1)).mean()):.4f}; "
        f"{res['evaluations']} evaluations in {res['elapsed_seconds']:.3f} s = "
        f"{res['evals_per_second']:.1f} evals/s; mutate acceptance {np.round(mut, 4).tolist()}, "
        f"exchange {np.round(exc, 4).tolist()}; on {smi}")
    assert abs(share - exact) <= MCSE_LIMIT * se, f"mode share {share} against {exact}"
    return dict(evals_per_second=res["evals_per_second"])


def phase_poppk_models(workdir, smi):
    """The other PopPK models on the card: `two` and `one_biphasic_uptake`
    through SamplerPT at `one`'s width, POPPK_PT_SAMPLES deep (cold run, warm wall per
    iteration, busy share under the profiler); `two_transit` at
    one_transit's width in one evaluation of prior draws (CUDA events; its
    sampler's cold run, 76 s of start-position search, and its profile are
    cut for time); then each against the port on the CPU on ORACLE_DRAWS
    prior draws (two_transit on TWO_TRANSIT_ORACLE_DRAWS)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    evals = {}
    for pk_type in ("two", "one_biphasic_uptake", "two_transit"):
        prior, lik = build_model(pk_type, workdir)
        transit = pk_type == "two_transit"
        E = ENSEMBLES["one_transit" if transit else "one"]
        if transit:
            # one evaluation of the population, then one more under the profiler
            gen = torch.Generator(device=CARD).manual_seed(7)
            x = prior.sample(gen, (NUM_CHAINS * E,), torch.float32)
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            lp = lik.log_prob_batched(x)
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
            finite = float(torch.isfinite(lp).double().mean())
            # its profile (busy 1,369.6-1,425.9 ms in PRs 6-13, ~57 s of
            # tracing ~300,000 launches) is cut for the gradient phases' time
            line = (f"{pk_type}: one evaluation of {NUM_CHAINS * E} prior draws x "
                    f"{NUM_PATIENTS} patients: {ms:.1f} ms (CUDA events), {finite:.4f} of "
                    f"them finite")
            evals[pk_type] = NUM_CHAINS * E / ms * 1e3
            del x, lp
        else:
            cfg = PTConfig(
                num_samples=POPPK_PT_SAMPLES, use_every_nth=USE_EVERY_NTH,
                num_chains=NUM_CHAINS, num_ensembles=E, adapt_proposal_samples=0,
                adapt_proposal_times=0, swapping_scheme="deterministic_even_odd", seed=7,
                emit_dtype=torch.float32, emit_fixed_only=True, device=CARD,
                dtype=torch.float32,
            )
            sampler = SamplerPT(prior, lik, cfg)
            res = sampler.run()
            torch.cuda.synchronize()
            iterations = cfg.num_samples * cfg.use_every_nth
            assert res["samples"].shape == (cfg.num_samples * E, 1, prior.num_variables)
            assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
            mut, _ = sampler.acceptance_rates(sampler.state)
            line = (f"{pk_type}: {NUM_CHAINS} x {E} chains, {iterations} iterations, cold run "
                    f"{res['evaluations']} evaluations in {res['elapsed_seconds']:.3f} s = "
                    f"{res['evals_per_second']:.1f} evals/s ({res['sampling_seconds']:.3f} s "
                    f"of iterations); T=1 mutate acceptance {mut[-1]:.4f}")
            warm = sampler.run()
            wall_ms = warm["sampling_seconds"] * 1e3 / iterations
            # ~1,500 launches an iteration: the profiled run is shorter, as
            # the clustered slices' are
            sampler.config = dataclasses.replace(sampler.config,
                                                 num_samples=CLUSTERED_PROFILE_SAMPLES)
            busy_ms, top = profile_sampling(sampler, CLUSTERED_PROFILE_SAMPLES * USE_EVERY_NTH)
            idle = "not measured" if busy_ms is None else f"{1.0 - busy_ms / wall_ms:.4f}"
            line += (f"; warm {wall_ms:.4f} ms per iteration = "
                     f"{NUM_CHAINS * E / wall_ms * 1e3:.1f} evals/s, device busy {busy_ms} ms "
                     f"per iteration (under the profiler), idle share {idle}; largest kernels "
                     + ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top[:4]))
            evals[pk_type] = NUM_CHAINS * E / wall_ms * 1e3
            del sampler, res
        log(line + f"; on {smi}")
        draws = TWO_TRANSIT_ORACLE_DRAWS if transit else ORACLE_DRAWS
        xs = prior.sample(torch.Generator().manual_seed(5), (draws,), torch.float64)
        card = lik.log_prob_batched(xs.to(CARD, torch.float32)).double().cpu().numpy()
        card_vs_cpu(f"card vs CPU {pk_type}", pk_type, lik, xs, card)
        torch.cuda.empty_cache()
    return evals


def timed_calls(obj, name, seconds):
    """Wrap obj.name so that each call appends its seconds to `seconds`."""
    fn = getattr(obj, name)

    def wrapper(*args):
        t = time.perf_counter()
        out = fn(*args)
        seconds.append(time.perf_counter() - t)
        return out

    setattr(obj, name, wrapper)


def phase_cli(models, workdir, smi):
    """The port's CLI at bench width, through its in-memory cores (this
    machine may lack h5py, which the CLI's files need):

    (a) config.txt parsed by build_arg_parser / options_from_args, each
        sampler built by the factory (cli.make_sampler) over `one`;
    (b) resume identity: U runs 40 samples (boundaries after 10 and 20),
        A the first 10 with a checkpoint file, B resumes A's checkpoint to
        40; A + B must equal U bit for bit, and B's acceptance counters
        U's; U carries the console progress indicator;
    (c) the predict core on U's stored second half (20 x 8192 rows, B1)
        against U's stored log-likelihoods, and on the second half of
        65,536 prior draws of `one_transit` (32,768 rows, B2); each
        against the port on the CPU (float64, plain versions) on
        CLI_CPU_ROWS rows;
    (d) the importance sampler from the factory, batches of 65,536 on
        `one`, for 20,000 samples or CLI_IS_ROUNDS batches;
    (e) the bcmopt core on U's stored samples at 8 x 64 chains, with a
        prior that leaves CLI_FIXED at each stored sample's value."""
    import importlib.util
    import io
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from bcm3_tpu_torch import Prior, VariableSet, cli
    from bcm3_tpu_torch.io.config import build_arg_parser, options_from_args

    cfg = os.path.join(workdir, "config.txt")
    with open(cfg, "w") as f:
        f.write(CLI_CONFIG)
    opts = options_from_args(build_arg_parser().parse_args(["-c", cfg]))
    prior, lik = models["one"]
    E, S = int(opts["ptmhsampler.num_ensembles"]), int(opts["sampler.num_samples"])

    # (b) U, A, B
    progress = io.StringIO()
    u = cli.make_sampler(opts, prior, lik, progress_stream=progress)
    t0 = time.perf_counter()
    full = u.run()
    u_seconds = time.perf_counter() - t0
    assert u.adaptations_done == 2 and full["samples"].shape == (S * E, 1, prior.num_variables)
    lines = [ln.strip() for ln in progress.getvalue().replace("\r", "\n").splitlines()]
    log(f"cli_one U: {S} samples of {NUM_CHAINS} x {E} chains in {u_seconds:.3f} s, "
        f"{full['evaluations']} evaluations; progress: {[ln for ln in lines if ln][-1]}")

    ck = os.path.join(workdir, "state.ckpt")
    saves, restores = [], []
    a = cli.make_sampler(dict(opts, **{"sampler.num_samples": str(CLI_INTERRUPT),
                                       "ptmhsampler.checkpoint_file": ck}), prior, lik,
                         progress_stream=io.StringIO())
    timed_calls(a, "_save_checkpoint", saves)
    part1 = a.run()
    nbytes = os.path.getsize(ck)
    b = cli.make_sampler(dict(opts, **{"ptmhsampler.checkpoint_file": ck}), prior, lik,
                         progress_stream=io.StringIO())
    timed_calls(b, "_save_checkpoint", saves)
    timed_calls(b, "_restore_checkpoint", restores)
    part2 = b.run()
    for k in ("samples", "log_prior", "log_likelihood"):
        joined = np.concatenate([part1[k], part2[k]])
        assert np.array_equal(joined, full[k]), f"cli_one: resumed {k} differ from U's"
    for k, v in full["acceptance"].items():
        assert np.array_equal(part2["acceptance"][k], v), f"cli_one: resumed {k} differ"
    assert part2["adaptation_boundaries"] == 2
    log(f"cli_one resume: A {CLI_INTERRUPT} + B {S - CLI_INTERRUPT} samples equal U's bit for "
        f"bit (samples, log-priors, log-likelihoods, acceptance counters); checkpoint "
        f"{nbytes} bytes (history {tuple(b.state.history.shape)} float32); "
        f"{len(saves)} saves of {min(saves):.3f}-{max(saves):.3f} s, restore "
        f"{restores[0]:.3f} s; on {smi}")
    del a, b, part1, part2

    # (c) predict core
    samples = full["samples"]
    pred, n_eval, seconds = cli.predict_core(opts, lik, samples)
    half = np.arange(len(samples) // 2, len(samples))
    stored = full["log_likelihood"][half, 0].astype(np.float64)
    got = pred[half, 0]
    rel = np.abs(got - stored) / np.abs(stored)
    log(f"cli_one predict one: {n_eval} rows in {seconds:.4f} s = {n_eval / seconds:.1f} evals/s; "
        f"against U's stored log-likelihoods: {int((got == stored).sum())} equal, max rel "
        f"{rel.max():.3e} (limit 1e-5); on {smi}")
    assert rel.max() <= 1e-5
    picked = half[:: len(half) // CLI_CPU_ROWS][:CLI_CPU_ROWS]
    rows = torch.as_tensor(samples[picked, 0], dtype=torch.float64)
    card_vs_cpu("cli_one predict one, card vs CPU", "one", lik, rows, pred[picked, 0])

    tprior, tlik = models["one_transit"]
    gen = torch.Generator(device=opts["device"]).manual_seed(11)
    draws = tprior.sample(gen, (2 * CLI_TRANSIT_ROWS,), torch.float32).cpu().numpy()[:, None, :]
    tpred, t_eval, t_seconds = cli.predict_core(opts, tlik, draws)
    log(f"cli_one predict one_transit: {t_eval} rows in {t_seconds:.4f} s = "
        f"{t_eval / t_seconds:.1f} evals/s; on {smi}")
    picked = slice(CLI_TRANSIT_ROWS, CLI_TRANSIT_ROWS + CLI_CPU_ROWS)
    rows = torch.as_tensor(draws[picked, 0], dtype=torch.float64)
    card_vs_cpu("cli_one predict one_transit, card vs CPU", "one_transit", tlik, rows,
                tpred[picked, 0])

    # (d) importance sampler
    is_opts = dict(opts, **{"sampler.type": "is", "issampler.batch_size": "65536",
                            "sampler.num_samples": "20000", "sampler.use_every_nth": "1"})
    sampler = cli.make_sampler(is_opts, prior, lik)
    sampler.config = dataclasses.replace(sampler.config, max_rounds=CLI_IS_ROUNDS)
    res = sampler.run()
    kept = len(res["weights"])
    assert kept >= 1 and np.array_equal(res["weights"], np.exp(res["log_likelihood"]))
    assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
    log(f"cli_one importance sampler: {res['num_evaluations']} draws in "
        f"{res['elapsed_seconds']:.3f} s = {res['num_evaluations'] / res['elapsed_seconds']:.1f} "
        f"evals/s, {kept} rows kept of the 20000 asked (log-likelihoods of the kept rows "
        f"{res['log_likelihood'].min():.2f} to {res['log_likelihood'].max():.2f}); on {smi}")

    # (e) bcmopt core, with a prior that leaves CLI_FIXED at its stored values
    tree = ET.parse(os.path.join(workdir, "prior_one.xml"))
    tree.getroot().remove(next(v for v in tree.getroot() if v.get("name") == CLI_FIXED))
    tree.write(os.path.join(workdir, "prior_bcmopt.xml"))
    bvs = VariableSet.from_xml(os.path.join(workdir, "prior_bcmopt.xml"))
    bprior = Prior.from_xml(os.path.join(workdir, "prior_bcmopt.xml"), bvs)
    bopts = dict(opts, **{"ptmhsampler.num_ensembles": "64", "sampler.num_samples": "10",
                          "bcmopt.num_samples": "2"})
    stored = {"samples": samples.astype(np.float64), "variables": prior.varset.names,
              "variable_transform": prior.varset.transforms, "temperatures": full["temperatures"]}
    t0 = time.perf_counter()
    result = cli.bcmopt_core(bopts, bprior, lik, stored)
    b_seconds = time.perf_counter() - t0
    assert result["fixed_names"] == [CLI_FIXED]
    fixed_ix = prior.varset.names.index(CLI_FIXED)
    maps = np.stack([r["map_sample"] for r in result["rows"]]).astype(np.float64)
    full_maps = np.insert(maps, fixed_ix, [r["fixed"][0] for r in result["rows"]], axis=1)
    want = (bprior.log_pdf(torch.as_tensor(maps))
            + lik.log_prob_batched(torch.as_tensor(full_maps))).numpy()
    got = np.array([r["map_lposterior"] for r in result["rows"]])
    # float32 on the card against float64 on the CPU, as card_vs_cpu's `one`
    assert len(got) == 2 and np.all(np.abs(got - want) <= 1e-3 * np.abs(want)), (got, want)
    log(f"cli_one bcmopt: {len(got)} samplers of {NUM_CHAINS} x 64 chains, {CLI_FIXED} fixed at "
        f"the stored samples' values, in {b_seconds:.3f} s; MAP log posteriors {got.tolist()} "
        f"(the CPU, float64, at the MAP values: {want.tolist()})")
    h5py = importlib.util.find_spec("h5py") is not None
    log(f"cli_one files: this phase writes no output.nc, prediction.nc, sampler_adaptation.nc "
        f"or TSV: the CLI's file ends need h5py, which is {'' if h5py else 'not '}importable "
        "here; tests/test_torch_cli.py holds those files to the JAX CLI's on the CPU")

def phase_em(res, smi):
    """The batched EM on the card against the same code on the CPU, both
    float64, from the same k-means++ starts (one host seed), on histories
    of the adapted run's T=1 rows. The two fits run at once, the CPU's in a
    second thread.

    A fit's course (the step it stops at, converged or singular) turns on
    the M-step's singular test. For a component with about D points or
    fewer that test compares eigenvalues that are 0 up to eigh's rounding,
    and cuSOLVER and the CPU's LAPACK may decide it apart; the fit then
    takes another course, and the history may select another fit. Each fit
    reports its edge, the least margin of that test it met (in units of
    the test's tolerance). Limits: every fit whose course differs met the
    edge (below EM_EDGE on the card or the CPU); every fit with the same
    course agrees in means, covariances and weights within EM_RTOL (atol
    EM_RTOL times the array's largest entry: entries near 0 carry the fit's
    absolute rounding); every history none of whose fits differ in course
    selects the same component count, with parameters within EM_RTOL."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from bcm3_tpu_torch.stats import gmm_device as gd

    rows = res["samples"][:, -1, :].astype(np.float64)
    rng = np.random.default_rng(11)
    hs = [rows[rng.choice(len(rows), EM_ROWS, replace=False)] for _ in range(EM_HISTORIES)]
    metas, candidates, fits, fit_meta = gd._prepare_fits(hs, np.random.default_rng(5))
    stats = {"cuda": {}, "cpu": {}}
    seconds = {}

    def run(dev):
        t0 = time.perf_counter()
        per_fit = gd._run_fits(metas, fits, fit_meta, dev, stats[dev])
        seconds[dev] = time.perf_counter() - t0
        return per_fit

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 1))  # a core for the card's thread
    try:
        with ThreadPoolExecutor(1) as pool:
            cpu = pool.submit(run, "cpu")
            per = {"cuda": run("cuda"), "cpu": cpu.result()}
    finally:
        torch.set_num_threads(threads)

    a, b = per["cuda"], per["cpu"]
    differs = np.zeros(len(fits), dtype=bool)
    for f in ("converged", "singular", "steps"):
        differs |= a[f] != b[f]
    edge = np.minimum(a["edge"], b["edge"]) < EM_EDGE
    worst = 0.0  # per fit: max |card - CPU| over max |CPU| of each array
    for f in ("means", "covs", "weights"):
        x, y = a[f][~differs], b[f][~differs]
        if x.size:
            axes = tuple(range(1, x.ndim))
            worst = max(worst, float(np.max(np.abs(x - y).max(axis=axes)
                                            / np.abs(y).max(axis=axes))))
    sel = {dev: gd._select_fits(metas, candidates, fit_meta, per[dev], False)
           for dev in per}
    ks = {dev: [0 if g is None else g.num_components for g in sel[dev]] for dev in sel}
    pos = np.asarray([p for p, _ in fit_meta])
    clean = [p for p in range(EM_HISTORIES) if not differs[pos == p].any()]
    kf = np.asarray([k for _, k in fit_meta])

    def per_k(mask):
        return {int(k): int(mask[kf == k].sum()) for k in np.unique(kf)}

    log(f"EM card vs CPU: {EM_HISTORIES} histories of {EM_ROWS} x {rows.shape[1]}, "
        f"{len(fits)} fits (per k {stats['cpu']['fits']}), {int(edge.sum())} at the singular "
        f"test's edge (margin < {EM_EDGE:g} on either), {int(differs.sum())} of another "
        f"course (card singular {int(a['singular'].sum())}, CPU {int(b['singular'].sum())}), "
        f"of those at the edge {int((differs & edge).sum())} (per k: at the edge "
        f"{per_k(edge)}, of another course {per_k(differs)}); same-course fits: worst "
        f"|card - CPU| / max |CPU| per fit of means, covariances, weights {worst:.3e} (limit "
        f"{EM_RTOL}); components chosen card {ks['cuda']} / CPU {ks['cpu']}, histories "
        f"with no fit of another course {clean}; card {seconds['cuda']:.3f} s "
        f"(torch.linalg.eigh {stats['cuda']['eigh_seconds']:.3f} s, batched EM steps "
        f"{stats['cuda']['em_steps']}), CPU {seconds['cpu']:.3f} s (torch.linalg.eigh "
        f"{stats['cpu']['eigh_seconds']:.3f} s), run at once; on {smi}")
    eigh_backends(hs, smi)
    assert not (differs & ~edge).any(), (
        f"EM: {int((differs & ~edge).sum())} fits took another course away from the edge")
    assert worst <= EM_RTOL, f"EM card vs CPU: same-course fits differ by {worst}"
    for p in clean:
        g, h = sel["cuda"][p], sel["cpu"][p]
        assert ks["cuda"][p] == ks["cpu"][p], f"EM history {p}: components {ks}"
        for f in ("means", "covariances", "weights"):
            if h is not None:
                np.testing.assert_allclose(
                    getattr(g, f), getattr(h, f), rtol=EM_RTOL,
                    atol=EM_RTOL * np.abs(getattr(h, f)).max(), err_msg=f"EM history {p}: {f}")


def eigh_backends(hs, smi):
    """torch.linalg.eigh on the boundary EM's largest batch of one step
    (k = 13: the 7 heated positions x 4 retries x 13 components, 40 x 40
    float64 correlation matrices) under each CUDA linear-algebra backend of this torch build,
    and on the CPU: the eigenvalues agree, and the times say what a
    faster EM would have to beat."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    n, D = (NUM_CHAINS - 1) * 4 * 13, hs[0].shape[1]
    x = rng.normal(size=(n, 3 * D, D)) @ (np.eye(D) + 0.3 * rng.normal(size=(D, D)))
    cov = np.einsum("bni,bnj->bij", x, x)
    sd = np.sqrt(np.einsum("bii->bi", cov))
    corr = torch.as_tensor(cov / (sd[:, :, None] * sd[:, None, :]), device="cuda")
    cpu = corr.cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        ref = torch.linalg.eigvalsh(cpu)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / 3
    times = {}
    libs = ["cusolver"] + (["magma"] if torch.cuda.has_magma else [])
    try:
        for lib in libs:
            torch.backends.cuda.preferred_linalg_library(lib)
            times[lib] = cuda_ms(lambda: torch.linalg.eigh(corr), 3)
            err = (torch.linalg.eigh(corr)[0].cpu() - ref).abs().max().item()
            assert err <= 1e-10 * ref.abs().max().item(), f"eigh under {lib}: {err}"
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    log(f"torch.linalg.eigh of {n} {D} x {D} float64 matrices (one EM step at k = 13): "
        + ", ".join(f"{lib} {ms:.3f} ms" for lib, ms in times.items())
        + ("" if torch.cuda.has_magma else ", magma not in this torch build")
        + f", CPU {cpu_ms:.3f} ms ({torch.get_num_threads()} threads); on {smi}")


def device_profile(fn):
    """(device busy ms, device operations, the profile's seconds) of one
    fn() under the profiler, tracing the device only (the host's operator
    events would double the events to process). Raises if the trace holds
    no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert device, "the profiler traced no device event"
    return (sum(e.time_range.elapsed_us() for e in device) / 1e3, len(device),
            time.perf_counter() - t)


def profile_sampling(sampler, iterations):
    """One run() under torch.profiler. Returns the device's busy time per
    iteration (kernels, copies and sets that ran within the sampler's
    "SamplerPT.sampling" span, so without the start-position search; one
    stream, so they do not overlap) and the 8 largest entries of it by
    kernel; (None, []) where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # run() ends with copies to the host, so its device work is done
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.run()
    events = prof.events()
    spans = [e for e in events
             if e.name == "SamplerPT.sampling" and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        return None, []
    start, end = spans[0].time_range.start, spans[0].time_range.end
    by_kernel = {}
    for e in events:
        # the span's own device-side record is a range, not work
        if e.device_type != DeviceType.CUDA or e.name == "SamplerPT.sampling":
            continue
        if start <= e.time_range.start <= end:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_kernel.values()) / 1e3 / iterations
    top = sorted(((k, v / 1e3 / iterations) for k, v in by_kernel.items()),
                 key=lambda kv: -kv[1])[:8]
    return (busy, top) if busy > 0 else (None, [])


def phase_oracle(pk_type, workdir):
    """The port on the card against the port on the CPU (plain versions)."""
    import torch

    prior, lik = build_model(pk_type, workdir)
    xs = prior.sample(torch.Generator().manual_seed(5), (ORACLE_DRAWS,), torch.float64)
    card = lik.log_prob_batched(xs.to("cuda", torch.float32)).double().cpu().numpy()
    card_vs_cpu(f"card vs CPU {pk_type}", pk_type, lik, xs, card)


def card_vs_cpu(name, pk_type, lik, xs, card):
    """The card's log-likelihoods `card` (float64 numpy) at the rows `xs`
    (a float64 CPU tensor) against the port on the CPU (float64, plain
    versions), within the tolerances of the model: `one`, `two` and the
    biphasic models float32 against float64 on every row, the transit
    models a float32 adaptive solve against the CPU's."""
    import numpy as np

    n = len(xs)
    transit = pk_type in ("one_transit", "two_transit")
    cpu = lik.log_prob_batched(xs).numpy()
    # prior draws can put a rate such as ka = 10^(mu + sigma * ndtri(u))
    # beyond float32's range (sigma is half-Cauchy); such a row is -inf in
    # float32 and may be finite in float64, so the finite sets are compared
    # on the rows whose rates fit in float32
    params, _, _ = lik.model._patient_params(xs)
    fits = np.ones(n, dtype=bool)
    for v in params.values():
        v = v.reshape(n, -1).abs().numpy()
        fits &= (v < np.finfo(np.float32).max).all(axis=1)
    fin_cpu, fin_card = np.isfinite(cpu), np.isfinite(card)
    beyond = int((~fits).sum())
    if pk_type != "one" and not transit:
        # the two-compartment closed form leaves float32's range on some
        # rows whose rates fit in it (tr * tr in _expm_2x2, det_p of the
        # particular solution); the JAX package's float32 path scores -inf
        # on the same rows (tests/test_torch_poppk.py::
        # test_float32_range_matches_jax). There the card is held to the
        # CPU's float32 finite set, elsewhere to its float64
        fin32 = np.isfinite(lik.log_prob_batched(xs.float()).numpy())
        f32_range = fits & (fin32 != fin_cpu)
        off = int((fin32 != fin_card)[f32_range].sum())
        log(f"{name}: {int(f32_range.sum())} rows leave float32's range with rates inside "
            f"it, {off} of them with another finite set on the card than the CPU's float32")
        assert off == 0
        fits &= ~f32_range
    mismatched = int((fin_cpu != fin_card)[fits].sum())
    both = fin_cpu & fin_card
    rel = np.abs(card[both] - cpu[both]) / np.abs(cpu[both])
    if not transit:
        # every row, within float32's rounding of the closed form
        rtol, share, limit = 1e-3, 1.0, 0
    else:
        # the card solves in float32 (one_transit's CPU too: B2's plain
        # version always does; two_transit's DP5 takes the rows' dtype, so
        # the CPU solves in float64): a float32 adaptive solve at rtol 1e-6
        # takes another step sequence on a small share of lanes when the
        # last bits differ, so >= 95% of the rows within rtol 5e-3 (as
        # tests/test_poppk_pallas.py:115-134), <= 5% finite-set flips
        rtol, share, limit = 5e-3, 0.95, n // 20
    within = float((rel <= rtol).mean())
    log(f"{name}: {int(both.sum())}/{n} finite on both, "
        f"{beyond} rows with rates beyond float32, {mismatched} "
        f"finite-set mismatches among the others (limit {limit}), {within:.4f} of "
        f"rows within rtol {rtol} (limit {share}), max rel err {rel.max():.3e}, "
        f"median {np.median(rel):.3e}")
    assert both.sum() >= n // 10
    assert mismatched <= limit
    assert within >= share


# ---------------------------------------------------------------------------
# The gradient and population samplers (phases 16-21)


def sampler_profile(step, transitions, profiled=True):
    """`step()` (one transition from a fixed state with fixed draws, so the
    work is the same each call) once to warm up, then `transitions` times:
    the wall per call (host clock, synchronized); with `profiled`, as many
    times more under torch.profiler: the device's busy time per call
    (events inside the span), the launches, B1's and B1T's share of the
    busy time. Busy is None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(transitions):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / transitions
    if not profiled:
        return dict(wall_ms=wall_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.transitions"):
            for _ in range(transitions):
                step()
            torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name != "chip_smoke.transitions"]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / transitions
    if busy <= 0:
        return dict(wall_ms=wall_ms, busy_ms=None, launches=None, b1_ms=None, b1t_ms=None,
                    b2j_ms=None)

    def share(name):
        return sum(e.time_range.elapsed_us() for e in device
                   if name in e.name) / 1e3 / transitions

    return dict(wall_ms=wall_ms, busy_ms=busy, launches=len(device) / transitions,
                b1_ms=share("poppk_propagate_kernel"),
                b1t_ms=share("poppk_propagate_adjoint_kernel"),
                b2j_ms=share("transit_dp5_tangent_kernel"))


def log_profile(name, prof, unit, per_unit, smi):
    """One line of a sampler_profile result: per transition and per `unit`
    (leaf, leapfrog step) of which there are `per_unit` per transition."""
    if prof["busy_ms"] is None:
        log(f"{name}: wall {prof['wall_ms']:.3f} ms per transition; device busy not measured "
            f"(the profiler saw no device time); on {smi}")
        return
    idle = 1.0 - prof["busy_ms"] / prof["wall_ms"]
    log(f"{name}: wall {prof['wall_ms']:.3f} ms per transition, device busy "
        f"{prof['busy_ms']:.3f} ms (idle share {idle:.4f}); {per_unit:.2f} {unit}s per "
        f"transition, {prof['launches'] / per_unit:.1f} device launches per {unit}, wall "
        f"{prof['wall_ms'] / per_unit:.4f} ms per {unit}; B1 {prof['b1_ms']:.4f} ms and B1T "
        f"{prof['b1t_ms']:.4f} ms of the busy time per transition, the rest "
        f"{prof['busy_ms'] - prof['b1_ms'] - prof['b1t_ms']:.3f} ms (eager elementwise work, "
        f"the sampler's own); on {smi}")


def nuts_ess(res, seconds):
    """bench.py bench_nuts's ESS: per-chain ESS of the first 256 chains'
    traces (FFT-batched), mean over variables, times the chains, over the
    sampling loop's seconds. A chain that never moved (it started at a
    point of -inf density, see phase_nuts_one, or rejected every proposal,
    see phase_hmc_one) has a constant trace, which the formula counts as S
    effective samples; the same ESS over the chains that moved is given
    beside it, and the count of those that did not."""
    import numpy as np

    from bcm3_tpu_torch.analysis import effective_sample_size_batched

    x = res["samples_per_chain"]  # (S, C, D)
    S, C, D = x.shape
    stuck = (x == x[:1]).all(axis=(0, 2))
    Csub = min(C, 256)
    ess = effective_sample_size_batched(
        np.ascontiguousarray(x[:, :Csub, :].reshape(S, Csub * D), dtype=np.float64)
    ).reshape(Csub, D)
    per_var = ess.mean(axis=0)
    moving = ess[~stuck[:Csub]].mean(axis=0)
    return dict(ess_per_chain_mean=float(per_var.mean()),
                ess_per_sec=float(per_var.mean()) * C / seconds,
                ess_min_var_per_sec=float(per_var.min()) * C / seconds,
                stuck_chains=int(stuck.sum()),
                moving_ess_per_sec=float(moving.mean()) * int((~stuck).sum()) / seconds)


def check_gradient_run(name, res, S, C, D, stuck_limit=0.1):
    """The emitted rows of a NUTS or HMC run on `one`: shapes, finite
    positions, and the chains that never moved. The samplers start from
    prior draws, as the JAX package's do; a draw whose rate lies beyond
    float32 (about 3% of them) has density -inf and, its gradient NaN, a
    chain started there may never leave (ROADMAP C), its stored densities
    -inf. At most `stuck_limit` of the chains may stay where they were
    through the stored samples (NUTS); for HMC the count is only logged
    (phase_hmc_one). Returns the ESS of nuts_ess."""
    import numpy as np

    assert res["samples"].shape == (S * C, 1, D)
    assert np.isfinite(res["samples"]).all()
    finite = np.isfinite(res["log_prior"] + res["log_likelihood"]).reshape(S, C)
    ess = nuts_ess(res, res["sampling_seconds"])
    log(f"{name}: {ess['stuck_chains']} of {C} chains never moved, "
        f"{int((~finite.all(axis=0)).sum())} chains with -inf stored densities")
    assert finite.all(axis=0).mean() >= 0.9
    assert stuck_limit is None or ess["stuck_chains"] <= stuck_limit * C
    return ess


def phase_nuts_one(models, smi):
    """bench.py bench_nuts on the card: NUTS on `one`, 2,048 chains, max tree
    depth 7, target acceptance 0.9, seed 5, float32, every leaf one
    gradient evaluation through B1 and B1T; warmup and samples cut (§4)."""
    import torch

    from bcm3_tpu_torch.ops import poppk_kernels
    from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS

    prior, lik = models["one"]
    cfg = NUTSConfig(num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES, device=CARD,
                     dtype=torch.float32, **NUTS_ONE)
    s = SamplerNUTS(prior, lik, cfg)
    res = s.run()
    C, S = cfg.num_chains, cfg.num_samples
    ess = check_gradient_run("nuts_one", res, S, C, prior.num_variables)
    evals = res["gradient_evaluations_per_transition"]
    grad_per_s = evals * S / res["sampling_seconds"]
    log(f"nuts_one: {C} chains, {cfg.num_warmup} warmup + {S} sampling transitions, run "
        f"{res['elapsed_seconds']:.3f} s, sampling {res['sampling_seconds']:.3f} s; ESS per "
        f"chain {ess['ess_per_chain_mean']:.4f} of {S}, ESS/s {ess['ess_per_sec']:.1f} (worst "
        f"variable {ess['ess_min_var_per_sec']:.1f}; over the chains that moved "
        f"{ess['moving_ess_per_sec']:.1f}); divergence rate "
        f"{res['divergences'] / (S * C):.5f}; mean tree depth {res['mean_tree_depth']:.4f}; "
        f"step size {res['step_size']:.5g}; {evals:.2f} gradient evaluations (of all {C} "
        f"chains) and {res['host_syncs_per_transition']:.2f} host reads per transition, "
        f"{grad_per_s:.1f} gradient evaluations/s = {grad_per_s * C:.1f} chain gradients/s; "
        f"launches so far B1 {poppk_kernels.propagate_intervals_one_compartment.launches}, "
        f"B1T {poppk_kernels.propagate_intervals_adjoint.launches}; on {smi}")
    # more transitions from where the run ended, with fixed draws: the wall
    # of full trees; then, for the profile (whose trace of a full tree's
    # ~85,000 device events takes minutes to process), trees cut at depth
    # PROFILED_DEPTH from the same state: a leaf runs the same operations
    # at any depth
    z, lp, g = s.state
    D = z.shape[1]
    draws = s.draws(C, D, torch.float32)
    before = s.target.gradient_evaluations
    full = sampler_profile(
        lambda: s.transition(z, lp, g, s.step_size, s.inv_mass, *draws), PROFILED_TRANSITIONS,
        profiled=False)
    leaves = (s.target.gradient_evaluations - before) / (PROFILED_TRANSITIONS + 1)
    short = SamplerNUTS(prior, lik, dataclasses.replace(cfg, max_tree_depth=PROFILED_DEPTH))
    draws = short.draws(C, D, torch.float32)
    before = short.target.gradient_evaluations
    prof = sampler_profile(
        lambda: short.transition(z, lp, g, s.step_size, s.inv_mass, *draws),
        PROFILED_TRANSITIONS)
    short_leaves = (short.target.gradient_evaluations - before) / (2 * PROFILED_TRANSITIONS + 1)
    log(f"nuts_one: full trees from the run's end: {leaves:.1f} leaves, wall "
        f"{full['wall_ms']:.3f} ms a transition = {full['wall_ms'] / leaves:.4f} ms a leaf")
    log_profile(f"nuts_one profile (trees cut at depth {PROFILED_DEPTH})", prof, "leaf",
                short_leaves, smi)
    return dict(res=res, ess=ess, profile=prof, leaves=short_leaves, grad_per_s=grad_per_s,
                leaf_wall_ms=full["wall_ms"] / leaves)


def finite_gradients_at(target, lik, z):
    """The gradient of a transit model's posterior at rows z (C, D): (the
    rows of finite density whose rates lie inside float32, those of them
    with a non-finite gradient). A rate beyond float32 has a finite density
    in which it no longer enters, and a NaN gradient, as in the JAX
    package; phase_gradient_card_vs_cpu counts such rows."""
    import torch

    v, g = target.value_and_grad(z)
    params, _, _ = lik.model._patient_params(target.reparam.to_x(z))
    fits = torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    for p in params.values():
        fits &= torch.isfinite(p.reshape(z.shape[0], -1)).all(dim=1)
    fin = torch.isfinite(v) & fits
    return int(fin.sum()), int((~torch.isfinite(g[fin]).all(dim=1)).sum())


def phase_nuts_one_transit(models, smi):
    """NUTS on `one_transit` at bench_nuts's width: 2,048 chains, target
    acceptance 0.9, seed 5, float32, max tree depth 5 (NUTS_ONE_TRANSIT),
    NUTS_TRANSIT_WARMUP + NUTS_TRANSIT_SAMPLES transitions from prior draws
    of finite density, every leaf one gradient evaluation through kernel
    B2J (the likelihood's gradient mode). Asserts that the chains move and
    that the gradient is finite wherever the density is; reports the leaf
    wall, gradient evaluations/s, ESS/s, and B2J's launches and device ms a
    leaf."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.ops import transit_tangent_kernels
    from bcm3_tpu_torch.sampler import NUTSConfig, SamplerNUTS

    prior, lik = models["one_transit"]
    cfg = NUTSConfig(num_warmup=NUTS_TRANSIT_WARMUP, num_samples=NUTS_TRANSIT_SAMPLES,
                     device=CARD, dtype=torch.float32, **NUTS_ONE_TRANSIT)
    s = SamplerNUTS(prior, lik, cfg)
    C, S, D = cfg.num_chains, cfg.num_samples, prior.num_variables
    # The chains start at prior draws of finite density: about half of this
    # trial's prior draws have a lane that fails (density -inf), and such a
    # chain never moves while its diverging leaves drive the step size's
    # adaptation to ~4e-10 (measured on one H100; ROADMAP C). The search: the first
    # C finite of NUTS_START_DRAWS x C draws of the sampler's generator,
    # scored by its target in one evaluation
    x0 = prior.sample(s.generator, (NUTS_START_DRAWS * C,), torch.float32)
    with torch.no_grad():
        fin0 = torch.isfinite(s.target(s.target.reparam.from_x(x0)))
    assert int(fin0.sum()) >= C, "nuts_one_transit: too few prior draws of finite density"
    x0 = x0[fin0.nonzero()[:C, 0]]
    res = s.run(x0)
    assert res["samples"].shape == (S * C, 1, D) and np.isfinite(res["samples"]).all()
    x = res["samples_per_chain"]
    stuck = (x == x[:1]).all(axis=(0, 2))
    finite = np.isfinite(res["log_prior"] + res["log_likelihood"]).reshape(S, C)
    log(f"nuts_one_transit: {int(fin0.sum())} of {NUTS_START_DRAWS * C} prior draws of finite "
        f"density, the first {C} the starts; {int((~stuck).sum())} of {C} chains moved (limit "
        f"{int((1 - NUTS_STUCK_SHARE) * C)}), {int((~finite.all(axis=0)).sum())} with a stored "
        f"density -inf; step size {res['step_size']:.5g}, divergence rate "
        f"{res['divergences'] / (S * C):.5f}, mean tree depth {res['mean_tree_depth']:.4f}")
    assert stuck.sum() <= NUTS_STUCK_SHARE * C
    ess = nuts_ess(res, res["sampling_seconds"])
    evals = res["gradient_evaluations_per_transition"]
    grad_per_s = evals * S / res["sampling_seconds"]
    launches = transit_tangent_kernels.transit_jacobian.launches
    z, _, _ = s.state
    fin, bad = finite_gradients_at(s.target, lik, z)
    log(f"nuts_one_transit: {C} chains, {cfg.num_warmup} warmup + {S} sampling transitions at "
        f"max depth {cfg.max_tree_depth}, run {res['elapsed_seconds']:.3f} s, sampling "
        f"{res['sampling_seconds']:.3f} s; ESS per chain {ess['ess_per_chain_mean']:.4f} of "
        f"{S}, ESS/s {ess['ess_per_sec']:.1f} (worst variable {ess['ess_min_var_per_sec']:.1f}; "
        f"over the chains that moved {ess['moving_ess_per_sec']:.1f}); divergence rate "
        f"{res['divergences'] / (S * C):.5f}; mean tree depth {res['mean_tree_depth']:.4f}; "
        f"step size {res['step_size']:.5g}; {evals:.2f} gradient evaluations a transition, "
        f"{grad_per_s:.1f} gradient evaluations/s; B2J launches {launches} in the run "
        f"({s.target.gradient_evaluations} gradient evaluations); at the run's end "
        f"{fin} rows of finite density with rates inside float32, {bad} of them with "
        f"a non-finite gradient (limit 0); on {smi}")
    assert bad == 0 and fin >= C // 2
    # the wall of a leaf in the run's sampling loop; the profile from where
    # the run ended, on trees cut at PROFILED_DEPTH (a leaf runs the same
    # operations at any depth, and the trace of full trees takes long to
    # process)
    leaf_wall = res["sampling_seconds"] * 1e3 / (evals * S)
    short = SamplerNUTS(prior, lik, dataclasses.replace(cfg, max_tree_depth=PROFILED_DEPTH))
    draws = short.draws(C, D, torch.float32)
    _, lp, g = s.state
    prof = sampler_profile(
        lambda: short.transition(z, lp, g, s.step_size, s.inv_mass, *draws),
        PROFILED_TRANSITIONS)
    leaves = short.target.gradient_evaluations / (2 * PROFILED_TRANSITIONS + 1)
    if prof["busy_ms"] is None:
        log(f"nuts_one_transit: wall {leaf_wall:.3f} ms a leaf in the sampling loop; the "
            f"profile (trees cut at depth {PROFILED_DEPTH}) saw no device time; on {smi}")
    else:
        log(f"nuts_one_transit: wall {leaf_wall:.3f} ms a leaf in the sampling loop; profile "
            f"(trees cut at depth {PROFILED_DEPTH}, {leaves:.2f} leaves a transition): wall "
            f"{prof['wall_ms'] / leaves:.3f} ms a leaf, device busy "
            f"{prof['busy_ms'] / leaves:.3f} ms a leaf (idle share "
            f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.4f}), {prof['launches'] / leaves:.1f} "
            f"device launches a leaf, of which B2J one, {prof['b2j_ms'] / leaves:.4f} ms a leaf; "
            f"on {smi}")
    return dict(res=res, ess=ess, profile=prof, leaves=leaves, grad_per_s=grad_per_s,
                leaf_wall_ms=leaf_wall)


def phase_hmc_one(models, smi):
    """HMC on `one` at bench_nuts's width: 2,048 chains, 16 leapfrog steps,
    float32; warmup and samples cut (§4).

    Its ESS is not a usable metric. The JAX package's HMC adapts one step
    size for all chains to their mean acceptance; chains that started in
    the prior's tails reject every proposal, pull the mean down and so the
    step size too, and over half of them never move (ROADMAP C).
    bench_nuts's formula counts each of them as S effective samples. The
    phase reports that ESS beside the ESS over the chains that moved and
    the count that did not, and claims neither; what it measures is the
    leapfrog's throughput."""
    import torch

    from bcm3_tpu_torch.sampler import HMCConfig, SamplerHMC

    prior, lik = models["one"]
    cfg = HMCConfig(num_warmup=HMC_WARMUP, num_samples=HMC_SAMPLES, device=CARD,
                    dtype=torch.float32, **HMC_ONE)
    s = SamplerHMC(prior, lik, cfg)
    res = s.run()
    C, S = cfg.num_chains, cfg.num_samples
    ess = check_gradient_run("hmc_one", res, S, C, prior.num_variables, stuck_limit=None)
    assert 0.0 < res["accept_rate"] <= 1.0
    steps_per_s = res["gradient_evaluations"] / res["sampling_seconds"]
    log(f"hmc_one: {C} chains, {cfg.num_leapfrog_steps} leapfrog steps, {cfg.num_warmup} "
        f"warmup + {S} sampling iterations, run {res['elapsed_seconds']:.3f} s, sampling "
        f"{res['sampling_seconds']:.3f} s; acceptance {res['accept_rate']:.4f}, step size "
        f"{res['step_size']:.5g}; ESS per chain {ess['ess_per_chain_mean']:.4f} of {S}, ESS/s "
        f"{ess['ess_per_sec']:.1f} by bench_nuts's formula, {ess['moving_ess_per_sec']:.1f} "
        f"over the {C - ess['stuck_chains']} chains that moved (neither usable: phase_hmc_one); "
        f"{steps_per_s:.1f} leapfrog steps/s = "
        f"{steps_per_s * C:.1f} chain gradients/s; on {smi}")
    z, lp, g = s.state
    short = SamplerHMC(prior, lik, dataclasses.replace(cfg,
                                                       num_leapfrog_steps=HMC_PROFILED_LEAPFROG))
    draws = short.draws(C, z.shape[1], torch.float32)
    prof = sampler_profile(lambda: short.step(z, lp, g, s.step_size, s.inv_mass, *draws),
                           PROFILED_TRANSITIONS)
    log_profile(f"hmc_one profile (steps of {HMC_PROFILED_LEAPFROG} leapfrog steps)", prof,
                "leapfrog step", HMC_PROFILED_LEAPFROG, smi)
    return dict(res=res, ess=ess, profile=prof, steps_per_s=steps_per_s)


def phase_hmc_one_transit(models, smi):
    """HMC on `one_transit` at hmc_one's configuration (HMC_ONE: 2,048
    chains, 16 leapfrog steps, seed 5, float32), HMC_TRANSIT_WARMUP +
    HMC_TRANSIT_SAMPLES iterations, every leapfrog step one gradient
    evaluation of 32,768 lanes through kernel B2J (float32, n = 2, K = 5).
    The chains start at prior draws, as the JAX package's do; about half of
    this trial's have density -inf (ROADMAP C). From there h1 - h0 is +inf
    where the trajectory ends at a finite density (accepted) and NaN where
    it ends at -inf (a rejection), as in the JAX package's hmc.py
    (tests/test_torch_hmc.py); the port's gradient 0 at such a row (its
    recorded departure) lets the trajectory move, where the JAX package's
    NaN would not. Asserts the samples' shape, finite samples and a finite
    gradient wherever the density is finite and the rates lie inside
    float32. Reports throughput, not ESS (HMC adapts one step size for all
    chains, ROADMAP C): leapfrog steps/s, chain gradients/s, the
    acceptance, the step size, the chains that never moved and what became
    of those that started at -inf, and B2J's launches and device ms a
    leapfrog step from the profile of steps cut to HMC_PROFILED_LEAPFROG."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.ops import transit_tangent_kernels
    from bcm3_tpu_torch.sampler import HMCConfig, SamplerHMC

    prior, lik = models["one_transit"]
    cfg = HMCConfig(num_warmup=HMC_TRANSIT_WARMUP, num_samples=HMC_TRANSIT_SAMPLES,
                    device=CARD, dtype=torch.float32, **HMC_ONE)
    C, S, D = cfg.num_chains, cfg.num_samples, prior.num_variables
    # the starts run() draws: a sampler's first draw from its seeded generator
    probe = SamplerHMC(prior, lik, cfg)
    with torch.no_grad():
        z0 = probe.target.reparam.from_x(prior.sample(probe.generator, (C,), torch.float32))
        start_finite = torch.isfinite(probe.target(z0)).cpu().numpy()
    s = SamplerHMC(prior, lik, cfg)
    res = s.run()
    assert res["samples"].shape == (S * C, 1, D) and np.isfinite(res["samples"]).all()
    x = res["samples_per_chain"]
    stuck = (x == x[:1]).all(axis=(0, 2))
    z, lp, g = s.state
    end_finite = torch.isfinite(lp).cpu().numpy()
    steps_per_s = res["gradient_evaluations"] / res["sampling_seconds"]
    launches = transit_tangent_kernels.transit_jacobian.launches
    fin, bad = finite_gradients_at(s.target, lik, z)
    log(f"hmc_one_transit: {C} chains, {cfg.num_leapfrog_steps} leapfrog steps, "
        f"{cfg.num_warmup} warmup + {S} sampling iterations, run {res['elapsed_seconds']:.3f} s, "
        f"sampling {res['sampling_seconds']:.3f} s; acceptance {res['accept_rate']:.4f}, step "
        f"size {res['step_size']:.5g}; {int(stuck.sum())} of {C} chains never moved in the "
        f"stored samples; {int((~start_finite).sum())} chains started at density -inf, "
        f"{int((~start_finite & end_finite).sum())} of them ended at a finite density; "
        f"{int(end_finite.sum())} chains end finite; {steps_per_s:.1f} leapfrog steps/s = "
        f"{steps_per_s * C:.1f} chain gradients/s (throughput; ESS not claimed: one step size "
        f"for all chains, ROADMAP C); B2J launches {launches} so far in the phase; at the run's "
        f"end {fin} rows of finite density with rates inside float32, {bad} of them with a "
        f"non-finite gradient (limit 0); on {smi}")
    assert bad == 0 and 0.0 <= res["accept_rate"] <= 1.0
    short = SamplerHMC(prior, lik, dataclasses.replace(cfg,
                                                       num_leapfrog_steps=HMC_PROFILED_LEAPFROG))
    draws = short.draws(C, D, torch.float32)
    prof = sampler_profile(lambda: short.step(z, lp, g, s.step_size, s.inv_mass, *draws),
                           PROFILED_TRANSITIONS)
    n = HMC_PROFILED_LEAPFROG
    if prof["busy_ms"] is None:
        log(f"hmc_one_transit profile: wall {prof['wall_ms'] / n:.3f} ms a leapfrog step; the "
            f"profiler saw no device time; on {smi}")
    else:
        log(f"hmc_one_transit profile (steps of {n} leapfrog steps): wall "
            f"{prof['wall_ms'] / n:.3f} ms a leapfrog step, device busy "
            f"{prof['busy_ms'] / n:.3f} ms (idle share "
            f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.4f}), {prof['launches'] / n:.1f} device "
            f"launches a leapfrog step, of which B2J one, {prof['b2j_ms'] / n:.4f} ms; on {smi}")
    return dict(res=res, profile=prof, steps_per_s=steps_per_s, stuck_chains=int(stuck.sum()))


def phase_vi_two_transit(models, smi):
    """VI on `two_transit` at VI_ONE's configuration in float64 (32 samples
    an ELBO over 16 patients: B2J's float64 instance with n = 3, K = 7 at
    512 lanes a launch), its Adam steps cut (VI_TWO_TRANSIT). Asserts a
    finite fitted mean and log-sigma and finite samples; reports the ELBO,
    Adam steps/s, the share of the fitted Gaussian's draws (the 1,000
    emitted) whose density is -inf, and B2J's device ms a step."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.ops import transit_tangent_kernels
    from bcm3_tpu_torch.sampler import SamplerVI, VIConfig

    prior, lik = models["two_transit"]
    cfg = VIConfig(device=CARD, dtype=torch.float64, **VI_TWO_TRANSIT)
    s = SamplerVI(prior, lik, cfg)
    res = s.run()
    D = prior.num_variables
    assert res["samples"].shape == (cfg.num_samples, 1, D)
    assert np.isfinite(res["mean"]).all() and np.isfinite(res["log_sigma"]).all()
    assert np.isfinite(res["samples"]).all()
    minus_inf = float(np.mean(~np.isfinite(res["log_prior"] + res["log_likelihood"])))
    launches = transit_tangent_kernels.transit_jacobian.launches
    mu = torch.as_tensor(res["mean"], device=CARD)
    log_sigma = torch.as_tensor(res["log_sigma"], device=CARD)
    eps = torch.randn((cfg.num_mc_samples, D), generator=s.generator, dtype=torch.float64,
                      device=CARD)
    prof = sampler_profile(lambda: s.fit(mu, log_sigma, [eps]), PROFILED_TRANSITIONS)
    b2j = "not measured" if prof["busy_ms"] is None else f"{prof['b2j_ms']:.4f} ms"
    busy = "not measured" if prof["busy_ms"] is None else f"{prof['busy_ms']:.3f} ms"
    log(f"vi_two_transit: {cfg.num_iterations} Adam steps of {cfg.num_mc_samples} samples x "
        f"{NUM_PATIENTS} patients = {cfg.num_mc_samples * NUM_PATIENTS} lanes a B2J launch "
        f"(float64, n = 3, K = 7), ELBO {res['elbo']:.3f}, fit {res['fit_seconds']:.3f} s = "
        f"{cfg.num_iterations / res['fit_seconds']:.1f} Adam steps/s; share of the fitted "
        f"Gaussian's {cfg.num_samples} draws with density -inf {minus_inf:.4f}; mean sigma "
        f"{float(np.exp(res['log_sigma']).mean()):.4f}; B2J launches {launches} so far in the "
        f"phase; an Adam step (profile): wall {prof['wall_ms']:.3f} ms, device busy {busy}, "
        f"B2J {b2j}; on {smi}")
    return dict(res=res, profile=prof, minus_inf_share=minus_inf)


def phase_smc_one(models, smi):
    """SMC on `one` with 65,536 particles (the PT headline's 8 x 8,192
    chains), float32: every mutation sweep scores the population through
    log_prob_batched, B1 on the card."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import SamplerSMC, SMCConfig

    prior, lik = models["one"]
    cfg = SMCConfig(device=CARD, dtype=torch.float32, **SMC_ONE)
    res = SamplerSMC(prior, lik, cfg).run()
    assert res["samples"].shape == (cfg.num_particles, 1, prior.num_variables)
    assert res["betas"][-1] == 1.0 and np.isfinite(res["log_marginal_likelihood"])
    assert np.isfinite(res["log_prior"] + res["log_likelihood"]).all()
    evals = cfg.num_particles * (1 + cfg.mutation_steps * res["stages"])
    log(f"smc_one: {cfg.num_particles} particles, {res['stages']} stages, betas "
        f"{[round(b, 6) for b in res['betas']]}, log evidence "
        f"{res['log_marginal_likelihood']:.4f}, last stage's acceptance "
        f"{res['acceptance'][-1]:.4f}; {res['elapsed_seconds']:.3f} s = "
        f"{evals / res['elapsed_seconds']:.1f} evals/s; on {smi}")
    return dict(res=res, evals_per_second=evals / res["elapsed_seconds"])


def phase_vi_one(models, smi):
    """VI on `one` with the JAX package's defaults (32 Monte Carlo samples
    per ELBO, Adam at 0.05, 1,000 draws), float64 (B1 and B1T's float64
    variants), iterations cut (§4)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import SamplerVI, VIConfig

    prior, lik = models["one"]
    cfg = VIConfig(device=CARD, dtype=torch.float64, **VI_ONE)
    res = SamplerVI(prior, lik, cfg).run()
    assert res["samples"].shape == (cfg.num_samples, 1, prior.num_variables)
    assert np.isfinite(res["elbo"]) and np.isfinite(res["samples"]).all()
    log(f"vi_one: {cfg.num_iterations} Adam steps of {cfg.num_mc_samples} samples, ELBO "
        f"{res['elbo']:.3f}, fit {res['fit_seconds']:.3f} s = "
        f"{cfg.num_iterations / res['fit_seconds']:.1f} gradient evaluations/s; "
        f"mean sigma {float(np.exp(res['log_sigma']).mean()):.4f}; on {smi}")
    return dict(res=res)


def b1t_inputs(models, rows, gen, dtype):
    """B1T's inputs as the gradient path gives them: the posterior's
    gradient of `rows` prior draws on the card, with B1's inputs and the
    gradients flowing into B1's outputs captured on their way to B1T."""
    from bcm3_tpu_torch.likelihoods import poppk
    from bcm3_tpu_torch.ops.poppk_kernels import PropagateOneCompartment
    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    prior, lik = models["one"]
    target = LogPosterior(prior, lik)
    z = target.reparam.from_x(prior.sample(gen, (rows,), dtype))
    seen = {}

    def capture(*inputs):
        gut, cen = PropagateOneCompartment.apply(*inputs)
        seen["args"] = tuple(x.detach() for x in inputs)
        gut.register_hook(lambda t: seen.__setitem__("grad_gut", t))
        cen.register_hook(lambda t: seen.__setitem__("grad_cen", t))
        return gut, cen

    function = poppk.PropagateOneCompartment
    poppk.PropagateOneCompartment = types.SimpleNamespace(apply=capture)
    try:
        target.value_and_grad(z)
    finally:
        poppk.PropagateOneCompartment = function
    return (*seen["args"], seen["grad_gut"].contiguous(), seen["grad_cen"].contiguous())


def graph_ms(fn, reps=50, replays=20):
    """Device milliseconds per call of fn: `reps` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so that no
    host work stands between two launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def host_us(fn, reps=200):
    """Host microseconds per call of fn: the calls enqueued back to back,
    timed on the host clock before the card is waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def b1t_call(args):
    """A call of this tree's B1T on B1T's inputs. A tree from before B1T
    recomputed the forward (its wrapper reads B1's outputs `gut`, `cen`)
    gets them from B1 first, outside the call, so that
    `--b1t-timing TREE` can time an earlier commit's kernel."""
    import inspect

    from bcm3_tpu_torch.ops import poppk_kernels as pk

    if "gut" not in inspect.signature(pk.propagate_intervals_adjoint).parameters:
        return lambda: pk.propagate_intervals_adjoint(*args)
    gut, cen = pk.propagate_intervals_one_compartment(*args[:6])
    old = (*args[:3], args[4], gut, cen, *args[6:])
    return lambda: pk.propagate_intervals_adjoint(*old)


def b1t_times(args):
    """B1T's times on `args`: device ms a launch (`graph_ms`), ms a call
    of back-to-back wrapper calls by CUDA events (the larger of the device
    time and the wrapper's host time), and the wrapper's host µs a call."""
    call = b1t_call(args)
    return dict(ms=graph_ms(call), stream_ms=cuda_ms(call, 50), host_us=host_us(call))


def b1t_bound(args):
    """B1T's bound: the bytes its function must move (B1's inputs and the
    two incoming gradients read once, 3 B P gradients written) at the
    memory rate, or its operations (per lane ~30 of set-up and chain rule
    and 22 an interval, csrc/poppk_propagate.cu) at the float32 peak."""
    B, P = args[0].shape
    K = args[5].shape[1]
    nbytes = sum(x.numel() * x.element_size() for x in args) + 3 * B * P * args[0].element_size()
    return (*bound_ms(B * P * (30 + 22 * K), nbytes), nbytes)


def b1t_against_plain(name, args, smi):
    """B1T against its plain version on the card: bit for bit on the lanes
    where both are finite, with the same finite set (the kernel is built
    without FMA contraction and takes the plain version's operations in
    its order); its device time, the wrapper's, the plain version's, the
    bound and the roofline share."""
    import torch

    from bcm3_tpu_torch.ops.poppk_kernels import (
        propagate_intervals_adjoint as b1t,
        propagate_intervals_adjoint_plain as b1t_plain,
    )

    got = b1t(*args)
    ref = b1t_plain(*args)
    torch.cuda.synchronize()
    B, P = args[0].shape
    K = args[5].shape[1]
    fin = torch.ones_like(ref[0], dtype=torch.bool)
    for r in ref:
        fin &= torch.isfinite(r)
    assert fin.double().mean().item() > 0.9, "B1T: too few finite lanes"
    same_set = all(torch.equal(torch.isfinite(g), torch.isfinite(r)) for g, r in zip(got, ref))
    identical = all(torch.equal(g[fin], r[fin]) for g, r in zip(got, ref))
    err = max((g - r).abs()[fin].max().item() for g, r in zip(got, ref))
    rel = max(((g - r).abs()[fin] / (r.abs()[fin] + 1e-30)).max().item()
              for g, r in zip(got, ref))
    assert same_set, f"B1T {name}: finite sets differ from the plain version's"
    assert identical, f"B1T {name} differs from its plain version: max abs err {err}, rel {rel}"
    times = b1t_times(args)
    plain_ms = cuda_ms(lambda: b1t_plain(*args), 10)
    bound, by, nbytes = b1t_bound(args)
    log(f"B1T poppk_propagate_adjoint, {name} width, B={B} P={P} K={K} ({B * P} lanes, "
        f"{args[0].dtype}): bit for bit {identical} (asserted, same finite set; max abs err "
        f"{err:.3e}, max rel err {rel:.3e}); kernel {times['ms']:.5f} ms a launch (device "
        f"time: 50 launches in a CUDA graph), {times['stream_ms']:.5f} ms a call back to back "
        f"(CUDA events), wrapper {times['host_us']:.2f} us a call on the host; plain "
        f"{plain_ms:.4f} ms; bound {bound:.5f} ms by {by} ({nbytes} bytes), roofline share "
        f"{bound / times['ms']:.3f}; on {smi}")
    return dict(times, max_abs_err=err, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bit_for_bit=identical)


# B1T at the widths its paths launch it: NUTS and HMC (2,048 chains x 16
# patients, float32), the PT headline (8 x 8,192 chains, float32: the
# kernels line's), VI (32 Monte Carlo samples, float64)
def b1t_widths():
    import torch

    return (("nuts", NUTS_ONE["num_chains"], torch.float32),
            ("pt", NUM_CHAINS * ENSEMBLES["one"], torch.float32),
            ("vi", VI_ONE["num_mc_samples"], torch.float64))


def phase_gradient_card_vs_cpu(models, smi, transit_reference):
    """The card's float32 log-posterior and gradient in z (through B1 and
    B1T) against the port's CPU float64 (plain versions) on GRAD_DRAWS
    prior draws; the transit models' through B2J
    (`transit_gradient_card_vs_cpu`); then B1T against its plain version
    at the NUTS path's width (2,048 chains x 16 patients) and at the PT
    path's (65,536)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    prior, lik = models["one"]
    target = LogPosterior(prior, lik)
    x = prior.sample(torch.Generator().manual_seed(5), (GRAD_DRAWS,), torch.float64)
    z = target.reparam.from_x(x)
    v_cpu, g_cpu = (a.numpy() for a in target.value_and_grad(z))
    v, g = (a.double().cpu().numpy() for a in target.value_and_grad(z.to(CARD, torch.float32)))
    # rows whose rates fit in float32 (a heavy-tailed population sd can put
    # a rate beyond it: -inf on the card, finite in float64)
    params, _, _ = lik.model._patient_params(x)
    fits = np.ones(len(x), dtype=bool)
    for p in params.values():
        fits &= (p.reshape(len(x), -1).abs().numpy() < np.finfo(np.float32).max).all(axis=1)
    both = fits & np.isfinite(v_cpu) & np.isfinite(v)
    flips = int((np.isfinite(v_cpu) != np.isfinite(v))[fits].sum())
    rel_v = np.abs(v[both] - v_cpu[both]) / np.abs(v_cpu[both])
    # each row's gradient against its largest component (float32 rounding
    # of a sum of ~400 terms of both signs)
    norm = np.abs(g_cpu[both]).max(axis=1)
    rel_g = np.abs(g[both] - g_cpu[both]).max(axis=1) / norm
    ok_g = float((rel_g <= GRAD_RTOL).mean())
    log(f"gradient card vs CPU on `one`: {int(both.sum())}/{len(x)} rows finite on both "
        f"({int((~fits).sum())} with rates beyond float32), {flips} finite-set flips (limit 0); "
        f"log-posterior max rel err {rel_v.max():.3e} (limit {GRAD_RTOL}); gradient max rel err "
        f"{rel_g.max():.3e}, median {np.median(rel_g):.3e}, {ok_g:.4f} of rows within "
        f"{GRAD_RTOL} of the row's largest component (limit {GRAD_SHARE}); on {smi}")
    assert both.sum() >= len(x) // 4 and flips == 0
    assert rel_v.max() <= GRAD_RTOL and ok_g >= GRAD_SHARE
    transit_gradient_card_vs_cpu(models, smi, transit_reference)
    gen = torch.Generator(device=CARD).manual_seed(6)
    return {name: b1t_against_plain(name, b1t_inputs(models, rows, gen, dtype), smi)
            for name, rows, dtype in b1t_widths()}


def transit_grad_rows(prior, lik):
    """The log-posterior of a transit model and the z of its
    TRANSIT_GRAD_DRAWS prior draws (float64, on the CPU)."""
    import torch

    from bcm3_tpu_torch.sampler.hmc import LogPosterior

    target = LogPosterior(prior, lik)
    x = prior.sample(torch.Generator().manual_seed(5), (TRANSIT_GRAD_DRAWS,), torch.float64)
    return target, target.reparam.from_x(x)


def transit_grad_cpu_reference(workdir, path):
    """The CPU's side of `transit_gradient_card_vs_cpu`, run in a process
    of its own from the start of the run: the float64 log-posterior and
    its gradient in z for each transit model (the gradient mode's plain
    version), into `path` (.npz)."""
    import numpy as np
    import torch

    torch.set_num_threads(2)  # the card's phases keep a core busy launching
    out = {}
    for pk_type in ("one_transit", "two_transit"):
        target, z = transit_grad_rows(*build_model(pk_type, workdir))
        v, g = target.value_and_grad(z)
        out[f"{pk_type}_value"], out[f"{pk_type}_grad"] = v.numpy(), g.numpy()
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


def start_transit_grad_cpu_reference(workdir):
    """The transit gradients' CPU reference process (spawned: this one has
    CUDA state) and its result file."""
    import multiprocessing

    sub = os.path.join(workdir, "transit_grad_cpu")
    os.makedirs(sub, exist_ok=True)
    path = os.path.join(sub, "reference.npz")
    proc = multiprocessing.get_context("spawn").Process(
        target=transit_grad_cpu_reference, args=(sub, path), daemon=True)
    proc.start()
    return proc, path


def transit_gradient_card_vs_cpu(models, smi, reference):
    """The transit models' log-posterior and gradient in z (the gradient
    mode: B2J on the card) on TRANSIT_GRAD_DRAWS prior draws: the card's
    float64 against the CPU's float64 (`reference`: its process and file,
    waited for here), within TRANSIT_GRAD_RTOL; the card's float32 against
    the same, reported."""
    import numpy as np
    import torch

    proc, path = reference
    t = time.perf_counter()
    proc.join(timeout=600)
    assert proc.exitcode == 0, f"the transit gradients' CPU reference failed: {proc.exitcode}"
    waited = time.perf_counter() - t
    ref = np.load(path)
    for pk_type in ("one_transit", "two_transit"):
        target, z = transit_grad_rows(*models[pk_type])
        v_cpu, g_cpu = ref[f"{pk_type}_value"], ref[f"{pk_type}_grad"]
        fin_cpu = np.isfinite(v_cpu)
        lines = []
        for dtype in (torch.float64, torch.float32):
            v, g = (a.double().cpu().numpy()
                    for a in target.value_and_grad(z.to(CARD, dtype)))
            fin = np.isfinite(v)
            both = fin & fin_cpu
            flips = int((fin != fin_cpu).sum())
            rel_v = np.abs(v[both] - v_cpu[both]) / np.abs(v_cpu[both])
            norm = np.abs(g_cpu[both]).max(axis=1)
            rel_g = np.abs(g[both] - g_cpu[both]).max(axis=1) / norm
            g_nonfinite = int((~np.isfinite(g[both])).any(axis=1).sum())
            rtol = TRANSIT_GRAD_RTOL if dtype == torch.float64 else GRAD_RTOL
            share = float((rel_g <= rtol).mean())
            lines.append(f"{str(dtype)[6:]}: {int(both.sum())}/{len(v)} rows finite on both, "
                         f"{flips} finite-set flips, log-posterior max rel err {rel_v.max():.3e}, "
                         f"gradient max rel err {rel_g.max():.3e} (median "
                         f"{np.median(rel_g):.3e}), {share:.4f} of rows within {rtol} of the "
                         f"row's largest component, {g_nonfinite} rows with a non-finite "
                         f"gradient")
            if dtype == torch.float64:
                assert both.sum() >= len(v) // 4 and flips <= 1 and g_nonfinite == 0
                assert rel_v.max() <= TRANSIT_GRAD_RTOL and share >= GRAD_SHARE
        log(f"gradient card vs CPU on `{pk_type}` (the gradient mode, B2J; the CPU's float64 "
            f"from its own process, waited {waited:.1f} s): " + "; ".join(lines)
            + f" (float64 asserted: flips <= 1, values within {TRANSIT_GRAD_RTOL}, gradients "
            f"on >= {GRAD_SHARE} of rows; float32 reported); on {smi}")


def b1t_timing(tree):
    """`python3 chip_smoke.py --b1t-timing [TREE]`: B1T's times alone, at
    each width of `b1t_widths`, on the inputs the gradient path gives it,
    from this checkout's package or from TREE's (another commit unpacked
    with `git archive`); one JSON line. Run it in turns over two trees in
    one call to compare their kernels on one card."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    smi = phase_environment()
    import torch

    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        models = {"one": build_model("one", tmp)}
        gen = torch.Generator(device="cuda").manual_seed(6)
        out = {}
        for name, rows, dtype in b1t_widths():
            args = b1t_inputs(models, rows, gen, dtype)
            bound, by, _ = b1t_bound(args)
            out[name] = dict(b1t_times(args), bound_ms=bound, bound_by=by,
                             lanes=args[0].numel())
    from bcm3_tpu_torch.ops import poppk_kernels

    log(json.dumps({"b1t_timing": out, "tree": tree or ".",
                    "package": os.path.dirname(poppk_kernels.__file__), "device": smi}))


def b2j_timing(tree):
    """`python3 chip_smoke.py --b2j-timing [TREE]`: B2J's times alone, by
    CUDA events after a warm-up, at the widths of B2J_CHECKS (32,768 lanes
    in float32 on `one_transit`, 1,024 lanes in float64 on both transit
    models) on the inputs `b2j_inputs` makes, from this checkout's package
    or from TREE's (another commit unpacked with `git archive`); one JSON
    line with, per width, the ms, the bound and its share, the lanes' trips
    (mean, max, the mean over warps of 32 consecutive lanes of the warp's
    maximum), the launch plan, and the registers and spills of B2J's
    instances. Run it in turns over two trees in one call to compare their
    kernels on one card."""
    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    smi = phase_environment()
    import inspect

    import torch

    ptxas = {k: v for k, v in phase_build().items() if "transit_dp5_tangent" in k}
    from bcm3_tpu_torch.ops import transit_tangent_kernels as b2j

    slots_counted = "warp_slots" in inspect.signature(b2j.transit_jacobian).parameters
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        models = {k: build_model(k, tmp) for k in ("one_transit", "two_transit")}
        gen = torch.Generator(device="cuda").manual_seed(7)
        for pk_type, rows, dtype in B2J_CHECKS:
            rates, tables, options = b2j_inputs(*models[pk_type], rows, gen,
                                                getattr(torch, dtype))
            _, _, ok, n = b2j.transit_jacobian(rates, **tables, **options, trip_counts=True)
            ms = cuda_ms(lambda: b2j.transit_jacobian(rates, **tables, **options), B2J_TIMED)
            bound, by, ops, _ = b2j_bound(rates, tables, n)
            L = n.numel()
            warps = n[: L // 32 * 32].reshape(-1, 32).amax(dim=1).double()
            row = dict(ms=ms, bound_ms=bound, bound_by=by, share=bound / ms, ops=ops, lanes=L,
                       ok=int(ok.sum()), trips_mean=n.double().mean().item(),
                       trips_max=int(n.max()), trips_warp_max_mean=warps.mean().item())
            if slots_counted:
                slots = torch.zeros(1, dtype=torch.int64, device="cuda")
                b2j.transit_jacobian(rates, **tables, **options, warp_slots=slots)
                plan = b2j.transit_jacobian.last_plan
                # the producer warps' trip records, and the share of their
                # lanes' slots that held a trip
                row.update(plan=plan, producer_slots=int(slots),
                           slots_a_producer_warp=int(slots) / plan["blocks"],
                           slot_efficiency=int(n.long().sum())
                           / (plan["lanes_per_warp"] * int(slots)))
            else:
                row["plan"] = "a lane a thread, 128 threads a block, blocks min(needed, resident)"
            out[f"{pk_type} {L} {dtype}"] = row
    log(json.dumps({"b2j_timing": out, "ptxas": ptxas, "tree": tree or ".",
                    "package": os.path.dirname(b2j.__file__), "device": smi}))


def smc_replicates(prior, lik, device, dtype, seeds):
    """Means, sds and log evidences of independent SMC populations."""
    import numpy as np

    from bcm3_tpu_torch.sampler import SamplerSMC, SMCConfig

    rows = []
    for seed in seeds:
        res = SamplerSMC(prior, lik, SMCConfig(num_particles=BANANA_GRADIENT, seed=seed,
                                               device=device, dtype=dtype)).run()
        x = res["samples"][:, 0, :].astype(np.float64)
        rows.append(np.concatenate([x.mean(axis=0), x.std(axis=0),
                                    [res["log_marginal_likelihood"]]]))
    return np.array(rows)


def banana_log_evidence():
    """log of the banana likelihood's mean over the uniform prior box
    (sd1 2, sd2 1, normalized), by the trapezoid rule."""
    import numpy as np

    (lo1, hi1), (lo2, hi2) = BANANA_BOX
    n = 2001
    x1, x2 = np.linspace(lo1, hi1, n), np.linspace(lo2, hi2, n)
    X1, X2 = np.meshgrid(x1, x2, indexing="ij")
    lik = np.exp(-0.5 * (X1 / 2.0) ** 2 - 0.5 * (X2 - (X1 + 3.0 * X1 + (1.0 - X1) ** 2)) ** 2)
    lik /= 2.0 * 2.0 * np.pi  # sd1 * sd2 * 2 pi
    w = np.ones(n)
    w[[0, -1]] = 0.5
    integral = (np.outer(w, w) * lik).sum() * (x1[1] - x1[0]) * (x2[1] - x2[0])
    return float(np.log(integral / ((hi1 - lo1) * (hi2 - lo2))))


def phase_banana_gradient(smi):
    """NUTS, HMC and SMC on the banana fixture at 8,192 chains or particles
    (float32), each held to the quadrature oracle within MCSE_LIMIT
    standard errors; SMC's oracle distance is logged and its populations
    are held to the port's CPU run (float64) instead: its reflection on the
    prior's bounds, the JAX package's, moves it off the oracle (ROADMAP C,
    tests/test_torch_smc.py)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import HMCConfig, NUTSConfig, SamplerHMC, SamplerNUTS

    prior, lik = analytic_model("banana")
    kw = dict(num_chains=BANANA_GRADIENT, device=CARD, dtype=torch.float32)
    out = {}
    for name, cls, cfg in (
        ("NUTS", SamplerNUTS, NUTSConfig(**BANANA_NUTS, **kw)),
        ("HMC", SamplerHMC, HMCConfig(**BANANA_HMC, **kw)),
    ):
        t = time.perf_counter()
        res = cls(prior, lik, cfg).run()
        seconds = time.perf_counter() - t
        extra = (f"mean tree depth {res['mean_tree_depth']:.3f}, {res['divergences']} "
                 f"divergences" if name == "NUTS" else f"acceptance {res['accept_rate']:.4f}")
        log(f"banana {name}: {BANANA_GRADIENT} chains, {cfg.num_warmup} + {cfg.num_samples} "
            f"transitions in {seconds:.3f} s, step size {res['step_size']:.5g}, {extra}")
        z = oracle_distance(f"banana {name} against the oracle", res["samples_per_chain"],
                            smi, asserted=True)
        assert np.all(np.abs(z) <= MCSE_LIMIT), f"banana {name} misses the oracle: z {z}"
        out[name] = z
    seeds = range(1, SMC_REPLICATES + 1)
    t = time.perf_counter()
    card = smc_replicates(prior, lik, CARD, torch.float32, seeds)
    seconds = time.perf_counter() - t
    cpu = smc_replicates(prior, lik, "cpu", torch.float64, [s + 1000 for s in seeds])
    exact_mean, exact_sd = banana_oracle()
    exact = np.concatenate([exact_mean, exact_sd, [banana_log_evidence()]])
    R = len(card)
    se = card.std(axis=0, ddof=1) / np.sqrt(R)
    z_oracle = (card.mean(axis=0) - exact) / se
    z_cpu = (card.mean(axis=0) - cpu.mean(axis=0)) / np.sqrt(
        se**2 + cpu.var(axis=0, ddof=1) / R)
    log(f"banana SMC: {R} populations of {BANANA_GRADIENT} particles in {seconds:.3f} s; "
        f"mean, sd and log evidence {np.round(card.mean(axis=0), 5).tolist()} +- "
        f"{np.round(se, 5).tolist()}; against the oracle {np.round(exact, 5).tolist()} z "
        f"{np.round(z_oracle, 3).tolist()} (not asserted: the reflection, ROADMAP C); against "
        f"the port's CPU float64 populations z {np.round(z_cpu, 3).tolist()} (limit "
        f"{MCSE_LIMIT}); on {smi}")
    assert np.all(np.abs(z_cpu) <= MCSE_LIMIT), f"banana SMC card against CPU: z {z_cpu}"
    out["SMC"] = z_oracle
    return out


# ---------------------------------------------------------------------------
# The pharmacometric and generic likelihoods (phases 22-26)


def write_uniform_prior(path, spec):
    """A prior.xml of uniform variables: spec is (name, logspace, lower,
    upper) per variable."""
    lines = ['<?xml version="1.0" encoding="utf-8"?>', "<prior>"]
    for name, logspace, lo, hi in spec:
        ls = ' logspace="true"' if logspace else ""
        lines.append(f'  <variable name="{name}" distribution="uniform"{ls} lower="{lo}" '
                     f'upper="{hi}"/>')
    lines.append("</prior>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def pharmaco_model(workdir, cfg_kw=None):
    """bench.py bench_pharmaco's pharmaco_population likelihood (16
    patients x 24 observations, trial seed 31, lapatinib, a random effect on
    absorption, an additive sd), with the rates of cfg_kw's options after
    its variables; the prior (its XML written to workdir, uniform around
    the values) and the values: bench's, and the added rates'."""
    import numpy as np

    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.pharmaco import (
        PharmacoLikelihoodPopulation,
        PharmacoModelConfig,
    )
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial

    cfg_kw = cfg_kw or {}
    # (name, logspace, value, lower, upper)
    spec = [("mean_absorption", False, -0.3, -1.3, 0.7),
            ("sigma_absorption", False, 0.2, 0.01, 1.0),
            ("mean_clearance", False, np.log10(18.0), 0.5, 2.0),
            ("mean_volume_of_distribution", False, np.log10(120.0), 1.5, 2.7)]
    spec += [(f"p{j + 1}_absorption", False, 0.3 + 0.02 * j, 0.0, 1.0)
             for j in range(NUM_PATIENTS)]
    spec += [("additive_error_standard_deviation", False, 25.0, 1.0, 100.0)]
    rates = {"use_peripheral": [("peripheral_forward_rate", 0.08),
                                ("peripheral_backward_rate", 0.05)],
             "use_metabolite": [("metabolite_conversion_rate", 0.1)],
             "num_transit": [("mean_transit_time", 2.0)]}
    for option in cfg_kw:
        spec += [(name, True, np.log10(v), np.log10(v) - 1.0, np.log10(v) + 1.0)
                 for name, v in rates[option]]
    name = "_".join(f"{k}{v}" for k, v in cfg_kw.items()) or "bench"
    path = os.path.join(workdir, f"prior_pharmaco_{name}.xml")
    write_uniform_prior(path, [(n, ls, lo, hi) for n, ls, _, lo, hi in spec])
    varset = VariableSet.from_xml(path)
    trial, _ = synthesize_trial(num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS,
                                seed=31)
    model = PharmacoLikelihoodPopulation(varset, trial, "lapatinib",
                                         PharmacoModelConfig(**cfg_kw))
    lik = Likelihood("pharmaco_population", model.log_prob_batched, model=model)
    return Prior.from_xml(path, varset), lik, np.array([v for _, _, v, _, _ in spec])


def bench_rows(values, rows, seed=0, jitter=PHARMACO_JITTER):
    """_bench_batched_loglik's rows (bench.py:404-427): the values with
    normal jitter, float64 on the host."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return values[None, :] + jitter * rng.normal(size=(rows, len(values)))


def pharmaco_card_vs_cpu(name, lik, xs):
    """The card's float32 against the CPU's float64 on the rows xs (a
    float64 numpy array): equal finite sets, every finite row within
    PHARMACO_RTOL."""
    import numpy as np
    import torch

    rows = torch.as_tensor(xs)
    cpu = lik.log_prob_batched(rows).numpy()
    card = lik.log_prob_batched(rows.to(CARD, torch.float32)).double().cpu().numpy()
    fin = np.isfinite(cpu)
    mismatched = int((np.isfinite(card) != fin).sum())
    rel = np.abs(card[fin] - cpu[fin]) / np.abs(cpu[fin])
    log(f"{name}: {int(fin.sum())}/{len(xs)} finite on the CPU, {mismatched} finite-set "
        f"mismatches (limit 0), max rel err {rel.max():.3e} (limit {PHARMACO_RTOL}), median "
        f"{np.median(rel):.3e}")
    assert mismatched == 0 and fin.sum() >= len(xs) // 2
    assert rel.max() <= PHARMACO_RTOL


def phase_pharmaco(workdir, smi):
    """pharmaco_population at bench.py bench_pharmaco's width (float32):
    evals/s over PHARMACO_REPS evaluations after a warm-up, the finite
    count, the peak memory, the device's busy share of one evaluation under
    the profiler, and where the time goes (CUDA events): the parameters
    and matrices, the step matrix expm(A * interval), the K-interval
    recurrence, the read-out (its closed-form expm(A * offset) apart), and
    the scoring. Then the card against the CPU on PHARMACO_CPU_ROWS rows,
    and for the PHARMACO_WIDE configurations on PHARMACO_WIDE_ROWS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bcm3_tpu_torch.likelihoods import pharmaco
    from bcm3_tpu_torch.ode.linear_pk import _expm_2x2

    _, lik, values = pharmaco_model(workdir)
    m = lik.model
    xs = bench_rows(values, PHARMACO_ROWS)
    x = torch.as_tensor(xs, dtype=torch.float32, device=CARD)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lp = lik.log_prob_batched(x)
    finite = int(torch.isfinite(lp).sum())
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(PHARMACO_REPS):
        lp = lik.log_prob_batched(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / PHARMACO_REPS
    peak = torch.cuda.max_memory_allocated() - held
    del lp
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lik.log_prob_batched(x)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    idle = "not measured" if busy_ms <= 0 else f"{1.0 - busy_ms / wall_ms:.4f}"
    B, P, T = PHARMACO_ROWS, NUM_PATIENTS, NUM_TIMEPOINTS
    log(f"pharmaco_population: {B} rows x {P} patients x {T} observations, K = "
        f"{m.schedule.dose_amount.shape[1]} intervals, n = {m.cfg.num_compartments}, float32: "
        f"{wall_ms:.3f} ms an evaluation (host clock, synchronized, mean of {PHARMACO_REPS}) = "
        f"{B / wall_ms * 1e3:.1f} evals/s; {finite}/{B} finite; peak memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held before; device busy "
        f"{busy_ms:.3f} ms ({len(device)} device operations) under the profiler, idle share "
        f"{idle}; on {smi}")
    assert finite >= B // 2

    tb = m._tables(x.device, x.dtype)
    params_ms = cuda_ms(lambda: m._params(x), 3)
    A, bio, _, _, _ = m._params(x)
    step_ms = cuda_ms(lambda: pharmaco.expm(A * tb["interval"][:, None, None]), 3)
    starts_ms = cuda_ms(
        lambda: pharmaco.interval_starts(A, tb["interval"], tb["dose_amount"], bio), 3)
    solve_ms = cuda_ms(lambda: m._solve(A, bio, tb), 3)
    off = tb["obs_offset"][None]
    entries = [A[..., i, j][:, :, None] * off for i in (0, 1) for j in (0, 1)]
    readout_expm_ms = cuda_ms(lambda: _expm_2x2(*entries, 1.0), 3)
    del A, bio, entries
    total_ms = cuda_ms(lambda: lik.log_prob_batched(x), 3)
    readout_ms = solve_ms - starts_ms
    log("pharmaco_population time by stage (CUDA events, ms an evaluation): " + json.dumps({
        "evaluation": total_ms, "parameters_and_matrices": params_ms,
        "step_matrix_expm": step_ms, "interval_starts_with_step_expm": starts_ms,
        "read_out": readout_ms, "read_out_expm": readout_expm_ms,
        "scoring": total_ms - params_ms - solve_ms,
        "expm_share": (step_ms + readout_expm_ms) / total_ms,
        "read_out_share": readout_ms / total_ms}))
    del x
    torch.cuda.empty_cache()

    pharmaco_card_vs_cpu("card vs CPU pharmaco_population", lik, xs[:PHARMACO_CPU_ROWS])
    for name, cfg_kw in PHARMACO_WIDE.items():
        _, wide, values = pharmaco_model(workdir, cfg_kw)
        rows = bench_rows(values, PHARMACO_WIDE_ROWS)
        ms = cuda_ms(lambda: wide.log_prob_batched(
            torch.as_tensor(rows, dtype=torch.float32, device=CARD)), 1)
        log(f"pharmaco_population {name} (n = {wide.model.cfg.num_compartments}): "
            f"{PHARMACO_WIDE_ROWS} rows in {ms:.3f} ms (CUDA events); on {smi}")
        pharmaco_card_vs_cpu(f"card vs CPU pharmaco_population {name}", wide, rows)
    return PHARMACO_ROWS / wall_ms * 1e3


def phase_pharmaco_pt(workdir, smi):
    """SamplerPT over bench_pharmaco's likelihood at `one`'s width and
    depth."""
    prior, lik, _ = pharmaco_model(workdir)
    res = pt_slice("pharmaco_pt", prior, lik, ENSEMBLES["one"], NUM_SAMPLES["one"],
                   profile_samples=PT_PROFILE_ITERATIONS)
    log(f"pharmaco_pt on {smi}")
    return res["evals_per_second"]


# the single-patient layout (LikelihoodPharmacokineticTrajectory.cpp
# :247-290): (name, lower, upper), all log10-space, as write_poppk_prior_xml
# bounds the population's rates
_PK_SINGLE_BASE = [("absorption", -2.0, 1.0), ("excretion", -4.0, 0.0),
                   ("elimination", -1.0, 1.5), ("volume_of_distribution", 1.0, 3.0)]
_PK_SINGLE_PERIPHERY = [("k_periphery_fwd", -3.0, 0.0), ("k_periphery_bwd", -3.0, 0.0)]
_PK_SINGLE_TRANSIT = [("n_transit", 0.0, 1.0), ("mean_transit_time", -1.0, 1.5)]
_PK_SINGLE_SD = [("standard_deviation", 0.0, 2.5), ("standard_deviation2", -3.0, 0.5)]


def pk_single_model(pk_type, workdir):
    """The pharmacokinetic_trajectory likelihood of the bench trial's
    patient PK_SINGLE_PATIENT, and its prior from its XML."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.pk_single import SinglePatientPKLikelihood, select_patient
    from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial

    spec = list(_PK_SINGLE_BASE)
    if pk_type in ("two", "two_transit"):
        spec += _PK_SINGLE_PERIPHERY
    if pk_type in ("one_transit", "two_transit"):
        spec += _PK_SINGLE_TRANSIT
    spec += _PK_SINGLE_SD
    path = os.path.join(workdir, f"prior_pk_single_{pk_type}.xml")
    write_uniform_prior(path, [(n, True, lo, hi) for n, lo, hi in spec])
    varset = VariableSet.from_xml(path)
    trial, _ = synthesize_trial(num_patients=NUM_PATIENTS, num_timepoints=NUM_TIMEPOINTS,
                                seed=42)
    pk = SinglePatientPKLikelihood(varset, select_patient(trial, PK_SINGLE_PATIENT), pk_type,
                                   "lapatinib")
    lik = Likelihood("pharmacokinetic_trajectory", pk.log_prob_batched, model=pk)
    return Prior.from_xml(path, varset), lik


def phase_kernels_one_patient(single, gen):
    """B1 and B2 at P = 1, on the inputs the single-patient likelihood makes
    from prior draws at the slices' widths (B1: 65,536 lanes, B2: 32,768),
    bit for bit against their plain versions on the card."""
    import torch

    from bcm3_tpu_torch.ops.poppk_kernels import (
        propagate_intervals_one_compartment as b1,
        propagate_intervals_plain as b1_plain,
    )
    from bcm3_tpu_torch.ops.transit_kernels import transit_solve as b2
    from bcm3_tpu_torch.ops.transit_kernels import transit_solve_plain as b2_plain

    prior, lik = single["one"]
    pk = lik.model
    xs = prior.sample(gen, (ENSEMBLES["one"] * NUM_CHAINS,), torch.float32)
    tb = pk._tables(xs.device, torch.float32)
    p, _, _ = pk._patient_params(xs)
    B, P = p["ka"].shape
    args = (p["ka"].contiguous(), p["ke"][:, None].expand(B, P).contiguous(),
            p["kel"].contiguous(), tb["initial_dose"], tb["interval"], tb["dose_amount"])
    g, c = b1(*args)
    gp, cp = b1_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(gp) & torch.isfinite(cp)
    same_set = torch.equal(fin, torch.isfinite(g) & torch.isfinite(c))
    differ = int(((g != gp) | (c != cp))[fin].sum())
    log(f"B1 at P = 1 (B = {B}, K = {pk.K}): {int(fin.sum())}/{fin.numel()} finite, same finite "
        f"set {same_set}, {differ} finite values differ from the plain version (limit 0)")
    assert P == 1 and same_set and differ == 0

    params, grid, amt, kw = b2_inputs(*single["one_transit"], gen)
    c, ok, n = b2(params, grid, amt, trip_counts=True, **kw)
    cp, okp, n_p = b2_plain(params, grid, amt, trip_counts=True, **kw)
    torch.cuda.synchronize()
    L = len(ok)
    ok_differ, trips_differ = int((ok != okp).sum()), int((n != n_p).sum())
    both = ok & okp
    differ = int((c[both] != cp[both]).sum())
    log(f"B2 at P = 1 (L = {L}, S = {grid.shape[1]}): ok {int(ok.sum())}/{L}, {ok_differ} lanes "
        f"differ in ok, {trips_differ} in trips, {differ} central values of the finished lanes "
        f"(limits 0)")
    assert grid.shape[0] == 1 and ok_differ == 0 and trips_differ == 0 and differ == 0
    assert int(both.sum()) > L // 10


def phase_pk_single_one(single, smi):
    """pharmacokinetic_trajectory `one` through SamplerPT at the `one`
    slice's width and depth (through B1), then the card against the CPU
    for `one` and `two` on PK_SINGLE_CPU_ROWS prior draws."""
    import torch

    res = pt_slice("pk_single_one", *single["one"], ENSEMBLES["one"], NUM_SAMPLES["one"],
                   profile_samples=PT_PROFILE_ITERATIONS)
    log(f"pk_single_one on {smi}")
    for pk_type in ("one", "two"):
        prior, lik = single[pk_type]
        xs = prior.sample(torch.Generator().manual_seed(5), (PK_SINGLE_CPU_ROWS,), torch.float64)
        card = lik.log_prob_batched(xs.to(CARD, torch.float32)).double().cpu().numpy()
        card_vs_cpu(f"card vs CPU pk_single {pk_type}", pk_type, lik, xs, card)
    return res["evals_per_second"]


def phase_pk_single_one_transit(single, smi):
    """pharmacokinetic_trajectory `one_transit`: one evaluation at
    one_transit's width (through B2); the card against the CPU on
    PK_SINGLE_TRANSIT_ROWS prior draws, both solving in float32 (B2 and
    its plain version) from float32 rows: the central compartment at B2's
    stack tolerance with equal finite sets, and the log-likelihoods
    against the CPU's float64 rows as card_vs_cpu holds the transit
    models."""
    import numpy as np
    import torch

    prior, lik = single["one_transit"]
    m = lik.model
    gen = torch.Generator(device=CARD).manual_seed(11)
    x = prior.sample(gen, (NUM_CHAINS * ENSEMBLES["one_transit"],), torch.float32)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    lp = lik.log_prob_batched(x)
    stop.record()
    torch.cuda.synchronize()
    log(f"pk_single_one_transit: one evaluation of {len(x)} prior draws: "
        f"{start.elapsed_time(stop):.3f} ms (CUDA events), "
        f"{float(torch.isfinite(lp).double().mean()):.4f} of them finite; on {smi}")

    xs = prior.sample(torch.Generator().manual_seed(5), (PK_SINGLE_TRANSIT_ROWS,),
                      torch.float64)

    def central(rows):
        p, _, _ = m._patient_params(rows)
        return m._central_transit(p, m._tables(rows.device, rows.dtype), rows.dtype)[:, 0]

    card = central(xs.to(CARD, torch.float32)).cpu().double().numpy()
    cpu = central(xs.float()).double().numpy()
    fin = np.isfinite(cpu).all(axis=1)
    same_set = np.array_equal(np.isfinite(card).all(axis=1), fin)
    atol = B2_STACK_ATOL * float(m.trial.dose.min())

    def excess(a, b):  # per row, the largest excess over the stack tolerance
        return (np.abs(a - b) - (B2_STACK_RTOL * np.abs(b) + atol)).max(axis=1)

    # rows where the CPU's own float32 solve leaves the stack tolerance when
    # its parameters move by their float32 rounding (the same rows' float64
    # parameters rounded once): there the adaptive step sequence, not the
    # device, decides the result (a step over the narrow transit pulse
    # after a dose), ROADMAP "Measured limits"
    unstable = fin & (excess(cpu, central(xs).double().numpy()) > 0)
    held = fin & ~unstable
    worst = excess(card[held], cpu[held]).max()
    log(f"card vs CPU pk_single one_transit central (float32 on both): {int(fin.sum())}/"
        f"{len(xs)} rows finite, same finite set {same_set}; {int(unstable.sum())} rows whose "
        f"CPU solve leaves rtol {B2_STACK_RTOL} + atol {atol:.3e} under its parameters' "
        f"float32 rounding (limit {len(xs) // 16}), on them the card's largest excess "
        f"{excess(card[unstable], cpu[unstable]).max(initial=0.0):.3e} (logged); on the other "
        f"{int(held.sum())} rows the largest excess {worst:.3e} (limit 0)")
    assert same_set and held.sum() >= len(xs) // 4 and worst <= 0
    assert unstable.sum() <= len(xs) // 16
    card_lp = lik.log_prob_batched(xs.to(CARD, torch.float32)).double().cpu().numpy()
    card_vs_cpu("card vs CPU pk_single one_transit", "one_transit", lik, xs, card_lp)


def harmonic_derivative(t, y, params):
    """The ODE template's harmonic oscillator (tests/test_ode_and_plugin.py
    :43-61), lanes first: y0' = y1, y1' = -w^2 y0 with w = 1/2300, two
    inert states."""
    import torch

    w = 1.0 / 2300.0
    z = torch.zeros_like(y[:, 0])
    return torch.stack([y[:, 1], -w * w * y[:, 0], z, z], dim=-1)


def phase_ode_dll(workdir, smi):
    """The ODE template at ODE_ROWS rows with the harmonic derivative
    (float64) and its seconds, the card against the CPU on ODE_CPU_ROWS;
    the C plugin of tests/fixtures/plugins built here with cc and
    evaluated at PLUGIN_ROWS rows of the card, its host time a row."""
    import numpy as np
    import torch

    from bcm3_tpu_torch import VariableSet, create_likelihood

    vs = VariableSet()
    for i in range(13):
        vs.add_variable(f"p{i}")
    lik = create_likelihood("ODE", vs, _derivative=harmonic_derivative)
    rng = np.random.default_rng(4)
    rows = rng.uniform(0.1, 1.3, (ODE_ROWS, 13))
    rows[:, 9] = 100.0 + 20.0 * rng.normal(size=ODE_ROWS)  # data: 100 cos(t/2300) + 300
    x = torch.as_tensor(rows, device=CARD)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lp = lik.log_prob_batched(x)
    torch.cuda.synchronize()
    ode_seconds = time.perf_counter() - t
    card = lp[:ODE_CPU_ROWS].cpu().numpy()
    cpu = lik.log_prob_batched(torch.as_tensor(rows[:ODE_CPU_ROWS])).numpy()
    fin = np.isfinite(cpu)
    same_set = np.array_equal(np.isfinite(card), fin)
    rel = np.abs(card[fin] - cpu[fin]) / np.abs(cpu[fin])
    log(f"ode_template: {ODE_ROWS} rows (float64, harmonic derivative) in {ode_seconds:.3f} s, "
        f"{int(torch.isfinite(lp).sum())} finite; card vs CPU on {ODE_CPU_ROWS} rows: same "
        f"finite set {same_set}, max rel err {rel.max():.3e} (limit {ODE_RTOL}); on {smi}")
    assert same_set and fin.all() and rel.max() <= ODE_RTOL

    so = os.path.join(workdir, "gaussian_plugin.so")
    subprocess.run(["cc", "-shared", "-fPIC", "-O2", "-o", so, PLUGIN_SOURCE], check=True,
                   timeout=120)
    vs = VariableSet()
    for i in range(4):
        vs.add_variable(f"x{i}")
    plugin = create_likelihood("dll", vs, dll_filename_base=so[:-3])
    gen = torch.Generator(device=CARD).manual_seed(2)
    x = 2.0 * torch.randn((PLUGIN_ROWS, 4), generator=gen, device=CARD)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lp = plugin.log_prob_batched(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    v = x.double().cpu().numpy()
    ref = np.where(np.abs(v[:, 0]) <= 5.0, -0.5 * (v * v).sum(axis=1), -np.inf)
    got = lp.double().cpu().numpy()
    fails = int(np.isneginf(ref).sum())
    log(f"dll (C plugin, host ctypes calls): {PLUGIN_ROWS} rows of the card in {seconds:.3f} s "
        f"= {seconds / PLUGIN_ROWS * 1e6:.3f} us a row on the host, {fails} false returns "
        f"scored -inf; on {smi}")
    assert lp.device.type == x.device.type and np.array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-6)
    return ODE_ROWS / ode_seconds


def phase_pt_emission(models, workdir, smi):
    """SamplerPT's chunked, overlapped emission at `one`'s slice width (8 x
    8,192 chains, float32) with every temperature emitted (11.0 MB an
    emission): PT_EMISSION_SAMPLES emissions for each emit_chunk_size of
    PT_EMISSION_CHUNKS, each from a new sampler of the same seed. Asserts
    samples, log-prior and log-likelihood bit for bit equal; reports each
    run's wall, a run's wall an iteration, and the host reads of a run and
    of a segment (sync debug mode "warn"). Then a short run with
    `profile_dir`: its trace file must name the `poppk_propagate` kernel and
    the SamplerPT.sampling span."""
    import glob

    import numpy as np
    import torch

    from bcm3_tpu_torch.sampler import SamplerPT

    prior, lik = models["one"]
    base = dataclasses.replace(pt_config(ENSEMBLES["one"], PT_EMISSION_SAMPLES),
                               emit_fixed_only=False)
    iterations = PT_EMISSION_SAMPLES * USE_EVERY_NTH
    SamplerPT(prior, lik, dataclasses.replace(base, num_samples=1)).run()  # warm
    runs = {}
    for chunk in PT_EMISSION_CHUNKS:
        sampler = SamplerPT(prior, lik, dataclasses.replace(base, emit_chunk_size=chunk))
        torch.cuda.synchronize()
        t = time.perf_counter()
        res, reads = host_reads(sampler.run)
        wall = time.perf_counter() - t
        runs[chunk] = res
        log(f"pt_emission emit_chunk_size {chunk}: {NUM_CHAINS} x {ENSEMBLES['one']} chains, "
            f"every temperature, {PT_EMISSION_SAMPLES} emissions of {USE_EVERY_NTH} "
            f"iterations: run {wall:.3f} s (host reads {reads}), sampling "
            f"{res['sampling_seconds']:.3f} s = {res['sampling_seconds'] * 1e3 / iterations:.3f} "
            f"ms an iteration; on {smi}")
    first = runs[PT_EMISSION_CHUNKS[0]]
    assert first["samples"].shape == (PT_EMISSION_SAMPLES * ENSEMBLES["one"], NUM_CHAINS,
                                      prior.num_variables)
    same = {chunk: all(np.array_equal(res[k], first[k])
                       for k in ("samples", "log_prior", "log_likelihood"))
            for chunk, res in runs.items()}
    # a segment alone: its iterations and the chunks' copies, no drain
    sampler = SamplerPT(prior, lik, base)
    state = sampler._init_state()
    torch.cuda.synchronize()
    (_, _, rows), reads = host_reads(
        lambda: sampler._run_segment(state, list(sampler.proposals), PT_EMISSION_SAMPLES))
    torch.cuda.synchronize()
    log(f"pt_emission: bit for bit across chunk sizes {same}; host reads of a segment of "
        f"{PT_EMISSION_SAMPLES} emissions {reads}; on {smi}")
    assert all(same.values()), f"pt_emission: chunk sizes disagree {same}"
    del runs, first, rows

    trace_dir = os.path.join(workdir, "pt_profile")
    cfg = dataclasses.replace(base, num_samples=1, profile_dir=trace_dir)
    t = time.perf_counter()
    SamplerPT(prior, lik, cfg).run()
    seconds = time.perf_counter() - t
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json*"))
    assert len(traces) == 1, f"pt_emission: profile_dir holds {traces}"
    with open(traces[0]) as f:
        text = f.read()
    names = {k: k in text for k in ("poppk_propagate", "SamplerPT.sampling")}
    log(f"pt_emission profile_dir: a run of {USE_EVERY_NTH} iterations under the profiler in "
        f"{seconds:.3f} s, trace {os.path.basename(traces[0])} of {len(text)} bytes, names "
        f"{names}; on {smi}")
    assert all(names.values()), f"pt_emission: the trace lacks {names}"
    return dict(same=same, segment_reads=reads)


def phase_dp5_fixed_trips(smi):
    """dp5's `fixed_trips` on the card: the ODE template's harmonic solve
    (ODE_ROWS rows, float64, its 100 stops) by the while form and by the
    fixed form at each count of FIXED_TRIPS until one covers every lane's
    segments. The covering count's result must equal the while form's bit
    for bit (a masked trip leaves a lane as it is), the count before it
    must fail some lanes exactly as the while form does under that
    per-segment budget, and the fixed form must read the host never (sync
    debug mode "error"). Reports the wall of both forms (ROADMAP B12)."""
    import numpy as np
    import torch

    from bcm3_tpu_torch import VariableSet
    from bcm3_tpu_torch.likelihoods.ode_template import ODETemplateLikelihood
    from bcm3_tpu_torch.ode import dp5

    vs = VariableSet()
    for i in range(13):
        vs.add_variable(f"p{i}")
    model = ODETemplateLikelihood(vs, derivative=harmonic_derivative)
    rng = np.random.default_rng(4)
    rows = rng.uniform(0.1, 1.3, (ODE_ROWS, 13))
    rows[:, 9] = 100.0 + 20.0 * rng.normal(size=ODE_ROWS)  # phase_ode_dll's rows
    p = model._transform(torch.as_tensor(rows, device=CARD))
    y0 = p[:, 9:13].contiguous()
    ts = torch.as_tensor(model.timepoints, dtype=torch.float64, device=CARD)
    kw = dict(args=p, rtol=model.rtol, atol=model.atol)

    def same(a, b):
        return (torch.equal(a.ok, b.ok) and torch.equal(a.n_steps, b.n_steps)
                and torch.equal(a.ys.isnan(), b.ys.isnan())
                and torch.equal(a.ys.nan_to_num(), b.ys.nan_to_num()))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    ref, while_s = timed(lambda: dp5.solve_at_times(harmonic_derivative, y0, ts, **kw))
    assert bool(ref.ok.all())
    before = None
    for trips in FIXED_TRIPS:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fixed, fixed_s = timed(
                lambda: dp5.solve_at_times(harmonic_derivative, y0, ts, fixed_trips=trips, **kw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if bool(fixed.ok.all()):
            break
        before = (trips, fixed)
    else:
        raise AssertionError(f"dp5_fixed_trips: no count of {FIXED_TRIPS} covers every lane")
    covered = same(fixed, ref)
    log(f"dp5_fixed_trips: {ODE_ROWS} rows x {len(ts)} stops, float64: the while form "
        f"{while_s:.3f} s ({int(ref.n_steps.max())} steps at most a lane), fixed_trips {trips} "
        f"{fixed_s:.3f} s with 0 host reads (sync debug mode error), bit for bit {covered}; "
        f"on {smi}")
    assert covered, "dp5_fixed_trips: the covering count differs from the while form"
    if before is not None:
        small, fixed_small = before
        budget = dp5.solve_at_times(harmonic_derivative, y0, ts,
                                    max_steps_per_segment=small, **kw)
        agree = same(fixed_small, budget)
        log(f"dp5_fixed_trips: fixed_trips {small} fails {int((~fixed_small.ok).sum())} of "
            f"{ODE_ROWS} lanes, the while form with max_steps_per_segment {small} "
            f"{int((~budget.ok).sum())}; bit for bit, NaN rows included, {agree}")
        assert agree and not bool(fixed_small.ok.all())
    return dict(while_seconds=while_s, fixed_seconds=fixed_s, trips=trips)


# ---------------------------------------------------------------------------
# The cell likelihoods (phases 27-30)


def incucyte_setup():
    """_incucyte_setup's experiment and values (tests/test_cellmisc.py
    :106-178), which bench.py bench_incucyte scores: one experiment of 3
    concentrations, 20 timepoints x 4 replicates, D = 32; (name, value)."""
    import numpy as np

    from bcm3_tpu_torch.likelihoods.cellmisc import IncucyteExperiment

    tp = np.linspace(0.0, 96.0, 20)
    e = IncucyteExperiment(
        timepoints=tp, concentrations=np.log10([0.1, 1.0, 10.0]),
        drug_confluence=np.full((20, 3, 4), 10.0), drug_apoptosis=np.full((20, 3, 4), 1.0),
        neg_confluence=np.full((20, 4), 20.0), neg_apoptosis=np.full((20, 4), 0.5),
        pos_confluence=np.full((20, 4), 5.0), pos_apoptosis=np.full((20, 4), 3.0),
        ctb=np.array([0.9, 0.5, 0.2]), treatment_time=24.0, seeding_density=1000.0,
        experiment_ix=0,
    )
    values = [
        ("log10_cell_size", np.log10(300.0)), ("apoptotic_cell_size", 0.5),
        ("pao_apoptotic_cell_size", 0.5), ("debris_size", 0.2), ("apoptosis_marker_size", 0.8),
        ("pao_apoptosis_marker_size", 0.8), ("debris_apoptosis_marker_size", 0.3),
        ("proliferation_rate", 0.03), ("apoptosis_rate", 0.1), ("apoptosis_duration", 6.0),
        ("apoptosis_remove_rate", 0.05), ("drug_delay", 1.0), ("drug_effect_time", 6.0),
        ("pao_delay", 1.0), ("pao_effect_time", 3.0), ("pao_apoptosis_rate", 0.2),
        ("contact_inhibition_start", 70.0), ("contact_inhibition_max_confluence", 100.0),
        ("contact_inhibition_apoptosis_rate", 0.0), ("cell_preadherence_size", 1.3),
        ("cell_adherence_time", 4.0), ("starting_dead_cell_fraction", 0.02),
        ("seeding_density_deviation_1", 0.0), ("drug_proliferation_rate_1", 0.1),
        ("drug_proliferation_rate_2", 0.2), ("drug_proliferation_rate_3", 0.3),
        ("drug_apoptosis_rate_1", 0.001), ("drug_apoptosis_rate_2", 0.002),
        ("drug_apoptosis_rate_3", 0.005), ("sigma_confluence", 2.0),
        ("sigma_apoptosis_marker", 0.5), ("sigma_ctb", 0.1),
    ]
    return e, values


def incucyte_model(workdir, **options):
    """bench_incucyte's likelihood (G = INCUCYTE_GRID, ring INCUCYTE_RING,
    unless options say otherwise), built in memory; the prior (its XML in
    workdir, uniform within 25% of each value, +-0.05 around a zero) and
    the values."""
    import numpy as np

    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.cellmisc import IncucytePopulationLikelihood

    e, values = incucyte_setup()
    path = os.path.join(workdir, "prior_incucyte.xml")
    write_uniform_prior(path, [(n, False, v - (0.25 * abs(v) or 0.05), v + (0.25 * abs(v) or 0.05))
                               for n, v in values])
    varset = VariableSet.from_xml(path)
    kw = {"grid_points": INCUCYTE_GRID, "ring_size": INCUCYTE_RING, **options}
    model = IncucytePopulationLikelihood(varset, [e], **kw)
    lik = Likelihood("incucyte_population", model.log_prob_batched, model=model)
    return Prior.from_xml(path, varset), lik, np.array([v for _, v in values])


def rows_card_vs_cpu(name, lik, xs, rtol, dtype):
    """lik on the card in `dtype` against the CPU's float64 on the rows xs
    (float64 numpy): equal finite sets, at least half finite, every finite
    row within rtol. Returns the largest relative error."""
    import numpy as np
    import torch

    rows = torch.as_tensor(xs)
    cpu = lik.log_prob_batched(rows).numpy()
    card = lik.log_prob_batched(rows.to(CARD, dtype)).double().cpu().numpy()
    fin = np.isfinite(cpu)
    mismatched = int((np.isfinite(card) != fin).sum())
    rel = np.abs(card[fin] - cpu[fin]) / np.abs(cpu[fin])
    log(f"{name} ({dtype} on the card, float64 on the CPU): {int(fin.sum())}/{len(xs)} finite, "
        f"{mismatched} finite-set mismatches (limit 0), max rel err {rel.max():.3e} (limit "
        f"{rtol}), median {np.median(rel):.3e}")
    assert mismatched == 0 and fin.sum() >= len(xs) // 2 and rel.max() <= rtol
    return float(rel.max())


def event_ms(fn):
    """Milliseconds of one fn() between two CUDA events."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def incucyte_stages(model, x):
    """ms of one evaluation by stage (CUDA events, warm): the wells'
    setup, the solve, the interpolation to the timepoints, the scoring,
    and the rest of the evaluation (the observables)."""
    from bcm3_tpu_torch.likelihoods.cellmisc import _data, interp

    e = model.experiments[0]
    problem = model.well_problem(x, e)
    res = model._solve(*problem)
    tp = _data(e.timepoints, x)
    sim = model.simulate_experiment(x, e)
    total = x.new_zeros(x.shape[0])
    stages = {"evaluation": event_ms(lambda: model.log_prob_batched(x)),
              "well_setup": event_ms(lambda: model.well_problem(x, e)),
              "solve": event_ms(lambda: model._solve(*problem)),
              "interpolation": event_ms(lambda: interp(tp, problem[2], res.ys.transpose(1, 2))),
              "scoring": event_ms(lambda: model.score_experiment(x, e, sim, total))}
    stages["rest"] = stages["evaluation"] - sum(
        stages[k] for k in ("well_setup", "solve", "interpolation", "scoring"))
    return stages


def timed_evaluations(lik, x, reps):
    """(ms an evaluation on the host clock, synchronized, mean of reps after
    a warm-up; the warm-up's result)."""
    import torch

    out = lik.log_prob_batched(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        lik.log_prob_batched(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps, out


def phase_incucyte(workdir, smi):
    """incucyte_population at bench_incucyte's configuration (float32):
    evals/s at each of INCUCYTE_WIDTHS, the finite count, peak memory, the
    device's busy share of one evaluation under the profiler and, at the
    widest, the time by stage; the card against the CPU; the ring solve under the sync
    debug mode "error" (no host read); each solver at G =
    INCUCYTE_SOLVER_GRID."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.likelihoods.cellmisc import SOLVERS, IncucytePopulationLikelihood

    _, lik, values = incucyte_model(workdir)
    model = lik.model
    out = {}
    for B in INCUCYTE_WIDTHS:
        xs = bench_rows(values, B, jitter=INCUCYTE_JITTER)
        x = torch.as_tensor(xs, dtype=torch.float32, device=CARD)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        wall_ms, lp = timed_evaluations(lik, x, INCUCYTE_REPS)
        finite = int(torch.isfinite(lp).sum())
        peak = torch.cuda.max_memory_allocated() - held
        busy_ms, ops, prof_s = device_profile(lambda: lik.log_prob_batched(x))
        idle = 1.0 - busy_ms / wall_ms
        out[B] = B / wall_ms * 1e3
        log(f"incucyte_population: {B} rows x {2 + len(model.experiments[0].concentrations)} "
            f"wells, G = {model.grid_points}, ring {model.ring_size}, float32: {wall_ms:.3f} ms "
            f"an evaluation (host clock, synchronized, mean of {INCUCYTE_REPS}) = "
            f"{out[B]:.1f} evals/s; {finite}/{B} finite; peak memory {peak / 2**30:.3f} GiB "
            f"above the {held / 2**30:.3f} GiB held before; device busy {busy_ms:.3f} ms "
            f"({ops} device operations) under the profiler ({prof_s:.1f} s), idle share "
            f"{idle:.4f}; on {smi}")
        if B == max(INCUCYTE_WIDTHS):
            # where the device, not the host's launches, sets the time
            log(f"incucyte_population {B} rows, time by stage (CUDA events, ms an "
                f"evaluation): " + json.dumps(incucyte_stages(model, x)))
        assert finite == B
        del x, lp
    torch.cuda.empty_cache()

    xs = bench_rows(values, INCUCYTE_CPU_ROWS, jitter=INCUCYTE_JITTER)
    rows_card_vs_cpu("card vs CPU incucyte_population", lik, xs, INCUCYTE_RTOL, torch.float32)
    rows_card_vs_cpu("card vs CPU incucyte_population", lik, xs, F64_RTOL, torch.float64)

    # no host read inside a solve: the sync debug mode raises on one
    x = torch.as_tensor(bench_rows(values, INCUCYTE_SYNC_ROWS, jitter=INCUCYTE_JITTER),
                        dtype=torch.float32, device=CARD)
    problem = model.well_problem(x, model.experiments[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = model._solve(*problem)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"incucyte ring solve of {INCUCYTE_SYNC_ROWS} rows ({res.ok.numel()} lanes) under "
        f"torch.cuda.set_sync_debug_mode('error'): no host read; "
        f"{int(res.ok.sum())} lanes ok")
    assert bool(res.ok.all())
    del x, problem, res

    xs = bench_rows(values, INCUCYTE_SOLVER_ROWS, jitter=INCUCYTE_JITTER)
    x = torch.as_tensor(xs, dtype=torch.float32, device=CARD)
    n = INCUCYTE_SOLVER_CPU_ROWS
    solvers = {}
    for solver in SOLVERS:
        m = IncucytePopulationLikelihood(model.varset, model.experiments,
                                         grid_points=INCUCYTE_SOLVER_GRID, solver=solver)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lp = m.log_prob_batched(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        card = lp.double().cpu().numpy()
        cpu = m.log_prob_batched(torch.as_tensor(xs[:n])).numpy()
        fin = np.isfinite(cpu) & np.isfinite(card[:n])
        mismatched = int((np.isfinite(cpu) != np.isfinite(card[:n])).sum())
        rel = np.abs(card[:n][fin] - cpu[fin]) / np.abs(cpu[fin])
        finite = int(np.isfinite(card).sum())
        solvers[solver] = dict(ms=ms, finite=finite, max_rel=float(rel.max()),
                               mismatched=mismatched)
        log(f"incucyte solver {solver}, G = {INCUCYTE_SOLVER_GRID}: {INCUCYTE_SOLVER_ROWS} rows "
            f"in {ms:.1f} ms (float32, host clock, first call), {finite} finite; against the "
            f"CPU's float64 on {n} rows: {mismatched} finite-set mismatches (limit "
            f"{SOLVER_FLIPS[solver]}), max rel err {rel.max():.3e} (limit {INCUCYTE_RTOL}); "
            f"on {smi}")
        for row in np.flatnonzero(~np.isfinite(card)):
            # the row on the CPU: the method's failure, or the card's?
            on_cpu = [float(m.log_prob_batched(torch.as_tensor(xs[row:row + 1], dtype=dt))[0])
                      for dt in (torch.float32, torch.float64)]
            log(f"incucyte solver {solver}: row {row} not finite on the card (float32); on the "
                f"CPU float32 {on_cpu[0]!r}, float64 {on_cpu[1]!r}; its apoptosis_duration "
                f"{xs[row, m._ix['apoptosis_duration']]!r}")
            assert not np.isfinite(on_cpu[1]), f"row {row} fails on the card alone"
        assert rel.max() <= INCUCYTE_RTOL and mismatched <= SOLVER_FLIPS[solver]
        assert finite >= INCUCYTE_SOLVER_ROWS - SOLVER_NONFINITE[solver]
    log("incucyte solvers: " + json.dumps(solvers))
    return out


def phase_incucyte_pt(workdir, smi):
    """SamplerPT over bench_incucyte's likelihood at 8 x 8192 chains (prior
    uniform around bench's values), its wall from the one run; the
    profile over INCUCYTE_PT_PROFILE_SAMPLES iterations of a second
    sampler."""
    prior, lik, _ = incucyte_model(workdir)
    res = pt_slice("incucyte_pt", prior, lik, ENSEMBLES["one"], INCUCYTE_PT_SAMPLES,
                   profile_samples=INCUCYTE_PT_PROFILE_SAMPLES, warm=False)
    log(f"incucyte_pt on {smi}")
    return res["evals_per_second"]


def mitosis_model(workdir):
    """MITOSIS_CELLS observed boxcars over MITOSIS_TIMEPOINTS from the
    model's own Sobol construction at MITOSIS_TRUTH; the prior (uniform in
    log10 around the truth) and the truth's log10."""
    import numpy as np

    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import Likelihood
    from bcm3_tpu_torch.likelihoods.cellmisc import MitosisTimeEstimationLikelihood

    names = ("mitosis_times_stdev", "entry_time_stdev", "trajectory_noise_stdev")
    truth = np.log10(MITOSIS_TRUTH)
    path = os.path.join(workdir, "prior_mitosis.xml")
    write_uniform_prior(path, [(n, False, v - 0.5, v + 0.5) for n, v in zip(names, truth)])
    varset = VariableSet.from_xml(path)
    tp = np.linspace(0.0, 10.0, MITOSIS_TIMEPOINTS)
    model = MitosisTimeEstimationLikelihood(varset, tp,
                                            np.zeros((MITOSIS_TIMEPOINTS, MITOSIS_CELLS)))
    start = model.sobol_values[:, 1:2] * MITOSIS_TRUTH[1]
    end = start + model.sobol_values[:, :1] * MITOSIS_TRUTH[0]
    model.observed = ((tp[None, :] >= start) & (tp[None, :] < end)).astype(float).T
    lik = Likelihood("mitosis_time_estimation", model.log_prob_batched, model=model)
    return Prior.from_xml(path, varset), lik, truth


def phase_mitosis(workdir, smi):
    """mitosis_time_estimation: MITOSIS_ROWS rows, evals/s split into the
    cost on the card, its copy to the host and the native matching; the
    native matching against scipy; the card against the CPU; one PT run."""
    import numpy as np
    import torch

    from bcm3_tpu_torch import native
    from bcm3_tpu_torch.cellpop.data_likelihood import host_costs
    from bcm3_tpu_torch.sampler import SamplerPT

    t = time.perf_counter()
    lib = native.build_lap_library()
    native.get_lap_library()
    log(f"native matching: {lib.name} built or found and loaded in "
        f"{time.perf_counter() - t:.2f} s; {native.match_threads()} threads")
    prior, lik, truth = mitosis_model(workdir)
    model = lik.model
    rng = np.random.default_rng(0)
    xs = truth + MITOSIS_JITTER * rng.normal(size=(MITOSIS_ROWS, 3))
    x = torch.as_tensor(xs, dtype=torch.float32, device=CARD)
    wall_ms, lp = timed_evaluations(lik, x, INCUCYTE_REPS)
    finite = int(torch.isfinite(lp).sum())
    cost_ms = cuda_ms(lambda: model.cost(x), INCUCYTE_REPS)
    cost = model.cost(x)
    host_costs(cost)  # the pinned staging buffer, allocated once
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = host_costs(cost)
    copy_ms = (time.perf_counter() - t) * 1e3
    ones = np.ones(MITOSIS_CELLS, dtype=bool)
    t = time.perf_counter()
    totals = native.lap_match_logp_batch(host, ones, ones)
    match_ms = (time.perf_counter() - t) * 1e3
    log(f"mitosis_time_estimation: {MITOSIS_ROWS} rows x {MITOSIS_CELLS} cells x "
        f"{MITOSIS_TIMEPOINTS} timepoints, float32: {wall_ms:.3f} ms an evaluation (host "
        f"clock, mean of {INCUCYTE_REPS}) = {MITOSIS_ROWS / wall_ms * 1e3:.1f} evals/s; "
        f"{finite}/{MITOSIS_ROWS} finite; the cost on the card {cost_ms:.3f} ms (CUDA "
        f"events), its copy to the host in float64 ({host.nbytes / 2**20:.0f} MiB, pinned) "
        f"{copy_ms:.3f} ms, the matching {match_ms:.3f} ms = "
        f"{match_ms * 1e3 / MITOSIS_ROWS:.3f} us a row (host clock); on {smi}")
    assert finite == MITOSIS_ROWS

    n = MITOSIS_SCIPY_ROWS
    t = time.perf_counter()
    plain = native.lap_match_logp_batch_plain(host[:n], ones, ones)
    scipy_ms = (time.perf_counter() - t) * 1e3
    rel = np.abs(totals[:n] - plain) / np.abs(plain)
    log(f"native matching vs scipy on {n} rows: max rel err {rel.max():.3e} (limit "
        f"{MATCH_RTOL}); scipy {scipy_ms * 1e3 / n:.3f} us a row, native "
        f"{match_ms * 1e3 / MITOSIS_ROWS:.3f}")
    assert np.isfinite(plain).all() and rel.max() <= MATCH_RTOL
    del x, lp, cost, host

    xs_cpu = xs[:MITOSIS_CPU_ROWS]
    rows_card_vs_cpu("card vs CPU mitosis_time_estimation", lik, xs_cpu, MITOSIS_RTOL,
                     torch.float32)
    rows_card_vs_cpu("card vs CPU mitosis_time_estimation", lik, xs_cpu, F64_RTOL,
                     torch.float64)

    sampler = SamplerPT(prior, lik, pt_config(ENSEMBLES["one"], MITOSIS_PT_SAMPLES))
    res = sampler.run()
    lpost = res["log_prior"] + res["log_likelihood"]
    mut, exc = sampler.acceptance_rates(sampler.state)
    iterations = MITOSIS_PT_SAMPLES * USE_EVERY_NTH
    log(f"mitosis_pt: {NUM_CHAINS} x {ENSEMBLES['one']} chains, {MITOSIS_PT_SAMPLES} samples "
        f"thinned by {USE_EVERY_NTH}: {res['evaluations']} evaluations in "
        f"{res['elapsed_seconds']:.3f} s = {res['evals_per_second']:.1f} evals/s, wall "
        f"{res['sampling_seconds'] * 1e3 / iterations:.3f} ms an iteration; T=1 mutate "
        f"acceptance {mut[-1]:.4f}, exchange {np.round(exc, 4).tolist()}; on {smi}")
    assert np.isfinite(lpost).all() and 0.0 < mut[-1] < 1.0
    return MITOSIS_ROWS / wall_ms * 1e3


def ccm_track(n=220, seed=0):
    """tests/test_cellmisc.py:41-79's track: the model's own piecewise form
    at CCM_TRUTH with t(4) noise."""
    import numpy as np

    s_entry, s_dur, plat_dur, base, s_inc, plat_inc, mit_frac, mit_dec = CCM_TRUTH[:8]
    i = np.arange(n, dtype=float)
    plateau_t, mitosis_t = s_entry + s_dur, s_entry + s_dur + plat_dur
    x = np.full_like(i, base)
    sel = (i > s_entry) & (i <= plateau_t)
    x[sel] = base + s_inc * (i[sel] - s_entry)
    sel = (i > plateau_t) & (i <= mitosis_t)
    x[sel] = base + s_dur * s_inc + (i[sel] - plateau_t) * plat_inc
    sel = i > mitosis_t
    x[sel] = base + (s_dur * s_inc + plat_dur * plat_inc) * mit_frac - mit_dec * (i[sel] - mitosis_t)
    rng = np.random.default_rng(seed)
    return x + rng.standard_t(4, size=n) * (1.0 + 0.02 * np.maximum(x, 0))


def phase_cell_cycle_marker(smi):
    """cell_cycle_marker over the 220-point track at CCM_ROWS rows
    (float32): evals/s, the card against the CPU."""
    import numpy as np
    import torch

    from bcm3_tpu_torch import VariableSet
    from bcm3_tpu_torch.likelihoods.cellmisc import CellCycleMarkerLikelihood

    vs = VariableSet()
    for k in range(10):
        vs.add_variable(f"v{k}")
    model = CellCycleMarkerLikelihood(vs, ccm_track())
    rng = np.random.default_rng(0)
    xs = np.array(CCM_TRUTH) * (1.0 + 0.1 * rng.normal(size=(CCM_ROWS, 10)))
    x = torch.as_tensor(xs, dtype=torch.float32, device=CARD)
    ms = cuda_ms(lambda: model.log_prob_batched(x), INCUCYTE_REPS)
    finite = int(torch.isfinite(model.log_prob_batched(x)).sum())
    log(f"cell_cycle_marker: {CCM_ROWS} rows x {len(model.data)} points, float32: {ms:.4f} ms "
        f"an evaluation (CUDA events) = {CCM_ROWS / ms * 1e3:.1f} evals/s, {finite} finite; "
        f"on {smi}")
    assert finite == CCM_ROWS
    rows_card_vs_cpu("card vs CPU cell_cycle_marker", model, xs[:CCM_CPU_ROWS], CCM_RTOL,
                     torch.float32)
    return CCM_ROWS / ms * 1e3


# ---------------------------------------------------------------------------
# The cell-population likelihood (phases 31-34)

SBML_NS = "http://www.sbml.org/sbml/level2/version4"
MATHML = "http://www.w3.org/1998/Math/MathML"

# tools/bench_cellpop.py:29-90's model (that module and
# tools/bench_cellpop_scaling.py import the JAX package and h5py)
CELL_MODEL = f"""<?xml version="1.0"?>
<sbml xmlns="{SBML_NS}" level="2" version="4">
<model id="cell">
<listOfSpecies>
  <species id="mass" name="mass" initialAmount="1.0"/>
  <species id="cytokinesis" name="cytokinesis" initialAmount="0.0"/>
  <species id="Ka" name="Ka" initialAmount="0.0"/>
  <species id="Xp" name="Xp" initialAmount="0.0"/>
  <species id="env" name="env" initialAmount="1.0"/>
</listOfSpecies>
<listOfParameters>
  <parameter id="Ktot" value="1.0"/>
  <parameter id="Xtot" value="1.0"/>
  <parameter id="k_act" value="2000.0"/>
  <parameter id="k_deact" value="1000.0"/>
  <parameter id="k_phos" value="3000.0"/>
  <parameter id="k_dephos" value="1500.0"/>
</listOfParameters>
<listOfReactions>
  <reaction id="growth">
    <listOfProducts><speciesReference species="mass"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_growth</ci><ci>mass</ci>
        <apply><minus/><cn>1</cn><ci>Xp</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="division_clock">
    <listOfProducts><speciesReference species="cytokinesis"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}"><ci>k_div</ci></math></kineticLaw>
  </reaction>
  <reaction id="k_activation">
    <listOfProducts><speciesReference species="Ka"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_act</ci><ci>mass</ci>
        <apply><minus/><ci>Ktot</ci><ci>Ka</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="k_deactivation">
    <listOfReactants><speciesReference species="Ka"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_deact</ci><ci>Ka</ci></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="x_phos">
    <listOfProducts><speciesReference species="Xp"/></listOfProducts>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_phos</ci><ci>Ka</ci>
        <apply><minus/><ci>Xtot</ci><ci>Xp</ci></apply></apply>
    </math></kineticLaw>
  </reaction>
  <reaction id="x_dephos">
    <listOfReactants><speciesReference species="Xp"/></listOfReactants>
    <kineticLaw><math xmlns="{MATHML}">
      <apply><times/><ci>k_dephos</ci><ci>Xp</ci></apply>
    </math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""


def _reaction(rid, products, reactants, math):
    prods = "".join(f'<speciesReference species="{s}"/>' for s in products)
    reacts = "".join(f'<speciesReference species="{s}"/>' for s in reactants)
    plist = f"<listOfProducts>{prods}</listOfProducts>" if prods else ""
    rlist = f"<listOfReactants>{reacts}</listOfReactants>" if reacts else ""
    return (
        f'<reaction id="{rid}">{rlist}{plist}'
        f'<kineticLaw><math xmlns="{MATHML}">{math}</math></kineticLaw>'
        "</reaction>"
    )


def cascade_model(extra_modules):
    """tools/bench_cellpop_scaling.py:59's dividing-cell model with a stiff
    kinase cascade of `extra_modules` (Ka_i, Xp_i) modules: 5 + 2 m species."""
    species = [
        '<species id="mass" name="mass" initialAmount="1.0"/>',
        '<species id="cytokinesis" name="cytokinesis" initialAmount="0.0"/>',
        '<species id="Ka" name="Ka" initialAmount="0.0"/>',
        '<species id="Xp" name="Xp" initialAmount="0.0"/>',
        '<species id="env" name="env" initialAmount="1.0"/>',
    ]
    reactions = [
        _reaction("growth", ["mass"], [],
                  "<apply><times/><ci>k_growth</ci><ci>mass</ci>"
                  "<apply><minus/><cn>1</cn><ci>Xp</ci></apply></apply>"),
        _reaction("division_clock", ["cytokinesis"], [], "<ci>k_div</ci>"),
        _reaction("k_activation", ["Ka"], [],
                  "<apply><times/><ci>k_act</ci><ci>mass</ci>"
                  "<apply><minus/><ci>Ktot</ci><ci>Ka</ci></apply></apply>"),
        _reaction("k_deactivation", [], ["Ka"],
                  "<apply><times/><ci>k_deact</ci><ci>Ka</ci></apply>"),
        _reaction("x_phos", ["Xp"], [],
                  "<apply><times/><ci>k_phos</ci><ci>Ka</ci>"
                  "<apply><minus/><ci>Xtot</ci><ci>Xp</ci></apply></apply>"),
        _reaction("x_dephos", [], ["Xp"],
                  "<apply><times/><ci>k_dephos</ci><ci>Xp</ci></apply>"),
    ]
    for i in range(extra_modules):
        ka, xp = f"Ka{i}", f"Xp{i}"
        driver = "mass" if i == 0 else f"Xp{i - 1}"
        species.append(f'<species id="{ka}" initialAmount="0.0"/>')
        species.append(f'<species id="{xp}" initialAmount="0.0"/>')
        reactions.append(_reaction(
            f"k_act_{i}", [ka], [],
            f"<apply><times/><ci>k_act</ci><ci>{driver}</ci>"
            f"<apply><minus/><ci>Ktot</ci><ci>{ka}</ci></apply></apply>"))
        reactions.append(_reaction(
            f"k_deact_{i}", [], [ka], f"<apply><times/><ci>k_deact</ci><ci>{ka}</ci></apply>"))
        reactions.append(_reaction(
            f"x_phos_{i}", [xp], [],
            f"<apply><times/><ci>k_phos</ci><ci>{ka}</ci>"
            f"<apply><minus/><ci>Xtot</ci><ci>{xp}</ci></apply></apply>"))
        reactions.append(_reaction(
            f"x_dephos_{i}", [], [xp], f"<apply><times/><ci>k_dephos</ci><ci>{xp}</ci></apply>"))
    params = (
        '<parameter id="Ktot" value="1.0"/>'
        '<parameter id="Xtot" value="1.0"/>'
        '<parameter id="k_act" value="2000.0"/>'
        '<parameter id="k_deact" value="1000.0"/>'
        '<parameter id="k_phos" value="3000.0"/>'
        '<parameter id="k_dephos" value="1500.0"/>'
    )
    return (
        f'<?xml version="1.0"?>\n<sbml xmlns="{SBML_NS}" level="2"'
        ' version="4">\n<model id="cell">\n'
        f"<listOfSpecies>{''.join(species)}</listOfSpecies>\n"
        f"<listOfParameters>{params}</listOfParameters>\n"
        f"<listOfReactions>{''.join(reactions)}</listOfReactions>\n"
        "</model>\n</sbml>\n"
    )


CELLPOP_NAMES = ("k_growth", "k_div", "cv_kdiv", "sd")
CELLPOP_BASE = (0.1, 0.25, 0.15, 0.05)  # bench.py:776
# bench.py's cellpop configurations: (extra cascade modules, scoring)
CELLPOP_CONFIGS = {"cellpop": (None, "average"), "cellpop21": (8, "average"),
                   "cellpop_matched": (0, "matched")}


def cellpop_files(workdir, config, cells, num_cells):
    """Write a bench cellpop configuration's cell.xml and likelihood.xml
    (tools/bench_cellpop.py and tools/bench_cellpop_scaling.py
    build_likelihood, adaptive RODAS3 at rtol = atol = 1e-6) into workdir;
    return the likelihood.xml's path and the data group of experiment
    "exp1" as a mapping of numpy arrays (the tools write it to data.nc)."""
    import numpy as np

    modules, scoring = CELLPOP_CONFIGS[config]
    with open(os.path.join(workdir, "cell.xml"), "w") as f:
        f.write(CELL_MODEL if modules is None else cascade_model(modules))
    times = np.linspace(0.5, 10.0, 12)
    k_growth = 0.1
    if scoring == "matched":
        # per-cell observed time courses, one a cell, with spread
        rng = np.random.default_rng(3)
        obs = np.exp(k_growth * 0.6 * times)[None, :] * rng.lognormal(0.0, 0.15,
                                                                       size=(num_cells, 1))
        data = {"time": times, "cell_mass": obs}
        block = ('  <data type="time_course" data_name="cell_mass"\n'
                 '    species_name="mass" error_model="normal" stdev="sd"/>\n')
    else:
        data = {"time": times, "avg_mass": np.exp(k_growth * 0.6 * times)[None, :]}
        block = ('  <data type="time_course_population_average" data_name="avg_mass"\n'
                 '    species_name="mass" error_model="normal" stdev="sd"/>\n')
    path = os.path.join(workdir, "likelihood.xml")
    with open(path, "w") as f:
        f.write(
            '<bcm_likelihood type="cell_population">\n'
            '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
            f'  num_cells="{num_cells}" max_cells="{cells}" divide_cells="true"'
            ' entry_time="0"\n'
            '  solver_type="CVODE" solver_relative_tolerance="1e-6"\n'
            '  solver_absolute_tolerance="1e-6" trailing_simulation_time="0.5">\n'
            '  <cell_variability distribution="diagonal_gaussian">\n'
            '    <variable model_parameter="k_div" apply="multiplicative_log"'
            ' scale="cv_kdiv"/>\n'
            "  </cell_variability>\n"
            + block
            + "</experiment>\n"
            "</bcm_likelihood>\n"
        )
    return path, data


def cellpop_model(workdir, config, cells=128, num_cells=16, sparse_stiff=True):
    """A bench cellpop configuration's likelihood through the registry
    (`create_likelihood` on its likelihood.xml, the data in memory); the
    prior (uniform within 25% of bench's values, its XML in workdir)."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import create_likelihood

    sub = os.path.join(workdir, f"{config}_{cells}_{num_cells}")
    os.makedirs(sub, exist_ok=True)
    path, data = cellpop_files(sub, config, cells, num_cells)
    prior_path = os.path.join(sub, "prior.xml")
    write_uniform_prior(prior_path, [(n, False, 0.75 * v, 1.25 * v)
                                     for n, v in zip(CELLPOP_NAMES, CELLPOP_BASE)])
    varset = VariableSet.from_xml(prior_path)
    lik = create_likelihood(path, varset, _data={"exp1": data}, _sparse_stiff=sparse_stiff)
    return Prior.from_xml(prior_path, varset), lik


def cellpop_rows(rows, seed=0):
    """bench.py:776-779's rows: base x exp(0.05 N(0, 1)), the normals from
    a numpy seed (bench draws them with a JAX key); float64 on the host."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.array(CELLPOP_BASE) * np.exp(0.05 * rng.normal(size=(rows, 4)))


CELLPOP_ROWS, CELLPOP_CELLS, CELLPOP_INITIAL = 512, 128, 16  # bench.py:758-767
CELLPOP_REPS = {"cellpop": 3, "cellpop21": 1, "cellpop_matched": 1}
CELLPOP_CPU_ROWS = 64
# rows whose lanes all took the CPU's step counts are held at F64_RTOL; a
# row with a lane that took another (see phase_cellpop_card_vs_cpu) at
# the solver's rtol
CELLPOP_SOLVER_RTOL = 1e-6
CELLPOP_BUDGET_TRIPS = 256
CELLPOP_PT_ENSEMBLES, CELLPOP_PT_SAMPLES, CELLPOP_PT_THIN = 64, 1, 3


def device_busy(fn):
    """(device busy ms, device operations, the profile's seconds) of one
    fn() under the profiler, the device alone, summed from the profiler's
    raw events (`device_profile` builds every event's Python object, ~0.2
    ms each: minutes for the ~200,000 operations of a cellpop
    evaluation). CUPTI has returned a trace without device events for a
    call that launches thousands of kernels: such a call is profiled once
    more, and raises if that trace holds no device event either."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        if device:
            break
        log("device_busy: the profiler traced no device event; profiling the call once more")
    assert device, "the profiler traced no device event"
    return sum(device) / 1e6, len(device), time.perf_counter() - t


def cellpop_round_summary(exp):
    """The simulation's rounds as recorded in exp.rounds: lanes solved, the
    steps of a lane (mean, max), skipped rounds. One read of the steps."""
    out = []
    for r in exp.rounds:
        if r.lanes:
            st = r.steps.double().cpu()
            out.append(dict(lanes=r.lanes, steps_mean=float(st.mean()), steps_max=int(st.max())))
        else:
            out.append(dict(lanes=0))
    return out


def host_reads(fn):
    """(fn()'s result, the host reads it made): torch's warnings in the
    sync debug mode "warn", one a synchronizing call (not the notice that
    the mode is a prototype, which the mode's first use in a process
    gives)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def cellpop_stages(exp, fn):
    """ms of one fn() (an evaluation) by stage, from CUDA events recorded
    at each stage's end (exp.on_stage): setup, each round's solve, events
    and allocation, the read-out, the scoring (the matching's host work
    included)."""
    import torch

    marks = [("start", torch.cuda.Event(enable_timing=True))]
    marks[0][1].record()

    def on_stage(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    exp.on_stage = on_stage
    try:
        fn()
    finally:
        exp.on_stage = None
    torch.cuda.synchronize()
    stages, rnd = {}, 0
    for (_, a), (name, b) in zip(marks, marks[1:]):
        key = f"{name}_{rnd}" if name in ("solve", "events", "allocation") else name
        stages[key] = round(stages.get(key, 0.0) + a.elapsed_time(b), 3)
        rnd += name == "events"
    return stages


def stage_solver_timing(exp, B, smi):
    """The cellpop21 step's linear algebra at B x capacity lanes on one
    step's matrices (the model's Jacobian at perturbed initial states):
    the sparse stage solver (factor_G + 4 solves) against the dense
    lu_factor_ex + 4 lu_solve, float32, CUDA events; the solutions against
    each other."""
    import numpy as np
    import torch

    n = exp.model.num_ode_species
    L = B * exp.max_cells
    gen = torch.Generator(device=CARD)
    gen.manual_seed(5)
    y = torch.as_tensor(exp.model.initial_ode_values(), dtype=torch.float32, device=CARD)
    y = y + torch.rand(L, n, generator=gen, device=CARD)
    x = torch.as_tensor(cellpop_rows(L), dtype=torch.float32, device=CARD)
    const = torch.as_tensor(exp.model.initial_constant_values(), dtype=torch.float32,
                            device=CARD).expand(L, -1)
    t = torch.zeros(L, device=CARD)
    f0, ft, J = exp._jac(t, y, (x, const, t))
    inv_hg = torch.full((L,), 1.0 / (1e-3 * 0.5), device=CARD)
    rhs = [torch.rand(L, n, generator=gen, device=CARD) for _ in range(4)]
    sparse = exp.sparse_solver

    def run_sparse():
        A = sparse.factor_G(sparse.entries_from_jacobian(J), inv_hg)
        return [sparse.solve(A, r) for r in rhs]

    def run_dense():
        G = torch.eye(n, device=CARD) * inv_hg[:, None, None] - J
        LU, piv, _ = torch.linalg.lu_factor_ex(G)
        return [torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0] for r in rhs]

    xs, xd = run_sparse(), run_dense()
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-6)).max()) for a, b in zip(xs, xd))
    ms_sparse = cuda_ms(run_sparse, 10)
    ms_dense = cuda_ms(run_dense, 10)
    _, ops_sparse, _ = device_busy(run_sparse)
    _, ops_dense, _ = device_busy(run_dense)
    log(f"cellpop21 stage solver at {L} lanes, n = {n}, float32 (one step's factor + 4 "
        f"solves, CUDA events, mean of 10): sparse {ms_sparse:.3f} ms ({ops_sparse} device "
        f"operations; {len(sparse._boxes)} elimination columns, fill {sparse.fill_nnz} of "
        f"{n * n}), dense lu_factor_ex + lu_solve {ms_dense:.3f} ms ({ops_dense} operations); "
        f"solutions agree to {rel:.2e} (relative); on {smi}")
    assert np.isfinite(rel) and rel <= 1e-3
    return dict(sparse_ms=ms_sparse, dense_ms=ms_dense)


def phase_cellpop_config(workdir, smi, config):
    """bench.py's `config` at its width (CELLPOP_ROWS rows x CELLPOP_CELLS
    cells, CELLPOP_INITIAL initial, float32): a first evaluation (its host
    reads counted, its rounds recorded; under the profiler, device busy
    and operations, with CUDA events at each stage, but for
    cellpop_matched, whose evaluation is split in `cellpop_matching`
    instead), then CELLPOP_REPS[config] timed evaluations; peak memory."""
    import torch

    _, lik = cellpop_model(workdir, config, CELLPOP_CELLS, CELLPOP_INITIAL)
    exp = lik.model.experiments[0]
    x = torch.as_tensor(cellpop_rows(CELLPOP_ROWS), dtype=torch.float32, device=CARD)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    exp.rounds = []
    stages, got = {}, {}

    def first():
        got["lp"], got["reads"] = host_reads(lambda: lik.log_prob_batched(x))

    t = time.perf_counter()
    if config == "cellpop_matched":
        # the same simulation as cellpop's: its matching is timed apart below
        first()
        profiled = "not profiled (the simulation is cellpop's)"
        busy_ms = ops = None
    else:
        busy_ms, ops, prof_s = device_busy(lambda: stages.update(cellpop_stages(exp, first)))
        profiled = (f"{ops} device operations an evaluation; device busy {busy_ms:.1f} ms "
                    f"(the first evaluation, profiled: {prof_s:.1f} s)")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    lp, reads = got["lp"], got["reads"]
    rounds = cellpop_round_summary(exp)
    exp.rounds = None
    reps = CELLPOP_REPS[config]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        lik.log_prob_batched(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / reps
    if busy_ms is not None:
        profiled += f", idle share {1.0 - busy_ms / wall_ms:.4f}"
    peak = torch.cuda.max_memory_allocated() - held
    finite = int(torch.isfinite(lp).sum())
    solver = "sparse" if exp.sparse_solver is not None else "dense"
    B = CELLPOP_ROWS
    log(f"{config}: {B} rows x {CELLPOP_CELLS} cells ({CELLPOP_INITIAL} initial), "
        f"{exp.model.num_ode_species} ODE species, adaptive RODAS3 through the {solver} stage "
        f"solver, float32: first evaluation {first_ms:.1f} ms; {wall_ms:.1f} ms an evaluation "
        f"(host clock, synchronized, mean of {reps}) = {B / wall_ms * 1e3:.1f} evals/s; "
        f"{finite}/{B} finite; {reads} host reads an evaluation; {profiled}; peak memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held before; on {smi}")
    log(f"{config} rounds (lanes, RODAS3 steps a lane): {json.dumps(rounds)}; "
        f"{sum(r['lanes'] > 0 for r in rounds)} solved, {sum(r['lanes'] == 0 for r in rounds)} "
        f"skipped")
    if busy_ms is not None:
        log(f"{config} time by stage (CUDA events in the first evaluation, profiled, ms): "
            f"{json.dumps(stages)}")
    assert finite == B
    out = dict(evals_per_second=B / wall_ms * 1e3, ms=wall_ms, busy_ms=busy_ms, ops=ops,
               reads=reads, rounds=rounds)
    if config == "cellpop21":
        out["stage_solver"] = stage_solver_timing(exp, B, smi)
    if config == "cellpop_matched":
        out["matching"] = cellpop_matching(lik, x, smi)
    return out


def cellpop_matching(lik, x, smi):
    """The matched configuration's evaluation split: the device part
    (simulation and cost matrices, CUDA events), the cost's pinned copy to
    the host and the native matching (host clock), as `mitosis` splits it."""
    import numpy as np
    import torch

    from bcm3_tpu_torch import native
    from bcm3_tpu_torch.cellpop.data_likelihood import host_costs

    exp = lik.model.experiments[0]
    tv = lik.model._transform(x)
    parts = {}
    device_ms = event_ms(lambda: parts.setdefault("p", exp.log_prob_parts(tv)))
    _, _, ((cost, ov, sv),) = parts["p"]
    host_costs(cost)  # the pinned staging buffer, allocated once
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = host_costs(cost)
    copy_ms = (time.perf_counter() - t) * 1e3
    ovn, svn = ov.cpu().numpy(), sv.cpu().numpy()
    t = time.perf_counter()
    totals = native.lap_match_logp_batch(host, ovn, svn)
    match_ms = (time.perf_counter() - t) * 1e3
    log(f"cellpop_matched evaluation split: simulation and cost matrices on the card "
        f"{device_ms:.1f} ms (CUDA events), the cost ({host.nbytes / 2**20:.1f} MiB float64) "
        f"pinned copy {copy_ms:.3f} ms, the native matching of {cost.shape[0]} rows "
        f"{match_ms:.3f} ms = {match_ms * 1e3 / cost.shape[0]:.2f} us a row (host clock); "
        f"on {smi}")
    assert np.isfinite(totals).all()
    return dict(device_ms=device_ms, copy_ms=copy_ms, match_ms=match_ms)


def phase_cellpop(workdir, smi):
    return phase_cellpop_config(workdir, smi, "cellpop")


def phase_cellpop21(workdir, smi):
    return phase_cellpop_config(workdir, smi, "cellpop21")


def phase_cellpop_matched(workdir, smi):
    return phase_cellpop_config(workdir, smi, "cellpop_matched")


def cellpop_steps(exp):
    """{flat lane: steps} of every solved lane of each round of the last
    evaluation, one dict a round."""
    return [dict(zip(r.index.cpu().tolist(), r.steps.cpu().tolist())) if r.lanes else {}
            for r in exp.rounds]


def cellpop_cpu_reference(workdir, path):
    """The CPU's side of `phase_cellpop_card_vs_cpu`, run in a process of
    its own while the card runs the cellpop phases: for each configuration
    on CELLPOP_CPU_ROWS rows the float64 log-densities and each round's
    {lane: steps}, and the float32 log-densities, into `path` (JSON)."""
    import torch

    torch.set_num_threads(4)  # the card's phases keep a core busy launching
    out = {}
    for config in CELLPOP_CONFIGS:
        _, lik = cellpop_model(os.path.join(workdir, "cpu"), config, CELLPOP_CELLS,
                               CELLPOP_INITIAL)
        exp = lik.model.experiments[0]
        rows = torch.as_tensor(cellpop_rows(CELLPOP_CPU_ROWS, seed=1))
        exp.rounds = []
        lp64 = lik.log_prob_batched(rows).tolist()
        steps = [{str(k): v for k, v in r.items()} for r in cellpop_steps(exp)]
        exp.rounds = None
        lp32 = lik.log_prob_batched(rows.float()).double().tolist()
        out[config] = dict(lp64=lp64, steps=steps, lp32=lp32)
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def start_cellpop_cpu_reference(workdir):
    """The CPU reference's process (spawned: this one has CUDA state) and
    its result file."""
    import multiprocessing

    path = os.path.join(workdir, "cellpop_cpu_reference.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=cellpop_cpu_reference, args=(workdir, path), daemon=True)
    proc.start()
    return proc, path


def phase_cellpop_card_vs_cpu(workdir, smi, reference):
    """Each configuration on CELLPOP_CPU_ROWS rows: the card's float64
    against the CPU's (`reference`: the process of `cellpop_cpu_reference`
    and its file, waited for here), lane by lane the RODAS3 step counts of
    every round and row by row the log-density (F64_RTOL where every lane
    took the CPU's step count, the solver's rtol otherwise; equal -inf
    sets); the card's float32 against the CPU's float64, its limit ten
    times the CPU's own float32 error on the rows; the budget form's solve
    of the cellpop rows' first round under the sync debug mode "error"."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.ode.rosenbrock import solve_at_times_stiff_budget

    proc, path = reference
    cards = {}
    for config in CELLPOP_CONFIGS:
        _, lik = cellpop_model(workdir, config, CELLPOP_CELLS, CELLPOP_INITIAL)
        exp = lik.model.experiments[0]
        rows = torch.as_tensor(cellpop_rows(CELLPOP_CPU_ROWS, seed=1), device=CARD)
        exp.rounds = []
        card = lik.log_prob_batched(rows).cpu().numpy()
        steps = cellpop_steps(exp)
        exp.rounds = None
        card32 = lik.log_prob_batched(rows.float()).double().cpu().numpy()
        cards[config] = (card, steps, card32, exp.max_cells)
    t = time.perf_counter()
    proc.join(timeout=600)
    waited = time.perf_counter() - t
    assert proc.exitcode == 0, f"the CPU reference's process ended with {proc.exitcode}"
    with open(path) as f:
        reference = json.load(f)
    log(f"cellpop card vs CPU: the CPU reference (a process of its own) waited for "
        f"{waited:.1f} s after the card's runs")
    out = {}
    for config, (card, steps_card, card32, N) in cards.items():
        ref = reference[config]
        cpu, cpu32 = np.array(ref["lp64"]), np.array(ref["lp32"])
        steps_cpu = [{int(k): v for k, v in r.items()} for r in ref["steps"]]
        lanes = differ = 0
        rows_apart = set()
        for r, (a, b) in enumerate(zip(steps_cpu, steps_card)):
            assert a.keys() == b.keys(), f"{config}: round {r} solved other lanes on the card"
            lanes += len(a)
            for lane in a:
                if a[lane] != b[lane]:
                    differ += 1
                    rows_apart.add(lane // N)
                    if differ <= 8:
                        log(f"{config} card vs CPU: round {r} lane {lane} (row {lane // N}, "
                            f"slot {lane % N}) {b[lane]} steps on the card, {a[lane]} on the CPU")
        fin = np.isfinite(cpu)
        assert np.array_equal(fin, np.isfinite(card)) and fin.all()
        rel = np.abs(card - cpu) / np.abs(cpu)
        same = np.array([i not in rows_apart for i in range(len(cpu))])
        log(f"{config} card vs CPU, float64, {CELLPOP_CPU_ROWS} rows: {lanes} lanes solved, "
            f"{differ} ({differ / max(lanes, 1):.4%}) took another step count on the card, in "
            f"{len(rows_apart)} rows; max rel err {rel[same].max(initial=0.0):.3e} on the rows "
            f"without one (limit {F64_RTOL}), {rel[~same].max(initial=0.0):.3e} on the others "
            f"(limit {CELLPOP_SOLVER_RTOL}); on {smi}")
        assert rel[same].max(initial=0.0) <= F64_RTOL
        assert rel[~same].max(initial=0.0) <= CELLPOP_SOLVER_RTOL
        own = float((np.abs(cpu32 - cpu) / np.abs(cpu)).max())
        rel32 = np.abs(card32 - cpu) / np.abs(cpu)
        log(f"{config} card float32 vs CPU float64: max rel err {rel32.max():.3e} (limit "
            f"{10 * own:.3e}, ten times the CPU's own float32 error {own:.3e})")
        assert np.isfinite(card32).all() and rel32.max() <= 10 * own
        out[config] = dict(lanes=lanes, differ=differ, rel64=float(rel[same].max(initial=0.0)),
                           rel32=float(rel32.max()), own32=own)

    # the budget form makes no host read: the first round of the cellpop rows
    _, lik = cellpop_model(workdir, "cellpop", CELLPOP_CELLS, CELLPOP_INITIAL)
    exp = lik.model.experiments[0]
    tv = torch.as_tensor(cellpop_rows(CELLPOP_ROWS), dtype=torch.float32, device=CARD)
    nsp = exp._nsp(tv)
    C0, n = exp.initial_cells, exp.model.num_ode_species
    y0 = exp._initial_conditions_with_variability(exp._initial_state(tv), tv, nsp, True)
    params = exp._cell_params(tv, nsp, True)[:, :C0].reshape(-1, tv.shape[1])
    L = params.shape[0]
    consts = exp._const("const_y", exp.model.initial_constant_values(), tv).expand(L, -1)
    creation = exp._entry_times(tv, nsp)[:, :C0].reshape(-1)
    args = (params, consts, creation)
    grid = exp._const("grid", exp.grid, tv)
    kw = dict(args=args, rtol=exp.rtol, atol=exp.atol, sparse=exp.sparse_solver, jac=exp._jac)
    y0 = y0[:, :C0].reshape(-1, n)
    # one trip first: the solver's index tables are copied to the card at
    # their first use
    solve_at_times_stiff_budget(exp._rhs, y0, grid, total_trips=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solve_at_times_stiff_budget(exp._rhs, y0, grid, total_trips=CELLPOP_BUDGET_TRIPS,
                                          **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"cellpop budget RODAS3 solve of the first round ({L} lanes, {CELLPOP_BUDGET_TRIPS} "
        f"trips, float32) under torch.cuda.set_sync_debug_mode('error'): no host read; "
        f"{int(res.ok.sum())} lanes reached the grid's end within the budget")
    out["budget_lanes_ok"] = int(res.ok.sum())
    return out


def phase_cellpop_pt(workdir, smi):
    """SamplerPT over the registry's cell_population likelihood at
    bench_cellpop's configuration, 8 x CELLPOP_PT_ENSEMBLES chains (bench's
    512 rows), CELLPOP_PT_SAMPLES sample thinned by CELLPOP_PT_THIN: one run
    (its outputs checked; the wall of its iterations), then one more
    iteration under the profiler (device busy; the slices' profile of a
    whole run would process ~1 M host and device events an iteration)."""
    import numpy as np

    from bcm3_tpu_torch.sampler import SamplerPT

    prior, lik = cellpop_model(workdir, "cellpop", CELLPOP_CELLS, CELLPOP_INITIAL)
    cfg = dataclasses.replace(pt_config(CELLPOP_PT_ENSEMBLES, CELLPOP_PT_SAMPLES),
                              use_every_nth=CELLPOP_PT_THIN)
    sampler = SamplerPT(prior, lik, cfg)
    res = sampler.run()
    lpost = res["log_prior"] + res["log_likelihood"]
    mut, exc = sampler.acceptance_rates(sampler.state)
    iterations = cfg.num_samples * cfg.use_every_nth
    wall_ms = res["sampling_seconds"] * 1e3 / iterations
    busy_ms, ops, prof_s = device_busy(
        lambda: sampler._iteration(sampler.state, sampler.proposals,
                                   sampler.draw(sampler.proposals)))
    log(f"cellpop_pt: {NUM_CHAINS} x {CELLPOP_PT_ENSEMBLES} chains, {iterations} iterations "
        f"({res['evaluations']} evaluations in {res['elapsed_seconds']:.3f} s with the start "
        f"search): wall {wall_ms:.1f} ms an iteration = {res['evals_per_second']:.1f} evals/s "
        f"of the run; one more iteration under the profiler: device busy {busy_ms:.1f} ms "
        f"({ops} device operations, {prof_s:.1f} s), idle share {1.0 - busy_ms / wall_ms:.4f}; "
        f"T=1 mutate acceptance {mut[-1]:.4f}, exchange {np.round(exc, 4).tolist()}; on {smi}")
    assert np.isfinite(lpost).all() and 0.0 < mut[-1] < 1.0
    return res["evals_per_second"]


# ---------------------------------------------------------------------------
# fISA: bench.py bench_fisa's network and two richer fixtures, built in
# memory (the data through `_data`, so that no h5py is needed)

CELLDESIGNER = "http://www.sbml.org/2001/ns/celldesigner"


def fisa_species(sid, name, cls, notes=""):
    """A CellDesigner species of class `cls` with its notes."""
    notes_xml = (f"<notes><body xmlns='http://www.w3.org/1999/xhtml'><p>{notes}</p></body>"
                 f"</notes>" if notes else "")
    return (f'<species id="{sid}" name="{name}" initialAmount="0">{notes_xml}'
            f"<annotation><celldesigner:extension xmlns:celldesigner='{CELLDESIGNER}'>"
            f"<celldesigner:speciesIdentity><celldesigner:class>{cls}</celldesigner:class>"
            f"</celldesigner:speciesIdentity></celldesigner:extension></annotation></species>")


def fisa_reaction(rid, reactant, product, positive=True):
    rtype = "POSITIVE_INFLUENCE" if positive else "NEGATIVE_INFLUENCE"
    return (f'<reaction id="{rid}"><annotation><celldesigner:extension '
            f"xmlns:celldesigner='{CELLDESIGNER}'><celldesigner:reactionType>{rtype}"
            f"</celldesigner:reactionType></celldesigner:extension></annotation>"
            f'<listOfReactants><speciesReference species="{reactant}"/></listOfReactants>'
            f'<listOfProducts><speciesReference species="{product}"/></listOfProducts>'
            f"</reaction>")


def fisa_sbml(species, reactions):
    return (f'<?xml version="1.0"?>\n<sbml xmlns="{SBML_NS}" level="2" version="4">'
            f'<model id="net"><listOfSpecies>{"".join(species)}</listOfSpecies>'
            f'<listOfReactions>{"".join(reactions)}</listOfReactions></model></sbml>\n')


# bench.py:525-573: A <-> B, mutually activating, under the logistic limit
FISA_BISTABLE_SBML = fisa_sbml(
    [fisa_species("s1", "A", "PROTEIN"), fisa_species("s2", "B", "PROTEIN")],
    [fisa_reaction("r1", "s1", "s2"), fisa_reaction("r2", "s2", "s1")])
# (name, logspace, value) of each fixture's variables; bench.py:575
FISA_VARIABLES = {
    "bistable": [("base_A", False, 0.15), ("base_B", False, 0.15),
                 ("strength_A_B", False, 0.8), ("strength_B_A", False, 0.8)],
    # a feedback network with the four drug effects (with and without a
    # dose-response), a complete-loss mutation, a drug transporter,
    # expression levels and mixing, conditions by data, variable and value,
    # and the four error models with NaN observations
    "network": [
        ("base_A", False, 0.2), ("base_C", False, 0.1),
        ("strength_A_B", False, 0.9), ("inflection_A_B", False, 0.4),
        ("steepness_A_B", False, 6.0), ("strength_B_A", False, 0.7),
        ("strength_B_C", False, 0.8), ("strength_A_proliferation", False, 0.9),
        ("strength_C_proliferation", False, 0.3), ("strength_LOSS_C", False, 0.5),
        ("maxinhib_drugX_A", False, 0.8), ("ic50_drugX_A", False, -0.5),
        ("logsteepness_drugX_A", False, 0.1), ("maxinhib_drugY_C", False, 0.6),
        ("drugZ_proliferation_susceptibility", False, 0.7), ("maxinhib_drugW_B", False, 0.3),
        ("expression_mixing[B]", False, 0.6), ("base_expression[A]", False, 0.1),
        ("scale_expression[A]", False, 0.8), ("base_expression[C]", False, 0.2),
        ("y_conc", False, 0.4), ("base_p", False, 0.05), ("scale_p", False, 0.9),
        ("sd_p", True, -1.0), ("sd_c", False, 0.08),
    ],
    # tests/test_fisa.py:266-300: EGFR -> ERK -> proliferation, ERK -| apoptosis
    "incucyte": [("base_EGFR", False, 0.6), ("base_apoptosis", False, 0.9),
                 ("strength_EGFR_ERK", False, 0.9), ("strength_ERK_proliferation", False, 0.8),
                 ("strength_ERK_apoptosis", False, 0.7), ("maxinhib_drugX_ERK", False, 0.6)],
}
FISA_JITTER = 0.01  # bench.py:580


def _fisa_network_files(workdir, feedback):
    import numpy as np

    species = [
        fisa_species("s1", "A", "PROTEIN"), fisa_species("s2", "B", "PROTEIN"),
        fisa_species("s3", "C", "PROTEIN"), fisa_species("s4", "proliferation", "PHENOTYPE"),
        fisa_species("s5", "drugX", "DRUG", "inhibit activity"),
        fisa_species("s6", "drugY", "DRUG", "inhibit activation"),
        fisa_species("s7", "drugZ", "DRUG", "alter susceptibility"),
        fisa_species("s8", "drugW", "DRUG", "activate"),
        fisa_species("s9", "LOSS", "GENE", "complete_loss"),
        fisa_species("s10", "PUMP", "PROTEIN", "drug_transporter"),
    ]
    reactions = [
        fisa_reaction("r1", "s1", "s2"), fisa_reaction("r3", "s2", "s3"),
        fisa_reaction("r4", "s1", "s4"), fisa_reaction("r5", "s3", "s4", positive=False),
        fisa_reaction("r6", "s5", "s1", positive=False),
        fisa_reaction("r7", "s6", "s3", positive=False), fisa_reaction("r8", "s7", "s4"),
        fisa_reaction("r9", "s8", "s2"), fisa_reaction("r10", "s9", "s3"),
        fisa_reaction("r11", "s10", "s1"),
    ]
    if feedback:
        reactions.append(fisa_reaction("r2", "s2", "s1"))
    with open(os.path.join(workdir, "net.xml"), "w") as f:
        f.write(fisa_sbml(species, reactions))
    P = 3
    data = {
        "cell_lines": np.array([b"c1", b"c2", b"c3"]),
        "x_conc": np.array([0.0, 0.3, 1.0]),
        "w_levels": np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.5]]),
        "loss": np.array([0.0, 0.0, 1.0]),
        "a_expr": np.array([0.9, 0.5, 0.7]),
        "c_expr": np.array([0.6, 0.8, 0.4]),
        "prolif": np.array([[0.35, 0.3, 0.4], [0.33, np.nan, 0.42]]),
        "a_data": np.array([[0.6, 0.5, 0.55]]),
        "c_data": np.array([[0.3, 0.25, 0.05]]),
        "b_data": np.array([[0.7, np.nan, 0.6]]),
    }
    assert all(len(np.atleast_2d(v)[-1]) == P for v in data.values())
    limit = "logistic" if feedback else "minmax"
    xml = (
        '<bcm_likelihood type="fISA">\n'
        f'<experiment name="exp1" model_file="net.xml" data_file="data.nc"'
        f' activation_limit="{limit}" multiroot_solves="6">\n'
        '  <condition species_name="drugX" data_name="x_conc"/>\n'
        '  <condition species_name="drugY" variable_name="y_conc"/>\n'
        '  <condition species_name="drugZ" value="0.3"/>\n'
        '  <condition species_name="drugW" data_name="w_levels[1]"/>\n'
        '  <mutation species_name="LOSS" data_name="loss"/>\n'
        '  <expression_level species_name="A" data_name="a_expr"/>\n'
        '  <expression_level species_name="C" data_name="c_expr"/>\n'
        '  <expression_level species_name="PUMP" value="0.7"/>\n'
        '  <data species_name="proliferation" data_name="prolif" likelihood_function="normal"'
        ' base_scale_sd_suffix="p"/>\n'
        '  <data species_name="A" data_name="a_data" likelihood_function="truncated_normal"'
        ' use_base="false" use_scale="false" scale_var_with_mean="false" sd="0.1"/>\n'
        '  <data species_name="C" data_name="c_data" likelihood_function="studentt"'
        ' data_is_inactive_form="true" expression="C" base="0.05" use_scale="false"'
        ' sd="sd_c" weight="0.5" scale_var_with_mean="false"/>\n'
        '  <data species_name="B" data_name="b_data" likelihood_function="truncated_t"'
        ' use_base="false" use_scale="false" scale_var_with_mean="false" sd="0.2"/>\n'
        "</experiment>\n</bcm_likelihood>\n")
    return xml, {"exp1": data}


def _fisa_incucyte_files(workdir, relative, nan_pair):
    """tests/test_fisa.py:266-390's incucyte-sequential setup: the analytic
    steady state of its chain gives the mixture table (mix.tsv)."""
    import numpy as np

    with open(os.path.join(workdir, "inet.xml"), "w") as f:
        f.write(fisa_sbml(
            [fisa_species("s1", "EGFR", "PROTEIN"), fisa_species("s2", "ERK", "PROTEIN"),
             fisa_species("s3", "proliferation", "PHENOTYPE"),
             fisa_species("s4", "apoptosis", "PHENOTYPE"),
             fisa_species("s5", "drugX", "DRUG", "inhibit activity")],
            [fisa_reaction("r1", "s1", "s2"), fisa_reaction("r2", "s2", "s3"),
             fisa_reaction("r3", "s2", "s4", positive=False),
             fisa_reaction("r4", "s5", "s2", positive=False)]))
    egfr = np.array([0.5, 0.9])
    concs = np.array([0.0, 0.4, 0.8])
    tv = np.array([v for _, _, v in FISA_VARIABLES["incucyte"]])

    def steady(e, c):
        b_eg, b_ap, s_ee, s_ep, s_ea, mi = tv
        erk = np.clip(s_ee * e, 0, 1)
        sig = 1.0 - c * mi
        return np.clip(s_ep * erk * sig, 0, 1), np.clip(b_ap - s_ea * erk * sig, 0, 1)

    rows = []
    for i in range(2):
        base_p = steady(egfr[i], 0.0)[0] if relative else 0.0
        for c in concs:
            p, a = steady(egfr[i], c)
            row = []
            for dp in (0.0, 0.05, 0.0):
                row += [p - base_p + dp, a - dp, 0.01, 0.002, 0.01]
            rows.append(row + [0.6, 0.4, 0.0])
    if nan_pair:
        rows[0][5] = np.nan  # the second component's mean of (c1, conc 0)
    with open(os.path.join(workdir, "mix.tsv"), "w") as f:
        f.write("\n".join("\t".join(str(x) for x in r) for r in rows) + "\n")
    group = {"cell_lines": np.array([b"c1", b"c2"]), "egfr_levels": egfr}
    data_node = ('<data data_file_base="mix.tsv" type="relative" relative_reference="baseline"/>'
                 if relative else '<data data_file_base="mix.tsv"/>')
    baseline = ('<experiment name="baseline" model_file="inet.xml" data_file="idata.nc">'
                '<condition species_name="EGFR" data_name="egfr_levels"/></experiment>'
                if relative else "")
    xml = ('<bcm_likelihood type="fISA">'
           f"{baseline}"
           '<experiment name="incu" type="incucyte_sequential" model_file="inet.xml"'
           ' data_file="idata.nc">'
           '<drug_range species_name="drugX" concentrations="0.0;0.4;0.8"/>'
           '<condition species_name="EGFR" data_name="egfr_levels"/>'
           f"{data_node}</experiment></bcm_likelihood>")
    return xml, ({"baseline": group, "incu": group} if relative else {"incu": group})


def fisa_files(workdir, config, feedback=True, relative=True, nan_pair=False,
               multiroot_solves=10):
    """Write a fISA configuration's SBML (and mixture table) and its
    likelihood.xml into workdir; return the likelihood.xml's path and its
    data groups, {experiment name: {dataset name: numpy array}} (what
    data.nc would hold). `config` is "bistable" (bench.py bench_fisa:
    multiroot_solves starts, the data at the low root), "network" (with
    or without its feedback loop) or "incucyte" (absolute or relative to
    a single-condition experiment, a NaN pair optional)."""
    import numpy as np

    os.makedirs(workdir, exist_ok=True)
    if config == "bistable":
        with open(os.path.join(workdir, "net.xml"), "w") as f:
            f.write(FISA_BISTABLE_SBML)
        xml = ('<bcm_likelihood type="fISA">\n'
               '<experiment name="exp1" model_file="net.xml" data_file="data.nc"'
               f' activation_limit="logistic" multiroot_solves="{multiroot_solves}">\n'
               '  <data species_name="A" data_name="a_data" likelihood_function="normal"'
               ' use_base="false" use_scale="false" scale_var_with_mean="false" sd="0.02"/>\n'
               "</experiment>\n</bcm_likelihood>\n")
        data = {"exp1": {"cell_lines": np.array([b"c1"]), "a_data": np.array([[0.057]])}}
    elif config == "network":
        xml, data = _fisa_network_files(workdir, feedback)
    else:
        xml, data = _fisa_incucyte_files(workdir, relative, nan_pair)
    path = os.path.join(workdir, "likelihood.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path, data


def fisa_varset(config):
    from bcm3_tpu_torch import VariableSet

    vs = VariableSet()
    for name, logspace, _ in FISA_VARIABLES[config]:
        vs.add_variable(name, logspace=logspace)
    return vs


def fisa_model(workdir, config, **options):
    """A fISA configuration through the registry (`create_likelihood` on its
    likelihood.xml, the data in memory) and its values."""
    import numpy as np

    from bcm3_tpu_torch.likelihoods import create_likelihood

    path, data = fisa_files(workdir, config, **options)
    lik = create_likelihood(path, fisa_varset(config), _data=data)
    return lik, np.array([v for _, _, v in FISA_VARIABLES[config]])


FISA_WIDTHS = (65536, 524288)  # bench.py:579 bench's batch, and eight times it
FISA_REPS = 3
FISA_CPU_ROWS = 256
FISA_CONVERGED = 1e-10  # a kept solve's Newton residual at its root (float64)
FISA_PT_SAMPLES = 20
FISA_PT_PROFILE_SAMPLES = 2
FISA_SAME_ROOT = 1e-2  # best-root activities this close pick the same root


def fisa_bridge_folder(workdir):
    """bench_fisa's network with a prior.xml (uniform within 25% of bench's
    values) in one folder, for `rbridge.init` and SamplerPT; the folder,
    its data groups (for `_data`) and bench's values."""
    import numpy as np

    folder = os.path.join(workdir, "fisa_bench")
    _, data = fisa_files(folder, "bistable")
    write_uniform_prior(os.path.join(folder, "prior.xml"),
                        [(n, False, 0.75 * v, 1.25 * v) for n, _, v in FISA_VARIABLES["bistable"]])
    return folder, data, np.array([v for _, _, v in FISA_VARIABLES["bistable"]])


def phase_fisa(workdir, smi):
    """bench_fisa's network (10 Sobol starts, float32) at FISA_WIDTHS rows
    (bench's jitter 0.01): evals/s over FISA_REPS evaluations after a warm
    one, device operations and busy time of one evaluation under the
    profiler, idle share, host reads of one evaluation (sync debug "warn"),
    peak memory."""
    import torch

    lik, values = fisa_model(os.path.join(workdir, "fisa"), "bistable")
    net = lik.model.experiments[0].network
    out = {}
    for B in FISA_WIDTHS:
        x = torch.as_tensor(bench_rows(values, B, jitter=FISA_JITTER), dtype=torch.float32,
                            device=CARD)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        wall_ms, lp = timed_evaluations(lik, x, FISA_REPS)
        peak = torch.cuda.max_memory_allocated() - held
        finite = int(torch.isfinite(lp).sum())
        _, reads = host_reads(lambda: lik.log_prob_batched(x))
        busy_ms, ops, prof_s = device_busy(lambda: lik.log_prob_batched(x))
        idle = 1.0 - busy_ms / wall_ms
        out[B] = dict(evals_per_second=B / wall_ms * 1e3, ms=wall_ms, ops=ops, reads=reads,
                      busy_ms=busy_ms, idle=idle, peak_gib=peak / 2**30)
        log(f"fisa: {B} rows x {net.multiroot_solves} Sobol starts ({B * net.multiroot_solves} "
            f"lanes), 20 Newton steps, float32: {wall_ms:.3f} ms an evaluation (host clock, "
            f"synchronized, mean of {FISA_REPS} after a warm one) = {out[B]['evals_per_second']:.1f} "
            f"evals/s; {finite}/{B} finite; {ops} device operations an evaluation, {reads} host "
            f"reads; device busy {busy_ms:.3f} ms (profiled, {prof_s:.1f} s), idle share "
            f"{idle:.4f}; peak memory {peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB "
            f"held before; on {smi}")
        assert finite == B and reads == 0
        del x, lp
    torch.cuda.empty_cache()
    return out


def _fisa_rows_card_vs_cpu(name, lik, xs, smi):
    """One fixture on the rows xs: the card's float64 against the CPU's
    within F64_RTOL on every row, equal -inf sets (the rows whose kept solve
    the 20 Newton steps left short of its root, a residual above
    FISA_CONVERGED on the CPU, counted: there one ulp moves the iterate);
    the card's float32 against the CPU's float64 on the rows where both and
    the CPU's float32 keep the same root per cell line, within ten times the
    CPU's own float32 error there; rows whose best root differs counted."""
    import numpy as np
    import torch

    rows = torch.as_tensor(xs)
    cpu = lik.log_prob_batched(rows).numpy()
    card = lik.log_prob_batched(rows.to(CARD)).cpu().numpy()
    fin = np.isfinite(cpu)
    assert np.array_equal(fin, np.isfinite(card)), f"{name}: -inf rows differ"
    loose = lik.model.newton_residual(rows).numpy() > FISA_CONVERGED
    rel = np.zeros_like(cpu)
    rel[fin] = np.abs(card[fin] - cpu[fin]) / np.abs(cpu[fin])
    strict, slack = rel[fin & ~loose].max(initial=0.0), rel[fin & loose].max(initial=0.0)
    log(f"fisa card vs CPU {name}, float64, {len(xs)} rows: {int(fin.sum())} finite; max rel "
        f"err {strict:.3e} on {int((fin & ~loose).sum())} converged rows, {slack:.3e} on "
        f"{int((fin & loose).sum())} whose kept solve stopped short of its root (limit "
        f"{F64_RTOL} on all); on {smi}")
    assert max(strict, slack) <= F64_RTOL

    def roots(x):
        tv = lik.model._transform(x)
        return torch.cat([exp.modeled_activities(tv).flatten(1) for exp in lik.model.experiments],
                         dim=1).double().cpu().numpy()

    cpu32 = lik.log_prob_batched(rows.float()).double().numpy()
    card32 = lik.log_prob_batched(rows.to(CARD, torch.float32)).double().cpu().numpy()
    r64, r32, rc32 = roots(rows), roots(rows.float()), roots(rows.to(CARD, torch.float32))
    same = ((np.abs(r32 - r64).max(axis=1) < FISA_SAME_ROOT)
            & (np.abs(rc32 - r64).max(axis=1) < FISA_SAME_ROOT) & fin)
    own = float((np.abs(cpu32[same] - cpu[same]) / np.abs(cpu[same])).max(initial=0.0))
    rel32 = float((np.abs(card32[same] - cpu[same]) / np.abs(cpu[same])).max(initial=0.0))
    log(f"fisa card vs CPU {name}: card float32 vs CPU float64 max rel err {rel32:.3e} on "
        f"{int(same.sum())} rows with the same best roots (limit {10 * own:.3e}, ten times the "
        f"CPU's own float32 error {own:.3e}); {int((fin & ~same).sum())} rows keep another root "
        f"in float32 (counted, not asserted)")
    assert same.sum() >= len(xs) // 2 and rel32 <= max(10 * own, 1e-6)
    return dict(rel64=float(strict), unconverged=int((fin & loose).sum()), rel32=rel32,
                own32=own, other_root=int((fin & ~same).sum()))


def phase_fisa_card_vs_cpu(workdir, smi):
    """The three fISA fixtures (bench_fisa's bistable network; the feedback
    network with every drug effect, conditions and expression levels; the
    incucyte-sequential experiment relative to a single-condition one) on
    FISA_CPU_ROWS rows of their values with jitter 0.01."""
    out = {}
    for config in ("bistable", "network", "incucyte"):
        lik, values = fisa_model(os.path.join(workdir, f"fisa_{config}"), config)
        xs = bench_rows(values, FISA_CPU_ROWS, seed=1, jitter=FISA_JITTER)
        out[config] = _fisa_rows_card_vs_cpu(config, lik, xs, smi)
    return out


def phase_fisa_pt(workdir, smi):
    """SamplerPT over the registry's fISA at bench_fisa's configuration
    (prior uniform within 25% of bench's values), 8 x 8,192 chains,
    FISA_PT_SAMPLES samples thinned by 5, float32: one run, its wall; the
    profile over FISA_PT_PROFILE_SAMPLES iterations of a second sampler."""
    from bcm3_tpu_torch import Prior, VariableSet
    from bcm3_tpu_torch.likelihoods import create_likelihood

    folder, data, _ = fisa_bridge_folder(workdir)
    prior_path = os.path.join(folder, "prior.xml")
    varset = VariableSet.from_xml(prior_path)
    lik = create_likelihood(os.path.join(folder, "likelihood.xml"), varset, _data=data)
    res = pt_slice("fisa_pt", Prior.from_xml(prior_path, varset), lik, ENSEMBLES["one"],
                   FISA_PT_SAMPLES, profile_samples=FISA_PT_PROFILE_SAMPLES, warm=False)
    log(f"fisa_pt: {res['wall_ms'] / 1e3:.4f} s an iteration = "
        f"{NUM_CHAINS * ENSEMBLES['one'] / res['wall_ms'] * 1e3:.1f} evals/s of the iterations; "
        f"on {smi}")
    return res["evals_per_second"]


def phase_rbridge(workdir, smi):
    """rbridge.init on the card (its default) against the same calls on a
    handle with device="cpu": the in-repo banana fixture (no data file) and
    bench_fisa's network through `_data`; the variable names, the
    log-likelihood and log-prior of 8 rows, and every fISA accessor, to
    float64 rounding (F64_RTOL)."""
    import numpy as np

    from bcm3_tpu_torch import rbridge

    folder, data, values = fisa_bridge_folder(workdir)
    rng = np.random.default_rng(3)
    cases = {"banana": (os.path.join(FIXTURES, "banana"), {},
                        rng.uniform([-4.0, -4.0], [4.0, 14.0], size=(8, 2))),
             "fisa": (folder, {"_data": data}, bench_rows(values, 8, seed=3,
                                                          jitter=FISA_JITTER))}
    worst = {}
    for name, (path, opts, rows) in cases.items():
        card, cpu = rbridge.init(path, **opts), rbridge.init(path, device="cpu", **opts)
        try:
            assert rbridge._get(card)["device"].type == "cuda"
            assert rbridge.get_variable_names(card) == rbridge.get_variable_names(cpu)
            pairs = []
            for v in rows:
                for fn in (rbridge.get_log_likelihood, rbridge.get_log_prior):
                    pairs.append((fn(card, v), fn(cpu, v)))
                if name == "fisa":
                    assert (rbridge.fISA_get_num_experiments(card)
                            == rbridge.fISA_get_num_data(card, 0)
                            == rbridge.fISA_get_num_cell_lines(card, 0) == 1)
                    assert rbridge.fISA_get_cell_line_names(card, 0) == ["c1"]
                    assert np.array_equal(rbridge.fISA_get_observed_data(card, 0, 0),
                                          rbridge.fISA_get_observed_data(cpu, 0, 0))
                    for fn, args in ((rbridge.fISA_get_modeled_activities, (0,)),
                                     (rbridge.fISA_get_modeled_data, (0, 0))):
                        pairs.append((fn(card, *args, v), fn(cpu, *args, v)))
            rel = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                   / np.maximum(np.abs(np.asarray(b)), 1e-300)))
                      for a, b in pairs)
            worst[name] = rel
            log(f"rbridge {name}: {len(pairs)} accessor results of {len(rows)} rows on the card "
                f"against a CPU handle: max rel err {rel:.3e} (limit {F64_RTOL}); on {smi}")
            assert rel <= F64_RTOL
        finally:
            rbridge.cleanup(card)
            rbridge.cleanup(cpu)
    return worst

def sharded_one_config(**override):
    """`pt_config` of `one` with SHARDED_ONE's adaptation."""
    return dataclasses.replace(pt_config(ENSEMBLES["one"], NUM_SAMPLES["one"]), **SHARDED_ONE,
                               **override)


def sharded_banana_sampler(**override):
    """SamplerPT over the banana fixture with SHARDED_BANANA, float32 on
    CARD, every temperature emitted."""
    import torch

    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    prior, lik = analytic_model("banana")
    cfg = PTConfig(**SHARDED_BANANA, **override, device=CARD, dtype=torch.float32)
    return SamplerPT(prior, lik, cfg)


SHARDED_KEYS = ("samples", "log_prior", "log_likelihood")


def same_sharded_run(name, got, ref):
    """A sharded run against the one-process run, bit for bit: samples,
    log densities and every acceptance counter."""
    import numpy as np

    for k in SHARDED_KEYS:
        assert np.array_equal(got[k], ref[k]), f"{name}: {k} differs from the one-process run"
    for k, v in ref["acceptance"].items():
        assert np.array_equal(got["acceptance"][k], v), f"{name}: acceptance {k} differs"
    log(f"{name}: the sharded run equals the one-process run bit for bit")


def phase_sharded_one(models, smi):
    """`one` at bench width, unsharded and then sharded in a one-rank NCCL
    group (the sharded path: the start search's all-reduce, the boundary's
    gathers and digest check, the gathered statistics), bit for bit; the
    entry points' step on the card and dryrun_multichip(1)."""
    import torch
    import torch.distributed as dist

    from bcm3_tpu_torch import entry
    from bcm3_tpu_torch.parallel import distributed, launch
    from bcm3_tpu_torch.sampler import SamplerPT

    prior, lik = models["one"]
    iterations = NUM_SAMPLES["one"] * USE_EVERY_NTH
    runs = {}
    plain = SamplerPT(prior, lik, sharded_one_config())
    runs["unsharded"] = plain.run()
    device = distributed.initialize(f"tcp://localhost:{launch.free_port()}", 1, 0, device=CARD)
    try:
        log(f"sharded_one: backend {dist.get_backend()}, world {distributed.world()}, "
            f"rank 0 on {device}")
        sharded = SamplerPT(prior, lik, sharded_one_config(shard_over_devices=True))
        assert sharded._block is not None and sharded._block.whole
        runs["sharded"] = sharded.run()
    finally:
        distributed.destroy()
    # the first run above was the process's first of this shape: a second
    # unsharded run gives a wall as warm as the sharded run's
    runs["unsharded, again"] = SamplerPT(prior, lik, sharded_one_config()).run()
    res = runs["sharded"]
    assert res["adaptation_boundaries"] == 1 and res["ensemble_shard"] == (0, ENSEMBLES["one"])
    same_sharded_run("sharded_one", res, runs["unsharded"])
    fields = ("means", "chols", "inv_chols", "log_weights", "log_c", "scales", "acc_ema",
              "selected")
    for a, b in zip(sharded.proposals, plain.proposals):
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for name, r in runs.items():
        br = r["adaptation_breakdown"][0]
        log(f"sharded_one {name}: {r['sampling_seconds'] * 1e3 / iterations:.4f} ms per "
            f"iteration (of the iterations alone), {r['evals_per_second']:.1f} evals/s; the "
            f"boundary {r['adaptation_seconds']:.3f} s, its history gather "
            f"{br['gather_seconds']:.4f} s")
    log("sharded_one: samples, log densities, acceptance counters and the proposals after "
        "the boundary equal the unsharded run's bit for bit")
    del plain, sharded
    torch.cuda.empty_cache()

    step, args = entry.entry(CARD)
    t = time.perf_counter()
    x, lprior, llh = step(*args)
    torch.cuda.synchronize()
    assert x.device.type == torch.device(CARD).type and x.shape == (6, 2)
    assert bool(torch.isfinite(lprior + llh).all())
    log(f"entry(): one PT iteration of the banana fixture's 6 chains on {x.device} in "
        f"{(time.perf_counter() - t) * 1e3:.3f} ms (first call)")
    t = time.perf_counter()
    dry = entry.dryrun_multichip(1, CARD)
    log(f"dryrun_multichip(1): one rank, samples {dry['samples'].shape}, "
        f"{dry['evaluations']} evaluations, {time.perf_counter() - t:.2f} s with the process")
    return runs["unsharded"]


def sharded_rank(rank, world, workdir, card, ensembles):
    """One rank of sharded_two_process: (a) `one` at bench width, then (b)
    the banana fixture; each run's outputs, its backend and device, and
    its B1 launches. `card` and `ensembles` are the parent's CARD and
    ENSEMBLES["one"] (a rank imports this script afresh)."""
    import torch.distributed as dist

    from bcm3_tpu_torch.ops import poppk_kernels
    from bcm3_tpu_torch.parallel import distributed
    from bcm3_tpu_torch.sampler import SamplerPT

    global CARD
    CARD = card
    ENSEMBLES["one"] = ensembles
    mine = os.path.join(workdir, f"rank{rank}")  # each rank writes its own prior file
    os.makedirs(mine, exist_ok=True)
    samplers = {
        "one": lambda: SamplerPT(*build_model("one", mine),
                                 sharded_one_config(shard_over_devices=True)),
        "banana": lambda: sharded_banana_sampler(shard_over_devices=True),
    }
    keep = SHARDED_KEYS + ("acceptance", "ensemble_shard", "num_ensembles", "sampling_seconds",
                           "evaluations", "adaptation_boundaries")
    out = {}
    for which, make in samplers.items():
        poppk_kernels.propagate_intervals_one_compartment.launches = 0
        res = make().run()
        out[which] = dict({k: res[k] for k in keep}, backend=dist.get_backend(),
                          device=str(distributed.rank_device(card)),
                          b1_launches=poppk_kernels.propagate_intervals_one_compartment.launches)
    return out


def phase_sharded_two_process(models, workdir, one_process, smi):
    """Two processes share the one card over gloo (launch.spawn): (a) `one`
    at bench width, 4,096 ensembles a rank (whole ladders), merged and
    held to the one-process run of sharded_one; (b) the banana fixture at
    6 x 3, whose second ladder straddles the ranks (the exchange crosses
    processes), held to the one-process card run."""
    import numpy as np
    import torch

    from bcm3_tpu_torch.io.output import merge_sharded_results
    from bcm3_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    t = time.perf_counter()
    both = launch.spawn(sharded_rank, 2, CARD, workdir, CARD, ENSEMBLES["one"], backend="gloo")
    log(f"sharded_two_process: {time.perf_counter() - t:.2f} s with the processes")
    b1 = 0
    for which in ("one", "banana"):
        ranks = [r[which] for r in both]
        for r, res in enumerate(ranks):
            log(f"sharded_two_process {which}: rank {r} of 2, backend {res['backend']}, device "
                f"{res['device']}, ensemble_shard {res['ensemble_shard']}, "
                f"{res['b1_launches']} B1 launches, sampling {res['sampling_seconds']:.3f} s")
        b1 += sum(res["b1_launches"] for res in ranks)
        if which == "one":
            got = merge_sharded_results([dict(r, temperatures=None) for r in ranks])
            got["acceptance"] = ranks[0]["acceptance"]
            ref = one_process
            half = ENSEMBLES["one"] // 2
            assert [r["ensemble_shard"] for r in ranks] == [(0, half), (half, half)]
        else:
            got = ranks[0]
            assert all(r["ensemble_shard"] is None for r in ranks)
            for k in SHARDED_KEYS:
                assert np.array_equal(ranks[1][k], got[k]), k
            ref = sharded_banana_sampler().run()
        assert all(r["adaptation_boundaries"] == 1 for r in ranks)
        same_sharded_run(f"sharded_two_process {which}", got, ref)
    return b1


def main(workdir):
    phase_times = {}

    def timed(name, fn, *args):
        """fn(*args), its seconds logged as soon as it ends (so a run cut
        by its time limit still shows where the time went)."""
        t = time.perf_counter()
        out = fn(*args)
        phase_times[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_times[name]:.3f} s")
        return out

    smi = timed("environment", phase_environment)
    import torch

    from bcm3_tpu_torch.ops import poppk_kernels, transit_kernels, transit_tangent_kernels

    timed("build", phase_build)
    models = {k: build_model(k, workdir) for k in ("one", "one_transit", "two_transit")}
    # the CPU's side of the transit gradients' check runs meanwhile
    transit_reference = start_transit_grad_cpu_reference(workdir)
    single = {k: pk_single_model(k, workdir) for k in ("one", "two", "one_transit")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    kernels = timed("kernels", phase_kernels, models, gen)
    timed("kernels_one_patient", phase_kernels_one_patient, single, gen)

    counters = {"poppk_propagate": poppk_kernels.propagate_intervals_one_compartment,
                "transit_dp5": transit_kernels.transit_solve,
                "poppk_propagate_adjoint": poppk_kernels.propagate_intervals_adjoint,
                "transit_dp5_tangent": transit_tangent_kernels.transit_jacobian}
    paths = {}

    def main_path(name, kernels, fn, *args):
        """A slice of the main path, the launch counts set to 0 just before
        it and read just after; it must have launched each of `kernels`."""
        for c in counters.values():
            c.launches = 0
        out = timed(name, fn, *args)
        paths[name] = {k: c.launches for k, c in counters.items()}
        for kernel in kernels:
            assert paths[name][kernel] > 0, f"{name} never launched {kernel}"
        return out

    slices = {k: main_path(f"slice_{k}", (kernel,), phase_slice, k, models)
              for k, kernel in (("one", "poppk_propagate"), ("one_transit", "transit_dp5"))}
    adapted = main_path("slice_one_adapted", ("poppk_propagate",), phase_adapted, models,
                        slices["one"], smi)
    clustered = main_path("slice_one_clustered", ("poppk_propagate",), phase_clustered, models,
                          slices["one"], smi)
    timed("assign_card_vs_cpu", phase_assign, clustered, smi)
    evals = dict({k: v["evals_per_second"] for k, v in slices.items()},
                 one_adapted=adapted["evals_per_second"],
                 one_clustered=clustered["res"]["evals_per_second"])
    del clustered
    torch.cuda.empty_cache()
    autoblock = main_path("slice_one_autoblock", ("poppk_propagate",), phase_autoblock, models,
                          smi)
    evals["one_autoblock"] = autoblock["evals_per_second"]
    del autoblock
    torch.cuda.empty_cache()
    main_path("cli_one", ("poppk_propagate", "transit_dp5"), phase_cli, models, workdir, smi)
    # the multi-device path: a one-rank NCCL group here, then two processes
    # sharing the card over gloo (their B1 launches are counted in the ranks
    # and added to the slice's)
    one_process = main_path("sharded_one", ("poppk_propagate",), phase_sharded_one, models, smi)
    two = main_path("sharded_two_process", (), phase_sharded_two_process, models, workdir,
                    one_process, smi)
    paths["sharded_two_process"]["poppk_propagate"] += two
    assert two > 0, "sharded_two_process never launched poppk_propagate"
    del one_process
    # the sampler's chunked emission and profile_dir, over B1
    main_path("pt_emission", ("poppk_propagate",), phase_pt_emission, models, workdir, smi)
    # the slices of this port's later paths, which no kernel serves
    # (counted all the same, to show it)
    analytic = {"banana": main_path("banana", (), phase_banana, smi),
                "multimodal_gaussians": main_path("multimodal_gaussians", (), phase_multimodal,
                                                  smi)}
    evals.update({k: v["evals_per_second"] for k, v in analytic.items()})
    evals.update(main_path("poppk_models", (), phase_poppk_models, workdir, smi))
    # the gradient and population samplers: NUTS, HMC and VI differentiate
    # through B1 and B1T, SMC scores its particles through B1
    both = ("poppk_propagate", "poppk_propagate_adjoint")
    samplers = {
        "nuts_one": main_path("nuts_one", both, phase_nuts_one, models, smi),
        "hmc_one": main_path("hmc_one", both, phase_hmc_one, models, smi),
        "smc_one": main_path("smc_one", ("poppk_propagate",), phase_smc_one, models, smi),
        "vi_one": main_path("vi_one", both, phase_vi_one, models, smi),
        # NUTS, HMC and VI on the transit models differentiate through B2J
        # (the gradient mode)
        "nuts_one_transit": main_path("nuts_one_transit", ("transit_dp5_tangent",),
                                      phase_nuts_one_transit, models, smi),
        "hmc_one_transit": main_path("hmc_one_transit", ("transit_dp5_tangent",),
                                     phase_hmc_one_transit, models, smi),
        "vi_two_transit": main_path("vi_two_transit", ("transit_dp5_tangent",),
                                    phase_vi_two_transit, models, smi),
    }
    torch.cuda.empty_cache()
    main_path("banana_gradient", (), phase_banana_gradient, smi)
    # the pharmacometric and generic likelihoods: pharmaco_population, ODE
    # and dll reach no kernel (none in the JAX package either); the
    # single-patient PK model runs `one` through B1 and `one_transit`
    # through B2
    evals["pharmaco_population"] = main_path("pharmaco_population", (), phase_pharmaco,
                                             workdir, smi)
    evals["pharmaco_pt"] = main_path("pharmaco_pt", (), phase_pharmaco_pt, workdir, smi)
    evals["pk_single_one"] = main_path("pk_single_one", ("poppk_propagate",),
                                       phase_pk_single_one, single, smi)
    main_path("pk_single_one_transit", ("transit_dp5",), phase_pk_single_one_transit, single,
              smi)
    evals["ode_template"] = main_path("ode_dll", (), phase_ode_dll, workdir, smi)
    main_path("dp5_fixed_trips", (), phase_dp5_fixed_trips, smi)
    # the cell likelihoods: no kernel serves them (none in the JAX package
    # either: XLA, and the matching on the host)
    incucyte = main_path("incucyte", (), phase_incucyte, workdir, smi)
    evals.update({f"incucyte_{B}": v for B, v in incucyte.items()})
    evals["incucyte_pt"] = main_path("incucyte_pt", (), phase_incucyte_pt, workdir, smi)
    evals["mitosis_time_estimation"] = main_path("mitosis", (), phase_mitosis, workdir, smi)
    evals["cell_cycle_marker"] = main_path("cell_cycle_marker", (), phase_cell_cycle_marker,
                                           smi)
    # the cell-population likelihood: no kernel serves it (XLA and the host
    # matching in the JAX package); the CPU's reference for its card-vs-CPU
    # check runs meanwhile in a process of its own
    reference = start_cellpop_cpu_reference(workdir)
    for config, phase in (("cellpop", phase_cellpop), ("cellpop21", phase_cellpop21),
                          ("cellpop_matched", phase_cellpop_matched)):
        evals[config] = main_path(config, (), phase, workdir, smi)["evals_per_second"]
    evals["cellpop_pt"] = main_path("cellpop_pt", (), phase_cellpop_pt, workdir, smi)
    # fISA and the R bridge: no kernel serves them (XLA and the host in the
    # JAX package), and none may launch
    fisa = main_path("fisa", (), phase_fisa, workdir, smi)
    evals.update({f"fisa_{B}": v["evals_per_second"] for B, v in fisa.items()})
    main_path("fisa_card_vs_cpu", (), phase_fisa_card_vs_cpu, workdir, smi)
    evals["fisa_pt"] = main_path("fisa_pt", (), phase_fisa_pt, workdir, smi)
    main_path("rbridge", (), phase_rbridge, workdir, smi)
    for name in ("fisa", "fisa_card_vs_cpu", "fisa_pt", "rbridge"):
        assert not any(paths[name].values()), f"{name} launched a kernel: {paths[name]}"
    launches = {k: sum(p[k] for p in paths.values()) for k in counters}
    log(f"main-path launches: {launches}; per slice {json.dumps(paths)}")

    timed("cellpop_card_vs_cpu", phase_cellpop_card_vs_cpu, workdir, smi, reference)
    timed("em_card_vs_cpu", phase_em, adapted, smi)
    for pk_type in ("one", "one_transit"):
        timed(f"card_vs_cpu_{pk_type}", phase_oracle, pk_type, workdir)
    b1t = timed("gradient_card_vs_cpu", phase_gradient_card_vs_cpu, models, smi,
                transit_reference)
    kernels["poppk_propagate_adjoint"] = b1t["pt"]
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phase_times.items()}))
    log("slice evals/s: " + json.dumps(evals) + f" on {smi}")
    log("samplers: " + json.dumps({
        "nuts_one": dict(ess_per_sec=samplers["nuts_one"]["ess"]["ess_per_sec"],
                         ess_per_sec_moving_chains=samplers["nuts_one"]["ess"][
                             "moving_ess_per_sec"],
                         stuck_chains=samplers["nuts_one"]["ess"]["stuck_chains"],
                         gradient_evaluations_per_sec=samplers["nuts_one"]["grad_per_s"]),
        # HMC's ESS is not usable (phase_hmc_one): both figures, labelled
        "hmc_one": dict(ess_usable=False,
                        ess_per_sec_all_chains=samplers["hmc_one"]["ess"]["ess_per_sec"],
                        ess_per_sec_moving_chains=samplers["hmc_one"]["ess"][
                            "moving_ess_per_sec"],
                        stuck_chains=samplers["hmc_one"]["ess"]["stuck_chains"],
                        leapfrog_steps_per_sec=samplers["hmc_one"]["steps_per_s"]),
        "smc_one": dict(evals_per_second=samplers["smc_one"]["evals_per_second"]),
        "nuts_one_transit": dict(
            ess_per_sec=samplers["nuts_one_transit"]["ess"]["ess_per_sec"],
            stuck_chains=samplers["nuts_one_transit"]["ess"]["stuck_chains"],
            gradient_evaluations_per_sec=samplers["nuts_one_transit"]["grad_per_s"],
            leaf_wall_ms=samplers["nuts_one_transit"]["leaf_wall_ms"]),
        "hmc_one_transit": dict(
            ess_usable=False, accept_rate=samplers["hmc_one_transit"]["res"]["accept_rate"],
            stuck_chains=samplers["hmc_one_transit"]["stuck_chains"],
            leapfrog_steps_per_sec=samplers["hmc_one_transit"]["steps_per_s"]),
        "vi_two_transit": dict(
            elbo=samplers["vi_two_transit"]["res"]["elbo"],
            adam_steps_per_sec=VI_TWO_TRANSIT["num_iterations"]
            / samplers["vi_two_transit"]["res"]["fit_seconds"],
            minus_inf_share=samplers["vi_two_transit"]["minus_inf_share"]),
        "b1t_device_ms": {k: v["ms"] for k, v in b1t.items()},
        "b1t_wrapper_host_us": {k: v["host_us"] for k, v in b1t.items()},
    }) + f" on {smi}")

    meta = {
        "poppk_propagate": ("bcm3_tpu_torch/csrc/poppk_propagate.cu",
                            "bcm3_tpu/ops/poppk_pallas.py:82"),
        "transit_dp5": ("bcm3_tpu_torch/csrc/transit_dp5.cu",
                        "bcm3_tpu/ops/transit_pallas.py:213"),
        "poppk_propagate_adjoint": (
            "bcm3_tpu_torch/csrc/poppk_propagate.cu",
            "the reverse mode of bcm3_tpu/ops/poppk_pallas.py:82, which the JAX package "
            "differentiates through lax.scan in bcm3_tpu/likelihoods/poppk.py:617"),
        "transit_dp5_tangent": (
            "bcm3_tpu_torch/csrc/transit_dp5_tangent.cu",
            "no Pallas kernel: the derivative of bcm3_tpu/ode/dp5.py:234 as "
            "bcm3_tpu/likelihoods/poppk.py:500-613 calls it, which the JAX package's "
            "gradient samplers take by XLA's reverse mode"),
    }
    log(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"],
            "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            # no single PyTorch call computes any of the four functions
            "library_ms": None,
        }
        for name in ("poppk_propagate", "transit_dp5", "poppk_propagate_adjoint",
                     "transit_dp5_tangent")
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--b1t-timing"]:
        sys.exit(b1t_timing(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--b2j-timing"]:
        sys.exit(b2j_timing(sys.argv[2] if len(sys.argv) > 2 else None))
    # the prior XML files of the run live in a directory removed at exit
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sys.exit(main(tmp))
