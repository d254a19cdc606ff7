#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

It drives thirteen paths: the main path through K1 (`csrc/pair_forces.cu`,
twod field, unscreened), the same path through K2
(`csrc/pair_forces_unrolled.cu`, backend "pallas_unrolled"), a crowd with
per-rider field parameters through K3 (`csrc/pair_forces_db.cu`, backend
"pallas_db"), bicycle2d's default legacy field through K1's
mixed-family form (tile screen, the NeighborConfig default), the twod
model (spline destination force) through K1's main form, a MixedEngine
of bicycle2d and twod riders through K1's two-family form, and the
inverted-pendulum model (the ZOH propagator as a piecewise quintic),
the balancing rider (the Whipple model, its gains as a piecewise
quintic), and the stochastic balancing rider in bench.py's two rows
(pole features resampled from the pole model, budget and cadence, and
without them) through K1's main form; the main path with 1% of its
riders scripted through K1's per-rider column form; and the Kaths
external model on the generic culled path, which has no pair kernel;
and the SUMO co-simulation of the packaged grid2x2 net through K1's
mixed form at receiver block 64, a calibration, a pole-model fit and the
field plots' evaluations; the main path's crowd split into four shards
held by one process (`parallel.sharding`), through the culled allgather,
ring and halo schedules and a mixed crowd's allgather, all through K1,
and once over a one-rank NCCL group; and the demos. The first four
paths run every step through the per-agent kernels agent_pre and
agent_post (`csrc/agent_step.cu`) around their pair kernel, slice_twod
through their twod instances (the spline force, the arrived-freeze), and
slice_balancingrider through agent_pre and agent_post_whipple. Phases, each
printing one JSON line (a failing phase raises and the script exits
non-zero):

  1. device    the card's name, and its name and power limit as nvidia-smi
               reports them (every time printed below was taken on it);
  2. build     compile the CUDA kernels from the checkout's sources;
  3. kernel    K1 in the main path's form against its plain PyTorch
               version on the card, at the main path's shape (100,000
               riders padded to 782 x 128, block_src = 64, kb = 19), with
               CUDA-event times;
  4. kernel_forms  every other form of K1, K2 and K3 against its plain
               version at the same shape and with CUDA-event times; then
               the mixed-family forms at the legacy path's shape (cutoff
               100 m, block_src 64, kb from the audit; K3 at block_src
               128), on the legacy crowd and on a two-family pack (every
               other rider a twod row with per-rider columns). Four
               in-call yardsticks, each timed in turns (a, b, b, a): K1's
               main form against K2's `uniform` form on the same table,
               K1 in K3's form (tile screen, columns, block_src 128)
               against K3 on the same table, K1's mixed form with the
               tile screen (slice_legacy's) against K3's mixed form on the
               legacy crowd, and K1's mixed form unscreened against K2's
               mixed form on the same table; then K1 main, K2 `uniform`
               and K3 at receiver blocks of 64 and 256 (BLOCK_FORMS);
  4b. agent_step  the per-agent kernels (`csrc/agent_step.cu`:
               agent_pre, the destination force, navigation FSM and pair
               packs before the pair kernel, and agent_post, the clamp,
               bicycle2d's step and the bookkeeping after it, or on the
               balancing rider agent_post_whipple, the clamp, the Whipple
               step and the bookkeeping) against their
               plain versions on one step of the 100,000-rider crowd after
               a table rebuild, in cell-sorted order: twod and legacy
               packs, per-rider columns (the slice_db engine), the
               crowd with its navigation spread over the FSM (`fsm_crowd`),
               slice_twod's engine on its crowd with queues (`with_queues`)
               after TWOD_WARM steps (`twod_spline`: agent_pre's spline
               instance and agent_post's twod instance; its inactive rows'
               forces are the chain's NaN where their spline is degenerate,
               so finiteness is checked over the active rows there)
               and slice_balancingrider's crowd and engine (`whipple`),
               every output field bit for bit (the differing elements and
               their ulps named per field), with each kernel's and plain
               version's time (each call replayed as a CUDA graph) and
               bound;
  5. audit     no receiver block overflows the neighbor table at t = 0;
  6. slice     240 steps of Engine.simulate on the card, as a user calls it:
               each 20-step chunk one replay of a CUDA graph. 240 K1
               launches counted (12 replays x the 20 launches the capture
               recorded) beside the 20 of the capture's warm-up chunk that
               K1's wrapper counted, a finite state, no overflow at t =
               end, the time of the first run and of the capture in it; on
               the paths of FUSED_PATHS as many launches of agent_pre
               and of their post kernel as of the pair kernel, on every
               other path none; a device trace of 40 more graphed steps,
               which must show 40 runs of K1's kernel (and of agent_pre and
               the post kernel) and none of K2's or K3's (a trace for
               which Kineto's log reports lost records, or which shows
               fewer runs of the path's kernel than the replays launched
               and nothing else (TRACE_UNDERCOUNT), is void and taken
               again, TRACE_ATTEMPTS in all; any other disagreement
               fails); then the
               eager loop (`graph=False`) and the graphed one timed in
               turns, TIMED_ROUNDS runs of each: ms per step of both,
               their spreads and the ratio;
  7. slice_unrolled  the same 240 steps through K2: 240 K2 launches and
               no K1 launch;
  8. slice_db  240 steps of 100,000 riders with per-rider f_0 and sigma_0
               (+-5%) through K3 at block = block_src = 128, kb from the
               overflow audit plus a margin: 240 K3 launches;
  9. slice_legacy  240 steps of the 100,000 riders with bicycle2d's
               default field, Engine.create(BicycleParams.create(),
               MODELS["bicycle2d"], neighbors=NeighborConfig(cutoff=100,
               block=128, block_src=64, kb=<audited max + 2>,
               rebuild_every=20)): 240 K1 launches, none of K2 or K3;
  9b. slice_twod  240 steps of the 100,000 riders as twod riders
               (`bench.py:main_row("twod")`: the spline destination force,
               position ring of 128, the main path's NeighborConfig):
               240 K1 launches and as many of agent_pre and agent_post
               (their twod instances), sorted-resident;
  9c. slice_mixed  240 steps of a MixedEngine of the 100,000 riders,
               bicycle2d (legacy field) on the first 50,000 rows and twod
               on the rest, NeighborConfig(cutoff=100, block=128,
               block_src=64, kb=<audited max + 2>, rebuild_every=20): 240
               K1 launches in the mixed form, rows in original order;
  9d. slice_invpendulum  240 steps of the 100,000 riders as invpendulum
               riders (`bench.py:main_row("invpendulum")`:
               InvPendulumBicycleParams.create(zoh_poly=32), the spline
               destination force, position ring of 128, `prepare`, the main
               path's NeighborConfig): 240 K1 launches, sorted-resident;
  9e. slice_balancingrider  240 steps of the 100,000 riders as balancing
               riders (`bench.py:main_heavy`:
               BalancingRiderParams.create(gains_poly=16), `prepare`,
               position ring of 8, the main path's NeighborConfig): 240 K1
               launches and as many of agent_pre and agent_post_whipple,
               sorted-resident, the share of fallen riders
               (|roll| > FALLEN_ROLL) reported;
  9f. slice_stochastic, slice_stochastic_exact  240 steps of the 100,000
               riders as stochastic balancing riders
               (`bench.py:main_row("stochastic")` and
               `("stochastic_exact")`, `scenarios.stochastic_row`: gains_poly
               Ackermann basis, a resampling budget of 4,096 every 4 steps,
               and every needy rider at once), each as slice_balancingrider,
               with the resamples per step and the riders still needy after
               each over RESAMPLE_STATS_STEPS eager steps reported;
  9g. slice_scripted  the main path's crowd and NeighborConfig with every
               SCRIPTED_EVERY-th rider (1,000) replaying a straight
               SCRIPT_STEPS-step track (`engine.ScriptedTraj`, uid-indexed,
               [100,096, 120, 8] float32) and emitting SCRIPTED_FIELD
               through per-rider f_0 and sigma_1 columns: 240 K1 launches
               in the column form (`uniform=None`), sorted-resident; every
               scripted rider exactly at its last point after the run
               (hold) and on its track after PARITY_STEPS steps (replay);
  9h. slice_kaths  100,000 Kaths riders (`external.py`, BicycleParams
               with the Kaths parameter dicts) uniform at DENSITY on the
               generic culled path (`backend="xla"`: cutoff, blocks and
               rebuild of the main path, kb from the overflow audit): no
               pair kernel launched (none counted, none in the trace), the
               generic path's calls per step and the peak memory of a
               step reported;
  9i. sumo     the packaged grid2x2 net (4 junctions) through
               FakeTraCI under the full demand of grid2x2.rou.xml (44
               riders, SUMO_NET), SumoCoSimulation(bicycle_type="bicycle",
               capacity=SUMO_CAPACITY, neighbors=SUMO_NEIGHBORS:
               K1's mixed form, tile screen, receiver block 64) stepped
               until FakeTraCI expects no vehicle (SUMO_MAX_STEPS at
               most, the cut printed; on the card each junction's step
               is a replay of its captured step after an eager table
               build): K1 launched once per (junction, step) that held a
               rider (replays) and once per junction by the capture's
               warm-up, no K2 or K3 (every count set to 0 just before), every rider handed over at both
               junctions of its route and back and finished, states and
               pushes finite; ms per step with the handover, the engine
               steps, the pushes and FakeTraCI apart; then K1's form
               there against its plain version on the fullest junction's
               packs (`kernel_forms`' k1_mixed_screen_sumo; the same form
               on the 100,000-rider legacy crowd is
               k1_mixed_screen_block64);
  9j. calibration  CAL_TRACKS synthetic bicycle2d tracks of CAL_STEPS
               steps made on the card, `Calibration.run` from CAL_GUESS
               recovering k_p_v within CAL_TOL (one objective a CUDA-graph
               replay, its seconds printed), `evaluate_population` of
               CAL_TRACKS candidates over every track (one replay of
               65,536 riders) equal to the per-candidate objective;
  9k. gmm_fit  `fit_pole_model` at the packaged BR1 fit's size (GMM_*:
               161 fits of 100 EM restarts), its seconds;
  9l. sharded  the main path's crowd padded to 100,352 rows (whole blocks
               on each of SHARDS shards), its rows ordered by x so that
               each shard is a strip of the domain (`strips`), split over
               SHARDS shards on cuda:0 (`parallel.make_mesh`), the main
               path's NeighborConfig with kb from the shards' own tables'
               audit: K1 against its plain version on the inputs each
               schedule hands it (`kernel_forms`' k1_sharded_allgather,
               k1_sharded_ring_hop: the hop table with the most holes,
               compacted, and k1_sharded_halo: a compacted halo-window
               table, `sharded_forms`), then the culled allgather, ring
               and halo schedules (the
               halo required_halo + 1 source block, audited at t = 0 and
               t = end), each N_STEPS steps with every count set to 0
               just before: K1 exactly SHARDS launches a step (the ring
               SHARDS x SHARDS), no K2 or K3, no table or halo overflow,
               ms per step and the collectives' share; each first held
               after PARITY_STEPS steps to the single-device graphed run
               under `parity`'s two tiers, its max |difference| and
               whether it is bit-equal reported. Then the mixed
               two-family crowd at the parity_mixed size, float64, every
               pair in range (SHARDED_MIXED_CUTOFF), through allgather
               under the same gates;
  9m. sharded_group  the allgather run over a one-rank NCCL process group
               made in this process (a HashStore) and holding all the
               shards: bit-equal to the run without a group; the group
               destroyed after;
  9n. demos    the demos that need no plotting library (DEMOS), side by
               side, each `python -m cyclistsocialforce_tpu_torch.demos.
               <name> ... --device cuda` at tests/test_demos.py's sizes:
               each exits 0 and prints its line; those left out, with
               the reason, in DEMOS_LEFT_OUT;
 10. parity    a 6,144-rider crowd run 45 steps (two table-rebuild
               chunks and the per-step tail) on the card in float32 and on
               the CPU in float64 through the plain version, same initial
               state, compared on the final state;
 11. parity_db the K3 path against the K1 path (tile screen, block_src =
               128) on the card, 45 steps of the slice_db crowd; and the
               K3 path on the card in float32 against the CPU float64
               plain version on a 2,048-rider crowd;
 12. parity_legacy  the slice_legacy configuration on a 4,096-rider crowd,
               45 steps on the card in float32 against the plain version
               on the CPU in float32 (the two tiers of `parity`) and in
               float64 (every rider within the cap; the 99.9% tier is
               reported beside the CPU float32 run's own distance from
               float64, which fails it alike: see PARITY_LEG_N);
 12b. parity_twod, parity_mixed  the twod path on 4,096 riders and the
               mixed path on 2 x 2,048, with TWOD_QUEUE destinations per
               rider (both spline branches run), 45 steps: the card in
               float64 against the CPU in float64 under both tiers, the
               card's float32 run reported (see TWOD_FLOAT32);
 12c. parity_invpendulum  the slice_invpendulum path on PARITY_IP_N riders
               with TWOD_QUEUE destinations, 45 steps, with the poly
               propagator and with the exact one: the card in float64
               against the CPU in float64 with the pair stage in float32
               (the card's arithmetic) under both tiers and against the
               CPU's plain float64 run under the cap (IP_STEER), the
               float32 run reported; then the poly's evaluation at
               100,000 speeds with TF32 allowed, bit-equal to TF32 off,
               and a float64 evaluation of the fit within float32's
               rounding bound on each rider's own segment;
 12d. parity_balancingrider  the slice_balancingrider configuration on a
               PARITY_BR_N-rider Whipple-stable crowd, 45 steps, with the
               exact placement, with gains_poly and with the Hess model:
               as parity_invpendulum (the card in float64 against the CPU
               float64 run with float32 pairs under both tiers, against
               plain float64 under the cap, the float32 run reported);
               then a gains_poly step of the 100,000 riders with TF32
               allowed, bit-equal to TF32 off;
 12e. parity_stochastic  the stochastic balancing rider with budget,
               cadence and torque disturbances (STOCH_PARITY) on
               PARITY_STOCH_N stable riders, as parity_balancingrider (the
               port draws JAX's streams, so the card's and the CPU's runs
               resample the same riders); then the pole-feature and
               disturbance draws of 100,000 riders and of their rows
               shuffled, per uid bit for bit;
 12f. parity_scripted, parity_kaths  the slice_scripted and slice_kaths
               configurations on PARITY_N riders, 45 steps: the card in
               float32 against the CPU (scripted: against the CPU's
               float32 run under both tiers and float64 as SCRIPTED_F32
               says, every scripted rider exactly on its track; Kaths:
               against float64 under both tiers, finite);
 13. graph_parity  on each of the ten paths 45 steps (two chunks and a
               5-step tail) with `graph=False` and with the graph from the
               same 100,000-rider state: every field of the final state
               bit-equal, again with `record_metrics=True`, and with
               `record=True` on 4,096-rider crowds of `slice`,
               `slice_twod`, `slice_mixed`, `slice_invpendulum`,
               `slice_balancingrider` and of invpendulum with the exact
               propagator, planarpoint and planarbicycle
               (`graph_parity_models`), and on 4,096-rider stable crowds
               of the balancing rider in each gain mode of BR_MODES and
               of the Hess model, of the stochastic cases of
               STOCH_MODES, of the main path with a road
               (`road_elements`) and of slice_scripted and slice_kaths;
               one eager chunk of each of those twenty-three with every
               host synchronisation an error (at full width where it is a
               path);
 13b. scenario  a `Scenario` of the main path on the card, N_STEPS steps
               in chunks of SCENARIO_CHUNK (one simulate call each), and
               the same run checkpointed at SCENARIO_SPLIT and restored
               into a fresh engine's scenario: bit-equal final states;
 13c. diagnostics  `checked_simulate` of the main path at full width: a
               clean run reports nothing, a NaN injected at step DIAG_AT
               is reported at that step;
 13d. viz_fields  `density_map` of the N_AGENTS crowd on the card equal
               to numpy.histogram2d cell for cell, and `eval_force_field`
               of a FIELD_N-rider crowd over FIELD_GRID^2 points (held to
               the CPU's at the end), matplotlib never imported;
 13e. sumo_parity, calibration_parity, gmm_fit_parity,
               viz_fields_parity  each against its CPU run (float64; the
               sumo run with float32 pairs): the same riders enter and
               leave each junction within one step and the pushed
               positions within `parity`'s two tiers; CAL_CPU tracks'
               replay and an objective within 1e-10 relative; the same
               selected hyperparameters and the best means within 1e-8;
               the field within FIELD_RTOL of its largest value;
 14. metrics   `simulate(state, 240, record=False, record_metrics=True)` on
               the main path: [240, 8], finite, 100,000 active and no
               overflow in every row, speeds within the model's limits;
 15. aliasing  two `simulate` calls on one engine from two states: the
               first call's state and records are unchanged by the second;
 16. profile   one torch.profiler window of 40 graphed steps of the main
               path, `slice_twod`, `slice_mixed`, `slice_invpendulum`,
               `slice_balancingrider`, the two stochastic paths,
               `slice_scripted` and `slice_kaths`:
               device kernels and host launches per step, device-busy ms
               per step, the card's idle share, the kernels that take most
               of the time, and the device kernels per step that the twod
               step adds to the main path's, the invpendulum step to
               twod's, the balancing-rider step to the main path's and the
               stochastic steps to the balancing rider's.

They run in this order: 1-4, 4b, 5-9n (the timed phases), 16, then
13-15, 13b,
13c, 13d, 10-12f and 13e. The CPU reference runs of 10-12f and 13e
start after 16 in CPU_WORKERS worker processes of one thread each
(`CpuReferences`, the longest first) and are collected by their phases
at the end: no timed phase shares the host with them.

Then the wall seconds of each phase and of the script, a JSON line with
the kernels' launch counts (each from its own path, with every count set
to 0 just before it: the replayed launches, and the warm-up's beside
them; K1's on each of its paths under `paths`, its column form's on
slice_scripted under `columns`, K1's launches on `sumo` under `paths`
and its sumo form under `mixed_block64`; K1's launches on each
sharded schedule under `paths` too), the block-64 and block-256
forms under `blocks`,
errors, times, bounds (with the floor that sets each: FP32, MUFU or
bytes) and the four yardstick ratios (`vs_k1`: K1's time over the
kernel's, same work, same call), agent_pre, agent_post and
agent_post_whipple with their launches on the fused paths, errors, times,
bounds and shares of them (agent_pre's and agent_post's twod instances
under `twod_spline`), the nvidia-smi
line, and last
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before printing any result.
"""

import contextlib
import functools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

N_AGENTS, DENSITY, HIST_LEN = 100_000, 0.02, 8
BLOCK, BLOCK_SRC, KB, CUTOFF, REBUILD = 128, 64, 19, 50.0, 20
N_STEPS = 240
# graph_parity: two chunks and a 5-step tail; the recorded run's crowd
GRAPH_PARITY_STEPS, GRAPH_PARITY_RECORD_N = 45, 4096
# the profiled window: two chunks
PROFILE_STEPS = 40
# each slice phase times the eager and the graphed loop in turns, this
# many runs of each (3 before the twod and mixed paths came; the twod
# path's eager loop takes ~6 s per run)
TIMED_ROUNDS = 2
# the JAX package's float32 bar for its own pair kernel against its
# float64 oracle (tests/test_neighbors.py): |kernel - plain| <= A + R|plain|
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2e-4
# card float32 vs CPU float64 after PARITY_STEPS steps, per agent. The
# bulk differs by float32 rounding of ~300 m coordinates (ulp 3e-5 m); a
# rare agent whose float32 and float64 runs cross a discontinuity of the
# field (the hard FOV cone edge, the sign(sin phi) jump straight ahead of
# a source) at different steps drifts further (a CPU float32-vs-float64
# rehearsal of an 8,192-rider crowd: median 2.9e-5 m, 99.9th percentile
# 2.4e-4 m, one agent at 1.3e-3 m). So: at least PARITY_QUANTILE of the
# agents within PARITY_TOL of each quantity, and every agent within
# PARITY_CAP. The crowd is 6,144 riders (8,192 before the legacy path's
# parity run was added; cut to keep the script near 200 s on the card).
# Its own CPU float32-vs-float64 rehearsal: max 4.5e-3 m, 2 riders above
# 1e-3 m/s, inside both tiers (a 4,096-rider draw put one rider past the
# cap, 1.1e-2 m, and is not used).
PARITY_N, PARITY_STEPS = 6144, 45
PARITY_QUANTILE = 0.999
PARITY_TOL = {"pos": 1e-3, "psi": 1e-3, "v": 1e-3, "delta": 1e-3}
PARITY_CAP = {"pos": 1e-2, "psi": 5e-2, "v": 5e-2, "delta": 5e-2}
# K3 path: source blocks of 128 (K3 needs block_src == block), per-rider
# f_0 and sigma_0 jittered by +-JITTER (numpy, seeded), kb = the audited
# maximum of in-range blocks plus KB_MARGIN (tests/test_neighbors.py)
DB_BLOCK, JITTER, JITTER_SEED, KB_MARGIN = 128, 0.05, 7, 2
# the other receiver blocks the kernels are compiled for, each with the
# block_src of its K1 and K2 forms (K3 takes block_src = block)
BLOCK_FORMS = {64: 32, 256: 64}
# the K3 path's CPU float64 crowd: 2,048 riders (4,096 before the legacy
# path's parity run was added; halved to keep the script near 200 s on
# the card; the plain version in float32 against float64 on this crowd,
# CPU: max 1.06e-4 m, well inside both tiers)
PARITY_DB_N = 2048
# legacy path: bicycle2d's default field, whose slow forward decay wants a
# ~100 m cutoff (the JAX package's NeighborConfig docstring). Within 100 m
# many sources sit near a receiver's FOV cone edge, where a source's whole
# force (up to ~0.1 at 50 m ahead) switches on or off: float32 and float64
# runs of the same crowd cross those edges at different steps. On the
# CPU, the plain version in float32 against float64 on the parity_legacy
# crowd gives exactly the card's distances (max 2.96e-3 m, 5 riders of
# 4,096 above 1e-3 rad of steer): the 99.9% tier is beyond float32 here,
# so the card is held to the CPU float32 run under both tiers and to the
# float64 run under the cap.
LEG_CUTOFF, PARITY_LEG_N = 100.0, 4096
# the twod model's paths: the spline destination force looks back 1 s, so
# the position ring holds 1/t_s + 1 = 101 samples or more (bench.py's
# main_row("twod") takes 128). The twod parity crowd has TWOD_QUEUE
# destinations per rider, the first TWOD_SPACING m ahead and each next one
# as far again, with the queue pointer at uid % TWOD_QUEUE: riders on
# their last destination take the last-destination spline, the others the
# forward spline over 2 to 4 queue points
TWOD_HIST, TWOD_QUEUE, TWOD_SPACING, TWOD_QUEUE_SEED = 128, 4, 20.0, 11
PARITY_TWOD_N = 4096
# TWOD_FLOAT32: the spline force is ill-conditioned in float32 at the
# crowd's coordinates (~300 m, ulp 3e-5 m): it fits a spline through the
# positions one step apart (1-6 cm) and, for the first second, the 1 s
# lookback reads the start position too. On the CPU the plain version in
# float32 ends 0.09 m from float64 after 45 steps of 1,024 riders, 131
# of them beyond 1e-3 m, and so does the JAX package's own float32 run
# (scripts/twod_float32.py). So the twod and mixed paths are held to the
# CPU float64 run in float64 on the card (the pair kernel still in
# float32), and their float32 run's distance is reported
# the mixed path: bicycle2d (legacy field) on the first half of the rows,
# twod on the second, drawn as one crowd; the parity run's crowd is
# 2 x PARITY_MIXED_HALF riders
PARITY_MIXED_HALF = 2048
# the invpendulum path (`bench.py:main_row("invpendulum")`): the
# piecewise-quintic ZOH propagator of IP_ZOH_POLY speed segments; its
# parity crowd (PARITY_IP_N riders with TWOD_QUEUE destinations) runs once
# with it and once with the exact per-rider exponential
IP_ZOH_POLY, PARITY_IP_N = 32, 2048
# IP_STEER: the invpendulum steer loop turns K1's float32 pair forces
# into steer angles ~5e-3 rad from the float64 run's after 45 steps for a
# few riders: on the CPU, the plain version with only its pair stage in
# float32 (`float32_pairs`) leaves 4 of 2,048 riders of the parity crowd
# over 1e-3 rad (max 5.0e-3 rad; positions within 3.4e-4 m), for both
# propagators (`parity_invpendulum`'s `cpu_float32_pairs_vs_float64`), as
# the card's float64 run does. So the card is held to that CPU run under both tiers and to the
# plain float64 run under the cap, as `parity_legacy` is
# the balancing-rider path (`bench.py:main_heavy`): the piecewise-quintic
# gains of BR_GAINS_POLY speed segments, the position ring HIST_LEN long.
# The bench crowd's uniform random headings command yaw turns of up to pi,
# and riders so commanded fall (|roll| > FALLEN_ROLL rad: the reference's
# physics, reported, not gated); the parity and graph_parity crowds are
# Whipple-stable instead (`scenarios.build_flagship_crowd`: headings within
# 0.2 rad of their destination 100 m ahead, 4-6 m/s, at DENSITY), as
# fallen riders amplify every rounding difference. PARITY_BR_N riders run
# the exact placement, gains_poly and the Hess model against the CPU (see
# IP_STEER, which binds them alike); graph_parity runs every gain mode of
# BR_MODES and Hess on GRAPH_PARITY_RECORD_N of them
BR_GAINS_POLY, PARITY_BR_N, FALLEN_ROLL = 16, 2048, 1.0
BR_MODES = {"exact": {}, "gains_poly": {"gains_poly": BR_GAINS_POLY},
            "gains_lut": {"gains_lut": 4096},
            "prop_lut": {"prop_lut": 4096},
            "prop_poly": {"prop_poly": BR_GAINS_POLY},
            "fixed": {"gains": (-13.14, 1.10, -6.69, -0.11, -11.38)}}
# the stochastic balancing rider (`bench.py:main_row`'s "stochastic" and
# "stochastic_exact" rows, `scenarios.STOCHASTIC_ROWS`): its paths are the
# bench crowd after `prepare`, as slice_balancingrider's. STOCH_MODES:
# graph_parity's cases on GRAPH_PARITY_RECORD_N stable riders (the exact
# row; a budget that binds and a cadence under a tighter hysteresis, so
# that riders resample every few steps; the Ackermann basis as a table;
# torque disturbances on gains_poly, whose torques STOCH_DIST keeps the
# riders upright). parity_stochastic: PARITY_STOCH_N stable riders with
# budget, cadence and the disturbances (STOCH_PARITY), the card in float64
# against the CPU float64 run with float32 pairs under both tiers and
# against plain float64 under the cap (IP_STEER), as the other Whipple
# paths: the card draws JAX's streams, so the runs follow one another
STOCH_DIST = dict(p_dist_roll=0.02, p_dist_steer=0.02, T_dist_roll=20.0,
                  T_dist_steer=20.0)
STOCH_MODES = {
    "stochastic_exact": dict(stochastic_control_behavior=True,
                             gains_poly=BR_GAINS_POLY),
    "stochastic_budget_cadence": dict(
        stochastic_control_behavior=True, gains_poly=BR_GAINS_POLY,
        resample_budget=64, resample_every=4,
        controlparam_resampling_speedthresh=0.3),
    "stochastic_gains_lut": dict(stochastic_control_behavior=True,
                                 gains_lut=4096),
    "disturb": dict(gains_poly=BR_GAINS_POLY, **STOCH_DIST),
}
STOCH_PARITY = dict(stochastic_control_behavior=True,
                    gains_poly=BR_GAINS_POLY, resample_budget=64,
                    resample_every=4,
                    controlparam_resampling_speedthresh=0.3, **STOCH_DIST)
PARITY_STOCH_N = 2048
# steps of the eager step-by-step run that counts resamples per step
RESAMPLE_STATS_STEPS = 40
# the road case of graph_parity: a straight road through the middle of
# the crowd along x, ROAD_WIDTH m wide, its edges' vertices every ROAD_DS
# m, with the curve scenario's repulsion (tests/test_parity_curve.py)
ROAD_WIDTH, ROAD_DS, ROAD_F0, ROAD_SIGMA = 10.0, 0.5, 0.15, 2.0
# the CPU reference runs of the parity phases go to CPU_WORKERS worker
# processes of one torch thread each, started after the timed phases
# (slice*, profile) and collected by the parity phases at the end
CPU_WORKERS = 6
# POLY_HORNER: the poly's float32 evaluation on the card against a
# float64 evaluation of the same fit (numpy, `poly_float32_excess`), per
# rider and output within the float32 rounding bound of the rider's own
# segment s: eps32 (3 (deg + 1) sum_d |c_sd| + 4 max(x, 1) sum_d d |c_sd|)
# -- the Horner chain's rounding, 2 (deg + 1) eps sum |c_sd| for u in
# [0, 1], with the coefficients' own rounding, and the local coordinate
# u = x - s off by a few ulps of x (CUDA divides by a scalar through its
# reciprocal) times p'(u). A rider whose x lies within 16 ulps of a
# segment boundary may take either segment, and is held to the nearer of
# the two evaluations. The TF32 check itself is bit for bit
# the bound of a call: the largest of its operations over the H100's FP32
# peak and bytes over its memory rate (NVIDIA's data sheet, SXM part at
# 700 W), and its special-function (MUFU) operations over the MUFU rate:
# 16 results per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0: reciprocal square root,
# base-2 exponential) x 132 SMs x 1.98 GHz. FP32 operations per pair,
# counted from the plain version's function (ops/pair_forces.py
# tile_forces), operation by operation as it is written there: every
# FP32 add, subtract, multiply, negation, min/max and comparison counts
# one, the MUFU operations (rsqrt, sqrt, exp) none (per-receiver work
# excluded; the kernels' csrc/pair_math.cuh add_pairs fuses some of them
# into multiply-adds, which the bound does not credit). Base forms
# without the FOV cone and priority to the right; the cone adds 5,
# priority to the right 4, the mixed form's family test 1. MUFU operations per pair, the least the field needs: twod 5 (the
# rsqrts of rho2, m4 and |(u, v)|^2, one rsqrt for the exponent's
# sqrt(rho2 ec2) / sigma, the exponential), legacy 2 (rsqrt, exp).
# Of these, every walked pair needs the decision (OPS_DECIDE: dx, dy,
# rho2, its clamp, the unit vector, rho2 > 0; the rsqrt of rho2; and the
# cone, priority and family tests), and only a tracked pair the rest: a
# pair the decision drops adds exactly 0 (`tracked_pairs`).
PEAK_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
OPS_TWOD, OPS_LEGACY, OPS_FOV, OPS_P2R, OPS_FAMILY = 67, 35, 5, 4, 1
OPS_SFU_TWOD, OPS_SFU_LEGACY = 5, 2
OPS_DECIDE, OPS_SFU_DECIDE = 9, 1
# calls timed in turns (a, b, b, a) for the in-call yardsticks
YARDSTICK_REPS = 50
# slice_scripted: every SCRIPTED_EVERY-th rider of the main path's crowd
# (1,000 of the 100,000) replays a straight SCRIPT_STEPS-step track along
# its initial heading at its initial speed, then holds its last point; the
# scripted riders emit the crossing car's field of tests/test_scripted.py
# (SCRIPTED_FIELD) through per-rider f_0 and sigma_1 columns, which puts
# K1 on its column form (`uniform=None`). Its parity run scripts the
# PARITY_N crowd the same way
SCRIPTED_EVERY, SCRIPT_STEPS = 100, 120
SCRIPTED_FIELD = {"f_0": 12.0, "sigma_1": 8.0}
# SCRIPTED_F32: on the CPU, the plain version in float32 against float64
# on the parity_scripted crowd leaves one rider of 6,144 2.6e-2 m apart
# after 45 steps (past the cap; 4 beyond 1e-3 m, inside the 99.9% tier),
# the field discontinuities' story (see PARITY_N: a 4,096-rider draw of
# the unscripted crowd once did the same). So the card is held to the
# CPU float32 run under both tiers, and to float64 under every tier that
# the CPU's own float32 run meets
# the scenario phase: Scenario chunks of SCENARIO_CHUNK steps, one
# simulate call (one graph replay) each, a checkpoint at SCENARIO_SPLIT
SCENARIO_CHUNK, SCENARIO_SPLIT = 20, 120
# the diagnostics phase: checked_simulate over DIAG_STEPS steps of the
# main path at full width, a NaN injected into one rider at DIAG_AT
DIAG_STEPS, DIAG_AT = 30, 17
# the sumo path: the packaged grid2x2 net (4 junctions) under the full
# demand of its grid2x2.rou.xml (each flow's `number` riders departing
# evenly over [begin, end), on the flow's route, speed and start offset
# drawn as demos/demo_sumo.py draws them), bicycle2d riders with the
# legacy field, SUMO_CAPACITY slots a junction, the culled stage through
# K1's mixed form at receiver block 64 (SUMO_NEIGHBORS: one receiver
# block, a table over the whole junction, so culled equals dense). It
# runs until FakeTraCI expects no vehicle, at most SUMO_MAX_STEPS steps
# (the demand ends near step 18,500)
SUMO_NET, SUMO_CAPACITY, SUMO_MAX_STEPS, SUMO_SEED = "grid2x2", 64, 25_000, 0
SUMO_NEIGHBORS = dict(cutoff=100.0, block=64, block_src=32, kb=2)
# the calibration phase: CAL_TRACKS synthetic bicycle2d tracks of
# CAL_STEPS steps at k_p_v = CAL_TRUTH (demos/demo_calibration.py's
# inputs, made on the card in float64), split CAL_SPLIT; Nelder-Mead from
# CAL_GUESS (CAL_MAXITER iterations) recovers the truth within CAL_TOL;
# the candidate batch is CAL_TRACKS candidates over every track, held to
# the per-candidate objective on CAL_CHECK of them; CAL_CPU tracks are
# held to the CPU's replay
CAL_TRACKS, CAL_STEPS, CAL_TRUTH, CAL_SPLIT = 256, 1000, 10.0, 0.75
CAL_GUESS, CAL_MAXITER, CAL_TOL, CAL_CHECK, CAL_CPU = 4.0, 60, 1e-3, 8, 16
# the gmm_fit phase: `fit_pole_model` at the size of the packaged BR1
# fit (its YAML metadata: 154 samples of ImRe5GivenV features, 10 folds,
# 100 EM restarts), components 1-4 and the four covariance types; the
# samples drawn from the packaged BR1 model at GMM_SAMPLES speeds spread
# evenly over the reference's speed grid (1.5-5.5 m/s)
GMM_MODEL = "BR1_ImRe5GivenV_pole-model-params.yaml"
GMM_SAMPLES, GMM_FOLDS, GMM_INIT, GMM_SEED = 154, 10, 100, 0
# viz_fields: density_map of the N_AGENTS crowd (DENSITY_BINS cells a
# side) against numpy.histogram2d; eval_force_field of a FIELD_N-rider
# twod crowd over a FIELD_GRID x FIELD_GRID grid against the CPU
DENSITY_BINS, FIELD_N, FIELD_GRID, FIELD_RTOL = 512, 4096, 256, 1e-9
# the sharded phases (`parallel.sharding`, one process holding every
# shard on cuda:0): the main path's crowd padded with inactive riders to
# whole BLOCK-row blocks on each of SHARDS shards (100,352 rows) in
# strips of the domain (`strips`), the main path's NeighborConfig with kb
# from the shards' tables (`sharded_engine`), float32, N_STEPS steps of
# each culled schedule through K1: allgather and halo launch it once per
# shard and step, the ring once per shard, hop and step. The halo is
# required_halo + 1 source block (audited at t = 0 and t = end). The
# mixed two-family crowd runs the allgather schedule at the parity_mixed
# size in float64 (the pairs in float32: the spline force is
# ill-conditioned in float32, see TWOD_FLOAT32), and every schedule is
# held after PARITY_STEPS steps to the single-device `Engine.simulate` of
# the same crowd under `parity`'s two tiers
SHARDS = 4
SHARDED_COMMS = ("allgather", "ring", "halo")
# the allgather and ring schedules keep each rider on its shard, so the
# strips' edges blur as the riders cross them and the edge blocks' boxes
# grow: on the card, 5 receiver blocks had more than kb = 20 (the t = 0
# maximum of 18 plus KB_MARGIN) in range after N_STEPS steps
SHARDED_KB_MARGIN = 8
# the mixed crowd's sharded run: a cutoff beyond its 452 m square, as the
# JAX package's sharded mixed tests take (tests/test_sharding.py: 1e4).
# At the legacy field's 100 m the shards' other block partition admits
# other fringe pairs, whose force is not small (the CPU rehearsal at
# 1,024 riders: 2 riders past the 99.9% tier in psi after 21 steps)
SHARDED_MIXED_CUTOFF = 1e4
# the demos run on the card at tests/test_demos.py's sizes, side by side
# (demo_scale on K1: tests/test_demos.py's "xla" names the plain version,
# which the port runs on CPU tensors only); the two that draw need
# matplotlib, which the card's machine lacks
DEMOS = {
    "demo_standalone twod": (["--model", "twod", "--t-end", "1.0"],
                             "model=twod:"),
    "demo_standalone balancingrider": (
        ["--model", "balancingrider", "--t-end", "0.5"],
        "model=balancingrider:"),
    "demo_parcours": (["--t-end", "1.0"], "waypoints reached"),
    "demo_curve": (["--t-end", "1.0"], "final pos"),
    "demo_sumo": (["--bikes", "2", "--steps", "800"],
                  "ran 800 steps; all vehicles finished: True"),
    "demo_mixed_traffic": (["--riders", "256", "--cars", "3", "--steps",
                            "60"], "lateral shift near the car lane"),
    "demo_scale": (["--agents", "2048", "--steps", "20"],
                   "agent-steps/sec"),
    "demo_sharded": (["--agents", "2048", "--steps", "12", "--comm",
                      "allgather", "--skip-check"], "demo_sharded: ok"),
}
DEMOS_LEFT_OUT = {
    "demo_polemodel": "its figure is the demo: it needs matplotlib, "
                      "absent on the card's machine",
    "demo_calibration": "writes its test-track overlay with matplotlib, "
                        "absent on the card's machine",
}
DEMO_TIMEOUT = 300
SRC = "cyclistsocialforce_tpu_torch/csrc/"
TPU = "cyclistsocialforce_tpu/ops/pallas_forces.py:"
# the paths whose every step goes through agent_pre, the pair kernel and a
# post kernel (`Engine.agent_kernels`), by the post kernel's name; every
# other path launches none of them
FUSED_PATHS = {"slice": "agent_post", "slice_unrolled": "agent_post",
               "slice_db": "agent_post", "slice_legacy": "agent_post",
               "slice_twod": "agent_post",
               "slice_balancingrider": "agent_post_whipple"}
# what the per-agent kernels replace: the XLA program of a step, which
# fuses this chain (no Pallas kernel computes it)
JAX_STEP = "cyclistsocialforce_tpu/"
AGENT_REPLACES = {
    "agent_pre": JAX_STEP + "engine.py:49-102 (nav_params_view, "
                 "dest_force_straight), dest_force_spline and ops/spline.py "
                 "(the spline instance) and :901-980 (pack_pair_fields), "
                 "fused by XLA",
    "agent_post": JAX_STEP + "ops/forces.py:238 (clamp_add_dest), "
                  "models/bicycle2d.py:34-87 (step), models/bicycle_twod.py "
                  "(the twod instance) and engine.py:1153-1198 "
                  "(finish_step), fused by XLA",
    "agent_post_whipple": JAX_STEP + "ops/forces.py:238 (clamp_add_dest), "
                          "models/balancingrider.py (step, gains_poly), "
                          "ops/smallmat.py (solve_small) and "
                          "engine.py:1153-1198 (finish_step), fused by XLA"}
# agent_step: the FSM-spread crowd's queue length and draws (fsm_crowd)
FSM_QUEUE, FSM_SEED, FSM_INACTIVE = 4, 11, 0.02
# FP32 operations a row of each per-agent kernel does, counted from
# csrc/agent_step.cu (a math-library call as 20; agent_post_whipple:
# benchmark/roofline/step.py's 560 a balancing rider less the ~100 of the
# destination force and FSM; agent_pre's spline instance: its 1,250 a
# twod rider less agent_post's 300); the bytes bound them 10-25x over
OPS_AGENT = {"agent_pre": 160, "agent_post": 300, "agent_post_whipple": 460,
             "agent_pre_spline": 950}
# agent_step's twod case: steps of slice_twod's crowd with queues before
# the step compared, so the ring holds a past and the fits are real
TWOD_WARM = 120


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def neighbor_config(**kw):
    """The main path's NeighborConfig (K1, unscreened), with `kw` changed."""
    from cyclistsocialforce_tpu_torch import NeighborConfig

    cfg = dict(cutoff=CUTOFF, block=BLOCK, block_src=BLOCK_SRC, kb=KB,
               rebuild_every=REBUILD, screen=False)
    return NeighborConfig(**{**cfg, **kw})


def make_engine(params=None, road=None, scripted=None, **kw):
    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    return Engine.create(params or BicycleParams.create(),
                         MODELS["bicycle2d"], rep_force="twod",
                         neighbors=neighbor_config(**kw), road=road,
                         scripted=scripted)


def scripted_setup(state):
    """(params, ScriptedTraj, scripted uids) of the slice_scripted
    configuration on `state`'s crowd: every SCRIPTED_EVERY-th active rider
    on a straight SCRIPT_STEPS-step track from its initial state (row k
    the point k + 1 steps ahead), with per-rider f_0 and sigma_1
    (SCRIPTED_FIELD on the scripted riders, BicycleParams' defaults on
    the rest) in the state's dtype on its device."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.engine import ScriptedTraj
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    base = BicycleParams.create()
    s = state.s.double().cpu().numpy()
    uids = np.flatnonzero(state.active.cpu().numpy()
                          & (np.arange(state.n) % SCRIPTED_EVERY == 0))
    ahead = base.t_s * np.arange(1, SCRIPT_STEPS + 1)
    tracks = {}
    for a in uids.tolist():
        x, y, psi, v = s[a, :4]
        tracks[a] = np.stack([x + v * ahead * np.cos(psi),
                              y + v * ahead * np.sin(psi),
                              np.full(SCRIPT_STEPS, psi),
                              np.full(SCRIPT_STEPS, v)], axis=1)
    scripted = ScriptedTraj.create(state.n, tracks, dtype=state.s.dtype,
                                   device=state.device)
    cols = {}
    for f, value in SCRIPTED_FIELD.items():
        col = torch.full((state.n,), float(getattr(base, f)),
                         dtype=state.s.dtype, device=state.device)
        col[torch.as_tensor(uids, device=state.device)] = value
        cols[f] = col
    return base.replace(**cols), scripted, uids


def scripted_engine(state, **kw):
    """The main path's engine (K1, unscreened) with slice_scripted's
    scripts and per-rider field columns on `state`'s crowd; `kw` changes
    the NeighborConfig."""
    params, scripted, _ = scripted_setup(state)
    return make_engine(params, scripted=scripted, **kw)


def scripts_followed(engine, state, final, steps):
    """Every scripted rider of `final` (the run of `steps` steps from
    `state`) exactly at its script's row steps (replay) or, past the
    script's end, at its last row (hold)."""
    import torch

    sc = engine.scripted
    rows = sc.mask.nonzero()[:, 0]
    at = torch.clamp(torch.full_like(rows, steps), max=SCRIPT_STEPS - 1)
    want = sc.traj[rows, at, :4].to(final.s.dtype)
    got = final.s[rows, :4]
    mode = "replay" if steps < SCRIPT_STEPS else "hold"
    exact = bool(torch.equal(got, want))
    out = {"scripted_riders": int(rows.numel()), "steps": steps,
           "mode": mode, "exactly_on_script": exact,
           "max_abs_from_script": float((got - want).abs().max())}
    if not exact:
        raise AssertionError(f"scripted riders off their scripts after "
                             f"{steps} steps ({mode}): {out}")
    return out


def make_kaths_engine(params=None, **kw):
    """The Kaths external model (`external`, BicycleParams with the Kaths
    parameter dicts) on the generic culled path (backend "xla") with the
    main path's cutoff, blocks and rebuild interval, `kw` changed."""
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig, external
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    kaths = external.KATHS_VELOANISO_PARAMS
    cfg = dict(cutoff=CUTOFF, block=BLOCK, block_src=BLOCK_SRC, kb=KB,
               rebuild_every=REBUILD, backend="xla")
    return Engine.create(params or BicycleParams.create(
        rep_force=kaths, dest_force=kaths), external,
        neighbors=NeighborConfig(**{**cfg, **kw}))


def kaths_crowd(n, dtype, device, pad=BLOCK):
    """The bench crowd (`build_population`) as Kaths riders, each riding
    toward its one destination."""
    from cyclistsocialforce_tpu_torch import external
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    return build_population(n, DENSITY, HIST_LEN, pad, dtype, device,
                            model=external)


def kaths_report(engine, state):
    """slice_kaths's line: no pair kernel, the generic path's calls per
    step, and the peak device memory of its eager step over the state's
    own."""
    import torch

    cfg = engine.neighbors

    def report(final):
        cache = engine.neighbor_cache(state)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.step_with_forces(state, cache)
        torch.cuda.synchronize()
        blocks = state.n // cfg.block
        per_call = engine.generic_blocks_per_call()
        return {"pair_kernel": None,
                "note": "the generic culled path has no kernel in either "
                        "package: it launches no pair kernel",
                "generic_calls_per_step": -(-blocks // per_call),
                "blocks_per_call": per_call,
                "tile_pairs_per_step": blocks * cfg.kb * cfg.block_src
                * cfg.block,
                "step_peak_bytes_over_state": torch.cuda.max_memory_allocated()
                - base}

    return report


def make_legacy_engine(params=None, **kw):
    """bicycle2d with its default field (no rep_force: the model's
    "legacy") and the NeighborConfig defaults but for the legacy path's
    cutoff, blocks and rebuild interval, with `kw` changed."""
    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    cfg = dict(cutoff=LEG_CUTOFF, block=BLOCK, block_src=BLOCK_SRC,
               rebuild_every=REBUILD)
    return Engine.create(params or BicycleParams.create(),
                         MODELS["bicycle2d"],
                         neighbors=NeighborConfig(**{**cfg, **kw}))


def make_twod_engine(params=None, **kw):
    """The twod model (spline destination force, twod field) on the main
    path's NeighborConfig, `bench.py`'s main_row("twod") configuration,
    with `kw` changed."""
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    return make_model_engine("twod", params or BicycleParams.create(), **kw)


def make_mixed_engine(n, **kw):
    """A MixedEngine of n riders: bicycle2d (its legacy field) on rows
    [0, n/2), twod on the rest, both on BicycleParams.create(); the
    NeighborConfig defaults (the tile screen) but for the legacy path's
    cutoff, blocks and rebuild interval, with `kw` changed."""
    from cyclistsocialforce_tpu_torch import NeighborConfig
    from cyclistsocialforce_tpu_torch.mixed import MixedEngine
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    cfg = dict(cutoff=LEG_CUTOFF, block=BLOCK, block_src=BLOCK_SRC,
               rebuild_every=REBUILD)
    half = n // 2
    return MixedEngine.create(
        [("bicycle2d", BicycleParams.create(), half),
         ("twod", BicycleParams.create(), n - half)],
        neighbors=NeighborConfig(**{**cfg, **kw}))


@functools.lru_cache(maxsize=None)
def ip_params(exact=False):
    """`bench.py:main_row("invpendulum")`'s parameters: the reference's
    InvPendulumBicycle with the piecewise-quintic ZOH propagator of
    IP_ZOH_POLY segments (exact=True: the exact per-rider exponential)."""
    from cyclistsocialforce_tpu_torch.params import InvPendulumBicycleParams

    return InvPendulumBicycleParams.create(
        zoh_poly=0 if exact else IP_ZOH_POLY)


def graph_parity_models():
    """name -> (model, params) of the models that graph_parity runs on a
    GRAPH_PARITY_RECORD_N-rider crowd of their own (beside the paths):
    invpendulum with the exact propagator, planarpoint, planarbicycle."""
    from cyclistsocialforce_tpu_torch.params import (PlanarBicycleParams,
                                                     PlanarPointBicycleParams)

    return {"invpendulum_exact": ("invpendulum", ip_params(exact=True)),
            "planarpoint": ("planarpoint", PlanarPointBicycleParams.create()),
            "planarbicycle": ("planarbicycle",
                              PlanarBicycleParams.create())}


@functools.lru_cache(maxsize=None)
def br_params(mode="gains_poly", device="cuda"):
    """BalancingRiderParams in gain mode `mode` (BR_MODES; "gains_poly" is
    `bench.py:main_heavy`'s), or HessBikeRiderParams for "hess", with
    their tables on `device` (a capture copies nothing from the host)."""
    from cyclistsocialforce_tpu_torch.params import (BalancingRiderParams,
                                                     HessBikeRiderParams)

    if mode == "hess":
        return HessBikeRiderParams.create()
    p = BalancingRiderParams.create(**{**BR_MODES, **STOCH_MODES,
                                       "parity_stochastic": STOCH_PARITY}[
                                           mode])
    return p.replace(**{f: (getattr(p, f)[0].to(device),)
                        + getattr(p, f)[1:] for f in p.POPULATION_SHARED
                        if getattr(p, f) is not None})


def br_model(mode):
    return "hessbikerider" if mode == "hess" else "balancingrider"


def stable_crowd(mode, n, dtype, device, pad=BLOCK):
    """A Whipple-stable crowd of n riders at DENSITY
    (`scenarios.build_flagship_crowd`, position ring HIST_LEN) after the
    `prepare` of mode `mode`'s model and parameters (`br_params`)."""
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.scenarios import build_flagship_crowd

    model = br_model(mode)
    st = build_flagship_crowd(n, DENSITY, HIST_LEN, pad, dtype, device,
                              model=model)
    return prepare(MODELS[model], br_params(mode, device), st)


def stochastic_path(row):
    """`bench.py:main_row(row)`'s engine and 100,000-rider state on the
    card (`scenarios.stochastic_row`), the parameters' table-free fits
    kept as they are."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import stochastic_row

    return stochastic_row(row, N_AGENTS, DENSITY, torch.float32, "cuda")


def resample_stats(engine, state):
    """Resampling of the stochastic balancing rider per step, over
    RESAMPLE_STATS_STEPS eager steps from `state` (one table per step):
    the riders whose speed of last resampling changed (resampled), and
    those still needy after the step (|v - v_last| above the threshold:
    deferred by the budget or the cadence, or needy since the step)."""
    import torch

    from cyclistsocialforce_tpu_torch.models import balancingrider as BR
    from cyclistsocialforce_tpu_torch.state import V

    thresh = engine.params.controlparam_resampling_speedthresh
    done, needy = [], []
    st = state
    for _ in range(RESAMPLE_STATS_STEPS):
        new = engine.step(st)
        vl = new.dyn_gains[:, BR._VLAST]
        done.append(int((vl != st.dyn_gains[:, BR._VLAST]).sum()))
        needy.append(int((((new.s[:, V] - vl).abs() > thresh)
                          & new.active).sum()))
        st = new
    torch.cuda.synchronize()
    return {"resample_steps": RESAMPLE_STATS_STEPS,
            "resampled_per_step_mean": statistics.mean(done),
            "resampled_per_step_max": max(done),
            "resampled_per_step": done,
            "budget": engine.params.br_resample_budget,
            "every": engine.params.br_resample_every,
            "needy_after_step_mean": statistics.mean(needy),
            "needy_after_step_max": max(needy)}


def road_elements(n, dtype, device):
    """The road of graph_parity's road case for a bench crowd of n riders
    (`build_population`: a square of half-side 0.5 sqrt(n / DENSITY)): a
    straight segment along x through the middle, end to end."""
    import math

    from cyclistsocialforce_tpu_torch.params import RoadElementParams
    from cyclistsocialforce_tpu_torch.road import (build_road_elements,
                                                   straight_segment)

    side = 0.5 * math.sqrt(n / DENSITY)
    seg = straight_segment((-side, 0.0, 0.0), ROAD_WIDTH, 2 * side,
                           ROAD_DS, RoadElementParams.create(
                               F_0=ROAD_F0, sigma=ROAD_SIGMA))
    return build_road_elements([seg], dtype, device)


def fallen_share(state):
    """The share of active riders whose roll exceeds FALLEN_ROLL rad."""
    from cyclistsocialforce_tpu_torch.state import THETA

    roll = state.s[state.active, THETA].abs()
    return {"fallen_share": float((roll > FALLEN_ROLL).double().mean()),
            "max_abs_roll": float(roll.max())}


def make_model_engine(model, params, **kw):
    """`model` (a `models.MODELS` name) on `params` and the main path's
    NeighborConfig, with `kw` changed."""
    from cyclistsocialforce_tpu_torch import Engine
    from cyclistsocialforce_tpu_torch.models import MODELS

    return Engine.create(params, MODELS[model],
                         neighbors=neighbor_config(**kw))


def model_crowd(model, params, n, dtype, device, pad=BLOCK,
                hist_len=TWOD_HIST):
    """The bench crowd sized for `model` (`build_population(model=...)`,
    the position ring `hist_len` long) after the model's `prepare` on
    `params`, padded to a multiple of `pad` (None: not padded)."""
    from cyclistsocialforce_tpu_torch.models import MODELS, prepare
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(n, DENSITY, hist_len, pad, dtype, device,
                          model=model)
    return prepare(MODELS[model], params, st)


def twod_crowd(n, dtype, device, pad=BLOCK):
    """The bench crowd sized for twod (`model_crowd`; twod keeps no
    latents), padded to a multiple of `pad` (None: not padded)."""
    return model_crowd("twod", None, n, dtype, device, pad)


def with_queues(state):
    """`state` with TWOD_QUEUE destinations per rider along a seeded
    random direction (the k-th (k + 1) TWOD_SPACING m away, +-TWOD_SPACING/4
    to the side, so each lies farther than the one before) and the queue
    pointer at uid % TWOD_QUEUE."""
    import numpy as np
    import torch

    n = state.n
    rng = np.random.default_rng(TWOD_QUEUE_SEED)
    heading = rng.uniform(-np.pi, np.pi, n)
    side = rng.uniform(-0.25, 0.25, (n, TWOD_QUEUE)) * TWOD_SPACING
    along = TWOD_SPACING * np.arange(1, TWOD_QUEUE + 1)[None, :]
    pos = state.s[:, :2].double().cpu().numpy()
    c, s_ = np.cos(heading)[:, None], np.sin(heading)[:, None]
    dq = np.zeros(tuple(state.destqueue.shape))
    dq[:, :TWOD_QUEUE, 0] = pos[:, :1] + along * c - side * s_
    dq[:, :TWOD_QUEUE, 1] = pos[:, 1:] + along * s_ + side * c
    ptr = state.uid.cpu().numpy().astype(np.int64) % TWOD_QUEUE
    like = state.destqueue
    return state.replace(
        destqueue=torch.as_tensor(dq, dtype=like.dtype, device=like.device),
        dest=torch.as_tensor(dq[np.arange(n), ptr], dtype=like.dtype,
                             device=like.device),
        destpointer=torch.as_tensor(ptr, dtype=state.destpointer.dtype,
                                    device=like.device),
        nq=torch.full_like(state.nq, TWOD_QUEUE))


def jittered_params(n, device, dtype):
    """Shared BicycleParams with per-rider f_0 and sigma_0 [n] on `device`
    (broadcast by `as_population`, scaled by a seeded numpy draw in
    1 +- JITTER): the field columns the K3 path reads. The other fields
    stay shared floats, so the state keeps its dtype."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.params import BicycleParams, as_population

    base = BicycleParams.create()
    pop = as_population(base, n, device=device)
    rng = np.random.default_rng(JITTER_SEED)

    def jitter():
        return torch.as_tensor(1 + JITTER * rng.uniform(-1, 1, n),
                               device=device)

    return base.replace(f_0=(pop.f_0 * jitter()).to(dtype),
                        sigma_0=(pop.sigma_0 * jitter()).to(dtype))


def audit_overflow(engine, state, tag):
    """Assert that no receiver block has more in-range source blocks than
    the table holds (overflow would silently drop the farthest blocks'
    forces); returns the largest in-range count."""
    cache = engine.neighbor_cache(state)
    counts = cache[2].sum(dim=1)
    n_over = int(cache[3].sum())
    kb = engine.neighbors.kb
    emit("audit", at=tag, max_in_range_blocks=int(counts.max()), kb=kb,
         block_src=engine.neighbors.block_src, overflow_blocks=n_over)
    if n_over:
        raise AssertionError(f"neighbor table overflow at {tag}: "
                             f"{n_over} receiver blocks exceed kb={kb}")
    return int(counts.max())


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, each timed with CUDA
    events, after one warm-up run."""
    import torch

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
    times.sort()
    return times[len(times) // 2]


def graphed_ms(fn, reps):
    """`cuda_ms` of one replay of a CUDA graph that holds one call of
    `fn`: the device's time for the call without the host's (a wrapper's
    Python and a kernel's launch, which for a kernel of some
    microseconds take longer than the kernel itself)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def sorted_inputs(engine, state):
    """(nbr, valid, src, recv): the engine's table and its cell-sorted
    packs, as the sorted-resident step hands them to the pair kernel."""
    from cyclistsocialforce_tpu_torch.engine import permute_state

    cache = engine.neighbor_cache(state)
    src, recv = engine.pack_pair_fields(permute_state(state, cache[0]))
    return cache[1], cache[2], src, recv


def work(tensors, plain_kw):
    """What one call of the form needs: the pairs it evaluates (the valid
    tiles' pairs, after the screen where one applies: those of the tiles or
    strips it admits), legacy rows' pairs apart in the mixed form, the
    operations and MUFU operations they take (OPS_*), and the bytes of
    every input read once and the output written once; with the bound
    these give. `bound_by` says whether operations (FP32 or MUFU, as
    `floor` names) or bytes set it."""
    import torch

    nbr, valid, src, recv = tensors
    block = plain_kw.get("block", BLOCK)
    block_src = plain_kw.get("block_src", block)
    strip = plain_kw.get("sub") or block_src
    rows, n_strips = src.shape[0] // block_src, block_src // strip
    idx = nbr.long()
    admit = valid[..., None].expand(*valid.shape, n_strips)   # [B, KB, ns]
    if plain_kw.get("screen"):
        xs = src[:, 0].reshape(rows, block_src)[idx]           # [B, KB, S]
        ys = src[:, 1].reshape(rows, block_src)[idx]
        xr = recv[0].reshape(nbr.shape[0], 1, 1, block)
        yr = recv[1].reshape(nbr.shape[0], 1, 1, block)
        dx, dy = xr - xs[..., None], yr - ys[..., None]
        rho2 = (dx * dx + dy * dy).reshape(*nbr.shape, n_strips, -1)
        cutoff = plain_kw["cutoff"]
        admit = admit & (rho2.amin(dim=-1) <= cutoff * cutoff)
    pieces = int(admit.sum())
    pairs = pieces * strip * block
    legacy_pairs = 0
    mixed = bool(plain_kw.get("mixed"))
    if mixed:
        fam = (src[:, 13] > 0.5).reshape(rows, block_src)[idx]
        per_strip = fam.reshape(*nbr.shape, n_strips, strip).sum(dim=-1)
        legacy_pairs = int((per_strip * admit).sum()) * block
    fov = plain_kw.get("fov", True)
    p2r = plain_kw.get("priority_p2r", False)
    extra = OPS_FOV * fov + OPS_P2R * p2r + OPS_FAMILY * mixed
    tracked, legacy_tracked = tracked_pairs(tensors, plain_kw)
    twod_tracked = tracked - legacy_tracked
    ops = (pairs * (OPS_DECIDE + extra)
           + twod_tracked * (OPS_TWOD - OPS_DECIDE)
           + legacy_tracked * (OPS_LEGACY - OPS_DECIDE))
    sfu_ops = (pairs * OPS_SFU_DECIDE
               + twod_tracked * (OPS_SFU_TWOD - OPS_SFU_DECIDE)
               + legacy_tracked * (OPS_SFU_LEGACY - OPS_SFU_DECIDE))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 2 * recv.shape[1] * 4
    floors = {"fp32": 1e3 * ops / PEAK_FLOPS,
              "sfu": 1e3 * sfu_ops / PEAK_SFU_PER_S,
              "bytes": 1e3 * nbytes / PEAK_BYTES_PER_S}
    floor = max(floors, key=floors.get)
    out = {"candidate_pairs": int(valid.sum()) * block_src * block,
           "pairs": pairs, "legacy_pairs": legacy_pairs,
           "tracked_pairs": tracked, "operations": ops,
           "sfu_operations": sfu_ops, "bytes": nbytes,
           "floors_ms": floors, "bound_ms": floors[floor],
           "bound_by": "bytes" if floor == "bytes" else "operations",
           "floor": floor}
    if plain_kw.get("screen"):
        out["screen_admits"] = pieces / float(valid.sum() * n_strips)
    return out


def tracked_pairs(tensors, plain_kw):
    """(all, legacy rows'): the walked pairs the field needs past the
    decision, those `pair_forces_neighbors_ref`'s form tracks: rho2 > 0,
    in the receiver's FOV cone where `fov`, to its right where
    `priority_p2r`, an active receiver, in a valid slot and a strip the
    screen admits; in float32 as the plain version decides them."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    nbr, valid, src, recv = tensors
    block = plain_kw.get("block", BLOCK)
    block_src = plain_kw.get("block_src", block)
    strip = (plain_kw.get("sub") or block_src) if plain_kw.get("screen") \
        else block_src
    uniform = plain_kw.get("uniform")
    cutoff2 = PF.cutoff_squared(plain_kw.get("cutoff", float("inf")))
    src_blocks = src.reshape(-1, block_src, PF.SRC_COLS)
    r_all = recv.reshape(PF.RECV_ROWS, nbr.shape[0], 1, 1, block)
    total = legacy = 0
    for lo in range(0, nbr.shape[0], 64):
        hi = min(lo + 64, nbr.shape[0])
        s = src_blocks[nbr[lo:hi].long()]                  # [C, KB, S, 16]
        r = r_all[:, lo:hi]
        dx, dy = r[0] - s[..., 0:1], r[1] - s[..., 1:2]
        rho2 = dx * dx + dy * dy                           # [C, KB, S, R]
        inv_rho = torch.rsqrt(torch.clamp(rho2, min=1e-30))
        dxn, dyn = dx * inv_rho, dy * inv_rho
        keep = (rho2 > 0) & (r[4] > 0) & valid[lo:hi, :, None, None]
        if plain_kw.get("fov", True):
            chf = (uniform[6] if uniform is not None
                   else s[..., 11:12])
            keep &= (dxn * r[2] + dyn * r[3]) <= -chf
        if plain_kw.get("priority_p2r"):
            keep &= (dyn * r[2] - dxn * r[3]) >= 0
        if plain_kw.get("screen"):
            strips = rho2.reshape(*rho2.shape[:2], block_src // strip, -1)
            admit = strips.amin(dim=-1) <= cutoff2
            keep &= admit.repeat_interleave(strip, dim=-1)[..., None]
        total += int(keep.sum())
        if plain_kw.get("mixed"):
            legacy += int((keep & (s[..., 13:14] > 0.5)).sum())
    return total, legacy


def check_form(phase, form, fn, tensors, kw, plain_kw):
    """Kernel `fn` against its plain version on `tensors` (forms of the
    plain version in `plain_kw`): assert |diff| <= KERNEL_ATOL +
    KERNEL_RTOL |plain| everywhere, time both with CUDA events, count the
    call's work and bound (`work`), emit one line; returns {max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms}."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    nbr, valid, src, recv = tensors
    out_k = fn(*tensors, **kw)
    out_r = PF.pair_forces_neighbors_ref(*tensors, **plain_kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{form}: non-finite forces")
    err = (out_k - out_r).abs()
    n_bad = int((err > KERNEL_ATOL + KERNEL_RTOL * out_r.abs()).sum())
    max_abs_err = float(err.max())
    field = {}
    if fn is PF.pair_forces_neighbors:
        # K1's count of the pairs whose field it evaluated against its
        # plain version, and a second call's bits against the first's
        counter = torch.zeros(1, dtype=torch.int64, device=src.device)
        again = fn(*tensors, **kw, field_pairs=counter)
        want = PF.field_pairs_ref(*tensors, **kw)
        field = {"field_pairs": int(counter), "field_pairs_ref": want,
                 "field_pct": 100 * int(counter) / (
                     int(valid.sum()) * kw.get("block_src", BLOCK) *
                     kw.get("block", BLOCK))}
        if int(counter) != want or not torch.equal(again, out_k):
            raise AssertionError(
                f"{form}: K1 counts {int(counter)} field pairs (plain "
                f"{want}), same bits on a second call: "
                f"{torch.equal(again, out_k)}")
    ms = cuda_ms(lambda: fn(*tensors, **kw), reps=50)
    plain_ms = cuda_ms(lambda: PF.pair_forces_neighbors_ref(*tensors,
                                                            **plain_kw),
                       reps=5)
    w = work(tensors, plain_kw)
    block = plain_kw.get("block", BLOCK)
    emit(phase, form=form, name=fn.__name__, shape={
        "blocks": nbr.shape[0], "kb": nbr.shape[1], "block": block,
        "block_src": plain_kw.get("block_src", block),
        "n_src": src.shape[0]},
        options={k: v for k, v in plain_kw.items()
                 if k not in ("block", "uniform")},
        uniform=plain_kw.get("uniform") is not None, **w,
        max_abs_err=max_abs_err, max_abs_force=float(out_r.abs().max()),
        n_over_tolerance=n_bad, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ms=ms,
        plain_ms=plain_ms, **field)
    if n_bad:
        raise AssertionError(f"{form}: {fn.__name__} disagrees with its "
                             f"plain version on {n_bad} values (max |diff| "
                             f"{max_abs_err:.3e})")
    # no single PyTorch call computes a block-sparse pair sum
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "floor": w["floor"], "library_ms": None}


def alternate(name_a, fn_a, name_b, fn_b):
    """In-call yardstick: time a and b in turns (a, b, b, a), each the
    median of YARDSTICK_REPS CUDA-event-timed calls, and emit a's mean
    over b's mean. Launch counts are not read here."""
    times = {name_a: [], name_b: []}
    for name, fn in ((name_a, fn_a), (name_b, fn_b), (name_b, fn_b),
                     (name_a, fn_a)):
        times[name].append(cuda_ms(fn, reps=YARDSTICK_REPS))
    ratio = sum(times[name_a]) / sum(times[name_b])
    emit("kernel_forms", yardstick=f"{name_a} / {name_b}", ms=times,
         ratio=ratio)
    return ratio


def fsm_crowd(state):
    """`state`'s crowd with its navigation spread over the FSM, drawn from
    FSM_SEED as tests/test_torch_step.py's fsm_state draws it: speeds on
    both sides of the FSM's thresholds, a queue of FSM_QUEUE destinations
    0.5-30 m from each rider (half of them stops), queue pointers, FSM
    states and latched braking profiles at random, and FSM_INACTIVE of
    the riders inactive besides the pad rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(FSM_SEED)
    n, q = state.n, FSM_QUEUE
    dev = state.device
    s = state.s.clone()
    pos = s[:, :2].double().cpu().numpy()
    s[:, 3] = torch.as_tensor(rng.choice([0.0, 0.3, 0.6, 1.5, 2.5, 5.0], n),
                              dtype=s.dtype, device=dev)
    r = rng.choice([0.5, 1.9, 2.1, 4.0, 8.0, 30.0], (n, q))
    ang = rng.uniform(-np.pi, np.pi, (n, q))
    entries = np.stack([pos[:, :1] + r * np.cos(ang),
                        pos[:, 1:2] + r * np.sin(ang),
                        (rng.uniform(size=(n, q)) < 0.5).astype(float)],
                       axis=2)
    dq = torch.zeros_like(state.destqueue)
    dq[:, :q] = torch.as_tensor(entries, dtype=s.dtype, device=dev)
    nq = rng.integers(1, q + 1, n)
    ptr = rng.integers(0, q, n) % nq
    znav = np.eye(3, dtype=bool)[rng.integers(0, 3, n)]
    latched = np.stack([rng.uniform(0, 6, n), rng.uniform(0.5, 5, n),
                        rng.uniform(0.1, 3, n), rng.integers(0, 50, n)],
                       axis=1)
    active = state.active.cpu().numpy() & (rng.uniform(size=n)
                                           >= FSM_INACTIVE)

    def t(a, dtype=s.dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return state.replace(
        s=s, destqueue=dq, dest=dq[torch.arange(n, device=dev), t(
            ptr, torch.long)], nq=t(nq, torch.int32),
        destpointer=t(ptr, torch.int32), znav=t(znav, torch.bool),
        znavparams=t(np.where(znav[:, :1], 0.0, latched)),
        i=t(rng.integers(0, 100, n), torch.int32),
        i_stopsignal=t(rng.integers(0, 100, n), torch.int32),
        d_stopsignal=t(rng.uniform(0, 10, n)), active=t(active, torch.bool))


def bits_differ(got, want):
    """(elements that differ bit for bit, their largest distance in units
    in the last place) of two tensors of one dtype; for an integer or
    boolean tensor the distance is 0."""
    import torch

    differ = int((got != want).sum()) if not got.dtype.is_floating_point \
        else int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if not got.dtype.is_floating_point or not differ:
        return differ, 0

    def line(t):
        # the float32 bit patterns on one monotone integer line
        b = t.view(torch.int32).long()
        return torch.where(b < 0, -(b & 0x7FFFFFFF), b)

    return differ, int((line(got) - line(want)).abs().max())


def agent_step_bytes(name, pre, state, engine, kernels):
    """Bytes of one call of the kernel `name` that its function needs on
    this state, each input read once and each output written once.
    agent_pre reads the state fields of the destination update and the
    FSM (the queue entry at each row's pointer and, where the queue has
    one, the next), the uid and each per-rider pair column, and writes
    the FSM fields (an inactive row's held), the force and the packs.
    agent_post reads, for every row, the pre-step state, its pid
    memories and step counter, the activity flag, both forces and the
    position ring but the slot it writes; for an active row also
    agent_pre's destination (x, y), pointer and the queue length; and
    writes the new state, the ring, the counter and the applied force.
    agent_post_whipple reads, for every row, the pre-step state, the bike
    frame's seven latents, the gains row (dyn_gains, all of it: the
    columns past the gains are copied), the step counter, the activity
    flag, both forces and the position ring but the slot it writes; for
    an inactive row its speed dyn_v; and writes the state, the latents,
    dyn_v, the gains row, the ring, the counter and the applied force
    (the constants, 2 KB, read once a block from L2, are not counted).
    Where `kernels` (`Engine.agent_kernels`) name the spline, agent_pre's
    spline instance also reads two slots of the ring and the clock, and
    for a row whose destination is not its last the queue's points (x, y)
    past the two entries the FSM read; agent_post's twod instance also
    reads each row's "arrived" flag."""
    import torch

    n, hist = state.n, state.hist_len
    if name == "agent_pre":
        nbytes = n * (16 + 12 + 4 + 4 + 3 + 16 + 4 + 4 + 4 + 1   # read
                      + 8 + 12 + 4 + 3 + 16 + 4 + 4)             # written
        nxt = (state.destpointer + 1 < state.nq).sum()
        nbytes += 12 * (n + int(nxt))
        nbytes += pre.src_pack.numel() * 4 + pre.recv_pack.numel() * 4
        tables = [v for v in (getattr(engine.params, f) for f in (
            "hfov", "p_0", "p_decay", "f_0", "e_0", "e_1", "sigma_0",
            "sigma_1", "sigma_2", "sigma_3")) if isinstance(v, torch.Tensor)]
        if tables:
            nbytes += 4 * n + sum(min(n, t.numel()) * t.element_size()
                                  for t in tables)
        if kernels.dest == "spline":
            ptr = pre.state.destpointer
            fwd = torch.clamp(state.nq - ptr, max=4)
            past = torch.clamp(ptr + fwd - state.destpointer - 2, min=0)
            nbytes += 16 * n + 4 + 8 * int(past[ptr < state.nq - 1].sum())
    elif name == "agent_post":
        n_act = int(state.active.sum())
        nbytes = (n * (32 + 8 + 8 + 4 + 1 + 16 + 8 * (hist - 1))   # read
                  + n_act * (8 + 4 + 4)
                  + n * (32 + 8 + 8 + 4 + 8 * hist + 8)          # written
                  + 8                               # t_glob, both ways
                  + n * (kernels.post == "agent_post_twod"))  # "arrived"
    else:
        gains = 4 * state.dyn_gains.shape[1]
        n_idle = int((~state.active).sum())
        nbytes = (n * (32 + 28 + gains + 4 + 1 + 16 + 8 * (hist - 1))  # read
                  + n_idle * 4
                  + n * (32 + 28 + 4 + gains + 4 + 8 * hist + 8)  # written
                  + 8)                              # t_glob, both ways
    return nbytes


# the state fields each post kernel writes
POST_FIELDS = {"agent_post": ("s", "pid_e", "pid_i", "i", "t_glob",
                              "pos_hist"),
               "agent_post_whipple": ("s", "dyn_x", "dyn_v", "dyn_gains",
                                      "i", "t_glob", "pos_hist")}
# the agent_step cases whose kernels are timed, and what the kernels'
# lines keep of them
AGENT_TIMED = ("twod", "legacy", "whipple", "twod_spline")
AGENT_KEYS = ("max_abs_err", "ms", "plain_ms", "eager_ms", "plain_eager_ms",
              "bound_ms", "bound_by", "share")


def phase_agent_step(cases):
    """agent_pre and the engine's post kernel (`Engine.agent_kernels`:
    agent_post, or agent_post_whipple on a balancing rider) against their
    plain versions on one step
    of each of `cases` (form -> (engine, state)): the state after a table
    rebuild, in the table's cell-sorted order as the main path holds it.
    agent_pre on the state, and again with a block of pad rows past the
    crowd (`agent_pre_pad`: the packs as `Engine.fused_step` pads a crowd
    that is not a whole number of blocks); the pair kernel on the plain
    version's packs; the post kernel on the plain version's outputs and
    those forces. Every output field compared bit for bit (floats by their
    bits, integer and boolean fields exactly): the count of differing
    elements and their largest distance in ulps per field. On the cases
    of AGENT_TIMED the times
    of both kernels and their plain versions, each call replayed as a
    CUDA graph (`graphed_ms`: 50 and 5 replays; "eager_ms" and
    "plain_eager_ms" the calls as such, with the host's time), their
    bounds and the bound's share of the graphed time. Raises where a
    kernel disagrees."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state
    from cyclistsocialforce_tpu_torch.ops import agent_step as AS

    changed = ("dest", "destpointer", "znav", "znavparams", "i_stopsignal",
               "d_stopsignal")
    out, bad = {}, []
    for form, (engine, state) in cases.items():
        cache = engine.neighbor_cache(state)
        st = permute_state(state, cache[0])
        n = npad = st.n
        kernels = engine.agent_kernels(st)
        if kernels is None:
            raise AssertionError(f"agent_step {form}: not the fused form")
        post = AS.POST_KERNELS[kernels.post]
        post_name = post.__name__
        post_ref = getattr(AS, post_name + "_ref")
        twod = kernels.dest == "spline"
        pre_k = AS.agent_pre(engine, st, npad)
        pre_r = AS.agent_pre_ref(engine, st, npad)
        ragged = engine.pair_rows(n + 1)
        pad_k = AS.agent_pre(engine, st, ragged)
        pad_r = AS.agent_pre_ref(engine, st, ragged)
        pair = engine.pair_kernel_dispatch(cache[1], cache[2],
                                           pre_r.src_pack, pre_r.recv_pack,
                                           cache[4])
        frx, fry = pair[0, :n], pair[1, :n]
        post_k, fx_k, fy_k = post(engine, st, pre_r, frx, fry)
        post_r, fx_r, fy_r = post_ref(engine, st, pre_r, frx, fry)
        torch.cuda.synchronize()
        fields = {
            "agent_pre": {"fdx": (pre_k.fdx, pre_r.fdx),
                          "fdy": (pre_k.fdy, pre_r.fdy),
                          "src_pack": (pre_k.src_pack, pre_r.src_pack),
                          "recv_pack": (pre_k.recv_pack, pre_r.recv_pack),
                          **{f: (getattr(pre_k.state, f),
                                 getattr(pre_r.state, f)) for f in changed}},
            "agent_pre_pad": {f: (getattr(pad_k, f), getattr(pad_r, f))
                              for f in ("src_pack", "recv_pack")},
            post_name: {"fx": (fx_k, fx_r), "fy": (fy_k, fy_r),
                        **{f: (getattr(post_k, f), getattr(post_r, f))
                           for f in POST_FIELDS[post_name]}}}
        line = {"form": form, "n": n, "pad_rows": ragged - n,
                "pair_family": engine.pair_family,
                "per_rider_columns": [
                    f for f in ("f_0", "sigma_0", "p_0", "p_decay")
                    if isinstance(getattr(engine.params, f, None),
                                  torch.Tensor)],
                "fsm_states": st.znav.sum(dim=0).tolist(),
                "inactive": int((~st.active).sum())}
        for name, pairs in fields.items():
            diffs = {f: bits_differ(*pair) for f, pair in pairs.items()}
            line[name] = {"fields_differing": {
                f: {"elements": d, "max_ulps": u}
                for f, (d, u) in diffs.items() if d}, "max_abs_err": max(
                    float((a.double() - b.double()).abs().max())
                    for a, b in pairs.values() if a.dtype.is_floating_point)}
            bad += [f"{form} {name}.{f}" for f, (d, _) in diffs.items() if d]
            # on a twod engine an inactive row's forces are the chain's
            # NaN where its spline is degenerate: its active rows checked
            finite = all(bool(torch.isfinite(
                t[st.active] if twod and t.shape == (n,) else t).all())
                for t, _ in pairs.values() if t.dtype.is_floating_point)
            line[name]["finite"] = finite
            if not finite:
                bad.append(f"{form} {name}: non-finite")
        if form in AGENT_TIMED:
            calls = {
                "agent_pre": (lambda: AS.agent_pre(engine, st, npad),
                              lambda: AS.agent_pre_ref(engine, st, npad)),
                post_name: (
                    lambda: post(engine, st, pre_r, frx, fry),
                    lambda: post_ref(engine, st, pre_r, frx, fry))}
            for name, (kern, plain) in calls.items():
                nbytes = agent_step_bytes(name, pre_r, st, engine, kernels)
                ops = OPS_AGENT[name + ("_spline" if twod and name ==
                                        "agent_pre" else "")]
                floors = {"fp32": 1e3 * ops * n / PEAK_FLOPS,
                          "bytes": 1e3 * nbytes / PEAK_BYTES_PER_S}
                floor = max(floors, key=floors.get)
                kern_ms = graphed_ms(kern, reps=50)
                line[name].update(
                    ms=kern_ms, share=floors[floor] / kern_ms,
                    plain_ms=graphed_ms(plain, reps=5),
                    eager_ms=cuda_ms(kern, reps=50),
                    plain_eager_ms=cuda_ms(plain, reps=5),
                    bytes=nbytes, floors_ms=floors, bound_ms=floors[floor],
                    bound_by="bytes" if floor == "bytes" else "operations")
            out[form] = line
        emit("agent_step", **line)
    if bad:
        raise AssertionError(f"agent_step: the kernels differ from their "
                             f"plain versions in {bad}")
    return out


def phase_kernel(engine, state):
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    kw = dict(block=BLOCK, block_src=BLOCK_SRC, uniform=engine.uniform_pair,
              fov=not engine.full_fov)
    return check_form("kernel", "main", PF.pair_forces_neighbors,
                      sorted_inputs(engine, state), kw, kw)


def phase_kernel_forms(engine, db_engine, state):
    """Every other single-family form of the three kernels at the main
    path's shape: K1 and K2 on the main table (block_src 64, kb 19), K3
    and K1 in K3's form on the K3 path's table (block_src 128). Per-source
    column forms run on the K3 path's per-rider parameters."""
    import math

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    k1, k2, k3 = (PF.pair_forces_neighbors, PF.pair_forces_neighbors_unrolled,
                  PF.pair_forces_neighbors_db)
    full_fov = make_engine(BicycleParams.create(hfov=2 * math.pi))
    columns = make_engine(db_engine.params)
    main_t, fov_t, col_t = (sorted_inputs(e, state)
                            for e in (engine, full_fov, columns))
    db_t = sorted_inputs(db_engine, state)
    u = engine.uniform_pair
    bs64 = dict(block=BLOCK, block_src=BLOCK_SRC)
    bs128 = dict(block=BLOCK, block_src=DB_BLOCK)
    screen = dict(screen=True, cutoff=CUTOFF)
    # name: (kernel, packs, kernel kwargs, plain-version kwargs or None
    # for the same)
    forms = {
        "k1_screen": (k1, main_t, {**bs64, "uniform": u, **screen}, None),
        "k1_screen_sub32": (k1, main_t,
                            {**bs64, "uniform": u, **screen, "sub": 32},
                            None),
        "k1_fov_off": (k1, fov_t, {**bs64, "uniform": full_fov.uniform_pair,
                                   "fov": False}, None),
        "k1_columns": (k1, col_t, {**bs64}, None),
        "k1_p2r": (k1, main_t, {**bs64, "uniform": u, "priority_p2r": True},
                   None),
        "k2_uniform": (k2, main_t, {**bs64, "uniform": u}, None),
        "k2_columns": (k2, col_t, {**bs64}, None),
        "k3": (k3, db_t, {"block": BLOCK, "cutoff": CUTOFF},
               {**bs128, **screen}),
        "k3_p2r": (k3, db_t, {"block": BLOCK, "cutoff": CUTOFF,
                              "priority_p2r": True},
                   {**bs128, **screen, "priority_p2r": True}),
        # K3's computation through K1, for the time comparison
        "k1_screen_bs128_columns": (k1, db_t, {**bs128, **screen}, None),
    }
    out = {name: check_form("kernel_forms", name, fn, t, kw, plain or kw)
           for name, (fn, t, kw, plain) in forms.items()}
    main_kw = {**bs64, "uniform": u, "fov": not engine.full_fov}
    k1_db_kw, k3_kw = forms["k1_screen_bs128_columns"][2], forms["k3"][2]
    ratios = {
        "k2_uniform": alternate("k1 main", lambda: k1(*main_t, **main_kw),
                                "k2 uniform",
                                lambda: k2(*main_t, **main_kw)),
        "k3": alternate("k1 screen bs128 columns",
                        lambda: k1(*db_t, **k1_db_kw),
                        "k3", lambda: k3(*db_t, **k3_kw)),
    }
    return out, ratios


def two_family(engine, state):
    """(nbr, valid, src, recv) of a two-family pack: the legacy `engine`'s
    table and sorted packs with every other rider (odd uid) a twod row of
    per-rider columns (the K3 path's jittered f_0 and sigma_0, family
    0)."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state

    cache = engine.neighbor_cache(state)
    st = permute_state(state, cache[0])
    src_leg, recv = engine.pack_pair_fields(st)
    params = jittered_params(state.n, "cuda", torch.float32)
    src_twod, _ = make_engine(params).pack_pair_fields(st)
    odd = (st.uid % 2 == 1)[:, None]
    return cache[1], cache[2], torch.where(odd, src_twod, src_leg), recv


def phase_mixed_forms(leg, leg_db, state):
    """The mixed-family forms at the legacy path's shape: K1 unscreened,
    with the tile screen (the slice_legacy form), the strip screen
    (sub 32), the FOV cone off and priority to the right, K2, and K3 on
    the block_src 128 table; then a two-family pack through K1 (tile
    screen), K2 and K3."""
    import math

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    k1, k2, k3 = (PF.pair_forces_neighbors, PF.pair_forces_neighbors_unrolled,
                  PF.pair_forces_neighbors_db)
    full_fov = leg.with_params(BicycleParams.create(hfov=2 * math.pi))
    leg_t, fov_t, db_t = (sorted_inputs(e, state)
                          for e in (leg, full_fov, leg_db))
    two_t, two_db = two_family(leg, state), two_family(leg_db, state)
    bs64 = dict(block=BLOCK, block_src=BLOCK_SRC, mixed=True)
    bs128 = dict(block=BLOCK, block_src=DB_BLOCK, mixed=True)
    screen = dict(screen=True, cutoff=LEG_CUTOFF)
    k3_kw = {"block": BLOCK, "cutoff": LEG_CUTOFF, "mixed": True}
    k3_plain = {**bs128, **screen}
    forms = {
        "k1_mixed": (k1, leg_t, bs64, None),
        "k1_mixed_screen": (k1, leg_t, {**bs64, **screen}, None),
        "k1_mixed_screen_sub32": (k1, leg_t, {**bs64, **screen, "sub": 32},
                                  None),
        "k1_mixed_fov_off": (k1, fov_t, {**bs64, "fov": False}, None),
        "k1_mixed_p2r": (k1, leg_t, {**bs64, "priority_p2r": True}, None),
        "k2_mixed": (k2, leg_t, bs64, None),
        "k3_mixed": (k3, db_t, k3_kw, k3_plain),
        "k1_two_family_screen": (k1, two_t, {**bs64, **screen}, None),
        "k2_two_family": (k2, two_t, bs64, None),
        "k3_two_family": (k3, two_db, k3_kw, k3_plain),
    }
    out = {name: check_form("kernel_forms", name, fn, t, kw, plain or kw)
           for name, (fn, t, kw, plain) in forms.items()}
    k1_kw = {**bs64, **screen}
    ratios = {
        "k3_mixed": alternate("k1 mixed tile screen",
                              lambda: k1(*leg_t, **k1_kw),
                              "k3 mixed", lambda: k3(*db_t, **k3_kw)),
        "k2_mixed": alternate("k1 mixed", lambda: k1(*leg_t, **bs64),
                              "k2 mixed", lambda: k2(*leg_t, **bs64)),
    }
    return out, ratios


def audited_engine(make, tag, state, **kw):
    """`make(kb=..., **kw)` with kb = the in-range maximum at t = 0
    (counted with a table of 8 * KB slots, itself overflow-free) plus
    KB_MARGIN."""
    most = audit_overflow(make(kb=8 * KB, **kw), state, f"{tag} probe t=0")
    return make(kb=most + KB_MARGIN, **kw)


def phase_block_forms(state):
    """The receiver blocks other than 128 that the kernels are compiled
    for (BLOCK_FORMS): K1 in its main form and K2 `uniform` on the main
    path's field (block_src BLOCK_FORMS[block]), K3 with per-rider columns
    and its tile screen (block_src = block), each against its plain
    version at the 100,000-rider shape, kb from the audit."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    k1, k2, k3 = PF.KERNELS
    params = jittered_params(state.n, "cuda", torch.float32)
    out = {}
    for block, block_src in BLOCK_FORMS.items():
        main = audited_engine(make_engine, f"block {block}", state,
                              block=block, block_src=block_src)
        db = audited_engine(
            lambda **kw: make_engine(params, **kw), f"db block {block}",
            state, backend="pallas_db", block=block, block_src=block,
            screen=True)
        main_t, db_t = sorted_inputs(main, state), sorted_inputs(db, state)
        kw = dict(block=block, block_src=block_src,
                  uniform=main.uniform_pair, fov=not main.full_fov)
        out[f"k1_block{block}"] = check_form(
            "kernel_forms", f"k1_block{block}", k1, main_t, kw, kw)
        out[f"k2_block{block}"] = check_form(
            "kernel_forms", f"k2_block{block}", k2, main_t, kw, kw)
        out[f"k3_block{block}"] = check_form(
            "kernel_forms", f"k3_block{block}", k3, db_t,
            {"block": block, "cutoff": CUTOFF},
            {"block": block, "block_src": block, "screen": True,
             "cutoff": CUTOFF})
    return out


def phase_legacy_config(state):
    """The legacy path's engines: kb = the in-range maximum at t = 0
    (counted with a table of 4 * KB slots, itself overflow-free) plus
    KB_MARGIN, at block_src 64 (K1, K2) and at block_src 128 (K3)."""
    engines = []
    for block_src, backend in ((BLOCK_SRC, "pallas"), (DB_BLOCK,
                                                        "pallas_db")):
        probe = make_legacy_engine(block_src=block_src, kb=4 * KB)
        most = audit_overflow(probe, state,
                              f"legacy probe block_src {block_src} t=0")
        engines.append(make_legacy_engine(block_src=block_src,
                                          kb=most + KB_MARGIN,
                                          backend=backend))
    return engines


def phase_db_config(state):
    """The K3 path's engine: per-rider f_0 and sigma_0 on the card, block =
    block_src = 128, kb = the in-range maximum at t = 0 (counted with a
    table of 4 * KB slots, itself overflow-free) plus KB_MARGIN."""
    import torch

    params = jittered_params(state.n, "cuda", torch.float32)
    probe = make_engine(params, backend="pallas_db", block_src=DB_BLOCK,
                        kb=4 * KB, screen=True)
    most = audit_overflow(probe, state, "db probe t=0")
    return make_engine(params, backend="pallas_db", block_src=DB_BLOCK,
                       kb=most + KB_MARGIN, screen=True)


# each wrapper's kernel by the name a device trace shows it under
KERNEL_SYMBOLS = {"pair_forces_neighbors": "pair_forces_twod_kernel",
                  "pair_forces_neighbors_unrolled":
                      "pair_forces_unrolled_kernel",
                  "pair_forces_neighbors_db": "pair_forces_db_kernel",
                  "agent_pre": "agent_pre_kernel<",
                  "agent_post": "agent_post_kernel<",
                  "agent_post_whipple": "agent_post_kernel_whipple("}


# Kineto's own record of lost device activity: the profiler's log line when
# CUPTI drops activity records or its buffers fill ("Dropped N activity
# records", "... stopped by GPU profiler. (Buffer size configured is ...")
DROP_PATTERN = re.compile(r"dropped|buffer size configured|overflow",
                          re.IGNORECASE)
# Kineto's log level for warnings (its LoggerOutputType WARNING); at the
# default level it prints none, lost records included
KINETO_WARNING = 2
# a trace whose records Kineto reports lost is void and taken again, up to
# this many times in all; a count that disagrees with no loss reported fails
# unless it is a pure undercount (TRACE_UNDERCOUNT)
TRACE_ATTEMPTS = 3
# TRACE_UNDERCOUNT: a trace may lose a record without Kineto's log saying
# so: on an H100 a slice_mixed trace once showed 39 of 40 K1 runs with
# the replay counters at 40 and no loss in the log (ROADMAP Queue 3.12).
# A trace that shows fewer runs of the path's own kernel than the replays
# launched, none of another kernel and none by a wrapper is therefore
# void as well; one more run than the replays, another kernel, or a
# launch by a wrapper still fails at once


@contextlib.contextmanager
def captured_stderr(out):
    """Route file descriptor 2 (where Kineto's C++ logger writes) into a
    file under the checkout's build directory for the block; its text goes
    into out["text"] and back to the real stderr."""
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(dir=build) as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield out
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            out["text"] = tmp.read().decode(errors="replace")
            sys.stderr.write(out["text"])


def traced_pair_kernels(engine, state, steps):
    """How often each counted kernel (the pair kernels and the per-agent
    ones) ran on the card in one graphed
    `simulate` of `steps` steps, read from a torch.profiler device trace,
    and the lines of Kineto's log that report lost records: ({wrapper
    name: kernel events}, [log lines])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log = {}
    with captured_stderr(log):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.simulate(state, steps, record=False, graph=True)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    lost = [ln.strip() for ln in log["text"].splitlines()
            if DROP_PATTERN.search(ln)]
    if not names:
        raise AssertionError("the trace holds no device activity")
    return ({fn: sum(symbol in n for n in names)
             for fn, symbol in KERNEL_SYMBOLS.items()}, lost)


def phase_slice(phase, engine, state, kernel, report=None):
    """N_STEPS steps of `engine.simulate` as a user calls it (on the card
    each chunk is one CUDA-graph replay), each step through `kernel`.
    Every count is set to 0 just before the run. The wrappers count what
    they launch themselves, here the REBUILD steps of the capture's
    warm-up chunk; a replay runs no wrapper, so the engine counts its
    replays times the launches its capture recorded: exactly N_STEPS of
    `kernel` and none of the other kernels. A device trace of
    PROFILE_STEPS further graphed steps then shows that a replay does run
    that kernel once per step, and no other pair kernel. Also: a finite
    state, no table overflow at t = 0 and t = end. Then the eager loop and
    the graphed one timed in turns, TIMED_ROUNDS runs of each. `report`:
    a function of the run's final state whose dict goes into the run's
    line. `kernel` None: a path that launches no pair kernel (the generic
    culled path), held to none launched and none in the trace. A path of
    FUSED_PATHS launches agent_pre and its post kernel as often as its pair
    kernel, in the counts and in the trace; every other path none of
    them."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import agent_step as AS
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    counted = PF.KERNELS + AS.KERNELS
    fused = ((AS.agent_pre, getattr(AS, FUSED_PATHS[phase]))
             if phase in FUSED_PATHS else ())

    def named(counts):
        return dict(zip((fn.__name__ for fn in counted), counts))

    def only(n):
        return {fn.__name__: n * (fn is kernel or fn in fused)
                for fn in counted}

    audit_overflow(engine, state, f"{phase} t=0")
    torch.cuda.synchronize()
    if engine._runners:
        raise AssertionError(f"{phase}: the engine has captured already")
    PF.reset_launches(counted)
    t0 = time.perf_counter()
    final, _ = engine.simulate(state, N_STEPS, record=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm_up = named(PF.launch_counts(counted))
    launches = named(engine.graph_launches(counted))
    finite = bool(torch.isfinite(final.s).all())
    runner, = engine._runners.values()
    if runner.graph is None or runner.presorted != engine.sorted_resident:
        raise AssertionError(
            f"{phase}: the run did not go through a captured chunk "
            f"(sorted-resident: {engine.sorted_resident})")
    emit(f"{phase}_run", steps=N_STEPS, backend=engine.neighbors.backend,
         kernel_launches=launches, warm_up_launches=warm_up,
         replays=runner.replays, presorted=runner.presorted,
         finite=finite, first_run_s=first_s,
         capture_s=runner.capture_seconds,
         captured_launches_per_replay=named(
             runner.captured_by[fn] for fn in counted),
         **(report(final) if report else {}))
    if launches != only(N_STEPS) or warm_up != only(REBUILD):
        raise AssertionError(
            f"{phase}: expected {only(N_STEPS)} replayed and "
            f"{only(REBUILD)} warm-up launches, counted {launches} and "
            f"{warm_up}")
    if not finite:
        raise AssertionError(f"{phase}: non-finite state after the run")
    audit_overflow(engine, final, f"{phase} t=end")

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = named(engine.graph_launches(counted))
        PF.reset_launches(counted)
        traced, lost = traced_pair_kernels(engine, state, PROFILE_STEPS)
        replayed = {k: n - before[k] for k, n in
                    named(engine.graph_launches(counted)).items()}
        by_wrapper = named(PF.launch_counts(counted))
        agree = (traced == replayed == only(PROFILE_STEPS)
                 and by_wrapper == only(0))
        undercount = (not agree and replayed == only(PROFILE_STEPS)
                      and by_wrapper == only(0)
                      and all(traced[k] <= replayed[k] for k in traced))
        emit(f"{phase}_trace", steps=PROFILE_STEPS, attempt=attempt,
             device_trace_kernels=traced, counted_replayed=replayed,
             counted_by_wrappers=by_wrapper, lost_records_reported=lost,
             undercount=undercount,
             void=(bool(lost) or undercount) and not agree)
        if agree:
            break
        if not (lost or undercount):
            raise AssertionError(
                f"{phase}: the device trace of {PROFILE_STEPS} graphed "
                f"steps shows {traced}, the replay counters {replayed}, "
                f"the wrappers {by_wrapper}, and the profiler reported no "
                f"lost record")
    else:
        raise AssertionError(
            f"{phase}: all {TRACE_ATTEMPTS} device traces were void (lost "
            f"records reported, or an undercount): the replays are "
            f"unchecked")

    runs = {"eager": [], "graphed": []}
    for _ in range(TIMED_ROUNDS):
        for how, graph in (("eager", False), ("graphed", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.simulate(state, N_STEPS, record=False, graph=graph)
            torch.cuda.synchronize()
            runs[how].append(time.perf_counter() - t0)
    if len(engine._runners) != 1:
        raise AssertionError(f"{phase}: the timed runs captured again")

    def ms(seconds):
        return 1e3 * seconds / N_STEPS

    dt = min(runs["graphed"])
    med = {how: ms(statistics.median(r)) for how, r in runs.items()}
    emit(phase, n_agents=N_AGENTS, n_padded=state.n, steps=N_STEPS,
         backend=engine.neighbors.backend, ms_per_step=ms(dt),
         agent_steps_per_s=N_AGENTS * N_STEPS / dt,
         median_ms_per_step=med,
         best_ms_per_step={how: ms(min(r)) for how, r in runs.items()},
         spread_ms_per_step={how: ms(max(r) - min(r))
                             for how, r in runs.items()},
         eager_over_graphed=med["eager"] / med["graphed"], runs_s=runs)
    pair = ((0, 0) if kernel is None
            else (launches[kernel.__name__], warm_up[kernel.__name__]))
    return pair + tuple((launches[fn.__name__], warm_up[fn.__name__])
                        for fn in AS.KERNELS)


def states_differ(a, b):
    """The fields in which two states are not bit-equal."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS

    return [f for f in _STATE_FIELDS
            if not torch.equal(getattr(a, f), getattr(b, f))]


def phase_graph_parity(paths, record_cases):
    """The graphed run against the eager loop, bit for bit: on each path
    GRAPH_PARITY_STEPS steps from its 100,000-rider state (`paths`: name
    -> (engine, state)) without records and with the per-step metrics;
    with the [T, N, 8] record on the GRAPH_PARITY_RECORD_N-rider crowds of
    `record_cases` (name -> (engine, state)). And for each of
    `record_cases` one eager chunk with every host synchronisation an
    error (what a capture would refuse): at full width where it is a
    path, else on its own crowd."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state

    cases = [(name, engine, st, kw) for name, (engine, st) in paths.items()
             for kw in (dict(record=False),
                        dict(record=False, record_metrics=True))]
    cases += [(name, engine, st, dict(record=True))
              for name, (engine, st) in record_cases.items()]
    for name, engine, st, kw in cases:
        eager, rec_e = engine.simulate(st, GRAPH_PARITY_STEPS, graph=False,
                                       **kw)
        graphed, rec_g = engine.simulate(st, GRAPH_PARITY_STEPS, graph=True,
                                         **kw)
        torch.cuda.synchronize()
        differ = states_differ(eager, graphed)
        if rec_e is not None and not torch.equal(rec_e, rec_g):
            differ.append("records")
        emit("graph_parity", path=name, n=st.n, steps=GRAPH_PARITY_STEPS,
             rebuild_every=REBUILD, options=kw, fields_differing=differ,
             records=None if rec_e is None else list(rec_e.shape))
        if differ:
            raise AssertionError(f"graph_parity {name} {kw}: the graphed "
                                 f"run differs from the eager loop in "
                                 f"{differ}")

    for name in record_cases:
        engine, state = paths.get(name, record_cases[name])
        cache = engine.neighbor_cache(state)
        presorted = engine.sorted_resident
        st = permute_state(state, cache[0]) if presorted else state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.run_chunk(st, cache, REBUILD, presorted=presorted)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit("graph_parity", path=name, check="one eager chunk under "
             "torch.cuda.set_sync_debug_mode('error')", steps=REBUILD,
             sync_points=0)


def phase_metrics(engine, state):
    """The per-step metrics of the main path at full width, through the
    sorted-resident graphed chunks."""
    import torch

    from cyclistsocialforce_tpu_torch.params import pair_hi, pair_lo

    names = engine.METRIC_NAMES
    t0 = time.perf_counter()
    _, m = engine.simulate(state, N_STEPS, record=False, record_metrics=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cols = dict(zip(names, m.double().cpu().T))
    lo = pair_lo(engine.params.v_max_riding)
    hi = pair_hi(engine.params.v_max_riding)
    checks = {
        "shape": tuple(m.shape) == (N_STEPS, len(names)),
        "finite": bool(torch.isfinite(m).all()),
        "n_active": bool((cols["n_active"] == N_AGENTS).all()),
        "nbr_overflow": bool((cols["nbr_overflow"] == 0).all()),
        "v_max": bool(((cols["v_max"] >= lo) & (cols["v_max"] <= hi)).all()),
        "v_mean": bool(((cols["v_mean"] >= lo)
                        & (cols["v_mean"] <= cols["v_max"])).all()),
        "f_max": bool((cols["f_max"] >= cols["f_mean"]).all()),
    }
    emit("metrics", steps=N_STEPS, shape=list(m.shape), run_s=run_s,
         speed_limits=[lo, hi], checks=checks,
         last_row=dict(zip(names, m[-1].tolist())))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"metrics failed: {failed}")


def phase_aliasing(engine, state):
    """Two `simulate` calls on one engine from two different states, with
    the [T, 8] records: what the first call returned is unchanged after
    the second (a graph's outputs live in memory its next replay
    overwrites; `simulate` hands out copies)."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS

    s = state.s.clone()
    s[:, :2] += 1.5
    other = state.replace(s=s)
    kw = dict(record=False, record_metrics=True)
    first, m_first = engine.simulate(state, 2 * REBUILD, **kw)
    keep = {f: getattr(first, f).clone() for f in _STATE_FIELDS}
    m_keep = m_first.clone()
    second, _ = engine.simulate(other, 2 * REBUILD + 5, **kw)
    torch.cuda.synchronize()
    changed = [f for f in _STATE_FIELDS
               if not torch.equal(getattr(first, f), keep[f])]
    if not torch.equal(m_first, m_keep):
        changed.append("records")
    runs_differ = not torch.equal(first.s, second.s)
    emit("aliasing", steps=[2 * REBUILD, 2 * REBUILD + 5],
         first_call_changed=changed, runs_differ=runs_differ)
    if changed or not runs_differ:
        raise AssertionError(f"aliasing: the second simulate changed the "
                             f"first call's {changed} (runs differ: "
                             f"{runs_differ})")


def phase_profile(path, engine, state):
    """One torch.profiler window of PROFILE_STEPS graphed steps (two
    chunks, with their two table rebuilds) of the main path: device
    kernels and copies per step, host launches per step, device-busy ms
    per step, the card's idle share within the window, and the kernels
    by device time. The profiler slows the host's part (the rebuilds), so
    the same steps are also timed without it, and the device-busy time is
    given over that wall time too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.simulate(state, PROFILE_STEPS, record=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.simulate(state, PROFILE_STEPS, record=False)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.simulate(state, PROFILE_STEPS, record=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    device = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e[:2])
    if not device:
        raise AssertionError("profile: the trace holds no device activity")
    busy_us, by_name = 0.0, {}
    window_start = reach = device[0][0]
    for start, end, name in device:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    window_us = reach - window_start
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in (
                "cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync"):
            host[e.name] = host.get(e.name, 0) + 1
    pair_us = sum(t for n, t in by_name.items() if "pair_forces" in n)
    agent_us = sum(t for n, t in by_name.items() if "agent_p" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # what the host launched one by one ran outside the graphs (rebuilds,
    # permutations, the copies into the static buffers)
    eager_launches = sum(n for name, n in host.items()
                         if name != "cudaGraphLaunch")
    emit("profile", path=path, steps=PROFILE_STEPS,
         rebuilds=PROFILE_STEPS // REBUILD,
         wall_ms_per_step=1e3 * wall_s / PROFILE_STEPS,
         unprofiled_wall_ms_per_step=1e3 * plain_wall_s / PROFILE_STEPS,
         device_activities_per_step=len(device) / PROFILE_STEPS,
         graph_activities_per_step=(len(device) - eager_launches)
         / PROFILE_STEPS,
         host_calls=host,
         host_launches_per_step=sum(host.values()) / PROFILE_STEPS,
         device_busy_ms_per_step=1e-3 * busy_us / PROFILE_STEPS,
         window_ms_per_step=1e-3 * window_us / PROFILE_STEPS,
         idle_share=1.0 - busy_us / window_us,
         device_busy_over_unprofiled_wall=1e-6 * busy_us / plain_wall_s,
         pair_kernel_ms_per_step=1e-3 * pair_us / PROFILE_STEPS,
         agent_kernels_ms_per_step=1e-3 * agent_us / PROFILE_STEPS,
         other_ms_per_step=1e-3 * (busy_us - pair_us - agent_us)
         / PROFILE_STEPS,
         top_kernels_ms_per_step={n[:80]: 1e-3 * t / PROFILE_STEPS
                                  for n, t in top})
    return len(device) / PROFILE_STEPS


def cpu_case(kind, **kw):
    """(engine, state) on the CPU of one reference run of a parity phase
    (`kind` the phase; `kw` the audited kb, the dtype, the mode, and
    `pairs32` for the twin whose pair stage takes float32 packs)."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    f64 = torch.float64
    if kind == "parity":
        return make_engine(), build_population(PARITY_N, DENSITY, HIST_LEN,
                                               BLOCK, f64, "cpu")
    if kind == "parity_db":
        st = build_population(PARITY_DB_N, DENSITY, HIST_LEN, BLOCK, f64,
                              "cpu")
        return make_engine(jittered_params(st.n, "cpu", f64),
                           backend="pallas_db", block_src=DB_BLOCK,
                           kb=kw["kb"], screen=True), st
    if kind == "parity_legacy":
        return make_legacy_engine(kb=kw["kb"]), build_population(
            PARITY_LEG_N, DENSITY, HIST_LEN, BLOCK,
            getattr(torch, kw["dtype"]), "cpu")
    if kind == "parity_twod":
        return make_twod_engine(), with_queues(twod_crowd(
            PARITY_TWOD_N, f64, "cpu", BLOCK))
    if kind == "parity_mixed":
        n = 2 * PARITY_MIXED_HALF
        return make_mixed_engine(n, kb=kw["kb"]), with_queues(twod_crowd(
            n, f64, "cpu", None))
    if kind == "parity_scripted":
        st = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              getattr(torch, kw["dtype"]), "cpu")
        return scripted_engine(st), st
    if kind == "parity_kaths":
        return make_kaths_engine(kb=kw["kb"]), kaths_crowd(PARITY_N, f64,
                                                           "cpu")
    if kind == "parity_invpendulum":
        params = ip_params(kw["exact"])
        engine = make_model_engine("invpendulum", params)
        st = with_queues(model_crowd("invpendulum", params, PARITY_IP_N, f64,
                                     "cpu", BLOCK))
    else:
        mode = kw["mode"]
        engine = make_model_engine(br_model(mode), br_params(mode, "cpu"))
        n = PARITY_STOCH_N if mode == "parity_stochastic" else PARITY_BR_N
        st = stable_crowd(mode, n, f64, "cpu")
    return (float32_pairs(engine) if kw.get("pairs32") else engine), st


def _cpu_worker_init():
    import torch

    torch.set_num_threads(1)


def cpu_reference(kind, kw):
    """In a worker process: PARITY_STEPS steps of `cpu_case(kind, **kw)`;
    the final state's fields that `parity_errors` reads, as numpy, and
    the run's wall seconds."""
    engine, st = cpu_case(kind, **kw)
    t0 = time.perf_counter()
    fin, _ = engine.simulate(st, PARITY_STEPS, record=False)
    return {"s": fin.s.numpy(), "znav": fin.znav.numpy(),
            "destpointer": fin.destpointer.numpy(),
            "seconds": time.perf_counter() - t0}


class CpuReferences:
    """The parity phases' CPU reference runs in CPU_WORKERS processes
    (spawned, one torch thread each): `start` submits them all, `get`
    waits for one. `close` shuts the pool down, after what still runs."""

    def __init__(self):
        self.pool, self.futures, self.t0 = None, {}, None

    @staticmethod
    def _key(kind, kw):
        return kind, tuple(sorted(kw.items()))

    def start(self, specs, first=()):
        """Submit `first` ((name, fn, args) runs, the longest first), then
        the parity runs `specs`."""
        import concurrent.futures
        import multiprocessing

        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)
        for name, fn, args in first:
            self.submit(name, fn, *args)
        for kind, kw in specs:
            self.futures[self._key(kind, kw)] = self.pool.submit(
                cpu_reference, kind, kw)

    def submit(self, name, fn, *args):
        """Another CPU run, `fn(*args)` in a worker, under `name`."""
        self.futures[name] = self.pool.submit(fn, *args)

    def result(self, name):
        return self.futures[name].result()

    def get(self, kind, **kw):
        import types

        import torch

        r = self.futures[self._key(kind, kw)].result()
        return types.SimpleNamespace(
            s=torch.from_numpy(r["s"]), znav=torch.from_numpy(r["znav"]),
            destpointer=torch.from_numpy(r["destpointer"]),
            seconds=r["seconds"])

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None
            emit("cpu_references", workers=CPU_WORKERS,
                 runs=len(self.futures),
                 wall_s=time.perf_counter() - self.t0)


def cpu_specs(db_kb, leg_kb, mixed_kb, kaths_kb):
    """Every CPU reference run of the parity phases, the longest first."""
    specs = [("parity_kaths", {"kb": kaths_kb})]
    specs += [("parity_legacy", {"kb": leg_kb, "dtype": d})
              for d in ("float64", "float32")]
    specs += [("parity_mixed", {"kb": mixed_kb}), ("parity_twod", {}),
              ("parity", {})]
    specs += [("parity_scripted", {"dtype": d})
              for d in ("float64", "float32")]
    specs += [("parity_invpendulum", {"exact": e, "pairs32": p})
              for e in (True, False) for p in (False, True)]
    specs += [("parity_balancingrider", {"mode": m, "pairs32": p})
              for m in ("exact", "gains_poly", "hess") for p in (False, True)]
    specs += [("parity_stochastic", {"mode": "parity_stochastic",
                                     "pairs32": p}) for p in (False, True)]
    specs.append(("parity_db", {"kb": db_kb}))
    return specs


def compare_runs(phase, fin_a, fin_b, **info):
    """Final states of two runs held to the two-tier tolerance
    (`parity_errors`); emits one line."""
    errs = parity_errors(fin_a, fin_b)
    emit(phase, steps=PARITY_STEPS, rebuild_every=REBUILD, **info, **errs)
    if errs["failed"]:
        raise AssertionError(f"{phase} failed: {errs['failed']}")


def card_final(engine, state):
    import torch

    fin, _ = engine.simulate(state, PARITY_STEPS, record=False)
    torch.cuda.synchronize()
    return fin


def phase_parity(cpu):
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    engine = make_engine()
    st_gpu = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float32, "cuda")
    audit_overflow(engine, st_gpu, "parity t=0")
    ref = cpu.get("parity")
    compare_runs("parity", card_final(engine, st_gpu), ref, n=PARITY_N,
                 cpu_run_s=ref.seconds,
                 runs="card float32 K1 vs CPU float64 plain")


def phase_parity_db(db_engine, state, cpu):
    """The K3 path against K1 in the same screened per-column form on the
    card (the slice_db crowd), then against the CPU float64 plain version
    on a PARITY_DB_N-rider crowd."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    cfg = db_engine.neighbors
    k1 = make_engine(db_engine.params, block_src=DB_BLOCK, kb=cfg.kb,
                     screen=True)
    compare_runs("parity_db", card_final(db_engine, state),
                 card_final(k1, state), n=state.n,
                 runs="card K3 vs card K1 (screen, block_src 128)")

    st_gpu = build_population(PARITY_DB_N, DENSITY, HIST_LEN, BLOCK,
                              torch.float32, "cuda")
    gpu = db_engine.with_params(jittered_params(st_gpu.n, "cuda",
                                                torch.float32))
    audit_overflow(gpu, st_gpu, "parity_db t=0")
    ref = cpu.get("parity_db", kb=cfg.kb)
    compare_runs("parity_db", card_final(gpu, st_gpu), ref, n=PARITY_DB_N,
                 cpu_run_s=ref.seconds,
                 runs="card float32 K3 vs CPU float64 plain")


def phase_parity_legacy(engine, cpu):
    """The slice_legacy configuration on a PARITY_LEG_N-rider crowd, 45
    steps: the card in float32 (K1, mixed form, tile screen) against the
    plain version on the CPU in float32 (both tiers) and in float64 (the
    cap), see LEG_CUTOFF."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(PARITY_LEG_N, DENSITY, HIST_LEN, BLOCK,
                          torch.float32, "cuda")
    audit_overflow(engine, st, "parity_legacy t=0")
    card = card_final(engine, st)
    kb = engine.neighbors.kb
    cpu32 = cpu.get("parity_legacy", kb=kb, dtype="float32")
    cpu64 = cpu.get("parity_legacy", kb=kb, dtype="float64")
    s32, s64 = cpu32.seconds, cpu64.seconds
    vs32 = parity_errors(card, cpu32)
    vs64 = parity_errors(card, cpu64)
    base = parity_errors(cpu32, cpu64)
    over_cap = [k for k in vs64["failed"]
                if k not in vs64["max"] or vs64["max"][k] > PARITY_CAP[k]]
    info = dict(steps=PARITY_STEPS, rebuild_every=REBUILD, n=PARITY_LEG_N)
    emit("parity_legacy", runs="card float32 K1 mixed vs CPU float32 "
         "plain", cpu_run_s=s32, **info, **vs32)
    emit("parity_legacy", runs="card float32 K1 mixed vs CPU float64 "
         "plain (enforced: the cap)", cpu_run_s=s64, **info, **vs64,
         over_cap=over_cap, cpu_float32_vs_float64={
             k: base[k] for k in ("max", "p99.9", "n_over_tol", "failed")})
    if vs32["failed"] or over_cap:
        raise AssertionError(f"parity_legacy failed: float32 "
                             f"{vs32['failed']}, float64 cap {over_cap}")


def float32_pairs(engine):
    """A twin of `engine` whose pair stage takes float32 packs on any
    device, as K1 does on the card (`engine.pair_kernel_dispatch` casts
    there): on the CPU, the plain version with the card's arithmetic."""
    twin = engine.with_params(engine.params)
    dispatch = twin.pair_kernel_dispatch

    def float32_dispatch(nbr, valid, src, recv, count=None):
        return dispatch(nbr, valid, src.float(), recv.float(),
                        count).to(src.dtype)

    twin.pair_kernel_dispatch = float32_dispatch
    return twin


def phase_parity_queues(phase, engine, n, pad, cpu, make_crowd=twod_crowd,
                        pairs32=False, queues=True, **info):
    """`engine` on an n-rider crowd (`make_crowd(n, dtype, device, pad)`)
    with destination queues (`with_queues`), PARITY_STEPS steps from one
    initial state, the final states against the plain version on the CPU
    in float64: the card's graphed run in float64 (K1 in float32 inside)
    held to both tiers of `parity`, and the card's float32 graphed run
    reported beside it (see TWOD_FLOAT32). With `pairs32` (see
    IP_STEER) the card's float64 run is held to both tiers against the
    CPU float64 run whose pair stage is float32 (`float32_pairs`), and to
    the cap against the plain float64 run. `queues=False` keeps the
    crowd's own destinations. `cpu(pairs32)` gives the CPU float64 run
    (plain, or with float32 pairs), made elsewhere (`CpuReferences`).
    `info` goes into every line."""
    import torch

    def crowd(dtype, device):
        st = make_crowd(n, dtype, device, pad)
        return with_queues(st) if queues else st

    card32, card64 = crowd(torch.float32, "cuda"), crowd(torch.float64,
                                                         "cuda")
    audit_overflow(engine, card32, f"{phase} t=0")
    fin32, _ = engine.simulate(card32, PARITY_STEPS, record=False)
    fin64, _ = engine.simulate(card64, PARITY_STEPS, record=False)
    torch.cuda.synchronize()
    ref = cpu(False)
    info = dict(steps=PARITY_STEPS, rebuild_every=REBUILD, n=n,
                cpu_run_s=ref.seconds, **info)
    vs64 = parity_errors(fin64, ref)
    vs32 = parity_errors(fin32, ref)
    failed = vs64["failed"]
    if pairs32:
        ref32 = cpu(True)
        held = parity_errors(fin64, ref32)
        base = parity_errors(ref32, ref)
        over_cap = [k for k in vs64["failed"]
                    if k not in vs64["max"] or vs64["max"][k] > PARITY_CAP[k]]
        emit(phase, runs="card float64 graphed vs CPU float64 plain with "
             "float32 pairs (enforced)", **info, **held)
        emit(phase, runs="card float64 graphed vs CPU float64 plain "
             "(enforced: the cap)", **info, **vs64, over_cap=over_cap,
             cpu_float32_pairs_vs_float64={
                 k: base[k] for k in ("max", "p99.9", "n_over_tol",
                                      "failed")})
        failed = held["failed"] + over_cap
    else:
        emit(phase, runs="card float64 graphed vs CPU float64 plain "
             "(enforced)", **info, **vs64)
    emit(phase, runs="card float32 graphed vs CPU float64 plain "
         "(reported)", **info,
         **{k: vs32[k] for k in ("max", "p99.9", "n_over_tol", "failed")})
    if failed:
        raise AssertionError(f"{phase} failed: {failed}")


def phase_parity_invpendulum(cpu):
    """The slice_invpendulum configuration on a PARITY_IP_N-rider crowd
    with destination queues, once with the piecewise-polynomial
    propagator and once with the exact one: the card in float64 against
    the CPU in float64 with float32 pairs under both tiers and against
    the plain float64 run under the cap (IP_STEER), the card's float32
    run reported (`phase_parity_queues`). Then the polynomial's
    evaluation on the card with TF32 allowed: bit for bit the evaluation
    with TF32 off, and a float64 evaluation of the fit within the float32
    bound of each rider's segment (POLY_HORNER)."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.ops.piecewise import \
        eval_piecewise_poly

    for exact in (False, True):
        params = ip_params(exact)

        def crowd(n, dtype, device, pad, params=params):
            return model_crowd("invpendulum", params, n, dtype, device, pad)

        phase_parity_queues(
            "parity_invpendulum", make_model_engine("invpendulum", params),
            PARITY_IP_N, BLOCK,
            lambda p, exact=exact: cpu.get("parity_invpendulum", exact=exact,
                                           pairs32=p),
            crowd, pairs32=True,
            propagator="exact" if exact else f"zoh_poly={IP_ZOH_POLY}")

    poly = ip_params().ip_zoh_poly
    v = torch.as_tensor(np.random.default_rng(TWOD_QUEUE_SEED).uniform(
        0.5, 7.5, N_AGENTS), dtype=torch.float32)
    flags = torch.backends.cuda.matmul.allow_tf32
    out = {}
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            out[allow] = torch.stack(eval_piecewise_poly(poly, v.cuda(), 30))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags
    same = torch.equal(out[True], out[False])
    excess = poly_float32_excess(poly, v.double().numpy(),
                                 out[True].cpu().double().numpy())
    over = int((excess > 1.0).sum())
    emit("parity_invpendulum", check="ip_zoh_poly evaluation with TF32 "
         "allowed", n=N_AGENTS, tf32_on_equals_off=same,
         max_err_over_bound=float(excess.max()),
         card_vs_float64_over_bound=over)
    if not same or over:
        raise AssertionError(f"parity_invpendulum: the poly evaluation with "
                             f"TF32 allowed: equal to TF32 off {same}, "
                             f"{over} values beyond the float32 bound")


def phase_parity_balancingrider(state, cpu):
    """The slice_balancingrider configuration on a PARITY_BR_N-rider
    stable crowd (`stable_crowd`), PARITY_STEPS steps, with the exact
    placement, with gains_poly and with the Hess model: the card in
    float64 against the CPU in float64 with float32 pairs under both tiers
    and against the plain float64 run under the cap (IP_STEER), the
    card's float32 run reported (`phase_parity_queues`, the crowd's own
    destinations). Then one gains_poly step of the 100,000 riders of
    `state` with TF32 allowed for matrix products: bit for bit the step
    with TF32 off."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.models import balancingrider as BR

    for mode in ("exact", "gains_poly", "hess"):
        def crowd(n, dtype, device, pad, mode=mode):
            return stable_crowd(mode, n, dtype, device, pad)

        phase_parity_queues(
            "parity_balancingrider",
            make_model_engine(br_model(mode), br_params(mode)),
            PARITY_BR_N, BLOCK,
            lambda p, mode=mode: cpu.get("parity_balancingrider", mode=mode,
                                         pairs32=p),
            crowd, pairs32=True, queues=False, model=br_model(mode),
            mode=mode)

    rng = np.random.default_rng(TWOD_QUEUE_SEED)
    fx, fy = (torch.as_tensor(rng.normal(3.0, 2.0, state.n),
                              dtype=state.s.dtype, device=state.device)
              for _ in range(2))
    flags = torch.backends.cuda.matmul.allow_tf32
    out = {}
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            out[allow] = BR.step(br_params(), state, fx, fy)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags
    differ = [f for f in ("s", "dyn_x", "dyn_v", "dyn_gains")
              if not torch.equal(getattr(out[True], f),
                                 getattr(out[False], f))]
    emit("parity_balancingrider", check="gains_poly step with TF32 "
         "allowed", n=state.n, tf32_on_fields_differing=differ)
    if differ:
        raise AssertionError(f"parity_balancingrider: the step with TF32 "
                             f"allowed differs in {differ}")


def phase_parity_stochastic(cpu):
    """The stochastic balancing rider (STOCH_PARITY: budget, cadence and
    torque disturbances) on PARITY_STOCH_N stable riders, PARITY_STEPS
    steps: the card in float64 against the CPU float64 run with float32
    pairs under both tiers and against plain float64 under the cap, the
    card's float32 run reported (`phase_parity_queues`). Then the pole
    features that every rider of a 100,000-rider card state draws (all
    needy, the dense resampler) and its torque disturbances, from the
    state and from its rows shuffled: per uid bit for bit."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state
    from cyclistsocialforce_tpu_torch.models import balancingrider as BR
    from cyclistsocialforce_tpu_torch.state import V

    mode = "parity_stochastic"

    def crowd(n, dtype, device, pad):
        return stable_crowd(mode, n, dtype, device, pad)

    phase_parity_queues(
        "parity_stochastic", make_model_engine("balancingrider",
                                               br_params(mode)),
        PARITY_STOCH_N, BLOCK,
        lambda p: cpu.get("parity_stochastic", mode=mode, pairs32=p),
        crowd, pairs32=True, queues=False, model="balancingrider",
        params=STOCH_PARITY)

    params = br_params("stochastic_exact").replace(**STOCH_DIST)
    state = stable_crowd("stochastic_exact", N_AGENTS, torch.float32,
                         "cuda")
    perm = torch.as_tensor(np.random.default_rng(TWOD_QUEUE_SEED)
                           .permutation(state.n), device="cuda")
    c = BR.step_constants(params, state.s.dtype, state.device)["constants"]

    def draws(st):
        v = st.s[:, V] + 1.0
        feats, new = BR._pole_features(params, c, st, v,
                                       torch.ones_like(st.active))
        t_roll, t_steer = BR._disturbances(params, st)
        by_uid = torch.argsort(st.uid.long())
        return [t[by_uid] for t in (feats, new.dyn_gains, t_roll, t_steer)]

    differ = [name for name, a, b in zip(
        ("features", "dyn_gains", "roll_torques", "steer_torques"),
        draws(state), draws(permute_state(state, perm)))
        if not torch.equal(a, b)]
    emit("parity_stochastic", check="per-uid draws of a row-shuffled "
         "state", n=state.n, fields_differing=differ)
    if differ:
        raise AssertionError(f"parity_stochastic: the draws of shuffled "
                             f"rows differ per uid in {differ}")


def poly_float32_excess(poly, v, got):
    """Per output and rider, |got - the fit at v in float64| over the
    float32 rounding bound of the rider's segment (POLY_HORNER): values
    over 1 are out of bound. `v` [N] and `got` [n_out, N] are float64
    numpy arrays; a rider near a segment boundary takes the nearer of its
    two segments' evaluations."""
    import numpy as np

    coeffs, lo, seg_dv = poly
    n_seg = len(coeffs)
    n_out = got.shape[0]
    c = np.asarray(coeffs).reshape(n_seg, n_out, -1)          # [S, M, D]
    deg1 = c.shape[2]
    eps = float(np.finfo(np.float32).eps)
    x = np.clip((v - lo) / seg_dv, 0.0, n_seg - 1e-6)
    scale = np.maximum(x, 1.0)
    slack = 16 * eps * scale
    horner = np.abs(c).sum(axis=2)                             # [S, M]
    slope = (np.abs(c) * np.arange(deg1)).sum(axis=2)          # [S, M]
    best = None
    for side in (-1.0, 1.0):
        seg = np.clip(np.floor(x + side * slack), 0, n_seg - 1).astype(int)
        u = x - seg
        cs = c[seg]                                            # [N, M, D]
        want = cs[:, :, deg1 - 1]
        for d in range(deg1 - 2, -1, -1):
            want = want * u[:, None] + cs[:, :, d]
        bound = eps * (3 * deg1 * horner[seg]
                       + 4 * scale[:, None] * slope[seg])       # [N, M]
        ratio = (np.abs(got.T - want) / bound).T
        best = ratio if best is None else np.minimum(best, ratio)
    return best


def phase_parity_scripted(cpu):
    """slice_scripted's configuration on the PARITY_N crowd, 45 steps:
    every scripted rider of the card's run exactly on its script
    (replay); the card in float32 (K1's column form) against the plain
    version on the CPU in float32 under both tiers, and against the CPU
    in float64 under both tiers but where the CPU's own float32 run fails
    a tier too (SCRIPTED_F32: reported beside it)."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(PARITY_N, DENSITY, HIST_LEN, BLOCK, torch.float32,
                          "cuda")
    engine = scripted_engine(st)
    audit_overflow(engine, st, "parity_scripted t=0")
    card = card_final(engine, st)
    replay = scripts_followed(engine, st, card, PARITY_STEPS)
    cpu32 = cpu.get("parity_scripted", dtype="float32")
    cpu64 = cpu.get("parity_scripted", dtype="float64")
    vs32, vs64 = parity_errors(card, cpu32), parity_errors(card, cpu64)
    base = parity_errors(cpu32, cpu64)
    excused = [k for k in vs64["failed"] if k in base["failed"]]
    info = dict(steps=PARITY_STEPS, rebuild_every=REBUILD, n=PARITY_N,
                scripts=replay)
    emit("parity_scripted", runs="card float32 K1 columns vs CPU float32 "
         "plain (enforced)", cpu_run_s=cpu32.seconds, **info, **vs32)
    emit("parity_scripted", runs="card float32 K1 columns vs CPU float64 "
         "plain (enforced but where the CPU's float32 run fails too)",
         cpu_run_s=cpu64.seconds, **info, **vs64, excused=excused,
         cpu_float32_vs_float64={
             k: base[k] for k in ("max", "p99.9", "n_over_tol", "failed")})
    failed = vs32["failed"] + [k for k in vs64["failed"]
                               if k not in excused]
    if failed:
        raise AssertionError(f"parity_scripted failed: {failed}")


def phase_parity_kaths(kb, cpu):
    """slice_kaths's configuration on the PARITY_N crowd, 45 steps: the
    card in float32 against the CPU in float64 (the generic culled path
    on both) under both tiers, and every state finite."""
    import torch

    st = kaths_crowd(PARITY_N, torch.float32, "cuda")
    engine = make_kaths_engine(kb=kb)
    audit_overflow(engine, st, "parity_kaths t=0")
    card = card_final(engine, st)
    if not torch.isfinite(card.s).all():
        raise AssertionError("parity_kaths: non-finite state on the card")
    ref = cpu.get("parity_kaths", kb=kb)
    compare_runs("parity_kaths", card, ref, n=PARITY_N,
                 cpu_run_s=ref.seconds, finite=True,
                 runs="card float32 vs CPU float64, generic culled path")


def phase_scenario(state):
    """A `Scenario` of the main path on the card: N_STEPS steps in chunks
    of SCENARIO_CHUNK (each one simulate call, one graph replay), and the
    same run interrupted at SCENARIO_SPLIT by a checkpoint that a fresh
    engine's scenario restores: bit for bit the straight run's final
    state."""
    import torch

    from cyclistsocialforce_tpu_torch.engine import _STATE_FIELDS
    from cyclistsocialforce_tpu_torch.scenario import Scenario

    straight = Scenario(make_engine(), state, chunk=SCENARIO_CHUNK)
    straight.run(n_steps=N_STEPS)
    first = Scenario(make_engine(), state, chunk=SCENARIO_CHUNK)
    first.run(n_steps=SCENARIO_SPLIT)
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    path = build / "scenario_checkpoint.npz"
    t0 = time.perf_counter()
    first.checkpoint(path)
    resumed = Scenario(make_engine(), state, chunk=SCENARIO_CHUNK)
    meta = resumed.restore(path)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = path.stat().st_size
    path.unlink()
    resumed.run(n_steps=N_STEPS - SCENARIO_SPLIT)
    torch.cuda.synchronize()
    differ = [f for f in _STATE_FIELDS
              if not torch.equal(getattr(straight.state, f),
                                 getattr(resumed.state, f))]
    emit("scenario", n=state.n, steps=N_STEPS, chunk=SCENARIO_CHUNK,
         checkpoint_at=SCENARIO_SPLIT, restored_i=meta["i"],
         resumed_i=resumed.i, checkpoint_and_restore_s=ckpt_s,
         checkpoint_bytes=ckpt_bytes, fields_differing=differ,
         straight_metrics=straight.metrics.summary(),
         straight_ms_per_step_by_chunk=[
             1e3 * t for t in straight.metrics.step_wall_times()])
    if differ or resumed.i != N_STEPS or meta["i"] != SCENARIO_SPLIT:
        raise AssertionError(f"scenario: the resumed run differs from the "
                             f"straight one in {differ} (steps "
                             f"{resumed.i})")


def phase_diagnostics(state):
    """`checked_simulate` of the main path at full width on the card: a
    clean run reports nothing; a run whose model step turns one rider's y
    into NaN at step DIAG_AT reports that step."""
    import torch

    from cyclistsocialforce_tpu_torch.diagnostics import checked_simulate
    from cyclistsocialforce_tpu_torch.models import MODELS

    engine = make_engine()
    t0 = time.perf_counter()
    clean, (fin, _) = checked_simulate(engine, DIAG_STEPS)(state)
    clean_s = time.perf_counter() - t0
    step = MODELS["bicycle2d"].step
    victim = int(torch.nonzero(state.active)[0, 0])

    def poisoned(params, st, fx, fy):
        new = step(params, st, fx, fy)
        s = new.s.clone()
        s[victim, 1] = torch.where(st.i[victim] == DIAG_AT, float("nan"),
                                   s[victim, 1])
        return new.replace(s=s)

    engine.model_step = poisoned
    err, (_, traj) = checked_simulate(engine, DIAG_STEPS)(state)
    finite_before = bool(torch.isfinite(traj[:DIAG_AT]).all())
    want = f"non-finite state at step {DIAG_AT}"
    emit("diagnostics", n=state.n, steps=DIAG_STEPS, clean=clean.get(),
         clean_run_s=clean_s, injected_at=DIAG_AT, reported=err.get(),
         finite_before=finite_before)
    if clean.get() is not None or err.get() != want or not finite_before:
        raise AssertionError(f"diagnostics: clean run {clean.get()!r}, "
                             f"injected run {err.get()!r} (want {want!r})")


def sumo_demand():
    """The packaged demand of SUMO_NET: [(vehicle, route edges, depart s,
    speed, start offset)], each flow's `number` riders departing evenly
    over [begin, end) (SUMO's spacing of a `number=` flow), the speed and
    offset of each drawn as demos/demo_sumo.py draws them."""
    import xml.etree.ElementTree as ET

    import numpy as np

    from cyclistsocialforce_tpu_torch.sumo.net import SUMO_DATA_DIR

    root = ET.parse(os.path.join(SUMO_DATA_DIR,
                                 f"{SUMO_NET}.rou.xml")).getroot()
    routes = {r.get("id"): tuple(r.get("edges").split())
              for r in root.iter("route")}
    rng = np.random.default_rng(SUMO_SEED)
    demand = []
    for flow in root.iter("flow"):
        begin, end = float(flow.get("begin")), float(flow.get("end"))
        number = int(flow.get("number"))
        for i in range(number):
            demand.append((f"{flow.get('id')}.{i}", routes[flow.get("route")],
                           begin + i * (end - begin) / number,
                           float(rng.uniform(3.0, 5.0)),
                           float(rng.uniform(0.0, 10.0))))
    return demand


class PushRecorder:
    """A transport that passes every call to `inner` (a FakeTraCI) and
    records each moveToXY push as (step, vehicle, x, y)."""

    def __init__(self, inner):
        self.inner, self.pushes, self.step = inner, [], 0
        rec = self

        class _Vehicle:
            def __getattr__(self, name):
                return getattr(inner.vehicle, name)

            def moveToXY(self, vid, edge_id, lane_index, x, y, angle=None,
                         keepRoute=6):
                rec.pushes.append((rec.step, vid, x, y))
                inner.vehicle.moveToXY(vid, edge_id, lane_index, x, y,
                                       angle=angle, keepRoute=keepRoute)

        self.vehicle = _Vehicle()
        self.lane, self.simulation = inner.lane, inner.simulation

    def simulationStep(self):
        self.step += 1
        self.inner.simulationStep()

    def close(self):
        self.inner.close()


def run_sumo(device, keep_form=False):
    """The sumo path on `device` (on the CPU in float64 with the pair
    stage in float32, `float32_pairs`): SumoCoSimulation.step until
    FakeTraCI expects no vehicle or SUMO_MAX_STEPS. Returns the steps, the
    pushes, each rider's (junction: [enter step, exit step]), the
    (junction, step) pairs that held a rider, the seconds of the handover,
    the engine steps, the pushes and FakeTraCI apart, and with
    `keep_form` the cell-sorted packs of the fullest junction (what K1
    took there)."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch import NeighborConfig
    from cyclistsocialforce_tpu_torch.sumo import (FakeTraCI,
                                                   SumoCoSimulation,
                                                   load_packaged_net)

    cuda = torch.device(device).type == "cuda"
    net = load_packaged_net(SUMO_NET)
    fake = FakeTraCI(net, step_length=0.01)
    demand = sumo_demand()
    for vid, route, depart, speed, offset in demand:
        fake.add_vehicle(vid, route, speed=speed, depart=depart,
                         depart_pos=offset)
    rec = PushRecorder(fake)
    cs = SumoCoSimulation(net, rec, bicycle_type="bicycle",
                          capacity=SUMO_CAPACITY,
                          neighbors=NeighborConfig(**SUMO_NEIGHBORS),
                          device=device)
    if not cuda:
        for ins in cs.intersections:
            ins.engine = float32_pairs(ins.engine)
    clock = dict.fromkeys(("handover", "engine", "push", "transport"), 0.0)
    occupied = [0]

    def timed(key, fn, sync=False):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run

    def counted(ins, step):
        def run():
            occupied[0] += bool(ins._slots)
            step()
        return run

    cs.allocate_road_users = timed("handover", cs.allocate_road_users)
    for ins in cs.intersections:
        ins.step = timed("engine", counted(ins, ins.step), sync=cuda)
        ins.push_positions = timed("push", ins.push_positions)
    rec.simulationStep = timed("transport", rec.simulationStep)

    handovers = {vid: {} for vid, *_ in demand}
    inside = {ins.id: set() for ins in cs.intersections}
    fullest, form = 0, None
    steps = 0
    t0 = time.perf_counter()
    while fake.simulation.getMinExpectedNumber() > 0 \
            and steps < SUMO_MAX_STEPS:
        cs.step()
        steps += 1
        for ins in cs.intersections:
            now = set(ins._slots)
            for vid in now - inside[ins.id]:
                handovers[vid][ins.id] = [steps, None]
            for vid in inside[ins.id] - now:
                handovers[vid][ins.id][1] = steps
            inside[ins.id] = now
            if keep_form and len(now) > fullest:
                # the packs as the culled stage hands them to K1 (float32)
                fullest = len(now)
                nbr, valid, src, recv = sorted_inputs(ins.engine, ins.state)
                form = (nbr.clone(), valid.clone(), src.float(),
                        recv.float())
    wall = time.perf_counter() - t0
    pos = np.array([p[2:] for p in rec.pushes], dtype=float)
    replayed = [sum(n) for n in zip(*(ins.engine.graph_launches()
                                      for ins in cs.intersections))]
    return {"steps": steps, "riders": len(demand),
            "done": fake.simulation.getMinExpectedNumber() == 0,
            "left_inside": sum(len(v) for v in inside.values()),
            "pushes": [p[:2] for p in rec.pushes], "positions": pos,
            "handovers": handovers, "occupied": occupied[0],
            "replayed_launches": replayed,
            "captures": sum(len(ins.engine._runners)
                            for ins in cs.intersections),
            "fullest_junction": fullest, "wall_s": wall, "clock_s": clock,
            "finite": bool(np.isfinite(pos).all() and all(
                torch.isfinite(ins.state.s).all()
                for ins in cs.intersections)),
            "route_junctions": {
                vid: sorted(net.edges[e].to_node for e in route[:-1])
                for vid, route, *_ in demand},
            "form": form}


def phase_sumo():
    """The sumo path on the card: every count set to 0 just before the
    run; K1 launched once per (junction, step) that held a rider (each
    junction's captured step replayed, its replays counted by its engine)
    and once more per junction by the capture's warm-up (counted by the
    wrapper), no K2 or K3; every rider handed over at both junctions of
    its route and back, and finished; finite states and pushes. Then K1's
    form there (mixed, tile screen, block 64) against its plain version
    on the fullest junction's packs. Returns (K1's replayed and warm-up
    launches, the run, the form's numbers)."""
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    k1, k2, k3 = PF.KERNELS
    PF.reset_launches()
    run = run_sumo("cuda", keep_form=True)
    names = [fn.__name__ for fn in PF.KERNELS]
    warm_up = dict(zip(names, PF.launch_counts()))
    counts = dict(zip(names, run["replayed_launches"]))
    missing = [vid for vid, junctions in run["route_junctions"].items()
               if sorted(run["handovers"][vid]) != junctions
               or any(e is None for _, e in run["handovers"][vid].values())]
    per_step = {k: 1e3 * v / run["steps"] for k, v in run["clock_s"].items()}
    emit("sumo", net=SUMO_NET, riders=run["riders"], steps=run["steps"],
         cut=run["steps"] >= SUMO_MAX_STEPS, max_steps=SUMO_MAX_STEPS,
         capacity=SUMO_CAPACITY, neighbors=SUMO_NEIGHBORS,
         all_finished=run["done"], left_inside=run["left_inside"],
         junction_steps_with_riders=run["occupied"],
         kernel_launches=counts, warm_up_launches=warm_up,
         captures=run["captures"], pushes=len(run["pushes"]),
         fullest_junction=run["fullest_junction"], finite=run["finite"],
         riders_missing_a_handover=missing, wall_s=run["wall_s"],
         ms_per_step=1e3 * run["wall_s"] / run["steps"],
         ms_per_step_parts=per_step,
         engine_ms_per_junction_step=(1e3 * run["clock_s"]["engine"]
                                      / max(run["occupied"], 1)))
    if counts != {k1.__name__: run["occupied"], k2.__name__: 0,
                  k3.__name__: 0} or warm_up != {
                      k1.__name__: run["captures"], k2.__name__: 0,
                      k3.__name__: 0}:
        raise AssertionError(
            f"sumo: expected {run['occupied']} replayed and "
            f"{run['captures']} warm-up K1 launches and none of K2 or K3, "
            f"counted {counts} and {warm_up}")
    if not (run["done"] and run["left_inside"] == 0 and not missing
            and run["finite"]):
        raise AssertionError(
            f"sumo: finished {run['done']}, {run['left_inside']} riders "
            f"left inside, {len(missing)} riders without both handovers, "
            f"finite {run['finite']}")
    kw = dict(block=SUMO_NEIGHBORS["block"],
              block_src=SUMO_NEIGHBORS["block_src"], mixed=True, screen=True,
              cutoff=SUMO_NEIGHBORS["cutoff"])
    form = check_form("kernel_forms", "k1_mixed_screen_sumo", k1,
                      run.pop("form"), kw, kw)
    return (counts[k1.__name__], warm_up[k1.__name__]), run, form


def phase_block64_mixed(state):
    """K1's mixed form with the tile screen at receiver block 64 (the sumo
    path's form: block_src 32, cutoff 100 m) on the legacy field of the
    N_AGENTS crowd, kb from the audit, against its plain version."""
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    engine = audited_engine(make_legacy_engine, "legacy block 64", state,
                            block=SUMO_NEIGHBORS["block"],
                            block_src=SUMO_NEIGHBORS["block_src"])
    kw = dict(block=SUMO_NEIGHBORS["block"],
              block_src=SUMO_NEIGHBORS["block_src"], mixed=True, screen=True,
              cutoff=LEG_CUTOFF)
    return check_form("kernel_forms", "k1_mixed_screen_block64", PF.KERNELS[0],
                      sorted_inputs(engine, state), kw, kw)


def compare_sumo(card, cpu):
    """The sumo run on the card against the CPU's (float64, the pair stage
    in float32): the same riders enter and leave the same junctions, each
    handover within one step (how many are equal is reported), and the
    pushed positions of the (step, rider) pairs both made within
    `parity`'s two tiers."""
    import numpy as np

    diffs, keys_differ = [], []
    for vid, junctions in card["handovers"].items():
        other = cpu["handovers"][vid]
        if sorted(junctions) != sorted(other):
            keys_differ.append(vid)
            continue
        for j, steps in junctions.items():
            diffs += [abs(a - b) for a, b in zip(steps, other[j])]
    diffs = np.asarray(diffs)
    at = {key: i for i, key in enumerate(cpu["pushes"])}
    both = [(i, at[key]) for i, key in enumerate(card["pushes"])
            if key in at]
    a = card["positions"][[i for i, _ in both]]
    b = cpu["positions"][[j for _, j in both]]
    err = np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    n_over = int((err > PARITY_TOL["pos"]).sum())
    ok = bool(not keys_differ and diffs.max() <= 1
              and n_over <= (1.0 - PARITY_QUANTILE) * err.size
              and err.max() <= PARITY_CAP["pos"])
    emit("sumo_parity", runs="card (K1 float32 pairs, float64 state) vs CPU "
         "float64 with float32 pairs", steps={"card": card["steps"],
                                             "cpu": cpu["steps"]},
         handovers=int(diffs.size), handovers_equal=int((diffs == 0).sum()),
         handovers_one_step_apart=int((diffs == 1).sum()),
         max_handover_step_diff=int(diffs.max()),
         riders_with_other_junctions=keys_differ,
         pushes_compared=len(both),
         pushes_unmatched={"card": len(card["pushes"]) - len(both),
                           "cpu": len(cpu["pushes"]) - len(both)},
         pos_max=float(err.max()), pos_p99_9=float(np.quantile(err, 0.999)),
         n_over_tol=n_over, tol=PARITY_TOL["pos"], cap=PARITY_CAP["pos"],
         cpu_run_s=cpu["wall_s"], ok=ok)
    if not ok:
        raise AssertionError("sumo_parity failed")


def calibration_tracks(device):
    """CAL_TRACKS tracks of CAL_STEPS steps made by the port's bicycle2d at
    k_p_v = CAL_TRUTH on `device` in float64, with the inputs and initial
    states of demos/demo_calibration.py's `synth_tracks` (numpy seeded)."""
    import numpy as np

    from cyclistsocialforce_tpu_torch.calibration import (Calibration,
                                                          CalibrationData)
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    n, steps = CAL_TRACKS, CAL_STEPS
    rng = np.random.default_rng(0)
    s0 = np.zeros((n, 5))
    s0[:, 2] = rng.uniform(-0.4, 0.4, n)
    s0[:, 3] = rng.uniform(2.0, 5.0, n)
    t = np.arange(steps) * 0.01
    fx = 3.5 + np.sin(2 * np.pi * 0.25 * t)[None, :] \
        + rng.normal(0, 0.1, (n, 1))
    fy = np.sin(2 * np.pi * 0.2 * t + rng.uniform(0, np.pi, (n, 1)))
    inputs = np.stack([fx * np.ones((n, steps)), fy], axis=2)
    lengths = np.full((n,), steps, dtype=np.int32)
    blank = CalibrationData(s0, inputs, np.zeros((n, steps, 2)), lengths)
    truth = Calibration(MODELS["bicycle2d"],
                        BicycleParams.create(k_p_v=CAL_TRUTH), ["k_p_v"],
                        blank, fix_speed=False, verbose=False, device=device)
    obs = truth.simulate(truth.params, blank).cpu().numpy()
    return CalibrationData(s0, inputs, obs, lengths)


def calibration_of(data, device, test=None):
    from cyclistsocialforce_tpu_torch.calibration import Calibration
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams

    return Calibration(MODELS["bicycle2d"], BicycleParams.create(),
                       ["k_p_v"], data, test_data=test,
                       objective_features=(0, 1), fix_speed=False,
                       maxiter=CAL_MAXITER, verbose=False, device=device)


def calibration_check(data, device):
    """What the CPU is held to: the replay of `data` at the truth and one
    objective off it."""
    cal = calibration_of(data, device)
    out = cal.simulate(cal.params.replace(k_p_v=CAL_TRUTH), data)
    return {"outputs": out.cpu().numpy(), "objective": cal.objective([7.0])}


def phase_calibration():
    """The calibration on the card: the tracks, the first objective (its
    replay captured as a CUDA graph), one objective's seconds, `run` from
    CAL_GUESS, the test error, and the batch of CAL_TRACKS candidates over
    every track (one replay of CAL_TRACKS^2 riders) held to the
    per-candidate objective; returns the CAL_CPU tracks and the card's
    numbers for the CPU check."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.calibration import CalibrationData

    t0 = time.perf_counter()
    data = calibration_tracks("cuda")
    make_s = time.perf_counter() - t0
    train, test = data.split(CAL_SPLIT, rng=np.random.default_rng(1))
    cal = calibration_of(train, "cuda", test)
    t0 = time.perf_counter()
    cal.objective([CAL_GUESS])
    first_s = time.perf_counter() - t0
    times = []
    for v in np.linspace(5.0, 9.0, 9):
        t0 = time.perf_counter()
        cal.objective([v])
        times.append(time.perf_counter() - t0)
    # the same replay eager (`simulate`, no graph), for comparison
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal.simulate(cal.params.replace(k_p_v=CAL_GUESS), train)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xopt, res = cal.run([CAL_GUESS])
    run_s = time.perf_counter() - t0
    test_err = cal.test()
    full = calibration_of(data, "cuda")
    cands = np.linspace(6.0, 14.0, CAL_TRACKS)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = full.evaluate_population(cands)
    batch_s = time.perf_counter() - t0
    pick = np.linspace(0, CAL_TRACKS - 1, CAL_CHECK).astype(int)
    singles = np.array([full.objective(cands[i]) for i in pick])
    rel = np.abs(errs[pick] - singles) / np.abs(singles)
    ok = bool(abs(xopt[0] - CAL_TRUTH) < CAL_TOL and rel.max() <= 1e-12
              and np.isfinite(errs).all())
    emit("calibration", tracks=CAL_TRACKS, steps=CAL_STEPS,
         train=len(train), test=len(test), make_tracks_s=make_s,
         first_objective_s=first_s, objective_s=statistics.median(times),
         objective_graphed=cal._replays[id(train)].graph is not None,
         eager_replay_s=eager_s,
         run_s=run_s, x=float(xopt[0]), truth=CAL_TRUTH, tol=CAL_TOL,
         iters=res["iters"], calls=res["calls"], error=res["error"],
         test_error=test_err, batch_riders=CAL_TRACKS * CAL_TRACKS,
         batch_s=batch_s, batch_vs_objective_max_rel=float(rel.max()),
         batch_argmin_k_p_v=float(cands[np.argmin(errs), 0]), ok=ok)
    if not ok:
        raise AssertionError("calibration failed")
    sub = CalibrationData(data.s0[:CAL_CPU], data.inputs[:CAL_CPU],
                          data.objectives[:CAL_CPU], data.lengths[:CAL_CPU])
    return sub, calibration_check(sub, "cuda")


def compare_calibration(card, cpu):
    import numpy as np

    a, b = card["outputs"], cpu["outputs"]
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    rel_obj = abs(card["objective"] - cpu["objective"]) / abs(cpu["objective"])
    emit("calibration_parity", tracks=CAL_CPU, steps=CAL_STEPS,
         outputs_max_rel=rel, objective_rel=rel_obj, tol=1e-10)
    if not (rel <= 1e-10 and rel_obj <= 1e-10):
        raise AssertionError("calibration_parity failed")


def gmm_samples():
    """GMM_SAMPLES raw ImRe5GivenV feature rows drawn from the packaged
    GMM_MODEL at speeds spread evenly over 1.5-5.5 m/s (numpy seeded)."""
    import numpy as np

    from cyclistsocialforce_tpu_torch.behavior import load_packaged_polemodel

    pm = load_packaged_polemodel(GMM_MODEL)
    rng = np.random.default_rng(GMM_SEED)
    v = np.linspace(1.5, 5.5, GMM_SAMPLES)
    return np.array([np.r_[vi, pm.sample_pole_features(1, v=vi,
                                                       rng=rng)[0][0]]
                     for vi in v])


def fit_gmm_model(device):
    """`fit_pole_model` of `gmm_samples()` on `device` at the packaged BR1
    fit's size; its selected hyperparameters (read from the grid search it
    runs), the mixture and the seconds."""
    import numpy as np

    from cyclistsocialforce_tpu_torch import behavior, gmm_fit

    seen = {}
    grid_search = gmm_fit.fit_optimize

    def recorded(*args, **kw):
        gmm, info = grid_search(*args, **kw)
        seen.update(info)
        return gmm, info

    X = gmm_samples()
    gmm_fit.fit_optimize = recorded
    try:
        t0 = time.perf_counter()
        pm = behavior.fit_pole_model(
            X, "ImRe5GivenV", range_components=(1, 5),
            covariance_types=gmm_fit.COVARIANCE_TYPES, k_crossval=GMM_FOLDS,
            n_init=GMM_INIT, seed=GMM_SEED, device=device)
        seconds = time.perf_counter() - t0
    finally:
        gmm_fit.fit_optimize = grid_search
    return {"hyperparameters": seen["hyperparameters"],
            "fits": len(seen["gridsearch"]) * GMM_FOLDS + 1,
            "means": np.asarray(pm.gmm.means),
            "weights": np.asarray(pm.gmm.weights),
            "scores_val": seen["scores_val"], "seconds": seconds}


def phase_gmm_fit():
    out = fit_gmm_model("cuda")
    emit("gmm_fit", samples=GMM_SAMPLES, folds=GMM_FOLDS, n_init=GMM_INIT,
         fits=out["fits"], seconds=out["seconds"],
         hyperparameters=out["hyperparameters"],
         scores_val=out["scores_val"])
    return out


def compare_gmm_fit(card, cpu):
    """The same hyperparameters as the CPU's fit, the best model's means
    within 1e-8 (matched component by component: a tie between restarts
    may order them otherwise)."""
    import numpy as np

    same = card["hyperparameters"] == cpu["hyperparameters"]
    err = None
    if same:
        order = [int(np.argmin(np.abs(cpu["means"] - m).sum(axis=1)))
                 for m in card["means"]]
        err = float(np.abs(card["means"] - cpu["means"][order]).max()) \
            if sorted(order) == list(range(len(order))) else math.inf
    emit("gmm_fit_parity", card=card["hyperparameters"],
         cpu=cpu["hyperparameters"], means_max_abs=err, tol=1e-8,
         cpu_seconds=cpu["seconds"])
    if not (same and err <= 1e-8):
        raise AssertionError("gmm_fit_parity failed")


def field_case(device):
    """eval_force_field of a FIELD_N-rider crowd (the twod field) over a
    FIELD_GRID x FIELD_GRID grid over its extent, in float64 on
    `device`."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population
    from cyclistsocialforce_tpu_torch.viz import eval_force_field

    st = build_population(FIELD_N, DENSITY, HIST_LEN, None, torch.float64,
                          device)
    xy = st.s[:, :2].cpu().numpy()
    lo, hi = xy.min(axis=0) - 5.0, xy.max(axis=0) + 5.0
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], FIELD_GRID),
                         np.linspace(lo[1], hi[1], FIELD_GRID))
    t0 = time.perf_counter()
    fx, fy = eval_force_field(gx, gy, engine=make_engine(), state=st,
                              psi_recv=0.3)
    return {"fx": fx, "fy": fy, "seconds": time.perf_counter() - t0}


def phase_viz_fields(state):
    """density_map of the N_AGENTS crowd on the card (positions in
    float64) against numpy.histogram2d, cell for cell; the card's
    eval_force_field (compared with the CPU's at the end); matplotlib
    never imported."""
    import numpy as np
    import torch

    from cyclistsocialforce_tpu_torch.viz import density_map

    act = state.active.cpu().numpy()
    xy = state.s[:, :2].double().cpu().numpy()[act]
    xlim = (float(xy[:, 0].min()), float(xy[:, 0].max()))
    ylim = (float(xy[:, 1].min()), float(xy[:, 1].max()))
    s = state.s.double()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H, _ = density_map(s[:, 0], s[:, 1], xlim, ylim, bins=DENSITY_BINS,
                       active=state.active)
    density_s = time.perf_counter() - t0
    want, _, _ = np.histogram2d(xy[:, 0], xy[:, 1], bins=DENSITY_BINS,
                                range=[xlim, ylim])
    n_diff = int((H != want.T).sum())
    field = field_case("cuda")
    ok = bool(n_diff == 0 and H.sum() == act.sum()
              and "matplotlib" not in sys.modules)
    emit("viz_fields", density_bins=DENSITY_BINS, riders=int(act.sum()),
         counted=float(H.sum()), cells_differing=n_diff,
         density_s=density_s, field_riders=FIELD_N,
         field_points=FIELD_GRID * FIELD_GRID,
         field_s=field["seconds"],
         matplotlib_imported="matplotlib" in sys.modules, ok=ok)
    if not ok:
        raise AssertionError("viz_fields failed")
    return field


def compare_field(card, cpu):
    import numpy as np

    scale = max(np.abs(cpu["fx"]).max(), np.abs(cpu["fy"]).max())
    rel = max(np.abs(card["fx"] - cpu["fx"]).max(),
              np.abs(card["fy"] - cpu["fy"]).max()) / scale
    emit("viz_fields_parity", max_rel=float(rel), tol=FIELD_RTOL,
         cpu_seconds=cpu["seconds"], card_seconds=card["seconds"],
         matplotlib_imported="matplotlib" in sys.modules)
    if not (rel <= FIELD_RTOL and "matplotlib" not in sys.modules):
        raise AssertionError("viz_fields_parity failed")


# ---- the sharded schedules and the demos ----


def sharded_final(engine, state, mesh, comm, steps, halo=None,
                  timing=False):
    """`steps` steps of `state` over `mesh` (`parallel.sharding`) by
    schedule `comm`: (the gathered final state, the halo overflow flag or
    None, wall seconds, seconds in the collectives or None). The shards
    are made before the clock starts."""
    import torch

    from cyclistsocialforce_tpu_torch import parallel as P

    kw = {"halo": halo} if comm == "halo" else {}
    run = P.sharded_simulate_fn(engine, mesh, steps, comm=comm, **kw)
    shards = P.shard_state(state, mesh)
    torch.cuda.synchronize()
    mesh.timing = [] if timing else None
    t0 = time.perf_counter()
    final, extra = run(shards)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    coll = mesh.collective_seconds() if timing else None
    mesh.timing = None
    return (P.gather_state(final, mesh),
            bool(extra) if comm == "halo" else None, seconds, coll)


def audit_sharded(engine, state, mesh, tag):
    """No shard's table (local cell sort against the gathered source
    blocks) overflows kb."""
    from cyclistsocialforce_tpu_torch import parallel as P
    from cyclistsocialforce_tpu_torch.parallel import sharding as S

    caches = S._neighbor_cache_sharded(engine, mesh,
                                       P.shard_state(state, mesh))
    n_over = sum(int(c[3].sum()) for c in caches)
    most = max(int(c[2].sum(dim=1).max()) for c in caches)
    emit("audit", at=tag, max_in_range_blocks=most, kb=engine.neighbors.kb,
         overflow_blocks=n_over)
    if n_over:
        raise AssertionError(f"sharded table overflow at {tag}: {n_over} "
                             f"receiver blocks exceed kb")
    return most


def sharded_engine(make, state, mesh, tag):
    """`make(kb=...)` with kb the sharded tables' in-range maximum at t = 0
    (counted with a table of every source block) plus SHARDED_KB_MARGIN,
    and no less than the main path's KB."""
    most = audit_sharded(make(kb=state.n // BLOCK_SRC), state, mesh,
                         f"{tag} probe t=0")
    return make(kb=min(max(KB, most + SHARDED_KB_MARGIN),
                       state.n // BLOCK_SRC))


def strips(state):
    """`state` with its rows ordered by x, so that shard d of SHARDS holds
    the d-th vertical strip of the domain, as a domain decomposition
    assigns regions to shards. The rows of a random crowd lie in random
    places: a shard of them spreads over the whole domain, its blocks'
    boxes reach four times the source blocks the single-device table's
    do, and kb 19 overflows in every receiver block. (Strips cut from the
    table's serpentine cell order start and end inside a cell column,
    which the shard's own cell sort splits into blocks hundreds of metres
    tall: 86 in-range source blocks at the main path's size.)"""
    import torch

    from cyclistsocialforce_tpu_torch.engine import permute_state

    return permute_state(state, torch.argsort(state.s[:, 0], stable=True))


def fields_equal(a, b):
    import dataclasses

    import torch

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def sharded_schedule(phase, engine, state, mesh, comm, halo=None,
                     shards=SHARDS):
    """One schedule: the parity run (PARITY_STEPS steps against the
    single-device run under both tiers), then N_STEPS steps with every
    launch count set to 0 just before, K1 the only kernel, launched
    exactly once per shard and step (the ring: per shard, hop and step),
    no overflow at either end, ms per step and the collectives' share.
    Returns (K1 launches, the final state)."""
    import torch

    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    names = [fn.__name__ for fn in PF.KERNELS]
    ref = card_final(engine, state)
    got, ovf, _, _ = sharded_final(engine, state, mesh, comm, PARITY_STEPS,
                                   halo)
    diff = float((got.s.double() - ref.s.double()).abs().max())
    compare_runs(f"{phase}_parity", got, ref, comm=comm, shards=shards,
                 max_abs_state_diff=diff, bit_equal=fields_equal(got, ref),
                 halo=halo, halo_overflow=ovf)
    if comm != "halo":
        audit_sharded(engine, state, mesh, f"{phase} t=0")
    PF.reset_launches()
    final, ovf, seconds, coll = sharded_final(engine, state, mesh, comm,
                                              N_STEPS, halo, timing=True)
    counts = dict(zip(names, PF.launch_counts()))
    per_step = shards * (shards if comm == "ring" else 1)
    want = {n: N_STEPS * per_step * (n == names[0]) for n in names}
    finite = bool(torch.isfinite(final.s).all())
    emit(phase, comm=comm, shards=shards, rows=state.n, steps=N_STEPS,
         halo=halo, kernel_launches=counts, expected_launches=want,
         finite=finite, halo_overflow=ovf, seconds=seconds,
         ms_per_step=1e3 * seconds / N_STEPS,
         collective_ms_per_step=1e3 * coll / N_STEPS,
         collective_share=coll / seconds)
    if counts != want:
        raise AssertionError(f"{phase}: expected {want} launches, counted "
                             f"{counts}")
    if not finite:
        raise AssertionError(f"{phase}: non-finite state after the run")
    if ovf:
        raise AssertionError(f"{phase}: the halo window overflowed")
    if comm != "halo":
        audit_sharded(engine, final, mesh, f"{phase} t=end")
    return counts[names[0]], final


def sharded_forms(engine, state, mesh, halo):
    """K1 against its plain version on the inputs the sharded schedules
    hand it at t = 0 (`kernel_forms`' k1_sharded_*): shard 0's table
    against the gathered source pack (allgather); the ring hop whose raw
    mask has the most holes (invalid slots before a valid one), its table
    compacted (`sharding.hop_table`), with its resident shard's pack; an
    interior shard's compacted halo-window table with its window's source
    pack (halo). The raw hop mask's plain forces are held to the
    compacted table's under the form tolerance, and whether they are
    bit-equal is reported."""
    import torch

    from cyclistsocialforce_tpu_torch import engine as eng
    from cyclistsocialforce_tpu_torch import parallel as P
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.parallel import sharding as S

    k1 = PF.KERNELS[0]
    cfg = engine.neighbors
    kw = dict(block=cfg.block, block_src=cfg.block_src,
              uniform=engine.uniform_pair, fov=not engine.full_fov,
              screen=cfg.screen, sub=cfg.sub, cutoff=cfg.cutoff)
    shards = P.shard_state(state, mesh)
    nl, size = shards[0].n, mesh.n_shards
    bl_src = nl // cfg.block_src
    caches = S._neighbor_cache_sharded(engine, mesh, shards)
    packs = [eng.sorted_packs(engine.pack_pair_fields(st, nl)[0], c[0])
             for st, c in zip(shards, caches)]
    src_glob = mesh.all_gather([p[0] for p in packs])
    forms = {"k1_sharded_allgather": check_form(
        "kernel_forms", "k1_sharded_allgather", k1,
        (caches[0][1], caches[0][2], src_glob, packs[0][1]), kw, kw)}

    def holes(valid):
        after = torch.flip(torch.cummax(torch.flip(valid.int(), [1]),
                                        1).values, [1]).bool()
        return int((after & ~valid).sum())

    hops = []
    for j in range(size):
        for hop in range(size):
            lo = ((j - hop) % size) * bl_src
            nbr, valid = caches[j][1], caches[j][2]
            raw = valid & (nbr >= lo) & (nbr < lo + bl_src)
            hops.append((holes(raw), int(raw.sum()), j, hop, lo))
    n_holes, n_valid, j, hop, lo = max(hops)
    nbr, valid = caches[j][1], caches[j][2]
    raw = valid & (nbr >= lo) & (nbr < lo + bl_src)
    resident = packs[(j - hop) % size][0]
    hop_t = (*S.hop_table(caches[j], lo, bl_src)[:2], resident, packs[j][1])
    plain_raw = PF.pair_forces_neighbors_ref(
        torch.where(raw, nbr - lo, 0), raw, resident, packs[j][1], **kw)
    plain_compact = PF.pair_forces_neighbors_ref(*hop_t, **kw)
    raw_err = float((plain_raw - plain_compact).abs().max())
    emit("kernel_forms", form="k1_sharded_ring_hop", shard=j, hop=hop,
         holes=n_holes, valid_entries=n_valid,
         plain_raw_mask_max_abs_diff=raw_err,
         plain_raw_mask_bit_equal=bool(torch.equal(plain_raw,
                                                   plain_compact)))
    if (plain_raw - plain_compact).abs().gt(
            KERNEL_ATOL + KERNEL_RTOL * plain_compact.abs()).any():
        raise AssertionError(f"k1_sharded_ring_hop: the plain version on "
                             f"the raw mask differs from the compacted "
                             f"table's by {raw_err:.3e}")
    forms["k1_sharded_ring_hop"] = check_form(
        "kernel_forms", "k1_sharded_ring_hop", k1, hop_t, kw, kw)
    idents = [d * nl + torch.arange(nl, device=st.device)
              for d, st in zip(mesh.shards, shards)]
    sts, _ = S._global_reshard(engine, mesh, shards, idents,
                               from_original=True)
    inner = 1 if size > 2 else 0
    c = S._neighbor_cache_halo(engine, mesh, sts, halo)[inner]
    src_ext, recv = S.halo_packs(engine, mesh, sts, halo)[inner]
    forms["k1_sharded_halo"] = check_form(
        "kernel_forms", "k1_sharded_halo", k1, (c[0], c[1], src_ext, recv),
        kw, kw)
    return forms


def phase_sharded(state):
    """The culled allgather, ring and halo schedules of the main path over
    SHARDS shards on the card, then the mixed two-family crowd's
    allgather (see SHARDS). Returns ({path: (K1 launches, None)}, the
    allgather run's final state, the sharded engine's kb, K1's forms on
    the sharded schedules' inputs (`sharded_forms`))."""
    import torch

    from cyclistsocialforce_tpu_torch import parallel as P

    mesh = P.make_mesh(SHARDS, device="cuda")
    engine = sharded_engine(make_engine, state, mesh, "sharded")
    need = P.required_halo(engine, state, SHARDS)
    halo = need + 1
    emit("sharded_halo", at="t=0", required_halo=need, halo=halo,
         strip_src_blocks=state.n // SHARDS // BLOCK_SRC)
    forms = sharded_forms(engine, state, mesh, halo)
    launches, finals = {}, {}
    for comm in SHARDED_COMMS:
        launches[f"sharded_{comm}"], finals[comm] = sharded_schedule(
            f"sharded_{comm}", engine, state, mesh, comm,
            halo if comm == "halo" else None)
    need_end = P.required_halo(engine, finals["halo"], SHARDS)
    emit("sharded_halo", at="t=end", required_halo=need_end, halo=halo)
    if need_end >= halo:
        raise AssertionError(f"sharded_halo: the crowd needs a halo of "
                             f"{need_end} at t=end, the run had {halo}")
    n_mixed = 2 * PARITY_MIXED_HALF
    mixed_state = twod_crowd(n_mixed, torch.float64, "cuda", None)
    # group membership is a row range of the single-device MixedEngine,
    # so its rows stay in their random order, and every pair is in range
    # (SHARDED_MIXED_CUTOFF): the shards' block partition then changes
    # only the order of the sums
    mixed = make_mixed_engine(n_mixed, cutoff=SHARDED_MIXED_CUTOFF,
                              kb=n_mixed // BLOCK_SRC)
    launches["sharded_mixed"], _ = sharded_schedule(
        "sharded_mixed", mixed, mixed_state, mesh, "allgather")
    return ({k: (v, None) for k, v in launches.items()},
            finals["allgather"], engine.neighbors.kb, forms)


def phase_sharded_group(state, want, kb):
    """The allgather run of `phase_sharded` over a one-rank NCCL process
    group made in this process and holding all SHARDS shards: the
    collectives go through NCCL; bit-equal to the run without a group."""
    import torch.distributed as dist

    from cyclistsocialforce_tpu_torch import parallel as P
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    engine = make_engine(kb=kb)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = P.make_mesh(SHARDS, group=dist.group.WORLD, device="cuda")
        PF.reset_launches()
        final, _, seconds, coll = sharded_final(engine, state, mesh,
                                                "allgather", N_STEPS,
                                                timing=True)
        k1 = PF.launch_counts()[0]
    finally:
        dist.destroy_process_group()
    equal = fields_equal(final, want)
    emit("sharded_group", backend="nccl", world_size=1, shards=SHARDS,
         steps=N_STEPS, k1_launches=k1, bit_equal_to_in_process=equal,
         ms_per_step=1e3 * seconds / N_STEPS,
         collective_share=coll / seconds)
    if not equal:
        raise AssertionError("sharded_group: the NCCL group's run differs "
                             "from the in-process mesh's")
    return k1, None


def phase_demos():
    """Every demo that needs no plotting library, side by side, each a
    process `python -m cyclistsocialforce_tpu_torch.demos.<name> ...
    --device cuda` from the checkout; each must exit 0 and print its
    line. Every process still running at the end is killed."""
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(root), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    t0 = time.perf_counter()
    try:
        for key, (args, _) in DEMOS.items():
            procs[key] = subprocess.Popen(
                [sys.executable, "-m",
                 f"cyclistsocialforce_tpu_torch.demos.{key.split()[0]}",
                 *args, "--device", "cuda"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=str(root), env=env)
        outs = {key: p.communicate(timeout=DEMO_TIMEOUT)[0]
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [key for key, p in procs.items()
              if p.returncode != 0 or DEMOS[key][1] not in outs[key]]
    emit("demos", ran=list(DEMOS), left_out=DEMOS_LEFT_OUT,
         seconds=time.perf_counter() - t0,
         returncodes={k: p.returncode for k, p in procs.items()},
         last_lines={k: outs[k].strip().splitlines()[-1:]
                     for k in DEMOS}, failed=failed)
    if failed:
        raise AssertionError("demos failed: " + "; ".join(
            f"{k}: {outs[k][-1500:]}" for k in failed))


def parity_errors(a, b):
    """Per-quantity error summary of final states `a` and `b`, and the
    list of checks that failed (see PARITY_TOL)."""
    import torch

    g, c = a.s.double().cpu(), b.s.double().cpu()

    def wrapped(d):
        return (torch.remainder(d + math.pi, 2 * math.pi) - math.pi).abs()

    per_agent = {"pos": torch.hypot(g[:, 0] - c[:, 0], g[:, 1] - c[:, 1]),
                 "psi": wrapped(g[:, 2] - c[:, 2]),
                 "v": (g[:, 3] - c[:, 3]).abs(),
                 "delta": wrapped(g[:, 4] - c[:, 4])}
    out = {"max": {}, "p99.9": {}, "n_over_tol": {}, "failed": []}
    n = g.shape[0]
    for k, e in per_agent.items():
        n_over = int((e > PARITY_TOL[k]).sum())
        out["max"][k] = float(e.max())
        out["p99.9"][k] = float(e.quantile(0.999))
        out["n_over_tol"][k] = n_over
        if n_over > (1.0 - PARITY_QUANTILE) * n or not e.max() <= \
                PARITY_CAP[k]:
            out["failed"].append(k)
    for f in ("znav", "destpointer"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            out["failed"].append(f)
    out.update(tol=PARITY_TOL, cap=PARITY_CAP, quantile=PARITY_QUANTILE)
    return out


def main():
    # Kineto's warnings (lost activity records among them) on stderr,
    # where `traced_pair_kernels` reads them; set before torch loads it
    os.environ.setdefault("KINETO_LOG_LEVEL", str(KINETO_WARNING))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from cyclistsocialforce_tpu_torch.ops import _build
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t_start = t0 = time.perf_counter()
    lib = _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=lib._name)

    engine = make_engine()
    state = build_population(N_AGENTS, DENSITY, HIST_LEN, BLOCK,
                             torch.float32, "cuda")
    db_engine = phase_db_config(state)
    leg_engine, leg_db_engine = phase_legacy_config(state)
    twod_engine = make_twod_engine()
    twod_state = twod_crowd(N_AGENTS, torch.float32, "cuda")
    ip_engine = make_model_engine("invpendulum", ip_params())
    ip_state = model_crowd("invpendulum", ip_params(), N_AGENTS,
                           torch.float32, "cuda")
    br_engine = make_model_engine("balancingrider", br_params())
    br_state = model_crowd("balancingrider", br_params(), N_AGENTS,
                           torch.float32, "cuda", hist_len=HIST_LEN)
    stoch_engine, stoch_state = stochastic_path("stochastic")
    exact_engine, exact_state = stochastic_path("stochastic_exact")
    mixed_state = twod_crowd(N_AGENTS, torch.float32, "cuda", pad=None)
    mixed_engine = audited_engine(
        lambda **kw: make_mixed_engine(N_AGENTS, **kw), "slice_mixed",
        mixed_state)
    n_mixed = 2 * PARITY_MIXED_HALF
    parity_mixed_state = twod_crowd(n_mixed, torch.float32, "cuda", None)
    parity_mixed_engine = audited_engine(
        lambda **kw: make_mixed_engine(n_mixed, **kw), "parity_mixed",
        parity_mixed_state)
    scr_engine = scripted_engine(state)
    kaths_state = kaths_crowd(N_AGENTS, torch.float32, "cuda")
    kaths_engine = audited_engine(make_kaths_engine, "slice_kaths",
                                  kaths_state)
    seconds = {}

    def timed(label, fn, *args):
        """fn(*args), its wall seconds kept under `label`."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t
        return out

    kernel = timed("kernel", phase_kernel, engine, state)
    forms, vs_k1 = timed("kernel_forms", phase_kernel_forms, engine,
                         db_engine, state)
    mixed_forms, mixed_vs_k1 = timed("kernel_forms", phase_mixed_forms,
                                     leg_engine, leg_db_engine, state)
    forms.update(mixed_forms)
    forms.update(timed("kernel_forms", phase_block_forms, state))
    forms["k1_mixed_screen_block64"] = timed("kernel_forms",
                                             phase_block64_mixed, state)
    # K1's column form on slice_scripted's own packs
    forms["k1_columns_scripted"] = timed(
        "kernel_forms", check_form, "kernel_forms", "k1_columns_scripted",
        PF.pair_forces_neighbors, sorted_inputs(scr_engine, state),
        dict(block=BLOCK, block_src=BLOCK_SRC), dict(block=BLOCK,
                                                     block_src=BLOCK_SRC))
    vs_k1.update(mixed_vs_k1)
    fsm_state = fsm_crowd(state)
    # the twod case's crowd, run TWOD_WARM steps by an engine of its own
    # (slice_twod's must not have captured before its phase)
    twod_warm, _ = make_twod_engine().simulate(with_queues(twod_state),
                                               TWOD_WARM, record=False)
    agent = timed("agent_step", phase_agent_step, {
        "twod": (engine, state), "legacy": (leg_engine, state),
        "columns": (db_engine, state), "twod_fsm": (engine, fsm_state),
        "legacy_fsm": (leg_engine, fsm_state),
        "whipple": (br_engine, br_state),
        "twod_spline": (twod_engine, twod_warm)})
    del fsm_state, twod_warm
    paths = {"slice": (engine, state),
             "slice_unrolled": (make_engine(backend="pallas_unrolled"),
                                state),
             "slice_db": (db_engine, state),
             "slice_legacy": (leg_engine, state),
             "slice_twod": (twod_engine, twod_state),
             "slice_mixed": (mixed_engine, mixed_state),
             "slice_invpendulum": (ip_engine, ip_state),
             "slice_balancingrider": (br_engine, br_state),
             "slice_stochastic": (stoch_engine, stoch_state),
             "slice_stochastic_exact": (exact_engine, exact_state),
             "slice_scripted": (scr_engine, state),
             "slice_kaths": (kaths_engine, kaths_state)}
    k1, k2, k3 = PF.KERNELS
    kernel_of = {"slice": k1, "slice_unrolled": k2, "slice_db": k3,
                 "slice_legacy": k1, "slice_twod": k1, "slice_mixed": k1,
                 "slice_invpendulum": k1, "slice_balancingrider": k1,
                 "slice_stochastic": k1, "slice_stochastic_exact": k1,
                 "slice_scripted": k1, "slice_kaths": None}

    def stochastic_report(engine, state):
        return lambda final: {**fallen_share(final),
                              **resample_stats(engine, state)}

    def scripted_report(final):
        """Hold after the run; replay after PARITY_STEPS graphed steps."""
        replay, _ = scr_engine.simulate(state, PARITY_STEPS, record=False)
        return {"hold": scripts_followed(scr_engine, state, final, N_STEPS),
                "replay": scripts_followed(scr_engine, state, replay,
                                           PARITY_STEPS)}

    reports = {"slice_balancingrider": fallen_share,
               "slice_stochastic": stochastic_report(stoch_engine,
                                                     stoch_state),
               "slice_stochastic_exact": stochastic_report(exact_engine,
                                                           exact_state),
               "slice_scripted": scripted_report,
               "slice_kaths": kaths_report(kaths_engine, kaths_state)}
    launches = {path: timed(path, phase_slice, path, *paths[path],
                            kernel_of[path], reports.get(path))
                for path in paths}
    # the co-simulation (eager steps, the wrapper counts every launch),
    # the calibration and the pole-model fit
    launches["sumo"], sumo_run, forms["k1_mixed_screen_sumo"] = timed(
        "sumo", phase_sumo)
    cal_tracks, cal_card = timed("calibration", phase_calibration)
    gmm_card = timed("gmm_fit", phase_gmm_fit)
    # the sharded schedules (eager, timed) and the demos, before the CPU
    # pool starts
    sharded_state = strips(build_population(
        N_AGENTS, DENSITY, HIST_LEN, SHARDS * BLOCK, torch.float32, "cuda"))
    sharded, allgather_final, sharded_kb, sharded_k1_forms = timed(
        "sharded", phase_sharded, sharded_state)
    launches.update(sharded)
    forms.update(sharded_k1_forms)
    launches["sharded_group"] = timed("sharded_group", phase_sharded_group,
                                      sharded_state, allgather_final,
                                      sharded_kb)
    timed("demos", phase_demos)
    profiled = ("slice", "slice_twod", "slice_mixed", "slice_invpendulum",
                "slice_balancingrider", "slice_stochastic",
                "slice_stochastic_exact", "slice_scripted", "slice_kaths")
    per_step = {path: timed("profile", phase_profile, path, *paths[path])
                for path in profiled}
    emit("profile", twod_device_activities_per_step_over_slice=(
        per_step["slice_twod"] - per_step["slice"]),
        invpendulum_device_activities_per_step_over_twod=(
        per_step["slice_invpendulum"] - per_step["slice_twod"]),
        balancingrider_device_activities_per_step_over_slice=(
        per_step["slice_balancingrider"] - per_step["slice"]),
        stochastic_device_activities_per_step_over_balancingrider={
            path: per_step[path] - per_step["slice_balancingrider"]
            for path in ("slice_stochastic", "slice_stochastic_exact")},
        scripted_device_activities_per_step_over_slice=(
            per_step["slice_scripted"] - per_step["slice"]))

    # the CPU reference runs, in worker processes, after every timed
    # phase: the card-only phases run meanwhile, the parity phases
    # collect them last
    cpu = CpuReferences()
    cpu.start(cpu_specs(db_engine.neighbors.kb, leg_engine.neighbors.kb,
                        parity_mixed_engine.neighbors.kb,
                        kaths_engine.neighbors.kb),
              first=(("gmm_fit", fit_gmm_model, ("cpu",)),
                     ("sumo", run_sumo, ("cpu",)),
                     ("viz_fields", field_case, ("cpu",)),
                     ("calibration", calibration_check,
                      (cal_tracks, "cpu"))))
    try:
        card_phases(timed, paths, engine, twod_engine, ip_engine,
                    br_engine, state)
        timed("scenario", phase_scenario, state)
        timed("diagnostics", phase_diagnostics, state)
        field_card = timed("viz_fields", phase_viz_fields, state)
        timed("parity", phase_parity, cpu)
        timed("parity_db", phase_parity_db, db_engine, state, cpu)
        timed("parity_legacy", phase_parity_legacy, leg_engine, cpu)
        timed("parity_twod", phase_parity_queues, "parity_twod",
              twod_engine, PARITY_TWOD_N, BLOCK,
              lambda p: cpu.get("parity_twod"))
        timed("parity_mixed", phase_parity_queues, "parity_mixed",
              parity_mixed_engine, n_mixed, None,
              lambda p: cpu.get("parity_mixed",
                                kb=parity_mixed_engine.neighbors.kb))
        timed("parity_invpendulum", phase_parity_invpendulum, cpu)
        timed("parity_balancingrider", phase_parity_balancingrider,
              br_state, cpu)
        timed("parity_stochastic", phase_parity_stochastic, cpu)
        timed("parity_scripted", phase_parity_scripted, cpu)
        timed("parity_kaths", phase_parity_kaths, kaths_engine.neighbors.kb,
              cpu)
        timed("sumo_parity", compare_sumo, sumo_run, cpu.result("sumo"))
        timed("calibration_parity", compare_calibration, cal_card,
              cpu.result("calibration"))
        timed("gmm_fit_parity", compare_gmm_fit, gmm_card,
              cpu.result("gmm_fit"))
        timed("viz_fields_parity", compare_field, field_card,
              cpu.result("viz_fields"))
    finally:
        cpu.close()
    emit("phase_seconds", **seconds)
    emit("total", seconds=time.perf_counter() - t_start)
    kernels_line(launches, kernel, forms, vs_k1, kernel_of, agent)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def card_phases(timed, paths, engine, twod_engine, ip_engine, br_engine,
                state):
    """graph_parity, metrics and aliasing: the phases that need no CPU
    reference run."""
    import torch

    from cyclistsocialforce_tpu_torch.scenarios import build_population

    small_mixed = twod_crowd(GRAPH_PARITY_RECORD_N, torch.float32, "cuda",
                             None)
    model_cases = {name: (make_model_engine(model, params), model_crowd(
        model, params, GRAPH_PARITY_RECORD_N, torch.float32, "cuda"))
        for name, (model, params) in graph_parity_models().items()}
    model_cases["slice_invpendulum"] = (ip_engine, model_crowd(
        "invpendulum", ip_params(), GRAPH_PARITY_RECORD_N, torch.float32,
        "cuda"))
    model_cases["slice_balancingrider"] = (br_engine, model_crowd(
        "balancingrider", br_params(), GRAPH_PARITY_RECORD_N, torch.float32,
        "cuda", hist_len=HIST_LEN))
    for mode in (*BR_MODES, "hess", *STOCH_MODES):
        model_cases[f"{br_model(mode)}_{mode}"] = (
            make_model_engine(br_model(mode), br_params(mode)),
            stable_crowd(mode, GRAPH_PARITY_RECORD_N, torch.float32, "cuda"))
    road_state = build_population(GRAPH_PARITY_RECORD_N, DENSITY, HIST_LEN,
                                  BLOCK, torch.float32, "cuda")
    model_cases["road"] = (make_engine(road=road_elements(
        GRAPH_PARITY_RECORD_N, torch.float32, "cuda")), road_state)
    model_cases["slice_scripted"] = (scripted_engine(road_state), road_state)
    small_kaths = kaths_crowd(GRAPH_PARITY_RECORD_N, torch.float32, "cuda")
    model_cases["slice_kaths"] = (audited_engine(
        make_kaths_engine, "graph_parity kaths", small_kaths), small_kaths)
    timed("graph_parity", phase_graph_parity, paths, {
        **model_cases,
        "slice": (engine, build_population(
            GRAPH_PARITY_RECORD_N, DENSITY, HIST_LEN, BLOCK, torch.float32,
            "cuda")),
        "slice_twod": (twod_engine, twod_crowd(GRAPH_PARITY_RECORD_N,
                                               torch.float32, "cuda")),
        "slice_mixed": (audited_engine(
            lambda **kw: make_mixed_engine(GRAPH_PARITY_RECORD_N, **kw),
            "graph_parity mixed", small_mixed), small_mixed)})
    timed("metrics", phase_metrics, engine, state)
    timed("aliasing", phase_aliasing, engine, state)


def kernels_line(launches, kernel, forms, vs_k1, kernel_of, agent):
    """Print the kernels' JSON line: each with its launches on its paths,
    errors, times and bounds (see the module docstring); the per-agent
    kernels with their figures on the twod crowd and, under "legacy",
    on the legacy one (`phase_agent_step`)."""
    from cyclistsocialforce_tpu_torch.ops import pair_forces as PF

    k1 = PF.KERNELS[0]

    def counted(path):
        """A path's (replayed, warm-up) launches of its kernel."""
        return {"launches": launches[path][0],
                "warm_up_launches": launches[path][1]}

    def mixed(form, path=None):
        return {"form": form, **(counted(path) if path else {
            "launches": None, "warm_up_launches": None}), **forms[form]}

    def blocks(k):
        return {str(b): {"form": f"{k}_block{b}", "launches": None,
                         **forms[f"{k}_block{b}"]} for b in BLOCK_FORMS}

    # vs_k1: K1's time over the kernel's on the same work in the same call
    print(json.dumps({"kernels": [
        {"name": "pair_forces_neighbors", "route": "cuda",
         "source": SRC + "pair_forces.cu", "replaces": TPU + "75",
         **counted("slice"), **kernel,
         "vs_k2_uniform": vs_k1["k2_uniform"],
         "paths": {**{name: counted(name)
                      for name, fn in kernel_of.items() if fn is k1},
                   **{name: counted(name)
                      for name in ("sumo", *(f"sharded_{c}" for c in (
                          *SHARDED_COMMS, "mixed")), "sharded_group")}},
         "mixed": {**mixed("k1_mixed_screen", "slice_legacy"),
                   "vs_k3_mixed": vs_k1["k3_mixed"]},
         "two_family": mixed("k1_two_family_screen", "slice_mixed"),
         "columns": mixed("k1_columns_scripted", "slice_scripted"),
         "sharded": {comm: mixed(f"k1_sharded_{form}", f"sharded_{comm}")
                     for comm, form in (("allgather", "allgather"),
                                        ("ring", "ring_hop"),
                                        ("halo", "halo"))},
         "mixed_block64": {**mixed("k1_mixed_screen_sumo", "sumo"),
                           "crowd": forms["k1_mixed_screen_block64"]},
         "blocks": blocks("k1")},
        {"name": "pair_forces_neighbors_unrolled", "route": "cuda",
         "source": SRC + "pair_forces_unrolled.cu", "replaces": TPU + "401",
         **counted("slice_unrolled"), **forms["k2_uniform"],
         "vs_k1": vs_k1["k2_uniform"],
         "mixed": {**mixed("k2_mixed"), "vs_k1": vs_k1["k2_mixed"]},
         "blocks": blocks("k2")},
        {"name": "pair_forces_neighbors_db", "route": "cuda",
         "source": SRC + "pair_forces_db.cu", "replaces": TPU + "500",
         **counted("slice_db"), **forms["k3"],
         "vs_k1": vs_k1["k3"],
         "mixed": {**mixed("k3_mixed"), "vs_k1": vs_k1["k3_mixed"]},
         "blocks": blocks("k3")},
        *({"name": name, "route": "cuda", "source": SRC + "agent_step.cu",
           "replaces": AGENT_REPLACES[name],
           "launches": launches[main][2 + i][0],
           "warm_up_launches": launches[main][2 + i][1],
           **{key: agent[form][name][key] for key in AGENT_KEYS},
           "library_ms": None,
           "paths": {path: {"launches": launches[path][2 + i][0],
                            "warm_up_launches": launches[path][2 + i][1]}
                     for path, post in FUSED_PATHS.items()
                     if name in ("agent_pre", post)},
           **({case: {key: agent[case][name][key] for key in AGENT_KEYS}
               for case in ("legacy", "twod_spline")} if form == "twod"
              else {})}
          for i, (name, main, form) in enumerate((
              ("agent_pre", "slice", "twod"),
              ("agent_post", "slice", "twod"),
              ("agent_post_whipple", "slice_balancingrider", "whipple")))),
    ]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
