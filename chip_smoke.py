#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, nine sources, started together).
2. Kernel phases at the main path's shapes: ``pdu_health_sim`` on one
   controller interval of the 1024-rack campus (T = 1000, R = 1024, slew
   and wear fold) and ``admm_iterate`` on the campus controller QP
   (h = 12, R = 1024, 30 iterations; also bit for bit against the
   shared-plan kernel, timed beside it), each held against its plain
   PyTorch version on the same inputs on the card and timed with CUDA events
   (median of 25 calls, the host's enqueueing hidden behind a device
   sleep; ``_median_ms``) beside it.  Then ``pdu_health_sim`` in each ESS
   availability mode on an interval of the degraded campus (phase 13's):
   a 0/1 (R,) row, a fractional (T, R) wind-down, and the events tables of
   its fault schedule at edge 1 and at the scenario's edge width (50), each
   bitwise against its plain version, the events runs also bitwise against
   the (T, R) run on ``faults.ess_weight``, each timed beside the clean
   variant; the wear machine at kappa 1, 3 and 2.5; and the widened
   shapes: rmsnorm at D = 100 and 9000, admm_step at horizons 6 (padded
   to 12), 24, 48 (the shared-plan variant) and 64, 96 and 128 (the plan
   read from global memory), each in one launch within 2e-5 of its plain
   version after 30 iterations and timed beside its bound: at 6, 12 and 24
   the row-parallel kernel bit for bit against the shared-plan kernel
   forced on the same QP (timed beside it), from 48 up each home of the
   global-plan variant's iterates (shared memory, a global scratch) that
   does not serve h bit for bit against the kernel that does.  The
   one-thread-a-rack kernel's time before the row-parallel redesign is
   printed on a line of its own, marked as a recorded constant.
   ``pdu_health`` runs the warp-specialised pipeline of
   ``csrc/hw_stages.cuh``; its campus interval is also run with the
   pipeline's cp.async route forced (the same bits, timed beside the TMA
   route the plan picks at R = 1024), and at ragged shapes
   (``phase_pdu_health_ragged``: R = 1, 3, 33, 1000 and T = 1, 7, S - 1,
   S + 1, 2500 in every weight mode with the slew and wear fold on and off,
   against the first R columns of one plain run at 1024 racks); its times
   before the redesign, in each mode, are printed as recorded constants.
   A latency probe (``chain_probe``: one warp's chain of dependent FMAs
   timed at two lengths) gives the card's time per dependent operation,
   from which the script prints the chain bound of pdu_health, pdu_sim and
   lc_filter (T x the LC update's 5 dependent operations) beside their
   byte bound.
3. The quickstart (``examples/quickstart.py`` through the port): the
   240 s testbench trace at 500 Hz through ``pdu.condition`` with
   ``qp_iters=40``; the raw rack must fail the grid spec, the conditioned
   grid must pass it, and the SoC must stay inside [0.10, 0.90];
   ``pdu_health`` and ``admm_step`` must launch once per 5 s interval (48
   each, T = 2500, R = 1: one rack, its copies and stores spread over 32
   samples a warp instruction).
4. The acceptance campus: 1024 racks, four model families plus an
   inference-diurnal block, staggered starts, early stops and a fault
   cascade, 88 s at 200 Hz, conditioned by ``fleet.condition(engine=
   "host")`` with the wear fold, ``qp_iters=30``, ``chunk_intervals=4``.
   Each kernel must launch 18 times (one per controller interval), and the
   campus numbers must match the JAX package's (``JAX_CAMPUS``, recorded
   on the CPU by ``python tests/test_torch_campus_reference.py``) within
   ``CAMPUS_TOLERANCES``.  Then the same campus through the scanned engine
   (``fleet.condition``'s default: the whole window as one CUDA graph;
   ``phase_scanned``): after its cache is emptied, one cold run (warm-up
   and capture) and three warm runs.  The capture must record pdu_health
   and admm_step 18 times each with no plain pdu_health call, a warm run
   must launch nothing from Python (a replay), every output (the campus
   arrays, the QP residual, the wear and online-fraction traces, every
   leaf of the state, both reports) must equal the host engine's bit for
   bit, so ``JAX_CAMPUS`` holds too.  Successive one-chunk windows
   (``start_sample`` / ``stop_sample``), each resumed from the last one's
   state, must replay one graph (no launch from Python after the first)
   with ``torch.cuda.memory_reserved`` flat, and together equal the
   one-call run.  It prints the cold wall, the warm walls (median and
   spread), the warm walls of the resumed windows, the graph's nodes by
   type and the peak memory beside the host engine's, and drops the cached
   graphs at the end.
5. The serving kernels at the serving slice's full-width shapes, each held
   against its plain version on the card and timed as in phase 2 beside
   the plain version and the library call: ``rmsnorm`` on (4 x 512,
   2048) bf16 and f32 and (4, 2048) bf16, then at every shape of
   ``RMSNORM_SHAPES`` (``_rmsnorm_case``: the main paths' prefill rows
   from 512 to 7168 columns, (2048, 2048) float32, the decode step's 4
   rows, and the edge cases), each also giving the same bits twice and, on
   the row route, the bits of ``fold_rmsnorm``, and timed warm and cold (the L2 filled by zeroing a 256 MiB buffer
   before each call) beside ``F.rms_norm``, the kernel's times before its
   redesign printed as recorded constants; the flash-attention forward on
   q (4, 32, 512, 64) and k, v (4, 8, 512, 64), causal, bf16 and f32, a decode offset
   (Tq = 128, Tk = 1024), a ragged Tq = Tk = 300, a non-causal case and
   a head dim of 30 (zero-padded to 32), head dims 160, 192 and 256 (bf16
   and f32; 256 timed), B x H = 65600 heads (float32), and head dims 320
   and 512 in column chunks (bf16 and f32, causal with Tq = Tk = 300 and
   non-causal with Tq = 200, Tk = 257; the causal bf16 ones timed beside
   their bounds and held to the float32 plain version), output and
   log-sum-exp compared (``F.scaled_dot_product_attention``).  The bf16
   forward runs on the tensor cores; the FP32-FMA kernel's recorded time
   before that redesign is printed on a line of its own, marked as a
   constant.
6. The serving slice at full llama3.2-1b width (16 layers, bf16, 1.24 B
   random parameters from ``convert.random_lm_tree(cfg, 0)``):
   (a) the prefill step on 4 prompts x 512 tokens must launch flash 16
   and rmsnorm 33 times, and its logits must match the same step run on
   the plain versions (``ops.forced("ref")``) within
   ``SERVE_PREFILL_TOL``; (b) ``ServeEngine.generate``, 4 requests, 64-token
   prompts, 32 greedy tokens, must launch rmsnorm 33 x 32 times and flash
   never, its logits (the decode loop fed its own tokens) must match
   ``forward``'s on the output within ``SERVE_PREFILL_TOL``, and its
   tokens must equal forward's argmax wherever the top-2 margin exceeds
   ``SERVE_MARGIN_TOL``; and ``SERVE_REF`` (2 prompts x 64, 8 tokens) must
   match the JAX package's numbers (``JAX_SERVE``, recorded on the CPU by
   ``python tests/test_torch_serve_reference.py``: prefill rows, and the
   decode step's logits at every generated position with JAX's tokens fed
   back) within ``SERVE_LOGIT_TOL``.  It prints the prefill wall time and
   the generation's tokens/s.  (c) stablelm-12b at full width (head dim
   160, LayerNorm) cut to 4 layers (``STABLELM``): the prefill on 2 x 512
   tokens must launch flash once per layer and match the same step under
   ``ops.forced("ref")`` within ``SERVE_PREFILL_TOL``.

7. The training kernels at the training slice's full-width shapes: the
   flash-attention backward (dK/dV and dQ kernels) on q (4, 32, 512, 64),
   k, v (4, 8, 512, 64), causal, bf16 and f32, a decode offset (Tq = 128,
   Tk = 1024), a ragged 300, a non-causal case, a head dim of 30, head dims
   160, 192 and 256 (bf16 and f32; 256 timed), B x H = 66560 heads and head
   dims 320 and 512 in column chunks (as in phase 5; timed, and run once
   more through ``ops.attention`` and autograd: one launch of each kernel,
   the same bits), each gradient held against the plain backward on the
   same residuals and against autograd through the plain attention; bf16
   at head dims up to 128 runs
   on the tensor cores, every line names its route; both kernels timed at
   the training shape beside the plain backward and the library's
   (autograd through ``F.scaled_dot_product_attention``, backward only),
   with the FP32-FMA kernels' recorded times before the redesign printed
   as constants; the rmsnorm Function's gradients equal to autograd of the
   plain version.
8. The training slice at full llama3.2-1b width (16 layers, bf16,
   ``remat="block"``, the serving phase's parameter tree): (a) three
   ``build_train_step`` steps on 4 x 512 tokens of ``SyntheticLMDataset``
   with AdamW(lr=1e-3, weight decay 0.1) must launch, per step, flash
   forward 32 times (the recompute runs it again), dK/dV and dQ 16 each and
   rmsnorm 65 times, and step 1 (loss, grad norm, sampled moments and
   updated parameters) must match the same step on the plain versions
   (``ops.forced("ref")``) within ``TRAIN_TOL``; (b) ``TRAIN_REF`` (2
   layers at full width, 2 x 64 tokens, 2 steps) must match the JAX
   package's numbers (``JAX_TRAIN``, recorded on the CPU by ``python
   tests/test_torch_train_reference.py``); (c) ``train()`` with the
   launcher's ``PowerSim`` (``launch.train.power_sim_for``) for 4 steps
   must keep the conditioned grid's ramp within 0.1 /s (+1e-3), the rack's
   above it and the SoC inside [0.1, 0.9], with ``pdu_health`` and
   ``admm_step`` launched once per conditioned controller interval.  It
   prints the warm step's wall time, tokens/s and ``train_mfu`` (6 N
   tokens over the step time at 989 TFLOP/s; remat executes ~8 N).
9. The ``rwkv6_scan`` kernel at the ssm slice's shapes, held against the
   sequential plain version (output and final state): the prefill shape
   (4, 64, 512, 64) in bf16 and f32 from a non-zero state, the same
   from (B, T, H, D) views as the time mix hands them over (o returned in
   that layout), a decode step (T = 1), a ragged T = 257 at D = 128, an
   extreme decay w = 0.01, D = 32, a D = 48 zero-padded to 64, D = 256
   (bf16 at the prefill shape with 16 heads, timed, and f32), a D = 200
   zero-padded to 256, and above 256 (threads of 128 rows a state column)
   D = 512 (bf16, timed, and f32), a D = 400 zero-padded to 512, D = 384
   and D = 4096, and past it D = 4224 (f32, 33 threads of 128 rows a
   column) and D = 8192 (bf16, timed), in slabs whose partial outputs a
   second pass sums (one ``rwkv6_slab_sum`` launch a call above 1024),
   each above 256 also through ``ops.rwkv6_scan`` (one launch, the same
   bits), and a state carried across two calls equal to one call, the
   second call a decode step too; a decode step on the step kernel
   (D = 32, 64 and 128) bitwise equal to the chunk kernel's single step;
   timed beside the sequential and the chunked plain versions and the
   chunk kernel's single step, with the kernel's prefill and decode times
   before its redesign printed on a line of their own, marked as recorded
   constants.
10. The ssm serving slice at full rwkv6-7b width (32 layers, bf16, 7.5 B
   random parameters drawn on the card by ``transformer.init``): (a) the
   prefill step on 4 prompts x 512 tokens must launch ``rwkv6_scan`` 32
   and rmsnorm 97 times, no slab sum, and call no plain scan, and its
   logits must match the same step under ``ops.forced("ref")`` (chunked and sequential
   plain scans) within ``RWKV_PREFILL_TOL``, and each block alone, fed
   the kernel run's input to it, must match its plain run within
   ``RWKV_BLOCK_ULPS``; (b) ``ServeEngine.generate``, 4 requests,
   64-token prompts, 32 greedy tokens, must launch them 32 x 32 and
   97 x 32 times, its tokens must be its logits' argmax, and its logits
   must match ``forward``'s over the output within ``RWKV_PREFILL_TOL``;
   (c) ``RWKV_SERVE_REF`` (4 layers of full width) must match
   ``JAX_RWKV_SERVE`` (recorded on the CPU by ``python
   tests/test_torch_rwkv6_serve_reference.py``) within ``RWKV_LOGIT_TOL``.
   It prints the prefill wall time and the generation's tokens/s.

11. The kernel-level entry (``ops.lc_filter``, ``ops.pdu_sim``,
   ``ops.gemm_burn``) at real sizes, each main-path call through ``ops``
   launching its kernel exactly once: (a) lc_filter and pdu_sim at
   ``benchmarks/kernel_benches.py``'s shapes (T = 60000, R = 128, the
   prototype-rack filter, dt = 1 ms, zero corrective; pdu_sim unweighted,
   with the (T, R) weight of 12 % degraded racks ramping down over 4 s, and
   with a (R,) 0/1 weight; each pdu_sim variant also on the first 1 and
   3 racks against the plain run's first columns; the plain versions over
   the first ``SIM_BENCH["plain_t"]`` samples, against the main-path run's
   first samples and a kernel run over them); (b) both over the whole
   acceptance campus in
   one launch (T = 17600, R = 1024, the campus ``make_pdu`` filter;
   pdu_sim unweighted and with the (T, R) and (R,) weights, unweighted also with the
   cp.async route forced, the same bits, timed beside the TMA route; its
   times before the pipeline redesign printed as recorded constants);
   lc_filter at both shapes also with its cp.async route (copies and spread
   stores) forced, the same bits, timed beside the route the plan picks,
   on the first 1, 3 and 33 racks against the plain run's first columns
   and on the first 1, 7, S - 1 and S + 1 samples (S its chunk) on both
   routes against plain runs of those samples, with its times before the
   redesign printed as recorded constants; and pdu_sim's grid and
   SoC against the plain ``ess.simulate`` -> ``filters.simulate`` within
   ``UNFUSED_TOL``; (c) gemm_burn at 512^3 float32 (n_iters 4, and the
   n_iters 1 vs 8 value), 4096^3 bfloat16 (n_iters 1, 4, 8; time(8) /
   time(1) >= 5, the cost of one more round the same from 1 to 4 as from
   4 to 8 within ``GEMM_ROUND_AGREE`` and no less than a round's bf16
   bound; TFLOP/s printed), a ragged bfloat16 1000 x 1001 x 998 (n_iters
   4; K and N zero-padded for the tensor maps) and a float32 300 x 200 x
   520 (n_iters 3; K split with a short last range).  lc_filter and pdu_sim must equal their plain versions
   bit for bit (grid, SoC, every final); gemm_burn must match its plain
   version within tests/test_kernels.py's tolerances.  Each is timed
   beside its plain version (one call) and gemm_burn beside n_iters x
   ``torch.matmul``.
12. Paper Fig. 11 through the port: ``titanx_testbench`` (300 s at 200 Hz)
   -> ``burn.calibrate`` -> ``burn_schedule(beta=0.1)`` ->
   ``pdu.condition(qp_iters=40)`` -> ``compare_energy``; pdu_health and
   admm_step must launch once per controller interval (60),
   ``burn_vs_easyrider_frac`` lie in [0.10, 0.30], the EasyRider overhead
   in [-1e-3, 0.02] and the burn envelope's ramp within 0.1 (1 + 1e-3);
   the same pipeline on ``scenario_from_testbench(titanx_spec(),
   noise_seed=2)`` must match the JAX package's numbers (``JAX_FIG11``,
   recorded on the CPU by ``python tests/test_torch_burn_reference.py``)
   within ``FIG11_TOLERANCES``.  It times the closed-form burn envelope.
13. Degraded-mode conditioning of ``FAULTY_CAMPUS`` (the campus of
   ``bench_mixed_campus_faulty``: a stochastic fault soup and an injected
   rack cascade over 1024 racks, 88 s at 200 Hz) through
   ``fleet.condition`` with ``engine="host"`` (the fault schedule handed to
   ``pdu.condition``; the kernel renders the ESS weight from the episode
   tables) and ``engine="oneshot"`` (the streamed (T, R) weight), each run
   twice: each run must launch pdu_health (in its engine's weight mode)
   and admm_step 18 times and call no plain pdu_health, and the numbers
   must match the JAX package's (``JAX_FAULTY_CAMPUS``, recorded on the CPU
   by ``python tests/test_torch_faulty_campus_reference.py``) within
   ``FAULTY_CAMPUS_TOLERANCES``, ``ess_online_frac`` and the verdicts
   exactly.  It prints each engine's warm wall time.  Then the scanned
   engine as in phase 4 (its capture records pdu_health in the events
   mode 18 times), bit for bit the host engine's run.
14. The controller's per-step oracle and the paper benches that need it,
   at the reference's sizes (``benchmarks/paper_benches.py``), each with
   the launch counters set to 0 just before its timed run and read just
   after: (a) Fig. 12 (``FIG12``: ``simulate_soc_management`` from SoC
   0.62, 400 steps of 80 cold iterations through the plan) must launch
   admm_step once a step (the unbatched solve lifted to one column), end
   within the deadband of 0.5 and stay inside [0.10, 0.90], and match the
   same run on the plain versions (``ops.forced("ref")``) within
   ``FIG12_SOC_TOL`` with the same convergence step; it prints the
   convergence time and both walls.  (b) ``fleet_1024racks``
   (``FLEET_SCALE``: 1024 racks of a 44 s testbench trace at 200 Hz,
   staggered by ``fleet.staggered_fleet``) through ``pdu.condition`` cold
   (``use_plan=False``, the per-step oracle, 120 iterations) and warm
   (the plan, 30), each after a warm-up run: pdu_health once an interval
   in both, admm_step never cold and once an interval warm, the campus
   ramp within 0.1 /s and the two campus means within
   ``FLEET_COLD_WARM_TOL``; it prints per-rack microseconds, their ratio,
   the QP residuals and the ramp.  (c) ``controller_throughput``
   (``CONTROLLER_THROUGHPUT``: 2048 racks, cold ``inner_loop_step``
   batched at 120 iterations, warm 4 warm-started plan steps at 30): it
   prints both rates in rack-solves/s and the last warm residual.
15. Safe mode (``core.safemode``, ``make_pdu(safemode=True)``): (a) the
   acceptance campus of phase 4 supervised with the default
   ``SafeModeConfig`` (``bench_mixed_campus_safemode``) through the host
   engine and then the scanned engine as in phase 4 (``phase_scanned``):
   each must launch pdu_health 18 times, all in its (T, R) series mode (the
   supervisor's weight of ones), and admm_step 18 times, and equal phase
   4's unsupervised run bit for bit (so ``JAX_CAMPUS`` holds too), with
   every ``safemode_trace`` row [1, 0, 0, 0, 0, 0] and every rack NORMAL;
   it prints the graph's nodes beside phase 4's and the supervision
   overhead, three alternating warm runs unsupervised and supervised on
   each engine (recorded, not asserted).  (b) The drill
   (``SAFEMODE_DRILL``: ``FAULTY_CAMPUS`` supervised, from an initial state
   with a poisoned warm start on two racks, a NaN SoC, a NaN LC state and
   an operator's offline override) through the host engine (twice) and the
   scanned engine (a cold run and three warm ones): pdu_health in the
   series mode 18 times a run (at capture on the scanned engine), the two
   engines bit for bit, each within ``FAULTY_CAMPUS_TOLERANCES`` of
   ``JAX_SAFEMODE_DRILL`` (recorded on the CPU by ``python
   tests/test_torch_safemode_campus_reference.py``) with the verdicts,
   ``ess_online_frac``, the ``safemode_trace`` rows and the supervisor's
   summary exactly, every campus sample finite, and the scanned run split
   at sample 8000 and resumed equal to one call; it prints each engine's
   warm walls.
16. Grid regions and the operator service (``core.grid``,
   ``serve.conditioner``): (a) ``GRID_REGION`` (``bench_grid_region``'s 4
   campuses x 256 racks of checkpoint stalls, 200 s at 50 Hz) through
   ``fleet.condition`` on the scanned engine, synchronized and then
   staggered, one cold and three warm runs each: the 8 campus runs must
   make one capture (40 clean pdu_health and 40 admm_step launches) and
   launch nothing from Python after it; the synchronized POI must ring the
   inter-area band and pass the local-plant band, the staggered one pass
   both, at least 10x apart, both POI ramps within spec; ``poi_rack`` /
   ``poi_grid`` must equal the left-to-right weighted sum of the campus
   aggregates and ``poi_freq_dev`` / ``poi_volt_dev`` ``grid.poi_response``
   of it, each campus's result ``fleet.condition`` of that salted campus
   alone, bit for bit; both regions must match ``JAX_GRID_REGION``
   (recorded on the CPU by ``python
   tests/test_torch_grid_region_reference.py``) under ``compare_region``,
   the mode lines also the exact DFT of the port's POI.  It prints the
   walls, the graph's nodes and the host-side POI fold and
   ``poi_response`` times.  (b) ``ConditionerService`` over the
   synchronized region (4-interval windows, an fsync'd audit log): a trip
   of global rack 261 (campus 1) shown by ``status()`` and cleared, a
   checkpoint restored into a second service whose next window equals the
   live one bit for bit (``poi_grid``, ``campus_rack``, ``poi_freq_dev``,
   every state leaf), then drained: ``mode_band_violation`` events, all
   inter-area above threshold, every line strict JSON.  (c) The degraded
   ``FAULTY_CAMPUS`` under ``ConditionerService`` (4-interval windows)
   drained whole, killed after window 2 and recovered over a directory
   holding a torn ``.npz``, and auto-checkpointed every window keeping 3:
   the three bit for bit equal, the windows together within
   ``FAULTY_CAMPUS_TOLERANCES`` of phase 13's scanned run
   (``ess_online_frac`` exactly), the fault, repair and degraded events as
   the schedule's ``episodes_in_window`` and the online fraction give
   them, three checkpoints kept, pdu_health captured in its events mode.
17. The ``moe`` family (DeepSeek MLA, the capacity-bounded MoE FFN, MTP)
   at its published widths, cut in depth (``MOE_V2``, ``MOE_V3``).  (a)
   Flash at MLA's prefill shape (q, k (4, 128, 512, 192), v (4, 128, 512,
   128), v zero-padded to 192 in the wrapper) and a ragged T = 300 against
   the plain version, timed beside it and the library call, and rmsnorm
   at 1536, 512, 5120 and 7168 columns at the model's eps, held as phase 5
   holds it (phase 5 times these shapes).  (b)
   deepseek-v2-236b at 2 layers (1 dense + 1 MoE, 160 experts top-6,
   capacity factor 1.25; 5.36 B parameters from ``random_lm_leaves``, one
   leaf on the host at a time): ``MOE_SERVE_REF`` against
   ``JAX_MOE_SERVE`` (recorded on the CPU by ``python
   tests/test_torch_moe_serve_reference.py``) under ``compare_moe_serve``:
   every logit within ``MOE_LOGIT_TOL`` on JAX's routing (``routed_as``),
   the MoE layer's own routing in the prefill step, every decode call and
   ``forward`` pick for pick and ``forward``'s expert counts and dropped
   fraction exactly, but where a routing near-tie (``ROUTE_TIE_LOGIT``)
   moved a pick (the exempt tokens counted and printed); prefill 4 x 512
   (flash 2, rmsnorm 9 launches) against the same step on the plain
   versions and generation 4 x (64 + 32) (rmsnorm 9 a token) against the
   decode loop on the plain versions, every logit within
   ``MOE_PREFILL_TOL`` on the kernel run's routing, the two runs' own
   routings compared as above.  (c) deepseek-v3-671b at 4 layers (3 dense
   + 1 MoE, 256 experts top-8, the sigmoid-bias router, MTP; 15.8 B
   parameters drawn on the card): the same prefill and generation checks
   (flash 4, rmsnorm 17 launches a prefill), and ``forward``'s
   ``mtp_logits`` (flash 5, rmsnorm 22) on the kernels against the plain
   versions the same way.  It prints each model's prefill wall, tokens/s,
   peak memory and launches, and the phase's seconds.
18. The ``moe`` family trained (the aux and MTP losses, the router-bias
   nudge, remat of the MoE stack, AdamW's sliced update).  (a) The flash
   backward at MLA's training shape (q, k (4, 128, 512, 192), v (4, 128,
   512, 128), causal bf16) through ``FlashAttention``, held as phase 7
   holds it against the plain backward on the same residuals and autograd
   through the plain attention; dK/dV and dQ timed beside the plain
   backward and SDPA's backward at 192/128, with the bound of the model's
   work and the route the launches took.  (b) deepseek-v2-236b at full
   width cut to 2 layers (17b's model, 5.36 B parameters, bf16,
   ``remat="block"``, AdamW(lr=1e-3) with float32 moments; 4 x 512 tokens
   a step): step 1 on the plain versions, the same step from the same
   start (a host copy) on the kernels on the plain run's routing
   (``routed_as`` keyed by layer and forward pass, the recompute replaying
   its forward), within ``MOE_TRAIN_TOL`` (loss, ``lm_loss``, the aux
   losses, grad norm, sampled moments and parameters; ``expert_load`` and
   ``dropped_fraction`` exactly) with the routings compared apart; the
   kernel step once more from the same start (the same bits, or the
   differing leaves printed); two more kernel steps.  Each kernel step
   launches flash forward 4, dK/dV 2, dQ 2 and rmsnorm 17 times
   (``moe_train_launches``), the plain step none.  It prints the step
   walls, tokens/s, ``train_mfu`` over the active parameters and the peak
   memory.  (c) ``MOE_TRAIN_REF`` (the v2 and v3 smoke configs, float32, 3
   layers, capacity factor 1.25, 2 steps of 4 x 128) on the kernels on
   JAX's routing against ``JAX_MOE_TRAIN`` (recorded on the CPU by
   ``python tests/test_torch_moe_train_reference.py``) within
   ``MOE_REF_TOL``, v3's router bias within 1e-7, the port's own routing
   against JAX's picks but at near-ties (``MOE_REF_TIE``).  (d)
   ``train()`` with the launcher's PowerSim for deepseek-v2 at full width
   (2 layers, 4 steps), checked as phase 8c.  It prints the phase's
   seconds.
19. The ``hybrid`` family (zamba2: Mamba2 SSD blocks, the Zamba2 shared
   attention block) served at zamba2-2.7b's published width and full depth
   (``HYBRID``: 54 Mamba2 layers in 9 groups of 6, the shared block of 32
   heads of 80 visited after each group; 2.44 B parameters drawn on the
   card; the SSD scan is plain float32 PyTorch, as it is ``jnp`` in the
   reference).  (a) Flash at the shared block's (4, 32, 512, 80), causal
   bf16 (zero-padded to 128 in the wrapper; the backward on the
   tensor-core route), forward and backward held as phases 5 and 7 hold
   them and timed beside the plain versions and SDPA (which takes 80),
   with the bounds of the model's work and of the padded work; rmsnorm at
   2560 is in ``RMSNORM_SHAPES``.  (b) Prefill 4 x 512 (rmsnorm 127, flash
   9 launches: ``hybrid_launches``) against the same step on the plain
   versions within ``HYBRID_PREFILL_TOL`` beside the plain run with another
   SSD chunk (the stack's floor with no kernel), each block alone within
   ``HYBRID_BLOCK_ULPS`` of its plain run; generation 4 x (64 + 32)
   (rmsnorm 127 a token, flash 0) against ``forward``; ``HYBRID_SERVE_REF``
   (full width, 12 layers) against ``JAX_HYBRID_SERVE`` (recorded on the
   CPU by ``python tests/test_torch_hybrid_serve_reference.py``) within
   ``HYBRID_LOGIT_TOL``.  It prints the prefill wall, tokens/s and peak
   memory.
20. The ``hybrid`` family trained.  (a) 19's model, ``remat="block"`` (one
   checkpoint a group), AdamW(lr=1e-3) with float32 moments, 4 x 512
   tokens a step: step 1 on the kernels against the same step on the
   plain versions from the same start (a copy on the card) within
   ``TRAIN_TOL`` on ``HYBRID_TRAIN_LEAVES``, once more the same bits, two
   more steps; each kernel step launches flash forward 18, dK/dV 9 and dQ
   9 (all on the tensor cores) and rmsnorm 253.  It prints the step walls,
   tokens/s, ``train_mfu`` over ``cfg.param_count()`` and the peak memory.
   (b) ``HYBRID_TRAIN_REF`` (the smoke config, float32, 2 steps of 4 x
   128) on the kernels against ``JAX_HYBRID_TRAIN`` (``python
   tests/test_torch_hybrid_train_reference.py``) within ``HYBRID_REF_TOL``.
   (c) ``train()`` with the launcher's PowerSim at full width and depth,
   4 steps, checked as phase 8c.
21. The ``audio`` family (Whisper: the encoder-decoder of
   ``models/encdec.py``) at whisper-large-v3's published width and full
   depth (``WHISPER``: 32 encoder and 32 decoder layers, d_model 1280, 20
   heads of 64, 1500 frames a request; 1.643 B parameters drawn on the
   card; its layernorms and cross-attention are plain PyTorch, as they are
   ``jnp`` in the reference).  (a) Flash at the encoder's (4, 20, 1500, 64)
   non-causal (a ragged last tile) forward and backward, the decoder's
   prefill (4, 20, 64, 64) causal forward and its training (4, 20, 512,
   64) causal backward, held as phases 5 and 7 hold them and timed beside
   the plain versions and SDPA.  (b) Prefill 4 x 64 with the frames (flash
   32 non-causal + 32 causal: ``whisper_launches``) against the same step
   on the plain versions within ``WHISPER_PREFILL_TOL``, each block alone
   within ``WHISPER_BLOCK_ULPS``; generation 4 x (64 + 32) (the encoder's
   32 once, none a token) against ``forward``.  (c) Training 4 x 512 with
   the reference loop's frames: step 1 on the kernels against the plain
   versions within ``TRAIN_TOL`` on ``WHISPER_TRAIN_LEAVES``, once more
   the same bits, two more steps (flash forward 128, dK/dV 64, dQ 64 a
   step, the backward on the tensor cores); ``train()`` with the
   launcher's PowerSim, 4 steps, checked as phase 8c.  (d)
   ``WHISPER_SERVE_REF`` (full width, 2 + 2 layers) against
   ``JAX_WHISPER_SERVE`` within ``WHISPER_LOGIT_TOL`` and
   ``WHISPER_TRAIN_REF`` (the smoke config, float32, 2 steps) against
   ``JAX_WHISPER_TRAIN`` within ``WHISPER_REF_TOL`` (both recorded on the
   CPU by ``python tests/test_torch_encdec_{serve,train}_reference.py``).
   It prints each part's seconds.
22. The ssm training slice (``RWKV_TRAIN``): rwkv6-7b at full width cut to
   16 layers, drawn on the card, trained with remat per block and AdamW,
   4 x 512 tokens a step.  (a-b) Step 1 on the kernels against the plain
   versions within ``TRAIN_TOL`` on ``RWKV_TRAIN_LEAVES``, once more the
   same bits, three more steps; a step launches rmsnorm 97 times and
   ``rwkv6_scan`` never (a recorded graph takes the plain chunked form, 32
   calls, the reference's training route); ``train()`` with the
   launcher's PowerSim, 4 steps.  (c) ``RWKV_TRAIN_REF`` (the smoke
   config, float32, 2 steps) against ``JAX_RWKV_TRAIN`` within
   ``RWKV_REF_TOL`` (recorded on the CPU by ``python
   tests/test_torch_rwkv6_train_reference.py``).  (d) ``compress_int8`` /
   ``decompress_int8`` on the step's gradients of ``blocks.0.*`` and the
   head, bit for bit against the CPU, the summed residual over 8 rounds
   below one quantization step (``COMPRESS``).  It prints the phase's
   seconds.
23. The sharded engines (``SHARDED``) over worlds of ranks that share the
   one card: one process a rank, a ``torch.distributed`` world each
   (``launch.mesh.init_world``, a ``file://`` store, collectives timed out
   after 120 s), the kernels built by phase 1 loaded, not rebuilt.  (a)
   Four gloo ranks on a (4, 1) region mesh (``sharding.region_mesh``):
   GRID_REGION synchronized and staggered through ``fleet.condition(...,
   mesh=)``, a cold run and two warm ones, every leaf of every rank's
   result bit for bit phase 16a's sequential one; each rank's capture
   records ``pdu_health`` and ``admm_step`` 40 times (its campus's
   intervals), with no plain ``pdu_health_sim`` call.  (c) On the same
   world, ``ConditionerService(..., mesh=)``: one window bit for bit the
   one-rank service's.  (b) Phase 4's 1024-rack campus rack-sharded
   (``fleet.condition(..., mesh=)``) over two gloo ranks and over a world
   of one nccl rank, on the host and scanned engines: every per-rack leaf
   (the state, the wear report) bit for bit phase 4's, the campus means
   within 1e-6, the online fraction, the QP residual and every verdict
   equal (over one rank, every leaf bit for bit).  It prints each rank's
   cold and warm walls and its gather's seconds and bytes, marked as ranks
   sharing one card (no multi-GPU scaling figure), and the phase's
   seconds; a rank that fails or hangs fails the run.
24. FSDP training (``FSDP``, ``sharding.fsdp``) on ``make_host_mesh()``'s
   ``("data", "model")`` mesh of model 1.  (a) A world of one nccl rank
   trains llama3.2-1b as phase 8a (full width and depth, phase 8a's start
   weights, which phase 8 returns, its batches): every
   loss, grad norm, parameter and moment bit for bit phase 8a's three
   kernel steps, its launches (flash forward 32, dK/dV 16, dQ 16, rmsnorm
   65 a step); it prints the walls, the peak memory and the collectives'
   share of a synchronized step (one rank, not a scaling figure).  (b)
   Two gloo ranks sharing the card, full width cut to 4 layers, 4 x 512
   global: ``microbatches`` 1, and 2 with ``gather_small_weights_once``, 2
   steps each, every rank's loss, grad norm and reassembled parameters
   against one process's unsharded run within ``TRAIN_TOL``, replicated
   leaves bit for bit across the ranks, the launches one process's.  (c)
   (b)'s checkpoint restored into one process and back into the two
   ranks bit for bit, and a step from it bit for bit the step without the
   restore.  A failing collective or rank fails the run.
25. Tensor parallelism (``TP``, ``sharding.tp``) on the rules' ``"model"``
   axis, gloo ranks sharing the card (nccl refuses two ranks on one
   device).  Each rank first holds the flash forward (and for training its
   backward) and rmsnorm kernels to their plain versions at the local
   shapes its main path gives them, then drives the main path with the
   counts at 0.  (a) Two ranks on a (1, 2) mesh serve llama3.2-1b at full
   width and depth (phase 8a's start weights, the serving phase's): a
   4 x 512 prefill and ``decode`` teacher-forced decode steps through
   ``build_prefill_step(mesh=)`` / ``build_decode_step(mesh=)``, every
   rank's whole logits against phase 6's unsharded run of the same steps
   within ``SERVE_PREFILL_TOL``, the argmax equal where the top-2 margin
   exceeds ``SERVE_MARGIN_TOL``, the ranks' logits the same bits.  (b) The
   same width cut to ``FSDP["layers"]`` layers trained from phase 8a's
   start weights: ``steps12`` steps on (1, 2) over those two ranks, then
   ``steps22`` on (2, 2) over four, each rank's losses, grad norms,
   sampled moments and reassembled parameters against one process's
   unsharded run within ``TRAIN_TOL``.  (c) chatglm3-6b at full width (2
   KV heads: each rank gathers ``wk`` / ``wv`` over ``"model"``; qkv bias;
   rope fraction 0.5) cut to ``glm_layers`` layers on (1, 4) over the four
   ranks: a prefill against one process's, and one training step (its
   loss, norm, sampled moments and parameters, and the q/k/v biases whole,
   whose gradients sum over ``"model"``).  It prints each rank's launches,
   the ``tp.*`` collectives' share of the walls (ranks sharing one card:
   not a scaling figure) and the phase's seconds.

With ``--profile DIR`` it also profiles one more campus run, prefill step,
generation and training step, rwkv6-7b prefill and generation, a host run
of the degraded campus, a warm replay of each campus's scanned engine,
phase 14's runs (Fig. 12, ``fleet_1024racks`` and ``controller_throughput``
cold and warm), phase 17's prefills and generations, one deepseek-v2
training step, zamba2's prefill and generation, one zamba2 training
step, whisper's prefill and generation, one whisper training step and
one rwkv6-7b training step (``torch.profiler``), writes the tables and Chrome traces into DIR, and
prints each campus's host engine split into ``core.profiling``'s
``render`` / ``solve`` / ``host-sync`` spans.

The script prints the card's name and power limit, then one JSON line
describing each kernel, and ends with the line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` next to it, it exits non-zero and prints
no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

ARCHS = ("llama3_2_1b", "deepseek_v3_671b", "chatglm3_6b", "whisper_large_v3")
CAMPUS = dict(n_racks=1024, duration_s=88.0, sample_hz=200.0, seed=3, noise_seed=2,
              qp_iters=30, chunk_intervals=4)

# The JAX package's numbers for CAMPUS: its host engine on the CPU
# (jax 0.9.0), printed by ``python tests/test_torch_campus_reference.py``.
JAX_CAMPUS = {
    'rack_max_ramp': 3.0713260173797607,
    'grid_max_ramp': 0.02206563949584961,
    'rack_worst_line': 0.00022977461048867553,
    'grid_worst_line': 1.5509531294810586e-06,
    'rack_worst_line_exact': 0.00022994263194101478,
    'grid_worst_line_exact': 1.3892173364332258e-06,
    'rack_ramp_ok': False,
    'rack_spectrum_ok': False,
    'grid_ramp_ok': True,
    'grid_spectrum_ok': True,
    'grid_ok': True,
    'max_qp_residual': 0.004625674337148666,
    'campus_rack_mean': 0.6661505436232652,
    'campus_grid_mean': 0.5565653294642371,
    'soc_mean_min': 0.3337993025779724,
    'soc_mean_max': 0.4915217459201813,
    'soc_mean_last': 0.35262781381607056,
    'efc_mean': 0.12189458310604095,
    'efc_max': 0.1892935335636139,
    'half_cycles_mean': 288.251953125,
    'worst_dod': 0.21451985836029053,
    'fade_mean': 6.208408649399644e-07,
    'fade_max': 1.1300876394670922e-06,
    'mean_soc': 0.3876362144947052,
}

# Tolerances of the port against JAX_CAMPUS, with their reasons:
# * the port renders its own trace: erfinv/cos rounding and XLA's fused
#   multiply-adds move each rack sample by ~1e-6, the campus means by less;
# * ramp maxima are differences of campus means over dt = 5 ms: campus
#   mean errors d <= 5e-8 give 2 d / dt = 2e-5 /s, so 5e-5 /s absolute
#   (measured 1.8e-5 and 6e-6 at 16 racks, which average less);
# * worst spec lines: the reference's float32 Goertzel bank drifts from
#   the exact DFT of its own campus trace (by 11.6 % of the grid's worst
#   line here, inside its 1e-5 absolute contract), so the lines are held
#   to the exact float64 DFT of each package's campus trace at the bank's
#   bins (``exact_worst_line``).  The port's exact lines against the
#   reference's: the rendered racks differ by ~1e-6 (erfinv/cos rounding),
#   which moves the campus lines by ~1e-9 (measured on the CPU at 1024
#   racks: 5e-6 relative rack, 9e-4 relative grid): 1e-3 rack, 1e-2 grid
#   relative.  The port's streamed lines against its own exact DFT: see
#   BANK_REL_TOL.  The verdicts against alpha = 1e-4 are compared exactly;
# * the QP residual and the wear counts follow the SoC path, which sees
#   the controller's commands (ADMM sums in another order on the card):
#   1e-3 relative; counted half-cycles can flip at flat SoC points: 1e-3;
# * SoC and fade means: 1e-5 absolute / 1e-4 relative.
CAMPUS_TOLERANCES = {
    "rack_max_ramp": ("abs", 5e-5),
    "grid_max_ramp": ("abs", 5e-5),
    "rack_worst_line_exact": ("rel", 1e-3),
    "grid_worst_line_exact": ("rel", 1e-2),
    "max_qp_residual": ("rel", 1e-3),
    "campus_rack_mean": ("abs", 1e-6),
    "campus_grid_mean": ("abs", 1e-5),
    "soc_mean_min": ("abs", 1e-5),
    "soc_mean_max": ("abs", 1e-5),
    "soc_mean_last": ("abs", 1e-5),
    "efc_mean": ("rel", 1e-4),
    "efc_max": ("rel", 1e-3),
    "half_cycles_mean": ("rel", 1e-3),
    "worst_dod": ("rel", 1e-3),
    "fade_mean": ("rel", 1e-4),
    "fade_max": ("rel", 1e-3),
    "mean_soc": ("abs", 1e-5),
}
# The port's streamed spec lines (float64 line sums per chunk, folded into
# float32 accumulators) against the exact DFT of the same trace: each of
# the five chunk folds rounds a partial line sum of magnitude up to ~20 at
# float32 precision (~1e-6), against a grid line sum of ~6e-3: relative
# error up to ~1e-3 (measured on the CPU at 1024 racks: 2e-7 rack, 8e-5
# grid).
BANK_REL_TOL = 1e-3
CAMPUS_VERDICTS = ("rack_ramp_ok", "rack_spectrum_ok", "grid_ramp_ok", "grid_spectrum_ok", "grid_ok")


# The serving slice (phases 5-6): llama3.2-1b at full width, bf16, random
# weights from ``convert.random_lm_tree(cfg, SERVE["seed"])``; prompts from
# ``serve_prompts``.  Prefill: 4 prompts x 512 tokens through the prefill
# step; generation: 4 requests, 64-token prompts, 32 greedy tokens.
SERVE = dict(arch="llama3_2_1b", seed=0, prompt_seed=1, prefill=(4, 512), gen=(4, 64),
             gen_tokens=32)
# What tests/test_torch_serve_reference.py runs through the JAX package on
# the CPU and what the card's run is held to: 2 prompts x 64 tokens; the
# prefill step's logits at these (request, position) rows; 8 greedy tokens
# of ServeEngine.generate, and the decode step's logits at each of them
# with JAX's tokens fed back (teacher-forced), so that every generated
# position is compared, whatever the tokens the port would choose.
SERVE_REF = dict(requests=2, prompt_len=64, gen_tokens=8, prompt_seed=SERVE["prompt_seed"],
                 rows=((0, 0), (0, 31), (0, 63), (1, 17), (1, 63)))

# The JAX package's numbers for SERVE_REF at full llama3.2-1b width (bf16,
# weights ``random_lm_tree(cfg, 0)``), on the CPU (jax 0.9.0), printed by
# ``python tests/test_torch_serve_reference.py``.
JAX_SERVE = {'rows': [{'argmax': 53304,
                       'margin': 0.71875,
                       'max': 4.375,
                       'lse': 12.13351521160129,
                       'at_ids': [1.6953125, -0.035888671875, 0.20703125, 0.34375, 0.1416015625, 0.64453125,
                                  -0.24609375]},
                      {'argmax': 41089,
                       'margin': 0.65625,
                       'max': 4.34375,
                       'lse': 12.13730681827908,
                       'at_ids': [0.859375, -0.228515625, 0.400390625, -0.2578125, 0.82421875, 1.0703125,
                                  -0.98046875]},
                      {'argmax': 63792,
                       'margin': 0.0625,
                       'max': 3.703125,
                       'lse': 12.134699800976126,
                       'at_ids': [1.0625, -1.6328125, 0.3203125, -0.06396484375, 0.87109375, 1.0625,
                                  0.08642578125]},
                      {'argmax': 111453,
                       'margin': 0.21875,
                       'max': 3.8125,
                       'lse': 12.138742085093343,
                       'at_ids': [-2.015625, 0.875, -0.66015625, 0.1376953125, -0.1806640625, 0.515625,
                                  0.89453125]},
                      {'argmax': 91941,
                       'margin': 0.125,
                       'max': 3.65625,
                       'lse': 12.141883498599583,
                       'at_ids': [-1.625, 1.1171875, -0.69140625, -1.015625, 0.03125, -0.90625,
                                  0.95703125]}],
             'steps': [[{'argmax': 63792,
                         'margin': 0.046875,
                         'max': 3.6875,
                         'lse': 12.134510879472856,
                         'at_ids': [1.0546875, -1.640625, 0.31640625, -0.06689453125, 0.87890625, 1.046875,
                                    0.09326171875],
                         'at_fed': 3.6875},
                        {'argmax': 77213,
                         'margin': 0.0625,
                         'max': 3.65625,
                         'lse': 12.135331481625709,
                         'at_ids': [-0.2451171875, -1.4453125, 1.15625, 0.376953125, 0.8046875, 1.2265625,
                                    -0.9375],
                         'at_fed': 3.65625},
                        {'argmax': 75560,
                         'margin': 0.046875,
                         'max': 3.71875,
                         'lse': 12.133354783766924,
                         'at_ids': [0.314453125, -2.421875, 0.58203125, 0.236328125, 0.69921875, 1.5,
                                    -1.0078125],
                         'at_fed': 3.71875},
                        {'argmax': 77397,
                         'margin': 0.109375,
                         'max': 3.703125,
                         'lse': 12.133224823608902,
                         'at_ids': [0.62109375, -1.3203125, 0.404296875, -0.044921875, 1.1875, 0.25,
                                    -0.57421875],
                         'at_fed': 3.703125},
                        {'argmax': 59492,
                         'margin': 0.234375,
                         'max': 3.90625,
                         'lse': 12.13692550946161,
                         'at_ids': [-0.004608154296875, -1.6875, 1.0625, -0.0966796875, 0.71484375, 0.46875,
                                    -0.232421875],
                         'at_fed': 3.90625},
                        {'argmax': 59492,
                         'margin': 0.03125,
                         'max': 3.59375,
                         'lse': 12.134143368559942,
                         'at_ids': [0.06884765625, -1.2734375, 1.3671875, 0.058349609375, 1.046875,
                                    1.1171875, -0.3671875],
                         'at_fed': 3.59375},
                        {'argmax': 90329,
                         'margin': 0.109375,
                         'max': 3.65625,
                         'lse': 12.134918050738074,
                         'at_ids': [0.23828125, -1.6328125, 1.0625, -0.07177734375, 0.8203125, 1.2265625,
                                    -0.349609375],
                         'at_fed': 3.65625},
                        {'argmax': 49347,
                         'margin': 0.015625,
                         'max': 3.828125,
                         'lse': 12.137233711929856,
                         'at_ids': [0.1865234375, -1.7890625, 0.3515625, -0.1484375, 0.7734375, 0.51171875,
                                    -0.79296875],
                         'at_fed': 3.828125}],
                       [{'argmax': 91941,
                         'margin': 0.140625,
                         'max': 3.65625,
                         'lse': 12.141830395390194,
                         'at_ids': [-1.625, 1.1171875, -0.69140625, -1.0, 0.04443359375, -0.890625,
                                    0.94921875],
                         'at_fed': 3.65625},
                        {'argmax': 120719,
                         'margin': 0.09375,
                         'max': 3.9375,
                         'lse': 12.141137943070845,
                         'at_ids': [-1.59375, 0.87109375, -0.337890625, -0.9921875, -0.314453125,
                                    -0.72265625, 1.4453125],
                         'at_fed': 3.9375},
                        {'argmax': 72533,
                         'margin': 0.015625,
                         'max': 3.625,
                         'lse': 12.141015762102596,
                         'at_ids': [-1.1328125, 0.5703125, -1.3984375, -1.0390625, -0.2294921875,
                                    -0.0205078125, 0.416015625],
                         'at_fed': 3.625},
                        {'argmax': 68464,
                         'margin': 0.171875,
                         'max': 3.796875,
                         'lse': 12.141149609575123,
                         'at_ids': [-1.21875, 0.91015625, -1.171875, -1.140625, -0.71875, -0.66015625,
                                    1.4609375],
                         'at_fed': 3.796875},
                        {'argmax': 111,
                         'margin': 0.15625,
                         'max': 3.734375,
                         'lse': 12.141638050447344,
                         'at_ids': [-0.60546875, 1.734375, -0.8515625, -1.859375, 0.875, 0.01043701171875,
                                    0.53125],
                         'at_fed': 3.734375},
                        {'argmax': 33435,
                         'margin': 0.109375,
                         'max': 3.640625,
                         'lse': 12.141639462069238,
                         'at_ids': [-1.0, 1.1328125, -0.8828125, -1.21875, -0.2431640625, -1.6953125,
                                    1.1484375],
                         'at_fed': 3.640625},
                        {'argmax': 109757,
                         'margin': 0.171875,
                         'max': 3.546875,
                         'lse': 12.140034049074472,
                         'at_ids': [-0.93359375, 0.8359375, -1.1953125, -1.171875, 0.18359375,
                                    -0.1806640625, 1.0],
                         'at_fed': 3.546875},
                        {'argmax': 118148,
                         'margin': 0.125,
                         'max': 3.625,
                         'lse': 12.142823505194698,
                         'at_ids': [-1.078125, 0.89453125, -1.3984375, -1.3125, 0.1484375, -0.6171875,
                                    1.1953125],
                         'at_fed': 3.625}]],
             'tokens': [[63792, 77213, 75560, 77397, 59492, 59492, 90329, 49347],
                        [91941, 120719, 72533, 68464, 111, 33435, 109757, 118148]]}

# Tolerances of the card's full-width bf16 serving run, with their
# reasons.  The logits are bf16 (the tied readout rounds them before they
# are widened), and at the top of their range (|logit| ~4.4) one bf16 ulp
# is 2^-5 = 0.031.  The port and the reference round at the same points but
# sum their bf16 products in other orders (cuBLAS, XLA:CPU), and on the
# card the flash kernel keeps the prefill's attention logits and
# probabilities in float32 where the plain version rounds them to bf16;
# each such difference moves a hidden value by a bf16 ulp, and 16 layers
# carry them to the logits.
# * SERVE_LOGIT_TOL: the card against JAX_SERVE (sampled logits, maxima,
#   log-sum-exps, the logit of JAX's token at each teacher-forced step):
#   2 ulps at the top of the range (measured 0.031, one ulp, on the CPU
#   by ``tests/test_torch_serve_reference.py --port`` and on an H100);
# * JAX_MARGIN_TOL: an argmax or a greedy token may differ from JAX's where
#   JAX's top-1/top-2 margin is within twice that (each of the two logits
#   may move by the tolerance);
# * SERVE_PREFILL_TOL: every logit of the 4 x 512 prefill with all kernels
#   against the same step on the plain versions: the largest of 263 M
#   differences, 4 ulps at the top of the range (measured 0.084 on an
#   H100);
# * SERVE_MARGIN_TOL: the generation (the plain cache attention) against
#   ``forward`` (the flash kernel) on its own tokens differs as the prefill
#   with and without the kernels does, so a greedy token may differ from
#   forward's argmax where the margin is within twice SERVE_PREFILL_TOL
#   (measured on an H100: the generation's logits within 0.074 of
#   forward's; its tokens differ from forward's argmax only at exact ties).
SERVE_LOGIT_TOL = 0.0625
JAX_MARGIN_TOL = 2 * SERVE_LOGIT_TOL
SERVE_PREFILL_TOL = 0.125
SERVE_MARGIN_TOL = 2 * SERVE_PREFILL_TOL


def exact_worst_line(trace, bank) -> float:
    """The largest spec line of a whole campus trace at the bank's bins, from
    a float64 FFT of the Hann-windowed trace: what the streaming line bank
    (``compliance.SpectrumObserver``) computes chunk by chunk."""
    import numpy as np

    x = np.asarray(trace.detach().cpu() if hasattr(trace, "detach") else trace, np.float64)
    n = x.shape[0]
    assert bank.modulus == n and bank.window == "hann", (bank.modulus, n, bank.window)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    bins = np.asarray(bank.bins, np.int64)
    scale = np.where((n % 2 == 0) & (bins == n // 2), 1.0, 2.0)
    return float(np.max(np.abs(np.fft.rfft(x * w))[bins] * scale) / (n * np.mean(w)))


def serve_prompts(vocab_size: int, batch: int, length: int, seed: int):
    """Prompt token ids, ``(batch, length)`` int32, from numpy (both packages
    get the same ids)."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, vocab_size, (batch, length)).astype(np.int32)


def _top2_margin(logits):
    """Top-1 minus top-2 logit over the last axis (float64)."""
    import numpy as np

    top2 = np.partition(np.asarray(logits, np.float64), -2, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _logit_summary(row, ids, fed=None) -> dict:
    """Argmax, top-2 margin, max, log-sum-exp and the logits at ``ids`` of
    one ``(V,)`` row of logits, and the logit of token ``fed`` if given."""
    import numpy as np

    row = np.asarray(row, np.float64)
    m = float(row.max())
    out = {"argmax": int(row.argmax()), "margin": float(_top2_margin(row)), "max": m,
           "lse": m + float(np.log(np.sum(np.exp(row - m)))), "at_ids": [float(row[i]) for i in ids]}
    if fed is not None:
        out["at_fed"] = float(row[fed])
    return out


def serve_summary(prefill_logits, tokens, step_logits, fed, ref: dict = SERVE_REF) -> dict:
    """The numbers of a SERVE_REF run that the check compares (either
    package; numpy arrays): ``prefill_logits (R, T0, V)`` of the prefill
    step, ``tokens (R, T0 + n)`` of the greedy generation, and ``step_logits
    (R, n, V)``, the decode step's last-position logits at each generated
    position with the tokens ``fed (R, n)`` fed back (JAX's, on both sides).
    Each prefill row and each step keeps its argmax, top-2 margin, max,
    log-sum-exp and the logits at seven fixed ids spread over the
    vocabulary; each step also the logit of the token fed at it.  ``ref``
    is SERVE_REF or RWKV_SERVE_REF."""
    import numpy as np

    t0 = ref["prompt_len"]
    v = prefill_logits.shape[-1]
    ids = [int(f * (v - 1)) for f in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0)]
    rows = [_logit_summary(prefill_logits[r, pos], ids) for r, pos in ref["rows"]]
    fed = np.asarray(fed)
    steps = [[_logit_summary(step_logits[r, p], ids, int(fed[r, p])) for p in range(fed.shape[1])]
             for r in range(fed.shape[0])]
    return {"rows": rows, "steps": steps, "tokens": np.asarray(tokens)[:, t0:].tolist()}


def _compare_logits(g: dict, w: dict, what: str, tol: float, margin_tol: float) -> list[str]:
    bad = []
    if w["margin"] > margin_tol and g["argmax"] != w["argmax"]:
        bad.append(f"{what}: argmax {g['argmax']} != {w['argmax']} (margin {w['margin']:.4f})")
    for k in ("max", "lse", "at_fed"):
        if k in w and not abs(g[k] - w[k]) <= tol:
            bad.append(f"{what}: {k} {g[k]!r} vs {w[k]!r}")
    for j, (a, b) in enumerate(zip(g["at_ids"], w["at_ids"])):
        if not abs(a - b) <= tol:
            bad.append(f"{what}: logit {j} {a!r} vs {b!r}")
    return bad


def serve_max_diff(got: dict, want: dict) -> float:
    """Largest |got - want| over the compared logits (maxima, log-sum-exps,
    sampled ids and the fed tokens' logits) of the rows and steps."""
    pairs = list(zip(got["rows"], want["rows"]))
    pairs += [p for gs, ws in zip(got["steps"], want["steps"]) for p in zip(gs, ws)]
    keys = lambda d: d["at_ids"] + [d["max"], d["lse"]] + ([d["at_fed"]] if "at_fed" in d else [])
    return max(abs(a - b) for g, w in pairs for a, b in zip(keys(g), keys(w)))


def compare_serve(got: dict, want: dict, tol: float = SERVE_LOGIT_TOL,
                  margin_tol: float = JAX_MARGIN_TOL,
                  free_steps=frozenset()) -> tuple[list[str], int]:
    """Failures of ``got`` against ``want`` under the logit tolerance
    ``tol`` and the margin tolerance ``margin_tol`` (by default
    SERVE_LOGIT_TOL and JAX_MARGIN_TOL), and the number of generated positions whose greedy
    tokens were left uncompared.  Every prefill row and every teacher-forced
    step is compared (its argmax where ``want``'s top-2 margin exceeds the
    margin tolerance).  The free-running greedy tokens
    are walked request by request: where ``want``'s margin exceeds the
    tolerance and the ``(request, step)`` is not in ``free_steps`` (a
    token whose MoE routing may differ: ``compare_routing``) they must
    agree; elsewhere they may differ, and if they do, the two runs
    continue from different contexts and the rest of the request's tokens
    are not compared (its teacher-forced steps still are)."""
    bad = []
    for i, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        bad += _compare_logits(g, w, f"row {i}", tol, margin_tol)
    for r, (gs, ws) in enumerate(zip(got["steps"], want["steps"])):
        for p, (g, w) in enumerate(zip(gs, ws)):
            bad += _compare_logits(g, w, f"request {r} step {p}", tol, margin_tol)
    skipped = 0
    for r, (gt, wt, ws) in enumerate(zip(got["tokens"], want["tokens"], want["steps"])):
        for p, (a, b, w) in enumerate(zip(gt, wt, ws)):
            if a == b:
                continue
            if w["margin"] > margin_tol and (r, p) not in free_steps:
                bad.append(f"request {r}: token {p} is {a}, JAX {b} (margin {w['margin']:.4f})")
            skipped += len(gt) - p - 1
            break
    return bad, skipped


# The training slice (phases 7-8): llama3.2-1b at full width, bf16,
# remat="block", 16 layers, weights ``convert.random_lm_tree(cfg, 0)`` (the
# serving phase's tree), AdamW(lr=1e-3) with its default weight decay 0.1,
# 4 x 512 tokens of ``SyntheticLMDataset`` per step.  The schedule warms up
# in one step (``total_steps=10, warmup_steps=1``): with the default 100
# warm-up steps the first steps' lr would be ~1e-5, under half a bf16 ulp of
# every weight, and no parameter would move.
TRAIN = dict(arch="llama3_2_1b", seed=0, batch=4, seq_len=512, lr=1e-3, total_steps=10,
             warmup_steps=1, steps=3, power_steps=4)
# What tests/test_torch_train_reference.py runs through the JAX package on
# the CPU and what the card's run is held to: the same at 2 layers (full
# width; a full-depth step through the JAX package on the CPU would hold
# ~20 GB of weights, moments and gradients), 2 x 64 tokens, 2
# steps: each step's loss and grad norm, and after the last step 16
# sampled elements of the updated parameters and of the first moment after
# each step, of the embedding, block 0's wq and ln1 scale, and ln_f.
TRAIN_REF = dict(n_layers=2, batch=2, seq_len=64, steps=2, samples=16, sample_seed=5)
TRAIN_LEAVES = ("embed.embedding", "blocks.attn.wq.kernel", "blocks.ln1.scale", "ln_f.scale")

# Tolerances of the training comparisons, with their reasons.  A step's
# gradients are bf16 (the parameters' type), summed in other orders by the
# two packages (and, on the card, through the flash kernels, which keep the
# attention probabilities in float32 where the plain versions round them to
# bf16); each such difference moves a gradient element by about a bf16 ulp
# (2^-8 relative) of the larger terms it sums.
# * loss: a mean over 128 (JAX_TRAIN) or 2048 (kernels vs plain) tokens of
#   float32 cross entropies from bf16 logits that differ by an ulp or two
#   (0.03-0.06 at the top of the logit range, SERVE_LOGIT_TOL), mostly
#   averaging out: 5e-3 absolute (measured against JAX_TRAIN: 3.3e-3 by the
#   port on the CPU, 1.8e-3 on an H100; kernels vs plain 1.5e-4);
# * grad_norm: the root of a sum of 1.2 B (0.4 B) squares of such
#   gradients: 5e-3 relative (measured 9.5e-4 against JAX_TRAIN, 2.1e-4
#   kernels vs plain);
# * the first moment m = 0.1 g (clipped): 2^-5 of the leaf's largest
#   sampled |m|, a few bf16 ulps of the leaf's largest gradient (measured
#   2^-6 against JAX_TRAIN, 0.007 kernels vs plain);
# * updated parameters: AdamW's first steps move an element by about
#   lr * u with u = m / sqrt(v) of size ~1 (+ decay), ~8 bf16 ulps of a
#   weight of ~0.02.  Where the element's moment is clear of zero at every
#   step (beyond ``grad_margin``, 4x the moment tolerance, of the leaf's
#   largest), the two u differ by a fraction (measured 0.019 on the CPU
#   for TRAIN_REF, where the moments differed by 1 %): the parameters must
#   agree to 2 bf16 ulps of the value (rounding after each update) plus
#   ``update_frac`` = 1/8 of lr per step.  Elsewhere a gradient within its
#   noise of zero can flip u's sign: 2 lr per step.
TRAIN_TOL = dict(loss=5e-3, grad_norm=5e-3, m=2.0**-5, grad_margin=2.0**-3, param_ulps=2,
                 update_frac=2.0**-3)

# The JAX package's numbers for TRAIN_REF (llama3.2-1b at full width with 2
# layers, bf16, weights ``random_lm_tree(cfg, 0)``), on the CPU (jax 0.9.0),
# printed by ``python tests/test_torch_train_reference.py``.
JAX_TRAIN = {'loss': [12.154769897460938, 12.04736328125],
 'grad_norm': [35.166812896728516, 37.876102447509766],
 'params': {'embed.embedding': [-0.0286865234375, 0.0037994384765625, -0.0262451171875,
                                -0.0135498046875, -0.0184326171875, -0.008056640625, 0.011962890625,
                                -0.0230712890625, 0.0037689208984375, 0.02587890625, 0.02490234375,
                                -0.0213623046875, 0.021484375, 0.027099609375, 0.039794921875,
                                0.0106201171875],
            'blocks.attn.wq.kernel': [-0.04541015625, -0.01312255859375, -0.02392578125,
                                      -0.0274658203125, -0.0057373046875, -0.017333984375,
                                      0.01092529296875, -0.01361083984375, 0.00811767578125,
                                      0.009521484375, 0.034423828125, 0.006988525390625,
                                      0.005767822265625, 0.01513671875, -0.00183868408203125,
                                      0.032470703125],
            'blocks.ln1.scale': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                                 1.0, 1.0, 1.0],
            'ln_f.scale': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                           1.0, 1.0]},
 'm': [{'embed.embedding': [-1.0296589358915753e-08, 5.084735743565716e-09, -1.8389792799666793e-08,
                            -1.6949117664921687e-09, -1.2033874341454975e-08,
                            -6.016937170727488e-09, -1.3400396348117738e-09, -9.152524071964763e-09,
                            -7.288120773552009e-09, 3.898297240567672e-09, -1.2627093148864788e-08,
                            1.072031707849419e-08, 1.072031707849419e-08, -2.0084703677980542e-08,
                            -7.711848937219656e-09, 8.262694528582415e-09],
        'blocks.attn.wq.kernel': [3.124061549897306e-05, -1.2930143384437542e-05,
                                  -4.382363840704784e-06, -3.4277895792911295e-06,
                                  3.322027168906061e-07, 7.506424935854739e-06,
                                  9.068456165550742e-06, 4.794566393684363e-06,
                                  1.6140984371304512e-05, -4.94643063575495e-06,
                                  8.200661795854103e-06, -2.399995082669193e-07,
                                  4.122025529795792e-06, -5.938970843999414e-07,
                                  -2.7769435746449744e-06, 4.577617801260203e-06],
        'blocks.ln1.scale': [-2.6554522264632396e-05, 3.1067054806044325e-05, 1.562030774948653e-05,
                             8.504389370500576e-06, -9.198624866257887e-06, 6.725410003127763e-06,
                             9.068456165550742e-06, 1.5967425497365184e-05, 7.3328665166627616e-06,
                             3.575314985937439e-05, 1.5012849871709477e-05, 1.1888789231306873e-05,
                             -2.5339608328067698e-05, -6.334902082016924e-06, -4.29558440373512e-06,
                             -5.5191754654515535e-05],
        'ln_f.scale': [5.119989509694278e-06, -5.814225460198941e-06, 4.6860923248459585e-06,
                       3.0806718314124737e-06, -2.3213513031805633e-06, 1.1454892046458554e-05,
                       -5.380328275350621e-06, -9.632522960600909e-06, -1.1194553735549562e-05,
                       9.198624866257887e-06, -1.7529455362819135e-05, 4.122025529795792e-06,
                       4.208804966765456e-06, 2.559994754847139e-06, -1.0890825251408387e-05,
                       1.2496245290094521e-05]},
       {'embed.embedding': [-2.5788142732352526e-09, 4.769493244793921e-08, -1.658462167597463e-08,
                            -2.1730393873209408e-10, -2.129541876172425e-08, 4.734954650587042e-09,
                            3.4363032419548745e-09, -3.2955874140760955e-10,
                            -1.2539270066724839e-08, 2.210186256235147e-09, -4.220840210678034e-08,
                            2.231636209160115e-08, 6.186201773061839e-09, -1.395284665584029e-09,
                            -1.4848376750364878e-08, 1.782267489147671e-08],
        'blocks.attn.wq.kernel': [2.179164221161045e-05, -8.998392331704963e-06,
                                  -1.7988946865443722e-06, -6.126607786427485e-06,
                                  2.5147157884930493e-06, -1.6771276932558976e-05,
                                  1.4204519175109453e-05, 2.129590939148329e-06,
                                  1.2170151421742048e-05, -1.8734796185526648e-06,
                                  4.298711701267166e-06, 6.310342541837599e-06,
                                  6.247844794415869e-06, 2.366089120187098e-06,
                                  -1.0086648671858711e-06, -2.003625013458077e-06],
        'blocks.ln1.scale': [-7.836582517484203e-05, 1.0959631254081614e-05, 1.220511785504641e-05,
                             3.6656304018833907e-06, 1.3898923043598188e-06, 5.0206388550577685e-05,
                             1.4929668395780027e-05, -4.160905064054532e-06, -7.339397143368842e-06,
                             -1.616543704585638e-05, 1.8063889001496136e-05,
                             -2.4107244826154783e-05, -3.10240029648412e-05,
                             -2.9228471248643473e-05, 7.0917826633376535e-06,
                             -6.087210203986615e-05],
        'ln_f.scale': [7.891304449003655e-06, -1.3572016541729681e-05, -1.640897971810773e-05,
                       2.2754489691578783e-05, 8.30458702694159e-06, 6.1196519709483255e-06,
                       1.2811856322514359e-06, -1.0522428965487052e-05, -8.554299711249769e-06,
                       -1.5510365756199462e-06, -1.1123843250970822e-06, -3.461095275270054e-06,
                       -2.577273335191421e-06, 7.057750281092012e-06, -9.295648851548322e-06,
                       1.7088099411921576e-05]}]}


# The ssm serving slice (phases 9-10): rwkv6-7b at full width (32 layers,
# d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536 untied, bf16; 7.5 B
# parameters), random weights drawn on the card by ``transformer.init``
# from a ``torch.Generator`` seeded with RWKV["seed"] (a float32 numpy tree
# of that size would take ~30 GB of host memory).  Prefill: 4 prompts x
# 512 tokens; generation: 4 requests, 64-token prompts, 32 greedy tokens.
RWKV = dict(arch="rwkv6_7b", seed=0, prompt_seed=1, prefill=(4, 512), gen=(4, 64),
            gen_tokens=32)
# What tests/test_torch_rwkv6_serve_reference.py runs through the JAX package
# on the CPU and what the card's run is held to: the same width cut to 4
# layers, weights ``convert.random_lm_tree(cfg, RWKV["seed"])`` (~5.6 GB of
# float32), as SERVE_REF: 2 prompts x 64 tokens, the prefill rows, 8 greedy
# tokens and the teacher-forced decode logits at each of them.
RWKV_SERVE_REF = dict(SERVE_REF, n_layers=4, prompt_seed=RWKV["prompt_seed"])
# The JAX package's numbers for RWKV_SERVE_REF (bf16), on the CPU (jax
# 0.9.0), printed by ``python tests/test_torch_rwkv6_serve_reference.py``.
JAX_RWKV_SERVE = {'rows': [{'argmax': 65141,
                            'at_ids': [0.4140625, 0.9765625, -2.234375, -0.51953125, -0.380859375,
                                       0.275390625, -0.08447265625],
                            'lse': 11.556984921313276,
                            'margin': 0.5,
                            'max': 4.28125},
                           {'argmax': 53382,
                            'at_ids': [0.99609375, 0.55078125, -0.369140625, -1.1640625, -0.6171875,
                                       0.5234375, -0.10986328125],
                            'lse': 11.547920210193526,
                            'margin': 0.234375,
                            'max': 3.9375},
                           {'argmax': 164,
                            'at_ids': [2.5625, -0.97265625, -0.421875, 0.232421875, 1.046875,
                                       0.671875, -0.0205078125],
                            'lse': 11.551289348189295,
                            'margin': 0.15625,
                            'max': 3.859375},
                           {'argmax': 10899,
                            'at_ids': [-0.50390625, 0.1953125, 0.39453125, -0.1962890625,
                                       0.73046875, -0.255859375, 0.6796875],
                            'lse': 11.548107348426527,
                            'margin': 0.234375,
                            'max': 4.0625},
                           {'argmax': 46687,
                            'at_ids': [1.5, -1.375, -1.6640625, 0.13671875, -0.369140625, 1.265625,
                                       0.34375],
                            'lse': 11.556398042867066,
                            'margin': 0.109375,
                            'max': 4.0625}],
                  'steps': [[{'argmax': 164,
                              'at_fed': 3.859375,
                              'at_ids': [2.5625, -0.97265625, -0.421875, 0.232421875, 1.046875,
                                         0.671875, -0.0205078125],
                              'lse': 11.551289348189295,
                              'margin': 0.15625,
                              'max': 3.859375},
                             {'argmax': 36171,
                              'at_fed': 4.21875,
                              'at_ids': [0.1513671875, 0.09521484375, -0.546875, -0.2255859375,
                                         -0.8125, 0.462890625, 0.87890625],
                              'lse': 11.555668418951095,
                              'margin': 0.0,
                              'max': 4.21875},
                             {'argmax': 12562,
                              'at_fed': 4.15625,
                              'at_ids': [-0.1025390625, 0.96484375, -1.4609375, 0.8984375,
                                         -0.08154296875, 0.5078125, 0.0223388671875],
                              'lse': 11.552363311847534,
                              'margin': 0.15625,
                              'max': 4.15625},
                             {'argmax': 25068,
                              'at_fed': 4.75,
                              'at_ids': [-0.77734375, 0.68359375, 0.1533203125, 0.44921875,
                                         0.671875, 0.34375, -0.53515625],
                              'lse': 11.56002977551505,
                              'margin': 0.828125,
                              'max': 4.75},
                             {'argmax': 26000,
                              'at_fed': 4.125,
                              'at_ids': [2.09375, 1.0234375, -1.140625, -0.796875, 1.3828125,
                                         1.2265625, 0.220703125],
                              'lse': 11.552600692583345,
                              'margin': 0.03125,
                              'max': 4.125},
                             {'argmax': 16024,
                              'at_fed': 4.3125,
                              'at_ids': [0.9765625, 0.4921875, 0.56640625, 0.3828125, -0.5,
                                         1.3828125, -0.7265625],
                              'lse': 11.560096478205729,
                              'margin': 0.21875,
                              'max': 4.3125},
                             {'argmax': 9498,
                              'at_fed': 4.375,
                              'at_ids': [-0.1806640625, -1.578125, -1.578125, 0.53125, -1.453125,
                                         1.921875, 0.75],
                              'lse': 11.551906069828991,
                              'margin': 0.28125,
                              'max': 4.375},
                             {'argmax': 23209,
                              'at_fed': 3.890625,
                              'at_ids': [-0.404296875, 2.125, -2.546875, -0.5859375, 0.025390625,
                                         -1.296875, 0.474609375],
                              'lse': 11.561280672044113,
                              'margin': 0.015625,
                              'max': 3.890625}],
                            [{'argmax': 46687,
                              'at_fed': 4.0625,
                              'at_ids': [1.5, -1.375, -1.6640625, 0.13671875, -0.369140625,
                                         1.265625, 0.34375],
                              'lse': 11.556398042867066,
                              'margin': 0.109375,
                              'max': 4.0625},
                             {'argmax': 32591,
                              'at_fed': 4.71875,
                              'at_ids': [1.109375, -0.84765625, -0.640625, 0.9140625, 1.5,
                                         1.1796875, 0.74609375],
                              'lse': 11.557554292913274,
                              'margin': 0.34375,
                              'max': 4.71875},
                             {'argmax': 38168,
                              'at_fed': 3.90625,
                              'at_ids': [0.38671875, 0.4921875, -0.255859375, -1.390625,
                                         0.0283203125, 0.7265625, -0.8203125],
                              'lse': 11.549035166011372,
                              'margin': 0.109375,
                              'max': 3.90625},
                             {'argmax': 3292,
                              'at_fed': 4.625,
                              'at_ids': [0.8515625, -0.83203125, -2.1875, 0.259765625, -0.82421875,
                                         0.1513671875, -0.333984375],
                              'lse': 11.557626228836785,
                              'margin': 0.59375,
                              'max': 4.625},
                             {'argmax': 42921,
                              'at_fed': 3.8125,
                              'at_ids': [0.76171875, -1.0546875, -1.5, -0.93359375, -1.3203125,
                                         0.80078125, 0.71875],
                              'lse': 11.543500242470522,
                              'margin': 0.265625,
                              'max': 3.8125},
                             {'argmax': 11079,
                              'at_fed': 4.0,
                              'at_ids': [0.2421875, -1.109375, -0.14453125, -0.83203125,
                                         -0.326171875, 0.4375, 1.546875],
                              'lse': 11.56081022043342,
                              'margin': 0.21875,
                              'max': 4.0},
                             {'argmax': 50568,
                              'at_fed': 4.09375,
                              'at_ids': [-0.1982421875, -1.2265625, -1.265625, 1.0859375, 0.3515625,
                                         0.73828125, -0.6015625],
                              'lse': 11.561809781813201,
                              'margin': 0.15625,
                              'max': 4.09375},
                             {'argmax': 31296,
                              'at_fed': 3.953125,
                              'at_ids': [-0.4921875, -0.0732421875, -0.90625, 2.28125, 0.4375,
                                         -0.46875, 2.84375],
                              'lse': 11.557891978921273,
                              'margin': 0.140625,
                              'max': 3.953125}]],
                  'tokens': [[164, 36171, 12562, 25068, 26000, 16024, 9498, 23209],
                             [46687, 32591, 38168, 3292, 42921, 11079, 50568, 31296]]}

# Tolerances of the card's full-width bf16 rwkv6-7b serving run, with their
# reasons.  The logits are the untied head's bf16 outputs, ~N(0, 1) with
# maxima ~4.5 (one bf16 ulp is 2^-5 = 0.031 at the top of the range, 2^-7
# near 1).  The two packages round at the same points, but an RWKV-6 layer
# chains more bf16 roundings than a llama layer (the token-shift mixes,
# the LoRAs, the gates), each of which may land an ulp apart where the
# bf16 products are summed in other orders, so the hidden state differs by
# more than the readout's last ulp.
# * RWKV_LOGIT_TOL: the card against JAX_RWKV_SERVE (4 layers; sampled
#   logits, maxima, log-sum-exps, the logit of JAX's token at each
#   teacher-forced step): 0.125, twice the largest difference of the port
#   on the CPU (0.0625, ``tests/test_torch_rwkv6_serve_reference.py
#   --port``; median 0.013) and on an H100 (0.0625), where the prompt
#   runs the sequential kernel and JAX the chunked plain form;
# * RWKV_MARGIN_TOL: argmaxes and greedy tokens may differ from JAX's where
#   its top-1/top-2 margin is within twice that;
# * RWKV_BLOCK_ULPS: each of the 32 blocks alone, fed the kernel run's
#   input to it, on the kernels against the plain versions (sequential
#   scan): max|diff| within 4 bf16 ulps of the block output's largest
#   value.  The rmsnorm kernel moves some of ln1's and ln2's bf16 outputs
#   by an ulp, which moves every GEMM output of the block by up to an ulp,
#   and the scan's o is rounded once on each side; the block's output sums
#   the residual, the time mix and the channel mix, each rounded.  On an
#   H100 up to 2 ulps, 4 is twice that; the chunked plain form against
#   the sequential one differs by up to 1 (no kernel involved);
# * RWKV_PREFILL_TOL: every logit of the 4 x 512 prefill (32 layers) with
#   the kernels against the same step on the plain versions (chunked and
#   sequential scan), and the generation's logits against ``forward``'s:
#   0.75, 24 ulps at the top of the range, 1.6 times the floor that the
#   stack sets with no kernel involved.  The random-weight 32-layer stack
#   amplifies a rounding difference: on an H100 the two plain runs, which
#   differ only in the scan's float32 summation order, have layer-0
#   states 8.8e-7 apart relative, layer 1's 1.8e-3 (an ulp flipped at a
#   bf16 rounding point), layer 31's 1.8e-2, and logits 0.469 apart; the
#   kernels against either plain run read 0.461 (chunked) and 0.346
#   (sequential), within that floor, and the generation (GEMMs of other
#   shapes) differs from forward by 0.356.  This is a gross-error gate;
#   RWKV_BLOCK_ULPS and RWKV_LOGIT_TOL hold the layers tightly.
RWKV_LOGIT_TOL = 0.125
RWKV_MARGIN_TOL = 2 * RWKV_LOGIT_TOL
RWKV_PREFILL_TOL = 0.75
RWKV_BLOCK_ULPS = 4


def train_indices(shape, leaf: int):
    """``TRAIN_REF["samples"]`` flat indices into a leaf of ``shape`` (layer
    0's slice for block leaves; all of a smaller leaf's), from numpy."""
    import numpy as np

    n = int(np.prod(shape))
    rng = np.random.default_rng(TRAIN_REF["sample_seed"] + leaf)
    return np.sort(rng.choice(n, size=min(TRAIN_REF["samples"], n), replace=False))


def train_samples(leaf_array, leaves=TRAIN_LEAVES) -> dict:
    """``{path: values at train_indices}`` of a JAX-layout tree's
    ``leaves`` (numpy, float64), given ``leaf_array(path)`` -> that leaf
    (layer 0 for block leaves) as a numpy array."""
    import numpy as np

    out = {}
    for i, path in enumerate(leaves):
        a = np.asarray(leaf_array(path), np.float64)
        out[path] = a.reshape(-1)[train_indices(a.shape, i)].tolist()
    return out


def train_summary(losses, grad_norms, params: dict, moments: list[dict]) -> dict:
    """The numbers of a training run that the checks compare (either
    package): each step's loss and grad norm, sampled updated parameters,
    and the sampled first moment after each step (``train_samples``)."""
    return {"loss": [float(x) for x in losses], "grad_norm": [float(x) for x in grad_norms],
            "params": params, "m": moments}


def _ulp(x: float, bits: int) -> float:
    """The spacing of a ``bits``-bit significand at ``x`` (8: bf16, 24:
    float32)."""
    import math

    return 2.0 ** (math.floor(math.log2(abs(x))) - bits + 1) if x else 2.0 ** (-126 - bits + 1)


def _bf16_ulp(x: float) -> float:
    return _ulp(x, 8)


def compare_train(got: dict, want: dict, lr: float, tol: dict = TRAIN_TOL,
                  leaves=TRAIN_LEAVES) -> list[str]:
    """Failures of ``got`` against ``want`` under ``tol`` (TRAIN_TOL: see
    there; ``ulp_bits`` the significand of the parameters' type, 8 if
    absent) on the sampled ``leaves``."""
    t = tol
    ulp = lambda x: _ulp(x, t.get("ulp_bits", 8))
    bad = []
    for i, (g, w) in enumerate(zip(got["loss"], want["loss"])):
        if not abs(g - w) <= t["loss"]:
            bad.append(f"step {i}: loss {g!r} vs {w!r}")
    for i, (g, w) in enumerate(zip(got["grad_norm"], want["grad_norm"])):
        if not abs(g - w) <= t["grad_norm"] * abs(w):
            bad.append(f"step {i}: grad norm {g!r} vs {w!r}")
    steps = len(want["m"])
    for path in leaves:
        wm = [m[path] for m in want["m"]]
        scale = max(abs(x) for ms in wm for x in ms) or 1.0
        for s, (gs, ws) in enumerate(zip((m[path] for m in got["m"]), wm)):
            for j, (a, b) in enumerate(zip(gs, ws)):
                if not abs(a - b) <= t["m"] * scale:
                    bad.append(f"{path}[{j}] step {s}: m {a!r} vs {b!r}")
        for j, (a, b) in enumerate(zip(got["params"][path], want["params"][path])):
            clear = all(abs(ms[j]) > t["grad_margin"] * scale for ms in wm)
            within = (t["param_ulps"] * ulp(b) + t["update_frac"] * lr * steps if clear
                      else 2 * lr * steps + ulp(b))
            if not abs(a - b) <= within:
                bad.append(f"{path}[{j}]: param {a!r} vs {b!r} (tolerance {within:.3g})")
    return bad


def train_max_diff(got: dict, want: dict, lr: float, tol: dict = TRAIN_TOL,
                   leaves=TRAIN_LEAVES) -> dict:
    """The largest differences that ``compare_train`` holds to its
    tolerances: loss (absolute), grad norm (relative), m (relative to the
    leaf's largest sampled |m|) and the parameters of clear gradient sign
    (in units of lr per step, beyond their ulps)."""
    t = tol
    ulp = lambda x: _ulp(x, t.get("ulp_bits", 8))
    out = {"loss": max(abs(g - w) for g, w in zip(got["loss"], want["loss"])),
           "grad_norm": max(abs(g - w) / abs(w)
                            for g, w in zip(got["grad_norm"], want["grad_norm"])),
           "m": 0.0, "update_frac": 0.0}
    for path in leaves:
        wm = [m[path] for m in want["m"]]
        scale = max(abs(x) for ms in wm for x in ms) or 1.0
        for gs, ws in zip((m[path] for m in got["m"]), wm):
            out["m"] = max([out["m"]] + [abs(a - b) / scale for a, b in zip(gs, ws)])
        for j, (a, b) in enumerate(zip(got["params"][path], want["params"][path])):
            if all(abs(ms[j]) > t["grad_margin"] * scale for ms in wm):
                beyond = max(abs(a - b) - t["param_ulps"] * ulp(b), 0.0)
                out["update_frac"] = max(out["update_frac"], beyond / (lr * len(wm)))
    return out


def _port_leaf(path: str) -> str:
    """The port's parameter name of layer 0 of the JAX-layout leaf
    ``path`` (``blocks.x`` -> ``blocks.0.x``, ``groups.x`` ->
    ``groups.0.0.x``; an unstacked leaf keeps its name)."""
    from repro_torch.models.transformer import STACK_DEPTH

    head, _, rest = path.partition(".")
    return ".".join([head] + ["0"] * STACK_DEPTH[head] + [rest]) if head in STACK_DEPTH else path


def port_train_reference(model, cfg, dev, ref: dict = TRAIN_REF, leaves=TRAIN_LEAVES) -> dict:
    """``ref``'s steps (TRAIN_REF, HYBRID_TRAIN_REF or WHISPER_TRAIN_REF:
    batch, seq_len, steps) through the port on ``model`` (whose parameters
    they update), AdamW and the schedule of TRAIN; ``train_summary`` of the
    run on the sampled ``leaves``."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    opt = AdamWConfig(lr=TRAIN["lr"])
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    step = build_train_step(cfg, opt, total_steps=TRAIN["total_steps"],
                            warmup_steps=TRAIN["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=TRAIN["seed"], batch=ref["batch"],
                                       seq_len=ref["seq_len"], vocab_size=cfg.vocab_size))
    host = lambda t: t.detach().to(torch.float32).cpu().numpy()
    losses, norms, moments = [], [], []
    for i in range(ref["steps"]):
        batch = ds.batch_at(i)
        if cfg.family == "audio":  # the reference loop's frames of step i
            from repro_torch.train.loop import audio_frames

            batch["frames"] = audio_frames(cfg, ref["batch"], i, dev)
        model, state, metrics = step(model, state, batch, i)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        moments.append(train_samples(lambda p: host(state.m[_port_leaf(p)]), leaves))
    sampled = train_samples(lambda p: host(params[_port_leaf(p)]), leaves)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
    return train_summary(losses, norms, sampled, moments)


def campus_summary(res, health_summary: dict) -> dict:
    """The scalars of a campus run that the check compares (either package:
    every field goes through ``float``/``bool`` of its value)."""
    import numpy as np

    f = lambda x: float(x)
    host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    soc = [float(v) for v in host(res.soc_mean)]
    rr, rg = res.report_rack, res.report_grid
    out = {
        "rack_max_ramp": f(rr.max_ramp), "grid_max_ramp": f(rg.max_ramp),
        "rack_worst_line": f(rr.worst_high_freq_mag), "grid_worst_line": f(rg.worst_high_freq_mag),
        "rack_worst_line_exact": exact_worst_line(res.campus_rack, res.bank),
        "grid_worst_line_exact": exact_worst_line(res.campus_grid, res.bank),
        "rack_ramp_ok": bool(rr.ramp_ok), "rack_spectrum_ok": bool(rr.spectrum_ok),
        "grid_ramp_ok": bool(rg.ramp_ok), "grid_spectrum_ok": bool(rg.spectrum_ok),
        "grid_ok": bool(rg.ok),
        "max_qp_residual": f(res.max_qp_residual),
        "campus_rack_mean": float(np.mean(host(res.campus_rack))),
        "campus_grid_mean": float(np.mean(host(res.campus_grid))),
        "soc_mean_min": min(soc), "soc_mean_max": max(soc), "soc_mean_last": soc[-1],
    }
    for k in ("efc_mean", "efc_max", "half_cycles_mean", "worst_dod", "fade_mean",
              "fade_max", "mean_soc"):
        out[k] = float(health_summary[k])
    return out


def compare_campus(got: dict, want: dict) -> list[str]:
    """Failures of ``got`` against ``want`` under CAMPUS_TOLERANCES."""
    bad = []
    for k in CAMPUS_VERDICTS:
        if got[k] != want[k]:
            bad.append(f"{k}: {got[k]} != {want[k]}")
    for k, (kind, tol) in CAMPUS_TOLERANCES.items():
        err = abs(got[k] - want[k])
        lim = tol * abs(want[k]) if kind == "rel" else tol
        if not err <= lim:
            bad.append(f"{k}: {got[k]!r} vs {want[k]!r} (|diff| {err:.3e} > {lim:.3e})")
    for side in ("rack", "grid"):
        line, exact = got[f"{side}_worst_line"], got[f"{side}_worst_line_exact"]
        if not abs(line - exact) <= BANK_REL_TOL * exact:
            bad.append(f"{side}_worst_line: streamed {line!r} vs exact DFT {exact!r}")
    return bad


def run_campus(n_racks: int, duration_s: float, *, device: str = "cuda", engine: str = "host",
               safemode: bool = False, mesh=None, **window):
    """The acceptance campus through the port's ``engine`` (``window``:
    further ``StreamOptions``, e.g. ``start_sample``, ``state``), supervised
    with the default ``SafeModeConfig`` if ``safemode``, its racks sharded
    over ``mesh`` if given; returns ``(result, health fleet summary, wall
    seconds)``."""
    import torch

    from repro_torch.core import compliance, fleet, health as hlt, pdu
    from repro_torch.power import scenario as SC

    c = CAMPUS
    s = SC.mixed_campus(n_racks, ARCHS, duration_s=duration_s, sample_hz=c["sample_hz"],
                        seed=c["seed"], fault_at_s=duration_s * 0.6,
                        noise_seed=c["noise_seed"], device=device)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, safemode=safemode,
                       device=device)
    spec = compliance.GridSpec.create(device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.condition(
        s, cfg, spec, engine=engine, qp_iters=c["qp_iters"], device=device, mesh=mesh,
        stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"], **window),
    )
    hsum = hlt.fleet_summary(res.health)  # reads back to the host
    if device != "cpu":
        torch.cuda.synchronize()
    return res, hsum, time.perf_counter() - t0


# The degraded-mode acceptance campus (phase 13), as
# benchmarks/paper_benches.py::bench_mixed_campus_faulty builds it: the
# CAMPUS fleet with no scripted fault window and clamped edge smoothing,
# a stochastic fault soup (ESS offline ~30 % of the time at steady state,
# rack power losses, sensor dropouts) sampled with seed 6, and a rack
# cascade injected over a tenth of the fleet from rack n // 3, starting at
# 60 % of the trace, 5 s of ripple and 20 s outages.  Conditioned by a
# degraded-mode PDU with qp_iters 30 and 4-interval chunks.
FAULTY_CAMPUS = dict(n_racks=1024, duration_s=88.0, sample_hz=200.0, seed=3, noise_seed=2,
                     sched_seed=6, qp_iters=30, chunk_intervals=4)

# The JAX package's numbers for FAULTY_CAMPUS: its host engine on the CPU
# (jax 0.9.0), printed by ``python tests/test_torch_faulty_campus_reference.py``.
JAX_FAULTY_CAMPUS = {
    'rack_max_ramp': 0.4151582717895508,
    'grid_max_ramp': 0.08859634399414062,
    'rack_worst_line_exact': 0.00021256112894012203,
    'grid_worst_line_exact': 0.00011539100426595775,
    'rack_ramp_ok': False,
    'rack_spectrum_ok': False,
    'grid_ramp_ok': True,
    'grid_spectrum_ok': False,
    'grid_ok': False,
    'campus_rack_mean': 0.6283449018839746,
    'campus_grid_mean': 0.5616183132288808,
    'ess_online_frac': [1.0,
                        0.9609375,
                        0.93359375,
                        0.90234375,
                        0.8720703125,
                        0.8505859375,
                        0.828125,
                        0.8173828125,
                        0.8076171875,
                        0.7900390625,
                        0.783203125,
                        0.7724609375,
                        0.7724609375,
                        0.765625,
                        0.7578125,
                        0.7412109375,
                        0.734375,
                        0.72265625],
    'rack_worst_line': 0.00021321636450011283,
    'grid_worst_line': 0.00011558195546967909,
    'soc_mean_min': 0.3992605209350586,
    'soc_mean_max': 0.4999118447303772,
    'soc_mean_last': 0.40299588441848755,
    'max_qp_residual': 0.004786832258105278,
}

# Tolerances of the port against JAX_FAULTY_CAMPUS, with their reasons (those
# of CAMPUS_TOLERANCES, less the wear fold, which this campus does not run):
# * the per-rack samples differ by ~1e-6 (erfinv/cos rounding); the fault
#   tables, the NaN positions, the bridged holds' sources and the ESS
#   weights are integer-exact, so the campus means differ as on the clean
#   campus: 1e-6 rack, 1e-5 grid, and the ramps 5e-5 /s;
# * exact spec lines: 1e-3 relative rack, 1e-2 grid (as CAMPUS_TOLERANCES);
# * QP residual 1e-3 relative and SoC means 1e-5 (ADMM sums in another
#   order on the card);
# * ess_online_frac and the verdicts are compared exactly: the availability
#   comes from integer tables and the finite guard from NaN positions.
FAULTY_CAMPUS_TOLERANCES = {
    "rack_max_ramp": ("abs", 5e-5),
    "grid_max_ramp": ("abs", 5e-5),
    "rack_worst_line_exact": ("rel", 1e-3),
    "grid_worst_line_exact": ("rel", 1e-2),
    "max_qp_residual": ("rel", 1e-3),
    "campus_rack_mean": ("abs", 1e-6),
    "campus_grid_mean": ("abs", 1e-5),
    "soc_mean_min": ("abs", 1e-5),
    "soc_mean_max": ("abs", 1e-5),
    "soc_mean_last": ("abs", 1e-5),
}


def faulty_campus(SC, FLT, n_racks: int, duration_s: float, **kw):
    """FAULTY_CAMPUS's scenario with its schedule attached, built by either
    package's ``scenario`` and ``faults`` modules (``kw``: the port's
    ``device``)."""
    c = FAULTY_CAMPUS
    hz = c["sample_hz"]
    s = SC.mixed_campus(n_racks, ARCHS, duration_s=duration_s, sample_hz=hz, seed=c["seed"],
                        fault_rack_fraction=0.0, edge_pad="clamp", noise_seed=c["noise_seed"],
                        **kw)
    proc = FLT.FaultProcess.create(
        rack_mtbf_s=duration_s * 4.0, rack_mttr_s=duration_s * 0.25,
        ess_mtbf_s=duration_s * 1.75, ess_mttr_s=duration_s * 0.75,
        sensor_mtbf_s=duration_s * 3.0, sensor_mttr_s=duration_s * 0.1)
    sched = FLT.sample_schedule(proc, n_racks, s.total_samples, hz, seed=c["sched_seed"], **kw)
    n_cas, lo = max(n_racks // 10, 1), n_racks // 3
    t0f, durf = int(0.6 * duration_s * hz), int(20.0 * hz)
    step = max(int(5.0 * hz) // max(n_cas - 1, 1), 1)
    sched = FLT.inject_episodes(sched, rack=[
        (lo + i, t0f + i * step, min(t0f + i * step + durf, s.total_samples))
        for i in range(n_cas)])
    return SC.attach_faults(s, sched)


def faulty_campus_summary(res, bank) -> dict:
    """The scalars of a degraded campus run that the check compares (either
    package, either engine); ``bank`` is the stream's spectrum bank (the
    one-shot engine's result has none).  Fields an engine does not return
    (the one-shot engine's SoC means and QP residual) are left out."""
    import numpy as np

    host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    rr, rg = res.report_rack, res.report_grid
    out = {
        "rack_max_ramp": float(rr.max_ramp), "grid_max_ramp": float(rg.max_ramp),
        "rack_worst_line_exact": exact_worst_line(res.campus_rack, bank),
        "grid_worst_line_exact": exact_worst_line(res.campus_grid, bank),
        "rack_ramp_ok": bool(rr.ramp_ok), "rack_spectrum_ok": bool(rr.spectrum_ok),
        "grid_ramp_ok": bool(rg.ramp_ok), "grid_spectrum_ok": bool(rg.spectrum_ok),
        "grid_ok": bool(rg.ok),
        "campus_rack_mean": float(np.mean(host(res.campus_rack))),
        "campus_grid_mean": float(np.mean(host(res.campus_grid))),
        "ess_online_frac": [float(v) for v in host(res.ess_online_frac)],
    }
    if res.bank is not None:
        out["rack_worst_line"] = float(rr.worst_high_freq_mag)
        out["grid_worst_line"] = float(rg.worst_high_freq_mag)
    if res.soc_mean is not None:
        soc = [float(v) for v in host(res.soc_mean)]
        out.update(soc_mean_min=min(soc), soc_mean_max=max(soc), soc_mean_last=soc[-1],
                   max_qp_residual=float(res.max_qp_residual))
    return out


def compare_faulty_campus(got: dict, want: dict) -> list[str]:
    """Failures of ``got`` against ``want`` under FAULTY_CAMPUS_TOLERANCES
    (the verdicts and ``ess_online_frac`` exactly)."""
    bad = [f"{k}: {got[k]} != {want[k]}" for k in CAMPUS_VERDICTS + ("ess_online_frac",)
           if got[k] != want[k]]
    for k, (kind, tol) in FAULTY_CAMPUS_TOLERANCES.items():
        if k not in got:
            continue
        err = abs(got[k] - want[k])
        lim = tol * abs(want[k]) if kind == "rel" else tol
        if not err <= lim:
            bad.append(f"{k}: {got[k]!r} vs {want[k]!r} (|diff| {err:.3e} > {lim:.3e})")
    for side in ("rack", "grid"):
        if f"{side}_worst_line" in got:
            line, exact = got[f"{side}_worst_line"], got[f"{side}_worst_line_exact"]
            if not abs(line - exact) <= BANK_REL_TOL * exact:
                bad.append(f"{side}_worst_line: streamed {line!r} vs exact DFT {exact!r}")
    return bad


def run_faulty_campus(n_racks: int, duration_s: float, engine: str, *, device: str = "cuda",
                      **window):
    """FAULTY_CAMPUS through the port's ``engine`` (``window``: further
    ``StreamOptions``); returns ``(result, its summary, wall seconds)``."""
    import torch

    from repro_torch.core import compliance, fleet, pdu
    from repro_torch.power import faults as FLT, scenario as SC

    c = FAULTY_CAMPUS
    s = faulty_campus(SC, FLT, n_racks, duration_s, device=device)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], degraded_mode=True, device=device)
    spec = compliance.GridSpec.create(device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.condition(s, cfg, spec, engine=engine, qp_iters=c["qp_iters"], device=device,
                          stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"],
                                                     **window))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bank = res.bank or compliance.make_bank(s.total_samples, cfg.sample_dt, float(spec.f_c))
    return res, faulty_campus_summary(res, bank), wall


# The safe-mode drill (phase 15b), the engine-level form of the reference's
# chaos drill (tests/test_chaos.py::test_fast_chaos_drill): FAULTY_CAMPUS
# conditioned with safemode=True (the default SafeModeConfig) from an
# initial state corrupted on racks that the schedule keeps online (no ESS,
# sensor or rack episode) through the first 12 controller intervals, at both
# the full size and the 64-rack, 30 s cut: the warm ADMM iterates x set to
# 1e12 on two racks (their solves diverge: the watchdog trips them), the SoC
# NaN on one and the LC filter state NaN on another (the sanitizer
# quarantines them), and the operator's ess_online override 0 on a fifth.
SAFEMODE_DRILL = dict(warm=(9, 41), soc_nan=18, lc_nan=27, offline=44)

# The JAX package's numbers for the drill: its host engine on the CPU
# (jax 0.9.0), printed by ``python tests/test_torch_safemode_campus_reference.py``.
JAX_SAFEMODE_DRILL = {'rack_max_ramp': 0.4151582717895508,
 'grid_max_ramp': 0.09058713912963867,
 'rack_worst_line_exact': 0.00021256112894012203,
 'grid_worst_line_exact': 0.00011567547373729067,
 'rack_ramp_ok': False,
 'rack_spectrum_ok': False,
 'grid_ramp_ok': True,
 'grid_spectrum_ok': False,
 'grid_ok': False,
 'campus_rack_mean': 0.6283449018839746,
 'campus_grid_mean': 0.5619212644123895,
 'ess_online_frac': [0.9990234375,
                     0.9599609375,
                     0.9326171875,
                     0.9013671875,
                     0.87109375,
                     0.849609375,
                     0.8271484375,
                     0.81640625,
                     0.806640625,
                     0.7890625,
                     0.7822265625,
                     0.771484375,
                     0.771484375,
                     0.7646484375,
                     0.7568359375,
                     0.740234375,
                     0.7333984375,
                     0.7216796875],
 'rack_worst_line': 0.00021321636450011283,
 'grid_worst_line': 0.00011560069106053561,
 'soc_mean_min': 0.39970704913139343,
 'soc_mean_max': 0.4999103248119354,
 'soc_mean_last': 0.4034321904182434,
 'max_qp_residual': 1.5155540704727173,
 'safemode_trace': [[0.99609375, 2.0, 2.0, 4.0, 0.0, 3.0],
                    [0.998046875, 2.0, 0.0, 4.0, 2.0, 3.0],
                    [1.0, 0.0, 0.0, 4.0, 4.0, 3.0],
                    [1.0, 0.0, 0.0, 4.0, 4.0, 3.0],
                    [1.0, 0.0, 0.0, 4.0, 4.0, 3.0]],
 'safemode_summary': {'n_normal': 1024,
                      'n_passthrough': 0,
                      'n_quarantined': 0,
                      'passthrough_racks': [],
                      'quarantined_racks': [],
                      'passthrough_entries': 2,
                      'quarantine_entries': 2,
                      'readmissions': 4,
                      'worst_resid_streak': 3}}


def safemode_drill_state(state, put):
    """``state`` with SAFEMODE_DRILL's corruption; ``put(leaf, index,
    value)`` returns a copy of ``leaf`` with ``value`` at ``index`` (either
    package's arrays; indices are numpy arrays)."""
    import numpy as np

    d = SAFEMODE_DRILL
    rows = lambda *r: np.asarray(r, np.int64)
    nan = float("nan")
    warm = state.qp_warm
    return state._replace(
        qp_warm=warm._replace(x=put(warm.x, (slice(None), rows(*d["warm"])), 1e12)),
        ess_state=state.ess_state._replace(soc=put(state.ess_state.soc, rows(d["soc_nan"]), nan)),
        filter_state=put(state.filter_state, rows(d["lc_nan"]), nan),
        ess_online=put(state.ess_online, rows(d["offline"]), 0.0),
    )


def safemode_drill_summary(res, bank) -> dict:
    """``faulty_campus_summary`` of a supervised run, with its
    ``safemode_trace`` rows and ``safemode_summary()`` (either package)."""
    import numpy as np

    host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    out = faulty_campus_summary(res, bank)
    out["safemode_trace"] = [[float(v) for v in row] for row in host(res.safemode_trace)]
    out["safemode_summary"] = res.safemode_summary()
    return out


def compare_safemode_drill(got: dict, want: dict) -> list[str]:
    """Failures of ``got`` against ``want``: ``compare_faulty_campus``, and
    the supervisor's trace rows and summary (modes, racks, counters)
    exactly."""
    bad = compare_faulty_campus(got, want)
    bad += [f"{k}: {got[k]} != {want[k]}" for k in ("safemode_trace", "safemode_summary")
            if got[k] != want[k]]
    return bad


def drill_online_racks(sched, n_intervals: int, k: int) -> list[int]:
    """The racks that ``sched`` (a port ``FaultSchedule``) keeps free of
    every episode (ESS, sensor, rack) over the first ``n_intervals``
    controller intervals of ``k`` samples."""
    import torch

    stop = n_intervals * k
    hit = torch.zeros(sched.ess_start.shape[0], dtype=torch.bool, device=sched.ess_start.device)
    for st, en in ((sched.ess_start, sched.ess_end), (sched.sensor_start, sched.sensor_end),
                   (sched.rack_start, sched.rack_end)):
        hit |= ((st < stop) & (en > st)).any(dim=1)
    return [int(r) for r in torch.nonzero(~hit).reshape(-1).cpu()]


def run_safemode_drill(n_racks: int, duration_s: float, engine: str, *, device: str = "cuda",
                       **window):
    """The drill through the port's ``engine`` (``window``: further
    ``StreamOptions``; without a ``state`` the run starts from the drilled
    initial state); returns ``(result, its summary, wall seconds)``."""
    import torch

    from repro_torch.core import compliance, fleet, pdu
    from repro_torch.power import faults as FLT, scenario as SC

    c = FAULTY_CAMPUS
    s = faulty_campus(SC, FLT, n_racks, duration_s, device=device)
    online = set(drill_online_racks(s.faults, 12, int(round(5.0 * c["sample_hz"]))))
    used = {*SAFEMODE_DRILL["warm"], SAFEMODE_DRILL["soc_nan"], SAFEMODE_DRILL["lc_nan"],
            SAFEMODE_DRILL["offline"]}
    _check(used <= online, f"safemode drill: racks {sorted(used - online)} are not online "
           "through the first 12 intervals")
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], degraded_mode=True, safemode=True,
                       device=device)
    if window.get("state") is None:
        def put(a, idx, v):
            a = a.clone()
            a[idx] = v
            return a

        window["state"] = safemode_drill_state(pdu.init_state(cfg, SC.render(s, 0, 1)[0]), put)
    spec = compliance.GridSpec.create(device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.condition(s, cfg, spec, engine=engine, qp_iters=c["qp_iters"], device=device,
                          stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"],
                                                     **window))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, safemode_drill_summary(res, res.bank), wall


# The grid region of phase 16a, as benchmarks/paper_benches.py::
# bench_grid_region builds it: 4 campuses x 256 racks of checkpoint stalls
# (a stall every 8 s, compute plateau, no comm wave), 200 s at 50 Hz, the
# default POI and mode bands, ``make_pdu(sample_dt=1/50)``, the scanned
# engine's defaults (qp_iters 30, 16-interval chunks); synchronized, then
# its staggered twin (campus c offset by c/4 of the stall period).
GRID_REGION = dict(n_campuses=4, n_racks=256, duration_s=200.0, sample_hz=50.0, qp_iters=30,
                   chunk_intervals=16)

# The JAX package's numbers for GRID_REGION, synchronized and staggered:
# its region composed from pieces that run on jax 0.9.0 (each campus through
# the scanned ``fleet.condition``, the POI summed left to right,
# ``grid._poi_fold`` and ``grid._assemble_region_result``) on the CPU,
# printed by ``python tests/test_torch_grid_region_reference.py``.
JAX_GRID_REGION = {'synchronized': {'mode_mags': [0.014346247538924217, 0.0003370149352122098],
                                   'mode_mags_exact': [0.014285486031422337, 0.0003378028401011392],
                                   'mode_ok': [False, True],
                                   'modes_ok': False,
                                   'poi_max_ramp': 0.05616620182991028,
                                   'poi_rack_max_ramp': 3.3940017223358154,
                                   'poi_ramp_ok': True,
                                   'poi_spectrum_ok': True,
                                   'poi_ok': False,
                                   'max_freq_dev_hz': 0.13485008478164673,
                                   'max_volt_dev': 0.028554094955325127,
                                   'poi_grid_mean': 0.6715167226441204,
                                   'poi_rack_mean': 0.7198593588419259,
                                   'campuses': [{'rack_max_ramp': 3.4577994346618652,
                                                 'grid_max_ramp': 0.056164711713790894,
                                                 'rack_ramp_ok': False,
                                                 'rack_spectrum_ok': False,
                                                 'grid_ramp_ok': True,
                                                 'grid_spectrum_ok': True,
                                                 'grid_ok': True,
                                                 'campus_rack_mean': 0.7198652780100703,
                                                 'campus_grid_mean': 0.6715054398551583},
                                                {'rack_max_ramp': 3.462648391723633,
                                                 'grid_max_ramp': 0.05621574819087982,
                                                 'rack_ramp_ok': False,
                                                 'rack_spectrum_ok': False,
                                                 'grid_ramp_ok': True,
                                                 'grid_spectrum_ok': True,
                                                 'grid_ok': True,
                                                 'campus_rack_mean': 0.7198572585821151,
                                                 'campus_grid_mean': 0.6714757766887546},
                                                {'rack_max_ramp': 3.4481897354125977,
                                                 'grid_max_ramp': 0.056173279881477356,
                                                 'rack_ramp_ok': False,
                                                 'rack_spectrum_ok': False,
                                                 'grid_ramp_ok': True,
                                                 'grid_spectrum_ok': True,
                                                 'grid_ok': True,
                                                 'campus_rack_mean': 0.7198604618884623,
                                                 'campus_grid_mean': 0.6715195635780692},
                                                {'rack_max_ramp': 3.453092336654663,
                                                 'grid_max_ramp': 0.056111812591552734,
                                                 'rack_ramp_ok': False,
                                                 'rack_spectrum_ok': False,
                                                 'grid_ramp_ok': True,
                                                 'grid_spectrum_ok': True,
                                                 'grid_ok': True,
                                                 'campus_rack_mean': 0.7198544369496405,
                                                 'campus_grid_mean': 0.6715661110334098}]},
                  'staggered': {'mode_mags': [0.00016362612950615585, 1.7581861584403669e-06],
                                'mode_mags_exact': [3.690787813835106e-05, 1.3508824414405797e-07],
                                'mode_ok': [True, True],
                                'modes_ok': True,
                                'poi_max_ramp': 0.03512650728225708,
                                'poi_rack_max_ramp': 0.8911266922950745,
                                'poi_ramp_ok': True,
                                'poi_spectrum_ok': True,
                                'poi_ok': True,
                                'max_freq_dev_hz': 0.1580348163843155,
                                'max_volt_dev': 0.02808746136724949,
                                'poi_grid_mean': 0.6619964199826122,
                                'poi_rack_mean': 0.7075693835943937,
                                'campuses': [{'rack_max_ramp': 3.4577994346618652,
                                              'grid_max_ramp': 0.056164711713790894,
                                              'rack_ramp_ok': False,
                                              'rack_spectrum_ok': False,
                                              'grid_ramp_ok': True,
                                              'grid_spectrum_ok': True,
                                              'grid_ok': True,
                                              'campus_rack_mean': 0.7198652780100703,
                                              'campus_grid_mean': 0.6715054398551583},
                                             {'rack_max_ramp': 3.4735469818115234,
                                              'grid_max_ramp': 0.05618780851364136,
                                              'rack_ramp_ok': False,
                                              'rack_spectrum_ok': False,
                                              'grid_ramp_ok': True,
                                              'grid_spectrum_ok': True,
                                              'grid_ok': True,
                                              'campus_rack_mean': 0.711657291907072,
                                              'campus_grid_mean': 0.664964661718905},
                                             {'rack_max_ramp': 3.473508358001709,
                                              'grid_max_ramp': 0.05621127784252167,
                                              'rack_ramp_ok': False,
                                              'rack_spectrum_ok': False,
                                              'grid_ramp_ok': True,
                                              'grid_spectrum_ok': True,
                                              'grid_ok': True,
                                              'campus_rack_mean': 0.703460494659096,
                                              'campus_grid_mean': 0.6587324350871145},
                                             {'rack_max_ramp': 3.4711389541625977,
                                              'grid_max_ramp': 0.05624815821647644,
                                              'rack_ramp_ok': False,
                                              'rack_spectrum_ok': False,
                                              'grid_ramp_ok': True,
                                              'grid_spectrum_ok': True,
                                              'grid_ok': True,
                                              'campus_rack_mean': 0.6952944698646665,
                                              'campus_grid_mean': 0.652783144813776}]}}

# Tolerances of the port against JAX_GRID_REGION, with their reasons:
# * the campus means as CAMPUS_TOLERANCES (1e-6 rack, 1e-5 grid) and the
#   campus and POI ramps 5e-5 /s: the rendered samples differ by ~1e-6;
# * the mode magnitudes: the reference's float32 Goertzel bank drifts from
#   the exact DFT of its own POI at these sub-Hz lines by up to 1.27e-4
#   absolute (the staggered inter-area line reads 1.636e-4 against an exact
#   3.69e-5; synchronized 1.4346e-2 against 1.4285e-2), while the port's
#   lines stay within 2e-4 relative of theirs.  So the port's lines are held
#   to the exact float64 DFT of the JAX POI within 1e-3 relative plus 1e-8
#   (measured: 4e-5 relative, 7e-10 absolute), to the JAX bank's lines
#   within 2e-4 absolute, and to the exact DFT of their own POI within
#   BANK_REL_TOL plus 1e-9;
# * max |df| 2e-3 relative and max |dV| 1e-6 absolute: the swing model is
#   linear in the POI deviation, and both POI traces differ by ~1e-6;
# * every verdict exactly.
GRID_REGION_TOLERANCES = {
    "poi_max_ramp": ("abs", 5e-5),
    "poi_rack_max_ramp": ("abs", 5e-5),
    "max_freq_dev_hz": ("rel", 2e-3),
    "max_volt_dev": ("abs", 1e-6),
    "poi_grid_mean": ("abs", 1e-5),
    "poi_rack_mean": ("abs", 1e-6),
}
GRID_CAMPUS_TOLERANCES = {
    "rack_max_ramp": ("abs", 5e-5),
    "grid_max_ramp": ("abs", 5e-5),
    "campus_rack_mean": ("abs", 1e-6),
    "campus_grid_mean": ("abs", 1e-5),
}
MODE_JAX_EXACT_TOL = (1e-3, 1e-8)  # (relative, absolute) against the JAX POI's exact DFT
MODE_JAX_BANK_ABS = 2e-4  # against the JAX bank's streamed lines
MODE_EXACT_ABS = 1e-9  # beside BANK_REL_TOL against the port POI's own exact DFT
GRID_VERDICTS = ("mode_ok", "modes_ok", "poi_ramp_ok", "poi_spectrum_ok", "poi_ok")
GRID_CAMPUS_VERDICTS = ("rack_ramp_ok", "rack_spectrum_ok", "grid_ramp_ok", "grid_spectrum_ok",
                        "grid_ok")


def grid_region(grid, stagger: bool, n_racks: int, duration_s: float, **kw):
    """GRID_REGION's region (``stagger``: its staggered twin) at ``n_racks``
    a campus and ``duration_s``, built by either package's ``grid`` module
    (``kw``: the port's ``device``)."""
    c = GRID_REGION
    build = grid.staggered_region if stagger else grid.synchronized_region
    return build(n_campuses=c["n_campuses"], n_racks=n_racks, duration_s=duration_s,
                 sample_hz=c["sample_hz"], **kw)


def exact_band_lines(trace, bank, bands) -> list[float]:
    """Each band's largest line of a whole trace at the mode bank's bins,
    from a float64 FFT of the Hann-windowed trace (0 for a band with no
    line), as ``grid.mode_verdicts`` selects them."""
    import numpy as np

    x = np.asarray(trace.detach().cpu() if hasattr(trace, "detach") else trace, np.float64)
    n = x.shape[0]
    assert bank.modulus == n and bank.window == "hann", (bank.modulus, n, bank.window)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    bins = np.asarray(bank.bins, np.int64)
    scale = np.where((n % 2 == 0) & (bins == n // 2), 1.0, 2.0)
    mags = np.abs(np.fft.rfft(x * w))[bins] * scale / (n * np.mean(w))
    freqs = bins / (bank.modulus * bank.dt)
    out = []
    for b in bands:
        sel = (freqs >= b.lo_hz) & (freqs < b.hi_hz)
        out.append(float(mags[sel].max()) if sel.any() else 0.0)
    return out


def region_summary(res, reg, mbank) -> dict:
    """The scalars of a region run that the check compares (either package);
    ``mbank`` is the window's mode bank (``grid.mode_bank``)."""
    import numpy as np

    host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    rp, rr = res.report_poi, res.report_rack
    out = {
        "mode_mags": [float(v) for v in host(rp.mode_mags)],
        "mode_mags_exact": exact_band_lines(res.poi_grid, mbank, reg.bands),
        "mode_ok": [bool(v) for v in host(rp.mode_ok)],
        "modes_ok": bool(rp.modes_ok),
        "poi_max_ramp": float(rp.max_ramp), "poi_rack_max_ramp": float(rr.max_ramp),
        "poi_ramp_ok": bool(rp.ramp_ok), "poi_spectrum_ok": bool(rp.spectrum_ok),
        "poi_ok": bool(rp.ok),
        "max_freq_dev_hz": float(np.max(np.abs(host(res.poi_freq_dev)))),
        "max_volt_dev": float(np.max(np.abs(host(res.poi_volt_dev)))),
        "poi_grid_mean": float(np.mean(host(res.poi_grid))),
        "poi_rack_mean": float(np.mean(host(res.poi_rack))),
        "campuses": [],
    }
    for p in res.per_campus:
        r, g = p.report_rack, p.report_grid
        out["campuses"].append({
            "rack_max_ramp": float(r.max_ramp), "grid_max_ramp": float(g.max_ramp),
            "rack_ramp_ok": bool(r.ramp_ok), "rack_spectrum_ok": bool(r.spectrum_ok),
            "grid_ramp_ok": bool(g.ramp_ok), "grid_spectrum_ok": bool(g.spectrum_ok),
            "grid_ok": bool(g.ok),
            "campus_rack_mean": float(np.mean(host(p.campus_rack))),
            "campus_grid_mean": float(np.mean(host(p.campus_grid))),
        })
    return out


def _within(got: float, want: float, kind: str, tol: float) -> bool:
    return abs(got - want) <= (tol * abs(want) if kind == "rel" else tol)


def compare_region(got: dict, want: dict) -> list[str]:
    """Failures of ``got`` against ``want`` under GRID_REGION_TOLERANCES,
    GRID_CAMPUS_TOLERANCES, MODE_JAX_EXACT_TOL and MODE_JAX_BANK_ABS (every
    verdict exactly), and of ``got``'s mode lines against its exact DFT
    (BANK_REL_TOL plus MODE_EXACT_ABS)."""
    bad = [f"{k}: {got[k]} != {want[k]}" for k in GRID_VERDICTS if got[k] != want[k]]
    for k, (kind, tol) in GRID_REGION_TOLERANCES.items():
        if not _within(got[k], want[k], kind, tol):
            bad.append(f"{k}: {got[k]!r} vs {want[k]!r} (tolerance {kind} {tol:g})")
    rel, ab = MODE_JAX_EXACT_TOL
    for i, (g, x, w, wx) in enumerate(zip(got["mode_mags"], got["mode_mags_exact"],
                                          want["mode_mags"], want["mode_mags_exact"],
                                          strict=True)):
        if not abs(g - wx) <= rel * wx + ab:
            bad.append(f"mode_mags[{i}]: {g!r} vs the JAX POI's exact DFT {wx!r}")
        if not abs(g - w) <= MODE_JAX_BANK_ABS:
            bad.append(f"mode_mags[{i}]: {g!r} vs the JAX bank's {w!r}")
        if not abs(g - x) <= BANK_REL_TOL * x + MODE_EXACT_ABS:
            bad.append(f"mode_mags[{i}]: streamed {g!r} vs exact DFT {x!r}")
    if len(got["campuses"]) != len(want["campuses"]):
        return bad + [f"{len(got['campuses'])} campuses != {len(want['campuses'])}"]
    for c, (g, w) in enumerate(zip(got["campuses"], want["campuses"])):
        bad += [f"campus {c} {k}: {g[k]} != {w[k]}" for k in GRID_CAMPUS_VERDICTS if g[k] != w[k]]
        for k, (kind, tol) in GRID_CAMPUS_TOLERANCES.items():
            if not _within(g[k], w[k], kind, tol):
                bad.append(f"campus {c} {k}: {g[k]!r} vs {w[k]!r} (tolerance {kind} {tol:g})")
    return bad


def run_region(stagger: bool, n_racks: int, duration_s: float, *, device: str = "cuda",
               mesh=None, **window):
    """GRID_REGION's region (or its staggered twin) through the port's
    ``fleet.condition`` on the scanned engine (``window``: further
    ``StreamOptions``; ``mesh``: the sharded region engine's); returns
    ``(region, config, spec, result, its summary, wall seconds)``."""
    import torch

    from repro_torch.core import compliance, fleet, grid, pdu

    c = GRID_REGION
    reg = grid_region(grid, stagger, n_racks, duration_s, device=device)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], device=device)
    spec = compliance.GridSpec.create(device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.condition(reg, cfg, spec, qp_iters=c["qp_iters"], device=device, mesh=mesh,
                          stream=fleet.StreamOptions(chunk_intervals=c["chunk_intervals"],
                                                     **window))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mbank = grid.mode_bank(res.poi_grid.shape[0], cfg.sample_dt, reg.bands)
    return reg, cfg, spec, res, region_summary(res, reg, mbank), wall


def decode_logits(model, cfg, prompts, fed, max_len: int, frames=None):
    """``ServeEngine.generate``'s loop through the port's decode step with
    the tokens ``fed (B, n)`` fed back in place of the sampled ones: the
    last-position logits at each generated position, ``(B, n, V)`` (the
    ``audio`` family from the encoder ``frames``)."""
    import torch

    from repro_torch.models import encdec as ED, transformer as T
    from repro_torch.serve import build_decode_step

    decode = build_decode_step(cfg)
    b, t0 = prompts.shape
    if cfg.family == "audio":
        with torch.inference_mode():
            state = ED.init_decode_state(model, frames, b, max_len)
    else:
        state = T.init_decode_state(cfg, b, max_len, device=prompts.device)
    logits, state = decode(model, prompts, state, 0)
    steps = [logits[:, -1]]
    for i in range(fed.shape[1] - 1):
        logits, state = decode(model, fed[:, i:i + 1], state, t0 + i)
        steps.append(logits[:, -1])
    return torch.stack(steps, dim=1)


def port_serve_reference(model, cfg, dev, fed, ref: dict = SERVE_REF) -> dict:
    """``ref`` (SERVE_REF or RWKV_SERVE_REF) through the port on ``dev``
    (prefill step, greedy generation, the decode steps with JAX's tokens
    ``fed (R, n)`` fed back); returns ``serve_summary``.  The ``audio``
    family serves from the frames of ``ref["frame_seed"]``
    (``train.loop.audio_frames``; the JAX side draws the same bits), its
    prefill step sizing the caches to the prompt as the reference's."""
    import torch

    from repro_torch.serve import ServeEngine, build_prefill_step
    from repro_torch.train.loop import audio_frames

    t0, n = ref["prompt_len"], ref["gen_tokens"]
    prompts = torch.as_tensor(
        serve_prompts(cfg.vocab_size, ref["requests"], t0, ref["prompt_seed"]), device=dev)
    frames = None
    if cfg.family == "audio":
        frames = audio_frames(cfg, ref["requests"], ref["frame_seed"], dev)
        logits, _ = build_prefill_step(cfg)(model, prompts, frames)
    else:
        logits, _ = build_prefill_step(cfg)(model, prompts, t0 + n)
    out = ServeEngine(cfg, model, max_len=t0 + n, device=dev).generate(prompts, n, frames=frames)
    steps = decode_logits(model, cfg, prompts, torch.as_tensor(fed, device=dev), t0 + n, frames)
    host = lambda t: t.cpu().numpy()
    return serve_summary(host(logits), host(out), host(steps), fed, ref)


# Paper Fig. 11 (phase 12): the Titan-X testbench (300 s at 200 Hz) through
# the burn baseline (calibration, burn schedule at beta = 0.1) and through
# EasyRider (``pdu.condition``, qp_iters = 40), and the energy comparison.
# The card's run draws the trace noise from a torch.Generator (seed 2) and
# the calibration noise from another (seed 3), as examples/power_conditioning.py
# does with jax.random keys; the comparison with the JAX package runs both
# packages on the counter-hashed noise of ``scenario_from_testbench(
# titanx_spec(), noise_seed=2)``, whose bits are the same in both.
FIG11 = dict(beta=0.1, qp_iters=40, trace_seed=2, cal_seed=3, noise_seed=2, p_idle=0.06,
             p_peak=1.0)
FIG11_BANDS = dict(burn_vs_easyrider_frac=(0.10, 0.30), easyrider_overhead_frac=(-1e-3, 0.02))

# The JAX package's numbers for the noise_seed=2 pipeline, on the CPU (jax
# 0.9.0), printed by ``python tests/test_torch_burn_reference.py``.
JAX_FIG11 = {
    'rack_energy': 208.68409729003906,
    'easyrider_energy': 210.5052947998047,
    'burn_energy': 249.42127990722656,
    'easyrider_overhead_frac': 0.008727055042982101,
    'burn_overhead_frac': 0.195209801197052,
    'burn_vs_easyrider_frac': 0.18486939370632172,
    'schedule_overhead_frac': 0.1944669783115387,
    'burn_max_ramp': 0.10000467300415039,
    'grid_max_ramp': 0.051027536392211914,
    'soc_last': 0.43629035353660583,
    'cal_a': 0.9389286041259766,
    'cal_b': 0.06043790653347969,
}

# Tolerances of the port against JAX_FIG11, with their reasons:
# * energies (~130-200 s x P_RATED): float32 sums of 60000 samples in
#   another order (~1e-6 relative), and the EasyRider grid follows the
#   controller's commands (ADMM sums in another order): 1e-5 relative;
# * the fractions are differences of those energies over them: 1e-4
#   absolute (a 1e-5 relative error of either energy moves them by ~1e-5);
# * the burn envelope's max ramp: the closed form in float64 against the
#   reference's float32 max-scans, which round each step of a ramp (up to
#   ~1640 steps of ~3e-8 in each pass, ~1e-4 in all), over dt = 5 ms:
#   0.02 /s absolute;
# * the conditioned grid's max ramp: as the campus's, 5e-5 /s absolute;
# * the SoC at the end: 1e-4 absolute (the controller's commands);
# * the calibration (a, b): the two packages draw different noise, 16 duty
#   means of 32 samples of std 0.01 (each ~1.8e-3): 1e-2 absolute.  It
#   changes none of the energies.
FIG11_TOLERANCES = {
    "rack_energy": ("rel", 1e-5),
    "easyrider_energy": ("rel", 1e-5),
    "burn_energy": ("rel", 1e-5),
    "easyrider_overhead_frac": ("abs", 1e-4),
    "burn_overhead_frac": ("abs", 1e-4),
    "burn_vs_easyrider_frac": ("abs", 1e-4),
    "schedule_overhead_frac": ("abs", 1e-4),
    "burn_max_ramp": ("abs", 2e-2),
    "grid_max_ramp": ("abs", 5e-5),
    "soc_last": ("abs", 1e-4),
    "cal_a": ("abs", 1e-2),
    "cal_b": ("abs", 1e-2),
}


def fig11_summary(rack, dt, cal, *, device: str = "cuda") -> dict:
    """Fig. 11 through the port: ``rack (T,)`` through the burn schedule
    and through ``pdu.condition``; returns the energy comparison and the
    checks' inputs as floats."""
    from repro_torch.core import burn, compliance, pdu

    f = FIG11
    sched = burn.burn_schedule(rack, dt, beta=f["beta"], cal=cal)
    cfg = pdu.make_pdu(sample_dt=dt, device=device)
    st = pdu.init_state(cfg, rack[0])
    gez, _, telem = pdu.condition(cfg, st, rack, qp_iters=f["qp_iters"])
    nwarm = sched.conditioned.shape[0] - rack.shape[0]
    soc_last = float(telem.soc[-1])
    cmp = burn.compare_energy(rack, gez, sched.conditioned[nwarm:], dt, soc_delta=soc_last - 0.5,
                              q_max_seconds=float(cfg.ess_params.q_max))
    out = {k: float(v) for k, v in cmp.items()}
    out.update(
        schedule_overhead_frac=float(sched.energy_overhead_frac),
        burn_max_ramp=float(compliance.max_abs_ramp(sched.conditioned, dt)),
        grid_max_ramp=float(compliance.max_abs_ramp(gez, dt)),
        soc_last=soc_last, cal_a=float(cal.a), cal_b=float(cal.b),
    )
    return out


def port_fig11_reference(n_samples: int | None = None, *, device: str = "cuda") -> dict:
    """``fig11_summary`` on the trace ``JAX_FIG11`` was recorded on (its
    first ``n_samples``), with the calibration noise from a generator."""
    import torch

    from repro_torch.core import burn
    from repro_torch.power import scenario as SC, trace

    f = FIG11
    rack, dt = SC.render_trace(trace.scenario_from_testbench(
        trace.titanx_spec(), noise_seed=f["noise_seed"], device=device))
    gen = torch.Generator(device=device).manual_seed(f["cal_seed"])
    cal = burn.calibrate(gen, f["p_idle"], f["p_peak"], device=device)
    return fig11_summary(rack[:n_samples], dt, cal, device=device)


def check_fig11(got: dict) -> list[str]:
    """Fig. 11's acceptance bands (tests/test_burn.py) and the burn
    envelope's ramp limit; returns what fails."""
    bad = [f"{k} {got[k]} outside [{lo}, {hi}]" for k, (lo, hi) in FIG11_BANDS.items()
           if not lo <= got[k] <= hi]
    if got["burn_max_ramp"] > FIG11["beta"] * (1 + 1e-3):
        bad.append(f"burn envelope ramp {got['burn_max_ramp']} > {FIG11['beta']} (1 + 1e-3)")
    return bad


def compare_fig11(got: dict, want: dict) -> list[str]:
    """``got`` against ``want`` within ``FIG11_TOLERANCES``; returns what
    differs."""
    bad = []
    for k, (kind, tol) in FIG11_TOLERANCES.items():
        g, w = got[k], want[k]
        lim = tol * abs(w) if kind == "rel" else tol
        if not abs(g - w) <= lim:
            bad.append(f"{k}: {g} vs {w} (|diff| {abs(g - w):.3e} > {lim:.3e})")
    return bad


# Phase 14: the controller's per-step oracle (``pdu.condition(use_plan=
# False)``) and the paper benches that need it, at the reference's sizes
# (benchmarks/paper_benches.py).  Fig. 12 (``bench_fig12_soc_management``,
# examples/power_conditioning.py ``fig12``): one battery from SoC 0.62 back
# toward S_mid = 0.5, 400 control steps of 5 s, 80 cold ADMM iterations a
# step through the factor-once plan.
FIG12 = dict(i_max=4e-3, q_max_seconds=40.0, soc0=0.62, n_steps=400, qp_iters=80)
# Two float32 runs of Fig. 12 whose ADMM products sum in another order (the
# port against the JAX package on the CPU, the admm_step kernel against its
# plain version on the card) hold the SoC trajectory within a few float32
# ulps of a SoC near 0.5 (6e-8 each; the port vs JAX measured 6e-8) and the
# convergence step exactly; tests/test_torch_controller.py holds the port to
# the JAX package with the same bound.  The closest SoC comes to the
# deadband's edge is 3.6e-5 (step 293 of the cold run), so a flip would
# take ~600 ulps.
FIG12_SOC_TOL = 1e-6
# ``bench_fleet_scale`` (``fleet_1024racks``): 1024 racks of a 44 s
# testbench trace at 200 Hz with measurement noise, each rolled by up to 800
# samples; conditioned cold (the per-step oracle, 120 iterations) and warm
# (the plan, 30 iterations).  Neither draw can be JAX's (threefry).
FLEET_SCALE = dict(n_racks=1024, duration_s=44.0, sample_hz=200.0, trace_seed=7,
                   stagger_seed=8, max_offset_samples=800, cold_iters=120, warm_iters=30)
# The reference's own bound between the cold and warm paths' outputs
# (tests/test_controller_plan.py::test_condition_plan_matches_per_step_path:
# grid and SoC within 1e-3, well under the compliance scales).
FLEET_COLD_WARM_TOL = 1e-3
# ``bench_controller_throughput``: 2048 racks at SoCs drawn in [0.3, 0.7),
# cold = ``inner_loop_step`` batched (per-rack build + factor + 120
# iterations), warm = 4 warm-started steps of ``inner_loop_step_plan`` (30).
CONTROLLER_THROUGHPUT = dict(n_racks=2048, n_steps=4, soc_seed=12, cold_iters=120, warm_iters=30)


def convergence_step(soc, deadband: float, target: float = 0.5) -> int | None:
    """The first step whose SoC lies within ``deadband`` of ``target``, as
    the reference's Fig. 12 reads it (None if no step does)."""
    import numpy as np

    hit = np.flatnonzero(np.abs(np.asarray(soc) - np.float32(target)) <= np.float32(deadband))
    return int(hit[0]) if hit.size else None


def _median_ms(fn, reps: int = 25, warmup: int = 3, flush=None) -> float:
    """Median device time of one ``fn()`` call, from CUDA events, with the
    card kept busy (``torch.cuda._sleep``, ~1 ms) while the host enqueues the
    call, so that up to ~1 ms of its host-side overhead is not counted.
    With ``flush`` (a tensor past the 50 MB L2) that buffer is zeroed before
    each timed call: the call finds the L2 full of other data, dirty, as
    after a caller's GEMM (a cold time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes, nops,
                 flop_per_s, **extra) -> dict:
    """One kernel's record for the ``kernels`` JSON line; the bound is the
    larger of ``nbytes`` over the memory rate and ``nops`` over
    ``flop_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / flop_per_s * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, **extra,
    }


def _max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max((_max_err(x, y) for x, y in zip(a, b)), default=0.0)
    if a is None:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def _cp_async_route():
    """Plan every ``pdu_health``/``pdu_sim`` launch inside the block on the
    pipeline's cp.async route (the one R % 4 != 0 takes), so that it can be
    timed beside the TMA route the plan picks at R = 1024: the reason the
    kernel keeps both."""
    from repro_torch.kernels import hw_plan

    orig = hw_plan.plan
    hw_plan.plan = lambda r, mask, **kw: orig(r, mask, **{**kw, "aligned": False})
    try:
        yield
    finally:
        hw_plan.plan = orig


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the campus shapes."""
    import torch

    from repro_torch.core import controller as ctrl, health as hlt, pdu
    from repro_torch.kernels import admm_step, hw_plan, ops, pdu_health
    from repro_torch.power import scenario as SC

    c = CAMPUS
    s = SC.mixed_campus(c["n_racks"], ARCHS, duration_s=c["duration_s"],
                        sample_hz=c["sample_hz"], seed=c["seed"],
                        fault_at_s=c["duration_s"] * 0.6, noise_seed=c["noise_seed"],
                        device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, device=dev)
    k = int(round(float(cfg.controller.dt) * c["sample_hz"]))
    chunk = SC.render(s, 0, k)
    st = pdu.init_state(cfg, chunk[0])
    t_len, r = chunk.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    applied = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    target = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    hw = pdu.hw_kwargs(cfg)
    # The campus keeps SoC inside its window, so drive two slices of racks
    # into it: one starts just below soc_max and charges at full power, one
    # just above soc_min and discharges, so the window clamp and its power
    # back-off run within the interval and are held against the plain
    # version too.
    soc0 = st.ess_state.soc.clone()
    n8 = r // 8
    soc0[:n8], applied[:n8], target[:n8] = hw["soc_max"] - 0.01, 1.0, 1.0
    soc0[n8:2 * n8], applied[n8:2 * n8], target[n8:2 * n8] = hw["soc_min"] + 0.01, -1.0, -1.0
    filt = st.filter_obj
    # The filter matrices as host arrays, as pdu.condition passes them.
    lc = tuple(m.cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0]))
    ph_args = (chunk, st.ess_state.g_filter, soc0, st.filter_state, *lc)
    ph_kw = dict(slew=(applied, target), health=(hlt.step_consts(cfg.health), tuple(st.health)),
                 **hw)
    out_k = ops.pdu_health_sim(*ph_args, force="cuda", **ph_kw)
    out_p = ops.pdu_health_sim(*ph_args, force="ref", **ph_kw)
    torch.cuda.synchronize()
    grid_k, soc_k, fin_k, h_k = out_k
    grid_p, soc_p, fin_p, h_p = out_p
    soc_max, soc_min = (torch.tensor(hw[k], dtype=torch.float32) for k in ("soc_max", "soc_min"))
    n_hi = int((soc_k[:, :n8] == soc_max).any(0).sum())
    n_lo = int((soc_k[:, n8:2 * n8] == soc_min).any(0).sum())
    print(f"pdu_health  SoC window clamp reached by {n_hi}/{n8} charging and {n_lo}/{n8} "
          f"discharging racks")
    _check(n_hi == n8 and n_lo == n8, "pdu_health: the SoC window clamp must fire")
    errs = {
        "grid": _max_err(grid_k, grid_p), "soc": _max_err(soc_k, soc_p),
        "ess+lc finals": _max_err(fin_k, fin_p), "wear carries": _max_err(h_k[:6], h_p[:6]),
        "block sums": _max_err(h_k[6:10], h_p[6:10]),
    }
    print(f"pdu_health  T={t_len} R={r} slew+wear  max|kernel - plain|: "
          + "  ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    # The dense-corrective variant without the wear fold, same shape.
    dense_kw = dict(corrective=torch.outer(torch.linspace(-1, 1, t_len, device=dev), target), **hw)
    out_k = ops.pdu_health_sim(*ph_args, force="cuda", **dense_kw)
    out_p = ops.pdu_health_sim(*ph_args, force="ref", **dense_kw)
    torch.cuda.synchronize()
    errs["dense variant"] = _max_err(out_k[:3], out_p[:3])
    print(f"pdu_health  T={t_len} R={r} dense corrective  max|kernel - plain| = "
          f"{errs['dense variant']:.3e}")
    # Same arithmetic and rounding on both sides (see csrc/pdu_health.cu);
    # the plain version's emulated FMA can double-round (p ~ 2^-29 per op)
    # and the LC filter carries such an ulp forward.
    _check(errs["soc"] <= 1e-6 and errs["wear carries"] <= 1e-6, "pdu_health SoC/wear vs plain")
    _check(errs["grid"] <= 1e-5 and errs["ess+lc finals"] <= 1e-5, "pdu_health grid/LC vs plain")
    _check(errs["dense variant"] <= 1e-5, "pdu_health dense variant vs plain")
    _check(errs["block sums"] <= 1e-3, "pdu_health block sums vs plain")
    prep = pdu_health.prepare(*ph_args, **ph_kw)
    ph_ms = _median_ms(lambda: pdu_health.launch(prep))
    ph_call_ms = _median_ms(lambda: ops.pdu_health_sim(*ph_args, force="cuda", **ph_kw))
    ph_plain_ms = _median_ms(lambda: ops.pdu_health_sim(*ph_args, force="ref", **ph_kw), reps=20)
    print(f"pdu_health  kernel {ph_ms:.4f} ms, wrapper call {ph_call_ms:.4f} ms, "
          f"plain {ph_plain_ms:.1f} ms (median of CUDA-event timings); plan {prep.plan}")
    print(f"pdu_health  T={t_len} R={r}: the one-thread-a-rack kernel before the pipeline "
          f"redesign took {PREVIOUS_KERNEL_MS['pdu_health']:.4f} ms (a recorded constant, not "
          f"this run's)")
    with _cp_async_route():
        pc = pdu_health.prepare(*ph_args, **ph_kw)
    pdu_health.launch(pc)
    same = _bitwise((pc.grid, pc.soc_t, pc.sf, pc.hf), (prep.grid, prep.soc_t, prep.sf, prep.hf))
    ph_cp_ms = _median_ms(lambda: pdu_health.launch(pc))
    print(f"pdu_health  the {pc.plan.route} route forced at R={r}: {ph_cp_ms:.4f} ms against the "
          f"{prep.plan.route} route's {ph_ms:.4f}, the same bits: {same}")
    _check(same and pc.plan.route == "cp.async", "pdu_health cp.async route vs the TMA route")
    ph_chunk = prep.plan.chunk
    # Bytes moved once: rack power in, grid and SoC out (T x R each), plus
    # the per-rack rows (slew 2, state 5 in + 5 out, wear 11 in + 11 out).
    ph_bytes = 4 * (3 * t_len * r + (2 + 5 + 11 + 5 + 11) * r)
    # Float operations per rack-sample counted from the kernel source:
    # slew 3, ESS filter 3, battery power 4, SoC 7, window + back-off 8,
    # node 1, grid 5, LC 3 x 9, wear machine 22 (an FMA counts 2).
    ph_ops = 80 * t_len * r

    plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
    soc = 0.2 + 0.6 * torch.rand(r, generator=gen, device=dev)
    u_prev = (torch.rand(r, generator=gen, device=dev) - 0.5)
    q, lo, hi = ctrl._qp_state_terms(plan, soc, cfg.controller.s_mid.expand(r), u_prev)
    h = plan.horizon
    kq = plan.kkt_inv @ q
    kkt_stack = torch.cat([plan.kkt_inv_sigma, plan.kkt_inv_at], dim=1)
    x0 = torch.zeros_like(q)
    z0 = torch.clamp(plan.a_mat @ x0, lo, hi)
    y0 = torch.zeros_like(z0)
    ad_args = (kkt_stack, plan.a_mat[2 * h:], kq, lo, hi, x0, z0, y0)
    ad_kw = dict(rho=plan.rho, iters=c["qp_iters"])
    out_k = ops.admm_iterate(*ad_args, force="cuda", **ad_kw)
    out_p = ops.admm_iterate(*ad_args, force="ref", **ad_kw)
    torch.cuda.synchronize()
    ad_err = _max_err(out_k, out_p)
    print(f"admm_step   h={h} R={r} iters={c['qp_iters']}  max|kernel - plain| over x,z,y = {ad_err:.3e}")
    # Summation order of the products differs (FP32 FMA chain vs cuBLAS):
    # the reference's own Pallas-vs-ref envelope after 30 iterations.
    _check(ad_err <= 2e-5, "admm_step vs plain")
    prep = admm_step.prepare(*ad_args, **ad_kw)
    # The row-parallel kernel against the one-thread-a-rack shared-plan
    # kernel forced at the same horizon: the same FMA chains in the same
    # order, so the same bits.
    sp = admm_step.prepare(*ad_args, **ad_kw, variant="shared plan")
    admm_step.launch(sp)
    same = all(torch.equal(a, b) for a, b in zip((sp.x, sp.z, sp.y), out_k))
    print(f"admm_step   h={h} row-parallel kernel == shared-plan kernel bit for bit: {same}")
    _check(same, f"admm_step h = {h} row-parallel vs shared-plan kernel")
    ad_ms = _median_ms(lambda: admm_step.launch(prep))
    ad_sp_ms = _median_ms(lambda: admm_step.launch(sp))
    ad_call_ms = _median_ms(lambda: ops.admm_iterate(*ad_args, force="cuda", **ad_kw))
    ad_plain_ms = _median_ms(lambda: ops.admm_iterate(*ad_args, force="ref", **ad_kw))
    print(f"admm_step   kernel {ad_ms:.4f} ms, shared-plan kernel {ad_sp_ms:.4f} ms, wrapper "
          f"call {ad_call_ms:.4f} ms, plain {ad_plain_ms:.3f} ms")
    print(f"admm_step   h={h} R={r}: the one-thread-a-rack kernel before the row-parallel "
          f"redesign took {PREVIOUS_KERNEL_MS['admm_step']:.4f} ms (a recorded constant, not "
          f"this run's)")
    ad_bytes, ad_ops = _admm_bytes_ops(h, r, c["qp_iters"])

    def entry(name, source, replaces, err, ms, call_ms, plain_ms, nbytes, nops, **extra):
        # No single PyTorch call computes either function.  "ms" is the
        # kernel launch alone; the wrapper call adds its host-side checks,
        # packing and (pdu_health) epilogue sums.
        return kernel_entry(name, source, replaces, err, ms, plain_ms, None, nbytes, nops,
                            FP32_FLOP_PER_S, kernel_ms=ms, wrapper_ms=call_ms, **extra)

    return {
        "pdu_health": entry(
            "pdu_health", "src/repro_torch/csrc/pdu_health.cu",
            "src/repro/kernels/pdu_health.py:224", max(errs.values()), ph_ms, ph_call_ms,
            ph_plain_ms, ph_bytes, ph_ops, chunk=ph_chunk, cp_async_ms=ph_cp_ms),
        "admm_step": entry(
            "admm_step", "src/repro_torch/csrc/admm_step.cu",
            "src/repro/kernels/admm_step.py:65", ad_err, ad_ms, ad_call_ms, ad_plain_ms,
            ad_bytes, ad_ops, shared_plan_ms=ad_sp_ms),
    }


def _pdu_health_cost(t_len: int, r: int, mask: str, n_ev: int = 0) -> tuple[int, int]:
    """Bytes ``pdu_health`` must move once (rack power in, grid and SoC out,
    the per-rack rows: slew 2, state 5 + 5, wear 11 + 11) and its float
    operations (phase_kernels' count of 80 per rack-sample), plus what each
    weight mode adds: the (R,) row or the (T, R) series read once and 3
    operations a sample (the two selects and the product); the events
    tables (E, R) twice and the base row once, and ~8 operations a sample
    (the clamp, the ramp's two subtracts, adds, products and clips, 1 - i
    and the product; the table walk is compares)."""
    nbytes, nops = 4 * (3 * t_len * r + (2 + 5 + 11 + 5 + 11) * r), 80 * t_len * r
    extra = {"none": (0, 0), "row": (4 * r, 3 * t_len * r),
             "series": (4 * t_len * r, 3 * t_len * r),
             "events": (8 * n_ev * r + 4 * r, 11 * t_len * r)}[mask]
    return nbytes + extra[0], nops + extra[1]


def phase_pdu_health_variants(dev) -> dict:
    """Phase 2, continued: ``pdu_health`` in each ESS availability mode at
    the campus shape (T = 1000, R = 1024, slew and wear fold), each bitwise
    against its plain version and timed beside the clean variant: a 0/1
    (R,) row, a fractional (T, R) wind-down, and the events tables of the
    degraded campus's own fault schedule (FAULTY_CAMPUS) at edge 1 and at
    the scenario's edge width, the events run also bitwise against the
    (T, R) run on ``faults.ess_weight``; then the wear machine at kappa 1,
    3 and 2.5 against its plain version."""
    import torch

    from repro_torch.core import health as hlt, pdu
    from repro_torch.kernels import ops, pdu_health
    from repro_torch.power import faults as FLT, scenario as SC

    c = FAULTY_CAMPUS
    s = faulty_campus(SC, FLT, c["n_racks"], c["duration_s"], device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, degraded_mode=True,
                       device=dev)
    k = int(round(float(cfg.controller.dt) * c["sample_hz"]))
    sched, r = s.faults, s.n_racks
    # The interval in which most ESS trips and repairs fall (real episodes,
    # inside the trace; the clamped empty slots sit at its end).
    i_best, n_edges = _busiest_interval(s, k)
    i0 = i_best * k
    chunk, _ = pdu.bridge_sensors(torch.full((r,), 0.5, device=dev), SC.render(s, i0, k))
    st = pdu.init_state(cfg, chunk[0])
    gen = torch.Generator(device=dev).manual_seed(5)
    applied = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    target = (torch.rand(r, generator=gen, device=dev) - 0.5) * 1e-2
    hw = pdu.hw_kwargs(cfg)
    lc = tuple(m.cpu().numpy() for m in (st.filter_obj.ad, st.filter_obj.bd, st.filter_obj.c[0]))
    args = (chunk.contiguous(), st.ess_state.g_filter, st.ess_state.soc, st.filter_state, *lc)
    hconsts = hlt.step_consts(cfg.health)
    kw = dict(slew=(applied, target), health=(hconsts, tuple(st.health)), **hw)
    sensed = FLT.interval_sensed(sched, i0, 1, k)[0].to(torch.float32)
    row = FLT.interval_online(sched, i0, 1, k)[0] * sensed
    series = degraded_weight(k, r, cfg.sample_dt, dev)[0]
    events = (sched.ess_start.T.contiguous(), sched.ess_end.T.contiguous(), row.contiguous(), i0,
              i0 + k - 1)
    edge = s.edge_width
    n_ev = events[0].shape[0]
    print(f"pdu_health  degraded modes on interval {i_best} (samples {i0}..{i0 + k - 1}) of the "
          f"degraded campus: {n_edges} ESS trips and repairs, {int((row == 0).sum())} "
          f"racks dark in the (R,) row, E = {n_ev} episode rows, edge {edge}")
    modes = {
        "ess_row": ("row", dict(ess_on=row)),
        "ess_series": ("series", dict(ess_on=series)),
        "ess_events_edge1": ("events", dict(ess_events=events, ess_edge=1)),
        f"ess_events_edge{edge}": ("events", dict(ess_events=events, ess_edge=edge)),
    }
    clean_p = pdu_health.prepare(*args, **kw)
    clean_ms = _median_ms(lambda: pdu_health.launch(clean_p))
    out = {}
    for name, (mask, mkw) in modes.items():
        got = ops.pdu_health_sim(*args, force="cuda", **kw, **mkw)
        want, plain_ms = _event_ms(lambda: ops.pdu_health_sim(*args, force="ref", **kw, **mkw))
        same = _bitwise((got[0], got[1], *got[2], *got[3]), (want[0], want[1], *want[2], *want[3]))
        err = _max_err((got[0], got[1], *got[2], *got[3]), (want[0], want[1], *want[2], *want[3]))
        frozen = int((got[1] == args[2][None, :]).all(0).sum())
        prep = pdu_health.prepare(*args, **kw, **mkw)
        ms = _median_ms(lambda: pdu_health.launch(prep))
        nbytes, nops = _pdu_health_cost(k, r, mask, n_ev)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S) * 1e3
        line = (f"pdu_health  {name:17s} T={k} R={r} slew+wear: bitwise vs plain {same} "
                f"(max|diff| {err:.3e}), {frozen} racks' SoC held all interval; kernel "
                f"{ms:.4f} ms (clean {clean_ms:.4f} ms), plain {plain_ms:.1f} ms, bound "
                f"{bound:.4f} ms")
        ok = same
        if mask == "events":
            w = FLT.ess_weight(sched, i0, k, mkw["ess_edge"]) * row[None, :]
            streamed = ops.pdu_health_sim(*args, force="cuda", ess_on=w.contiguous(), **kw)
            eq = _bitwise((got[0], got[1], *got[2], *got[3]),
                          (streamed[0], streamed[1], *streamed[2], *streamed[3]))
            line += f"; == the (T, R) run on faults.ess_weight: {eq}"
            ok = ok and eq
        prev = PREVIOUS_KERNEL_MS[f"pdu_health_{name}"]
        print(line + f" (before the pipeline redesign {prev:.4f} ms, a recorded constant)")
        _check(ok, f"pdu_health {name} vs plain")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                         clean_ms=clean_ms)
    # The wear machine at the exponents the campus does not use.
    for kappa in (1.0, 3.0, 2.5):
        kkw = dict(kw, health=(tuple(hconsts[:3]) + (kappa,), tuple(st.health)))
        got = ops.pdu_health_sim(*args, force="cuda", **kkw)
        want = ops.pdu_health_sim(*args, force="ref", **kkw)
        err = _max_err((got[0], got[1], *got[2], *got[3]), (want[0], want[1], *want[2], *want[3]))
        same = _bitwise(got[3][:6], want[3][:6])
        # Integer kappas multiply as the plain version does, bit for bit;
        # 2.5 goes through powf, which may round an ulp apart from
        # torch.pow on the card.
        ok = same if kappa.is_integer() else err <= 1e-6
        print(f"pdu_health  kappa {kappa}: wear carries bitwise vs plain {same}, max|diff| over "
              f"every output {err:.3e}")
        _check(ok and _bitwise(got[1], want[1]), f"pdu_health kappa {kappa} vs plain")
    return out


# The LC state update's dependent operations a step (x1 -> a1 x1 -> three
# FMAs -> + bv): the longest loop-carried chain of pdu_health and pdu_sim,
# so their floor is T times this chain.
LC_CHAIN_OPS = 5
# pdu_health's ragged shapes (phase 2): racks (one partial block; three
# blocks, the last holding one rack; 32 racks a row but a partial last block)
# and samples (T = S - 1 and S + 1 around the chunk; 2500, the
# quickstart's interval).
RAGGED_R = (1, 3, 33, 1000)
RAGGED_T_LONG = 2500


def chain_probe(dev) -> dict:
    """The card's time per dependent FP32 operation: one warp's chain of
    dependent FMAs (``csrc/fma_chain.cu``, a library of its own) timed with
    CUDA events at two lengths, the difference over the extra length; in
    cycles at the SM clock ``nvidia-smi`` reports as its maximum.  Not a
    port of a TPU kernel; not counted."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.launch_fn("fma_chain", "fma_chain_launch",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    out = torch.ones(32, device=dev)

    def chain(n):
        _build.check_launch("fma_chain", fn(out.data_ptr(), n,
                                            torch.cuda.current_stream(dev).cuda_stream))

    n1, n2 = 1 << 20, 1 << 21
    t1 = _median_ms(lambda: chain(n1), reps=7)
    t2 = _median_ms(lambda: chain(n2), reps=7)
    ns = (t2 - t1) * 1e6 / (n2 - n1)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    cyc = ns * mhz * 1e-3
    print(f"chain probe: one warp, {n1} and {n2} dependent FMAs: {t1:.4f} and {t2:.4f} ms, "
          f"{ns:.4f} ns a dependent operation = {cyc:.3f} cycles at the {mhz:.0f} MHz maximum "
          f"SM clock")
    return {"ns_per_op": ns, "clock_mhz": mhz, "cycles_per_op": cyc}


def chain_bound_ms(t_len: int, probe: dict) -> float:
    """T x the LC chain's dependent operations x cycles per operation /
    clock: the time the longest loop-carried chain takes, however many
    racks run beside it."""
    return t_len * LC_CHAIN_OPS * probe["cycles_per_op"] / (probe["clock_mhz"] * 1e3)


def _busiest_interval(s, k: int) -> tuple[int, int]:
    """The controller interval of the degraded campus in which most ESS
    trips and repairs fall (real episodes, inside the trace), and their
    count there."""
    import torch

    sched = s.faults
    n_ctrl = -(-s.total_samples // k)
    real = sched.ess_end > sched.ess_start
    edges = torch.cat([sched.ess_start[real], sched.ess_end[real]])
    edges = edges[edges < s.total_samples]
    per = torch.bincount(torch.div(edges, k, rounding_mode="floor"), minlength=n_ctrl)
    i_best = int(torch.argmax(per[: s.total_samples // k]))
    return i_best, int(per[i_best])


def phase_pdu_health_ragged(dev) -> dict:
    """Phase 2, continued: ``pdu_health`` at ragged shapes, R in RAGGED_R and
    T in (1, 7, S - 1, S + 1, 2500) for the plan's chunk S, in every weight
    mode (none, the (R,) row, the (T, R) series, the events tables at edge 1
    and 50), with the slew and the wear fold both on and both off (and,
    at T = S + 1, one on and one off), on the degraded campus's busiest
    interval.  The plain version is elementwise across racks, so one plain
    run at R = 1024 serves every R: the kernel on the first R racks must
    equal its first R columns, bit for bit in the masked modes, within
    phase 2's tolerances in the clean mode (1e-6 for the SoC and the wear
    carries, 1e-5 for the grid and the ESS and LC finals; the line says whether
    it is bitwise).  Every (slew, wear, mode) instantiation launches here;
    the line prints each one's plan (chunk, slots, shared memory)."""
    import torch

    from repro_torch.core import health as hlt, pdu
    from repro_torch.kernels import hw_plan, ops
    from repro_torch.power import faults as FLT, scenario as SC

    c = FAULTY_CAMPUS
    s = faulty_campus(SC, FLT, c["n_racks"], c["duration_s"], device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], track_health=True, degraded_mode=True,
                       device=dev)
    k = int(round(float(cfg.controller.dt) * c["sample_hz"]))
    sched, r_all = s.faults, s.n_racks
    i0 = min(_busiest_interval(s, k)[0] * k, s.total_samples - RAGGED_T_LONG)
    chunk = hw_plan.CHUNK
    t_list = (1, 7, chunk - 1, chunk + 1, RAGGED_T_LONG)
    trace, _ = pdu.bridge_sensors(torch.full((r_all,), 0.5, device=dev),
                                  SC.render(s, i0, RAGGED_T_LONG))
    st = pdu.init_state(cfg, trace[0])
    gen = torch.Generator(device=dev).manual_seed(9)
    applied = (torch.rand(r_all, generator=gen, device=dev) - 0.5) * 1e-2
    target = (torch.rand(r_all, generator=gen, device=dev) - 0.5) * 1e-2
    hw = pdu.hw_kwargs(cfg)
    lc = tuple(m.cpu().numpy() for m in (st.filter_obj.ad, st.filter_obj.bd, st.filter_obj.c[0]))
    hconsts = hlt.step_consts(cfg.health)
    sensed = FLT.interval_sensed(sched, i0, 1, k)[0].to(torch.float32)
    row = FLT.interval_online(sched, i0, 1, k)[0] * sensed
    ev_st, ev_en = sched.ess_start.T.contiguous(), sched.ess_end.T.contiguous()
    # the first r racks of an operand (racks on its last axis) or a result
    cols = lambda x, r: x if not isinstance(x, torch.Tensor) or x.ndim == 0 else (
        x[..., :r].contiguous() if x.shape[-1] == r_all else x)

    def operands(t, mode, slew_on, wear_on):
        args = (trace[:t].contiguous(), st.ess_state.g_filter, st.ess_state.soc, st.filter_state,
                *lc)
        kw = dict(hw)
        if slew_on:
            kw["slew"] = (applied, target)
        else:
            kw["corrective"] = torch.outer(torch.linspace(-1, 1, t, device=dev), target)
        if wear_on:
            kw["health"] = (hconsts, tuple(st.health))
        if mode == "row":
            kw["ess_on"] = row
        elif mode == "series":
            kw["ess_on"] = degraded_weight(t, r_all, cfg.sample_dt, dev)[0]
        elif mode.startswith("events"):
            kw["ess_events"] = (ev_st, ev_en, row, i0, i0 + t - 1)
            kw["ess_edge"] = 1 if mode == "events_edge1" else s.edge_width
        return args, kw

    def sliced(args, kw, r):
        a = tuple(cols(x, r) for x in args[:3]) + (args[3][:r].contiguous(),) + args[4:]
        out = {}
        for name, v in kw.items():
            if name in ("slew", "ess_events"):
                out[name] = tuple(cols(x, r) for x in v)
            elif name == "health":
                out[name] = (v[0], tuple(cols(x, r) for x in v[1]))
            else:
                out[name] = cols(v, r)
        return a, out

    def flat(o, r=None):
        """grid, SoC, g, SoC and LC finals and the wear carries (of the first
        r racks)."""
        out = (o[0], o[1], o[2][0], o[2][1], o[2][2].T) + (
            tuple(o[3][:6]) if o[3] is not None else ())
        return out if r is None else tuple(cols(x, r) for x in out)

    modes = ("none", "row", "series", "events_edge1", "events_edge50")
    flag_sets = [(True, True), (False, False)]
    summary, worst_clean = {}, 0.0
    for mode in modes:
        for slew_on, wear_on in flag_sets + [(True, False), (False, True)]:
            ts = t_list if (slew_on, wear_on) in flag_sets else (chunk + 1,)
            mask = hw_plan.MASK_NONE if mode == "none" else (
                hw_plan.MASK_ROW if mode == "row" else hw_plan.MASK_SERIES if mode == "series"
                else hw_plan.MASK_EVENTS)
            plan = hw_plan.plan(1024, mask)
            n_bit, n_all = 0, 0
            for t in ts:
                args, kw = operands(t, mode, slew_on, wear_on)
                want = ops.pdu_health_sim(*args, force="ref", **kw)
                for r in RAGGED_R:
                    a, skw = sliced(args, kw, r)
                    got = ops.pdu_health_sim(*a, force="cuda", **skw)
                    ref_cols = flat(want, r)
                    torch.cuda.synchronize()
                    same = _bitwise(flat(got), ref_cols)
                    n_bit += same
                    n_all += 1
                    if mode == "none":
                        # phase 2's tolerances: the SoC trace and the wear
                        # carries; the grid and the ESS and LC finals
                        g_out = flat(got)
                        err_soc = _max_err((g_out[1], *g_out[5:]), (ref_cols[1], *ref_cols[5:]))
                        err_lc = _max_err((g_out[0], *g_out[2:5]), (ref_cols[0], *ref_cols[2:5]))
                        worst_clean = max(worst_clean, err_soc, err_lc)
                        _check(err_soc <= 1e-6 and err_lc <= 1e-5,
                               f"pdu_health ragged clean T={t} R={r}: SoC/wear {err_soc:.3e}, "
                               f"grid/LC {err_lc:.3e}")
                    else:
                        _check(same, f"pdu_health ragged {mode} T={t} R={r} slew={slew_on} "
                                     f"wear={wear_on}: kernel vs plain not bitwise")
            flags = ("slew" if slew_on else "dense") + ("+wear" if wear_on else "")
            print(f"pdu_health  ragged {mode:13s} {flags:10s} R in {RAGGED_R} x T in {ts}: "
                  f"{n_bit}/{n_all} bitwise vs plain; plan chunk {plan.chunk}, {plan.slots} "
                  f"slots, {hw_plan.WARPS} warps, {plan.smem_bytes} bytes of shared memory")
            summary[f"{mode}_{flags}"] = dict(bitwise=n_bit, runs=n_all, smem=plan.smem_bytes)
    largest = max(v["smem"] for v in summary.values())
    print(f"pdu_health  ragged: every instantiation launched, the largest plan {largest} bytes "
          f"of the {hw_plan.SMEM_LIMIT} a block may use; clean mode max|diff| {worst_clean:.3e}")
    return {"ragged_clean_max_abs_err": worst_clean, "ragged_largest_smem": largest}


def _admm_bytes_ops(h: int, r: int, iters: int) -> tuple[int, int]:
    """Bytes ``admm_step`` must move (the plan, kq, lo, hi, x0, z0, y0 in and
    x, z, y out, once each) and its float operations: per iteration and
    column the x-update 2 (2h)(5h) + 2h, the operand 2 (3h), G x 2 h (2h),
    z 4 (3h) and y 3 (3h)."""
    n2, n3 = 2 * h, 3 * h
    nbytes = 4 * (n2 * 5 * h + h * n2 + r * (n2 + 2 * n3 + n2 + 2 * n3 + n2 + 2 * n3))
    return nbytes, iters * r * (2 * n2 * 5 * h + n2 + 2 * n3 + 2 * h * n2 + 4 * n3 + 3 * n3)


def phase_widened_shapes(dev) -> dict:
    """Phase 2, continued: the kernel shapes this port widened, each against
    its plain version: rmsnorm at D = 100 (no 16-byte rows) and D = 9000
    (past the vector path), admm_step at horizons 6 (padded to 12), 24 (a
    second instantiation), 48 (the shared-plan variant) and 64, 96 and 128
    (the global-plan variant), each in one launch; from 48 up each home
    of the global-plan variant's iterates that does not serve h, bit for
    bit against the kernel that does.  Returns the times and bounds of the
    launches from 48 up."""
    import torch

    from repro_torch.core import controller as ctrl, pdu
    from repro_torch.kernels import admm_step, ops

    gen = torch.Generator(device=dev).manual_seed(9)
    for d, dtype in ((100, torch.bfloat16), (100, torch.float32), (9000, torch.float32)):
        x = torch.randn(512, d, generator=gen, device=dev).to(dtype)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        got = ops.rmsnorm(x, w, force="cuda").double()
        want = ops.rmsnorm(x, w, force="ref").double()
        rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-6
        ok = bool(((got - want).abs() <= rel * want.abs() + 1e-6).all())
        print(f"rmsnorm     (512, {d}) {str(dtype)[6:]}: max|kernel - plain| "
              f"{float((got - want).abs().max()):.3e}")
        _check(ok, f"rmsnorm D = {d} vs plain")
    r, iters = 1024, 30
    wide = {}
    for horizon in (6, 24, 48, 64, 96, 128):
        cc = ctrl.ControllerConfig.create(horizon=horizon, device=dev)
        cfg = pdu.make_pdu(controller_cfg=cc, sample_dt=0.005, device=dev)
        plan = ctrl.make_plan(cfg.controller, cfg.ess_params)
        soc = 0.2 + 0.6 * torch.rand(r, generator=gen, device=dev)
        u_prev = torch.rand(r, generator=gen, device=dev) - 0.5
        q, lo, hi = ctrl._qp_state_terms(plan, soc, cfg.controller.s_mid.expand(r), u_prev)
        h = plan.horizon
        kq = plan.kkt_inv @ q
        x0 = torch.zeros_like(q)
        z0 = torch.clamp(plan.a_mat @ x0, lo, hi)
        a = (torch.cat([plan.kkt_inv_sigma, plan.kkt_inv_at], dim=1), plan.a_mat[2 * h:], kq, lo,
             hi, x0, z0, torch.zeros_like(z0))
        before = admm_step.admm_iterate.launches
        got = ops.admm_iterate(*a, rho=plan.rho, iters=iters, force="cuda")
        want = ops.admm_iterate(*a, rho=plan.rho, iters=iters, force="ref")
        err = _max_err(got, want)
        variant = admm_step.kernel_variant(admm_step.kernel_horizon(h))
        print(f"admm_step   h={h} (kernel horizon {admm_step.kernel_horizon(h)}, {variant}) R={r} "
              f"iters={iters}: max|kernel - plain| {err:.3e}")
        _check(err <= 2e-5 and admm_step.admm_iterate.launches == before + 1,
               f"admm_step horizon {h} vs plain")
        nbytes, nops = _admm_bytes_ops(h, r, iters)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S) * 1e3
        if h < 48:
            # The row-parallel kernel (h = 6 padded to 12, and 24) against
            # the shared-plan kernel forced on the same (padded) QP.
            hp = admm_step.kernel_horizon(h)
            pa = admm_step.pad_horizon(*a, hp)
            rows = admm_step.prepare(*pa, rho=plan.rho, iters=iters)
            sp = admm_step.prepare(*pa, rho=plan.rho, iters=iters, variant="shared plan")
            admm_step.launch(rows)
            admm_step.launch(sp)
            same = all(torch.equal(u, w_) for u, w_ in zip((rows.x, rows.z, rows.y),
                                                            (sp.x, sp.z, sp.y)))
            same &= all(torch.equal(u, w_) for u, w_ in zip(
                admm_step.unpad_horizon(rows.x, rows.z, rows.y, h), got))
            wide[f"h{h}_ms"] = _median_ms(lambda: admm_step.launch(rows))
            wide[f"h{h}_shared_plan_ms"] = _median_ms(lambda: admm_step.launch(sp))
            wide[f"h{h}_bound_ms"] = bound
            print(f"admm_step   h={h} R={r} iters={iters} (row-parallel at {hp}): kernel "
                  f"{wide[f'h{h}_ms']:.4f} ms, shared-plan kernel "
                  f"{wide[f'h{h}_shared_plan_ms']:.4f} ms, bitwise equal: {same} (bound "
                  f"{bound:.4f} ms)")
            _check(same, f"admm_step h = {h} row-parallel vs shared-plan kernel")
            continue
        prep = admm_step.prepare(*a, rho=plan.rho, iters=iters)
        wide[f"h{h}_ms"] = _median_ms(lambda: admm_step.launch(prep), reps=5 if h > 64 else 25)
        wide[f"h{h}_bound_ms"] = bound
        line = f"admm_step   h={h} R={r} iters={iters} ({variant}): kernel {wide[f'h{h}_ms']:.4f} ms"
        # The global-plan kernel's other homes of the iterates where the
        # kernel that serves h runs too: the same operations in the same
        # order, so the same bits.  Their times are why the iterates stay in
        # shared memory up to SHARED_ITERATES_MAX (PERF.md section 6).
        for name in ("global plan", "global plan and iterates"):
            if name == variant:
                continue
            gp = admm_step.prepare(*a, rho=plan.rho, iters=iters, variant=name)
            admm_step.launch(gp)
            same = all(torch.equal(u, w_) for u, w_ in zip((gp.x, gp.z, gp.y), got))
            key = f"h{h}_global_ms" if name == "global plan" else f"h{h}_global_scratch_ms"
            wide[key] = _median_ms(lambda: admm_step.launch(gp), reps=5 if h > 64 else 25)
            line += f"; {name} {wide[key]:.4f} ms, bitwise equal: {same}"
            _check(same, f"admm_step h = {h} {name} vs {variant}")
        print(line + f" (bound {bound:.4f} ms)")
    return wide


def _visible_pairs(q, k, causal) -> int:
    """The (query, key) pairs of one head that the causal mask leaves
    visible."""
    tq, tk = q.shape[2], k.shape[2]
    if not causal:
        return tq * tk
    off = tk - tq  # row i sees min(tk, i + off + 1) keys
    return sum(min(tk, i + off + 1) for i in range(tq))


def _flash_bytes_ops(q, k, causal) -> tuple[int, int]:
    """Bytes the flash forward must move (q, k, v in, o and the float32 lse
    out, once each) and the product operations of the visible pairs (2 D
    for q k^T and 2 D for p v each)."""
    b, h, tq, d = q.shape
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * tq
    return nbytes, 4 * d * b * h * _visible_pairs(q, k, causal)


# The rmsnorm shapes the main paths launch, (rows, D, dtype, offset), each
# held and timed warm and cold in phase 5: the prefill's 2048 rows in bf16
# at llama3.2-1b's 2048, rwkv6-7b's 4096, deepseek-v2/v3's kv_a_norm 512,
# q_a_norm 1536 and blocks 5120 and 7168, and zamba2-2.7b's blocks 2560
# (its Mamba out_norm runs at d_inner 5120); (2048, 2048) in float32; the
# decode step's 4 rows; and the edge cases: D = 100 (the scalar route) and
# 9000, rows 1, 3 and 133, x one element past an aligned address (the
# scalar route), D = 16384 (the weight too wide to stage), and the staged
# plan at 2048 vectors a row (10240 bf16, 8192 float32).
# tools/rmsnorm_time.py times the same list.
RMSNORM_SHAPES = (
    (2048, 512, "bfloat16", False), (2048, 1536, "bfloat16", False),
    (2048, 2048, "bfloat16", False), (2048, 4096, "bfloat16", False),
    (2048, 5120, "bfloat16", False), (2048, 7168, "bfloat16", False),
    (2048, 2560, "bfloat16", False),
    (2048, 2048, "float32", False),
    (4, 2048, "bfloat16", False), (4, 4096, "bfloat16", False), (4, 2560, "bfloat16", False),
    (4, 5120, "bfloat16", False), (4, 7168, "bfloat16", False),
    (512, 100, "bfloat16", False), (512, 100, "float32", False), (512, 9000, "float32", False),
    (1, 2048, "bfloat16", False), (3, 5120, "bfloat16", False), (133, 7168, "bfloat16", False),
    (2048, 2048, "bfloat16", True), (64, 16384, "bfloat16", False),
    (2048, 10240, "bfloat16", False), (2048, 8192, "float32", False),
)
FLUSH_BYTES = 256 << 20  # past the H100's 50 MB L2


def _rmsnorm_inputs(rows: int, d: int, dtype: str, offset: bool, gen, dev):
    """x (rows, d) and w (d,) of ``dtype`` drawn from ``gen``; with
    ``offset`` x is a view one element into its buffer (not 16-byte
    aligned)."""
    import torch

    t = getattr(torch, dtype)
    flat = torch.randn(rows * d + int(offset), generator=gen, device=dev).to(t)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(t)
    return flat[int(offset):].view(rows, d), w


def _rmsnorm_case(x, w, eps: float, flush=None, label: str = "") -> dict:
    """``rmsnorm`` on ``x`` and ``w`` held to its plain version (one bf16
    ulp, 2^-7 of the value, or 1e-6 relative in float32: the float32
    statistics sum in another order and 1/sqrt is not torch.rsqrt, which
    can move a bf16 result across one rounding boundary), giving the same
    bits twice and, on the row route, the bits of ``fold_rmsnorm`` (the
    kernel's order in plain float32 operations).  With ``flush`` (see
    ``_median_ms``) also timed warm and cold beside the plain version
    (warm) and ``F.rms_norm`` (warm and cold), with its byte bound (x read
    and y written once, the weight once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, rmsnorm as rn

    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    kernel = lambda: ops.rmsnorm(x, w, eps, force="cuda")
    got, again, want = kernel(), kernel(), ops.rmsnorm(x, w, eps, force="ref")
    plan = rn.plan_for(x, w)
    same = [again] + ([rn.fold_rmsnorm(x, w, eps)] if plan.route == "rows" else [])
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    rel = 2.0**-7 if x.dtype == torch.bfloat16 else 1e-6
    what = f"rmsnorm ({rows}, {d}) {str(x.dtype)[6:]}{label}"
    _check(got.shape == x.shape and bool((err <= rel * want.double().abs() + 1e-6).all()),
           f"{what} vs plain")
    _check(all(torch.equal(got, o) for o in same),
           f"{what}: the same bits twice, and as fold_rmsnorm on the row route")
    route = (f"G {plan.warps_per_row}, CH {plan.chunks}, weight "
             f"{'staged' if plan.stage else 'in registers'}, {plan.blocks} blocks"
             if plan.route == "rows" else f"scalar, {plan.blocks} blocks")
    case = {"shape": [rows, d], "dtype": str(x.dtype)[6:], "offset": bool(label),
            "plan": plan._asdict(), "max_abs_err": float(err.max()),
            "runs_bit_for_bit": len(same)}
    if flush is None:
        print(f"rmsnorm     ({rows}, {d}) {case['dtype']}{label} eps {eps:g} [{route}]: "
              f"max|kernel - plain| {case['max_abs_err']:.3e}, {len(same)} more runs bit for bit")
        return case
    lib = lambda: F.rms_norm(x, (d,), w, eps)
    case.update({
        "ms": _median_ms(kernel), "cold_ms": _median_ms(kernel, flush=flush),
        "plain_ms": _median_ms(lambda: ops.rmsnorm(x, w, eps, force="ref")),
        "library_ms": _median_ms(lib), "library_cold_ms": _median_ms(lib, flush=flush),
        "bound_ms": x.element_size() * (2 * rows * d + d) / HBM_BYTES_PER_S * 1e3})
    prev = (PREVIOUS_KERNEL_MS.get(f"rmsnorm_{d}")
            if rows == 2048 and case["dtype"] == "bfloat16" and not label else None)
    print(f"rmsnorm     ({rows}, {d}) {case['dtype']}{label} [{route}]: max|kernel - plain| "
          f"{case['max_abs_err']:.3e}, {len(same)} more runs bit for bit; kernel warm "
          f"{case['ms']:.5f} ms, cold {case['cold_ms']:.5f} ms; plain {case['plain_ms']:.5f} ms; "
          f"F.rms_norm warm {case['library_ms']:.5f}, cold {case['library_cold_ms']:.5f} ms; "
          f"bound {case['bound_ms']:.5f} ms (bytes; {100 * case['bound_ms'] / case['cold_ms']:.1f} "
          f"% of it cold)" + (f"; the kernel before its redesign {prev:.5f} ms warm (a recorded "
                              f"constant)" if prev is not None else ""))
    return case


def phase_rmsnorm_shapes(dev) -> list[dict]:
    """Phase 5, rmsnorm: every shape of ``RMSNORM_SHAPES`` through
    ``_rmsnorm_case``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(28)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    return [_rmsnorm_case(*_rmsnorm_inputs(rows, d, dtype, offset, gen, dev), 1e-5, flush,
                          " offset" if offset else "")
            for rows, d, dtype, offset in RMSNORM_SHAPES]


def phase_serve_kernels(dev) -> dict:
    """The serving kernels against their plain versions at the slice's
    full-width shapes (llama3.2-1b: d_model 2048, 32 query and 8 KV heads of
    64), each timed beside its plain version and the library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import full_config
    from repro_torch.kernels import ops, ref

    cfg = full_config(SERVE["arch"])
    d, eps = cfg.d_model, cfg.norm_eps
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = SERVE["prefill"][0] * SERVE["prefill"][1]

    # rmsnorm: the prefill's rows in bf16 and f32, and the decode step's.
    # Tolerance, elementwise: the float32 statistics differ from the plain
    # version's by a few float32 ulps (summation order; 1/sqrt against
    # torch.rsqrt), which can move a bf16 result across one rounding
    # boundary: one bf16 ulp, 2^-7 of the value; float32: 1e-6 relative.
    rn_err = 0.0
    for dtype, n in ((bf16, rows), (f32, rows), (bf16, SERVE["gen"][0])):
        x, w = randn(n, d).to(dtype), (1.0 + 0.1 * randn(d)).to(dtype)
        got = ops.rmsnorm(x, w, eps, force="cuda").double()
        want = ops.rmsnorm(x, w, eps, force="ref").double()
        err = float((got - want).abs().max())
        rel = 2.0**-7 if dtype == bf16 else 1e-6
        ok = bool(((got - want).abs() <= rel * want.abs() + 1e-6).all())
        print(f"rmsnorm     ({n}, {d}) {str(dtype)[6:]}  max|kernel - plain| = {err:.3e}")
        _check(ok, f"rmsnorm ({n}, {d}) {dtype} vs plain")
        rn_err = max(rn_err, err)
    shapes = phase_rmsnorm_shapes(dev)
    main = next(c for c in shapes if c["shape"] == [rows, d] and c["dtype"] == "bfloat16"
                and not c["offset"])
    # Bytes: x in, y out, the weight once; operations per element: the
    # square and its sum (2), the scale and the weight (float32).
    rn_entry = kernel_entry(
        "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
        max([rn_err] + [c["max_abs_err"] for c in shapes]), main["ms"], main["plain_ms"],
        main["library_ms"], 2 * (2 * rows * d + d), 4 * rows * d, FP32_FLOP_PER_S,
        shape=[rows, d], dtype="bfloat16", cold_ms=main["cold_ms"],
        library_cold_ms=main["library_cold_ms"], plan=main["plan"], shapes=shapes)

    # Flash forward.  Tolerances: float32, 1e-5 on o and lse (sums in
    # another order; the kernel accumulates across key tiles).  bf16: the
    # plain version rounds the logits and the probabilities to bf16 (as the
    # reference's einsums do) where the kernel keeps them in float32, so
    # against it 2e-2 on o and lse (the reference's own bf16 envelope);
    # against the plain version on the same inputs widened to float32 the
    # kernel's only rounding is its output's: one bf16 ulp (2^-7 of the
    # value) on o, 1e-5 on lse.
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bsz, tl = SERVE["prefill"]
    # Then: the qwen1.5-4b smoke config's head dim 30, zero-padded to 32;
    # 128 (the tensor-core kernels' largest); stablelm-12b's 160 (32 heads,
    # 8 KV heads), the deepseek MLA configs'
    # qk head dim 192 and 256 (the reference kernel's largest), each
    # instantiated exactly; a batch of heads past
    # the old grid limit of 65535, in float32,
    # where the kernel and the plain version do the same arithmetic (its 4.2 M
    # rows would also sample the bf16 plain version's rounding of the logits
    # and probabilities far into its tail; the point of the case is the grid);
    # and head dims 320 and 512 in column chunks (``_wide_flash_cases``).
    cases = [("prefill", bsz, h, hkv, tl, tl, hd, True, bf16),
             ("prefill f32", bsz, h, hkv, tl, tl, hd, True, f32),
             ("decode offset", bsz, h, hkv, 128, 1024, hd, True, bf16),
             ("ragged", bsz, h, hkv, 300, 300, hd, True, bf16),
             ("non-causal", bsz, h, hkv, tl, tl, hd, False, bf16),
             ("head dim 30", 2, 4, 4, 77, 77, 30, True, bf16),
             ("head dim 128", 2, 16, 4, 300, 300, 128, True, bf16),
             ("head dim 160", 2, 32, 8, tl, tl, 160, True, bf16),
             ("head dim 160 f32", 2, 32, 8, tl, tl, 160, True, f32),
             ("head dim 192", 2, 16, 4, 300, 300, 192, True, bf16),
             ("head dim 192 f32", 2, 16, 4, 300, 300, 192, True, f32),
             ("head dim 256", 2, 16, 4, 300, 300, 256, True, bf16),
             ("head dim 256 f32", 2, 16, 4, 300, 300, 256, True, f32),
             ("B*H 65600 f32", 1025, 64, 16, 64, 64, 64, True, f32)]
    cases += _wide_flash_cases(bf16, f32)
    fa_err, wide = 0.0, {}
    for name, b, nh, nkv, tq, tk, dh, causal, dtype in cases:
        q, k, v = (randn(b, n, t, dh).to(dtype) for n, t in ((nh, tq), (nkv, tk), (nkv, tk)))
        o, lse = _fa_kernel(q, k, v, causal)
        o_p, lse_p = ref.attention(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        err_o, err_l = _max_err(o, o_p), _max_err(lse, lse_p)
        line = f"flash fwd   {name:16s} q {tuple(q.shape)} k {tuple(k.shape)} {str(dtype)[6:]}: " \
               f"max|kernel - plain| o {err_o:.3e} lse {err_l:.3e}"
        tol = 2e-2 if dtype == bf16 else 1e-5
        ok = err_o <= tol and err_l <= tol
        if dtype == bf16:
            o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=causal, with_lse=True)
            dev_o = (o.double() - o_w.double()).abs()
            line += f"; vs float32 plain o {float(dev_o.max()):.3e} lse {_max_err(lse, lse_w):.3e}"
            ok_w = bool((dev_o <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
            ok_w = ok_w and _max_err(lse, lse_w) <= 1e-5
            # Head dims above 256 are held as phase 7 holds the backward: to
            # the float32 plain version, within one bf16 ulp of the element.
            # The 2e-2 envelope against the bf16 plain version is less than
            # one ulp where |o| >= 4 (0.03125), where the two roundings may
            # land an ulp apart (an H100 read 3.125e-2 at D = 512, the kernel
            # within half an ulp of the float32 plain version).
            ok = ok_w if dh > 256 else ok and ok_w
        print(line)
        _check(ok, f"flash forward {name} vs plain")
        fa_err = max(fa_err, err_o, err_l)
        if name in ("head dim 256", "head dim 320", "head dim 512"):
            dh_ms = _median_ms(lambda: _fa_kernel(q, k, v, causal))
            nbytes, nops = _flash_bytes_ops(q, k, causal)
            wide[dh] = (dh_ms, max(nbytes / HBM_BYTES_PER_S, nops / BF16_FLOP_PER_S) * 1e3)
            print(f"flash fwd   {name} bf16 {tuple(q.shape)}: kernel {dh_ms:.4f} ms (bound "
                  f"{wide[dh][1]:.4f} ms)")
        if name == "prefill":
            fa_ms = _median_ms(lambda: _fa_kernel(q, k, v, causal))
            fa_plain = _median_ms(lambda: ref.attention(q, k, v, causal=causal, with_lse=True))
            # The library's causal mask is aligned to the top left, the same
            # function only where Tq == Tk.
            fa_lib = _median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            fa_bytes, fa_ops = _flash_bytes_ops(q, k, causal)
            fa_shape = [list(q.shape), list(k.shape)]
    print(f"flash fwd   prefill bf16: kernel {fa_ms:.4f} ms, plain {fa_plain:.4f} ms, "
          f"F.scaled_dot_product_attention {fa_lib:.4f} ms")
    print(f"flash fwd   prefill bf16: the FP32-FMA kernel before the redesign took "
          f"{FMA_KERNEL_MS['flash_attention_fwd']:.4f} ms (a recorded constant, not this run's)")
    fa_entry = kernel_entry(
        "flash_attention_fwd", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:90", fa_err, fa_ms, fa_plain, fa_lib, fa_bytes,
        fa_ops, BF16_FLOP_PER_S, shape=fa_shape, dtype="bfloat16", causal=True,
        d256_shape=[[2, 16, 300, 256], [2, 4, 300, 256]], d256_ms=wide[256][0],
        d256_bound_ms=wide[256][1],
        **{k_: v_ for dh in (320, 512) for k_, v_ in (
            (f"d{dh}_shape", [[2, 8, 300, dh], [2, 2, 300, dh]]), (f"d{dh}_ms", wide[dh][0]),
            (f"d{dh}_bound_ms", wide[dh][1]))})
    return {"rmsnorm": rn_entry, "flash_attention_fwd": fa_entry}


def _wide_flash_cases(bf16, f32) -> list:
    """Head dims above 256 (column chunks of 160 at 320, of 256 at 512) for
    phases 5 and 7: causal with a ragged Tq = Tk, non-causal with Tq != Tk,
    each in both types; ``(name, B, H, Hkv, Tq, Tk, D, causal, dtype)``."""
    return [(f"head dim {dh}{'' if dt is bf16 else ' f32'}{'' if causal else ' nc'}", 2, 8, 2,
             300 if causal else 200, 300 if causal else 257, dh, causal, dt)
            for dh in (320, 512) for causal in (True, False) for dt in (bf16, f32)]


def _fa_kernel(q, k, v, causal):
    from repro_torch.kernels import flash_attention

    return flash_attention.flash_attention_fwd(q, k, v, causal=causal)


def _counts() -> dict:
    from repro_torch.kernels import flash_attention, rmsnorm

    return {"rmsnorm": rmsnorm.rmsnorm.launches,
            "flash_attention_fwd": flash_attention.flash_attention_fwd.launches}


def _reset_counts() -> None:
    from repro_torch.kernels import flash_attention, rmsnorm

    rmsnorm.rmsnorm.launches = 0
    flash_attention.flash_attention_fwd.launches = 0


def _timed(fn) -> float:
    """Wall seconds of ``fn()``, synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def phase_serve(dev, tree, profile_dir: Path | None = None) -> dict:
    """The serving slice at full llama3.2-1b width on the parameter tree
    ``tree`` (``convert.random_lm_tree(cfg, SERVE["seed"])``); returns the
    kernels' launch counts of the prefill step and of the generation, and
    their wall times.  With ``profile_dir``, profiles one more prefill and
    generation."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import full_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, build_prefill_step

    cfg = full_config(SERVE["arch"])
    t0 = time.perf_counter()
    model = convert.lm_params_from_numpy(tree, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: {cfg.name} {n_params} parameters ({cfg.dtype}) moved to the card "
          f"in {time.perf_counter() - t0:.1f} s")

    got = port_serve_reference(model, cfg, dev, JAX_SERVE["tokens"])
    bad, skipped = compare_serve(got, JAX_SERVE)
    print(f"serve vs JAX: prefill rows and teacher-forced steps max|diff| "
          f"{serve_max_diff(got, JAX_SERVE):.4f}; row argmax "
          f"{[g['argmax'] for g in got['rows']]} vs {[w['argmax'] for w in JAX_SERVE['rows']]}; "
          f"step argmax {[[g['argmax'] for g in gs] for gs in got['steps']]}; "
          f"tokens {got['tokens']} vs {JAX_SERVE['tokens']}; {skipped} tokens past a "
          f"top-2 margin <= {JAX_MARGIN_TOL} not compared")
    _check(not bad, "serving differs from the JAX package: " + "; ".join(bad))

    # (a) Prefill: 4 prompts x 512 tokens through the prefill step.
    b, tl = SERVE["prefill"]
    prefill_prompts = torch.as_tensor(
        serve_prompts(cfg.vocab_size, b, tl, SERVE["prompt_seed"]), device=dev)
    step = build_prefill_step(cfg)
    step(model, prefill_prompts, tl)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    logits, state = step(model, prefill_prompts, tl)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = _counts()
    with ops.forced("ref"):
        logits_ref, _ = step(model, prefill_prompts, tl)
    torch.cuda.synchronize()
    err = _max_err(logits, logits_ref)
    print(f"serve prefill {b} x {tl}: {prefill_s:.4f} s wall, launches {prefill_counts}; "
          f"logits max|kernels - plain| {err:.4f} (max|logit| "
          f"{float(logits_ref.abs().max()):.3f})")
    _check(prefill_counts == {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention_fwd": cfg.n_layers},
           f"prefill launches {prefill_counts}")
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and state["blocks"].length == tl, "prefill logits/state")
    _check(err <= SERVE_PREFILL_TOL, "prefill logits, kernels vs plain versions")

    # (b) Generation: 4 requests, 64-token prompts, 32 greedy tokens.
    b, t0p = SERVE["gen"]
    n = SERVE["gen_tokens"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t0p, SERVE["prompt_seed"] + 1),
                              device=dev)
    eng = ServeEngine(cfg, model, max_len=t0p + n, device=dev)
    eng.generate(prompts, 2)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    out = eng.generate(prompts, n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_counts = _counts()
    with torch.inference_mode():
        fwd = T.forward(model, out[:, :-1]).logits[:, t0p - 1:]
    # The generation's own logits (its decode loop fed its own tokens)
    # against forward's, every logit of every generated position.
    gen_logits = decode_logits(model, cfg, prompts, out[:, t0p:], t0p + n)
    gen_err = _max_err(gen_logits, fwd)
    margin = torch.as_tensor(_top2_margin(fwd.cpu().numpy()))
    agree = fwd.argmax(-1).cpu() == out[:, t0p:].cpu()
    sure = margin > SERVE_MARGIN_TOL
    worst = float(margin[~agree].max()) if bool((~agree).any()) else 0.0
    print(f"serve generate {b} x ({t0p} + {n}): {gen_s:.4f} s wall, {b * n / gen_s:.1f} tokens/s, "
          f"launches {gen_counts}; logits max|generation - forward| {gen_err:.4f}; greedy == "
          f"forward argmax at {int(agree.sum())}/{agree.numel()} positions (largest margin "
          f"where not {worst:.4f}), {int(sure.sum())} with a top-2 margin > {SERVE_MARGIN_TOL}")
    _check(gen_counts == {"rmsnorm": (2 * cfg.n_layers + 1) * n, "flash_attention_fwd": 0},
           f"generation launches {gen_counts}")
    _check(gen_err <= SERVE_PREFILL_TOL, "generation logits vs forward")
    _check(bool(sure.any()) and bool(agree[sure].all()),
           "greedy tokens differ from the forward argmax")
    if profile_dir is not None:
        profile_run("prefill", lambda: _timed(lambda: step(model, prefill_prompts, tl)),
                    profile_dir)
        profile_run("generate", lambda: _timed(lambda: eng.generate(prompts, n)), profile_dir)
    return {"prefill": prefill_counts, "generate": gen_counts, "prefill_s": prefill_s,
            "generate_s": gen_s, "tokens_per_s": b * n / gen_s,
            "tp_ref": tp_serve_reference(model, cfg, dev)}


def _flash_bwd_bytes_ops(q, k, causal, v=None) -> dict:
    """Bytes each backward kernel must move and the product operations it
    does on the visible (query, key) pairs, for a value head dim ``Dv``
    (``v``'s; the query's D without it).  dK/dV reads q, k, v, dO and the
    float32 lse and delta once and writes dk, dv; its products per pair are
    q k^T (2 D), dO V^T (2 Dv), p^T dO (2 Dv) and dS^T Q (2 D): 8 D when
    Dv = D.  dQ reads the same and writes dq; q k^T, dO V^T and dS K (4 D +
    2 Dv)."""
    b, h, tq, d = q.shape
    dv = d if v is None else v.shape[-1]
    v_numel = k.numel() // d * dv
    pairs = _visible_pairs(q, k, causal)
    e = q.element_size()
    reads = e * (q.numel() + b * h * tq * dv + k.numel() + v_numel) + 2 * 4 * b * h * tq
    return {"dkv": (reads + e * (k.numel() + v_numel), 4 * (d + dv) * b * h * pairs),
            "dq": (reads + e * q.numel(), (4 * d + 2 * dv) * b * h * pairs)}


def _flash_bwd_tc_ops(q, k, causal) -> dict:
    """The product operations the tensor-core backward kernels run on the
    visible pairs: q k^T and dO V^T once each, and every product with a
    float32 operand three times (its three bf16 parts): dK/dV 2 + 2 + 3 (2
    + 2) = 16 D a pair, dQ 2 + 2 + 3 (2) = 10 D."""
    b, h, _, d = q.shape
    pairs = _visible_pairs(q, k, causal)
    return {"dkv": 16 * d * b * h * pairs, "dq": 10 * d * b * h * pairs}


def phase_train_kernels(dev) -> dict:
    """The training kernels at the training slice's full-width shapes: the
    flash-attention backward (dK/dV and dQ) against the plain backward on
    the same residuals and against autograd through the plain attention,
    each kernel timed beside the plain backward and the library's; the
    rmsnorm Function's gradients against autograd of the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import full_config
    from repro_torch.kernels import flash_attention as fa, ops, ref

    cfg = full_config(TRAIN["arch"])
    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bsz, tl = TRAIN["batch"], TRAIN["seq_len"]

    # Tolerances, elementwise, with ``scale`` the gradient's largest |value|:
    # * against the plain backward on the same residuals (the same float32
    #   math; the kernels sum the products and the GQA head group in
    #   another order): float32 1e-5 x scale (measured 2.5e-6 on a first
    #   run); bf16 additionally one bf16 ulp of the element (2^-7 of it),
    #   since each side rounds its float32 result once;
    # * against autograd through the plain attention on the same inputs
    #   widened to float32 (the softmax's own VJP): float32 2e-5 x scale;
    #   bf16 one ulp of the element plus 2^-7 x scale, as the kernels'
    #   residuals o and dO are bf16 (delta = sum(dO o) moves by 2^-8 of
    #   its size, and dS, dQ, dK with it).
    # The bf16 kernels run on the tensor cores at head dims 32, 64 and 128
    # (their float32 operands in three bf16 parts) and on FP32 FMAs above;
    # each line names the route its launches took (the wrappers' counts by
    # route).  As in phase 5: head dims 128, 160, 192 and 256 (the FP32-FMA
    # kernels walk 32-row tiles at 256), a batch of heads past 65535, and
    # head dims 320 and 512 in column chunks.
    cases = [("train", bsz, h, hkv, tl, tl, hd, True, bf16),
             ("train f32", bsz, h, hkv, tl, tl, hd, True, f32),
             ("decode offset", bsz, h, hkv, 128, 1024, hd, True, bf16),
             ("ragged", bsz, h, hkv, 300, 300, hd, True, bf16),
             ("non-causal", bsz, h, hkv, tl, tl, hd, False, bf16),
             ("head dim 30", 2, 4, 4, 77, 77, 30, True, bf16),
             ("head dim 128", 2, 16, 4, 300, 300, 128, True, bf16),
             ("head dim 160", 2, 32, 8, tl, tl, 160, True, bf16),
             ("head dim 160 f32", 2, 32, 8, tl, tl, 160, True, f32),
             ("head dim 192", 2, 16, 4, 300, 300, 192, True, bf16),
             ("head dim 192 f32", 2, 16, 4, 300, 300, 192, True, f32),
             ("head dim 256", 2, 16, 4, 300, 300, 256, True, bf16),
             ("head dim 256 f32", 2, 16, 4, 300, 300, 256, True, f32),
             ("B*H 66560", 520, 128, 32, 64, 64, 32, True, bf16)]
    cases += _wide_flash_cases(bf16, f32)
    err_max, wide, routes = 0.0, {}, {}
    by_route = lambda: [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    for name, b, nh, nkv, tq, tk, dh, causal, dtype in cases:
        q, k, v = (randn(b, n, t, dh).to(dtype) for n, t in ((nh, tq), (nkv, tk), (nkv, tk)))
        do = randn(b, nh, tq, dh).to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        before = by_route()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        # The route each kernel's launch took, from its counts by route.
        took = {r for b_, a_ in zip(before, by_route()) for r in a_ if a_[r] != b_[r]}
        _check(len(took) == 1, f"flash backward {name}: one route for both kernels, took {took}")
        n_chunks, width = fa.column_chunks(fa.kernel_head_dim(dh))
        route = next(iter(took)) + (f", {n_chunks} column chunks of {width}" if n_chunks > 1
                                    else "")
        if dtype == bf16:
            routes[str(fa.kernel_head_dim(dh))] = route
        plain = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        qw, kw, vw = (t.float().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(ref.attention(qw, kw, vw, causal=causal), (qw, kw, vw),
                                   do.float())
        torch.cuda.synchronize()
        line = (f"flash bwd   {name:16s} q {tuple(q.shape)} k {tuple(k.shape)} {str(dtype)[6:]} "
                f"[{route}]:")
        ok = True
        for nm, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
            g64, p64, a64 = g.double(), p.double(), a.double()
            scale = float(p64.abs().max())
            ulp = 2.0**-7 if dtype == bf16 else 0.0
            e_p, e_a = float((g64 - p64).abs().max()), float((g64 - a64).abs().max())
            ok &= bool(((g64 - p64).abs() <= ulp * p64.abs() + 1e-5 * scale).all())
            ok &= bool(((g64 - a64).abs() <= ulp * a64.abs()
                        + (2.0**-7 if dtype == bf16 else 2e-5) * scale).all())
            line += f" {nm} {e_p:.3e}/{e_a:.3e} (max {scale:.3f})"
            err_max = max(err_max, e_p)
        print(line + "  [kernel - plain backward / - autograd of plain attention]")
        _check(ok, f"flash backward {name} vs plain")
        if dh > 256:
            # The column-chunked route through the entry a model calls:
            # ops.attention's forward and its autograd backward launch the
            # same kernels once each and give the same bits.
            before = _train_counts()
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            oa = ops.attention(qa, ka, va, causal=causal, force="cuda")
            ga = torch.autograd.grad(oa, (qa, ka, va), do)
            ran = {n: c - before[n] for n, c in _train_counts().items() if n != "rmsnorm"}
            same = torch.equal(oa, o) and all(torch.equal(a, g) for a, g in zip(ga, got))
            print(f"flash bwd   {name} through ops.attention + autograd: launches {ran}, the "
                  f"same bits as the direct calls: {same}")
            _check(same and set(ran.values()) == {1}, f"flash {name} through ops.attention")
        if name in ("head dim 256", "head dim 320", "head dim 512"):
            lse_c, delta = lse.contiguous(), torch.sum(do.float() * o.float(), dim=-1)
            sc = 1.0 / dh**0.5
            costs_d = _flash_bwd_bytes_ops(q, k, True)
            wide[dh] = {
                "dkv": _median_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse_c, delta, causal=True,
                                                           scale=sc)),
                "dq": _median_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse_c, delta, causal=True,
                                                         scale=sc)),
                "bound": {w: max(costs_d[w][0] / HBM_BYTES_PER_S,
                                 costs_d[w][1] / BF16_FLOP_PER_S) * 1e3 for w in ("dkv", "dq")}}
            print(f"flash bwd   {name} bf16 {tuple(q.shape)}: dK/dV {wide[dh]['dkv']:.4f} ms "
                  f"(bound {wide[dh]['bound']['dkv']:.4f}), dQ {wide[dh]['dq']:.4f} ms (bound "
                  f"{wide[dh]['bound']['dq']:.4f})")
        if name == "train":
            lse_c, delta = lse.contiguous(), torch.sum(do.float() * o.float(), dim=-1)
            sc = 1.0 / hd**0.5
            dkv_ms = _median_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse_c, delta, causal=True,
                                                         scale=sc))
            dq_ms = _median_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse_c, delta, causal=True,
                                                       scale=sc))
            plain_ms = _median_ms(lambda: ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                                  causal=True))
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
            lib_ms = _median_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                            retain_graph=True))
            costs = _flash_bwd_bytes_ops(q, k, True)
            tc_ops = _flash_bwd_tc_ops(q, k, True)
            shape = [list(q.shape), list(k.shape)]
    fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0
    print(f"flash bwd   train bf16: dK/dV {dkv_ms:.4f} ms, dQ {dq_ms:.4f} ms (tensor cores); plain "
          f"backward {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms")
    print(f"flash bwd   train bf16: the FP32-FMA kernels' recorded times before the redesign: "
          f"dK/dV {FMA_KERNEL_MS['flash_attention_bwd_dkv']:.4f} ms, dQ "
          f"{FMA_KERNEL_MS['flash_attention_bwd_dq']:.4f} ms (recorded constants, not this run's)")
    rows = {}
    for key, which, ms, line in (("dkv", "flash_attention_bwd_dkv", dkv_ms, 243),
                                 ("dq", "flash_attention_bwd_dq", dq_ms, 273)):
        # The plain and library times are of the whole backward (both
        # gradients), the only unit either computes.  bound_ms is that of
        # the reference's work; tc_bound_ms that of the products the
        # tensor-core kernel runs (three bf16 parts of each float32 operand).
        rows[which] = kernel_entry(
            which, "src/repro_torch/csrc/flash_attention_bwd.cu",
            f"src/repro/kernels/flash_attention.py:{line}", err_max, ms, plain_ms, lib_ms,
            *costs[key], BF16_FLOP_PER_S, shape=shape, dtype="bfloat16", causal=True,
            routes=routes,
            tc_bound_ms=max(costs[key][0] / HBM_BYTES_PER_S, tc_ops[key] / BF16_FLOP_PER_S) * 1e3,
            d256_shape=[[2, 16, 300, 256], [2, 4, 300, 256]], d256_ms=wide[256][key],
            d256_bound_ms=wide[256]["bound"][key],
            **{k_: v_ for dh in (320, 512) for k_, v_ in (
                (f"d{dh}_shape", [[2, 8, 300, dh], [2, 2, 300, dh]]),
                (f"d{dh}_ms", wide[dh][key]), (f"d{dh}_bound_ms", wide[dh]["bound"][key]))})

    # The rmsnorm Function: its backward is autograd of the plain version,
    # so the gradients equal autograd through the plain rmsnorm exactly.
    for dtype in (bf16, f32):
        x = randn(bsz * tl, cfg.d_model).to(dtype).requires_grad_()
        w = (1.0 + 0.1 * randn(cfg.d_model)).to(dtype).requires_grad_()
        c = randn(bsz * tl, cfg.d_model).to(dtype)
        gk = torch.autograd.grad((ops.rmsnorm(x, w, cfg.norm_eps, force="cuda") * c).sum(), (x, w))
        gp = torch.autograd.grad((ops.rmsnorm(x, w, cfg.norm_eps, force="ref") * c).sum(), (x, w))
        same = all(torch.equal(a, b) for a, b in zip(gk, gp))
        print(f"rmsnorm bwd ({bsz * tl}, {cfg.d_model}) {str(dtype)[6:]}: gradients equal to "
              f"autograd of the plain version: {same}")
        _check(same, f"rmsnorm gradients {dtype}")
    return rows


def _train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa, rmsnorm

    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv.launches,
            "flash_attention_bwd_dq": fa.flash_bwd_dq.launches,
            "rmsnorm": rmsnorm.rmsnorm.launches}


def _reset_train_counts() -> None:
    from repro_torch.kernels import flash_attention as fa, rmsnorm

    fa.flash_attention_fwd.launches = fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0
    rmsnorm.rmsnorm.launches = 0


def _step_summary(model, state, metrics, leaves=TRAIN_LEAVES) -> dict:
    """``train_summary`` of one step of a port model on the sampled
    ``leaves``."""
    import torch

    params = dict(model.named_parameters())
    host = lambda t: t.detach().to(torch.float32).cpu().numpy()
    return train_summary([metrics["loss"]], [metrics["grad_norm"]],
                         train_samples(lambda p: host(params[_port_leaf(p)]), leaves),
                         [train_samples(lambda p: host(state.m[_port_leaf(p)]), leaves)])


def phase_train(dev, tree, profile_dir: Path | None = None) -> dict:
    """The training slice at full llama3.2-1b width: (a) three
    ``build_train_step`` steps, launch counts and step 1 against the plain
    versions; (b) TRAIN_REF against JAX_TRAIN; (c) ``train()`` with the
    launcher's PowerSim.  Returns the counts and the timings, and under
    ``"steps_8a"`` (a)'s kernel steps: each loss and grad norm and the bit
    prints of every parameter and moment after them, and under
    ``"start_8a"`` their start weights (on the host, the parameters'
    type), which phase 24a starts from and holds its one-rank FSDP run
    to."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs import full_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import admm_step, ops, pdu_health
    from repro_torch.launch.train import power_sim_for
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.power import phases as P, scenario as SC
    from repro_torch.train import TrainConfig, build_train_step, train

    cfg = full_config(TRAIN["arch"])
    _check(cfg.remat == "block" and cfg.dtype == "bfloat16",
           "the full config trains in bf16 with remat")
    L = cfg.n_layers
    b, t = TRAIN["batch"], TRAIN["seq_len"]
    opt = AdamWConfig(lr=TRAIN["lr"])
    step = build_train_step(cfg, opt, total_steps=TRAIN["total_steps"],
                            warmup_steps=TRAIN["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=TRAIN["seed"], batch=b, seq_len=t,
                                       vocab_size=cfg.vocab_size))
    model = convert.lm_params_from_numpy(tree, cfg, device=dev)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    start = {n: p.detach().clone() for n, p in params.items()}
    start_8a = {n: t.cpu() for n, t in start.items()}

    # (a) Step 1 on the plain versions, then from the same start on the
    # kernels, then two more kernel steps.
    with ops.forced("ref"):
        _, st, m = step(model, adamw_init(params, opt), ds.batch_at(0), 0)
    want = _step_summary(model, st, m)
    del st, m
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    del start
    state = adamw_init(params, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_train_counts()
    walls, losses, norms = [], [], []
    for i in range(TRAIN["steps"]):
        batch = ds.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, metrics = step(model, state, batch, i)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            got = _step_summary(model, state, metrics)
    counts = _train_counts()
    steps_8a = dict(loss=losses, grad_norm=norms, prints=_bit_prints(_train_state(params, state)))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
                "flash_attention_bwd_dq": L, "rmsnorm": (2 * L + 1) + 2 * L}
    step_s = walls[-1]
    tokens = b * t
    mfu = 6.0 * n_params * tokens / (step_s * BF16_FLOP_PER_S)
    bad = compare_train(got, want, TRAIN["lr"])
    print(f"train {cfg.name} {n_params} parameters ({cfg.dtype}, remat={cfg.remat}), {b} x {t} "
          f"tokens: step walls {[round(w, 4) for w in walls]} s, losses {losses}, launches over "
          f"{TRAIN['steps']} steps {counts}, peak memory {peak_gb:.1f} GB")
    print("train step 1, kernels vs plain versions: "
          + json.dumps(train_max_diff(got, want, TRAIN["lr"])))
    print(f"train warm step {step_s:.4f} s, {tokens / step_s:.1f} tokens/s, train_mfu "
          f"{mfu:.4f} (6 N tokens / (step time x 989 TFLOP/s); remat executes ~8 N)")
    _check(counts == {k: v * TRAIN["steps"] for k, v in per_step.items()},
           f"train launches {counts}, want {per_step} per step")
    _check(all(map(math.isfinite, losses)), f"train losses {losses}")
    _check(not bad, "train step 1, kernels vs plain versions: " + "; ".join(bad))
    if profile_dir is not None:
        batch = ds.batch_at(TRAIN["steps"])
        profile_run("train_step", lambda: _timed(lambda: step(model, state, batch, TRAIN["steps"])),
                    profile_dir)
    del model, state, params, metrics
    torch.cuda.empty_cache()

    # (b) TRAIN_REF: full width at 2 layers against the JAX package.
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_REF["n_layers"])
    model2 = convert.lm_params_from_numpy(convert.random_lm_tree(cfg2, TRAIN["seed"]), cfg2,
                                          device=dev)
    got_ref = port_train_reference(model2, cfg2, dev)
    del model2
    torch.cuda.empty_cache()
    bad = compare_train(got_ref, JAX_TRAIN, TRAIN["lr"])
    print(f"train vs JAX ({TRAIN_REF['n_layers']} layers, {TRAIN_REF['batch']} x "
          f"{TRAIN_REF['seq_len']}, {TRAIN_REF['steps']} steps): losses {got_ref['loss']} vs "
          f"{JAX_TRAIN['loss']}, grad norms {got_ref['grad_norm']} vs {JAX_TRAIN['grad_norm']}; "
          f"largest differences {json.dumps(train_max_diff(got_ref, JAX_TRAIN, TRAIN['lr']))}")
    _check(not bad, "training differs from the JAX package: " + "; ".join(bad))

    # (c) train() with the launcher's PowerSim, full width.
    sim = power_sim_for(cfg, b, t, device=dev)
    durs, pows = P.step_phases(sim.cost, sim.hw, sim.model)
    step_samples = SC.from_phase_timeline(durs, pows, sim.cfg.sample_hz, device=dev).total_samples
    intervals = step_samples * TRAIN["power_steps"] // sim._k
    pdu_health.pdu_health_sim.launches = admm_step.admm_iterate.launches = 0
    _reset_train_counts()
    t0 = time.perf_counter()
    res = train(cfg, DataConfig(seed=TRAIN["seed"], batch=b, seq_len=t, vocab_size=cfg.vocab_size),
                AdamWConfig(lr=TRAIN["lr"]), TrainConfig(steps=TRAIN["power_steps"], log_every=1),
                power_sim=sim, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = res["power_report"]
    power_counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
    power_train_counts = _train_counts()
    print(f"train + PowerSim: {TRAIN['power_steps']} steps in {wall:.2f} s wall, losses "
          f"{[round(r['loss'], 4) for r in res['history']]}; each step {float(sum(durs)):.2f} s "
          f"of simulated power at {sim.cfg.sample_hz:g} Hz, {intervals} controller intervals "
          f"conditioned; launches pdu_health={power_counts[0]} admm_step={power_counts[1]}, "
          f"training kernels {power_train_counts}")
    print("train + PowerSim report: " + json.dumps(rep))
    del res
    torch.cuda.empty_cache()
    _check(rep["grid_max_ramp"] <= 0.1 + 1e-3, f"PowerSim grid ramp {rep['grid_max_ramp']}")
    _check(rep["rack_max_ramp"] > rep["grid_max_ramp"], "PowerSim rack ramp <= grid ramp")
    _check(0.1 <= rep["final_soc"] <= 0.9, f"PowerSim SoC {rep['final_soc']}")
    _check(power_counts == (intervals, intervals),
           f"PowerSim launches {power_counts}, want {intervals} each")
    _check(power_train_counts == {k: v * TRAIN["power_steps"] for k, v in per_step.items()},
           f"train() launches {power_train_counts}")
    return {"counts": counts, "per_step": per_step, "step_s": step_s,
            "tokens_per_s": tokens / step_s, "train_mfu": mfu, "peak_gb": peak_gb,
            "power_counts": power_counts, "steps_8a": steps_8a, "start_8a": start_8a}


def _train_state(params: dict, state) -> dict:
    """``{"param/name", "m/name", "v/name": tensor}`` of a training state
    (a sharded one's are this rank's shards)."""
    out = {f"param/{n}": p.detach() for n, p in params.items()}
    out.update({f"m/{n}": t for n, t in state.m.items()})
    out.update({f"v/{n}": t for n, t in state.v.items()})
    return out


def _rwkv_inputs(gen, dev, b, h, t, d, dtype, w_val=None, time_major=False):
    """Scan operands like the time mix's: r, k, v ~ N(0, 1/4); the decay
    exp(-exp(-6 + N(0, 1))) as the reference's ``decay_base`` gives it
    (in (0.98, 1): a memory of hundreds of tokens), or ``w_val``; u ~
    N(0, 0.01); all rounded to ``dtype``; a float32 state ~ N(0, 1/4).
    With ``time_major`` r, k, v, w are (B, H, T, D) views of (B, T, H, D)
    tensors, as the time mix hands them over."""
    import torch

    shape = (b, t, h, d) if time_major else (b, h, t, d)
    lay = (lambda x: x.transpose(1, 2)) if time_major else (lambda x: x)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    r, k, v = (0.5 * randn(*shape) for _ in range(3))
    w = (torch.exp(-torch.exp(-6.0 + randn(*shape))) if w_val is None
         else torch.full(shape, w_val, device=dev))
    u = 0.1 * randn(h, d)
    s0 = 0.5 * randn(b, h, d, d)
    return [lay(x.to(dtype)) for x in (r, k, v, w)] + [u.to(dtype)], s0


def _rwkv_bytes_ops(r) -> tuple[int, int]:
    """Bytes the scan must move from a given state (r, k, v, w and u in, o
    out, the float32 state in and out) and the float32 operations the
    function needs: per state element per token 5 (o's r_i S_ij, one FMA;
    the update w_i S_ij + k_i v_j, a multiply and an FMA), and per head
    element per token 5 more for the bonus, which factors out of the
    (D, D) work: r diag(u) k^T v = (sum_i r_i u_i k_i) v (a multiply and
    an FMA per i, an FMA per j)."""
    b, h, t, d = r.shape
    nbytes = r.element_size() * (5 * r.numel() + h * d) + 2 * 4 * b * h * d * d
    return nbytes, 5 * b * h * t * d * (d + 1)


def phase_rwkv_kernel(dev) -> dict:
    """The rwkv6_scan kernel against the sequential plain version at the
    ssm slice's shapes (rwkv6-7b: 64 heads of 64), timed beside the
    sequential and the chunked plain versions."""
    import torch

    from repro_torch.kernels import ops, ref, rwkv6_scan as rw

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    b, t = RWKV["prefill"]
    h, d = 64, 64
    # Tolerances, elementwise, with ``scale`` the largest |value| of the
    # plain version's output or state: the kernel and the plain version do
    # the same float32 operations on the state per step, but the kernel
    # factors the bonus out of o (o_j = sum_i r_i S_ij + v_j sum_i r_i u_i
    # k_i), sums o over i in another order (partial sums per lane, then
    # shuffles, then the slabs above 4096, against cuBLAS's) and contracts
    # multiply-adds into FMAs, so o and S differ by float32 rounding that the
    # recurrence carries along: 1e-5 x scale; bf16 o additionally one bf16
    # ulp of the element (2^-7 of it), since each side rounds its float32 o
    # once.
    # "time-major" hands the kernel (B, H, T, D) views of (B, T, H, D)
    # tensors, as the time mix does, and o must come back in that layout.
    cases = [("prefill", b, h, t, d, bf16, None, True, False),
             ("time-major", b, h, t, d, bf16, None, True, True),
             ("prefill f32", b, h, t, d, f32, None, True, False),
             ("decode", b, h, 1, d, bf16, None, True, False),
             ("ragged D128", b, 32, 257, 128, bf16, None, False, False),
             ("w = 0.01", b, h, t, d, bf16, 0.01, True, False),
             ("D 32", b, 16, t, 32, bf16, None, True, False),
             ("padded D48", b, 16, t, 48, bf16, None, True, False),
             ("D 256", b, 16, t, 256, bf16, None, True, False),
             ("D 256 f32", 2, 8, 129, 256, f32, None, True, False),
             ("padded D200", 2, 8, 129, 200, bf16, None, True, False),
             # Above 256: threads of 128 rows a column (4 at 512 and a padded
             # 400, 3 at 384); above 1024 in slabs of at most 8 such threads,
             # summed by a second pass (4 slabs of 8 at 4096).
             ("D 512", 2, 8, 257, 512, bf16, None, True, False),
             ("D 512 f32", 1, 4, 129, 512, f32, None, True, False),
             ("padded D400", 2, 4, 129, 400, bf16, None, True, False),
             ("D 384 f32", 1, 4, 65, 384, f32, None, True, False),
             ("D 4096 f32", 1, 1, 16, 4096, f32, None, True, False),
             # Above 4096, the old limit: 33 threads at 4224 (5 slabs of 7
             # and a short one; its float32 state 71 MB), 8 slabs of 8 at
             # 8192.
             ("D 4224 f32", 1, 1, 16, 4224, f32, None, True, False),
             ("D 8192 bf16", 1, 2, 8, 8192, bf16, None, True, False)]
    err_max, wide = 0.0, {}
    for name, bb, hh, tt, dd, dtype, w_val, with_s0, time_major in cases:
        (r, k, v, w, u), s0 = _rwkv_inputs(gen, dev, bb, hh, tt, dd, dtype, w_val, time_major)
        s0 = s0 if with_s0 else None
        sums = rw.rwkv6_scan.sum_launches
        o, s = rw.rwkv6_scan(r, k, v, w, u, s0)
        sums = rw.rwkv6_scan.sum_launches - sums
        po, ps = ref.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        ulp = 2.0**-7 if dtype == bf16 else 0.0
        ok = bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
        # o comes back in r's layout, but a padded head dim returns a view
        # of the padded output.
        ok &= (o.stride() == r.stride() or dd not in rw.HEAD_DIMS) and r.is_contiguous() != time_major
        line = f"rwkv6_scan  {name:12s} {(bb, hh, tt, dd)} {str(dtype)[6:]}:"
        for nm, g, p, u_ in (("o", o, po, ulp), ("S", s, ps, 0.0)):
            g64, p64 = g.double(), p.double()
            scale = float(p64.abs().max())
            err = float((g64 - p64).abs().max())
            ok &= bool(((g64 - p64).abs() <= u_ * p64.abs() + 1e-5 * scale).all())
            line += f" {nm} {err:.3e} (max {scale:.3f})"
            err_max = max(err_max, err)
        plan = rw.lane_plan(dd, tt)
        print(line + f"  [max|kernel - sequential plain|; o strides {o.stride()}; plan "
                     f"{tuple(plan)}, slab sums {sums}]")
        _check(ok, f"rwkv6_scan {name} vs plain")
        _check(sums == int(plan.slabs > 1),
               f"rwkv6_scan {name}: a slab-sum launch exactly where the plan has slabs")
        if dd > 256:
            # Through the entry the time mix calls: one launch, the same bits.
            before = rw.rwkv6_scan.launches
            with torch.no_grad():
                oo, so = ops.rwkv6_scan(r, k, v, w, u, s0, force="cuda")
            same = torch.equal(oo, o) and torch.equal(so, s)
            print(f"rwkv6_scan  {name} through ops.rwkv6_scan: "
                  f"{rw.rwkv6_scan.launches - before} launch, the same bits: {same}")
            _check(same and rw.rwkv6_scan.launches == before + 1,
                   f"rwkv6_scan {name} through ops.rwkv6_scan")
        if name in ("D 256", "D 512", "D 8192 bf16"):
            nb, no = _rwkv_bytes_ops(r)
            wide[dd] = (_median_ms(lambda: rw.rwkv6_scan(r, k, v, w, u, s0),
                                   reps=5 if dd > 4096 else 25),
                        max(nb / HBM_BYTES_PER_S, no / FP32_FLOP_PER_S) * 1e3, [bb, hh, tt, dd])
            print(f"rwkv6_scan  {name} {(bb, hh, tt, dd)} bf16: kernel {wide[dd][0]:.4f} ms "
                  f"(bound {wide[dd][1]:.4f} ms)")
        del r, k, v, w, u, s0, o, s, po, ps
    # A state carried across two calls equals one call: the kernel does the
    # same operations per step, and the state passes through float32 memory
    # exactly.
    (r, k, v, w, u), s0 = _rwkv_inputs(gen, dev, b, h, t, d, bf16)
    o, s = rw.rwkv6_scan(r, k, v, w, u, s0)
    half = t // 2
    o1, s1 = rw.rwkv6_scan(*(x[:, :, :half] for x in (r, k, v, w)), u, s0)
    o2, s2 = rw.rwkv6_scan(*(x[:, :, half:] for x in (r, k, v, w)), u, s1)
    same = torch.equal(torch.cat([o1, o2], dim=2), o) and torch.equal(s2, s)
    print(f"rwkv6_scan  state carried across two calls of {half} == one call of {t}: {same}")
    _check(same, "rwkv6_scan carried state")
    # The same with a decode step last: T - 1 steps on the chunk kernel,
    # then one on the step kernel, which does the chunk kernel's arithmetic.
    o1, s1 = rw.rwkv6_scan(*(x[:, :, :t - 1] for x in (r, k, v, w)), u, s0)
    o2, s2 = rw.rwkv6_scan(*(x[:, :, t - 1:] for x in (r, k, v, w)), u, s1)
    same = torch.equal(torch.cat([o1, o2], dim=2), o) and torch.equal(s2, s)
    print(f"rwkv6_scan  state carried across calls of {t - 1} and 1 (a decode step) == one call "
          f"of {t}: {same}")
    _check(same, "rwkv6_scan carried state into a decode step")
    # The step kernel against the chunk kernel's single step (its plan for
    # longer calls, forced): the same bits, at every head dim it runs.
    for dd, dtype in ((32, bf16), (64, bf16), (64, f32), (128, bf16)):
        (r1, k1, v1, w1, u1), s01 = _rwkv_inputs(gen, dev, b, 16, 1, dd, dtype)
        os_, ss_ = rw.rwkv6_scan(r1, k1, v1, w1, u1, s01)
        oc_, sc_ = rw.rwkv6_scan(r1, k1, v1, w1, u1, s01, plan=rw.lane_plan(dd, 2))
        same = torch.equal(os_, oc_) and torch.equal(ss_, sc_)
        print(f"rwkv6_scan  decode D {dd} {str(dtype)[6:]}: step kernel {tuple(rw.lane_plan(dd, 1))} "
              f"== chunk kernel {tuple(rw.lane_plan(dd, 2))}: {same}")
        _check(same, f"rwkv6_scan decode D {dd}: step kernel vs chunk kernel")
    # The kernel has no backward (nor has the reference's): under a
    # recording graph the call takes the plain chunked form, the
    # reference's training route, launching nothing, and ``force="cuda"``
    # raises rather than launch a kernel that cannot differentiate.
    before = rw.rwkv6_scan.launches
    rg = r.detach().requires_grad_()
    o_graph, s_graph = ops.rwkv6_scan(rg, k, v, w, u, s0)
    o_plain, s_plain = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=32)
    plain_route = (rw.rwkv6_scan.launches == before and torch.equal(o_graph.detach(), o_plain)
                   and torch.equal(s_graph.detach(), s_plain))
    try:
        ops.rwkv6_scan(rg, k, v, w, u, s0, force="cuda")
        refused = False
    except NotImplementedError:
        refused = True
    del rg, o_graph, s_graph, o_plain, s_plain
    print(f"rwkv6_scan  under a recording autograd graph on the card: the plain chunked form, "
          f"no launch: {plain_route}; force='cuda' refused: {refused}")
    _check(plain_route and refused, "rwkv6_scan under a recording graph")

    ms = _median_ms(lambda: rw.rwkv6_scan(r, k, v, w, u, s0))
    seq_ms = _median_ms(lambda: ref.rwkv6_scan(r, k, v, w, u, s0), reps=5, warmup=1)
    chunk_ms = _median_ms(lambda: ref.rwkv6_chunked(r, k, v, w, u, s0), reps=10)
    dec = [x[:, :, :1] for x in (r, k, v, w)]
    dec_ms = _median_ms(lambda: rw.rwkv6_scan(*dec, u, s0))
    chunk_plan = rw.lane_plan(d, 2)
    dec_chunk_ms = _median_ms(lambda: rw.rwkv6_scan(*dec, u, s0, plan=chunk_plan))
    dec_plain = _median_ms(lambda: ref.rwkv6_scan(*dec, u, s0))
    rw.rwkv6_scan.launches = rw.rwkv6_scan.sum_launches = 0
    print(f"rwkv6_scan  prefill bf16: kernel {ms:.4f} ms, sequential plain {seq_ms:.4f} ms, "
          f"chunked plain {chunk_ms:.4f} ms; decode (T = 1): kernel (the step kernel) "
          f"{dec_ms:.5f} ms, the chunk kernel's single step {dec_chunk_ms:.5f} ms, plain "
          f"{dec_plain:.4f} ms")
    print(f"rwkv6_scan  the kernel before its redesign took {PREVIOUS_KERNEL_MS['rwkv6_scan']:.4f} "
          f"ms a prefill and {PREVIOUS_KERNEL_MS['rwkv6_scan_decode']:.5f} ms a decode step (recorded "
          f"constants, not this run's)")
    nbytes, nops = _rwkv_bytes_ops(r)
    dec_bytes, dec_ops = _rwkv_bytes_ops(dec[0])
    dec_bound = max(dec_bytes / HBM_BYTES_PER_S, dec_ops / FP32_FLOP_PER_S) * 1e3
    # No single PyTorch call computes this recurrence; "plain_ms" is the
    # sequential plain version (what the kernel is held to).
    return kernel_entry(
        "rwkv6_scan", "src/repro_torch/csrc/rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:57",
        err_max, ms, seq_ms, None, nbytes, nops, FP32_FLOP_PER_S, shape=[b, h, t, d],
        dtype="bfloat16", chunked_plain_ms=chunk_ms, decode_ms=dec_ms,
        decode_chunk_kernel_ms=dec_chunk_ms, decode_plain_ms=dec_plain,
        decode_bound_ms=dec_bound, second_pass="rwkv6_slab_sum",
        **{k_: v_ for dd, (ms_, bound_, shape_) in wide.items() for k_, v_ in (
            (f"d{dd}_shape", shape_), (f"d{dd}_ms", ms_), (f"d{dd}_bound_ms", bound_))})


def _rwkv_counts() -> dict:
    from repro_torch.kernels import rwkv6_scan as rw

    return {"rwkv6_scan": rw.rwkv6_scan.launches, "rwkv6_slab_sum": rw.rwkv6_scan.sum_launches,
            **_counts()}


def _reset_rwkv_counts() -> None:
    from repro_torch.kernels import rwkv6_scan as rw

    rw.rwkv6_scan.launches = rw.rwkv6_scan.sum_launches = 0
    _reset_counts()


def phase_rwkv_serve(dev, profile_dir: Path | None = None) -> dict:
    """The ssm serving slice at full rwkv6-7b width: (a) the prefill step,
    launches and logits against the plain versions; (b) greedy generation,
    launches and logits against ``forward``'s; (c) RWKV_SERVE_REF against
    JAX_RWKV_SERVE.  Returns the counts and the timings."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs import full_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, build_prefill_step

    cfg = full_config(RWKV["arch"])
    _check(cfg.family == "ssm" and cfg.dtype == "bfloat16", "rwkv6-7b serves in bf16")
    nl = cfg.n_layers
    t0 = time.perf_counter()
    model = T.init(cfg, device=dev, generator=torch.Generator(dev).manual_seed(RWKV["seed"]))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"rwkv serve: {cfg.name} {n_params} parameters ({cfg.dtype}, {nl} layers) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    per_prefill = {"rwkv6_scan": nl, "rwkv6_slab_sum": 0, "rmsnorm": 3 * nl + 1,
                   "flash_attention_fwd": 0}

    # (a) Prefill: 4 prompts x 512 tokens through the prefill step.
    b, tl = RWKV["prefill"]
    prefill_prompts = torch.as_tensor(
        serve_prompts(cfg.vocab_size, b, tl, RWKV["prompt_seed"]), device=dev)
    step = build_prefill_step(cfg)
    step(model, prefill_prompts, tl)  # warm-up
    with _PlainCalls("rwkv6_scan", "rwkv6_chunked") as plain:
        torch.cuda.synchronize()
        _reset_rwkv_counts()
        t = time.perf_counter()
        logits, state = step(model, prefill_prompts, tl)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        prefill_counts = _rwkv_counts()
    with ops.forced("ref"):
        logits_ref, state_ref = step(model, prefill_prompts, tl)
    with ops.forced("ref", algorithm="sequential"):
        logits_seq, state_seq = step(model, prefill_prompts, tl)
    torch.cuda.synchronize()
    err = _max_err(logits, logits_ref)
    seq_err = _max_err(logits, logits_seq)
    # The two plain runs differ only in the scan's algorithm (float32
    # summation order), with no kernel involved: the floor that the
    # 32-layer stack's amplification of a rounding difference sets.
    floor_err = _max_err(logits_ref, logits_seq)
    # Per layer, the largest state difference relative to the layer's
    # largest state value: how a rounding difference grows with depth.
    rel = lambda a, b: [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]
    layers = sorted({i for i in (0, 1, 3, 7, 15, nl - 1) if i < nl})
    lays = {name: rel(a["blocks"].wkv, c["blocks"].wkv) for name, a, c in (
        ("kernels-chunked", state, state_ref), ("kernels-sequential", state, state_seq),
        ("chunked-sequential", state_ref, state_seq))}
    print(f"rwkv prefill {b} x {tl}: {prefill_s:.4f} s wall, launches {prefill_counts}, plain "
          f"scan calls {plain.n}; logits max|kernels - plain| {err:.4f} with the chunked plain "
          f"scan, {seq_err:.4f} with the sequential one, max|chunked plain - sequential plain| "
          f"{floor_err:.4f} (max|logit| {float(logits_ref.abs().max()):.3f})")
    for name, lay in lays.items():
        print(f"rwkv prefill relative state differences {name:18s} at layers {layers}: "
              f"{[f'{lay[i]:.1e}' for i in layers]}")
    # Each block alone, fed the kernel run's input to it, on the kernels and
    # on the sequential plain versions: the difference one layer makes
    # before the stack amplifies it, in bf16 ulps of the block output's
    # largest value; beside it the chunked plain form against the
    # sequential one, with no kernel involved.
    xs = []
    hooks = [blk.register_forward_pre_hook(lambda m, a: xs.append(a[0].clone()))
             for blk in model.blocks]
    step(model, prefill_prompts, tl)
    for hk in hooks:
        hk.remove()
    ulps_k, ulps_p, state_k = [], [], []
    with torch.inference_mode():
        for blk, x in zip(model.blocks, xs):
            yk, sk = blk(x)
            with ops.forced("ref", algorithm="sequential"):
                yp, sp = blk(x)
            with ops.forced("ref"):
                yc, _ = blk(x)
            unit = _bf16_ulp(float(yp.abs().max()))
            ulps_k.append(_max_err(yk, yp) / unit)
            ulps_p.append(_max_err(yc, yp) / unit)
            state_k.append(float((sk.wkv - sp.wkv).abs().max() / sp.wkv.abs().max()))
    del xs, yk, yp, yc
    print(f"rwkv blocks alone, max|kernels - sequential plain| in bf16 ulps of the block "
          f"output's largest value, layers 0-{nl - 1}: {[f'{u:g}' for u in ulps_k]}; chunked "
          f"plain - sequential plain: {[f'{u:g}' for u in ulps_p]}; relative state differences "
          f"(kernels - sequential plain) up to {max(state_k):.1e}")
    _check(prefill_counts == per_prefill and plain.n == 0, f"rwkv prefill launches {prefill_counts}")
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and state["blocks"].length == tl, "rwkv prefill logits/state")
    _check(max(ulps_k) <= RWKV_BLOCK_ULPS, "rwkv blocks alone, kernels vs plain versions")
    _check(err <= RWKV_PREFILL_TOL and seq_err <= RWKV_PREFILL_TOL,
           "rwkv prefill logits, kernels vs plain versions")
    del logits_ref, state_ref, logits_seq, state_seq, state

    # (b) Generation: 4 requests, 64-token prompts, 32 greedy tokens.
    b, t0p = RWKV["gen"]
    n = RWKV["gen_tokens"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t0p, RWKV["prompt_seed"] + 1),
                              device=dev)
    eng = ServeEngine(cfg, model, max_len=t0p + n, device=dev)
    eng.generate(prompts, 2)  # warm-up
    with _PlainCalls("rwkv6_scan", "rwkv6_chunked") as plain:
        torch.cuda.synchronize()
        _reset_rwkv_counts()
        t = time.perf_counter()
        out = eng.generate(prompts, n)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        gen_counts = _rwkv_counts()
    with torch.inference_mode():
        fwd = T.forward(model, out[:, :-1]).logits[:, t0p - 1:]
    # The generation's own logits (its decode loop fed its own tokens: the
    # state carried across 32 calls) against one fresh pass over the output.
    # The loop repeats generate's calls exactly, so every greedy token is
    # its logits' argmax; with those logits within RWKV_PREFILL_TOL of
    # forward's, a token can differ from forward's argmax only where
    # forward's top-2 margin is within twice that, so the agreement is
    # printed, not checked.
    gen_logits = decode_logits(model, cfg, prompts, out[:, t0p:], t0p + n)
    gen_err = _max_err(gen_logits, fwd)
    own = torch.equal(gen_logits.argmax(-1), out[:, t0p:])
    margin = torch.as_tensor(_top2_margin(fwd.cpu().numpy()))
    agree = fwd.argmax(-1).cpu() == out[:, t0p:].cpu()
    worst = float(margin[~agree].max()) if bool((~agree).any()) else 0.0
    print(f"rwkv generate {b} x ({t0p} + {n}): {gen_s:.4f} s wall, {b * n / gen_s:.1f} tokens/s, "
          f"launches {gen_counts}, plain scan calls {plain.n}; greedy tokens == the argmax of "
          f"their logits: {own}; logits max|generation - forward| {gen_err:.4f}; greedy == "
          f"forward argmax at {int(agree.sum())}/{agree.numel()} positions (largest margin where "
          f"not {worst:.4f}; largest margin {float(margin.max()):.4f})")
    _check(gen_counts == {k: v * n for k, v in per_prefill.items()} and plain.n == 0,
           f"rwkv generation launches {gen_counts}")
    _check(own, "rwkv greedy tokens differ from their logits' argmax")
    _check(gen_err <= RWKV_PREFILL_TOL, "rwkv generation logits vs forward")
    if profile_dir is not None:
        profile_run("rwkv_prefill", lambda: _timed(lambda: step(model, prefill_prompts, tl)),
                    profile_dir)
        profile_run("rwkv_generate", lambda: _timed(lambda: eng.generate(prompts, n)), profile_dir)
    del model, eng, fwd, gen_logits, logits
    torch.cuda.empty_cache()

    # (c) RWKV_SERVE_REF: full width at 4 layers against the JAX package.
    cfg4 = dataclasses.replace(cfg, n_layers=RWKV_SERVE_REF["n_layers"])
    t = time.perf_counter()
    model4 = convert.lm_params_from_numpy(convert.random_lm_tree(cfg4, RWKV["seed"]), cfg4,
                                          device=dev)
    print(f"rwkv vs JAX: random_lm_tree of {RWKV_SERVE_REF['n_layers']} layers moved to the card "
          f"in {time.perf_counter() - t:.1f} s")
    got = port_serve_reference(model4, cfg4, dev, JAX_RWKV_SERVE["tokens"], RWKV_SERVE_REF)
    del model4
    torch.cuda.empty_cache()
    bad, skipped = compare_serve(got, JAX_RWKV_SERVE, RWKV_LOGIT_TOL, RWKV_MARGIN_TOL)
    print(f"rwkv vs JAX: prefill rows and teacher-forced steps max|diff| "
          f"{serve_max_diff(got, JAX_RWKV_SERVE):.4f}; row argmax "
          f"{[g['argmax'] for g in got['rows']]} vs {[w['argmax'] for w in JAX_RWKV_SERVE['rows']]}; "
          f"tokens {got['tokens']} vs {JAX_RWKV_SERVE['tokens']}; {skipped} tokens past a top-2 "
          f"margin <= {RWKV_MARGIN_TOL} not compared")
    _check(not bad, "rwkv serving differs from the JAX package: " + "; ".join(bad))
    return {"prefill": prefill_counts, "generate": gen_counts, "prefill_s": prefill_s,
            "generate_s": gen_s, "tokens_per_s": b * n / gen_s}


# The moe serving slice (phase 17): deepseek-v2-236b and deepseek-v3-671b at
# their published widths (bf16), cut in depth to their leading dense layers
# and one MoE layer.  v2: 2 layers (1 dense + 1 MoE; 160 experts top-6, 2
# shared, capacity factor 1.25; 5.36 B parameters), weights
# ``convert.random_lm_leaves(cfg, seed)`` drawn on the host and moved to the
# card one leaf at a time (its float32 tree is 20 GB); v3: 4 layers (3 dense
# + 1 MoE; 256 experts top-8, the sigmoid-bias router, MTP; 15.8 B
# parameters), drawn on the card by ``transformer.init`` (its float32 tree,
# 58.8 GB, would not fit the host beside it).  Prefill 4 x 512 tokens;
# generation 4 requests, 64-token prompts, 32 greedy tokens.
MOE_V2 = dict(arch="deepseek_v2_236b", n_layers=2, seed=0, prompt_seed=1, prefill=(4, 512),
              gen=(4, 64), gen_tokens=32)
MOE_V3 = dict(arch="deepseek_v3_671b", n_layers=4, seed=0, prompt_seed=1, prefill=(4, 512),
              gen=(4, 64), gen_tokens=32)
# What tests/test_torch_moe_serve_reference.py runs through the JAX package
# on the CPU (v2 at MOE_V2's width and depth) and what the card's run is
# held to: SERVE_REF's prefill rows, 8 greedy tokens and the teacher-forced
# decode logits; the routing of the MoE layer (``routing_record``) in the
# prefill step, in each call of the teacher-forced decode loop and in
# ``forward`` on the 2 x 64 prompts; ``forward``'s expert load (as counts)
# and dropped fraction on the prompts: 128 tokens at capacity max(int(1.25 *
# 128 * 6 / 160), 6) = 6 slots an expert drop pairs at the published
# factor.
MOE_SERVE_REF = dict(SERVE_REF, prompt_seed=MOE_V2["prompt_seed"])
# The JAX package's numbers for MOE_SERVE_REF (bf16, weights
# ``random_lm_leaves(cfg, MOE_V2["seed"])``), on the CPU (jax 0.9.0), printed by
# ``python tests/test_torch_moe_serve_reference.py``.
JAX_MOE_SERVE = {'aux': {'dropped_fraction': 0.4544270634651184,
         'expert_counts': [0, 1, 8, 0, 2, 5, 2, 26, 6, 0, 2, 1, 0, 0, 2, 4, 0, 0, 1, 6, 4, 6, 0, 1,
                           0, 7, 0, 24, 0, 1, 6, 13, 11, 3, 0, 0, 1, 0, 12, 4, 26, 0, 6, 0, 4, 11,
                           3, 1, 5, 0, 3, 8, 9, 2, 2, 2, 2, 0, 2, 7, 2, 1, 2, 33, 2, 2, 4, 0, 15, 1,
                           0, 22, 0, 27, 9, 1, 3, 1, 1, 2, 0, 2, 5, 2, 0, 1, 1, 1, 2, 1, 1, 14, 0,
                           3, 40, 2, 0, 0, 2, 3, 0, 0, 3, 10, 22, 1, 16, 0, 0, 2, 36, 0, 1, 7, 0, 0,
                           0, 2, 1, 21, 1, 1, 3, 0, 5, 6, 6, 0, 10, 13, 2, 4, 3, 3, 0, 0, 4, 8, 8,
                           3, 0, 1, 21, 3, 0, 0, 1, 3, 0, 8, 5, 0, 27, 0, 6, 17, 2, 1, 7, 4]},
 'routing': {'decode': [{'margin': [0.117493, 0.012803, 0.0568406, 0.0579893, 0.0765822, 0.0796589,
                                    0.0044342, 0.00839006, 0.0105039, 0.231076, 0.0300507, 0.235994,
                                    0.128921, 0.0336905, 0.0877183, 0.065331, 0.0936591, 0.140386,
                                    0.113572, 0.062317, 0.169876, 0.260963, 0.0619655, 0.167151,
                                    0.00713262, 0.107093, 0.018889, 0.027612, 0.221679, 0.00221987,
                                    0.0363553, 0.0671759, 0.0408986, 0.0060672, 0.240879, 0.0525568,
                                    0.243942, 0.099451, 0.00213593, 0.0672668, 0.0169291, 0.0755787,
                                    0.053512, 0.0180227, 0.139886, 0.0801049, 0.179759, 0.0513099,
                                    0.00516943, 0.227425, 0.0274481, 0.0209044, 0.17132, 0.1541,
                                    0.30399, 0.018186, 0.120361, 0.116167, 0.00211625, 0.138238,
                                    0.0408718, 0.0330812, 0.0297725, 0.145154, 0.20693, 0.0195702,
                                    0.152758, 0.0766375, 0.379166, 0.181868, 0.13818, 0.363224,
                                    0.3341, 0.0625282, 0.120865, 0.0445889, 0.0149873, 0.262462,
                                    0.325042, 0.0615339, 0.0237258, 0.00858062, 0.0293499, 0.132494,
                                    0.116657, 0.0634176, 0.217113, 0.0579004, 0.259366, 0.0537992,
                                    0.0113976, 0.0434985, 0.0944401, 0.104843, 0.00535796,
                                    0.0491974, 0.0513843, 0.0501449, 0.16946, 0.0226195, 0.0166075,
                                    0.0859678, 0.0200253, 0.122086, 0.0626944, 0.0304216, 0.0117891,
                                    0.146079, 0.141787, 0.0502434, 0.195716, 0.00642688, 0.214552,
                                    0.0151696, 0.0724931, 0.00727575, 0.0261783, 0.015844, 0.128768,
                                    0.011229, 0.0448228, 0.0816496, 0.163918, 0.042522, 0.0301517,
                                    0.0132073, 0.0726968, 0.152615],
                         'picks': [[7, 104, 33, 74, 59, 73], [7, 104, 66, 52, 59, 63],
                                   [7, 126, 122, 63, 68, 40], [132, 104, 136, 7, 40, 68],
                                   [126, 158, 117, 40, 93, 27], [40, 63, 59, 117, 45, 143],
                                   [93, 21, 68, 126, 7, 138], [122, 59, 63, 7, 27, 158],
                                   [39, 63, 138, 126, 129, 78], [59, 63, 52, 68, 51, 126],
                                   [63, 158, 68, 152, 52, 45], [59, 63, 45, 152, 32, 150],
                                   [63, 94, 7, 136, 152, 52], [63, 7, 59, 104, 99, 129],
                                   [152, 45, 40, 63, 68, 58], [152, 27, 63, 7, 104, 128],
                                   [63, 152, 40, 104, 99, 27], [152, 129, 104, 126, 102, 124],
                                   [7, 152, 102, 45, 104, 21], [152, 73, 27, 63, 129, 25],
                                   [93, 52, 98, 63, 27, 42], [152, 27, 63, 131, 158, 45],
                                   [152, 66, 147, 27, 128, 10], [63, 152, 25, 68, 98, 104],
                                   [7, 152, 40, 63, 104, 159], [99, 63, 25, 158, 152, 51],
                                   [66, 7, 42, 104, 51, 40], [68, 60, 76, 130, 152, 50],
                                   [152, 68, 27, 63, 56, 129], [68, 152, 73, 42, 58, 53],
                                   [129, 40, 73, 131, 71, 139], [65, 68, 152, 7, 21, 73],
                                   [63, 104, 143, 159, 132, 73], [73, 63, 131, 158, 91, 45],
                                   [152, 40, 131, 25, 73, 136], [63, 91, 52, 40, 152, 129],
                                   [40, 7, 152, 136, 104, 27], [129, 63, 51, 152, 48, 7],
                                   [30, 63, 128, 8, 53, 27], [7, 42, 52, 152, 86, 129],
                                   [69, 40, 7, 63, 128, 27], [138, 68, 91, 104, 124, 7],
                                   [104, 68, 130, 40, 7, 52], [27, 50, 7, 60, 118, 128],
                                   [51, 19, 42, 91, 158, 40], [30, 128, 27, 7, 122, 21],
                                   [143, 30, 68, 40, 104, 27], [51, 138, 104, 19, 25, 91],
                                   [27, 64, 63, 65, 137, 88], [11, 91, 42, 45, 40, 129],
                                   [40, 73, 150, 27, 30, 129], [23, 30, 152, 25, 150, 40],
                                   [129, 7, 51, 132, 138, 150], [91, 8, 30, 27, 128, 104],
                                   [27, 7, 104, 14, 139, 82], [128, 66, 133, 7, 68, 104],
                                   [27, 19, 78, 152, 128, 138], [27, 18, 40, 137, 95, 102],
                                   [7, 91, 129, 128, 56, 138], [104, 39, 7, 45, 91, 139],
                                   [73, 27, 64, 39, 45, 36], [133, 27, 91, 77, 73, 51],
                                   [1, 91, 152, 39, 121, 159], [27, 91, 133, 14, 104, 52],
                                   [138, 103, 48, 119, 2, 89], [119, 25, 103, 155, 48, 2],
                                   [48, 71, 119, 15, 95, 10], [71, 119, 74, 15, 2, 154],
                                   [74, 155, 31, 71, 4, 110], [74, 119, 110, 155, 94, 73],
                                   [110, 94, 2, 155, 32, 124], [119, 125, 155, 15, 74, 154],
                                   [142, 32, 110, 73, 103, 94], [94, 74, 119, 21, 103, 82],
                                   [94, 32, 38, 74, 76, 31], [142, 103, 94, 110, 31, 82],
                                   [21, 94, 31, 2, 155, 32], [94, 125, 31, 110, 142, 73],
                                   [32, 110, 142, 155, 94, 106], [94, 110, 124, 71, 31, 137],
                                   [38, 71, 110, 31, 4, 5], [155, 73, 71, 146, 31, 83],
                                   [154, 63, 31, 103, 110, 73], [110, 94, 119, 20, 147, 76],
                                   [110, 142, 147, 125, 31, 74], [94, 73, 71, 2, 154, 155],
                                   [94, 31, 44, 19, 157, 106], [110, 94, 38, 63, 31, 33],
                                   [103, 71, 106, 142, 20, 63], [94, 15, 154, 5, 32, 74],
                                   [110, 50, 44, 106, 71, 94], [71, 81, 142, 73, 19, 48],
                                   [142, 94, 103, 20, 46, 44], [94, 63, 155, 119, 106, 149],
                                   [94, 110, 142, 8, 73, 83], [94, 32, 110, 47, 27, 119],
                                   [110, 94, 106, 2, 119, 152], [71, 106, 110, 32, 87, 155],
                                   [137, 142, 110, 71, 106, 19], [94, 8, 71, 82, 113, 32],
                                   [110, 119, 63, 38, 31, 137], [54, 154, 106, 110, 79, 103],
                                   [155, 94, 141, 125, 142, 119], [94, 156, 106, 29, 38, 137],
                                   [73, 20, 106, 142, 155, 62], [119, 149, 54, 110, 94, 113],
                                   [94, 103, 38, 5, 119, 46], [38, 155, 5, 94, 110, 63],
                                   [94, 33, 85, 110, 106, 40], [62, 125, 38, 149, 142, 110],
                                   [94, 110, 40, 142, 38, 91], [8, 155, 106, 110, 94, 38],
                                   [119, 94, 149, 71, 55, 110], [73, 142, 110, 119, 94, 5],
                                   [94, 71, 149, 119, 142, 73], [71, 113, 110, 32, 94, 40],
                                   [71, 94, 81, 110, 40, 73], [110, 155, 112, 124, 46, 119],
                                   [106, 110, 6, 125, 38, 142], [73, 110, 79, 109, 6, 72],
                                   [71, 142, 38, 113, 110, 156], [119, 94, 113, 2, 61, 142],
                                   [159, 149, 73, 94, 71, 82], [119, 38, 110, 137, 142, 55],
                                   [90, 119, 155, 105, 113, 94], [71, 113, 106, 40, 109, 44],
                                   [137, 142, 53, 71, 149, 73], [94, 73, 40, 149, 120, 8]],
                         'sel_k': [0.0267296, 0.0305833, 0.0360003, 0.0256791, 0.0267602, 0.0325515,
                                   0.0318478, 0.0349868, 0.031862, 0.0348182, 0.0298442, 0.0385842,
                                   0.029834, 0.0321741, 0.0285199, 0.0266722, 0.0247294, 0.0323696,
                                   0.0247338, 0.0226627, 0.0278393, 0.0288425, 0.0263215, 0.0305182,
                                   0.0297671, 0.0288247, 0.0217126, 0.0217715, 0.0358186, 0.0283027,
                                   0.0288785, 0.0298379, 0.02923, 0.033604, 0.0395393, 0.0338801,
                                   0.0313197, 0.0330124, 0.0289116, 0.029895, 0.0336338, 0.0274694,
                                   0.028419, 0.0228919, 0.0319873, 0.0328, 0.0341596, 0.0425579,
                                   0.0281455, 0.0237062, 0.0192194, 0.0431649, 0.0326964, 0.0274285,
                                   0.0284577, 0.0303975, 0.0233533, 0.0315341, 0.0289683, 0.040047,
                                   0.0290407, 0.0388726, 0.0255459, 0.0311579, 0.0239364, 0.0264727,
                                   0.0297239, 0.0326553, 0.0364086, 0.0337594, 0.0297569, 0.0386977,
                                   0.0379442, 0.027301, 0.0251774, 0.0390003, 0.0350063, 0.0250796,
                                   0.0441634, 0.0184216, 0.0406997, 0.019288, 0.0304927, 0.0276992,
                                   0.0323517, 0.0284221, 0.037206, 0.0185504, 0.0375551, 0.0281801,
                                   0.0139017, 0.0319042, 0.0254793, 0.02522, 0.0213258, 0.0277345,
                                   0.0245765, 0.0243925, 0.0428061, 0.0268006, 0.0294488, 0.0313956,
                                   0.0291993, 0.0251085, 0.0233591, 0.0238727, 0.0300992, 0.0359524,
                                   0.0295572, 0.0358564, 0.0374465, 0.0276872, 0.0363946, 0.0253985,
                                   0.0331141, 0.0265893, 0.0349446, 0.0271952, 0.0277486, 0.0354949,
                                   0.0261413, 0.0296385, 0.0399805, 0.0265738, 0.0398578, 0.0287645,
                                   0.0276593, 0.032304],
                         'slope': [0.0260152, 0.029648, 0.0347043, 0.0250197, 0.0260441, 0.0314919,
                                   0.0308335, 0.0337627, 0.0308469, 0.0336059, 0.0289535, 0.0370955,
                                   0.0289439, 0.0311389, 0.0277065, 0.0259608, 0.0241178, 0.0313218,
                                   0.0241221, 0.0221491, 0.0270643, 0.0280106, 0.0256287, 0.0295868,
                                   0.028881, 0.0279938, 0.0212411, 0.0212975, 0.0345356, 0.0275016,
                                   0.0280446, 0.0289476, 0.0283756, 0.0324747, 0.037976, 0.0327322,
                                   0.0303388, 0.0319226, 0.0280757, 0.0290013, 0.0325025, 0.0267148,
                                   0.0276114, 0.0223679, 0.0309641, 0.0317242, 0.0329928, 0.0407467,
                                   0.0273533, 0.0231442, 0.01885, 0.0413017, 0.0316273, 0.0266762,
                                   0.0276478, 0.0294735, 0.0228079, 0.0305397, 0.0281291, 0.0384432,
                                   0.0281973, 0.0373616, 0.0248933, 0.0301871, 0.0233635, 0.0257719,
                                   0.0288404, 0.0315889, 0.035083, 0.0326197, 0.0288715, 0.0372002,
                                   0.0365044, 0.0265557, 0.0245435, 0.0374793, 0.0337809, 0.0244506,
                                   0.042213, 0.0180823, 0.0390432, 0.018916, 0.0295629, 0.026932,
                                   0.031305, 0.0276143, 0.0358217, 0.0182063, 0.0361447, 0.027386,
                                   0.0137084, 0.0308864, 0.0248301, 0.0245839, 0.020871, 0.0269653,
                                   0.0239725, 0.0237975, 0.0409738, 0.0260823, 0.0285816, 0.03041,
                                   0.0283467, 0.0244781, 0.0228135, 0.0233028, 0.0291933, 0.0346598,
                                   0.0286836, 0.0345707, 0.0360443, 0.0269206, 0.0350701, 0.0247535,
                                   0.0320176, 0.0258823, 0.0337235, 0.0264556, 0.0269787, 0.034235,
                                   0.0254579, 0.0287601, 0.038382, 0.0258676, 0.0382692, 0.0279371,
                                   0.0268942, 0.0312604]},
                        {'margin': [0.020319, 0.100283],
                         'picks': [[93, 119, 52, 8, 133, 27], [73, 12, 71, 133, 142, 108]],
                         'sel_k': [0.0269955, 0.029967],
                         'slope': [0.0262667, 0.029069]},
                        {'margin': [0.0230136, 0.0264737],
                         'picks': [[27, 73, 45, 137, 60, 39], [4, 33, 110, 149, 38, 5]],
                         'sel_k': [0.0317488, 0.0279389],
                         'slope': [0.0307408, 0.0271584]},
                        {'margin': [0.00761635, 0.144437],
                         'picks': [[153, 14, 1, 91, 89, 27], [71, 110, 87, 55, 40, 130]],
                         'sel_k': [0.0305324, 0.0349996],
                         'slope': [0.0296002, 0.0337747]},
                        {'margin': [0.03134, 0.00218227],
                         'picks': [[27, 60, 40, 68, 133, 73], [47, 71, 133, 24, 149, 108]],
                         'sel_k': [0.0325096, 0.0360947],
                         'slope': [0.0314527, 0.0347919]},
                        {'margin': [0.0321397, 0.364496],
                         'picks': [[158, 40, 152, 32, 93, 71], [38, 108, 142, 94, 81, 44]],
                         'sel_k': [0.0277162, 0.0461636],
                         'slope': [0.026948, 0.0440326]},
                        {'margin': [0.102274, 0.0392021],
                         'picks': [[129, 51, 27, 158, 144, 130], [113, 94, 8, 149, 105, 125]],
                         'sel_k': [0.0285732, 0.029],
                         'slope': [0.0277568, 0.028159]},
                        {'margin': [0.0100523, 0.0474314],
                         'picks': [[30, 152, 138, 64, 27, 7], [40, 87, 134, 94, 82, 140]],
                         'sel_k': [0.0265308, 0.0327407],
                         'slope': [0.0258269, 0.0316688]}],
             'forward': {'margin': [0.117493, 0.0353162, 0.0702235, 0.0707795, 0.0794145, 0.0925574,
                                    0.00378577, 0.0188434, 0.0233973, 0.231095, 0.0308346, 0.247235,
                                    0.123999, 0.035203, 0.0761077, 0.0564374, 0.0709632, 0.149929,
                                    0.135809, 0.0871758, 0.168349, 0.263302, 0.0804013, 0.191332,
                                    0.00512431, 0.107775, 0.0352835, 0.0402006, 0.215061,
                                    0.00742296, 0.0416637, 0.0938842, 0.0543211, 0.000672136,
                                    0.252273, 0.0430372, 0.235335, 0.0818043, 0.0052209, 0.0764421,
                                    0.0380796, 0.0701034, 0.0444257, 0.00069104, 0.140032, 0.117362,
                                    0.14892, 0.0221717, 0.0302089, 0.229377, 0.039345, 0.0404339,
                                    0.161515, 0.139335, 0.309602, 0.0177067, 0.124474, 0.134472,
                                    0.00670342, 0.131544, 0.0409234, 0.011552, 0.0380291, 0.121777,
                                    0.20693, 0.0158409, 0.154177, 0.0686995, 0.392793, 0.207984,
                                    0.123523, 0.355083, 0.340861, 0.0307054, 0.120016, 0.0595996,
                                    0.0480053, 0.250123, 0.310421, 0.0385352, 0.0199895, 0.0281485,
                                    0.0029318, 0.121481, 0.136786, 0.0812364, 0.20061, 0.0596181,
                                    0.272767, 0.0542741, 0.000227383, 0.0689399, 0.0958972,
                                    0.0965825, 0.0220748, 0.0399502, 0.0794494, 0.0580491, 0.159064,
                                    0.0376504, 0.0322465, 0.0835607, 0.00953413, 0.11634, 0.0482843,
                                    0.016303, 0.0344376, 0.141141, 0.156175, 0.0712992, 0.196741,
                                    0.0105569, 0.204375, 0.00385307, 0.0874827, 0.0306522,
                                    0.0235795, 0.000990244, 0.119615, 0.00544378, 0.0596898,
                                    0.0745427, 0.141043, 0.0447164, 0.0273367, 0.0536267, 0.069913,
                                    0.154478],
                         'picks': [[7, 104, 33, 74, 59, 73], [7, 104, 66, 52, 59, 63],
                                   [7, 126, 122, 63, 68, 40], [132, 104, 136, 7, 40, 68],
                                   [126, 158, 117, 40, 93, 27], [40, 63, 59, 117, 45, 143],
                                   [93, 21, 68, 126, 7, 138], [122, 59, 63, 7, 27, 158],
                                   [39, 63, 138, 126, 129, 45], [59, 63, 52, 68, 51, 126],
                                   [63, 158, 68, 152, 52, 45], [59, 63, 45, 152, 32, 150],
                                   [63, 94, 7, 136, 152, 52], [63, 7, 59, 104, 99, 129],
                                   [152, 45, 40, 63, 68, 58], [152, 27, 63, 7, 104, 128],
                                   [63, 152, 40, 104, 99, 27], [152, 129, 104, 126, 102, 124],
                                   [7, 152, 102, 45, 104, 21], [152, 73, 27, 63, 129, 25],
                                   [93, 52, 98, 27, 63, 42], [152, 27, 63, 131, 158, 45],
                                   [152, 66, 147, 27, 128, 10], [63, 152, 68, 25, 98, 104],
                                   [7, 152, 40, 63, 104, 91], [99, 63, 25, 152, 158, 51],
                                   [66, 7, 42, 104, 51, 40], [68, 60, 76, 130, 152, 50],
                                   [152, 68, 27, 63, 56, 129], [68, 152, 73, 42, 58, 150],
                                   [129, 40, 73, 131, 71, 139], [65, 68, 152, 7, 21, 73],
                                   [63, 104, 143, 159, 73, 132], [73, 63, 131, 158, 91, 45],
                                   [152, 40, 131, 25, 73, 136], [63, 91, 52, 40, 152, 129],
                                   [40, 7, 152, 136, 104, 27], [129, 63, 51, 152, 48, 7],
                                   [30, 63, 128, 8, 53, 75], [7, 42, 52, 152, 86, 129],
                                   [69, 40, 7, 63, 128, 27], [138, 68, 91, 104, 124, 7],
                                   [104, 68, 130, 40, 7, 52], [27, 50, 7, 60, 128, 118],
                                   [51, 19, 42, 91, 158, 40], [30, 128, 27, 7, 122, 21],
                                   [143, 30, 68, 40, 104, 27], [51, 138, 104, 19, 25, 91],
                                   [27, 64, 63, 65, 137, 88], [11, 91, 42, 45, 40, 129],
                                   [40, 73, 150, 27, 30, 129], [23, 30, 152, 25, 150, 40],
                                   [129, 7, 51, 132, 138, 150], [91, 8, 27, 30, 128, 104],
                                   [27, 7, 104, 14, 139, 82], [128, 66, 133, 7, 68, 104],
                                   [27, 19, 78, 152, 128, 138], [27, 18, 40, 137, 95, 102],
                                   [7, 91, 129, 128, 56, 138], [104, 39, 7, 45, 91, 139],
                                   [73, 27, 64, 39, 45, 36], [133, 27, 91, 77, 73, 51],
                                   [1, 91, 152, 39, 121, 159], [27, 91, 133, 104, 14, 52],
                                   [138, 103, 48, 119, 2, 89], [119, 25, 103, 155, 48, 2],
                                   [48, 71, 119, 15, 95, 10], [71, 119, 74, 15, 2, 154],
                                   [74, 155, 31, 71, 4, 110], [74, 119, 110, 155, 94, 73],
                                   [110, 94, 2, 155, 32, 124], [119, 125, 155, 15, 74, 154],
                                   [142, 32, 110, 73, 103, 94], [94, 74, 119, 21, 103, 82],
                                   [94, 32, 38, 74, 76, 31], [142, 103, 94, 110, 31, 82],
                                   [94, 21, 31, 2, 155, 32], [94, 125, 31, 110, 142, 73],
                                   [32, 110, 142, 155, 94, 106], [94, 110, 124, 71, 31, 137],
                                   [38, 71, 110, 31, 4, 5], [155, 73, 71, 146, 31, 83],
                                   [154, 63, 31, 103, 110, 73], [110, 94, 119, 20, 147, 76],
                                   [110, 142, 147, 125, 31, 74], [94, 73, 71, 2, 154, 155],
                                   [94, 31, 44, 19, 157, 106], [110, 94, 38, 63, 31, 33],
                                   [103, 71, 106, 142, 63, 20], [94, 15, 154, 5, 32, 74],
                                   [110, 50, 44, 106, 71, 94], [71, 81, 142, 73, 19, 48],
                                   [142, 94, 103, 20, 46, 44], [94, 63, 155, 119, 106, 149],
                                   [94, 110, 142, 8, 73, 83], [94, 32, 110, 47, 27, 119],
                                   [110, 94, 106, 2, 119, 152], [71, 106, 110, 32, 87, 155],
                                   [137, 142, 110, 71, 106, 19], [94, 8, 71, 82, 113, 32],
                                   [110, 119, 63, 38, 31, 137], [54, 154, 106, 79, 110, 103],
                                   [155, 94, 141, 125, 142, 106], [94, 156, 106, 29, 38, 137],
                                   [73, 20, 106, 142, 155, 62], [119, 54, 149, 110, 94, 113],
                                   [94, 103, 38, 5, 119, 46], [38, 155, 5, 94, 110, 63],
                                   [94, 33, 85, 110, 106, 40], [62, 125, 38, 149, 142, 110],
                                   [94, 110, 40, 142, 38, 91], [8, 155, 106, 110, 94, 88],
                                   [119, 94, 149, 71, 55, 110], [73, 142, 110, 119, 94, 5],
                                   [94, 71, 149, 119, 142, 73], [71, 113, 110, 32, 94, 40],
                                   [71, 94, 81, 110, 40, 73], [110, 155, 112, 124, 46, 119],
                                   [106, 110, 6, 125, 142, 38], [73, 110, 79, 109, 6, 159],
                                   [71, 142, 38, 113, 110, 156], [119, 94, 113, 2, 61, 142],
                                   [159, 149, 73, 94, 71, 82], [119, 38, 110, 137, 142, 55],
                                   [90, 119, 155, 105, 113, 94], [71, 113, 106, 40, 109, 44],
                                   [137, 142, 53, 71, 149, 73], [94, 73, 40, 149, 120, 8]],
                         'sel_k': [0.0267296, 0.0309432, 0.0361319, 0.0259752, 0.0269285, 0.0327512,
                                   0.0321715, 0.0348023, 0.0318118, 0.0345693, 0.0297321, 0.0391971,
                                   0.0298698, 0.0316615, 0.0280714, 0.0264353, 0.0248791, 0.032375,
                                   0.0248116, 0.0230674, 0.0278991, 0.0284709, 0.0263445, 0.0310245,
                                   0.0298029, 0.0288965, 0.021548, 0.0218924, 0.0357576, 0.028386,
                                   0.0292367, 0.0301164, 0.0294829, 0.0332935, 0.0399462, 0.0334483,
                                   0.0306582, 0.0328542, 0.0287931, 0.0298851, 0.0344952, 0.0272592,
                                   0.0285299, 0.0229273, 0.0321452, 0.0336661, 0.0336144, 0.0421149,
                                   0.0284798, 0.0239696, 0.0191131, 0.044064, 0.0325628, 0.0274184,
                                   0.0287681, 0.0302496, 0.0235339, 0.0317245, 0.02932, 0.0402,
                                   0.0282328, 0.0384974, 0.0259519, 0.0310276, 0.0239364, 0.026411,
                                   0.0296214, 0.0327234, 0.0369519, 0.0342201, 0.0293891, 0.038369,
                                   0.0379361, 0.0269924, 0.0253266, 0.0396096, 0.0353267, 0.0249022,
                                   0.0437726, 0.0181041, 0.0405028, 0.0195911, 0.0303168, 0.0279472,
                                   0.0322816, 0.0288579, 0.0370517, 0.0188735, 0.0381647, 0.0284261,
                                   0.0136493, 0.0325636, 0.0253655, 0.0253857, 0.0215777, 0.0266756,
                                   0.0247382, 0.0242346, 0.0427974, 0.026691, 0.0296337, 0.0315739,
                                   0.028924, 0.0252897, 0.0231128, 0.0241054, 0.0305778, 0.035623,
                                   0.0293885, 0.0361354, 0.0372122, 0.028125, 0.0365, 0.0247268,
                                   0.0333237, 0.0269397, 0.0347405, 0.0265736, 0.0273941, 0.0351616,
                                   0.0264089, 0.0297452, 0.0390756, 0.0266435, 0.0396156, 0.0296616,
                                   0.0275672, 0.0321219],
                         'slope': [0.0260152, 0.0299858, 0.0348264, 0.0253005, 0.0262034, 0.0316786,
                                   0.0311365, 0.0335911, 0.0307998, 0.0333742, 0.0288481, 0.0376607,
                                   0.0289776, 0.0306591, 0.0272834, 0.0257365, 0.0242601, 0.0313269,
                                   0.024196, 0.0225353, 0.0271208, 0.0276603, 0.0256505, 0.0300619,
                                   0.0289147, 0.0280615, 0.0210837, 0.0214131, 0.034479, 0.0275802,
                                   0.0283819, 0.0292094, 0.0286136, 0.0321851, 0.0383505, 0.0323295,
                                   0.0297183, 0.0317748, 0.0279641, 0.028992, 0.0333053, 0.0265161,
                                   0.0277159, 0.0224017, 0.0311118, 0.0325327, 0.0324845, 0.0403413,
                                   0.0276687, 0.023395, 0.0187478, 0.0421223, 0.0315024, 0.0266666,
                                   0.0279405, 0.0293346, 0.02298, 0.0307181, 0.0284603, 0.038584,
                                   0.0274357, 0.0370153, 0.0252784, 0.0300649, 0.0233635, 0.0257135,
                                   0.028744, 0.0316526, 0.0355865, 0.0330491, 0.0285254, 0.0368968,
                                   0.036497, 0.0262638, 0.0246852, 0.0380407, 0.0340787, 0.024282,
                                   0.0418566, 0.0177764, 0.0388623, 0.0192073, 0.0293977, 0.0271661,
                                   0.0312395, 0.0280251, 0.0356789, 0.0185173, 0.0367081, 0.027618,
                                   0.013463, 0.0315032, 0.0247221, 0.0247413, 0.0211121, 0.0259641,
                                   0.0241262, 0.0236473, 0.0409658, 0.0259786, 0.0287555, 0.030577,
                                   0.0280874, 0.0246502, 0.0225786, 0.0235243, 0.0296428, 0.034354,
                                   0.0285249, 0.0348296, 0.0358274, 0.027334, 0.0351677, 0.0241154,
                                   0.0322133, 0.0262139, 0.0335336, 0.0258675, 0.0266436, 0.0339252,
                                   0.0257114, 0.0288605, 0.0375487, 0.0259337, 0.0380462, 0.0287818,
                                   0.0268073, 0.0310901]},
             'prefill': {'margin': [0.117493, 0.0353162, 0.0702235, 0.0707795, 0.0794145, 0.0925574,
                                    0.00378577, 0.0188434, 0.0233973, 0.231095, 0.0308346, 0.247235,
                                    0.123999, 0.035203, 0.0761077, 0.0564374, 0.0709632, 0.149929,
                                    0.135809, 0.0871758, 0.168349, 0.263302, 0.0804013, 0.191332,
                                    0.00512431, 0.107775, 0.0352835, 0.0402006, 0.215061,
                                    0.00742296, 0.0416637, 0.0938842, 0.0543211, 0.000672136,
                                    0.252273, 0.0430372, 0.235335, 0.0818043, 0.0052209, 0.0764421,
                                    0.0380796, 0.0701034, 0.0444257, 0.00069104, 0.140032, 0.117362,
                                    0.14892, 0.0221717, 0.0302089, 0.229377, 0.039345, 0.0404339,
                                    0.161515, 0.139335, 0.309602, 0.0177067, 0.124474, 0.134472,
                                    0.00670342, 0.131544, 0.0409234, 0.011552, 0.0380291, 0.121777,
                                    0.20693, 0.0158409, 0.154177, 0.0686995, 0.392793, 0.207984,
                                    0.123523, 0.355083, 0.340861, 0.0307054, 0.120016, 0.0595996,
                                    0.0480053, 0.250123, 0.310421, 0.0385352, 0.0199895, 0.0281485,
                                    0.0029318, 0.121481, 0.136786, 0.0812364, 0.20061, 0.0596181,
                                    0.272767, 0.0542741, 0.000227383, 0.0689399, 0.0958972,
                                    0.0965825, 0.0220748, 0.0399502, 0.0794494, 0.0580491, 0.159064,
                                    0.0376504, 0.0322465, 0.0835607, 0.00953413, 0.11634, 0.0482843,
                                    0.016303, 0.0344376, 0.141141, 0.156175, 0.0712992, 0.196741,
                                    0.0105569, 0.204375, 0.00385307, 0.0874827, 0.0306522,
                                    0.0235795, 0.000990244, 0.119615, 0.00544378, 0.0596898,
                                    0.0745427, 0.141043, 0.0447164, 0.0273367, 0.0536267, 0.069913,
                                    0.154478],
                         'picks': [[7, 104, 33, 74, 59, 73], [7, 104, 66, 52, 59, 63],
                                   [7, 126, 122, 63, 68, 40], [132, 104, 136, 7, 40, 68],
                                   [126, 158, 117, 40, 93, 27], [40, 63, 59, 117, 45, 143],
                                   [93, 21, 68, 126, 7, 138], [122, 59, 63, 7, 27, 158],
                                   [39, 63, 138, 126, 129, 45], [59, 63, 52, 68, 51, 126],
                                   [63, 158, 68, 152, 52, 45], [59, 63, 45, 152, 32, 150],
                                   [63, 94, 7, 136, 152, 52], [63, 7, 59, 104, 99, 129],
                                   [152, 45, 40, 63, 68, 58], [152, 27, 63, 7, 104, 128],
                                   [63, 152, 40, 104, 99, 27], [152, 129, 104, 126, 102, 124],
                                   [7, 152, 102, 45, 104, 21], [152, 73, 27, 63, 129, 25],
                                   [93, 52, 98, 27, 63, 42], [152, 27, 63, 131, 158, 45],
                                   [152, 66, 147, 27, 128, 10], [63, 152, 68, 25, 98, 104],
                                   [7, 152, 40, 63, 104, 91], [99, 63, 25, 152, 158, 51],
                                   [66, 7, 42, 104, 51, 40], [68, 60, 76, 130, 152, 50],
                                   [152, 68, 27, 63, 56, 129], [68, 152, 73, 42, 58, 150],
                                   [129, 40, 73, 131, 71, 139], [65, 68, 152, 7, 21, 73],
                                   [63, 104, 143, 159, 73, 132], [73, 63, 131, 158, 91, 45],
                                   [152, 40, 131, 25, 73, 136], [63, 91, 52, 40, 152, 129],
                                   [40, 7, 152, 136, 104, 27], [129, 63, 51, 152, 48, 7],
                                   [30, 63, 128, 8, 53, 75], [7, 42, 52, 152, 86, 129],
                                   [69, 40, 7, 63, 128, 27], [138, 68, 91, 104, 124, 7],
                                   [104, 68, 130, 40, 7, 52], [27, 50, 7, 60, 128, 118],
                                   [51, 19, 42, 91, 158, 40], [30, 128, 27, 7, 122, 21],
                                   [143, 30, 68, 40, 104, 27], [51, 138, 104, 19, 25, 91],
                                   [27, 64, 63, 65, 137, 88], [11, 91, 42, 45, 40, 129],
                                   [40, 73, 150, 27, 30, 129], [23, 30, 152, 25, 150, 40],
                                   [129, 7, 51, 132, 138, 150], [91, 8, 27, 30, 128, 104],
                                   [27, 7, 104, 14, 139, 82], [128, 66, 133, 7, 68, 104],
                                   [27, 19, 78, 152, 128, 138], [27, 18, 40, 137, 95, 102],
                                   [7, 91, 129, 128, 56, 138], [104, 39, 7, 45, 91, 139],
                                   [73, 27, 64, 39, 45, 36], [133, 27, 91, 77, 73, 51],
                                   [1, 91, 152, 39, 121, 159], [27, 91, 133, 104, 14, 52],
                                   [138, 103, 48, 119, 2, 89], [119, 25, 103, 155, 48, 2],
                                   [48, 71, 119, 15, 95, 10], [71, 119, 74, 15, 2, 154],
                                   [74, 155, 31, 71, 4, 110], [74, 119, 110, 155, 94, 73],
                                   [110, 94, 2, 155, 32, 124], [119, 125, 155, 15, 74, 154],
                                   [142, 32, 110, 73, 103, 94], [94, 74, 119, 21, 103, 82],
                                   [94, 32, 38, 74, 76, 31], [142, 103, 94, 110, 31, 82],
                                   [94, 21, 31, 2, 155, 32], [94, 125, 31, 110, 142, 73],
                                   [32, 110, 142, 155, 94, 106], [94, 110, 124, 71, 31, 137],
                                   [38, 71, 110, 31, 4, 5], [155, 73, 71, 146, 31, 83],
                                   [154, 63, 31, 103, 110, 73], [110, 94, 119, 20, 147, 76],
                                   [110, 142, 147, 125, 31, 74], [94, 73, 71, 2, 154, 155],
                                   [94, 31, 44, 19, 157, 106], [110, 94, 38, 63, 31, 33],
                                   [103, 71, 106, 142, 63, 20], [94, 15, 154, 5, 32, 74],
                                   [110, 50, 44, 106, 71, 94], [71, 81, 142, 73, 19, 48],
                                   [142, 94, 103, 20, 46, 44], [94, 63, 155, 119, 106, 149],
                                   [94, 110, 142, 8, 73, 83], [94, 32, 110, 47, 27, 119],
                                   [110, 94, 106, 2, 119, 152], [71, 106, 110, 32, 87, 155],
                                   [137, 142, 110, 71, 106, 19], [94, 8, 71, 82, 113, 32],
                                   [110, 119, 63, 38, 31, 137], [54, 154, 106, 79, 110, 103],
                                   [155, 94, 141, 125, 142, 106], [94, 156, 106, 29, 38, 137],
                                   [73, 20, 106, 142, 155, 62], [119, 54, 149, 110, 94, 113],
                                   [94, 103, 38, 5, 119, 46], [38, 155, 5, 94, 110, 63],
                                   [94, 33, 85, 110, 106, 40], [62, 125, 38, 149, 142, 110],
                                   [94, 110, 40, 142, 38, 91], [8, 155, 106, 110, 94, 88],
                                   [119, 94, 149, 71, 55, 110], [73, 142, 110, 119, 94, 5],
                                   [94, 71, 149, 119, 142, 73], [71, 113, 110, 32, 94, 40],
                                   [71, 94, 81, 110, 40, 73], [110, 155, 112, 124, 46, 119],
                                   [106, 110, 6, 125, 142, 38], [73, 110, 79, 109, 6, 159],
                                   [71, 142, 38, 113, 110, 156], [119, 94, 113, 2, 61, 142],
                                   [159, 149, 73, 94, 71, 82], [119, 38, 110, 137, 142, 55],
                                   [90, 119, 155, 105, 113, 94], [71, 113, 106, 40, 109, 44],
                                   [137, 142, 53, 71, 149, 73], [94, 73, 40, 149, 120, 8]],
                         'sel_k': [0.0267296, 0.0309432, 0.0361319, 0.0259752, 0.0269285, 0.0327512,
                                   0.0321715, 0.0348023, 0.0318118, 0.0345693, 0.0297321, 0.0391971,
                                   0.0298698, 0.0316615, 0.0280714, 0.0264353, 0.0248791, 0.032375,
                                   0.0248116, 0.0230674, 0.0278991, 0.0284709, 0.0263445, 0.0310245,
                                   0.0298029, 0.0288965, 0.021548, 0.0218924, 0.0357576, 0.028386,
                                   0.0292367, 0.0301164, 0.0294829, 0.0332935, 0.0399462, 0.0334483,
                                   0.0306582, 0.0328542, 0.0287931, 0.0298851, 0.0344952, 0.0272592,
                                   0.0285299, 0.0229273, 0.0321452, 0.0336661, 0.0336144, 0.0421149,
                                   0.0284798, 0.0239696, 0.0191131, 0.044064, 0.0325628, 0.0274184,
                                   0.0287681, 0.0302496, 0.0235339, 0.0317245, 0.02932, 0.0402,
                                   0.0282328, 0.0384974, 0.0259519, 0.0310276, 0.0239364, 0.026411,
                                   0.0296214, 0.0327234, 0.0369519, 0.0342201, 0.0293891, 0.038369,
                                   0.0379361, 0.0269924, 0.0253266, 0.0396096, 0.0353267, 0.0249022,
                                   0.0437726, 0.0181041, 0.0405028, 0.0195911, 0.0303168, 0.0279472,
                                   0.0322816, 0.0288579, 0.0370517, 0.0188735, 0.0381647, 0.0284261,
                                   0.0136493, 0.0325636, 0.0253655, 0.0253857, 0.0215777, 0.0266756,
                                   0.0247382, 0.0242346, 0.0427974, 0.026691, 0.0296337, 0.0315739,
                                   0.028924, 0.0252897, 0.0231128, 0.0241054, 0.0305778, 0.035623,
                                   0.0293885, 0.0361354, 0.0372122, 0.028125, 0.0365, 0.0247268,
                                   0.0333237, 0.0269397, 0.0347405, 0.0265736, 0.0273941, 0.0351616,
                                   0.0264089, 0.0297452, 0.0390756, 0.0266435, 0.0396156, 0.0296616,
                                   0.0275672, 0.0321219],
                         'slope': [0.0260152, 0.0299858, 0.0348264, 0.0253005, 0.0262034, 0.0316786,
                                   0.0311365, 0.0335911, 0.0307998, 0.0333742, 0.0288481, 0.0376607,
                                   0.0289776, 0.0306591, 0.0272834, 0.0257365, 0.0242601, 0.0313269,
                                   0.024196, 0.0225353, 0.0271208, 0.0276603, 0.0256505, 0.0300619,
                                   0.0289147, 0.0280615, 0.0210837, 0.0214131, 0.034479, 0.0275802,
                                   0.0283819, 0.0292094, 0.0286136, 0.0321851, 0.0383505, 0.0323295,
                                   0.0297183, 0.0317748, 0.0279641, 0.028992, 0.0333053, 0.0265161,
                                   0.0277159, 0.0224017, 0.0311118, 0.0325327, 0.0324845, 0.0403413,
                                   0.0276687, 0.023395, 0.0187478, 0.0421223, 0.0315024, 0.0266666,
                                   0.0279405, 0.0293346, 0.02298, 0.0307181, 0.0284603, 0.038584,
                                   0.0274357, 0.0370153, 0.0252784, 0.0300649, 0.0233635, 0.0257135,
                                   0.028744, 0.0316526, 0.0355865, 0.0330491, 0.0285254, 0.0368968,
                                   0.036497, 0.0262638, 0.0246852, 0.0380407, 0.0340787, 0.024282,
                                   0.0418566, 0.0177764, 0.0388623, 0.0192073, 0.0293977, 0.0271661,
                                   0.0312395, 0.0280251, 0.0356789, 0.0185173, 0.0367081, 0.027618,
                                   0.013463, 0.0315032, 0.0247221, 0.0247413, 0.0211121, 0.0259641,
                                   0.0241262, 0.0236473, 0.0409658, 0.0259786, 0.0287555, 0.030577,
                                   0.0280874, 0.0246502, 0.0225786, 0.0235243, 0.0296428, 0.034354,
                                   0.0285249, 0.0348296, 0.0358274, 0.027334, 0.0351677, 0.0241154,
                                   0.0322133, 0.0262139, 0.0335336, 0.0258675, 0.0266436, 0.0339252,
                                   0.0257114, 0.0288605, 0.0375487, 0.0259337, 0.0380462, 0.0287818,
                                   0.0268073, 0.0310901]}},
 'rows': [{'argmax': 61080,
           'at_ids': [-1.0234375, -1.4921875, 0.609375, 0.62890625, -0.1513671875, 0.06884765625,
                      -0.228515625],
           'lse': 11.99868339345508,
           'margin': 0.484375,
           'max': 4.21875},
          {'argmax': 69319,
           'at_ids': [-1.2578125, -1.109375, 1.046875, 0.92578125, 0.8046875, 0.0179443359375,
                      0.33203125],
           'lse': 12.000453996364213,
           'margin': 0.203125,
           'max': 4.03125},
          {'argmax': 2753,
           'at_ids': [-2.671875, -1.5703125, 1.2421875, -0.08251953125, -0.2080078125, 0.20703125,
                      0.0286865234375],
           'lse': 11.99818941002643,
           'margin': 0.28125,
           'max': 4.40625},
          {'argmax': 68291,
           'at_ids': [-0.1494140625, 0.57421875, -1.21875, 0.91796875, 1.140625, -1.265625,
                      0.8203125],
           'lse': 11.992502936848737,
           'margin': 0.28125,
           'max': 4.625},
          {'argmax': 38633,
           'at_ids': [-0.439453125, -0.3828125, 2.265625, -0.67578125, 0.4609375, 0.1845703125,
                      -0.92578125],
           'lse': 11.99613136168189,
           'margin': 0.03125,
           'max': 4.03125}],
 'steps': [[{'argmax': 2753,
             'at_fed': 4.40625,
             'at_ids': [-2.65625, -1.5703125, 1.234375, -0.09033203125, -0.2060546875, 0.22265625,
                        0.0296630859375],
             'lse': 11.998315451179838,
             'margin': 0.28125,
             'max': 4.40625},
            {'argmax': 53311,
             'at_fed': 4.09375,
             'at_ids': [0.006927490234375, -0.0031890869140625, 0.0830078125, -0.62109375, 1.109375,
                        1.6875, -0.470703125],
             'lse': 11.99852770279005,
             'margin': 0.25,
             'max': 4.09375},
            {'argmax': 82307,
             'at_fed': 4.21875,
             'at_ids': [-0.94140625, 0.000942230224609375, 0.2734375, -0.94140625, -1.2109375,
                        1.6171875, -0.054443359375],
             'lse': 11.99893936983181,
             'margin': 0.0625,
             'max': 4.21875},
            {'argmax': 38511,
             'at_fed': 3.78125,
             'at_ids': [-0.447265625, -0.1455078125, 0.396484375, -0.53125, 0.546875, 0.107421875,
                        -0.8203125],
             'lse': 11.999061238209242,
             'margin': 0.0,
             'max': 3.78125},
            {'argmax': 18958,
             'at_fed': 5.0,
             'at_ids': [-1.0859375, 0.0673828125, 2.875, -0.83203125, 0.2265625, 1.15625,
                        -0.462890625],
             'lse': 12.000327226006448,
             'margin': 0.65625,
             'max': 5.0},
            {'argmax': 26294,
             'at_fed': 4.0,
             'at_ids': [0.71875, -1.203125, -0.2236328125, -1.953125, 0.18359375, 0.8984375,
                        -1.4765625],
             'lse': 11.99937415059021,
             'margin': 0.09375,
             'max': 4.0},
            {'argmax': 30541,
             'at_fed': 4.15625,
             'at_ids': [-0.47265625, -1.921875, 0.73046875, 0.1357421875, 1.3359375, 0.8359375,
                        0.60546875],
             'lse': 11.998443442831265,
             'margin': 0.1875,
             'max': 4.15625},
            {'argmax': 99865,
             'at_fed': 3.796875,
             'at_ids': [1.234375, -0.328125, 1.40625, 1.3359375, 0.404296875, -0.6953125,
                        -0.35546875],
             'lse': 11.997846420704866,
             'margin': 0.125,
             'max': 3.796875}],
           [{'argmax': 2580,
             'at_fed': 4.0,
             'at_ids': [-0.451171875, -0.380859375, 2.28125, -0.671875, 0.455078125, 0.19140625,
                        -0.9296875],
             'lse': 11.996102457828934,
             'margin': 0.0,
             'max': 4.0},
            {'argmax': 70098,
             'at_fed': 4.1875,
             'at_ids': [-0.4765625, 0.41015625, 1.03125, -1.2421875, 0.546875, 0.447265625,
                        0.0269775390625],
             'lse': 11.997997280175113,
             'margin': 0.375,
             'max': 4.1875},
            {'argmax': 47278,
             'at_fed': 4.46875,
             'at_ids': [-0.6015625, 0.419921875, -0.64453125, -1.109375, 0.470703125, 0.64453125,
                        -0.29296875],
             'lse': 11.997491696182934,
             'margin': 0.34375,
             'max': 4.46875},
            {'argmax': 86881,
             'at_fed': 4.375,
             'at_ids': [-0.453125, 0.134765625, 0.734375, -1.53125, 0.54296875, -0.400390625,
                        0.4296875],
             'lse': 11.993701561089674,
             'margin': 0.40625,
             'max': 4.375},
            {'argmax': 21826,
             'at_fed': 4.0,
             'at_ids': [-1.984375, -0.57421875, 0.283203125, -1.3359375, 0.7109375, -0.734375,
                        0.271484375],
             'lse': 11.99200129646623,
             'margin': 0.125,
             'max': 4.0},
            {'argmax': 63098,
             'at_fed': 4.5625,
             'at_ids': [-0.205078125, 0.34765625, 0.59375, 0.25, 1.6796875, -0.59375, -0.255859375],
             'lse': 11.994224905325606,
             'margin': 0.59375,
             'max': 4.5625},
            {'argmax': 32920,
             'at_fed': 5.09375,
             'at_ids': [-0.05517578125, -1.265625, -0.91015625, -0.953125, -0.4453125, 0.162109375,
                        -0.0810546875],
             'lse': 11.9918256278996,
             'margin': 1.34375,
             'max': 5.09375},
            {'argmax': 40698,
             'at_fed': 4.28125,
             'at_ids': [-1.859375, 1.4765625, -0.020751953125, -1.0234375, 0.9609375, -0.37109375,
                        0.482421875],
             'lse': 11.998319617873918,
             'margin': 0.5,
             'max': 4.28125}]],
 'tokens': [[2753, 53311, 82307, 38511, 18958, 26294, 30541, 99865],
            [2580, 70098, 47278, 86881, 21826, 63098, 32920, 40698]]}

# Tolerances of the moe comparisons and their reasons.  Every logit
# comparison runs both sides on the same routing: the port is made to pick
# the experts the other run picked (``routed_as``; its gates still come from
# its own scores), so a rounding difference cannot move a token to another
# expert and every logit is compared.  The routing itself is compared
# apart, run against run (``compare_routing``):
# * ROUTE_TIE_LOGIT: a token whose k-th and (k+1)-th selection scores lie
#   within this margin (in router-logit units: the score gap over the k-th
#   score's slope s (1 - s), on either side of a comparison) may pick
#   another expert when its MoE input differs by rounding.  The JAX
#   package's bf16 attention rounds its logits and probabilities to bf16
#   where the flash kernel keeps float32, and the plain versions on the
#   card do the same, so the MoE input differs by more than an ulp: on an
#   H100 the k-th score moved by up to ~0.05 in these units (deepseek-v2
#   against JAX and kernels against plain), and a gap moves by at most
#   twice what one score does; 0.2 is twice that.  Such a token is exempt
#   from the pick comparison and counted; a pick that differs past the
#   margin fails.  A changed pick moves the slots of later pairs of its
#   group at the two experts involved, so a later token whose kept choices
#   differ only at such experts is exempt too (counted as a cascade).  The
#   free-running greedy tokens may part at an exempt token's step.
# * MOE_LOGIT_TOL / MOE_MARGIN_TOL: the card against JAX_MOE_SERVE on JAX's
#   routing, as SERVE_LOGIT_TOL / JAX_MARGIN_TOL for llama (bf16 rounding
#   points on both sides, two layers);
# * MOE_PREFILL_TOL: every logit of the 4 x 512 prefill, of v3's
#   ``mtp_logits`` and of the generation's decode loop with the kernels
#   against the same step on the plain versions on the kernel run's
#   routing: the flash kernel keeps the attention's probabilities in
#   float32 where the plain version rounds them to bf16, as
#   SERVE_PREFILL_TOL.
ROUTE_TIE_LOGIT = 0.2
MOE_LOGIT_TOL = 0.0625
MOE_MARGIN_TOL = 2 * MOE_LOGIT_TOL
MOE_PREFILL_TOL = 0.125


def moe_config(spec: dict):
    """The full-width config of ``spec`` (MOE_V2 or MOE_V3) cut to its
    ``n_layers``."""
    import dataclasses

    from repro_torch.configs import full_config

    return dataclasses.replace(full_config(spec["arch"]), n_layers=spec["n_layers"])


def routing_record(idx, select, scores) -> dict:
    """One MoE call's routing from either package (numpy): the experts each
    of its ``N`` tokens picked, ``idx (N, k)`` in selection order; from the
    selection scores ``select (N, E)`` (softmax scores, or sigmoid scores
    plus the bias) the k-th score ``sel_k``; the slope ``s (1 - s)`` of the
    k-th expert's raw score ``s`` (``scores (N, E)``) by its logit; and the
    margin ``(sel_k - sel_(k+1)) / slope`` to the first expert left out, in
    router-logit units to first order (for softmax the log of the two
    scores' ratio)."""
    import numpy as np

    idx = np.asarray(idx)
    k = idx.shape[1]
    top = -np.sort(-np.asarray(select, np.float64), axis=-1)[:, :k + 1]
    s = np.take_along_axis(np.asarray(scores, np.float64), idx[:, k - 1:k], -1)[:, 0]
    slope = s * (1.0 - s)
    short = lambda a: [float(f"{x:.6g}") for x in a]  # 6 digits: a margin, not a bit pattern
    return {"picks": idx.tolist(), "sel_k": short(top[:, k - 1]), "slope": short(slope),
            "margin": short((top[:, k - 1] - top[:, k]) / slope)}


def keep_flags(picks, n_experts: int, capacity_factor: float, group_size: int = 256):
    """``models.moe.slots``' kept flags ``(N, k)`` for the picks ``(N, k)``
    (numpy): groups of ``group_size`` rows, zero-padded rows choosing expert
    0, a pair kept while fewer than the capacity earlier pairs of its group
    went to its expert."""
    import numpy as np

    p = np.asarray(picks)
    n, k = p.shape
    s = min(group_size, n)
    pad = -n % s
    cap = max(int(capacity_factor * s * k / n_experts), k)
    flat = np.concatenate([p, np.zeros((pad, k), p.dtype)]).reshape(-1, s * k)
    keep = np.zeros(flat.shape, bool)
    for g, row in enumerate(flat):
        count = np.zeros(n_experts, np.int64)
        for j, e in enumerate(row):
            keep[g, j] = count[e] < cap
            count[e] += 1
    return keep.reshape(-1, k)[:n]


def compare_routing(got: list, want: list, cfg, tie: float = ROUTE_TIE_LOGIT,
                    group_size: int = 256) -> dict:
    """Hold the routing records of two runs of the same calls (each a list of
    ``routing_record``s, call by call) against each other.  A token whose
    picks differ as a set is exempt where either side's margin is within
    ``tie`` (a flip), else a failure; a token with the same picks whose kept
    flags differ is exempt where they differ only at experts that an
    earlier flip of its group moved (a cascade), else a failure.  Returns
    ``bad``, the counts of tokens within the margin (``ties``), of flips and
    of cascades, per call the exempt tokens (``affected``), the experts the
    flips moved (``touched``) and the pairs they moved, the largest
    difference of the k-th selection score over the tokens whose picks
    agree, in logit units (``max_dlogit``: over ``want``'s slope), and the
    largest margin at which a token flipped (``max_flip_margin``)."""
    import numpy as np

    mo = cfg.moe
    out = {"bad": [], "ties": 0, "flipped": 0, "cascaded": 0, "affected": [], "touched": [],
           "moved_pairs": [], "max_dlogit": 0.0, "max_flip_margin": 0.0}
    for c, (g, w) in enumerate(zip(got, want)):
        gp, wp = np.asarray(g["picks"]), np.asarray(w["picks"])
        aff, touched, moved = set(), set(), 0
        out["affected"].append(aff)
        out["touched"].append(touched)
        if gp.shape != wp.shape:
            out["bad"].append(f"call {c}: picks {gp.shape} vs {wp.shape}")
            out["moved_pairs"].append(0)
            continue
        n = gp.shape[0]
        s = min(group_size, n)
        gk = keep_flags(gp, mo.n_experts, mo.capacity_factor, group_size)
        wk = keep_flags(wp, mo.n_experts, mo.capacity_factor, group_size)
        moved_at: dict = {}  # group -> experts whose pair counts an earlier flip changed
        for i in range(n):
            near = min(g["margin"][i], w["margin"][i]) <= tie
            out["ties"] += int(near)
            gs, ws = set(gp[i].tolist()), set(wp[i].tolist())
            if gs != ws:
                if not near:
                    out["bad"].append(f"call {c} token {i}: experts {sorted(gs)} vs {sorted(ws)} "
                                      f"(margins {g['margin'][i]:.3e}, {w['margin'][i]:.3e})")
                    continue
                out["flipped"] += 1
                out["max_flip_margin"] = max(out["max_flip_margin"],
                                             min(g["margin"][i], w["margin"][i]))
                moved += len(gs - ws)
                moved_at.setdefault(i // s, set()).update(gs ^ ws)
                touched.update(gs ^ ws)
                aff.add(i)
                continue
            out["max_dlogit"] = max(out["max_dlogit"],
                                    abs(g["sel_k"][i] - w["sel_k"][i]) / w["slope"][i])
            kg, kw = dict(zip(gp[i].tolist(), gk[i])), dict(zip(wp[i].tolist(), wk[i]))
            diff = {e for e in gs if kg[e] != kw[e]}
            if not diff:
                continue
            if diff <= moved_at.get(i // s, set()):
                out["cascaded"] += 1
                aff.add(i)
            else:
                out["bad"].append(f"call {c} token {i}: kept flags differ at experts {sorted(diff)} "
                                  f"that no earlier flip of its group moved")
        out["moved_pairs"].append(moved)
    return out


def compare_moe_aux(got: dict, want: dict, n_pairs: int, touched: set, moved: int) -> list[str]:
    """``forward``'s expert counts and dropped fraction (``{"expert_counts",
    "dropped_fraction"}``) against another run's: the counts equal at every
    expert no routing flip moved (``touched``), the dropped fraction equal
    when no pair moved and otherwise within ``moved`` of ``n_pairs`` pairs
    (each moved pair changes the kept count by at most one)."""
    bad = [f"expert {e}: {a} vs {b} tokens" for e, (a, b) in
           enumerate(zip(got["expert_counts"], want["expert_counts"])) if a != b and e not in touched]
    d = abs(got["dropped_fraction"] - want["dropped_fraction"])
    if (moved == 0 and d != 0.0) or d > moved / n_pairs + 1e-7:
        bad.append(f"dropped_fraction {got['dropped_fraction']!r} vs {want['dropped_fraction']!r} "
                   f"({moved} moved pairs of {n_pairs})")
    return bad


def moe_aux_summary(aux: dict, n_tokens: int) -> dict:
    """``forward``'s ``expert_load`` (assignments per token, exactly count x
    float32(1 / N)) as integer counts, and its ``dropped_fraction``."""
    import numpy as np

    load = np.asarray(aux["expert_load"].cpu() if hasattr(aux["expert_load"], "cpu")
                      else aux["expert_load"], np.float64)
    return {"expert_counts": np.rint(load * n_tokens).astype(int).tolist(),
            "dropped_fraction": float(aux["dropped_fraction"])}


@contextlib.contextmanager
def capture_routing(model):
    """Record the routing of every call of the model's MoE layers while the
    block runs: yields a list of lists, one per MoE layer, of
    ``routing_record``s, computed by a forward pre-hook on each MoE FFN
    from its input (``moe.route`` as it is where the block starts, which the
    layer then repeats: a ``routed_as`` entered inside the block does not
    change what is recorded).  The recompute of a checkpointed block (in
    the backward pass, ``transformer.recomputing()``) is not a call of its
    own and is not recorded."""
    import torch

    from repro_torch.models import moe as MOE, transformer as T

    calls = [[] for _ in model.moe_blocks]
    route = MOE.route

    def hook_for(i):
        def hook(mod, args):
            if T.recomputing():
                return
            x = args[0]
            with torch.no_grad():
                _, idx, scores, _ = route(mod, mod.cfg, x.reshape(-1, x.shape[-1]))
                calls[i].append(routing_record(
                    idx.cpu().numpy(), MOE.select_scores(mod, mod.cfg, scores).cpu().numpy(),
                    scores.cpu().numpy()))
        return hook

    hooks = [blk.moe.register_forward_pre_hook(hook_for(i))
             for i, blk in enumerate(model.moe_blocks)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def routed_as(calls: list, model=None):
    """Inside the block, the i-th call of ``moe.route`` picks the experts of
    ``calls[i]["picks"]`` (another run's ``routing_record``s, in call
    order), its gates computed from its own scores as ``route`` computes
    them; its scores and logits are its own.  With ``model``, ``calls``
    holds one list per MoE layer of ``model`` (as ``capture_routing``
    yields them), keyed by (layer, forward pass): a layer's forward calls
    take its records in order, and the recompute of a checkpointed block
    (in the backward pass, on autograd's thread on the card:
    ``transformer.recomputing()``) replays the record its forward took, so
    the recompute dispatches the same pairs.  Raises if the calls run out
    or are not all used."""
    import torch

    from repro_torch.models import moe as MOE, transformer as T

    orig = MOE.route
    if model is None:
        layer_of, lists = None, [calls]
    else:
        layer_of = {id(blk.moe): i for i, blk in enumerate(model.moe_blocks)}
        lists = calls
        _check(len(lists) == len(layer_of), f"routed_as: {len(lists)} layers of records for "
                                             f"{len(layer_of)} MoE layers")
    its = [iter(c) for c in lists]
    last = [None] * len(lists)
    used = [0] * len(lists)

    def route(p, cfg, x_flat):
        _, _, scores, logits = orig(p, cfg, x_flat)
        i = 0 if layer_of is None else layer_of[id(p)]
        if layer_of is None or not T.recomputing():
            last[i] = next(its[i], None)
            _check(last[i] is not None, f"routed_as: layer {i} ran out of records")
            used[i] += 1
        else:
            _check(last[i] is not None, f"routed_as: a recompute of layer {i} before its forward")
        idx = torch.as_tensor(last[i]["picks"], device=x_flat.device)
        _check(tuple(idx.shape) == (x_flat.shape[0], cfg.moe.experts_per_token),
               f"routed_as: layer {i} call {used[i] - 1} has {tuple(idx.shape)} picks for "
               f"{x_flat.shape[0]} tokens")
        w = torch.gather(scores, -1, idx)
        return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9), idx, scores, logits

    MOE.route = route
    try:
        yield
    finally:
        MOE.route = orig
    _check(used == [len(c) for c in lists],
           f"routed_as: {used} of {[len(c) for c in lists]} calls used")


def moe_walk_exempt(routing: dict, ref: dict) -> set:
    """The ``(request, step)`` pairs of ``ref``'s teacher-forced decode loop
    whose token ``compare_routing`` exempted: step 0 from the prompt call
    (token ``r * T0 + T0 - 1``), step p from call p (token r)."""
    t0, dec = ref["prompt_len"], routing["affected"]
    return {(r, p) for r in range(ref["requests"]) for p in range(ref["gen_tokens"])
            if (r * t0 + t0 - 1 if p == 0 else r) in dec[p]}


def port_moe_serve_reference(model, cfg, dev, want: dict, ref: dict = MOE_SERVE_REF) -> dict:
    """``ref`` through the port on ``dev`` (a model with one MoE layer),
    against ``want`` (JAX_MOE_SERVE: its tokens are fed back, its routing
    imposed): the prefill step's rows and the teacher-forced decode loop's
    steps on ``want``'s routing (``routed_as``), the free-running greedy
    tokens, and on the port's own routing the MoE layer's records of the
    prefill step, the decode loop and ``forward`` on the prompts
    (``capture_routing``) with ``forward``'s expert counts and dropped
    fraction (``moe_aux_summary``)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, build_prefill_step

    _check(len(model.moe_blocks) == 1, "the moe serve reference runs one MoE layer")
    t0, n = ref["prompt_len"], ref["gen_tokens"]
    prompts = torch.as_tensor(
        serve_prompts(cfg.vocab_size, ref["requests"], t0, ref["prompt_seed"]), device=dev)
    fed = torch.as_tensor(want["tokens"], device=dev)
    prefill = build_prefill_step(cfg)
    with capture_routing(model) as pre:
        prefill(model, prompts, t0 + n)
    with routed_as([want["routing"]["prefill"]]):
        logits, _ = prefill(model, prompts, t0 + n)
    out = ServeEngine(cfg, model, max_len=t0 + n, device=dev).generate(prompts, n)
    with capture_routing(model) as dec:
        decode_logits(model, cfg, prompts, fed, t0 + n)
    with routed_as(want["routing"]["decode"]):
        steps = decode_logits(model, cfg, prompts, fed, t0 + n)
    with capture_routing(model) as fwd, torch.inference_mode():
        aux = T.forward(model, prompts).aux_losses
    host = lambda t: t.cpu().numpy()
    summary = serve_summary(host(logits), host(out), host(steps), want["tokens"], ref)
    summary["routing"] = {"prefill": pre[0][0], "decode": dec[0], "forward": fwd[0][0]}
    summary["aux"] = moe_aux_summary(aux, prompts.numel())
    return summary


def compare_moe_serve(got: dict, want: dict, cfg, ref: dict = MOE_SERVE_REF,
                      tol: float = MOE_LOGIT_TOL, margin_tol: float = MOE_MARGIN_TOL):
    """``got`` (``port_moe_serve_reference``) against ``want`` (the JAX
    package's, ``JAX_MOE_SERVE``): the routing of the prefill step, of every
    decode call and of ``forward`` (``compare_routing``), ``forward``'s
    expert counts and dropped fraction (``compare_moe_aux``), and
    ``compare_serve`` (every row and step, on JAX's routing; the greedy
    tokens may part at a routing-exempt step).  Returns the failures and a
    dict of what was exempted and measured."""
    routing = {k: compare_routing([got["routing"][k]], [want["routing"][k]], cfg)
               for k in ("prefill", "forward")}
    routing["decode"] = compare_routing(got["routing"]["decode"], want["routing"]["decode"], cfg)
    walk = moe_walk_exempt(routing["decode"], ref)
    fr = routing["forward"]
    bad = [b for r in routing.values() for b in r["bad"]]
    n_pairs = ref["requests"] * ref["prompt_len"] * cfg.moe.experts_per_token
    bad += compare_moe_aux(got["aux"], want["aux"], n_pairs, fr["touched"][0],
                           fr["moved_pairs"][0])
    sbad, skipped = compare_serve(got, want, tol, margin_tol, walk)
    info = {"skipped": skipped, "walk_exempt": len(walk),
            **{f"{c}_{k}": r[c] for k, r in routing.items()
               for c in ("ties", "flipped", "cascaded", "max_dlogit", "max_flip_margin")}}
    return bad + sbad, info


def _mla_flash_bytes_ops(q, k, v, causal) -> tuple[int, int, int]:
    """Bytes the flash forward must move at a value head dim other than the
    query's (q, k, v in, o of v's width and the float32 lse out, once each),
    the model's product operations on the visible pairs (2 Dqk for q k^T and
    2 Dv for p v each), and those the kernel does with v zero-padded to
    Dqk (2 Dqk for each product)."""
    b, h, tq, dqk = q.shape
    dv = v.shape[-1]
    pairs = b * h * _visible_pairs(q, k, causal)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + b * h * tq * dv) \
        + 4 * b * h * tq
    return nbytes, (2 * dqk + 2 * dv) * pairs, 4 * dqk * pairs


def phase_moe_kernels(dev) -> dict:
    """17a: the kernels of the moe path at its shapes.  Flash at deepseek's
    MLA prefill (q and k (4, 128, 512, 192), v (4, 128, 512, 128), bf16,
    causal: v zero-padded to 192 in the wrapper) and at a ragged T = 300,
    each against its plain version as phase 5 holds it, timed beside its
    plain version and the library call; rmsnorm at ``q_a_norm``'s 1536 and
    ``kv_a_norm``'s 512 and at the block norms' 5120 (v2) and 7168 (v3)
    over the prefill's 2048 rows, held at the model's eps as phase 5 holds
    it (``_rmsnorm_case``, untimed: phase 5 times these shapes)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    cfg = moe_config(MOE_V2)
    m = cfg.mla
    gen = torch.Generator(device=dev).manual_seed(17)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf16 = torch.bfloat16
    bsz, tl = MOE_V2["prefill"]
    dqk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    scale = dqk ** -0.5
    out = {"err": 0.0}
    for name, t in (("mla", tl), ("mla ragged", 300)):
        q, k = (randn(bsz, cfg.n_heads, t, dqk).to(bf16) for _ in range(2))
        v = randn(bsz, cfg.n_heads, t, dv).to(bf16)
        o, lse = _fa_kernel(q, k, v, True)  # its default scale is 1/sqrt(192)
        o_p, lse_p = ref.attention(q, k, v, causal=True, scale=scale, with_lse=True)
        o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=True, scale=scale,
                                   with_lse=True)
        torch.cuda.synchronize()
        err_o, err_l = _max_err(o, o_p), _max_err(lse, lse_p)
        dev_o = (o.double() - o_w.double()).abs()
        # Held as phase 5 holds head dims above 256: to the float32 plain
        # version on the same inputs, within one bf16 ulp of each element of
        # o (the kernel's only rounding is its output's) and 1e-5 on lse.
        # The bf16 plain version rounds the logits and the probabilities to
        # bf16 where the kernel keeps them in float32, so against it the two
        # roundings may land an ulp apart where |o| >= 2 (an H100 read
        # 2.344e-2 at T = 300, the kernel within 7.8e-3 of float32): its
        # difference is printed, not held to phase 5's 2e-2.
        ok = (tuple(o.shape) == (bsz, cfg.n_heads, t, dv)
              and bool((dev_o <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
              and _max_err(lse, lse_w) <= 1e-5)
        print(f"flash fwd   {name:11s} q, k {tuple(q.shape)} v {tuple(v.shape)} bf16: "
              f"max|kernel - plain| o {err_o:.3e} lse {err_l:.3e}; vs float32 plain o "
              f"{float(dev_o.max()):.3e} lse {_max_err(lse, lse_w):.3e}")
        _check(ok, f"flash forward {name} vs plain")
        out["err"] = max(out["err"], err_o, err_l)
        if name == "mla":
            ms = _median_ms(lambda: _fa_kernel(q, k, v, True))
            plain = _median_ms(lambda: ref.attention(q, k, v, causal=True, scale=scale,
                                                     with_lse=True))
            # The library's causal mask is aligned to the top left: Tq == Tk here.
            lib = _median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))
            nbytes, nops, nops_pad = _mla_flash_bytes_ops(q, k, v, True)
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_FLOP_PER_S * 1e3
            out.update(mla_shape=[list(q.shape), list(v.shape)], mla_ms=ms, mla_plain_ms=plain,
                       mla_library_ms=lib, mla_bound_ms=max(t_b, t_o),
                       mla_bound_by="bytes" if t_b >= t_o else "operations",
                       mla_bound_padded_ms=max(t_b, nops_pad / BF16_FLOP_PER_S * 1e3))
            print(f"flash fwd   mla bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"F.scaled_dot_product_attention {lib:.4f} ms; bound {out['mla_bound_ms']:.4f} "
                  f"ms ({out['mla_bound_by']}: {nops / 1e9:.2f} GFLOP of the model's), "
                  f"{out['mla_bound_padded_ms']:.4f} ms for the padded value work "
                  f"({nops_pad / 1e9:.2f} GFLOP)")
    rows = bsz * tl
    out["rmsnorm_widths"] = {
        d: _rmsnorm_case(randn(rows, d).to(bf16), (1.0 + 0.1 * randn(d)).to(bf16), cfg.norm_eps)
        for d in (m.q_lora_rank, m.kv_lora_rank, cfg.d_model, moe_config(MOE_V3).d_model)}
    return out


def _routing_line(what: str, r: dict) -> str:
    return (f"{what}: {r['ties']} tokens within the tie margin ({ROUTE_TIE_LOGIT:g} in logit "
            f"units), {r['flipped']} picked other experts there (at margins up to "
            f"{r['max_flip_margin']:.3e}), {r['cascaded']} kept other pairs after them; max|k-th "
            f"selection score difference| {r['max_dlogit']:.3e} in logit units")


def _moe_model(spec: dict, dev):
    """The model of ``spec`` on the card: v2 from ``random_lm_leaves`` (one
    leaf on the host at a time), v3 drawn on the card."""
    import torch

    from repro_torch import convert
    from repro_torch.models import transformer as T

    cfg = moe_config(spec)
    t0 = time.perf_counter()
    if spec is MOE_V2:
        model = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg, spec["seed"]), cfg,
                                              device=dev)
        how = "drawn on the host leaf by leaf and moved to the card"
    else:
        model = T.init(cfg, device=dev, generator=torch.Generator(dev).manual_seed(spec["seed"]))
        how = "drawn on the card"
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    print(f"moe serve: {cfg.name} {n_params} parameters ({gib:.1f} GiB, {cfg.n_layers} layers: "
          f"{cfg.moe.first_dense_layers} dense + {cfg.n_layers - cfg.moe.first_dense_layers} MoE"
          f"{', MTP' if cfg.mtp_depth else ''}) {how} in {time.perf_counter() - t0:.1f} s")
    return cfg, model


def _kernels_vs_plain(model, cfg, run, label: str) -> tuple[object, float, dict]:
    """``run()`` (returning a logits tensor) on the kernels with its routing
    captured, on the plain versions (``ops.forced("ref")``) on its own
    routing and then on the kernel run's: returns the kernel run's logits,
    max|kernels - plain| on the same routing, and ``compare_routing`` of
    the two runs' own routings (which must pass)."""
    from repro_torch.kernels import ops

    with capture_routing(model) as rk:
        got = run()
    with capture_routing(model) as rp, ops.forced("ref"):
        run()
    with routed_as(rk[0]), ops.forced("ref"):
        want = run()
    routing = compare_routing(rk[0], rp[0], cfg)
    _check(not routing["bad"], f"{label} routing, kernels vs plain: " + "; ".join(routing["bad"][:10]))
    return got, _max_err(got, want), routing


def phase_moe_serve(dev, spec: dict, profile_dir: Path | None = None, model=None) -> dict:
    """17b / 17c: ``spec`` (MOE_V2 or MOE_V3) at full width.  (a) v2 only:
    MOE_SERVE_REF against JAX_MOE_SERVE (``compare_moe_serve``).  (b) The
    prefill step on 4 x 512 tokens: launches, wall, peak memory, and every
    logit against the same step on the plain versions on the kernel run's
    routing; the two runs' own routings under ``compare_routing``.  (c)
    Greedy generation 4 x (64 + 32): launches, tokens/s, its tokens the
    argmax of its logits, and the decode loop's logits on the kernels
    against the plain versions the same way.  (d) v3: ``forward``'s
    ``mtp_logits`` on the kernels against the plain versions the same
    way.  ``model``: the model of ``spec`` if the caller drew it (and keeps
    it), else drawn here (``_moe_model``)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, build_prefill_step

    t_phase = time.perf_counter()
    cfg, model = _moe_model(spec, dev) if model is None else (moe_config(spec), model)
    nl = cfg.n_layers
    label = "v2" if spec is MOE_V2 else "v3"
    per_call = {"rmsnorm": 4 * nl + 1, "flash_attention_fwd": nl}
    out = {}

    if spec is MOE_V2:
        got = port_moe_serve_reference(model, cfg, dev, JAX_MOE_SERVE)
        bad, info = compare_moe_serve(got, JAX_MOE_SERVE, cfg)
        print(f"moe {label} vs JAX (on JAX's routing): prefill rows and teacher-forced steps "
              f"max|diff| {serve_max_diff(got, JAX_MOE_SERVE):.4f} (tolerance {MOE_LOGIT_TOL}); "
              f"row argmax {[g['argmax'] for g in got['rows']]} vs "
              f"{[w['argmax'] for w in JAX_MOE_SERVE['rows']]}; tokens {got['tokens']} vs "
              f"{JAX_MOE_SERVE['tokens']}; {info['skipped']} tokens past a top-2 margin <= "
              f"{MOE_MARGIN_TOL} or a routing-exempt step ({info['walk_exempt']} such steps) not "
              f"compared")
        for what in ("prefill", "decode", "forward"):
            print(f"moe {label} vs JAX routing, " + _routing_line(what, {
                c: info[f"{c}_{what}"] for c in ("ties", "flipped", "cascaded", "max_dlogit",
                                                 "max_flip_margin")}))
        same = sum(a == b for a, b in zip(got["aux"]["expert_counts"],
                                          JAX_MOE_SERVE["aux"]["expert_counts"]))
        print(f"moe {label} vs JAX forward: dropped_fraction {got['aux']['dropped_fraction']!r} vs "
              f"{JAX_MOE_SERVE['aux']['dropped_fraction']!r}; expert counts equal at "
              f"{same}/{cfg.moe.n_experts} experts (the others moved by routing flips)")
        _check(not bad, f"moe {label} serving differs from the JAX package: " + "; ".join(bad[:10]))
        out["jax"] = info

    # (b) Prefill: 4 prompts x 512 tokens through the prefill step.
    b, tl = spec["prefill"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl, spec["prompt_seed"]),
                              device=dev)
    step = build_prefill_step(cfg)
    step(model, prompts, tl)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t = time.perf_counter()
    logits, state = step(model, prompts, tl)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _check(prefill_counts == per_call, f"moe {label} prefill launches {prefill_counts}")
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and state["moe"].length == tl and state["dense"].length == tl,
           f"moe {label} prefill logits/state")
    del logits, state
    logits, err, routing = _kernels_vs_plain(model, cfg, lambda: step(model, prompts, tl)[0],
                                             f"moe {label} prefill")
    print(f"moe {label} prefill {b} x {tl}: {prefill_s:.4f} s wall, {b * tl / prefill_s:.0f} "
          f"tokens/s, peak {peak:.2f} GiB allocated, launches {prefill_counts}; logits "
          f"max|kernels - plain| {err:.4f} on the kernel run's routing (max|logit| "
          f"{float(logits.abs().max()):.3f})")
    print(f"moe {label} prefill routing, kernels vs plain, " + _routing_line("prefill", routing))
    _check(err <= MOE_PREFILL_TOL, f"moe {label} prefill logits, kernels vs plain versions")
    del logits

    # (d) v3's MTP head through forward, kernels against plain versions.
    if cfg.mtp_depth:
        _reset_counts()
        with torch.inference_mode():
            fo = T.forward(model, prompts)
        fwd_counts = _counts()
        _check(fwd_counts == {"rmsnorm": per_call["rmsnorm"] + 5, "flash_attention_fwd": nl + 1},
               f"moe {label} forward launches {fwd_counts}")
        _check(bool(torch.isfinite(fo.mtp_logits).all())
               and tuple(fo.mtp_logits.shape) == (b, tl, cfg.padded_vocab), "mtp_logits")
        del fo

        def mtp():
            with torch.inference_mode():
                return T.forward(model, prompts).mtp_logits

        _, mtp_err, fr = _kernels_vs_plain(model, cfg, mtp, f"moe {label} forward")
        print(f"moe {label} forward {b} x {tl}: launches {fwd_counts}; mtp_logits max|kernels - "
              f"plain| {mtp_err:.4f} on the kernel run's routing; " + _routing_line("routing", fr))
        _check(mtp_err <= MOE_PREFILL_TOL, f"moe {label} mtp_logits, kernels vs plain versions")
    torch.cuda.empty_cache()

    # (c) Generation: 4 requests, 64-token prompts, 32 greedy tokens.
    b, t0p = spec["gen"]
    n = spec["gen_tokens"]
    gprompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t0p, spec["prompt_seed"] + 1),
                               device=dev)
    eng = ServeEngine(cfg, model, max_len=t0p + n, device=dev)
    eng.generate(gprompts, 2)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    gen = eng.generate(gprompts, n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_counts = _counts()
    fed = gen[:, t0p:]
    gl, gen_err, dr = _kernels_vs_plain(
        model, cfg, lambda: decode_logits(model, cfg, gprompts, fed, t0p + n),
        f"moe {label} generation")
    own = torch.equal(gl.argmax(-1), fed)
    print(f"moe {label} generate {b} x ({t0p} + {n}): {gen_s:.4f} s wall, {b * n / gen_s:.1f} "
          f"tokens/s, launches {gen_counts}; greedy tokens == the argmax of their logits: {own}; "
          f"logits max|kernels - plain| {gen_err:.4f} on the kernel run's routing; "
          + _routing_line("routing", dr))
    _check(gen_counts == {"rmsnorm": per_call["rmsnorm"] * n, "flash_attention_fwd": 0},
           f"moe {label} generation launches {gen_counts}")
    _check(own, f"moe {label} greedy tokens differ from their logits' argmax")
    _check(gen_err <= MOE_PREFILL_TOL, f"moe {label} generation logits, kernels vs plain")
    if profile_dir is not None:
        profile_run(f"moe_{label}_prefill", lambda: _timed(lambda: step(model, prompts, tl)),
                    profile_dir)
        profile_run(f"moe_{label}_generate", lambda: _timed(lambda: eng.generate(gprompts, n)),
                    profile_dir)
    del model, eng, gl
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"moe {label}: phase {wall:.1f} s")
    return {**out, "prefill": prefill_counts, "generate": gen_counts, "prefill_s": prefill_s,
            "prefill_tokens_per_s": b * tl / prefill_s, "generate_s": gen_s,
            "tokens_per_s": b * n / gen_s, "peak_gib": peak, "phase_s": wall,
            "routing_flips": {"prefill": routing["flipped"], "generate": dr["flipped"]}}


# The moe training slice (phase 18): deepseek-v2-236b at its published width
# cut to 2 layers (MOE_V2's model, drawn once for phases 17b and 18b: 1 dense
# + 1 MoE layer, 160 experts top-6, capacity factor 1.25; bf16,
# remat="block"), AdamW(lr=1e-3) with its default float32 moments and weight
# decay 0.1, 4 x 512 tokens of ``SyntheticLMDataset`` a step, the schedule
# warmed up in one step as TRAIN's; ``train()`` with the launcher's PowerSim
# for ``power_steps`` steps at the same width.  deepseek-v3 does not train
# at its width on one card (one MoE layer's 256 x 3 x 7168 x 2048 = 11.3 B
# routed-expert parameters, with their gradients and moments, pass 80 GB):
# its pieces (the sigmoid-bias router, the bias nudge, MTP) train at its
# smoke width in MOE_TRAIN_REF.
MOE_TRAIN = dict(seed=0, batch=4, seq_len=512, lr=1e-3, total_steps=10, warmup_steps=1, steps=3,
                 power_steps=4)
# The leaves whose first moment and updated values the checks sample, layer
# 0 of a stack: the embedding, a dense-block MLA projection, the routed
# experts' ``w_up`` cut to one expert that received tokens in the first step
# (``expert``: the largest expert_load), the router kernel and ln_f.
MOE_TRAIN_LEAVES = ("embed.embedding", "dense_blocks.attn.wq_b.kernel",
                    "moe_blocks.moe.experts.w_up", "moe_blocks.moe.router.kernel", "ln_f.scale")
MOE_EXPERT_LEAF = "moe_blocks.moe.experts.w_up"
# A step's scalars that the checks hold (those a config has: v2 has no
# mtp_loss, v3's load_balance is 0), beside expert_load.
MOE_STEP_SCALARS = ("loss", "lm_loss", "load_balance", "router_z", "mtp_loss", "grad_norm",
                    "dropped_fraction")
# What tests/test_torch_moe_train_reference.py runs through the JAX package
# on the CPU and what the card's run is held to (phase 18c): both smoke
# configs (3 layers: 1 dense + 2 MoE, so the bias nudge averages two
# layers' loads) at the published capacity factor 1.25, so pairs drop, in
# float32; 4 x 128 tokens (two routing groups of 256) a step, 2 steps from
# ``random_lm_tree(cfg, 0)``, AdamW and the schedule of MOE_TRAIN.
MOE_TRAIN_REF = dict(archs=("deepseek_v2_236b", "deepseek_v3_671b"), capacity_factor=1.25,
                     dtype="float32", seed=0, batch=4, seq_len=128, steps=2)

# Tolerances of MOE_TRAIN_REF against the JAX package, float32, on JAX's
# routing (the port's own routing is compared apart, its picks equal JAX's
# but at a near-tie: a token within MOE_REF_TIE router-logit units of its
# (k+1)-th expert, 100x the float32 noise of router logits whose inputs
# differ by ~1e-6 relative; the smallest margins of the two runs are ~5e-6
# and ~3e-5).  The two packages sum matmuls, softmax and the MoE combine
# in other orders; measured with the port on the CPU (the card's, phase
# 18c, printed beside them):
# * loss, lm_loss, mtp_loss: 2e-5 absolute (measured 9.5e-7, 1.9e-6 mtp);
# * grad_norm, load_balance, router_z: 2e-5 relative (1.3e-6, 3.3e-7);
# * m: 1e-3 of the leaf's largest sampled |m| (5.8e-5);
# * updated parameters: 4 float32 ulps plus 1e-3 lr per step where the
#   moment is clear of zero (``grad_margin``, 4x the moment tolerance, of
#   the leaf's largest), as TRAIN_TOL argues (9.7e-5); else 2 lr per step;
# * the router bias, decay plus the nudge of +-1e-3 a step: 1e-7 (0).
MOE_REF_TIE = 1e-4
MOE_REF_TOL = dict(loss=2e-5, grad_norm=2e-5, aux=2e-5, m=1e-3, grad_margin=4e-3, param_ulps=4,
                   update_frac=1e-3, ulp_bits=24, bias=1e-7)
# The JAX package's numbers for MOE_TRAIN_REF, on the CPU (jax 0.9.0), printed by
# ``python tests/test_torch_moe_train_reference.py``.
JAX_MOE_TRAIN = {'deepseek_v2_236b': {'dropped_fraction': [0.22607421875, 0.2763671875],
                      'expert': 3,
                      'expert_load': [[0.3642578125, 0.1181640625, 0.193359375, 0.513671875,
                                       0.126953125, 0.2822265625, 0.1005859375, 0.30078125],
                                      [0.1640625, 0.130859375, 0.3955078125, 0.2822265625,
                                       0.1474609375, 0.2578125, 0.4453125, 0.1767578125]],
                      'grad_norm': [14.708057403564453, 11.432653427124023],
                      'lm_loss': [6.591271877288818, 6.644425392150879],
                      'load_balance': [0.010543644428253174, 0.010390838608145714],
                      'loss': [6.605942249298096, 6.659082889556885],
                      'm': [{'dense_blocks.attn.wq_b.kernel': [9.137564484262839e-05,
                                                               5.836563286720775e-05,
                                                               2.167327875213232e-05,
                                                               -4.093208190170117e-05,
                                                               -3.032715176232159e-05,
                                                               -5.2259165386203676e-05,
                                                               1.4029799785930663e-05,
                                                               -8.269800673588179e-06,
                                                               0.00010837061563506722,
                                                               2.436445174680557e-05,
                                                               -2.0815392417716794e-05,
                                                               2.215333552157972e-05,
                                                               -4.857548901782138e-06,
                                                               -4.384874409879558e-05,
                                                               -4.2581518755469006e-06,
                                                               0.00010836950968950987],
                             'embed.embedding': [0.0002466815640218556, 2.383796345384326e-05,
                                                 0.00015710679872427136, 0.00011385860852897167,
                                                 0.0005857422365806997, 0.0, 0.0, 0.0, 0.0, 0.0,
                                                 0.0, 0.0, 0.0004843163478653878, 0.0, 0.0, 0.0],
                             'ln_f.scale': [0.00012526067439466715, 0.00019091775175184011,
                                            -2.5497176466160454e-05, 1.9521519789122976e-05,
                                            2.2245685613597743e-05, -1.954556501004845e-05,
                                            -4.12664157920517e-05, 7.99084227764979e-05,
                                            0.00014089203614275903, 1.9795137632172555e-05,
                                            7.382932381005958e-05, -3.5734516131924465e-05,
                                            0.00010822949843714014, -1.4947212548577227e-05,
                                            5.739572225138545e-05, -5.819213038193993e-05],
                             'moe_blocks.moe.experts.w_up': [-1.5821915440028533e-06,
                                                             3.425501972742495e-06,
                                                             4.99007583130151e-05,
                                                             2.142604955679417e-07,
                                                             -2.432752523873205e-07,
                                                             1.0857520464924164e-05,
                                                             1.6772077287896536e-05,
                                                             -5.766252343164524e-06,
                                                             2.447238330205437e-06,
                                                             -1.586139092069061e-06,
                                                             -3.936345365218585e-06,
                                                             5.8288419495511334e-06,
                                                             -4.399651515996084e-06,
                                                             3.5860284697264433e-06,
                                                             -7.060481493681436e-06,
                                                             1.582842628522485e-06],
                             'moe_blocks.moe.router.kernel': [-1.8249795175506733e-05,
                                                              3.8143112760735676e-05,
                                                              -1.9886845166183775e-06,
                                                              6.564554837495962e-07,
                                                              3.009586907865014e-05,
                                                              4.0164057281799614e-05,
                                                              9.815792509471066e-06,
                                                              1.843149402702693e-05,
                                                              6.137795571703464e-05,
                                                              -3.759913670364767e-05,
                                                              -1.951558624568861e-05,
                                                              -1.9014807548956014e-05,
                                                              7.255098171299323e-05,
                                                              1.1311682101222686e-05,
                                                              4.410276596900076e-05,
                                                              8.572221122449264e-05]},
                            {'dense_blocks.attn.wq_b.kernel': [0.00013400634634308517,
                                                               2.9944920242996886e-05,
                                                               0.00013506031245924532,
                                                               7.86234304541722e-05,
                                                               -2.478231181157753e-05,
                                                               -8.532538777217269e-05,
                                                               7.25277786841616e-05,
                                                               -3.925290729966946e-05,
                                                               0.00018478069978300482,
                                                               1.1216445273021236e-05,
                                                               1.708562922431156e-05,
                                                               -5.0338421715423465e-05,
                                                               5.936277375440113e-06,
                                                               -4.294657628634013e-05,
                                                               -7.569600711576641e-06,
                                                               0.0002098643162753433],
                             'embed.embedding': [0.000222013404709287, 1.5956751667545177e-05,
                                                 0.00021952293172944337, 0.00031041359761729836,
                                                 0.0005671213148161769, 0.0, -0.0008900712127797306,
                                                 -0.000621771439909935, 0.0, 0.0, 0.0, 0.0,
                                                 0.0004358846927061677, 0.0, 0.0, 0.0],
                             'ln_f.scale': [0.00021117873257026076, 0.00019421949400566518,
                                            0.00011111998901469633, 7.470035779988393e-05,
                                            2.110906279995106e-05, 4.0049148083198816e-05,
                                            -0.0001728217612253502, 0.00015317864017561078,
                                            0.00020783382933586836, 5.594841422862373e-05,
                                            0.00021948522771708667, 0.00016201514517888427,
                                            5.3980154916644096e-05, -0.00012052160309394822,
                                            0.0002116638352163136, 8.30755234346725e-05],
                             'moe_blocks.moe.experts.w_up': [1.9616605641203932e-05,
                                                             1.7335104018911807e-07,
                                                             3.157600440317765e-05,
                                                             -8.102899300865829e-06,
                                                             -2.7653925371851074e-06,
                                                             1.4833900422672741e-05,
                                                             2.2403963157557882e-05,
                                                             -7.869647561165038e-06,
                                                             9.317819831267116e-07,
                                                             1.036272351484513e-06,
                                                             -3.6361600450618425e-06,
                                                             1.25073665913078e-05,
                                                             -2.7919654144170636e-07,
                                                             -3.3164553315145895e-05,
                                                             -1.653275467106141e-05,
                                                             -1.7760223727236735e-06],
                             'moe_blocks.moe.router.kernel': [-4.3272983020870015e-05,
                                                              -7.618447853019461e-05,
                                                              9.88100582617335e-05,
                                                              -7.287977496162057e-05,
                                                              6.859594577690586e-05,
                                                              -9.026861107486184e-07,
                                                              -6.982825289014727e-05,
                                                              -3.823783845291473e-05,
                                                              3.20667058986146e-05,
                                                              -2.9674454708583653e-05,
                                                              -7.797212310833856e-05,
                                                              -2.9295320928213187e-05,
                                                              3.8918697100598365e-05,
                                                              2.6897105271928012e-05,
                                                              -3.291363827884197e-05,
                                                              5.6139273510780185e-05]}],
                      'params': {'dense_blocks.attn.wq_b.kernel': [0.11923827975988388,
                                                                   -0.052443381398916245,
                                                                   0.09855322539806366,
                                                                   -0.004757130518555641,
                                                                   0.09621170163154602,
                                                                   0.06069829687476158,
                                                                   0.09540225565433502,
                                                                   -0.2706497013568878,
                                                                   -0.09076868742704391,
                                                                   -0.02536032348871231,
                                                                   0.03664243593811989,
                                                                   -0.00964423082768917,
                                                                   -0.052147313952445984,
                                                                   0.01589319109916687,
                                                                   0.0973779559135437,
                                                                   0.1328432410955429],
                                 'embed.embedding': [-0.017833568155765533, -0.013214262202382088,
                                                     -0.003709834534674883, -0.008812393993139267,
                                                     0.013715624809265137, -0.03870707377791405,
                                                     -0.010480686090886593, -0.011172626167535782,
                                                     0.014743790961802006, 0.000651156937237829,
                                                     -0.03999199718236923, 0.0023125940933823586,
                                                     -3.92615984310396e-05, 0.02286127768456936,
                                                     -0.03999199718236923, 0.006640085484832525],
                                 'ln_f.scale': [0.9980103969573975, 0.9982384443283081,
                                                1.0004010200500488, 0.9980883598327637,
                                                0.9982854723930359, 1.000515103340149,
                                                1.0018974542617798, 0.9979998469352722,
                                                0.9980420470237732, 0.9980379343032837,
                                                0.9980461597442627, 1.0003963708877563,
                                                0.9986522197723389, 1.0018196105957031,
                                                0.9980822801589966, 1.0005841255187988],
                                 'moe_blocks.moe.experts.w_up': [0.14847666025161743,
                                                                 -0.09267956018447876,
                                                                 -0.10402040183544159,
                                                                 -0.17701907455921173,
                                                                 -0.10994929075241089,
                                                                 0.08631718903779984,
                                                                 -0.039777129888534546,
                                                                 0.08502358943223953,
                                                                 -0.04134518280625343,
                                                                 -0.05140461027622223,
                                                                 0.0030013227369636297,
                                                                 0.10723143815994263,
                                                                 0.023228663951158524,
                                                                 0.08307699114084244,
                                                                 -0.014439143240451813,
                                                                 -0.07054764777421951],
                                 'moe_blocks.moe.router.kernel': [0.022028641775250435,
                                                                  -0.008284284733235836,
                                                                  -0.00794817041605711,
                                                                  -0.015196352265775204,
                                                                  -0.03295310586690903,
                                                                  0.028591837733983994,
                                                                  0.012127058580517769,
                                                                  0.02731928415596485,
                                                                  -0.01466286275535822,
                                                                  -0.011319500394165516,
                                                                  0.03394634649157524,
                                                                  0.03247230499982834,
                                                                  -0.006623246241360903,
                                                                  0.005501185543835163,
                                                                  -0.008861604146659374,
                                                                  -0.0320131778717041]},
                      'router_z': [0.004126400221139193, 0.004266769625246525],
                      'routing': [[('0501011601101460060701146007146167071017607414606770101706741460677010170674146167701017'
                                    '6074146167701017017414616773171704741461677017170474146167701717047414616770171704741461'
                                    '6773171704741461677017170474146167737117047441616773711704744161677371170474416175354040'
                                    '3403033030200203030303370303033002020303030337033003300702030303033703300330070203030303'
                                    '3703300330070203030303370330033007020303030337033003300702030303033703300330070203030303'
                                    '3703300330070203030303370330033007020303030337033003300702033003033703306261516041065014'
                                    '0157015745171656465045436505455057055754751665455040434550455757055754171665455040435450'
                                    '4575570557541716564550404354354575750557451716504650404354354574750557451714504650404354'
                                    '5345747505575417145046574045545345747505575417145046574045545345267072747371737471714776'
                                    '7674034630344336747314477627747374373435743770372773347335733735473770377675353232377437'
                                    '5327755723375737753047355773327573756534753574625453735337353557737554573265233703650770'
                                    '35535373372135420620303212530227363553323752212537757502'),
                                   ('7173377473167153616337606136303036367536546535745374363635643663036236363565363650633662'
                                    '5365563635353553365056505005533553600345305675305065676535753554020553235353566053067550'
                                    '5063560303366506075353560636235363060230320335060660535235305235523575520305050574737373'
                                    '7372727070737637010770757307750575737073730701040773730775077573707073070407077373077270'
                                    '7575707373070407077373077270757570737307047070747307720775757073730704707074730775077575'
                                    '7073730704747074730775077575707373700474707473077507757570737370047470744747372337472736'
                                    '7213202326323237323224272627372423623132733234232726277124216231237332342327262771422162'
                                    '3123733234262762277142216231237332342627622117242162312373323426216121172421623123733234'
                                    '2621612171242162312371323426216121172421623124713234262163211624070506055604262526626262'
                                    '2762622625266262622662262626266262622662262626266262622662262626266262622626262626266262'
                                    '6226262626262662626226262626262662626226262626262662626226262026262662626226262626262662'
                                    '62622626202626266262622626262626266262622626202626266262')],
                                  [('6767733773700662253230033230062323233036320320232732033031030223273703033103202327370330'
                                    '3103022327370330210302232737033013032023273703301307022327370330130702232737033013070223'
                                    '2737030313070223273703031307022127370303130702212737030313070221273703301307022140020507'
                                    '7403040556565004030507530303505750050405030753033005535350020303075307300553535002030307'
                                    '5303300535535002030303350330053553530203030335033205355353020303033503350535505302030303'
                                    '3503350535055302030303350335053550530203030335033505535353020330033503353634322332322332'
                                    '2323233235343223343232322325322553235335323232353131323225322553253535353223353131323525'
                                    '3225532535353532233531323235253223532535353532233535323235253232532535353532233535323235'
                                    '5232325325353535322335353232355232325325355335322335353232322332677073757073737173737572'
                                    '7070717063727063360270767370757075707305233730273773577372733723323723737075756075377507'
                                    '3756537335672775321765353737723551532572373572074235536735303653367535377235363756370235'
                                    '56232372635676270303655353567373037356363035360116233536'),
                                   ('4234311212211334214131124002424264324223422624522424605025233402202324542524256323232626'
                                    '2424252527274325023654255364253430432356323223255356542523575223022335536223243554625223'
                                    '2427636253563626566523262663422727602065623065625330236236355362043426256223324202434520'
                                    '1216141216202324411012244213121243421340231245011324421312124345134023134531132443131212'
                                    '4341134323134531132443131221434513433231453113244312122143451443341345011024431212214345'
                                    '1443344145131424431412414343144343414113144243141242434314434343411314241261631660601660'
                                    '6126366160626026326160616061266062632670203263606162612660626326732031636062626226606260'
                                    '2637203263606262622360626026372032636062622126606260263720326360266321266062602637203263'
                                    '6026632626606260263702326360266326266062606263013263602660262360656565566565656565656565'
                                    '6565656565656565656565656565656565656565656565656565656565656565656565656565656565656565'
                                    '6565656565656565656565656565656565656565656565656565656565656565656565656565656565656565'
                                    '65656565656565656565656565656565656565656565656565656565')]]},
 'deepseek_v3_671b': {'dropped_fraction': [0.1953125, 0.259765625],
                      'expert': 3,
                      'expert_load': [[0.359375, 0.1650390625, 0.1494140625, 0.4541015625,
                                       0.1259765625, 0.3232421875, 0.1435546875, 0.279296875],
                                      [0.142578125, 0.21875, 0.419921875, 0.279296875, 0.1572265625,
                                       0.15625, 0.4375, 0.1884765625]],
                      'grad_norm': [18.484281539916992, 13.928427696228027],
                      'lm_loss': [6.761205673217773, 6.5951128005981445],
                      'load_balance': [0.0, 0.0],
                      'loss': [8.741442680358887, 8.533012390136719],
                      'm': [{'dense_blocks.attn.wq_b.kernel': [0.0001397312298649922,
                                                               4.416722367750481e-05,
                                                               -3.818891127593815e-05,
                                                               -5.543639053939842e-05,
                                                               -1.002342742140172e-05,
                                                               -8.007743417692836e-06,
                                                               -2.664140447450336e-05,
                                                               1.660563430050388e-05,
                                                               6.49864596198313e-05,
                                                               0.00010384561028331518,
                                                               -0.00011413136962801218,
                                                               3.5771452076005517e-06,
                                                               4.719496064353734e-05,
                                                               -8.559207344660535e-05,
                                                               -4.84662314192974e-06,
                                                               0.0001975581981241703],
                             'embed.embedding': [0.00012739241356030107, -5.4069394536782056e-05,
                                                 0.0002954014344140887, 2.1752990505774505e-05,
                                                 -0.00017243808542843908, 0.0, 0.0, 0.0, 0.0, 0.0,
                                                 0.0, 0.0, 0.0007874789880588651, 0.0, 0.0, 0.0],
                             'ln_f.scale': [3.253625982324593e-05, 0.00013012155250180513,
                                            -8.506671292707324e-05, -4.950320089847082e-06,
                                            3.7695604987675324e-05, -6.476695853052661e-05,
                                            -1.1628058018686716e-05, 3.417685366002843e-05,
                                            0.00014060991816222668, 0.0001764927146723494,
                                            0.00010147815191885456, -2.7693395168171264e-06,
                                            7.711550279054791e-05, -0.00010499540803721175,
                                            5.2579674957087263e-05, -1.186653389595449e-05],
                             'moe_blocks.moe.experts.w_up': [3.9861711229605135e-06,
                                                             1.943184088304406e-06,
                                                             3.63040562660899e-05,
                                                             1.4084336044106749e-06,
                                                             -9.407792276761029e-06,
                                                             1.2347962183412164e-05,
                                                             1.2520031305029988e-05,
                                                             -5.938074082223466e-06,
                                                             3.3590793009352637e-06,
                                                             -3.8959751691436395e-06,
                                                             -1.6365389683414833e-06,
                                                             3.91749517802964e-06,
                                                             -1.1769454886234598e-06,
                                                             2.7702130864781793e-06,
                                                             -7.791139978508e-06,
                                                             5.345673343981616e-06],
                             'moe_blocks.moe.router.kernel': [-1.3527225064535742e-06,
                                                              2.5549993551976513e-06,
                                                              -1.144261477747932e-05,
                                                              3.7226332096906845e-06,
                                                              7.665132216061465e-06,
                                                              1.9723876903299242e-05,
                                                              5.427550149761373e-06,
                                                              3.1160761864157394e-06,
                                                              4.818969614461821e-07,
                                                              -1.535261981189251e-05,
                                                              -7.874787115724757e-07,
                                                              9.51403853832744e-06,
                                                              1.9688426618813537e-05,
                                                              -1.4347462638397701e-05,
                                                              3.4508233511587605e-05,
                                                              -2.1040737919975072e-05]},
                            {'dense_blocks.attn.wq_b.kernel': [8.711124974070117e-05,
                                                               1.543091275379993e-05,
                                                               5.771556243416853e-05,
                                                               -5.5697219067951664e-05,
                                                               -2.2167461793287657e-05,
                                                               -5.798629558739776e-07,
                                                               -5.2300245442893356e-05,
                                                               7.68925565353129e-06,
                                                               0.00016461225459352136,
                                                               0.0001259125128854066,
                                                               -3.796795499511063e-05,
                                                               -5.127159602125175e-05,
                                                               5.2557657909346744e-05,
                                                               -0.00011664546764222905,
                                                               3.229931462556124e-05,
                                                               0.0002694798167794943],
                             'embed.embedding': [0.00011465317220427096, 0.00013929315900895745,
                                                 0.00069081672700122, 0.00012951325334142894,
                                                 -0.0002461872063577175, 0.0,
                                                 -3.318727613077499e-05, -0.00046388874761760235,
                                                 0.0, 0.0, 0.0, 0.0, 0.0007087310659699142, 0.0,
                                                 0.0, 0.0],
                             'ln_f.scale': [0.00016890592814888805, 6.69884102535434e-05,
                                            1.1067759260185994e-05, 6.0092723288107663e-05,
                                            -4.020263020265702e-07, 1.6752030205680057e-05,
                                            -0.0001018060720525682, 0.00011135785462101921,
                                            0.00016553100431337953, 0.00019956960750278085,
                                            0.00021529255900532007, 0.00013971175940241665,
                                            0.00011299733887426555, -0.0001688713819021359,
                                            0.00012216344475746155, 5.058000169810839e-05],
                             'moe_blocks.moe.experts.w_up': [1.7752739950083196e-05,
                                                             -8.930416697694454e-06,
                                                             2.763259362836834e-05,
                                                             -1.4196177289704792e-05,
                                                             -1.086136035155505e-05,
                                                             8.691516995895654e-06,
                                                             1.1747431017283816e-05,
                                                             -3.819415269390447e-06,
                                                             2.4215303255914478e-06,
                                                             -1.8424373138259398e-06,
                                                             -3.41305417350668e-06,
                                                             4.361349510872969e-06,
                                                             1.460695784771815e-06,
                                                             6.972240953473374e-06,
                                                             -5.3846710216021165e-05,
                                                             5.526467248273548e-06],
                             'moe_blocks.moe.router.kernel': [1.3956095017420012e-06,
                                                              2.4016886527533643e-05,
                                                              9.545358807372395e-06,
                                                              -1.425623213435756e-05,
                                                              6.934935754543403e-06,
                                                              1.1617463314905763e-05,
                                                              -2.273933387186844e-05,
                                                              9.351660992251709e-06,
                                                              -6.33099580227281e-06,
                                                              -7.206556801975239e-06,
                                                              -3.669524812721647e-05,
                                                              -4.5808728827978484e-06,
                                                              3.967824341088999e-06,
                                                              -5.181597316550324e-06,
                                                              3.527038643369451e-05,
                                                              2.3020531443762593e-05]}],
                      'mtp_loss': [6.586953163146973, 6.445296287536621],
                      'params': {'dense_blocks.attn.wq_b.kernel': [0.11974209547042847,
                                                                   -0.052313182502985,
                                                                   0.10097088664770126,
                                                                   -0.003530856454744935,
                                                                   0.09659230709075928,
                                                                   0.059755731374025345,
                                                                   0.0992698147892952,
                                                                   -0.2738470137119293,
                                                                   -0.09075629711151123,
                                                                   -0.02591455914080143,
                                                                   0.03716430068016052,
                                                                   -0.009457106702029705,
                                                                   -0.05458255112171173,
                                                                   0.016085408627986908,
                                                                   0.0957399308681488,
                                                                   0.13291485607624054],
                                 'embed.embedding': [-0.017833560705184937, -0.011247809045016766,
                                                     -0.0037604286335408688, -0.008694601245224476,
                                                     0.01739041693508625, -0.03870707377791405,
                                                     -0.01048071589320898, -0.011172627098858356,
                                                     0.014743790961802006, 0.000651156937237829,
                                                     -0.03999199718236923, 0.0023125940933823586,
                                                     -3.926295539713465e-05, 0.02286127768456936,
                                                     -0.03999199718236923, 0.006640085484832525],
                                 'ln_f.scale': [0.9981330037117004, 0.9986389875411987,
                                                1.0009325742721558, 1.0003174543380737,
                                                0.999005913734436, 1.000874400138855,
                                                1.0018128156661987, 0.9980615973472595,
                                                0.9981461763381958, 0.9981703162193298,
                                                0.9980022311210632, 1.0002777576446533,
                                                0.9980442523956299, 1.0019811391830444,
                                                0.9980101585388184, 1.000403642654419],
                                 'moe_blocks.moe.experts.w_up': [0.14627286791801453,
                                                                 -0.09204550087451935,
                                                                 -0.10412842035293579,
                                                                 -0.17706851661205292,
                                                                 -0.10989738255739212,
                                                                 0.08672614395618439,
                                                                 -0.03956454619765282,
                                                                 0.08456379920244217,
                                                                 -0.041626449674367905,
                                                                 -0.05081600695848465,
                                                                 0.0033030337654054165,
                                                                 0.10740861296653748,
                                                                 0.022804198786616325,
                                                                 0.0814308449625969,
                                                                 -0.014593909494578838,
                                                                 -0.07168743759393692],
                                 'moe_blocks.moe.router.kernel': [0.020690202713012695,
                                                                  -0.009571564383804798,
                                                                  -0.007534190081059933,
                                                                  -0.015343801118433475,
                                                                  -0.03264325112104416,
                                                                  0.0281564611941576,
                                                                  0.01207367517054081,
                                                                  0.02588033862411976,
                                                                  -0.013607416301965714,
                                                                  -0.011587094515562057,
                                                                  0.03378953039646149,
                                                                  0.02971121110022068,
                                                                  -0.006367741152644157,
                                                                  0.008726248517632484,
                                                                  -0.009912985377013683,
                                                                  -0.029896805062890053]},
                      'router_bias': [[[-0.0010000000474974513, 0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513],
                                       [-0.0010000000474974513, 0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513,
                                        0.0010000000474974513, -0.0010000000474974513]],
                                      [[1.00000761449337e-07, 0.001999900210648775,
                                        -1.00000761449337e-07, -0.001999900210648775,
                                        0.001999900210648775, 1.00000761449337e-07,
                                        -1.00000761449337e-07, 1.00000761449337e-07],
                                       [1.00000761449337e-07, 0.001999900210648775,
                                        -1.00000761449337e-07, -0.001999900210648775,
                                        0.001999900210648775, 1.00000761449337e-07,
                                        -1.00000761449337e-07, 1.00000761449337e-07]]],
                      'router_z': [0.004151131957769394, 0.004311129916459322],
                      'routing': [[('0501011601101460060701146007146167071017607414606770101706741460677010170674146167701017'
                                    '6074146167701017017414616773171704741461677017170474146167701717047414616770171704741461'
                                    '6773171704741461677017170474146167737117047441616773711704744161677371170474416175354040'
                                    '3403033030200203030303370303033002020303030337033003300702030303033703300330070203030303'
                                    '3703300330070203030303370330033007020303030337033003300702030303033703300330070203030303'
                                    '3703300330070203030303370330033007020303030337033003300702033003033703306261516041065014'
                                    '0157015745171656465045436505455057055754751665455040434550455757055754171665455040435450'
                                    '4575570557541716564550404354354575750557451716504650404354354574750557451714504650404354'
                                    '5345747505575417145046574045545345747505575417145046574045545345267072747371737471714776'
                                    '7674034630344336747314477627747374373435743770372773347335733735473770377675353232377437'
                                    '5327755723375737753047355773327573756534753574625453735337353557737554573265233703650770'
                                    '35535373372135420620303212530227363553323752212537757502'),
                                   ('7174137414161753166337616136313536711613136523743527323435463636302637373263353656363706'
                                    '3562753623325327365026755226235635606043365675307561676532701364625253272523656252067550'
                                    '5163652030066506753553266052212523060230232135200206352632372521253075250605052574737373'
                                    '7371727373737673067070737370720575737073737001707073730772707573707373700474707373077270'
                                    '7373707373700474707373077270737370737370407470737307727073737073737040747073730772707573'
                                    '7073737040747073730772707573707373704074707373077270757370737370407470734747372337422736'
                                    '7231232326323237323224272627372423623232733234242726277324236232237332342327262771422362'
                                    '3223733234262762277342216232237332342627622717242162362371324326276223172421623623713243'
                                    '2623612117242162362471324326236121162421623624713234262363216124070505505605262526626262'
                                    '2762262626266262262626262626266262262626262626266262262626262626266262262626262626266262'
                                    '2626262026262626622626262026262626622626262026262626622626262026262626622626262026262626'
                                    '62262626202626262662262626202626262662262626202626262662')],
                                  [('7661671652070562103256105305026215231610310502261532161013050226513210011306026215321601'
                                    '1505022651531001120502625153010115560226155301011205022615530101120602265135010712050226'
                                    '5135010312060226153501061206022615350106120502265135010612050226513501061205022640520505'
                                    '3713075056565740075407530730050557505005030753073005055305050703075307300505530305070307'
                                    '5303300330533535030307530335033053353503030353033503305335350703035303350330533535070303'
                                    '3503350330533530033030353735303053353003303035733530355335300330303570353234313235233232'
                                    '2332323535343232323535353213322332233535313232353132353531323535233535353232351335353531'
                                    '3235352535353532323531353535353232352335353532233531353535353235352535353532233531353535'
                                    '5332353525353535322335353535355332353523353535322335353535323532600773707073707175717071'
                                    '0707176760717263730767703072747437077007177603733273567027737023737263707257757175725670'
                                    '3627057131763256637167625373736717652330733563702535566527653263646556736732367063630235'
                                    '72325727636567563006653565677275737365633657350602653536'),
                                   ('4143131312121335124231211321242163232324702021272320060225213203322320522426232020232062'
                                    '0727255202272626023625022126422306622352622125236752262320705362022532656224652364636564'
                                    '2462366342633602612623652636646225320660266526267232326536235232022064566062367202434324'
                                    '1414411414414143411414421414121242411441411441141242141412124141124141144114124214141212'
                                    '4141124141144114124114131212414512414141411414411414122142451241414141141441141412214245'
                                    '1241414141141441141412234245124141414114144114141223424512414141411414411661636263606062'
                                    '6062366360623030366360016260266336636230303263606062612363636362370332636061266123363663'
                                    '6230033263606126612363133662300332636061266123631336623003323660162623236331366230033263'
                                    '6025322123633136623003323660256223236331366236033236602362232363676567566565616565656165'
                                    '6565656161616565656561656161616565656162656161616565656162656161616565656162656161616765'
                                    '6561616561616165656565616561616565656565616561676565656565616561676565656565616561656565'
                                    '65656561656167656565656561656167656565656565656165656565')]]}}


def moe_train_config(arch: str):
    """MOE_TRAIN_REF's config of ``arch``: its smoke config at the published
    capacity factor, in float32."""
    import dataclasses

    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch)
    return dataclasses.replace(cfg, dtype=MOE_TRAIN_REF["dtype"], moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_TRAIN_REF["capacity_factor"]))


def moe_train_launches(cfg) -> dict:
    """The kernel launches of one ``build_train_step`` step of the ``moe``
    config ``cfg`` with ``remat="block"``: each of the ``L`` blocks runs its
    norms (ln1, ln2 and MLA's ``q_a_norm`` and ``kv_a_norm``) and the flash
    forward twice (forward and recompute), ln_f once, an MTP head once more
    (its block, not checkpointed, and its norm); the flash backward once a
    block and an MTP block."""
    nl, mtp = cfg.n_layers, cfg.mtp_depth
    norms = 4 if cfg.mla.q_lora_rank else 3
    return {"flash_attention_fwd": 2 * nl + mtp, "flash_attention_bwd_dkv": nl + mtp,
            "flash_attention_bwd_dq": nl + mtp, "rmsnorm": 2 * norms * nl + 1 + (norms + 1) * mtp}


def _host(x):
    import numpy as np

    return np.asarray(x.detach().float().cpu() if hasattr(x, "detach") else x, np.float64)


def moe_step_record(metrics) -> dict:
    """A step's scalars (``MOE_STEP_SCALARS`` present in ``metrics``) and
    its ``expert_load``, as floats, from either package's metrics."""
    rec = {k: float(_host(metrics[k])) for k in MOE_STEP_SCALARS if k in metrics}
    rec["expert_load"] = _host(metrics["expert_load"]).tolist()
    return rec


def moe_train_samples(leaf_array, expert: int) -> dict:
    """``train_samples`` of ``MOE_TRAIN_LEAVES`` (``leaf_array(path)``: layer
    0 of a stacked leaf), the routed experts' leaf cut to ``expert``."""
    return train_samples(lambda p: leaf_array(p)[expert] if p == MOE_EXPERT_LEAF
                         else leaf_array(p), MOE_TRAIN_LEAVES)


def moe_train_summary(records: list, expert: int, params: dict, moments: list,
                      biases: list | None = None) -> dict:
    """The numbers of a moe training run that the checks compare (either
    package): per step each of ``moe_step_record``'s entries, the sampled
    expert, the sampled updated parameters (after the last step) and first
    moments (after each step), and with a sigmoid-bias router every MoE
    layer's whole bias after each step."""
    out = {k: [r[k] for r in records] for k in records[0]}
    out.update(expert=expert, params=params, m=moments)
    if biases is not None:
        out["router_bias"] = biases
    return out


def port_moe_train_reference(cfg, dev, want: dict | None = None) -> dict:
    """MOE_TRAIN_REF's steps of ``cfg`` through the port on ``dev`` from
    ``random_lm_tree(cfg, seed)``: ``moe_train_summary`` of the run.  With
    ``want`` (a ``JAX_MOE_TRAIN`` entry) every MoE layer routes as
    ``want["routing"]`` says (``routed_as``, the recompute replaying its
    forward) and ``want["expert"]`` is sampled; else its own routing, and
    the largest load of the first step.  Also its own routing, as
    ``capture_routing`` records it (``routing``), and the smallest margin
    of any of its tokens (``min_margin``, in router-logit units)."""
    import torch

    from repro_torch import convert
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    ref = MOE_TRAIN_REF
    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, ref["seed"]), cfg,
                                         device=dev)
    opt = AdamWConfig(lr=MOE_TRAIN["lr"])
    params = dict(model.named_parameters())
    state = adamw_init(params, opt)
    step = build_train_step(cfg, opt, total_steps=MOE_TRAIN["total_steps"],
                            warmup_steps=MOE_TRAIN["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=ref["seed"], batch=ref["batch"],
                                       seq_len=ref["seq_len"], vocab_size=cfg.vocab_size))
    host = lambda t: t.detach().to(torch.float32).cpu().numpy()
    expert = None if want is None else want["expert"]
    bias = cfg.moe.router == "sigmoid_bias"
    records, moments, biases = [], [], []
    imposed = contextlib.nullcontext() if want is None else routed_as(picks_records(want), model)
    with capture_routing(model) as own, imposed:
        for i in range(ref["steps"]):
            model, state, metrics = step(model, state, ds.batch_at(i), i)
            records.append(moe_step_record(metrics))
            if expert is None:
                expert = int(torch.argmax(metrics["expert_load"]))
            moments.append(moe_train_samples(lambda p: host(state.m[_port_leaf(p)]), expert))
            if bias:
                biases.append([host(b.moe.router.bias).tolist() for b in model.moe_blocks])
    sampled = moe_train_samples(lambda p: host(params[_port_leaf(p)]), expert)
    out = moe_train_summary(records, expert, sampled, moments, biases if bias else None)
    out["routing"] = own
    out["min_margin"] = min(min(r["margin"]) for layer in own for r in layer)
    return out


def picks_text(picks) -> str:
    """A MoE call's picks ``(N, k)`` as one hex digit an expert (up to 16
    experts, as the smoke configs have), row by row: ``JAX_MOE_TRAIN``'s
    compact record of a routing."""
    import numpy as np

    p = np.asarray(picks)
    assert p.max() < 16
    return "".join(f"{e:x}" for e in p.reshape(-1))


def picks_records(want: dict) -> list:
    """``want["routing"]`` (``picks_text`` per MoE layer per forward pass of
    MOE_TRAIN_REF's tokens) as ``routed_as``' records."""
    n = MOE_TRAIN_REF["batch"] * MOE_TRAIN_REF["seq_len"]

    def record(text):
        k = len(text) // n
        return {"picks": [[int(c, 16) for c in text[i:i + k]] for i in range(0, len(text), k)]}

    return [[record(text) for text in layer] for layer in want["routing"]]


def compare_moe_picks(got: list, want: list, tie: float) -> tuple[list[str], int]:
    """The picks of ``got`` (``capture_routing``'s records, per MoE layer
    per forward pass) against ``want``'s (the same layout): a token whose
    experts differ as a set is a failure unless its own margin is within
    ``tie`` (a near-tie flip, counted)."""
    import numpy as np

    bad, flipped = [], 0
    for layer, (gs, ws) in enumerate(zip(got, want)):
        for call, (g, w) in enumerate(zip(gs, ws)):
            gp, wp = np.sort(np.asarray(g["picks"]), -1), np.sort(np.asarray(w["picks"]), -1)
            for i in np.flatnonzero((gp != wp).any(-1)):
                if g["margin"][i] <= tie:
                    flipped += 1
                else:
                    bad.append(f"layer {layer} pass {call} token {i}: experts {gp[i].tolist()} vs "
                               f"{wp[i].tolist()} (margin {g['margin'][i]:.3e})")
    return bad, flipped


def compare_moe_train(got: dict, want: dict, lr: float, tol: dict) -> list[str]:
    """Failures of ``got`` against ``want`` (``moe_train_summary``s) under
    ``tol``: ``compare_train``'s loss, grad norm, moments and parameters on
    ``MOE_TRAIN_LEAVES``; ``lm_loss`` and ``mtp_loss`` as the loss;
    ``load_balance`` and ``router_z`` to ``tol["aux"]`` relative;
    ``expert_load`` and ``dropped_fraction`` exactly; the router bias to
    ``tol["bias"]``."""
    bad = []
    if got["expert"] != want["expert"]:
        return [f"sampled expert {got['expert']} vs {want['expert']}"]
    info = {"routing", "min_margin"}
    if set(got) - info != set(want) - info:
        return [f"summary keys {sorted(got)} vs {sorted(want)}"]
    bad += compare_train(got, want, lr, tol, MOE_TRAIN_LEAVES)
    for i in range(len(want["loss"])):
        for k in ("lm_loss", "mtp_loss"):
            if k in want and not abs(got[k][i] - want[k][i]) <= tol["loss"]:
                bad.append(f"step {i}: {k} {got[k][i]!r} vs {want[k][i]!r}")
        for k in ("load_balance", "router_z"):
            g, w = got[k][i], want[k][i]
            if not abs(g - w) <= tol["aux"] * abs(w):
                bad.append(f"step {i}: {k} {g!r} vs {w!r}")
        for k in ("expert_load", "dropped_fraction"):
            if got[k][i] != want[k][i]:
                bad.append(f"step {i}: {k} {got[k][i]!r} vs {want[k][i]!r}")
        if "router_bias" in want:
            for layer, (g, w) in enumerate(zip(got["router_bias"][i], want["router_bias"][i])):
                far = [(e, a, b) for e, (a, b) in enumerate(zip(g, w))
                       if not abs(a - b) <= tol["bias"]]
                if far:
                    bad.append(f"step {i}: layer {layer} router bias differs at {far[:4]}")
    return bad


def moe_train_max_diff(got: dict, want: dict, lr: float, tol: dict) -> dict:
    """``train_max_diff`` on ``MOE_TRAIN_LEAVES`` plus the largest absolute
    differences of ``lm_loss`` and ``mtp_loss``, the relative ones of the two
    aux losses, and the router bias's absolute one."""
    out = train_max_diff(got, want, lr, tol, MOE_TRAIN_LEAVES)
    for k in ("lm_loss", "mtp_loss", "load_balance", "router_z"):
        if k in want:
            rel = k in ("load_balance", "router_z")
            out[k] = max(abs(g - w) / (abs(w) if rel and w else 1.0)
                         for g, w in zip(got[k], want[k]))
    if "router_bias" in want:
        out["router_bias"] = max(abs(a - b)
                                 for gs, ws in zip(got["router_bias"], want["router_bias"])
                                 for g, w in zip(gs, ws) for a, b in zip(g, w))
    return out


# Tolerances of phase 18b, step 1 on the kernels against the same step on
# the plain versions on one routing (the plain run's, imposed): TRAIN_TOL
# (its reasons hold: bf16 gradients summed in other orders, the flash
# kernels keeping the attention's probabilities in float32), and for
# ``load_balance`` and ``router_z`` 5e-3 relative, as the grad norm: means
# over the 2048 tokens of float32 functions of router logits whose bf16
# inputs differ by an ulp or two between the two routes.
MOE_TRAIN_TOL = dict(TRAIN_TOL, aux=5e-3)


def _moe_step_summary(model, state, metrics, expert: int) -> dict:
    """``moe_train_summary`` of one step of a port model."""
    import torch

    params = dict(model.named_parameters())
    host = lambda t: t.detach().to(torch.float32).cpu().numpy()
    return moe_train_summary(
        [moe_step_record(metrics)], expert,
        moe_train_samples(lambda p: host(params[_port_leaf(p)]), expert),
        [moe_train_samples(lambda p: host(state.m[_port_leaf(p)]), expert)])


def _bit_prints(tensors: dict) -> dict:
    """Per tensor two sums of its bits read as integers, plain and weighted
    by position (mod 65521, + 1), over slices of 2^25 elements: equal
    tensors give equal prints, and a changed bit changes the first."""
    import torch

    out = {}
    for name, x in tensors.items():
        flat = x.detach().reshape(-1).view(torch.int16 if x.element_size() == 2 else torch.int32)
        s = w = 0
        for i in range(0, flat.numel(), 1 << 25):
            b = flat[i:i + (1 << 25)].to(torch.int64)
            pos = torch.arange(i, i + b.numel(), device=b.device) % 65521 + 1
            s, w = s + torch.sum(b), w + torch.sum(b * pos)
        out[name] = (int(s), int(w))
    return out


def phase_moe_train_kernels(dev) -> dict:
    """18a: the flash backward at deepseek's MLA training shape (q, k (4,
    128, 512, 192), v (4, 128, 512, 128), causal bf16) through
    ``FlashAttention`` (v and the cotangent zero-padded to 192, dv cut
    back), held as phase 7 holds it against the plain backward on the same
    residuals and against autograd through the plain attention, and both
    kernels timed beside the plain backward and the library's (autograd
    through ``F.scaled_dot_product_attention`` at 192/128, backward only),
    with the bound of the model's work (``_flash_bwd_bytes_ops`` at v's
    width) and the padded work the kernels do."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa, ref

    cfg = moe_config(MOE_V2)
    m = cfg.mla
    gen = torch.Generator(device=dev).manual_seed(18)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf16 = torch.bfloat16
    b, t, h = MOE_TRAIN["batch"], MOE_TRAIN["seq_len"], cfg.n_heads
    dqk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    scale = dqk ** -0.5
    q, k = (randn(b, h, t, dqk).to(bf16) for _ in range(2))
    v, do = (randn(b, h, t, dv).to(bf16) for _ in range(2))
    by_route = lambda: [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    before = by_route()
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.FlashAttention.apply(ql, kl, vl, True, None), (ql, kl, vl), do)
    took = {r for b_, a_ in zip(before, by_route()) for r in a_ if a_[r] != b_[r]}
    _check(len(took) == 1, f"flash backward mla: one route for both kernels, took {took}")
    route = next(iter(took))
    vp, dop = fa.pad_value(v, dqk), fa.pad_value(do, dqk)
    o, lse = fa.flash_attention_fwd(q, k, vp, causal=True, scale=scale)
    plain = ref.flash_attention_bwd(q, k, vp, o, lse, dop, causal=True, scale=scale)
    plain = (plain[0], plain[1], plain[2][..., :dv])
    qw, kw, vw = (x.float().requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(ref.attention(qw, kw, vw, causal=True, scale=scale), (qw, kw, vw),
                               do.float())
    torch.cuda.synchronize()
    line = f"flash bwd   mla q, k {tuple(q.shape)} v {tuple(v.shape)} bf16 [{route}]:"
    ok, err = True, 0.0
    for nm, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
        g64, p64, a64 = g.double(), p.double(), a.double()
        sc = float(p64.abs().max())
        e_p, e_a = float((g64 - p64).abs().max()), float((g64 - a64).abs().max())
        # As phase 7 holds bf16: one bf16 ulp of the element plus 1e-5 x
        # scale against the plain backward, plus 2^-7 x scale against
        # autograd of the plain attention (bf16 residuals o and dO).
        ok &= tuple(g.shape) == tuple(p.shape) and bool(
            ((g64 - p64).abs() <= 2.0**-7 * p64.abs() + 1e-5 * sc).all())
        ok &= bool(((g64 - a64).abs() <= 2.0**-7 * a64.abs() + 2.0**-7 * sc).all())
        line += f" {nm} {e_p:.3e}/{e_a:.3e} (max {sc:.3f})"
        err = max(err, e_p)
    print(line + "  [kernel - plain backward / - autograd of plain attention]")
    _check(ok, "flash backward at MLA's shape vs plain")
    lse_c, delta = lse.contiguous(), torch.sum(dop.float() * o.float(), dim=-1)
    dkv_ms = _median_ms(lambda: fa.flash_bwd_dkv(q, k, vp, dop, lse_c, delta, causal=True,
                                                 scale=scale))
    dq_ms = _median_ms(lambda: fa.flash_bwd_dq(q, k, vp, dop, lse_c, delta, causal=True,
                                               scale=scale))
    plain_ms = _median_ms(lambda: ref.flash_attention_bwd(q, k, vp, o, lse, dop, causal=True,
                                                          scale=scale))
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
    lib_ms = _median_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    costs = _flash_bwd_bytes_ops(q, k, True, v=v)
    padded = _flash_bwd_bytes_ops(q, k, True)
    bound = lambda c: max(c[0] / HBM_BYTES_PER_S, c[1] / BF16_FLOP_PER_S) * 1e3
    rows = {}
    for key, which in (("dkv", "flash_attention_bwd_dkv"), ("dq", "flash_attention_bwd_dq")):
        t_b, t_o = costs[key][0] / HBM_BYTES_PER_S * 1e3, costs[key][1] / BF16_FLOP_PER_S * 1e3
        rows[which] = dict(mla_shape=[list(q.shape), list(v.shape)], mla_route=route,
                           mla_ms=dkv_ms if key == "dkv" else dq_ms, mla_plain_ms=plain_ms,
                           mla_library_ms=lib_ms, mla_bound_ms=max(t_b, t_o),
                           mla_bound_by="bytes" if t_b >= t_o else "operations",
                           mla_bound_padded_ms=bound(padded[key]), mla_max_abs_err=err)
    print(f"flash bwd   mla bf16 [{route}]: dK/dV {dkv_ms:.4f} ms (bound "
          f"{rows['flash_attention_bwd_dkv']['mla_bound_ms']:.4f}, padded work "
          f"{bound(padded['dkv']):.4f}), dQ {dq_ms:.4f} ms (bound "
          f"{rows['flash_attention_bwd_dq']['mla_bound_ms']:.4f}, padded "
          f"{bound(padded['dq']):.4f}); plain backward {plain_ms:.4f} ms, SDPA backward at "
          f"192/128 {lib_ms:.4f} ms")
    return rows


def phase_moe_train(dev, model, profile_dir: Path | None = None) -> dict:
    """18b: deepseek-v2 at full width cut to 2 layers (``model``: MOE_V2's,
    bf16) trained with ``build_train_step``, ``remat="block"`` and AdamW's
    float32 moments.  Step 1 on the plain versions (its routing captured),
    then from the same start (a host copy of the parameters: a clone on the
    card would be 10.7 GB) the same step on the kernels on the plain run's
    routing (``routed_as``, the recompute replaying its forward), held to it
    under MOE_TRAIN_TOL with the kernel run's own routing compared apart
    (``compare_routing``); the kernel step once more from the same start on
    the same routing, whose parameters and first moment must equal the
    first kernel run's bit for bit (``_bit_prints``, or the differing
    leaves are printed); then two more kernel steps on their own routing.
    Every kernel step must launch the flash forward, dK/dV, dQ and rmsnorm
    ``moe_train_launches`` times, the plain step none.  The model's
    parameters are those of its last step when this returns."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    t_phase = time.perf_counter()
    cfg, tr = model.cfg, MOE_TRAIN
    _check(cfg.remat == "block" and cfg.dtype == "bfloat16" and cfg.family == "moe",
           "the moe config trains in bf16 with remat")
    b, t = tr["batch"], tr["seq_len"]
    opt = AdamWConfig(lr=tr["lr"])
    step = build_train_step(cfg, opt, total_steps=tr["total_steps"],
                            warmup_steps=tr["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=b, seq_len=t,
                                       vocab_size=cfg.vocab_size))
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    mo = cfg.moe
    # Active parameters a token: all but the routed experts it is not sent to.
    n_active = n_params - (cfg.n_layers - mo.first_dense_layers) * (
        mo.n_experts - mo.experts_per_token) * 3 * cfg.d_model * mo.d_expert
    t0 = time.perf_counter()
    start = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    copy_s = time.perf_counter() - t0

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])

    per_step = moe_train_launches(cfg)
    none = dict.fromkeys(per_step, 0)
    batch0 = ds.batch_at(0)

    # (1) Step 1 on the plain versions, its routing captured.
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_routing(model) as rp, ops.forced("ref"):
        _, st, mp = step(model, adamw_init(params, opt), batch0, 0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(_train_counts() == none, f"moe train plain step launched {_train_counts()}")
    expert = int(torch.argmax(mp["expert_load"]))
    want = _moe_step_summary(model, st, mp, expert)
    del st, mp
    restore()

    # (2) The same step on the kernels on the plain run's routing.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts = [], []

    def kernel_step(i, state, routing=None):
        _reset_train_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if routing is None else routed_as(routing, model):
            _, state, metrics = step(model, state, ds.batch_at(i), i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(_train_counts())
        return state, metrics

    with capture_routing(model) as rk:
        state, mk = kernel_step(0, adamw_init(params, opt), rp)
    got = _moe_step_summary(model, state, mk, expert)
    prints = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    del state, mk
    restore()
    # (3) Once more from the same start on the same routing.
    state, mk = kernel_step(0, adamw_init(params, opt), rp)
    again = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    differ = sorted(n for n in prints if prints[n] != again[n])
    del start
    # (4) Two more kernel steps, each on its own routing.
    losses = [float(mk["loss"])]
    for i in range(1, tr["steps"]):
        state, mk = kernel_step(i, state)
        losses.append(float(mk["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    routing = compare_routing(rk[0], rp[0], cfg)
    bad = compare_moe_train(got, want, tr["lr"], MOE_TRAIN_TOL)
    step_s = walls[-1]
    tokens = b * t
    mfu = 6.0 * n_active * tokens / (step_s * BF16_FLOP_PER_S)
    print(f"moe train {cfg.name} {cfg.n_layers} layers, {n_params} parameters ({n_active} active a "
          f"token; bf16, remat={cfg.remat}, AdamW float32 moments), {b} x {t} tokens: plain step "
          f"{plain_s:.3f} s, kernel step walls {[round(w, 4) for w in walls]} s (two step-1 runs, "
          f"then steps 2-{tr['steps']}), losses {losses}, launches a step {counts[-1]}, peak "
          f"{peak:.2f} GiB allocated; the parameters' host copy {copy_s:.1f} s")
    print("moe train step 1, kernels vs plain versions on the plain run's routing: "
          + json.dumps(moe_train_max_diff(got, want, tr["lr"], MOE_TRAIN_TOL))
          + "; expert_load and dropped_fraction equal: "
          + str(all(got[k] == want[k] for k in ("expert_load", "dropped_fraction"))))
    print("moe train step 1 routing, kernels vs plain, " + _routing_line("routing", routing))
    print(f"moe train step 1 twice on the kernels from the same start: "
          + ("the same bits (parameters and first moment)" if not differ else
             f"{len(differ)} leaves differ: {differ[:12]} (the dispatch's index-put and the "
             f"combine's gather accumulate their backward in an order the card may vary)"))
    print(f"moe train warm step {step_s:.4f} s, {tokens / step_s:.1f} tokens/s, train_mfu "
          f"{mfu:.4f} (6 N_active tokens / (step time x 989 TFLOP/s); remat executes ~8 N)")
    _check(all(c == per_step for c in counts), f"moe train launches {counts}, want {per_step}")
    _check(all(map(math.isfinite, losses)), f"moe train losses {losses}")
    _check(not routing["bad"],
           "moe train routing, kernels vs plain: " + "; ".join(routing["bad"][:10]))
    _check(not bad, "moe train step 1, kernels vs plain versions: " + "; ".join(bad[:10]))
    _check(peak * 2**30 < torch.cuda.get_device_properties(dev).total_memory, "peak memory")
    if profile_dir is not None:
        bp = ds.batch_at(tr["steps"])
        profile_run("moe_v2_train_step",
                    lambda: _timed(lambda: step(model, state, bp, tr["steps"])), profile_dir)
    del state, mk
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"moe train: phase {wall:.1f} s")
    return {"counts": {k: sum(c[k] for c in counts) for k in per_step}, "per_step": per_step,
            "walls": walls, "step_s": step_s, "tokens_per_s": tokens / step_s, "train_mfu": mfu,
            "peak_gib": peak, "plain_step_s": plain_s, "routing_flips": routing["flipped"],
            "same_bits": not differ, "phase_s": wall}


def phase_moe_train_reference(dev) -> dict:
    """18c: MOE_TRAIN_REF's two steps of the v2 and v3 smoke configs
    (float32, 3 layers) on the kernels (flash at head dim 48, v padded from
    32, and rmsnorm; ``moe_train_launches`` a step) on JAX's routing,
    against JAX_MOE_TRAIN under MOE_REF_TOL; the port's own routing
    against JAX's picks apart (``compare_moe_picks``, near-ties within
    MOE_REF_TIE counted)."""
    out = {}
    for arch in MOE_TRAIN_REF["archs"]:
        cfg, want = moe_train_config(arch), JAX_MOE_TRAIN[arch]
        _reset_train_counts()
        got = port_moe_train_reference(cfg, dev, want)
        counts = _train_counts()
        per = {k: v * MOE_TRAIN_REF["steps"] for k, v in moe_train_launches(cfg).items()}
        bad = compare_moe_train(got, want, MOE_TRAIN["lr"], MOE_REF_TOL)
        pbad, flipped = compare_moe_picks(got["routing"], picks_records(want), MOE_REF_TIE)
        print(f"moe train vs JAX {arch} smoke (float32, {cfg.n_layers} layers, "
              f"{MOE_TRAIN_REF['steps']} steps of {MOE_TRAIN_REF['batch']} x "
              f"{MOE_TRAIN_REF['seq_len']}): losses {got['loss']} vs {want['loss']}; largest "
              f"differences "
              f"{json.dumps(moe_train_max_diff(got, want, MOE_TRAIN['lr'], MOE_REF_TOL))}; "
              f"own routing: {flipped} tokens flipped within {MOE_REF_TIE:g} (smallest margin "
              f"{got['min_margin']:.3e}); launches {counts}")
        _check(counts == per, f"moe train reference {arch} launches {counts}, want {per}")
        _check(not pbad, f"moe train {arch} routing vs JAX: " + "; ".join(pbad[:10]))
        _check(not bad,
               f"moe training differs from the JAX package ({arch}): " + "; ".join(bad[:10]))
        out[arch] = {"counts": counts, "flipped": flipped}
    return out


def phase_train_power(dev, cfg, tr: dict, per_step: dict) -> dict:
    """``train()`` with the launcher's PowerSim for ``cfg`` (weights drawn
    on the card from ``tr["seed"]``; ``tr["power_steps"]`` steps of
    ``tr["batch"]`` x ``tr["seq_len"]``), as phase 8c holds llama: the grid
    ramp, the SoC, pdu_health and admm_step once per conditioned
    controller interval, the training kernels ``per_step`` a step.  18d:
    deepseek-v2 at full width cut to 2 layers; 20c: zamba2-2.7b whole."""
    import torch

    from repro_torch.data import DataConfig
    from repro_torch.kernels import admm_step, pdu_health
    from repro_torch.launch.train import power_sim_for
    from repro_torch.optim import AdamWConfig
    from repro_torch.power import phases as P, scenario as SC
    from repro_torch.train import TrainConfig, train

    b, t = tr["batch"], tr["seq_len"]
    sim = power_sim_for(cfg, b, t, device=dev)
    durs, pows = P.step_phases(sim.cost, sim.hw, sim.model)
    step_samples = SC.from_phase_timeline(durs, pows, sim.cfg.sample_hz, device=dev).total_samples
    intervals = step_samples * tr["power_steps"] // sim._k
    pdu_health.pdu_health_sim.launches = admm_step.admm_iterate.launches = 0
    _reset_train_counts()
    t0 = time.perf_counter()
    res = train(cfg, DataConfig(seed=tr["seed"], batch=b, seq_len=t, vocab_size=cfg.vocab_size),
                AdamWConfig(lr=tr["lr"]), TrainConfig(steps=tr["power_steps"], log_every=1,
                                                      seed=tr["seed"]),
                power_sim=sim, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = res["power_report"]
    losses = [r["loss"] for r in res["history"]]
    power_counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
    counts = _train_counts()
    per = {k: v * tr["power_steps"] for k, v in per_step.items()}
    print(f"{cfg.name} train() + PowerSim ({cfg.n_layers} layers): {tr['power_steps']} steps in "
          f"{wall:.2f} s wall, losses {[round(x, 4) for x in losses]}; {intervals} controller "
          f"intervals conditioned; launches pdu_health={power_counts[0]} "
          f"admm_step={power_counts[1]}, training kernels {counts}")
    print(f"{cfg.name} train() + PowerSim report: " + json.dumps(rep))
    del res
    torch.cuda.empty_cache()
    _check(all(map(math.isfinite, losses)), f"{cfg.name} train() losses {losses}")
    _check(rep["grid_max_ramp"] <= 0.1 + 1e-3, f"PowerSim grid ramp {rep['grid_max_ramp']}")
    _check(rep["rack_max_ramp"] > rep["grid_max_ramp"], "PowerSim rack ramp <= grid ramp")
    _check(0.1 <= rep["final_soc"] <= 0.9, f"PowerSim SoC {rep['final_soc']}")
    _check(power_counts == (intervals, intervals),
           f"PowerSim launches {power_counts}, want {intervals} each")
    _check(counts == per, f"{cfg.name} train() launches {counts}, want {per}")
    return {"counts": counts, "power_counts": power_counts, "wall_s": wall}


# The hybrid slice (phases 19-20): zamba2-2.7b at its published width and
# full depth (d_model 2560, 54 Mamba2 layers in 9 groups of 6, one shared
# attention block of 32 heads of 80 visited after each group; bf16; 2.44 B
# parameters), weights drawn on the card by ``transformer.init`` from
# ``seed``, served (prefill 4 x 512; generation 4 requests, 64-token
# prompts, 32 greedy tokens) and trained (``remat="block"``: one checkpoint
# a group; AdamW(lr=1e-3) with its float32 moments and weight decay 0.1;
# 4 x 512 tokens of ``SyntheticLMDataset`` a step, the schedule warmed up in
# one step as TRAIN's; ``train()`` with the launcher's PowerSim for
# ``power_steps`` steps).  Nothing is cut: the model, its gradients and
# moments take ~29 GB.
HYBRID = dict(arch="zamba2_2_7b", seed=0, prompt_seed=1, prefill=(4, 512), gen=(4, 64),
              gen_tokens=32, batch=4, seq_len=512, lr=1e-3, total_steps=10, warmup_steps=1,
              steps=3, power_steps=4)
# What tests/test_torch_hybrid_serve_reference.py runs through the JAX
# package on the CPU and what the card's run is held to: SERVE_REF's
# prefill rows, 8 greedy tokens and the teacher-forced decode logits, at
# full width cut to 12 layers (2 groups, so the shared block is visited
# twice, each visit on its own cache).
HYBRID_SERVE_REF = dict(SERVE_REF, n_layers=12, prompt_seed=HYBRID["prompt_seed"])
# The JAX package's numbers for HYBRID_SERVE_REF (bf16, weights
# ``random_lm_tree(cfg, HYBRID["seed"])``), on the CPU (jax 0.9.0), printed by
# ``python tests/test_torch_hybrid_serve_reference.py``.
JAX_HYBRID_SERVE = {'rows': [{'argmax': 26534,
           'at_ids': [0.6171875,
                      -1.3046875,
                      -0.609375,
                      -0.07373046875,
                      -0.76171875,
                      -0.83203125,
                      -1.578125],
           'lse': 10.838436981880733,
           'margin': 0.125,
           'max': 3.78125},
          {'argmax': 25992,
           'at_ids': [0.74609375,
                      0.3984375,
                      0.49609375,
                      0.349609375,
                      0.404296875,
                      -1.34375,
                      0.2119140625],
           'lse': 10.842583204211127,
           'margin': 0.671875,
           'max': 4.15625},
          {'argmax': 4530,
           'at_ids': [-0.023681640625,
                      -0.92578125,
                      0.34765625,
                      -0.2080078125,
                      1.125,
                      0.76171875,
                      -1.40625],
           'lse': 10.837438277422535,
           'margin': 0.125,
           'max': 3.9375},
          {'argmax': 30880,
           'at_ids': [1.390625,
                      0.5546875,
                      0.51953125,
                      -0.7421875,
                      -0.0947265625,
                      1.8203125,
                      -0.052978515625],
           'lse': 10.823328495754332,
           'margin': 0.265625,
           'max': 3.765625},
          {'argmax': 14795,
           'at_ids': [2.0625, -1.4921875, 0.306640625, -0.53515625, 1.25, -0.166015625, 0.80859375],
           'lse': 10.81903532308704,
           'margin': 0.265625,
           'max': 4.1875}],
 'steps': [[{'argmax': 4530,
             'at_fed': 3.9375,
             'at_ids': [-0.0281982421875,
                        -0.94140625,
                        0.341796875,
                        -0.21484375,
                        1.109375,
                        0.7578125,
                        -1.3984375],
             'lse': 10.837491255263682,
             'margin': 0.109375,
             'max': 3.9375},
            {'argmax': 57,
             'at_fed': 3.71875,
             'at_ids': [-0.41015625,
                        -0.0181884765625,
                        -1.7109375,
                        0.57421875,
                        -1.25,
                        0.9140625,
                        0.361328125],
             'lse': 10.848671446056539,
             'margin': 0.03125,
             'max': 3.71875},
            {'argmax': 30728,
             'at_fed': 4.15625,
             'at_ids': [-1.1953125,
                        0.25390625,
                        -0.98828125,
                        -0.96484375,
                        0.3046875,
                        -0.875,
                        0.051513671875],
             'lse': 10.837883232071068,
             'margin': 0.53125,
             'max': 4.15625},
            {'argmax': 21013,
             'at_fed': 3.96875,
             'at_ids': [0.4296875,
                        1.921875,
                        -0.53515625,
                        -0.9609375,
                        0.62109375,
                        1.046875,
                        -0.41015625],
             'lse': 10.832589024398578,
             'margin': 0.15625,
             'max': 3.96875},
            {'argmax': 21803,
             'at_fed': 3.609375,
             'at_ids': [-0.8046875,
                        0.90234375,
                        -1.2890625,
                        0.034423828125,
                        1.1484375,
                        0.375,
                        1.046875],
             'lse': 10.823144082850824,
             'margin': 0.078125,
             'max': 3.609375},
            {'argmax': 20186,
             'at_fed': 3.671875,
             'at_ids': [-0.042236328125,
                        1.0078125,
                        1.6328125,
                        -0.7265625,
                        -0.7265625,
                        0.60546875,
                        -1.0390625],
             'lse': 10.834794717595061,
             'margin': 0.171875,
             'max': 3.671875},
            {'argmax': 12226,
             'at_fed': 3.78125,
             'at_ids': [-1.03125,
                        0.21875,
                        1.625,
                        0.361328125,
                        -0.318359375,
                        0.7578125,
                        0.169921875],
             'lse': 10.831561115397268,
             'margin': 0.203125,
             'max': 3.78125},
            {'argmax': 2698,
             'at_fed': 3.796875,
             'at_ids': [0.7109375,
                        1.1015625,
                        1.328125,
                        0.03955078125,
                        -0.6484375,
                        -1.296875,
                        0.380859375],
             'lse': 10.840359091756063,
             'margin': 0.015625,
             'max': 3.796875}],
           [{'argmax': 14795,
             'at_fed': 4.1875,
             'at_ids': [2.0625, -1.484375, 0.31640625, -0.5546875, 1.2421875, -0.18359375, 0.8125],
             'lse': 10.819069358427656,
             'margin': 0.28125,
             'max': 4.1875},
            {'argmax': 22321,
             'at_fed': 3.609375,
             'at_ids': [1.28125,
                        -0.0030670166015625,
                        0.546875,
                        -1.421875,
                        -1.109375,
                        0.328125,
                        -0.244140625],
             'lse': 10.833841504434524,
             'margin': 0.015625,
             'max': 3.609375},
            {'argmax': 12774,
             'at_fed': 4.125,
             'at_ids': [0.16796875,
                        0.578125,
                        0.255859375,
                        0.10791015625,
                        -0.03564453125,
                        1.2109375,
                        0.2451171875],
             'lse': 10.836426247569374,
             'margin': 0.25,
             'max': 4.125},
            {'argmax': 7686,
             'at_fed': 4.0,
             'at_ids': [-0.06884765625,
                        -0.3984375,
                        -0.76171875,
                        0.06787109375,
                        0.33984375,
                        1.03125,
                        2.015625],
             'lse': 10.840921310486788,
             'margin': 0.265625,
             'max': 4.0},
            {'argmax': 5342,
             'at_fed': 4.125,
             'at_ids': [0.03125,
                        0.01043701171875,
                        -1.59375,
                        -1.7265625,
                        1.3203125,
                        0.01300048828125,
                        1.1015625],
             'lse': 10.852837391430803,
             'margin': 0.265625,
             'max': 4.125},
            {'argmax': 25799,
             'at_fed': 3.796875,
             'at_ids': [-1.1328125,
                        0.6796875,
                        -0.2294921875,
                        0.73828125,
                        -0.201171875,
                        -0.1171875,
                        -0.61328125],
             'lse': 10.833291972413326,
             'margin': 0.0625,
             'max': 3.796875},
            {'argmax': 31721,
             'at_fed': 3.703125,
             'at_ids': [-0.48828125,
                        -0.033203125,
                        0.7890625,
                        0.04833984375,
                        -0.890625,
                        -0.1513671875,
                        0.19921875],
             'lse': 10.840688720021966,
             'margin': 0.171875,
             'max': 3.703125},
            {'argmax': 26012,
             'at_fed': 4.03125,
             'at_ids': [-1.7265625,
                        1.484375,
                        -0.061767578125,
                        0.375,
                        -1.5390625,
                        0.58203125,
                        -0.1005859375],
             'lse': 10.836953805668738,
             'margin': 0.15625,
             'max': 4.03125}]],
 'tokens': [[4530, 57, 30728, 21013, 21803, 20186, 12226, 2698],
            [14795, 22321, 12774, 7686, 5342, 25799, 31721, 26012]]}
# Tolerance of HYBRID_SERVE_REF against the JAX package.  A 1-ulp bf16
# difference anywhere in this stack spreads: the shared block's attention
# carries it to every position, and 12 layers later the logits (|logit| up
# to ~4.5, a bf16 ulp 2^-5 there) of two bf16 runs lie several ulps apart.
# Measured on the CPU against the JAX package's float32 run on the same
# (bf16-rounded) weights, the prefill rows of JAX's bf16 run lie up to
# 0.125 from it and the port's 0.219; the port's bf16 run lies up to 0.196
# from JAX's over the rows and the teacher-forced steps (an H100's kernels
# 0.1807).  Each Mamba block
# alone matches JAX's in bf16 but for one ulp in 0.006 % of its outputs
# (both silu gates round as XLA's do: ``mamba2.silu``); the shared block's
# FFN keeps ``F.silu``, as every dense FFN of the port (ROADMAP.md queue 3,
# "bf16 silu"; rounding it as XLA's moved these numbers by < 0.01).
HYBRID_LOGIT_TOL = 0.25
HYBRID_MARGIN_TOL = 2 * HYBRID_LOGIT_TOL
# Tolerances of the full-depth runs on the card (phase 19b), as RWKV_*'s:
# * the prefill's logits, kernels against the plain versions, and the
#   generation's against ``forward``'s: 0.75 (24 ulps at the top of the
#   logit range), a gross-error gate above the floor the 54-layer stack
#   sets with no kernel involved.  The stack amplifies any one-ulp bf16
#   difference (the shared block's attention spreads it over every
#   position and the next visit takes it up again): the two plain runs
#   that differ only in the SSD's chunk (64 and 32, a float32 summation
#   order) are printed beside the kernels' difference and held to it too;
#   on an H100 80GB HBM3 at 700 W the kernels read 0.4961 against the
#   plain run, the two plain runs 0.5010 apart, the generation 0.2402
#   from ``forward``;
# * each block alone (every Mamba block and every visit of the shared
#   block, fed the kernel run's input to it), kernels against the plain
#   versions: HYBRID_BLOCK_ULPS bf16 ulps of the block output's largest
#   value (the plain attention rounds its logits and probabilities to bf16
#   where the flash kernel keeps them in float32, phase 5's envelope; an
#   H100 read at most 1 ulp, the Mamba blocks' only kernel being rmsnorm).
HYBRID_PREFILL_TOL = 0.75
HYBRID_BLOCK_ULPS = 4
# The leaves whose first moment and updated values the training checks
# sample (layer 0 of the groups' stack): the embedding, a Mamba layer's
# input projection, conv kernel and dt_bias (float32, from zero), the
# shared block's concat projection and query projection, and ln_f.
HYBRID_TRAIN_LEAVES = ("embed.embedding", "groups.mamba.w_in.kernel", "groups.mamba.conv.kernel",
                       "groups.mamba.dt_bias", "shared.w_concat.kernel",
                       "shared.block.attn.wq.kernel", "ln_f.scale")
# What tests/test_torch_hybrid_train_reference.py runs through the JAX
# package on the CPU and what the card's run is held to (phase 20b): the
# zamba2 smoke config (4 layers: 2 groups of 2) in float32, 4 x 128 tokens
# (8 chunks of 16 a sequence) a step, 2 steps from ``random_lm_tree(cfg,
# TRAIN["seed"])``, the data seed, AdamW and the schedule of TRAIN (those
# of HYBRID).
HYBRID_TRAIN_REF = dict(dtype="float32", batch=4, seq_len=128, steps=2)
# Tolerances of HYBRID_TRAIN_REF against the JAX package, float32 (the
# port's plain versions on the CPU measured against it; the card's run,
# on the kernels, printed beside them): loss 2e-5 absolute, grad norm 2e-5
# relative, m 1e-3 of the leaf's largest sampled |m|, parameters 4 float32
# ulps plus 1e-3 lr per step where the moment is clear of zero, as
# MOE_REF_TOL argues.
HYBRID_REF_TOL = dict(loss=2e-5, grad_norm=2e-5, m=1e-3, grad_margin=4e-3, param_ulps=4,
                      update_frac=1e-3, ulp_bits=24)
# The JAX package's numbers for HYBRID_TRAIN_REF, on the CPU (jax 0.9.0),
# printed by ``python tests/test_torch_hybrid_train_reference.py``.
JAX_HYBRID_TRAIN = {'grad_norm': [27.380722045898438, 24.294818878173828],
 'loss': [6.790250778198242, 6.337066650390625],
 'm': [{'embed.embedding': [-0.0013578588841482997,
                            -2.8757931431755424e-05,
                            0.00016017263988032937,
                            0.00014639775326941162,
                            -0.0015660839853808284,
                            0.0,
                            0.0,
                            0.0,
                            0.0,
                            0.0,
                            0.0,
                            0.0,
                            -0.000173323875060305,
                            0.0,
                            0.0,
                            0.0],
        'groups.mamba.conv.kernel': [5.665608841809444e-05,
                                     -3.5875825687980978e-06,
                                     9.195207530865446e-05,
                                     -1.0628994459693786e-05,
                                     1.030706425808603e-05,
                                     -2.7656933525577188e-06,
                                     -3.080238457187079e-05,
                                     8.565044481656514e-06,
                                     1.354119012830779e-05,
                                     1.750967749103438e-05,
                                     4.029493356938474e-05,
                                     1.034218348650029e-05,
                                     -6.9448674366867635e-06,
                                     5.078168396721594e-05,
                                     4.633269054465927e-05,
                                     1.629314101592172e-05],
        'groups.mamba.dt_bias': [9.440971189178526e-05,
                                 -3.0410479666898027e-05,
                                 -0.000175952329300344,
                                 -5.934395085205324e-05,
                                 7.524566171923652e-05,
                                 -9.894780669128522e-05,
                                 -0.00012837011308874935,
                                 0.0001452136639272794],
        'groups.mamba.w_in.kernel': [3.076085340580903e-05,
                                     3.558229309419403e-06,
                                     -4.140352029935457e-05,
                                     7.684959200560115e-06,
                                     -1.9135868569719605e-05,
                                     9.723885341372807e-06,
                                     -0.0001342480245511979,
                                     -1.4014110092830379e-05,
                                     7.031315908534452e-05,
                                     2.5789771825657226e-05,
                                     -0.00014742462371941656,
                                     9.628290172258858e-06,
                                     -2.0341442450444447e-06,
                                     -7.052623004710767e-06,
                                     -6.669898084510351e-06,
                                     -4.7511737648164853e-05],
        'ln_f.scale': [-2.181893796660006e-05,
                       5.1163689931854606e-05,
                       -2.141422010026872e-05,
                       0.00011095929949078709,
                       4.0677077777218074e-05,
                       3.640031354734674e-05,
                       -2.7622443667496555e-05,
                       3.2174804800888523e-05,
                       6.049930743756704e-05,
                       3.949265737901442e-05,
                       3.998325701104477e-05,
                       2.4976861823233776e-05,
                       -3.016765185748227e-05,
                       1.1877235920110252e-05,
                       -5.77600212636753e-06,
                       6.507692887680605e-05],
        'shared.block.attn.wq.kernel': [-4.647579771699384e-06,
                                        4.248510776960757e-06,
                                        -1.6619984535282128e-06,
                                        -4.962530510965735e-06,
                                        6.2906105995352846e-06,
                                        1.7658912838669494e-06,
                                        -6.701038273604354e-06,
                                        -1.1673495237118914e-07,
                                        -7.04460774159088e-07,
                                        -6.691352609777823e-06,
                                        2.857044273696374e-05,
                                        3.469236389719299e-06,
                                        -6.847247277619317e-06,
                                        -2.6937243092106655e-05,
                                        -1.8911362076323712e-06,
                                        5.278449407342123e-06],
        'shared.w_concat.kernel': [-8.004752453416586e-05,
                                   -4.440670454641804e-05,
                                   -9.773531201062724e-05,
                                   3.065082125885965e-07,
                                   2.707500470933155e-06,
                                   -3.5283656529827567e-07,
                                   -9.849279791751542e-08,
                                   -6.429494305848493e-07,
                                   -2.1460137133999524e-07,
                                   1.1013457701380958e-08,
                                   -8.057026548158319e-07,
                                   5.1617177199148045e-09,
                                   -1.579256604600232e-06,
                                   5.986282189951453e-07,
                                   1.0524146318857674e-06,
                                   1.141551365435589e-06]},
       {'embed.embedding': [-0.0012220729840919375,
                            -6.214145287231077e-08,
                            0.0001677018590271473,
                            0.0002137310366379097,
                            -0.0014317758614197373,
                            0.0,
                            9.947988291969523e-05,
                            0.000815408886410296,
                            0.0,
                            0.0,
                            0.0,
                            0.0,
                            -0.0001559914817335084,
                            0.0,
                            0.0,
                            0.0],
        'groups.mamba.conv.kernel': [1.3292119547259063e-05,
                                     -9.439499262953177e-05,
                                     5.5184224038384855e-05,
                                     5.9403537306934595e-05,
                                     0.00014490169996861368,
                                     8.304291986860335e-05,
                                     -7.101257506292313e-05,
                                     -3.5312211821292294e-06,
                                     -5.625719131785445e-05,
                                     8.634589903522283e-05,
                                     5.6907276302808896e-05,
                                     5.1448158046696335e-05,
                                     4.822813571081497e-05,
                                     5.814517135149799e-05,
                                     0.00014603865565732121,
                                     1.9965407773270272e-05],
        'groups.mamba.dt_bias': [-0.0002602124586701393,
                                 -0.00020133053476456553,
                                 -3.8364974898286164e-05,
                                 -1.3595456039183773e-05,
                                 -2.283668982272502e-05,
                                 -0.00015004265878815204,
                                 -1.938659443112556e-05,
                                 3.2700081646908075e-05],
        'groups.mamba.w_in.kernel': [6.505107012344524e-05,
                                     -3.0058798074605875e-05,
                                     -0.00010600644600344822,
                                     -4.7955392801668495e-05,
                                     -1.6298665286740288e-05,
                                     1.735734986141324e-05,
                                     -0.0002494012878742069,
                                     -5.4869411542313173e-05,
                                     6.111770926509053e-05,
                                     -7.90301855886355e-05,
                                     2.129853965016082e-05,
                                     -2.6695659471442923e-05,
                                     -8.518736285623163e-05,
                                     -1.1165449905092828e-05,
                                     0.0001092114980565384,
                                     -4.0148432162823156e-05],
        'ln_f.scale': [2.208651312685106e-05,
                       4.878632171312347e-05,
                       6.013412348693237e-05,
                       0.00018908972560893744,
                       4.204145079711452e-05,
                       0.00010766853665700182,
                       1.6112177036120556e-05,
                       4.843567876378074e-05,
                       6.870321522001177e-05,
                       3.636515612015501e-05,
                       9.879772551357746e-05,
                       0.00011736181477317587,
                       -7.250791531987488e-05,
                       8.362387598026544e-05,
                       2.8361944714561105e-05,
                       0.00011492627527331933],
        'shared.block.attn.wq.kernel': [-9.928276085702237e-06,
                                        -9.634398338675965e-06,
                                        -2.649363705131691e-05,
                                        -1.5545276255579665e-05,
                                        1.0753145716080326e-06,
                                        7.137938382584252e-07,
                                        -5.645578085022862e-07,
                                        -1.9936009266530164e-05,
                                        1.4504072169074789e-05,
                                        -1.0486935025255661e-05,
                                        3.284586637164466e-05,
                                        6.928494258318096e-06,
                                        -1.3906568710808642e-05,
                                        -1.966672789421864e-05,
                                        -1.2973040611541364e-05,
                                        4.045476998726372e-06],
        'shared.w_concat.kernel': [-7.735176041023806e-05,
                                   -9.96033995761536e-05,
                                   -7.125709089450538e-05,
                                   8.149681889335625e-07,
                                   4.076146979059558e-06,
                                   -2.6070449621329317e-06,
                                   2.1999780130954605e-07,
                                   -1.3009859003432211e-06,
                                   5.868758421456732e-07,
                                   -6.46448995667015e-07,
                                   -2.075690019864851e-07,
                                   1.3110180816511274e-06,
                                   -1.2822858934669057e-06,
                                   3.846593017442501e-07,
                                   1.9886902009602636e-06,
                                   1.2941018212586641e-06]}],
 'params': {'embed.embedding': [0.0416705459356308,
                                -0.002194146392866969,
                                -0.019654978066682816,
                                0.036699388176202774,
                                0.008060083724558353,
                                0.0017371743451803923,
                                -0.00895601324737072,
                                -0.01886209100484848,
                                0.035673391073942184,
                                0.02475750260055065,
                                -0.021736549213528633,
                                0.0026698315050452948,
                                -0.0011612437665462494,
                                0.0075742704793810844,
                                0.017404036596417427,
                                0.01551321242004633],
            'groups.mamba.conv.kernel': [0.029688239097595215,
                                         -0.5005592107772827,
                                         -0.06863521039485931,
                                         -0.4862769842147827,
                                         0.4723551869392395,
                                         -0.44190385937690735,
                                         -0.28729042410850525,
                                         -0.25000709295272827,
                                         0.24014121294021606,
                                         -0.06210470572113991,
                                         0.40678873658180237,
                                         -0.6014360189437866,
                                         0.07986295223236084,
                                         0.2896691858768463,
                                         0.20152512192726135,
                                         0.3833276331424713],
            'groups.mamba.dt_bias': [-0.0004645430890377611,
                                     0.0018383676651865244,
                                     0.0011346080573275685,
                                     0.0011421784292906523,
                                     -0.0008558578556403518,
                                     0.0019662813283503056,
                                     0.0010901883943006396,
                                     -0.0011394994799047709],
            'groups.mamba.w_in.kernel': [0.11194170266389847,
                                         -0.007394945714622736,
                                         0.012196538038551807,
                                         -0.030912086367607117,
                                         0.06187286227941513,
                                         0.17474515736103058,
                                         -0.10753635317087173,
                                         0.02802588976919651,
                                         0.05386549234390259,
                                         -0.16788767278194427,
                                         -0.17581576108932495,
                                         0.07988035678863525,
                                         -0.034418728202581406,
                                         0.09536229819059372,
                                         -0.04782582446932793,
                                         0.11237286031246185],
            'ln_f.scale': [1.0006532669067383,
                           0.9982820749282837,
                           1.0004616975784302,
                           0.9980087876319885,
                           0.9982278943061829,
                           0.9980453252792358,
                           1.000758409500122,
                           0.9980357885360718,
                           0.9981676936149597,
                           0.9983058571815491,
                           0.9980177283287048,
                           0.9981194734573364,
                           1.001985788345337,
                           0.9981678128242493,
                           1.0003873109817505,
                           0.9980045557022095],
            'shared.block.attn.wq.kernel': [-0.04041193425655365,
                                            0.00885764416307211,
                                            -0.1749647706747055,
                                            0.0014680804451927543,
                                            -0.1503271758556366,
                                            0.03943392261862755,
                                            -0.14656829833984375,
                                            -0.13084201514720917,
                                            -0.011987914331257343,
                                            0.020365530624985695,
                                            -0.02396952174603939,
                                            -0.12829597294330597,
                                            -0.08799172937870026,
                                            0.06267300248146057,
                                            0.05224623158574104,
                                            0.05995561182498932],
            'shared.w_concat.kernel': [0.12670184671878815,
                                       0.10104726254940033,
                                       -0.0732581838965416,
                                       0.024215662851929665,
                                       -0.06732243299484253,
                                       0.041396137326955795,
                                       -0.07522846758365631,
                                       -0.012588836252689362,
                                       0.10180063545703888,
                                       0.02000991813838482,
                                       0.006537476554512978,
                                       -0.0077431038953363895,
                                       0.043248336762189865,
                                       0.006725300569087267,
                                       -0.028955677524209023,
                                       0.013662661425769329]}}


def hybrid_launches(cfg) -> dict:
    """The kernel launches of the ``hybrid`` config ``cfg``: a prefill (or
    one decode call: flash 0) runs each Mamba block's ``ln`` and
    ``out_norm``, each shared visit's ``ln1`` and ``ln2`` and the flash
    forward, and ``ln_f``; a ``build_train_step`` step with
    ``remat="block"`` runs the forward's and, from the backward, each
    group's recompute (every norm but ``ln_f`` and every flash forward
    again), and the flash backward once a visit."""
    groups = cfg.n_layers // cfg.hybrid.shared_every
    norms = 2 * cfg.n_layers + 2 * groups
    return {"prefill": {"rmsnorm": norms + 1, "flash_attention_fwd": groups},
            "train": {"flash_attention_fwd": 2 * groups, "flash_attention_bwd_dkv": groups,
                      "flash_attention_bwd_dq": groups, "rmsnorm": 2 * norms + 1}}


def hybrid_train_config():
    """HYBRID_TRAIN_REF's config: the zamba2 smoke config in float32."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(HYBRID["arch"]), dtype=HYBRID_TRAIN_REF["dtype"])


def port_hybrid_train_reference(cfg, dev, ref: dict = HYBRID_TRAIN_REF) -> dict:
    """``ref``'s steps of ``cfg`` through the port on ``dev`` from
    ``random_lm_tree(cfg, TRAIN["seed"])`` (``port_train_reference``)."""
    from repro_torch import convert

    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, TRAIN["seed"]), cfg,
                                         device=dev)
    return port_train_reference(model, cfg, dev, ref, HYBRID_TRAIN_LEAVES)


def _hybrid_flash_cost(q, dk: int) -> dict:
    """Bytes and product operations of the flash forward and backward at
    ``q``'s head dim (the model's work) and those the kernels do on head
    dim ``dk`` (zero-padded): ``{"fwd", "dkv", "dq"}`` of ``(bytes, ops,
    padded ops)``."""
    import torch

    qp = torch.empty(q.shape[:-1] + (dk,), dtype=q.dtype, device="meta")
    nbytes, nops = _flash_bytes_ops(q, q, True)
    bwd, bwd_pad = _flash_bwd_bytes_ops(q, q, True), _flash_bwd_tc_ops(qp, qp, True)
    return {"fwd": (nbytes, nops, _flash_bytes_ops(qp, qp, True)[1]),
            **{k: (*bwd[k], bwd_pad[k]) for k in ("dkv", "dq")}}


def phase_hybrid_kernels(dev) -> dict:
    """19a: flash forward and backward at zamba2's shared block (q, k, v (4,
    32, 512, 80), causal, bf16: the kernels run head dim 80 zero-padded to
    ``kernel_head_dim(80)`` = 128, the backward on the tensor-core route),
    held as phase 5 and phase 7 hold them: the forward within one bf16 ulp
    of the float32 plain version (1e-5 on lse) and 2e-2 of the bf16 one;
    the backward through ``FlashAttention`` against the plain backward on
    the same residuals (one bf16 ulp plus 1e-5 of the scale) and autograd
    through the plain attention (2^-7 of the element and of the scale).
    Each is timed beside its plain version and the library's
    (``F.scaled_dot_product_attention``, which takes 80 natively; its
    backward through autograd), with the bound of the model's work at 80
    and of the padded work the kernels do (the tensor-core backward's
    three-part products counted).  rmsnorm at zamba2's widths is timed in
    phase 5 (RMSNORM_SHAPES)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import full_config
    from repro_torch.kernels import flash_attention as fa, ref

    cfg = full_config(HYBRID["arch"])
    h = cfg.hybrid.shared_block_heads
    d = cfg.d_model // h
    b, t = HYBRID["prefill"]
    dk = fa.kernel_head_dim(d)
    gen = torch.Generator(device=dev).manual_seed(19)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v, do = (randn(b, h, t, d).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = _fa_kernel(q, k, v, True)
    o_p, lse_p = ref.attention(q, k, v, causal=True, with_lse=True)
    o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=True, with_lse=True)
    torch.cuda.synchronize()
    dev_o = (o.double() - o_w.double()).abs()
    err = max(_max_err(o, o_p), _max_err(lse, lse_p))
    ok = (tuple(o.shape) == (b, h, t, d) and err <= 2e-2
          and bool((dev_o <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
          and _max_err(lse, lse_w) <= 1e-5)
    print(f"flash fwd   head dim {d} (padded to {dk}) q {tuple(q.shape)} bf16: max|kernel - plain| "
          f"o {_max_err(o, o_p):.3e} lse {_max_err(lse, lse_p):.3e}; vs float32 plain o "
          f"{float(dev_o.max()):.3e} lse {_max_err(lse, lse_w):.3e}")
    _check(ok, f"flash forward head dim {d} vs plain")
    cost = _hybrid_flash_cost(q, dk)
    bound = lambda c, padded=False: max(
        c[0] / HBM_BYTES_PER_S, (c[2] if padded else c[1]) / BF16_FLOP_PER_S) * 1e3
    by = lambda c: "bytes" if c[0] / HBM_BYTES_PER_S >= c[1] / BF16_FLOP_PER_S else "operations"
    fwd = dict(hd80_shape=list(q.shape), hd80_kernel_head_dim=dk,
               hd80_ms=_median_ms(lambda: _fa_kernel(q, k, v, True)),
               hd80_plain_ms=_median_ms(lambda: ref.attention(q, k, v, causal=True,
                                                              with_lse=True)),
               hd80_library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               hd80_bound_ms=bound(cost["fwd"]), hd80_bound_by=by(cost["fwd"]),
               hd80_bound_padded_ms=bound(cost["fwd"], True), hd80_max_abs_err=err)
    print(f"flash fwd   head dim {d} bf16: kernel {fwd['hd80_ms']:.4f} ms, plain "
          f"{fwd['hd80_plain_ms']:.4f} ms, F.scaled_dot_product_attention "
          f"{fwd['hd80_library_ms']:.4f} ms; bound {fwd['hd80_bound_ms']:.4f} ms "
          f"({fwd['hd80_bound_by']}), {fwd['hd80_bound_padded_ms']:.4f} ms for the work at {dk}")

    by_route = lambda: [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    before = by_route()
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.FlashAttention.apply(ql, kl, vl, True, None), (ql, kl, vl), do)
    took = {r for b_, a_ in zip(before, by_route()) for r in a_ if a_[r] != b_[r]}
    _check(took == {"tensor cores"}, f"flash backward head dim {d}: routes {took}")
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
    qw, kw, vw = (x.float().requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(ref.attention(qw, kw, vw, causal=True, scale=scale), (qw, kw, vw),
                               do.float())
    torch.cuda.synchronize()
    line, ok, berr = f"flash bwd   head dim {d} q {tuple(q.shape)} bf16 [tensor cores]:", True, 0.0
    for nm, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
        g64, p64, a64 = g.double(), p.double(), a.double()
        sc = float(p64.abs().max())
        ok &= tuple(g.shape) == tuple(p.shape) and bool(
            ((g64 - p64).abs() <= 2.0**-7 * p64.abs() + 1e-5 * sc).all())
        ok &= bool(((g64 - a64).abs() <= 2.0**-7 * a64.abs() + 2.0**-7 * sc).all())
        line += (f" {nm} {float((g64 - p64).abs().max()):.3e}/"
                 f"{float((g64 - a64).abs().max()):.3e} (max {sc:.3f})")
        berr = max(berr, float((g64 - p64).abs().max()))
    print(line + "  [kernel - plain backward / - autograd of plain attention]")
    _check(ok, f"flash backward head dim {d} vs plain")
    pad = lambda x: F.pad(x, (0, dk - d))
    qp, kp, vp, dop, op = map(pad, (q, k, v, do, o))
    lse_c, delta = lse.contiguous(), torch.sum(dop.float() * op.float(), dim=-1)
    dkv_ms = _median_ms(lambda: fa.flash_bwd_dkv(qp, kp, vp, dop, lse_c, delta, causal=True,
                                                 scale=scale))
    dq_ms = _median_ms(lambda: fa.flash_bwd_dq(qp, kp, vp, dop, lse_c, delta, causal=True,
                                               scale=scale))
    plain_ms = _median_ms(lambda: ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                                          scale=scale))
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_ms = _median_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
    rows = {"flash_attention_fwd": fwd}
    for key, which, ms in (("dkv", "flash_attention_bwd_dkv", dkv_ms),
                           ("dq", "flash_attention_bwd_dq", dq_ms)):
        c = cost[key]
        rows[which] = dict(hd80_shape=list(q.shape), hd80_route="tensor cores", hd80_ms=ms,
                           hd80_plain_ms=plain_ms, hd80_library_ms=lib_ms,
                           hd80_bound_ms=bound(c), hd80_bound_by=by(c),
                           hd80_bound_padded_ms=bound(c, True), hd80_max_abs_err=berr)
    print(f"flash bwd   head dim {d} bf16 [tensor cores at {dk}]: dK/dV {dkv_ms:.4f} ms (bound "
          f"{rows['flash_attention_bwd_dkv']['hd80_bound_ms']:.4f}, padded work "
          f"{rows['flash_attention_bwd_dkv']['hd80_bound_padded_ms']:.4f}), dQ {dq_ms:.4f} ms "
          f"(bound {rows['flash_attention_bwd_dq']['hd80_bound_ms']:.4f}, padded "
          f"{rows['flash_attention_bwd_dq']['hd80_bound_padded_ms']:.4f}); plain backward "
          f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms")
    return rows


@contextlib.contextmanager
def ssd_chunk(model, chunk: int):
    """Run every Mamba block of ``model`` with the SSD chunk ``chunk``
    inside the block (its float32 summation order; the result is the same
    function)."""
    import dataclasses

    mods = [blk.mamba for group in model.groups for blk in group]
    old = mods[0].cfg
    new = dataclasses.replace(old, ssm=dataclasses.replace(old.ssm, chunk=chunk))
    for m in mods:
        m.cfg = new
    try:
        yield
    finally:
        for m in mods:
            m.cfg = old


def _hybrid_blocks_alone(model, run) -> dict:
    """Each Mamba block and each visit of the shared block of ``model``,
    fed its input in ``run()`` (the prefill on the kernels), once more on
    the kernels and on the plain versions: the largest difference of each
    in bf16 ulps of its output's largest value, ``{"mamba": [...],
    "shared": [...]}``."""
    import torch

    from repro_torch.kernels import ops

    inputs = {"mamba": [], "shared": []}
    hooks = [blk.register_forward_pre_hook(
        lambda m, a: inputs["mamba"].append((m, a[0].clone())))
        for group in model.groups for blk in group]
    hooks.append(model.shared.register_forward_pre_hook(
        lambda m, a: inputs["shared"].append((m, tuple(t.clone() for t in a[:3])))))
    run()
    for hk in hooks:
        hk.remove()
    out = {"mamba": [], "shared": []}
    with torch.inference_mode():
        for kind, calls in inputs.items():
            for m, args in calls:
                args = args if kind == "shared" else (args,)
                yk = m(*args)[0]
                with ops.forced("ref"):
                    yp = m(*args)[0]
                out[kind].append(_max_err(yk, yp) / _bf16_ulp(float(yp.abs().max())))
    return out


def _hybrid_model(dev):
    """zamba2-2.7b at full width and depth, drawn on the card."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.models import transformer as T

    cfg = full_config(HYBRID["arch"])
    _check(cfg.family == "hybrid" and cfg.dtype == "bfloat16" and cfg.remat == "block",
           "zamba2-2.7b serves and trains in bf16 with remat")
    t0 = time.perf_counter()
    model = T.init(cfg, device=dev, generator=torch.Generator(dev).manual_seed(HYBRID["seed"]))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    print(f"hybrid: {cfg.name} {n} parameters ({gib:.2f} GiB; {cfg.n_layers} Mamba2 layers in "
          f"{len(model.groups)} groups, one shared block of {cfg.hybrid.shared_block_heads} heads "
          f"of {cfg.d_model // cfg.hybrid.shared_block_heads}) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def phase_hybrid_serve(dev, model, profile_dir: Path | None = None) -> dict:
    """19b: ``model`` (zamba2-2.7b, ``_hybrid_model``) served.  (a) The
    prefill step on 4 x 512 tokens: launches, wall, peak memory, and every
    logit against the same step on the plain versions
    (``ops.forced("ref")``) within HYBRID_PREFILL_TOL, beside the plain run
    with another SSD chunk (``ssd_chunk``: the floor with no kernel), and
    each block alone against its plain run within HYBRID_BLOCK_ULPS
    (``_hybrid_blocks_alone``).  (b) Greedy generation 4 x (64 + 32):
    launches, tokens/s, its logits against ``forward``'s within
    HYBRID_PREFILL_TOL and its tokens the forward's argmax where the top-2
    margin exceeds twice their largest difference.  (c) HYBRID_SERVE_REF at full
    width cut to 12 layers (weights ``random_lm_leaves``) against
    JAX_HYBRID_SERVE."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, build_prefill_step

    t_phase = time.perf_counter()
    cfg = model.cfg
    per_call = hybrid_launches(cfg)["prefill"]

    # (a) Prefill: 4 prompts x 512 tokens through the prefill step.
    b, tl = HYBRID["prefill"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl, HYBRID["prompt_seed"]),
                              device=dev)
    step = build_prefill_step(cfg)
    step(model, prompts, tl)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t = time.perf_counter()
    logits, state = step(model, prompts, tl)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with ops.forced("ref"):
        logits_ref, _ = step(model, prompts, tl)
        with ssd_chunk(model, cfg.ssm.chunk // 2):
            logits_half, _ = step(model, prompts, tl)
    torch.cuda.synchronize()
    err = _max_err(logits, logits_ref)
    floor_err = _max_err(logits_half, logits_ref)
    print(f"hybrid prefill {b} x {tl}: {prefill_s:.4f} s wall, {b * tl / prefill_s:.0f} tokens/s, "
          f"peak {peak:.2f} GiB allocated, launches {prefill_counts}; logits max|kernels - plain| "
          f"{err:.4f}, max|plain (SSD chunk {cfg.ssm.chunk // 2}) - plain| {floor_err:.4f} (no "
          f"kernel involved; max|logit| {float(logits_ref.abs().max()):.3f})")
    del logits_half
    ulps = _hybrid_blocks_alone(model, lambda: step(model, prompts, tl))
    print(f"hybrid blocks alone, max|kernels - plain| in bf16 ulps of the block output's largest "
          f"value: Mamba blocks 0-{len(ulps['mamba']) - 1} "
          f"{[f'{u:g}' for u in ulps['mamba']]}; shared visits {[f'{u:g}' for u in ulps['shared']]}")
    _check(max(ulps["mamba"] + ulps["shared"]) <= HYBRID_BLOCK_ULPS,
           "hybrid blocks alone, kernels vs plain versions")
    _check(prefill_counts == per_call, f"hybrid prefill launches {prefill_counts}, want {per_call}")
    g, sh = state["groups"], state["shared"]
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and g.length == sh.length == tl and bool(torch.isfinite(g.ssm).all()),
           "hybrid prefill logits/state")
    _check(err <= HYBRID_PREFILL_TOL and floor_err <= HYBRID_PREFILL_TOL,
           "hybrid prefill logits, kernels vs plain versions")
    del logits, logits_ref, state, g, sh
    torch.cuda.empty_cache()

    # (b) Generation: 4 requests, 64-token prompts, 32 greedy tokens.
    b, t0p = HYBRID["gen"]
    n = HYBRID["gen_tokens"]
    gprompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t0p, HYBRID["prompt_seed"] + 1),
                               device=dev)
    eng = ServeEngine(cfg, model, max_len=t0p + n, device=dev)
    eng.generate(gprompts, 2)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    out = eng.generate(gprompts, n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_counts = _counts()
    with torch.inference_mode():
        fwd = T.forward(model, out[:, :-1]).logits[:, t0p - 1:]
    gen_logits = decode_logits(model, cfg, gprompts, out[:, t0p:], t0p + n)
    gen_err = _max_err(gen_logits, fwd)
    own = torch.equal(gen_logits.argmax(-1), out[:, t0p:])
    margin = torch.as_tensor(_top2_margin(fwd.cpu().numpy()))
    agree = fwd.argmax(-1).cpu() == out[:, t0p:].cpu()
    # With every logit within gen_err of forward's, a greedy token can
    # differ from forward's argmax only where forward's top-2 margin is
    # within 2 gen_err.
    sure = margin > 2 * gen_err
    worst = float(margin[~agree].max()) if bool((~agree).any()) else 0.0
    print(f"hybrid generate {b} x ({t0p} + {n}): {gen_s:.4f} s wall, {b * n / gen_s:.1f} "
          f"tokens/s, launches {gen_counts}; greedy tokens == the argmax of their logits: {own}; "
          f"logits max|generation - forward| {gen_err:.4f}; greedy == forward argmax at "
          f"{int(agree.sum())}/{agree.numel()} positions (largest margin where not {worst:.4f}), "
          f"{int(sure.sum())} with a top-2 margin > 2 x {gen_err:.4f}")
    _check(gen_counts == {"rmsnorm": per_call["rmsnorm"] * n, "flash_attention_fwd": 0},
           f"hybrid generation launches {gen_counts}")
    _check(own, "hybrid greedy tokens differ from their logits' argmax")
    _check(gen_err <= HYBRID_PREFILL_TOL, "hybrid generation logits vs forward")
    _check(bool(sure.any()) and bool(agree[sure].all()),
           "hybrid greedy tokens differ from the forward argmax")
    if profile_dir is not None:
        profile_run("hybrid_prefill", lambda: _timed(lambda: step(model, prompts, tl)),
                    profile_dir)
        profile_run("hybrid_generate", lambda: _timed(lambda: eng.generate(gprompts, n)),
                    profile_dir)
    del eng, fwd, gen_logits
    torch.cuda.empty_cache()

    # (c) HYBRID_SERVE_REF: full width at 12 layers against the JAX package.
    cfg12 = dataclasses.replace(cfg, n_layers=HYBRID_SERVE_REF["n_layers"])
    t = time.perf_counter()
    model12 = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg12, HYBRID["seed"]),
                                            cfg12, device=dev)
    print(f"hybrid vs JAX: random_lm_leaves of {cfg12.n_layers} layers moved to the card in "
          f"{time.perf_counter() - t:.1f} s")
    got = port_serve_reference(model12, cfg12, dev, JAX_HYBRID_SERVE["tokens"], HYBRID_SERVE_REF)
    del model12
    torch.cuda.empty_cache()
    bad, skipped = compare_serve(got, JAX_HYBRID_SERVE, HYBRID_LOGIT_TOL, HYBRID_MARGIN_TOL)
    print(f"hybrid vs JAX ({cfg12.n_layers} layers): prefill rows and teacher-forced steps "
          f"max|diff| {serve_max_diff(got, JAX_HYBRID_SERVE):.4f} (tolerance {HYBRID_LOGIT_TOL}); "
          f"row argmax {[g['argmax'] for g in got['rows']]} vs "
          f"{[w['argmax'] for w in JAX_HYBRID_SERVE['rows']]}; tokens {got['tokens']} vs "
          f"{JAX_HYBRID_SERVE['tokens']}; {skipped} tokens past a top-2 margin <= "
          f"{HYBRID_MARGIN_TOL} not compared")
    _check(not bad, "hybrid serving differs from the JAX package: " + "; ".join(bad[:10]))
    wall = time.perf_counter() - t_phase
    print(f"hybrid serve: phase {wall:.1f} s")
    return {"prefill": prefill_counts, "generate": gen_counts, "prefill_s": prefill_s,
            "prefill_tokens_per_s": b * tl / prefill_s, "generate_s": gen_s,
            "tokens_per_s": b * n / gen_s, "peak_gib": peak, "phase_s": wall}


def phase_hybrid_train(dev, model, profile_dir: Path | None = None) -> dict:
    """20a: ``model`` (zamba2-2.7b at full width and depth, bf16) trained
    with ``build_train_step``, ``remat="block"`` (one checkpoint a group)
    and AdamW's float32 moments.  Step 1 on the plain versions, then from
    the same start (a copy of the parameters on the card) the same step on
    the kernels, held to it under TRAIN_TOL on HYBRID_TRAIN_LEAVES; the
    kernel step once more from the same start, whose parameters and first
    moment must equal the first kernel run's bit for bit (``_bit_prints``);
    then two more kernel steps, timed.  Every kernel step must launch
    ``hybrid_launches(cfg)["train"]``, the backward on the tensor-core
    route only; the plain step none.  ``train_mfu`` counts 6
    ``cfg.param_count()`` tokens a step."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step

    t_phase = time.perf_counter()
    cfg, tr = model.cfg, HYBRID
    b, t = tr["batch"], tr["seq_len"]
    opt = AdamWConfig(lr=tr["lr"])
    step = build_train_step(cfg, opt, total_steps=tr["total_steps"],
                            warmup_steps=tr["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=b, seq_len=t,
                                       vocab_size=cfg.vocab_size))
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    start = {n: p.detach().clone() for n, p in params.items()}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])

    per_step = hybrid_launches(cfg)["train"]
    none = dict.fromkeys(per_step, 0)
    batch0 = ds.batch_at(0)

    # (1) Step 1 on the plain versions.
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.forced("ref"):
        _, st, mp = step(model, adamw_init(params, opt), batch0, 0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(_train_counts() == none, f"hybrid train plain step launched {_train_counts()}")
    want = _step_summary(model, st, mp, HYBRID_TRAIN_LEAVES)
    del st, mp
    restore()

    # (2) The same step on the kernels, (3) once more, (4) two more steps.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts, routes = [], [], []

    def kernel_step(i, state):
        _reset_train_counts()
        before = [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step(model, state, ds.batch_at(i), i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(_train_counts())
        routes.append({r for f, b_ in zip((fa.flash_bwd_dkv, fa.flash_bwd_dq), before)
                       for r in f.route_launches if f.route_launches[r] != b_[r]})
        return state, metrics

    state, mk = kernel_step(0, adamw_init(params, opt))
    got = _step_summary(model, state, mk, HYBRID_TRAIN_LEAVES)
    prints = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    del state, mk
    restore()
    state, mk = kernel_step(0, adamw_init(params, opt))
    again = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    differ = sorted(n for n in prints if prints[n] != again[n])
    del start
    losses = [float(mk["loss"])]
    for i in range(1, tr["steps"]):
        state, mk = kernel_step(i, state)
        losses.append(float(mk["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    bad = compare_train(got, want, tr["lr"], TRAIN_TOL, HYBRID_TRAIN_LEAVES)
    step_s = walls[-1]
    tokens = b * t
    mfu = 6.0 * cfg.param_count() * tokens / (step_s * BF16_FLOP_PER_S)
    print(f"hybrid train {cfg.name} {cfg.n_layers} layers, {n_params} parameters (bf16, "
          f"remat={cfg.remat} a group, AdamW float32 moments), {b} x {t} tokens: plain step "
          f"{plain_s:.3f} s, kernel step walls {[round(w, 4) for w in walls]} s (two step-1 runs, "
          f"then steps 2-{tr['steps']}), losses {losses}, launches a step {counts[-1]}, backward "
          f"routes {sorted(set().union(*routes))}, peak {peak:.2f} GiB allocated")
    print("hybrid train step 1, kernels vs plain versions: "
          + json.dumps(train_max_diff(got, want, tr["lr"], TRAIN_TOL, HYBRID_TRAIN_LEAVES)))
    print("hybrid train step 1 twice on the kernels from the same start: "
          + ("the same bits (parameters and first moment)" if not differ else
             f"{len(differ)} leaves differ: {differ[:12]}"))
    print(f"hybrid train warm step {step_s:.4f} s, {tokens / step_s:.1f} tokens/s, train_mfu "
          f"{mfu:.4f} (6 N tokens / (step time x 989 TFLOP/s), N = param_count() "
          f"{cfg.param_count()}; remat executes ~8 N)")
    _check(all(c == per_step for c in counts), f"hybrid train launches {counts}, want {per_step}")
    _check(all(r == {"tensor cores"} for r in routes), f"hybrid train backward routes {routes}")
    _check(all(map(math.isfinite, losses)), f"hybrid train losses {losses}")
    _check(not bad, "hybrid train step 1, kernels vs plain versions: " + "; ".join(bad[:10]))
    _check(not differ, f"hybrid train step 1 twice on the kernels: {differ[:12]} differ")
    if profile_dir is not None:
        bp = ds.batch_at(tr["steps"])
        profile_run("hybrid_train_step",
                    lambda: _timed(lambda: step(model, state, bp, tr["steps"])), profile_dir)
    del state, mk
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"hybrid train: phase {wall:.1f} s")
    return {"counts": {k: sum(c[k] for c in counts) for k in per_step}, "per_step": per_step,
            "walls": walls, "step_s": step_s, "tokens_per_s": tokens / step_s, "train_mfu": mfu,
            "peak_gib": peak, "plain_step_s": plain_s, "same_bits": not differ, "phase_s": wall}


def phase_hybrid_train_reference(dev) -> dict:
    """20b: HYBRID_TRAIN_REF's two steps of the zamba2 smoke config
    (float32, 2 groups of 2 Mamba blocks) on the kernels (flash at head
    dim 32 on the FP32-FMA route, rmsnorm; ``hybrid_launches`` a step)
    against JAX_HYBRID_TRAIN under HYBRID_REF_TOL."""
    cfg = hybrid_train_config()
    _reset_train_counts()
    got = port_hybrid_train_reference(cfg, dev)
    counts = _train_counts()
    per = {k: v * HYBRID_TRAIN_REF["steps"] for k, v in hybrid_launches(cfg)["train"].items()}
    bad = compare_train(got, JAX_HYBRID_TRAIN, TRAIN["lr"], HYBRID_REF_TOL, HYBRID_TRAIN_LEAVES)
    print(f"hybrid train vs JAX smoke (float32, {cfg.n_layers} layers, "
          f"{HYBRID_TRAIN_REF['steps']} steps of {HYBRID_TRAIN_REF['batch']} x "
          f"{HYBRID_TRAIN_REF['seq_len']}): losses {got['loss']} vs {JAX_HYBRID_TRAIN['loss']}; "
          f"largest differences " + json.dumps(train_max_diff(
              got, JAX_HYBRID_TRAIN, TRAIN["lr"], HYBRID_REF_TOL, HYBRID_TRAIN_LEAVES))
          + f"; launches {counts}")
    _check(counts == per, f"hybrid train reference launches {counts}, want {per}")
    _check(not bad, "hybrid training differs from the JAX package: " + "; ".join(bad[:10]))
    return {"counts": counts}


# The audio slice (phase 21): whisper-large-v3 at its published width and
# full depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads of
# 64 (kv 20), d_ff 5120, vocab 51866 padded to 51968, 1500 encoder frames,
# bf16; 1.643 B parameters, of which ``dec_pos`` (32832 x 1280) is 42 M),
# weights drawn on the card by ``encdec.init`` from ``seed``, the stub
# frontend's frames drawn as the reference loop draws them
# (``train.loop.audio_frames``: numpy's normal at 0.02, seed
# ``frame_seed`` for serving, the step index for training).  Served
# (prefill 4 x 64 with 1500 frames a request; generation 4 requests,
# 64-token prompts, 32 greedy tokens) and trained (``remat="block"``: one
# checkpoint an encoder and a decoder block; AdamW(lr=1e-3) with its
# float32 moments and weight decay 0.1; 4 x 512 tokens and 4 x 1500 frames
# a step, the schedule warmed up in one step as TRAIN's; ``train()`` with
# the launcher's PowerSim for ``power_steps`` steps).  Nothing is cut.
WHISPER = dict(arch="whisper_large_v3", seed=0, prompt_seed=1, frame_seed=2, prefill=(4, 64),
               gen=(4, 64), gen_tokens=32, batch=4, seq_len=512, lr=1e-3, total_steps=10,
               warmup_steps=1, steps=3, power_steps=4)
# What tests/test_torch_encdec_serve_reference.py runs through the JAX
# package on the CPU and what the card's run is held to: SERVE_REF's
# prefill rows, 8 greedy tokens and the teacher-forced decode logits, with
# the 1500 frames of ``frame_seed`` a request, at full width cut to 2
# encoder and 2 decoder layers (the full-width tree in float32 is ~2 GB
# with ``dec_pos``, the embedding and the head; the cut keeps the JAX run
# on the CPU near a minute).
WHISPER_SERVE_REF = dict(SERVE_REF, n_layers=2, encoder_layers=2,
                         prompt_seed=WHISPER["prompt_seed"], frame_seed=WHISPER["frame_seed"])
# The JAX package's numbers for WHISPER_SERVE_REF (bf16, weights
# ``random_lm_tree(cfg, WHISPER["seed"])``, the frames of ``frame_seed``), on
# the CPU (jax 0.9.0), printed by
# ``python tests/test_torch_encdec_serve_reference.py``.
JAX_WHISPER_SERVE = {'rows': [{'argmax': 19815,
           'at_ids': [0.396484375, -1.0234375, 0.462890625, 0.04296875, 0.24609375, -1.21875,
                      0.0751953125],
           'lse': 11.325138237893409,
           'margin': 0.09375,
           'max': 3.96875},
          {'argmax': 45375,
           'at_ids': [0.53515625, 0.796875, -1.1796875, -0.0247802734375, 0.365234375, -1.25,
                      1.09375],
           'lse': 11.315253879054604,
           'margin': 0.203125,
           'max': 3.796875},
          {'argmax': 26225,
           'at_ids': [0.97265625, 0.4609375, -0.83984375, -0.1103515625, 0.66015625, -1.25,
                      0.98828125],
           'lse': 11.313870349563455,
           'margin': 0.21875,
           'max': 3.734375},
          {'argmax': 10446,
           'at_ids': [0.33203125, 0.515625, -0.43359375, -0.1318359375, 0.021484375, -1.1875,
                      1.15625],
           'lse': 11.313345662909574,
           'margin': 0.046875,
           'max': 3.703125},
          {'argmax': 26225,
           'at_ids': [0.49609375, 0.435546875, -0.8359375, -0.2451171875, 0.455078125, -1.59375,
                      1.171875],
           'lse': 11.310558865766254,
           'margin': 0.015625,
           'max': 3.5625}],
 'steps': [[{'argmax': 26225,
             'at_fed': 3.734375,
             'at_ids': [0.96875, 0.46484375, -0.84765625, -0.10107421875, 0.65234375, -1.25,
                        0.9921875],
             'lse': 11.313807757048366,
             'margin': 0.21875,
             'max': 3.734375},
            {'argmax': 26225,
             'at_fed': 3.71875,
             'at_ids': [0.7109375, 0.52734375, -1.0546875, -0.228515625, 0.6171875, -1.1875,
                        1.1171875],
             'lse': 11.313042918503609,
             'margin': 0.296875,
             'max': 3.71875},
            {'argmax': 26225,
             'at_fed': 3.875,
             'at_ids': [0.6015625, 0.53515625, -0.875, -0.12255859375, 0.7734375, -1.3359375,
                        1.15625],
             'lse': 11.313316162838053,
             'margin': 0.34375,
             'max': 3.875},
            {'argmax': 26225,
             'at_fed': 3.796875,
             'at_ids': [0.60546875, 0.4140625, -0.9765625, -0.087890625, 0.6171875, -1.296875,
                        1.1328125],
             'lse': 11.313312108206823,
             'margin': 0.296875,
             'max': 3.796875},
            {'argmax': 26225,
             'at_fed': 3.78125,
             'at_ids': [0.6796875, 0.5703125, -0.9375, -0.1318359375, 0.6875, -1.15625, 1.1015625],
             'lse': 11.313093249062675,
             'margin': 0.34375,
             'max': 3.78125},
            {'argmax': 26225,
             'at_fed': 3.78125,
             'at_ids': [0.703125, 0.419921875, -0.8046875, -0.10693359375, 0.72265625, -1.1796875,
                        1.1953125],
             'lse': 11.312959648975074,
             'margin': 0.34375,
             'max': 3.78125},
            {'argmax': 26225,
             'at_fed': 3.84375,
             'at_ids': [0.625, 0.478515625, -1.0703125, -0.1259765625, 0.7421875, -1.1875,
                        1.0546875],
             'lse': 11.312787391970927,
             'margin': 0.359375,
             'max': 3.84375},
            {'argmax': 26225,
             'at_fed': 3.71875,
             'at_ids': [0.59765625, 0.578125, -0.9921875, -0.0181884765625, 0.609375, -1.203125,
                        1.1015625],
             'lse': 11.313083380300316,
             'margin': 0.1875,
             'max': 3.71875}],
           [{'argmax': 15914,
             'at_fed': 3.5625,
             'at_ids': [0.5078125, 0.435546875, -0.83203125, -0.251953125, 0.44921875, -1.59375,
                        1.1796875],
             'lse': 11.310496316726727,
             'margin': 0.0,
             'max': 3.5625},
            {'argmax': 26225,
             'at_fed': 3.578125,
             'at_ids': [0.50390625, 0.396484375, -0.765625, -0.392578125, 0.51953125, -1.46875,
                        1.2265625],
             'lse': 11.310033529748676,
             'margin': 0.140625,
             'max': 3.578125},
            {'argmax': 26225,
             'at_fed': 3.75,
             'at_ids': [0.53515625, 0.484375, -0.78515625, -0.10595703125, 0.625, -1.4765625,
                        1.34375],
             'lse': 11.311650772931976,
             'margin': 0.3125,
             'max': 3.75},
            {'argmax': 26225,
             'at_fed': 3.71875,
             'at_ids': [0.478515625, 0.3125, -0.74609375, -0.193359375, 0.46484375, -1.5546875,
                        1.2890625],
             'lse': 11.311869559012266,
             'margin': 0.109375,
             'max': 3.71875},
            {'argmax': 26225,
             'at_fed': 3.71875,
             'at_ids': [0.63671875, 0.390625, -0.78125, -0.1494140625, 0.462890625, -1.46875,
                        1.4296875],
             'lse': 11.312239742328199,
             'margin': 0.234375,
             'max': 3.71875},
            {'argmax': 26225,
             'at_fed': 3.78125,
             'at_ids': [0.578125, 0.43359375, -0.703125, -0.051513671875, 0.58984375, -1.3984375,
                        1.34375],
             'lse': 11.310662103483065,
             'margin': 0.140625,
             'max': 3.78125},
            {'argmax': 26225,
             'at_fed': 3.765625,
             'at_ids': [0.5625, 0.478515625, -0.75, -0.2099609375, 0.51953125, -1.390625, 1.25],
             'lse': 11.31117742303043,
             'margin': 0.171875,
             'max': 3.765625},
            {'argmax': 20627,
             'at_fed': 3.65625,
             'at_ids': [0.5625, 0.4921875, -0.78515625, -0.036865234375, 0.6015625, -1.40625,
                        1.171875],
             'lse': 11.311888324573879,
             'margin': 0.046875,
             'max': 3.65625}]],
 'tokens': [[26225, 26225, 26225, 26225, 26225, 26225, 26225, 26225],
            [15914, 26225, 26225, 26225, 26225, 26225, 26225, 20627]]}
# Tolerance of WHISPER_SERVE_REF against the JAX package: SERVE_LOGIT_TOL
# (two bf16 ulps at the top of the logit range; the port's plain versions
# on the CPU read 0.0156).
WHISPER_LOGIT_TOL = SERVE_LOGIT_TOL
WHISPER_MARGIN_TOL = 2 * WHISPER_LOGIT_TOL
# Tolerances of the full-depth runs on the card (phase 21b): the
# prefill's logits, kernels against the plain versions, and the
# generation's against ``forward``'s, within SERVE_PREFILL_TOL (four bf16
# ulps at the top of the logit range; an H100 80GB HBM3 at 700 W read
# 0.0703 and 0.0625 over the 64-layer stack); each encoder and decoder
# block alone, fed the kernel run's input to it, kernels against the plain
# versions within WHISPER_BLOCK_ULPS bf16 ulps of the block output's
# largest value, HYBRID_BLOCK_ULPS (the plain attention rounds its logits
# and probabilities to bf16 where the flash kernel keeps them in float32,
# phase 5's envelope; the H100 read at most 3).
WHISPER_PREFILL_TOL = SERVE_PREFILL_TOL
WHISPER_BLOCK_ULPS = HYBRID_BLOCK_ULPS
# The leaves whose first moment and updated values the training checks
# sample (layer 0 of the stacks): the embedding, the decoder positions,
# an encoder block's query projection and ln1 scale (stacked, so decayed),
# a decoder block's cross-attention key projection and ln_x scale
# (stacked, decayed), and ``ln_enc``, ``ln_f`` (rank 1, not decayed).
WHISPER_TRAIN_LEAVES = ("embed.embedding", "dec_pos", "enc_blocks.attn.wq.kernel",
                        "enc_blocks.ln1.scale", "dec_blocks.xattn.wk.kernel",
                        "dec_blocks.ln_x.scale", "ln_enc.scale", "ln_f.scale")
# What tests/test_torch_encdec_train_reference.py runs through the JAX
# package on the CPU and what the card's run is held to (phase 21d): the
# whisper smoke config (2 + 2 layers, 64 frames) in float32, 4 x 64 tokens
# a step with the reference loop's frames of the step, 2 steps from
# ``random_lm_tree(cfg, TRAIN["seed"])``, the data seed, AdamW and the
# schedule of TRAIN (those of WHISPER).
WHISPER_TRAIN_REF = dict(dtype="float32", batch=4, seq_len=64, steps=2)
# Tolerances of WHISPER_TRAIN_REF against the JAX package: HYBRID_REF_TOL's
# (float32; the port's plain versions on the CPU read loss 9.5e-7, grad norm
# 1.5e-7 relative, m 3.1e-6 of the leaf's largest, 2.8e-7 lr beyond the
# parameters' ulps; on the card the flash kernels run the FP32-FMA routes).
WHISPER_REF_TOL = HYBRID_REF_TOL
# The JAX package's numbers for WHISPER_TRAIN_REF, on the CPU (jax 0.9.0),
# printed by ``python tests/test_torch_encdec_train_reference.py``.
JAX_WHISPER_TRAIN = {'grad_norm': [4.260893821716309, 3.1253180503845215],
 'loss': [6.465755462646484, 6.475581169128418],
 'm': [{'dec_blocks.ln_x.scale': [-6.998771340249732e-08, 5.527796020032838e-06,
                                  -6.667175512120593e-06, 5.4498423196491785e-06,
                                  -3.8854132071719505e-06, 1.1361890756234061e-05,
                                  2.4960215796454577e-06, 1.3991991181683261e-05,
                                  -2.0458423932723235e-07, 3.946935521526029e-06,
                                  3.837446911347797e-07, 1.0772865607577842e-05,
                                  -1.3630505236505996e-05, 1.2532035498225014e-06,
                                  -8.871359568729531e-06, 9.963585398509167e-06],
        'dec_blocks.xattn.wk.kernel': [-1.8398134216113249e-06, -4.1508374124532565e-06,
                                       -1.628622703719884e-05, 8.282883754873183e-06,
                                       -3.7807498642905557e-07, -6.205074896570295e-06,
                                       -1.3060356423011399e-06, 1.7151401721093862e-07,
                                       -6.546135409735143e-06, -3.0407934445975116e-06,
                                       5.257049451756757e-06, 2.2105446078057867e-06,
                                       7.91098500485532e-07, 1.4753894674868206e-06,
                                       -9.030883347804775e-07, -4.428369265951915e-06],
        'dec_pos': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        'embed.embedding': [0.00013239399413578212, 0.00019396956486161798, 0.00012683161185123026,
                            1.3596319149655756e-05, -0.00039774124161340296, 0.0, 0.0, 0.0, 0.0,
                            0.0, 0.0, 0.0, 0.00038517944631166756, 0.0, 0.0, 0.0],
        'enc_blocks.attn.wq.kernel': [2.995551585627254e-05, 7.355374236794887e-06,
                                      -1.945719850482419e-05, -7.768839168420527e-06,
                                      -1.4543287761625834e-05, -1.705225986370351e-05,
                                      -2.0973384380340576e-05, 2.152245542674791e-05,
                                      -1.6026742741814815e-05, 2.4387101802858524e-05,
                                      -5.729463373427279e-05, -5.498128666658886e-05,
                                      -0.00010435191506985575, -2.6483276087674312e-05,
                                      5.659290400217287e-05, -2.4978211513371207e-05],
        'enc_blocks.ln1.scale': [-0.00018184415239375085, 3.2840795029187575e-05,
                                 0.0002493840584065765, -1.409442484145984e-05,
                                 0.0003401994763407856, -0.00019353997777216136,
                                 -0.00028813464450649917, 7.379310409305617e-05,
                                 -9.415468957740813e-05, -0.0001394622231600806,
                                 0.00028573579038493335, -0.00031590258004143834,
                                 -0.00036451639607548714, -0.0004912785952910781,
                                 -0.0001645572338020429, -0.0001232184295076877],
        'ln_enc.scale': [0.0002684828359633684, -4.0536826418247074e-05, -0.00014572282088920474,
                         -1.0024173207057174e-05, -7.503441884182394e-05, 0.00011328636173857376,
                         0.0001893556909635663, -8.675635763211176e-05, -0.00023111874179448932,
                         0.0002497943351045251, -0.0002926807792391628, -2.405490340606775e-05,
                         9.143767783825751e-06, 5.7703677157405764e-05, 2.7942718588747084e-05,
                         0.00017330942500848323],
        'ln_f.scale': [4.936358527629636e-05, 0.0002284632355440408, -0.00013314769603312016,
                       2.3844926545280032e-05, -1.6797665011836216e-05, 0.0006816490204073489,
                       5.1701052143471316e-05, 0.00043239264050498605, 8.4068211435806e-05,
                       0.0004608056624419987, 0.00012199638149468228, 0.0003061434836126864,
                       3.099149353147368e-06, -8.383912063436583e-05, 0.0005114267696626484,
                       0.00011195878323633224]},
       {'dec_blocks.ln_x.scale': [-8.097321369859856e-06, 2.464908902766183e-05,
                                  -6.526302513520932e-06, 4.9841601139632985e-06,
                                  -1.0813730568770552e-06, 9.591299203748349e-06,
                                  1.8020089100900805e-06, 1.7495598513050936e-05,
                                  -2.391585212535574e-06, -2.9262375846883515e-06,
                                  5.303260877553839e-06, 7.974588697834406e-06,
                                  -6.049801413610112e-06, 6.823805506428471e-06,
                                  -6.029517408023821e-06, 8.011981663003098e-06],
        'dec_blocks.xattn.wk.kernel': [1.659711415413767e-05, -7.532815288868733e-06,
                                       -1.5576708392472938e-05, -1.0521980584599078e-05,
                                       -1.344102383882273e-05, -2.3136739457640942e-07,
                                       -2.0274414964660536e-06, -8.026978321140632e-06,
                                       -8.109352165774908e-06, -4.941445240547182e-06,
                                       6.12221401752322e-06, 2.478244596204604e-06,
                                       2.6919774427369703e-06, 1.264991624339018e-06,
                                       -3.96871746488614e-06, -8.556082320865244e-06],
        'dec_pos': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        'embed.embedding': [0.00011915458890143782, 0.00012800430704373866, -3.0508983400068246e-05,
                            2.845847666321788e-05, -0.00035796710290014744, 0.0,
                            0.0002466391015332192, -0.0003174814337398857, 0.0, 0.0, 0.0, 0.0,
                            0.0003466614871285856, 0.0, 0.0, 0.0],
        'enc_blocks.attn.wq.kernel': [3.322373959235847e-05, -2.1923913209320744e-06,
                                      -3.355209264555015e-05, -4.452727807802148e-06,
                                      -1.292286833631806e-05, -8.071748015936464e-05,
                                      -8.823124517221004e-05, -6.7629821387527045e-06,
                                      -1.4011093298904598e-05, 8.257356967078522e-05,
                                      -6.614928861381486e-05, -7.6758922659792e-05,
                                      -0.00016332285304088145, 2.172347558371257e-05,
                                      0.00013513297017198056, -2.714850961638149e-05],
        'enc_blocks.ln1.scale': [-0.0003211800940334797, 0.00014789642591495067,
                                 0.00013489370758179575, 6.708962609991431e-05,
                                 0.0003850576758850366, -9.815515659283847e-05,
                                 -0.0002258679160149768, -7.236332749016583e-05,
                                 5.877940930076875e-05, -0.00018626484961714596,
                                 0.00048624450573697686, -0.0006465189508162439,
                                 -0.0003942699986509979, -0.0004754986730404198,
                                 -0.00037548880209214985, -0.00017434987239539623],
        'ln_enc.scale': [0.0002852188190445304, -6.400430265784962e-06, -0.0003869360953103751,
                         2.2196583813638426e-05, -0.0002625673951115459, 8.312845602631569e-05,
                         -0.00011998488480458036, -0.00010535010369494557, -0.00016170466551557183,
                         0.00019543542293831706, 0.00013392216351348907, 9.51545416683075e-07,
                         0.000251683930400759, -6.402059079846367e-05, 2.2978185370448045e-05,
                         2.4781320462352596e-05],
        'ln_f.scale': [-0.000240721128648147, 7.991048914846033e-05, 0.00023379706544801593,
                       0.00022612218162976205, 5.823495303047821e-05, 0.0010235914960503578,
                       4.2661293264245614e-05, 0.00035401491913944483, 3.5559571642806986e-06,
                       0.00036752494634129107, 0.00028456293512135744, 0.00037537552998401225,
                       -0.0005296606686897576, 0.0001365729549434036, 0.0008370790746994317,
                       0.0005217507714405656]}],
 'params': {'dec_blocks.ln_x.scale': [1.0015264749526978, 0.9979122281074524, 1.0015352964401245,
                                      0.9981109499931335, 1.0009765625, 0.9981648325920105,
                                      0.9982653260231018, 0.9979130029678345, 1.0015876293182373,
                                      0.9990857243537903, 0.9980190396308899, 0.9982494711875916,
                                      1.0011029243469238, 0.997940182685852, 1.0012996196746826,
                                      0.9981968998908997],
            'dec_blocks.xattn.wk.kernel': [-0.07216205447912216, 0.011882355436682701,
                                           0.09428664296865463, 0.027071498334407806,
                                           -0.028232073411345482, 0.1257498413324356,
                                           -0.07315468043088913, -0.11318355798721313,
                                           -0.10011513531208038, 0.17872370779514313,
                                           -0.11799454689025879, -0.05035785958170891,
                                           -0.032165370881557465, 0.013955747708678246,
                                           -0.09881983697414398, -0.06401456147432327],
            'dec_pos': [-0.018323861062526703, 0.03644528612494469, -0.01745499111711979,
                        -0.004582796711474657, 0.004553125239908695, 0.028936225920915604,
                        0.03999199718236923, 0.0030896926764398813, -0.006167132407426834,
                        0.018361659720540047, -0.023885542526841164, -0.008444922044873238,
                        -0.008291979320347309, -0.009087832644581795, 0.002840979490429163,
                        0.025822173804044724],
            'embed.embedding': [-0.01248038187623024, 0.038508933037519455, -0.000399585347622633,
                                -0.019727632403373718, 0.012159952893853188, 0.010170583613216877,
                                -0.004691695794463158, 0.00598044041544199, -0.03249194100499153,
                                -0.03605956584215164, -0.0063145398162305355, -0.032150544226169586,
                                -0.004231439437717199, -0.03999199718236923, -0.003344098338857293,
                                -0.018350213766098022],
            'enc_blocks.attn.wq.kernel': [0.029800087213516235, 0.005770848598331213,
                                          -0.06064227223396301, 0.08858196437358856,
                                          0.010879909619688988, 0.11346891522407532,
                                          -0.1748446524143219, -0.0021143474150449038,
                                          0.17840009927749634, -0.051553480327129364,
                                          -0.051915209740400314, 0.08969593793153763,
                                          0.054927315562963486, -0.035810887813568115,
                                          0.010991073213517666, -0.032546766102313995],
            'enc_blocks.ln1.scale': [1.0017954111099243, 0.9979135394096375, 0.9984173774719238,
                                     1.0001907348632812, 0.9979698061943054, 1.0011546611785889,
                                     1.0013868808746338, 0.9991403818130493, 1.0005463361740112,
                                     1.001719355583191, 0.997809112071991, 1.001799464225769,
                                     1.0016016960144043, 1.001528024673462, 1.0017917156219482,
                                     1.0017433166503906],
            'ln_enc.scale': [0.9982098340988159, 1.0010946989059448, 1.0019720792770386,
                             1.000501275062561, 1.0019264221191406, 0.9984545707702637,
                             0.9992563128471375, 1.0018714666366577, 1.0015168190002441,
                             0.9984142780303955, 1.0007988214492798, 1.0009784698486328,
                             0.9982408285140991, 0.9993650913238525, 0.9983819127082825,
                             0.9989148378372192],
            'ln_f.scale': [0.9996117949485779, 0.9987703561782837, 1.0005438327789307,
                           0.9981932044029236, 1.0004304647445679, 0.9980365037918091,
                           0.998379647731781, 0.9983847737312317, 0.9989760518074036,
                           0.9984018802642822, 0.9980106353759766, 0.9981232285499573,
                           0.9997314214706421, 1.0005582571029663, 0.9980154633522034,
                           0.9981182813644409]}}


def whisper_launches(cfg) -> dict:
    """The kernel launches of the ``audio`` config ``cfg`` (its layernorms
    and cross-attention are plain, as the reference's ``jnp``, so no
    rmsnorm): a prefill runs the encoder's non-causal flash forward once a
    layer and the decoder's causal one once a layer; ``generate`` encodes
    once (the encoder's launches) and then runs the cached decode (none a
    token); a ``build_train_step`` step with ``remat="block"`` runs every
    block's forward twice (the recompute) and its backward once."""
    enc, dec = cfg.encdec.encoder_layers, cfg.n_layers
    return {"prefill": {"rmsnorm": 0, "flash_attention_fwd": enc + dec},
            "generate": {"rmsnorm": 0, "flash_attention_fwd": enc},
            "train": {"flash_attention_fwd": 2 * (enc + dec), "flash_attention_bwd_dkv": enc + dec,
                      "flash_attention_bwd_dq": enc + dec, "rmsnorm": 0}}


def whisper_step_flops(model, batch: int, seq_len: int) -> float:
    """6 x the matmul work of one ``batch`` x ``seq_len`` training step of
    the ``EncDec`` ``model``: the encoder's parameters and the decoder's
    cross-attention key/value projections over the frames, the rest of the
    decoder and the head over the tokens (the attention products not
    counted, as ``train_mfu``'s 6 N tokens of the other families)."""
    frames = model.cfg.encdec.encoder_seq
    per_frame = per_token = 0
    for name, p in model.named_parameters():
        if name.startswith(("enc_blocks.", "ln_enc.")) or ".xattn.wk." in name \
                or ".xattn.wv." in name:
            per_frame += p.numel()
        elif name.startswith(("dec_blocks.", "ln_f.", "lm_head.")):
            per_token += p.numel()
    return 6.0 * batch * (per_frame * frames + per_token * seq_len)


def whisper_train_config():
    """WHISPER_TRAIN_REF's config: the whisper smoke config in float32."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(WHISPER["arch"]), dtype=WHISPER_TRAIN_REF["dtype"])


def whisper_serve_config():
    """WHISPER_SERVE_REF's config: whisper-large-v3 at full width with its
    depth cut."""
    import dataclasses

    from repro_torch.configs import full_config

    cfg = full_config(WHISPER["arch"])
    r = WHISPER_SERVE_REF
    return dataclasses.replace(cfg, n_layers=r["n_layers"], encdec=dataclasses.replace(
        cfg.encdec, encoder_layers=r["encoder_layers"]))


def port_whisper_train_reference(cfg, dev, ref: dict = WHISPER_TRAIN_REF) -> dict:
    """``ref``'s steps of ``cfg`` through the port on ``dev`` from
    ``random_lm_tree(cfg, TRAIN["seed"])`` (``port_train_reference``)."""
    from repro_torch import convert

    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, TRAIN["seed"]), cfg,
                                         device=dev)
    return port_train_reference(model, cfg, dev, ref, WHISPER_TRAIN_LEAVES)


def phase_whisper_kernels(dev) -> dict:
    """21a: the flash kernels at whisper's shapes (20 heads of 64 on 20 KV
    heads, bf16): the forward at the encoder's (4, 20, 1500, 64),
    non-causal (1500 = 23 x 64 + 28: a ragged last tile), and at the
    decoder's prefill (4, 20, 64, 64), causal; the backward (dK/dV and dQ,
    the tensor-core route at 64) at the encoder's shape and at the
    decoder's training shape (4, 20, 512, 64), causal.  Each is held as
    phases 5 and 7 hold it: the forward within one bf16 ulp of the float32
    plain version (1e-5 on lse) and 2e-2 of the bf16 one; the backward
    through ``FlashAttention`` against the plain backward on the same
    residuals (one bf16 ulp plus 1e-5 of the scale) and autograd through
    the float32 plain attention (2^-7 of the element and of the scale).
    Each is timed beside its plain version and the library's
    (``F.scaled_dot_product_attention``; its backward through autograd),
    with its bound (the backward's also for the three-part tensor-core
    products)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import full_config
    from repro_torch.kernels import flash_attention as fa, ref

    cfg = full_config(WHISPER["arch"])
    h, d = cfg.n_heads, cfg.resolved_head_dim
    b, t_enc = WHISPER["batch"], cfg.encdec.encoder_seq
    _check(cfg.n_kv_heads == h and d == 64, "whisper's attention: 20 heads of 64 on 20 KV heads")
    gen = torch.Generator(device=dev).manual_seed(21)
    randn = lambda t: torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
    scale = d ** -0.5
    bound = lambda c: max(c[0] / HBM_BYTES_PER_S, c[1] / BF16_FLOP_PER_S) * 1e3
    by = lambda c: "bytes" if c[0] / HBM_BYTES_PER_S >= c[1] / BF16_FLOP_PER_S else "operations"
    rows = {"flash_attention_fwd": {}, "flash_attention_bwd_dkv": {}, "flash_attention_bwd_dq": {}}
    for label, t, causal in (("whisper_enc", t_enc, False),
                             ("whisper_dec_prefill", WHISPER["prefill"][1], True)):
        q, k, v = randn(t), randn(t), randn(t)
        o, lse = _fa_kernel(q, k, v, causal)
        o_p, lse_p = ref.attention(q, k, v, causal=causal, with_lse=True)
        o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=causal, with_lse=True)
        torch.cuda.synchronize()
        dev_o = (o.double() - o_w.double()).abs()
        err = max(_max_err(o, o_p), _max_err(lse, lse_p))
        ok = (tuple(o.shape) == (b, h, t, d) and err <= 2e-2
              and bool((dev_o <= 2.0**-7 * o_w.double().abs() + 1e-6).all())
              and _max_err(lse, lse_w) <= 1e-5)
        print(f"flash fwd   {label} q {tuple(q.shape)} {'causal' if causal else 'non-causal'} bf16: "
              f"max|kernel - plain| o {_max_err(o, o_p):.3e} lse {_max_err(lse, lse_p):.3e}; vs "
              f"float32 plain o {float(dev_o.max()):.3e} lse {_max_err(lse, lse_w):.3e}")
        _check(ok, f"flash forward {label} vs plain")
        cost = _flash_bytes_ops(q, k, causal)
        row = {f"{label}_shape": list(q.shape), f"{label}_causal": causal,
               f"{label}_ms": _median_ms(lambda: _fa_kernel(q, k, v, causal)),
               f"{label}_plain_ms": _median_ms(lambda: ref.attention(q, k, v, causal=causal,
                                                                     with_lse=True)),
               f"{label}_library_ms": _median_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal)),
               f"{label}_bound_ms": bound(cost), f"{label}_bound_by": by(cost),
               f"{label}_max_abs_err": err}
        rows["flash_attention_fwd"].update(row)
        print(f"flash fwd   {label}: kernel {row[f'{label}_ms']:.4f} ms, plain "
              f"{row[f'{label}_plain_ms']:.4f} ms, F.scaled_dot_product_attention "
              f"{row[f'{label}_library_ms']:.4f} ms; bound {row[f'{label}_bound_ms']:.4f} ms "
              f"({row[f'{label}_bound_by']}; {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} GFLOP)")
        del o_p, o_w
    by_route = lambda: [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
    for label, t, causal in (("whisper_enc", t_enc, False),
                             ("whisper_dec_train", WHISPER["seq_len"], True)):
        q, k, v, do = randn(t), randn(t), randn(t), randn(t)
        o, lse = _fa_kernel(q, k, v, causal)
        before = by_route()
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        got = torch.autograd.grad(fa.FlashAttention.apply(ql, kl, vl, causal, None), (ql, kl, vl),
                                  do)
        took = {r for b_, a_ in zip(before, by_route()) for r in a_ if a_[r] != b_[r]}
        _check(took == {"tensor cores"}, f"flash backward {label}: routes {took}")
        plain = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
        qw, kw, vw = (x.float().requires_grad_() for x in (q, k, v))
        auto = torch.autograd.grad(ref.attention(qw, kw, vw, causal=causal, scale=scale),
                                   (qw, kw, vw), do.float())
        torch.cuda.synchronize()
        line, ok, berr = f"flash bwd   {label} q {tuple(q.shape)} bf16 [tensor cores]:", True, 0.0
        for nm, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
            g64, p64, a64 = g.double(), p.double(), a.double()
            sc = float(p64.abs().max())
            ok &= tuple(g.shape) == tuple(p.shape) and bool(
                ((g64 - p64).abs() <= 2.0**-7 * p64.abs() + 1e-5 * sc).all())
            ok &= bool(((g64 - a64).abs() <= 2.0**-7 * a64.abs() + 2.0**-7 * sc).all())
            line += (f" {nm} {float((g64 - p64).abs().max()):.3e}/"
                     f"{float((g64 - a64).abs().max()):.3e} (max {sc:.3f})")
            berr = max(berr, float((g64 - p64).abs().max()))
        print(line + "  [kernel - plain backward / - autograd of plain attention]")
        _check(ok, f"flash backward {label} vs plain")
        del got, plain, auto, qw, kw, vw
        lse_c, delta = lse.contiguous(), torch.sum(do.float() * o.float(), dim=-1)
        dkv_ms = _median_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse_c, delta, causal=causal,
                                                     scale=scale))
        dq_ms = _median_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse_c, delta, causal=causal,
                                                   scale=scale))
        plain_ms = _median_ms(lambda: ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                              scale=scale))
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_ms = _median_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
        cost, tc = _flash_bwd_bytes_ops(q, k, causal), _flash_bwd_tc_ops(q, k, causal)
        for key, which, ms in (("dkv", "flash_attention_bwd_dkv", dkv_ms),
                               ("dq", "flash_attention_bwd_dq", dq_ms)):
            c = cost[key]
            rows[which].update({
                f"{label}_shape": list(q.shape), f"{label}_causal": causal,
                f"{label}_route": "tensor cores", f"{label}_ms": ms, f"{label}_plain_ms": plain_ms,
                f"{label}_library_ms": lib_ms, f"{label}_bound_ms": bound(c),
                f"{label}_bound_by": by(c), f"{label}_bound_tc_ms": bound((c[0], tc[key])),
                f"{label}_max_abs_err": berr})
        print(f"flash bwd   {label}: dK/dV {dkv_ms:.4f} ms (bound "
              f"{rows['flash_attention_bwd_dkv'][f'{label}_bound_ms']:.4f}, three-part work "
              f"{rows['flash_attention_bwd_dkv'][f'{label}_bound_tc_ms']:.4f}), dQ {dq_ms:.4f} ms "
              f"(bound {rows['flash_attention_bwd_dq'][f'{label}_bound_ms']:.4f}, three-part "
              f"{rows['flash_attention_bwd_dq'][f'{label}_bound_tc_ms']:.4f}); plain backward "
              f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms")
        del out, ql, kl, vl
        torch.cuda.empty_cache()
    return rows


def phase_whisper_cross(dev) -> dict:
    """21a (cross-attention): the decoder's cross-attention core
    (``encdec._full_attention``, plain PyTorch as the reference's ``jnp``)
    at the training step's shape, q (4, 512, 20, 64) against the memory's
    k, v (4, 1500, 20, 64) bf16, timed forward and forward + backward
    (autograd), beside the flash kernels at the same non-causal Tq != Tk
    shape (their forward held within one bf16 ulp of the float32 plain
    version): ROADMAP's held lead of routing cross-attention through flash.
    Returns the four times (ms) and the flash forward's error."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.models import encdec as ED

    cfg = full_config(WHISPER["arch"])
    h, d = cfg.n_heads, cfg.resolved_head_dim
    b, tq, tm = WHISPER["batch"], WHISPER["seq_len"], cfg.encdec.encoder_seq
    gen = torch.Generator(device=dev).manual_seed(22)
    randn = lambda t: torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v, do = randn(tq), randn(tm), randn(tm), randn(tq)
    scale = d ** -0.5
    with torch.no_grad():
        plain_fwd = _median_ms(lambda: ED._full_attention(q, k, v, scale))
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    plain_fb = _median_ms(lambda: torch.autograd.grad(ED._full_attention(ql, kl, vl, scale),
                                                      (ql, kl, vl), do))
    qf, kf, vf, dof = (x.transpose(1, 2) for x in (q, k, v, do))
    o, _ = _fa_kernel(qf, kf, vf, False)
    o_w = ref.attention(qf.float(), kf.float(), vf.float(), causal=False)
    err = float((o.double() - o_w.double()).abs().max())
    _check(bool((((o.double() - o_w.double()).abs()) <= 2.0**-7 * o_w.double().abs() + 1e-6).all()),
           "flash forward at the cross-attention shape vs float32 plain")
    flash_fwd = _median_ms(lambda: _fa_kernel(qf, kf, vf, False))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qf, kf, vf))
    flash_fb = _median_ms(lambda: torch.autograd.grad(
        fa.FlashAttention.apply(qg, kg, vg, False, None), (qg, kg, vg), dof))
    print(f"audio cross-attention core q ({b}, {tq}, {h}, {d}) x memory {tm}, bf16: plain forward "
          f"{plain_fwd:.4f} ms, forward + backward {plain_fb:.4f} ms; flash forward {flash_fwd:.4f} "
          f"ms (max|flash - float32 plain| {err:.3e}), forward + backward {flash_fb:.4f} ms "
          f"(timed here; the port runs the plain core, as the reference)")
    return {"plain_fwd_ms": plain_fwd, "plain_fwd_bwd_ms": plain_fb, "flash_fwd_ms": flash_fwd,
            "flash_fwd_bwd_ms": flash_fb, "flash_max_abs_err": err}


def _whisper_blocks_alone(model, run) -> dict:
    """Each encoder and decoder block of ``model``, fed its inputs in
    ``run()`` (the prefill on the kernels), once more on the kernels and on
    the plain versions: the largest difference of each in bf16 ulps of its
    output's largest value, ``{"encoder": [...], "decoder": [...]}``."""
    import torch

    from repro_torch.kernels import ops

    inputs = {"encoder": [], "decoder": []}
    keep = lambda kind: lambda m, a, kw: inputs[kind].append(
        (m, tuple(x.clone() for x in a), dict(kw)))
    hooks = [blk.register_forward_pre_hook(keep("encoder"), with_kwargs=True)
             for blk in model.enc_blocks]
    hooks += [blk.register_forward_pre_hook(keep("decoder"), with_kwargs=True)
              for blk in model.dec_blocks]
    run()
    for hk in hooks:
        hk.remove()
    out = {"encoder": [], "decoder": []}
    with torch.inference_mode():
        for kind, calls in inputs.items():
            for m, args, kw in calls:
                yk = m(*args, **kw)[0]
                with ops.forced("ref"):
                    yp = m(*args, **kw)[0]
                out[kind].append(_max_err(yk, yp) / _bf16_ulp(float(yp.abs().max())))
    return out


def _whisper_model(dev):
    """whisper-large-v3 at full width and depth, drawn on the card."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.models import encdec as ED

    cfg = full_config(WHISPER["arch"])
    _check(cfg.family == "audio" and cfg.dtype == "bfloat16" and cfg.remat == "block",
           "whisper-large-v3 serves and trains in bf16 with remat")
    t0 = time.perf_counter()
    model = ED.init(cfg, device=dev, generator=torch.Generator(dev).manual_seed(WHISPER["seed"]))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    print(f"audio: {cfg.name} {n} parameters ({gib:.2f} GiB; {len(model.enc_blocks)} encoder + "
          f"{len(model.dec_blocks)} decoder layers, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, dec_pos {tuple(model.dec_pos.shape)}) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def phase_whisper_serve(dev, model, profile_dir: Path | None = None) -> dict:
    """21b: ``model`` (whisper-large-v3, ``_whisper_model``) served with the
    1500 frames of ``WHISPER["frame_seed"]`` a request.  (a) The prefill
    step on 4 x 64 tokens (the caches sized to the prompt): launches
    (``whisper_launches``: 32 non-causal + 32 causal flash), wall, peak
    memory, every logit against the same step on the plain versions
    (``ops.forced("ref")``) within WHISPER_PREFILL_TOL, and each block
    alone within WHISPER_BLOCK_ULPS (``_whisper_blocks_alone``).  (b)
    Greedy generation 4 x (64 + 32) (``ServeEngine.generate(frames=)``):
    launches (the encoder's 32 once, none a token), tokens/s, its logits
    against ``forward``'s within WHISPER_PREFILL_TOL and its tokens the
    forward's argmax where the top-2 margin exceeds twice their largest
    difference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import encdec as ED
    from repro_torch.serve import ServeEngine, build_prefill_step
    from repro_torch.train.loop import audio_frames

    t_phase = time.perf_counter()
    cfg = model.cfg
    per = whisper_launches(cfg)

    # (a) Prefill: 4 prompts x 64 tokens and 4 x 1500 frames.
    b, tl = WHISPER["prefill"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl, WHISPER["prompt_seed"]),
                              device=dev)
    frames = audio_frames(cfg, b, WHISPER["frame_seed"], dev)
    step = build_prefill_step(cfg)
    step(model, prompts, frames)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t = time.perf_counter()
    logits, state = step(model, prompts, frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with ops.forced("ref"):
        logits_ref, _ = step(model, prompts, frames)
    torch.cuda.synchronize()
    err = _max_err(logits, logits_ref)
    print(f"audio prefill {b} x {tl} tokens, {b} x {frames.shape[1]} frames: {prefill_s:.4f} s "
          f"wall, {b * tl / prefill_s:.0f} tokens/s, peak {peak:.2f} GiB allocated, launches "
          f"{prefill_counts}; logits max|kernels - plain| {err:.4f} (max|logit| "
          f"{float(logits_ref.abs().max()):.3f})")
    ulps = _whisper_blocks_alone(model, lambda: step(model, prompts, frames))
    print(f"audio blocks alone, max|kernels - plain| in bf16 ulps of the block output's largest "
          f"value: encoder {[f'{u:g}' for u in ulps['encoder']]}; decoder "
          f"{[f'{u:g}' for u in ulps['decoder']]}")
    _check(max(ulps["encoder"] + ulps["decoder"]) <= WHISPER_BLOCK_ULPS,
           "audio blocks alone, kernels vs plain versions")
    _check(prefill_counts == per["prefill"],
           f"audio prefill launches {prefill_counts}, want {per['prefill']}")
    sk = state.self_kv
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and sk.length == tl and tuple(sk.k.shape[:3]) == (cfg.n_layers, b, tl)
           and tuple(state.cross_k.shape[:3]) == (cfg.n_layers, b, frames.shape[1]),
           "audio prefill logits/state")
    _check(err <= WHISPER_PREFILL_TOL, "audio prefill logits, kernels vs plain versions")
    del logits, logits_ref, state, sk
    torch.cuda.empty_cache()

    # (b) Generation: 4 requests, 64-token prompts, 32 greedy tokens.
    b, t0p = WHISPER["gen"]
    n = WHISPER["gen_tokens"]
    gprompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t0p, WHISPER["prompt_seed"] + 1),
                               device=dev)
    eng = ServeEngine(cfg, model, max_len=t0p + n, device=dev)
    eng.generate(gprompts, 2, frames=frames)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    out = eng.generate(gprompts, n, frames=frames)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_counts = _counts()
    with torch.inference_mode():
        fwd = ED.forward(model, out[:, :-1], frames).logits[:, t0p - 1:]
    gen_logits = decode_logits(model, cfg, gprompts, out[:, t0p:], t0p + n, frames)
    gen_err = _max_err(gen_logits, fwd)
    own = torch.equal(gen_logits.argmax(-1), out[:, t0p:])
    margin = torch.as_tensor(_top2_margin(fwd.cpu().numpy()))
    agree = fwd.argmax(-1).cpu() == out[:, t0p:].cpu()
    # With every logit within gen_err of forward's, a greedy token can
    # differ from forward's argmax only where forward's top-2 margin is
    # within 2 gen_err.
    sure = margin > 2 * gen_err
    worst = float(margin[~agree].max()) if bool((~agree).any()) else 0.0
    print(f"audio generate {b} x ({t0p} + {n}): {gen_s:.4f} s wall (the {frames.shape[1]} frames "
          f"encoded once), {b * n / gen_s:.1f} tokens/s, launches {gen_counts}; greedy tokens == "
          f"the argmax of their logits: {own}; logits max|generation - forward| {gen_err:.4f}; "
          f"greedy == forward argmax at {int(agree.sum())}/{agree.numel()} positions (largest "
          f"margin where not {worst:.4f}), {int(sure.sum())} with a top-2 margin > 2 x "
          f"{gen_err:.4f}")
    _check(gen_counts == per["generate"], f"audio generation launches {gen_counts}")
    _check(own, "audio greedy tokens differ from their logits' argmax")
    _check(gen_err <= WHISPER_PREFILL_TOL, "audio generation logits vs forward")
    _check(bool(sure.any()) and bool(agree[sure].all()),
           "audio greedy tokens differ from the forward argmax")
    if profile_dir is not None:
        profile_run("whisper_prefill", lambda: _timed(lambda: step(model, prompts, frames)),
                    profile_dir)
        profile_run("whisper_generate",
                    lambda: _timed(lambda: eng.generate(gprompts, n, frames=frames)), profile_dir)
    del eng, fwd, gen_logits
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"audio serve: phase {wall:.1f} s")
    return {"prefill": prefill_counts, "generate": gen_counts, "prefill_s": prefill_s,
            "prefill_tokens_per_s": b * tl / prefill_s, "generate_s": gen_s,
            "tokens_per_s": b * n / gen_s, "peak_gib": peak, "phase_s": wall}


def phase_whisper_train(dev, model, cross: dict, profile_dir: Path | None = None) -> dict:
    """21c: ``model`` (whisper-large-v3 at full width and depth, bf16)
    trained with ``build_train_step``, ``remat="block"`` and AdamW's
    float32 moments, 4 x 512 tokens and the reference loop's 4 x 1500
    frames of the step.  Step 1 on the plain versions, then from the same
    start (a copy of the parameters on the card) the same step on the
    kernels, held to it under TRAIN_TOL on WHISPER_TRAIN_LEAVES; the kernel
    step once more from the same start, whose parameters and first moment
    must equal the first kernel run's bit for bit (``_bit_prints``); then
    two more kernel steps, timed.  Every kernel step must launch
    ``whisper_launches(cfg)["train"]``, the backward on the tensor-core
    route only; the plain step none.  ``train_mfu`` counts
    ``whisper_step_flops``.  With ``cross`` (``phase_whisper_cross``) it
    prints the cross-attention core's share of the warm step: each of the
    32 decoder blocks runs it forward twice (the recompute) and backward
    once, beside what the flash kernels would take at that shape."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.train.loop import audio_frames

    t_phase = time.perf_counter()
    cfg, tr = model.cfg, WHISPER
    b, t = tr["batch"], tr["seq_len"]
    opt = AdamWConfig(lr=tr["lr"])
    step = build_train_step(cfg, opt, total_steps=tr["total_steps"],
                            warmup_steps=tr["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=b, seq_len=t,
                                       vocab_size=cfg.vocab_size))
    batch_at = lambda i: {**ds.batch_at(i), "frames": audio_frames(cfg, b, i, dev)}
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    start = {n: p.detach().clone() for n, p in params.items()}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])

    per_step = whisper_launches(cfg)["train"]
    none = dict.fromkeys(per_step, 0)
    batch0 = batch_at(0)

    # (1) Step 1 on the plain versions.
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.forced("ref"):
        _, st, mp = step(model, adamw_init(params, opt), batch0, 0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(_train_counts() == none, f"audio train plain step launched {_train_counts()}")
    want = _step_summary(model, st, mp, WHISPER_TRAIN_LEAVES)
    del st, mp
    restore()

    # (2) The same step on the kernels, (3) once more, (4) two more steps.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts, routes = [], [], []

    def kernel_step(i, state, batch):
        _reset_train_counts()
        before = [dict(f.route_launches) for f in (fa.flash_bwd_dkv, fa.flash_bwd_dq)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step(model, state, batch, i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(_train_counts())
        routes.append({r for f, b_ in zip((fa.flash_bwd_dkv, fa.flash_bwd_dq), before)
                       for r in f.route_launches if f.route_launches[r] != b_[r]})
        return state, metrics

    state, mk = kernel_step(0, adamw_init(params, opt), batch0)
    got = _step_summary(model, state, mk, WHISPER_TRAIN_LEAVES)
    prints = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    del state, mk
    restore()
    state, mk = kernel_step(0, adamw_init(params, opt), batch0)
    again = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    differ = sorted(n for n in prints if prints[n] != again[n])
    del start
    losses = [float(mk["loss"])]
    for i in range(1, tr["steps"]):
        state, mk = kernel_step(i, state, batch_at(i))
        losses.append(float(mk["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    bad = compare_train(got, want, tr["lr"], TRAIN_TOL, WHISPER_TRAIN_LEAVES)
    step_s = walls[-1]
    tokens = b * t
    flops = whisper_step_flops(model, b, t)
    mfu = flops / (step_s * BF16_FLOP_PER_S)
    print(f"audio train {cfg.name} {cfg.encdec.encoder_layers} + {cfg.n_layers} layers, {n_params} "
          f"parameters (bf16, remat={cfg.remat} a block, AdamW float32 moments), {b} x {t} tokens "
          f"and {b} x {cfg.encdec.encoder_seq} frames: plain step {plain_s:.3f} s, kernel step "
          f"walls {[round(w, 4) for w in walls]} s (two step-1 runs, then steps 2-{tr['steps']}), "
          f"losses {losses}, launches a step {counts[-1]}, backward routes "
          f"{sorted(set().union(*routes))}, peak {peak:.2f} GiB allocated")
    print("audio train step 1, kernels vs plain versions: "
          + json.dumps(train_max_diff(got, want, tr["lr"], TRAIN_TOL, WHISPER_TRAIN_LEAVES)))
    print("audio train step 1 twice on the kernels from the same start: "
          + ("the same bits (parameters and first moment)" if not differ else
             f"{len(differ)} leaves differ: {differ[:12]}"))
    print(f"audio train warm step {step_s:.4f} s, {tokens / step_s:.1f} tokens/s, train_mfu "
          f"{mfu:.4f} ({flops / 1e12:.2f} TFLOP of matmul work a step, whisper_step_flops, over "
          f"step time x 989 TFLOP/s; remat executes ~4/3 of it)")
    cross_ms = cfg.n_layers * (cross["plain_fwd_ms"] + cross["plain_fwd_bwd_ms"])
    flash_ms = cfg.n_layers * (cross["flash_fwd_ms"] + cross["flash_fwd_bwd_ms"])
    print(f"audio train cross-attention core: {cfg.n_layers} x (forward + forward and backward) "
          f"= {cross_ms:.1f} ms of device time a step, {100 * cross_ms / 1e3 / step_s:.1f} % of "
          f"the warm step; through the flash kernels {flash_ms:.1f} ms")
    _check(all(c == per_step for c in counts), f"audio train launches {counts}, want {per_step}")
    _check(all(r == {"tensor cores"} for r in routes), f"audio train backward routes {routes}")
    _check(all(map(math.isfinite, losses)), f"audio train losses {losses}")
    _check(not bad, "audio train step 1, kernels vs plain versions: " + "; ".join(bad[:10]))
    _check(not differ, f"audio train step 1 twice on the kernels: {differ[:12]} differ")
    if profile_dir is not None:
        bp = batch_at(tr["steps"])
        profile_run("whisper_train_step",
                    lambda: _timed(lambda: step(model, state, bp, tr["steps"])), profile_dir)
    del state, mk
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"audio train: phase {wall:.1f} s")
    return {"counts": {k: sum(c[k] for c in counts) for k in per_step}, "per_step": per_step,
            "walls": walls, "step_s": step_s, "tokens_per_s": tokens / step_s, "train_mfu": mfu,
            "peak_gib": peak, "plain_step_s": plain_s, "same_bits": not differ,
            "cross_attention_ms": cross_ms, "cross_attention_share": cross_ms / 1e3 / step_s,
            "phase_s": wall}


def phase_whisper_serve_reference(dev) -> dict:
    """21d (serving): WHISPER_SERVE_REF at full width cut to 2 + 2 layers
    (weights ``random_lm_leaves``, moved to the card leaf by leaf) on the
    kernels against JAX_WHISPER_SERVE under WHISPER_LOGIT_TOL."""
    import torch

    from repro_torch import convert

    cfg = whisper_serve_config()
    t = time.perf_counter()
    model = convert.lm_params_from_leaves(convert.random_lm_leaves(cfg, WHISPER["seed"]), cfg,
                                          device=dev)
    print(f"audio vs JAX: random_lm_leaves of {cfg.encdec.encoder_layers} + {cfg.n_layers} layers "
          f"moved to the card in {time.perf_counter() - t:.1f} s")
    _reset_counts()
    got = port_serve_reference(model, cfg, dev, JAX_WHISPER_SERVE["tokens"], WHISPER_SERVE_REF)
    counts = _counts()
    del model
    torch.cuda.empty_cache()
    bad, skipped = compare_serve(got, JAX_WHISPER_SERVE, WHISPER_LOGIT_TOL, WHISPER_MARGIN_TOL)
    print(f"audio vs JAX ({cfg.encdec.encoder_layers} + {cfg.n_layers} layers): prefill rows and "
          f"teacher-forced steps max|diff| {serve_max_diff(got, JAX_WHISPER_SERVE):.4f} "
          f"(tolerance {WHISPER_LOGIT_TOL}); row argmax {[g['argmax'] for g in got['rows']]} vs "
          f"{[w['argmax'] for w in JAX_WHISPER_SERVE['rows']]}; tokens {got['tokens']} vs "
          f"{JAX_WHISPER_SERVE['tokens']}; {skipped} tokens past a top-2 margin <= "
          f"{WHISPER_MARGIN_TOL} not compared; launches {counts}")
    _check(counts["flash_attention_fwd"] > 0, "audio vs JAX ran no flash kernel")
    _check(not bad, "audio serving differs from the JAX package: " + "; ".join(bad[:10]))
    return {"counts": counts}


def phase_whisper_train_reference(dev) -> dict:
    """21d (training): WHISPER_TRAIN_REF's two steps of the whisper smoke
    config (float32, 2 + 2 layers, 64 frames: flash at head dim 32 on the
    FP32-FMA route; ``whisper_launches`` a step) on the kernels against
    JAX_WHISPER_TRAIN under WHISPER_REF_TOL."""
    cfg = whisper_train_config()
    _reset_train_counts()
    got = port_whisper_train_reference(cfg, dev)
    counts = _train_counts()
    per = {k: v * WHISPER_TRAIN_REF["steps"] for k, v in whisper_launches(cfg)["train"].items()}
    bad = compare_train(got, JAX_WHISPER_TRAIN, TRAIN["lr"], WHISPER_REF_TOL, WHISPER_TRAIN_LEAVES)
    print(f"audio train vs JAX smoke (float32, {cfg.encdec.encoder_layers} + {cfg.n_layers} "
          f"layers, {WHISPER_TRAIN_REF['steps']} steps of {WHISPER_TRAIN_REF['batch']} x "
          f"{WHISPER_TRAIN_REF['seq_len']}): losses {got['loss']} vs {JAX_WHISPER_TRAIN['loss']}; "
          f"largest differences " + json.dumps(train_max_diff(
              got, JAX_WHISPER_TRAIN, TRAIN["lr"], WHISPER_REF_TOL, WHISPER_TRAIN_LEAVES))
          + f"; launches {counts}")
    _check(counts == per, f"audio train reference launches {counts}, want {per}")
    _check(not bad, "audio training differs from the JAX package: " + "; ".join(bad[:10]))
    return {"counts": counts}


# The ssm training slice (phase 22): rwkv6-7b at its published width (d_model
# 4096, 64 heads of 64, d_ff 14336, vocab 65536, bf16) cut to 16 of its 32
# layers and nothing else (4.06 B parameters: its bf16 weights and
# gradients and AdamW's float32 moments take ~49 GB, where the whole model's
# 7.58 B would take ~91 GB, past one 80 GB card), weights drawn on the card
# by ``transformer.init`` from ``seed``; trained with ``remat="block"`` (one
# checkpoint a block), AdamW(lr=1e-3) with its float32 moments and weight
# decay 0.1, 4 x 512 tokens of ``SyntheticLMDataset`` a step, the schedule
# warmed up in one step as TRAIN's; ``train()`` with the launcher's PowerSim
# for ``power_steps`` steps.  The recurrence runs the plain chunk-parallel
# form under the recorded graph (``ops.rwkv6_scan``), as the reference
# trains it: its kernel, and the port's, have no backward.
RWKV_TRAIN = dict(arch="rwkv6_7b", n_layers=16, seed=0, batch=4, seq_len=512, lr=1e-3,
                  total_steps=10, warmup_steps=1, steps=4, power_steps=4)
# The leaves whose first moment and updated values the training checks
# sample (layer 0 of the stack): the time mix's receptance projection,
# decay base and bonus (both float32, the last two rank-1/2 leaves decayed
# as stacked), the channel mix's key projection, an in-block norm scale,
# ln_f and the head.
RWKV_TRAIN_LEAVES = ("blocks.time.wr.kernel", "blocks.time.decay_base", "blocks.time.u_bonus",
                     "blocks.channel.wk.kernel", "blocks.ln1.scale", "ln_f.scale",
                     "lm_head.kernel")
# What tests/test_torch_rwkv6_train_reference.py runs through the JAX
# package on the CPU and what the card's run is held to (phase 22c): the
# rwkv6 smoke config (2 layers, d_model 128, 2 heads of 64) in float32, 4 x
# 128 tokens (4 chunks of 32 a sequence: the chunk-parallel form on both
# sides) a step, 2 steps from ``random_lm_tree(cfg, TRAIN["seed"])``, the
# data seed, AdamW and the schedule of TRAIN (those of RWKV_TRAIN).
RWKV_TRAIN_REF = dict(dtype="float32", batch=4, seq_len=128, steps=2)
# Tolerances of RWKV_TRAIN_REF against the JAX package, float32: those of
# HYBRID_REF_TOL (loss 2e-5 absolute, grad norm 2e-5 relative, m 1e-3 of
# the leaf's largest sampled |m|, parameters 4 float32 ulps plus 1e-3 lr
# per step where the moment is clear of zero; MOE_REF_TOL's reasons).  The
# port's plain versions on the CPU measured against it (``train_max_diff``,
# printed by ``python tests/test_torch_rwkv6_train_reference.py --port``):
# RWKV_REF_MEASURED, 20-140x inside each bound.
RWKV_REF_TOL = HYBRID_REF_TOL
RWKV_REF_MEASURED = {"loss": 4.76837158203125e-07, "grad_norm": 9.230038637710908e-07,
                     "m": 9.726383894905214e-06, "update_frac": 6.984919309616089e-06}
# The JAX package's numbers for RWKV_TRAIN_REF, on the CPU (jax 0.9.0),
# printed by ``python tests/test_torch_rwkv6_train_reference.py``.
JAX_RWKV_TRAIN = {'grad_norm': [24.208961486816406, 24.797494888305664],
                  'loss': [6.804034233093262, 6.318443298339844],
                  'm': [{'blocks.channel.wk.kernel': [3.9903267179397517e-07, 4.518956848187372e-05,
                                                      3.3772765164030716e-05, 2.711888555495534e-05,
                                                      9.775291982805356e-05, -1.6340256934199715e-06,
                                                      -3.0353316105902195e-05, -6.926159403519705e-05,
                                                      8.633958714199252e-06, -5.243258783593774e-05,
                                                      2.1375972210080363e-05, 1.4748006833542604e-05,
                                                      -3.7237957712932257e-06, -9.939421033777762e-06,
                                                      -3.386006210348569e-05, -1.111283836507937e-05],
                         'blocks.ln1.scale': [-0.0002874102792702615, -1.818866076064296e-05,
                                              1.0951152034976985e-05, 0.0001252395595656708,
                                              -0.00011747309326892719, -1.1386152436898556e-05,
                                              -5.554278686759062e-05, -0.00014828890562057495,
                                              -0.00012065167538821697, 0.0001933256135089323,
                                              -0.0001377436419716105, -7.734825339866802e-05,
                                              0.00015440963034052402, 0.0001492621813667938,
                                              0.00020319312170613557, 0.00012577150482684374],
                         'blocks.time.decay_base': [3.5370594559935853e-06, 4.116242507734569e-06,
                                                    9.46812292568211e-07, -5.615383429358189e-07,
                                                    6.204823876032606e-06, -7.335385362239322e-06,
                                                    -2.296991397088277e-06, 1.0466577577972203e-06,
                                                    -4.127639840589836e-06, 6.128772838565055e-06,
                                                    9.768283234734554e-06, -1.6169342416105792e-06,
                                                    -7.752601050015073e-06, -6.242677955015097e-06,
                                                    -4.526297288975911e-06, -1.0175384659305564e-06],
                         'blocks.time.u_bonus': [5.1555357458710205e-06, 8.183978934539482e-05,
                                                 -5.6286993640242144e-05, -4.2282794311176986e-05,
                                                 -6.206173111422686e-06, -1.5191180864349008e-05,
                                                 2.8673546239588177e-06, 8.342120963789057e-06,
                                                 -4.2138930439250544e-05, 1.680937384662684e-05,
                                                 -5.680103276972659e-05, 1.0130210284842178e-05,
                                                 -3.3318188798148185e-05, -1.389549993291439e-06,
                                                 1.2505685845098924e-05, -2.611618947412353e-05],
                         'blocks.time.wr.kernel': [-0.00010393578850198537, -6.986188236624002e-05,
                                                   1.7740503608365543e-05, 7.618492963956669e-05,
                                                   -2.938663055829238e-05, 2.288276118633803e-05,
                                                   -1.794637501006946e-05, -0.00010274577653035522,
                                                   0.00013370973465498537, -4.655265001929365e-05,
                                                   8.677036385051906e-05, 7.297257980098948e-05,
                                                   0.00017168068734463304, 6.453151581808925e-05,
                                                   6.622004002565518e-05, -9.343001147499308e-05],
                         'lm_head.kernel': [-8.096398232737556e-05, -1.3787172292722971e-06,
                                            -7.839115028218657e-07, -2.8137271783634787e-06,
                                            -6.751826276740758e-06, 5.083479663881008e-06, -8.353226235158218e-07,
                                            -2.266229785163887e-06, -1.5575095630993019e-06, 7.882803032543961e-08,
                                            -8.17451291368343e-06, -1.3163866015020176e-06, 1.3821090760757215e-06,
                                            -9.945939893896139e-08, -4.226867531542666e-06,
                                            -1.993836121982895e-06],
                         'ln_f.scale': [1.9690600311150774e-05, 1.8335204003960826e-05, -2.1525669581023976e-05,
                                        4.587029980029911e-05, 3.965809446526691e-05, 0.00011862234532600269,
                                        4.3736668885685503e-05, 5.8638561313273385e-05, 4.117183561902493e-05,
                                        -4.82830409964663e-06, 5.0797239964595065e-05, -4.7128094593063e-05,
                                        -3.373336949152872e-05, 2.3778840841259807e-05, 3.9871458284324035e-05,
                                        7.081525109242648e-05]},
                        {'blocks.channel.wk.kernel': [4.643667580239708e-06, 3.4720349503913894e-05,
                                                      6.28506313660182e-05, 3.135176302748732e-05,
                                                      3.75651397916954e-05, 5.2695919293910265e-05,
                                                      -1.9453631466603838e-05, -0.00021327096328604966,
                                                      9.272790521208663e-06, -6.943581684026867e-05,
                                                      -2.1072584786452353e-05, 3.72845861420501e-05,
                                                      1.0142141036340035e-05, -5.217679790803231e-05,
                                                      -3.2881747756619006e-05, -8.905101822165307e-06],
                         'blocks.ln1.scale': [-0.0004126426938455552, 0.00029926534625701606,
                                              -9.617613977752626e-05, 0.00036880900734104216,
                                              -0.00017236173152923584, 5.873350892215967e-05,
                                              -4.3837615521624684e-05, 0.00016998525825329125,
                                              -9.106695506488904e-05, 0.00011467936565168202,
                                              -0.00012772927584592253, 0.0001781421306077391,
                                              0.0001940158399520442, 0.00012418671394698322,
                                              0.00015293816977646202, -7.465152157237753e-05],
                         'blocks.time.decay_base': [-4.060688297613524e-06, 1.156993312179111e-05,
                                                    -1.18523553283012e-06, 5.556929409067379e-06,
                                                    1.547331157780718e-05, -9.721049536892679e-06,
                                                    -3.4039428555843187e-06, 4.499096576182637e-06,
                                                    1.704700366644829e-06, 3.633672804426169e-06,
                                                    7.056380127323791e-06, -4.024716872663703e-06,
                                                    -3.454172485817253e-07, -5.6317680900974665e-06,
                                                    -5.630219675367698e-06, -5.446972863865085e-06],
                         'blocks.time.u_bonus': [-5.995323704155453e-07, 6.41425940557383e-05,
                                                 -5.20721405337099e-05, -3.4801596484612674e-05,
                                                 -5.93481104260718e-07, -2.514787411200814e-05,
                                                 -3.2603536965325475e-05, -8.764088852331042e-05,
                                                 -4.767527207150124e-05, 5.959686404821696e-06,
                                                 -8.862252434482798e-05, -0.00010927727271337062,
                                                 -5.8408397308085114e-05, -7.810149691067636e-05,
                                                 2.8889939130749553e-05, -8.845412594382651e-06],
                         'blocks.time.wr.kernel': [-8.179394353646785e-05, -0.0001244839804712683,
                                                   5.9020625485572964e-05, 4.210046972730197e-05,
                                                   2.085937921947334e-06, -7.981371709320229e-06,
                                                   -5.371997303882381e-06, -6.527044024551287e-05,
                                                   0.00014030399324838072, 3.2246778573608026e-05,
                                                   7.185604317783145e-06, 1.9082666767644696e-05,
                                                   0.00014889822341501713, 6.868708442198113e-05,
                                                   -3.2901600206969306e-05, -7.21388787496835e-05],
                         'lm_head.kernel': [-7.177898078225553e-05, -7.589081292280753e-07, 0.0001288020721403882,
                                            -3.877183189615607e-06, -1.6462650819448754e-05,
                                            6.5593717408773955e-06, -1.970614221136202e-06, -6.687615496048238e-06,
                                            2.8258994007046567e-06, 2.2494357381219743e-06, -1.411733956047101e-05,
                                            -3.965553332818672e-06, 2.6131936010642676e-06, 5.35045387550781e-07,
                                            -1.0310425750503782e-05, -5.328923180059064e-06],
                         'ln_f.scale': [7.809984526829794e-05, 2.3553129722131416e-05, -1.7424148609279655e-05,
                                        -5.572372174356133e-05, 3.731853939825669e-05, 0.00013340555597096682,
                                        0.00012378014798741788, 3.447047856752761e-05, 0.00010542218660702929,
                                        3.444387039053254e-05, 2.971560570586007e-05, -2.6994979634764604e-05,
                                        5.726516246795654e-05, 5.119597335578874e-05, 3.389504490769468e-05,
                                        6.001982546877116e-05]}],
                  'params': {'blocks.channel.wk.kernel': [-0.09318860620260239, 0.09781331568956375,
                                                          0.0973394513130188, 0.13156911730766296,
                                                          -0.02077224664390087, -0.043810829520225525,
                                                          0.00279451091773808, -0.03948444128036499,
                                                          -0.07052335888147354, -0.06441696733236313,
                                                          -0.0016441586194559932, 0.047927819192409515,
                                                          0.1772075742483139, -0.07296875864267349,
                                                          0.1647704690694809, -0.039342209696769714],
                             'blocks.ln1.scale': [1.0017486810684204, 1.0001040697097778, 0.9994634985923767,
                                                  0.9978446364402771, 1.001756191253662, 1.000182032585144,
                                                  1.0013912916183472, 1.0004281997680664, 1.001362919807434,
                                                  0.9983734488487244, 1.0014989376068115, 1.0002943277359009,
                                                  0.9979103207588196, 0.998174250125885, 0.9982389211654663,
                                                  0.9990447163581848],
                             'blocks.time.decay_base': [-5.999427795410156, -6.000762462615967,
                                                        -5.9994096755981445, -5.998472690582275,
                                                        -6.000781059265137, -5.996884822845459,
                                                        -5.9968414306640625, -6.000692367553711, -5.99798583984375,
                                                        -6.0002264976501465, -6.000335693359375,
                                                        -5.996819972991943, -5.997775077819824, -5.997120380401611,
                                                        -5.9969162940979, -5.996938705444336],
                             'blocks.time.u_bonus': [0.026058489456772804, 0.19837328791618347,
                                                     -0.022178972139954567, 0.05376410484313965,
                                                     -0.012829500250518322, -0.08005740493535995,
                                                     -0.007561278063803911, 0.15085266530513763,
                                                     -0.012682542204856873, 0.01282851118594408,
                                                     -0.05123031511902809, 0.022145774215459824,
                                                     0.10128791630268097, 0.15630069375038147, 0.19496579468250275,
                                                     0.074583999812603],
                             'blocks.time.wr.kernel': [-0.15534445643424988, 0.022534292191267014,
                                                       0.03874018415808678, -0.06889539211988449,
                                                       0.07164468616247177, -0.025657253339886665,
                                                       -0.050426676869392395, -0.07961621135473251,
                                                       -0.033954475075006485, 0.06623782962560654,
                                                       -0.10700678825378418, -0.07942654937505722,
                                                       0.037188779562711716, -0.05698637291789055,
                                                       -0.026640135794878006, 0.029485436156392097],
                             'lm_head.kernel': [-0.01264712680131197, 0.08589508384466171, -0.02055339515209198,
                                                -0.029765287414193153, 0.05324278771877289, 0.04439357668161392,
                                                -0.02473299391567707, -0.031056955456733704, -0.1450079083442688,
                                                0.06318812072277069, 0.13150335848331451, 0.13258692622184753,
                                                0.12403741478919983, 0.04432746767997742, 0.044479165226221085,
                                                -0.0040787700563669205],
                             'ln_f.scale': [0.9980940818786621, 0.9980990886688232, 1.0016076564788818,
                                            0.9993834495544434, 0.9982910752296448, 0.9981736540794373,
                                            0.9980380535125732, 0.998577892780304, 0.9980226755142212,
                                            1.000351905822754, 0.998580276966095, 1.0014094114303589,
                                            1.0005502700805664, 0.9980032444000244, 0.9983598589897156,
                                            0.9983618259429932]}}
# Phase 22d: int8 compression with error feedback on the step's gradients
# of ``blocks.0.*`` and the head (488 M elements; the whole tree's float32
# error state would take 16 GB).  ``rounds`` rounds on the card, round 0 on
# the bf16 gradients and round i > 0 on them widened and scaled by the
# float32 factor ``factors[i]`` (numpy, ``seed``); the first ``host_rounds``
# held bit for bit to the same functions on host copies on the CPU (each
# operation is correctly rounded on both); after all rounds the summed
# residual |sum(sent) - sum(true)| of every leaf, in float64, below one
# quantization step (the last round's scale).
COMPRESS = dict(rounds=8, host_rounds=2, seed=11)


def rwkv_train_config():
    """RWKV_TRAIN's config: rwkv6-7b at full width with its depth cut."""
    import dataclasses

    from repro_torch.configs import full_config

    return dataclasses.replace(full_config(RWKV_TRAIN["arch"]), n_layers=RWKV_TRAIN["n_layers"])


def rwkv_ref_config():
    """RWKV_TRAIN_REF's config: the rwkv6 smoke config in float32."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(RWKV_TRAIN["arch"]), dtype=RWKV_TRAIN_REF["dtype"])


def rwkv_train_launches(cfg, seq_len: int) -> dict:
    """The kernel launches and plain scan calls of a ``build_train_step``
    step of the ``ssm`` config ``cfg`` with ``remat="block"`` on
    ``seq_len`` tokens: each block's three norms (``ln1``, ``ln_x``,
    ``ln2``) in the forward and again in its recompute, ``ln_f`` once; no
    ``rwkv6_scan`` launch (a recorded graph takes the plain forms), and
    the plain chunked form (``seq_len`` a multiple of 32 above 32) or the
    sequential scan twice a block (the forward and the recompute)."""
    nl = cfg.n_layers
    chunked = seq_len > 32 and seq_len % 32 == 0
    return {"kernels": {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
                        "flash_attention_bwd_dq": 0, "rmsnorm": 2 * 3 * nl + 1},
            "rwkv6_scan": 0,
            "plain": {"rwkv6_chunked": 2 * nl if chunked else 0,
                      "rwkv6_scan": 0 if chunked else 2 * nl}}


def port_rwkv_train_reference(cfg, dev, ref: dict = RWKV_TRAIN_REF) -> dict:
    """``ref``'s steps of ``cfg`` through the port on ``dev`` from
    ``random_lm_tree(cfg, TRAIN["seed"])`` (``port_train_reference``)."""
    from repro_torch import convert

    model = convert.lm_params_from_numpy(convert.random_lm_tree(cfg, TRAIN["seed"]), cfg,
                                         device=dev)
    return port_train_reference(model, cfg, dev, ref, RWKV_TRAIN_LEAVES)


class _RwkvTrainCalls:
    """The training kernels' launches, ``rwkv6_scan``'s, and the plain
    scan forms' calls inside the block (``.counts``, ``.scan``,
    ``.plain``), the counters set to 0 on entry."""

    def __enter__(self):
        from repro_torch.kernels import rwkv6_scan as rw

        self._plain = {n: _PlainCalls(n) for n in ("rwkv6_chunked", "rwkv6_scan")}
        for p in self._plain.values():
            p.__enter__()
        _reset_train_counts()
        rw.rwkv6_scan.launches = 0
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import rwkv6_scan as rw

        self.counts, self.scan = _train_counts(), rw.rwkv6_scan.launches
        self.plain = {n: p.n for n, p in self._plain.items()}
        for p in self._plain.values():
            p.__exit__(*exc)
        return False


def _rwkv_train_model(dev):
    """RWKV_TRAIN's model, drawn on the card."""
    import torch

    from repro_torch.models import transformer as T

    cfg = rwkv_train_config()
    _check(cfg.family == "ssm" and cfg.dtype == "bfloat16" and cfg.remat == "block"
           and cfg.d_model == 4096 and cfg.d_ff == 14336 and cfg.vocab_size == 65536,
           "rwkv6-7b trains at its published width in bf16 with remat")
    t0 = time.perf_counter()
    model = T.init(cfg, device=dev, generator=torch.Generator(dev).manual_seed(RWKV_TRAIN["seed"]))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    print(f"rwkv train: {cfg.name} cut to {cfg.n_layers} layers, {n} parameters ({gib:.2f} GiB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    return model


def phase_rwkv_train(dev, model, profile_dir: Path | None = None) -> dict:
    """22a-b: ``model`` (RWKV_TRAIN: rwkv6-7b at full width, 16 layers,
    bf16) trained with ``build_train_step``, ``remat="block"`` and AdamW's
    float32 moments.  Step 1 on the plain versions (``ops.forced("ref")``),
    then from the same start (the weights drawn again from the seed, fresh
    moments) the same step on the kernels, held to it under TRAIN_TOL on
    RWKV_TRAIN_LEAVES; the kernel step once more from the same start, whose
    parameters and first moment must equal the first kernel run's bit for
    bit (``_bit_prints``); then ``steps - 1`` more kernel steps, timed.
    Every kernel step must launch ``rwkv_train_launches``: rmsnorm 97,
    ``rwkv6_scan`` none, the plain chunked form 32 times; the plain step
    no kernel.  ``train_mfu`` counts 6 ``cfg.param_count()`` tokens a
    step.  Returns the numbers and the gradients of ``blocks.0.*`` and the
    head at the trained weights (22d's input)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import build_train_step
    from repro_torch.train.step import loss_fn

    t_phase = time.perf_counter()
    cfg, tr = model.cfg, RWKV_TRAIN
    b, t = tr["batch"], tr["seq_len"]
    opt = AdamWConfig(lr=tr["lr"])
    step = build_train_step(cfg, opt, total_steps=tr["total_steps"],
                            warmup_steps=tr["warmup_steps"])
    ds = SyntheticLMDataset(DataConfig(seed=tr["seed"], batch=b, seq_len=t,
                                       vocab_size=cfg.vocab_size))
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())

    def restore():  # the start again: T.init's draws from the same seed
        L.init_weights_(model, torch.Generator(dev).manual_seed(tr["seed"]))

    want_calls = rwkv_train_launches(cfg, t)
    per_step = want_calls["kernels"]
    batch0 = ds.batch_at(0)

    # (1) Step 1 on the plain versions.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _RwkvTrainCalls() as plain_calls, ops.forced("ref"):
        _, st, mp = step(model, adamw_init(params, opt), batch0, 0)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(plain_calls.counts == dict.fromkeys(per_step, 0) and plain_calls.scan == 0
           and plain_calls.plain == want_calls["plain"],
           f"rwkv train plain step launched {plain_calls.counts}, rwkv6_scan {plain_calls.scan}, "
           f"plain scans {plain_calls.plain}")
    want = _step_summary(model, st, mp, RWKV_TRAIN_LEAVES)
    del st, mp
    restore()

    # (2) The same step on the kernels, (3) once more, (4) the other steps.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, calls = [], []

    def kernel_step(i, state):
        with _RwkvTrainCalls() as c:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, metrics = step(model, state, ds.batch_at(i), i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        calls.append(c)
        return state, metrics

    state, mk = kernel_step(0, adamw_init(params, opt))
    got = _step_summary(model, state, mk, RWKV_TRAIN_LEAVES)
    prints = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    del state, mk
    restore()
    state, mk = kernel_step(0, adamw_init(params, opt))
    again = _bit_prints({**params, **{"m." + n: x for n, x in state.m.items()}})
    differ = sorted(n for n in prints if prints[n] != again[n])
    losses = [float(mk["loss"])]
    for i in range(1, tr["steps"]):
        state, mk = kernel_step(i, state)
        losses.append(float(mk["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if profile_dir is not None:
        bp = ds.batch_at(tr["steps"])
        profile_run("rwkv_train_step",
                    lambda: _timed(lambda: step(model, state, bp, tr["steps"])), profile_dir)
    del state, mk
    bad = compare_train(got, want, tr["lr"], TRAIN_TOL, RWKV_TRAIN_LEAVES)
    warm = walls[2:]
    step_s = statistics.median(warm)
    tokens = b * t
    mfu = 6.0 * cfg.param_count() * tokens / (step_s * BF16_FLOP_PER_S)
    last = calls[-1]
    print(f"rwkv train {cfg.name} {cfg.n_layers} layers, {n_params} parameters (bf16, "
          f"remat={cfg.remat} a block, AdamW float32 moments), {b} x {t} tokens: plain step "
          f"{plain_s:.3f} s, kernel step walls {[round(w, 4) for w in walls]} s (two step-1 runs, "
          f"then steps 2-{tr['steps']}), losses {losses}, launches a step {last.counts}, "
          f"rwkv6_scan {last.scan}, plain scan calls {last.plain}, peak {peak:.2f} GiB allocated")
    print("rwkv train step 1, kernels vs plain versions: "
          + json.dumps(train_max_diff(got, want, tr["lr"], TRAIN_TOL, RWKV_TRAIN_LEAVES)))
    print("rwkv train step 1 twice on the kernels from the same start: "
          + ("the same bits (parameters and first moment)" if not differ else
             f"{len(differ)} leaves differ: {differ[:12]}"))
    print(f"rwkv train warm steps {[round(w, 4) for w in warm]} s, median {step_s:.4f} s, "
          f"{tokens / step_s:.1f} tokens/s, train_mfu {mfu:.4f} (6 N tokens / (step time x 989 "
          f"TFLOP/s), N = param_count() {cfg.param_count()}; the model holds {n_params}; remat "
          f"executes ~8 N)")
    _check(all(c.counts == per_step and c.scan == 0 and c.plain == want_calls["plain"]
               for c in calls),
           f"rwkv train launches {[(c.counts, c.scan, c.plain) for c in calls]}, want "
           f"{want_calls}")
    _check(all(map(math.isfinite, losses)), f"rwkv train losses {losses}")
    _check(not bad, "rwkv train step 1, kernels vs plain versions: " + "; ".join(bad[:10]))
    _check(not differ, f"rwkv train step 1 twice on the kernels: {differ[:12]} differ")

    # The gradients of blocks.0.* and the head at the trained weights.
    sel = [n for n in params if n.startswith("blocks.0.")] + ["lm_head.kernel"]
    batch = {k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(tr["steps"] + 1).items()}
    loss, _ = loss_fn(model, batch)
    grads = dict(zip(sel, torch.autograd.grad(loss, [params[n] for n in sel])))
    del loss
    wall = time.perf_counter() - t_phase
    print(f"rwkv train: phase {wall:.1f} s")
    return {"counts": {k: sum(c.counts[k] for c in calls) for k in per_step},
            "per_step": per_step, "plain_per_step": want_calls["plain"], "walls": walls,
            "step_s": step_s, "tokens_per_s": tokens / step_s, "train_mfu": mfu,
            "peak_gib": peak, "plain_step_s": plain_s, "same_bits": not differ,
            "phase_s": wall, "grads": grads}


def phase_rwkv_compression(dev, grads: dict) -> dict:
    """22d: ``compress_int8`` / ``decompress_int8`` (COMPRESS) on the card
    on ``grads`` (bf16, ``blocks.0.*`` and the head), the first
    ``host_rounds`` held bit for bit (int8 values, scales and the error
    state) to the same functions on host copies on the CPU, and the summed
    residual of every leaf after all rounds below one quantization step."""
    import numpy as np
    import torch

    from repro_torch.optim import compress_int8, decompress_int8, init_compression

    c = COMPRESS
    t_phase = time.perf_counter()
    factors = [1.0] + [float(np.float32(f)) for f in
                       1.0 + 0.5 * np.random.default_rng(c["seed"]).standard_normal(c["rounds"] - 1)]
    n_el = sum(g.numel() for g in grads.values())

    def round_input(g: dict, i: int) -> dict:
        return g if i == 0 else {n: x.float() * factors[i] for n, x in g.items()}

    state = init_compression(grads)
    sum_true = {n: torch.zeros(g.shape, dtype=torch.float64, device=dev) for n, g in grads.items()}
    sum_sent = {n: torch.zeros_like(s) for n, s in sum_true.items()}
    card, ms = [], []
    for i in range(c["rounds"]):
        g = round_input(grads, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, state = compress_int8(g, state)
        sent = decompress_int8(q)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for n in grads:
            sum_true[n] += g[n].double()
            sum_sent[n] += sent[n].double()
        if i < c["host_rounds"]:
            card.append(({n: v.cpu() for n, v in q.values.items()},
                         {n: s.cpu() for n, s in q.scales.items()},
                         {n: e.cpu() for n, e in state.error.items()}))
        del g, sent
    resid = {n: float((sum_sent[n] - sum_true[n]).abs().max()) for n in grads}
    steps = {n: float(s) for n, s in q.scales.items()}
    over = sorted(n for n in grads if not resid[n] < steps[n])
    del sum_true, sum_sent, state, q
    t0 = time.perf_counter()
    host = {n: g.cpu() for n, g in grads.items()}
    hstate = init_compression(host)
    differ = []
    for i in range(c["host_rounds"]):
        hq, hstate = compress_int8(round_input(host, i), hstate)
        values, scales, error = card[i]
        for n in host:
            for what, a, b in (("values", values[n], hq.values[n]),
                               ("scale", scales[n], hq.scales[n]),
                               ("error", error[n], hstate.error[n])):
                if not torch.equal(a, b):
                    differ.append(f"round {i} {n} {what}")
    host_s = time.perf_counter() - t0
    del host, hstate, card
    wall = time.perf_counter() - t_phase
    worst = max(resid, key=lambda n: resid[n] / steps[n])
    print(f"rwkv compression: {len(grads)} leaves, {n_el} elements (blocks.0.* and the head), "
          f"{c['rounds']} rounds of compress_int8 + decompress_int8 on the card "
          f"{[round(x, 3) for x in ms]} ms; rounds 1-{c['host_rounds']} against the CPU: "
          + ("the same bits (int8 values, scales, error state)" if not differ else
             f"{len(differ)} differ: {differ[:8]}")
          + f" ({host_s:.1f} s on the host); summed residual / last scale up to "
          f"{resid[worst] / steps[worst]:.4f} ({worst}: {resid[worst]:.3e} / {steps[worst]:.3e}); "
          f"phase {wall:.1f} s")
    _check(not differ, f"compression on the card vs the CPU: {differ[:8]}")
    _check(not over, f"compression summed residual past one quantization step: {over[:8]}")
    return {"round_ms": ms, "elements": n_el, "same_bits": not differ,
            "resid_over_step": resid[worst] / steps[worst], "phase_s": wall}


def phase_rwkv_train_reference(dev) -> dict:
    """22c: RWKV_TRAIN_REF's two steps of the rwkv6 smoke config (float32,
    2 layers, 4 x 128 tokens: the plain chunked form, rmsnorm on the
    kernel, ``rwkv_train_launches`` a step) against JAX_RWKV_TRAIN under
    RWKV_REF_TOL."""
    cfg = rwkv_ref_config()
    r = RWKV_TRAIN_REF
    with _RwkvTrainCalls() as calls:
        got = port_rwkv_train_reference(cfg, dev)
    want_calls = rwkv_train_launches(cfg, r["seq_len"])
    per = {k: v * r["steps"] for k, v in want_calls["kernels"].items()}
    plain = {k: v * r["steps"] for k, v in want_calls["plain"].items()}
    bad = compare_train(got, JAX_RWKV_TRAIN, TRAIN["lr"], RWKV_REF_TOL, RWKV_TRAIN_LEAVES)
    print(f"rwkv train vs JAX smoke (float32, {cfg.n_layers} layers, {r['steps']} steps of "
          f"{r['batch']} x {r['seq_len']}): losses {got['loss']} vs {JAX_RWKV_TRAIN['loss']}; "
          f"largest differences " + json.dumps(train_max_diff(
              got, JAX_RWKV_TRAIN, TRAIN["lr"], RWKV_REF_TOL, RWKV_TRAIN_LEAVES))
          + f" (the port on the CPU: {json.dumps(RWKV_REF_MEASURED)}); launches {calls.counts}, "
          f"rwkv6_scan {calls.scan}, plain scan calls {calls.plain}")
    _check(calls.counts == per and calls.scan == 0 and calls.plain == plain,
           f"rwkv train reference launches {calls.counts}, {calls.scan}, {calls.plain}")
    _check(not bad, "rwkv training differs from the JAX package: " + "; ".join(bad[:10]))
    return {"counts": calls.counts}


def phase_rwkv_train_power(dev) -> dict:
    """22a (``train()``): RWKV_TRAIN's model through ``train()`` with the
    launcher's PowerSim (``phase_train_power``), no ``rwkv6_scan`` launch
    and the plain chunked form twice a block a step."""
    from repro_torch.kernels import rwkv6_scan as rw

    cfg = rwkv_train_config()
    want = rwkv_train_launches(cfg, RWKV_TRAIN["seq_len"])
    with _PlainCalls("rwkv6_chunked") as plain:
        rw.rwkv6_scan.launches = 0
        out = phase_train_power(dev, cfg, RWKV_TRAIN, want["kernels"])
        scans = rw.rwkv6_scan.launches
    n = RWKV_TRAIN["power_steps"]
    _check(scans == 0 and plain.n == want["plain"]["rwkv6_chunked"] * n,
           f"rwkv train() rwkv6_scan {scans}, plain chunked calls {plain.n}")
    return dict(out, plain_chunked=plain.n)


# The kernel-level entry (phase 11): benchmarks/kernel_benches.py's shapes
# (60 s x 128 racks at 1 kHz, the prototype-rack filter sized for beta =
# 0.0625, zero corrective; 12 % of racks degraded with a 4 s wind-down ramp
# for the (T, R) weight) and the whole acceptance campus in one launch.
# At the bench shape the plain versions run over the first ``plain_t``
# samples only: their Python loop of ~60 small operations a sample took
# ~3.5 minutes over all 60000 samples of the four runs, and the script
# must stay within its time limit.  The kernel runs and is timed over all
# of them, its first ``plain_t`` samples held bit for bit to the plain run.
# The kernels line carries those plain times as ``bench_plain_ms_<plain_t>``
# (``bench_plain_ms``, of earlier versions of this script, timed all 60000
# samples).  The (R,)-weight row's ``ms``, ``plain_ms`` and ``bound_ms`` are
# the campus's, as its two siblings' (earlier versions: the bench shape's,
# which its ``bench_ms`` and ``bench_bound_ms`` carry now).
SIM_BENCH = dict(t=60_000, r=128, dt=1e-3, beta=0.0625, seed=0, degraded=0.12, ramp_s=4.0,
                 plain_t=6000)
PDU_KW = dict(beta=0.0625, dt=1e-3, q_max=40.0, eta_c=0.97, eta_d=0.97, p_max=1.0, soc_min=0.1,
              soc_max=0.9)
# gemm_burn: bench_gemm_burn's 512^3 float32 with n_iters = 4, and 4096^3
# bfloat16 with n_iters 1, 4 and 8; then ragged cases (dtype, M, K, N,
# n_iters): bfloat16 of about 1000^3 (K and N zero-padded to multiples of 8
# for the tensor maps), and float32 with K split into 6 ranges of 96 whose
# last is 40 long (the output's 40 tiles leave SMs idle).
GEMM_CASES = (("float32", 512, (4,)), ("bfloat16", 4096, (1, 4, 8)))
GEMM_RAGGED = (("bfloat16", 1000, 998, 1001, 4), ("float32", 300, 520, 200, 3))
# The redesigned kernels' times before their redesign, when they ran FP32
# FMAs from shared memory (this script's kernels line on an NVIDIA H100
# 80GB HBM3 at 700 W): 4096^3 bf16 x 4, 512^3 f32 x 4, the prefill flash
# forward, and the training shape's flash backward (dK/dV, dQ).  Recorded
# constants: printed, marked as such, and kept out of the kernels line,
# which holds only what this run measured.
FMA_KERNEL_MS = {"gemm_burn": 18.972000122070312, "gemm_burn_f32": 0.3409920036792755,
                 "flash_attention_fwd": 0.22044800221920013,
                 "flash_attention_bwd_dkv": 0.46799999475479126,
                 "flash_attention_bwd_dq": 0.3270080089569092}
# The times of admm_step and rwkv6_scan before their redesign for the H100
# (one thread a rack; one thread a state column with the bonus inside the
# (D, D) loop and a barrier a step), from this script's kernels line on an
# NVIDIA H100 80GB HBM3 at 700 W: the campus QP (h = 12, R = 1024), the
# rwkv prefill (4, 64, 512, 64) bf16 and its decode step.  Recorded
# constants: printed, marked as such, and kept out of the kernels line.
PREVIOUS_KERNEL_MS = {"admm_step": 0.350271999835968, "rwkv6_scan": 0.43558400869369507,
                      "rwkv6_scan_decode": 0.0072639998979866505,
                      # pdu_health and pdu_sim before the warp-specialised
                      # pipeline (one thread a rack, 32 a block, loads 8
                      # samples ahead): the campus interval clean and in each
                      # weight mode; pdu_sim at 17600 x 1024 and 60000 x 128
                      "pdu_health": 0.10364799946546555, "pdu_health_ess_row": 0.1252799928188324,
                      "pdu_health_ess_series": 0.12051200121641159,
                      "pdu_health_ess_events_edge1": 0.29843199253082275,
                      "pdu_health_ess_events_edge50": 0.3129599988460541,
                      "pdu_sim": 2.272752046585083, "pdu_sim_weight_series": 2.5074559450149536,
                      "pdu_sim_bench": 7.231215953826904,
                      "pdu_sim_weight_series_bench": 8.196144104003906,
                      "pdu_sim_weight_row_bench": 7.667616128921509,
                      # lc_filter before its redesign on the pipeline (one
                      # thread a rack, 32 a block, loads 8 samples ahead):
                      # 17600 x 1024 and 60000 x 128
                      "lc_filter": 1.5339040160179138, "lc_filter_bench": 4.760495901107788,
                      # rmsnorm before its redesign (one block a row above
                      # D = 256, the weight read after the reduction), warm,
                      # over 2048 rows bf16 by D, from this script's kernels
                      # line on an NVIDIA H100 80GB HBM3 at 700 W
                      "rmsnorm_512": 0.00723200011998415, "rmsnorm_1536": 0.007935999892652035,
                      "rmsnorm_2048": 0.008704000152647495, "rmsnorm_5120": 0.01945599913597107,
                      "rmsnorm_7168": 0.02630399912595749}
UNFUSED_TOL = 2e-5  # tests/test_kernels.py: the fused path vs ess -> filters
# The 4096^3 bf16 burn's cost of one more round, from n_iters 1 -> 4 and
# 4 -> 8, must agree within this fraction: the work grows with n_iters and
# nothing of it is folded away (an H100 80GB HBM3 at 700 W read 0.1460 and
# 0.1478 ms, 1.2 % apart; the margin leaves room for clocks that drop
# under the longer load).
GEMM_ROUND_AGREE = 0.10


def _gemm_tol(dtype: str, k: int) -> dict:
    """tests/test_kernels.py's gemm_burn tolerances (atol scales with K)."""
    if dtype == "bfloat16":
        return dict(rtol=3e-2, atol=0.5 * (k / 128))
    return dict(rtol=1e-4, atol=2e-3 * (k / 128))


def _event_ms(fn):
    """``fn()``'s result and its device time in ms (CUDA events, one call):
    for the plain versions, whose one call takes seconds."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _bitwise(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return all(_bitwise(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(a, b))


def degraded_weight(t: int, r: int, dt: float, dev):
    """``bench_pdu_sim_masked``'s availability weights: a (R,) 0/1 row
    with SIM_BENCH's share of racks degraded, and the (T, R) series in
    which those racks wind down linearly over SIM_BENCH's ramp."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SIM_BENCH["seed"] + 7)
    row = (torch.rand(r, generator=gen, device=dev) > SIM_BENCH["degraded"]).to(torch.float32)
    ramp = torch.clamp(torch.arange(t, dtype=torch.float32, device=dev)[:, None]
                       / (SIM_BENCH["ramp_s"] / dt), 0.0, 1.0)
    return (row[None, :] + (1.0 - row[None, :]) * (1.0 - ramp)).contiguous(), row


def sim_bench_problem(dev):
    """kernel_benches.py's lc_filter / pdu_sim problem on ``dev``: the
    filter, the node trace for lc_filter, the rack trace, the initial
    state and the (T, R) and (R,) weights."""
    import torch

    from repro_torch.core import filters, pdu, sizing

    c = SIM_BENCH
    rack = sizing.prototype_rack()
    pp = pdu.per_unit_filter(sizing.size_system(rack, beta=c["beta"]), rack, device=dev)
    filt = filters.make_discrete_filter(pp, c["dt"])
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    t, r = c["t"], c["r"]
    node = 0.5 + 0.3 * torch.rand((t, r), generator=gen, device=dev)
    u = 0.3 + 0.6 * torch.rand((t, r), generator=gen, device=dev)
    x0 = filters.steady_state(filt, torch.tensor([1.0, 0.5], device=dev)).expand(r, 3).contiguous()
    return (filt, node, u, x0) + degraded_weight(t, r, c["dt"], dev)


def sim_campus_problem(dev):
    """The whole acceptance campus (CAMPUS), rendered in one piece, its
    ``make_pdu`` filter and hardware scalars, the initial state and the
    (T, R) and (R,) weights (SIM_BENCH's degraded share and ramp)."""
    from repro_torch.core import pdu
    from repro_torch.power import scenario as SC

    c = CAMPUS
    s = SC.mixed_campus(c["n_racks"], ARCHS, duration_s=c["duration_s"], sample_hz=c["sample_hz"],
                        seed=c["seed"], fault_at_s=c["duration_s"] * 0.6,
                        noise_seed=c["noise_seed"], device=dev)
    rack, dt = SC.render_trace(s)
    cfg = pdu.make_pdu(sample_dt=dt, device=dev)
    st = pdu.init_state(cfg, rack[0])
    return (cfg, st, rack.contiguous()) + degraded_weight(*rack.shape, dt, dev)


def _sim_bytes_ops(t, r, n_in, n_out, ops_per_sample, per_rack_floats) -> tuple[int, int]:
    """Bytes moved once (``n_in`` (T, R) arrays read, ``n_out`` written,
    ``per_rack_floats`` per rack) and float operations of a trace kernel."""
    return 4 * ((n_in + n_out) * t * r + per_rack_floats * r), ops_per_sample * t * r


# Float operations per rack-sample counted from the kernel sources (an FMA
# counts 2): lc_filter grid 5 + three states 8 each; pdu_sim ESS filter 3,
# battery power 4, SoC 7, window + back-off 8, node 1, weight 3 (ignored
# when unweighted), and lc_filter's 29.
LC_OPS, PDU_OPS = 29, 52


def phase_sim_kernels(dev) -> dict:
    """Phase 11: lc_filter, pdu_sim (three weight variants) and gemm_burn
    through ``ops`` at the kernel benches' shapes and over the whole
    campus, each main-path call counted, held against its plain version
    (bitwise for the trace kernels) and timed beside it."""
    import torch

    from repro_torch.core import ess, filters, pdu
    from repro_torch.kernels import gemm_burn, hw_plan, lc_filter, ops, pdu_sim

    kern = {"lc_filter": lc_filter.lc_filter, "pdu_sim": pdu_sim.pdu_sim,
            "gemm_burn": gemm_burn.gemm_burn}
    launches = {}  # main-path launches by kernel entry

    def main_call(name, fn, entry_name=None):
        """One main-path call through ``ops``: it must launch ``name``
        once and nothing else of this phase (counted under ``entry_name``).
        A float32 gemm_burn call split over K also launches its second
        pass, ``gemm_burn_f32_sum``; those launches are counted apart."""
        for f in kern.values():
            f.launches = 0
        gemm_burn.gemm_burn.sum_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in kern.items()}
        _check(got == {k: int(k == name) for k in kern},
               f"{name}: one main-path call must launch it once, got {got}")
        key = entry_name or name
        launches[key] = launches.get(key, 0) + 1
        sums = gemm_burn.gemm_burn.sum_launches
        if sums:
            launches["gemm_burn_f32_sum"] = launches.get("gemm_burn_f32_sum", 0) + sums
        return out

    def kernel_lc(filt, node, x0, prev, plain_t=None):
        """``plain_t``: the plain run covers the first ``plain_t`` samples
        (the kernel's run over them checked whole, the main-path run's
        grid over them)."""
        lc = tuple(m.cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0]))
        out_k = main_call("lc_filter", lambda: ops.lc_filter(*lc, x0, node))
        t, r = node.shape
        tp = t if plain_t is None else plain_t
        node_p = node if tp == t else node[:tp].contiguous()
        out_p, plain_ms = _event_ms(lambda: ops.lc_filter(*lc, x0, node_p, force="ref"))
        out_kp = out_k if tp == t else ops.lc_filter(*lc, x0, node_p, force="cuda")
        _check(_bitwise(out_kp, out_p) and _bitwise(out_k[0][:tp], out_p[0]),
               f"lc_filter {tuple(node.shape)}: kernel vs plain bitwise over {tp} samples")
        ms = _median_ms(lambda: ops.lc_filter(*lc, x0, node), reps=10)
        # The cp.async route (4-byte copies, spread stores) forced on the
        # same trace, timed beside the route the plan picks (TMA at R % 4 ==
        # 0): the same bits.
        plan = hw_plan.lc_plan(r)
        forced = hw_plan.lc_plan(r, loads="cp.async", stores="spread")
        lc_call = lambda p, x=node: lc_filter.lc_filter(*lc, x0.contiguous(), x, plan=p)
        planned_ms = _median_ms(lambda: lc_call(plan), reps=10)
        _check(_bitwise(lc_call(forced, node_p), out_p),
               f"lc_filter T={tp} R={r}: cp.async route vs plain")
        cp_ms = _median_ms(lambda: lc_call(forced), reps=10)
        print(f"lc_filter   T={t} R={r}: grid and final state bitwise vs plain over the first "
              f"{tp} samples; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms over {tp}; the "
              f"{plan.loads} + {plan.stores} route "
              f"{planned_ms:.4f} ms and the cp.async + spread route forced {cp_ms:.4f} ms (both "
              f"through the kernel module; the same bits); before the redesign "
              f"{PREVIOUS_KERNEL_MS[prev]:.4f} ms (a recorded constant)")
        # The first 1, 3 and 33 racks (the cp.async route, blocks of fewer
        # than 32 racks) over the whole trace, against the plain run's first
        # columns; and the first 1, 7, S - 1 and S + 1 samples of every rack
        # on both routes, against plain runs of those samples.
        for rn in (1, 3, 33):
            got = ops.lc_filter(*lc, x0[:rn], node_p[:, :rn].contiguous(), force="cuda")
            ok = _bitwise(got, (out_p[0][:, :rn].contiguous(), out_p[1][:rn]))
            _check(ok, f"lc_filter T={tp} R={rn}: kernel vs the plain run's first racks")
        cuts = (1, 7, plan.chunk - 1, plan.chunk + 1)
        for tn in cuts:
            sub = node[:tn].contiguous()
            want = ops.lc_filter(*lc, x0, sub, force="ref")
            for p in (plan, forced):
                ok = _bitwise(lc_filter.lc_filter(*lc, x0.contiguous(), sub, plan=p), want)
                _check(ok, f"lc_filter T={tn} R={r} {p.loads} + {p.stores}: kernel vs plain")
        print(f"lc_filter   T={tp}: the first 1, 3 and 33 racks bitwise vs the plain run's first "
              f"racks; T = {', '.join(map(str, cuts))} at R={r} on both routes bitwise vs plain")
        return out_k, ms, plain_ms, _sim_bytes_ops(t, r, 1, 1, LC_OPS, 6), cp_ms

    def kernel_pdu(label, filt, rack, g0, soc0, x0, corr, w, kw, prev, narrow=(), plain_t=None):
        """``plain_t``: as ``kernel_lc``'s (the main-path run's grid and SoC
        over the first ``plain_t`` samples, a kernel run over them whole);
        ``prev``: the recorded time before the redesign, or None."""
        lc = tuple(m.cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0]))
        args = (rack, g0, soc0, x0, *lc, corr)
        variant = {None: "pdu_sim", 1: "pdu_sim_weight_row", 2: "pdu_sim_weight_series"}
        out_k = main_call("pdu_sim", lambda: ops.pdu_sim(*args, ess_on=w, **kw),
                          variant[None if w is None else w.ndim])
        t, r = rack.shape
        tp = t if plain_t is None else plain_t
        head = lambda x: x if tp == t else x[:tp].contiguous()
        args_p = (head(rack), g0, soc0, x0, *lc, head(corr))
        w_p = w if w is None or w.ndim == 1 else head(w)
        out_p, plain_ms = _event_ms(lambda: ops.pdu_sim(*args_p, ess_on=w_p, force="ref", **kw))
        out_kp = out_k if tp == t else ops.pdu_sim(*args_p, ess_on=w_p, force="cuda", **kw)
        same = {n: _bitwise(a, b) for n, a, b in zip(("grid", "soc", "finals"), out_kp, out_p)}
        same["main run"] = _bitwise(out_k[0][:tp], out_p[0]) and _bitwise(out_k[1][:tp], out_p[1])
        _check(all(same.values()),
               f"pdu_sim {label} T={t} R={r}: kernel vs plain bitwise over {tp} samples {same}")
        ms = _median_ms(lambda: ops.pdu_sim(*args, ess_on=w, **kw), reps=10)
        n_hi = int((out_k[1] >= kw["soc_max"]).any(0).sum())
        before = "" if prev is None else (f"; before the pipeline redesign "
                                          f"{PREVIOUS_KERNEL_MS[prev]:.4f} ms (a recorded constant)")
        print(f"pdu_sim     {label:<13} T={t} R={r}: grid, SoC, finals bitwise vs plain over the "
              f"first {tp} samples; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms over {tp}; racks "
              f"reaching soc_max {n_hi}{before}")
        # The kernel on the first rn racks against the plain run's first rn
        # columns (the plain version is elementwise across racks): the
        # cp.async route and a block of one or three racks over the whole
        # trace.
        for rn in narrow:
            cut = lambda x: x[..., :rn].contiguous()
            a = (cut(args_p[0]), g0[:rn], soc0[:rn], x0[:rn].contiguous(), *lc, cut(args_p[-1]))
            got = ops.pdu_sim(*a, ess_on=None if w is None else cut(w_p), force="cuda", **kw)
            want = (cut(out_p[0]), cut(out_p[1]),
                    (out_p[2][0][:rn], out_p[2][1][:rn], out_p[2][2][:rn]))
            ok = all(_bitwise(x, y) for x, y in zip(got, want))
            print(f"pdu_sim     {label:<13} T={tp} R={rn}: grid, SoC, finals bitwise vs the plain "
                  f"run's first {rn} racks: {ok}")
            _check(ok, f"pdu_sim {label} T={tp} R={rn}: kernel vs plain not bitwise")
        n_in = 2 + (w is not None and w.ndim == 2)
        per_rack = 10 + (w is not None and w.ndim == 1)
        return out_k, ms, plain_ms, _sim_bytes_ops(t, r, n_in, 2, PDU_OPS, per_rack)

    def entry(name, source, replaces, ms, plain_ms, bo, flop_per_s, library_ms=None, err=0.0,
              **extra):
        # err 0.0: the trace kernels were checked bitwise against their
        # plain versions above.
        return kernel_entry(name, source, replaces, err, ms, plain_ms, library_ms, bo[0], bo[1],
                            flop_per_s, launches=launches.get(name, 0), **extra)

    lc_src, lc_rep = "src/repro_torch/csrc/lc_filter.cu", "src/repro/kernels/lc_filter.py:63"
    ps_src, ps_rep = "src/repro_torch/csrc/pdu_sim.cu", "src/repro/kernels/pdu_sim.py:109"
    gb_src, gb_rep = "src/repro_torch/csrc/gemm_burn.cu", "src/repro/kernels/gemm_burn.py:44"

    # (a) the kernel benches' shapes
    filt, node, u, x0, w_series, w_row = sim_bench_problem(dev)
    bench_t = SIM_BENCH["plain_t"]
    _, lc_b_ms, lc_b_plain, lc_b_bo, lc_b_cp = kernel_lc(filt, node, x0, "lc_filter_bench",
                                                         bench_t)
    r = u.shape[1]
    g0, soc0 = u[0].contiguous(), torch.full((r,), 0.5, device=dev)
    corr = torch.zeros_like(u)
    bench = {label: kernel_pdu(label, filt, u, g0, soc0, x0, corr, w, PDU_KW, prev,
                               narrow=(1, 3), plain_t=bench_t)[1:]
             for label, w, prev in (("unweighted", None, "pdu_sim_bench"),
                                    ("(T, R) weight", w_series, "pdu_sim_weight_series_bench"),
                                    ("(R,) weight", w_row, "pdu_sim_weight_row_bench"))}
    del node, u, corr, w_series

    # (b) the whole campus trace in one launch
    cfg, st, rack, w_series, w_row = sim_campus_problem(dev)
    filt, kw = st.filter_obj, pdu.hw_kwargs(cfg)
    t, r = rack.shape
    print(f"campus trace rendered whole: T={t} R={r}, {rack.numel() * 4 / 1e6:.1f} MB per (T, R) "
          f"array")
    _, lc_c_ms, lc_c_plain, lc_c_bo, lc_c_cp = kernel_lc(filt, rack, st.filter_state, "lc_filter")
    corr = torch.zeros_like(rack)
    args = (filt, rack, st.ess_state.g_filter, st.ess_state.soc, st.filter_state, corr)
    (grid, soc_t, _), ps_ms, ps_plain, ps_bo = kernel_pdu("unweighted", *args, None, kw,
                                                          "pdu_sim")
    _, pw_ms, pw_plain, pw_bo = kernel_pdu("(T, R) weight", *args, w_series, kw,
                                           "pdu_sim_weight_series")
    _, pr_ms, pr_plain, pr_bo = kernel_pdu("(R,) weight", *args, w_row, kw, None)
    # The cp.async route forced on the same trace: the same bits, timed.
    lc = tuple(m.cpu().numpy() for m in (filt.ad, filt.bd, filt.c[0]))
    sim_args = (rack, st.ess_state.g_filter, st.ess_state.soc, st.filter_state, *lc, corr)
    ps_tma_ms = _median_ms(lambda: pdu_sim.pdu_sim(*sim_args, **kw), reps=10)
    with _cp_async_route():
        out = pdu_sim.pdu_sim(*sim_args, **kw)
        same = _bitwise((out[0], out[1]), (grid, soc_t))
        ps_cp_ms = _median_ms(lambda: pdu_sim.pdu_sim(*sim_args, **kw), reps=10)
    print(f"pdu_sim     the cp.async route forced at T={t} R={r}: {ps_cp_ms:.4f} ms against the "
          f"TMA route's {ps_tma_ms:.4f} (both through the kernel module), the same bits: {same}")
    _check(same, "pdu_sim cp.async route vs the TMA route")
    # The unfused physics the fused kernel is held to (float32 alpha there,
    # the reference kernel's float64 alpha here: 1.2e-5 relative at dt = 5 ms).
    t0 = time.perf_counter()
    node_u, soc_u, _ = ess.simulate(cfg.ess_params, st.ess_state, rack, cfg.sample_dt)
    y_u, _ = filters.simulate(filt, st.filter_state,
                              torch.stack([torch.ones_like(node_u), node_u], dim=-1))
    torch.cuda.synchronize()
    unf = (_max_err(grid, y_u[..., 0]), _max_err(soc_t, soc_u))
    print(f"pdu_sim     campus vs plain ess.simulate -> filters.simulate: max|diff| grid "
          f"{unf[0]:.3e} SoC {unf[1]:.3e} (limit {UNFUSED_TOL}; {time.perf_counter() - t0:.1f} s)")
    _check(max(unf) <= UNFUSED_TOL, "pdu_sim vs the unfused ess -> filters pipeline")
    del rack, corr, w_series, w_row, grid, soc_t, node_u, soc_u, y_u

    # (c) gemm_burn
    gen = torch.Generator(device=dev).manual_seed(1)
    gemm = {}
    for dtype_name, n, iters in GEMM_CASES:
        dtype = getattr(torch, dtype_name)
        a = torch.randn((n, n), generator=gen, device=dev).to(dtype)
        b = torch.randn((n, n), generator=gen, device=dev).to(dtype)
        tol = _gemm_tol(dtype_name, n)
        outs, times = {}, {}
        for it in iters:
            outs[it] = main_call("gemm_burn", lambda: ops.gemm_burn(a, b, it),
                                 "gemm_burn" if dtype_name == "bfloat16" else "gemm_burn_f32")
            want, plain_ms = _event_ms(lambda: ops.gemm_burn(a, b, it, force="ref"))
            err = _max_err(outs[it], want)
            ok = torch.allclose(outs[it].float(), want.float(), **tol)
            _check(ok, f"gemm_burn {dtype_name} {n}^3 n_iters={it}: kernel vs plain ({err:.3e})")
            ms = _median_ms(lambda: ops.gemm_burn(a, b, it), reps=5, warmup=1)
            lib_ms = _median_ms(lambda: [torch.matmul(a, b) for _ in range(it)], reps=5, warmup=1)
            times[it] = ms
            flops = 2 * n ** 3 * it
            print(f"gemm_burn   {dtype_name} {n}^3 n_iters={it}: max|kernel - plain| {err:.3e} "
                  f"(within rtol {tol['rtol']}, atol {tol['atol']}); kernel {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, {it} x "
                  f"torch.matmul {lib_ms:.3f} ms")
            gemm[(dtype_name, it)] = (err, ms, plain_ms, lib_ms,
                                      (a.element_size() * 3 * n * n, flops))
        if len(iters) > 1:
            lo, mid, hi = sorted(iters)
            inv = _max_err(outs[lo], outs[hi])
            _check(torch.allclose(outs[lo].float(), outs[hi].float(), **tol),
                   f"gemm_burn n_iters {lo} vs {hi} value")
            ratio = times[hi] / times[lo]
            # What one more round of products costs, from n_iters lo -> mid
            # and mid -> hi: the fixed cost of a call (its operand stream
            # and epilogue) cancels.  round_ms is the second.
            low_round_ms = (times[mid] - times[lo]) / (mid - lo)
            round_ms = (times[hi] - times[mid]) / (hi - mid)
            round_bound_ms = 2 * n ** 3 / BF16_FLOP_PER_S * 1e3
            print(f"gemm_burn   {dtype_name} {n}^3: max|o{lo} - o{hi}| {inv:.3e}; time(n={hi}) / "
                  f"time(n={lo}) = {ratio:.2f}; one more round {low_round_ms:.4f} ms from "
                  f"n={lo} to {mid}, {round_ms:.4f} ms ({2 * n ** 3 / round_ms / 1e9:.1f} TFLOP/s) "
                  f"from {mid} to {hi}; a round's bound {round_bound_ms:.4f} ms")
            print(f"gemm_burn   {dtype_name} {n}^3 n_iters={mid}: the FP32-FMA kernel before the "
                  f"redesign took {FMA_KERNEL_MS['gemm_burn']:.3f} ms (a recorded constant, not "
                  f"this run's)")
            _check(ratio >= 5, f"gemm_burn: the FLOP knob must be real (time ratio {ratio:.2f})")
            _check(abs(low_round_ms / round_ms - 1) <= GEMM_ROUND_AGREE,
                   f"gemm_burn: a round must cost the same at every n_iters ({low_round_ms:.4f} vs "
                   f"{round_ms:.4f} ms)")
            _check(round_ms >= round_bound_ms,
                   f"gemm_burn: a round ({round_ms:.4f} ms) beats its bound ({round_bound_ms:.4f} ms)")
            gemm["ratio"], gemm["round_ms"] = ratio, round_ms
        else:
            o1 = main_call("gemm_burn", lambda: ops.gemm_burn(a, b, 1), "gemm_burn_f32")
            o8 = main_call("gemm_burn", lambda: ops.gemm_burn(a, b, 8), "gemm_burn_f32")
            inv = _max_err(o1, o8)
            print(f"gemm_burn   {dtype_name} {n}^3: max|o1 - o8| {inv:.3e}")
            _check(torch.allclose(o1, o8, rtol=1e-4, atol=1e-4), "gemm_burn o1 vs o8 (f32)")

    # The ragged cases.  bf16 M = 1000, K = 998, N = 1001: the wrapper
    # zero-pads K to 1000 and N to 1008 (1000 itself is a multiple of 8 and
    # would pad nothing), the ragged M rides on TMA's zero fill.  float32:
    # a split K whose last range is shorter than the others.
    for dtype_name, m, k, n, it in GEMM_RAGGED:
        dtype = getattr(torch, dtype_name)
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        out = main_call("gemm_burn", lambda: ops.gemm_burn(a, b, it),
                        "gemm_burn" if dtype_name == "bfloat16" else "gemm_burn_f32")
        want = ops.gemm_burn(a, b, it, force="ref")
        tol = _gemm_tol(dtype_name, k)
        err = _max_err(out, want)
        print(f"gemm_burn   {dtype_name} ragged M {m} N {n} K {k} n_iters={it}: max|kernel - "
              f"plain| {err:.3e} (within rtol {tol['rtol']}, atol {tol['atol']})")
        _check(out.shape == want.shape and torch.allclose(out.float(), want.float(), **tol),
               f"gemm_burn ragged {dtype_name} {m} x {k} x {n}: kernel vs plain ({err:.3e})")

    gb32, gb16 = gemm[("float32", 4)], gemm[("bfloat16", 4)]
    bench_plain_key = f"bench_plain_ms_{bench_t}"
    return {
        "lc_filter": entry(
            "lc_filter", lc_src, lc_rep, lc_c_ms, lc_c_plain, lc_c_bo, FP32_FLOP_PER_S,
            shape=[t, r], chunk=hw_plan.lc_plan(r).chunk, cp_async_ms=lc_c_cp,
            bench_shape=[SIM_BENCH["t"], SIM_BENCH["r"]], bench_ms=lc_b_ms,
            **{bench_plain_key: lc_b_plain}, bench_bound_ms=lc_b_bo[0] / HBM_BYTES_PER_S * 1e3,
            bench_cp_async_ms=lc_b_cp),
        "pdu_sim": entry(
            "pdu_sim", ps_src, ps_rep, ps_ms, ps_plain, ps_bo, FP32_FLOP_PER_S, shape=[t, r],
            variant="unweighted", chunk=hw_plan.CHUNK, cp_async_ms=ps_cp_ms,
            bench_ms=bench["unweighted"][0], **{bench_plain_key: bench["unweighted"][1]},
            bench_bound_ms=bench["unweighted"][2][0] / HBM_BYTES_PER_S * 1e3),
        "pdu_sim_weight_series": entry(
            "pdu_sim_weight_series", ps_src, ps_rep, pw_ms, pw_plain, pw_bo, FP32_FLOP_PER_S,
            shape=[t, r], variant="(T, R) weight",
            bench_ms=bench["(T, R) weight"][0], **{bench_plain_key: bench["(T, R) weight"][1]},
            bench_bound_ms=bench["(T, R) weight"][2][0] / HBM_BYTES_PER_S * 1e3),
        "pdu_sim_weight_row": entry(
            "pdu_sim_weight_row", ps_src, ps_rep, pr_ms, pr_plain, pr_bo, FP32_FLOP_PER_S,
            shape=[t, r], variant="(R,) weight",
            bench_ms=bench["(R,) weight"][0], **{bench_plain_key: bench["(R,) weight"][1]},
            bench_bound_ms=bench["(R,) weight"][2][0] / HBM_BYTES_PER_S * 1e3),
        "gemm_burn": entry(
            "gemm_burn", gb_src, gb_rep, gb16[1], gb16[2], gb16[4], BF16_FLOP_PER_S,
            library_ms=gb16[3], err=gb16[0], shape=[4096, 4096, 4096], dtype="bfloat16", n_iters=4,
            n_iters_ms={str(it): gemm[("bfloat16", it)][1] for it in (1, 4, 8)},
            time_ratio_8_1=gemm["ratio"], round_ms=gemm["round_ms"]),
        "gemm_burn_f32": entry(
            "gemm_burn_f32", gb_src, gb_rep, gb32[1], gb32[2], gb32[4], FP32_FLOP_PER_S,
            library_ms=gb32[3], err=gb32[0], shape=[512, 512, 512], dtype="float32", n_iters=4,
            second_pass="gemm_burn_f32_sum", second_pass_launches=launches.get("gemm_burn_f32_sum", 0)),
    }


def phase_fig11(dev) -> dict:
    """Phase 12: paper Fig. 11 through the port (examples/power_conditioning.py
    ``fig11``), its checks, and the same pipeline on the counter-hashed
    noise against ``JAX_FIG11``."""
    import torch

    from repro_torch.core import burn
    from repro_torch.kernels import admm_step, pdu_health
    from repro_torch.power import trace

    f = FIG11
    gen = torch.Generator(device=dev).manual_seed(f["trace_seed"])
    rack, dt = trace.titanx_testbench(gen, device=dev)
    cal = burn.calibrate(torch.Generator(device=dev).manual_seed(f["cal_seed"]), f["p_idle"],
                         f["p_peak"], device=dev)
    pdu_health.pdu_health_sim.launches = 0
    admm_step.admm_iterate.launches = 0
    t0 = time.perf_counter()
    got = fig11_summary(rack, dt, cal, device=dev)
    wall = time.perf_counter() - t0
    counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
    n_ctrl = rack.shape[0] // int(round(5.0 / dt))
    print(f"fig11 titanx_testbench {rack.shape[0]} samples: {wall:.3f} s wall, launches "
          f"pdu_health={counts[0]} admm_step={counts[1]}")
    print("fig11: " + json.dumps(got))
    print(f"[Fig 11] software burn uses {got['burn_vs_easyrider_frac'] * 100:.1f}% more energy "
          f"than rack+EasyRider (paper: 19%)")
    _check(counts == (n_ctrl, n_ctrl),
           f"fig11: each kernel must launch {n_ctrl} times, got {counts}")
    bad = check_fig11(got)
    _check(not bad, "fig11: " + "; ".join(bad))
    n_warm = int(round(30.0 / dt))
    full = torch.cat([torch.full((n_warm,), 0.1, device=dev), rack])
    env_ms = _median_ms(lambda: burn.ramp_compliant_envelope(full, dt, f["beta"]), reps=10)
    print(f"fig11 ramp_compliant_envelope over {full.shape[0]} samples (closed form): "
          f"{env_ms:.4f} ms")

    got2 = port_fig11_reference(device=dev)
    print("fig11 vs JAX: " + json.dumps({k: [got2[k], JAX_FIG11[k]] for k in got2}))
    bad = check_fig11(got2) + compare_fig11(got2, JAX_FIG11)
    _check(not bad, "fig11 differs from the JAX package: " + "; ".join(bad))
    return {"counts": counts, "envelope_ms": env_ms, "wall_s": wall,
            "burn_vs_easyrider_frac": got["burn_vs_easyrider_frac"]}


def phase_fig12(dev, profile_dir: Path | None = None) -> dict:
    """Phase 14a: paper Fig. 12 through the port (a warm-up run, then the
    timed one), its checks, and the same run on the plain versions
    (``ops.forced("ref")``) held to it; with ``profile_dir`` one more run
    under the profiler."""
    import numpy as np
    import torch

    from repro_torch.core import controller as ctrl, ess
    from repro_torch.kernels import admm_step, ops

    f = FIG12
    cfg = ctrl.ControllerConfig.create(i_max=f["i_max"], device=dev)
    es = ess.ESSParams.create(q_max_seconds=f["q_max_seconds"], device=dev)

    def run():
        t0 = time.perf_counter()
        out = ctrl.simulate_soc_management(cfg, es, f["soc0"], n_steps=f["n_steps"],
                                           qp_iters=f["qp_iters"])
        soc = out["soc"].cpu().numpy()
        return soc, time.perf_counter() - t0

    run()  # warm-up: the timed run below finds the handles and caches made
    admm_step.admm_iterate.launches = 0
    soc, wall = run()
    launches = admm_step.admm_iterate.launches
    with ops.forced("ref"):
        soc_ref, plain_wall = run()
    db = float(cfg.deadband)
    hit, hit_ref = convergence_step(soc, db), convergence_step(soc_ref, db)
    err = float(np.max(np.abs(soc.astype(np.float64) - soc_ref)))
    minutes = None if hit is None else hit * float(cfg.dt) / 60.0
    print(f"[Fig 12] SoC {f['soc0']} -> {soc[-1]:.6f} in "
          f"{'never' if minutes is None else f'{minutes:.2f} min'} (step {hit}; paper: converges "
          f"to S_mid=0.5 in ~20 min), {f['n_steps']} steps in {wall:.3f} s wall "
          f"(plain versions {plain_wall:.3f} s), admm_step launches {launches}")
    print(f"fig12 kernels vs plain versions: SoC max |diff| {err:.3e} (tolerance "
          f"{FIG12_SOC_TOL:.0e}), convergence step {hit} vs {hit_ref}")
    _check(launches == f["n_steps"], f"fig12: admm_step must launch once a step, got {launches}")
    _check(hit is not None and abs(float(soc[-1]) - 0.5) <= db,
           f"fig12: SoC must end within the deadband {db} of 0.5, got {soc[-1]}")
    _check(0.10 <= float(soc.min()) and float(soc.max()) <= 0.90, "fig12: SoC must stay in [0.10, 0.90]")
    if hit != hit_ref:
        k = min(i for i in (hit, hit_ref) if i is not None)
        _check(False, f"fig12: convergence step {hit} vs {hit_ref} on the plain versions; margin "
                      f"|S - S*| - deadband at step {k}: {abs(float(soc[k]) - 0.5) - db:.3e} "
                      f"(kernel), {abs(float(soc_ref[k]) - 0.5) - db:.3e} (plain)")
    _check(err <= FIG12_SOC_TOL, f"fig12: SoC trajectory vs the plain versions {err:.3e}")
    if profile_dir is not None:
        profile_run("fig12", lambda: run()[1], profile_dir)
    return dict(launches=launches, wall_s=wall, plain_wall_s=plain_wall, soc_final=float(soc[-1]),
                converge_step=hit, converge_min=minutes, max_abs_err=err)


def phase_fleet_scale(dev, profile_dir: Path | None = None) -> dict:
    """Phase 14b: ``bench_fleet_scale`` at 1024 racks: ``pdu.condition`` on
    the per-step oracle (cold) and on the plan (warm), each run once to warm
    up and once timed with the launch counts read around it; with
    ``profile_dir`` each once more under the profiler."""
    import torch

    from repro_torch.core import compliance, fleet, pdu
    from repro_torch.kernels import admm_step, pdu_health
    from repro_torch.power import trace

    f = FLEET_SCALE
    sp = trace.TestbenchSpec(duration_s=f["duration_s"], sample_hz=f["sample_hz"])
    t1, dt = trace.testbench_trace(sp, torch.Generator(device=dev).manual_seed(f["trace_seed"]),
                                   device=dev)
    racks = fleet.staggered_fleet(
        t1, f["n_racks"], torch.Generator(device=dev).manual_seed(f["stagger_seed"]),
        max_offset_samples=f["max_offset_samples"], device=dev)
    cfg = pdu.make_pdu(sample_dt=dt, device=dev)
    n_ctrl = -(-racks.shape[0] // int(round(float(cfg.controller.dt) / dt)))

    def run(use_plan, iters):
        t0 = time.perf_counter()
        st = pdu.init_state(cfg, racks[0])
        grid, _, telem = pdu.condition(cfg, st, racks, qp_iters=iters, use_plan=use_plan)
        campus, resid = torch.mean(grid, dim=1), torch.amax(telem.qp_residual)
        torch.cuda.synchronize()
        return campus, resid, time.perf_counter() - t0

    res, campus = {}, {}
    cases = (("cold", False, f["cold_iters"]), ("warm", True, f["warm_iters"]))
    for name, use_plan, iters in cases:
        run(use_plan, iters)
        pdu_health.pdu_health_sim.launches = 0
        admm_step.admm_iterate.launches = 0
        campus[name], resid, wall = run(use_plan, iters)
        res[name] = dict(resid=float(resid), wall_s=wall,
                         us_per_rack=wall * 1e6 / f["n_racks"],
                         launches=(pdu_health.pdu_health_sim.launches,
                                   admm_step.admm_iterate.launches),
                         ramp=float(compliance.max_abs_ramp(campus[name], dt)))
    cold, warm = res["cold"], res["warm"]
    diff = float(torch.max(torch.abs(campus["cold"] - campus["warm"])))
    print(f"fleet_1024racks {f['n_racks']} racks x {racks.shape[0]} samples ({n_ctrl} intervals): "
          f"cold (per-step oracle, {f['cold_iters']} iterations) {cold['wall_s']:.4f} s = "
          f"{cold['us_per_rack']:.1f} us/rack, warm (plan, {f['warm_iters']}) {warm['wall_s']:.4f} s "
          f"= {warm['us_per_rack']:.1f} us/rack, cold / warm {cold['wall_s'] / warm['wall_s']:.2f}x")
    print(f"fleet_1024racks campus_ramp warm {warm['ramp']:.6f}/s cold {cold['ramp']:.6f}/s, "
          f"qp_resid cold {cold['resid']:.3e} warm {warm['resid']:.3e}, campus mean cold vs warm "
          f"{diff:.3e}; launches pdu_health/admm_step cold {cold['launches']} warm {warm['launches']}")
    for name in ("cold", "warm"):
        _check(res[name]["ramp"] <= 0.1, f"fleet_1024racks {name}: campus ramp {res[name]['ramp']}")
    _check(diff <= FLEET_COLD_WARM_TOL, f"fleet_1024racks: campus means cold vs warm {diff:.3e}")
    _check(cold["launches"] == (n_ctrl, 0),
           f"fleet_1024racks cold: pdu_health once an interval, admm_step never, got {cold['launches']}")
    _check(warm["launches"] == (n_ctrl, n_ctrl),
           f"fleet_1024racks warm: each kernel once an interval, got {warm['launches']}")
    if profile_dir is not None:
        for name, use_plan, iters in cases:
            profile_run(f"fleet_1024racks_{name}", lambda: run(use_plan, iters)[2], profile_dir)
    return dict(res, n_ctrl=n_ctrl, cold_warm_ratio=cold["wall_s"] / warm["wall_s"],
                campus_cold_warm_diff=diff)


def phase_controller_throughput(dev, profile_dir: Path | None = None) -> dict:
    """Phase 14c: ``bench_controller_throughput`` at 2048 racks: rack-solves/s
    of the per-step oracle (cold, batched) and of warm-started plan steps;
    with ``profile_dir`` each once more under the profiler."""
    import torch

    from repro_torch.core import controller as ctrl, ess
    from repro_torch.kernels import admm_step

    f = CONTROLLER_THROUGHPUT
    n = f["n_racks"]
    cfg = ctrl.ControllerConfig.create(device=dev)
    es = ess.ESSParams.create(q_max_seconds=40.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(f["soc_seed"])
    socs = 0.3 + 0.4 * torch.rand(n, generator=gen, device=dev)
    tgt = torch.tensor(0.5, device=dev)
    ups = torch.zeros(n, device=dev)
    plan = ctrl.make_plan(cfg, es)

    def cold():
        return ctrl.inner_loop_step(cfg, es, socs, tgt, ups, qp_iters=f["cold_iters"]).corrective_power

    def warm():
        soc, up, w = socs, torch.zeros_like(socs), ctrl.init_warm(plan, socs.shape, device=dev)
        resid = []
        for _ in range(f["n_steps"]):
            out, w = ctrl.inner_loop_step_plan(cfg, es, plan, soc, tgt, up, w,
                                               qp_iters=f["warm_iters"])
            soc = soc - out.corrective_power * cfg.dt / es.q_max
            up = out.corrective_power / cfg.i_max
            resid.append(out.qp_primal_residual)
        return torch.stack(resid)

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def timed(fn):
        wall(fn)
        admm_step.admm_iterate.launches = 0
        return (*wall(fn), admm_step.admm_iterate.launches)

    cmd, cold_s, cold_launches = timed(cold)
    resid, warm_s, warm_launches = timed(warm)
    cold_rate = n / cold_s
    warm_rate = n / (warm_s / f["n_steps"])
    last = float(torch.max(resid[-1]))
    print(f"controller_throughput {n} racks: racksolves_per_s cold {cold_rate:.0f} "
          f"(per-step oracle, {f['cold_iters']} iterations, {cold_s:.4f} s) warm {warm_rate:.0f} "
          f"(plan, {f['warm_iters']} iterations, {f['n_steps']} steps in {warm_s:.4f} s), "
          f"warm / cold {warm_rate / cold_rate:.2f}x, warm_resid {last:.3e}; admm_step launches "
          f"cold {cold_launches} warm {warm_launches}")
    i_max = float(cfg.i_max)
    _check(tuple(cmd.shape) == (n,) and bool(torch.isfinite(cmd).all())
           and float(cmd.abs().max()) <= i_max, "controller_throughput: cold commands")
    _check(bool(torch.isfinite(resid).all()), "controller_throughput: warm residuals")
    _check((cold_launches, warm_launches) == (0, f["n_steps"]),
           f"controller_throughput: admm_step launches cold/warm {(cold_launches, warm_launches)}")
    if profile_dir is not None:
        for name, fn in (("cold", cold), ("warm", warm)):
            profile_run(f"controller_throughput_{name}", lambda: wall(fn)[1], profile_dir)
    return dict(cold_racksolves_per_s=cold_rate, warm_racksolves_per_s=warm_rate, cold_s=cold_s,
                warm_s=warm_s, warm_resid=last, launches_warm=warm_launches)


def phase_quickstart(dev) -> tuple[int, int]:
    """The quickstart flow through the port (a single rack: the kernels run
    one column); returns the kernels' launch counts."""
    import torch

    from repro_torch.core import compliance, pdu
    from repro_torch.kernels import admm_step, pdu_health
    from repro_torch.power import trace

    spec = compliance.GridSpec.create(beta=0.1, alpha=1e-4, f_c=2.0, device=dev)
    cfg = pdu.make_pdu(grid=spec, sample_dt=2e-3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rack, dt = trace.testbench_trace(
        trace.TestbenchSpec(duration_s=240.0, sample_hz=500.0, terminate_at_s=210.0),
        gen, device=dev)
    pdu_health.pdu_health_sim.launches = 0
    admm_step.admm_iterate.launches = 0
    t0 = time.perf_counter()
    state = pdu.init_state(cfg, rack[0])
    grid, state, telem = pdu.condition(cfg, state, rack, qp_iters=40)
    before = compliance.check(rack, dt, spec)
    after = compliance.check(grid, dt, spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    soc_lo, soc_hi = float(telem.soc.min()), float(telem.soc.max())
    print(f"quickstart rack : ramp {float(before.max_ramp):8.3f}/s  "
          f"S(f>=2Hz) {float(before.worst_high_freq_mag):.2e}  ok={bool(before.ok)}")
    print(f"quickstart grid : ramp {float(after.max_ramp):8.4f}/s  "
          f"S(f>=2Hz) {float(after.worst_high_freq_mag):.2e}  ok={bool(after.ok)}")
    print(f"quickstart SoC in [{soc_lo:.4f}, {soc_hi:.4f}], {rack.shape[0]} samples, "
          f"{wall:.3f} s wall")
    counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
    k = int(round(float(cfg.controller.dt) / dt))
    print(f"quickstart launches pdu_health={counts[0]} admm_step={counts[1]} (intervals of "
          f"T = {k} samples, R = {rack.shape[1] if rack.ndim == 2 else 1})")
    _check(counts == (rack.shape[0] // k,) * 2,
           f"quickstart: each kernel must launch once an interval, got {counts}")
    _check(not bool(before.ok), "quickstart: the raw rack trace must fail the grid spec")
    _check(bool(after.ok), "quickstart: the conditioned grid must meet the spec")
    _check(0.10 <= soc_lo and soc_hi <= 0.90, "quickstart: SoC must stay in [0.10, 0.90]")
    return counts


def phase_campus(dev, profile_dir: Path | None = None) -> dict:
    """The acceptance campus through the host engine, then through the
    scanned engine (``phase_scanned``); returns the kernels' launch counts
    on the host engine's run and the scanned engine's numbers."""
    import torch

    from repro_torch.kernels import admm_step, pdu_health

    c = CAMPUS
    counts = None
    for run in ("first", "second"):
        pdu_health.pdu_health_sim.launches = 0
        admm_step.admm_iterate.launches = 0
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, hsum, wall = run_campus(c["n_racks"], c["duration_s"], device=dev)
        peak = torch.cuda.max_memory_allocated() - base
        counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
        print(f"campus {run} run: {wall:.3f} s wall, launches pdu_health={counts[0]} "
              f"admm_step={counts[1]}, peak memory {peak / 2**20:.1f} MiB above the base")
        _check(counts == (18, 18), f"campus: each kernel must launch 18 times, got {counts}")
    host_res, host_peak = res, peak
    got = campus_summary(res, hsum)
    print(f"campus rack: max ramp {got['rack_max_ramp']:.6f}/s ramp_ok={got['rack_ramp_ok']} "
          f"worst line {got['rack_worst_line']:.3e} spectrum_ok={got['rack_spectrum_ok']}")
    print(f"campus grid: max ramp {got['grid_max_ramp']:.6f}/s ramp_ok={got['grid_ramp_ok']} "
          f"worst line {got['grid_worst_line']:.3e} (exact DFT {got['grid_worst_line_exact']:.3e}) "
          f"spectrum_ok={got['grid_spectrum_ok']} ok={got['grid_ok']}")
    print("campus health: " + json.dumps(hsum))
    print("campus vs JAX: " + json.dumps({k: [got[k], JAX_CAMPUS[k]] for k in got}))
    bad = compare_campus(got, JAX_CAMPUS)
    _check(not bad, "campus differs from the JAX package: " + "; ".join(bad))

    def run(engine="scanned", **window):
        r, h, w = run_campus(c["n_racks"], c["duration_s"], device=dev, engine=engine, **window)
        return r, w, h

    scanned = phase_scanned("campus", run, host_res, host_peak, pdu_health.MASK_NONE,
                            c["chunk_intervals"], profile_dir)
    got = campus_summary(scanned["res"], scanned["extra"])
    print("campus scanned vs JAX: " + json.dumps({k: [got[k], JAX_CAMPUS[k]] for k in got}))
    bad = compare_campus(got, JAX_CAMPUS)
    _check(not bad, "scanned campus differs from the JAX package: " + "; ".join(bad))
    return dict(counts=counts, host_s=wall, scanned=scanned, host_res=host_res)


# Phase 6, continued: stablelm-12b at full width (d_model 5120, 32 query
# and 8 KV heads of 160, LayerNorm, d_ff 13824, bf16), its depth cut from 40
# to 4 layers (~2.1 B parameters, drawn on the card by transformer.init);
# the prefill step on 2 prompts x 512 tokens.
STABLELM = dict(arch="stablelm_12b", n_layers=4, seed=0, prompt_seed=3, prefill=(2, 512))


def phase_stablelm(dev) -> dict:
    """The prefill of the cut-depth, full-width stablelm-12b on the kernels
    against the same step on the plain versions (``ops.forced("ref")``):
    flash must launch once per layer at head dim 160 (LayerNorm, so no
    rmsnorm launch)."""
    import dataclasses

    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import build_prefill_step

    cfg = dataclasses.replace(full_config(STABLELM["arch"]), n_layers=STABLELM["n_layers"])
    _check(cfg.resolved_head_dim == 160 and cfg.norm == "layernorm", "stablelm-12b's layout")
    t0 = time.perf_counter()
    model = T.init(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(STABLELM["seed"]))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"stablelm: {cfg.name} {n_params} parameters ({cfg.dtype}, {cfg.n_layers} of 40 layers, "
          f"d_model {cfg.d_model}, head dim {cfg.resolved_head_dim}) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    b, tl = STABLELM["prefill"]
    prompts = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl, STABLELM["prompt_seed"]),
                              device=dev)
    step = build_prefill_step(cfg)
    step(model, prompts, tl)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t = time.perf_counter()
    logits, state = step(model, prompts, tl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _counts()
    with ops.forced("ref"):
        logits_ref, _ = step(model, prompts, tl)
    torch.cuda.synchronize()
    err = _max_err(logits, logits_ref)
    print(f"stablelm prefill {b} x {tl}: {wall:.4f} s wall, launches {counts}; logits "
          f"max|kernels - plain| {err:.4f} (max|logit| {float(logits_ref.abs().max()):.3f})")
    _check(counts == {"rmsnorm": 0, "flash_attention_fwd": cfg.n_layers},
           f"stablelm prefill launches {counts}")
    _check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (b, tl, cfg.padded_vocab)
           and state["blocks"].length == tl, "stablelm prefill logits/state")
    _check(err <= SERVE_PREFILL_TOL, "stablelm prefill logits, kernels vs plain versions")
    del model
    return {"prefill_s": wall, "flash_attention_fwd": counts["flash_attention_fwd"]}


class _PlainCalls:
    """Counts calls of the named plain versions (attributes of
    ``kernels.ref``, as ``ops`` reaches them) inside the block."""

    def __init__(self, *names: str):
        self.names = names

    def __enter__(self):
        from repro_torch.kernels import ref

        self.n, self._saved = 0, tuple(getattr(ref, n) for n in self.names)

        def counted(fn):
            def call(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return call

        for n, fn in zip(self.names, self._saved):
            setattr(ref, n, counted(fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref

        for n, fn in zip(self.names, self._saved):
            setattr(ref, n, fn)
        return False


def phase_faulty_campus(dev, profile_dir: Path | None = None) -> dict:
    """Phase 13: FAULTY_CAMPUS at full size through the host engine (the
    fault schedule handed to ``pdu.condition``, the ESS weight rendered in
    the kernel from the episode tables) and the one-shot engine (the
    streamed (T, R) weight).  Each run must launch pdu_health (in its
    engine's weight mode) and admm_step 18 times and call no plain
    pdu_health; the numbers must match JAX_FAULTY_CAMPUS within
    FAULTY_CAMPUS_TOLERANCES (ess_online_frac and the verdicts exactly).
    Then the scanned engine (``phase_scanned``), its numbers bit for bit
    the host engine's.  Returns each engine's warm wall time and launch
    counts."""
    from repro_torch.kernels import admm_step, pdu_health

    import torch

    c = FAULTY_CAMPUS
    mode = {"host": pdu_health.MASK_EVENTS, "oneshot": pdu_health.MASK_SERIES}
    out = {}
    for engine in ("host", "oneshot"):
        for run in ("first", "second"):
            pdu_health.pdu_health_sim.launches = 0
            pdu_health.pdu_health_sim.launches_by_mask = [0, 0, 0, 0]
            admm_step.admm_iterate.launches = 0
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with _PlainCalls("pdu_health_sim") as plain:
                res, got, wall = run_faulty_campus(c["n_racks"], c["duration_s"], engine,
                                                   device=dev)
            peak = torch.cuda.max_memory_allocated() - base
            by_mask = list(pdu_health.pdu_health_sim.launches_by_mask)
            counts = (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)
            print(f"faulty campus {engine} engine, {run} run: {wall:.3f} s wall, launches "
                  f"pdu_health={counts[0]} (by weight mode none/row/series/events {by_mask}) "
                  f"admm_step={counts[1]}, plain pdu_health calls {plain.n}")
            _check(counts == (18, 18) and by_mask[mode[engine]] == 18 and plain.n == 0,
                   f"faulty campus {engine}: launches {counts} {by_mask}, plain calls {plain.n}")
        print(f"faulty campus {engine}: grid max ramp {got['grid_max_ramp']:.6f}/s "
              f"ok={got['grid_ok']}, ESS online fraction min {min(got['ess_online_frac']):.4f}")
        print(f"faulty campus {engine} vs JAX: "
              + json.dumps({k: [got[k], JAX_FAULTY_CAMPUS[k]] for k in got}))
        bad = compare_faulty_campus(got, JAX_FAULTY_CAMPUS)
        _check(not bad, f"faulty campus ({engine}) differs from the JAX package: "
               + "; ".join(bad))
        out[engine] = dict(wall_s=wall, pdu_health=counts[0], admm_step=counts[1],
                           by_mask=by_mask)
        if engine == "host":
            host_res, host_peak = res, peak

    def run_scanned(engine="scanned", **window):
        r, g, w = run_faulty_campus(c["n_racks"], c["duration_s"], engine, device=dev, **window)
        return r, w, g

    scanned = phase_scanned("faulty campus", run_scanned, host_res, host_peak,
                            pdu_health.MASK_EVENTS, c["chunk_intervals"], profile_dir)
    got = scanned["extra"]
    print("faulty campus scanned vs JAX: "
          + json.dumps({k: [got[k], JAX_FAULTY_CAMPUS[k]] for k in got}))
    bad = compare_faulty_campus(got, JAX_FAULTY_CAMPUS)
    _check(not bad, "scanned faulty campus differs from the JAX package: " + "; ".join(bad))
    out["scanned"] = scanned
    return out


def phase_safemode(dev, campus: dict, profile_dir: Path | None = None) -> dict:
    """Phase 15: safe mode on the card.  (a) The acceptance campus supervised
    (``bench_mixed_campus_safemode``): the host engine, then the scanned
    engine (``phase_scanned``), each bit for bit phase 4's unsupervised run
    with pdu_health in its series mode (18 launches, a weight of ones) and
    admm_step 18, every safemode_trace row [1, 0, 0, 0, 0, 0] and 1024
    racks NORMAL; then the supervision overhead, timed interleaved (three
    alternating warm runs, unsupervised and supervised, on each engine),
    and the graph's nodes beside phase 4's.  (b) The safe-mode drill
    (``SAFEMODE_DRILL`` on ``FAULTY_CAMPUS``) through the host and scanned
    engines: pdu_health in the series mode throughout, the two engines bit
    for bit, each against ``JAX_SAFEMODE_DRILL`` (``compare_safemode_drill``),
    every campus sample finite, and the scanned run split at sample 8000 and
    resumed equal to one call.  Returns the launch counts, walls, overhead
    and nodes."""
    import torch

    from repro_torch.core import fleet
    from repro_torch.kernels import admm_step, pdu_health

    c, fc = CAMPUS, FAULTY_CAMPUS
    series = pdu_health.MASK_SERIES

    def reset():
        pdu_health.pdu_health_sim.launches = 0
        pdu_health.pdu_health_sim.launches_by_mask = [0, 0, 0, 0]
        admm_step.admm_iterate.launches = 0

    def counts():
        return (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches,
                list(pdu_health.pdu_health_sim.launches_by_mask))

    def clean_supervisor(res, what):
        trace = res.safemode_trace.cpu()
        summ = res.safemode_summary()
        _check(bool((trace == torch.tensor([1.0, 0, 0, 0, 0, 0])).all()),
               f"{what}: safemode_trace rows {trace.tolist()} (want [1, 0, 0, 0, 0, 0])")
        _check(summ["n_normal"] == c["n_racks"] and summ["passthrough_entries"] == 0
               and summ["quarantine_entries"] == 0, f"{what}: summary {summ}")

    # (a) The supervised acceptance campus.
    host_ref = campus["host_res"]
    reset()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _PlainCalls("pdu_health_sim") as plain:
        res, _, wall = run_campus(c["n_racks"], c["duration_s"], device=dev, safemode=True)
    peak = torch.cuda.max_memory_allocated() - base
    n = counts()
    print(f"supervised campus host engine: {wall:.3f} s wall, launches pdu_health={n[0]} (by "
          f"weight mode none/row/series/events {n[2]}) admm_step={n[1]}, plain pdu_health calls "
          f"{plain.n}")
    _check(n[:2] == (18, 18) and n[2][series] == 18 and plain.n == 0,
           f"supervised campus host: launches {n}, plain calls {plain.n}")
    bad = _differing_bits(res, host_ref)
    _check(not bad, "supervised campus host engine differs from phase 4's unsupervised run in "
           f"{bad}")
    clean_supervisor(res, "supervised campus host")
    host_counts = n

    def run(engine="scanned", **window):
        r, h, w = run_campus(c["n_racks"], c["duration_s"], device=dev, engine=engine,
                             safemode=True, **window)
        return r, w, h

    scanned = phase_scanned("supervised campus", run, host_ref, peak, series,
                            c["chunk_intervals"], profile_dir)
    clean_supervisor(scanned["res"], "supervised campus scanned")
    nodes, nodes_off = scanned["nodes"], campus["scanned"]["nodes"]
    print(f"supervised campus scanned graph nodes {nodes} against phase 4's {nodes_off} "
          f"(+{nodes['total'] - nodes_off['total']})")

    # The supervision overhead, timed interleaved on each engine.
    overhead = {}
    for engine in ("scanned", "host"):
        walls = {False: [], True: []}
        for sm in (False, True):  # warm-up (the scanned engine captures here)
            run_campus(c["n_racks"], c["duration_s"], device=dev, engine=engine, safemode=sm)
        for _ in range(3):
            for sm in (False, True):
                walls[sm].append(run_campus(c["n_racks"], c["duration_s"], device=dev,
                                            engine=engine, safemode=sm)[2])
        off, on = statistics.median(walls[False]), statistics.median(walls[True])
        overhead[engine] = dict(off_s=walls[False], on_s=walls[True], off_median_s=off,
                                on_median_s=on, overhead_median=on / off - 1.0,
                                overhead_min=min(walls[True]) / min(walls[False]) - 1.0)
        print(f"supervised campus {engine} engine, interleaved warm walls: unsupervised "
              f"{', '.join(f'{w:.4f}' for w in walls[False])} s, supervised "
              f"{', '.join(f'{w:.4f}' for w in walls[True])} s; overhead (median) "
              f"{100 * overhead[engine]['overhead_median']:+.1f} %, (min) "
              f"{100 * overhead[engine]['overhead_min']:+.1f} % (the reference's budget: 10 %)")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()

    # (b) The drill.
    n_r, dur = fc["n_racks"], fc["duration_s"]
    drill_walls = {}
    for i in range(2):
        reset()
        with _PlainCalls("pdu_health_sim") as plain:
            res_h, got_h, wall = run_safemode_drill(n_r, dur, "host", device=dev)
        n = counts()
        drill_walls.setdefault("host", []).append(wall)
        print(f"safemode drill host engine, run {i + 1}: {wall:.3f} s wall, launches "
              f"pdu_health={n[0]} (by weight mode {n[2]}) admm_step={n[1]}, plain calls {plain.n}")
        _check(n[:2] == (18, 18) and n[2][series] == 18 and plain.n == 0,
               f"safemode drill host: launches {n}, plain calls {plain.n}")
    drill_host_counts = n
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    reset()
    with _PlainCalls("pdu_health_sim") as plain:
        res_s, got_s, cold = run_safemode_drill(n_r, dur, "scanned", device=dev)
    (engine,) = fleet._ENGINE_CACHE.values()
    cap = engine.launches_at_capture
    print(f"safemode drill scanned cold run: {cold:.4f} s wall, at capture pdu_health="
          f"{cap['pdu_health']} (by weight mode {cap['pdu_health_by_mask']}) admm_step="
          f"{cap['admm_step']}, plain calls {plain.n}; graph nodes {_graph_nodes(engine.graph)}")
    _check(cap["pdu_health"] == 18 and cap["pdu_health_by_mask"][series] == 18
           and cap["admm_step"] == 18 and plain.n == 0,
           f"safemode drill scanned: capture launches {cap}, plain calls {plain.n}")
    for i in range(3):
        reset()
        res_s, got_s, wall = run_safemode_drill(n_r, dur, "scanned", device=dev)
        drill_walls.setdefault("scanned", []).append(wall)
        _check(counts()[:2] == (0, 0), f"safemode drill scanned warm run {i + 1}: launches "
               f"{counts()} from Python (a replay launches none)")
    bad = _differing_bits(res_s, res_h)
    if not _bitwise(res_s.safemode_trace, res_h.safemode_trace):
        bad.append("safemode_trace")
    print(f"safemode drill: scanned vs host engine "
          f"{'bit for bit' if not bad else 'differ in ' + str(bad)}; warm walls host "
          f"{', '.join(f'{w:.4f}' for w in drill_walls['host'])} s, scanned "
          f"{', '.join(f'{w:.4f}' for w in drill_walls['scanned'])} s")
    _check(not bad, f"safemode drill: scanned and host engines differ in {bad}")
    for name, r, got in (("host", res_h, got_h), ("scanned", res_s, got_s)):
        finite = bool(torch.isfinite(r.campus_grid).all() and torch.isfinite(r.campus_rack).all())
        print(f"safemode drill {name} vs JAX: "
              + json.dumps({k: [got[k], JAX_SAFEMODE_DRILL[k]] for k in got}))
        bad = compare_safemode_drill(got, JAX_SAFEMODE_DRILL)
        _check(finite, f"safemode drill {name}: a campus sample is not finite")
        _check(not bad, f"safemode drill ({name}) differs from the JAX package: " + "; ".join(bad))
    cut = 8000
    a, _, _ = run_safemode_drill(n_r, dur, "scanned", device=dev, stop_sample=cut)
    b, _, _ = run_safemode_drill(n_r, dur, "scanned", device=dev, start_sample=cut, state=a.state)
    fields = ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac", "health_trace",
              "safemode_trace")
    bad = [f for f in fields
           if not _bitwise(torch.cat([getattr(a, f), getattr(b, f)]), getattr(res_s, f))]
    ref_leaves = _result_leaves(res_s.state, "state")
    bad += [k for k, v in _result_leaves(b.state, "state").items()
            if not _bitwise(v, ref_leaves[k])]
    if not _bitwise(torch.maximum(a.max_qp_residual, b.max_qp_residual), res_s.max_qp_residual):
        bad.append("max_qp_residual")
    print(f"safemode drill scanned split at sample {cut} and resumed: "
          f"{'bit for bit the one-call run' if not bad else 'differs in ' + str(bad)}")
    _check(not bad, f"safemode drill split at {cut} differs from one call in {bad}")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return dict(host_counts=host_counts, scanned=scanned, nodes=nodes, nodes_off=nodes_off,
                overhead=overhead, drill_host_counts=drill_host_counts, drill_capture=cap,
                drill_walls=drill_walls, drill_cold_s=cold)


def _region_counts() -> tuple:
    from repro_torch.kernels import admm_step, pdu_health

    return (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)


def _reset_region_counts() -> None:
    from repro_torch.kernels import admm_step, pdu_health

    pdu_health.pdu_health_sim.launches = 0
    pdu_health.pdu_health_sim.launches_by_mask = [0, 0, 0, 0]
    admm_step.admm_iterate.launches = 0


def _weighted_sum_bitwise(res, name: str, poi) -> bool:
    """Whether ``poi`` is ``w[0] * a[0] + w[1] * a[1] + ...`` of the
    per-campus ``name`` aggregates, summed left to right, bit for bit."""
    acc = None
    for c, p in enumerate(res.per_campus):
        term = res.weights[c] * getattr(p, name)
        acc = term if acc is None else acc + term
    return _bitwise(acc, poi)


def phase_grid_region(dev, profile_dir: Path | None = None) -> dict:
    """Phase 16a: GRID_REGION synchronized, then its staggered twin, through
    ``fleet.condition`` on the scanned engine (its cache emptied first):
    one cold run and three warm runs of each.  The synchronized POI must
    ring the inter-area band and pass the local-plant band, the staggered
    one pass both, the inter-area lines at least 10x apart, both POI ramps
    within spec; the POI equal to the left-to-right weighted sum of the
    per-campus aggregates and ``poi_freq_dev`` / ``poi_volt_dev`` equal to
    ``grid.poi_response`` of it, bit for bit; each per-campus result equal
    to ``fleet.condition`` of that salted campus alone, bit for bit; both
    regions within tolerance of JAX_GRID_REGION (``compare_region``).  The
    8 campus runs must make one capture (40 clean pdu_health and 40
    admm_step launches) and launch nothing from Python after it.  Returns
    the walls, the capture's counts and the graph's nodes."""
    import torch

    from repro_torch.core import fleet, grid
    from repro_torch.kernels import pdu_health

    c = GRID_REGION
    n_int = int(c["duration_s"] / 5.0)  # controller intervals of 5 s a campus
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    out, mags = {}, {}
    for name, stagger in (("synchronized", False), ("staggered", True)):
        walls = []
        for i in range(4):
            _reset_region_counts()
            with _PlainCalls("pdu_health_sim") as plain:
                reg, cfg, spec, res, got, wall = run_region(stagger, c["n_racks"], c["duration_s"],
                                                            device=dev)
            walls.append(wall)
            counts = _region_counts()
            if name == "synchronized" and i == 0:
                (engine,) = fleet._ENGINE_CACHE.values()
                cap = engine.launches_at_capture
                nodes = _graph_nodes(engine.graph)
                print(f"grid region {name} cold run: {wall:.4f} s wall (one capture, four campus "
                      f"replays), launches {counts} (warm-up and capture), at capture "
                      f"pdu_health={cap['pdu_health']} (by weight mode none/row/series/events "
                      f"{cap['pdu_health_by_mask']}) admm_step={cap['admm_step']}, plain "
                      f"pdu_health calls {plain.n}; graph nodes {nodes}")
                _check(cap["pdu_health"] == n_int and cap["admm_step"] == n_int
                       and cap["pdu_health_by_mask"][pdu_health.MASK_NONE] == n_int
                       and plain.n == 0,
                       f"grid region capture: launches {cap}, plain calls {plain.n}")
            else:
                _check(counts == (0, 0) and plain.n == 0 and len(fleet._ENGINE_CACHE) == 1,
                       f"grid region {name} run {i + 1}: launches {counts} from Python, plain "
                       f"calls {plain.n}, {len(fleet._ENGINE_CACHE)} cached graphs (every "
                       "campus run of both regions replays one graph)")
        cold_s, warm_s = (walls[0] if name == "synchronized" else None), statistics.median(walls[1:])
        print(f"grid region {name}: walls {', '.join(f'{w:.4f}' for w in walls)} s (first "
              f"{'cold' if cold_s else 'a replay'}; warm median {warm_s:.4f}, spread "
              f"{max(walls[1:]) - min(walls[1:]):.4f}); inter-area {got['mode_mags'][0]:.6e} "
              f"(exact DFT {got['mode_mags_exact'][0]:.6e}), local-plant "
              f"{got['mode_mags'][1]:.6e}, modes_ok={got['modes_ok']}, POI ramp "
              f"{got['poi_max_ramp']:.6f}/s, max |df| {got['max_freq_dev_hz']:.6f} Hz, "
              f"max |dV| {got['max_volt_dev']:.6f} pu")
        rp = res.report_poi
        ring = [bool(v) for v in rp.mode_ok.cpu()]
        _check(ring == ([False, True] if name == "synchronized" else [True, True])
               and bool(rp.ramp_ok) and bool(rp.ok) is (name == "staggered"),
               f"grid region {name}: mode verdicts {ring}, ramp_ok {bool(rp.ramp_ok)}, "
               f"ok {bool(rp.ok)}")
        bad = [f for f in ("campus_rack", "campus_grid")
               if not _weighted_sum_bitwise(res, f, res.poi_rack if f == "campus_rack"
                                            else res.poi_grid)]
        resp = grid.poi_response(res.poi_grid, reg.poi, cfg.sample_dt)
        bad += [f for f, a, b in (("poi_freq_dev", resp.freq_dev_hz, res.poi_freq_dev),
                                  ("poi_volt_dev", resp.volt_dev, res.poi_volt_dev))
                if not _bitwise(a, b)]
        for ci, p in enumerate(res.per_campus):
            bad += [f"{f}[{ci}]" for f in ("campus_rack", "campus_grid", "soc_mean",
                                            "ess_online_frac", "health_trace")
                    if not _bitwise(getattr(res, f)[ci], getattr(p, f))]
        _reset_region_counts()
        for ci, scen in enumerate(reg.campuses):
            alone = fleet.condition(scen, cfg, spec, qp_iters=c["qp_iters"], device=dev,
                                    stream=fleet.StreamOptions(
                                        chunk_intervals=c["chunk_intervals"]))
            bad += [f"campus {ci} alone: {d}" for d in _differing_bits(alone, res.per_campus[ci])]
        _check(_region_counts() == (0, 0), "grid region: a campus alone did not replay the graph")
        print(f"grid region {name}: POI left-to-right weighted sum, poi_response, stacked "
              f"aggregates and each campus alone: "
              f"{'bit for bit' if not bad else 'differ in ' + str(bad)}")
        _check(not bad, f"grid region {name}: {bad}")
        want = JAX_GRID_REGION[name]
        print(f"grid region {name} vs JAX: " + json.dumps(
            {k: [got[k], want[k]] for k in got if k != "campuses"}))
        bad = compare_region(got, want)
        _check(not bad, f"grid region {name} differs from the JAX package: " + "; ".join(bad))
        # The host-side parts of a region run on this result's POI traces.
        k, chunk, _, _, t_total, n_full, rem = fleet._window_geometry(
            cfg, reg.total_samples, c["chunk_intervals"], 0, None)
        bank, mbank = fleet._make_bank(spec, cfg, t_total), grid.mode_bank(t_total, cfg.sample_dt,
                                                                            reg.bands)
        fold_s = _timed(lambda: grid._poi_fold(bank, mbank, chunk, n_full, rem, cfg.sample_dt,
                                               res.poi_rack, res.poi_grid))
        resp_s = _timed(lambda: grid.poi_response(res.poi_grid, reg.poi, cfg.sample_dt))
        print(f"grid region {name}: of the warm wall, the POI fold takes {fold_s:.4f} s and the "
              f"host poi_response {resp_s:.4f} s ({t_total} samples)")
        mags[name] = got["mode_mags"][0]
        out[name] = dict(cold_s=cold_s, warm_s=warm_s, walls=walls, fold_s=fold_s,
                         poi_response_s=resp_s, summary=got, res=res)
    sep = mags["synchronized"] / mags["staggered"]
    print(f"grid region: inter-area separation synchronized / staggered {sep:.1f}x (JAX bank "
          f"{JAX_GRID_REGION['synchronized']['mode_mags'][0] / JAX_GRID_REGION['staggered']['mode_mags'][0]:.1f}x, "
          f"JAX POI's exact DFT "
          f"{JAX_GRID_REGION['synchronized']['mode_mags_exact'][0] / JAX_GRID_REGION['staggered']['mode_mags_exact'][0]:.1f}x)")
    _check(sep >= 10.0, f"grid region: inter-area separation {sep:.2f}x < 10x")
    out.update(capture=cap, nodes=nodes, separation=sep)
    if profile_dir is not None:
        profile_run("grid_region_synchronized",
                    lambda: run_region(False, c["n_racks"], c["duration_s"], device=dev)[-1],
                    profile_dir)
    return out


def _strict_json_lines(path) -> list[dict]:
    """Every line of a JSONL file, parsed as strict JSON (no NaN or
    Infinity literals)."""
    def refuse(x):
        raise ValueError(f"non-standard JSON constant {x}")

    with open(path) as f:
        return [json.loads(line, parse_constant=refuse) for line in f]


def phase_region_service(dev) -> dict:
    """Phase 16b: ``ConditionerService`` over GRID_REGION's synchronized
    region with 4-interval windows and an audit log: advance once, trip a
    global rack of campus 1 (``inject_fault``), read ``status()``, clear
    it; checkpoint, advance, restore into a second service and advance
    there: both windows bit for bit equal in ``poi_grid``, ``campus_rack``
    and ``poi_freq_dev``, and so are the states; then drain.  The log must
    hold ``mode_band_violation`` events, all of the inter-area band above
    its threshold, and every line must be strict JSON.  Windows of one
    length replay one graph.  Returns the walls."""
    import tempfile

    import torch

    from repro_torch.core import compliance, fleet, grid, pdu
    from repro_torch.serve import ConditionerService

    c = GRID_REGION
    reg = grid_region(grid, False, c["n_racks"], c["duration_s"], device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], device=dev)
    spec = compliance.GridSpec.create(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "audit.jsonl"
        svc = ConditionerService(cfg, reg, spec, chunk_intervals=4, qp_iters=c["qp_iters"],
                                 audit_path=log, audit_fsync=True)
        _check(svc.n_racks == c["n_campuses"] * c["n_racks"], f"service racks {svc.n_racks}")
        walls = []

        def advance(s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = s.advance()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return r

        advance(svc)
        rack = c["n_racks"] + 5  # campus 1's local rack 5
        svc.inject_fault([rack])
        st = svc.status()
        _check(float(svc.state[1].ess_online[5]) == 0.0
               and st["manual_offline_racks"] == [rack]
               and st["region"]["campus_racks"] == [c["n_racks"]] * c["n_campuses"]
               and {"peak_power_pu", "max_freq_dev_hz", "mode_bands"} <= set(st["poi"])
               and len(st["campuses"]) == c["n_campuses"],
               f"region service status after inject_fault({rack}): {json.dumps(st)[:400]}")
        svc.clear_fault([rack])
        ck = svc.checkpoint(Path(tmp) / "ck")
        _reset_region_counts()
        live = advance(svc)
        svc2 = ConditionerService(cfg, reg, spec, chunk_intervals=4, qp_iters=c["qp_iters"])
        svc2.restore(ck)
        resumed = advance(svc2)
        _check(_region_counts() == (0, 0), f"region service windows: launches "
               f"{_region_counts()} from Python (a window of a cached length is a replay)")
        bad = [f for f in ("poi_grid", "campus_rack", "poi_freq_dev")
               if not _bitwise(getattr(live, f), getattr(resumed, f))]
        bad += [k for k, v in _result_leaves(svc.state, "state").items()
                if not _bitwise(v, _result_leaves(svc2.state, "state")[k])]
        print(f"region service: a window after restore vs the live one: "
              f"{'bit for bit (poi_grid, campus_rack, poi_freq_dev, every state leaf)' if not bad else 'differs in ' + str(bad)}")
        _check(not bad, f"region service resume differs in {bad}")
        while not svc.exhausted:
            advance(svc)
        events = _strict_json_lines(log)
        mv = [e for e in events if e["event"] == "mode_band_violation"]
        n_win = sum(e["event"] == "window" for e in events)
        print(f"region service: {n_win} windows of 4 intervals, {len(events)} audit lines (strict "
              f"JSON), {len(mv)} mode_band_violation events "
              f"({sorted({e['band'] for e in mv})}, magnitudes "
              f"{min((e['magnitude'] for e in mv), default=0):.4e}-"
              f"{max((e['magnitude'] for e in mv), default=0):.4e}); window walls "
              f"{', '.join(f'{w:.4f}' for w in walls)} s (the first cold)")
        _check(len(events) == len(svc.audit) and mv
               and all(e["band"] == "inter_area" and e["magnitude"] > e["threshold"] for e in mv),
               f"region service log: {len(events)} lines for {len(svc.audit)} events, "
               f"mode_band_violation {mv[:3]}")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return dict(cold_window_s=walls[0], warm_window_s=statistics.median(walls[2:]),
                windows=n_win, mode_band_violations=len(mv))


def phase_campus_service(dev, scanned_ref) -> dict:
    """Phase 16c: FAULTY_CAMPUS under ``ConditionerService`` with
    4-interval windows, three ways: drained whole; killed after window 2
    (auto-checkpoints every window) and brought back by ``recover`` over
    the checkpoint directory, which also holds a torn ``.npz``, then
    drained; drained with auto-checkpoints every window, keeping 3.  The
    three must be bit for bit equal in the campus arrays, ``soc_mean`` and
    ``ess_online_frac``; the windows put together must equal
    ``scanned_ref`` (phase 13's scanned run) within
    FAULTY_CAMPUS_TOLERANCES (``ess_online_frac`` exactly); the fault and
    repair events must be the schedule's ``episodes_in_window`` of each
    window and the degraded events follow the online fraction; exactly
    three checkpoints must remain.  pdu_health runs in its events mode.
    Returns the walls."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import compliance, fleet, pdu
    from repro_torch.kernels import pdu_health
    from repro_torch.power import faults as FLT, scenario as SC
    from repro_torch.serve import ConditionerService

    c = FAULTY_CAMPUS
    s = faulty_campus(SC, FLT, c["n_racks"], c["duration_s"], device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], degraded_mode=True, device=dev)
    spec = compliance.GridSpec.create(device=dev)
    fields = ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()

    def make(**kw):
        return ConditionerService(cfg, s, spec, chunk_intervals=4, qp_iters=c["qp_iters"], **kw)

    walls = []

    def drain(svc, parts, n=None):
        while not svc.exhausted and (n is None or n > 0):
            start = svc.sample_pos
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = svc.advance()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            parts[start] = {f: getattr(r, f).cpu() for f in fields}
            parts[start]["max_qp_residual"] = r.max_qp_residual.cpu()
            n = None if n is None else n - 1
        return parts

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _reset_region_counts()
        whole = drain(make(audit_path=tmp / "audit.jsonl"), {})
        caps = [e.launches_at_capture for e in fleet._ENGINE_CACHE.values()]
        killed = drain(make(checkpoint_dir=tmp / "ck", checkpoint_every=1), {}, n=2)
        (tmp / "ck" / "torn.npz").write_bytes(b"PK\x03\x04" + b"\x00" * 32)
        back = make()
        got = back.recover(tmp / "ck")
        skipped = [e for e in back.audit.tail(50) if e["event"] == "recover_skipped"]
        _check(got is not None and got.endswith("ckpt_000000008000.npz") and len(skipped) == 1,
               f"campus service recover: {got}, skipped {skipped}")
        drain(back, killed)
        auto = drain(make(checkpoint_dir=tmp / "auto", checkpoint_every=1, keep_checkpoints=3), {})
        kept = sorted(os.listdir(tmp / "auto"))
        events = _strict_json_lines(tmp / "audit.jsonl")
    bad = []
    for label, run in (("killed and recovered", killed), ("auto-checkpointed", auto)):
        if run.keys() != whole.keys():
            bad.append(f"{label}: windows {sorted(run)} != {sorted(whole)}")
            continue
        bad += [f"{label} {f} at {k}" for k in whole for f in fields + ("max_qp_residual",)
                if not _bitwise(whole[k][f], run[k][f])]
    starts = sorted(whole)
    edges = [dict(e) for k in starts
             for e in FLT.episodes_in_window(s.faults, k, min(k + 4000, s.total_samples))]
    logged = [{k: v for k, v in e.items() if k != "seq"} for e in events
              if e["event"] in ("fault", "repair")]
    if logged != edges:
        bad.append(f"fault/repair events: {len(logged)} logged, {len(edges)} in the schedule")
    frac = [float(whole[k]["ess_online_frac"].min()) for k in starts]
    want_deg, deg = [], False
    for k, f in zip(starts, frac):
        if f < 1.0 and not deg:
            want_deg.append(("degraded_enter", k))
        elif deg and f >= 1.0:
            want_deg.append(("degraded_exit", k))
        deg = f < 1.0
    got_deg = [(e["event"], e["sample"]) for e in events
               if e["event"] in ("degraded_enter", "degraded_exit")]
    if got_deg != want_deg:
        bad.append(f"degraded events {got_deg} != {want_deg}")
    if kept != ["ckpt_000000012000.npz", "ckpt_000000016000.npz", "ckpt_000000017600.npz"]:
        bad.append(f"checkpoints kept {kept}")
    # The windows put together against phase 13's scanned run.
    cat = {f: torch.cat([whole[k][f] for k in starts]) for f in fields}
    ref = {f: getattr(scanned_ref, f).cpu() for f in fields}
    total = s.total_samples
    bank = compliance.make_bank(total, cfg.sample_dt, float(spec.f_c))
    ramp = lambda x: float(compliance.max_abs_ramp(x, cfg.sample_dt))
    summ = lambda d, worst: {
        "rack_max_ramp": ramp(d["campus_rack"]), "grid_max_ramp": ramp(d["campus_grid"]),
        "rack_worst_line_exact": exact_worst_line(d["campus_rack"], bank),
        "grid_worst_line_exact": exact_worst_line(d["campus_grid"], bank),
        "campus_rack_mean": float(d["campus_rack"].double().mean()),
        "campus_grid_mean": float(d["campus_grid"].double().mean()),
        "soc_mean_min": float(d["soc_mean"].min()), "soc_mean_max": float(d["soc_mean"].max()),
        "soc_mean_last": float(d["soc_mean"][-1]), "max_qp_residual": float(worst)}
    got_s = summ(cat, max(float(whole[k]["max_qp_residual"]) for k in starts))
    want_s = summ(ref, scanned_ref.max_qp_residual)
    for k, (kind, tol) in FAULTY_CAMPUS_TOLERANCES.items():
        if not _within(got_s[k], want_s[k], kind, tol):
            bad.append(f"windows vs phase 13 {k}: {got_s[k]!r} vs {want_s[k]!r}")
    if not _bitwise(cat["ess_online_frac"], ref["ess_online_frac"]):
        bad.append("windows vs phase 13 ess_online_frac")
    same = [f for f in fields if _bitwise(cat[f], ref[f])]
    by_mask = [sum(cap["pdu_health_by_mask"][m] for cap in caps) for m in range(4)]
    print(f"campus service: {len(starts)} windows of 4 intervals (the last "
          f"{total - starts[-1]} samples) drained whole, killed after window 2 and recovered "
          f"({got.rsplit('/', 1)[-1]}, {len(skipped)} torn file skipped), and auto-checkpointed "
          f"(kept {kept}); {len(logged)} fault/repair events, degraded events {got_deg}; captures "
          f"pdu_health by weight mode none/row/series/events {by_mask}, admm_step "
          f"{sum(cap['admm_step'] for cap in caps)}; windows vs phase 13's scanned run: bit for "
          f"bit in {same}, within FAULTY_CAMPUS_TOLERANCES "
          + json.dumps({k: [got_s[k], want_s[k]] for k in got_s}))
    _check(not bad, f"campus service: {bad}")
    _check(by_mask[pdu_health.MASK_EVENTS] == sum(by_mask) == 6,
           f"campus service captures: pdu_health by mask {by_mask} (events mode, 4 + 2)")
    n = len(starts)
    warm = [walls[i] for i in range(n, len(walls)) if (i % n) not in (0, n - 1)] or walls[1:]
    print(f"campus service window walls {', '.join(f'{w:.4f}' for w in walls)} s (the first "
          f"full and the ragged window cold); warm full window median {statistics.median(warm):.4f} s")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return dict(warm_window_s=statistics.median(warm), windows=n, walls=walls,
                capture_by_mask=by_mask)


def _result_leaves(x, prefix: str = "") -> dict:
    """Every tensor of a conditioning result by its path (the reports, the
    state's leaves, the campus arrays)."""
    import dataclasses as dc

    import torch

    if isinstance(x, torch.Tensor):
        return {prefix: x}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(x))
    elif dc.is_dataclass(x) and not isinstance(x, type):
        items = ((f.name, getattr(x, f.name)) for f in dc.fields(x))
    else:
        return {}
    out = {}
    for name, v in items:
        out.update(_result_leaves(v, f"{prefix}.{name}" if prefix else name))
    return out


# What the scanned engine must return bit for bit as the host engine does.
SCANNED_BITWISE = ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac",
                   "max_qp_residual", "health_trace", "state", "report_rack", "report_grid")


def _differing_bits(a, b) -> list[str]:
    """The tensors of ``SCANNED_BITWISE`` in which two results differ."""
    bad = []
    for field in SCANNED_BITWISE:
        la, lb = _result_leaves(getattr(a, field), field), _result_leaves(getattr(b, field), field)
        if la.keys() != lb.keys():
            bad.append(f"{field}: fields {sorted(la)} != {sorted(lb)}")
            continue
        bad += [k for k in la if not _bitwise(la[k], lb[k])]
    return bad


def _graph_nodes(graph) -> dict:
    """The captured graph's node count by type (kernel, memcpy, memset,
    other), read from the raw graph the scanned engine keeps."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    out = {"total": n.value}
    for node in nodes:
        t = ctypes.c_int(-1)
        lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        key = names.get(t.value, "other")
        out[key] = out.get(key, 0) + 1
    return out


def phase_scanned(label: str, run, host_res, host_peak: int, mask: int, chunk_intervals: int,
                  profile_dir: Path | None = None) -> dict:
    """The scanned engine (``fleet.condition``'s default: the window as one
    CUDA graph) on a campus of phase 4 or 13.  ``run(engine, **window)``
    returns ``(result, wall seconds, extra)``.  One cold run (warm-up and
    capture) and three warm runs, after the engine's cache is emptied:
    the capture must record pdu_health (in weight mode ``mask``) and
    admm_step 18 times each with no plain pdu_health call, a warm run must
    launch nothing from Python (a replay), and every output must equal the
    host engine's ``host_res`` bit for bit; successive one-chunk windows,
    each resumed from the last one's state, must replay one graph with the
    reserved memory flat and together equal the one-call run.  With
    ``profile_dir`` a warm replay is profiled, and one host-engine run is
    timed by ``core.profiling``'s spans.  The cached graphs are dropped at
    the end.  Returns the last warm result, its ``extra``, the walls, the
    capture's counts, the graph's nodes and the peak memory."""
    import torch

    from repro_torch.core import fleet, profiling
    from repro_torch.kernels import admm_step, pdu_health

    def reset():
        pdu_health.pdu_health_sim.launches = 0
        pdu_health.pdu_health_sim.launches_by_mask = [0, 0, 0, 0]
        admm_step.admm_iterate.launches = 0

    def counts():
        return (pdu_health.pdu_health_sim.launches, admm_step.admm_iterate.launches)

    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    reset()
    base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    with _PlainCalls("pdu_health_sim") as plain:
        res, cold_s, _ = run()
    cold_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_reserved() - reserved
    (engine,) = fleet._ENGINE_CACHE.values()
    cap = engine.launches_at_capture
    nodes = _graph_nodes(engine.graph)
    print(f"{label} scanned cold run: {cold_s:.4f} s wall (warm-up, capture and one replay), "
          f"launches {counts()} (warm-up and capture), at capture pdu_health={cap['pdu_health']} "
          f"(by weight mode none/row/series/events {cap['pdu_health_by_mask']}) "
          f"admm_step={cap['admm_step']}, plain pdu_health calls {plain.n}; graph nodes {nodes}")
    _check(cap["pdu_health"] == 18 and cap["admm_step"] == 18
           and cap["pdu_health_by_mask"][mask] == 18 and plain.n == 0,
           f"{label} scanned: capture launches {cap}, plain calls {plain.n}")
    bad = _differing_bits(res, host_res)
    _check(not bad, f"{label} scanned cold run differs from the host engine in {bad}")
    walls = []
    for i in range(3):
        reset()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _PlainCalls("pdu_health_sim") as plain:
            res, wall, extra = run()
        warm_peak = torch.cuda.max_memory_allocated() - base
        walls.append(wall)
        _check(counts() == (0, 0) and plain.n == 0,
               f"{label} scanned warm run {i + 1}: launches {counts()} from Python, plain calls "
               f"{plain.n} (a replay launches none)")
        bad = _differing_bits(res, host_res)
        _check(not bad, f"{label} scanned warm run {i + 1} differs from the host engine in {bad}")
    warm_s = statistics.median(walls)
    print(f"{label} scanned warm runs: {', '.join(f'{w:.4f}' for w in walls)} s wall (median "
          f"{warm_s:.4f}, spread {max(walls) - min(walls):.4f}), launches from Python 0, every "
          f"output bit for bit the host engine's")
    print(f"{label} peak memory above the base: host engine {host_peak / 2**20:.1f} MiB, scanned "
          f"cold {cold_peak / 2**20:.1f} MiB, scanned warm {warm_peak / 2**20:.1f} MiB (the "
          f"cached graph keeps {held / 2**20:.1f} MiB reserved: its pool and static buffers)")
    # Successive windows of one chunk each, each resumed from the last
    # one's state.  The start is read on the card, so the windows of one
    # length replay one graph: after the first captures it, they launch
    # nothing from Python and the reserved memory stays flat.  The ragged
    # last window is a key of its own.  Together they are the one-call run.
    w = chunk_intervals * engine.geometry["k"]
    total = host_res.campus_grid.shape[0]
    fields = ("campus_rack", "campus_grid", "soc_mean", "ess_online_frac", "health_trace")
    parts, state, resumed, reserved = {f: [] for f in fields}, None, [], []
    worst = None
    for s0 in range(0, total, w):
        reset()
        part, wall, _ = run(start_sample=s0, stop_sample=min(s0 + w, total), state=state)
        state = part.state
        for f in fields:
            parts[f].append(getattr(part, f).cpu())
        worst = part.max_qp_residual if worst is None else torch.maximum(worst,
                                                                         part.max_qp_residual)
        del part
        if s0 and s0 + w <= total:
            _check(counts() == (0, 0), f"{label} scanned window at {s0}: launches {counts()} "
                   "from Python (a window of a cached length is a replay)")
            resumed.append(wall)
        if s0 + w <= total:
            reserved.append(torch.cuda.memory_reserved())
    bad = [f for f in fields if not _bitwise(torch.cat(parts[f]), getattr(host_res, f).cpu())]
    bad += [k for k, v in _result_leaves(state, "state").items()
            if not _bitwise(v, _result_leaves(host_res.state, "state")[k])]
    if not _bitwise(worst, host_res.max_qp_residual):
        bad.append("max_qp_residual")
    n_win = -(-total // w)
    print(f"{label} scanned windows: {n_win} windows of {w} samples (the last "
          f"{total - (n_win - 1) * w}), each resumed from the last one's state: "
          f"{'bit for bit the one-call run' if not bad else 'differs in ' + str(bad)}; warm "
          f"resumed windows {', '.join(f'{x:.4f}' for x in resumed)} s wall (median "
          f"{statistics.median(resumed):.4f}); memory reserved after each full window "
          f"{[round(x / 2**20, 1) for x in reserved]} MiB; cached graphs "
          f"{len(fleet._ENGINE_CACHE)}")
    _check(not bad, f"{label} scanned windows of {w} samples differ from one call in {bad}")
    _check(len(set(reserved)) == 1,
           f"{label} scanned windows: memory reserved grew across windows of one length "
           f"({reserved})")
    if profile_dir is not None:
        tag = label.replace(" ", "_")
        profile_run(f"{tag}_scanned", lambda: run()[1], profile_dir)
        profiling.enable()
        try:
            _, wall, _ = run("host")
            ph = profiling.phases()
        finally:
            profiling.disable()
        print(f"profile: {label} host engine under core.profiling spans, {wall:.4f} s wall: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in ph.items())
              + f" (sum {sum(ph.values()):.4f})")
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    return dict(res=res, extra=extra, cold_s=cold_s, warm_s=warm_s, warm_walls=walls,
                window_warm_s=statistics.median(resumed), reserved_mib=reserved[-1] / 2**20,
                capture=cap, nodes=nodes, peak_mib=dict(host=host_peak / 2**20,
                                                        cold=cold_peak / 2**20,
                                                        warm=warm_peak / 2**20,
                                                        held_reserved=held / 2**20))


def profile_run(label: str, run, out_dir: Path) -> None:
    """``run()`` (which returns its wall seconds) once more under
    torch.profiler: device time by kernel and the device's busy share of
    the run's wall time (both inflated a little by the profiler itself).
    Writes the table and a Chrome trace into ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # Device-side entries only (the kernels); the host ops that launched
    # them repeat the same time.
    rows = sorted(((dev_us(e), e.count, e.key) for e in avgs
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
    (out_dir / f"{label}_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out_dir / f"{label}_trace.json.gz"))
    print(f"profile: {label} run {wall * 1e3:.1f} ms wall under the profiler, kernels "
          f"{busy_us / 1e3:.2f} ms in {sum(r[1] for r in rows)} launches "
          f"(device busy {100 * busy_us / 1e3 / (wall * 1e3):.1f} %)")
    for us, count, key in rows[:12]:
        print(f"profile:   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


# Phase 23: the sharded engines over ranks that share the one card (gloo:
# nccl refuses two ranks on one device), and a world of one nccl rank.
SHARDED = dict(region_ranks=4, campus_ranks=2, warm_runs=2, join_s=240.0)


def _gather_alone(tree, mesh, axis: str) -> dict:
    """The bytes of ``tree``'s leaves (what one rank sends into a gather of
    it, from the shapes) and the median seconds of five gathers of it over
    ``axis`` alone, each after a barrier: the engines' ``gather`` spans
    also hold the wait for the slowest rank."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.utils.trees import tree_leaves

    walls = []
    for _ in range(5):
        dist.barrier()
        walls.append(_timed(lambda: sharding.all_gather_tree(tree, mesh, axis)))
    return dict(bytes=sum(t.numel() * t.element_size() for t in tree_leaves(tree)),
                alone_s=statistics.median(walls))


def _sharded_rank(rank: int, world: int, store: str, backend: str, job: str, out_dir: str):
    """One rank of a phase-23 world: joins it, runs ``job`` and writes its
    results (every result leaf on the host, walls, launch counts) to
    ``out_dir/rank{rank}.pt``.  ``job`` is ``"region"`` (23a and 23c) or
    ``"campus"`` (23b)."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.core import compliance, fleet, grid, pdu, profiling
    from repro_torch.launch.mesh import init_world
    from repro_torch.serve import ConditionerService

    init_world(rank, world, f"file://{store}", device_type="cuda", backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    host = lambda res: {k: v.detach().cpu() for k, v in _result_leaves(res).items()}
    out: dict = {"backend": backend}
    profiling.enable()
    if job == "region":
        c = GRID_REGION
        mesh = sharding.region_mesh(world, device_type="cuda")
        for name, stagger in (("synchronized", False), ("staggered", True)):
            fleet._ENGINE_CACHE.clear()
            walls, spans = [], []
            for i in range(1 + SHARDED["warm_runs"]):
                _reset_region_counts()
                profiling.enable()
                with _PlainCalls("pdu_health_sim") as plain:
                    reg, cfg, spec, res, _, wall = run_region(stagger, c["n_racks"],
                                                              c["duration_s"], device=dev,
                                                              mesh=mesh)
                walls.append(wall)
                spans.append(profiling.phases())
                if i == 0:
                    (engine,) = fleet._ENGINE_CACHE.values()
                    out[f"{name}/capture"] = dict(engine.launches_at_capture, plain=plain.n,
                                                  counts=_region_counts())
                else:
                    _check(_region_counts() == (0, 0) and plain.n == 0,
                           f"sharded region {name} rank {rank}: warm run {i} launched "
                           f"{_region_counts()} from Python, {plain.n} plain calls")
            p = res.per_campus[sharding.axis_index(mesh, sharding.CAMPUS_AXIS)]
            out[f"{name}/walls"], out[f"{name}/spans"] = walls, spans
            out[f"{name}/gather"] = _gather_alone(
                (p.state, p.campus_rack, p.campus_grid, p.soc_mean, p.max_qp_residual,
                 p.health_trace, p.ess_online_frac, p.safemode_trace, p.observers),
                mesh, sharding.CAMPUS_AXIS)
            out[f"{name}/res"] = host(res)
        fleet._ENGINE_CACHE.clear()
        reg = grid_region(grid, False, c["n_racks"], c["duration_s"], device=dev)
        cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], device=dev)
        svc = ConditionerService(cfg, reg, compliance.GridSpec.create(device=dev),
                                 chunk_intervals=4, qp_iters=c["qp_iters"], mesh=mesh)
        out["service/wall"] = _timed(lambda: out.__setitem__("service/res", host(svc.advance())))
    else:
        c = CAMPUS
        mesh = sharding.make_mesh((world,), (sharding.RACK_AXIS,), device_type="cuda")
        for engine in ("host", "scanned"):
            fleet._ENGINE_CACHE.clear()
            walls, spans = [], []
            for i in range(1 + SHARDED["warm_runs"]):
                _reset_region_counts()
                profiling.enable()
                with _PlainCalls("pdu_health_sim") as plain:
                    res, hsum, wall = run_campus(c["n_racks"], c["duration_s"], device=dev,
                                                 engine=engine, mesh=mesh)
                walls.append(wall)
                spans.append(profiling.phases())
                if i == 0:
                    counts = _region_counts()
                    if engine == "scanned":
                        (eng,) = fleet._ENGINE_CACHE.values()
                        counts = (eng.launches_at_capture["pdu_health"],
                                  eng.launches_at_capture["admm_step"])
                    out[f"{engine}/launches"] = dict(pdu_health=counts[0], admm_step=counts[1],
                                                     plain=plain.n)
            lo, hi = sharding.rack_block(c["n_racks"], mesh)
            out[f"{engine}/walls"], out[f"{engine}/spans"] = walls, spans
            out[f"{engine}/gather"] = _gather_alone(
                (fleet._map_state_racks(res.state, lambda t, ax: t.narrow(ax, lo, hi - lo)),
                 res.campus_rack, res.campus_grid, res.soc_mean, res.max_qp_residual,
                 res.health_trace, res.ess_online_frac, res.safemode_trace), mesh, sharding.RACK_AXIS)
            out[f"{engine}/res"], out[f"{engine}/health"] = host(res), hsum
    profiling.disable()
    fleet._ENGINE_CACHE.clear()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _walls(walls) -> str:
    return ", ".join(f"{w:.4f}" for w in walls)


def _span_line(spans) -> str:
    """``core.profiling`` spans of each run (``replay``: the scanned
    engine's graph, its capture in a cold run; ``gather``: the engine's
    collectives and the wait for the slowest rank)."""
    names = sorted({k for s in spans for k in s})
    return "; ".join(f"{k} {_walls([s.get(k, 0.0) for s in spans])}" for k in names)


def _gather_line(g: dict) -> str:
    return f"a gather alone {g['alone_s']:.5f} s for {g['bytes']} bytes a rank"


def _run_world(world: int, backend: str, job: str, target=None,
               join_s: float = SHARDED["join_s"], during=None) -> list[dict]:
    """Every rank's results of one world of ``target`` ranks (phase 23's
    ``_sharded_rank`` by default), its ranks started together (``spawn``);
    ``during()`` runs in this process while they run.  A rank that fails,
    or a world that outlasts ``join_s``, fails the run."""
    import multiprocessing as mp
    import tempfile

    import torch

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = [ctx.Process(target=target or _sharded_rank,
                             args=(r, world, f"{tmp}/store", backend, job, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_s
        try:
            if during is not None:
                during()
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        _check(not alive and all(code == 0 for code in codes),
               f"{job} world of {world} {backend} ranks: exit codes {codes}, still "
               f"running after {join_s} s: {alive}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


# A rack-sharded campus's envelope against the unsharded run: the campus
# means combine the ranks' block means in rank order, within SHARDED_AGG_TOL
# of the one-rank mean (the reference's LC-chain envelope).
SHARDED_AGG_TOL = 1e-6


def sharded_campus_tolerance(k: str, dt: float, n_samples: int) -> float | None:
    """The absolute tolerance of the leaf at path ``k`` of a rack-sharded
    campus result against the unsharded run's (0.0: bit for bit), derived
    from the means' envelope ``e = SHARDED_AGG_TOL``, or None for a leaf no
    rule covers.  Per-rack leaves, counts, maxima and verdicts are exact; a
    campus mean and an observer's last sample are within e; a ramp is a
    difference of two such samples over dt (2 e / dt); a spectrum line is a
    window-weighted sum of the trace scaled by 2 over the window's sum of
    weights, so it moves by at most 2 e; an observer's unscaled line sum, a
    sum of at most ``n_samples`` weights <= 1, by ``n_samples`` e."""
    e = SHARDED_AGG_TOL
    if k.startswith(("state.", "health.", "grid_spec.")) or k.endswith(
            ("_ok", ".ok", ".n", ".phase")) or k in (
            "ess_online_frac", "max_qp_residual", "safemode_trace"):
        return 0.0
    if k in ("campus_rack", "campus_grid", "soc_mean", "health_trace") or k.endswith(".last"):
        return e  # health_trace: [mean EFC, max fade, max DoD], the maxima checked exactly
    if k.endswith(".max_ramp"):
        return 2 * e / dt
    if k.endswith(".worst_high_freq_mag"):
        return 2 * e
    if k.endswith((".acc_re", ".acc_im")):
        return n_samples * e
    return None


def _sharded_campus_check(label: str, got: dict, want: dict, one_rank: bool,
                          dt: float) -> list[str]:
    """What differs between a rack-sharded campus result and the unsharded
    one (leaves by path), each leaf held to ``sharded_campus_tolerance``
    (a leaf no rule covers fails); over one rank, every leaf bit for bit."""
    import torch

    bad = [f"{label} {k}: not in the unsharded result" for k in got.keys() - want.keys()]
    n_samples = want["campus_rack"].shape[0]
    for k, w in want.items():
        g = got.get(k)
        tol = 0.0 if one_rank else sharded_campus_tolerance(k, dt, n_samples)
        if g is None or g.shape != w.shape or g.dtype != w.dtype:
            bad.append(f"{label} {k}: missing, or shape or dtype")
        elif tol is None:
            bad.append(f"{label} {k}: no rule holds this leaf")
        elif k == "health_trace" and not torch.equal(g[:, 1:], w[:, 1:]):
            bad.append(f"{label} {k}: the maxima not bit for bit")
        elif tol == 0.0:
            if not torch.equal(g, w):
                bad.append(f"{label} {k}: not bit for bit")
        else:
            err = float((g.double() - w.double()).abs().max())
            if not err <= tol:
                bad.append(f"{label} {k}: {err:.3e} > {tol:.3e}")
    return bad


def phase_sharded(dev, campus: dict, region: dict) -> dict:
    """Phase 23: the sharded region engine, the region service and rack
    sharding over worlds of ranks that share the one card (``SHARDED``);
    ``campus`` is phase 4's return, ``region`` phase 16a's.  Returns the
    walls, the gathers and the ranks' capture launches."""
    import torch

    from repro_torch.core import compliance, fleet, grid, pdu
    from repro_torch.serve import ConditionerService

    t_phase = time.perf_counter()
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    c = GRID_REGION
    n_int = int(c["duration_s"] / 5.0)
    # (c)'s reference: the one-rank service's first window.
    reg = grid_region(grid, False, c["n_racks"], c["duration_s"], device=dev)
    cfg = pdu.make_pdu(sample_dt=1.0 / c["sample_hz"], device=dev)
    svc = ConditionerService(cfg, reg, compliance.GridSpec.create(device=dev), chunk_intervals=4,
                             qp_iters=c["qp_iters"])
    service_ref = {k: v.cpu() for k, v in _result_leaves(svc.advance()).items()}
    fleet._ENGINE_CACHE.clear()
    torch.cuda.empty_cache()
    note = "ranks sharing one card: not a multi-GPU scaling figure"
    out = {}

    t0 = time.perf_counter()
    ranks = _run_world(SHARDED["region_ranks"], "gloo", "region")
    out["region_world_s"] = time.perf_counter() - t0
    captures = []
    for name in ("synchronized", "staggered"):
        want = {k: v.cpu() for k, v in _result_leaves(region[name]["res"]).items()}
        for r, o in enumerate(ranks):
            cap = o[f"{name}/capture"]
            captures.append(cap)
            bad = [k for k, w in want.items()
                   if k not in o[f"{name}/res"] or not _bitwise(o[f"{name}/res"][k], w)]
            print(f"23a sharded region {name}, rank {r} of {len(ranks)} ({o['backend']}; {note}):"
                  f" walls {_walls(o[f'{name}/walls'])} s (first cold), spans "
                  f"{_span_line(o[f'{name}/spans'])}; {_gather_line(o[f'{name}/gather'])}; "
                  f"capture pdu_health="
                  f"{cap['pdu_health']} admm_step={cap['admm_step']}, plain pdu_health calls "
                  f"{cap['plain']}; vs phase 16a "
                  f"{'bit for bit (' + str(len(want)) + ' leaves)' if not bad else bad[:6]}")
            _check(not bad and cap["pdu_health"] == n_int and cap["admm_step"] == n_int
                   and cap["plain"] == 0,
                   f"23a sharded region {name} rank {r}: differs in {bad[:6]}, capture {cap}")
    bad = [r for r, o in enumerate(ranks)
           if not all(_bitwise(o["service/res"][k], v) for k, v in service_ref.items())]
    print(f"23c region service with the mesh: one window on each rank ("
          f"{', '.join(f'{o['service/wall']:.4f}' for o in ranks)} s, cold; {note}) vs the "
          f"one-rank service's: {'bit for bit' if not bad else 'differs on ranks ' + str(bad)}")
    _check(not bad, f"23c region service window differs on ranks {bad}")

    worlds, counts = {}, {"pdu_health": 0, "admm_step": 0}
    for world, backend in ((SHARDED["campus_ranks"], "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        ranks = _run_world(world, backend, "campus")
        worlds[f"{world}x{backend}"] = time.perf_counter() - t0
        for engine, ref in (("host", campus["host_res"]), ("scanned", campus["scanned"]["res"])):
            want = {k: v.cpu() for k, v in _result_leaves(ref).items()}
            for r, o in enumerate(ranks):
                bad = _sharded_campus_check(f"{engine} rank {r}", o[f"{engine}/res"], want,
                                            world == 1, 1.0 / CAMPUS["sample_hz"])
                err = {k: float((o[f"{engine}/res"][k].double() - want[k].double()).abs().max())
                       for k in ("campus_rack", "campus_grid", "soc_mean",
                                 "report_rack.max_ramp", "report_grid.max_ramp",
                                 "report_rack.worst_high_freq_mag",
                                 "report_grid.worst_high_freq_mag")}
                n = o[f"{engine}/launches"]
                for k in counts:
                    counts[k] += n[k]
                print(f"23b rack-sharded campus, {engine} engine, rank {r} of {world} "
                      f"({backend}; {note}): walls {_walls(o[f'{engine}/walls'])} s (first "
                      f"cold), spans {_span_line(o[f'{engine}/spans'])}; "
                      f"{_gather_line(o[f'{engine}/gather'])}; launches pdu_health="
                      f"{n['pdu_health']} admm_step={n['admm_step']} (plain {n['plain']}); vs "
                      f"phase 4: per-rack leaves bit for bit, differences "
                      f"{', '.join(f'{k} {v:.3e}' for k, v in err.items())} (each within "
                      f"sharded_campus_tolerance)"
                      f"{'' if not bad else '; DIFFERS ' + str(bad[:6])}")
                _check(not bad and n["pdu_health"] == 18 and n["admm_step"] == 18
                       and n["plain"] == 0,
                       f"23b {engine} over {world} {backend} ranks, rank {r}: {bad[:6]}, "
                       f"launches {n}")
    out.update(worlds_s=worlds, captures=captures, campus_counts=counts,
               phase_s=time.perf_counter() - t_phase)
    print(f"phase 23 (sharded engines): {out['phase_s']:.1f} s (region world "
          f"{out['region_world_s']:.1f} s, campus worlds "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in worlds.items())})")
    return out


# Phase 24: FSDP training on the rules' layout (``sharding.fsdp``).  (a) A
# world of one nccl rank trains llama3.2-1b at full width and depth on
# phase 8a's start weights and steps (TRAIN), bit for bit phase 8a; (b) two
# gloo ranks sharing the card train it at full width cut to ``layers``
# layers (every gather goes through the host, so full depth would cost the
# script's time), 4 x 512 global tokens, 2 x 512 a rank, at each of
# ``configs`` ((microbatches, gather_small_weights_once)) for ``steps``
# steps, held to one process's unsharded run within TRAIN_TOL; (c) (b)'s
# last run saved, restored into one process (this one, while (b)'s ranks
# go on) and back into (b)'s two ranks, bit for bit, and a step from it
# bit for bit the step without the restore.  ``wait_s`` bounds this
# process's wait for the ranks' save.
FSDP = dict(layers=4, steps=2, configs=((1, False), (2, True)), join_s=300.0, wait_s=240.0)
FSDP_DIR = ROOT / "build" / "phase24"


def _fsdp_cfg(layers: int | None = None):
    import dataclasses

    from repro_torch.configs import full_config

    cfg = full_config(TRAIN["arch"])
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _fsdp_model(cfg, start: dict, dev):
    """A ``Transformer`` of ``cfg`` on ``dev`` holding ``start`` (host
    tensors by name)."""
    import torch

    from repro_torch.models import transformer as T

    model = T.Transformer(cfg, device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    return model


def _fsdp_step(cfg, mb: int = 1, once: bool = False):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step

    opt = AdamWConfig(lr=TRAIN["lr"])
    return opt, build_train_step(cfg, opt, microbatches=mb, gather_small_weights_once=once,
                                 total_steps=TRAIN["total_steps"],
                                 warmup_steps=TRAIN["warmup_steps"])


def _fsdp_data(cfg):
    from repro_torch.data import DataConfig, SyntheticLMDataset

    return SyntheticLMDataset(DataConfig(seed=TRAIN["seed"], batch=TRAIN["batch"],
                                         seq_len=TRAIN["seq_len"], vocab_size=cfg.vocab_size))


def _fsdp_samples(params: dict, get, leaves=TRAIN_LEAVES) -> dict:
    """This rank's part of ``train_samples``: ``{path: {k: value}}`` for
    the k-th sampled element of each full leaf that lies in this rank's
    shard (``get(name)`` the shard of parameter ``name``, or its moment's;
    split along its data dim and, under tensor parallelism, its model
    dim)."""
    import numpy as np
    import torch

    from repro_torch.sharding import fsdp

    out = {}
    for i, path in enumerate(leaves):
        name = _port_leaf(path)
        x, info = get(name), fsdp.shard_of(params[name])
        splits = [(info.dim, info.size, info.rank)]
        if info.model_dim is not None:
            splits.append((info.model_dim, info.model.size, info.model.rank))
        splits = [sp for sp in splits if sp[0] is not None]
        full = list(x.shape)
        for dim, size, _ in splits:
            full[dim] *= size
        multi = list(np.unravel_index(train_indices(tuple(full), i), full))
        keep = np.ones(len(multi[0]), bool)
        for dim, _, rank in splits:
            lo = rank * x.shape[dim]
            keep &= (multi[dim] >= lo) & (multi[dim] < lo + x.shape[dim])
            multi[dim] = multi[dim] - lo
        idx = tuple(torch.as_tensor(m[keep], device=x.device) for m in multi)
        vals = x.detach()[idx].to(torch.float64).cpu().tolist()
        out[path] = dict(zip(np.nonzero(keep)[0].tolist(), vals))
    return out


def _merge_samples(parts: list) -> dict:
    """``train_samples`` from the ranks' ``_fsdp_samples``."""
    out = {}
    for path in parts[0]:
        got = {}
        for p in parts:
            got.update(p[path])
        out[path] = [got[k] for k in range(len(got))]
    return out


def _fsdp_rank(rank: int, world: int, store: str, backend: str, job: str, out_dir: str):
    """One rank of a phase-24 world: joins it, places the model on
    ``make_host_mesh()`` and runs ``job`` ("a", or "b" with (c)), writing
    its results to ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import profiling
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import fsdp
    from repro_torch.train import Checkpointer

    t0 = time.perf_counter()
    init_world(rank, world, f"file://{store}", device_type="cuda", backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm"])
    mesh = make_host_mesh(device_type="cuda")
    dist.barrier()  # the backend's first collective (nccl builds its communicator)
    t1 = time.perf_counter()
    cfg = _fsdp_cfg(None if job == "a" else FSDP["layers"])
    start = torch.load(FSDP_DIR / ("start.pt" if job == "a" else "start4.pt"), mmap=True)
    ds = _fsdp_data(cfg)
    out: dict = {"backend": backend, "join_s": t1 - t0, "load_s": time.perf_counter() - t1}

    def placed():
        model = fsdp.shard_model(_fsdp_model(cfg, start, dev), mesh)
        return model, dict(model.named_parameters())

    def run_steps(model, params, state, step, first: int, n: int, tag: str):
        walls, losses, norms, counts, moments = [], [], [], [], []
        for i in range(first, first + n):
            batch = ds.batch_at(i)
            torch.cuda.synchronize()
            _reset_train_counts()
            t0 = time.perf_counter()
            _, state, m = step(model, state, batch, i)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(_train_counts())
            moments.append(_fsdp_samples(params, lambda n_: state.m[n_]))
        out.update({f"{tag}/walls": walls, f"{tag}/loss": losses, f"{tag}/grad_norm": norms,
                    f"{tag}/counts": counts, f"{tag}/m": moments})
        return state

    if job == "a":
        model, params = placed()
        del start
        opt, step = _fsdp_step(cfg)
        state = adamw_init(params, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        state = run_steps(model, params, state, step, 0, TRAIN["steps"], "a")
        out["a/peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["a/prints"] = _bit_prints(_train_state(params, state))
        profiling.enable()  # a further step with the collectives timed (synchronized)
        _reset_train_counts()
        t0 = time.perf_counter()
        step(model, state, ds.batch_at(TRAIN["steps"]), TRAIN["steps"])
        torch.cuda.synchronize()
        out["a/profiled_wall"] = time.perf_counter() - t0
        out["a/profiled/counts"] = [_train_counts()]
        out["a/spans"] = profiling.phases()
        profiling.disable()
    elif job == "b":
        for mb, once in FSDP["configs"]:
            tag = f"b/mb{mb}{'once' if once else ''}"
            model, params = placed()
            opt, step = _fsdp_step(cfg, mb, once)
            state = adamw_init(params, opt)
            profiling.enable()
            state = run_steps(model, params, state, step, 0, FSDP["steps"], tag)
            out[f"{tag}/spans"] = profiling.phases()
            profiling.disable()
            host = lambda t: t.detach().to("cpu", copy=True)
            for n, p in params.items():
                out[f"{tag}/param/{n}"] = host(p)
                info = fsdp.shard_of(p)
                out[f"{tag}/dim/{n}"] = info.dim
                if info.dim is None:
                    out[f"{tag}/m/{n}"], out[f"{tag}/v/{n}"] = host(state.m[n]), host(state.v[n])
        # (c): the last run saved, its next step; the save restored into a
        # fresh placement, and that step again
        t0 = time.perf_counter()
        Checkpointer(str(FSDP_DIR / "ckpt2")).save(
            FSDP["steps"] - 1, (params, state), shardings=fsdp.shardings(model, state),
            blocking=True)
        out["c/save_s"] = time.perf_counter() - t0
        out["c/saved"] = _bit_prints(_train_state(params, state))
        state = run_steps(model, params, state, step, FSDP["steps"], 1, "c/live")
        out["c/live"] = _bit_prints(_train_state(params, state))
        del model, params, state
        model, params = placed()
        del start
        state = adamw_init(params, opt)
        t0 = time.perf_counter()
        _, (got, state) = Checkpointer(str(FSDP_DIR / "ckpt2")).restore(
            None, (params, state), shardings=fsdp.shardings(model, state))
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(got[n])
        del got
        out["c/restore_s"] = time.perf_counter() - t0
        out["c/restored"] = _bit_prints(_train_state(params, state))
        state = run_steps(model, params, state, step, FSDP["steps"], 1, "c/again")
        out["c/again"] = _bit_prints(_train_state(params, state))
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _bf16_loose_bad(got, want, lr: float, steps: int) -> int:
    """Elements of ``got`` farther from ``want`` than TRAIN_TOL's loose
    bound, ``2 lr`` a step plus a bf16 ulp of the larger of the two values
    (each side rounds its update to bf16 at its own magnitude: where a
    sign flip carries ``got`` an order of magnitude past a small ``want``,
    its rounding is the larger)."""
    import torch

    g, w = got.double(), want.double()
    top = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(top != 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                      torch.full_like(w, 2.0 ** -133))
    return int(((g - w).abs() > 2 * lr * steps + ulp).sum())


def phase_fsdp(dev, steps_8a: dict, start_8a: dict) -> dict:
    """Phase 24 (``FSDP``): (a) the one-rank nccl world from phase 8a's
    start weights ``start_8a`` against its steps ``steps_8a``
    (``phase_train``), (b) the two-rank gloo world against one process's
    unsharded run, (c) the checkpoint across worlds.  The ranks read their
    start weights from ``FSDP_DIR``, which is removed at the end."""
    import shutil

    import torch

    from repro_torch.optim import adamw_init
    from repro_torch.sharding import fsdp
    from repro_torch.train import Checkpointer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    note = "one rank, not a scaling figure"
    out = {}
    FSDP_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(start_8a, FSDP_DIR / "start.pt")

    # (a) one nccl rank, full width and depth, against phase 8a
    t0 = time.perf_counter()
    (a,) = _run_world(1, "nccl", "a", target=_fsdp_rank, join_s=FSDP["join_s"])
    out["a_world_s"] = time.perf_counter() - t0
    want = steps_8a
    bad = [k for k, v in want["prints"].items() if a["a/prints"].get(k) != v]
    L = _fsdp_cfg().n_layers
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
                "flash_attention_bwd_dq": L, "rmsnorm": (2 * L + 1) + 2 * L}
    spans = a["a/spans"]
    coll = spans.get("fsdp.gather", 0.0) + spans.get("fsdp.reduce", 0.0)
    print(f"24a FSDP, one nccl rank ({note}): llama3.2-1b full width, 16 layers, "
          f"{TRAIN['batch']} x {TRAIN['seq_len']}: the rank joined in {a['join_s']:.2f} s, "
          f"loaded the weights in {a['load_s']:.2f} s; step walls {_walls(a['a/walls'])} s (the "
          f"first cold), peak "
          f"memory {a['a/peak_gb']:.2f} GB, losses {a['a/loss']}, grad norms {a['a/grad_norm']}, "
          f"launches a step {a['a/counts']}; a synchronized step {a['a/profiled_wall']:.4f} s, "
          f"of it collectives {coll:.4f} s ({coll / a['a/profiled_wall']:.3f}: fsdp.gather "
          f"{spans.get('fsdp.gather', 0.0):.4f} s, fsdp.reduce {spans.get('fsdp.reduce', 0.0):.4f}"
          f" s); vs phase 8a: {'bit for bit (' + str(len(want['prints'])) + ' tensors)' if not bad else 'DIFFERS ' + str(bad[:6])}")
    _check(not bad and a["a/loss"] == want["loss"] and a["a/grad_norm"] == want["grad_norm"],
           f"24a: one rank differs from phase 8a: losses {a['a/loss']} vs {want['loss']}, grad "
           f"norms {a['a/grad_norm']} vs {want['grad_norm']}, tensors {bad[:6]}")
    _check(all(c == per_step for c in a["a/counts"]),
           f"24a launches {a['a/counts']}, want {per_step} a step")
    out.update(a_walls=a["a/walls"], a_peak_gb=a["a/peak_gb"], a_counts=a["a/counts"][-1],
               a_collective_share=coll / a["a/profiled_wall"])

    # (b) two gloo ranks, 4 layers; meanwhile this process runs the unsharded
    # reference and (c)'s restore into one process and its save
    cfg = _fsdp_cfg(FSDP["layers"])
    start = {n: t for n, t in start_8a.items()
             if not n.startswith("blocks.") or int(n.split(".")[1]) < FSDP["layers"]}
    del start_8a
    torch.save(start, FSDP_DIR / "start4.pt")
    dims = fsdp.data_dims(start, {"data": 2, "model": 1})
    ds, refs, one = _fsdp_data(cfg), {}, {}

    def during():
        for mb, once in FSDP["configs"]:
            tag = f"b/mb{mb}{'once' if once else ''}"
            model = _fsdp_model(cfg, start, dev)
            params = dict(model.named_parameters())
            opt, step = _fsdp_step(cfg, mb, once)
            state = adamw_init(params, opt)
            r = {"loss": [], "grad_norm": [], "counts": [], "m": []}
            for i in range(FSDP["steps"]):
                _reset_train_counts()
                _, state, m = step(model, state, ds.batch_at(i), i)
                r["loss"].append(float(m["loss"]))
                r["grad_norm"].append(float(m["grad_norm"]))
                r["counts"].append(_train_counts())
                r["m"].append(train_samples(
                    lambda p: state.m[_port_leaf(p)].float().cpu().numpy()))
            r["params"] = {n: p.detach().clone() for n, p in params.items()}
            refs[tag] = r
            del model, params, state
        # (c) the ranks' checkpoint into one process, each rank's chunk printed
        saved = FSDP_DIR / "ckpt2" / f"step-{FSDP['steps'] - 1:09d}" / "manifest.json"
        deadline = time.monotonic() + FSDP["wait_s"]
        while not saved.exists():
            _check(time.monotonic() < deadline, f"24c: no {saved} after {FSDP['wait_s']} s")
            time.sleep(0.2)
        t0 = time.perf_counter()
        model = _fsdp_model(cfg, start, dev)
        params = dict(model.named_parameters())
        opt, _ = _fsdp_step(cfg)
        one["step"], (got, state) = Checkpointer(str(FSDP_DIR / "ckpt2")).restore(
            None, (params, adamw_init(params, opt)))
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(got[n])
        del got
        whole = _train_state(params, state)
        one["chunks"] = [_bit_prints({k: fsdp.local_shard(t, dims[k.split("/", 1)[1]], 2, r)
                                      for k, t in whole.items()}) for r in range(2)]
        one["s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ranks = _run_world(2, "gloo", "b", target=_fsdp_rank, join_s=FSDP["join_s"], during=during)
    out["b_world_s"] = time.perf_counter() - t0
    for tag, r in refs.items():
        whole = {n: (ranks[0][f"{tag}/param/{n}"] if dims[n] is None else torch.cat(
                 [o[f"{tag}/param/{n}"] for o in ranks], dims[n])).to(dev) for n in r["params"]}
        sampled = train_samples(lambda p: whole[_port_leaf(p)].float().cpu().numpy())
        loose = {n: _bf16_loose_bad(whole[n], w, TRAIN["lr"], FSDP["steps"])
                 for n, w in r["params"].items()}
        repl = [n for n in r["params"] if dims[n] is None]
        same = [n for n in repl for k in ("param", "m", "v")
                if not torch.equal(ranks[0][f"{tag}/{k}/{n}"], ranks[1][f"{tag}/{k}/{n}"])]
        for rk, o in enumerate(ranks):
            got = train_summary(o[f"{tag}/loss"], o[f"{tag}/grad_norm"], sampled,
                                [_merge_samples([q[f"{tag}/m"][i] for q in ranks])
                                 for i in range(FSDP["steps"])])
            want = train_summary(r["loss"], r["grad_norm"], train_samples(
                lambda p: r["params"][_port_leaf(p)].float().cpu().numpy()), r["m"])
            diff = compare_train(got, want, TRAIN["lr"])
            sp = o[f"{tag}/spans"]
            coll = sp.get("fsdp.gather", 0.0) + sp.get("fsdp.reduce", 0.0)
            print(f"24b FSDP {tag[2:]}, rank {rk} of 2 (gloo, ranks sharing one card: not a "
                  f"scaling figure): {FSDP['layers']} layers, {TRAIN['batch']} x "
                  f"{TRAIN['seq_len']} global: walls {_walls(o[f'{tag}/walls'])} s (the first "
                  f"cold; collectives timed: {coll:.3f} s of {sum(o[f'{tag}/walls']):.3f}), losses "
                  f"{o[f'{tag}/loss']} vs one process {r['loss']}, grad norms "
                  f"{o[f'{tag}/grad_norm']} vs {r['grad_norm']}; largest differences "
                  f"{json.dumps(train_max_diff(got, want, TRAIN['lr']))}; elements past the loose "
                  f"bound {sum(loose.values())}; replicated leaves equal across ranks: {not same} "
                  f"({len(repl)} leaves); launches a step {o[f'{tag}/counts'][-1]} (one process's "
                  f"{r['counts'][-1]})")
            _check(not diff and not any(loose.values()) and not same
                   and o[f"{tag}/counts"] == r["counts"],
                   f"24b {tag} rank {rk}: {diff[:4]}, past the loose bound "
                   f"{ {n: v for n, v in loose.items() if v} }, replicated differ {same[:4]}, "
                   f"launches {o[f'{tag}/counts']} vs {r['counts']}")
        out[f"{tag}_walls"] = [o[f"{tag}/walls"] for o in ranks]
    del refs, whole

    # (c)
    bad_1 = [(r, k) for r in range(2) for k, v in one["chunks"][r].items()
             if ranks[r]["c/saved"][k] != v]
    bad_2 = [(r, k) for r in range(2) for k, v in ranks[r]["c/saved"].items()
             if ranks[r]["c/restored"][k] != v]
    bad_3 = [(r, k) for r in range(2) for k, v in ranks[r]["c/live"].items()
             if ranks[r]["c/again"][k] != v]
    same_metrics = all(ranks[r][f"c/again/{k}"] == ranks[r][f"c/live/{k}"]
                       for r in range(2) for k in ("loss", "grad_norm"))
    out["c_one_s"] = one["s"]
    print(f"24c checkpoint of the 2-rank world (step {one['step']}; saved in "
          f"{_walls([o['c/save_s'] for o in ranks])} s): into one process "
          f"{'bit for bit (' + str(len(one['chunks'][0])) + ' tensors, each rank chunk)' if not bad_1 else 'DIFFERS ' + str(bad_1[:4])}"
          f" ({one['s']:.2f} s), and back into the two ranks "
          f"({_walls([o['c/restore_s'] for o in ranks])} s) "
          f"{'bit for bit' if not bad_2 else 'DIFFERS ' + str(bad_2[:4])}; the next step from "
          f"it vs the step without the restore: "
          f"{'bit for bit' if not bad_3 and same_metrics else 'DIFFERS ' + str(bad_3[:4])} "
          f"(losses {[o['c/again/loss'] for o in ranks]})")
    _check(not bad_1 and not bad_2 and not bad_3 and same_metrics,
           f"24c checkpoint round trip: {bad_1[:4]} {bad_2[:4]} {bad_3[:4]} {same_metrics}")
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    out["launches"] = {}  # every step of every rank of both worlds
    for o in [a] + ranks:
        for key, steps in o.items():
            if key.endswith("/counts"):
                for c in steps:
                    for name, n in c.items():
                        out["launches"][name] = out["launches"].get(name, 0) + n
    out["launches_per_step"] = dict(
        one_rank=a["a/counts"][-1],
        two_ranks={tag: ranks[0][f"{tag}/counts"][-1] for tag in
                   (f"b/mb{mb}{'once' if once else ''}" for mb, once in FSDP["configs"])})
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 24 (FSDP training): {out['phase_s']:.1f} s (one-rank world "
          f"{out['a_world_s']:.1f} s, two-rank world {out['b_world_s']:.1f} s with (c))")
    return out


# Phase 25: tensor parallelism on the rules' "model" axis (``sharding.tp``):
# (a) serving at full llama3.2-1b width and depth on (1, 2), ``decode``
# teacher-forced steps after phase 6's 4 x 512 prefill prompts; (b)
# training at full width, FSDP["layers"] layers, ``steps12`` steps on (1, 2)
# and ``steps22`` on (2, 2); (c) chatglm3-6b at full width, ``glm_layers``
# layers, a ``glm_batch`` prefill and one training step on (1, 4).  The
# ranks read their weights and references from ``TP_DIR``, removed at the
# end; ``join_s`` bounds each world.
TP = dict(decode=32, steps12=2, steps22=1, glm_arch="chatglm3_6b", glm_layers=2,
          glm_batch=(2, 512), glm_seed=0, join_s=360.0)
TP_DIR = ROOT / "build" / "phase25"
# The sampled leaves of (c): the projections (wk and wv gathered over
# "model"), their biases (summed over "model"), the norms and the untied
# head.  Not the embedding: its untied gradient is the lookup's alone, a
# 2 x 512 batch reaches 1 of 64 of its rows, and the comparison's scale (the
# largest sampled |m|) would fall on one element's.
TP_GLM_LEAVES = ("blocks.attn.wq.kernel", "blocks.attn.wk.kernel", "blocks.attn.wv.kernel",
                 "blocks.ln1.scale", "ln_f.scale", "lm_head.kernel", "blocks.attn.wq.bias",
                 "blocks.attn.wk.bias", "blocks.attn.wv.bias")


def tp_serve_reference(model, cfg, dev) -> dict:
    """Phase 25a's reference, run by phase 6 on its unsharded model: a
    ``SERVE["prefill"]`` prefill into caches of ``TP["decode"]`` more
    positions, then that many teacher-forced decode steps; the prompts, the
    fed tokens and every logit on the host in bf16 (the tied readout's
    logits are bf16 products: exact)."""
    import torch

    from repro_torch.serve import build_decode_step, build_prefill_step

    b, tl = SERVE["prefill"]
    n = TP["decode"]
    toks = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl + n, SERVE["prompt_seed"] + 2),
                           device=dev)
    prompts, fed = toks[:, :tl], toks[:, tl:]
    lossless = lambda t: bool(torch.equal(t.to(torch.bfloat16).float(), t))
    logits, state = build_prefill_step(cfg)(model, prompts, tl + n)
    exact = lossless(logits) and bool(torch.isfinite(logits).all())
    out = {"prompts": prompts.cpu(), "fed": fed.cpu(), "prefill": logits.to(torch.bfloat16).cpu()}
    decode, steps = build_decode_step(cfg), []
    for i in range(n):
        step_logits, state = decode(model, fed[:, i:i + 1], state, tl + i)
        exact &= lossless(step_logits) and bool(torch.isfinite(step_logits).all())
        steps.append(step_logits.to(torch.bfloat16).cpu())
    out["steps"] = torch.cat(steps, dim=1)
    _check(exact, "25a reference logits: finite, and exact in bf16")
    return out


def _tp_kernel_parity(dev, b, h, hkv, t, hd, d, backward: bool, eps: float,
                      causal: bool = True, flash: bool = True) -> dict:
    """This rank's kernels against their plain versions at the local shapes
    of its main path, with phases 5 and 7's tolerances: with ``flash`` the
    flash forward (``causal`` or not) on q ``(b, h, t, hd)``, k and v ``(b,
    hkv, t, hd)`` in bf16 (2e-2 against the bf16 plain version, one bf16 ulp
    of the element on o and 1e-5 on lse against the float32 one), with
    ``backward`` its dK/dV and dQ against the plain backward (one ulp of the
    element plus 1e-5 of the gradient's scale), rmsnorm on ``(b t, d)``
    bf16 rows (one ulp; not with ``d`` None).  The largest errors by
    kernel; a disagreement fails the run."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(25)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    errs = {}
    if flash:
        errs.update(_tp_flash_parity(dev, randn, b, h, hkv, t, hd, backward, causal))
    if d is not None:
        x, w = randn(b * t, d), (1.0 + 0.1 * randn(d).float()).to(torch.bfloat16)
        got = ops.rmsnorm(x, w, eps, force="cuda").double()
        want = ops.rmsnorm(x, w, eps, force="ref").double()
        errs["rmsnorm"] = float((got - want).abs().max())
        _check(bool(((got - want).abs() <= 2.0**-7 * want.abs() + 1e-6).all()),
               f"25: rmsnorm ({b * t}, {d}) vs plain")
    torch.cuda.synchronize()
    return errs


def _tp_flash_parity(dev, randn, b, h, hkv, t, hd, backward: bool, causal: bool) -> dict:
    """``_tp_kernel_parity``'s flash part."""
    from repro_torch.kernels import flash_attention as fa, ref

    q, k, v = randn(b, h, t, hd), randn(b, hkv, t, hd), randn(b, hkv, t, hd)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o_p, lse_p = ref.attention(q, k, v, causal=causal, with_lse=True)
    o_w, lse_w = ref.attention(q.float(), k.float(), v.float(), causal=causal, with_lse=True)
    dev_o = (o.double() - o_w.double()).abs()
    errs = {"flash_attention_fwd": max(_max_err(o, o_p), _max_err(lse, lse_p))}
    _check(errs["flash_attention_fwd"] <= 2e-2 and _max_err(lse, lse_w) <= 1e-5
           and bool((dev_o <= 2.0**-7 * o_w.double().abs() + 1e-6).all()),
           f"25: flash forward at q {tuple(q.shape)} k {tuple(k.shape)} causal {causal} vs plain")
    if backward:
        do = randn(b, h, t, hd)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        plain = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        err, ok = 0.0, True
        for g, p in zip(got, plain):
            g64, p64 = g.double(), p.double()
            ok &= bool(((g64 - p64).abs() <= 2.0**-7 * p64.abs()
                        + 1e-5 * float(p64.abs().max())).all())
            err = max(err, _max_err(g, p))
        _check(ok, f"25: flash backward at q {tuple(q.shape)} k {tuple(k.shape)} vs plain")
        errs["flash_attention_bwd_dkv"] = errs["flash_attention_bwd_dq"] = err
    return errs


def _tp_coll_s(spans: dict) -> float:
    """Seconds of ``core.profiling``'s collective spans (``tp.*`` and
    ``fsdp.*``)."""
    return sum(v for k, v in spans.items() if k.startswith(("tp.", "fsdp.")))


def _tp_serve_job(dev, mesh, out: dict) -> None:
    """25a on this rank: the full-depth model placed on ``mesh``, the
    kernels held at the local shapes, then the prefill and the decode
    steps against the reference, each counted and timed."""
    import torch

    from repro_torch.configs import full_config
    from repro_torch.core import profiling
    from repro_torch.serve import build_decode_step, build_prefill_step
    from repro_torch.sharding import fsdp, tp as TPM

    cfg = full_config(SERVE["arch"])
    model = fsdp.shard_model(_fsdp_model(cfg, torch.load(TP_DIR / "start.pt", mmap=True), dev),
                             mesh)
    torch.cuda.empty_cache()
    ref = torch.load(TP_DIR / "serve_ref.pt", mmap=True)
    prompts, fed = ref["prompts"].to(dev), ref["fed"].to(dev)
    (b, tl), n, m = prompts.shape, fed.shape[1], model.tp.size
    kv = TPM.kv_heads(cfg, model.tp)[1]
    out["a/parity"] = _tp_kernel_parity(dev, b, cfg.n_heads // m, kv, tl,
                                        cfg.resolved_head_dim, cfg.d_model, False, cfg.norm_eps)
    prefill, decode = build_prefill_step(cfg, mesh), build_decode_step(cfg, mesh)
    prefill(model, prompts[:, :64], 65)  # warm-up (the collectives' first calls)
    torch.cuda.synchronize()
    _reset_train_counts()
    t0 = time.perf_counter()
    logits, state = prefill(model, prompts, tl + n)
    torch.cuda.synchronize()
    out["a/prefill_s"], out["a/prefill_counts"] = time.perf_counter() - t0, _train_counts()
    want = ref["prefill"].to(dev).float()
    out["a/prefill_err"] = _max_err(logits, want)
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > SERVE_MARGIN_TOL
    agree = logits.argmax(-1) == want.argmax(-1)
    out["a/prefill_sure"], out["a/prefill_agree"] = int(sure.sum()), int((agree & sure).sum())
    out["a/prefill_print"] = _bit_prints({"prefill": logits})["prefill"]
    out["a/cache_shape"] = list(state["blocks"].k.shape)
    del logits, want, top2
    _reset_train_counts()
    profiling.enable()
    errs, walls, steps = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        step_logits, state = decode(model, fed[:, i:i + 1], state, tl + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        w = ref["steps"][:, i:i + 1].to(dev).float()
        errs.append(_max_err(step_logits, w))
        steps.append(step_logits)
    out["a/decode_spans"] = profiling.phases()
    profiling.disable()
    out["a/decode_counts"], out["a/decode_walls"], out["a/decode_err"] = \
        _train_counts(), walls, max(errs)
    got = torch.cat(steps, dim=1)
    want = ref["steps"].to(dev).float()
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > SERVE_MARGIN_TOL
    out["a/decode_sure"] = int(sure.sum())
    out["a/decode_agree"] = int(((got.argmax(-1) == want.argmax(-1)) & sure).sum())
    out["a/decode_print"] = _bit_prints({"steps": got})["steps"]
    # one more prefill with the collectives timed (synchronized)
    profiling.enable()
    t0 = time.perf_counter()
    prefill(model, prompts, tl + n)
    torch.cuda.synchronize()
    out["a/prefill_profiled_s"], out["a/prefill_spans"] = time.perf_counter() - t0, \
        profiling.phases()
    profiling.disable()
    del model, state, got, want
    torch.cuda.empty_cache()


def _tp_train_job(dev, mesh, steps: int, tag: str, out: dict) -> None:
    """25b on this rank: the 4-layer model placed on ``mesh``, its kernels
    held at the local shapes, then ``steps`` steps; the rank's shards, its
    sampled moments and its walls, counts and spans."""
    import torch

    from repro_torch.core import profiling
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import fsdp, rules, tp as TPM

    cfg = _fsdp_cfg(FSDP["layers"])
    model = fsdp.shard_model(_fsdp_model(cfg, torch.load(TP_DIR / "start4.pt", mmap=True), dev),
                             mesh)
    params = dict(model.named_parameters())
    n, m = rules.axis_sizes(mesh)["data"], model.tp.size
    out[f"{tag}/parity"] = _tp_kernel_parity(
        dev, TRAIN["batch"] // n, cfg.n_heads // m, TPM.kv_heads(cfg, model.tp)[1],
        TRAIN["seq_len"], cfg.resolved_head_dim, cfg.d_model, True, cfg.norm_eps)
    out[f"{tag}/coords"] = (rules.axis_index(mesh, "data"), rules.axis_index(mesh, "model"))
    opt, step = _fsdp_step(cfg)
    state = adamw_init(params, opt)
    ds = _fsdp_data(cfg)
    walls, losses, norms, counts, moments, spans = [], [], [], [], [], []
    for i in range(steps):
        batch = ds.batch_at(i)
        torch.cuda.synchronize()
        _reset_train_counts()
        profiling.enable()
        t0 = time.perf_counter()
        _, state, metrics = step(model, state, batch, i)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(profiling.phases())
        profiling.disable()
        counts.append(_train_counts())
        moments.append(_fsdp_samples(params, lambda n_: state.m[n_]))
    out.update({f"{tag}/walls": walls, f"{tag}/loss": losses, f"{tag}/grad_norm": norms,
                f"{tag}/counts": counts, f"{tag}/m": moments, f"{tag}/spans": spans})
    for name, p in params.items():
        info = fsdp.shard_of(p)
        out[f"{tag}/param/{name}"] = p.detach().to("cpu", copy=True)
        out[f"{tag}/dims/{name}"] = (info.dim, info.model_dim)
    del model, params, state
    torch.cuda.empty_cache()


def _tp_glm_cfg():
    import dataclasses

    from repro_torch.configs import full_config

    return dataclasses.replace(full_config(TP["glm_arch"]), n_layers=TP["glm_layers"])


def _tp_glm_model(dev):
    """(c)'s model, drawn on the card from ``TP["glm_seed"]`` (the same
    weights in every process)."""
    import torch

    from repro_torch.models import transformer as T

    return T.init(_tp_glm_cfg(), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(TP["glm_seed"]))


def _tp_glm_batch(cfg):
    """(c)'s prompts and training batch (host tensors)."""
    import torch

    b, t = TP["glm_batch"]
    toks = torch.as_tensor(serve_prompts(cfg.vocab_size, b, t + 1, TP["glm_seed"] + 1))
    return toks[:, :t], {"tokens": toks[:, :t], "labels": toks[:, 1:].clone()}


def _tp_glm_job(dev, mesh, out: dict) -> None:
    """25c on this rank: chatglm3's model placed on ``mesh`` (1, 4), its
    kernels held at the local shapes, the prefill against the reference
    and one training step."""
    import torch

    from repro_torch.optim import adamw_init
    from repro_torch.serve import build_prefill_step
    from repro_torch.sharding import fsdp, tp as TPM

    cfg = _tp_glm_cfg()
    model = fsdp.shard_model(_tp_glm_model(dev), mesh)
    prompts, batch = _tp_glm_batch(cfg)
    b, t = prompts.shape
    kv = TPM.kv_heads(cfg, model.tp)
    out["c/kv_heads"] = kv
    out["c/parity"] = _tp_kernel_parity(dev, b, cfg.n_heads // model.tp.size, kv[1], t,
                                        cfg.resolved_head_dim, cfg.d_model, True, cfg.norm_eps)
    _reset_train_counts()
    t0 = time.perf_counter()
    logits, _ = build_prefill_step(cfg, mesh)(model, prompts.to(dev), t)
    torch.cuda.synchronize()
    out["c/prefill_s"], out["c/prefill_counts"] = time.perf_counter() - t0, _train_counts()
    want = torch.load(TP_DIR / "glm_ref.pt", mmap=True).to(dev).float()
    out["c/prefill_err"] = _max_err(logits, want)
    del logits, want
    params = dict(model.named_parameters())
    opt, step = _fsdp_step(cfg)
    state = adamw_init(params, opt)
    _reset_train_counts()
    t0 = time.perf_counter()
    _, state, metrics = step(model, state, batch, 0)
    torch.cuda.synchronize()
    out.update({"c/step_s": time.perf_counter() - t0, "c/step_counts": _train_counts(),
                "c/loss": [float(metrics["loss"])], "c/grad_norm": [float(metrics["grad_norm"])],
                "c/m": [_fsdp_samples(params, lambda n_: state.m[n_], TP_GLM_LEAVES)],
                "c/params": _fsdp_samples(params, lambda n_: params[n_], TP_GLM_LEAVES),
                "c/biases": {n: p.detach().float().cpu() for n, p in params.items()
                             if n.endswith("bias")}})
    del model, params, state
    torch.cuda.empty_cache()


def _tp_rank(rank: int, world: int, store: str, backend: str, job: str, out_dir: str):
    """One rank of a phase-25 world: ``job`` "a" (two ranks: 25a, then 25b
    on (1, 2)) or "b" (four ranks: 25b on (2, 2), then 25c on (1, 4));
    writes its results to ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_world, make_host_mesh

    t0 = time.perf_counter()
    init_world(rank, world, f"file://{store}", device_type="cuda", backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm"])
    dist.barrier()
    out: dict = {"backend": backend, "join_s": time.perf_counter() - t0}
    if job == "a":
        mesh = make_host_mesh(2, device_type="cuda")
        out["mesh"] = tuple(mesh.shape)
        _tp_serve_job(dev, mesh, out)
        _tp_train_job(dev, mesh, TP["steps12"], "b12", out)
    else:
        mesh = make_host_mesh(2, device_type="cuda")
        out["mesh"] = tuple(mesh.shape)
        _tp_train_job(dev, mesh, TP["steps22"], "b22", out)
        glm_mesh = make_host_mesh(4, device_type="cuda")
        out["glm_mesh"] = tuple(glm_mesh.shape)
        _tp_glm_job(dev, glm_mesh, out)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _tp_reassemble(ranks: list, tag: str, name: str, model_size: int):
    """The whole leaf ``name`` from the ranks' shards of run ``tag``: each
    data coordinate's model chunks concatenated along the model dim, then
    the data chunks along the data dim."""
    import torch

    dim, mdim = ranks[0][f"{tag}/dims/{name}"]
    by = {o[f"{tag}/coords"]: o[f"{tag}/param/{name}"] for o in ranks}
    n_data = len(ranks) // model_size
    rows = []
    for d in range(n_data):
        parts = [by[(d, m)] for m in range(model_size)]
        rows.append(parts[0] if mdim is None else torch.cat(parts, mdim))
    return rows[0] if dim is None else torch.cat(rows, dim)


def _tp_train_check(label: str, ranks: list, tag: str, ref: dict, steps: int, model_size: int,
                    dev) -> dict:
    """Every rank of a 25b run against one process's (``ref``: losses, grad
    norms, sampled moments, the parameters after ``steps`` steps): losses,
    norms, the sampled moments and parameters within ``TRAIN_TOL``, every
    element of the reassembled parameters within the loose bound, the
    ranks' replicated leaves the same bits, the launches one process's."""
    import torch

    params = ref["params"][steps - 1]
    whole = {n: _tp_reassemble(ranks, tag, n, model_size).to(dev) for n in params}
    sampled = train_samples(lambda p: whole[_port_leaf(p)].float().cpu().numpy())
    loose = {n: _bf16_loose_bad(whole[n], w.to(dev), TRAIN["lr"], steps) for n, w in params.items()}
    repl = [n for n in params if ranks[0][f"{tag}/dims/{n}"] == (None, None)]
    first = ranks[0]
    same = [n for n in repl if any(not torch.equal(o[f"{tag}/param/{n}"], first[f"{tag}/param/{n}"])
                                   for o in ranks[1:])]
    want = train_summary(ref["loss"][:steps], ref["grad_norm"][:steps], ref["samples"][steps - 1],
                         ref["m"][:steps])
    worst = {}
    for rk, o in enumerate(ranks):
        got = train_summary(o[f"{tag}/loss"], o[f"{tag}/grad_norm"], sampled,
                            [_merge_samples([q[f"{tag}/m"][i] for q in ranks])
                             for i in range(steps)])
        diff = compare_train(got, want, TRAIN["lr"])
        worst = train_max_diff(got, want, TRAIN["lr"])
        sp = o[f"{tag}/spans"][-1]
        print(f"25b TP {label}, rank {rk} of {len(ranks)} (gloo, ranks sharing one card: not a "
              f"scaling figure): {FSDP['layers']} layers, {TRAIN['batch']} x {TRAIN['seq_len']} "
              f"global: walls {_walls(o[f'{tag}/walls'])} s (the first cold; last step's "
              f"collectives {_tp_coll_s(sp):.3f} s: "
              f"{ {k: round(v, 4) for k, v in sorted(sp.items())} }), losses {o[f'{tag}/loss']} vs "
              f"one process {ref['loss'][:steps]}, grad norms {o[f'{tag}/grad_norm']} vs "
              f"{ref['grad_norm'][:steps]}; largest differences {json.dumps(worst)}; elements "
              f"past the loose bound {sum(loose.values())}; replicated leaves equal across ranks: "
              f"{not same} ({len(repl)} leaves); launches a step {o[f'{tag}/counts'][-1]} (one "
              f"process's {ref['counts'][-1]}); kernels at the local shapes vs plain "
              f"{o[f'{tag}/parity']}")
        _check(not diff and not any(loose.values()) and not same
               and o[f"{tag}/counts"] == ref["counts"][:steps],
               f"25b {label} rank {rk}: {diff[:4]}, past the loose bound "
               f"{ {n: v for n, v in loose.items() if v} }, replicated differ {same[:4]}, "
               f"launches {o[f'{tag}/counts']} vs {ref['counts'][:steps]}")
    return worst


def phase_tp(dev, start_8a: dict, serve_ref: dict) -> dict:
    """Phase 25 (``TP``): (a) and (b) on (1, 2) over two gloo ranks, (b) on
    (2, 2) and (c) on (1, 4) over four; ``start_8a`` phase 8a's start
    weights (host tensors by name), ``serve_ref`` phase 6's
    ``tp_serve_reference``."""
    import shutil

    import torch

    from repro_torch.configs import full_config
    from repro_torch.optim import adamw_init
    from repro_torch.serve import build_prefill_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    TP_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(start_8a, TP_DIR / "start.pt")
    cfg = _fsdp_cfg(FSDP["layers"])
    start = {n: t for n, t in start_8a.items()
             if not n.startswith("blocks.") or int(n.split(".")[1]) < FSDP["layers"]}
    torch.save(start, TP_DIR / "start4.pt")
    torch.save(serve_ref, TP_DIR / "serve_ref.pt")
    ref = {"loss": [], "grad_norm": [], "counts": [], "m": [], "samples": [], "params": []}

    def during_a():
        # (b)'s one-process run: TP["steps12"] steps, the state after each
        model = _fsdp_model(cfg, start, dev)
        params = dict(model.named_parameters())
        opt, step = _fsdp_step(cfg)
        state = adamw_init(params, opt)
        ds = _fsdp_data(cfg)
        for i in range(max(TP["steps12"], TP["steps22"])):
            _reset_train_counts()
            _, state, m = step(model, state, ds.batch_at(i), i)
            ref["loss"].append(float(m["loss"]))
            ref["grad_norm"].append(float(m["grad_norm"]))
            ref["counts"].append(_train_counts())
            ref["m"].append(train_samples(lambda p: state.m[_port_leaf(p)].float().cpu().numpy()))
            ref["samples"].append(train_samples(
                lambda p: params[_port_leaf(p)].detach().float().cpu().numpy()))
            ref["params"].append({n: p.detach().to("cpu", copy=True) for n, p in params.items()})

    t0 = time.perf_counter()
    two = _run_world(2, "gloo", "a", target=_tp_rank, join_s=TP["join_s"], during=during_a)
    out["world2_s"] = time.perf_counter() - t0

    # (a)
    L, (b, tl), n = full_config(SERVE["arch"]).n_layers, SERVE["prefill"], TP["decode"]
    want_prefill = {"rmsnorm": 2 * L + 1, "flash_attention_fwd": L, "flash_attention_bwd_dkv": 0,
                    "flash_attention_bwd_dq": 0}
    want_decode = dict(want_prefill, rmsnorm=(2 * L + 1) * n, flash_attention_fwd=0)
    for rk, o in enumerate(two):
        sp = o["a/prefill_spans"]
        dsp = o["a/decode_spans"]
        print(f"25a TP serve, rank {rk} of 2 on {o['mesh']} (gloo, ranks sharing one card: not a "
              f"scaling figure): llama3.2-1b full width and depth, prefill {b} x {tl} "
              f"{o['a/prefill_s']:.4f} s (a synchronized run {o['a/prefill_profiled_s']:.4f} s, "
              f"its "
              f"collectives {_tp_coll_s(sp):.4f} s: "
              f"{ {k: round(v, 4) for k, v in sorted(sp.items())} }), {n} decode steps "
              f"{sum(o['a/decode_walls']):.4f} s (collectives {_tp_coll_s(dsp):.4f} s); logits "
              f"max|TP - one process| prefill {o['a/prefill_err']:.4f}, decode "
              f"{o['a/decode_err']:.4f} (tolerance {SERVE_PREFILL_TOL}); argmax equal at "
              f"{o['a/prefill_agree']}/{o['a/prefill_sure']} prefill and "
              f"{o['a/decode_agree']}/{o['a/decode_sure']} decode positions with a top-2 margin > "
              f"{SERVE_MARGIN_TOL}; cache {o['a/cache_shape']}; launches prefill "
              f"{o['a/prefill_counts']}, decode {o['a/decode_counts']}; kernels at the local "
              f"shapes vs plain {o['a/parity']}")
        _check(o["a/prefill_err"] <= SERVE_PREFILL_TOL and o["a/decode_err"] <= SERVE_PREFILL_TOL
               and o["a/prefill_agree"] == o["a/prefill_sure"] > 0
               and o["a/decode_agree"] == o["a/decode_sure"] > 0,
               f"25a rank {rk}: TP serving differs from one process")
        _check(o["a/prefill_counts"] == want_prefill and o["a/decode_counts"] == want_decode,
               f"25a rank {rk} launches {o['a/prefill_counts']} {o['a/decode_counts']}")
        _check(o["a/prefill_print"] == two[0]["a/prefill_print"]
               and o["a/decode_print"] == two[0]["a/decode_print"],
               f"25a rank {rk}: the ranks' logits differ")
    out["a"] = {k: two[0][f"a/{k}"] for k in ("prefill_s", "prefill_profiled_s", "prefill_err",
                                             "decode_err", "decode_walls")}
    out["a"]["prefill_coll_s"] = _tp_coll_s(two[0]["a/prefill_spans"])
    out["a"]["decode_coll_s"] = _tp_coll_s(two[0]["a/decode_spans"])
    # (b) on (1, 2)
    out["b12"] = _tp_train_check("(1, 2)", two, "b12", ref, TP["steps12"], 2, dev)
    out["b12_walls"] = [o["b12/walls"] for o in two]
    out["b12_coll_s"] = [_tp_coll_s(o["b12/spans"][-1]) for o in two]
    launches = [o["a/prefill_counts"] for o in two] + [o["a/decode_counts"] for o in two] + [
        c for o in two for c in o["b12/counts"]]
    del two

    # (c)'s one-process prefill, which the ranks read, then its step beside them
    glm_cfg = _tp_glm_cfg()
    glm = _tp_glm_model(dev)
    prompts, batch = _tp_glm_batch(glm_cfg)
    logits, _ = build_prefill_step(glm_cfg)(glm, prompts.to(dev), prompts.shape[1])
    torch.save(logits.to(torch.bfloat16).cpu(), TP_DIR / "glm_ref.pt")
    del logits
    glm_ref = {}

    def during_b():
        params = dict(glm.named_parameters())
        opt, step = _fsdp_step(glm_cfg)
        state = adamw_init(params, opt)
        _reset_train_counts()
        _, state, m = step(glm, state, batch, 0)
        glm_ref.update(loss=[float(m["loss"])], grad_norm=[float(m["grad_norm"])],
                       counts=_train_counts(),
                       m=[train_samples(lambda p: state.m[_port_leaf(p)].float().cpu().numpy(),
                                        TP_GLM_LEAVES)],
                       params=train_samples(
                           lambda p: params[_port_leaf(p)].detach().float().cpu().numpy(),
                           TP_GLM_LEAVES),
                       biases={n: p.detach().float().cpu() for n, p in params.items()
                               if n.endswith("bias")})

    t0 = time.perf_counter()
    four = _run_world(4, "gloo", "b", target=_tp_rank, join_s=TP["join_s"], during=during_b)
    out["world4_s"] = time.perf_counter() - t0
    del glm
    out["b22"] = _tp_train_check("(2, 2)", four, "b22", ref, TP["steps22"], 2, dev)
    out["b22_walls"] = [o["b22/walls"] for o in four]
    out["b22_coll_s"] = [_tp_coll_s(o["b22/spans"][-1]) for o in four]
    del ref

    # (c)
    gl = glm_cfg.n_layers
    want_c = {"rmsnorm": 2 * gl + 1, "flash_attention_fwd": gl, "flash_attention_bwd_dkv": 0,
              "flash_attention_bwd_dq": 0}
    want = train_summary(glm_ref["loss"], glm_ref["grad_norm"], glm_ref["params"], glm_ref["m"])
    for rk, o in enumerate(four):
        got = train_summary(o["c/loss"], o["c/grad_norm"],
                            _merge_samples([q["c/params"] for q in four]),
                            [_merge_samples([q["c/m"][0] for q in four])])
        diff = compare_train(got, want, TRAIN["lr"], leaves=TP_GLM_LEAVES)
        bias_bad = {n: _bf16_loose_bad(o["c/biases"][n], w, TRAIN["lr"], 1)
                    for n, w in glm_ref["biases"].items()}
        worst = train_max_diff(got, want, TRAIN["lr"], leaves=TP_GLM_LEAVES)
        print(f"25c TP chatglm3-6b, rank {rk} of 4 on {o['glm_mesh']} (KV heads "
              f"{o['c/kv_heads']} of {glm_cfg.n_kv_heads}: gathered over 'model'): {gl} layers, "
              f"prefill {TP['glm_batch']} {o['c/prefill_s']:.4f} s, max|TP - one process| "
              f"{o['c/prefill_err']:.4f}; one step {o['c/step_s']:.4f} s, loss {o['c/loss']} vs "
              f"{glm_ref['loss']}, grad norm {o['c/grad_norm']} vs {glm_ref['grad_norm']}, largest "
              f"differences {json.dumps(worst)}"
              f", q/k/v bias elements past the loose bound {sum(bias_bad.values())}; launches "
              f"prefill {o['c/prefill_counts']}, step {o['c/step_counts']} (one process's "
              f"{glm_ref['counts']}); kernels at the local shapes vs plain {o['c/parity']}")
        _check(o["c/prefill_err"] <= SERVE_PREFILL_TOL and not diff and not any(bias_bad.values())
               and o["c/prefill_counts"] == want_c and o["c/step_counts"] == glm_ref["counts"],
               f"25c rank {rk}: {o['c/prefill_err']} {diff[:4]} {bias_bad}")
    launches += [o["b22/counts"][i] for o in four for i in range(TP["steps22"])]
    launches += [o[k] for o in four for k in ("c/prefill_counts", "c/step_counts")]
    out["c"] = {k: four[0][f"c/{k}"] for k in ("prefill_s", "prefill_err", "step_s")}
    del four
    shutil.rmtree(TP_DIR, ignore_errors=True)
    out["launches"] = {}  # every main-path run of every rank of both worlds
    for c in launches:
        for name, k in c.items():
            out["launches"][name] = out["launches"].get(name, 0) + k
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 25 (tensor parallelism): {out['phase_s']:.1f} s (two-rank world "
          f"{out['world2_s']:.1f} s, four-rank world {out['world4_s']:.1f} s)")
    return out


# Phase 26: tensor parallelism on the rules' "model" axis for the ssm,
# hybrid and audio families (``sharding.tp``), on (1, 2) over two gloo
# ranks that share the card: not a scaling figure.  Each rank first runs
# one process's model on the same weights (drawn on the card from the
# family's seed), then places that model on the mesh and runs the same
# work, held to the one-process run.  (a) rwkv6-7b at full width cut to
# ``rwkv_layers`` layers: RWKV["prefill"]'s 4 x 512 prefill and ``decode``
# teacher-forced steps, and each block alone on the one-process forward's
# input to it (RWKV_BLOCK_ULPS); (b) zamba2-2.7b at full width cut to
# ``hybrid_groups`` groups, the same (HYBRID_BLOCK_ULPS, the Mamba2 blocks
# and the shared block's visits); (c) whisper-large-v3 whole:
# WHISPER["prefill"]'s 4 x 64 prefill with 1500 frames a request and
# ``whisper_decode`` steps, every encoder and decoder block alone
# (WHISPER_BLOCK_ULPS); (d) ``steps`` training steps of each at full width
# cut in depth (rwkv6 ``train_rwkv_layers`` layers, zamba2
# ``train_hybrid_groups`` groups, whisper ``train_whisper_layers`` encoder
# and as many decoder layers) on TRAIN's 4 x 512 tokens (whisper with
# 4 x 1500 frames), within TRAIN_TOL on the family's sampled leaves and
# every element within its loose bound: rwkv6 and whisper in bf16, zamba2
# in float32, because in bf16 one process's own step lies farther from
# its float32 step than TRAIN_TOL allows the ranks to lie from it (on an
# H100, 1 group: grad norms 84.19 bf16 against 81.71 float32 at the first
# step, 81.08 against 94.89 at the second; ``tools/tp_train_control.py``),
# and a bf16 comparison of two orders of its sums is then a comparison of
# rounding noise.  Each rank also holds its kernels at its local shapes to
# their plain versions.
# ``join_s`` bounds the world.
TPF = dict(rwkv_layers=4, hybrid_groups=1, decode=32, whisper_decode=16, train_rwkv_layers=2,
           train_hybrid_groups=1, train_whisper_layers=4, steps=2, join_s=600.0)
TPF_FAMILIES = {"rwkv": RWKV, "hybrid": HYBRID, "whisper": WHISPER}


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _tpf_cfg(fam: str, train: bool = False):
    """Phase 26's config of ``fam``: full width, its depth cut as TPF says
    (whisper serves whole; zamba2 trains in float32)."""
    import dataclasses

    from repro_torch.configs import full_config

    cfg = full_config(TPF_FAMILIES[fam]["arch"])
    if fam == "rwkv":
        return dataclasses.replace(
            cfg, n_layers=TPF["train_rwkv_layers"] if train else TPF["rwkv_layers"])
    if fam == "hybrid":
        groups = TPF["train_hybrid_groups"] if train else TPF["hybrid_groups"]
        return dataclasses.replace(cfg, n_layers=groups * cfg.hybrid.shared_every,
                                   dtype="float32" if train else cfg.dtype)
    if not train:
        return cfg
    n = TPF["train_whisper_layers"]
    return dataclasses.replace(cfg, n_layers=n,
                               encdec=dataclasses.replace(cfg.encdec, encoder_layers=n))


def _tpf_model(fam: str, cfg, dev):
    """``cfg``'s model drawn on the card from the family's seed (the same
    weights in every process)."""
    import torch

    from repro_torch.models import encdec as ED, transformer as T

    gen = torch.Generator(device=dev).manual_seed(TPF_FAMILIES[fam]["seed"])
    return (ED.init if cfg.family == "audio" else T.init)(cfg, device=dev, generator=gen)


def tpf_route_bytes(cfg, b: int, t: int, m: int) -> dict:
    """Bytes a rank receives a block over ``"model"`` (``m`` ranks, bf16
    activations and weights, float32 partial sums) at ``b x t`` tokens, for
    each site where a rank needs columns it does not compute, by the two
    routes: ``activation`` (its columns of the product gathered whole, the
    route the port takes) and ``kernel`` (the up kernel gathered whole with
    ``tp.whole_kernel``, each rank computing the columns it needs); and the
    row-parallel sums of the block's outputs (an all-reduce: ``2 (m - 1) /
    m`` of the float32 tensor; whisper's encoder block two over its frames,
    its decoder block three).  ``readout`` is the serving readout of the
    untied ``lm_head`` (once a call, not a block): the partial logits
    summed (``activation``, the port's) against the kernel's ``d`` rows
    gathered and the vocab columns' logits gathered (``kernel``)."""
    bf, f32 = 2, 4
    other = (m - 1) / m
    red = lambda n: 2 * other * b * t * n * f32
    d = cfg.d_model
    readout = {} if cfg.tie_embeddings else {"readout": {
        "activation": red(cfg.padded_vocab),
        "kernel": other * (d * cfg.padded_vocab * bf + b * t * cfg.padded_vocab * f32)}}
    if cfg.family == "ssm":
        lora = 5 * cfg.rwkv.mix_lora
        sites = {"mix_lora_a": {"activation": other * b * t * lora * bf,
                                "kernel": other * d * lora * bf},
                 "ln_x": {"activation": other * b * t * d * bf},
                 "channel_k": {"activation": other * b * t * cfg.d_ff * bf,
                               "kernel": other * cfg.d_ff * d * bf},
                 "channel_out": {"activation": other * b * t * d * bf},
                 "wo_sum": {"activation": red(d)}}
    elif cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        width = 2 * di + 2 * s.d_state + di // s.head_dim
        sites = {"w_in": {"activation": other * b * t * width * bf,
                          "kernel": other * d * width * bf},
                 "out_norm": {"activation": other * b * t * di * bf},
                 "w_out_sum": {"activation": red(d)}}
    else:
        red_enc = 2 * other * b * cfg.encdec.encoder_seq * d * f32
        sites = {"encoder_block_sums": {"activation": 2 * red_enc},
                 "decoder_block_sums": {"activation": 3 * red(d)}}
    return sites | readout


def _tpf_capture(mods, run) -> list:
    """``(module, args, kwargs)`` of every call of ``mods`` during
    ``run()``."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a, k: calls.append((m, a, k)),
                                         with_kwargs=True) for m in mods]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _tpf_blocks(model, cfg) -> list:
    if cfg.family == "ssm":
        return list(model.blocks)
    if cfg.family == "hybrid":
        return [blk for group in model.groups for blk in group] + [model.shared]
    return list(model.enc_blocks) + list(model.dec_blocks)


def _tpf_kernel_parity(dev, fam: str, cfg, b: int, t: int, m: int) -> dict:
    """This rank's kernels at its local shapes against their plain
    versions: rwkv6_scan's chunk and step kernels on ``H / m`` heads (phase
    9's tolerances: 1e-5 of the scale on o and the state, o also one bf16
    ulp of the element) and rmsnorm (rwkv, zamba2); flash on ``heads / m``
    heads (zamba2's shared block causal at head dim 80, whisper's encoder
    non-causal over 1500 frames and its decoder causal)."""
    import torch

    from repro_torch.kernels import ref, rwkv6_scan as rw

    errs = {}
    if fam == "rwkv":
        gen = torch.Generator(device=dev).manual_seed(26)
        h = cfg.d_model // cfg.rwkv.head_dim // m
        err = 0.0
        for tt in (t, 1):
            (r, k, v, w, u), s0 = _rwkv_inputs(gen, dev, b, h, tt, cfg.rwkv.head_dim,
                                               torch.bfloat16, time_major=True)
            o, s = rw.rwkv6_scan(r, k, v, w, u, s0)
            po, ps = ref.rwkv6_scan(r, k, v, w, u, s0)
            for g, p_, u_ in ((o, po, 2.0**-7), (s, ps, 0.0)):
                g64, p64 = g.double(), p_.double()
                scale = float(p64.abs().max())
                _check(bool(((g64 - p64).abs() <= u_ * p64.abs() + 1e-5 * scale).all()),
                       f"26: rwkv6_scan at {(b, h, tt, cfg.rwkv.head_dim)} vs plain")
                err = max(err, _max_err(g, p_))
        errs["rwkv6_scan"] = err
        errs.update(_tp_kernel_parity(dev, b, 1, 1, t, 64, cfg.d_model, False, cfg.norm_eps,
                                      flash=False))
    elif fam == "hybrid":
        heads = cfg.hybrid.shared_block_heads
        errs.update(_tp_kernel_parity(dev, b, heads // m, heads // m, t, cfg.d_model // heads,
                                      None, True, cfg.norm_eps))
        errs.update(_tp_kernel_parity(dev, b, 1, 1, t, 64, cfg.d_model, False, cfg.norm_eps,
                                      flash=False))
    else:
        h = cfg.n_heads // m
        enc = _tp_kernel_parity(dev, b, h, h, cfg.encdec.encoder_seq, cfg.resolved_head_dim, None,
                                True, cfg.norm_eps, causal=False)
        dec = _tp_kernel_parity(dev, b, h, h, t, cfg.resolved_head_dim, None, True,
                                cfg.norm_eps)
        errs.update({k: max(enc[k], dec[k]) for k in enc})
    return errs


def _tpf_counts() -> dict:
    return {k: v for k, v in {**_rwkv_counts(), **_train_counts()}.items()
            if k != "rwkv6_slab_sum"}


def _tpf_reset_counts() -> None:
    _reset_rwkv_counts()
    _reset_train_counts()


def _tpf_serve_job(dev, mesh, fam: str, out: dict) -> None:
    """26a-c on this rank: ``fam``'s one-process run, then the same model
    placed on ``mesh`` and run again; logits, launches, spans and each
    block alone against the one-process run."""
    import torch

    from repro_torch.core import profiling
    from repro_torch.models import encdec as ED, transformer as T
    from repro_torch.serve import build_decode_step, build_prefill_step
    from repro_torch.sharding import fsdp
    from repro_torch.train.loop import audio_frames

    c = TPF_FAMILIES[fam]
    cfg = _tpf_cfg(fam)
    b, tl = c["prefill"]
    n = TPF["whisper_decode"] if fam == "whisper" else TPF["decode"]
    toks = torch.as_tensor(serve_prompts(cfg.vocab_size, b, tl + n, c["prompt_seed"] + 3),
                           device=dev)
    prompts, fed = toks[:, :tl], toks[:, tl:]
    enc = (audio_frames(cfg, b, c["frame_seed"], dev),) if fam == "whisper" else ()
    model = _tpf_model(fam, cfg, dev)
    tag = f"{fam}/serve"

    def run(prefill, decode):
        """The prefill (unprofiled) and the decode steps (their
        collectives timed: ``core.profiling``'s spans)."""
        torch.cuda.synchronize()
        _tpf_reset_counts()
        t0 = time.perf_counter()
        logits, state = prefill(model, prompts, *enc, tl + n)
        torch.cuda.synchronize()
        res = {"prefill_s": time.perf_counter() - t0, "prefill_counts": _tpf_counts(),
               "prefill": logits}
        _tpf_reset_counts()
        steps, walls = [], []
        profiling.enable()
        for i in range(n):
            t0 = time.perf_counter()
            step_logits, state = decode(model, fed[:, i:i + 1], state, tl + i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            steps.append(step_logits)
        res["decode_spans"] = profiling.phases()
        profiling.disable()
        res.update(decode_walls=walls, decode_counts=_tpf_counts(), steps=torch.cat(steps, 1))
        return res

    with torch.inference_mode():
        one = run(build_prefill_step(cfg), build_decode_step(cfg))
        forward = (lambda: ED.forward(model, prompts, *enc)) if enc else \
            (lambda: T.forward(model, prompts))
        calls = _tpf_capture(_tpf_blocks(model, cfg), forward)
        ys = [blk(*a, **k)[0] for blk, a, k in calls]
    fsdp.shard_model(model, mesh)
    torch.cuda.empty_cache()
    m = model.tp.size
    out[f"{tag}/parity"] = _tpf_kernel_parity(dev, fam, cfg, b, tl, m)
    prefill, decode = build_prefill_step(cfg, mesh), build_decode_step(cfg, mesh)
    with torch.inference_mode():
        prefill(model, prompts[:, :16], *enc, 17)  # warm-up (the collectives' first calls)
        got = run(prefill, decode)
        profiling.enable()
        t0 = time.perf_counter()
        prefill(model, prompts, *enc, tl + n)
        torch.cuda.synchronize()
        out[f"{tag}/prefill_profiled_s"] = time.perf_counter() - t0
        out[f"{tag}/prefill_spans"] = profiling.phases()
        profiling.disable()
        ulps = []
        for (blk, a, k), y1 in zip(calls, ys):
            with fsdp.gathered(blk):
                y = blk(*a, **k)[0]
            ulps.append(_max_err(y, y1) / _bf16_ulp(float(y1.abs().max())))
    del calls, ys
    for k in ("prefill", "steps"):
        want, mine = one[k].float(), got[k].float()
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > {"rwkv": RWKV_MARGIN_TOL, "hybrid": HYBRID_MARGIN_TOL,
                                               "whisper": WHISPER_MARGIN_TOL}[fam]
        out[f"{tag}/{k}_err"] = _max_err(mine, want)
        out[f"{tag}/{k}_sure"] = int(sure.sum())
        out[f"{tag}/{k}_agree"] = int(((mine.argmax(-1) == want.argmax(-1)) & sure).sum())
        out[f"{tag}/{k}_print"] = _bit_prints({k: mine})[k]
        out[f"{tag}/{k}_finite"] = bool(torch.isfinite(mine).all())
    for k in ("prefill_s", "decode_walls", "prefill_counts", "decode_counts"):
        out[f"{tag}/{k}"], out[f"{tag}/one_{k}"] = got[k], one[k]
    out[f"{tag}/decode_spans"] = got["decode_spans"]
    out[f"{tag}/block_ulps"] = ulps
    out[f"{tag}/layers"] = (cfg.n_layers, cfg.encdec.encoder_layers if enc else 0)
    del model, one, got
    torch.cuda.empty_cache()


def _tpf_batch(cfg, i: int, dev) -> dict:
    """Step ``i``'s TRAIN batch (whisper: with the reference loop's
    frames)."""
    from repro_torch.train.loop import audio_frames

    batch = _fsdp_data(cfg).batch_at(i)
    if cfg.family == "audio":
        batch["frames"] = audio_frames(cfg, TRAIN["batch"], i, dev)
    return batch


TPF_TRAIN_LEAVES = {"rwkv": RWKV_TRAIN_LEAVES, "hybrid": HYBRID_TRAIN_LEAVES,
                    "whisper": WHISPER_TRAIN_LEAVES}


def _whole_samples(get, leaves) -> dict:
    """``train_samples`` of whole leaves (``get(name)`` the parameter
    ``name`` or its moment), gathered on the device."""
    import torch

    out = {}
    for i, path in enumerate(leaves):
        x = get(_port_leaf(path)).detach()
        idx = torch.as_tensor(train_indices(tuple(x.shape), i), device=x.device)
        out[path] = x.reshape(-1)[idx].double().cpu().tolist()
    return out


def _tpf_chunk(w, info):
    """This rank's shard of the whole leaf ``w`` by its ``DataShard``."""
    if info.model_dim is not None:
        w = w.chunk(info.model.size, info.model_dim)[info.model.rank]
    if info.dim is not None:
        w = w.chunk(info.size, info.dim)[info.rank]
    return w


def _tpf_train_job(dev, mesh, fam: str, out: dict) -> None:
    """26d on this rank: ``TPF["steps"]`` steps of ``fam``'s cut model in
    one process, then of the same weights placed on ``mesh``: the losses,
    grad norms, launches, walls, the family's sampled leaves and first
    moments after each step (this rank's part), and every element of this
    rank's shards against the one-process run's under TRAIN_TOL's loose
    bound."""
    import torch

    from repro_torch.core import profiling
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import fsdp

    cfg = _tpf_cfg(fam, train=True)
    tag, leaves = f"{fam}/train", TPF_TRAIN_LEAVES[fam]

    def run(model, samples):
        params = dict(model.named_parameters())
        opt, step = _fsdp_step(cfg)
        state = adamw_init(params, opt)
        res = {"loss": [], "grad_norm": [], "counts": [], "walls": [], "spans": [], "m": []}
        for i in range(TPF["steps"]):
            batch = _tpf_batch(cfg, i, dev)
            torch.cuda.synchronize()
            _tpf_reset_counts()
            profiling.enable()
            t0 = time.perf_counter()
            _, state, metrics = step(model, state, batch, i)
            res["loss"].append(float(metrics["loss"]))
            res["grad_norm"].append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            res["walls"].append(time.perf_counter() - t0)
            res["spans"].append(profiling.phases())
            profiling.disable()
            res["counts"].append(_tpf_counts())
            res["m"].append(samples(params, lambda n: state.m[n]))
        res["params"] = samples(params, lambda n: params[n])
        return params, res

    params, one = run(_tpf_model(fam, cfg, dev), lambda _, get: _whole_samples(get, leaves))
    want = {n: p.detach() for n, p in params.items()}
    del params
    torch.cuda.empty_cache()
    model = fsdp.shard_model(_tpf_model(fam, cfg, dev), mesh)
    torch.cuda.empty_cache()
    params, got = run(model, lambda ps, get: _fsdp_samples(ps, get, leaves))
    loose, tight, total = 0, 0, 0
    lr, steps = TRAIN["lr"], TPF["steps"]
    for name, p in params.items():
        w = _tpf_chunk(want[name], fsdp.shard_of(p))
        if not w.numel():
            continue
        g64, w64 = p.detach().double(), w.double()
        loose += _bf16_loose_bad(g64, w64, lr, steps)
        top = torch.maximum(g64.abs(), w64.abs())
        ulp = torch.where(top != 0, torch.exp2(torch.floor(torch.log2(top)) - 7),
                          torch.full_like(w64, 2.0 ** -133))
        tight += int(((g64 - w64).abs() <= TRAIN_TOL["param_ulps"] * ulp
                      + TRAIN_TOL["update_frac"] * lr * steps).sum())
        total += w.numel()
    out.update({f"{tag}/{k}": v for k, v in got.items()})
    out.update({f"{tag}/one_{k}": v for k, v in one.items() if k != "spans"})
    out.update({f"{tag}/loose_bad": loose, f"{tag}/tight_share": tight / total,
                f"{tag}/layers": (cfg.n_layers, cfg.encdec.encoder_layers if cfg.encdec else 0)})
    del model, params, want
    torch.cuda.empty_cache()


def _tpf_rank(rank: int, world: int, store: str, backend: str, job: str, out_dir: str):
    """One rank of phase 26's world: 26a-c, then 26d, on (1, 2); writes its
    results to ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_world, make_host_mesh

    t0 = time.perf_counter()
    init_world(rank, world, f"file://{store}", device_type="cuda", backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm", "rwkv6_scan"])
    dist.barrier()
    out: dict = {"backend": backend, "join_s": time.perf_counter() - t0}
    mesh = make_host_mesh(2, device_type="cuda")
    out["mesh"] = tuple(mesh.shape)
    for kind, job_fn in (("serve", _tpf_serve_job), ("train", _tpf_train_job)):
        for fam in TPF_FAMILIES:
            t1 = time.perf_counter()
            job_fn(dev, mesh, fam, out)
            out[f"{fam}/{kind}/job_s"] = time.perf_counter() - t1
            print(f"26 rank {rank}: {fam} {kind} {out[f'{fam}/{kind}/job_s']:.1f} s (peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)", flush=True)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def phase_tp_families(dev) -> dict:
    """Phase 26 (``TPF``): two gloo ranks sharing the card on (1, 2), each
    holding its runs to one process's on the same weights."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    card = _card()
    two = _run_world(2, "gloo", "f", target=_tpf_rank, join_s=TPF["join_s"])
    out = {"world_s": time.perf_counter() - t_phase, "launches": {}}
    tols = {"rwkv": (RWKV_PREFILL_TOL, RWKV_MARGIN_TOL, RWKV_BLOCK_ULPS),
            "hybrid": (HYBRID_PREFILL_TOL, HYBRID_MARGIN_TOL, HYBRID_BLOCK_ULPS),
            "whisper": (WHISPER_PREFILL_TOL, WHISPER_MARGIN_TOL, WHISPER_BLOCK_ULPS)}
    runs = []
    for fam, (tol, margin, max_ulps) in tols.items():
        tag = f"{fam}/serve"
        cfg = _tpf_cfg(fam)
        b, tl = TPF_FAMILIES[fam]["prefill"]
        print(f"26 tensor parallelism (1, 2), {fam} route bytes a rank a block at "
              f"{b} x {tl} / at a decode step of {b}: "
              f"{json.dumps(tpf_route_bytes(cfg, b, tl, 2))} / "
              f"{json.dumps(tpf_route_bytes(cfg, b, 1, 2))}")
        for rk, o in enumerate(two):
            sp, dsp = o[f"{tag}/prefill_spans"], o[f"{tag}/decode_spans"]
            print(f"26 {fam} TP serve, rank {rk} of 2 on {o['mesh']} (gloo, ranks sharing one "
                  f"{card}: not a scaling figure): {cfg.name} full width, layers "
                  f"{o[f'{tag}/layers']}, prefill {b} x {tl} {o[f'{tag}/prefill_s']:.4f} s (one "
                  f"process {o[f'{tag}/one_prefill_s']:.4f} s; a synchronized run "
                  f"{o[f'{tag}/prefill_profiled_s']:.4f} s, its collectives "
                  f"{_tp_coll_s(sp):.4f} s: { {k: round(v, 4) for k, v in sorted(sp.items())} }), "
                  f"{len(o[f'{tag}/decode_walls'])} decode steps {sum(o[f'{tag}/decode_walls']):.4f} s "
                  f"(one process {sum(o[f'{tag}/one_decode_walls']):.4f} s; collectives "
                  f"{_tp_coll_s(dsp):.4f} s); logits max|TP - one process| prefill "
                  f"{o[f'{tag}/prefill_err']:.4f}, decode {o[f'{tag}/steps_err']:.4f} (tolerance "
                  f"{tol}); argmax equal at {o[f'{tag}/prefill_agree']}/{o[f'{tag}/prefill_sure']} "
                  f"prefill and {o[f'{tag}/steps_agree']}/{o[f'{tag}/steps_sure']} decode positions "
                  f"with a top-2 margin > {margin}; blocks alone max|TP - one process| in bf16 "
                  f"ulps of the block output's largest value "
                  f"{[round(u, 2) for u in o[f'{tag}/block_ulps']]} (tolerance {max_ulps}); "
                  f"launches prefill {o[f'{tag}/prefill_counts']}, decode "
                  f"{o[f'{tag}/decode_counts']} (one process {o[f'{tag}/one_prefill_counts']}, "
                  f"{o[f'{tag}/one_decode_counts']}); kernels at the local shapes vs plain "
                  f"{o[f'{tag}/parity']}")
            _check(o[f"{tag}/prefill_finite"] and o[f"{tag}/steps_finite"]
                   and o[f"{tag}/prefill_err"] <= tol and o[f"{tag}/steps_err"] <= tol
                   and o[f"{tag}/prefill_agree"] == o[f"{tag}/prefill_sure"] > 0
                   and o[f"{tag}/steps_agree"] == o[f"{tag}/steps_sure"] > 0,
                   f"26 {fam} rank {rk}: TP serving differs from one process")
            _check(max(o[f"{tag}/block_ulps"]) <= max_ulps,
                   f"26 {fam} rank {rk}: a block alone differs from one process's")
            _check(o[f"{tag}/prefill_counts"] == o[f"{tag}/one_prefill_counts"]
                   and o[f"{tag}/decode_counts"] == o[f"{tag}/one_decode_counts"],
                   f"26 {fam} rank {rk}: launches differ from one process's")
            _check(o[f"{tag}/prefill_print"] == two[0][f"{tag}/prefill_print"]
                   and o[f"{tag}/steps_print"] == two[0][f"{tag}/steps_print"],
                   f"26 {fam} rank {rk}: the ranks' logits differ")
            runs += [o[f"{tag}/prefill_counts"], o[f"{tag}/decode_counts"]]
        out[fam] = {k: two[0][f"{tag}/{k}"] for k in ("prefill_s", "prefill_err", "steps_err",
                                                     "decode_walls", "block_ulps", "job_s")}
        out[fam]["prefill_coll_s"] = _tp_coll_s(two[0][f"{tag}/prefill_spans"])
        out[fam]["decode_coll_s"] = _tp_coll_s(two[0][f"{tag}/decode_spans"])
    lr = TRAIN["lr"]
    for fam in TPF_FAMILIES:
        tag = f"{fam}/train"
        cfg = _tpf_cfg(fam, train=True)
        leaves = TPF_TRAIN_LEAVES[fam]
        want = train_summary(two[0][f"{tag}/one_loss"], two[0][f"{tag}/one_grad_norm"],
                             two[0][f"{tag}/one_params"], two[0][f"{tag}/one_m"])
        merged_m = [_merge_samples([o[f"{tag}/m"][i] for o in two]) for i in range(TPF["steps"])]
        merged_p = _merge_samples([o[f"{tag}/params"] for o in two])
        for rk, o in enumerate(two):
            got = train_summary(o[f"{tag}/loss"], o[f"{tag}/grad_norm"], merged_p, merged_m)
            diff = compare_train(got, want, lr, leaves=leaves)
            worst = train_max_diff(got, want, lr, leaves=leaves)
            tol_name = "TRAIN_TOL, float32" if fam == "hybrid" else "TRAIN_TOL"
            sp = o[f"{tag}/spans"][-1]
            print(f"26d {fam} TP train, rank {rk} of 2 (gloo, ranks sharing one {card}: not a "
                  f"scaling figure): {cfg.name} full width, layers {o[f'{tag}/layers']}, "
                  f"{TRAIN['batch']} x {TRAIN['seq_len']} tokens: walls "
                  f"{_walls(o[f'{tag}/walls'])} s (one process {_walls(o[f'{tag}/one_walls'])} s; "
                  f"last step's collectives {_tp_coll_s(sp):.3f} s: "
                  f"{ {k: round(v, 4) for k, v in sorted(sp.items())} }), losses "
                  f"{o[f'{tag}/loss']} vs {o[f'{tag}/one_loss']}, grad norms "
                  f"{o[f'{tag}/grad_norm']} vs {o[f'{tag}/one_grad_norm']}; largest differences "
                  f"on the sampled leaves {json.dumps(worst)} ({tol_name}); parameters past the "
                  f"loose bound {o[f'{tag}/loose_bad']}, within the tight bound "
                  f"{100 * o[f'{tag}/tight_share']:.3f} %; launches a step "
                  f"{o[f'{tag}/counts'][-1]} (one process's {o[f'{tag}/one_counts'][-1]})")
            _check(not diff and o[f"{tag}/loose_bad"] == 0
                   and o[f"{tag}/counts"] == o[f"{tag}/one_counts"],
                   f"26d {fam} rank {rk}: TP training differs from one process: {diff[:4]}, "
                   f"past the loose bound {o[f'{tag}/loose_bad']}")
            runs += o[f"{tag}/counts"]
        out[f"{fam}_train"] = {k: two[0][f"{tag}/{k}"] for k in ("walls", "one_walls", "job_s")}
        out[f"{fam}_train"]["coll_s"] = _tp_coll_s(two[0][f"{tag}/spans"][-1])
    for c in runs:  # every main-path run of both ranks
        for name, k in c.items():
            out["launches"][name] = out["launches"].get(name, 0) + k
    out["parity"] = {}
    for o in two:
        for fam in TPF_FAMILIES:
            for name, err in o[f"{fam}/serve/parity"].items():
                out["parity"][name] = max(out["parity"].get(name, 0.0), err)
    for name in ("rwkv6_scan", "rmsnorm", "flash_attention_fwd"):
        _check(out["launches"].get(name, 0) > 0, f"26: {name} never launched on the TP path")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 26 (tensor parallelism, ssm / hybrid / audio): {out['phase_s']:.1f} s on "
          f"{card} (the world {out['world_s']:.1f} s; jobs a rank "
          f"{ {k: round(two[0][k], 1) for k in two[0] if k.endswith('job_s')} })")
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one campus run, prefill step, generation, training "
                         "step, rwkv6-7b prefill and generation, a degraded campus run, "
                         "phase 14's runs, the moe prefills and generations, a "
                         "deepseek-v2 training step, the zamba2 prefill and generation, "
                         "a zamba2 training step, the whisper prefill and generation, a "
                         "whisper training step and an rwkv6-7b training step; write the "
                         "tables and traces here")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.utils.devices import resolve_device

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in _build.build_logs.items():
        fn = ""  # the kernel ptxas reports on: its mangled name past the file's namespace
        for line in log.splitlines():
            if "Compiling entry function" in line and "'" in line:
                mangled = line.split("'")[1]
                fn = mangled[mangled.find("_cu_") + 12:][:60] if "_cu_" in mangled else mangled[:60]
                tmpl = re.search(r"pipeline_kernelI((?:L[bi]n?\d+E)+)E", mangled)
                if tmpl:  # hw::pipeline_kernel<SLEW, HEALTH, KAPPA, MASK>
                    args = [("-" if a[2] == "n" else "") + a.lstrip("Lbin")
                            for a in tmpl.group(1).split("E") if a]
                    fn = f"hw::pipeline_kernel<{', '.join(args)}>"
            elif "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {fn}: {line.strip()}")

    probe = chain_probe(dev)
    kernels = phase_kernels(dev)
    kernels["pdu_health"]["variants"] = phase_pdu_health_variants(dev)
    kernels["pdu_health"].update(phase_pdu_health_ragged(dev))
    kernels["admm_step"].update(phase_widened_shapes(dev))
    for name, n in zip(("pdu_health", "admm_step"), phase_quickstart(dev)):
        kernels[name]["launches_quickstart"] = n
    campus = phase_campus(dev, opts.profile)
    kernels["pdu_health"]["launches"], kernels["admm_step"]["launches"] = campus["counts"]
    for name in ("pdu_health", "admm_step"):
        kernels[name]["launches_scanned_capture"] = campus["scanned"]["capture"][name]
    if opts.profile is not None:
        c = CAMPUS
        profile_run("campus", lambda: run_campus(c["n_racks"], c["duration_s"], device=dev)[2],
                    opts.profile)
    kernels.update(phase_serve_kernels(dev))
    from repro_torch import convert
    from repro_torch.configs import full_config

    assert SERVE["arch"] == TRAIN["arch"] and SERVE["seed"] == TRAIN["seed"]
    t0 = time.perf_counter()
    tree = convert.random_lm_tree(full_config(SERVE["arch"]), SERVE["seed"])
    print(f"random_lm_tree({SERVE['arch']}, {SERVE['seed']}) in {time.perf_counter() - t0:.1f} s "
          f"(serving and training phases)")
    serve = phase_serve(dev, tree, opts.profile)
    torch.cuda.empty_cache()
    stablelm = phase_stablelm(dev)
    torch.cuda.empty_cache()
    kernels.update(phase_train_kernels(dev))
    trained = phase_train(dev, tree, opts.profile)
    del tree
    for name in ("rmsnorm", "flash_attention_fwd"):
        pre, gen = serve["prefill"][name], serve["generate"][name]
        tr = trained["counts"][name]
        kernels[name].update(launches=pre + gen + tr, launches_prefill=pre, launches_generate=gen,
                             launches_train=tr, launches_per_train_step=trained["per_step"][name])
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        kernels[name].update(launches=trained["counts"][name],
                             launches_per_train_step=trained["per_step"][name])
    for name, n in zip(("pdu_health", "admm_step"), trained["power_counts"]):
        kernels[name]["launches_train_powersim"] = n
    torch.cuda.empty_cache()
    kernels["rwkv6_scan"] = phase_rwkv_kernel(dev)
    rwkv = phase_rwkv_serve(dev, opts.profile)
    for name in ("rwkv6_scan", "rmsnorm"):
        pre, gen = rwkv["prefill"][name], rwkv["generate"][name]
        kernels[name].update(launches=(kernels[name]["launches"] or 0) + pre + gen,
                             launches_rwkv_prefill=pre, launches_rwkv_generate=gen)
    kernels["rwkv6_scan"]["second_pass_launches"] = (rwkv["prefill"]["rwkv6_slab_sum"]
                                                     + rwkv["generate"]["rwkv6_slab_sum"])
    torch.cuda.empty_cache()
    kernels.update(phase_sim_kernels(dev))
    # The chain bound of the hardware-path kernels beside their byte bound.
    for name in ("pdu_health", "pdu_sim", "pdu_sim_weight_series", "pdu_sim_weight_row",
                 "lc_filter"):
        e = kernels[name]
        t_len = e["shape"][0] if "shape" in e else 1000
        e["chain_bound_ms"] = chain_bound_ms(t_len, probe)
        e["chain_cycles_per_op"] = probe["cycles_per_op"]
        line = (f"chain bound {name}: T = {t_len} x {LC_CHAIN_OPS} dependent operations x "
                f"{probe['cycles_per_op']:.3f} cycles / {probe['clock_mhz']:.0f} MHz = "
                f"{e['chain_bound_ms']:.5f} ms (bytes bound {e['bound_ms']:.5f} ms, kernel "
                f"{e['ms']:.5f} ms)")
        if "bench_shape" in e or name.startswith("pdu_sim"):
            line += f"; at T = {SIM_BENCH['t']}: {chain_bound_ms(SIM_BENCH['t'], probe):.5f} ms"
        if "bench_ms" in e:
            e["bench_chain_bound_ms"] = chain_bound_ms(SIM_BENCH["t"], probe)
            line += f" (kernel {e['bench_ms']:.5f} ms)"
        if name == "pdu_health":
            line += f"; at the quickstart's T = {RAGGED_T_LONG}: " \
                    f"{chain_bound_ms(RAGGED_T_LONG, probe):.5f} ms"
        print(line)
    fig11 = phase_fig11(dev)
    for name, n in zip(("pdu_health", "admm_step"), fig11["counts"]):
        kernels[name]["launches_fig11"] = n
    fig12 = phase_fig12(dev, opts.profile)
    fleet_scale = phase_fleet_scale(dev, opts.profile)
    throughput = phase_controller_throughput(dev, opts.profile)
    kernels["admm_step"].update(
        launches_fig12=fig12["launches"], launches_fleet_cold=fleet_scale["cold"]["launches"][1],
        launches_fleet_warm=fleet_scale["warm"]["launches"][1],
        launches_controller_throughput_warm=throughput["launches_warm"])
    kernels["pdu_health"].update(launches_fleet_cold=fleet_scale["cold"]["launches"][0],
                                 launches_fleet_warm=fleet_scale["warm"]["launches"][0])
    if opts.profile is not None:
        c = FAULTY_CAMPUS
        profile_run("faulty_campus", lambda: run_faulty_campus(
            c["n_racks"], c["duration_s"], "host", device=dev)[2], opts.profile)
    faulty = phase_faulty_campus(dev, opts.profile)
    for engine, mode in (("host", "events"), ("oneshot", "series")):
        kernels["pdu_health"][f"launches_faulty_{engine}_{mode}"] = faulty[engine]["pdu_health"]
        kernels["admm_step"][f"launches_faulty_{engine}"] = faulty[engine]["admm_step"]
    kernels["pdu_health"]["launches_faulty_scanned_capture_events"] = \
        faulty["scanned"]["capture"]["pdu_health_by_mask"][3]
    kernels["admm_step"]["launches_faulty_scanned_capture"] = faulty["scanned"]["capture"]["admm_step"]
    safemode = phase_safemode(dev, campus, opts.profile)
    from repro_torch.kernels import pdu_health
    from repro_torch.kernels.pdu_health import MASK_SERIES as series
    kernels["pdu_health"].update(
        launches_safemode_host_series=safemode["host_counts"][2][series],
        launches_safemode_scanned_capture_series=safemode["scanned"]["capture"]
        ["pdu_health_by_mask"][series],
        launches_drill_host_series=safemode["drill_host_counts"][2][series],
        launches_drill_scanned_capture_series=safemode["drill_capture"]["pdu_health_by_mask"]
        [series])
    kernels["admm_step"].update(
        launches_safemode_host=safemode["host_counts"][1],
        launches_safemode_scanned_capture=safemode["scanned"]["capture"]["admm_step"],
        launches_drill_host=safemode["drill_host_counts"][1],
        launches_drill_scanned_capture=safemode["drill_capture"]["admm_step"])
    region = phase_grid_region(dev, opts.profile)
    region_service = phase_region_service(dev)
    campus_service = phase_campus_service(dev, faulty["scanned"]["res"])
    kernels["pdu_health"].update(
        launches_region_capture=region["capture"]["pdu_health"],
        launches_campus_service_capture_events=campus_service["capture_by_mask"][
            pdu_health.MASK_EVENTS])
    kernels["admm_step"]["launches_region_capture"] = region["capture"]["admm_step"]
    kernels["flash_attention_fwd"]["launches_stablelm_prefill"] = stablelm["flash_attention_fwd"]
    t17 = time.perf_counter()
    moe_kernels = phase_moe_kernels(dev)
    _, v2_model = _moe_model(MOE_V2, dev)  # served in 17b, trained in 18b
    moe = {"v2": phase_moe_serve(dev, MOE_V2, opts.profile, model=v2_model),
           "v3": phase_moe_serve(dev, MOE_V3, opts.profile)}
    print(f"phase 17 (moe): {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    for name, row in phase_moe_train_kernels(dev).items():
        kernels[name].update(row)
    moe_train = phase_moe_train(dev, v2_model, opts.profile)
    del v2_model
    torch.cuda.empty_cache()
    moe_train_ref = phase_moe_train_reference(dev)
    moe_train_power = phase_train_power(dev, moe_config(MOE_V2), MOE_TRAIN,
                                        moe_train_launches(moe_config(MOE_V2)))
    torch.cuda.empty_cache()
    print(f"phase 18 (moe training): {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    for name, row in phase_hybrid_kernels(dev).items():
        kernels[name].update(row)
    hybrid_model = _hybrid_model(dev)  # served in 19b, trained in 20a
    hybrid = phase_hybrid_serve(dev, hybrid_model, opts.profile)
    print(f"phase 19 (hybrid serving): {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    hybrid_train = phase_hybrid_train(dev, hybrid_model, opts.profile)
    del hybrid_model
    torch.cuda.empty_cache()
    hybrid_train_ref = phase_hybrid_train_reference(dev)
    hybrid_cfg = full_config(HYBRID["arch"])
    hybrid_train_power = phase_train_power(dev, hybrid_cfg, HYBRID,
                                           hybrid_launches(hybrid_cfg)["train"])
    torch.cuda.empty_cache()
    print(f"phase 20 (hybrid training): {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    for name, row in phase_whisper_kernels(dev).items():
        kernels[name].update(row)
    whisper_cross = phase_whisper_cross(dev)
    print(f"phase 21a (audio kernels): {time.perf_counter() - t21:.1f} s")
    t21b = time.perf_counter()
    whisper_model = _whisper_model(dev)  # served in 21b, trained in 21c
    whisper = phase_whisper_serve(dev, whisper_model, opts.profile)
    print(f"phase 21b (audio serving): {time.perf_counter() - t21b:.1f} s")
    t21c = time.perf_counter()
    whisper_train = phase_whisper_train(dev, whisper_model, whisper_cross, opts.profile)
    del whisper_model
    torch.cuda.empty_cache()
    whisper_cfg = full_config(WHISPER["arch"])
    whisper_train_power = phase_train_power(dev, whisper_cfg, WHISPER,
                                            whisper_launches(whisper_cfg)["train"])
    torch.cuda.empty_cache()
    print(f"phase 21c (audio training): {time.perf_counter() - t21c:.1f} s")
    t21d = time.perf_counter()
    whisper_serve_ref = phase_whisper_serve_reference(dev)
    whisper_train_ref = phase_whisper_train_reference(dev)
    print(f"phase 21d (audio vs JAX): {time.perf_counter() - t21d:.1f} s")
    print(f"phase 21 (audio): {time.perf_counter() - t21:.1f} s")
    t22 = time.perf_counter()
    rwkv_model = _rwkv_train_model(dev)
    rwkv_train = phase_rwkv_train(dev, rwkv_model, opts.profile)
    del rwkv_model
    rwkv_grads = rwkv_train.pop("grads")
    torch.cuda.empty_cache()
    print(f"phase 22a-b (ssm training): {time.perf_counter() - t22:.1f} s")
    rwkv_compress = phase_rwkv_compression(dev, rwkv_grads)
    del rwkv_grads
    torch.cuda.empty_cache()
    t22c = time.perf_counter()
    rwkv_train_ref = phase_rwkv_train_reference(dev)
    print(f"phase 22c (ssm training vs JAX): {time.perf_counter() - t22c:.1f} s")
    rwkv_train_power = phase_rwkv_train_power(dev)
    torch.cuda.empty_cache()
    phase22_s = time.perf_counter() - t22
    print(f"phase 22 (ssm training): {phase22_s:.1f} s")
    sharded = phase_sharded(dev, campus, region)
    for name in ("pdu_health", "admm_step"):
        kernels[name].update(
            launches_sharded_region_capture=sum(c[name] for c in sharded["captures"]),
            launches_sharded_campus=sharded["campus_counts"][name])
    start_8a = trained.pop("start_8a")
    fsdp_train = phase_fsdp(dev, trained.pop("steps_8a"), start_8a)
    tp_run = phase_tp(dev, start_8a, serve.pop("tp_ref"))
    del start_8a
    tpf_run = phase_tp_families(dev)
    fa, rn = kernels["flash_attention_fwd"], kernels["rmsnorm"]
    fa.update({k: v for k, v in moe_kernels.items() if k.startswith("mla_")},
              mla_max_abs_err=moe_kernels["err"])
    rn["widths"] = moe_kernels["rmsnorm_widths"]
    for label, r in moe.items():
        for name, e in (("flash_attention_fwd", fa), ("rmsnorm", rn)):
            pre, gen = r["prefill"][name], r["generate"][name]
            e.update({"launches": e["launches"] + pre + gen, f"launches_moe_{label}_prefill": pre,
                      f"launches_moe_{label}_generate": gen})
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                 "rmsnorm"):
        n = moe_train["counts"][name]
        kernels[name].update(launches=kernels[name]["launches"] + n, launches_moe_v2_train=n,
                             launches_per_moe_v2_train_step=moe_train["per_step"][name],
                             launches_moe_v2_train_powersim=moe_train_power["counts"][name])
    for name, n in zip(("pdu_health", "admm_step"), moe_train_power["power_counts"]):
        kernels[name]["launches_moe_train_powersim"] = n
    for name in ("flash_attention_fwd", "rmsnorm"):
        pre, gen = hybrid["prefill"][name], hybrid["generate"][name]
        kernels[name].update(launches=kernels[name]["launches"] + pre + gen,
                             launches_hybrid_prefill=pre, launches_hybrid_generate=gen)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                 "rmsnorm"):
        n = hybrid_train["counts"][name]
        kernels[name].update(launches=kernels[name]["launches"] + n, launches_hybrid_train=n,
                             launches_per_hybrid_train_step=hybrid_train["per_step"][name],
                             launches_hybrid_train_reference=hybrid_train_ref["counts"][name],
                             launches_hybrid_train_powersim=hybrid_train_power["counts"][name])
    for name, n in zip(("pdu_health", "admm_step"), hybrid_train_power["power_counts"]):
        kernels[name]["launches_hybrid_train_powersim"] = n
    n = whisper["prefill"]["flash_attention_fwd"] + whisper["generate"]["flash_attention_fwd"]
    fa.update(launches=fa["launches"] + n,
              launches_whisper_prefill=whisper["prefill"]["flash_attention_fwd"],
              launches_whisper_generate=whisper["generate"]["flash_attention_fwd"],
              launches_whisper_serve_reference=whisper_serve_ref["counts"]["flash_attention_fwd"])
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        n = whisper_train["counts"][name]
        kernels[name].update(launches=kernels[name]["launches"] + n, launches_whisper_train=n,
                             launches_per_whisper_train_step=whisper_train["per_step"][name],
                             launches_whisper_train_reference=whisper_train_ref["counts"][name],
                             launches_whisper_train_powersim=whisper_train_power["counts"][name])
    for name, n in zip(("pdu_health", "admm_step"), whisper_train_power["power_counts"]):
        kernels[name]["launches_whisper_train_powersim"] = n
    n = rwkv_train["counts"]["rmsnorm"]
    rn.update(launches=rn["launches"] + n, launches_rwkv_train=n,
              launches_per_rwkv_train_step=rwkv_train["per_step"]["rmsnorm"],
              launches_rwkv_train_reference=rwkv_train_ref["counts"]["rmsnorm"],
              launches_rwkv_train_powersim=rwkv_train_power["counts"]["rmsnorm"])
    kernels["rwkv6_scan"].update(launches_rwkv_train=0, launches_per_rwkv_train_step=0,
                                 plain_chunked_per_rwkv_train_step=rwkv_train["plain_per_step"]
                                 ["rwkv6_chunked"])
    for name, n in zip(("pdu_health", "admm_step"), rwkv_train_power["power_counts"]):
        kernels[name]["launches_rwkv_train_powersim"] = n
    per = fsdp_train["launches_per_step"]
    for name, n in fsdp_train["launches"].items():
        kernels[name].update(
            launches=kernels[name]["launches"] + n, launches_fsdp_train=n,
            launches_per_fsdp_step_one_rank=per["one_rank"][name],
            launches_per_fsdp_step_two_ranks={k: c[name] for k, c in per["two_ranks"].items()})
    for name, n in tp_run["launches"].items():
        kernels[name].update(launches=kernels[name]["launches"] + n, launches_tp=n)
    for name, n in tpf_run["launches"].items():
        kernels[name].update(launches=kernels[name]["launches"] + n, launches_tp_families=n,
                             tp_families_max_abs_err=tpf_run["parity"].get(name))
    print(json.dumps({"serve": {k: serve[k] for k in ("prefill_s", "generate_s", "tokens_per_s")},
                      "train": {k: trained[k] for k in ("step_s", "tokens_per_s", "train_mfu",
                                                         "peak_gb")},
                      "rwkv_serve": {k: rwkv[k] for k in ("prefill_s", "generate_s",
                                                          "tokens_per_s")},
                      "fig11": {k: fig11[k] for k in ("wall_s", "envelope_ms",
                                                      "burn_vs_easyrider_frac")},
                      "stablelm_prefill_s": stablelm["prefill_s"],
                      "fig12": {k: fig12[k] for k in ("wall_s", "plain_wall_s", "soc_final",
                                                      "converge_min")},
                      "fleet_1024racks": {
                          "cold_s": fleet_scale["cold"]["wall_s"],
                          "warm_s": fleet_scale["warm"]["wall_s"],
                          "cold_us_per_rack": fleet_scale["cold"]["us_per_rack"],
                          "warm_us_per_rack": fleet_scale["warm"]["us_per_rack"],
                          "cold_warm_ratio": fleet_scale["cold_warm_ratio"],
                          "campus_ramp": fleet_scale["warm"]["ramp"],
                          "qp_resid_cold": fleet_scale["cold"]["resid"],
                          "qp_resid_warm": fleet_scale["warm"]["resid"]},
                      "controller_throughput": {
                          k: throughput[k] for k in ("cold_racksolves_per_s",
                                                     "warm_racksolves_per_s", "warm_resid")},
                      "campus_s": {"host": campus["host_s"],
                                   "scanned_cold": campus["scanned"]["cold_s"],
                                   "scanned_warm": campus["scanned"]["warm_s"],
                                   "scanned_window_warm": campus["scanned"]["window_warm_s"]},
                      "faulty_campus_s": {"host": faulty["host"]["wall_s"],
                                          "oneshot": faulty["oneshot"]["wall_s"],
                                          "scanned_cold": faulty["scanned"]["cold_s"],
                                          "scanned_warm": faulty["scanned"]["warm_s"],
                                          "scanned_window_warm":
                                              faulty["scanned"]["window_warm_s"]},
                      "scanned_peak_mib": {"campus": campus["scanned"]["peak_mib"],
                                           "faulty_campus": faulty["scanned"]["peak_mib"]},
                      "scanned_graph_nodes": {"campus": campus["scanned"]["nodes"],
                                              "faulty_campus": faulty["scanned"]["nodes"],
                                              "supervised_campus": safemode["nodes"]},
                      "safemode": {
                          "campus_scanned_cold_s": safemode["scanned"]["cold_s"],
                          "campus_scanned_warm_s": safemode["scanned"]["warm_s"],
                          "overhead": safemode["overhead"],
                          "drill_walls_s": safemode["drill_walls"],
                          "drill_scanned_cold_s": safemode["drill_cold_s"]},
                      "grid_region": {
                          "synchronized_cold_s": region["synchronized"]["cold_s"],
                          "synchronized_warm_s": region["synchronized"]["warm_s"],
                          "staggered_warm_s": region["staggered"]["warm_s"],
                          "poi_fold_s": region["synchronized"]["fold_s"],
                          "poi_response_s": region["synchronized"]["poi_response_s"],
                          "inter_area_separation": region["separation"],
                          "graph_nodes": region["nodes"]},
                      "service": {
                          "region_cold_window_s": region_service["cold_window_s"],
                          "region_warm_window_s": region_service["warm_window_s"],
                          "campus_warm_window_s": campus_service["warm_window_s"]},
                      "moe_serve": {label: {k: r[k] for k in (
                          "prefill_s", "prefill_tokens_per_s", "generate_s", "tokens_per_s",
                          "peak_gib", "phase_s", "routing_flips")} for label, r in moe.items()},
                      "moe_train": {k: moe_train[k] for k in (
                          "walls", "step_s", "tokens_per_s", "train_mfu", "peak_gib",
                          "plain_step_s", "routing_flips", "same_bits", "phase_s")},
                      "moe_train_vs_jax_flips": {a: r["flipped"] for a, r in moe_train_ref.items()},
                      "moe_train_powersim_s": moe_train_power["wall_s"],
                      "hybrid_serve": {k: hybrid[k] for k in (
                          "prefill_s", "prefill_tokens_per_s", "generate_s", "tokens_per_s",
                          "peak_gib", "phase_s")},
                      "hybrid_train": {k: hybrid_train[k] for k in (
                          "walls", "step_s", "tokens_per_s", "train_mfu", "peak_gib",
                          "plain_step_s", "same_bits", "phase_s")},
                      "hybrid_train_powersim_s": hybrid_train_power["wall_s"],
                      "whisper_serve": {k: whisper[k] for k in (
                          "prefill_s", "prefill_tokens_per_s", "generate_s", "tokens_per_s",
                          "peak_gib", "phase_s")},
                      "whisper_train": {k: whisper_train[k] for k in (
                          "walls", "step_s", "tokens_per_s", "train_mfu", "peak_gib",
                          "plain_step_s", "same_bits", "cross_attention_share", "phase_s")},
                      "whisper_cross_attention_ms": whisper_cross,
                      "whisper_train_powersim_s": whisper_train_power["wall_s"],
                      "rwkv_train": {k: rwkv_train[k] for k in (
                          "walls", "step_s", "tokens_per_s", "train_mfu", "peak_gib",
                          "plain_step_s", "same_bits", "phase_s")},
                      "rwkv_train_powersim_s": rwkv_train_power["wall_s"],
                      "rwkv_compression": {k: rwkv_compress[k] for k in (
                          "round_ms", "elements", "same_bits", "resid_over_step", "phase_s")},
                      "phase22_s": phase22_s,
                      "sharded": {k: sharded[k] for k in ("region_world_s", "worlds_s",
                                                          "phase_s")},
                      "fsdp_train": {k: fsdp_train[k] for k in (
                          "a_walls", "a_peak_gb", "a_collective_share", "a_world_s",
                          "b_world_s", "c_one_s", "phase_s")},
                      "tp": {k: tp_run[k] for k in (
                          "a", "b12_walls", "b12_coll_s", "b22_walls", "b22_coll_s", "c",
                          "world2_s", "world4_s", "phase_s")},
                      "tp_families": {k: tpf_run[k] for k in (
                          "rwkv", "hybrid", "whisper", "rwkv_train", "hybrid_train",
                          "whisper_train", "world_s", "phase_s")}}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
