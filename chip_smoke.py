#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``r2d2_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each exits non-zero on failure):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them;
2. build: compile every kernel of the serving path from ``r2d2_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) and print the seconds;
3. kernel vs plain: three designs against ``lstm_unroll_reference`` on
   the card, H=512, B in {1, 7, 8, 64, 65, 256} (65 crosses a 64-row tile;
   8 is the actor fleet's batch),
   T in {1, 85}, TF32 off: the tensor-core kernel (bf16 ``wh``, the main
   path), the f32 kernel ``lstm_step_f32`` (the f32 route: TMA, h
   multicast across a cluster, f32 FMAs) and the first CUDA-core design in
   bfloat16 (kept for comparison; "the CUDA-core kernel" or "route" in
   the phases below is the f32 route, ``lstm_step_f32``, counted under
   ``CUDACORE_COUNTER``).  Each step, taken from the
   kernel's own state, must match the plain step to 1e-5 max-abs in
   float32 and 1e-4 in bfloat16 (the operands are rounded at the same
   points, only the order of the f32 sums differs), the one-launch unroll
   must equal the chain of one-step launches bit for bit, and the whole
   unroll must match the plain unroll to 1e-5 in float32 and 1e-2 in
   bfloat16 (there a last-bit difference that crosses a bf16 rounding
   boundary of h moves the next operand by one bf16 ulp, and the
   recurrence carries it).  Then the tensor-core kernel's device time at
   each tile width n, and at (T, B) = (1, 1), (1, 8), (1, 32), (1, 64),
   (1, 256), (85, 64) in bf16, in ``ROUNDS`` rounds that take the designs in turns
   (forward, then backward): time per call with the launch (CUDA events),
   device time (``torch.profiler``) and the host's time to issue a call, of
   both kernels and the plain version, and of the layer step (``x @ wi +
   b`` then the kernel) against one library call for the same layer step
   (``torch.lstm_cell`` at T=1, cuDNN ``nn.LSTM`` at T=85, both in bf16,
   held to the plain layer to a loose ``LIB_TOL``); and the bound.  Then
   the f32 route at its main-path shapes, (T, B, H) = (1, 16, 128) (the
   reference soak's) and (1, 1), (1, 8), (1, 32), (1, 64), (1, 256) at
   H=512 (the load generator's float32 cell): per call and device time of
   the f32 kernel beside the first design in f32, the plain version, the
   layer step and ``torch.lstm_cell`` in f32 with TF32 off, and
   ``lstm_bound_ms(..., "float32")``; the kernel and the first design
   held to the plain version (1e-5), the library call to the plain layer
   step (``F32_LIB_TOL``); before that, the f32 kernel's device time at
   (1, 16) H=128, (1, 64) and (1, 256) H=512 with ``f32_plan``'s cluster,
   then its units a block, varied;
4. full-width serving: the flagship ``Config()`` (nature torso over
   84×84 frames space-to-depth folded, H=512, bfloat16 compute,
   ``serve_max_batch=256`` so 9 buckets, 9 actions) with seeded random
   params behind the port's ``SessionServer`` on 127.0.0.1.  A
   ``SessionClient`` opens 64 sessions and sends 4 act steps each (step 0
   resets) in groups of 1, 2, 5, 8, 16 and 32 sessions so that batches of
   different sizes form.  Checked: every reply is OK with finite q; each
   batch's rows are the sessions' requests and carry each session's
   hidden from its previous step (zeros after the reset); each batch's new
   hidden matches a direct ``R2D2Network.act`` on the same card and params,
   with the plain LSTM in place of the kernel, to 1e-4 max-abs, and its q
   the plain dueling head of that served hidden to 2e-3 (the q of the
   plain act end to end is printed, max-abs and in bf16 ulps: both ends
   round in the bf16 head, so it may differ by one ulp); the store's
   ``admitted == completed + reaped + evicted + live``; and the
   tensor-core kernel was launched once per batch and layer, the
   CUDA-core one never (counts reset just before the traffic; a replayed
   graph adds the launches its capture recorded).  The act replays one
   CUDA graph per bucket: ``warmup`` captures all 9, the traffic none,
   and each bucket's graph is held bit for bit (q and new hidden) to the
   eager act on the published params and the same rows, cuDNN
   deterministic through the phase.  Prints the client-side p50/p99 act
   latency, and per act alone at n in {1, 32, 256} the host wall clock,
   issue, device time and device events of the graphed act against the
   same act issued eagerly (``graph_vs_eager``; the put and fetch around
   both), in which the profiler must find the tensor-core kernel and not
   the CUDA-core one;
5. full-width training: ``train_sync(cfg, device="cuda")`` on the flagship
   ``Config(game_name="Fake")`` (nature torso on 21×21×16 frames, H=512,
   bf16 compute, batch 64, burn-in 40 + learning 40 + forward 5, 8 actors,
   blocks of 400) with only the replay size, warm-up and run length cut
   (printed on the ``reduced:`` line): 16 updates, a target sync at step 8,
   saves at 8 and 16, then 4 greedy evaluation episodes.  Checked: the
   tensor-core kernel launched once per layer for every actor iteration and
   evaluator step and the CUDA-core one never (counts reset just before
   the run); all 16 losses finite and all 16 priority feedbacks in the
   buffer; the target equal to the online params after step 8 and not
   after 7; the latest checkpoint restoring into a fresh learner bit for
   bit; a finite greedy return; the profiler finding the tensor-core
   kernel in an actor iteration and no LSTM kernel in a learner update;
   the learner's 16 updates (and the profiled ones) replayed from one
   CUDA-graph capture of ``learner.train_step``; from one state at step 6
   and one batch, graphed updates 7, 8 and 9 bit for bit the eager
   step's (loss, priorities, params, Adam moments, target, counters;
   cuDNN deterministic); and one learner step at a reduced width (mlp
   torso, H=64) in bf16 on the card against float32 on the CPU
   (``STEP_LOSS_RTOL``, ``STEP_PRIO_ATOL``).  Prints env steps/s while
   filling, the learner update's wall clock, device time, idle share and
   top device ops, a lone graphed update's host issue, wall, device time
   and kernel nodes beside the eager one's, and the host and device time
   of an actor iteration;
6. the IMPALA-deep fabric at full width: ``impala_deep_config(game_name=
   "Fake")`` (the IMPALA residual CNN over raw 84×84 frames, two LSTM
   layers of H=512, batch 64, burn-in 40 + learning 75 + forward 5, blocks
   of 375, remat, bf16 compute, 8 actors) with only the replay size,
   warm-up and run length cut (the ``reduced:`` line), trained by the
   threaded ``train()`` in this (the main) thread for 12 updates, resumed
   warm to 14, then its checkpoint served by ``run_server`` in a worker
   thread to a client process (16 sessions × 4 steps).  Checked: 12
   updates and 12 priority feedbacks, no thread restarted, every loss
   finite; the kernel launched twice per actor act (one per layer), the
   CUDA-core one never; ``/healthz`` (``ok``) and ``/metrics`` answered on
   the run's ephemeral port; the JSONL run log and a complete ``step_12``
   replay snapshot on disk; the resume restores the replay and the actors
   (counters monotone) and ends at 14 updates; every served new hidden
   within 2e-3 of the plain-LSTM act of the same restored params and every
   served q within 2e-3 of their plain head of that hidden (as phase 4);
   the store's accounting quadruple exact; two launches per served batch;
   the shutdown session snapshot's counters equal to the server's.
   Prints env steps/s while filling and while training, updates/s and the
   update interval p50, the device time, idle share and top ops of one
   profiled update, an actor iteration's host/device time and the kernel's share,
   tensor-map encodes per act, the act's and the update's graph replays
   with their waits for and holds of ``PROFILER_LOCK`` (a hold is a
   launch), the served act and client round trip
   p50/p99, and the phase's seconds;
7. the Pong preset from a device-resident replay ring:
   ``pong_config(game_name="Fake")`` at full width (nature torso on
   21×21×16 frames, one LSTM layer of H = 512, bf16, batch 64, burn-in 40
   + learning 40 + forward 5, 64 actors with 8 env workers,
   ``superstep_k=4``, ``superstep_pipeline=2``) with the full
   2 000 000-transition ring (15.80 GB) on the card, cut only in warm-up
   and run length (the ``reduced:`` line).  First, on the card: a ring of
   a few blocks at the full slot shapes, filled like a host
   ``ReplayBuffer``, gathers every ``sample_meta`` bundle bit for bit
   like the host ring's ``_gather_rows``; the in-graph sampler over the
   full ring's 50 000 leaves draws the same indices and ints as on the
   CPU for the same uniforms, weights within 1e-6; one host-sampled
   super-step, replayed from its CUDA graph, equals k sequential eager
   train steps bit for bit, and the graphed in-graph super-step equals
   its eager run from the same ring, state and generator seed (sampled
   indices, losses, the leaves, params), for two dispatches (cuDNN
   deterministic for these checks only).  Then ``train()`` on the main
   thread, 32 updates with ``in_graph_per=True`` and 16 with it off, under
   a wall budget.  Checked: the ring built on the card (no fallback
   warning, ``in_graph_per`` kept) with ``nbytes() == data_bytes``;
   updates k per dispatch and every loss finite; one ``learner.
   result_fetch`` per dispatch; dispatch puts under 10 KB per dispatch;
   k priority feedbacks per dispatch (host-sampled); the scatter changing
   only drawn leaves and every padding leaf still 0 (in-graph); the
   kernel launched once per act (one layer), the CUDA-core one never, and
   no LSTM kernel in a profiled super-step; the checkpoint at 16 written
   and no replay snapshot; the run's super-step captured once.  Prints
   env steps/s while filling and while training, the dispatch interval
   p50, the lock hold per in-graph dispatch, a lone graphed super-step's
   host issue, wall clock, device time and kernel nodes beside the same
   super-step issued eagerly, its top device ops, ring and peak GB, and
   the phase's seconds;
8. anakin, the fused env → act → cut → write → train loop: the README's
   ``Config(game_name="Fake", actor_transport="anakin", anakin_env=
   "grid")`` at full width (nature torso on 21×21×16 frames, H = 512,
   bf16, batch 64, burn-in 40 + learning 40 + forward 5, 8 lanes,
   ``superstep_k=8``, ``anakin_env_steps_per_update=4``, episodes of 32)
   on the card, cut in replay size (500 of the 5 000 blocks, so that the
   resume reads a 1.58 GB snapshot), warm-up, run length, eval cadence
   and the target/save intervals (the ``reduced:`` line).  First: one
   32-step fused rollout of the fake env at ``base_eps = 1`` with seeded
   draws, bf16 on the card against f32 on the CPU (bytes, actions, integer fields, ``n_step_gamma`` and PER
   metadata identical; q, hiddens and priorities within 2e-2); then, on a
   64-block ring with cuDNN deterministic, the meshless entries' CUDA
   graphs (the rollout captured at the first rollout, the super-step at
   dispatches 0 and 1, one graph per eval branch) held bit for bit to the
   eager entries run from copies of the same carry, ring, leaves,
   ``seq_meta``, ``first``, train state and index at rollouts 1 and 2 and
   dispatches 2, 3 and 4 (the eval lane on at 2 and 4: the bitwise
   repeat), snapshot → restore into a plane of other params → dispatch 3
   bitwise equal to the uninterrupted plane's, one capture of the rollout
   and two of the super-step, then a lone rollout and a lone training
   dispatch graphed against eager (``graph_vs_eager``).  Then ``train(cfg,
   device="cuda")`` for 6 dispatches of k = 8, and ``resume=True`` for 2
   more, both replaying the graphs.  Checked: one
   ``anakin.result_fetch`` per rollout and per dispatch and one
   ``anakin.snapshot_fetch`` per snapshot; the third dispatch clean under
   ``torch.cuda.set_sync_debug_mode("error")``; k finite losses per
   dispatch; N eval episodes on each eval dispatch; ``fill`` equal to the
   sum of ``block_learning_total``; the ring on the card at
   ``data_bytes``; ``lstm_infer`` launched 0 times (the anakin actor acts
   through the scan recurrence, as JAX's); the resume restoring the
   counters, and them monotone.  Prints the lone graphed dispatches' top
   device ops, env frames/s while filling and training, the dispatch
   interval p50, ring and peak GB, the snapshot's write and read seconds,
   and the phase's seconds;
9. process fleets: ``pong_config(game_name="Fake", actor_transport=
   "process", actor_fleets=8)`` — phase 7's preset with its 64 actors in 8
   spawned subprocess fleets of 8 lanes — with the full ring on the card,
   cut as phase 7 is, trained by ``train()`` for 16 updates in serve mode
   (every env step an act RPC to the trainer's ``InferenceService``, which
   acts through the kernel at the 64-lane batch) and then 16 in local mode
   (each fleet acts through its f32 CPU twin on pumped weights).  First,
   ``/dev/shm`` must have room for the fleets' slabs.  Checked, both modes:
   16 updates in 4 dispatches, every loss finite and k priority feedbacks
   a dispatch; the buffer's transitions equal the ingested blocks'; 0
   corrupt blocks, 0 fleet restarts, every circuit closed with 0 opens and
   0 local-twin acts, ``/healthz`` ok; each fleet's report (asked for while
   it runs) shows no CUDA context and no JAX, and ``nvidia-smi
   --query-compute-apps`` lists no fleet's pid; the ring on the card at
   ``data_bytes``.  Serve mode: ``lstm_infer`` launched lstm_layers x
   (served batches + the one warm-up act of ``InferenceService.start``)
   times, the CUDA-core kernel never; one ``serve.act_fetch`` per batch
   and one ``serve.act_put`` per act; the lanes served equal to the fleets'
   env steps from the stats slab, but for at most one iteration a fleet
   whose last served act the drain cut short; then one 64-lane batch
   through the service's card act (bf16, the kernel) against the fleets'
   f32 CPU twin, q within ``SERVE_CPU_TOL``.  Local mode: no ``lstm_infer``
   launch in the trainer, and every fleet's pumped version past the first
   (a fleet reports it in the stats it publishes after each burst, so
   the last dispatch first waits, at most ``PUMP_WAIT_S``, until every
   fleet has reported one; the trainer's pumps and each fleet's first
   report past version 1 are printed).
   Prints, per mode: the dispatch interval p50, the lock hold p50, env
   steps/s while filling and while training (from the fleets' own act
   times), the fleets' act (RPC round trip, or CPU act) p50/p99, in serve
   mode ``serve.act`` p50/p99, mean lanes per batch and partial batches
   (and those at steady state: after the first full batch, a missing
   fleet's request following no block cut), the learner thread's, the
   trainer's and the fleets' CPU cores, peak GB; then each run's interval
   against phase 7's lone super-step beside phase 7's in-graph run, and
   the phase's seconds;
10. the sharded replay plane: the README's flagship ``Config(game_name=
    "Fake", replay_shards=4)`` at full width (nature torso on 21×21×16
    frames, H = 512, bf16, batch 64, burn-in 40 + learning 40 + forward 5,
    8 thread actors acting through the kernel at B = 8) with the full
    5 000-block host ring (1 250 blocks a shard), cut only in warm-up (16
    blocks, 4 a shard) and run length (the ``reduced:`` line).  First,
    ``/dev/shm`` must hold the shards' slabs and MemAvailable the ring.
    Then 16 scripted blocks go into both transports at K = 4 and into a
    K = 1 oracle buffer: every row a plane returns must equal the
    oracle's gather at the same global index bit for bit, each IS weight
    the oracle's leaves' weight, and the summed shard mass the oracle's
    tree total to 1e-12 relative, over three draws with priority feedback
    between them.  Then ``train(cfg, device="cuda")`` three times: K = 1
    (the in-process ring, 8 updates), K = 4 over shm (8 updates, ending
    with the drain-then-save per-shard snapshot, read back into a fresh
    plane mass-exact, its bytes and seconds printed) and K = 4 over
    managed loopback sockets (8 updates).  Checked in each run: every
    loss finite and every priority feedback in the plane; ``lstm_infer``
    launched lstm_layers x (actor + evaluator acts) times, the CUDA-core
    kernel never, and none by an update alone; one batch copy to the card
    per staged batch from a plane (one per field from the in-process
    ring); /healthz ok.  In the shard runs: the shards' summed size equal
    to the ingested blocks' transitions; 0 corrupt blocks, respawns,
    dropped blocks and stale feedback, and 0 redraws, sample timeouts and
    garbled responses at the run's end (the stop's cut of the draw in
    flight counts as a sample stop, ROADMAP C 10); over sockets every
    circuit closed and 0 epoch drops; the
    /statusz and /healthz ``replay_shards`` blocks present; each shard's
    process (read from ``/proc``) maps no CUDA driver and no JAX, and
    ``nvidia-smi --query-compute-apps`` lists no shard.  Prints per run
    the update interval p50, env steps/s while filling and training, the
    plane's sample call p50/p99 on the learner's side and batches/s, the
    shards' CPU cores and the peak GB; then each shard run's interval
    against K = 1's, beside the plane's sample call alone (5 back-to-back
    calls after the parity check, no other thread), and the phase's
    seconds;
11. the learner mesh: an NCCL group of world size 1 on a loopback store,
    ``make_mesh`` giving dp = fsdp = tp = 1, on the flagship
    ``Config(game_name="Fake")`` (phase 5's widths, 8 thread actors acting
    through the kernel at B = 8).  First, from one state and one batch,
    one meshed train step (a DTensor state, every leaf on the card)
    against the meshless ``train_step``, bitwise in loss, priorities and
    every new param (cuDNN deterministic for that check only), and a
    meshless checkpoint restored onto the mesh bitwise.  Then
    ``train_sync(cfg, use_mesh=True, device="cuda")`` host-staged on phase
    5's cut ring (16 updates), and ``train(cfg, use_mesh=True)`` with
    ``device_replay``, ``device_ring_layout="dp"`` and host-sampled
    super-steps (``Learner._run_device_multihost``) from this rank's slab
    of the full 5 000-block ring on the card, cut in warm-up and run
    length as phase 10 is (16 updates).  Checked in both: the backend
    ``nccl``, a DTensor state; every loss finite and every priority fed
    back to this rank's buffer; ``lstm_infer`` launched lstm_layers x
    acts, the CUDA-core kernel never, none by an update alone; the target
    synced at step 8 and not 7; one collective gate per update or
    dispatch, one min-density agreement per super-step, and one
    ``group_broadcast`` of the dp group's rows per update or super-step
    (over a group of one: the path a spanning dp group takes); in the ring
    run the slab on the card and ``/healthz`` ok; the train_sync run's
    checkpoint restored without a mesh bitwise.  Prints the update and
    dispatch interval p50 beside phase 5's and phase 7's meshless values,
    a lone meshed update's host and device time and device events beside
    the meshless update's (the DTensor dispatch cost), the NCCL kernels
    in one update with its gate, env steps/s filling and training, peak
    GB and the phase's seconds;
12. the cross-rank draw: phase 11's NCCL group of world size 1.  (a)
    ``pong_config(game_name="Fake")`` with in-graph PER on the mesh and
    ``device_ring_layout="dp"`` (this rank's slab is the whole 15.80 GB
    ring): on a 16-block ring at the preset's slot shapes, one meshed
    super-step (k = 4, through ``parallel/cross_rank.py``) against the
    meshless one from the same ring, state and generator seed — sampled
    indices, losses, the priority slab and every new param bitwise (cuDNN
    deterministic for the check), with the design's collectives; then
    ``train(cfg, use_mesh=True)`` from the full ring, cut as phase 7's
    in-graph run (8 updates).  (b) The README's anakin config on the
    mesh: on a 64-block ring at the full slot shapes, the meshed plane's
    warm-up and one training dispatch against the meshless plane's —
    every payload array, the losses and every param bitwise, with the
    lanes split over dp and with the replicated lane axis forced (the
    fallback when the lanes do not divide over dp or outnumber a slab's
    blocks) — and its snapshot read into a meshless plane bitwise; then
    ``train(cfg,
    use_mesh=True)`` from the full ring, cut as phase 8 (2 dispatches of
    k = 8).  Checked in both runs: the backend ``nccl`` and a DTensor
    state; every loss finite; the target synced at step 8 and not 7; the
    collectives ``CROSS_RANK_CALLS`` counts equal to the design's count
    per inner step and per actor step, and ``group_broadcast`` one per
    inner step in (a) (the leader's rows to its dp group, here of one) and
    none in (b); one result fetch per dispatch (and
    per rollout); ``lstm_infer`` launched layers × acts in (a), 0 in (b),
    the CUDA-core kernel never; in (b) the second dispatch clean under
    ``set_sync_debug_mode("error")``; ``/healthz`` ok.  Prints a lone
    meshed super-step's and anakin dispatch's host time, device time,
    device events and NCCL kernels beside the meshless ones, env steps or
    frames/s while filling and training, peak GB and the phase's seconds;
13. the league: the flagship ``Config(game_name="Fake",
    actor_transport="process", actor_fleets=2, actor_inference="serve",
    population_spec=<the base and the low_resource member preset>,
    league_eval=True, league_eval_episodes=2)`` (phase 5's widths, its 8
    lanes in two member fleets of 4, each under its member's config and
    epsilon ladder, acting through the trainer's service and the kernel
    at B = 8) trained by ``train(cfg, device="cuda")`` from the full
    5 000-block host ring, cut in warm-up as phase 14 (each lane's first
    block), with a checkpoint every 4 updates, until the eval sidecar (a
    CPU subprocess with the card hidden) has scored both members on a
    complete checkpoint and the learner has taken 8 updates, under a
    wall budget that fails the
    phase (the ``reduced:`` line).  Checked: every loss finite; both
    members' blocks in replay and in the population rows (member 1 the
    ``low_resource`` preset); ``league.jsonl`` with >= 1 complete sweep,
    no duplicate (step, member) and the reference's keys; a live
    ``/statusz`` with the 2-row league table, ``/metrics`` with the
    population and league series, ``/healthz`` ok; ``lstm_infer``
    launched layers x (service batches + 1 warm-up) times, the CUDA-core
    kernel never; the served q against the fleets' f32 CPU twin as in
    phase 9; the sidecar's process (``/proc``) maps no CUDA driver and no
    JAX, and ``nvidia-smi --query-compute-apps`` does not list it.  Then
    the chaos drill, ``kill_eval_sidecar:every=1``: the sidecar's respawn
    budget runs out, ``/healthz`` answers HTTP 200 ``degraded`` with
    ``league.failed``, and the learner updates after that.  Prints the
    update interval p50, each member's env steps/s filling and training,
    a sweep's latency from its checkpoint's commit, the sidecar's CPU
    cores, peak GB and the phase's seconds;
14. telemetry and guards: (a) one armed train step (the in-graph
    diagnostic vector) of the flagship net in f32 on the card against f32
    on the CPU — the 12 scalars within ``DIAG_RTOL`` relative, the 16
    bucket counts equal up to the values within ``DIAG_EDGE_EPS`` of an
    edge (their number printed) — then the bf16 step printed, not held;
    (b) the flagship ``Config(game_name="Fake")`` through ``train()`` from
    its full host ring with ``learnhealth_interval=4`` and
    ``trace_steps=8``, 8 thread actors, cut in warm-up and run length (the
    ``reduced:`` line), and a plain run beside it.  Checked: armed diag
    rows every 4th update and zeros elsewhere, one ``learner.
    result_fetch`` an update in both runs, ``/alertz`` live, one trace
    JSON with the trainer track, ``learner.*`` spans and
    ``block.env_steps+cut`` flows, ``lstm_infer`` = layers x acts; prints
    the update interval p50 with and without the diagnostics and in the
    capture window, and a lone step's device time armed and disarmed;
    (c) phase 10's flagship over two shm shards with ``actor_transport=
    "process"``, two fleets through the service: ``GET /tracez?steps=32``
    (200, then 409 while busy) dumps one trace with one track per process
    (fleets and shards in distinct pids), a block flow across fleet,
    trainer and shard, ``serve.batch`` instants and no torn slot, and no
    child holds the card; ``GET /profilez?secs=1`` (200, then 409) writes
    a ``torch.profiler`` trace: a window in which the service served no
    batch (counted where the profiler starts and stops) is taken again,
    at most ``PROFILE_WINDOWS`` in all, each printed with its batches,
    ``lstm_step_wgmma`` events and each fleet's env steps and blocks
    across it; the window with traffic must hold ``lstm_step_wgmma``
    (else its heaviest kernels are printed first; ROADMAP C 21), at most
    lstm layers × its batches + 1 of them and at least ``PROFILE_KEPT`` of
    that less a batch (the profiler drops a graph replay's record now and
    then; the act launches without one are printed);
    (d) phase 8's
    anakin config with ``transfer_guard=True``, cut to two dispatches:
    its windows counted and none tripped; on a 64-block plane at the same
    widths, a guarded dispatch's cost against an unguarded one and an
    undeclared ``.item()`` injected into a dispatch window raising
    ``TransferGuardTripped`` naming it; phase 4's served act under an
    armed guard (``window.serving.act`` counted, no trip); (e) the Pong
    preset's in-graph super-step with ``learnhealth_interval=2`` returning
    (k, 28) rows from its two CUDA graphs (the armed and the disarmed
    inner step), and a meshed world-size-1 step's diag bit for bit its
    meshless one over NCCL.  Prints each part's seconds;
15. the edges, as a user runs them: the flagship ``Config(game_name=
    "Fake")`` at its published widths (nature torso on 21×21×16 frames,
    H = 512, bf16, batch 64, burn-in 40 + learning 40 + forward 5, 8
    actors) through ``python -m r2d2_tpu_torch``, cut in warm-up, run
    length and the end-of-run replay snapshot (the ``reduced:`` line).
    (a) Two ``replay-shard`` servers (``--port 0``, their ports read from
    their start lines), then ``eval --follow`` trailing the run.  (b)
    ``cli.main(["train", ..., "--replay-hosts", ...])`` in this process:
    the printed JSON line with 8 updates, every loss finite, the
    checkpoints at 4 and 8 complete, ``lstm_infer`` = layers × acts on
    the tensor-core route and 0 on the CUDA-core route, each shard's
    printed summary (after SIGTERM) with its ingested blocks equal to
    what the trainer routed to it and 0 corrupt.  (c) The evaluator exits
    0 when its follow timeout runs out, with one record per complete
    checkpoint in step order, the reference's keys, ``curve.json`` equal
    to its printed records, and the plot written or skipped for want of
    matplotlib.  (d) The session load generator's ``main``: 256 sessions
    over 8 workers against an LRU budget of 192, 5 s a cell, both session
    chaos sites armed, in three cells: the reference's ``float32`` and
    ``bfloat16`` params, both computed in bf16, and ``float32_compute``:
    per cell the accounting exact, ``/healthz`` polled and never
    ``failing``, kills that abandoned sessions and a reap, 0 < evictions,
    sessions completed inside every straggler's freeze, and
    ``lstm_infer`` = layers × (batches + warm-up buckets) on the cell's
    route only — ``lstm_step_wgmma`` for the two bf16-compute cells,
    ``lstm_step_f32`` (its cluster launch) for ``float32_compute`` — all
    replayed from the cell's bucket graphs, one capture a bucket; prints
    acts/s and the client p50/p95/p99.  (e) ``serve --port -1 --max-wall-seconds 15`` driven by
    ``run_load`` for 5 s: its summary serves step 8 with the accounting
    exact.  (f) The bench through its isolated driver, cut in steps and
    seconds: the JSON line parses, ``learner_env_frames_per_sec > 0``,
    ``0 < mfu < 1``, every phase reported and none failed; the line is
    printed.  Then every phase's seconds;
16. graftlint, the soak and r2d2_top: (a) ``python -m
    r2d2_tpu_torch.analysis r2d2_tpu_torch --baseline
    GRAFTLINT_TORCH_BASELINE.json`` in a subprocess on this machine, which
    has no JAX: exit 0, and the number of files, findings and
    suppressions printed.  (b) The port's ``tools/soak.py`` ``main`` in
    this process, ``SOAK_MINUTES`` in each drivetrain (host-sampled, then
    ``--ingraph``; cut from the reference's 20-minute default, the
    ``reduced:`` line), at the reference soak's own config (``test_config``
    at H = 128 in float32, 32 actors in two thread fleets, device replay,
    k = 4): each prints ``SOAK PASS`` with no fabric failure, exact
    priority accounting and no decay, and ``lstm_infer`` = layers × acts,
    all on ``lstm_step_f32`` and none on ``lstm_step_wgmma``, replayed
    from the acts' graphs (each act instance captured at least once);
    prints updates/s (mid and last third), env steps and each act
    instance's captures.  (c) The flagship
    ``Config(game_name="Fake")`` at its published widths through
    ``cli.main(["train", ..., "--device", "cuda"])`` with a telemetry port
    and a checkpoint dir, cut as phase 15 but for 128 updates with a
    checkpoint every 64, so that it outlasts the scrape below (the
    ``reduced:`` line): while it trains, ``python -m
    r2d2_tpu_torch.tools.r2d2_top --once --url`` renders a frame whose
    first line is ``format_entry`` of ``/statusz``'s ``last_entry``;
    after it, ``r2d2_top --once <ckpt_dir>`` renders the run log's last
    entry; ``lstm_infer`` = layers × acts on ``lstm_step_wgmma``, 0 on
    the CUDA-core route.  Prints the frames and the phase's seconds;
After each of phases 4–16 the script prints each act instance the phase
built in this process with its traces (on the card an act's CUDA-graph
captures, actor.py:GraphedAct: every act on the card replays a graph, so
each phase's exact launch counts are counts of replayed launches; a CPU
twin's input signatures), and after each of phases 5–16
``RETRACES.counts()`` (each entry point's traces: on the card the
learner steps' and the acts' captures, elsewhere new input signatures),
failing when an entry point went past its budget, as the JAX package's
end-to-end tests assert;

17. one ``{"kernels": [...]}`` JSON line: the tensor-core route
    (``lstm_infer``, bf16 ``wh``) and the f32 route (``lstm_infer_f32``)
    each with its launches, error, times, bound and library call;
18. last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np

H = 512
ACTION_DIM = 9
N_SESSIONS = 64
N_STEPS = 4
GROUPS = (1, 2, 5, 8, 16, 32)
F32_TOL = 1e-5
BF16_TOL = 1e-4
# a whole bf16 unroll compounds: where the kernel's and the plain h differ
# in the last f32 bits across a bf16 rounding boundary, the next step's
# operand differs by one bf16 ulp, and that carries through the recurrence
BF16_FREE_TOL = 1e-2
Q_TOL = 2e-3
# phase 3's shapes: B = 65 crosses a 64-row tile of the tensor-core kernel;
# B = 8 is the flagship actor fleet's lockstep batch (phase 5), B = 64 the
# Pong preset's one 64-lane fleet (phase 7)
CHECK_B = (1, 7, 8, 64, 65, 256)
TIMED = ((1, 1), (1, 8), (1, 32), (1, 64), (1, 256), (85, 64))
# the f32 route's main-path shapes, (T, B, H): the reference soak's config
# (H = 128, 16 lanes a fleet) and the load generator's float32 cell at the
# flagship width over its buckets
F32_TIMED = ((1, 16, 128), (1, 1, 512), (1, 8, 512), (1, 32, 512),
             (1, 64, 512), (1, 256, 512))
# torch.lstm_cell in f32 (TF32 off) against the plain f32 layer step: the
# same f32 arithmetic in another order
F32_LIB_TOL = 1e-4
# the f32 kernel's cluster and units swept at these (B, H)
F32_SWEEP = ((16, 128), (64, 512), (256, 512))
# rounds of the timing, each taking the designs in turns (cut from 4 to
# 2 to make room for phase 15, to 1 for phase 16; the rounds agree to a
# few per cent)
ROUNDS = 1
# the flagship LSTM layer's input: torso features, last action, reward
IN_DIM = H + ACTION_DIM + 1
# the library yardstick runs in bf16 end to end (x @ wi, the gates, h and
# c all rounded to bf16 each step), the plain layer in f32 around a bf16
# product: a loose bound, far below the O(1) of a wrong gate order
LIB_TOL = {1: 6e-2, 85: 2.5e-1}
# the kernels, as the profiler names them: the two routes' (bf16 wh: the
# tensor-core kernel; f32 wh: the f32 kernel) and the first CUDA-core
# design, kept only as a comparison column
WGMMA_KERNEL = "lstm_step_wgmma"
CUDACORE_KERNEL = "lstm_step_f32"
PR1_KERNEL = "lstm_step_cudacore"
# phase 5: the flagship Config(game_name="Fake") cut only in replay size,
# warm-up and run length, so that a target sync and two saves happen
TRAIN_REDUCED = dict(buffer_capacity=40_000, learning_starts=4_000,
                     training_steps=16, target_net_update_interval=8,
                     save_interval=8)
# the fake env's episodes: its default of 32 steps would fill each of the
# 100 ring slots with one 32-step block, 3 200 transitions in all, under
# learning_starts; 1 000-step episodes fill blocks to block_length (400)
FAKE_EPISODE_LEN = 1000
TRAIN_ACTIONS = 4
EVAL_EPISODES = 4
# the learner step in bf16 on the card against float32 on the CPU: bf16
# keeps 8 significant bits, so every dense/conv output and every h the
# scan feeds back is rounded by up to 2^-9 relative; a CPU rehearsal of the
# same comparison (bf16 CPU step vs f32 CPU step, this batch, these
# params) measured 4.8e-4 relative on the loss and 1.9e-3 max-abs on the
# priorities (max 1.17).  The bounds are 20x and 10x that; a wrong gate,
# window index or target is off by O(1)
STEP_LOSS_RTOL = 1e-2
STEP_PRIO_ATOL = 2e-2
STEP_H = 64
# phase 6: impala_deep_config(game_name="Fake") cut only in replay size
# (1 500 000 -> 37 500 transitions, 100 blocks), warm-up and run length;
# the exporter on an ephemeral port and a log entry a second, so that the
# run's /healthz and /metrics can be read while it trains
FABRIC_REDUCED = dict(buffer_capacity=37_500, learning_starts=3_750,
                      training_steps=12, target_net_update_interval=8,
                      save_interval=8, telemetry_port=-1, log_interval=1.0)
FABRIC_RESUME_STEPS = 14
# a wall budget that fails the phase rather than let a stuck fabric hang
FABRIC_WALL_S = 420
FABRIC_SESSIONS = 16
FABRIC_GROUPS = (1, 2, 5, 8)
# phase 7: pong_config(game_name="Fake") with its full ring on the card,
# cut only in warm-up (the first block of each of the 64 actors), run
# length (two runs: in-graph PER, then host-sampled) and the cadences
DEVICE_REDUCED = dict(learning_starts=25_600, target_net_update_interval=8,
                      save_interval=16)
DEVICE_RUNS = ((True, 32), (False, 16))    # (in_graph_per, updates)
DEVICE_WALL_S = 240
# a dispatch's H2D: the (k, B, 6) int32 bundle and (k, B) weights, 7 KB at
# k=4, B=64 — far below one batch's 38 MB of observations
DISPATCH_PUT_MAX_BYTES = 10_000
SAMPLER_W_RTOL = 1e-6
CHECK_RING_BLOCKS = 4
# phase 8: the README's anakin Config(game_name="Fake", actor_transport=
# "anakin", anakin_env="grid") on the card, cut in ring size (ANAKIN_RING),
# warm-up, run length (6 dispatches of k = 8, resumed for 2 more), the
# eval cadence (so that the lane fires) and the target/save intervals; the
# resumed run writes no second snapshot
ANAKIN_REDUCED = dict(learning_starts=4_096, anakin_eval_interval=2,
                      target_net_update_interval=16, save_interval=24)
ANAKIN_STEPS, ANAKIN_RESUME_STEPS = 48, 64
# the runs' ring: 500 blocks of the full slot shapes (cut from 5 000), so
# that the full-state snapshot the resume reads is 1.58 GB, not 15.80 GB
# (its write and read took 22–23 s and 31–36 s)
ANAKIN_RING = 200_000
ANAKIN_WALL_S = 300
ANAKIN_WATCHDOG_S = 420
# the card checks' own ring: 64 blocks at the full slot shapes (NB >= N),
# warmed up by one rollout dispatch (8 lanes x 32 steps); phases 8 and 12
ANAKIN_CHECK_BLOCKS = 64
ANAKIN_CHECK_STARTS = 256
# a fused rollout, bf16 on the card against f32 on the CPU: phase 5's
# limit; a CPU rehearsal of the same comparison (bf16 CPU vs f32 CPU, 32
# steps of 8 lanes, these shapes) measured 1.1e-3 on q, 1.9e-3 on the
# hiddens and 3.3e-4 on the priorities
ANAKIN_CARD_CPU_TOL = 2e-2
ANAKIN_ROLL_STEPS = 32
# phase 9: pong_config(game_name="Fake", actor_transport="process",
# actor_fleets=8) with its full ring on the card, cut as phase 7 is
# (warm-up, run length, cadences); one run per inference mode
PROCESS_FLEETS = 8
PROCESS_STEPS = 16
PROCESS_MODES = ("serve", "local")
PROCESS_WALL_S = 240
# local mode: the most the last dispatch waits for every fleet's report of
# a pump past the first
PUMP_WAIT_S = 30
PROCESS_WATCHDOG_S = 420
# the served act (bf16 on the card, the kernel) against the fleets' f32
# CPU twin on one 64-lane batch: phase 8's card-vs-CPU limit
SERVE_CPU_TOL = 2e-2
# phase 10: the README's flagship Config(game_name="Fake",
# replay_shards=4) with the full 5 000-block host ring, cut only in
# warm-up (16 blocks, 4 a shard) and run length; three runs: the
# in-process ring (K = 1, the same configuration otherwise), four shm
# shards, four managed loopback socket shard servers
REPLAY_SHARDS = 4
REPLAY_REDUCED = dict(learning_starts=6_400, telemetry_port=-1,
                      log_interval=1.0)
REPLAY_RUNS = (("k1", dict(replay_shards=1), 8), ("shm", {}, 8),
               ("socket", dict(replay_transport="socket"), 8))
REPLAY_WALL_S = 300
REPLAY_WATCHDOG_S = 900
# the scripted-block parity check before the runs: 16 blocks (4 a
# shard), 3 draws of the full batch with priority feedback between them;
# the shard masses sum in another order than the oracle's tree, so they
# agree to rounding, not bit for bit
REPLAY_CHECK_BLOCKS = 16
REPLAY_CHECK_DRAWS = 3
REPLAY_ALONE_DRAWS = 5
REPLAY_MASS_RTOL = 1e-12
# phase 11: the learner mesh at world size 1 (the machine has one card)
# on the flagship Config(game_name="Fake"): train_sync host-staged on
# phase 5's cuts (TRAIN_REDUCED), then train() from this rank's dp slab of
# the full ring on the card, cut in warm-up and run length as phase 10 is,
# with host-sampled super-steps (k = 8: two dispatches)
MESH_RING_REDUCED = dict(device_replay=True, device_ring_layout="dp",
                         in_graph_per=False, learning_starts=6_400,
                         training_steps=16, target_net_update_interval=8,
                         save_interval=16, telemetry_port=-1,
                         log_interval=1.0)
MESH_WALL_S = 240
# phase 12: the cross-rank draw at world size 1 over NCCL.  (a) The Pong
# preset with in-graph PER on the mesh, its ring this rank's dp slab (the
# whole ring at dp = 1), cut as phase 7's in-graph run in warm-up and
# cadences, 8 updates; (b) the README's anakin config on the mesh, cut as
# phase 8 in warm-up and eval cadence, 2 dispatches of k = 8, no replay
# snapshot (the plane's snapshot is checked on the 64-block ring)
MESH_IG_REDUCED = dict(device_ring_layout="dp", learning_starts=25_600,
                       training_steps=8, target_net_update_interval=8,
                       save_interval=8, telemetry_port=-1,
                       log_interval=1.0)
MESH_ANAKIN_REDUCED = dict(learning_starts=4_096, anakin_eval_interval=2,
                           training_steps=16, target_net_update_interval=8,
                           save_interval=16, replay_snapshot=False,
                           telemetry_port=-1, log_interval=1.0)
# (a)'s parity ring: 16 scripted blocks at the preset's slot shapes
MESH_CHECK_BLOCKS = 16
MESH_DRAW_WATCHDOG_S = 420
# phase 13: the league — the flagship's 8 lanes in two member fleets (the
# base and the low_resource member preset) acting through the service,
# the eval sidecar scoring both members on every complete checkpoint.
# Cut as phase 14 in warm-up (each lane's first block; 6 400 until PR 14);
# the run trains until the sidecar has scored
# LEAGUE_SWEEPS complete sweep(s) and the learner has taken
# LEAGUE_MIN_UPDATES, and
# the chaos drill until the learner updates after the sidecar's budget
# ran out.  A wall budget fails the phase rather than hang it
LEAGUE_SPEC = ('[{"name": "base"}, {"name": "low", '
               '"preset": "low_resource"}]')
LEAGUE_REDUCED = dict(learning_starts=3_200, save_interval=4,
                      keep_checkpoints=4, league_eval_interval=0.5,
                      telemetry_port=-1, log_interval=0.5)
LEAGUE_MIN_UPDATES = 8
LEAGUE_SWEEPS = 1
# the chaos drill: a shorter warm-up, and this many updates after the
# sidecar's budget ran out
LEAGUE_DRILL_STARTS = 1_600
LEAGUE_DRILL_UPDATES = 4
LEAGUE_WALL_S = 150
LEAGUE_WATCHDOG_S = 420
# the keys of a league.jsonl row (r2d2_tpu/league/eval_service.py:212-220)
LEAGUE_ROW_KEYS = {"kind", "time", "step", "member", "member_name", "game",
                   "episodes", "mean_reward", "env_frames", "minutes",
                   "incarnation"}
# phase 14: telemetry and guards.  (a) one armed step, f32 card vs f32
# CPU: the scalars sum in other orders, nothing else differs; a |TD| or IS
# weight within DIAG_EDGE_EPS of a bucket edge may land in either bucket
DIAG_RTOL = 1e-4
DIAG_EDGE_EPS = 1e-5
# (b) the flagship Config(game_name="Fake") through train() from its full
# host ring, cut in warm-up (8 blocks: each lane's first, 80 sequences for
# a batch of 64) and run length, with the diagnostics every 4th update
# and a boot-time capture of 8 updates; the comparison run has neither
LH_INTERVAL = 4
LH_TRACE_STEPS = 8
LH_REDUCED = dict(learning_starts=3_200, training_steps=16,
                  telemetry_port=-1, log_interval=0.5)
LH_PLAIN_STEPS = 8
LH_WALL_S = 240
LH_COST_ITERS = 2
# (c) the flagship over two shm shards with two fleets through the
# service, cut in warm-up as (b); a capture of 32 updates through
# /tracez, then a 1 s profile through /profilez.  The window must hold a
# block's chain from fleet to shard: 4 updates spanned about a second
# when the update was issued op by op, 32 do since it replays a CUDA
# graph (≈25 ms an update)
CAPTURE_REDUCED = dict(replay_shards=2, actor_transport="process",
                       actor_fleets=2, actor_inference="serve",
                       learning_starts=3_200, telemetry_port=-1,
                       log_interval=0.5)
CAPTURE_STEPS = 32
CAPTURE_ATTEMPTS = 10
PROFILE_SECS = 0.5
# the traces a kernel count of graph replays may take (act_kernel_events)
PROFILE_TRIES = 3
# the share of a /profilez window's act kernel records the profiler must
# keep (it drops a graph replay's record now and then)
PROFILE_KEPT = 0.75
PROFILE_WINDOWS = 3
CAPTURE_WALL_S = 240
# (d) phase 8's anakin config with the guard armed after its warm-up, cut
# as phase 8 in warm-up and to two dispatches; then a 64-block plane at
# the same widths, and phase 4's served act
GUARD_REDUCED = dict(ANAKIN_REDUCED, training_steps=16,
                     replay_snapshot=False)
GUARD_PAIRS = 4
GUARD_SERVE_BATCHES = (1, 5, 32)
GUARD_WALL_S = 240
TELEMETRY_WATCHDOG_S = 600
# phase 15: the edges.  The flagship Config(game_name="Fake") through the
# command line, cut in warm-up as phase 14 (each lane's first block), run
# length (8 updates, a checkpoint every 4) and no replay snapshot at the
# run's end; the evaluator trailing it exits after EDGES_FOLLOW_S without
# a new checkpoint; the load generator EDGES_LOAD_S a cell with both
# session chaos sites armed (each capped: a kill abandons a worker's 32
# sessions); serve EDGES_SERVE_WALL_S, driven EDGES_SERVE_LOAD_S; the
# bench cut in steps and seconds
EDGES_SETS = dict(learning_starts=3_200, save_interval=4,
                  replay_snapshot=False)
EDGES_STEPS = 8
EDGES_WALL_S = 240
EDGES_FOLLOW_S = 20
EDGES_LOAD_S = 5
EDGES_LOAD_CHAOS = ("kill_session_client:every=50,n=6;"
                    "slow_session_client:every=40,dur=1.0,n=4")
EDGES_SERVE_WALL_S = 10
EDGES_SERVE_LOAD_S = 5
EDGES_BENCH = dict(steps=5, warmup=1, system_seconds=4.0)
EDGES_BENCH_WORKERS = 3
EDGES_WATCHDOG_S = 900
# phase 16: graftlint over the checkout; the soak (the reference's own
# config: test_config at H = 128, f32, two thread fleets, device replay,
# k = 4) for SOAK_MINUTES in each drivetrain, cut from its 20-minute
# default; the flagship through the command line, cut as phase 15 (each
# lane's first block, no replay snapshot), a log entry a second so that
# /statusz has one while it runs, and 128 updates with a checkpoint every
# 64, so that the run outlasts r2d2_top's scrape (the graphed acts fill
# the warm-up in under a second).  The soak's stats
# entries come every SOAK_LOG_S (the reference's 10 s), so that its
# decay check still compares medians of two entries a third
SOAK_MINUTES = 0.3
SOAK_LOG_S = 3.0
TOP_SETS = dict(learning_starts=3_200, save_interval=64,
                replay_snapshot=False, log_interval=1.0)
TOP_STEPS = 128
TOP_WALL_S = 240
LINT_WATCHDOG_S = 600
# the meshless timings of phases 5 and 7, set as they run, printed beside
# phase 11's meshed ones
MESHLESS: dict = {}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def env_factory(c, seed: int):
    """The fake env of phases 5-10 (episodes of ``FAKE_EPISODE_LEN``,
    ``TRAIN_ACTIONS`` actions): module-level, so that a spawned fleet
    unpickles it by name."""
    from r2d2_tpu_torch.envs import FakeAtariEnv

    return FakeAtariEnv(obs_shape=c.stored_obs_shape,
                        action_dim=TRAIN_ACTIONS,
                        episode_len=FAKE_EPISODE_LEN, seed=seed)


def fail(msg: str) -> None:
    """Print the failure and exit 1.  The phases' ``finally`` blocks still
    run; the process fleets are terminated first, and a hard exit follows
    after 60 s: at exit, multiprocessing joins each queue's feeder thread,
    and a feeder blocked on a full pipe to a fleet that stopped reading
    held a failed run to its time limit."""
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    for p in multiprocessing.active_children():
        p.terminate()
    timer = threading.Timer(60.0, os._exit, (1,))
    timer.daemon = True
    timer.start()
    sys.exit(1)


def bench_ms(torch, fn, reps: int = 15, iters: int = 20) -> float:
    """Median over ``reps`` of the mean time per call of ``iters``
    back-to-back calls, CUDA events around each run (launch overhead
    included: this is what a caller pays per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return float(np.median(times))


def host_us(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the host's wall clock, in µs per call, to
    issue ``iters`` calls with no synchronisation among them: what the
    host pays per call while the card keeps up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def host_pairs_us(torch, fa, fb, iters: int, pairs: int = 60) -> dict:
    """The host's µs per call to issue ``iters`` calls of ``fa`` and of
    ``fb``, taken in ``pairs`` back-to-back pairs whose order alternates,
    so that the host's load, which drifts over milliseconds, hits both
    alike: the median of each, and the median and quartiles of the
    paired differences ``fa - fb``."""
    for f in (fa, fb):
        f()
    torch.cuda.synchronize()
    ta, tb = [], []
    for i in range(pairs):
        for f, out in ((fa, ta), (fb, tb))[::1 if i % 2 == 0 else -1]:
            t0 = time.perf_counter()
            for _ in range(iters):
                f()
            out.append((time.perf_counter() - t0) / iters * 1e6)
            torch.cuda.synchronize()
    diff = np.asarray(ta) - np.asarray(tb)
    q25, q50, q75 = np.percentile(diff, [25, 50, 75])
    return {"a_us": float(np.median(ta)), "b_us": float(np.median(tb)),
            "diff_median_us": float(q50), "diff_q25_us": float(q25),
            "diff_q75_us": float(q75), "pairs": pairs}


def device_ms(torch, fn, iters: int = 20, name: str = "", tries: int = 3):
    """``(ms, events)`` per call from a ``torch.profiler`` trace: the summed
    time and the number of the device events (kernels, copies) whose name
    contains ``name`` (all of them for ""), over ``iters`` calls.  ms is
    None when the trace holds no device time in any of ``tries`` traces
    (one trace in a few hundred comes back empty on the H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        # device activity only (CUPTI): the CPU ops' records are never
        # read here and cost ~1.7 ms of host time each (6 000 ops: 10.56 s
        # recorded against 0.34 s, the same device time and events)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        total = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in events)
        if total > 0:
            return total / iters / 1e3, sum(e.count for e in events) / iters
    return None, 0.0


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def lstm_bound_ms(T: int, B: int, dtype: str, hidden: int = H) -> tuple:
    """The least time for the unroll's work on an H100: the bytes it must
    move (xp, wh, h0, c0 in; hs, c_T out; each once) over HBM bandwidth,
    against the recurrent product's FLOPs over the dtype's peak (f32: the
    CUDA cores' 67 TFLOP/s), at hidden size ``hidden``."""
    Hd = hidden
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = (T * B * 4 * Hd * 4 + Hd * 4 * Hd * wbytes + 2 * B * Hd * 4
              + T * B * Hd * 4 + B * Hd * 4)
    flops = 2.0 * T * B * Hd * 4 * Hd
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_designs(torch, lstm, randn):
    """Each design against the plain version at T in {1, 85} and every B
    of CHECK_B: step by step from the kernel's own state (each step is the
    plain step up to the order of the f32 sums), the one-launch unroll bit
    for bit against the chain of one-step launches, and the whole unroll.
    Returns {design: (per-step error, whole-unroll error)}."""
    designs = (("tensor_core", lstm.lstm_unroll_cuda, torch.bfloat16),
               ("cuda_core_f32", lstm.lstm_unroll_cuda, torch.float32),
               ("cuda_core_bf16", lstm._lstm_unroll_pr1, torch.bfloat16))
    errs = {name: [0.0, 0.0] for name, _, _ in designs}
    for T in (1, 85):
        for B in CHECK_B:
            xp = randn(T, B, 4 * H, scale=0.5)
            wh = randn(H, 4 * H, scale=H ** -0.5)
            h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
            for name, fn, dt in designs:
                whc = wh.to(dt)
                got = fn(xp, whc, h0, c0)
                want = lstm.lstm_unroll_reference(xp, wh, h0, c0, dt)
                h, c = h0, c0
                step_err = 0.0
                for t in range(T):
                    _, h1, c1 = fn(xp[t:t + 1], whc, h, c)
                    _, h2, c2 = lstm.lstm_unroll_reference(
                        xp[t:t + 1], wh, h, c, dt)
                    step_err = max(step_err, (h1 - h2).abs().max().item(),
                                   (c1 - c2).abs().max().item())
                    if not torch.equal(h1, got[0][t]):
                        fail(f"{name} T={T} B={B}: the unroll's step {t} "
                             "differs from the one-step launch")
                    h, c = h1, c1
                torch.cuda.synchronize()
                if not torch.equal(c, got[2]):
                    fail(f"{name} T={T} B={B}: c_T differs from the chain")
                if not all(torch.isfinite(g).all().item() for g in got):
                    fail(f"{name} output not finite at T={T} B={B}")
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                tol = F32_TOL if dt == torch.float32 else BF16_TOL
                free_tol = F32_TOL if dt == torch.float32 else BF16_FREE_TOL
                print(f"lstm_infer {name} vs plain T={T} B={B}: per-step "
                      f"max_abs_err={step_err:.3e} (tol {tol:.0e}), whole "
                      f"unroll {err:.3e} (tol {free_tol:.0e})", flush=True)
                if step_err > tol or err > free_tol:
                    fail(f"lstm_infer {name} disagrees with its plain "
                         f"version at T={T} B={B}")
                errs[name][0] = max(errs[name][0], step_err)
                errs[name][1] = max(errs[name][1], err)
    return errs


def layer_inputs(torch, randn, T: int, B: int):
    """One LSTM layer of the flagship net at random weights: x (T, B, IN)
    in bf16, wi (IN, 4H), wh (H, 4H), b (4H,), h0, c0 (B, H)."""
    x = randn(T, B, IN_DIM, scale=0.5).to(torch.bfloat16)
    wi = randn(IN_DIM, 4 * H, scale=IN_DIM ** -0.5)
    wh = randn(H, 4 * H, scale=H ** -0.5)
    b = randn(4 * H, scale=0.1)
    return x, wi, wh, b, randn(B, H, scale=0.5), randn(B, H, scale=0.5)


def library_step(torch, T, x, wi, wh, b, h0, c0):
    """The yardstick: one PyTorch call for the layer's T steps in bf16 —
    ``torch.lstm_cell`` (what ``nn.LSTMCell`` calls) at T=1, cuDNN through
    ``nn.LSTM`` at T>1 — with the layer's weights (gate order i, f, g, o in
    both).  Returns the call, which gives (h_T, c_T)."""
    bf = torch.bfloat16
    w_ih, w_hh = wi.t().contiguous().to(bf), wh.t().contiguous().to(bf)
    b_ih, b_hh = b.to(bf), torch.zeros_like(b, dtype=bf)
    h16, c16 = h0.to(bf), c0.to(bf)
    if T == 1:
        def call():
            return torch.lstm_cell(x[0], (h16, c16), w_ih, w_hh, b_ih, b_hh)
    else:
        mod = torch.nn.LSTM(IN_DIM, H).to(device="cuda", dtype=bf)
        with torch.no_grad():
            mod.weight_ih_l0.copy_(w_ih)
            mod.weight_hh_l0.copy_(w_hh)
            mod.bias_ih_l0.copy_(b_ih)
            mod.bias_hh_l0.copy_(b_hh)
        mod.flatten_parameters()   # one weight buffer, as cuDNN wants it
        hx = (h16[None], c16[None])

        def call():
            _, (h, c) = mod(x, hx)
            return h[0], c[0]
    return call


def phase_kernel(torch, lstm):
    """Phase 3: every design against the plain version, the tile sweep,
    and the timings of the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    print(f"reduced: timing rounds {ROUNDS}", flush=True)
    errs = check_designs(torch, lstm, randn)

    # the tensor-core kernel at each tile width n, device time
    sweep = {}
    for B in (64, 256):
        xp = randn(1, B, 4 * H, scale=0.5)
        wh = randn(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
        h0, c0 = randn(B, H, scale=0.5), randn(B, H, scale=0.5)
        base = lstm.launch_plan(B, H)
        for n in lstm.UNITS_PER_GATE:
            plan = lstm.plan_for(n, B, H)
            dev, _ = device_ms(torch, lambda: lstm._launch_wgmma(
                xp, wh, h0, c0, plan), name=WGMMA_KERNEL)
            sweep[f"B={B} n={n}"] = dev
        print(f"tile sweep (1, {B}) bf16, device ms per call: " + ", ".join(
            f"n={n} {fmt(sweep[f'B={B} n={n}'])}"
            for n in lstm.UNITS_PER_GATE)
            + f"; launch_plan picks n={base.n}", flush=True)

    # the f32 kernel at f32_plan's tile with the cluster and then the
    # units a block varied, device time
    for B, Hd in F32_SWEEP:
        xp = randn(1, B, 4 * Hd, scale=0.5)
        wh = randn(Hd, 4 * Hd, scale=Hd ** -0.5)
        h0, c0 = randn(B, Hd, scale=0.5), randn(B, Hd, scale=0.5)
        base = lstm.f32_plan(B, Hd)
        plans = {f"cluster={c}": base._replace(cluster=c)
                 for c in (1, 2, 4, 8) if base.grid[0] % c == 0}
        for n in lstm.F32_UNITS:
            try:
                p = lstm.f32_plan_for(n, base.rows, B, Hd)
            except ValueError:
                continue
            plans[f"n={n}"] = p._replace(cluster=base.cluster if
                                         p.grid[0] % base.cluster == 0
                                         else 1)
        got = {}
        for k, p in plans.items():
            got[k], _ = device_ms(torch, lambda: lstm._lstm_unroll_cudacore(
                xp, wh, h0, c0, p), name=CUDACORE_KERNEL)
            sweep[f"f32 B={B} H={Hd} {k}"] = got[k]
        print(f"f32 tile sweep (1, {B}) H={Hd}, device ms per call, at "
              f"f32_plan's n={base.n} rows={base.rows} rr={base.rr} "
              f"ks={base.ks} cluster={base.cluster} with one parameter "
              "varied: " + ", ".join(f"{k} {fmt(v)}" for k, v in got.items()),
              flush=True)

    timings = {}
    with torch.inference_mode():
        for T, B in TIMED:
            timings[(T, B)] = time_shape(torch, lstm, randn, T, B)
        for T, B, Hd in F32_TIMED:
            timings[("f32", T, B, Hd)] = time_f32_shape(torch, lstm, randn,
                                                        T, B, Hd)
    return errs, sweep, timings


def time_f32_shape(torch, lstm, randn, T: int, B: int, Hd: int) -> dict:
    """One f32 shape of the f32 route at hidden size ``Hd``, each run the
    mean over ``ROUNDS`` rounds that take the runs in turns: time per
    call with the launch (CUDA events) and device time (profiler) of the
    route's kernel (``lstm_step_f32``), the first CUDA-core design in
    f32, the plain version, the layer step (x @ wi + b, then the kernel)
    and ``torch.lstm_cell`` in f32 (TF32 off) for the same layer step;
    the bound.  The route and the first design are held to the plain
    version (1e-5) and the library call to the plain layer step
    (``F32_LIB_TOL``) on the inputs they are timed on."""
    in_dim = Hd + ACTION_DIM + 1
    x = randn(T, B, in_dim, scale=0.5)
    wi = randn(in_dim, 4 * Hd, scale=in_dim ** -0.5)
    wh = randn(Hd, 4 * Hd, scale=Hd ** -0.5)
    b = randn(4 * Hd, scale=0.1)
    h0, c0 = randn(B, Hd, scale=0.5), randn(B, Hd, scale=0.5)
    xp = (x @ wi + b).contiguous()
    w_ih, w_hh = wi.t().contiguous(), wh.t().contiguous()
    zero = torch.zeros_like(b)

    def library():
        return torch.lstm_cell(x[0], (h0, c0), w_ih, w_hh, b, zero)

    _, ph, pc = lstm.lstm_unroll_reference(xp, wh, h0, c0, torch.float32)
    errs = {}
    for k, fn in (("route", lstm.lstm_unroll_cuda),
                  ("pr1", lstm._lstm_unroll_pr1)):
        _, kh, kc = fn(xp, wh, h0, c0)
        errs[k] = max((kh - ph).abs().max().item(),
                      (kc - pc).abs().max().item())
    lh, lc = library()
    errs["library"] = max((lh - ph).abs().max().item(),
                          (lc - pc).abs().max().item())
    if errs["route"] > F32_TOL or errs["pr1"] > F32_TOL or not (
            errs["library"] <= F32_LIB_TOL):
        fail(f"f32 route at ({T}, {B}) H={Hd}: vs plain {errs}")
    runs = {
        "": (lambda: lstm.lstm_unroll_cuda(xp, wh, h0, c0),
             CUDACORE_KERNEL),
        "pr1_": (lambda: lstm._lstm_unroll_pr1(xp, wh, h0, c0), PR1_KERNEL),
        "plain_": (lambda: lstm.lstm_unroll_reference(
            xp, wh, h0, c0, torch.float32), ""),
        "layer_step_": (lambda: lstm.lstm_unroll_cuda(
            (x @ wi + b).contiguous(), wh, h0, c0), ""),
        "library_": (library, ""),
    }
    got = {f"{k}{m}": [] for k in runs for m in ("ms", "device_ms")}
    for r in range(ROUNDS):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            fn, name = runs[k]
            d, _ = device_ms(torch, fn, iters=20, name=name)
            if d is None:
                fail(f"no f32 device time for {k or 'kernel'} at ({T}, {B})"
                     f" H={Hd}")
            got[f"{k}device_ms"].append(d)
            got[f"{k}ms"].append(bench_ms(torch, fn, reps=5, iters=20))
    out = {k: float(np.mean(v)) for k, v in got.items()}
    bound, by = lstm_bound_ms(T, B, "float32", Hd)
    plan = lstm.f32_plan(B, Hd)
    out.update(max_abs_err=errs["route"], pr1_max_abs_err=errs["pr1"],
               library_max_abs_err=errs["library"], bound_ms=bound,
               bound_by=by, share_of_bound=bound / out["device_ms"],
               pr1_share_of_bound=bound / out["pr1_device_ms"],
               plan=plan._asdict())
    print(f"lstm_infer f32 time ({T}, {B}) H={Hd}, mean of {ROUNDS} rounds, "
          f"per call / device: f32 kernel (n={plan.n}, rows={plan.rows}, "
          f"rr={plan.rr}, cluster={plan.cluster}, grid={plan.grid}) "
          f"{out['ms']:.4f} / {out['device_ms']:.4f} ms; the first design "
          f"{out['pr1_ms']:.4f} / {out['pr1_device_ms']:.4f} ms; plain "
          f"{out['plain_ms']:.4f} / {out['plain_device_ms']:.4f} ms; layer "
          f"step (x @ wi + b, kernel) {out['layer_step_ms']:.4f} / "
          f"{out['layer_step_device_ms']:.4f} ms against torch.lstm_cell "
          f"f32 {out['library_ms']:.4f} / {out['library_device_ms']:.4f} ms;"
          f" bound {bound:.5f} ms ({by}), share of bound "
          f"{out['share_of_bound']:.1%} (first design "
          f"{out['pr1_share_of_bound']:.1%}); vs plain: kernel "
          f"{errs['route']:.2e}, first design {errs['pr1']:.2e}, "
          f"lstm_cell {errs['library']:.2e}", flush=True)
    return out


def time_shape(torch, lstm, randn, T: int, B: int) -> dict:
    """One shape's numbers, bf16 wh, each the mean over ``ROUNDS`` rounds
    that take the runs in turns: time per call with the launch (CUDA
    events), device time (profiler) and host µs to issue a call, of the
    tensor-core kernel, the CUDA-core kernel, the plain version, the layer
    step (x @ wi + b, then the kernel) and the library call for the same
    layer step; the bound.  Keys: ``<run>_ms``, ``<run>_device_ms``,
    ``<run>_host_us`` (the tensor-core kernel's without the prefix), and
    each round's numbers of the two kernels under ``rounds``."""
    x, wi, wh, b, h0, c0 = layer_inputs(torch, randn, T, B)
    wi16, whb = wi.to(torch.bfloat16), wh.to(torch.bfloat16)
    xp = ((x @ wi16).float() + b).contiguous()
    lib = library_step(torch, T, x, wi, wh, b, h0, c0)

    # the yardstick computes the same function: held to the plain layer
    _, ph, pc = lstm.lstm_unroll_reference(xp, wh, h0, c0, torch.bfloat16)
    lh, lc = lib()
    lib_err = max((lh.float() - ph).abs().max().item(),
                  (lc.float() - pc).abs().max().item())
    if not lib_err <= LIB_TOL[T]:
        fail(f"the library yardstick at ({T}, {B}) is {lib_err:.3e} from "
             f"the plain layer (tol {LIB_TOL[T]:.0e})")

    runs = {
        "": (lambda: lstm.lstm_unroll_cuda(xp, whb, h0, c0), WGMMA_KERNEL),
        "cudacore_": (lambda: lstm._lstm_unroll_pr1(xp, whb, h0, c0),
                      PR1_KERNEL),
        "plain_": (lambda: lstm.lstm_unroll_reference(
            xp, wh, h0, c0, torch.bfloat16), ""),
        "layer_step_": (lambda: lstm.lstm_unroll_cuda(
            ((x @ wi16).float() + b).contiguous(), whb, h0, c0), ""),
        "library_": (lib, ""),
    }
    # in turns, forward then back, so a drift of the card's clock or of
    # the host's load hits every run alike
    got = {f"{k}{m}": [] for k in runs for m in ("ms", "device_ms",
                                                 "host_us")}
    iters = 5 if T > 1 else 20
    for r in range(ROUNDS):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            fn, name = runs[k]
            d, _ = device_ms(torch, fn, iters=iters, name=name)
            if d is None:
                fail(f"no device time for {k or 'kernel'} at ({T}, {B})")
            got[f"{k}device_ms"].append(d)
            got[f"{k}ms"].append(bench_ms(torch, fn, reps=5, iters=iters))
            got[f"{k}host_us"].append(host_us(torch, fn, iters=iters))
    out = {k: float(np.mean(v)) for k, v in got.items()}
    out["rounds"] = {k: got[k] for k in ("ms", "cudacore_ms", "host_us",
                                         "cudacore_host_us")}
    # the host's cost of the two kernels' wrappers, in alternating pairs:
    # a = the tensor-core kernel, b = the CUDA-core kernel
    pair = host_pairs_us(torch, runs[""][0], runs["cudacore_"][0], iters)
    out["host_pairs_us"] = pair
    # the same for the bare C entry points (the launches and what the C
    # side does around them, without the Python wrappers)
    lib = lstm._library()
    plan = lstm.launch_plan(B, H)
    hs, c = torch.empty(T, B, H, device="cuda"), c0.clone()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (xp, whb, h0, c, hs)]
    bare = host_pairs_us(
        torch, lambda: lib.lstm_infer_wgmma(*ptrs, T, B, H, plan.n,
                                            *plan.grid, stream),
        lambda: lib.lstm_infer_cudacore(ptrs[0], ptrs[1], 1, *ptrs[2:], T,
                                        B, H, stream), iters)
    out["c_entry_pairs_us"] = bare
    bound, by = lstm_bound_ms(T, B, "bfloat16")
    out.update(library_max_abs_err=lib_err, bound_ms=bound, bound_by=by,
               share_of_bound=bound / out["device_ms"],
               cudacore_share_of_bound=bound / out["cudacore_device_ms"])
    lib_name = "lstm_cell" if T == 1 else "cuDNN nn.LSTM"
    print(f"lstm_infer time ({T}, {B}) bf16 H={H}, mean of {ROUNDS} rounds, "
          "per call / device / host issue: tensor-core kernel "
          f"{out['ms']:.4f} / {out['device_ms']:.4f} ms / "
          f"{out['host_us']:.1f} us; CUDA-core kernel (the first design) "
          f"{out['cudacore_ms']:.4f} / {out['cudacore_device_ms']:.4f} ms / "
          f"{out['cudacore_host_us']:.1f} us; plain {out['plain_ms']:.4f} / "
          f"{out['plain_device_ms']:.4f} ms; layer step (x @ wi + b, "
          f"kernel) {out['layer_step_ms']:.4f} / "
          f"{out['layer_step_device_ms']:.4f} ms against library "
          f"({lib_name}) {out['library_ms']:.4f} / "
          f"{out['library_device_ms']:.4f} ms, library vs plain "
          f"{lib_err:.3e} (tol {LIB_TOL[T]:.0e}); bound {bound:.4f} ms "
          f"({by}), share of bound {out['share_of_bound']:.1%} (CUDA-core "
          f"kernel {out['cudacore_share_of_bound']:.1%})", flush=True)
    print(f"lstm_infer host us per call ({T}, {B}), {pair['pairs']} "
          f"alternating pairs: tensor-core {pair['a_us']:.1f}, CUDA-core "
          f"{pair['b_us']:.1f}, paired difference median "
          f"{pair['diff_median_us']:+.1f} (quartiles "
          f"{pair['diff_q25_us']:+.1f}, {pair['diff_q75_us']:+.1f}); bare C "
          f"entry points: tensor-core {bare['a_us']:.1f}, CUDA-core "
          f"{bare['b_us']:.1f}, difference {bare['diff_median_us']:+.1f} "
          f"({bare['diff_q25_us']:+.1f}, {bare['diff_q75_us']:+.1f})",
          flush=True)
    print(f"lstm_infer rounds ({T}, {B}): per call ms tensor-core "
          f"{fmt_list(got['ms'])} CUDA-core {fmt_list(got['cudacore_ms'])}; "
          f"host us tensor-core {fmt_list(got['host_us'], 1)} CUDA-core "
          f"{fmt_list(got['cudacore_host_us'], 1)}", flush=True)
    return out


def fmt_list(xs, digits: int = 4) -> str:
    return "[" + ", ".join(f"{x:.{digits}f}" for x in xs) + "]"


def session_inputs(obs_shape, seed: int = 1, n_sessions: int = N_SESSIONS):
    """The traffic: per (session, step) an observation and a reward, made
    from ``seed`` — the client process and the checks rebuild the same."""
    rng = np.random.default_rng(seed)
    sids = list(range(100, 100 + n_sessions))
    obs = {(s, t): rng.integers(0, 256, obs_shape, np.uint8)
           for s in sids for t in range(N_STEPS)}
    reward = {(s, t): float(rng.normal()) for s in sids
              for t in range(N_STEPS)}
    return sids, obs, reward


def client_setup(kind: str):
    """(config, action dim, sessions, groups) of a client: ``flagship``
    for phase 4's served net, ``impala`` for phase 6's checkpoint."""
    from r2d2_tpu_torch.config import Config, impala_deep_config

    if kind == "flagship":
        return Config(serve_max_batch=256), ACTION_DIM, N_SESSIONS, GROUPS
    return (impala_deep_config(game_name="Fake").replace(**FABRIC_REDUCED),
            TRAIN_ACTIONS, FABRIC_SESSIONS, FABRIC_GROUPS)


def client_process(host: str, port: int, out, kind: str = "flagship"
                   ) -> None:
    """The external client (its own process, as a frontend would be):
    opens the sessions, sends the steps in groups, feeds each session its
    greedy action back, and puts ``("ok", replies, latencies)`` or
    ``("error", message)`` on ``out``."""
    from r2d2_tpu_torch.serving.client import SessionClient
    from r2d2_tpu_torch.serving.wire import STATUS_OK

    cfg, action_dim, n_sessions, groups = client_setup(kind)
    sids, obs, reward = session_inputs(cfg.stored_obs_shape,
                                       n_sessions=n_sessions)
    replies, lat = {}, []
    try:
        client = SessionClient(cfg, action_dim, host, port, timeout=60.0)
    except OSError as e:
        out.put(("error", f"connect failed: {e}"))
        return
    try:
        for s in sids:
            if client.open_session(s) != STATUS_OK:
                out.put(("error", f"open_session({s}) refused"))
                return
        la = {s: np.zeros(action_dim, np.float32) for s in sids}
        for t in range(N_STEPS):
            lo = 0
            for g in groups:
                group = sids[lo:lo + g]
                lo += g
                sent = {s: (client.send_act(s, obs[(s, t)], la[s],
                                            reward[(s, t)], reset=t == 0),
                            time.perf_counter()) for s in group}
                for s in group:
                    status, q = client.recv(s, sent[s][0])
                    lat.append(time.perf_counter() - sent[s][1])
                    if status != STATUS_OK or q is None:
                        out.put(("error", f"session {s} step {t}: status "
                                          f"{status}"))
                        return
                    replies[(s, t)] = q
                    la[s] = np.zeros(action_dim, np.float32)
                    la[s][int(np.argmax(q))] = 1.0
        for s in sids:
            client.close_session(s)
    except Exception as e:  # reported to the parent, which fails the run
        out.put(("error", f"client: {type(e).__name__}: {e}"))
        return
    finally:
        client.close()
    out.put(("ok", replies, lat))


def phase_serving(torch, card: str):
    """Phase 4: the flagship net served over the session tier."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.serving import SessionServer

    cfg = Config(serve_max_batch=256)
    if (cfg.torso, cfg.obs_shape, cfg.stored_obs_shape, cfg.hidden_dim,
            cfg.compute_dtype) != ("nature", (84, 84, 1), (21, 21, 16), H,
                                   "bfloat16"):
        fail(f"Config() is not the flagship configuration: {cfg}")
    net = create_network(cfg, ACTION_DIM, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    if net.lstm_layers[0].impl != "pallas":
        fail("the serving network did not resolve the fused LSTM kernel")
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}

    server = SessionServer(cfg, ACTION_DIM, host="127.0.0.1")
    if server.batcher.device.type != "cuda":
        fail(f"the server acts on {server.batcher.device}, not the card")
    # cuDNN deterministic through the phase, so that the bucket graphs
    # captured here and the eager act they are held to below pick the
    # same convolution algorithms
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return serve_flagship(torch, card, cfg, params, server)
    finally:
        torch.backends.cudnn.deterministic = det


def serve_flagship(torch, card: str, cfg, params, server) -> int:
    """Phase 4's traffic, checks and timings (the docstring's phase 4)."""
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    server.publish_params(params)
    graphed = server.batcher._act
    t0 = time.perf_counter()
    server.warmup()
    torch.cuda.synchronize()
    buckets = server.batcher.buckets
    print(f"serving warmup ({len(buckets)} buckets {buckets}, "
          f"{graphed.graphs.captures} CUDA-graph captures of serving.act): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if graphed.graphs.captures != len(buckets) or len(buckets) != 9:
        fail(f"serving.act captured {graphed.graphs.captures} graphs for "
             f"{len(buckets)} buckets")

    # record every served batch (inputs and outputs, host copies) to hold
    # it against the plain-LSTM act afterwards
    served = []
    act = server.batcher.act

    def recording_act(obs, last_action, last_reward, hidden):
        q, new_hidden = act(obs, last_action, last_reward, hidden)
        served.append(tuple(np.array(a) for a in (
            obs, last_action, last_reward, hidden, q, new_hidden)))
        return q, new_hidden

    server.batcher.act = recording_act
    _, obs, _ = session_inputs(cfg.stored_obs_shape)

    KERNEL_LAUNCHES.reset()
    server.start()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    child = ctx.Process(target=client_process,
                        args=(server.host, server.port, out))
    child.start()
    try:
        result = out.get(timeout=600)
    except queue.Empty:
        result = ("error", "the client process sent nothing in 600 s")
    finally:
        child.join(timeout=30)
        if child.is_alive():
            child.terminate()
            child.join(timeout=10)
        server.stop()
        server.close()
    if result[0] != "ok":
        fail(result[1])
    _, replies, lat = result
    if len(replies) != N_SESSIONS * N_STEPS:
        fail(f"{len(replies)} replies, expected {N_SESSIONS * N_STEPS}")
    for (s, t), q in replies.items():
        if q.shape != (ACTION_DIM,) or not np.isfinite(q).all():
            fail(f"session {s} step {t}: bad q {q}")
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old_launches = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    stats = server.stats()
    counts = server.store.counts()
    if counts["admitted"] != (counts["completed"] + counts["reaped"]
                              + counts["evicted"] + counts["live"]):
        fail(f"store accounting broken: {counts}")
    if stats["requests"] != N_SESSIONS * N_STEPS or stats["act_failures"]:
        fail(f"server stats: {stats}")
    if (launches != stats["batches"] * cfg.lstm_layers or launches < 1
            or old_launches):
        fail(f"the tensor-core lstm_infer kernel launched {launches} times "
             f"(the CUDA-core one {old_launches}) for {stats['batches']} "
             "batches on the main path")

    # every batch row is one session step: its hidden is the session's
    # previous output (zeros after the step-0 reset) and its q went out
    key = {obs[k].tobytes(): k for k in obs}
    out_hidden = {}
    rows = {}
    for b_obs, _, _, b_hid, b_q, b_new in served:
        for i in range(len(b_obs)):
            k = key[b_obs[i].tobytes()]
            rows[k] = (b_hid[i], b_q[i])
            out_hidden[k] = b_new[i]
    if len(rows) != N_SESSIONS * N_STEPS:
        fail(f"{len(rows)} session steps were batched, expected "
             f"{N_SESSIONS * N_STEPS}")
    for (s, t), (hid_in, q) in rows.items():
        want = (np.zeros_like(hid_in) if t == 0 else out_hidden[(s, t - 1)])
        if not np.array_equal(hid_in, want):
            fail(f"session {s} step {t} was served with the wrong hidden")
        if not np.array_equal(q, replies[(s, t)]):
            fail(f"session {s} step {t}: the reply is not the batch's q")

    # the same batches through the plain LSTM act and the plain head
    err = served_vs_plain(torch, cfg, ACTION_DIM, served, params,
                          server.batcher.bucket)
    sizes = sorted(len(b[0]) for b in served)
    spans = server.tracer.snapshot()
    print("serving spans (ms): " + ", ".join(
        f"{k[5:]}={v:.3f}" for k, v in sorted(spans.items())
        if k.endswith(("p50_ms", "p99_ms", "mean_ms"))), flush=True)
    print(f"serving: {stats['batches']} batches, sizes {sizes}; "
          f"lstm_infer launches {launches}; new hidden vs plain-LSTM act "
          f"max_abs_err {err['hidden']:.3e} (tol {BF16_TOL:.0e}), q vs the "
          f"plain head of the served hidden {err['q']:.3e} (tol "
          f"{Q_TOL:.0e}); q vs plain-LSTM act end to end {err['act']:.3e} "
          f"({err['act_ulps']:.2f} bf16 ulps); store {counts}", flush=True)
    if err["q"] > Q_TOL or err["hidden"] > BF16_TOL:
        fail("served q or hidden disagrees with the plain version")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    print(f"serving act latency (client round trip, {len(lat)} requests) "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms on {card}", flush=True)

    # each bucket's graph against the eager act on the published params
    # and the same padded rows, bit for bit; no capture after the warm-up
    rng = np.random.default_rng(2)
    published = server.batcher._params
    for n in buckets:
        x = (torch.from_numpy(rng.integers(
                 0, 256, (n, *cfg.stored_obs_shape), np.uint8)).to("cuda"),
             torch.from_numpy(np.eye(ACTION_DIM, dtype=np.float32)[
                 rng.integers(ACTION_DIM, size=n)]).to("cuda"),
             torch.from_numpy(rng.normal(size=n).astype(np.float32)
                              ).to("cuda"),
             torch.from_numpy((rng.normal(size=(
                 n, 2, cfg.lstm_layers, H)) * 0.3).astype(np.float32)
                 ).to("cuda"))
        got = [t.clone() for t in graphed(published, *x)]
        want = eager_act(torch, server.batcher.net, published, x)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"serving.act's graph at bucket {n} is not the eager act "
                 "bit for bit")
    if graphed.graphs.captures != len(buckets) or graphed.adoptions != 1:
        fail(f"serving.act: {graphed.graphs.captures} captures and "
             f"{graphed.adoptions} adoptions after the traffic")
    print(f"serving.act graphs on {card}: each of the {len(buckets)} "
          f"buckets {buckets} bit for bit the eager act (q and new hidden, "
          f"cuDNN deterministic), {graphed.graphs.captures} captures, "
          f"{graphed.adoptions} param adoption", flush=True)

    # where one batch's time goes, the traffic gone: the host's wall clock
    # per batcher.act against the device time in it, the act replayed
    # from its graph against the same act issued eagerly (the batcher's
    # put and fetch around both)
    def eager_batch(rows):
        def run():
            server.batcher._act = lambda p, *x: eager_act(
                torch, server.batcher.net, p, x)
            try:
                return act(*rows)
            finally:
                server.batcher._act = graphed
        return run

    for n in (1, 32, 256):
        rows = (rng.integers(0, 256, (n, *cfg.stored_obs_shape), np.uint8),
                np.zeros((n, ACTION_DIM), np.float32),
                np.zeros(n, np.float32),
                np.zeros((n, 2, cfg.lstm_layers, H), np.float32))
        g, e = graph_vs_eager(torch, lambda: act(*rows), eager_batch(rows),
                              iters=20)
        events, tries = act_kernel_events(torch, lambda: act(*rows), 20,
                                          cfg.lstm_layers)
        kern = [(ms, c) for k, ms, c in events or () if WGMMA_KERNEL in k]
        n_old = sum(c for k, _, c in events or () if CUDACORE_KERNEL in k)
        if not kern or kern[0][1] != cfg.lstm_layers or n_old:
            fail(f"the served act at n={n} ran {kern} tensor-core (ms, "
                 f"count a call) and {n_old} CUDA-core LSTM kernels, in "
                 f"{tries} trace(s)")
        print(f"serving act alone n={n} on {card}: " + fmt_graph(g, e)
              + f"; lstm_infer tensor-core kernel {fmt(kern[0][0])} a batch"
              + (f" ({tries} traces)" if tries > 1 else ""), flush=True)
    if graphed.graphs.captures != len(buckets):
        fail(f"serving.act captured again: {graphed.graphs.captures}")
    return launches


def eager_act(torch, net, params, x):
    """The act issued eagerly, op by op: what a graphed act replays."""
    with torch.inference_mode():
        return torch.func.functional_call(net, params, tuple(x))


def profile_events(torch, fn, iters: int, tries: int = 3):
    """Device-side events of ``iters`` calls of ``fn`` under
    ``torch.profiler``: ``[(name, ms per call, count per call)]``, longest
    first, or None when no trace in ``tries`` holds device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        # device activity only, as device_ms
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, getattr(e, "self_device_time_total", 0.0)
                   / iters / 1e3, e.count / iters)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(ms for _, ms, _ in events) > 0:
            return sorted(events, key=lambda e: -e[1])
    return None


def act_kernel_events(torch, fn, iters: int, layers: int):
    """``profile_events`` of ``iters`` calls of an act ``fn`` that launches
    ``layers`` ``WGMMA_KERNEL`` a call, and the traces taken: the profiler
    drops a graph replay's kernel record now and then (a served act
    counted 0.95 a call, 19 replays of 20, twice on the H100), so a trace
    that counts fewer is taken again, at most ``PROFILE_TRIES``.  The
    caller holds the count of the last trace."""
    for tries in range(1, PROFILE_TRIES + 1):
        events = profile_events(torch, fn, iters)
        if events is not None and any(
                WGMMA_KERNEL in k and n == layers for k, _, n in events):
            break
    return events, tries


def short_kernel_name(name: str, width: int = 110) -> str:
    """A device kernel's symbol without the namespaces that every ATen
    kernel shares, so the functor (add, sigmoid, gemm ...) shows."""
    for prefix in ("void ", "at::native::", "(anonymous namespace)::",
                   "c10::"):
        name = name.replace(prefix, "")
    return name[:width]


def wall_ms(torch, fn, iters: int) -> float:
    """Host wall clock per call of ``iters`` calls, synchronised at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def step_batch(cfg, seed: int = 0) -> dict:
    """One learner batch with ragged windows, made from ``seed``."""
    rng = np.random.default_rng(seed)
    B, T, L, n = (cfg.batch_size, cfg.seq_len, cfg.learning_steps,
                  cfg.forward_steps)
    learning = rng.integers(1, L + 1, B).astype(np.int32)
    burn_in = rng.integers(0, cfg.burn_in_steps + 1, B).astype(np.int32)
    forward = np.where(learning == L, rng.integers(1, n + 1, B),
                       1).astype(np.int32)
    return dict(
        obs=rng.integers(0, 256, (B, T, *cfg.stored_obs_shape), np.uint8),
        last_action=np.eye(TRAIN_ACTIONS, dtype=np.float32)[
            rng.integers(TRAIN_ACTIONS, size=(B, T))],
        last_reward=rng.normal(size=(B, T)).astype(np.float32),
        hidden=(rng.normal(size=(B, 2, cfg.lstm_layers, cfg.hidden_dim))
                * 0.5).astype(np.float32),
        action=rng.integers(0, TRAIN_ACTIONS, (B, L)).astype(np.int32),
        n_step_reward=rng.normal(size=(B, L)).astype(np.float32),
        n_step_gamma=np.full((B, L), cfg.gamma ** n, np.float32),
        burn_in=burn_in, learning=learning, forward=forward,
        is_weights=rng.uniform(0.2, 1.0, B).astype(np.float32))


def learner_step_card_vs_cpu(torch) -> dict:
    """One learner step at a reduced width (mlp torso, H=64) from the same
    params on the same batch: bf16 on the card against float32 on the
    CPU, which is the reference here (the card has no JAX)."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network

    out = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        cfg = Config(game_name="Fake", torso="mlp", hidden_dim=STEP_H,
                     compute_dtype=dtype)
        net = create_network(cfg, TRAIN_ACTIONS, device=dev,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(cfg, net.state_dict())
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in step_batch(cfg).items()}
        _, loss, prios = make_train_step(cfg, net)(state, batch)
        out[dev] = (loss.item(), prios.cpu().numpy())
    (lc, pc), (lf, pf) = out["cuda"], out["cpu"]
    loss_rel = abs(lc - lf) / abs(lf)
    prio_err = float(np.abs(pc - pf).max())
    print(f"learner step card vs CPU (mlp torso, H={STEP_H}, batch 64, "
          f"T=85): loss bf16 card {lc:.6f} vs f32 CPU {lf:.6f}, relative "
          f"{loss_rel:.3e} (tol {STEP_LOSS_RTOL:.0e}); priorities max-abs "
          f"{prio_err:.3e} (tol {STEP_PRIO_ATOL:.0e}, max {pf.max():.3f})",
          flush=True)
    if not (np.isfinite(lc) and np.isfinite(pc).all()):
        fail("the card's learner step is not finite")
    if loss_rel > STEP_LOSS_RTOL or prio_err > STEP_PRIO_ATOL:
        fail("the card's learner step disagrees with the CPU's")
    return dict(loss_rel_err=loss_rel, prio_max_abs_err=prio_err)


def states_equal(torch, a, b) -> bool:
    """Two train states equal bit for bit: host mirrors, device counters,
    params, target params and Adam's moments."""
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and torch.equal(a.step_t, b.step_t)
            and torch.equal(a.opt_state.count_t, b.opt_state.count_t)
            and all(torch.equal(x[k], y[k])
                    for x, y in ((a.params, b.params),
                                 (a.target_params, b.target_params),
                                 (a.opt_state.mu, b.opt_state.mu),
                                 (a.opt_state.nu, b.opt_state.nu))
                    for k in x))


def graph_vs_eager(torch, graphed, eager, iters: int = 3) -> tuple:
    """A lone call of a graphed entry and of its eager twin, timed in one
    call of this script: per call the host's issue (no synchronisation
    inside), the host wall clock, the device time and the device events
    (for a graph, its kernel nodes) from ``lone``, and the span of the
    stream's work by CUDA events."""
    out = []
    for fn in (graphed, eager):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(dict(lone(torch, fn, iters), issue=issue,
                        span=start.elapsed_time(end) / iters))
    return tuple(out)


def fmt_graph(g: dict, e: dict) -> str:
    return (f"host wall {g['wall']:.2f} ms graphed vs {e['wall']:.2f} ms "
            f"eager (issue {g['issue']:.2f} vs {e['issue']:.2f} ms), device "
            f"{g['device']:.3f} vs {e['device']:.3f} ms (stream span "
            f"{g['span']:.3f} vs {e['span']:.3f} ms), {g['events']:.0f} "
            f"kernel nodes replayed vs {e['events']:.0f} device events "
            f"issued, device idle {1 - g['device'] / g['wall']:.1%} vs "
            f"{1 - e['device'] / e['wall']:.1%}")


def retraces_line(label: str) -> None:
    """A training phase's retrace counts, and its failure when an entry
    point traced (on the card: captured) past its budget, as the JAX
    package's end-to-end tests assert."""
    from r2d2_tpu_torch.utils.trace import RETRACES

    print(f"phase {label} retraces (max traces per entry point): "
          f"{json.dumps(RETRACES.counts(), sort_keys=True)}", flush=True)
    if RETRACES.over_budget():
        fail(f"phase {label}: entry points past their retrace budgets: "
             f"{RETRACES.over_budget()}")


ACT_ENTRIES = ("actor.act", "serving.act", "league.act")


def act_instances(n0: int) -> list:
    """``(name, traces)`` of every act instance built since the retrace
    guard held ``n0`` entries: on the card an act's traces are its
    CUDA-graph captures (actor.py:GraphedAct), on the CPU (a fleet's f32
    twin) its input signatures."""
    from r2d2_tpu_torch.utils.trace import RETRACES

    return [(n, t) for n, t, _ in RETRACES.entries()[n0:]
            if n in ACT_ENTRIES]


def graphed_update_checks(torch, card: str, cfg, net) -> dict:
    """Phase 5's graphed ``learner.train_step`` against the plain step at
    the flagship width: from one state at step 6 and one batch, updates
    7, 8 and 9 (the target sync at 8 inside) bit for bit in loss,
    priorities, every param, Adam moment and the target (cuDNN
    deterministic); one capture; then a lone update of each, timed."""
    from r2d2_tpu_torch.learner.graphs import make_learner_step
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    def at_six():
        # the host mirrors at 6; the device counters come from them
        st = create_train_state(cfg, net.state_dict())
        st.step = st.opt_state.count = 6
        return st

    guard = RetraceGuard()
    graphed = make_learner_step(cfg, net, guard=guard)
    eager = make_train_step(cfg, net)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in step_batch(cfg, seed=7).items()}
    a, b = at_six(), at_six()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for n in (7, 8, 9):
            ga, gb = graphed(a, batch), eager(b, batch)
            a, b = ga[0], gb[0]
            same = (all(torch.equal(x, y) for x, y in zip(ga[1:], gb[1:]))
                    and states_equal(torch, a, b))
            synced = all(torch.equal(a.params[k], a.target_params[k])
                         for k in a.params)
            if not same or a.step != n or synced != (n == 8):
                fail(f"the graphed update {n} is not the eager one bit for "
                     f"bit (loss {ga[1].item()} vs {gb[1].item()}, step "
                     f"{a.step}, target synced {synced})")
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    if guard.counts() != {"learner.train_step": 1}:
        fail(f"graphed update captures: {guard.counts()}")
    g, e = graph_vs_eager(torch, lambda: graphed(a, batch),
                          lambda: eager(b, batch))
    print(f"graphed learner.train_step on {card}: updates 7, 8, 9 (the "
          "target sync at 8) bit for bit the eager step's in loss, "
          "priorities, params, target params, Adam moments and counters "
          "(cuDNN deterministic for the check), 1 capture; a lone update "
          "(the staged batch on the card): " + fmt_graph(g, e), flush=True)
    return dict(graphed=g, eager=e)


def phase_training(torch, card: str) -> int:
    """Phase 5: ``train_sync`` at the flagship width on the card."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.evaluate import EVAL_ACT, evaluate_params
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import (
        HOST_TRANSFERS,
        KERNEL_LAUNCHES,
        RETRACES,
    )

    t_phase = time.perf_counter()
    base = Config(game_name="Fake")
    flagship = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                    hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                    param_dtype="float32", batch_size=64, burn_in_steps=40,
                    learning_steps=40, forward_steps=5, num_actors=8,
                    block_length=400)
    got = {k: getattr(base, k) for k in flagship}
    if got != flagship:
        fail(f"Config(game_name='Fake') is not the flagship: {got}")
    cfg = base.replace(**TRAIN_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in TRAIN_REDUCED.items())
        + f" (host ring {cfg.num_blocks} blocks of {cfg.block_length}); "
        f"fake env episodes of {FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} "
        "actions", flush=True)

    # the run's parts, captured as train_sync builds them, so that the
    # checks below can read the buffer, the actor and the learner; the
    # actor's bursts and the learner's steps are timed (each step ends in
    # a synchronise, as the result fetch at pipeline 0 does anyway)
    rec = dict(fill=[], acts=[], updates=[], synced={})
    built = {}
    real_build = train._build

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner = sys_["actor"], sys_["learner"]
        run, step = actor.run, learner._step_fn

        def timed_run(max_steps, stop=None):
            t0 = time.perf_counter()
            run(max_steps, stop)
            key = "fill" if max_steps == cfg.block_length else "acts"
            rec[key].append((max_steps, time.perf_counter() - t0))

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["updates"].append((time.perf_counter() - t0) * 1e3)
            st = out[0]
            if st.step in (7, 8):
                rec["synced"][st.step] = all(
                    torch.equal(st.params[k], st.target_params[k])
                    for k in st.params)
            return out

        actor.run, learner._step_fn = timed_run, timed_step
        built.update(sys_, run=run, step=step)
        return sys_

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        train._build = capture
        t0 = time.perf_counter()
        try:
            m = train.train_sync(cfg, env_factory, checkpoint_dir=ckdir,
                                 device="cuda")
        finally:
            train._build = real_build
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_return = evaluate_params(cfg, built["act_net"],
                                      m["final_params"], env_factory,
                                      episodes=EVAL_EPISODES, epsilon=0.0,
                                      seed=cfg.seed)
        eval_s = time.perf_counter() - t0
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old_launches = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        acts = HOST_TRANSFERS.get(ACTOR_ACT)
        evals = HOST_TRANSFERS.get(EVAL_ACT)
        actor, learner, buffer = (built["actor"], built["learner"],
                                  built["buffer"])

        # the main path's checks
        if built["act_net"].lstm_layers[0].impl != "pallas":
            fail("the actors' network did not resolve the fused LSTM kernel")
        if acts != actor.actor_steps:
            fail(f"{acts} actor acts for {actor.actor_steps} lockstep "
                 "iterations")
        if (launches != cfg.lstm_layers * (acts + evals) or not acts
                or not evals or old_launches):
            fail(f"lstm_infer launched {launches} times (CUDA-core "
                 f"{old_launches}) for {acts} actor iterations and {evals} "
                 f"evaluator steps, {cfg.lstm_layers} layer(s)")
        losses = np.asarray(m["losses"])
        stats = buffer.stats()
        if (m["num_updates"] != cfg.training_steps
                or losses.shape != (cfg.training_steps,)
                or not np.isfinite(losses).all()
                or stats["training_steps"] != cfg.training_steps):
            fail(f"training: {m['num_updates']} updates, losses {losses}, "
                 f"buffer training_steps {stats['training_steps']}")
        if rec["synced"] != {7: False, 8: True}:
            fail(f"target params equal to the online params after steps "
                 f"7, 8: {rec['synced']} (want False, True)")
        if not np.isfinite(eval_return):
            fail(f"evaluation return {eval_return}")

        # the latest checkpoint restores into a fresh learner bit for bit
        ck = Checkpointer(ckdir)
        if ck.steps() != [8, 16]:
            fail(f"checkpoints {ck.steps()}, expected [8, 16]")
        state, meta = ck.restore()
        fresh = Learner(built["cfg"], built["net"], state)
        a, b = learner.state, fresh.state
        same = (a.step == b.step == cfg.training_steps
                and a.opt_state.count == b.opt_state.count
                and all(torch.equal(x[k], y[k])
                        for x, y in ((a.params, b.params),
                                     (a.target_params, b.target_params),
                                     (a.opt_state.mu, b.opt_state.mu),
                                     (a.opt_state.nu, b.opt_state.nu))
                        for k in x))
        if not same:
            fail("the latest checkpoint did not restore bit for bit")
        print(f"training: {m['num_updates']} updates in {train_s:.2f} s, "
              f"losses {fmt_list(losses.tolist())}, buffer training_steps "
              f"{stats['training_steps']}, env_steps {m['env_steps']}; "
              f"target == online after step 7 {rec['synced'][7]}, after 8 "
              f"{rec['synced'][8]}; checkpoints {ck.steps()} restore bit "
              f"for bit (step {b.step}, env_steps {meta['env_steps']}); "
              f"greedy return over {EVAL_EPISODES} episodes "
              f"{eval_return:.3f} in {eval_s:.2f} s; lstm_infer launches "
              f"{launches} = {cfg.lstm_layers} x ({acts} actor iterations "
              f"+ {evals} evaluator steps), CUDA-core {old_launches}",
              flush=True)

        # timings (after the checks; they run the actor and learner on)
        fill_steps = sum(n for n, _ in rec["fill"])
        fill_s = sum(t for _, t in rec["fill"])
        upd = np.asarray(rec["updates"])
        MESHLESS["update_p50"] = float(np.percentile(upd, 50))
        spans = learner.tracer.snapshot()
        print(f"training timings on {card}: fill {fill_steps} lockstep "
              f"iterations x {cfg.num_actors} envs in {fill_s:.2f} s = "
              f"{fill_steps * cfg.num_actors / fill_s:.0f} env steps/s; "
              f"learner update (step + synchronise) p50 "
              f"{np.percentile(upd, 50):.2f} ms, min {upd.min():.2f}, max "
              f"{upd.max():.2f}, first {upd[0]:.2f} over {len(upd)}; "
              "per-update spans (mean ms) "
              + ", ".join(f"{k[5:-8]} {v:.2f}" for k, v in sorted(
                  spans.items()) if k.endswith(".mean_ms")), flush=True)

        one_iter = lambda: built["run"](1)   # noqa: E731
        act_events, _ = act_kernel_events(torch, one_iter, 10,
                                          cfg.lstm_layers)
        act_wall = wall_ms(torch, one_iter, 20)
        if act_events is None:
            fail("no device time in an actor iteration")
        act_dev = sum(ms for _, ms, _ in act_events)
        kern = [(ms, n) for k, ms, n in act_events if WGMMA_KERNEL in k]
        if (not kern or kern[0][1] != cfg.lstm_layers
                or any(CUDACORE_KERNEL in k for k, _, _ in act_events)):
            fail(f"an actor iteration ran {kern} tensor-core LSTM kernels")

        def one_update():
            dev, _ = learner._stage(buffer.sample_batch())
            _, loss, _ = built["step"](learner.state, dev)
            return loss.item()

        upd_events = profile_events(torch, one_update, 2)
        upd_wall = wall_ms(torch, one_update, 2)
        if upd_events is None:
            fail("no device time in a learner update")
        if any("lstm_step" in k for k, _, _ in upd_events):
            fail("a learner update launched an lstm_infer kernel")
        upd_dev = sum(ms for _, ms, _ in upd_events)
        n_upd = sum(n for _, _, n in upd_events)
        print(f"actor iteration (B={cfg.num_actors}) on {card}: host wall "
              f"{act_wall:.3f} ms, device {act_dev:.4f} ms in "
              f"{sum(n for _, _, n in act_events):.0f} device events, "
              f"lstm_infer tensor-core kernel {kern[0][0]:.4f} ms "
              f"({kern[0][0] / act_dev:.1%} of the device time), device idle "
              f"{1 - act_dev / act_wall:.1%}", flush=True)
        print(f"learner update (sample, stage, step, fetch; 2 updates "
              f"profiled) on {card}: host wall {upd_wall:.2f} ms, device "
              f"{upd_dev:.3f} ms in {n_upd:.0f} device events, device idle "
              f"{1 - upd_dev / upd_wall:.1%}; no lstm_infer kernel; top 5 "
              "device ops (ms per update, count): " + "; ".join(
                  f"{short_kernel_name(k)} {ms:.3f} ({n:.0f})"
                  for k, ms, n in upd_events[:5]), flush=True)
        # the run's learner replayed one captured graph for its updates
        traces = built["step"].graphs.entry.traces
        if (built["step"].graphs.captures != 1 or traces != 1
                or RETRACES.counts().get("learner.train_step") != 1):
            fail(f"train_sync's learner.train_step: {traces} traces, "
                 f"{built['step'].graphs.captures} captures, process-wide "
                 f"{RETRACES.counts()}")
        print(f"train_sync's learner.train_step on {card}: "
              f"{cfg.training_steps} updates (and the profiled ones) from 1 "
              "CUDA-graph capture", flush=True)
        graphed_update_checks(torch, card, cfg, built["net"])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    learner_step_card_vs_cpu(torch)
    print(f"phase 5 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def http_get(port: int, path: str):
    """``(status, body)`` of a GET to the local exporter (no proxy: a
    direct connection to 127.0.0.1)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each ``|x|`` (8 significant bits)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def served_vs_plain(torch, cfg, action_dim, served, params, bucket) -> dict:
    """Every served batch held against the plain version on the same card,
    params and padded rows:

    - ``hidden``: the served new hidden against a direct act with the
      plain LSTM in place of the kernel, which is what the kernel computes;
    - ``q``: the served q against the plain dueling head of the served new
      hidden (its top layer's h is the head's input), the same arithmetic
      at the same shapes, so any difference is the server's;
    - ``act`` and ``act_ulps``: the served q against the plain act's q end
      to end, max-abs and in bf16 ulps of the plain q.  Both ends round in
      the bf16 head, so a q beside a rounding boundary differs by one ulp
      (3.906e-03 at |q| >= 0.5) however small ``hidden`` is: these two are
      printed, and the two above are the checks."""
    from r2d2_tpu_torch.actor import make_act_fn
    from r2d2_tpu_torch.serving.batcher import bucket_sizes
    from r2d2_tpu_torch.models import create_network

    plain = create_network(cfg, action_dim, device="cuda",
                           lstm_impl="reference")
    # the reference act runs at every bucket shape the server formed: one
    # trace a bucket, as the server's own act (its budget)
    plain_act = make_act_fn(plain, retrace_budget=len(
        bucket_sizes(cfg.serve_max_batch)) + 1)
    gparams = {k: v.to("cuda") for k, v in params.items()}
    head = {k[len("head."):]: v for k, v in gparams.items()
            if k.startswith("head.")}
    err = dict(q=0.0, hidden=0.0, act=0.0, act_ulps=0.0)
    for b_obs, b_la, b_lr, b_hid, b_q, b_new in served:
        n = len(b_obs)
        pad = bucket(n)

        def padded(a):
            out = np.zeros((pad, *a.shape[1:]), a.dtype)
            out[:n] = a
            return torch.from_numpy(out).to("cuda")

        q, new_hidden = plain_act(gparams, padded(b_obs), padded(b_la),
                                  padded(b_lr), padded(b_hid))
        with torch.inference_mode():
            q_head = torch.func.functional_call(
                plain.head, head, (padded(b_new)[:, 0, -1],))
        q = q[:n].cpu().numpy()
        d = np.abs(q - b_q)
        err["act"] = max(err["act"], float(d.max()))
        err["act_ulps"] = max(err["act_ulps"], float((d / bf16_ulp(q)).max()))
        err["q"] = max(err["q"], float(np.abs(
            q_head[:n].cpu().numpy() - b_q).max()))
        err["hidden"] = max(err["hidden"], float(np.abs(
            new_hidden[:n].cpu().numpy() - b_new).max()))
    return err


def phase_fabric(torch, card: str):
    """Phase 6: the IMPALA-deep net trained by the threaded ``train()``,
    resumed warm, and its checkpoint served by ``run_server``.  Returns
    the kernel's launches on the fabric and on the served checkpoint."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.config import impala_deep_config
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes
    from r2d2_tpu_torch.serving import server as server_mod
    from r2d2_tpu_torch.telemetry.runlog import read_entries
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    t_phase = time.perf_counter()
    base = impala_deep_config(game_name="Fake")
    literal = dict(torso="impala", lstm_layers=2, hidden_dim=H,
                   obs_shape=(84, 84, 1), stored_obs_shape=(84, 84, 1),
                   obs_space_to_depth=False, batch_size=64,
                   burn_in_steps=40, learning_steps=75, forward_steps=5,
                   block_length=375, remat=True, compute_dtype="bfloat16",
                   param_dtype="float32", num_actors=8)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"impala_deep_config(game_name='Fake') is not the IMPALA-deep "
             f"configuration: {got}")
    cfg = base.replace(**FABRIC_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in FABRIC_REDUCED.items())
        + f" (host ring {cfg.num_blocks} blocks of {cfg.block_length}, "
        f"{data_bytes(cfg, TRAIN_ACTIONS) / 1e9:.3f} GB); fake env episodes "
        f"of {FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} actions", flush=True)

    # each run's parts, captured as train() builds them: the learner's
    # steps are stamped (entry, exit, actor iterations so far) without any
    # synchronisation, so the fabric runs as it would unobserved
    runs = []
    real_build = train._build

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner = sys_["actor"], sys_["learner"]
        run, step = actor.run, learner._step_fn
        rec = dict(sys_, run=run, step=step, steps=[], start=None,
                   actor_steps0=actor.actor_steps,
                   episode_steps0=actor.episode_steps.copy())

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def timed_step(state, batch):
            t0, a0 = time.perf_counter(), actor.actor_steps
            out = step(state, batch)
            rec["steps"].append((t0, a0, time.perf_counter(),
                                 actor.actor_steps))
            return out

        actor.run, learner._step_fn = timed_run, timed_step
        runs.append(rec)
        return sys_

    probe = {}

    def log_sink(entry):
        # the first entry: read the run's exporter while it trains
        if probe:
            return
        try:
            port = entry["telemetry_port"]
            probe["healthz"] = http_get(port, "/healthz")
            probe["metrics"] = http_get(port, "/metrics")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    def counts():
        return (KERNEL_LAUNCHES.get(lstm.KERNEL),
                KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER),
                HOST_TRANSFERS.get(ACTOR_ACT),
                lstm.TENSOR_MAP_ENCODES.get(lstm.KERNEL))

    def reset():
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        lstm.TENSOR_MAP_ENCODES.reset()

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_fabric_")
    try:
        train._build = capture
        try:
            reset()
            t0 = time.perf_counter()
            m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                            max_wall_seconds=FABRIC_WALL_S, verbose=False,
                            log_sink=log_sink)
            train_s = time.perf_counter() - t0
            launches, old, acts, encodes = counts()
            first = runs[0]
            actor = first["actor"]
            saved_steps = actor.actor_steps
            saved_episode_steps = actor.episode_steps.copy()

            # the fabric's checks
            if first["act_net"].lstm_layers[0].impl != "pallas":
                fail("the fabric's actors did not resolve the fused LSTM "
                     "kernel")
            lh = m["learnhealth"]
            restarts = {k: h["restarts"] for k, h in m["health"].items()}
            if (m["num_updates"] != cfg.training_steps
                    or m["buffer_training_steps"] != m["num_updates"]
                    or lh["loss_count"] != cfg.training_steps
                    or lh["nonfinite"] or not np.isfinite(m["mean_loss"])):
                fail(f"fabric: {m['num_updates']} updates, buffer "
                     f"{m['buffer_training_steps']} feedbacks, learnhealth "
                     f"{lh}")
            if m["fabric_failed"] or any(restarts.values()):
                fail(f"fabric threads: failed {m['fabric_failed']}, "
                     f"restarts {restarts}")
            if launches != cfg.lstm_layers * acts or not acts or old:
                fail(f"lstm_infer launched {launches} times (CUDA-core "
                     f"{old}) for {acts} actor acts, {cfg.lstm_layers} "
                     "layers")
            if "error" in probe or probe["healthz"][0] != 200:
                fail(f"the run's exporter: {probe}")
            health = json.loads(probe["healthz"][1])
            if (health.get("status") != "ok" or probe["metrics"][0] != 200
                    or "r2d2_replay_buffer_size" not in
                    probe["metrics"][1]):
                fail(f"/healthz {health}, /metrics status "
                     f"{probe['metrics'][0]}")
            runlog = os.path.join(ckdir, "telemetry", "run.jsonl")
            ck = Checkpointer(ckdir)
            if not os.path.exists(runlog) or cfg.training_steps not in (
                    ck.replay_steps()):
                fail(f"run log {os.path.exists(runlog)}, replay snapshots "
                     f"{ck.replay_steps()}")
            print(f"fabric on {card}: {m['num_updates']} updates in "
                  f"{train_s:.2f} s, "
                  f"buffer feedbacks {m['buffer_training_steps']}, mean loss "
                  f"{m['mean_loss']:.5f}, losses finite "
                  f"{lh['loss_count']}/{cfg.training_steps}; threads "
                  f"{sorted(restarts)} restarts 0; /healthz "
                  f"{health['status']}, /metrics "
                  f"{len(probe['metrics'][1])} bytes; checkpoints "
                  f"{ck.steps()}, replay snapshots {ck.replay_steps()}; "
                  f"lstm_infer launches {launches} = {cfg.lstm_layers} x "
                  f"{acts} actor acts, CUDA-core {old}; tensor-map encodes "
                  f"{encodes} ({encodes / acts:.2f} per act)", flush=True)

            # the fabric's timings (from the stamps, no synchronisation)
            steps = first["steps"]
            n_env = cfg.num_actors
            t_start, a_start = first["start"]
            fill_rate = (steps[0][1] - a_start) * n_env / (steps[0][0]
                                                           - t_start)
            train_rate = ((steps[-1][3] - steps[0][1]) * n_env
                          / (steps[-1][2] - steps[0][0]))
            exits = np.asarray([s[2] for s in steps])
            gaps = np.diff(exits) * 1e3
            print(f"fabric timings on {card}: env steps/s while filling "
                  f"{fill_rate:.0f} ({steps[0][1] - a_start} iterations x "
                  f"{n_env} envs), while training {train_rate:.0f}; "
                  f"updates/s {(len(exits) - 1) / (exits[-1] - exits[0]):.3f}"
                  f", update interval p50 {np.percentile(gaps, 50):.2f} ms "
                  f"(min {gaps.min():.2f}, max {gaps.max():.2f}, "
                  f"{len(gaps)} intervals); first update dispatched "
                  f"{(steps[0][2] - steps[0][0]) * 1e3:.1f} ms", flush=True)
            spans = m["trace"]
            print(f"fabric spans on {card} (mean / p50 ms): " + ", ".join(
                f"{k[5:-8]} {v:.2f} / {spans[k[:-8] + '.p50_ms']:.2f}"
                for k, v in sorted(spans.items()) if k.endswith(".mean_ms")),
                flush=True)

            # where an update's and an actor iteration's time goes, the
            # fabric stopped (both run on after the snapshot was saved)
            learner, buffer = first["learner"], first["buffer"]

            def one_update():
                dev, _ = learner._stage(buffer.sample_batch())
                _, loss, _ = first["step"](learner.state, dev)
                return loss.item()

            upd_events = profile_events(torch, one_update, 1)
            upd_wall = wall_ms(torch, one_update, 2)
            if upd_events is None:
                fail("no device time in a learner update")
            if any("lstm_step" in k for k, _, _ in upd_events):
                fail("a learner update launched an lstm_infer kernel")
            upd_dev = sum(ms for _, ms, _ in upd_events)
            print(f"learner update at IMPALA-deep (sample, stage, step, "
                  f"fetch; 1 profiled) on {card}: host wall {upd_wall:.2f} "
                  f"ms, device {upd_dev:.3f} ms in "
                  f"{sum(n for _, _, n in upd_events):.0f} device events, "
                  f"device idle {1 - upd_dev / upd_wall:.1%}; top 5 device "
                  "ops (ms per update, count): " + "; ".join(
                      f"{short_kernel_name(k)} {ms:.3f} ({n:.0f})"
                      for k, ms, n in upd_events[:5]), flush=True)
            one_iter = lambda: first["run"](1)   # noqa: E731
            act_events, _ = act_kernel_events(torch, one_iter, 10,
                                              cfg.lstm_layers)
            act_wall = wall_ms(torch, one_iter, 20)
            if act_events is None:
                fail("no device time in an actor iteration")
            act_dev = sum(ms for _, ms, _ in act_events)
            kern = [(ms, n) for k, ms, n in act_events if WGMMA_KERNEL in k]
            if (not kern or kern[0][1] != cfg.lstm_layers
                    or any(CUDACORE_KERNEL in k for k, _, _ in act_events)):
                fail(f"an IMPALA-deep actor iteration ran {kern} "
                     "tensor-core LSTM kernels")
            print(f"actor iteration at IMPALA-deep (B={cfg.num_actors}) on "
                  f"{card}: host wall {act_wall:.3f} ms, device "
                  f"{act_dev:.4f} ms in "
                  f"{sum(n for _, _, n in act_events):.0f} device events, "
                  f"lstm_infer tensor-core kernel {kern[0][0]:.4f} ms in "
                  f"{kern[0][1]:.0f} launches ({kern[0][0] / act_dev:.1%} of "
                  f"the device time), device idle "
                  f"{1 - act_dev / act_wall:.1%}", flush=True)

            # resume warm: the replay ring and the actors come back
            reset()
            t0 = time.perf_counter()
            m2 = train.train(cfg.replace(training_steps=FABRIC_RESUME_STEPS),
                             env_factory, checkpoint_dir=ckdir, resume=True,
                             max_wall_seconds=FABRIC_WALL_S, verbose=False)
            resume_s = time.perf_counter() - t0
            launches2, old2, acts2, encodes2 = counts()
        finally:
            train._build = real_build
        second = runs[1]
        entries = list(read_entries(runlog))
        env_curve = [e["env_steps"] for e in entries]
        upd_curve = [e["training_steps"] for e in entries]
        if (not m2["restored_replay"]
                or m2["num_updates"] != FABRIC_RESUME_STEPS
                or m2["buffer_training_steps"] != FABRIC_RESUME_STEPS
                or second["actor_steps0"] != saved_steps
                or not np.array_equal(second["episode_steps0"],
                                      saved_episode_steps)
                or second["actor"].actor_steps <= saved_steps
                or m2["env_steps"] < m["env_steps"]
                or env_curve != sorted(env_curve)
                or upd_curve != sorted(upd_curve)):
            fail(f"resume: restored_replay {m2['restored_replay']}, "
                 f"{m2['num_updates']} updates, feedbacks "
                 f"{m2['buffer_training_steps']}, actor steps "
                 f"{second['actor_steps0']} (saved {saved_steps}), env steps "
                 f"{m['env_steps']} -> {m2['env_steps']}, run log env steps "
                 f"{env_curve}, updates {upd_curve}")
        if launches2 != cfg.lstm_layers * acts2 or not acts2 or old2:
            fail(f"resumed: lstm_infer launched {launches2} times (CUDA-core "
                 f"{old2}) for {acts2} actor acts")
        print(f"fabric resume on {card}: restored_replay true, "
              f"{m2['num_updates']} "
              f"updates in {resume_s:.2f} s, actor iterations "
              f"{saved_steps} -> {second['actor_steps0']} (restored) -> "
              f"{second['actor'].actor_steps}, env steps {m['env_steps']} -> "
              f"{m2['env_steps']}, run log {len(entries)} entries monotone; "
              f"lstm_infer launches {launches2} = {cfg.lstm_layers} x "
              f"{acts2} acts, CUDA-core {old2}", flush=True)
        fabric_launches = launches + launches2

        serve_launches = serve_checkpoint(torch, card, cfg, ckdir,
                                          server_mod)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"phase 6 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return fabric_launches, serve_launches


def serve_checkpoint(torch, card: str, cfg, ckdir: str, server_mod) -> int:
    """Phase 6's serving half: ``run_server`` on the fabric's checkpoint in
    a worker thread, a client process driving the sessions.  Returns the
    kernel's launches under that traffic."""
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    t0 = time.perf_counter()
    served, holder, result = [], {}, {}
    done = threading.Event()
    real_server = server_mod.SessionServer

    class RecordingServer(real_server):
        """The server run_server builds, with every served batch's inputs
        and outputs recorded (host copies)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            act = self.batcher.act

            def recording_act(obs, last_action, last_reward, hidden):
                q, new_hidden = act(obs, last_action, last_reward, hidden)
                served.append(tuple(np.array(a) for a in (
                    obs, last_action, last_reward, hidden, q, new_hidden)))
                return q, new_hidden

            self.batcher.act = recording_act
            holder["server"] = self

    def serve():
        try:
            result["stats"] = server_mod.run_server(
                cfg, ckdir, action_dim=TRAIN_ACTIONS,
                max_wall_seconds=FABRIC_WALL_S, verbose=False,
                stop_fn=done.is_set)
        except BaseException as e:  # reported by the main thread
            result["error"] = f"{type(e).__name__}: {e}"

    server_mod.SessionServer = RecordingServer
    thread = threading.Thread(target=serve, name="run_server")
    try:
        thread.start()
        deadline = time.monotonic() + 300
        while not (holder.get("server") is not None
                   and holder["server"]._started):
            if "error" in result or time.monotonic() > deadline:
                fail(f"run_server did not start: {result}")
            time.sleep(0.05)
        server = holder["server"]
        if server.batcher.device.type != "cuda":
            fail(f"run_server acts on {server.batcher.device}")
        # the traffic only: warmup's launches are behind us
        KERNEL_LAUNCHES.reset()
        lstm.TENSOR_MAP_ENCODES.reset()
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        child = ctx.Process(target=client_process,
                            args=(server.host, server.port, out, "impala"))
        child.start()
        try:
            reply = out.get(timeout=300)
        except queue.Empty:
            reply = ("error", "the client process sent nothing in 300 s")
        finally:
            child.join(timeout=30)
            if child.is_alive():
                child.terminate()
                child.join(timeout=10)
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        encodes = lstm.TENSOR_MAP_ENCODES.get(lstm.KERNEL)
        batches = server.batches
        spans = server.tracer.snapshot()
    finally:
        done.set()
        thread.join(timeout=120)
        server_mod.SessionServer = real_server
    if thread.is_alive() or "error" in result:
        fail(f"run_server did not end cleanly: {result}")
    if reply[0] != "ok":
        fail(reply[1])
    _, replies, lat = reply
    stats = result["stats"]
    if len(replies) != FABRIC_SESSIONS * N_STEPS or not all(
            q.shape == (TRAIN_ACTIONS,) and np.isfinite(q).all()
            for q in replies.values()):
        fail(f"{len(replies)} served replies, or a bad q")
    if stats["step"] != FABRIC_RESUME_STEPS or stats["admitted"] != (
            stats["completed"] + stats["reaped"] + stats["evicted"]
            + stats["live"]) or stats["act_failures"]:
        fail(f"run_server stats: {stats}")
    if launches != cfg.lstm_layers * batches or not batches or old:
        fail(f"the served checkpoint launched lstm_infer {launches} times "
             f"(CUDA-core {old}) for {batches} batches")
    snap = os.path.join(ckdir, "sessions.snap", "meta.json")
    if not os.path.exists(snap):
        fail("no session snapshot at shutdown")
    with open(snap) as f:
        snap_counters = json.load(f)["counters"]
    want = {k: stats[k] for k in ("admitted", "completed", "reaped",
                                  "evicted")}
    if snap_counters != want:
        fail(f"session snapshot counters {snap_counters}, server {want}")
    state, _ = Checkpointer(ckdir).restore(FABRIC_RESUME_STEPS)
    err = served_vs_plain(torch, cfg, TRAIN_ACTIONS, served, state.params,
                          server.batcher.bucket)
    sizes = sorted(len(b[0]) for b in served)
    print(f"served checkpoint step_{stats['step']} on {card}: {batches} "
          f"batches, "
          f"sizes {sizes}; against the restored params: new hidden vs "
          f"plain-LSTM act max_abs_err {err['hidden']:.3e} (tol "
          f"{Q_TOL:.0e}), q vs the plain head of the served hidden "
          f"{err['q']:.3e} (tol {Q_TOL:.0e}), q vs plain-LSTM act end to "
          f"end {err['act']:.3e} ({err['act_ulps']:.2f} bf16 ulps); store "
          f"{want} live {stats['live']}, session "
          f"snapshot counters equal; lstm_infer launches {launches} = "
          f"{cfg.lstm_layers} x {batches} batches, CUDA-core {old}; "
          f"tensor-map encodes {encodes} ({encodes / batches:.2f} per "
          f"batch)", flush=True)
    if err["q"] > Q_TOL or err["hidden"] > Q_TOL:
        fail("the served checkpoint disagrees with the plain version")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    print(f"served checkpoint latency on {card}: serving.act p50 "
          f"{spans['span.serving.act.p50_ms']:.3f} ms p99 "
          f"{spans['span.serving.act.p99_ms']:.3f} ms; client round trip "
          f"({len(lat)} requests) p50 {p50:.3f} ms p99 {p99:.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def scripted_blocks(cfg, n_blocks: int, seed: int = 0):
    """``n_blocks`` well-formed blocks at ``cfg``'s shapes, cut by the
    port's LocalBuffer from seeded random steps."""
    from r2d2_tpu_torch.replay.block import LocalBuffer

    rng = np.random.default_rng(seed)
    local = LocalBuffer(cfg, TRAIN_ACTIONS)
    local.reset(rng.integers(0, 256, cfg.stored_obs_shape, np.uint8))
    out = []
    while len(out) < n_blocks:
        for _ in range(cfg.block_length):
            local.add(int(rng.integers(TRAIN_ACTIONS)), float(rng.normal()),
                      rng.integers(0, 256, cfg.stored_obs_shape, np.uint8),
                      rng.normal(size=TRAIN_ACTIONS).astype(np.float32),
                      (rng.normal(size=(2, cfg.lstm_layers, cfg.hidden_dim))
                       * 0.5).astype(np.float32))
        blk, prios, _ = local.finish(
            rng.normal(size=TRAIN_ACTIONS).astype(np.float32))
        out.append((blk, prios))
    return out


def device_ring_checks(torch, base) -> dict:
    """Phase 7's checks on the card before the fabric runs: the device
    gather against the host ring, the in-graph sampler against its CPU
    run, the graphed super-step against k sequential eager train steps,
    and the graphed in-graph super-step against its eager run."""
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.utils.trace import RetraceGuard
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.replay.device_ring import (
        DeviceRing,
        gather_batch,
        to_device,
    )
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    cuda = torch.device("cuda", torch.cuda.current_device())
    k, B = base.superstep_k, base.batch_size
    # a ring of a few blocks at the full slot shapes, wrapped once
    cfg = base.replace(buffer_capacity=CHECK_RING_BLOCKS * base.block_length,
                       learning_starts=base.block_length, in_graph_per=False)
    host = ReplayBuffer(cfg.replace(device_replay=False), TRAIN_ACTIONS,
                        rng=np.random.default_rng(3))
    ring = DeviceRing(cfg, TRAIN_ACTIONS, device=cuda)
    dev = ReplayBuffer(cfg, TRAIN_ACTIONS, rng=np.random.default_rng(3),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, CHECK_RING_BLOCKS + 2):
        host.add(blk, prios, None)
        dev.add(blk, prios, None)
    meta = dev.sample_meta(k)
    ints = to_device(meta["ints"], cuda)
    weights = to_device(meta["is_weights"], cuda)
    for j in range(k):
        got = gather_batch(cfg, ring.snapshot(), ints[j], weights[j])
        want = dict(host._gather_rows(meta["idxes"][j]),
                    is_weights=meta["is_weights"][j])
        for key, v in want.items():
            if not np.array_equal(got[key].cpu().numpy(), v):
                fail(f"device gather field {key} differs from the host "
                     f"ring's _gather_rows (bundle {j})")
    print(f"device gather on the card: {k} bundles x {B} rows from a "
          f"{cfg.num_blocks}-block ring at the full slot shapes (obs "
          f"{tuple(ring.arrays['obs'].shape[1:])}, hidden "
          f"{tuple(ring.arrays['hidden'].shape[1:])}), every field bit for "
          "bit equal to the host ring's _gather_rows", flush=True)

    # the in-graph sampler over the full ring's leaf count, card vs CPU
    rng = np.random.default_rng(11)
    NB, K = base.num_blocks, base.seqs_per_block
    prios = (rng.random(NB * K) * rng.exponential(1.0, NB * K)).astype(
        np.float32)
    prios[rng.random(NB * K) < 0.3] = 0.0
    seq_meta = np.stack([rng.integers(0, base.burn_in_steps + 1, (NB, K)),
                         rng.integers(1, base.learning_steps + 1, (NB, K)),
                         rng.integers(1, base.forward_steps + 1, (NB, K))],
                        axis=-1).astype(np.int32)
    first = rng.integers(0, base.burn_in_steps + 1, NB).astype(np.int32)
    u = rng.random((k, B)).astype(np.float32)
    w_err = 0.0
    for j in range(k):
        leaves = [torch.from_numpy(a) for a in (prios, seq_meta, first)]
        cpu = step_mod._in_graph_sample(base, torch.from_numpy(u[j]), *leaves)
        card = step_mod._in_graph_sample(
            base, torch.from_numpy(u[j]).to(cuda),
            *(t.to(cuda) for t in leaves))
        if not (torch.equal(card[0].cpu(), cpu[0])
                and torch.equal(card[2].cpu(), cpu[2])):
            fail("the in-graph sampler's indices or ints differ between the "
                 "card and the CPU")
        w_err = max(w_err, float(((card[1].cpu() - cpu[1]).abs()
                                  / cpu[1]).max()))
    if w_err > SAMPLER_W_RTOL:
        fail(f"the in-graph sampler's weights: {w_err:.3e} relative")
    print(f"in-graph sampler on the card vs the CPU over {NB * K} leaves "
          f"(30% zero), {k} x {B} draws: indices and ints equal, weights "
          f"max relative error {w_err:.3e} (tol {SAMPLER_W_RTOL:.0e})",
          flush=True)

    # one host-sampled super-step (k replays of its CUDA graph) against k
    # sequential eager train steps on the same bundles, bit for bit:
    # cuDNN's conv weight gradients may otherwise pick algorithms with
    # atomics, so deterministic for this check only
    net = create_network(cfg, TRAIN_ACTIONS, device=cuda,
                         generator=torch.Generator().manual_seed(5))
    fused = step_mod.create_train_state(cfg, net.state_dict())
    seq = step_mod.create_train_state(cfg, net.state_dict())
    super_step = step_mod.make_super_step_fn(cfg, net, k,
                                             guard=RetraceGuard())
    train_step = step_mod.make_train_step(cfg, net)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fused, losses, fprios = super_step(fused, ring.snapshot(), ints,
                                           weights)
        seq_losses, seq_prios = [], []
        for j in range(k):
            seq, loss, p = train_step(seq, gather_batch(
                cfg, ring.snapshot(), ints[j], weights[j]))
            seq_losses.append(loss)
            seq_prios.append(p)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = was
    same = (torch.equal(losses, torch.stack(seq_losses))
            and torch.equal(fprios, torch.stack(seq_prios))
            and all(torch.equal(a[n], b[n])
                    for a, b in ((fused.params, seq.params),
                                 (fused.target_params, seq.target_params),
                                 (fused.opt_state.mu, seq.opt_state.mu),
                                 (fused.opt_state.nu, seq.opt_state.nu))
                    for n in a))
    if not (same and torch.isfinite(losses).all()
            and super_step.graphs.captures == 1):
        fail(f"a graphed super-step is not k sequential steps bit for bit "
             f"(losses {losses.tolist()} vs "
             f"{[x.item() for x in seq_losses]}, "
             f"{super_step.graphs.captures} captures)")
    print(f"graphed super-step (k={k}, 1 capture) vs {k} sequential eager "
          f"train steps on the card: losses {fmt_list(losses.tolist())}, "
          "priorities, params, target params and Adam moments bit for bit "
          "equal (cuDNN deterministic)", flush=True)
    in_graph_graph_check(torch, base, net)
    return dict(gather_bitwise=True, sampler_w_rel_err=w_err,
                superstep_bitwise=True)


def in_graph_graph_check(torch, base, net) -> None:
    """The graphed in-graph PER super-step (sample, gather, step and
    scatter, one CUDA graph an inner step) against the same super-step
    run eagerly, from the same ring of a few blocks at the full slot
    shapes, state and generator seed, for two dispatches: sampled
    indices, losses, the priority slab and every param bit for bit (cuDNN
    deterministic for the check)."""
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.replay.device_ring import DeviceRing
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
    from r2d2_tpu_torch.utils.trace import RetraceGuard

    cuda = torch.device("cuda", torch.cuda.current_device())
    cfg = base.replace(buffer_capacity=CHECK_RING_BLOCKS * base.block_length,
                       learning_starts=base.block_length, in_graph_per=True)
    k = cfg.superstep_k
    ring = DeviceRing(cfg, TRAIN_ACTIONS, device=cuda)
    buf = ReplayBuffer(cfg, TRAIN_ACTIONS, rng=np.random.default_rng(3),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, CHECK_RING_BLOCKS + 2):
        buf.add(blk, prios, None)
    meta = ring.per_meta()
    graphed = step_mod.make_in_graph_per_super_step_fn(
        cfg, net, k, guard=RetraceGuard())
    eager = step_mod.make_in_graph_per_super_step_fn(
        cfg, net, k, train_step=step_mod.make_train_step(cfg, net),
        guard=RetraceGuard())
    states = [step_mod.create_train_state(cfg, net.state_dict())
              for _ in range(2)]
    leaves = [ring.take_prios().clone() for _ in range(2)]
    gens = [torch.Generator(device=cuda).manual_seed(cfg.seed)
            for _ in range(2)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        same, drawn = True, 0
        for _ in range(2):
            recs, losses = ([], []), []
            for i, fn in enumerate((graphed, eager)):
                out = fn(states[i], ring.snapshot(), leaves[i],
                         meta["seq_meta"], meta["first"], generator=gens[i],
                         record=recs[i])
                losses.append(out[2])
            drawn += sum(int(x.numel()) for x in recs[0])
            same = (same and len(recs[0]) == k
                    and all(torch.equal(x, y) for x, y in zip(*recs))
                    and torch.equal(*losses)
                    and torch.equal(*leaves)
                    and states_equal(torch, *states))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    if not same or graphed.graphs.captures != 1:
        fail(f"the graphed in-graph super-step is not the eager one bit for "
             f"bit ({graphed.graphs.captures} captures)")
    print(f"graphed in-graph PER super-step (k={k}, 1 capture) vs the eager "
          f"one on the card, 2 dispatches from one {cfg.num_blocks}-block "
          f"ring, state and generator seed: {drawn} sampled indices, "
          "losses, the priority slab, params, target params and Adam "
          "moments bit for bit equal (cuDNN deterministic)", flush=True)


def device_replay_run(torch, card: str, cfg, need: int) -> tuple:
    """One of phase 7's ``train()`` runs on the full ring (in-graph PER or
    host-sampled, as ``cfg.in_graph_per`` says), its checks, timings and a
    profiled super-step.  Returns the kernel's launches in the run and the
    run's timings (for phase 9's comparison).  The run's ring, learner and
    buffer are only referenced from this frame, so they are freed when it
    returns."""
    import shutil
    import tempfile
    import warnings

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.learner import learner as learner_mod
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.replay.device_ring import to_device
    from r2d2_tpu_torch.utils.trace import (
        HOST_TRANSFERS,
        KERNEL_LAUNCHES,
        RETRACES,
        RetraceGuard,
    )

    in_graph, steps, k = cfg.in_graph_per, cfg.training_steps, cfg.superstep_k
    real_build = train._build
    real_ig = learner_mod.make_in_graph_per_super_step_fn

    rec = dict(dispatches=[], start=None, leaves=[], drawn=[])

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        actor, learner, ring = (sys_["actor"], sys_["learner"],
                                sys_["ring"])
        run, loop = actor.run, learner._superstep_loop
        rec.update(sys_)

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def stamped_loop(k_, target, t0, gate, sample, harvest,
                         prepare=None, tracer=None):
            # each dispatch stamped (entry, actor iterations, exit,
            # actor iterations), without any synchronisation
            def stamped():
                t, a, c = time.perf_counter(), actor.actor_steps, host_cpu()
                out = sample()
                rec["dispatches"].append(
                    (t, a, time.perf_counter(), actor.actor_steps,
                     host_cpu(), c))
                return out
            return loop(k_, target, t0, gate, stamped, harvest,
                        prepare, tracer)

        actor.run, learner._superstep_loop = timed_run, stamped_loop
        if ring is not None and ring.cfg.in_graph_per:
            # the leaves just before and after each super-step, both
            # copied on the card under the buffer lock (per_meta and
            # put_prios run inside it)
            per_meta, put_prios = ring.per_meta, ring.put_prios

            def meta_before():
                rec["leaves"].append([ring.take_prios().clone(), None,
                                      len(rec["drawn"])])
                return per_meta()

            def prios_after(p):
                rec["leaves"][-1][1] = p.clone()
                put_prios(p)

            ring.per_meta, ring.put_prios = meta_before, prios_after
        return sys_

    def recording_ig(*args, **kw):
        # the learner's in-graph super-step, each inner step's sampled
        # indices recorded (copies of the graph's output, on the card)
        fn = real_ig(*args, **kw)

        def super_step(*a, **kw_):
            return fn(*a, record=rec["drawn"], **kw_)
        super_step.graphs = fn.graphs
        rec["super_step"] = super_step
        return super_step

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_device_ring_")
    try:
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        torch.cuda.reset_peak_memory_stats()
        train._build = capture
        learner_mod.make_in_graph_per_super_step_fn = recording_ig
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                                max_wall_seconds=DEVICE_WALL_S,
                                verbose=False)
        finally:
            train._build = real_build
            learner_mod.make_in_graph_per_super_step_fn = real_ig
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        acts = HOST_TRANSFERS.get(ACTOR_ACT)
        fetches = HOST_TRANSFERS.get("learner.result_fetch")
        put_bytes = HOST_TRANSFERS.get("learner.dispatch_put_bytes")
        ring, learner, buffer = rec["ring"], rec["learner"], rec["buffer"]
        n_disp = len(rec["dispatches"])
        mode = "in-graph PER" if in_graph else "host-sampled PER"

        # the run's checks
        fallback = [str(w.message) for w in caught
                    if "falling back" in str(w.message)
                    or "in_graph_per disabled" in str(w.message)]
        if (fallback or ring is None
                or rec["cfg"].in_graph_per != in_graph
                or ring.arrays["obs"].device.type != "cuda"):
            fail(f"{mode}: the ring was not built on the card "
                 f"({fallback})")
        if ring.nbytes() != need:
            fail(f"ring nbytes {ring.nbytes()} != data_bytes {need}")
        lh = m["learnhealth"]
        restarts = {n: h["restarts"] for n, h in m["health"].items()}
        if (m["num_updates"] != steps or n_disp * k != steps
                or lh["loss_count"] != steps or lh["nonfinite"]
                or not np.isfinite(m["mean_loss"])
                or m["fabric_failed"] or any(restarts.values())):
            fail(f"{mode}: {m['num_updates']} updates in {n_disp} "
                 f"dispatches, learnhealth {lh}, failed "
                 f"{m['fabric_failed']}, restarts {restarts}")
        if fetches != n_disp:
            fail(f"{mode}: {fetches} result fetches for {n_disp} "
                 "dispatches")
        if put_bytes / n_disp >= DISPATCH_PUT_MAX_BYTES:
            fail(f"{mode}: {put_bytes} bytes put for {n_disp} dispatches")
        if not in_graph and m["buffer_training_steps"] != k * n_disp:
            fail(f"{mode}: {m['buffer_training_steps']} priority "
                 f"feedbacks for {n_disp} dispatches")
        if launches != cfg.lstm_layers * acts or not acts or old:
            fail(f"{mode}: lstm_infer launched {launches} times "
                 f"(CUDA-core {old}) for {acts} actor acts")
        ck = Checkpointer(ckdir)
        if 16 not in ck.steps() or ck.replay_steps():
            fail(f"{mode}: checkpoints {ck.steps()}, replay snapshots "
                 f"{ck.replay_steps()}")
        scatter = ""
        if in_graph:
            drawn_n = changed_n = 0
            for before, after, first in rec["leaves"][:n_disp]:
                drawn = torch.zeros_like(before, dtype=torch.bool)
                for idx in rec["drawn"][first:first + k]:
                    drawn[idx] = True
                changed = after != before
                if (not changed.any() or (changed & ~drawn).any()
                        or (before[drawn] <= 0).any()):
                    fail("in-graph PER: the scatter changed leaves it "
                         "did not draw, or drew a zero leaf")
                drawn_n += int(drawn.sum())
                changed_n += int(changed.sum())
            padding = ring.per_meta()["seq_meta"][:, :, 1].reshape(-1) == 0
            if (ring.take_prios()[padding] != 0).any():
                fail("in-graph PER: a padding leaf became sampleable")
            scatter = (f"; scatter changed {changed_n} of {drawn_n} "
                       f"drawn leaves over {n_disp} dispatches, none "
                       "undrawn; "
                       f"{int(padding.sum())} padding/empty leaves all 0")
        print(f"device replay, {mode}, on {card}: {m['num_updates']} "
              f"updates in {n_disp} dispatches of k={k} in {run_s:.2f} s,"
              f" losses finite {lh['loss_count']}/{steps}, mean loss "
              f"{m['mean_loss']:.5f}; priority feedbacks "
              f"{m['buffer_training_steps']}; result fetches {fetches}; "
              f"dispatch puts {put_bytes} bytes "
              f"({put_bytes / n_disp:.0f} per dispatch); lstm_infer "
              f"launches {launches} = {cfg.lstm_layers} x {acts} acts, "
              f"CUDA-core {old}; checkpoints {ck.steps()}, replay "
              f"snapshots {ck.replay_steps()}{scatter}", flush=True)

        # timings, from the stamps (no synchronisation added)
        d = rec["dispatches"]
        n_env = cfg.num_actors
        t_start, a_start = rec["start"]
        fill = (d[0][1] - a_start) * n_env / (d[0][0] - t_start)
        training = ((d[-1][3] - d[0][1]) * n_env / (d[-1][2] - d[0][0]))
        gaps = np.diff([x[0] for x in d]) * 1e3
        issue = np.asarray([x[2] - x[0] for x in d]) * 1e3
        spans = m["trace"]
        hold = (f"; lock hold per dispatch (learner.dispatch_lock) p50 "
                f"{spans['span.learner.dispatch_lock.p50_ms']:.2f} ms, "
                f"mean {spans['span.learner.dispatch_lock.mean_ms']:.2f}"
                if in_graph else
                f"; gathers under the lock (learner.gather_dispatch) "
                f"mean {spans['span.learner.gather_dispatch.mean_ms']:.2f}"
                " ms")
        print(f"device replay timings, {mode}, on {card}: env steps/s "
              f"while filling {fill:.0f} ({d[0][1] - a_start} iterations"
              f" x {n_env} envs), while training {training:.0f}; "
              f"dispatch interval p50 {np.percentile(gaps, 50):.2f} ms "
              f"({len(gaps)} intervals, min {gaps.min():.2f}, max "
              f"{gaps.max():.2f}); dispatch issue p50 "
              f"{np.percentile(issue, 50):.2f} ms, first "
              f"{issue[0]:.2f}{hold}; ring {ring.nbytes() / 1e9:.2f} GB,"
              f" peak allocated {peak / 1e9:.2f} GB", flush=True)

        # the run's learner replayed its captured graphs: one capture of
        # the inner step (no diagnostics in this config)
        name = ("learner.in_graph_per_super_step" if in_graph
                else "learner.super_step")
        run_traces = (rec["super_step"].graphs.captures if in_graph
                      else RETRACES.counts().get(name))
        if run_traces != 1:
            fail(f"{mode}: {name} captured {run_traces} times in the run")

        # a lone super-step, the fabric stopped: graphed (as the run's
        # learner) against the same super-step issued eagerly
        eager_step = step_mod.make_train_step(cfg, learner.net)
        if in_graph:
            fns = [step_mod.make_in_graph_per_super_step_fn(
                cfg, learner.net, k, train_step=ts, guard=RetraceGuard())
                for ts in (None, eager_step)]
            gen = torch.Generator(device=learner.device).manual_seed(1)
            per = ring.per_meta()

            def one_super(fn):
                fn(learner.state, ring.snapshot(), ring.take_prios(),
                   per["seq_meta"], per["first"], generator=gen)
        else:
            fns = [step_mod.SuperStep(cfg, learner.net, k, train_step=ts,
                                      guard=RetraceGuard())
                   for ts in (None, eager_step)]

            def one_super(fn):
                meta = buffer.sample_meta(k)
                fn(learner.state, ring.snapshot(),
                   to_device(meta["ints"], learner.device),
                   to_device(meta["is_weights"], learner.device))
        events = profile_events(torch, lambda: one_super(fns[0]), 1)
        if events is None:
            fail(f"{mode}: no device time in a graphed super-step")
        if any("lstm_step" in name for name, _, _ in events):
            fail(f"{mode}: a super-step launched an lstm_infer kernel")
        g, e = graph_vs_eager(torch, lambda: one_super(fns[0]),
                              lambda: one_super(fns[1]), iters=1)
        # the graphed issue alone: its wall clock and the CPU time of the
        # issuing thread
        t0, c0 = time.perf_counter(), time.thread_time()
        one_super(fns[0])
        issue_ms = (time.perf_counter() - t0) * 1e3
        issue_cpu_ms = (time.thread_time() - c0) * 1e3
        torch.cuda.synchronize()
        wall = g["wall"]
        print(f"super-step ({mode}, k={k}, one alone) on {card}: "
              + fmt_graph(g, e) + "; the graphed issue "
              f"{issue_ms:.2f} ms, {issue_cpu_ms:.2f} ms of it on the CPU; "
              "no lstm_infer kernel; top 5 device ops of the graph (ms per "
              "super-step, count): "
              + "; ".join(f"{short_kernel_name(n)} {ms:.3f} ({c:.0f})"
                          for n, ms, c in events[:5]), flush=True)
        (l0, p0), (l1, p1) = d[0][4], d[-1][4]
        span = max(d[-1][2] - d[0][0], 1e-9)
        issue_cpu = np.asarray([x[4][0] - x[5][0] for x in d]) * 1e3
        print(f"learner CPU, {mode}, on {card}: a dispatch's issue p50 "
              f"{np.percentile(issue, 50):.2f} ms wall, "
              f"{np.percentile(issue_cpu, 50):.2f} ms of the learner "
              f"thread's CPU (alone: {issue_ms:.2f} ms wall, "
              f"{issue_cpu_ms:.2f} ms CPU); while training the learner "
              f"thread {(l1 - l0) / span:.2f} cores, the process "
              f"{(p1 - p0) / span:.2f}", flush=True)
        return launches, dict(
            issue_ms=issue_ms, issue_cpu_ms=issue_cpu_ms,
            eager_super_ms=e["wall"], device_ms=g["device"],
            eager_device_ms=e["device"],
            issue_p50=float(np.percentile(issue, 50)),
            issue_cpu_p50=float(np.percentile(issue_cpu, 50)),
            interval_p50=float(np.percentile(gaps, 50)),
            hold_p50=(spans["span.learner.dispatch_lock.p50_ms"]
                      if in_graph else None),
            fill=fill, training=training, super_ms=wall,
            peak_gb=peak / 1e9, seconds=run_s,
            learner_cores=(l1 - l0) / span, trainer_cores=(p1 - p0) / span,
            children_cores=None)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def phase_device_replay(torch, card: str) -> tuple:
    """Phase 7: the Pong preset trained by ``train()`` from its full replay
    ring on the card, with in-graph PER and then host-sampled.  Returns
    the kernel's launches over both runs and the in-graph run's timings."""
    import gc

    from r2d2_tpu_torch.config import pong_config
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    base = pong_config(game_name="Fake")
    literal = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                   hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                   batch_size=64, burn_in_steps=40, learning_steps=40,
                   forward_steps=5, block_length=400, num_actors=64,
                   env_workers=8, device_replay=True, in_graph_per=True,
                   superstep_k=4, superstep_pipeline=2,
                   buffer_capacity=2_000_000)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"pong_config(game_name='Fake') is not the Pong preset: {got}")
    need = data_bytes(base, TRAIN_ACTIONS)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in DEVICE_REDUCED.items())
        + ", training_steps " + " then ".join(
            f"{n} (in_graph_per={igp})" for igp, n in DEVICE_RUNS)
        + f"; the full ring on the card ({base.num_blocks} blocks of "
        f"{base.block_length}, {need / 1e9:.2f} GB); fake env episodes of "
        f"{FAKE_EPISODE_LEN} steps, {TRAIN_ACTIONS} actions", flush=True)
    device_ring_checks(torch, base)
    launches, timings = 0, {}
    for in_graph, steps in DEVICE_RUNS:
        n, timings[in_graph] = device_replay_run(
            torch, card, base.replace(in_graph_per=in_graph,
                                      training_steps=steps, **DEVICE_REDUCED),
            need)
        launches += n
        # the next run builds its own 15.8 GB ring; this one's went with
        # the run's frame
        gc.collect()
        torch.cuda.empty_cache()
    MESHLESS["host_sampled_interval_p50"] = timings[False]["interval_p50"]
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return launches, timings[True]


def anakin_draws(torch, n_lanes: int, steps: int, seed: int):
    """Seeded exploration and reset draws for ``steps`` actor steps of
    ``n_lanes`` lanes, and the initial reset's, as ``make_debug_rollout``
    takes them: the card and the CPU walk one trajectory from them."""
    rng = np.random.default_rng(seed)

    def ints():
        return torch.from_numpy(
            rng.integers(0, TRAIN_ACTIONS, n_lanes).astype(np.int32))

    draws = [dict(u=torch.from_numpy(rng.random(n_lanes).astype(np.float32)),
                  rand_a=ints(), reset=dict(phase=ints()))
             for _ in range(steps)]
    return draws, dict(phase=ints())


def anakin_card_vs_cpu(torch, base) -> dict:
    """One fused rollout of the fake env at ``base_eps = 1`` (every action
    an injected draw), bf16 on the card against f32 on the CPU from the
    same state, params and draws, on a ring of 16 blocks at the full slot
    shapes: bytes, actions, integer fields, ``n_step_gamma`` and the PER
    metadata identical; q, hiddens and priorities within
    ``ANAKIN_CARD_CPU_TOL``."""
    from r2d2_tpu_torch.envs.anakin import make_anakin_env
    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    cfg = base.replace(anakin_env="fake", base_eps=1.0,
                       buffer_capacity=16 * base.block_length,
                       learning_starts=base.block_length,
                       device_replay=True, in_graph_per=True)
    draws, init = anakin_draws(torch, cfg.num_actors, ANAKIN_ROLL_STEPS, 21)
    params = create_network(cfg, TRAIN_ACTIONS, device="cpu",
                            generator=torch.Generator().manual_seed(9)
                            ).state_dict()
    out = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        c = cfg.replace(compute_dtype=dtype)

        def on(d, dev=dev):
            return {k: v.to(dev) for k, v in d.items()}

        env = make_anakin_env(c, TRAIN_ACTIONS, device=dev)
        ring = DeviceRing(c, TRAIN_ACTIONS, device=dev)
        ast = anakin.make_anakin_state(c, TRAIN_ACTIONS, env, 77,
                                       draws=on(init))
        meta = ring.per_meta()
        roll = anakin.make_debug_rollout(
            c, create_network(c, TRAIN_ACTIONS, device=dev), env,
            TRAIN_ACTIONS, ANAKIN_ROLL_STEPS)
        (ast, arrays, prios, seq_meta, first), tr = roll(
            on(params), ast, ring.snapshot(), ring.take_prios(),
            meta["seq_meta"], meta["first"],
            draws=[dict(u=d["u"].to(dev), rand_a=d["rand_a"].to(dev),
                        reset=on(d["reset"])) for d in draws])
        out[dev] = {**{f"state_{k}": v for k, v in ast.items()},
                    **{f"ring_{k}": v for k, v in arrays.items()},
                    **{f"trace_{k}": v for k, v in tr.items()},
                    "per_prios": prios, "per_seq_meta": seq_meta,
                    "per_first": first}
        out[dev] = {k: v.cpu() for k, v in out[dev].items()}
    card, cpu = out["cuda"], out["cpu"]
    close = ("state_hidden", "state_buf_hidden", "state_buf_qval",
             "ring_hidden", "trace_q", "trace_hidden", "per_prios")
    errs, differ = {}, []
    for k in cpu:
        if k in ("state_env_key", "state_act_key") or k in close:
            continue
        if k == "ring_n_step_reward":
            errs[k] = float((card[k] - cpu[k]).abs().max())
        elif not torch.equal(card[k], cpu[k]):
            differ.append(k)
    for k in close:
        errs[k] = float((card[k] - cpu[k]).abs().max())
    blocks = int(cpu["state_blocks_d"])
    print(f"anakin rollout, bf16 card vs f32 CPU ({ANAKIN_ROLL_STEPS} steps "
          f"x {cfg.num_actors} lanes of the fake env, base_eps 1, the same "
          f"draws; {blocks} blocks cut into a {cfg.num_blocks}-block ring "
          "at the full slot shapes): obs bytes, actions, integer fields, "
          "n_step_gamma and PER metadata equal; max-abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {ANAKIN_CARD_CPU_TOL:.0e}; n_step_reward 1e-6)",
          flush=True)
    if differ:
        fail(f"anakin rollout: the card and the CPU differ in {differ}")
    if (errs.pop("ring_n_step_reward") > 1e-6 or blocks < cfg.num_actors
            or max(errs.values()) > ANAKIN_CARD_CPU_TOL):
        fail(f"anakin rollout: card vs CPU {errs}, {blocks} blocks")
    return errs


def anakin_copies(plane) -> tuple:
    """Copies of a plane's carry, ring arrays, PER leaves, ``seq_meta``
    and ``first``, in the entries' argument order."""
    arrays, prios, seq_meta, first = plane._handles()
    return ({k: v.clone() for k, v in plane.state.items()},
            {k: v.clone() for k, v in arrays.items()}, prios.clone(),
            seq_meta.clone(), first.clone())


def anakin_differs(torch, plane, want) -> list:
    """The names of the plane's tensors that differ from ``want`` (an
    eager entry's carry, arrays, leaves, ``seq_meta`` and ``first``)."""
    ast, arrays, prios, seq_meta, first = want
    got = anakin_copies(plane)
    return ([f"state_{k}" for k in ast if not torch.equal(got[0][k], ast[k])]
            + [f"ring_{k}" for k in arrays
               if not torch.equal(got[1][k], arrays[k])]
            + [n for n, a, b in (("per_prios", got[2], prios),
                                 ("per_seq_meta", got[3], seq_meta),
                                 ("per_first", got[4], first))
               if not torch.equal(a, b)])


def anakin_graph_checks(torch, card: str, base) -> dict:
    """The meshless anakin entries' CUDA graphs on a ring of
    ``ANAKIN_CHECK_BLOCKS`` blocks at the full slot shapes, cuDNN
    deterministic: the rollout captured at the first rollout and held bit
    for bit to the eager rollout from copies of the same carry, ring and
    PER state at the next two; the super-step captured at dispatches 0
    (the eval lane on) and 1 (off) and held bit for bit to the eager
    dispatch from copies of the same carry, ring, PER state, train state
    and index at dispatches 2, 3 and 4 (the eval lane on at 2 and 4): the
    result vector, the carry, the ring, the leaves, ``seq_meta``,
    ``first`` and the train state: the bitwise repeat.  The resume: the
    loop state written between dispatches 2 and 3 and read into a plane
    of other params, whose dispatch 3 from the saved train state equals
    the plane's own, payload and train state bit for bit.  One capture of
    the rollout, two of the super-step.  Then a lone rollout and a lone
    training dispatch, each graphed against eager (``graph_vs_eager``)."""
    import shutil
    import tempfile

    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.graphs import _clone_state
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    cuda = torch.device("cuda", torch.cuda.current_device())
    cfg = base.replace(
        buffer_capacity=ANAKIN_CHECK_BLOCKS * base.block_length,
        learning_starts=ANAKIN_CHECK_STARTS, device_replay=True,
        in_graph_per=True, **{k: v for k, v in ANAKIN_REDUCED.items()
                              if k != "learning_starts"})
    net = create_network(cfg, TRAIN_ACTIONS, device=cuda,
                         generator=torch.Generator().manual_seed(5))
    plane = AnakinPlane(cfg, net, TRAIN_ACTIONS,
                        DeviceRing(cfg, TRAIN_ACTIONS, device=cuda))
    learner = Learner(cfg, net, create_train_state(cfg, net.state_dict()))
    eager_roll = anakin.make_anakin_rollout(
        cfg, net, plane.env, TRAIN_ACTIONS, plane.roll_steps)
    eager_step = anakin.make_anakin_super_step(cfg, net, plane.env,
                                               TRAIN_ACTIONS)
    bad, held, resumed = [], [], False
    snap = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_anakin_"),
                        "anakin.bin")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for r in range(3):
            want = (eager_roll(learner.state.params, *anakin_copies(plane))
                    if r else None)
            out = plane.rollout(learner.state.params, plane.state,
                                *plane._handles())
            plane._absorb(out[-1].cpu().numpy())
            if want is not None:
                differ = anakin_differs(torch, plane, want[:5])
                if differ or not torch.equal(out[-1], want[-1]):
                    bad.append(f"rollout {r}: {differ}")
                held.append(f"rollout {r}")
        if not plane.ready:
            bad.append(f"not ready after 3 rollouts: fill {plane.fill}")
        for d in range(5):
            if d == 3:
                # the resume's snapshot, between dispatches 2 and 3
                meta = plane.write_state(snap)
                saved = _clone_state(learner.state)
            copies, twin = anakin_copies(plane), _clone_state(learner.state)
            learner.state, *rest = plane.super_step(
                learner.state, plane.state, *plane._handles(), d)
            if d == 3:
                after = (plane._payload(), _clone_state(learner.state))
            if d < 2:
                continue
            want = eager_step(twin, *copies, d)
            differ = anakin_differs(torch, plane, want[1:6])
            if not torch.equal(rest[-1], want[-1]):
                differ.append("flat")
            if not states_equal(torch, learner.state, want[0]):
                differ.append("train state")
            if differ:
                bad.append(f"dispatch {d}: {differ}")
            held.append(f"dispatch {d}"
                        + (" (eval)" if d % cfg.anakin_eval_interval == 0
                           else ""))
        # the resume: a plane of other params restored from the snapshot
        # dispatches 3 from the saved train state as the plane did
        other = AnakinPlane(cfg, create_network(
            cfg, TRAIN_ACTIONS, device=cuda,
            generator=torch.Generator().manual_seed(6)), TRAIN_ACTIONS,
            DeviceRing(cfg, TRAIN_ACTIONS, device=cuda))
        other.read_state(snap, meta)
        saved, *_ = other.super_step(saved, other.state, *other._handles(),
                                     3)
        payload = other._payload()
        resumed = (sorted(payload) == sorted(after[0])
                   and all(np.array_equal(payload[k], after[0][k])
                           for k in payload)
                   and states_equal(torch, saved, after[1]))
        del other
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = was
        shutil.rmtree(os.path.dirname(snap), ignore_errors=True)
    captures = dict(rollout=plane.rollout.graphs.captures,
                    super_step=plane.super_step.graphs.captures)
    if bad or not resumed or captures != dict(rollout=1, super_step=2):
        fail(f"anakin graphs against the eager entries: {bad}; resumed "
             f"bitwise {resumed}; captures {captures}")
    print(f"anakin graphs on {card} (the README's widths, a "
          f"{cfg.num_blocks}-block ring at the full slot shapes, cuDNN "
          f"deterministic for the check): captured at rollout 0 and "
          f"dispatches 0 (eval) and 1; {', '.join(held)} replayed bit for "
          "bit the eager entries from copies of the same carry, ring, "
          "leaves, seq_meta, first, train state and index (result vector, "
          f"carry, ring, PER state, params, Adam moments, counters): the "
          f"bitwise repeat; snapshot after dispatch 2 -> restore into a "
          f"plane of other params -> dispatch 3 equal to the plane's own "
          f"dispatch 3 (its {len(payload)} payload arrays and the train "
          f"state): {resumed}; captures {captures}", flush=True)

    state = {"d": 5}

    def graphed_dispatch():
        # odd indices: the eval lane off in both timed entries
        state["d"] += 2
        learner.state, *rest = plane.super_step(
            learner.state, plane.state, *plane._handles(), state["d"])
        return rest[-1]

    def eager_dispatch():
        state["d"] += 2
        return eager_step(learner.state, plane.state, *plane._handles(),
                          state["d"])[-1]

    out = {}
    for name, graphed, eager in (
            ("rollout", lambda: plane.rollout(
                learner.state.params, plane.state, *plane._handles()),
             lambda: eager_roll(learner.state.params, plane.state,
                                *plane._handles())),
            ("training dispatch", graphed_dispatch, eager_dispatch)):
        g, e = graph_vs_eager(torch, graphed, eager, iters=1)
        out[name] = dict(graphed=g, eager=e)
        if g["lstm"] or e["lstm"]:
            fail(f"anakin: a {name} launched {g['lstm'] + e['lstm']}")
        print(f"anakin {name} alone on {card} (graphed vs eager, the "
              f"{cfg.num_blocks}-block ring): " + fmt_graph(g, e)
              + "; no lstm_infer kernel; the graph's top 5 device ops (ms, "
              "count): " + "; ".join(
                  f"{short_kernel_name(n, 60)} {ms:.3f} ({c:.0f})"
                  for n, ms, c in g["top"]), flush=True)
    if plane.super_step.graphs.captures != 2 or \
            plane.rollout.graphs.captures != 1:
        fail("anakin: the timed entries captured again")
    return out


def anakin_run(torch, card: str, cfg, ckdir: str, need: int,
               resume: bool, prior=None) -> dict:
    """One ``train()`` run of phase 8 on its cut ring, its invariants and
    timings.  Returns the counters and numbers; the run's ring is only
    referenced from this frame, so it is freed when it returns."""
    from collections import deque

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    k, N = cfg.superstep_k, cfg.num_actors
    fetches = "anakin.result_fetch"
    real_loop = anakin.run_anakin_loop
    rec = dict(rollouts=[], dispatches=[], harvests=[], bad=[],
               sync_checked=None)

    def loop(learner, plane, **kw):
        rec.update(learner=learner, plane=plane, start={
            f: getattr(plane, f) for f in plane._COUNTER_FIELDS})
        roll, disp, harv = plane.rollout_step, plane.dispatch, plane.harvest
        pending = deque()

        def rollout_step(params):
            f0, t = HOST_TRANSFERS.get(fetches), time.perf_counter()
            roll(params)
            rec["rollouts"].append((t, time.perf_counter()))
            if HOST_TRANSFERS.get(fetches) - f0 != 1:
                rec["bad"].append("a rollout did not fetch once")

        def dispatch(state):
            pending.append(plane.dispatch_no)
            t = time.perf_counter()
            if not resume and len(rec["dispatches"]) == 2:
                # one training dispatch under the sync debug mode: any
                # device->host synchronisation in it raises
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = disp(state)
                except RuntimeError as e:
                    rec["sync_checked"] = repr(e)
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                rec["sync_checked"] = "clean"
            else:
                out = disp(state)
            rec["dispatches"].append((t, time.perf_counter()))
            return out

        def harvest(result):
            f0, e0 = HOST_TRANSFERS.get(fetches), plane.eval_episodes_total
            losses = harv(result)
            idx = pending.popleft()
            want = N if idx % cfg.anakin_eval_interval == 0 else 0
            if HOST_TRANSFERS.get(fetches) - f0 != 1:
                rec["bad"].append(f"dispatch {idx} did not fetch once")
            if plane.eval_episodes_total - e0 != want:
                rec["bad"].append(f"dispatch {idx}: eval episodes "
                                  f"{plane.eval_episodes_total - e0} != "
                                  f"{want}")
            if len(losses) != k or not np.isfinite(losses).all():
                rec["bad"].append(f"dispatch {idx}: losses {losses}")
            rec["harvests"].append(time.perf_counter())
            return losses

        plane.rollout_step, plane.dispatch = rollout_step, dispatch
        plane.harvest = harvest
        return real_loop(learner, plane, **kw)

    plane_cls = anakin.AnakinPlane
    real_write, real_read = plane_cls.write_state, plane_cls.read_state

    def timed(fn, key):
        def run(self, *a):
            t = time.perf_counter()
            out = fn(self, *a)
            rec[key] = time.perf_counter() - t
            return out
        return run

    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    torch.cuda.reset_peak_memory_stats()
    anakin.run_anakin_loop = loop
    plane_cls.write_state = timed(real_write, "write_s")
    plane_cls.read_state = timed(real_read, "read_s")
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, checkpoint_dir=ckdir, resume=resume,
                        max_wall_seconds=ANAKIN_WALL_S, verbose=False,
                        device="cuda")
    except RuntimeError as e:
        fail(f"anakin run: {e} (sync debug check: {rec['sync_checked']})")
    finally:
        anakin.run_anakin_loop = real_loop
        plane_cls.write_state, plane_cls.read_state = real_write, real_read
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = (KERNEL_LAUNCHES.get(lstm.KERNEL)
                + KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER))
    plane, learner = rec["plane"], rec["learner"]
    ring = plane.ring
    n_roll, n_disp = len(rec["rollouts"]), len(rec["dispatches"])
    snaps = 1 if cfg.replay_snapshot else 0
    counters = {f: getattr(plane, f) for f in plane._COUNTER_FIELDS}
    blt = int(plane.state["block_learning_total"].sum())
    what = "resumed" if resume else "first"

    # the run's checks
    bad = list(rec["bad"])
    start_updates = 0 if prior is None else prior["training_steps"]
    if (m["num_updates"] != cfg.training_steps
            or n_disp * k != cfg.training_steps - start_updates
            or m["dispatch_wedged"] or m["fabric_failed"]
            or m["healthz"].get("status") != "ok"):
        bad.append(f"{m['num_updates']} updates in {n_disp} dispatches, "
                   f"wedged {m['dispatch_wedged']}, failed "
                   f"{m['fabric_failed']}, healthz {m['healthz']}")
    if not resume and rec["sync_checked"] != "clean":
        bad.append(f"sync debug check {rec['sync_checked']}")
    if (HOST_TRANSFERS.get(fetches) != n_roll + n_disp
            or HOST_TRANSFERS.get("anakin.snapshot_fetch") != snaps):
        bad.append(f"transfers {HOST_TRANSFERS.snapshot()} for {n_roll} "
                   f"rollouts, {n_disp} dispatches, {snaps} snapshots")
    if plane.fill != blt or plane.fill < cfg.learning_starts:
        bad.append(f"fill {plane.fill} != block_learning_total sum {blt}")
    if (ring.arrays["obs"].device.type != "cuda"
            or ring.nbytes() != need):
        bad.append(f"ring {ring.nbytes()} bytes on "
                   f"{ring.arrays['obs'].device} (data_bytes {need})")
    if launches:
        bad.append(f"lstm_infer launched {launches} times")
    eval_disp = sum(1 for i in range(counters["dispatch_no"] - n_disp,
                                     counters["dispatch_no"])
                    if i % cfg.anakin_eval_interval == 0)
    if not eval_disp:
        bad.append("the eval lane never fired")
    if prior is not None:
        if not m["restored_replay"] or rec["start"] != prior:
            bad.append(f"resume restored {m['restored_replay']}: counters "
                       f"{rec['start']} != the snapshot's {prior}")
        if any(counters[f] < prior[f] for f in prior) or not (
                counters["env_steps"] > prior["env_steps"]):
            bad.append(f"counters not monotone: {prior} -> {counters}")
    ck = Checkpointer(ckdir)
    if cfg.training_steps not in ck.steps() or (
            snaps and ck.replay_steps()[-1:] != [cfg.training_steps]):
        bad.append(f"checkpoints {ck.steps()}, snapshots "
                   f"{ck.replay_steps()}")
    if bad:
        fail(f"anakin ({what} run): " + "; ".join(bad))

    fpd = plane.roll_steps * N
    r, d = rec["rollouts"], rec["dispatches"]
    fill_fps = (n_roll * fpd / (r[-1][1] - r[0][0])) if n_roll else None
    gaps = np.diff([x[0] for x in d]) * 1e3
    train_fps = (n_disp - 1) * fpd / (d[-1][0] - d[0][0])
    issue = np.asarray([x[1] - x[0] for x in d]) * 1e3
    print(f"anakin {what} run on {card}: {m['num_updates']} updates in "
          f"{n_disp} dispatches of k={k} x "
          f"(E={cfg.anakin_env_steps_per_update} steps of {N} lanes + 1 "
          f"train step) after {n_roll} "
          f"rollouts, {run_s:.2f} s; result fetches "
          f"{HOST_TRANSFERS.get(fetches)} = {n_roll} + {n_disp}, snapshot "
          "fetches "
          f"{HOST_TRANSFERS.get('anakin.snapshot_fetch')}; "
          + ("" if resume else "dispatch 2 under set_sync_debug_mode("
             "'error'): clean; ")
          + f"losses finite {k}/dispatch, "
          f"mean {m['mean_loss']:.5f}; eval episodes {N} on each of "
          f"{eval_disp} eval dispatches (mean greedy return "
          f"{m['mean_eval_return']:.3f}); fill {plane.fill} = sum of "
          f"block_learning_total; env steps {counters['env_steps']}, "
          f"episodes {counters['episodes_total']} (mean return "
          f"{m['mean_episode_return']:.3f}); lstm_infer launches {launches}"
          + ("" if prior is None else
             f"; resumed from the snapshot's counters {prior}, monotone"),
          flush=True)
    print(f"anakin {what} run timings on {card}: env frames/s while "
          f"filling {'none' if fill_fps is None else f'{fill_fps:.1f}'}, "
          f"while training {train_fps:.1f}; dispatch interval p50 "
          f"{np.percentile(gaps, 50):.2f} ms ({len(gaps)} intervals, min "
          f"{gaps.min():.2f}, max {gaps.max():.2f}); dispatch issue p50 "
          f"{np.percentile(issue, 50):.2f} ms, first {issue[0]:.2f}; ring "
          f"{ring.nbytes() / 1e9:.2f} GB, peak allocated "
          f"{peak / 1e9:.2f} GB; full-state snapshot "
          + (f"read {rec['read_s']:.1f} s" if resume
             else f"written {rec['write_s']:.1f} s"), flush=True)
    out = dict(counters=counters, run_s=run_s, fill_fps=fill_fps,
               snapshot_s=rec["read_s" if resume else "write_s"],
               train_fps=train_fps, interval_p50=float(np.percentile(gaps,
                                                                     50)),
               peak_gb=peak / 1e9, launches=launches)
    return out


def phase_anakin(torch, card: str) -> int:
    """Phase 8: the README's anakin config at full width, trained from a
    ring of ``ANAKIN_RING`` transitions by ``train()``, resumed; before it, the fused rollout card
    vs CPU and the determinism and snapshot checks.  Returns the kernel's
    launches over the phase's main path (0: the anakin actor acts through
    the scan recurrence, as JAX's does)."""
    import gc
    import shutil
    import tempfile

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    # a stuck phase dumps every thread's stack to stderr before the
    # caller's time limit cuts it
    faulthandler.dump_traceback_later(ANAKIN_WATCHDOG_S)
    base = Config(game_name="Fake", actor_transport="anakin",
                  anakin_env="grid")
    literal = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                   hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                   batch_size=64, burn_in_steps=40, learning_steps=40,
                   forward_steps=5, block_length=400, num_actors=8,
                   superstep_k=8, anakin_env_steps_per_update=4,
                   anakin_episode_len=32, superstep_pipeline=1,
                   buffer_capacity=2_000_000)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"the README's anakin Config is not the flagship: {got}")
    run_base = base.replace(buffer_capacity=ANAKIN_RING)
    need = data_bytes(run_base.replace(device_replay=True,
                                       in_graph_per=True), TRAIN_ACTIONS)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in ANAKIN_REDUCED.items())
        + f", training_steps {base.training_steps} -> {ANAKIN_STEPS} (6 "
        f"dispatches), resumed to {ANAKIN_RESUME_STEPS} with replay_snapshot"
        f" off (no second snapshot); buffer_capacity {base.buffer_capacity}"
        f" -> {ANAKIN_RING} on the card ({run_base.num_blocks} blocks of "
        f"{base.block_length}, {need / 1e9:.2f} GB); grid env episodes of "
        f"{base.anakin_episode_len} steps, {TRAIN_ACTIONS} actions; the "
        f"graph checks' warm-up {ANAKIN_CHECK_STARTS} transitions",
        flush=True)
    anakin_card_vs_cpu(torch, base)
    anakin_graph_checks(torch, card, base)
    gc.collect()
    torch.cuda.empty_cache()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_anakin_")
    try:
        first = anakin_run(torch, card, run_base.replace(
            training_steps=ANAKIN_STEPS, **ANAKIN_REDUCED), ckdir, need,
            resume=False)
        gc.collect()
        torch.cuda.empty_cache()
        second = anakin_run(torch, card, run_base.replace(
            training_steps=ANAKIN_RESUME_STEPS, replay_snapshot=False,
            **ANAKIN_REDUCED), ckdir, need, resume=True,
            prior=first["counters"])
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return first["launches"] + second["launches"]


def unsteady_request(i: int, cfg) -> bool:
    """Whether a fleet's ``i``-th act request (1-based) is its first (the
    fleets come up seconds apart) or follows an iteration in which its
    lanes cut blocks: all its lanes run in step, so all of them cut at a
    block boundary (the cut is deferred to the next iteration) and at an
    episode's end, and the fleet writes every block into its 4 slots —
    waiting for the trainer's ingest — before it posts the next request.
    One request of slack after each."""
    t = (i - 1) % FAKE_EPISODE_LEN
    return (i == 1 or (t in (0, 1) and i > 2)
            or (t >= cfg.block_length and t % cfg.block_length in (1, 2)))


def host_cpu() -> tuple:
    """CPU seconds of the calling thread (the learner's, in a dispatch
    stamp) and of this process over all its threads."""
    return time.thread_time(), time.process_time()


def pct(xs, q) -> float:
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def process_run(torch, card: str, cfg, need: int) -> dict:
    """One of phase 9's ``train()`` runs (the inference mode is
    ``cfg.actor_inference``): the plane's checks and timings.  Returns the
    kernel's launches in the run and its timings.  The run's ring and
    plane are freed when it returns."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    mode, steps, k = cfg.actor_inference, cfg.training_steps, cfg.superstep_k
    real_build = train._build
    rec = dict(dispatches=[], acts=[], probe=None, smi=None, pumps=[],
               reported=[])
    done = threading.Event()

    def probe(plane):
        # fleet reports (pid, CUDA context, JAX, threads, RPC round trips)
        # and the card's compute processes, while the fleets run; a fleet
        # answers between its bursts, or in its shutdown handshake
        pids = [p.pid for p in plane.procs]
        asked = threading.Thread(target=lambda: rec.__setitem__(
            "probe", plane.probe_fleets(timeout=120)), daemon=True)
        asked.start()
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        rec["smi"] = (smi.returncode, smi.stdout.split(), pids)
        asked.join(130)

    def fleet_versions(plane) -> list:
        return [int(r.get("param_version", 0))
                for r in plane.poll_fleet_stats()["per_fleet"]]

    def sampler(sys_):
        # the probe, two dispatches before the run's end; in local mode
        # each fleet's reported pump version, as it changes
        plane, learner = sys_["plane"], sys_["learner"]
        prober, seen, polled = None, None, 0.0
        while not done.is_set():
            if prober is None and learner.num_updates >= steps - 2 * k:
                prober = threading.Thread(target=probe, args=(plane,),
                                          daemon=True)
                prober.start()
            if mode == "local" and time.perf_counter() - polled > 0.25:
                polled = time.perf_counter()
                now = fleet_versions(plane)
                if now != seen:
                    rec["reported"].append((polled, now))
                    seen = now
            time.sleep(0.05)
        if prober is not None:
            prober.join(150)

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        learner, plane = sys_["learner"], sys_["plane"]
        rec.update(sys_)
        loop = learner._superstep_loop

        def stamped_loop(k_, target, t0, gate, sample, harvest,
                         prepare=None, tracer=None):
            def stamped():
                if mode == "local" and len(rec["dispatches"]) == (
                        steps // k - 1):
                    # before the last dispatch, while the pump runs: a
                    # fleet reports the version of its last decoded pump
                    # in the stats it publishes after each 256-step burst
                    # of CPU acts, so a report may lag the pump by seconds
                    # (ROADMAP C, phase 9's watch line); wait, bounded,
                    # until every fleet has reported a pump past the first
                    t_w, v0 = time.perf_counter(), fleet_versions(plane)
                    while (min(fleet_versions(plane)) < 2
                           and time.perf_counter() - t_w < PUMP_WAIT_S):
                        time.sleep(0.1)
                    rec["pump_wait"] = (time.perf_counter() - t_w, v0,
                                        fleet_versions(plane))
                t, c = time.perf_counter(), host_cpu()
                out = sample()
                rec["dispatches"].append((t, time.perf_counter(),
                                          host_cpu(), c))
                return out
            return loop(k_, target, t0, gate, stamped, harvest, prepare,
                        tracer)

        learner._superstep_loop = stamped_loop
        pump = plane.pump_params_once

        def stamped_pump():
            pumped = pump()
            if pumped:
                rec["pumps"].append((time.perf_counter(),
                                     plane._pumped_version))
            return pumped

        plane.pump_params_once = stamped_pump
        svc = plane.service
        if svc is not None:
            act = svc._act_batch

            def timed_act(hidden_in, name):
                # the batch's fleets and the act's host time (H2D, act,
                # D2H: the serve.act span), without any added sync
                pend = sorted(svc._pending)
                t = time.perf_counter()
                out = act(hidden_in, name)
                rec["acts"].append((t, time.perf_counter() - t, pend))
                return out

            svc._act_batch = timed_act
        t = threading.Thread(target=sampler, args=(sys_,), daemon=True)
        t.start()
        rec["sampler"] = t
        return sys_

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_fleets_")
    try:
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        torch.cuda.reset_peak_memory_stats()
        train._build = capture
        t0 = time.perf_counter()
        try:
            m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                            max_wall_seconds=PROCESS_WALL_S, verbose=False)
        finally:
            train._build = real_build
            done.set()
            if "sampler" in rec:
                rec["sampler"].join(160)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        transfers = HOST_TRANSFERS.snapshot()
        plane, ring, buffer = rec["plane"], rec["ring"], rec["buffer"]
        svc = plane.service
        fleet = m["fleet_health"]
        n_disp = len(rec["dispatches"])
        F = plane.num_fleets

        # the run's checks, both modes
        if (ring is None or not rec["cfg"].in_graph_per
                or ring.arrays["obs"].device.type != "cuda"
                or ring.nbytes() != need):
            fail(f"{mode}: the ring was not built on the card at "
                 f"data_bytes {need}")
        lh = m["learnhealth"]
        restarts = {n: h["restarts"] for n, h in m["health"].items()}
        if (m["num_updates"] != steps or n_disp * k != steps
                or lh["loss_count"] != steps or lh["nonfinite"]
                or not np.isfinite(m["mean_loss"])
                or m["buffer_training_steps"] != k * n_disp
                or m["fabric_failed"] or any(restarts.values())):
            fail(f"{mode}: {m['num_updates']} updates in {n_disp} "
                 f"dispatches, {m['buffer_training_steps']} priority "
                 f"feedbacks, learnhealth {lh}, failed "
                 f"{m['fabric_failed']}, thread restarts {restarts}")
        wrapped = plane.blocks_ingested > cfg.num_blocks
        if (buffer.env_steps != plane.frames_ingested
                or (not wrapped and len(buffer) != plane.frames_ingested)
                or buffer.blocks_per_member.get(0) != plane.blocks_ingested):
            fail(f"{mode}: fill {len(buffer)}, {buffer.env_steps} added, "
                 f"for {plane.frames_ingested} transitions in "
                 f"{plane.blocks_ingested} ingested blocks")
        res = fleet["resilience"]
        if (plane.blocks_corrupt or buffer.corrupt_blocks
                or any(fleet["restarts"]) or res["circuits_open"]
                or res["circuit_opens"] or res["local_acts"]
                or res["degraded"]):
            fail(f"{mode}: corrupt blocks {plane.blocks_corrupt}, fleet "
                 f"restarts {fleet['restarts']}, resilience {res}")
        hz = m["healthz"]
        if hz.get("status") != "ok" or hz["fleet"]["alive"] != F:
            fail(f"{mode}: /healthz {hz.get('status')}, fleet "
                 f"{hz.get('fleet')}")
        reports = rec["probe"] or []
        if (len(reports) != F or any(r is None for r in reports)
                or any(r["cuda_initialized"] or r["jax_loaded"]
                       or r["r2d2_tpu_loaded"] or not len(r["act_times"])
                       for r in reports)):
            fail(f"{mode}: fleet reports {reports}")
        smi_rc, smi_pids, child_pids = rec["smi"]
        if smi_rc != 0 or len(smi_pids) > 1 or (
                set(smi_pids) & {str(p) for p in child_pids}):
            fail(f"{mode}: nvidia-smi compute apps {smi_pids} (rc "
                 f"{smi_rc}); trainer {os.getpid()}, fleets {child_pids}")
        rows = fleet["stats"]["per_fleet"]
        env_steps = sum(r["env_steps"] for r in rows)
        versions = [int(r["param_version"]) for r in rows]
        if mode == "serve":
            h = svc.health()
            want = cfg.lstm_layers * (h["batches"] + h["warmups"])
            drain = h["lanes_served"] - env_steps
            if (launches != want or old
                    or transfers.get("serve.act_fetch") != h["batches"]
                    or transfers.get("serve.act_put")
                    != h["batches"] + h["warmups"]
                    or not 0 <= drain <= cfg.num_actors
                    or h["requests_corrupt"] or h["resyncs"]):
                fail(f"serve: lstm_infer launched {launches} times "
                     f"(CUDA-core {old}) for {h['batches']} batches + "
                     f"{h['warmups']} warm-up x {cfg.lstm_layers} layer; "
                     f"transfers {transfers}; {h['lanes_served']} lanes "
                     f"served for {env_steps:.0f} env steps; service {h}")
        else:
            drain = None
            print(f"local pumps on {card}: " + pump_timeline(rec, F),
                  flush=True)
            if launches or old or min(versions) < 2:
                fail(f"local: lstm_infer launched {launches} times "
                     f"(CUDA-core {old}) in the trainer; fleets' pumped "
                     f"versions {versions}")
        threads = sorted({r["num_threads"] for r in reports})
        print(f"process fleets, {mode} mode, on {card}: {m['num_updates']} "
              f"updates in {n_disp} dispatches of k={k} in {run_s:.2f} s, "
              f"losses finite {lh['loss_count']}/{steps}, mean loss "
              f"{m['mean_loss']:.5f}; priority feedbacks "
              f"{m['buffer_training_steps']}; fill {len(buffer)} = "
              f"{plane.frames_ingested} transitions in "
              f"{plane.blocks_ingested} blocks; corrupt 0, fleet restarts "
              f"{fleet['restarts']}, circuits {res['circuit_states']}, "
              f"opens 0, local acts 0, /healthz ok; fleets' pumped "
              f"versions {versions}; children: no CUDA context, no JAX, "
              f"{threads} torch threads each of os.cpu_count() "
              f"{reports[0]['cpu_count']}; nvidia-smi compute apps "
              f"{smi_pids} (trainer pid {os.getpid()}); ring "
              f"{ring.nbytes() / 1e9:.2f} GB on the card", flush=True)
        if mode == "serve":
            print(f"serve mode launches on {card}: lstm_infer {launches} = "
                  f"{cfg.lstm_layers} x ({h['batches']} batches + "
                  f"{h['warmups']} warm-up), CUDA-core {old}; serve."
                  f"act_fetch {transfers.get('serve.act_fetch')}, serve."
                  f"act_put {transfers.get('serve.act_put')}; lanes served "
                  f"{h['lanes_served']} = the fleets' env steps "
                  f"{env_steps:.0f} + {drain:.0f} served in the drain; "
                  f"peeks {h['peeks']}, stale {h['stale_requests']}",
                  flush=True)

        # timings, from the stamps (no synchronisation added): the
        # dispatches', the service's acts and each fleet's own acts, which
        # its report carries as (wall-clock end, seconds) rows
        d = rec["dispatches"]
        wall = time.time() - time.perf_counter()
        t_first, t_last = d[0][0] + wall, d[-1][1] + wall
        gaps = np.diff([x[0] for x in d]) * 1e3
        issue = np.asarray([x[1] - x[0] for x in d]) * 1e3
        spans = m["trace"]
        lanes = cfg.num_actors // F
        times = [r["act_times"] for r in reports]
        # filling from when the last fleet came up (each fleet's first act)
        t_up = max(float(a[0, 0]) for a in times)
        windows = dict(filling=(t_up, t_first), training=(t_first, t_last))
        parts = {}
        for name, (lo, hi) in windows.items():
            acts = np.concatenate(times)
            acts = acts[(acts[:, 0] >= lo) & (acts[:, 0] < hi)]
            parts[name] = dict(rate=len(acts) * lanes / max(hi - lo, 1e-9),
                               act_p50=pct(acts[:, 1] * 1e3, 50),
                               act_p99=pct(acts[:, 1] * 1e3, 99),
                               acts=len(acts))
        out = dict(mode=mode, launches=launches,
                   interval_p50=float(np.percentile(gaps, 50)),
                   hold_p50=spans["span.learner.dispatch_lock.p50_ms"],
                   fill=parts["filling"]["rate"],
                   training=parts["training"]["rate"], peak_gb=peak / 1e9,
                   seconds=run_s, parts=parts)
        what = ("act RPC round trip" if mode == "serve"
                else "CPU act (f32 twin)")
        line = (f"process fleets timings, {mode} mode, on {card}: "
                f"dispatch interval p50 {out['interval_p50']:.2f} ms ("
                f"{len(gaps)} intervals, min {gaps.min():.2f}, max "
                f"{gaps.max():.2f}); dispatch issue p50 "
                f"{np.percentile(issue, 50):.2f} ms; lock hold per dispatch "
                f"(learner.dispatch_lock) p50 {out['hold_p50']:.2f} ms; "
                f"peak allocated {peak / 1e9:.2f} GB")
        for name, p in parts.items():
            line += (f"; {name} ({windows[name][1] - windows[name][0]:.2f}"
                     f" s): env steps/s {p['rate']:.0f}, the fleets' {what}"
                     f" p50 {p['act_p50']:.3f} ms, p99 {p['act_p99']:.3f} "
                     f"ms over {p['acts']} acts")
        if mode == "serve":
            for name, (lo, hi) in windows.items():
                lo, hi = lo - wall, hi - wall
                sel = [(dt, p) for t, dt, p in rec["acts"] if lo <= t < hi]
                ms = [dt * 1e3 for dt, _ in sel]
                part = sum(1 for _, p in sel if len(p) < F)
                mean = (float(np.mean([lanes * len(p) for _, p in sel]))
                        if sel else float("nan"))
                parts[name].update(serve_p50=pct(ms, 50),
                                   serve_p99=pct(ms, 99), batches=len(ms),
                                   mean_lanes=mean, partial=part)
                line += (f"; {name}: serve.act p50 {pct(ms, 50):.3f} ms, "
                         f"p99 {pct(ms, 99):.3f} ms over {len(ms)} batches,"
                         f" mean lanes per batch {mean:.2f}, partial "
                         f"batches {part}")
            # a partial batch at steady state: one after the first batch
            # of every fleet that misses a fleet whose next request
            # follows no block cut
            seen, steady, unexplained = [0] * F, False, []
            for b, (t, _, pend) in enumerate(rec["acts"]):
                steady = steady or len(pend) == F
                miss = [(f, seen[f] + 1) for f in range(F) if f not in pend
                        and not unsteady_request(seen[f] + 1, cfg)]
                if steady and miss:
                    unexplained.append((b, t >= rec["dispatches"][0][0],
                                        miss))
                for f in pend:
                    seen[f] += 1
            out["unexplained"] = len(unexplained)
            line += (f"; steady-state partial batches (after the first "
                     f"full batch, the missing fleet's request following "
                     f"no block cut): {len(unexplained)}, "
                     f"{sum(1 for _, tr, _ in unexplained if tr)} while "
                     f"training; first: {unexplained[:6]}")
        (l0, p0), (l1, p1) = d[0][2], d[-1][2]
        span = max(d[-1][1] - d[0][0], 1e-9)
        issue_cpu = np.asarray([x[2][0] - x[3][0] for x in d]) * 1e3
        out.update(issue_p50=float(np.percentile(issue, 50)),
                   issue_cpu_p50=float(np.percentile(issue_cpu, 50)),
                   learner_cores=(l1 - l0) / span,
                   trainer_cores=(p1 - p0) / span,
                   children_cores=sum(r["cpu_seconds"] / r["alive_seconds"]
                                      for r in reports))
        line += (f"; a dispatch's issue p50 {out['issue_p50']:.2f} ms wall,"
                 f" {out['issue_cpu_p50']:.2f} ms of the learner thread's "
                 f"CPU; CPU while training: the learner thread "
                 f"{out['learner_cores']:.2f} cores, the trainer process "
                 f"{out['trainer_cores']:.2f}; the {F} fleets over their "
                 f"lives {out['children_cores']:.2f} of the host's "
                 f"{os.cpu_count()}")
        print(line, flush=True)
        if mode == "serve":
            out["twin"] = served_vs_twin(torch, card, cfg, svc)
        return out
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def pump_timeline(rec: dict, fleets: int) -> str:
    """Phase 9's local run: the trainer's pumps (seconds from the first,
    version), when each fleet first reported a version past the first and
    how long after the pump of that version, and the bounded wait before
    the last dispatch (the versions before and after it)."""
    pumps, reported = rec["pumps"], rec["reported"]
    if not pumps:
        return "no pump recorded"
    t0 = pumps[0][0]
    first = {}
    for t, vs in reported:
        for f, v in enumerate(vs):
            if v >= 2 and f not in first:
                first[f] = (t, v)
    lags = []
    for f in range(fleets):
        if f not in first:
            lags.append(f"fleet {f} never")
            continue
        t, v = first[f]
        sent = [tp for tp, vp in pumps if vp == v]
        lag = f", {t - sent[0]:.2f} s after its pump" if sent else ""
        lags.append(f"fleet {f} {v} at {t - t0:.2f} s{lag}")
    wait = rec.get("pump_wait")
    return (f"pumped {[(round(t - t0, 2), v) for t, v in pumps]} (s, "
            f"version); first report past version 1: {'; '.join(lags)}; "
            + ("no wait before the last dispatch" if wait is None else
               f"before the last dispatch reported {wait[1]}, waited "
               f"{wait[0]:.2f} s (at most {PUMP_WAIT_S} s) for {wait[2]}"))


def served_vs_twin(torch, card: str, cfg, svc) -> tuple:
    """One full 64-lane batch through the service's act on the card (bf16,
    the kernel) and through the fleets' f32 CPU twin, on the same inputs
    and the params the service last served with."""
    from r2d2_tpu_torch.actor import make_host_act_fn
    from r2d2_tpu_torch.parallel.actor_procs import fleet_act_net

    rng = np.random.default_rng(9)
    N, A = cfg.num_actors, TRAIN_ACTIONS
    svc.obs[:] = rng.integers(0, 256, svc.obs.shape, dtype=np.uint8)
    svc.last_action[:] = np.eye(A, dtype=np.float32)[rng.integers(A, size=N)]
    svc.last_reward[:] = rng.normal(size=N).astype(np.float32)
    hidden = (rng.normal(size=svc.hidden.shape) * 0.5).astype(np.float32)
    inputs = (svc.obs.copy(), svc.last_action.copy(),
              svc.last_reward.copy(), hidden)
    q_card, h_card = svc._act_batch(hidden, "smoke.twin_fetch")
    params = {k_: v.detach().float().cpu() for k_, v in svc._params.items()}
    q_cpu, h_cpu = make_host_act_fn(fleet_act_net(cfg, A))(params, *inputs)
    err_q = float(np.abs(q_card - q_cpu).max())
    err_h = float(np.abs(h_card - h_cpu).max())
    if not err_q <= SERVE_CPU_TOL or not np.isfinite(q_card).all():
        fail(f"served act vs the f32 CPU twin: q max-abs {err_q:.3e} > "
             f"{SERVE_CPU_TOL}")
    print(f"served act (bf16, lstm_infer, on {card}) vs the fleets' f32 "
          f"CPU twin, one {N}-lane batch: q max-abs {err_q:.3e} (limit "
          f"{SERVE_CPU_TOL}), new hidden max-abs {err_h:.3e}", flush=True)
    return err_q, err_h


def phase_process_fleets(torch, card: str, thread: dict) -> int:
    """Phase 9: the Pong preset with its 64 actors in 8 subprocess fleets,
    trained by ``train()`` from its full ring on the card, first in serve
    mode (every act an RPC to the trainer's service, which acts through
    the kernel) and then in local mode (each fleet acts on its CPU).
    ``thread`` is phase 7's in-graph run, printed beside.  Returns the
    kernel's launches by mode."""
    import gc
    import shutil

    from r2d2_tpu_torch.config import pong_config
    from r2d2_tpu_torch.parallel.actor_procs import shm_bytes
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(PROCESS_WATCHDOG_S)
    base = pong_config(game_name="Fake", actor_transport="process",
                       actor_fleets=PROCESS_FLEETS)
    need = data_bytes(base, TRAIN_ACTIONS)
    shm_free = shutil.disk_usage("/dev/shm").free
    shm_need = max(shm_bytes(base.replace(actor_inference=m),
                             TRAIN_ACTIONS) for m in PROCESS_MODES)
    if shm_free < shm_need:
        fail(f"/dev/shm has {shm_free} bytes free; the fleets map "
             f"{shm_need}")
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in DEVICE_REDUCED.items())
        + f", training_steps {base.training_steps} -> {PROCESS_STEPS} per "
        f"mode; {base.num_actors} actors in {PROCESS_FLEETS} subprocess "
        f"fleets of {base.num_actors // PROCESS_FLEETS}; the full ring on "
        f"the card ({need / 1e9:.2f} GB); os.cpu_count() {os.cpu_count()};"
        f" /dev/shm {shm_free} bytes free for {shm_need}", flush=True)
    runs = {}
    for mode in PROCESS_MODES:
        runs[mode] = process_run(torch, card, base.replace(
            actor_inference=mode, training_steps=PROCESS_STEPS,
            **DEVICE_REDUCED), need)
        gc.collect()
        torch.cuda.empty_cache()
    rows = [("thread (phase 7, in-graph)", thread)] + [
        (f"process, {m}", runs[m]) for m in PROCESS_MODES]
    print(f"fabric interval against the lone super-step ({thread['super_ms']:.2f}"
          f" ms, phase 7) on {card}: " + "; ".join(
              f"{name}: interval p50 {r['interval_p50']:.2f} ms = "
              f"{r['interval_p50'] / thread['super_ms']:.2f}x, lock hold "
              f"p50 {r['hold_p50']:.2f} ms, env steps/s {r['fill']:.0f} "
              f"filling / {r['training']:.0f} training, issue p50 "
              f"{r['issue_p50']:.2f} ms wall / {r['issue_cpu_p50']:.2f} ms "
              f"learner CPU (alone {thread['issue_ms']:.2f} / "
              f"{thread['issue_cpu_ms']:.2f}), CPU cores: "
              f"learner {r['learner_cores']:.2f}, trainer "
              f"{r['trainer_cores']:.2f}, fleets "
              + ("-" if r["children_cores"] is None
                 else f"{r['children_cores']:.2f}") + ", peak "
              f"{r['peak_gb']:.2f} GB, {r['seconds']:.1f} s"
              for name, r in rows), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return {m: runs[m]["launches"] for m in PROCESS_MODES}


def replay_shm_bytes(cfg, action_dim: int) -> int:
    """Bytes one sharded plane maps in /dev/shm: per shard, its ingest
    slots and its sample slab (``parallel/replay_shards._ShardChannels``),
    plus the stats slab — computed from the specs the plane allocates."""
    from r2d2_tpu_torch.parallel.replay_shards import (
        SHARD_STAT_FIELDS,
        _ShardChannels,
    )
    from r2d2_tpu_torch.replay.block import (
        batch_slot_spec,
        block_slot_spec,
        slot_layout,
    )

    shard = cfg.replace(buffer_capacity=cfg.buffer_capacity
                        // cfg.replay_shards, replay_shards=1)
    block, _ = slot_layout(block_slot_spec(shard, action_dim))
    sample, _ = slot_layout(batch_slot_spec(shard, action_dim,
                                            cfg.batch_size))
    stats = 8 * (len(SHARD_STAT_FIELDS) + 2)
    return cfg.replay_shards * (_ShardChannels.INGEST_SLOTS * block + sample
                                + stats)


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def proc_report(pid: int) -> dict:
    """What a child process holds, read from the outside: the CUDA driver
    library (``libcuda``; a process that imports the CUDA build of torch
    maps it too, through ``libcaffe2_nvrtc.so``), the card itself (a CUDA
    context opens and maps the ``/dev/nvidia*`` device files), JAX
    (``xla_extension`` or ``jaxlib``), torch (``libtorch``); and its CPU
    seconds so far."""
    from r2d2_tpu_torch.league.eval_service import card_handles

    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    cpu = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return dict(pid=pid, cuda="libcuda" in maps,
                device=bool(card_handles(str(pid))),
                jax="xla_extension" in maps or "jaxlib" in maps,
                torch="libtorch" in maps, cpu_s=cpu)


def oracle_leaf(cfg, idxes):
    """Global sharded leaf index → the K = 1 oracle's leaf with the same
    content (block n routes to shard n % K, local slot n // K)."""
    K, kseq = cfg.replay_shards, cfg.seqs_per_block
    lps = cfg.num_sequences // K
    shard, local = idxes // lps, idxes % lps
    return ((local // kseq) * K + shard) * kseq + local % kseq


def replay_parity(base) -> dict:
    """Phase 10's check on scripted blocks, before the runs: both
    transports at K = 4 and a K = 1 oracle buffer, at the flagship's full
    geometry, fed the same blocks; every returned row bitwise equal to the
    oracle's gather at the same global index (and each IS weight to the
    oracle's leaves' weight), the summed shard mass equal to the oracle's
    tree total to 1e-12 relative, before and after priority feedback."""
    from r2d2_tpu_torch.parallel.replay_net import NetShardedReplayPlane
    from r2d2_tpu_torch.parallel.replay_shards import ShardedReplayPlane
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    A, B = TRAIN_ACTIONS, base.batch_size
    blocks = scripted_blocks(base, REPLAY_CHECK_BLOCKS, seed=5)
    steps = sum(int(b.learning_steps.sum()) for b, _ in blocks)
    rows = ("obs", "last_action", "last_reward", "hidden", "action",
            "n_step_reward", "n_step_gamma", "burn_in", "learning",
            "forward")
    out = {}
    for label, cls, cfg in (
            ("shm", ShardedReplayPlane, base),
            ("socket", NetShardedReplayPlane,
             base.replace(replay_transport="socket"))):
        oracle_t = ReplayBuffer(base.replace(replay_shards=1), A,
                                rng=np.random.default_rng(0))
        for blk, prios in blocks:
            oracle_t.add(blk, prios, None)
        plane = cls(cfg, A, rng=np.random.default_rng(1))
        t0 = time.perf_counter()
        try:
            plane.start()
            for blk, prios in blocks:
                plane.add(blk, prios, None)
            deadline = time.time() + 120
            while (plane.poll_shard_stats()["size_total"] < steps
                   and time.time() < deadline):
                time.sleep(0.02)
            rel = []
            fed = 0
            # the socket plane issues each next draw before the current
            # batch returns (the pipeline): its shards serve that draw
            # before the batch's feedback lands, so its rows carry the
            # priorities from before that feedback
            at_issue = oracle_t.tree.leaf_values()
            for rnd in range(REPLAY_CHECK_DRAWS):
                st = plane.poll_shard_stats()
                rel.append(abs(st["mass_total"] - oracle_t.tree.total)
                           / oracle_t.tree.total)
                batch = plane.sample_batch(B)
                if batch is None:
                    fail(f"replay parity ({label}): no batch")
                oidx = oracle_leaf(cfg, batch["idxes"])
                with oracle_t.lock:
                    want = oracle_t._gather_rows(oidx)
                    now = oracle_t.tree.leaf_values()
                leaves = (at_issue if label == "socket" else now)[oidx]
                at_issue = now
                for name in rows:
                    if not np.array_equal(batch[name], want[name]):
                        fail(f"replay parity ({label}): field {name} of "
                             f"draw {rnd} differs from the oracle's gather")
                pos = leaves[leaves > 0]
                p = np.maximum(leaves, pos.min())
                w = ((p / pos.min()) ** (-cfg.importance_sampling_exponent)
                     ).astype(np.float32)
                if not np.array_equal(batch["is_weights"], w):
                    fail(f"replay parity ({label}): IS weights of draw "
                         f"{rnd} differ from the oracle's leaves'")
                new = np.linspace(0.1, 2.0 + rnd, B)
                plane.update_priorities(batch["idxes"], new,
                                        batch["block_ptr"], 0.0)
                oracle_t.update_priorities(oidx, new, oracle_t.block_ptr,
                                           0.0)
                fed += len(batch["block_ptr"])
                deadline = time.time() + 60
                while (plane.poll_shard_stats()["totals"].get(
                        "prio_updates", 0) < fed
                       and time.time() < deadline):
                    time.sleep(0.01)
            st = plane.poll_shard_stats()
            rel.append(abs(st["mass_total"] - oracle_t.tree.total)
                       / oracle_t.tree.total)
            # the sample call alone: back to back, as the fabric's sample
            # thread calls it, with no other thread in the process
            calls = []
            for _ in range(REPLAY_ALONE_DRAWS):
                t_call = time.perf_counter()
                if plane.sample_batch(B) is None:
                    fail(f"replay parity ({label}): no batch")
                calls.append((time.perf_counter() - t_call) * 1e3)
            if max(rel) > REPLAY_MASS_RTOL:
                fail(f"replay parity ({label}): shard mass against the "
                     f"oracle's tree total, relative {rel}")
        finally:
            plane.shutdown()
        out[label] = dict(mass_rel=max(rel), calls_ms=calls,
                          seconds=time.perf_counter() - t0)
    print(f"replay parity at the flagship geometry (K = 4, "
          f"{REPLAY_CHECK_BLOCKS} scripted blocks, {REPLAY_CHECK_DRAWS} "
          f"draws of {B} with priority feedback): every row bitwise equal "
          f"to the K = 1 oracle's gather and every IS weight to its "
          f"leaves', over shm and over sockets; shard mass vs the oracle's "
          f"tree total, max relative " + ", ".join(
              f"{k} {v['mass_rel']:.2e} ({v['seconds']:.1f} s)"
              for k, v in out.items()) + f" (limit {REPLAY_MASS_RTOL}); "
          f"the plane's sample call alone, back to back, p50 " + ", ".join(
              f"{k} {np.percentile(v['calls_ms'], 50):.2f} ms (of "
              + " / ".join(f"{ms:.2f}" for ms in v["calls_ms"]) + ")"
              for k, v in out.items()), flush=True)
    return out


def replay_run(torch, card: str, cfg, label: str, ckdir) -> dict:
    """One of phase 10's ``train()`` runs: its checks and timings.
    ``ckdir`` (or None) is where the run saves; the run with a replay
    plane and a ``ckdir`` ends with the drain-then-save per-shard
    snapshot, read back here into a fresh plane."""
    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    steps = cfg.training_steps
    real_build = train._build
    rec = dict(steps=[], samples=[], stages=0, probe=None, start=None,
               cpu=[], last_batch=None, write_s=None, settle=None)
    probe = {}

    def read_procs(plane):
        return [proc_report(p.pid) for p in plane.procs]

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        rec.update(sys_)
        actor, learner, buffer = (sys_["actor"], sys_["learner"],
                                  sys_["buffer"])
        plane = sys_["replay_plane"]
        run, step, stage = actor.run, learner._step_fn, learner._stage
        sample = buffer.sample_batch

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def timed_step(state, batch):
            t0, a0 = time.perf_counter(), actor.actor_steps
            out = step(state, batch)
            rec["steps"].append((t0, a0, time.perf_counter(),
                                 actor.actor_steps))
            n = len(rec["steps"])
            if plane is not None and n in (1, steps):
                # the shards' maps and CPU seconds, read from /proc while
                # they serve the run
                rec["cpu"].append((time.perf_counter(), read_procs(plane)))
            return out

        def counted_stage(batch):
            rec["stages"] += 1
            return stage(batch)

        def timed_sample(*a, **k):
            t0 = time.perf_counter()
            batch = sample(*a, **k)
            rec["samples"].append((t0, time.perf_counter()))
            if batch is not None:
                rec["last_batch"] = batch
            return batch

        actor.run, learner._step_fn = timed_run, timed_step
        learner._stage, buffer.sample_batch = counted_stage, timed_sample
        if plane is not None:
            write, shutdown = plane.write_state, plane.shutdown

            def timed_write(path):
                t0 = time.perf_counter()
                meta = write(path)
                rec["write_s"] = time.perf_counter() - t0
                return meta

            def settled_shutdown(*a, **k):
                # the card's compute processes while the shards still run,
                # asked after training so that it adds nothing to the
                # measured window
                smi = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60)
                rec["probe"] = (smi.returncode, smi.stdout.split())
                # the last routed blocks reach their shards within a few
                # polls of the fabric's stop; read the plane settled
                deadline = time.time() + 30
                while (plane.poll_shard_stats()["size_total"]
                       != plane.env_steps and time.time() < deadline):
                    time.sleep(0.02)
                st = plane.poll_shard_stats()
                rec["settle"] = dict(size=st["size_total"],
                                     masses=st["masses"].copy(),
                                     health=plane.health())
                return shutdown(*a, **k)

            plane.write_state, plane.shutdown = timed_write, settled_shutdown
        return sys_

    def log_sink(entry):
        if probe:
            return
        try:
            port = entry["telemetry_port"]
            probe["healthz"] = http_get(port, "/healthz")
            probe["statusz"] = http_get(port, "/statusz")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    torch.cuda.reset_peak_memory_stats()
    train._build = capture
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                        max_wall_seconds=REPLAY_WALL_S, verbose=False,
                        log_sink=log_sink)
    finally:
        train._build = real_build
    run_s = time.perf_counter() - t0
    # the run's stamps (the check below steps the learner once more)
    st = list(rec["steps"])
    peak = torch.cuda.max_memory_allocated()
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
    h2d = HOST_TRANSFERS.get("learner.batch_h2d")
    plane, learner = rec["replay_plane"], rec["learner"]
    K = cfg.replay_shards

    # the run's checks
    lh = m["learnhealth"]
    restarts = {n: h["restarts"] for n, h in m["health"].items()}
    if (m["num_updates"] != steps or lh["loss_count"] != steps
            or lh["nonfinite"] or not np.isfinite(m["mean_loss"])
            or m["buffer_training_steps"] != steps
            or m["fabric_failed"] or any(restarts.values())):
        fail(f"{label}: {m['num_updates']} updates, learnhealth {lh}, "
             f"feedbacks {m['buffer_training_steps']}, failed "
             f"{m['fabric_failed']}, thread restarts {restarts}")
    if launches != cfg.lstm_layers * acts or not acts or old:
        fail(f"{label}: lstm_infer launched {launches} times (CUDA-core "
             f"{old}) for {acts} acts, {cfg.lstm_layers} layer")
    per_stage = 1 if plane is not None else 11
    stages = rec["stages"]
    if h2d != per_stage * stages:
        fail(f"{label}: {h2d} batch copies to the card for {stages} "
             f"staged batches (want {per_stage} each)")
    # an update alone launches no lstm_infer kernel
    KERNEL_LAUNCHES.reset()
    dev, _ = learner._stage(rec["last_batch"])
    _, loss, _ = learner._step_fn(learner.state, dev)
    torch.cuda.synchronize()
    upd_launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    if upd_launches or not np.isfinite(loss.item()):
        fail(f"{label}: an update alone launched {upd_launches} lstm_infer "
             f"kernels, loss {loss.item()}")
    if "error" in probe or probe.get("healthz", (0,))[0] != 200:
        fail(f"{label}: the run's exporter: {probe}")
    health = json.loads(probe["healthz"][1])
    status = json.loads(probe["statusz"][1])
    if health.get("status") != "ok" or m["healthz"].get("status") != "ok":
        fail(f"{label}: /healthz {health}, final {m['healthz']}")
    out = dict(label=label, launches=launches, acts=acts,
               peak_gb=peak / 1e9, seconds=run_s, h2d=h2d, stages=stages)
    line = (f"replay {label} on {card}: {m['num_updates']} updates in "
            f"{run_s:.2f} s, losses finite {lh['loss_count']}/{steps}, "
            f"mean loss {m['mean_loss']:.5f}, priority feedbacks "
            f"{m['buffer_training_steps']}; lstm_infer launches {launches} "
            f"= {cfg.lstm_layers} x {acts} acts, CUDA-core {old}, 0 in an "
            f"update alone; batch copies to the card {h2d} for "
            f"{stages} staged batches; /healthz ok")
    if plane is None:
        buffer = rec["buffer"]
        if len(buffer) != buffer.env_steps:
            fail(f"{label}: fill {len(buffer)} for {buffer.env_steps} "
                 "ingested transitions")
        line += f"; fill {len(buffer)} = the ingested transitions"
    else:
        settle = rec["settle"]
        rh = settle["health"]
        # the fault counters at the run's end: the stop's cut of the
        # draw in flight counts as a sample stop, not as a fault
        bad = dict(corrupt=rh["corrupt_blocks"], respawns=rh["respawns"],
                   dropped=rh["dropped_blocks"],
                   stale=rh["stale_feedback"],
                   timeouts=rh["sample_timeouts"], redraws=rh["redraws"],
                   garbled=rh["garbled_responses"],
                   retries=rh["sample_retries"])
        if (settle["size"] != plane.env_steps or rh["alive"] != K
                or any(bad["respawns"]) or any(
                    v for k_, v in bad.items() if k_ != "respawns")):
            fail(f"{label}: shards' size {settle['size']} for "
                 f"{plane.env_steps} ingested transitions; {bad}; alive "
                 f"{rh['alive']}")
        net = rh.get("net")
        if net is not None:
            circuits = [row["circuit"] for row in net["links"]]
            if (circuits != ["closed"] * K or net["epoch_drops"]
                    or net["connected"] != K):
                fail(f"{label}: circuits {circuits}, epoch drops "
                     f"{net['epoch_drops']}, connected {net['connected']}")
        if "replay_shards" not in (status.get("last_entry") or {}) or (
                "replay_shards" not in health):
            fail(f"{label}: /statusz or /healthz has no replay_shards "
                 "block")
        reports = rec["cpu"][-1][1]
        smi_rc, smi_pids = rec["probe"]
        pids = [r["pid"] for r in reports]
        if (len(reports) != K or any(r["cuda"] or r["jax"]
                                     for _, rs in rec["cpu"] for r in rs)
                or smi_rc != 0 or set(smi_pids) & {str(p) for p in pids}):
            fail(f"{label}: shard reports {reports}; nvidia-smi compute "
                 f"apps {smi_pids} (rc {smi_rc})")
        (t_a, first), (t_b, last) = rec["cpu"][0], rec["cpu"][-1]
        cores = [(b["cpu_s"] - a["cpu_s"]) / max(t_b - t_a, 1e-9)
                 for a, b in zip(first, last)]
        out.update(shard_cores=cores, masses=settle["masses"])
        line += (f"; shards' size {settle['size']} = the ingested "
                 f"transitions ({rh['blocks_routed']} blocks routed), "
                 f"sizes {rh['sizes']}; corrupt 0, respawns 0, dropped 0, "
                 f"stale feedback 0; at the run's end redraws 0, timeouts "
                 f"0, garbled 0, retries 0 (sample stops "
                 f"{rh['sample_stops']}: the stop's cut of the draw in "
                 f"flight)"
                 + (f"; circuits {['closed'] * K}, epoch drops 0, "
                    f"reconnects {net['reconnects']}" if net else "")
                 + f"; /statusz replay_shards {health['replay_shards']}; "
                 f"shards: no CUDA context, no JAX, torch "
                 f"{sorted({r['torch'] for r in reports})}; nvidia-smi "
                 f"compute apps {smi_pids} (trainer {os.getpid()}, shards "
                 f"{pids})")
    print(line, flush=True)

    # timings, from the stamps (no synchronisation added)
    t_start, a_start = rec["start"]
    n_env = cfg.num_actors
    fill = (st[0][1] - a_start) * n_env / (st[0][0] - t_start)
    training = ((st[-1][3] - st[0][1]) * n_env / (st[-1][2] - st[0][0]))
    exits = np.asarray([s[2] for s in st])
    gaps = np.diff(exits) * 1e3
    calls = [(a, b) for a, b in rec["samples"]]
    ms = np.asarray([b - a for a, b in calls]) * 1e3
    in_train = [(a, b) for a, b in calls if st[0][0] <= a <= st[-1][2]]
    rate = len(in_train) / max(st[-1][2] - st[0][0], 1e-9)
    slow = np.argsort(gaps)[::-1][:3]
    out.update(interval_p50=float(np.percentile(gaps, 50)), fill=fill,
               training=training, sample_p50=pct(ms, 50),
               sample_p99=pct(ms, 99), batches_s=rate,
               capacity=1e3 / float(np.mean(ms)))
    line = (f"replay {label} timings on {card}: update interval p50 "
            f"{out['interval_p50']:.2f} ms (min {gaps.min():.2f}, max "
            f"{gaps.max():.2f}, {len(gaps)} intervals, the longest after "
            f"updates {[int(i) + 1 for i in slow]}); env steps/s while "
            f"filling {fill:.0f}, while training {training:.0f}; the "
            f"plane's sample call on the learner's side p50 "
            f"{out['sample_p50']:.2f} ms, p99 {out['sample_p99']:.2f} ms "
            f"over {len(ms)} calls, {rate:.2f} batches/s while training "
            f"({out['capacity']:.2f}/s at the mean call); peak allocated "
            f"{peak / 1e9:.2f} GB")
    if plane is not None:
        line += ("; the shards' CPU cores while training "
                 + ", ".join(f"{c:.2f}" for c in out["shard_cores"])
                 + f" of the host's {os.cpu_count()}")
    print(line, flush=True)

    if plane is not None and ckdir is not None:
        # the drain-then-save per-shard snapshot, read back into a fresh
        # plane, mass-exact
        from r2d2_tpu_torch.checkpoint import Checkpointer
        from r2d2_tpu_torch.parallel.replay_shards import ShardedReplayPlane

        meta, ring, _ = Checkpointer(ckdir).restore_replay()
        nbytes = sum(os.path.getsize(f"{ring}.shard{s}") for s in range(K))
        saved = [sm["tree_total"] for sm in meta["shard_metas"]]
        if (meta["kind"] != "sharded" or meta["shards"] != K
                or not np.array_equal(saved, out["masses"])):
            fail(f"{label}: snapshot meta {meta['kind']}/{meta['shards']}, "
                 f"masses {saved} against the live {out['masses']}")
        fresh = ShardedReplayPlane(cfg, TRAIN_ACTIONS)
        t0 = time.perf_counter()
        try:
            fresh.read_state(ring, meta)
            fresh.start()
            deadline = time.time() + 300
            while (not np.array_equal(fresh.poll_shard_stats()["masses"],
                                      saved) and time.time() < deadline):
                time.sleep(0.05)
            got = fresh.poll_shard_stats()
        finally:
            read_s = time.perf_counter() - t0
            fresh.shutdown()
        if not np.array_equal(got["masses"], saved) or (
                got["size_total"] != rec["settle"]["size"]):
            fail(f"{label}: snapshot read back to masses {got['masses']} "
                 f"(saved {saved}), size {got['size_total']}")
        out.update(snapshot_bytes=nbytes, write_s=rec["write_s"],
                   read_s=read_s)
        print(f"replay {label} snapshot on {card}: drain-then-save of "
              f"{K} shards, {nbytes} bytes in {rec['write_s']:.2f} s; read "
              f"back into a fresh plane in {read_s:.2f} s, masses equal "
              f"bit for bit ({[float(x) for x in saved]}), size "
              f"{got['size_total']}", flush=True)
    return out


def flagship_replay_config():
    """The README's ``Config(game_name="Fake", replay_shards=4)``, checked
    against the flagship's published widths."""
    from r2d2_tpu_torch.config import Config

    base = Config(game_name="Fake", replay_shards=REPLAY_SHARDS)
    literal = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                   hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                   batch_size=64, burn_in_steps=40, learning_steps=40,
                   forward_steps=5, num_actors=8,
                   buffer_capacity=2_000_000, block_length=400)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"Config(game_name='Fake') is not the flagship: {got}")
    return base


def phase_replay_shards(torch, card: str, base) -> tuple:
    """Phase 10: the flagship ``base`` trained by ``train()`` from the
    in-process ring (K = 1), from four shm replay shards and from four
    loopback socket shard servers, after the scripted-block parity check.
    Returns the kernel's launches by run and the parity check's result."""
    import gc
    import shutil
    import tempfile

    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(REPLAY_WATCHDOG_S)
    need = data_bytes(base, TRAIN_ACTIONS)
    shm_need = replay_shm_bytes(base, TRAIN_ACTIONS)
    vfs = os.statvfs("/dev/shm")
    shm_free = vfs.f_bavail * vfs.f_frsize
    mem = mem_available()
    if shm_free < shm_need:
        fail(f"/dev/shm has {shm_free} bytes free; {base.replay_shards} "
             f"shards map {shm_need}")
    if mem < 1.2 * need:
        fail(f"MemAvailable {mem} bytes; the host ring needs {need}")
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in REPLAY_REDUCED.items())
        + ", training_steps " + ", ".join(
            f"{lbl} {n}" for lbl, _, n in REPLAY_RUNS) + f" (from "
        f"{base.training_steps}); the full host ring, {base.num_blocks} "
        f"blocks ({need / 1e9:.2f} GB, "
        f"{base.num_blocks // base.replay_shards} a shard); /dev/shm {shm_free} bytes free for {shm_need}; "
        f"MemAvailable {mem}; os.cpu_count() {os.cpu_count()}", flush=True)
    parity = replay_parity(base)
    runs = {}
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_replay_")
    try:
        for label, kw, n in REPLAY_RUNS:
            cfg = base.replace(training_steps=n, **REPLAY_REDUCED, **kw)
            runs[label] = replay_run(torch, card, cfg, label,
                                     ckdir if label == "shm" else None)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    one = runs["k1"]
    print(f"replay planes against the in-process ring on {card}: " + "; ".join(
        f"{lbl}: interval p50 {r['interval_p50']:.2f} ms = "
        f"{r['interval_p50'] / one['interval_p50']:.2f}x K = 1's "
        f"{one['interval_p50']:.2f}, sample call p50 {r['sample_p50']:.2f}"
        f" ms (K = 1 {one['sample_p50']:.2f}; alone "
        f"{np.percentile(parity[lbl]['calls_ms'], 50):.2f}), env steps/s "
        f"{r['fill']:.0f} filling / {r['training']:.0f} training, peak "
        f"{r['peak_gb']:.2f} GB" for lbl, r in runs.items() if lbl != "k1"),
        flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return {lbl: r["launches"] for lbl, r in runs.items()}, parity


# --------------------------------------------------------------------------
# phase 11: the learner mesh on the card
# --------------------------------------------------------------------------

def mesh_group(torch, device: str):
    """A world of one rank on a loopback ``TCPStore`` (a free port): the
    NCCL group of the meshed runs on the card (gloo on the CPU)."""
    from datetime import timedelta

    import torch.distributed as dist

    from r2d2_tpu_torch.parallel.distributed import init_distributed

    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=timedelta(seconds=120))
    init_distributed(store=store, world_size=1, rank=0, device=device)
    return store


def state_equal(torch, a, b) -> bool:
    """Two plain TrainStates bit for bit."""
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and all(torch.equal(x[k], y[k])
                    for x, y in ((a.params, b.params),
                                 (a.target_params, b.target_params),
                                 (a.opt_state.mu, b.opt_state.mu),
                                 (a.opt_state.nu, b.opt_state.nu))
                    for k in x))


def mesh_step_checks(torch, card: str, cfg, mesh, device: str,
                     ckdir: str) -> dict:
    """Run 1 of phase 11: from one state and one batch, one meshed train
    step against one meshless ``train_step`` (phase 5's ``step_batch``),
    bitwise; the lone updates' host and device time; and a meshless
    checkpoint restored onto the mesh, bitwise."""
    from torch.distributed.tensor import DTensor

    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.parallel.distributed import sync_min_array
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_train_step,
    )

    net = create_network(cfg, TRAIN_ACTIONS, device=device,
                         generator=torch.Generator().manual_seed(0))
    plain_state = create_train_state(cfg, net.state_dict())
    mesh_state = create_train_state(cfg, net.state_dict())
    table = ShardingTable(mesh, cfg)
    meshed = mesh_train_step(cfg, net, table, state_template=mesh_state)
    mesh_state = table.place_state(mesh_state)
    leaves = [v for d in (mesh_state.params, mesh_state.target_params,
                          mesh_state.opt_state.mu, mesh_state.opt_state.nu)
              for v in d.values()]
    if not all(isinstance(v, DTensor) and v.device.type == device
               for v in leaves):
        fail(f"a meshed state leaf is not a DTensor on {device}")
    plain = make_train_step(cfg, net)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in step_batch(cfg, seed=11).items()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain_state, la, pa = plain(plain_state, batch)
        mesh_state, lb, pb = meshed(mesh_state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    full = gather_state(mesh_state)
    param_err = max(float((full.params[k] - plain_state.params[k]).abs()
                          .max()) for k in full.params)
    bitwise = (torch.equal(la, lb) and torch.equal(pa, pb)
               and state_equal(torch, plain_state, full))
    print(f"mesh step parity on {card}: world size 1, {len(leaves)} state "
          f"leaves DTensors on {device}; loss meshed {lb.item():.6f} vs "
          f"meshless {la.item():.6f}, priorities max-abs "
          f"{(pa - pb).abs().max().item():.3e}, new params max-abs "
          f"{param_err:.3e}; bitwise {bitwise} (cuDNN deterministic for "
          "this check only)", flush=True)
    if not bitwise:
        worst = sorted(((float((full.params[k] - plain_state.params[k])
                               .abs().max()), k) for k in full.params),
                       reverse=True)[:5]
        fail(f"the meshed step is not the meshless step bit for bit: "
             f"loss {la.item()!r} vs {lb.item()!r}, worst params {worst}")

    # the meshless state, checkpointed, restored onto the mesh
    ck = Checkpointer(ckdir)
    ck.save(1, plain_state, meta=dict(env_steps=0))
    restored, _ = ck.restore()
    on_mesh = Learner(cfg, net, restored, mesh=mesh)
    if not state_equal(torch, gather_state(on_mesh.state), plain_state):
        fail("a meshless checkpoint did not restore onto the mesh bit for "
             "bit")
    print(f"checkpoint crossing on {card}: a meshless checkpoint restored "
          "with the mesh, gathered back, bit for bit", flush=True)

    # the lone updates: the step alone, meshless and meshed; then one
    # meshed update with its collective gate, for the NCCL kernels
    def one_plain():
        plain(plain_state, batch)

    def one_meshed():
        meshed(mesh_state, batch)

    def one_gated():
        sync_min_array([1.0, 1.0], tag="profile")
        meshed(mesh_state, batch)

    out = {}
    for name, fn in (("meshless", one_plain), ("meshed", one_meshed)):
        events = profile_events(torch, fn, 2)
        if events is None:
            fail(f"no device time in a {name} update")
        out[name] = dict(wall=wall_ms(torch, fn, 3),
                         device=sum(ms for _, ms, _ in events),
                         events=sum(n for _, _, n in events))
    gated = profile_events(torch, one_gated, 2)
    if gated is None:
        fail("no device time in a gated meshed update")
    nccl = [(n, ms, c) for n, ms, c in gated if "nccl" in n.lower()]
    out["nccl"] = nccl
    a, b = out["meshless"], out["meshed"]
    print(f"lone update on {card} (step only, 3 timed): meshless host wall "
          f"{a['wall']:.2f} ms, device {a['device']:.3f} ms in "
          f"{a['events']:.0f} device events; meshed host wall "
          f"{b['wall']:.2f} ms, device {b['device']:.3f} ms in "
          f"{b['events']:.0f} device events ({b['wall'] / a['wall']:.2f}x "
          f"the host wall: the DTensor dispatch); NCCL kernels in one "
          "update with its gate: " + (", ".join(
              f"{short_kernel_name(n, 80)} x{c:.0f} ({ms:.4f} ms)"
              for n, ms, c in nccl) or "none"), flush=True)
    return out


def mesh_run(torch, card: str, cfg, label: str, ckdir: str,
             sync: bool, device: str) -> dict:
    """Runs 2 (``sync``: ``train_sync``) and 3 (``train()`` from the
    device ring) of phase 11, with ``use_mesh=True``; their checks and
    timings."""
    import warnings

    import torch.distributed as dist

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS
    from r2d2_tpu_torch.parallel.sharding import full, gather_state
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    steps, k = cfg.training_steps, cfg.superstep_k
    rec = dict(start=None, stamps=[], synced={})
    real_build, real_mts = train._build, step_mod.make_train_step
    probe = {}

    def recording_mts(cfg_, net_, **kw):
        inner = real_mts(cfg_, net_, **kw)

        def step(state, batch):
            out = inner(state, batch)
            st = out[0]
            if st.step in (7, 8):
                # the learner thread, between steps: the gathers are
                # collectives every rank makes at the same step
                rec["synced"][st.step] = all(
                    torch.equal(full(st.params[n]),
                                full(st.target_params[n]))
                    for n in st.params)
            return out
        return step

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        rec.update(sys_)
        actor, learner = sys_["actor"], sys_["learner"]
        run = actor.run

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)
            if sync and max_steps == cfg.block_length:
                rec["filled"] = (time.perf_counter(), actor.actor_steps)

        actor.run = timed_run
        if sync:
            step = learner._step_fn

            def timed_step(state, batch):
                torch.cuda.synchronize()
                t0, a0 = time.perf_counter(), actor.actor_steps
                out = step(state, batch)
                torch.cuda.synchronize()
                rec["stamps"].append((t0, a0, time.perf_counter(),
                                      actor.actor_steps))
                return out
            learner._step_fn = timed_step
        else:
            loop = learner._superstep_loop

            def stamped_loop(k_, target, t0, gate, sample, harvest,
                             prepare=None, tracer=None):
                def stamped():
                    t, a = time.perf_counter(), actor.actor_steps
                    out = sample()
                    rec["stamps"].append((t, a, time.perf_counter(),
                                          actor.actor_steps))
                    return out
                return loop(k_, target, t0, gate, stamped, harvest,
                            prepare, tracer)
            learner._superstep_loop = stamped_loop
        return sys_

    def log_sink(entry):
        if probe:
            return
        try:
            probe["healthz"] = http_get(entry["telemetry_port"], "/healthz")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    COLLECTIVE_CALLS.clear()
    torch.cuda.reset_peak_memory_stats()
    train._build, step_mod.make_train_step = capture, recording_mts
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if sync:
                m = train.train_sync(cfg, env_factory, checkpoint_dir=ckdir,
                                     device=device, use_mesh=True)
            else:
                m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                                use_mesh=True, device=device,
                                max_wall_seconds=MESH_WALL_S, verbose=False,
                                log_sink=log_sink)
    finally:
        train._build, step_mod.make_train_step = real_build, real_mts
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
    calls = dict(COLLECTIVE_CALLS)
    learner, buffer, ring = rec["learner"], rec["buffer"], rec["ring"]
    # the run's stamps (the check below steps the learner once more)
    stamps = list(rec["stamps"])
    n = len(stamps)

    # the run's checks
    if dist.get_backend() != ("nccl" if device == "cuda" else "gloo"):
        fail(f"{label}: the process group's backend is "
             f"{dist.get_backend()}")
    if learner.mesh is None or not all(
            type(v).__name__ == "DTensor" for v in learner.state.params
            .values()):
        fail(f"{label}: the learner's state is not on the mesh")
    if sync:
        losses = np.asarray(m["losses"])
        finite = losses.shape == (steps,) and np.isfinite(losses).all()
    else:
        lh = m["learnhealth"]
        losses = lh
        finite = lh["loss_count"] == steps and not lh["nonfinite"]
    fed = buffer.stats()["training_steps"]
    if (m["num_updates"] != steps or not finite
            or not np.isfinite(m["mean_loss"]) or fed != steps):
        fail(f"{label}: {m['num_updates']} updates, losses {losses}, "
             f"{fed} priority feedbacks")
    per = 1 if sync else k
    if n * per != steps or learner.gate_counts["go"] != n or (
            calls.get("gate", 0) != sum(learner.gate_counts.values())):
        fail(f"{label}: {n} updates or dispatches, gates "
             f"{dict(learner.gate_counts)}, collectives {calls}")
    if not sync and calls.get("min_density") != n:
        fail(f"{label}: {calls.get('min_density')} min-density agreements "
             f"for {n} super-steps")
    # the dp group's broadcast, over a group of one: one an update (sync)
    # or a super-step (the device ring)
    if calls.get("group_broadcast") != n:
        fail(f"{label}: {calls.get('group_broadcast')} group broadcasts "
             f"for {n} updates or dispatches")
    if launches != cfg.lstm_layers * acts or not acts or old:
        fail(f"{label}: lstm_infer launched {launches} times (CUDA-core "
             f"{old}) for {acts} acts, {cfg.lstm_layers} layer")
    if rec["synced"] != {7: False, 8: True}:
        fail(f"{label}: target == online after steps 7, 8: "
             f"{rec['synced']} (want False, True)")
    line = (f"mesh {label} on {card}: {m['num_updates']} updates"
            + ("" if sync else f" in {n} dispatches of k={k}")
            + f" in {run_s:.2f} s, losses finite, mean loss "
            f"{m['mean_loss']:.5f}; priority feedbacks {fed} to this "
            f"rank's buffer; collective gates {dict(learner.gate_counts)},"
            f" collectives {calls}; lstm_infer launches {launches} = "
            f"{cfg.lstm_layers} x {acts} acts, CUDA-core {old}; target == "
            f"online after step 7 {rec['synced'][7]}, after 8 "
            f"{rec['synced'][8]}")
    if not sync:
        fallback = [str(w.message) for w in caught
                    if "host staging" in str(w.message)
                    or "in_graph_per disabled" in str(w.message)]
        need = data_bytes(cfg, TRAIN_ACTIONS)
        if (fallback or ring is None or ring.layout != "dp"
                or ring.arrays["obs"].device.type != device
                or ring.nbytes() != need):
            fail(f"{label}: the dp ring was not built on the card "
                 f"({fallback}, {ring and ring.layout})")
        if "error" in probe or probe.get("healthz", (0,))[0] != 200 or (
                json.loads(probe["healthz"][1]).get("status") != "ok"
                or m["healthz"].get("status") != "ok"):
            fail(f"{label}: /healthz {probe}, final {m.get('healthz')}")
        line += (f"; this rank's dp slab on the card: {ring.nbytes()} "
                 f"bytes = the whole ring at dp = 1; /healthz ok")
    print(line, flush=True)

    out = dict(launches=launches, acts=acts, peak_gb=peak / 1e9,
               seconds=run_s)
    if sync:
        # the meshed checkpoint restores without a mesh, bit for bit
        ck = Checkpointer(ckdir)
        if ck.steps() != [8, 16]:
            fail(f"{label}: checkpoints {ck.steps()}, expected [8, 16]")
        state, _ = ck.restore()
        plain = Learner(rec["cfg"], rec["net"], state)
        if not state_equal(torch, plain.state, gather_state(learner.state)):
            fail(f"{label}: the meshed checkpoint did not restore without "
                 "the mesh bit for bit")
        print(f"checkpoint crossing on {card}: the meshed run's step "
              f"{ck.steps()[-1]} checkpoint restored without a mesh, bit "
              "for bit", flush=True)
    # an update alone launches no lstm_infer kernel
    KERNEL_LAUNCHES.reset()
    if sync:
        dev, _ = learner._stage(buffer.sample_batch(rec["host_bs"]))
        _, loss, _ = learner._step_fn(learner.state, dev)
    else:
        from r2d2_tpu_torch.parallel.sharding import mesh_super_step
        from r2d2_tpu_torch.replay.device_ring import to_device

        fn = mesh_super_step(cfg, learner.net, learner.table, k,
                             state_template=learner.state)
        meta = buffer.sample_meta(k, batch_size=rec["host_bs"])
        _, losses_, _ = fn(learner.state, ring.snapshot(),
                           to_device(meta["ints"], learner.device),
                           to_device(meta["is_weights"], learner.device))
        loss = losses_[-1]
    torch.cuda.synchronize()
    if KERNEL_LAUNCHES.get(lstm.KERNEL) or not np.isfinite(loss.item()):
        fail(f"{label}: an update alone launched "
             f"{KERNEL_LAUNCHES.get(lstm.KERNEL)} lstm_infer kernels")

    # timings, from the stamps
    t_start, a_start = rec["start"]
    n_env = cfg.num_actors
    first = rec.get("filled", stamps[0][:2]) if sync else stamps[0][:2]
    fill = (first[1] - a_start) * n_env / max(first[0] - t_start, 1e-9)
    training = ((stamps[-1][3] - stamps[0][1]) * n_env
                / max(stamps[-1][2] - stamps[0][0], 1e-9))
    if sync:
        gaps = np.asarray([s[2] - s[0] for s in stamps]) * 1e3
        what = "update (step + synchronise)"
    else:
        gaps = np.diff([s[0] for s in stamps]) * 1e3
        what = "dispatch interval"
    out.update(interval_p50=pct(gaps, 50), fill=fill, training=training)
    print(f"mesh {label} timings on {card}: {what} p50 "
          f"{out['interval_p50']:.2f} ms over {len(gaps)}; env steps/s "
          f"while filling {fill:.0f}, while training {training:.0f}; peak "
          f"allocated {peak / 1e9:.2f} GB; {run_s:.2f} s", flush=True)
    return out


def phase_mesh(torch, card: str, device: str = "cuda", base=None) -> dict:
    """Phase 11: the learner mesh at world size 1 over NCCL — the step
    parity, ``train_sync`` host-staged, ``train()`` from this rank's dp
    slab of the full ring, and checkpoints crossing both ways.  Returns
    the kernel's launches by run.  ``device`` and ``base`` (default: the
    card and the flagship) let a CPU rehearsal run the phase at test
    sizes."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.parallel.mesh import axis_sizes, make_mesh
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    if base is None:
        flagship_replay_config()      # the flagship's published widths
        base = Config(game_name="Fake")
    sync_cfg = base.replace(**TRAIN_REDUCED)
    ring_cfg = base.replace(**MESH_RING_REDUCED)
    need = data_bytes(ring_cfg, TRAIN_ACTIONS)
    print("reduced: world size 1 (one card) with dp = fsdp = tp = 1; "
          "train_sync: " + ", ".join(
              f"{k_} {getattr(base, k_)} -> {v}"
              for k_, v in TRAIN_REDUCED.items())
          + "; train() from the device ring: " + ", ".join(
              f"{k_} {getattr(base, k_)} -> {v}"
              for k_, v in MESH_RING_REDUCED.items())
          + f", the full ring on the card ({ring_cfg.num_blocks} blocks, "
          f"{need / 1e9:.2f} GB); fake env episodes of {FAKE_EPISODE_LEN} "
          f"steps, {TRAIN_ACTIONS} actions", flush=True)
    store = mesh_group(torch, device)     # noqa: F841 (the group's store)
    ckdirs = [tempfile.mkdtemp(prefix="chip_smoke_mesh_") for _ in range(3)]
    try:
        if dist.get_backend() != ("nccl" if device == "cuda" else "gloo"):
            fail(f"the group's backend is {dist.get_backend()}")
        mesh = make_mesh(base, device)
        if axis_sizes(mesh) != dict(dp=1, fsdp=1, tp=1):
            fail(f"mesh {axis_sizes(mesh)}")
        print(f"mesh on {card}: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, axes {mesh.mesh_dim_names} sizes "
              f"{axis_sizes(mesh)}", flush=True)
        step = mesh_step_checks(torch, card, base, mesh, device, ckdirs[0])
        sync = mesh_run(torch, card, sync_cfg, "train_sync host-staged",
                        ckdirs[1], True, device)
        gc.collect()
        torch.cuda.empty_cache()
        ring = mesh_run(torch, card, ring_cfg, "train() dp ring",
                        ckdirs[2], False, device)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for d in ckdirs:
            shutil.rmtree(d, ignore_errors=True)
    p5 = MESHLESS.get("update_p50")
    p7 = MESHLESS.get("host_sampled_interval_p50")
    a, b = step["meshless"], step["meshed"]
    print(f"mesh against meshless on {card}: train_sync update p50 "
          f"{sync['interval_p50']:.2f} ms meshed vs phase 5's "
          f"{p5 if p5 is None else f'{p5:.2f}'} ms meshless "
          f"({sync['interval_p50'] / p5 if p5 else float('nan'):.2f}x); "
          f"device-ring dispatch interval p50 {ring['interval_p50']:.2f} ms"
          f" (flagship, k = {ring_cfg.superstep_k}, 8 actors) vs phase 7's "
          f"host-sampled {p7 if p7 is None else f'{p7:.2f}'} ms (Pong, k = "
          f"4, 64 actors); lone update host wall {b['wall']:.2f} vs "
          f"{a['wall']:.2f} ms, device {b['device']:.3f} vs "
          f"{a['device']:.3f} ms, device events {b['events']:.0f} vs "
          f"{a['events']:.0f}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(sync=sync["launches"], ring=ring["launches"])


# --------------------------------------------------------------------------
# phase 12: the cross-rank draw on the card
# --------------------------------------------------------------------------

def lone(torch, fn, iters: int = 1) -> dict:
    """A call's host wall clock (``iters`` calls after the profiled ones,
    synchronised at the end), device time and device events, and the
    NCCL kernels among them (per call)."""
    events = profile_events(torch, fn, iters)
    if events is None:
        fail("no device time in a profiled call")
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return dict(wall=(time.perf_counter() - t0) / iters * 1e3,
                device=sum(ms for _, ms, _ in events),
                events=sum(c for _, _, c in events),
                nccl=[(n, ms, c) for n, ms, c in events
                      if "nccl" in n.lower()],
                top=events[:5],
                lstm=[n for n, _, _ in events if "lstm_step" in n])


def fmt_lone(a: dict, b: dict) -> str:
    """A lone meshless call ``a`` beside the meshed ``b``."""
    return (f"host wall {b['wall']:.2f} ms meshed vs {a['wall']:.2f} ms "
            f"meshless ({b['wall'] / a['wall']:.2f}x), device "
            f"{b['device']:.3f} vs {a['device']:.3f} ms, device events "
            f"{b['events']:.0f} vs {a['events']:.0f}, device idle "
            f"{1 - b['device'] / b['wall']:.1%} vs "
            f"{1 - a['device'] / a['wall']:.1%}; NCCL kernels in the "
            "meshed call: " + (", ".join(
                f"{short_kernel_name(n, 60)} x{c:.0f} ({ms:.4f} ms)"
                for n, ms, c in b["nccl"]) or "none"))


def draw_calls(k: int, dispatches: int) -> dict:
    """The collectives the design counts for ``dispatches`` in-graph
    super-steps of ``k`` inner steps (parallel/cross_rank.py): seq_meta
    and first gathered once, the leaves and the feedback gathered and the
    seven ring fields exchanged once an inner step."""
    return dict(all_gather=dispatches * (2 + 2 * k),
                all_to_all=dispatches * 7 * k)


def anakin_calls(cfg, rollouts: int, dispatches: int) -> dict:
    """The collectives the design counts for an anakin run: per actor step
    two emits, each one cut gather and one block all_to_all; per inner
    step the leaves, seq_meta, first and feedback gathered and seven row
    exchanges; per rollout and dispatch one all_reduce of the lane
    counters."""
    steps = cfg.superstep_k * cfg.anakin_env_steps_per_update
    k = cfg.superstep_k
    return dict(all_gather=(rollouts + dispatches) * 2 * steps
                + dispatches * 4 * k,
                all_to_all=(rollouts + dispatches) * 2 * steps
                + dispatches * 7 * k,
                all_reduce=rollouts + dispatches)


def mesh_draw_parity(torch, card: str, base, mesh, device: str) -> dict:
    """12(a), first: on a ring of ``MESH_CHECK_BLOCKS`` scripted blocks at
    the preset's slot shapes, one meshed in-graph super-step (k = 4)
    against the meshless one from the same ring, state and generator
    seed: sampled indices, losses, the priority slab and every new param
    bitwise (cuDNN deterministic for this check only), with the design's
    collectives, the leader's rows broadcast to its dp group (of one)
    each inner step; then each alone, timed."""
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_in_graph_per_super_step_fn,
    )
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS, CrossRank
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS, dp_group
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        gather_state,
        mesh_train_step,
    )
    from r2d2_tpu_torch.replay.device_ring import DeviceRing
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer

    dev = torch.device(device, torch.cuda.current_device()
                       if device == "cuda" else None)
    cfg = base.replace(
        buffer_capacity=MESH_CHECK_BLOCKS * base.block_length,
        learning_starts=base.block_length, device_ring_layout="dp")
    k = cfg.superstep_k
    ring = DeviceRing(cfg, TRAIN_ACTIONS, device=dev, layout="dp")
    buf = ReplayBuffer(cfg, TRAIN_ACTIONS, rng=np.random.default_rng(3),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, MESH_CHECK_BLOCKS, seed=12):
        buf.add(blk, prios, None)
    net = create_network(cfg, TRAIN_ACTIONS, device=dev,
                         generator=torch.Generator().manual_seed(0))
    plain_state = create_train_state(cfg, net.state_dict())
    mesh_state = create_train_state(cfg, net.state_dict())
    table = ShardingTable(mesh, cfg)
    step = mesh_train_step(cfg, net, table, state_template=mesh_state)
    mesh_state = table.place_state(mesh_state)
    cross = CrossRank(cfg, mesh, cfg.num_blocks, span=dp_group(mesh))
    plain = make_in_graph_per_super_step_fn(cfg, net, k)
    meshed = make_in_graph_per_super_step_fn(cfg, net, k, train_step=step,
                                             cross=cross)
    meta = ring.per_meta()
    p0 = ring.take_prios().clone()

    def gen():
        return torch.Generator(device=dev).manual_seed(cfg.seed)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pa, pb, ra, rb = p0.clone(), p0.clone(), [], []
        plain_state, pa, la = plain(plain_state, ring.snapshot(), pa,
                                    meta["seq_meta"], meta["first"],
                                    generator=gen(), record=ra)
        CROSS_RANK_CALLS.clear()
        COLLECTIVE_CALLS.clear()
        mesh_state, pb, lb = meshed(mesh_state, ring.snapshot(), pb,
                                    meta["seq_meta"], meta["first"],
                                    generator=gen(), record=rb)
        calls = dict(CROSS_RANK_CALLS)
        broadcasts = COLLECTIVE_CALLS.get("group_broadcast", 0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    full = gather_state(mesh_state)
    same_idx = len(ra) == len(rb) == k and all(
        torch.equal(x, y) for x, y in zip(ra, rb))
    bitwise = (same_idx and torch.equal(la, lb) and torch.equal(pa, pb)
               and state_equal(torch, plain_state, full))
    print(f"mesh in-graph parity on {card}: world size 1, a "
          f"{cfg.num_blocks}-block ring at the preset's slot shapes, k = "
          f"{k}: sampled indices equal {same_idx}, losses meshed "
          f"{lb.tolist()} vs meshless {la.tolist()}, priority slab max-abs "
          f"{(pa - pb).abs().max().item():.3e}; bitwise {bitwise} (cuDNN "
          f"deterministic for this check only); collectives {calls}, "
          f"group broadcasts {broadcasts}", flush=True)
    if not bitwise:
        fail("the meshed in-graph super-step is not the meshless one bit "
             "for bit")
    if broadcasts != k:
        fail(f"mesh in-graph: {broadcasts} group broadcasts for k = {k}")
    if calls != draw_calls(k, 1):
        fail(f"mesh in-graph: collectives {calls}, the design counts "
             f"{draw_calls(k, 1)}")

    arrays = ring.snapshot()
    out = dict(meshless=lone(torch, lambda: plain(
        plain_state, arrays, pa, meta["seq_meta"], meta["first"],
        generator=gen())), meshed=lone(torch, lambda: meshed(
            mesh_state, arrays, pb, meta["seq_meta"], meta["first"],
            generator=gen())))
    print(f"lone in-graph super-step on {card} (k = {k}, batch "
          f"{cfg.batch_size}, 1 profiled, 1 timed): "
          + fmt_lone(out["meshless"], out["meshed"]), flush=True)
    return out


def mesh_ig_run(torch, card: str, cfg, device: str) -> dict:
    """12(a), then: ``train(cfg, use_mesh=True)`` with in-graph PER from
    this rank's slab of the full ring (``Learner._run_device_in_graph_per``
    through parallel/cross_rank.py), its checks and timings."""
    import shutil
    import tempfile
    import warnings

    import torch.distributed as dist

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS
    from r2d2_tpu_torch.parallel.sharding import full
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    steps, k = cfg.training_steps, cfg.superstep_k
    rec = dict(start=None, stamps=[], synced={})
    probe = {}
    real_build, real_mts = train._build, step_mod.make_train_step

    def recording_mts(cfg_, net_, **kw):
        inner = real_mts(cfg_, net_, **kw)

        def step(state, batch):
            out = inner(state, batch)
            st = out[0]
            if st.step in (7, 8):
                rec["synced"][st.step] = all(
                    torch.equal(full(st.params[n]),
                                full(st.target_params[n]))
                    for n in st.params)
            return out
        return step

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        rec.update(sys_)
        actor, learner = sys_["actor"], sys_["learner"]
        run, loop = actor.run, learner._superstep_loop

        def timed_run(max_steps, stop=None):
            if rec["start"] is None:
                rec["start"] = (time.perf_counter(), actor.actor_steps)
            run(max_steps, stop)

        def stamped_loop(k_, target, t0, gate, sample, harvest,
                         prepare=None, tracer=None):
            def stamped():
                t, a = time.perf_counter(), actor.actor_steps
                out = sample()
                rec["stamps"].append((t, a, time.perf_counter(),
                                      actor.actor_steps))
                return out
            return loop(k_, target, t0, gate, stamped, harvest, prepare,
                        tracer)

        actor.run, learner._superstep_loop = timed_run, stamped_loop
        return sys_

    def log_sink(entry):
        if probe:
            return
        try:
            probe["healthz"] = http_get(entry["telemetry_port"], "/healthz")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ig_")
    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    CROSS_RANK_CALLS.clear()
    COLLECTIVE_CALLS.clear()
    torch.cuda.reset_peak_memory_stats()
    train._build, step_mod.make_train_step = capture, recording_mts
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                            use_mesh=True, device=device,
                            max_wall_seconds=MESH_WALL_S, verbose=False,
                            log_sink=log_sink)
    finally:
        train._build, step_mod.make_train_step = real_build, real_mts
        shutil.rmtree(ckdir, ignore_errors=True)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
    calls = dict(CROSS_RANK_CALLS)
    broadcasts = COLLECTIVE_CALLS.get("group_broadcast", 0)
    learner, ring, rcfg = rec["learner"], rec["ring"], rec["cfg"]
    stamps, n = rec["stamps"], len(rec["stamps"])
    fetches = HOST_TRANSFERS.get("learner.result_fetch")
    lh = m["learnhealth"]

    bad = []
    if dist.get_backend() != ("nccl" if device == "cuda" else "gloo"):
        bad.append(f"backend {dist.get_backend()}")
    if learner.mesh is None or not all(
            type(v).__name__ == "DTensor"
            for v in learner.state.params.values()):
        bad.append("the learner's state is not on the mesh")
    if (m["num_updates"] != steps or n * k != steps
            or lh["loss_count"] != steps or lh["nonfinite"]
            or not np.isfinite(m["mean_loss"])):
        bad.append(f"{m['num_updates']} updates in {n} dispatches, "
                   f"learnhealth {lh}")
    if not rcfg.in_graph_per or any(
            "host staging" in str(w.message)
            or "in_graph_per disabled" in str(w.message) for w in caught):
        bad.append("in_graph_per did not stay on")
    need = data_bytes(cfg, TRAIN_ACTIONS)
    if (ring is None or ring.layout != "dp"
            or ring.arrays["obs"].device.type != device
            or ring.nbytes() != need):
        bad.append(f"the dp slab was not the whole ring on the card "
                   f"({ring and ring.layout}, {ring and ring.nbytes()})")
    if calls != draw_calls(k, n):
        bad.append(f"collectives {calls}, the design counts "
                   f"{draw_calls(k, n)} for {n} dispatches")
    # the leader's rows to its dp group (a group of one): one an inner step
    if broadcasts != n * k:
        bad.append(f"{broadcasts} group broadcasts for {n} dispatches of "
                   f"k={k}")
    if fetches != n or learner.gate_counts["go"] != n:
        bad.append(f"{fetches} result fetches, gates "
                   f"{dict(learner.gate_counts)} for {n} dispatches")
    if launches != cfg.lstm_layers * acts or not acts or old:
        bad.append(f"lstm_infer launched {launches} times (CUDA-core "
                   f"{old}) for {acts} acts")
    if rec["synced"] != {7: False, 8: True}:
        bad.append(f"target == online after steps 7, 8: {rec['synced']}")
    if "error" in probe or probe.get("healthz", (0,))[0] != 200 or (
            json.loads(probe["healthz"][1]).get("status") != "ok"
            or m["healthz"].get("status") != "ok"):
        bad.append(f"/healthz {probe}, final {m.get('healthz')}")
    if bad:
        fail("mesh in-graph run: " + "; ".join(bad))

    t_start, a_start = rec["start"]
    n_env = cfg.num_actors
    fill = ((stamps[0][1] - a_start) * n_env
            / max(stamps[0][0] - t_start, 1e-9))
    training = ((stamps[-1][3] - stamps[0][1]) * n_env
                / max(stamps[-1][2] - stamps[0][0], 1e-9))
    gaps = np.diff([s[0] for s in stamps]) * 1e3
    print(f"mesh in-graph run on {card}: {steps} updates in {n} dispatches"
          f" of k={k} in {run_s:.2f} s, losses finite, mean loss "
          f"{m['mean_loss']:.5f}; backend {dist.get_backend()}, DTensor "
          f"state; collectives {calls} = the design's for {n} dispatches; "
          f"group broadcasts {broadcasts} = {n} x {k}; "
          f"{fetches} result fetches; gates {dict(learner.gate_counts)}; "
          f"lstm_infer launches {launches} = {cfg.lstm_layers} x {acts} "
          f"acts, CUDA-core {old}; target == online after step 7 "
          f"{rec['synced'][7]}, after 8 {rec['synced'][8]}; this rank's "
          f"dp slab on the card {ring.nbytes()} bytes = the whole ring; "
          f"/healthz ok", flush=True)
    print(f"mesh in-graph run timings on {card}: dispatch interval p50 "
          f"{pct(gaps, 50):.2f} ms over {len(gaps)}; env steps/s while "
          f"filling {fill:.0f}, while training {training:.0f}; peak "
          f"allocated {peak / 1e9:.2f} GB", flush=True)
    return dict(launches=launches, interval_p50=pct(gaps, 50), fill=fill,
                training=training, peak_gb=peak / 1e9, seconds=run_s)


def mesh_anakin_checks(torch, card: str, base, mesh, device: str) -> dict:
    """12(b), first: on a ring of ``ANAKIN_CHECK_BLOCKS`` blocks at the
    full slot shapes, cuDNN deterministic, the meshed plane (world size
    1) against the meshless plane from one seed: the warm-up rollouts and
    one training dispatch give the same loop state — every payload array,
    ring, PER leaves and carry — the same losses and params, bit for bit,
    with the lanes split over dp and with the replicated lane axis forced
    (the fallback for lanes that do not divide over dp or outnumber a
    slab's blocks); the meshed plane's snapshot reads into a fresh
    meshless plane bit for bit; then each dispatch alone, timed."""
    import shutil
    import tempfile

    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.parallel.sharding import ShardingTable
    from r2d2_tpu_torch.replay.device_ring import DeviceRing

    dev = torch.device(device, torch.cuda.current_device()
                       if device == "cuda" else None)
    cfg = base.replace(
        buffer_capacity=ANAKIN_CHECK_BLOCKS * base.block_length,
        learning_starts=ANAKIN_CHECK_STARTS, device_replay=True,
        in_graph_per=True)
    table = ShardingTable(mesh, cfg)

    def build(seed, meshed, replicate=False):
        net = create_network(cfg, TRAIN_ACTIONS, device=dev,
                             generator=torch.Generator().manual_seed(seed))
        learner = Learner(cfg, net, create_train_state(cfg,
                                                       net.state_dict()),
                          mesh=mesh if meshed else None,
                          table=table if meshed else None)
        ring = DeviceRing(cfg, TRAIN_ACTIONS, device=dev,
                          layout="dp" if meshed else "replicated")
        plane = AnakinPlane(cfg, net, TRAIN_ACTIONS, ring,
                            table=table if meshed else None,
                            state_template=learner.state,
                            replicate_lanes=replicate)
        return plane, learner

    def drive(plane, learner):
        while not plane.ready:
            plane.rollout_step(learner.state.params)
        learner.state, res = plane.dispatch(learner.state)
        return plane.harvest(res)

    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_anakin_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pa, la = build(5, False)
        loss_a = drive(pa, la)
        pay_a = pa._payload()
        params_a = la.full_params()

        def same_as_meshless(plane, learner):
            loss = drive(plane, learner)
            pay, params = plane._payload(), learner.full_params()
            ok = (np.array_equal(loss_a, loss) and sorted(pay_a) == sorted(pay)
                  and all(np.array_equal(pay_a[k], pay[k]) for k in pay_a)
                  and all(torch.equal(params_a[k], params[k])
                          for k in params_a))
            return ok, pay

        pr, lr = build(5, True, replicate=True)
        replicated, _ = same_as_meshless(pr, lr)
        replicated = replicated and pr.replicated_lanes
        del pr, lr
        pb, lb = build(5, True)
        same, pay_b = same_as_meshless(pb, lb)
        meta = pb.write_state(os.path.join(d, "anakin.bin"))
        pc, _ = build(6, False)
        pc.read_state(os.path.join(d, "anakin.bin"), meta)
        pay_c = pc._payload()
        resumed = all(np.array_equal(pay_b[k], pay_c[k]) for k in pay_b)
        del pc
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(d, ignore_errors=True)
    print(f"mesh anakin parity on {card}: world size 1, a "
          f"{cfg.num_blocks}-block ring at the full slot shapes, cuDNN "
          f"deterministic: warm-up and one training dispatch meshed == "
          f"meshless over {len(pay_a)} payload arrays, the losses and every"
          f" param: {same}; the same with the replicated lane axis forced: "
          f"{replicated}; the meshed snapshot read into a meshless plane "
          f"bit for bit: {resumed}", flush=True)
    if not (same and replicated and resumed):
        fail("mesh anakin: a meshed plane (lanes split or replicated) is "
             "not the meshless plane bit for bit, or its snapshot does not "
             "read back")

    def one(plane, learner):
        def fn():
            learner.state, res = plane.dispatch(learner.state)
            plane.harvest(res)
        return fn

    out = dict(meshless=lone(torch, one(pa, la)),
               meshed=lone(torch, one(pb, lb)))
    print(f"lone anakin training dispatch on {card} (k = "
          f"{cfg.superstep_k} x (E = {cfg.anakin_env_steps_per_update} "
          f"steps of {cfg.num_actors} lanes + 1 train step), 1 profiled, "
          f"1 timed): "
          + fmt_lone(out["meshless"], out["meshed"]), flush=True)
    return out


def mesh_anakin_run(torch, card: str, cfg, device: str) -> dict:
    """12(b), then: ``train(cfg, use_mesh=True)`` with the anakin
    transport on this rank's slab of the full ring; its checks and
    timings.  The second dispatch runs under
    ``set_sync_debug_mode("error")``."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.learner import anakin
    from r2d2_tpu_torch.learner import step as step_mod
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.parallel.cross_rank import CROSS_RANK_CALLS
    from r2d2_tpu_torch.parallel.distributed import COLLECTIVE_CALLS
    from r2d2_tpu_torch.parallel.sharding import full
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    k, N = cfg.superstep_k, cfg.num_actors
    fetches = "anakin.result_fetch"
    rec = dict(rollouts=[], dispatches=[], bad=[], synced={},
               sync_checked=None)
    probe = {}
    real_loop, real_mts = anakin.run_anakin_loop, step_mod.make_train_step

    def recording_mts(cfg_, net_, **kw):
        inner = real_mts(cfg_, net_, **kw)

        def step(state, batch):
            out = inner(state, batch)
            st = out[0]
            if st.step in (7, 8):
                rec["synced"][st.step] = all(
                    torch.equal(full(st.params[n]),
                                full(st.target_params[n]))
                    for n in st.params)
            return out
        return step

    def loop(learner, plane, **kw):
        rec.update(learner=learner, plane=plane)
        roll, disp = plane.rollout_step, plane.dispatch

        def rollout_step(params):
            f0, t = HOST_TRANSFERS.get(fetches), time.perf_counter()
            roll(params)
            rec["rollouts"].append((t, time.perf_counter()))
            if HOST_TRANSFERS.get(fetches) - f0 != 1:
                rec["bad"].append("a rollout did not fetch once")

        def dispatch(state):
            t = time.perf_counter()
            if len(rec["dispatches"]) == 1:
                # one training dispatch under the sync debug mode: any
                # device->host synchronisation in it raises
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = disp(state)
                except RuntimeError as e:
                    rec["sync_checked"] = repr(e)
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                rec["sync_checked"] = "clean"
            else:
                out = disp(state)
            rec["dispatches"].append((t, time.perf_counter()))
            return out

        plane.rollout_step, plane.dispatch = rollout_step, dispatch
        return real_loop(learner, plane, **kw)

    def log_sink(entry):
        if probe:
            return
        try:
            probe["healthz"] = http_get(entry["telemetry_port"], "/healthz")
        except Exception as e:  # checked below, after the run
            probe["error"] = f"{type(e).__name__}: {e}"

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_anakin_run_")
    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    CROSS_RANK_CALLS.clear()
    COLLECTIVE_CALLS.clear()
    torch.cuda.reset_peak_memory_stats()
    anakin.run_anakin_loop, step_mod.make_train_step = loop, recording_mts
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, checkpoint_dir=ckdir, use_mesh=True,
                        max_wall_seconds=MESH_WALL_S, verbose=False,
                        device=device, log_sink=log_sink)
    except RuntimeError as e:
        fail(f"mesh anakin run: {e} (sync debug check: "
             f"{rec['sync_checked']})")
    finally:
        anakin.run_anakin_loop, step_mod.make_train_step = real_loop, \
            real_mts
        shutil.rmtree(ckdir, ignore_errors=True)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = (KERNEL_LAUNCHES.get(lstm.KERNEL)
                + KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER))
    plane, learner = rec["plane"], rec["learner"]
    ring = plane.ring
    n_roll, n_disp = len(rec["rollouts"]), len(rec["dispatches"])
    calls = dict(CROSS_RANK_CALLS)
    want_calls = anakin_calls(cfg, n_roll, n_disp)
    lh = m["learnhealth"]

    bad = list(rec["bad"])
    if dist.get_backend() != ("nccl" if device == "cuda" else "gloo"):
        bad.append(f"backend {dist.get_backend()}")
    if learner.mesh is None or plane.cross is None or not all(
            type(v).__name__ == "DTensor"
            for v in learner.state.params.values()):
        bad.append("the learner's state or the plane is not on the mesh")
    if (m["num_updates"] != cfg.training_steps or n_disp * k
            != cfg.training_steps or lh["loss_count"] != cfg.training_steps
            or lh["nonfinite"] or m["dispatch_wedged"]
            or m["fabric_failed"]):
        bad.append(f"{m['num_updates']} updates in {n_disp} dispatches, "
                   f"learnhealth {lh}, wedged {m['dispatch_wedged']}")
    if rec["sync_checked"] != "clean":
        bad.append(f"sync debug check {rec['sync_checked']}")
    if HOST_TRANSFERS.get(fetches) != n_roll + n_disp:
        bad.append(f"{HOST_TRANSFERS.get(fetches)} result fetches for "
                   f"{n_roll} rollouts and {n_disp} dispatches")
    if calls != want_calls:
        bad.append(f"collectives {calls}, the design counts {want_calls}")
    # every rank of a dp group steps the group's lanes: nothing broadcast
    if COLLECTIVE_CALLS.get("group_broadcast", 0):
        bad.append(f"{COLLECTIVE_CALLS['group_broadcast']} group "
                   "broadcasts in anakin")
    blt = int(plane.state["block_learning_total"].sum())
    if plane.fill != blt or plane.fill < cfg.learning_starts:
        bad.append(f"fill {plane.fill} != block_learning_total sum {blt}")
    need = data_bytes(cfg.replace(device_replay=True, in_graph_per=True),
                      TRAIN_ACTIONS)
    if (ring.layout != "dp" or ring.arrays["obs"].device.type != device
            or ring.nbytes() != need):
        bad.append(f"ring {ring.layout} {ring.nbytes()} bytes on "
                   f"{ring.arrays['obs'].device}")
    if launches:
        bad.append(f"lstm_infer launched {launches} times")
    if rec["synced"] != {7: False, 8: True}:
        bad.append(f"target == online after steps 7, 8: {rec['synced']}")
    if plane.eval_episodes_total < N:
        bad.append(f"eval episodes {plane.eval_episodes_total}")
    if "error" in probe or probe.get("healthz", (0,))[0] != 200 or (
            json.loads(probe["healthz"][1]).get("status") != "ok"
            or m["healthz"].get("status") != "ok"):
        bad.append(f"/healthz {probe}, final {m.get('healthz')}")
    if bad:
        fail("mesh anakin run: " + "; ".join(bad))

    fpd = plane.roll_steps * N
    r, d = rec["rollouts"], rec["dispatches"]
    fill_fps = n_roll * fpd / max(r[-1][1] - r[0][0], 1e-9)
    train_fps = n_disp * fpd / max(d[-1][1] - d[0][0], 1e-9)
    issue = np.asarray([x[1] - x[0] for x in d]) * 1e3
    print(f"mesh anakin run on {card}: {m['num_updates']} updates in "
          f"{n_disp} dispatches of k={k} after {n_roll} rollouts, "
          f"{run_s:.2f} s; backend {dist.get_backend()}, DTensor state; "
          f"result fetches {HOST_TRANSFERS.get(fetches)} = {n_roll} + "
          f"{n_disp}; collectives {calls} = the design's, no group "
          f"broadcast; dispatch 2 under "
          f"set_sync_debug_mode('error'): clean; losses finite, mean "
          f"{m['mean_loss']:.5f}; eval episodes "
          f"{plane.eval_episodes_total}; fill {plane.fill} = sum of "
          f"block_learning_total; lstm_infer launches {launches}; target "
          f"== online after step 7 {rec['synced'][7]}, after 8 "
          f"{rec['synced'][8]}; /healthz ok", flush=True)
    print(f"mesh anakin run timings on {card}: env frames/s while filling "
          f"{fill_fps:.1f}, while training {train_fps:.1f}; dispatch issue "
          f"{', '.join(f'{x:.2f}' for x in issue)} ms; ring "
          f"{ring.nbytes() / 1e9:.2f} GB, peak allocated {peak / 1e9:.2f} "
          f"GB", flush=True)
    return dict(launches=launches, fill_fps=fill_fps, train_fps=train_fps,
                peak_gb=peak / 1e9, seconds=run_s)


def phase_mesh_draw(torch, card: str, device: str = "cuda", ig_base=None,
                    anakin_base=None) -> dict:
    """Phase 12: the cross-rank draw at world size 1 over NCCL — (a) the
    Pong preset's in-graph PER on the mesh, (b) the README's anakin
    config on the mesh, each held bitwise to its meshless path and then
    trained by ``train(cfg, use_mesh=True)`` from the full ring.  Returns
    the kernel's launches by path.  ``device`` and the bases (default:
    the card and the published configs) let a CPU rehearsal run the phase
    at test sizes."""
    import gc

    import torch.distributed as dist

    from r2d2_tpu_torch.config import Config, pong_config
    from r2d2_tpu_torch.parallel.mesh import axis_sizes, make_mesh
    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(MESH_DRAW_WATCHDOG_S)
    if ig_base is None:
        ig_base = pong_config(game_name="Fake")
        anakin_base = Config(game_name="Fake", actor_transport="anakin",
                             anakin_env="grid")
    ig_cfg = ig_base.replace(**MESH_IG_REDUCED)
    an_cfg = anakin_base.replace(**MESH_ANAKIN_REDUCED)
    print("reduced: world size 1 (one card), dp = fsdp = tp = 1; (a) "
          "in-graph PER: " + ", ".join(
              f"{k_} {getattr(ig_base, k_)} -> {v}"
              for k_, v in MESH_IG_REDUCED.items())
          + f", the full ring on the card ({ig_cfg.num_blocks} blocks, "
          f"{data_bytes(ig_cfg, TRAIN_ACTIONS) / 1e9:.2f} GB); (b) anakin: "
          + ", ".join(f"{k_} {getattr(anakin_base, k_)} -> {v}"
                      for k_, v in MESH_ANAKIN_REDUCED.items())
          + f", the full ring ({an_cfg.num_blocks} blocks); the parity "
          f"checks: a lone super-step 1 call profiled and 1 timed, the "
          f"anakin planes' warm-up {ANAKIN_CHECK_STARTS} transitions",
          flush=True)
    store = mesh_group(torch, device)     # noqa: F841 (the group's store)
    try:
        if dist.get_backend() != ("nccl" if device == "cuda" else "gloo"):
            fail(f"the group's backend is {dist.get_backend()}")
        mesh = make_mesh(ig_base, device)
        if axis_sizes(mesh) != dict(dp=1, fsdp=1, tp=1):
            fail(f"mesh {axis_sizes(mesh)}")
        parts = [time.perf_counter()]
        ig = mesh_draw_parity(torch, card, ig_base.replace(
            device_replay=True, in_graph_per=True), mesh, device)
        parts.append(time.perf_counter())
        ig_run = mesh_ig_run(torch, card, ig_cfg, device)
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
        an = mesh_anakin_checks(torch, card, anakin_base, mesh, device)
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
        an_run = mesh_anakin_run(torch, card, an_cfg, device)
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
    finally:
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 12 on {card}: (a) lone super-step host wall "
          f"{ig['meshed']['wall']:.2f} vs {ig['meshless']['wall']:.2f} ms "
          f"meshless, run dispatch interval p50 "
          f"{ig_run['interval_p50']:.2f} ms, env steps/s filling "
          f"{ig_run['fill']:.0f} training {ig_run['training']:.0f}, peak "
          f"{ig_run['peak_gb']:.2f} GB; (b) lone dispatch host wall "
          f"{an['meshed']['wall']:.2f} vs {an['meshless']['wall']:.2f} ms "
          f"meshless, env frames/s filling {an_run['fill_fps']:.1f} "
          f"training {an_run['train_fps']:.1f}, peak "
          f"{an_run['peak_gb']:.2f} GB; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s (in-graph checks, run, "
          f"anakin checks, run: "
          + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
          + " s)", flush=True)
    return dict(in_graph=ig_run["launches"], anakin=an_run["launches"])


# --------------------------------------------------------------------------
# phase 13: the league
# --------------------------------------------------------------------------

def league_config():
    """The flagship with its 8 lanes in two member fleets, acting through
    the trainer's service, and the eval sidecar on, checked against the
    flagship's published widths."""
    from r2d2_tpu_torch.config import Config

    base = Config(game_name="Fake", actor_transport="process",
                  actor_fleets=2, actor_inference="serve",
                  population_spec=LEAGUE_SPEC, league_eval=True,
                  league_eval_episodes=2)
    literal = dict(torso="nature", stored_obs_shape=(21, 21, 16),
                   hidden_dim=H, lstm_layers=1, compute_dtype="bfloat16",
                   num_actors=8, buffer_capacity=2_000_000,
                   block_length=400)
    got = {k: getattr(base, k) for k in literal}
    if got != literal:
        fail(f"the league config is not the flagship: {got}")
    return base


def league_run(torch, card: str, cfg, chaos: bool) -> dict:
    """One of phase 13's ``train()`` runs.  The main run trains until the
    sidecar has scored ``LEAGUE_SWEEPS`` complete sweeps on a live
    /statusz and the learner has taken ``LEAGUE_MIN_UPDATES``; the chaos
    drill until the learner has updated after the sidecar's respawn budget
    ran out.  A live poller reads /statusz, /metrics and /healthz, the
    sidecar's ``/proc`` maps and CPU seconds, and the card's compute
    processes.  Returns the run's checks and timings."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.league import eval_service
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    real_build, real_start = train._build, eval_service.EvalSidecar.start
    rec = dict(updates=[], entries=[], port=None, live=None, sidecar=None,
               procs=[], failed_at=None, after=None, healthz=None,
               ingested=[0, 0])
    done, finished = threading.Event(), threading.Event()

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        rec.update(sys_)
        learner = sys_["learner"]
        step = learner._step_fn

        def timed_step(state, batch):
            rec["updates"].append(time.perf_counter())
            return step(state, batch)

        learner._step_fn = timed_step
        return sys_

    def start(self):
        real_start(self)
        rec["sidecar"] = self

    def log_sink(entry):
        rec["port"] = entry["telemetry_port"]
        pop = entry.get("fleet", {}).get("population", {}).get("members")
        rec["entries"].append((time.perf_counter(),
                               [r["env_steps"] for r in pop or []]))
        if pop:
            rec["ingested"] = [r["blocks_ingested"] for r in pop]
        h = (entry.get("league") or {}).get("health") or {}
        if chaos and h.get("failed") and rec["failed_at"] is None:
            rec["failed_at"] = len(rec["updates"])

    def sidecar_proc():
        sc = rec["sidecar"]
        p = sc.proc if sc is not None else None
        if p is None or not p.is_alive():
            return None
        try:
            return (time.perf_counter(), proc_report(p.pid))
        except OSError:
            return None

    def poll():
        # live reads while the run trains; the run stops when they are in
        while not finished.is_set():
            time.sleep(0.5)
            if rec["port"] is None:
                continue
            try:
                if poll_once():
                    done.set()
                    return
            except (OSError, ValueError):
                continue   # the exporter between two requests: ask again

    def poll_once() -> bool:
        """One round of live reads; True once the run's checks are in."""
        if chaos:
            if rec["failed_at"] is not None and rec["healthz"] is None:
                rec["healthz"] = http_get(rec["port"], "/healthz")
            if (rec["healthz"] is not None and min(rec["ingested"]) > 0
                    and len(rec["updates"])
                    >= rec["failed_at"] + LEAGUE_DRILL_UPDATES):
                rec["after"] = len(rec["updates"]) - rec["failed_at"]
                return True
            return False
        code, body = http_get(rec["port"], "/statusz")
        entry = json.loads(body).get("last_entry") or {}
        lg = entry.get("league") or {}
        pop = ((entry.get("fleet") or {}).get("population")
               or {}).get("members") or []
        if lg.get("rows") and not rec["procs"]:
            # the sidecar has scored: its maps and CPU seconds, and the
            # card's compute processes
            got = sidecar_proc()
            if got is not None:
                rec["procs"].append(got)
                smi = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60)
                rec["smi"] = (smi.returncode, smi.stdout.split(),
                              got[1]["pid"])
        if not (code == 200 and lg.get("sweeps", 0) >= LEAGUE_SWEEPS
                and len(lg.get("table") or []) == 2 and len(pop) == 2
                and all(r["blocks"] > 0 for r in pop)
                and len(rec["updates"]) >= LEAGUE_MIN_UPDATES
                and rec["procs"]):
            return False
        got = sidecar_proc()
        if got is not None:
            rec["procs"].append(got)
        rec["live"] = dict(league=lg, population=pop,
                           metrics=http_get(rec["port"], "/metrics"),
                           healthz=http_get(rec["port"], "/healthz"))
        return True

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_league_")
    poller = threading.Thread(target=poll, daemon=True)
    try:
        KERNEL_LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats()
        train._build = capture
        eval_service.EvalSidecar.start = start
        poller.start()
        t0 = time.perf_counter()
        try:
            m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                            max_wall_seconds=LEAGUE_WALL_S, verbose=False,
                            log_sink=log_sink, stop_fn=done.is_set)
        finally:
            train._build = real_build
            eval_service.EvalSidecar.start = real_start
            finished.set()
            poller.join(30)
        run_s = time.perf_counter() - t0
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        rows = eval_service.read_league(ckdir)
        metas = {int(n[len("step_"):-len(".meta.json")]):
                 os.path.getmtime(os.path.join(ckdir, n))
                 for n in os.listdir(ckdir) if n.endswith(".meta.json")}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    label = "chaos drill" if chaos else "run"
    if not done.is_set():
        fail(f"league {label}: the wall budget ({LEAGUE_WALL_S} s) ran out "
             f"before its checks were in: {len(rec['updates'])} updates, "
             f"failed at {rec['failed_at']}, live {rec['live']}")
    lh, plane, buffer = m["learnhealth"], rec["plane"], rec["buffer"]
    restarts = {n: h["restarts"] for n, h in m["health"].items()}
    bpm = m["blocks_per_member"]
    if (lh["nonfinite"] or lh["loss_count"] != m["num_updates"]
            or not np.isfinite(m["mean_loss"]) or m["num_updates"] < 1
            or m["fabric_failed"] or any(restarts.values())
            or set(bpm) != {0, 1} or min(bpm.values()) < 1):
        fail(f"league {label}: {m['num_updates']} updates, learnhealth "
             f"{lh}, failed {m['fabric_failed']}, thread restarts "
             f"{restarts}, blocks per member {bpm}")
    pop = m["fleet_health"]["population"]["members"]
    if (len(pop) != 2 or any(r["env_steps"] < 1 or r["blocks"] < 1
                             for r in pop)
            or pop[1]["preset"] != "low_resource"):
        fail(f"league {label}: population rows {pop}")
    svc = plane.service
    h = svc.health()
    want = cfg.lstm_layers * (h["batches"] + h["warmups"])
    if launches != want or old:
        fail(f"league {label}: lstm_infer launched {launches} times "
             f"(CUDA-core {old}) for {h['batches']} service batches + "
             f"{h['warmups']} warm-up x {cfg.lstm_layers} layer")
    out = dict(launches=launches, seconds=run_s, updates=m["num_updates"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               batches=h["batches"], warmups=h["warmups"])
    if chaos:
        code, body = rec["healthz"]
        hz = json.loads(body)
        if (code != 200 or hz.get("status") != "degraded"
                or not hz.get("league", {}).get("failed")
                or m["chaos"].get("kill_eval_sidecar", 0) < 1
                or not m["league"]["health"]["failed"]):
            fail(f"league chaos drill: /healthz {code} {hz}, chaos "
                 f"{m['chaos']}, league {m['league']}, {len(rows)} rows")
        print(f"league chaos drill on {card}: kill_eval_sidecar fired "
              f"{m['chaos']['kill_eval_sidecar']} times; the sidecar's "
              f"budget ran out after {rec['sidecar'].restarts} respawns "
              f"(update {rec['failed_at']}); /healthz {code} "
              f"{hz['status']} with league.failed; {rec['after']} updates "
              f"after that, {m['num_updates']} in all, losses finite; "
              f"blocks per member {bpm}; lstm_infer {launches} = "
              f"{cfg.lstm_layers} x ({h['batches']} + {h['warmups']}), "
              f"CUDA-core 0; {run_s:.1f} s", flush=True)
        return out

    # the main run: the sidecar's record, its live view, its process
    table = eval_service.league_table(rows, 2)
    pairs = [(r["step"], r["member"]) for r in rows]
    live = rec["live"]
    code, body = live["healthz"]
    mcode, metrics = live["metrics"]
    if (table["sweeps"] < LEAGUE_SWEEPS or len(pairs) != len(set(pairs))
            or any(set(r) != LEAGUE_ROW_KEYS for r in rows)
            or not all(np.isfinite(r["mean_reward"]) for r in rows)
            or m["league"]["sweeps"] < LEAGUE_SWEEPS
            or m["league"]["health"]["failed"]):
        fail(f"league: league.jsonl {len(rows)} rows, {table['sweeps']} "
             f"sweeps, duplicates {len(pairs) - len(set(pairs))}, keys "
             f"{[sorted(r) for r in rows[:1]]}; metrics league "
             f"{m['league']}")
    if (code != 200 or json.loads(body).get("status") != "ok"
            or m["healthz"].get("status") != "ok" or mcode != 200
            or 'r2d2_population_env_steps_total{member="1"}' not in metrics
            or "r2d2_league_sweeps_total" not in metrics
            or live["league"]["members"] != 2):
        fail(f"league: live /healthz {code} {body[:300]}, /metrics "
             f"{mcode}, /statusz league {live['league']}")
    (t_a, first), (t_b, last) = rec["procs"][0], rec["procs"][-1]
    smi_rc, smi_pids, pid = rec["smi"]
    if (first["device"] or first["jax"] or last["device"] or last["jax"]
            or smi_rc != 0 or str(pid) in smi_pids or len(smi_pids) > 1):
        fail(f"league: the sidecar (pid {pid}) maps {first} / {last}; "
             f"nvidia-smi compute apps {smi_pids} (rc {smi_rc})")
    # timings, from the stamps: the learner's update interval, each
    # member's env steps/s filling and training (from the log entries'
    # population rows), each sweep's latency from its checkpoint's commit
    # to its last row, and the sidecar's CPU cores
    ups = rec["updates"]
    gaps = np.diff(ups) * 1e3
    t_train = ups[0]
    ent = [e for e in rec["entries"] if len(e[1]) == 2]

    def rates(lo, hi):
        sel = [e for e in ent if lo <= e[0] <= hi]
        if len(sel) < 2:
            return [float("nan")] * 2
        (ta, a), (tb, b) = sel[0], sel[-1]
        return [(y - x) / max(tb - ta, 1e-9) for x, y in zip(a, b)]

    def rows_of(pop):
        return [(r["member"], r["name"], r["preset"], r["env_steps"],
                 r["blocks"]) for r in pop]

    fill = rates(0.0, t_train)
    training = rates(t_train, float("inf"))
    by_step = {}
    for r in rows:
        by_step.setdefault(r["step"], []).append(r["time"])
    sweep_s = [max(ts) - metas[s] for s, ts in by_step.items()
               if len(ts) == 2 and s in metas]
    cores = (last["cpu_s"] - first["cpu_s"]) / max(t_b - t_a, 1e-9)
    out.update(interval_p50=pct(gaps, 50), fill=fill, training=training,
               sweep_p50=pct(sweep_s, 50), sweep_max=max(sweep_s,
                                                         default=float("nan")),
               sidecar_cores=cores, sweeps=table["sweeps"], rows=len(rows))
    print(f"league run on {card}: {m['num_updates']} updates in "
          f"{run_s:.2f} s, losses finite {lh['loss_count']}; blocks per "
          f"member {bpm}; population (member, name, preset, env steps, "
          f"blocks) {rows_of(pop)}; "
          f"league.jsonl {len(rows)} rows, {table['sweeps']} complete "
          f"sweeps, no duplicate (step, member), the reference's keys; "
          f"live /statusz: {live['league']['sweeps']} sweeps, "
          f"{len(live['league']['table'])} table rows; /metrics carries "
          f"the population and league series; /healthz ok; lstm_infer "
          f"{launches} = {cfg.lstm_layers} x ({h['batches']} service "
          f"batches + {h['warmups']} warm-up), CUDA-core 0; the sidecar "
          f"(pid {pid}) holds no card (no /dev/nvidia* open or mapped) and "
          f"no JAX (libtorch mapped: {first['torch']}, and with it the "
          f"driver library: {first['cuda']}), not among the card's compute "
          f"apps {smi_pids}", flush=True)
    print(f"league timings on {card}: update interval p50 "
          f"{out['interval_p50']:.2f} ms ({len(gaps)} intervals); env "
          f"steps/s per member filling {fmt_list(fill, 1)}, training "
          f"{fmt_list(training, 1)}; a sweep ({cfg.league_eval_episodes} "
          f"episodes x 2 members on the CPU) from its checkpoint's commit "
          f"to its last row p50 {out['sweep_p50']:.2f} s, max "
          f"{out['sweep_max']:.2f} s over {len(sweep_s)} sweeps; the "
          f"sidecar's CPU cores {cores:.2f} of {os.cpu_count()}; peak "
          f"{out['peak_gb']:.2f} GB", flush=True)
    out["twin"] = served_vs_twin(torch, card, cfg, svc)
    return out


def phase_league(torch, card: str) -> dict:
    """Phase 13: the league.  The flagship's lanes in two member fleets
    train through ``train()`` from its full host ring while the CPU eval
    sidecar scores both members on every complete checkpoint, then the
    kill-sidecar chaos drill.  Returns the kernel's launches by run."""
    import gc

    from r2d2_tpu_torch.replay.replay_buffer import data_bytes

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(LEAGUE_WATCHDOG_S)
    base = league_config()
    need = data_bytes(base, TRAIN_ACTIONS)
    if mem_available() < 1.2 * need:
        fail(f"MemAvailable {mem_available()} bytes; the host ring needs "
             f"{need}")
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in LEAGUE_REDUCED.items())
        + f", training_steps {base.training_steps} -> until "
        f"{LEAGUE_SWEEPS} sweeps and {LEAGUE_MIN_UPDATES} updates (chaos "
        f"drill: learning_starts -> {LEAGUE_DRILL_STARTS}, until "
        f"{LEAGUE_DRILL_UPDATES} updates after the sidecar failed), a "
        f"{LEAGUE_WALL_S} s wall budget a run; the full host ring, "
        f"{base.num_blocks} blocks ({need / 1e9:.2f} GB); 8 lanes in 2 "
        f"member fleets of 4; os.cpu_count() {os.cpu_count()}", flush=True)
    cfg = base.replace(training_steps=10 ** 9, **LEAGUE_REDUCED)
    main_run = league_run(torch, card, cfg, chaos=False)
    gc.collect()
    drill = league_run(torch, card, cfg.replace(
        chaos_spec="kill_eval_sidecar:every=1,n=1000000",
        learning_starts=LEAGUE_DRILL_STARTS), chaos=True)
    gc.collect()
    torch.cuda.empty_cache()
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return dict(run=main_run["launches"], chaos=drill["launches"])


# --------------------------------------------------------------------------
# phase 14: telemetry and guards on the card
# --------------------------------------------------------------------------

def diag_rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-scalar relative difference of two diag vectors (absolute where
    the reference is 0)."""
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def near_edges(values: np.ndarray, edges) -> int:
    """How many of ``values`` lie within ``DIAG_EDGE_EPS`` of a bucket
    edge: a value there may bucket differently on the card and the CPU."""
    v = np.asarray(values, np.float64).reshape(-1, 1)
    return int((np.abs(v - np.asarray(edges, np.float64)[None, :])
                <= DIAG_EDGE_EPS).any(axis=1).sum())


def diag_card_vs_cpu(torch, base, device: str = "cuda") -> dict:
    """(a): one armed train step of the flagship net, f32 on the card
    against f32 on the CPU from the same params on the same batch: the
    twelve scalars within ``DIAG_RTOL`` relative, the bucket counts equal
    up to the values within ``DIAG_EDGE_EPS`` of an edge; then the bf16
    step on the card, printed against the f32 CPU diag and not held."""
    from r2d2_tpu_torch.learner.step import (
        _loss_net,
        create_train_state,
        loss_and_priorities,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.telemetry import learnhealth as lhm

    out, edge_vals = {}, None
    for dev, dtype in ((device, "float32"), ("cpu", "float32"),
                       (device, "bfloat16")):
        cfg = base.replace(compute_dtype=dtype, learnhealth_interval=1)
        net = create_network(cfg, TRAIN_ACTIONS, device=dev,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(cfg, net.state_dict())
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in step_batch(cfg, seed=14).items()}
        if dev == "cpu":
            with torch.no_grad():
                _, _, aux = loss_and_priorities(
                    cfg, _loss_net(net), state.params, state.target_params,
                    batch, with_aux=True)
            td, mask = aux[0].numpy(), aux[1].numpy()
            edge_vals = (near_edges(np.abs(td)[mask], lhm.TD_ABS_EDGES)
                         + near_edges(batch["is_weights"].numpy(),
                                      lhm.IS_WEIGHT_EDGES))
        _, loss, _, diag = make_train_step(cfg, net, learnhealth=True)(
            state, batch)
        out[(dev, dtype)] = diag.float().cpu().numpy()
    card = out[(device, "float32")]
    cpu = out[("cpu", "float32")]
    bf16 = out[(device, "bfloat16")]
    n = len(lhm.DIAG_SCALARS)
    rel = diag_rel(card[:n], cpu[:n])
    buckets = np.abs(card[n:] - cpu[n:]).sum()
    worst = int(np.argmax(rel))
    print(f"diag card vs CPU (flagship widths, f32, batch "
          f"{base.batch_size}, T={base.seq_len}): armed {card[0]:.0f}/"
          f"{cpu[0]:.0f}; scalars max relative {rel.max():.3e} at "
          f"{lhm.DIAG_SCALARS[worst]} (tol {DIAG_RTOL:.0e}); bucket counts "
          f"differ by {buckets:.0f} with {edge_vals} values within "
          f"{DIAG_EDGE_EPS:.0e} of an edge; dq_mean {cpu[8]:.5f}, dq_max "
          f"{cpu[9]:.5f}, grad_norm {cpu[3]:.5f}", flush=True)
    rel_bf = diag_rel(bf16[:n], cpu[:n])
    print("diag bf16 card vs f32 CPU (printed, not held): " + ", ".join(
        f"{name} {r:.2e}" for name, r in zip(lhm.DIAG_SCALARS, rel_bf))
        + f"; bucket counts differ by {np.abs(bf16[n:] - cpu[n:]).sum():.0f}",
        flush=True)
    if not (np.isfinite(card).all() and np.isfinite(cpu).all()
            and card[0] == 1.0 and cpu[0] == 1.0):
        fail(f"the armed diag is not finite and armed: {card} / {cpu}")
    if rel.max() > DIAG_RTOL or buckets > 2 * edge_vals:
        fail(f"the card's diag disagrees with the CPU's: scalars "
             f"{rel.tolist()}, buckets {card[n:]} vs {cpu[n:]}")
    return dict(max_rel=float(rel.max()), bucket_diff=float(buckets),
                near_edge=edge_vals)


def armed_step_cost(torch, base, device: str = "cuda") -> dict:
    """The device time of an armed train step against a disarmed one at
    the run's widths (bf16): the ΔQ re-unroll, the norms and histograms."""
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network

    cfg = base.replace(learnhealth_interval=1)
    net = create_network(cfg, TRAIN_ACTIONS, device=device,
                         generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in step_batch(cfg, seed=15).items()}
    out = {}
    for label, lh in (("armed", True), ("disarmed", False)):
        state = create_train_state(cfg, net.state_dict())
        step = make_train_step(cfg, net, learnhealth=lh)
        box = [state]

        def fn():
            box[0] = step(box[0], batch)[0]

        out[label] = device_ms(torch, fn, iters=LH_COST_ITERS)
    return out


def lh_run(torch, card: str, cfg, label: str, ckdir: str,
           device: str = "cuda") -> dict:
    """One of (b)'s ``train()`` runs: the rows the monitor absorbed, the
    learner's result fetches, the kernel's launches and the update
    interval, in the capture window and after it."""
    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.telemetry import learnhealth as lhm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    real_build = train._build
    real_absorb = lhm.LearnHealthMonitor.absorb_diags
    rec = dict(stamps=[], rows=[])
    probe = {}

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        learner = sys_["learner"]
        step = learner._step_fn

        def stamped(state, batch):
            rec["stamps"].append(time.perf_counter())
            return step(state, batch)

        learner._step_fn = stamped
        return sys_

    def absorb(self, diags):
        rec["rows"].extend(np.asarray(diags, np.float64)
                           .reshape(-1, lhm.DIAG_SIZE))
        return real_absorb(self, diags)

    def log_sink(entry):
        if "alertz" in probe:
            return
        try:
            probe["alertz"] = http_get(entry["telemetry_port"], "/alertz")
        except Exception as e:   # checked below, after the run
            probe["alertz"] = (0, f"{type(e).__name__}: {e}")

    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    train._build = capture
    lhm.LearnHealthMonitor.absorb_diags = absorb
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                        max_wall_seconds=LH_WALL_S, verbose=False,
                        log_sink=log_sink, device=device)
    finally:
        train._build = real_build
        lhm.LearnHealthMonitor.absorb_diags = real_absorb
    run_s = time.perf_counter() - t0
    steps = cfg.training_steps
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    acts = HOST_TRANSFERS.get(ACTOR_ACT)
    fetches = HOST_TRANSFERS.get("learner.result_fetch")
    if (m["num_updates"] != steps or m["fabric_failed"]
            or not np.isfinite(m["mean_loss"])):
        fail(f"{label}: {m['num_updates']} updates, failed "
             f"{m['fabric_failed']}, mean loss {m['mean_loss']}")
    if launches != cfg.lstm_layers * acts or not acts:
        fail(f"{label}: lstm_infer launched {launches} times for {acts} "
             f"acts, {cfg.lstm_layers} layer")
    if probe.get("alertz", (0,))[0] != 200:
        fail(f"{label}: /alertz answered {probe.get('alertz')}")
    stamps = np.asarray(rec["stamps"])
    gaps = np.diff(stamps) * 1e3
    return dict(m=m, rows=np.asarray(rec["rows"]), fetches=fetches,
                launches=launches, acts=acts, seconds=run_s, gaps=gaps,
                alertz=json.loads(probe["alertz"][1]))


def trace_summary(path: str) -> dict:
    """A merged trace's tracks, event names and flows."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["pid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e["name"] == "process_name"}
    names: dict = {}
    flows: dict = {}
    for e in events:
        if e.get("ph") == "M":
            continue
        names.setdefault(e["pid"], set()).add(e["name"])
        if e.get("cat") == "block":
            flows.setdefault(e["id"], set()).add(e["pid"])
    return dict(tracks=tracks, names=names, flows=flows, events=len(events),
                bytes=os.path.getsize(path))


def crossing_flows(tr: dict) -> list:
    """The block flows of a merged trace with events on a fleet's, the
    trainer's and a shard's track."""
    pid_of = {n: p for p, n in tr["tracks"].items()}
    fleets = {p for n, p in pid_of.items() if n.startswith("fleet")}
    shards = {p for n, p in pid_of.items() if n.startswith("shard")}
    trainer = pid_of.get("trainer")
    return [i for i, pids in tr["flows"].items()
            if pids & fleets and trainer in pids and pids & shards]


def lh_fabric(torch, card: str, device: str = "cuda", base=None) -> dict:
    """(b): the flagship through ``train()`` with the diagnostics armed
    every ``LH_INTERVAL`` updates and a boot-time capture of
    ``LH_TRACE_STEPS``, then the same run with neither."""
    import glob
    import shutil
    import tempfile

    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SIZE

    base = base or Config(game_name="Fake")
    cfg = base.replace(learnhealth_interval=LH_INTERVAL,
                       trace_steps=LH_TRACE_STEPS, **LH_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in LH_REDUCED.items())
        + f", learnhealth_interval 0 -> {LH_INTERVAL}, trace_steps 0 -> "
        f"{LH_TRACE_STEPS}; the comparison run {LH_PLAIN_STEPS} updates "
        f"with neither; the full host ring ({base.num_blocks} blocks of "
        f"{base.block_length}), 8 thread actors, fake env episodes of "
        f"{FAKE_EPISODE_LEN} steps", flush=True)
    cost = armed_step_cost(torch, base, device)
    ckdirs = [tempfile.mkdtemp(prefix="chip_smoke_lh_") for _ in range(2)]
    try:
        lh = lh_run(torch, card, cfg, "diagnosed", ckdirs[0], device)
        plain = lh_run(torch, card, base.replace(
            training_steps=LH_PLAIN_STEPS, **{
                k: v for k, v in LH_REDUCED.items()
                if k != "training_steps"}), "plain", ckdirs[1], device)
        dumps = sorted(glob.glob(os.path.join(ckdirs[0], "telemetry",
                                              "trace_*.json")))
        if len(dumps) != 1:
            fail(f"the diagnosed run dumped {dumps}, want one trace")
        tr = trace_summary(dumps[0])
    finally:
        for d in ckdirs:
            shutil.rmtree(d, ignore_errors=True)
    rows = lh["rows"]
    steps = cfg.training_steps
    armed = rows[:, 0] == 1.0
    want = (np.arange(1, len(rows) + 1) % LH_INTERVAL) == 0
    if (len(rows) != steps or not np.array_equal(armed, want)
            or np.any(rows[~armed] != 0) or rows.shape[1] != DIAG_SIZE
            or not np.isfinite(rows).all()):
        fail(f"diag rows: {len(rows)} for {steps} updates, armed at "
             f"{np.nonzero(armed)[0].tolist()}, want every {LH_INTERVAL}th")
    if (lh["fetches"] != steps or plain["fetches"] != LH_PLAIN_STEPS):
        fail(f"learner.result_fetch: {lh['fetches']} for {steps} diagnosed "
             f"updates, {plain['fetches']} for {LH_PLAIN_STEPS} plain")
    if lh["m"]["learnhealth"]["armed_steps"] != steps // LH_INTERVAL:
        fail(f"the monitor absorbed {lh['m']['learnhealth']} armed steps")
    trainer = [p for p, n in tr["tracks"].items() if n == "trainer"]
    got = tr["names"].get(trainer[0], set()) if trainer else set()
    learner_spans = sorted(n for n in got if n.startswith("learner."))
    if (not trainer or not learner_spans or "block.env_steps+cut" not in got
            or not tr["flows"]):
        fail(f"the trace: tracks {tr['tracks']}, trainer names "
             f"{sorted(got)}, {len(tr['flows'])} flows")
    gaps = lh["gaps"]
    inside = gaps[:LH_TRACE_STEPS - 1]
    after = gaps[LH_TRACE_STEPS:]
    print(f"diagnosed flagship on {card}: {steps} updates in "
          f"{lh['seconds']:.2f} s, armed rows at updates "
          f"{(np.nonzero(armed)[0] + 1).tolist()} and zeros elsewhere; "
          f"learner.result_fetch {lh['fetches']} = one a update, as the "
          f"plain run's {plain['fetches']} for {LH_PLAIN_STEPS}; /alertz "
          f"200 ({len(lh['alertz'].get('rules', []))} rules); lstm_infer "
          f"{lh['launches']} = 1 x {lh['acts']} acts (plain run "
          f"{plain['launches']} = 1 x {plain['acts']}); trace "
          f"{os.path.basename(dumps[0])}: {tr['events']} events, "
          f"{tr['bytes']} bytes, {len(tr['flows'])} block flows, trainer "
          f"spans {learner_spans}", flush=True)
    a_ms, a_ev = cost["armed"]
    d_ms, d_ev = cost["disarmed"]
    print(f"diagnostics' cost on {card}: update interval p50 "
          f"{pct(gaps, 50):.2f} ms diagnosed vs {pct(plain['gaps'], 50):.2f}"
          f" ms plain; in the capture window {pct(inside, 50):.2f} ms vs "
          f"{pct(after, 50):.2f} ms after it; a lone step's device time "
          f"armed {fmt(a_ms)} ({a_ev:.0f} device events) vs disarmed "
          f"{fmt(d_ms)} ({d_ev:.0f}): the re-unroll, norms and histograms "
          f"{fmt(None if a_ms is None or d_ms is None else a_ms - d_ms)}",
          flush=True)
    return dict(launches=lh["launches"] + plain["launches"],
                armed_ms=a_ms, disarmed_ms=d_ms)


def fleet_states(rec: dict):
    """Each fleet's env steps (its stats slab) and blocks ingested, and
    the service's served batches, now; None before the plane exists."""
    plane = rec.get("plane")
    if plane is None:
        return None
    rows = plane.poll_fleet_stats()["per_fleet"]
    return dict(env_steps=[int(r["env_steps"]) for r in rows],
                blocks=list(plane.blocks_per_fleet),
                batches=(plane.service.batches
                         if plane.service is not None else None))


def fmt_fleet_states(before, after) -> str:
    """A fleet stepping its envs in the window was acting; one that took
    no env step and sent no block was waiting (on its act replies, or on
    replay to take its blocks)."""
    if before is None or after is None:
        return f"not read ({before}, {after})"
    parts = []
    for f, (e0, e1, b0, b1) in enumerate(zip(
            before["env_steps"], after["env_steps"], before["blocks"],
            after["blocks"])):
        parts.append(f"fleet {f} env steps {e0} -> {e1}, blocks {b0} -> "
                     f"{b1}: {'acting' if e1 > e0 else 'waiting'}")
    return "; ".join(parts) + (f"; service batches {before['batches']} -> "
                               f"{after['batches']}")


def heaviest_kernels(events: list, n: int = 8) -> list:
    """The device kernels of a Chrome trace with the most time: (name, ms,
    count), longest first."""
    by = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            ms, c = by.get(e["name"], (0.0, 0))
            by[e["name"]] = (ms + e["dur"] / 1e3, c + 1)
    return sorted(((k, ms, c) for k, (ms, c) in by.items()),
                  key=lambda x: -x[1])[:n]


def profile_kernels(path: str) -> dict:
    """A Chrome trace's ``WGMMA_KERNEL`` events: of any category, of the
    ``kernel`` category, and the trace's heaviest kernels; and the act
    graph launches (``cudaGraphLaunch`` on the thread whose launches the
    kernels correlate with) that have no kernel record, by their offset
    into the trace in ms (where the profiler lost them)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    named = [e for e in events if WGMMA_KERNEL in str(e.get("name", ""))]
    kernels = [e for e in named if e.get("cat") == "kernel"]

    def corr(e):
        return (e.get("args") or {}).get("correlation")

    seen = {corr(e) for e in kernels}
    launches = {corr(e): e for e in events
                if e.get("name") == "cudaGraphLaunch" and corr(e) is not None}
    tids = {launches[c].get("tid") for c in seen if c in launches}
    acts = [e for e in launches.values() if e.get("tid") in tids]
    ts = [e["ts"] for e in events if isinstance(e.get("ts"), (int, float))]
    t0 = min(ts) if ts else 0.0
    return dict(any=len(named), kernel=len(kernels),
                heaviest=heaviest_kernels(events), act_launches=len(acts),
                lost_at_ms=sorted(round((e["ts"] - t0) / 1e3, 1)
                                  for e in acts if corr(e) not in seen),
                trace_ms=round((max(ts) - t0) / 1e3, 1) if ts else 0.0)


def capture_run(torch, card: str, device: str = "cuda", base=None) -> dict:
    """(c): the flagship over two shm replay shards with two fleets in
    serve mode; a capture armed through ``GET /tracez?steps=`` and a
    profile through ``GET /profilez?secs=``, both read back."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils import trace as trace_mod
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    base = base or Config(game_name="Fake")
    cfg = base.replace(**CAPTURE_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in
        CAPTURE_REDUCED.items()) + "; stopped once the capture and the "
        "profile are read back", flush=True)
    real_build = train._build
    rec: dict = {}
    stop = threading.Event()
    state = dict(port=None, steps=0)

    def capture(*args, **kw):
        sys_ = real_build(*args, **kw)
        rec.update(sys_)
        return sys_

    def log_sink(entry):
        state["port"] = entry["telemetry_port"]
        state["steps"] = entry["training_steps"]
        if "procs" not in rec and rec.get("plane") is not None:
            plane, rp = rec["plane"], rec["replay_plane"]
            try:
                rec["procs"] = [proc_report(p.pid) for p in
                                list(plane.procs) + list(rp.procs)]
            except OSError as e:
                rec["procs_error"] = str(e)

    def driver():
        try:
            deadline = time.time() + CAPTURE_WALL_S
            while (state["port"] is None or state["steps"] < 1) and \
                    time.time() < deadline and not stop.is_set():
                time.sleep(0.1)
            port = state["port"]
            # lockstep lanes cut their 400-step blocks in bursts, and a
            # window of a few updates may fall between two bursts: capture
            # again until one window holds a block's whole chain (the
            # attempts are printed)
            for attempt in range(1, CAPTURE_ATTEMPTS + 1):
                arm = http_get(port, f"/tracez?steps={CAPTURE_STEPS}")
                busy = http_get(port, f"/tracez?steps={CAPTURE_STEPS}")
                rec.setdefault("arm", arm)
                rec.setdefault("busy", busy)
                while time.time() < deadline:
                    status = json.loads(http_get(port, "/tracez")[1])
                    if (not status["armed"]
                            and status["last"].get("capture_id") == attempt):
                        rec["trace"] = status["last"]
                        break
                    time.sleep(0.2)
                rec["attempts"] = attempt
                if "trace" in rec and crossing_flows(
                        trace_summary(rec["trace"]["path"])):
                    break
            # ROADMAP C 21: a window in which the service served no act
            # says nothing about the profiler; take another, at most
            # PROFILE_WINDOWS in all, each printed
            for window in range(1, PROFILE_WINDOWS + 1):
                t0 = time.perf_counter()
                prev = rec.pop("profile", {}).get("path")
                rec.pop("fleets_after", None)
                rec.pop("profile_s", None)
                rec["fleets_before"] = fleet_states(rec)
                arm = http_get(port, f"/profilez?secs={PROFILE_SECS}")
                busy = http_get(port, f"/profilez?secs={PROFILE_SECS}")
                rec.setdefault("profile_arm", arm)
                rec.setdefault("profile_busy", busy)
                while time.time() < deadline:
                    status = json.loads(http_get(port, "/profilez")[1])
                    if not status["armed"] and status["last"] and \
                            status["last"].get("path") != prev:
                        rec["profile"] = status["last"]
                        rec["profile_s"] = time.perf_counter() - t0
                        rec["fleets_after"] = fleet_states(rec)
                        break
                    time.sleep(0.1)
                prof = rec.get("profile", {})
                served = (window_batches[-1] if len(window_batches)
                          == window else None)
                kernels_ = (profile_kernels(prof["path"])
                            if "path" in prof else None)
                rec.setdefault("windows", []).append(dict(
                    window=window, served=served, kernels=kernels_,
                    profile=prof, profile_s=rec.get("profile_s"),
                    fleets_before=rec["fleets_before"],
                    fleets_after=rec.get("fleets_after"),
                    arm=(arm[0], busy[0])))
                print(f"/profilez window {window}: "
                      f"{'not read' if served is None else served} "
                      f"service batches inside the profiler, "
                      + ("no trace" if kernels_ is None else
                         f"{kernels_['any']} {WGMMA_KERNEL} events "
                         f"({kernels_['kernel']} kernel-category) among "
                         f"{prof.get('device_events')} device events; "
                         f"act graph launches {kernels_['act_launches']}, "
                         f"without their kernel record at ms "
                         f"{kernels_['lost_at_ms']} of the trace's "
                         f"{kernels_['trace_ms']}")
                      + f", the window {rec.get('profile_s', 0.0):.2f} s "
                      f"end to end; across the request: "
                      + fmt_fleet_states(rec["fleets_before"],
                                         rec.get("fleets_after")),
                      flush=True)
                if served and kernels_ is not None:
                    break
        except Exception as e:   # checked below, after the run
            rec["driver_error"] = f"{type(e).__name__}: {e}"
        finally:
            stop.set()

    # the service's batch count where the profiler starts and stops
    # (utils/trace.device_profile, which /profilez records through)
    real_profile = trace_mod.device_profile
    window_batches = []

    @contextlib.contextmanager
    def counted_profile(log_dir, require_cuda=False):
        with real_profile(log_dir, require_cuda) as prof:
            svc = rec["plane"].service
            b0 = svc.batches
            try:
                yield prof
            finally:
                window_batches.append(svc.batches - b0)

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_capture_")
    KERNEL_LAUNCHES.reset()
    train._build = capture
    trace_mod.device_profile = counted_profile
    th = threading.Thread(target=driver, name="capture-driver", daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, env_factory, checkpoint_dir=ckdir,
                        max_wall_seconds=CAPTURE_WALL_S, verbose=False,
                        log_sink=log_sink, stop_fn=stop.is_set,
                        device=device)
        run_s = time.perf_counter() - t0
        th.join(30)
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        if "driver_error" in rec or "trace" not in rec:
            fail(f"capture: driver {rec.get('driver_error')}, trace "
                 f"{rec.get('trace')}")
        if rec["arm"][0] != 200 or rec["busy"][0] != 409:
            fail(f"/tracez answered {rec['arm']} then {rec['busy']}")
        tr = trace_summary(rec["trace"]["path"])
        windows = rec.get("windows", [])
        last = windows[-1] if windows else {}
        prof = last.get("profile", {})
        served = last.get("served")
        counted = last.get("kernels") or {}
        kernels = counted.get("any", 0)
        heaviest = counted.get("heaviest", [])
    finally:
        train._build = real_build
        trace_mod.device_profile = real_profile
        shutil.rmtree(ckdir, ignore_errors=True)
    names = set(tr["tracks"].values())
    want = {"trainer", "fleet0", "fleet1", "shard0", "shard1"}
    trainer = {n: p for p, n in tr["tracks"].items()}.get("trainer")
    crossing = crossing_flows(tr)
    serve_batches = "serve.batch" in tr["names"].get(trainer, set())
    procs = rec.get("procs", [])
    if (m["fabric_failed"] or not names >= want
            or len(set(tr["tracks"])) != len(tr["tracks"]) or not crossing
            or not serve_batches or rec["trace"]["dropped_slabs"] != 0):
        fail(f"capture: failed {m['fabric_failed']}, tracks "
             f"{tr['tracks']}, {len(crossing)} flows across fleet, trainer "
             f"and shard, serve.batch {serve_batches}, last "
             f"{rec['trace']}")
    if not procs or any(p["device"] for p in procs):
        fail(f"a fleet or shard child holds the card: {procs} "
             f"{rec.get('procs_error')}")
    if any(w["arm"] != (200, 409) for w in windows) or "path" not in prof:
        fail(f"/profilez: {[w['arm'] for w in windows]} (200 then 409 "
             f"each), last {prof}")
    if not served:
        fail(f"/profilez: no act traffic in the window ({len(windows)} "
             f"windows served {[w['served'] for w in windows]} batches)")
    if not kernels:
        # ROADMAP C 21: name what the window held before failing on it
        print(f"/profilez window without {WGMMA_KERNEL}: its heaviest "
              "device kernels (ms, count): " + "; ".join(
                  f"{short_kernel_name(n, 60)} {ms:.3f} ({c})"
                  for n, ms, c in heaviest), flush=True)
    # each served batch is one act: lstm_layers kernel launches, counted
    # after the act's fetch, so after its kernels ran: a batch may
    # straddle either edge of the window.  The profiler drops a graph
    # replay's kernel record now and then (act_kernel_events; 4 of 51 in
    # one window), so the lower bound is PROFILE_KEPT of the batches'
    layers = cfg.lstm_layers
    band = (int(layers * (served - 1) * PROFILE_KEPT), layers * (served + 1))
    if not kernels or not band[0] <= counted.get("kernel", 0) <= band[1]:
        fail(f"/profilez: {kernels} {WGMMA_KERNEL} events "
             f"({counted.get('kernel')} kernel-category) for {served} "
             f"batches served inside the window: want {band[0]}..{band[1]} "
             f"({layers} layer(s) a batch); act graph launches without "
             f"their kernel record at ms {counted.get('lost_at_ms')}")
    print(f"capture across processes on {card}: {m['num_updates']} "
          f"updates in {run_s:.2f} s; /tracez?steps={CAPTURE_STEPS} 200 "
          f"then 409 while busy, {rec['attempts']} capture(s) to catch a "
          f"block's chain; tracks {sorted(tr['tracks'].items())}, "
          f"{tr['events']} events, {tr['bytes']} bytes, "
          f"{rec['trace']['dropped_slabs']} torn slots, overflow "
          f"{rec['trace']['overflow']}; {len(crossing)} of "
          f"{len(tr['flows'])} block flows cross fleet -> trainer -> shard; "
          f"serve.batch instants on the trainer track; children "
          f"{len(procs)}, none holding the card; /profilez?secs="
          f"{PROFILE_SECS} 200 then 409, {len(windows)} window(s) to "
          f"catch act traffic, {prof['device_events']} device events, "
          f"{kernels} {WGMMA_KERNEL} events for {served} batches served "
          f"inside the window (band {band[0]}..{band[1]}), the window "
          f"{last['profile_s']:.2f} s end to end; lstm_infer {launches}",
          flush=True)
    return dict(launches=launches)


def guard_checks(torch, card: str, device: str = "cuda", base=None,
                 serve_cfg=None) -> dict:
    """(d): anakin trained with ``transfer_guard=True`` (phase 8's config,
    cut short): windows counted, none tripped; an undeclared ``.item()``
    injected into a dispatch window of a small plane raises
    ``TransferGuardTripped`` naming the window; a guarded dispatch's cost;
    and phase 4's served act under an armed guard."""
    import shutil
    import tempfile

    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.learner.anakin import AnakinPlane
    from r2d2_tpu_torch.learner.learner import Learner
    from r2d2_tpu_torch.learner.step import create_train_state
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.replay.device_ring import DeviceRing
    from r2d2_tpu_torch.serving import SessionServer
    from r2d2_tpu_torch.utils.trace import (
        KERNEL_LAUNCHES,
        TRANSFER_GUARD,
        TransferGuardTripped,
    )

    base = base or Config(game_name="Fake", actor_transport="anakin",
                          anakin_env="grid")
    cfg = base.replace(transfer_guard=True, **GUARD_REDUCED)
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in GUARD_REDUCED.items())
        + ", transfer_guard False -> True", flush=True)
    TRANSFER_GUARD.reset()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    t0 = time.perf_counter()
    try:
        m = train.train(cfg, checkpoint_dir=ckdir, verbose=False,
                        max_wall_seconds=GUARD_WALL_S, device=device)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    run_s = time.perf_counter() - t0
    snap = TRANSFER_GUARD.snapshot()
    dispatches = cfg.training_steps // cfg.superstep_k
    trips = {k: v for k, v in snap.items() if k.startswith("trip.")}
    if (m["num_updates"] != cfg.training_steps or m["fabric_failed"]
            or snap.get("window.anakin.dispatch") != dispatches
            or snap.get("window.anakin.harvest") != dispatches or trips):
        fail(f"guarded anakin: {m['num_updates']} updates, failed "
             f"{m['fabric_failed']}, guard {snap}")
    print(f"guarded anakin on {card}: {m['num_updates']} updates in "
          f"{run_s:.2f} s, guard {snap}", flush=True)

    # a small plane at the flagship widths: a guarded dispatch's cost,
    # then the injected sync
    small = base.replace(
        buffer_capacity=ANAKIN_CHECK_BLOCKS * base.block_length,
        learning_starts=2 * base.block_length, device_replay=True,
        in_graph_per=True)
    net = create_network(small, TRAIN_ACTIONS, device=device,
                         generator=torch.Generator().manual_seed(0))
    learner = Learner(small, net, create_train_state(small,
                                                     net.state_dict()))
    plane = AnakinPlane(small, net, TRAIN_ACTIONS,
                        DeviceRing(small, TRAIN_ACTIONS, device=device))
    while not plane.ready:
        plane.rollout_step(learner.state.params)

    def cycle():
        learner.state, result = plane.dispatch(learner.state)
        plane.harvest(result)

    cycle()
    times = {"guarded": [], "unguarded": []}
    for _ in range(GUARD_PAIRS):
        for label in ("unguarded", "guarded"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if label == "guarded":
                with TRANSFER_GUARD.arm():
                    cycle()
            else:
                cycle()
            times[label].append((time.perf_counter() - t1) * 1e3)
    real = plane.super_step

    def undeclared(*a, **k):
        out = real(*a, **k)
        out[-1].sum().item()        # a sync no crossing declares
        return out

    plane.super_step = undeclared
    raised = None
    with TRANSFER_GUARD.arm():
        try:
            plane.dispatch(learner.state)
        except TransferGuardTripped as e:
            raised = str(e)
    plane.super_step = real
    if raised is None or "'anakin.dispatch'" not in raised:
        fail(f"an undeclared .item() in a dispatch window raised {raised}")
    print(f"guarded dispatch on {card} (64-block ring, flagship widths, "
          f"{GUARD_PAIRS} alternating pairs of dispatch + harvest): p50 "
          f"{pct(times['guarded'], 50):.2f} ms guarded vs "
          f"{pct(times['unguarded'], 50):.2f} ms unguarded; the injected "
          f".item() raised TransferGuardTripped: {raised[:110]}", flush=True)
    del plane, learner, net

    # phase 4's server, its act under an armed guard
    scfg = serve_cfg or Config(serve_max_batch=256)
    snet = create_network(scfg, ACTION_DIM, device=device,
                          generator=torch.Generator().manual_seed(0))
    server = SessionServer(scfg, ACTION_DIM, host="127.0.0.1")
    server.publish_params({k: v.detach().clone()
                           for k, v in snet.state_dict().items()})
    server.warmup()
    rng = np.random.default_rng(4)
    TRANSFER_GUARD.reset()
    KERNEL_LAUNCHES.reset()
    acts = 0
    with TRANSFER_GUARD.arm():
        for n in GUARD_SERVE_BATCHES:
            q, _ = server.batcher.act(
                rng.integers(0, 256, (n, *scfg.stored_obs_shape), np.uint8),
                np.eye(ACTION_DIM, dtype=np.float32)[
                    rng.integers(ACTION_DIM, size=n)],
                rng.normal(size=n).astype(np.float32),
                (rng.normal(size=(n, 2, scfg.lstm_layers, scfg.hidden_dim))
                 * 0.5).astype(np.float32))
            acts += 1
            if not np.isfinite(q).all():
                fail("a guarded served act is not finite")
    snap = TRANSFER_GUARD.snapshot()
    served = KERNEL_LAUNCHES.get(lstm.KERNEL)
    server.close()
    if (snap.get("window.serving.act") != acts
            or any(k.startswith("trip.") for k in snap) or served != acts):
        fail(f"guarded serving: {snap}, {served} launches for {acts} acts")
    print(f"guarded served act on {card}: batches {GUARD_SERVE_BATCHES}, "
          f"guard {snap}, lstm_infer {served}", flush=True)
    return dict(serve=served)


def ig_and_mesh_diag(torch, card: str, device: str = "cuda", pong=None,
                     base=None) -> dict:
    """(e): the Pong preset's in-graph super-steps with the diagnostics
    every 2nd step return (k, DIAG_SIZE) rows, on a ring of a few blocks
    at the full slot shapes; and a meshed world-size-1 step's diag is its
    meshless one bit for bit."""
    import torch.distributed as dist

    from r2d2_tpu_torch.config import Config, pong_config
    from r2d2_tpu_torch.learner.step import (
        create_train_state,
        make_in_graph_per_super_step_fn,
        make_train_step,
    )
    from r2d2_tpu_torch.models import create_network
    from r2d2_tpu_torch.parallel.mesh import make_mesh
    from r2d2_tpu_torch.parallel.sharding import (
        ShardingTable,
        mesh_train_step,
    )
    from r2d2_tpu_torch.replay.device_ring import DeviceRing
    from r2d2_tpu_torch.replay.replay_buffer import ReplayBuffer
    from r2d2_tpu_torch.telemetry.learnhealth import DIAG_SIZE

    pong = pong or pong_config(game_name="Fake")
    cfg = pong.replace(buffer_capacity=CHECK_RING_BLOCKS * pong.block_length,
                       learning_starts=pong.block_length,
                       learnhealth_interval=2)
    k = cfg.superstep_k
    ring = DeviceRing(cfg, TRAIN_ACTIONS, device=device)
    buf = ReplayBuffer(cfg, TRAIN_ACTIONS, rng=np.random.default_rng(3),
                       device_ring=ring)
    for blk, prios in scripted_blocks(cfg, CHECK_RING_BLOCKS):
        buf.add(blk, prios, None)
    net = create_network(cfg, TRAIN_ACTIONS, device=device,
                         generator=torch.Generator().manual_seed(0))
    fn = make_in_graph_per_super_step_fn(cfg, net, k, learnhealth=True)
    meta = ring.per_meta()
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    state, _, losses, diags = fn(
        create_train_state(cfg, net.state_dict()), ring.snapshot(),
        ring.take_prios(), meta["seq_meta"], meta["first"], generator=gen)
    d = diags.float().cpu().numpy()
    want = (np.arange(1, k + 1) % 2) == 0
    captures = fn.graphs.captures if device == "cuda" else 2
    if (d.shape != (k, DIAG_SIZE) or not np.array_equal(d[:, 0] == 1, want)
            or np.any(d[~want] != 0) or not np.isfinite(d).all()
            or captures != 2):
        fail(f"in-graph super-step diag rows {d.shape}: armed "
             f"{d[:, 0].tolist()}, {captures} captures")
    print(f"in-graph super-step on {card} (Pong widths, k = {k}, "
          f"{CHECK_RING_BLOCKS}-block ring at the full slot shapes, "
          f"learnhealth_interval 2): diag rows {d.shape} from the armed and "
          f"the disarmed CUDA graphs ({captures} captures), armed "
          f"{d[:, 0].tolist()}, dq_mean {d[want, 8].tolist()}", flush=True)
    del ring, buf

    base = (base or Config(game_name="Fake")).replace(learnhealth_interval=1)
    store = mesh_group(torch, device)     # noqa: F841 (the group's store)
    try:
        mesh = make_mesh(base, device)
        mnet = create_network(base, TRAIN_ACTIONS, device=device,
                              generator=torch.Generator().manual_seed(0))
        plain_state = create_train_state(base, mnet.state_dict())
        mesh_state = create_train_state(base, mnet.state_dict())
        table = ShardingTable(mesh, base)
        meshed = mesh_train_step(base, mnet, table,
                                 state_template=mesh_state)
        mesh_state = table.place_state(mesh_state)
        plain = make_train_step(base, mnet, learnhealth=True)
        batch = {kk: torch.from_numpy(v).to(device)
                 for kk, v in step_batch(base, seed=16).items()}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            da = plain(plain_state, batch)[3]
            db = meshed(mesh_state, batch)[3]
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = det
    finally:
        dist.destroy_process_group()
    if not torch.equal(da, db) or da[0].item() != 1.0:
        fail(f"the meshed diag is not the meshless one bit for bit: "
             f"{da.tolist()} vs {db.tolist()}")
    print(f"meshed diag on {card}: world size 1 over "
          f"{'NCCL' if device == 'cuda' else 'gloo'}, {DIAG_SIZE} values "
          f"bit for bit the meshless step's (cuDNN deterministic for this "
          "check only)", flush=True)
    return {}


def phase_telemetry(torch, card: str) -> dict:
    """Phase 14: the in-graph diagnostics, the cross-process trace with
    ``/tracez`` and ``/profilez``, and the transfer guard on the card.
    Returns the kernel's launches by run."""
    import gc

    from r2d2_tpu_torch.config import Config

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(TELEMETRY_WATCHDOG_S)
    base = Config(game_name="Fake")
    t = time.perf_counter()
    diag_card_vs_cpu(torch, base)
    print(f"phase 14 (a) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    b = lh_fabric(torch, card)
    print(f"phase 14 (b) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    c = capture_run(torch, card)
    print(f"phase 14 (c) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    d = guard_checks(torch, card)
    print(f"phase 14 (d) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ig_and_mesh_diag(torch, card)
    print(f"phase 14 (e) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(diagnosed=b["launches"], capture=c["launches"],
                guarded_serve=d["serve"])


# --------------------------------------------------------------------------
# phase 15: the edges — the command line, the evaluator's follow mode, the
# session load generator, serving and the bench, as a user runs them
# --------------------------------------------------------------------------

def edges_sets() -> list:
    """``--set`` arguments of every phase-15 command: phase 10's warm-up
    cut (each lane's first block), a checkpoint every 4 updates, no
    replay snapshot at the run's end (the per-shard snapshot is held in
    phase 10), the exporter on an ephemeral port."""
    out = []
    for k, v in EDGES_SETS.items():
        out += ["--set", f"{k}={str(v).lower() if isinstance(v, bool) else v}"]
    return out


def start_cli(args: list, logdir: str):
    """``python -m r2d2_tpu_torch <args>`` from this checkout: its stdout
    piped as text, its stderr into a file of ``logdir`` (``proc.log``)."""
    log = os.path.join(logdir, f"{args[0]}_{len(os.listdir(logdir))}.err")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "r2d2_tpu_torch", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=err, text=True)
    proc.log = log
    return proc


def err_tail(proc, n: int = 2000) -> str:
    with open(proc.log) as f:
        return f.read()[-n:]


def read_until(proc, pred, timeout: float) -> list:
    """Lines of ``proc``'s stdout up to the first that ``pred`` accepts
    (returned last), within ``timeout`` seconds; fails otherwise."""
    got: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            got.put(line)
            if pred(line):
                return
        got.put(None)

    threading.Thread(target=pump, daemon=True).start()
    lines, deadline = [], time.time() + timeout
    while time.time() < deadline:
        try:
            line = got.get(timeout=0.5)
        except queue.Empty:
            continue
        if line is None:
            break
        lines.append(line)
        if pred(line):
            return lines
    fail(f"{proc.args[3:5]}: no line wanted within {timeout:.0f} s; "
         f"got {lines[-5:]}, stderr {err_tail(proc)}")


def finish(proc, timeout: float, what: str) -> tuple:
    """Wait for ``proc``; (rc, the rest of its stdout, its stderr's
    tail); kills it past the timeout and fails."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=30)
        fail(f"{what} did not exit within {timeout:.0f} s: "
             f"{err_tail(proc)}")
    return proc.returncode, out, err_tail(proc)


def edges_train(torch, card: str, ckdir: str, hosts: str) -> dict:
    """15(b): ``cli.main(["train", ...])`` in this process, so that the
    kernel counters see its acts; the run's system read by wrapping
    ``train._build`` (replay plane, learner) and its metrics by wrapping
    ``train.train``."""
    import contextlib
    import io

    from r2d2_tpu_torch import cli
    from r2d2_tpu_torch import train
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.checkpoint import Checkpointer
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    real_build, real_train = train._build, train.train
    rec = dict(steps=[], metrics=None)

    def capture(*a, **k):
        sys_ = real_build(*a, **k)
        rec.update(sys_)
        step = sys_["learner"]._step_fn

        def timed_step(state, batch):
            out = step(state, batch)
            rec["steps"].append(time.perf_counter())
            return out

        sys_["learner"]._step_fn = timed_step
        return sys_

    def keep(*a, **k):
        rec["metrics"] = real_train(*a, **k)
        return rec["metrics"]

    argv = ["train", "--game", "Fake", "--ckpt-dir", ckdir,
            "--replay-shards", "2", "--replay-hosts", hosts,
            "--training-steps", str(EDGES_STEPS), "--quiet",
            "--max-wall-seconds", str(EDGES_WALL_S), *edges_sets()]
    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    out = io.StringIO()
    train._build, train.train = capture, keep
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        train._build, train.train = real_build, real_train
    run_s = time.perf_counter() - t0
    launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
    old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
    acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
    printed = out.getvalue().strip().splitlines()
    try:
        line = json.loads(printed[-1])
    except (IndexError, ValueError):
        fail(f"15(b): the train command printed no JSON line: {printed[-5:]}")
    m = rec["metrics"]
    lh = m["learnhealth"]
    if (rc != 0 or line["num_updates"] != EDGES_STEPS
            or lh["loss_count"] != EDGES_STEPS or lh["nonfinite"]
            or not np.isfinite(line["mean_loss"]) or m["fabric_failed"]):
        fail(f"15(b): rc {rc}, printed {line}, learnhealth {lh}, failed "
             f"{m['fabric_failed']}")
    ck = Checkpointer(ckdir)
    want = list(range(EDGES_SETS["save_interval"], EDGES_STEPS + 1,
                      EDGES_SETS["save_interval"]))
    if ck.steps() != want or ck.steps(complete=False) != want:
        fail(f"15(b): complete checkpoints {ck.steps()}, all "
             f"{ck.steps(complete=False)}; want {want}")
    cfg = rec["learner"].cfg
    if launches != cfg.lstm_layers * acts or not acts or old:
        fail(f"15(b): lstm_infer launched {launches} times (CUDA-core "
             f"{old}) for {acts} acts, {cfg.lstm_layers} layer")
    gaps = np.diff(np.asarray(rec["steps"])) * 1e3
    print(f"15(b) train through the command line on {card}: "
          f"{' '.join(argv)}; printed {line}; {line['num_updates']} "
          f"updates in {run_s:.2f} s, losses finite "
          f"{lh['loss_count']}/{EDGES_STEPS}, checkpoints {ck.steps()} "
          f"complete; lstm_infer launches {launches} = {cfg.lstm_layers} "
          f"x {acts} acts, CUDA-core {old}; update interval p50 "
          f"{pct(gaps, 50):.2f} ms (min {gaps.min():.2f}, max "
          f"{gaps.max():.2f})", flush=True)
    return dict(launches=launches, acts=acts, routed=list(
        rec["replay_plane"]._routed), interval_p50=pct(gaps, 50),
        seconds=run_s)


def edges_load(torch, card: str) -> dict:
    """15(d): the session load generator's ``main`` in this process, its
    three cells (the reference's ``float32`` and ``bfloat16`` params, both
    computed in bf16 on ``lstm_step_wgmma``, and ``float32_compute`` on
    ``lstm_step_f32``), both session chaos sites armed; the live server
    polled for its health and completions, the straggler's freezes
    stamped.  Returns each cell's launches."""
    import contextlib
    import io

    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.serving import server as server_mod
    from r2d2_tpu_torch.tools import session_load_gen as slg
    from r2d2_tpu_torch.utils import chaos as chaos_mod
    from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES

    servers, freezes, polls = [], [], []
    real_server = server_mod.SessionServer
    real_slow = chaos_mod.ChaosInjector.session_client_slow_seconds

    class Watched(real_server):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    def stamped_slow(self):
        dur = real_slow(self)
        if dur > 0:
            freezes.append((len(servers) - 1, time.monotonic(), dur))
        return dur

    stop = threading.Event()

    def watch():
        while not stop.is_set():
            if servers:
                srv = servers[-1]
                if srv._started and not srv.stop_event.is_set():
                    polls.append((len(servers) - 1, time.monotonic(),
                                  srv.store.counts()["completed"],
                                  srv.healthz()["status"]))
            time.sleep(0.1)

    argv = ["--sessions", "256", "--workers", "8", "--max-sessions", "192",
            "--seconds", str(EDGES_LOAD_S), "--chaos", EDGES_LOAD_CHAOS]
    server_mod.SessionServer = Watched
    chaos_mod.ChaosInjector.session_client_slow_seconds = stamped_slow
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    out = io.StringIO()
    KERNEL_LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = slg.main(argv)
    finally:
        stop.set()
        watcher.join(5)
        server_mod.SessionServer = real_server
        chaos_mod.ChaosInjector.session_client_slow_seconds = real_slow
    run_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    if rc != 0 or len(lines) != len(slg.CELLS) + 1:
        fail(f"15(d): load generator rc {rc}, lines {out.getvalue()[-3000:]}")
    # the cell's route: the compute dtype picks the kernel
    counters = {"bfloat16": lstm.KERNEL, "float32": lstm.CUDACORE_COUNTER}
    kernels = {"bfloat16": WGMMA_KERNEL, "float32": CUDACORE_KERNEL}
    launches = {}
    for i, c in enumerate(lines[:-1]):
        dt, cl, srv = c["cell"], c["client"], c["server"]
        counter = counters[c["compute_dtype"]]
        mine = [p for p in polls if p[0] == i]
        worst = sorted({p[3] for p in mine})
        want = {counter: c["lstm_layers"] * (srv["batches"]
                                             + c["warmup_batches"])}
        during = []
        for _, t, dur in (f for f in freezes if f[0] == i):
            inside = [p[2] for p in mine if t <= p[1] <= t + dur]
            if len(inside) >= 2:
                during.append(inside[-1] - inside[0])
        if (not c["accounting_ok"] or "failing" in worst or not mine
                or c["health"] == "failing"):
            fail(f"15(d) {dt}: accounting {c['accounting_ok']}, health "
                 f"seen {worst}, final {c['health']}")
        if not (cl["kills"] and cl["abandoned"] and srv["reaped"]
                and srv["evicted"] and cl["slow"]):
            fail(f"15(d) {dt}: kills {cl['kills']} abandoned "
                 f"{cl['abandoned']} reaped {srv['reaped']} evicted "
                 f"{srv['evicted']} slows {cl['slow']}")
        if not during or min(during) <= 0:
            fail(f"15(d) {dt}: completions while a straggler was frozen "
                 f"{during} over {len(freezes)} freezes")
        if c["kernel_launches"] != want:
            fail(f"15(d) {dt}: launches {c['kernel_launches']}, want {want}"
                 f" (layers x ({srv['batches']} batches + "
                 f"{c['warmup_batches']} warm-up))")
        # on the card every act replays a graph: all of the cell's
        # launches came from its buckets' graphs (the f32 cell's from
        # lstm_step_f32's cluster launch replayed)
        graphs = servers[i].batcher._act.graphs.captures
        if graphs != c["warmup_batches"]:
            fail(f"15(d) {dt}: serving.act captured {graphs} graphs for "
                 f"{c['warmup_batches']} buckets")
        launches[dt] = want[counter]
        print(f"15(d) load generator, {dt} cell (params {c['serve_dtype']},"
              f" compute {c['compute_dtype']}) on {card}: {cl['acts']} "
              f"acts, {cl['acts_per_sec']} acts/s, {cl['sessions_per_sec']}"
              f" sessions/s; client act p50 {cl.get('act_p50_ms')} ms, p95 "
              f"{cl.get('act_p95_ms')} ms, p99 {cl.get('act_p99_ms')} ms; "
              f"server: admitted {srv['admitted']} = completed "
              f"{srv['completed']} + reaped {srv['reaped']} + evicted "
              f"{srv['evicted']} + live {srv['live']}, {srv['batches']} "
              f"batches (mean {srv['mean_batch']}); kills {cl['kills']} "
              f"abandoning {cl['abandoned']}, slows {cl['slow']} with "
              f"{during} completions inside the freezes; health seen "
              f"{worst}; launches {c['kernel_launches']} on "
              f"{kernels[c['compute_dtype']]}, every one replayed from the "
              f"act's {graphs} bucket graphs", flush=True)
    print(f"15(d) took {run_s:.1f} s: {lines[-1]}", flush=True)
    return launches


def edges_serve(torch, card: str, ckdir: str, logdir: str) -> dict:
    """15(e): ``python -m r2d2_tpu_torch serve`` on the run's checkpoints,
    driven by ``run_load`` for ``EDGES_SERVE_LOAD_S``; its printed summary
    checked.  Not ``--quiet``: its start line names the ephemeral port."""
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.tools import session_load_gen as slg

    t0 = time.perf_counter()
    proc = start_cli(["serve", "--game", "Fake", "--ckpt-dir", ckdir,
                      "--port", "-1", "--max-wall-seconds",
                      str(EDGES_SERVE_WALL_S), *edges_sets()], logdir)
    try:
        lines = read_until(proc, lambda ln: ln.startswith("serving step_"),
                           180)
        host, port = lines[-1].split(" on ")[1].split()[0].rsplit(":", 1)
        cfg = Config(game_name="Fake")
        load = slg.run_load(cfg, TRAIN_ACTIONS, host, int(port),
                            sessions=64, workers=4, steps_mean=10,
                            think_s=0.005, run_seconds=EDGES_SERVE_LOAD_S,
                            call_timeout=20.0, seed=1)
        rc, rest, err = finish(proc, EDGES_SERVE_WALL_S + 60, "serve")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    summary = json.loads(rest.strip().splitlines()[-1])
    if (rc != 0 or summary["step"] != EDGES_STEPS
            or summary["admitted"] != summary["completed"]
            + summary["reaped"] + summary["evicted"] + summary["live"]
            or summary["health"] == "failing" or not load["acts"]):
        fail(f"15(e): serve rc {rc}, summary {summary}, load {load}, "
             f"stderr {err}")
    print(f"15(e) serve through the command line on {card}: "
          f"{lines[-1].strip()}; run_load {load['acts']} acts "
          f"({load['acts_per_sec']}/s, p50 {load.get('act_p50_ms')} ms, p99 "
          f"{load.get('act_p99_ms')} ms); summary {summary}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return summary


def edges_bench(torch, card: str) -> dict:
    """15(f): the port's bench through its isolated driver, cut in steps
    and seconds; the one JSON line checked and printed.  Its isolated
    entry runs twice: first to record the children it would start (none
    starts), then, with the children run ``EDGES_BENCH_WORKERS`` at a
    time, to compose the line from their results; so the children's
    rates contend for the card and the host, and are not measurements."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from r2d2_tpu_torch import bench

    out = io.StringIO()
    real_run_phase, real_probe, spent = (bench._run_phase,
                                         bench._device_probe, {})
    calls = []

    def recorded(phase, timeout_s, extra=(), label=None):
        calls.append((phase, timeout_s, tuple(extra), label))
        return None, "recorded"

    def timed_phase(phase, timeout_s, extra=(), label=None):
        t = time.perf_counter()
        res = real_run_phase(phase, timeout_s, extra, label)
        spent[label or phase] = round(time.perf_counter() - t, 1)
        return res

    t0 = time.perf_counter()
    try:
        bench._run_phase = recorded
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                bench._main_isolated(**EDGES_BENCH)
            except SystemExit:
                pass   # no child ran: the headline is missing
        with ThreadPoolExecutor(EDGES_BENCH_WORKERS) as pool:
            futures = [pool.submit(timed_phase, *c) for c in calls]
        results = {c: f.result() for c, f in zip(calls, futures)}
        bench._run_phase = (lambda phase, timeout_s, extra=(), label=None:
                            results[(phase, timeout_s, tuple(extra), label)])
        bench._device_probe = lambda: (True, "")    # probed above
        with contextlib.redirect_stdout(out):
            bench._main_isolated(**EDGES_BENCH)
    except SystemExit as e:
        fail(f"15(f): the bench exited {e.code}: {out.getvalue()[-3000:]}")
    finally:
        bench._run_phase, bench._device_probe = real_run_phase, real_probe
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    try:
        result = json.loads(lines[0])
    except (IndexError, ValueError):
        fail(f"15(f): no JSON line: {out.getvalue()[-3000:]}")
    phases = ["value", "learner_fused_env_frames_per_sec",
              "system_env_frames_per_sec",
              "system_ingraph_env_frames_per_sec",
              *(f"{label}_env_frames_per_sec"
                for label, _ in bench.ACTOR_CELLS)]
    errors = [k for k in result if k.endswith("_error") or k == "error"
              or k == "phase_errors"]
    if (errors or not result["value"] > 0
            or not 0 < result.get("mfu", 0) < 1
            or any(result.get(k, -1) < 0 for k in phases)):
        fail(f"15(f): bench line {result}")
    print(f"15(f) bench on {card} ({time.perf_counter() - t0:.1f} s; its "
          f"{len(calls)} children, {EDGES_BENCH_WORKERS} at a time (their "
          f"rates contend), and their seconds {spent}): "
          + json.dumps(result), flush=True)
    return result


def phase_edges(torch, card: str) -> dict:
    """Phase 15: the edges as a user runs them (the module docstring).
    Returns the kernel's launches by path."""
    import gc
    import shutil
    import tempfile

    from r2d2_tpu_torch.config import Config

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(EDGES_WATCHDOG_S)
    base = Config(game_name="Fake")
    print("reduced: " + ", ".join(
        f"{k} {getattr(base, k)} -> {v}" for k, v in EDGES_SETS.items())
        + f", training_steps {base.training_steps} -> {EDGES_STEPS}, "
        f"replay_shards {base.replay_shards} -> 2 (socket servers); the "
        f"eval follow timeout {EDGES_FOLLOW_S} s; the load generator "
        f"{EDGES_LOAD_S} s a cell; serve {EDGES_SERVE_WALL_S} s; the bench "
        f"{EDGES_BENCH} (from 100 / 5 / 75.0), its children "
        f"{EDGES_BENCH_WORKERS} at a time (from 1)", flush=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_edges_")
    logdir = tempfile.mkdtemp(prefix="chip_smoke_edges_logs_")
    procs = []
    try:
        # (a) two replay shard servers, then the evaluator trailing the run
        t = time.perf_counter()
        shards = []
        for s in range(2):
            p = start_cli(["replay-shard", "--game", "Fake", "--port", "0",
                           "--shard-id", str(s), "--replay-shards", "2",
                           "--action-dim", str(TRAIN_ACTIONS),
                           "--max-wall-seconds", str(EDGES_WATCHDOG_S),
                           *edges_sets()], logdir)
            procs.append(p)
            shards.append(p)
        ports = []
        for s, p in enumerate(shards):
            line = read_until(p, lambda ln: "serving on" in ln, 120)[-1]
            ports.append(int(line.split("serving on ")[1].split()[0]
                             .rsplit(":", 1)[1]))
        curve_json = os.path.join(ckdir, "curve.json")
        curve_png = os.path.join(ckdir, "curve.png")
        ev = start_cli(["eval", "--game", "Fake", "--ckpt-dir", ckdir,
                        "--follow", "--follow-timeout", str(EDGES_FOLLOW_S),
                        "--episodes", "1", "--out-json", curve_json,
                        "--plot", curve_png, *edges_sets()], logdir)
        procs.append(ev)
        print(f"15(a) replay-shard servers on ports {ports}, the evaluator "
              f"following {ckdir} ({time.perf_counter() - t:.1f} s)",
              flush=True)

        # (b) train through the command line against them
        run = edges_train(torch, card, ckdir,
                          ",".join(f"127.0.0.1:{p}" for p in ports))
        summaries = []
        for s, p in enumerate(shards):
            p.terminate()     # SIGTERM: the server prints its summary
            rc, rest, err = finish(p, 120, f"replay-shard {s}")
            try:
                summaries.append(json.loads(rest.strip().splitlines()[-1]))
            except (IndexError, ValueError):
                fail(f"15(b): replay-shard {s} rc {rc}, printed "
                     f"{rest[-500:]}, stderr {err}")
        blocks = [sm["blocks"] for sm in summaries]
        if (blocks != run["routed"] or any(sm["corrupt"]
                                            for sm in summaries)):
            fail(f"15(b): shards ingested {blocks} blocks (corrupt "
                 f"{[sm['corrupt'] for sm in summaries]}), the trainer "
                 f"routed {run['routed']}")
        print(f"15(b) shard summaries: " + "; ".join(
            json.dumps(sm) for sm in summaries) + f" — ingested = routed "
            f"{run['routed']}, 0 corrupt", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the load generator (the evaluator waits out its timeout)
        t = time.perf_counter()
        load = edges_load(torch, card)
        gc.collect()
        torch.cuda.empty_cache()

        # (e) serve through the command line
        edges_serve(torch, card, ckdir, logdir)

        # (c) the evaluator: one record per complete checkpoint
        rc, rest, err = finish(ev, EDGES_FOLLOW_S + 120, "eval --follow")
        recs = [json.loads(ln) for ln in rest.strip().splitlines()
                if ln.startswith("{")]
        with open(curve_json) as f:
            curve = json.load(f)
        keys = {"step", "env_frames", "minutes", "mean_reward"}
        if (rc != 0 or [r["step"] for r in recs] != [4, 8]
                or recs != curve or any(set(r) != keys for r in recs)
                or not all(np.isfinite(r["mean_reward"]) for r in recs)):
            fail(f"15(c): eval rc {rc}, records {recs}, curve.json {curve},"
                 f" stderr {err}")
        try:
            import matplotlib  # noqa: F401
            have_mpl = True
        except ImportError:
            have_mpl = False
        wrote = os.path.exists(curve_png)
        if wrote != have_mpl:
            fail(f"15(c): plot written {wrote}, matplotlib {have_mpl}")
        print(f"15(c) eval --follow on {card}: rc 0, records {recs} = "
              f"curve.json; the plot "
              + ("written" if wrote else "skipped: no matplotlib here"),
              flush=True)

        # (f) the bench
        bench_line = edges_bench(torch, card)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
        shutil.rmtree(ckdir, ignore_errors=True)
        shutil.rmtree(logdir, ignore_errors=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}: "
          f"the command-line train's update interval p50 "
          f"{run['interval_p50']:.2f} ms over socket shards", flush=True)
    # by route: the f32-compute cell on lstm_step_f32, the reference's
    # two cells (bf16 compute) on lstm_step_wgmma
    return dict(cli_train=run["launches"],
                load_f32=load["float32_compute"],
                load_bf16=load["float32"] + load["bfloat16"],
                load_cells=load, bench=bench_line)


def lint_checkout(card: str) -> dict:
    """16(a): the port's analyzer over the checkout, in a subprocess on
    this machine (which has no JAX), against the committed baseline: exit
    0 means no drift from its 0 findings and its reasoned suppressions."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.analysis", "r2d2_tpu_torch",
         "--baseline", "GRAFTLINT_TORCH_BASELINE.json"],
        cwd=root, capture_output=True, text=True, timeout=120)
    last = gate.stdout.strip().splitlines()[-1] if gate.stdout else ""
    files = re.search(r"across (\d+) files", last)
    with open(os.path.join(root, "GRAFTLINT_TORCH_BASELINE.json")) as f:
        pinned = json.load(f)
    if (gate.returncode != 0 or not files or pinned["findings"]
            or not last.startswith("graftlint: 0 drift line(s)")):
        fail(f"16(a): the analyzer exited {gate.returncode}: "
             f"{gate.stdout[-3000:]} {gate.stderr[-3000:]}")
    out = dict(files=int(files.group(1)), findings=0,
               suppressions=sum(p["count"] for p in pinned["suppressions"]))
    print(f"16(a) graftlint on {card}'s host (no JAX installed): {last}; "
          f"{out['files']} files, {out['findings']} findings, "
          f"{out['suppressions']} suppressions "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return out


def soak_run_card(torch, card: str, ingraph: bool) -> dict:
    """16(b): ``tools/soak.py``'s ``main`` in this process on the card;
    its printed verdict and summary file checked, and the kernel's
    launches counted on the f32 route (``lstm_step_f32``: the soak
    computes in float32)."""
    import contextlib
    import io
    import tempfile

    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.tools import soak
    from r2d2_tpu_torch.utils.trace import (
        HOST_TRANSFERS,
        KERNEL_LAUNCHES,
        RETRACES,
    )

    label = "soak_ingraph" if ingraph else "soak_host"
    cfg = soak.soak_config(ingraph)
    n0 = len(RETRACES.entries())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as d:
        out_path = os.path.join(d, "soak.json")
        buf = io.StringIO()
        KERNEL_LAUNCHES.reset()
        HOST_TRANSFERS.reset()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = soak.main(SOAK_MINUTES, ingraph=ingraph, out=out_path,
                           log_interval=SOAK_LOG_S)
        run_s = time.perf_counter() - t
        launches = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        wgmma = KERNEL_LAUNCHES.get(lstm.KERNEL)
        acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
        printed = buf.getvalue()
        if rc != 0 or printed.rstrip().splitlines()[-1] != "SOAK PASS":
            fail(f"16(b) {label}: rc {rc}: {printed[-3000:]}")
        with open(out_path) as f:
            summary = json.load(f)
        with open(os.path.join(d, "soak.telemetry.jsonl")) as f:
            entries = len(f.readlines())
    if (summary["fabric_failed"] or not summary["priority_accounting_exact"]
            or not summary["no_throughput_decay"]
            or not summary["num_updates"]):
        fail(f"16(b) {label}: summary {summary}")
    if (launches != cfg.lstm_layers * acts or not acts or wgmma
            or cfg.compute_dtype != "float32"):
        fail(f"16(b) {label}: lstm_infer launched {launches} times on the "
             f"f32 route ({wgmma} on the tensor-core route) for "
             f"{acts} acts, {cfg.lstm_layers} layer, {cfg.compute_dtype}")
    # every act on the card replays its graph: the launches above are the
    # f32 route's cluster launch replayed from these captures
    graphs = act_instances(n0)
    if not graphs or any(t < 1 for _, t in graphs):
        fail(f"16(b) {label}: act instances and captures {graphs}")
    print(f"16(b) soak {label} on {card}, {SOAK_MINUTES} min (H = "
          f"{cfg.hidden_dim}, {cfg.compute_dtype}, {cfg.num_actors} actors "
          f"in {cfg.actor_fleets} fleets, k = {cfg.superstep_k}): SOAK PASS "
          f"in {run_s:.1f} s; {summary['num_updates']} updates, "
          f"{summary['env_steps']} env steps, updates/s mid "
          f"{summary['updates_per_sec_mid']} last "
          f"{summary['updates_per_sec_last']}, {entries} log entries; "
          f"lstm_infer launches {launches} = {cfg.lstm_layers} x {acts} acts"
          f" on {CUDACORE_KERNEL}, {wgmma} on {WGMMA_KERNEL}, replayed from "
          f"the acts' graphs (captures per act instance: {graphs})",
          flush=True)
    return dict(launches=launches, seconds=run_s, summary=summary)


def top_frame(args: list) -> str:
    """``python -m r2d2_tpu_torch.tools.r2d2_top --once <args>`` from this
    checkout: its frame; fails on a non-zero exit."""
    proc = subprocess.run(
        [sys.executable, "-m", "r2d2_tpu_torch.tools.r2d2_top", "--once",
         *args], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"16(c): r2d2_top {args} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return proc.stdout.rstrip("\n")


def top_live(torch, card: str) -> dict:
    """16(c): the flagship through ``cli.main(["train", ..., "--device",
    "cuda"])`` in this process with a telemetry port; while it trains,
    ``r2d2_top --once --url`` in its own process renders ``/statusz``;
    after it, ``r2d2_top --once <ckpt_dir>`` the run log."""
    import contextlib
    import io
    import shutil
    import socket
    import tempfile

    from r2d2_tpu_torch import cli
    from r2d2_tpu_torch.actor import ACTOR_ACT
    from r2d2_tpu_torch.config import Config
    from r2d2_tpu_torch.evaluate import EVAL_ACT
    from r2d2_tpu_torch.ops import lstm
    from r2d2_tpu_torch.telemetry.console import format_entry
    from r2d2_tpu_torch.telemetry.runlog import tail_entry
    from r2d2_tpu_torch.tools import r2d2_top
    from r2d2_tpu_torch.utils.trace import HOST_TRANSFERS, KERNEL_LAUNCHES

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_top_")
    live: dict = {}
    stop = threading.Event()

    def watch():
        # the run's first entry on /statusz, then one frame around two
        # scrapes of it (an entry a second: the frame is one of the two)
        while not stop.is_set():
            try:
                before = r2d2_top.fetch_statusz(url)
            except OSError:
                time.sleep(0.2)
                continue
            if not before.get("last_entry"):
                time.sleep(0.2)
                continue
            try:
                frame = top_frame(["--url", url])
                after = r2d2_top.fetch_statusz(url)
            except (OSError, SystemExit) as e:
                live["error"] = repr(e)
                return
            live.update(frame=frame, entries=[before["last_entry"],
                                              after["last_entry"]])
            return

    sets = []
    for k, v in TOP_SETS.items():
        sets += ["--set", f"{k}={str(v).lower() if isinstance(v, bool) else v}"]
    argv = ["train", "--game", "Fake", "--ckpt-dir", ckdir,
            "--training-steps", str(TOP_STEPS), "--quiet",
            "--max-wall-seconds", str(TOP_WALL_S), "--telemetry-port",
            str(port), "--device", "cuda", *sets]
    watcher = threading.Thread(target=watch, daemon=True)
    KERNEL_LAUNCHES.reset()
    HOST_TRANSFERS.reset()
    out = io.StringIO()
    t = time.perf_counter()
    try:
        watcher.start()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        run_s = time.perf_counter() - t
        stop.set()
        watcher.join(60)
        launches = KERNEL_LAUNCHES.get(lstm.KERNEL)
        old = KERNEL_LAUNCHES.get(lstm.CUDACORE_COUNTER)
        acts = HOST_TRANSFERS.get(ACTOR_ACT) + HOST_TRANSFERS.get(EVAL_ACT)
        log_path = os.path.join(ckdir, "telemetry", "run.jsonl")
        last = tail_entry(log_path)
        after_frame = top_frame([ckdir])
    finally:
        stop.set()
        shutil.rmtree(ckdir, ignore_errors=True)
    printed = out.getvalue().strip().splitlines()
    try:
        line = json.loads(printed[-1])
    except (IndexError, ValueError):
        fail(f"16(c): the train command printed no JSON line: {printed[-5:]}")
    if rc != 0 or line["num_updates"] != TOP_STEPS:
        fail(f"16(c): rc {rc}, printed {line}")
    if "frame" not in live:
        fail(f"16(c): no live frame from {url}: {live}")
    first = live["frame"].splitlines()[0]
    if first not in {format_entry(e) for e in live["entries"]}:
        fail(f"16(c): the live frame's first line {first!r} is not "
             f"format_entry of /statusz's last_entry {live['entries']}")
    if not last or after_frame != r2d2_top.render(last):
        fail(f"16(c): r2d2_top on the run log gave {after_frame!r}, want "
             f"{r2d2_top.render(last)!r}")
    layers = Config(game_name="Fake").lstm_layers
    if launches != layers * acts or not acts or old:
        fail(f"16(c): lstm_infer launched {launches} times on the "
             f"tensor-core route (CUDA-core {old}) for {acts} acts, "
             f"{layers} layer")
    print(f"16(c) r2d2_top on a live flagship run on {card} ({' '.join(argv)};"
          f" {line['num_updates']} updates in {run_s:.1f} s): the frame from "
          f"/statusz:\n{live['frame']}\nand from the run log after it:\n"
          f"{after_frame}\nlstm_infer launches {launches} = {layers} x "
          f"{acts} acts on lstm_step_wgmma, CUDA-core {old}", flush=True)
    return dict(launches=launches, seconds=run_s)


def phase_lint_soak_top(torch, card: str) -> dict:
    """Phase 16: graftlint over the checkout, the soak's fabric in both
    drivetrains, r2d2_top on a live flagship run (the module docstring).
    Returns the kernel's launches by path."""
    import gc

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(LINT_WATCHDOG_S)
    print(f"reduced: the soak 20.0 -> {SOAK_MINUTES} minutes a drivetrain, "
          f"a stats entry every 10.0 -> {SOAK_LOG_S} s; "
          f"the flagship run " + ", ".join(
              f"{k} -> {v}" for k, v in TOP_SETS.items())
          + f", training_steps -> {TOP_STEPS}", flush=True)
    lint = lint_checkout(card)
    runs = {}
    for ingraph in (False, True):
        r = soak_run_card(torch, card, ingraph)
        runs["soak_ingraph" if ingraph else "soak_host"] = r
        gc.collect()
        torch.cuda.empty_cache()
    top = top_live(torch, card)
    faulthandler.cancel_dump_traceback_later()
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s on {card}: "
          f"the analyzer's {lint['files']} files clean, soaks "
          f"{runs['soak_host']['seconds']:.1f} / "
          f"{runs['soak_ingraph']['seconds']:.1f} s, the live run "
          f"{top['seconds']:.1f} s", flush=True)
    return dict(soak_host=runs["soak_host"]["launches"],
                soak_ingraph=runs["soak_ingraph"]["launches"],
                top_flagship=top["launches"], lint=lint)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    try:
        from r2d2_tpu_torch.ops import _build
        from r2d2_tpu_torch.ops import lstm
        from r2d2_tpu_torch.utils.trace import RETRACES
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "root of a checkout")

    # phase 1: the device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    secs = _build.build([lstm.KERNEL], verbose=True)
    print(f"build: {secs} ({time.perf_counter() - t0:.2f} s)", flush=True)

    spent = {}

    def timed(label, fn, *args):
        n0 = len(RETRACES.entries())
        t = time.perf_counter()
        out = fn(*args)
        spent[label] = round(time.perf_counter() - t, 1)
        if int(label) >= 4:
            print(f"phase {label} act instances built in this process and "
                  f"their traces (on the card CUDA-graph captures; a CPU "
                  f"twin's input signatures): {act_instances(n0)}",
                  flush=True)
        if int(label) >= 5:
            retraces_line(label)
        return out

    # phase 3: every design against its plain version, and the timings
    errs, sweep, timings = timed("3", phase_kernel, torch, lstm)

    # phase 4: the serving path at full width
    serve_launches = timed("4", phase_serving, torch, card)

    # phase 5: the training path at full width
    train_launches = timed("5", phase_training, torch, card)

    # phase 6: the IMPALA-deep fabric, resumed, and its checkpoint served
    fabric_launches, serve_ckpt_launches = timed("6", phase_fabric, torch,
                                                 card)

    # phase 7: the Pong preset from its full replay ring on the card
    device_replay_launches, thread_timings = timed(
        "7", phase_device_replay, torch, card)

    # phase 8: anakin, the fused loop, from its full ring on the card
    anakin_launches = timed("8", phase_anakin, torch, card)

    # phase 9: the Pong preset's actors in subprocess fleets, serve and
    # local inference
    fleet_launches = timed("9", phase_process_fleets, torch, card,
                           thread_timings)

    # phase 10: the flagship from K replay shards, over shm and sockets
    replay_launches, _ = timed("10", phase_replay_shards, torch, card,
                               flagship_replay_config())

    # phase 11: the learner mesh over NCCL, world size 1
    mesh_launches = timed("11", phase_mesh, torch, card)

    # phase 12: the cross-rank draw, in-graph PER and anakin on the mesh
    draw_launches = timed("12", phase_mesh_draw, torch, card)

    # phase 13: the league, member fleets and the CPU eval sidecar
    league_launches = timed("13", phase_league, torch, card)

    # phase 14: telemetry and guards — the in-graph diagnostics, the
    # cross-process trace with /tracez and /profilez, the transfer guard
    telemetry_launches = timed("14", phase_telemetry, torch, card)

    # phase 15: the edges — the command line, eval --follow, the session
    # load generator (its f32 cell on lstm_step_f32), serve, bench
    edges = timed("15", phase_edges, torch, card)

    # phase 16: graftlint over the checkout, the soak's fabric (its f32
    # config on lstm_step_f32) and r2d2_top on a live flagship run
    late = timed("16", phase_lint_soak_top, torch, card)
    print(f"phase seconds on {card}: {json.dumps(spent)}, in all "
          f"{sum(spent.values()):.1f} s after the build", flush=True)

    head = timings[(1, 256)]
    f32_head = timings[("f32",) + F32_TIMED[0]]
    launches = (serve_launches + train_launches + fabric_launches
                + serve_ckpt_launches + device_replay_launches
                + anakin_launches + fleet_launches["serve"]
                + fleet_launches["local"] + sum(replay_launches.values())
                + sum(mesh_launches.values()) + sum(draw_launches.values())
                + sum(league_launches.values())
                + sum(telemetry_launches.values()) + edges["cli_train"]
                + edges["load_bf16"] + edges["load_f32"]
                + late["soak_host"] + late["soak_ingraph"]
                + late["top_flagship"])
    cudacore = edges["load_f32"] + late["soak_host"] + late["soak_ingraph"]
    print(json.dumps({"kernels": [{
        "name": "lstm_infer",
        "route": "cuda",
        "source": "r2d2_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "r2d2_tpu/ops/lstm.py:46",
        # the tensor-core route (bf16 wh, lstm_step_wgmma); the f32
        # route's kernel, which runs in the load generator's float32 cell
        # and the soak's two runs, is the next entry
        "launches": launches - cudacore,
        "launches_by_route": {WGMMA_KERNEL: launches - cudacore,
                              CUDACORE_KERNEL: cudacore},
        "launches_by_path": {"serving": serve_launches,
                             "training": train_launches,
                             "fabric": fabric_launches,
                             "serving_checkpoint": serve_ckpt_launches,
                             "device_replay": device_replay_launches,
                             "anakin": anakin_launches,
                             "process_serve": fleet_launches["serve"],
                             "process_local": fleet_launches["local"],
                             "replay_k1": replay_launches["k1"],
                             "replay_shm": replay_launches["shm"],
                             "replay_socket": replay_launches["socket"],
                             "mesh_sync": mesh_launches["sync"],
                             "mesh_ring": mesh_launches["ring"],
                             "mesh_in_graph": draw_launches["in_graph"],
                             "mesh_anakin": draw_launches["anakin"],
                             "league": league_launches["run"],
                             "league_chaos": league_launches["chaos"],
                             "telemetry_diagnosed":
                                 telemetry_launches["diagnosed"],
                             "telemetry_capture":
                                 telemetry_launches["capture"],
                             "telemetry_guarded_serve":
                                 telemetry_launches["guarded_serve"],
                             "edges_cli_train": edges["cli_train"],
                             "edges_load_f32": edges["load_f32"],
                             "edges_load_bf16": edges["load_bf16"],
                             "soak_host": late["soak_host"],
                             "soak_ingraph": late["soak_ingraph"],
                             "top_flagship": late["top_flagship"]},
        "max_abs_err": errs["tensor_core"][0],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "layer_step_ms": head["layer_step_ms"],
        "device_ms": head["device_ms"],
        "plain_device_ms": head["plain_device_ms"],
        "library_device_ms": head["library_device_ms"],
        "layer_step_device_ms": head["layer_step_device_ms"],
        "checked": True,
        "times": "*ms: per call with the launch (CUDA events); *device_ms: "
                 "device time per call (torch.profiler); *host_us: host "
                 "time to issue a call; library_ms (torch.lstm_cell) and "
                 "layer_step_ms are one LSTM layer step (x @ wi + b and "
                 "the recurrence), ms and plain_ms the recurrence alone; "
                 f"bf16 wh, H={H}, mean of {ROUNDS} rounds",
        "shape": {"T": 1, "B": 256, "H": H, "wh": "bfloat16"},
        "by_shape": {f"T={k[0]} B={k[1]}": v for k, v in timings.items()
                     if len(k) == 2},
        "max_abs_err_by_design": {k: {"per_step": v[0], "whole_unroll": v[1]}
                                  for k, v in errs.items()},
        "tile_sweep_device_ms": sweep,
        "phase_seconds": spent,
        "bench": edges["bench"],
        "graftlint": late["lint"],
        "card": card,
    }, {
        "name": "lstm_infer_f32",
        "route": "cuda",
        "source": "r2d2_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "r2d2_tpu/ops/lstm.py:46",
        # the f32 route (f32 wh, lstm_step_f32): the load generator's
        # float32 cell and the soak's two runs
        "launches": cudacore,
        "launches_by_path": {"edges_load_f32": edges["load_f32"],
                             "soak_host": late["soak_host"],
                             "soak_ingraph": late["soak_ingraph"]},
        "max_abs_err": max(errs["cuda_core_f32"][0], max(
            v["max_abs_err"] for k, v in timings.items() if len(k) == 4)),
        "ms": f32_head["ms"],
        "plain_ms": f32_head["plain_ms"],
        "bound_ms": f32_head["bound_ms"],
        "bound_by": f32_head["bound_by"],
        "library_ms": f32_head["library_ms"],
        "layer_step_ms": f32_head["layer_step_ms"],
        "device_ms": f32_head["device_ms"],
        "pr1_ms": f32_head["pr1_ms"],
        "pr1_device_ms": f32_head["pr1_device_ms"],
        "plain_device_ms": f32_head["plain_device_ms"],
        "library_device_ms": f32_head["library_device_ms"],
        "layer_step_device_ms": f32_head["layer_step_device_ms"],
        "checked": True,
        "times": "as the first entry's; library_ms is torch.lstm_cell in "
                 "f32 with TF32 off; pr1_* the first CUDA-core design in "
                 f"f32; mean of {ROUNDS} rounds",
        "shape": dict(zip(("T", "B", "H"), F32_TIMED[0]), wh="float32"),
        "by_shape": {f"T={k[1]} B={k[2]} H={k[3]}": v
                     for k, v in timings.items() if len(k) == 4},
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
