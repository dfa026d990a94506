#!/usr/bin/env python3
"""Smoke run of allegro_tpu_torch on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase 13   # the build, then phase 8, 9, 10, 11, 12 or 13 alone

Phases (any failure exits non-zero; there is no CPU fallback):

0. device: the card's name and power limit (``nvidia-smi``);
1. build: compile the CUDA kernels (``allegro_tpu_torch/csrc/*.cu``) with
   nvcc, one process per source, all started together;
2. kernels: on the 4,096-atom periodic crystal (r_max 4.0, seed 0), each
   kernel against its plain PyTorch version at the flagship shapes, bound
   max|err| / max|ref| < 1e-5, with median times from CUDA events: the four
   layer kernels at both layers (U = 32; layer 0 dims (9, 9, 9) with 83 CG
   entries, layer 1 (9, 9, 1) with 9); the mega kernels on the mega model's
   weights: ``latent_env_scatter`` and ``latent_env_bwd`` without a hidden
   layer (the first projection, W0 [64, 160]) and with one (layer 0's latent,
   W0 [96, 64], W1 [64, 160]), ``gather_tp_embed`` with its split output and
   ``bwd_embed`` with ``gts``, and ``gather_tp`` with the split output and
   ``bwd_fused`` with ``gts`` at layer-0 dims (``gather_tp`` walks the
   layer's path table, ``bwd_fused`` those of its role swap and of its
   (0, 2, 1) order, ``Contracter.infer_paths``), and at layer 0 beside
   ``bwd_fused`` the pair that computes its function in two launches,
   ``gather_tp`` on the role swap and ``tp_scatter`` (``bwd_fused[pair]``),
   and at both layers beside ``unweight_both`` the pair ``unweight_sh`` +
   ``unweight_w`` (``unweight_both[pair]``);
   then, checks only, the
   mega kernels at U = 16 and 48 (the lane loops for other widths; the
   layer kernels at those widths are phase 5a's shape checks) and
   ``gather_tp`` without its split output, ``gather_tp_embed`` (with and
   without its split output), ``bwd_embed`` and ``gather_tp`` (with and
   without) on an l = 4 layer at U = 32, whose paths beyond the compiled CG
   header take the kernels' per-entry default case, and the mega kernels,
   ``gather_tp`` (with and without), ``env_scatter`` (against float64),
   ``tp_scatter`` (both role orders, against the plain version in float64),
   ``unweight_sh``, ``bwd_fused`` (with and without ``gts``, against
   float64), ``unweight_w``, ``unweight_both`` and ``readout_sum`` on the
   same crystal at r_max 7.0 (~134 edges per atom: a segment spans three of
   ``latent_env_scatter``'s 64-edge tiles, and each of ``tp_scatter``'s and
   ``bwd_fused``'s four chunks walks ~34 of its edges); the center gather
   and sum on positions [4096, 3] at the center and the neighbor side, and
   timed at every other width a user path runs them (``center_cases``: the
   [·, 1] energy column, the ``pallas`` env sums at d2 U = 288 and the
   l_max-3 256, the chunked sums of two class CSRs against float64), and
   untimed on their scalar builds (C = 18 on both sides and chunked, C =
   288 from bases that are not 16-byte aligned: ``[scalar]``);
   the fused readout and its backward on three 64-wide pieces (W0 [192,
   32], w1 [32, 1]); the launch floor, an empty kernel's time under the
   same timer, printed again before the kernels line;
3. force call: the flagship ``AllegroModel`` (l_max 2, 2 layers, 64 scalar
   and 32 tensor features, random weights from seed 0) on ``fused_infer`` in
   three configurations: ``mega`` (the default ``use_mega=None``: the JAX
   bench's default kwargs), and with ``use_mega=False`` the fused readout
   and the plain readout chain (``use_fused_readout=False``). 5 force calls
   each, with the exact launch count of every kernel asserted after each
   call; outputs finite and in agreement with the port's plain ``einsum``
   backend on the same card (force max-abs rel < 1e-5, per-atom energies
   allclose at 5e-5). Prints µs/atom per force call, the run-to-run
   max |Δforces| of two identical calls and a torch.profiler breakdown of
   three ``mega`` calls; (3w) the routing rule for models wider than the
   fused kernels' shared memory: ``ops/smem_fit.py``'s bytes against the
   launchers' own (``atpt_*_smem``) over 1,108 widths on both sides of the
   card's opt-in limit, then ``WIDE_MODELS`` (S = 128 with 3 layers and
   readout width 128; S = 128 with latent width 128; S = 256 with latent
   width 256) on the default path: their ``Model.routes()`` printed and
   asserted, one force call each with exact launch counts held to
   ``einsum`` as above, and their µs/atom;
4. MD and calculator, on the ``mega`` model: ``md.Simulation`` runs 100
   steps (10 blocks) of NVE on the crystal with a skin small enough to
   re-neighbor, asserting finite positions, the exact launch counts of every
   block (each of its force calls), no host synchronization inside a block,
   and agreement within 1e-4 Å with the ``einsum`` backend after the first
   block; prints the energy drift, ms/step and µs/atom per step. Then three
   ``AllegroCalculator.calculate`` calls on jittered copies of the crystal,
   each checked against ``apply_with_derivatives`` and its launch counts;
   the padded buckets must not grow after the first call. Every MD neighbor
   list must come from the native C++ list. (4c) per-edge-type cutoffs
   (``PER_TYPE_CUTOFF``) on the flagship's mega path: the per-type list's
   edges beside the r_max list's, one force call with exact launch counts
   held to ``einsum``, two with the same bits, µs/atom, and 20 MD steps with
   the per-type skin on native lists, within 1e-4 Å of ``einsum`` MD.

5. training on the trainable ``fused`` backend: (a) on the JAX bench's
   4 x 1,000-atom crystal batch (seeds 200-203, 100,928 edges), the four
   transposes ``tp_scatter``, ``gather_dw`` (each layer's entry table in
   both role orders; against the plain version in float64), ``unweight_sh``,
   ``unweight_w`` and ``gather_tp`` on the role-swapped table (and, checked,
   the layer's own), each against its plain version (1e-5) with median
   times, then checks only at U = 16 and 48, and (the shape checks, on the
   edges of a quarter of the batch's atoms and every sentinel edge:
   ``SHAPE_ROWS``) ``gather_tp`` (with and
   without its split output) and ``gather_dw`` in both role orders on
   those edges less one (an odd count) at U = 16 and 48 and on an l = 4
   layer (walk rows beyond the header), with x nonzero on the sentinel
   edges, and ``tp_scatter`` (both orders, against float64) and
   ``unweight_sh`` at those shapes on the batch's edges less those of atom
   ``EMPTY_ATOM`` (a segment without edges) and an odd count (a whole number
   of no tile's or chunk's edges), with x, g and wexp nonzero on the
   sentinel edges, and ``unweight_sh`` on an l = 4 layer at U = 256 and
   512, whose full tile outgrows the card's shared memory (the launcher
   stages fewer t rows, then takes smaller tiles), on the edges of the
   first ``WIDE_ATOMS`` atoms less one; ``env_scatter`` (against float64)
   wherever ``unweight_sh`` is checked (at U = 256 and 512 its chunks are
   cut and a block takes a slice of one atom's items); ``bwd_fused`` (with
   and without ``gts``, against float64) and ``unweight_w`` at the same
   shapes, with x, g, gts and sh nonzero on the sentinel edges, and
   ``unweight_w`` on the l = 4 dims at U = 256 and 512; ``unweight_both``
   wherever ``unweight_w`` is checked (its full tile outgrows shared memory
   at U = 256 and 512 too); ``readout_sum`` and ``readout_bwd`` on the
   edges less atom ``EMPTY_ATOM``'s with their pieces nonzero on the
   sentinel edges: the
   flagship's 64-wide column slices at H = 20, 32, 64 and without a hidden
   layer, pieces 5, 3 and 17 wide, slices not 16-byte aligned, and K = 768
   (32-edge tiles); ``gather_tp``, ``gather_dw``, ``tp_scatter`` and
   ``bwd_fused`` on the card without their path tables must raise; (b) on
   that batch (zero
   targets) and on the bench's 16 synthetic 21-atom frames (984 edges):
   the flagship on ``fused`` through ``Trainer.fit``, Adam 1e-3, EMA 0.999,
   10 steps with the exact launch count of every kernel per step, finite
   losses that fall, ms per step, samples/s, peak memory, two identical
   3-step runs that must end in the same bits, and (1k batch) a
   torch.profiler breakdown of 3 steps; (c) on the first step of each
   batch, the parameter gradients against the ``einsum`` backend from the
   same weights (max-abs error over max-abs < 1e-4 per tensor); on the 1k
   batch, two identical training steps whose gradients must agree bit for
   bit in every parameter, for the flagship and for it with the spline
   embed and trainable per-type scales and shifts (``TABLE_MODEL``: every
   parameter table read by class, through the class CSR).
6. the ``pallas`` backend (kernels 20 and 21, ``csrc/sparse_tp.cu``, each
   walking the role order's path table): (a) ``sparse_tp`` and
   ``sparse_tp_gradw`` against their plain versions on the crystal's
   103,532 edges at both layer dims, in all six role orders of the layer's
   table (the three untimed ones on a quarter of those rows: the walks do
   not depend on the row count), with and without path-channel coupling
   (1e-5; ``sparse_tp_gradw``,
   whose entries sum ~10^5 edges, against the plain version in float64),
   with median times (the table and its a- and b-swaps; the plain versions
   timed in float32), the bound and the one PyTorch call
   computing the same function (``torch.einsum`` with the dense CG tensor;
   "OOM" where it runs out of memory); then, checks only, on 103,531 edges
   (not a whole number of any block's edges), all six orders at U = 16 and
   48 and on an l = 4 layer (dims 25, 1,158 entries: paths beyond the
   compiled CG header, walked entry by entry); (b) 5 force calls of the
   flagship on ``pallas`` with exact launch counts (6 ``sparse_tp``; the
   env sums, position gathers and edge-energy sum on the center kernels,
   7 + 7), held to ``einsum`` as in phase 3, its µs/atom and a
   torch.profiler breakdown of 3 calls; (c) phase 5b/5c on ``pallas``
   (with 5b's profile of 3 steps on the 1k batch): 10 Adam steps on
   each batch with the exact launch counts of every step, the loss falls,
   first-step gradients within 1e-4 of ``einsum``'s, and 5b/5c's same-bits
   checks; (d) the command line in
   subprocesses, as shipped: ``python -m allegro_tpu_torch md -c
   configs/md.yaml`` (1,000 atoms, 200 steps on ``pallas``), ``run -c
   configs/tutorial.yaml`` (train + test, ``einsum`` + ZBL), the same with
   ``model.tp_kernel_backend: pallas``, and the tutorial under ``optax.sgd``
   (momentum 0.9) with ``optax.exponential_decay``, ``profile_dir`` and the
   ``package`` stage (``-o``), the four processes started together; each
   must exit 0 and write its log,
   checkpoints and test metrics, with the exact launch counts of its run;
   the package must hold the checkpoint's EMA parameters and give their
   force call bit for bit, and the profiler must have left a trace.
7. kernels 18 and 19 and the rest of the model surface: (b) ``bwd_fused``
   with its weight gradient (kernel 18) at the flagship's layer dims, with
   and without dw, two calls with the same bits, timed at layer 0 beside the
   three kernels it can replace on the same inputs, and ``unweight_both``
   from one denv array (kernel 19); (a) every kernel with a basis dimension
   (1-4, 7-10, 13-21) at the shapes of the JAX bench's l_max-3 model
   (``run_lmax3_bench``): layer 0 (16, 16, 16; 353 entries, timed) and
   layer 1 (16, 16, 1) of the 2-layer model, the 3-layer model's (16, 16,
   31) and (31, 16, 16) (611 entries); (c) the l_max-3 force call on
   ``mega``, ``use_mega=False``, ``pallas`` and ``einsum``: exact launch
   counts, agreement with ``einsum`` as in phase 3, µs/atom, peak memory, a
   torch.profiler breakdown; (d) 20 MD steps on ``mega`` (within 1e-4 Å of
   ``einsum``) and a calculator call; (e) one force call of each remaining
   configuration (``parity=False`` at 3 layers, the 3-layer l_max-3 model,
   shared env weights, the spline embed) on ``fused_infer``'s default and
   ``pallas`` against ``einsum``, with exact launch counts.
   In phases 3, 5c, 6b, 6c, 7c, 7e and 8 two identical force calls must
   agree bit for bit in energy, forces and virial (5c and 6c: on the 1k
   batch of four periodic frames, whose virial sums per frame). The plain
   versions are timed with fewer calls than the kernels (``PLAIN_TIMING``;
   phase 7's, fewer still: ``PHASE7_PLAIN_TIMING``).
8. the JAX bench's headline system (``us_per_atom_100k``): the 97,336-atom
   crystal (``crystal_frame(97336, 4.0, 0)``, r_max 4.0, 2,457,212 edges;
   its list from the native cell list) on the flagship's default mega path,
   each call with its launches counted (every kernel of the mega path at
   least once), two identical calls the same bits, µs/atom (host clock),
   device busy and idle (torch.profiler) and peak memory, freed between
   them: (a) the f32 force call; (b) the JAX bench's 100k policy
   (``POLICY_100K``: the bf16 track, "high", remat, checkpoint_energy),
   whose forces must meet the reference allclose against (a)'s, max(|Δf| -
   5e-5 |f|) <= 5e-5; (c) remat and checkpoint_energy in f32, the same bits
   as (a); (d) ``StreamedEvaluator`` at f32 with 8 chunks, within rtol 1e-4
   / atol 1e-5 of (a)'s forces and rtol 1e-3 / atol 1e-4 of its virial;
   then (e) the bf16 forms of kernels 2, 3 and 7-10 at the flagship's
   4,096-atom shapes, each against its plain version on the same bf16
   inputs (``check_bf16_case``: bf16 outputs within 1 bf16 ulp beyond the
   float32 tolerance, float32 outputs within 1e-5, plus for 7's env and 8's
   dsh one bf16 ulp of each rounded env weight they sum), the share of
   outputs that are not the same bits, and the median device times of the
   form, its plain version and its float32 form beside the bound (the
   track's elements at 2 B). The bf16 forms stage the same float32 columns
   in shared memory as the float32 forms (they widen as they load), so
   ``check_fit_rule`` holds both storage types.
9. deployment (``deploy_phase``; ``--phase 9`` runs it alone, on a tutorial
   workdir it trains while the kernels build): the mega model's force call on the ghost-format crystal (its
   list to r_max + ``DEPLOY_SKIN``, the C++ driver's), padded with room to
   grow, exported by ``compile/export.py``: (a) the ``ExportedProgram``'s
   module on the card holds one ``atpt::`` op per launch of the eager call
   and gives its outputs within 1e-6 rel (the same bits expected); (b) the
   ``.pt2`` (AOTInductor; its build seconds printed) loaded in this
   process: forces within 1e-5 rel and energies within 5e-5 of the eager
   call, two calls the same bits, the eager call's launches per call, and
   eager against ``.pt2`` µs/atom in turns; (c) the C++ MD driver
   (``native/md_driver.py``, built in the background from the start of
   (b)) runs ``--selftest``, then 1 and ``DEPLOY_STEPS`` velocity-Verlet
   steps of the crystal on (b)'s package: its step-0 forces, recovered from
   the first displacement, within 1e-4 rel of the eager call's, its final
   positions within 1e-4 A of a host float64 Verlet driven by eager forces;
   (d) ``python -m allegro_tpu_torch compile`` on phase 6d's tutorial
   workdir (started with (c)'s build), its ``.pt2`` loaded and called once
   against the eager model of the same checkpoint; (e) every model the port
   builds exported at the same padded shape (``EXPORT_MODELS``: md.yaml's
   on ``pallas``, the flagship on ``fused``, under ``POLICY_100K`` on the
   mega route, the bf16 track with ``use_mega=False``, ``remat`` +
   ``checkpoint_energy`` in f32, ``einsum`` with ``tp_chunk_edges``): (a)
   each program's module on the card holds one ``atpt::`` op per launch of
   the eager call, op by op, and one set bf16 flag per bf16 launch, gives
   the eager outputs within 1e-6 rel (the same bits expected) and the same
   bits twice; (b) the ``POLICY_100K`` model's ``.pt2``, built by a child
   process started with (c)'s build (its seconds printed), loaded here:
   forces within 1e-5 rel and energies within 5e-5 of sum |E_i| of the
   eager call, the same bits twice, per call the launches of the program's
   live ops (the eager call's less the recomputed ops whose results nothing
   reads, which the compiler drops; a recompute merged into the forward
   would launch fewer still), eager against ``.pt2`` us/atom in turns, and each one's peak memory net of the
   inputs beside the call without remat and checkpoint_energy; (c) the C++
   driver runs that package for 1 and ``DEPLOY_STEPS`` steps against a host
   Verlet on eager forces, as in (c) above (the bf16 flags of
   ``csrc/torch_ops.cpp``); (d) every ``atpt::`` op form those models and
   ``OP_CHECK_MODELS`` call on a 512-atom crystal, captured with its
   arguments and outputs, called again through ``csrc/torch_ops.cpp``'s
   implementation in a child process that loads it as a library
   (``native.build_torch_ops``) without ``ops/custom_ops.py``: the same
   bits, every op of ``custom_ops.SCHEMAS`` held.
10. multi-device (``parallel_phase``; ``--phase 10`` runs it alone), every mesh ``[cuda:0] * D`` on this one card: (a) slab
   at D = 2 and 4, brick at (2, 2, 1) and (2, 2, 2) on the 4,096-atom
   crystal (``parallel.SlabDecomposition`` / ``BrickDecomposition``: halo
   exchange, the mega force call per domain, ghost forces sent back in a
   fixed order) against the undecomposed force call (``Model.energy_forces``
   on the same list): energy within 1e-5 of sum |E_i| (the crystal's total
   is a near-cancellation, so its own relative error is printed beside),
   forces within 5e-5 of max|F|, two calls the same bits, each kernel's launches D times the
   undecomposed call's, ms per call beside it in turns; (b) ``edge_shard``
   over ``[cuda:0] * 2`` against one device (energy, forces, launches 2x);
   (c) 20 NVE steps (2 blocks) with ``slab`` (D = 2) and ``brick`` (2, 2,
   1) against one-device ``edge_shard``: positions within 1e-4 A, launches
   per block D x 11 x the call's, ms per step; (d) ``Trainer(mesh=[cuda:0,
   cuda:0])`` on ``fused`` over two 1k-atom crystals (phase 5's seeds 200
   and 201), one per row: its mean gradient equal to the mean of the two
   one-row gradients bit for bit, twice; launches 2x a one-row step's; ms
   per step.
11. the bf16 tensor track off the mega route (``track_phase``; ``--phase
   11`` runs it alone): (a) the bf16 forms of
   kernels 1, 4 and 14-17 (the env weights of ``env_scatter``,
   ``unweight_sh`` and ``unweight_both`` in bfloat16, and the dwexp that
   ``unweight_both`` and ``unweight_w`` store; the x and g of ``tp_scatter``
   and ``gather_dw``) at the flagship's 4,096-atom shapes, each against its
   plain version on the same bf16 inputs (``check_bf16_case``) and timed
   beside its float32 form; untimed checks of ``unweight_both`` with a
   float32 dwexp (a mega model routed off the mega kernels) and of
   ``tp_scatter`` and ``gather_dw`` on layer 0's table (where training
   launches them too); (b) under
   ``POLICY_100K``, the flagship with ``use_mega=False`` (JAX's non-mega
   semantics) and phase 3w's widest model, routed to ``fused_call`` on this
   card (JAX's mega semantics), against the float64 ``einsum`` oracle: the
   routed model within the reference allclose, the ``use_mega=False`` call
   within ``OFF_MEGA_TOL`` (its 5e-5 margin printed beside: JAX's non-mega
   path rounds layer 0's input features, which mega does not; JAX's own call
   misses 5e-5 by as much on this crystal), each energy within its force
   tolerance of sum |E_i|, each with its exact bf16 launches (``TRACK_CALL``, ``TRACK_ROUTED_CALL``) and two
   calls the same bits; (c) on phase 5's 1k batch, the first step's
   gradients on ``fused`` with the track against the float32 ``einsum``
   step's (``TRACK_GRAD_TOL``, margin printed), then
   ``TRACK_TRAIN_STEPS`` Adam steps: every launch of the trainable
   family a bf16 form (``PER_STEP``'s counts), finite losses, float32
   parameters and gradients, two identical steps' gradients the same bits.
12. a bfloat16 model (``model_dtype="bfloat16"``; ``model_phase``;
   ``--phase 12`` runs it alone), the flagship's weights from seed 0 rounded
   to bfloat16: (b) a force call on each route (``mega``,
   ``use_mega=False``, ``pallas``, ``einsum``) with its exact launches and
   bf16-operand launches (``MODEL_ROUTES``), output dtypes those of the
   CPU's call, two calls the same bits, forces and per-atom energies
   against the port's bfloat16 ``einsum`` and the float64 ``einsum`` oracle
   (``MODEL_F_TOL``, ``MODEL_E_TOL``; margins printed) and µs/atom; (a) the
   bf16-operand forms of kernels 1-12 and 20 at the flagship shapes
   (``check_model_forms``), each against its plain version in float64 on
   the same bfloat16 inputs (bfloat16 outputs within 1 bf16 ulp, float32
   outputs within KERNEL_TOL), ``sparse_tp``'s against its plain version
   (JAX's bfloat16 rounding op by op), each timed beside its float32 form;
   (c) ``MODEL_MD_STEPS`` MD steps and one calculator call on the default
   route against the same on the bfloat16 ``einsum``.

13. a bfloat16 model in training (``model_train_phase``; ``--phase 13``
   runs it alone), the flagship's weights from seed 0 rounded to bfloat16
   on phase 5's 1k batch: (a) the bf16-operand forms of kernels 13-17 and
   21 its training step launches, at that batch's shapes on both layers
   (``check_model_train_forms``): 13-17 against their plain versions in
   float64 (bfloat16 outputs within 1 bf16 ulp, float32 outputs within
   KERNEL_TOL), ``sparse_tp_gradw`` the same bits as its plain version in
   each role order a ``pallas`` step launches, each timed beside its
   float32 form; (c) the first step's gradients on ``fused`` and ``pallas``
   against the bfloat16 and the float32 ``einsum`` step's (``SPREAD_GRAD``,
   margins printed), two identical steps the same bits on every backend
   (``einsum`` under ``deterministic_algorithms``); (b)
   ``MODEL_TRAIN_STEPS`` Adam steps on ``fused`` and on ``pallas``: each
   step's exact launches and bf16-operand launches (``MODEL_TRAIN_BF16``),
   finite losses, bfloat16 parameters, gradients, EMA and moments, two
   identical steps the same bits, ms per step beside the float32 model's in
   turns.

``--phase N`` (8, 9, 10, 11, 12 or 13) runs phases 0 and 1, builds the
flagship's models on the crystal as a whole run does, runs phase N (8 with
8e) with a fresh ``RandomState(SEED)``, prints the ptxas lines of its bf16
forms and its rows of the kernels line (8, 11, 12, 13) or its launches
(10), then ``[done]``; no ``ok`` line, since the other phases did not run.

The run prints its total seconds (``[done]``). The last two lines of stdout
are a JSON object with the kernels' records and the JSON result ``{"ok":
true, "device": {...}}``. The kernels line has one row per TPU kernel
(``tpu_kernel`` 1-21, ``name`` the port's wrapper, with ``[variant]`` where
a variant serves it). A row's ``ms`` and ``plain_ms`` sum the device times
of its launches in one force call of ``ms_config`` (``mega``, except for
the four layer kernels and 19 on ``use_mega=False``: ``fused readout``,
where all their launches are; for the trainable backend's kernels, ``train
step``: one launch per layer; 18: its layer-0 launch). ``launches`` is the
total of every launch in the force calls of all four configurations of
phases 3 and 6b (5 calls each) and in the 10 training steps on the 1k batch
of both backends (phases 5b and 6c): the kernel's launches on every path
the run times (0 for 18, which no user path runs, in JAX either).
``sparse_tp`` is timed on the ``pallas`` force call (its 6 launches),
``sparse_tp_gradw`` on the ``pallas`` training step (one launch per layer
and table order, 6 of its 8 per step).
``bound_ms`` is the least time of the same work on the card (the bytes of
the inputs read once and the outputs written once at 3.35 TB/s, or the
FLOPs at 67 TFLOP/s f32, the larger; ``bound_by`` says which),
``library_ms`` the time of one PyTorch call computing the same function
where there is one (the center gather and sum, ``sparse_tp*``), else null,
``ptxas`` the registers and spill bytes of each of its entry functions
(``-Xptxas -v`` of this run's build).
Every configuration and entry point has its own ``launches_*`` key (phase
10's runs ``launches_parallel_*``: each decomposed call, the edge_shard
call, both MD runs' 20 steps, the data-parallel step); the
``*_lmax3`` keys are the same kernel's record at the l_max-3 layer-0 shapes;
variants (``[split]``, ``[gts]``, ``[swapped]``, ``[dw]``, ``[trio]``, ``[pair]``; the
center gather's and sum's other widths, ``[C1]``, ``[C288]``, ``[C256]``,
``[chunked1024]``, ``[chunked32]``, ``[class32]``: ``center_cases``) have
their own ``ms_*``, ``plain_ms_*``, ``bound_ms_*`` and ``library_ms_*`` in the base row;
``pair_ms`` (and ``pair_ms_lmax3``) is the ``[pair]`` variant's time: the two
launches that compute the same function (``unweight_sh`` + ``unweight_w``
for ``unweight_both``; ``gather_tp`` swapped + ``tp_scatter`` for
``bwd_fused``, at layer 0).
After the 21 rows, one row per bf16 form (``name[bf16]``, kernels 2, 3,
7-10; ``bf16_record``): its times at the flagship shapes (phase 8e, one
launch per layer of the 100k policy's force call), ``ms_f32_form`` beside
them, ``max_ulps``, ``not_same_bits`` (``same_bits``: the share of its
bfloat16-stored outputs, null where it stores none) and
``not_same_bits_all`` (of all its outputs), and as ``launches`` its launches
in one force call of the 100k policy on the 97,336-atom crystal (phase 8b:
the recomputes of remat and checkpoint_energy included). Then one row per
bf16 form of phase 11 (kernels 1, 4, 14-17; ``track_record``): its times at
the flagship shapes (11a) and as ``launches`` the sum of its bf16 launches
in the ``use_mega=False`` force call of 11b and one training step of 11c,
each also under its own key. Then the rows of phase 12's bf16-operand
forms (``name[bf16 model]``, kernels 1-12 and 20; ``model_record``) and of
phase 13's training forms (``name[bf16 model train]``, kernels 13-17 and
21; ``model_train_record``): their times at the 1k batch's shapes (13a)
and as ``launches`` their launches in one bfloat16 training step (13b).
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_ATOMS = 4096
R_MAX = 4.0
LONG_R_MAX = 7.0  # phase 2's long segments: ~134 edges per atom
# phase 2's long segments on a smaller crystal: an atom's segment is as long
# (the same r_max and spacing), the kernels' tiles and chunks meet it as on
# the 4,096 atoms, in a quarter of the time (the run's time limit)
LONG_ATOMS = 1000
EMPTY_ATOM = 7  # phase 5a: the atom whose edges check_scatter_shapes removes
WIDE_ATOMS = 512  # phase 5a: the atoms whose edges unweight_sh's wide-U checks take
SHAPE_ROWS = 4  # phase 5a's shape checks: the edges of a quarter of the batch's atoms
SEED = 0
N_CALLS = 5
KERNEL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: longer than queueing 20 calls
# the plain versions are timed with fewer calls than the kernels (median_ms's
# reps, runs, warmup): one plain call takes up to 0.16 s at the flagship
# shapes (sparse_tp_gradw) and 0.3 s at the l_max-3 shapes (phase 7), and the
# plain version is the kernels' oracle, not a yardstick of speed
PLAIN_TIMING = dict(reps=5, runs=3, warmup=1)
PHASE7_PLAIN_TIMING = dict(reps=1, runs=3, warmup=1)
FLAGSHIP = dict(
    r_max=R_MAX,
    type_names=["A", "B", "C"],
    l_max=2,
    parity=True,
    num_layers=2,
    num_scalar_features=64,
    num_tensor_features=32,
    per_type_energy_scales=1.0,
    per_type_energy_shifts=0.0,
    model_dtype="float32",
)
SOURCES = {
    "latent_env_scatter": "allegro_tpu_torch/csrc/mega.cu",
    "latent_env_bwd": "allegro_tpu_torch/csrc/mega.cu",
    "gather_tp_embed": "allegro_tpu_torch/csrc/mega.cu",
    "bwd_embed": "allegro_tpu_torch/csrc/mega.cu",
    "env_scatter": "allegro_tpu_torch/csrc/train_tp.cu",
    "gather_tp": "allegro_tpu_torch/csrc/sparse_tp.cu",
    "bwd_fused": "allegro_tpu_torch/csrc/sparse_tp.cu",
    "bwd_fused[dw]": "allegro_tpu_torch/csrc/fused_tp.cu",
    "unweight_both": "allegro_tpu_torch/csrc/train_tp.cu",
    "center_gather": "allegro_tpu_torch/csrc/center_readout.cu",
    "center_sum": "allegro_tpu_torch/csrc/center_readout.cu",
    "readout_sum": "allegro_tpu_torch/csrc/center_readout.cu",
    "readout_bwd": "allegro_tpu_torch/csrc/center_readout.cu",
    "tp_scatter": "allegro_tpu_torch/csrc/sparse_tp.cu",
    "gather_dw": "allegro_tpu_torch/csrc/sparse_tp.cu",
    "unweight_sh": "allegro_tpu_torch/csrc/train_tp.cu",
    "unweight_w": "allegro_tpu_torch/csrc/train_tp.cu",
    "sparse_tp": "allegro_tpu_torch/csrc/sparse_tp.cu",
    "sparse_tp_gradw": "allegro_tpu_torch/csrc/sparse_tp.cu",
}
# the 21 TPU kernels (each function that reaches pl.pallas_call): number,
# the record of the port's kernel that replaces it (a wrapper, or
# ``wrapper[variant]``), and the TPU kernel's file:line. 13 and 19 are the
# same functions as 2 and 4 from one env array; 13 runs on the role-swapped
# table, 18 is bwd_fused with its weight gradient
TPU_KERNELS = [
    (1, "env_scatter", "allegro_tpu/ops/fused_tp.py:1091"),
    (2, "gather_tp", "allegro_tpu/ops/fused_tp.py:500"),
    (3, "bwd_fused", "allegro_tpu/ops/fused_tp.py:1340"),
    (4, "unweight_both", "allegro_tpu/ops/fused_tp.py:1455"),
    (5, "center_gather", "allegro_tpu/ops/fused_tp.py:1043"),
    (6, "center_sum", "allegro_tpu/ops/fused_tp.py:991"),
    (7, "latent_env_scatter", "allegro_tpu/ops/fused_tp.py:1701"),
    (8, "latent_env_bwd", "allegro_tpu/ops/fused_tp.py:1966"),
    (9, "gather_tp_embed", "allegro_tpu/ops/fused_tp.py:603"),
    (10, "bwd_embed", "allegro_tpu/ops/fused_tp.py:683"),
    (11, "readout_sum", "allegro_tpu/ops/fused_tp.py:1794"),
    (12, "readout_bwd", "allegro_tpu/ops/fused_tp.py:1873"),
    (13, "gather_tp[swapped]", "allegro_tpu/ops/fused_tp.py:451"),
    (14, "tp_scatter", "allegro_tpu/ops/fused_tp.py:835"),
    (15, "gather_dw", "allegro_tpu/ops/fused_tp.py:907"),
    (16, "unweight_sh", "allegro_tpu/ops/fused_tp.py:1159"),
    (17, "unweight_w", "allegro_tpu/ops/fused_tp.py:1588"),
    (18, "bwd_fused[dw]", "allegro_tpu/ops/fused_tp.py:1207"),
    (19, "unweight_both", "allegro_tpu/ops/fused_tp.py:1522"),
    (20, "sparse_tp", "allegro_tpu/ops/pallas_contract.py:84"),
    (21, "sparse_tp_gradw", "allegro_tpu/ops/pallas_contract.py:102"),
]
TRAIN_KERNELS = ("tp_scatter", "gather_dw", "unweight_sh", "unweight_w")
PALLAS_KERNELS = ("sparse_tp", "sparse_tp_gradw")
# launches per force call of the 2-layer flagship on fused_infer. All
# configurations: the two position gathers (center and neighbor side) and
# their transposes, the two force scatters. mega: the first projection and
# layer 0's latent are each one latent_env_scatter (and one latent_env_bwd);
# layer 0's TP is gather_tp_embed / bwd_embed, layer 1's gather_tp /
# bwd_fused; the fused readout and its backward once each. use_mega=False:
# each of the four layer kernels once per layer. The plain readout chain sums
# the per-edge energies with center_sum instead, and its backward gathers the
# per-atom cotangent back to the edges with center_gather: one more launch of
# each, none of the readout.
LAYER_KERNELS = ("env_scatter", "gather_tp", "bwd_fused", "unweight_both")
_NO_MEGA = {"latent_env_scatter": 0, "latent_env_bwd": 0, "gather_tp_embed": 0, "bwd_embed": 0}
_NO_TRAIN = {name: 0 for name in (*TRAIN_KERNELS, *PALLAS_KERNELS)}
PER_CALL = {
    "mega": {"latent_env_scatter": 2, "latent_env_bwd": 2, "gather_tp_embed": 1, "bwd_embed": 1,
             "env_scatter": 0, "gather_tp": 1, "bwd_fused": 1, "unweight_both": 0,
             "center_gather": 2, "center_sum": 2, "readout_sum": 1, "readout_bwd": 1,
             **_NO_TRAIN},
    "fused readout": {**_NO_MEGA, "env_scatter": 2, "gather_tp": 2, "bwd_fused": 2,
                      "unweight_both": 2, "center_gather": 2, "center_sum": 2, "readout_sum": 1,
                      "readout_bwd": 1, **_NO_TRAIN},
    "plain readout": {**_NO_MEGA, "env_scatter": 2, "gather_tp": 2, "bwd_fused": 2,
                      "unweight_both": 2, "center_gather": 3, "center_sum": 3, "readout_sum": 0,
                      "readout_bwd": 0, **_NO_TRAIN},
}
# launches per training step of the 2-layer flagship on `fused` (energy +
# force loss, its gradient in the parameters). Forward: per layer one
# env_scatter and one gather_tp; the two position gathers (center_gather);
# the edge-energy sum (center_sum). Force backward (create_graph): the
# energy sum's transpose (center_gather); per layer GatherTp's three
# transposes (gather_tp on the swapped table, tp_scatter, gather_dw; the
# forces never read that dw, but needs_input_grad is fixed at forward time)
# and EnvScatter's two (unweight_sh, unweight_w); the position gathers'
# transposes (2 center_sum). Parameter backward, per layer: GatherTp of the
# forward again (gather_tp, tp_scatter, gather_dw), the force backward's
# GatherTp on the swapped table (the same three on swapped tables) and its
# TpScatter (two gather_tp, one gather_dw); EnvScatter again (unweight_sh,
# unweight_w), the force backward's UnweightSh (env_scatter, unweight_w) and
# UnweightW (env_scatter, unweight_sh); the energy sum's transpose and the
# force backward's two center_sum, one center_gather each. Per step: 3 L
# env_scatter, 6 L gather_tp, 3 L tp_scatter, 4 L gather_dw (L of them
# unused), 3 L unweight_sh, 3 L unweight_w (L = 2 layers), 6 center_gather
# and 3 center_sum.
# The parameter tables read by class (here the two type embeddings) each
# take one center_gather forward and one center_sum in the parameter
# backward: 2 more of each.
PER_STEP = {**{name: 0 for name in PER_CALL["mega"]},
            "env_scatter": 6, "gather_tp": 12, "tp_scatter": 6, "gather_dw": 8,
            "unweight_sh": 6, "unweight_w": 6, "center_gather": 8, "center_sum": 5}


def per_call(config, L=2, zbl=False):
    """Launches per force call of an L-layer model in ``config``: PER_CALL's
    tables for L = 2, in general: ``mega``: L latent_env_scatter and
    latent_env_bwd (the first projection and every latent but the last), one
    gather_tp_embed / bwd_embed (layer 0), L - 1 gather_tp / bwd_fused;
    ``fused readout``: each of the four layer kernels once per layer;
    ``pallas``: per layer the forward sparse_tp and its two input transposes
    (a- and b-swapped tables), no sparse_tp_gradw (the parameters are frozen
    in the force call); the two position gathers and their transposes, the
    edge-energy sum and its transpose, and per layer the env sum (center_sum
    then center_gather) and its transpose; with ZBL (``zbl``) one more sum and
    its transpose. The kernel configurations also run the position gathers
    and their transposes (2 + 2) and the fused readout (1 + 1)."""
    counts = {name: 0 for name in PER_CALL["mega"]}
    if config == "pallas":
        counts.update(sparse_tp=3 * L, center_gather=3 + 2 * L + zbl,
                      center_sum=3 + 2 * L + zbl)
        return counts
    counts.update(center_gather=2, center_sum=2, readout_sum=1, readout_bwd=1)
    if config == "mega":
        counts.update(latent_env_scatter=L, latent_env_bwd=L, gather_tp_embed=1, bwd_embed=1,
                      gather_tp=L - 1, bwd_fused=L - 1)
    else:
        counts.update({name: L for name in LAYER_KERNELS})
    return counts


def per_call_routes(routes, L):
    """Launches per force call of an L-layer ``fused_infer`` model on its
    ``Model.routes``: the mega or the non-mega layer kernels (``per_call``),
    and the plain readout chain in place of the fused readout (one more
    center_sum and center_gather, no readout kernel)."""
    counts = per_call("mega" if routes["allegro"] == "mega" else "fused readout", L)
    if routes["edge_readout"] == "plain":
        counts.update(readout_sum=0, readout_bwd=0, center_gather=counts["center_gather"] + 1,
                      center_sum=counts["center_sum"] + 1)
    return counts


def per_step_pallas(L=2, zbl=False, lookups=2):
    """Launches per training step on ``pallas`` of an L-layer model. Per
    layer: the forward SparseTp (1); the force backward (create_graph) runs
    its three transposes, two sparse_tp and one sparse_tp_gradw
    (needs_input_grad is fixed at forward time: the loss never reads that
    weight gradient); the parameter backward runs the three transposes of the
    forward node and of the force backward's two SparseTp nodes (6 sparse_tp,
    3 sparse_tp_gradw; its SparseTpGradW node feeds nothing the loss reads and
    is not run): 9 L sparse_tp, 4 L sparse_tp_gradw. The center kernels: the
    forward's 3 + 2 L sums and gathers of ``per_call``, their transposes in the
    force backward, and in the parameter backward the transposes of every
    node on the way to a parameter: 6 + 4 L center_gather, 3 + 4 L
    center_sum (ZBL: one more of each); and one of each per parameter table
    read by class (``lookups``: the two type embeddings of the Bessel
    embed)."""
    counts = {name: 0 for name in PER_CALL["mega"]}
    counts.update(sparse_tp=9 * L, sparse_tp_gradw=4 * L,
                  center_gather=6 + 4 * L + zbl + lookups, center_sum=3 + 4 * L + zbl + lookups)
    return counts


# the pallas backend: the CSR statics route its env sums, position
# gathers and edge-energy sum through the center kernels, so two identical
# calls give the same bits
PER_CALL["pallas"] = per_call("pallas")
PER_STEP_PALLAS = per_step_pallas()
# phase 3w (ROADMAP F1): models wider than the fused kernels' shared memory.
# On a card whose blocks may opt into 227 KB the first and second keep no
# mega kernel (S = 128: latent_env_bwd's weights of the first projection
# alone take 282 KB) and the first also no fused readout (W0 [512, 128]:
# readout_bwd 308 KB, readout_sum 274 KB); the flagship keeps both
WIDE_MODELS = {
    "S128, 3 layers, readout 128": {**FLAGSHIP, "num_scalar_features": 128, "num_layers": 3,
                                    "readout_mlp_hidden_layers_width": 128},
    "S128, latent 128": {**FLAGSHIP, "num_scalar_features": 128,
                         "allegro_mlp_hidden_layers_width": 128},
    "S256, latent 256": {**FLAGSHIP, "num_scalar_features": 256,
                         "allegro_mlp_hidden_layers_width": 256},
}
WIDE_ROUTES = {
    "S128, 3 layers, readout 128": {"allegro": "fused_call", "edge_readout": "plain"},
    "S128, latent 128": {"allegro": "fused_call", "edge_readout": "fused"},
    "S256, latent 256": {"allegro": "fused_call", "edge_readout": "fused"},
}
FLAGSHIP_ROUTES = {"allegro": "mega", "edge_readout": "fused"}
H100_SMEM_OPTIN = 232448  # the opt-in the wide models' expected routes assume (227 KB)
# phase 7: the JAX bench's l_max-3 model (allegro_tpu/bench.py:run_lmax3_bench,
# BASELINE.json config 3) and the rest of the model surface, at full width
LMAX3 = {**FLAGSHIP, "l_max": 3}
# the parameter tables read by class beyond the type embeddings (phases 5c, 6c)
TABLE_MODEL = dict(
    radial_chemical_embed={"_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed"},
    per_type_energy_scales_trainable=True, per_type_energy_shifts_trainable=True)
SURFACE = {
    "parity=False, 3 layers": {**FLAGSHIP, "parity": False, "num_layers": 3},
    "l_max 3, 3 layers": {**LMAX3, "num_layers": 3},
    "shared env weights": {**FLAGSHIP, "weight_individual_irreps": False},
    "spline embed": {**FLAGSHIP, "radial_chemical_embed": {
        "_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed"}},
}
MD_BLOCKS = 10
MD_STEPS_PER_BLOCK = 10
MD = dict(masses=[1.0, 1.0, 1.0], r_max=R_MAX, dt=0.01, skin=0.2,
          steps_per_block=MD_STEPS_PER_BLOCK, edge_multiple=1024)
MD_KT = 0.01
# phase 4c: per-edge-type cutoffs in the style of JAX's MODEL_GRID row
# (tests/model/test_allegro_model.py): center type A at 3.5 A to every
# neighbor, B's row asymmetric (B-A at r_max, B-B 3.5, B-C 3.8), C at r_max;
# 3.5 A drops the crystal's third shell (3.81 A at spacing 2.2) for those pairs
PER_TYPE_CUTOFF = {"A": 3.5, "B": {"A": 4.0, "B": 3.5, "C": 3.8}}
PER_TYPE_MD_STEPS = 20
MD_TOL = 1e-4
CALC_JITTER = 0.01
CALC_SEED = 100
# the card's published peaks (H100 SXM data sheet): what bound_ms divides by
HBM_BYTES_PER_MS = 3.35e9
F32_FLOPS_PER_MS = 67e9
# phase 5: the JAX bench's training batches (allegro_tpu/bench.py:588-680)
TRAIN_SEEDS = (200, 201, 202, 203)
TRAIN_ATOMS = 1000
MOL_FRAMES, MOL_ATOMS, MOL_SPREAD = 16, 21, 3.0
TRAIN_STEPS = 10
TRAIN_REPEAT_STEPS = 3
GRAD_TOL = 1e-4
REPO = Path(__file__).resolve().parent
# phase 6d: the CLI as a user runs it (``python -m allegro_tpu_torch ...`` is
# runpy.run_module), then the launch counts of that process's run
CLI_DRIVER = """
import json, runpy, sys
from allegro_tpu_torch.ops import fused_tp
sys.argv = ["allegro_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("allegro_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (0, None):
        raise
print("LAUNCHES " + json.dumps(fused_tp.LAUNCHES))
"""
CLI_TIMEOUT = 400


def crystal_frame(n_atoms, r_max, seed):
    """The JAX bench's crystal (allegro_tpu/bench.py:_crystal_frame): a
    jittered simple-cubic lattice, spacing 2.2, three random types."""
    from allegro_tpu_torch.data import keys, neighbor_list

    rng = np.random.RandomState(seed)
    side = int(round(n_atoms ** (1 / 3)))
    n_atoms = side**3
    spacing = 2.2
    grid = (
        np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), axis=-1)
        .reshape(-1, 3)
        .astype(np.float64)
    )
    frame = {
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n_atoms, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n_atoms).astype(np.int32),
        keys.CELL: np.eye(3) * (side * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }
    return neighbor_list(frame, r_max), n_atoms


def median_ms(fn, reps=20, runs=5, warmup=3):
    """Device time of one call of ``fn``, in ms: ``reps`` calls queued behind
    a sleep kernel (so the device runs them back to back, without waiting
    for the host to launch them) between two CUDA events; the median of
    ``runs`` such batches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def launch_floor_ms(dev):
    """The device time of one launch of an empty kernel under
    :func:`median_ms` (``atpt_noop``, ``csrc/fused_tp.cu``): the floor under
    every kernel time of this run, which the bound leaves out."""
    from allegro_tpu_torch.ops import _build

    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return median_ms(lambda: _build.check(lib, lib.atpt_noop(stream), "noop"))


def rel_err(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    return err, err / scale


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(tps, data, rng, records=None, first=0, plain_timing=None):
    """Phase 2: each kernel against its plain version at the layers' shapes
    (``tps``: layers ``first``, ``first + 1``, ...); with ``records``, also the
    median times, accumulated there."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())  # the edges whose work the bounds count

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for layer, tp in enumerate(tps, first):
        U, d1, d2, d3 = tp.mul, tp.d1, tp.d2, tp.d3
        n_irr = int(tp.dim_to_irr.max().item()) + 1
        idx, coef, d2i = tp.entry_idx, tp.entry_coef.to(torch.float32), tp.dim_to_irr
        paths, swapped, scatter = tp.infer_paths()
        x, sh, wexp, g = rand(E, d1 * U), rand(E, d2), rand(E, n_irr * U), rand(E, d3 * U)
        w = rand(tp.num_paths, U, edge=False)
        env = fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U)
        t = rand(n_atoms, d2 * U, edge=False)
        n = idx.shape[0]
        walks = (*swapped, *scatter)
        # (kernel, plain version, inputs read, FLOPs): a CG entry costs 3 per
        # edge and channel (c*w formed once; x*env, then the multiply-add)
        cases = {
            "env_scatter": (
                lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U),),
                lambda: (fused_tp.env_scatter_reference(sh, wexp, centers, n_atoms, d2i, U),),
                (sh, wexp, row_ptr, d2i), 2 * Er * d2 * U,
            ),
            "gather_tp": (
                lambda: (fused_tp.gather_tp(x, env, w, centers, idx, coef, d3, paths=paths),),
                lambda: (fused_tp.gather_tp_reference(x, env, w, centers, idx, coef, d3),),
                (x, env, w, centers, *paths), 3 * Er * n * U,
            ),
            "bwd_fused": (
                lambda: fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef,
                                           paths=swapped, scatter_paths=scatter),
                lambda: fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, idx, coef),
                (x, g, env, w, row_ptr, *walks), 6 * Er * n * U,
            ),
            "unweight_both": (
                lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
                lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
                (t, sh, wexp, centers, d2i), 4 * Er * d2 * U,
            ),
        }
        if records is not None:
            # the same function from the trainable backend's two row
            # kernels, one launch each, at every layer unweight_both runs
            cases["unweight_both[pair]"] = (
                lambda: (fused_tp.unweight_sh(t, wexp, centers, d2i),
                         fused_tp.unweight_w(t, sh, centers, d2i, n_irr)),
                cases["unweight_both"][1], (t, sh, wexp, centers, d2i), 4 * Er * d2 * U,
            )
        if records is not None and layer == first:
            # the same function from the trainable backend's two walks, one
            # launch each: gather_tp on the role swap (dx), tp_scatter (denv)
            cases["bwd_fused[pair]"] = (
                lambda: (fused_tp.gather_tp(g, env, w, centers, tp.entry_swapped, coef, d1,
                                            paths=swapped),
                         fused_tp.tp_scatter(x, g, w, centers, row_ptr, idx, coef, d2, scatter)),
                cases["bwd_fused"][1], (x, g, env, w, centers, row_ptr, *walks), 6 * Er * n * U,
            )
        for name, (kernel, plain, reads, flops) in cases.items():
            label = f"U {U} layer {layer} dims ({d1},{d2},{d3}) entries {n:3d}"
            check_case(name, kernel, plain, label, records, reads, flops, plain_timing=plain_timing)


def check_case(name, kernel, plain, label, records=None, reads=(), flops=0, library=None,
               plain_timing=None, exact=None):
    """One kernel call against its plain version (max|err| / max|ref| <
    KERNEL_TOL); with ``records``, also their median times, accumulated
    there under ``name`` (a kernel name, or ``kernel[variant]``), with the
    work the bound counts: the bytes of ``reads`` (each input read once) and
    of the outputs (each written once), and ``flops``. ``library``: one
    PyTorch call computing the same function, timed beside them.
    ``plain_timing``: median_ms's keyword arguments for the plain version
    (the caller's choice; default ``PLAIN_TIMING``). ``exact``: the plain
    version in float64, which the kernel is then held to (``plain`` is only
    timed)."""
    got = kernel()
    ref = (exact or plain)()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ok = rel < KERNEL_TOL
    print(f"  {label} {name:18s} max_abs_err {abs_err:.3e} rel {rel:.3e} (< {KERNEL_TOL}) "
          f"{'ok' if ok else 'FAIL'}", end="")
    if not ok:
        print()
        raise AssertionError(f"{name} ({label}) disagrees with its plain version")
    if records is None:
        print()
        return
    ms = median_ms(kernel)
    plain_ms = median_ms(plain, **(plain_timing or PLAIN_TIMING))
    work = nbytes(*reads, *got)
    bound_ms, bound_by = bound(work, flops)
    print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
          end="")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                    "bytes": 0, "flops": 0, "library_ms": None})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["bytes"] += work
    rec["flops"] += flops
    if library is not None:
        lib_ms = median_ms(library)
        rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
        print(f"  library {lib_ms:.4f} ms", end="")
    print()


def bound(n_bytes, flops):
    """The least time (ms) of the work on the card and what binds it: the
    bytes at the memory rate or the FLOPs at the f32 rate, the larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_mega_kernels(allegro, data, rng, records=None, plain_timing=None):
    """Phase 2: the mega kernels and the split / gts variants of kernels 2
    and 3 against their plain versions, on the mega model's weights at the
    force call's shapes; with ``records``, also the median times, summed
    over the launches of one force call (the variants under their own
    keys). Pieces and g_lat have nonzero rows on the sentinel edges too."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())
    S, U = allegro.S, allegro.U
    tp = allegro.tps[0]
    d2i, specs = tp.dim_to_irr, allegro.row_specs
    n_irr = int(max(allegro.env_weighter.dim_to_irr)) + 1

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    sh, emb, ts = rand(E, tp.d2), rand(E, S), rand(E, U)
    t, g_lat = rand(n_atoms, tp.d2 * U), rand(E, S)
    (w_proj,) = allegro.first_projection.weights()
    w0, w1 = allegro.latents[0].weights()
    label = f"U {U} E {E}"
    for pieces, a, b in (((emb,), w_proj.detach(), None),
                         ((emb, ts), w0.detach(), w1.detach())):
        what = f"{label} W0 {list(a.shape)}" + ("" if b is None else f" W1 {list(b.shape)}")
        # the MLP runs on every edge (sentinels too), the env work on real ones
        mlp = a.shape[0] * a.shape[1] + (0 if b is None else b.shape[0] * b.shape[1])
        env_flops = 2 * Er * tp.d2 * U
        check_case("latent_env_scatter",
                   lambda: fused_tp.latent_env_scatter(pieces, sh, a, b, centers, row_ptr, d2i, U,
                                                       S, tp.irr_ranges),
                   lambda: fused_tp.latent_env_scatter_reference(pieces, sh, a, b, row_ptr, d2i,
                                                                 U, S), what, records,
                   (*pieces, sh, a, b, centers, row_ptr, tp.irr_ranges), 2 * E * mlp + env_flops,
                   plain_timing=plain_timing)
        check_case("latent_env_bwd",
                   lambda: _flat(fused_tp.latent_env_bwd(pieces, sh, a, b, t, g_lat, centers,
                                                         d2i, U, S, tp.irr_ranges)),
                   lambda: _flat(fused_tp.latent_env_bwd_reference(pieces, sh, a, b, t, g_lat,
                                                                   centers, d2i, U, S)),
                   what, records, (*pieces, sh, a, b, t, g_lat, centers, d2i),
                   4 * E * mlp + 2 * env_flops, plain_timing=plain_timing)
    wk, idx, coef = (v.detach() for v in tp.fused_infer_parts(torch.float32))
    d1, d2, d3 = tp.d1, tp.d2, tp.d3
    w2b, env = rand(E, n_irr * U), rand(n_atoms, d2 * U)
    x, g, gts = rand(E, d1 * U), rand(E, d3 * U), rand(E, U)
    what = f"{label} dims ({d1},{d2},{d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    paths = tp.cg_paths()
    check_case("gather_tp_embed",
               lambda: fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, row_ptr, idx, coef,
                                                specs, d3, True, paths),
               lambda: fused_tp.gather_tp_embed_reference(sh, w2b, env, wk, centers, idx, coef,
                                                          specs, d3, True), what, records,
               (sh, w2b, env, wk, row_ptr, *paths, specs), tp_flops + Er * d1 * U,
               plain_timing=plain_timing)
    check_case("bwd_embed",
               lambda: fused_tp.bwd_embed(sh, w2b, g, env, wk, centers, row_ptr, idx, coef,
                                          specs, gts, paths),
               lambda: fused_tp.bwd_embed_reference(sh, w2b, g, env, wk, centers, n_atoms, idx,
                                                    coef, specs, gts), what, records,
               (sh, w2b, g, gts, env, wk, row_ptr, idx, coef, specs),
               2 * tp_flops + 4 * Er * d1 * U, plain_timing=plain_timing)
    walk = tp.gather_paths()[0]
    check_case("gather_tp[split]",
               lambda: fused_tp.gather_tp(x, env, wk, centers, idx, coef, d3, True, walk),
               lambda: fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, d3, True),
               what, records, (x, env, wk, centers, *walk), tp_flops, plain_timing=plain_timing)
    if records is None:  # the checks at other widths and at r_max 7.0: without ts too
        check_case("gather_tp",
                   lambda: (fused_tp.gather_tp(x, env, wk, centers, idx, coef, d3, paths=walk),),
                   lambda: (fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, d3),),
                   what)
    _, swapped, scatter = tp.infer_paths()
    check_case("bwd_fused[gts]",
               lambda: fused_tp.bwd_fused(x, g, env, wk, centers, row_ptr, idx, coef, gts,
                                          paths=swapped, scatter_paths=scatter),
               lambda: fused_tp.bwd_fused_reference(x, g, env, wk, centers, n_atoms, idx, coef,
                                                    gts), what, records,
               (x, g, gts, env, wk, row_ptr, *swapped, *scatter), 2 * tp_flops + Er * U,
               plain_timing=plain_timing)


def check_embed_beyond_the_header(data, rng):
    """Phase 2: ``gather_tp_embed``, ``bwd_embed`` and ``gather_tp`` on a
    layer whose paths the compiled CG header does not hold (l = 4: the
    kernels' per-entry default case), U = 32, on the crystal's edges, against
    their plain versions (with and without the split output / gts;
    ``gather_tp``'s x nonzero on the sentinel edges too, which it must not
    read)."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.nn.contract import Contracter
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms, E, U = row_ptr.shape[0] - 1, centers.shape[0], 32
    irreps = "1x0e+1x2e+1x4e"
    tp = Contracter(irreps, irreps, irreps, U, kernel_backend="fused_infer").to(dev)
    paths = tp.cg_paths()
    beyond = int((paths.desc[:, 1] < 0).sum())
    assert beyond > 0, "the l = 4 layer has no path beyond the header"
    idx, coef = tp.entry_idx, tp.entry_coef.to(torch.float32)
    specs = torch.tensor([(j, int(r)) for j, r in enumerate(tp.dim_to_irr.tolist())],
                         dtype=torch.int32, device=dev)

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    wk = rand(tp.num_paths, U)

    sh, w2b, env = rand(E, tp.d2), rand(E, tp.n_irr * U), rand(n_atoms, tp.d2 * U)
    g, gts = rand(E, tp.d3 * U), rand(E, U)
    label = (f"U {U} l_max 4 dims ({tp.d1},{tp.d2},{tp.d3}) entries {idx.shape[0]}, "
             f"{beyond} of {paths.desc.shape[0]} paths beyond the header")
    for split in (False, True):
        check_case("gather_tp_embed",
                   lambda: _flat_out(fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, row_ptr,
                                                              idx, coef, specs, tp.d3, split,
                                                              paths)),
                   lambda: _flat_out(fused_tp.gather_tp_embed_reference(
                       sh, w2b, env, wk, centers, idx, coef, specs, tp.d3, split)),
                   label + (" split" if split else ""))
    for opt in (None, gts):
        check_case("bwd_embed",
                   lambda: fused_tp.bwd_embed(sh, w2b, g, env, wk, centers, row_ptr, idx, coef,
                                              specs, opt, paths),
                   lambda: fused_tp.bwd_embed_reference(sh, w2b, g, env, wk, centers, n_atoms,
                                                        idx, coef, specs, opt),
                   label + ("" if opt is None else " gts"))
    walk = tp.gather_paths()[0]
    x = rand(E, tp.d1 * U)
    label = (f"U {U} l_max 4 dims ({tp.d1},{tp.d2},{tp.d3}) entries {idx.shape[0]}, "
             f"{int((walk.desc[:, 1] < 0).sum())} of {walk.desc.shape[0]} walk rows beyond the "
             f"header")
    for split in (False, True):
        check_case("gather_tp",
                   lambda: _flat_out(fused_tp.gather_tp(x, env, wk, centers, idx, coef, tp.d3,
                                                        split, walk)),
                   lambda: _flat_out(fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef,
                                                                  tp.d3, split)),
                   label + (" split" if split else ""))


def _flat(res):
    """(dsh, (dp_0, dp_1, ...)) → (dsh, dp_0, dp_1, ...)."""
    return (res[0], *res[1])


def _flat_out(res):
    """A kernel's output, or its outputs, as a tuple."""
    return res if isinstance(res, tuple) else (res,)


def check_long_segments(model, rng, dev):
    """Phase 2: the mega kernels (checks only) on the crystal of LONG_ATOMS
    atoms at r_max LONG_R_MAX, where an atom has ~134 edges: its segment spans three of
    ``latent_env_scatter``'s 64-edge tiles; ``env_scatter``, ``tp_scatter``
    (both orders), ``unweight_sh``, ``bwd_fused`` (with and without ``gts``)
    and ``unweight_w`` at the flagship's layer-0 dims there, where each of
    ``tp_scatter``'s and ``bwd_fused``'s chunks walks ~34 edges of a segment
    and an ``env_scatter`` block's 2 atoms take 5 of its 64-edge chunks; and
    ``readout_sum`` on the flagship's readout pieces, whose 128-edge tiles
    each hold about one atom's segment."""
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.nn.contract import Contracter
    from allegro_tpu_torch.ops import fused_tp

    frame, n_atoms = crystal_frame(LONG_ATOMS, LONG_R_MAX, SEED)
    data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                    dtype=torch.float32, device=dev)
    degree = torch.diff(data[keys.CENTER_ROW_PTR][: n_atoms + 1])
    print(f"  r_max {LONG_R_MAX}: {int(data[keys.EDGE_MASK].sum())} edges, "
          f"{degree.float().mean().item():.1f} per atom (at most {int(degree.max())})")
    check_mega_kernels(model.module.allegro, data, rng)
    l2 = "1x0e+1x1o+1x2e"
    tps = [Contracter(l2, l2, l2, model.module.allegro.U, kernel_backend="fused").to(dev)]
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    check_scatter_kernels(tps, centers, data[keys.CENTER_ROW_PTR], rng, f"r_max {LONG_R_MAX}")
    check_bwd_kernels(tps, centers, data[keys.CENTER_ROW_PTR], rng, f"r_max {LONG_R_MAX}")
    E, S = centers.shape[0], FLAGSHIP["num_scalar_features"]
    pieces = [torch.as_tensor(rng.randn(E, S + 96).astype(np.float32), device=dev)[:, :S]
              for _ in range(3)]
    w0 = torch.as_tensor(rng.randn(3 * S, 32).astype(np.float32), device=dev) / (3 * S)**0.5
    w1 = torch.as_tensor(rng.randn(32, 1).astype(np.float32), device=dev) / 32**0.5
    row_ptr = data[keys.CENTER_ROW_PTR]
    check_case("readout_sum", lambda: (fused_tp.readout_sum(pieces, w0, w1, row_ptr),),
               lambda: (fused_tp.readout_sum_reference(pieces, w0, w1, row_ptr),),
               f"r_max {LONG_R_MAX} pieces 3 x [{E}, {S}] W0 [{3 * S}, 32]")


def center_cases(data, rng):
    """The center gather's and sum's cases at every width and side a user
    path runs them, on ``data``'s edges: (record key, case, label, kernel,
    plain, reads, FLOPs, library, exact). The record key is the kernel's
    name at the flagship force call's widths (the C = 3 position gathers and
    force scatters, both sides, summed), else ``name[variant]``: the [·, 1]
    energy column of the plain readout chain (``C1``), the ``pallas``
    backend's env sum at the flagship (``C288``: d2 U = 9 x 32) and at the
    l_max-3 layer 0 (``C256``: 16 x 16), and a parameter table's class CSR
    (``chunked1024``: the crystal's 9 edge classes on rows of 64 x 16 spline
    weights; ``chunked32``: 3 center types on a 32-wide type embedding, and
    ``class32``, that table's read). ``library``: the one PyTorch call that
    computes the same function (``index_select`` on the table with a zero
    row for the sentinel, ``index_add_``), timed beside it; the port never
    calls it. ``exact``: the plain version in float64 where the kernel is
    held to it (the chunked sums: each row sums ~10^4-10^5 edges, so the
    kernel is held to the exact sum, not to another float32 order of it)."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    ei = data[keys.EDGE_INDEX].to(torch.int32)
    centers, neighbors = ei[0].contiguous(), ei[1].contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    nbr = (data[keys.NBR_ROW_PTR], data[keys.NBR_PERM])
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    n_types = len(FLAGSHIP["type_names"])
    perm, rp = fused_tp.neighbor_csr(data[keys.EDGE_TYPE].cpu().numpy(), n_types**2)
    edge_class = (data[keys.EDGE_TYPE], torch.as_tensor(rp, device=dev),
                  torch.as_tensor(perm, device=dev))
    center_type = tuple(data[k] for k in keys.class_csr_keys(keys.CENTER_TYPE_LOOKUP))
    sides = {"center": (centers, row_ptr, None), "neighbor": (neighbors, *nbr)}
    # (key, case, width, side or class CSR, sum only)
    plan = [(None, "C3_center", 3, sides["center"], False),
            (None, "C3_neighbor", 3, sides["neighbor"], False),
            ("C1", "C1_center", 1, sides["center"], False),
            ("C288", "C288_center", 288, sides["center"], False),
            ("C256", "C256_center", 256, sides["center"], False),
            ("chunked1024", "chunked1024", 64 * 16, edge_class, True),
            ("chunked32", "chunked32", 32, center_type, True)]
    cases = []

    def add(tag, case, width, idx, rp, perm, chunked):
        n_rows = rp.shape[0] - 1
        a = (data[keys.POSITIONS].contiguous() if width == 3
             else rand(n_rows, width, edge=False))
        v = rand(E, width)
        a_pad = torch.cat([a, a.new_zeros((1, width))])  # the sentinel's zero row
        idx_l = idx.long()
        acc = a.new_zeros((n_rows + 1, width))
        side = "chunked (class CSR)" if chunked else case.split("_")[-1]
        label = f"[{n_rows}, {width}] <-> [{E}, {width}] {side:8s}"
        gather_case = (lambda: (fused_tp.center_gather(a, idx),),
                       lambda: (fused_tp.center_gather_reference(a, idx),), (a, idx), 0,
                       lambda: a_pad.index_select(0, idx_l), None)
        sum_case = (lambda: (fused_tp.center_sum(v, rp, perm, chunked),),
                    lambda: (fused_tp.center_sum_reference(v, rp, perm),), (v, rp, perm),
                    Er * width, lambda: acc.index_add_(0, idx_l, v),
                    (lambda: (fused_tp.center_sum_reference(v.double(), rp, perm),))
                    if chunked else None)
        if chunked:  # a table's read (a gather by class), then its gradient
            if width == 32:
                cases.append(("center_gather[class32]", "class32", label, *gather_case))
            cases.append((f"center_sum[{tag}]", case, label, *sum_case))
            return
        cases.append(("center_gather" + (f"[{tag}]" if tag else ""), case, label, *gather_case))
        cases.append(("center_sum" + (f"[{tag}]" if tag else ""), case, label, *sum_case))

    for tag, case, width, csr, chunked in plan:
        add(tag, case, width, *csr, chunked)
    return cases


def check_center_scalar_forms(data, rng):
    """Phase 2: the center gather's and sum's scalar builds, which no shape
    of a user path reaches today (C > 4 and no multiple of 4, or a base that
    is not 16-byte aligned), against their plain versions, untimed: C = 18
    on the center side, the neighbor side and the crystal's edge classes
    (the chunked sum, against float64), and C = 288 on the center side from
    bases 4 bytes past alignment."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    ei = data[keys.EDGE_INDEX].to(torch.int32)
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = ei.shape[1]
    n_types = len(FLAGSHIP["type_names"])
    perm, rp = fused_tp.neighbor_csr(data[keys.EDGE_TYPE].cpu().numpy(), n_types**2)
    csrs = {"center": (ei[0].contiguous(), data[keys.CENTER_ROW_PTR], None),
            "neighbor": (ei[1].contiguous(), data[keys.NBR_ROW_PTR], data[keys.NBR_PERM]),
            "chunked": (data[keys.EDGE_TYPE], torch.as_tensor(rp, device=dev),
                        torch.as_tensor(perm, device=dev))}

    def rand(n, width, offset):
        """[n, width], contiguous, its base ``offset`` floats into its buffer."""
        flat = torch.as_tensor(rng.randn(offset + n * width).astype(np.float32), device=dev)
        return flat[offset:].view(n, width)

    for side, width, offset in (("center", 18, 0), ("neighbor", 18, 0), ("chunked", 18, 0),
                                ("center", 288, 1)):
        idx, rp, perm = csrs[side]
        chunked = side == "chunked"
        a, v = rand(rp.shape[0] - 1, width, offset), rand(E, width, offset)
        v.mul_(real)
        label = f"[{a.shape[0]}, {width}] <-> [{E}, {width}] {side:8s} base +{4 * offset} B"
        check_case("center_gather[scalar]", lambda: (fused_tp.center_gather(a, idx),),
                   lambda: (fused_tp.center_gather_reference(a, idx),), label)
        check_case("center_sum[scalar]", lambda: (fused_tp.center_sum(v, rp, perm, chunked),),
                   lambda: (fused_tp.center_sum_reference(v, rp, perm),), label,
                   exact=(lambda: (fused_tp.center_sum_reference(v.double(), rp, perm),))
                   if chunked else None)


def check_center_readout(data, rng, records):
    """Phase 2, second part: the center gather and sum at every width and
    side a user path runs them (:func:`center_cases`; the kernels line's
    rows 5 and 6 sum the C = 3 launches of one force call, the other widths
    are variants), and the fused readout at the force call's shapes."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for key, _, label, kernel, plain, reads, flops, library, exact in center_cases(data, rng):
        check_case(key, kernel, plain, label, records, reads, flops, library, exact=exact)
    check_center_scalar_forms(data, np.random.RandomState(SEED + 1))
    S, H = FLAGSHIP["num_scalar_features"], 32
    K = S * (FLAGSHIP["num_layers"] + 1)
    # the scalar track's pieces are column slices of the layers' MLP outputs
    wide = [rand(E, S + 96), rand(E, S + 96), rand(E, S)]
    pieces = [w[:, :S] for w in wide]
    w0 = rand(K, H, edge=False) / K**0.5
    w1 = rand(H, 1, edge=False) / H**0.5
    y = rand(n_atoms, 1, edge=False)
    label = f"pieces 3 x [{E}, {S}] W0 [{K}, {H}]"
    check_case("readout_sum",
               lambda: (fused_tp.readout_sum(pieces, w0, w1, row_ptr),),
               lambda: (fused_tp.readout_sum_reference(pieces, w0, w1, row_ptr),),
               label, records, (*pieces, w0, w1, row_ptr), 2 * Er * (K * H + H))
    check_case("readout_bwd",
               lambda: fused_tp.readout_bwd(pieces, w0, w1, y, centers),
               lambda: fused_tp.readout_bwd_reference(pieces, w0, w1, y, centers),
               label, records, (*pieces, w0, w1, y, centers), 2 * Er * (2 * K * H + H))


def check_train_kernels(tps, data, rng, records=None, first=0, plain_timing=None):
    """Phase 5a: the trainable backend's transposes against their plain
    versions at the training batch's shapes, each layer's table in both role
    orders (the swapped one under ``kernel[swapped]``), and ``gather_tp`` on
    the swapped table (the layer's own order, timed in phase 2, checked
    here too); with ``records``, also the median times (one launch per layer
    and order, summed). ``gather_tp`` and ``gather_dw`` walk the order's
    path table (``Contracter.gather_paths``, carried by ``FusedStatics``),
    ``tp_scatter`` that order's with its roles permuted (0, 2, 1)
    (:func:`scatter_paths`).
    Each entry of ``gather_dw`` sums ~10^5 edges, so it is held to the plain
    version in float64 (from the float64 entries), as ``sparse_tp_gradw``
    is; the float32 plain version is timed. Per-edge inputs are zero on
    sentinel edges, per-atom ones (env, t) are not."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp
    from allegro_tpu_torch.ops.fused_primitives import FusedStatics

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for layer, tp in enumerate(tps, first):
        U = tp.mul
        _, idx, coef = (v.detach() for v in tp.fused_infer_parts(torch.float32))
        d2i = tp.dim_to_irr
        st = FusedStatics(centers, row_ptr, d2i, tp.n_irr, U, idx, tp.entry_swapped, coef,
                          tp.num_paths, (tp.d1, tp.d2, tp.d3), *tp.gather_paths(),
                          *scatter_paths(tp))
        n = idx.shape[0]
        t, sh, wexp = rand(n_atoms, tp.d2 * U, edge=False), rand(E, tp.d2), rand(E, tp.n_irr * U)
        label = f"U {U} layer {layer} dims {st.dims} entries {n:3d}"
        check_case("unweight_sh", lambda: (fused_tp.unweight_sh(t, wexp, centers, d2i),),
                   lambda: (fused_tp.unweight_sh_reference(t, wexp, centers, d2i),), label,
                   records, (t, wexp, centers, d2i), 2 * Er * tp.d2 * U, plain_timing=plain_timing)
        check_case("unweight_w", lambda: (fused_tp.unweight_w(t, sh, centers, d2i, tp.n_irr),),
                   lambda: (fused_tp.unweight_w_reference(t, sh, centers, d2i, tp.n_irr),),
                   label, records, (t, sh, centers, d2i), 2 * Er * tp.d2 * U,
                   plain_timing=plain_timing)
        for tag, s in (("", st), ("[swapped]", st.swap())):
            d1, d2, d3 = s.dims
            x, g = rand(E, d1 * U), rand(E, d3 * U)
            env, w = rand(n_atoms, d2 * U, edge=False), rand(s.n_paths, U, edge=False)
            tab = (s.entry_idx, coef)
            label = f"U {U} layer {layer} dims {s.dims} entries {n:3d}"
            check_case("tp_scatter" + tag,
                       lambda: (fused_tp.tp_scatter(x, g, w, centers, row_ptr, *tab, d2,
                                                    s.scatter_paths),),
                       lambda: (fused_tp.tp_scatter_reference(x, g, w, centers, n_atoms, *tab,
                                                              d2),),
                       label, records, (x, g, w, row_ptr, *s.scatter_paths), 3 * Er * n * U,
                       plain_timing=plain_timing)
            # a CG entry's dw term: x*env, *g, then the multiply-add with c
            exact = fused_tp.gather_dw_reference(x.double(), env.double(), g.double(), centers,
                                                 s.entry_idx, tp.entry_coef, s.n_paths, U)
            check_case("gather_dw" + tag,
                       lambda: (fused_tp.gather_dw(x, env, g, centers, *tab, s.n_paths, U,
                                                   s.paths),),
                       lambda: (fused_tp.gather_dw_reference(x, env, g, centers, *tab,
                                                             s.n_paths, U),),
                       label + " (vs float64)", records, (x, env, g, centers, *s.paths),
                       4 * Er * n * U, plain_timing=plain_timing, exact=lambda: (exact,))
            check_case("gather_tp" + tag,
                       lambda: (fused_tp.gather_tp(x, env, w, centers, *tab, d3, paths=s.paths),),
                       lambda: (fused_tp.gather_tp_reference(x, env, w, centers, *tab, d3),),
                       label, records if tag else None, (x, env, w, centers, *s.paths),
                       3 * Er * n * U, plain_timing=plain_timing)


def check_gather_shapes(data, rng):
    """Phase 5a, checks only, on :func:`_shape_centers` less one edge where
    their count is even (an odd count: a whole number of no block's edges):
    ``gather_tp`` (the
    layer's order with and without its split output, and the role swap) and
    ``gather_dw`` (both orders, held to the plain version in float64) on the
    flagship's two layer shapes at U = 16 and 48 and on an l = 4 layer at
    U = 32 (dims 25: walk rows beyond the compiled CG header, walked entry by
    entry). x and g are nonzero on the sentinel edges too, which neither
    kernel may read. Then a call on the card without its path table must
    raise: there is no fallback to an entry walk or the plain version."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.nn.contract import Contracter
    from allegro_tpu_torch.ops import fused_tp, gen_cg_blocks

    dev = data[keys.POSITIONS].device
    centers = _shape_centers(data)
    centers = (centers[:-1] if centers.shape[0] % 2 == 0 else centers).contiguous()
    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    E = centers.shape[0]

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    l2 = "1x0e+1x1o+1x2e"
    l4 = "+".join(f"1x{l}{'e' if l % 2 == 0 else 'o'}" for l in range(5))
    layers = [Contracter(*irreps, mul, kernel_backend="fused")
              for mul in (16, 48) for irreps in ((l2,) * 3, (l2, l2, "1x0e"))]
    layers.append(Contracter(l4, l4, l4, 32, kernel_backend="fused"))
    for tp in layers:
        tp = tp.to(dev)
        U, P = tp.mul, tp.num_paths
        coef = tp.entry_coef.to(torch.float32)
        walk, walk_swapped = tp.gather_paths()
        for order, idx, paths, (d1, d2, d3) in (
                ("own", tp.entry_idx, walk, (tp.d1, tp.d2, tp.d3)),
                ("swapped", tp.entry_swapped, walk_swapped, (tp.d3, tp.d2, tp.d1))):
            x, g = rand(E, d1 * U), rand(E, d3 * U)
            env, w = rand(n_atoms, d2 * U), rand(P, U)
            beyond = int((paths.desc[:, 1] == gen_cg_blocks.DEFAULT).sum())
            label = (f"U {U} E {E} {order:7s} dims ({d1},{d2},{d3}) entries {idx.shape[0]:4d} "
                     f"rows {paths.desc.shape[0]} ({beyond} beyond the header)")
            for split in (False, True) if order == "own" else (False,):
                check_case("gather_tp",
                           lambda: _flat_out(fused_tp.gather_tp(x, env, w, centers, idx, coef, d3,
                                                                split, paths)),
                           lambda: _flat_out(fused_tp.gather_tp_reference(x, env, w, centers,
                                                                          idx, coef, d3, split)),
                           label + (" split" if split else ""))
            exact = fused_tp.gather_dw_reference(x.double(), env.double(), g.double(), centers,
                                                 idx, tp.entry_coef, P, U)
            check_case("gather_dw",
                       lambda: (fused_tp.gather_dw(x, env, g, centers, idx, coef, P, U, paths),),
                       lambda: (exact,), label + " (vs float64)")
            del exact
    for name, call in (
            ("gather_tp", lambda: fused_tp.gather_tp(x, env, w, centers, idx, coef, d3)),
            ("gather_dw", lambda: fused_tp.gather_dw(x, env, g, centers, idx, coef, P, U))):
        try:
            call()
        except ValueError as e:
            print(f"    {name} on the card without a path table raises: {e}")
        else:
            raise AssertionError(f"{name} ran on the card without its path table")


def scatter_paths(tp):
    """``tp_scatter``'s path tables for layer ``tp``: its entry order's and its
    role swap's, each with its roles permuted (0, 2, 1) so that the walk's out
    is j. A ``fused`` layer's own (``Contracter.scatter_paths``); for a layer
    of another backend, which never runs ``tp_scatter``, built by the
    function ``Contracter`` builds them with (``contract.walk_tables``)."""
    from allegro_tpu_torch.nn import contract
    from allegro_tpu_torch.ops import fused_tp

    if hasattr(tp, "scatter_desc"):
        return tp.scatter_paths()
    return tuple(paths.to(tp.entry_idx.device) for paths in contract.walk_tables(
        tp.entry_idx, tp.entry_swapped, tp.entry_coef, fused_tp.SCATTER_ROLES))


def check_scatter_kernels(tps, centers, row_ptr, rng, label):
    """Checks only: ``env_scatter`` (held to the plain version in float64),
    ``unweight_sh`` and ``tp_scatter`` (each layer's table in both role
    orders, walking :func:`scatter_paths`; held to the plain version in
    float64) on the edges ``centers`` with the CSR ``row_ptr``, with x, g, sh
    and wexp nonzero on the sentinel edges, which no kernel may read."""
    from allegro_tpu_torch.ops import fused_tp

    dev = centers.device
    n_atoms, E = row_ptr.shape[0] - 1, centers.shape[0]

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    for tp in tps:
        U, P = tp.mul, tp.num_paths
        coef = tp.entry_coef.to(torch.float32)
        t, wexp = rand(n_atoms, tp.d2 * U), rand(E, tp.n_irr * U)
        what = f"{label} U {U} dims ({tp.d1},{tp.d2},{tp.d3}) entries {tp.entry_idx.shape[0]:4d}"
        check_env_scatter(rand(E, tp.d2), wexp, centers, row_ptr, tp.dim_to_irr, U, what)
        check_case("unweight_sh",
                   lambda: (fused_tp.unweight_sh(t, wexp, centers, tp.dim_to_irr),),
                   lambda: (fused_tp.unweight_sh_reference(t, wexp, centers, tp.dim_to_irr),),
                   what)
        for order, idx, paths, (d1, d2, d3) in zip(
                ("own", "swapped"), (tp.entry_idx, tp.entry_swapped), scatter_paths(tp),
                ((tp.d1, tp.d2, tp.d3), (tp.d3, tp.d2, tp.d1))):
            x, g, w = rand(E, d1 * U), rand(E, d3 * U), rand(P, U)
            exact = fused_tp.tp_scatter_reference(x.double(), g.double(), w.double(), centers,
                                                  n_atoms, idx, tp.entry_coef, d2)
            beyond = int((paths.desc[:, 1] < 0).sum())
            check_case("tp_scatter",
                       lambda: (fused_tp.tp_scatter(x, g, w, centers, row_ptr, idx, coef, d2,
                                                    paths),),
                       lambda: (exact,),
                       f"{what} {order:7s} rows {paths.desc.shape[0]} ({beyond} beyond the "
                       f"header) (vs float64)")
            del exact


def check_env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U, label):
    """Checks only: ``env_scatter`` against its plain version in float64 (a
    segment sums up to ~137 edges)."""
    from allegro_tpu_torch.ops import fused_tp

    n_atoms = row_ptr.shape[0] - 1
    exact = fused_tp.env_scatter_reference(sh.double(), wexp.double(), centers, n_atoms,
                                           dim_to_irr, U)
    check_case("env_scatter",
               lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U),),
               lambda: (exact,), f"{label} (vs float64)")


def _shape_centers(data):
    """Phase 5a's rows: the training batch's edges whose center is among the
    first 1/SHAPE_ROWS of its atoms, and every sentinel edge (the rows the
    kernels must not read), still sorted by center. The walks and tiles do
    not depend on the row count."""
    from allegro_tpu_torch.data import keys

    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    centers = data[keys.EDGE_INDEX][0].to(torch.int32)
    return centers[(centers < n_atoms // SHAPE_ROWS) | (centers >= n_atoms)]


def _odd_edges(data):
    """Phase 5a's edge set: :func:`_shape_centers` less the edges of atom
    ``EMPTY_ATOM`` (a segment without edges) and less the last one or two (an
    odd count: a whole number of no tile's or chunk's edges), with its CSR."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    centers = _shape_centers(data)
    centers = centers[centers != EMPTY_ATOM]
    centers = centers[:-1] if centers.shape[0] % 2 == 0 else centers[:-2]
    centers = centers.contiguous()
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.cpu().numpy(), n_atoms), device=dev)
    if row_ptr[EMPTY_ATOM] != row_ptr[EMPTY_ATOM + 1]:
        raise AssertionError(f"atom {EMPTY_ATOM} still has edges")
    return centers, row_ptr


def _shape_layers(dev):
    """Phase 5a's layers: the flagship's two layer shapes at U = 16 and 48 and
    an l = 4 layer at U = 32 (dims 25: walk rows beyond the compiled CG
    header, walked entry by entry), on ``fused``."""
    from allegro_tpu_torch.nn.contract import Contracter

    l2 = "1x0e+1x1o+1x2e"
    l4 = "+".join(f"1x{l}{'e' if l % 2 == 0 else 'o'}" for l in range(5))
    layers = [Contracter(*irreps, mul, kernel_backend="fused")
              for mul in (16, 48) for irreps in ((l2,) * 3, (l2, l2, "1x0e"))]
    layers.append(Contracter(l4, l4, l4, 32, kernel_backend="fused"))
    return [tp.to(dev) for tp in layers]


def check_scatter_shapes(data, rng):
    """Phase 5a, checks only: ``tp_scatter`` and ``unweight_sh`` (both role
    orders) and ``env_scatter`` on :func:`_odd_edges` at :func:`_shape_layers`'
    shapes, and ``unweight_sh`` and ``env_scatter`` on that l = 4 layer's
    dims at U = 256 and 512 on the edges of the first ``WIDE_ATOMS`` atoms
    less one: 32 wexp rows and 4 t rows take 260 KiB there at U = 256 and 520
    KiB at 512, more than the card's opt-in shared memory (227 KiB on an
    H100), so ``unweight_sh``'s launcher stages 2 t rows at U = 256 and takes
    16-edge tiles with one t row at 512; ``env_scatter``'s 64-edge chunks of
    wexp and sh rows are cut to 8 and 4 edges there (a quarter of the card's
    shared memory), and a block takes one atom and a slice of its 1,600 and
    3,200 (dim, 4 channels) items. Then a ``tp_scatter`` call on the card
    without its path table must raise."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    centers, row_ptr = _odd_edges(data)
    layers = _shape_layers(dev)
    E = centers.shape[0]
    check_scatter_kernels(layers, centers, row_ptr, rng, f"E {E} (atom {EMPTY_ATOM} without edges)")
    tp = layers[-1]
    wide = centers[:int(row_ptr[WIDE_ATOMS]) - 1]
    wide_ptr = torch.as_tensor(fused_tp.csr_row_ptr(wide.cpu().numpy(), n_atoms), device=dev)
    for U in (256, 512):
        t = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U).astype(np.float32), device=dev)
        wexp = torch.as_tensor(rng.randn(wide.shape[0], tp.n_irr * U).astype(np.float32),
                               device=dev)
        sh = torch.as_tensor(rng.randn(wide.shape[0], tp.d2).astype(np.float32), device=dev)
        check_env_scatter(sh, wexp, wide, wide_ptr, tp.dim_to_irr, U,
                          f"E {wide.shape[0]} U {U} dims ({tp.d1},{tp.d2},{tp.d3})")
        full = (32 * tp.n_irr + 4 * tp.d2) * U * 4
        check_case("unweight_sh",
                   lambda: (fused_tp.unweight_sh(t, wexp, wide, tp.dim_to_irr),),
                   lambda: (fused_tp.unweight_sh_reference(t, wexp, wide, tp.dim_to_irr),),
                   f"E {wide.shape[0]} U {U} dims ({tp.d1},{tp.d2},{tp.d3}) (full tile "
                   f"{full // 1024} KiB)")
        del t, wexp, sh
    tp = layers[0]
    x, w = torch.zeros(E, tp.d1 * tp.mul, device=dev), torch.zeros(tp.num_paths, tp.mul,
                                                                   device=dev)
    try:
        fused_tp.tp_scatter(x, x, w, centers, row_ptr, tp.entry_idx,
                            tp.entry_coef.to(torch.float32), tp.d2)
    except ValueError as e:
        print(f"    tp_scatter on the card without a path table raises: {e}")
    else:
        raise AssertionError("tp_scatter ran on the card without its path table")


def check_bwd_kernels(tps, centers, row_ptr, rng, label):
    """Checks only: ``bwd_fused`` without its weight gradient, with and
    without ``gts``, walking the layer's role-swap table (dx) and its (0, 2,
    1) table (denv) (``Contracter.infer_paths``), held to the plain version
    in float64 (denv sums up to ~137 edges per atom), ``unweight_w`` and
    ``unweight_both``, on the edges ``centers`` with the CSR ``row_ptr``,
    with x, g, gts, sh and wexp nonzero on the sentinel edges, which no
    kernel may read."""
    from allegro_tpu_torch.ops import fused_tp

    dev = centers.device
    n_atoms, E = row_ptr.shape[0] - 1, centers.shape[0]

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    for tp in tps:
        U = tp.mul
        idx, coef = tp.entry_idx, tp.entry_coef.to(torch.float32)
        _, swapped, scatter = tp.infer_paths()
        what = f"{label} U {U} dims ({tp.d1},{tp.d2},{tp.d3}) entries {idx.shape[0]:4d}"
        t, sh, wexp = rand(n_atoms, tp.d2 * U), rand(E, tp.d2), rand(E, tp.n_irr * U)
        check_case("unweight_w",
                   lambda: (fused_tp.unweight_w(t, sh, centers, tp.dim_to_irr, tp.n_irr),),
                   lambda: (fused_tp.unweight_w_reference(t, sh, centers, tp.dim_to_irr,
                                                          tp.n_irr),), what)
        check_case("unweight_both",
                   lambda: fused_tp.unweight_both(t, sh, wexp, centers, tp.dim_to_irr),
                   lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, tp.dim_to_irr),
                   what)
        del t, sh, wexp
        x, g, gts = rand(E, tp.d1 * U), rand(E, tp.d3 * U), rand(E, U)
        env, w = rand(n_atoms, tp.d2 * U), rand(tp.num_paths, U)
        beyond = int((swapped.desc[:, 1] < 0).sum() + (scatter.desc[:, 1] < 0).sum())
        for opt in (None, gts):
            exact = fused_tp.bwd_fused_reference(
                x.double(), g.double(), env.double(), w.double(), centers, n_atoms, idx,
                tp.entry_coef, None if opt is None else opt.double())
            check_case("bwd_fused",
                       lambda: fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef, opt,
                                                  paths=swapped, scatter_paths=scatter),
                       lambda: exact,
                       f"{what} {'gts' if opt is not None else '   '} rows "
                       f"{swapped.desc.shape[0]} + {scatter.desc.shape[0]} ({beyond} beyond the "
                       f"header) (vs float64)")
            del exact
        del x, g, gts, env


def check_bwd_shapes(data, rng):
    """Phase 5a, checks only: :func:`check_bwd_kernels` on :func:`_odd_edges`
    at :func:`_shape_layers`' shapes, ``unweight_w`` and ``unweight_both`` on
    the l = 4 layer's dims at U = 256 and 512 on the edges of the first
    ``WIDE_ATOMS`` atoms less one (4 staged t rows take 200 KiB at U = 512,
    as do ``unweight_sh``'s there; ``unweight_both``'s full tile, 32 wexp and
    sh rows beside them, 263 KiB at U = 256 and 523 KiB at 512, so its
    launcher backs off as ``unweight_sh``'s does), then a ``bwd_fused`` call
    on the card without its path tables, which must raise."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    centers, row_ptr = _odd_edges(data)
    layers = _shape_layers(dev)
    E = centers.shape[0]
    check_bwd_kernels(layers, centers, row_ptr, rng, f"E {E} (atom {EMPTY_ATOM} without edges)")
    tp = layers[-1]
    wide = centers[:int(row_ptr[WIDE_ATOMS]) - 1]
    for U in (256, 512):
        t = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U).astype(np.float32), device=dev)
        sh = torch.as_tensor(rng.randn(wide.shape[0], tp.d2).astype(np.float32), device=dev)
        wexp = torch.as_tensor(rng.randn(wide.shape[0], tp.n_irr * U).astype(np.float32),
                               device=dev)
        label = f"E {wide.shape[0]} U {U} dims ({tp.d1},{tp.d2},{tp.d3})"
        check_case("unweight_w",
                   lambda: (fused_tp.unweight_w(t, sh, wide, tp.dim_to_irr, tp.n_irr),),
                   lambda: (fused_tp.unweight_w_reference(t, sh, wide, tp.dim_to_irr,
                                                          tp.n_irr),),
                   f"{label} (4 staged t rows {4 * tp.d2 * U * 4 // 1024} KiB)")
        full = ((32 * tp.n_irr + 4 * tp.d2) * U + 32 * tp.d2) * 4
        check_case("unweight_both",
                   lambda: fused_tp.unweight_both(t, sh, wexp, wide, tp.dim_to_irr),
                   lambda: fused_tp.unweight_both_reference(t, sh, wexp, wide, tp.dim_to_irr),
                   f"{label} (full tile {full // 1024} KiB)")
        del t, sh, wexp
    tp = layers[0]
    x = torch.zeros(E, tp.d1 * tp.mul, device=dev)
    env = torch.zeros(n_atoms, tp.d2 * tp.mul, device=dev)
    w = torch.zeros(tp.num_paths, tp.mul, device=dev)
    try:
        fused_tp.bwd_fused(x, x, env, w, centers, row_ptr, tp.entry_idx,
                           tp.entry_coef.to(torch.float32))
    except ValueError as e:
        print(f"    bwd_fused on the card without its path tables raises: {e}")
    else:
        raise AssertionError("bwd_fused ran on the card without its path tables")


def check_readout_shapes(data, rng):
    """Phase 5a, checks only: ``readout_sum`` and ``readout_bwd`` on
    :func:`_odd_edges` (an odd edge count, an atom without edges), their
    pieces nonzero on the sentinel edges, which add nothing to any atom's
    energy and get zero rows: the flagship's pieces (64-wide column slices
    of 160-wide rows; 16-byte copies and float4 stores) with hidden widths
    20 (padded), 32 and 64 (two column groups per thread) and without a
    hidden layer; pieces of odd widths (5, 3, 17: 4-byte copies, column
    stores); 64-wide slices starting at column 1 of their rows (pointers not
    16-byte aligned); and three 256-wide pieces (K = 768), where W0ᵀ and a
    64-edge tile outgrow shared memory and ``readout_bwd``'s launcher takes
    32-edge tiles (``readout_sum``'s W0ᵀ and stage buffers still fit)."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    n_atoms = data[keys.CENTER_ROW_PTR].shape[0] - 1
    centers, row_ptr = _odd_edges(data)
    E = centers.shape[0]

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    y = rand(n_atoms, 1)
    S = FLAGSHIP["num_scalar_features"]
    layouts = {"flagship slices": ((S,) * 3, 0, S + 96), "odd widths": ((5, 3, 17), 0, 20),
               "unaligned slices": ((S,) * 3, 1, S + 96), "wide (K 768)": ((256,) * 3, 0, 256)}
    for what, (dims, start, width) in layouts.items():
        pieces = [rand(E, width)[:, start:start + d] for d in dims]
        K = sum(dims)
        for H in ((20, 32, 64, None) if what == "flagship slices" else (32,)):
            w0 = rand(K, H or 1) / K**0.5
            w1 = None if H is None else rand(H, 1) / H**0.5
            label = f"E {E} {what} {list(dims)} " + ("no hidden layer" if H is None else f"H {H}")
            check_case("readout_sum",
                       lambda: (fused_tp.readout_sum(pieces, w0, w1, row_ptr),),
                       lambda: (fused_tp.readout_sum_reference(pieces, w0, w1, row_ptr),), label)
            check_case("readout_bwd",
                       lambda: fused_tp.readout_bwd(pieces, w0, w1, y, centers),
                       lambda: fused_tp.readout_bwd_reference(pieces, w0, w1, y, centers), label)
        del pieces


def check_pallas_kernels(tps, n_edges, dev, rng, records, library=True, first=0,
                         plain_timing=None, untimed_rows=None):
    """Phase 6a: ``sparse_tp`` and ``sparse_tp_gradw`` against their plain
    versions on ``n_edges`` rows, at each layer's dims, in all six role
    orders of its table (each order's path table in walk order, as the
    kernels take it from ``Contracter.tp_statics``), ``sparse_tp`` with and
    without path-channel coupling (the weights of one path equal across
    channels). Timed (coupled; the table and its a- and b-swaps, the orders
    of the force call and of ``sparse_tp_gradw``'s launches in a training
    step): the median times, summed over the layers and three orders, with
    the one ``torch.einsum`` call that computes the same function from the
    dense CG tensor (None and "OOM" printed where it runs out of device
    memory). The other three orders (the weight gradient's transposes) are
    checks only, on ``untimed_rows`` rows where given (the walks do not
    depend on the row count). Each entry of ``sparse_tp_gradw`` sums ~10^5
    edges, and the
    float32 plain version's own error comes near the tolerance at the 3-layer
    l_max-3 dims (printed beside each case), so the kernel is held to the
    plain version in float64 (from the float64 entries), as the chunked
    ``center_sum`` is."""
    from allegro_tpu_torch.nn.contract import sparse_entries
    from allegro_tpu_torch.ops import fused_tp
    from allegro_tpu_torch.ops import pallas_contract as pc
    from allegro_tpu_torch.ops.tp_primitives import SWAP_A, SWAP_B, compose

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    timed_orders = {0: "table", compose(0, SWAP_A): "swap_a", compose(0, SWAP_B): "swap_b"}
    for layer, tp in enumerate(tps, first):
        U, P, st = tp.mul, tp.num_paths, tp.tp_statics()
        idx64, coef64 = (t.to(dev) for t in pc.role_tables(sparse_entries(tp.w3j.cpu().numpy()),
                                                          torch.float64))
        for r in range(len(pc.ROLES)):
            tag = timed_orders.get(r, "".join(map(str, pc.ROLES[r])))
            d1, d2, d3 = (st.dims[s] for s in pc.ROLES[r])
            (idx, coef), paths = st.table(r), st.walk(r)
            n = idx.shape[0]
            timed = records if r in timed_orders else None
            E = n_edges if r in timed_orders or untimed_rows is None else untimed_rows
            a, b, g = rand(E, d1 * U), rand(E, d2 * U), rand(E, d3 * U)
            a3, b3, g3 = a.view(E, d1, U), b.view(E, d2, U), g.view(E, d3, U)
            C = fused_tp._cg_tensor(a, idx, coef, P, d1, d2, d3)
            label = (f"U {U} E {E} layer {layer} {tag:6s} dims ({d1},{d2},{d3}) entries {n:3d} "
                     f"rows {paths.desc.shape[0]}")
            for coupled in (True, False):
                w = rand(P, U) if coupled else rand(P, 1).expand(P, U).contiguous()
                lib = _fits(lambda: torch.einsum("eiu,eju,pu,pijk->eku", a3, b3, w, C)) \
                    if coupled and library and timed is not None else None
                check_case("sparse_tp", lambda: (pc.sparse_tp(a, b, w, idx, coef, d3, paths),),
                           lambda: (pc.sparse_tp_reference(a, b, w, idx, coef, d3),),
                           f"{label} {'coupled' if coupled else 'uncoupled'}",
                           timed if coupled else None, (a, b, w, idx, coef), 3 * E * n * U, lib,
                           plain_timing=plain_timing)
            lib = _fits(lambda: torch.einsum("eiu,eju,eku,pijk->pu", a3, b3, g3, C)) \
                if library and timed is not None else None
            exact = pc.sparse_tp_gradw_reference(a.double(), b.double(), g.double(), idx64[r],
                                                 coef64[r], P, U)
            plain_rel = rel_err(pc.sparse_tp_gradw_reference(a, b, g, idx, coef, P, U), exact)[1]
            print(f"    the float32 plain sparse_tp_gradw against float64: rel {plain_rel:.3e}")
            check_case("sparse_tp_gradw",
                       lambda: (pc.sparse_tp_gradw(a, b, g, idx, coef, P, U, paths),),
                       lambda: (pc.sparse_tp_gradw_reference(a, b, g, idx, coef, P, U),),
                       f"{label} (vs float64)", timed, (a, b, g, idx, coef), 4 * E * n * U, lib,
                       plain_timing=plain_timing, exact=lambda: (exact,))
            del exact
            del a, b, g, a3, b3, g3, C
            torch.cuda.empty_cache()


def check_pallas_shapes(n_edges, dev, rng):
    """Phase 6a, checks only, on ``n_edges`` rows (odd: not a whole number of
    any block's edges): both kernels in all six role orders of the
    flagship's layers at U = 16 and 48 (a warp spans two edges; an edge
    spans warps), and of a layer with paths beyond the compiled header (the
    l_max-4 model's layer 0 at U = 32: dims 25, 1,158 entries; each l = 4
    output slice walked in two chunks, entry by entry)."""
    from allegro_tpu_torch.nn.contract import Contracter
    from allegro_tpu_torch.ops import gen_cg_blocks

    layers = [Contracter(*irreps, mul, kernel_backend="pallas")
              for mul in (16, 48)
              for irreps in (("1x0e+1x1o+1x2e",) * 3, ("1x0e+1x1o+1x2e",) * 2 + ("1x0e",))]
    l4 = "+".join(f"1x{l}{'e' if l % 2 == 0 else 'o'}" for l in range(5))
    layers.append(Contracter(l4, l4, l4, 32, kernel_backend="pallas"))
    desc = layers[-1].tp_statics().walk(0).desc
    beyond = int((desc[:, 1] == gen_cg_blocks.DEFAULT).sum())
    if beyond == 0:
        raise AssertionError("the l = 4 layer has no path beyond the header")
    print(f"    l = 4 layer: {beyond} of its {desc.shape[0]} rows beyond the header")
    for tp in layers:
        check_pallas_kernels([tp.to(dev)], n_edges, dev, rng, None, library=False)


def _fits(fn):
    """``fn`` if one call of it fits in device memory, else None (and "OOM"
    is printed): the library yardstick of a kernel."""
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except torch.cuda.OutOfMemoryError:
        print("  library call: OOM")
        torch.cuda.empty_cache()
        return None


def train_loaders():
    """The JAX bench's training batches (``run_train_bench_1k`` and
    ``run_train_bench``, allegro_tpu/bench.py:588-680): four 1,000-atom
    crystals (seeds 200-203) with zero energy and force targets, and 16
    synthetic 21-atom molecular frames (spread 3.0) with their labels, each
    one batch, r_max 4.0."""
    from allegro_tpu_torch.data import (DataLoader, InMemoryDataset, keys,
                                        synthetic_molecular_frames)

    crystals = []
    for seed in TRAIN_SEEDS:
        frame, _ = crystal_frame(TRAIN_ATOMS, R_MAX, seed)
        crystals.append({**frame, keys.TOTAL_ENERGY: np.zeros(1),
                         keys.FORCES: np.zeros_like(frame[keys.POSITIONS])})
    mols = synthetic_molecular_frames(MOL_FRAMES, n_atoms=MOL_ATOMS, spread=MOL_SPREAD)
    return {"1k": DataLoader(InMemoryDataset(crystals, R_MAX), batch_size=len(crystals)),
            "21": DataLoader(InMemoryDataset(mols, R_MAX), batch_size=MOL_FRAMES)}


def train_models(batch_np, backend="fused"):
    """The flagship on ``backend`` (random weights from SEED) and its
    ``einsum`` twin with the same weights, for one training batch."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel

    avg_n = float(batch_np[keys.EDGE_MASK].sum()) / float(batch_np[keys.NODE_MASK].sum())
    fused = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n,
                         tp_kernel_backend=backend).init(SEED)
    einsum = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n, tp_kernel_backend="einsum")
    einsum.load_state_dict(fused.state_dict())
    return fused, einsum


def make_trainer(model, dev):
    """Adam at 1e-3 and EMA 0.999 with the trainer's default loss: per-atom
    energy and force MSE (the reference tutorial's). The bench's total-energy
    MSE grows with the frame size: on zero targets, Adam's first steps (each
    parameter moves by about the learning rate) overshoot it."""
    from allegro_tpu_torch.train import Trainer

    return Trainer(model, learning_rate=1e-3, ema_decay=0.999, device=dev,
                   logger=lambda s: None)


def peak_mib():
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def run_training(loaders, dev, smi, backend="fused", per_step=PER_STEP, labels=("5c", "5b")):
    """Phase 5b/5c (6c on ``pallas``; ``labels`` of the two) on each batch: the gradient agreement
    of ``backend`` with ``einsum`` on the first step, two identical force
    calls on the 1k batch (several periodic frames) that must give the same
    bits in energy, forces and virial, then TRAIN_STEPS Adam
    steps through ``Trainer.fit`` with the launch counts of every step
    (``per_step``), two identical runs of TRAIN_REPEAT_STEPS steps, and (1k
    batch) a torch.profiler trace of 3 steps. Returns the launches
    of each batch's TRAIN_STEPS steps."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    launches = {}
    for name, loader in loaders.items():
        batch_np = next(iter(loader))
        n_atoms, n_edges = int(batch_np[keys.NODE_MASK].sum()), int(batch_np[keys.EDGE_MASK].sum())
        fused, einsum = train_models(batch_np, backend)
        init = {k: v.clone() for k, v in fused.state_dict().items()}
        what = f"{name}: {loader.batch_size} frames, {n_atoms} atoms, {n_edges} edges"
        # 5c: the parameter gradients of the first step, fused against einsum
        grads, peaks = {}, {}
        for which, model in ((backend, fused), ("einsum", einsum)):
            trainer = make_trainer(model, dev)
            state = trainer.init_state()
            data = trainer.to_device(batch_np)
            torch.cuda.reset_peak_memory_stats()
            _, _, grads[which] = trainer.loss_and_grads(state, data)
            peaks[which] = peak_mib()
            if which == backend:
                backend_data = data
                if name == "1k":
                    check_same_gradients(trainer, state, data, f"{backend}, {what}")
        ratios = {k: ((g - grads["einsum"][k]).abs().max() / grads["einsum"][k].abs().max()).item()
                  for k, g in grads[backend].items()}
        worst = max(ratios, key=ratios.get)
        print(f"[{labels[0]}] {what}: parameter gradients {backend} vs einsum, worst max-abs err / "
              f"max-abs {ratios[worst]:.3e} ({worst}; < {GRAD_TOL}); peak of one step's "
              f"gradient: {backend} {peaks[backend]:.1f} MiB, einsum {peaks['einsum']:.1f} MiB")
        if not ratios[worst] < GRAD_TOL:
            raise AssertionError(f"{name}: {backend} vs einsum gradient of {worst}: "
                                 f"{ratios[worst]:.3e}")
        del grads, einsum
        torch.cuda.empty_cache()
        if name == "1k":
            # several periodic frames: each edge reads its frame's cell, each
            # atom its frame's strain, and the virial sums per frame
            first, again = (fused.apply_with_derivatives(backend_data) for _ in range(2))
            same = bitwise_same(first, again)
            print(f"    two identical force calls on {backend}, {loader.batch_size} periodic frames "
                  f"(virial {tuple(first[keys.VIRIAL].shape)}): energy, forces and virial "
                  f"{'the same bits' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"{backend}: two identical force calls on the 1k batch differ")
        del backend_data
        if name == "1k":
            # the spline embed and trainable per-type scales and shifts: the
            # parameter tables read by class, whose gradients center_sum adds
            spline = AllegroModel(**FLAGSHIP, **TABLE_MODEL, avg_num_neighbors=n_edges / n_atoms,
                                  tp_kernel_backend=backend).init(SEED)
            trainer = make_trainer(spline, dev)
            state = trainer.init_state()
            check_same_gradients(trainer, state, trainer.to_device(batch_np),
                                 f"{backend}, spline embed and trainable scales and shifts, "
                                 f"{what}")
            del spline, trainer, state
            torch.cuda.empty_cache()
        # 5b: TRAIN_STEPS steps, one per fit call (the loader is one batch)
        trainer = make_trainer(fused, dev)
        state = trainer.init_state()
        totals = {k: 0 for k in per_step}
        times = []
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            fused_tp.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.fit(state, loader, max_epochs=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if fused_tp.LAUNCHES != per_step:
                raise AssertionError(f"{name} step {step}: launches {fused_tp.LAUNCHES}, "
                                     f"expected {per_step}")
            for k, c in fused_tp.LAUNCHES.items():
                totals[k] += c
        peak = peak_mib()
        losses = [h["train_loss"] for h in trainer.history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses} are not finite or did not fall")
        ms = 1e3 * float(np.median(times[1:]))
        print(f"[{labels[1]}] {what}: {TRAIN_STEPS} Adam steps on {backend}, loss {losses[0]:.6e} -> "
              f"{losses[-1]:.6e}; launches per step "
              f"{ {k: c for k, c in per_step.items() if c} }")
        print(f"    {ms:.3f} ms/step (median of steps 2-{TRAIN_STEPS}, host clock, statics and "
              f"upload included), {loader.batch_size / ms * 1e3:.2f} samples/s, peak "
              f"{peak:.1f} MiB; {smi}")
        launches[name] = totals
        # two identical runs from the same weights
        runs = []
        for _ in range(2):
            fused.load_state_dict(init)
            again = make_trainer(fused, dev)
            s = again.fit(again.init_state(), loader, max_epochs=TRAIN_REPEAT_STEPS)
            runs.append({k: v.detach().clone() for k, v in s.params.items()})
        delta = max((runs[0][k] - runs[1][k]).abs().max().item() for k in runs[0])
        print(f"    max |dparam| of two identical runs of {TRAIN_REPEAT_STEPS} steps: {delta:.3e}")
        if delta != 0.0:
            raise AssertionError(f"{name}: two identical runs on {backend} differ by {delta:.3e}")
        if name == "1k":
            profile_steps(again, s, loader)
    return launches


def check_same_gradients(trainer, state, data, what):
    """Phases 5c and 6c: two identical training steps' parameter gradients
    (the same weights and batch) must agree bit for bit in every parameter,
    and the class lookups' center kernels must have run."""
    from allegro_tpu_torch.ops import fused_tp

    fused_tp.reset_launch_counts()
    _, _, first = trainer.loss_and_grads(state, data)
    gathers = fused_tp.LAUNCHES["center_gather"]
    _, _, again = trainer.loss_and_grads(state, data)
    differ = [k for k in first if not torch.equal(first[k], again[k])]
    print(f"    two identical training steps on {what}: {len(first)} parameter gradients "
          f"{'the same bits' if not differ else 'DIFFER in ' + ', '.join(differ)} "
          f"({gathers} center_gather launches per step)")
    if differ:
        raise AssertionError(f"{what}: two identical training steps differ in {differ}")


def profile_steps(trainer, state, loader, steps=3):
    """Where a training step's time goes: torch.profiler over ``steps`` steps,
    device time by kernel name and the device's idle share of the span.
    Returns (device ms per step, idle %), or None where the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(state, loader, max_epochs=steps)
        torch.cuda.synchronize()
        span_ms = 1e3 * (time.perf_counter() - t0)
    # device events only; a user annotation (Optimizer.step) spans kernels
    # that are counted on their own
    rows = [(e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[0] for r in rows)
    if not rows:
        print("    profile: torch.profiler recorded no device time")
        return None
    idle = 100 * (1 - busy * steps / span_ms)
    print(f"    profile of {steps} steps (1k batch): {sum(r[1] for r in rows):.0f} device ops "
          f"and {busy:.4f} ms device time per step, span {span_ms / steps:.4f} ms per step "
          f"(profiled), idle {idle:.1f}%; per step by name:")
    for ms, count, key in sorted(rows, reverse=True)[:16]:
        print(f"      {ms:9.4f} ms {count:6.1f}x  {key[:90]}")
    return busy, idle


def drive_force_calls(phase, config, model, data, ref, n_atoms, n_rows):
    """N_CALLS force calls with the exact launch counts of PER_CALL[config]
    after each, the outputs held to ``ref`` (einsum), two identical calls
    that must give the same bits (energy, forces, virial) and the µs/atom;
    returns (launches, µs/atom)."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    fused_tp.reset_launch_counts()
    for call in range(1, N_CALLS + 1):
        out = model.apply_with_derivatives(data)
        want = {k: n * call for k, n in PER_CALL[config].items()}
        if fused_tp.LAUNCHES != want:
            raise AssertionError(f"{config}, force call {call}: launches "
                                 f"{fused_tp.LAUNCHES}, expected {want}")
    torch.cuda.synchronize()
    launches = dict(fused_tp.LAUNCHES)
    print(f"[{phase}] {N_CALLS} force calls, {config}; launches "
          f"{ {k: c for k, c in launches.items() if c} }")
    check_force_call(out, ref, n_atoms, n_rows)
    again = model.apply_with_derivatives(data)
    drift = (again[keys.FORCES] - out[keys.FORCES]).abs().max().item()
    same = bitwise_same(out, again)
    print(f"    two identical calls: max |dforces| {drift:.3e}; energy, forces and virial "
          f"{'the same bits' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{config}: two identical force calls differ")
    return launches, time_force_call(model, data, n_atoms)


def cli_launches(config):
    """The exact launch counts of one CLI run, derived from its config: on
    ``pallas`` ``per_call`` / ``per_step_pallas`` for its number of layers
    and pair potential; ``einsum`` launches nothing (no CSR statics). ``md``:
    ``steps_per_block + 1`` force calls per block;
    ``run``: the training steps, one validation pass per epoch and the test
    pass, one force call per batch."""
    counts = {k: 0 for k in PER_CALL["mega"]}
    model = config["model"]
    if model.get("tp_kernel_backend", "einsum") != "pallas":
        return counts
    L, zbl = int(model["num_layers"]), model.get("pair_potential") is not None
    if "md" in config.get("run", []):
        md = config["md"]
        blocks = -(-int(md["n_steps"]) // int(md["steps_per_block"]))
        calls = blocks * (int(md["steps_per_block"]) + 1)
        return {k: calls * n for k, n in per_call("pallas", L, zbl).items()}
    data, epochs = config["data"], int(config["trainer"]["max_epochs"])
    batches = {k: -(-int(v) // int(data["batch_size"])) for k, v in data["split"].items()}
    calls = epochs * batches["val"] + batches["test"]
    steps = epochs * batches["train"]
    call, step = per_call("pallas", L, zbl), per_step_pallas(L, zbl)
    return {k: calls * call[k] + steps * step[k] for k in counts}


SGD_PACKAGE = "tutorial.atpkg"


def tutorial_sgd(workdir):
    """``configs/tutorial.yaml`` under ``optax.sgd`` with momentum 0.9 on an
    ``optax.exponential_decay`` schedule, steps 5-10 traced into
    ``workdir/trace``, and the ``package`` stage after train and test."""
    import yaml

    cfg = yaml.safe_load((REPO / "configs/tutorial.yaml").read_text())
    cfg["run"] = ["train", "test", "package"]
    # plain SGD on the tutorial's force loss diverges at 1e-3 and 1e-4
    cfg["trainer"]["optimizer"] = {"_target_": "optax.sgd", "learning_rate": 1e-5,
                                   "momentum": 0.9}
    cfg["trainer"]["lr_scheduler"] = {"_target_": "optax.exponential_decay",
                                      "transition_steps": 20, "decay_rate": 0.9}
    cfg["trainer"]["profile_dir"] = str(workdir / "trace")
    return cfg


def check_package(workdir, dev):
    """Phase 6d's package: the ``.atpkg`` the ``package`` stage wrote holds
    the EMA parameters of its checkpoint, bit for bit, and a force call on
    the card with the packaged parameters gives the same bits as one with
    the checkpoint's EMA parameters (the resolved config's model, on
    ``fused_infer``); the training run left a torch.profiler trace."""
    from allegro_tpu_torch.cli import _build_data
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.train import load_checkpoint
    from allegro_tpu_torch.train.config import build_model
    from allegro_tpu_torch.train.package import load_package

    _, params, meta = load_package(str(workdir / SGD_PACKAGE))
    name = meta["extra"]["checkpoint"]
    ema = load_checkpoint(str(workdir), name).ema_params
    if not meta["extra"]["from_checkpoint"] or any(not torch.equal(params[k], v)
                                                   for k, v in ema.items()):
        raise AssertionError(f"package {meta} does not hold the {name} checkpoint's EMA")
    resolved = json.loads((workdir / "resolved_config.json").read_text())
    # the force calls on fused_infer, whose kernels sum in a fixed order (the
    # run's einsum backend adds with atomics on the card)
    infer = {**resolved["model"], "tp_kernel_backend": "fused_infer"}
    from_package, from_ema = build_model(infer), build_model(infer)
    from_package.load_state_dict(params)
    from_ema.load_state_dict({**from_ema.state_dict(), **ema})
    _, loaders = _build_data(resolved["data"])
    batch = next(iter(loaders["test"]))
    outs = []
    for m in (from_package.to(dev), from_ema.to(dev)):
        outs.append(m.apply_with_derivatives(
            to_torch(m.precompute_statics(batch), dtype=torch.float32, device=dev)))
    same = all(torch.equal(outs[0][k], outs[1][k])
               for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES))
    traces = sorted((workdir / "trace").glob("trace_*.json"))
    print(f"    package {SGD_PACKAGE} ({meta['format']}, {meta['n_params']} arrays, the {name} "
          f"checkpoint's EMA): force call on fused_infer "
          f"{'the same bits' if same else 'DIFFERS'}; "
          f"{len(traces)} torch.profiler trace(s) of steps 5-10")
    if not same or not traces:
        raise AssertionError("the package's force call differs, or no profiler trace")


def run_cli(smi, dev, tmp):
    """Phase 6d: ``python -m allegro_tpu_torch`` in subprocesses on the
    shipped configs (``md -c configs/md.yaml``, ``run -c
    configs/tutorial.yaml``), on the tutorial with the ``pallas`` backend,
    and on it under sgd with an exponential decay, profiled, then packaged
    (``tutorial_sgd``, ``check_package``), each into a temporary workdir,
    the four processes started together (each counts its own launches):
    exit 0, the exact launch counts of the run, the files each writes,
    finite energies and test metrics. The workdirs go into ``tmp`` (phase
    9d compiles the tutorial's). Returns the launches by run."""
    import yaml

    out = {}
    tutorial = yaml.safe_load((REPO / "configs/tutorial.yaml").read_text())
    tutorial["model"]["tp_kernel_backend"] = "pallas"
    pallas_cfg = Path(tmp) / "tutorial_pallas.yaml"
    pallas_cfg.write_text(yaml.safe_dump(tutorial))
    sgd_cfg = Path(tmp) / "tutorial_sgd.yaml"
    sgd_cfg.write_text(yaml.safe_dump(tutorial_sgd(Path(tmp) / "tutorial_sgd")))
    runs = (("md", ["md", "-c", "configs/md.yaml"]),
            ("tutorial", ["run", "-c", "configs/tutorial.yaml"]),
            ("tutorial_pallas", ["run", "-c", str(pallas_cfg)]),
            ("tutorial_sgd", ["run", "-c", str(sgd_cfg), "-o", SGD_PACKAGE]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", CLI_DRIVER, *args, "-w",
                               str(Path(tmp) / name)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for name, args in runs]
    try:
        results = [proc.communicate(timeout=CLI_TIMEOUT) + (time.perf_counter() - t0,)
                   for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (name, args), proc, (stdout, stderr, seconds) in zip(runs, procs, results):
        workdir = Path(tmp) / name
        cfg_path = Path(args[2]) if Path(args[2]).is_absolute() else REPO / args[2]
        config = yaml.safe_load(cfg_path.read_text())
        if proc.returncode != 0:
            print(stdout[-3000:])
            print(stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"CLI {' '.join(args)} exited {proc.returncode}")
        lines = stdout.splitlines()
        launches = json.loads(lines[-1][len("LAUNCHES "):])
        want = cli_launches(config)
        if launches != want:
            raise AssertionError(f"CLI {name}: launches {launches}, expected {want}")
        out[name] = launches
        print(f"[6d] python -m allegro_tpu_torch {' '.join(args)}: exit 0 after {seconds:.1f} s "
              f"(the four started together; process start and kernel load included); launches "
              f"{ {k: c for k, c in launches.items() if c} }")
        if name == "md":
            log = json.loads((workdir / "md_log.json").read_text())
            energies = [r["e_tot"] for r in log]
            if len(log) != -(-config["md"]["n_steps"] // config["md"]["steps_per_block"]) \
                    or not np.isfinite(energies).all():
                raise AssertionError(f"md_log.json: {log}")
            print(f"    E_tot {energies[0]:.6f} -> {energies[-1]:.6f} over {log[-1]['step']} "
                  f"steps")
            print("    " + next(ln for ln in lines if ln.startswith("MD done")) + f"; {smi}")
            continue
        files = {p.name for p in workdir.iterdir()}
        if not {"best.pt", "last.pt", "resolved_config.json"} <= files:
            raise AssertionError(f"CLI {name} wrote {sorted(files)}")
        if name == "tutorial_sgd":
            check_package(workdir, dev)
        metrics = json.loads(next(ln for ln in lines if ln.startswith("test metrics: "))
                             [len("test metrics: "):])
        if not metrics or not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"CLI {name}: test metrics {metrics}")
        losses = [float(ln.split("train_loss=")[1].split()[0]) for ln in lines
                  if ln.startswith("epoch=")]
        print(f"    train_loss by epoch {[f'{x:.6f}' for x in losses]}; test metrics "
              f"{json.dumps(metrics)}")
        print("    " + next(ln for ln in lines if ln.startswith("trained ")) + f"; {smi}")
    return out


def check_kernel18(tps, data, rng, records, tag, plain_timing=None):
    """Phase 7b: kernel 18 (``bwd_fused`` with its weight gradient) at each
    layer's dims: with and without dw against the plain version, two calls
    with dw giving the same bits, and with ``records`` (layer 0's dims) its
    device time beside the three kernels the trainable backend runs for the
    same cotangents (``gather_tp`` on the swapped table for dx,
    ``tp_scatter`` for denv, ``gather_dw`` for dw) on the same inputs, under
    ``bwd_fused[dw]`` and ``bwd_fused[trio]``. Kernel 19 (``unweight_both``
    from one denv array) is checked beside it."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for layer, tp in enumerate(tps):
        U, d1, d2, d3, P = tp.mul, tp.d1, tp.d2, tp.d3, tp.num_paths
        idx, coef, d2i = tp.entry_idx, tp.entry_coef.to(torch.float32), tp.dim_to_irr
        n = idx.shape[0]
        x, g, w = rand(E, d1 * U), rand(E, d3 * U), rand(P, U, edge=False)
        env, t = rand(n_atoms, d2 * U, edge=False), rand(n_atoms, d2 * U, edge=False)
        sh, wexp = rand(E, d2), rand(E, tp.n_irr * U)
        timed = records if layer == 0 else None
        label = f"{tag} U {U} layer {layer} dims ({d1},{d2},{d3}) entries {n:3d} P {P}"
        reads = (x, g, env, w, row_ptr, idx, coef)
        _, swapped_walk, scatter = tp.infer_paths()
        for with_dw in (False, True):
            key = "bwd_fused[dw]" if with_dw else "bwd_fused"
            check_case(key, lambda: fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef,
                                                       with_dw=with_dw, paths=swapped_walk,
                                                       scatter_paths=scatter),
                       lambda: fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, idx,
                                                            coef, with_dw=with_dw),
                       label, timed if with_dw else None, reads, (6 + 4 * with_dw) * Er * n * U,
                       plain_timing=plain_timing)
        first = fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef, with_dw=True)
        again = fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef, with_dw=True)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"    bwd_fused with dw, two identical calls: {'same bits' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"bwd_fused with dw ({label}) is not deterministic")
        swapped = tp.entry_swapped
        walk, walk_swapped = tp.gather_paths()
        trio = lambda: (fused_tp.gather_tp(g, env, w, centers, swapped, coef, d1,
                                           paths=walk_swapped),
                        fused_tp.tp_scatter(x, g, w, centers, row_ptr, idx, coef, d2,
                                            scatter_paths(tp)[0]),
                        fused_tp.gather_dw(x, env, g, centers, idx, coef, P, U, walk))
        check_case("bwd_fused[trio]", trio,
                   lambda: fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, idx, coef,
                                                        with_dw=True),
                   label + " (gather_tp swapped + tp_scatter + gather_dw)", timed,
                   reads + (swapped,), 10 * Er * n * U, plain_timing=plain_timing)
        check_case("unweight_both", lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
                   lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
                   label + " (kernel 19)", None, plain_timing=plain_timing)


def lmax3_models(n_edges, n_atoms, dev):
    """The l_max-3 model of the JAX bench's run_lmax3_bench (BASELINE.json
    config 3) at full width, random weights from SEED, on fused_infer (mega,
    the default) and with the same weights on use_mega=False, pallas and
    einsum; and its 3-layer twin (the middle dims 31) on fused and pallas."""
    from allegro_tpu_torch.model import AllegroModel

    avg_n = n_edges / n_atoms
    base = AllegroModel(**LMAX3, avg_num_neighbors=avg_n, tp_kernel_backend="fused_infer")
    base.init(SEED).to(dev)
    models = {"mega": base}
    for config, kw in (("fused readout", dict(tp_kernel_backend="fused_infer", use_mega=False)),
                       ("pallas", dict(tp_kernel_backend="pallas")),
                       ("einsum", dict(tp_kernel_backend="einsum"))):
        m = AllegroModel(**LMAX3, avg_num_neighbors=avg_n, **kw).to(dev)
        m.load_state_dict(base.state_dict())
        models[config] = m
    deep = tuple(AllegroModel(**{**LMAX3, "num_layers": 3}, avg_num_neighbors=avg_n,
                              tp_kernel_backend=b).init(SEED).to(dev) for b in ("fused", "pallas"))
    return models, deep


def check_lmax3_kernels(models, deep, data, n_edges, dev, rng, records):
    """Phase 7a: every kernel with a basis dimension (1-4, 7-10, 13-17, 18,
    19, 20, 21) at the l_max-3 shapes on the crystal: layer 0 (16, 16, 16;
    353 entries; timed into ``records``, the launches of one force call or
    training step at that layer) and layer 1 (16, 16, 1; 16 entries) of the
    2-layer model; the 3-layer model's middle dims (16, 16, 31) and (31, 16,
    16) (611 entries each), checks only. ``deep``: that model on ``fused``
    and on ``pallas`` (whose Contracters hold the six table orders). The
    untimed ``pallas`` checks take a quarter of the crystal's rows: their
    walks do not depend on the row count, and on all of them (with their
    float64 references) they took 89 of phase 7a's 192 s on an NVIDIA H100
    80GB HBM3 at 700 W."""
    mega, tps = models["mega"].module.allegro, models["fused readout"].module.allegro.tps
    ptps = models["pallas"].module.allegro.tps
    timing = PHASE7_PLAIN_TIMING
    check_kernels(tps[:1], data, rng, records, plain_timing=timing)
    check_kernels(tps[1:], data, rng, first=1)
    check_mega_kernels(mega, data, rng, records, plain_timing=timing)
    check_train_kernels(tps[:1], data, rng, records, plain_timing=timing)
    check_train_kernels(tps[1:], data, rng, first=1)
    check_kernel18(tps, data, rng, records, "l_max 3", timing)
    check_pallas_kernels(ptps[:1], n_edges, dev, rng, records, library=False, plain_timing=timing)
    rows = n_edges // 4
    check_pallas_kernels(ptps[1:], rows, dev, rng, None, library=False, first=1)
    fused_deep, pallas_deep = (m.module.allegro for m in deep)
    check_kernels(fused_deep.tps[:2], data, rng)
    check_mega_kernels(fused_deep, data, rng)
    check_train_kernels(fused_deep.tps[:2], data, rng)
    check_kernel18(fused_deep.tps[:2], data, rng, None, "l_max 3, 3 layers")
    check_pallas_kernels(pallas_deep.tps[:2], rows, dev, rng, None, library=False)


def bitwise_same(a, b):
    """Energy, forces and virial of two force calls equal bit for bit."""
    from allegro_tpu_torch.data import keys

    return all(torch.equal(a[k], b[k]) for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL))


def profile_calls(fn, calls, label):
    """Where a force call's time goes: torch.profiler over ``calls`` calls,
    device time by kernel name and the device's idle share of the span.
    Returns (device ms per call, idle %, [(ms per call, count, name)]), or
    None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        span_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total / 1e3 / calls, e.count / calls, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        print(f"    profile ({label}): torch.profiler recorded no device time")
        return None
    busy = sum(r[0] for r in rows)
    idle = 100 * (1 - busy * calls / span_ms)
    print(f"    profile of {calls} force calls ({label}): {sum(r[1] for r in rows):.0f} device "
          f"ops and {busy:.4f} ms device time per call, span {span_ms / calls:.4f} ms per call "
          f"(profiled), idle {idle:.1f}%; per call by name:")
    rows.sort(reverse=True)
    for ms, count, key in rows[:12]:
        print(f"      {ms:9.4f} ms {count:6.1f}x  {key[:90]}")
    return busy, idle, rows


def run_lmax3(models, frame, batch_np, n_atoms, dev, smi):
    """Phase 7c/7d: the l_max-3 force call on mega, use_mega=False, pallas
    and einsum (exact launch counts per call, forces and per-atom energies
    held to einsum, µs/atom, peak memory, two calls bit for bit, a profile of
    mega and pallas), then 20 MD steps on mega (2 blocks of 10) against
    einsum and one calculator call. Returns the launches of each
    configuration's calls and of the MD and calculator runs."""
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.md import MDState, Simulation, maxwell_boltzmann_velocities
    from allegro_tpu_torch.ops import fused_tp

    n_rows = batch_np[keys.POSITIONS].shape[0]
    data = {c: to_torch(m.precompute_statics(batch_np), dtype=torch.float32, device=dev)
            for c, m in models.items()}
    ref = models["einsum"].apply_with_derivatives(data["einsum"])
    launches, us = {}, {}
    for config in ("mega", "fused readout", "pallas"):
        model = models[config]
        model.apply_with_derivatives(data[config])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_tp.reset_launch_counts()
        calls = 3
        for call in range(1, calls + 1):
            out = model.apply_with_derivatives(data[config])
            want = {k: n * call for k, n in per_call(config).items()}
            if fused_tp.LAUNCHES != want:
                raise AssertionError(f"l_max 3 {config}, call {call}: launches "
                                     f"{fused_tp.LAUNCHES}, expected {want}")
        peak = peak_mib()
        launches[config] = dict(fused_tp.LAUNCHES)
        print(f"[7c] l_max 3, {config}: {calls} force calls, launches per call "
              f"{ {k: c for k, c in per_call(config).items() if c} }; peak {peak:.1f} MiB")
        check_force_call(out, ref, n_atoms, n_rows)
        again = model.apply_with_derivatives(data[config])
        same = bitwise_same(out, again)
        print(f"    two identical calls: energy, forces and virial "
              f"{'the same bits' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"l_max 3 {config}: two identical force calls differ")
        us[config] = time_force_call(model, data[config], n_atoms)
    torch.cuda.reset_peak_memory_stats()
    models["einsum"].apply_with_derivatives(data["einsum"])
    einsum_peak = peak_mib()
    us["einsum"] = time_force_call(models["einsum"], data["einsum"], n_atoms)
    print("    l_max 3 force call: " + ", ".join(f"{k} {v:.3f} us/atom" for k, v in us.items())
          + f"; einsum peak {einsum_peak:.1f} MiB ({n_atoms} atoms, f32; {smi})")
    for config in ("mega", "pallas"):
        profile_calls(lambda: models[config].apply_with_derivatives(data[config]), 3,
                      f"l_max 3, {config}")
    del data
    torch.cuda.empty_cache()

    # 7d: 20 MD steps on mega against einsum, and one calculator call
    kw = dict(atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC],
              device=dev, **MD)
    pos0 = frame[keys.POSITIONS]
    sim = Simulation(models["mega"], **kw)
    vel0 = maxwell_boltzmann_velocities(sim.masses_per_atom, MD_KT, seed=SEED)
    state = MDState(pos0, vel0)
    per_block = {k: n * (MD_STEPS_PER_BLOCK + 1) for k, n in per_call("mega").items()}
    md_launches = {k: 0 for k in per_block}
    t0 = time.perf_counter()
    for b in range(2):
        fused_tp.reset_launch_counts()
        state = sim.run(state, MD_STEPS_PER_BLOCK)
        if fused_tp.LAUNCHES != per_block:
            raise AssertionError(f"l_max 3 MD block {b}: launches {fused_tp.LAUNCHES}")
        for k, n in fused_tp.LAUNCHES.items():
            md_launches[k] += n
    seconds = time.perf_counter() - t0
    ref_state = Simulation(models["einsum"], **kw).run(MDState(pos0, vel0),
                                                       2 * MD_STEPS_PER_BLOCK)
    dpos = float(np.abs(state.positions - ref_state.positions).max())
    print(f"[7d] l_max 3 MD: {2 * MD_STEPS_PER_BLOCK} steps on mega in 2 blocks, "
          f"{1e3 * seconds / (2 * MD_STEPS_PER_BLOCK):.3f} ms/step (first block included); "
          f"max |dpos| vs einsum {dpos:.3e} A (< {MD_TOL}); {smi}")
    if not (np.isfinite(state.positions).all() and dpos < MD_TOL):
        raise AssertionError(f"l_max 3 MD positions vs einsum: {dpos:.3e}")
    fused_tp.reset_launch_counts()
    res = AllegroCalculator(models["mega"], device=dev).calculate(
        pos0, atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC])
    calc_launches = dict(fused_tp.LAUNCHES)
    if calc_launches != per_call("mega"):
        raise AssertionError(f"l_max 3 calculator: launches {calc_launches}")
    f_ref = ref[keys.FORCES][:n_atoms].double().cpu().numpy()
    rel = float(np.abs(res["forces"] - f_ref).max() / np.abs(f_ref).max())
    print(f"    calculator call: energy {res['energy']:.6f}, forces rel {rel:.3e} vs einsum")
    if not rel < 1e-5:
        raise AssertionError(f"l_max 3 calculator forces vs einsum: {rel:.3e}")
    return launches, md_launches, calc_launches


def run_surface(batch_np, n_atoms, n_edges, dev):
    """Phase 7e: one force call of each remaining model configuration on
    fused_infer's default and on pallas, against einsum with the same
    weights, with the exact launch counts (shared env weights: the non-mega
    kernels, as in JAX) and two calls bit for bit."""
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    n_rows = batch_np[keys.POSITIONS].shape[0]
    for name, cfg in SURFACE.items():
        L = cfg["num_layers"]
        einsum = AllegroModel(**cfg, avg_num_neighbors=n_edges / n_atoms,
                              tp_kernel_backend="einsum").init(SEED).to(dev)
        ref = einsum.apply_with_derivatives(
            to_torch(einsum.precompute_statics(batch_np), dtype=torch.float32, device=dev))
        for backend in ("fused_infer", "pallas"):
            m = AllegroModel(**cfg, avg_num_neighbors=n_edges / n_atoms,
                             tp_kernel_backend=backend).to(dev)
            m.load_state_dict(einsum.state_dict())
            config = "pallas" if backend == "pallas" else (
                "mega" if m.module.allegro.mega else "fused readout")
            if name == "shared env weights" and config == "mega":
                raise AssertionError("shared env weights took the mega kernels")
            data = to_torch(m.precompute_statics(batch_np), dtype=torch.float32, device=dev)
            m.apply_with_derivatives(data)
            fused_tp.reset_launch_counts()
            out = m.apply_with_derivatives(data)
            if fused_tp.LAUNCHES != per_call(config, L):
                raise AssertionError(f"{name} on {config}: launches {fused_tp.LAUNCHES}, "
                                     f"expected {per_call(config, L)}")
            print(f"[7e] {name} on {backend} ({config}): launches "
                  f"{ {k: c for k, c in fused_tp.LAUNCHES.items() if c} }")
            check_force_call(out, ref, n_atoms, n_rows)
            if not bitwise_same(out, m.apply_with_derivatives(data)):
                raise AssertionError(f"{name} on {config}: two identical force calls differ")
            del data, out
        del einsum, ref
        torch.cuda.empty_cache()


def fit_rule_cases():
    """The width grid of ``check_fit_rule``: (family, C function, Python
    rule, arguments without the limit). Readouts K = 16..2,016 at H = 1 (no
    hidden layer) to 256; latent MLPs at S = 32..256, U = 16..64, l_max 2
    and 3 bases, the first projection and hidden widths 32..256; the embed
    kernels at U = 16..1,024. Each family reaches both sides of 227 KB."""
    from allegro_tpu_torch.ops import smem_fit as f

    cases = []
    for H in (1, 20, 32, 64, 128, 256):
        for K in range(16, 2049, 40):
            cases.append(("readout_sum", "atpt_readout_sum_smem", f.readout_sum_bytes, (K, H)))
            cases.append(("readout_bwd", "atpt_readout_bwd_smem", f.readout_bwd_bytes,
                          (K, H, int(H > 1))))
    for d2, n_irr in ((9, 3), (16, 4)):
        for U in (16, 32, 64):
            for S in (32, 64, 128, 256):
                N = S + n_irr * U
                mlps = [(0, S, 0)] + [(1, 2 * S + U, H) for H in (32, 64, 128, 256)]
                for hidden, K, H in mlps:
                    cases.append(("latent_env", "atpt_latent_env_scatter_smem",
                                  f.latent_env_scatter_bytes, (hidden, K, H, N, d2, U, n_irr)))
                    cases.append(("latent_env", "atpt_latent_env_bwd_smem",
                                  f.latent_env_bwd_bytes, (hidden, K, H, S, N, d2, U, n_irr)))
        for U in range(16, 1025, 16):
            args = (6 * n_irr, 6 * n_irr, d2, n_irr, d2, d2, d2, U)
            cases.append(("embed", "atpt_gather_tp_embed_smem", f.gather_tp_embed_bytes, args))
            cases.append(("embed", "atpt_bwd_embed_smem", f.bwd_embed_bytes, args))
    return cases


def check_fit_rule(dev):
    """The routing rule (``ops/smem_fit.py``) against the launchers' own
    layout choice (``atpt_*_smem``, the same code the launchers run) over
    ``fit_rule_cases`` at this card's opt-in limit: the same bytes in every
    case, and each family's grid on both sides of the limit."""
    from allegro_tpu_torch.ops import _build, smem_fit

    lib = _build.load_library()
    limit = smem_fit.smem_optin(dev)
    sides = {}
    cases = fit_rule_cases()
    for family, c_name, rule, args in cases:
        c_bytes = getattr(lib, c_name)(*(int(a) for a in args), limit)
        py_bytes = rule(*args, limit)
        if c_bytes != py_bytes:
            raise AssertionError(f"{c_name}{args} at {limit} B: the launcher takes {c_bytes} B, "
                                 f"ops/smem_fit.py says {py_bytes} B")
        fit = sides.setdefault(family, [0, 0])
        fit[c_bytes > limit] += 1
    print(f"[3w] fit rule: {len(cases)} widths, ops/smem_fit.py == the launchers' atpt_*_smem "
          f"bytes at the card's opt-in {limit} B; fits / refused: "
          + ", ".join(f"{k} {a} / {b}" for k, (a, b) in sides.items()))
    for family, (fits, refused) in sides.items():
        if not fits or not refused:
            raise AssertionError(f"{family}: the width grid does not reach both sides of {limit} B")
    return limit


def run_wide_models(batch_np, n_atoms, n_edges, dev, smi):
    """Phase 3w: ``WIDE_MODELS`` on the default ``fused_infer`` path (their
    routes printed and asserted, one force call with its exact launch counts
    held to ``einsum`` as in phase 3, and the µs/atom); returns {model:
    µs/atom}."""
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp, smem_fit

    n_rows = batch_np[keys.POSITIONS].shape[0]
    us = {}
    for name, kw in WIDE_MODELS.items():
        model = AllegroModel(**kw, avg_num_neighbors=n_edges / n_atoms,
                             tp_kernel_backend="fused_infer").init(SEED).to(dev)
        einsum = AllegroModel(**kw, avg_num_neighbors=n_edges / n_atoms,
                              tp_kernel_backend="einsum").to(dev)
        einsum.load_state_dict(model.state_dict())
        ref = einsum.apply_with_derivatives(
            to_torch(einsum.precompute_statics(batch_np), dtype=torch.float32, device=dev))
        data = to_torch(model.precompute_statics(batch_np), dtype=torch.float32, device=dev)
        routes = model.routes()
        print(f"[3w] {name}: routes {routes}")
        if smem_fit.smem_optin(dev) == H100_SMEM_OPTIN and routes != WIDE_ROUTES[name]:
            raise AssertionError(f"{name}: routes {routes}, expected {WIDE_ROUTES[name]}")
        fused_tp.reset_launch_counts()
        out = model.apply_with_derivatives(data)
        want = per_call_routes(routes, kw["num_layers"])
        if fused_tp.LAUNCHES != want:
            raise AssertionError(f"{name}: launches {fused_tp.LAUNCHES}, expected {want}")
        check_force_call(out, ref, n_atoms, n_rows)
        us[name] = time_force_call(model, data, n_atoms)
        print(f"    {name}: {us[name]:.3f} us/atom ({n_atoms} atoms, f32; {smi})")
        del model, einsum, ref, data, out
        torch.cuda.empty_cache()
    return us


def time_force_call(model, data, n_atoms, reps=10):
    for _ in range(2):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps / n_atoms * 1e6


ONE_PHASE = ("8", "9", "10", "11", "12", "13")  # the phases ``--phase`` runs alone


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of allegro_tpu_torch on one GPU.")
    parser.add_argument("--phase", choices=ONE_PHASE,
                        help="run the build and this phase alone (default: every phase)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import _build, fused_tp

    t_start = time.perf_counter()

    def stamp(phase):
        print(f"[t] phase {phase} starts at {time.perf_counter() - t_start:.1f} s")

    # phase 0: device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    tutorial = None
    if args.phase == "9":
        # phase 9d's workdir (a whole run's comes from phase 6d), trained
        # while the kernels build
        tutorial = tempfile.TemporaryDirectory(prefix="chip_smoke_tutorial_")
        train = subprocess.Popen(
            [sys.executable, "-m", "allegro_tpu_torch", "run", "-c", "configs/tutorial.yaml",
             "-w", str(Path(tutorial.name) / "tutorial")], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # phase 1: build
    t0 = time.perf_counter()
    so = _build.build_library()
    _build.load_library()
    print(f"[1] built {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    usage = ptxas_usage(log.read_text()) if log.exists() else {}
    if args.phase:
        try:
            if tutorial is not None:
                out, err = train.communicate(timeout=CLI_TIMEOUT)
                if train.returncode != 0:
                    print(out[-2000:], err[-3000:], file=sys.stderr)
                    raise AssertionError("the tutorial run for phase 9d failed")
            one_phase(args.phase, dev, smi, usage, stamp,
                      tutorial and str(Path(tutorial.name) / "tutorial"))
        finally:
            if tutorial is not None:
                train.kill()
                tutorial.cleanup()
        print(f"[done] phase {args.phase} in {time.perf_counter() - t_start:.1f} s")
        print(smi)
        return 0
    for mangled, (regs, stores, loads) in usage.items():
        print(f"    ptxas: {regs:3d} registers, spill stores {stores} B, loads {loads} B: {mangled}")

    stamp("2")
    # phase 2: kernels at the slice's shapes
    frame, n_atoms = crystal_frame(N_ATOMS, R_MAX, SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    print(f"[2] crystal: {n_atoms} atoms, {n_edges} edges ({n_edges / n_atoms:.2f}/atom)")
    batch_np = batch_frames([frame], n_frames=1)
    fused = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
        use_mega=False, use_fused_readout=False,
    ).init(SEED).to(dev)
    data = to_torch(fused.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    mega = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
    ).to(dev)
    mega.load_state_dict(fused.state_dict())
    if not mega.module.allegro.mega or mega.routes() != FLAGSHIP_ROUTES:
        raise AssertionError(f"the default fused_infer model takes {mega.routes()}, not "
                             f"{FLAGSHIP_ROUTES}")
    records = {}
    rng = np.random.RandomState(SEED)
    check_kernels(fused.module.allegro.tps, data, rng, records)
    stamp("2 mega")
    check_mega_kernels(mega.module.allegro, data, rng, records)
    stamp("2 U16/48")
    for U in (16, 48):
        # the layer kernels at these widths: phase 5a's shape checks
        other = AllegroModel(
            **{**FLAGSHIP, "num_tensor_features": U}, avg_num_neighbors=n_edges / n_atoms,
            tp_kernel_backend="fused_infer",
        ).init(SEED).to(dev)
        check_mega_kernels(other.module.allegro, data, rng)
    check_embed_beyond_the_header(data, rng)
    stamp("2 long")
    check_long_segments(mega, rng, dev)
    stamp("2 center")
    check_center_readout(data, rng, records)
    floor_ms = launch_floor_ms(dev)
    print(f"    launch floor: an empty kernel {floor_ms:.4f} ms under median_ms ({smi})")

    stamp("3")
    # phase 3: the force call — 5 calls per configuration through the kernels
    fused_ro = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
        use_mega=False,
    ).to(dev)
    fused_ro.load_state_dict(fused.state_dict())
    einsum = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="einsum"
    ).to(dev)
    einsum.load_state_dict(fused.state_dict())
    einsum_data = to_torch(einsum.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    ref = einsum.apply_with_derivatives(einsum_data)
    us = {}
    launches = {}
    n_rows = batch_np[keys.POSITIONS].shape[0]
    for config, model in (("mega", mega), ("fused readout", fused_ro), ("plain readout", fused)):
        launches[config], us[config] = drive_force_calls("3", config, model, data, ref, n_atoms,
                                                         n_rows)
    profile_calls(lambda: mega.apply_with_derivatives(data), 3, "flagship, mega")
    us["einsum"] = time_force_call(einsum, einsum_data, n_atoms)
    print("    force call: " + ", ".join(f"{k} {v:.3f} us/atom" for k, v in us.items())
          + f" ({n_atoms} atoms, f32; {smi})")

    stamp("3w")
    # phase 3w: wide models on the default path, routed around the fused
    # kernels whose shared memory they outgrow (ROADMAP F1)
    check_fit_rule(dev)
    run_wide_models(batch_np, n_atoms, n_edges, dev, smi)

    stamp("4")
    # phase 4: the MD and calculator entry points, on the mega model
    md_launches = run_md(mega, einsum, frame, n_atoms, dev, smi)
    calc_launches = run_calculator(mega, frame, n_atoms, dev)
    stamp("4c")
    run_per_type_md(mega, data, frame, n_atoms, n_edges, dev, smi)

    stamp("5")
    # phase 5: training on the trainable `fused` backend
    loaders = train_loaders()
    batch_1k = next(iter(loaders["1k"]))
    train, _ = train_models(batch_1k)
    train_data = to_torch(train.to(dev).precompute_statics(batch_1k), dtype=torch.float32,
                          device=dev)
    print(f"[5] training batch: {int(batch_1k[keys.NODE_MASK].sum())} atoms, "
          f"{int(batch_1k[keys.EDGE_MASK].sum())} edges (padded "
          f"{batch_1k[keys.EDGE_INDEX].shape[1]})")
    check_train_kernels(train.module.allegro.tps, train_data, rng, records)
    stamp("5a U16/48")
    for U in (16, 48):
        other = AllegroModel(**{**FLAGSHIP, "num_tensor_features": U}, avg_num_neighbors=25.0,
                             tp_kernel_backend="fused").init(SEED).to(dev)
        check_train_kernels(other.module.allegro.tps, train_data, rng)
    stamp("5a shapes")
    check_gather_shapes(train_data, rng)
    check_scatter_shapes(train_data, rng)
    check_bwd_shapes(train_data, rng)
    check_readout_shapes(train_data, rng)
    del train_data
    stamp("5b")
    train_launches = run_training(loaders, dev, smi)

    stamp("6")
    # phase 6: the pallas backend (kernels 20 and 21) and the CLI
    pallas = AllegroModel(**FLAGSHIP, avg_num_neighbors=n_edges / n_atoms,
                          tp_kernel_backend="pallas").to(dev)
    pallas.load_state_dict(fused.state_dict())
    print(f"[6] pallas kernels on the crystal's {n_edges} edges")
    check_pallas_kernels(pallas.module.allegro.tps, n_edges, dev, rng, records,
                         untimed_rows=n_edges // 4)
    check_pallas_shapes(n_edges - 1, dev, rng)
    stamp("6b")
    pallas_data = to_torch(pallas.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    launches["pallas"], us["pallas"] = drive_force_calls("6b", "pallas", pallas, pallas_data, ref,
                                                         n_atoms, n_rows)
    print(f"    force call: pallas {us['pallas']:.3f} us/atom, einsum {us['einsum']:.3f} us/atom "
          f"({n_atoms} atoms, f32; {smi})")
    profile_calls(lambda: pallas.apply_with_derivatives(pallas_data), 3, "flagship, pallas")
    del pallas_data
    torch.cuda.empty_cache()
    stamp("6c")
    pallas_train = run_training(loaders, dev, smi, "pallas", PER_STEP_PALLAS, ("6c", "6c"))
    stamp("6d")
    # the CLI's workdirs stay for phase 9d, which compiles the tutorial's
    cli_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    cli = run_cli(smi, dev, cli_dir.name)

    stamp("7")
    # phase 7: kernels 18 and 19, the l_max-3 model and the rest of the surface
    print("[7b] kernel 18 (bwd_fused with dw) and 19 (unweight_both) at the flagship dims")
    check_kernel18(fused.module.allegro.tps, data, rng, records, "flagship", PHASE7_PLAIN_TIMING)
    stamp("7 models")
    models, deep = lmax3_models(n_edges, n_atoms, dev)
    stamp("7a")
    print(f"[7a] kernels at the l_max-3 shapes on the crystal's {n_edges} edges")
    records_l3 = {}
    l3_data = to_torch(models["mega"].precompute_statics(batch_np), dtype=torch.float32,
                       device=dev)
    check_lmax3_kernels(models, deep, l3_data, n_edges, dev, rng, records_l3)
    del deep, l3_data
    torch.cuda.empty_cache()
    stamp("7c")
    l3_launches, l3_md, l3_calc = run_lmax3(models, frame, batch_np, n_atoms, dev, smi)
    del models
    torch.cuda.empty_cache()
    stamp("7e")
    run_surface(batch_np, n_atoms, n_edges, dev)

    stamp("8")
    # phase 8: the 97,336-atom crystal under the JAX bench's policies, and
    # the bf16 forms at the flagship shapes
    bf16_rows = big_system_phase(mega, data, rng, dev, smi)

    stamp("9")
    # phase 9: deployment: the force call as an AOTInductor package, run from
    # Python and from the C++ MD driver; the CLI's compile stage
    pt2_launches = deploy_phase(mega, dev, smi, str(Path(cli_dir.name) / "tutorial"), stamp)
    cli_dir.cleanup()

    stamp("10")
    # phase 10: multi-device MD and data-parallel training on meshes of this card
    parallel = parallel_phase(mega, dev, smi, stamp)

    stamp("11")
    # phase 11: the bf16 tensor track off the mega route
    track_rows = track_phase(fused, batch_np, data, n_atoms, n_edges, loaders, rng, dev, smi)

    stamp("12")
    # phase 12: a bfloat16 model on the serving routes
    model_rows = model_phase(fused, batch_np, frame, data, n_atoms, n_edges, rng, dev, smi)

    stamp("13")
    # phase 13: a bfloat16 model in training
    train_rows = model_train_phase(fused, loaders, rng, dev, smi)

    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(f"launch floor {floor_ms:.4f} ms (an empty kernel under median_ms, phase 2)")
    runs = dict(launches=launches, md=md_launches, calculator=calc_launches, train=train_launches,
                pallas_train=pallas_train, cli=cli, lmax3=l3_launches, lmax3_md=l3_md,
                lmax3_calculator=l3_calc, ptxas=usage, pt2=pt2_launches, parallel=parallel)
    print(json.dumps({"kernels": [kernel_record(row, records, records_l3, runs)
                                  for row in TPU_KERNELS]
                      + bf16_rows + track_rows + model_rows + train_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def one_phase(phase, dev, smi, usage, stamp, tutorial_dir):
    """``--phase``: phase 8 (with 8e), 9, 10, 11, 12 or 13 alone on the
    flagship's models and the 4,096-atom crystal, as ``main`` builds them."""
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel

    frame, n_atoms = crystal_frame(N_ATOMS, R_MAX, SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    batch_np = batch_frames([frame], n_frames=1)
    fused = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
        use_mega=False, use_fused_readout=False,
    ).init(SEED).to(dev)
    data = to_torch(fused.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    mega = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
    ).to(dev)
    mega.load_state_dict(fused.state_dict())
    rng = np.random.RandomState(SEED)
    stamp(phase)
    if phase == "8":
        rows, forms = big_system_phase(mega, data, rng, dev, smi), BF16_KERNELS
    elif phase == "9":
        deploy_phase(mega, dev, smi, tutorial_dir, stamp)
        return
    elif phase == "10":
        for run, counts in parallel_phase(mega, dev, smi, stamp).items():
            print(f"launches {run}: {sum(counts.values())} ({counts})")
        return
    elif phase == "11":
        rows = track_phase(fused, batch_np, data, n_atoms, n_edges, train_loaders(), rng, dev,
                           smi)
        forms = TRACK_KERNELS
    elif phase == "12":
        rows = model_phase(fused, batch_np, frame, data, n_atoms, n_edges, rng, dev, smi)
        forms = MODEL_FORMS
    else:
        rows = model_train_phase(fused, train_loaders(), rng, dev, smi)
        forms = [(n, name.split("[")[0]) for n, name in MODEL_TRAIN_FORMS]
    for _, name in forms:
        print(f"    ptxas {name}: {kernel_ptxas(name, usage)}")
    print(json.dumps(rows))


def ptxas_usage(log):
    """Registers and spill bytes of each entry function in nvcc's ``-Xptxas
    -v`` output: {mangled name: [registers, spill stores, spill loads]}."""
    usage, current, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            usage[current] = [0, 0, 0]
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in usage:
            usage[props][1:] = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current in usage:
            usage[current][0] = int(m.group(1))
    return usage


def kernel_ptxas(name, usage):
    """The ptxas records of the entry functions of wrapper ``name``'s kernel
    (``<name>_kernel``, its ``_partial`` first pass, and the center
    kernels' forms ``_narrow``, ``_segments``, ``_rows``, ``_chunks`` and
    ``_partials``; ``<true>`` / ``<false>``, ``<4>``, ``<true, 64>``,
    ``<float4>``, ``<bf16>``: the instantiations of its bool, int, vector-
    and storage-type template parameters)."""
    out = []
    forms = "partial|narrow|segments|rows|chunks|partials|bf16"
    for mangled, (regs, stores, loads) in usage.items():
        m = re.search(rf"\d({re.escape(name)}(?:_(?:{forms}))?_kernel)"
                      r"(I((?:L[bi]\d+E|f|6float4|13__nv_bfloat16|S\d*_)+)E)?", mangled)
        if m:
            types = {"f": "float", "6float4": "float4", "13__nv_bfloat16": "bf16"}
            args = []
            # S<n>_ repeats a type named before it (the only repeat here:
            # the last storage type, as in <4, bf16, bf16>)
            for b, v, t in re.findall(r"L([bi])(\d+)E|(f|6float4|13__nv_bfloat16|S\d*_)",
                                      m.group(3) or ""):
                if v:
                    args.append({"b1": "true", "b0": "false"}.get(b + v, v))
                else:
                    args.append(types.get(t) or next(a for a in reversed(args)
                                                     if a in types.values()))
            tag = f"<{', '.join(args)}>" if any(args) else ""
            out.append({"kernel": m.group(1) + tag, "registers": regs, "spill_stores": stores,
                        "spill_loads": loads})
    return out


def kernel_record(row, records, records_l3, runs):
    """One entry of the ``kernels`` JSON line (see the module docstring)."""
    n, key, replaces = row
    name = key.split("[")[0]
    rec = records[key]
    launches = runs["launches"]
    # the four layer kernels (and 19) are timed on the use_mega=False path,
    # where all their launches are; the trainable backend's on the training
    # step; sparse_tp on the pallas force call, sparse_tp_gradw on the pallas
    # training step; 18 on no path (JAX runs it on none); the rest on mega
    if n == 18:
        config = "none (not on a user path)"
    elif name == "sparse_tp":
        config = "pallas"
    elif name == "sparse_tp_gradw":
        config = "pallas train step"
    elif name in TRAIN_KERNELS or n == 13:
        config = "train step"
    else:
        config = "fused readout" if name in LAYER_KERNELS else "mega"
    # every launch of the force calls of all configurations and of the 1k
    # batch's training steps on both backends (18: none, no user path runs it)
    count = 0 if n == 18 else (sum(c[name] for c in launches.values())
                               + runs["train"]["1k"][name] + runs["pallas_train"]["1k"][name])
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    # kernel 18 (bwd_fused with dw) is a kernel of its own, bwd_fused_dw_kernel
    entry = "bwd_fused_dw" if key == "bwd_fused[dw]" else name
    out = {"name": key, "route": "cuda", "source": SOURCES.get(key, SOURCES[name]),
           "replaces": replaces, "tpu_kernel": n, "launches": count,
           "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": rec["library_ms"],
           "ms_config": config, "ptxas": kernel_ptxas(entry, runs["ptxas"])}
    for config in PER_CALL:
        out["launches_" + config.replace(" ", "_")] = launches[config][name]
    for run in ("md", "calculator", "lmax3_md", "lmax3_calculator"):
        out["launches_" + run] = runs[run][name]
    for package, counts in runs["pt2"].items():
        out[f"launches_pt2_{package}_call"] = counts.get(name, 0)
    for run, counts in runs["parallel"].items():
        out[f"launches_parallel_{run}"] = counts.get(name, 0)
    for batch, counts in runs["train"].items():
        out[f"launches_train_{batch}"] = counts[name]
    for batch, counts in runs["pallas_train"].items():
        out[f"launches_train_pallas_{batch}"] = counts[name]
    for run, counts in runs["cli"].items():
        out[f"launches_cli_{run}"] = counts[name]
    for config, counts in runs["lmax3"].items():
        out["launches_lmax3_" + config.replace(" ", "_")] = counts[name]
    l3 = records_l3.get(key)
    if l3 is not None:
        out["max_abs_err_lmax3"], out["ms_lmax3"] = l3["max_abs_err"], l3["ms"]
        out["plain_ms_lmax3"] = l3["plain_ms"]
        out["bound_ms_lmax3"], out["bound_by_lmax3"] = bound(l3["bytes"], l3["flops"])
    # the pair of launches that computes the same function, timed beside it
    for suffix, recs in (("", records), ("_lmax3", records_l3)):
        if f"{key}[pair]" in recs:
            out["pair_ms" + suffix] = recs[f"{key}[pair]"]["ms"]
    if key == name:
        for variant_key, variant in records.items():
            if variant_key.startswith(name + "["):
                tag = variant_key[len(name) + 1:-1]
                v_bound, v_by = bound(variant["bytes"], variant["flops"])
                out[f"max_abs_err_{tag}"] = variant["max_abs_err"]
                out[f"ms_{tag}"], out[f"plain_ms_{tag}"] = variant["ms"], variant["plain_ms"]
                out[f"bound_ms_{tag}"], out[f"bound_by_{tag}"] = v_bound, v_by
                out[f"library_ms_{tag}"] = variant["library_ms"]
    return out


# phase 8: the JAX bench's headline system (us_per_atom_100k,
# allegro_tpu/bench.py:160-184): the 46^3 crystal under its 100k policy
BIG_ATOMS = 97_336
POLICY_100K = dict(tensor_dtype="bfloat16", remat=True, checkpoint_energy=True, precision="high",
                   features_layout="flat_dim_major")
# the reference's compiled-model acceptance (tests/model/test_bf16_storage.py:26-33, :60-64):
# max(|df| - rtol |f_ref|) <= atol
REF_ATOL = REF_RTOL = 5e-5
STREAM_CHUNKS = 8
# the streamed evaluator against the monolithic call (tests/md/test_streaming.py:76-78)
STREAM_F_TOL = dict(rtol=1e-4, atol=1e-5)
STREAM_V_TOL = dict(rtol=1e-3, atol=1e-4)
BIG_REPS = 3  # timed force calls per policy (after two warm-up calls)
# the kernels of the mega path (each launched in every force call on it)
MEGA_PATH = ("latent_env_scatter", "latent_env_bwd", "gather_tp_embed", "bwd_embed", "gather_tp",
             "bwd_fused", "center_gather", "center_sum", "readout_sum", "readout_bwd")
# the bf16 forms (kernels 2, 3, 7-10) and their TPU kernels
BF16_KERNELS = [(2, "gather_tp"), (3, "bwd_fused"), (7, "latent_env_scatter"),
                (8, "latent_env_bwd"), (9, "gather_tp_embed"), (10, "bwd_embed")]
# the share of a bf16 form's stored bfloat16 outputs that may differ from the
# plain version's bits: a float32 sum that differs by ~1e-7 of its value
# crosses a bf16 rounding boundary in ~1e-7 / 2^-8 of the outputs (0.007%
# read for gather_tp at the flagship shapes, NVIDIA H100 80GB HBM3, 700 W)
BF16_DIFFER_MAX = 0.01


def bf16_ulp(ref):
    """The spacing of bfloat16 numbers at |ref| (float64): 2^(e - 7) for
    |ref| in [2^e, 2^(e+1)), the subnormal spacing below 2^-126."""
    a = ref.double().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_gate(got, ref, slack=None):
    """Holds a bf16 form's outputs to its plain version's on the same bf16
    inputs: each float32 output within KERNEL_TOL of its max |ref| (plus
    ``slack``, a per-element bound of the rounding flips a float32 output
    sums, where given: {output index: bound}), each bfloat16 output within
    1 bf16 ulp (at the larger of the two magnitudes: the two roundings, half
    an ulp each) of the reference beyond that same float32 tolerance (the
    kernel's float32 sum may differ from the plain one's by that much before
    it is rounded: near a sum that cancels, that is many ulps of a small
    result), and at most BF16_DIFFER_MAX of the bfloat16 outputs not the
    same bits (a store that truncates, or rounds the wrong way, would differ
    in about half). Returns (ok, worst ulps, rel, max abs error, outputs not
    the same bits, outputs, bfloat16 outputs not the same bits, bfloat16
    outputs)."""
    slack = slack or {}
    worst_ulps, rel, abs_err, differ, total, differ16, total16 = 0.0, 0.0, 0.0, 0, 0, 0, 0
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.dtype != b.dtype:
            raise AssertionError(f"output {i} is {a.dtype}, the plain version's {b.dtype}")
        d = (a.double() - b.double()).abs()
        n = int((a != b).sum())
        differ += n
        total += a.numel()
        abs_err = max(abs_err, d.max().item())
        scale = max(b.double().abs().max().item(), 1e-30)
        if a.dtype == torch.bfloat16:
            differ16 += n
            total16 += a.numel()
            over = (d - KERNEL_TOL * scale).clamp_min(0.0)
            worst_ulps = max(worst_ulps, (over / bf16_ulp(torch.maximum(a.abs(), b.abs())))
                             .max().item())
        else:
            over = d - slack.get(i, torch.zeros((), device=d.device))
            rel = max(rel, over.max().item() / scale)
    share16 = differ16 / max(total16, 1)
    ok = worst_ulps <= 1.0 and rel < KERNEL_TOL and share16 <= BF16_DIFFER_MAX
    return ok, worst_ulps, rel, abs_err, differ, total, differ16, total16


def check_bf16_case(name, kernel, plain, f32_form, label, records, reads, flops, slack=None,
                    timed=True, tells_apart=False, exact=None, library=None, plain_timing=None,
                    exact_bits=False):
    """One bf16 form against its plain version on the same bf16 inputs
    (``bf16_gate``). Prints the share of outputs that are not the same
    bits, and, where ``timed``, the median device times of the form, its
    plain version and the float32 form (``f32_form``) on the same values,
    beside the bound (the track's elements at 2 B). ``tells_apart``: the
    float32 form's outputs (the same dtypes, unrounded) must fail the same
    gate, so the gate is shown to see the rounding. ``exact``: the plain
    version in float64, which the form is then held to, its outputs rounded
    once to the form's dtypes (``plain`` is only timed). ``library``: one
    PyTorch call computing the same function, timed beside them.
    ``plain_timing``: median_ms's keyword arguments for the plain version
    (default ``PLAIN_TIMING``). ``exact_bits``: the form's outputs must be
    the plain version's, dtypes and bits."""
    got = kernel()
    want = (exact or plain)()
    ref = tuple(r.to(g.dtype) for r, g in zip(want, got))
    ok, worst_ulps, rel, abs_err, differ, total, differ16, total16 = bf16_gate(got, ref, slack)
    share, share16 = differ / max(total, 1), differ16 / max(total16, 1)
    if exact_bits:
        ok = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        print(f"  {label} {name + '[bf16]':22s} {'the same' if ok else 'NOT the same'} dtypes "
              f"and bits as its plain version ({differ} of {total} outputs differ)", end="")
    else:
        print(f"  {label} {name + '[bf16]':22s} max_abs_err {abs_err:.3e}, bf16 outputs within "
              f"{worst_ulps:.2f} ulp (<= 1), f32 outputs rel {rel:.3e} (< {KERNEL_TOL}), "
              f"not the same bits {100 * share:.4f}% (bf16 outputs {100 * share16:.4f}%, <= "
              f"{100 * BF16_DIFFER_MAX:g}%) {'ok' if ok else 'FAIL'}", end="")
    if not ok:
        print()
        raise AssertionError(f"{name}[bf16] ({label}) disagrees with its plain version")
    if tells_apart:
        unrounded = bf16_gate(f32_form(), ref, slack)
        print(f"; the f32 form fails the gate (f32 outputs rel {unrounded[2]:.3e})", end="")
        if unrounded[0]:
            print()
            raise AssertionError(f"{name}[bf16] ({label}): the f32 form passes the bf16 gate")
    if not timed:
        print()
        return
    ms, f32_ms = median_ms(kernel), median_ms(f32_form)
    plain_ms = median_ms(plain, **(plain_timing or PLAIN_TIMING))
    work = nbytes(*reads, *got)
    bound_ms, bound_by = bound(work, flops)
    print(f"  kernel {ms:.4f} ms (f32 form {f32_ms:.4f})  plain {plain_ms:.4f} ms  bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                                    "flops": 0, "library_ms": None, "ms_f32": 0.0,
                                    "ulps": 0.0, "differ": 0, "outputs": 0, "differ16": 0,
                                    "outputs16": 0})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["ms_f32"] += f32_ms
    rec["bytes"] += work
    rec["flops"] += flops
    rec["ulps"] = max(rec["ulps"], worst_ulps)
    rec["differ"] += differ
    rec["outputs"] += total
    rec["differ16"] += differ16
    rec["outputs16"] += total16
    if library is not None:
        lib_ms = median_ms(library)
        rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
        print(f"  library {lib_ms:.4f} ms")


def same_bits(rec):
    """A bf16 form's row keys for its outputs that are not the plain
    version's bits: ``not_same_bits`` the share of its bfloat16-stored
    outputs (null where it stores none), ``not_same_bits_all`` of all its
    outputs (float32 sums in another order than the plain version's differ
    in most of their bits, and are held to KERNEL_TOL instead)."""
    return {"not_same_bits": rec["differ16"] / rec["outputs16"] if rec["outputs16"] else None,
            "not_same_bits_all": rec["differ"] / max(rec["outputs"], 1)}


def flip_ulps(w):
    """Per element of the float32 env weights ``w`` (the plain MLP's): the
    bf16 ulp where a value within the float32 tolerance (KERNEL_TOL of
    max |w|) of ``w`` may round to another bfloat16 than ``w`` does (the
    kernel's MLP sums in another order), else 0."""
    from allegro_tpu_torch.ops import fused_tp

    w = w.double()
    tau = KERNEL_TOL * w.abs().max().item()
    up = fused_tp.round_to(w + tau, torch.bfloat16).double()
    down = fused_tp.round_to(w - tau, torch.bfloat16).double()
    return torch.where(up != down, bf16_ulp(torch.maximum(up.abs(), down.abs())),
                       torch.zeros_like(w)).float()


def check_bf16_kernels(allegro, data, rng, records):
    """Phase 8e: the bf16 forms of kernels 2, 3 and 7-10 at the flagship's
    4,096-atom shapes on the mega model's weights, each against its plain
    version on the same bf16 inputs (``check_bf16_case``), and timed beside
    its float32 form; one launch per layer of the bf16 policy's force call
    (gather_tp and bwd_fused at layer 1's dims, the latent kernels on the
    first projection and layer 0's latent)."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    bf = torch.bfloat16
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E, Er = centers.shape[0], int(data[keys.EDGE_MASK].sum())
    S, U = allegro.S, allegro.U
    tp0, tp1 = allegro.tps[0], allegro.tps[1]
    d2i, specs = tp0.dim_to_irr, allegro.row_specs
    n_irr = tp0.n_irr

    def rand(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    label = f"U {U} E {E}"
    # kernels 7 and 8: the env weights rounded to bf16 inside the kernel. The
    # kernel's float32 MLP sums in another order than the plain version's, so
    # a weight within the float32 tolerance of a bf16 rounding midpoint may
    # round the other way: each env sum (and dsh) may differ by one bf16 ulp
    # of each such weight it reads, which the slack bounds (flip_ulps). A
    # kernel that did not round would miss by up to half an ulp of every
    # weight: the f32 form must fail the same gate (tells_apart)
    sh, emb, ts = rand(E, tp0.d2), rand(E, S), rand(E, U)
    t, g_lat = rand(n_atoms, tp0.d2 * U), rand(E, S)
    (w_proj,) = allegro.first_projection.weights()
    w0, w1 = allegro.latents[0].weights()
    for pieces, a, b in (((emb,), w_proj.detach(), None), ((emb, ts), w0.detach(), w1.detach())):
        what = f"{label} W0 {list(a.shape)}" + ("" if b is None else f" W1 {list(b.shape)}")
        mlp = a.shape[0] * a.shape[1] + (0 if b is None else b.shape[0] * b.shape[1])
        env_flops = 2 * Er * tp0.d2 * U
        ulp = flip_ulps(fused_tp._edge_mlp(pieces, a, b)[1][:, S:])
        env_slack = fused_tp.env_scatter_reference(sh.abs(), ulp, centers, n_atoms, d2i, U)
        dsh_slack = fused_tp.unweight_sh_reference(t.abs(), ulp, centers, d2i)
        check_bf16_case(
            "latent_env_scatter",
            lambda: fused_tp.latent_env_scatter(pieces, sh, a, b, centers, row_ptr, d2i, U, S,
                                                tp0.irr_ranges, bf),
            lambda: fused_tp.latent_env_scatter_reference(pieces, sh, a, b, row_ptr, d2i, U, S,
                                                          bf),
            lambda: fused_tp.latent_env_scatter(pieces, sh, a, b, centers, row_ptr, d2i, U, S,
                                                tp0.irr_ranges),
            what, records, (*pieces, sh, a, b, centers, row_ptr, tp0.irr_ranges),
            2 * E * mlp + env_flops, {1: env_slack.double()}, tells_apart=True)
        check_bf16_case(
            "latent_env_bwd",
            lambda: _flat(fused_tp.latent_env_bwd(pieces, sh, a, b, t, g_lat, centers, d2i, U, S,
                                                  tp0.irr_ranges, bf)),
            lambda: _flat(fused_tp.latent_env_bwd_reference(pieces, sh, a, b, t, g_lat, centers,
                                                            d2i, U, S, bf)),
            lambda: _flat(fused_tp.latent_env_bwd(pieces, sh, a, b, t, g_lat, centers, d2i, U, S,
                                                  tp0.irr_ranges)),
            what, records, (*pieces, sh, a, b, t, g_lat, centers, d2i),
            4 * E * mlp + 2 * env_flops, {0: dsh_slack.double()}, tells_apart=True)
    # kernels 9 and 10 at layer 0: out stored in bf16, g read in bf16
    wk, idx, coef = (v.detach() for v in tp0.fused_infer_parts(torch.float32))
    w2b, env = rand(E, n_irr * U), rand(n_atoms, tp0.d2 * U)
    g, gts = rand(E, tp0.d3 * U, dtype=bf), rand(E, U)
    g32 = g.float()  # the float32 form's input, widened once, outside the timing
    paths = tp0.cg_paths()
    what = f"{label} dims ({tp0.d1},{tp0.d2},{tp0.d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    check_bf16_case(
        "gather_tp_embed",
        lambda: fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, row_ptr, idx, coef, specs,
                                         tp0.d3, True, paths, bf),
        lambda: fused_tp.gather_tp_embed_reference(sh, w2b, env, wk, centers, idx, coef, specs,
                                                   tp0.d3, True, bf),
        lambda: fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, row_ptr, idx, coef, specs,
                                         tp0.d3, True, paths),
        what, records, (sh, w2b, env, wk, row_ptr, *paths, specs), tp_flops + Er * tp0.d1 * U)
    check_bf16_case(
        "bwd_embed",
        lambda: fused_tp.bwd_embed(sh, w2b, g, env, wk, centers, row_ptr, idx, coef, specs, gts,
                                   paths),
        lambda: fused_tp.bwd_embed_reference(sh, w2b, g, env, wk, centers, n_atoms, idx, coef,
                                             specs, gts),
        lambda: fused_tp.bwd_embed(sh, w2b, g32, env, wk, centers, row_ptr, idx, coef,
                                   specs, gts, paths),
        what, records, (sh, w2b, g, gts, env, wk, row_ptr, idx, coef, specs),
        2 * tp_flops + 4 * Er * tp0.d1 * U)
    # kernels 2 and 3 at layer 1 (the path's): x, out, g and dx in bf16
    wk, idx, coef = (v.detach() for v in tp1.fused_infer_parts(torch.float32))
    walk, swapped, scatter = tp1.infer_paths()
    x, g = rand(E, tp1.d1 * U, dtype=bf), rand(E, tp1.d3 * U, dtype=bf)
    x32, g32 = x.float(), g.float()
    what = f"{label} dims ({tp1.d1},{tp1.d2},{tp1.d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    check_bf16_case(
        "gather_tp",
        lambda: (fused_tp.gather_tp(x, env, wk, centers, idx, coef, tp1.d3, paths=walk),),
        lambda: (fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, tp1.d3),),
        lambda: (fused_tp.gather_tp(x32, env, wk, centers, idx, coef, tp1.d3, paths=walk),),
        what, records, (x, env, wk, centers, *walk), tp_flops)
    check_bf16_case(
        "bwd_fused",
        lambda: fused_tp.bwd_fused(x, g, env, wk, centers, row_ptr, idx, coef, paths=swapped,
                                   scatter_paths=scatter),
        lambda: fused_tp.bwd_fused_reference(x, g, env, wk, centers, n_atoms, idx, coef),
        lambda: fused_tp.bwd_fused(x32, g32, env, wk, centers, row_ptr, idx, coef,
                                   paths=swapped, scatter_paths=scatter),
        what, records, (x, g, env, wk, row_ptr, *swapped, *scatter), 2 * tp_flops)
    # checks only: gather_tp with its split output and bwd_fused with gts at
    # layer-0 dims (a deeper model's middle layers)
    wk, idx, coef = (v.detach() for v in tp0.fused_infer_parts(torch.float32))
    walk, swapped, scatter = tp0.infer_paths()
    x, g = rand(E, tp0.d1 * U, dtype=bf), rand(E, tp0.d3 * U, dtype=bf)
    check_bf16_case(
        "gather_tp[split]",
        lambda: fused_tp.gather_tp(x, env, wk, centers, idx, coef, tp0.d3, True, walk),
        lambda: fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, tp0.d3, True),
        None, f"{label} layer-0 dims", records, (), 0, timed=False)
    check_bf16_case(
        "bwd_fused[gts]",
        lambda: fused_tp.bwd_fused(x, g, env, wk, centers, row_ptr, idx, coef, gts,
                                   paths=swapped, scatter_paths=scatter),
        lambda: fused_tp.bwd_fused_reference(x, g, env, wk, centers, n_atoms, idx, coef, gts),
        None, f"{label} layer-0 dims", records, (), 0, timed=False)


def run_100k(dev, smi):
    """Phase 8: the 97,336-atom crystal (native cell list) on the flagship's
    mega path: (a) the f32 force call, (b) the JAX bench's 100k policy (bf16
    track, "high", remat, checkpoint_energy), (c) remat and
    checkpoint_energy in f32, (d) ``StreamedEvaluator`` at f32 with K = 8;
    each with µs/atom (host clock), device busy (torch.profiler) and peak
    memory, freed between them. Returns the launches of one force call of
    each and of the streamed call (each kernel of the mega path at least
    once)."""
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.data.neighborlist import NEIGHBOR_LISTS, reset_neighbor_list_counts
    from allegro_tpu_torch.md.streaming import StreamedEvaluator
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    reset_neighbor_list_counts()
    t0 = time.perf_counter()
    frame, n_atoms = crystal_frame(BIG_ATOMS, R_MAX, SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    lists = dict(NEIGHBOR_LISTS)
    print(f"[8] crystal: {n_atoms} atoms, {n_edges} edges ({n_edges / n_atoms:.2f}/atom), "
          f"list {lists} in {time.perf_counter() - t0:.1f} s; {smi}")
    if lists.get("native", 0) != 1:
        raise AssertionError(f"the 100k list did not come from the native cell list: {lists}")
    batch_np = batch_frames([frame], n_frames=1)
    kw = dict(**FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer")
    f32 = AllegroModel(**kw).init(SEED).to(dev)
    policies = {"f32": {}, "100k policy": POLICY_100K,
                "remat f32": dict(remat=True, checkpoint_energy=True)}
    t0 = time.perf_counter()
    data = to_torch(f32.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    print(f"    statics on the host and the batch on the card in {time.perf_counter() - t0:.1f} s")
    launches, results = {}, {}
    ref = None
    for name, policy in policies.items():
        model = AllegroModel(**kw, **policy).to(dev)
        model.load_state_dict(f32.state_dict())
        if model.routes() != FLAGSHIP_ROUTES:
            raise AssertionError(f"{name}: routes {model.routes()}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**20
        fused_tp.reset_launch_counts()
        out = model.apply_with_derivatives(data)
        torch.cuda.synchronize()
        launches[name] = dict(fused_tp.LAUNCHES)
        launches[name + " bf16"] = dict(fused_tp.BF16_LAUNCHES)
        peak = peak_mib()
        missing = [k for k in MEGA_PATH if launches[name][k] == 0]
        if missing:
            raise AssertionError(f"{name}: the force call launched no {missing}")
        # the track is bf16 in this call iff every launch of the six kernels
        # that read or write it ran its bf16 form (gather_tp_embed stores
        # layer 0's features, gather_tp reads and stores the later layers',
        # bwd_fused and bwd_embed read their cotangents; 7 and 8 round the
        # env weights), and none does in f32
        bf16 = launches[name + " bf16"]
        track = {k for _, k in BF16_KERNELS}
        want = {k: launches[name][k] if policy.get("tensor_dtype") and k in track else 0
                for k in bf16}
        if bf16 != want:
            raise AssertionError(f"{name}: bf16 form launches {bf16}, expected {want}")
        for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
        if out[keys.FORCES].shape != (batch_np[keys.POSITIONS].shape[0], 3):
            raise AssertionError(f"{name}: forces shape {tuple(out[keys.FORCES].shape)}")
        again = model.apply_with_derivatives(data)
        if not bitwise_same(out, again):
            raise AssertionError(f"{name}: two identical force calls differ")
        del again
        forces = out[keys.FORCES][:n_atoms]
        line = (f"    {name}: launches per call { {k: c for k, c in launches[name].items() if c} }"
                f", of them bf16 forms { {k: c for k, c in bf16.items() if c} }"
                f"; two calls the same bits")
        if ref is None:
            ref = {k: out[k] for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL,
                                       keys.PER_ATOM_ENERGY)}
        elif name == "100k policy":
            # the reference allclose form: max(|f - f_ref| - REF_RTOL |f_ref|)
            f_ref = ref[keys.FORCES][:n_atoms].double()
            margin = ((forces.double() - f_ref).abs() - REF_RTOL * f_ref.abs()).max().item()
            line += f"; forces vs f32: margin {margin:.3e} (<= {REF_ATOL})"
            if not margin <= REF_ATOL:
                raise AssertionError(f"the 100k policy's forces miss the reference allclose: "
                                     f"margin {margin:.3e}")
        else:
            if not bitwise_same(out, ref):
                raise AssertionError(f"{name}: not the same bits as the f32 call")
            line += "; the same bits as the f32 call"
        print(line)
        del out
        us = time_force_call(model, data, n_atoms, reps=BIG_REPS)
        prof = profile_calls(lambda: model.apply_with_derivatives(data), 2, f"100k, {name}")
        results[name] = dict(us_per_atom=us, peak_mib=peak, inputs_mib=base,
                             busy_ms=None if prof is None else prof[0],
                             idle_pct=None if prof is None else prof[1])
        print(f"    {name}: {us:.3f} us/atom (host clock, {BIG_REPS} calls), peak "
              f"{peak:.0f} MiB allocated ({base:.0f} MiB before the call), busy "
              f"{results[name]['busy_ms']} ms per call ({n_atoms} atoms; {smi})")
        del model
    del data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    ev = StreamedEvaluator(f32, batch_np, STREAM_CHUNKS, with_stress=True, device=dev)
    print(f"[8d] streamed: {STREAM_CHUNKS} chunks of up to "
          f"{ev.stacked[keys.EDGE_INDEX].shape[2]} edges and "
          f"{ev.stacked[keys.ATOM_TYPES].shape[1]} atom rows, built in "
          f"{time.perf_counter() - t0:.1f} s")
    pos = torch.as_tensor(batch_np[keys.POSITIONS], device=dev).float()
    ev(pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_tp.reset_launch_counts()
    e, f, v = ev(pos)
    torch.cuda.synchronize()
    launches["streamed"] = dict(fused_tp.LAUNCHES)
    peak = peak_mib()
    missing = [k for k in MEGA_PATH if launches["streamed"][k] == 0]
    if missing:
        raise AssertionError(f"streamed: the call launched no {missing}")
    f_ref, v_ref = ref[keys.FORCES][:n_atoms].double(), ref[keys.VIRIAL][0].double()
    df = (f[:n_atoms].double() - f_ref).abs()
    dv = (v.double() - v_ref).abs()
    f_ok = bool((df <= STREAM_F_TOL["atol"] + STREAM_F_TOL["rtol"] * f_ref.abs()).all())
    v_ok = bool((dv <= STREAM_V_TOL["atol"] + STREAM_V_TOL["rtol"] * v_ref.abs()).all())
    de = abs(e.item() - ref[keys.TOTAL_ENERGY].sum().item())
    print(f"    streamed vs the f32 call: energy |dE| {de:.3e}, forces max |df| "
          f"{df.max().item():.3e} ({'ok' if f_ok else 'FAIL'} at {STREAM_F_TOL}), virial max "
          f"|dv| {dv.max().item():.3e} ({'ok' if v_ok else 'FAIL'} at {STREAM_V_TOL})")
    if not (f_ok and v_ok):
        raise AssertionError("the streamed evaluator disagrees with the monolithic call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BIG_REPS):
        ev(pos)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / BIG_REPS / n_atoms * 1e6
    prof = profile_calls(lambda: ev(pos), 2, "100k, streamed")
    results["streamed"] = dict(us_per_atom=us, peak_mib=peak, inputs_mib=base,
                               busy_ms=None if prof is None else prof[0],
                               idle_pct=None if prof is None else prof[1])
    print(f"    streamed: {us:.3f} us/atom (host clock, {BIG_REPS} calls), peak {peak:.0f} MiB "
          f"allocated ({base:.0f} MiB before the call), busy {results['streamed']['busy_ms']} ms "
          f"per call ({n_atoms} atoms; {smi})")
    print("    100k: " + json.dumps({"atoms": n_atoms, "edges": n_edges, "card": smi,
                                    "policies": results}))
    del ev, ref
    torch.cuda.empty_cache()
    return launches


def big_system_phase(mega, data, rng, dev, smi):
    """Phases 8 (``run_100k``) and 8e (``check_bf16_kernels`` on the
    flagship ``mega`` model at the shapes of ``data``). Returns the kernels
    line's rows of the bf16 forms."""
    launches = run_100k(dev, smi)
    print("[8e] the bf16 forms of kernels 2, 3, 7-10 at the flagship shapes")
    records = {}
    check_bf16_kernels(mega.module.allegro, data, rng, records)
    return [bf16_record(n, name, records, launches) for n, name in BF16_KERNELS]


def bf16_record(n, name, records, launches):
    """The kernels line's row of kernel ``n``'s bf16 form (``name[bf16]``):
    its times at the flagship shapes (phase 8e) and its launches in one
    force call of the 100k policy (phase 8b; ``fused_tp.BF16_LAUNCHES``)."""
    rec = records[name]
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    replaces = next(r for k, _, r in TPU_KERNELS if k == n)
    return {"name": f"{name}[bf16]", "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "tpu_kernel": n, "launches": launches["100k policy bf16"][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": rec["library_ms"],
            "ms_f32_form": rec["ms_f32"], "max_ulps": rec["ulps"],
            **same_bits(rec),
            "ms_config": "bf16 form at the flagship shapes (4,096 atoms), one launch per layer",
            "launches_config": "one force call of the 100k policy (97,336 atoms)"}


# phase 11: the bf16 tensor track off the mega route (ROADMAP item 6)
TRACK_KERNELS = [(1, "env_scatter"), (4, "unweight_both"), (14, "tp_scatter"), (15, "gather_dw"),
                 (16, "unweight_sh"), (17, "unweight_w")]
TRACK_WIDE = "S256, latent 256"  # phase 3w's widest model
# bf16 launches per force call under POLICY_100K (2 layers): remat and
# checkpoint_energy run each layer's forward three times (the call, the
# energy's recompute in the backward pass, remat's recompute inside that),
# its backward once. use_mega=False (JAX's non-mega path): the track from
# the entry on, every launch of the four layer kernels a bf16 form. The
# routed model (JAX's mega path): layer 0 reads unrounded float32 features
# (its gather_tp and bwd_fused are the float32 forms), every env_scatter and
# unweight_both reads the env weights in bfloat16
TRACK_CALL = {"env_scatter": 6, "gather_tp": 6, "bwd_fused": 2, "unweight_both": 2}
TRACK_ROUTED_CALL = {"env_scatter": 6, "gather_tp": 3, "bwd_fused": 1, "unweight_both": 2}
# the use_mega=False call of the 100k policy against the float64 oracle:
# JAX's non-mega path stores layer 0's input features in bfloat16 (its
# tensor embed casts them; the mega path builds them in float32 in the
# kernel), which alone takes the reference allclose's margin past 5e-5 on
# a few hundred atoms. JAX's own non-mega call, on the CPU with these
# weights (tests/test_torch_precision.py::
# test_the_100k_policy_off_the_mega_path_is_as_close_as_jaxs_own): margin
# 8.33e-5 on this crystal cut to 216 atoms, 9.42e-5 on its 4,096, its energy
# 3.14e-5 of sum |E_i| there (1.44e-2 of the cancelling |E|). Held to the
# allclose at this tolerance, both sides, and its 5e-5 margin printed; each
# call's energy within its force tolerance of sum |E_i|
OFF_MEGA_TOL = 2e-4
TRACK_TRAIN_STEPS = 3


def check_track_kernels(tps, data, rng, records):
    """Phase 11a: the bf16 forms of kernels 1, 4 and 14-17 at the flagship's
    4,096-atom shapes, each against its plain version on the same bf16
    inputs (``check_bf16_case``) and timed beside its float32 form: the env
    weights' kernels (1, 4, 16, 17) on layer 0's basis, ``tp_scatter`` and
    ``gather_dw`` on layer 1's table (the layer 8e times ``gather_tp`` and
    ``bwd_fused`` on); untimed, ``unweight_both`` with a float32 dwexp and
    ``tp_scatter`` and ``gather_dw`` on layer 0's table."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    bf = torch.bfloat16
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E, Er = centers.shape[0], int(data[keys.EDGE_MASK].sum())
    tp0, tp1 = tps[0], tps[1]
    U, d2, n_irr, d2i = tp0.mul, tp0.d2, tp0.n_irr, tp0.dim_to_irr

    def rand(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    label = f"U {U} E {E}"
    sh, wexp, t = rand(E, d2), rand(E, n_irr * U, dtype=bf), rand(n_atoms, d2 * U)
    wexp32 = wexp.float()  # the float32 forms' inputs, widened once, outside the timing
    env_flops = 2 * Er * d2 * U
    check_bf16_case(
        "env_scatter",
        lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U),),
        lambda: (fused_tp.env_scatter_reference(sh, wexp, centers, n_atoms, d2i, U),),
        lambda: (fused_tp.env_scatter(sh, wexp32, centers, row_ptr, d2i, U),),
        f"{label} d2 {d2}", records, (sh, wexp, row_ptr, d2i), env_flops)
    check_bf16_case(
        "unweight_both",
        lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
        lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
        lambda: fused_tp.unweight_both(t, sh, wexp32, centers, d2i),
        f"{label} d2 {d2}", records, (t, sh, wexp, centers, d2i), 2 * env_flops)
    check_bf16_case(
        "unweight_both",
        lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i, torch.float32),
        lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i, torch.float32),
        None, f"{label} d2 {d2}, float32 dwexp", records, (), 0, timed=False)
    check_bf16_case(
        "unweight_sh",
        lambda: (fused_tp.unweight_sh(t, wexp, centers, d2i),),
        lambda: (fused_tp.unweight_sh_reference(t, wexp, centers, d2i),),
        lambda: (fused_tp.unweight_sh(t, wexp32, centers, d2i),),
        f"{label} d2 {d2}", records, (t, wexp, centers, d2i), env_flops)
    check_bf16_case(
        "unweight_w",
        lambda: (fused_tp.unweight_w(t, sh, centers, d2i, n_irr, bf),),
        lambda: (fused_tp.unweight_w_reference(t, sh, centers, d2i, n_irr, bf),),
        lambda: (fused_tp.unweight_w(t, sh, centers, d2i, n_irr),),
        f"{label} d2 {d2}", records, (t, sh, centers, d2i), env_flops)
    # kernels 14 and 15 on layer 1's table: x and g in bf16, env and w float32
    wk, idx, coef = (v.detach() for v in tp1.fused_infer_parts(torch.float32))
    walk, scatter = tp1.gather_paths()[0], tp1.scatter_paths()[0]
    x, g = rand(E, tp1.d1 * U, dtype=bf), rand(E, tp1.d3 * U, dtype=bf)
    x32, g32 = x.float(), g.float()
    env = rand(n_atoms, tp1.d2 * U)
    what = f"{label} dims ({tp1.d1},{tp1.d2},{tp1.d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    check_bf16_case(
        "tp_scatter",
        lambda: (fused_tp.tp_scatter(x, g, wk, centers, row_ptr, idx, coef, tp1.d2, scatter),),
        lambda: (fused_tp.tp_scatter_reference(x, g, wk, centers, n_atoms, idx, coef, tp1.d2),),
        lambda: (fused_tp.tp_scatter(x32, g32, wk, centers, row_ptr, idx, coef, tp1.d2,
                                     scatter),),
        what, records, (x, g, wk, row_ptr, *scatter), tp_flops)
    P = wk.shape[0]
    check_bf16_case(
        "gather_dw",
        lambda: (fused_tp.gather_dw(x, env, g, centers, idx, coef, P, U, walk),),
        lambda: (fused_tp.gather_dw_reference(x, env, g, centers, idx, coef, P, U),),
        lambda: (fused_tp.gather_dw(x32, env, g32, centers, idx, coef, P, U, walk),),
        what, records, (x, env, g, centers, *walk), tp_flops)
    # checks only: both on layer 0's table, where g is a whole feature wide
    # (phase 11c launches them there in each training step)
    wk, idx, coef = (v.detach() for v in tp0.fused_infer_parts(torch.float32))
    walk, scatter = tp0.gather_paths()[0], tp0.scatter_paths()[0]
    x, g = rand(E, tp0.d1 * U, dtype=bf), rand(E, tp0.d3 * U, dtype=bf)
    env = rand(n_atoms, tp0.d2 * U)
    what = f"{label} layer-0 dims ({tp0.d1},{tp0.d2},{tp0.d3})"
    check_bf16_case(
        "tp_scatter",
        lambda: (fused_tp.tp_scatter(x, g, wk, centers, row_ptr, idx, coef, tp0.d2, scatter),),
        lambda: (fused_tp.tp_scatter_reference(x, g, wk, centers, n_atoms, idx, coef, tp0.d2),),
        None, what, records, (), 0, timed=False)
    check_bf16_case(
        "gather_dw",
        lambda: (fused_tp.gather_dw(x, env, g, centers, idx, coef, wk.shape[0], U, walk),),
        lambda: (fused_tp.gather_dw_reference(x, env, g, centers, idx, coef, wk.shape[0], U),),
        None, what, records, (), 0, timed=False)


def track_force_calls(fused, batch_np, n_atoms, n_edges, dev, smi):
    """Phase 11b: under POLICY_100K on the 4,096-atom crystal, the flagship
    with ``use_mega=False`` and ``TRACK_WIDE`` (routed to ``fused_call`` on
    this card) against the float64 ``einsum`` oracle with the same weights
    (forces within the allclose at 5e-5, or ``OFF_MEGA_TOL``; the energy
    within that tolerance of sum |E_i|); exact bf16 launches per call, two
    calls the same bits. Returns the
    launches of one call of each."""
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    avg_n = n_edges / n_atoms
    launches = {}
    for name, kw, extra, want, tol in (
            ("use_mega=False", FLAGSHIP, dict(use_mega=False), TRACK_CALL, OFF_MEGA_TOL),
            (TRACK_WIDE, WIDE_MODELS[TRACK_WIDE], {}, TRACK_ROUTED_CALL, REF_ATOL)):
        source = fused if name == "use_mega=False" else AllegroModel(
            **kw, avg_num_neighbors=avg_n, tp_kernel_backend="fused_infer").init(SEED)
        weights = {k: v.detach().cpu() for k, v in source.state_dict().items()}
        oracle = AllegroModel(**{**kw, "model_dtype": "float64"}, avg_num_neighbors=avg_n,
                              tp_kernel_backend="einsum").to(dev)
        oracle.load_state_dict({k: v.double() for k, v in weights.items()})
        ref = oracle.apply_with_derivatives(
            to_torch(oracle.precompute_statics(batch_np), dtype=torch.float64, device=dev))
        f_ref = ref[keys.FORCES][:n_atoms].detach()
        e_ref = float(ref[keys.TOTAL_ENERGY].sum())
        e_scale = float(ref[keys.PER_ATOM_ENERGY][:n_atoms].abs().sum())
        del oracle, ref
        torch.cuda.empty_cache()
        model = AllegroModel(**kw, avg_num_neighbors=avg_n, tp_kernel_backend="fused_infer",
                             **extra, **POLICY_100K).to(dev)
        model.load_state_dict(weights)
        data = to_torch(model.precompute_statics(batch_np), dtype=torch.float32, device=dev)
        routes = model.routes()
        if routes["allegro"] != "fused_call":
            raise AssertionError(f"{name}: routes {routes}, expected the fused_call route")
        fused_tp.reset_launch_counts()
        out = model.apply_with_derivatives(data)
        torch.cuda.synchronize()
        calls, bf16 = dict(fused_tp.LAUNCHES), dict(fused_tp.BF16_LAUNCHES)
        got = {k: c for k, c in bf16.items() if c}
        if got != want:
            raise AssertionError(f"{name}: bf16 form launches {got}, expected {want}")
        for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
        again = model.apply_with_derivatives(data)
        if not bitwise_same(out, again):
            raise AssertionError(f"{name}: two identical force calls differ")
        f = out[keys.FORCES][:n_atoms].double()
        diff = (f - f_ref).abs()
        margin = (diff - REF_RTOL * f_ref.abs()).max().item()
        within = (diff - tol * f_ref.abs()).max().item()
        e = float(out[keys.TOTAL_ENERGY].sum())
        e_err = abs(e - e_ref) / e_scale
        us = time_force_call(model, data, n_atoms, reps=3)
        print(f"[11b] {name}, 100k policy, routes {routes}: launches per call "
              f"{ {k: c for k, c in calls.items() if c} }, of them bf16 forms {got}; two calls "
              f"the same bits; forces vs the float64 einsum oracle: reference allclose margin "
              f"{margin:.3e} (atol = rtol = {REF_ATOL}), at {tol}: {within:.3e}; energy |dE| "
              f"{e_err:.3e} of sum |E_i| (< {tol}; {abs(e - e_ref) / max(abs(e_ref), 1e-3):.3e} "
              f"of |E|); {us:.3f} us/atom ({n_atoms} atoms; {smi})")
        if not within <= tol:
            raise AssertionError(f"{name}: forces miss the allclose at {tol}: {within:.3e}")
        if not e_err < tol:
            raise AssertionError(f"{name}: energy {e_err:.3e} of sum |E_i| from the oracle's")
        launches[name] = bf16
        del model, data, out, again
        torch.cuda.empty_cache()
    return launches


def track_training(loaders, dev, smi):
    """Phase 11c: the first step's parameter gradients of the flagship on
    ``fused`` with the bf16 track on phase 5's 1k batch against the float32
    ``einsum`` step's on the same weights (``grad_spread`` within
    ``TRACK_GRAD_TOL``, margin printed); then TRACK_TRAIN_STEPS Adam steps:
    each step's launches ``PER_STEP``, every launch of the trainable
    family's kernels (and gather_tp) a bf16 form; finite losses; float32
    parameters and gradients; two identical steps' gradients the same bits.
    Returns one step's bf16 launches."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    loader = loaders["1k"]
    batch_np = next(iter(loader))
    avg_n = float(batch_np[keys.EDGE_MASK].sum()) / float(batch_np[keys.NODE_MASK].sum())
    model = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n, tp_kernel_backend="fused",
                         tensor_dtype="bfloat16").init(SEED)
    einsum = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n, tp_kernel_backend="einsum")
    einsum.load_state_dict(model.state_dict())
    # the first step's gradients against the float32 einsum step's
    firsts = {}
    for which, m in (("track", model), ("einsum", einsum)):
        t = make_trainer(m, dev)
        _, _, firsts[which] = t.loss_and_grads(t.init_state(), t.to_device(batch_np))
    spread, leaf = grad_spread(firsts["track"], firsts["einsum"])
    del einsum, firsts
    torch.cuda.empty_cache()
    trainer = make_trainer(model, dev)
    state = trainer.init_state()
    want = {k: c for k, c in PER_STEP.items()
            if c and k in ("env_scatter", "gather_tp", *TRAIN_KERNELS)}
    times = []
    for step in range(TRACK_TRAIN_STEPS):
        fused_tp.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(state, loader, max_epochs=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bf16 = {k: c for k, c in fused_tp.BF16_LAUNCHES.items() if c}
        if fused_tp.LAUNCHES != PER_STEP or bf16 != want:
            raise AssertionError(f"bf16 training step {step}: launches {fused_tp.LAUNCHES}, of "
                                 f"them bf16 {bf16}; expected {PER_STEP}, bf16 {want}")
    losses = [h["train_loss"] for h in trainer.history]
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 training: losses {losses}")
    data = trainer.to_device(batch_np)
    _, _, first = trainer.loss_and_grads(state, data)
    _, _, again = trainer.loss_and_grads(state, data)
    dtypes = {str(t.dtype) for t in (*state.params.values(), *first.values())}
    differ = [k for k in first if not torch.equal(first[k], again[k])]
    finite = all(torch.isfinite(g).all() for g in first.values())
    print(f"[11c] {TRACK_TRAIN_STEPS} Adam steps on fused with the bf16 track, "
          f"{int(batch_np[keys.NODE_MASK].sum())} atoms: loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e}; bf16 launches per step {want}; {1e3 * float(np.median(times)):.3f} "
          f"ms/step (median, host clock); parameters and gradients {sorted(dtypes)}, gradients "
          f"{'finite' if finite else 'NOT FINITE'}; two identical steps "
          f"{'the same bits' if not differ else 'DIFFER in ' + ', '.join(differ)}; first-step "
          f"gradients vs the float32 einsum step's {spread:.3e} ({leaf}; <= {TRACK_GRAD_TOL}, "
          f"margin {TRACK_GRAD_TOL - spread:.3e}); {smi}")
    if dtypes != {"torch.float32"} or not finite or differ or not spread <= TRACK_GRAD_TOL:
        raise AssertionError("bf16 training: parameters or gradients not float32 and finite, "
                             f"two identical steps differ ({differ}), or the first step's "
                             f"gradients lie {spread:.3e} from the float32 einsum step's")
    return want


def track_phase(fused, batch_np, data, n_atoms, n_edges, loaders, rng, dev, smi):
    """Phase 11 (11a ``check_track_kernels`` on ``fused``'s layers at the
    shapes of ``data``, 11b ``track_force_calls``, 11c ``track_training``).
    Returns the kernels line's rows of its bf16 forms."""
    records = {}
    print("[11a] the bf16 forms of kernels 1, 4, 14-17 at the flagship shapes")
    check_track_kernels(fused.module.allegro.tps, data, rng, records)
    calls = track_force_calls(fused, batch_np, n_atoms, n_edges, dev, smi)
    step = track_training(loaders, dev, smi)
    return [track_record(n, name, records, calls["use_mega=False"], step)
            for n, name in TRACK_KERNELS]


def track_record(n, name, records, call, step):
    """The kernels line's row of kernel ``n``'s bf16 form of phase 11
    (``name[bf16]``): its times at the flagship shapes (11a), its launches
    in the use_mega=False call of the 100k policy (11b) and in one bf16
    training step (11c), and their sum as ``launches``."""
    rec = records[name]
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    replaces = next(r for k, _, r in TPU_KERNELS if k == n)
    return {"name": f"{name}[bf16]", "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "tpu_kernel": n,
            "launches": call.get(name, 0) + step.get(name, 0),
            "launches_100k_use_mega_false_call": call.get(name, 0),
            "launches_train_step": step.get(name, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": rec["library_ms"],
            "ms_f32_form": rec["ms_f32"], "max_ulps": rec["ulps"],
            **same_bits(rec),
            "ms_config": "bf16 form at the flagship shapes (4,096 atoms), one launch",
            "launches_config": "phase 11b's use_mega=False call of the 100k policy (4,096 "
                               "atoms) and one bf16 training step on the 1k batch (11c)"}


# phase 12: a bfloat16 model (model_dtype="bfloat16", ROADMAP item 6) on the
# serving routes. Its per-edge operands that JAX stores in bfloat16 (sh, the
# embeddings, the scalar pieces, features, env weights) take the kernels'
# bf16-operand forms, widened as they are staged; its MLP and path weights
# are widened once per call (exact), and sparse_tp rounds every op to
# bfloat16 as JAX's pallas kernel does
MODEL_FORMS = [(1, "env_scatter"), (2, "gather_tp"), (3, "bwd_fused"), (4, "unweight_both"),
               (5, "center_gather"), (6, "center_sum"), (7, "latent_env_scatter"),
               (8, "latent_env_bwd"), (9, "gather_tp_embed"), (10, "bwd_embed"),
               (11, "readout_sum"), (12, "readout_bwd"), (20, "sparse_tp")]
# each route's launches per force call of the bfloat16 flagship on float32
# positions (the entry points' default, JAX's too), and of them the
# bf16-operand forms' (fused_tp.BF16_LAUNCHES). The position gathers and the
# force sums read float32 on every route, and mega's readout float32 pieces
# (the latent kernels' lat_s, as in JAX): those take the float32 forms.
# pallas sums its env rows and edge energies in bfloat16 (center_sum and
# center_gather, forward and transposed) and runs every sparse_tp on
# bfloat16 operands
MODEL_ROUTES = {
    "mega": (dict(tp_kernel_backend="fused_infer"), PER_CALL["mega"],
             {"latent_env_scatter": 2, "latent_env_bwd": 2, "gather_tp_embed": 1, "bwd_embed": 1,
              "gather_tp": 1, "bwd_fused": 1}),
    "use_mega=False": (dict(tp_kernel_backend="fused_infer", use_mega=False),
                       PER_CALL["fused readout"],
                       {"env_scatter": 2, "gather_tp": 2, "bwd_fused": 2, "unweight_both": 2,
                        "readout_sum": 1, "readout_bwd": 1}),
    "pallas": (dict(tp_kernel_backend="pallas"), per_call("pallas"),
               {"center_gather": 5, "center_sum": 5, "sparse_tp": 6}),
    "einsum": (dict(tp_kernel_backend="einsum"), {}, {}),
}
MODEL_KERNEL_ROUTES = {"mega": "mega", "use_mega=False": "fused_call", "pallas": "pallas",
                       "einsum": "einsum"}
# a route of the bfloat16 model against the port's bfloat16 einsum on the
# card: forces max |dF| / max |F|, per-atom energies max |dE_i| / sum |E_i|.
# bfloat16 storage moves forces by ~1.5e-2 of max |F| whatever the route:
# on the CPU (tests/test_torch_model_dtype_bf16.py) JAX's own backends differ
# by up to 1.82e-2 on float32 data, and the port's routes lie within that of
# JAX's same backend; here ~3x that, for the 4,096 atoms' larger maximum
MODEL_F_TOL = 5e-2
MODEL_E_TOL = 1e-3
MODEL_MD_STEPS = 20


def check_model_forms(mega, fused, pallas, data, rng, records):
    """Phase 12a: each bf16-operand form of a bfloat16 model at the
    flagship's 4,096-atom shapes, against its plain version in float64 on
    the same bfloat16 inputs (``check_bf16_case``'s gate: bfloat16 outputs
    within 1 bf16 ulp, float32 outputs within KERNEL_TOL); sparse_tp's
    against its plain version, JAX's bfloat16 rounding op by op (the same
    bits). Each timed beside its float32 form on the same values widened."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp, pallas_contract

    bf, f32 = torch.bfloat16, torch.float32
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E, Er = centers.shape[0], int(data[keys.EDGE_MASK].sum())
    real = data[keys.EDGE_MASK].to(f32)[:, None]
    allegro = mega.module.allegro
    tp0, tp1 = allegro.tps
    S, U, d2, n_irr, d2i = allegro.S, allegro.U, tp0.d2, tp0.n_irr, tp0.dim_to_irr
    ranges = tp0.irr_ranges

    def rand(*shape, dtype=f32, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return (t * real if edge else t).to(dtype)

    def f64(fn, *args):
        """``fn`` on the float tensors of ``args`` widened to float64."""
        return lambda: fn(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                            for a in args))

    def wide(*ts):
        return tuple(t.float() for t in ts)

    def case(name, kernel, plain, exact, f32_form, what, reads, flops, library=None):
        check_bf16_case(name, kernel, plain, f32_form, what, records, reads, flops, exact=exact,
                        library=library)

    label = f"U {U} E {E}"
    # 1: env_scatter on layer 0's basis, sh and wexp bfloat16
    sh, wexp, t = rand(E, d2, dtype=bf), rand(E, n_irr * U, dtype=bf), rand(n_atoms, d2 * U,
                                                                             edge=False)
    sh32, wexp32 = wide(sh, wexp)
    env_flops = 2 * Er * d2 * U
    case("env_scatter", lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U),),
         lambda: (fused_tp.env_scatter_reference(sh, wexp, centers, n_atoms, d2i, U),),
         f64(lambda *a: (fused_tp.env_scatter_reference(*a, centers, n_atoms, d2i, U),), sh, wexp),
         lambda: (fused_tp.env_scatter(sh32, wexp32, centers, row_ptr, d2i, U),),
         f"{label} d2 {d2}", (sh, wexp, row_ptr, d2i), env_flops)
    # 4: unweight_both, dsh float32 and dwexp bfloat16
    case("unweight_both", lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
         lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
         f64(lambda *a: fused_tp.unweight_both_reference(*a, centers, d2i, torch.float64),
             t, sh, wexp),
         lambda: fused_tp.unweight_both(t, sh32, wexp32, centers, d2i),
         f"{label} d2 {d2}", (t, sh, wexp, centers, d2i), 2 * env_flops)
    # 2 and 3 on layer 0's table (its split scalars, ts and gts bfloat16)
    wk, idx, coef = (v.detach() for v in tp0.fused_infer_parts(bf))
    wk = wk.float()
    walk, swapped, scatter = tp0.infer_paths()
    x, env = rand(E, tp0.d1 * U, dtype=bf), rand(n_atoms, tp0.d2 * U, edge=False)
    g, gts = rand(E, tp0.d3 * U, dtype=bf), rand(E, U, dtype=bf)
    x32, g32, gts32 = wide(x, g, gts)
    what = f"{label} dims ({tp0.d1},{tp0.d2},{tp0.d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    case("gather_tp",
         lambda: fused_tp.gather_tp(x, env, wk, centers, idx, coef, tp0.d3, True, walk, bf),
         lambda: fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, tp0.d3, True, bf),
         f64(lambda *a: fused_tp.gather_tp_reference(*a, centers, idx, coef, tp0.d3, True,
                                                     torch.float64), x, env, wk),
         lambda: fused_tp.gather_tp(x32, env, wk, centers, idx, coef, tp0.d3, True, walk),
         what + ", split, ts bf16", (x, env, wk, centers, *walk), tp_flops)
    case("bwd_fused",
         lambda: fused_tp.bwd_fused(x, g, env, wk, centers, row_ptr, idx, coef, gts,
                                    paths=swapped, scatter_paths=scatter),
         lambda: fused_tp.bwd_fused_reference(x, g, env, wk, centers, n_atoms, idx, coef, gts),
         f64(lambda x_, g_, e_, w_, t_: fused_tp.bwd_fused_reference(
             x_, g_, e_, w_, centers, n_atoms, idx, coef, t_), x, g, env, wk, gts),
         lambda: fused_tp.bwd_fused(x32, g32, env, wk, centers, row_ptr, idx, coef, gts32,
                                    paths=swapped, scatter_paths=scatter),
         what + ", gts bf16", (x, g, gts, env, wk, row_ptr, *swapped, *scatter), 2 * tp_flops)
    # 9 and 10: layer 0's embed-fused TP on bfloat16 factors
    w2b = rand(E, n_irr * U, dtype=bf)
    w2b32 = w2b.float()
    paths = tp0.cg_paths()
    specs = allegro.row_specs
    what = f"{label} d1 {specs.shape[0]} d3 {tp0.d3}"
    case("gather_tp_embed",
         lambda: fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, row_ptr, idx, coef, specs,
                                          tp0.d3, True, paths),
         lambda: fused_tp.gather_tp_embed_reference(sh, w2b, env, wk, centers, idx, coef, specs,
                                                    tp0.d3, True),
         f64(lambda *a: fused_tp.gather_tp_embed_reference(*a, centers, idx, coef, specs, tp0.d3,
                                                           True), sh, w2b, env, wk),
         lambda: fused_tp.gather_tp_embed(sh32, w2b32, env, wk, centers, row_ptr, idx, coef,
                                          specs, tp0.d3, True, paths),
         what + ", out and ts bf16", (sh, w2b, env, wk, row_ptr, *paths), tp_flops)
    case("bwd_embed",
         lambda: fused_tp.bwd_embed(sh, w2b, g, env, wk, centers, row_ptr, idx, coef, specs, gts,
                                    paths),
         lambda: fused_tp.bwd_embed_reference(sh, w2b, g, env, wk, centers, n_atoms, idx, coef,
                                              specs, gts),
         f64(lambda s_, w_, g_, e_, k_, t_: fused_tp.bwd_embed_reference(
             s_, w_, g_, e_, k_, centers, n_atoms, idx, coef, specs, t_),
             sh, w2b, g, env, wk, gts),
         lambda: fused_tp.bwd_embed(sh32, w2b32, g32, env, wk, centers, row_ptr, idx, coef,
                                    specs, gts32, paths),
         what + ", g and gts bf16", (sh, w2b, g, gts, env, wk, row_ptr, *paths), 2 * tp_flops)
    # 7 and 8: the first projection (a bfloat16 embedding) and layer 0's
    # latent (float32 scalars beside bfloat16 tensor scalars), sh bfloat16
    (w_proj,) = (w.detach().float() for w in allegro.first_projection.weights())
    w0, w1 = (w.detach().float() for w in allegro.latents[0].weights())
    emb = rand(E, allegro.embed_dim, dtype=bf)
    lat, ts = rand(E, S), rand(E, U, dtype=bf)
    g_lat = rand(E, S)
    for tag, pieces, a, b in (("first projection", (emb,), w_proj, None),
                              ("layer-0 latent", (lat, ts), w0, w1)):
        p32 = wide(*pieces)
        K, N = a.shape[0], (a if b is None else b).shape[1]
        H = 0 if b is None else a.shape[1]
        what = f"{label} pieces {[tuple(p.shape[1:]) for p in pieces]} K {K} H {H} N {N}"
        mlp = 2 * Er * (K * N if b is None else K * H + H * N)
        case("latent_env_scatter",
             lambda: fused_tp.latent_env_scatter(pieces, sh, a, b, centers, row_ptr, d2i, U, S,
                                                 ranges),
             lambda: fused_tp.latent_env_scatter_reference(pieces, sh, a, b, row_ptr, d2i, U, S),
             lambda: fused_tp.latent_env_scatter_reference(
                 tuple(p.double() for p in pieces), sh.double(), a.double(),
                 None if b is None else b.double(), row_ptr, d2i, U, S),
             lambda: fused_tp.latent_env_scatter(p32, sh32, a, b, centers, row_ptr, d2i, U, S,
                                                 ranges),
             f"{what} ({tag})", (*pieces, sh, a, *([] if b is None else [b]), row_ptr),
             mlp + env_flops)
        case("latent_env_bwd",
             lambda: _flat(fused_tp.latent_env_bwd(pieces, sh, a, b, t, g_lat, centers, d2i, U,
                                                   S, ranges)),
             lambda: _flat(fused_tp.latent_env_bwd_reference(pieces, sh, a, b, t, g_lat, centers,
                                                             d2i, U, S)),
             lambda: _flat(fused_tp.latent_env_bwd_reference(
                 tuple(p.double() for p in pieces), sh.double(), a.double(),
                 None if b is None else b.double(), t.double(), g_lat.double(), centers, d2i,
                 U, S)),
             lambda: _flat(fused_tp.latent_env_bwd(p32, sh32, a, b, t, g_lat, centers, d2i, U,
                                                   S, ranges)),
             f"{what} ({tag})", (*pieces, sh, a, *([] if b is None else [b]), t, g_lat, centers),
             3 * mlp + 2 * env_flops)
    # 11 and 12: use_mega=False's readout on bfloat16 pieces (column slices
    # of the latent MLPs' outputs)
    ro = fused.module.edge_readout.mlp
    r0, r1 = (w.detach().float() for w in ro.weights())
    K, H = r0.shape
    wide_rows = [rand(E, S + 96, dtype=bf), rand(E, S + 96, dtype=bf), rand(E, S, dtype=bf)]
    pieces = [w[:, :S] for w in wide_rows]
    p32 = [p.float() for p in pieces]
    y = rand(n_atoms, 1, edge=False)
    what = f"pieces 3 x [{E}, {S}] bf16, W0 [{K}, {H}]"
    case("readout_sum", lambda: (fused_tp.readout_sum(pieces, r0, r1, row_ptr),),
         lambda: (fused_tp.readout_sum_reference(pieces, r0, r1, row_ptr),),
         lambda: (fused_tp.readout_sum_reference([p.double() for p in pieces], r0.double(),
                                                 r1.double(), row_ptr),),
         lambda: (fused_tp.readout_sum(p32, r0, r1, row_ptr),),
         what, (*pieces, r0, r1, row_ptr), 2 * Er * (K * H + H))
    case("readout_bwd", lambda: fused_tp.readout_bwd(pieces, r0, r1, y, centers),
         lambda: fused_tp.readout_bwd_reference(pieces, r0, r1, y, centers),
         lambda: fused_tp.readout_bwd_reference([p.double() for p in pieces], r0.double(),
                                                r1.double(), y.double(), centers),
         lambda: fused_tp.readout_bwd(p32, r0, r1, y, centers),
         what, (*pieces, r0, r1, y, centers), 2 * Er * (2 * K * H + H))
    # 5 and 6 at pallas's widths: the env rows (d2 U) and the edge energies
    # (1), and at the positions' (3), bfloat16
    nbr_perm, nbr_ptr = data[keys.NBR_PERM], data[keys.NBR_ROW_PTR]
    idx_l = centers.long()
    for C in (d2 * U, 3, 1):
        a = rand(n_atoms, C, dtype=bf, edge=False)
        v = rand(E, C, dtype=bf)
        a32, v32 = a.float(), v.float()
        a_pad = torch.cat([a, a.new_zeros((1, C))])
        acc = v.new_zeros((n_atoms + 1, C))
        case("center_gather", lambda: (fused_tp.center_gather(a, centers),),
             lambda: (fused_tp.center_gather_reference(a, centers),),
             None, lambda: (fused_tp.center_gather(a32, centers),),
             f"[{n_atoms}, {C}] -> [{E}, {C}] bf16", (a, centers), 0,
             library=lambda: a_pad.index_select(0, idx_l))
        case("center_sum", lambda: (fused_tp.center_sum(v, row_ptr),),
             lambda: (fused_tp.center_sum_reference(v, row_ptr),),
             f64(lambda v_: (fused_tp.center_sum_reference(v_, row_ptr),), v),
             lambda: (fused_tp.center_sum(v32, row_ptr),),
             f"[{E}, {C}] -> [{n_atoms}, {C}] bf16", (v, row_ptr), Er * C,
             library=lambda: acc.index_add_(0, idx_l, v))
    # the neighbor side's gather and sum (the positions' other CSR), checked
    a = rand(n_atoms, 3, dtype=bf, edge=False)
    v = rand(E, 3, dtype=bf)
    nbrs = data[keys.EDGE_INDEX][1].to(torch.int32).contiguous()
    check_bf16_case("center_gather", lambda: (fused_tp.center_gather(a, nbrs),),
                    lambda: (fused_tp.center_gather_reference(a, nbrs),), None,
                    f"[{n_atoms}, 3] -> [{E}, 3] bf16, neighbor side", records, (), 0,
                    timed=False)
    check_bf16_case("center_sum", lambda: (fused_tp.center_sum(v, nbr_ptr, nbr_perm),),
                    lambda: (fused_tp.center_sum_reference(v, nbr_ptr, nbr_perm),), None,
                    f"[{E}, 3] -> [{n_atoms}, 3] bf16, neighbor side", records, (), 0,
                    timed=False,
                    exact=f64(lambda v_: (fused_tp.center_sum_reference(v_, nbr_ptr, nbr_perm),),
                              v))
    # 20: sparse_tp on bfloat16 a, b and w, the layer tables of pallas's
    # force call (orders 0 and the a- and b-swaps' of layer 0, order 0 of
    # layer 1): the plain version is JAX's rounding, op by op
    ptps = pallas.module.allegro.tps
    for li, r in ((0, 0), (0, 5), (0, 1), (1, 0)):
        st = ptps[li].tp_statics()
        idx, coef = st.table(r)
        dims = [st.dims[k] for k in pallas_contract.ROLES[r]]
        av, bv = rand(E, dims[0] * U, dtype=bf), rand(E, dims[1] * U, dtype=bf)
        wv = rand(st.n_paths, U, dtype=bf, edge=False)
        a32, b32, w32 = wide(av, bv, wv)
        walk_r = st.walk(r)
        case("sparse_tp",
             lambda: (pallas_contract.sparse_tp(av, bv, wv, idx, coef, dims[2], walk_r),),
             lambda: (pallas_contract.sparse_tp_bf16_reference(av, bv, wv, idx, coef, dims[2]),),
             None,
             lambda: (pallas_contract.sparse_tp(a32, b32, w32, idx, coef, dims[2], walk_r),),
             f"{label} layer {li} order {pallas_contract.ROLES[r]} dims {tuple(dims)} entries "
             f"{idx.shape[0]}", (av, bv, wv, idx, coef), 4 * Er * idx.shape[0] * U)


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """``torch.use_deterministic_algorithms`` where ``on``, restored after:
    the ``einsum`` reference sums with ``index_add``, whose CUDA form adds
    with atomics unless asked for its deterministic form."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    if on:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def model_force_calls(weights, batch_np, n_atoms, n_edges, dev, smi):
    """Phase 12b: the bfloat16 flagship (``weights`` rounded to bfloat16) on
    each route against the port's bfloat16 ``einsum`` on the card
    (MODEL_F_TOL, MODEL_E_TOL) and against the float64 ``einsum`` oracle on
    the same bfloat16 values: margins printed; output dtypes those of the
    CPU's call on a small crystal; exact launches per call (MODEL_ROUTES),
    the bf16-operand forms' among them; two calls the same bits (``einsum``
    under ``deterministic_algorithms``); µs/atom. Returns each route's
    launches per call, and the models."""
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    avg_n = n_edges / n_atoms
    kw = {**FLAGSHIP, "model_dtype": "bfloat16", "avg_num_neighbors": avg_n}
    oracle = AllegroModel(**{**kw, "model_dtype": "float64"}, tp_kernel_backend="einsum").to(dev)
    oracle.load_state_dict({k: v.to(torch.bfloat16).double() for k, v in weights.items()})
    ref64 = oracle.apply_with_derivatives(
        to_torch(oracle.precompute_statics(batch_np), dtype=torch.float64, device=dev))
    del oracle
    torch.cuda.empty_cache()
    small_frame, small_n = crystal_frame(64, R_MAX, SEED)
    small = batch_frames([small_frame], n_frames=1)

    def metrics(out, ref):
        f, f_ref = out[keys.FORCES][:n_atoms].double(), ref[keys.FORCES][:n_atoms].double()
        e = out[keys.PER_ATOM_ENERGY][:n_atoms].double()
        e_ref = ref[keys.PER_ATOM_ENERGY][:n_atoms].double()
        d = (f - f_ref).abs()
        return (d.max().item() / f_ref.abs().max().item(),
                (d - REF_RTOL * f_ref.abs()).max().item(),
                (e - e_ref).abs().max().item() / e_ref.abs().sum().item())

    models, launches, ref_bf = {}, {}, None
    for name in ("einsum", "mega", "use_mega=False", "pallas"):
        extra, want, want_bf16 = MODEL_ROUTES[name]
        model = AllegroModel(**kw, **extra).to(dev)
        model.load_state_dict(weights)
        routes = model.routes()
        if routes["allegro"] != MODEL_KERNEL_ROUTES[name]:
            raise AssertionError(f"bfloat16 model, {name}: routes {routes}")
        data = to_torch(model.precompute_statics(batch_np), dtype=torch.float32, device=dev)
        with deterministic_algorithms(name == "einsum"):
            model.apply_with_derivatives(data)
            torch.cuda.synchronize()
            fused_tp.reset_launch_counts()
            out = model.apply_with_derivatives(data)
            torch.cuda.synchronize()
            calls = {k: c for k, c in fused_tp.LAUNCHES.items() if c}
            bf16 = {k: c for k, c in fused_tp.BF16_LAUNCHES.items() if c}
            again = model.apply_with_derivatives(data)
        if calls != {k: c for k, c in want.items() if c} or bf16 != want_bf16:
            raise AssertionError(f"bfloat16 model, {name}: launches {calls}, of them bf16 forms "
                                 f"{bf16}; expected {want}, bf16 {want_bf16}")
        for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"bfloat16 model, {name}: non-finite {k}")
        cpu = AllegroModel(**kw, **extra)
        cpu.load_state_dict({k: v.cpu() for k, v in weights.items()})
        cpu_out = cpu.apply_with_derivatives(to_torch(cpu.precompute_statics(small), torch.float32))
        dtypes = {k: str(out[k].dtype) for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY,
                                                 keys.FORCES)}
        cpu_dtypes = {k: str(cpu_out[k].dtype) for k in dtypes}
        if dtypes != cpu_dtypes:
            raise AssertionError(f"bfloat16 model, {name}: dtypes {dtypes}, the CPU's "
                                 f"{cpu_dtypes}")
        if not bitwise_same(out, again):
            raise AssertionError(f"bfloat16 model, {name}: two identical force calls differ")
        us, us_f32 = time_force_call(model, data, n_atoms, reps=5), None
        if name != "einsum":
            # the float32 model on the same weights and data, in turns with
            # the bfloat16 one: host clocks move between calls
            f32 = AllegroModel(**{**kw, "model_dtype": "float32"}, **extra).to(dev)
            f32.load_state_dict({k: v.to(torch.bfloat16).float() for k, v in weights.items()})
            turns = [time_force_call(m, data, n_atoms, reps=5) for m in (model, f32, f32, model)]
            us, us_f32 = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            if name == "mega":
                profile_calls(lambda: model.apply_with_derivatives(data), 3,
                              "bfloat16 flagship, mega")
                profile_calls(lambda: f32.apply_with_derivatives(data), 3,
                              "the float32 flagship on the same weights, mega")
            del f32
        if ref_bf is None:
            ref_bf = out
        rel, margin, e_err = metrics(out, ref_bf)
        rel64, margin64, e64 = metrics(out, ref64)
        print(f"[12b] bfloat16 model, {name} (routes {routes}): launches per call {calls}, of "
              f"them bf16 forms {bf16}; dtypes {dtypes} (the CPU's); two calls the same bits; "
              f"vs the bf16 einsum: forces max|dF|/max|F| {rel:.3e} (< {MODEL_F_TOL}), "
              f"reference allclose margin {margin:.3e} (atol = rtol = {REF_ATOL}), per-atom "
              f"energies {e_err:.3e} of sum |E_i| (< {MODEL_E_TOL}); vs the float64 einsum "
              f"oracle: {rel64:.3e}, margin {margin64:.3e}, energies {e64:.3e}; {us:.3f} "
              f"us/atom" + ("" if us_f32 is None else
                            f" (the float32 model's {us_f32:.3f}, in turns)")
              + f" ({n_atoms} atoms; {smi})")
        if not (rel <= MODEL_F_TOL and e_err <= MODEL_E_TOL and rel64 <= MODEL_F_TOL
                and e64 <= MODEL_E_TOL):
            raise AssertionError(f"bfloat16 model, {name}: beyond the tolerances")
        launches[name] = bf16
        models[name] = model
        del data, out, again
        torch.cuda.empty_cache()
    return launches, models


def model_entry_points(mega, einsum, frame, n_atoms, dev, smi):
    """Phase 12c: MODEL_MD_STEPS MD steps (``md.Simulation``, float32, its
    default) and one calculator call of the bfloat16 flagship on the default
    route, exact launches per MD block, against the same on the bfloat16
    ``einsum``: the positions' difference within MODEL_F_TOL of the largest
    displacement, the calculator's forces within MODEL_F_TOL of max |F|."""
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.md import MDState, Simulation, maxwell_boltzmann_velocities
    from allegro_tpu_torch.ops import fused_tp

    kw = dict(atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC],
              device=dev, **MD)
    _, per_call, per_call_bf16 = MODEL_ROUTES["mega"]
    ends, times = {}, []
    for name, model in (("mega", mega), ("einsum", einsum)):
        sim = Simulation(model, **kw)
        vel0 = maxwell_boltzmann_velocities(sim.masses_per_atom, MD_KT, seed=SEED)
        state = MDState(frame[keys.POSITIONS], vel0)
        for b in range(MODEL_MD_STEPS // MD_STEPS_PER_BLOCK):
            fused_tp.reset_launch_counts()
            t0 = time.perf_counter()
            state = sim.run(state, MD_STEPS_PER_BLOCK)
            if name == "mega":
                times.append(time.perf_counter() - t0)
                steps = MD_STEPS_PER_BLOCK + 1
                want = {k: n * steps for k, n in per_call.items() if n}
                want_bf16 = {k: n * steps for k, n in per_call_bf16.items()}
                got = {k: c for k, c in fused_tp.LAUNCHES.items() if c}
                got_bf16 = {k: c for k, c in fused_tp.BF16_LAUNCHES.items() if c}
                if got != want or got_bf16 != want_bf16:
                    raise AssertionError(f"bfloat16 MD block {b}: launches {got}, bf16 "
                                         f"{got_bf16}; expected {want}, bf16 {want_bf16}")
        if not np.isfinite(state.positions).all():
            raise AssertionError(f"bfloat16 MD on {name}: non-finite positions")
        ends[name] = state.positions
    cell = np.asarray(frame[keys.CELL], dtype=np.float64).reshape(3, 3)

    def minimum_image(d):
        """Displacements wrapped to the periodic cell's nearest image."""
        frac = d @ np.linalg.inv(cell)
        return (frac - np.round(frac)) @ cell

    moved = float(np.abs(minimum_image(ends["einsum"] - frame[keys.POSITIONS])).max())
    dpos = float(np.abs(minimum_image(ends["mega"] - ends["einsum"])).max())
    print(f"[12c] bfloat16 model, {MODEL_MD_STEPS} MD steps on mega (float32 positions): max "
          f"|dpos| vs the bf16 einsum's MD {dpos:.3e} A, {dpos / moved:.3e} of the largest "
          f"displacement {moved:.3e} A (< {MODEL_F_TOL}); "
          f"{1e3 * float(np.median(times)) / MD_STEPS_PER_BLOCK:.3f} ms/step ({smi})")
    if not dpos <= MODEL_F_TOL * moved:
        raise AssertionError(f"bfloat16 MD: positions {dpos:.3e} from einsum's")
    res = {}
    for name, model in (("mega", mega), ("einsum", einsum)):
        calc = AllegroCalculator(model, device=dev)
        fused_tp.reset_launch_counts()
        res[name] = calc.calculate(frame[keys.POSITIONS], atom_types=frame[keys.ATOM_TYPES],
                                   cell=frame[keys.CELL], pbc=frame[keys.PBC])
        if name == "mega" and {k: c for k, c in fused_tp.BF16_LAUNCHES.items() if c} \
                != per_call_bf16:
            raise AssertionError(f"bfloat16 calculator call: bf16 launches "
                                 f"{fused_tp.BF16_LAUNCHES}")
    f, f_ref = res["mega"]["forces"], res["einsum"]["forces"]
    rel = float(np.abs(f - f_ref).max() / np.abs(f_ref).max())
    e_err = float(np.abs(res["mega"]["energies"] - res["einsum"]["energies"]).max()
                  / np.abs(res["einsum"]["energies"]).sum())
    print(f"    calculator call on mega: energy {res['mega']['energy']:.6f} (einsum "
          f"{res['einsum']['energy']:.6f}), forces {res['mega']['forces'].dtype} max|dF|/max|F| "
          f"{rel:.3e} (< {MODEL_F_TOL}), per-atom energies {e_err:.3e} of sum |E_i| "
          f"(< {MODEL_E_TOL})")
    if not (np.isfinite(f).all() and rel <= MODEL_F_TOL and e_err <= MODEL_E_TOL):
        raise AssertionError("bfloat16 calculator call beyond the tolerances")


def model_phase(fused, batch_np, frame, data, n_atoms, n_edges, rng, dev, smi):
    """Phase 12 (12a ``check_model_forms``, 12b ``model_force_calls``, 12c
    ``model_entry_points``) on the flagship's weights from seed 0 (``fused``'s)
    rounded to bfloat16. Returns the kernels line's rows of its forms."""
    weights = {k: v.detach() for k, v in fused.state_dict().items()}
    launches, models = model_force_calls(weights, batch_np, n_atoms, n_edges, dev, smi)
    records = {}
    print("[12a] the bf16-operand forms of kernels 1-12 and 20 (a bfloat16 model) at the "
          "flagship shapes")
    check_model_forms(models["mega"], models["use_mega=False"], models["pallas"], data, rng,
                      records)
    model_entry_points(models["mega"], models["einsum"], frame, n_atoms, dev, smi)
    return [model_record(n, name, records, launches) for n, name in MODEL_FORMS]


def model_record(n, name, records, launches):
    """The kernels line's row of kernel ``n``'s bf16-operand form
    (``name[bf16 model]``): its times at the flagship shapes (12a) and its
    launches in one force call on each route (12b)."""
    rec = records[name]
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    replaces = next(r for k, _, r in TPU_KERNELS if k == n)
    per_route = {route: calls.get(name, 0) for route, calls in launches.items()}
    return {"name": f"{name}[bf16 model]", "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "tpu_kernel": n, "launches": sum(per_route.values()),
            "launches_per_route": per_route,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": rec["library_ms"],
            "ms_f32_form": rec["ms_f32"], "max_ulps": rec["ulps"],
            **same_bits(rec),
            "ms_config": "bf16-operand form at the flagship shapes (4,096 atoms), each timed "
                         "case of phase 12a summed",
            "launches_config": "one force call of the bfloat16 flagship on each route (4,096 "
                               "atoms, phase 12b)"}


# phase 13: a bfloat16 model in training (model_dtype="bfloat16", ROADMAP
# item 14's first half): the flagship's weights from seed 0 rounded to
# bfloat16 on phase 5's 1k batch. Its training step reaches the trainable
# families' kernels with bfloat16 operands: on fused the bf16 track's forms
# (features, their cotangents and the env weights bfloat16) and
# unweight_w's form on bfloat16 sh; on pallas sparse_tp_gradw's bfloat16
# form, which sums the edges in JAX's packed groups
MODEL_TRAIN_FORMS = [(13, "gather_tp[swapped]"), (14, "tp_scatter"), (15, "gather_dw"),
                     (16, "unweight_sh"), (17, "unweight_w"), (21, "sparse_tp_gradw")]
MODEL_TRAIN_STEPS = 3
# a training step's bf16-operand launches (fused_tp.BF16_LAUNCHES): every
# launch of the trainable families' kernels and of gather_tp and
# env_scatter; of the center kernels those on bfloat16 rows (the edge
# energies and their cotangent, the type embeddings read by class, pallas's
# env sums), not the position gathers and force sums, which read float32
MODEL_TRAIN_BF16 = {
    "fused": {"env_scatter": 6, "gather_tp": 12, "tp_scatter": 6, "gather_dw": 8,
              "unweight_sh": 6, "unweight_w": 6, "center_gather": 4, "center_sum": 3},
    "pallas": {"sparse_tp": 18, "sparse_tp_gradw": 8, "center_gather": 12, "center_sum": 11},
}
# of a fused step's 12 gather_tp launches (PER_STEP), those on the layers'
# role-swapped tables (kernel 13's training form): per layer the force
# backward's dx, the parameter backward's dx of the forward GatherTp, and
# the x-gradient of the force backward's TpScatter; the other 3 L (the
# forward, the swapped GatherTp's dx, TpScatter's g-gradient) run on the
# layers' own tables
MODEL_TRAIN_SWAPPED = {"fused": 6, "pallas": 0}
# the pallas step's gradw role orders (the table, its b- and a-swaps)
MODEL_GRADW_ORDERS = (0, 1, 5)
# the first-step gradients' gate: JAX's own spread of the bf16 toy's
# gradients over its backends and its float32 einsum gradient, four draws
# (tests/test_torch_model_dtype_bf16_train.py, SPREAD_GRAD; measured by
# tests/bf16_grad_probe.py), max over the leaves of
# max |g_a - g_b| / max(|g_a|, |g_b|)
SPREAD_GRAD = 6.646e-2
# phase 11c: the bf16 track's first-step gradients against the float32
# einsum step's, the same gauge. Measured on the CPU at the flagship's
# widths on four crystals of phase 5's seeds cut to 64 and 216 atoms:
# 3.34e-3 and 3.36e-3 (tests/test_torch_bf16_track.py holds the track's
# gradients to JAX's at 1e-8); three times that, for the kernels' other
# summation order on the card
TRACK_GRAD_TOL = 1e-2


def grad_spread(a, b):
    """(max over the leaves of max |a - b| / max(|a|, |b|), its leaf)."""
    r = {k: ((a[k].double() - b[k].double()).abs().max()
             / torch.maximum(a[k].double().abs().max(), b[k].double().abs().max())).item()
         for k in a}
    worst = max(r, key=r.get)
    return r[worst], worst


def check_model_train_forms(fused, pallas, data, rng, records):
    """Phase 13a: the bf16-operand forms a bfloat16 model's training step
    launches, at the shapes of the 1k batch's two layers (``data``: the
    batch's statics), each against its plain version on the same bfloat16
    inputs and timed beside its float32 form on float32 copies (plain
    versions with PHASE7_PLAIN_TIMING): 13 ``gather_tp`` on the role-swapped
    table, 14 ``tp_scatter``, 15 ``gather_dw`` (x and g bfloat16, env and
    the widened path weights float32), held to the plain version in float64
    (bfloat16 outputs within 1 bf16 ulp, float32 outputs within KERNEL_TOL,
    ``check_bf16_case``), on both layers' tables; 16 ``unweight_sh``
    (bfloat16 env weights) and 17 ``unweight_w`` (bfloat16 sh, its new form)
    on layer 0's basis, the same gate; 21 ``sparse_tp_gradw`` on bfloat16
    operands in the role orders a pallas step launches (MODEL_GRADW_ORDERS)
    on both layers' tables: the same bits as its plain version (JAX's
    bfloat16 rounding, in JAX's packed groups), timed beside the float32
    form and one ``torch.einsum`` call."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp
    from allegro_tpu_torch.ops import pallas_contract as pc

    bf, f32 = torch.bfloat16, torch.float32
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E, Er = centers.shape[0], int(data[keys.EDGE_MASK].sum())
    real = data[keys.EDGE_MASK].to(f32)[:, None]
    tps = fused.module.allegro.tps

    def rand(*shape, dtype=f32, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return (t * real if edge else t).to(dtype)

    def f64(fn, *args):
        return lambda: fn(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                            for a in args))

    def case(name, kernel, plain, exact, f32_form, what, reads, flops):
        check_bf16_case(name, kernel, plain, f32_form, what, records, reads, flops, exact=exact,
                        plain_timing=PHASE7_PLAIN_TIMING)

    for layer, tp in enumerate(tps):
        U, P = tp.mul, tp.num_paths
        wk, idx, coef = (v.detach() for v in tp.fused_infer_parts(bf))
        wk = wk.float()  # the Functions' widened path weights (fused_primitives._wide)
        (walk, walk_sw), scatter = tp.gather_paths(), tp.scatter_paths()[0]
        d1, d2, d3 = tp.d1, tp.d2, tp.d3
        x, g = rand(E, d1 * U, dtype=bf), rand(E, d3 * U, dtype=bf)
        env = rand(n_atoms, d2 * U, edge=False)
        x32, g32 = x.float(), g.float()
        n = idx.shape[0]
        what = f"U {U} E {E} layer {layer} dims ({d1},{d2},{d3}) entries {n}"
        flops = 3 * Er * n * U
        sw = tp.entry_swapped
        case("gather_tp[swapped]",
             lambda: (fused_tp.gather_tp(g, env, wk, centers, sw, coef, d1, paths=walk_sw),),
             lambda: (fused_tp.gather_tp_reference(g, env, wk, centers, sw, coef, d1),),
             f64(lambda *a: (fused_tp.gather_tp_reference(*a),), g, env, wk, centers, sw, coef,
                 d1),
             lambda: (fused_tp.gather_tp(g32, env, wk, centers, sw, coef, d1, paths=walk_sw),),
             what, (g, env, wk, centers, *walk_sw), flops)
        case("tp_scatter",
             lambda: (fused_tp.tp_scatter(x, g, wk, centers, row_ptr, idx, coef, d2, scatter),),
             lambda: (fused_tp.tp_scatter_reference(x, g, wk, centers, n_atoms, idx, coef, d2),),
             f64(lambda *a: (fused_tp.tp_scatter_reference(*a),), x, g, wk, centers, n_atoms,
                 idx, coef, d2),
             lambda: (fused_tp.tp_scatter(x32, g32, wk, centers, row_ptr, idx, coef, d2,
                                          scatter),),
             what, (x, g, wk, row_ptr, *scatter), flops)
        case("gather_dw",
             lambda: (fused_tp.gather_dw(x, env, g, centers, idx, coef, P, U, walk),),
             lambda: (fused_tp.gather_dw_reference(x, env, g, centers, idx, coef, P, U),),
             f64(lambda *a: (fused_tp.gather_dw_reference(*a),), x, env, g, centers, idx, coef,
                 P, U),
             lambda: (fused_tp.gather_dw(x32, env, g32, centers, idx, coef, P, U, walk),),
             what, (x, env, g, centers, *walk), flops)
        del x, g, env, x32, g32
    tp0 = tps[0]
    U, d2, n_irr, d2i = tp0.mul, tp0.d2, tp0.n_irr, tp0.dim_to_irr
    sh, wexp, t = rand(E, d2, dtype=bf), rand(E, n_irr * U, dtype=bf), rand(n_atoms, d2 * U,
                                                                             edge=False)
    sh32, wexp32 = sh.float(), wexp.float()
    env_flops = 2 * Er * d2 * U
    what = f"U {U} E {E} layer 0 d2 {d2}"
    case("unweight_sh", lambda: (fused_tp.unweight_sh(t, wexp, centers, d2i),),
         lambda: (fused_tp.unweight_sh_reference(t, wexp, centers, d2i),),
         f64(lambda *a: (fused_tp.unweight_sh_reference(*a),), t, wexp, centers, d2i),
         lambda: (fused_tp.unweight_sh(t, wexp32, centers, d2i),),
         what, (t, wexp, centers, d2i), env_flops)
    case("unweight_w", lambda: (fused_tp.unweight_w(t, sh, centers, d2i, n_irr, bf),),
         lambda: (fused_tp.unweight_w_reference(t, sh, centers, d2i, n_irr, bf),),
         f64(lambda *a: (fused_tp.unweight_w_reference(*a, bf),), t, sh, centers, d2i, n_irr),
         lambda: (fused_tp.unweight_w(t, sh32, centers, d2i, n_irr),),
         what, (t, sh, centers, d2i), env_flops)
    del sh, wexp, t, sh32, wexp32
    # 21: the same bits as the plain version, in each order a pallas step launches
    for layer, tp in enumerate(pallas.module.allegro.tps):
        U, P, st = tp.mul, tp.num_paths, tp.tp_statics()
        for r in MODEL_GRADW_ORDERS:
            d1, d2, d3 = (st.dims[s] for s in pc.ROLES[r])
            (idx, coef), paths = st.table(r), st.walk(r)
            n = idx.shape[0]
            a, b, g = (rand(E, d * U, dtype=bf) for d in (d1, d2, d3))
            a32, b32, g32 = a.float(), b.float(), g.float()
            label = (f"U {U} E {E} layer {layer} order {''.join(map(str, pc.ROLES[r]))} dims "
                     f"({d1},{d2},{d3}) entries {n}")
            C = fused_tp._cg_tensor(a32, idx, coef, P, d1, d2, d3).to(bf)
            a3, b3, g3 = a.view(E, d1, U), b.view(E, d2, U), g.view(E, d3, U)
            check_bf16_case(
                "sparse_tp_gradw", lambda: (pc.sparse_tp_gradw(a, b, g, idx, coef, P, U),),
                lambda: (pc.sparse_tp_gradw_bf16_reference(a, b, g, idx, coef, P, U),),
                lambda: (pc.sparse_tp_gradw(a32, b32, g32, idx, coef, P, U, paths),),
                label, records, (a, b, g, idx, coef), 4 * Er * n * U,
                library=_fits(lambda: torch.einsum("eiu,eju,eku,pijk->pu", a3, b3, g3, C)),
                plain_timing=PHASE7_PLAIN_TIMING, exact_bits=True)
            del a, b, g, a32, b32, g32, C, a3, b3, g3
            torch.cuda.empty_cache()


def _count_swapped(tps):
    """A wrapper of ``fused_tp.gather_tp`` that sorts its launches (the rise
    of ``LAUNCHES["gather_tp"]`` over the real call) by table: ``swapped``
    on a role-swapped table of ``tps`` (kernel 13's training form), ``own``
    on their own tables, ``other`` on any other: (install, restore,
    counts)."""
    from allegro_tpu_torch.ops import fused_tp

    real, counts = fused_tp.gather_tp, {"swapped": 0, "own": 0, "other": 0}
    swapped, own = [tp.entry_swapped for tp in tps], [tp.entry_idx for tp in tps]

    def wrap(x, env, w, centers, entry_idx, *args, **kw):
        before = fused_tp.LAUNCHES["gather_tp"]
        out = real(x, env, w, centers, entry_idx, *args, **kw)
        table = ("swapped" if any(entry_idx is t for t in swapped) else
                 "own" if any(entry_idx is t for t in own) else "other")
        counts[table] += fused_tp.LAUNCHES["gather_tp"] - before
        return out

    return (lambda: setattr(fused_tp, "gather_tp", wrap),
            lambda: setattr(fused_tp, "gather_tp", real), counts)


def model_training(weights, loader, dev, smi):
    """Phase 13b/13c: the bfloat16 flagship (``weights`` rounded) on the 1k
    batch. (c) the first step's parameter gradients on ``fused`` and
    ``pallas`` against the bfloat16 ``einsum`` step's and the float32
    ``einsum`` step's on the same values (``SPREAD_GRAD``, margins printed),
    bfloat16 as the parameters; two identical ``einsum`` steps the same
    bits under ``deterministic_algorithms`` (``index_add_`` adds with
    atomics otherwise). (b) MODEL_TRAIN_STEPS Adam steps (optax's rounding,
    ``OptaxBf16``) on ``fused`` and ``pallas``: each step's launches exact
    (``PER_STEP``, ``PER_STEP_PALLAS``) and its bf16-operand launches
    ``MODEL_TRAIN_BF16`` (every launch of 13-17 and 21 a bf16 form); finite
    losses; parameters, gradients, EMA and moments bfloat16; two identical
    steps' gradients the same bits; ms per step (host clock) in turns with
    the float32 model's on the same values. Returns each backend's
    bf16-operand launches per step, with kernel 13's apart."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    batch_np = next(iter(loader))
    avg_n = float(batch_np[keys.EDGE_MASK].sum()) / float(batch_np[keys.NODE_MASK].sum())
    kw = {**FLAGSHIP, "avg_num_neighbors": avg_n}
    values = {k: v.to(torch.bfloat16) for k, v in weights.items()}

    def model(dtype, backend):
        m = AllegroModel(**{**kw, "model_dtype": dtype}, tp_kernel_backend=backend)
        m.load_state_dict({k: v.to(m.model_dtype) for k, v in values.items()})
        return m

    grads, launches = {}, {}
    for dtype, backend in (("float32", "einsum"), ("bfloat16", "einsum"), ("bfloat16", "fused"),
                           ("bfloat16", "pallas")):
        trainer = make_trainer(model(dtype, backend), dev)
        state = trainer.init_state()
        data = trainer.to_device(batch_np)
        with deterministic_algorithms(backend == "einsum"):
            _, _, first = trainer.loss_and_grads(state, data)
            _, _, again = trainer.loss_and_grads(state, data)
        differ = [k for k in first if not torch.equal(first[k], again[k])]
        dtypes = {str(g.dtype) for g in first.values()}
        if differ or dtypes != {f"torch.{dtype}"} or not all(
                torch.isfinite(g).all() for g in first.values()):
            raise AssertionError(f"{dtype} {backend}: gradients {sorted(dtypes)}, finite or not, "
                                 f"two identical steps differ in {differ}")
        grads[dtype, backend] = first
        del trainer, state, data, again
        torch.cuda.empty_cache()
    print(f"[13c] first-step gradients, bfloat16 flagship on {int(batch_np[keys.NODE_MASK].sum())}"
          f" atoms: bfloat16, finite; two identical steps the same bits on each backend (einsum "
          f"under deterministic_algorithms)")
    for backend in ("fused", "pallas"):
        for ref in (("bfloat16", "einsum"), ("float32", "einsum")):
            spread, leaf = grad_spread(grads["bfloat16", backend], grads[ref])
            print(f"    {backend} vs the {ref[0]} einsum step: {spread:.3e} ({leaf}; <= "
                  f"{SPREAD_GRAD}, margin {SPREAD_GRAD - spread:.3e})")
            if not spread <= SPREAD_GRAD:
                raise AssertionError(f"bfloat16 {backend} gradients vs the {ref[0]} einsum "
                                     f"step's: {spread:.3e} of {leaf}")
    del grads
    torch.cuda.empty_cache()
    for backend, per_step in (("fused", PER_STEP), ("pallas", PER_STEP_PALLAS)):
        trainer = make_trainer(model("bfloat16", backend), dev)
        state = trainer.init_state()
        install, restore, swapped = _count_swapped(trainer.model.module.allegro.tps)
        install()
        try:
            for step in range(MODEL_TRAIN_STEPS):
                fused_tp.reset_launch_counts()
                swapped.update(swapped=0, own=0, other=0)
                trainer.fit(state, loader, max_epochs=1)
                torch.cuda.synchronize()
                bf16 = {k: c for k, c in fused_tp.BF16_LAUNCHES.items() if c}
                want_sw = MODEL_TRAIN_SWAPPED[backend]
                if fused_tp.LAUNCHES != per_step or bf16 != MODEL_TRAIN_BF16[backend] or \
                        swapped != {"swapped": want_sw, "own": per_step["gather_tp"] - want_sw,
                                    "other": 0}:
                    raise AssertionError(f"bfloat16 {backend} step {step}: launches "
                                         f"{fused_tp.LAUNCHES}, of them bf16 {bf16}, gather_tp "
                                         f"by table {swapped}; expected {per_step}, bf16 "
                                         f"{MODEL_TRAIN_BF16[backend]}, {want_sw} on the "
                                         "swapped tables and the rest on their own")
        finally:
            restore()
        losses = [h["train_loss"] for h in trainer.history]
        moments = [v for s in state.opt_state.state.values() for v in s.values()
                   if torch.is_tensor(v)]
        dtypes = {str(t.dtype) for t in (*state.params.values(), *state.ema_params.values(),
                                         *moments)}
        data = trainer.to_device(batch_np)
        _, _, first = trainer.loss_and_grads(state, data)
        _, _, again = trainer.loss_and_grads(state, data)
        differ = [k for k in first if not torch.equal(first[k], again[k])]
        dtypes |= {str(g.dtype) for g in first.values()}
        # ms per step in turns with the float32 model on the same values
        f32 = make_trainer(model("float32", backend), dev)
        f32_state = f32.init_state()
        turns = []
        for t in (trainer, f32, f32, trainer):
            s = state if t is trainer else f32_state
            t.fit(s, loader, max_epochs=1)  # a warm step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.fit(s, loader, max_epochs=1)
            torch.cuda.synchronize()
            turns.append(1e3 * (time.perf_counter() - t0))
        ms, ms_f32 = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        launches[backend] = {**MODEL_TRAIN_BF16[backend], "gather_tp[swapped]": swapped["swapped"]}
        print(f"[13b] {MODEL_TRAIN_STEPS} Adam steps (optax's bfloat16 rounding) on {backend}: "
              f"loss {losses[0]:.6e} -> {losses[-1]:.6e}; launches per step "
              f"{ {k: c for k, c in per_step.items() if c} }, of them bf16 forms "
              f"{MODEL_TRAIN_BF16[backend]}"
              + (f" (gather_tp on the swapped tables {swapped['swapped']}, on their own "
                 f"{swapped['own']})" if backend == "fused" else "")
              + f"; parameters, gradients, EMA and moments {sorted(dtypes)}; two identical steps "
              f"{'the same bits' if not differ else 'DIFFER in ' + ', '.join(differ)}; "
              f"{ms:.3f} ms/step (the float32 model's {ms_f32:.3f}, in turns, host clock); {smi}")
        if not np.isfinite(losses).all() or dtypes != {"torch.bfloat16"} or differ:
            raise AssertionError(f"bfloat16 {backend} training: losses {losses}, dtypes "
                                 f"{sorted(dtypes)}, two identical steps differ in {differ}")
        del trainer, state, f32, f32_state, data, first, again
        torch.cuda.empty_cache()
    return launches


def model_train_phase(fused, loaders, rng, dev, smi):
    """Phase 13 (13a ``check_model_train_forms`` at the 1k batch's shapes,
    13b/13c ``model_training``) on the flagship's weights from seed 0
    (``fused``'s) rounded to bfloat16. Returns the kernels line's rows of
    its forms."""
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.model import AllegroModel

    weights = {k: v.detach() for k, v in fused.state_dict().items()}
    loader = loaders["1k"]
    batch_np = next(iter(loader))
    avg_n = float(batch_np[keys.EDGE_MASK].sum()) / float(batch_np[keys.NODE_MASK].sum())
    models = {}
    for backend in ("fused", "pallas"):
        models[backend] = AllegroModel(**{**FLAGSHIP, "model_dtype": "bfloat16"},
                                       avg_num_neighbors=avg_n, tp_kernel_backend=backend).to(dev)
        models[backend].load_state_dict(weights)
    data = to_torch(models["fused"].precompute_statics(batch_np), dtype=torch.float32,
                    device=dev)
    records = {}
    print("[13a] the bf16-operand forms of kernels 13-17 and 21 (a bfloat16 model's training) "
          f"at the 1k batch's shapes ({int(batch_np[keys.NODE_MASK].sum())} atoms)")
    check_model_train_forms(models["fused"], models["pallas"], data, rng, records)
    del data, models
    torch.cuda.empty_cache()
    launches = model_training(weights, loader, dev, smi)
    return [model_train_record(n, name, records, launches) for n, name in MODEL_TRAIN_FORMS]


def model_train_record(n, name, records, launches):
    """The kernels line's row of kernel ``n``'s bf16-operand training form
    (``name[bf16 model train]``): its times at the 1k batch's shapes (13a,
    each timed case summed) and its launches in one training step of the
    bfloat16 flagship on that batch (13b; 13 counted apart from gather_tp's
    other launches)."""
    rec = records[name]
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    replaces = next(r for k, _, r in TPU_KERNELS if k == n)
    base = name.split("[")[0]
    backend = "pallas" if base == "sparse_tp_gradw" else "fused"
    step = launches[backend].get(name, 0)
    return {"name": f"{name}[bf16 model train]", "route": "cuda", "source": SOURCES[base],
            "replaces": replaces, "tpu_kernel": n, "launches": step,
            "launches_train_step": step, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": rec["library_ms"], "ms_f32_form": rec["ms_f32"],
            "max_ulps": rec["ulps"], **same_bits(rec),
            "ms_config": "bf16-operand form at the 1k training batch's shapes, each timed case "
                         "of phase 13a summed (13-15 and 21 both layers' tables, 21 in each "
                         "order a pallas step launches; 16 and 17 layer 0's basis)",
            "launches_config": f"one training step of the bfloat16 flagship on {backend} on the "
                               "1k batch (phase 13b)"}


def check_force_call(out, ref, n_atoms, n_rows):
    """Finite outputs of the right shape that agree with the einsum backend."""
    from allegro_tpu_torch.data import keys

    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"non-finite {k}")
    if out[keys.FORCES].shape != (n_rows, 3):
        raise AssertionError(f"forces shape {tuple(out[keys.FORCES].shape)}")
    f_f = out[keys.FORCES][:n_atoms].double()
    f_o = ref[keys.FORCES][:n_atoms].double()
    force_rel = ((f_f - f_o).abs().max() / f_o.abs().max().clamp_min(1e-6)).item()
    ea_f = out[keys.PER_ATOM_ENERGY][:n_atoms].double().cpu().numpy().ravel()
    ea_o = ref[keys.PER_ATOM_ENERGY][:n_atoms].double().cpu().numpy().ravel()
    ea_err = float(np.abs(ea_f - ea_o).max())
    print(f"    vs einsum on the card: force max-abs rel {force_rel:.3e} (< 1e-5), "
          f"per-atom energy max-abs {ea_err:.3e} (allclose 5e-5)")
    if not force_rel < 1e-5:
        raise AssertionError(f"forces vs einsum: rel {force_rel:.3e}")
    np.testing.assert_allclose(ea_f, ea_o, rtol=5e-5, atol=5e-5)


def run_md(model, einsum, frame, n_atoms, dev, smi):
    """Phase 4a: MD_BLOCKS blocks of NVE through ``md.Simulation``; its
    neighbor lists must come from the native C++ list."""
    from allegro_tpu_torch.data import keys, neighborlist
    from allegro_tpu_torch.md import MDState, Simulation, kinetic_energy
    from allegro_tpu_torch.md import maxwell_boltzmann_velocities
    from allegro_tpu_torch.ops import fused_tp

    types = frame[keys.ATOM_TYPES]
    kw = dict(atom_types=types, cell=frame[keys.CELL], pbc=frame[keys.PBC], device=dev, **MD)
    sim = Simulation(model, **kw)
    pos0 = frame[keys.POSITIONS]
    vel0 = maxwell_boltzmann_velocities(sim.masses_per_atom, MD_KT, seed=SEED)
    block = sim._block

    def no_sync_block(*args):
        # a host synchronization inside the block raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    sim._block = no_sync_block
    per_block = {k: n * (MD_STEPS_PER_BLOCK + 1) for k, n in PER_CALL["mega"].items()}
    state = MDState(pos0, vel0)
    neighborlist.reset_neighbor_list_counts()
    totals, times, rebuilt = [], [], []
    total_launches = {k: 0 for k in per_block}
    for b in range(MD_BLOCKS):
        rebuilds = sim.rebuilds
        fused_tp.reset_launch_counts()
        t0 = time.perf_counter()
        energies = []
        state = sim.run(state, MD_STEPS_PER_BLOCK, callback=lambda s, e: energies.append(e))
        times.append(time.perf_counter() - t0)
        rebuilt.append(sim.rebuilds > rebuilds)
        if fused_tp.LAUNCHES != per_block:
            raise AssertionError(f"MD block {b}: launches {fused_tp.LAUNCHES}, "
                                 f"expected {per_block} ({MD_STEPS_PER_BLOCK + 1} force calls)")
        for k, n in fused_tp.LAUNCHES.items():
            total_launches[k] += n
        if not np.isfinite(state.positions).all() or not np.isfinite(state.velocities).all():
            raise AssertionError(f"MD block {b}: non-finite positions or velocities")
        totals.append(energies[-1] + kinetic_energy(state.velocities, sim.masses_per_atom))
        if b == 0:
            first = state.positions.copy()
    steps = MD_BLOCKS * MD_STEPS_PER_BLOCK
    print(f"[4] MD: {steps} steps on fused_infer (mega), {sim.rebuilds} neighbor lists "
          f"(edge bucket {sim._edge_bucket}, grown {sim.bucket_grows}x), "
          f"launches per block {per_block}")
    if sim.rebuilds < 2:
        raise AssertionError("MD: no re-neighboring happened")
    check_native_lists(sim.rebuilds)
    ref_sim = Simulation(einsum, **kw)
    ref = ref_sim.run(MDState(pos0, vel0), MD_STEPS_PER_BLOCK)
    dpos = float(np.abs(first - ref.positions).max())
    print(f"    after block 1: max |dpos| vs einsum {dpos:.3e} A (< {MD_TOL})")
    if not dpos < MD_TOL:
        raise AssertionError(f"MD positions vs einsum: {dpos:.3e}")
    e = np.asarray(totals)
    drift = float(np.abs(e - e[0]).max())
    steady = [t for t, r in zip(times, rebuilt) if not r] or times
    ms_step = 1e3 * float(np.median(steady)) / MD_STEPS_PER_BLOCK
    print(f"    NVE total energy {e[0]:.6f} -> {e[-1]:.6f}, max |drift| {drift:.3e} "
          f"({drift / abs(e[0]):.3e} rel) over {steps} steps")
    print(f"    {ms_step:.3f} ms/step, {ms_step * 1e3 / n_atoms:.3f} us/atom per step "
          f"(median of {len(steady)} blocks without a rebuild; all {steps} steps with "
          f"rebuilds {1e3 * sum(times) / steps:.3f} ms/step; {smi})")
    return total_launches


def check_native_lists(rebuilds):
    """The neighbor lists since the last reset: all ``rebuilds`` of them
    built by the native C++ list (``data.neighborlist.NEIGHBOR_LISTS``)."""
    from allegro_tpu_torch.data import neighborlist

    lists = dict(neighborlist.NEIGHBOR_LISTS)
    print(f"    neighbor lists built: {lists}")
    if lists != {"native": rebuilds, "scipy": 0}:
        raise AssertionError(f"{rebuilds} rebuilds, lists {lists}: not all native")


def run_per_type_md(mega, mega_data, frame, n_atoms, n_edges, dev, smi):
    """Phase 4c: the flagship with ``PER_TYPE_CUTOFF`` on the default mega
    path: the per-type neighbor list (native) against the r_max list's
    edges; one force call with the exact launches of ``PER_CALL["mega"]``
    held to ``einsum`` as in phase 3, two calls with the same bits, and its
    µs/atom in turns with the flagship's (``mega`` on ``mega_data``: flagship,
    per-type, per-type, flagship); ``PER_TYPE_MD_STEPS`` MD steps with the
    per-type skin, all lists native, positions within ``MD_TOL`` of
    ``einsum`` MD, ms/step by block."""
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, neighborlist, to_torch
    from allegro_tpu_torch.md import MDState, Simulation, maxwell_boltzmann_velocities
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.model.builders import _per_edge_type_cutoff_matrix
    from allegro_tpu_torch.ops import fused_tp

    matrix = _per_edge_type_cutoff_matrix(PER_TYPE_CUTOFF, FLAGSHIP["type_names"], R_MAX)
    neighborlist.reset_neighbor_list_counts()
    pt_frame = neighbor_list(frame, R_MAX, matrix)
    check_native_lists(1)
    n_pt = pt_frame[keys.EDGE_INDEX].shape[1]
    print(f"[4c] per-edge-type cutoffs {PER_TYPE_CUTOFF} (rows: center type): {n_pt} edges, "
          f"{n_edges} at r_max {R_MAX} for every pair")
    if not n_pt < n_edges:
        raise AssertionError("the per-type cutoffs drop no edge")
    kw = {**FLAGSHIP, "per_edge_type_cutoff": PER_TYPE_CUTOFF, "avg_num_neighbors": n_pt / n_atoms}
    model = AllegroModel(**kw, tp_kernel_backend="fused_infer").init(SEED).to(dev)
    if model.routes() != FLAGSHIP_ROUTES:
        raise AssertionError(f"per-type model routes {model.routes()}")
    einsum = AllegroModel(**kw, tp_kernel_backend="einsum").to(dev)
    einsum.load_state_dict(model.state_dict())
    batch = batch_frames([pt_frame], n_frames=1)
    data = to_torch(model.precompute_statics(batch), dtype=torch.float32, device=dev)
    ref = einsum.apply_with_derivatives(
        to_torch(einsum.precompute_statics(batch), dtype=torch.float32, device=dev))
    fused_tp.reset_launch_counts()
    out = model.apply_with_derivatives(data)
    if fused_tp.LAUNCHES != PER_CALL["mega"]:
        raise AssertionError(f"per-type force call: launches {fused_tp.LAUNCHES}")
    check_force_call(out, ref, n_atoms, batch[keys.POSITIONS].shape[0])
    if not bitwise_same(out, model.apply_with_derivatives(data)):
        raise AssertionError("per-type model: two identical force calls differ")
    turns = [time_force_call(m, d, n_atoms) for m, d in ((mega, mega_data), (model, data),
                                                         (model, data), (mega, mega_data))]
    us = float(np.mean(turns[1:3]))
    print(f"    two identical calls: the same bits; us/atom in turns, flagship | per-type | "
          f"per-type | flagship: {' | '.join(f'{t:.3f}' for t in turns)} ({n_atoms} atoms, "
          f"f32; {smi})")
    md_kw = dict(atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC],
                 device=dev, per_edge_type_cutoff=matrix, **MD)
    sim = Simulation(model, **md_kw)
    vel0 = maxwell_boltzmann_velocities(sim.masses_per_atom, MD_KT, seed=SEED)
    neighborlist.reset_neighbor_list_counts()
    fused_tp.reset_launch_counts()
    state, times = MDState(frame[keys.POSITIONS], vel0), []
    for _ in range(PER_TYPE_MD_STEPS // MD_STEPS_PER_BLOCK):
        rebuilds, t0 = sim.rebuilds, time.perf_counter()
        state = sim.run(state, MD_STEPS_PER_BLOCK)
        times.append((time.perf_counter() - t0, sim.rebuilds > rebuilds))
    check_native_lists(sim.rebuilds)
    calls = PER_TYPE_MD_STEPS // MD_STEPS_PER_BLOCK * (MD_STEPS_PER_BLOCK + 1)
    if fused_tp.LAUNCHES != {k: calls * n for k, n in PER_CALL["mega"].items()}:
        raise AssertionError(f"per-type MD: launches {fused_tp.LAUNCHES}")
    ref_state = Simulation(einsum, **md_kw).run(MDState(frame[keys.POSITIONS], vel0),
                                                PER_TYPE_MD_STEPS)
    dpos = float(np.abs(state.positions - ref_state.positions).max())
    ms_step = 1e3 * sum(t for t, _ in times) / PER_TYPE_MD_STEPS
    steady = [1e3 * t / MD_STEPS_PER_BLOCK for t, rebuilt in times if not rebuilt]
    print(f"    MD: {PER_TYPE_MD_STEPS} steps, {sim.rebuilds} neighbor lists (per-type skin "
          f"{MD['skin']}), max |dpos| vs einsum MD {dpos:.3e} A (< {MD_TOL}); ms/step by "
          f"block {[round(1e3 * t / MD_STEPS_PER_BLOCK, 3) for t, _ in times]} (rebuilt "
          f"{[r for _, r in times]}), {ms_step:.3f} over all ({smi})")
    if not np.isfinite(state.positions).all() or not dpos < MD_TOL:
        raise AssertionError(f"per-type MD positions vs einsum: {dpos:.3e}")
    return {"edges": n_pt, "us_per_atom": us, "md_ms_per_step": ms_step,
            "md_ms_per_step_without_rebuild": steady}


def run_calculator(model, frame, n_atoms, dev):
    """Phase 4b: three single-point calls on jittered copies of the crystal."""
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
    from allegro_tpu_torch.ops import fused_tp

    calc = AllegroCalculator(model, device=dev)
    rng = np.random.RandomState(CALC_SEED)
    total_launches = {k: 0 for k in fused_tp.LAUNCHES}
    for call in range(3):
        pos = frame[keys.POSITIONS] + CALC_JITTER * rng.randn(n_atoms, 3)
        fused_tp.reset_launch_counts()
        res = calc.calculate(pos, atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL],
                             pbc=frame[keys.PBC])
        if fused_tp.LAUNCHES != PER_CALL["mega"]:
            raise AssertionError(f"calculator call {call}: launches {fused_tp.LAUNCHES}")
        for k, n in fused_tp.LAUNCHES.items():
            total_launches[k] += n
        if call == 0:
            buckets = (calc.n_atoms_pad, calc.n_edges_pad)
        elif (calc.n_atoms_pad, calc.n_edges_pad) != buckets:
            raise AssertionError(f"calculator buckets grew: {buckets} -> "
                                 f"{(calc.n_atoms_pad, calc.n_edges_pad)}")
        fr = neighbor_list({**frame, keys.POSITIONS: pos}, R_MAX)
        data = to_torch(model.precompute_statics(batch_frames([fr], n_frames=1)),
                        dtype=torch.float32, device=dev)
        want = model.apply_with_derivatives(data)
        f_w = want[keys.FORCES][:n_atoms].double().cpu().numpy()
        rel = float(np.abs(res["forces"] - f_w).max() / np.abs(f_w).max())
        e_w = want[keys.PER_ATOM_ENERGY][:n_atoms, 0].double().cpu().numpy()
        if not (np.isfinite(res["forces"]).all() and rel < 1e-5):
            raise AssertionError(f"calculator call {call}: forces rel {rel:.3e}")
        np.testing.assert_allclose(res["energies"], e_w, rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(res["energy"], want[keys.TOTAL_ENERGY].sum().item(),
                                   rtol=5e-5, atol=5e-5)
        print(f"    calculator call {call}: energy {res['energy']:.6f}, forces rel "
              f"{rel:.3e} vs apply_with_derivatives, buckets (atoms {calc.n_atoms_pad}, "
              f"edges {calc.n_edges_pad})")
    return total_launches


# phase 9: deployment (ROADMAP item 10). The flagship's force call exported
# (compile/export.py) on the ghost-format crystal, its list reaching r_max +
# DEPLOY_SKIN as the C++ driver's does, padded with room for the list to grow
# as the atoms move; the driver runs DEPLOY_STEPS velocity-Verlet steps on
# it, each type with its mass, the velocities drawn from DEPLOY_SEED
DEPLOY_SKIN = 0.1
DEPLOY_ROOM = 1.1
DEPLOY_STEPS = 20
DEPLOY_DT = 1e-3
DEPLOY_MASSES = (1.0, 2.0, 3.0)
DEPLOY_VELOCITY = 2.0
DEPLOY_SEED = 9
DEPLOY_TURNS = 5
DEPLOY_TIMEOUT = 900
PT2_FORCE_TOL = 1e-5  # a .pt2's forces against the eager call's (9b, 9e(b)), max-abs rel
BUILD_DRIVER = "from allegro_tpu_torch.native import build_md_driver; print(build_md_driver())"


def _outputs_rel(got, want):
    """Max-abs error over max-abs reference of each output, and whether all
    are the same bits."""
    rel = {k: rel_err(got[k], want[k])[1] for k in got}
    return rel, all(torch.equal(got[k], want[k]) for k in got)


def deploy_inputs(mega, dev):
    """The ghost-format crystal padded for the package: (the single-frame
    data with the host statics, the export's inputs, n_pad, e_pad, the
    padded host batch)."""
    from allegro_tpu_torch.compile import ghost_atom_conversion
    from allegro_tpu_torch.compile.targets import EXPORT_INPUTS
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
    from allegro_tpu_torch.data.atomic_data import round_up

    # the driver's system: wrapped positions (an atom just below a face sits
    # at the opposite one, with ghosts on both sides)
    pos, types, _, _, cell = driver_system()
    n_atoms = len(pos)
    frame = neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: types, keys.CELL: cell,
                           keys.PBC: np.ones(3, bool)}, R_MAX + DEPLOY_SKIN)
    ghost = ghost_atom_conversion(frame)
    ghost.pop("_ghost_owner")
    n_rows, n_edges = ghost[keys.POSITIONS].shape[0], ghost[keys.EDGE_INDEX].shape[1]
    n_pad = round_up(int(n_rows * DEPLOY_ROOM), 256)
    e_pad = round_up(int(n_edges * DEPLOY_ROOM), 4096)
    batch = batch_frames([ghost], n_atoms=n_pad, n_edges=e_pad, n_frames=1)
    for k in (keys.BATCH, keys.NUM_NODES, keys.FRAME_MASK):
        batch.pop(k)
    data = to_torch(mega.precompute_statics(batch), dtype=torch.float32, device=dev)
    print(f"[9] ghost-format crystal (wrapped): {n_atoms} atoms + {n_rows - n_atoms} ghosts, "
          f"{n_edges} edges within r_max + skin ({R_MAX + DEPLOY_SKIN}), padded to {n_pad} rows "
          f"and {e_pad} edges")
    return data, tuple(data[k] for k in EXPORT_INPUTS), n_pad, e_pad, batch


def check_program(mega, data, args, n_pad, e_pad):
    """9a: the exported program's module on the card against the eager call
    (1e-6 rel; the same bits expected: the same kernels and products)."""
    from allegro_tpu_torch.compile import LoadedModel, export_program
    from allegro_tpu_torch.ops import fused_tp

    fused_tp.reset_launch_counts()
    eager = mega.apply_with_derivatives(data)
    eager_launches = {k: v for k, v in fused_tp.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    program, meta = export_program(mega, n_atoms=n_pad, n_edges=e_pad)
    seconds = time.perf_counter() - t0
    ops = _atpt_counts(program.graph.nodes)
    if ops != eager_launches:
        raise AssertionError(f"9a: the program's atpt ops {ops}, the eager call's launches "
                             f"{eager_launches}")
    got = LoadedModel(program.module(), meta)(*args)
    rel, same = _outputs_rel(got, {k: eager[k] for k in got})
    print(f"[9a] exported program ({len(program.graph.nodes)} nodes; make_fx + torch.export "
          f"{seconds:.1f} s): atpt ops {ops}; vs eager max-abs rel "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, same bits: {same}")
    if max(rel.values()) > 1e-6:
        raise AssertionError(f"9a: exported program vs eager {rel}")
    return eager, eager_launches


def check_pt2(mega, data, eager, eager_launches, args, n_pad, e_pad, work, n_atoms, smi):
    """9b: the .pt2 loaded in this process: forces within 1e-5 rel of the
    eager call, energies within 5e-5 (JAX's compile tolerance), the same
    bits twice, the eager call's launches per call; compile seconds and
    eager against .pt2 µs/atom in turns. Returns the package's path and its
    launches per call."""
    from allegro_tpu_torch.compile import export_model, load_exported
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    t0 = time.perf_counter()
    path = export_model(mega, str(work / "flagship.pt2"), n_atoms=n_pad, n_edges=e_pad)
    compile_s = time.perf_counter() - t0
    loaded = load_exported(path)
    fused_tp.reset_launch_counts()
    first = loaded(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_tp.LAUNCHES.items() if v}
    second = loaded(*args)
    rel, _ = _outputs_rel(first, {k: eager[k] for k in first})
    _, same_twice = _outputs_rel(second, first)
    print(f"[9b] .pt2 built in {compile_s:.1f} s ({Path(path).stat().st_size} bytes); vs eager "
          f"max-abs rel { {k: f'{v:.2e}' for k, v in rel.items()} }; two calls the same bits: "
          f"{same_twice}; launches per call {launches}")
    if launches != eager_launches:
        raise AssertionError(f"9b: .pt2 launches {launches}, eager {eager_launches}")
    if not same_twice:
        raise AssertionError("9b: two identical .pt2 calls differ")
    if rel[keys.FORCES] > PT2_FORCE_TOL:
        raise AssertionError(f"9b: .pt2 forces vs eager rel {rel[keys.FORCES]:.3e}")
    for k in (keys.PER_ATOM_ENERGY, keys.TOTAL_ENERGY):
        np.testing.assert_allclose(first[k].double().cpu().numpy(),
                                   eager[k].double().cpu().numpy(), rtol=5e-5, atol=5e-5)
    times = {"eager": [], "pt2": []}
    for _ in range(DEPLOY_TURNS):
        for name, fn in (("eager", lambda: mega.apply_with_derivatives(data)),
                         ("pt2", lambda: loaded(*args))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) / n_atoms * 1e6)
    print("    in turns (host clock, synchronized; the eager call on host statics computed "
          "once, as MD's, the .pt2 computing its own in the graph): "
          + ", ".join(f"{k} {np.median(v):.3f} us/atom (runs {[round(x, 3) for x in v]})"
                      for k, v in times.items()) + f"; {n_atoms} atoms, {smi}")
    return path, launches


def driver_system():
    """The crystal for the C++ driver: its positions wrapped into the cell,
    masses by type, velocities from DEPLOY_SEED."""
    from allegro_tpu_torch.data import keys

    frame, n_atoms = crystal_frame(N_ATOMS, R_MAX, SEED)
    cell = frame[keys.CELL]
    frac = frame[keys.POSITIONS] @ np.linalg.inv(cell)
    pos = (frac - np.floor(frac)) @ cell
    types = frame[keys.ATOM_TYPES]
    masses = np.asarray(DEPLOY_MASSES)[types]
    vel = DEPLOY_VELOCITY * np.random.RandomState(DEPLOY_SEED).randn(n_atoms, 3)
    return pos, types, masses, vel, cell


def eager_forces(mega, pos, types, cell, dev):
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch

    fr = neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: types, keys.CELL: cell,
                        keys.PBC: np.ones(3, bool)}, R_MAX)
    data = to_torch(mega.precompute_statics(batch_frames([fr], n_frames=1)),
                    dtype=torch.float32, device=dev)
    return mega.apply_with_derivatives(data)[keys.FORCES][:len(pos)].double().cpu().numpy()


def driver_binary(build):
    """9c: the C++ driver, built in the background (``build``), and its
    --selftest; returns the binary's path."""
    out, err = build.communicate(timeout=DEPLOY_TIMEOUT)
    if build.returncode != 0:
        print(err[-4000:], file=sys.stderr)
        raise AssertionError(f"9c: the driver build exited {build.returncode}")
    binary = out.strip().splitlines()[-1]
    selftest = subprocess.run([binary, "--selftest"], capture_output=True, text=True, timeout=60)
    if selftest.returncode != 0 or "selftest OK" not in selftest.stdout:
        raise AssertionError(f"9c: --selftest: {selftest.stdout[-1000:]} {selftest.stderr[-2000:]}")
    return binary


def run_driver(binary, path, mega, work, dev, smi, label="9c"):
    """9c (and 9e(c) on the 100k policy's package): the C++ driver runs one
    step and DEPLOY_STEPS steps of the crystal on the package: its step-0
    forces, recovered from the first Verlet displacement, within 1e-4 rel of
    the eager call's, and its final positions within 1e-4 A of a host
    float64 Verlet driven by the eager forces."""
    pos, types, masses, vel, cell = driver_system()
    init = work / "system.npz"
    np.savez(init, positions=pos, types=types.astype(np.int32), masses=masses, velocities=vel,
             cell=cell, pbc=np.ones(3, np.int32))
    reports = {}
    prefix = label.replace("(", "").replace(")", "")
    for steps in (1, DEPLOY_STEPS):
        cmd = [binary, "--artifact", path, "--init", str(init), "--steps", str(steps), "--dt",
               str(DEPLOY_DT), "--skin", str(DEPLOY_SKIN), "--out-prefix",
               str(work / f"{prefix}run{steps}_")]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=DEPLOY_TIMEOUT)
        if run.returncode != 0:
            print(run.stdout[-2000:])
            print(run.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"{label}: the driver exited {run.returncode}: {' '.join(cmd)}")
        reports[steps] = json.loads(run.stdout.strip().splitlines()[-1])
    x1 = np.load(work / f"{prefix}run1_positions.npy")
    f0 = 2.0 * masses[:, None] * (x1 - pos - DEPLOY_DT * vel) / DEPLOY_DT**2
    f_eager = eager_forces(mega, pos, types, cell, dev)
    f_rel = float(np.abs(f0 - f_eager).max() / np.abs(f_eager).max())
    # the host float64 Verlet on the eager forces (lists rebuilt every step)
    x, v, f = pos.copy(), vel.copy(), f_eager
    for _ in range(DEPLOY_STEPS):
        x = x + DEPLOY_DT * v + 0.5 * DEPLOY_DT**2 / masses[:, None] * f
        fn = eager_forces(mega, x, types, cell, dev)
        v = v + 0.5 * DEPLOY_DT / masses[:, None] * (f + fn)
        f = fn
    x_drv = np.load(work / f"{prefix}run{DEPLOY_STEPS}_positions.npy")
    d = (x_drv - x) @ np.linalg.inv(cell)
    x_err = float(np.abs((d - np.round(d)) @ cell).max())
    rep = reports[DEPLOY_STEPS]
    print(f"[{label}] allegro_md: --selftest OK; step-0 forces from the first displacement vs eager "
          f"rel {f_rel:.3e} (< 1e-4); after {DEPLOY_STEPS} steps ({rep['rebuilds']} list builds) "
          f"positions vs the host f64 Verlet max {x_err:.3e} A (< 1e-4), moved up to "
          f"{np.abs(x - pos).max():.3f} A; {rep['ms_per_step']:.3f} ms/step, first call "
          f"{rep['first_call_ms']:.1f} ms; kernel launches {rep['launches']}; {smi}")
    if not f_rel < 1e-4:
        raise AssertionError(f"{label}: driver step-0 forces rel {f_rel:.3e}")
    if not x_err < 1e-4:
        raise AssertionError(f"{label}: driver positions off by {x_err:.3e} A")
    if not any(rep["launches"].values()):
        raise AssertionError(f"{label}: the driver launched no kernel")
    return rep["launches"]


def check_cli_package(cli, tutorial_dir, dev):
    """9d: ``python -m allegro_tpu_torch compile`` on the tutorial's workdir
    (started in the background during 9b): its .pt2 loaded and called once
    on a synthetic frame, against the eager model of the same checkpoint."""
    import yaml

    from allegro_tpu_torch.cli import _global_options
    from allegro_tpu_torch.compile import load_exported
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
    from allegro_tpu_torch.data.datasets import synthetic_molecular_frames
    from allegro_tpu_torch.train.package import trained_model

    out, err = cli.communicate(timeout=DEPLOY_TIMEOUT)
    if cli.returncode != 0:
        print(out[-2000:])
        print(err[-4000:], file=sys.stderr)
        raise AssertionError(f"9d: the compile stage exited {cli.returncode}")
    loaded = load_exported(str(Path(tutorial_dir) / "model.pt2"))
    config = yaml.safe_load((REPO / "configs/tutorial.yaml").read_text())
    config["model"] = {**_global_options(config["global_options"]), **config["model"]}
    _, model, ckpt, cfg = trained_model(config, tutorial_dir, None)
    model.to(dev)
    frame = neighbor_list(synthetic_molecular_frames(1, n_atoms=21, spread=1.5, seed=5)[0],
                          float(cfg["model"]["r_max"]))
    batch = batch_frames([frame], n_atoms=loaded.n_atoms, n_edges=loaded.n_edges, n_frames=1)
    for k in (keys.BATCH, keys.NUM_NODES, keys.FRAME_MASK):
        batch.pop(k)
    got = loaded(*(batch[k] for k in (keys.POSITIONS, keys.EDGE_INDEX, keys.ATOM_TYPES,
                                      keys.NODE_MASK, keys.EDGE_MASK)))
    want = model.apply_with_derivatives(
        to_torch(model.precompute_statics(batch), dtype=torch.float32, device=dev))
    rel, _ = _outputs_rel(got, {k: want[k] for k in got})
    print(f"[9d] python -m allegro_tpu_torch compile on the tutorial's workdir (checkpoint "
          f"{ckpt}): {out.strip().splitlines()[-1]}; loaded, one call vs eager max-abs rel "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }")
    if not all(torch.isfinite(v).all() for v in got.values()) or max(rel.values()) > 1e-5:
        raise AssertionError(f"9d: the CLI's package vs eager {rel}")


# phase 9e (ROADMAP item 10's remainder): every model the port builds,
# exported at phase 9's padded shape. Each one's program module against its
# eager call on the card; the 100k policy's as a .pt2 (built in a child
# process from the start of phase 9) and in the C++ driver; every op's C++
# implementation against its Python wrapper
EXPORT_CHUNK_EDGES = 65536  # tp_chunk_edges of the einsum model: 2 slices of the padded list
EXPORT_MODELS = {
    "md.yaml (pallas)": None,  # configs/md.yaml's model as shipped, its own seed
    "fused": dict(tp_kernel_backend="fused"),
    "100k policy": dict(tp_kernel_backend="fused_infer", **POLICY_100K),
    "bf16 track, use_mega=False": dict(tp_kernel_backend="fused_infer",
                                       tensor_dtype="bfloat16", use_mega=False),
    "remat + checkpoint_energy": dict(tp_kernel_backend="fused_infer", remat=True,
                                      checkpoint_energy=True),
    "einsum, tp_chunk_edges": dict(tp_kernel_backend="einsum",
                                   tp_chunk_edges=EXPORT_CHUNK_EDGES),
}
# 9e(d): the op forms the six models do not reach, captured beside theirs
OP_CHECK_MODELS = {
    "fused, bf16 track": dict(tp_kernel_backend="fused", tensor_dtype="bfloat16"),
    "use_mega=False": dict(tp_kernel_backend="fused_infer", use_mega=False),
}
# 9e(b)'s memory reference: the 100k policy without its recomputes
NO_RECOMPUTE = {**EXPORT_MODELS["100k policy"], "remat": False, "checkpoint_energy": False}
# ... and its accuracy reference: the same weights in float64 on einsum
F64_ORACLE = dict(tp_kernel_backend="einsum", model_dtype="float64")
VARIANTS = {**EXPORT_MODELS, **OP_CHECK_MODELS, "100k policy, no recompute": NO_RECOMPUTE,
            "100k policy, float64 einsum oracle": F64_ORACLE}
OP_CHECK_ATOMS = 512  # the crystal of 9e(d)'s captured calls
EXPORT_REL_TOL = 1e-6
PT2_100K = """
import json, sys, time
import torch
import chip_smoke as cs
from allegro_tpu_torch.compile import export_model
weights, path, n_pad, e_pad = sys.argv[1:]
model = cs.export_variant("100k policy", torch.load(weights), torch.device("cuda", 0))
t = time.perf_counter()
export_model(model, path, n_atoms=int(n_pad), n_edges=int(e_pad))
print(json.dumps({"seconds": time.perf_counter() - t}))
"""
OPS_CHECK = """
import json, sys
import torch
torch.ops.load_library(sys.argv[1])
report = {}
for name, args, want in torch.load(sys.argv[2], weights_only=False):
    got = getattr(torch.ops.atpt, name)(*args)
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    same = len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    report.setdefault(name, []).append(bool(same))
print(json.dumps(report))
"""


def export_variant(name, state, dev):
    """A model of VARIANTS on ``dev``: the flagship at its crystal's mean
    neighbor count with the parameters ``state`` (``md.yaml``'s: its own,
    from its seed)."""
    import yaml

    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.train.config import build_model

    if name == "md.yaml (pallas)":
        cfg = yaml.safe_load((REPO / "configs/md.yaml").read_text())["model"]
        return build_model(cfg).init(int(cfg["seed"])).to(dev)
    model = AllegroModel(**{**FLAGSHIP, **VARIANTS[name]},
                         avg_num_neighbors=float(state["avg_num_neighbors"]))
    model.load_state_dict({k: v for k, v in state.items() if k != "avg_num_neighbors"})
    return model.to(dev)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the duration (ops without
    a deterministic form warn), restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _atpt_counts(nodes):
    """{op: nodes} of the ``atpt::`` calls among graph ``nodes``."""
    ops = {}
    for node in nodes:
        if str(node.target).startswith("atpt."):
            name = str(node.target).split(".")[1]
            ops[name] = ops.get(name, 0) + 1
    return ops


def _atpt_nodes(program):
    """``({op: nodes}, bf16 nodes)`` of a program: its ``atpt::`` calls, and
    those whose bf16 flag (``bf16`` or ``bf16_wexp``) is set."""
    bf16 = 0
    for node in program.graph.nodes:
        if str(node.target).startswith("atpt."):
            names = [a.name for a in node.target._schema.arguments]
            values = dict(zip(names, node.args), **node.kwargs)
            bf16 += bool(values.get("bf16") or values.get("bf16_wexp"))
    return _atpt_counts(program.graph.nodes), bf16


def _live_atpt_ops(program):
    """{op: nodes} of the program's ``atpt::`` calls that an output depends
    on: what a compiled package launches, since the compiler drops a pure
    op whose results nothing reads (a recompute's energy sum, say)."""
    live, todo = set(), [n for n in program.graph.nodes if n.op == "output"]
    while todo:
        node = todo.pop()
        if node not in live:
            live.add(node)
            todo.extend(node.all_input_nodes)
    return _atpt_counts(live)


def _launch_counts():
    from allegro_tpu_torch.ops import fused_tp

    torch.cuda.synchronize()
    return ({k: v for k, v in fused_tp.LAUNCHES.items() if v},
            sum(fused_tp.BF16_LAUNCHES.values()))


def check_exported_models(state, batch, args, n_pad, e_pad, dev):
    """9e(a): each model of EXPORT_MODELS exported at phase 9's padded shape
    (``export_program``); its program's module on the card holds one
    ``atpt::`` op per launch of the eager call, op by op (and one bf16 flag
    per bf16 launch), gives the eager outputs within 1e-6 rel (the same bits
    expected), and the same bits twice; its live ops (``_live_atpt_ops``)
    are counted for 9e(b). ``einsum``, the plain reference,
    sums with ``index_add_``, atomics on the card: its eager call and its
    program run under ``torch.use_deterministic_algorithms`` here. Returns
    {model: (model, data, eager outputs, eager launches, live ops)}."""
    from allegro_tpu_torch.compile import LoadedModel, export_program
    from allegro_tpu_torch.data import to_torch
    from allegro_tpu_torch.ops import fused_tp

    eager_runs = {}
    for name in EXPORT_MODELS:
        model = export_variant(name, state, dev)
        data = to_torch(model.precompute_statics(batch), dtype=torch.float32, device=dev)
        with contextlib.nullcontext() if model.on_kernels else deterministic():
            fused_tp.reset_launch_counts()
            eager = model.apply_with_derivatives(data)
            launches, bf16 = _launch_counts()
            t0 = time.perf_counter()
            program, meta = export_program(model, n_atoms=n_pad, n_edges=e_pad)
            seconds = time.perf_counter() - t0
            ops, flagged = _atpt_nodes(program)
            if ops != launches or flagged != bf16:
                raise AssertionError(f"9e(a) {name}: the program's atpt ops {ops} ({flagged} "
                                     f"bf16), the eager call's launches {launches} ({bf16} bf16)")
            loaded = LoadedModel(program.module(), meta)
            first, second = loaded(*args), loaded(*args)
        rel, same = _outputs_rel(first, {k: eager[k] for k in first})
        _, twice = _outputs_rel(second, first)
        print(f"[9e(a)] {name}{'' if model.on_kernels else ' (deterministic algorithms)'}: "
              f"exported in {seconds:.1f} s ({len(program.graph.nodes)} nodes; "
              f"meta tensor_dtype {meta['tensor_dtype']}, remat {meta['remat']}, "
              f"checkpoint_energy {meta['checkpoint_energy']}); atpt ops {ops} ({flagged} bf16) "
              f"= the eager launches; module vs eager max-abs rel "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, same bits: {same}; twice the same "
              f"bits: {twice}")
        if max(rel.values()) > EXPORT_REL_TOL or not twice:
            raise AssertionError(f"9e(a) {name}: module vs eager {rel}, twice the same: {twice}")
        eager_runs[name] = (model, data, eager, launches, _live_atpt_ops(program))
        del program, loaded, first, second
    return eager_runs


def _dead(launches, live):
    return {k: v - live.get(k, 0) for k, v in launches.items() if v != live.get(k, 0)}


def _peak_net_mib(fn):
    """Peak device memory of ``fn()`` net of what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _allclose_margin(f, ref):
    """max(|f - ref| - REF_RTOL |ref|): the reference allclose holds where
    this is at most REF_ATOL."""
    ref = ref.double()
    return ((f.double() - ref).abs() - REF_RTOL * ref.abs()).max().item()


def check_policy_pt2(child, path, run, state, batch, args, n_atoms, dev, smi):
    """9e(b): the 100k policy's .pt2 (built in ``child`` from the start of
    phase 9) loaded here: its forces within the reference allclose of the
    eager call's (the bf16 track's own criterion: an f32 package moves its
    products by ~5e-6, and stored bf16 features whose f32 value lies within
    that of a rounding midpoint round the other way, so 1e-5 rel is out of
    reach; the rel error and both calls' margins against the float64
    ``einsum`` oracle are printed), energies within 5e-5 of sum |E_i|, the
    same bits twice, and per call the
    launches of the program's live ops: the eager call's less the recomputed
    ops whose results nothing reads, which the compiler drops (a recompute
    merged into the forward would launch fewer still, and keep the
    activations remat drops); eager against .pt2 us/atom in turns, and each
    one's peak memory net of the inputs beside the track's call without
    remat and checkpoint_energy."""
    from allegro_tpu_torch.compile import load_exported
    from allegro_tpu_torch.data import keys, to_torch
    from allegro_tpu_torch.ops import fused_tp

    out, err = child.communicate(timeout=DEPLOY_TIMEOUT)
    if child.returncode != 0:
        print(out[-2000:])
        print(err[-4000:], file=sys.stderr)
        raise AssertionError(f"9e(b): the .pt2 build exited {child.returncode}")
    build_s = json.loads(out.strip().splitlines()[-1])["seconds"]
    model, data, eager, eager_launches, live = run
    loaded = load_exported(path)
    fused_tp.reset_launch_counts()
    first = loaded(*args)
    launches, bf16 = _launch_counts()
    second = loaded(*args)
    rel, _ = _outputs_rel(first, {k: eager[k] for k in first})
    _, same_twice = _outputs_rel(second, first)
    e_scale = float(eager[keys.PER_ATOM_ENERGY].abs().sum())
    e_err = float((first[keys.TOTAL_ENERGY].double() - eager[keys.TOTAL_ENERGY].double()).abs()
                  .max())
    margin = _allclose_margin(first[keys.FORCES], eager[keys.FORCES])
    oracle = export_variant("100k policy, float64 einsum oracle", state, dev)
    ref = oracle.apply_with_derivatives(to_torch(oracle.precompute_statics(batch),
                                                 dtype=torch.float64, device=dev))[keys.FORCES]
    to_oracle = {k: _allclose_margin(out[keys.FORCES], ref) for k, out in (("eager", eager),
                                                                          (".pt2", first))}
    del oracle, ref
    print(f"[9e(b)] 100k policy .pt2 built in {build_s:.1f} s (child process, from the start of "
          f"phase 9; {Path(path).stat().st_size} bytes); vs eager max-abs rel "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (forces "
          f"{'within' if rel[keys.FORCES] <= PT2_FORCE_TOL else 'beyond'} {PT2_FORCE_TOL}), "
          f"forces' reference allclose margin {margin:.3e} (<= {REF_ATOL}), "
          f"energy {e_err:.2e} of sum |E_i| {e_scale:.4g}; forces' margin against the float64 "
          f"einsum oracle: { {k: f'{v:.3e}' for k, v in to_oracle.items()} }; two calls the "
          f"same bits: {same_twice}; launches per call {launches} "
          f"({bf16} bf16) = the program's live ops; of the eager call's, not launched (dead "
          f"recomputes): {_dead(eager_launches, live)}")
    if launches != live:
        raise AssertionError(f"9e(b): .pt2 launches {launches}, the program's live ops {live} "
                             f"(eager {eager_launches})")
    if not same_twice:
        raise AssertionError("9e(b): two identical .pt2 calls differ")
    if not margin <= REF_ATOL:
        raise AssertionError(f"9e(b): .pt2 forces miss the reference allclose of eager's: "
                             f"margin {margin:.3e}")
    if e_err > 5e-5 * e_scale:
        raise AssertionError(f"9e(b): .pt2 energy off by {e_err:.3e} of sum |E_i| {e_scale:.4g}")
    np.testing.assert_allclose(first[keys.PER_ATOM_ENERGY].double().cpu().numpy(),
                               eager[keys.PER_ATOM_ENERGY].double().cpu().numpy(),
                               rtol=5e-5, atol=5e-5)
    times = {"eager": [], "pt2": []}
    for _ in range(DEPLOY_TURNS):
        for name, fn in (("eager", lambda: model.apply_with_derivatives(data)),
                         ("pt2", lambda: loaded(*args))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) / n_atoms * 1e6)
    print("    in turns (host clock, synchronized): " + ", ".join(
        f"{k} {np.median(v):.3f} us/atom (runs {[round(x, 3) for x in v]})"
        for k, v in times.items()) + f"; {n_atoms} atoms, {smi}")
    no_recompute = export_variant("100k policy, no recompute", state, dev)
    peaks = {"eager": _peak_net_mib(lambda: model.apply_with_derivatives(data)),
             ".pt2": _peak_net_mib(lambda: loaded(*args)),
             "eager without remat and checkpoint_energy": _peak_net_mib(
                 lambda: no_recompute.apply_with_derivatives(data))}
    print("    peak memory net of the inputs: " + ", ".join(
        f"{k} {v:.1f} MiB" for k, v in peaks.items()) + f"; {smi}")
    return launches
def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, (list, tuple)):
        return type(v)(_clone(x) for x in v)
    return v


def _form(v):
    """The dtypes and flags of an op call's arguments: one case per form."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype)
    if isinstance(v, (list, tuple)):
        return tuple(_form(x) for x in v)
    return v if isinstance(v, bool) or v is None else "value"


def capture_op_calls(state, dev):
    """9e(d)'s cases: every ``atpt::`` op form that the models of
    EXPORT_MODELS and OP_CHECK_MODELS call in a force call on an
    OP_CHECK_ATOMS-atom crystal (their eager calls inside
    ``custom_ops.tracing()``, so the Functions call the ops, whose
    implementations run the Python wrappers on the card): [(op, arguments,
    outputs)], one per op and form of its arguments."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from allegro_tpu_torch.data import batch_frames, to_torch
    from allegro_tpu_torch.ops import custom_ops

    cases = {}

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "atpt":
                key = (func._schema.name, _form(args))
                if key not in cases:
                    outs = list(out) if isinstance(out, (list, tuple)) else [out]
                    cases[key] = (func._schema.name.split("::")[1], _clone(args), _clone(outs))
            return out

    frame, _ = crystal_frame(OP_CHECK_ATOMS, R_MAX, SEED)
    batch = batch_frames([frame], n_frames=1)
    for name in (*EXPORT_MODELS, *OP_CHECK_MODELS):
        model = export_variant(name, state, dev)
        data = to_torch(model.precompute_statics(batch), dtype=torch.float32, device=dev)
        with custom_ops.tracing(), Capture():
            model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    return list(cases.values())


def check_op_implementations(cases, work):
    """9e(d): each captured op call again, through ``csrc/torch_ops.cpp``'s
    CUDA implementation, in a child process that loads that library
    (``native.build_torch_ops``, built with the driver) and does not import
    ``ops/custom_ops.py`` (both define the ``atpt`` namespace): the same
    outputs, bit for bit."""
    from allegro_tpu_torch.native import build_torch_ops
    from allegro_tpu_torch.ops import custom_ops

    path = work / "op_cases.pt"
    torch.save(cases, path)
    run = subprocess.run([sys.executable, "-c", OPS_CHECK, str(build_torch_ops()), str(path)],
                         capture_output=True, text=True, timeout=DEPLOY_TIMEOUT, cwd=REPO)
    if run.returncode != 0:
        print(run.stdout[-2000:])
        print(run.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"9e(d): the op check exited {run.returncode}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    forms = {name: f"{sum(same)}/{len(same)}" for name, same in report.items()}
    print(f"[9e(d)] csrc/torch_ops.cpp's op implementations vs the Python wrappers on the same "
          f"inputs ({OP_CHECK_ATOMS}-atom crystal), forms the same bits: {forms}")
    missing = sorted(set(custom_ops.SCHEMAS) - set(report))
    if missing or not all(all(same) for same in report.values()):
        raise AssertionError(f"9e(d): ops not held {missing}; report {report}")


def deploy_phase(mega, dev, smi, tutorial_dir, stamp):
    """Phase 9: the flagship's force call exported (9a), built into a .pt2
    and run from Python (9b) and from the C++ MD driver (9c), and the CLI's
    compile stage on the tutorial's workdir (9d); then every model the port
    builds exported (9e). The driver's build, the CLI and the 100k policy's
    .pt2 build start in the background before 9a. Returns each .pt2's
    launches per call: {"flagship": ..., "100k_policy": ...}."""
    work_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_")
    work = Path(work_dir.name)
    data, args, n_pad, e_pad, batch = deploy_inputs(mega, dev)
    n_atoms = N_ATOMS
    state = {k: v.cpu() for k, v in mega.state_dict().items()}
    state["avg_num_neighbors"] = float(mega.builder_kwargs["avg_num_neighbors"])
    torch.save(state, work / "weights.pt")
    pipes = dict(cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    build = subprocess.Popen([sys.executable, "-c", BUILD_DRIVER], **pipes)
    cli = subprocess.Popen([sys.executable, "-m", "allegro_tpu_torch", "compile", "-c",
                            "configs/tutorial.yaml", "-w", str(tutorial_dir), "-o", "model.pt2"],
                           **pipes)
    policy_path = str(work / "policy_100k.pt2")
    policy = subprocess.Popen([sys.executable, "-c", PT2_100K, str(work / "weights.pt"),
                               policy_path, str(n_pad), str(e_pad)], **pipes)
    try:
        stamp("9a")
        eager, eager_launches = check_program(mega, data, args, n_pad, e_pad)
        stamp("9b")
        path, launches = check_pt2(mega, data, eager, eager_launches, args, n_pad, e_pad, work,
                                   n_atoms, smi)
        stamp("9c")
        binary = driver_binary(build)
        run_driver(binary, path, mega, work, dev, smi)
        stamp("9d")
        check_cli_package(cli, tutorial_dir, dev)
        stamp("9e")
        runs = check_exported_models(state, batch, args, n_pad, e_pad, dev)
        stamp("9e(b)")
        policy_launches = check_policy_pt2(policy, policy_path, runs["100k policy"], state,
                                           batch, args, n_atoms, dev, smi)
        stamp("9e(c)")
        driver_launches = run_driver(binary, policy_path, runs["100k policy"][0], work, dev, smi,
                                     "9e(c)")
        print(f"    the 100k policy's package in the driver: launches {driver_launches}")
        stamp("9e(d)")
        del runs
        torch.cuda.empty_cache()
        check_op_implementations(capture_op_calls(state, dev), work)
    finally:
        for proc in (build, cli, policy):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        work_dir.cleanup()
    return {"flagship": launches, "100k_policy": policy_launches}


# phase 10: multi-device MD and data-parallel training, every mesh on this
# one card ([cuda:0] * D): the decompositions' force calls held to the
# undecomposed call, edge_shard over 2, MD on slab and brick, the Trainer
# over two rows
PARALLEL_CASES = (("slab", (2,)), ("slab", (4,)), ("brick", (2, 2, 1)), ("brick", (2, 2, 2)))
# energy, relative to sum |E_i|: the crystal's total (shifts 0, random
# weights) is a near-cancellation of per-atom energies of either sign, so
# float32 sums in another order move it far more than 1e-5 of itself
PARALLEL_E_TOL = 1e-5
PARALLEL_F_TOL = 5e-5  # forces, of max |F| (BASELINE's float32 model tolerance)
PARALLEL_TIMING_REPS = 5
PARALLEL_MD_STEPS = 20  # 2 blocks of MD_STEPS_PER_BLOCK
DP_SEEDS = TRAIN_SEEDS[:2]  # phase 5's 1k-atom crystals, one per row
DP_STEPS = 3


def _plain_force_data(model, frame, dev):
    """The frame as MD's force call takes it (no batch axis, edges sorted by
    center, the model's statics), on ``dev``."""
    from allegro_tpu_torch.data import keys, to_torch

    ei = frame[keys.EDGE_INDEX]
    order = np.argsort(ei[0], kind="stable")
    data = {keys.ATOM_TYPES: frame[keys.ATOM_TYPES], keys.EDGE_INDEX: ei[:, order],
            keys.EDGE_CELL_SHIFT: frame[keys.EDGE_CELL_SHIFT][order],
            keys.EDGE_MASK: np.ones(ei.shape[1], bool), keys.CELL: frame[keys.CELL][None],
            keys.PBC: frame[keys.PBC][None]}
    data = to_torch(model.precompute_statics(data), dtype=torch.float32, device=dev)
    data[keys.POSITIONS] = torch.as_tensor(frame[keys.POSITIONS], dtype=torch.float32,
                                           device=dev)
    return data


def _launches_of(fn):
    """The kernels' launches in one call of ``fn`` (counts set to 0 just
    before it and read just after) and its result."""
    from allegro_tpu_torch.ops import fused_tp

    fused_tp.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return dict(fused_tp.LAUNCHES), out


def _check_launches(label, got, per_unit, units):
    want = {k: units * n for k, n in per_unit.items()}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {units} x {per_unit}")
    if not any(got.values()):
        raise AssertionError(f"{label}: no kernel launched")


def _host_ms(fn, reps=PARALLEL_TIMING_REPS):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _force_error(e, f, ref, label):
    """The energy error over sum |E_i| (and, printed, over |E|) and the force
    error over max |F| against ``ref`` (energy, forces, sum |E_i|); raises
    beyond PARALLEL_E_TOL / PARALLEL_F_TOL."""
    e_ref, f_ref, scale = ref
    diff = abs(float(e) - float(e_ref))
    de = diff / scale
    f = torch.as_tensor(f, dtype=torch.float64).cpu()
    f_ref = torch.as_tensor(f_ref, dtype=torch.float64).cpu()
    df = float((f - f_ref).abs().max() / f_ref.abs().max())
    print(f"    {label}: energy {float(e):.6f} vs {float(e_ref):.6f} ({de:.3e} of sum|E_i| "
          f"{scale:.4f}; {diff / max(abs(float(e_ref)), 1e-30):.3e} of |E|), forces {df:.3e} "
          f"of max|F|")
    if not (de < PARALLEL_E_TOL and df < PARALLEL_F_TOL):
        raise AssertionError(f"{label}: energy {de:.3e} of sum|E_i| (< {PARALLEL_E_TOL}), "
                             f"forces {df:.3e} of max|F| (< {PARALLEL_F_TOL})")
    return de, df


def check_decomposed_calls(mega, frame, n_atoms, dev, smi):
    """10a: slab at D = 2 and 4, brick at (2, 2, 1) and (2, 2, 2), all on
    ``[dev] * D``, against the undecomposed force call: energy, forces, the
    same bits twice, launches D x the undecomposed call's, ms per call in
    turns. Returns the launches of each case's call."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.parallel import BrickDecomposition, SlabDecomposition
    from allegro_tpu_torch.parallel.accounting import decomposition_accounting

    pos, types = frame[keys.POSITIONS], frame[keys.ATOM_TYPES]
    cell, pbc = frame[keys.CELL], frame[keys.PBC]
    data = _plain_force_data(mega, frame, dev)
    ref_launches, (e_ref, f_ref) = _launches_of(lambda: mega.energy_forces(data))
    if ref_launches != PER_CALL["mega"]:
        raise AssertionError(f"10a: the undecomposed call launched {ref_launches}, not "
                             f"{PER_CALL['mega']}")
    scale = float(mega.apply(data, frozen=True)[keys.PER_ATOM_ENERGY].abs().sum())
    ref = (e_ref, f_ref[:n_atoms], scale)
    out = {}
    for kind, shape in PARALLEL_CASES:
        D = int(np.prod(shape))
        t0 = time.perf_counter()
        if kind == "slab":
            dd = SlabDecomposition(pos, types, cell, pbc, R_MAX, [dev] * D)
        else:
            dd = BrickDecomposition(pos, types, cell, pbc, R_MAX, [dev] * D, mesh_shape=shape)
        fn = dd.make_energy_forces_fn(mega)
        local = [torch.as_tensor(x, device=dev) for x in dd.scatter_positions(pos)]
        build_s = time.perf_counter() - t0
        label = f"{kind} {'x'.join(map(str, shape))}"
        launches, (e, f_local) = _launches_of(lambda: fn(local))
        _check_launches(f"10a {label}", launches, ref_launches, D)
        _force_error(e, dd.gather_forces(f_local), ref, f"10a {label}")
        e2, f2 = fn(local)
        if not (torch.equal(e, e2) and all(torch.equal(a, b) for a, b in zip(f_local, f2))):
            raise AssertionError(f"10a {label}: two identical calls differ")
        plain = [_host_ms(lambda: mega.energy_forces(data))]
        split = [_host_ms(lambda: fn(local))]
        split.append(_host_ms(lambda: fn(local)))
        plain.append(_host_ms(lambda: mega.energy_forces(data)))
        acct = decomposition_accounting(dd)
        print(f"[10a] {label}: {D} domains, No {dd.No}, L {dd.L}, El {dd.El}, ghost fraction "
              f"{acct['ghost_fraction']:.4f}, halo {acct['halo_bytes_per_device_step']} B per "
              f"domain per call; same bits twice; launches {D} x the undecomposed call's; "
              f"host build {build_s:.2f} s")
        print(f"    ms per call (host clock, in turns undecomposed/decomposed/decomposed/"
              f"undecomposed): {plain[0]:.3f} {split[0]:.3f} {split[1]:.3f} {plain[1]:.3f} "
              f"({n_atoms} atoms, f32, {D} domains on one card; {smi})")
        out[f"{kind}{''.join(map(str, shape))}"] = launches
    return ref_launches, ref, out


def check_edge_shard(mega, frame, n_atoms, dev, ref_launches, ref, smi):
    """10b: edge_shard over ``[dev] * 2`` against one device: energy and
    forces, launches 2 x the one-device call's."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.md import Simulation

    kw = dict(atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC],
              **{**MD, "skin": 0.0})
    one = Simulation(mega, device=dev, **kw)
    two = Simulation(mega, mesh=[dev, dev], **kw)
    pos = one._wrap(frame[keys.POSITIONS])
    x = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    for sim in (one, two):
        sim._rebuild(pos)
    _, (e1, f1) = _launches_of(lambda: one._energy_forces(x))
    launches, (e2, f2) = _launches_of(lambda: two._energy_forces(x))
    _check_launches("10b edge_shard x2", launches, ref_launches, 2)
    _force_error(e2, f2, (e1, f1, ref[2]), "10b edge_shard x2 vs one device")
    _force_error(e1, f1, ref, "10b edge_shard x1 vs 10a's call")
    ms = (_host_ms(lambda: one._energy_forces(x)), _host_ms(lambda: two._energy_forces(x)))
    print(f"[10b] edge_shard: shards of {[int(s[keys.EDGE_MASK].sum()) for s in two._shards]} "
          f"edges (whole centers); ms per call one device {ms[0]:.3f}, two shards {ms[1]:.3f} "
          f"(f32; {smi})")
    return launches


def run_parallel_md(mega, frame, n_atoms, dev, ref_launches, smi):
    """10c: PARALLEL_MD_STEPS steps of NVE with slab (D = 2) and brick
    (2, 2, 1) on ``[dev] * D`` against one-device edge_shard: positions
    within MD_TOL, launches per block D x (steps + 1) x the call's, ms per
    step."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.md import MDState, Simulation, maxwell_boltzmann_velocities

    kw = dict(atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL], pbc=frame[keys.PBC],
              **MD)
    ref = Simulation(mega, device=dev, **kw)
    vel0 = maxwell_boltzmann_velocities(ref.masses_per_atom, MD_KT, seed=SEED)
    start = MDState(frame[keys.POSITIONS], vel0)
    t0 = time.perf_counter()
    want = ref.run(start, PARALLEL_MD_STEPS)
    ref_ms = 1e3 * (time.perf_counter() - t0) / PARALLEL_MD_STEPS
    out = {}
    per_block = MD_STEPS_PER_BLOCK + 1
    for strategy, shape in (("slab", (2,)), ("brick", (2, 2, 1))):
        D = int(np.prod(shape))
        sim = Simulation(mega, mesh=[dev] * D, strategy=strategy,
                         mesh_shape=shape if strategy == "brick" else None, **kw)
        state, total = start, {}
        t0 = time.perf_counter()
        for _ in range(PARALLEL_MD_STEPS // MD_STEPS_PER_BLOCK):
            launches, state = _launches_of(lambda: sim.run(state, MD_STEPS_PER_BLOCK))
            _check_launches(f"10c {strategy} block", launches, ref_launches, D * per_block)
            total = {k: total.get(k, 0) + n for k, n in launches.items()}
        ms = 1e3 * (time.perf_counter() - t0) / PARALLEL_MD_STEPS
        dpos = float(np.abs(state.positions - want.positions).max())
        print(f"[10c] MD {strategy} {'x'.join(map(str, shape))}: {PARALLEL_MD_STEPS} steps, "
              f"{sim.rebuilds} decompositions, max |dpos| vs one-device edge_shard {dpos:.3e} A "
              f"(< {MD_TOL}); {ms:.3f} ms/step against edge_shard's {ref_ms:.3f} (host clock, "
              f"decompositions included; {smi})")
        if not (dpos < MD_TOL and np.isfinite(state.positions).all()):
            raise AssertionError(f"10c {strategy}: positions {dpos:.3e} A from edge_shard")
        out[f"md_{strategy}"] = total
    return out


def run_data_parallel(dev, smi):
    """10d: ``Trainer(mesh=[dev, dev])`` on ``fused`` over two 1k-atom
    crystals, one per row: the step's mean gradient equals the mean of the
    two one-row gradients to the bits, twice; launches 2 x a one-row step's;
    ms per step."""
    from allegro_tpu_torch.data import DataLoader, InMemoryDataset, keys
    from allegro_tpu_torch.train import Trainer

    frames = []
    for seed in DP_SEEDS:
        frame, _ = crystal_frame(TRAIN_ATOMS, R_MAX, seed)
        frames.append({**frame, keys.TOTAL_ENERGY: np.zeros(1),
                       keys.FORCES: np.zeros_like(frame[keys.POSITIONS])})
    batches = list(DataLoader(InMemoryDataset(frames, R_MAX), batch_size=1))
    one_model, _ = train_models(batches[0])
    two_model, _ = train_models(batches[0])
    one = make_trainer(one_model, dev)
    two = Trainer(two_model, learning_rate=1e-3, ema_decay=0.999, mesh=[dev, dev],
                  logger=lambda s: None)
    s1, s2 = one.init_state(), two.init_state()
    rows = [one.to_device(b) for b in batches]
    row_launches, (_, _, g0) = _launches_of(lambda: one.loss_and_grads(s1, rows[0]))
    _, _, g1 = one.loss_and_grads(s1, rows[1])
    launches, (_, _, g) = _launches_of(lambda: two.loss_and_grads(s2, rows))
    _check_launches("10d two rows", launches, row_launches, 2)
    _, _, again = two.loss_and_grads(s2, rows)
    for k in g:
        if not torch.equal(g[k], (g0[k] + g1[k]) / 2):
            raise AssertionError(f"10d: {k}'s mean gradient is not the rows' mean")
        if not torch.equal(g[k], again[k]):
            raise AssertionError(f"10d: {k}'s gradient differs between two identical steps")
    one_ms = _host_ms(lambda: one.train_step(s1, rows[0]), DP_STEPS)
    two_ms = _host_ms(lambda: two.train_step(s2, rows), DP_STEPS)
    print(f"[10d] data-parallel step on fused, 2 rows of {TRAIN_ATOMS} atoms on one card: mean "
          f"gradient = the rows' mean, same bits twice; launches 2 x a one-row step's; "
          f"{two_ms:.3f} ms/step against one row's {one_ms:.3f} (host clock; {smi})")
    return {"dp_step": launches}


def parallel_phase(mega, dev, smi, stamp):
    """Phase 10 (10a-10d); returns the launches of each run, by name."""
    frame, n_atoms = crystal_frame(N_ATOMS, R_MAX, SEED)
    stamp("10a")
    ref_launches, ref, runs = check_decomposed_calls(mega, frame, n_atoms, dev, smi)
    stamp("10b")
    runs["edge_shard2"] = check_edge_shard(mega, frame, n_atoms, dev, ref_launches, ref, smi)
    stamp("10c")
    runs.update(run_parallel_md(mega, frame, n_atoms, dev, ref_launches, smi))
    stamp("10d")
    runs.update(run_data_parallel(dev, smi))
    return runs


if __name__ == "__main__":
    sys.exit(main())
