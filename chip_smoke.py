#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It fails (exit code 1, no result line) where CUDA is not available or
the package is missing.  Phases, each fatal on failure:

1. **Build.**  Compiles every CUDA kernel source in
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` each, all started together)
   for ``sm_90a`` and prints the build time, the compiler's register
   and spill report, and the card's name and power limit; for each
   tensor-core kernel (B3, B4, B5 in bf16 and f16 at each head dim they
   are built for and past head dim 128, B2 in bf16) its
   registers, spill bytes and tensor-core instructions (``HMMA``/``HGMMA``
   in ``cuobjdump -sass``, or "not measured" without that tool).  Fails
   if B3, B4 or B5 spills at D = 64 or runs no HMMA there, or B3, B4 or
   B5 past 128 or B2 does.
1b. **Tensor-core sums vs sequential FMAs.**  A kernel compiled by NVRTC
   chains ``mma.sync`` over k as B4 and B5 do and measures, on random
   normal bf16 rows at each head dim (16 to 128, and 136, 256 and 512 as
   the chunked kernels chain their chunks), how far its dot products
   fall from sequential f32 FMAs, in units of 2^-24 |a| |b|; fails above
   the bound under which B4 and B5 take a bf16 rounding as settled
   (scaled by sqrt(D / 128) past 128).
2. **Forward kernel vs plain.**  Calls B3's wrapper on the card at the
   serving path's largest shape, (B, H, T, D) = (8, 12, 512, 64), in
   bf16 and f32, for a ragged key-padding mask with one fully masked
   batch row, causal, an additive (H, T, T) bias, and dropout 0.1 with
   fixed seed words, and the mask and causal cases again at T = 305,
   off the kernel's tile grid; at the training path's shape (32, 12,
   128, 64) with the training batch's mask and dropout 0.1; at head dims
   16, 32, 48, 96 and 128 at (2, 3, 200, D) with every option at once;
   at head dims 130 (rows not 16-byte aligned), 136, 256 and 512 (the
   chunked kernels) there and at
   (4, 8, 512, D) with a mask, timed in every type; and at (70000, 1,
   16, 16), batch*heads past one grid dimension; in f16 the serving and
   training main cases, the head dims and the fold.
   Holds out and lse against the plain PyTorch version on the same
   inputs, and past head dim 128 a second launch bitwise against the
   first; times the main cases and the (4, 8, 512, D) ones (the kernel
   by CUDA events and by device time, past 128 also B3's own kernel
   alone, the plain version, and one library call of the same function,
   ``scaled_dot_product_attention``, timed here only, also by device
   time) beside the least time the card could take.
2b. **Backward kernels vs plain.**  B4 (dq) and B5 (dk, dv) on the same
   cases (head dims other than 16, 32, 64, 128 zero-padded by the
   wrapper), and on mask, causal, bias and dropout alone at the training
   shape; held against the plain backward on the same saved forward and
   upstream gradient (and that forward, B3's out and lse, against the
   plain forward), with exact zeros required for the fully masked row's
   out and dq and for the dk/dv rows of padding keys; B4's delta against
   the plain row sum bit for bit, and its keep words against the plain
   packed mask on every live pair; a second launch of
   B4 and B5 bitwise equal to the first; the share of live pairs whose
   16-bit rounding each kernel derived again.  The main cases' kernels
   timed alone by CUDA events and by their device time
   (``torch.profiler``), beside its bound; the whole backward as training
   runs it (``autograd.grad`` through `flash_attention`: B4, then B5) by
   device time, beside the plain backward and SDPA's backward alone
   (``autograd.grad`` through one SDPA forward; its kernels' device time,
   two windows).
2c. **Seed words by pointer.**  B4 captured in a CUDA graph with its
   seed words in a device buffer, replayed with two sets of words: each
   replay's keep words equal the plain mask of its own words, and the
   two differ.
2d. **The dropout kernels vs plain** (`csrc/dropout.cu`, not the port of
   a TPU kernel): the forward (its output and its packed keep bits) and
   the backward bitwise against their plain versions at BERT-base's
   (32, 128, 768) in bf16, f32 and f16, the word LM's (30, 32, 650) f32,
   an odd n, and contiguous views whose data start off a 16-byte boundary
   (the kernels' scalar head); the bits unpack to the plain mask, the
   keep rate within 0.01 of 1 - p where n >= 20000.  Each kernel timed
   by device time with its inputs out of L2 (a read of twice the L2
   between launches; warm beside it), against its bytes bound and its
   integer-work bound (the INT32-pipe instructions the function needs:
   a rotate and an xor a round, 20 rounds a hash, a hash a pair in the
   forward, a keep decision an element; over 64 a clock an SM at the
   card's SM count and maximum SM clock), beside the integer
   instructions of the kernel's own main loop counted in its SASS by
   ``cuobjdump -sass`` (a diagnostic), its plain version and torch's own
   dropout (forward) or ``native_dropout_backward`` from a bool mask
   (backward), other bits and other inputs: yardsticks only.
3. **Serving.**  BERT-base at full width (vocab 30522, units 768, FFN
   3072, 12 layers, 12 heads, max_length 512), random weights from a
   seed, cast to bf16 on ``cuda:0``, behind ``serve.Endpoint``
   (max_batch_size 8, sequence buckets 128/256/512; each bucket a CUDA
   graph): warmup, then 48
   requests of lengths spread over 1..512 from 4 client threads, timed,
   then the same traffic again, traced.  Every result must be finite
   and of its request's shape; the flash kernel's launches over the
   traced traffic, counted from the trace and by its wrapper, must each
   be 12 per dispatched batch;
   every warmed bucket's replay bitwise equal to its eager forward; the
   replayed batch timed and traced at (1, 128) and (8, 512); a
   ``swap_model`` to a second BERT-base under live traffic (every
   request served, the version flipped, a request after the flip equal
   to the new model's direct forward); one result is checked against
   the same request run alone, and against the same model with
   ``use_flash=False``.
4. **Where a forward's time goes.**  One forward at the largest and at
   the smallest bucket, timed back to back and traced with
   ``torch.profiler``: device time by kernel, and the share the card
   idles.
4c. **Serving breadth.**  (a) The endpoint's hooks, on an endpoint of
   phase 3's configuration over the same BERT-base (bf16, flash, 8 x
   (128 | 256 | 512) captured): phase 3's 48 requests from 4 clients in
   four windows, telemetry on and off in turns (req/s, execute p50/p99
   from a batch hook); a ``serve.model_call`` timeout injected once,
   retried once and answered within ``SERVE_REL_TOL`` of the request
   alone; one ``serve/<name>/batch`` span a batch in a running
   profiler's dump; two `Monitor.install_endpoint` rows a batch; the
   host us a batch of the hooks around no device call, on and off; the
   registry's ``mxtpu_serve_*`` counts equal to ``stats()``; after the
   storm below, ``swap_model(stage=True)`` with no miss after the flip
   and ``stage=False`` with one miss per warmed shape used.  (b)
   ``tools/storm.py``'s traffic shape: 96 requests of 1-512 tokens from
   6 clients (16 each, 0-4 ms apart, seeded), the classes interactive,
   standard and batch in turn, at the default deadlines, each run
   traced: through the bare endpoint; a `Fleet` of 2 replicas on the
   card (its ``RuntimeWarning`` required); the same with a faultline
   ``preempt`` at ``serve.replica``'s 24th dispatch; a 1-replica
   `Fleet`.  Gates: every future resolves, none failed or shed, every
   result within ``SERVE_REL_TOL`` of the request through the net alone,
   B3 12 a batch on the card and by its wrapper; with the kill, one
   replica dead, the recovered counter and the failover histogram
   ticked, each class's p99 within its objective.  (c) ``ContinuousBatcher``
   over the word LM (BASELINE config 5's ``RNNModel(10000, 650, 650, 2,
   "lstm", tie_weights=True)``, Xavier weights, bf16, greedy; the decode
   one CUDA graph over 8 slots): 32 prompts of 4-64 tokens with budgets
   of 8-64 and an ``eos_id``, all at once, then each alone through the
   same batcher.  Gates: each sequence's tokens bitwise its solo run's,
   one decode capture, no retrace, 1 host sync a step, 32 joins and 32
   leaves.  Printed (``fleet:``, ``continuous:``): req/s, tokens/s,
   latency by class, failover and kill seconds, batches a replica, peak
   memory; decode ms a replay, host ms a step, mean occupancy, prefill
   ms p50.
3b. **Training.**  ``BertForPretraining`` at the same width, dropout 0.1,
   bf16, the repo's pretraining loss (masked MLM + NSP) on a fixed
   32 x 128 batch with ragged valid lengths, Adam at lr 1e-4 through
   ``Trainer`` and ``FusedTrainStep``: 3 warm-up steps, then 30 timed
   steps, replays of the CUDA graph the second step captured, then 2
   more replays traced; and the eager path
   (``record``/``backward``/``Trainer.step``) timed beside them.  Every
   loss must be finite, the last five must average below the first,
   the step must be captured once, and each traced step must launch
   B3, B4 and B5 exactly 12 times and the dropout kernel 50 times, as
   the trace counts the kernels on the card and as their wrappers'
   bookkeeping counts them.  Then one eager step against one fused
   step, and against one replay, from the same state and seeds (within
   one bf16 ulp, equal losses); two replays from the same state draw
   different seed words and losses; after ``set_data`` of every
   parameter the step is captured again, with the eager step's loss
   and its autograd graph alive, and its replay equals the eager step;
   and flash against dense gradients (2 layers, f32, dropout 0;
   relative L2 per parameter within 1e-3).
4b. **Where a training step's time goes.**  One replayed and one eager
   step traced: device time, idle share, launches, the host's launch
   calls, top kernels, the device time of B3, B4, B5 and dropout by
   name, and the device-to-host syncs torch's sync debug mode reports.
3e. **Training in mixed precision, as the reference's amp does it.**
   ``BertForPretraining`` at the same width with ``remat=True``, f32
   parameters, ``amp.init("float16")`` and ``amp.init_trainer`` (a
   dynamic loss scaler from 2^16), LAMB under a linear-warmup
   ``PolyScheduler``, through a captured ``FusedTrainStep``: peak
   memory of one eager step with and without remat at (32, 128) and (8,
   512), and the two's gradients from the same weights and seed words,
   and a plain step's against a second plain one's: both bitwise (the
   embedding's backward sums in a fixed order; the worst difference
   against ``BWD_TOL["float16"]`` is printed beside); 3 warm-up and 15 timed
   replays, 2 traced (B3 24, B4 12, B5 12 and dropout 74 launches a
   step: B3 and the layers' dropout run again in the recompute); one
   traced and profiled replay (host syncs: exactly 1 with the scaler,
   the verdict's read); the eager triple (``record``, ``scale_loss``,
   ``backward``, ``Trainer.step``) timed and held against a replay
   (equal losses, weights within one f16 ulp); the scale forced to
   2^32: every overflowed replay holds weights and optimizer states
   bitwise and halves the scale, until two replays train again; a step
   without a scaler syncs 0 times a replay; the scale's trajectory
   (halved after an overflow, never below 1, otherwise flat or
   doubling); a finite, falling loss; the replayed step with and
   without remat timed alternately (``remat's cost``).  amp's patches
   are undone after the phase.
3c. **BERT at other head dims and in f16.**  Full width, 2 layers,
   ``use_flash=True``: head_dim 96 (units 768, 8 heads) and 4 heads of
   256 (units 1024, FFN 4096) in bf16 and BERT-base in f16, one forward
   and one eager Adam step each: finite outputs, loss and weights,
   B3/B4/B5 once a layer.
3d. **Flash vs dense crossover.**  (8, 12, T, 64) bf16 at T = 128 ..
   2048: device ms of flash and of the model's dense attention, forward
   alone and forward plus backward (``flash_crossover:`` lines); then,
   as the auto policy sees BERT's attention, at D = 64 (8, 12, T, 64)
   and D = 256 (8, 4, T, 256) with a (B, T) key-padding mask whose
   first 75 % of keys are valid: the forward in predict mode, and
   forward plus backward in train mode with attention dropout 0.1
   (``flash_crossover_masked:`` lines), and the smallest T of the grid
   from which flash wins at both head dims, forward alone and forward
   plus backward (``flash_crossover_policy:``), beside the policy's
   constants.
3f. **The operations layer on BERT-base's training step.**
   ``BertForPretraining`` as in 3b (full width and depth, bf16, (32,
   128), Adam, a captured ``FusedTrainStep`` whose dropout and flash
   seed words come from ``mx.random``'s default generator), 30 steps of
   their own seeded batches with telemetry on and a ``faultline`` plan
   of ``nan_grad`` at ``train.grads`` arrival 7; a
   ``CheckpointManager(keep=2, async_write=True)`` saves
   ``gather_training_state`` every 10 steps into a temporary directory
   (removed after).  Then the same seed and plan with ``preempt`` at
   arrival 23: the phase catches ``InjectedPreemption``, builds a fresh
   net, Trainer and step as a restarted process would (its generator
   reseeded elsewhere), restores the newest checkpoint and runs to step
   30.  Gates: the final parameters, Adam states, update counts and
   random stream bitwise the uninterrupted run's; step 7 leaves
   parameters and states bitwise as they were; the recovered and skipped
   counters tick once in each run, ``mxtpu_trainer_steps_total`` and the
   ``fused-step`` phase count equal the steps taken; each step captures
   once, the watchdog counts no retrace; a replay between saves makes no
   host sync and a save one; three replays under
   ``profiler.set_state("run")`` dump a chrome trace holding their three
   ``step/fused-step`` spans and B3, B4, B5 and both dropout kernels at
   the wrappers' counts (12, 12, 12 and 25 + 25 a step); the flight
   recorder's dump is of the reference's schema and holds the runs'
   phase, fault, recovery and checkpoint events; ``DivergenceSentinel``
   trips on no loss.  Printed (``ops:``): step ms replayed with
   telemetry on and off in turns, host ms a call, the save's ms on the
   host's path and the writer's ms, checkpoint MB, restore ms, each with
   the card's name and power limit.
5. **B1 vs plain.**  The BatchNorm-backward reduction at ResNet-50's
   nine batch-128 BatchNorm shapes and an odd one (C = 3, M = 2331),
   f32 made on the card from a seed: worst error against an allowance
   from the two summation orders, kernel, plain and library
   (``torch.batch_norm_backward_reduce``) times beside the bound; the
   stem case twice, which must agree bitwise.
6. **B2 vs plain.**  The space-to-depth stem conv, (128, 12, 112, 112)
   packed input to (128, 64, 112, 112) NCHW at batch 128 in f32 and
   bf16, and an odd case (3, 12, 15, 17) with C_out = 40: against the
   plain version (patches times the folded weight), B2's first design
   (the matmul over prebuilt patches) against its own, and the packed
   stem through B2 against cuDNN's 7x7/stride-2 conv of the unpacked
   input with the same weight; times (events and device) beside the
   bound, cuDNN's conv of the packed input (the library call), the
   first design, cuBLAS's product over prebuilt patches and cuDNN's
   7x7 stem.
7. **ResNet-50 v1 training** as ``bench.py`` builds it: Xavier, bf16,
   SoftmaxCrossEntropyLoss, SGD lr 0.1 momentum 0.9 through ``Trainer``
   and ``FusedTrainStep`` at batch 128 on one fixed seeded batch: 3
   warm-up steps, then 20 timed (replayed) steps and 2 traced, and the
   eager path timed beside them.  Every loss finite, the last five below
   the first, 53 B1 and 0 B2 launches per step (in the traced steps
   counted from the trace and by the wrappers), one capture; one eager
   step against a new fused step's eager first call and its third (a
   replay), each from the same state, the eager loss and its autograd
   graph alive across the capture (cuDNN pinned deterministic for it,
   the graph captured so): weights within one bf16 ulp, running
   statistics and losses equal; one replayed and one eager step traced
   as in 4b.
8. **The same with the space-to-depth stem**: ``features.0`` replaced
   by ``SpaceToDepthStem(64, in_channels=3)`` carrying the same weight,
   the input packed once on the card; 2 warm-up, 15 timed and 2 traced
   steps (the loss spikes at lr 0.1 over steps 4-8, so ten would leave
   the last five close to the first): falling losses, 1 B2 and 53 B1
   launches per step.
8b. **ResNet-50 trained from a RecordIO file**, ``bench.py``'s recordio
   rider in the port: the script writes ``bench.py``'s file (2048
   JPEG-encoded 256 x 256 low-frequency textures, labels 0-999, seed 0)
   with `recordio` into ``build/chip_smoke/``, then trains ResNet-50 v1
   as in 7 through a captured ``FusedTrainStep`` fed by
   ``DevicePrefetcher(depth=3, dtypes=(None, int32))`` (pinned slots, a
   side stream, events) from (a) ``ImageRecordIter(rand_crop,
   rand_mirror, shuffle)`` into ``RecNetWithLoss`` (uint8 NHWC to f32,
   normalised, bf16, NCHW inside the step) and (b) ``ImageRecordIter``'s
   256 x 256 canvases into ``AugNetWithLoss`` (`DeviceAugment` inside the
   step).  Where g++ cannot link libjpeg (`_native.jpeg_unavailable`,
   decided before anything runs), the native pipeline cannot be built:
   (a) is not run and (b) is fed the file's records decoded by Pillow
   (``NDArrayIter`` + ``ResizeIter``), and the output says so and why.
   Each variant: 3 warm-up steps, 20 chip-only steps re-stepping one
   resident batch (the weights put back after), two windows of 20 steps
   end to end, one step's host syncs, 2 traced steps.  Printed: the
   decode pool's and one thread's img/s (or Pillow's), the pinned H2D
   MB/s and img/s, chip-only and end-to-end img/s, the overlap bound (the
   least of the three) and the ratio to it; for (b) the augment's device
   ms alone and its share of a traced replay's device time.  Gates:
   losses finite, the last five below the first; 53 B1 launches a step
   counted on the card from the trace and by the wrapper; every batch
   the prefetcher delivered equal, bitwise on the card, to the host
   batch the source handed it; one capture; 0 host syncs a step; for
   (b), the crop offsets and flips of two replays' seed words differ, and
   on the card equal their plain CPU draw.
9. **B6 vs plain.**  The user kernels of ``USER_KERNELS_SRC`` (user
   code, as upstream's ``custom_softmax_rtc.py`` writes it) compiled
   once by NVRTC through ``rtc.CudaModule`` (timed): ``axpy``, the
   template ``scale<float>`` (found by its exported name) and
   ``row_reverse`` (80 KB of dynamic shared memory) held bitwise;
   ``softmax_fwd`` within `_softmax_tol` of its plain version and
   ``softmax_bwd`` bitwise, at the head's (128, 1000), BERT-base's MLM
   logits (640, 30522) and an odd (37, 1001), timed beside the bound,
   the plain version and ``torch.softmax``; ``scale_bf16`` (a bf16
   scalar argument) bitwise; the host's time per ``CudaKernel.launch``
   of ``axpy`` and of ``scale_bf16`` against torch's own launch of the
   same work (``add_``, ``mul``).
10. **ResNet-50 with the custom head**, as in 7 but trained in the
   eager loop (``record``, the net, its logits in f32 through
   ``mx.nd.Custom(logits, label, op_type="softmax_rtc")``,
   ``autograd.backward``, ``Trainer.step``): 3 warm-up and 20 timed
   steps.  Every loss (-log p[label], taken from the logits, since the
   head's f32 p[label] underflows to 0 for some samples while the loss
   spikes) finite, the last five below the first, 2 B6 launches
   (``softmax_fwd``, ``softmax_bwd``) and 53 B1 launches per step;
   the head's logits gradient within 1e-6 of autograd through
   SoftmaxCrossEntropyLoss;
   ``save_parameters`` + ``save_states``, loaded into a fresh net and
   trainer, whose next step must equal the running net's bitwise (cuDNN
   pinned deterministic); one step traced.  Then the same eager loop
   with SoftmaxCrossEntropyLoss in the head's place, from the same
   weights and batch, on the f32 and on the bf16 logits: the three loss
   curves side by side (``resnet_custom: loss curves``).

11. **The LSTM word language model** (BASELINE config 5), at the
   reference's ``example/rnn`` "medium" width (vocab 10000, embedding =
   hidden = 650, 2 layers), the recurrence plain torch ops (no TPU
   kernel lies on this path: the reference's is ``lax.scan`` over
   ``jnp`` ops).  (a) ``benchmark/rnn_lm_bench.py``'s step: its WordLM
   (Embedding, ``rnn.LSTM`` TNC, Dense over the vocabulary) in bf16,
   -mean(pick(log_softmax(f32 logits))), SGD lr 1.0 momentum 0.9
   through a captured ``FusedTrainStep`` on seeded (35, B) tokens, 3
   warm-up and 20 timed replays at B = 32 and 128.  Gates: finite
   losses, the last five below the first, one capture, 1 host launch
   call and 0 host syncs a replay (from the trace); at B = 32 the
   eager step against a new step's eager first call and against a
   replay (one bf16 ulp, equal losses), bf16 h_n and c_n and no f32
   matrix product in the eager step's trace (``record_shapes``).
   Printed: step ms replayed and eager, tokens/s, device ms, idle
   share, kernels a replay, the largest kernels, peak memory and the
   step's bound.  Beside it, off the path, cuDNN's fused LSTM
   (``torch.nn.LSTM(650, 650, num_layers=2)``, bf16) forward and
   backward over (35, 32, 650) against the port's ``rnn.LSTM`` on the
   same input.  (b) ``examples/rnn/word_lm.py``'s eager loop:
   ``RNNModel(10000, 650, 650, 2, "lstm", dropout=0.5,
   tie_weights=True)`` in f32, ``BucketSentenceIter(buckets=[10, 20,
   30], layout="TN", batch_size=32)`` over `learnable_corpus` (each
   token its predecessor's image under a fixed permutation with
   probability 0.9, else uniform: the example's own stream is noise no
   model can learn), ``record``, the loss, ``backward``,
   ``clip_global_norm(..., 0.25)``, ``Trainer.step``, SGD lr 1.0.
   Gates: the last 10 batches' mean loss below the first 10's by
   WORD_LM_MARGIN; the dropout kernel 2 launches a forward (4 a
   training batch) on the card and by its wrapper; the mask between
   the LSTM layers on the card bitwise its plain CPU computation from
   the same key words.

15. **Ranks** (``--ranks`` alone; `phase_ranks`).  Each world is this
   script started again with ``--ranks-worker`` and the launcher's three
   variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
   ``JAX_PROCESS_ID``), whose import of the package starts the rank's
   ``torch.distributed`` group; a rank that fails, or a world past
   RANKS_TIMEOUT, fails the script.  ResNet-50 v1 as `bench.py` builds
   it for the dp mesh (bf16, SoftmaxCrossEntropyLoss, SGD lr 0.1
   momentum 0.9, one seeded global batch of 128 at 224 x 224) through
   `FusedTrainStep(mesh=make_mesh({"dp": -1}))`.  (a) Two ranks share
   the card over gloo (the step's body eager), 64 rows a rank, 5 steps:
   the weights' digests equal on both ranks after every step, B1 53 a
   step on each, each step's ms, the collectives' ms in one more step
   timed call by call and their share, peak memory; on rank 0, step 1's
   per-row losses and each parameter's first update, and the mean loss
   and the weights after 3 steps, against one rank on the global batch,
   each within `RANKS_FACTOR` of the distance that rolling one rank's
   rows makes (`RANKS_ROLLS`, `RANKS_FLOOR`).  (b) An NCCL group of one
   rank: one capture, 0 host syncs a replay, B1 53 a replay traced on
   the card and booked by its wrapper, the weights after 3 steps
   bitwise the plain step's (cuDNN pinned deterministic), the replayed
   step's ms beside the plain step's.  (c) Four ranks over NCCL, one
   card each, where the machine has four cards, held as (a) is and
   each rank's replays traced as (b)'s; else "not run: N card(s)".  (d) Two
   ranks make the store; rank 1 exits after its second step and rank
   0's ``get_dead_nodes(timeout=3)`` must name it (``rank:`` lines).

Every measurement is printed on a line of its own (``kernel``,
``kernel_bwd``, ``kernel_bn``, ``kernel_stem``, ``kernel_rtc``,
``serve:``, ``fleet:``, ``continuous:``, ``train:``, ``train_amp:``,
``odd_bert:``, ``flash_crossover:``,
``ops:``, ``resnet:``, ``resnet_s2d:``, ``recordio:``, ``rtc:``, ``resnet_custom:``,
``rnn_lm:``, ``profile:``, ``dp:``, ``rank:``).  The last three lines are a ``{"kernels": [...]}``
object.  A captured path's ``launches`` are counted on the card, from
the ``torch.profiler`` trace of its traced run (`KERNEL_NAMES`), with
the wrappers' bookkeeping of the same run beside them as
``launches_booked``: B3 at the serving path's main case, bf16 with a
key-padding mask, with its launches over the traced traffic, at the
training case with its launches over the 2 traced BERT steps, its
D > 128 cases under ``wide_cases``, and under ``amp_f16_case`` the f16
training case with its launches over the 2 traced amp + remat steps; B4
and B5 at the BERT training path's main case, with their launches over
the traced steps, their D > 128 cases, and their ``amp_f16_case``; the
dropout forward and backward kernels at (32, 128, 768) bf16, each with
its launches over the traced BERT steps (``amp_launches``: over the
traced amp steps; ``rnn_lm_launches``: over the traced word-LM
batches); B1 at the
stem BatchNorm's shape,
with its launches over the 2 traced ResNet steps (``recordio_launches``:
over the 2 traced steps of each recordio variant); B2 at the bf16 stem,
with its launches over the 2 traced space-to-depth steps; B6 as
``softmax_fwd`` and ``softmax_bwd`` at the head's shape, with their
launches over the 20 timed custom-head steps), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import logging
import re
import statistics
import subprocess
import sys
import threading
import time

# H100 SXM data sheet (dense): HBM bandwidth and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

B, H, T, D = 8, 12, 512, 64
# A length off the 64-row tile grid: the kernel's last K and Q tiles are
# partial there (a request served alone runs at its own length)
T_RAGGED = 305
B_TRAIN, T_TRAIN = 32, 128
# Tolerances of kernel vs plain: |kernel - plain| <= atol + rtol |plain|
# + ptol A for out, A = sum_j p_j keep_j |v_j| / l (the plain forward on
# |v|), and |kernel - plain| <= atol for lse.  f32: both are true f32
# and differ only in summation order (online softmax by 64-key tiles vs
# whole rows).  bf16: both round each p * keep to bf16 before the PV
# product, the kernel against its running max and the plain version
# against the row max, so the two roundings of one term differ by up to
# two half-ulps, 2^-7 of it, and out's f32 values by up to 2^-7 A (ptol).
# A is about |out| where one key dominates but far larger where terms
# cancel (few live keys, large v: the training shape with dropout).
# Then both round out to bf16: one more ulp, at most 2^-7 |plain| (rtol).
# atol covers f32 summation order and the ulp of that ulp.  lse is f32 in
# both (values of 5-10).  f16 rounds at the same points with 11
# significant bits instead of 8: two half-ulps of a normal p * keep are
# 2^-10 of it (ptol) and out's own rounding one ulp, at most 2^-10
# |plain| (rtol).  Below 2^-14 f16 is subnormal with a fixed ulp of
# 2^-24, so a p * keep there may differ by 2^-24 outright: with l >= 1,
# keep <= 1/0.9, |v| < 6 and at most 512 such keys a row, 2.0e-4 more of
# out, on top of bf16's atol: 4e-4.
TOL = {"float32": {"out": (1e-4, 0.0, 0.0), "lse": 1e-4},
       "bfloat16": {"out": (2e-4, 2.0 ** -7, 2.0 ** -7), "lse": 1e-4},
       "float16": {"out": (4e-4, 2.0 ** -10, 2.0 ** -10), "lse": 1e-4}}
# B4/B5 vs the plain backward, |kernel - plain| <= atol + rtol |plain| for
# dq, dk and dv.  f32: both true f32, summation order only; the plain f32
# backward differs from a float64 one by under 7e-7 at (1, 4, 512, 64)
# (gradients of 0.02-1), so atol 1e-5.  bf16: both round ds and p*keep to
# bf16 at the same points and the result to bf16, so where their f32
# values straddle a rounding step they differ by one bf16 ulp of the
# result (rtol 1e-2 covers it) or of one ds term (some 1e-5 of a sum;
# atol 1e-3 covers many).  f16: the same rounding points with 3 more
# significant bits, so each straddle moves a result by 2^-3 of the bf16
# amount (one f16 ulp of the result is 2^-10 ~ 9.8e-4 of it: rtol
# 1.25e-3; atol 1.25e-4); ds and p*keep below 2^-14 are f16 subnormals,
# whose ties (a fixed ulp of 2^-24) the kernels test like any other.
BWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-3, 1e-2),
           "float16": (1.25e-4, 1.25e-3)}
# Kernel cases, (case, B, H, T, D): the serving path's largest shape, the
# same off the tile grid, the training path's shape with its own mask
# and dropout, the other head dims at a small shape off the grid with
# every option at once ("all": 16, 32, 128 natively, 48 and 96 through
# B3's rounding up to 16 and B4/B5's zero padding), and batch*heads past
# one grid dimension's 65535 (folded over two)
_SERVE_CASES = [(c, B, H, T, D) for c in ("ragged_mask", "causal", "bias",
                                          "dropout")] \
    + [(c, B, H, T_RAGGED, D) for c in ("ragged_mask", "causal")]
_TRAIN_CASE = ("train_mask_dropout", B_TRAIN, H, T_TRAIN, D)
_HEAD_DIM_CASES = [("all", 2, 3, 200, d) for d in (16, 32, 48, 96, 128)]
# head dims past 128 (the chunked kernels): every option at once at the
# small shape, and a key-padding mask at (4, 8, 512, D), timed in every type
WIDE_DIMS = (136, 256, 512)
_WIDE_CASES = [("all", 2, 3, 200, d) for d in WIDE_DIMS]
WIDE_TIMED = tuple(("ragged_mask", 4, 8, 512, d) for d in WIDE_DIMS)
# rows of 130 elements are not 16-byte aligned: the chunked kernels load,
# derive again and store them element by element (run after every other
# case in every type, so that those draw the inputs they drew before)
_ODD_WIDE_CASE = ("all", 2, 3, 200, 130)
_FOLD_CASE = ("ragged_mask", 70000, 1, 16, 16)
CASES = _SERVE_CASES + [_TRAIN_CASE] + _HEAD_DIM_CASES + [_FOLD_CASE] \
    + _WIDE_CASES + list(WIDE_TIMED)
BWD_CASES = _SERVE_CASES \
    + [(c, B_TRAIN, H, T_TRAIN, D) for c in ("ragged_mask", "causal",
                                             "bias", "dropout")] \
    + [_TRAIN_CASE] + _HEAD_DIM_CASES + [_FOLD_CASE] + _WIDE_CASES \
    + list(WIDE_TIMED)
# f16 on the main cases, the padded and the wide head dims and the fold
F16_CASES = [(c, *shape) for c, *shape in CASES
             if (c, *shape) in (("ragged_mask", B, H, T, D), _TRAIN_CASE,
                                _FOLD_CASE) + WIDE_TIMED or c == "all"]
# cases timed (the rest are checked only): in the forward, the serving and
# training main cases in every type, also by device time (torch.profiler),
# and every bf16 case at those two shapes; in the backward, the training
# case in every type and the same bf16 cases
DEVICE_TIMED = (("ragged_mask", B, H, T, D), _TRAIN_CASE)
BWD_TIMED = (_TRAIN_CASE,) + WIDE_TIMED
BWD_TIMED_BF16 = ((B, H, T, D), (B_TRAIN, H, T_TRAIN, D))
# BERT-base pretraining as `benchmark/bert_pretrain_bench.py` builds it
TRAIN_CFG = dict(vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 use_flash=True)
TRAIN_WARMUP, TRAIN_STEPS = 3, 30
# BERT-base pretraining in mixed precision as the reference's amp runs
# it: f32 parameters, amp.init("float16"), a dynamic loss scaler from
# 2^16, LAMB under a linear-warmup PolyScheduler, remat=True
AMP_CFG = dict(TRAIN_CFG, remat=True)
AMP_WARMUP, AMP_STEPS = 3, 15
AMP_SCHEDULE = dict(max_update=1000, base_lr=1e-3, pwr=1, warmup_steps=5)
# the forced overflow: a scale at which the f16 gradient of the MLM
# logits (|p - y| / valid tokens, ~3e-4 at most) passes f16's 65504
AMP_FORCED_SCALE = 2.0 ** 32
AMP_MAX_BACKOFF = 12
# eager vs replayed amp step: the f32 master weights within one f16 ulp
# of the weight (2^-10 |w|, the precision the products run in); bitwise
# is expected, as for the bf16 step, and elements differing are printed
AMP_ULP = 2.0 ** -10
# peak memory with and without remat at the training shape and at T 512
AMP_MEM_SHAPES = ((B_TRAIN, T_TRAIN), (8, 512))
# one bf16 ulp of a weight is at most 2^-7 of its magnitude
EAGER_FUSED_ULP = 2.0 ** -7
# flash vs dense gradients in f32 with TF32 off: both true f32, they
# differ in summation order and in the masked fill (-1e30 vs -1e9, both
# exp to exactly 0)
GRAD_REL_TOL = 1e-3
# BERT-base in bf16: one request served in a padded batch vs alone, and
# flash vs dense attention, as a relative L2 error over its valid rows
SERVE_REL_TOL = 2e-2
N_CLIENTS, PER_CLIENT = 4, 12
SEQ_BUCKETS = (128, 256, 512)
# the port's kernels by the names the profiler's trace gives them: the
# launches of the main paths are counted from these records, which see
# the kernels a CUDA graph replays (the wrappers count only at capture)
KERNEL_NAMES = {
    "flash_attention_fwd": r"\bflash_fwd_\w+_kernel\b",
    "flash_attention_bwd_dq": r"\bflash_bwd_dq_\w+_kernel\b",
    "flash_attention_bwd_dkv": r"\bflash_bwd_dkv_\w+_kernel\b",
    # both dropout kernels; the backward alone as dropout_bwd
    "dropout": r"\bdropout_(?:fwd|bwd)_kernel\b",
    "dropout_bwd": r"\bdropout_bwd_kernel\b",
    "bn_bwd_reduce": r"\bbn_reduce_partial\b",
    "bn_bwd_reduce_rows": r"\bbn_reduce_rows_partial\b",
    "stem_conv": r"\bstem_conv_\w+_kernel\b",
}
# training steps traced after the timed ones, their launches counted
TRACED_STEPS = 2
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "bn_bwd_reduce",
           "stem_matmul", "dropout")
EPS32 = 2.0 ** -24
# B1 at ResNet-50 v1's batch-128 BatchNorm shapes, (N, C, H*W) as the
# backward hands them to the kernel, with launches per training step;
# the last an odd case (C = 3, M = 2331 a multiple of no tile)
BN_CASES = [((128, 64, 12544), 1), ((128, 64, 3136), 6),
            ((128, 256, 3136), 4), ((128, 128, 784), 8),
            ((128, 512, 784), 5), ((128, 256, 196), 12),
            ((128, 1024, 196), 7), ((128, 512, 49), 6), ((128, 2048, 49), 4),
            ((7, 3, 333), 0)]
# B1's channel-minor form: ResNet-50 v1's nine BatchNorm shapes in NHWC,
# (N, H, W, C), the kernel reading (N * H * W, C, 1); the N1 = 49 shapes
# of the last stages of DenseNet-121 and MobileNetV2 at batch 64, which
# stay on the (N0, C, N1) form; an odd case (W = C * N1 = 111, no float4,
# three columns a channel)
BN_NHWC_CASES = [((128, 112, 112, 64), 1), ((128, 56, 56, 64), 6),
                 ((128, 56, 56, 256), 4), ((128, 28, 28, 128), 8),
                 ((128, 28, 28, 512), 5), ((128, 14, 14, 256), 12),
                 ((128, 14, 14, 1024), 7), ((128, 7, 7, 512), 6),
                 ((128, 7, 7, 2048), 4)]
BN_ZOO_N1_CASES = [("densenet121", (64, 1024, 49)),
                   ("densenet121", (64, 128, 49)),
                   ("mobilenetv2_1.0", (64, 960, 49)),
                   ("mobilenetv2_1.0", (64, 1280, 49))]
BN_ODD_ROWS = (4099, 37, 3)
# where the two forms cross: C = 256, about 100M elements, these N1
BN_ROUTE_N1 = (1, 2, 4, 8, 16, 32, 49)
# B2: ResNet-50's packed stem at batch 128 (B, 4 * C_in, H/2, W/2) with
# C_out 64, and an odd case (H2 = 15 and W2 = 17 off every tile, W2 not a
# multiple of 8, M = 765; C_out = 40, a partial channel tile)
STEM_CASES = [("float32", (128, 12, 112, 112), 64),
              ("bfloat16", (128, 12, 112, 112), 64),
              ("bfloat16", (3, 12, 15, 17), 40)]
# the flash-vs-dense crossover: (8, 12, T, 64) bf16 at these T
CROSSOVER_T = (128, 256, 512, 1024, 2048)
# ... and as the policy sees BERT: (B, heads, D) with a key-padding mask,
# CROSSOVER_VALID of the keys valid, attention dropout in training
CROSSOVER_MASKED = ((8, 12, 64), (8, 4, 256))
CROSSOVER_VALID, CROSSOVER_DROPOUT = 0.75, 0.1
# the operations phase: steps, checkpoint interval, faults' arrivals
OPS_STEPS, OPS_SAVE_EVERY, OPS_NAN_AT, OPS_PREEMPT_AT = 30, 10, 7, 23
OPS_SEED, OPS_TIMING_WINDOWS, OPS_WINDOW_STEPS = 5, 6, 10
OPS_HOOK_CALLS = 500
# BERT with head_dim 96 (units 768, 8 heads) and BERT-base in f16, with
# use_flash=True: one forward and one training step each, cut to 2 layers
ODD_BERTS = [("d96_bf16", dict(num_heads=8), "bfloat16"),
             ("d256_bf16", dict(units=1024, hidden_size=4096, num_heads=4),
              "bfloat16"),
             ("base_f16", {}, "float16")]
# ResNet-50 v1 training as `bench.py` builds it
RESNET_BATCH, RESNET_IMAGE = 128, 224
RESNET_WARMUP, RESNET_STEPS = 3, 20
S2D_WARMUP, S2D_STEPS = 2, 15
BN_LAYERS = 53
# ResNet-50 trained from a RecordIO file as `bench.py`'s recordio rider
# does: its file (2048 JPEG 256 x 256 low-frequency textures), its
# normalisation, a prefetch depth of 3; 3 warm-up steps, 20 re-stepping
# one resident batch (chip-only), two windows of 20 through the
# prefetcher (end to end)
REC_IMAGES, REC_SIDE = 2048, 256
REC_MEAN, REC_STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
REC_DEPTH, REC_WARMUP, REC_CHIP_STEPS = 3, 3, 20
REC_WINDOW, REC_WINDOWS = 20, 2
# batches timed through the decode pool, and through one decode thread
REC_POOL_BATCHES, REC_SINGLE_BATCHES = 8, 2
# ResNet-50 with the softmax_rtc head, trained in the eager loop; the
# checkpoint is taken after the warm-up and timed steps.  As phase 7's,
# its loss spikes at lr 0.1 until about step 10, so the last five of 13
# steps sit at or above the first: 20 timed steps, as phase 7 takes
CUSTOM_WARMUP, CUSTOM_STEPS = 3, 20
# B6's softmax at the head's (batch, classes), at BERT-base's MLM
# logits (32 sequences x 20 masked positions, vocab 30522), and odd
SOFTMAX_SHAPES = [(128, 1000), (640, 30522), (37, 1001)]
# the head's gradient against autograd through SoftmaxCrossEntropyLoss:
# both are softmax - onehot in f32, rounded at other points
HEAD_GRAD_TOL = 1e-6


# ---------------------------------------------------------------------------
# user kernels, launched through mxnet_tpu_torch.rtc (B6)
# ---------------------------------------------------------------------------
# User code, not package code: the upstream MXNet example
# `example/numpy-ops/custom_softmax_rtc.py` writes its softmax loss head
# this way.  ``req`` is upstream's request code: 0 null, 1 write, 2 add.
SOFTMAX_THREADS = 256
USER_KERNELS_SRC = r"""
#include <cuda_bf16.h>

#define THREADS 256

// y = a * x + y, each product and sum rounded on its own (no fused
// multiply-add), so the plain torch version matches bitwise
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __fadd_rn(__fmul_rn(a, x[i]), y[i]);
}

// row softmax over the last axis: one block of THREADS per row, the
// row's max and sum of exponentials each reduced by a shared-memory tree
extern "C" __global__ void softmax_fwd(const float *x, float *y, int n_cols,
                                       int req) {
  __shared__ float red[THREADS];
  const float *row = x + (size_t)blockIdx.x * n_cols;
  float *out = y + (size_t)blockIdx.x * n_cols;
  const int t = threadIdx.x;
  float m = __int_as_float(0xff800000);            // -inf
  for (int j = t; j < n_cols; j += THREADS) m = fmaxf(m, row[j]);
  red[t] = m;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = fmaxf(red[t], red[t + s]);
    __syncthreads();
  }
  m = red[0];
  __syncthreads();
  float sum = 0.f;
  for (int j = t; j < n_cols; j += THREADS) sum += expf(row[j] - m);
  red[t] = sum;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  sum = red[0];
  for (int j = t; j < n_cols; j += THREADS) {
    float v = expf(row[j] - m) / sum;
    if (req == 1) out[j] = v;
    else if (req == 2) out[j] += v;
  }
}

// SoftmaxOutput's gradient dx = y - onehot(label); a grid of
// (column blocks, rows)
extern "C" __global__ void softmax_bwd(const int *label, const float *y,
                                       float *dx, int n_cols, int req) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_cols) return;
  const size_t i = (size_t)blockIdx.y * n_cols + j;
  float g = y[i] - (j == label[blockIdx.y] ? 1.f : 0.f);
  if (req == 1) dx[i] = g;
  else if (req == 2) dx[i] += g;
}

// y = x * a in bf16 with a bf16 scalar argument, the product in f32
// rounded once
extern "C" __global__ void scale_bf16(const __nv_bfloat16 *x,
                                      __nv_bfloat16 *y, __nv_bfloat16 a,
                                      int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    y[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * __bfloat162float(a));
}

// a C++ template, found through its exported name "scale<float>"
template <typename T>
__global__ void scale(const T *x, T *y, T a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * a;
}

// reverses each row through dynamic shared memory (one row per block;
// rows longer than 12288 floats need more than the default 48 KB)
extern "C" __global__ void row_reverse(const float *x, float *y,
                                       int n_cols) {
  extern __shared__ float buf[];
  const float *row = x + (size_t)blockIdx.x * n_cols;
  float *out = y + (size_t)blockIdx.x * n_cols;
  for (int j = threadIdx.x; j < n_cols; j += blockDim.x) buf[j] = row[j];
  __syncthreads();
  for (int j = threadIdx.x; j < n_cols; j += blockDim.x)
    out[j] = buf[n_cols - 1 - j];
}
"""
USER_KERNELS = {
    "axpy": "const float *x, float *y, float a, int n",
    "softmax_fwd": "const float *x, float *y, int n_cols, int req",
    "softmax_bwd": "const int *label, const float *y, float *dx, "
                   "int n_cols, int req",
    "scale<float>": "const float *x, float *y, float a, int n",
    "scale_bf16": "const __nv_bfloat16 *x, __nv_bfloat16 *y, "
                  "__nv_bfloat16 a, int n",
    "row_reverse": "const float *x, float *y, int n_cols",
}
# the bf16 scalar of scale_bf16's check and host time (not a bf16 value:
# the launch rounds it)
SCALE_BF16 = 0.3
REQ_CODES = {"null": 0, "write": 1, "add": 2}


def axpy_plain(x, y, a):
    """``a * x + y`` in torch, each step rounded (as the kernel)."""
    return a * x + y


def softmax_plain(x):
    """Row softmax over the last axis, spelled in torch ops."""
    e = (x - x.amax(dim=-1, keepdim=True)).exp()
    return e / e.sum(dim=-1, keepdim=True)


def softmax_bwd_plain(label, y):
    """``y - onehot(label)``: the gradient of cross entropy through a
    softmax, in y's dtype."""
    import torch
    onehot = torch.zeros_like(y)
    onehot.scatter_(1, label.long()[:, None], 1.0)
    return y - onehot


@functools.cache
def user_kernels():
    """The user kernels, compiled by NVRTC once per process
    (``compile_ms`` is the compile's host time)."""
    from mxnet_tpu_torch import rtc
    t0 = time.perf_counter()
    mod = rtc.CudaModule(USER_KERNELS_SRC, exports=["scale<float>"])
    out = {"compile_ms": (time.perf_counter() - t0) * 1e3}
    out.update({name: mod.get_kernel(name, sig)
                for name, sig in USER_KERNELS.items()})
    return out


def register_softmax_rtc():
    """Register the ``softmax_rtc`` CustomOp (arguments ``data``,
    ``label``; ``need_top_grad=False``, as upstream's
    `custom_softmax_rtc.py`): its forward and backward launch
    ``softmax_fwd`` and ``softmax_bwd`` on a CUDA tensor and the plain
    versions on a CPU tensor.  Returns the prop class."""
    from mxnet_tpu_torch import operator

    class SoftmaxRTC(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x, y = in_data[0], out_data[0]
            if not x.is_cuda:
                self.assign(y, req[0], softmax_plain(x))
                return
            user_kernels()["softmax_fwd"].launch(
                (x, y, x.shape[1], REQ_CODES[req[0]]), x.device,
                (x.shape[0],), (SOFTMAX_THREADS,))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label, y, dx = in_data[1], out_data[0], in_grad[0]
            if not y.is_cuda:
                self.assign(dx, req[0], softmax_bwd_plain(label, y))
                return
            rows, cols = y.shape
            user_kernels()["softmax_bwd"].launch(
                (label, y, dx, cols, REQ_CODES[req[0]]), y.device,
                (-(-cols // SOFTMAX_THREADS), rows), (SOFTMAX_THREADS,))

    @operator.register("softmax_rtc")
    class SoftmaxRTCProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def infer_type(self, in_type):
            return in_type, [in_type[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SoftmaxRTC()

    return SoftmaxRTCProp


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn()`` on the card, by CUDA events over ``iters``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def _ptxas_by_kernel(ptxas):
    """{mangled kernel name: (registers, spill store bytes)} from the
    compiler's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, 0]
        elif name and "bytes spill stores" in line:
            out[name][1] = int(re.search(r"(\d+) bytes spill stores",
                                         line).group(1))
        elif name and "Used " in line:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
    return out


@functools.cache
def _sass(lib_path):
    """The library's SASS from ``cuobjdump -sass`` beside nvcc; None
    where that tool is missing."""
    from pathlib import Path

    from mxnet_tpu_torch.ops import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def _mma_counts(lib_path):
    """{mangled kernel name: (HMMA, HGMMA) instruction counts} in the
    library's SASS; None where ``cuobjdump`` is missing."""
    sass = _sass(lib_path)
    if sass is None:
        return None
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0]
        elif name and "HGMMA" in line:
            out[name][1] += 1
        elif name and "HMMA" in line:
            out[name][0] += 1
    return out


# SASS opcodes of integer work: those the INT32 (ALU) pipe runs, and the
# integer multiply-adds, which run on the FMA pipe
INT_ALU_OPS = frozenset((
    "IADD3", "IADD", "IADD32I", "ISETP", "IMNMX", "IABS", "SHF", "SHL", "SHR",
    "LOP3", "LOP", "LOP32I", "LEA", "SEL", "PRMT", "BMSK", "BREV", "FLO",
    "POPC", "VIADD", "VIMNMX", "ISCADD", "BFE", "BFI", "ICMP"))
INT_FMA_OPS = frozenset(("IMAD", "IMUL", "IMAD32I", "IMUL32I"))
# Hopper: 64 INT32 instructions a clock an SM (16 lanes in each of its four
# partitions)
INT32_PER_CLOCK_SM = 64


def sass_main_loop(lib_path, kernel):
    """The integer work of the main loop of the first function of the
    library whose mangled name matches the regex ``kernel``: the loop is
    the longest span from a backward branch's target to the branch, of
    those with a 16-byte global store where any has one.
    Returns the function, the span's instructions, its INT32-pipe
    integer instructions (`INT_ALU_OPS`), its integer multiply-adds, its
    16-byte global stores (one a loop iteration before unrolling, so the
    caller can count per element whatever the compiler unrolled) and its
    ten most frequent opcodes; None where ``cuobjdump`` is missing or no
    function matches."""
    sass = _sass(lib_path)
    if sass is None:
        return None
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            instr = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            funcs[name].append((int(m.group(1), 16), instr))
    name = next((f for f in funcs if re.search(kernel, f)), None)
    if name is None:
        return None
    code = funcs[name]
    loops = []
    for addr, instr in code:
        if instr.split()[0].startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", instr)
            if target and int(target.group(1), 16) <= addr:
                loops.append((int(target.group(1), 16), addr))
    if not loops:
        return None

    def opcodes(span):
        return [instr.split()[0] for addr, instr in code
                if span[0] <= addr <= span[1]]

    def vector_store(span):
        return any(op.startswith("STG") and ".128" in op
                   for op in opcodes(span))
    full = opcodes(max(loops, key=lambda span: (vector_store(span),
                                                span[1] - span[0])))
    ops = [op.split(".")[0] for op in full]
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return {"function": name, "instructions": len(ops),
            "int_alu": sum(counts.get(o, 0) for o in INT_ALU_OPS),
            "int_fma": sum(counts.get(o, 0) for o in INT_FMA_OPS),
            "vector_stores": sum(op.startswith("STG") and ".128" in op
                                 for op in full),
            "global_stores": sum(op.startswith("STG") for op in full),
            "top": dict(sorted(counts.items(), key=lambda kv: -kv[1])[:10])}


@functools.cache
def int32_rate():
    """The card's INT32 instruction rate: `INT32_PER_CLOCK_SM` times its
    SM count times its maximum SM clock (``nvidia-smi``)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return {"sms": sms, "max_sm_mhz": mhz,
            "ops_per_s": INT32_PER_CLOCK_SM * sms * mhz * 1e6}


# tensor-core kernels by mangled name: (kernel id, type, head dim)
_TC_KERNELS = (
    (r"flash_fwd_tc_kernelI\w*?(Bf16|F16)ELi(\d+)E", "B3"),
    (r"flash_fwd_wide_tc_kernelI\w*?(Bf16|F16)E()", "B3 D>128"),
    (r"flash_bwd_dq_tc_kernelI\w*?(Bf16|F16)ELi(\d+)E", "B4"),
    (r"flash_bwd_dkv_tc_kernelI\w*?(Bf16|F16)ELi(\d+)E", "B5"),
    (r"flash_bwd_dq_wide_tc_kernelI\w*?(Bf16|F16)E()", "B4 D>128"),
    (r"flash_bwd_dkv_wide_tc_kernelI\w*?(Bf16|F16)E()", "B5 D>128"),
    (r"stem_conv_tc_kernelI\w*?(Bf16|F16)E()", "B2"),
)


def _tc_kernels(path, ptxas):
    """Registers, spill bytes and tensor-core instruction counts of the
    16-bit tensor-core kernels of one library: B3, B4 and B5 at each head
    dim they are built for and past 128, B2."""
    regs = _ptxas_by_kernel(ptxas)
    mma = _mma_counts(path)
    rows = []
    for name, (n_regs, spill) in sorted(regs.items()):
        for pattern, kid in _TC_KERNELS:
            m = re.search(pattern, name)
            if not m:
                continue
            hmma, hgmma = (mma.get(name, (0, 0)) if mma is not None
                           else ("not measured", "not measured"))
            rows.append({"kernel": kid,
                         "type": "bf16" if m.group(1) == "Bf16" else "f16",
                         "head_dim": int(m.group(2)) if m.group(2) else None,
                         "registers": n_regs, "spill_store_bytes": spill,
                         "hmma": hmma, "hgmma": hgmma})
    return rows


def phase_build():
    """Build every kernel source, one nvcc for each, all started
    together; report the tensor-core kernels' registers, spills and
    tensor-core instructions, and fail if B3, B4 or B5 (at D = 64 and past
    D = 128) or B2 spills or runs no HMMA."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    seconds = time.perf_counter() - t0
    tc = []
    for name, path in zip(SOURCES, paths):
        ptxas = _build.BUILD_LOG.get(name, {}).get("ptxas", "")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in ptxas.splitlines() if "Used " in line})
        spill = max((int(n) for n in re.findall(
            r"(\d+) bytes spill stores", ptxas)), default=0)
        log(f"build: {path.name} (nvcc {' '.join(_build.NVCC_FLAGS)}); "
            f"ptxas: {'; '.join(regs)}; most spill stores: {spill} bytes")
        tc += _tc_kernels(path, ptxas)
        for kname, (n_regs, n_spill) in sorted(
                _ptxas_by_kernel(ptxas).items()):
            m = re.search(r"\d(flash_(?:fwd|bwd_dq|bwd_dkv)_wide_kernel|"
                          r"dropout_(?:fwd|bwd)_kernel)I\d*(\w+?)E", kname)
            if m:
                log(f"build: {m.group(1)} <{m.group(2)}>: {n_regs} "
                    f"registers, {n_spill} bytes spill stores")
    for r in tc:
        at = "" if r["head_dim"] is None else f" D={r['head_dim']}"
        log(f"build: {r['kernel']} {r['type']}{at}: "
            f"{r['registers']} registers, {r['spill_store_bytes']} bytes "
            f"spill stores, HMMA {r['hmma']}, HGMMA {r['hgmma']}")
    log(f"build: {len(SOURCES)} sources in {seconds:.1f} s")
    gated = [r for r in tc if r["head_dim"] in (D, None)]
    if sorted((r["kernel"], r["type"]) for r in gated) != sorted(
            [(k, t) for k in ("B3", "B4", "B5", "B3 D>128", "B4 D>128",
                              "B5 D>128")
             for t in ("bf16", "f16")] + [("B2", "bf16")]) or any(
            r["spill_store_bytes"] or r["hmma"] == 0 for r in gated):
        raise SystemExit(f"tensor-core kernels (B3, B4, B5 at D={D} and "
                         f"past 128, B2): expected no spills and HMMA "
                         f"instructions, got {gated}")
    return tc


# ---------------------------------------------------------------------------
# phase 1b: the tensor cores' sums against sequential FMAs
# ---------------------------------------------------------------------------
# The bf16 backward kernels (B4, B5) derive again, with sequential f32 FMAs,
# every element whose bf16 rounding a bounded difference between their
# tensor-core sums and sequential FMAs could flip.  The bound takes that
# difference to be at most MMA_ERR_BOUND * 2^-24 |a| |b| for rows a, b
# (`SUM_ERR` in flash_attention_bwd.cu; past D = 128 that bound times
# sqrt(D / 128), `wide_sum_err`).  This kernel measures it: a . b
# for each pair of 16-row and 8-row blocks, chained over k in steps of 16 as
# B4 and B5 chain their mma.sync, against the sequential sum;
# err = |difference| / (2^-24 |a| |b|).  Compiled by NVRTC (rtc).
MMA_ERR_BOUND = 6
MMA_ERR_SRC = r"""
#include <cuda_bf16.h>

__device__ unsigned pair(const __nv_bfloat16* x) {
    return *reinterpret_cast<const unsigned*>(x);
}

extern "C" __global__ void mma_vs_fma(const __nv_bfloat16* a,
                                      const __nv_bfloat16* b, float* err,
                                      int rows, int d) {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const long slab = (long)blockIdx.z * rows * d;
    const int r0 = 16 * blockIdx.x, c0 = 8 * blockIdx.y;
    const __nv_bfloat16* A = a + slab + (long)r0 * d;
    const __nv_bfloat16* B = b + slab + (long)c0 * d;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d; k0 += 16) {
        const unsigned a0 = pair(A + g * d + k0 + 2 * t);
        const unsigned a1 = pair(A + (g + 8) * d + k0 + 2 * t);
        const unsigned a2 = pair(A + g * d + k0 + 8 + 2 * t);
        const unsigned a3 = pair(A + (g + 8) * d + k0 + 8 + 2 * t);
        const unsigned b0 = pair(B + g * d + k0 + 2 * t);
        const unsigned b1 = pair(B + g * d + k0 + 8 + 2 * t);
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 2 * t + (e & 1);
        float seq = 0.f, na = 0.f, nb = 0.f;
        for (int k = 0; k < d; ++k) {
            const float x = __bfloat162float(A[r * d + k]);
            const float y = __bfloat162float(B[col * d + k]);
            seq = __fmaf_rn(x, y, seq);
            na += x * x;
            nb += y * y;
        }
        err[((long)blockIdx.z * rows + r0 + r) * rows + c0 + col] =
            fabsf(c[e] - seq) / (sqrtf(na * nb) * 5.9604645e-8f);
    }
}
"""


def phase_mma_error(dev):
    """The tensor cores' dot products against sequential FMAs on random
    normal bf16 rows (as the kernels' inputs are drawn) at each head dim:
    the largest and the 99.99th-percentile error in units of 2^-24 |a|
    |b|, against the bound the kernels assume.  Fails if the bound is
    exceeded."""
    import torch
    from mxnet_tpu_torch import rtc
    kernel = rtc.CudaModule(MMA_ERR_SRC).get_kernel(
        "mma_vs_fma", "const __nv_bfloat16 *a, const __nv_bfloat16 *b, "
        "float *err, int rows, int d")
    gen = torch.Generator().manual_seed(99)
    rows, out = 128, {}
    for d, slabs in ((16, 96), (32, 96), (64, B_TRAIN * H), (128, 96),
                     *((d, 96) for d in WIDE_DIMS)):
        # rows zero-padded to a multiple of 16, as the chunked kernels'
        # tiles are: the zeros add nothing to either sum
        a, b = (torch.nn.functional.pad(
            torch.randn(slabs, rows, d, generator=gen), (0, -d % 16)).to(
                dev, torch.bfloat16) for _ in range(2))
        err = torch.empty(slabs, rows, rows, device=dev)
        kernel.launch((a, b, err, rows, a.shape[-1]), dev,
                      (rows // 16, rows // 8, slabs), (32,))
        torch.cuda.synchronize()
        flat = err.flatten()
        bound = MMA_ERR_BOUND * max(1.0, d / 128) ** 0.5
        out[d] = {"max": flat.max().item(),
                  "p9999": flat.kthvalue(int(flat.numel() * 0.9999)
                                         ).values.item(),
                  "bound": bound, "pairs": flat.numel()}
        log(f"mma_error: D={d}: tensor cores vs sequential FMAs, max "
            f"{out[d]['max']:.3f}, 99.99% {out[d]['p9999']:.3f} x 2^-24 "
            f"|a| |b| over {out[d]['pairs']} pairs (bound {bound:.3f})")
    if any(r["max"] > r["bound"] for r in out.values()):
        raise SystemExit(f"tensor-core sums exceed the bound B4/B5 assume: "
                         f"{out}")
    return out


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------
def _attention_inputs(dtype, case, shape, gen, dev):
    import torch
    b, h, t, d = shape
    q, k, v = (torch.randn(b, h, t, d, generator=gen).to(dev, dtype)
               for _ in range(3))
    kw = {}
    if case == "ragged_mask":
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0] = 0                      # one fully masked batch row
        lens[1] = t
        kw["mask"] = (torch.arange(t)[None, :] < lens[:, None]).to(
            dev, torch.int32)
    elif case == "causal":
        kw["causal"] = True
    elif case == "bias":
        kw["bias"] = torch.randn(h, t, t, generator=gen).to(dev)
    elif case == "dropout":
        kw["dropout"] = 0.1
        kw["key"] = (0x1234ABCD, 0x9876)
    elif case == "train_mask_dropout":
        # the training phase's batch: ragged lengths in [T/2, T] and
        # attention dropout 0.1
        kw["mask"] = torch.from_numpy(train_mask(b, t)).to(dev)
        kw["dropout"] = 0.1
        kw["key"] = (0x1234ABCD, 0x9876)
    elif case == "all":
        # a fully masked batch row and a ragged one, causal, a
        # (B, H, T, T) bias and dropout at once
        mask = torch.ones(b, t, dtype=torch.int32)
        mask[0] = 0
        mask[1, t * 3 // 4:] = 0
        kw = {"mask": mask.to(dev), "causal": True, "dropout": 0.1,
              "key": (77, 78),
              "bias": torch.randn(b, h, t, t, generator=gen).to(dev)}
    return q, k, v, kw


def _row0_masked(kw):
    """Whether batch row 0 has no valid key (its out and dq must be
    exact zeros)."""
    return "mask" in kw and not bool(kw["mask"][0].any())


def _live_pairs(kw, shape):
    """(query, key) pairs the mask and causal order leave."""
    import torch
    b, h, t, _ = shape
    keys = (kw["mask"].bool().cpu() if "mask" in kw
            else torch.ones(b, t, dtype=torch.bool))
    allowed = keys[:, None, :].expand(b, t, t)
    if kw.get("causal"):
        allowed = allowed & torch.ones(t, t, dtype=torch.bool).tril()
    return int(allowed.sum()) * h


def _key_bytes(kw, shape, nbytes_elem):
    """k and v bytes the function needs (only valid keys' rows under a
    mask), plus the mask and bias it reads."""
    b, h, t, d = shape
    rows = int(kw["mask"].sum().item()) if "mask" in kw else b * t
    io = 2 * rows * h * d * nbytes_elem
    if "mask" in kw:
        io += b * t * 4
    if "bias" in kw:
        io += kw["bias"].numel() * 4
    return io


def _bound(dtype, kw, shape, nbytes_elem):
    """Least time (ms) for the work these inputs need: every input the
    function needs read once and every output written once over the
    memory rate, and the products (4 * D flops per (query, attended key)
    pair) over the peak rate for the type.  With a key-padding mask only
    the valid keys' k and v rows are needed, and only they are
    attended."""
    b, h, t, d = shape
    qo = 2 * b * h * t * d * nbytes_elem + b * h * t * 4   # q, out, lse
    io = qo + _key_bytes(kw, shape, nbytes_elem)
    flops = 4 * d * _live_pairs(kw, shape)
    return _bound_ms(dtype, io, flops)


def _bound_ms(dtype, io, flops, int_ops=0):
    """Least time (ms) for ``io`` bytes, ``flops`` operations of
    ``dtype`` and ``int_ops`` INT32 instructions, each at the card's
    rate, and which of "bytes", "operations" and "integer ops" binds."""
    times = {"bytes": io / HBM_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_FLOPS[dtype] * 1e3}
    if int_ops:
        times["integer ops"] = int_ops / int32_rate()["ops_per_s"] * 1e3
    by = max(times, key=times.get)
    return times[by], by


def _contract_bound(by):
    """``bound_by`` in the result line's terms: integer instructions are
    operations there (``bound_kind`` says which)."""
    return "operations" if by == "integer ops" else by


def _sdpa_call(q, k, v, kw):
    """One PyTorch call computing the same function, for timing only:
    SDPA with the key-padding mask, causal order and bias folded into its
    one ``attn_mask`` (its dropout draws other bits)."""
    import torch
    import torch.nn.functional as F
    t = q.shape[2]
    attn, causal = None, kw.get("causal", False)
    if "mask" in kw:
        attn = kw["mask"].bool()[:, None, None, :]
    if causal and (attn is not None or "bias" in kw):
        tril = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        attn = tril if attn is None else attn & tril
        causal = False
    if "bias" in kw:
        bias = kw["bias"].to(q.dtype)
        attn = bias if attn is None else bias.masked_fill(~attn,
                                                          float("-inf"))
    drop = kw.get("dropout", 0.0)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn, is_causal=causal, dropout_p=drop)


def _out_err(q, k, v, kw, out, ref_out, dname):
    """Max |kernel - plain| of B3's out, and the worst error over its
    allowance (<= 1 passes)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    atol, rtol, ptol = TOL[dname]["out"]
    allow = atol + rtol * ref_out.float().abs()
    if ptol:
        allow = allow + ptol * fa.flash_attention_reference(
            q, k, v.abs(), **kw)[0].float()
    diff = (out.float() - ref_out.float()).abs()
    return diff.max().item(), (diff / allow).max().item()


def _where_taken(fn, missing=None):
    """``fn()``, or ``missing`` where the library call refuses the case
    (SDPA's kernels do not take every head dim)."""
    import torch
    try:
        return fn()
    except (RuntimeError, torch.OutOfMemoryError) as exc:
        log(f"library call refused the case: {str(exc)[:120]}")
        return missing


def _fmt(x):
    return "n/a" if x is None else f"{x:.4f}"


def _case_name(r):
    return f"{r['dtype']}/{r['case']}/{r['shape']}"


def _odd_wide_cases():
    """(type, [the unaligned wide case]) for each type, run last."""
    import torch
    return tuple((dt, [_ODD_WIDE_CASE]) for dt in (
        torch.bfloat16, torch.float32, torch.float16))


def phase_kernel_vs_plain(dev):
    """B3 against `flash_attention_reference` on every forward case in
    each type (phase 2 of the module's docstring)."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(1234)
    rows = []
    for dtype, cases in ((torch.bfloat16, CASES), (torch.float32, CASES),
                         (torch.float16, F16_CASES), *_odd_wide_cases()):
        dname = str(dtype).split(".")[1]
        for case, *shape in cases:
            q, k, v, kw = _attention_inputs(dtype, case, shape, gen, dev)
            out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            err_out, err_ratio = _out_err(q, k, v, kw, out, ref_out, dname)
            live = ref_lse > fa._MASKED_ROW
            err_lse = (lse - ref_lse)[live].abs().max().item()
            ok = (err_ratio <= 1.0 and err_lse <= TOL[dname]["lse"] and
                  bool(torch.isfinite(out).all()))
            if _row0_masked(kw):
                ok = ok and bool((out[0] == 0).all()) and \
                    bool((lse[0] < fa._MASKED_ROW).all())
            call = functools.partial(fa.flash_attention_with_lse, q, k, v,
                                     **kw)
            repeat_ok = kernel_dev_ms = None
            if shape[3] > 128:
                # the chunked kernels use no atomics: a second launch is
                # bitwise equal to the first
                out2, lse2 = call()
                torch.cuda.synchronize()
                repeat_ok = bool(torch.equal(out, out2) and
                                 torch.equal(lse, lse2))
                ok = ok and repeat_ok
                del out2, lse2
            ms = dev_ms = plain_ms = library_ms = library_dev_ms = None
            if (case, *shape) in DEVICE_TIMED + WIDE_TIMED or (
                    dname == "bfloat16" and tuple(shape) in BWD_TIMED_BF16):
                ms = cuda_ms(call)
                plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, **kw), iters=5)
                library_ms = _where_taken(lambda: cuda_ms(
                    _sdpa_call(q, k, v, kw)))
            if (case, *shape) in DEVICE_TIMED:
                dev_ms = device_ms(call)
                library_dev_ms = device_ms(_sdpa_call(q, k, v, kw))
            if (case, *shape) in WIDE_TIMED:
                dev_ms = device_ms(call)
                # B3 alone, without the wrapper's mask and kend kernels
                kernel_dev_ms = device_ms(
                    call, match=KERNEL_NAMES["flash_attention_fwd"])
                library_dev_ms = _where_taken(lambda: device_ms(
                    _sdpa_call(q, k, v, kw)))
            bound_ms, bound_by = _bound(dname, kw, shape, q.element_size())
            row = {"dtype": dname, "case": case, "shape": shape,
                   "max_abs_err": err_out, "err_over_tol": err_ratio,
                   "lse_max_abs_err": err_lse,
                   "tol": TOL[dname], "ms": ms, "device_ms": dev_ms,
                   "kernel_device_ms": kernel_dev_ms,
                   "repeat_bitwise": repeat_ok, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "library_device_ms": library_dev_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "ok": ok}
            rows.append(row)
            timing = "not timed " if ms is None else (
                f"kernel_ms={ms:.4f}" +
                ("" if dev_ms is None else f" (device {dev_ms:.4f}" + (
                    "" if kernel_dev_ms is None
                    else f", B3 alone {kernel_dev_ms:.4f}") + ")") +
                f" plain_ms={plain_ms:.4f} library_ms={_fmt(library_ms)}" +
                ("" if library_dev_ms is None
                 else f" (device {library_dev_ms:.4f})") + " ")
            log(f"kernel {dname:8s} {case:18s} {tuple(shape)} "
                f"out_err={err_out:.3e} ({err_ratio:.2f} of tol) "
                f"lse_err={err_lse:.3e} " +
                ("" if repeat_ok is None else
                 f"repeat {'bitwise' if repeat_ok else 'DIFFERS'} ") + timing +
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"{'ok' if ok else 'FAILED'}")
            del q, k, v, kw, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    failed = [_case_name(r) for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return rows


def wide_forward_times(dev, dims=WIDE_DIMS, windows=3):
    """B3 past head dim 128 alone, for comparing two trees in one call
    (``python3 chip_smoke.py --wide-forward [D ...]`` from the root of
    each, in turns): at (4, 8, 512, D) with a key-padding mask in bf16
    and f16, ``windows`` turns of the wrapper's call by CUDA events and by
    device time, B3's kernel alone by device time, and SDPA's device
    time; one ``wide_forward:`` line a case, beside the bound.  Each
    case draws its inputs from its own seed, so that a case sees the same
    inputs whatever the other head dims asked for."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa
    for dtype in (torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[1]
        for d in dims:
            shape = [4, 8, 512, d]
            gen = torch.Generator().manual_seed(1234 + d)
            q, k, v, kw = _attention_inputs(dtype, "ragged_mask", shape, gen,
                                            dev)
            call = functools.partial(fa.flash_attention_with_lse, q, k, v,
                                     **kw)
            sdpa = _sdpa_call(q, k, v, kw)
            r = {"dtype": dname, "shape": shape, "ms": [], "device_ms": [],
                 "kernel_device_ms": [], "library_device_ms": []}
            for _ in range(windows):
                r["ms"].append(cuda_ms(call))
                r["device_ms"].append(device_ms(call))
                r["kernel_device_ms"].append(device_ms(
                    call, match=KERNEL_NAMES["flash_attention_fwd"]))
                r["library_device_ms"].append(device_ms(sdpa))
            r["bound_ms"], r["bound_by"] = _bound(dname, kw, shape,
                                                  q.element_size())
            log("wide_forward: " + json.dumps(r))


# ---------------------------------------------------------------------------
# phase 2b: backward kernels vs plain
# ---------------------------------------------------------------------------
def train_mask(b, t):
    """The training batch's key-padding mask: valid prefixes of lengths
    ``RandomState(11).randint(t // 2, t + 1)``, as the repo's BERT
    pretraining benchmark draws them."""
    import numpy as onp
    lens = onp.random.RandomState(11).randint(t // 2, t + 1, size=b)
    return (onp.arange(t)[None, :] < lens[:, None]).astype(onp.int32)


def _bwd_bounds(dtype, kw, shape, nbytes_elem):
    """Least time (ms) of B4 and of B5 for these inputs, each as (bound,
    what bounds it, (bytes ms, operations ms)).  Bytes: q, dO (and the
    k, v rows the mask leaves), lse and delta read once; dq, or dk and
    dv, written once.  Flops: 2 * D per live (query, key) pair for each
    product, 3 products in B4 (s, dp, dq) and 4 in B5 (s, dp, dv, dk)."""
    b, h, t, d = shape
    act = b * h * t * d * nbytes_elem          # one (B, H, T, D) tensor
    rows = b * h * t * 4                       # one (B, H, T) f32 tensor
    reads = 2 * act + 2 * rows + _key_bytes(kw, shape, nbytes_elem)
    pairs = _live_pairs(kw, shape)
    out = []
    for io, flops in ((reads + act, 3 * 2 * d * pairs),
                      (reads + 2 * act, 4 * 2 * d * pairs)):
        out.append((*_bound_ms(dtype, io, flops),
                    (io / HBM_BYTES_PER_S * 1e3,
                     flops / PEAK_FLOPS[dtype] * 1e3)))
    return out


def _sdpa_backward_ms(q, k, v, dout, kw):
    """SDPA's backward alone on the same inputs (timing yardstick only):
    its forward graph is built once with grad, then ``autograd.grad``
    through it runs in two windows of 20 calls, each timed by the card's
    kernel time (`device_ms`: the autograd engine's host work per call
    outlasts these kernels, so CUDA events would time the host), so
    their spread shows; and one window by CUDA events, to show it."""
    import torch
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = _sdpa_call(qg, kg, vg, kw)()

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dout,
                                   retain_graph=True)

    return device_ms(bwd), device_ms(bwd), cuda_ms(bwd)


def _flash_backward_ms(q, k, v, dout, kw):
    """The port's whole backward as training runs it: ``autograd.grad``
    through one `flash_attention` forward, i.e. `_FlashAttention.backward`
    (B4 with delta and the keep words, then B5).  Its kernels' device
    time (`device_ms`) and its time by CUDA events."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, **kw)

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dout,
                                   retain_graph=True)

    return device_ms(bwd), cuda_ms(bwd)


def _bwd_times(q, k, v, out, lse, dout, kw, b4, delta, words, args):
    """B4 and B5 each by CUDA events and by device time, the whole
    backward through autograd, the plain backward and SDPA's backward
    (where its kernels take batch*heads)."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    def b5():
        return fa._launch_dkv(q, k, v, dout, lse, delta, words, args)

    out_ = {"dq": cuda_ms(b4), "dkv": cuda_ms(b5), "dq_dev": device_ms(b4),
            "dkv_dev": device_ms(b5)}
    out_["bwd_dev"], out_["bwd_events"] = _flash_backward_ms(q, k, v, dout,
                                                             kw)
    out_["plain"] = cuda_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, out, lse, dout, **kw), iters=5)
    b, h = q.shape[:2]
    out_["lib_a"], out_["lib_b"], out_["lib_events"] = (
        _where_taken(lambda: _sdpa_backward_ms(q, k, v, dout, kw),
                     (None, None, None)) if b * h <= 65535
        else (None, None, None))
    return out_


def _keep_words_ok(keep, kw, shape, dev):
    """B4's keep words equal the plain packed mask on every live pair
    (the kernel leaves the words of tiles it skips unwritten)."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa
    if keep is None:
        return "dropout off"
    b, h, t, _ = shape
    causal = kw.get("causal", False)
    live = fa._pack_bits(fa._live_pairs(b, t, kw.get("mask"), causal, dev)
                         .expand(b, h, t, t))
    plain = fa.keep_words_reference(kw["key"], b, h, t, kw["dropout"],
                                    mask=kw.get("mask"), causal=causal,
                                    device=dev)
    return bool(torch.equal(keep & live, plain))


def phase_bwd_vs_plain(dev):
    """B4 and B5 against `flash_attention_backward_reference` on the
    same saved forward and upstream gradient, and that forward (B3's out
    and lse) against `flash_attention_reference`; B4's delta and keep
    words against their plain versions, bit for bit; a second launch of
    both bitwise equal to the first; the share of live pairs whose bf16
    rounding each kernel derived again."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(4321)
    rows = []
    for dtype, cases in ((torch.bfloat16, BWD_CASES),
                         (torch.float32, BWD_CASES),
                         (torch.float16, F16_CASES), *_odd_wide_cases()):
        dname = str(dtype).split(".")[1]
        atol, rtol = BWD_TOL[dname]
        for case, *shape in cases:
            b, h, t, d = shape
            q, k, v, kw = _attention_inputs(dtype, case, shape, gen, dev)
            dout = torch.randn(*shape, generator=gen).to(dev, dtype)
            with torch.no_grad():
                out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
            args = fa._LaunchArgs(q, kw.get("causal", False), d ** -0.5,
                                  kw.get("mask"), kw.get("bias"),
                                  kw.get("dropout", 0.0), kw.get("key"))

            rederived = torch.zeros(2, dtype=torch.int64, device=dev)

            def b4(stats=None):
                return fa._launch_dq(q, k, v, out, dout, lse, None, args,
                                     stats)

            dq, delta, words = b4(rederived[:1])
            dk, dv = fa._launch_dkv(q, k, v, dout, lse, delta, words, args,
                                    rederived[1:])
            dq2, delta2, words2 = b4()
            dk2, dv2 = fa._launch_dkv(q, k, v, dout, lse, delta2, words2,
                                      args)
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in
                         ((dq, dq2), (dk, dk2), (dv, dv2), (delta, delta2)))
            # B4's delta is summed in torch's order, bit for bit the plain's
            delta_equal = bool(torch.equal(delta, fa._delta(out, dout, None)))
            share = [n / _live_pairs(kw, shape) for n in rederived.tolist()]
            ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
            _, fwd_ratio = _out_err(q, k, v, kw, out, ref_out, dname)
            live = ref_lse > fa._MASKED_ROW
            lse_err = (lse - ref_lse)[live].abs().max().item()
            plain = fa.flash_attention_backward_reference(
                q, k, v, out, lse, dout, **kw)
            errs, ratio = {}, 0.0
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
                diff = (got.float() - ref.float()).abs()
                errs[name] = diff.max().item()
                ratio = max(ratio, (diff / (atol + rtol * ref.float().abs())
                                    ).max().item())
            keep_ok = _keep_words_ok(words[0] if "dropout" in kw else None,
                                     kw, shape, dev)
            ok = (ratio <= 1.0 and fwd_ratio <= 1.0 and
                  lse_err <= TOL[dname]["lse"] and repeat and delta_equal
                  and keep_ok is not False and
                  all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv)))
            if "mask" in kw:
                dead = (kw["mask"] == 0)[:, None, :].expand(b, h, t)
                exact = (bool((dk[dead] == 0).all()) and
                         bool((dv[dead] == 0).all()))
                if _row0_masked(kw):             # batch row 0: no valid key
                    exact = exact and bool((dq[0] == 0).all()) and \
                        bool((out[0] == 0).all())
                ok = ok and exact
            times = dict.fromkeys(("dq", "dkv", "dq_dev", "dkv_dev",
                                   "bwd_dev", "bwd_events", "plain",
                                   "lib_a", "lib_b", "lib_events"))
            if (case, *shape) in BWD_TIMED or (
                    dname == "bfloat16" and tuple(shape) in BWD_TIMED_BF16):
                times = _bwd_times(q, k, v, out, lse, dout, kw, b4, delta,
                                   words, args)
            dq_ms, dkv_ms, dq_dev, dkv_dev, bwd_dev, bwd_events, plain_ms, \
                lib_a, lib_b, lib_events = times.values()
            (dq_bound, dq_by, dq_parts), (dkv_bound, dkv_by, dkv_parts) = \
                _bwd_bounds(dname, kw, shape, q.element_size())
            row = {"dtype": dname, "case": case, "shape": shape,
                   "max_abs_err": errs, "err_over_tol": ratio,
                   "fwd_err_over_tol": fwd_ratio, "lse_max_abs_err": lse_err,
                   "delta_equal": delta_equal, "keep_words_equal": keep_ok,
                   "bitwise_repeat": repeat,
                   "rederived_share": share,
                   "tol": [atol, rtol], "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                   "dq_device_ms": dq_dev, "dkv_device_ms": dkv_dev,
                   "backward_device_ms": bwd_dev,
                   "backward_events_ms": bwd_events,
                   "plain_ms": plain_ms,
                   "library_ms": None if lib_a is None else (lib_a + lib_b) / 2,
                   "library_ms_windows": [lib_a, lib_b],
                   "library_ms_events": lib_events,
                   "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
                   "dq_bound_parts_ms": dq_parts,
                   "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
                   "dkv_bound_parts_ms": dkv_parts,
                   "ok": ok}
            rows.append(row)
            timing = "not timed " if dq_ms is None else (
                f"dq_ms={dq_ms:.4f} (device {dq_dev:.4f}, bound "
                f"{dq_bound:.4f} {dq_by}) dkv_ms={dkv_ms:.4f} (device "
                f"{dkv_dev:.4f}, bound {dkv_bound:.4f} {dkv_by}) "
                f"backward_device_ms={bwd_dev:.4f} (events "
                f"{bwd_events:.4f}) plain_ms={plain_ms:.4f} sdpa_bwd_ms=" +
                ("n/a " if lib_a is None else
                 f"{lib_a:.4f}/{lib_b:.4f} (events {lib_events:.4f}) "))
            log(f"kernel_bwd {dname:8s} {case:18s} {tuple(shape)} "
                f"err dq={errs['dq']:.2e} dk={errs['dk']:.2e} "
                f"dv={errs['dv']:.2e} ({ratio:.2f} of tol; fwd out "
                f"{fwd_ratio:.2f} of tol, lse_err={lse_err:.2e}; delta "
                f"equal {delta_equal}; keep words {keep_ok}; bitwise repeat "
                f"{repeat}; derived again "
                f"{share[0]:.4f} / {share[1]:.4f} of live pairs) " + timing +
                f"{'ok' if ok else 'FAILED'}")
            del q, k, v, kw, dout, out, lse, dq, dk, dv, plain, delta, args
            del ref_out, ref_lse, words, dq2, dk2, dv2, delta2, words2, rederived
    torch.cuda.empty_cache()
    failed = [_case_name(r) for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"backward kernels disagree with the plain "
                         f"backward: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 2c: seed words by pointer, replayed
# ---------------------------------------------------------------------------
def phase_replay_seeds(dev):
    """B4 captured in a CUDA graph with its seed words in a device
    buffer, replayed twice with two sets of words written between: each
    replay's keep words equal the plain packed mask of its own words on
    every live pair, and the two differ (a graph replays its pointers,
    not the words it was captured with)."""
    import torch
    from mxnet_tpu_torch.ops import capture
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(99)
    shape = (B_TRAIN, H, T_TRAIN, D)
    q, k, v, kw = _attention_inputs(torch.bfloat16, "train_mask_dropout",
                                    shape, gen, dev)
    dout = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    seed = torch.zeros(2, dtype=torch.int32, device=dev)
    args = fa._LaunchArgs(q, False, D ** -0.5, kw["mask"], None, 0.1, seed)
    if args.seed is not seed:
        raise SystemExit("the wrappers copied a device seed buffer")
    with torch.no_grad():
        out, lse = fa.flash_attention_with_lse(q, k, v, mask=kw["mask"])
    fa._launch_dq(q, k, v, out, dout, lse, None, args)      # warm
    graph = capture.Graph(dev)
    words = graph.capture(
        lambda: fa._launch_dq(q, k, v, out, dout, lse, None, args)[2])
    got, ok = [], True
    live = fa._pack_bits(fa._live_pairs(B_TRAIN, T_TRAIN, kw["mask"], False,
                                        dev).expand(B_TRAIN, H, T_TRAIN,
                                                    T_TRAIN))
    for key in ((0x1234ABCD, 0x9876), (0x1234ABCE, 0x9876)):
        seed.copy_(torch.tensor(key, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        got.append(words[0].clone() & live)
        ok = ok and _keep_words_ok(words[0], dict(kw, key=key), shape,
                                   dev) is True
    differ = not torch.equal(got[0], got[1])
    out_ = {"shape": list(shape), "replays_match_their_words": ok,
            "replays_differ": differ}
    log("replay_seeds: " + json.dumps(out_))
    if not (ok and differ):
        raise SystemExit("replayed B4 did not read its seed words from the "
                         "buffer")
    return out_


# ---------------------------------------------------------------------------
# phase 2d: the dropout kernel vs plain
# ---------------------------------------------------------------------------
# (dtype, shape, p, lead): BERT-base training's dropout input (32 x 128
# tokens x 768) in bf16, f32 and f16 (the amp path's), the word LM's
# (phase 11) nn.Dropout input at its longest bucket, (30, 32, 650) f32 at
# p 0.5, an odd n, and contiguous views that start `lead` elements into
# a buffer of their own, off a 16-byte boundary (the kernels' scalar
# head; an odd n too; the last shorter than its head)
DROPOUT_CASES = [("bfloat16", (B_TRAIN, T_TRAIN, 768), 0.1, 0),
                 ("float32", (B_TRAIN, T_TRAIN, 768), 0.1, 0),
                 ("float16", (B_TRAIN, T_TRAIN, 768), 0.1, 0),
                 ("float32", (30, 32, 650), 0.5, 0),
                 ("bfloat16", (3, 1001, 7), 0.1, 0),
                 ("bfloat16", (100003,), 0.1, 1),
                 ("float32", (65537,), 0.3, 3),
                 ("float16", (77,), 0.5, 5),
                 ("bfloat16", (3,), 0.5, 1)]
DROPOUT_RATE_MIN_N = 20000
_SASS_TYPE = {"float32": "f", "bfloat16": "13__nv_bfloat16",
              "float16": "6__half"}
# the dropout kernels by mangled name in the library's SASS, and by name
# in a trace
DROPOUT_SASS = {"fwd": r"dropout_fwd_kernelI{}Lb0E",
                "bwd": r"dropout_bwd_kernelI{}E"}
DROPOUT_TRACE = {"fwd": r"\bdropout_fwd_kernel\b",
                 "bwd": KERNEL_NAMES["dropout_bwd"]}


def dropout_int_ops(part, n):
    """INT32-pipe instructions the dropout function needs over ``n``
    elements, whatever the kernel compiles to: a threefry2x32 hash is 20
    rounds of a rotate (SHF) and an xor (LOP3), its adds and key
    injections can run on the FMA pipe (IMAD); the forward hashes once a
    pair of elements; each element takes one keep decision (a compare in
    the forward, a bit test in the backward, which hashes nothing)."""
    return (40 * -(-n // 2) if part == "fwd" else 0) + n


def dropout_sass(dname):
    """Each dropout kernel's main loop in its SASS (`sass_main_loop`)
    and its INT32-pipe instructions an element (the span's 16-byte
    stores give its elements): what the kernel as compiled spends, a
    diagnostic beside `dropout_int_ops`."""
    from mxnet_tpu_torch.ops import _build
    path = _build.build("dropout")
    out = {}
    for part, pattern in DROPOUT_SASS.items():
        loop = sass_main_loop(path, pattern.format(_SASS_TYPE[dname]))
        if loop is None or not loop["vector_stores"]:
            out[part] = None
            continue
        elements = loop["vector_stores"] * (16 //
                                            torch_dtype(dname).itemsize)
        out[part] = dict(loop, elements=elements,
                         int_per_element=loop["int_alu"] / elements)
    return out


def torch_dtype(dname):
    import torch
    return getattr(torch, dname)


def _dropout_input(dname, shape, lead, gen, dev):
    import torch
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn(n + lead, generator=gen).to(dev, torch_dtype(dname))
    return buf[lead:].view(shape)


def l2_flush(dev):
    """A float32 buffer twice the card's L2 cache: reading it (`sum`)
    between two timed launches leaves none of their inputs in L2, and
    dirties no line that a launch would then write back."""
    import torch
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return torch.empty(l2 // 2, dtype=torch.float32, device=dev)


def _dropout_case(dname, shape, p, lead, gen, seed, sass, flush):
    """One case: the kernels against their plain versions, bitwise, the
    bits against the plain mask, the keep rate, and each kernel timed
    beside its bounds and its yardsticks."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as tnn
    dev = seed.device
    x = _dropout_input(dname, shape, lead, gen, dev)
    grad = _dropout_input(dname, shape, (lead + 1) % 4, gen, dev)
    n, es = x.numel(), x.element_size()
    out, bits = tnn._dropout_forward(x, seed, p)
    ref, ref_bits = tnn.dropout_forward_reference(x, seed, p)
    out2, bits2 = tnn._dropout_forward(x, seed, p)
    dx = tnn._dropout_backward(grad, bits, p)
    dx_ref = tnn.dropout_backward_reference(grad, ref_bits, p)
    keep = tnn.unpack_keep_bits(bits, n)
    torch.cuda.synchronize()
    kept = float(keep.float().mean())
    row = {"dtype": dname, "shape": list(shape), "p": p, "lead": lead,
           "x_off_16": x.data_ptr() % 16, "out_off_16": out.data_ptr() % 16,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "bitwise": bool(torch.equal(out, ref)),
           "repeat_bitwise": bool(torch.equal(out, out2) and
                                  torch.equal(bits, bits2)),
           "bwd_max_abs_err": (dx.float() - dx_ref.float()).abs().max()
           .item(),
           "bwd_bitwise": bool(torch.equal(dx, dx_ref)),
           "bits_bitwise": bool(torch.equal(bits, ref_bits)),
           "bits_unpack_to_mask": bool(torch.equal(
               keep, tnn.dropout_keep(n, seed, p, dev))),
           "keep_rate": kept, "keep_rate_gated": n >= DROPOUT_RATE_MIN_N}
    mask = tnn.dropout_forward_reference(torch.ones_like(grad), seed,
                                         p)[0] != 0
    scale = 1.0 / (1.0 - p)
    io_fwd = 2 * n * es + 4 * -(-n // 32) + 8
    io_bwd = 2 * n * es + 4 * -(-n // 32)
    rate = int32_rate()["ops_per_s"]
    for part, io, run, plain, yard in (
            ("fwd", io_fwd, lambda: tnn._dropout_forward(x, seed, p),
             lambda: tnn.dropout_forward_reference(x, seed, p),
             lambda: F.dropout(x, p, training=True)),
            ("bwd", io_bwd, lambda: tnn._dropout_backward(grad, bits, p),
             lambda: tnn.dropout_backward_reference(grad, ref_bits, p),
             lambda: torch.ops.aten.native_dropout_backward(grad, mask,
                                                            scale))):
        bound, by = _bound_ms(dname, io, 0, dropout_int_ops(part, n))
        per = (sass or {}).get(part)

        def cold(fn=run):
            flush.sum()
            return fn()
        row.update({
            # the kernel alone by device time, its inputs out of L2 as a
            # step's cold tensors are; warm: the same inputs launch after
            # launch, left in L2 by the last; the wrapper's call by
            # events (host-bound at these sizes)
            f"{part}_ms": device_ms(cold, match=DROPOUT_TRACE[part]),
            f"{part}_warm_ms": device_ms(run, match=DROPOUT_TRACE[part]),
            f"{part}_events_ms": cuda_ms(run),
            f"{part}_plain_ms": cuda_ms(plain, iters=5),
            f"{part}_yardstick_ms": device_ms(yard),
            f"{part}_yardstick_events_ms": cuda_ms(yard),
            f"{part}_bound_ms": bound, f"{part}_bound_by": by,
            f"{part}_bytes_bound_ms": io / HBM_BYTES_PER_S * 1e3,
            f"{part}_int_bound_ms": dropout_int_ops(part, n) / rate * 1e3,
            f"{part}_sass_int_ms": (n * per["int_per_element"] / rate * 1e3
                                    if per else "not measured")})
    # the forward's (the main-path) keys under the names the result
    # line reads
    row.update({"ms": row["fwd_ms"], "plain_ms": row["fwd_plain_ms"],
                "torch_dropout_ms": row["fwd_yardstick_ms"],
                "library_ms": None, "bound_ms": row["fwd_bound_ms"],
                "bound_by": row["fwd_bound_by"]})
    checks = [row["bitwise"], row["repeat_bitwise"], row["bwd_bitwise"],
              row["bits_bitwise"], row["bits_unpack_to_mask"]]
    if row["keep_rate_gated"]:
        checks.append(abs(kept - (1 - p)) < 0.01)
    row["ok"] = all(checks)
    return row


def phase_dropout(dev):
    """The dropout kernels against their plain versions at
    `DROPOUT_CASES` (bitwise: outputs, the packed keep bits, the
    gradient), the bits against the plain mask, the keep rate, and each
    kernel's time beside its bytes and integer-work bounds, its plain
    version and torch's (other bits and inputs, so yardsticks only: no
    library call computes this function).  Prints each kernel's SASS
    main loop as counted."""
    import torch
    gen = torch.Generator().manual_seed(55)
    seed = torch.tensor([0x2468ACE, -0x1357], dtype=torch.int32, device=dev)
    sass = {d: dropout_sass(d) for d in _SASS_TYPE}
    log("kernel_dropout_sass: " + json.dumps(
        {"int32_rate": int32_rate(), "loops": sass}))
    flush = l2_flush(dev)
    rows = []
    for dname, shape, p, lead in DROPOUT_CASES:
        row = _dropout_case(dname, shape, p, lead, gen, seed, sass[dname],
                            flush)
        rows.append(row)
        log("kernel_dropout: " + json.dumps(row))
    del flush
    failed = [(r["dtype"], r["shape"], r["lead"]) for r in rows
              if not r["ok"]]
    if failed:
        raise SystemExit(f"the dropout kernels disagree with their plain "
                         f"versions: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: serving BERT-base through Endpoint
# ---------------------------------------------------------------------------
def make_requests(n, max_len, vocab, seed):
    """``n`` requests (tokens, segments, valid_mask), one row each, with
    lengths spread evenly over 1..max_len in shuffled order."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    lengths = rng.permutation(onp.linspace(1, max_len, n).astype(int))
    reqs = []
    for n_tok in lengths:
        tokens = rng.integers(1, vocab, (1, n_tok)).astype(onp.int32)
        segments = (onp.arange(n_tok) >= n_tok // 2).astype(onp.int32)[None]
        reqs.append((tokens, segments, onp.ones((1, n_tok), onp.int32)))
    return reqs


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _traffic(ep, reqs, results, latencies):
    """``reqs`` submitted to ``ep`` from N_CLIENTS threads, each waiting
    for its result; returns the wall seconds until all are served."""
    def client(idx):
        for i in idx:
            t_sub = time.perf_counter()
            results[i] = ep.submit(*reqs[i]).result(timeout=300)
            latencies[i] = time.perf_counter() - t_sub

    threads = [threading.Thread(
        target=client, args=(range(c, len(reqs), N_CLIENTS),))
        for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise SystemExit("serving clients did not finish")
    return time.perf_counter() - t0


def serve(net, dev, reqs, seq_buckets):
    """Serve ``reqs`` from N_CLIENTS threads through an Endpoint, timed;
    then the same traffic again, traced, from flash launch counts of 0:
    B3's launches counted from the trace and by its wrapper, and the
    batches the traced traffic took.  Returns (results, latencies_s,
    wall_s, stats, {"traced", "booked", "batches"}, endpoint)."""
    from mxnet_tpu_torch.ops.flash_attention import FLASH_FWD
    from mxnet_tpu_torch.serve import Endpoint

    results = [None] * len(reqs)
    latencies = [None] * len(reqs)
    with Endpoint(net, device=dev, max_batch_size=8, max_latency_ms=5,
                  seq_buckets=seq_buckets) as ep:
        t0 = time.perf_counter()
        warmed = ep.warmup(*reqs[0])
        log(f"serve: warmup ran {warmed} bucket shapes in "
            f"{time.perf_counter() - t0:.2f} s")
        wall = _traffic(ep, reqs, results, latencies)
        stats = ep.stats()
        before = {}

        def reset():
            FLASH_FWD.launches = 0
            before["batches"] = ep.stats()["batches"]
        reset()
        _, traced = traced_launches(lambda: _traffic(
            ep, reqs, [None] * len(reqs), [None] * len(reqs)), reset)
        launches = {"traced": traced["flash_attention_fwd"],
                    "booked": FLASH_FWD.launches,
                    "batches": ep.stats()["batches"] - before["batches"]}
    return results, latencies, wall, stats, launches, ep


def phase_serve(dev, cfg=None, seq_buckets=SEQ_BUCKETS, dtype="bfloat16"):
    import numpy as onp
    import torch
    from mxnet_tpu_torch.models import bert_base

    cfg = dict(cfg or {}, use_flash=True, dropout=0.1)
    n_layers = cfg.get("num_layers", 12)
    net = bert_base(**cfg).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast(dtype)
    vocab = net.word_embed._input_dim
    max_len = seq_buckets[-1]
    reqs = make_requests(N_CLIENTS * PER_CLIENT, max_len, vocab, seed=7)
    results, lat, wall, stats, launches, ep = serve(net, dev, reqs,
                                                    seq_buckets)

    for req, res in zip(reqs, results):
        seq, pooled = res
        n_tok = req[0].shape[1]
        if tuple(seq.shape) != (1, n_tok, cfg.get("units", 768)) or \
                not bool(torch.isfinite(seq).all()) or \
                not bool(torch.isfinite(pooled).all()):
            raise SystemExit(f"bad result for a request of length {n_tok}")
    expect = n_layers * launches["batches"]
    log(f"serve: traced traffic: B3 launched {launches['traced']} times "
        f"on the card (its wrapper counted {launches['booked']}) in "
        f"{launches['batches']} batches")
    if launches["traced"] != expect or launches["booked"] != expect:
        raise SystemExit(f"flash kernel launches {launches} != "
                         f"{n_layers} x {launches['batches']} batches")
    # the graphs, before the model's attention is switched to dense below
    buckets = _bucket_replays(ep, vocab, dev)
    swap = phase_swap(net, dev, seq_buckets, cfg, dtype)

    # one request padded inside its bucket, checked alone and against
    # dense attention
    i = min(range(len(reqs)),
            key=lambda j: abs(reqs[j][0].shape[1] - 0.6 * max_len))
    req = reqs[i]
    args = [torch.from_numpy(a).to(dev) for a in req]
    with torch.inference_mode():
        alone = net(*args)
        for blk in net.modules():
            if hasattr(blk, "_use_flash"):
                blk._use_flash = False
        dense = net(*args)
    err_alone = max(rel_err(a, b) for a, b in zip(results[i], alone))
    err_dense = max(rel_err(a, b) for a, b in zip(results[i], dense))
    ok = err_alone <= SERVE_REL_TOL and err_dense <= SERVE_REL_TOL
    n_tokens = sum(r[0].shape[1] for r in reqs)
    lat_ms = onp.sort(onp.asarray(lat) * 1e3)
    out = {
        "model": "bert_base", "dtype": dtype, "seq_buckets": list(seq_buckets),
        "requests": len(reqs), "clients": N_CLIENTS, "tokens": n_tokens,
        "wall_s": wall, "req_per_s": len(reqs) / wall,
        "tokens_per_s": n_tokens / wall,
        "latency_ms_p50": float(onp.percentile(lat_ms, 50)),
        "latency_ms_p99": float(onp.percentile(lat_ms, 99)),
        "batches": stats["batches"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "execute_ms_p50": stats["execute_ms_p50"],
        "execute_ms_p99": stats["execute_ms_p99"],
        "cache_hits": stats["cache_hits"],
        "cache_misses": stats["cache_misses"],
        "flash_launches": launches["traced"],
        "flash_launches_booked": launches["booked"],
        "traced_batches": launches["batches"],
        "checked_request_len": int(req[0].shape[1]),
        "rel_err_vs_alone": err_alone, "rel_err_vs_dense": err_dense,
        "rel_tol": SERVE_REL_TOL,
    }
    out["buckets"], out["swap"] = buckets, swap
    log("serve: " + json.dumps(out))
    if not ok:
        raise SystemExit("served result disagrees with the direct forward")
    return out, net


def _bucket_inputs(key, vocab, dev, seed):
    """Inputs of one bucket key: tokens drawn from ``seed``, segments
    zero, every position valid."""
    import torch
    (shape, _), *_ = key
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, vocab, shape, generator=gen,
                           dtype=torch.int32).to(dev)
    return [tokens, torch.zeros_like(tokens), torch.ones_like(tokens)]


def _bucket_replays(ep, vocab, dev):
    """Each warmed bucket's graph replayed against its eager forward on
    the same inputs (bitwise), and the replayed batch timed at the
    smallest and largest bucket: wall time per batch back to back
    (copy in, replay, copies out, sync), and one traced batch."""
    import torch
    cache = ep._cache_for(ep._version)
    equal, keys = 0, sorted(cache._entries, key=lambda k: k[0][0])
    for i, key in enumerate(keys):
        inputs = _bucket_inputs(key, vocab, dev, seed=100 + i)
        eager = cache._fn(*inputs)
        replayed = cache._entries[key](inputs)
        torch.cuda.synchronize()
        equal += all(torch.equal(a, b) for a, b in zip(eager, replayed))
    out = {"buckets": len(keys), "replay_equals_eager": equal}
    log(f"serve: {equal} of {len(keys)} warmed buckets replay bitwise "
        "equal to their eager forward")
    if equal != len(keys):
        raise SystemExit("a bucket's graph replay differs from its eager "
                         "forward")
    for key in (keys[0], keys[-1]):
        inputs = _bucket_inputs(key, vocab, dev, seed=7)
        cache(inputs)
        t0 = time.perf_counter()
        for _ in range(20):
            cache(inputs)
        batch_ms = (time.perf_counter() - t0) / 20 * 1e3
        shape = list(key[0][0])
        prof = profile_call(lambda: cache(inputs),
                            f"replayed batch at {tuple(shape)}", batch_ms)
        # the batch's one designed sync: the stream, before its latency
        # is stamped
        prof["host_syncs_per_batch"] = _count_syncs(lambda: cache(inputs))[0]
        out[f"replayed_batch_{shape[0]}x{shape[1]}"] = prof
        log(f"serve: replayed batch at {tuple(shape)}: {batch_ms:.3f} ms "
            "per batch back to back (copy in, replay, copies out, sync); "
            f"{prof['host_syncs_per_batch']} host syncs a batch")
    return out


def phase_swap(net, dev, seq_buckets, cfg, dtype):
    """``swap_model`` under live traffic: two clients keep submitting
    while the main thread swaps in a second BERT-base (other random
    weights), whose grid is warmed and captured beside the live replays.
    Every request must resolve finite and of its shape, the version must
    flip, and a request served after the flip must match the new model's
    direct forward."""
    import torch
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.serve import Endpoint

    new = bert_base(**cfg).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(1))
    new.cast(dtype)
    vocab = new.word_embed._input_dim
    reqs = make_requests(24, seq_buckets[-1], vocab, seed=9)
    results = [None] * len(reqs)
    with Endpoint(net, device=dev, max_batch_size=8, max_latency_ms=5,
                  seq_buckets=seq_buckets) as ep:
        ep.warmup(*reqs[0])

        def client(idx):
            for i in idx:
                results[i] = ep.submit(*reqs[i]).result(timeout=300)
                time.sleep(0.01)

        threads = [threading.Thread(target=client,
                                    args=(range(c, len(reqs), 2),))
                   for c in range(2)]
        for th in threads:
            th.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        version = ep.swap_model(new)
        swap_s = time.perf_counter() - t0
        for th in threads:
            th.join(timeout=600)
        req = reqs[len(reqs) // 2]
        after = ep.predict(*req)
        stats = ep.stats()
    with torch.inference_mode():
        direct = new(*[torch.from_numpy(a).to(dev) for a in req])
    err = max(rel_err(a, b) for a, b in zip(after, direct))
    finite = all(r is not None and bool(torch.isfinite(r[0]).all()) and
                 r[0].shape[1] == q[0].shape[1]
                 for r, q in zip(results, reqs))
    out = {"requests": len(reqs), "swap_s": swap_s, "version": version,
           "all_served_finite": finite, "rel_err_after_swap": err,
           "model_version": stats["model_version"],
           "executables": stats["executables"]}
    log("serve: swap under live traffic: " + json.dumps(out))
    if not (finite and version == 1 and err <= SERVE_REL_TOL):
        raise SystemExit("swap_model under live traffic failed")
    del new
    return out


# ---------------------------------------------------------------------------
# phase 4: where one forward's time goes
# ---------------------------------------------------------------------------
def _device_times(prof):
    """ms on the device by kernel name, and the kernel launches, of a
    finished ``torch.profiler`` trace (device work only, not the ops)."""
    import torch
    per_kernel, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        per_kernel[evt.key] = us / 1e3
        launches += evt.count
    return per_kernel, launches


# the host's launch calls, as the profiler names the CUDA API calls
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


def _host_launches(prof):
    """{API call: count} of the host's kernel and graph launches in a
    finished ``torch.profiler`` trace."""
    import torch
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU and \
                evt.key in HOST_LAUNCHES:
            out[evt.key] = out.get(evt.key, 0) + evt.count
    return out


def _named_launches(prof, names):
    """{tag: kernel launches on the card} of a finished ``torch.profiler``
    trace, for each ``tag: regex`` of ``names`` matched in the kernel's
    name."""
    import torch
    counts = dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for tag, pat in names.items():
            if re.search(pat, evt.key):
                counts[tag] += evt.count
    return counts


# spin kernels (``torch.cuda._sleep``) run at the start of a counted
# trace, before ``fn``, and again at its end: the profiler now and then
# loses the first records of a trace (seen on an H100: the leading
# kernels of a word-LM forward, its first dropout launch among them),
# and once lost one replay's kernels at the end of a fleet's storm, so a
# count is read only from a trace that kept more of these than one end
# launched (so at least one at each end, if what it loses are the
# first or the last records)
TRACE_PAD, TRACE_PAD_CYCLES = 256, 10000
TRACE_PAD_NAME = r"\bspin_kernel\b"


def traced_launches(fn, reset, agree=None):
    """Run ``fn()`` traced by ``torch.profiler`` (device activity only)
    between two runs of `TRACE_PAD` spin kernels; returns its result and
    the launches of each of `KERNEL_NAMES` the trace recorded, a CUDA
    graph's replayed kernels included.  A count is read only from a
    trace that kept more than `TRACE_PAD` spin kernels, since what a
    trace lost at either end may reach into ``fn``'s launches: where
    fewer were kept (seen on an H100 right after another trace),
    ``reset()`` puts the caller's bookkeeping back to where it stood and
    ``fn`` runs again under a fresh trace, once; a second loss fails.
    ``agree(kept_enough)``, where ``fn`` is one step of several ranks,
    returns whether every rank's trace kept enough, so that all of them
    trace again or none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(TRACE_PAD_CYCLES)
        torch.cuda.synchronize()

    for attempt in range(2):
        if attempt:
            log(f"the profiler kept {kept} of the {2 * TRACE_PAD} spin "
                "kernels around a counted trace; tracing again")
            reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad()
            result = fn()
            torch.cuda.synchronize()
            pad()
        counts = _named_launches(prof, dict(KERNEL_NAMES,
                                            pad=TRACE_PAD_NAME))
        kept = counts.pop("pad")
        if (agree or bool)(kept > TRACE_PAD):
            return result, counts
    raise SystemExit(f"the profiler kept {kept} of the {2 * TRACE_PAD} "
                     "spin kernels around a counted trace, twice")


def device_ms(fn, iters=20, match=None):
    """Time per call of ``fn()`` that the card spends running its
    kernels (with ``match``, a regex, only those whose name it matches),
    summed by ``torch.profiler`` over ``iters`` calls after one warm-up:
    the host's launch gaps are left out, for calls whose host work
    outlasts their device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ms for name, ms in _device_times(prof)[0].items()
               if match is None or re.search(match, name)) / iters


def profile_call(fn, label, back_to_back_ms, named=None):
    """Trace one call of ``fn`` with ``torch.profiler``: the device time
    summed over kernels, the share of ``back_to_back_ms`` the card was
    idle, the kernel launches and the ten largest kernels; and for each
    ``named`` tag, the device time and the launches of the kernels whose
    name matches its regex."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel, launches = _device_times(prof)
    host = _host_launches(prof)
    total = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"what": label, "back_to_back_ms": back_to_back_ms,
           "device_ms_traced": total if total else "not measured",
           "idle_share": (1 - total / back_to_back_ms) if total
           else "not measured",
           "kernel_launches": launches, "host_launch_calls": host,
           "top_kernels_ms": top}
    log(f"profile: {label}: {back_to_back_ms:.3f} ms back to back, "
        f"{total:.3f} ms of it on the device in {launches} kernel launches; "
        f"host launch calls {json.dumps(host)}")
    for name, ms in top:
        log(f"profile:   {ms:9.3f} ms  {name[:90]}")
    if named:
        out["named_device_ms"] = {
            tag: sum(ms for name, ms in per_kernel.items()
                     if re.search(pat, name))
            for tag, pat in named.items()}
        out["named_launches"] = _named_launches(prof, named)
        log(f"profile: {label}: device ms by kernel: "
            + json.dumps(out["named_device_ms"]) + "; launches: "
            + json.dumps(out["named_launches"]))
    return out


def profile_forward(net, dev, rows, seq_len):
    """One forward at (rows, seq_len): its time back to back by CUDA
    events (bounded by the host when the host launches slower than the
    card runs) and its trace."""
    import torch

    vocab = net.word_embed._input_dim
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, vocab, (rows, seq_len), generator=gen).to(dev)
    segments = torch.zeros_like(tokens)
    valid = torch.ones_like(tokens)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: net(tokens, segments, valid), iters=10)
        out = profile_call(lambda: net(tokens, segments, valid),
                           f"forward at ({rows}, {seq_len})", fwd_ms)
        out["host_syncs"] = _count_syncs(
            lambda: net(tokens, segments, valid))[0]
    log(f"profile: forward at ({rows}, {seq_len}): {out['host_syncs']} "
        "host syncs")
    return out


def phase_profile(net, dev):
    for blk in net.modules():
        if hasattr(blk, "_use_flash"):
            blk._use_flash = True
    return [profile_forward(net, dev, 8, 512),
            profile_forward(net, dev, 1, 128)]


# ---------------------------------------------------------------------------
# phase 4c: serving breadth: the endpoint's hooks, a Fleet, continuous
# batching
# ---------------------------------------------------------------------------
# tools/storm.py's traffic shape at BERT-base: 6 clients x 16 requests of
# 1-512 tokens, the classes in turn, a replica killed at the 24th
# dispatch (a quarter in, after warm traffic: the tool's total / 4)
STORM_CLIENTS, STORM_PER_CLIENT = 6, 16
STORM_CLASSES = ("interactive", "standard", "batch")
STORM_KILL_AT = 24
# the endpoint's timing windows (telemetry on and off in turns) and the
# hooks' microbenchmark
HOOK_WINDOWS, HOOK_CALLS = 4, 2000
# the word LM (BASELINE config 5) behind ContinuousBatcher: 8 decode
# slots, 32 prompts of 4-64 tokens with budgets of 8-64 tokens
CONT_SLOTS, CONT_PROMPTS = 8, 32
CONT_PROMPT_LEN, CONT_BUDGET, CONT_EOS = (4, 64), (8, 64), 3


def _registry(name, labels):
    from mxnet_tpu_torch import telemetry
    v = telemetry.default_registry().get_sample_value(name, labels)
    return 0.0 if v is None else v


def storm_requests(vocab, seed):
    """STORM_CLIENTS x STORM_PER_CLIENT requests, ((tokens, segments,
    valid), class): one row each of 1-512 tokens from ``seed``, the
    classes in turn."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    out = []
    for i in range(STORM_CLIENTS * STORM_PER_CLIENT):
        n_tok = int(rng.integers(1, SEQ_BUCKETS[-1] + 1))
        tokens = rng.integers(1, vocab, (1, n_tok)).astype(onp.int32)
        segments = (onp.arange(n_tok) >= n_tok // 2).astype(onp.int32)[None]
        out.append(((tokens, segments, onp.ones((1, n_tok), onp.int32)),
                    STORM_CLASSES[i % len(STORM_CLASSES)]))
    return out


def _alone(net, dev, reqs):
    """Each request's (seq, pooled) from the net alone, eagerly."""
    import torch
    with torch.inference_mode():
        return [net(*[torch.from_numpy(a).to(dev) for a in req])
                for req, _ in reqs]


def _endpoints(target):
    return [r.endpoint for r in target.replicas] \
        if hasattr(target, "replicas") else [target]


def _storm_traffic(target, reqs):
    """``reqs`` submitted to ``target`` (a Fleet, with each request's
    class, or an Endpoint) from STORM_CLIENTS threads, each pausing
    0-4 ms between submits (seeded), then every future awaited.  Returns
    (outcomes: result or exception, latencies_s, wall_s)."""
    import numpy as onp
    n = len(reqs)
    futs, t_sub, t_done = [None] * n, [None] * n, [None] * n
    fleet = hasattr(target, "router")

    def done(i, _fut):
        t_done[i] = time.perf_counter()

    def client(c):
        rng = onp.random.default_rng(100 + c)
        for i in range(c, n, STORM_CLIENTS):
            req, cls = reqs[i]
            t_sub[i] = time.perf_counter()
            fut = target.submit(*req, cls=cls) if fleet else \
                target.submit(*req)
            fut.add_done_callback(functools.partial(done, i))
            futs[i] = fut
            time.sleep(float(rng.uniform(0.0, 0.004)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(STORM_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result(timeout=300))
        except Exception as exc:              # noqa: BLE001
            outcomes.append(exc)
    ends = [t for t in t_done if t is not None]
    wall = (max(ends) if ends else time.perf_counter()) - t0
    lat = [d - s if d is not None else None for s, d in zip(t_sub, t_done)]
    return outcomes, lat, wall


def _class_latency(lat, reqs):
    """Exact p50/p99 ms of each class's latencies, submit to result."""
    import numpy as onp
    out = {}
    for cls in STORM_CLASSES:
        ms = [x * 1e3 for x, (_, c) in zip(lat, reqs)
              if c == cls and x is not None]
        out[cls] = {"p50_ms": float(onp.percentile(ms, 50)) if ms else None,
                    "p99_ms": float(onp.percentile(ms, 99)) if ms else None}
    return out


def storm(label, build, reqs, alone, n_layers, plan=None):
    """The storm through ``build()``'s target, traced by `traced_launches`
    (a lost trace rebuilds the target when ``plan``, a faultline plan,
    has killed a replica of it).  Returns the run's numbers, its gates'
    inputs and the target."""
    import torch
    from mxnet_tpu_torch.ops.flash_attention import FLASH_FWD
    from mxnet_tpu_torch.resilience import faultline
    from mxnet_tpu_torch.serve import DeadlineExceeded

    state = {}
    recovered = {"site": "serve.replica", "kind": "preempt"}

    def reset():
        if plan and "target" in state:
            state.pop("target").shutdown(drain=False)
        if "target" not in state:
            state["base_gb"] = torch.cuda.memory_allocated() / 1e9
            state["target"] = build()
        FLASH_FWD.launches = 0
        state["batches"] = [ep.stats()["batches"]
                            for ep in _endpoints(state["target"])]
        state["recovered"] = _registry("mxtpu_faults_recovered_total",
                                       recovered)
        if plan:
            faultline.plan(plan)
        torch.cuda.reset_peak_memory_stats()

    reset()
    try:
        (outcomes, lat, wall), traced = traced_launches(
            lambda: _storm_traffic(state["target"], reqs), reset)
    finally:
        faultline.clear()
    target = state["target"]
    batches = [ep.stats()["batches"] - b0
               for ep, b0 in zip(_endpoints(target), state["batches"])]
    done = [(i, o) for i, o in enumerate(outcomes)
            if not isinstance(o, BaseException)]
    shed = sum(isinstance(o, DeadlineExceeded) for o in outcomes)
    errors = [o for o in outcomes if isinstance(o, BaseException)
              and not isinstance(o, DeadlineExceeded)]
    err = max((rel_err(a, b) for i, o in done
               for a, b in zip(o, alone[i])), default=None)
    tokens = sum(req[0].shape[1] for req, _ in reqs)
    out = {
        "what": label, "requests": len(reqs), "completed": len(done),
        "shed": shed, "failed": len(errors),
        "first_error": repr(errors[0])[:200] if errors else None,
        "wall_s": wall, "req_per_s": len(reqs) / wall,
        "tokens_per_s": tokens / wall,
        "latency_ms": _class_latency(lat, reqs),
        "batches_per_replica": batches,
        "flash_launches": traced["flash_attention_fwd"],
        "flash_launches_booked": FLASH_FWD.launches,
        "flash_launches_expected": n_layers * sum(batches),
        "max_rel_err_vs_alone": err, "rel_tol": SERVE_REL_TOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mem_before_build_gb": state["base_gb"],
        "traced": True,
    }
    if hasattr(target, "sla_report"):
        out["sla"] = target.sla_report()
        out["dead"] = [f"r{r.index}" for r in target.replicas
                       if r.state == "dead"]
        out["failover_s"] = {"count": target.metrics._failover.count,
                             "sum": target.metrics._failover.sum}
        out["recovered"] = _registry("mxtpu_faults_recovered_total",
                                     recovered) - state["recovered"]
        out["kill_s"] = target.kill_seconds
    log(f"fleet: {label}: " + json.dumps(out))
    if len(done) + shed + len(errors) != len(reqs) or errors or shed \
            or err is None or err > SERVE_REL_TOL:
        raise SystemExit(f"fleet: {label}: a request was not answered, "
                         f"failed, shed or wrong: {out}")
    if not out["flash_launches"] == out["flash_launches_booked"] == \
            out["flash_launches_expected"]:
        raise SystemExit(f"fleet: {label}: flash launches "
                         f"{out['flash_launches']} traced, "
                         f"{out['flash_launches_booked']} booked != "
                         f"{n_layers} x {sum(batches)} batches")
    return out, target


def _hooks_us(ep, n=HOOK_CALLS):
    """Host us of what `Endpoint._execute` runs around one batch's device
    call (the fault hook inside the one-retry wrapper inside the batch
    span, the metrics' batch and execute observations, the batch hooks
    registered on ``ep``), around no device call, ``n`` times, with
    telemetry on and off in turns.  The metrics go to a throwaway
    `EndpointMetrics`."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import faultline
    from mxnet_tpu_torch.resilience.policies import retry_transient
    from mxnet_tpu_torch.serve import EndpointMetrics

    metrics = EndpointMetrics("chip_smoke/hooks")
    hooks = list(ep._batch_hooks)
    out = {"on": [], "off": []}
    try:
        for w in range(HOOK_WINDOWS):
            tag = "on" if w % 2 == 0 else "off"
            telemetry.set_enabled(tag == "on")
            t0 = time.perf_counter()
            for _ in range(n):
                with telemetry.span("serve/chip_smoke/hooks/batch",
                                    cat="serve", args={"rows": 8,
                                                       "bucket": 8,
                                                       "requests": 8}):
                    retry_transient(
                        lambda: faultline.check("serve.model_call"),
                        site="serve.model_call", retries=1)
                metrics.observe_batch(8, 8)
                metrics.observe_execute(1e-3)
                for hook in hooks:
                    hook(ep, 8, 8, 1e-3)
            out[tag].append((time.perf_counter() - t0) / n * 1e6)
    finally:
        telemetry.set_enabled(True)
    return out


def _timed_windows(ep, reqs):
    """The 48 requests of phase 3's traffic through ``ep``, HOOK_WINDOWS
    times with telemetry on and off in turns: req/s, and execute p50/p99
    from the batch hook's latencies."""
    import numpy as onp
    from mxnet_tpu_torch import telemetry

    seen = []
    handle = ep.register_batch_hook(lambda _e, _r, _b, s: seen.append(s))
    out = {"on": [], "off": []}
    try:
        for w in range(HOOK_WINDOWS):
            tag = "on" if w % 2 == 0 else "off"
            telemetry.set_enabled(tag == "on")
            seen.clear()
            wall = _traffic(ep, reqs, [None] * len(reqs),
                            [None] * len(reqs))
            ms = onp.asarray(seen) * 1e3
            out[tag].append({"req_per_s": len(reqs) / wall,
                             "batches": len(seen),
                             "execute_ms_p50": float(onp.percentile(ms, 50)),
                             "execute_ms_p99": float(onp.percentile(ms, 99))})
    finally:
        telemetry.set_enabled(True)
        handle.detach()
    return out


def _retry_once(ep, net, dev, vocab):
    """One request with a ``serve.model_call`` timeout injected at the
    next arrival: retried once, answered within SERVE_REL_TOL of the
    request alone."""
    import torch
    from mxnet_tpu_torch.resilience import faultline

    req = make_requests(1, 300, vocab, seed=21)[0]
    labels = {"site": "serve.model_call", "kind": "timeout"}
    before = _registry("mxtpu_faults_recovered_total", labels)
    faultline.plan([{"site": "serve.model_call", "kind": "timeout",
                     "at": 1}])
    try:
        got = ep.predict(*req)
        arrivals = faultline.arrivals("serve.model_call")
    finally:
        faultline.clear()
    with torch.inference_mode():
        want = net(*[torch.from_numpy(a).to(dev) for a in req])
    out = {"arrivals": arrivals,
           "recovered": _registry("mxtpu_faults_recovered_total", labels)
           - before,
           "rel_err_vs_alone": max(rel_err(a, b) for a, b in zip(got, want))}
    if not (arrivals == 2 and out["recovered"] == 1
            and out["rel_err_vs_alone"] <= SERVE_REL_TOL):
        raise SystemExit(f"fleet: the injected model-call timeout was not "
                         f"retried once and answered: {out}")
    return out


def _registry_vs_stats(ep):
    s = ep.stats()
    lab = {"endpoint": ep.name}
    got = {e: _registry("mxtpu_serve_requests_total", dict(lab, event=e))
           for e in ("submitted", "completed", "failed", "timeouts",
                     "rejected_full")}
    got["cache_hits"] = _registry("mxtpu_serve_cache_total",
                                  dict(lab, kind="hit"))
    got["cache_misses"] = _registry("mxtpu_serve_cache_total",
                                    dict(lab, kind="miss"))
    got["batches"] = _registry("mxtpu_serve_batches_total", lab)
    bad = {k: (v, s[k]) for k, v in got.items() if v != s[k]}
    counts = {"latency": ("mxtpu_serve_latency_seconds_count", "completed"),
              "execute": ("mxtpu_serve_execute_seconds_count", "batches")}
    for key, (series, stat) in counts.items():
        if _registry(series, lab) != s[stat]:
            bad[key] = (_registry(series, lab), s[stat])
    if bad:
        raise SystemExit(f"fleet: registry != stats(): {bad}")
    return {k: got[k] for k in ("submitted", "completed", "batches",
                                "cache_hits", "cache_misses")}


def _spans_and_monitor(ep, reqs):
    """The traffic under a running profiler: one ``serve/<name>/batch``
    span a batch in its dump; and again under `Monitor.install_endpoint`:
    two rows a batch (occupancy, latency)."""
    import os
    import tempfile

    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.monitor import Monitor

    fd, path = tempfile.mkstemp(suffix=".json", prefix="serve-trace-")
    os.close(fd)
    profiler.set_config(filename=path)
    try:
        b0 = ep.stats()["batches"]
        profiler.set_state("run")
        _traffic(ep, reqs, [None] * len(reqs), [None] * len(reqs))
        profiler.dump()
        batches = ep.stats()["batches"] - b0
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        profiler.set_config(filename="profile.json")
        os.remove(path)
    spans = sum(1 for e in events if e.get("ph") == "X"
                and e.get("name") == f"serve/{ep.name}/batch")
    mon = Monitor(interval=1)
    mon.install_endpoint(ep)
    b0 = ep.stats()["batches"]
    mon.tic()
    _traffic(ep, reqs, [None] * len(reqs), [None] * len(reqs))
    rows = mon.toc()
    mon.uninstall()
    mon_batches = ep.stats()["batches"] - b0
    out = {"batches": batches, "spans": spans, "monitor_rows": len(rows),
           "monitor_batches": mon_batches}
    if spans != batches or len(rows) != 2 * mon_batches:
        raise SystemExit(f"fleet: spans or monitor rows != batches: {out}")
    return out


def _swap_stage(ep, net, vocab):
    """``swap_model(stage=True)``: no miss after the flip over phase 3's
    traffic; ``stage=False``: one miss per warmed shape used, then
    hits."""
    reqs = make_requests(N_CLIENTS * PER_CLIENT, SEQ_BUCKETS[-1], vocab,
                         seed=23)
    m0 = ep.stats()["cache_misses"]
    t0 = time.perf_counter()
    ep.swap_model(net, stage=True)
    staged_s = time.perf_counter() - t0
    _traffic(ep, reqs, [None] * len(reqs), [None] * len(reqs))
    staged = ep.stats()["cache_misses"] - m0
    ep.swap_model(net, stage=False)
    one_each = make_requests(len(SEQ_BUCKETS), SEQ_BUCKETS[-1], vocab,
                             seed=25)
    m0 = ep.stats()["cache_misses"]
    for req in one_each + one_each:
        ep.predict(*req)
    lazy = ep.stats()["cache_misses"] - m0
    shapes = len({ep.spec.signature(r) for r in one_each})
    out = {"stage_true_misses": staged, "stage_true_s": staged_s,
           "stage_false_misses": lazy, "shapes_used": shapes,
           "model_version": ep.stats()["model_version"]}
    if staged != 0 or lazy != shapes:
        raise SystemExit(f"fleet: swap_model(stage=) misses: {out}")
    return out


def phase_fleet(net, dev):
    """Phase 4c (a) and (b): the endpoint's hooks on phase 3's endpoint
    configuration, then the storm through a 2-replica Fleet with a
    replica killed, a 1-replica Fleet and the bare Endpoint."""
    import gc
    import warnings

    import torch
    from mxnet_tpu_torch.monitor import Monitor
    from mxnet_tpu_torch.serve import Endpoint, Fleet

    for blk in net.modules():
        if hasattr(blk, "_use_flash"):
            blk._use_flash = True
    vocab = net.word_embed._input_dim
    n_layers = net.encoder._num_layers
    kw = dict(max_batch_size=8, max_latency_ms=5, seq_buckets=SEQ_BUCKETS)
    reqs = make_requests(N_CLIENTS * PER_CLIENT, SEQ_BUCKETS[-1], vocab,
                         seed=7)
    traffic = storm_requests(vocab, seed=11)
    alone = _alone(net, dev, traffic)
    out = {}
    with Endpoint(net, name="chip_smoke/bert_base", device=dev,
                  **kw) as ep:
        ep.warmup(*reqs[0])
        hooks = {"windows": _timed_windows(ep, reqs),
                 "retry": _retry_once(ep, net, dev, vocab),
                 "traced": _spans_and_monitor(ep, reqs)}
        mon = Monitor(interval=1)
        mon.install_endpoint(ep)
        hooks["hooks_us"] = _hooks_us(ep)
        mon.uninstall()
        hooks["registry"] = _registry_vs_stats(ep)
        log("fleet: endpoint hooks: " + json.dumps(hooks))
        out["endpoint"], _ = storm("bare endpoint", lambda: ep, traffic,
                                   alone, n_layers)
        hooks["swap"] = _swap_stage(ep, net, vocab)
        log("fleet: swap_model(stage=): " + json.dumps(hooks["swap"]))
    out["hooks"] = hooks

    def fleet(replicas, name):
        def build():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                f = Fleet(net, replicas=replicas,
                          name=f"chip_smoke/{name}", **kw)
            shared = [str(w.message) for w in caught
                      if issubclass(w.category, RuntimeWarning)]
            if replicas > 1 and not shared:
                raise SystemExit("fleet: no RuntimeWarning for replicas "
                                 "sharing the card")
            # the seconds the dispatcher spends in each replica kill
            kill, f.kill_seconds = f.kill_replica, []

            def timed_kill(index):
                t0 = time.perf_counter()
                kill(index)
                f.kill_seconds.append(time.perf_counter() - t0)
            f.kill_replica = timed_kill
            t0 = time.perf_counter()
            f.warmup(*reqs[0])
            log(f"fleet: {replicas} replica(s) warmed in "
                f"{time.perf_counter() - t0:.2f} s"
                + (f"; warned: {shared[0][:120]}" if shared else ""))
            return f
        return build

    out["fleet2"], f2 = storm("2 replicas", fleet(2, "fleet2"), traffic,
                              alone, n_layers)
    f2.shutdown(drain=True)
    del f2
    plan = [{"site": "serve.replica", "kind": "preempt",
             "at": STORM_KILL_AT}]
    out["fleet2_kill"], f2 = storm("2 replicas, one killed",
                                   fleet(2, "fleet2_kill"), traffic, alone,
                                   n_layers, plan=plan)
    f2.shutdown(drain=True)
    del f2, ep
    gc.collect()
    torch.cuda.empty_cache()
    k = out["fleet2_kill"]
    if not (len(k["dead"]) == 1 and k["recovered"] >= 1
            and k["failover_s"]["count"] >= 1
            and all(v["ok"] for v in k["sla"].values())):
        raise SystemExit(f"fleet: the killed replica's failover or the "
                         f"SLA failed: {k}")
    out["fleet1"], f1 = storm("1 replica", fleet(1, "fleet1"), traffic,
                              alone, n_layers)
    f1.shutdown(drain=True)
    del f1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def word_lm_decoder(dev, seed=0):
    """BASELINE config 5's model, `RNNModel(10000, 650, 650, 2, "lstm",
    tie_weights=True)`, Xavier weights from ``seed``, in bf16 on ``dev``;
    and its greedy prefill and decode for `ContinuousBatcher` (the carry
    is (h, c), (layers, units) a sequence), the prefill timing itself
    into the list returned third."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models import RNNModel

    model = RNNModel(RNN_VOCAB, RNN_UNITS, RNN_UNITS, RNN_LAYERS, "lstm",
                     tie_weights=True)
    model.initialize(init=mx.init.Xavier(), ctx=dev,
                     generator=torch.Generator().manual_seed(seed))
    model.cast("bfloat16")
    prefill_ms = []

    def prefill(prompt):
        t0 = time.perf_counter()
        x = torch.from_numpy(prompt.astype(onp.int64)).reshape(-1, 1).to(dev)
        with torch.no_grad(), autograd.predict_mode():
            logits, (h, c) = model(x, model.begin_state(1, ctx=dev))
            tok = logits[-1, 0].argmax()
        _sync(dev)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return (h[:, 0], c[:, 0]), tok

    def decode(carry, toks):
        h, c = (s.transpose(0, 1) for s in carry)
        with autograd.predict_mode():
            logits, (h, c) = model(toks.reshape(1, -1), [h, c])
        return (h.transpose(0, 1), c.transpose(0, 1)), logits[0].argmax(-1)

    return prefill, decode, prefill_ms


def phase_continuous(dev):
    """Phase 4c (c): `ContinuousBatcher` over the word LM (see the
    module's docstring)."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import ContinuousBatcher

    rng = onp.random.default_rng(13)
    prompts = [rng.integers(0, RNN_VOCAB, int(rng.integers(
        CONT_PROMPT_LEN[0], CONT_PROMPT_LEN[1] + 1))) for _ in
        range(CONT_PROMPTS)]
    budgets = [int(b) for b in rng.integers(CONT_BUDGET[0],
                                            CONT_BUDGET[1] + 1,
                                            CONT_PROMPTS)]
    prefill, decode, prefill_ms = word_lm_decoder(dev)
    name = "chip_smoke/word_lm"
    with ContinuousBatcher(prefill, decode, slots=CONT_SLOTS,
                           eos_id=CONT_EOS, name=name) as cb:
        t0 = time.perf_counter()
        futs = [cb.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        run = cb.stats()
        prefill_p50 = float(onp.percentile(prefill_ms, 50))
        solo = [cb.generate(p, max_new_tokens=b, timeout=300)
                for p, b in zip(prompts, budgets)]
        seen, _ = _count_syncs(lambda: torch.ones(1, device=dev).item())
        syncs, examples = _count_syncs(
            lambda: (cb._decode(cb._carry, cb._last), cb._last.tolist()))
        step_ms = cuda_ms(lambda: cb._decode(cb._carry, cb._last), iters=50)
        captures = cb._decode.captures
    retraces = telemetry.watchdog().retrace_count(f"serve/{name}/decode")
    equal = sum(onp.array_equal(a, b) for a, b in zip(outs, solo))
    # decode steps a sequence was in a slot for: its tokens after the
    # prefill's, and the eos step where it stopped short of its budget
    active = sum(len(o) if len(o) < b else b - 1
                 for o, b in zip(outs, budgets))
    generated = sum(len(o) for o in outs)
    out = {"model": f"RNNModel({RNN_VOCAB}, {RNN_UNITS}, {RNN_UNITS}, "
                    f"{RNN_LAYERS}, lstm, tie_weights)",
           "dtype": "bfloat16", "slots": CONT_SLOTS,
           "sequences": len(prompts), "eos_id": CONT_EOS,
           "ended_at_eos": sum(len(o) < b for o, b in zip(outs, budgets)),
           "steps": run["steps"], "joins": run["joins"],
           "leaves": run["leaves"], "wall_s": wall,
           "tokens": generated, "tokens_per_s": generated / wall,
           "host_ms_per_step": wall / max(run["steps"], 1) * 1e3,
           "decode_replay_ms": step_ms,
           "mean_occupancy": active / max(run["steps"] * CONT_SLOTS, 1),
           "prefill_ms_p50": prefill_p50, "captures": captures,
           "retraces": retraces, "host_syncs_per_step": syncs
           if seen else "not measured", "sync_examples": examples,
           "solo_bitwise_equal": equal}
    log("continuous: " + json.dumps(out))
    if not (equal == len(prompts) and captures == 1 and retraces == 0
            and syncs == 1 and seen
            and run["joins"] == run["leaves"] == len(prompts)):
        raise SystemExit(f"continuous: a gate failed: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 3b: training BERT-base pretraining
# ---------------------------------------------------------------------------
def pretrain_loss(model):
    """The repo's BERT pretraining loss (`benchmark/bert_pretrain_bench.py`
    `PretrainLoss`): masked MLM over valid positions plus NSP, in f32."""
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import HybridBlock

    class PretrainLoss(HybridBlock):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, tokens, segments, labels, valid_mask):
            mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
            logp = npx.log_softmax(mlm_logits.float(), axis=-1)
            picked = npx.pick(logp, labels, axis=-1)
            m = valid_mask.float()
            mlm = -(picked * m).sum() / m.sum()
            nsp = -npx.log_softmax(nsp_logits.float())[:, 0].mean()
            return mlm + nsp

    return PretrainLoss(model)


def train_batch(dev, vocab, seed=12, b=B_TRAIN, t=T_TRAIN):
    """Tokens and labels from a seeded numpy generator, segments zero,
    the ragged valid mask of `train_mask`, at (b, t)."""
    import numpy as onp
    import torch
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(onp.int32)
    labels = rng.integers(0, vocab, (b, t)).astype(onp.int32)
    segments = onp.zeros((b, t), onp.int32)
    return [torch.from_numpy(a).to(dev) for a in
            (tokens, segments, labels, train_mask(b, t))]


def _launch_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    return {k.name: k.launches
            for k in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)}


def _reset_counts():
    from mxnet_tpu_torch.ops import flash_attention as fa
    for k in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV):
        k.launches = 0


def _reset_bert_counts():
    """The flash kernels' and both dropout kernels' counts to 0."""
    from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD
    _reset_counts()
    DROPOUT.launches = DROPOUT_BWD.launches = 0


def _snapshot(mod, trainer):
    """Weights, optimizer states, update counts and, with amp, the loss
    scaler's state and the trainer's skipped steps."""
    opt = trainer.optimizer
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    return ({k: p.data().detach().clone()
             for k, p in mod.collect_params().items()},
            {i: tuple(x.clone() for x in st)
             for i, st in trainer._states.items()},
            (dict(opt._index_update_count), opt.num_update),
            None if scaler is None else (scaler.loss_scale,
                                         scaler._unskipped,
                                         trainer.skipped_steps))


def _restore(mod, trainer, snap):
    import torch
    weights, states, (counts, num_update), scaled = snap
    with torch.no_grad():
        for k, p in mod.collect_params().items():
            p.data().copy_(weights[k])
        for i, st in trainer._states.items():
            for x, y in zip(st, states[i]):
                x.copy_(y)
    trainer.optimizer._index_update_count = dict(counts)
    trainer.optimizer.num_update = num_update
    if scaled is not None:
        scaler = trainer._amp_loss_scaler
        scaler.loss_scale, scaler._unskipped, trainer.skipped_steps = scaled


def _replay_with(step, args, seed, batch=B_TRAIN):
    """One step of the captured ``step`` whose seed words come from a
    generator seeded ``seed`` (as the eager triple's draws do)."""
    import torch
    step._generator = torch.Generator().manual_seed(seed)
    return step(*args, batch_size=batch)


def _eager_vs_fused(mod, trainer, args, run_fused=None, what="fused",
                    ulp=EAGER_FUSED_ULP, batch=B_TRAIN):
    """One eager record/backward/Trainer.step step and one FusedTrainStep
    step from the same weights, optimizer state and dropout seeds: a new
    step's first (eager) call, or ``run_fused()`` (a replay of a captured
    one).  The eager Trainer hands the update an f32 gradient, the fused
    step one cast back to bf16 (the reference's rounding points), so
    Adam's step differs by that rounding only and a bf16 weight by at
    most one ulp (|diff| <= 2^-7 |w|): ``ulp``.  With a loss scaler on
    the trainer (amp), the eager backward runs through
    ``amp.scale_loss``, as the fused step scales its seed."""
    import torch
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon import FusedTrainStep

    snap = _snapshot(mod, trainer)
    with autograd.record(generator=torch.Generator().manual_seed(77)):
        loss_e = mod(*args)
    with amp.scale_loss(loss_e, trainer) as scaled:
        autograd.backward(scaled)
    # loss_e keeps its autograd graph, and with it the parameters'
    # gradient accumulators, alive across a capture in run_fused
    trainer.step(batch)
    amp.unscale(trainer)
    eager = {k: p.data().detach().clone()
             for k, p in mod.collect_params().items()}
    _restore(mod, trainer, snap)
    if run_fused is None:
        step = FusedTrainStep(mod, trainer,
                              generator=torch.Generator().manual_seed(77))
        loss_f = step(*args, batch_size=batch)
    else:
        loss_f = run_fused()
    worst, n_diff, n_all = 0.0, 0, 0
    for k, p in mod.collect_params().items():
        w_f, w_e = p.data().detach().float(), eager[k].float()
        diff = (w_e - w_f).abs()
        worst = max(worst, (diff / (ulp * w_f.abs() + 1e-30)).max().item())
        n_diff += int((diff != 0).sum())
        n_all += diff.numel()
    out = {"loss_eager": loss_e.item(), "loss_fused": loss_f.item(),
           "worst_diff_over_one_ulp": worst, "elements_differing": n_diff,
           "elements": n_all}
    log(f"train: eager vs {what} step: " + json.dumps(out))
    if worst > 1.0 or out["loss_eager"] != out["loss_fused"]:
        raise SystemExit(f"eager and {what} training steps disagree")
    return out


def _fresh_draws(mod, trainer, args, step):
    """Two consecutive replays from the same weights and state: each
    writes its own seed words into the graph's buffer, and the losses
    (other dropout masks) differ."""
    entry, = step._graphs.values()
    n_seed = 2 * len(entry.kinds)
    snap = _snapshot(mod, trainer)
    losses, words = [], []
    for _ in range(2):
        losses.append(step(*args, batch_size=B_TRAIN).item())
        words.append(entry.buf[:n_seed].clone())
        _restore(mod, trainer, snap)
    import torch
    out = {"draw_sites": len(entry.kinds), "losses": losses,
           "words_differ": not torch.equal(words[0], words[1]),
           "losses_differ": losses[0] != losses[1]}
    log("train: two consecutive replays: " + json.dumps(out))
    if not (out["words_differ"] and out["losses_differ"]):
        raise SystemExit("consecutive replays drew the same dropout bits")
    return out


def _rebound_replay(mod, trainer, args, step):
    """Every parameter bound to a new tensor (``set_data`` of a copy):
    the next call captures the step again, while the eager step's loss
    holds its autograd graph over the new tensors, and its replay equals
    the eager step on them."""
    for p in mod.collect_params().values():
        p.set_data(p.data().detach().clone())
    before = step.captures
    out = _eager_vs_fused(mod, trainer, args,
                          lambda: _replay_with(step, args, 77),
                          what="re-captured")
    out["captures"] = [before, step.captures]
    if step.captures != before + 1:
        raise SystemExit("set_data did not re-capture the step")
    return out


def _eager_steps(mod, trainer, args, batch, n_warm, n_steps, counts,
                 generator=None):
    """The eager path, ``record``/``backward``/``Trainer.step``:
    ``n_steps`` steps after ``n_warm``.  Returns one such step as a
    function, wall ms a step and the launches of each kernel a step
    (``counts()`` before and after each)."""
    import torch
    from mxnet_tpu_torch import autograd

    def one():
        with autograd.record(generator=generator):
            loss = mod(*args)
        autograd.backward(loss)
        trainer.step(batch)
        return loss.detach()

    for _ in range(n_warm):
        one()
    torch.cuda.synchronize()
    per_step = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = counts()
        one()
        after = counts()
        per_step.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    return one, ms, per_step


def _flash_vs_dense_grads(dev, args):
    """Gradients of one backward with flash attention and with dense
    attention, BERT-base width, 2 layers, f32, dropout 0: relative L2 per
    parameter.  The attention key biases are left out: softmax ignores a
    per-row constant, so their gradient is rounding noise on both paths
    (its norm is printed)."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models import BertForPretraining

    net = BertForPretraining(**dict(TRAIN_CFG, num_layers=2, dropout=0.0)
                             ).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(2))
    mod = pretrain_loss(net)
    grads = []
    for flash in (True, False):
        for blk in net.modules():
            if hasattr(blk, "_use_flash"):
                blk._use_flash = flash
        with autograd.record():
            loss = mod(*args)
        loss.backward()
        grads.append({k: p.grad().clone()
                      for k, p in mod.collect_params().items()})
    worst, worst_name, noise = 0.0, None, 0.0
    for k, g_flash in grads[0].items():
        g_dense = grads[1][k]
        if k.endswith("attention.key.bias"):
            noise = max(noise, g_flash.norm().item(), g_dense.norm().item())
            continue
        err = rel_err(g_flash, g_dense)
        if err > worst:
            worst, worst_name = err, k
    out = {"worst_rel_l2": worst, "worst_param": worst_name,
           "tol": GRAD_REL_TOL, "key_bias_grad_norm": noise}
    log("train: flash vs dense gradients: " + json.dumps(out))
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("flash and dense gradients disagree")
    return out


def phase_train(dev):
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.models import BertForPretraining
    from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD

    net = BertForPretraining(**TRAIN_CFG).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    mod = pretrain_loss(net)
    args = train_batch(dev, TRAIN_CFG["vocab_size"])
    trainer = Trainer(mod.collect_params(), "adam", {"learning_rate": 1e-4})
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(1))
    losses = [step(*args, batch_size=B_TRAIN) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()

    per_step, dropouts = [], []
    _reset_counts()                          # count only the main path
    DROPOUT.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = _launch_counts()
        d0 = DROPOUT.launches
        losses.append(step(*args, batch_size=B_TRAIN))
        after = _launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        dropouts.append(DROPOUT.launches - d0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = dict(_launch_counts(), dropout=DROPOUT.launches)
    n_layers = TRAIN_CFG["num_layers"]
    loss_vals = torch.stack(losses).float().cpu().tolist()
    measured = loss_vals[TRAIN_WARMUP:]
    falling = sum(measured[-5:]) / 5 < measured[0]
    finite = all(x == x and abs(x) != float("inf") for x in loss_vals)
    # dropout: the embeddings' and two a layer, forward and backward
    drop_ok = all(n == 2 * (2 * n_layers + 1) for n in dropouts)
    counts_ok = all(c == n_layers for s in per_step
                    for c in s.values()) and drop_ok
    step_ms = wall / TRAIN_STEPS * 1e3
    # the main path's launches, measured: TRACED_STEPS more replays
    # traced, from wrapper counts of 0 (the bookkeeping, a cross-check)
    _reset_bert_counts()
    _, traced = traced_launches(lambda: [step(*args, batch_size=B_TRAIN)
                                         for _ in range(TRACED_STEPS)],
                                _reset_bert_counts)
    booked = dict(_launch_counts(), dropout=DROPOUT.launches,
                  dropout_bwd=DROPOUT_BWD.launches)
    traced = {k: traced[k] for k in booked}
    expect = {k: TRACED_STEPS * n_layers for k in booked}
    # both kernels: the forward and the backward of each dropout
    expect["dropout"] = TRACED_STEPS * 2 * (2 * n_layers + 1)
    expect["dropout_bwd"] = TRACED_STEPS * (2 * n_layers + 1)
    traced_ok = traced == expect and booked == expect
    log(f"train: {TRACED_STEPS} replayed steps traced: launches on the card "
        f"{json.dumps(traced)}, by the wrappers {json.dumps(booked)}, "
        f"expected {json.dumps(expect)}")
    out = {"model": "BertForPretraining (bert_base width)", "dtype":
           "bfloat16", "batch": [B_TRAIN, T_TRAIN], "steps": TRAIN_STEPS,
           "warmup_steps": TRAIN_WARMUP, "step_ms": step_ms,
           "tokens_per_s": B_TRAIN * T_TRAIN * TRAIN_STEPS / wall,
           "valid_occupancy": float(args[3].float().mean().item()),
           "loss_first": measured[0], "loss_last5_mean":
           sum(measured[-5:]) / 5, "losses": measured,
           "launches_booked": totals, "launches_per_step_ok": counts_ok,
           "traced_steps": TRACED_STEPS, "launches": traced,
           "launches_booked_traced": booked,
           "launches_traced_ok": traced_ok,
           "captures": step.captures, "ring_waits": sum(
               e.ring.waits for e in step._graphs.values()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": nvidia_smi()}
    eager_step, eager_ms, eager_counts = _eager_steps(
        mod, trainer, args, B_TRAIN, 2, 8, _launch_counts,
        torch.Generator().manual_seed(3))
    out["eager_step_ms"] = eager_ms
    out["eager_launches_per_step_ok"] = all(
        c == n_layers for s in eager_counts for c in s.values())
    log("train: " + json.dumps(out))
    if not (finite and falling and counts_ok and traced_ok and
            step.captures == 1 and out["eager_launches_per_step_ok"]):
        raise SystemExit(f"training failed: finite={finite} "
                         f"falling={falling} launches per step ok="
                         f"{counts_ok} traced launches ok={traced_ok} "
                         f"captures={step.captures}")
    out["eager_vs_fused"] = _eager_vs_fused(mod, trainer, args)
    out["eager_vs_replay"] = _eager_vs_fused(
        mod, trainer, args, lambda: _replay_with(step, args, 77),
        what="replayed")
    out["fresh_draws"] = _fresh_draws(mod, trainer, args, step)
    named = {tag: KERNEL_NAMES[k] for tag, k in (
        ("B3 flash_fwd", "flash_attention_fwd"),
        ("B4 flash_bwd_dq", "flash_attention_bwd_dq"),
        ("B5 flash_bwd_dkv", "flash_attention_bwd_dkv"),
        ("dropout", "dropout"))}
    out["profile"] = phase_train_profile(
        lambda: step(*args, batch_size=B_TRAIN),
        f"replayed training step at ({B_TRAIN}, {T_TRAIN})", named=named)
    out["eager_profile"] = phase_train_profile(
        eager_step, f"eager training step at ({B_TRAIN}, {T_TRAIN})",
        named=named)
    out["rebound"] = _rebound_replay(mod, trainer, args, step)
    del step, eager_step, trainer, mod, net
    torch.cuda.empty_cache()
    out["flash_vs_dense"] = _flash_vs_dense_grads(dev, args)
    return out


# ---------------------------------------------------------------------------
# phase 3e: BERT-base pretraining in mixed precision (amp float16, remat)
# ---------------------------------------------------------------------------
def _amp_grads(mod, trainer, args, seed):
    """One eager forward and loss-scaled backward: the loss, the true
    (unscaled) gradients, and the peak memory above what was allocated
    before, in GB; the stored gradients are cleared after."""
    import torch
    from mxnet_tpu_torch import amp, autograd
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with autograd.record(generator=torch.Generator().manual_seed(seed)):
        loss = mod(*args)
    scale = trainer._amp_loss_scaler.loss_scale
    with amp.scale_loss(loss, trainer) as scaled:
        autograd.backward(scaled)
    amp.unscale(trainer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    grads = {k: p.grad() / scale for k, p in mod.collect_params().items()
             if p.grad_req != "null"}
    mod.zero_grad()
    return loss.item(), grads, {"peak_gb": peak / 1e9,
                                "above_start_gb": (peak - base) / 1e9}


def _remat_memory_and_grads(net, mod, trainer, dev):
    """Peak memory of one eager step's forward and backward with and
    without remat at `AMP_MEM_SHAPES`, and, at the training shape, the
    gradients of the two from the same weights and seed words, and of a
    second plain step: both bitwise (a recompute runs the same kernels on
    the same inputs, and every backward sums in a fixed order); the worst
    difference against ``BWD_TOL["float16"]`` is printed beside them."""
    import torch
    atol, rtol = BWD_TOL["float16"]
    encoder = net.bert.encoder
    mem, grads = {}, {}
    for b, t in AMP_MEM_SHAPES:
        args = train_batch(dev, AMP_CFG["vocab_size"], seed=21, b=b, t=t)
        for remat in (True, False):
            encoder._remat = remat
            loss, g, m = _amp_grads(mod, trainer, args, seed=31)
            mem[f"({b}, {t}) remat={remat}"] = m
            if (b, t) == (B_TRAIN, T_TRAIN):
                grads[remat] = (loss, g)
            del g
        if (b, t) == (B_TRAIN, T_TRAIN):
            # the plain step again: are two plain runs bitwise equal?
            loss, g, _ = _amp_grads(mod, trainer, args, seed=31)
            differ = {k: int((g[k] != x).sum())
                      for k, x in grads[False][1].items()
                      if not torch.equal(g[k], x)}
            repeat = loss == grads[False][0] and not differ
            del g
        del args
        torch.cuda.empty_cache()
    encoder._remat = True
    (loss_r, g_r), (loss_p, g_p) = grads[True], grads[False]
    bitwise = loss_r == loss_p and all(
        torch.equal(g_r[k], g_p[k]) for k in g_r)
    worst, worst_name = 0.0, None
    for k, ref in g_p.items():
        diff = (g_r[k] - ref).abs()
        over = (diff / (atol * ref.abs().max() + rtol * ref.abs() + 1e-30)
                ).max().item()
        if over > worst:
            worst, worst_name = over, k
    out = {"loss_remat": loss_r, "loss_plain": loss_p, "bitwise": bitwise,
           "plain_repeat_bitwise": repeat,
           "plain_repeat_elements_differing": differ,
           "worst_over_tol": worst,
           "worst_param": worst_name,
           "tol": [atol, rtol], "memory": mem}
    log("train_amp: remat vs plain: " + json.dumps(out))
    # the embedding's backward sums in a fixed order, so a backward is
    # bitwise repeatable on the card, and a recompute runs the same
    # kernels on the same inputs: both must agree bitwise
    if not (repeat and bitwise):
        raise SystemExit(f"a plain backward again (bitwise: {repeat}, "
                         f"differing elements {differ}) or remat against "
                         f"plain (bitwise: {bitwise}, worst "
                         f"{worst:.3g} of the allowance) disagrees")
    return out


def _scale_trajectory_ok(traj):
    """Each step's scale (before it) and whether it overflowed, None
    where the scale was set by hand (the forced overflow): the scale
    halves after an overflow (never below 1) and otherwise stays or
    doubles."""
    for a, b in zip(traj, traj[1:]):
        if a is None or b is None:
            continue
        (s0, over), (s1, _) = a, b
        if (over and s1 != max(s0 / 2, 1.0)) or \
                (not over and s1 not in (s0, 2 * s0)):
            return False
    return all(x[0] >= 1.0 for x in traj if x is not None)


def _forced_overflow(mod, trainer, args, step, traj):
    """The scale set to `AMP_FORCED_SCALE`: the replay overflows, holds
    every weight and optimizer state bitwise, counts a skipped step and
    halves the scale; further replays back off until one trains (the
    weights move), and the next trains too."""
    import torch
    scaler = trainer._amp_loss_scaler
    before_scale = scaler.loss_scale
    scaler.loss_scale = AMP_FORCED_SCALE
    traj.append(None)
    rows, held = [], True
    for _ in range(AMP_MAX_BACKOFF + 2):
        snap = _snapshot(mod, trainer)
        scale, skipped = scaler.loss_scale, trainer.skipped_steps
        loss = step(*args, batch_size=B_TRAIN).item()
        over = trainer.skipped_steps == skipped + 1
        traj.append((scale, over))
        weights, states = snap[0], snap[1]
        same = all(torch.equal(p.data(), weights[k])
                   for k, p in mod.collect_params().items()) and all(
            torch.equal(x, y) for i, st in trainer._states.items()
            for x, y in zip(st, states[i]))
        rows.append({"scale": scale, "overflow": over, "loss": loss,
                     "held_bitwise": same})
        if over:
            held = held and same and scaler.loss_scale == scale / 2
        elif sum(not r["overflow"] for r in rows) == 2:
            break
    clean = [r for r in rows if not r["overflow"]]
    out = {"forced_scale": AMP_FORCED_SCALE, "scale_before": before_scale,
           "steps": rows, "overflows": len(rows) - len(clean),
           "ok": bool(rows[0]["overflow"] and held and len(clean) == 2 and
                      not any(r["held_bitwise"] for r in clean) and
                      all(r["loss"] == r["loss"] for r in clean))}
    log("train_amp: forced overflow: " + json.dumps(out))
    if not out["ok"]:
        raise SystemExit("the forced overflow was not held, or training "
                         "did not resume")
    return out


def _remat_cost(net, mod, trainer, args, step):
    """What remat's recompute costs a step: the replayed amp step with
    remat (``step``) against the same step captured without it, timed
    alternately (5 replays each, twice) and by device time."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep
    encoder = net.bert.encoder
    encoder._remat = False
    plain = FusedTrainStep(mod, trainer,
                           generator=torch.Generator().manual_seed(6))
    for _ in range(3):                  # eager, capture, replay
        plain(*args, batch_size=B_TRAIN)
    encoder._remat = True
    wall = {"remat": [], "plain": []}
    for _ in range(2):
        for name, s in (("remat", step), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                s(*args, batch_size=B_TRAIN)
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t0) / 5 * 1e3)
    dev_ms = {name: device_ms(lambda s=s: s(*args, batch_size=B_TRAIN),
                              iters=3)
              for name, s in (("remat", step), ("plain", plain))}
    out = {"step_ms": wall, "device_ms": dev_ms,
           "recompute_device_ms": dev_ms["remat"] - dev_ms["plain"]}
    log("train_amp: remat's cost: " + json.dumps(out))
    return out


def phase_train_amp(dev):
    """BERT-base pretraining as the tentpole runs it: 12 layers at full
    width, (32, 128), f32 parameters, ``amp.init("float16")`` and
    ``amp.init_trainer`` (a dynamic loss scaler from 2^16), LAMB under a
    linear-warmup PolyScheduler, ``remat=True``, through a captured
    FusedTrainStep.  Gates: remat against plain gradients; the replayed
    step against the eager triple (``record``/``scale_loss``/
    ``backward``/``Trainer.step``); launches a step from the trace (B3
    twice a layer: forward and recompute; B4 and B5 once; dropout twice
    a site and once more for each recomputed one); 1 host sync a
    replayed step with the scaler, 0 without; a forced overflow held
    bitwise with the scale halved, then training again; the scale's
    trajectory; a finite, falling loss.  amp's patches are undone at
    the end."""
    import torch
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.lr_scheduler import PolyScheduler
    from mxnet_tpu_torch.models import BertForPretraining
    from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD

    marks = [("start", time.perf_counter())]

    def mark(what):
        marks.append((what, time.perf_counter()))

    amp.init("float16")
    try:
        net = BertForPretraining(**AMP_CFG).initialize(
            ctx=dev, generator=torch.Generator().manual_seed(0))
        mod = pretrain_loss(net)
        args = train_batch(dev, AMP_CFG["vocab_size"])
        trainer = Trainer(mod.collect_params(), "lamb", {
            "learning_rate": AMP_SCHEDULE["base_lr"],
            "lr_scheduler": PolyScheduler(**AMP_SCHEDULE)})
        plain_step = FusedTrainStep(mod, trainer,
                                    generator=torch.Generator().manual_seed(4))
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        out = {"model": "BertForPretraining (bert_base width), remat",
               "amp": "float16", "params": "float32",
               "batch": [B_TRAIN, T_TRAIN], "optimizer": "lamb",
               "schedule": AMP_SCHEDULE}
        mark("model")
        out["remat_vs_plain"] = _remat_memory_and_grads(net, mod, trainer,
                                                        dev)
        mark("remat vs plain, memory")
        step = FusedTrainStep(mod, trainer,
                              generator=torch.Generator().manual_seed(1))
        traj, losses, lrs = [], [], []

        def one():
            scale, skipped = scaler.loss_scale, trainer.skipped_steps
            loss = step(*args, batch_size=B_TRAIN)
            traj.append((scale, trainer.skipped_steps != skipped))
            lrs.append(trainer.optimizer.learning_rate)
            return loss

        losses += [one() for _ in range(AMP_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [one() for _ in range(AMP_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = AMP_CFG["num_layers"]
        _reset_bert_counts()
        _, traced = traced_launches(lambda: [one()
                                             for _ in range(TRACED_STEPS)],
                                    _reset_bert_counts)
        booked = dict(_launch_counts(), dropout=DROPOUT.launches,
                      dropout_bwd=DROPOUT_BWD.launches)
        traced = {k: traced[k] for k in booked}
        per_step = {"flash_attention_fwd": 2 * n,
                    "flash_attention_bwd_dq": n,
                    "flash_attention_bwd_dkv": n,
                    # the embeddings' and two a layer, forward and
                    # backward, and each layer's two again in its recompute
                    # (a forward)
                    "dropout": 2 * (2 * n + 1) + 2 * n,
                    "dropout_bwd": 2 * n + 1}
        expect = {k: TRACED_STEPS * v for k, v in per_step.items()}
        launches_ok = traced == expect and booked == expect
        log(f"train_amp: {TRACED_STEPS} replayed steps traced: launches on "
            f"the card {json.dumps(traced)}, by the wrappers "
            f"{json.dumps(booked)}, expected {json.dumps(expect)}")
        seen, _ = _count_syncs(lambda: torch.ones(1, device=dev).item())
        syncs, examples = _count_syncs(one)
        out["profile"] = phase_train_profile(
            one, f"replayed amp + remat step at ({B_TRAIN}, {T_TRAIN})",
            named={tag: KERNEL_NAMES[k] for tag, k in (
                ("B3 flash_fwd", "flash_attention_fwd"),
                ("B4 flash_bwd_dq", "flash_attention_bwd_dq"),
                ("B5 flash_bwd_dkv", "flash_attention_bwd_dkv"),
                ("dropout", "dropout"))})
        mark("replayed steps, trace, profile")
        gen_e = torch.Generator().manual_seed(3)

        def eager_one():
            with autograd.record(generator=gen_e):
                loss = mod(*args)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
            trainer.step(B_TRAIN)
            amp.unscale(trainer)
            return loss.detach()

        eager_one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eager_one()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / 3 * 1e3
        out["eager_vs_replay"] = _eager_vs_fused(
            mod, trainer, args, lambda: _replay_with(step, args, 77),
            what="amp replayed", ulp=AMP_ULP)
        mark("eager steps, eager vs replay")
        step._generator = torch.Generator().manual_seed(5)
        out["forced_overflow"] = _forced_overflow(mod, trainer, args, step,
                                                  traj)
        losses.append(one())
        mark("forced overflow")
        plain_syncs, _ = _count_syncs(
            lambda: plain_step(*args, batch_size=B_TRAIN))
        plain_syncs = [plain_syncs] + [
            _count_syncs(lambda: plain_step(*args, batch_size=B_TRAIN))[0]
            for _ in range(2)]
        mark("step without a scaler")
        out["remat_cost"] = _remat_cost(net, mod, trainer, args, step)
        mark("remat's cost")
        loss_vals = [x.item() for x in losses]
        measured = loss_vals[AMP_WARMUP:AMP_WARMUP + AMP_STEPS]
        finite = all(x == x and abs(x) != float("inf") for x in loss_vals)
        falling = sum(measured[-5:]) / 5 < measured[0]
        trajectory_ok = _scale_trajectory_ok(traj)
        syncs_ok = seen >= 1 and syncs == 1 and plain_syncs[-1] == 0
        out.update({
            "steps": AMP_STEPS, "warmup_steps": AMP_WARMUP,
            "step_ms": wall / AMP_STEPS * 1e3,
            "tokens_per_s": B_TRAIN * T_TRAIN * AMP_STEPS / wall,
            "eager_step_ms": eager_ms,
            "loss_first": measured[0],
            "loss_last5_mean": sum(measured[-5:]) / 5, "losses": measured,
            "lrs": lrs[:AMP_WARMUP + AMP_STEPS],
            "scale_trajectory": [x and x[0] for x in traj],
            "overflowed_steps": [i for i, x in enumerate(traj)
                                 if x and x[1]],
            "scale_trajectory_ok": trajectory_ok,
            "skipped_steps": trainer.skipped_steps,
            "traced_steps": TRACED_STEPS, "launches": traced,
            "launches_booked_traced": booked,
            "launches_per_step_expected": per_step,
            "launches_ok": launches_ok,
            "host_syncs_replayed_step": syncs, "sync_examples": examples,
            "host_syncs_without_scaler": plain_syncs,
            "captures": step.captures, "card": nvidia_smi(),
            "seconds": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}})
        log("train_amp: " + json.dumps(out))
        if not (finite and falling and launches_ok and syncs_ok and
                trajectory_ok and step.captures == 1):
            raise SystemExit(
                f"amp training failed: finite={finite} falling={falling} "
                f"launches ok={launches_ok} syncs={syncs} (without a "
                f"scaler {plain_syncs}) trajectory ok={trajectory_ok} "
                f"captures={step.captures}")
        del step, plain_step, trainer, mod, net
        torch.cuda.empty_cache()
        return out
    finally:
        amp._reset()


def _dense_attention(q, k, v):
    """The model's dense attention (`MultiHeadAttention`'s use_flash=False
    path, no mask) on (B, H, T, D): scores, softmax, weighted sum."""
    import math

    import torch
    from mxnet_tpu_torch import npx
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(npx.softmax(scores, axis=-1), v)


def phase_flash_crossover(dev):
    """Flash (B3; B4 and B5 in the backward) against the model's dense
    attention at (8, 12, T, 64) bf16, no mask, for each T of
    `CROSSOVER_T`: device ms of the forward alone and of forward plus
    backward (``autograd.grad`` of a cotangent).  Measured, not acted
    on: the auto policy keeps the reference's crossovers."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(8)
    rows = []
    for t in CROSSOVER_T:
        q, k, v, dout = (torch.randn(B, H, t, D, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        row = {"shape": [B, H, t, D]}
        for name, fn in (("flash", fa.flash_attention),
                         ("dense", _dense_attention)):
            with torch.no_grad():
                row[f"{name}_fwd_ms"] = _device_ms_kept(
                    lambda: fn(q, k, v))
            qg, kg, vg = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))

            def fwd_bwd():
                return torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg),
                                           dout)

            row[f"{name}_fwd_bwd_ms"] = _device_ms_kept(fwd_bwd)
            del qg, kg, vg
        rows.append(row)
        log("flash_crossover: " + json.dumps(row))
        del q, k, v, dout
    torch.cuda.empty_cache()
    return rows, phase_flash_crossover_masked(dev)


def _dense_masked(q, k, v, mask, p):
    """The model's dense attention (`MultiHeadAttention`, use_flash=False)
    with a (B, T) key-padding mask and, at ``p`` > 0, its attention
    dropout (the port's dropout kernel, seeds from the scope)."""
    import math

    import torch
    from mxnet_tpu_torch import npx
    b, _h, t, d = q.shape
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    scores = scores.masked_fill(mask.reshape(b, 1, 1, t) == 0,
                                torch.tensor(-1e9).to(scores.dtype))
    attn = npx.softmax(scores, axis=-1)
    if p:
        attn = npx.dropout(attn, p=p)
    return torch.matmul(attn, v)


def _device_ms_kept(fn):
    """`device_ms` of ``fn``, taken again where the trace lost every
    kernel record (it reads 0.0: seen on an H100 in this phase), at most
    twice more; a third loss fails."""
    for _ in range(3):
        ms = device_ms(fn)
        if ms > 0:
            return ms
    raise SystemExit("the profiler lost every kernel of a crossover "
                     "timing three times")


def _crossover_from(rows, key):
    """The smallest T of the grid from which flash's ``key`` time is
    below dense's at every head dim, for that T and every larger one;
    None where flash loses at the largest."""
    by_t = {}
    for r in rows:
        by_t.setdefault(r["shape"][2], []).append(
            r[f"flash_{key}"] < r[f"dense_{key}"])
    wins = [t for t in sorted(by_t) if all(by_t[t])]
    best = None
    for t in sorted(by_t, reverse=True):
        if t not in wins:
            break
        best = t
    return best


def phase_flash_crossover_masked(dev):
    """Flash against the model's dense attention as the auto policy sees
    BERT's: a (B, T) key-padding mask with `CROSSOVER_VALID` of the keys
    valid, at each (B, heads, D) of `CROSSOVER_MASKED` and each T of
    `CROSSOVER_T`; the forward in predict mode, forward plus backward in
    train mode with attention dropout `CROSSOVER_DROPOUT`.  Prints the
    smallest T from which flash wins at both head dims beside the
    policy's constants."""
    import torch
    from mxnet_tpu_torch import autograd, npx
    from mxnet_tpu_torch.models import transformer as tr

    gen = torch.Generator().manual_seed(9)
    rows = []
    for b, h, d in CROSSOVER_MASKED:
        for t in CROSSOVER_T:
            q, k, v, dout = (torch.randn(b, h, t, d, generator=gen).to(
                dev, torch.bfloat16) for _ in range(4))
            mask = torch.zeros(b, t, dtype=torch.int32)
            mask[:, :int(t * CROSSOVER_VALID)] = 1
            mask = mask.to(dev)
            row = {"shape": [b, h, t, d], "valid": CROSSOVER_VALID,
                   "dropout_training": CROSSOVER_DROPOUT}
            for name, fn in (
                    ("flash", lambda q, k, v, p: npx.flash_attention(
                        q, k, v, mask=mask, dropout=p)),
                    ("dense", lambda q, k, v, p: _dense_masked(
                        q, k, v, mask, p))):
                with torch.no_grad():
                    row[f"{name}_fwd_ms"] = _device_ms_kept(
                        lambda: fn(q, k, v, 0.0))
                qg, kg, vg = (x.detach().clone().requires_grad_()
                              for x in (q, k, v))
                seeds = torch.Generator().manual_seed(10)

                def fwd_bwd():
                    with autograd.train_mode(generator=seeds):
                        out = fn(qg, kg, vg, CROSSOVER_DROPOUT)
                    return torch.autograd.grad(out, (qg, kg, vg), dout)

                row[f"{name}_fwd_bwd_ms"] = _device_ms_kept(fwd_bwd)
                del qg, kg, vg
            rows.append(row)
            log("flash_crossover_masked: " + json.dumps(row))
            del q, k, v, dout
        torch.cuda.empty_cache()
    policy = {"fwd_from_t": _crossover_from(rows, "fwd_ms"),
              "fwd_bwd_from_t": _crossover_from(rows, "fwd_bwd_ms"),
              "FLASH_AUTO_MIN_T": tr.FLASH_AUTO_MIN_T,
              "FLASH_AUTO_MIN_T_TRAINING": tr.FLASH_AUTO_MIN_T_TRAINING,
              "card": nvidia_smi()}
    log("flash_crossover_policy: " + json.dumps(policy))
    return {"rows": rows, "policy": policy}


def phase_odd_berts(dev):
    """BERT at full width with head_dim 96 (units 768, 8 heads) in bf16
    and BERT-base in f16, use_flash=True, cut to 2 layers: one forward
    and one eager training step (Adam) each, on the training batch.
    Every output, loss and updated weight finite; B3, B4 and B5 launched
    once a layer."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.models import BertForPretraining

    args = train_batch(dev, TRAIN_CFG["vocab_size"])
    out = {}
    for name, overrides, dtype in ODD_BERTS:
        cfg = dict(TRAIN_CFG, num_layers=2, **overrides)
        net = BertForPretraining(**cfg).initialize(
            ctx=dev, generator=torch.Generator().manual_seed(5))
        net.cast(dtype)
        mod = pretrain_loss(net)
        trainer = Trainer(mod.collect_params(), "adam",
                          {"learning_rate": 1e-4})
        _reset_counts()
        with torch.no_grad():
            mlm, nsp = net(args[0], args[1], args[3])
        fwd_ok = bool(torch.isfinite(mlm).all() and torch.isfinite(nsp).all())
        fwd_counts = _launch_counts()
        _reset_counts()
        with autograd.record(generator=torch.Generator().manual_seed(6)):
            loss = mod(*args)
        loss.backward()
        trainer.step(B_TRAIN)
        torch.cuda.synchronize()
        step_counts = _launch_counts()
        weights_ok = all(bool(torch.isfinite(p.data()).all())
                         for p in mod.collect_params().values())
        n = cfg["num_layers"]
        counts_ok = (fwd_counts == {"flash_attention_fwd": n,
                                    "flash_attention_bwd_dq": 0,
                                    "flash_attention_bwd_dkv": 0} and
                     all(c == n for c in step_counts.values()))
        out[name] = {"units": cfg["units"], "num_heads": cfg["num_heads"],
                     "head_dim": cfg["units"] // cfg["num_heads"],
                     "dtype": dtype, "layers": n,
                     "forward_finite": fwd_ok, "loss": loss.item(),
                     "weights_finite": weights_ok,
                     "launches_forward": fwd_counts,
                     "launches_step": step_counts, "ok": (
                         fwd_ok and weights_ok and counts_ok and
                         loss.item() == loss.item() and
                         abs(loss.item()) != float("inf"))}
        log(f"odd_bert: {name}: " + json.dumps(out[name]))
        del net, mod, trainer, mlm, nsp, loss
        torch.cuda.empty_cache()
    failed = [k for k, r in out.items() if not r["ok"]]
    if failed:
        raise SystemExit(f"BERT with use_flash=True failed on the card: "
                         f"{failed}")
    return out


# ---------------------------------------------------------------------------
# phase 4b: where one training step's time goes
# ---------------------------------------------------------------------------
def _count_syncs(fn):
    """Device-to-host synchronisations torch reports during ``fn()``
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # each synchronizing call warns "called a synchronizing CUDA
    # operation"; the mode's own notice that it is a prototype does not
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs), syncs[:3]


def phase_train_profile(one, label, named=None):
    """``one()``, a training step, traced: syncs, wall ms back to back,
    and `profile_call`'s breakdown."""
    import torch

    # the count is only as good as the debug mode's coverage: check that
    # it sees a known sync (a scalar read) before trusting a zero
    seen, _ = _count_syncs(lambda: torch.ones(1, device="cuda").item())
    n_syncs, examples = _count_syncs(one)
    if seen < 1:
        n_syncs = "not measured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    out = profile_call(one, label, step_ms, named)
    out["host_syncs_per_step"] = n_syncs
    log(f"profile: {label}: {n_syncs} device-to-host syncs {examples}; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


# ---------------------------------------------------------------------------
# phase 3f: the operations layer on BERT-base's training step
# ---------------------------------------------------------------------------
def _ops_build(dev):
    """BERT-base pretraining as in `phase_train`, its step's draws from
    ``mx.random``'s default generator."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.models import BertForPretraining

    net = BertForPretraining(**TRAIN_CFG).initialize(
        ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    mod = pretrain_loss(net)
    trainer = Trainer(mod.collect_params(), "adam", {"learning_rate": 1e-4})
    return mod, trainer, FusedTrainStep(mod, trainer)


def _ops_bits(arrays):
    """name -> bytes of a gathered training state (bf16 tensors through
    an int16 view)."""
    import torch
    return {k: (a.view(torch.int16).numpy() if isinstance(a, torch.Tensor)
                else a).tobytes() for k, a in arrays.items()}


def _ops_device_state(trainer):
    import torch
    return [p.data().detach().clone() for p in trainer._params] + \
        [s.clone() for i in sorted(trainer._states)
         for s in trainer._states[i]]


def _ops_metric(name, labels=None):
    from mxnet_tpu_torch import telemetry
    v = telemetry.default_registry().get_sample_value(name, labels)
    return 0.0 if v is None else v


OPS_COUNTERS = {
    "recovered": ("mxtpu_faults_recovered_total",
                  {"site": "train.grads", "kind": "nan_grad"}),
    "skipped": ("mxtpu_train_steps_skipped_total", None),
    "steps": ("mxtpu_trainer_steps_total", None),
    "fused_step_phases": ("mxtpu_trainer_step_phase_seconds_count",
                          {"phase": "fused-step"}),
    "save_seconds_sum": ("mxtpu_checkpoint_save_seconds_sum", None),
    "save_seconds_count": ("mxtpu_checkpoint_save_seconds_count", None),
    "bytes": ("mxtpu_checkpoint_bytes_total", None),
}


def _ops_counts():
    return {k: _ops_metric(*v) for k, v in OPS_COUNTERS.items()}


def _ops_run(dev, batches, root, plan, first=1, state=None):
    """Steps ``first`` .. OPS_STEPS of a fresh net under ``plan``, a
    checkpoint every OPS_SAVE_EVERY steps into ``root``; ``state`` (a
    restored checkpoint's arrays and meta) is put into the fresh trainer
    first.  Returns what the gates read; a preemption ends the run where
    it strikes, with ``preempted_at`` set."""
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import (CheckpointManager, faultline,
                                            gather_training_state,
                                            restore_training_state)

    mod, trainer, step = _ops_build(dev)
    out = {"saves_host_ms": [], "save_syncs": [], "replay_syncs": None,
           "restore_ms": None, "preempted_at": None, "nan_step_held": None}
    if state is not None:
        mod._ensure_shapes(*batches[0])
        t0 = time.perf_counter()
        restored = restore_training_state(*state, trainer)
        torch.cuda.synchronize()
        out["restore_copy_ms"] = (time.perf_counter() - t0) * 1e3
        if restored != first - 1:
            raise SystemExit(f"ops: restored step {restored}, expected "
                             f"{first - 1}")
    faultline.plan(plan)
    mgr = CheckpointManager(root, keep=2, async_write=True)
    name = f"FusedTrainStep[{type(mod).__name__}]"
    retraces0 = telemetry.watchdog().retrace_count(name)
    before = _ops_counts()
    losses, taken = [], 0
    for t in range(first, OPS_STEPS + 1):
        args = batches[t - 1]
        held = _ops_device_state(trainer) if t == OPS_NAN_AT else None
        try:
            if t == OPS_SAVE_EVERY + OPS_SAVE_EVERY // 2:
                out["replay_syncs"], _ = _count_syncs(lambda: losses.append(
                    step(*args, batch_size=B_TRAIN)))
            else:
                losses.append(step(*args, batch_size=B_TRAIN))
        except faultline.InjectedPreemption:
            out["preempted_at"] = t
            break
        taken += 1
        if held is not None:
            now = _ops_device_state(trainer)
            out["nan_step_held"] = all(torch.equal(a, b)
                                       for a, b in zip(held, now)) and \
                not bool(step.last_step_finite)
            del held, now
        if t % OPS_SAVE_EVERY == 0:
            box = {}

            def save():
                box["state"] = gather_training_state(trainer, t)
                mgr.save(t, *box["state"])

            t0 = time.perf_counter()
            n, _ = _count_syncs(save)
            out["saves_host_ms"].append((time.perf_counter() - t0) * 1e3)
            out["save_syncs"].append(n)
            out["final"] = box["state"]
    mgr.close()
    faultline.clear()
    after = _ops_counts()
    out.update(
        mod=mod, trainer=trainer, step=step, taken=taken, losses=losses,
        counts={k: after[k] - before[k] for k in after},
        captures=step.captures,
        retraces=telemetry.watchdog().retrace_count(name) - retraces0)
    return out


def _ops_trace(step, args, dev):
    """Three replays under ``profiler.set_state("run")``: the dumped
    chrome trace's ``step/fused-step`` spans and kernels of
    `KERNEL_NAMES`, beside the wrappers' counts of the same replays."""
    import os
    import tempfile

    import torch
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD

    fd, path = tempfile.mkstemp(suffix=".json", prefix="ops-trace-")
    os.close(fd)
    profiler.set_config(filename=path)
    try:
        for attempt in range(2):
            _reset_bert_counts()
            torch.cuda.synchronize()
            profiler.set_state("run")
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(TRACE_PAD_CYCLES)
            torch.cuda.synchronize()
            for _ in range(TRACED_STEPS + 1):
                step(*args, batch_size=B_TRAIN)
            profiler.dump()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            if any(re.search(TRACE_PAD_NAME, k) for k in kernels):
                break
            log("ops: the profiler lost every spin kernel; tracing again")
        else:
            raise SystemExit("ops: the profiler lost every spin kernel twice")
    finally:
        profiler.set_config(filename="profile.json")
        os.remove(path)
    names = {k: KERNEL_NAMES[k] for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "dropout", "dropout_bwd")}
    traced = {k: sum(1 for n in kernels if re.search(pat, n))
              for k, pat in names.items()}
    booked = dict(_launch_counts(), dropout=DROPOUT.launches,
                  dropout_bwd=DROPOUT_BWD.launches)
    spans = sum(1 for e in events if e.get("name") == "step/fused-step"
                and e.get("ph") == "X")
    return {"spans": spans, "traced": traced, "booked": booked,
            "kernel_events": len(kernels)}


def _ops_hooks_us(step, n=OPS_HOOK_CALLS):
    """Host us of the operations hooks one `FusedTrainStep` call runs
    (the faultline poll, `mark_step`, the ``fused-step`` phase around
    nothing, the watchdog's observe), ``n`` times in a loop, with
    telemetry on and off in turns: what telemetry costs the host a
    step, which a replay's wait for the card hides from its step ms."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import faultline

    wd, name = telemetry.watchdog(), "FusedTrainStep[ops-hooks]"
    out = {"on": [], "off": []}
    try:
        for w in range(4):
            tag = "on" if w % 2 == 0 else "off"
            telemetry.set_enabled(tag == "on")
            t0 = time.perf_counter()
            for _ in range(n):
                faultline.poll("train.grads")
                telemetry.mark_step()
                with telemetry.step_phase("fused-step"):
                    pass
                wd.observe(step, name=name)
            out[tag].append((time.perf_counter() - t0) / n * 1e6)
    finally:
        telemetry.set_enabled(True)
    return out


def _ops_timing(step, batches):
    """Replayed step ms with telemetry on and off in turns
    (`OPS_TIMING_WINDOWS` windows of `OPS_WINDOW_STEPS` steps, synced at
    each window's ends), the host ms of each call (unsynced: it waits
    for the seed ring's buffers, so the card's pace), and
    `_ops_hooks_us`."""
    import torch
    from mxnet_tpu_torch import telemetry

    out = {"on": [], "off": [], "on_host": [], "off_host": [],
           "hooks_us": _ops_hooks_us(step)}
    try:
        for w in range(OPS_TIMING_WINDOWS):
            tag = "on" if w % 2 == 0 else "off"
            telemetry.set_enabled(tag == "on")
            torch.cuda.synchronize()
            host = 0.0
            t0 = time.perf_counter()
            for i in range(OPS_WINDOW_STEPS):
                h0 = time.perf_counter()
                step(*batches[i % len(batches)], batch_size=B_TRAIN)
                host += time.perf_counter() - h0
            torch.cuda.synchronize()
            out[tag].append((time.perf_counter() - t0) / OPS_WINDOW_STEPS
                            * 1e3)
            out[f"{tag}_host"].append(host / OPS_WINDOW_STEPS * 1e3)
    finally:
        telemetry.set_enabled(True)
    return out


def phase_ops(dev):
    """Phase 3f (see the module's docstring)."""
    import shutil
    import tempfile

    import torch
    from mxnet_tpu_torch import observe
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.ops import invoke
    from mxnet_tpu_torch.resilience import (CheckpointManager,
                                            DivergenceSentinel,
                                            gather_training_state)

    card = nvidia_smi()
    batches = [train_batch(dev, TRAIN_CFG["vocab_size"], seed=100 + t)
               for t in range(OPS_STEPS)]
    nan = {"site": "train.grads", "kind": "nan_grad", "at": OPS_NAN_AT}
    root = tempfile.mkdtemp(prefix="chip-smoke-ops-")
    observe.reset()
    observe.configure(root=root)
    try:
        _reset_bert_counts()                 # the main path's launches
        mxrandom.seed(OPS_SEED)
        oracle = _ops_run(dev, batches, f"{root}/oracle", [nan])
        launches = dict(_launch_counts())
        from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD
        launches.update(dropout=DROPOUT.launches,
                        dropout_bwd=DROPOUT_BWD.launches)
        want = _ops_bits(oracle["final"][0])
        want_meta = oracle["final"][1]
        # the gather alone, three times back to back with the writer idle
        # (pinned blocks of earlier saves freed and cached by torch)
        gather_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            gather_training_state(oracle["trainer"], OPS_STEPS)
            gather_ms.append((time.perf_counter() - t0) * 1e3)
        trace = _ops_trace(oracle["step"], batches[0], dev)
        timing = _ops_timing(oracle["step"], batches)
        oracle_losses = torch.stack(oracle["losses"]).float().cpu().tolist()
        del oracle["mod"], oracle["trainer"], oracle["step"], oracle["final"]
        torch.cuda.empty_cache()

        mxrandom.seed(OPS_SEED)
        first = _ops_run(dev, batches, f"{root}/faulted", [
            nan, {"site": "train.grads", "kind": "preempt",
                  "at": OPS_PREEMPT_AT}])
        del first["mod"], first["trainer"], first["step"]
        first.pop("final", None)
        torch.cuda.empty_cache()
        invoke.set_default_generator(None)   # a restarted process
        mxrandom.seed(OPS_SEED + 1000)
        t0 = time.perf_counter()
        latest = CheckpointManager(f"{root}/faulted").restore_latest()
        load_ms = (time.perf_counter() - t0) * 1e3
        resumed = _ops_run(dev, batches, f"{root}/faulted", [], latest[0] + 1,
                           state=latest[1:])
        got = _ops_bits(resumed["final"][0])
        got_meta = resumed["final"][1]
        del resumed["mod"], resumed["trainer"], resumed["step"]
        resumed.pop("final")
        torch.cuda.empty_cache()
        dump = observe.dump(reason="chip_smoke")
        with open(dump) as f:
            record = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differing = sorted(k for k in want if got.get(k) != want[k])
    sentinel = DivergenceSentinel()
    trips = [i + 1 for i, x in enumerate(oracle_losses) if sentinel.observe(x)]
    cats = sorted({e[4] for e in record["events"]})
    n_layers = TRAIN_CFG["num_layers"]
    per_step = {"flash_attention_fwd": n_layers,
                "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers,
                "dropout": 2 * (2 * n_layers + 1),
                "dropout_bwd": 2 * n_layers + 1}
    expect = {k: (TRACED_STEPS + 1) * n for k, n in per_step.items()}
    save_ms = [c["save_seconds_sum"] / max(1, c["save_seconds_count"]) * 1e3
               for c in (oracle["counts"], first["counts"],
                         resumed["counts"])]
    mb = oracle["counts"]["bytes"] / max(1, oracle["counts"][
        "save_seconds_count"]) / 2 ** 20
    gates = {
        "resume_bitwise": not differing and len(got) == len(want),
        "update_counts_equal": got_meta["opt_update_counts"] ==
        want_meta["opt_update_counts"] and
        got_meta["rng_counter"] == want_meta["rng_counter"],
        "preempted_at": first["preempted_at"] == OPS_PREEMPT_AT,
        "restored_step": latest[0] == 20,
        "nan_step_held": oracle["nan_step_held"] is True and
        first["nan_step_held"] is True,
        "recovered_and_skipped_once": all(
            r["counts"]["recovered"] == 1 and r["counts"]["skipped"] == 1
            for r in (oracle, first)) and
        resumed["counts"]["recovered"] == resumed["counts"]["skipped"] == 0,
        "steps_counted": all(
            r["counts"]["steps"] == r["counts"]["fused_step_phases"] ==
            r["taken"] for r in (oracle, first, resumed)) and
        oracle["taken"] == OPS_STEPS and
        first["taken"] + resumed["taken"] == OPS_PREEMPT_AT - 1 +
        OPS_STEPS - 20,
        "one_capture_no_retrace": all(
            r["captures"] == 1 and r["retraces"] == 0
            for r in (oracle, first, resumed)),
        "replay_no_sync": oracle["replay_syncs"] == 0 and
        first["replay_syncs"] == 0,
        "save_one_sync": all(n == 1 for r in (oracle, first, resumed)
                             for n in r["save_syncs"]),
        "trace_spans": trace["spans"] == TRACED_STEPS + 1,
        "trace_kernels": trace["traced"] == expect and
        trace["booked"] == expect,
        "main_path_launched": all(launches[k] > 0 for k in per_step),
        "flight_record": record["schema"] == observe.SCHEMA_VERSION and
        {"phase", "fault", "recovery", "checkpoint"} <= set(cats),
        "sentinel_quiet": not trips,
    }
    out = {
        "model": "BertForPretraining (bert_base width and depth)",
        "dtype": "bfloat16", "batch": [B_TRAIN, T_TRAIN], "steps": OPS_STEPS,
        "step_ms_telemetry_on": timing["on"],
        "step_ms_telemetry_off": timing["off"],
        "host_ms_per_call_on": timing["on_host"],
        "host_ms_per_call_off": timing["off_host"],
        "hooks_host_us_on": timing["hooks_us"]["on"],
        "hooks_host_us_off": timing["hooks_us"]["off"],
        "save_host_ms": oracle["saves_host_ms"] + first["saves_host_ms"] +
        resumed["saves_host_ms"],
        "save_syncs": oracle["save_syncs"] + first["save_syncs"] +
        resumed["save_syncs"],
        "gather_ms_writer_idle": gather_ms,
        "write_ms_mean": save_ms, "checkpoint_mb": mb,
        "restore_load_ms": load_ms,
        "restore_copy_ms": resumed["restore_copy_ms"],
        "replay_syncs": [oracle["replay_syncs"], first["replay_syncs"]],
        "launches": launches, "trace": trace, "trace_expected": expect,
        "counts": {"oracle": oracle["counts"], "faulted": first["counts"],
                   "resumed": resumed["counts"]},
        "flight_record": {"schema": record["schema"], "events": len(
            record["events"]), "categories": cats},
        "differing_arrays": differing[:5], "sentinel_trips": trips,
        "losses_first_last": [oracle_losses[0], oracle_losses[-1]],
        "gates": gates, "card": card}
    log("ops: " + json.dumps(out))
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"ops: gates failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 5: B1 (BatchNorm-backward reduction) vs plain
# ---------------------------------------------------------------------------
def _bn_allowance(n0, c, n1):
    """B1's allowance, per channel, as a multiple of sum|term|: f32
    summation with depth d errs by at most d * 2^-24 * sum|term|.  The
    (N0, C, N1) form's depth is ceil(chunk / 256) sequential adds per
    thread, 8 tree levels and ``splits`` sequential adds of the partials;
    the channel-minor form's ceil(chunk / rows a pass) in a thread, the
    rows a pass (256 / tw) in the block and N1 * ``splits`` at the end.
    The plain sum's blocked order is taken to be no deeper, so the two
    may differ by twice that."""
    from mxnet_tpu_torch.ops.nn import (BN_ROWS_BELOW, bn_bwd_reduce_plan,
                                        bn_bwd_reduce_rows_plan)
    if n1 < BN_ROWS_BELOW:
        _vec, tw, splits, chunk = bn_bwd_reduce_rows_plan(n0, c, n1)
        rows = 256 // tw
        depth = -(-chunk // rows) + rows + n1 * splits
    else:
        splits, chunk = bn_bwd_reduce_plan(n0, c, n1)
        depth = -(-chunk // 256) + 8 + splits
    return 2 * depth * EPS32


def _bn_case(dev, gen, shape, view, per_step, what, repeat):
    """One B1 case: inputs of ``shape`` on the card, read by the kernel
    as ``view`` (N0, C, N1); its error over the allowance, the form the
    wrapper took, times (CUDA events and device time), the plain
    version's time, the bound, and the library call's time
    (``torch.batch_norm_backward_reduce`` with mean 0 and invstd 1, whose
    ``sum_dy_xmu`` is then sum(dy * xhat), on the NCHW-shaped tensor:
    channels-last for an NHWC input); with ``repeat``, a second launch
    bitwise."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn

    n0, c, n1 = view
    dy4 = torch.randn(shape, generator=gen, device=dev)
    xh4 = torch.randn(shape, generator=gen, device=dev)
    dy, xh = dy4.view(view), xh4.view(view)
    before = (tnn.BN_BWD_REDUCE.launches, tnn.BN_BWD_REDUCE_ROWS.launches)
    s, ss = tnn.bn_bwd_reduce(dy, xh)
    torch.cuda.synchronize()
    form = "rows" if tnn.BN_BWD_REDUCE_ROWS.launches > before[1] else \
        "channel"
    ps, pss = tnn.bn_bwd_reduce_reference(dy, xh)
    frac = _bn_allowance(n0, c, n1)
    allow_s = frac * dy.abs().sum(dim=(0, 2)) + 1e-30
    allow_ss = frac * (dy * xh).abs().sum(dim=(0, 2)) + 1e-30
    err = max((s - ps).abs().max().item(), (ss - pss).abs().max().item())
    ratio = max(((s - ps).abs() / allow_s).max().item(),
                ((ss - pss).abs() / allow_ss).max().item())
    ok = ratio <= 1.0 and bool(torch.isfinite(s).all()) and \
        bool(torch.isfinite(ss).all())
    bitwise = None
    if repeat:
        s2, ss2 = tnn.bn_bwd_reduce(dy, xh)
        bitwise = bool(torch.equal(s, s2) and torch.equal(ss, ss2))
        ok = ok and bitwise
    lib_dy, lib_xh = (dy4.permute(0, 3, 1, 2), xh4.permute(0, 3, 1, 2)) \
        if len(shape) == 4 else (dy, xh)
    zeros = torch.zeros(c, device=dev)
    ones = torch.ones(c, device=dev)
    ms = cuda_ms(lambda: tnn.bn_bwd_reduce(dy, xh))
    dev_ms = device_ms(lambda: tnn.bn_bwd_reduce(dy, xh))
    plain_ms = cuda_ms(lambda: tnn.bn_bwd_reduce_reference(dy, xh), iters=5)
    library_ms = cuda_ms(lambda: torch.batch_norm_backward_reduce(
        lib_dy, lib_xh, zeros, ones, None, True, False, False))
    bound_ms, bound_by = _bound_ms(
        "float32", 2 * dy.numel() * 4 + 2 * c * 4, 2 * dy.numel())
    row = {"shape": list(shape), "view": list(view), "what": what,
           "form": form, "launches_per_step": per_step,
           "max_abs_err": err, "err_over_tol": ratio,
           "tol": f"{frac:.3e} x sum|term| per channel",
           "bitwise_repeat": bitwise, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok}
    rep = "" if bitwise is None else f" bitwise_repeat={bitwise}"
    log(f"kernel_bn {what} {tuple(shape)} as (N0, C, N1)={tuple(view)} "
        f"[{form}] x{per_step}/step err={err:.3e} ({ratio:.3f} of tol) "
        f"kernel_ms={ms:.4f} (device {dev_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}){rep} {'ok' if ok else 'FAILED'}")
    return row


def _bn_route_sweep(dev, gen):
    """Both forms of B1 on the same inputs, (N0, 256, N1) at about 100M
    elements for each N1 of `BN_ROUTE_N1`: where the channel-minor form
    stops being the faster (`ops.nn.BN_ROWS_BELOW`)."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    out = []
    for n1 in BN_ROUTE_N1:
        n0 = 100_000_000 // (256 * n1)
        dy = torch.randn(n0, 256, n1, generator=gen, device=dev)
        xh = torch.randn(n0, 256, n1, generator=gen, device=dev)
        row = {"n1": n1, "shape": [n0, 256, n1],
               "rows_ms": cuda_ms(lambda: tnn._bn_reduce_rows(dy, xh)),
               "channel_ms": cuda_ms(
                   lambda: tnn._bn_reduce_channels(dy, xh)),
               "bound_ms": _bound_ms("float32", 2 * dy.numel() * 4,
                                     2 * dy.numel())[0],
               "taken": "rows" if n1 < tnn.BN_ROWS_BELOW else "channel"}
        out.append(row)
        log("kernel_bn_route: " + json.dumps(row))
        del dy, xh
    torch.cuda.empty_cache()
    return out


def phase_bn_reduce(dev):
    """B1 against `bn_bwd_reduce_reference`: at ResNet-50's NCHW
    BatchNorm shapes and an odd one (the (N0, C, N1) form), at its NHWC
    shapes and an odd one (the channel-minor form), and at the zoo's
    N1 = 49 shapes, which stay on the (N0, C, N1) form; each case's
    worst error over its allowance, kernel time (CUDA events, and the
    two kernels' device time by the profiler), bound, plain version and
    the library call; the first case of each form twice, bitwise; then
    the two forms side by side across N1 (`_bn_route_sweep`)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(31)
    rows = [_bn_case(dev, gen, view, view, per_step, "resnet50_nchw",
                     i == 0)
            for i, (view, per_step) in enumerate(BN_CASES)]
    nhwc = [_bn_case(dev, gen, shape, (shape[0] * shape[1] * shape[2],
                                       shape[3], 1),
                     per_step, "resnet50_nhwc", i == 0)
            for i, (shape, per_step) in enumerate(BN_NHWC_CASES)]
    nhwc.append(_bn_case(dev, gen, BN_ODD_ROWS, BN_ODD_ROWS, 0, "odd_rows",
                         False))
    zoo = [_bn_case(dev, gen, view, view, None, what, False)
           for what, view in BN_ZOO_N1_CASES]
    torch.cuda.empty_cache()
    for label, group in (("NCHW", rows), ("NHWC", nhwc[:-1])):
        per_step = {k: sum(r[k] * r["launches_per_step"] for r in group)
                    for k in ("ms", "device_ms", "bound_ms", "library_ms")}
        log(f"kernel_bn per ResNet-50 ({label}) step ({BN_LAYERS} "
            "launches): " + json.dumps(per_step))
    route = _bn_route_sweep(dev, gen)
    failed = [r["shape"] for r in rows + nhwc + zoo if not r["ok"]]
    forms = [r["shape"] for r in nhwc if r["form"] != "rows"] + \
        [r["shape"] for r in rows[:-1] + zoo if r["form"] != "channel"]
    if failed:
        raise SystemExit(f"B1 disagrees with its plain version: {failed}")
    if forms:
        raise SystemExit(f"B1 took the other form at {forms}")
    return {"nchw": rows, "nhwc": nhwc, "zoo": zoo, "route": route}


# ---------------------------------------------------------------------------
# phase 6: B2 (space-to-depth stem matmul) vs plain
# ---------------------------------------------------------------------------
def phase_stem(dev):
    """B2 (`stem_conv_b2`, the packed stem conv without patches) against
    its plain version `stem_conv_b2_reference` (patches times the folded
    weight, f32) on the packed input; the first design (`stem_matmul`
    over the patches) against its own plain version, timed beside it; the
    packed stem (`stem_conv_auto`, through B2) against cuDNN's
    7x7/stride-2 conv of the unpacked input with the same weight.
    Allowances: f32 sums of K products err by at most K * 2^-24 * the
    sum of |products| (computed as |patches| @ |W|), for either side; in
    bf16 each side then rounds once to nearest, which moves a value v by
    at most half a bf16 ulp, 2^-8 |round(v)|: so the kernel and the plain
    version may differ by 2^-8 (|kernel| + |plain|) more, and the kernel
    and the unrounded f32 conv by 2^-8 |kernel|.  Times: the kernel by
    CUDA events and by device time, its plain version, cuDNN's conv of
    the packed input with the folded weight (the same function in one
    library call), and as context cuBLAS's product over prebuilt patches
    and cuDNN's 7x7 stem; the bound reads xs and the weight once and
    writes the output once."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import stem

    gen = torch.Generator(device=dev).manual_seed(41)
    rows = []
    for dname, (b, c, h2, w2), c_out in STEM_CASES:
        dt = getattr(torch, dname)
        x = (torch.rand(b, c // 4, 2 * h2, 2 * w2, generator=gen, device=dev)
             * 2 - 1).to(dt)
        w7 = (torch.randn(c_out, c // 4, 7, 7, generator=gen, device=dev)
              * 0.05).to(dt)
        xs = stem.space_to_depth2(x).contiguous()
        wf = stem.fold_stem_kernel(w7).contiguous()
        flat = stem.stem_patches(xs)
        w2d = wf.reshape(c_out, -1).t().contiguous()
        m, k = flat.shape
        out = stem.stem_conv_b2(xs, wf)
        old = stem.stem_matmul(flat, w2d)
        torch.cuda.synchronize()
        ref = stem.stem_conv_b2_reference(xs, wf).float()
        ref_old = stem.stem_matmul_reference(flat, w2d).float()
        absprod = torch.matmul(flat.float().abs(), w2d.float().abs())
        allow_old = 2 * k * EPS32 * absprod + 1e-30
        allow = allow_old.reshape(b, h2, w2, c_out).permute(0, 3, 1, 2)
        if dt == torch.bfloat16:
            allow = allow + 2.0 ** -8 * (ref.abs() + out.float().abs())
            allow_old = allow_old + 2.0 ** -8 * (ref_old.abs() +
                                                 old.float().abs())
        diff = (out.float() - ref).abs()
        err, ratio = diff.max().item(), (diff / allow).max().item()
        old_ratio = ((old.float() - ref_old).abs() / allow_old).max().item()
        del absprod, allow, allow_old, diff, ref, ref_old, old
        packed = stem.stem_conv_auto(xs, w7).float()
        conv = F.conv2d(x.float(), w7.float(), stride=2, padding=3)
        allow = 2 * k * EPS32 * F.conv2d(x.float().abs(), w7.float().abs(),
                                         stride=2, padding=3) + 1e-30
        if dt == torch.bfloat16:
            allow = allow + 2.0 ** -8 * packed.abs()
        conv_diff = (packed - conv).abs()
        conv_err = conv_diff.max().item()
        conv_ratio = (conv_diff / allow).max().item()
        ok = (ratio <= 1.0 and old_ratio <= 1.0 and conv_ratio <= 1.0 and
              tuple(out.shape) == (b, c_out, h2, w2) and
              out.is_contiguous() and bool(torch.isfinite(out).all()))
        del packed, conv, allow, conv_diff
        ms = cuda_ms(lambda: stem.stem_conv_b2(xs, wf))
        dev_ms = device_ms(lambda: stem.stem_conv_b2(xs, wf))
        plain_ms = cuda_ms(lambda: stem.stem_conv_b2_reference(xs, wf),
                           iters=5)
        library_ms = cuda_ms(
            lambda: F.conv2d(xs, wf, padding=2)[..., :h2, :w2])
        old_ms = cuda_ms(lambda: stem.stem_matmul(flat, w2d))
        cublas_ms = cuda_ms(lambda: torch.matmul(flat, w2d))
        conv_ms = cuda_ms(lambda: F.conv2d(x, w7, stride=2, padding=3))
        esize = xs.element_size()
        bound_ms, bound_by = _bound_ms(
            dname, (xs.numel() + wf.numel() + b * c_out * h2 * w2) * esize,
            2 * m * k * c_out)
        old_bound_ms, _ = _bound_ms(dname, (m * k + k * c_out + m * c_out)
                                    * esize, 2 * m * k * c_out)
        row = {"dtype": dname, "packed_input": [b, c, h2, w2],
               "c_out": c_out, "m": m, "k": k, "max_abs_err": err,
               "err_over_tol": ratio, "first_design_err_over_tol": old_ratio,
               "conv7x7_max_abs_err": conv_err,
               "conv7x7_err_over_tol": conv_ratio, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "first_design_ms": old_ms,
               "first_design_bound_ms": old_bound_ms,
               "cublas_patches_ms": cublas_ms, "cudnn_conv7x7_ms": conv_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok}
        rows.append(row)
        log(f"kernel_stem {dname:8s} xs={(b, c, h2, w2)} C_out={c_out} "
            f"err={err:.3e} ({ratio:.3f} of tol; first design "
            f"{old_ratio:.3f}) vs 7x7 conv err={conv_err:.3e} "
            f"({conv_ratio:.3f} of tol) kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (cuDNN, packed input) "
            f"first_design_ms={old_ms:.4f} cublas_patches_ms="
            f"{cublas_ms:.4f} cudnn_conv7x7_ms={conv_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) "
            f"{'ok' if ok else 'FAILED'}")
        del x, w7, xs, wf, flat, w2d, out
    torch.cuda.empty_cache()
    failed = [f"{r['dtype']}/{r['packed_input']}" for r in rows
              if not r["ok"]]
    if failed:
        raise SystemExit(f"B2 disagrees with its plain version or the 7x7 "
                         f"conv: {failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: training ResNet-50 v1 (the path bench.py times)
# ---------------------------------------------------------------------------
def net_with_loss(net):
    """``bench.py``'s NetWithLoss: the net, then SoftmaxCrossEntropyLoss."""
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    class NetWithLoss(HybridBlock):
        def __init__(self, n):
            super().__init__()
            self.net = n
            self.loss_fn = SoftmaxCrossEntropyLoss()

        def forward(self, x, y):
            return self.loss_fn(self.net(x), y)

    return NetWithLoss(net)


def resnet50(dev, seed=0, layout="NCHW", dtype="bfloat16"):
    """``vision.resnet50_v1(layout=layout)``, Xavier from ``seed``, cast
    to ``dtype``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(layout=layout)
    net.initialize(init=mx.init.Xavier(), ctx=dev,
                   generator=torch.Generator().manual_seed(seed))
    net.cast(dtype)
    return net


def resnet_batch(dev, layout="NCHW"):
    """uniform(-1, 1) bf16 images and random labels, from a fixed seed,
    made on the card; in NHWC the same images, contiguous channels-last."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(21)
    x = (torch.rand(RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE, generator=gen,
                    device=dev)
         * 2 - 1).to(torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device=dev,
                      dtype=torch.int32)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    return x, y


def _cnn_counts():
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE, BN_BWD_REDUCE_ROWS
    from mxnet_tpu_torch.ops.stem import STEM_CONV
    return {"bn_bwd_reduce": BN_BWD_REDUCE.launches,
            "bn_bwd_reduce_rows": BN_BWD_REDUCE_ROWS.launches,
            "stem_conv": STEM_CONV.launches}


def _reset_cnn_counts():
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE, BN_BWD_REDUCE_ROWS
    from mxnet_tpu_torch.ops.stem import STEM_CONV
    BN_BWD_REDUCE.launches = BN_BWD_REDUCE_ROWS.launches = \
        STEM_CONV.launches = 0


def _train_steps(step, args, n_steps, expect, batch=RESNET_BATCH,
                 label="ResNet"):
    """Run ``n_steps`` fused steps, timed, then TRACED_STEPS more traced,
    each run from launch counts of 0.  Returns the timed steps' losses
    (on the card) and seconds to the final sync, the traced steps'
    launches of each kernel on the card (the measured counts) and by
    its wrapper (the bookkeeping), and whether every step launched
    ``expect`` of each kernel by both counts."""
    import torch
    losses, ok = [], True
    torch.cuda.synchronize()
    _reset_cnn_counts()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = _cnn_counts()
        losses.append(step(*args, batch_size=batch))
        after = _cnn_counts()
        ok = ok and all(after[k] - before[k] == expect[k] for k in expect)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _reset_cnn_counts()
    _, traced = traced_launches(lambda: [step(*args, batch_size=batch)
                                         for _ in range(TRACED_STEPS)],
                                _reset_cnn_counts)
    booked = _cnn_counts()
    traced = {k: traced[k] for k in booked}
    ok = ok and all(traced[k] == booked[k] == TRACED_STEPS * expect[k]
                    for k in expect)
    log(f"{TRACED_STEPS} replayed {label} steps traced: launches on the card "
        f"{json.dumps(traced)}, by the wrappers {json.dumps(booked)}")
    return losses, wall, {"traced": traced, "booked": booked}, ok


def _loss_gates(losses):
    """Mean loss per step; every one finite, the last five below the
    first."""
    import torch
    vals = torch.stack([v.float().mean() for v in losses]).cpu().tolist()
    finite = all(v == v and abs(v) != float("inf") for v in vals)
    return vals, finite, sum(vals[-5:]) / 5 < vals[0]


def _resnet_eager_vs_fused(mod, trainer, args, batch=RESNET_BATCH,
                           label="resnet"):
    """One eager record/backward/Trainer.step step of a convolutional
    net (ResNet-50, LeNet, MobileNetV2) against a fused step from the
    same weights, momentum and running statistics: a new
    FusedTrainStep's first (eager) call, and its third, a replay of the
    graph its second call captured while the eager step's loss, and its
    autograd graph, were alive.  cuDNN's backward algorithms may sum
    in a run-dependent order, so all of it runs with
    ``cudnn.deterministic`` (the graph captures the deterministic
    algorithms; this check only).  The gradients' rescale by 1/batch (a
    power of two) is exact, so the two steps hand SGD the same
    gradient: weights must agree within one bf16 ulp (2^-7 |w|), the
    losses and the running statistics exactly."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import FusedTrainStep

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        snap = _snapshot(mod, trainer)
        with autograd.record():
            loss_e = mod(*args)
        autograd.backward(loss_e)
        # loss_e keeps its autograd graph alive across the capture below
        trainer.step(batch)
        eager = {k: p.data().detach().clone()
                 for k, p in mod.collect_params().items()}
        fused = {}
        det_step = FusedTrainStep(mod, trainer)
        for call in (1, 2, 3):
            _restore(mod, trainer, snap)
            loss_f = det_step(*args, batch_size=batch)
            if call != 2:
                fused["eager" if call == 1 else "replayed"] = (
                    loss_f, {k: p.data().detach().clone()
                             for k, p in mod.collect_params().items()})
    finally:
        torch.backends.cudnn.deterministic = prev
    out = {"captures": det_step.captures}
    ok = det_step.captures == 1
    for what, (loss_f, weights) in fused.items():
        worst, n_diff, n_all, stats_equal = 0.0, 0, 0, True
        for k, p in mod.collect_params().items():
            w_f, w_e = weights[k], eager[k]
            if p.grad_req == "null":
                stats_equal = stats_equal and bool(torch.equal(w_f, w_e))
                continue
            diff = (w_e.float() - w_f.float()).abs()
            worst = max(worst, (diff / (EAGER_FUSED_ULP * w_f.float().abs()
                                        + 1e-30)).max().item())
            n_diff += int((diff != 0).sum())
            n_all += diff.numel()
        losses_equal = bool(torch.equal(loss_e.detach(), loss_f))
        out[what] = {"worst_diff_over_one_ulp": worst,
                     "elements_differing": n_diff, "elements": n_all,
                     "running_stats_equal": stats_equal,
                     "losses_equal": losses_equal}
        ok = ok and worst <= 1.0 and stats_equal and losses_equal
    log(f"{label}: eager vs fused and replayed step: " + json.dumps(out))
    if not ok:
        raise SystemExit(f"{label}: eager and fused steps disagree")
    return out


# cuDNN's layout transposes, by the names its kernels take in a trace
TRANSPOSE_NAMES = {"cudnn_transposes": r"(?i)nchwToNhwc|nhwcToNchw"}


def phase_resnet(dev, layout="NCHW"):
    """ResNet-50 v1 as `bench.py` builds it, trained with SGD momentum
    through `Trainer` + `FusedTrainStep` at batch 128, bf16, in
    ``layout`` (NCHW as `bench.py`; NHWC on an NHWC batch, where B1 runs
    its channel-minor form)."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer

    label = "resnet" if layout == "NCHW" else "resnet_nhwc"
    torch.cuda.reset_peak_memory_stats()
    net = resnet50(dev, layout=layout)
    mod = net_with_loss(net)
    args = resnet_batch(dev, layout)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    step = FusedTrainStep(mod, trainer)
    t0 = time.perf_counter()
    warm = [step(*args, batch_size=RESNET_BATCH)
            for _ in range(RESNET_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rows = layout == "NHWC"
    expect = {"bn_bwd_reduce": 0 if rows else BN_LAYERS,
              "bn_bwd_reduce_rows": BN_LAYERS if rows else 0,
              "stem_conv": 0}
    losses, wall, launches, counts_ok = _train_steps(step, args,
                                                     RESNET_STEPS, expect)
    vals, finite, falling = _loss_gates(warm + losses)
    measured = vals[RESNET_WARMUP:]
    n_params = sum(p.data().numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    out = {"model": f"resnet50_v1 ({layout})", "dtype": "bfloat16",
           "batch": RESNET_BATCH, "steps": RESNET_STEPS,
           "warmup_steps": RESNET_WARMUP, "warmup_s": warm_s,
           "step_ms": wall / RESNET_STEPS * 1e3,
           "img_per_s": RESNET_BATCH * RESNET_STEPS / wall,
           "trainable_params": n_params,
           "loss_first": vals[0], "loss_last5_mean": sum(vals[-5:]) / 5,
           "losses": measured, "traced_steps": TRACED_STEPS,
           "launches": launches["traced"],
           "launches_booked": launches["booked"],
           "launches_per_step_ok": counts_ok,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": nvidia_smi()}
    log(f"{label}: " + json.dumps(out))
    if not (finite and falling and counts_ok):
        raise SystemExit(f"{label} training failed: finite={finite} "
                         f"falling={falling} launches per step ok="
                         f"{counts_ok}")
    eager_step, eager_ms, eager_counts = _eager_steps(
        mod, trainer, args, RESNET_BATCH, 2, 8, _cnn_counts)
    out["eager_step_ms"] = eager_ms
    out["eager_launches_per_step_ok"] = all(
        s[k] == expect[k] for s in eager_counts for k in expect)
    out["captures"] = step.captures
    log(f"{label}: eager step {eager_ms:.3f} ms against replayed "
        f"{out['step_ms']:.3f} ms; captures {step.captures}; eager "
        f"launches per step ok {out['eager_launches_per_step_ok']}")
    if not out["eager_launches_per_step_ok"] or step.captures != 1:
        raise SystemExit(f"{label}: eager steps launched B1 other than "
                         f"{BN_LAYERS} times, or the step was captured more "
                         "than once")
    out["eager_vs_fused"] = _resnet_eager_vs_fused(mod, trainer, args,
                                                   label=label)
    out["profile"] = phase_train_profile(
        lambda: step(*args, batch_size=RESNET_BATCH),
        f"replayed ResNet-50 ({layout}) training step at batch "
        f"{RESNET_BATCH}", TRANSPOSE_NAMES)
    out["eager_profile"] = phase_train_profile(
        eager_step, f"eager ResNet-50 ({layout}) training step at batch "
        f"{RESNET_BATCH}", TRANSPOSE_NAMES)
    del step, eager_step, trainer, mod, net, args
    torch.cuda.empty_cache()
    return out


def phase_resnet_s2d(dev):
    """The same net with ``features.0`` replaced by
    ``SpaceToDepthStem(64, in_channels=3)`` carrying the 7x7 weight, fed
    the input packed once on the card."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.gluon.nn import SpaceToDepthStem
    from mxnet_tpu_torch.ops.stem import space_to_depth2

    net = resnet50(dev)
    x, y = resnet_batch(dev)
    net._ensure_shapes(x[:1])
    stem = SpaceToDepthStem(64, in_channels=3)
    stem.initialize(ctx=dev)
    stem.cast("bfloat16")
    stem.weight.set_data(net.features[0].weight.data())
    setattr(net.features, "0", stem)
    args = (space_to_depth2(x).contiguous(), y)
    del x
    mod = net_with_loss(net)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    step = FusedTrainStep(mod, trainer)
    warm = [step(*args, batch_size=RESNET_BATCH) for _ in range(S2D_WARMUP)]
    expect = {"bn_bwd_reduce": BN_LAYERS, "bn_bwd_reduce_rows": 0,
              "stem_conv": 1}
    losses, wall, launches, counts_ok = _train_steps(step, args, S2D_STEPS,
                                                     expect)
    vals, finite, falling = _loss_gates(warm + losses)
    out = {"model": "resnet50_v1 + SpaceToDepthStem", "dtype": "bfloat16",
           "batch": RESNET_BATCH, "steps": S2D_STEPS,
           "warmup_steps": S2D_WARMUP, "step_ms": wall / S2D_STEPS * 1e3,
           "img_per_s": RESNET_BATCH * S2D_STEPS / wall,
           "loss_first": vals[0], "loss_last5_mean": sum(vals[-5:]) / 5,
           "losses": vals[S2D_WARMUP:], "traced_steps": TRACED_STEPS,
           "launches": launches["traced"],
           "launches_booked": launches["booked"],
           "launches_per_step_ok": counts_ok}
    log("resnet_s2d: " + json.dumps(out))
    if not (finite and falling and counts_ok):
        raise SystemExit(f"space-to-depth ResNet training failed: "
                         f"finite={finite} falling={falling} launches per "
                         f"step ok={counts_ok}")
    del step, trainer, mod, net, args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8b: ResNet-50 trained from a RecordIO file (bench.py's recordio rider)
# ---------------------------------------------------------------------------
def make_bench_rec(path):
    """`bench.py`'s ``_ensure_bench_rec`` through the port's `recordio`:
    `REC_IMAGES` JPEG-encoded (Pillow, quality 85) `REC_SIDE` squared
    low-frequency textures (32 x 32 noise resized bilinearly) and labels
    in 0..999, from seed 0."""
    import io as pio

    import numpy as onp
    from PIL import Image
    from mxnet_tpu_torch import recordio

    rs = onp.random.RandomState(0)
    w = recordio.MXRecordIO(path, "w")
    for i in range(REC_IMAGES):
        small = rs.randint(0, 255, (32, 32, 3), dtype=onp.uint8)
        img = Image.fromarray(small).resize((REC_SIDE, REC_SIDE),
                                            Image.BILINEAR)
        buf = pio.BytesIO()
        img.save(buf, "JPEG", quality=85)
        w.write(recordio.pack(
            recordio.IRHeader(0, float(rs.randint(0, 1000)), i, 0),
            buf.getvalue()))
    w.close()


class _Tee:
    """A prefetcher's source that keeps every batch it hands out (the
    host arrays, by reference): what the prefetcher delivers is held
    against them afterwards."""

    def __init__(self, source):
        self.source = source
        self.batches = []

    def __call__(self):
        src = self.source
        if hasattr(src, "next_arrays"):
            arrays = src.next_arrays()
        else:
            batch = src.next()
            arrays = tuple(a.numpy() for a in batch.data + batch.label)
        self.batches.append(arrays)
        return arrays


def rec_net_with_loss(net, dev):
    """`bench.py`'s ``RecNetWithLoss``: uint8 NHWC in; f32, normalised,
    bf16 and NCHW inside the step."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    class RecNetWithLoss(HybridBlock):
        def __init__(self, n):
            super().__init__()
            self.net = n
            self.loss_fn = SoftmaxCrossEntropyLoss()
            self.mean = mx.np.array(REC_MEAN, ctx=dev)
            self.std = mx.np.array(REC_STD, ctx=dev)

        def forward(self, x_u8, y):
            x = x_u8.to(torch.float32)
            x = ((x - self.mean) / self.std).to(torch.bfloat16)
            x = mx.np.transpose(x, (0, 3, 1, 2))
            return self.loss_fn(self.net(x), y)

    return RecNetWithLoss(net)


def aug_net_with_loss(net, dev):
    """`bench.py`'s ``AugNetWithLoss``: the uint8 canvas in; random
    224 x 224 crop, flip, normalisation, bf16 and NCHW by `DeviceAugment`
    inside the step."""
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon.data import DeviceAugment
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    class AugNetWithLoss(HybridBlock):
        def __init__(self, n):
            super().__init__()
            self.net = n
            self.loss_fn = SoftmaxCrossEntropyLoss()
            self.aug = DeviceAugment(
                (RESNET_IMAGE, RESNET_IMAGE), rand_crop=True,
                rand_mirror=True, mean=REC_MEAN, std=REC_STD,
                dtype="bfloat16")

        def forward(self, x_u8, y):
            return self.loss_fn(self.net(self.aug(x_u8)), y)

    return AugNetWithLoss(net)


def _decode_rates(rec):
    """img/s of the native pipeline (`bench.py`'s shapes: 224 crops and
    flips of the shuffled file), one decode thread and the default pool
    (`env.decode_threads`), each on a fresh handle after one batch."""
    from mxnet_tpu_torch.env import decode_threads
    from mxnet_tpu_torch.io import ImageRecordIter

    out = {}
    for name, threads, n in (("single", 1, REC_SINGLE_BATCHES),
                             ("pool", None, REC_POOL_BATCHES)):
        it = ImageRecordIter(rec, RESNET_BATCH, (3, RESNET_IMAGE,
                                                 RESNET_IMAGE),
                             rand_crop=True, rand_mirror=True, shuffle=True,
                             preprocess_threads=threads)
        it.next_arrays()
        t0 = time.perf_counter()
        for _ in range(n):
            it.next_arrays()
        out[f"decode_{name}_img_per_s"] = RESNET_BATCH * n / (
            time.perf_counter() - t0)
        it.close()
    out["decode_pool_threads"] = decode_threads()
    return out


def _pil_canvases(rec):
    """Every record of ``rec`` decoded on the host by Pillow
    (`recordio.unpack_img`), one thread: (N, S, S, 3) uint8 canvases,
    f32 labels, and the img/s it took."""
    import numpy as onp
    from mxnet_tpu_torch import recordio

    r = recordio.MXRecordIO(rec, "r")
    imgs, labels = [], []
    t0 = time.perf_counter()
    while (buf := r.read()) is not None:
        header, img = recordio.unpack_img(buf)
        imgs.append(img.numpy())
        labels.append(header.label)
    rate = len(imgs) / (time.perf_counter() - t0)
    r.close()
    return onp.stack(imgs), onp.asarray(labels, onp.float32), rate


def _h2d(batch, dev):
    """ms and MB/s of one pinned host-to-card copy of ``batch`` (a numpy
    array), by CUDA events."""
    import torch
    pinned = torch.from_numpy(batch).pin_memory()
    dst = torch.empty(pinned.shape, dtype=pinned.dtype, device=dev)
    ms = cuda_ms(lambda: dst.copy_(pinned, non_blocking=True), iters=10)
    return ms, batch.nbytes / 2 ** 20 / (ms / 1e3)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _augment_words_check(step, dev, canvas_hw):
    """The seed words of the captured step's last replay (its buffer's
    first row, the augment's draw): their crop offsets and flips on the
    card against the plain CPU draw of the same words."""
    import torch
    from mxnet_tpu_torch.gluon.data.augment import augment_draws
    from mxnet_tpu_torch.ops.threefry import key_of

    (entry,) = step._graphs.values()
    if entry.kinds != ("augment",):
        raise SystemExit(f"recordio: the captured AugNet step drew "
                         f"{entry.kinds}, not one augment key")
    words = entry.buf[:2].clone()
    shape = (RESNET_BATCH, *canvas_hw, RESNET_IMAGE, RESNET_IMAGE)
    card = augment_draws(key_of(words), *shape)
    plain = augment_draws(key_of(words.cpu()), *shape)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card, plain))
    return words.cpu(), plain, same


def _recordio_variant(name, dev, make_mod, source, canvas_hw):
    """Train ResNet-50 through `FusedTrainStep` from ``source`` (a
    DataIter of uint8 NHWC batches and f32 labels) behind a
    `DevicePrefetcher`: warm-up, chip-only, two end-to-end windows, one
    step's host syncs, TRACED_STEPS traced steps; then the gates."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.io import DevicePrefetcher

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    net = resnet50(dev)
    mod = make_mod(net, dev)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(31))
    tee = _Tee(source)
    pf = DevicePrefetcher(tee, ctx=dev, depth=REC_DEPTH,
                          dtypes=(None, onp.int32))
    delivered = []

    def one():
        x, y = next(pf)
        delivered.append((x, y))
        return step(x, y, batch_size=RESNET_BATCH)

    t0 = time.perf_counter()
    losses = [one() for _ in range(REC_WARMUP)]
    _sync(dev)
    warm_s = time.perf_counter() - t0
    # chip-only: re-step the last resident batch, then put the weights
    # back, so the end-to-end windows train on from the warm-up
    snap = _snapshot(mod, trainer)
    x0, y0 = delivered[-1]
    for _ in range(2):
        step(x0, y0, batch_size=RESNET_BATCH)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(REC_CHIP_STEPS):
        step(x0, y0, batch_size=RESNET_BATCH)
    _sync(dev)
    chip_rate = RESNET_BATCH * REC_CHIP_STEPS / (time.perf_counter() - t0)
    _restore(mod, trainer, snap)
    windows = []
    for _ in range(REC_WINDOWS):
        t0 = time.perf_counter()
        losses += [one() for _ in range(REC_WINDOW)]
        _sync(dev)
        windows.append(RESNET_BATCH * REC_WINDOW /
                       (time.perf_counter() - t0))
    out = {"variant": name, "batch": RESNET_BATCH, "warmup_s": warm_s,
           "chip_only_img_per_s": chip_rate,
           "end_to_end_img_per_s": windows,
           "prefetcher": pf.stats()}
    n_syncs, examples = _count_syncs(one)
    seen, _ = _count_syncs(lambda: torch.ones(1, device=dev).item())
    out["host_syncs_per_step"] = n_syncs if seen >= 1 else "not measured"
    _reset_cnn_counts()
    _, traced = traced_launches(lambda: [one() for _ in range(TRACED_STEPS)],
                                _reset_cnn_counts)
    booked = _cnn_counts()
    out["launches"] = {k: traced[k] for k in booked}
    out["launches_booked"] = booked
    expect = {"bn_bwd_reduce": BN_LAYERS, "bn_bwd_reduce_rows": 0,
              "stem_conv": 0}
    counts_ok = all(traced[k] == booked[k] == TRACED_STEPS * n
                    for k, n in expect.items())
    if canvas_hw is not None:
        words1, draws1, same1 = _augment_words_check(step, dev, canvas_hw)
        one()
        words2, draws2, same2 = _augment_words_check(step, dev, canvas_hw)
        differ = not all(torch.equal(a, b) for a, b in zip(draws1, draws2))
        out["augment"] = {"words": [(w.long() & 0xFFFFFFFF).tolist()
                                    for w in (words1, words2)],
                          "card_draws_equal_plain": same1 and same2,
                          "two_replays_crop_differently": differ}
        aug = mod.aug
        from mxnet_tpu_torch import autograd
        xa = delivered[-1][0]

        def augment_alone():
            with autograd.train_mode(
                    generator=torch.Generator().manual_seed(5)):
                return aug(xa)
        out["augment_device_ms"] = device_ms(augment_alone, iters=5)
        step_ms = RESNET_BATCH * 1e3 / max(windows)
        out["profile"] = profile_call(
            one, f"replayed {name} step at batch {RESNET_BATCH} through "
            "the prefetcher", step_ms)
        dev_ms = out["profile"]["device_ms_traced"]
        out["augment_device_share"] = (
            out["augment_device_ms"] / dev_ms
            if isinstance(dev_ms, float) else "not measured")
    pf.close()
    # every batch delivered equals, bitwise on the card, the batch the
    # source handed the prefetcher
    bitwise = len(tee.batches) >= len(delivered) and all(
        torch.equal(x, torch.from_numpy(hx).to(dev)) and
        torch.equal(y, torch.from_numpy(hy.astype(onp.int32)).to(dev))
        for (x, y), (hx, hy) in zip(delivered, tee.batches))
    vals, finite, falling = _loss_gates(losses)
    out.update({"batches_checked": len(delivered),
                "delivered_bitwise": bitwise, "loss_first": vals[0],
                "loss_last5_mean": sum(vals[-5:]) / 5, "losses": vals,
                "launches_per_step_ok": counts_ok,
                "captures": step.captures,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else "not measured"})
    log(f"recordio: {name}: " + json.dumps(out))
    ok = finite and falling and counts_ok and bitwise and \
        step.captures == 1 and out["host_syncs_per_step"] == 0
    if canvas_hw is not None:
        ok = ok and out["augment"]["card_draws_equal_plain"] and \
            out["augment"]["two_replays_crop_differently"]
    if not ok:
        raise SystemExit(
            f"recordio: {name} failed: finite={finite} falling={falling} "
            f"launches ok={counts_ok} delivered bitwise={bitwise} "
            f"captures={step.captures} host syncs="
            f"{out['host_syncs_per_step']} {examples} augment="
            f"{out.get('augment')}")
    del step, trainer, mod, net, delivered, tee, pf
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_recordio(dev):
    """`bench.py`'s ``_bench_recordio`` in the port: ResNet-50 v1 (bf16,
    batch 128, Xavier, SGD lr 0.1 momentum 0.9) trained through a
    captured `FusedTrainStep` from a RecordIO file, ``ImageRecordIter``
    -> ``DevicePrefetcher(depth=3, dtypes=(None, int32))``, in two
    variants: (a) host crops and flips, ``RecNetWithLoss``; (b) 256 x 256
    canvases, `DeviceAugment` inside the step.  Where this machine
    cannot link libjpeg (`_native.jpeg_unavailable`), the native
    pipeline cannot be built: (a) is not run, and (b) is fed the
    file's records decoded by Pillow on the host, through ``NDArrayIter``
    and ``ResizeIter``; the output says so and why."""
    import numpy as onp
    from pathlib import Path
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.io import ImageRecordIter, NDArrayIter, ResizeIter

    rec_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    rec_dir.mkdir(parents=True, exist_ok=True)
    rec = str(rec_dir / "bench_imagenet.rec")
    t0 = time.perf_counter()
    make_bench_rec(rec)
    out = {"images": REC_IMAGES, "side": REC_SIDE,
           "rec_build_s": time.perf_counter() - t0,
           "rec_mb": Path(rec).stat().st_size / 2 ** 20}
    no_jpeg = _native.jpeg_unavailable()
    out["native_decode"] = "run" if no_jpeg is None else \
        "not run: g++ cannot link libjpeg here: " + no_jpeg.splitlines()[0]
    log(f"recordio: file {json.dumps(out)}")
    if no_jpeg is None:
        out.update(_decode_rates(rec))
        crop_src = ImageRecordIter(rec, RESNET_BATCH,
                                   (3, RESNET_IMAGE, RESNET_IMAGE),
                                   rand_crop=True, rand_mirror=True,
                                   shuffle=True)
        out["a"] = _recordio_variant("a_host_crop", dev, rec_net_with_loss,
                                     crop_src, None)
        crop_src.close()
        canvas_src = ImageRecordIter(rec, RESNET_BATCH,
                                     (3, REC_SIDE, REC_SIDE), shuffle=True)
    else:
        canvases, labels, out["pil_decode_single_img_per_s"] = \
            _pil_canvases(rec)
        onp.random.seed(0)
        canvas_src = ResizeIter(NDArrayIter(canvases, labels,
                                            batch_size=RESNET_BATCH,
                                            shuffle=True), 10 ** 6)
    out["b"] = _recordio_variant("b_device_augment", dev, aug_net_with_loss,
                                 canvas_src, (REC_SIDE, REC_SIDE))
    if hasattr(canvas_src, "close"):
        canvas_src.close()
    for v in ("a", "b"):
        if v not in out:
            continue
        shape = (RESNET_BATCH, RESNET_IMAGE if v == "a" else REC_SIDE,
                 RESNET_IMAGE if v == "a" else REC_SIDE, 3)
        ms, mb_s = _h2d(onp.zeros(shape, onp.uint8), dev)
        res = out[v]
        res["h2d_ms"], res["h2d_mb_per_s"] = ms, mb_s
        res["h2d_img_per_s"] = RESNET_BATCH / (ms / 1e3)
        rates = {"h2d": res["h2d_img_per_s"],
                 "chip_only": res["chip_only_img_per_s"]}
        if "decode_pool_img_per_s" in out:
            rates["decode_pool"] = out["decode_pool_img_per_s"]
        res["overlap_bound_img_per_s"] = min(rates.values())
        res["bound_by"] = min(rates, key=rates.get)
        res["overlap_bound_over"] = sorted(rates)
        res["vs_overlap_bound"] = max(res["end_to_end_img_per_s"]) / \
            res["overlap_bound_img_per_s"]
        log(f"recordio: {res['variant']}: end to end "
            f"{res['end_to_end_img_per_s']} img/s, chip only "
            f"{res['chip_only_img_per_s']:.2f}, h2d {res['h2d_img_per_s']:.2f}"
            f" img/s ({mb_s:.1f} MB/s), decode pool "
            f"{out.get('decode_pool_img_per_s', 'not measured')}; overlap "
            f"bound {res['overlap_bound_img_per_s']:.2f} ({res['bound_by']}),"
            f" vs bound {res['vs_overlap_bound']:.4f}")
    out["card"] = nvidia_smi()
    log("recordio: " + json.dumps({k: v for k, v in out.items()
                                   if k not in ("a", "b")}))
    return out


# ---------------------------------------------------------------------------
# phase 9: B6 (user kernels through rtc.CudaModule) vs plain
# ---------------------------------------------------------------------------
def _softmax_tol(cols):
    """softmax_fwd's allowance as a multiple of |plain|: f32 sums of
    positive terms with depth d err by at most d * 2^-24 of the sum; the
    kernel's depth is ceil(cols / 256) sequential adds per thread and 8
    tree levels, the plain sum's taken to be no deeper, so the two sums
    may differ by twice that; each side's exp and division add at most 2
    and 1 ulps."""
    return (2 * (-(-cols // SOFTMAX_THREADS) + 8) + 6) * EPS32


def _host_us(fn, n=200):
    """Host microseconds per call of ``fn``: the enqueue cost, over
    fewer calls than the launch queue holds, so that the host never
    waits for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / n * 1e6


RTC_HOST_WINDOWS = 5


def rtc_host_times(dev, windows=1):
    """Host microseconds per ``CudaKernel.launch`` of ``axpy`` (f32
    scalar) and ``scale_bf16`` (bf16 scalar) at 128000 elements, beside
    torch's launch of the same work (``add_``, ``mul``), and of the
    ``resolve_device`` call that a kernel keeps the result of, in
    ``windows`` alternating windows of `_host_us`."""
    import torch

    from mxnet_tpu_torch.context import resolve_device
    kernels = user_kernels()
    gen = torch.Generator(device=dev).manual_seed(52)
    n = 128 * 1000
    grid = (-(-n // 256),)
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev)
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    calls = {
        "host_us_per_launch": lambda: kernels["axpy"].launch(
            (x, y, 2.5, n), dev, grid, (256,)),
        "torch_add_host_us": lambda: y.add_(x, alpha=2.5),
        "bf16_scalar_host_us_per_launch": lambda: kernels[
            "scale_bf16"].launch((xb, yb, SCALE_BF16, n), dev, grid, (256,)),
        "torch_mul_host_us": lambda: torch.mul(xb, SCALE_BF16, out=yb),
        "resolve_device_host_us": lambda: resolve_device(dev)}
    out = {k: [] for k in calls}
    for _ in range(windows):
        for k, fn in calls.items():
            out[k].append(_host_us(fn))
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}, out


def phase_rtc(dev):
    """The user module compiled once by NVRTC (timed); ``axpy``,
    ``scale<float>`` (a template found by its exported name) and
    ``row_reverse`` (80 KB of dynamic shared memory) held bitwise;
    ``softmax_fwd`` against `softmax_plain` within `_softmax_tol` and
    ``softmax_bwd`` bitwise against `softmax_bwd_plain` at
    `SOFTMAX_SHAPES`, each timed beside its bound, its plain version and
    its library call (``torch.softmax``; for the backward
    ``torch.scatter_add`` of -1 at the labels, held bitwise against the
    plain version); and the host's time per
    ``CudaKernel.launch`` against torch's launch of the same work
    (``add_`` for ``axpy``, ``torch.softmax`` for ``softmax_fwd``)."""
    import torch

    kernels = user_kernels()
    gen = torch.Generator(device=dev).manual_seed(51)
    checks = {}
    n = 128 * 1000
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev)
    want = axpy_plain(x, y, 2.5)
    kernels["axpy"].launch((x, y, 2.5, n), dev, (-(-n // 256),), (256,))
    checks["axpy_bitwise"] = bool(torch.equal(y, want))
    out = torch.empty_like(x)
    kernels["scale<float>"].launch((x, out, -0.75, n), dev, (-(-n // 256),),
                                   (256,))
    checks["scale<float>_bitwise"] = bool(torch.equal(out, x * -0.75))
    wide = torch.randn(4, 20000, generator=gen, device=dev)
    rev = torch.empty_like(wide)
    smem = wide.shape[1] * 4
    kernels["row_reverse"].launch((wide, rev, wide.shape[1]), dev, (4,),
                                  (1024,), shared_mem=smem)
    checks[f"row_reverse_{smem}_bytes_smem_bitwise"] = bool(
        torch.equal(rev, wide.flip(1)))
    xb = x.to(torch.bfloat16)
    yb = torch.empty_like(xb)
    kernels["scale_bf16"].launch((xb, yb, SCALE_BF16, n), dev,
                                 (-(-n // 256),), (256,))
    a_bf16 = torch.tensor(SCALE_BF16, dtype=torch.bfloat16).float()
    checks["scale_bf16_bitwise"] = bool(torch.equal(
        yb, (xb.float() * a_bf16.to(dev)).to(torch.bfloat16)))
    torch.cuda.synchronize()
    host, _ = rtc_host_times(dev)
    del x, y, want, out, wide, rev, xb, yb

    fwd, bwd = kernels["softmax_fwd"], kernels["softmax_bwd"]
    rows = []
    for r, c in SOFTMAX_SHAPES:
        x = torch.randn(r, c, generator=gen, device=dev) * 4
        label = torch.randint(0, c, (r,), generator=gen, device=dev,
                              dtype=torch.int32)
        prob = torch.empty_like(x)
        dx = torch.empty_like(x)

        def run_fwd():
            fwd.launch((x, prob, c, 1), dev, (r,), (SOFTMAX_THREADS,))

        def run_bwd():
            bwd.launch((label, prob, dx, c, 1), dev,
                       (-(-c // SOFTMAX_THREADS), r), (SOFTMAX_THREADS,))

        run_fwd()
        run_bwd()
        torch.cuda.synchronize()
        ref = softmax_plain(x)
        tol = _softmax_tol(c)
        diff = (prob - ref).abs()
        err = diff.max().item()
        ratio = (diff / (tol * ref.abs() + 1e-30)).max().item()
        bwd_want = softmax_bwd_plain(label, prob)
        bwd_diff = (dx - bwd_want).abs()
        bwd_equal = not bool(bwd_diff.any())
        # the library yardstick for softmax_bwd: one scatter_add of -1 at
        # each row's label, the same function bitwise (y + -1 is y - 1)
        idx = label.long()[:, None]
        neg_ones = torch.full((r, 1), -1.0, device=dev)
        lib_equal = bool(torch.equal(
            torch.scatter_add(prob, 1, idx, neg_ones), bwd_want))
        ok = ratio <= 1.0 and bwd_equal and lib_equal and \
            bool(torch.isfinite(prob).all())
        fwd_bound = _bound_ms("float32", 2 * x.numel() * 4, 5 * x.numel())
        bwd_bound = _bound_ms("float32", 2 * x.numel() * 4 + r * 4,
                              x.numel())
        row = {"shape": [r, c], "fwd_max_abs_err": err,
               "err_over_tol": ratio, "rtol": tol,
               "bwd_max_abs_err": bwd_diff.max().item(),
               "bwd_bitwise": bwd_equal,
               "fwd_ms": cuda_ms(run_fwd),
               "fwd_plain_ms": cuda_ms(lambda: softmax_plain(x)),
               "fwd_library_ms": cuda_ms(lambda: torch.softmax(x, -1)),
               "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
               "bwd_ms": cuda_ms(run_bwd),
               "bwd_plain_ms": cuda_ms(lambda: softmax_bwd_plain(label,
                                                                 prob)),
               "bwd_library_ms": cuda_ms(lambda: torch.scatter_add(
                   prob, 1, idx, neg_ones)),
               "bwd_library_bitwise": lib_equal,
               "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
               "fwd_host_us": _host_us(run_fwd),
               "torch_softmax_host_us": _host_us(
                   lambda: torch.softmax(x, -1)),
               "ok": ok}
        rows.append(row)
        log(f"kernel_rtc softmax {(r, c)} fwd err={err:.3e} ({ratio:.3f} "
            f"of tol {tol:.2e}) fwd_ms={row['fwd_ms']:.4f} plain_ms="
            f"{row['fwd_plain_ms']:.4f} torch.softmax_ms="
            f"{row['fwd_library_ms']:.4f} bound_ms={fwd_bound[0]:.4f}; "
            f"bwd bitwise={bwd_equal} bwd_ms={row['bwd_ms']:.4f} plain_ms="
            f"{row['bwd_plain_ms']:.4f} scatter_add_ms="
            f"{row['bwd_library_ms']:.4f} (bitwise={lib_equal}) "
            f"bound_ms={bwd_bound[0]:.4f}; host "
            f"us per launch {row['fwd_host_us']:.1f} (torch.softmax "
            f"{row['torch_softmax_host_us']:.1f}) "
            f"{'ok' if ok else 'FAILED'}")
        del x, label, prob, dx, ref, diff, bwd_diff, bwd_want, idx, neg_ones
    torch.cuda.empty_cache()
    out = {"compile_ms": kernels["compile_ms"], "checks": checks, **host,
           "softmax": rows}
    log("rtc: " + json.dumps({k: v for k, v in out.items()
                              if k != "softmax"}))
    failed = [k for k, v in checks.items() if not v] + \
        [str(r["shape"]) for r in rows if not r["ok"]]
    if failed:
        raise SystemExit(f"user kernels disagree with their plain "
                         f"versions: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 10: ResNet-50 with the softmax_rtc head, eager loop, checkpoint
# ---------------------------------------------------------------------------
def _custom_step(net, trainer, x, y):
    """One eager step with the custom head: record, the forward, the
    logits in f32 through ``mx.nd.Custom(..., op_type="softmax_rtc")``,
    backward (the head ignores its head gradients) and
    ``Trainer.step``.  Returns the f32 logits and the head's
    probabilities, off the tape."""
    import mxnet_tpu_torch as mx
    with mx.autograd.record():
        logits = net(x).float()
        prob = mx.nd.Custom(logits, y, op_type="softmax_rtc")
    mx.autograd.backward(prob)
    trainer.step(RESNET_BATCH)
    return logits.detach(), prob.detach()


def _nll(out, y):
    """The step's mean loss -log p[label] and how many of its samples'
    p[label] the head's f32 output holds as 0.  The loss is taken from
    the logits (a log-softmax): during the lr-0.1 spike some samples'
    p[label] falls below f32's least value, where -log p of the head's
    output reads +inf."""
    import torch
    logits, prob = out
    idx = y.long()[:, None]
    nll = -torch.log_softmax(logits, -1).gather(1, idx).mean()
    return nll, (prob.gather(1, idx) == 0).sum()


def _head_grad_check(net, x, y, train=False):
    """The head's logits gradient against autograd through
    SoftmaxCrossEntropyLoss on the same f32 logits, from a forward in
    predict mode or (``train``) in train mode, as a step takes it (which
    moves the running statistics).  Returns the largest difference and
    how many elements differ once both are rounded to bf16, as the
    step's backward rounds them into the net."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    mode = mx.autograd.train_mode() if train else mx.autograd.predict_mode()
    with torch.no_grad(), mode:
        logits = net(x).float()
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    with mx.autograd.record():
        prob = mx.nd.Custom(a, y, op_type="softmax_rtc")
        loss = SoftmaxCrossEntropyLoss()(b, y)
    mx.autograd.backward(prob)
    mx.autograd.backward(loss)
    return ((a.grad - b.grad).abs().max().item(),
            (a.grad.bfloat16() != b.grad.bfloat16()).sum().item())


def _ce_step(net, trainer, x, y, f32_logits):
    """One eager step with SoftmaxCrossEntropyLoss in the head's place:
    on the f32 logits, as the head takes them, or on the bf16 logits, as
    phase 7's step does."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    with mx.autograd.record():
        logits = net(x)
        loss = SoftmaxCrossEntropyLoss()(
            logits.float() if f32_logits else logits, y)
    mx.autograd.backward(loss)
    trainer.step(RESNET_BATCH)


def _ce_curve(dev, f32_logits):
    """The custom-head phase's eager loop with SoftmaxCrossEntropyLoss in
    the head's place, from the same weights (`resnet50`, seed 0) and the
    same batch, for the same warm-up and timed steps: the mean loss of
    each step (on the f32 logits, as the head takes them, or on the bf16
    logits, as phase 7's fused step does)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    net = resnet50(dev)
    x, y = resnet_batch(dev)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    losses = []
    for _ in range(CUSTOM_WARMUP + CUSTOM_STEPS):
        with mx.autograd.record():
            logits = net(x)
            loss = SoftmaxCrossEntropyLoss()(
                logits.float() if f32_logits else logits, y)
        mx.autograd.backward(loss)
        trainer.step(RESNET_BATCH)
        losses.append(loss.detach().float().mean())
    vals = torch.stack(losses).cpu().tolist()
    del net, trainer, x, y
    torch.cuda.empty_cache()
    return vals


def _weight_diff(mine, theirs):
    """The largest absolute difference over every parameter, and how
    many parameters differ at all."""
    import torch
    diffs = [(a.data().float() - theirs[k].data().float()).abs().max()
             for k, a in mine.items()]
    return {"max_abs": torch.stack(diffs).max().item(),
            "params_differing": sum(bool(d > 0) for d in diffs),
            "params": len(diffs)}


def _checkpoint_resume(net, trainer, dev, x, y):
    """``save_parameters`` + ``save_states``, one more step on the
    running net; a fresh net (other random weights) and trainer load
    both and take the same step.  With cuDNN pinned deterministic (and
    B1 and the user kernels deterministic by design) the two must leave
    every weight, running statistic and momentum bitwise equal.  Then
    the fresh net and trainer load the checkpoint again and take the
    step with SoftmaxCrossEntropyLoss in the head's place, once on the
    f32 logits and once on the bf16 logits: how far each lands from the
    head's step (reported, not gated), beside the two logits gradients
    from the checkpoint's train-mode forward."""
    import pathlib

    import torch
    from mxnet_tpu_torch.gluon import Trainer

    folder = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    folder.mkdir(parents=True, exist_ok=True)
    params, states = folder / "resnet50.params", folder / "resnet50.states"
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        net.save_parameters(str(params))
        trainer.save_states(str(states))
        save_s = time.perf_counter() - t0
        _custom_step(net, trainer, x, y)
        fresh = resnet50(dev, seed=1)
        t0 = time.perf_counter()
        fresh.load_parameters(str(params))
        fresh_tr = Trainer(fresh.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="device")
        fresh_tr.load_states(str(states))
        load_s = time.perf_counter() - t0
        _custom_step(fresh, fresh_tr, x, y)
        torch.cuda.synchronize()
        mine, theirs = net.collect_params(), fresh.collect_params()
        differing = [k for k, p in mine.items()
                     if not torch.equal(p.data(), theirs[k].data())]
        differing += [f"state {i}" for i, st in trainer._states.items()
                      if not all(torch.equal(s, t) for s, t in
                                 zip(st, fresh_tr._states[i]))]
        fresh.load_parameters(str(params))
        err, bf16_differing = _head_grad_check(fresh, x, y, train=True)
        head_vs_ce = {"logits_grad_train_mode_max_abs": err,
                      "logits_grad_bf16_elements_differing": bf16_differing}
        for name, f32 in (("ce_on_f32_logits", True),
                          ("ce_on_bf16_logits", False)):
            fresh.load_parameters(str(params))
            fresh_tr.load_states(str(states))
            _ce_step(fresh, fresh_tr, x, y, f32)
            head_vs_ce[name] = _weight_diff(mine, theirs)
    finally:
        torch.backends.cudnn.deterministic = prev
    out = {"file_mb": (params.stat().st_size + states.stat().st_size) / 1e6,
           "save_s": save_s, "load_s": load_s,
           "tensors_compared": len(mine) + len(trainer._states),
           "differing": differing[:5], "bitwise_equal": not differing,
           "head_step_vs_cross_entropy_step": head_vs_ce}
    params.unlink()
    states.unlink()
    del fresh, fresh_tr
    return out


def phase_resnet_custom(dev):
    """ResNet-50 v1 (`resnet50`: bf16, batch 128, Xavier from seed 0)
    with the ``softmax_rtc`` head over its f32 logits, SGD lr 0.1
    momentum 0.9 through `Trainer` in the eager loop: warm-up, then the
    timed steps from launch counts of 0 (B6 twice a step, B1 53 times);
    the head's gradient against SoftmaxCrossEntropyLoss's; checkpoint
    and resume; one step traced."""
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE

    register_softmax_rtc()
    kernels = user_kernels()
    fwd, bwd = kernels["softmax_fwd"], kernels["softmax_bwd"]
    torch.cuda.reset_peak_memory_stats()
    net = resnet50(dev)
    x, y = resnet_batch(dev)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    t0 = time.perf_counter()
    steps = [_nll(_custom_step(net, trainer, x, y), y)
             for _ in range(CUSTOM_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def counts():
        return (fwd.launches, bwd.launches, BN_BWD_REDUCE.launches)

    counts_ok = True
    fwd.launches = bwd.launches = BN_BWD_REDUCE.launches = 0
    t0 = time.perf_counter()
    for _ in range(CUSTOM_STEPS):
        before = counts()
        steps.append(_nll(_custom_step(net, trainer, x, y), y))
        after = counts()
        counts_ok = counts_ok and [b - a for a, b in zip(before, after)] == \
            [1, 1, BN_LAYERS]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("softmax_fwd", "softmax_bwd", "bn_bwd_reduce"),
                        counts()))
    vals, finite, falling = _loss_gates([nll for nll, _ in steps])
    zero_p = torch.stack([z for _, z in steps]).tolist()
    grad_err, _ = _head_grad_check(net, x, y)
    out = {"model": "resnet50_v1 + softmax_rtc head (eager)",
           "dtype": "bfloat16 (logits f32)", "batch": RESNET_BATCH,
           "steps": CUSTOM_STEPS, "warmup_steps": CUSTOM_WARMUP,
           "warmup_s": warm_s, "step_ms": wall / CUSTOM_STEPS * 1e3,
           "img_per_s": RESNET_BATCH * CUSTOM_STEPS / wall,
           "loss_first": vals[0], "loss_last5_mean": sum(vals[-5:]) / 5,
           "losses": vals[CUSTOM_WARMUP:],
           "samples_with_p_label_0_per_step": zero_p, "launches": launches,
           "launches_per_step_ok": counts_ok,
           "head_grad_max_abs_err": grad_err, "head_grad_tol": HEAD_GRAD_TOL,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": nvidia_smi()}
    log("resnet_custom: " + json.dumps(out))
    if not (finite and falling and counts_ok and grad_err <= HEAD_GRAD_TOL):
        raise SystemExit(f"ResNet training with the custom head failed: "
                         f"finite={finite} falling={falling} launches per "
                         f"step ok={counts_ok} head grad err={grad_err}")
    out["checkpoint"] = _checkpoint_resume(net, trainer, dev, x, y)
    log("resnet_custom: checkpoint and resume: " +
        json.dumps(out["checkpoint"]))
    if not out["checkpoint"]["bitwise_equal"]:
        raise SystemExit("the resumed step differs from the uninterrupted "
                         "one")
    train_err = out["checkpoint"]["head_step_vs_cross_entropy_step"][
        "logits_grad_train_mode_max_abs"]
    if not train_err <= HEAD_GRAD_TOL:
        raise SystemExit(f"the head's gradient on train-mode logits is "
                         f"{train_err} from cross entropy's")
    out["profile"] = phase_train_profile(
        lambda: _custom_step(net, trainer, x, y),
        f"ResNet-50 eager step with the softmax_rtc head at "
        f"batch {RESNET_BATCH}")
    del net, trainer, x, y
    torch.cuda.empty_cache()
    # the same eager loop with cross entropy in the head's place: whether
    # the gap to phase 7's fused curve belongs to the head or to the loop
    curves = {"softmax_rtc_head_eager": vals,
              "cross_entropy_f32_logits_eager": _ce_curve(dev, True),
              "cross_entropy_bf16_logits_eager": _ce_curve(dev, False)}
    out["loss_curves"] = curves
    log("resnet_custom: loss curves (warm-up and timed steps): " +
        json.dumps({k: {"first": v[0], "last5_mean": sum(v[-5:]) / 5,
                        "curve": v} for k, v in curves.items()}))
    return out


# ---------------------------------------------------------------------------
# phase 11: the LSTM word language model (BASELINE config 5)
# ---------------------------------------------------------------------------
# benchmark/rnn_lm_bench.py's shape, the reference's example/rnn "medium"
# word LM: vocab 10000, embedding = hidden = 650, 2 LSTM layers, bptt 35
RNN_VOCAB, RNN_UNITS, RNN_LAYERS, RNN_BPTT = 10000, 650, 2, 35
RNN_BATCHES = (32, 128)
RNN_WARMUP, RNN_STEPS = 3, 20
# examples/rnn/word_lm.py's loop: buckets, batch, gradient clipping
WORD_LM_BUCKETS = (10, 20, 30)
WORD_LM_BATCH = 32
WORD_LM_CLIP = 0.25
WORD_LM_DROPOUT = 0.5
WORD_LM_BATCHES = 400
WORD_LM_SENTENCES = 6000
WORD_LM_TRACED = 2
# each token follows its predecessor through a fixed permutation with
# this probability, and is uniform otherwise
WORD_LM_FOLLOW = 0.9
# the mean loss of the last 10 of the 400 batches must be below the
# first 10's by this many nats: about half of the 1.255 nats the loop
# falls at width 650 on an H100 (9.2095 -> 7.9544, the same in two runs
# of this phase).  On the CPU (``python3 chip_smoke.py --word-lm-curve
# 64``, and ``256``) the loss sits near ln 10000 for ~150-200 batches,
# then falls; over the 400 batches by 0.23 nats at width 64 and 0.62 at
# width 256
WORD_LM_MARGIN = 0.6
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::matmul", "aten::linear")


def rnn_lm_flops_per_token(head=True):
    """``rnn_lm_bench.flops_per_token``: 3 x (forward) with the forward
    2 x 4H(in + H) a layer, plus 2 H V for the vocabulary head."""
    fwd = RNN_LAYERS * 8.0 * RNN_UNITS * (RNN_UNITS + RNN_UNITS)
    if head:
        fwd += 2.0 * RNN_UNITS * RNN_VOCAB
    return 3.0 * fwd


def rnn_lm_models(dev, seed=0, dtype="bfloat16"):
    """``rnn_lm_bench.py``'s WordLM (Embedding -> LSTM(TNC) -> Dense over
    the vocabulary) from the port's blocks, random weights from
    ``seed``, cast to ``dtype``; and its LMLoss: -mean(pick(log_softmax
    of the f32 logits))."""
    import torch
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import HybridBlock, nn, rnn

    vocab, units, layers = RNN_VOCAB, RNN_UNITS, RNN_LAYERS

    class WordLM(HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, units)
            self.lstm = rnn.LSTM(units, num_layers=layers, layout="TNC",
                                 input_size=units)
            self.decoder = nn.Dense(vocab, flatten=False, in_units=units)

        def forward(self, data):
            return self.decoder(self.lstm(self.embed(data)))

    class LMLoss(HybridBlock):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, data, target):
            logp = npx.log_softmax(self.m(data).float(), axis=-1)
            return -mnp.mean(npx.pick(logp, target, axis=-1))

    model = WordLM()
    model.initialize(ctx=dev, generator=torch.Generator().manual_seed(seed))
    if dtype != "float32":
        model.cast(dtype)
    return model, LMLoss(model)


def rnn_lm_tokens(dev, batch, seed=31):
    """Random (bptt, batch) int32 tokens and targets, as
    ``rnn_lm_bench.py`` makes them, from ``seed``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, RNN_VOCAB, (RNN_BPTT, batch),
                               generator=gen, dtype=torch.int32).to(dev)
                 for _ in range(2))


def _gemm_input_types(fn, path):
    """Run ``fn()`` under ``torch.profiler`` with shapes recorded and
    return {GEMM op: sorted input types} from the trace it exports to
    ``path``: every matrix product the host dispatched, backward
    included."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts, record_shapes=True) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    path.unlink()
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    found = collections.defaultdict(collections.Counter)
    for evt in events:
        if evt.get("name") in GEMM_OPS:
            types = tuple(t for t in evt.get("args", {}).get("Input type", ())
                          if t and t != "Scalar")
            found[evt["name"]][",".join(types)] += 1
    return {k: dict(v) for k, v in found.items()}


def _rnn_lm_bound(model, trainer, batch):
    """The least time of one training step on the card: its operations
    (``rnn_lm_flops_per_token`` x tokens) at the bf16 peak, or its bytes
    (every weight and optimizer state read and written once, the tokens
    and targets read) at HBM's rate, whichever is larger."""
    n_par = sum(p.data().numel() * p.data().element_size()
                for p in model.collect_params().values())
    n_state = sum(x.numel() * x.element_size()
                  for st in trainer._states.values() for x in st
                  if x is not None)
    nbytes = 2 * (n_par + n_state) + 2 * RNN_BPTT * batch * 4
    flops = rnn_lm_flops_per_token() * RNN_BPTT * batch
    ms, by = _bound_ms("bfloat16", nbytes, flops)
    return ms, by, {"bytes": nbytes, "flops": flops}


def _rnn_lm_step(dev, batch, detail):
    """``rnn_lm_bench.py``'s training step at ``batch``: bf16, SGD lr 1.0
    momentum 0.9 through a captured `FusedTrainStep`, RNN_WARMUP
    warm-up and RNN_STEPS timed replays; with ``detail``, also the eager
    step against a new step's first call and a replay, the bf16 states
    and products, the eager step's trace."""
    import pathlib

    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer

    torch.cuda.reset_peak_memory_stats()
    model, mod = rnn_lm_models(dev)
    args = rnn_lm_tokens(dev, batch)
    trainer = Trainer(model.collect_params(), "sgd",
                      {"learning_rate": 1.0, "momentum": 0.9})
    step = FusedTrainStep(mod, trainer)
    t0 = time.perf_counter()
    losses = [step(*args, batch_size=batch) for _ in range(RNN_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(RNN_STEPS):
        losses.append(step(*args, batch_size=batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals, finite, falling = _loss_gates(losses)
    tokens = batch * RNN_BPTT
    bound_ms, bound_by, work = _rnn_lm_bound(model, trainer, batch)
    label = f"replayed LSTM LM step at ({RNN_BPTT}, {batch})"
    prof = phase_train_profile(lambda: step(*args, batch_size=batch), label)
    host_calls = sum(prof["host_launch_calls"].values())
    eager_step, eager_ms, _ = _eager_steps(mod, trainer, args, batch, 2, 5,
                                           dict)
    out = {"model": "rnn_lm_bench WordLM (V 10000, E = H = 650, 2 layers)",
           "dtype": "bfloat16", "batch": batch, "bptt": RNN_BPTT,
           "warmup_steps": RNN_WARMUP, "steps": RNN_STEPS,
           "warmup_s": warm_s, "step_ms": wall / RNN_STEPS * 1e3,
           "tokens_per_s": tokens * RNN_STEPS / wall,
           "eager_step_ms": eager_ms,
           "eager_tokens_per_s": tokens / eager_ms * 1e3,
           "device_ms": prof["device_ms_traced"],
           "idle_share": prof["idle_share"],
           "kernels_per_replay": prof["kernel_launches"],
           "host_launch_calls_per_replay": host_calls,
           "host_syncs_per_replay": prof["host_syncs_per_step"],
           "top_kernels_ms": prof["top_kernels_ms"][:5],
           "captures": step.captures,
           "bound_ms": bound_ms, "bound_by": bound_by, **work,
           "flops_per_token": rnn_lm_flops_per_token(),
           "loss_first": vals[0], "loss_last5_mean": sum(vals[-5:]) / 5,
           "losses": vals, "peak_mem_gb": prof["peak_mem_gb"],
           "card": nvidia_smi()}
    ok = finite and falling and step.captures == 1 and host_calls == 1 \
        and prof["host_syncs_per_step"] == 0
    if detail:
        eager_prof = phase_train_profile(
            eager_step, f"eager LSTM LM step at ({RNN_BPTT}, {batch})")
        out["eager_device_ms"] = eager_prof["device_ms_traced"]
        out["eager_idle_share"] = eager_prof["idle_share"]
        out["eager_kernels"] = eager_prof["kernel_launches"]
        out["eager_host_launch_calls"] = sum(
            eager_prof["host_launch_calls"].values())
        folder = pathlib.Path(__file__).resolve().parent / "build" / \
            "chip_smoke"
        folder.mkdir(parents=True, exist_ok=True)
        gemms = _gemm_input_types(eager_step, folder / "rnn_lm_trace.json")
        f32_gemms = {op: {t: n for t, n in types.items() if "float" in
                          t.split(",")}
                     for op, types in gemms.items()}
        f32_gemms = {op: t for op, t in f32_gemms.items() if t}
        with torch.no_grad():
            lstm = model.lstm
            _, (hn, cn) = lstm(model.embed(args[0]),
                               lstm.begin_state(batch, ctx=dev))
        out["gemm_input_types"] = gemms
        out["f32_gemms"] = f32_gemms
        out["state_dtypes"] = [str(hn.dtype), str(cn.dtype)]
        bf16_ok = not f32_gemms and hn.dtype == cn.dtype == torch.bfloat16
        out["bf16_throughout"] = bf16_ok
        ok = ok and bf16_ok
    log(f"rnn_lm: step at batch {batch}: " + json.dumps(out))
    if not ok:
        raise SystemExit(
            f"the LSTM LM step at batch {batch} failed: finite={finite} "
            f"falling={falling} captures={step.captures} host launch "
            f"calls={host_calls} syncs={prof['host_syncs_per_step']} "
            f"bf16 throughout={out.get('bf16_throughout')}")
    if detail:
        out["eager_vs_fused"] = _eager_vs_fused(mod, trainer, args,
                                                what="LSTM LM fused",
                                                batch=batch)
        out["eager_vs_replay"] = _eager_vs_fused(
            mod, trainer, args,
            lambda: _replay_with(step, args, 77, batch=batch),
            what="LSTM LM replayed", batch=batch)
    del step, eager_step, trainer, mod, model
    torch.cuda.empty_cache()
    return out


def _lstm_yardstick(dev):
    """Off the path: cuDNN's fused LSTM (``torch.nn.LSTM(650, 650,
    num_layers=2)`` in bf16) forward and backward over a (35, batch, 650)
    input, by CUDA events and by device time; beside it the port's
    ``rnn.LSTM`` alone on the same input and upstream gradient; and the
    recurrence's bound (its operations at the bf16 peak)."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import rnn

    batch = RNN_BATCHES[0]
    gen = torch.Generator().manual_seed(41)
    x = torch.randn(RNN_BPTT, batch, RNN_UNITS, generator=gen).to(
        dev, torch.bfloat16)
    dy = torch.randn(RNN_BPTT, batch, RNN_UNITS, generator=gen).to(
        dev, torch.bfloat16)
    port = rnn.LSTM(RNN_UNITS, num_layers=RNN_LAYERS, input_size=RNN_UNITS)
    port.initialize(ctx=dev, generator=torch.Generator().manual_seed(42))
    port.cast("bfloat16")
    weights = [p.data() for p in port.collect_params().values()]

    def port_step():
        with autograd.record():
            out = port(x)
        return torch.autograd.grad(out, weights, dy)

    out = {"shape": [RNN_BPTT, batch, RNN_UNITS], "layers": RNN_LAYERS,
           "dtype": "bfloat16", "port_ms": cuda_ms(port_step, iters=10),
           "port_device_ms": device_ms(port_step, iters=5)}
    cudnn = torch.nn.LSTM(RNN_UNITS, RNN_UNITS,
                          num_layers=RNN_LAYERS).to(dev, torch.bfloat16)
    # one contiguous weight buffer, as cuDNN wants it (else every call
    # compacts the weights first)
    cudnn.flatten_parameters()
    cparams = list(cudnn.parameters())

    def cudnn_step():
        y, _ = cudnn(x)
        return torch.autograd.grad(y, cparams, dy)

    out["cudnn_ms"] = cuda_ms(cudnn_step, iters=10)
    out["cudnn_device_ms"] = device_ms(cudnn_step, iters=5)
    flops = rnn_lm_flops_per_token(head=False) * RNN_BPTT * batch
    nbytes = 2 * sum(w.numel() * w.element_size() for w in weights) + \
        2 * x.numel() * x.element_size() * 2
    out["bound_ms"], out["bound_by"] = _bound_ms("bfloat16", nbytes, flops)
    out["card"] = nvidia_smi()
    log("rnn_lm: yardstick (not on the path): " + json.dumps(out))
    return out


def learnable_corpus(seed, vocab, n_sentences, follow=WORD_LM_FOLLOW,
                     lengths=(5, 30)):
    """Sentences of ids 1..vocab-1, lengths in [5, 30) as
    ``examples/rnn/word_lm.py`` draws them: the first token uniform,
    each next one the image of its predecessor under a fixed random
    permutation with probability ``follow``, uniform otherwise."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    succ = onp.concatenate([[0], 1 + rng.permutation(vocab - 1)])
    sentences = []
    for n in rng.integers(lengths[0], lengths[1], n_sentences):
        toks = rng.integers(1, vocab, n)
        keep = rng.random(n) < follow
        for i in range(1, n):
            if keep[i]:
                toks[i] = succ[toks[i - 1]]
        sentences.append(toks.tolist())
    return sentences


def word_lm_setup(dev, seed=0, units=RNN_UNITS):
    """``examples/rnn/word_lm.py``'s pieces: `RNNModel(vocab, units,
    units, 2, "lstm", dropout=0.5, tie_weights=True)` Xavier-initialized
    from ``seed`` in f32, SGD at lr 1.0, SoftmaxCrossEntropyLoss, and
    `BucketSentenceIter` over `learnable_corpus`."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.io import BucketSentenceIter
    from mxnet_tpu_torch.models import RNNModel

    vocab = RNN_VOCAB
    model = RNNModel(vocab, units, units, RNN_LAYERS, "lstm",
                     dropout=WORD_LM_DROPOUT, tie_weights=True)
    model.initialize(init=mx.init.Xavier(), ctx=dev,
                     generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model.collect_params(), "sgd", {"learning_rate": 1.0})
    onp.random.seed(seed)          # the iterator shuffles with numpy's
    it = BucketSentenceIter(learnable_corpus(seed, vocab,
                                             WORD_LM_SENTENCES),
                            WORD_LM_BATCH, buckets=list(WORD_LM_BUCKETS),
                            layout="TN")
    return model, trainer, SoftmaxCrossEntropyLoss(), it


def word_lm_batches(it, n):
    """``n`` batches of ``it``, starting over at its end."""
    out = []
    while len(out) < n:
        it.reset()
        out.extend(b for _, b in zip(range(n - len(out)), it))
    return out


def word_lm_step(model, trainer, loss_fn, batch, dev, generator):
    """One batch of the example's loop: record, loss, backward,
    ``clip_global_norm(..., 0.25)``, ``Trainer.step``."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    data = batch.data[0].to(dev)
    label = batch.label[0].to(dev)
    with autograd.record(generator=generator):
        loss = loss_fn(model(data), label).mean()
    loss.backward()
    clip_global_norm([p.grad() for p in model.collect_params().values()
                      if p.grad_req != "null"], WORD_LM_CLIP)
    trainer.step(WORD_LM_BATCH)
    return loss.detach()


def _inter_layer_mask_check(dev):
    """The mask between the LSTM layers from one draw's key words, on
    the card and by the plain CPU computation: bitwise equal."""
    import torch
    from mxnet_tpu_torch.gluon.rnn.rnn_layer import inter_layer_mask
    from mxnet_tpu_torch.ops.seeds import DRAWS, words_tensor
    words = DRAWS["rnn"](torch.Generator().manual_seed(9))
    shape = (max(WORD_LM_BUCKETS), WORD_LM_BATCH, RNN_UNITS)
    keep = 1.0 - WORD_LM_DROPOUT
    on_card = inter_layer_mask(words_tensor(words, dev), 0, keep, shape)
    plain = inter_layer_mask(words_tensor(words, "cpu"), 0, keep, shape)
    equal = bool(torch.equal(on_card.cpu(), plain))
    return {"key_words": list(words), "shape": list(shape),
            "keep_share": float(plain.float().mean()), "bitwise": equal}


def _word_lm(dev):
    """``examples/rnn/word_lm.py``'s eager loop at the medium width, f32,
    on `learnable_corpus`: WORD_LM_BATCHES batches timed, then
    WORD_LM_TRACED more traced (the dropout kernel's launches on the
    card), one train-mode forward traced alone."""
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops.nn import DROPOUT, DROPOUT_BWD

    torch.cuda.reset_peak_memory_stats()
    model, trainer, loss_fn, it = word_lm_setup(dev)
    batches = word_lm_batches(it, WORD_LM_BATCHES + WORD_LM_TRACED + 1)
    gen = torch.Generator().manual_seed(7)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[:WORD_LM_BATCHES]:
        losses.append(word_lm_step(model, trainer, loss_fn, batch, dev, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(b.data[0].numel() for b in batches[:WORD_LM_BATCHES])
    vals = torch.stack(losses).cpu().tolist()
    first, last = sum(vals[:10]) / 10, sum(vals[-10:]) / 10
    finite = all(v == v and abs(v) != float("inf") for v in vals)
    def reset():
        DROPOUT.launches = DROPOUT_BWD.launches = 0
    reset()
    traced_batches = batches[WORD_LM_BATCHES:WORD_LM_BATCHES +
                             WORD_LM_TRACED]
    _, traced = traced_launches(lambda: [
        word_lm_step(model, trainer, loss_fn, b, dev, gen)
        for b in traced_batches], reset)
    booked, booked_bwd = DROPOUT.launches, DROPOUT_BWD.launches
    reset()
    fwd_batch = batches[-1]

    def forward_only():
        with autograd.record(generator=gen):
            return model(fwd_batch.data[0].to(dev))

    _, fwd_traced = traced_launches(forward_only, reset)
    fwd_booked = DROPOUT.launches
    mask = _inter_layer_mask_check(dev)
    out = {"model": "RNNModel(10000, 650, 650, 2, lstm, dropout 0.5, tied)",
           "dtype": "float32", "batch": WORD_LM_BATCH,
           "buckets": list(WORD_LM_BUCKETS), "batches": WORD_LM_BATCHES,
           "corpus": f"learnable_corpus: follow a fixed permutation with "
                     f"p {WORD_LM_FOLLOW}, else uniform; "
                     f"{WORD_LM_SENTENCES} sentences",
           "batch_ms": wall / WORD_LM_BATCHES * 1e3,
           "tokens_per_s": tokens / wall,
           "loss_first10_mean": first, "loss_last10_mean": last,
           "margin": WORD_LM_MARGIN, "losses": vals,
           "traced_batches": WORD_LM_TRACED,
           "dropout_launches": traced["dropout"],
           "dropout_launches_booked": booked,
           "dropout_bwd_launches": traced["dropout_bwd"],
           "dropout_bwd_launches_booked": booked_bwd,
           "dropout_launches_forward_alone": fwd_traced["dropout"],
           "dropout_launches_forward_alone_booked": fwd_booked,
           "inter_layer_mask": mask,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": nvidia_smi()}
    log("rnn_lm: word_lm loop: " + json.dumps(out))
    # nn.Dropout on the embedding and on the LSTM's output: two launches
    # a forward, two more in the backward (the backward kernel's)
    launches_ok = traced["dropout"] == booked == 4 * WORD_LM_TRACED and \
        traced["dropout_bwd"] == booked_bwd == 2 * WORD_LM_TRACED and \
        fwd_traced["dropout"] == fwd_booked == 2 and \
        fwd_traced["dropout_bwd"] == 0
    if not (finite and last < first - WORD_LM_MARGIN and launches_ok and
            mask["bitwise"]):
        raise SystemExit(
            f"the word LM loop failed: finite={finite} first10={first} "
            f"last10={last} margin={WORD_LM_MARGIN} dropout launches "
            f"ok={launches_ok} mask bitwise={mask['bitwise']}")
    del model, trainer
    torch.cuda.empty_cache()
    return out


def word_lm_curve(units, n_batches):
    """The word-LM loop of `_word_lm` on the CPU at embedding = hidden =
    ``units`` (vocab, corpus, buckets, dropout, clipping and lr as on the
    card) for ``n_batches``: the mean loss of every 10 batches, printed.
    What WORD_LM_MARGIN was fixed from."""
    import torch
    dev = torch.device("cpu")
    model, trainer, loss_fn, it = word_lm_setup(dev, units=units)
    gen = torch.Generator().manual_seed(7)
    vals = [float(word_lm_step(model, trainer, loss_fn, b, dev, gen))
            for b in word_lm_batches(it, n_batches)]
    for i in range(0, n_batches, 10):
        log(f"word_lm_curve: width {units} batches {i}-{i + 9}: mean loss "
            f"{sum(vals[i:i + 10]) / len(vals[i:i + 10])}")


def phase_rnn_lm(dev):
    """BASELINE config 5 on the card: (a) ``rnn_lm_bench.py``'s captured
    bf16 step at batch 32 and 128, with cuDNN's LSTM as a yardstick off
    the path; (b) ``examples/rnn/word_lm.py``'s eager f32 loop with
    dropout, tied weights and gradient clipping."""
    out = {"bench": [_rnn_lm_step(dev, b, detail=(b == RNN_BATCHES[0]))
                     for b in RNN_BATCHES],
           "yardstick": _lstm_yardstick(dev),
           "word_lm": _word_lm(dev)}
    return out


# ---------------------------------------------------------------------------
# phase 11: BASELINE config 1, Gluon LeNet (benchmark/lenet_mnist_bench.py)
# ---------------------------------------------------------------------------
# the bench's batch, warm-ups and three windows (best of three), each
# sized to about LENET_WINDOW_S; then replays on the one fixed batch
# whose losses must fall
LENET_BATCH, LENET_WARMUP, LENET_WINDOWS, LENET_WINDOW_S = 256, 5, 3, 1.0
LENET_FALLING = 50


def lenet(nn):
    """The bench's LeNet, no ``in_units`` anywhere."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Conv2D(50, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Flatten(),
            nn.Dense(500, activation="tanh"),
            nn.Dense(10))
    return net


def _windows(fn, batch, n_windows, window_s):
    """img/s of ``n_windows`` back-to-back windows of ``fn()`` calls,
    each sized from a probe of 3 calls to last about ``window_s``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) / 3
    iters = int(min(max(window_s / max(est, 1e-5), 10), 5000))
    rates = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        rates.append(batch * iters / (time.perf_counter() - t0))
    return rates, iters


def phase_lenet(dev):
    """BASELINE config 1 as `benchmark/lenet_mnist_bench.py` runs it:
    LeNet cast to bf16, batch 256, SGD lr 0.1 momentum 0.9 through a
    captured `FusedTrainStep`, the mean loss; what the number measures is
    the framework's overhead per step (the model is ~0.4 MFLOP an
    image).  Gates: one capture, 0 host syncs a replay, eager and fused
    within one bf16 ulp, finite losses falling over 50 replays."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    b = LENET_BATCH
    net = lenet(nn)
    net.initialize(ctx=dev, generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")

    class WithLoss(HybridBlock):
        def __init__(self, m):
            super().__init__()
            self.m = m
            self.loss = SoftmaxCrossEntropyLoss()

        def forward(self, x, y):
            return self.loss(self.m(x), y).mean()

    mod = WithLoss(net)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(b, 1, 28, 28, generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, 10, (b,), generator=gen, device=dev,
                      dtype=torch.int32)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    step = FusedTrainStep(mod, trainer)

    def one():
        return step(x, y, batch_size=b)

    warm = [one() for _ in range(LENET_WARMUP)]
    rates, iters = _windows(one, b, LENET_WINDOWS, LENET_WINDOW_S)
    losses = warm + [one() for _ in range(LENET_FALLING)]
    vals, finite, falling = _loss_gates(losses)
    eager_step, eager_ms, _ = _eager_steps(mod, trainer, (x, y), b, 3, 20,
                                           lambda: {})
    out = {"model": "LeNet (bench)", "dtype": "bfloat16", "batch": b,
           "dense_in_units": net[5].weight.shape[1],
           "window_iters": iters, "window_img_per_s": rates,
           "img_per_s": max(rates), "step_ms": b / max(rates) * 1e3,
           "eager_step_ms": eager_ms, "loss_first": vals[0],
           "loss_last5_mean": sum(vals[-5:]) / 5, "captures": step.captures,
           "card": nvidia_smi()}
    out["eager_vs_fused"] = _resnet_eager_vs_fused(mod, trainer, (x, y),
                                                   batch=b, label="lenet")
    out["profile"] = phase_train_profile(
        one, f"replayed LeNet training step at batch {b}")
    out["eager_profile"] = phase_train_profile(
        eager_step, f"eager LeNet training step at batch {b}")
    log("lenet: " + json.dumps(out))
    syncs = out["profile"]["host_syncs_per_step"]
    if not (finite and falling and step.captures == 1 and syncs == 0 and
            out["dense_in_units"] == 800):
        raise SystemExit(f"LeNet training failed: finite={finite} "
                         f"falling={falling} captures={step.captures} "
                         f"host syncs a replay={syncs}")
    del step, trainer, mod, net
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: examples/gluon/mnist_mlp.py's loop
# ---------------------------------------------------------------------------
# the example's synthetic stand-in (2048 x (1, 28, 28)), batch 128, 2
# epochs, with labels that can be learned: the argmax of a fixed seeded
# linear map of x
MNIST_N, MNIST_BATCH, MNIST_EPOCHS, MNIST_LR = 2048, 128, 2, 0.1
# accuracy above chance (0.1) the second epoch must reach: half of what
# the same loop reaches on the CPU (`--mnist-mlp-curve`: 0.1226 after
# epoch 2, 0.0226 above chance).  The example's hyperparameters give the
# MLP 32 SGD steps on 784 pixels of noise, so it learns little; the gate
# also holds the accuracy above the largest class's share (0.1147),
# which guessing that class would reach
MNIST_MARGIN = 0.011


def mnist_data(seed=0):
    """(x, y) numpy arrays: x uniform in [0, 1), (MNIST_N, 1, 28, 28) f32;
    y the argmax of (x - 0.5) @ W for a fixed seeded W (centred, so the
    ten classes come out about equally often), as f32 labels."""
    import numpy as onp
    rng = onp.random.default_rng(seed)
    x = rng.random((MNIST_N, 1, 28, 28), dtype=onp.float32)
    w = rng.standard_normal((784, 10)).astype(onp.float32)
    y = ((x.reshape(MNIST_N, -1) - 0.5) @ w).argmax(-1).astype(onp.float32)
    return x, y


def mnist_mlp_loop(dev, log_epoch=None):
    """The example's loop on ``dev``: the MLP with no ``in_units``,
    ``initialize(init=Xavier())``, ``hybridize()``, SGD through
    ``Trainer``, SoftmaxCrossEntropyLoss, ``metric.Accuracy``, the data
    through ``ArrayDataset`` and a shuffling ``DataLoader``.  Returns
    each epoch's (accuracy, ms a batch)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn

    import numpy as onp
    onp.random.seed(0)      # the DataLoader's shuffle draws from numpy's
    x, y = mnist_data()
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"),
            nn.Dense(10))
    net.initialize(init=mx.init.Xavier(), ctx=dev,
                   generator=torch.Generator().manual_seed(1))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": MNIST_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = gluon.metric.Accuracy()
    data = gluon.data.DataLoader(gluon.data.ArrayDataset(x, y), MNIST_BATCH,
                                 shuffle=True, device=dev)
    epochs = []
    for epoch in range(MNIST_EPOCHS):
        metric.reset()
        n = 0
        t0 = time.perf_counter()
        for xb, yb in data:
            xb = xb.reshape(xb.shape[0], -1)
            with autograd.record():
                out = net(xb)
                loss = loss_fn(out, yb)
            autograd.backward(loss)
            trainer.step(xb.shape[0])
            metric.update(yb, out)
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        name, acc = metric.get()
        epochs.append({"epoch": epoch, name: acc, "ms_per_batch": ms,
                       "batches": n})
        if log_epoch:
            log_epoch(epochs[-1])
    return epochs


def phase_mnist_mlp(dev):
    """`examples/gluon/mnist_mlp.py`, eager as the example runs it (each
    batch's metric update reads the output on the host).  Gate: the last
    epoch's accuracy above chance by `MNIST_MARGIN` and above the
    largest class's share."""
    import numpy as onp
    epochs = mnist_mlp_loop(dev, lambda e: log("mnist_mlp: " +
                                               json.dumps(e)))
    acc = epochs[-1]["accuracy"]
    majority = float(onp.bincount(mnist_data()[1].astype(int)).max()
                     / MNIST_N)
    out = {"epochs": epochs, "margin": MNIST_MARGIN,
           "largest_class_share": majority, "card": nvidia_smi()}
    log("mnist_mlp: " + json.dumps(out))
    if not acc > max(0.1 + MNIST_MARGIN, majority):
        raise SystemExit(f"mnist_mlp learned nothing: accuracy {acc} after "
                         f"{MNIST_EPOCHS} epochs")
    return out


# ---------------------------------------------------------------------------
# phase 13: the model zoo as examples/image-classification/
# train_imagenet.py trains it, on its synthetic batches
# ---------------------------------------------------------------------------
ZOO = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
       ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
       ("densenet121", 224), ("inceptionv3", 299))
ZOO_BATCH, ZOO_WARMUP, ZOO_STEPS, ZOO_FREQUENT = 64, 3, 10, 5
ZOO_EAGER_CHECK = "mobilenetv2_1.0"


class _Collect(logging.Handler):
    """A logging handler that keeps the messages it is handed."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _zoo_net(name, side, dev):
    """One family's network, trained as `train_imagenet.py` does: step ms
    and img/s over `ZOO_STEPS` replays (after `ZOO_WARMUP` calls) at
    batch 64 in bf16, `mx.callback.Speedometer` over the replays (it
    reads the host's clock without a sync, so its first lines count
    steps queued, not done), peak memory, B1's launches a step by the
    trace and by the wrapper, and one replay's profile."""
    from collections import namedtuple

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer
    from mxnet_tpu_torch.gluon.model_zoo import vision

    torch.cuda.reset_peak_memory_stats()
    net = vision.get_model(name)
    net.initialize(init=mx.init.Xavier(), ctx=[dev],
                   generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    mod = net_with_loss(net)
    gen = torch.Generator(device=dev).manual_seed(23)
    x = (torch.rand(ZOO_BATCH, 3, side, side, generator=gen, device=dev)
         * 2 - 1).to(torch.bfloat16)
    y = torch.randint(0, 1000, (ZOO_BATCH,), generator=gen, device=dev,
                      dtype=torch.int32)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    # dropout (AlexNet, VGG, SqueezeNet, Inception) draws its seed words
    # from this generator, a fresh pair at each replay
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(29))
    warm = [step(x, y, batch_size=ZOO_BATCH) for _ in range(ZOO_WARMUP)]
    n_bn = sum(k.endswith("running_mean") for k in net.collect_params())
    expect = {"bn_bwd_reduce": n_bn, "bn_bwd_reduce_rows": 0,
              "stem_conv": 0}
    speed = mx.callback.Speedometer(ZOO_BATCH, frequent=ZOO_FREQUENT)
    param = namedtuple("P", ["epoch", "nbatch", "eval_metric"])
    collect = _Collect()
    root = logging.getLogger()
    level = root.level
    root.addHandler(collect)
    root.setLevel(logging.INFO)
    try:
        speed(param(0, 0, None))
        losses, wall, launches, counts_ok = _train_steps(
            _Speedo(step, speed, param), (x, y), ZOO_STEPS, expect,
            batch=ZOO_BATCH, label=name)
    finally:
        root.removeHandler(collect)
        root.setLevel(level)
    vals, finite, _ = _loss_gates(warm + losses)
    out = {"model": name, "input": [ZOO_BATCH, 3, side, side],
           "dtype": "bfloat16", "steps": ZOO_STEPS,
           "step_ms": wall / ZOO_STEPS * 1e3,
           "img_per_s": ZOO_BATCH * ZOO_STEPS / wall,
           "speedometer": collect.messages,
           "batchnorms": n_bn, "b1_launches_per_step": n_bn,
           "launches": launches["traced"],
           "launches_booked": launches["booked"],
           "launches_per_step_ok": counts_ok, "captures": step.captures,
           "loss_first": vals[0], "loss_last": vals[-1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if name == ZOO_EAGER_CHECK:
        out["eager_vs_fused"] = _resnet_eager_vs_fused(
            mod, trainer, (x, y), batch=ZOO_BATCH, label=f"zoo {name}")
    out["profile"] = phase_train_profile(
        lambda: step(x, y, batch_size=ZOO_BATCH),
        f"replayed {name} training step at batch {ZOO_BATCH}")
    log("zoo: " + json.dumps(out))
    if not (finite and counts_ok and step.captures == 1):
        raise SystemExit(f"zoo {name} failed: finite={finite} launches per "
                         f"step ok={counts_ok} captures={step.captures}")
    del step, trainer, mod, net, x, y
    torch.cuda.empty_cache()
    return out


class _Speedo:
    """A training step that calls the Speedometer after each replay, as
    `train_imagenet.py`'s loop does."""

    def __init__(self, step, speed, param):
        self.step, self.speed, self.param, self.n = step, speed, param, 0

    def __call__(self, *args, **kwargs):
        loss = self.step(*args, **kwargs)
        self.n += 1
        self.speed(self.param(0, self.n, None))
        return loss


def phase_zoo(dev):
    return [_zoo_net(name, side, dev) for name, side in ZOO]


# ---------------------------------------------------------------------------
# phase 14: data parallelism over parameter copies in one process
# (examples/image-classification/train_imagenet.py's loop, BASELINE config 3)
# ---------------------------------------------------------------------------
# the example's defaults: ResNet-50 v1, f32, batch 64, SGD lr 0.1 momentum 0.9
DP_BATCH, DP_STEPS = 64, 5
# (b): a copy on the card and one on the host, 4 images a copy
DP_HOST_PER_COPY, DP_HOST_STEPS = 4, 3
# (b): the two copies of a trainable parameter after each step.  Both
# take the same reduced gradient; the optimizer's f32 update runs once on
# each device, whose elementwise kernels may round (or fuse a
# multiply-add) differently: a few f32 ulps of the update a step, so
# 1e-5 of max(1, |w|) leaves room for 3 steps of momentum
DP_COPY_TOL = 1e-5
DP_STORE_CALLS = 20


def _dp_net(ctxs, seed=0):
    """``vision.resnet50_v1()`` (1000 classes, f32), Xavier from
    ``seed``, one copy on each of ``ctxs``, hybridized as the example
    does."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1()
    net.initialize(init=mx.init.Xavier(), ctx=ctxs,
                   generator=torch.Generator().manual_seed(seed))
    net.hybridize(static_alloc=True)
    return net


def _dp_batch(n, seed=41):
    """uniform(-1, 1) f32 images and labels below 1000, on the host, from
    ``seed`` (the loop's split_and_load sends them to the copies)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, RESNET_IMAGE, RESNET_IMAGE, generator=gen) * 2 - 1
    y = torch.randint(0, 1000, (n,), generator=gen, dtype=torch.int32)
    return x, y


def _dp_step(net, trainer, loss_fn, ctxs, x, y, split=False):
    """One step of `train_imagenet.py`'s loop: ``split_and_load`` over
    ``ctxs``, a loss a copy, ``autograd.backward``, ``trainer.step``.
    With ``split``, the step's reduce and update run as
    ``allreduce_grads`` and ``update``, each timed to a sync of every
    device.  Returns the losses (detached) and the seconds of the
    forward and backward, the reduce and the update (None without
    ``split``)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.utils import split_and_load

    t0 = time.perf_counter()
    xs, ys = split_and_load(x, ctxs), split_and_load(y, ctxs)
    with mx.autograd.record():
        losses = [loss_fn(net(xb), yb).mean() for xb, yb in zip(xs, ys)]
    mx.autograd.backward(losses)
    if not split:
        trainer.step(x.shape[0])
        return [l.detach() for l in losses], None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.allreduce_grads()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.update(x.shape[0])
    torch.cuda.synchronize()
    return [l.detach() for l in losses], (t1 - t0, t2 - t1,
                                          time.perf_counter() - t2)


def _dp_card(dev):
    """(a): ResNet-50 at full width on ``ctx=[gpu(0)]`` with
    ``kvstore="tpu_ici"``, DP_STEPS steps of the loop on one seeded batch,
    B1's launches counted step by step from 0, each step timed to a sync;
    the same loop with ``kvstore=None`` on a second net from the same
    seed, a step of each in turns; the store's host time a reduce over
    one copy a parameter."""
    import torch
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE

    opt = {"learning_rate": 0.1, "momentum": 0.9}
    loss_fn = SoftmaxCrossEntropyLoss()
    x, y = _dp_batch(DP_BATCH)
    runs = {}
    for store in ("tpu_ici", None):
        net = _dp_net([dev])
        runs[store] = {"net": net, "ms": [], "losses": [], "b1": [],
                       "trainer": Trainer(net.collect_params(), "sgd", opt,
                                          kvstore=store)}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DP_STEPS):
        for store, run in runs.items():
            torch.cuda.synchronize()
            BN_BWD_REDUCE.launches = 0
            t0 = time.perf_counter()
            losses, _ = _dp_step(run["net"], run["trainer"], loss_fn, [dev],
                                 x, y)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["b1"].append(BN_BWD_REDUCE.launches)
            run["losses"].append(float(losses[0]))
    main = runs["tpu_ici"]
    store = main["trainer"].kvstore
    t0 = time.perf_counter()
    for _ in range(DP_STORE_CALLS):
        main["trainer"].allreduce_grads()
    store_us = (time.perf_counter() - t0) / DP_STORE_CALLS * 1e6
    out = {"model": "resnet50_v1", "classes": 1000, "dtype": "float32",
           "input": [DP_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE],
           "ctx": [str(dev)], "kvstore": store.type,
           "kvstore_class": type(store).__name__, "steps": DP_STEPS,
           "losses": main["losses"], "step_ms": main["ms"],
           "median_step_ms": statistics.median(main["ms"][1:]),
           "b1_launches_per_step": main["b1"],
           "no_store": {"kvstore": runs[None]["trainer"].kvstore,
                        "losses": runs[None]["losses"],
                        "step_ms": runs[None]["ms"],
                        "median_step_ms":
                            statistics.median(runs[None]["ms"][1:])},
           "allreduce_host_us_one_copy": store_us,
           "params": len(main["trainer"]._params),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["store_minus_no_store_ms"] = out["median_step_ms"] - \
        out["no_store"]["median_step_ms"]
    finite = all(v == v and abs(v) != float("inf")
                 for run in runs.values() for v in run["losses"])
    b1_ok = all(n == BN_LAYERS for n in main["b1"])
    log("dp: (a) one card copy: " + json.dumps(out))
    if not (finite and b1_ok and store is not None
            and store.type == "tpu_ici"):
        raise SystemExit(f"data-parallel ResNet-50 on one card copy failed: "
                         f"finite={finite} B1 launches a step "
                         f"{main['b1']} (expected {BN_LAYERS}) store={store}")
    del runs, main, store
    torch.cuda.empty_cache()
    return out


def _dp_card_and_host(dev):
    """(b): ResNet-50 on ``ctx=[gpu(0), cpu()]`` with ``kvstore="device"``,
    DP_HOST_PER_COPY images a copy, DP_HOST_STEPS steps: the store sums
    the two copies' gradients on the card and writes the sum to both;
    after each step every trainable parameter's two copies agree within
    DP_COPY_TOL; the reduce's share of the step."""
    import torch
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.utils import split_and_load
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE

    ctxs = [dev, cpu()]
    net = _dp_net(ctxs, seed=1)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      kvstore="device")
    loss_fn = SoftmaxCrossEntropyLoss()
    x, y = _dp_batch(DP_HOST_PER_COPY * len(ctxs), seed=43)
    net._ensure_shapes(split_and_load(x, ctxs)[0])   # draws, then copies
    params = net.collect_params()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    start = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in (p.list_data() for p in trainable))
    steps = []
    for _ in range(DP_HOST_STEPS):
        BN_BWD_REDUCE.launches = 0
        losses, (fb, reduce_s, update_s) = _dp_step(
            net, trainer, loss_fn, ctxs, x, y, split=True)
        worst, name = 0.0, None
        for p in trainable:
            a, b = p.list_data()
            err = float((a.detach().cpu() - b.detach()).abs().max()) / \
                max(1.0, float(b.detach().abs().max()))
            if err >= worst:
                worst, name = err, p.name
        stats = params["features.1.running_mean"].list_data()
        total = fb + reduce_s + update_s
        steps.append({
            "losses": [float(l) for l in losses],
            "forward_backward_ms": fb * 1e3, "reduce_ms": reduce_s * 1e3,
            "update_ms": update_s * 1e3, "reduce_share": reduce_s / total,
            "b1_launches_card_copy": BN_BWD_REDUCE.launches,
            "copies_max_rel_diff": worst, "worst_param": name,
            "stem_bn_running_mean_copies_differ": not torch.equal(
                stats[0].cpu(), stats[1])})
    out = {"model": "resnet50_v1", "dtype": "float32",
           "ctx": [str(c) for c in ctxs], "kvstore": "device",
           "kvstore_class": type(trainer.kvstore).__name__,
           "images_per_copy": DP_HOST_PER_COPY, "copies_start_max_diff": start,
           "tolerance": DP_COPY_TOL, "steps": steps}
    log("dp: (b) a card copy and a host copy: " + json.dumps(out))
    finite = all(v == v and abs(v) != float("inf")
                 for s in steps for v in s["losses"])
    agree = start == 0.0 and all(s["copies_max_rel_diff"] <= DP_COPY_TOL
                                 for s in steps)
    b1_ok = all(s["b1_launches_card_copy"] == BN_LAYERS for s in steps)
    if not (finite and agree and b1_ok):
        raise SystemExit(f"the card and host copies failed: finite={finite} "
                         f"copies agree={agree} (start {start}, "
                         f"{[s['copies_max_rel_diff'] for s in steps]}) "
                         f"B1 a step on the card copy "
                         f"{[s['b1_launches_card_copy'] for s in steps]}")
    del net, trainer
    torch.cuda.empty_cache()
    return out


def _dp_nccl(dev):
    """(c): `TPUICIStore`'s branch for copies on distinct cards, one NCCL
    all-reduce, against the plain sum; run only with two cards or more."""
    import torch
    from mxnet_tpu_torch import kv

    n = torch.cuda.device_count()
    if n < 2:
        out = {"run": False,
               "why": f"{n} card: the branch for copies on distinct cards "
                      "(torch.cuda.nccl.all_reduce) needs two or more"}
        log("dp: (c) NCCL branch: " + json.dumps(out))
        return out
    gen = torch.Generator().manual_seed(47)
    host = [torch.randn(1000, 257, generator=gen) for _ in range(n)]
    copies = [h.to(torch.device("cuda", i)) for i, h in enumerate(host)]
    kv.create("tpu_ici").pushpull(0, copies)
    plain = sum(host[1:], host[0])
    err = max(float((c.cpu() - plain).abs().max()) for c in copies)
    out = {"run": True, "cards": n, "max_abs_err": err}
    log("dp: (c) NCCL branch: " + json.dumps(out))
    if not err <= 1e-5:
        raise SystemExit(f"the NCCL all-reduce of the copies is {err} from "
                         "their sum")
    return out


def phase_dp(dev):
    out = {"card_copy": _dp_card(dev),
           "card_and_host_copies": _dp_card_and_host(dev),
           "nccl_copies": _dp_nccl(dev), "card": nvidia_smi()}
    return out


# ---------------------------------------------------------------------------
# phase 15: ranks (processes of a torch.distributed group)
# ---------------------------------------------------------------------------
RANKS_BATCH, RANKS_STEPS, RANKS_CHECK_AFTER = RESNET_BATCH, 5, 3
# (a) and (c) against one rank on the global batch.  Each reading is held
# to RANKS_FACTOR times its distance between one rank on the rows in order
# and one rank on the same rows rolled (the larger over RANKS_ROLLS): the
# yardstick of a change of summation order alone; where the yardstick is
# smaller, the dtype's floor stands in (RANKS_FLOORS: in bf16 two roundings,
# as two ranks round each rank's gradient before the sum; in f32 the CPU
# tests' rtol).  The readings: step 1's per-row losses (the forward), each
# trainable parameter's first update (SGD's f32 momentum after step 1: -lr
# x the rescaled global gradient), and after the last step compared the
# mean loss and every weight at once.  In bf16, the path itself, compared
# over RANKS_CHECK_AFTER steps, BatchNorm's single-pass statistics (the
# reference's) amplify roundings where a channel's mean dwarfs its spread
# (ROADMAP C14): rolled rows move step 1's per-row losses 1 % and most
# parameters' first update by as much as the update itself, so a fault can
# hide there.  The same step in f32 with cuDNN deterministic, one step,
# gives the sharp readings.
RANKS_FACTOR = 3.0
RANKS_FLOORS = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
RANKS_ROLLS = (RANKS_BATCH // 2, RANKS_BATCH // 4)
RANKS_KILL_AFTER, RANKS_DEAD_TIMEOUT = 2, 3.0
RANKS_HEARTBEAT = 0.5
RANKS_TIMEOUT = 300          # seconds a world may take, start-up included
RANKS_TIMED = 10             # replays timed in (b)


def _weight_digest(params):
    """sha256 of every parameter's bytes, in name order (a host copy)."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name].data().detach().contiguous().flatten()
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _timed_collectives(step, args, batch):
    """One more step with every ``torch.distributed`` collective timed on
    its own: the card synchronized and the ranks met at a barrier before
    each (so a rank does not time its peer's kernels on the shared card),
    the card synchronized after it (the step's own time is taken without
    this)."""
    import torch
    import torch.distributed as dist

    spent, calls = [0.0], [0]
    real = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            calls[0] += 1
            return out
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        step(*args, batch_size=batch)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    return spent[0] * 1e3, calls[0]


def _trainable_copy(params):
    """A copy of every trainable parameter's value, by name."""
    return {n: p.data().detach().clone() for n, p in params.items()
            if p.grad_req != "null"}


def _first_updates(net, trainer):
    """Every trainable parameter's SGD momentum after the first step (-lr
    x its first rescaled gradient, in f32), by name."""
    names = {id(p): n for n, p in net.collect_params().items()}
    return {names[id(p)]: trainer._states[i][0].detach().clone()
            for i, p in enumerate(trainer._params) if i in trainer._states}


def _rel(mine, ref):
    """||mine - ref|| / ||ref|| in f32."""
    ref = ref.float()
    return float((mine.float() - ref).norm() / ref.norm())


def _rel_all(mine, ref):
    """||mine - ref|| / ||ref|| over every tensor of ``ref`` at once."""
    diff2 = norm2 = 0.0
    for name, r in ref.items():
        r = r.float()
        diff2 += float((mine[name].float() - r).norm()) ** 2
        norm2 += float(r.norm()) ** 2
    return (diff2 / norm2) ** 0.5


def _deterministic(fn):
    """``fn()`` with cuDNN pinned to its deterministic algorithms."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = prev


def _ranks_resnet(dev, mesh=None, dtype="bfloat16"):
    """ResNet-50 v1 as `bench.py` builds it for the dp mesh (in bf16;
    SoftmaxCrossEntropyLoss, SGD lr 0.1 momentum 0.9), its trainer, its
    step over ``mesh`` (None: the single-device step), and the global
    batch, in ``dtype``."""
    import torch
    from mxnet_tpu_torch.gluon import FusedTrainStep, Trainer

    net = resnet50(dev, dtype=dtype)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    step = FusedTrainStep(net_with_loss(net), trainer, mesh=mesh)
    x, y = resnet_batch(dev)
    return net, trainer, step, (x.to(getattr(torch, dtype)), y)


def _steps_kept(net, trainer, step, args, steps):
    """``steps`` steps: step 1's per-row losses and first updates, and the
    mean loss and the trainable weights after each step."""
    params, run = net.collect_params(), {"means": [], "weights": []}
    for k in range(steps):
        loss = step(*args, batch_size=RANKS_BATCH).float().clone()
        if k == 0:
            run["rows"], run["updates"] = loss, _first_updates(net, trainer)
        run["means"].append(float(loss.mean()))
        run["weights"].append(_trainable_copy(params))
    return run


def _one_rank_runs(dev, dtype, steps):
    """`_steps_kept` of one rank on the global batch in ``dtype``: the
    rows in order and half-rolled for ``steps`` steps, a quarter-rolled
    for one (a roll's per-row losses rolled back)."""
    import torch
    runs = {}
    for shift in (0,) + RANKS_ROLLS:
        net, trainer, step, args = _ranks_resnet(dev, None, dtype)
        if shift:
            args = tuple(a.roll(shift, 0) for a in args)
        run = _steps_kept(net, trainer, step, args,
                          steps if shift in (0, RANKS_ROLLS[0]) else 1)
        run["rows"] = run["rows"].roll(-shift, 0)
        runs[shift] = run
        del net, trainer, step, args
        torch.cuda.empty_cache()
    return runs


def _against_one_rank(dev, dtype, ranks):
    """Rank 0 of (a) and (c): the ranks' `_steps_kept` held against one
    rank's in ``dtype`` (see RANKS_FACTOR)."""
    runs = _one_rank_runs(dev, dtype, len(ranks["means"]))
    one, rolls = runs[0], [runs[s] for s in RANKS_ROLLS]
    half, last = runs[RANKS_ROLLS[0]], len(ranks["means"]) - 1
    floor = RANKS_FLOORS[dtype]

    def held(reading, yardstick):
        return {"ranks": reading, "rolled": yardstick,
                "ratio": reading / max(yardstick, floor),
                "ok": reading <= RANKS_FACTOR * max(yardstick, floor)}

    rows = held(_rel(ranks["rows"], one["rows"]),
                max(_rel(r["rows"], one["rows"]) for r in rolls))
    params = {n: held(_rel(ranks["updates"][n], ref),
                      max(_rel(r["updates"][n], ref) for r in rolls))
              for n, ref in one["updates"].items()}
    mean = abs(one["means"][last])
    loss = held(abs(ranks["means"][last] - one["means"][last]) / mean,
                abs(half["means"][last] - one["means"][last]) / mean)
    weights = held(_rel_all(ranks["weights"][last], one["weights"][last]),
                   _rel_all(half["weights"][last], one["weights"][last]))
    worst = sorted(params, key=lambda n: -params[n]["ratio"])[:5]
    out = {
        "dtype": dtype, "steps": last + 1, "rolls": list(RANKS_ROLLS),
        "factor": RANKS_FACTOR, "floor": floor,
        "one_rank_losses": one["means"], "ranks_losses": ranks["means"],
        "step1_rows": rows,
        "step1_updates_failed": [n for n, p in params.items()
                                 if not p["ok"]],
        "step1_updates_worst": {n: params[n] for n in worst},
        "step1_updates_median": {
            k: statistics.median(p[k] for p in params.values())
            for k in ("ranks", "rolled")},
        "step1_updates": {n: [p["ranks"], p["rolled"]]
                          for n, p in params.items()},
        "loss_after": loss, "weights_after": weights}
    out["ok"] = (rows["ok"] and not out["step1_updates_failed"] and
                 loss["ok"] and weights["ok"])
    return out


def _ranks_dp(dev, out):
    """(a) and (c): RANKS_STEPS steps of ResNet-50 over the dp mesh of
    every rank, each timed to a sync, B1's launches counted from 0 a step,
    the weights' digest after each; a captured step's launches counted in
    TRACED_STEPS more steps traced; the collectives timed in one more
    step (gloo: a captured step calls none from the host); one step of
    the same net in f32, cuDNN deterministic; then, on rank 0, the first
    RANKS_CHECK_AFTER bf16 steps and the f32 step against one rank on
    the global batch (`_against_one_rank`)."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch import _distributed
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE
    from mxnet_tpu_torch.parallel import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh({"dp": -1})
    torch.cuda.reset_peak_memory_stats()
    net, trainer, step, args = _ranks_resnet(dev, mesh)
    params = net.collect_params()
    ms, b1, digests, means = [], [], [], []
    kept = {"means": [], "weights": []}
    for k in range(RANKS_STEPS):
        torch.cuda.synchronize()
        BN_BWD_REDUCE.launches = 0
        t0 = time.perf_counter()
        loss = step(*args, batch_size=RANKS_BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        b1.append(BN_BWD_REDUCE.launches)
        means.append(float(loss.float().mean()))
        digests.append(_weight_digest(params))
        if rank == 0 and k == 0:
            kept["rows"] = loss.float().clone()
            kept["updates"] = _first_updates(net, trainer)
        if rank == 0 and k < RANKS_CHECK_AFTER:
            kept["means"].append(means[-1])
            kept["weights"].append(_trainable_copy(params))
    traced = None
    if step.eager_reason is None:
        def reset():
            BN_BWD_REDUCE.launches = 0

        def agree(ok):
            flag = torch.tensor([int(ok)], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            return bool(flag.item())

        reset()
        _, counts = traced_launches(
            lambda: [step(*args, batch_size=RANKS_BATCH)
                     for _ in range(TRACED_STEPS)], reset, agree)
        traced = {"steps": TRACED_STEPS, "traced": counts["bn_bwd_reduce"],
                  "booked": BN_BWD_REDUCE.launches}
    coll_ms, coll_calls = _timed_collectives(step, args, RANKS_BATCH) \
        if step.eager_reason else (None, 0)
    median = statistics.median(ms[1:])
    out.update({
        "world": world, "backend": _distributed.backend(),
        "device": str(dev), "global_batch": RANKS_BATCH,
        "rows_a_rank": RANKS_BATCH // world, "step_ms": ms,
        "median_step_ms": median, "losses": means,
        "b1_launches_per_step": b1, "b1_traced": traced, "digests": digests,
        "captures": step.captures, "eager_reason": step.eager_reason,
        "collective_ms": coll_ms, "collective_calls": coll_calls,
        "collective_share": None if coll_ms is None else coll_ms / median,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del net, trainer, step, args, params

    def f32_step():
        net, trainer, step, args = _ranks_resnet(dev, mesh, "float32")
        run = _steps_kept(net, trainer, step, args, 1)
        run["digest"] = _weight_digest(net.collect_params())
        return run

    f32 = _deterministic(f32_step)
    out["f32_digest"] = f32.pop("digest")
    dist.barrier()
    if rank == 0 and world > 1:
        out["one_rank"] = _against_one_rank(dev, "bfloat16", kept)
        out["one_rank_f32"] = _deterministic(
            lambda: _against_one_rank(dev, "float32", f32))


def _ranks_nccl1(dev, out):
    """(b): an NCCL group of one rank: ResNet-50 over the dp mesh and the
    plain single-device step from the same seed, cuDNN pinned
    deterministic, RANKS_CHECK_AFTER steps each, weights compared
    bitwise; the mesh step's captures, host syncs a replay, B1's launches
    in TRACED_STEPS replays traced and booked, and replayed step ms (the
    plain step's beside it)."""
    import torch
    from mxnet_tpu_torch import _distributed
    from mxnet_tpu_torch.ops.nn import BN_BWD_REDUCE
    from mxnet_tpu_torch.parallel import make_mesh

    def reset():
        BN_BWD_REDUCE.launches = 0

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = {}
    for label, mesh in (("mesh", make_mesh({"dp": -1})), ("plain", None)):
        net, _, step, args = _ranks_resnet(dev, mesh)
        losses = [float(step(*args, batch_size=RANKS_BATCH).float().mean())
                  for _ in range(RANKS_CHECK_AFTER)]
        weights = {n: p.data().detach().clone()
                   for n, p in net.collect_params().items()}
        reset()
        _, counts = traced_launches(
            lambda: [step(*args, batch_size=RANKS_BATCH)
                     for _ in range(TRACED_STEPS)], reset)
        b1 = {"replays": TRACED_STEPS, "traced": counts["bn_bwd_reduce"],
              "booked": BN_BWD_REDUCE.launches}
        syncs, _ = _count_syncs(lambda: step(*args, batch_size=RANKS_BATCH))
        replay_ms = cuda_ms(lambda: step(*args, batch_size=RANKS_BATCH),
                            iters=RANKS_TIMED, warmup=1)
        runs[label] = {"losses": losses, "weights": weights,
                       "captures": step.captures, "host_syncs": syncs,
                       "replay_ms": replay_ms, "b1": b1,
                       "eager_reason": step.eager_reason}
        del net, step, args
        torch.cuda.empty_cache()
    mesh, plain = runs["mesh"], runs["plain"]
    bitwise = all(torch.equal(mesh["weights"][n], plain["weights"][n])
                  for n in plain["weights"])
    for run in runs.values():
        del run["weights"]
    out.update({"backend": _distributed.backend(), "world": 1,
                "weights_bitwise_plain": bitwise,
                "losses_equal": mesh["losses"] == plain["losses"], **runs})


def _ranks_live(dev, out):
    """(d): both ranks make the store and take RANKS_KILL_AFTER steps of a
    small net over the dp mesh; then rank 1 exits without a word and rank
    0 polls ``get_dead_nodes(timeout=RANKS_DEAD_TIMEOUT)`` until it names
    rank 1."""
    import os

    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch import gluon, kv
    from mxnet_tpu_torch.parallel import make_mesh

    rank = dist.get_rank()
    store = kv.create("tpu_ici")
    net = gluon.nn.Dense(16, in_units=32)
    net.initialize(ctx=dev, generator=torch.Generator().manual_seed(rank))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})

    class L2(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return (self.net(x) ** 2).sum(1)

    step = gluon.FusedTrainStep(L2(), trainer, mesh=make_mesh({"dp": -1}))
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(5)).to(dev)
    for _ in range(RANKS_KILL_AFTER):
        step(x, batch_size=8)
        store.record_steptime(0.01 * (rank + 1))
    torch.cuda.synchronize()
    dist.barrier()
    steptimes = store.read_steptimes()
    live = store.get_dead_nodes(timeout=RANKS_DEAD_TIMEOUT)
    dist.barrier()
    if rank == 1:
        os._exit(0)                 # no goodbye: its heartbeat just stops
    t0 = time.perf_counter()
    polls, dead = 0, []
    while not dead and time.perf_counter() - t0 < 30:
        time.sleep(0.25)
        dead = store.get_dead_nodes(timeout=RANKS_DEAD_TIMEOUT)
        polls += 1
    out.update({"dead": dead, "detect_s": time.perf_counter() - t0,
                "polls": polls, "live_before": live,
                "steptimes": {str(k): v for k, v in steptimes.items()},
                "timeout": RANKS_DEAD_TIMEOUT,
                "heartbeat_interval": RANKS_HEARTBEAT})
    store.close()


RANKS_MODES = {"gloo2": _ranks_dp, "nccl1": _ranks_nccl1,
               "nccl4": _ranks_dp, "live": _ranks_live}


def ranks_worker(mode, path):
    """One rank of phase 15, started by `phase_ranks` with the launcher's
    variables (the package's import started its group): runs ``mode``
    and writes its result to ``path`` with the rank's number."""
    import torch.distributed as dist
    from mxnet_tpu_torch import _distributed

    dev = _distributed.device()
    out = {"rank": dist.get_rank(), "mode": mode}
    RANKS_MODES[mode](dev, out)
    with open(f"{path}.{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    log(f"rank {out['rank']} of {mode}: done")
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_world(mode, n, outdir, env=None):
    """Start ``n`` ranks of ``mode`` (this script with ``--ranks-worker``
    and the launcher's three variables), wait for all within
    RANKS_TIMEOUT (killing every one past it), and return their exit
    codes, logs and results; each rank logs to a file of its own."""
    import os
    port = _free_port()
    path = os.path.join(outdir, mode)
    procs, logs = [], []
    for r in range(n):
        logs.append(open(f"{path}.{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ranks-worker",
             mode, path],
            stdout=logs[-1], stderr=subprocess.STDOUT,
            env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                     JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r),
                     **(env or {}))))
    deadline = time.perf_counter() + RANKS_TIMEOUT
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline -
                                            time.perf_counter())))
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [open(f"{path}.{r}.log").read() for r in range(n)]
    results = []
    for r in range(n):
        try:
            with open(f"{path}.{r}.json") as f:
                results.append(json.load(f))
        except FileNotFoundError:
            results.append(None)
    return codes, texts, results


def _world_or_die(mode, n, outdir, env=None, quiet_ranks=()):
    """`_spawn_world`, failing the script when a rank failed, timed out or
    wrote nothing (ranks in ``quiet_ranks`` exit by design without a
    result)."""
    t0 = time.perf_counter()
    codes, texts, results = _spawn_world(mode, n, outdir, env)
    bad = codes is None or any(c != 0 for c in codes) or any(
        results[r] is None for r in range(n) if r not in quiet_ranks)
    if bad:
        for r, text in enumerate(texts):
            log(f"rank {r} of {mode} (exit {None if codes is None else codes[r]}"
                f"):\n" + text[-4000:])
        raise SystemExit(f"ranks: the world {mode} of {n} failed: exit "
                         f"codes {codes} (None: past {RANKS_TIMEOUT} s)")
    return results, time.perf_counter() - t0


def _against_one_rank_ok(label, ranks):
    """Rank 0's comparisons with one rank, in bf16 and in f32: each
    parameter's first-update distances (ranks, rolled) logged on a line of
    their own; returns the summaries, the f32 digests' agreement across
    ranks, and whether every check held."""
    summary = {}
    for key in ("one_rank", "one_rank_f32"):
        one = ranks[0][key]
        log(f"rank: {label} {one['dtype']} first updates by parameter "
            "[ranks, rolled]: " + json.dumps(one["step1_updates"]))
        summary[key] = {k: v for k, v in one.items()
                        if k != "step1_updates"}
    summary["f32_weights_bitwise"] = all(
        r["f32_digest"] == ranks[0]["f32_digest"] for r in ranks)
    return summary, (summary["f32_weights_bitwise"] and
                     summary["one_rank"]["ok"] and
                     summary["one_rank_f32"]["ok"])


def _part_a(outdir, out):
    """(a): two ranks share the card over gloo."""
    a, secs = _world_or_die("gloo2", 2, outdir)
    out["gloo2"] = {"ranks": a, "seconds": secs}
    one, one_ok = _against_one_rank_ok("(a)", a)
    bitwise = [a[0]["digests"][k] == a[1]["digests"][k]
               for k in range(RANKS_STEPS)]
    b1_ok = all(n == BN_LAYERS for r in a for n in r["b1_launches_per_step"])
    log("rank: (a) two ranks on one card over gloo: " + json.dumps({
        "backend": a[0]["backend"], "eager_reason": a[0]["eager_reason"],
        "global_batch": RANKS_BATCH, "rows_a_rank": a[0]["rows_a_rank"],
        "median_step_ms": [r["median_step_ms"] for r in a],
        "step_ms": [r["step_ms"] for r in a],
        "collective_ms": [r["collective_ms"] for r in a],
        "collective_share": [r["collective_share"] for r in a],
        "collective_calls": a[0]["collective_calls"],
        "peak_mem_gb": [r["peak_mem_gb"] for r in a],
        "b1_launches_per_step": [r["b1_launches_per_step"] for r in a],
        "weights_bitwise_after_each_step": bitwise,
        "losses": a[0]["losses"], "against_one_rank": one,
        "seconds": secs, "card": out["card"]}))
    if not (all(bitwise) and b1_ok and one_ok and
            all(r["backend"] == "gloo" for r in a)):
        raise SystemExit(
            f"ranks (a) failed: weights bitwise {bitwise}, B1 a step ok "
            f"{b1_ok}, against one rank ok {one_ok}")


def _b1_traced_ok(b1, n):
    """B1's launches in ``n`` traced steps or replays: BN_LAYERS a step on
    the card, and as many by the wrapper's count."""
    return b1["traced"] == b1["booked"] == n * BN_LAYERS


def _part_b(outdir, out):
    """(b): an NCCL group of one rank, the captured step."""
    (b,), secs = _world_or_die("nccl1", 1, outdir)
    out["nccl1"] = dict(b, seconds=secs)
    mesh = b["mesh"]
    log("rank: (b) an NCCL group of one rank: " + json.dumps(
        dict(out["nccl1"], card=out["card"])))
    if not (b["backend"] == "nccl" and mesh["captures"] == 1
            and mesh["host_syncs"] == 0 and b["weights_bitwise_plain"]
            and all(_b1_traced_ok(r["b1"], TRACED_STEPS)
                    for r in (mesh, b["plain"]))):
        raise SystemExit(f"ranks (b) failed: {json.dumps(b)}")


def _part_c(outdir, out):
    """(c): four ranks over NCCL, one card each, where there are four."""
    cards = out["cards"]
    if cards < 4:
        out["nccl4"] = {"run": False, "why": f"not run: {cards} card(s)"}
        log(f"rank: (c) four ranks over NCCL: not run: {cards} card(s)")
        return
    c, secs = _world_or_die("nccl4", 4, outdir)
    out["nccl4"] = {"run": True, "ranks": c, "seconds": secs}
    bitwise = [all(r["digests"][k] == c[0]["digests"][k] for r in c)
               for k in range(RANKS_STEPS)]
    one, one_ok = _against_one_rank_ok("(c)", c)
    log("rank: (c) four ranks over NCCL: " + json.dumps({
        "backend": [r["backend"] for r in c],
        "devices": [r["device"] for r in c], "captures":
        [r["captures"] for r in c], "rows_a_rank": c[0]["rows_a_rank"],
        "median_step_ms": [r["median_step_ms"] for r in c],
        "step_ms": [r["step_ms"] for r in c],
        "peak_mem_gb": [r["peak_mem_gb"] for r in c],
        "b1_launches_per_step": [r["b1_launches_per_step"] for r in c],
        "b1_traced": [r["b1_traced"] for r in c],
        "weights_bitwise_after_each_step": bitwise,
        "losses": c[0]["losses"], "against_one_rank": one,
        "seconds": secs, "card": out["card"]}))
    if not (all(bitwise) and one_ok and all(
            r["backend"] == "nccl" and r["captures"] == 1 and
            all(n == BN_LAYERS for n in r["b1_launches_per_step"]) and
            _b1_traced_ok(r["b1_traced"], TRACED_STEPS) for r in c)):
        raise SystemExit("ranks (c) failed: see its rank: line")


def _part_d(outdir, out):
    """(d): liveness; rank 1 exits after its second step."""
    (d, _), secs = _world_or_die(
        "live", 2, outdir, {"MXNET_HEARTBEAT_INTERVAL": str(RANKS_HEARTBEAT)},
        quiet_ranks=(1,))
    out["live"] = dict(d, seconds=secs)
    log("rank: (d) liveness: " + json.dumps(out["live"]))
    if d["dead"] != [1] or d["live_before"] != []:
        raise SystemExit(f"ranks (d) failed: {json.dumps(d)}")


RANKS_PARTS = {"a": _part_a, "b": _part_b, "c": _part_c, "d": _part_d}


def phase_ranks(dev, parts="abcd"):
    """Phase 15: ranks (see the module's docstring); ``parts`` picks
    which of (a)-(d) run."""
    import tempfile

    import torch
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops.nn import _declare_bn

    _build.load("bn_bwd_reduce", _declare_bn)   # built once, for every rank
    out = {"card": nvidia_smi(), "cards": torch.cuda.device_count(),
           "ran": []}
    with tempfile.TemporaryDirectory(prefix="ranks-") as outdir:
        for part in parts:
            RANKS_PARTS[part](outdir, out)
            out["ran"].append(part)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--word-lm-curve"]:
        # on the CPU, no result line: how WORD_LM_MARGIN was fixed
        word_lm_curve(int(sys.argv[2]), int(sys.argv[3]) if len(sys.argv) > 3
                      else WORD_LM_BATCHES)
        return 0
    if sys.argv[1:2] == ["--mnist-mlp-curve"]:
        # on the CPU, no result line: how MNIST_MARGIN was fixed
        torch.set_num_threads(4)
        mnist_mlp_loop(torch.device("cpu"),
                       lambda e: print(json.dumps(e), flush=True))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs "
              "only on the card", file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch  # noqa: F401  (a rank: starts its group)
    except ImportError as exc:
        print(f"chip_smoke: the mxnet_tpu_torch package is missing ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ranks-worker"]:
        # one rank of phase 15, started by phase_ranks
        return ranks_worker(sys.argv[2], sys.argv[3])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = nvidia_smi()
    if sys.argv[1:2] == ["--wide-forward"]:
        # on the card, no result line: B3 past head dim 128 alone
        log(f"card: {card}; torch {torch.__version__}")
        wide_forward_times(dev, [int(d) for d in sys.argv[2:]] or WIDE_DIMS)
        return 0
    if sys.argv[1:2] == ["--dropout"]:
        # on the card, no result line: phase 2d alone (builds only the
        # dropout source)
        log(f"card: {card}; torch {torch.__version__}")
        phase_dropout(dev)
        return 0
    if sys.argv[1:2] == ["--ops"]:
        # on the card, no result line: phase 3f alone (the kernels build
        # at their first use)
        log(f"card: {card}; torch {torch.__version__}")
        phase_ops(dev)
        return 0
    if sys.argv[1:2] == ["--fleet"]:
        # on the card, no result line: phase 4c alone, on a BERT-base of
        # its own (B3 builds at its first use)
        log(f"card: {card}; torch {torch.__version__}")
        from mxnet_tpu_torch.models import bert_base
        net = bert_base(use_flash=True, dropout=0.1).initialize(
            ctx=dev, generator=torch.Generator().manual_seed(0))
        net.cast("bfloat16")
        phase_fleet(net, dev)
        del net
        torch.cuda.empty_cache()
        phase_continuous(dev)
        return 0
    if sys.argv[1:2] == ["--flash-crossover"]:
        # on the card, no result line: phase 3d alone (the kernels build
        # at their first use)
        log(f"card: {card}; torch {torch.__version__}")
        phase_flash_crossover(dev)
        return 0
    if sys.argv[1:2] == ["--dp"]:
        # on the card, no result line: phase 14 alone (B1 builds at its
        # first use)
        log(f"card: {card}; torch {torch.__version__}")
        phase_dp(dev)
        return 0
    if sys.argv[1:2] == ["--ranks"]:
        # on the card, no result line: phase 15 alone (B1 is built first),
        # or the parts named after it (e.g. `--ranks c`)
        log(f"card: {card}; torch {torch.__version__}")
        phase_ranks(dev, sys.argv[2] if len(sys.argv) > 2 else "abcd")
        return 0
    if sys.argv[1:2] == ["--rtc-host"]:
        # on the card, no result line: B6's host time a launch alone, in
        # RTC_HOST_WINDOWS windows
        log(f"card: {card}; torch {torch.__version__}")
        med, windows = rtc_host_times(dev, RTC_HOST_WINDOWS)
        log("rtc_host: " + json.dumps({"median": med, "windows": windows}))
        return 0
    t_start = time.perf_counter()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    phase_mma_error(dev)
    rows = phase_kernel_vs_plain(dev)
    bwd_rows = phase_bwd_vs_plain(dev)
    phase_replay_seeds(dev)
    drop_rows = phase_dropout(dev)
    served, net = phase_serve(dev)
    phase_profile(net, dev)
    fleet = phase_fleet(net, dev)
    del net
    torch.cuda.empty_cache()
    phase_continuous(dev)
    trained = phase_train(dev)
    trained_amp = phase_train_amp(dev)
    phase_odd_berts(dev)
    phase_flash_crossover(dev)
    ops = phase_ops(dev)
    bn_rows = phase_bn_reduce(dev)
    stem_rows = phase_stem(dev)
    resnet = phase_resnet(dev)
    resnet_nhwc = phase_resnet(dev, "NHWC")
    resnet_s2d = phase_resnet_s2d(dev)
    rec = phase_recordio(dev)
    rtc_out = phase_rtc(dev)
    custom = phase_resnet_custom(dev)
    rnn_lm = phase_rnn_lm(dev)
    phase_lenet(dev)
    phase_mnist_mlp(dev)
    zoo = phase_zoo(dev)
    dp = phase_dp(dev)
    ranks = phase_ranks(dev)
    log(f"seconds: {time.perf_counter() - t_start:.1f}")

    main_case = next(r for r in rows
                     if r["dtype"] == "bfloat16" and r["case"] == "ragged_mask"
                     and r["shape"] == [B, H, T, D])
    train_case = next(r for r in rows
                      if r["dtype"] == "bfloat16" and
                      r["case"] == "train_mask_dropout")
    bwd_case = next(r for r in bwd_rows
                    if r["dtype"] == "bfloat16" and
                    r["case"] == "train_mask_dropout")
    # the amp path's f16 case, (32, 12, 128, 64) with mask and dropout,
    # with its launches over the traced amp + remat steps
    f16_fwd = next(r for r in rows if r["dtype"] == "float16" and
                   r["case"] == "train_mask_dropout")
    f16_bwd = next(r for r in bwd_rows if r["dtype"] == "float16" and
                   r["case"] == "train_mask_dropout")
    amp_launches = trained_amp["launches"]
    amp_booked = trained_amp["launches_booked_traced"]

    def amp_case(name, row, keys):
        return {"launches": amp_launches[name],
                "launches_booked": amp_booked[name],
                **{k: row[k] for k in keys}}
    # B1 at the stem BatchNorm, B2 at the bf16 stem: the largest shapes
    bn_case = bn_rows["nchw"][0]
    bn_rows_case = bn_rows["nhwc"][0]
    stem_case = next(r for r in stem_rows if r["dtype"] == "bfloat16")
    # B6 at the head's shape; softmax_bwd is held bitwise
    rtc_case = rtc_out["softmax"][0]
    bwd_src = "mxnet_tpu_torch/csrc/flash_attention_bwd.cu"
    # launches counted on the card from the trace of the main path's
    # traced run; the wrappers' bookkeeping of the same run beside them
    launches = trained["launches"]
    booked = trained["launches_booked_traced"]
    drop_case = drop_rows[0]
    lm_case = next(r for r in drop_rows if r["shape"] == [30, 32, 650])
    wide_fwd = [{k: r[k] for k in (
        "dtype", "shape", "ms", "device_ms", "kernel_device_ms", "bound_ms",
        "bound_by", "library_ms", "library_device_ms", "max_abs_err",
        "lse_max_abs_err", "repeat_bitwise")}
                for r in rows if tuple([r["case"]] + r["shape"]) in WIDE_TIMED]
    wide_bwd = [{k: r[k] for k in (
        "dtype", "shape", "dq_ms", "dkv_ms", "dq_device_ms", "dkv_device_ms",
        "backward_device_ms", "plain_ms", "dq_bound_ms", "dq_bound_by",
        "dq_bound_parts_ms", "dkv_bound_ms", "dkv_bound_by",
        "dkv_bound_parts_ms", "library_ms", "library_ms_windows",
        "rederived_share", "max_abs_err")}
                for r in bwd_rows
                if tuple([r["case"]] + r["shape"]) in WIDE_TIMED]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:366",
        "launches": served["flash_launches"],
        "launches_booked": served["flash_launches_booked"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "device_ms": main_case["device_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "wide_cases": wide_fwd,
        "ops_launches": ops["launches"]["flash_attention_fwd"],
        # the traced storm through the 2-replica fleet with a replica
        # killed (phase 4c)
        "fleet_launches": fleet["fleet2_kill"]["flash_launches"],
        "training_case": {
            "launches": launches["flash_attention_fwd"],
            "launches_booked": booked["flash_attention_fwd"],
            **{k: train_case[k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}},
        "amp_f16_case": amp_case("flash_attention_fwd", f16_fwd, (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")),
    }, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": bwd_src,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:536",
        "launches": launches["flash_attention_bwd_dq"],
        "launches_booked": booked["flash_attention_bwd_dq"],
        "ops_launches": ops["launches"]["flash_attention_bwd_dq"],
        "max_abs_err": bwd_case["max_abs_err"]["dq"],
        "ms": bwd_case["dq_ms"], "device_ms": bwd_case["dq_device_ms"],
        "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case["dq_bound_ms"],
        "bound_by": bwd_case["dq_bound_by"],
        "library_ms": bwd_case["library_ms"],
        "wide_cases": wide_bwd,
        "amp_f16_case": amp_case("flash_attention_bwd_dq", f16_bwd, (
            "max_abs_err", "dq_ms", "dq_device_ms", "plain_ms",
            "dq_bound_ms", "dq_bound_by", "library_ms")),
    }, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": bwd_src,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:604",
        "launches": launches["flash_attention_bwd_dkv"],
        "launches_booked": booked["flash_attention_bwd_dkv"],
        "ops_launches": ops["launches"]["flash_attention_bwd_dkv"],
        "max_abs_err": max(bwd_case["max_abs_err"]["dk"],
                           bwd_case["max_abs_err"]["dv"]),
        "ms": bwd_case["dkv_ms"], "device_ms": bwd_case["dkv_device_ms"],
        "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case["dkv_bound_ms"],
        "bound_by": bwd_case["dkv_bound_by"],
        "library_ms": bwd_case["library_ms"],
        "wide_cases": wide_bwd,
        "amp_f16_case": amp_case("flash_attention_bwd_dkv", f16_bwd, (
            "max_abs_err", "dkv_ms", "dkv_device_ms", "plain_ms",
            "dkv_bound_ms", "dkv_bound_by", "library_ms")),
    }, {
        "name": "bn_bwd_reduce", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/bn_bwd_reduce.cu",
        "replaces": "mxnet_tpu/ops/nn.py:340",
        "launches": resnet["launches"]["bn_bwd_reduce"],
        "launches_booked": resnet["launches_booked"]["bn_bwd_reduce"],
        "recordio_launches": {rec[v]["variant"]:
                              rec[v]["launches"]["bn_bwd_reduce"]
                              for v in ("a", "b") if v in rec},
        "zoo_launches_per_step": {z["model"]: z["launches"]["bn_bwd_reduce"]
                                  // TRACED_STEPS for z in zoo},
        # phase 14's eager loop over parameter copies: each step's
        # launches from 0, on the one card copy and on the card copy of
        # the card-and-host pair
        "dp_launches_per_step": dp["card_copy"]["b1_launches_per_step"],
        "dp_card_and_host_launches_per_step": [
            s["b1_launches_card_copy"]
            for s in dp["card_and_host_copies"]["steps"]],
        # phase 15: each rank's launches in each step of (a), two ranks
        # over gloo, eager; a replay's launches traced in (b), an NCCL
        # group of one rank, and on each rank in (c), four
        "ranks_launches_per_step": {
            "gloo2": [r["b1_launches_per_step"]
                      for r in ranks["gloo2"]["ranks"]],
            "nccl1_traced": ranks["nccl1"]["mesh"]["b1"]["traced"]
            // TRACED_STEPS,
            "nccl4_traced": [r["b1_traced"]["traced"] // TRACED_STEPS
                             for r in ranks["nccl4"]["ranks"]]
            if ranks["nccl4"]["run"] else ranks["nccl4"]["why"]},
        "max_abs_err": bn_case["max_abs_err"],
        "ms": bn_case["ms"], "plain_ms": bn_case["plain_ms"],
        "bound_ms": bn_case["bound_ms"], "bound_by": bn_case["bound_by"],
        "library_ms": bn_case["library_ms"],
    }, {
        "name": "bn_bwd_reduce_rows", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/bn_bwd_reduce.cu",
        "replaces": "mxnet_tpu/ops/nn.py:340",
        "form": "channel-minor (M, C): NHWC activations",
        "launches": resnet_nhwc["launches"]["bn_bwd_reduce_rows"],
        "launches_booked": resnet_nhwc["launches_booked"][
            "bn_bwd_reduce_rows"],
        "shape": bn_rows_case["view"],
        "max_abs_err": bn_rows_case["max_abs_err"],
        "ms": bn_rows_case["ms"], "device_ms": bn_rows_case["device_ms"],
        "plain_ms": bn_rows_case["plain_ms"],
        "bound_ms": bn_rows_case["bound_ms"],
        "bound_by": bn_rows_case["bound_by"],
        "library_ms": bn_rows_case["library_ms"],
    }, {
        "name": "stem_conv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/stem_matmul.cu",
        "replaces": "mxnet_tpu/ops/stem.py:120",
        "launches": resnet_s2d["launches"]["stem_conv"],
        "launches_booked": resnet_s2d["launches_booked"]["stem_conv"],
        "max_abs_err": stem_case["max_abs_err"],
        "ms": stem_case["ms"], "device_ms": stem_case["device_ms"],
        "plain_ms": stem_case["plain_ms"],
        "bound_ms": stem_case["bound_ms"], "bound_by": stem_case["bound_by"],
        "library_ms": stem_case["library_ms"],
        "first_design_ms": stem_case["first_design_ms"],
    }] + [{
        "name": name, "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/dropout.cu",
        "replaces": "mxnet_tpu/ops/nn.py:566",
        "replaces_note": "not a Pallas kernel: the reference's dropout "
                         "draws from XLA's random bits",
        # the traced BERT steps' launches of this kernel (dropout: both
        # kernels' in launches_both_kernels)
        "launches": launches["dropout"] - launches["dropout_bwd"]
        if part == "fwd" else launches["dropout_bwd"],
        "launches_booked": booked["dropout"] - booked["dropout_bwd"]
        if part == "fwd" else booked["dropout_bwd"],
        "launches_both_kernels": launches["dropout"],
        "ops_launches": ops["launches"]["dropout"] -
        ops["launches"]["dropout_bwd"] if part == "fwd"
        else ops["launches"]["dropout_bwd"],
        "max_abs_err": drop_case["max_abs_err" if part == "fwd"
                                 else "bwd_max_abs_err"],
        # the kernel's device time, its inputs out of L2; warm, and its
        # wrapper's call by events
        "ms": drop_case[f"{part}_ms"],
        "warm_ms": drop_case[f"{part}_warm_ms"],
        "events_ms": drop_case[f"{part}_events_ms"],
        "plain_ms": drop_case[f"{part}_plain_ms"],
        "bound_ms": drop_case[f"{part}_bound_ms"],
        "bound_by": _contract_bound(drop_case[f"{part}_bound_by"]),
        "bound_kind": drop_case[f"{part}_bound_by"],
        "bytes_bound_ms": drop_case[f"{part}_bytes_bound_ms"],
        "int_bound_ms": drop_case[f"{part}_int_bound_ms"],
        "sass_int_ms": drop_case[f"{part}_sass_int_ms"],
        "library_ms": None,
        "yardstick_ms": drop_case[f"{part}_yardstick_ms"],
        "yardstick": yard,
        "amp_launches": amp_launches["dropout"] - amp_launches["dropout_bwd"]
        if part == "fwd" else amp_launches["dropout_bwd"],
        "amp_launches_booked":
            amp_booked["dropout"] - amp_booked["dropout_bwd"]
        if part == "fwd" else amp_booked["dropout_bwd"],
        "rnn_lm_launches":
            rnn_lm["word_lm"]["dropout_launches"] -
            rnn_lm["word_lm"]["dropout_bwd_launches"]
        if part == "fwd" else rnn_lm["word_lm"]["dropout_bwd_launches"],
        "rnn_lm_case": {k: lm_case[k] for k in (
            "dtype", "shape", "p", "bitwise", "bwd_bitwise", "keep_rate",
            f"{part}_ms", f"{part}_plain_ms", f"{part}_bound_ms",
            f"{part}_bound_by", f"{part}_yardstick_ms")},
    } for name, part, yard in (
        ("dropout", "fwd", "F.dropout (other bits)"),
        ("dropout_bwd", "bwd",
         "aten.native_dropout_backward (a bool mask, not packed bits)"))
    ] + [{
        "name": f"rtc:{name}", "route": "cuda",
        "source": "chip_smoke.py:USER_KERNELS_SRC",
        "launcher": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:61",
        "launches": custom["launches"][name],
        "max_abs_err": rtc_case[f"{part}_max_abs_err"],
        "ms": rtc_case[f"{part}_ms"], "plain_ms": rtc_case[f"{part}_plain_ms"],
        "bound_ms": rtc_case[f"{part}_bound_ms"],
        "bound_by": rtc_case[f"{part}_bound_by"],
        "library_ms": rtc_case[f"{part}_library_ms"],
    } for name, part in (("softmax_fwd", "fwd"), ("softmax_bwd", "bwd"))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
