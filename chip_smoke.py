#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from mxnet_tpu_torch/csrc with nvcc (all
   sources at once) and prints the -Xptxas -v summary on one line, then
   the tensor-core kernels' lines apart; fails if those spill at D = 64.
3. Kernel phase: each hand-written kernel (flash-attention forward, its
   backward's dq and dk/dv kernels, fused residual+LayerNorm, fused FFN1)
   against its plain PyTorch version on the same inputs on the card, at
   the main paths' shapes (B = 8, T in {128, 512}, bf16 and f32;
   attention also causal, with a key mask, with dropout, at a ragged T,
   at the serving shapes B in {1, 8} x T in {64, 256}, and at D = 128;
   FFN1 over M in {64, 200, 1024, 4096}, K in {768, 72}, N in {3072, 100}),
   with the tolerance stated beside each comparison. The forward, dq and
   dk/dv kernels each have a tensor-core variant (bf16) and a SIMT one
   (f32, D = 8, and the first design, reachable at bf16 through a private
   argument); FFN1 has a wgmma + TMA variant (bf16, K a multiple of 8),
   the first WMMA design (other bf16, and forced) and a SIMT one (f32).
   Every case checks that exactly one launch of each expected kernel and
   variant ran, in the case's dtype, and the old and new variants are
   held against the plain version and timed at the main shape in this
   run. The flash forward, dq, dk/dv and FFN1 kernels also run in float16
   (AMP's GPU target) at the main shapes, with and without dropout and
   with a key mask, each against its plain version (atol 2e-3 + rtol
   2e-3, twice float16's epsilon) and timed beside the bf16 kernel; the
   float16 backward also where ds passes float16's 65504 (a dO of order
   2**13, as a loss scale gives). Times each kernel, its plain
   version and one PyTorch library call that computes the same function
   (a yardstick only: the port never calls it) as device time from
   torch.profiler's CUDA trace (CUDA events where the trace has none),
   and computes each kernel's bound from the H100 SXM data sheet. Last,
   the language models' shapes: A, K2 and K3 at GPT-2 small's causal
   self-attention (B = 8, T = 1024, H = 12) and at Transformer-base's
   cross-attention (B = 16, H = 8, Tq = 200, Tk = 256, key mask), each
   against its plain version and timed beside SDPA and the bound of the
   query-key pairs those inputs need (A causal also without the flag).
3a. lm phase (right after the kernel phase: its profiler traces are
   read early, while they come back whole): (b) GPT-2 small
   (models/gpt.py, gpt2_small_config: vocab 50257, hidden 768, 12
   layers, 12 heads) at full width and depth, weights Normal(0.02) from a
   numpy seed, one step at B = 1, T = 1024, dropout 0, bf16 on the card
   against f32 on the CPU through the plain versions (PERF.md section
   2's training bounds, the tied word_embed gradient on its own line);
   (a) the main path as examples/train_gpt.py runs it: bf16,
   gpt_lm_loss, ShardedTrainStep with AdamW at lr 3e-4, dropout 0.1 drawn
   on the card, B = 8, T = 1024, one repeated batch: call 1 runs eagerly
   and captures (the counters at 0 before: 24 launches each of A, K2 and
   K3, all tensor-core), a profiler trace of 3 replays early (busy time,
   idle share) and one counting 12 of each per replay, then 10 timed
   steps whose losses must fall; step ms (median and spread of 3 calls),
   tokens/s and MFU by bench.py's accounting; (c) Transformer-base
   (Vaswani et al. 2017: hidden 512, 6 + 6 layers, 8 heads, FFN 2048,
   a shared vocabulary of 37000) in bf16: its logits at B = 2 against f32
   on the CPU (rel Frobenius 0.05), then one gluon.Trainer AdamW step at
   B = 16, source T = 256 under a key mask from valid lengths in [128,
   256], target T = 200: 18 A launches in the forward, 18 each of K2 and
   K3 in the backward.
3b. zoo phase: alexnet, vgg16_bn, squeezenet1.1, mobilenetv2_1.0,
   densenet121 (224) and inceptionv3 (299) with 1000 classes, B = 8, f32,
   He-normal weights from a numpy seed, each predict forward against the
   CPU's within rel Frobenius 0.05 and timed; then gluon.contrib's
   Estimator.fit of mobilenetv2_1.0 ending in a softmax (B = 32, 224, 8
   batches of a DataLoader over an ArrayDataset, SGD) with Accuracy,
   TopKAccuracy(5) and CrossEntropy held against numpy over the same
   predictions (exactly; cross-entropy within 1e-5), a LoggingHandler, a
   CheckpointHandler resumed into a fresh net byte for byte and a
   WatchdogHandler's 8 beats; images/s. The path launches none of the
   hand-written kernels.
3c. seq phase, f32 with TF32 off: gluon.rnn on the fused rnn op and
   CTC. (a) MXNet 1.6's example/gluon/word_language_model as its README
   trains it (emsize 650, nhid 650, 2 layers, dropout 0.5, tied, the
   vocabulary of WikiText-2, 33278; B = 32, bptt 35), composed here:
   Embedding, gluon.rnn.LSTM, a Dense tied to the embedding, weights
   uniform in [-0.1, 0.1] from a numpy seed, token ids from a numpy seed.
   One forward and backward at dropout 0 against the same weights on the
   CPU (loss rel 1e-5, every gradient rel Frobenius 1e-4, the tied
   embedding's gradient on its own line); then the example's loop on the
   hybridized model (gluon.Trainer SGD at lr 20, clip_global_norm at
   0.25, the hidden state detached between batches, dropout 0.5 drawn on
   the card) over one repeated batch: the loss must fall; step ms
   (median and spread of 3 calls of 10), tokens/s, and the busy time and
   idle share of a profiler trace of 3 steps. (b) A bidirectional 2-layer
   GRU's forward (hidden 650, T = 35, B = 32) against the CPU (rel
   Frobenius 1e-4). (c) example/ctc's sizes (2 LSTM layers of 100, 80
   steps over 30 features, 4 digits, 11 classes with the blank, B = 128):
   CTCLoss (TNC, blank last, label 0 among the labels) and its gradients
   against the CPU, then one Trainer step (finite loss, every parameter
   moved). The path launches none of the hand-written kernels.
3d. det phase, f32: SSD-512 VOC (ssd_512(num_classes=20), He-normal
   weights from a numpy seed). (a) 24572 anchors; one training step at
   B = 2 (examples/train_ssd.py make_batch at 512 and 20 classes, labels
   padded to 4 rows) against the same weights on the CPU:
   multibox_target's outputs on the card against the CPU's fed the
   card's cls_pred (class targets and masks exactly, box targets 1e-5);
   ssd_train_loss (rel 1e-5) and every gradient (rel Frobenius 1e-4; the
   convolution biases ahead of a BatchNorm left out, their gradient zero
   in exact arithmetic), the CPU fed the card's targets where a near-tie
   of the mining scores makes its own differ (the count printed). (b) The
   example's loop at B = 32 (gluon.Trainer Adam at lr 1e-3, one repeated
   batch): the loss must fall; step ms (median and spread of 3 calls of
   10), images/s, the idle share of a trace of 3 steps. (c) detect's
   multibox_detection at B = 8, nms_topk 400, on the card against the
   CPU fed the same cls_prob and loc_pred (the kept ids and their order
   exactly, scores and boxes 1e-5), timed, with the peak memory it adds
   (NMS forms no 24572 x 24572 matrix). (d) A .rec of 32 JPEGs 512 x 512
   with box labels, written with recordio.pack_img in a temporary
   directory, read by ImageDetIter (rand_crop, rand_pad, rand_mirror,
   mean and std) on the card: every box in [0, 1]; 4 SSD steps fed by it,
   finite losses. The path launches none of the hand-written kernels.
3e. sym phase (after det): MXNet's symbolic API. (a) ResNet-50 v1
   built from mx.sym as MXNet 1.6's example/image-classification/
   symbols/resnet.py lays it out (a BatchNorm of the data, 50 layers of
   bottleneck units over 64/256/512/1024/2048 filters, 1000 classes,
   BatchNorm eps 2e-5 and momentum 0.9, ``bn[0]``), He-normal weights
   from a numpy seed, through Module on the card: one forward
   (is_train=True) and backward at B = 2, f32 with TF32 off, against the
   CPU (aligned_units for the ReLU and max-pool ties; the output, every
   gradient and the new moving statistics at the det phase's f32
   bounds, or, the step being ill-conditioned at B = 2, no further from
   the CPU's float64 step than twice the CPU's own f32 step); Module.fit
   over an NDArrayIter of random images at B = 32 (SGD momentum 0.9, lr
   0.1, wd 1e-4, 8 batches): step ms (median and spread), images/s, a profiled
   step's busy time and idle share; save_checkpoint, Module.load and
   predict bitwise the predictions before; SymbolBlock.imports of the
   pair within 1e-6 with the same classes; a Gluon net's export and
   imports on the card. (b) At BERT-base width (hidden 768, 12 heads,
   T = 512, B = 8, bf16, valid_length in [256, 512]): a 12-layer encoder
   from mx.sym (FullyConnected flatten=False, multi_head_attention,
   LayerNorm, FFN 3072) through simple_bind: 12 launches of A per
   forward, 12 of K2 and of K3 per backward, the output within rel
   Frobenius 0.05 and the gradients within the bf16 training bounds of
   f32 on the CPU; and 12 NaiveAttentionBlocks (tests/test_subgraph.py's,
   written for the port, additive key mask) hybridized with
   backend='fuse_attention': 12 matches a trace, a replayed forward
   launches A 12 times and no softmax kernel, a replayed step under
   autograd.record 12 of A, K2 and K3; fused against unfused within the
   bf16 bounds; device ms of both. The checkpoint and exported files live
   under build/chip_smoke_sym and are removed. The launches of (b) are
   the kernels' sym column (A, K2 and K3 per symbolic forward and
   backward beside them); (a) launches none.
3f. sparse phase (after sym), f32 with TF32 off: MXNet's sparse storage
   on the RowSparse path (ops/rowsparse.py, parallel/step.py) and
   models.wide_deep.WideDeep (examples/train_wide_deep.py's model on the
   port's layers; both tables Embedding(sparse_grad=True)). (a)
   unique_rows, dedup_take (forward and table gradient) and
   merge_row_blocks on the card equal the CPU's bitwise, on a batch
   where row vocab - 1 is live and the budget keeps sentinel slots and on
   the example's batch; dedup_take's table gradient bitwise equal across
   3 runs and 3 permutations of the ids. (b) At the example's defaults
   (vocab 100000, 20 fields, dim 16, hidden 64, B = 128, hot fraction
   0.05, weights Normal(0.01) from a numpy seed): the lazy-Adam
   ShardedTrainStep on the card (call 1 eager and captured, call 2 a
   replay) against the same step on the CPU: loss rel 1e-5, every
   parameter and moment rel Frobenius 1e-4, the untouched rows' moments
   exactly 0; exact mode against dense (MXTPU_SPARSE=0), 3 captured
   steps, bitwise. (c) The example's loop: 20 captured steps over 4
   batches repeated, the last cycle's mean loss below the first's; 3
   replays under torch.cuda.set_sync_debug_mode('error') (no host sync),
   a profiler trace of 3 replays (busy time, idle share), step ms (median
   and spread of 3 calls of 10), peak memory, sparse_report()'s update
   bytes and shrink. (d) The same model at a Criteo-sized table (26
   fields, one table hashed to 10,000,000 rows, dim 16, B = 2048, hot
   fraction 0.05; about DLRM's Criteo Terabyte sizes) under lazy, exact
   and dense (MXTPU_SPARSE=0): the (c) readings for each; under lazy,
   sampled untouched rows keep zero moments and every touched row moved.
   (e) gluon.Trainer with SGD (momentum 0.9, lazy) and with Adam over
   Embedding(sparse_grad=True) + Dense: grad() a RowSparseNDArray on the
   card, 3 steps against the CPU within 1e-5, absent rows unchanged
   bitwise. (f) nd.sparse on the card: dot(csr, dense) through the CSR
   route against the dense product within 1e-5 (both timed), retain and
   tostype round trips, nd.save / nd.load of row_sparse and csr bitwise,
   SparseEmbedding's one SGD step moving exactly the looked-up rows. (g)
   The DGL ops on card-resident inputs equal the CPU's (the samplers
   seeded alike). The launch counters are set to 0 just before and read
   just after: the path launches none of the hand-written kernels (the
   JAX package's sparse path runs no Pallas kernel). Prints its seconds.
4. Serving phase: the serving recipe, InferenceEngine(BlockRunner(net))
   then serving.warmup(engine), on BERT-base at full width, weights drawn
   with numpy from a fixed seed (Normal(0.02)) and cast to bf16 on the
   card, both fused-kernel knobs on, buckets T in {64, 128, 256, 512} x
   B in {1, 2, 4, 8}. BlockRunner hybridizes the model; first, with
   hybridize(False), each bucket's eager output and the eager dispatch
   breakdown. Then the main path: the launch counters are set to 0, the
   compile ledger armed, warmup captures one CUDA graph per bucket (16,
   with 16 serving:warmup_* ledger entries, its seconds, memory_reserved
   and the graph pools' bytes printed), and 64 ragged requests from 4
   client threads replay them: the burst adds no ledger entry, no
   recompile warning and no graph, and the counters, which move only at
   warmup (each bucket's eager run and capture: 2 x 12 x 16 flash and
   FFN1 launches, twice that of LayerNorm, all on the tensor-core
   variants), do not move. Requests/s, p50 and p99; a profiler trace of
   3 replays of the 8 x 512 bucket counts 12, 24 and 12 launches per
   dispatch. Every bucket's replay is bitwise its eager output, and the
   pinned output copy bitwise the pageable one (the two copies timed).
   The captured dispatch breakdown (host ms, device busy ms, idle share)
   is printed beside the eager one, and two host steps of a dispatch
   (the CachedOp key, the token upload) are timed alone. With telemetry and tracing armed, a
   second burst's Prometheus serving counters equal engine.stats() and
   its serving.dispatch spans the dispatches; one 8 x 512 dispatch is
   timed armed and disarmed. One request is checked against the same
   weights in f32 on the CPU through the plain versions, and again with
   both knobs off after hybridize() (its bucket captured anew on the
   engine's worker thread; a trace shows no LayerNorm or FFN1 launch).
5. Front phase: the serving replica's front door. Two BERT-base bf16
   replicas, each its own BertModel with the serving phase's weights and
   both knobs on, each InferenceEngine(BlockRunner(net)) warmed (16 CUDA
   graphs each; the launch counters set to 0 just before, so the front's
   launches are the two warmups') behind serving.PredictServer on
   127.0.0.1, telemetry and tracing armed. Checks, in order: /predict of
   one sequence and of a list equals the in-process engine's output for
   the same sequences bitwise after the JSON round trip; /metrics carries
   the engine's counters; /healthz['memory'] is the allocator's live
   bytes; memory_admission below the live bytes answers 503 and the
   engine's dispatch count does not move; /reload by path with a second
   weight set serves that set's eager forward bitwise with no new ledger
   entry and every parameter's storage in place; /reload {"ns", "step"}
   on a corrupted step directory answers 409; quantize_weights('int8') on
   the second replica (its output drift against bf16 printed); a profiler
   trace of 3 HTTP requests of 512 tokens counts 12 / 24 / 12 launches of
   the flash forward, LayerNorm and FFN1 kernels per request; the
   CachedOp key's host time rebuilt per call (as before its names were
   kept) and now; then a serving.Router over both replicas takes 32
   requests (lengths uniform in 8..512, numpy seed) from 4 client
   threads, and /drain goes to replica 0 once a quarter are answered: 0
   failed requests, at least one failover, the drained listener closed.
   Prints requests/s over HTTP, HTTP p50/p99, the engine's p50, and the
   JSON encode time of one response at four lengths.
6. Training phase: BERT-base BertForPretraining at full width in bf16,
   the same numpy weights, both knobs on, so all five kernels run. First
   one step at B = 2 with dropout 0 against the same weights in f32 on the
   CPU through the plain versions (loss, and every gradient). Then, with
   dropout 0.1 drawn on the card, the flagship batch (B = 8, T = 512,
   valid_length in [256, 512], 72 masked positions per row) through
   gluon.Trainer/AdamW (multi_precision): a warm-up step, then 5 timed
   steps with the launch counters set to 0 just before and read just
   after (12 forward, 12 dq, 12 dk/dv, 24 LayerNorm and 12 FFN1 launches
   per step; every forward, dq, dk/dv and FFN1 on the tensor-core
   variant), step
   time, samples/s and MFU, and a profiled step.
6a. AMP phase (MXNet's automatic mixed precision, after the training
   phase): BERT-base BertForPretraining with f32 parameters. One step at
   B = 2 (dropout 0) under amp.init('bfloat16') and under
   amp.init('float16') on the card, each against the same f32 CPU
   reference as the training phase's parity. A Dense hybridized before
   amp.init is captured anew after it and after _deinit (3 graphs).
   Then the flagship batch with AdamW, the recipe as MXNet writes it
   (autograd.record, amp.scale_loss(loss, trainer) as s: s.backward(),
   trainer.step(B)): 5 steps under bfloat16 (scale 1), and 5 under float16
   with the dynamic scaler from 2**16 (warm-up steps back it off until the
   first update; step 3's gradient is planted non-finite: the parameters
   and update counts stay, the scale halves, and the next step updates
   again), each with the counters at 0 just before (12 forward, dq and
   dk/dv launches a step on the tensor cores in the target dtype, no
   LayerNorm or FFN1), step time (median of 3 calls), samples/s and a
   profiled step; the overflow check's host ms; one float16 step with
   MXTPU_PALLAS_LN=1 (24 LayerNorm launches in the promoted f32); and a
   predict forward of the model cast to float16 with both knobs on (12
   forward and FFN1, 24 LayerNorm launches in float16) against the f32
   model.
7. NDArray phase: MXNet's imperative API (mx.nd, mx.autograd) on the
   card with user kernels compiled by NVRTC (mx.rtc, the counterpart of
   the JAX package's pallas_op). Compiles the five user kernels of
   mxnet_tpu_torch/test_utils.py (scale_add, block_double, rowsum, GELU
   forward and backward), holds each against its plain version at the
   shapes of tests/test_rtc.py and at 4096 x 3072 f32, and times each
   there beside its bound and one PyTorch call, with the copy each
   output array costs printed apart. The counters are set to 0, then the
   path runs: the three mirrored kernels called on NDArrays as
   tests/test_rtc.py calls its Pallas ops, and 5 SGD steps of the FFN
   block y = dot(gelu(dot(x, w1) + b1), w2) + b2 at BERT-base width
   (4096 x 768, FFN 3072, f32), its GELU an autograd.Function whose
   forward and backward are rtc launches; exactly 5 + 5 GELU launches.
   Step 1 is checked against the same program on the CPU with the plain
   GELU; the losses must fall. Prints step time, the idle share of one
   profiled step, the host cost of one NDArray op, and checks two
   semantics on the card (a launch into a reshape leaves its source
   unchanged; a second backward leaves the gradients).
8. Gluon phase: MXNet's Gluon API on the card. First the parity checks:
   one SGD step of resnet50_v1 (B = 2, 224 x 224) in bf16, unit by unit
   (each of its layers and bottlenecks on the input and upstream gradient
   the f32 step on the CPU gave it) against f32 on the CPU, with the whole
   step end to end printed beside the CPU's own bf16 step; then
   resnet18_v1 (thumbnail, B = 8, 32 x 32) in f32 with TF32 off, the
   whole step, card against CPU. Then (b) bench.py's _resnet_report
   program as written (resnet50_v1, Xavier, cast to bf16,
   ShardedTrainStep with SGD momentum 0.9, lr 0.1, B = 64, 224 x 224): 2
   warm-up and 3 x 8 timed steps, the step time (median and spread of the
   3), images/s, a profiled step (busy time, idle share, top kernels), and
   (a) the imperative Gluon loop (autograd.record, SoftmaxCrossEntropyLoss,
   backward, Trainer.step) on the same net, unhybridized and hybridized
   (forward and backward as CUDA graphs), 5 steps each, median of 3; and
   the hybridized predict-mode forward at B = 64 bitwise equal to the
   unhybridized one, one graph per key. The five kernels' launch counters
   are set to 0 before (b) and must read 0 after (a): this path runs
   none of them (its convolutions, pooling and BatchNorm are stock
   PyTorch/cuDNN ops, as the JAX package leaves them to XLA).
8a. io phase (after the Gluon phase): MXNet's input pipeline on the card.
   (a) A probe, decided up front and checked after: g++, jpeglib.h, a
   system libjpeg, PIL and the libjpeg-turbo bundled in Pillow's wheel;
   with g++ and either libjpeg the native runtime (src/io/mxtpu_io.cc,
   built by mxnet_tpu_torch/_native.py) must build and serve, else the
   PIL path, else raw uint8 through NDArrayIter. (b) bench.py's
   _io_report on the card: 384 noise JPEGs 360 x 480 q90 (written with
   PIL; without PIL the committed fixture tools/fixtures/io_smooth.rec),
   B = 64, resize 256, random crop 224, mirror, bench.py's mean/std,
   os.cpu_count() decode threads; images/s of the cold epoch and of 3
   warm ones for f32-copy, u8-lease and u8-lease+device-prefetch, host
   bytes per image and the decode cache's hits and misses; the u8 batch
   (normalized on the card) against the f32 one (normalized on the host)
   bitwise. (c) The Gluon phase's ResNet-50 v1 program (bf16, B = 64)
   fed by ImageRecordIter(transport='u8', dtype='bfloat16') through
   DevicePrefetchIter(depth=2), against the same step on a resident
   batch: step ms (median and spread of 3 calls of 8), images/s, a
   profiled step's idle share. (d) The compiled BERT-base step (bf16,
   dropout 0.1, both knobs on) fed by gluon.data.DataLoader over an
   ArrayDataset of 40 flagship rows (pin_memory=True, num_workers=2): 5
   losses bitwise those of the same batches resident on the card, the
   launch counters at 0 just before (the eager step and the capture:
   24 / 24 / 24 / 48 / 24, the kernels' io column). (e) 200 u8 batches
   under a slow consumer, a busy side stream and a delay planted on the
   iterator's copy stream between each copy and its event, each bitwise
   its f32 twin; no lease goes back before its event, the drains that
   found the copy unfinished and waited (must be some); then 20 batches
   with the drain's event sync taken out must show leases going back
   early, so the probe can see a missing drain. (f) io.decode:corrupt under
   corrupt_policy='skip' skips the same records twice; io.device_put:
   raise reaches the caller; dataloader.worker:raise respawns twice and
   leaves the batches unchanged.
9. Compiled-step phase (the last to run): parallel.ShardedTrainStep, the flagship's entry
   point, whose step (forward, backward, AdamW) is one CUDA graph
   replayed per call. First, at hidden 128 and 2 layers in f32 with
   dropout 0, 5 steps of the captured step and 5 of the Trainer with its
   captured fused update, each against the Trainer's per-parameter loop
   on the card (loss rel 1e-5 at every step, parameters' rel Frobenius
   1e-4). Then BERT-base at full width in bf16 with dropout 0.1 on the
   flagship batch: 3 warm-up steps (call 1 runs eagerly and captures)
   and 10 timed ones with finite losses and every master moving; the
   attention seeds two replays draw, read back from the card, differ;
   the launch counters show the eager step and the capture (2 per layer
   of each kernel, 4 of LayerNorm), and a profiler trace of 3 replays
   counts exactly 12 launches of the flash forward, dq, dk/dv and FFN1
   kernels and 24 of LayerNorm per replay. Prints the step time (median
   and spread of 3 calls) beside the Trainer loop's, the device's busy
   time and idle share, and telemetry.attribution.report over the flight
   recorder's records of 8 traced steps (each followed by its loss read):
   its buckets sum to the host clock's time per step within 1%, its MFU
   printed beside the phase's own. The kernel phase also times the flash
   forward, dq and dk/dv with dropout 0.1, their seed read by pointer.
10. Autotune phase: every built tensor-core tile of the flash forward,
   dq and dk/dv kernels (ops.flash_attention.TILES; bf16 and float16, a
   ragged T, a float key mask, dropout 0.1) against the plain version,
   the tile forced through autotune.forced and read back from
   ops.tile_counts; then autotune.sweep_flash_attention at the compiled
   step's shape (B = 8, H = 12, T = 512, D = 64, bf16, the valid_length
   float mask, dropout 0.1), which prunes tiles that spill (registers and
   local bytes from cudaFuncGetAttributes, each named), holds each
   candidate against the plain version and times it (CUDA events, the
   median of MXTPU_AUTOTUNE_REPS), writing the winners to a DB under
   build/autotune; bench.py's own call (batch 1, f32: one SIMT tile); a
   fresh resolve reads the winner back with source 'db'.
10a. Remat phase: the compiled step (BERT-base bf16, dropout 0.1, both
   knobs on) under MXTPU_REMAT none, layer and aggressive at B = 8 and
   B = 32: the eager first call and capture and 3 replays, held against
   'none' (REMAT_TOL), the peak bytes of a replay plus the graph pool, the
   step ms (median of 3 calls of 3 replays), and at B = 8 the flash
   forward's launches per replay (12, or 24 with a recompute); every run
   at the (64, 64) tile. Then path (b): the step at B = 8 with
   MXTPU_AUTOTUNE_DIR naming the sweep's DB, against the default tile
   (TUNED_TOL), its compile signature naming the db decision.
11. dp phase (after the compiled-step phase): data parallelism and ZeRO-1
   over torch.distributed. One process runs the reference: BERT-base
   BertForPretraining in bf16 with both knobs on, attention dropout 0.1
   from the shared stream of models.bert.dp_generators, hidden dropout
   0, the flagship batch (B = 8, T = 512), 5 steps of ShardedTrainStep
   (AdamW) and then 3 of the Trainer loop from the same weights. Then two
   rank processes of this script (--dp-rank) share the one card over gloo
   (asked for by name: NCCL refuses two ranks on one card), rendezvous
   through a FileStore under build/, each with B = 4 of the same batch:
   the same 5 steps with ZeRO-1 (the step captured in segments between
   its collectives) and the same 3 Trainer steps (ZeRO-1 in the fused
   update, step(batch_size) dividing the world's sum of the ranks' mean
   gradients by 2). Per-step losses and the f32 masters' updates are held
   to DP_TOL (chosen before the first run), each rank's launch counts to
   the eager step, the captures and the Trainer's steps; each kernel the
   path launches is held against its plain version at the rank's bh_base
   (0 and 48); opt_state_bytes_per_device at dp 2 against dp 1, the
   analytic ring bytes, the collectives' host ms and the step ms
   (two ranks on one card: not a speed figure) are printed beside the
   card; SyncBatchNorm in a small conv net at dp 2 against BatchNorm at
   dp 1, f32 with TF32 off, outputs and running statistics within 1e-5.
   Each rank then runs path (c): ZeRO-3 in ShardedTrainStep (eager,
   uncaptured: gloo cannot be captured) from the same weights, rows and
   attention masks, DP_STEPS steps, held to DP_TOL against its ZeRO-1
   run; the parameter bytes a rank holds over ZeRO-1's within
   [0.45, 0.55]; the layer groups, the group all-gathers a step and
   their host ms printed.
   With two or more cards it repeats the training part over NCCL, one
   rank per card, up to 4; with one it prints "nccl: not run (1 card)".
   A rank that fails or passes DP_TIMEOUT fails the script.
12. Resilience phase (after the dp phase): training that survives
   faults on the flagship path. (a) BERT-base BertForPretraining, bf16,
   dropout 0.1, both knobs on, ShardedTrainStep (AdamW, one CUDA graph)
   with a NonFiniteGuard and an async CheckpointManager (keep the last 2
   steps and every 4th, autosave every 2) under
   MXTPU_FAULT=step.dispatch:nan:1:0:5-7, 10 steps on 10 flagship
   batches, the launch counters at 0 just before: steps 5-7 give NaN
   losses and leave the parameters, masters, moments and update count
   bitwise as they were (the flag and the where-gate inside the graph);
   3 bad steps, one rollback, to step 4; committed 4, 8, 10 and no step
   5-7; the eager step and the capture launch each kernel 2 per layer
   (LayerNorm 4). (b) A fresh model and an unguarded step, captured on
   batch 1, restored from step 4 in place (no parameter tensor replaced,
   the RNG streams exact), replay steps 8-10: the same losses and
   byte-equal parameters, masters and moments. (e) Step ms (median of 3
   calls of 10) and kernel launches per replay, guarded against
   unguarded; a save's blocked ms (a manager's first, which pins its
   host buffers, and a later one, which reuses them), its seconds end to
   end and bytes, the restore's seconds. (c) A child
   process of this script (--resilience-child) trains a 2-layer bf16 BERT
   (hidden 256) under the SIGTERM hook and commits step 3 when signalled;
   a new manager restores it bitwise; a checkpoint.write:corrupt save of
   step 4 makes restore_latest fall back to 3; /healthz (a
   TelemetryServer on 127.0.0.1) reports the newest committed step. (d)
   The serving engine (BlockRunner over that BERT) with its watchdog
   armed: a burst of 32 requests from 4 threads gives no stall report; a
   runner planted to stall 3 s under a 1 s watchdog gives exactly one.
   Checkpoints live in a temporary directory removed at the end.
13. Removes what the run created under build/ (the kernels and the native
   io library it built, the tile database, the dp phase's files, the sym
   phase's checkpoint and exported files), so that a later process in
   the checkout, the `cuda` tests say, starts as it would have without
   this run.
14. Prints the kernels' JSON line (each row with its variant and dtype,
   A's, K2's and K3's launches per lm replay and per symbolic forward
   and backward (launches_per_sym_forward/_backward), their lm_shapes
   timings
   and, for a redesigned kernel, the time of the one it replaced, old_ms;
   the float16 routes as rows of their own, named kernel[float16], whose
   launches are the AMP phase's float16 ones) and, last, the result
   line.

Any failed check raises: the script exits non-zero and prints no result.
"""
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

SEED = 20261016
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12      # H100 SXM HBM3 bytes/s


def _zero_counters():
    """Every launch count and attention route count at 0."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import attention as attn_ops
    mt.ops.reset_launch_counts()
    for k in attn_ops.route_counts:
        attn_ops.route_counts[k] = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def stream_ms(fn, iters=20, warmup=3):
    """Mean stream time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (inputs stay warm in L2).
    Where the host takes longer to launch a call than the card to run
    it, this is the host's launch time."""
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
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(evt):
    t = getattr(evt, 'self_device_time_total', None)
    return t if t is not None else getattr(evt, 'self_cuda_time_total', 0)


def profile_device(fn, iters, expect=()):
    """torch.profiler CUDA trace of ``iters`` calls: {kernel name: total
    device microseconds} and the host seconds the calls took. A trace
    taken after one of CUDA-graph replays can come back without the
    kernels that ran (seen on the card: an empty trace, then whole ones);
    where a kernel named in ``expect`` is missing, the trace is taken
    again, up to 3 times, and the retry is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per_kernel = {e.key: _dev_us(e) for e in prof.key_averages()
                      if _dev_us(e) > 0}
        missing = [k for k in expect if not any(k in n for n in per_kernel)]
        if not missing:
            break
        print(f'  (profiler trace {attempt + 1} lacks {missing}: taken '
              f'again)')
    return per_kernel, wall


def steps_ms(step, steps):
    """Host ms per step over ``steps`` calls of ``step``, between
    synchronizes."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def kernel_launches(fn, iters, expect=None):
    """{kernel name: launches} in torch.profiler's CUDA trace of ``iters``
    calls of ``fn`` (kernels replayed from a CUDA graph included). A trace
    can drop events (seen on the card: 34 of a graph's 36 launches of a
    kernel); where ``expect`` ({name part: launches per call}) finds fewer
    than it names, the trace is taken again, up to 3 times, and the retry
    is printed. The caller checks the counts of the last trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if _dev_us(e) > 0}
        short = {k: sum(c for n, c in names.items() if k in n)
                 for k, want in (expect or {}).items()}
        short = {k: c for k, c in short.items() if c < expect[k] * iters}
        if not short:
            break
        print(f'  (profiler trace {attempt + 1} holds fewer launches than '
              f'{iters} calls make: {short}; taken again)')
    return names


def ops_split(names, iters):
    """(kernels, copies) per call in a ``kernel_launches`` result: the
    profiler's memcpy and memset events counted apart from the kernels."""
    copies = sum(c for n, c in names.items()
                 if n.startswith(('Memcpy', 'Memset')))
    return (sum(names.values()) - copies) / iters, copies / iters


def time_ms(fn, iters=20):
    """(ms, how): the mean device time of one call — the summed durations
    of the kernels it ran, from the profiler's trace — or, where the trace
    holds no device time, the CUDA-event stream time."""
    per_kernel, _ = profile_device(fn, iters)
    total = sum(per_kernel.values())
    if total > 0:
        return total / iters / 1e3, 'profiler'
    return stream_ms(fn, iters), 'events'


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes
                                       else 'bytes')


def compare(name, got, want, atol, rtol):
    """max |got - want| and max relative error; fails unless every
    element is within atol + rtol * |want|."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_abs = float(err.max())
    max_rel = float((err / w.abs().clamp_min(1e-6)).max())
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    print(f'  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} '
          f'tolerance atol={atol} rtol={rtol} -> {"ok" if ok else "FAIL"}')
    check(ok, f'{name} disagrees with its plain version')
    return max_abs


def timings(kernel, plain, library):
    """Device times of a kernel's wrapper, its plain version and the
    library yardstick, plus the kernel's back-to-back stream time."""
    (ms, how), (plain_ms, plain_how), (library_ms, library_how) = (
        time_ms(fn) for fn in (kernel, plain, library))
    return dict(ms=ms, how=f'{how}/{plain_how}/{library_how}',
                stream_ms=stream_ms(kernel), plain_ms=plain_ms,
                library_ms=library_ms)


# tolerances, kernel vs plain version on the same inputs on the card:
# f32 differs only by summation order; bf16 outputs may differ by one or
# two bf16 ulps (2**-8 relative) where the two round differently
TOL = {'float32': dict(atol=1e-4, rtol=1e-4),
       'bfloat16': dict(atol=1e-2, rtol=1.6e-2),
       'float16': dict(atol=2e-3, rtol=2e-3)}
# one BERT-base training step in bf16 on the card against f32 on the CPU
# (chosen before the first run; see PERF.md section 2)
TRAIN_TOL = {'loss_rel': 0.01, 'grad_rel_fro': 0.1, 'grad_min_cos': 0.95}


def kernel_phase(card):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import _build, fused_ffn, fused_layernorm
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    dev = 'cuda'
    rows = {}
    H, D, C, FF = 12, 64, 768, 3072

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    print(f'kernel phase on {card}')
    # ---- A: flash-attention forward. bf16 at D = 64 or 128 routes to the
    # tensor-core variant, f32 to the SIMT one; {'variant': 'simt'} forces
    # the SIMT kernel (the first design) at bf16, as nothing else does.
    # The serving shapes (B in {1, 8}, T in {64, 256}) come before the main
    # shape, which is last and timed.
    cases = [(8, 128, torch.bfloat16, {}), (8, 128, torch.float32, {}),
             (8, 512, torch.float32, {}),
             (8, 512, torch.bfloat16, {'causal': True}),
             (8, 512, torch.bfloat16, {'mask': True}),
             (8, 512, torch.bfloat16, {'dropout_p': 0.1}),
             (8, 200, torch.bfloat16, {'mask': True, 'causal': True}),
             (8, 512, torch.bfloat16, {'D': 128}),
             (8, 200, torch.bfloat16, {'D': 128, 'mask': True,
                                       'dropout_p': 0.1}),
             (8, 512, torch.bfloat16, {'variant': 'simt'}),
             (8, 200, torch.bfloat16, {'variant': 'simt', 'mask': True,
                                       'dropout_p': 0.1})] + \
        [(8, 512, torch.float16, opt) for opt in (
            {}, {'mask': True}, {'dropout_p': 0.1}, {'causal': True},
            {'D': 128, 'mask': True})] + \
        [(8, 200, torch.float16, {'mask': True, 'causal': True,
                                  'dropout_p': 0.1})] + \
        [(B, T, torch.bfloat16, {}) for B in (1, 8) for T in (64, 256)] + \
        [(8, 512, torch.bfloat16, {})]          # the main shape, timed
    errs16 = {}                                 # float16 main-shape errors

    def case_inputs(B, T, dtype, opt, n):
        Dc = opt.get('D', D)
        ts = [randn(B, H, T, Dc, dtype=dtype) for _ in range(n)]
        key_mask = None
        if opt.get('mask'):
            valid = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
            key_mask = torch.arange(T, device=dev)[None, :] < valid[:, None]
        p = opt.get('dropout_p', 0.0)
        variant = opt.get('variant') or fa.kernel_variant(dtype, Dc)
        shown = {key: x for key, x in opt.items() if key != 'variant'}
        tag = (f'B={B} T={T} D={Dc} {str(dtype)[6:]} [{variant}] '
               f'{shown or "plain"}')
        return ts, key_mask, opt.get('causal', False), p, \
            (1234 if p else None), variant, tag

    def one_launch(variant, dtype, *kernels):
        """the call launched exactly one of each of ``kernels``, of
        ``variant``, on ``dtype`` inputs, and nothing else"""
        got = dict(_build.variant_counts)
        names = {f'{k}.{variant}' for k in kernels}
        want = {k: int(k in names) for k in got}
        check(got == want, f'variant counts {got}, expected one each of '
              f'{sorted(names)}')
        want_dt = {f'{k}.{str(dtype)[6:]}': 1 for k in kernels}
        check(_build.dtype_counts == want_dt, f'dtype counts '
              f'{_build.dtype_counts}, expected {want_dt}')

    for B, T, dtype, opt in cases:
        (q, k, v), key_mask, causal, p, seed, variant, tag = case_inputs(
            B, T, dtype, opt, 3)
        _build.reset_launch_counts()
        out, lse = fa.flash_attention_forward(q, k, v, key_mask, causal, p,
                                              seed, _variant=variant)
        torch.cuda.synchronize()
        one_launch(variant, dtype, 'flash_attn_fwd')
        km, _ = fa._normalize_mask(key_mask, B, H, T)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, km, causal,
                                                        p, seed)
        tol = TOL[str(dtype)[6:]]
        err = compare(f'flash_attn_fwd {tag} out', out, ref_out, **tol)
        compare(f'flash_attn_fwd {tag} lse', lse, ref_lse, **TOL['float32'])
        if dtype == torch.float16 and not opt:
            errs16['flash_attn_fwd'] = err
    # the main shape: the tensor-core kernel, then the SIMT one it replaced
    times = timings(lambda: fa.flash_attention_forward(q, k, v),
                    lambda: fa.flash_attention_reference(q, k, v),
                    lambda: F.scaled_dot_product_attention(q, k, v))
    old_ms, _ = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, _variant='simt'))
    nbytes = 4 * q.numel() * q.element_size() + B * H * T * 4
    b_ms, b_by = bound_ms(4 * B * H * T * T * D, nbytes, PEAK_BF16)
    # with dropout 0.1, the seed drawn on the card and read by pointer
    seed_t = torch.randint(0, 2 ** 32, (1,), generator=gen, device=dev,
                           dtype=torch.int64)
    drop_ms, _ = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, None, False, 0.1, seed_t))
    rows['flash_attn_fwd'] = dict(
        route='cuda', source='mxnet_tpu_torch/csrc/flash_attn_fwd.cu',
        replaces='mxnet_tpu/ops/pallas_attention.py:171', variant='tc',
        dtype='bfloat16', old_ms=old_ms, max_abs_err=err, bound_ms=b_ms,
        bound_by=b_by, dropout_ms=drop_ms, **times)
    # the float16 route at the same shape (AMP's float16 target): the same
    # bytes and operations, the same 989 TFLOP/s peak
    q16, k16, v16 = (t.to(torch.float16) for t in (q, k, v))
    rows['flash_attn_fwd[float16]'] = dict(
        rows['flash_attn_fwd'], dtype='float16', old_ms=None,
        max_abs_err=errs16['flash_attn_fwd'],
        dropout_ms=time_ms(lambda: fa.flash_attention_forward(
            q16, k16, v16, None, False, 0.1, seed_t))[0],
        **timings(lambda: fa.flash_attention_forward(q16, k16, v16),
                  lambda: fa.flash_attention_reference(q16, k16, v16),
                  lambda: F.scaled_dot_product_attention(q16, k16, v16)))

    # ---- K2, K3: flash-attention backward (dq; dk and dv). Both kernels
    # route like the forward, to one variant.
    for B, T, dtype, opt in cases:
        (q, k, v, do), key_mask, causal, p, seed, variant, tag = case_inputs(
            B, T, dtype, opt, 4)
        out, lse = fa.flash_attention_forward(q, k, v, key_mask, causal, p,
                                              seed)
        _build.reset_launch_counts()
        grads = fa.flash_attention_backward(q, k, v, key_mask, causal, p,
                                            seed, out, lse, do,
                                            _variant=variant)
        torch.cuda.synchronize()
        one_launch(variant, dtype, 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv')
        km, _ = fa._normalize_mask(key_mask, B, H, T)
        want = fa.flash_attention_backward_reference(q, k, v, km, causal, p,
                                                     seed, out, lse, do)
        errs = [compare(f'flash_attn_bwd {tag} d{n}', g, w,
                        **TOL[str(dtype)[6:]])
                for n, g, w in zip('qkv', grads, want)]
        if dtype == torch.float16 and not opt:
            errs16['flash_attn_bwd_dq'] = errs[0]
            errs16['flash_attn_bwd_dkv'] = max(errs[1:])
    # float16 with ds past 65504: dO of order 2**13 (a loss scale) times v
    # of order 300, q and k of order 1e-3 so that dq and dk stay finite;
    # the tolerance adds the split's 2**-22 on each f32 term over T terms
    qb, kb, vb, dob = (randn(8, H, 512, D, dtype=torch.float32, scale=sc)
                       .half() for sc in (1e-3, 1e-3, 300.0, 8192.0))
    kmb, _ = fa._normalize_mask(torch.arange(512, device=dev)[None, :] <
                                torch.tensor([512, 300] * 4, device=dev)[
                                    :, None], 8, H, 512)
    ob, lb = fa.flash_attention_forward(qb, kb, vb, kmb)
    got = fa.flash_attention_backward(qb, kb, vb, kmb, False, 0.0, None, ob,
                                      lb, dob)
    want = fa.flash_attention_backward_reference(qb, kb, vb, kmb, False,
                                                 0.0, None, ob, lb, dob)
    pb = torch.exp(fa._scores(qb, kb, kmb, False) - lb[..., None])
    big = float((pb * torch.einsum('bhqd,bhkd->bhqk', dob.float(),
                                   vb.float())).abs().max()) * 2 / D ** 0.5
    check(big > 65504, f'the planted ds reaches only {big:.0f}')
    for n, g, w, other in (('q', got[0], want[0], kb),
                           ('k', got[1], want[1], qb)):
        check(bool(torch.isfinite(w).all()), f'plain d{n} not finite')
        compare(f'flash_attn_bwd float16, ds up to {big:.3g} d{n}', g, w,
                atol=max(2e-3, big * float(other.float().abs().max()) *
                         2 ** -22 * 512 ** 0.5), rtol=2e-3)
    del qb, kb, vb, dob, ob, lb, pb, got, want
    # timed at the training path's shape: bf16, B=8, T=512, with a float
    # additive key mask as the valid_length mask is; the SIMT dq and dk/dv
    # kernels in the same run
    valid = torch.randint(T // 2, T + 1, (B,), generator=gen, device=dev)
    fmask = torch.where(torch.arange(T, device=dev)[None, :] < valid[:, None],
                        0.0, -1e30).float()
    out, lse = fa.flash_attention_forward(q, k, v, fmask)

    def backward(variant=None):
        return fa.flash_attention_backward(q, k, v, fmask, False, 0.0, None,
                                           out, lse, do, _variant=variant)
    tc_names = ('flash_bwd_dq_tc_kernel', 'flash_bwd_dkv_tc_kernel')
    per_kernel, _ = profile_device(backward, 20, tc_names)
    per_kernel_simt, _ = profile_device(
        lambda: backward('simt'), 20,
        ('flash_bwd_dq_kernel', 'flash_bwd_dkv_kernel'))
    out_d, lse_d = fa.flash_attention_forward(q, k, v, fmask, False, 0.1,
                                              seed_t)
    per_kernel_drop, _ = profile_device(
        lambda: fa.flash_attention_backward(q, k, v, fmask, False, 0.1,
                                            seed_t, out_d, lse_d, do), 20,
        tc_names)
    # the float16 kernels at the same shape, with and without dropout
    q16, k16, v16, do16 = (t.to(torch.float16) for t in (q, k, v, do))
    out16, lse16 = fa.flash_attention_forward(q16, k16, v16, fmask)
    out16_d, lse16_d = fa.flash_attention_forward(q16, k16, v16, fmask,
                                                  False, 0.1, seed_t)
    per_kernel16, _ = profile_device(
        lambda: fa.flash_attention_backward(q16, k16, v16, fmask, False, 0.0,
                                            None, out16, lse16, do16), 20,
        tc_names)
    per_kernel16_drop, _ = profile_device(
        lambda: fa.flash_attention_backward(q16, k16, v16, fmask, False, 0.1,
                                            seed_t, out16_d, lse16_d, do16),
        20, tc_names)
    bwd_stream_ms = stream_ms(backward)
    km, _ = fa._normalize_mask(fmask, B, H, T)
    plain_ms, plain_how = time_ms(
        lambda: fa.flash_attention_backward_reference(
            q, k, v, km, False, 0.0, None, out, lse, do))
    plain16_ms, _ = time_ms(
        lambda: fa.flash_attention_backward_reference(
            q16, k16, v16, km, False, 0.0, None, out16, lse16, do16))

    def sdpa_backward_ms(q, k, v, do):
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=fmask.to(q.dtype)[:, None, None, :])
        return time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), do, retain_graph=True))
    library_ms, library_how = sdpa_backward_ms(q, k, v, do)
    library16_ms, _ = sdpa_backward_ms(q16, k16, v16, do16)
    io = q.numel() * q.element_size()          # one (B, H, T, D) tensor
    rows_f32 = 2 * B * H * T * 4 + fmask.numel() * 4   # lse, delta, mask

    def trace_ms(trace, kname):
        us = sum(t for n, t in trace.items() if kname in n)
        check(us > 0, f'no device time for {kname} in the trace')
        return us / 20 / 1e3
    for name, kname, old_kname, flops, nbytes, err in (
            ('flash_attn_bwd_dq', 'flash_bwd_dq_tc_kernel',
             'flash_bwd_dq_kernel', 6 * B * H * T * T * D, 5 * io + rows_f32,
             errs[0]),
            ('flash_attn_bwd_dkv', 'flash_bwd_dkv_tc_kernel',
             'flash_bwd_dkv_kernel', 8 * B * H * T * T * D,
             6 * io + rows_f32, max(errs[1:]))):
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
        rows[name] = dict(
            route='cuda', source='mxnet_tpu_torch/csrc/flash_attn_bwd.cu',
            replaces='mxnet_tpu/ops/pallas_attention.py:' +
            ('283' if name.endswith('dq') else '319'),
            variant='tc', dtype='bfloat16',
            old_ms=trace_ms(per_kernel_simt, old_kname),
            dropout_ms=trace_ms(per_kernel_drop, kname),
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            ms=trace_ms(per_kernel, kname),
            how=f'profiler/{plain_how}/{library_how}',
            stream_ms=bwd_stream_ms,
            plain_ms=plain_ms, library_ms=library_ms)
        rows[f'{name}[float16]'] = dict(
            rows[name], dtype='float16', old_ms=None,
            dropout_ms=trace_ms(per_kernel16_drop, kname),
            max_abs_err=errs16[name], ms=trace_ms(per_kernel16, kname),
            stream_ms=stream_ms(lambda: fa.flash_attention_backward(
                q16, k16, v16, fmask, False, 0.0, None, out16, lse16, do16)),
            plain_ms=plain16_ms, library_ms=library16_ms)
    delta_us = sum(t for n, t in per_kernel.items()
                   if 'flash_bwd' not in n) / 20
    print(f'  flash_attn_bwd: delta = rowsum(dO*O) and the allocations take '
          f'{delta_us / 1e3:.4f} ms of device time per backward beside the '
          f'two kernels; plain_ms (the whole plain backward) and library_ms '
          f'(the backward of F.scaled_dot_product_attention with the same '
          f'float mask, dq+dk+dv) are one time for both kernels, and so is '
          f'the stream time (the whole backward)')

    # ---- B: fused residual + LayerNorm
    for B, T, dtype in [(8, 128, torch.float32), (8, 512, torch.float32),
                        (8, 128, torch.bfloat16), (8, 512, torch.bfloat16)]:
        x, r = randn(B, T, C, dtype=dtype), randn(B, T, C, dtype=dtype)
        g = (1 + randn(C, dtype=torch.float32, scale=0.1)).to(dtype)
        b = randn(C, dtype=dtype, scale=0.1)
        out = fused_layernorm.fused_add_layer_norm(x, r, g, b, 1e-5)
        torch.cuda.synchronize()
        ref = fused_layernorm.add_layer_norm_reference(x, r, g, b, 1e-5)
        d = str(dtype)[6:]
        err = compare(f'fused_add_layernorm N={B * T} C={C} {d}', out, ref,
                      **({'atol': 1e-4, 'rtol': 0} if d == 'float32'
                         else {'atol': 0.05, 'rtol': 0}))
    times = timings(
        lambda: fused_layernorm.fused_add_layer_norm(x, r, g, b),
        lambda: fused_layernorm.add_layer_norm_reference(x, r, g, b),
        lambda: F.layer_norm(x + r, (C,), g, b, 1e-5))
    N = B * T
    b_ms, b_by = bound_ms(7 * N * C, (3 * N * C + 2 * C) * x.element_size(),
                          PEAK_F32)
    rows['fused_add_layernorm'] = dict(
        route='triton', variant='triton', dtype='bfloat16', old_ms=None,
        source='mxnet_tpu_torch/ops/fused_layernorm.py',
        replaces='mxnet_tpu/ops/pallas_layernorm.py:33',
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)

    # ---- C: fused FFN1 dense + bias + GELU. bf16 with K a multiple of 8
    # routes to the wgmma + TMA kernel (the serving buckets' M from 64 to
    # 4096, ragged M, N and K), other bf16 K to the WMMA kernel, f32 to the
    # SIMT one; {'variant': 'wmma'} forces the first design at bf16. The
    # main shape (training's M = B*T = 4096, and serving's largest bucket)
    # is last and timed.
    ffn_cases = [(M, K, N, torch.bfloat16, None)
                 for M in (64, 200, 1024, 4096) for K in (C, 72)
                 for N in (FF, 100) if (M, K, N) != (4096, C, FF)] + \
        [(200, 70, 100, torch.bfloat16, None),
         (4096, C, FF, torch.bfloat16, 'wmma'),
         (1024, C, FF, torch.float32, None),
         (4096, C, FF, torch.float32, None),
         (200, 70, 100, torch.float16, None),
         (1024, 72, 100, torch.float16, None),
         (4096, C, FF, torch.float16, 'wmma'),
         (4096, C, FF, torch.float16, None),
         (4096, C, FF, torch.bfloat16, None)]
    for M, K, N, dtype, forced in ffn_cases:
        x = randn(M, K, dtype=dtype)
        w = randn(N, K, dtype=dtype, scale=0.02)
        b = randn(N, dtype=dtype, scale=0.02)
        variant = forced or fused_ffn.kernel_variant(dtype, K)
        _build.reset_launch_counts()
        out = fused_ffn.fused_dense_gelu(x, w, b, _variant=forced)
        torch.cuda.synchronize()
        one_launch(variant, dtype, 'dense_gelu')
        ref = fused_ffn.dense_gelu_reference(x, w, b)
        err = compare(f'dense_gelu M={M} K={K} N={N} {str(dtype)[6:]} '
                      f'[{variant}]', out, ref, **TOL[str(dtype)[6:]])
        if (M, K, N, dtype, forced) == (4096, C, FF, torch.float16, None):
            errs16['dense_gelu'] = err
    # the main shape: the wgmma kernel, then the WMMA kernel it replaced
    times = timings(lambda: fused_ffn.fused_dense_gelu(x, w, b),
                    lambda: fused_ffn.dense_gelu_reference(x, w, b),
                    lambda: F.gelu(F.linear(x, w, b)))
    old_ms, _ = time_ms(lambda: fused_ffn.fused_dense_gelu(
        x, w, b, _variant='wmma'))
    b_ms, b_by = bound_ms(2 * M * N * K,
                          (M * K + N * K + N + M * N) * x.element_size(),
                          PEAK_BF16)
    rows['dense_gelu'] = dict(
        route='cuda', variant='tc', dtype='bfloat16', old_ms=old_ms,
        source='mxnet_tpu_torch/csrc/dense_gelu.cu',
        replaces='mxnet_tpu/ops/pallas_ffn.py:48',
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)
    x16, w16, b16 = (t.to(torch.float16) for t in (x, w, b))
    rows['dense_gelu[float16]'] = dict(
        rows['dense_gelu'], dtype='float16', max_abs_err=errs16['dense_gelu'],
        old_ms=time_ms(lambda: fused_ffn.fused_dense_gelu(
            x16, w16, b16, _variant='wmma'))[0],
        **timings(lambda: fused_ffn.fused_dense_gelu(x16, w16, b16),
                  lambda: fused_ffn.dense_gelu_reference(x16, w16, b16),
                  lambda: F.gelu(F.linear(x16, w16, b16))))

    for name, shapes in lm_kernel_cases(card).items():
        rows[name]['lm_shapes'] = shapes
    for name, r in rows.items():
        old = (f', the kernel it replaced {r["old_ms"]:.4f} ms'
               if r['old_ms'] is not None else '')
        if 'dropout_ms' in r:
            old += (f', with dropout 0.1 (seed by device pointer) '
                    f'{r["dropout_ms"]:.4f} ms')
        print(f'  timing {name} ({r["dtype"]}, B=8 T=512) on {card}: '
              f'device time '
              f'(kernel/plain/library from {r["how"]}) kernel '
              f'[{r["variant"]}] {r["ms"]:.4f} ms{old}, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms; '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}); back-to-back '
              f'stream time of the kernel {r["stream_ms"]:.4f} ms')
    return rows


# the language models' attention shapes (bf16, D = 64): GPT-2 small's
# causal self-attention at B = 8, T = 1024, H = 12, and Transformer-base's
# decoder cross-attention at B = 16, Tq = 200, Tk = 256, H = 8 under a key
# mask from valid lengths in [128, 256]
LM_ATTENTION = (('gpt2_causal_T1024', 8, 12, 1024, 1024, True, False),
                ('cross_Tq200_Tk256', 16, 8, 200, 256, False, True))


def _attention_pairs(B, H, Tq, Tk, causal, valid):
    """The (query, key) pairs the attention of these inputs needs: every
    key before the causal cut, and only the valid keys under a mask."""
    if causal:
        per_row = sum(min(i + 1, Tk) for i in range(Tq))
        return B * H * per_row
    keys = sum(valid) if valid is not None else B * Tk
    return H * Tq * keys


def lm_kernel_cases(card, reps=20):
    """A, K2 and K3 at LM_ATTENTION's shapes: each against its plain
    version (bf16 tolerances), exactly one launch of the tensor-core
    variant each, and timed (device time from the profiler's trace) beside
    the plain version, F.scaled_dot_product_attention (forward, and its
    backward for dq + dk + dv) and the bound of the pairs the inputs need.
    The causal forward is also timed without the causal flag: its kernel
    walks every key tile either way (csrc/flash_fwd_tc.cuh), while dq
    stops at the diagonal. Returns {row name: {shape label: numbers}}."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 16)
    D, dtype, tol = 64, torch.bfloat16, TOL['bfloat16']
    out_rows = {'flash_attn_fwd': {}, 'flash_attn_bwd_dq': {},
                'flash_attn_bwd_dkv': {}}
    tc_names = {'flash_attn_fwd': 'flash_fwd_tc_kernel',
                'flash_attn_bwd_dq': 'flash_bwd_dq_tc_kernel',
                'flash_attn_bwd_dkv': 'flash_bwd_dkv_tc_kernel'}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').to(dtype)

    def one_launch(*kernels):
        want = {f'{k}.tc' for k in kernels}
        got = {k for k, n in _build.variant_counts.items() if n}
        check(got == want and all(_build.variant_counts[k] == 1
                                  for k in want),
              f'variant counts {dict(_build.variant_counts)}, expected one '
              f'each of {sorted(want)}')

    for label, B, H, Tq, Tk, causal, masked in LM_ATTENTION:
        q, do = randn(B, H, Tq, D), randn(B, H, Tq, D)
        k, v = randn(B, H, Tk, D), randn(B, H, Tk, D)
        valid = key_mask = None
        if masked:
            valid = torch.randint(Tk // 2, Tk + 1, (B,), generator=gen,
                                  device='cuda')
            key_mask = torch.arange(Tk, device='cuda')[None, :] < \
                valid[:, None]
            valid = valid.tolist()
        check(fa.kernel_variant(dtype, D) == 'tc', 'not the tc variant')
        tag = f'{label} B={B} H={H} Tq={Tq} Tk={Tk} D={D} bf16 [tc]'
        _build.reset_launch_counts()
        out, lse = fa.flash_attention_forward(q, k, v, key_mask, causal)
        torch.cuda.synchronize()
        one_launch('flash_attn_fwd')
        km, _ = fa._normalize_mask(key_mask, B, H, Tk)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, km, causal)
        err_f = compare(f'flash_attn_fwd {tag} out', out, ref_out, **tol)
        compare(f'flash_attn_fwd {tag} lse', lse, ref_lse, **TOL['float32'])
        _build.reset_launch_counts()
        grads = fa.flash_attention_backward(q, k, v, key_mask, causal, 0.0,
                                            None, out, lse, do)
        torch.cuda.synchronize()
        one_launch('flash_attn_bwd_dq', 'flash_attn_bwd_dkv')
        want = fa.flash_attention_backward_reference(q, k, v, km, causal,
                                                     0.0, None, out, lse, do)
        errs = [compare(f'flash_attn_bwd {tag} d{n}', g, w, **tol)
                for n, g, w in zip('qkv', grads, want)]

        # timings: the kernels, their plain versions and the library's
        sdpa_mask = key_mask[:, None, None, :] if masked else None
        fwd = timings(
            lambda: fa.flash_attention_forward(q, k, v, key_mask, causal),
            lambda: fa.flash_attention_reference(q, k, v, km, causal),
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, is_causal=causal))
        per_kernel, _ = profile_device(
            lambda: fa.flash_attention_backward(q, k, v, key_mask, causal,
                                                0.0, None, out, lse, do),
            reps, (tc_names['flash_attn_bwd_dq'],
                   tc_names['flash_attn_bwd_dkv']))
        plain_bwd, _ = time_ms(
            lambda: fa.flash_attention_backward_reference(
                q, k, v, km, causal, 0.0, None, out, lse, do))
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        s_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask,
                                               is_causal=causal)
        sdpa_bwd, _ = time_ms(lambda: torch.autograd.grad(
            s_out, (qs, ks, vs), do, retain_graph=True))
        pairs = _attention_pairs(B, H, Tq, Tk, causal, valid)
        # bytes: K and V are read for the keys the mask keeps only (a masked
        # key changes nothing); dk and dv are written whole
        ioq, iok = (B * H * T * D * 2 for T in (Tq, Tk))
        iok_read = H * (sum(valid) if masked else B * Tk) * D * 2
        rows_f32 = B * H * Tq * 4 + (B * Tk * 4 if masked else 0)
        for name, flops, nbytes, err, ms, plain, lib in (
                ('flash_attn_fwd', 4 * D * pairs, 2 * ioq + 2 * iok_read +
                 rows_f32, err_f, fwd['ms'], fwd['plain_ms'],
                 fwd['library_ms']),
                ('flash_attn_bwd_dq', 6 * D * pairs, 3 * ioq + 2 * iok_read +
                 2 * rows_f32, errs[0], None, plain_bwd, sdpa_bwd),
                ('flash_attn_bwd_dkv', 8 * D * pairs, 2 * ioq + 2 * iok_read +
                 2 * iok + 2 * rows_f32, max(errs[1:]), None, plain_bwd,
                 sdpa_bwd)):
            if ms is None:
                us = sum(t for n_, t in per_kernel.items()
                         if tc_names[name] in n_)
                check(us > 0, f'no device time for {tc_names[name]}')
                ms = us / reps / 1e3
            b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
            out_rows[name][label] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, pairs=pairs)
        if causal:
            out_rows['flash_attn_fwd'][label]['noncausal_ms'] = time_ms(
                lambda: fa.flash_attention_forward(q, k, v))[0]
        for name, r in out_rows.items():
            r = r[label]
            extra = (f', the same forward without the causal cut '
                     f'{r["noncausal_ms"]:.4f} ms' if 'noncausal_ms' in r
                     else '')
            print(f'  timing {name} at {tag} on {card}: kernel '
                  f'{r["ms"]:.4f} ms{extra}, plain {r["plain_ms"]:.4f} ms, '
                  f'library {r["library_ms"]:.4f} ms (SDPA; for dq and '
                  f'dk/dv its whole backward); bound {r["bound_ms"]:.4f} ms '
                  f'({r["bound_by"]}, {pairs} query-key pairs)')
        del q, k, v, do, out, lse, grads, want, qs, ks, vs, s_out
    torch.cuda.empty_cache()
    return out_rows


_FAMILIES = (('flash_attn_fwd', ('flash_fwd_kernel', 'flash_fwd_tc_kernel')),
             ('flash_attn_bwd_dq', ('flash_bwd_dq_kernel',
                                    'flash_bwd_dq_tc_kernel')),
             ('flash_attn_bwd_dkv', ('flash_bwd_dkv_kernel',
                                     'flash_bwd_dkv_tc_kernel')),
             ('fused_add_layernorm', ('_add_ln_fwd',)),
             ('dense_gelu', ('dense_gelu_',)),
             ('rtc user kernels', ('gelu_fwd', 'gelu_bwd', 'scale_add',
                                   'block_double', 'rowsum')),
             ('batch_norm', ('batch_norm_',)),
             ('layout conversions', ('nchwToNhwc', 'nhwcToNchw')),
             ('pooling', ('max_pool', 'avg_pool', 'adaptive_')),
             ('library GEMMs', ('gemm', 'nvjet', 'cutlass', 'xmma')))


_OP_NAMES = (
    # PyTorch kernels name the op in a functor or a kernel of their own
    ('embedding_backward', 'embedding backward'),
    ('indexing_backward', 'embedding backward'),
    ('index_put', 'index_put (embedding backward)'),
    ('gelu_backward', 'GELU backward'),
    ('GeluBackward', 'GELU backward'),
    ('GeluCUDAKernel', 'GELU'),
    ('layer_norm_grad', 'LayerNorm backward'),
    ('LayerNormBackward', 'LayerNorm backward'),
    ('GammaBeta', 'LayerNorm backward (gamma, beta)'),
    ('layer_norm', 'LayerNorm'),
    ('LayerNorm', 'LayerNorm'),
    ('softmax_warp_backward', 'log_softmax backward'),
    ('cunn_SoftMaxBackward', 'log_softmax backward'),
    ('softmax', 'log_softmax'),
    ('SoftMax', 'log_softmax'),
    ('multi_tensor_apply', 'multi-tensor (foreach) ops'),
    ('reduce_kernel', 'reductions (sums: bias grads, LayerNorm stats, norms)'),
    ('erf', 'erf (GELU)'),
    ('exp_kernel', 'exp'),
    ('sqrt', 'sqrt (AdamW)'),
    ('div_true', 'div (AdamW)'),
    ('Functor_add', 'add'),
    ('AddFunctor', 'add'),
    ('MulFunctor', 'mul'),
    ('Functor_mul', 'mul'),
    ('direct_copy', 'copy / dtype cast'),
    ('copy_kernel', 'copy / dtype cast'),
    ('CatArrayBatchedCopy', 'cat'),
    ('where', 'where'),
    ('fill', 'fill / zero'),
    ('gather', 'gather'),
    ('scatter', 'scatter'),
    ('elementwise_kernel', 'other elementwise'),
)


def op_of(kernel):
    """The op a PyTorch kernel's name says it computes (first match of
    _OP_NAMES), else the name's first 60 characters."""
    return next((op for pat, op in _OP_NAMES if pat in kernel), kernel[:60])


def device_breakdown(label, fn, card, iters, other_by_op=False):
    """Device time of one call of ``fn`` by kernel family, from
    torch.profiler's CUDA trace, and the device's idle share: one minus
    the kernels' summed time over the call's host time. With
    ``other_by_op``, the family 'other' is also broken down by op."""
    per_kernel, wall = profile_device(fn, iters)
    fam = {}
    for name, us in per_kernel.items():
        f = next((f for f, pats in _FAMILIES
                  if any(p in name for p in pats)), 'other')
        fam[f] = fam.get(f, 0.0) + us / iters / 1e3
    busy = sum(fam.values())
    per = wall / iters * 1e3
    print(f'  {label} on {card}: host {per:.3f} ms, '
          f'device busy {busy:.3f} ms, idle share '
          f'{max(0.0, 1 - busy / per):.3f}; by family: ' + ', '.join(
              f'{f} {ms:.3f} ms ({ms / busy:.1%})' for f, ms in
              sorted(fam.items(), key=lambda kv: -kv[1])))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f'  top kernels per {label}: ' + '; '.join(
        f'{n[:60]} {us / iters / 1e3:.3f} ms' for n, us in top))
    out = dict(host_ms=per, busy_ms=busy, idle=max(0.0, 1 - busy / per),
               families=fam)
    if other_by_op:
        ops = {}
        for name, us in per_kernel.items():
            if not any(p in name for _, pats in _FAMILIES for p in pats):
                op = op_of(name)
                ops[op] = ops.get(op, 0.0) + us / iters / 1e3
        out['other_by_op'] = ops
        print(f'  "other" of {label} by op: ' + '; '.join(
            f'{op} {ms:.3f} ms' for op, ms in
            sorted(ops.items(), key=lambda kv: -kv[1])))
    return out


def dispatch_breakdown(engine, card, label, batch=8, seq=512, iters=3):
    """One dispatch of the largest bucket (tokens in, output back to the
    host included): host ms, device busy ms and idle share."""
    return device_breakdown(f'dispatch b{batch}_s{seq}, {label}',
                            lambda: engine.run_bucket(batch, seq), card,
                            iters)


def random_bert_arrays(net, seed=SEED):
    """Normal(0.02) for every weight, drawn with numpy from ``seed``;
    gamma, beta and biases keep their constructed one/zero."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    arrays = {}
    for name, p in net.named_parameters():
        if name.endswith('weight'):
            arrays[name] = (rng.standard_normal(tuple(p.shape))
                            .astype(onp.float32) * onp.float32(0.02))
        else:
            # a copy: on the CPU numpy() would share the parameter's storage
            arrays[name] = p.detach().float().cpu().numpy().copy()
    return arrays


# the serving kernels' names in a profiler trace, by launch-counter name
SERVE_KERNELS = {'flash_attn_fwd': 'flash_fwd_tc_kernel',
                 'fused_add_layernorm': '_add_ln_fwd',
                 'dense_gelu': 'dense_gelu_tc_kernel'}


def replay_launches(engine, batch, seq, replays=3):
    """{launch-counter name: launches per dispatch} of the serving
    kernels in a profiler trace of ``replays`` dispatches of one bucket
    (a replayed graph's kernels are in the trace; the wrappers' counters
    do not move)."""
    names = kernel_launches(lambda: engine.run_bucket(batch, seq), replays)
    return {k: sum(c for n, c in names.items() if v in n) / replays
            for k, v in SERVE_KERNELS.items()}


def copy_back_ms(shape, iters=20):
    """Host ms of one copy of an f32 device tensor of ``shape`` to the
    host: pageable (``.cpu()``) and into a kept pinned buffer
    (``non_blocking`` copy, then a wait on its event), alternated."""
    import torch
    out = torch.randn(shape, device='cuda')
    buf = torch.empty(shape, pin_memory=True)
    done = torch.cuda.Event()

    def pageable():
        out.cpu()

    def pinned():
        buf.copy_(out, non_blocking=True)
        done.record()
        done.synchronize()
    times = {'pageable': [], 'pinned': []}
    for fn in (pageable, pinned):
        fn()
    for _ in range(2):
        for name, fn in (('pageable', pageable), ('pinned', pinned),
                         ('pinned', pinned), ('pageable', pageable)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times[name].append((time.perf_counter() - t0) / iters * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def serving_phase(card):
    """The serving recipe: InferenceEngine(BlockRunner(net)) hybridizes
    BERT-base, serving.warmup captures one CUDA graph per bucket, and
    every request replays one. See the module docstring, item 4."""
    import warnings
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models.bert import BertModel, bert_base_config
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    comp = telemetry.compile
    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    L = cfg['layers']
    net = BertModel(**cfg, dtype=torch.bfloat16, device='cuda')
    arrays = random_bert_arrays(net)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    engine = mt.serving.InferenceEngine(
        mt.serving.BlockRunner(net), seq_buckets='64,128,256,512',
        batch_buckets='1,2,4,8')
    grid = engine.bucket_grid()
    check(net._active, 'BlockRunner did not hybridize the block')
    try:
        # eager first (hybridize(False)): each bucket's output, and the
        # eager dispatch breakdown
        net.hybridize(False)
        eager = {(b, s): engine.runner(onp.full((b, s), 7, 'int32')).copy()
                 for b, s in grid}
        eager_bd = dispatch_breakdown(engine, card, 'eager (hybridize(False))')
        net.hybridize()

        # the main path's run, warmup and burst: counters at 0 just before
        comp.enable()
        comp.clear(ledger='')
        _zero_counters()
        t0 = time.perf_counter()
        rep = mt.serving.warmup(engine)
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        pools = net._cached_op.memory_pools().get('cuda_graphs', {})
        ledger = comp.ledger()
        warm_sites = sorted(e['site'] for e in ledger
                            if e['site'].startswith('serving:warmup_'))
        caps = [e['seconds']['capture'] for e in ledger
                if e['site'].startswith('serving:warmup_')]
        print(f'serving phase on {card}: BERT-base bf16, warmup of '
              f'{len(rep["buckets"])} buckets took {warm_s:.2f} s '
              f'({net._cached_op.num_graphs} CUDA graphs; compile ledger: '
              f'{len(ledger)} entries, {len(warm_sites)} serving:warmup_*, '
              f'capture seconds {sum(caps):.3f} in all, largest '
              f'{max(caps):.3f}); memory_reserved after warmup '
              f'{reserved / 2**20:.1f} MiB, graph pools '
              f'{sum(pools.values()) / 2**20:.1f} MiB over {len(pools)} '
              f'graphs')
        check(net._cached_op.num_graphs == len(grid) == 16,
              f'{net._cached_op.num_graphs} graphs for {len(grid)} buckets')
        check(warm_sites == sorted(f'serving:warmup_b{b}_s{s}'
                                   for b, s in grid),
              f'ledger serving:warmup_* sites {warm_sites}')
        check(comp.validate_ledger(ledger) == [], 'ledger fails validation')
        after_warmup = dict(mt.ops.launch_counts)

        rng = onp.random.RandomState(SEED)
        requests = [rng.randint(1, cfg['vocab_size'], int(n)).tolist()
                    for n in rng.randint(8, 513, 64)]

        def burst():
            results, errors = [None] * len(requests), []

            def client(idx):
                try:
                    handles = [(i, engine.submit_async(requests[i]))
                               for i in idx]
                    for i, h in handles:
                        results[i] = engine.result(h, timeout=300.0)
                except Exception as e:                # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client,
                                        args=(range(t, len(requests), 4),))
                       for t in range(4)]
            b0 = engine.stats()['batches']
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            check(not any(t.is_alive() for t in threads), 'a client hung')
            check(not errors, f'client errors: {errors!r}')
            check(all(r is not None for r in results),
                  'a request went unanswered')
            return results, wall, engine.stats()['batches'] - b0

        n_ledger = len(comp.ledger())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            results, wall, dispatches = burst()
        launches = dict(mt.ops.launch_counts)
        variants = dict(mt.ops.variant_counts)
        routes = dict(attn_ops.route_counts)
        stats = engine.stats()
        recompiles = [w for w in caught
                      if type(w.message).__name__ == 'RecompileWarning']
        for req, out in zip(requests, results):
            check(out.shape == (len(req), cfg['hidden']),
                  f'output shape {out.shape} for length {len(req)}')
            check(bool(onp.isfinite(out).all()), 'non-finite output')
        print(f'  burst: {len(requests)} requests in {dispatches} '
              f'dispatches; compile ledger {n_ledger} -> '
              f'{len(comp.ledger())} entries, {len(recompiles)} recompile '
              f'warnings, {net._cached_op.num_graphs} graphs; launch '
              f'counters {launches} (moved only at warmup: eager run and '
              f'capture of each bucket), variants {variants}, routes '
              f'{routes}')
        check(len(comp.ledger()) == n_ledger and not recompiles,
              'the burst captured or compiled')
        check(net._cached_op.num_graphs == 16, 'the burst added a graph')
        check(launches == after_warmup, 'a replay moved the launch counters')
        check(routes['flash'] > 0, 'attention never took the flash route')
        check(launches == {'flash_attn_fwd': 2 * L * 16,
                           'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
                           'fused_add_layernorm': 4 * L * 16,
                           'dense_gelu': 2 * L * 16},
              f'launch counts {launches} for the warmup of 16 buckets')
        check(variants == {k: 2 * L * 16 if k in (
            'flash_attn_fwd.tc', 'dense_gelu.tc') else 0 for k in variants},
              f'variant counts {variants}')
        print(f'  served {len(requests)} requests in {wall:.3f} s: '
              f'{len(requests) / wall:.2f} requests/s, '
              f'p50 {stats["p50_ms"]} ms, p99 {stats["p99_ms"]} ms, '
              f'shed {stats["shed"]} on {card}')
        per_replay = replay_launches(engine, 8, 512)
        print(f'  kernel launches per dispatch (profiler, 3 replays of '
              f'b8_s512): {per_replay}')
        check(per_replay == {'flash_attn_fwd': L, 'fused_add_layernorm':
                             2 * L, 'dense_gelu': L},
              f'launches per replay {per_replay}')

        # captured against eager, bitwise, per bucket; pinned against
        # pageable, bitwise
        for b, s in grid:
            got = engine.runner(onp.full((b, s), 7, 'int32'))
            check(onp.array_equal(got, eager[(b, s)]),
                  f'bucket b{b}_s{s}: the replay differs from eager')
        mat = onp.full((8, 512), 7, 'int32')
        was = engine.runner.pinned
        check(was, 'the runner copies through pageable memory')
        pinned = engine.runner(mat).copy()
        engine.runner.pinned = False
        pageable = engine.runner(mat)
        engine.runner.pinned = was
        check(onp.array_equal(pinned, pageable),
              'the pinned copy differs from the pageable one')
        copy = copy_back_ms((8, 512, cfg['hidden']))
        print(f'  all 16 buckets: replay bitwise equal to eager; pinned copy '
              f'bitwise equal to pageable; copy of one 8 x 512 x 768 f32 '
              f'output: pinned {copy["pinned"]:.3f} ms, pageable '
              f'{copy["pageable"]:.3f} ms (median of 4 x 20) on {card}')
        cap_bd = dispatch_breakdown(engine, card,
                                    'captured (graph replay, pinned copy)')

        # two of the host steps around a replay, timed alone
        def host_us(fn, n=200):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e6
        tok = torch.from_numpy(mat).to('cuda')
        with torch.inference_mode():
            key_us = host_us(lambda: net._cached_op.key((tok,)))
        upload_us = host_us(lambda: torch.from_numpy(mat).to('cuda'))
        print(f'  host time of one 8 x 512 dispatch step on {card}: the '
              f'CachedOp key {key_us:.1f} us, the token upload '
              f'{upload_us:.1f} us')

        # telemetry armed: its counters against engine.stats(), its spans
        # against the dispatches, and the hook cost per dispatch
        def per_dispatch_ms(n=20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                engine.run_bucket(8, 512)
            return (time.perf_counter() - t0) / n * 1e3
        cost = {'disarmed': [], 'armed': []}
        for armed in (False, True, True, False):
            (telemetry.enable if armed else telemetry.disable)()
            (telemetry.trace.enable if armed else telemetry.trace.disable)()
            cost['armed' if armed else 'disarmed'].append(per_dispatch_ms())
        telemetry.reset()
        telemetry.trace.clear()
        telemetry.enable()
        telemetry.trace.enable()
        before = engine.stats()
        _, wall2, dispatches2 = burst()
        after = engine.stats()
        prom = telemetry.prometheus()
        spans = [e for e in telemetry.trace.chrome_events()
                 if e['ph'] == 'B' and e['name'] == 'serving.dispatch']
        telemetry.disable()
        telemetry.trace.disable()

        def prom_value(metric):
            return sum(float(line.rsplit(' ', 1)[1])
                       for line in prom.splitlines()
                       if line.startswith(metric + '{'))
        got = {k: prom_value(f'mxnet_tpu_serving_{k}_total')
               for k in ('requests', 'batches')}
        want = {k: after[k] - before[k] for k in ('requests', 'batches')}
        print(f'  telemetry armed: burst of {len(requests)} in '
              f'{wall2:.3f} s; prometheus {got} vs engine.stats() {want}; '
              f'{len(spans)} serving.dispatch spans for {dispatches2} '
              f'dispatches; one b8_s512 dispatch {sorted(cost["disarmed"])} '
              f'ms disarmed, {sorted(cost["armed"])} ms armed on {card}')
        check(got == want, f'prometheus {got} != engine.stats() {want}')
        check(len(spans) == dispatches2,
              f'{len(spans)} spans for {dispatches2} dispatches')

        # one request against the same weights in f32 on the CPU (plain
        # versions throughout); bf16 through 12 layers is expected to
        # stay within a few percent
        req = requests[0]
        s = mt.serving.seq_bucket_for(len(req), engine.seq_buckets)
        cpu = BertModel(**cfg, device='cpu').eval()
        cpu.load_state_dict(params_from_mxnet_tpu(arrays, cpu))
        tok = torch.zeros(1, s, dtype=torch.int64)
        tok[0, :len(req)] = torch.tensor(req)
        with torch.inference_mode():
            want = cpu(tok)[0][0, :len(req)].numpy()

        def agree(name, got):
            err = onp.abs(got - want)
            rel = float(onp.linalg.norm(got - want) / onp.linalg.norm(want))
            ok = float(err.max()) <= 0.5 and rel <= 0.05
            print(f'  {name} vs f32 CPU plain (length {len(req)}): '
                  f'max_abs_err={float(err.max()):.4f} '
                  f'rel_fro_err={rel:.5f} tolerance max_abs<=0.5 '
                  f'rel_fro<=0.05 -> {"ok" if ok else "FAIL"}')
            check(ok, f'{name} disagrees with the f32 CPU reference')

        agree('served bf16, all three kernels', results[0])
        # flash only: a captured bucket keeps its route, so the flip is
        # followed by hybridize(), which drops the graphs; the request's
        # bucket is captured again, on the engine's worker thread
        os.environ['MXTPU_PALLAS_LN'] = '0'
        os.environ['MXTPU_PALLAS_FFN'] = '0'
        net.hybridize()
        agree('served bf16, flash only', engine.submit(req, timeout=300.0))
        flash_only = replay_launches(engine, 1, s)
        print(f'  flash only, launches per dispatch (profiler, 3 replays of '
              f'b1_s{s}): {flash_only}')
        check(flash_only == {'flash_attn_fwd': L, 'fused_add_layernorm': 0,
                             'dense_gelu': 0},
              f'flash-only launches per replay {flash_only}')
    finally:
        engine.drain()
        comp.disable()
        comp.clear(ledger='')
    return (launches, per_replay,
            dict(stats, rps=len(requests) / wall, eager=eager_bd,
                 captured=cap_bd))


FRONT_BUCKETS = dict(seq_buckets='64,128,256,512', batch_buckets='1,2,4,8')
FRONT_TIMEOUT = 300.0      # seconds, every HTTP call and wait of the phase


def front_phase(card, burst_n=32, clients=4):
    """The serving replica's front door: two BERT-base bf16 replicas, each
    InferenceEngine(BlockRunner(net)) behind serving.PredictServer on
    loopback, and a serving.Router over both. See the module docstring,
    item 5."""
    import tempfile
    import urllib.request
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.checkpoint import manifest as mf
    from mxnet_tpu_torch.models.bert import BertModel, bert_base_config
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    comp = telemetry.compile
    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    L, H = cfg['layers'], cfg['hidden']
    host = '127.0.0.1'

    def bert(seed):
        net = BertModel(**cfg, dtype=torch.bfloat16, device='cuda')
        net.load_state_dict(params_from_mxnet_tpu(
            random_bert_arrays(net, seed), net))
        return net

    def ask(port, path, doc=None):
        return serving.http_json(host, port, path, doc,
                                 timeout=FRONT_TIMEOUT)

    def cachedop_entries():
        return [e for e in comp.ledger() if e['site'].startswith('cachedop:')]

    telemetry.reset()
    telemetry.enable()
    telemetry.trace.clear()
    telemetry.trace.enable()
    comp.enable()
    comp.clear(ledger='')
    engines, servers = [], []
    tmp = tempfile.TemporaryDirectory(prefix='mxtt-front-')
    try:
        # the main path's run: the counters at 0 just before the replicas
        # are built and warmed (each bucket's eager run and capture); the
        # HTTP dispatches replay the graphs
        mt.ops.reset_launch_counts()
        nets = []
        for i in range(2):
            net = bert(SEED)
            eng = serving.InferenceEngine(serving.BlockRunner(net),
                                          name=f'front{i}', **FRONT_BUCKETS)
            nets.append(net)
            engines.append(eng)
            t0 = time.perf_counter()
            serving.warmup(eng)
            warm_s = time.perf_counter() - t0
            check(net._cached_op.num_graphs == 16,
                  f'replica {i}: {net._cached_op.num_graphs} graphs')
            servers.append(serving.PredictServer(eng, port=0, block=net))
            print(f'front phase on {card}: replica {i} (BERT-base bf16) '
                  f'warmed {net._cached_op.num_graphs} CUDA graphs in '
                  f'{warm_s:.2f} s; PredictServer on {host}:'
                  f'{servers[-1].port}')
        check(len(cachedop_entries()) == 32,
              f'{len(cachedop_entries())} cachedop: ledger entries for two '
              f'warmups of 16 buckets')
        after_warmup = dict(mt.ops.launch_counts)
        ports = [s.port for s in servers]
        rng = onp.random.RandomState(SEED + 7)

        # /predict, one sequence and a list (one sequence per seq bucket,
        # so each is a batch of one, as the in-process submit below is):
        # bitwise the engine's own result after the JSON round trip
        seqs = [rng.randint(1, cfg['vocab_size'], n).tolist()
                for n in (40, 100, 200, 400)]
        st, one = ask(ports[0], '/predict', {'inputs': seqs[0]})
        check(st == 200, f'/predict answered {st}: {one}')
        st, many = ask(ports[0], '/predict', {'inputs': seqs})
        check(st == 200, f'/predict (list) answered {st}')
        direct = [engines[0].submit(s, timeout=FRONT_TIMEOUT) for s in seqs]
        for g, w in zip([one['outputs']] + many['outputs'],
                        [direct[0]] + direct):
            g = onp.asarray(g)
            check(g.shape == w.shape and onp.array_equal(
                g, w.astype(onp.float64)),
                  f'HTTP output {g.shape} differs from the in-process '
                  f'engine\'s {w.shape}')
        print(f'  /predict single and list ({[len(s) for s in seqs]} '
              f'tokens): bitwise the in-process engine\'s outputs after the '
              f'JSON round trip')

        # /metrics carries the engine's counters
        with urllib.request.urlopen(f'http://{host}:{ports[0]}/metrics',
                                    timeout=FRONT_TIMEOUT) as r:
            prom = r.read().decode()

        def prom_value(metric, engine):
            return sum(float(line.rsplit(' ', 1)[1])
                       for line in prom.splitlines()
                       if line.startswith(metric + '{')
                       and f'engine="{engine}"' in line)
        stats0 = engines[0].stats()
        scraped = {k: prom_value(f'mxnet_tpu_serving_{k}_total', 'front0')
                   for k in ('requests', 'batches')}
        check(scraped == {k: stats0[k] for k in ('requests', 'batches')},
              f'/metrics {scraped} vs engine.stats() {stats0}')
        print(f'  /metrics: mxnet_tpu_serving_{{requests,batches}}_total '
              f'{scraped} = engine.stats()')

        # /healthz['memory'] is the allocator's live bytes
        m0 = torch.cuda.memory_allocated()
        st, health = ask(ports[0], '/healthz')
        m1 = torch.cuda.memory_allocated()
        mem = health['memory']
        check(st == 200 and mem['source'] == 'memory_stats' and
              min(m0, m1) <= mem['live_bytes'] <= max(m0, m1),
              f'/healthz memory {mem} vs allocated {m0}, {m1}')
        print(f'  /healthz memory: live {mem["live_bytes"] / 2**20:.1f} MiB '
              f'(torch.cuda.memory_allocated {m0 / 2**20:.1f} MiB), peak '
              f'{mem["peak_bytes"] / 2**20:.1f} MiB, source {mem["source"]}')

        # admission below the live bytes: 503, shed before the device
        before = engines[0].stats()
        engines[0].admission = serving.memory_admission(
            mem['live_bytes'] / 2 / 2**20)
        st, doc = ask(ports[0], '/predict', {'inputs': seqs[0]})
        engines[0].admission = None
        after = engines[0].stats()
        check(st == 503 and 'memory_pressure' in doc['error'],
              f'admission answered {st}: {doc}')
        check(after['batches'] == before['batches'] and
              after['requests'] == before['requests'] and
              after['shed'] == before['shed'] + 1,
              f'the shed request reached the engine: {before} -> {after}')
        print(f'  memory_admission at half the live bytes: 503 '
              f'({doc["error"]}); dispatches {before["batches"]} -> '
              f'{after["batches"]}')

        # /reload by path: a second weight set copied into the captured
        # graphs' parameters; no capture; the second set's eager output
        donor = bert(SEED + 1)
        path = os.path.join(tmp.name, 'second.params')
        donor.save_parameters(path)
        caps = len(cachedop_entries())
        n_ledger = len(comp.ledger())
        ptrs = {n: p.data_ptr() for n, p in nets[0].named_parameters()}
        st, doc = ask(ports[0], '/reload', {'path': path})
        check(st == 200 and doc['reloaded'], f'/reload answered {st} {doc}')
        st, doc = ask(ports[0], '/predict', {'inputs': seqs[1]})
        check(st == 200, f'/predict after /reload answered {st}')
        padded = onp.zeros((1, 128), 'int32')
        padded[0, :len(seqs[1])] = seqs[1]
        donor.eval()
        counted = dict(mt.ops.launch_counts)
        with torch.inference_mode():
            eager = donor(torch.from_numpy(padded).cuda())[0][
                0, :len(seqs[1])].float().cpu().numpy()
        # the reference's eager launches are not the path's
        reference = {k: mt.ops.launch_counts[k] - counted[k]
                     for k in counted}
        check(onp.array_equal(onp.asarray(doc['outputs']),
                              eager.astype(onp.float64)),
              'the reloaded replica differs from the second set\'s eager '
              'forward')
        check(len(comp.ledger()) == n_ledger and
              len(cachedop_entries()) == caps, '/reload captured a graph')
        check({n: p.data_ptr() for n, p in nets[0].named_parameters()}
              == ptrs, '/reload moved a parameter\'s storage')
        del donor
        print(f'  /reload by path: the replayed graphs serve the second '
              f'weight set, bitwise its eager forward; compile ledger '
              f'{n_ledger} -> {len(comp.ledger())} entries; parameters in '
              f'place')

        # /reload {"ns", "step"} on a corrupted step directory: 409
        servers[0].replica_root = tmp.name
        d = os.path.join(tmp.name, 'serving', mf.step_dir_name(7))
        os.makedirs(d)
        with open(path, 'rb') as f:
            data = f.read()
        with open(os.path.join(d, 'weights.params'), 'wb') as f:
            f.write(data[:-1] + bytes([data[-1] ^ 0xFF]))
        mf.write_manifest(d, {'step': 7, 'blobs': [{
            'name': 'weights', 'file': 'weights.params',
            'bytes': len(data), 'sha256': mf.sha256_bytes(data)}]})
        st, doc = ask(ports[0], '/reload', {'ns': 'serving', 'step': 7})
        check(st == 409, f'/reload of a corrupted step answered {st} {doc}')
        print(f'  /reload {{"ns", "step"}} on a corrupted step directory: '
              f'{st} ({doc["error"][:70]}...)')

        # int8 weights on the second replica: the drift against bf16
        st, bf16_out = ask(ports[1], '/predict', {'inputs': seqs[2]})
        serving.quantize_weights(nets[1], 'int8')
        st2, int8_out = ask(ports[1], '/predict', {'inputs': seqs[2]})
        check(st == st2 == 200, 'predict around quantize_weights failed')
        a = onp.asarray(bf16_out['outputs'])
        b = onp.asarray(int8_out['outputs'])
        drift = float(onp.abs(b - a).max())
        rel = float(onp.linalg.norm(b - a) / onp.linalg.norm(a))
        check(bool(onp.isfinite(b).all()) and drift > 0,
              f'int8 output drift {drift}')
        check(len(cachedop_entries()) == caps, 'quantize captured a graph')
        print(f'  quantize_weights(int8) on replica 1: output drift against '
              f'bf16 max_abs {drift:.4f}, rel_fro {rel:.5f} (length '
              f'{len(seqs[2])}); no capture')

        # the JSON encode of one response, and the kernels of one HTTP
        # dispatch
        enc = []
        for s in seqs:
            out = engines[1].submit(s, timeout=FRONT_TIMEOUT)
            t0 = time.perf_counter()
            body = serving.PredictServer._json('200 OK', {
                'outputs': serving.PredictServer.encode_outputs([out], True),
                'latency_ms': 0.0})[2]
            enc.append(((time.perf_counter() - t0) * 1e3, len(s),
                        len(body)))
        long_req = rng.randint(1, cfg['vocab_size'], 512).tolist()
        names = kernel_launches(
            lambda: ask(ports[1], '/predict', {'inputs': long_req}), 3)
        per_http = {k: sum(c for n, c in names.items() if v in n) / 3
                    for k, v in SERVE_KERNELS.items()}
        print(f'  kernel launches per HTTP /predict of 512 tokens (profiler, '
              f'3 requests): {per_http}')
        check(per_http == {'flash_attn_fwd': L, 'fused_add_layernorm':
                           2 * L, 'dense_gelu': L},
              f'launches per HTTP dispatch {per_http}')

        # the CachedOp key's host time: as it was built before the names
        # were kept (every parameter's structured name on every call), and
        # now
        from mxnet_tpu_torch.amp.amp import patch_epoch as amp_epoch
        tok = torch.from_numpy(padded).cuda()
        op = nets[0]._cached_op

        def key_rebuilt():
            return (tuple((tuple(a.shape), a.dtype, a.requires_grad)
                          for a in (tok,)), nets[0].training, False,
                    torch.is_inference_mode_enabled(), amp_epoch(),
                    tuple(nets[0]._collect_params_with_prefix()))

        def host_us(fn, n=200):
            fn()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e6
        with torch.inference_mode():
            check(key_rebuilt() == op.key((tok,)), 'the key changed')
            key_old = min(host_us(key_rebuilt) for _ in range(2))
            key_new = min(host_us(lambda: op.key((tok,))) for _ in range(2))
        print(f'  host time of the CachedOp key on {card}: rebuilt per call '
              f'{key_old:.1f} us, names kept {key_new:.1f} us (best of 2 x '
              f'200)')

        # the burst: a Router over both replicas; /drain to replica 0 once
        # a quarter of the requests are answered
        router = serving.Router(endpoints=[(host, p) for p in ports],
                                timeout=FRONT_TIMEOUT)
        reqs = [rng.randint(1, cfg['vocab_size'], int(n)).tolist()
                for n in rng.randint(8, 513, burst_n)]
        results, lat, errors = [None] * burst_n, [None] * burst_n, []
        done = [0]
        lock = threading.Lock()
        quarter = threading.Event()

        def client(idx):
            for i in idx:
                t0 = time.perf_counter()
                try:
                    results[i] = router.predict(reqs[i])
                except Exception as e:                # noqa: BLE001
                    errors.append(repr(e))
                    continue
                lat[i] = (time.perf_counter() - t0) * 1e3
                with lock:
                    done[0] += 1
                    if done[0] >= burst_n // 4:
                        quarter.set()

        b0 = [e.stats()['batches'] for e in engines]
        threads = [threading.Thread(target=client,
                                    args=(range(t, burst_n, clients),))
                   for t in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        check(quarter.wait(FRONT_TIMEOUT), 'the burst stalled')
        drained_at = done[0]
        st, _ = ask(ports[0], '/drain', {})
        check(st == 200, f'/drain answered {st}')
        for t in threads:
            t.join(timeout=FRONT_TIMEOUT)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), 'a client hung')
        deadline = time.monotonic() + 60
        while servers[0]._server is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        check(servers[0]._server is None,
              'the drained replica kept listening')
        failed = len(errors) + sum(r is None for r in results)
        disp = [e.stats()['batches'] - b for e, b in zip(engines, b0)]
        print(f'  burst through the Router: {burst_n} requests (lengths '
              f'8..512) from {clients} client threads, /drain to replica 0 '
              f'after {drained_at} answers: {failed} failed, '
              f'{router.failovers} failovers, ejected {router.ejected()}, '
              f'dispatches per replica {disp}')
        check(failed == 0, f'{failed} requests failed: {errors[:3]}')
        check(router.failovers >= 1, 'no request failed over')
        for q, o in zip(reqs, results):
            o = onp.asarray(o)
            check(o.shape == (len(q), H) and bool(onp.isfinite(o).all()),
                  f'bad output {o.shape} for a request of {len(q)} tokens')
        lats = sorted(lat)
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        stats1 = engines[1].stats()
        print(f'  over HTTP on {card}: {burst_n / wall:.2f} requests/s, p50 '
              f'{p50:.3f} ms, p99 {p99:.3f} ms (client clock, failovers '
              f'included); engine p50 {stats1["p50_ms"]} ms, p99 '
              f'{stats1["p99_ms"]} ms (replica 1, enqueue to result); JSON '
              f'encode of one response: ' + ', '.join(
                  f'{n} tokens {ms:.3f} ms ({nb / 1e6:.2f} MB)'
                  for ms, n, nb in enc))
        launches = {k: v - reference[k]
                    for k, v in mt.ops.launch_counts.items()}
        check(launches == after_warmup, 'an HTTP dispatch moved the launch '
              'counters (a capture outside warmup)')
        check(launches == {'flash_attn_fwd': 2 * 2 * L * 16,
                           'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
                           'fused_add_layernorm': 2 * 4 * L * 16,
                           'dense_gelu': 2 * 2 * L * 16},
              f'front launch counts {launches} for two warmups')
    finally:
        for s in servers:
            s.stop()
        for e in engines:
            e.drain()
        telemetry.disable()
        telemetry.trace.disable()
        telemetry.trace.clear()
        comp.disable()
        comp.clear(ledger='')
        tmp.cleanup()
    return launches, per_http, dict(
        rps=burst_n / wall, p50_ms=p50, p99_ms=p99,
        engine_p50_ms=stats1['p50_ms'], encode=enc, key_us=(key_old,
                                                            key_new),
        int8_drift=drift, failovers=router.failovers)


def honest_flops(params, cfg, batch, seq, nmask):
    """bench.py's FLOP count of one BERT pretraining step (forward and
    backward): embeddings do no matmul work, the MLM head runs on the
    masked positions only, pooler and NSP on one position per sequence;
    6 FLOPs per parameter per token, and 12*L*hidden*T per token for
    attention."""
    def psize(keys):
        return sum(p.numel() for n, p in params.items()
                   if any(k in n for k in keys))
    P = psize([''])
    P_embed = psize(['word_embed', 'pos_embed', 'type_embed'])
    P_head = psize(['mlm_'])
    P_pool = psize(['pooler', 'nsp'])
    P_body = P - P_embed - P_head - P_pool
    tokens = batch * seq
    return (6 * P_body * tokens + 6 * P_head * batch * nmask
            + 6 * P_pool * batch
            + 12 * cfg['layers'] * cfg['hidden'] * seq * tokens)


def pretraining_batch(cfg, batch, seq, seed):
    """The flagship batch of bench.py: random tokens, token types 0,
    valid_length in [seq/2, seq], 72 masked positions per row (15% of 512
    rounded down to a multiple of 8), their labels and NSP labels."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    nmask = max(8, int(0.15 * seq) // 8 * 8)
    arrays = dict(
        tokens=rng.randint(0, cfg['vocab_size'], (batch, seq)),
        types=onp.zeros((batch, seq), onp.int64),
        valid=rng.randint(seq // 2, seq + 1, (batch,)).astype(onp.float32),
        mpos=onp.stack([rng.choice(seq, nmask, replace=False)
                        for _ in range(batch)]),
        labels=rng.randint(0, cfg['vocab_size'], (batch, nmask)),
        nsp=rng.randint(0, 2, (batch,)))
    return arrays, nmask


def _key_bias_zeroed(name, g):
    """A gradient with the key third of a qkv bias set to 0: that gradient
    is zero in exact arithmetic (softmax ignores a shift shared by every
    key of a row), so what any run computes for it is rounding noise."""
    if name.endswith('.qkv.bias'):
        hidden = g.shape[0] // 3
        g = g.clone()
        g[hidden:2 * hidden] = 0
    return g


def parity_step(model, arrays, dev, dtype):
    """(loss, {name: f32 gradient on the CPU}) of one step at dropout 0 of
    ``model`` = (build, loss_of): the net ``build(dtype, dev)`` with
    ``arrays`` loaded, its loss ``loss_of(net, dev)`` (the key third of
    each qkv bias zeroed, see _key_bias_zeroed)."""
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    build, loss_of = model
    net = build(dtype, dev).train()
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    loss = loss_of(net, dev)
    loss.backward()
    return float(loss.detach()), {
        n: _key_bias_zeroed(n, p.grad.detach().float().cpu())
        for n, p in net.named_parameters()}


def bert_model(cfg, seq=512, batch=2):
    """parity_step's model: BertForPretraining on the flagship-style batch
    drawn from SEED + 1."""
    import torch
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_pretrain_loss)
    data, _ = pretraining_batch(cfg, batch, seq, SEED + 1)

    def loss_of(net, dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
        return bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
    return (lambda dtype, dev: BertForPretraining(
        dict(cfg, dropout=0.0), dtype=dtype, device=dev)), loss_of


_CPU_REF = []


def cpu_reference(cfg, arrays):
    """parity_step in f32 on the CPU through the plain versions, run once
    and kept: the training and AMP phases hold the card against it."""
    import torch
    if not _CPU_REF:
        _CPU_REF.append(parity_step(bert_model(cfg), arrays, 'cpu',
                                     torch.float32))
    return _CPU_REF[0]


def grad_agreement(got, want):
    """The gradients ``got`` against ``want`` (both {name: tensor}, over
    want's names): their global rel Frobenius, and the least cosine with
    its name."""
    import torch
    num = sum(float((got[n].double() - want[n].double()).square().sum())
              for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    cos = {n: float(torch.nn.functional.cosine_similarity(
        got[n].flatten().double(), want[n].flatten().double(), dim=0))
        for n in want}
    worst = min(cos, key=cos.get)
    return (num / den) ** 0.5, cos[worst], worst


def hold_parity(label, got, want, tol):
    """loss rel, gradients' rel Frobenius and least cosine of the card's
    step ``got`` against the CPU's ``want``, each within ``tol``."""
    (lg, gg), (lc, gc) = got, want
    loss_rel = abs(lg - lc) / abs(lc)
    rel_fro, cos, worst = grad_agreement(gg, gc)
    ok = loss_rel <= tol['loss_rel'] and \
        rel_fro <= tol['grad_rel_fro'] and \
        cos >= tol['grad_min_cos']
    print(f'  parity, {label}: loss {lg:.5f} vs {lc:.5f} (rel '
          f'{loss_rel:.2e}), gradients rel_fro_err={rel_fro:.4f}, least '
          f'cosine {cos:.5f} ({worst}); tolerance {tol} (key third '
          f'of each qkv bias left out: its gradient is zero in exact '
          f'arithmetic) -> {"ok" if ok else "FAIL"}')
    check(ok, f'{label} disagrees with the f32 CPU reference')
    return dict(loss_rel=loss_rel, rel_fro=rel_fro, min_cos=cos)


def training_parity(cfg, arrays, card, seq=512, batch=2):
    """One step's loss and gradients on the card (bf16, all five kernels,
    dropout 0) against the same weights in f32 on the CPU through the
    plain versions."""
    import torch
    got = parity_step(bert_model(cfg, seq, batch), arrays, 'cuda',
                      torch.bfloat16)
    return hold_parity(f'one step at B={batch} T={seq} (dropout 0), bf16 on '
                       f'the card vs f32 CPU plain', got,
                       cpu_reference(cfg, arrays), TRAIN_TOL)


def training_phase(card, steps=5, batch=8, seq=512):
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    print(f'training phase on {card}: BertForPretraining (BERT-base), bf16, '
          f'both knobs on')
    gen = torch.Generator('cuda').manual_seed(SEED)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    arrays = random_bert_arrays(net)
    parity = training_parity(cfg, arrays, card)

    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    net.train()
    params = gluon.collect_params(net)
    trainer = gluon.Trainer(params, 'adamw',
                            {'learning_rate': 1e-4, 'wd': 0.01,
                             'multi_precision': True})
    data, nmask = pretraining_batch(cfg, batch, seq, SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    def step():
        mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
        loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
        loss.backward()
        trainer.step(1)
        net.zero_grad(set_to_none=False)
        return loss.detach()

    warm = float(step())
    states = trainer._updater.states
    masters0 = {i: st[0].clone() for i, st in states.items()}
    torch.cuda.synchronize()
    # the main path's run: counters at 0 just before, read just after
    _zero_counters()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mt.ops.launch_counts)
    variants = dict(mt.ops.variant_counts)
    routes = dict(attn_ops.route_counts)
    losses = [float(x) for x in losses]

    L = cfg['layers']
    print(f'  losses: warm-up {warm:.5f}, timed {losses}')
    print(f'  launches={launches} variants={variants} routes={routes} over '
          f'{steps} steps')
    check(all(onp.isfinite(x) for x in [warm] + losses), 'non-finite loss')
    check(routes['flash'] == L * steps, f'flash route {routes}')
    check(launches == {'flash_attn_fwd': L * steps,
                       'flash_attn_bwd_dq': L * steps,
                       'flash_attn_bwd_dkv': L * steps,
                       'fused_add_layernorm': 2 * L * steps,
                       'dense_gelu': L * steps},
          f'launch counts {launches} for {steps} steps')
    check(variants == {k: L * steps if k.endswith('.tc') else 0
                       for k in variants},
          f'variant counts {variants} for {steps} steps')
    names = list(params)
    still = [names[i] for i, st in states.items()
             if torch.equal(st[0], masters0[i])]
    check(not still, f'parameters that did not move: {still}')

    flops = honest_flops(params, cfg, batch, seq, nmask)
    # two more calls of the same steps: host time moves between calls
    calls = [wall / steps * 1e3] + [steps_ms(step, steps) for _ in range(2)]
    step_s = sorted(calls)[1] / 1e3
    mfu = flops / step_s / PEAK_BF16
    print(f'  {steps} AdamW steps at B={batch} T={seq} on {card}: '
          f'{step_s * 1e3:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{c:.3f}" for c in calls)} ms; host clock between '
          f'synchronizes), {batch / step_s:.3f} samples/s, '
          f'{flops / 1e12:.4f} TFLOP per step, MFU {mfu:.4%} of 989 '
          f'TFLOP/s bf16')

    # where a step's device time goes: by kernel family over one profiled
    # step, then forward / backward / optimizer from CUDA events
    device_breakdown(f'training step b{batch}_s{seq}', step, card, 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
    loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
    ev[1].record()
    loss.backward()
    ev[2].record()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    trainer.step(1)
    host_update_ms = (time.perf_counter() - h0) * 1e3
    net.zero_grad(set_to_none=False)
    ev[3].record()
    ev[3].synchronize()
    phases = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    check(trainer._fused[1] is not None, 'the fused update was not captured')
    print(f'  one step by phase (CUDA events) on {card}: forward+loss '
          f'{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, AdamW update '
          f'{phases[2]:.3f} ms (the fused update, one CUDA-graph replay; '
          f'{host_update_ms:.3f} ms of host time in trainer.step)')
    return launches, dict(step_ms=step_s * 1e3, calls_ms=calls,
                          samples_per_s=batch / step_s, mfu=mfu,
                          update_ms=phases[2], update_host_ms=host_update_ms,
                          parity=parity)


# AMP on the card (chosen before the first run; PERF.md section 2): one step
# at B = 2, dropout 0, under amp.init(target) against the f32 CPU reference
# of the same weights and batch (no AMP there). bfloat16: the bound of the
# bf16 training step; float16 keeps 3 more significand bits and AMP rounds
# only the products' inputs, so its bound is tighter
AMP_TOL = {'bfloat16': TRAIN_TOL,
           'float16': {'loss_rel': 0.005, 'grad_rel_fro': 0.05,
                       'grad_min_cos': 0.98}}
# a BERT-base cast to float16 against the f32 model, one predict forward:
# the serving bound (PERF.md section 2)
HALF_TOL = 0.05


def _amp_counts(L, steps, dtype):
    """The launch, variant and dtype counts of ``steps`` AMP steps: the
    flash forward, dq and dk/dv once a layer a step on the tensor cores,
    in ``dtype``; no LayerNorm or FFN1 launch (both knobs off)."""
    n = L * steps
    fl = ('flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv')
    return ({k: n if k in fl else 0 for k in
             ('flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv',
              'fused_add_layernorm', 'dense_gelu')},
            {f'{k}.{dtype}': n for k in fl})


def amp_phase(card, steps=5, batch=8, seq=512):
    """MXNet's AMP recipe on BERT-base at full width and depth, f32
    parameters: parity at B = 2 under each target; a block hybridized
    before amp.init recaptured after it; then, on the flagship batch with
    AdamW, ``steps`` steps of ``with autograd.record(): ...; with
    amp.scale_loss(loss, trainer) as s: s.backward(); trainer.step(B)``
    under amp.init('bfloat16') and under amp.init('float16') (the dynamic
    scaler from 2**16, one step's gradient planted non-finite), one step
    with the fused LayerNorm on, and a predict forward of the model cast
    to float16 with both knobs on. Returns ({kernel: launches},
    {kernel.dtype: launches}, figures) of those main runs."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch import amp, autograd, gluon
    from mxnet_tpu_torch.amp import amp as amp_mod
    from mxnet_tpu_torch.gluon.parameter import tensor_of
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    cfg = bert_base_config()
    L = cfg['layers']
    knobs = {k: os.environ.get(k) for k in ('MXTPU_PALLAS_LN',
                                            'MXTPU_PALLAS_FFN')}
    os.environ['MXTPU_PALLAS_LN'] = '0'
    os.environ['MXTPU_PALLAS_FFN'] = '0'
    print(f'AMP phase on {card}: BertForPretraining (BERT-base), f32 '
          f'parameters, amp.init in bfloat16 and float16, flash attention '
          f'on, the LayerNorm and FFN1 knobs off unless said')
    gen = torch.Generator('cuda').manual_seed(SEED)
    net = BertForPretraining(dict(cfg, dropout=0.1), device='cuda',
                             generator=gen)
    arrays = random_bert_arrays(net)
    ref = cpu_reference(cfg, arrays)
    figures = {'parity': {}}
    for target in ('bfloat16', 'float16'):
        amp.init(target)
        try:
            got = parity_step(bert_model(cfg), arrays, 'cuda', torch.float32)
        finally:
            amp_mod._deinit()
        figures['parity'][target] = hold_parity(
            f'one step at B=2 T={seq} (dropout 0) under amp.init({target!r}) '
            f'on the card vs f32 CPU plain', got, ref, AMP_TOL[target])

    # a block hybridized before amp.init: its predict graph is not replayed
    # after amp.init nor after _deinit (the patch epoch is in the key)
    blk = gluon.nn.Dense(768, in_units=768, device='cuda')
    blk.initialize()
    blk.hybridize()
    xb = torch.randn(64, 768, generator=gen, device='cuda')
    graphs = []
    with torch.no_grad():
        y0 = blk(xb)
        graphs.append(blk._cached_op.num_graphs)
        amp.init('bfloat16')
        try:
            y1 = blk(xb)
            y1b = blk(xb)               # a replay of the new graph
            graphs.append(blk._cached_op.num_graphs)
        finally:
            amp_mod._deinit()
        y2 = blk(xb)
        graphs.append(blk._cached_op.num_graphs)
    torch.cuda.synchronize()
    print(f'  recapture: graphs of the hybridized Dense before amp.init, '
          f'after it and after _deinit: {graphs}; outputs {y0.dtype}, '
          f'{y1.dtype}, {y2.dtype}')
    check(graphs == [1, 2, 3], f'graphs {graphs}: expected a new capture at '
          f'amp.init and at _deinit')
    check(y1.dtype == y1b.dtype == torch.bfloat16 and torch.equal(y1, y1b),
          'the graph captured under amp.init does not run in bf16')
    check(y0.dtype == y2.dtype == torch.float32 and torch.equal(y0, y2),
          'after _deinit the block does not run as before amp.init')
    del blk

    data, nmask = pretraining_batch(cfg, batch, seq, SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    params = gluon.collect_params(net)
    tensors = [tensor_of(p) for p in params.values()]
    flops = honest_flops(params, cfg, batch, seq, nmask)
    launches = dict.fromkeys(_build.launch_counts, 0)
    dtypes = {}

    def take_counts():
        for k, n in _build.launch_counts.items():
            launches[k] += n
        for k, n in _build.dtype_counts.items():
            dtypes[k] = dtypes.get(k, 0) + n

    def make_step(trainer):
        def step(plant=False):
            with autograd.record():
                mlm, nsp = net(t['tokens'], t['types'], t['valid'],
                               t['mpos'])
                loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
            if plant:
                tensors[0].grad.view(-1)[0] = float('inf')
            trainer.step(batch)
            net.zero_grad(set_to_none=False)
            return loss.detach()
        return step

    def timed(step, target, losses, wall):
        losses = [float(x) for x in losses]
        check(all(onp.isfinite(x) for x in losses), f'non-finite loss '
              f'{losses}')
        calls = [wall / steps * 1e3] + [steps_ms(step, steps)
                                        for _ in range(2)]
        step_s = sorted(calls)[1] / 1e3
        print(f'  amp.init({target!r}), {steps} AdamW steps at B={batch} '
              f'T={seq} on {card}: losses {losses}; {step_s * 1e3:.3f} ms '
              f'per step, the median of 3 calls '
              f'({", ".join(f"{c:.3f}" for c in calls)} ms; '
              f'host clock between synchronizes), {batch / step_s:.3f} '
              f'samples/s, MFU {flops / step_s / PEAK_BF16:.4%} of 989 '
              f'TFLOP/s')
        bd = device_breakdown(f'AMP {target} step b{batch}_s{seq}', step,
                              card, 1, other_by_op=True)
        return dict(step_ms=step_s * 1e3, calls_ms=calls,
                    samples_per_s=batch / step_s,
                    mfu=flops / step_s / PEAK_BF16, **bd)

    def hold_counts(target):
        want, want_dt = _amp_counts(L, steps, target)
        got = dict(_build.launch_counts)
        variants = {k: n for k, n in _build.variant_counts.items() if n}
        print(f'  amp.init({target!r}) launches={got} '
              f'dtypes={dict(_build.dtype_counts)} variants={variants} over '
              f'{steps} steps')
        check(got == want, f'launch counts {got}, expected {want}')
        check(_build.dtype_counts == want_dt,
              f'dtype counts {_build.dtype_counts}, expected {want_dt}')
        check(variants == {f'{k}.tc': L * steps for k in (
            'flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv')},
            f'variants {variants}')
        take_counts()

    # ---- bfloat16: scale 1, no overflow check
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    net.train()
    amp.init('bfloat16')
    try:
        trainer = gluon.Trainer(params, 'adamw',
                                {'learning_rate': 1e-4, 'wd': 0.01})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        check(scaler.loss_scale == 1.0 and not scaler.dynamic,
              f'bf16 scaler {scaler.loss_scale} dynamic={scaler.dynamic}')
        step = make_step(trainer)
        step()                          # the fused update's capture
        before = [x.detach().clone() for x in tensors]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step() for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hold_counts('bfloat16')
        still = [n for n, a, b in zip(params, tensors, before)
                 if torch.equal(a, b)]
        check(not still, f'parameters that did not move: {still}')
        del before
        figures['bfloat16'] = timed(step, 'bfloat16', losses, wall)
    finally:
        amp_mod._deinit()

    # ---- float16: the dynamic scaler from 2**16, step 3's gradient
    # planted non-finite
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    amp.init('float16')
    try:
        trainer = gluon.Trainer(params, 'adamw',
                                {'learning_rate': 1e-4, 'wd': 0.01})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        check(scaler.loss_scale == 2.0 ** 16 and scaler.dynamic,
              f'float16 scaler {scaler.loss_scale} '
              f'dynamic={scaler.dynamic}')
        step = make_step(trainer)
        opt = trainer.optimizer
        # warm-up: the scale backs off while the scaled gradients overflow
        # float16; the first clean step captures the fused update
        scales = [scaler.loss_scale]
        for _ in range(16):
            n0 = opt.num_update
            step()
            scales.append(scaler.loss_scale)
            if opt.num_update > n0:
                break
        print(f'  float16 warm-up: loss scale {scales} (a halving per '
              f'skipped step) until the first update')
        check(opt.num_update == 1, f'no clean float16 step in 16: scales '
              f'{scales}')
        graph = trainer._fused[1]       # the fused update's one capture
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for i in range(steps):
            n0, s0 = opt.num_update, scaler.loss_scale
            if i == 2:
                counts0 = dict(opt._index_update_count)
                before = [x.detach().clone() for x in tensors]
            losses.append(step(plant=(i == 2)))
            if i == 2:
                torch.cuda.synchronize()
                moved = [n for n, a, b in zip(params, tensors, before)
                         if not torch.equal(a, b)]
                print(f'  planted inf on step 3: loss scale {s0} -> '
                      f'{scaler.loss_scale}, update count {n0} -> '
                      f'{opt.num_update}, parameters moved: {len(moved)}')
                check(not moved and opt.num_update == n0 and
                      dict(opt._index_update_count) == counts0 and
                      scaler.loss_scale == s0 / 2,
                      'the planted non-finite gradient was not skipped')
                del before
            else:
                check(opt.num_update == n0 + 1 and scaler.loss_scale == s0,
                      f'float16 step {i + 1} did not update (scale {s0} -> '
                      f'{scaler.loss_scale})')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(trainer._fused[1] is graph, 'a new loss scale recaptured the '
              'fused update')
        hold_counts('float16')
        figures['float16'] = timed(step, 'float16', losses, wall)
        # the scaler's overflow check alone: every buffer's finiteness
        # reduced on the card, one sync
        bufs = list(trainer._grads.values())
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(10):
            scaler.has_overflow(bufs)
        figures['overflow_check_ms'] = (time.perf_counter() - h0) * 100
        print(f'  the dynamic scaler\'s overflow check over {len(bufs)} '
              f'gradient buffers: {figures["overflow_check_ms"]:.3f} ms of '
              f'host time (one sync each; mean of 10)')

        # one step with the fused LayerNorm: x f32, res float16, promoted
        os.environ['MXTPU_PALLAS_LN'] = '1'
        _build.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        ln = (_build.launch_counts['fused_add_layernorm'],
              dict(_build.dtype_counts).get('fused_add_layernorm.float32'))
        print(f'  one float16 AMP step with MXTPU_PALLAS_LN=1: LayerNorm '
              f'launches {ln[0]}, in float32: {ln[1]}')
        check(ln == (2 * L, 2 * L), f'LayerNorm launches {ln}')
        take_counts()
    finally:
        os.environ['MXTPU_PALLAS_LN'] = '0'
        amp_mod._deinit()

    # ---- a model cast to float16: FFN1 (C) and LayerNorm (B) in float16
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    net.eval()
    half = BertForPretraining(dict(cfg, dropout=0.0), dtype=torch.float16,
                              device='cuda').eval()
    half.load_state_dict(params_from_mxnet_tpu(arrays, half))
    args = (t['tokens'], t['types'], t['valid'], t['mpos'])
    with torch.no_grad():
        want = net(*args)[0].float()
        os.environ['MXTPU_PALLAS_LN'] = '1'
        os.environ['MXTPU_PALLAS_FFN'] = '1'
        try:
            _build.reset_launch_counts()
            got = half(*args)[0]
            torch.cuda.synchronize()
        finally:
            os.environ['MXTPU_PALLAS_LN'] = '0'
            os.environ['MXTPU_PALLAS_FFN'] = '0'
    dt_half = dict(_build.dtype_counts)
    rel = float((got.float() - want).norm() / want.norm())
    print(f'  BERT-base cast to float16, one predict forward at B={batch} '
          f'T={seq}, both knobs on: launches {dict(_build.launch_counts)}, '
          f'dtypes {dt_half}; MLM logits vs the f32 model rel Frobenius '
          f'{rel:.4f} (tolerance {HALF_TOL})')
    check(dt_half == {'flash_attn_fwd.float16': L,
                      'fused_add_layernorm.float16': 2 * L,
                      'dense_gelu.float16': L}, f'dtype counts {dt_half}')
    check(_build.variant_counts['dense_gelu.tc'] == L, 'FFN1 not on tc')
    check(bool(torch.isfinite(got).all()) and rel <= HALF_TOL,
          f'the float16 model disagrees with f32: rel {rel}')
    take_counts()
    figures['half_rel'] = rel
    del half, net
    torch.cuda.empty_cache()
    for k, v in knobs.items():          # as the phases before left them
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return launches, dtypes, figures


# the captured step and the Trainer's captured fused update against the
# Trainer's per-parameter loop on the same card, f32 with TF32 off and
# dropout 0 (chosen before the first run): the same arithmetic in another
# order, so the loss agrees to f32 rounding and the parameters to a few
# roundings over 5 AdamW steps
CAPTURE_TOL = {'loss_rel': 1e-5, 'param_rel_fro': 1e-4}


def _rel_fro(got, want):
    got = [a.detach().float() for a in got]
    want = [b.detach().float() for b in want]
    num = sum(float((a - b).square().sum()) for a, b in zip(got, want))
    return (num / sum(float(b.square().sum()) for b in want)) ** 0.5


def capture_parity(card, steps=5, batch=8, seq=128):
    """BertForPretraining at hidden 128, 2 layers (BERT-base's vocabulary
    and positions), numpy weights, dropout 0, f32: 5 AdamW steps through
    the captured ShardedTrainStep and through the Trainer's captured fused
    update, each against the Trainer's per-parameter loop (eager)."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    cfg = dict(bert_base_config(), hidden=128, layers=2, heads=2,
               intermediate=512, dropout=0.0)
    data, _ = pretraining_batch(cfg, batch, seq, SEED + 2)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    ins = [t['tokens'], t['types'], t['valid'], t['mpos']]
    labs = [t['labels'], t['nsp']]
    kw = {'learning_rate': 1e-3, 'wd': 0.01}
    arrays = {}

    def model():
        net = BertForPretraining(cfg, device='cuda')
        if not arrays:
            arrays.update(random_bert_arrays(net))
        net.load_state_dict(params_from_mxnet_tpu(arrays, net))
        return net.train()

    def trainer_run(fused):
        net = model()
        trainer = gluon.Trainer(gluon.collect_params(net), 'adamw', kw)
        trainer.optimizer.fused_update = fused
        losses = []
        for _ in range(steps):
            net.zero_grad(set_to_none=False)
            loss = bert_pretrain_loss(*net(*ins), *labs)
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.detach()))
        if fused:
            check(trainer._fused[1] is not None,
                  'the fused update was not captured')
        return net, losses

    def step_run():
        net = model()
        step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                         kw)
        losses = [float(step(ins, labs)) for _ in range(steps)]
        check(len(step._graphs) == 1, 'the step was not captured once')
        return net, losses

    ref_net, ref = trainer_run(False)
    out = {}
    for label, (net, losses) in (('captured ShardedTrainStep', step_run()),
                                 ('Trainer, captured fused update',
                                  trainer_run(True))):
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        rel = _rel_fro(list(net.parameters()), list(ref_net.parameters()))
        ok = loss_rel <= CAPTURE_TOL['loss_rel'] and \
            rel <= CAPTURE_TOL['param_rel_fro']
        print(f'  capture vs eager on {card}, hidden 128, 2 layers, f32, '
              f'dropout 0, {steps} AdamW steps: {label} losses {losses} vs '
              f'the per-parameter loop {ref}: max loss rel {loss_rel:.2e}, '
              f'parameters rel Frobenius {rel:.2e}; tolerance {CAPTURE_TOL} '
              f'-> {"ok" if ok else "FAIL"}')
        check(ok, f'{label} disagrees with the eager Trainer loop')
        out[label] = dict(loss_rel=loss_rel, param_rel_fro=rel)
    return out


def compiled_step_phase(card, warmup=3, timed=10, batch=8, seq=512):
    """The flagship's entry point: ShardedTrainStep(net, bert_pretrain_loss,
    'adamw', {'learning_rate': 1e-4}) on BERT-base BertForPretraining at
    full width, bf16, dropout 0.1 drawn on the card, the flagship batch;
    call 1 runs eagerly and captures, every later call replays."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    print(f'compiled-step phase on {card}: parallel.ShardedTrainStep, one '
          f'CUDA graph per input signature')
    parity = capture_parity(card)
    torch.cuda.empty_cache()

    cfg = bert_base_config()
    L = cfg['layers']
    gen = torch.Generator('cuda').manual_seed(SEED + 3)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    net.load_state_dict(params_from_mxnet_tpu(random_bert_arrays(net), net))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01})
    data, nmask = pretraining_batch(cfg, batch, seq, SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    ins = [t['tokens'], t['types'], t['valid'], t['mpos']]
    labs = [t['labels'], t['nsp']]

    # a probe copies each attention-dropout seed the step draws into a
    # buffer outside the graph, so the host can read what a replay drew
    probe = torch.zeros(L, dtype=torch.int64, device='cuda')
    drawn = [0]
    draw = attn_ops._dropout_seed

    def probed(generator, device):
        seed = draw(generator, device)
        probe[drawn[0] % L].copy_(seed[0])
        drawn[0] += 1
        return seed
    attn_ops._dropout_seed = probed
    try:
        # the path's run: counters at 0 before call 1 (eager step and
        # capture, the host calls counted), read after the last replay
        _zero_counters()
        t0 = time.perf_counter()
        warm = [float(step(ins, labs))]
        first_s = time.perf_counter() - t0
        seeds = []
        for _ in range(warmup - 1):
            warm.append(float(step(ins, labs)))
            seeds.append(probe.cpu().tolist())
    finally:
        attn_ops._dropout_seed = draw
    check(drawn[0] == 2 * L, f'{drawn[0]} seeds drawn in the eager step '
          f'and the capture, expected {2 * L}')
    fresh = all(a != b for a, b in zip(*seeds))
    print(f'  attention seeds drawn on the card, read back after two '
          f'replays: {seeds[0][:3]}... then {seeds[1][:3]}... -> '
          f'{"fresh on each replay" if fresh else "REPEATED"}')
    check(fresh, 'a replay reused the previous replay\'s dropout seeds')

    masters0 = {n: m.clone() for n, m in step._master.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ins, labs) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    # the unguarded step's bits, to hold two trees against each other
    bits = dict(params=_digest(dict(net.named_parameters())),
                masters=_digest(step._master))
    launches = dict(mt.ops.launch_counts)
    variants = dict(mt.ops.variant_counts)
    routes = dict(attn_ops.route_counts)
    print(f'  losses: warm-up {warm} (call 1, eager and capture: '
          f'{first_s:.1f} s), timed {losses}')
    print(f'  host launches (eager step + capture; replays launch from the '
          f'graph) launches={launches} variants={variants} routes={routes}')
    check(all(onp.isfinite(x) for x in warm + losses), 'non-finite loss')
    check(len(step._graphs) == 1, f'{len(step._graphs)} graphs captured')
    check(routes['flash'] == 2 * L, f'flash route {routes}')
    check(launches == {'flash_attn_fwd': 2 * L, 'flash_attn_bwd_dq': 2 * L,
                       'flash_attn_bwd_dkv': 2 * L,
                       'fused_add_layernorm': 4 * L, 'dense_gelu': 2 * L},
          f'launch counts {launches} for the eager step and the capture')
    check(variants == {k: 2 * L if k.endswith('.tc') else 0
                       for k in variants}, f'variant counts {variants}')
    still = [n for n, m in step._master.items() if torch.equal(m,
                                                              masters0[n])]
    check(not still, f'masters that did not move: {still}')

    # each replay's kernels, by name, from the profiler's CUDA trace
    replays = 3
    names = kernel_launches(lambda: step(ins, labs), replays)
    want = {'flash_fwd_tc_kernel': L, 'flash_bwd_dq_tc_kernel': L,
            'flash_bwd_dkv_tc_kernel': L, 'dense_gelu_tc_kernel': L,
            '_add_ln_fwd': 2 * L}
    per_replay = {k: sum(c for n, c in names.items() if k in n) / replays
                  for k in want}
    print(f'  kernel launches per replay (profiler, {replays} replays): '
          f'{per_replay}')
    kern, copies = ops_split(names, replays)
    print(f'  step bits on {card}: losses {[x.hex() for x in warm + losses]}; '
          f'parameters sha256 {bits["params"]}, masters sha256 '
          f'{bits["masters"]}; {kern + copies:.0f} device operations per '
          f'replay ({kern:.0f} kernels, {copies:.0f} copies and memsets)')
    check(per_replay == want, f'launches per replay {per_replay}, expected '
          f'{want}')

    calls = [wall / timed * 1e3] + [
        steps_ms(lambda: step(ins, labs), timed) for _ in range(2)]
    step_ms = sorted(calls)[1]
    print(f'  {timed} captured steps at B={batch} T={seq} on {card}: '
          f'{step_ms:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{c:.3f}" for c in calls)} ms), '
          f'{batch / step_ms * 1e3:.3f} samples/s')
    attr = step_attribution(step, ins, labs,
                            honest_flops(dict(net.named_parameters()), cfg,
                                         batch, seq, nmask), step_ms, card)
    busy = device_breakdown(f'captured step b{batch}_s{seq}',
                            lambda: step(ins, labs), card, 3,
                            other_by_op=True)
    bytes_state = step.opt_state_bytes_per_device()
    print(f'  state on the card: parameters '
          f'{step.param_bytes_per_device() / 2 ** 20:.1f} MiB, masters + '
          f'moments {bytes_state / 2 ** 20:.1f} MiB; peak allocated '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    per_path = {'flash_attn_fwd': launches['flash_attn_fwd'],
                'flash_attn_bwd_dq': launches['flash_attn_bwd_dq'],
                'flash_attn_bwd_dkv': launches['flash_attn_bwd_dkv'],
                'fused_add_layernorm': launches['fused_add_layernorm'],
                'dense_gelu': launches['dense_gelu']}
    replay_by_row = {'flash_attn_fwd': per_replay['flash_fwd_tc_kernel'],
                     'flash_attn_bwd_dq': per_replay['flash_bwd_dq_tc_kernel'],
                     'flash_attn_bwd_dkv':
                         per_replay['flash_bwd_dkv_tc_kernel'],
                     'fused_add_layernorm': per_replay['_add_ln_fwd'],
                     'dense_gelu': per_replay['dense_gelu_tc_kernel']}
    return per_path, replay_by_row, dict(
        step_ms=step_ms, calls_ms=calls, losses=warm + losses,
        busy=busy, parity=parity, attribution=attr)


def step_attribution(step, ins, labs, flops, step_ms, card, steps=8):
    """telemetry.attribution.report over the flight recorder's records
    of ``steps`` traced calls of the compiled step, each followed by its
    loss read; its buckets must sum to the host clock's time per step
    between the reads within 1%. Prints its MFU beside the phase's own
    (bench.py's FLOP count over the median step time)."""
    from mxnet_tpu_torch import telemetry
    flight, trace = telemetry.flight, telemetry.trace
    flight.get().clear()
    trace.clear()
    trace.enable()
    try:
        marks = []
        for _ in range(steps):
            float(step(ins, labs))
            marks.append(time.perf_counter())
        records = flight.get().steps()
    finally:
        trace.disable()
        trace.clear()
        flight.get().clear()
    rep = telemetry.attribution.report(records, flops_per_step=flops,
                                       peak_flops=PEAK_BF16)
    wall_ms = (marks[-1] - marks[0]) / (steps - 1) * 1e3
    total = sum(rep['buckets_ms'].values())
    phase_mfu = flops / (step_ms / 1e3) / PEAK_BF16 * 100
    print('  attribution over the flight recorder (' + '; '.join(
        telemetry.attribution.format_table(rep).splitlines()[:7]) + ')')
    print(f'  attribution on {card}: buckets sum {total:.3f} ms against the '
          f'host clock\'s {wall_ms:.3f} ms a step between loss reads '
          f'({abs(total - wall_ms) / wall_ms:.2%} apart, limit 1%); honest '
          f'MFU {rep["mfu_percent"]:.2f}% by attribution, '
          f'{phase_mfu:.2f}% by the phase\'s median step')
    check(abs(total - wall_ms) <= 0.01 * wall_ms,
          f'attribution buckets {total:.3f} ms vs wall {wall_ms:.3f} ms')
    return dict(wall_ms=wall_ms, buckets_ms=rep['buckets_ms'],
                mfu_percent=rep['mfu_percent'], phase_mfu_percent=phase_mfu)


# user kernels against their plain versions on the card (chosen before the
# first run): the copies and 2x are exact; the row sum adds in another
# order (uniform [0, 1) inputs, no cancellation); erff/expf may differ from
# torch's by an ulp and the GELU derivative cancels near x = -0.75, so
# GELU also gets an absolute 1e-6 (8 ulps of 1.0)
USER_TOL = {'scale_add': dict(atol=0, rtol=0),
            'block_double': dict(atol=0, rtol=0),
            'rowsum': dict(atol=0, rtol=1e-5),
            'gelu_fwd': dict(atol=1e-6, rtol=1e-5),
            'gelu_bwd': dict(atol=1e-6, rtol=1e-5)}
USER_TEST_SHAPES = {'scale_add': (8, 128), 'block_double': (128, 128),
                    'rowsum': (8, 16), 'gelu_fwd': (8, 128),
                    'gelu_bwd': (8, 128)}
USER_BIG = (4096, 3072)            # the slice's FFN activation, 50.3 MB f32
# operations per element, to bound each user kernel
USER_OPS = {'scale_add': 2, 'block_double': 1, 'rowsum': 1, 'gelu_fwd': 5,
            'gelu_bwd': 10}
# step 1 of the FFN SGD program on the card vs the CPU, both f32 with TF32
# off (chosen before the first run: only the products' summation order
# differs)
NDARRAY_TOL = {'loss_rel': 1e-5, 'grad_rel_fro': 1e-4}
FFN_LR = 1.0


def _user_yardsticks():
    """One PyTorch call per user kernel that computes the same function
    (timed only; the port never calls them)."""
    import torch
    import torch.nn.functional as F
    return {'scale_add': lambda x, y: torch.add(y, x, alpha=2),
            'block_double': lambda x: x * 2,
            'rowsum': lambda x: x.sum(1, keepdim=True),
            'gelu_fwd': lambda x: F.gelu(x),
            'gelu_bwd': lambda x, dy: torch.ops.aten.gelu_backward(dy, x)}


def ndarray_phase(card, steps=5):
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.test_utils import (FfnSgd, PlainGelu, RTC_SOURCE,
                                            USER_KERNELS, ffn_arrays,
                                            launch_user_kernel,
                                            rtc_gelu_function)
    ctx = mt.gpu(0)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    print(f'ndarray phase on {card}: mx.nd + mx.autograd on the card, user '
          f'kernels compiled by NVRTC (mx.rtc)')
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE)
    compile_s = time.perf_counter() - t0
    kernels = {n: mod.get_kernel(n, s['signature'])
               for n, s in USER_KERNELS.items()}
    print(f'  NVRTC: one module of {len(kernels)} kernels compiled and '
          f'loaded in {compile_s:.3f} s ({" ".join(mod.options[:2])}); '
          f'log: {mod.log.strip() or "empty"}')

    def inputs(name, shape):
        """Drawn on the card: rowsum sums uniform [0, 1) values, as
        tests/test_rtc.py does; the others take N(0, 9)."""
        if name == 'rowsum':
            ts = [torch.rand(shape, generator=gen, device='cuda')]
        else:
            ts = [torch.randn(shape, generator=gen, device='cuda') * 3
                  for _ in range(USER_KERNELS[name]['n_in'])]
        return [nd.NDArray(t) for t in ts]

    errs = {}
    for name in USER_KERNELS:
        for shape in (USER_TEST_SHAPES[name], USER_BIG):
            xs = inputs(name, shape)
            out = launch_user_kernel(kernels[name], name, xs)
            torch.cuda.synchronize()
            want = USER_KERNELS[name]['plain'](*[x._data for x in xs])
            errs[name] = compare(f'{name} {shape} f32 (rtc launch)',
                                 out._data, want, **USER_TOL[name])

    rows, yard = {}, _user_yardsticks()
    for name, spec in USER_KERNELS.items():
        xs = inputs(name, USER_BIG)
        out = nd.zeros(spec['out_shape'](USER_BIG), ctx=ctx)
        grid, block = spec['geometry'](USER_BIG)
        args = xs + [out] + list(spec['ints'](USER_BIG))

        def launch(k=kernels[name], args=args, grid=grid, block=block):
            k.launch(args, ctx, grid, block)
        per_kernel, _ = profile_device(launch, 20, (name,))
        k_us = per_kernel.get(name, 0.0)
        check(k_us > 0, f'no device time for {name} in the trace')
        copy_ms = (sum(per_kernel.values()) - k_us) / 20 / 1e3
        ts = [x._data for x in xs]
        plain_ms, plain_how = time_ms(lambda: spec['plain'](*ts))
        library_ms, library_how = time_ms(lambda: yard[name](*ts))
        n = ts[0].numel()
        nbytes = sum(t.numel() * 4 for t in ts) + out.size * 4
        b_ms, b_by = bound_ms(USER_OPS[name] * n, nbytes, PEAK_F32)
        rows[name] = dict(
            route='cuda', via='rtc (NVRTC)', variant='nvrtc', old_ms=None,
            source='mxnet_tpu_torch/test_utils.py',
            replaces='mxnet_tpu/rtc.py:32 PallasKernel',
            max_abs_err=errs[name], ms=k_us / 20 / 1e3,
            how=f'profiler/{plain_how}/{library_how}', copy_ms=copy_ms,
            stream_ms=stream_ms(launch), plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        print(f'  timing {name} {USER_BIG} f32 on {card}: kernel '
              f'{rows[name]["ms"]:.4f} ms, bound {b_ms:.4f} ms ({b_by}, '
              f'{nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, library '
              f'{library_ms:.4f} ms ({rows[name]["how"]}); the copy of the '
              f'output array each launch makes: {copy_ms:.4f} ms; '
              f'back-to-back stream time of a launch {rows[name]["stream_ms"]:.4f} ms')
        del xs, out, args, ts

    # the path's run: the mirrored kernels called on NDArrays as
    # tests/test_rtc.py calls its Pallas ops, then the slice's SGD steps
    x_np, t_np, params_np = ffn_arrays(4096, 768, 3072, SEED)
    run = FfnSgd(mt, ctx, x_np, t_np, params_np, rtc_gelu_function(mod),
                 FFN_LR)
    small = {n: inputs(n, USER_TEST_SHAPES[n])
             for n in ('scale_add', 'block_double', 'rowsum')}
    torch.cuda.synchronize()
    rtc.reset_launch_counts()
    mt.ops.reset_launch_counts()
    calls = [('scale_add', small['scale_add']),
             ('scale_add', small['scale_add'][::-1]),
             ('block_double', small['block_double']),
             ('rowsum', small['rowsum'])]
    outs = [launch_user_kernel(kernels[n], n, xs) for n, xs in calls]
    losses, marks = [], [time.perf_counter()]
    for i in range(steps):
        losses.append(run.step())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if i == 0:
            grads1 = [p.grad._data for p in run.params]   # rebound, not
    launches = dict(rtc.launch_counts)                    # overwritten
    op_launches = dict(mt.ops.launch_counts)
    losses = [float(v.asscalar()) for v in losses]

    for (n, xs), out in zip(calls, outs):
        torch.testing.assert_close(
            out._data, USER_KERNELS[n]['plain'](*[x._data for x in xs]),
            **{k: USER_TOL[n][k] for k in ('atol', 'rtol')})
    print(f'  path run: launches {launches}, the five kernels of ops '
          f'{op_launches}; losses {losses}')
    check(launches == {'scale_add': 2, 'block_double': 1, 'rowsum': 1,
                       'gelu_fwd': steps, 'gelu_bwd': steps},
          f'rtc launch counts {launches} for {steps} steps')
    check(set(op_launches.values()) == {0}, f'op kernels ran: {op_launches}')
    check(all(onp.isfinite(v) for v in losses), 'non-finite loss')
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f'losses do not fall: {losses}')
    step_ms = (marks[-1] - marks[1]) / (steps - 1) * 1e3
    print(f'  {steps} SGD steps (4096 x 768, FFN 3072, f32, TF32 off) on '
          f'{card}: {step_ms:.3f} ms per step over steps 2-{steps} (host '
          f'clock between synchronizes), first step '
          f'{(marks[1] - marks[0]) * 1e3:.3f} ms')

    cpu = FfnSgd(mt, mt.cpu(), x_np, t_np, params_np, PlainGelu, FFN_LR)
    cpu_loss = float(cpu.step().asscalar())
    loss_rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    num = sum(float((g.cpu() - p.grad._data).square().sum())
              for g, p in zip(grads1, cpu.params))
    den = sum(float(p.grad._data.square().sum()) for p in cpu.params)
    rel_fro = (num / den) ** 0.5
    ok = loss_rel <= NDARRAY_TOL['loss_rel'] and \
        rel_fro <= NDARRAY_TOL['grad_rel_fro']
    print(f'  parity, step 1 on the card (rtc GELU) vs the CPU (plain GELU): '
          f'loss {losses[0]:.7f} vs {cpu_loss:.7f} (rel {loss_rel:.2e}), '
          f'gradients rel_fro_err={rel_fro:.2e}; tolerance {NDARRAY_TOL} '
          f'-> {"ok" if ok else "FAIL"}')
    check(ok, 'the NDArray step disagrees with the CPU reference')
    device_breakdown('ndarray SGD step', run.step, card, 1)

    # host cost of one NDArray op on small card arrays, beside plain torch
    a, b = nd.ones((8, 128), ctx=ctx), nd.ones((8, 128), ctx=ctx)
    ta, tb = a._data, b._data
    per_op = {'nd': [], 'torch': []}
    ops = {'nd': lambda: a + b, 'torch': lambda: ta + tb}
    for label in ('nd', 'torch', 'torch', 'nd'):      # in turns
        for _ in range(100):
            ops[label]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            ops[label]()
        per_op[label].append((time.perf_counter() - t0) / 1000 * 1e6)
        torch.cuda.synchronize()
    print(f'  dispatch: {per_op["nd"]} us of host time per NDArray a + b on '
          f'(8, 128) card arrays, {per_op["torch"]} us for the same torch op '
          f'(host clock around 1000 calls that only enqueue, in turns nd, '
          f'torch, torch, nd)')

    # semantics on the card
    src = nd.array(onp.arange(8, dtype='f'), ctx=ctx)
    view = src.reshape((2, 4))
    ones = nd.ones((2, 4), ctx=ctx)
    kernels['scale_add'].launch([ones, ones, view, 8], ctx, (1, 1, 1),
                                (32, 1, 1))
    check(onp.array_equal(src.asnumpy(), onp.arange(8.0)) and
          onp.array_equal(view.asnumpy(), onp.full((2, 4), 3.0)),
          'a launch into a reshape changed its source')
    w = nd.array([1.0, 2.0], ctx=ctx)
    w.attach_grad()
    with mt.autograd.record():
        y = (w * w).sum()
    y.backward()
    w.grad[:] = 7
    y.backward()
    check(onp.array_equal(w.grad.asnumpy(), [7.0, 7.0]),
          'a second backward without retain_graph wrote the gradients')
    print('  semantics on the card: a launch into a.reshape(...) leaves a '
          'unchanged; a second backward leaves the gradients -> ok')
    return launches, op_launches, rows, dict(
        compile_s=compile_s, step_ms=step_ms, dispatch_us=per_op,
        loss_rel=loss_rel, grad_rel_fro=rel_fro)


# Gluon parity on the card (chosen before the first run; PERF.md section
# 2 says why the bf16 check is made block by block):
# - bf16: one SGD step of resnet50_v1 at B = 2, 224 x 224, its units (the
#   stem's layers, the 16 bottlenecks, the pooling, the classifier, the
#   loss) each run in bf16 on the card on the input and the upstream
#   gradient that the f32 step on the CPU gave that unit, rounded to bf16,
#   against the same unit in f32 on the CPU on those rounded values, all
#   with the same (bf16) weights: the loss within loss_rel, every
#   gradient's cosine >= grad_min_cos, the running statistics within
#   stats_rel, each gradient's rel Frobenius within grad_rel_fro. A
#   gradient that bf16 itself cannot bring within grad_rel_fro (torch's
#   CPU bf16 kernels, on the same unit and values, give more) is named in
#   the output and held to GLUON_BF16_OVER times the CPU's bf16 figure
#   instead; that factor lies between the sound readings and those of the
#   planted faults (GLUON_BF16_FAULTS, PERF.md section 6), and every run
#   checks that each planted fault fails the bounds. The biases of the
#   1x1 convolutions BottleneckV1 puts before a BatchNorm are left out:
#   their exact gradient is 0 in training mode. The whole step end to end
#   in bf16 is printed beside the CPU's own bf16 step, not held to
#   bounds: in training mode the f32 network itself takes a 0.3% change
#   of its input to a 35% change of its stage-4 features.
# - f32: resnet18_v1 (thumbnail) at B = 8, 32 x 32, TF32 off, the whole
#   step on the card against the CPU.
GLUON_BF16_TOL = {'loss_rel': 0.01, 'grad_rel_fro': 0.1,
                  'grad_min_cos': 0.95, 'stats_rel': 0.02}
GLUON_BF16_OVER = 1.15
# faults planted in the card's BatchNorm (a plain version of
# torch.native_batch_norm, which ops.nn.batch_norm calls): the control
# 'plain' is sound and must pass; the others must fail
GLUON_BF16_FAULTS = ('plain', 'statistics detached', 'variance detached')
GLUON_F32_TOL = {'loss_rel': 1e-5, 'grad_rel_fro': 1e-4}
_ZERO_GRAD = ('body.0.bias', 'body.6.bias')


def _gluon_step(net, x, y, trainer=None):
    """One step of the imperative Gluon loop on ``net``: the loss, every
    gradient and (after the step) the running statistics, on the host."""
    from mxnet_tpu_torch import autograd, gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if trainer is None:
        trainer = gluon.Trainer(net.collect_params(), 'sgd',
                                {'learning_rate': 0.1, 'momentum': 0.9})
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    params = net._collect_params_with_prefix()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != 'null'}
    trainer.step(x.shape[0])
    stats = {k: p.data().asnumpy() for k, p in params.items()
             if p.grad_req == 'null'}
    return loss.asnumpy(), grads, stats


def _nets(make, x, ctxs, seed):
    """One net per context, with the same Xavier weights (drawn on the CPU
    from ``seed``, then rounded to bf16), placed by one forward."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    mt.random.seed(seed)
    nets = []
    for ctx in ctxs:
        net = make()
        net.initialize(mt.init.Xavier(), ctx=ctx)
        net(nd.array(x, ctx=ctx))
        nets.append(net)
    src = nets[0]._collect_params_with_prefix()
    for net in nets[1:]:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(src[k].data())
    return nets


def _bf16(a):
    import torch
    return torch.from_numpy(a).bfloat16().float().numpy()


def _compare(grads, want, stats, want_stats, skip=()):
    """(worst rel Frobenius by name, min cosine, worst stats rel)."""
    import numpy as onp
    rel, cos = {}, []
    for k, g in grads.items():
        if k.endswith(skip):
            continue
        a = onp.asarray(g, onp.float64).ravel()
        b = onp.asarray(want[k], onp.float64).ravel()
        rel[k] = onp.linalg.norm(a - b) / onp.linalg.norm(b)
        cos.append(a @ b / (onp.linalg.norm(a) * onp.linalg.norm(b)))
    srel = [onp.linalg.norm(stats[k] - want_stats[k]) /
            onp.linalg.norm(want_stats[k]) for k in stats]
    return rel, min(cos), max(srel or [0.0])


def _units(net):
    f = net.features
    units = [('stem conv', f[0]), ('stem bn', f[1]), ('stem relu', f[2]),
             ('stem pool', f[3])]
    for s in range(4, 8):
        units += [(f'stage{s - 3} block{i}', b) for i, b in enumerate(f[s])]
    return units + [('pool', f[8]), ('classifier', net.output)]


def _unit_step(unit, x, g, label_grads=None):
    """Training-mode forward of one unit on tensor ``x`` and its backward
    from ``g``: ({param: grad}, {stat: value}) on the host."""
    import torch
    unit.train()
    with torch.enable_grad():
        out = unit(x)
        ps = [(n, p) for n, p in unit.named_parameters() if p.requires_grad]
        gs = torch.autograd.grad(out, [p for _, p in ps], grad_outputs=g) \
            if ps else []
    return ({n: gr.float().cpu().numpy() for (n, _), gr in zip(ps, gs)},
            {n: p.detach().float().cpu().numpy()
             for n, p in unit.named_parameters() if not p.requires_grad})


@contextlib.contextmanager
def _planted_batch_norm(fault):
    """torch.native_batch_norm replaced, for the port's BatchNorm, by a
    plain version (f32 statistics) with ``fault`` planted: 'plain' plants
    none; 'statistics detached' drops the batch statistics from the
    backward; 'variance detached' drops the variance's term only."""
    import torch
    if fault is None:
        yield
        return
    native = torch.native_batch_norm

    def plain(x, w, b, rm, rv, training, momentum, eps):
        dims = [0] + list(range(2, x.dim()))
        sh = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        mean = xf.mean(dims)
        invstd = torch.rsqrt(xf.var(dims, correction=0) + eps)
        m, s = mean, invstd
        if fault == 'statistics detached':
            m, s = m.detach(), s.detach()
        elif fault == 'variance detached':
            s = s.detach()
        y = (xf - m.reshape(sh)) * s.reshape(sh)
        if w is not None:
            y = y * w.float().reshape(sh)
        if b is not None:
            y = y + b.float().reshape(sh)
        return y.to(x.dtype), mean.detach(), invstd.detach()
    torch.native_batch_norm = plain
    try:
        yield
    finally:
        torch.native_batch_norm = native


def _hold_bf16_units(readings, tol):
    """``check`` every unit's reading against the bf16 bounds; returns the
    gradients held to GLUON_BF16_OVER times the CPU's bf16 figure and the
    largest share of its bound any gradient used."""
    over, share = [], 0.0
    for name, rel, rel_cpu, cos, srel in readings:
        check(cos >= tol['grad_min_cos'], f'bf16 {name}: gradient cosine '
              f'{cos:.5f} under {tol["grad_min_cos"]}')
        check(srel <= tol['stats_rel'], f'bf16 {name}: running statistics '
              f'rel {srel:.3e} over {tol["stats_rel"]}')
        for k, e in rel.items():
            bound = tol['grad_rel_fro']
            if rel_cpu[k] > bound:
                bound = GLUON_BF16_OVER * rel_cpu[k]
                over.append(f'{name} {k}')
            check(e <= bound, f'bf16 {name} {k}: gradient rel Frobenius '
                  f'{e:.3e} over {bound:.3e}')
            share = max(share, e / bound)
    return over, share


def gluon_bf16_parity(card, shape=(2, 3, 224, 224), device='cuda'):
    """The bf16 check of GLUON_BF16_TOL, block by block, the planted
    faults of GLUON_BF16_FAULTS, and the end-to-end step printed beside
    the CPU's own bf16 step. ``device`` 'cpu' runs the bf16 side on the
    CPU (a dry run: the 'card' readings are then the CPU's bf16)."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    rng = onp.random.RandomState(SEED + 4)
    x = _bf16(rng.randn(*shape).astype(onp.float32))
    y = rng.randint(0, 1000, shape[0]).astype(onp.int32)
    make = lambda: resnet50_v1(classes=1000)      # noqa: E731
    # the f32 reference with hooks, a second f32 copy and a CPU bf16 copy
    # per unit, and the card's bf16 net: all from one set of weights
    ref, ref_u, cpu16, net = _nets(make, x, [mt.cpu()] * 3 + [ctx],
                                   SEED + 5)
    for n in (ref, ref_u, cpu16, net):
        n.cast('bfloat16')        # every copy holds the rounded weights
    for n in (ref, ref_u):
        n.cast('float32')
    tol = GLUON_BF16_TOL
    ins, outs = [], []

    def hook(m, i, o):
        ins.append(i[0].detach())
        o.retain_grad()
        outs.append(o)
    handles = [u.register_forward_hook(hook) for _, u in _units(ref)]
    ref.train()
    with torch.enable_grad():
        logits = ref(torch.from_numpy(x))
        logits.retain_grad()
        logp = torch.log_softmax(logits, -1)
        (-logp.gather(1, torch.from_numpy(y).long()[:, None])).sum() \
            .backward()
    for h in handles:
        h.detach()
    units = []
    for (name, u16), (_, uref), (_, ucpu16), xin, o in zip(
            _units(net), _units(ref_u), _units(cpu16), ins, outs):
        xb, gb = xin.bfloat16(), o.grad.bfloat16()
        g_ref, s_ref = _unit_step(uref, xb.float(), gb.float())
        if not g_ref:
            continue
        g_cpu, _ = _unit_step(ucpu16, xb, gb)
        rel_cpu, _, _ = _compare(g_cpu, g_ref, {}, {}, _ZERO_GRAD)
        stats0 = [p.detach().clone() for p in u16.parameters()
                  if not p.requires_grad]
        units.append((name, u16, xb.to(device), gb.to(device), g_ref, s_ref,
                      rel_cpu, stats0))

    def card_readings(fault=None):
        """(name, rel by gradient, CPU bf16 rel, cosine, stats rel) per
        unit, each unit's running statistics as they were before."""
        rows = []
        with _planted_batch_norm(fault):
            for name, u16, xb, gb, g_ref, s_ref, rel_cpu, stats0 in units:
                with torch.no_grad():
                    for p, s0 in zip((p for p in u16.parameters()
                                      if not p.requires_grad), stats0):
                        p.copy_(s0)
                g_card, s_card = _unit_step(u16, xb, gb)
                rel, cos, srel = _compare(g_card, g_ref, s_card, s_ref,
                                          _ZERO_GRAD)
                rows.append((name, rel, rel_cpu, cos, srel))
        return rows

    def summary(rows):
        return '; '.join(f'{n} {max(r.values()):.3f}/'
                         f'{max(rc.values()):.3f}' for n, r, rc, _, _ in rows)
    sound = card_readings()
    worst_rel = max(max(r.values()) for _, r, _, _, _ in sound)
    worst_cos = min(c for _, _, _, c, _ in sound)
    worst_stats = max(s for _, _, _, _, s in sound)
    # the loss on the classifier's output, rounded to bf16
    lg = torch.from_numpy(_bf16(logits.detach().numpy()))
    yt = torch.from_numpy(y).long()[:, None]
    loss_card = -torch.log_softmax(lg.bfloat16().to(device), -1).gather(
        1, yt.to(device)).float().cpu()
    loss_ref = -torch.log_softmax(lg, -1).gather(1, yt)
    loss_rel = float((loss_card - loss_ref).abs().max() /
                     loss_ref.abs().max())
    print(f'  parity, resnet50_v1 B=2 224x224 block by block, bf16 {device} '
          f'vs f32 CPU on the same bf16 inputs, upstream gradients and '
          f'weights on {card}: loss rel {loss_rel:.2e}, min cosine '
          f'{worst_cos:.5f}, running statistics rel {worst_stats:.2e}, '
          f'worst gradient rel Frobenius {worst_rel:.3e}; worst per unit, '
          f'card/CPU bf16: {summary(sound)}; tolerance {tol}, over '
          f'{tol["grad_rel_fro"]} where the CPU bf16 is: '
          f'{GLUON_BF16_OVER} x the CPU bf16')
    ratios = sorted(((r[k] / rc[k], f'{n} {k}') for n, r, rc, _, _ in sound
                     for k in r if rc[k] > tol['grad_rel_fro']),
                    reverse=True)
    print(f'  gradients over {tol["grad_rel_fro"]} in the CPU bf16, card/CPU '
          f'bf16 ratio: ' + ', '.join(f'{k} {q:.3f}' for q, k in ratios))
    check(loss_rel <= tol['loss_rel'], f'bf16 resnet50_v1 loss rel '
          f'{loss_rel:.3e} over {tol["loss_rel"]}')
    over, share = _hold_bf16_units(sound, tol)
    print(f'  -> ok: every bound held (at most {share:.2f} of a bound); '
          f'{len(over)} gradients held to {GLUON_BF16_OVER} x the CPU bf16: '
          f'{", ".join(over)}')
    faults = {}
    for fault in GLUON_BF16_FAULTS:
        rows = card_readings(fault)
        try:
            _hold_bf16_units(rows, tol)
            err = None
        except RuntimeError as e:
            err = str(e)
        ratio = max((r[k] / rc[k] for _, r, rc, _, _ in rows for k in r
                     if rc[k] > tol['grad_rel_fro']), default=0.0)
        faults[fault] = dict(caught=err is not None, max_rel=max(
            max(r.values()) for _, r, _, _, _ in rows),
            min_cos=min(c for _, _, _, c, _ in rows),
            max_over_ratio=ratio)
        print(f'  planted fault {fault!r} in the card\'s BatchNorm: worst '
              f'per unit, card/CPU bf16: {summary(rows)}; largest card/CPU '
              f'ratio over {tol["grad_rel_fro"]}: {ratio:.3f}; '
              f'{"fails the bounds: " + err if err else "passes the bounds"}')
        check((err is not None) == (fault != 'plain'),
              f'planted fault {fault!r}: the bf16 check '
              f'{"caught the sound control" if err else "missed it"}')

    # the end-to-end step in bf16, the card and the CPU, against f32
    f32, cpu16, net = _nets(make, x, [mt.cpu(), mt.cpu(), ctx], SEED + 5)
    for n in (f32, cpu16, net):
        n.cast('bfloat16')
    f32.cast('float32')
    e2e = {}
    loss32, g32, s32 = _gluon_step(f32, nd.array(x, ctx=mt.cpu()),
                                   nd.array(y, ctx=mt.cpu()))
    for label, n, c in (('card', net, ctx), ('CPU', cpu16, mt.cpu())):
        loss, g, st = _gluon_step(n, nd.array(x, ctx=c, dtype='bfloat16'),
                                  nd.array(y, ctx=c))
        rel, cos, srel = _compare(g, g32, st, s32, _ZERO_GRAD)
        e2e[label] = dict(loss_rel=float(onp.abs(loss - loss32).max() /
                                         onp.abs(loss32).max()),
                          grad_rel_fro=float(max(rel.values())),
                          grad_min_cos=float(cos), stats_rel=float(srel))
    print(f'  end to end (the whole step in bf16 vs f32 on the CPU, not '
          f'held to bounds): card {e2e["card"]}, the CPU\'s own bf16 '
          f'{e2e["CPU"]}')
    return dict(loss_rel=loss_rel, grad_min_cos=worst_cos,
                stats_rel=worst_stats, grad_rel_fro=worst_rel,
                over=over, faults=faults, end_to_end=e2e)


def gluon_f32_parity(card, shape=(8, 3, 32, 32)):
    """The f32 check of GLUON_F32_TOL: the whole step, card vs CPU."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    rng = onp.random.RandomState(SEED + 7)
    x = rng.randn(*shape).astype(onp.float32)
    y = rng.randint(0, 10, shape[0]).astype(onp.int32)
    ref, net = _nets(lambda: resnet18_v1(classes=10, thumbnail=True), x,
                     [mt.cpu(), mt.gpu(0)], SEED + 8)
    loss, g, st = _gluon_step(net, nd.array(x, ctx=mt.gpu(0)),
                              nd.array(y, ctx=mt.gpu(0)))
    loss_c, g_c, st_c = _gluon_step(ref, nd.array(x, ctx=mt.cpu()),
                                    nd.array(y, ctx=mt.cpu()))
    rel, cos, srel = _compare(g, g_c, st, st_c)
    loss_rel = float(onp.abs(loss - loss_c).max() / onp.abs(loss_c).max())
    worst = max(rel, key=rel.get)
    tol = GLUON_F32_TOL
    ok = loss_rel <= tol['loss_rel'] and rel[worst] <= tol['grad_rel_fro']
    print(f'  parity, resnet18_v1 thumbnail B=8 32x32, f32 card (TF32 off) '
          f'vs CPU on {card}: loss rel {loss_rel:.2e}, worst gradient rel '
          f'Frobenius {rel[worst]:.2e} ({worst}), min cosine {cos:.7f}, '
          f'running statistics rel {srel:.2e}; tolerance {tol} -> '
          f'{"ok" if ok else "FAIL"}')
    check(ok, 'f32 resnet18_v1 on the card disagrees with the CPU')
    return dict(loss_rel=loss_rel, grad_rel_fro=rel[worst], stats_rel=srel)


def gluon_parity(card):
    return {'bf16': gluon_bf16_parity(card), 'f32': gluon_f32_parity(card)}


def gluon_phase(card, batch=64, warmup=2, timed=8, loop_steps=5):
    """MXNet's Gluon front end on the card: (b) bench.py's _resnet_report
    program (ResNet-50 v1, Xavier, bf16, the compiled step with SGD),
    then (a) the imperative Gluon loop on the same net, unhybridized and
    hybridized, and predict mode through hybridize()."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import ShardedTrainStep

    print(f'gluon phase on {card}: the Gluon API (Block, hybridize, '
          f'model zoo) on the card; ResNet-50 v1 at B={batch}, 224x224, '
          f'bf16')
    parity = gluon_parity(card)
    torch.cuda.empty_cache()
    mx.ops.reset_launch_counts()

    # (b) bench.py:195-219 as written, the mesh line left out (one card)
    mx.random.seed(SEED + 6)
    net = resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier())
    net.cast('bfloat16')

    def loss_fn(logits, labels):
        logp = nd.log_softmax(logits, axis=-1)
        return -nd.mean(nd.pick(logp, labels, axis=-1))

    step = ShardedTrainStep(net, loss_fn, 'sgd',
                            {'learning_rate': 0.1, 'momentum': 0.9})
    rng = onp.random.RandomState(0)
    x = nd.array(rng.randn(batch, 3, 224, 224).astype(onp.float32))
    y = nd.array(rng.randint(0, 1000, (batch,)).astype(onp.int32))
    t0 = time.perf_counter()
    warm = []
    for _ in range(warmup):
        v = float(step([x], [y]).asnumpy())
        check(onp.isfinite(v), 'non-finite resnet loss')
        warm.append(v)
    first_s = time.perf_counter() - t0
    calls, losses = [], []
    for _ in range(3):
        t0 = time.time()
        for _ in range(timed):
            loss = step([x], [y])
        losses.append(float(loss.asnumpy()))
        calls.append((time.time() - t0) / timed * 1e3)
    step_ms = sorted(calls)[1]
    check(all(onp.isfinite(v) for v in losses), 'non-finite resnet loss')
    check(len(step._graphs) == 1, f'{len(step._graphs)} graphs captured')
    print(f'  (b) bench.py _resnet_report program: warm-up losses {warm} '
          f'({first_s:.1f} s: call 1 eager and capture), losses after each '
          f'call of {timed} {losses}')
    print(f'  (b) {timed} captured steps at B={batch} on {card}: '
          f'{step_ms:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{c:.3f}" for c in calls)} ms; spread '
          f'{max(calls) - min(calls):.3f} ms), '
          f'{batch / step_ms * 1e3:.1f} images/s')
    busy = device_breakdown(f'ResNet-50 captured step b{batch}',
                            lambda: step([x], [y]), card, 3)

    # (a) the imperative Gluon loop on the same net, bf16
    xb = x.astype('bfloat16')
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.1, 'momentum': 0.9})
    loss_g = gluon.loss.SoftmaxCrossEntropyLoss()

    def loop_step():
        with autograd.record():
            loss = loss_g(net(xb), y)
        loss.backward()
        trainer.step(batch)
        return loss

    loop = {}
    for hybrid in (False, True):
        net.hybridize(hybrid)
        warm_l = [float(loop_step().mean().asscalar()) for _ in range(2)]
        ms = [steps_ms(loop_step, loop_steps) for _ in range(3)]
        last = float(loop_step().mean().asscalar())
        check(all(onp.isfinite(v) for v in warm_l + [last]),
              'non-finite loss in the Gluon loop')
        label = 'hybridized' if hybrid else 'not hybridized'
        loop[label] = sorted(ms)[1]
        print(f'  (a) imperative Gluon loop, {label}, {loop_steps} steps at '
              f'B={batch} bf16 on {card}: {loop[label]:.3f} ms per step, '
              f'the median of 3 calls ({", ".join(f"{m:.3f}" for m in ms)}'
              f' ms); losses {warm_l} ... {last}')
    graphs_train = net._cached_op.num_graphs
    busy_loop = device_breakdown(f'hybridized Gluon loop step b{batch}',
                                 loop_step, card, 3)

    # predict mode: hybridized against the same blocks unhybridized
    net.hybridize(False)
    eager = net(xb).asnumpy()
    net.hybridize()
    first = net(xb).asnumpy()
    replay = net(xb).asnumpy()
    graphs = net._cached_op.num_graphs
    same = onp.array_equal(first, eager) and onp.array_equal(replay, eager)
    print(f'  (a) predict mode at B={batch}: hybridized (warm-up, then '
          f'replay) vs unhybridized forward bitwise '
          f'{"equal" if same else "DIFFERENT"}; graphs captured: {graphs} '
          f'(predict), {graphs_train} (training loop, forward and '
          f'backward)')
    check(same, 'hybridized predict differs from the unhybridized forward')
    check(graphs == 1 and graphs_train == 1, 'unexpected graph counts')
    launches = dict(mx.ops.launch_counts)
    check(not any(launches.values()), f'the Gluon path launched {launches}')
    return launches, dict(step_ms=step_ms, calls_ms=calls,
                          images_per_s=batch / step_ms * 1e3, busy=busy,
                          loop_ms=loop, busy_loop=busy_loop,
                          parity=parity)


# --------------------------------------------------------------------------
# io phase: MXNet's input pipeline on the card
# --------------------------------------------------------------------------

IO_BATCH = 64
IO_IMAGES = 384                  # bench.py's _io_report: 384 JPEGs,
IO_SRC_HW = (360, 480)           # 360 x 480, quality 90
IO_OUT = 224
IO_RESIZE = 256
IO_MEANSTD = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94,
                  std_r=58.4, std_g=57.1, std_b=57.4)
IO_FIXTURE = os.path.join('tools', 'fixtures', 'io_smooth.rec')
IO_RESIDENT_MS = 32.819          # ResNet-50 B = 64 bf16, resident (PR 10)
LEASE_PROBE_BATCHES = 200


def io_probe():
    """What the machine offers the input pipeline, decided up front: the
    native runtime needs g++ and a libjpeg, the system's (jpeglib.h and a
    libjpeg shared library) or the libjpeg-turbo bundled in Pillow's
    wheel (with the port's ABI-62 headers); the records are written with
    PIL where it exists, else read from the committed fixture; with no
    decoder at all the phase runs on raw uint8."""
    import ctypes.util
    import importlib.util
    import shutil
    from mxnet_tpu_torch import _native
    gxx = shutil.which('g++')
    header = False
    if gxx:
        header = subprocess.run(
            [gxx, '-fsyntax-only', '-x', 'c++', '-'],
            input='#include <cstdio>\n#include <jpeglib.h>\n',
            capture_output=True, text=True, timeout=60).returncode == 0
    libjpeg = ctypes.util.find_library('jpeg')
    pil = importlib.util.find_spec('PIL') is not None
    bundled = _native.pillow_libjpeg()
    system = bool(header and libjpeg)
    native = bool(gxx and (system or bundled))
    out = dict(gxx=gxx, jpeglib_h=header, libjpeg=libjpeg, pil=pil,
               pillow_libjpeg=bundled, native=native,
               jpeg=('system' if system else bundled) if native else None,
               decoder=native or pil,
               records=('written (PIL, as bench.py writes them)' if pil
                        else f'the committed fixture {IO_FIXTURE}'))
    path = ('the native runtime on the system libjpeg' if native and system
            else "the native runtime on Pillow's bundled libjpeg-turbo"
            if native else 'the PIL path' if pil
            else 'the raw uint8 path (no JPEG decoder)')
    print(f'  (a) probe: g++ {gxx or "missing"}, jpeglib.h '
          f'{"found" if header else "missing"}, system libjpeg '
          f'{libjpeg or "missing"}, PIL {"found" if pil else "missing"}, '
          f'libjpeg bundled with Pillow {bundled or "missing"} -> decode on '
          f'{path}; records {out["records"] if out["decoder"] else "none"}')
    return out


def io_records(work, probe):
    """(path, images) of the phase's .rec file."""
    import io as pyio
    import numpy as onp
    from mxnet_tpu_torch import recordio
    if not probe['pil']:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            IO_FIXTURE)
        check(os.path.isfile(path), f'{IO_FIXTURE} is missing')
        n = 0
        rec = recordio.MXRecordIO(path, 'r')
        while rec.read() is not None:
            n += 1
        rec.close()
        return path, n
    from PIL import Image
    path = os.path.join(work, 'bench.rec')
    rec = recordio.MXRecordIO(path, 'w')
    rng = onp.random.RandomState(0)
    for i in range(IO_IMAGES):
        img = (rng.rand(*IO_SRC_HW, 3) * 255).astype(onp.uint8)
        buf = pyio.BytesIO()
        Image.fromarray(img).save(buf, format='JPEG', quality=90)
        rec.write(recordio.pack(recordio.IRHeader(0, float(i % 10), i, 0),
                                buf.getvalue()))
    rec.close()
    return path, IO_IMAGES


def _record_iter(path, probe, **kw):
    from mxnet_tpu_torch.io import ImageRecordIter
    args = dict(path_imgrec=path, data_shape=(3, IO_OUT, IO_OUT),
                batch_size=IO_BATCH, resize=IO_RESIZE, rand_crop=True,
                rand_mirror=True, preprocess_threads=os.cpu_count() or 4,
                **IO_MEANSTD)
    args.update(kw)
    it = ImageRecordIter(**args)
    if probe['native'] and args.get('corrupt_policy') != 'skip':
        check(it.native, 'the probe found g++, jpeglib.h and libjpeg but '
              'the native pipeline is not serving the iterator')
    return it


def io_transport(path, probe, transport, prefetch, epochs=3):
    """bench.py's _io_report on the card: images/s of a cold epoch and of
    ``epochs`` warm ones, the decode cache, host bytes per image."""
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.io import DevicePrefetchIter
    it = _record_iter(path, probe, transport=transport)
    src = DevicePrefetchIter(it, depth=2) if prefetch else it
    t0 = time.perf_counter()
    seen = 0
    for b in src:
        seen += b.data[0].shape[0]
    torch.cuda.synchronize()
    cold = seen / (time.perf_counter() - t0)
    telemetry.enable()
    bytes0 = telemetry.counter('mxnet_tpu_io_host_bytes_total').value() or 0
    seen = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        src.reset()
        for b in src:
            seen += b.data[0].shape[0]
    torch.cuda.synchronize()
    warm = seen / (time.perf_counter() - t0)
    host = ((telemetry.counter('mxnet_tpu_io_host_bytes_total').value() or 0)
            - bytes0) / max(seen, 1)
    telemetry.disable()
    check(b.data[0]._data.is_cuda, 'a batch did not land on the card')
    out = dict(images_per_s=warm, cold_images_per_s=cold,
               host_bytes_per_image=host, native=it.native)
    if it.native:
        hits, misses, nbytes = it._pipe.cache_stats()
        out['decode_cache'] = dict(hits=hits, misses=misses, bytes=nbytes)
    return out


def io_resnet_fed(path, probe, card, steps=8):
    """(c) ResNet-50 v1 (bench.py's _resnet_report program, bf16, B = 64)
    fed by ImageRecordIter(transport='u8', dtype='bfloat16') through
    DevicePrefetchIter(depth=2), against the same step on a resident
    batch."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.io import DevicePrefetchIter
    from mxnet_tpu_torch.parallel import ShardedTrainStep

    mx.random.seed(SEED + 6)
    net = resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier())
    net.cast('bfloat16')

    def loss_fn(logits, labels):
        logp = nd.log_softmax(logits, axis=-1)
        return -nd.mean(nd.pick(logp, labels, axis=-1))

    step = ShardedTrainStep(net, loss_fn, 'sgd',
                            {'learning_rate': 0.1, 'momentum': 0.9})
    src = DevicePrefetchIter(_record_iter(path, probe, transport='u8',
                                          dtype='bfloat16'), depth=2)

    def batch():
        try:
            return src.next()
        except StopIteration:
            src.reset()
            return src.next()

    def fed():
        b = batch()
        return step(b.data, b.label)

    warm = [float(fed().asnumpy()) for _ in range(2)]
    check(all(onp.isfinite(warm)), f'non-finite fed losses {warm}')
    for _ in range(IO_IMAGES // IO_BATCH):
        fed()              # the rest of the cold epoch fills the decode cache
    b = batch()
    check(b.data[0]._data.dtype == torch.bfloat16 and
          b.data[0].shape == (IO_BATCH, 3, IO_OUT, IO_OUT),
          f'fed batch {b.data[0].shape} {b.data[0]._data.dtype}')
    xres = nd.NDArray(b.data[0]._data.clone())
    yres = nd.NDArray(b.label[0]._data.clone())

    def resident():
        return step([xres], [yres])

    out = {}
    for label, fn, how in (
            ('fed', fed, 'ImageRecordIter u8 -> bf16 + DevicePrefetchIter(2)'),
            ('resident', resident, 'one batch resident on the card')):
        fn()
        calls = [steps_ms(fn, steps) for _ in range(3)]
        loss = float(fn().asnumpy())
        check(onp.isfinite(loss), f'non-finite {label} loss')
        ms = sorted(calls)[1]
        out[label] = dict(step_ms=ms, calls_ms=calls,
                          images_per_s=IO_BATCH / ms * 1e3)
        print(f'  (c) ResNet-50 v1 at B={IO_BATCH} bf16, {label} ({how}) '
              f'on {card}: {ms:.3f} ms per step, the median of 3 calls of '
              f'{steps} ({", ".join(f"{c:.3f}" for c in calls)} ms; spread '
              f'{max(calls) - min(calls):.3f}), '
              f'{IO_BATCH / ms * 1e3:.1f} images/s, '
              f'{os.cpu_count()} host cores')
        out[label]['busy'] = device_breakdown(
            f'ResNet-50 step b{IO_BATCH}, {label}', fn, card, 3)
    check(len(step._graphs) == 1, f'{len(step._graphs)} graphs captured')
    print(f'  (c) fed against resident: {out["fed"]["step_ms"]:.3f} against '
          f'{out["resident"]["step_ms"]:.3f} ms per step in this run '
          f'(resident {IO_RESIDENT_MS} ms in PR 10\'s run), the pipeline\'s '
          f'gap {out["fed"]["step_ms"] - out["resident"]["step_ms"]:.3f} ms')
    return out


def io_bert_fed(card, steps=5, batch=8, seq=512):
    """(d) The compiled BERT-base step fed by gluon.data.DataLoader
    (pin_memory=True, num_workers=2) against the same batches resident on
    the card: each step's loss bitwise equal."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    L = cfg['layers']
    data, _ = pretraining_batch(cfg, steps * batch, seq, SEED + 40)
    ds = ArrayDataset(*[data[k] for k in ('tokens', 'types', 'valid', 'mpos',
                                          'labels', 'nsp')])

    def make():
        gen = torch.Generator('cuda').manual_seed(SEED + 41)
        net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                                 device='cuda', generator=gen)
        net.load_state_dict(params_from_mxnet_tpu(random_bert_arrays(net),
                                                  net))
        return net, parallel.ShardedTrainStep(
            net, bert_pretrain_loss, 'adamw',
            {'learning_rate': 1e-4, 'wd': 0.01})

    with mt.cpu():
        host = list(DataLoader(ds, batch_size=batch))
    resident = [[x._data.cuda() for x in b] for b in host]
    torch.cuda.synchronize()
    net, step = make()
    want = [step(b[:4], b[4:]) for b in resident]
    want = [float(x) for x in want]
    del net, step
    torch.cuda.empty_cache()

    net, step = make()
    mt.ops.reset_launch_counts()
    loader = DataLoader(ds, batch_size=batch, pin_memory=True, num_workers=2)
    check(loader._pin_to is not None, 'the loader is not pinning for the card')
    t0 = time.perf_counter()
    got = []
    for b in loader:
        check(all(x._data.is_cuda for x in b), 'a loader batch is not on '
              'the card')
        got.append(step(b[:4], b[4:]))
    got = [float(x) for x in got]
    wall = time.perf_counter() - t0
    launches = dict(mt.ops.launch_counts)
    loader.close()
    same = [a.hex() == b.hex() for a, b in zip(got, want)]
    print(f'  (d) compiled BERT-base step (bf16, dropout 0.1, both knobs on) '
          f'fed by DataLoader(pin_memory=True, num_workers=2) over '
          f'{len(ds)} pretraining rows, B={batch} T={seq}, {steps} steps in '
          f'{wall:.2f} s (call 1 eager and capture): losses '
          f'{[x.hex() for x in got]}; resident {[x.hex() for x in want]} '
          f'-> {"bitwise equal" if all(same) else "DIFFERENT"}; launches '
          f'{launches}')
    check(len(got) == steps and all(same), f'fed losses {got} against '
          f'resident {want}')
    check(launches == {'flash_attn_fwd': 2 * L, 'flash_attn_bwd_dq': 2 * L,
                       'flash_attn_bwd_dkv': 2 * L,
                       'fused_add_layernorm': 4 * L, 'dense_gelu': 2 * L},
          f'launch counts {launches} for the eager step and the capture')
    del net, step
    torch.cuda.empty_cache()
    return launches, dict(losses=got)


def _lease_probe_run(path, probe, batches, mutate_drain=False):
    """u8 batches under a slow consumer (a host sleep between next() and
    use, GEMMs on a busy side stream) with a delay planted on the
    iterator's copy stream between each copy and the event behind it,
    compared with their f32 twins on the card with no host sync until
    the end. Returns (batches, mismatches, drains, waits, the returns
    that found their lease's event unfinished)."""
    import torch
    it = _record_iter(path, probe, transport='u8', rand_crop=False,
                      rand_mirror=False, shuffle=True, seed=7)
    twin = _record_iter(path, probe, transport='f32', rand_crop=False,
                        rand_mirror=False, shuffle=True, seed=7)
    events = {}
    early = [0]
    if it._h2d.stream is not None:
        finish, normalize = it._h2d.finish, it._normalize_u8
        returned = it._pipe.return_lease if it._pipe is not None else None

        def delayed_finish(tensors):
            with torch.cuda.stream(it._h2d.stream):
                torch.cuda._sleep(120_000_000)  # ~60 ms before the event
            return finish(tensors)

        def capture(u8):
            # the delay goes behind the lease's copy only, not the labels'
            it._h2d.finish = delayed_finish
            try:
                out, ev = normalize(u8)
            finally:
                it._h2d.finish = finish
            events[it._lease] = ev
            return out, ev

        def checked_return(lease_id):
            early[0] += not events[lease_id].query()
            return returned(lease_id)

        it._normalize_u8 = capture
        if returned is not None:
            it._pipe.return_lease = checked_return
    busy = torch.cuda.Stream()
    a = torch.randn(4096, 4096, device='cuda', dtype=torch.bfloat16)
    bad = torch.zeros((), dtype=torch.int64, device='cuda')
    pads = n = 0
    sync = torch.cuda.Event.synchronize
    if mutate_drain:
        torch.cuda.Event.synchronize = lambda self: None
    try:
        while n < batches:
            try:
                b, t = it.next(), twin.next()
            except StopIteration:
                it.reset()
                twin.reset()
                continue
            with torch.cuda.stream(busy):
                for _ in range(4):
                    a @ a
            time.sleep(0.005)
            bad += (b.data[0]._data != t.data[0]._data).any(
                ) | (b.label[0]._data != t.label[0]._data).any()
            pads += b.pad != t.pad
            n += 1
    finally:
        torch.cuda.Event.synchronize = sync
    torch.cuda.synchronize()
    return n, int(bad) + pads, it.lease_drains, it.lease_drain_waits, \
        early[0]


def io_lease_probe(path, probe, card, batches=LEASE_PROBE_BATCHES):
    """(e) The lease race probe: every lease goes back only after the
    event behind the copy and normalize that read it, and every batch
    equals its twin from the f32 transport with the same seed; the same
    run with the drain's event sync taken out must show leases going
    back early, or the probe could not see a missing drain."""
    t0 = time.perf_counter()
    n, bad, drains, waits, early = _lease_probe_run(path, probe, batches)
    print(f'  (e) lease race probe on {card}: {n} u8 batches (a 5 ms '
          f'consumer sleep, 4 GEMMs of 4096^2 bf16 on a busy side stream, '
          f'~60 ms planted between each copy and its event) against the '
          f'f32 twin: {bad} mismatches; sync.lease_drain {drains} drains, '
          f'{waits} found the copy unfinished and waited, {early} leases '
          f'went back before their event; {time.perf_counter() - t0:.1f} s')
    check(bad == 0, f'{bad} u8 batches differ from the f32 twin')
    check(early == 0, f'{early} leases went back before their copy\'s event')
    out = dict(batches=n, mismatches=bad, drains=drains, waits=waits,
               early=early)
    if probe['native']:
        check(waits > 0, 'the planted delay never outlasted a drain: the '
              'probe cannot see a missing one')
        m = _lease_probe_run(path, probe, 20, mutate_drain=True)
        print(f'  (e) the same with the drain\'s event sync taken out: '
              f'{m[0]} batches, {m[4]} leases went back before their event '
              f'(the lease is pageable, so its copy had staged it: '
              f'{m[1]} mismatches)')
        check(m[4] > 0, 'with no drain no lease went back early: the probe '
              'cannot see a missing drain')
        out['early_without_drain'] = m[4]
    return out


def io_faults(path, probe):
    """(f) The input pipeline's fault sites: io.decode:corrupt under
    corrupt_policy='skip' skips the same records in two runs;
    io.device_put:raise reaches the caller; dataloader.worker:raise
    respawns within its budget and leaves the batches unchanged."""
    import logging
    import warnings
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter
    from mxnet_tpu_torch.resilience import InjectedFault, faults

    skipped = []
    if probe['pil']:
        class Grab(logging.Handler):
            def emit(self, record):
                skipped[-1].append(record.args[0].index)
        log = logging.getLogger('mxnet_tpu_torch.io')
        h = Grab()
        log.addHandler(h)
        try:
            for _ in range(2):
                skipped.append([])
                faults.arm('io.decode', 'corrupt', prob=0.05, seed=11)
                with warnings.catch_warnings():
                    warnings.simplefilter('ignore', RuntimeWarning)
                    it = _record_iter(path, probe, transport='u8',
                                      corrupt_policy='skip')
                check(not it.native, 'io.decode armed: the python path')
                n = sum(b.data[0].shape[0] - b.pad for b in it)
                faults.disarm()
                check(n == IO_IMAGES, f'{n} images in a skipping epoch')
        finally:
            log.removeHandler(h)
            faults.disarm()
        print(f'  (f) io.decode:corrupt (prob 0.05, seed 11) under '
              f'corrupt_policy=skip: skipped records {sorted(skipped[0])} '
              f'then {sorted(skipped[1])}')
        check(skipped[0] and sorted(skipped[0]) == sorted(skipped[1]),
              'the skipped records differ between two runs')
    else:
        print('  (f) io.decode: not run (no PIL: the python decode path, '
              'where the site sits, cannot decode)')

    x = onp.arange(64, dtype=onp.float32).reshape(16, 4)
    y = onp.arange(16, dtype=onp.float32)
    faults.arm('io.device_put', 'raise')
    try:
        pre = DevicePrefetchIter(NDArrayIter(x, y, batch_size=4,
                                             ctx=mx.cpu()), depth=2)
        raised = False
        try:
            pre.next()
        except InjectedFault:
            raised = True
    finally:
        faults.disarm()
    print(f'  (f) io.device_put:raise -> '
          f'{"InjectedFault in the caller" if raised else "NOT RAISED"}')
    check(raised, 'io.device_put:raise did not reach the caller')

    def loader():
        return DataLoader(ArrayDataset(x, y), batch_size=4, num_workers=2,
                          pin_memory=True, worker_retries=2)
    want = [[a.asnumpy() for a in b] for b in loader()]
    telemetry.enable()
    telemetry.reset()
    faults.arm('dataloader.worker', 'raise', window=(1, 2))
    try:
        got = [[a.asnumpy() for a in b] for b in loader()]
    finally:
        faults.disarm()
    respawns = telemetry.value('mxnet_tpu_resilience_worker_respawns_total')
    telemetry.reset()
    telemetry.disable()
    same = len(got) == len(want) and all(
        onp.array_equal(u, v) for bg, bw in zip(got, want)
        for u, v in zip(bg, bw))
    print(f'  (f) dataloader.worker:raise (occurrences 1-2): {respawns} '
          f'respawns, batches {"unchanged" if same else "CHANGED"}')
    check(respawns == 2 and same, 'dataloader.worker respawn')
    torch.cuda.synchronize()
    return dict(skipped=skipped, device_put_raised=raised,
                respawns=respawns)


def io_phase(card):
    """MXNet's input pipeline on the card: (a) the probe, (b) images/s by
    transport, (c) ResNet-50 fed against resident, (d) the compiled BERT
    step fed by the DataLoader, (e) the lease race probe, (f) the fault
    sites. Returns the kernels' launches of (d)'s run."""
    import tempfile
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native

    t_phase = time.perf_counter()
    print(f'io phase on {card}: RecordIO, the native decode runtime, '
          f'ImageRecordIter, DevicePrefetchIter and gluon.data on the card; '
          f'{os.cpu_count()} host cores')
    probe = io_probe()
    if probe['native']:
        t0 = time.perf_counter()
        lib = _native.get_lib()
        check(lib is not None, f'native build failed: {_native.build_error()}')
        print(f'  (a) native runtime: {lib._name}, libjpeg '
              f'{_native.jpeg_route()} ({time.perf_counter() - t0:.1f} s to '
              f'build and load)')
        check(_native.jpeg_route() == probe['jpeg'],
              f'the library links {_native.jpeg_route()}, the probe chose '
              f'{probe["jpeg"]}')
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        if not probe['decoder']:
            # no JPEG decoder at all: raw uint8 through NDArrayIter
            from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter
            rng = onp.random.RandomState(0)
            u8 = (rng.rand(IO_BATCH * 6, 3, IO_OUT, IO_OUT) * 255).astype(
                onp.uint8)
            src = DevicePrefetchIter(NDArrayIter(u8, onp.zeros(len(u8)),
                                                 batch_size=IO_BATCH,
                                                 ctx=mx.cpu()), depth=2)
            t0 = time.perf_counter()
            n = sum(b.data[0].shape[0] for b in src)
            torch.cuda.synchronize()
            print(f'  (b) no JPEG decoder: raw uint8 NDArrayIter + '
                  f'DevicePrefetchIter {n / (time.perf_counter() - t0):.1f} '
                  f'images/s; (c) and the ImageRecordIter parts not run')
            launches, bert = io_bert_fed(card)
            return launches, dict(probe=probe, bert=bert)
        path, n_img = io_records(work, probe)
        print(f'  (b) {n_img} records, {os.path.getsize(path)} bytes: JPEG '
              f'{IO_SRC_HW[0]}x{IO_SRC_HW[1]} -> resize {IO_RESIZE} -> '
              f'random crop '
              f'{IO_OUT} + mirror + mean/std, B={IO_BATCH}, '
              f'{os.cpu_count()} decode threads')
        ab = {}
        for name, transport, prefetch in (('f32-copy', 'f32', False),
                                          ('u8-lease', 'u8', False),
                                          ('u8-lease+device-prefetch', 'u8',
                                           True)):
            ab[name] = r = io_transport(path, probe, transport, prefetch)
            cache = r.get('decode_cache')
            print(f'  (b) {name} on {card}: cold epoch '
                  f'{r["cold_images_per_s"]:.1f} images/s, 3 warm epochs '
                  f'{r["images_per_s"]:.1f} images/s, host bytes per image '
                  f'{r["host_bytes_per_image"]:.0f}, decode cache '
                  + (f'{cache["hits"]} hits, {cache["misses"]} misses, '
                     f'{cache["bytes"] / 2 ** 20:.1f} MiB'
                     if cache else 'n/a (PIL path)'))
        # u8 against f32 on the card, bitwise (center crop: the native
        # pipeline's random crops depend on which decode thread takes a
        # batch)
        kw = dict(rand_crop=False, rand_mirror=False, shuffle=True, seed=3)
        u8 = [(b.data[0]._data, b.label[0]._data) for b in
              _record_iter(path, probe, transport='u8', **kw)]
        f32 = [(b.data[0]._data, b.label[0]._data) for b in
               _record_iter(path, probe, transport='f32', **kw)]
        diff = max(float((a - c).abs().max()) for (a, _), (c, _) in
                   zip(u8, f32))
        labels = all(torch.equal(a, c) for (_, a), (_, c) in zip(u8, f32))
        print(f'  (b) u8 (normalized on the card) against f32 (normalized '
              f'on the host) over {len(u8)} batches on the card: max abs '
              f'difference {diff}, labels {"equal" if labels else "DIFFER"}')
        check(len(u8) == len(f32) and diff == 0.0 and labels,
              'u8 and f32 transports differ on the card')
        del u8, f32
        resnet = io_resnet_fed(path, probe, card)
        torch.cuda.empty_cache()
        launches, bert = io_bert_fed(card)
        lease = io_lease_probe(path, probe, card)
        fault = io_faults(path, probe)
    print(f'  io phase: {time.perf_counter() - t_phase:.1f} s')
    return launches, dict(probe=probe, transports=ab, resnet=resnet,
                          bert=bert, lease=lease, faults=fault)


# --------------------------------------------------------------------------
# dp phase: data parallelism and ZeRO-1 over torch.distributed
# --------------------------------------------------------------------------

# chosen before the first run (PERF.md section 2): two ranks at B = 4
# against one process at B = 8 on the same weights, batches and attention
# masks, in bf16 on the card; the ceiling is the bf16 training bound
# the memory and tile knobs' phases (chosen before their first run; see
# PERF.md section 2): remat against 'none' within the capture-vs-eager
# bound; the autotuned step against the default tile within the bf16
# training bound's loss; ZeRO-3 against ZeRO-1 within DP_TOL
REMAT_TOL = {'loss_rel': 1e-5, 'param_abs': 1e-4}
TUNED_TOL = {'loss_rel': 0.01}
REMAT_POLICIES = ('none', 'layer', 'aggressive')


def tile_checks(card, B=2, H=12, T=300):
    """Every built tensor-core tile of the flash forward, dq and dk/dv
    kernels (flash_attention.TILES), bf16 and float16, at a ragged T with
    a float key mask and dropout 0.1, against the plain version; the tile
    forced through the autotuner's seam and read back from the launch
    counts. {kernel: worst max abs error}."""
    import torch
    from mxnet_tpu_torch.ops import _build, autotune
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator('cuda').manual_seed(SEED + 50)
    worst, n = {}, 0
    for dtype in (torch.bfloat16, torch.float16):
        tol = TOL[str(dtype)[6:]]
        for kind, kernels, table in (
                ('fwd', ('flash_attn_fwd',), fa.TILES['fwd']),
                ('bwd', ('flash_attn_bwd_dq', 'flash_attn_bwd_dkv'),
                 fa.TILES['dq'])):
            for tile, dims in sorted(table.items()):
                for D in dims:
                    q, k, v, do = (torch.randn(B, H, T, D, generator=g,
                                               device='cuda').to(dtype)
                                   for _ in range(4))
                    valid = torch.tensor([T, T // 2 + 7], device='cuda')
                    mask = torch.where(torch.arange(T, device='cuda')[None]
                                       < valid[:, None], 0.0, -1e30)
                    seed = torch.tensor([SEED + n], device='cuda')
                    out, lse = fa.flash_attention_reference(
                        q, k, v, mask, False, 0.1, seed)
                    _build.reset_launch_counts()
                    with autotune.forced(autotune.KERNEL_FA, kind,
                                         (1,) + tile):
                        if kind == 'fwd':
                            got = fa.flash_attention_forward(
                                q, k, v, mask, False, 0.1, seed)[:1]
                            want = (out,)
                        else:
                            got = fa.flash_attention_backward(
                                q, k, v, mask, False, 0.1, seed, out, lse, do)
                            want = fa.flash_attention_backward_reference(
                                q, k, v, mask, False, 0.1, seed, out, lse, do)
                    torch.cuda.synchronize()
                    t = f'{tile[0]}x{tile[1]}'
                    check(_build.tile_counts == {f'{kn}.{t}': 1
                                                 for kn in kernels},
                          f'{kind} at {t} D={D} ran {_build.tile_counts}')
                    # dq is the dq kernel's; dk and dv the dk/dv kernel's
                    owners = (kernels[0],) + (kernels[-1],) * 2
                    for kn, a, b in zip(owners, got, want):
                        err = float((a.float() - b.float()).abs().max())
                        ok = bool(((a.float() - b.float()).abs() <=
                                   tol['atol'] + tol['rtol'] *
                                   b.float().abs()).all())
                        check(ok, f'{kn} tile {t} D={D} {dtype} disagrees '
                              f'with plain (max abs {err:.3e})')
                        key = f'{kn}[{str(dtype)[6:]}]'
                        worst[key] = max(worst.get(key, 0.0), err)
                    n += 1
    print(f'  every built tile against the plain version on {card}: {n} '
          f'(kernel, tile, D, dtype) cases at B={B} H={H} T={T}, float mask, '
          f'dropout 0.1, tolerance {TOL["bfloat16"]} (bf16) / '
          f'{TOL["float16"]} (float16); worst max abs err {worst}')
    return worst


def _sweep_rows(rep, kind, dtype, D):
    """One line per candidate of a measured sweep: its time, its error
    against the plain version, its kernels' registers and spills."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    r = rep[kind]
    for row in r['ranking']:
        tile = tuple(row['blocks'][1:])
        regs = []
        if fa.kernel_variant(dtype, D) == 'tc':
            for kernel in (('fwd',) if kind == 'fwd' else ('dq', 'dkv')):
                a = fa.tile_attributes(kernel, dtype, D, tile)
                regs.append(f'{kernel} {a["registers"]} regs '
                            f'{a["local_bytes"]} B local')
        print(f'    {kind} {tile[0]}x{tile[1]}: '
              + (f'{row["median_ms"]:.4f} ms' if 'median_ms' in row
                 else row.get('error', 'not timed'))
              + f', max abs err {row.get("max_abs_err", float("nan")):.3e}'
              + f', analytic {row["analytic_ms"]:.4f} ms'
              + (f'; {", ".join(regs)}' if regs else ''))
    for tile, why in r['registers']['pruned'].items():
        print(f'    {kind} {tile}: pruned before timing: {why}')
    print(f'    {kind}: {r["candidates"]} candidates, {r["pruned"]} pruned '
          f'by the static rules (G > 1, tiles not built, ...); winner '
          f'{r["winner"]} ({r["source"]})')


def autotune_phase(card, work):
    """The flash-attention tile autotuner on the card: every built tile
    against the plain version; the measured sweep at the compiled step's
    shape (B = 8 -> BH = 96, T = 512, D = 64, bf16, the valid_length float
    mask, dropout 0.1) and at bench.py's own call (batch 1, f32: the SIMT
    kernel's one tile), into a DB under ``work``; a fresh resolve reads
    the winner back with source 'db'."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch.models.bert import bert_base_config
    from mxnet_tpu_torch.ops import autotune
    from mxnet_tpu_torch.ops import flash_attention as fa
    print(f'autotune phase on {card}: the flash kernels\' tiles')
    worst = tile_checks(card)
    data, _ = pretraining_batch(bert_base_config(), 8, 512, SEED)
    mask = torch.where(torch.arange(512)[None] <
                       torch.from_numpy(data['valid'])[:, None], 0.0, -1e30)
    rep = autotune.sweep_flash_attention(
        batch=8, heads=12, seq=512, head_dim=64, dtype=torch.bfloat16,
        key_mask=mask, dropout_p=0.1, db_dir=work)
    check(rep['mode'] == 'measured', f'sweep mode {rep["mode"]}')
    print(f'  sweep at B=8 H=12 T=512 D=64 bf16, float mask, dropout 0.1 '
          f'on {card} ({rep["sweep_seconds"]:.1f} s, median of '
          f'MXTPU_AUTOTUNE_REPS calls each, CUDA events):')
    for kind in ('fwd', 'bwd'):
        _sweep_rows(rep, kind, torch.bfloat16, 64)
        rows = rep[kind]['ranking']
        check(rep[kind]['registers']['checked'], 'registers unchecked')
        check(not [x for x in rows if 'error' in x],
              f'{kind} candidates disagree with the plain version: {rows}')
    rep32 = autotune.sweep_flash_attention(batch=1, heads=12, seq=512,
                                           head_dim=64, dtype=torch.float32,
                                           db_dir=work)
    for kind in ('fwd', 'bwd'):
        _sweep_rows(rep32, kind, torch.float32, 64)
        check(rep32[kind]['candidates'] == 1 and rep32[kind]['winner'] ==
              [1, 64, 64], f'bench.py\'s f32 sweep {rep32[kind]}')
    os.environ['MXTPU_AUTOTUNE_DIR'] = work
    autotune.clear()
    try:
        got = fa._block_sizes(96, 512, 512, 64, torch.bfloat16, 'fwd')
        dec = autotune.decisions()[
            f'{autotune.KERNEL_FA}:{rep["fwd"]["signature"]}']
    finally:
        del os.environ['MXTPU_AUTOTUNE_DIR']
        autotune.clear()
    print(f'  a fresh resolve with MXTPU_AUTOTUNE_DIR set: {got}, {dec}')
    check(list(got) == rep['fwd']['winner'] and dec['source'] == 'db',
          f'resolve {got} {dec}, the sweep\'s winner {rep["fwd"]["winner"]}')
    fwd = {tuple(r['blocks']): r for r in rep['fwd']['ranking']}
    bwd = {tuple(r['blocks']): r for r in rep['bwd']['ranking']}
    return dict(tiles=worst, fwd=fwd, bwd=bwd,
                winner={k: rep[k]['winner'] for k in ('fwd', 'bwd')},
                f32=rep32['fwd']['ranking'][0],
                sweep_s=rep['sweep_seconds'])


def _bert_policy_step(cfg, arrays, batch, seq):
    """BERT-base bf16, dropout 0.1 (hidden and attention, one generator
    seeded alike for every run), both knobs on, ShardedTrainStep with
    AdamW; the flagship batch's first ``batch`` rows (tiled past 8)."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models.bert import BertForPretraining, \
        bert_pretrain_loss
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    gen = torch.Generator('cuda').manual_seed(SEED + 8)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01})
    data, _ = pretraining_batch(cfg, batch, seq, SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    return net, step, [t['tokens'], t['types'], t['valid'], t['mpos']], \
        [t['labels'], t['nsp']]


def remat_phase(card, tuned_dir, replays=3):
    """Path (a): the compiled step under MXTPU_REMAT none, layer and
    aggressive at B = 8 and B = 32 (T = 512, BERT-base bf16, dropout
    0.1): the eager first call and capture, 3 replays held against
    'none', the peak bytes of a replay plus the graph pool, the step ms
    (median of 3 calls of 3 replays), A's launches per replay. Path (b):
    the same step at B = 8 with MXTPU_AUTOTUNE_DIR naming the sweep's DB,
    against the default tile. Launch counts at 0 before each path's
    runs, read after (the eager steps and captures)."""
    import gc
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.bert import BertForPretraining, \
        bert_base_config
    from mxnet_tpu_torch.ops import _build
    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    L = cfg['layers']
    print(f'remat phase on {card}: MXTPU_REMAT none / layer / aggressive')
    arrays = random_bert_arrays(BertForPretraining(
        cfg, dtype=torch.bfloat16, device='cuda'))
    runs, remat_launches, tuned = {}, {}, None
    for batch in (8, 32):
        for policy in REMAT_POLICIES + (('tuned',) if batch == 8 else ()):
            os.environ['MXTPU_REMAT'] = 'none' if policy == 'tuned' \
                else policy
            if policy == 'tuned':
                os.environ['MXTPU_AUTOTUNE_DIR'] = tuned_dir
            gc.collect()
            torch.cuda.empty_cache()
            net, step, ins, labs = _bert_policy_step(cfg, arrays, batch, 512)
            torch.cuda.synchronize()
            mt.ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            losses = [float(step(ins, labs))]      # eager, then the capture
            # the eager step's and the capture's peak (the activations the
            # policy keeps, and the update's temporaries)
            eager_peak = torch.cuda.max_memory_allocated()
            launches = dict(mt.ops.launch_counts)
            tiles = dict(_build.tile_counts)
            losses += [float(step(ins, labs)) for _ in range(replays)]
            # on the host: a copy kept on the card would add to the next
            # run's peaks
            params = {n: p.detach().float().cpu()
                      for n, p in net.named_parameters()}
            torch.cuda.synchronize()
            # the checkpoint's frames form reference cycles: collect them
            # before reading what a replay holds
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(ins, labs)
            torch.cuda.synchronize()
            replay_peak = torch.cuda.max_memory_allocated()
            pool = torch.cuda.memory_reserved() - \
                torch.cuda.memory_allocated()
            calls = sorted(steps_ms(lambda: step(ins, labs), 3)
                           for _ in range(3))
            r = dict(losses=losses, params=params, launches=launches,
                     tiles=tiles, peak=replay_peak + pool,
                     replay_peak=replay_peak, pool=pool,
                     eager_peak=eager_peak, ms=calls[1],
                     calls=calls, stats=step.stats(),
                     sig=step.signature(ins, labs)['flags'])
            if batch == 8:
                names = kernel_launches(lambda: step(ins, labs), 3)
                r['a_per_replay'] = sum(
                    c for n, c in names.items()
                    if 'flash_fwd_tc_kernel' in n) / 3
            runs[(batch, policy)] = r
            print(f'  B={batch} {policy}: losses {[round(x, 5) for x in losses]}'
                  f'; {r["ms"]:.3f} ms a step (median of 3 calls of 3: '
                  f'{", ".join(f"{c:.3f}" for c in calls)}); peak '
                  f'{r["peak"] / 2 ** 30:.3f} GiB (a replay\'s '
                  f'{replay_peak / 2 ** 30:.3f} + graph pool '
                  f'{pool / 2 ** 30:.3f}); the eager step and capture\'s '
                  f'peak {eager_peak / 2 ** 30:.3f} GiB; launches '
                  f'{launches}; tiles '
                  f'{tiles}' + (f'; A per replay {r["a_per_replay"]}'
                                if 'a_per_replay' in r else ''))
            if policy == 'tuned':
                del os.environ['MXTPU_AUTOTUNE_DIR']
            del net, step, ins, labs
        os.environ['MXTPU_REMAT'] = 'none'
    # the default tile everywhere the knobs are unset
    for key, r in runs.items():
        if key[1] != 'tuned':
            check(set(t.split('.')[-1] for t in r['tiles']) == {'64x64'},
                  f'{key} ran tiles {r["tiles"]}')
    for batch in (8, 32):
        base = runs[(batch, 'none')]
        for policy in ('layer', 'aggressive'):
            r = runs[(batch, policy)]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(r['losses'], base['losses']))
            dp = max(float((r['params'][n] - base['params'][n]).abs().max())
                     for n in base['params'])
            r['loss_rel'], r['param_abs'] = rel, dp
            ok = rel <= REMAT_TOL['loss_rel'] and \
                dp <= REMAT_TOL['param_abs']
            print(f'  B={batch} {policy} vs none after the eager step and '
                  f'{replays} replays: loss rel err {rel:.2e}, parameters max '
                  f'abs {dp:.2e}; tolerance {REMAT_TOL} -> '
                  f'{"ok" if ok else "FAIL"}')
            check(ok, f'remat {policy} at B={batch} disagrees with none')
            check(r['sig']['remat'] == policy, f'signature {r["sig"]}')
    for policy in REMAT_POLICIES:
        r = runs[(8, policy)]
        a = r['launches']['flash_attn_fwd']
        want = 2 * L if policy == 'none' else 4 * L
        check(a == want, f'{policy}: {a} forward launches in the eager step '
              f'and the capture, expected {want}')
        check(r['a_per_replay'] == want // 2,
              f'{policy}: A per replay {r["a_per_replay"]}')
        for k, v in r['launches'].items():
            remat_launches[k] = remat_launches.get(k, 0) + v
    t = runs[(8, 'tuned')]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(t['losses'], runs[(8, 'none')]['losses']))
    flags = t['sig']['autotune'] or {}
    ok = rel <= TUNED_TOL['loss_rel']
    print(f'  path (b), MXTPU_AUTOTUNE_DIR set: tiles {t["tiles"]}, loss rel '
          f'err against the default tile {rel:.2e}; tolerance {TUNED_TOL} -> '
          f'{"ok" if ok else "FAIL"}; signature\'s autotune flags {flags}')
    check(ok, 'the autotuned step disagrees with the default tile')
    check(any(v.startswith('db:') for v in flags.values()),
          f'the signature names no db decision: {flags}')
    for key in ((8, 'layer'), (8, 'aggressive'), (32, 'layer'),
                (32, 'aggressive')):
        r, base = runs[key], runs[(key[0], 'none')]
        print(f'  B={key[0]} {key[1]}: peak {r["peak"] / base["peak"]:.3f}x '
              f'none\'s (eager step and capture '
              f'{r["eager_peak"] / base["eager_peak"]:.3f}x), step '
              f'{r["ms"] / base["ms"]:.3f}x none\'s')
    return remat_launches, dict(t['launches']), dict(
        runs={f'{b}/{p}': {k: v for k, v in r.items() if k != 'params'}
              for (b, p), r in runs.items()}, tuned_loss_rel=rel)


DP_TOL = {'loss_rel': 0.01, 'update_rel_fro': 0.1}
DP_SBN_TOL = dict(atol=1e-5, rtol=1e-5)    # SyncBatchNorm, f32, TF32 off
DP_TIMEOUT = 600.0       # seconds for a world of ranks, then all are killed
DP_STEPS, DP_TRAINER_STEPS = 5, 3


def _dp_timed(step, name, log):
    """Wrap ``step``'s collective segment ``name`` so each call's host ms
    (between synchronizes) lands in ``log[name]``."""
    import torch
    fn = getattr(step, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(step, name, timed)


def dp_train(world, rank, work, device='cuda', cfg=None, batch=8, seq=512):
    """One rank's share (at world 1 the whole) of the dp path: BERT-base
    BertForPretraining in bf16, both knobs on, attention dropout 0.1 (the
    shared stream of models.bert.dp_generators), hidden dropout 0, the
    flagship batch's rows [rank * B/world, (rank + 1) * B/world); DP_STEPS
    steps of ShardedTrainStep (AdamW, ZeRO-1 on by default at world > 1),
    then DP_TRAINER_STEPS of the Trainer loop from the same initial
    weights. Launch counters at 0 just before and read just after. Rank 0
    (and world 1) saves the f32 masters after each part to ``work``."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss,
                                             dp_generators)
    from mxnet_tpu_torch.parallel import collectives, dist
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = cfg or bert_base_config()
    dtype = torch.bfloat16 if device == 'cuda' else torch.float32
    hidden, attn = dp_generators(SEED + 5, device)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=dtype,
                             device=device, generator=hidden,
                             attn_generator=attn)
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0          # hidden dropout off; attention's 0.1
    arrays = random_bert_arrays(net)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    data, nmask = pretraining_batch(cfg, batch, seq, SEED)
    b = batch // world
    t = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(device)
         for k, v in data.items()}
    ins = [t['tokens'], t['types'], t['valid'], t['mpos']]
    labs = [t['labels'], t['nsp']]
    mesh = parallel.make_mesh((world,), ('dp',)) if world > 1 else \
        parallel.make_mesh(devices=[device])
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01},
                                     mesh=mesh)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    coll_ms = {}
    mt.ops.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(DP_STEPS):
        if i == 2 and world > 1:
            # host ms of the collective segments, steps 3 on (replays)
            for name in ('_dp_gather', '_dp_reduce', '_dp_gather_params'):
                _dp_timed(step, name, coll_ms)
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(ins, labs)))
        step_ms.append((time.perf_counter() - t0) * 1e3)

    # the f32 masters (the parameters themselves where f32), whole
    step_masters = {n: step._logical(n, step._master.get(
        n, step._local(n, p))) for n, p in step._trainable}
    # the Trainer loop, the recipe as MXNet writes it: each rank's loss is
    # its rows' mean, so the world's sum of gradients divides by world
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    attn.manual_seed(SEED + 6)
    params = gluon.collect_params(net)
    trainer = gluon.Trainer(params, 'adamw',
                            {'learning_rate': 1e-4, 'wd': 0.01,
                             'multi_precision': True})
    tr_losses = []
    for _ in range(DP_TRAINER_STEPS):
        with autograd.record():
            mlm, nsp = net(*ins)
            loss = bert_pretrain_loss(mlm, nsp, *labs)
        loss.backward()
        trainer.step(world)
        net.zero_grad(set_to_none=False)
        lt = loss.detach().float().reshape(1)
        if world > 1:
            collectives.all_reduce_(lt)
        tr_losses.append(float(lt) / world)
    sync()
    launches = dict(mt.ops.launch_counts)
    states = trainer._whole_states() if trainer._zero_dims else \
        trainer._updater.states
    tr_masters = {}
    for i, (n, p) in enumerate(params.items()):
        low = trainer._optimizer._low_precision(p)
        tr_masters[n] = (states[i][0] if low else p).detach().float() \
            .cpu().numpy()
    zero3 = dp_zero3(world, rank, work, cfg, arrays, ins, labs, device) \
        if world > 1 else None
    if zero3 is not None:
        zero3['zero1_param_bytes'] = step.param_bytes_per_device()
    if rank == 0:
        torch.save({'step': step_masters, 'trainer': tr_masters},
                   os.path.join(work, f'masters_dp{world}.pt'))
    return dict(zero3=zero3,
        losses=losses, trainer_losses=tr_losses, step_ms=step_ms,
        coll_ms=coll_ms, launches=launches, zero=step.zero,
        trainer_zero=trainer._zero_active,
        opt_bytes=step.opt_state_bytes_per_device(),
        trainer_opt_bytes=trainer.opt_state_bytes_per_device(),
        param_bytes=step.param_bytes_per_device(),
        comm=step.comm_bytes_per_hop(), graphs=len(step._graphs),
        backend=dist.backend(),
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                  if device == 'cuda' else 0.0),
        initial={n: a for n, a in arrays.items()} if world == 1 else None)


def dp_zero3(world, rank, work, cfg, arrays, ins, labs, device='cuda'):
    """Path (c): ZeRO-3 in ShardedTrainStep at this rank, on the ZeRO-1
    run's weights, batch rows and attention masks (a fresh model with the
    same dp_generators seeds, hidden dropout 0), DP_STEPS steps, eager
    and uncaptured; the launch counters at 0 before and read after. Rank
    0 saves its f32 masters, gathered whole, to ``work``."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_pretrain_loss,
                                             dp_generators)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    hidden, attn = dp_generators(SEED + 5, device)
    cuda = device == 'cuda'
    net = BertForPretraining(dict(cfg, dropout=0.1),
                             dtype=torch.bfloat16 if cuda else torch.float32,
                             device=device, generator=hidden,
                             attn_generator=attn)
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            m._rate = 0.0
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01},
                                     mesh=parallel.make_mesh((world,),
                                                             ('dp',)),
                                     zero=3)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mt.ops.reset_launch_counts()
    losses, step_ms, gather_ms, gathers = [], [], [], []
    for _ in range(DP_STEPS):
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(ins, labs)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        st = step.stats()
        gather_ms.append(st['gather_ms'])
        gathers.append(st['gathers'])
    launches = dict(mt.ops.launch_counts)
    masters = {n: step._logical(n, step._master.get(n, step._local(n, p)))
               for n, p in step._trainable}
    if rank == 0:
        torch.save(masters, os.path.join(work, f'masters_zero3_dp{world}.pt'))
    return dict(losses=losses, step_ms=step_ms, gather_ms=gather_ms,
                gathers=gathers, launches=launches, stats=step.stats(),
                param_bytes=step.param_bytes_per_device(),
                opt_bytes=step.opt_state_bytes_per_device(),
                modes=sorted({v['mode'] for v in
                              step.zero3_layouts.values()}),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30
                if cuda else 0.0)


def dp_kernel_checks(world, rank, batch=8, seq=512):
    """Each kernel the dp path launches against its plain version on this
    rank's shapes: the flash forward, dq and dk/dv with dropout 0.1 at
    this rank's bh_base (rank * B/world * heads), LayerNorm and FFN1 on
    the rank's rows. {kernel: max abs error}."""
    import torch
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_ffn, fused_layernorm
    b, H, D, C = batch // world, 12, 64, 768
    bh_base = rank * b * H
    g = torch.Generator('cuda').manual_seed(SEED + 40 + rank)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device='cuda') * scale) \
            .to(torch.bfloat16)
    q, k, v, do = (rnd(b, H, seq, D) for _ in range(4))
    valid = torch.randint(seq // 2, seq + 1, (b,), generator=g,
                          device='cuda')
    mask = torch.where(torch.arange(seq, device='cuda')[None] <
                       valid[:, None], 0.0, -1e30)
    seed = torch.randint(0, 2 ** 32, (1,), generator=g, device='cuda',
                         dtype=torch.int64)
    tol = TOL['bfloat16']
    out, lse = fa.flash_attention_forward(q, k, v, mask, False, 0.1, seed,
                                          bh_base=bh_base)
    ref, _ = fa.flash_attention_reference(q, k, v, mask, False, 0.1, seed,
                                          bh_base=bh_base)
    errs = {'flash_attn_fwd': compare(
        f'rank {rank} flash forward, bh_base {bh_base}', out, ref, **tol)}
    got = fa.flash_attention_backward(q, k, v, mask, False, 0.1, seed, out,
                                      lse, do, bh_base=bh_base)
    want = fa.flash_attention_backward_reference(q, k, v, mask, False, 0.1,
                                                 seed, out, lse, do,
                                                 bh_base=bh_base)
    errs['flash_attn_bwd_dq'] = compare(
        f'rank {rank} dq, bh_base {bh_base}', got[0], want[0], **tol)
    errs['flash_attn_bwd_dkv'] = max(
        compare(f'rank {rank} d{n}, bh_base {bh_base}', a, w, **tol)
        for n, a, w in zip('kv', got[1:], want[1:]))
    x, r = rnd(b * seq, C), rnd(b * seq, C)
    gamma, beta = rnd(C, scale=0.1) + 1, rnd(C, scale=0.1)
    errs['fused_add_layernorm'] = compare(
        f'rank {rank} LayerNorm', fused_layernorm.fused_add_layer_norm(
            x, r, gamma, beta),
        fused_layernorm.add_layer_norm_reference(x, r, gamma, beta), **tol)
    w, bias = rnd(4 * C, C, scale=0.02), rnd(4 * C, scale=0.02)
    errs['dense_gelu'] = compare(
        f'rank {rank} FFN1', fused_ffn.fused_dense_gelu(x, w, bias),
        fused_ffn.dense_gelu_reference(x, w, bias), **tol)
    return errs


def dp_sync_bn(world, rank, device='cuda', batch=8):
    """A small conv net with SyncBatchNorm (BatchNorm at world 1) in f32,
    one training forward on the rank's rows of a seeded batch: (outputs,
    running means, running vars) as numpy."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import collectives
    norm = nn.SyncBatchNorm if world > 1 else nn.BatchNorm
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    with ctx:
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                norm(in_channels=8), nn.Activation('relu'),
                nn.Conv2D(8, 3, padding=1, in_channels=8),
                norm(in_channels=8))
        net.initialize()
    rng = onp.random.RandomState(SEED + 7)
    net.load_state_dict({n: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(onp.float32) * 0.3
        if n.endswith('weight') else p.detach().cpu().numpy())
        for n, p in net.named_parameters()})
    x = rng.standard_normal((batch, 3, 16, 16)).astype(onp.float32)
    b = batch // world
    net.train()
    with collectives.data_axis('dp'):
        y = net(torch.from_numpy(x[rank * b:(rank + 1) * b]).to(device))
    stats = {n: p.detach().cpu().numpy().copy()
             for n, p in net.named_parameters() if 'running' in n}
    return y.detach().cpu().numpy(), stats


def dp_rank_main(rank, world, work, backend):
    """A rank of the dp phase (chip_smoke.py --dp-rank R ...)."""
    import pickle
    import torch
    from mxnet_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device('cuda', rank % torch.cuda.device_count()) \
        if backend == 'nccl' else None
    dist.init(coordinator=f'file://{work}/store_{backend}',
              num_processes=world, process_id=rank, backend=backend,
              device=dev, timeout=DP_TIMEOUT)
    res = dp_train(world, rank, work)
    res['kernels'] = dp_kernel_checks(world, rank)
    res['bh_base'] = rank * (8 // world) * 12
    if backend == 'gloo':
        res['sbn'] = dp_sync_bn(world, rank)
    with open(os.path.join(work, f'{backend}_rank{rank}.pkl'), 'wb') as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.shutdown()
    return 0


def _dp_world(world, backend, work):
    """Spawn ``world`` ranks of this script; every rank is killed and the
    phase fails at DP_TIMEOUT. Returns each rank's readings."""
    import pickle
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--dp-rank', str(r),
         '--dp-world', str(world), '--dp-dir', work, '--dp-backend',
         backend], env=dict(os.environ, OMP_NUM_THREADS='4'))
        for r in range(world)]
    deadline = time.monotonic() + DP_TIMEOUT
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline -
                                                time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * world, f'dp ranks over {backend} exited {codes} '
          f'(None: killed at {DP_TIMEOUT:.0f} s)')
    out = []
    for r in range(world):
        with open(os.path.join(work, f'{backend}_rank{r}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


def _update_rel_fro(got, want, initial):
    """The rel Frobenius norm of the difference of two runs' updates from
    ``initial``, over every tensor: |got - want| / |want - initial|."""
    import numpy as onp
    num = sum(float(onp.square(onp.asarray(got[n], onp.float64) -
                               onp.asarray(want[n], onp.float64)).sum())
              for n in want)
    den = sum(float(onp.square(onp.asarray(want[n], onp.float64) -
                               onp.asarray(initial[n], onp.float64)).sum())
              for n in want)
    return (num / den) ** 0.5


def _hold_dp(label, ranks, ref, ref_masters, got_masters, card):
    import numpy as onp
    worst = 0.0
    for key in ('losses', 'trainer_losses'):
        for o in ranks:
            rel = max(abs(a - b) / abs(b) for a, b in zip(o[key], ref[key]))
            worst = max(worst, rel)
    upd = {k: _update_rel_fro(got_masters[k], ref_masters[k], ref['initial'])
           for k in ('step', 'trainer')}
    ok = worst <= DP_TOL['loss_rel'] and \
        max(upd.values()) <= DP_TOL['update_rel_fro']
    print(f'  {label} vs one process at B=8 (dp=1), on {card}: per-step '
          f'loss rel err max {worst:.2e}; masters\' updates rel_fro '
          f'step {upd["step"]:.4f}, Trainer {upd["trainer"]:.4f}; '
          f'tolerance {DP_TOL} -> {"ok" if ok else "FAIL"}')
    print(f'    losses: dp {ranks[0]["losses"]} / {ranks[0]["trainer_losses"]}'
          f'; dp=1 {ref["losses"]} / {ref["trainer_losses"]}')
    check(all(onp.isfinite(x) for o in ranks for x in o['losses']),
          'non-finite dp loss')
    check(ok, f'{label} disagrees with one process')
    return dict(loss_rel=worst, **{f'update_rel_fro_{k}': v
                                   for k, v in upd.items()})


def _hold_zero3(ranks, ref, zero1_masters, work, world, card):
    """Path (c) against ZeRO-1 on the same ranks (DP_TOL): per-step losses,
    the f32 masters' updates; the parameter bytes a rank holds, stage 3
    over stage 1, in [0.45, 0.55]; the step uncaptured. Returns ({kernel:
    launches summed over the ranks}, readings)."""
    import numpy as onp
    import torch
    z = [o['zero3'] for o in ranks]
    rel = max(abs(a - b) / abs(b) for o, zo in zip(ranks, z)
              for a, b in zip(zo['losses'], o['losses']))
    masters = torch.load(os.path.join(work, f'masters_zero3_dp{world}.pt'),
                         weights_only=False)
    upd = _update_rel_fro(masters, zero1_masters['step'], ref['initial'])
    ratio = z[0]['param_bytes'] / z[0]['zero1_param_bytes']
    ok = rel <= DP_TOL['loss_rel'] and upd <= DP_TOL['update_rel_fro']
    gms = float(onp.median(z[0]['gather_ms'][1:]))
    print(f'  path (c), ZeRO-3 at dp={world} over gloo vs ZeRO-1 on the same '
          f'ranks, weights, rows and masks, on {card}: per-step loss rel err '
          f'max {rel:.2e}; masters\' updates rel_fro {upd:.4f}; tolerance '
          f'{DP_TOL} -> {"ok" if ok else "FAIL"}')
    print(f'    ZeRO-3 losses {z[0]["losses"]}; ZeRO-1 {ranks[0]["losses"]}')
    print(f'    captured: {z[0]["stats"]["captured"]} (eager: gloo cannot be '
          f'captured and a gather sits before every layer group); layouts '
          f'{z[0]["modes"]}; {z[0]["stats"]["layer_groups"]} layer groups, '
          f'{z[0]["gathers"]} group all-gathers a step (forward and '
          f'backward), their host ms a step {[round(x, 1) for x in z[0]["gather_ms"]]} '
          f'(median of steps 2-{DP_STEPS} {gms:.1f}); step ms '
          f'{[round(x, 1) for x in z[0]["step_ms"]]}; parameter bytes a rank '
          f'{z[0]["param_bytes"]} against ZeRO-1\'s '
          f'{z[0]["zero1_param_bytes"]} (ratio {ratio:.4f}); optimizer '
          f'state {z[0]["opt_bytes"]}; peak {z[0]["peak_gib"]:.2f} GiB a '
          f'rank; launches {z[0]["launches"]}')
    check(all(onp.isfinite(x) for zo in z for x in zo['losses']),
          'non-finite ZeRO-3 loss')
    check(ok, 'ZeRO-3 disagrees with ZeRO-1')
    check(0.45 <= ratio <= 0.55, f'ZeRO-3 parameter bytes ratio {ratio}')
    check(all(zo['stats']['captured'] is False for zo in z),
          'the stage-3 step claims to be captured')
    L = 12
    want = {'flash_attn_fwd': DP_STEPS * L, 'flash_attn_bwd_dq': DP_STEPS * L,
            'flash_attn_bwd_dkv': DP_STEPS * L,
            'fused_add_layernorm': 2 * DP_STEPS * L,
            'dense_gelu': DP_STEPS * L}
    for zo in z:
        check(zo['launches'] == want, f'ZeRO-3 launches {zo["launches"]}, '
              f'expected {want} (every step eager)')
    launches = {k: sum(zo['launches'][k] for zo in z) for k in want}
    return launches, dict(loss_rel=rel, update_rel_fro=upd, ratio=ratio,
                          gather_ms=gms, gathers=z[0]['gathers'][-1],
                          layer_groups=z[0]['stats']['layer_groups'],
                          step_ms=float(onp.median(z[0]['step_ms'][1:])))


def dp_phase(card, world=2):
    """Two ranks on the one card over gloo against one process (see the
    module docstring, step 11). Returns ({kernel: launches summed over the
    ranks}, {kernel: max abs error at bh_base != 0}, readings)."""
    import shutil
    import numpy as onp
    import torch
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'dp_phase')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print(f'dp phase on {card}: data parallelism and ZeRO-1 over '
          f'torch.distributed; the reference is one process at B=8')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = dp_train(1, 0, work)
    sbn_ref = dp_sync_bn(1, 0)
    ref_masters = torch.load(os.path.join(work, 'masters_dp1.pt'),
                             weights_only=False)
    torch.cuda.empty_cache()
    print(f'  dp=1: losses {ref["losses"]}, Trainer {ref["trainer_losses"]}, '
          f'step ms {[round(x, 3) for x in ref["step_ms"]]}, peak '
          f'{ref["peak_gib"]:.2f} GiB')
    t0 = time.perf_counter()
    ranks = _dp_world(world, 'gloo', work)
    print(f'  world of {world} ranks on the one card over '
          f'{ranks[0]["backend"]} (asked for by name: NCCL refuses two ranks '
          f'on one card) in {time.perf_counter() - t0:.1f} s; every '
          f'collective took the CUDA tensors as they are (gloo copies '
          f'through host memory itself); ZeRO-1 '
          f'{ranks[0]["zero"]} (step), {ranks[0]["trainer_zero"]} (Trainer); '
          f'{ranks[0]["graphs"]} captured signature')
    check(all(o['backend'] == 'gloo' and o['zero'] and o['trainer_zero']
              for o in ranks), 'a rank is not on gloo with ZeRO-1')
    got_masters = torch.load(os.path.join(work, f'masters_dp{world}.pt'),
                             weights_only=False)
    parity = _hold_dp(f'dp={world} over gloo', ranks, ref, ref_masters,
                      got_masters, card)
    L = 12
    want = {'flash_attn_fwd': 2 * L + DP_TRAINER_STEPS * L,
            'flash_attn_bwd_dq': 2 * L + DP_TRAINER_STEPS * L,
            'flash_attn_bwd_dkv': 2 * L + DP_TRAINER_STEPS * L,
            'fused_add_layernorm': 4 * L + 2 * DP_TRAINER_STEPS * L,
            'dense_gelu': 2 * L + DP_TRAINER_STEPS * L}
    for o in ranks:
        check(o['launches'] == want, f'rank launches {o["launches"]}, '
              f'expected {want} (the eager step and the capture, then the '
              f'Trainer loop\'s steps)')
    launches = {k: sum(o['launches'][k] for o in ranks) for k in want}
    errs = {k: max(o['kernels'][k] for o in ranks if o['bh_base'])
            for k in ranks[0]['kernels']}
    print(f'  kernels vs plain at bh_base {[o["bh_base"] for o in ranks]}: '
          f'max abs err over the ranks with bh_base != 0 {errs}')
    ratio = ranks[0]['opt_bytes'] / ref['opt_bytes']
    coll = {k: float(onp.median(v)) for k, v in ranks[0]['coll_ms'].items()}
    rank_ms = float(onp.median(ranks[0]['step_ms'][2:]))
    print(f'  {card}: opt_state_bytes_per_device {ranks[0]["opt_bytes"]} at '
          f'dp={world} against {ref["opt_bytes"]} at dp=1 (ratio '
          f'{ratio:.4f}; Trainer {ranks[0]["trainer_opt_bytes"]} against '
          f'{ref["trainer_opt_bytes"]}); analytic ring bytes per step '
          f'{ranks[0]["comm"]}; host ms a step of the collectives (median '
          f'of steps 3-{DP_STEPS}, between synchronizes): {coll}')
    print(f'  {card}: step ms {rank_ms:.3f} (median of steps 3-{DP_STEPS}; '
          f'two ranks sharing one card over gloo, the collectives through '
          f'host memory: not a speed figure) against {float(onp.median(ref["step_ms"][2:])):.3f} '
          f'at dp=1; peak {ranks[0]["peak_gib"]:.2f} GiB a rank')
    check(0.45 <= ratio <= 0.55, f'ZeRO-1 state ratio {ratio}')
    out = onp.concatenate([o['sbn'][0] for o in ranks])
    compare('SyncBatchNorm at dp=2 vs BatchNorm at dp=1, outputs',
            torch.from_numpy(out), torch.from_numpy(sbn_ref[0]),
            **DP_SBN_TOL)
    for o in ranks:
        for n, v in sbn_ref[1].items():
            compare(f'SyncBatchNorm {n}, rank {ranks.index(o)}',
                    torch.from_numpy(o['sbn'][1][n]), torch.from_numpy(v),
                    **DP_SBN_TOL)
    zero3 = _hold_zero3(ranks, ref, got_masters, work, world, card)
    nccl = None
    count = torch.cuda.device_count()
    if count >= 2:
        n = min(4, count)
        nranks = _dp_world(n, 'nccl', work)
        masters = torch.load(os.path.join(work, f'masters_dp{n}.pt'),
                             weights_only=False)
        nccl = _hold_dp(f'dp={n} over NCCL', nranks, ref, ref_masters,
                        masters, card)
        print(f'  nccl: ran on {n} cards, step ms '
              f'{float(onp.median(nranks[0]["step_ms"][2:])):.3f}')
    else:
        print('  nccl: not run (1 card)')
    return launches, errs, dict(parity=parity, ratio=ratio, coll_ms=coll,
                                step_ms=rank_ms, nccl=nccl,
                                zero3=zero3[1]), zero3[0]


# the tiled kernels' rows, and the sweep's ranking each reads its times from
# -- resilience: the guard, checkpoints, faults and the watchdog ----------

RESIL_STEPS = 10
RESIL_FAULT = 'step.dispatch:nan:1:0:5-7'
RESIL_SMALL = dict(vocab_size=1000, hidden=256, layers=2, heads=4,
                   intermediate=1024, max_len=128, type_vocab=2)
RESIL_TIMEOUT = 300.0      # seconds for the preemption child, then killed


def _resil_net(cfg, seed, dropout=0.1):
    import torch
    from mxnet_tpu_torch.models.bert import BertForPretraining
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    gen = torch.Generator('cuda').manual_seed(seed)
    net = BertForPretraining(dict(cfg, dropout=dropout), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    net.load_state_dict(params_from_mxnet_tpu(random_bert_arrays(net), net))
    return net


def _resil_step(net, guard=None):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models.bert import bert_pretrain_loss
    return parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01},
                                     guard=guard)


def _resil_batch(cfg, batch, seq, seed):
    import torch
    data, _ = pretraining_batch(cfg, batch, seq, seed)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    return [t['tokens'], t['types'], t['valid'], t['mpos']], \
        [t['labels'], t['nsp']]


def _resil_state(net, step):
    """Parameters, masters, moments and update counts, cloned on the
    card."""
    return ({n: p.detach().clone() for n, p in net.named_parameters()},
            {n: m.clone() for n, m in step._master.items()},
            {n: tuple(s.clone() for s in st)
             for n, st in step._state.items()}, step._t.clone())


def _resil_equal(a, b):
    import torch
    pa, ma, sa, ta = a
    pb, mb, sb, tb = b
    return all(torch.equal(pa[n], pb[n]) for n in pa) and \
        all(torch.equal(ma[n], mb[n]) for n in ma) and \
        all(torch.equal(x, y) for n in sa for x, y in zip(sa[n], sb[n])) \
        and torch.equal(ta, tb)


def _digest(tensors):
    """sha256 over the named tensors' bytes, in name order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for n in sorted(tensors):
        t = tensors[n].detach().cpu().contiguous()
        h.update(n.encode())
        h.update(t.view(torch.uint8).numpy().tobytes()
                 if t.dtype == torch.bfloat16 else t.numpy().tobytes())
    return h.hexdigest()


def resilience_child(work):
    """The preempted process of path (c): the small BERT's compiled step
    on the card under a CheckpointManager with the SIGTERM hook and no
    autosave cadence; after 3 steps it waits for the signal, which commits
    step 3, and writes the digest of its live parameters."""
    import torch
    from mxnet_tpu_torch import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    net = _resil_net(RESIL_SMALL, SEED + 21)
    step = _resil_step(net)
    mgr = checkpoint.CheckpointManager(os.path.join(work, 'preempt'),
                                       params=net, trainer=step)
    mgr.install_preemption_hook()
    for k in range(1, 4):
        step(*_resil_batch(RESIL_SMALL, 4, 128, SEED + 30 + k))
        mgr.maybe_save(k)
    torch.cuda.synchronize()
    print('READY 3', flush=True)
    deadline = time.monotonic() + RESIL_TIMEOUT
    while not mgr.preempted and time.monotonic() < deadline:
        time.sleep(0.05)
    with open(os.path.join(work, 'preempt.json'), 'w') as f:
        json.dump({'preempted': mgr.preempted, 'steps': mgr.all_steps(),
                   'digest': _digest(dict(net.named_parameters()))}, f)
    mgr.close()
    return 0 if mgr.preempted else 1


def _resil_preempt(work, card):
    """Path (c): the SIGTERM child, a new manager restoring its step, a
    corrupt write falling back, and /healthz."""
    import signal
    import warnings
    from mxnet_tpu_torch import checkpoint, resilience
    from mxnet_tpu_torch.telemetry import server
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--resilience-child',
         work], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS='4'))
    try:
        deadline = time.monotonic() + RESIL_TIMEOUT
        line = ''
        while 'READY' not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        check('READY 3' in line, f'the preemption child never got ready '
              f'(exit {proc.poll()})')
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=RESIL_TIMEOUT)
        sig_s = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(work, 'preempt.json')) as f:
        child = json.load(f)
    print(f'  (c) SIGTERM to the child at step 3: exit {code}, committed '
          f'{child["steps"]}, {sig_s:.2f} s from the signal to its exit')
    check(code == 0 and child['preempted'] and child['steps'] == [3],
          f'preemption child: exit {code}, {child}')
    net = _resil_net(RESIL_SMALL, SEED + 22)
    step = _resil_step(net)
    mgr = checkpoint.CheckpointManager(os.path.join(work, 'preempt'),
                                       params=net, trainer=step)
    check(mgr.restore_latest() == 3, 'the SIGTERM step did not restore')
    same = _digest(dict(net.named_parameters())) == child['digest']
    print(f'  (c) a new manager restores step 3: parameters '
          f'{"bitwise" if same else "NOT"} the preempted process\'s')
    check(same, 'the restored parameters differ from the preempted ones')
    loss = float(step(*_resil_batch(RESIL_SMALL, 4, 128, SEED + 34)))
    check(loss == loss, 'non-finite loss after the SIGTERM restore')
    resilience.faults.arm('checkpoint.write', 'corrupt', window=1)
    try:
        mgr.save(4, block=True)
    finally:
        resilience.faults.disarm()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        back = mgr.restore_latest(apply=False).step
    fell = any('falling back' in str(w.message) for w in caught)
    print(f'  (c) checkpoint.write:corrupt at step 4: committed '
          f'{mgr.all_steps()}, restore_latest falls back to step {back}')
    check(mgr.all_steps() == [3, 4] and back == 3 and fell,
          f'corrupt step: {mgr.all_steps()}, restored {back}')
    srv = server.TelemetryServer(port=0)
    try:
        import http.client
        conn = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=10)
        conn.request('GET', '/healthz')
        doc = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.stop()
    want = checkpoint.last_committed_step()
    print(f'  (c) /healthz last_committed_step: '
          f'{doc["last_committed_step"]} (newest over this process\'s '
          f'managers: {want})')
    check(doc['last_committed_step'] == want and want is not None,
          f'/healthz says {doc["last_committed_step"]}, expected {want}')
    mgr.close()


def _resil_watchdog(card):
    """Path (d): the serving engine with its watchdog armed."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.bert import BertModel
    cfg = dict(RESIL_SMALL)
    del cfg['type_vocab']
    net = BertModel(**cfg, dtype=torch.bfloat16, device='cuda')
    rng = onp.random.RandomState(SEED + 40)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith('weight'):
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                         .astype('float32') * 0.02))
    runner = mt.serving.BlockRunner(net)
    kw = dict(seq_buckets='64,128', batch_buckets='1,4', deadline_ms=2.0)
    warm = mt.serving.InferenceEngine(runner, **kw)
    mt.serving.warmup(warm)
    warm.drain()
    engine = mt.serving.InferenceEngine(runner, watchdog_seconds=2.0, **kw)
    errors = []

    def client(k):
        r = onp.random.RandomState(k)
        try:
            for _ in range(8):
                engine.submit(list(r.randint(1, 1000, r.randint(8, 129))),
                              timeout=60.0)
        except Exception as e:          # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    burst_s = time.perf_counter() - t0
    engine.drain()
    burst = engine.watchdog.stalls
    print(f'  (d) serving burst of 32 requests in {burst_s:.2f} s with the '
          f'watchdog armed (2 s): {burst} stall reports, '
          f'{engine.stats()["batches"]} batches')
    check(not errors and burst == 0, f'burst: {errors}, {burst} stalls')

    calls = []

    def stalled(mat):
        calls.append(1)
        if len(calls) == 2:
            time.sleep(3.0)
        return runner(mat)
    reports = []
    engine = mt.serving.InferenceEngine(stalled, watchdog_seconds=1.0, **kw)
    note = engine.watchdog.on_stall
    engine.watchdog.on_stall = lambda rep: (reports.append(rep), note(rep))
    for k in range(3):
        engine.submit(list(range(1, 60 + k)), timeout=60.0)
    engine.drain()
    stalls = engine.watchdog.stalls
    print(f'  (d) a runner planted to stall 3 s on its 2nd batch, watchdog '
          f'1 s: {stalls} stall report(s); first line: '
          f'{reports[0].splitlines()[0] if reports else None}')
    check(stalls == 1 and len(reports) == 1,
          f'planted stall: {stalls} reports')


def resilience_phase(card, batch=8, seq=512):
    """Training that survives faults on the flagship path: BERT-base
    ShardedTrainStep (bf16, dropout 0.1, AdamW, both knobs on, one CUDA
    graph) with a NonFiniteGuard and an async CheckpointManager (keep the
    last 2 and every 4th step, autosave every 2), MXTPU_FAULT's grammar
    planting NaN on steps 5-7."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import checkpoint, resilience
    from mxnet_tpu_torch.models.bert import bert_base_config

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    print(f'resilience phase on {card}: NonFiniteGuard + CheckpointManager '
          f'on the compiled BERT-base step, {RESIL_FAULT}')
    cfg = bert_base_config()
    L = cfg['layers']
    work = tempfile.mkdtemp(prefix='mxtt_resilience_')
    t_phase = time.perf_counter()
    try:
        batches = [_resil_batch(cfg, batch, seq, SEED + 100 + k)
                   for k in range(RESIL_STEPS)]
        # (a) the guarded run
        net = _resil_net(cfg, SEED + 5)
        mgr = checkpoint.CheckpointManager(
            os.path.join(work, 'a'), keep_last_n=2, keep_every_k_steps=4,
            autosave_steps=2)
        guard = resilience.NonFiniteGuard(manager=mgr, max_consecutive_bad=3)
        step = _resil_step(net, guard)
        mgr.bind_params(net)
        mgr.bind_trainer(step)
        resilience.faults.arm_from_env(RESIL_FAULT)
        held, losses, saves = [], [], []
        mt.ops.reset_launch_counts()
        try:
            for k, (ins, labs) in enumerate(batches, start=1):
                before = _resil_state(net, step) if k in (5, 6, 7) else None
                losses.append(step(ins, labs))
                if before is not None:
                    held.append(_resil_equal(before,
                                             _resil_state(net, step)))
                if guard.maybe_save(k):
                    saves.append((k, mgr.last_blocked_seconds))
            mgr.wait()
        finally:
            resilience.faults.disarm()
        launches = dict(mt.ops.launch_counts)
        losses = [float(x) for x in losses]
        steps_kept = mgr.all_steps()
        print(f'  (a) losses {losses}')
        print(f'  (a) bad steps {guard.bad_steps}, rollbacks '
              f'{guard.rollbacks} to step {guard.last_rollback_step}, '
              f'committed {steps_kept}; parameters, masters, moments and t '
              f'bitwise unchanged across steps 5, 6, 7: {held}')
        print(f'  (a) host launches (eager step + capture of the guarded '
              f'step): {launches}')
        check(held == [True] * 3, f'a skipped step moved the state: {held}')
        check([x != x for x in losses] == [k in (5, 6, 7) for k in
                                          range(1, RESIL_STEPS + 1)],
              f'losses {losses}')
        check((guard.bad_steps, guard.rollbacks, guard.last_rollback_step)
              == (3, 1, 4), f'guard ladder {guard.bad_steps}, '
              f'{guard.rollbacks}, {guard.last_rollback_step}')
        check(steps_kept == [4, 8, 10] and not {5, 6, 7} & set(steps_kept),
              f'committed steps {steps_kept}')
        check(launches == {'flash_attn_fwd': 2 * L, 'flash_attn_bwd_dq': 2 * L,
                           'flash_attn_bwd_dkv': 2 * L,
                           'fused_add_layernorm': 4 * L,
                           'dense_gelu': 2 * L},
              f'launch counts {launches}')
        check(len(step._graphs) == 1, f'{len(step._graphs)} graphs')
        final = _resil_state(net, step)
        blocked_ms = saves[0][1] * 1e3
        restore_s = mgr.last_restore_seconds

        # (b) bitwise resume: a fresh model and an unguarded step, captured
        # first, then restored from step 4 in place, replay steps 8-10
        net_b = _resil_net(cfg, SEED + 5)
        step_b = _resil_step(net_b)
        step_b(*batches[0])
        mgr_b = checkpoint.CheckpointManager(os.path.join(work, 'a'),
                                             params=net_b, trainer=step_b,
                                             keep_last_n=2,
                                             keep_every_k_steps=4)
        ptrs = {n: p.data_ptr() for n, p in net_b.named_parameters()}
        t0 = time.perf_counter()
        check(mgr_b.restore(4) == 4, 'restore(4)')
        restore_b_s = time.perf_counter() - t0
        check({n: p.data_ptr() for n, p in net_b.named_parameters()} == ptrs,
              'the restore replaced a parameter tensor')
        check(mgr_b.last_restored_metadata['rng_restored'] == 'exact',
              'RNG restore')
        losses_b = [float(step_b(*b)) for b in batches[7:]]
        same = _resil_equal(final, _resil_state(net_b, step_b))
        print(f'  (b) restored step 4 into a captured unguarded step '
              f'({restore_b_s:.2f} s), steps 8-10: losses {losses_b} vs '
              f'{losses[7:]}; parameters, masters and moments '
              f'{"byte-equal" if same else "DIFFER"}')
        check(losses_b == losses[7:], f'resumed losses {losses_b} vs '
              f'{losses[7:]}')
        check(same, 'the resumed state differs from the guarded run')

        # (e) the step, guarded against unguarded, and the save's times
        ins, labs = batches[0]
        want = {'flash_fwd_tc_kernel': L, 'flash_bwd_dq_tc_kernel': L,
                'flash_bwd_dkv_tc_kernel': L, 'dense_gelu_tc_kernel': L,
                '_add_ln_fwd': 2 * L}
        per = {}
        for label, s in (('guarded', step), ('unguarded', step_b)):
            # a short trace (a late one can drop events) is taken again
            names = kernel_launches(lambda s=s: s(ins, labs), 3, want)
            total = sum(names.values()) / 3
            kern, copies = ops_split(names, 3)
            mine = {k: sum(c for n, c in names.items() if k in n) / 3
                    for k in want}
            check(mine == want, f'{label} launches per replay {mine}')
            ms = sorted(steps_ms(lambda s=s: s(ins, labs), 10)
                        for _ in range(3))[1]
            per[label] = dict(ms=ms, launches=total, kernels=kern,
                              copies=copies)
        print(f'  (e) on {card}: step {per["guarded"]["ms"]:.3f} ms guarded '
              f'vs {per["unguarded"]["ms"]:.3f} ms unguarded (median of 3 '
              f'calls of 10), {per["guarded"]["launches"]:.0f} vs '
              f'{per["unguarded"]["launches"]:.0f} device operations per '
              f'replay (profiler; kernels {per["guarded"]["kernels"]:.0f} '
              f'vs {per["unguarded"]["kernels"]:.0f}, copies and memsets '
              f'{per["guarded"]["copies"]:.0f} vs '
              f'{per["unguarded"]["copies"]:.0f})')
        # a manager's first save pins its host buffers; later ones reuse
        # them (each save here with the writer idle)
        blocked_b_ms = []
        for k in (11, 12):
            mgr_b.save(k)
            mgr_b.wait()
            blocked_b_ms.append(mgr_b.last_blocked_seconds * 1e3)
        save_s = mgr_b.last_save_seconds
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(mgr_b.step_dir(12)) for f in fs)
        print(f'  (e) on {card}: save of {nbytes / 2 ** 30:.3f} GiB blocks '
              f'the training thread {blocked_ms:.1f} ms at the guarded '
              f'run\'s first save (its host buffers pinned), '
              f'{blocked_b_ms[0]:.1f} ms at a new manager\'s first and '
              f'{blocked_b_ms[1]:.1f} ms at its second (buffers reused); '
              f'{save_s:.2f} s end to end (writer thread); restore '
              f'{restore_s:.2f} s (the rollback), {restore_b_s:.2f} s (into '
              f'the captured step)')
        mgr.close()
        mgr_b.close()
        del step, net, step_b, net_b, final
        torch.cuda.empty_cache()
        _resil_preempt(work, card)
        _resil_watchdog(card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f'  resilience phase: {phase_s:.1f} s')
    return launches, dict(per=per, blocked_ms=blocked_ms,
                          blocked_reused_ms=blocked_b_ms[1], save_s=save_s,
                          restore_s=restore_s, restore_b_s=restore_b_s,
                          phase_s=phase_s)


# ---- the language models: GPT-2 small through ShardedTrainStep (the main
# path of this slice), its parity, and Transformer-base through the
# Trainer. Transformer-base is the base model of Vaswani et al. 2017,
# "Attention Is All You Need": its Table 3 widths and the shared BPE
# vocabulary of about 37000 tokens of its section 5.1.
TRANSFORMER_BASE = dict(hidden=512, enc_layers=6, dec_layers=6, heads=8,
                        ffn_hidden=2048)
TRANSFORMER_VOCAB = 37000
SERVE_TOL = 0.05        # rel Frobenius of bf16 logits against f32 (PERF.md 2)


def gpt_flops(params, cfg, batch, seq):
    """bench.py's accounting (PaLM-style, bench.py:1087-1106) of one GPT
    training step: 6 FLOPs per body parameter per token, plus
    6 * vocab * hidden per token for the tied head (the lookup does no
    matmul work), plus 12 * L * hidden * T per token for attention, not
    halved for causal."""
    P = sum(p.numel() for p in params.values())
    P_embed = sum(p.numel() for n, p in params.items()
                  if n.startswith(('word_embed', 'pos_embed')))
    tokens = batch * seq
    return (6 * (P - P_embed) * tokens
            + 6 * cfg['vocab_size'] * cfg['hidden'] * tokens
            + 12 * cfg['layers'] * cfg['hidden'] * seq * tokens)


def gpt_batch(cfg, batch, seq, seed):
    """Random tokens and their labels: the tokens shifted left, -1 at the
    last position (examples/train_gpt.py)."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, cfg['vocab_size'], (batch, seq))
    labels = onp.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    return toks, labels


def gpt_model(cfg, seq, batch):
    """parity_step's model: GPTModel and gpt_lm_loss on the batch drawn
    from SEED + 5."""
    import torch
    from mxnet_tpu_torch.models import gpt
    toks, labels = gpt_batch(cfg, batch, seq, SEED + 5)
    return (lambda dtype, dev: gpt.GPTModel(**cfg, dropout=0.0, dtype=dtype,
                                            device=dev),
            lambda net, dev: gpt.gpt_lm_loss(
                net(torch.from_numpy(toks).to(dev)),
                torch.from_numpy(labels).to(dev)))


def gpt_parity(cfg, arrays, card, device='cuda', seq=1024, batch=1):
    """One step of GPT-2 small at full width and depth, dropout 0, bf16 on
    the card against f32 on the CPU through the plain versions, held to
    PERF.md section 2's training bounds; the tied embedding's gradient
    (the lookup's and the head's) printed on its own line."""
    import torch
    model = gpt_model(cfg, seq, batch)
    got = parity_step(model, arrays, device, torch.bfloat16)
    want = parity_step(model, arrays, 'cpu', torch.float32)
    held = hold_parity(f'GPT-2 small one step at B={batch} T={seq} '
                       f'(dropout 0), bf16 on the card vs f32 CPU plain',
                       got, want, TRAIN_TOL)
    # in float64: a float32 cosine over the table's 38.6M elements rounds
    # past 1
    g, w = (r[1]['word_embed.weight'].double() for r in (got, want))
    rel = float((g - w).norm() / w.norm())
    cos = float(torch.nn.functional.cosine_similarity(
        g.flatten(), w.flatten(), dim=0))
    print(f'  parity, the tied word_embed gradient (lookup + head): '
          f'rel_fro_err={rel:.4f}, cosine {cos:.5f} (bounds '
          f'{TRAIN_TOL["grad_rel_fro"]}, {TRAIN_TOL["grad_min_cos"]})')
    check(rel <= TRAIN_TOL['grad_rel_fro'] and
          cos >= TRAIN_TOL['grad_min_cos'], 'the tied gradient disagrees')
    return dict(held, word_embed_rel_fro=rel, word_embed_cos=cos)


def _flash_counts():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import attention as attn_ops
    return ({k: v for k, v in mt.ops.launch_counts.items() if v},
            {k: v for k, v in mt.ops.variant_counts.items() if v},
            dict(attn_ops.route_counts))


def gpt_step(card, cfg, arrays, device='cuda', batch=8, seq=1024, warmup=3,
             timed=10):
    """(a) GPT-2 small as examples/train_gpt.py trains it: bf16,
    gpt_lm_loss, ShardedTrainStep with AdamW at lr 3e-4, dropout 0.1 drawn
    on the card, one repeated batch. Returns (launches of the eager step
    and the capture, launches per replay, numbers)."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import gpt
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    L = cfg['layers']
    gen = torch.Generator(device).manual_seed(SEED + 6)
    net = gpt.GPTModel(**cfg, dropout=0.1, dtype=torch.bfloat16,
                       device=device, generator=gen)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    step = parallel.ShardedTrainStep(
        net, gpt.gpt_lm_loss, 'adamw', {'learning_rate': 3e-4},
        **({} if device == 'cuda' else
           {'mesh': parallel.make_mesh(devices=[device])}))
    toks, labels = gpt_batch(cfg, batch, seq, SEED + 7)
    ins = [torch.from_numpy(toks).to(device)]
    labs = [torch.from_numpy(labels).to(device)]

    # the path's run: counters at 0 before call 1 (the eager step and the
    # capture), read after the warm-up
    _zero_counters()
    t0 = time.perf_counter()
    warm = [float(step(ins, labs))]
    first_s = time.perf_counter() - t0
    warm += [float(step(ins, labs)) for _ in range(warmup - 1)]
    launches, variants, routes = _flash_counts()
    print(f'  GPT-2 small warm-up losses {warm} (call 1, eager and capture: '
          f'{first_s:.1f} s); host launches {launches} variants {variants} '
          f'routes {routes}')
    check(routes.get('flash') == 2 * L and not routes.get('plain'),
          f'attention routes {routes}')
    check(launches == {'flash_attn_fwd': 2 * L, 'flash_attn_bwd_dq': 2 * L,
                       'flash_attn_bwd_dkv': 2 * L},
          f'launch counts {launches} for the eager step and the capture')
    check(variants == {'flash_attn_fwd.tc': 2 * L,
                       'flash_attn_bwd_dq.tc': 2 * L,
                       'flash_attn_bwd_dkv.tc': 2 * L},
          f'variant counts {variants}')

    # early traces (a late one drops events): the busy time and idle share
    # of a replay, then each replay's kernels by name
    busy = device_breakdown(f'GPT-2 small captured step b{batch}_s{seq}',
                            lambda: step(ins, labs), card, 3)
    replays = 3
    want = {'flash_fwd_tc_kernel': L, 'flash_bwd_dq_tc_kernel': L,
            'flash_bwd_dkv_tc_kernel': L}
    names = kernel_launches(lambda: step(ins, labs), replays, want)
    per_replay = {k: sum(c for n, c in names.items() if k in n) / replays
                  for k in want}
    simt = {k: sum(c for n, c in names.items() if k in n) / replays
            for k in ('flash_fwd_kernel', 'flash_bwd_dq_kernel',
                      'flash_bwd_dkv_kernel')}
    print(f'  GPT-2 small kernel launches per replay (profiler, {replays} '
          f'replays): {per_replay}; SIMT variants {simt}')
    check(per_replay == want, f'launches per replay {per_replay}, expected '
          f'{want}')
    check(not any(simt.values()), f'SIMT flash kernels ran: {simt}')

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ins, labs) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    # the first warm-up loss comes before any update; a bf16 loss in
    # [2^e, 2^(e+1)) is spaced 2^(e-7) apart
    ulp = 2.0 ** (math.floor(math.log2(abs(warm[0]))) - 7)
    drop = (warm[0] - losses[-1]) / ulp
    print(f'  GPT-2 small timed losses (one repeated batch): {losses}; the '
          f'last is {drop:.0f} bf16 spacings ({ulp}) below the first '
          f'warm-up loss {warm[0]} (before any update)')
    check(all(onp.isfinite(x) for x in warm + losses), 'non-finite loss')
    check(drop >= 8, f'the last loss is {drop:.0f} bf16 spacings below the '
          f'first, expected at least 8')
    # the replays after the timed ones still update: every f32 master moves
    # in each of two
    masters = step._master
    for i in range(2):
        kept = {n: m.clone() for n, m in masters.items()}
        step(ins, labs)
        torch.cuda.synchronize()
        still = [n for n, m in masters.items() if torch.equal(m, kept[n])]
        print(f'  one more replay: {len(masters) - len(still)} of '
              f'{len(masters)} f32 masters moved')
        check(not still, f'masters that did not move in a replay: {still}')
        del kept
    calls = [wall / timed * 1e3] + [
        steps_ms(lambda: step(ins, labs), timed) for _ in range(2)]
    step_ms = sorted(calls)[1]
    flops = gpt_flops(dict(net.named_parameters()), cfg, batch, seq)
    tokens_s = batch * seq / step_ms * 1e3
    mfu = flops / (step_ms / 1e3) / PEAK_BF16
    print(f'  GPT-2 small {timed} captured steps at B={batch} T={seq} on '
          f'{card}: {step_ms:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{c:.3f}" for c in calls)} ms), {tokens_s:.1f} '
          f'tokens/s, {flops / 1e12:.4f} TFLOP per step = 6*P_body*tokens '
          f'+ 6*vocab*hidden*tokens (tied head) + 12*L*hidden*T*tokens '
          f'(attention, not halved for causal), MFU {mfu:.4%} of 989 '
          f'TFLOP/s bf16; peak allocated '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    rows = {'flash_attn_fwd': 'flash_fwd_tc_kernel',
            'flash_attn_bwd_dq': 'flash_bwd_dq_tc_kernel',
            'flash_attn_bwd_dkv': 'flash_bwd_dkv_tc_kernel'}
    del step, net
    torch.cuda.empty_cache()
    return launches, {r: per_replay[k] for r, k in rows.items()}, dict(
        step_ms=step_ms, calls_ms=calls, tokens_s=tokens_s, mfu=mfu,
        flops=flops, losses=warm + losses, busy=busy)


def transformer_base(card, device='cuda', batch=16, src_len=256,
                     tgt_len=200, parity_batch=2, cfg=None,
                     vocab=TRANSFORMER_VOCAB):
    """(c) Transformer-base in bf16: the forward's logits at B = 2 against
    f32 on the CPU through the plain versions (eval mode), then one
    Trainer step (autograd, AdamW) at B = 16 with dropout 0.1, counting
    the flash kernels' launches of its forward and of its backward."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.models.bert import masked_cross_entropy
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    cfg = dict(cfg or TRANSFORMER_BASE)
    gen = torch.Generator(device).manual_seed(SEED + 8)
    net = transformer.TransformerModel(vocab, vocab, **cfg, dropout=0.1,
                                       dtype=torch.bfloat16, device=device,
                                       generator=gen)
    arrays = random_bert_arrays(net, seed=SEED + 9)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    rng = onp.random.RandomState(SEED + 10)

    def batch_of(B):
        src = rng.randint(0, vocab, (B, src_len))
        tgt = rng.randint(0, vocab, (B, tgt_len))
        labels = rng.randint(0, vocab, (B, tgt_len))
        valid = rng.randint(src_len // 2, src_len + 1, (B,))
        mask = onp.arange(src_len)[None, None, None, :] < \
            valid[:, None, None, None]
        return [torch.from_numpy(a) for a in (src, tgt, mask, labels)]

    src, tgt, mask, _ = batch_of(parity_batch)
    with torch.no_grad():
        got = net.eval()(src.to(device), tgt.to(device), mask.to(device))
        ref = transformer.TransformerModel(vocab, vocab, **cfg, dropout=0.0,
                                           device='cpu')
        ref.load_state_dict(params_from_mxnet_tpu(arrays, ref))
        want = ref.eval()(src, tgt, mask)
    rel = float((got.float().cpu() - want).norm() / want.norm())
    print(f'  Transformer-base forward at B={parity_batch} Ts={src_len} '
          f'Tt={tgt_len} (key mask), bf16 on the card vs f32 CPU plain: '
          f'logits rel_fro_err={rel:.4f} (bound {SERVE_TOL})')
    check(rel <= SERVE_TOL, 'Transformer-base logits disagree')
    del ref, want, got

    net.train()
    trainer = gluon.Trainer(net.collect_params(), 'adamw',
                            {'learning_rate': 1e-4, 'wd': 0.01,
                             'multi_precision': True})
    src, tgt, mask, labels = (t.to(device) for t in batch_of(batch))
    L = cfg['enc_layers'] + 2 * cfg['dec_layers']
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counters()
    loss = masked_cross_entropy(net(src, tgt, mask), labels)
    torch.cuda.synchronize()
    fwd = _flash_counts()
    _zero_counters()
    loss.backward()
    torch.cuda.synchronize()
    bwd = _flash_counts()
    trainer.step(1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f'  Transformer-base one Trainer step (AdamW) at B={batch} '
          f'Ts={src_len} Tt={tgt_len}: loss {float(loss.detach()):.5f}, '
          f'{step_s * 1e3:.1f} ms host (first step: kernels and the '
          f'update\'s capture set up); forward launches {fwd[0]} variants '
          f'{fwd[1]} routes {fwd[2]}; backward launches {bwd[0]} variants '
          f'{bwd[1]}')
    check(bool(torch.isfinite(loss)), 'non-finite Transformer loss')
    check(fwd[0] == {'flash_attn_fwd': L} and fwd[2].get('flash') == L and
          fwd[1] == {'flash_attn_fwd.tc': L}, f'forward launches {fwd}')
    check(bwd[0] == {'flash_attn_bwd_dq': L, 'flash_attn_bwd_dkv': L} and
          bwd[1] == {'flash_attn_bwd_dq.tc': L, 'flash_attn_bwd_dkv.tc': L},
          f'backward launches {bwd}')
    launches = {'flash_attn_fwd': L, 'flash_attn_bwd_dq': L,
                'flash_attn_bwd_dkv': L}
    del net, trainer, loss
    torch.cuda.empty_cache()
    return launches, dict(logits_rel_fro=rel, loss_step_ms=step_s * 1e3)


def lm_phase(card, device='cuda', cfg=None, batch=8, seq=1024,
             transformer_kw=None):
    """GPT-2 small's parity (b), its captured step (a) and Transformer-base
    (c); returns (launches of A, K2 and K3 on the path, GPT's launches per
    replay, numbers)."""
    import torch
    from mxnet_tpu_torch.models import gpt

    cfg = dict(cfg or gpt.gpt2_small_config())
    print(f'lm phase on {card}: GPT-2 small {cfg} and Transformer-base')
    # the weights: Normal(0.02) for every weight from a numpy seed, gamma,
    # beta and biases as constructed
    arrays = random_bert_arrays(gpt.GPTModel(**cfg, device='cpu'),
                                seed=SEED + 4)
    parity = gpt_parity(cfg, arrays, card, device, seq=seq, batch=1)
    torch.cuda.empty_cache()
    launches, per_replay, step = gpt_step(card, cfg, arrays, device, batch,
                                          seq)
    t_launches, trans = transformer_base(card, device,
                                         **(transformer_kw or {}))
    total = {k: launches[k] + t_launches[k] for k in launches}
    return total, per_replay, dict(gpt_step=step, gpt_parity=parity,
                                   transformer=trans)


# ---- the rest of the vision zoo on the card
ZOO_NETS = (('alexnet', 224), ('vgg16_bn', 224), ('squeezenet1.1', 224),
            ('mobilenetv2_1.0', 224), ('densenet121', 224),
            ('inceptionv3', 299))


def he_arrays(net, seed):
    """He-normal weights (N(0, 2 / fan_in)) drawn with numpy from ``seed``
    for every convolution and dense weight; BatchNorm's gamma, beta and
    running statistics and every bias as initialised (1, 0, 0, 1, 0), so
    that activations keep their scale through a deep net in predict
    mode."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if name.endswith('weight'):
            fan_in = int(onp.prod(a.shape[1:]))
            a = (rng.standard_normal(a.shape) *
                 onp.sqrt(2.0 / fan_in)).astype(onp.float32)
        arrays[name] = a
    return arrays


def _zoo_net(name, ctx, arrays=None, x=None, classes=1000):
    """``get_model(name)`` on ``ctx``, placed by one predict forward of
    ``x[:1]``, holding ``arrays`` (He-normal from ``SEED`` when None)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    with ctx:
        net = get_model(name, classes=classes)
        net.initialize()
        net(mt.nd.array(x[:1]))
        if arrays is None:
            arrays = he_arrays(net, SEED + 11)
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mt.nd.array(arrays[k]))
    return net, arrays


def prob_nll_loss():
    """-log p[label] as a Gluon Loss, for a net that ends in a softmax."""
    from mxnet_tpu_torch import gluon

    class ProbNLL(gluon.loss.Loss):
        def hybrid_forward(self, F, pred, label):
            return -F.log(F.pick(pred, label, axis=-1) + 1e-12)
    return ProbNLL(None, 0)


def zoo_estimator(card, work, batch=32, batches=8, side=224,
                  name='mobilenetv2_1.0'):
    """(b) Estimator.fit of ``name`` (ending in a softmax) in f32 on the
    card: ``batches`` batches of ``batch`` from gluon.data.DataLoader over
    an ArrayDataset, SGD, the metrics Accuracy, TopKAccuracy(5) and
    CrossEntropy held against numpy over the same predictions, with
    LoggingHandler, CheckpointHandler (resumed into a fresh net byte for
    byte) and WatchdogHandler (one beat a batch)."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    rng = onp.random.RandomState(SEED + 12)
    n = batch * batches
    x = rng.standard_normal((n, 3, side, side)).astype(onp.float32)
    y = rng.randint(0, 1000, n).astype(onp.float32)
    ctx = mt.gpu(0)

    def probs_net(arrays=None):
        body, arrays = _zoo_net(name, ctx, arrays, x)
        with ctx:
            net = gluon.nn.HybridSequential(prefix='')
            net.add(body)
            net.add(gluon.nn.HybridLambda(
                lambda F, z: F.softmax(z, axis=-1)))
        return net, arrays

    net, arrays = probs_net()
    # labels the net can get right: the even images take the class its
    # training-mode forward (as fit runs it) ranks first before any step,
    # the odd ones stay random
    with mt.autograd.record():
        first = onp.concatenate([
            net(mt.nd.array(x[i:i + batch], ctx=ctx)).asnumpy().argmax(1)
            for i in range(0, n, batch)])
    y = onp.where(onp.arange(n) % 2 == 0, first, y).astype(onp.float32)
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.01, 'momentum': 0.9})
    metrics = [mt.metric.Accuracy(), mt.metric.TopKAccuracy(5),
               mt.metric.CrossEntropy()]
    est = est_mod.Estimator(net, prob_nll_loss(), metrics=metrics,
                            trainer=trainer)
    check(est.context == [ctx], f'Estimator context {est.context}')
    seen = []

    class Keep(est_mod.BatchEnd):
        def batch_end(self, estimator, *args, **kwargs):
            seen.append((kwargs['pred'][0].asnumpy(),
                         kwargs['label'][0].asnumpy()))

    ckpt_dir = os.path.join(work, 'estimator')
    ckpt = est_mod.CheckpointHandler(ckpt_dir)
    wd = est_mod.WatchdogHandler(deadline_seconds=300)
    loader = DataLoader(ArrayDataset(x, y), batch_size=batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(loader, epochs=1, event_handlers=[
        est_mod.LoggingHandler(metrics=metrics), ckpt, wd, Keep()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(seen) == batches and wd._step == batches,
          f'{len(seen)} batches seen, {wd._step} watchdog beats')
    p = onp.concatenate([s[0] for s in seen])
    lab = onp.concatenate([s[1] for s in seen]).astype(onp.int64)
    want = {'accuracy': float((p.argmax(1) == lab).sum()) / n,
            'top_k_accuracy_5': float(
                (onp.argsort(-p, axis=1)[:, :5] == lab[:, None])
                .any(1).sum()) / n,
            'cross-entropy': float(
                (-onp.log(p[onp.arange(n), lab] + 1e-12)).sum()) / n}
    got = dict(m.get() for m in metrics)
    print(f'  Estimator.fit {name} f32 B={batch} {side}x{side}, {batches} '
          f'batches, SGD, on {card}: {n / wall:.1f} images/s '
          f'({wall:.2f} s, the first batch\'s set-up included); metrics '
          f'{got}, numpy over the same predictions {want}; watchdog beats '
          f'{wd._step}')
    check(got['accuracy'] == want['accuracy'] and
          got['top_k_accuracy_5'] == want['top_k_accuracy_5'],
          'accuracy metrics disagree with numpy')
    check(abs(got['cross-entropy'] - want['cross-entropy']) <=
          1e-5 * abs(want['cross-entropy']), 'cross-entropy disagrees')

    # resume: a fresh net takes the committed checkpoint byte for byte
    fresh, _ = probs_net(he_arrays(net[0], SEED + 13))
    est2 = est_mod.Estimator(fresh, prob_nll_loss(), metrics=[],
                             trainer=gluon.Trainer(fresh.collect_params(),
                                                   'sgd'))
    h2 = est_mod.CheckpointHandler(ckpt_dir, resume_from_checkpoint=True)
    h2.train_begin(est2)
    h2.manager.close()
    a, b = (dict((k, p_.data()._data) for k, p_ in
                 m._collect_params_with_prefix().items())
            for m in (net, fresh))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    print(f'  checkpoint: committed steps {ckpt.manager.all_steps()}, '
          f'resumed step {h2.resumed_step}, {len(a)} parameters, '
          f'{len(differ)} differ after the resume')
    check(h2.resumed_step == batches and not differ,
          f'resume differs: {differ[:5]}')
    return dict(images_s=n / wall, metrics=got)


def zoo_phase(card, work, device='cuda', batch=8, nets=ZOO_NETS,
              estimator_kw=None):
    """(a) each net's predict forward on the card in f32 against the same
    weights on the CPU through the plain versions, timed; (b)
    zoo_estimator. The path launches none of the hand-written kernels:
    convolutions, pooling and BatchNorm are PyTorch's, as the JAX package
    leaves them to XLA."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt

    print(f'zoo phase on {card}: the vision zoo beyond ResNet, f32')
    _zero_counters()
    out = {}
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    for name, side in nets:
        x = onp.random.RandomState(SEED + 14).standard_normal(
            (batch, 3, side, side)).astype(onp.float32)
        net, arrays = _zoo_net(name, ctx, None, x)
        ref, _ = _zoo_net(name, mt.cpu(), arrays, x)
        xt = torch.from_numpy(x)
        xd = xt.to(device)
        net.eval()
        ref.eval()
        with torch.no_grad():
            got = net(xd).float().cpu()
            want = ref(xt)
            ms, how = time_ms(lambda: net(xd)) if device == 'cuda' \
                else (float('nan'), 'not on a card')
        rel = float((got - want).norm() / want.norm())
        print(f'  zoo {name} B={batch} {side}x{side} f32 on {card}: '
              f'device {ms:.3f} ms per forward ({how}); logits '
              f'rel_fro_err={rel:.2e} against the CPU plain forward (bound '
              f'{SERVE_TOL}), |logits| max {float(want.abs().max()):.3f}')
        check(got.shape == (batch, 1000), f'{name} logits {got.shape}')
        check(rel <= SERVE_TOL, f'{name} disagrees with the CPU forward')
        out[name] = dict(ms=ms, rel_fro=rel)
        del net, ref
        torch.cuda.empty_cache()
    out['estimator'] = zoo_estimator(card, work, **(estimator_kw or {}))
    launches, _, _ = _flash_counts()
    check(not launches, f'the zoo path launched {launches}')
    return out


# ---- sequence models on the card: gluon.rnn and CTC
SEQ_TOL = {'loss_rel': 1e-5, 'grad_rel_fro': 1e-4}   # PERF.md section 2, f32
# MXNet 1.6's example/gluon/word_language_model as its README trains it:
# --emsize 650 --nhid 650 --nlayers 2 --dropout 0.5 --tied, WikiText-2's
# vocabulary, batch 32, bptt 35, SGD at lr 20, gradients clipped at 0.25
LM_CFG = dict(vocab=33278, emsize=650, nhid=650, nlayers=2, dropout=0.5,
              batch=32, bptt=35, lr=20.0, clip=0.25)
# MXNet 1.6's example/ctc (LSTM OCR), hyperparams.py: 2 LSTM layers of
# 100, 80 steps over 80 x 30 images, 4 digits a label, 10 digits and the
# blank, batch 128
CTC_CFG = dict(layers=2, hidden=100, seq_len=80, features=30, label_len=4,
               classes=11, batch=128)


def _uniform_arrays(net, seed, scale=0.1):
    """Every parameter of ``net`` (a tied one once) uniform in
    [-scale, scale] from ``seed``, by structured name."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    drawn, arrays = {}, {}
    for name, p in net._collect_params_with_prefix().items():
        if id(p) not in drawn:
            drawn[id(p)] = rng.uniform(-scale, scale, p.shape).astype(
                onp.float32)
        arrays[name] = drawn[id(p)]
    return arrays


def _place(net, ctx, inputs, arrays, draw):
    """``net`` initialized on ``ctx``, its deferred shapes placed by one
    forward of the numpy ``inputs`` (none: no forward), holding ``arrays``
    by structured name (``draw(net)`` when None). Returns (net, arrays)."""
    import mxnet_tpu_torch as mt
    net.initialize(ctx=ctx)
    if inputs:
        with mt.autograd.pause():
            net(*[mt.nd.array(a, ctx=ctx) for a in inputs])
    if arrays is None:
        arrays = draw(net)
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mt.nd.array(arrays[k], ctx=ctx))
    return net, arrays


def lm_net(ctx, dropout, arrays=None):
    """word_language_model's RNNModel (Embedding, then gluon.rnn.LSTM,
    then a Dense tied to the embedding), composed here as the example
    composes it, the LSTM's (h, c) passed apart; the weights ``arrays``
    (uniform in [-0.1, 0.1] from SEED + 20 when None)."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    c = LM_CFG

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(c['vocab'], c['emsize'])
                self.rnn = rnn.LSTM(c['nhid'], c['nlayers'],
                                    dropout=dropout, input_size=c['emsize'])
                self.decoder = nn.Dense(c['vocab'], in_units=c['nhid'],
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, h, c_):
            emb = self.drop(self.encoder(inputs))
            out, (h, c_) = self.rnn(emb, [h, c_])
            out = self.drop(out)
            return self.decoder(out.reshape((-1, c['nhid']))), h, c_

    hidden = onp.zeros((c['nlayers'], c['batch'], c['nhid']), onp.float32)
    toks = onp.zeros((c['bptt'], c['batch']), onp.float32)
    return _place(RNNModel(), ctx, (toks, hidden, hidden), arrays,
                  lambda n: _uniform_arrays(n, SEED + 20))


def lm_batch(seed):
    """One (bptt, batch) batch of token ids and its next-token targets,
    flattened as the example's ``target.reshape((-1,))``."""
    import numpy as onp
    c = LM_CFG
    rng = onp.random.RandomState(seed)
    stream = rng.randint(0, c['vocab'], (c['bptt'] + 1, c['batch']))
    return (stream[:-1].astype(onp.float32),
            stream[1:].reshape(-1).astype(onp.float32))


def _grads(net, skip=()):
    """{structured name: gradient}, a tied parameter once."""
    seen, out = set(), {}
    for k, p in net._collect_params_with_prefix().items():
        if p.grad_req == 'null' or id(p) in seen or k in skip:
            continue
        seen.add(id(p))
        out[k] = p.grad().asnumpy()
    return out


def _rel(a, b):
    import numpy as onp
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


def hold_f32(label, loss_rel, grads, want_grads, tol=SEQ_TOL, skip=()):
    """A step's loss (its relative error ``loss_rel``) and every gradient
    (rel Frobenius, the worst named) on the card against the CPU's,
    within ``tol``; ``skip`` gradients are left out (counted in the
    line)."""
    rel = {k: _rel(grads[k], want_grads[k]) for k in want_grads
           if k not in skip}
    worst = max(rel, key=rel.get)
    ok = loss_rel <= tol['loss_rel'] and rel[worst] <= tol['grad_rel_fro']
    print(f'  parity, {label}: loss rel {loss_rel:.2e}, {len(rel)} '
          f'gradients, worst rel Frobenius {rel[worst]:.2e} ({worst})' +
          (f', {len(skip)} left out (zero in exact arithmetic)'
           if skip else '') + f'; tolerance {tol} -> '
          f'{"ok" if ok else "FAIL"}')
    check(ok, f'{label} disagrees with the f32 CPU reference')
    return dict(loss_rel=loss_rel, grad_rel_fro=rel[worst])


def lm_parity(card, arrays, toks, target):
    """(a) One forward and backward at dropout 0 on the card against the
    same weights on the CPU; the tied embedding's gradient (the lookup's
    and the decoder's) on its own line."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    c = LM_CFG
    out = []
    for ctx in (mt.gpu(0), mt.cpu()):
        net, _ = lm_net(ctx, 0.0, arrays)
        h = mt.nd.zeros((c['nlayers'], c['batch'], c['nhid']), ctx=ctx)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        with autograd.record():
            o, _, _ = net(mt.nd.array(toks, ctx=ctx), h, h)
            L = loss_fn(o, mt.nd.array(target, ctx=ctx)) / (
                c['bptt'] * c['batch'])
        L.backward()
        out.append((float(L.sum().asnumpy()), _grads(net)))
    (loss, g), (loss_c, g_c) = out
    tied = 'encoder.weight'
    print(f'  LSTM LM loss {loss:.6f} on the card, {loss_c:.6f} on the CPU')
    held = hold_f32(f'LSTM LM (emsize {c["emsize"]}, nhid {c["nhid"]}, '
                    f'{c["nlayers"]} layers, vocab {c["vocab"]}, tied) '
                    f'B={c["batch"]} bptt={c["bptt"]}, dropout 0, f32 '
                    f'card (TF32 off) vs CPU',
                    abs(loss - loss_c) / abs(loss_c), g, g_c)
    rel = _rel(g[tied], g_c[tied])
    print(f'  parity, the tied embedding gradient ({tied}: the lookup\'s '
          f'and the decoder\'s): rel_fro_err={rel:.2e} (bound '
          f'{SEQ_TOL["grad_rel_fro"]})')
    check(rel <= SEQ_TOL['grad_rel_fro'], 'the tied gradient disagrees')
    return dict(held, tied_rel_fro=rel)


def lm_loop(card, arrays, toks, target, timed=10):
    """(a) The example's loop on the hybridized model: gluon.Trainer SGD
    at lr 20, gradients clipped to a global norm of 0.25, the hidden
    state detached between batches, dropout 0.5 drawn on the card; one
    repeated batch."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    c = LM_CFG
    ctx = mt.gpu(0)
    net, _ = lm_net(ctx, c['dropout'], arrays)
    net.hybridize()
    params = list(net.collect_params().values())
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': c['lr'], 'momentum': 0,
                             'wd': 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = mt.nd.array(toks, ctx=ctx), mt.nd.array(target, ctx=ctx)
    shape = (c['nlayers'], c['batch'], c['nhid'])
    hidden = [mt.nd.zeros(shape, ctx=ctx), mt.nd.zeros(shape, ctx=ctx)]
    norms = []

    def step():
        nonlocal hidden
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            out, h, c_ = net(x, *hidden)
            L = loss_fn(out, y) / (c['bptt'] * c['batch'])
        L.backward()
        hidden = [h, c_]
        norms.append(gluon.utils.clip_global_norm(
            [p.grad(ctx) for p in params], c['clip']))
        trainer.step(1)
        return L

    first = float(step().sum().asnumpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(L.sum().asnumpy()) for L in losses]
    calls = [wall / timed * 1e3] + [steps_ms(step, timed) for _ in range(2)]
    step_ms = sorted(calls)[1]
    tokens_s = c['bptt'] * c['batch'] / step_ms * 1e3
    print(f'  LSTM LM losses (one repeated batch, the hidden state carried '
          f'and detached): {first:.4f} before the timed steps, then '
          f'{[round(v, 4) for v in losses]}; global gradient norm before '
          f'clipping {norms[0]:.3f} then {norms[-1]:.3f} (clip '
          f'{c["clip"]})')
    check(all(onp.isfinite([first] + losses)), 'non-finite LM loss')
    check(losses[-1] < first, 'the LM loss did not fall')
    busy = device_breakdown(f'LSTM LM step B={c["batch"]} bptt={c["bptt"]} '
                            f'(hybridized; Trainer SGD, clip)', step, card, 3)
    print(f'  LSTM LM {timed} steps at B={c["batch"]} bptt={c["bptt"]} on '
          f'{card}: {step_ms:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{v:.3f}" for v in calls)} ms), {tokens_s:.1f} '
          f'tokens/s; idle share {busy["idle"]:.3f}')
    return dict(step_ms=step_ms, calls_ms=calls, tokens_s=tokens_s,
                losses=[first] + losses, busy=busy)


def gru_parity(card, hidden=650, T=35, B=32):
    """(b) A bidirectional 2-layer GRU's forward (the output and the final
    state) on the card against the CPU, f32."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import rnn
    rng = onp.random.RandomState(SEED + 21)
    x = rng.randn(T, B, hidden).astype(onp.float32)
    h0 = rng.randn(4, B, hidden).astype(onp.float32)
    arrays, outs = None, []
    for ctx in (mt.cpu(), mt.gpu(0)):
        net, arrays = _place(
            rnn.GRU(hidden, 2, bidirectional=True, input_size=hidden), ctx,
            (), arrays, lambda n: _uniform_arrays(n, SEED + 22))
        o, (h,) = net(mt.nd.array(x, ctx=ctx), [mt.nd.array(h0, ctx=ctx)])
        outs.append((o.asnumpy(), h.asnumpy()))
    (oc, hc), (og, hg) = outs
    rel_o, rel_h = _rel(og, oc), _rel(hg, hc)
    tol = SEQ_TOL['grad_rel_fro']
    print(f'  parity, GRU bidirectional 2 layers hidden {hidden} T={T} '
          f'B={B} forward, f32 card vs CPU: output {og.shape} rel_fro_err='
          f'{rel_o:.2e}, final state rel_fro_err={rel_h:.2e} (bound {tol})')
    check(og.shape == (T, B, 2 * hidden) and hg.shape == (4, B, hidden),
          f'GRU shapes {og.shape} {hg.shape}')
    check(rel_o <= tol and rel_h <= tol, 'the GRU disagrees with the CPU')
    return dict(out_rel_fro=rel_o, state_rel_fro=rel_h)


def ctc_net(ctx, arrays=None):
    """example/ctc's network: LSTM layers over the image's columns, a
    Dense to the 10 digits and the blank at every step."""
    import numpy as onp
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    c = CTC_CFG
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(rnn.LSTM(c['hidden'], c['layers'],
                         input_size=c['features']))
        net.add(nn.Dense(c['classes'], flatten=False, in_units=c['hidden']))
    x = onp.zeros((c['seq_len'], 1, c['features']), onp.float32)
    return _place(net, ctx, (x,), arrays,
                  lambda n: _uniform_arrays(n, SEED + 23))


def ctc_phase_part(card):
    """(c) CTCLoss (TNC, blank last, label 0 among the labels) and its
    gradients on the card against the CPU, then one Trainer step."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    c = CTC_CFG
    rng = onp.random.RandomState(SEED + 24)
    x = rng.rand(c['seq_len'], c['batch'], c['features']).astype(
        onp.float32)
    lab = rng.randint(0, 10, (c['batch'], c['label_len'])).astype(
        onp.float32)
    lab[::3, 0] = 0        # label 0, a digit under 'last', in every third
    arrays, runs = None, []
    loss_fn = gluon.loss.CTCLoss(layout='TNC', label_layout='NT')
    for ctx in (mt.cpu(), mt.gpu(0)):
        net, arrays = ctc_net(ctx, arrays)
        with autograd.record():
            L = loss_fn(net(mt.nd.array(x, ctx=ctx)),
                        mt.nd.array(lab, ctx=ctx))
        L.backward()
        runs.append((L.asnumpy(), _grads(net), net))
    (lc, gc, _), (lg, gg, net) = runs
    loss_rel = _rel(lg, lc)
    held = hold_f32(f'CTC (example/ctc: LSTM {c["layers"]} x '
                    f'{c["hidden"]}, T={c["seq_len"]} over '
                    f'{c["features"]} features, {c["label_len"]} digits, '
                    f'C={c["classes"]}, B={c["batch"]}), CTCLoss TNC blank '
                    f'last, f32 card vs CPU (loss: rel Frobenius of the '
                    f'{c["batch"]} losses)', loss_rel, gg, gc)
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 1e-3})
    before = {k: p.data().asnumpy() for k, p in
              net._collect_params_with_prefix().items()}
    ctx = mt.gpu(0)
    with autograd.record():
        L = loss_fn(net(mt.nd.array(x, ctx=ctx)), mt.nd.array(lab, ctx=ctx))
    L.backward()
    trainer.step(c['batch'])
    after = {k: p.data().asnumpy() for k, p in
             net._collect_params_with_prefix().items()}
    still = [k for k in before if onp.array_equal(before[k], after[k])]
    mean = float(L.asnumpy().mean())
    print(f'  CTC Trainer step (Adam, lr 1e-3) on {card}: mean loss '
          f'{mean:.4f}, {len(before) - len(still)} of {len(before)} '
          f'parameters moved')
    check(onp.isfinite(L.asnumpy()).all(), 'non-finite CTC loss')
    check(not still, f'CTC parameters that did not move: {still}')
    return dict(held, loss_rel_fro=loss_rel, mean_loss=mean)


def seq_phase(card):
    """gluon.rnn and CTC on the card in f32 (TF32 off, as main sets it):
    (a) the LSTM language model, (b) the bidirectional GRU, (c) CTC. The
    path launches none of the hand-written kernels."""
    import mxnet_tpu_torch as mt
    print(f'seq phase on {card}: gluon.rnn (the fused rnn op) and CTC, f32')
    _zero_counters()
    arrays = lm_net(mt.cpu(), 0.0)[1]
    toks, target = lm_batch(SEED + 25)
    out = dict(lm_parity=lm_parity(card, arrays, toks, target))
    out['lm'] = lm_loop(card, arrays, toks, target)
    out['gru'] = gru_parity(card)
    out['ctc'] = ctc_phase_part(card)
    launches, _, _ = _flash_counts()
    check(not launches, f'the seq path launched {launches}')
    return out


# ---- SSD-512 on the card: the multibox ops and ImageDetIter
SSD_CLASSES = 20           # VOC, BASELINE.json's config
SSD_SIZE = 512
SSD_ANCHORS = 24572        # 4*64^2 + 6*(32^2+16^2+8^2+4^2+2^2) + 4*1^2
SSD_TOL = {'loss_rel': 1e-5, 'grad_rel_fro': 1e-4}    # f32 training bounds
SSD_TIE = 1e-4      # choices within f32 rounding (tests/test_torch_model_zoo)


def ssd_batch(rng, batch, size=SSD_SIZE, num_classes=SSD_CLASSES, M=4):
    """examples/train_ssd.py make_batch: noise images, each with one
    bright rectangle; its label is the class and the normalized corner
    box, padded to M = 4 rows with -1. With 20 classes the rectangle is
    drawn in channel class % 3 (the example's channel is the class, for
    its 3 classes)."""
    import numpy as onp
    x = rng.rand(batch, 3, size, size).astype(onp.float32) * 0.1
    label = onp.full((batch, M, 5), -1.0, onp.float32)
    for i in range(batch):
        cls = rng.randint(num_classes)
        w, h = rng.randint(size // 4, size // 2, 2)
        x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
        x[i, cls % 3, y0:y0 + h, x0:x0 + w] += 0.8
        label[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                       (y0 + h) / size]
    return x, label


def ssd_net(ctx, arrays=None):
    """ssd_512(num_classes=20) on ``ctx``, placed by one forward at
    64 x 64 (no parameter's shape depends on the image size), with
    He-normal weights from SEED + 30 (he_arrays) unless ``arrays``."""
    import numpy as onp
    from mxnet_tpu_torch.models import ssd_512
    return _place(ssd_512(num_classes=SSD_CLASSES), ctx,
                  (onp.zeros((1, 3, 64, 64), onp.float32),), arrays,
                  lambda n: he_arrays(n, SEED + 30))


def _bn_fed_biases(net):
    """Structured names of the convolution biases a BatchNorm follows:
    their gradient is zero in exact arithmetic."""
    out = []
    for name, blk in net.named_modules():
        kids = list(getattr(blk, '_children', {}).items())
        for (k, a), (_, b) in zip(kids, kids[1:]):
            if type(a).__name__ == 'Conv2D' and \
                    type(b).__name__ == 'BatchNorm':
                out.append(f'{name}.{k}.bias' if name else f'{k}.bias')
    return tuple(out)


@contextlib.contextmanager
def aligned_units(shift=None, routes=None):
    """The discrete choices of a Gluon forward or a symbol Executor's,
    recorded on the host in call order: every ReLU input (the
    ``activation`` op, act_type 'relu', which the Activation blocks and
    ``sym.Activation`` nodes call) and every 2-D max pooling's argmax per
    window (the ``pooling`` op, 'valid'). ``shift`` maps a ReLU call's index to (flat indices,
    values): those inputs take the values, the move carrying no gradient.
    With ``routes`` (another run's argmax list) each such pooling takes
    its output, and routes its gradient, from those positions; the run's
    own argmax is still recorded. Yields (ReLU inputs, argmaxes, per
    pooling the values where the two argmaxes differ: (routed value, own
    max))."""
    import torch
    import torch.nn.functional as F
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import get_op
    act_def, pool_def = get_op('activation'), get_op('pooling')
    real_act, real_pool = act_def.fn, pool_def.fn
    nd_act, nd_pool = mt.nd.activation, mt.nd.pooling
    relu, pools, ties = [], [], []

    def activation(data, act_type='relu', **kw):
        if act_type == 'relu':
            i = len(relu)
            if shift and i in shift:
                idx, vals = shift[i]
                flat = data.detach().reshape(-1)
                idx = idx.to(flat.device)
                move = torch.zeros_like(flat)
                move[idx] = vals.to(flat) - flat[idx]
                data = data + move.reshape(data.shape)
            relu.append(data.detach().cpu())
        return real_act(data, act_type=act_type, **kw)

    def pooling(data, kernel=None, pool_type='max', global_pool=False,
                stride=None, pad=None, pooling_convention='valid', **kw):
        if pool_type != 'max' or global_pool or data.dim() != 4 or \
                pooling_convention != 'valid':
            return real_pool(data, kernel=kernel, pool_type=pool_type,
                             global_pool=global_pool, stride=stride,
                             pad=pad, pooling_convention=pooling_convention,
                             **kw)
        out, idx = F.max_pool2d(data, kernel, stride, padding=pad or 0,
                                return_indices=True)
        i = len(pools)
        pools.append(idx.cpu())
        if routes is not None:
            r = routes[i].to(data.device)
            flat = data.flatten(2)
            out = flat.gather(2, r.flatten(2)).reshape(out.shape)
            moved = (r != idx).reshape(-1)
            ties.append((out.detach().reshape(-1)[moved].cpu(),
                         flat.detach().gather(2, idx.flatten(2))
                         .reshape(-1)[moved].cpu()))
        return out
    mt.nd.activation, mt.nd.pooling = activation, pooling
    act_def.fn, pool_def.fn = activation, pooling
    try:
        yield relu, pools, ties
    finally:
        mt.nd.activation, mt.nd.pooling = nd_act, nd_pool
        act_def.fn, pool_def.fn = real_act, real_pool


def _relu_flips(got, want):
    """{call: (flat indices, got's inputs)} where the two runs' ReLU
    inputs lie on different sides of 0 (so their derivatives differ)."""
    out = {}
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.reshape(-1), b.reshape(-1)
        idx = ((a > 0) != (b > 0)).nonzero()[:, 0]
        if len(idx):
            out[i] = (idx, a[idx])
    return out


TIE_SHARE = 1e-5    # most of a step's ReLU inputs that may fall on ties


def aligned_rerun(step, card_run, first=None):
    """The CPU's step taking the card's discrete choices.
    ``step(shift, routes)`` runs it under ``aligned_units``: its max
    poolings route through ``card_run``'s argmaxes, and its ReLU inputs
    on the other side of 0 from the card's take the card's values, over
    up to 3 reruns (``first``, when given, is the step's routed first
    run). Returns (the last run, the readings ``tie_faults`` judges)."""
    import torch
    routes = card_run['pools']
    run = step(None, routes) if first is None else first
    shift, rounds = {}, 0
    flips = _relu_flips(card_run['relu'], run['relu'])
    while flips and rounds < 3:
        rounds += 1
        for i, (idx, vals) in flips.items():
            old = shift.get(i)
            shift[i] = (idx, vals) if old is None else (
                torch.cat([old[0], idx]), torch.cat([old[1], vals]))
        run = step(shift, routes)
        flips = _relu_flips(card_run['relu'], run['relu'])
    return run, dict(
        shift=shift, rounds=rounds, left=len(flips),
        units=sum(len(v[0]) for v in shift.values()),
        units_all=sum(a.numel() for a in card_run['relu']),
        worst_in=max((float(v[1].abs().max()) for v in shift.values()),
                     default=0.0),
        windows=sum(len(a) for a, _ in run['ties']),
        windows_all=sum(r.numel() for r in routes),
        worst_tie=max((float((a - b).abs().max()) for a, b in run['ties']
                       if len(a)), default=0.0))


def tie_faults(read, tie):
    """The tie rule on ``aligned_rerun``'s readings: no ReLU input left
    on another side of 0 than on the card, every one taken at the card's
    value within ``tie`` of 0 and at most TIE_SHARE of them, and each
    re-routed max pooling window's two values within ``tie``. Prints the
    readings; returns the rule's failures (none when it holds)."""
    print(f'  choices within rounding: {read["units"]} of '
          f'{read["units_all"]} ReLU inputs on different sides of 0 '
          f'(|input| at most {read["worst_in"]:.2e}; bounds {tie:.2e} and '
          f'{TIE_SHARE:g} of the inputs), taken at the card\'s values in '
          f'{read["rounds"]} rerun(s) of the CPU step; {read["windows"]} of '
          f'{read["windows_all"]} max pooling windows with another argmax '
          f'(the two values at most {read["worst_tie"]:.2e} apart, bound '
          f'{tie:.2e}), routed as on the card')
    return [f for f, bad in (
        (f'ReLU inputs left on different sides of 0 in {read["left"]} '
         f'calls', read['left']),
        (f'a ReLU input {read["worst_in"]:.2e} from 0 taken at the card\'s '
         f'value', read['worst_in'] > tie),
        (f'{read["units"]} ReLU inputs on ties', read['units'] >
         TIE_SHARE * read['units_all']),
        (f'a pooling argmax moved by {read["worst_tie"]:.2e}',
         read['worst_tie'] > tie)) if bad]


def _ssd_step(ctx, arrays, x, label, targets=None, shift=None,
              routes=None):
    """One ssd_train_loss step of ssd_512 on ``ctx`` under
    ``aligned_units(shift, routes)``: its loss, gradients, own multibox
    targets, anchors, class predictions, ReLU inputs, pooling argmaxes
    and ties, and the net; ``targets`` replace its own in the loss."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.models import ssd as tssd
    from mxnet_tpu_torch.ops.detection import multibox_target
    net, arrays = ssd_net(ctx, arrays)
    xs, ls = nd.array(x, ctx=ctx), nd.array(label, ctx=ctx)
    with aligned_units(shift, routes) as (relu, pools, ties), \
            autograd.record():
        anchor, cls_pred, loc_pred = net(xs)
        own = nd._invoke(multibox_target, anchor, ls, cls_pred,
                         negative_mining_ratio=3.0)
        use = own if targets is None else [nd.array(t, ctx=ctx)
                                           for t in targets]
        loss = nd._invoke(tssd._loss_of_targets, cls_pred, loc_pred, *use)
    loss.backward()
    return dict(loss=float(loss.asnumpy()), grads=_grads(net),
                targets=[t.asnumpy() for t in own], anchor=anchor.asnumpy(),
                cls=cls_pred.asnumpy(), relu=relu, pools=pools, ties=ties,
                net=net, arrays=arrays)


def ssd_parity(card, x, label):
    """(a) One training step of ssd_512 at B = 2 on the card against the
    same weights on the CPU: multibox_target's outputs (the CPU fed the
    card's cls_pred), ssd_train_loss and every gradient. cuDNN's and the
    CPU's convolutions round differently, so where the step makes a
    discrete choice between values within f32 rounding of each other the
    two devices can choose differently, and a gradient then differs by a
    whole term: a ReLU input on the other side of 0, or another argmax in
    a max pooling window. The CPU's step takes the card's choices: its
    max poolings route through the card's argmax (each window where its
    own differs must be a tie within 1e-4), and its ReLU inputs on the
    other side of 0 take the card's values (each within 1e-4 of 0, at
    most TIE_SHARE of them), the moves carrying no gradient
    (tests/test_torch_model_zoo.py's rule for ReLU; ``tie_faults``).
    Returns (the readings, the card's net)."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops.detection import multibox_target
    card_run = _ssd_step(mt.gpu(0), None, x, label)
    n_anchor = card_run['anchor'].shape[1]
    print(f'  SSD-512 ({SSD_CLASSES} classes) at {SSD_SIZE}x{SSD_SIZE}: '
          f'{n_anchor} anchors (expected {SSD_ANCHORS})')
    check(n_anchor == SSD_ANCHORS, f'{n_anchor} anchors')
    ref = [t.numpy() for t in multibox_target(
        torch.from_numpy(card_run['anchor']), torch.from_numpy(label),
        torch.from_numpy(card_run['cls']), negative_mining_ratio=3.0)]
    box_t, box_m, cls_t = card_run['targets']
    box_err = float(onp.abs(box_t - ref[0]).max())
    same_cls = bool(onp.array_equal(cls_t, ref[2]))
    same_mask = bool(onp.array_equal(box_m, ref[1]))
    print(f'  multibox_target, card vs CPU fed the card\'s cls_pred: '
          f'cls_target equal {same_cls} ({int((cls_t >= 0).sum())} kept, '
          f'{int((cls_t > 0).sum())} positive), box_mask equal '
          f'{same_mask}, box_target max abs err {box_err:.2e} (bound 1e-5)')
    check(same_cls and same_mask and box_err <= 1e-5,
          'multibox_target disagrees with the CPU')
    arrays, routes = card_run['arrays'], card_run['pools']
    cpu_run = _ssd_step(mt.cpu(), arrays, x, label, routes=routes)
    differ = int((cpu_run['targets'][2] != cls_t).sum())
    print(f'  the CPU\'s targets from its own cls_pred differ from the '
          f'card\'s at {differ} anchors' +
          (': the CPU loss takes the card\'s targets' if differ else ''))
    targets = card_run['targets'] if differ else None
    cpu_run, read = aligned_rerun(
        lambda shift, routes: _ssd_step(mt.cpu(), arrays, x, label, targets,
                                        shift, routes), card_run, cpu_run)
    faults = tie_faults(read, SSD_TIE)
    check(not faults, f'SSD-512 choices beyond rounding: {faults}')
    lg, lc = card_run['loss'], cpu_run['loss']
    print(f'  SSD-512 loss {lg:.6f} on the card, {lc:.6f} on the CPU')
    held = hold_f32(f'SSD-512 one step at B={x.shape[0]} (ssd_train_loss, '
                    f'f32 card, TF32 off, vs CPU)', abs(lg - lc) / abs(lc),
                    card_run['grads'], cpu_run['grads'], SSD_TOL,
                    _bn_fed_biases(card_run['net']))
    return dict(held, anchors=n_anchor, mined_differ=differ,
                box_target_err=box_err, relu_flips=read['units'],
                pool_ties=read['windows']), card_run['net']


def ssd_train_steps(net, batches, trainer):
    """A step function of the example's loop over ``batches`` (cycled):
    autograd.record, ssd_train_loss, backward, Trainer.step(B)."""
    import itertools
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models import ssd_train_loss
    it = itertools.cycle(batches)

    def step():
        x, label = next(it)
        with autograd.record():
            loss = ssd_train_loss(*net(x), label)
        loss.backward()
        trainer.step(x.shape[0])
        return loss
    return step


def ssd_loop(card, net, batch=32, timed=10):
    """(b) examples/train_ssd.py's loop at B = 32: Adam at lr 1e-3 through
    gluon.Trainer, one repeated batch."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import gluon, nd
    ctx = mt.gpu(0)
    x, label = ssd_batch(onp.random.RandomState(SEED + 32), batch)
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 1e-3})
    step = ssd_train_steps(net, [(nd.array(x, ctx=ctx),
                                  nd.array(label, ctx=ctx))], trainer)
    torch.cuda.reset_peak_memory_stats()
    first = float(step().asnumpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v.asnumpy()) for v in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    calls = [wall / timed * 1e3] + [steps_ms(step, timed) for _ in range(2)]
    step_ms = sorted(calls)[1]
    print(f'  SSD-512 losses (one repeated batch of {batch}): {first:.4f} '
          f'before the timed steps, then {[round(v, 4) for v in losses]}')
    check(onp.isfinite([first] + losses).all(), 'non-finite SSD loss')
    check(losses[-1] < first, 'the SSD loss did not fall')
    busy = device_breakdown(f'SSD-512 step B={batch} (Trainer Adam)', step,
                            card, 3)
    print(f'  SSD-512 {timed} steps at B={batch} {SSD_SIZE}x{SSD_SIZE} f32 '
          f'on {card}: {step_ms:.3f} ms per step, the median of 3 calls '
          f'({", ".join(f"{v:.3f}" for v in calls)} ms), '
          f'{batch / step_ms * 1e3:.1f} images/s; idle share '
          f'{busy["idle"]:.3f}; peak allocated {peak:.2f} GiB')
    return dict(step_ms=step_ms, calls_ms=calls,
                images_s=batch / step_ms * 1e3, losses=[first] + losses,
                busy=busy, peak_gib=peak)


def ssd_detect(card, net, batch=8, topk=400):
    """(c) detect's decode and NMS (multibox_detection, nms_topk 400) on
    the card against the port's CPU path fed the same cls_prob and
    loc_pred from the card; timed, with the peak memory it adds."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops.detection import multibox_detection
    x, _ = ssd_batch(onp.random.RandomState(SEED + 33), batch)
    with mt.autograd.predict_mode():
        anchor, cls_pred, loc_pred = net(nd.array(x, ctx=mt.gpu(0)))
    prob = torch.softmax(cls_pred._data, dim=1)
    loc, anc = loc_pred._data, anchor._data
    kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=topk)
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = multibox_detection(prob, loc, anc, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        want = multibox_detection(prob.cpu(), loc.cpu(), anc.cpu(), **kw)
        ms, how = time_ms(lambda: multibox_detection(prob, loc, anc, **kw),
                          iters=3)
    got = got.cpu().numpy()
    want = want.numpy()
    A = anc.shape[1]
    kept = (got[..., 0] >= 0).sum(1)
    same_ids = bool(onp.array_equal(got[..., 0], want[..., 0]))
    err = float(onp.abs(got - want).max())
    square = batch * A * A * 4
    print(f'  detect (multibox_detection, nms_topk {topk}) B={batch} over '
          f'{A} anchors on {card}: kept per image {kept.tolist()}; ids and '
          f'their order equal to the CPU\'s {same_ids}; scores and boxes max '
          f'abs err {err:.2e} (bound 1e-5); device {ms:.3f} ms ({how}), '
          f'host {host_ms:.1f} ms for the first call; peak memory it adds '
          f'{peak / 2 ** 20:.1f} MiB (bound: one image\'s {A}x{A} f32 IoU '
          f'matrix, {square / batch / 2 ** 30:.2f} GiB; the JAX op forms '
          f'{batch}, {square / 2 ** 30:.2f} GiB)')
    check(got.shape == (batch, A, 6), f'detections {got.shape}')
    check(same_ids and err <= 1e-5, 'detect disagrees with the CPU')
    check(((kept > 0) & (kept <= topk)).all(), f'kept {kept.tolist()}')
    check(peak < square / batch, f'detect took {peak} bytes, more than '
          f'one image\'s {A}x{A} IoU matrix')
    return dict(ms=ms, host_ms=host_ms, peak_mib=peak / 2 ** 20,
                kept=kept.tolist(), max_abs_err=err)


def ssd_iter_fed(card, net, work, images=32, batch=8, steps=4):
    """(d) ImageDetIter (rand_crop, rand_pad, rand_mirror) over a .rec of
    512 x 512 JPEGs with box labels, written here with
    recordio.pack_img, feeds SSD steps on the card."""
    import random
    import numpy as onp
    from mxnet_tpu_torch import gluon, image, recordio
    rng = onp.random.RandomState(SEED + 34)
    rec = os.path.join(work, 'det.rec')
    idx = os.path.join(work, 'det.idx')
    w = recordio.MXIndexedRecordIO(idx, rec, 'w')
    for i in range(images):
        img = (rng.rand(SSD_SIZE, SSD_SIZE, 3) * 60).astype(onp.uint8)
        objs = []
        for _ in range(1 + i % 3):
            bw, bh = rng.randint(SSD_SIZE // 8, SSD_SIZE // 2, 2)
            x0 = rng.randint(0, SSD_SIZE - bw)
            y0 = rng.randint(0, SSD_SIZE - bh)
            img[y0:y0 + bh, x0:x0 + bw] += onp.uint8(120)
            objs += [float(rng.randint(SSD_CLASSES)), x0 / SSD_SIZE,
                     y0 / SSD_SIZE, (x0 + bw) / SSD_SIZE,
                     (y0 + bh) / SSD_SIZE]
        w.write_idx(i, recordio.pack_img(
            (0, onp.array([2, 5] + objs, onp.float32), i, 0), img))
    w.close()
    random.seed(SEED + 35)
    it = image.ImageDetIter(batch, (3, SSD_SIZE, SSD_SIZE), path_imgrec=rec,
                            path_imgidx=idx, shuffle=True, rand_crop=0.5,
                            rand_pad=0.5, rand_mirror=True, mean=True,
                            std=True, max_objects=8)
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 1e-3})
    batches, boxes = [], 0
    for _ in range(steps):
        b = it.next()
        lab = b.label[0].asnumpy()
        valid = lab[lab[:, :, 0] >= 0]
        boxes += len(valid)
        check(len(valid) > 0 and (valid[:, 1:5] >= 0).all() and
              (valid[:, 1:5] <= 1).all(), 'a box outside [0, 1]')
        check(b.data[0]._data.is_cuda and b.label[0]._data.is_cuda,
              'ImageDetIter left a batch on the host')
        batches.append((b.data[0], b.label[0]))
    step = ssd_train_steps(net, batches, trainer)
    t0 = time.perf_counter()
    losses = [float(step().asnumpy()) for _ in range(steps)]
    wall = time.perf_counter() - t0
    print(f'  ImageDetIter (rand_crop, rand_pad, rand_mirror, mean/std) '
          f'over {images} JPEGs {SSD_SIZE}x{SSD_SIZE}: {steps} batches of '
          f'{batch} on the card, {boxes} boxes all in [0, 1]; {steps} SSD '
          f'steps fed by them, losses {[round(v, 4) for v in losses]} '
          f'({wall / steps * 1e3:.1f} ms a step)')
    check(onp.isfinite(losses).all(), 'non-finite loss on the fed steps')
    return dict(losses=losses, boxes=boxes)


def det_phase(card, work):
    """SSD-512 VOC (ssd_512(num_classes=20)) on the card in f32: (a) the
    step against the CPU, (b) the example's loop at B = 32, (c) detect,
    (d) ImageDetIter-fed steps. The path launches none of the
    hand-written kernels."""
    import numpy as onp
    import torch
    print(f'det phase on {card}: SSD-512 ({SSD_CLASSES} classes), the '
          f'multibox ops and ImageDetIter, f32')
    _zero_counters()
    x, label = ssd_batch(onp.random.RandomState(SEED + 31), 2)
    parity, net = ssd_parity(card, x, label)
    out = dict(parity=parity)
    out['loop'] = ssd_loop(card, net)
    out['detect'] = ssd_detect(card, net)
    out['iter'] = ssd_iter_fed(card, net, work)
    launches, _, _ = _flash_counts()
    check(not launches, f'the det path launched {launches}')
    del net
    torch.cuda.empty_cache()
    return out


SYM_TOL = {'loss_rel': 1e-5, 'grad_rel_fro': 1e-4, 'aux_rel_fro': 1e-5}
SYM_BERT = dict(hidden=768, heads=12, layers=12, ffn=3072)
SYM_DIR = os.path.join('build', 'chip_smoke_sym')


def resnet50_symbol(sym, num_classes=1000, bn_mom=0.9, eps=2e-5):
    """ResNet-50 v1 from ``mx.sym`` as MXNet 1.6's
    example/image-classification/symbols/resnet.py lays the network out:
    a BatchNorm of the data (fix_gamma), a 7x7/2 convolution, BatchNorm,
    ReLU and a 3x3/2 max pooling, then 3, 4, 6 and 3 bottleneck units of
    64/256, 128/512, 256/1024 and 512/2048 filters (v1: convolution,
    BatchNorm, ReLU; the stride on the unit's first 1x1, a projection
    shortcut on each stage's first unit, the sum then ReLU), global
    average pooling, a 1000-way FullyConnected and SoftmaxOutput.
    BatchNorm eps 2e-5, momentum 0.9, fix_gamma=False but on the data;
    ``bn[0]`` takes BatchNorm's output."""
    def bn(x, name, fix_gamma=False):
        return sym.BatchNorm(x, fix_gamma=fix_gamma, eps=eps,
                             momentum=bn_mom, name=name)[0]

    def conv(x, nf, kernel, stride, pad, name):
        return sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                               pad=pad, no_bias=True, name=name)

    def relu(x, name):
        return sym.Activation(x, act_type='relu', name=name)

    def unit(x, nf, stride, dim_match, name):
        b = relu(bn(conv(x, nf // 4, (1, 1), stride, (0, 0), name + '_conv1'),
                    name + '_bn1'), name + '_relu1')
        b = relu(bn(conv(b, nf // 4, (3, 3), (1, 1), (1, 1), name + '_conv2'),
                    name + '_bn2'), name + '_relu2')
        b = bn(conv(b, nf, (1, 1), (1, 1), (0, 0), name + '_conv3'),
               name + '_bn3')
        short = x if dim_match else bn(
            conv(x, nf, (1, 1), stride, (0, 0), name + '_sc'), name + '_sc_bn')
        return relu(b + short, name + '_relu')

    body = bn(sym.Variable('data'), 'bn_data', fix_gamma=True)
    body = relu(bn(conv(body, 64, (7, 7), (2, 2), (3, 3), 'conv0'), 'bn0'),
                'relu0')
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type='max', name='pool0')
    for i, (n, nf) in enumerate(zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
        for j in range(n):
            body = unit(body, nf, (1, 1) if i == 0 or j else (2, 2), j > 0,
                        f'stage{i + 1}_unit{j + 1}')
    pool = sym.Pooling(body, kernel=(7, 7), global_pool=True, pool_type='avg',
                       name='pool1')
    fc = sym.FullyConnected(sym.Flatten(pool, name='flatten0'),
                            num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(fc, sym.Variable('softmax_label'), name='softmax')


def sym_arrays(net, shapes, seed):
    """He-normal weights (N(0, 2 / fan_in)) for every ``*_weight`` from a
    numpy seed; gammas and moving variances 1, betas, biases and moving
    means 0."""
    import numpy as onp
    args, _, aux = net.infer_shape(**shapes)
    rng = onp.random.RandomState(seed)
    arg_params, aux_params = {}, {}
    for name, shape in zip(net.list_arguments(), args):
        if name in shapes:
            continue
        if name.endswith('_weight'):
            a = rng.standard_normal(shape) * onp.sqrt(
                2.0 / int(onp.prod(shape[1:])))
        elif name.endswith('_gamma'):
            a = onp.ones(shape)
        else:
            a = onp.zeros(shape)
        arg_params[name] = a.astype(onp.float32)
    for name, shape in zip(net.list_auxiliary_states(), aux):
        aux_params[name] = (onp.ones if name.endswith('_var') else
                            onp.zeros)(shape, onp.float32)
    return arg_params, aux_params


def _sym_module(net, ctx, arrays, batch, side, train=True):
    import mxnet_tpu_torch as mt
    mod = mt.module.Module(net, context=ctx)
    mod.bind(data_shapes=[('data', (batch, 3, side, side))],
             label_shapes=[('softmax_label', (batch,))], for_training=train)
    args, aux = arrays
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in args.items()},
                    aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in aux.items()})
    return mod


def _sym_step(net, ctx, arrays, x, label, shift=None, routes=None,
              dtype=None):
    """One Module forward(is_train=True) and backward of ``net`` on
    ``ctx`` under aligned_units (in ``dtype``, float64 for the exact
    reference, when given): every gradient, the new moving statistics,
    the ReLU inputs, the pooling argmaxes and ties."""
    import mxnet_tpu_torch as mt
    mod = _sym_module(net, ctx, arrays, x.shape[0], x.shape[-1])
    e = mod._execs[0]
    if dtype is not None:
        for d in (e.arg_dict, e.aux_dict, e.grad_dict):
            for a in d.values():
                a._data = a._data.to(dtype)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=ctx)],
                            [mt.nd.array(label, ctx=ctx)])
    with aligned_units(shift, routes) as (relu, pools, ties):
        mod.forward(batch, is_train=True)
        mod.backward()
    grads = {n: g._data.double().cpu() for n, g in e.grad_dict.items()
             if g is not None and n not in ('data', 'softmax_label')}
    return dict(grads=grads, aux={n: a._data.double().cpu()
                                  for n, a in e.aux_dict.items()},
                out=e.outputs[0]._data.double().cpu(), relu=relu,
                pools=pools, ties=ties)


def _own_rounding(run32, run64, reads):
    """The CPU f32 step's own rounding at this depth: the largest
    distance of its ReLU inputs from the float64 step's, the inputs that
    either step took at the card's values left out."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(run32['relu'], run64['relu'])):
        d = (a.double() - b.double()).abs().reshape(-1)
        for r in reads:
            if i in r['shift']:
                d[r['shift'][i][0]] = 0.0
        worst = max(worst, float(torch.max(d)))
    return worst


def _sym_verdict(net, arrays, x, label, card_run):
    """The f32 check of one card step of the symbolic ResNet-50 against
    the CPU. The CPU runs the step in f32 and in float64, both taking the
    card's choices on ties (``aligned_rerun``); the tie rule's bound is
    twice the CPU f32 step's own rounding of the ReLU inputs (its
    largest distance from the float64 step): a card as accurate as the
    CPU flips no input farther from 0. A reading (the output, each
    gradient, each new moving statistic) holds within its SYM_TOL bound
    of the CPU f32 step, or within max(bound, twice the CPU f32 step's
    own distance) of the float64 step. Returns (readings, the tie rule's
    failures, the readings' failures)."""
    import torch
    import mxnet_tpu_torch as mt

    def step(dtype):
        return lambda shift, routes: _sym_step(
            net, mt.cpu(), arrays, x, label, shift, routes, dtype)
    cpu32, r32 = aligned_rerun(step(None), card_run)
    cpu64, r64 = aligned_rerun(step(torch.float64), card_run)
    tie = 2 * _own_rounding(cpu32, cpu64, (r32, r64))
    print(f'  the CPU f32 step\'s own rounding of the ReLU inputs (largest '
          f'distance from the float64 step) {tie / 2:.2e}: ties within '
          f'{tie:.2e}')
    tie_failed = []
    for what, r in (('CPU f32', r32), ('CPU float64', r64)):
        print(f'  card vs {what}:')
        tie_failed += [f'{what}: {f}' for f in tie_faults(r, tie)]
    rows = [('output', 'out', None, SYM_TOL['loss_rel'])]
    rows += [(n, 'grads', n, SYM_TOL['grad_rel_fro'])
             for n in cpu32['grads']]
    rows += [(n, 'aux', n, SYM_TOL['aux_rel_fro']) for n in cpu32['aux']]
    worst = {kind: (0.0, '-', 0.0, 0.0, bound)
             for _, kind, _, bound in rows}
    failed, n_over = [], 0
    for name, kind, key, bound in rows:
        def pick(run):
            return run[kind] if key is None else run[kind][key]
        e32 = _rel(pick(card_run), pick(cpu32))
        e64 = _rel(pick(card_run), pick(cpu64))
        c64 = _rel(pick(cpu32), pick(cpu64))
        n_over += e32 > bound
        if e32 >= worst[kind][0]:
            worst[kind] = (e32, name, e64, c64, bound)
        if e32 > bound and e64 > max(bound, 2 * c64):
            failed.append((name, f'{e32:.2e}', f'{e64:.2e}', f'{c64:.2e}'))
    for group, (e32, name, e64, c64, bound) in worst.items():
        print(f'  {group}: worst card vs CPU f32 rel Frobenius {e32:.2e} '
              f'({name}; card vs the float64 step {e64:.2e}, CPU f32 vs '
              f'float64 {c64:.2e}); bound {bound}')
    moved = max(float((cpu32['aux'][n] - torch.from_numpy(
        arrays[1][n]).double()).abs().max()) for n in cpu32['aux'])
    print(f'  {len(rows)} readings (output, {len(cpu32["grads"])} '
          f'gradients, {len(cpu32["aux"])} moving statistics, moved by up '
          f'to {moved:.3e}): past the bound against the CPU f32 step '
          f'{n_over}; of those also past max(bound, twice the CPU f32 '
          f'step\'s own distance) from the float64 step (name, vs f32, vs '
          f'float64, CPU f32 vs float64): {failed or "none"}')
    if moved <= 0:
        failed.append(('moving statistics did not move',))
    return dict(out_rel=worst['out'][0], grad_rel_fro=worst['grads'][0],
                grad_rel_fro_f64=worst['grads'][2],
                aux_rel_fro=worst['aux'][0], tie=tie,
                relu_flips=r32['units'], relu_flips_f64=r64['units'],
                worst_in=max(r32['worst_in'], r64['worst_in']),
                pool_ties=r32['windows'], past_f32=n_over,
                failed=len(failed)), tie_failed, failed


def resnet_sym_parity(card, net, arrays, device='cuda', batch=2, side=224):
    """(a) parity: one Module forward (is_train=True) and backward of the
    symbolic ResNet-50 at B = 2, f32 with TF32 off, on the card against
    the same weights on the CPU at the det phase's f32 bounds (the output
    within rel Frobenius 1e-5, every gradient within 1e-4, the new
    moving statistics within 1e-5), the choices on ties aligned
    (``_sym_verdict``). Through 53 BatchNorms in training mode at B = 2
    an f32 step is ill-conditioned: the CPU's own f32 step lies past
    those bounds from the same step in float64 (PERF.md section 6), so a
    reading also holds where the card is as close to the float64 step
    as the CPU's f32 step is. The control: the same card step with TF32
    on (10-bit mantissas in the convolutions and the FC) must fail that
    check."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    rng = onp.random.RandomState(SEED + 41)
    x = rng.standard_normal((batch, 3, side, side)).astype(onp.float32)
    label = rng.randint(0, 1000, batch).astype(onp.float32)
    card_ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    print(f'  symbolic ResNet-50 v1 Module step at B={batch}, f32, TF32 '
          f'off, card vs CPU:')
    card_run = _sym_step(net, card_ctx, arrays, x, label)
    held, tie_failed, failed = _sym_verdict(net, arrays, x, label, card_run)
    check(not tie_failed and not failed, f'the symbolic ResNet-50 step '
          f'disagrees: {tie_failed + failed}')
    if device != 'cuda':
        return held
    print(f'  control: the same card step with TF32 on, the same check:')
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_run = _sym_step(net, card_ctx, arrays, x, label)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    ctl, ctl_tie, ctl_failed = _sym_verdict(net, arrays, x, label, tf32_run)
    print(f'  control (TF32 on): the tie rule fails {len(ctl_tie)} ways, '
          f'{len(ctl_failed)} readings fail (f32: {len(failed)}) -> '
          f'{"separated" if ctl_failed else "NOT separated"}')
    check(ctl_failed, 'the f32 check passes a TF32 step: it does not '
          'separate a lower-precision step')
    return dict(held, control=ctl, control_tie_faults=len(ctl_tie))


def resnet_sym_fit(card, net, arrays, device='cuda', batch=32, batches=8,
                   side=224):
    """(a) timed: Module.fit over an NDArrayIter of random images (numpy
    seed) at B = 32, SGD momentum 0.9, lr 0.1, wd 1e-4, 8 batches: step ms
    (median and spread, the first batch left out), images/s, a
    cross-entropy that stays finite, every parameter moved; then a
    profiled step's busy time, idle share and breakdown."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    rng = onp.random.RandomState(SEED + 43)
    images = rng.standard_normal((batch * batches, 3, side, side)) \
        .astype(onp.float32)
    labels = rng.randint(0, 1000, batch * batches).astype(onp.float32)
    with ctx:
        it = mt.io.NDArrayIter(images, labels, batch_size=batch)
    mod = mt.module.Module(net, context=ctx)
    marks = []

    def mark(param):
        if device == 'cuda':
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    args, aux = arrays
    marks.append(time.perf_counter())
    metric = mt.metric.CrossEntropy()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9,
                              'wd': 1e-4},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in args.items()},
            aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in aux.items()},
            batch_end_callback=mark)
    steps = [(b - a) * 1e3 for a, b in zip(marks[1:], marks[2:])]
    med = float(onp.median(steps))
    ce = metric.get()[1]
    got, _ = mod.get_params()
    still = [k for k, v in got.items()
             if onp.array_equal(v.asnumpy(), args[k])]
    print(f'  Module.fit, symbolic ResNet-50 v1 at B={batch}, {side}x{side}, '
          f'f32, SGD momentum 0.9 lr 0.1 wd 1e-4, {batches} batches on '
          f'{card}: step {med:.3f} ms median of {len(steps)} (spread '
          f'{min(steps):.3f}-{max(steps):.3f}; first {marks[1] - marks[0]:.3f}'
          f' s), {batch / med * 1e3:.1f} images/s; cross-entropy {ce:.4f}; '
          f'{len(got) - len(still)} of {len(got)} parameters moved')
    check(math.isfinite(ce) and not still, f'fit: ce {ce}, unmoved {still}')
    it.reset()
    batch0 = next(iter(it))

    def step():
        mod.forward_backward(batch0)
        mod.update()
    brk = device_breakdown(f'Module step (symbolic ResNet-50, B={batch})',
                           step, card, 3) if device == 'cuda' else {}
    return mod, images, dict(step_ms=med, step_ms_spread=[min(steps),
                                                           max(steps)],
                             images_per_s=batch / med * 1e3, ce=ce, **brk)


def resnet_sym_roundtrip(card, mod, images, work, device='cuda', batch=32):
    """(a) round trip: save_checkpoint, Module.load and predict bitwise
    the predictions before the save; SymbolBlock.imports of the same
    files within 1e-6 of the Module's inference forward, same classes;
    a Gluon net exported and imported on the card likewise."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    with ctx:
        it = mt.io.NDArrayIter(images[:2 * batch], batch_size=batch)
    before = mod.predict(it).asnumpy()
    prefix = os.path.join(work, 'resnet50_sym')
    mod.save_checkpoint(prefix, 8)
    loaded = mt.module.Module.load(prefix, 8, context=ctx)
    loaded.bind(data_shapes=it.provide_data, for_training=False)
    after = loaded.predict(it).asnumpy()
    bitwise = after.tobytes() == before.tobytes()
    blk = mt.gluon.SymbolBlock.imports(prefix + '-symbol.json',
                                       ['data', 'softmax_label'],
                                       prefix + '-0008.params', ctx=ctx)
    x = mt.nd.array(images[:batch], ctx=ctx)
    got = blk(x, mt.nd.zeros((batch,), ctx=ctx)).asnumpy()
    err = float(onp.abs(got - before[:batch]).max())
    same = bool((got.argmax(1) == before[:batch].argmax(1)).all())
    print(f'  round trip on {card}: Module.load + predict bitwise equal '
          f'{bitwise}; SymbolBlock.imports forward max abs err {err:.2e} '
          f'(bound 1e-6), same classes {same}')
    check(bitwise and err <= 1e-6 and same, 'the round trip changed the '
          'predictions')
    nn = mt.gluon.nn
    with ctx:
        net = nn.HybridSequential(prefix='exp_')
        with net.name_scope():
            net.add(nn.Conv2D(8, kernel_size=3, padding=1, in_channels=3),
                    nn.BatchNorm(in_channels=8), nn.Activation('relu'),
                    nn.MaxPool2D(pool_size=2), nn.Flatten(),
                    nn.Dense(10, in_units=8 * 16 * 16))
        net.initialize(mt.init.Xavier(), ctx=ctx)
        xs = mt.nd.array(images[:4, :, :32, :32], ctx=ctx)
        want = net(xs).asnumpy()
    files = net.export(os.path.join(work, 'exported'), epoch=1)
    imp = mt.gluon.SymbolBlock.imports(files[0], ['data'], files[1], ctx=ctx)
    exp_err = float(onp.abs(imp(xs).asnumpy() - want).max())
    print(f'  export + SymbolBlock.imports of a Conv/BatchNorm/Dense net on '
          f'{card}: max abs err {exp_err:.2e} (bound 1e-6)')
    check(exp_err <= 1e-6, 'export/imports changed the output')
    return dict(bitwise=bitwise, imports_err=err, export_err=exp_err)


def bert_sym_encoder(sym, hidden=768, heads=12, layers=12, ffn=3072):
    """A BERT-base encoder from ``mx.sym``: per layer q, k, v and output
    projections (FullyConnected, flatten=False), multi_head_attention
    under the key mask, residual + LayerNorm, FFN 3072 with GELU,
    residual + LayerNorm."""
    h = sym.Variable('data')
    mask = sym.Variable('mask')
    for i in range(layers):
        p = f'l{i}_'

        def fc(x, n, name):
            return sym.FullyConnected(x, num_hidden=n, flatten=False,
                                      name=p + name)
        att = sym.multi_head_attention(fc(h, hidden, 'q'), fc(h, hidden, 'k'),
                                       fc(h, hidden, 'v'), mask,
                                       num_heads=heads, name=p + 'att')
        h = sym.LayerNorm(h + fc(att, hidden, 'o'), name=p + 'ln1')
        f = sym.Activation(fc(h, ffn, 'ffn1'), act_type='gelu',
                           name=p + 'gelu')
        h = sym.LayerNorm(h + fc(f, hidden, 'ffn2'), name=p + 'ln2')
    return h


def _bert_sym_exec(net, ctx, dtype, batch, seq, arrays):
    import torch
    shapes = dict(data=(batch, seq, SYM_BERT['hidden']),
                  mask=(batch, 1, 1, seq))
    names = net.list_arguments()
    types = {n: dtype for n in names}
    types['mask'] = 'float32'
    reqs = {n: 'null' if n in shapes else 'write' for n in names}
    exe = net.simple_bind(ctx, grad_req=reqs, type_dict=types, **shapes)
    for n, a in arrays.items():
        dst = exe.arg_dict[n]
        dst._data = torch.from_numpy(a).to(dst._data.device, dst._data.dtype)
    return exe


def bert_sym_check(card, device='cuda', batch=8, seq=512):
    """(b1) The 12-layer BERT-base encoder from mx.sym through simple_bind
    on the card in bf16 at B = 8, T = 512, valid_length in [256, 512] (an
    additive key mask: 0 kept, -1e4 padding): one forward(is_train=True)
    launches A 12 times and its backward (a random head gradient) K2 and
    K3 12 times each, counted from 0 around each call (the mask
    (B, 1, 1, T), which the kernels take as a key mask); the output within
    rel Frobenius 0.05 of the same graph in f32 on the CPU, the gradients
    within the bf16 training bounds."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    net = bert_sym_encoder(mt.sym, **SYM_BERT)
    rng = onp.random.RandomState(SEED + 47)
    H = SYM_BERT['hidden']
    shapes = dict(data=(batch, seq, H), mask=(batch, 1, 1, seq))
    args, _, _ = net.infer_shape(**shapes)
    arrays = {}
    for n, s in zip(net.list_arguments(), args):
        if n in shapes:
            continue
        arrays[n] = (rng.standard_normal(s) * 0.02 if n.endswith('_weight')
                     else onp.ones(s) if n.endswith('_gamma')
                     else onp.zeros(s)).astype(onp.float32)
    x = rng.standard_normal(shapes['data']).astype(onp.float32)
    valid = rng.randint(seq // 2, seq + 1, batch)
    mask = onp.where(onp.arange(seq)[None] < valid[:, None], 0.0, -1e4) \
        .astype(onp.float32).reshape(batch, 1, 1, seq)
    head = rng.standard_normal(shapes['data']).astype(onp.float32)
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    dtype = 'bfloat16' if device == 'cuda' else 'float32'
    exe = _bert_sym_exec(net, ctx, dtype, batch, seq, arrays)
    dev = exe.arg_dict['data']._data.device
    tx = torch.from_numpy(x).to(dev, exe.arg_dict['data']._data.dtype)
    tm = torch.from_numpy(mask).to(dev)
    th = torch.from_numpy(head).to(dev, tx.dtype)
    exe.forward(is_train=True, data=tx, mask=tm)      # warm-up, kernels
    exe.backward(out_grads=th)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    sync()
    base = dict(mt.ops.launch_counts)
    t0 = time.perf_counter()
    out = exe.forward(is_train=True, data=tx, mask=tm)[0]
    sync()
    t1 = time.perf_counter()
    fwd = {k: v - base.get(k, 0) for k, v in mt.ops.launch_counts.items()
           if v != base.get(k, 0)}
    base = dict(mt.ops.launch_counts)
    exe.backward(out_grads=th)
    sync()
    t2 = time.perf_counter()
    bwd = {k: v - base.get(k, 0) for k, v in mt.ops.launch_counts.items()
           if v != base.get(k, 0)}
    L = SYM_BERT['layers']
    print(f'  symbolic BERT-base encoder ({L} layers, simple_bind, {dtype}) '
          f'at B={batch} T={seq} on {card}: forward {(t1 - t0) * 1e3:.3f} ms,'
          f' backward {(t2 - t1) * 1e3:.3f} ms (host, synced); launches per '
          f'forward {fwd}, per backward {bwd}')
    if device == 'cuda':
        check(fwd == {'flash_attn_fwd': L} and bwd == {
            'flash_attn_bwd_dq': L, 'flash_attn_bwd_dkv': L},
            f'symbolic encoder launches: forward {fwd}, backward {bwd}')
    got_out = out.asnumpy().astype(onp.float64)
    got_grads = {n: exe.grad_dict[n]._data.float().cpu()
                 for n in arrays}
    ref = _bert_sym_exec(net, mt.cpu(), 'float32', batch, seq, arrays)
    want = ref.forward(is_train=True, data=x, mask=mask)[0].asnumpy()
    ref.backward(out_grads=head)
    want_grads = {n: ref.grad_dict[n]._data for n in arrays}
    out_rel = _rel(got_out, want)
    print(f'  symbolic encoder output, {dtype} on {card} vs f32 on the CPU: '
          f'rel Frobenius {out_rel:.2e} (bound {SERVE_TOL})')
    check(out_rel <= SERVE_TOL, 'the symbolic encoder output disagrees')
    held = _hold_grads(f'symbolic encoder gradients, {dtype} on {card} vs '
                       f'f32 on the CPU', got_grads, want_grads,
                       skip=[n for n in want_grads if n.endswith('_k_bias')])
    return dict(fwd=fwd, bwd=bwd, out_rel=out_rel, **held,
                fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3)


def _hold_grads(label, got, want, tol=TRAIN_TOL, skip=()):
    """The gradients' global rel Frobenius and least cosine against
    ``want`` within the bf16 training bounds (``TRAIN_TOL``); ``skip``
    (zero in exact arithmetic) left out."""
    want = {n: g for n, g in want.items() if n not in skip}
    rel, cos, worst = grad_agreement(got, want)
    ok = rel <= tol['grad_rel_fro'] and cos >= tol['grad_min_cos']
    print(f'  {label}: {len(want)} gradients ({len(skip)} left out: zero '
          f'in exact arithmetic), rel Frobenius {rel:.4f}, '
          f'least cosine {cos:.5f} ({worst}); bounds '
          f'{tol["grad_rel_fro"]} / {tol["grad_min_cos"]} -> '
          f'{"ok" if ok else "FAIL"}')
    check(ok, f'{label} disagree')
    return dict(grad_rel_fro=rel, grad_min_cos=cos)


def naive_attention_stack(mt, layers, hidden, heads):
    """tests/test_subgraph.py's NaiveAttentionBlock written for the port
    (its forward on tensors; the additive key mask -1e30 in x's dtype),
    ``layers`` of them in a HybridBlock that passes valid_len to each."""
    import torch
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class NaiveAttentionBlock(HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.qkv = nn.Dense(3 * hidden, flatten=False,
                                    in_units=hidden)
                self.proj = nn.Dense(hidden, flatten=False, in_units=hidden)

        def forward(self, x, valid_len):
            N, T, C = x.shape
            D = C // heads
            q, k, v = nd.split(self.qkv(x), num_outputs=3, axis=-1)
            q = q.reshape(N, T, heads, D).permute(0, 2, 1, 3)
            k = k.reshape(N, T, heads, D).permute(0, 2, 1, 3)
            v = v.reshape(N, T, heads, D).permute(0, 2, 1, 3)
            scores = nd.batch_dot(q, k, transpose_b=True) / (D ** 0.5)
            keep = (torch.arange(T, device=x.device).reshape(1, 1, 1, T) <
                    valid_len.reshape(-1, 1, 1, 1)).to(x.dtype)
            big = torch.full((1, 1, 1, 1), -1e30, dtype=x.dtype,
                             device=x.device)
            att = nd.softmax(scores + (1.0 - keep) * big, axis=-1)
            out = nd.batch_dot(att, v)
            return self.proj(out.permute(0, 2, 1, 3).reshape(N, T, C))

    class Stack(HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                for _ in range(layers):
                    self.register_child(NaiveAttentionBlock())

        def forward(self, x, valid_len):
            for blk in self._children.values():
                x = blk(x, valid_len)
            return x
    return Stack()


def fused_attention_check(card, device='cuda', batch=8, seq=512):
    """(b2) 12 NaiveAttentionBlocks at BERT-base width (hidden 768, 12
    heads), bf16, the additive mask from valid_length in [256, 512],
    hybridized with backend='fuse_attention' on the card: 12 matches; a
    replayed predict forward launches A 12 times and no softmax kernel;
    a replayed step under autograd.record launches A, K2 and K3 12 times
    each; fused against unfused (hybridize() alone) within the bf16
    bounds, output and gradients; device ms of both."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd
    L, H, heads = SYM_BERT['layers'], SYM_BERT['hidden'], SYM_BERT['heads']
    ctx = mt.gpu(0) if device == 'cuda' else mt.cpu()
    dtype = 'bfloat16' if device == 'cuda' else 'float32'
    rng = onp.random.RandomState(SEED + 53)
    mt.random.seed(SEED + 59)
    with ctx:
        net = naive_attention_stack(mt, L, H, heads)
        net.initialize(mt.init.Normal(0.02), ctx=ctx)
    if dtype == 'bfloat16':
        net.cast('bfloat16')
    x = mt.nd.array(rng.standard_normal((batch, seq, H)), ctx=ctx,
                    dtype=dtype)
    vlen = mt.nd.array(rng.randint(seq // 2, seq + 1, batch), ctx=ctx,
                       dtype='float32')
    head = mt.nd.array(rng.standard_normal((batch, seq, H)), ctx=ctx,
                       dtype=dtype)
    runs = {}
    for backend in (None, 'fuse_attention'):
        net.hybridize(backend=backend)
        out = net(x, vlen)
        xg = mt.nd.array(x.asnumpy(), ctx=ctx, dtype=dtype)
        xg.attach_grad()

        def train():
            with autograd.record():
                y = net(xg, vlen)
            y.backward(head)
        train()
        grads = {k: p.grad()._data.float().cpu() for k, p in
                 net._collect_params_with_prefix().items()}
        grads['x'] = xg.grad._data.float().cpu()
        runs[backend] = dict(out=out.asnumpy(), grads=grads)
        if device == 'cuda':
            runs[backend]['fwd_ms'] = time_ms(lambda: net(x, vlen), 10)[0]
            runs[backend]['train_ms'] = time_ms(train, 5)[0]
            if backend:
                fnames = kernel_launches(lambda: net(x, vlen), 2,
                                         {'flash_fwd': L})
                tnames = kernel_launches(train, 2, {
                    'flash_fwd': L, 'flash_bwd_dq': L, 'flash_bwd_dkv': L})
                runs[backend]['fwd_launches'] = fnames
                runs[backend]['train_launches'] = tnames
    backend = net._subgraph_backend
    matches, traces = backend.stats['matches'], len(backend._programs)
    print(f'  fuse_attention over {L} NaiveAttentionBlocks (hidden {H}, '
          f'{heads} heads, {dtype}, B={batch} T={seq}, additive key mask) '
          f'on {card}: {matches} matches in {traces} traces (predict, '
          f'autograd)')
    check(traces == 2 and matches == L * traces,
          f'fuse_attention matched {matches} in {traces} traces')
    fused, plain = runs['fuse_attention'], runs[None]
    out_rel = _rel(fused['out'], plain['out'])
    print(f'  fused vs unfused output: rel Frobenius {out_rel:.2e} (bound '
          f'{SERVE_TOL})')
    check(out_rel <= SERVE_TOL, 'fused output disagrees')
    held = _hold_grads(f'fused vs unfused gradients ({dtype})',
                       fused['grads'], plain['grads'])
    res = dict(matches_per_trace=matches // traces, out_rel=out_rel, **held)
    if device == 'cuda':
        def count(names, part):
            return sum(c for n, c in names.items() if part in n) // 2
        fl, tl = fused['fwd_launches'], fused['train_launches']
        softmax = [n for n in fl if 'softmax' in n.lower()]
        per = dict(fwd=count(fl, 'flash_fwd'),
                   train_fwd=count(tl, 'flash_fwd'),
                   dq=count(tl, 'flash_bwd_dq'),
                   dkv=count(tl, 'flash_bwd_dkv'))
        print(f'  fused replays: A {per["fwd"]} per predict forward, '
              f'softmax kernels {softmax or "none"}; per step under '
              f'autograd.record A {per["train_fwd"]}, K2 {per["dq"]}, K3 '
              f'{per["dkv"]}; device ms predict forward fused '
              f'{fused["fwd_ms"]:.3f} / unfused {plain["fwd_ms"]:.3f}, '
              f'training step fused {fused["train_ms"]:.3f} / unfused '
              f'{plain["train_ms"]:.3f} ({card})')
        check(per == dict(fwd=L, train_fwd=L, dq=L, dkv=L) and not softmax,
              f'fused launches {per}, softmax {softmax}')
        res.update(per, fwd_ms=fused['fwd_ms'], fwd_ms_unfused=plain[
            'fwd_ms'], train_ms=fused['train_ms'],
            train_ms_unfused=plain['train_ms'])
    return res


def sym_phase(card, device='cuda', side=224, fit_batch=32, fit_batches=8,
              bert_batch=8, seq=512):
    """MXNet's symbolic API on the card: (a) ResNet-50 v1 from mx.sym
    through Module (parity, Module.fit timed, the checkpoint round trip),
    (b) attention at BERT-base width through a symbolic encoder and
    through the fuse_attention backend. The launch counters are set to 0
    just before and read just after; (a) launches none of the
    hand-written kernels, (b) A, K2 and K3. Returns (launches of the
    path, A/K2/K3 launches per symbolic forward and backward, readings)."""
    import shutil
    import torch
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    print(f'sym phase on {card}: Symbol, Executor, Module.fit, '
          f'SymbolBlock/export and fuse_attention')
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), SYM_DIR)
    os.makedirs(work, exist_ok=True)
    _zero_counters()
    try:
        net = resnet50_symbol(mt.sym)
        shapes = dict(data=(2, 3, side, side), softmax_label=(2,))
        arrays = sym_arrays(net, shapes, SEED + 37)
        print(f'  ResNet-50 v1 from mx.sym: {len(net.list_arguments())} '
              f'arguments, {len(net.list_auxiliary_states())} auxiliary '
              f'states, {sum(a.size for a in arrays[0].values())} '
              f'parameters')
        out = dict(parity=resnet_sym_parity(card, net, arrays, device,
                                            side=side))
        mod, images, out['fit'] = resnet_sym_fit(card, net, arrays, device,
                                                 fit_batch, fit_batches,
                                                 side)
        out['roundtrip'] = resnet_sym_roundtrip(card, mod, images, work,
                                                device, fit_batch)
        del mod, images
        launched, _, _ = _flash_counts()
        check(not launched, f'the ResNet-50 Module path launched {launched}')
        if device == 'cuda':
            torch.cuda.empty_cache()
        out['bert'] = bert_sym_check(card, device, bert_batch, seq)
        out['fused'] = fused_attention_check(card, device, bert_batch, seq)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launched = {k: v for k, v in mt.ops.launch_counts.items() if v}
    per_fwd = dict(out['bert']['fwd'])
    per_bwd = dict(out['bert']['bwd'])
    out['seconds'] = time.perf_counter() - t0
    print(f'  sym phase: launches {launched}, {out["seconds"]:.1f} s')
    if device == 'cuda':
        torch.cuda.empty_cache()
    return launched, per_fwd, per_bwd, out


# ---- sparse storage: the RowSparse path, Wide & Deep, nd.sparse, DGL
SPARSE_TOL = {'loss_rel': 1e-5, 'state_rel_fro': 1e-4, 'eager': 1e-5,
              'dot': 1e-5}


def _ctx(device):
    import mxnet_tpu_torch as mt
    return mt.gpu(0) if device == 'cuda' else mt.cpu()


def _wd_net(cfg, ctx, arrays=None, seed=SEED + 41):
    """models.wide_deep.WideDeep at ``cfg`` on ``ctx``, its weights
    Normal(0.01) drawn with numpy from ``seed`` (or ``arrays``), by
    structured name. Returns (net, arrays)."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.wide_deep import WideDeep
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    with ctx:
        net = WideDeep(cfg['vocab'], cfg['dim'], cfg['hidden'])
        net.initialize(mt.init.Zero(), ctx=ctx)
        net(mt.nd.zeros((1, cfg['fields']), ctx=ctx))
    if arrays is None:
        rng = onp.random.default_rng(seed)
        arrays = {n: rng.standard_normal(tuple(p.shape), dtype=onp.float32)
                  * onp.float32(0.01)
                  for n, p in sorted(net.named_parameters())}
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net, arrays


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wd_step(net, exact=False, dense=False):
    """ShardedTrainStep with lazy Adam (lr 0.01) and the example's BCE,
    and a call of it under MXTPU_SPARSE_EXACT=1 (``exact``) or
    MXTPU_SPARSE=0 (``dense``), which the step reads at its first call.
    Returns (step, call)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import ShardedTrainStep
    bce = mt.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    step = ShardedTrainStep(net, lambda o, y: bce(o, y), 'adam',
                            {'learning_rate': 0.01})
    env = dict(MXTPU_SPARSE='0' if dense else '1',
               MXTPU_SPARSE_EXACT='1' if exact else '0')

    def call(x, y):
        with _env(env):
            return step(x, y)
    return step, call


def _wd_batches(cfg, n, seed=SEED + 43):
    """``n`` batches of the example's synthetic CTR data (float32 ids)."""
    from mxnet_tpu_torch.models.wide_deep import synthetic_ctr
    ids, y = synthetic_ctr(cfg['batch'] * n, cfg['fields'], cfg['vocab'],
                           cfg['hot_fraction'], seed=seed)
    b = cfg['batch']
    return [(ids[i * b:(i + 1) * b], y[i * b:(i + 1) * b]) for i in range(n)]


def _state_rel(a, b):
    import torch
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) /
                 torch.linalg.norm(b).clamp_min(1e-30))


def sparse_dedup_checks(card, device='cuda'):
    """(a) unique_rows, dedup_take and merge_row_blocks on the card equal
    the CPU's exactly, on a batch where row vocab - 1 is live and the
    budget keeps sentinel slots, and on the example's batch; the table
    gradient of dedup_take is bitwise equal across 3 runs and 3
    permutations of the ids."""
    import numpy as onp
    import torch
    from mxnet_tpu_torch.ops import rowsparse as rs
    cfg = _wd_example()
    cases = {'sentinel': (onp.array([49, 3, 49, 3, 49, 0, 49, 0, 3, 3]), 50,
                          10),
             'example': (_wd_batches(cfg, 1)[0][0].astype(onp.int64).ravel(),
                         cfg['vocab'], cfg['batch'] * cfg['fields'])}
    for label, (ids, vocab, budget) in cases.items():
        outs = {}
        for dev in ('cpu', device):
            t = torch.from_numpy(ids).to(dev)
            uids, inv, n_live = rs.unique_rows(t, budget, vocab)
            rng = onp.random.RandomState(SEED + 45)
            w = torch.from_numpy(rng.standard_normal((vocab, 16)).astype(
                onp.float32)).to(dev).requires_grad_()
            out = rs.dedup_take(w, t)
            (out * out).sum().backward()
            vals = torch.from_numpy(rng.standard_normal(
                (2 * budget, 16)).astype(onp.float32)).to(dev)
            mu, mv, mn = rs.merge_row_blocks(torch.cat([uids, uids]), vals,
                                             vocab)
            outs[dev] = [x.detach().cpu() for x in
                         (uids, inv, n_live, out, w.grad, mu, mv, mn)]
        same = all(torch.equal(a, b) for a, b in zip(outs['cpu'],
                                                     outs[device]))
        n = int(outs[device][2])
        print(f'  dedup {label}: {ids.size} ids, vocab {vocab}, budget '
              f'{budget}, {n} live; unique_rows, dedup_take (forward and '
              f'table gradient) and merge_row_blocks on the card '
              f'{"equal" if same else "DIFFER from"} the CPU\'s bitwise')
        check(same, f'dedup {label}: card and CPU differ')
        if label == 'sentinel':
            u = outs[device][0].tolist()
            check(n == 3 and u[:3] == [0, 3, 49] and u[3:] == [vocab] * 7,
                  f'sentinel uids {u}')
    ids = cases['example'][0]
    vocab = cfg['vocab']
    rng = onp.random.RandomState(SEED + 46)
    w0 = torch.from_numpy(rng.standard_normal((vocab, 16)).astype(
        onp.float32)).to(device)
    grads = []
    for perm in range(3):
        order = onp.random.RandomState(perm).permutation(ids.size)
        for _ in range(3 if perm == 0 else 1):
            w = w0.clone().requires_grad_()
            out = rs.dedup_take(w, torch.from_numpy(ids[order]).to(device))
            (out * out).sum().backward()
            grads.append(w.grad)
    same = all(torch.equal(grads[0], g) for g in grads[1:])
    print(f'  table gradient of dedup_take over {ids.size} ids: 3 runs and '
          f'3 permutations {"bitwise equal" if same else "DIFFER"}')
    check(same, 'the dedup gradient is not bitwise reproducible')


def _wd_example():
    from mxnet_tpu_torch.models.wide_deep import example_config
    return example_config()


def sparse_parity(card, device='cuda', cfg=None, steps=2):
    """(b) At the example's defaults: the lazy-Adam ShardedTrainStep on
    the card against the same step on the CPU (call 1 eager and captured,
    call 2 replayed): loss rel 1e-5, every parameter and moment rel
    Frobenius 1e-4, the untouched rows' moments exactly 0; then exact mode
    against dense (MXTPU_SPARSE=0) over 3 steps on the card, bitwise."""
    import torch
    import mxnet_tpu_torch as mt
    cfg = cfg or _wd_example()
    batches = _wd_batches(cfg, steps)
    runs = {}
    for dev, ctx in (('cpu', mt.cpu()), (device, _ctx(device))):
        net, arrays = _wd_net(cfg, ctx)
        step, call = _wd_step(net)
        losses = [float(call(torch.from_numpy(x).to(dev),
                             torch.from_numpy(y).to(dev)))
                  for x, y in batches]
        runs[dev] = (net, step, losses)
    (cnet, cstep, closs), (gnet, gstep, gloss) = runs['cpu'], runs[device]
    check(gstep._sparse_names == ['deep.weight', 'wide.weight'],
          f'sparse tables {gstep._sparse_names}')
    check(device == 'cpu' or len(gstep._graphs) == 1,
          'the sparse step was not captured')
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gloss, closs))
    worst = 0.0
    cp = dict(cnet.named_parameters())
    for n, p in gnet.named_parameters():
        worst = max(worst, _state_rel(p, cp[n]))
        for a, b in zip(gstep._state[n], cstep._state[n]):
            worst = max(worst, _state_rel(a, b))
    touched = torch.unique(torch.cat([
        torch.from_numpy(x).long().reshape(-1) for x, _ in batches]))
    frozen = torch.ones(cfg['vocab'], dtype=torch.bool)
    frozen[touched] = False
    zero = all(bool((s.detach().cpu()[frozen] == 0).all())
               for n in gstep._sparse_names for s in gstep._state[n])
    print(f'  Wide & Deep at the example\'s defaults (vocab {cfg["vocab"]}, '
          f'{cfg["fields"]} fields, dim {cfg["dim"]}, hidden '
          f'{cfg["hidden"]}, B={cfg["batch"]}), lazy Adam, {steps} steps '
          f'(eager + capture, then replays) on the card against the CPU: '
          f'loss rel {loss_rel:.2e} (bound {SPARSE_TOL["loss_rel"]}), '
          f'worst parameter/moment rel Frobenius {worst:.2e} (bound '
          f'{SPARSE_TOL["state_rel_fro"]}); moments of the '
          f'{int(frozen.sum())} untouched rows exactly 0: {zero}')
    check(loss_rel <= SPARSE_TOL['loss_rel'], 'sparse step loss vs CPU')
    check(worst <= SPARSE_TOL['state_rel_fro'], 'sparse step state vs CPU')
    check(zero, 'an untouched row has a nonzero moment under lazy')
    # exact against dense, bitwise, on the card
    ctx = _ctx(device)
    b3 = _wd_batches(cfg, 3, seed=SEED + 44)
    res = {}
    for mode in ('exact', 'dense'):
        net, _ = _wd_net(cfg, ctx)
        step, call = _wd_step(net, exact=mode == 'exact',
                              dense=mode == 'dense')
        losses = [call(torch.from_numpy(x).to(device),
                       torch.from_numpy(y).to(device)) for x, y in b3]
        res[mode] = ([float(v) for v in losses],
                     {n: p.detach().clone() for n, p in
                      net.named_parameters()}, step)
    check(res['exact'][2]._sparse_names and
          not res['dense'][2]._sparse_names, 'exact/dense routes')
    same = res['exact'][0] == res['dense'][0] and all(
        torch.equal(res['exact'][1][n], res['dense'][1][n])
        for n in res['dense'][1])
    print(f'  exact mode against dense (MXTPU_SPARSE=0), 3 captured steps '
          f'on the card: losses {res["exact"][0]} vs {res["dense"][0]}; '
          f'parameters {"bitwise equal" if same else "DIFFER"}')
    check(same, 'exact sparse and dense steps differ')
    return dict(loss_rel=loss_rel, state_rel=worst)


def _no_sync_replays(call, n=3):
    """``n`` calls under torch.cuda.set_sync_debug_mode('error'): a call
    that synchronizes the host with the card raises."""
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(n):
            call()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def sparse_loop(card, cfg, label, modes=('lazy',), steps=20, timed=10,
                device='cuda', cycle=4):
    """(c)/(d) The example's loop: ``steps`` captured steps over
    ``cycle`` batches repeated; the mean loss of the last cycle must be
    below the first's. For each mode in ``modes`` (lazy, exact, dense):
    3 replays under the sync check, a profiler trace of 3 replays (busy
    time, idle share), step ms (median and spread of 3 calls of
    ``timed``), the peak memory of the build and the steps, and
    sparse_report()."""
    import torch
    import mxnet_tpu_torch as mt
    ctx = _ctx(device)
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(
        device)) for x, y in _wd_batches(cfg, cycle)]
    out = {}
    arrays = None
    for mode in modes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        net, arrays = _wd_net(cfg, ctx, arrays)
        step, call = _wd_step(net, exact=mode == 'exact',
                              dense=mode == 'dense')
        losses = [float(call(*batches[i % cycle])) for i in range(steps)]
        check((mode == 'dense') != bool(step._sparse_names),
              f'{label} {mode}: tables {step._sparse_names}')
        check(len(step._graphs) == 1, f'{label} {mode}: not one graph')
        first = sum(losses[:cycle]) / cycle
        last = sum(losses[-cycle:]) / cycle
        check(all(map(math.isfinite, losses)) and last < first,
              f'{label} {mode}: the loss did not fall ({first} -> {last})')
        k = [0]

        def one():
            x, y = batches[k[0] % cycle]
            k[0] += 1
            return call(x, y)
        _no_sync_replays(one)
        busy = device_breakdown(f'{label} {mode} step', one, card, 3)
        calls = [steps_ms(one, timed) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated() - base
        rep = step.sparse_report()
        print(f'  {label} {mode}: losses {first:.4f} -> {last:.4f} (means of '
              f'the first and last {cycle} of {steps} captured steps); '
              f'3 replays without a host sync; step {sorted(calls)[1]:.3f} '
              f'ms, the median of 3 calls of {timed} '
              f'({", ".join(f"{v:.3f}" for v in calls)}), idle share '
              f'{busy["idle"]:.3f}; peak memory {peak / 2**30:.3f} GiB '
              f'above the start; ' + (
                  f'update {rep["update_bytes_per_step"]} B/step against '
                  f'dense {rep["dense_update_bytes_per_step"]} '
                  f'({rep["update_shrink"]:.1f}x shrink), budgets '
                  f'{ {n: t["budget"] for n, t in rep["tables"].items()} }'
                  if rep else 'dense path'))
        if mode == 'lazy':
            _frozen_rows(step, batches, cfg)
        out[mode] = dict(step_ms=sorted(calls)[1], calls_ms=calls,
                         idle=busy['idle'], busy_ms=busy['busy_ms'],
                         peak_bytes=peak, report=rep,
                         losses=[first, last])
        # the step, its graph and the tables go before the next mode
        del net, step, call, one
        gc.collect()
    return out


def _frozen_rows(step, batches, cfg, samples=4096):
    """Sampled untouched rows keep zero moments; every touched row of the
    deep table moved its first moment."""
    import numpy as onp
    import torch
    touched = torch.unique(torch.cat([x.long().reshape(-1)
                                      for x, _ in batches]))
    free = onp.setdiff1d(onp.random.RandomState(SEED + 47).randint(
        0, cfg['vocab'], samples), touched.cpu().numpy())
    at = torch.from_numpy(free).to(touched.device)
    m, v = step._state['deep.weight']
    zero = bool((m.index_select(0, at) == 0).all()) and \
        bool((v.index_select(0, at) == 0).all())
    moved = bool((m.index_select(0, touched).abs().sum(1) > 0).all())
    print(f'  lazy: {free.size} sampled untouched rows keep zero moments: '
          f'{zero}; all {touched.numel()} touched rows moved: {moved}')
    check(zero and moved, 'lazy row freezing')


def sparse_eager(card, device='cuda', steps=3):
    """(e) gluon.Trainer with SGD (momentum 0.9, lazy) and with Adam over
    Embedding(sparse_grad=True) + Dense, 3 steps on the card against the
    CPU at 1e-5; p.grad() a RowSparseNDArray on the card; absent rows
    unchanged bitwise."""
    import numpy as onp
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ndarray import sparse as sp
    vocab, dim = 1000, 16
    rng = onp.random.RandomState(SEED + 48)
    w0 = {'0.weight': (rng.standard_normal((vocab, dim)) * 0.1)
          .astype(onp.float32),
          '1.weight': (rng.standard_normal((4, dim)) * 0.1)
          .astype(onp.float32),
          '1.bias': onp.zeros(4, onp.float32)}
    ids = rng.randint(0, 100, (32, 5)).astype(onp.float32)
    lab = rng.standard_normal((32, 5, 4)).astype(onp.float32)
    out = {}
    for opt, kw in (('sgd', {'learning_rate': 0.1, 'momentum': 0.9}),
                    ('adam', {'learning_rate': 0.01})):
        res = {}
        for dev, ctx in (('cpu', mt.cpu()), (device, _ctx(device))):
            with ctx:
                net = mt.gluon.nn.HybridSequential()
                net.add(mt.gluon.nn.Embedding(vocab, dim, sparse_grad=True))
                net.add(mt.gluon.nn.Dense(4, flatten=False, in_units=dim))
                net.initialize()
                for n, p in net.named_parameters():
                    p.data.copy_(mt.nd.array(w0[n])._data)
                tr = mt.gluon.Trainer(net.collect_params(), opt, dict(kw))
                x, y = mt.nd.array(ids), mt.nd.array(lab)
                for _ in range(steps):
                    with mt.autograd.record():
                        loss = ((net(x) - y) ** 2).mean()
                    loss.backward()
                    g = net[0].weight.grad()
                    tr.step(1)
                res[dev] = ({n: p.detach().cpu().numpy()
                             for n, p in net.named_parameters()}, g)
        (cw, _), (gw, g) = res['cpu'], res[device]
        check(isinstance(g, sp.RowSparseNDArray) and
              g._data.device.type == device, f'{opt}: grad() {type(g)}')
        worst = max(float(onp.abs(gw[n] - cw[n]).max() /
                          max(onp.abs(cw[n]).max(), 1e-30)) for n in cw)
        absent = onp.setdiff1d(onp.arange(vocab), ids.astype(int))
        frozen = onp.array_equal(gw['0.weight'][absent],
                                 w0['0.weight'][absent])
        print(f'  eager Trainer {opt} ({kw}) over Embedding(sparse_grad='
              f'True) + Dense, {steps} steps: grad() a RowSparseNDArray on '
              f'{g._data.device}; worst rel error against the CPU '
              f'{worst:.2e} (bound {SPARSE_TOL["eager"]}); the '
              f'{absent.size} absent rows unchanged bitwise: {frozen}')
        check(worst <= SPARSE_TOL['eager'], f'eager {opt} vs CPU')
        check(frozen, f'eager {opt}: absent rows moved')
        out[opt] = worst
    return out


def sparse_nd_checks(card, work, device='cuda'):
    """(f) nd.sparse on the card: dot(csr, dense) against the dense
    product, retain and tostype round trips, nd.save / nd.load of
    row_sparse and csr bitwise, SparseEmbedding trains one step; (g) the
    DGL ops on card-resident inputs equal the CPU's."""
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import get_op
    from mxnet_tpu_torch.gluon.contrib.nn import SparseEmbedding
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.ops import sparse_ops
    ctx = _ctx(device)
    rng = onp.random.RandomState(SEED + 49)
    a = rng.standard_normal((512, 1024)).astype(onp.float32)
    a[rng.rand(*a.shape) > 0.01] = 0
    b = rng.standard_normal((1024, 256)).astype(onp.float32)
    csr = sp.csr_matrix(a, ctx=ctx)
    rhs = mt.nd.array(b, ctx=ctx)
    before = sparse_ops.route_counts['dot_csr_dense']
    got = mt.nd.dot(csr, rhs)
    want = mt.nd.dot(mt.nd.array(a, ctx=ctx), rhs)
    check(sparse_ops.route_counts['dot_csr_dense'] == before + 1,
          'dot(csr, dense) did not take the CSR route')
    err = float((got._data - want._data).abs().max())
    rel = err / float(want._data.abs().max())
    dense = torch.from_numpy(a).to(device)
    ms, _ = time_ms(lambda: mt.nd.dot(csr, rhs), 10)
    dms, _ = time_ms(lambda: torch.matmul(dense, rhs._data), 10)
    print(f'  dot(csr 512x1024 at density {csr.density:.4f}, dense '
          f'1024x256) on {got._data.device}: max rel error {rel:.2e} '
          f'against the dense product (bound {SPARSE_TOL["dot"]}); '
          f'{ms:.4f} ms device (CSR route, the conversion included) vs '
          f'{dms:.4f} ms dense matmul')
    check(rel <= SPARSE_TOL['dot'], 'dot(csr, dense)')
    r = sp.row_sparse_array(a, ctx=ctx)
    kept = r.retain(mt.nd.array([0, 7, 300], ctx=ctx))
    ka = kept.asnumpy()
    ok = onp.array_equal(ka[[0, 7, 300]], a[[0, 7, 300]]) and \
        not ka[onp.setdiff1d(onp.arange(512), [0, 7, 300])].any()
    for st in ('csr', 'row_sparse', 'default'):
        ok = ok and onp.array_equal(r.tostype(st).asnumpy(), a) and \
            r.tostype(st).stype == st
    ok = ok and r.indices.asnumpy().tolist() == \
        onp.nonzero(a.any(axis=1))[0].tolist()
    print(f'  retain, tostype and the row_sparse parts on the card: {ok}')
    check(ok, 'retain / tostype round trips')
    f = os.path.join(work, 'sparse.nd')
    mt.nd.save(f, {'r': r, 'c': csr})
    back = mt.nd.load(f, ctx=ctx)
    same = all(onp.array_equal(back[k].asnumpy(), a) for k in ('r', 'c'))
    print(f'  nd.save / nd.load of row_sparse and csr ({os.path.getsize(f)} '
          f'bytes): bitwise {same}')
    check(same, 'nd.save / nd.load of sparse arrays')
    emb = SparseEmbedding(1000, 8)
    emb.initialize(ctx=ctx)
    w0 = emb.weight.data().asnumpy()
    tr = mt.gluon.Trainer(emb.collect_params(), 'sgd',
                          {'learning_rate': 0.5})
    with mt.autograd.record():
        loss = (emb(mt.nd.array([3, 9, 9], ctx=ctx)) ** 2).sum()
    loss.backward()
    tr.step(1)
    w1 = emb.weight.data().asnumpy()
    moved = sorted(onp.nonzero((w1 != w0).any(axis=1))[0].tolist())
    print(f'  SparseEmbedding one SGD step on the card: rows moved {moved}')
    check(moved == [3, 9], 'SparseEmbedding step')
    # (g) DGL ops
    x = onp.asarray([[1, 0, 0], [0, 2, 0], [0, 0, 3]], onp.float32)
    u, v = onp.asarray([0, 0, 1, 1, 2, 2]), onp.asarray([0, 1, 1, 2, 0, 2])
    g = onp.asarray([[0, 1, 2], [3, 0, 4], [5, 6, 0]], onp.float32)
    clique = onp.zeros((5, 5), onp.float32)
    clique[~onp.eye(5, dtype=bool)] = onp.arange(1, 21)
    cases = [('edge_id', (x, u, v), {}), ('dgl_adjacency', (x,), {}),
             ('dgl_subgraph', (g, onp.asarray([0, 2])),
              {'return_mapping': True}),
             ('dgl_graph_compact', (clique,),
              {'graph_sizes': (3,), 'return_mapping': True}),
             ('dgl_csr_neighbor_uniform_sample',
              (clique, onp.asarray([0, 1, 2, 3, 4])),
              {'num_hops': 2, 'num_neighbor': 2, 'max_num_vertices': 5}),
             ('dgl_csr_neighbor_non_uniform_sample',
              (clique, onp.asarray([1., 1., 0., 0., 0.], onp.float32),
               onp.asarray([0, 1, 2, 3, 4])),
              {'num_hops': 1, 'num_neighbor': 1, 'max_num_vertices': 5})]
    for name, args, kw in cases:
        outs = {}
        for dev in ('cpu', device):
            mt.random.seed(SEED)       # the samplers' seed stream
            res = get_op(name).fn(*[torch.from_numpy(onp.asarray(t)).to(dev)
                                    for t in args], **kw)
            outs[dev] = res if isinstance(res, tuple) else (res,)
        same = all(t.device.type == device for t in outs[device]) and all(
            torch.equal(a_.cpu(), b_) for a_, b_ in zip(outs[device],
                                                        outs['cpu']))
        print(f'  {name} on card-resident inputs equal to the CPU: {same}')
        check(same, f'{name} on the card')


def sparse_phase(card, device='cuda', example=None, criteo=None,
                 loop_steps=20, timed=10):
    """MXNet's sparse storage on the card (f32, TF32 off as main sets
    it): (a) the dedup, (b) the step's parity at the example's defaults,
    (c) the example's loop, (d) the Criteo-sized table lazy / exact /
    dense, (e) the eager Trainer, (f) nd.sparse, (g) the DGL ops. The
    launch counters are set to 0 just before and read just after: the
    path launches none of the hand-written kernels."""
    import torch
    from mxnet_tpu_torch.models.wide_deep import criteo_config
    t0 = time.perf_counter()
    example = example or _wd_example()
    criteo = criteo or criteo_config()
    print(f'sparse phase on {card}: the RowSparse step, Wide & Deep, the '
          f'eager lazy updates, nd.sparse and the DGL ops, f32')
    _zero_counters()
    out = {}
    sparse_dedup_checks(card, device)
    out['parity'] = sparse_parity(card, device, example)
    out['example'] = sparse_loop(card, example, 'Wide & Deep example',
                                 ('lazy',), loop_steps, timed, device)
    out['criteo'] = sparse_loop(card, criteo, 'Wide & Deep Criteo-sized '
                                f'(vocab {criteo["vocab"]}, '
                                f'{criteo["fields"]} fields, '
                                f'B={criteo["batch"]})',
                                ('lazy', 'exact', 'dense'), 8, timed, device)
    out['eager'] = sparse_eager(card, device)
    with tempfile.TemporaryDirectory() as work:
        sparse_nd_checks(card, work, device)
    launched, _, _ = _flash_counts()
    check(not launched, f'the sparse path launched {launched}')
    out['seconds'] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f'  sparse phase: {out["seconds"]:.1f} s; '
          f'{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated '
          f'after it')
    return out


SYM_ROWS = ('flash_attn_fwd', 'flash_attn_bwd_dq', 'flash_attn_bwd_dkv')
TILED = {'flash_attn_fwd': 'fwd', 'flash_attn_bwd_dq': 'bwd',
         'flash_attn_bwd_dkv': 'bwd'}


def _tile_fields(name, sweep):
    """The tile each path of a tiled kernel's row runs at, and the
    sweep's per-tile times at the compiled step's shape (the backward's
    cover the dq and dk/dv kernels together)."""
    kind = TILED[name]
    return dict(default='64x64', autotuned='x'.join(
        map(str, sweep['winner'][kind][1:])),
        sweep_ms={f'{b[1]}x{b[2]}': r.get('median_ms')
                  for b, r in sweep[kind].items()})


def _build_entries(root):
    """Every file and directory under the checkout's build/."""
    out = set()
    for dirpath, _dirs, files in os.walk(os.path.join(root, 'build')):
        out.add(dirpath)
        out.update(os.path.join(dirpath, n) for n in files)
    return out


def _remove_new_build_entries(root, before):
    """Remove what this run created under build/ (the kernels and the
    native io library it built, the tile database, the dp phase's files,
    the sym phase's checkpoint and exported files),
    so that a later process in the checkout starts as it would have
    without this run; what was there before stays."""
    import shutil
    for path in sorted(_build_entries(root) - before, key=len,
                       reverse=True):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the card',
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    before = _build_entries(root)
    try:
        return _run()
    finally:
        _remove_new_build_entries(root, before)


def _run():
    import torch
    from mxnet_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # an eager run and a capture must pick the same algorithms
    torch.backends.cudnn.benchmark = False

    card = card_line()
    print(f'card: {card} ({torch.cuda.get_device_name(0)}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda})')
    t0 = time.perf_counter()
    _build.build_all()
    print(f'build: nvcc of {len(_build.SOURCES)} sources in '
          f'{time.perf_counter() - t0:.1f} s')
    report = _build.ptxas_report()
    print('ptxas: ' + ' | '.join(report))
    tc = [e for e in report if '_tc_kernel' in e]
    print('ptxas, tensor-core kernels: ' + (' | '.join(tc) or
                                            'not rebuilt in this process'))
    # the default tile at D = 64; autotune_phase prunes and names any other
    # tile that spills
    for name in [f'{k}<{e}Li64ELi64ELi64E>' for e in ('13__nv_bfloat16',
                                                      '6__half')
                 for k in ('flash_fwd_tc_kernel', 'flash_bwd_dq_tc_kernel',
                           'flash_bwd_dkv_tc_kernel')] + [
            f'dense_gelu_tc_kernel<{e}>' for e in ('13__nv_bfloat16',
                                                   '6__half')]:
        line = next((e for e in tc if name in e), None)
        check(not tc or (line is not None and
                         ' 0 bytes spill stores, 0 bytes spill loads' in line),
              f'{name} spills or is missing: {line}')

    rows = kernel_phase(card)
    # early in the process: the lm phase's traces are read in full there
    lm, lm_replay, _lm = lm_phase(card)
    with tempfile.TemporaryDirectory() as work:
        _zoo = zoo_phase(card, work)
    _seq = seq_phase(card)
    with tempfile.TemporaryDirectory() as work:
        _det = det_phase(card, work)
    sym, sym_fwd, sym_bwd, _sym = sym_phase(card)
    _sparse = sparse_phase(card)
    serving, serve_replay, _serving = serving_phase(card)
    front, front_http, _front = front_phase(card)
    training, _train = training_phase(card)
    amp_launches, amp_dtypes, _amp = amp_phase(card)
    user, nd_ops, user_rows, _nd = ndarray_phase(card)
    gluon, _gluon = gluon_phase(card)
    io, _io = io_phase(card)
    # last: the traces taken after its graph replays are the least sure
    compiled, per_replay, _compiled = compiled_step_phase(card)
    tune_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'build', 'autotune')
    import shutil
    shutil.rmtree(tune_dir, ignore_errors=True)
    tuned_sweep = autotune_phase(card, tune_dir)
    remat, tuned, _remat = remat_phase(card, tune_dir)
    dp, dp_errs, _dp, zero3 = dp_phase(card)
    resil, _resil = resilience_phase(card)
    # launches: the serving, front, training, compiled-step and ndarray
    # runs', each counted from 0 just before its run (serving's and the
    # front's are their warmups' eager runs and captures, the compiled
    # step's its eager first step and its capture; each replay relaunches
    # them from the graph, the per-dispatch and per-replay counts from the
    # profiler's trace)
    # the AMP runs' float16 launches go to the [float16] rows where a
    # kernel has one, the rest of theirs to the kernel's own row
    paths = ('serving', 'front', 'training', 'amp', 'compiled_step',
             'ndarray', 'gluon', 'io', 'dp', 'remat', 'autotune', 'zero3',
             'resilience', 'lm', 'sym')
    by_path = {}
    for name in rows:
        base, f16 = name.split('[')[0], name.endswith('[float16]')
        n16 = amp_dtypes.get(f'{base}.float16', 0) \
            if f'{base}[float16]' in rows else 0
        by_path[name] = dict.fromkeys(paths, 0)
        if f16:
            by_path[name]['amp'] = n16
            continue
        by_path[name].update(
            serving=serving[name], front=front[name],
            training=training[name], amp=amp_launches[name] - n16,
            compiled_step=compiled[name], ndarray=nd_ops[name],
            gluon=gluon.get(name, 0), io=io.get(name, 0),
            dp=dp.get(name, 0),
            remat=remat.get(name, 0), autotune=tuned.get(name, 0),
            zero3=zero3.get(name, 0), resilience=resil.get(name, 0),
            lm=lm.get(name, 0), sym=sym.get(name, 0))
    for name in user_rows:
        by_path[name] = dict(dict.fromkeys(paths, 0), ndarray=user[name])
    idle = [n for n, paths_n in by_path.items()
            if not sum(paths_n.values())]
    check(not idle, f'kernels no main path launched: {idle}')
    kernels = [dict(name=name, route=r['route'], variant=r['variant'],
                    **({'dtype': r['dtype']} if 'dtype' in r else {}),
                    source=r['source'], replaces=r['replaces'],
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=r['max_abs_err'], ms=r['ms'],
                    old_ms=r['old_ms'], plain_ms=r['plain_ms'],
                    bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'],
                    **({'via': r['via']} if 'via' in r else {}),
                    **({'dropout_ms': r['dropout_ms']}
                       if 'dropout_ms' in r else {}),
                    **({'dp_max_abs_err': dp_errs[name]}
                       if name in dp_errs else {}),
                    **({'launches_per_replay': per_replay[name]}
                       if name in per_replay else {}),
                    **({'launches_per_lm_replay': lm_replay[name]}
                       if name in lm_replay else {}),
                    **({'lm_shapes': r['lm_shapes']}
                       if 'lm_shapes' in r else {}),
                    **({'launches_per_sym_forward': sym_fwd.get(name, 0),
                        'launches_per_sym_backward': sym_bwd.get(name, 0)}
                       if name in SYM_ROWS else {}),
                    **({'launches_per_serving_dispatch': serve_replay[name]}
                       if name in serve_replay else {}),
                    **({'launches_per_http_dispatch': front_http[name]}
                       if name in front_http else {}),
                    **({'tiles': _tile_fields(name, tuned_sweep)}
                       if name in TILED else {}))
               for name, r in {**rows, **user_rows}.items()]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def _rank_args(argv):
    def arg(k):
        return argv[argv.index(k) + 1]
    return (int(arg('--dp-rank')), int(arg('--dp-world')), arg('--dp-dir'),
            arg('--dp-backend'))


if __name__ == '__main__':
    if '--resilience-child' in sys.argv:
        import torch
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.exit(resilience_child(
            sys.argv[sys.argv.index('--resilience-child') + 1]))
    if '--dp-rank' in sys.argv:
        import torch
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.exit(dp_rank_main(*_rank_args(sys.argv)))
    sys.exit(main())
