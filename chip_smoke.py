#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``bigdl_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (built kernels land in
``bigdl_tpu_torch/_build/``) and nothing outside the repository. It
imports neither ``jax`` nor the JAX package. Phases, one JSON line each;
any failure raises, so the exit code is non-zero and no result prints:

1. env      — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions; TF32 is switched off for f32 matmuls and
              convolutions, so every f32 reference is full f32;
2. build    — every kernel of ``bigdl_tpu_torch/csrc/`` with one ``nvcc``
              per source, all started together; registers and spills from
              ``ptxas -v``, and the count of ``HGMMA`` (wgmma) instructions
              in the SASS (``cuobjdump -sass``) of each wgmma kernel
              (conv3x3's, the flash forward, dq and dk/dv, the fused-conv
              forward, dgrad and wgrad), which must be above zero; a ptxas
              line reporting wgmma serialized in dq, dk/dv or a fused-conv
              kernel fails the build;
2a. data_plane — the native host runtime (``bigdl_tpu_torch/native``):
              ``g++ --version`` and the library's build seconds; the
              committed JPEG fixtures (``tests/data/jpeg``) decoded to the
              SHA-256 the CPU test recorded (PIL's arrays), PNGs of every
              color type written here (rows filtered 0-4) decoded to their
              pixels; decode rate at 1 and 4 threads; ``recs_index`` ms over
              a 512-record RECS shard; four Hadoop SequenceFiles of the
              same records converted to RECS, the records byte-equal;
3. kernels  — each kernel against its plain PyTorch version on the card at
              its main path's shapes: decode attention at the serving shape
              (N=16 rows, H=12 heads, L=512, D=64) with per-row positions
              that include 0 and L-1, plus a ragged L, and at the other
              row counts the main path launches it at (serve_autopilot's 4
              int8 slots; make_decode_step's bf16 and f32 caches at 1, 4
              and 8 rows, whose split counts differ), timed with the mean,
              median and min-max of its repetitions beside SDPA's; the
              flash forward, dq and dk/dv kernels at the training shape
              (B=8, T=2048, H=12, D=64, bf16, causal), non-causal at a
              ragged T=300, Tq != Tk,
              and strict causal (causal_offset=-1): each output row's error
              relative to that row's largest plain value against the
              stated tolerance, kernel, plain and library times, and the
              least time the card could take; at the training shape the
              delta the dq kernel writes for dk/dv against the plain
              delta;
4. kernels  — (kv_requant) the int8 cache's grow-only requantize kernel
              against its plain version, bitwise, at the decode step's
              shape (16 rows, 512 positions, 12 heads, D 64) with no scale
              grown, every scale grown, and a mix (zero-scale, inactive,
              grown and not-grown rows); its time per case beside the
              plain unconditional requantize, the whole merge step and
              the earlier host-read step, and the bound;
4a. kernels — (w8a16) the weight-only int8 projection kernel against its
              plain version at the 137m LM's fc1 (768 x 3072), fc2 (3072 x
              768) and head (768 x 32768), at M = 1, 4, 8, 16 (decode) and
              2048 (a 16 x 128 prefill), called as the bf16 serving
              projection calls it (bf16 x, output and bias), at
              ResNet-50's weight-only head (M 256, K 2048, N 1000, f32 x,
              output and bias), at a ragged M 37 / 5, K 203, N 91 (f32
              x and output with and without an f32 bias, and bf16), at
              the regime boundary (M 16 and 17 at fc1, bf16 and f32) and
              at decode plans that split K over 1, 2 and 8 blocks of a
              cluster (picked through ``launch_plan``): each output row's
              error relative to that row's largest plain value within
              ``W8A16_ROW_RTOL``, and a second call bitwise the first;
              the wrapper's median host time per call beside the bf16
              ``F.linear``'s at fc1 M 16; kernel times
              (mean, median, min-max) beside the plain version, the
              two-call ``F.linear(x, weight_q.to(bf16))``, the bf16 model's
              ``F.linear`` on a pre-cast bf16 weight (the library column,
              not the same function) and the bound (bytes at decode,
              operations at prefill);
5. check    — a small model's int8-KV decode step on the card against the
              same step on the CPU, teacher-forced, f32;
6. train_check — a small LM's three ``make_train_step`` steps (f32,
              ``use_flash="always"``, SGD) on the card against the same
              steps on the CPU: losses and parameters;
7. serve    — the serving path at full width: the 137m TransformerLM
              (vocab 32768, hidden 768, 12 layers, 12 heads, max_len 512,
              random weights from seed 0) served bf16 with int8 KV by
              ``ServingEngine(n_slots=16)``: 24 requests, prompts of 16-256
              tokens, 32 new tokens each, greedy and seeded-sampled rows;
              then the device launches, device-to-host copies and host
              waits per decode step (``torch.profiler`` over 8 steps of a
              full pool): one copy and one wait, the step's readback;
8. serve_modes — the admission and scheduling modes of ``ServingEngine`` on
              the same model (bf16, int8 KV, 16 slots), each run held to:
              every request at its length, ids in 1..V, finite log-probs
              <= 0, and decode-attention launches = decode steps x 12:
              ``per_request`` on the serve phase's 24 requests; ``prefix``
              (prefix cache on 24 chat requests, one shared 192-token
              head with 16-64-token tails: every request after the first
              round must hit);
              ``chunked`` (budget 64 on the serve requests: no step may
              spend more, its decode-gap p99 beside the serve phase's);
              ``priority`` (16 priority-0 requests of 64 new tokens fill
              the slots, 8 priority-1 ones arrive after 4 steps: 8
              preemptions, every stash restored bitwise); ``faults``
              (a seeded ``FaultInjector``, up to 8 faults, 8 retries: all
              finish at length, faults and retries happen);
9. serve_async — the serve phase's engine and requests at
              ``dispatch_ahead`` W in 0, 1, 2, 4: every W's token and
              log-prob streams byte-identical to W = 0's; tok/s, decode
              step p50, the share of the wall spent waiting on readbacks,
              host step p50;
10. serve_spec — speculative serving of the same target (k=3) on
              ``serving_bench``'s mixed speculative trace (16 requests, 24
              new tokens; half greedy speculative, a quarter
              ``draft_tokens=0``, a quarter seeded sampled) with a
              weight-tied draft (accept rate above 0, tokens per step
              above 1) and, shorter, an independently seeded 2-layer draft;
              then fp32 greedy rows held to the plain engine's (a row may
              differ only from a near-tie, top-two gap below 1e-3, on);
11. serve_lora — multi-tenant LoRA and constrained decoding on the same
              model (bf16, int8 KV, 16 slots) with ``AdapterBank(rank=16,
              n_slots=4)`` and three tenants (``random_factors`` seeds
              50-52, amp 0.05) on ``serving_bench``'s multitenant trace (24
              requests, 32 new tokens; adapter ids round-robin over 0-3,
              every fourth request forced through a 3-token
              ``fixed_sequence``, odd ones seeded-sampled): a bank-less
              oracle, then base-only (ids and constraints stripped) and
              mixed passes; null-adapter rows bitwise the oracle's, forced
              rows verbatim, adapted rows leave the oracle's stream, one
              decode input layout, references released; tok/s, step p50,
              TTFT p50/p99 and the multitenant overhead; launches, copies
              and waits per decode step for the bank-less, base-only and
              mixed engines;
12. serve_disagg — the disaggregated plane, the host KV tier and pool
              health on the same model (bf16, int8 KV) with the serve
              phase's 24 requests: ``DisaggregatedEngine(prefill_slots=16,
              decode_slots=16, decode_pools=2)`` bitwise against
              ``ServingEngine(n_slots=16)``; ``kill_pool(0)`` after 3 steps
              at 8 decode slots (migrated rows bitwise, replayed rows
              counted); ``serving_bench``'s two-wave tiered trace through a
              ``TieredKVStore`` and through a tier of one row's budget; a
              bf16 and an int8 row packed, unpacked and restored bitwise;
              launches, copies and waits per decode step, handoff and
              restore;
13. serve_autopilot — the SLO autopilot on the same model (bf16, int8
              KV, 4 slots, chunked admission, priority policy,
              ``SteppingClock(0.002)``): ``tools/torch_serving_zoo.py``'s
              seeded zoo trace (seed 43, 49 requests) through four static
              passes and the closed loop; per pass the goodput, misses by
              class, actuations by actuator, wall seconds, tok/s and step
              p50; the closed loop's goodput above every static pass's,
              its high-priority misses not above the best static's, one
              decode input layout; rows clean in the closed and reference
              passes with equal chunk boundaries identical, others parted
              only within the measured error, which stays within a stated
              limit (as on 8 clean rows); the host µs of one
              ``sample()``; launches, copies and waits per decode step
              without and with an autopilot;
14. generate — the LM's own decoder on the same model at f32 (TF32 off)
              and bf16: ``generate`` on the serve phase's first 8 prompts
              (32 tokens, greedy and seeded-sampled) against
              ``ServingEngine(n_slots=8)`` with float KV, equal, or at
              bf16 parted at a near-tie within the measured error (greedy)
              or where both sampler rows lie near the f32 model's
              (sampled), the error within a stated limit (counted);
              ``beam_generate`` (beam 4, 64-token prompt, 32 tokens) with
              sorted scores and the top score re-scored by the f32 model;
              ``make_decode_step``'s step p50 and tok/s at batch 1 and 4;
14a. int8_infer — ``benchmarks/int8_bench.py`` on the card: ResNet-50
              (depth 50, shortcut B, 1,000 classes) inference at batch 256,
              224², fp32 (TF32 off), bf16, ``quantize("dynamic")`` and
              ``quantize("weight_only")``: images/s, weight bytes, peak
              memory, argmax agreement with fp32; then ``accuracy_delta``:
              a CIFAR ResNet-8 (shortcut A) trained 200 iterations on the
              card (SGD 0.1 / 0.9 / 5e-4, ``Step(150, 0.2)``, the synthetic
              CIFAR set of seed 5, noise 180), Top-1 through ``Evaluator``
              float against dynamic and weight-only int8, each int8 Top-1
              within ``INT8_TOP1_DROP`` (0.01) of float; and the ResNet-50
              (two images) and a ResNet-8 under both schemes quantized on
              the card and on the CPU from the same weights: codes
              bitwise, each dynamic layer's int32 accumulators bitwise on
              the same activation codes, each weight-only layer within
              ``WO_CONV_CARD_RTOL`` of the CPU's with cuDNN's TF32 allowed
              (the layer's own switch holds it off);
14b. int8_decode — ``benchmarks/decode_bench.py`` for ``137m`` (max_len
              384, 128-token prompt, 256 greedy tokens) through
              ``make_prefill_step`` and ``make_decode_step`` at batch 1
              and 8, fp32, bf16 and int8 weight-only + bf16: tok/s, step
              p50, prefill ms, w8a16 launches 25 per step and per prefill,
              decode attention 12 per step; then ``ServingEngine(kv_dtype=
              "int8")`` over the weight-only 137m (bf16, 16 slots) on the
              serve phase's 24 requests: tok/s, decode step p50 and
              launches per decode step (w8a16 25, decode attention and
              kv_requant 12); then a small weight-only LM's int8-KV
              decode step on the card against the CPU, teacher-forced;
15. train    — the training path at full width: the same 137m model at
              max_len = T = 2048, ``output="logits"``, trained through
              ``Optimizer(...).optimize()`` with
              ``MaskedSoftmaxCECriterion(0)``, ``Adam(1e-4)``, bf16 compute,
              batch 8, 2 warm + 5 timed steps on one seeded batch: step ms
              p50, tokens/s, MFU, peak memory, first and last loss;
15a. lm_knobs — the same recipe through ``make_train_step``: three f32
              steps from one seed of ``remat``, ``layer_scan``, both, and
              ``embed_grad_matmul`` against the unrolled run (parameters
              within 1e-5 or the spread of two unrolled runs, the first
              step's gradients per leaf within 1e-5 of the leaf's largest,
              losses 1e-5 relative); then bf16 compute on one batch repeated (2 warm
              + 3 timed steps) for the plain run, ``remat``, ``layer_scan``,
              bf16 Adam slots and bf16 parameters without and with
              stochastic rounding (the difference of their p50s its cost):
              step p50, peak memory, optimizer-state bytes, flash launches
              (12 per step of each kernel, the forward twice under remat);
              remat's peak below the plain run's, the bf16 slots half the
              f32 slots' bytes, the bf16-parameter loss falling;
15b. lm_main — ``models.transformer.train_main`` at that width through
              argv (``--synthetic 64 --maxIteration 6 --computeDtype
              bf16``), plain and ``--remat``: step p50, peak, losses;
15c. seq_parallel — on a one-rank NCCL group (``Engine.mesh(("seq",))``)
              the LM with ``sequence_parallel`` ring, striped_ring and
              ulysses, three bf16 steps bitwise the LM without it (same
              seed and batches): losses, parameters, step p50, flash
              launches per step;
15d. ring_replay — the ring's 4-rank schedule on one card at the LM's
              attention shape (B 8, T 2048, 512 per rank, 12 heads, D 64,
              bf16): contiguous causal, striped causal and non-causal,
              each rank's blocks (``ring_step_spec``), each held against
              the plain version on its inputs, merged by ``merge_block``
              against ``flash_attention_with_lse`` over the whole
              sequence, and the summed block grads against
              ``flash_attention_block_grads`` over it and against the
              plain block grads summed in the ring's order, every row
              within ``ROW_RTOL`` (``RING_REPLAY_TOL``); the block
              variants (offset 0, offset -1, non-causal at Tq = Tk = 512)
              against the plain version: kernel, plain and masked-SDPA
              times, bound, row errors;
15e. parallel_ext — on a one-rank NCCL group: ``moe_layer`` (d 768, 8
              experts, top-2, capacity factor 1.25, 16,384 tokens,
              ``mlp_expert`` at 3072) against a dense per-expert loop in
              f32 and its time; ``gpipe`` over one stage and ``tp_mlp``
              over one rank, bitwise their plain functions;
16. fused_conv — the fused BN → ReLU → 1×1-conv forward, dgrad and wgrad
              kernels against their plain versions: the stage-1 block join
              (M 802,816, C 256, K 64, residual, y and extra dy, bf16), the
              stage-4 bn2 edge (M 12,544, C 512, K 2048, bf16) and an f32
              case with ragged M, C and K; per-row errors and channel-sum
              errors against the stated tolerances, kernel, plain, bare
              cuBLAS product and unfused-torch times, and the bound; then
              the forward with an f32 z from bf16 rows (JAX's
              ``out_dtype``, ``fwd_kernel<bf16, float>``) at the stage-1
              join against its plain version, timed beside the default
              bf16-z kernel;
17. fused_shapes — the three fused-conv kernels at each of the 10 (M, C,
              K) that ResNet-50's step launches them at (batch 256, bf16):
              each against its plain version, each kernel's median and
              min-max time beside its bound, the cuBLAS product and the
              unfused sequence, and per kernel the step's sum of launches x
              (time - bound);
18. resnet_check — a bottleneck graph's three f32 SGD steps (every edge
              on the kernels) on the card against the CPU: losses,
              parameters and BN running statistics;
19. resnet_train — ResNet-50 at batch 256, 224², bf16 compute, SGD 0.1 /
              momentum 0.9 / weight decay 1e-4, ``maybe_fuse`` with
              ``BIGDL_PALLAS_MIN_C=128``, through ``optimize()``, 2 warm + 5
              timed steps: step ms p50, images/s, peak memory, losses; then
              the unfused ``Graph`` on the same recipe;
20. resnet_main — ResNet's own main at full width: ``train_main
              --dataset imagenet`` (ResNet-50 B on 512 synthetic 224²
              images, batch 128, 8 iterations, bf16, nesterov SGD) with
              ``--summary`` and ``--cache``: finite, falling losses, 8
              ``Loss``, ``Throughput`` and ``LearningRate`` scalars read
              back, the checkpoint's ``Module.load`` equal to the trained
              parameters, step p50 and peak memory; then ``train_main
              --dataset cifar10`` (ResNet-20, 1024 images, 16 iterations)
              ends finite;
20a. resnet_folder — ResNet's main on an image folder: 512 JPEGs in 8
              classes (the committed fixtures, 64 copies each) through
              ``train_main --dataset imagenet -f`` (ResNet-50 B, batch
              128, 8 iterations, bf16), then Inception-v1's ``train_main
              -f`` (batch 64, 6 iterations): the folder's load seconds,
              step p50, images/s, peak memory, finite losses;
21. resnet_u8 — the u8-NHWC feed: ResNet-50 (``maybe_fuse``,
              ``BIGDL_PALLAS_MIN_C=128``, batch 256, bf16, the bench.py SGD
              recipe) trained 6 iterations through ``optimize()`` on 512
              seeded 256² uint8 images (crop 224, ImageNet mean/std) fed
              by ``NativeImagePipeline(output="u8_nhwc")`` with
              ``set_device_preprocess(pipe.device_normalizer())``, then by
              ``output="f32_nchw"`` (the native loader), then by the same
              pipeline's numpy iterator (``plain_iter``); first the
              native f32 batches against the numpy iterator's (labels in
              the same order, values within an ulp); all with train and validation
              summaries, a Top-1 validation every epoch on 256 images and
              ``set_profile`` over iterations 3-4: the fused kernels 28
              times per step (and the forward 28 times per eval batch),
              the two runs' losses within 1e-3 relative, the trace names
              the fused kernels, one Top-1 per validation; per feed the
              step p50, bytes uploaded per step, and the shares of step
              time in ``place_batch`` and in the host pipeline;
22. resnet_preempt — ``handle_preemption`` on the card: a worker process
              trains ResNet-20 on the cifar10 recipe of ``train_main``
              with a checkpoint path; SIGTERM once its trigger reports
              iteration 3; it must exit with ``TrainingPreempted`` and a
              checkpoint at the iteration it stopped at; a resumed and an
              uninterrupted process to iteration 8 end bitwise equal
              under ``cudnn.deterministic``;
23. lenet    — BASELINE config #1: ``generate_idx_dataset`` writes
              60,000 train and 10,000 test images (seed 7, noise 220);
              ``train_main`` (batch 128, lr 0.05, momentum 0.9, 2 epochs,
              ``--cache``) and ``test_main`` on its last snapshot, Top-1 >=
              0.97; the ``Optimizer`` API with ``set_validation`` every
              epoch (each validation line printed): step p50, records/s,
              epoch wall, the host pipeline's share, validation seconds,
              peak memory and, by ``torch.profiler`` over 8 steps,
              launches, copies and waits per train step; a run stopped
              after epoch 1 and resumed into a freshly built model equal to
              the uninterrupted run bitwise under ``cudnn.deterministic``,
              and the same difference without it printed; the card against
              the CPU from the same weights and batches, one f32 step and 20
              float64 steps, parameters within ``LENET_CARD_TOL``. No port
              kernel runs on this path (cuDNN's 5x5 convolutions);
24. vgg      — BASELINE config #2: ``models.vgg.train_main`` (VGG-16
              ``VggForCifar10`` with Dropout on, the step's generator
              seeded per iteration; batch 128, 32², 1024 synthetic CIFAR
              images, SGD 0.01 / momentum 0.9, 8 iterations, ``--cache``)
              and ``test_main`` on its snapshot (512 images scored); step
              p50, images/s and peak memory from the run, launches per
              step by ``torch.profiler`` over 4 steps; the card against
              the CPU from the same weights at batch 8, dropout off: the
              first f32 step's loss, and 3 float64 steps' losses and
              parameters, within ``BASELINE_CARD_TOL``;
25. inception — BASELINE config #4: ``models.inception.train_main``
              (``Inception_v1_NoAuxClassifier(1000)``, Dropout on, batch
              64, 224², 384 synthetic images, SGD with ``Poly(0.5,
              62000)``, 6 iterations); the same figures (launches over 2
              steps); one train step of ``Inception_v1`` (three heads,
              Dropout on) through ``ParallelCriterion`` with weights 1,
              0.3, 0.3 at batch 64; card against CPU at batch 2 as vgg's
              (2 float64 steps);
26. textclassifier — BASELINE config #5: ``models.textclassifier.
              train_main`` at its synthetic defaults (vocab 500, seqLen 50,
              5 classes, embedding 64, hidden 128, BiRecurrent LSTM, batch
              32, Adagrad 0.05, 3 epochs of 512 samples); Top-1 on the
              next 256 samples of its synthetic stream above chance (0.2);
              the same figures and launches per time step and direction;
              3 SGD steps at batch 32, card against CPU, in f32 and in
              float64 (losses and parameters). No port
              kernel runs on these three paths (cuDNN convolutions, plain
              LRN and recurrence ops, cuBLAS products);
26a. text_news20 — the text classifier's ``train_main --news20`` at its
              defaults (seqLen 50, embedding 64, BiRecurrent LSTM on
              host-embedded GloVe input, batch 32, Adagrad 0.05, 3
              epochs) on the synthetic corpus and on a 500-message
              ``20news-18828.tar.gz`` written here: step p50, samples/s,
              Top-1 on its samples above chance (1/20);
27. distri_vgg — BASELINE config #2 through ``DistriOptimizer`` on a
              one-rank NCCL group (``Engine.init_distributed`` at a
              ``file://`` rendezvous, its first collective warmed, the
              group destroyed after): ``Optimizer(VggForCifar10(10),
              DataSet.distributed(1024 synthetic CIFAR images),
              ClassNLLCriterion(), batch_size=128)``, SGD 0.01 / 0.9,
              f32, 8 iterations, ``LocalOptimizer``, the
              ``partitioned``, ``partitioned`` with ``compress="bf16"``,
              ``allreduce`` and ``blockstore`` modes, and
              ``LocalOptimizer`` again: step p50, images/s,
              collective calls and bytes per step, host bytes and the
              block store's milliseconds per step (blockstore), peak
              memory, and launches per step by ``torch.profiler`` over 4
              iterations of a fresh model; the bf16 run keeps f32
              parameters and slots, moves 2 bytes per element of the
              padded vector fewer per step than the f32 run (its
              reduce-scatter is bf16) and parts from the f32 run's losses
              by more than ``BF16_EXCHANGE_FLOOR`` and at most
              ``BF16_EXCHANGE_TOL``; then ``partitioned`` and ``allreduce`` against
              ``LocalOptimizer`` from the same weights (3 f32 steps,
              dropout off, ``cudnn.deterministic``): losses and
              parameters bitwise (``DISTRI_CARD_TOL``);
28. distri_resnet — the resnet_train recipe (ResNet-50, batch 256, 224²,
              bf16, SGD 0.1 / 0.9 / 1e-4, ``maybe_fuse`` with
              ``BIGDL_PALLAS_MIN_C=128``, 2 warm + 5 timed steps) through
              ``LocalOptimizer`` and ``DistriOptimizer(
              parameter_mode="partitioned")`` on a one-rank NCCL group,
              in turns (local, partitioned, partitioned, local):
              the same figures, the fused kernels 28 times per step each,
              and the operands their wrappers copied for alignment;
29. distri_pod — ``examples/distributed_pod.main`` on the card (LeNet-5,
              batch 64, partitioned): 10 iterations with a checkpoint,
              then 5 and a ``--resume`` to 10, whose parameters must
              equal the uninterrupted run's bitwise under
              ``cudnn.deterministic``; step p50; collective calls and
              bytes per step and launches per step over a 4-iteration run
              (no checkpoint, no validation);
29a. nn_tail — every layer, criterion and optimizer of A.7 group 1 on the
              card against the port's own CPU run from the same weights
              and inputs (f32, TF32 off): the activations, misc ops,
              shape/table ops and containers on (64, 1024) rows or (32, 64,
              56, 56) maps, ``SpatialFullConvolution`` 64→32 channels,
              stride 2, on 28² (batch 32), ``Normalize``, ``BilinearFiller``
              and ``Echo``; forward, input gradient and parameter
              gradients; the 13 criteria on (64, 1024) rows (loss and input
              gradient); the five optimizers five steps each on a (1024,
              1024) weight; the largest error per name, each relative to
              the CPU value's largest magnitude, against ``NN_TAIL_TOL``;
29b. autoencoder — ``models.autoencoder.train_main`` at its published
              width (784 → 32 → 784, batch 128, Adagrad 0.01, 2 epochs)
              on 60,000 synthetic digits: the loss falls, step p50 and
              records/s; its first f32 step card against CPU (loss, the
              Adagrad accumulator g², the parameters) within
              ``AE_CARD_TOL``;
29c. finetune — ResNet-50 (1,000 classes, shortcut B, f32, batch 64,
              224², synthetic ImageNet) fine-tuned: ``freeze()`` then
              ``unfreeze(<the head Linear>)``, RMSprop with L2 weight decay
              on every conv and linear (``w_regularizer``), 5 steps
              through ``LocalOptimizer`` and again through
              ``DistriOptimizer`` (allreduce, a one-rank NCCL group): every
              frozen parameter ``torch.equal`` to its start, the head
              moved; the same recipe unfrozen for the step p50 beside the
              frozen one;
29d. rnn_cells — each new recurrent cell on the card against the port's
              own CPU run from the same weights and inputs (f32, TF32
              off), forward and backward (output, input gradient and
              parameter gradients, each relative to its tensor's largest
              CPU value, against ``RNN_CELLS_TOL``): ``RnnCell``, ``GRU``
              (both forms), ``LSTMPeephole`` and a two-``LSTM``
              ``MultiRNNCell`` at Zaremba et al.'s medium PTB width
              (hidden 650, 35 steps, batch 20) under ``Recurrent``,
              ``RecurrentDecoder(35)`` over ``GRU(650, 650)``,
              ``TimeDistributed(Linear(650, 10000))`` on (20, 35, 650), and
              a ``MultiRNNCell`` of three 5x5 ``ConvLSTMPeephole``s
              (hidden 128, 64, 64) on Shi et al.'s Moving-MNIST patch
              layout (10 frames of 16 x 16 x 16, batch 16; the check runs
              2 of the 16 sequences); step p50 of forward + backward and
              launches per time step at the full batch;
29e. ptb — ``PTBModel`` at the PTB "small" configuration (vocabulary
              10,000, hidden 200, 2 LSTM layers, 20 steps, batch 20)
              through ``LocalOptimizer`` with ``Adagrad(0.1)`` for one
              epoch of 10,000 synthetic windows (PTB's train set is about
              929k words): its first f32 step card against CPU within
              ``PTB_CARD_TOL``, the loss falls, step p50, words/s,
              launches per step and per time step and layer, peak memory;
              ``models.rnn.train_main`` on the ``-f`` corpus path (a
              200,000-word text file of a 10,000-word vocabulary written
              here, seqLen 20, batch 20, hidden 200, one epoch);
              ``SimpleRNN`` at the same width five steps;
29f. languagemodel — ``examples.languagemodel.main`` at ``--vocab 10000
              --hidden 200 --seqLen 20 -b 20`` on a 2,000-window synthetic
              epoch with ``--beam 4 --genLen 20``: every beam's ids in the
              vocabulary, scores sorted; on a 2-layer ``PTBModel`` the
              stacked-cell step fed a 20-token prompt one token at a time
              reproduces ``model.forward``'s log-probabilities at every
              position within ``LM_STEP_TOL``; the beam search's ms per
              generated token;
29g. treelstm — ``TreeLSTMSentiment(20000, 128, 128, 5)`` (JAX's
              defaults, a Stanford Sentiment Treebank-sized vocabulary) on
              25 synthetic binary trees of 10-56 leaves padded to 111
              nodes: forward and backward card against CPU within
              ``TREE_CARD_TOL``; ``TreeNNAccuracy`` (root and all nodes)
              of the card's output equal to the CPU's; ``LBFGS(max_iter=
              10)`` on the root loss of 256 trees lowers it, its first
              loss and gradient card against CPU; forward + backward ms
              per batch, launches per node and L-BFGS evaluations per
              second. No port kernel runs on these four paths (cuBLAS
              products, cuDNN convolutions, plain elementwise ops);
29h. nn_extra — every layer and criterion of A.7 group 3 (83 names:
              ``nn/layers_extra.py``, ``nn/layers_more.py``,
              ``nn/sparse.py``, ``nn/criterion_extra.py``) on the card
              against the port's own CPU run from the same weights and
              inputs (f32, TF32 off; training mode with no generator, so
              the random layers are deterministic): dense rows (64,
              1024), maps (32, 64, 56, 56), C3D's first block (Tran et al.
              2015: ``VolumetricConvolution`` 3 → 64, 3x3x3 on (8, 3, 16,
              112, 112); volumetric pooling on (8, 64, 16, 56, 56)), a
              sentence CNN (Kim 2014: batch 64, 56 words, 300-d, 100 maps
              of widths 3-5, max over time), ``LocallyConnected2D`` 3x3 on
              (16, 64, 28, 28), ``SparseLinear`` and ``LookupTableSparse``
              (sum, mean, sqrtn) over 1,000,000 hashed features, 40
              nonzeros a row, batch 2,048 (outputs 2 and 64: a 256 MB
              table); forward, input gradients and parameter gradients,
              each tensor's largest error relative to the CPU's largest
              value, against ``NN_EXTRA_TOL`` (the convolution-heavy
              layers are checked on their first 1-8 rows); the 15 criteria
              on (64, 1024) rows (loss and input gradient); forward +
              backward ms (p50) and launches (the host's launch, copy
              and fill calls; the card's records beside them) of the C3D,
              sentence-CNN, locally connected and sparse layers at their
              full batch;
              the random layers drawing from a CUDA generator: their laws
              (slope range and mean, noise deviation, keep rate, one
              decision per channel) and a bitwise repeat per seed;
29i. alexnet — ``models.alexnet.train_main`` (``AlexNet_OWT``, Dropout on,
              batch 128, 224², f32, SGD 0.01 / momentum 0.9, 8 iterations
              on 1,024 synthetic images): step p50, images/s, peak
              memory, launches per step over 4 iterations, a finite loss;
              its first f32 step's loss and 3 float64 steps card against
              CPU at batch 4 (``BASELINE_CARD_TOL``); the Caffe layout
              (``AlexNet``: LRN, two-group convolutions, 227² crops)
              forward + backward at batch 128 (ms, launches) and card
              against CPU at batch 4 (``ALEXNET_CARD_TOL``). No port
              kernel runs on these two paths either (cuDNN convolutions,
              cuBLAS products, ``index_add``);
29j. keras_resnet50 — Keras 1.2.2's ``applications/resnet50.py::
              ResNet50(include_top=True)``, ``th`` ordering, built with the
              port's Keras functional API
              (``examples/keras_apps.py::resnet50``: the 7x7 stem, [3, 4,
              6, 3] conv/identity blocks ending in ``Merge(mode="sum")``,
              ``AveragePooling2D((7, 7))``, ``Flatten``, ``Dense(1000)``,
              the head ``log_softmax``): its parameter count against
              Keras's published 25,636,712 (53,120 BatchNormalization
              running statistics); ``Optimizer`` at batch 64, 224², f32,
              SGD 0.1 / 0.9 on ``synthetic_imagenet_samples``: step p50,
              images/s, peak memory, launches per step over 4 steps; the
              eval f32 output (``KERAS_CARD_TOL``), the first f32 loss and
              2 float64 steps card against CPU at batch 2
              (``BASELINE_CARD_TOL``); ``save_module`` of the trained model
              and ``load_module`` back onto the card, outputs bitwise
              equal;
29k. keras_imdb — Keras 1.2.2's ``examples/imdb_cnn_lstm.py`` at its
              widths (Embedding 20,000 x 128 on maxlen 100, Dropout 0.25,
              Convolution1D 64 x 5, MaxPooling1D 4, LSTM 70, Dense 1,
              sigmoid) written as its Keras-1.2 ``to_json()`` text, built
              by ``load_keras_json`` and filled by ``load_keras_weights``
              from seeded keras-1 arrays (the card's machine has no h5py;
              the LSTM states ``inner_activation: "sigmoid"``, as the
              importer refuses the example's default ``hard_sigmoid``);
              ``Optimizer`` at batch 30, ``BCECriterion``, Adam 1e-3 on
              seeded ids: step p50, sequences/s, launches per step; card
              against CPU at batch 4 as above; the ``save_module`` round
              trip on the card. No port kernel runs on either Keras path;
30. conv3x3 — the twin of ``benchmarks/pallas_conv3x3_experiment.py``'s
              ``main()``, the one path of its TPU kernel: the 3x3 stride-1
              conv kernel at ResNet-50's four 3x3 shapes (batch 256, 56² x
              64 to 7² x 512, bf16) plus a ragged and a one-pixel f32 case,
              each output pixel against the plain version and the first two
              images against F.conv2d in f32; the four shapes timed (the
              kernel through its C entry point and through the wrapper,
              one launch each on the unpadded input; plain) beside cuDNN's
              F.conv2d, with TFLOP/s and the bound.

Each path's kernel launch counts are set to 0 just before it runs and read
just after; each of its kernels must have launched (decode attention and
kv_requant once per layer per decode step in serve, serve_modes,
serve_async, serve_lora, serve_disagg (summed over the decode pools) and
each pass of serve_autopilot; decode attention once per layer per decode
step in generate, which launches no kv_requant (float KV); in serve_spec
kv_requant once per target layer per verify step and no decode
attention; each
flash kernel once per layer per step, each
fused-conv kernel exactly 28 times per ResNet-50 step (resnet_train,
the three resnet_u8 runs and distri_resnet's distributed run; the forward
also 28 times per eval batch of resnet_u8's validations), the conv3x3
kernel
once per checked case and 33 times per timed shape; the w8a16 kernel
once per forward of int8_infer's weight-only ResNet-50 and 25 times per
decode step and per prefill call of int8_decode's weight-only runs).

The last lines are the ``{"kernels": [...]}`` summary, the card's
``name, power.limit`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
HOST_GUARD_CYCLES = 2_000_000    # ~1 ms of device spin while the host enqueues
#: nn_tail: card vs CPU, the largest difference relative to the CPU
#: value's largest magnitude, per kind of computation (f32, TF32 off).
#: Element-wise ops differ by the two libraries' math functions (a few
#: ulps); reductions, products, convolutions and losses by their summation
#: order; five optimizer steps by both.
NN_TAIL_TOL = {"elementwise": 1e-5, "reduction": 1e-5, "product": 1e-4,
               "criterion": 1e-5, "optimizer": 1e-5}
#: autoencoder: its first f32 step card vs CPU: the loss, the Adagrad
#: accumulator g² (each tensor relative to its largest), and the
#: parameters wherever the gradient is above 1% of its tensor's largest
#: (Adagrad's first step is lr·g / (|g| + 1e-10) ≈ ±lr: where g is within
#: the summation order's rounding of 0, card and CPU may step opposite
#: ways, as on the CPU against JAX).
AE_CARD_TOL = 1e-5
#: LeNet through the Optimizer, card vs CPU from the same weights and
#: batches: the largest parameter difference after the first f32 step, and
#: after 20 float64 steps. Twenty f32 steps part at a max-pool near-tie
#: (see ``BASELINE_CARD_TOL``): the CPU run's pool windows have top-two
#: gaps down to 1.2e-7 within those steps, and on an H100 at 700 W a
#: fixed batch order parted from the CPU at one window choice by 5.9e-6 in
#: one step and 1.6e-5 three steps later (cudnn deterministic or not); a
#: whole chip_smoke run once parted by 5.7e-4. In float64 the two differ by
#: rounding only (measured 1.1e-16 after 20 steps).
LENET_CARD_TOL = {"f32_first_step": 1e-5, "f64": 1e-9}
#: rnn_cells: each tensor's largest error relative to its largest CPU
#: value; the dense cells' products sum K = 650 terms in other orders,
#: then 35 steps of recurrence and their backward; the ConvLSTM stack's
#: 5x5 convolutions sum up to K = 3,200 terms by whichever algorithm
#: cuDNN picks.
RNN_CELLS_TOL = {"dense": 1e-4, "conv": 1e-3}
#: ptb: the first f32 Adagrad step card vs CPU: the loss, the
#: accumulator g² and the parameters where |g| is clear of 0
#: (``AE_CARD_TOL``'s reasoning).
PTB_CARD_TOL = 1e-5
#: languagemodel: the stacked-cell step's log-probabilities against
#: ``model.forward``'s on the card, relative to the largest magnitude.
LM_STEP_TOL = 1e-5
#: treelstm: forward and backward card vs CPU, each tensor relative to
#: its largest CPU value (111 node steps of K = 256 products whose errors
#: feed the parents), and L-BFGS's first loss and gradient.
TREE_CARD_TOL = 1e-4
#: nn_extra: card vs CPU, each tensor's largest error relative to its
#: largest CPU value, per kind of computation (f32, TF32 off), as
#: ``NN_TAIL_TOL``: element-wise ops differ by the libraries' math
#: functions; reductions, products, sparse ``index_add`` sums and losses
#: by their summation order; the convolutions (cuDNN's algorithms, weight
#: gradients summed over up to 1.6M positions) and the Torch7
#: normalizations (81-tap sums over 64 channels, then a division and a
#: square root) by more; the host-side layers (``MaskedSelect``,
#: ``DenseToSparse``) select and copy, so they are exact.
NN_EXTRA_TOL = {"elementwise": 1e-5, "reduction": 1e-5, "product": 1e-4,
                "convolution": 1e-4, "normalization": 1e-4, "sparse": 1e-5,
                "host_side": 0.0, "criterion": 1e-5}
#: alexnet: the Caffe-layout AlexNet's forward and backward card vs CPU
#: at batch 4, each tensor relative to its largest CPU value: the f32
#: output (products of up to 9,216 terms; a forward routes nothing), and
#: in float64 the output, the input gradient and every parameter's
#: gradient. The f32 gradients are printed, not held: a ReLU or max-pool
#: near-tie routes a window's gradient elsewhere (``BASELINE_CARD_TOL``'s
#: reasoning; on an H100 at 700 W one f32 weight gradient parted by
#: 1.2e-3 of its largest value while the f32 output agreed to 1.4e-7).
ALEXNET_CARD_TOL = {"f32_output": 1e-5, "f64": 1e-9}
#: keras_resnet50 / keras_imdb: the eval-mode f32 output card vs CPU at
#: the check batch, relative to the largest CPU value. ResNet-50 stacks 53
#: convolutions (sums of up to 4,608 products each, taken by cuDNN in
#: another order and algorithm), so its output is held to 1e-4; the IMDB
#: model (one convolution, one LSTM) to 1e-5. Losses and float64 steps go
#: through ``BASELINE_CARD_TOL``.
KERAS_CARD_TOL = {"keras_resnet50": 1e-4, "keras_imdb": 1e-5}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started, so
    the log shows where the run's time goes."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - _T0, 3)}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers and spills over a library's template variants, from
    ``nvcc -Xptxas -v``."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    return {"variants": len(regs), "max_registers": max(regs, default=0),
            "max_spill_store_bytes": max(spills, default=0)}


#: the wgmma kernels, by library: each must hold HGMMA instructions
WGMMA_KERNELS = {"conv3x3": ("conv3x3_wgmma",),
                 "flash_attention": ("fwd_wgmma", "dq_wgmma", "dkv_wgmma"),
                 "fused_conv": ("fwd_wgmma", "fwd_panel_wgmma", "dgrad_wgmma",
                                "wgrad_wgmma"),
                 "w8a16": ("w8a16_wgmma",)}
#: kernels, by library, that must build without a "wgmma ... serialized"
#: ptxas line (by library: both libraries have a ``fwd_wgmma``)
NO_SERIALIZED_WGMMA = {"flash_attention": ("dq_wgmma", "dkv_wgmma"),
                       "fused_conv": ("fwd_wgmma", "fwd_panel_wgmma",
                                      "dgrad_wgmma", "wgrad_wgmma"),
                       "w8a16": ("w8a16_wgmma",)}


def hgmma_per_kernel(name: str) -> dict:
    """``HGMMA`` (warpgroup matrix multiply) instructions in the SASS of
    each wgmma kernel of the built library ``name``, summed over the
    kernel's template variants: above zero where wgmma was emitted."""
    import shutil

    from bigdl_tpu_torch.utils import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = dict.fromkeys(WGMMA_KERNELS[name], 0)
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = next((k for k in counts if k in m.group(1)), None)
        elif kernel is not None and re.search(r"\bHGMMA\.", line):
            counts[kernel] += 1
    return counts


def serialized_wgmma(name: str, log: str) -> list:
    """The ptxas lines (``-Xptxas -v``) of library ``name`` that report
    wgmma serialized (C7510-C7520) in a kernel of its
    ``NO_SERIALIZED_WGMMA``."""
    kernels = NO_SERIALIZED_WGMMA.get(name, ())
    return [line.strip() for line in log.splitlines()
            if re.search(r"C75(1\d|20)", line) and "wgmma" in line
            and any(k in line for k in kernels)]


#: host time to enqueue the event pair and ``fn`` of each timed launch of
#: this run (:func:`time_stats`): the longest, the launches, those that
#: took longer than the guard's spin (so the pair may hold host time; each
#: is taken again) and those kept all the same (retakes ran out)
HOST_ENQUEUE = {"max_ms": 0.0, "launches": 0, "over_guard": 0,
                "kept_over_guard": 0}
_GUARD_MS: list = []


def guard_ms() -> float:
    """Device time of one host guard (``torch.cuda._sleep`` of
    ``HOST_GUARD_CYCLES``), by CUDA events, measured once."""
    import torch

    if not _GUARD_MS:
        torch.cuda._sleep(HOST_GUARD_CYCLES)          # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(HOST_GUARD_CYCLES)
        end.record()
        end.synchronize()
        _GUARD_MS.append(start.elapsed_time(end))
    return _GUARD_MS[0]


def time_stats(fn, reps: int = 30, flush=None) -> dict:
    """Device times of ``fn`` by CUDA events, one pair around each of
    ``reps`` launches after 3 warm-up calls: mean, median, min and max in
    ms, and the host's longest enqueue of one. ``flush`` (a large buffer)
    is overwritten before each launch so the caches start cold, as the
    decode step finds the KV cache after the other layers' work. Then the
    card spins (``torch.cuda._sleep``) while the host enqueues the events
    and ``fn``: without it a host slower than the flush leaves the card
    idle inside the event pair, and the time of a short kernel measures
    its wrapper's Python instead. A launch that
    the host took longer to enqueue than the guard spins is taken again,
    up to ``reps`` times in all; :data:`HOST_ENQUEUE` counts them."""
    import torch

    guard = guard_ms()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, retakes, host_max = [], reps, 0.0
    while len(times) < reps:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_GUARD_CYCLES)
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_max = max(host_max, host_ms)
        HOST_ENQUEUE["max_ms"] = max(HOST_ENQUEUE["max_ms"], host_ms)
        HOST_ENQUEUE["launches"] += 1
        if host_ms >= guard:
            HOST_ENQUEUE["over_guard"] += 1
            if retakes > 0:
                retakes -= 1
                continue
            HOST_ENQUEUE["kept_over_guard"] += 1
        times.append(start.elapsed_time(end))
    return {"mean": float(np.mean(times)), "median": float(np.median(times)),
            "min": min(times), "max": max(times), "host_ms_max": host_max}


def device_us(fn, flush, reps: int = 20) -> float:
    """Median time on the card in microseconds of the kernels one call of
    ``fn`` launches, summed per call, by ``torch.profiler`` (no host time
    and no event overhead: the launch gap a CUDA-event pair holds is left
    out), ``flush`` overwritten before each call; elementwise and memset
    kernels (the flush's, a wrapper's allocations) are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type.name == "CUDA"
                      and "elementwise" not in e.name
                      and "Memset" not in e.name),
                     key=lambda e: e.time_range.start)
    per = len(kernels) // reps        # kernels per call
    if per == 0 or len(kernels) % reps:   # the profiler dropped events
        return float("nan")
    sums = sorted(sum(e.time_range.elapsed_us()
                      for e in kernels[i * per:(i + 1) * per])
                  for i in range(reps))
    return float(sums[len(sums) // 2])


def time_ms(fn, reps: int = 30, flush=None) -> float:
    """Mean device time of ``fn`` (:func:`time_stats`)."""
    return time_stats(fn, reps, flush)["mean"]


def bound(ops: float, n_bytes: float, peak: float):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of ``ops`` at ``peak`` and ``n_bytes`` at the memory rate."""
    t_ops, t_bytes = ops / peak, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_inputs(kind, n, L, h, d, seed):
    """Seeded inputs on the card; int8 K/V are quantized from normal
    values with the engine's per-(row, head) scale rule."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(n, h, d, device="cuda", generator=g)
    pos = torch.randint(0, L, (n,), device="cuda", generator=g,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, L - 1
    k = torch.randn(n, L, h, d, device="cuda", generator=g)
    v = torch.randn(n, L, h, d, device="cuda", generator=g)
    if kind.startswith("int8"):
        ks = k.abs().amax(dim=(1, 3)) / 127.0 * 1.25
        vs = v.abs().amax(dim=(1, 3)) / 127.0 * 1.25
        k = torch.round(k / ks[:, None, :, None]).clamp(-127, 127)
        v = torch.round(v / vs[:, None, :, None]).clamp(-127, 127)
        return q, k.to(torch.int8), v.to(torch.int8), pos, ks, vs
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return q, k.to(dt), v.to(dt), pos, None, None


# the serving decode step's call: 16 pooled rows, cache 512, 12 heads, D 64
SERVING_DECODE = (16, 512, 12, 64)


def decode_work(q, k_scale, pos, h, d):
    """(live columns, bytes, operations) of one int8 decode-attention call:
    the live K and V columns read once, q in and the output out (q's
    dtype), both scales and pos; q.k and p.v, a multiply and an add each."""
    cols = int((pos.long() + 1).sum())
    n_bytes = (cols * h * d * 2 + q.numel() * q.element_size() * 2
               + 2 * k_scale.numel() * 4 + pos.numel() * pos.element_size())
    return cols, n_bytes, cols * h * d * 4


def dequantized_sdpa(q, k, v, pos, k_scale, v_scale):
    """The int8 decode kernel's library yardstick: one SDPA call over K/V
    dequantized to q's dtype, with the per-row mask. Everything but the
    call is prepared here, outside any timing; the call returns (N, H, 1,
    D)."""
    import torch
    import torch.nn.functional as F

    def deq(t, s):
        t = (t.float() * s[:, None, :, None]).to(q.dtype)
        return t.transpose(1, 2).contiguous()

    kd, vd = deq(k, k_scale), deq(v, v_scale)
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, None, :]
            <= pos.long()[:, None, None, None])
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)


def kernels_phase():
    """decode_attention against its plain version; returns the kernel's
    summary entry (times at the main path's call: bf16 q and output,
    int8 K/V)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da

    n_serve, L, h, d = SERVING_DECODE
    bf16, f32 = torch.bfloat16, torch.float32
    bf16_out = "bf16 output: two bf16 ulps at |out| <= 2"
    f32_sums = "f32 math, sums in another order"
    # (case, rows, q/out dtype, L, tolerance and why): the serving step's
    # call first, then the other row counts the main path launches at —
    # serve_autopilot's 4 int8 slots, and make_decode_step's float caches
    # at generate's batch 1, the beam's 4 and the 8-slot engine oracle
    # ("step" cases: q pre-scaled and cast to the cache dtype, scale 1.0,
    # as that step calls it)
    cases = [
        ("int8_serving", n_serve, bf16, L, 1.6e-2, bf16_out),
        ("int8", n_serve, f32, L, 2e-5, f32_sums),
        ("int8_ragged_L300", n_serve, f32, 300, 2e-5,
         "f32 math, L not a tile multiple"),
        ("bf16", n_serve, f32, L, 2e-2,
         "p rounded to bf16 before p.v (unnormalized in the kernel)"),
        ("fp32", n_serve, f32, L, 2e-5, f32_sums),
        ("int8_slots4", 4, bf16, L, 1.6e-2, bf16_out),
    ]
    for rows in (1, 4, 8):
        cases += [
            (f"bf16_step_b{rows}", rows, bf16, L, 3.6e-2,
             "p rounded to bf16 before p.v (2e-2), and the bf16 output's "
             "two ulps at |out| <= 2 (1.6e-2)"),
            (f"fp32_step_b{rows}", rows, f32, L, 2e-5, f32_sums)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entry = None
    for i, (case, n, qdt, Lc, tol, why) in enumerate(cases):
        kind = case.split("_")[0]
        q, k, v, pos, ks, vs = attention_inputs(kind, n, Lc, h, d, seed=i)
        scale = None
        if "_step_" in case:
            q, scale = (q * d ** -0.5).to(k.dtype), 1.0
        q = q.to(qdt)
        got = da.pooled_decode_attention(q, k, v, pos, ks, vs, scale=scale,
                                         out_dtype=qdt)
        want = da.decode_attention_reference(q, k, v, pos, ks, vs,
                                             scale=scale, out_dtype=qdt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        finite = bool(torch.isfinite(got).all())
        emit("kernels", kernel="decode_attention", case=case,
             shape=[n, Lc, h, d], kv_dtype=str(k.dtype), out_dtype=str(qdt),
             max_abs_err=err, tol=tol, why=why, finite=finite,
             splits=da.split_count(n * h, Lc, sms))
        if not finite or err > tol:
            raise AssertionError(
                f"decode_attention {case}: max abs err {err} > tol {tol}")
        if case != "int8_serving":
            continue
        kern = time_stats(lambda: da.pooled_decode_attention(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        ms = kern["mean"]
        plain_ms = time_ms(lambda: da.decode_attention_reference(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        sdpa = dequantized_sdpa(q, k, v, pos, ks, vs)
        lib_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
        lib_t = time_stats(sdpa, flush=flush)
        library_ms = lib_t["mean"]
        cols, n_bytes, ops = decode_work(q, ks, pos, h, d)
        bound_ms, bound_by = bound(ops, n_bytes, F32_FLOPS)
        emit("kernels", kernel="decode_attention", case=case, ms=ms,
             ms_median=kern["median"], ms_min_max=[kern["min"], kern["max"]],
             host_ms_max=kern["host_ms_max"],
             splits=da.split_count(n * h, Lc, sms),
             plain_ms=plain_ms, library_ms=library_ms,
             library_ms_median=lib_t["median"],
             library_ms_min_max=[lib_t["min"], lib_t["max"]],
             library_host_ms_max=lib_t["host_ms_max"],
             library="F.scaled_dot_product_attention, bf16 dequantized K/V",
             library_max_abs_err=lib_err, bound_ms=bound_ms,
             bound_by=bound_by, bytes=n_bytes, ops=ops, key_columns=cols,
             roofline_share=bound_ms / ms)
        entry = {"name": "decode_attention", "route": "cuda",
                 "source": "bigdl_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "bigdl_tpu/ops/decode_attention.py:126",
                 "launches": None, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms}
    return entry


def lm_flops_per_token(vocab: int, hidden: int, layers: int, t: int,
                       mlp_ratio: int = 4) -> float:
    """6 N_matmul + 12 L T H (the PaLM convention of
    ``benchmarks/llm_mfu_bench.py:55-63``, copied): forward + backward
    matmul FLOPs per token, attention counted over the full T x T."""
    attn_params = 4 * hidden * hidden
    mlp_params = 2 * hidden * (mlp_ratio * hidden)
    n_matmul = layers * (attn_params + mlp_params) + hidden * vocab
    return 6.0 * n_matmul + 12.0 * layers * t * hidden


def flash_work(b, tq, tk, h, d, causal, off, nbytes):
    """(FLOPs per kernel, bytes per kernel) that this call's data needs:
    the (query, key) pairs the mask keeps (a fully masked row visits every
    key), 2 FLOPs per multiply-add over D for each matmul — 2 in the
    forward, 3 in dq, 4 in dk/dv — and each operand read once, each
    output written once (dq reads O and writes delta too)."""
    rows = np.arange(tq)
    if causal:
        seen = np.clip(rows + off + 1, 0, tk)
        seen = np.where(rows + off < 0, tk, seen)
    else:
        seen = np.full(tq, tk)
    pairs = float(seen.sum()) * b * h
    mm = 2.0 * d * pairs
    q_bytes = b * tq * h * d * nbytes
    kv_bytes = b * tk * h * d * nbytes
    row_f32 = b * h * tq * 4
    return {"fwd": (2 * mm, q_bytes * 2 + kv_bytes * 2 + row_f32),
            "dq": (3 * mm, q_bytes * 4 + kv_bytes * 2 + row_f32 * 2),
            "dkv": (4 * mm, q_bytes * 2 + kv_bytes * 4 + row_f32 * 2)}


# (case, B, Tq, Tk, H, D, causal, causal_offset)
FLASH_CASES = [("train_main", 8, 2048, 2048, 12, 64, True, 0),
               ("noncausal_T300", 2, 300, 300, 12, 64, False, 0),
               ("tq_ne_tk", 2, 200, 520, 12, 64, True, 0),
               ("strict_causal", 2, 512, 512, 12, 64, True, -1)]


def flash_inputs(i: int, dtype):
    """Seeded q, k, v, dO on the card for case ``FLASH_CASES[i]``."""
    import torch

    _, b, tq, tk, h, d, _, _ = FLASH_CASES[i]
    g = torch.Generator(device="cuda").manual_seed(100 + i)

    def rand(t):
        return torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)

    return rand(tq), rand(tk), rand(tk), rand(tq)


def flash_phase():
    """The flash forward, dq and dk/dv kernels against their plain
    versions; returns their summary entries (times at the main shape)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import flash_attention as fa

    # each row of each output against the same row of the plain version,
    # relative to that row's largest magnitude (fa.max_row_rel_err)
    rtol = fa.ROW_RTOL[torch.bfloat16]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entries = {}
    for i, (case, b, tq, tk, h, d, causal, off) in enumerate(FLASH_CASES):
        q, k, v, do = flash_inputs(i, torch.bfloat16)
        scale = d ** -0.5
        o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, off)
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, scale, causal,
                                                    off)
        got = fa.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do, scale, causal,
                                off)
        want = fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do,
                                           scale, causal, off)
        torch.cuda.synchronize()
        outs = {"fwd": [(o, o_ref)], "dq": [(got[0], want[0])],
                "dkv": [(got[1], want[1]), (got[2], want[2])]}
        lse_err = float((lse - lse_ref).abs().max())
        work = flash_work(b, tq, tk, h, d, causal, off, 2)
        for name, pairs in outs.items():
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in pairs)
            row_err = max(fa.max_row_rel_err(a, r) for a, r in pairs)
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            emit("kernels", kernel=f"flash_{name}", case=case,
                 shape=[b, tq, tk, h, d], causal=causal, causal_offset=off,
                 max_abs_err=err, max_row_rel_err=row_err, rtol=rtol,
                 why=("per row, relative to the row's largest |plain|: bf16 "
                      "rounding of p/ds and of the outputs"),
                 lse_max_abs_err=lse_err if name == "fwd" else None,
                 lse_tol=1e-4 if name == "fwd" else None, finite=finite)
            if (not finite or row_err > rtol
                    or (name == "fwd" and lse_err > 1e-4)):
                raise AssertionError(
                    f"flash {name} {case}: row-relative err {row_err} > "
                    f"{rtol} (lse err {lse_err})")
        if case != "train_main":
            continue
        # dq and dk/dv are timed one launch each through the C entry
        # points (the wrapper launches both); the plain version computes
        # all three gradients at once, so both rows show its time. The dq
        # kernel writes delta, which dk/dv reads: held here against the
        # plain delta (f32 sums of bf16 products in another order)
        delta = torch.empty((b, h, tq), dtype=torch.float32, device="cuda")
        dqb, dkb, dvb = (torch.empty_like(t) for t in (q, k, v))
        geo = (b, h, tq, tk, d, 1, 0, float(scale), 1,
               torch.cuda.current_stream().cuda_stream)
        lib_c = fa._library()
        oc, lc = o_ref.contiguous(), lse_ref.contiguous()  # as the wrapper
        dq_in = (q.data_ptr(), k.data_ptr(), v.data_ptr(), oc.data_ptr(),
                 do.data_ptr(), lc.data_ptr(), delta.data_ptr())
        dkv_in = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lc.data_ptr(), delta.data_ptr())
        launched(lib_c.bigdl_flash_dq(*dq_in, dqb.data_ptr(), *geo))
        torch.cuda.synchronize()
        delta_ref = fa._delta(o_ref, do)
        delta_err = float((delta - delta_ref).abs().max())
        delta_tol = 1e-5 * float(delta_ref.abs().max())
        emit("kernels", kernel="flash_dq delta", case=case,
             max_abs_err=delta_err, tol=delta_tol,
             why="1e-5 of the largest |delta|: f32 sums of bf16 products "
                 "taken in another order")
        if not delta_err <= delta_tol:
            raise AssertionError(f"flash dq delta {case}: err {delta_err} > "
                                 f"{delta_tol}")

        def plain_bwd():
            fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do, scale,
                                        True)

        runs = {
            "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
                    lambda: fa.flash_forward_reference(q, k, v, scale, True)),
            "dq": (lambda: launched(lib_c.bigdl_flash_dq(
                *dq_in, dqb.data_ptr(), *geo)), plain_bwd),
            "dkv": (lambda: launched(lib_c.bigdl_flash_dkv(
                *dkv_in, dkb.data_ptr(), dvb.data_ptr(), *geo)), plain_bwd)}
        # the library yardstick: SDPA forward and backward over the same
        # bf16 inputs in its (B, H, T, D) layout, prepared outside timing
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), flush=flush)
        lo = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lo, (qs, ks, vs), dos, retain_graph=True), flush=flush)
        lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        # the backward as a whole (dq with its delta, and dk/dv, through
        # the wrapper) against SDPA's backward, which computes dq, dk and
        # dv together
        bwd_ms = time_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, o_ref, lse_ref, do, scale, True), flush=flush)
        bwd_flops = work["dq"][0] + work["dkv"][0]
        emit("kernels", kernel="flash_bwd (delta + dq + dk/dv)", case=case,
             ms=bwd_ms, library_ms=lib_bwd,
             library="F.scaled_dot_product_attention backward",
             flops=bwd_flops, tflops_per_s=bwd_flops / bwd_ms / 1e9,
             vs_library=bwd_ms / lib_bwd)
        for name, (kern, plain) in runs.items():
            ms = time_ms(kern, flush=flush)
            plain_ms = time_ms(plain, reps=5, flush=flush)
            flops, n_bytes = work[name]
            bound_ms, bound_by = bound(flops, n_bytes, BF16_FLOPS)
            emit("kernels", kernel=f"flash_{name}", case=case, ms=ms,
                 plain_ms=plain_ms, library_ms=lib[name],
                 library=("F.scaled_dot_product_attention forward"
                          if name == "fwd" else
                          "F.scaled_dot_product_attention backward "
                          "(dq, dk and dv together)"),
                 bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                 bytes=n_bytes, tflops_per_s=flops / ms / 1e9,
                 roofline_share=bound_ms / ms)
            entries[name] = {
                "name": f"flash_attention_{name}", "route": "cuda",
                "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
                "replaces": FLASH_REPLACES[name], "launches": None,
                "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[name]}
        for name, pairs in outs.items():
            entries[name]["max_abs_err"] = max(
                float((a.float() - r.float()).abs().max()) for a, r in pairs)
            entries[name]["max_row_rel_err"] = max(
                fa.max_row_rel_err(a, r) for a, r in pairs)
    return entries


def launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


FLASH_REPLACES = {"fwd": "bigdl_tpu/ops/flash_attention.py:52",
                  "dq": "bigdl_tpu/ops/flash_attention.py:149",
                  "dkv": "bigdl_tpu/ops/flash_attention.py:213"}


# (case, M, C, K, dtype, residual, want_y and extra dy): the stage-1 block
# join (batch 256 at 56x56), the stage-4 bn2 -> conv3 edge (batch 256 at
# 7x7), and an f32 case with ragged M and C, K that are not tile multiples
FUSED_CASES = [("stage1_join", 256 * 56 * 56, 256, 64, "bf16", True, True),
               ("stage4_bn2", 256 * 7 * 7, 512, 2048, "bf16", False, False),
               ("f32_ragged", 3001, 100, 72, "f32", True, True)]
FUSED_REPLACES = {"fwd": "bigdl_tpu/ops/fused_conv.py:141",
                  "dgrad": "bigdl_tpu/ops/fused_conv.py:281",
                  "wgrad": "bigdl_tpu/ops/fused_conv.py:405"}


def fused_inputs(m, c, k, dtype, seed):
    """Seeded rows on the card: pre-BN x with its batch statistics folded
    into scale/shift, a residual, W, dz and an extra dy."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    x = rand(m, c, scale=2.0) + 0.5
    mean, var = x.mean(0), x.var(0, correction=0)
    inv_std = torch.rsqrt(var + 1e-5)
    scale = (rand(c, scale=0.5) + 1.0) * inv_std
    shift = rand(c, scale=0.3) - mean * scale
    return dict(x=x.to(dtype), r=rand(m, c).to(dtype),
                w=(rand(c, k) / c ** 0.5).to(dtype), dz=rand(m, k).to(dtype),
                dy=rand(m, c).to(dtype), scale=scale, shift=shift, mean=mean,
                inv_std=inv_std)


def fused_work(m, c, k, es, res, extra):
    """(FLOPs, bytes) per kernel: 2·M·C·K for each product, each operand
    read once and each output written once (f32 vectors included)."""
    act, out = m * c * es, m * k * es
    w, vec = c * k * es, c * 4
    r = act if res else 0
    flops = 2.0 * m * c * k
    return {"fwd": (flops, act + r + w + out + (act if extra else 0)
                    + 2 * vec + 2 * k * 4),
            "dgrad": (flops, out + w + act + r + (act if extra else 0)
                      + act + 4 * vec + 2 * c * 4),
            "wgrad": (flops, act + r + out + w + 2 * vec)}


def unfused_sequences(d, dtype, res, extra):
    """The unfused PyTorch sequences of the forward, dgrad and wgrad in
    the data dtype, on the rows ``d`` of :func:`fused_inputs` (with the
    residual if ``res``, with the extra dy if ``extra``)."""
    import torch

    sc, sh = d["scale"].to(dtype), d["shift"].to(dtype)
    r = d["r"] if res else 0
    g = d["dy"] if extra else 0

    def fwd():
        yy = torch.relu(d["x"] * sc + sh + r)
        z = (yy @ d["w"]).float()
        return z.sum(0), (z * z).sum(0)

    def dgrad():
        dy = d["dz"] @ d["w"].t() + g
        p = d["x"] * sc + sh + r
        dp = torch.where(p > 0, dy, 0)
        xhat = (d["x"] - d["mean"].to(dtype)) * d["inv_std"].to(dtype)
        return dp.float().sum(0), (dp * xhat).float().sum(0)

    def wgrad():
        yy = torch.relu(d["x"] * sc + sh + r)
        return yy.t() @ d["dz"]

    return {"fwd": fwd, "dgrad": dgrad, "wgrad": wgrad}


def fused_calls(d, dtype, r, g, want_y):
    """The three fused-conv kernels and their plain versions on the rows
    ``d`` of :func:`fused_inputs`: ``{name: (kernel, plain)}``; r, g: the
    residual and extra dy or None; want_y: the forward also returns y."""
    from bigdl_tpu_torch.ops import fused_conv as fc

    return {
        "fwd": (lambda: fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"],
                                          d["w"], r, want_y),
                lambda: fc.fused_fwd_reference(d["x"], d["scale"], d["shift"],
                                               d["w"], r, want_y)),
        "dgrad": (lambda: fc.fused_dgrad_cuda(
            d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g),
            lambda: fc.fused_dgrad_reference(
            d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g)),
        "wgrad": (lambda: fc.fused_wgrad_cuda(d["x"], d["scale"], d["shift"],
                                              d["dz"], r, out_dtype=dtype),
                  lambda: fc.fused_wgrad_reference(d["x"], d["scale"],
                                                   d["shift"], d["dz"], r,
                                                   out_dtype=dtype))}


def fused_errors(name, kern, plain):
    """Runs a fused kernel and its plain version: (max per-row relative
    error of the outputs, of the f32 channel sums — zstats, q: output 1 of
    fwd and dgrad; 0 for the wgrad —, max abs error of the outputs, all
    finite)."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    outs = [(a, b) for j, (a, b) in enumerate(zip(got, want))
            if name == "wgrad" or j != 1]
    row_err = max(fc.max_row_rel_err(a, b) for a, b in outs)
    sum_err = 0.0 if name == "wgrad" else fc.max_row_rel_err(got[1], want[1])
    abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in outs)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    return row_err, sum_err, abs_err, finite


def fused_conv_phase():
    """The forward, dgrad and wgrad kernels against their plain versions at
    the main path's shapes and a ragged f32 case, each timed beside its
    plain version, bare product and unfused sequence; returns their
    summary entries (times at the stage-1 join)."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entries = {}
    for i, (case, m, c, k, dt, res, extra) in enumerate(FUSED_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        d = fused_inputs(m, c, k, dtype, seed=200 + i)
        r = d["r"] if res else None
        g = d["dy"] if extra else None
        calls = fused_calls(d, dtype, r, g, extra)
        # the bare cuBLAS product of each kernel (the library yardstick) and
        # the unfused PyTorch sequence in the data dtype, both on the same
        # inputs; y is made outside the timing
        y = torch.relu(d["x"] * d["scale"].to(dtype) + d["shift"].to(dtype)
                       + (r if res else 0))
        lib = {"fwd": (lambda: y @ d["w"], "torch.matmul y @ W (cuBLAS)"),
               "dgrad": (lambda: d["dz"] @ d["w"].t(),
                         "torch.matmul dz @ W^T (cuBLAS)"),
               "wgrad": (lambda: y.t() @ d["dz"],
                         "torch.matmul y^T @ dz (cuBLAS)")}
        unfused = unfused_sequences(d, dtype, res, extra)
        rtol = fc.ROW_RTOL[dtype]
        work = fused_work(m, c, k, 2 if dt == "bf16" else 4, res, extra)
        for name, (kern, plain) in calls.items():
            # outputs held row by row; the f32 channel sums (zstats, q) by
            # their rows too, at 1e-4
            row_err, sum_err, abs_err, finite = fused_errors(name, kern,
                                                             plain)
            emit("fused_conv", kernel=f"fused_{name}", case=case,
                 shape=[m, c, k], dtype=dt, residual=res, want_y_extra=extra,
                 max_abs_err=abs_err, max_row_rel_err=row_err, rtol=rtol,
                 max_sum_rel_err=sum_err, sum_rtol=1e-4, finite=finite,
                 why=("per row, relative to the row's largest |plain|: one "
                      "rounding of bf16 outputs whose f32 sums run in "
                      "another order; f32: the order alone"))
            if not finite or row_err > rtol or sum_err > 1e-4:
                raise AssertionError(
                    f"fused {name} {case}: row err {row_err} > {rtol} or "
                    f"sum err {sum_err} > 1e-4")
            ms = time_ms(kern, flush=flush)
            plain_ms = time_ms(plain, reps=5, flush=flush)
            library_ms = time_ms(lib[name][0], flush=flush)
            unfused_ms = time_ms(unfused[name], flush=flush)
            flops, n_bytes = work[name]
            bound_ms, bound_by = bound(
                flops, n_bytes, BF16_FLOPS if dt == "bf16" else F32_FLOPS)
            emit("fused_conv", kernel=f"fused_{name}", case=case, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 library=lib[name][1], unfused_torch_ms=unfused_ms,
                 bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                 bytes=n_bytes, roofline_share=bound_ms / ms)
            if case == "stage1_join":
                entries[name] = {
                    "name": f"fused_conv_{name}", "route": "cuda",
                    "source": "bigdl_tpu_torch/csrc/fused_conv.cu",
                    "replaces": FUSED_REPLACES[name], "launches": None,
                    "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                    "max_row_rel_err": row_err}
        del d, y
        torch.cuda.empty_cache()
    fused_out_dtype_case(flush)
    return entries


def fused_out_dtype_case(flush):
    """The forward with an f32 z from bf16 rows (JAX's ``out_dtype=``;
    ``fwd_kernel<bf16, float>`` through ``bigdl_fused_fwd_zcast``) at the
    stage-1 join (residual and y) against its plain version: z per row at
    the f32 tolerance (exact bf16 products, f32 sums in another order),
    y per row at bf16's; its time beside the plain version, the default
    bf16-z kernel and the bound."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    case, m, c, k = "stage1_join", 256 * 56 * 56, 256, 64
    d = fused_inputs(m, c, k, torch.bfloat16, seed=200)

    def kern():
        return fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"], d["w"],
                                 d["r"], True, out_dtype=torch.float32)

    def plain():
        return fc.fused_fwd_reference(d["x"], d["scale"], d["shift"],
                                      d["w"], d["r"], True,
                                      out_dtype=torch.float32)

    before = fc.fwd_launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if fc.fwd_launches != before + 1:
        raise AssertionError("the f32-z forward did not launch its kernel")
    z_err = fc.max_row_rel_err(got[0], want[0])
    y_err = fc.max_row_rel_err(got[2], want[2])
    sum_err = fc.max_row_rel_err(got[1], want[1])
    abs_err = float((got[0] - want[0]).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    ztol, ytol = fc.ROW_RTOL[torch.float32], fc.ROW_RTOL[torch.bfloat16]
    ms = time_ms(kern, flush=flush)
    plain_ms = time_ms(plain, reps=5, flush=flush)
    default_ms = time_ms(lambda: fc.fused_fwd_cuda(
        d["x"], d["scale"], d["shift"], d["w"], d["r"], True), flush=flush)
    y = torch.relu(d["x"] * d["scale"].to(torch.bfloat16)
                   + d["shift"].to(torch.bfloat16) + d["r"])
    library_ms = time_ms(lambda: y @ d["w"], flush=flush)
    flops, n_bytes = fused_work(m, c, k, 2, True, True)["fwd"]
    n_bytes += m * k * 2                      # z is f32: 4 bytes, not 2
    bound_ms, bound_by = bound(flops, n_bytes, BF16_FLOPS)
    emit("fused_conv", kernel="fused_fwd_f32z", case=case, shape=[m, c, k],
         dtype="bf16 rows, f32 z", residual=True, want_y=True,
         max_abs_err=abs_err, z_row_rel_err=z_err, z_rtol=ztol,
         y_row_rel_err=y_err, y_rtol=ytol, max_sum_rel_err=sum_err,
         sum_rtol=1e-4, finite=finite, ms=ms, plain_ms=plain_ms,
         default_bf16_z_ms=default_ms, library_ms=library_ms,
         library="torch.matmul y @ W, bf16 out (cuBLAS)", bound_ms=bound_ms,
         bound_by=bound_by, roofline_share=bound_ms / ms)
    if not finite or z_err > ztol or y_err > ytol or sum_err > 1e-4:
        raise AssertionError(f"fused forward with an f32 z: z err {z_err}, "
                             f"y err {y_err}, sum err {sum_err}")
    del d, y, got, want
    torch.cuda.empty_cache()


# ResNet-50's fused edges at batch 256 (shortcut B, maybe_fuse with
# BIGDL_PALLAS_MIN_C=128; counted on the CPU at batch 1 through the port's
# plain versions): (M, C, K, residual with want_y and extra dy, launches per
# step). Each edge launches the forward, the dgrad and the wgrad once per
# step, so each kernel runs 28 times over these 10 (M, C, K).
RESNET50_EDGES = [(802816, 256, 64, True, 2), (802816, 256, 128, True, 1),
                  (200704, 128, 512, False, 4), (200704, 512, 128, True, 3),
                  (200704, 512, 256, True, 1), (50176, 256, 1024, False, 6),
                  (50176, 1024, 256, True, 5), (50176, 1024, 512, True, 1),
                  (12544, 512, 2048, False, 3), (12544, 2048, 512, True, 2)]


def fused_shapes_phase():
    """The three fused-conv kernels at every (M, C, K) of ResNet-50's step
    (bf16, batch 256): each held to its plain version at each (outputs row
    by row, the f32 sums at 1e-4), each kernel's median time beside its
    bound, the bare cuBLAS product and the unfused PyTorch sequence; then
    per kernel the sum over the step of launches x (time - bound), the time
    a kernel at its bound would save per step."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dtype = torch.bfloat16
    lost = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    kernel_ms = dict.fromkeys(lost, 0.0)
    rtol = fc.ROW_RTOL[dtype]
    for i, (m, c, k, res, n) in enumerate(RESNET50_EDGES):
        d = fused_inputs(m, c, k, dtype, seed=400 + i)
        r = d["r"] if res else None
        g = d["dy"] if res else None
        sc, sh = d["scale"].to(dtype), d["shift"].to(dtype)
        calls = fused_calls(d, dtype, r, g, res)
        errs = {}
        for name, (kern, plain) in calls.items():
            row_err, sum_err, _, finite = fused_errors(name, kern, plain)
            errs[name] = (row_err, sum_err)
            if not finite or row_err > rtol or sum_err > 1e-4:
                raise AssertionError(
                    f"fused {name} at {(m, c, k)}: row err {row_err} > "
                    f"{rtol} or sum err {sum_err} > 1e-4")
        torch.cuda.empty_cache()
        y = torch.relu(d["x"] * sc + sh + (r if res else 0))
        unfused = unfused_sequences(d, dtype, res, res)
        runs = {
            "fwd": (calls["fwd"][0], lambda: y @ d["w"], unfused["fwd"]),
            "dgrad": (calls["dgrad"][0], lambda: d["dz"] @ d["w"].t(),
                      unfused["dgrad"]),
            "wgrad": (calls["wgrad"][0], lambda: y.t() @ d["dz"],
                      unfused["wgrad"])}
        work = fused_work(m, c, k, 2, res, res)
        for name, (kern, lib, unf) in runs.items():
            t = time_stats(kern, flush=flush)
            lib_ms = time_stats(lib, flush=flush)["median"]
            unf_ms = time_stats(unf, flush=flush)["median"]
            bound_ms, bound_by = bound(*work[name], BF16_FLOPS)
            lost[name] += n * (t["median"] - bound_ms)
            kernel_ms[name] += n * t["median"]
            emit("fused_shapes", kernel=f"fused_{name}", shape=[m, c, k],
                 residual=res, launches_per_step=n, ms_median=t["median"],
                 ms_min_max=[t["min"], t["max"]],
                 host_ms_max=t["host_ms_max"], bound_ms=bound_ms,
                 bound_by=bound_by, roofline_share=bound_ms / t["median"],
                 cublas_ms=lib_ms, unfused_torch_ms=unf_ms,
                 max_row_rel_err=errs[name][0],
                 max_sum_rel_err=errs[name][1] if name != "wgrad" else None)
        del d, y
        torch.cuda.empty_cache()
    emit("fused_shapes", what="per ResNet-50 step (28 launches each)",
         kernel_ms_per_step=kernel_ms,
         launches_x_time_minus_bound_ms=lost)
    return lost


# (case, N, H, W, C, K, dtype): ResNet-50's four 3x3 conv shapes at batch
# 256 (the experiment's SHAPES, benchmarks/pallas_conv3x3_experiment.py:112-
# 117, C = K, bf16), a ragged f32 case and a one-pixel f32 case
CONV3X3_CASES = [("s1 56² 64", 256, 56, 56, 64, 64, "bf16"),
                 ("s2 28² 128", 256, 28, 28, 128, 128, "bf16"),
                 ("s3 14² 256", 256, 14, 14, 256, 256, "bf16"),
                 ("s4 7² 512", 256, 7, 7, 512, 512, "bf16"),
                 ("f32_ragged", 3, 13, 11, 40, 72, "f32"),
                 ("f32_tiny", 1, 1, 1, 3, 5, "f32")]
# the first two images against F.conv2d in f32 with TF32 off (the
# experiment's check, :141-148): a bf16 output is one bf16 rounding from the
# f32 result; an f32 output differs by sum order and by the algorithm cuDNN
# picks (a Winograd or FFT transform rounds in other places)
CONV3X3_LIB_RTOL = {"bf16": 1e-2, "f32": 1e-4}
CONV3X3_TIMED_CALLS = 3 + 30      # time_ms: 3 warm-up calls + 30 timed,
#                                   plus any launch it takes again


def conv3x3_phase():
    """The twin of the experiment's ``main()``: can the hand-written 3x3
    conv keep up with the library conv at ResNet-50's four 3x3 shapes?
    Each case is held to the plain version row by row and to F.conv2d;
    the ResNet shapes are then timed: the kernel through its C entry
    point, the wrapper (one launch on x as it lies), the plain version and
    cuDNN
    (F.conv2d on the channels-last bf16 tensor with the OIHW weight). The
    launch count over the phase is asserted; returns the kernel's summary
    entry (times at s1 56²)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import conv3x3 as cv

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lib_c = cv._library()
    stream = torch.cuda.current_stream().cuda_stream
    cv.launches = 0
    expected = 0
    entry = None
    for i, (case, n, h, w, c, k, dt) in enumerate(CONV3X3_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(n, h, w, c, device="cuda", generator=g).to(dtype)
        w9 = (torch.randn(9, c, k, device="cuda", generator=g) * 0.05
              ).to(dtype)
        got = cv.conv3x3(x, w9)
        expected += 1
        want = cv.conv3x3_reference(x, w9)
        lib_ref = F.conv2d(x[:2].float().permute(0, 3, 1, 2),
                           cv.oihw_from_w9(w9).float(), padding=1
                           ).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        rtol, lib_rtol = cv.ROW_RTOL[dtype], CONV3X3_LIB_RTOL[dt]
        row_err = cv.max_row_rel_err(got, want)
        lib_err = cv.max_row_rel_err(got[:2], lib_ref)
        abs_err = float((got.float() - want.float()).abs().max())
        finite = bool(torch.isfinite(got).all())
        emit("conv3x3", case=case, shape=[n, h, w, c, k], dtype=dt,
             max_abs_err=abs_err, max_row_rel_err=row_err, rtol=rtol,
             conv2d_f32_row_rel_err=lib_err, conv2d_rtol=lib_rtol,
             finite=finite,
             why=("per output pixel, relative to its largest |plain|: bf16 "
                  "outputs round once from f32 sums taken in another order; "
                  "f32: the order alone"))
        if not finite or row_err > rtol or lib_err > lib_rtol:
            raise AssertionError(
                f"conv3x3 {case}: row err {row_err} > {rtol} or conv2d err "
                f"{lib_err} > {lib_rtol}")
        del got, want, lib_ref
        if dt != "bf16":
            continue
        out = torch.empty(n, h, w, k, dtype=dtype, device="cuda")
        ms = time_ms(lambda: launched(lib_c.bigdl_conv3x3(
            x.data_ptr(), w9.data_ptr(), out.data_ptr(), n, h, w, c, k, 1,
            stream)), flush=flush)
        retaken = HOST_ENQUEUE["over_guard"] - HOST_ENQUEUE["kept_over_guard"]
        entry_ms = time_ms(lambda: cv.conv3x3(x, w9), flush=flush)
        # each launch time_stats took again (its enqueue outlasted the
        # guard) launched once more
        expected += CONV3X3_TIMED_CALLS + (
            HOST_ENQUEUE["over_guard"] - HOST_ENQUEUE["kept_over_guard"]
            - retaken)
        plain_ms = time_ms(lambda: cv.conv3x3_reference(x, w9), reps=5,
                           flush=flush)
        # the library: one cuDNN call on the same bf16 values, x as its
        # channels-last NCHW view, the OIHW weight channels-last too
        xl = x.permute(0, 3, 1, 2)
        wl = cv.oihw_from_w9(w9).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1),
                             flush=flush)
        lib_out = F.conv2d(xl, wl, padding=1).permute(0, 2, 3, 1)
        lib_vs_plain = cv.max_row_rel_err(lib_out, cv.conv3x3_reference(x, w9))
        del out, lib_out
        flops = 2.0 * n * h * w * c * k * 9
        n_bytes = (x.numel() + w9.numel() + n * h * w * k) * 2
        bound_ms, bound_by = bound(flops, n_bytes, BF16_FLOPS)
        emit("conv3x3", case=case, ms=ms, entry_ms=entry_ms,
             plain_ms=plain_ms, library_ms=library_ms,
             library="F.conv2d (cuDNN), channels-last bf16, OIHW weight",
             library_row_rel_err_vs_plain=lib_vs_plain,
             ratio_library_over_kernel=library_ms / ms,
             ratio_library_over_entry=library_ms / entry_ms,
             tflops_per_s=flops / ms / 1e9,
             library_tflops_per_s=flops / library_ms / 1e9, flops=flops,
             bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
             roofline_share=bound_ms / ms)
        if entry is None:
            entry = {"name": "conv3x3", "route": "cuda",
                     "source": "bigdl_tpu_torch/csrc/conv3x3.cu",
                     "replaces": "benchmarks/pallas_conv3x3_experiment.py:49",
                     "launches": None, "max_abs_err": abs_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "entry_ms": entry_ms, "max_row_rel_err": row_err,
                     "path": ("chip_smoke.py conv3x3 phase, the twin of the "
                              "experiment's main() (on no package path): "
                              "one checked call per case, 33 timed entry "
                              "calls per ResNet-50 shape; ms is the kernel "
                              "through its C entry point, entry_ms one "
                              "launch through the wrapper, both at s1 "
                              "56² 64")}
        del x, w9, xl, wl
        torch.cuda.empty_cache()
    if cv.launches != expected:
        raise AssertionError(f"conv3x3 launched {cv.launches} times, "
                             f"expected {expected}")
    entry["launches"] = cv.launches
    return entry


def tiny_bottleneck(device, planes=8, seed=0):
    """A twin of tests/test_tpu_fusion.py::tiny_bottleneck: a conv-BN-ReLU
    stem, two bottleneck blocks (the second strided, projection
    shortcuts), global average pooling and a Linear head."""
    import torch

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.models.resnet import _Builder

    b = _Builder(device, torch.Generator(device=device).manual_seed(seed))
    inp = tnn.Input()
    x = b.conv(3, 2 * planes, 3, 1, 1).inputs(inp)
    x = tnn.ReLU(True).inputs(b.bn(2 * planes).inputs(x))
    n_in = 2 * planes
    x, n_in = b.residual(x, n_in, planes, 1, b.bottleneck_block, "B", True)
    x, n_in = b.residual(x, n_in, 2 * planes, 2, b.bottleneck_block, "B",
                         True)
    x = tnn.SpatialAveragePooling(4, 4, 1, 1).inputs(x)
    x = tnn.Reshape([n_in], batch_mode=True).inputs(x)
    return tnn.Graph(inp, b.linear(n_in, 10).inputs(x))


def resnet_check_phase():
    """The fused bottleneck graph's three f32 SGD train steps (momentum
    0.9, weight decay 1e-4) on the card, every edge on the kernels
    (threshold 8), against the same steps on the CPU (plain versions).
    Tolerances: losses 1e-5 relative; parameters and BN running statistics
    5e-5 absolute (f32 on both sides, sums and cuDNN's convolutions in
    other orders; the CPU parity tests hold the port to JAX at 1e-5 on
    the same recipe)."""
    import os

    import torch

    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph
    from bigdl_tpu_torch.ops import fused_conv as fc
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "8"
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((4, 3, 8, 8)).astype(np.float32),
                rng.integers(1, 11, size=4).astype(np.int32))
               for _ in range(3)]
    results = []
    fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
    try:
        for dev in ("cpu", "cuda"):
            model = FusedGraph(tiny_bottleneck("cpu")).to(dev)
            with torch.no_grad():      # non-zero gammas: every block passes
                for p in model.parameters():
                    if p.dim() == 1:
                        p.add_(0.3)
            sgd = SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
            step = make_train_step(model, CrossEntropyCriterion(), sgd)
            params = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            state = {k: b.detach().clone() for k, b in model.named_buffers()}
            opt = sgd.init_state(params)
            model.train()
            losses = []
            for x, y in batches:
                params, opt, state, loss = step(
                    params, opt, state, None, torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).to(dev))
                losses.append(float(loss))
            results.append((losses, [p.cpu() for p in params.values()],
                            [b.cpu() for b in state.values()]))
    finally:
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    (l_cpu, p_cpu, s_cpu), (l_gpu, p_gpu, s_gpu) = results
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    stat_err = max(float((a - b).abs().max()) for a, b in zip(s_gpu, s_cpu))
    launches = [fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches]
    emit("resnet_check", what="3 f32 SGD steps, fused bottleneck graph "
         "(4 kernel edges), card vs CPU", losses_cpu=l_cpu, losses_card=l_gpu,
         loss_rel_err=loss_err, param_max_abs_err=param_err,
         bn_stat_max_abs_err=stat_err, tol_loss=1e-5, tol_param=5e-5,
         tol_stat=5e-5, card_fused_launches=launches)
    if not (loss_err <= 1e-5 and param_err <= 5e-5 and stat_err <= 5e-5):
        raise AssertionError(f"card vs CPU resnet steps: loss {loss_err}, "
                             f"params {param_err}, stats {stat_err}")
    if launches != [12, 12, 12]:           # 4 edges x 3 steps, card only
        raise AssertionError(f"fused launches {launches}, expected 12 each")


def resnet_run(fuse: bool, warm: int, timed: int, batch: int = 256):
    """ResNet-50 trained through ``optimize()`` on one seeded batch (bf16
    compute, SGD 0.1 / momentum 0.9 / weight decay 1e-4, the recipe of
    bench.py:33-67); returns (losses, step seconds, peak GiB, wall s)."""
    import torch

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import maybe_fuse
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    model = ResNet(1000, {"depth": 50, "shortcutType": "B"}, seed=0)
    if fuse:
        model = maybe_fuse(model)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 3, 224, 224), dtype=np.float32)
    y = rng.integers(1, 1001, size=batch).astype(np.int32)
    samples = [Sample(x[i], y[i]) for i in range(batch)]
    steps = warm + timed
    losses = []

    def record_then_stop(state):       # the trigger reads every step's loss
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] > steps

    opt = Optimizer(model, samples, CrossEntropyCriterion(), batch_size=batch,
                    end_trigger=Trigger(record_then_stop,
                                        Trigger.max_iteration(steps).peek))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             weight_decay=1e-4)).set_compute_dtype("bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_s = opt.metrics.values("computing time")[warm:]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del opt, model, samples
    torch.cuda.empty_cache()
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"resnet losses {losses}")
    return losses, step_s, peak, wall


def resnet_train_phase(warm: int = 2, timed: int = 5, batch: int = 256):
    """The ResNet-50 training path at full size, fused with
    BIGDL_PALLAS_MIN_C=128; returns the fused kernels' launch counts over
    its ``optimize()`` run. The unfused Graph runs the same recipe after
    it, for comparison."""
    import os

    from bigdl_tpu_torch.ops import fused_conv as fc

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "128"
    try:
        fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
        losses, step_s, peak, wall = resnet_run(True, warm, timed, batch)
        launches = {"fwd": fc.fwd_launches, "dgrad": fc.dgrad_launches,
                    "wgrad": fc.wgrad_launches}
    finally:
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    steps = warm + timed
    for name, n in launches.items():
        if n != 28 * steps:
            raise AssertionError(f"fused {name} launched {n} times, expected "
                                 f"28 edges x {steps} steps")
    p50 = float(np.median(step_s))
    u_losses, u_step_s, u_peak, _ = resnet_run(False, warm, timed, batch)
    u_p50 = float(np.median(u_step_s))
    emit("resnet_train", model="ResNet-50", batch=batch, image=224,
         compute="bf16", optim="SGD(0.1, momentum 0.9, weight decay 1e-4)",
         fused="maybe_fuse, BIGDL_PALLAS_MIN_C=128", steps=steps,
         timed_steps=timed, step_ms=[s * 1e3 for s in step_s], wall_s=wall,
         fused_launches=launches, peak_mem_gib=peak, losses=losses,
         loss_fell=bool(losses[-1] < losses[0]),
         unfused_step_ms=[s * 1e3 for s in u_step_s],
         unfused_peak_mem_gib=u_peak, unfused_losses=u_losses)
    print(json.dumps({"resnet50_step_ms_p50": p50 * 1e3,
                      "images_per_s": batch / p50, "peak_mem_gib": peak,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "unfused_step_ms_p50": u_p50 * 1e3,
                      "unfused_images_per_s": batch / u_p50,
                      "unfused_peak_mem_gib": u_peak}))
    return launches


def resnet_main_phase():
    """ResNet's own main at full width: ``train_main`` on ImageNet-shaped
    synthetic data (ResNet-50, shortcut B, batch 128, 8 iterations, bf16,
    nesterov SGD) with ``--summary`` and ``--cache``; then the cifar10
    main (ResNet-20, 16 iterations). No port kernel runs on this path:
    ``train_main`` builds the unfused graph, as the JAX main does."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.models.resnet import train_main
    from bigdl_tpu_torch.nn.module import AbstractModule
    from bigdl_tpu_torch.visualization import TrainSummary

    work = tempfile.mkdtemp(prefix="resnet_main_")
    try:
        d1, d2 = os.path.join(work, "summary"), os.path.join(work, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = train_main(["--dataset", "imagenet", "--synthetic", "512",
                            "-b", "128", "--maxIteration", "8", "--summary",
                            d1, "--cache", d2, "--computeDtype", "bf16"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ts = TrainSummary(d1, "train")
        scalars = {tag: ts.read_scalar(tag)
                   for tag in ("Loss", "Throughput", "LearningRate")}
        ts.close()
        losses = [v for _, v in scalars["Loss"]]
        step_s = [128 / v for _, v in scalars["Throughput"]]
        loaded = AbstractModule.load(os.path.join(d2, "model"))
        same = all(torch.equal(a, b) for a, b in zip(loaded.parameters(),
                                                      model.parameters()))
        n_loaded = sum(1 for _ in loaded.parameters())
        del model, loaded
        torch.cuda.empty_cache()
        cifar = train_main(["--dataset", "cifar10", "--synthetic", "1024",
                            "-b", "128", "--maxIteration", "16"])
        cifar_finite = all(bool(torch.isfinite(p).all())
                           for p in cifar.parameters())
        del cifar
        emit("resnet_main", what="train_main --dataset imagenet (ResNet-50 "
             "B, 224², batch 128, bf16, nesterov SGD 0.1/0.9) 8 iterations "
             "--summary --cache; then --dataset cifar10 (ResNet-20) 16",
             card=nvidia_smi(), wall_s=wall, losses=losses,
             step_ms=[s * 1e3 for s in step_s],
             step_ms_p50=float(np.median(step_s[1:])) * 1e3,
             peak_mem_gib=peak,
             scalars={k: len(v) for k, v in scalars.items()},
             learning_rates=[v for _, v in scalars["LearningRate"]],
             checkpoint=sorted(os.listdir(d2)),
             checkpoint_equals_model=same, checkpoint_params=n_loaded,
             cifar10_finite=cifar_finite)
        if {k: len(v) for k, v in scalars.items()} != {
                "Loss": 8, "Throughput": 8, "LearningRate": 8}:
            raise AssertionError(f"summary scalars {scalars}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"resnet_main losses {losses}")
        if not (same and n_loaded == 161):
            raise AssertionError("the --cache checkpoint does not hold the "
                                 "trained parameters")
        if not cifar_finite:
            raise AssertionError("cifar10 train_main ended non-finite")
    finally:
        shutil.rmtree(work, ignore_errors=True)


FIXTURES = ("tests", "data", "jpeg")     # committed JPEGs, hashes.json


def fixture_blobs():
    """(names, bytes, {name: {"shape", "sha256"}}) of the committed JPEG
    fixtures, read from this checkout."""
    import os

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        *FIXTURES)
    with open(os.path.join(root, "hashes.json")) as f:
        hashes = json.load(f)
    names = sorted(hashes)
    blobs = []
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            blobs.append(f.read())
    return names, blobs, hashes


def png_bytes(px, ctype: int) -> bytes:
    """An 8-bit PNG of ``px`` (H, W, channels) of color type ``ctype``
    (0, 2, 4, 6; 3 with a 256-entry grey palette), its rows filtered with
    types 0-4 in turn."""
    import struct
    import zlib

    h, w, ch = px.shape
    raw = px.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        ft, cur = y % 5, raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0 * cur, left, up, (left + up) // 2, paeth][ft]
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if ctype == 3:
        out += chunk(b"PLTE", np.repeat(np.arange(256, dtype=np.uint8),
                                        3).tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(
        b"IEND", b"")


def data_plane_phase():
    """The native host runtime (see the phase list): the g++ build, the
    committed JPEG fixtures against the hashes the CPU test recorded,
    PNGs written here against their pixels, decode rates, ``recs_index``
    over a 512-record shard and a Hadoop → RECS conversion."""
    import hashlib
    import os
    import shutil
    import subprocess
    import tempfile

    from bigdl_tpu_torch.dataset import hadoop_seqfile as hs
    from bigdl_tpu_torch.dataset.seqfile import read_shard, write_shards
    from bigdl_tpu_torch.native import (
        build, decode_image, decode_images, library, recs_index,
    )

    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    path = build.build_library()
    library()
    build_s = time.perf_counter() - t0
    names, blobs, hashes = fixture_blobs()
    decoded = decode_images(blobs, n_threads=4, names=names)
    bad = [n for n, a in zip(names, decoded)
           if list(a.shape) != hashes[n]["shape"]
           or hashlib.sha256(a.tobytes()).hexdigest() != hashes[n]["sha256"]]
    rng = np.random.default_rng(7)
    png_ok = {}
    for ctype, ch in ((0, 1), (2, 3), (3, 1), (4, 2), (6, 4)):
        px = rng.integers(0, 256, (37, 53, ch), dtype=np.uint8)
        want = px[:, :, :3] if ch >= 3 else np.repeat(px[:, :, :1], 3, 2)
        png_ok[ctype] = bool(np.array_equal(
            decode_image(png_bytes(px, ctype)), want))
    batch = blobs * 16
    rate = {}
    for threads in (1, 4):
        decode_images(batch[:8], n_threads=threads)            # warm
        t0 = time.perf_counter()
        decode_images(batch, n_threads=threads)
        rate[threads] = len(batch) / (time.perf_counter() - t0)
    work = tempfile.mkdtemp(prefix="data_plane_")
    try:
        recs = [(i % 8 + 1, blobs[i % 8]) for i in range(512)]
        (shard,) = write_shards(recs, os.path.join(work, "recs"), 1)
        buf = np.fromfile(shard, np.uint8)
        index_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            labels, _, _ = recs_index(buf)
            index_ms.append((time.perf_counter() - t0) * 1e3)
        seq = os.path.join(work, "seq")
        os.makedirs(seq)
        for f in range(4):
            with hs.SequenceFileWriter(os.path.join(seq, f"part-{f:05d}"),
                                       sync_interval=100_000, seed=f) as w:
                for i in range(f, 512, 4):
                    w.append(f"{names[i % 8]} {recs[i][0]}", recs[i][1])
        t0 = time.perf_counter()
        shards = hs.convert_to_recs(seq, os.path.join(work, "converted"),
                                    n_shards=4)
        convert_s = time.perf_counter() - t0
        back = sorted(r for p in shards for r in read_shard(p))
        converted_equal = back == sorted(recs)
        shard_mb = buf.size / 2 ** 20
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("data_plane", card=nvidia_smi(), gxx=gxx, build_s=build_s,
         library=os.path.basename(path), fixtures=len(names),
         fixtures_off_their_hash=bad, png_color_types_equal=png_ok,
         decode_images_per_s={f"{k}_threads": v for k, v in rate.items()},
         decode_batch=f"{len(batch)} JPEGs (the 8 fixtures x 16, 199x257 "
         "to 640x480)", recs_records=int(len(labels)),
         recs_shard_mb=shard_mb, recs_index_ms_median=float(
             np.median(index_ms)), recs_index_ms=index_ms,
         hadoop_to_recs_s=convert_s, hadoop_files=4, recs_shards=4,
         records_byte_equal=converted_equal)
    if bad or not all(png_ok.values()) or len(labels) != 512 or \
            not converted_equal:
        raise AssertionError(f"data plane: fixtures {bad}, png {png_ok}, "
                             f"{len(labels)} records indexed, conversion "
                             f"equal {converted_equal}")
    return rate


FEEDS = {"u8_nhwc": "u8_nhwc + DeviceImageNormalizer",
         "f32_nchw": "f32_nchw through NativeLoader (C++ normalize)",
         "f32_numpy": "f32_nchw, the numpy iterator (plain_iter)"}
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
FUSED_TRACE_NAMES = {"fwd": ("fwd_wgmma", "fwd_panel_wgmma", "fwd_kernel"),
                     "dgrad": ("dgrad_wgmma", "dgrad_kernel"),
                     "wgrad": ("wgrad_wgmma", "wgrad_kernel")}


def plain_feed(pipe):
    """``pipe`` as a dataset whose batches come from its numpy iterator
    (``plain_iter``), the f32 feed before the native loader."""
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet

    class Plain(AbstractDataSet):
        def size(self) -> int:
            return pipe.size()

        def data(self, train: bool):
            return pipe.plain_iter(train)

    return Plain()


def resnet_u8_run(feed, images, labels, eval_images, eval_labels, steps,
                  work):
    """ResNet-50 (``maybe_fuse``, bf16, the bench.py:33-67 SGD recipe)
    trained ``steps`` iterations through ``optimize()`` on
    ``NativeImagePipeline`` batches of 256 (crop 224, pad 0) fed by
    ``feed`` (``FEEDS``), with train and validation summaries, a Top-1
    validation every epoch on a 256-image eval pipeline and a profile of
    iterations 3 and 4; returns what the phase checks and prints."""
    import os

    import torch

    from bigdl_tpu_torch.dataset import NativeImagePipeline
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import maybe_fuse
    from bigdl_tpu_torch.ops import fused_conv as fc
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    output = "u8_nhwc" if feed == "u8_nhwc" else "f32_nchw"

    def pipe(imgs, labs):
        p = NativeImagePipeline(imgs, labs, batch_size=256, crop=(224, 224),
                                mean=IMAGENET_MEAN, std=IMAGENET_STD, pad=0,
                                seed=0, output=output)
        return plain_feed(p) if feed == "f32_numpy" else p

    train = pipe(images, labels)
    stream = timed_stream(train)
    model = maybe_fuse(ResNet(1000, {"depth": 50, "shortcutType": "B"},
                              seed=0))
    opt = Optimizer(model, stream, CrossEntropyCriterion(),
                    end_trigger=Trigger.max_iteration(steps))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             weight_decay=1e-4)).set_compute_dtype("bf16")
    if output == "u8_nhwc":
        opt.set_device_preprocess(train.device_normalizer())
    logs = os.path.join(work, feed)
    ts, vs = TrainSummary(logs, "job"), ValidationSummary(logs, "job")
    trace_dir = os.path.join(logs, "trace")
    opt.set_train_summary(ts).set_val_summary(vs)
    opt.set_validation(Trigger.every_epoch(), pipe(eval_images, eval_labels),
                       [Top1Accuracy()])
    opt.set_profile(trace_dir, start_iteration=3, n_iterations=2)
    place = {"s": 0.0, "bytes": 0, "n": 0}
    prepare = opt._prepare

    def timed_prepare():
        step, place_batch, *rest = prepare()

        def timed(batch):
            t = time.perf_counter()
            out = place_batch(batch)
            place["s"] += time.perf_counter() - t
            place["bytes"] += batch.input.nbytes + batch.target.nbytes
            place["n"] += 1
            return out

        return (step, timed, *rest)

    opt._prepare = timed_prepare
    val = {"launches": [0, 0, 0], "s": 0.0}
    run_validation = opt._run_validation

    def counted_validation(*args):
        before = (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches)
        t = time.perf_counter()
        try:
            return run_validation(*args)
        finally:
            val["s"] += time.perf_counter() - t
            after = (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches)
            val["launches"] = [v + a - b for v, a, b in
                               zip(val["launches"], after, before)]

    opt._run_validation = counted_validation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fc.fwd_launches, "dgrad": fc.dgrad_launches,
                "wgrad": fc.wgrad_launches}
    ts.close()
    vs.close()
    step_s = opt.metrics.values("computing time")
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    traced = {k: sum(1 for n in names if any(s in n for s in subs))
              for k, subs in FUSED_TRACE_NAMES.items()}
    out = {"losses": [v for _, v in ts.read_scalar("Loss")],
           "top1": vs.read_scalar("Top1Accuracy"), "step_s": step_s,
           "wall_s": wall, "launches": launches,
           "validation_launches": val["launches"], "validation_s": val["s"],
           "place_s": place["s"], "placed": place["n"],
           "bytes_per_step": place["bytes"] / place["n"],
           "pipeline_s": stream.fetch_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "trace_file": trace_file, "traced_kernels": traced}
    del opt, model
    torch.cuda.empty_cache()
    return out


def native_feed_check(images, labels, batches: int = 3) -> dict:
    """The native f32 feed's first batches against the numpy iterator's
    on the phase's images: labels (order) equal and values within an ulp
    (the crops and flips are the same draws; ``(x - m) * (1 / s)``
    against ``(x - m) / s``)."""
    from bigdl_tpu_torch.dataset import NativeImagePipeline

    pipe = NativeImagePipeline(images, labels, batch_size=256,
                               crop=(224, 224), mean=IMAGENET_MEAN,
                               std=IMAGENET_STD, seed=0)
    native, plain = pipe.data(True), pipe.plain_iter(True)
    worst, same_labels, differ = 0, True, 0
    t = {"native_s": 0.0, "numpy_s": 0.0}
    try:
        for _ in range(batches):
            t0 = time.perf_counter()
            a = next(native)
            t1 = time.perf_counter()
            b = next(plain)
            t["native_s"] += t1 - t0
            t["numpy_s"] += time.perf_counter() - t1
            same_labels &= bool(np.array_equal(a.target, b.target))
            ia = a.input.view(np.int32).astype(np.int64)
            ib = b.input.view(np.int32).astype(np.int64)
            worst = max(worst, int(np.abs(ia - ib).max()))
            differ += int((ia != ib).sum())
    finally:
        native.close()
    return {"labels_equal": same_labels, "max_ulp_diff": worst,
            "values_differing": differ,
            "values": batches * 256 * 3 * 224 * 224,
            "native_s_per_batch": t["native_s"] / batches,
            "numpy_s_per_batch": t["numpy_s"] / batches}


def resnet_u8_phase(steps: int = 6):
    """The u8-NHWC feed against the f32-NCHW feed through NativeLoader and
    through the numpy iterator on the fused ResNet-50 (see the phase
    list); returns the fused kernels' launch counts over the three
    runs."""
    import os
    import shutil
    import tempfile

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "128"
    work = tempfile.mkdtemp(prefix="resnet_u8_")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (512, 256, 256, 3), dtype=np.uint8)
    labels = rng.integers(1, 1001, 512).astype(np.int32)
    eval_images = rng.integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)
    eval_labels = rng.integers(1, 1001, 256).astype(np.int32)
    try:
        feed_check = native_feed_check(images, labels)
        runs = {feed: resnet_u8_run(feed, images, labels, eval_images,
                                    eval_labels, steps, work)
                for feed in FEEDS}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    validations = steps // 2                 # every epoch of 2 batches
    u8, f32, f32np = runs["u8_nhwc"], runs["f32_nchw"], runs["f32_numpy"]
    rel = max(abs(a - b) / abs(b) for r in (f32, f32np)
              for a, b in zip(u8["losses"], r["losses"]))
    card = nvidia_smi()
    emit("resnet_u8", what="native f32 batches against the numpy "
         "iterator's (3 batches of 256, 224² crops of 256² u8)", card=card,
         **feed_check)
    if not (feed_check["labels_equal"]
            and feed_check["max_ulp_diff"] <= 1):
        raise AssertionError(f"native f32 feed differs from the numpy "
                             f"iterator: {feed_check}")
    for out, r in runs.items():
        p50 = float(np.median(r["step_s"][1:]))
        emit("resnet_u8", card=card, feed=FEEDS[out], steps=steps,
             batch=256, image="256² u8, crop 224", compute="bf16",
             step_ms=[s * 1e3 for s in r["step_s"]], step_ms_p50=p50 * 1e3,
             images_per_s=256 / p50, wall_s=r["wall_s"],
             bytes_uploaded_per_step=r["bytes_per_step"],
             place_batch_s=r["place_s"], batches_placed=r["placed"],
             place_batch_share=r["place_s"] / sum(r["step_s"]),
             host_pipeline_s=r["pipeline_s"],
             host_pipeline_share=r["pipeline_s"] / sum(r["step_s"]),
             validation_s=r["validation_s"], top1=r["top1"],
             losses=r["losses"], fused_launches=r["launches"],
             validation_fused_launches=r["validation_launches"],
             peak_mem_gib=r["peak_mem_gib"], trace=r["trace_file"],
             traced_fused_kernels=r["traced_kernels"])
    emit("resnet_u8", what="u8 vs f32 feeds' losses (native and numpy)",
         loss_max_rel_diff=rel, tol=1e-3)
    summary = {}
    for key, r in (("u8", u8), ("f32_native", f32), ("f32_numpy", f32np)):
        summary[f"resnet_{key}_step_ms_p50"] = float(
            np.median(r["step_s"][1:])) * 1e3
        summary[f"resnet_{key}_bytes_per_step"] = r["bytes_per_step"]
        summary[f"resnet_{key}_place_batch_share"] = (
            r["place_s"] / sum(r["step_s"]))
        summary[f"resnet_{key}_pipeline_share"] = (
            r["pipeline_s"] / sum(r["step_s"]))
    print(json.dumps(summary))
    total = {"fwd": 0, "dgrad": 0, "wgrad": 0}
    for out, r in runs.items():
        val = r["validation_launches"]
        train = {k: n - v for (k, n), v in zip(r["launches"].items(), val)}
        if train != {"fwd": 28 * steps, "dgrad": 28 * steps,
                     "wgrad": 28 * steps} or val != [28 * validations, 0, 0]:
            raise AssertionError(f"{out}: fused launches {r['launches']}, "
                                 f"{val} of them in validation; expected "
                                 f"28 per step and 28 per eval batch")
        if len(r["top1"]) != validations:
            raise AssertionError(f"{out}: Top1 scalars {r['top1']}, "
                                 f"expected {validations}")
        if min(r["traced_kernels"].values()) < 1:
            raise AssertionError(f"{out}: the profile trace names fused "
                                 f"kernels {r['traced_kernels']}")
        if not (len(r["losses"]) == steps and np.isfinite(r["losses"]).all()):
            raise AssertionError(f"{out}: losses {r['losses']}")
        for k in total:
            total[k] += r["launches"][k]
    if not rel <= 1e-3:
        raise AssertionError(f"u8 and f32 feed losses differ by {rel}")
    return total


PREEMPT_WORKER = r'''
import sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from bigdl_tpu_torch.dataset.cifar import load_samples
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, TrainingPreempted, Trigger

mode, ckpt, out = sys.argv[1:4]


def report(s):
    print("STEP", s["neval"], flush=True)
    if s["neval"] >= 3:
        time.sleep(0.2)        # the parent's SIGTERM lands here
    return s["neval"] > 100000


end = (Trigger(report, lambda s: s["neval"] > 100000) if mode == "evict"
       else Trigger.max_iteration(8))
model = ResNet(10, {"depth": 20, "shortcutType": "A", "dataSet": "cifar10"},
               seed=0)
opt = Optimizer(model, load_samples("/nonexistent", "train",
                                    synthetic_count=1024),
                CrossEntropyCriterion(), batch_size=128, end_trigger=end)
opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9, nesterov=True))
if mode != "full":
    opt.set_checkpoint(ckpt, Trigger(lambda s: False))
if mode == "evict":
    opt.handle_preemption()
try:
    opt.optimize(resume=mode == "resume")
except TrainingPreempted as e:
    print("PREEMPTED", opt.optim_method.state["neval"], e, flush=True)
    sys.exit(7)
torch.save([p.detach().cpu() for p in model.parameters()], out)
print("DONE", opt.optim_method.state["neval"], flush=True)
'''


def resnet_preempt_phase():
    """SIGTERM through ``handle_preemption`` on the card: a worker process
    trains ResNet-20 (``train_main``'s cifar10 recipe: synthetic CIFAR,
    batch 128, nesterov SGD 0.1/0.9) with a checkpoint path; the parent
    sends SIGTERM once the worker's trigger reports iteration 3; the
    worker must exit with ``TrainingPreempted`` after writing the
    checkpoint at the iteration it stopped at. A second process resumes
    to iteration 8, a third trains to 8 without a stop: parameters
    bitwise equal under ``cudnn.deterministic``."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="resnet_preempt_")
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(PREEMPT_WORKER)
    ckpt = os.path.join(work, "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))

    def run(mode, out=""):
        return subprocess.Popen(
            [sys.executable, script, mode, ckpt, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    try:
        t0 = time.perf_counter()
        proc = run("evict")
        try:
            line, seen = "", []
            while True:
                line = proc.stdout.readline()
                seen.append(line)
                if line.strip() == "STEP 3" or line == "":
                    break
            if line.strip() != "STEP 3":
                raise AssertionError("the worker never reached iteration 3: "
                                     + "".join(seen)[-3000:])
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        evict_s = time.perf_counter() - t0
        if proc.returncode != 7 or "PREEMPTED" not in rest:
            raise AssertionError(f"worker rc {proc.returncode}: "
                                 f"{rest[-3000:]}")
        stop = int(rest.split("PREEMPTED", 1)[1].split()[0])
        from bigdl_tpu_torch.utils.file_io import File

        ck_neval = File.load(os.path.join(ckpt, "optimMethod"))["neval"]
        outs = {m: os.path.join(work, f"{m}.pt") for m in ("resume", "full")}
        procs = {m: run(m, outs[m]) for m in outs}     # side by side
        try:
            for mode, p in procs.items():
                text, _ = p.communicate(timeout=600)
                if p.returncode != 0 or "DONE 9" not in text:
                    raise AssertionError(f"{mode} rc {p.returncode}: "
                                         f"{text[-3000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        resumed, full = (torch.load(outs[m]) for m in ("resume", "full"))
        diff = max(float((a - b).abs().max()) for a, b in zip(resumed, full))
        emit("resnet_preempt", what="ResNet-20 cifar10 recipe, SIGTERM at "
             "iteration 3, resume to 8 vs uninterrupted, "
             "cudnn.deterministic", card=nvidia_smi(), stopped_at=stop,
             checkpoint_neval=ck_neval, checkpoint=sorted(os.listdir(ckpt)),
             evict_s=evict_s, wall_s=time.perf_counter() - t0,
             max_abs_diff=diff, params=len(full))
        if stop != ck_neval or stop < 3:
            raise AssertionError(f"stopped at {stop}, checkpoint at "
                                 f"{ck_neval}")
        if diff != 0.0:
            raise AssertionError(f"resumed ResNet-20 differs from the "
                                 f"uninterrupted run by {diff}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def timed_stream(inner):
    """``inner`` (a dataset of MiniBatches) whose training iterator adds
    the host seconds spent producing each batch (the pipeline: shuffle,
    normalize, stack) to its ``fetch_s``."""
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet

    class Timed(AbstractDataSet):
        fetch_s = 0.0

        def size(self) -> int:
            return inner.size()

        def data(self, train: bool):
            it = inner.data(train)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    self.fetch_s += time.perf_counter() - t0
                    yield batch
            finally:
                getattr(it, "close", lambda: None)()   # a native feed's loader

    return Timed()


def lenet_run(device, samples, test_set, epochs, seed, ckpt=None,
              resume=False, validate=False):
    """LeNet-5 trained through ``Optimizer`` with the recipe of
    ``train_main`` (batch 128, SGD 0.05 / momentum 0.9, normalized
    MNIST), from weights drawn on the CPU from ``seed``; returns (model,
    optimizer, timed stream)."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy

    model = LeNet5(10, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).to(device)
    stream = timed_stream(
        DataSet.array(samples)
        >> GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
        >> SampleToMiniBatch(128))
    opt = Optimizer(model, stream, ClassNLLCriterion(),
                    end_trigger=Trigger.max_epoch(epochs))
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.every_epoch())
    if validate:
        opt.set_validation(Trigger.every_epoch(), test_set,
                           [Top1Accuracy(), Loss()], 128)
    opt.optimize(resume=resume)
    return model, opt, stream


def max_param_diff(a, b) -> float:
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def lenet_phase(device="cuda", n_train=60000, n_test=10000, epochs=2,
                card_steps=20):
    """BASELINE config #1: LeNet-5 on MNIST-sized generated idx data
    through LocalOptimizer (see the phase list). No port kernel runs on
    this path: its 5x5 convolutions are cuDNN's ``F.conv2d``."""
    import copy
    import logging
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.dataset import DataSet, MiniBatch, SampleToMiniBatch
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer
    from bigdl_tpu_torch.models.lenet import LeNet5, test_main, train_main
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    on_card = device == "cuda"
    work = tempfile.mkdtemp(prefix="lenet_")
    lines = []

    class Validation(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("validation ["):
                lines.append(msg)

    log = logging.getLogger("bigdl_tpu_torch")
    handler = Validation()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        mnist.generate_idx_dataset(work, n_train=n_train, n_test=n_test,
                                   seed=7, noise=220.0)
        gen_s = time.perf_counter() - t0
        # 1-3: the mains, on the device they default to
        ckpt = os.path.join(work, "main_ckpt")
        dev_args = [] if on_card else ["--device", device]
        torch.manual_seed(0)
        t0 = time.perf_counter()
        train_main(["-f", work, "-b", "128", "--learningRate", "0.05",
                    "--maxEpoch", str(epochs), "--cache", ckpt] + dev_args)
        main_s = time.perf_counter() - t0
        (res,) = test_main(["-f", work, "--model",
                            os.path.join(ckpt, "model")] + dev_args)
        top1, scored = res.result()
        emit("lenet", what="train_main + test_main", epochs=epochs,
             train_images=n_train, test_images=n_test, gen_s=gen_s,
             train_main_s=main_s, top1=top1, scored=scored,
             checkpoints=sorted(os.listdir(ckpt)))
        if not (scored == n_test and top1 >= 0.97):
            raise AssertionError(f"LeNet test_main Top-1 {top1} on {scored} "
                                 "images, expected >= 0.97")
        # 4: the Optimizer API with validation every epoch, measured
        samples = mnist.load_samples(work, "train", synthetic_fallback=False)
        test_set = (DataSet.array(mnist.load_samples(
            work, "test", synthetic_fallback=False))
            >> GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD))
        if on_card:
            torch.backends.cudnn.deterministic = False
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        val_s = []
        run = Optimizer._run_validation

        def timed_validation(self, *args):
            t = time.perf_counter()
            try:
                return run(self, *args)
            finally:
                val_s.append(time.perf_counter() - t)

        Optimizer._run_validation = timed_validation
        try:
            t0 = time.perf_counter()
            whole, opt, stream = lenet_run(device, samples, test_set, epochs,
                                           seed=5, validate=True)
            wall = time.perf_counter() - t0
        finally:
            Optimizer._run_validation = run
        peak = (torch.cuda.max_memory_allocated() / 2 ** 20 if on_card
                else None)
        step_s = opt.metrics.values("computing time")
        steps = len(step_s)
        train_wall = wall - sum(val_s)
        p50 = float(np.median(step_s))
        if len(lines) != 2 * epochs:
            raise AssertionError(f"{len(lines)} validation lines for "
                                 f"{epochs} epochs: {lines}")
        counts = None
        if on_card:
            def eight_steps():
                m = copy.deepcopy(whole)
                o = Optimizer(m, DataSet.array(samples[:1024])
                              >> GreyImgNormalizer(mnist.TRAIN_MEAN,
                                                   mnist.TRAIN_STD)
                              >> SampleToMiniBatch(128),
                              ClassNLLCriterion(),
                              end_trigger=Trigger.max_iteration(8))
                o.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
                o.optimize()
            eight_steps()                             # warm
            counts = window_counts(eight_steps, "lenet_train", 8)
        emit("lenet", what="Optimizer with validation every epoch",
             card=nvidia_smi() if on_card else device, epochs=epochs,
             steps=steps, validation=lines,
             step_ms_p50=p50 * 1e3,
             step_ms_p90=float(np.percentile(step_s, 90)) * 1e3,
             records_per_s=128 / p50,
             epoch_wall_s=train_wall / epochs,
             pipeline_s_per_epoch=stream.fetch_s / epochs,
             pipeline_share=stream.fetch_s / train_wall,
             outside_step_share=(train_wall - sum(step_s)
                                 + stream.fetch_s) / train_wall,
             validation_s=val_s, peak_mem_mib=peak, per_step=counts)
        # 5: resume = uninterrupted, bitwise under cudnn.deterministic
        diffs = {}
        for det in ((True, False) if on_card else (True,)):
            if on_card:
                torch.backends.cudnn.deterministic = det
            ref = (lenet_run(device, samples, test_set, epochs, seed=5)[0]
                   if det else whole)
            part = os.path.join(work, f"ckpt_{det}")
            lenet_run(device, samples, test_set, epochs - 1, seed=5,
                      ckpt=part)
            resumed, ropt, _ = lenet_run(device, samples, test_set, epochs,
                                         seed=99, ckpt=part, resume=True)
            diffs[det] = max_param_diff(resumed, ref)
            if ropt.optim_method.state["neval"] != steps + 1:
                raise AssertionError("the resumed run ended at iteration "
                                     f"{ropt.optim_method.state['neval']}")
        if on_card:
            torch.backends.cudnn.deterministic = False
        emit("lenet", what=f"resume after epoch {epochs - 1} into a fresh "
             "model vs an uninterrupted run", epochs=epochs,
             max_abs_diff_deterministic=diffs[True],
             max_abs_diff_default=diffs.get(False))
        if diffs[True] != 0.0:
            raise AssertionError("resumed LeNet parameters differ from the "
                                 f"uninterrupted run's by {diffs[True]}")
        # 6: the card against the CPU from the same weights and batches
        if on_card:
            batches = [b for _, b in zip(range(card_steps), (
                DataSet.array(samples)
                >> GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
                >> SampleToMiniBatch(128)).data(train=True))]

            def card_vs_cpu(dtype, steps):
                cast = [MiniBatch(np.asarray(b.get_input(), dtype=dtype),
                                  b.get_target()) for b in batches]
                cpu = LeNet5(10, device="cpu",
                             generator=torch.Generator().manual_seed(11))
                cpu = cpu.to(getattr(torch, np.dtype(dtype).name))
                gpu = copy.deepcopy(cpu).to("cuda")
                for m in (cpu, gpu):
                    o = Optimizer(m, DataSet.array(cast), ClassNLLCriterion(),
                                  end_trigger=Trigger.max_iteration(steps))
                    o.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
                    o.optimize()
                return max(float((a.detach().cpu() - b.detach()).abs().max())
                           for a, b in zip(gpu.parameters(), cpu.parameters()))

            err = {"f32_first_step": card_vs_cpu(np.float32, 1),
                   "f64": card_vs_cpu(np.float64, card_steps)}
            emit("lenet", what=f"the card vs the CPU: 1 f32 step, "
                 f"{card_steps} float64 steps", param_max_abs_err=err,
                 tol=LENET_CARD_TOL)
            for k, e in err.items():
                if not e <= LENET_CARD_TOL[k]:
                    raise AssertionError(f"LeNet card vs CPU ({k}): {e} > "
                                         f"{LENET_CARD_TOL[k]}")
        print(json.dumps({"lenet_step_ms_p50": p50 * 1e3,
                          "lenet_records_per_s": 128 / p50,
                          "lenet_epoch_wall_s": train_wall / epochs,
                          "lenet_pipeline_share":
                              stream.fetch_s / train_wall,
                          "lenet_test_top1": top1}))
    finally:
        log.removeHandler(handler)
        shutil.rmtree(work, ignore_errors=True)


def requant_inputs(case: str, seed: int):
    """Seeded int8 caches at the decode step's shape (16 rows, 512
    positions, 12 heads, D 64) with the step's old scales and new-value
    maxima: ``"none"`` grows no scale, ``"all"`` grows every one, and
    ``"mixed"`` has a zero-scale row that grows (its stale bytes go to
    zero), an inactive row (amax 0), a row that does not grow, and the
    other (row, head) pairs grown or not at random."""
    import torch

    n, L, h, d = SERVING_DECODE
    g = torch.Generator(device="cuda").manual_seed(seed)

    def cache():
        return torch.randint(-127, 128, (n, L, h, d), dtype=torch.int8,
                             device="cuda", generator=g)

    def scales():
        s_old = torch.rand(n, h, device="cuda", generator=g) * 0.1 + 0.01
        grow = torch.rand(n, h, device="cuda", generator=g) < 0.5
        if case == "mixed":
            s_old[0] = 0.0
            grow[0], grow[1], grow[2] = True, False, False
        else:
            grow[:] = case == "all"
        amax = torch.where(grow, (s_old + 0.01) * 127 * 2,
                           s_old * 127 * 0.5)
        if case == "mixed":
            amax[1] = 0.0
        return s_old, amax

    kc, vc = cache(), cache()
    (ks, ka), (vs, va) = scales(), scales()
    return kc, vc, ks, vs, ka, va


def parent_merge_step(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """The decode-step merge as the port spelled it before the kv_requant
    kernel: read the ``grew`` flag back to the host, requantize only on
    growth (the yardstick of the host read)."""
    from bigdl_tpu_torch.models import transformer as tm

    grew = bool(((k_amax / 127.0 > ks_old).any()
                 | (v_amax / 127.0 > vs_old).any()).item())
    if grew:
        kc.copy_(tm._kv_quant_merge(kc, ks_old, k_amax)[0])
        vc.copy_(tm._kv_quant_merge(vc, vs_old, v_amax)[0])


def kv_requant_phase():
    """The kv_requant kernel (the scale rule and the requantize of both
    caches) against its plain version, bitwise, at the decode step's shape
    in three cases (no growth, every pair grown, mixed); the kernel's time
    per case beside the plain unconditional merge, the decode step's merge
    call and the parent's host-read step (scale rule in PyTorch, the grew
    flag read back, the requantize on growth), by the host clock with a
    synchronize, and the bound. Returns the kernel's summary entry (the
    mixed case)."""
    import torch

    from bigdl_tpu_torch.models import transformer as tm
    from bigdl_tpu_torch.ops import kv_requant as kr

    n, L, h, d = SERVING_DECODE
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entry = None
    for i, case in enumerate(("none", "all", "mixed")):
        kc, vc, ks, vs, ka, va = requant_inputs(case, seed=40 + i)
        want = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
        got = tm._kv_quant_merge_step(kc.clone(), vc.clone(), ks, vs, ka, va)
        torch.cuda.synchronize()
        err = max(int((got[0].int() - want[0].int()).abs().max()),
                  int((got[1].int() - want[1].int()).abs().max()),
                  max(float((g - w).abs().max())
                      for g, w in zip(got[2:], want[2:])))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        k_ratio = kr.kv_scale_merge(ks, ka)[2]
        v_ratio = kr.kv_scale_merge(vs, va)[2]
        grown = int((k_ratio != 1.0).sum() + (v_ratio != 1.0).sum())
        emit("kernels", kernel="kv_requant", case=case, shape=[n, L, h, d],
             grown_pairs=grown, pairs=2 * n * h, max_abs_err=err,
             tol=0, why="the same f32 operations, each rounded to nearest: "
                        "bitwise (caches and the four scale tensors)",
             bitwise=bitwise)
        if not bitwise:
            raise AssertionError(f"kv_requant {case}: not bitwise equal to "
                                 f"its plain version (max abs err {err})")
        kern = time_stats(lambda: kr.kv_requant_cuda(kc, vc, ks, vs, ka, va),
                          flush=flush)

        def plain():
            k2, v2, *_ = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
            kc.copy_(k2)
            vc.copy_(v2)

        plain_ms = time_ms(plain, flush=flush)

        def host_ms(fn, reps=50):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        step_ms = host_ms(lambda: tm._kv_quant_merge_step(kc, vc, ks, vs,
                                                          ka, va))
        parent_ms = host_ms(lambda: parent_merge_step(kc, vc, ks, vs, ka,
                                                      va))
        # in: 4 (n, h) f32 tensors; out: 4; grown pairs read + write L x D
        n_bytes = 8 * n * h * 4 + grown * L * d * 2
        bound_ms, bound_by = bound(grown * L * d * 2, n_bytes, F32_FLOPS)
        emit("kernels", kernel="kv_requant", case=case, ms=kern["mean"],
             ms_median=kern["median"], ms_min_max=[kern["min"], kern["max"]],
             host_ms_max=kern["host_ms_max"], plain_ms=plain_ms,
             plain="scale rule + round(q * ratio) of both caches, copied "
                   "back (the unconditional merge)",
             step_host_ms=step_ms, parent_step_host_ms=parent_ms,
             parent="scale rule in PyTorch, host read of the grew flag, "
                    "requantize on growth",
             bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
             library_ms=None)
        if case == "mixed":
            entry = {"name": "kv_requant", "route": "cuda",
                     "source": "bigdl_tpu_torch/csrc/kv_requant.cu",
                     "replaces": "bigdl_tpu/models/transformer.py:653",
                     "launches": None, "max_abs_err": float(err),
                     "ms": kern["mean"], "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return entry


def check_phase():
    """A small model's int8-KV decode on the card vs on the CPU (same
    weights, same prefill, same fed tokens, f32): log-probs within 2e-3
    (f32 math on both; an int8 value on a rounding boundary may land one
    quantum apart, 0.4% of its row's range)."""
    import torch

    from bigdl_tpu_torch.models import transformer as tm

    lm_cpu = tm.TransformerLM(97, hidden_size=128, n_heads=4, n_layers=2,
                              max_len=64, device="cpu", seed=3)
    lm_gpu = tm.TransformerLM(97, hidden_size=128, n_heads=4, n_layers=2,
                              max_len=64, device="cpu", seed=3).to("cuda")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 97, size=(4, 16))
    lengths = np.asarray([16, 5, 0, 11])
    feeds = rng.integers(0, 97, size=(6, 4))
    active = torch.tensor([True, True, False, True])
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, "cuda")):
        prefill = tm.make_batch_prefill_step(lm, kv_quant=True)
        step, init = tm.make_batch_decode_step(lm, kv_quant=True)
        P = tm.serving_params(lm)
        with torch.no_grad():
            _, carry = prefill(P, torch.from_numpy(toks).to(dev), lengths,
                               init(4))
            logps = []
            for f in feeds:
                lp, carry = step(P, torch.from_numpy(f).to(dev),
                                 active.to(dev), carry)
                logps.append(lp.cpu().numpy())
        outs.append(np.stack(logps))
    err = float(np.abs(outs[0] - outs[1])[:, active.numpy()].max())
    emit("check", what="int8-KV decode step, card vs CPU, small model",
         steps=len(feeds), max_abs_logp_err=err, tol=2e-3)
    if not err <= 2e-3:
        raise AssertionError(f"card vs CPU decode: max abs err {err}")


def train_check_phase():
    """A small LM's three f32 train steps on the card vs on the CPU, with
    the flash path forced (``use_flash="always"``: the f32 kernels on the
    card, the plain version on the CPU) and SGD, whose update is linear
    in the gradients, so the parameters show any gradient difference.
    Tolerances: losses 1e-5 relative, parameters 1e-5 absolute (f32 on
    both sides, sums in other orders; 3 steps of lr 0.1)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    V, T, B = 29, 16, 4
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
        y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
        y[:, -3:] = 0.0
        batches.append((x, y))
    results = []
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    for dev in ("cpu", "cuda"):
        lm = TransformerLM(V, hidden_size=32, n_heads=4, n_layers=2,
                           max_len=T, output="logits", use_flash="always",
                           device="cpu", seed=9).to(dev)
        opt = SGD(learning_rate=0.1, momentum=0.9)
        step = make_train_step(lm, MaskedSoftmaxCECriterion(0), opt)
        params = {k: p.detach().clone() for k, p in lm.named_parameters()}
        state = opt.init_state(params)
        losses = []
        for x, y in batches:
            params, state, _, loss = step(
                params, state, {}, None, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))
            losses.append(float(loss))
        # the two builds' parameter names differ in their instance
        # counters; the order is the same
        results.append((losses, [p.cpu() for p in params.values()]))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    launches = [fa.fwd_launches, fa.dq_launches, fa.dkv_launches]
    emit("train_check", what="3 f32 train steps, small LM, card vs CPU",
         losses_cpu=l_cpu, losses_card=l_gpu, loss_rel_err=loss_err,
         param_max_abs_err=param_err, tol_loss=1e-5, tol_param=1e-5,
         card_flash_launches=launches)
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise AssertionError(f"card vs CPU train steps: loss {loss_err}, "
                             f"params {param_err}")
    if launches != [6, 6, 6]:              # 2 layers x 3 steps, card only
        raise AssertionError(f"flash launches {launches}, expected 6 each")


def train_phase(warm: int = 2, timed: int = 5):
    """The training path at full width; returns the flash kernels'
    launch counts over the ``optimize()`` run."""
    import torch

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    V, hidden, layers, heads, T, B = 32768, 768, 12, 12, 2048, 8
    lm = TransformerLM(V, hidden_size=hidden, n_heads=heads, n_layers=layers,
                       max_len=T, output="logits", seed=0)
    n_params = sum(p.numel() for p in lm.parameters())
    rng = np.random.default_rng(0)
    x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
    samples = [Sample(x[i], y[i]) for i in range(B)]
    steps = warm + timed
    losses = []

    def record_then_stop(state):       # the trigger reads every step's loss
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] > steps

    opt = Optimizer(lm, samples, MaskedSoftmaxCECriterion(0), batch_size=B,
                    end_trigger=Trigger(record_then_stop,
                                        Trigger.max_iteration(steps).peek))
    opt.set_optim_method(Adam(learning_rate=1e-4)).set_compute_dtype("bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches}
    step_s = opt.metrics.values("computing time")[warm:]
    p50 = float(np.median(step_s))
    tokens_per_s = B * T / p50
    fpt = lm_flops_per_token(V, hidden, layers, T)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"one batch repeated {steps} times did not "
                             f"lower the loss: {losses}")
    for name, n in launches.items():
        if n != layers * steps:
            raise AssertionError(
                f"flash {name} launched {n} times, expected {steps} steps "
                f"x {layers} layers")
    emit("train", model="137m", params=n_params, vocab=V, hidden=hidden,
         layers=layers, heads=heads, T=T, batch=B, compute="bf16",
         optim="Adam(1e-4)", steps=steps, timed_steps=timed,
         step_ms=[s * 1e3 for s in step_s], wall_s=wall,
         flash_launches=launches, peak_mem_gib=peak_gib, losses=losses)
    print(json.dumps({"train_step_ms_p50": p50 * 1e3,
                      "tokens_per_s": tokens_per_s,
                      "mfu": tokens_per_s * fpt / BF16_FLOPS,
                      "flops_per_token": fpt}))
    return launches


#: the CUDA runtime calls that block the host on the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def decode_step_trace(engine, vocab, rng, steps: int = 8, submit_kw=None,
                      between=None):
    """Per decode step, over ``steps`` steps with all 16 slots decoding
    (after one admission step; ``submit_kw(i)`` adds keyword arguments to
    request i's ``submit``; ``between(i)`` runs before traced step i),
    counted by ``torch.profiler`` as ``tools/torch_serving_profile.py``
    counts them: device launches (kernels, copies, fills), device→host
    copies, and host waits on the card. The waits are the ``SYNC_CALLS``
    of the window less those of a window with no step in it (the
    profiler's own and the ``torch.cuda.synchronize()`` that closes it),
    so no step's count hangs on the profiler placing a call's time
    against a span's. Also returns the window's wait calls by name, in
    and out of the steps' host spans, and the empty window's count."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng = engine()
    for i in range(16):
        p = rng.integers(1, vocab + 1, size=int(rng.integers(16, 257)))
        eng.submit(p.tolist(), max_new_tokens=16,
                   **({} if submit_kw is None else submit_kw(i)))
    with torch.no_grad():
        eng.step()                         # admission: the prefills
        torch.cuda.synchronize()
        with profile(activities=activities) as empty:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for i in range(steps):
                if between is not None:
                    between(i)
                with record_function("serve_step"):
                    eng.step()
            torch.cuda.synchronize()
        eng.drain()
    events = list(prof.events())
    # a record_function span also shows on the card's timeline as a user
    # annotation; that is no launch, and no host span
    cpu_type = torch.autograd.DeviceType.CPU
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "serve_step"]
    dtoh = sum(1 for e in cuda if "DtoH" in e.name)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "serve_step" and e.device_type == cpu_type]
    waits = {}
    for e in events:
        if e.name in SYNC_CALLS:
            inside = any(a <= e.time_range.start <= b for a, b in spans)
            key = f"{e.name} {'in' if inside else 'outside'} a step"
            waits[key] = waits.get(key, 0) + 1
    own = sum(1 for e in empty.events() if e.name in SYNC_CALLS)
    waits["in the empty window"] = own
    syncs = sum(1 for e in events if e.name in SYNC_CALLS) - own
    return len(cuda) / steps, dtoh / steps, syncs / steps, waits


def serve_traffic(rng, vocab: int):
    """The serve phase's 24 requests: prompts of 16-256 tokens, every
    third one sampled (seeded), the rest greedy; ``(prompt, sampling)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    out = []
    for i in range(24):
        prompt = rng.integers(1, vocab + 1, size=int(rng.integers(16, 257)))
        sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i)
              if i % 3 == 2 else None)
        out.append((prompt.tolist(), sp))
    return out


def lm_137m(n_layers: int = 12, seed: int = 0):
    """The "137m" TransformerLM (``benchmarks/serving_bench.py:146``) on
    the card, random weights from ``seed``; ``n_layers`` cuts its depth
    (a draft). Returns (model, build seconds)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    lm = TransformerLM(32768, hidden_size=768, n_heads=12,
                       n_layers=n_layers, max_len=512, output="logits",
                       seed=seed)
    lm.evaluate()
    torch.cuda.synchronize()
    return lm, time.perf_counter() - t0


def serve_phase():
    """The main path at the 137m width; returns decode_attention and
    kv_requant launches and the run's decode-gap p99 (the chunked run's
    yardstick)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    V, layers = 32768, 12
    lm, build_s = lm_137m()
    n_params = sum(p.numel() for p in lm.parameters())

    def engine():
        return ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                             kv_dtype="int8")

    # warm-up: library handles and allocator pools, outside the counts
    warm = engine()
    for p in ([5, 9, 2] * 7, [4] * 40):
        warm.submit(p, max_new_tokens=3)
    with torch.no_grad():
        warm.drain()
    del warm

    rng = np.random.default_rng(0)
    eng = engine()
    reqs = [(eng.submit(prompt, max_new_tokens=32, sampling=sp), sp)
            for prompt, sp in serve_traffic(rng, V)]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, requant = da.launches, kr.launches
    steps = eng.metrics.decode_step_count
    for rid, _ in reqs:
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == 32 and out.min() >= 1 and out.max() <= V):
            raise AssertionError(f"request {rid}: bad output {out}")
        if not (np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"request {rid}: bad logprobs {lps}")
        if eng.request(rid).finish_reason != "length":
            raise AssertionError(f"request {rid} did not run to length")
    for name, n in (("decode_attention", launches), ("kv_requant", requant)):
        if n != steps * layers:
            raise AssertionError(
                f"{name} launched {n} times, expected {steps} decode "
                f"steps x {layers} layers")
    s = eng.summary()
    per_step, dtoh, syncs, waits = decode_step_trace(engine, V, rng)
    emit("serve", model="137m", params=n_params, build_s=build_s,
         requests=len(reqs), new_tokens=32 * len(reqs), wall_s=wall,
         decode_steps=steps, decode_attention_launches=launches,
         kv_requant_launches=requant,
         decode_step_device_launches=per_step,
         decode_step_device_to_host_copies=dtoh,
         decode_step_host_waits=syncs, traced_wait_calls=waits,
         decode_gap_p99_s=s["serving/decode_gap_p99_s"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps({"tokens_per_s": s["serving/tokens_per_sec"]}))
    print(json.dumps({"ttft_p50_s": s["serving/ttft_p50_s"],
                      "ttft_p99_s": s["serving/ttft_p99_s"]}))
    print(json.dumps({"decode_step_p50_s": s["serving/decode_step_p50_s"],
                      "host_step_p50_s": s["serving/host_step_p50_s"]}))
    if dtoh != 1 or syncs != 1:
        raise AssertionError(
            f"a decode step made {dtoh} device-to-host copies and {syncs} "
            "host waits; the step's one readback (the fence) is all it "
            "may make")
    return launches, requant, s["serving/decode_gap_p99_s"]


def serve_modes_run(lm, mode, knobs, submit, between=None):
    """Serve one traffic through ``ServingEngine(**knobs)`` at the 137m
    width (bf16, int8 KV, 16 slots): ``submit(eng)`` queues requests and
    returns their ids, ``between(eng, step)`` runs after each step (more
    arrivals, checks). Checks every request ran to its length with ids in
    1..V and finite log-probs <= 0; returns (engine, ids, line fields)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    V = lm[0].n_index
    eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                        kv_dtype="int8", **knobs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.launches = kr.launches = 0
    rids = submit(eng)
    t0 = time.perf_counter()
    n = 0
    with torch.no_grad():
        while not eng.scheduler.idle():
            eng.step()
            n += 1
            if between is not None:
                rids += between(eng, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in rids:
        req, out, lps = eng.request(rid), eng.result(rid), eng.logprobs(rid)
        if req is None or req.finish_reason != "length" \
                or len(out) != req.max_new_tokens:
            raise AssertionError(f"{mode}: request {rid} did not run to "
                                 f"its length ({req and req.finish_reason})")
        if not (out.min() >= 1 and out.max() <= V):
            raise AssertionError(f"{mode}: request {rid}: bad ids {out}")
        if not (np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"{mode}: request {rid}: bad logprobs")
    s = eng.summary()
    m = eng.metrics.metrics
    fields = dict(
        mode=mode, requests=len(rids), wall_s=wall,
        new_tokens=int(m.get("serving/tokens_out")[0]),
        tokens_per_s=s["serving/tokens_per_sec"],
        ttft_p50_s=s["serving/ttft_p50_s"], ttft_p99_s=s["serving/ttft_p99_s"],
        decode_step_p50_s=s["serving/decode_step_p50_s"],
        decode_gap_p99_s=s.get("serving/decode_gap_p99_s", 0.0),
        prefix_hits=m.get("serving/prefix_hits")[0],
        prefix_matched_tokens=m.get("serving/prefix_hit_tokens")[0],
        chunks=m.get("serving/chunks")[0],
        preempted=m.get("serving/preempted")[0],
        retries=m.get("serving/retries")[0], shed=m.get("serving/shed")[0],
        decode_steps=eng.metrics.decode_step_count,
        decode_attention_launches=da.launches,
        kv_requant_launches=kr.launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return eng, rids, fields


def serve_modes_phase(batched_gap_p99_s):
    """The admission and scheduling modes of ``ServingEngine`` at the 137m
    width, each on its own traffic (see the module docstring);
    ``batched_gap_p99_s`` is the serve phase's decode-gap p99 on the same
    requests as the chunked run. Returns the decode_attention and the
    kv_requant launches of all runs."""
    import torch

    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    lm, _ = lm_137m()
    V, layers = 32768, 12
    traffic = serve_traffic(np.random.default_rng(0), V)

    def serve_submit(eng):
        return [eng.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]

    def check_launches(f):
        for name in ("decode_attention", "kv_requant"):
            if f[f"{name}_launches"] != f["decode_steps"] * layers:
                raise AssertionError(
                    f"{f['mode']}: {name} launched "
                    f"{f[f'{name}_launches']} times, expected "
                    f"{f['decode_steps']} decode steps x {layers} layers")

    launches = 0
    runs = {}

    _, _, f = serve_modes_run(lm, "per_request",
                              {"admission": "per_request"}, serve_submit)
    runs["per_request"] = f

    # chat traffic behind one system prompt: a shared 192-token head and
    # distinct 16-64-token tails
    rng = np.random.default_rng(1)
    head = rng.integers(1, V + 1, size=192).tolist()
    chat = [head + rng.integers(1, V + 1, size=int(rng.integers(16, 65)))
            .tolist() for _ in range(24)]
    eng, _, f = serve_modes_run(
        lm, "prefix", {"prefix_cache": True},
        lambda e: [e.submit(p, max_new_tokens=32) for p in chat])
    fed = sum(len(p) - 1 for p in chat)
    f["prefix_matched_share"] = f["prefix_matched_tokens"] / fed
    if f["prefix_hits"] != 24 - 16:
        raise AssertionError(f"prefix: {f['prefix_hits']} hits, expected "
                             "every request after the first round (8)")
    runs["prefix"] = f

    spend = []

    def chunk_spend(eng, n):
        total = eng.metrics.metrics.get("serving/chunk_tokens")[0]
        spend.append(total - sum(spend))
        return []

    _, _, f = serve_modes_run(lm, "chunked", {"admission": "chunked",
                                              "chunk_budget": 64},
                              serve_submit, chunk_spend)
    f["max_chunk_tokens_per_step"] = max(spend)
    f["batched_decode_gap_p99_s"] = batched_gap_p99_s
    if max(spend) > 64:
        raise AssertionError(f"chunked: a step spent {max(spend)} prompt "
                             "tokens, over the budget of 64")
    runs["chunked"] = f

    # 16 priority-0 requests fill the slots; after 4 steps 8 priority-1
    # requests arrive and preempt 8 of them; every restore of a stash is
    # held bitwise against the slot it lands in. Inside the timed loop a
    # restore only snapshots its slot (device copies, no read back); the
    # compares run once the wall time is taken
    rng = np.random.default_rng(2)
    low = [rng.integers(1, V + 1, size=int(rng.integers(16, 257))).tolist()
           for _ in range(16)]
    high = [rng.integers(1, V + 1, size=int(rng.integers(16, 257))).tolist()
            for _ in range(8)]
    restored = []           # (stashed payload, its slot right after)

    def arrive(eng, n):
        if n != 4:
            return []
        restore = eng.pool.restore_row

        def restore_and_snapshot(slot, payload):
            restore(slot, payload)
            restored.append((payload["carry"],
                             eng.pool.row_state(slot)["carry"]))

        eng.pool.restore_row = restore_and_snapshot
        return [eng.submit(p, max_new_tokens=32, priority=1) for p in high]

    eng, _, f = serve_modes_run(
        lm, "priority", {"policy": "priority"},
        lambda e: [e.submit(p, max_new_tokens=64) for p in low], arrive)
    f["resumed_without_prefill"] = \
        eng.metrics.metrics.get("serving/resumed_without_prefill")[0]
    restores = [all(torch.equal(after[k], v) for k, v in stash.items())
                for stash, after in restored]
    f["restores_bitwise"] = f"{sum(restores)}/{len(restores)}"
    f["stash_bytes_per_row"] = max(
        (sum(v.numel() * v.element_size() for v in stash.values())
         for stash, _ in restored), default=0)
    if f["preempted"] != 8 or not restores or not all(restores) \
            or f["resumed_without_prefill"] <= 0:
        raise AssertionError(f"priority: {f}")
    runs["priority"] = f

    inj = FaultInjector(seed=0, p_fail=0.05, p_garbage=0.05,
                        p_admit_fail=0.05, max_faults=8)
    _, _, f = serve_modes_run(
        lm, "faults", {"faults": inj,
                       "watchdog": WatchdogConfig(max_retries=8)},
        serve_submit)
    f["faults"] = dict(inj.counts)
    # a failed dispatch raises before the step runs and a garbage step
    # still launches, so every counted decode step launched once a layer
    if not (inj.total > 0 and f["retries"] > 0):
        raise AssertionError(f"faults: {f}")
    f["healthy_decode_steps"] = f["decode_steps"] - inj.counts["garbage"]
    runs["faults"] = f

    requant = 0
    for f in runs.values():
        check_launches(f)
        launches += f["decode_attention_launches"]
        requant += f["kv_requant_launches"]
        emit("serve_modes", **f)
    return launches, requant


#: the dispatch-ahead windows of the serve_async phase
#: (``benchmarks/serving_bench.py``'s ``--scenario async``)
ASYNC_WINDOWS = (0, 1, 2, 4)


def lm_layers(lm) -> int:
    from bigdl_tpu_torch.models.transformer import TransformerBlock

    return sum(isinstance(m, TransformerBlock) for m in lm.layers())


def serve_async_phase():
    """The serve phase's engine (137m, bf16, int8 KV, 16 slots) and 24
    requests at ``dispatch_ahead`` W in ``ASYNC_WINDOWS``: every W's token
    and log-prob streams byte-identical to W = 0's, decode_attention and
    kv_requant launched once per layer per decode step; per W tok/s, the
    decode step p50, the share of the wall spent waiting on readbacks
    and the host step p50. Returns both kernels' launches."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    traffic = serve_traffic(np.random.default_rng(0), V)
    streams, totals = {}, [0, 0]
    for W in ASYNC_WINDOWS:
        eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                            kv_dtype="int8", dispatch_ahead=W)
        rids = [eng.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]
        torch.cuda.synchronize()
        da.launches = kr.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.metrics.decode_step_count
        streams[W] = [(outs[r].tobytes(), eng.logprobs(r).tobytes())
                      for r in rids]
        for rid in rids:
            if len(outs[rid]) != 32 or eng.request(rid).finish_reason \
                    != "length":
                raise AssertionError(f"async W={W}: request {rid} did not "
                                     "run to its length")
        s = eng.summary()
        fence_s = eng.metrics.metrics.get("serving/fence_wait_s")[0]
        f = dict(dispatch_ahead=W, requests=len(rids), wall_s=wall,
                 tokens_per_s=s["serving/tokens_per_sec"],
                 decode_steps=steps,
                 decode_step_p50_s=s["serving/decode_step_p50_s"],
                 host_step_p50_s=s["serving/host_step_p50_s"],
                 fence_wait_share=fence_s / wall,
                 decode_attention_launches=da.launches,
                 kv_requant_launches=kr.launches,
                 streams_identical_to_w0=streams[W] == streams[0],
                 in_flight_after_drain=len(eng._window))
        emit("serve_async", **f)
        if not f["streams_identical_to_w0"] or eng._window:
            raise AssertionError(f"async W={W}: streams differ from W=0's "
                                 "or dispatches were left in flight")
        for name in ("decode_attention", "kv_requant"):
            if f[f"{name}_launches"] != steps * layers:
                raise AssertionError(
                    f"async W={W}: {name} launched {f[f'{name}_launches']} "
                    f"times, expected {steps} decode steps x {layers}")
        totals[0] += da.launches
        totals[1] += kr.launches
    return totals


def spec_trace(vocab: int, n_requests: int = 16, gen_tokens: int = 24,
               seed: int = 23):
    """``benchmarks/serving_bench.py``'s ``make_spec_trace``: prompts of 5,
    9 and 17 tokens; half the requests greedy speculative, a quarter
    ``draft_tokens=0`` (plain rows in the speculative batch), a quarter
    sampled with their own seeds. ``(prompt, new tokens, sampling,
    draft_tokens)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(seed)
    buckets = [5, 9, 17]
    trace = []
    for i in range(n_requests):
        prompt = rng.randint(1, vocab + 1,
                             size=(buckets[i % len(buckets)],)).tolist()
        if i % 4 == 3:
            sp, dt = SamplingParams(temperature=0.8, top_k=20,
                                    seed=200 + i), None
        elif i % 4 == 1:
            sp, dt = None, 0
        else:
            sp, dt = None, None
        trace.append((prompt, gen_tokens, sp, dt))
    return trace


def spec_run(lm, draft, dtype, kv, trace, k: int = 3):
    """One drain of ``trace`` through a 16-slot engine (speculative when
    ``draft`` is given), kernel launch counts set to 0 just before and
    read just after. Returns (engine, request ids, outputs, fields)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    eng = ServingEngine(lm, n_slots=16, compute_dtype=dtype, kv_dtype=kv,
                        speculative=None if draft is None
                        else SpeculativeConfig(draft, k=k))
    draft_steps = [0]
    if draft is not None:
        step = eng._spec._draft_step_fn

        def counted(*a):
            draft_steps[0] += 1
            return step(*a)

        eng._spec._draft_step_fn = counted
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp, draft_tokens=dt)
            for p, n, sp, dt in trace]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = lm[0].n_index
    for rid, (_, n, _, _) in zip(rids, trace):
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == n and out.min() >= 1 and out.max() <= V
                and np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"spec: request {rid}: bad output {out}")
    s = eng.summary()
    fields = dict(requests=len(rids), wall_s=wall,
                  tokens_per_s=s["serving/tokens_per_sec"],
                  accept_rate=s.get("serving/accept_rate"),
                  tokens_per_step=s.get("serving/tokens_per_step"),
                  verify_steps=eng.metrics.decode_step_count,
                  draft_steps=draft_steps[0],
                  decode_attention_launches=da.launches,
                  kv_requant_launches=kr.launches)
    return eng, rids, outs, fields


def serve_spec_phase():
    """Speculative serving of the 137m target (bf16, int8 KV, 16 slots,
    k=3) on ``spec_trace``: a same-seed weight-tied draft (drafts land:
    accept rate above 0, tokens per step above 1) and, on a short run, an
    independently seeded 2-layer draft (drafts rejected). In both, the
    verify step's int8 commit launches kv_requant once per target layer
    per verify step, and nothing launches decode_attention: the draft keeps
    a bf16 cache, as the JAX draft plane does, and the verify step attends
    in plain PyTorch, as JAX's reaches no kernel. Then the tied draft at fp32 (fp32 KV) on the trace's
    greedy rows: each must equal the plain fp32 engine's, or differ first
    where the plain model's top-two log-prob gap is below 1e-3 (a
    near-tie the chunked verify and the single-token step may break
    apart). Returns both kernels' launches of the bf16 runs."""
    import torch

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    tied, _ = lm_137m()
    other, _ = lm_137m(n_layers=2, seed=1)
    trace = spec_trace(V)
    totals = [0, 0]
    for name, draft, tr in (("tied", tied, trace),
                            ("independent", other, trace[:8])):
        d_layers = lm_layers(draft)
        _, _, _, f = spec_run(lm, draft, torch.bfloat16, "int8", tr)
        f.update(draft=name, draft_layers=d_layers)
        emit("serve_spec", **f)
        want_da, want_kr = 0, f["verify_steps"] * layers
        if (f["decode_attention_launches"] != want_da
                or f["kv_requant_launches"] != want_kr):
            raise AssertionError(
                f"spec {name}: launches {f['decode_attention_launches']} / "
                f"{f['kv_requant_launches']}, expected {want_da} / {want_kr}")
        if name == "tied" and not (f["accept_rate"] > 0
                                   and f["tokens_per_step"] > 1):
            raise AssertionError(f"spec tied: no draft landed: {f}")
        totals[0] += f["decode_attention_launches"]
        totals[1] += f["kv_requant_launches"]

    greedy = [t for t in trace if t[2] is None]
    _, rs, outs_s, f = spec_run(lm, tied, None, "fp32", greedy)
    _, rb, outs_b, _ = spec_run(lm, None, None, "fp32", greedy)
    equal, ties = 0, []
    for a, b, (prompt, _, _, _) in zip(rs, rb, greedy):
        got, want = outs_s[a].tolist(), outs_b[b].tolist()
        if got == want:
            equal += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        ids = torch.tensor([prompt + want[:i]], dtype=torch.float32,
                           device=lm[0].weight.device)
        with torch.no_grad():
            lp = torch.log_softmax(lm(ids)[0, -1].float(), dim=-1)
        top2 = lp.topk(2).values
        ties.append({"request": a, "position": i,
                     "top2_gap": float(top2[0] - top2[1])})
    emit("serve_spec", draft="tied", dtype="fp32", kv="fp32",
         greedy_requests=len(greedy), equal_to_plain=equal,
         differ_at_near_ties=ties, accept_rate=f["accept_rate"],
         tokens_per_step=f["tokens_per_step"])
    if any(t["top2_gap"] >= 1e-3 for t in ties):
        raise AssertionError(f"spec fp32: greedy rows differ from the plain "
                             f"engine off a near-tie: {ties}")
    return totals


#: serve_lora: tenants in the bank (``serving_bench.run_multitenant``'s 3,
#: factor seeds 50-52) and their rank
LORA_TENANTS = 3
LORA_RANK = 16


def multitenant_trace(vocab: int, n_requests: int = 24, gen_tokens: int = 32,
                      n_tenants: int = LORA_TENANTS, seed: int = 29):
    """``benchmarks/serving_bench.py``'s ``make_multitenant_trace``: prompts
    of 5, 9 and 17 tokens, adapter ids round-robin over 0 (base) and the
    tenants, every fourth request forced through a 3-token
    ``fixed_sequence``, odd requests seeded-sampled. ``(prompt, new
    tokens, sampling, adapter id, constraint, forced ids)``."""
    from bigdl_tpu_torch.serving import SamplingParams, fixed_sequence

    rng = np.random.RandomState(seed)
    buckets = [5, 9, 17]
    trace = []
    for i in range(n_requests):
        plen = buckets[i % len(buckets)]
        prompt = rng.randint(1, vocab + 1, size=(plen,)).tolist()
        sp = SamplingParams(temperature=0.8, top_k=20, seed=300 + i) \
            if i % 2 else None
        aid = i % (n_tenants + 1)
        forced = rng.randint(1, vocab + 1, size=(3,)).tolist() \
            if i % 4 == 3 else None
        cons = None if forced is None else fixed_sequence(forced)
        trace.append((prompt, gen_tokens, sp, aid, cons, forced))
    return trace


def lora_run(lm, trace, bank, tenants_on: bool):
    """One drain of ``trace`` through a 16-slot bf16 / int8-KV engine with
    ``adapters=bank`` (``bank=None``: the bank-less oracle);
    ``tenants_on=False`` strips adapter ids and constraints (the base-only
    pass). Kernel launch counts are set to 0 just before the drain and read
    just after; the shapes of every decode dispatch's inputs are recorded.
    Returns (engine, request ids, fields, input layouts)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                        kv_dtype="int8", adapters=bank, seed=5)
    layouts = set()
    step = eng._step_fn

    def recording(*args):
        flat = [args[1], args[2], *args[4].values(), *args[5:6],
                *(args[6].values() if len(args) > 6 else ())]
        layouts.add(tuple((tuple(t.shape), str(t.dtype)) for t in flat))
        return step(*args)

    eng._step_fn = recording
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp,
                       adapter_id=aid if tenants_on else 0,
                       constraint=cons if tenants_on else None)
            for p, n, sp, aid, cons, _ in trace]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = lm[0].n_index
    for rid, (_, n, _, _, _, _) in zip(rids, trace):
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == n and out.min() >= 1 and out.max() <= V
                and np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"lora: request {rid}: bad output {out}")
    s = eng.summary()
    fields = dict(requests=len(rids), wall_s=wall,
                  tokens_per_s=s["serving/tokens_per_sec"],
                  decode_step_p50_s=s["serving/decode_step_p50_s"],
                  ttft_p50_s=s["serving/ttft_p50_s"],
                  ttft_p99_s=s["serving/ttft_p99_s"],
                  decode_steps=eng.metrics.decode_step_count,
                  decode_attention_launches=da.launches,
                  kv_requant_launches=kr.launches)
    return eng, rids, fields, layouts


def serve_lora_phase():
    """Multi-tenant LoRA and constrained decoding on the 137m model (bf16,
    int8 KV, 16 slots) as ``serving_bench.run_multitenant`` drives it: an
    ``AdapterBank(rank=16, n_slots=4)`` with three tenants
    (``random_factors`` seeds 50-52, amp 0.05), ``multitenant_trace`` (24
    requests, 32 new tokens), a bank-less oracle pass, a short warm pass,
    then a base-only pass (ids and constraints stripped) and a mixed pass
    on engines with the bank. Held to: every unconstrained null-adapter
    row of the mixed pass bitwise the oracle's (tokens and log-probs);
    every constrained row emits its forced ids; at least one adapted row
    leaves the oracle's stream; one decode input layout, the same in both
    passes; decode_attention and kv_requant launched once per layer per
    decode step in each; every request's adapter reference released (then
    ``bank.free`` empties the bank). Then launches, device-to-host copies
    and host waits per decode step (``decode_step_trace``, one readback
    each) for the bank-less, base-only and mixed engines, and for mixed
    traffic while a spare tenant is alloc'd and freed between steps (the
    bank re-uploaded every step, still without a host wait). Last, the
    oracle, base-only and mixed passes in alternating order over four
    rounds: the bank's decode-step cost and mixed against base-only,
    within each round. Returns both kernels' launches of the base-only and
    mixed passes."""
    import torch

    from bigdl_tpu_torch.serving import (
        AdapterBank, ServingEngine, fixed_sequence,
    )

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    bank = AdapterBank(lm, rank=LORA_RANK, n_slots=LORA_TENANTS + 1)
    for t in range(LORA_TENANTS):
        bank.alloc(bank.random_factors(seed=50 + t))
    trace = multitenant_trace(V)
    eng_p, rids_p, f_plain, _ = lora_run(lm, trace, None, False)
    lora_run(lm, [(p, 2, sp, a, c, f) for p, _, sp, a, c, f in trace],
             bank, True)                                 # warm
    _, _, f_base, lay_b = lora_run(lm, trace, bank, False)
    eng_m, rids_m, f_mixed, lay_m = lora_run(lm, trace, bank, True)
    null_rows = equal_null = diverged = 0
    for (_, _, _, aid, cons, forced), rp, rm in zip(trace, rids_p, rids_m):
        want, got = eng_p.result(rp), eng_m.result(rm)
        if aid == 0 and cons is None:
            null_rows += 1
            equal_null += bool(np.array_equal(want, got) and (
                eng_p.logprobs(rp).tobytes() == eng_m.logprobs(rm).tobytes()))
        if cons is not None and list(got)[:3] != forced:
            raise AssertionError(f"lora: request {rm} did not emit its "
                                 f"forced ids {forced}: {got}")
        if aid != 0 and cons is None:
            diverged += not np.array_equal(want, got)
    live_after = bank.live
    for t in range(1, LORA_TENANTS + 1):
        bank.free(t)
    checks = dict(
        null_rows=null_rows, null_rows_bitwise_equal=equal_null,
        adapted_rows_diverged=diverged,
        constrained_rows_forced=sum(c is not None for *_, c, _ in trace),
        layouts_base_only=len(lay_b), layouts_mixed=len(lay_m),
        same_layout=lay_b == lay_m,
        live_after_passes={str(k): v for k, v in live_after.items()},
        live_after_free=len(bank.live))
    for name, f in (("oracle", f_plain), ("base_only", f_base),
                    ("mixed", f_mixed)):
        emit("serve_lora", run=name, model="137m", rank=LORA_RANK,
             tenants=LORA_TENANTS, **f)
        for k in ("decode_attention", "kv_requant"):
            if f[f"{k}_launches"] != f["decode_steps"] * layers:
                raise AssertionError(
                    f"lora {name}: {k} launched {f[f'{k}_launches']} "
                    f"times, expected {f['decode_steps']} x {layers}")
    emit("serve_lora", run="checks", multitenant_overhead_pct=100.0 * (
        f_base["tokens_per_s"] / f_mixed["tokens_per_s"] - 1.0), **checks)
    if not (equal_null == null_rows > 0 and diverged > 0
            and len(lay_b) == 1 and lay_b == lay_m
            and live_after == {t: 1 for t in range(1, LORA_TENANTS + 1)}
            and not bank.live):
        raise AssertionError(f"lora: a check failed: {checks}")

    # launches, copies and waits per decode step of a full pool; "churn"
    # serves mixed traffic from a bank with one slot more, whose spare
    # tenant is alloc'd before one traced step and freed before the next,
    # so every step re-uploads the bank
    for t in range(LORA_TENANTS):
        bank.alloc(bank.random_factors(seed=50 + t))
    churn = AdapterBank(lm, rank=LORA_RANK, n_slots=LORA_TENANTS + 2)
    for t in range(LORA_TENANTS):
        churn.alloc(churn.random_factors(seed=50 + t))
    spare_factors, spare = churn.random_factors(seed=50 + LORA_TENANTS), []

    def churn_step(i):
        if spare:
            churn.free(spare.pop())
        else:
            spare.append(churn.alloc(spare_factors))

    forced = np.random.default_rng(7).integers(1, V + 1, size=(16, 3))

    def mixed_kw(i):
        return {"adapter_id": i % (LORA_TENANTS + 1),
                "constraint": fixed_sequence(forced[i].tolist())
                if i % 4 == 3 else None}

    per_step = {}
    for name, adapters, kw, between in (
            ("no_bank", None, None, None), ("base_only", bank, None, None),
            ("mixed", bank, mixed_kw, None),
            ("churn", churn, mixed_kw, churn_step)):
        def engine(adapters=adapters):
            return ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                                 kv_dtype="int8", adapters=adapters)

        n, dtoh, syncs, waits = decode_step_trace(
            engine, V, np.random.default_rng(1), submit_kw=kw,
            between=between)
        per_step[name] = dict(device_launches=n, device_to_host_copies=dtoh,
                              host_waits=syncs, traced_wait_calls=waits)
    per_step["churn"]["bank_versions"] = churn.version
    emit("serve_lora", run="per_decode_step", **per_step)
    for name, f in per_step.items():
        if f["device_to_host_copies"] != 1 or f["host_waits"] != 1:
            raise AssertionError(f"lora {name}: a decode step made more than "
                                 f"its one readback: {f}")

    # the bank's cost per decode step: the three engines in alternating
    # order (ABC, CBA, ABC, CBA), so the drift between passes of one
    # process falls on each alike; differences are taken within a round
    order = ("oracle", "base_only", "mixed")
    rounds = {name: [] for name in order}
    for r in range(4):
        for name in order if r % 2 == 0 else order[::-1]:
            _, _, f, _ = lora_run(lm, trace, None if name == "oracle"
                                  else bank, name == "mixed")
            rounds[name].append(f)
    added = (per_step["base_only"]["device_launches"]
             - per_step["no_bank"]["device_launches"])
    step = {n: [f["decode_step_p50_s"] for f in fs]
            for n, fs in rounds.items()}
    bank_ms = [1e3 * (b - o) for b, o in zip(step["base_only"],
                                            step["oracle"])]
    emit("serve_lora", run="alternating", rounds=4, order="ABC CBA ABC CBA",
         decode_step_p50_s=step,
         tokens_per_s={n: [f["tokens_per_s"] for f in fs]
                       for n, fs in rounds.items()},
         bank_step_ms=bank_ms,
         host_us_per_added_launch=[1e3 * d / added for d in bank_ms],
         added_launches_per_step=added,
         mixed_minus_base_step_ms=[
             1e3 * (m - b) for m, b in zip(step["mixed"],
                                           step["base_only"])],
         multitenant_overhead_pct=[
             100.0 * (b["tokens_per_s"] / m["tokens_per_s"] - 1.0)
             for b, m in zip(rounds["base_only"], rounds["mixed"])])
    return (f_base["decode_attention_launches"]
            + f_mixed["decode_attention_launches"],
            f_base["kv_requant_launches"] + f_mixed["kv_requant_launches"])


def window_counts(fn, label: str, n: int):
    """Run ``fn()`` once under ``torch.profiler`` and count, per unit of
    ``n`` (handoffs, restores or decode steps): device launches
    (kernels, copies, fills), device→host and host→device copies as the
    card's records show them, the host's copy calls
    (``cudaMemcpyAsync``), and host waits on the card (the window's
    ``SYNC_CALLS`` less those of an empty window, as ``decode_step_trace``
    counts them), and the host's launch calls (kernel launches, copies
    and fills as the CUDA runtime and driver API calls that enqueue
    them). The card's records of a window can come back short (observed:
    12 of 16 handoff copies; none of a layer's forward + backward late in
    a whole run, whose host calls were all there); the host's calls are
    what the host did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as empty:
        torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=activities) as prof:
        with record_function(label):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != label]
    own = sum(1 for e in empty.events() if e.name in SYNC_CALLS)
    syncs = sum(1 for e in events if e.name in SYNC_CALLS) - own
    host_copies = sum(1 for e in events if e.name == "cudaMemcpyAsync")
    host_launches = sum(
        1 for e in events
        if e.device_type == torch.autograd.DeviceType.CPU
        and (e.name.startswith(("cudaLaunch", "cuLaunch"))
             or e.name in ("cudaMemcpyAsync", "cudaMemsetAsync")))
    return {"device_launches": len(cuda) / n,
            "host_launch_calls": host_launches / n,
            "device_to_host_copies": sum("DtoH" in e.name for e in cuda) / n,
            "host_to_device_copies": sum("HtoD" in e.name for e in cuda) / n,
            "host_copy_calls": host_copies / n, "host_waits": syncs / n}


def tiered_trace(vocab: int, n_requests: int = 24, gen_tokens: int = 32,
                 seed: int = 31):
    """``serving_bench.make_tiered_trace`` (``:1527-1547``): prompts of 5,
    9 and 17 tokens in turn, every odd request seeded-sampled;
    ``(prompt, new tokens, sampling)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_requests):
        prompt = rng.randint(1, vocab + 1, size=([5, 9, 17][i % 3],))
        sp = (SamplingParams(temperature=0.8, top_k=20, seed=400 + i)
              if i % 2 else None)
        out.append((prompt.tolist(), gen_tokens, sp))
    return out


def streams_of(eng, rids):
    """Each request's (token bytes, log-prob bytes)."""
    return [(np.asarray(eng.result(r), np.int32).tobytes(),
             np.asarray(eng.logprobs(r), np.float32).tobytes())
            for r in rids]


def check_served(name, eng, rids, lengths, vocab):
    """Every request at its length, ids in 1..V, finite log-probs <= 0."""
    for rid, n in zip(rids, lengths):
        out, lps = eng.result(rid), eng.logprobs(rid)
        if not (out is not None and len(out) == n and out.min() >= 1
                and out.max() <= vocab and np.isfinite(lps).all()
                and (lps <= 0).all()):
            raise AssertionError(f"{name}: request {rid}: bad output {out}")


def serve_disagg_phase():
    """The disaggregated plane, the host KV tier and pool health on the
    137m model (bf16, int8 KV, seed 0) with the serve phase's 24 requests:
    (1) handoff — ``DisaggregatedEngine(prefill_slots=16, decode_slots=16,
    decode_pools=2)`` against ``ServingEngine(n_slots=16)``: every stream
    bitwise the oracle's, 24 handoffs, the tier empty after the drain, both
    kernels once per layer per decode step summed over the pools;
    (2) failover — the plane at ``decode_slots=8``, ``kill_pool(0)`` after
    3 steps: every request at its length, one pool death, the migrated
    rows bitwise an undisturbed pass of the same plane, the replayed rows'
    identity counted, the survivor's launches = its decode steps x 12;
    (3) tier — ``serving_bench``'s two-wave trace (seed 31: 16 priority-0
    rows, 3 steps, 8 priority-5 rows) through a priority engine with a
    ``TieredKVStore`` against its ``tier=None`` twin: bitwise, >= 8 spills,
    fetches and resumes without prefill, no bytes left; then a tier whose
    budget holds one row: evictions, every row but the evicted (replayed)
    ones bitwise, the replayed rows' identity counted; (4) codec — a bf16 and an int8 row of
    a card pool packed, unpacked and restored into another slot bitwise.
    Then launches, copies and waits per decode step of a full decode pool,
    per handoff and per restore. Returns both kernels' launches."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import (
        DisaggregatedEngine, ServingEngine, TieredKVStore, pack_payload,
        payload_header, unpack_payload,
    )
    from bigdl_tpu_torch.serving.disagg import request_meta

    lm, _ = lm_137m()
    torch.cuda.reset_peak_memory_stats()     # the phase's own peak
    V, layers = lm[0].n_index, lm_layers(lm)
    bf16 = torch.bfloat16
    traffic = serve_traffic(np.random.default_rng(0), V)
    totals = [0, 0]

    def plane(**kw):
        kw.setdefault("prefill_slots", 16)
        return DisaggregatedEngine(lm, compute_dtype=bf16, kv_dtype="int8",
                                   **kw)

    def counted(name, fn, steps_of):
        """Run ``fn`` with the launch counts at 0; both kernels must have
        launched once per layer per decode step (``steps_of()``)."""
        torch.cuda.synchronize()
        da.launches = kr.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = steps_of()
        for k, n in (("decode_attention", da.launches),
                     ("kv_requant", kr.launches)):
            if n != steps * layers:
                raise AssertionError(f"disagg {name}: {k} launched {n} "
                                     f"times, expected {steps} x {layers}")
        totals[0] += da.launches
        totals[1] += kr.launches
        return out, wall, steps

    # (1) handoff against the monolithic oracle
    oracle = ServingEngine(lm, n_slots=16, compute_dtype=bf16,
                           kv_dtype="int8")
    o_rids = [oracle.submit(p, max_new_tokens=32, sampling=sp)
              for p, sp in traffic]
    _, o_wall, o_steps = counted("oracle", oracle.drain,
                                 lambda: oracle.metrics.decode_step_count)
    d = plane(decode_slots=16, decode_pools=2)
    d_rids = [d.submit(p, max_new_tokens=32, sampling=sp)
              for p, sp in traffic]
    _, d_wall, d_steps = counted(
        "handoff", d.drain,
        lambda: sum(w.engine.metrics.decode_step_count for w in d.decoders))
    check_served("disagg handoff", d, d_rids, [32] * 24, V)
    want, got = streams_of(oracle, o_rids), streams_of(d, d_rids)
    differ = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    s, so = d.summary(), oracle.summary()
    tp = d.metrics.transfer_percentiles((50, 99))
    handoff = dict(
        run="handoff", model="137m", requests=24,
        oracle_tokens_per_s=24 * 32 / o_wall, plane_tokens_per_s=24 * 32 / d_wall,
        oracle_metric_tokens_per_s=so["serving/tokens_per_sec"],
        oracle_decode_gap_p99_s=so["serving/decode_gap_p99_s"],
        plane_decode_gap_p99_s=s["serving/decode_gap_p99_s"],
        oracle_decode_steps=o_steps, plane_decode_steps=d_steps,
        pool_decode_steps=[w.engine.metrics.decode_step_count
                           for w in d.decoders],
        handoffs=s["serving/handoffs"],
        transfer_bytes_per_handoff=s["serving/transfer_bytes_per_handoff"],
        transfer_p50_ms=1e3 * tp["p50"], transfer_p99_ms=1e3 * tp["p99"],
        prefill_occupancy=s["serving/prefill_occupancy"],
        decode_occupancy=s["serving/decode_occupancy"],
        tier_entries=d.tier.entries, tier_bytes=d.tier.resident_bytes,
        streams_bitwise_equal=24 - len(differ), differing_rows=differ)
    emit("serve_disagg", **handoff)
    if differ or s["serving/handoffs"] != 24 or d.tier.entries \
            or d.tier.resident_bytes:
        raise AssertionError(f"disagg handoff: a check failed: {handoff}")
    del d, oracle

    # (2) failover: decode pools of 8 slots, pool 0 killed after 3 steps
    def failover_pass(kill: bool):
        f = plane(decode_slots=8, decode_pools=2)
        rids = [f.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]
        info = {}
        with torch.no_grad():
            for _ in range(3):
                f.step()
            if kill:
                w0 = f.decoders[0]
                wire = {payload_header(b)["request"]["req_id"]
                        for b in w0.transfer._q}
                sched = w0.engine.scheduler
                owned = [e[1] for e in sched._waiting] \
                    + list(sched.running.values()) \
                    + list(sched.partial.values())
                current = set()
                for req in owned:
                    h = f.tier.header(req.req_id)
                    if h is not None and h["carry_keys"] is not None and \
                            h["request"]["output"] == list(req.output):
                        current.add(req.req_id)
                info["migrated"] = sorted(wire | current)
                info["replayed"] = sorted({r.req_id for r in owned}
                                          - current)
                f.kill_pool(0)
                survivor = f.decoders[1].engine.metrics
                before = survivor.decode_step_count
                _, wall, steps = counted(
                    "failover survivor", f.drain,
                    lambda: survivor.decode_step_count - before)
                info.update(wall_s=wall, survivor_decode_steps=steps)
            else:
                f.drain()
        check_served(f"disagg failover kill={kill}", f, rids, [32] * 24, V)
        return f, rids, info

    ref, ref_rids, _ = failover_pass(False)
    f, f_rids, info = failover_pass(True)
    want, got = streams_of(ref, ref_rids), streams_of(f, f_rids)
    mig_bad = [r for r in info["migrated"] if want[r] != got[r]]
    rep_same = sum(want[r] == got[r] for r in info["replayed"])
    rep_tokens = sum(want[r][0] == got[r][0] for r in info["replayed"])
    s = f.summary()
    fp = f.metrics.failover_percentiles((50, 99))
    failover = dict(
        run="failover", decode_slots=8, pool_deaths=s["serving/pool_deaths"],
        migrated_rows=s.get("serving/migrated_rows", 0.0),
        replayed_rows=s.get("serving/replayed_rows", 0.0),
        migrated=info["migrated"], replayed=info["replayed"],
        migrated_bitwise_equal=len(info["migrated"]) - len(mig_bad),
        replayed_bitwise_equal=rep_same, replayed_tokens_equal=rep_tokens,
        failover_p50_ms=1e3 * fp["p50"], failover_p99_ms=1e3 * fp["p99"],
        survivor_decode_steps=info["survivor_decode_steps"],
        tier_entries=f.tier.entries)
    emit("serve_disagg", **failover)
    if s["serving/pool_deaths"] != 1.0 or mig_bad or not info["migrated"] \
            or f.tier.entries:
        raise AssertionError(f"disagg failover: a check failed: {failover}")
    del ref, f

    # (3) the host tier under two-wave priority traffic
    trace = tiered_trace(V)

    def tier_pass(tier):
        eng = ServingEngine(lm, n_slots=16, compute_dtype=bf16,
                            kv_dtype="int8", policy="priority",
                            preemption=True, seed=5, tier=tier)

        def run():
            rids = [eng.submit(p, max_new_tokens=n, sampling=sp, priority=0)
                    for p, n, sp in trace[:16]]
            for _ in range(3):
                eng.step()
            rids += [eng.submit(p, max_new_tokens=n, sampling=sp,
                                priority=5) for p, n, sp in trace[16:]]
            eng.drain()
            return rids

        rids, wall, steps = counted(
            "tier", run, lambda: eng.metrics.decode_step_count)
        check_served("disagg tier", eng, rids, [n for _, n, _ in trace], V)
        return eng, rids, wall

    twin, t_rids, twin_wall = tier_pass(None)
    eng, e_rids, eng_wall = tier_pass(TieredKVStore())
    want, got = streams_of(twin, t_rids), streams_of(eng, e_rids)
    s = eng.summary()
    fetch = eng.metrics.fetch_percentiles((50, 99))
    tier = dict(
        run="tier", requests=len(trace), twin_tokens_per_s=
        sum(n for _, n, _ in trace) / twin_wall,
        tiered_tokens_per_s=sum(n for _, n, _ in trace) / eng_wall,
        preempted=s["serving/preempted"], spills=s["serving/spills"],
        fetches=s["serving/fetches"],
        resumed_without_prefill=s["serving/resumed_without_prefill"],
        spill_bytes_per_row=s["serving/spill_bytes_per_row"],
        fetch_p50_ms=1e3 * fetch["p50"], fetch_p99_ms=1e3 * fetch["p99"],
        tier_bytes_after=s["serving/tier_bytes"],
        streams_bitwise_equal=sum(a == b for a, b in zip(want, got)))
    emit("serve_disagg", **tier)
    if want != got or min(s["serving/spills"], s["serving/fetches"],
                          s["serving/resumed_without_prefill"]) < 8 \
            or s["serving/tier_bytes"] != 0.0:
        raise AssertionError(f"disagg tier: a check failed: {tier}")
    row_bytes = int(s["serving/spill_bytes_per_row"])
    del eng
    # a starved tier: a budget of one row's bytes evicts all but the
    # newest spill, and the evicted rows replay through prefill
    starved = TieredKVStore(host_budget_bytes=row_bytes)
    fetch_row, from_tier = starved.fetch_row, set()

    def fetch_noting(req):
        payload = fetch_row(req)
        if payload is not None:
            from_tier.add(req.req_id)
        return payload

    starved.fetch_row = fetch_noting
    eng, e_rids, _ = tier_pass(starved)
    got = streams_of(eng, e_rids)
    s = eng.summary()
    replayed = [i for i, r in enumerate(e_rids)
                if eng.request(r).preemptions and r not in from_tier]
    differ = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    starve = dict(run="tier_starved", host_budget_bytes=row_bytes,
                  tier_evictions=s.get("serving/tier_evictions", 0.0),
                  resumed_from_tier=len(from_tier), replayed=replayed,
                  replayed_bitwise_equal=sum(i not in differ
                                             for i in replayed),
                  replayed_tokens_equal=sum(want[i][0] == got[i][0]
                                            for i in replayed),
                  streams_bitwise_equal=len(trace) - len(differ),
                  differing_rows=differ)
    emit("serve_disagg", **starve)
    if not s.get("serving/tier_evictions") or not replayed \
            or any(i not in replayed for i in differ):
        raise AssertionError(f"disagg starved tier: {starve}")
    del eng, twin

    # (4) the codec on the card: bf16 and int8 rows through the wire
    codec = {}
    for kv in ("bf16", "int8"):
        e = ServingEngine(lm, n_slots=2, compute_dtype=bf16, kv_dtype=kv)
        with torch.no_grad():
            e.submit(traffic[0][0], max_new_tokens=8)
            for _ in range(3):
                e.step()
            slot, req = next(iter(e.scheduler.running.items()))
            payload = e.pool.row_state(slot)
            _, back = unpack_payload(pack_payload(request_meta(req), payload))
            other = e.pool.alloc()
            e.pool.restore_row(other, back)
            again = e.pool.row_state(other)
        codec[kv] = all(torch.equal(again["carry"][k], v)
                        for k, v in payload["carry"].items())
        e.pool.free(other)
        with torch.no_grad():
            e.drain()
    emit("serve_disagg", run="codec", rows_bitwise=codec)
    if not all(codec.values()):
        raise AssertionError(f"disagg codec: a row did not round-trip {codec}")

    # launches, copies and waits: per decode step of a full decode pool,
    # per handoff, per restore
    rng = np.random.default_rng(1)
    p = plane(decode_slots=16, decode_pools=1)
    for _ in range(16):
        prompt = rng.integers(1, V + 1, size=int(rng.integers(16, 257)))
        p.submit(prompt.tolist(), max_new_tokens=16)
    with torch.no_grad():
        out = p.prefill.pump()
    per_handoff = window_counts(
        lambda: [p._handoff(r, pl) for r, pl in out], "handoffs", len(out))
    w = p.decoders[0]

    def restore():
        w.poll()
        w.engine._admit()

    per_restore = window_counts(restore, "restores", len(out))
    with torch.no_grad():
        w.step()                      # the first decode of the 16 rows

    def steps8():
        for _ in range(8):
            w.step()

    per_step = window_counts(steps8, "decode_steps", 8)
    with torch.no_grad():
        p.drain()
    emit("serve_disagg", run="per_unit", handoffs=len(out),
         per_handoff=per_handoff, per_restore=per_restore,
         per_decode_step=per_step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # a handoff's one copy call is its readback (the leaves' cat is a
    # kernel)
    if (per_handoff["host_copy_calls"] != 1
            or per_handoff["host_waits"] != 1
            or per_restore["host_waits"] != 0
            or per_step["device_to_host_copies"] != 1
            or per_step["host_waits"] != 1):
        raise AssertionError(
            f"disagg: copies or waits off their budget: handoff "
            f"{per_handoff}, restore {per_restore}, step {per_step}")
    return totals


def model_logp(lm, ids):
    """The f32 model's log-probs after every prefix of ``ids`` (1-based):
    (len(ids), V) on the card."""
    import torch

    x = torch.tensor([ids], dtype=torch.float32, device=lm[0].weight.device)
    with torch.no_grad():
        return torch.log_softmax(lm(x)[0].float(), dim=-1)


#: the largest log-prob error against the f32 model that a bf16 stream
#: over a float cache may show where it parts from another: the bf16
#: tolerance of tests/test_torch_generate.py (the decode step against
#: JAX's). Greedy bf16 partings of the 137m model measured 1.1e-2 to
#: 1.8e-2, the sampler rows of sampled ones 1.3e-2 to 1.7e-2 (H100 80GB
#: HBM3, 700 W)
BF16_LOGP_TOL = 5e-2


def stream_error(lm, prompt, out, lps, upto):
    """The largest |log-prob - the f32 model's| over a stream's first
    ``upto`` tokens (its recorded chosen log-probs against a teacher-forced
    f32 pass)."""
    import torch

    lp = model_logp(lm, list(prompt) + list(out[:upto]))
    at = torch.arange(len(prompt) - 1, len(prompt) - 1 + upto,
                      device=lp.device)
    ref = lp[at, torch.tensor(out[:upto], device=lp.device) - 1]
    return float((torch.as_tensor(np.asarray(lps[:upto]), device=lp.device)
                  - ref).abs().max())


def parting(lm, prompt, got, got_lp, want, want_lp, limit):
    """Where two greedy streams of one request part (the C.3 rule for int8
    and bf16): the first differing position i, the f32 model's log-prob
    gap there between the two chosen tokens (after the common prefix), and
    the larger of the two streams' measured log-prob errors against the
    f32 model up to i. Each stream ordered the pair its own way, so an
    honest parting has gap <= 2 x error; and the error itself must stay
    within ``limit``, so a wrong kernel cannot widen its own bound. ``ok``
    says both."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    err = max(stream_error(lm, prompt, got, got_lp, i + 1),
              stream_error(lm, prompt, want, want_lp, i + 1))
    lp = model_logp(lm, list(prompt) + list(want[:i]))[-1]
    gap = abs(float(lp[got[i] - 1] - lp[want[i] - 1]))
    return {"position": i, "gap": gap, "error": err, "limit": limit,
            "ok": gap <= 2 * err and err <= limit}


#: the same for bf16 compute over an int8 cache (serve_autopilot): 8 clean
#: rows of its closed pass measured 2.7e-2 (H100 80GB HBM3, 700 W)
INT8_BF16_LOGP_TOL = 1e-1


@contextlib.contextmanager
def sampler_inputs():
    """Keep a copy, on the card, of every ``(lanes, logp)`` pair the serving
    sampler is given while the block runs: the engine's decode step and
    ``generate`` both import ``sample_rows`` from its module at each call,
    so replacing it there catches both. Yields the list."""
    from bigdl_tpu_torch.serving import sampling

    real, seen = sampling.sample_rows, []

    def keeping(logp, lanes, *args):
        seen.append((lanes.clone(), logp.clone()))
        return real(logp, lanes, *args)

    sampling.sample_rows = keeping
    try:
        yield seen
    finally:
        sampling.sample_rows = real


def sampler_row(seen, seed: int, draws: int):
    """The log-prob row the sampler drew from for the lane ``(seed,
    draws)``: a lane advances once per draw of an active row, so it names
    one draw of one request."""
    for lanes, logp in seen:
        hit = ((lanes[:, 0] == seed) & (lanes[:, 1] == draws)).nonzero()
        if len(hit):
            return logp[int(hit[0, 0])]
    raise AssertionError(f"no sampler call drew from lane ({seed}, {draws})")


def sampled_parting(lm, prompt, sp, got, got_lp, gen_seen, want, want_lp,
                    eng_seen, limit):
    """Where two seeded-sampled streams of one request part. A Gumbel draw
    from the same lane uniforms parts wherever the two log-prob rows order
    two perturbed tokens differently or cross a top-k/top-p cut apart, so
    no log-prob gap bounds it; what it takes is the sampler's inputs: at
    the first differing position i, both streams' rows (each checked
    against the log-prob it recorded for its token) must lie within
    ``limit`` of the f32 model's row over the tokens either row's top-k
    keeps (the only ones the draw can reach), as must each stream's
    log-probs up to i."""
    import torch

    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    r_gen = sampler_row(gen_seen, sp.seed, i)
    r_eng = sampler_row(eng_seen, sp.seed, i)
    if not (float(r_gen[got[i] - 1]) == float(got_lp[i])
            and float(r_eng[want[i] - 1]) == float(want_lp[i])):
        raise AssertionError("the kept sampler rows do not hold the tokens "
                             "the streams drew")
    ref = model_logp(lm, list(prompt) + list(want[:i]))[-1]
    k = sp.top_k if sp.top_k > 0 else ref.numel()
    reach = torch.cat([r_gen.topk(k).indices, r_eng.topk(k).indices]).unique()
    row_err = max(float((r - ref)[reach].abs().max())
                  for r in (r_gen, r_eng))
    err = max(stream_error(lm, prompt, got, got_lp, i),
              stream_error(lm, prompt, want, want_lp, i)) if i else 0.0
    return {"position": i, "row_error": row_err,
            "rows_apart": float((r_gen - r_eng)[reach].abs().max()),
            "tokens_reached": int(reach.numel()), "error": err,
            "limit": limit, "ok": max(row_err, err) <= limit}


def serve_autopilot_phase():
    """The SLO autopilot on the 137m model (bf16, int8 KV, 4 slots, chunked
    admission, the priority policy, ``SteppingClock(0.002)``):
    ``tools/torch_serving_zoo.py``'s seeded zoo trace (seed 43, 49
    requests, prompts over the full vocabulary) through the four static
    passes of ``run_autopilot`` and the closed loop
    (``ServingEngine(autopilot=Autopilot())``). Asserted, as the JAX bench
    asserts: the closed loop's goodput above every static pass's, its
    high-priority misses not above the best static pass's, one decode input
    layout per pass; and the stream rule of int8 KV: a row clean in the
    closed and the reference static pass with the same chunk boundaries in
    both emits the same tokens, a row chunked differently may part only
    where ``parting`` allows. Both kernels launch once per layer per decode
    step in every pass. Then launches, copies and waits per decode step of
    a full 16-slot priority engine without and with an autopilot (batched
    admission). Returns both kernels' launches over the five passes."""
    import torch

    import tools.torch_serving_zoo as zoo
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import Autopilot, ServingEngine

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    bf16 = torch.bfloat16
    # warm-up: library handles and allocator pools, outside the counts
    warm = ServingEngine(lm, n_slots=4, compute_dtype=bf16, kv_dtype="int8",
                         admission="chunked", policy="priority")
    for p in ([5, 9, 2] * 7, [4] * 40):
        warm.submit(p, max_new_tokens=3)
    with torch.no_grad():
        warm.drain()
    del warm
    totals = [0, 0]

    def probe(name, run):
        torch.cuda.synchronize()
        da.launches = kr.launches = 0
        with torch.no_grad():
            r = run()
        torch.cuda.synchronize()
        steps = r.stats["decode_steps"]
        for k, n in (("decode_attention", da.launches),
                     ("kv_requant", kr.launches)):
            if n != steps * layers:
                raise AssertionError(f"autopilot {name}: {k} launched {n} "
                                     f"times, expected {steps} x {layers}")
        totals[0] += da.launches
        totals[1] += kr.launches
        st = r.stats
        emit("serve_autopilot", run=name, goodput=st["goodput"],
             hi_missed=st["hi_missed"], lo_missed=st["lo_missed"],
             preempted=st["preempted"], degraded=st["degraded"],
             degrade_restored=st["degrade_restored"],
             actuations=st["actuations_by_actuator"],
             virtual_s=st["virtual_s"], steps=st["steps"],
             decode_steps=steps, wall_s=st["wall_s"], tokens=st["tokens"],
             tok_s=st["tok_s"], step_p50_ms=st["step_p50_ms"],
             decode_layouts=st["decode_layouts"],
             sample_us_p50=st.get("sample_us_p50"),
             decode_attention_launches=da.launches,
             kv_requant_launches=kr.launches)
        return r

    out = zoo.run_autopilot(lm, compute_dtype=bf16, kv_dtype="int8",
                            device=lm[0].weight.device, stream_rule="chunks",
                            sync=torch.cuda.synchronize, probe=probe)
    closed, ref = out["runs"]["closed"], out["runs"][zoo.REFERENCE_STATIC]
    parted = []
    for ti, i, same in out["partings"]:
        prompt = out["trace"][ti][1]
        f = parting(lm, prompt, closed.outs[ti].tolist(),
                    closed.logprobs[ti], ref.outs[ti].tolist(),
                    ref.logprobs[ti], INT8_BF16_LOGP_TOL)
        parted.append({"row": ti, "same_chunks": same, **f})
    # the error a clean stream shows, for scale beside the limit
    clean = sorted(closed.clean)[:8]
    clean_err = max(stream_error(lm, out["trace"][ti][1],
                                 closed.outs[ti].tolist(), closed.logprobs[ti],
                                 len(closed.outs[ti])) for ti in clean)
    if not clean_err <= INT8_BF16_LOGP_TOL:
        raise AssertionError(f"autopilot: clean streams' log-prob error "
                             f"{clean_err} > {INT8_BF16_LOGP_TOL}")
    emit("serve_autopilot", closed_goodput=out["closed"]["goodput"],
         best_static=out["best_static"],
         gain_vs_best=out["goodput_gain_vs_best"],
         identical_rows=out["identical_rows"], partings=parted,
         clean_rows_measured=len(clean), clean_logp_error=clean_err,
         logp_limit=INT8_BF16_LOGP_TOL,
         sample_us_p50=out["closed"]["sample_us_p50"],
         samples=out["closed"]["samples"])
    if not all(p["ok"] for p in parted):
        raise AssertionError(f"autopilot: a row parted off the measured "
                             f"error: {parted}")

    rng = np.random.default_rng(0)
    for label, ap in (("without", None), ("with", Autopilot)):
        def engine(ap=ap):
            return ServingEngine(lm, n_slots=16, compute_dtype=bf16,
                                 kv_dtype="int8", policy="priority",
                                 autopilot=None if ap is None else ap())

        per_step, dtoh, syncs, waits = decode_step_trace(engine, V, rng)
        emit("serve_autopilot", decode_step=label + " autopilot",
             device_launches=per_step, device_to_host_copies=dtoh,
             host_waits=syncs, traced_wait_calls=waits)
        if dtoh != 1 or syncs != 1:
            raise AssertionError(
                f"autopilot {label}: a decode step made {dtoh} copies and "
                f"{syncs} waits; one readback is all it may make")
    return totals


def serve_generate_phase():
    """The LM's own decoder on the 137m model, at f32 (TF32 off) and bf16:
    ``generate`` on the serve phase's first 8 prompts (32 new tokens; greedy,
    and seeded-sampled where ``serve_traffic`` samples) against
    ``ServingEngine(n_slots=8)``'s streams with float KV: every row equal
    at f32; at bf16 a greedy row equal, or parted at a near-tie as
    ``parting`` allows (counted), and a seeded-sampled row equal, or parted
    where both streams' sampler rows lie within ``BF16_LOGP_TOL`` of the
    f32 model's (``sampled_parting``: a draw crossing a top-k or top-p cut
    has no log-prob gap to bound it); ``beam_generate`` (beam
    4, a 64-token prompt, 32 tokens): scores sorted, the top beam's score
    its length-penalised log-prob sum re-scored by the f32 model (1e-4
    relative at f32; at bf16 32 x ``BF16_LOGP_TOL`` over the length
    penalty, 6.1e-3 relative here); then ``make_decode_step``'s step p50
    and tok/s at batch 1 and 4 (32 steps after a 64-token prefill, each
    synchronized), and its launches, copies and waits per step over 8
    more. Decode attention launches exactly 12 times per decode step in
    each counted run.
    Returns its launches."""
    import torch

    from bigdl_tpu_torch.models.transformer import (
        beam_generate, get_decode_step, get_prefill_step, generate,
        serving_params,
    )
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.serving import ServingEngine

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    reqs = serve_traffic(np.random.default_rng(0), V)[:8]
    rng = np.random.default_rng(13)
    beam_prompt = rng.integers(1, V + 1, size=64).tolist()
    total = 0

    def counted(name, fn, steps):
        nonlocal total
        torch.cuda.synchronize()
        da.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if da.launches != steps * layers:
            raise AssertionError(f"generate {name}: decode_attention "
                                 f"launched {da.launches} times, expected "
                                 f"{steps} x {layers}")
        total += da.launches
        return out, wall

    for dtype_name, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        generate(lm, [5, 9, 2], length=2, temperature=0.0,
                 compute_dtype=dt)                             # warm-up
        eng = ServingEngine(lm, n_slots=8, compute_dtype=dt)
        rids = [eng.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in reqs]
        with torch.no_grad(), sampler_inputs() as eng_seen:
            outs = eng.drain()
        equal, parted, sampled_parted, gen_wall = 0, [], [], 0.0
        for (prompt, sp), rid in zip(reqs, rids):
            with sampler_inputs() as gen_seen:
                (ids, lps), wall = counted(
                    "generate", lambda: generate(
                        lm, prompt, length=32, temperature=0.0, sampling=sp,
                        compute_dtype=dt, return_logprobs=True), 32)
            gen_wall += wall
            got, want = ids.tolist(), outs[rid].tolist()
            if got == want:
                equal += 1
            elif sp is None:
                parted.append({"request": rid, **parting(
                    lm, prompt, got, lps, want, eng.logprobs(rid),
                    BF16_LOGP_TOL)})
            else:
                sampled_parted.append({"request": rid, **sampled_parting(
                    lm, prompt, sp, got, lps, gen_seen, want,
                    eng.logprobs(rid), eng_seen, BF16_LOGP_TOL)})
            del gen_seen
        del eng_seen
        emit("generate", dtype=dtype_name, requests=len(reqs),
             equal_to_engine=equal, parted_at_near_ties=parted,
             sampled_parted=sampled_parted,
             tok_s=32 * len(reqs) / gen_wall)
        if dt is None and (parted or sampled_parted):
            raise AssertionError(f"generate fp32: streams differ from the "
                                 f"engine's: {parted + sampled_parted}")
        if not all(p["ok"] for p in parted):
            raise AssertionError(f"generate {dtype_name}: streams part from "
                                 f"the engine's off a near-tie: {parted}")
        if not all(p["ok"] for p in sampled_parted):
            raise AssertionError(
                f"generate {dtype_name}: sampled streams part where the "
                f"sampler's rows lie off the f32 model: {sampled_parted}")

        (seqs, scores), wall = counted(
            "beam", lambda: beam_generate(lm, beam_prompt, beam_size=4,
                                          decode_length=32, alpha=0.6,
                                          compute_dtype=dt), 32)
        lp = model_logp(lm, beam_prompt + seqs[0].tolist())
        at = torch.arange(len(beam_prompt) - 1, len(beam_prompt) + 31,
                          device=lp.device)
        tok = torch.as_tensor(seqs[0].astype(np.int64), device=lp.device) - 1
        penalty = ((5.0 + 32) / 6.0) ** 0.6
        rescored = float(lp[at, tok].sum()) / penalty
        rel = abs(float(scores[0]) - rescored) / abs(rescored)
        # bf16: each of the 32 log-probs within BF16_LOGP_TOL of the f32
        # model's, so the penalised sum within 32 x that over the penalty
        beam_rtol = 1e-4 if dt is None else \
            32 * BF16_LOGP_TOL / penalty / abs(rescored)
        # the carry gather per step copies every leaf of the beam-4 carry:
        # each layer's (4, 512, 12, 64) K and V caches, and pos
        copied = sum(t.numel() * t.element_size()
                     for t in get_decode_step(lm, dt)[1](4).values())
        emit("generate", beam=4, dtype=dtype_name, wall_s=wall,
             scores=scores.tolist(), top_score=float(scores[0]),
             rescored=rescored, rel_err=rel, rel_tol=beam_rtol,
             gather_bytes_copied_per_step=copied,
             gather_bytes_moved_per_step=2 * copied)
        if not (np.all(np.diff(scores) <= 0) and rel <= beam_rtol
                and ((seqs >= 1) & (seqs <= V)).all()):
            raise AssertionError(f"beam {dtype_name}: scores {scores}, "
                                 f"rescored {rescored} (rel {rel})")

        step, init = get_decode_step(lm, dt)
        P = serving_params(lm, dt)
        prefill = get_prefill_step(lm, dt)
        for batch in (1, 4):
            ptoks = torch.tensor([[t - 1 for t in beam_prompt]] * batch,
                                 device=lm[0].weight.device)
            with torch.no_grad():
                _, carry = prefill(P, ptoks, init(batch))
            tok = torch.zeros((batch,), dtype=torch.int64,
                              device=ptoks.device)
            times = []

            def decode():
                nonlocal carry
                for _ in range(32):
                    t = time.perf_counter()
                    logp, carry = step(P, tok, carry)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)

            _, wall = counted(f"step b{batch}", decode, 32)

            def traced():
                nonlocal carry
                for _ in range(8):
                    _, carry = step(P, tok, carry)

            emit("generate", decode_step_batch=batch, dtype=dtype_name,
                 step_p50_ms=float(np.percentile(times, 50)) * 1e3,
                 tok_s=batch * 32 / wall,
                 per_step=window_counts(traced, "decode_step", 8))
    return total, 0


# -- the other BASELINE models: VGG-16, Inception-v1, the text classifier ----

#: card vs CPU: the same steps from the same weights, dropout off, TF32
#: off, compared as the largest loss difference over the steps relative to
#: the CPU's loss and the largest parameter difference after the last step
#: relative to that tensor's largest CPU value. In f32 a deep ReLU net's
#: two runs part at near-ties: a ReLU input or a max-pool window whose
#: sign or choice one ulp decides routes a gradient elsewhere (the VGG
#: tests against JAX find one in three steps at batch 4), and batch
#: statistics over the last stage's few values amplify it: on an H100 at
#: 700 W, three f32 VGG steps at batch 8 parted from the CPU's by 2.6% in
#: some tensor after one step and by 2% in the third loss. So VGG and
#: Inception are held in f32 on the first step's loss (a forward, no
#: routing; measured 1.3e-6) and on every loss and parameter in float64,
#: where no such tie occurs: each step's f64 arithmetic differs from the
#: CPU's by rounding only. The LSTM has no
#: such point, and the text classifier is held in f32 throughout (an f32
#: run parts from float64 by 3.6e-7 in three steps on the CPU).
BASELINE_CARD_TOL = {"vgg": {"f32_loss": 1e-5, "f64": 1e-9},
                     "alexnet": {"f32_loss": 1e-5, "f64": 1e-9},
                     "keras_resnet50": {"f32_loss": 1e-5, "f64": 1e-9},
                     "keras_imdb": {"f32_loss": 1e-5, "f32_param": 1e-5,
                                    "f64": 1e-9},
                     "inception": {"f32_loss": 1e-5, "f64": 1e-9},
                     "textclassifier": {"f32_loss": 1e-5, "f32_param": 1e-5,
                                        "f64": 1e-9}}


def train_steps(model, batches, criterion, method):
    """``model`` (its parameters, buffers, device and dtype) through the
    port's train step on each (input, target) batch with no generator
    (Dropout and the LSTM's dropout inactive); float inputs take the
    model's dtype. Returns (losses, final params on the CPU)."""
    import torch

    from bigdl_tpu_torch.optim.train_step import make_train_step

    p0 = next(model.parameters())
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    opt = method.init_state(params)
    step = make_train_step(model.train(), criterion, method)
    losses = []
    for x, y in batches:
        x = torch.as_tensor(x).to(p0.device)
        params, opt, state, loss = step(
            params, opt, state, None, x.to(p0.dtype), torch.as_tensor(y)
            .to(p0.device))
        losses.append(float(loss))
    return losses, {k: v.detach().cpu() for k, v in params.items()}


def card_vs_cpu(build, batches, criterion, make_method, dtype,
                device="cuda"):
    """The same steps from the same weights in ``dtype`` on ``device``
    and on the CPU (see ``BASELINE_CARD_TOL``)."""
    import copy

    cpu = build().to(dtype)
    dev = copy.deepcopy(cpu).to(device)
    cl, cp = train_steps(cpu, batches, criterion, make_method())
    dl, dp = train_steps(dev, batches, criterion, make_method())
    return {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(dl, cl)),
            "param_rel_err": max(float((dp[k] - v).abs().max())
                                 / max(float(v.abs().max()), 1e-30)
                                 for k, v in cp.items()),
            "cpu_losses": cl, "card_losses": dl}


def held_on_card(phase, build, batches, criterion, make_method):
    """The phase's card-vs-CPU checks (``BASELINE_CARD_TOL``): f32 on the
    first batch only where the tolerance holds no f32 parameters, f32 on
    every batch otherwise, and float64 on every batch."""
    import torch

    tol = BASELINE_CARD_TOL[phase]
    f32_batches = batches if "f32_param" in tol else batches[:1]
    out = {"f32": card_vs_cpu(build, f32_batches, criterion, make_method,
                              torch.float32),
           "f64": card_vs_cpu(build, batches, criterion, make_method,
                              torch.float64)}
    ok = (out["f32"]["loss_rel_err"] <= tol["f32_loss"]
          and out["f32"]["param_rel_err"] <= tol.get("f32_param", float("inf"))
          and out["f64"]["loss_rel_err"] <= tol["f64"]
          and out["f64"]["param_rel_err"] <= tol["f64"])
    return out, ok


def optimizer_window(model, samples, criterion, method, batch, steps):
    """A closure running ``steps`` iterations of ``Optimizer`` on
    ``model`` (a copy each call): what ``window_counts`` profiles."""
    import copy

    from bigdl_tpu_torch.optim import Optimizer, Trigger

    def run():
        m = copy.deepcopy(model)
        o = Optimizer(m, samples, criterion, batch_size=batch,
                      end_trigger=Trigger.max_iteration(steps))
        o.set_optim_method(copy.deepcopy(method))
        o.optimize()

    return run


def main_run(train_main, argv, batch):
    """``train_main(argv + --summary)`` on the card: (model, wall s, step
    seconds from the ``Throughput`` scalars, losses, peak GiB)."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.visualization import TrainSummary

    summary = tempfile.mkdtemp(prefix="summary_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = train_main(argv + ["--summary", summary])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ts = TrainSummary(summary, "train")
    losses = [v for _, v in ts.read_scalar("Loss")]
    step_s = [batch / v for _, v in ts.read_scalar("Throughput")]
    ts.close()
    shutil.rmtree(summary, ignore_errors=True)
    return model, wall, step_s, losses, peak


def baseline_emit(phase, what, batch, wall, step_s, losses, peak, counts,
                  card_check, unit="images"):
    """Print the phase's figures; raise on a non-finite loss or a
    card-vs-CPU check beyond ``BASELINE_CARD_TOL``. Returns step p50 s."""
    check, ok = card_check
    p50 = float(np.median(step_s[1:] if len(step_s) > 1 else step_s))
    emit(phase, what=what, card=nvidia_smi(), batch=batch, wall_s=wall,
         steps=len(step_s), step_ms=[s * 1e3 for s in step_s],
         step_ms_p50=p50 * 1e3, **{f"{unit}_per_s": batch / p50},
         losses=losses, peak_mem_gib=peak, per_step=counts,
         card_vs_cpu=check, tol=BASELINE_CARD_TOL[phase])
    if not np.isfinite(losses).all():
        raise AssertionError(f"{phase} losses {losses}")
    if not ok:
        raise AssertionError(f"{phase} card vs CPU {check} beyond "
                             f"{BASELINE_CARD_TOL[phase]}")
    return p50


def vgg_phase():
    """BASELINE config #2 (see the phase list). No port kernel runs on
    this path: its 3x3 convolutions are cuDNN's ``F.conv2d``."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.dataset.cifar import load_samples
    from bigdl_tpu_torch.models.vgg import VggForCifar10, test_main, train_main
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD

    work = tempfile.mkdtemp(prefix="vgg_")
    try:
        ckpt = os.path.join(work, "ckpt")
        model, wall, step_s, losses, peak = main_run(
            train_main, ["--synthetic", "1024", "-b", "128",
                         "--maxIteration", "8", "--cache", ckpt], 128)
        (res,) = test_main(["--synthetic", "512", "--model",
                            os.path.join(ckpt, "model")])
        top1, scored = res.result()
        samples = load_samples("/nonexistent", "train", synthetic_count=512)
        window = optimizer_window(model, samples, ClassNLLCriterion(),
                                  SGD(0.01, momentum=0.9), 128, 4)
        window()                                   # warm
        counts = window_counts(window, "vgg_train", 4)
        rng = np.random.default_rng(31)
        batches = [(rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
                    rng.integers(1, 11, 8).astype(np.float32))
                   for _ in range(3)]
        check = held_on_card(
            "vgg", lambda: VggForCifar10(
                10, has_dropout=False, device="cpu",
                generator=torch.Generator().manual_seed(3)),
            batches, ClassNLLCriterion(), lambda: SGD(0.01, momentum=0.9))
        p50 = baseline_emit(
            "vgg", "VggForCifar10 train_main (Dropout on, batch 128, 32², "
            "SGD 0.01/0.9, 8 iterations, --cache) + test_main; card vs CPU "
            "at batch 8, dropout off: 1 f32 step, 3 f64 steps", 128, wall, step_s,
            losses, peak, counts,
            check)
        emit("vgg", what="test_main on the snapshot", top1=top1,
             scored=scored, checkpoint=sorted(os.listdir(ckpt)))
        if scored != 512:
            raise AssertionError(f"vgg test_main scored {scored} of 512")
        return {"vgg_step_ms_p50": p50 * 1e3}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def inception_phase():
    """BASELINE config #4 (see the phase list). No port kernel runs on
    this path: cuDNN convolutions and plain-op LRNs."""
    import torch

    from bigdl_tpu_torch.models.inception import (
        Inception_v1, Inception_v1_NoAuxClassifier, train_main,
    )
    from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples
    from bigdl_tpu_torch.nn import ClassNLLCriterion, ParallelCriterion
    from bigdl_tpu_torch.optim import SGD, Poly

    model, wall, step_s, losses, peak = main_run(
        train_main, ["--synthetic", "384", "-b", "64",
                     "--maxIteration", "6"], 64)
    samples = synthetic_imagenet_samples(128, seed=5)
    window = optimizer_window(
        model, samples, ClassNLLCriterion(),
        SGD(0.01, momentum=0.9, learning_rate_schedule=Poly(0.5, 62000)),
        64, 2)
    window()
    counts = window_counts(window, "inception_train", 2)
    del model
    torch.cuda.empty_cache()
    # Inception_v1's three heads through ParallelCriterion, Dropout on
    from bigdl_tpu_torch.optim.train_step import make_train_step

    aux = Inception_v1(1000)
    dev = next(aux.parameters()).device
    crit = ParallelCriterion(repeat_target=True)
    for w in (1.0, 0.3, 0.3):
        crit.add(ClassNLLCriterion(), w)
    method = SGD(0.01, momentum=0.9)
    params = {k: p.detach().clone() for k, p in aux.named_parameters()}
    x = torch.from_numpy(np.stack([s.feature() for s in samples[:64]]))
    y = torch.tensor([float(s.label()) for s in samples[:64]])
    step = make_train_step(aux.train(), crit, method)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, _, _, aux_loss = step(
        params, method.init_state(params),
        {k: b.detach().clone() for k, b in aux.named_buffers()},
        torch.Generator(device=dev).manual_seed(1), x.to(dev), y.to(dev))
    aux_loss = float(aux_loss)
    aux_s = time.perf_counter() - t0
    aux_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(new[k], p) for k, p in
                aux.named_parameters())
    del aux, params, new
    torch.cuda.empty_cache()
    rng = np.random.default_rng(32)
    batches = [(rng.standard_normal((2, 3, 224, 224)).astype(np.float32),
                rng.integers(1, 1001, 2).astype(np.float32))
               for _ in range(2)]
    check = held_on_card(
        "inception", lambda: Inception_v1_NoAuxClassifier(
            1000, has_dropout=False, device="cpu",
            generator=torch.Generator().manual_seed(4)),
        batches, ClassNLLCriterion(), lambda: SGD(0.01, momentum=0.9))
    p50 = baseline_emit(
        "inception", "Inception_v1_NoAuxClassifier(1000) train_main "
        "(Dropout on, batch 64, 224², SGD 0.01/0.9 with Poly(0.5, 62000), "
        "6 iterations); card vs CPU at batch 2, dropout off: 1 f32 step, "
        "2 f64 steps",
        64, wall, step_s, losses, peak, counts,
        check)
    emit("inception", what="Inception_v1 (three heads) one train step "
         "through ParallelCriterion(1.0, 0.3, 0.3), batch 64, Dropout on",
         step_s=aux_s, peak_mem_gib=aux_peak, params_moved=moved,
         loss=aux_loss)
    if not (moved and np.isfinite(aux_loss)):
        raise AssertionError(f"Inception_v1's step: loss {aux_loss}, "
                             f"{moved} parameters moved")
    return {"inception_step_ms_p50": p50 * 1e3}


def textclassifier_phase():
    """BASELINE config #5 (see the phase list). No port kernel runs on
    this path: the recurrence is plain PyTorch ops and cuBLAS products."""
    import torch

    from bigdl_tpu_torch.models.textclassifier import (
        TextClassifier, synthetic_samples, train_main,
    )
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Adagrad
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    model, wall, step_s, losses, peak = main_run(train_main, [], 32)
    held_out = synthetic_samples(768, 500, 5, 50)[512:]
    (res,) = model.evaluate(held_out, [Top1Accuracy()], batch_size=32)
    top1, scored = res.result()
    window = optimizer_window(model.train(), held_out, ClassNLLCriterion(),
                              Adagrad(0.05), 32, 2)
    window()
    counts = window_counts(window, "textclassifier_train", 2)
    # launches per time step and direction of the recurrence
    counts["per_time_step_and_direction"] = (
        counts["device_launches"] / (50 * 2))
    # SGD, not Adagrad: Adagrad's first update is lr * sign(g) per
    # element, which two summation orders flip where g is near 0
    rng = np.random.default_rng(33)
    batches = [(rng.integers(1, 501, (32, 50)).astype(np.float32),
                rng.integers(1, 6, 32).astype(np.float32)) for _ in range(3)]
    check = held_on_card(
        "textclassifier", lambda: TextClassifier(
            5, embedding_dim=64, vocab_size=500, embedding_input=False,
            device="cpu", generator=torch.Generator().manual_seed(5)),
        batches, ClassNLLCriterion(), lambda: SGD(0.05))
    p50 = baseline_emit(
        "textclassifier", "train_main synthetic defaults (vocab 500, seqLen "
        "50, 5 classes, embedding 64, hidden 128, BiRecurrent LSTM, batch "
        "32, Adagrad 0.05, 3 epochs of 512); card vs CPU at batch 32: 3 "
        "SGD steps in f32 and in f64", 32, wall, step_s, losses, peak, counts,
        check, unit="samples")
    emit("textclassifier", what="Top-1 on 256 held-out synthetic samples",
         top1=top1, scored=scored, chance=0.2)
    if not (scored == 256 and top1 > 0.2):
        raise AssertionError(f"text classifier Top-1 {top1} on {scored} "
                             "held-out samples does not beat chance (0.2)")
    return {"textclassifier_step_ms_p50": p50 * 1e3,
            "textclassifier_top1": top1}


def image_folder(root: str, per_class: int = 64) -> str:
    """A 512-image, 8-class ImageNet-style folder under ``root``: class i
    holds ``per_class`` copies of committed fixture i (ImageNet-like and
    odd sizes, 199x257 to 640x480)."""
    import os

    names, blobs, _ = fixture_blobs()
    folder = os.path.join(root, "imagenet")
    for ci, (name, data) in enumerate(zip(names, blobs)):
        cdir = os.path.join(folder, f"n{ci:08d}")
        os.makedirs(cdir)
        for j in range(per_class):
            with open(os.path.join(cdir, f"{j:04d}_{name}"), "wb") as f:
                f.write(data)
    return folder


def resnet_folder_phase():
    """ResNet's and Inception-v1's mains on an image folder (see the phase
    list): the folder's load seconds (decode, ``/ 255``, resize to 224²),
    step p50 and peak memory; finite losses."""
    import shutil
    import tempfile

    import torch

    import bigdl_tpu_torch.dataset.image as dimg
    from bigdl_tpu_torch.models import inception, resnet

    work = tempfile.mkdtemp(prefix="resnet_folder_")
    load = []
    loader = dimg.image_folder_samples

    def timed_load(path, image_size=224):
        t0 = time.perf_counter()
        out = loader(path, image_size=image_size)
        load.append((time.perf_counter() - t0, len(out)))
        return out

    dimg.image_folder_samples = timed_load
    out = {}
    try:
        folder = image_folder(work)
        for name, main, argv, batch in (
                ("resnet50", resnet.train_main,
                 ["--dataset", "imagenet", "-f", folder, "-b", "128",
                  "--maxIteration", "8", "--computeDtype", "bf16"], 128),
                ("inception_v1", inception.train_main,
                 ["-f", folder, "-b", "64", "--maxIteration", "6"], 64)):
            model, wall, step_s, losses, peak = main_run(main, argv, batch)
            del model
            torch.cuda.empty_cache()
            load_s, n = load[-1]
            p50 = float(np.median(step_s[1:]))
            emit("resnet_folder", what=f"{name} train_main -f (512 JPEGs, "
                 f"8 classes, batch {batch}, {len(step_s)} iterations)",
                 card=nvidia_smi(), folder_images=n, folder_load_s=load_s,
                 folder_images_per_s=n / load_s, wall_s=wall,
                 step_ms=[t * 1e3 for t in step_s], step_ms_p50=p50 * 1e3,
                 images_per_s=batch / p50, peak_mem_gib=peak, losses=losses)
            if n != 512 or not (len(losses) == len(step_s) > 0
                                and np.isfinite(losses).all()):
                raise AssertionError(f"{name} on the folder: {n} images, "
                                     f"losses {losses}")
            out[name] = p50 * 1e3
    finally:
        dimg.image_folder_samples = loader
        shutil.rmtree(work, ignore_errors=True)
    return out


def news20_archive(root: str, docs_per_group: int = 25) -> str:
    """A small ``20news-18828.tar.gz`` under ``root``: 20 groups (sorted
    names, so group c is label c + 1) of messages drawn from the
    synthetic corpus's words with each group's own keywords."""
    import io
    import os
    import tarfile

    os.makedirs(root)
    rng = np.random.RandomState(7)
    with tarfile.open(os.path.join(root, "20news-18828.tar.gz"), "w:gz") \
            as tf:
        for c in range(20):
            for d in range(docs_per_group):
                words = [f"topic{c}word{rng.randint(8)}" if rng.rand() < 0.5
                         else f"common{rng.randint(16)}"
                         for _ in range(rng.randint(20, 60))]
                body = ("From: a@b\nSubject: s\n\n" + " ".join(words)).encode(
                    "latin1")
                info = tarfile.TarInfo(f"20news-18828/group{c:02d}/{d}")
                info.size = len(body)
                tf.addfile(info, io.BytesIO(body))
    return root


def text_news20_phase():
    """The text classifier's ``--news20`` main (see the phase list): on
    the synthetic corpus and on an archive written here; step p50,
    samples/s and Top-1 on its own samples, above chance (1/20)."""
    import os
    import shutil
    import tempfile

    from bigdl_tpu_torch.models.textclassifier import (
        news20_samples, train_main,
    )
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    work = tempfile.mkdtemp(prefix="news20_")
    out = {}
    try:
        synthetic = os.path.join(work, "synthetic")
        os.makedirs(synthetic)
        for what, folder in (("synthetic corpus", synthetic),
                             ("archive", news20_archive(
                                 os.path.join(work, "archive")))):
            model, wall, step_s, losses, peak = main_run(
                train_main, ["--news20", "-f", folder], 32)
            samples, classes = news20_samples(folder, 50, 64)
            (res,) = model.evaluate(samples, [Top1Accuracy()],
                                    batch_size=32)
            top1, scored = res.result()
            p50 = float(np.median(step_s[1:]))
            emit("text_news20", what=f"train_main --news20 on the {what} "
                 f"({len(samples)} texts, {classes} classes; seqLen 50, "
                 "embedding 64, batch 32, Adagrad 0.05, 3 epochs)",
                 card=nvidia_smi(), wall_s=wall, steps=len(step_s),
                 step_ms_p50=p50 * 1e3, samples_per_s=32 / p50,
                 peak_mem_gib=peak, first_loss=losses[0],
                 last_loss=losses[-1], top1=top1, scored=scored,
                 chance=1 / classes)
            if not (np.isfinite(losses).all() and top1 > 1 / classes):
                raise AssertionError(f"--news20 on the {what}: losses "
                                     f"{losses[:3]}..., Top-1 {top1}")
            out[what] = {"step_ms_p50": p50 * 1e3, "top1": top1}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- data-parallel training through DistriOptimizer (world size 1, NCCL) ---

#: distri_vgg's partitioned and allreduce runs against LocalOptimizer from
#: the same weights, 3 f32 steps, dropout off, ``cudnn.deterministic``:
#: the same convolutions and the same elementwise SGD on the same values,
#: so the parameters and losses are held bitwise (a tolerance of 0). At
#: world size 1 the reduce-scatter, all-gather and all-reduce copy their
#: input and the division by n is by 1.
DISTRI_CARD_TOL = 0.0
#: distri_vgg's bf16-compressed run against the f32 partitioned run from
#: the same weights and masks: each of the 8 losses within 2e-2 relative
#: (bf16 keeps 8 bits of each gradient, and 8 steps compound it: two
#: card runs measured 3.7e-3 and 6.2e-3). Neither run's loss falls in 8
#: steps of this recipe (2.39 to 2.46-2.48), so the f32 run is the check.
BF16_EXCHANGE_TOL = 2e-2
#: ... and apart from it by more than 1e-4 relative in some loss: an f32
#: exchange would part from the f32 run by cuDNN's run-to-run noise only
#: (the two card runs above measured 3.7e-3 and 6.2e-3 for bf16).
BF16_EXCHANGE_FLOOR = 1e-4


@contextlib.contextmanager
def nccl_world_of_one():
    """A one-rank NCCL group (``Engine.init_distributed`` at a ``file://``
    rendezvous in a temp dir), its first collective warmed outside any
    timed window, destroyed on exit so later phases see no group."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.parallel import all_reduce as ar
    from bigdl_tpu_torch.utils.engine import Engine

    work = tempfile.mkdtemp(prefix="rdv_")
    Engine.init_distributed(
        coordinator_address="file://" + os.path.join(work, "rdv"),
        num_processes=1, process_id=0, device="cuda", timeout_s=300)
    try:
        ar.all_reduce_sum(torch.ones(8, device="cuda"))   # NCCL starts lazily
        torch.cuda.synchronize()
        yield
    finally:
        Engine.shutdown()
        shutil.rmtree(work, ignore_errors=True)


class TimedStore:
    """A block store whose every call adds its wall time to ``seconds``
    (a call the store makes to itself counts once, in its caller)."""

    def __init__(self, inner) -> None:
        self.inner, self.seconds = inner, 0.0

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0

        return timed


def distri_run(build, samples, batch, steps, method, mode, compress=None,
               compute=None, warm=1, store=None):
    """``build()``'s (model, criterion) trained through ``optimize()`` for
    ``steps`` iterations: ``LocalOptimizer`` for ``mode="local"``, else
    ``DistriOptimizer(parameter_mode=mode)`` on ``DataSet.distributed``
    (``block_store=store``, a :class:`TimedStore`, where given). Returns
    (model, optimizer, the figures every distri phase prints)."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Optimizer, Trigger
    from bigdl_tpu_torch.parallel import all_reduce as ar

    model, crit = build()
    losses, comm, store_s = [], {}, []

    def record_then_stop(state):       # the trigger reads every step's loss
        if state["loss"] is not None:
            losses.append(state["loss"])
        if state["neval"] == 1:        # the steps' collectives, not the
            ar.comm["calls"] = ar.comm["bytes"] = 0   # start's broadcast
            if store is not None:
                store.seconds = 0.0
        elif state["neval"] == steps + 1:             # or the write-back
            comm.update(ar.comm)
            if store is not None:
                store_s.append(store.seconds)
        return state["neval"] > steps

    local = mode == "local"
    kw = {} if local else {"parameter_mode": mode, "compress": compress}
    if store is not None:
        kw["block_store"] = store
    opt = Optimizer(model, (DataSet.array if local else DataSet.distributed)(
        samples), crit, batch_size=batch, end_trigger=Trigger(
            record_then_stop, Trigger.max_iteration(steps).peek), **kw)
    opt.set_optim_method(method)
    if compute is not None:
        opt.set_compute_dtype(compute)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"distri {mode} losses {losses}")
    step_s = opt.metrics.values("computing time")
    p50 = float(np.median(step_s[warm:]))
    figures = {"mode": mode + (f"+{compress}" if compress else ""),
               "steps": steps, "warm": warm, "wall_s": wall,
               "step_ms": [s * 1e3 for s in step_s],
               "step_ms_p50": p50 * 1e3, "images_per_s": batch / p50,
               "nccl_calls_per_step": comm["calls"] / steps,
               "nccl_bytes_per_step": comm["bytes"] / steps,
               "host_bytes_per_step": getattr(opt, "host_bytes", 0) / steps,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "losses": losses}
    if store is not None:
        figures["store_ms_per_step"] = store_s[0] * 1e3 / steps
    return model, opt, figures


def distri_window(build, samples, batch, method, mode, compress=None,
                  compute=None, steps=4):
    """A closure running ``steps`` iterations of a fresh model and a copy
    of ``method`` (a method carries its iteration count; what
    ``window_counts`` profiles for launches per step)."""
    def run():
        import copy

        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.optim import Optimizer, Trigger

        model, crit = build()
        local = mode == "local"
        kw = {} if local else {"parameter_mode": mode, "compress": compress}
        o = Optimizer(model, (DataSet.array if local
                              else DataSet.distributed)(samples), crit,
                      batch_size=batch, end_trigger=Trigger.max_iteration(
                          steps), **kw)
        o.set_optim_method(copy.deepcopy(method))
        if compute is not None:
            o.set_compute_dtype(compute)
        o.optimize()
        if o.optim_method.state["neval"] != steps + 1:
            raise AssertionError(f"window ran to {o.optim_method.state}")

    return run


def distri_vgg_phase(batch: int = 128, steps: int = 8,
                     n_samples: int = 1024):
    """BASELINE config #2 through ``DistriOptimizer`` at world size 1 on
    NCCL (see the phase list)."""
    import copy

    import torch

    from bigdl_tpu_torch.dataset.cifar import load_samples
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import default_block_store

    samples = load_samples("/nonexistent", "train",
                           synthetic_count=n_samples)
    card = nvidia_smi()
    sgd = SGD(0.01, momentum=0.9)

    def build(dropout=True, seed=3):
        return (VggForCifar10(10, has_dropout=dropout,
                              generator=torch.Generator(device="cuda")
                              .manual_seed(seed)), ClassNLLCriterion())

    runs, finals = {}, {}
    with nccl_world_of_one():
        for mode, compress in (("local", None), ("partitioned", None),
                               ("partitioned", "bf16"), ("allreduce", None),
                               ("blockstore", None), ("local", None)):
            store = TimedStore(default_block_store()) \
                if mode == "blockstore" else None
            model, opt, fig = distri_run(build, samples, batch, steps,
                                         copy.deepcopy(sgd), mode, compress,
                                         store=store)
            if mode == "partitioned":
                fig["padded_size"] = opt._arp.padded_size
            slots = opt._final_opt_state["velocity"]
            fig["dtypes"] = {"parameters": str(next(model.parameters()).dtype),
                             "slots": str(next(iter(slots.values())).dtype)}
            del model, opt
            torch.cuda.empty_cache()
            window = distri_window(build, samples[:4 * batch], batch,
                                   copy.deepcopy(sgd), mode, compress)
            window()                                   # warm
            counts = window_counts(window, f"distri_vgg_{fig['mode']}", 4)
            fig["launches_per_step"] = counts["device_launches"]
            fig["host_waits_per_step"] = counts["host_waits"]
            if fig["mode"] in runs:             # the closing local run
                fig["mode"] += " (again)"
            runs[fig["mode"]] = fig
            emit("distri_vgg", card=card, batch=batch, **fig)
        # bf16 on the gradient exchange only: f32 masters and slots, each
        # step's reduce-scatter sent in 2 bytes an element (the run's
        # collectives move 2 x the padded size fewer bytes per step), and
        # the losses apart from the f32 run's by more than
        # BF16_EXCHANGE_FLOOR and less than BF16_EXCHANGE_TOL
        bf16, f32 = runs["partitioned+bf16"], runs["partitioned"]
        bf16["loss_rel_err_vs_f32"] = max(
            abs(a - b) / abs(b) for a, b in zip(bf16["losses"],
                                                 f32["losses"]))
        bf16["bytes_saved_per_step"] = (f32["nccl_bytes_per_step"]
                                        - bf16["nccl_bytes_per_step"])
        if set(bf16["dtypes"].values()) != {"torch.float32"} or \
                bf16["bytes_saved_per_step"] != 2 * f32["padded_size"] or \
                not BF16_EXCHANGE_FLOOR < bf16["loss_rel_err_vs_f32"] \
                <= BF16_EXCHANGE_TOL:
            raise AssertionError(f"bf16-compressed gradients: {bf16}")
        emit("distri_vgg", what="partitioned+bf16 against partitioned (f32 "
             "exchange)", card=card, padded_size=f32["padded_size"],
             bytes_saved_per_step=bf16["bytes_saved_per_step"],
             loss_rel_err_vs_f32=bf16["loss_rel_err_vs_f32"],
             floor=BF16_EXCHANGE_FLOOR, tol=BF16_EXCHANGE_TOL)
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for mode in ("local", "partitioned", "allreduce"):
                model, opt, fig = distri_run(
                    lambda: build(False, 4), samples[:3 * batch], batch, 3,
                    copy.deepcopy(sgd), mode)
                finals[mode] = ([p.detach().clone() for _, p in
                                 model._jax_ordered()], fig["losses"])
                del model, opt
        finally:
            torch.backends.cudnn.deterministic = det
    parity = {}
    for mode in ("partitioned", "allreduce"):
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(finals[mode][0], finals["local"][0]))
        parity[mode] = {"param_max_abs_diff": diff,
                        "losses": finals[mode][1],
                        "local_losses": finals["local"][1]}
    emit("distri_vgg", what="partitioned and allreduce against "
         "LocalOptimizer from the same weights: 3 f32 steps, batch 128, "
         "dropout off, cudnn.deterministic", card=card, tol=DISTRI_CARD_TOL,
         **parity)
    for mode, p in parity.items():
        if p["param_max_abs_diff"] > DISTRI_CARD_TOL or \
                p["losses"] != p["local_losses"]:
            raise AssertionError(f"distri_vgg {mode} against local: {p}")
    return runs


def distri_resnet_phase(warm: int = 2, timed: int = 5, batch: int = 256):
    """ResNet-50 on the bench.py recipe through ``DistriOptimizer``
    (partitioned) at world size 1 on NCCL, paired with the same recipe
    through ``LocalOptimizer`` (see the phase list); returns the fused
    kernels' launch counts over the distributed run."""
    import copy
    import os

    import torch

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import maybe_fuse
    from bigdl_tpu_torch.ops import fused_conv as fc
    from bigdl_tpu_torch.optim import SGD

    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 3, 224, 224), dtype=np.float32)
    y = rng.integers(1, 1001, size=batch).astype(np.int32)
    samples = [Sample(x[i], y[i]) for i in range(batch)]
    sgd = SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    steps, card = warm + timed, nvidia_smi()

    def build():
        return (maybe_fuse(ResNet(1000, {"depth": 50, "shortcutType": "B"},
                                  seed=0)), CrossEntropyCriterion())

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "128"
    figs = {}
    launches = {"fwd": 0, "dgrad": 0, "wgrad": 0}
    try:
        with nccl_world_of_one():
            # in turns, so a drift of the host shows on both sides
            for mode, turn in (("local", 1), ("partitioned", 1),
                               ("partitioned", 2), ("local", 2)):
                fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
                fc.aligned_clones = 0
                model, opt, fig = distri_run(build, samples, batch, steps,
                                             copy.deepcopy(sgd), mode,
                                             compute="bf16", warm=warm)
                fig["fused_launches"] = {"fwd": fc.fwd_launches,
                                         "dgrad": fc.dgrad_launches,
                                         "wgrad": fc.wgrad_launches}
                fig["aligned_clones_per_step"] = fc.aligned_clones / steps
                fig["turn"] = turn
                del model, opt
                torch.cuda.empty_cache()
                if turn == 1:
                    window = distri_window(build, samples, batch,
                                           copy.deepcopy(sgd), mode,
                                           compute="bf16", steps=2)
                    counts = window_counts(window, f"distri_resnet_{mode}",
                                           2)
                    fig["launches_per_step"] = counts["device_launches"]
                    fig["host_waits_per_step"] = counts["host_waits"]
                    torch.cuda.empty_cache()
                figs[mode, turn] = fig
                emit("distri_resnet", card=card, batch=batch, image=224,
                     compute="bf16", optim="SGD(0.1, momentum 0.9, weight "
                     "decay 1e-4)", fused="maybe_fuse, "
                     "BIGDL_PALLAS_MIN_C=128", **fig)
                if mode == "partitioned":
                    for name, n in fig["fused_launches"].items():
                        if n != 28 * steps:
                            raise AssertionError(
                                f"distri_resnet: fused {name} launched {n} "
                                f"times, expected 28 edges x {steps} steps")
                        launches[name] += n
    finally:
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    print(json.dumps({
        "distri_resnet50_step_ms_p50": [figs["partitioned", t]["step_ms_p50"]
                                        for t in (1, 2)],
        "local_resnet50_step_ms_p50": [figs["local", t]["step_ms_p50"]
                                       for t in (1, 2)],
        "distri_images_per_s": [figs["partitioned", t]["images_per_s"]
                                for t in (1, 2)]}))
    return launches


def distri_pod_phase():
    """``examples/distributed_pod.main`` on the card (see the phase list):
    an uninterrupted run to iteration 10, a run to 5 with a checkpoint and
    its ``--resume`` to 10, bitwise equal under ``cudnn.deterministic``."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.examples import distributed_pod as pod
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.optim import distri_optimizer as dmod
    from bigdl_tpu_torch.parallel import all_reduce as ar

    work = tempfile.mkdtemp(prefix="pod_")
    seen, step_comm = [], []
    prepare = dmod.DistriOptimizer._prepare

    def keep(self):                       # the runs' optimizers, for figures
        seen.append(self)
        end = self.end_when

        def count(state):   # the collectives of steps 1 to the last only
            done = end(state)
            if state["neval"] == 1:
                ar.comm["calls"] = ar.comm["bytes"] = 0
            elif done:
                step_comm.append((state["neval"] - 1, dict(ar.comm)))
            return done

        self.end_when = Trigger(count, end.peek)
        return prepare(self)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dmod.DistriOptimizer._prepare = keep
    try:
        base = ["-b", "64", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = pod.main(base + ["--maxIteration", "10", "--checkpoint",
                                 os.path.join(work, "a")])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_s = seen[-1].metrics.values("computing time")
        pod.main(base + ["--maxIteration", "5", "--checkpoint",
                         os.path.join(work, "b")])
        resumed = pod.main(base + ["--maxIteration", "10", "--checkpoint",
                                   os.path.join(work, "b"), "--resume"])
        window = lambda: pod.main(base + ["--maxIteration", "4"])  # noqa
        window()     # no checkpoint, no validation (every 10): steps only
        steps, comm = step_comm[-1]
        counts = window_counts(window, "distri_pod", 4)
    finally:
        dmod.DistriOptimizer._prepare = prepare
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(work, ignore_errors=True)
    unequal = [k for (k, a), (_, b) in zip(whole.named_parameters(),
                                           resumed.named_parameters())
               if not torch.equal(a, b)]
    p50 = float(np.median(step_s[1:]))
    emit("distri_pod", what="examples/distributed_pod.main: LeNet-5, batch "
         "64, partitioned, 10 iterations; 5 + --resume 5 against 10",
         card=nvidia_smi(), wall_s=wall, step_ms=[s * 1e3 for s in step_s],
         step_ms_p50=p50 * 1e3, images_per_s=64 / p50,
         nccl_calls_per_step=comm["calls"] / steps,
         nccl_bytes_per_step=comm["bytes"] / steps,
         launches_per_step=counts["device_launches"],
         host_waits_per_step=counts["host_waits"], peak_mem_gib=peak,
         resumed_parameters_unequal=unequal)
    if unequal:
        raise AssertionError(f"distri_pod: the resumed run's {unequal} part "
                             "from the uninterrupted run's")


# -- the transformer LM's knobs and main, sequence parallelism, the parallel planes

#: the 137M LM recipe of ``train_phase`` (``benchmarks/llm_mfu_bench.py``)
LM137 = dict(V=32768, hidden=768, layers=12, heads=12, T=2048, B=8)
#: f32 parameters of a knob run against the unrolled run after 3 steps:
#: 1e-5 absolute, or the spread of two unrolled runs if that is larger
#: (cuBLAS and the kernels sum in a fixed order, so the spread is 0 unless
#: an op reduces with atomics); losses within 1e-5 relative. Adam's step
#: normalises the gradient, so the parameters cannot show a gradient off
#: by a constant factor: the first step's gradients are held too, each
#: leaf's largest error within 1e-5 of its largest gradient, or of a
#: hundredth of the model's largest where the leaf's is smaller (the key
#: bias's gradient is zero in exact arithmetic, rounding noise in f32), or
#: within the two unrolled runs' spread by that measure if it is larger
LM_KNOB_TOL = {"param_abs": 1e-5, "loss_rel": 1e-5, "grad_rel": 1e-5,
               "grad_floor": 1e-2}
#: ``ring_replay``: every row within the kernels' own bf16 tolerance
#: against their plain versions (``ROW_RTOL``, a few bf16 ulps of the row's
#: scale). Each block the schedule runs: against the plain version on the
#: same inputs, as the kernel phase holds them. The merged forward: against
#: the whole-sequence kernel, each row relative to its largest value (the
#: ring rounds each block's O to bf16 before the merge, the kernel once).
#: The summed backward: against the whole-sequence kernel on the ring's
#: own merged O and LSE, each row relative to its largest value (on the
#: whole-sequence forward's O, delta = dO.O differs by O's bf16 ulps: 24%
#: of an early striped row, measured on an H100); and against the plain
#: block grads rounded to bf16 and summed in the ring's order, each row
#: relative to the larger of its largest value and the largest partial
#: summed into it (``summed_row_rel_err``: the ring rounds every partial
#: to bf16 before the sum, the kernel's and the plain version's apart).
#: LSEs: the merged within 1e-3 absolute of the whole-sequence kernel's,
#: each block's within 1e-4 of the plain version's (the kernel phase's)
RING_REPLAY_TOL = {"lse_abs": 1e-3, "block_lse_abs": 1e-4}


def flash_counts():
    from bigdl_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches}


def zero_flash_counts():
    from bigdl_tpu_torch.ops import flash_attention as fa

    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0


def lm_batches(n: int, seed: int):
    """``n`` seeded (ids int32, targets f32) batches of the 137M recipe on
    the card (targets 1..V, none masked)."""
    import torch

    V, T, B = LM137["V"], LM137["T"], LM137["B"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
        y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
        out.append((torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
    return out


def unrolled_order(model, params):
    """``params`` (``{name: tensor}`` of ``model``) as one list in the
    unrolled stack's order: a ``ScanBlocks``' stacked leaves are taken
    layer by layer."""
    from bigdl_tpu_torch.models.transformer import ScanBlocks

    out = []
    for key, child in model._modules.items():
        names = [f"{key}.{n}" for n, _ in child.named_parameters()]
        if isinstance(child, ScanBlocks):
            out += [params[n][i] for i in range(child.n_layers)
                    for n in names]
        else:
            out += [params[n] for n in names]
    return out


def lm_run(steps, batches, kw=None, compute=None, method=None,
           param_dtype=None, grad_transform=None, keep_grads=False):
    """The 137M LM (seed 0, ``kw`` its knobs) through ``steps`` train steps
    of ``make_train_step`` on the card, batch i % len(batches) at step i.
    Returns a dict: losses, per-step seconds, peak GiB, flash launches,
    the optimizer state's bytes and the final parameters (unrolled
    order, on the card); with ``keep_grads`` also the first step's
    gradients as the optimizer took them (unrolled order, on the card)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim.optim_method import Adam
    from bigdl_tpu_torch.optim.train_step import make_train_step

    c = LM137
    lm = TransformerLM(c["V"], hidden_size=c["hidden"], n_heads=c["heads"],
                       n_layers=c["layers"], max_len=c["T"],
                       output="logits", seed=0, **(kw or {}))
    if param_dtype is not None:
        lm = lm.to(param_dtype)
    method = method or Adam(learning_rate=1e-4)
    first = {}

    def transform(grads):
        if grad_transform is not None:
            grads = grad_transform(grads)
        if keep_grads and not first:
            first.update({k: g.detach().clone() for k, g in grads.items()})
        return grads

    step = make_train_step(lm, MaskedSoftmaxCECriterion(0), method,
                           compute_dtype=compute, grad_transform=transform)
    params = {k: p.detach().clone() for k, p in lm.named_parameters()}
    for p in lm.parameters():          # the step reads only ``params``
        p.data = torch.empty(0, device="cuda", dtype=p.dtype)
    state = method.init_state(params)
    state_bytes = sum(t.numel() * t.element_size()
                      for slot in ("m", "v") for t in state[slot].values())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    losses, secs = [], []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        t0 = time.perf_counter()
        params, state, _, loss = step(params, state, {}, None, x, y)
        losses.append(float(loss))              # the step's one sync
        secs.append(time.perf_counter() - t0)
    out = {"losses": losses, "step_s": secs, "flash": flash_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "state_bytes": state_bytes,
           "params": [t.detach() for t in unrolled_order(lm, params)],
           "grads": unrolled_order(lm, first) if keep_grads else None}
    del lm, params, state, step, first
    torch.cuda.empty_cache()
    return out


def summed_row_rel_err(got, want, part_peak, floor: float = 1e-3) -> float:
    """``fa.max_row_rel_err`` for a sum of partials that were each rounded
    to bf16: each row's largest error relative to the larger of its own
    largest ``|want|`` and ``part_peak`` (that row's largest partial, the
    magnitude at which its terms were rounded; the shape of ``got`` less
    its last dim); rows below ``floor`` x the tensor's largest ``|want|``
    against that floor."""
    import torch

    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    row = torch.maximum(w.abs().amax(dim=1), part_peak.reshape(-1))
    scale = row.clamp_min(max(floor * float(w.abs().max()), 1e-30))
    return float(((g - w).abs().amax(dim=1) / scale).max())


def max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def grad_err(got, want) -> float:
    """The largest error of any leaf of ``got`` against ``want`` (lists of
    gradients), relative to that leaf's largest ``want``, or to
    ``LM_KNOB_TOL["grad_floor"]`` of the largest of all where the leaf's
    is smaller."""
    peaks = [float(w.abs().max()) for w in want]
    floor = LM_KNOB_TOL["grad_floor"] * max(peaks)
    return max(float((g - w).abs().max()) / max(p, floor)
               for g, w, p in zip(got, want, peaks))


def lm_knobs_phase(f32_steps: int = 3, warm: int = 2, timed: int = 3):
    """The LM's knobs at full width; returns the flash launches of every
    run (each counted from 0 just before it)."""
    import torch

    from bigdl_tpu_torch.optim.optim_method import Adam

    c, launches = LM137, {"fwd": 0, "dq": 0, "dkv": 0}

    def count(run):
        for k in launches:
            launches[k] += run["flash"][k]
        return run

    batches = lm_batches(f32_steps, seed=1)
    t0 = time.perf_counter()
    ref = count(lm_run(f32_steps, batches, keep_grads=True))
    again = count(lm_run(f32_steps, batches, keep_grads=True))
    spread = max_diff(ref["params"], again["params"])
    tol = max(LM_KNOB_TOL["param_abs"], spread)
    grad_spread = grad_err(again["grads"], ref["grads"])
    grad_tol = max(LM_KNOB_TOL["grad_rel"], grad_spread)
    del again
    checks = {}
    for name, kw in (("remat", {"remat": True}),
                     ("layer_scan", {"layer_scan": True}),
                     ("layer_scan_remat", {"layer_scan": True,
                                           "remat": True}),
                     ("embed_grad_matmul", {"embed_grad_matmul": True})):
        run = count(lm_run(f32_steps, batches, kw, keep_grads=True))
        checks[name] = {
            "param_max_abs_err": max_diff(run["params"], ref["params"]),
            "first_step_grad_rel_err": grad_err(run["grads"], ref["grads"]),
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                                zip(run["losses"], ref["losses"])),
            "peak_gib": run["peak_gib"], "flash_launches": run["flash"]}
        del run
    emit("lm_knobs", what="3 f32 steps of each knob against the unrolled "
         "run, same seed and batches", card=nvidia_smi(), **c,
         compute="f32", optim="Adam(1e-4)", losses=ref["losses"],
         unrolled_run_to_run_spread=spread, param_tol=tol,
         param_tol_is=("the run-to-run spread" if spread > LM_KNOB_TOL[
             "param_abs"] else "1e-5 absolute"),
         unrolled_grad_spread=grad_spread, grad_tol=grad_tol,
         grad_tol_is=("the run-to-run spread" if grad_spread > LM_KNOB_TOL[
             "grad_rel"] else "1e-5 of the leaf's largest gradient"),
         grad_floor=LM_KNOB_TOL["grad_floor"],
         loss_rel_tol=LM_KNOB_TOL["loss_rel"], checks=checks,
         seconds=time.perf_counter() - t0)
    del ref
    for name, chk in checks.items():
        if not (chk["param_max_abs_err"] <= tol
                and chk["first_step_grad_rel_err"] <= grad_tol
                and chk["loss_rel_err"] <= LM_KNOB_TOL["loss_rel"]):
            raise AssertionError(f"lm_knobs f32 {name}: {chk} beyond "
                                 f"{tol} / {grad_tol} / "
                                 f"{LM_KNOB_TOL['loss_rel']}")
    # bf16 compute: one batch repeated, so the loss must fall
    one = lm_batches(1, seed=2)
    steps = warm + timed
    runs = {}
    for name, kw in (
            ("plain", {}), ("remat", {"kw": {"remat": True}}),
            ("layer_scan", {"kw": {"layer_scan": True}}),
            ("bf16_adam_slots", {"method": Adam(1e-4, state_dtype="bf16")}),
            ("bf16_params", {"param_dtype": torch.bfloat16,
                             "method": Adam(1e-4)}),
            ("bf16_params_sr", {"param_dtype": torch.bfloat16,
                                "method": Adam(1e-4,
                                               stochastic_rounding=True)})):
        run = count(lm_run(steps, one, compute="bf16", **kw))
        remat = name == "remat"
        want = {"fwd": c["layers"] * steps * (2 if remat else 1),
                "dq": c["layers"] * steps, "dkv": c["layers"] * steps}
        runs[name] = {"step_ms": [s * 1e3 for s in run["step_s"]],
                      "step_ms_p50": float(np.median(run["step_s"][warm:]))
                      * 1e3,
                      "peak_gib": run["peak_gib"], "losses": run["losses"],
                      "optimizer_state_bytes": run["state_bytes"],
                      "flash_launches": run["flash"],
                      "expected_flash_launches": want}
        if run["flash"] != want:
            raise AssertionError(f"lm_knobs {name}: flash launches "
                                 f"{run['flash']}, expected {want}")
        if not np.isfinite(run["losses"]).all():
            raise AssertionError(f"lm_knobs {name}: losses {run['losses']}")
        del run
    emit("lm_knobs", what="bf16 compute, one batch repeated", card=nvidia_smi(),
         steps=steps, timed_steps=timed, runs=runs,
         stochastic_rounding_ms=runs["bf16_params_sr"]["step_ms_p50"]
         - runs["bf16_params"]["step_ms_p50"])
    if not runs["remat"]["peak_gib"] < runs["plain"]["peak_gib"]:
        raise AssertionError("remat's peak memory is not below the plain "
                             "run's")
    if 2 * runs["bf16_adam_slots"]["optimizer_state_bytes"] != runs[
            "plain"]["optimizer_state_bytes"]:
        raise AssertionError("bf16 Adam slots are not half the f32 slots")
    sr = runs["bf16_params_sr"]["losses"]
    if not sr[-1] < sr[0]:
        raise AssertionError(f"bf16 parameters with stochastic rounding: the "
                             f"loss did not fall: {sr}")
    return launches


def lm_main_phase():
    """The LM's ``train_main`` at the 137M width, plain and ``--remat``;
    returns the flash launches of both runs."""
    from bigdl_tpu_torch.models.transformer import train_main

    argv = ["--vocab", "32768", "--hidden", "768", "--layers", "12",
            "--heads", "12", "--seqLen", "2048", "-b", "8", "--synthetic",
            "64", "--maxIteration", "6", "--computeDtype", "bf16"]
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    out = {}
    for name, extra in (("plain", []), ("remat", ["--remat"])):
        zero_flash_counts()
        model, wall, step_s, losses, peak = main_run(train_main,
                                                     argv + extra, 8)
        got = flash_counts()
        for k in launches:
            launches[k] += got[k]
        out[name] = {"wall_s": wall, "step_ms": [s * 1e3 for s in step_s],
                     "step_ms_p50": float(np.median(step_s[1:])) * 1e3,
                     "peak_gib": peak, "losses": losses,
                     "flash_launches": got}
        del model
        if not (len(losses) == 6 and np.isfinite(losses).all()):
            raise AssertionError(f"lm_main {name}: losses {losses}")
        if got["dq"] != 12 * 6:
            raise AssertionError(f"lm_main {name}: flash launches {got}")
    emit("lm_main", what="models.transformer.train_main through argv",
         card=nvidia_smi(), argv=argv, runs=out)
    return launches


def seq_parallel_phase(steps: int = 3):
    """The 137M LM with each ``sequence_parallel`` mode on a one-rank NCCL
    group: three bf16 steps bitwise the LM without it; returns the flash
    launches of the SP runs."""
    from bigdl_tpu_torch.parallel.axis import sum_gradients
    from bigdl_tpu_torch.utils.engine import Engine

    batches = lm_batches(steps, seed=3)
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    out = {}
    with nccl_world_of_one():
        Engine.mesh(("seq",))
        ref = lm_run(steps, batches, compute="bf16")
        for mode in ("ring", "striped_ring", "ulysses"):
            run = lm_run(steps, batches, {"sequence_parallel": mode},
                         compute="bf16", grad_transform=sum_gradients("seq"))
            for k in launches:
                launches[k] += run["flash"][k]
            same = (run["losses"] == ref["losses"] and all(
                bool((a == b).all()) for a, b in zip(run["params"],
                                                     ref["params"])))
            out[mode] = {"losses": run["losses"], "bitwise": same,
                         "step_ms_p50": float(np.median(run["step_s"][1:]))
                         * 1e3,
                         "flash_launches_per_step": {
                             k: v / steps for k, v in run["flash"].items()},
                         "param_max_abs_diff": max_diff(run["params"],
                                                        ref["params"])}
            del run
    emit("seq_parallel", what="sequence-parallel LM at world size 1 "
         "(NCCL) against the LM without it, 3 bf16 steps", card=nvidia_smi(),
         **LM137, plain_losses=ref["losses"],
         plain_step_ms_p50=float(np.median(ref["step_s"][1:])) * 1e3,
         modes=out)
    for mode, r in out.items():
        if not r["bitwise"]:
            raise AssertionError(f"seq_parallel {mode}: not bitwise the "
                                 f"plain LM ({r['param_max_abs_diff']})")
    return launches


def ring_replay_phase(n: int = 4):
    """The ring's n-rank schedule replayed on one card at the 137M
    attention shape; returns the schedule's flash launches (the
    whole-sequence references and the timings not counted) and the block
    variants' figures."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.parallel.ring_attention import (
        finish_merge, merge_block, ring_step_spec, stripe_sequence,
        unstripe_sequence,
    )

    B, T, H, D = LM137["B"], LM137["T"], LM137["heads"], 64
    t = T // n
    scale = 1.0 / np.sqrt(D)
    rtol = fa.ROW_RTOL[torch.bfloat16]
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(B, T, H, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    results = {}
    for sched, causal in (("contiguous", True), ("striped", True),
                          ("contiguous", False)):
        name = f"{sched}_{'causal' if causal else 'noncausal'}"
        lay = ((lambda x: stripe_sequence(x, n)) if sched == "striped"
               else (lambda x: x))
        unlay = ((lambda x: unstripe_sequence(x, n)) if sched == "striped"
                 else (lambda x: x))
        qs, ks, vs, dos = (lay(x) for x in (q, k, v, do))
        shard = [lambda x, r=r: x[:, r * t:(r + 1) * t] for r in range(n)]
        spec = ring_step_spec(sched, causal)
        # each block is held against the plain version on its inputs; the
        # plain checks run after the schedule so that its launches are
        # counted alone
        blocks = []
        zero_flash_counts()
        outs, lses = [], []
        for my in range(n):
            acc = None
            for step in range(n):
                src = (my - step) % n
                c_s, off, keep = spec(step, src, my)
                o_i, lse_i = fa.flash_attention_with_lse(
                    shard[my](qs), shard[src](ks), shard[src](vs), scale,
                    causal=c_s, causal_offset=off)
                blocks.append((my, src, c_s, off, keep, o_i, lse_i))
                if keep is not None and not keep:
                    lse_i = torch.full_like(lse_i, -float("inf"))
                acc = merge_block(acc, o_i, lse_i)
            o_my, lse_my = finish_merge(acc, torch.bfloat16)
            outs.append(o_my)
            lses.append(lse_my)
        dq = [None] * n
        dk = [torch.zeros(B, t, H, D, device="cuda") for _ in range(n)]
        dv = [torch.zeros(B, t, H, D, device="cuda") for _ in range(n)]
        bwd_blocks = []
        for my in range(n):
            for step in range(n):
                src = (my - step) % n
                c_s, off, keep = spec(step, src, my)
                dq_i, dk_i, dv_i = fa.flash_attention_block_grads(
                    shard[my](qs), shard[src](ks), shard[src](vs), outs[my],
                    lses[my], shard[my](dos), scale, causal=c_s,
                    causal_offset=off)
                if keep is not None and not keep:
                    continue
                bwd_blocks.append((my, src, c_s, off, dq_i, dk_i, dv_i))
                dq[my] = dq_i.float() if dq[my] is None else dq[my] + dq_i
                dk[src] += dk_i.float()
                dv[src] += dv_i.float()
        torch.cuda.synchronize()
        got = flash_counts()
        for kk in launches:
            launches[kk] += got[kk]
        # every block against the plain version on the same inputs, per
        # row; the plain block grads, each rounded to bf16 as the ring
        # rounds the kernels', summed in the ring's order (the second
        # reference); and the largest partial that went into each row of
        # each sum (the magnitude at which its terms were rounded)
        blk = {"fwd_row": 0.0, "lse_abs": 0.0, "bwd_row": 0.0}
        for my, src, c_s, off, keep, o_i, lse_i in blocks:
            o_p, lse_p = fa.flash_forward_reference(
                shard[my](qs), shard[src](ks), shard[src](vs), scale, c_s,
                off or 0)
            blk["fwd_row"] = max(blk["fwd_row"], fa.max_row_rel_err(o_i,
                                                                   o_p))
            blk["lse_abs"] = max(blk["lse_abs"],
                                 float((lse_i - lse_p).abs().max()))
        pl = {"dq": [torch.zeros(B, t, H, D, device="cuda")
                     for _ in range(n)]}
        pl["dk"] = [torch.zeros_like(x) for x in pl["dq"]]
        pl["dv"] = [torch.zeros_like(x) for x in pl["dq"]]
        part = {kk: [torch.zeros(B, t, H, device="cuda") for _ in range(n)]
                for kk in ("dq", "dk", "dv")}
        for my, src, c_s, off, dq_i, dk_i, dv_i in bwd_blocks:
            ref = fa.flash_backward_reference(
                shard[my](qs), shard[src](ks), shard[src](vs), outs[my],
                lses[my], shard[my](dos), scale, c_s, off or 0)
            for kk, dst, gi, ri in (("dq", my, dq_i, ref[0]),
                                    ("dk", src, dk_i, ref[1]),
                                    ("dv", src, dv_i, ref[2])):
                blk["bwd_row"] = max(blk["bwd_row"],
                                     fa.max_row_rel_err(gi, ri))
                pl[kk][dst] += ri.float()
                part[kk][dst] = torch.maximum(
                    part[kk][dst], gi.float().abs().amax(-1))
        o_ring = unlay(torch.cat(outs, 1))
        grads = [unlay(torch.cat(x, 1)).to(torch.bfloat16)
                 for x in (dq, dk, dv)]
        plain_sum = [unlay(torch.cat(pl[kk], 1)).to(torch.bfloat16)
                     for kk in ("dq", "dk", "dv")]
        parts = [unlay(torch.cat(part[kk], 1)) for kk in ("dq", "dk", "dv")]
        o_w, lse_w = fa.flash_attention_with_lse(q, k, v, scale,
                                                 causal=causal)
        lse_ring = torch.cat(lses, 2)
        if sched == "striped":
            lse_ring = unstripe_sequence(lse_ring.transpose(1, 2),
                                         n).transpose(1, 2)
        # the backward on the same inputs as the ring's: its merged O and
        # LSE (the whole-sequence kernel's own differ in their bf16 ulps,
        # and delta = dO.O carries that into every gradient row)
        want = fa.flash_attention_block_grads(q, k, v, o_ring, lse_ring, do,
                                              scale, causal=causal)
        err = {"fwd_row": fa.max_row_rel_err(o_ring, o_w),
               "lse_max_abs": float((lse_ring - lse_w).abs().max()),
               "bwd_row": max(fa.max_row_rel_err(a, b)
                              for a, b in zip(grads, want)),
               "bwd_row_blockwise_plain": max(
                   summed_row_rel_err(a, b, c)
                   for a, b, c in zip(grads, plain_sum, parts)),
               "blocks": blk}
        results[name] = {"err": err, "schedule_launches": got}
        if not (err["fwd_row"] <= rtol and err["bwd_row"] <= rtol
                and err["bwd_row_blockwise_plain"] <= rtol
                and err["lse_max_abs"] <= RING_REPLAY_TOL["lse_abs"]
                and blk["fwd_row"] <= rtol and blk["bwd_row"] <= rtol
                and blk["lse_abs"] <= RING_REPLAY_TOL["block_lse_abs"]):
            raise AssertionError(f"ring_replay {name}: {err} beyond "
                                 f"{rtol} / {RING_REPLAY_TOL}")
        del blocks, bwd_blocks, pl, part
    # the block variants at the ring's block shape, one launch each
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    qb, kb, vb, dob = (x[:, :t].contiguous() for x in (q, k, v, do))
    lib_c = fa._library()
    variants = {}
    for vname, causal, off in (("offset0", True, 0), ("offset-1", True, -1),
                               ("noncausal", False, 0)):
        o_r, lse_r = fa.flash_forward_reference(qb, kb, vb, scale, causal,
                                                off)
        delta = torch.empty((B, H, t), dtype=torch.float32, device="cuda")
        dqb, dkb, dvb = (torch.empty_like(x) for x in (qb, kb, vb))
        oc, lc = o_r.contiguous(), lse_r.contiguous()
        geo = (B, H, t, t, D, int(causal), off, float(scale), 1,
               torch.cuda.current_stream().cuda_stream)
        dq_in = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), oc.data_ptr(),
                 dob.data_ptr(), lc.data_ptr(), delta.data_ptr())
        dkv_in = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
                  lc.data_ptr(), delta.data_ptr())
        launched(lib_c.bigdl_flash_dq(*dq_in, dqb.data_ptr(), *geo))
        ms = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(qb, kb, vb, scale,
                                                        causal, off),
                             flush=flush),
              "dq": time_ms(lambda: launched(lib_c.bigdl_flash_dq(
                  *dq_in, dqb.data_ptr(), *geo)), flush=flush),
              "dkv": time_ms(lambda: launched(lib_c.bigdl_flash_dkv(
                  *dkv_in, dkb.data_ptr(), dvb.data_ptr(), *geo)),
                  flush=flush)}
        # the variant's outputs against the plain version, per row
        o_k, lse_k = fa.flash_fwd_cuda(qb, kb, vb, scale, causal, off)
        ref = fa.flash_backward_reference(qb, kb, vb, o_r, lse_r, dob, scale,
                                          causal, off)
        torch.cuda.synchronize()
        row_err = {"fwd": fa.max_row_rel_err(o_k, o_r),
                   "dq": fa.max_row_rel_err(dqb, ref[0]),
                   "dkv": max(fa.max_row_rel_err(dkb, ref[1]),
                              fa.max_row_rel_err(dvb, ref[2]))}
        lse_err = float((lse_k - lse_r).abs().max())
        if (max(row_err.values()) > rtol
                or lse_err > RING_REPLAY_TOL["block_lse_abs"]):
            raise AssertionError(f"ring_replay block {vname}: row errors "
                                 f"{row_err} (lse {lse_err}) beyond {rtol}")
        plain = {"fwd": time_ms(lambda: fa.flash_forward_reference(
            qb, kb, vb, scale, causal, off), reps=5, flush=flush)}
        plain["dq"] = plain["dkv"] = time_ms(
            lambda: fa.flash_backward_reference(qb, kb, vb, o_r, lse_r, dob,
                                                scale, causal, off),
            reps=5, flush=flush)
        # the library: one SDPA call with the equivalent boolean mask
        rows = torch.arange(t, device="cuda")[:, None]
        mask = (None if not causal
                else torch.arange(t, device="cuda")[None, :] <= rows + off)
        qs_, ks_, vs_ = (x.transpose(1, 2).contiguous().requires_grad_()
                         for x in (qb, kb, vb))
        dos_ = dob.transpose(1, 2).contiguous()
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, attn_mask=mask), flush=flush)
        lo = F.scaled_dot_product_attention(qs_, ks_, vs_, attn_mask=mask)
        lib_b = time_ms(lambda: torch.autograd.grad(
            lo, (qs_, ks_, vs_), dos_, retain_graph=True), flush=flush)
        work = flash_work(B, t, t, H, D, causal, off, 2)
        variants[vname] = {}
        for kname in ("fwd", "dq", "dkv"):
            b_ms, b_by = bound(*work[kname], BF16_FLOPS)
            variants[vname][kname] = {
                "ms": ms[kname], "plain_ms": plain[kname],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_f if kname == "fwd" else lib_b,
                "roofline_share": b_ms / ms[kname],
                "max_row_rel_err": row_err[kname], "rtol": rtol}
        variants[vname]["fwd"]["lse_max_abs_err"] = lse_err
    emit("ring_replay", what=f"{n}-rank ring schedules replayed on one card "
         "against whole-sequence flash", card=nvidia_smi(),
         shape=[B, T, H, D], per_rank=t, dtype="bf16", row_rtol=rtol,
         tol=RING_REPLAY_TOL,
         schedules=results, block_variants=variants,
         library="F.scaled_dot_product_attention with the boolean mask "
                 "(forward; backward: dq, dk and dv together)")
    return launches


def parallel_ext_phase():
    """MoE, the one-stage pipeline and the one-rank tensor-parallel MLP on
    a one-rank NCCL group, each against its plain computation."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.parallel import (
        gpipe, microbatch, mlp_expert, moe_layer, tp_mlp,
    )
    from bigdl_tpu_torch.utils.engine import Engine

    d, E, top_k, cf, T, hid = 768, 8, 2, 1.25, 16384, 3072
    g = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * s

    x = rand(T, d)
    router = rand(d, E, s=d ** -0.5)
    ep = {"w1": rand(E, d, hid, s=d ** -0.5), "b1": rand(E, hid, s=0.02),
          "w2": rand(E, hid, d, s=hid ** -0.5), "b2": rand(E, d, s=0.02)}
    cap = max(1, int(cf * top_k * T / E))
    out = {}
    with nccl_world_of_one():
        Engine.mesh(("expert",))
        y = moe_layer(x, router, ep, mlp_expert, "expert", top_k=top_k,
                      capacity_factor=cf)
        ms = time_ms(lambda: moe_layer(x, router, ep, mlp_expert, "expert",
                                       top_k=top_k, capacity_factor=cf),
                     reps=5)
        # the dense per-expert loop: top-k by torch.topk, each expert's
        # first ``cap`` tokens in token order, the kept gates renormalized
        probs = torch.softmax(x @ router, dim=-1)
        top = torch.topk(probs, top_k, dim=-1).indices
        chosen = torch.zeros_like(probs).scatter_(1, top, 1.0)
        keep = chosen * ((torch.cumsum(chosen, 0) - chosen) < cap)
        gates = probs * keep
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        want = torch.zeros_like(x)
        for e in range(E):
            idx = keep[:, e].nonzero().squeeze(1)
            h = F.gelu(x[idx] @ ep["w1"][e] + ep["b1"][e], approximate="tanh")
            want[idx] += gates[idx, e, None] * (h @ ep["w2"][e] + ep["b2"][e])
        err = float((y - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        out["moe"] = {"tokens": T, "d": d, "experts": E, "top_k": top_k,
                      "capacity": cap, "dropped_assignments": int(
                          chosen.sum() - keep.sum()),
                      "ms": ms, "max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"moe_layer vs the dense loop: {err} > {tol}")
        Engine.mesh(("pipe",))
        pw, pb, px = rand(1, d, d, s=d ** -0.5), rand(1, d, s=0.02), rand(64, d)

        def stage(p, xx):
            return torch.tanh(xx @ p["w"] + p["b"])

        piped = gpipe(stage, {"w": pw, "b": pb}, microbatch(px, 4), "pipe")
        plain = torch.stack([stage({"w": pw[0], "b": pb[0]}, mb)
                             for mb in microbatch(px, 4)])
        out["gpipe_one_stage"] = {"bitwise": bool(torch.equal(piped, plain))}
        Engine.mesh(("model",))
        w1, b1 = rand(hid, d, s=d ** -0.5), rand(hid, s=0.02)
        w2, b2 = rand(d, hid, s=hid ** -0.5), rand(d, s=0.02)
        tp = tp_mlp(px, w1, b1, w2, b2, "model")
        dense = F.gelu(px @ w1.t() + b1, approximate="tanh") @ w2.t() + b2
        out["tp_mlp_one_rank"] = {"bitwise": bool(torch.equal(tp, dense))}
    emit("parallel_ext", what="expert, pipeline and tensor parallelism on a "
         "one-rank NCCL group against their plain computations (f32)",
         card=nvidia_smi(), **out)
    if not (out["gpipe_one_stage"]["bitwise"]
            and out["tp_mlp_one_rank"]["bitwise"]):
        raise AssertionError(f"parallel_ext: {out}")


# -- int8 inference: the W8A16 kernel, ResNet-50 and the 137m LM ------------

#: (projection, K, N) of the 137m LM's weight-only int8 layers
W8A16_SHAPES = (("fc1", 768, 3072), ("fc2", 3072, 768), ("head", 768, 32768))
#: rows the main path gives the kernel: decode at batch 1, 4, 8 and the
#: 16-slot engine; a 16 x 128 prefill
W8A16_ROWS = (1, 4, 8, 16, 2048)
#: per output row, relative to the row's largest plain value: the kernel
#: and the plain version differ only in the order of the f32 sums (every
#: bf16 x bf16 product is exact in f32); with the serving projection's bf16
#: output and bf16 bias, each of the two roundings may then land one bf16
#: ulp apart, and a bf16 ulp is at most 2^-7 of its value: 2^-6 of the
#: row's largest value
W8A16_ROW_RTOL = {"f32": 5e-5, "bf16": 2.0 ** -6}
#: decode shapes (N, K) searched through ``launch_plan`` for a plan that
#: splits K over a cluster of 1, 2 and 8 blocks on this card
W8A16_SPLIT_SHAPES = ((3072, 768), (2048, 768), (768, 3072), (320, 2048),
                      (192, 4096))


def host_enqueue_us(fn, reps: int = 300) -> float:
    """Median host time of one call of ``fn`` in microseconds (the
    enqueue: nothing waits for the card)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def w8a16_phase():
    """The W8A16 kernel against its plain version at the 137m LM's
    shapes, called as the bf16 serving projection calls it (bf16 x, bf16
    output, bf16 bias), at ResNet-50's weight-only head at batch 256 and
    at ragged shapes, both with f32 x and output (the ``QuantizedLinear``
    call, with and without its f32 bias), at the regime boundary and at
    planned split counts 1, 2 and 8, every call repeated bitwise; the
    wrapper's host time per call at fc1 M 16; times beside the plain version,
    the two-call ``F.linear(x_bf16, weight_q.to(bf16), bias_bf16)``, the
    bf16 model's ``F.linear`` on a pre-cast weight (the library column:
    not the same function) and the bound. Returns the kernel's summary
    entry at the 16-slot engine's fc1 call."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import w8a16 as w8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, bf16, bf16, True) for name, k, n in W8A16_SHAPES
             for m in W8A16_ROWS]
    cases += [("resnet50_head", 256, 2048, 1000, f32, f32, True),
              ("ragged", 37, 203, 91, f32, f32, True),
              ("ragged", 5, 203, 91, f32, f32, False),
              ("ragged", 5, 203, 91, bf16, bf16, True),
              # the regime boundary: M 16 decodes, M 17 takes the next
              ("boundary", 16, 768, 3072, bf16, bf16, True),
              ("boundary", 17, 768, 3072, bf16, bf16, True),
              ("boundary", 17, 768, 3072, f32, f32, True)]
    for want in (1, 2, 8):       # a decode plan splitting K over `want`
        n, k = next((n, k) for n, k in W8A16_SPLIT_SHAPES
                    if w8.launch_plan(8, n, k, sms).splits == want)
        cases.append((f"splits{want}", 8, k, n, bf16, bf16, True))
    entry = None
    for name, m, k, n, dt, out_dt, with_bias in cases:
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda", generator=g)
        scale = torch.rand(n, 1, device="cuda", generator=g) * 2e-3 + 1e-4
        x = torch.randn(m, k, device="cuda", generator=g).to(dt)
        bias = (torch.randn(n, device="cuda", generator=g).to(out_dt)
                if with_bias else None)
        got = w8.w8a16(x, wq, scale, bias, out_dt)
        again = w8.w8a16(x, wq, scale, bias, out_dt)
        want = w8.w8a16_plain(x, wq, scale, bias, out_dt)
        torch.cuda.synchronize()
        err = fa.max_row_rel_err(got, want, floor=0.0)
        abs_err = float((got.float() - want.float()).abs().max())
        tol = W8A16_ROW_RTOL["bf16" if out_dt == bf16 else "f32"]
        plan = w8.launch_plan(m, n, k, sms, dt == bf16, k % 16 == 0,
                              out_dt == bf16)
        fields = dict(kernel="w8a16", case=f"{name}_m{m}", shape=[m, k, n],
                      x_dtype=str(dt), out_dtype=str(out_dt),
                      bias=with_bias, plan=plan._asdict(),
                      max_row_rel_err=err, max_abs_err=abs_err, tol=tol,
                      repeat_bitwise=bool(torch.equal(got, again)),
                      why="f32 sums in another order (bf16 products exact); "
                          "a bf16 output's two roundings one ulp apart")
        if not (bool(torch.isfinite(got).all()) and err <= tol
                and got.dtype == out_dt and fields["repeat_bitwise"]):
            emit("kernels", **fields)
            raise AssertionError(f"w8a16 {name} m{m}: row error {err} "
                                 f"(repeat bitwise: "
                                 f"{fields['repeat_bitwise']})")
        if name == "ragged" or name.startswith(("boundary", "splits")):
            emit("kernels", **fields)
            continue
        kern = time_stats(lambda: w8.w8a16(x, wq, scale, bias, out_dt),
                          flush=flush)
        plain_ms = time_ms(lambda: w8.w8a16_plain(x, wq, scale, bias,
                                                  out_dt), flush=flush)
        xb = x.to(bf16)
        bb = None if bias is None else bias.to(bf16)
        two = time_stats(lambda: F.linear(xb, wq.to(bf16), bb),
                         flush=flush)
        w_bf16 = wq.to(bf16)
        lib = time_stats(lambda: F.linear(xb, w_bf16, bb), flush=flush)
        n_bytes = (n * k + m * k * x.element_size() + n * 4
                   + (0 if bias is None else n * bias.element_size())
                   + m * n * got.element_size())
        bound_ms, bound_by = bound(2.0 * m * n * k, n_bytes, BF16_FLOPS)
        fields.update(ms=kern["mean"], ms_median=kern["median"],
                      ms_min_max=[kern["min"], kern["max"]],
                      host_ms_max=kern["host_ms_max"], plain_ms=plain_ms,
                      two_call_ms=two["mean"], two_call_ms_median=two["median"],
                      library_ms=lib["mean"], library_ms_median=lib["median"],
                      library_ms_min_max=[lib["min"], lib["max"]],
                      library="F.linear(x_bf16, w_bf16, b_bf16) on a "
                              "pre-cast bf16 weight: the bf16 model's "
                              "projection, not the same function",
                      bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
                      roofline_share=bound_ms / kern["mean"])
        emit("kernels", **fields)
        if (name, m) == ("fc1", 16):
            emit("kernels", kernel="w8a16", case="host_enqueue_fc1_m16",
                 wrapper_us=host_enqueue_us(
                     lambda: w8.w8a16(x, wq, scale, bias, out_dt)),
                 f_linear_us=host_enqueue_us(
                     lambda: F.linear(xb, w_bf16, bb)),
                 what="median host time per call: the wrapper (checks, "
                      "cached plan, one launch) beside the bf16 F.linear")
            entry = {"name": "w8a16", "route": "cuda",
                     "source": "bigdl_tpu_torch/csrc/w8a16.cu",
                     "replaces": "bigdl_tpu/models/transformer.py:674",
                     "launches": None, "max_abs_err": abs_err,
                     "ms": kern["mean"], "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib["mean"]}
        del w_bf16
    return entry


def param_bytes(model) -> int:
    return int(sum(p.numel() * p.element_size() for p in model.parameters()))


def infer_images_per_s(model, x, warm: int = 2, timed: int = 5):
    """(images/s, peak GiB, output) of ``model`` on batch ``x``."""
    import torch

    with torch.no_grad():
        for _ in range(warm):
            out = model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            out = model(x)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (x.shape[0] * timed / wall,
            torch.cuda.max_memory_allocated() / 2 ** 30, out)


def resnet8_accuracy_delta():
    """``benchmarks/int8_bench.py::accuracy_delta`` on the card: the
    CIFAR-shape ResNet-8 (shortcut A) trained 200 iterations (batch 64,
    SGD 0.1 / momentum 0.9 / weight decay 5e-4, ``Step(150, 0.2)``) on
    ``generate_batch_dataset(n_train=1280, n_test=512, seed=5,
    noise=180)``; Top-1 through ``Evaluator`` of the float model and of
    its dynamic and weight-only twins. Returns the fields."""
    import copy
    import tempfile

    from bigdl_tpu_torch.dataset import (
        BGRImgNormalizer, DataSet, SampleToMiniBatch,
    )
    from bigdl_tpu_torch.dataset.cifar import (
        TRAIN_MEAN, TRAIN_STD, generate_batch_dataset, load_samples,
    )
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (
        SGD, Evaluator, Optimizer, Step, Top1Accuracy, Trigger,
    )

    def stream(d, kind, train):
        ds = (DataSet.array(load_samples(d, kind, synthetic_fallback=False),
                            seed=13)
              .transform(BGRImgNormalizer(TRAIN_MEAN, TRAIN_STD))
              .transform(SampleToMiniBatch(64, drop_remainder=train)))
        if not train:
            return list(ds.data(train=False))
        it = ds.data(train=True)
        return [next(it) for _ in range(200)]

    with tempfile.TemporaryDirectory() as d:
        generate_batch_dataset(d, n_train=1280, n_test=512, seed=5,
                               noise=180.0)
        train, test = stream(d, "train", True), stream(d, "test", False)
    model = ResNet(10, {"depth": 8, "shortcutType": "A",
                        "dataSet": "cifar10"}, seed=17)
    opt = Optimizer(model=model, dataset=DataSet.array(train),
                    criterion=ClassNLLCriterion(),
                    end_trigger=Trigger.max_iteration(200))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             weight_decay=5e-4,
                             learning_rate_schedule=Step(150, 0.2)))
    t0 = time.perf_counter()
    trained = opt.optimize()
    train_s = time.perf_counter() - t0

    def top1(m):
        (res,) = Evaluator(m).test(test, [Top1Accuracy()], 64)
        acc, n = res.result()
        if n != 512:
            raise AssertionError(f"Evaluator scored {n} of 512")
        return float(acc)

    f32 = top1(trained)
    dyn = top1(copy.deepcopy(trained).quantize("dynamic"))
    wo = top1(copy.deepcopy(trained).quantize("weight_only"))
    return {"train_s": train_s, "top1_float": f32, "top1_int8_dynamic": dyn,
            "top1_int8_weight_only": wo, "delta_dynamic": dyn - f32,
            "delta_weight_only": wo - f32}


#: a weight-only convolution on the card against the same layer on the
#: CPU, on the same input, relative to the layer output's largest
#: magnitude: every product is exact in f32 (bf16 activations, int8
#: codes), so only the order of the f32 sums differs (the kernels' f32
#: ``ROW_RTOL``)
WO_CONV_CARD_RTOL = 2e-5
#: the most an int8 model's Top-1 may fall below its float model's
#: (``accuracy_delta``; the cost ``bigdl_tpu/nn/quantized.py`` states)
INT8_TOP1_DROP = 0.01


def quantized_card_vs_cpu(cpu, x, scheme: str):
    """The float model ``cpu`` (on the CPU) quantized under ``scheme`` on
    the CPU and on the card from the same weights: codes and scales
    bitwise. Then every quantized convolution's input (the CPU run's, kept
    by a hook) goes through the layer on both devices. Dynamic: the
    activation codes are compared, and the int32 accumulators are bitwise
    on the CPU's codes and, where the codes agree, on the card's. Weight-
    only: each layer within ``WO_CONV_CARD_RTOL``; this runs with cuDNN's
    TF32 at PyTorch's default (allowed), so the layer's own switch is what
    holds it off. Also the whole output's largest error relative to its
    largest magnitude (reported)."""
    import copy

    import torch

    from bigdl_tpu_torch.nn import QuantizedSpatialConvolution
    from bigdl_tpu_torch.nn.quantized import _quantize_rows

    cpu.evaluate()
    gpu = copy.deepcopy(cpu).to("cuda").quantize(scheme)
    cpu.quantize(scheme)
    for (k, a), (_, b) in zip(cpu.named_parameters(), gpu.named_parameters()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"{k}: quantized on the card != on the CPU")
    inputs = {}

    def keep_input(key):
        def hook(mod, inp, out):
            inputs[key] = inp[0]      # returns None: the output stands
        return hook

    hooks = [m.register_forward_hook(keep_input(name))
             for name, m in cpu.named_modules()
             if isinstance(m, QuantizedSpatialConvolution)]
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    out = {"scheme": scheme, "images": int(x.shape[0])}
    try:
        with torch.no_grad():
            want = cpu(x)
            got = gpu(x.to("cuda")).cpu()
            for h in hooks:
                h.remove()
            c_layers, g_layers = dict(cpu.named_modules()), \
                dict(gpu.named_modules())
            code_mismatch, acc_bitwise, layer_err = 0, True, 0.0
            for name, xin in inputs.items():
                c, g = c_layers[name], g_layers[name]
                if scheme == "weight_only":
                    a = c._weight_only(xin)
                    b = g._weight_only(xin.to("cuda")).cpu()
                    layer_err = max(layer_err, float(
                        (a - b).abs().max() / a.abs().max().clamp_min(1e-30)))
                    continue
                xq_c, _ = _quantize_rows(xin, (1, 2, 3))
                xq_g, _ = _quantize_rows(xin.to("cuda"), (1, 2, 3))
                agree = torch.equal(xq_c, xq_g.cpu())
                code_mismatch += int((xq_c != xq_g.cpu()).sum())
                acc_c = c._int8_conv(xq_c)
                acc_bitwise &= torch.equal(
                    acc_c, g._int8_conv(xq_c.to("cuda")).cpu())
                if agree:
                    acc_bitwise &= torch.equal(acc_c,
                                               g._int8_conv(xq_g).cpu())
    finally:
        cudnn.allow_tf32 = tf32
    out["layers"] = len(inputs)
    if scheme == "weight_only":
        out.update(layer_max_rel_err=layer_err, layer_rtol=WO_CONV_CARD_RTOL)
    else:
        out.update(activation_code_mismatches=code_mismatch,
                   int32_accumulators_bitwise=acc_bitwise)
    out["output_max_rel_err"] = float((got - want).abs().max()
                                      / want.abs().max())
    if not acc_bitwise:
        raise AssertionError("int32 accumulators differ between the card "
                             "and the CPU on the same codes")
    if not layer_err <= WO_CONV_CARD_RTOL:
        raise AssertionError(f"weight-only convolution, card vs CPU: "
                             f"{layer_err} > {WO_CONV_CARD_RTOL}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{scheme}: non-finite output on the card")
    return out


def int8_infer_phase(warm: int = 2, timed: int = 5, batch: int = 256):
    """``benchmarks/int8_bench.py`` on the card: ResNet-50 (depth 50,
    shortcut B, 1,000 classes) inference at batch 256, 3 x 224 x 224,
    fp32 (TF32 off), bf16, int8 dynamic and int8 weight-only: images/s,
    weight bytes, peak memory; both int8 schemes of this ResNet-50 card
    against CPU on two images; then the ResNet-8 accuracy delta (each int8
    Top-1 within ``INT8_TOP1_DROP`` of float) and both schemes of a
    ResNet-8 card against CPU. Returns the W8A16 launches of the timed
    runs (the weight-only head)."""
    import copy

    import torch

    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.ops import w8a16 as w8

    model = ResNet(1000, {"depth": 50, "shortcutType": "B"}, seed=7)
    model.evaluate()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (batch, 3, 224, 224)).astype(np.float32)).to("cuda")
    variants = {}
    launches = 0
    ref = None
    for name in ("fp32", "bf16", "int8_dynamic", "int8_weight_only"):
        if name == "fp32":
            m, xin = model, x
        elif name == "bf16":
            m, xin = copy.deepcopy(model).to(torch.bfloat16), x.bfloat16()
        else:
            m, xin = copy.deepcopy(model).quantize(name[5:]), x
        w8.launches = 0
        ips, peak, out = infer_images_per_s(m, xin, warm, timed)
        n = w8.launches
        launches += n
        out = out.float()
        if ref is None:
            ref = out
        agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        rel = float((out - ref).abs().max() / ref.abs().max())
        variants[name] = {"images_per_s": ips, "weight_bytes": param_bytes(m),
                          "peak_mem_gib": peak, "argmax_agreement_fp32": agree,
                          "max_rel_diff_fp32": rel, "w8a16_launches": n}
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"int8_infer {name}: non-finite output")
        if name == "int8_weight_only" and n != warm + timed:
            raise AssertionError(f"the weight-only head launched w8a16 {n} "
                                 f"times in {warm + timed} forwards")
        if m is not model:
            del m
        torch.cuda.empty_cache()
    emit("int8_infer", model="ResNet-50 B", batch=batch, warm=warm,
         timed=timed, variants=variants,
         vs_bf16={k: v["images_per_s"] / variants["bf16"]["images_per_s"]
                  for k, v in variants.items()})
    for scheme in ("dynamic", "weight_only"):
        emit("int8_infer", what="ResNet-50 B, card vs CPU",
             **quantized_card_vs_cpu(copy.deepcopy(model).to("cpu"),
                                     x[:2].cpu(), scheme))
    delta = resnet8_accuracy_delta()
    emit("int8_infer", what="accuracy_delta (ResNet-8, cifar10)",
         top1_drop_limit=INT8_TOP1_DROP, **delta)
    if min(delta["delta_dynamic"], delta["delta_weight_only"]) \
            < -INT8_TOP1_DROP:
        raise AssertionError(f"int8 Top-1 more than {INT8_TOP1_DROP} below "
                             f"float: {delta}")
    for scheme in ("dynamic", "weight_only"):
        small = ResNet(10, {"depth": 8, "shortcutType": "A",
                            "dataSet": "cifar10"}, device="cpu", seed=4)
        x8 = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (16, 3, 32, 32)).astype(np.float32))
        emit("int8_infer", what="ResNet-8, card vs CPU",
             **quantized_card_vs_cpu(small, x8, scheme))
    return launches


PROMPT_137M, GEN_137M = 128, 256


def decode_run(lm, dtype, batch: int):
    """``benchmarks/decode_bench.py``'s protocol with the port's steps:
    prefill 127 prompt tokens, then 256 greedy tokens one step at a time;
    returns (tok/s, step p50 ms, prefill ms, tokens)."""
    import torch

    from bigdl_tpu_torch.models.transformer import (
        make_decode_step, make_prefill_step, serving_params,
    )

    step, init = make_decode_step(lm, compute_dtype=dtype)
    prefill = make_prefill_step(lm, compute_dtype=dtype)
    P = serving_params(lm, dtype)
    g = torch.Generator(device="cuda").manual_seed(batch)
    prompt = torch.randint(0, lm[0].n_index, (batch, PROMPT_137M),
                           device="cuda", generator=g)
    with torch.no_grad():
        for _ in range(2):                              # warm-up
            _, c = prefill(P, prompt[:, :-1], init(batch))
            for _ in range(4):
                _, c = step(P, prompt[:, -1], c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, carry = prefill(P, prompt[:, :-1], init(batch))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok, toks = prompt[:, -1], []
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(GEN_137M + 1)]
        t0 = time.perf_counter()
        events[0].record()
        for i in range(GEN_137M):
            logp, carry = step(P, tok, carry)
            tok = logp.argmax(-1)
            events[i + 1].record()
            toks.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    out = torch.stack(toks, 1)
    if not bool(((out >= 0) & (out < lm[0].n_index)).all()) or \
            not bool(torch.isfinite(logp).all()):
        raise AssertionError("decode produced ids out of range or "
                             "non-finite log-probs")
    return batch * GEN_137M / wall, float(np.median(steps)), prefill_ms, out


def int8_decode_phase():
    """``benchmarks/decode_bench.py`` for ``137m`` on the card (fp32,
    bf16, int8 weight-only + bf16; batch 1 and 8), then a weight-only
    ``ServingEngine`` with int8 KV on the serve phase's traffic, then a
    small weight-only LM's int8-KV decode card vs CPU. Returns the
    launches of (w8a16, decode_attention, kv_requant)."""
    import copy

    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import w8a16 as w8

    V, layers = 32768, 12
    per_step_w8 = 2 * layers + 1
    lm = TransformerLM(V, hidden_size=768, n_heads=12, n_layers=layers,
                       max_len=PROMPT_137M + GEN_137M, output="logits",
                       seed=17).evaluate()
    qlm = copy.deepcopy(lm).quantize("weight_only")
    totals = {"w8a16": 0, "decode_attention": 0, "kv_requant": 0}
    models = {"fp32": (lm, None), "bf16": (lm, torch.bfloat16),
              "int8": (qlm, torch.bfloat16)}
    runs, greedy = {}, {}
    # bf16 and int8 in turns: a host-bound step's time spreads between
    # runs
    for batch in (1, 8):
        for variant in ("bf16", "int8", "int8", "bf16", "fp32"):
            model, dtype = models[variant]
            w8.launches = da.launches = 0
            tok_s, p50, prefill_ms, out = decode_run(model, dtype, batch)
            n_w8, n_da = w8.launches, da.launches
            totals["w8a16"] += n_w8
            totals["decode_attention"] += n_da
            run = runs.setdefault(f"{variant}_b{batch}", {
                "tok_s": [], "step_p50_ms": [], "prefill_ms": [],
                "w8a16_launches": n_w8, "decode_attention_launches": n_da})
            run["tok_s"].append(tok_s)
            run["step_p50_ms"].append(p50)
            run["prefill_ms"].append(prefill_ms)
            greedy[(variant, batch)] = out
            warm_steps = 2 * 4
            steps = GEN_137M + warm_steps
            want_w8 = per_step_w8 * (steps + 3) if variant == "int8" else 0
            if n_w8 != want_w8 or n_da != layers * steps:
                raise AssertionError(
                    f"decode {variant} b{batch}: w8a16 {n_w8} (want "
                    f"{want_w8}), decode_attention {n_da} (want "
                    f"{layers * steps})")
    agree = {f"b{b}": float((greedy[("int8", b)] == greedy[("bf16", b)])
                            .float().mean()) for b in (1, 8)}
    emit("int8_decode", model="137m", prompt=PROMPT_137M, gen=GEN_137M,
         order="per batch: bf16, int8, int8, bf16, fp32",
         weight_bytes={"fp32": param_bytes(lm), "int8": param_bytes(qlm)},
         runs=runs, int8_vs_bf16_greedy_agreement=agree,
         w8a16_launches_per_step=per_step_w8)
    del lm, qlm
    torch.cuda.empty_cache()
    for name, n in engine_weight_only_run().items():
        totals[name] += n
    weight_only_check()
    return totals


def engine_weight_only_run():
    """``ServingEngine(kv_dtype="int8")`` over the weight-only 137m (bf16,
    16 slots) on the serve phase's 24 requests, in turns with the same
    engine over the float model (float, int8, int8, float): tok/s, decode
    step p50, TTFT p50; the weight-only runs' launches per decode step.
    Returns the runs' launches."""
    import copy

    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.ops import w8a16 as w8
    from bigdl_tpu_torch.serving import ServingEngine

    V, layers = 32768, 12
    lm, build_s = lm_137m()
    models = {"bf16": lm, "int8": copy.deepcopy(lm).quantize("weight_only")}

    def engine(model):
        return ServingEngine(model, n_slots=16, compute_dtype=torch.bfloat16,
                             kv_dtype="int8")

    for model in models.values():       # warm-up, outside the counts
        warm = engine(model)
        for p in ([5, 9, 2] * 7, [4] * 40):
            warm.submit(p, max_new_tokens=3)
        with torch.no_grad():
            warm.drain()
    del warm
    counts = {"w8a16": 0, "decode_attention": 0, "kv_requant": 0}
    runs = {}
    for name in ("bf16", "int8", "int8", "bf16"):
        rng = np.random.default_rng(0)
        eng = engine(models[name])
        rids = [eng.submit(prompt, max_new_tokens=32, sampling=sp)
                for prompt, sp in serve_traffic(rng, V)]
        torch.cuda.synchronize()
        w8.launches = da.launches = kr.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"w8a16": w8.launches, "decode_attention": da.launches,
               "kv_requant": kr.launches}
        steps = eng.metrics.decode_step_count
        prefills = int(eng.metrics.metrics.get("serving/prefill_batch")[1])
        for rid in rids:
            out, lps = outs[rid], eng.logprobs(rid)
            if not (len(out) == 32 and out.min() >= 1 and out.max() <= V
                    and np.isfinite(lps).all() and (lps <= 0).all()):
                raise AssertionError(f"{name} engine request {rid}: {out}")
        want = {"w8a16": ((2 * layers + 1) * (steps + prefills)
                          if name == "int8" else 0),
                "decode_attention": layers * steps,
                "kv_requant": layers * steps}
        if got != want:
            raise AssertionError(f"{name} engine launches {got}, expected "
                                 f"{want}")
        s = eng.summary()
        run = runs.setdefault(name, {"tokens_per_s": [],
                                     "decode_step_p50_s": [],
                                     "ttft_p50_s": [], "wall_s": []})
        run["tokens_per_s"].append(s["serving/tokens_per_sec"])
        run["decode_step_p50_s"].append(s["serving/decode_step_p50_s"])
        run["ttft_p50_s"].append(s["serving/ttft_p50_s"])
        run["wall_s"].append(wall)
        for k in counts:
            counts[k] += got[k]
        if name == "int8":
            run.update(decode_steps=steps, prefill_calls=prefills,
                       per_decode_step={
                           "w8a16": (got["w8a16"] - (2 * layers + 1)
                                     * prefills) / steps,
                           "decode_attention": got["decode_attention"]
                           / steps,
                           "kv_requant": got["kv_requant"] / steps})
        del eng
    emit("int8_decode", what="ServingEngine 137m, bf16, int8 KV, 16 slots: "
         "weight-only int8 against float weights, in turns",
         order="bf16, int8, int8, bf16", build_s=build_s,
         weight_bytes={k: param_bytes(m) for k, m in models.items()},
         requests=24, new_tokens=32 * 24, runs=runs, launches=counts,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del models, lm
    torch.cuda.empty_cache()
    return counts


def weight_only_check():
    """A small weight-only LM's int8-KV decode step, teacher-forced, on
    the card against the same step on the CPU (the check phase's recipe
    over int8 weights, f32): log-probs within 2e-3 (an int8 KV value or a
    bf16-rounded activation on a rounding boundary may land one step
    apart)."""
    import copy

    import torch

    from bigdl_tpu_torch.models import transformer as tm

    lm_cpu = tm.TransformerLM(97, hidden_size=128, n_heads=4, n_layers=2,
                              max_len=64, device="cpu", seed=3)
    lm_cpu.quantize("weight_only")
    lm_gpu = copy.deepcopy(lm_cpu).to("cuda")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 97, size=(4, 16))
    lengths = np.asarray([16, 5, 0, 11])
    feeds = rng.integers(0, 97, size=(6, 4))
    active = torch.tensor([True, True, False, True])
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, "cuda")):
        prefill = tm.make_batch_prefill_step(lm, kv_quant=True)
        step, init = tm.make_batch_decode_step(lm, kv_quant=True)
        P = tm.serving_params(lm)
        with torch.no_grad():
            _, carry = prefill(P, torch.from_numpy(toks).to(dev), lengths,
                               init(4))
            logps = []
            for f in feeds:
                lp, carry = step(P, torch.from_numpy(f).to(dev),
                                 active.to(dev), carry)
                logps.append(lp.cpu().numpy())
        outs.append(np.stack(logps))
    err = float(np.abs(outs[0] - outs[1])[:, active.numpy()].max())
    emit("int8_decode", what="weight-only int8-KV decode step, card vs CPU, "
         "small model", steps=len(feeds), max_abs_logp_err=err, tol=2e-3)
    if not err <= 2e-3:
        raise AssertionError(f"weight-only card vs CPU decode: err {err}")


def tail_layer_cases():
    """A.7 group 1's layers for ``nn_tail``: (name, kind, build(generator)
    → module on the CPU, inputs(rng) → array, list of arrays, or an int
    array of ids)."""
    import bigdl_tpu_torch.nn as T

    E, R, P = "elementwise", "reduction", "product"
    rows, maps = (64, 1024), (32, 64, 56, 56)

    def normal(*shape, scale=1.0):
        return lambda rng: (scale * rng.standard_normal(shape)).astype(
            np.float32)

    def positive(*shape):
        return lambda rng: rng.uniform(0.1, 3.0, shape).astype(np.float32)

    def table(*makers):
        return lambda rng: [m(rng) for m in makers]

    def lin(i, o):
        return lambda g: T.Linear(i, o, device="cpu", generator=g)

    return [
        ("ReLU6", E, lambda g: T.ReLU6(), normal(*maps, scale=4.0)),
        ("Sigmoid", E, lambda g: T.Sigmoid(), normal(*rows)),
        ("SoftMax", R, lambda g: T.SoftMax(), normal(*maps)),
        ("PReLU", E, lambda g: T.PReLU(64, device="cpu"), normal(*maps)),
        ("ELU", E, lambda g: T.ELU(0.7), normal(*maps)),
        ("LeakyReLU", E, lambda g: T.LeakyReLU(0.1), normal(*maps)),
        ("HardTanh", E, lambda g: T.HardTanh(-0.5, 0.8), normal(*maps)),
        ("SoftPlus", E, lambda g: T.SoftPlus(2.0), normal(*maps)),
        ("SoftSign", E, lambda g: T.SoftSign(), normal(*maps)),
        ("GELU", E, lambda g: T.GELU(), normal(*maps)),
        ("MulConstant", E, lambda g: T.MulConstant(2.5), normal(*rows)),
        ("AddConstant", E, lambda g: T.AddConstant(-1.5), normal(*rows)),
        ("Power", E, lambda g: T.Power(3.0, 0.5, 1.0), normal(*rows)),
        ("Square", E, lambda g: T.Square(), normal(*rows)),
        ("Sqrt", E, lambda g: T.Sqrt(), positive(*rows)),
        ("Abs", E, lambda g: T.Abs(), normal(*rows)),
        ("Log", E, lambda g: T.Log(), positive(*rows)),
        ("Exp", E, lambda g: T.Exp(), normal(*rows)),
        ("Clamp", E, lambda g: T.Clamp(-0.5, 0.5), normal(*maps)),
        ("Mean", R, lambda g: T.Mean(2), normal(*maps)),
        ("Sum", R, lambda g: T.Sum(2, n_input_dims=3), normal(*maps)),
        ("Max", R, lambda g: T.Max(3, squeeze=False), normal(*maps)),
        ("Min", R, lambda g: T.Min(4), normal(*maps)),
        ("MM", P, lambda g: T.MM(trans_b=True),
         table(normal(64, 256, 512), normal(64, 128, 512))),
        ("MV", P, lambda g: T.MV(), table(normal(64, 256, 1024),
                                          normal(64, 1024))),
        ("Mul", E, lambda g: T.Mul(device="cpu", generator=g),
         normal(*rows)),
        ("Add", E, lambda g: T.Add(1024, device="cpu"), normal(*rows)),
        ("CMul", E, lambda g: T.CMul((1, 1024), device="cpu", generator=g),
         normal(*rows)),
        ("CAdd", E, lambda g: T.CAdd((1, 1024), device="cpu"),
         normal(*rows)),
        ("LookupTable", R, lambda g: T.LookupTable(
            10000, 1024, padding_value=3, max_norm=1.0, device="cpu",
            generator=g),
         lambda rng: rng.integers(0, 10001, (64, 32))),
        ("View", E, lambda g: T.View(32, 32), normal(*rows)),
        ("Narrow", E, lambda g: T.Narrow(2, 5, 1000), normal(*rows)),
        ("Squeeze", E, lambda g: T.Squeeze(3), normal(64, 1024, 1)),
        ("Unsqueeze", E, lambda g: T.Unsqueeze(2), normal(*rows)),
        ("Transpose", E, lambda g: T.Transpose([(2, 3), (3, 4)]),
         normal(*maps)),
        ("Contiguous", E, lambda g: T.Contiguous(), normal(*maps)),
        ("Padding", E, lambda g: T.Padding(2, -3, 3, 0.5), normal(*maps)),
        ("CMulTable", E, lambda g: T.CMulTable(),
         table(normal(*rows), normal(*rows), normal(*rows))),
        ("CSubTable", E, lambda g: T.CSubTable(),
         table(normal(*rows), normal(*rows))),
        ("CDivTable", E, lambda g: T.CDivTable(),
         table(normal(*rows), positive(*rows))),
        ("CMaxTable", E, lambda g: T.CMaxTable(),
         table(normal(*rows), normal(*rows), normal(*rows))),
        ("CMinTable", E, lambda g: T.CMinTable(),
         table(normal(*rows), normal(*rows), normal(*rows))),
        ("CAveTable", E, lambda g: T.CAveTable(),
         table(normal(*rows), normal(*rows), normal(*rows))),
        ("JoinTable", E, lambda g: T.JoinTable(2),
         table(normal(*rows), normal(*rows))),
        ("SplitTable", E, lambda g: T.SplitTable(2), normal(64, 16, 1024)),
        ("ParallelTable", P,
         lambda g: T.ParallelTable().add(lin(1024, 1024)(g)).add(T.Tanh()),
         table(normal(*rows), normal(*rows))),
        ("MapTable", P, lambda g: T.MapTable(lin(1024, 512)(g)),
         table(normal(*rows), normal(*rows), normal(*rows))),
        ("Bottle", P, lambda g: T.Bottle(lin(1024, 256)(g)),
         normal(8, 64, 1024)),
        ("SpatialFullConvolution", P, lambda g: T.SpatialFullConvolution(
            64, 32, 3, 3, 2, 2, 1, 1, adj_w=1, adj_h=1, device="cpu",
            generator=g), normal(32, 64, 28, 28)),
        ("Normalize", R, lambda g: T.Normalize(), normal(*maps)),
        ("Echo", E, lambda g: T.Echo(), normal(*rows)),
    ]


def tail_criterion_cases():
    """(name, criterion, inputs(rng) → (input, target)) at (64, 1024)."""
    from bigdl_tpu_torch import nn as T

    def f32(a):
        return a.astype(np.float32)

    def make(kind):
        def inputs(rng):
            x = f32(rng.standard_normal((64, 1024)))
            y = f32(rng.standard_normal((64, 1024)))
            p = f32(rng.uniform(0.02, 0.98, (64, 1024)))
            t01 = f32(rng.uniform(0, 1, (64, 1024)) > 0.5)
            pos = f32(rng.uniform(0.1, 3.0, (64, 1024)))
            pm1 = f32(np.where(y > 0, 1.0, -1.0))
            dist = p / p.sum(-1, keepdims=True)
            return {"xy": (x, y), "bce": (p, t01), "pm1": (x, pm1),
                    "pos": (pos, f32(rng.uniform(0.1, 3.0, (64, 1024)))),
                    "kl": (f32(np.log(dist)), f32(dist[::-1].copy())),
                    "prob": (dist, f32(dist[::-1].copy())),
                    "onehot": (p, f32(np.eye(1024)[rng.integers(
                        0, 1024, 64)])),
                    "pair": ([x, y], np.float32([1.0]))}[kind]
        return inputs

    w = f32(np.random.default_rng(3).uniform(0.5, 2.0, 1024))
    return [
        ("MSECriterion", T.MSECriterion(), make("xy")),
        ("AbsCriterion", T.AbsCriterion(), make("xy")),
        ("BCECriterion", T.BCECriterion(w), make("bce")),
        ("SmoothL1Criterion", T.SmoothL1Criterion(), make("xy")),
        ("MultiLabelSoftMarginCriterion",
         T.MultiLabelSoftMarginCriterion(w), make("bce")),
        ("MarginCriterion", T.MarginCriterion(), make("pm1")),
        ("DistKLDivCriterion", T.DistKLDivCriterion(), make("kl")),
        ("L1HingeEmbeddingCriterion", T.L1HingeEmbeddingCriterion(),
         make("pair")),
        ("PoissonCriterion", T.PoissonCriterion(), make("pos")),
        ("MeanAbsolutePercentageCriterion",
         T.MeanAbsolutePercentageCriterion(), make("xy")),
        ("MeanSquaredLogarithmicCriterion",
         T.MeanSquaredLogarithmicCriterion(), make("pos")),
        ("KullbackLeiblerDivergenceCriterion",
         T.KullbackLeiblerDivergenceCriterion(), make("prob")),
        ("CategoricalCrossEntropy", T.CategoricalCrossEntropy(),
         make("onehot")),
    ]


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (float64, on the CPU)."""
    import torch

    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _first_rows(x, n):
    """The first ``n`` rows of an input (each array of a table)."""
    if n is None:
        return x
    if isinstance(x, list):
        return [_first_rows(v, n) for v in x]
    return x[:n]


def _on(x, device):
    """An input on ``device``: float arrays as tensors requiring a
    gradient, other arrays as tensors, ``SparseTensor``s moved."""
    import torch

    if isinstance(x, list):
        return [_on(v, device) for v in x]
    if not isinstance(x, np.ndarray):
        return x.to(device)
    t = torch.from_numpy(x).to(device)
    return t.requires_grad_() if t.is_floating_point() else t


def _leaves(x):
    """Tensors of an input or output (a ``SparseTensor`` by its values),
    flattened."""
    from bigdl_tpu_torch.tensor.sparse import SparseTensor

    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x.values if isinstance(x, SparseTensor) else x]


def tail_layer_run(layer, xs, cts, device):
    """Forward ``layer`` (a copy on ``device``) on ``xs`` (an array, a
    ``SparseTensor`` or a list of them) and take the vector-Jacobian
    product of ``cts`` (drawn for its outputs when ``None``; a
    ``SparseTensor`` output by its values): (outputs, input gradients,
    parameter gradients, cotangents, what it printed, the indices of its
    ``SparseTensor`` outputs), on the CPU."""
    import copy
    import io

    import torch

    from bigdl_tpu_torch.tensor.sparse import SparseTensor

    m = copy.deepcopy(layer).to(device)
    ins = _on(xs, device)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):    # Echo's line
        out = m(ins)
    outs = _leaves(out)
    indices = [o.indices.cpu() for o in
               (out if isinstance(out, list) else [out])
               if isinstance(o, SparseTensor)]
    if cts is None:
        rng = np.random.default_rng(99)
        cts = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
               for o in outs]
    params = dict(m.named_parameters())
    wrt = list(params.values()) + [t for t in _leaves(ins)
                                   if t.requires_grad]
    grads = torch.autograd.grad(
        outs, wrt, [torch.from_numpy(c).to(device, o.dtype)
                    for c, o in zip(cts, outs)],
        allow_unused=True) if wrt else []
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(wrt, grads)]
    return ([t.detach().cpu() for t in outs],
            [g.cpu() for g in grads[len(params):]],
            {k: g.cpu() for k, g in zip(params, grads)}, cts, log.getvalue(),
            indices)


def tail_optimizer_run(method, grads, device):
    """Five steps of ``method`` on a (1024, 1024) weight on ``device``:
    (final weight, final slots), on the CPU."""
    import torch

    w = {"w": torch.from_numpy(
        np.random.default_rng(5).standard_normal((1024, 1024)).astype(
            np.float32)).to(device)}
    state = method.init_state(w)
    for g in grads:
        w, state = method.update({"w": torch.from_numpy(g).to(device)},
                                 state, w)
    slots = {k: v["w"].cpu() for k, v in state.items() if isinstance(v, dict)}
    return w["w"].cpu(), slots


def nn_tail_phase():
    """A.7 group 1 on the card against the port's own CPU run (see the
    phase list); raises on any error beyond ``NN_TAIL_TOL``."""
    import torch

    from bigdl_tpu_torch import optim as O

    errors, kinds = {}, {}
    for i, (name, kind, build, inputs) in enumerate(tail_layer_cases()):
        layer = build(torch.Generator().manual_seed(i))
        xs = inputs(np.random.default_rng(i))
        c_out, c_gx, c_gp, cts, c_log, _ = tail_layer_run(layer, xs, None,
                                                          "cpu")
        d_out, d_gx, d_gp, _, d_log, _ = tail_layer_run(layer, xs, cts,
                                                        "cuda")
        if name == "Echo" and not (c_log == d_log and "shape=(64, 1024)"
                                   in d_log):
            raise AssertionError(f"Echo printed {d_log!r}, not {c_log!r}")
        pairs = (list(zip(d_out, c_out)) + list(zip(d_gx, c_gx))
                 + [(d_gp[k], v) for k, v in c_gp.items()])
        errors[name] = max(rel_err(a, b) for a, b in pairs)
        kinds[name] = kind
    for i, (name, crit, inputs) in enumerate(tail_criterion_cases()):
        x, t = inputs(np.random.default_rng(100 + i))
        got = []
        for device in ("cpu", "cuda"):
            xd = ([torch.from_numpy(v).to(device) for v in x]
                  if isinstance(x, list) else torch.from_numpy(x).to(device))
            td = torch.from_numpy(t).to(device)
            loss = crit.forward(xd, td)
            g = crit.backward(xd, td)
            got.append((loss, g if isinstance(g, list) else [g]))
        (lc, gc), (ld, gd) = got
        errors[name] = max([abs(ld - lc) / max(abs(lc), 1e-30)]
                           + [rel_err(a, b) for a, b in zip(gd, gc)])
        kinds[name] = "criterion"
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal((1024, 1024)).astype(np.float32)
             for _ in range(5)]
    for name, make in (("Adadelta", lambda: O.Adadelta()),
                       ("Adamax", lambda: O.Adamax()),
                       ("RMSprop", lambda: O.RMSprop(1e-3)),
                       ("Ftrl", lambda: O.Ftrl(0.05, l1_regularization_strength
                                                =1e-3)),
                       ("LarsSGD", lambda: O.LarsSGD(0.1, weight_decay=1e-4))):
        wc, sc = tail_optimizer_run(make(), grads, "cpu")
        wd, sd = tail_optimizer_run(make(), grads, "cuda")
        errors[name] = max([rel_err(wd, wc)]
                           + [rel_err(sd[k], v) for k, v in sc.items()])
        kinds[name] = "optimizer"
    misses = {n: {"err": e, "tol": NN_TAIL_TOL[kinds[n]]}
              for n, e in errors.items() if not e <= NN_TAIL_TOL[kinds[n]]}
    filler = torch.empty((64, 32, 4, 4), device="cuda")
    from bigdl_tpu_torch.nn import BilinearFiller

    bilinear_equal = torch.equal(
        BilinearFiller().fill(filler).cpu(),
        BilinearFiller().fill(torch.empty((64, 32, 4, 4))))
    emit("nn_tail", card=nvidia_smi(), names=len(errors),
         max_err={n: {"kind": kinds[n], "err": e} for n, e in errors.items()},
         tol=NN_TAIL_TOL, bilinear_filler_bitwise=bilinear_equal,
         misses=misses)
    if misses or not bilinear_equal:
        raise AssertionError(f"nn_tail card vs CPU beyond tolerance: "
                             f"{misses}, bilinear bitwise {bilinear_equal}")


def ae_first_step(model, x, device):
    """One ``Adagrad(0.01)`` train step of a copy of ``model`` on
    ``device``: (loss, accumulator, params), on the CPU."""
    import copy

    import torch

    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.optim.train_step import make_train_step

    m = copy.deepcopy(model).to(device)
    opt = Adagrad(learning_rate=0.01)
    params = {k: p.detach().clone() for k, p in m.named_parameters()}
    xd = torch.from_numpy(x).to(device)
    params, state, _, loss = make_train_step(m, MSECriterion(), opt)(
        params, opt.init_state(params), {}, None, xd, xd)
    return (float(loss), {k: v.cpu() for k, v in state["accum"].items()},
            {k: v.cpu() for k, v in params.items()})


def autoencoder_phase():
    """The Autoencoder at its published width (see the phase list)."""
    import torch

    from bigdl_tpu_torch.dataset.mnist import load_samples
    from bigdl_tpu_torch.models.autoencoder import Autoencoder, train_main

    _, wall, step_s, losses, peak = main_run(
        train_main, ["--synthetic", "60000"], 128)
    p50 = float(np.median(step_s[1:]))
    x = np.stack([s.features[0].reshape(-1) for s in load_samples(
        "/nonexistent", "train", synthetic_count=128)])
    model = Autoencoder(32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    lc, ac, pc = ae_first_step(model, x, "cpu")
    ld, ad, pd = ae_first_step(model, x, "cuda")
    accum_err = max(rel_err(ad[k], v) for k, v in ac.items())
    param_err = 0.0
    for k, v in pc.items():
        clear = ac[k].sqrt() > 1e-2 * ac[k].sqrt().max()
        param_err = max(param_err, rel_err(pd[k][clear], v[clear]))
    check = {"loss_rel_err": abs(ld - lc) / abs(lc), "accum_rel_err":
             accum_err, "param_rel_err": param_err, "cpu_loss": lc,
             "card_loss": ld}
    emit("autoencoder", card=nvidia_smi(),
         what="models.autoencoder.train_main (784-32-784, batch 128, "
         "Adagrad 0.01, 2 epochs, 60,000 synthetic digits)", wall_s=wall,
         steps=len(step_s), step_ms_p50=p50 * 1e3,
         records_per_s=128 / p50, first_loss=losses[0], last_loss=losses[-1],
         peak_mem_gib=peak, card_vs_cpu=check, tol=AE_CARD_TOL)
    if not (len(losses) == 938 and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"autoencoder losses {losses[:3]} ... "
                             f"{losses[-3:]} ({len(losses)})")
    if max(check["loss_rel_err"], accum_err, param_err) > AE_CARD_TOL:
        raise AssertionError(f"autoencoder card vs CPU {check}")


def finetune_build(frozen: bool):
    """ResNet-50 with L2 weight decay on every conv and linear, frozen
    but for its head when asked: (model, criterion, head name)."""
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Linear
    from bigdl_tpu_torch.optim import L2Regularizer

    model = ResNet(1000, {"depth": 50, "shortcutType": "B"}, seed=0)
    for m in model.modules():
        if hasattr(m, "w_regularizer"):
            m.w_regularizer = L2Regularizer(1e-4)
    head = [m for m in model.modules() if isinstance(m, Linear)][-1].name
    if frozen:
        model.freeze()
        model.unfreeze(head)
    return model, CrossEntropyCriterion(), head


def finetune_phase(batch: int = 64, steps: int = 5):
    """ResNet-50 fine-tuned with a frozen backbone (see the phase list)."""
    import torch

    from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples
    from bigdl_tpu_torch.optim import RMSprop

    samples = synthetic_imagenet_samples(batch, seed=0)
    out = {}
    for label, frozen, mode in (("local_frozen", True, "local"),
                                ("local_unfrozen", False, "local"),
                                ("allreduce_frozen", True, "allreduce")):
        made = {}

        def build():
            model, crit, made["head"] = finetune_build(frozen)
            made["before"] = {k: p.detach().clone()
                              for k, p in model.named_parameters()}
            return model, crit

        ctx = (contextlib.nullcontext() if mode == "local"
               else nccl_world_of_one())
        with ctx:
            model, _, fig = distri_run(build, samples, batch, steps,
                                       RMSprop(learning_rate=1e-3), mode)
        before, head = made["before"], made["head"]
        kept, moved, n_frozen = True, False, 0
        for k, p in model.named_parameters():
            if k.rsplit(".", 1)[0].rsplit(":", 1)[-1] == head:
                moved = moved or not torch.equal(p, before[k])
            elif frozen:
                n_frozen += 1
                kept = kept and torch.equal(p, before[k])
        fig.update({"frozen_params": n_frozen, "frozen_kept_bitwise": kept,
                    "head_moved": moved})
        out[label] = fig
        del model, made, before
        torch.cuda.empty_cache()
        if not (kept and moved):
            raise AssertionError(f"finetune {label}: frozen kept {kept}, "
                                 f"head moved {moved}")
    emit("finetune", card=nvidia_smi(),
         what=f"ResNet-50 (1000 classes, f32, batch {batch}, 224², "
         "synthetic ImageNet), freeze() + unfreeze(head), RMSprop 1e-3 with "
         f"L2 1e-4 on every conv and linear, {steps} steps",
         step_ms_p50_frozen=out["local_frozen"]["step_ms_p50"],
         step_ms_p50_unfrozen=out["local_unfrozen"]["step_ms_p50"],
         step_ms_p50_allreduce_frozen=out["allreduce_frozen"]["step_ms_p50"],
         runs=out)


def host_ms(fn, reps: int = 5) -> list:
    """Host milliseconds of ``fn()`` to a synchronised card, ``reps``
    times after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def fwd_bwd(module, x):
    """A closure running ``module`` forward and backward on ``x`` (a
    tensor, a ``SparseTensor`` or a list of them) with a ones cotangent,
    grad enabled, differentiating its parameters and the inputs that
    require a gradient (what ``host_ms`` times and ``window_counts``
    profiles)."""
    import torch

    wrt = list(module.parameters()) + [t for t in _leaves(x)
                                       if t.requires_grad]

    def run():
        with torch.enable_grad():
            outs = _leaves(module(x))
            loss = outs[0].sum() if len(outs) == 1 else sum(
                o.sum() for o in outs)
            torch.autograd.grad(loss, wrt)

    return run


def rnn_cell_cases(H: int = 650, T: int = 35, B: int = 20,
                   vocab: int = 10000, frames=(16, 10, 16, 16, 16),
                   conv_hidden=(128, 64, 64), conv_checked: int = 2):
    """(name, kind, build(generator), input shape, CPU batch, time steps)
    of the rnn_cells phase (see the phase list)."""
    from bigdl_tpu_torch import nn as N

    def rec(make):
        return lambda g: N.Recurrent().add(make(g))

    def conv_stack(g):
        ins = (frames[2],) + tuple(conv_hidden[:-1])
        return N.Recurrent().add(N.MultiRNNCell(
            [N.ConvLSTMPeephole(i, o, 5, 5, generator=g)
             for i, o in zip(ins, conv_hidden)]))

    return [
        ("RnnCell", "dense", rec(lambda g: N.RnnCell(H, H, generator=g)),
         (B, T, H), B, T),
        ("GRU", "dense", rec(lambda g: N.GRU(H, H, generator=g)),
         (B, T, H), B, T),
        ("GRU_reset_before", "dense", rec(lambda g: N.GRU(
            H, H, reset_after=False, generator=g)), (B, T, H), B, T),
        ("LSTMPeephole", "dense", rec(lambda g: N.LSTMPeephole(
            H, H, generator=g)), (B, T, H), B, T),
        ("MultiRNNCell_2xLSTM", "dense", rec(lambda g: N.MultiRNNCell(
            [N.LSTM(H, H, generator=g), N.LSTM(H, H, generator=g)])),
         (B, T, H), B, T),
        ("RecurrentDecoder_GRU", "dense", lambda g: N.RecurrentDecoder(
            T).add(N.GRU(H, H, generator=g)), (B, H), B, T),
        ("TimeDistributed_Linear", "dense", lambda g: N.TimeDistributed(
            N.Linear(H, vocab, generator=g)), (B, T, H), B, T),
        ("MultiRNNCell_3xConvLSTMPeephole", "conv", conv_stack,
         tuple(frames), conv_checked, frames[1]),
    ]


def rnn_cells_phase(**sizes):
    """The recurrent family's cells on the card (see the phase list);
    raises on any error beyond ``RNN_CELLS_TOL``."""
    import copy

    import torch

    figures, misses = {}, {}
    for i, (name, kind, build, shape, cpu_b, steps) in enumerate(
            rnn_cell_cases(**sizes)):
        cpu = build(torch.Generator().manual_seed(i))
        x = np.random.default_rng(i).standard_normal(shape).astype(
            np.float32)
        c_out, c_gx, c_gp, cts, _, _ = tail_layer_run(cpu, x[:cpu_b], None,
                                                   "cpu")
        d_out, d_gx, d_gp, _, _, _ = tail_layer_run(cpu, x[:cpu_b], cts,
                                                    "cuda")
        err = {"output": rel_err(d_out[0], c_out[0]),
               "input_grad": rel_err(d_gx[0], c_gx[0]),
               "param_grads": max(rel_err(d_gp[k], v)
                                  for k, v in c_gp.items())}
        dev = copy.deepcopy(cpu).to("cuda")
        del cpu
        run = fwd_bwd(dev, torch.from_numpy(x).to("cuda"))
        ms = host_ms(run)
        counts = window_counts(run, f"rnn_cells_{name}", steps)
        figures[name] = {
            "kind": kind, "shape": list(shape), "checked_batch": cpu_b,
            "err": err, "tol": RNN_CELLS_TOL[kind],
            "fwd_bwd_ms_p50": float(np.median(ms)), "fwd_bwd_ms": ms,
            "launches_per_time_step": counts["device_launches"]}
        if max(err.values()) > RNN_CELLS_TOL[kind]:
            misses[name] = err
        del dev, run
        torch.cuda.empty_cache()
    emit("rnn_cells", card=nvidia_smi(), cells=figures, tol=RNN_CELLS_TOL,
         misses=misses)
    if misses:
        raise AssertionError(f"rnn_cells card vs CPU beyond "
                             f"{RNN_CELLS_TOL}: {misses}")


def ptb_first_step(model, x, y, device):
    """One ``Adagrad(0.1)`` train step of a copy of ``model`` on
    ``device``: (loss, accumulator, params), on the CPU."""
    import copy

    import torch

    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.optim.train_step import make_train_step

    m = copy.deepcopy(model).to(device)
    opt = Adagrad(learning_rate=0.1)
    params = {k: p.detach().clone() for k, p in m.named_parameters()}
    params, state, _, loss = make_train_step(
        m, TimeDistributedCriterion(ClassNLLCriterion()), opt)(
        params, opt.init_state(params), {}, None,
        torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    return (float(loss), {k: v.cpu() for k, v in state["accum"].items()},
            {k: v.cpu() for k, v in params.items()})


def first_step_errors(cpu, card):
    """The loss's, the accumulator's and the parameters' (where |g| is
    above 1% of its tensor's largest) relative errors of a first Adagrad
    step, card vs CPU."""
    (lc, ac, pc), (ld, ad, pd) = cpu, card
    param_err = 0.0
    for k, v in pc.items():
        clear = ac[k].sqrt() > 1e-2 * ac[k].sqrt().max()
        param_err = max(param_err, rel_err(pd[k][clear], v[clear]))
    return {"loss_rel_err": abs(ld - lc) / abs(lc),
            "accum_rel_err": max(rel_err(ad[k], v) for k, v in ac.items()),
            "param_rel_err": param_err, "cpu_loss": lc, "card_loss": ld}


def optimizer_run(model, samples, criterion, method, batch, epochs=1):
    """``Optimizer`` on the card for ``epochs`` with a ``TrainSummary``:
    (wall s, step seconds from the ``Throughput`` scalars, losses, peak
    GiB)."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.optim import Optimizer, Trigger
    from bigdl_tpu_torch.visualization import TrainSummary

    summary = tempfile.mkdtemp(prefix="summary_")
    opt = Optimizer(model, samples, criterion, batch_size=batch,
                    end_trigger=Trigger.max_epoch(epochs))
    opt.set_optim_method(method)
    opt.set_train_summary(TrainSummary(summary, "train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ts = TrainSummary(summary, "train")
    losses = [v for _, v in ts.read_scalar("Loss")]
    step_s = [batch / v for _, v in ts.read_scalar("Throughput")]
    ts.close()
    shutil.rmtree(summary, ignore_errors=True)
    return wall, step_s, losses, peak


def markov_corpus(path: str, words: int, vocab: int, seed: int = 0) -> str:
    """A text file of ``words`` words over ``vocab`` distinct ones, each
    next word 1-2 places after the previous (mod ``vocab``)."""
    rng = np.random.default_rng(seed)
    ids = np.cumsum(rng.integers(1, 3, words)) % vocab
    with open(path, "w") as f:
        f.write(" ".join(f"w{i}" for i in ids))
    return path


def falls(losses, k: int = 20) -> bool:
    """The mean of the last ``k`` losses below the mean of the first."""
    return bool(np.isfinite(losses).all()
                and np.mean(losses[-k:]) < np.mean(losses[:k]))


def ptb_phase(vocab: int = 10000, hidden: int = 200, steps: int = 20,
              batch: int = 20, windows: int = 10000,
              corpus_words: int = 200000):
    """The PTB language model at the PTB-small configuration (see the
    phase list)."""
    import copy
    import os
    import tempfile

    import torch

    from bigdl_tpu_torch.models.rnn import (
        PTBModel, SimpleRNN, synthetic_samples, train_main,
    )
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adagrad

    crit = TimeDistributedCriterion(ClassNLLCriterion())
    samples = synthetic_samples(windows, vocab, steps)
    x = np.stack([s.features[0] for s in samples[:batch]])
    y = np.stack([s.labels[0] for s in samples[:batch]])
    cpu = PTBModel(vocab, hidden, num_layers=2, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    check = first_step_errors(ptb_first_step(cpu, x, y, "cpu"),
                              ptb_first_step(cpu, x, y, "cuda"))
    model = copy.deepcopy(cpu).to("cuda")
    window = optimizer_window(model, samples[:3 * batch], crit,
                              Adagrad(0.1), batch, 2)
    window()
    counts = window_counts(window, "ptb_train", 2)
    counts["per_time_step_and_layer"] = counts["device_launches"] / (
        steps * 2)
    wall, step_s, losses, peak = optimizer_run(model, samples, crit,
                                               Adagrad(0.1), batch)
    p50 = float(np.median(step_s[1:]))
    with tempfile.TemporaryDirectory() as d:
        corpus = markov_corpus(os.path.join(d, "ptb.train.txt"),
                               corpus_words, vocab - 1)
        m, c_wall, c_step, c_losses, c_peak = main_run(
            train_main, ["-f", corpus, "--seqLen", str(steps), "-b",
                         str(batch), "--hidden", str(hidden),
                         "--maxEpoch", "1"], batch)
    c_vocab = m[0].n_index
    del m
    rng = np.random.default_rng(1)
    rnn_batches = [(rng.integers(1, vocab + 1, (batch, steps)).astype(
        np.float32), rng.integers(1, vocab + 1, (batch, steps)).astype(
        np.float32)) for _ in range(5)]
    rnn_losses, _ = train_steps(
        SimpleRNN(vocab, hidden, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(2)),
        rnn_batches, crit, Adagrad(0.1))
    emit("ptb", card=nvidia_smi(),
         what=f"PTBModel(vocab {vocab}, hidden {hidden}, 2 LSTM layers), "
         f"{steps} steps, batch {batch}, LocalOptimizer + Adagrad 0.1, "
         f"one epoch of {windows} synthetic windows (a time cut: PTB's "
         "train set is about 929k words)", wall_s=wall, steps=len(step_s),
         step_ms_p50=p50 * 1e3, words_per_s=batch * steps / p50,
         first_loss=losses[0], last_loss=losses[-1], peak_mem_gib=peak,
         per_step=counts, card_vs_cpu=check, tol=PTB_CARD_TOL,
         corpus={"words": corpus_words, "vocab": c_vocab, "wall_s": c_wall,
                 "steps": len(c_step),
                 "step_ms_p50": float(np.median(c_step[1:])) * 1e3,
                 "first_loss": c_losses[0], "last_loss": c_losses[-1],
                 "peak_mem_gib": c_peak},
         simple_rnn_losses=rnn_losses)
    if max(check["loss_rel_err"], check["accum_rel_err"],
           check["param_rel_err"]) > PTB_CARD_TOL:
        raise AssertionError(f"ptb first step card vs CPU {check}")
    if not (falls(losses) and falls(c_losses) and c_vocab == vocab
            and np.isfinite(rnn_losses).all()):
        raise AssertionError(
            f"ptb losses {losses[:3]}...{losses[-3:]}, corpus "
            f"{c_losses[:3]}...{c_losses[-3:]} (vocab {c_vocab}), "
            f"SimpleRNN {rnn_losses}")


def languagemodel_phase(vocab: int = 10000, hidden: int = 200,
                        steps: int = 20, batch: int = 20,
                        windows: int = 2000, beam: int = 4,
                        gen_len: int = 20):
    """The language-model example on the card (see the phase list)."""
    import io

    import torch

    from bigdl_tpu_torch.examples.languagemodel import (
        generate, lm_step_fn, main,
    )
    from bigdl_tpu_torch.models.rnn import PTBModel

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        model = main(["--vocab", str(vocab), "--hidden", str(hidden),
                      "--seqLen", str(steps), "-b", str(batch),
                      "--synthetic", str(windows), "--maxEpoch", "1",
                      "--beam", str(beam), "--genLen", str(gen_len)])
    lines = [ln for ln in log.getvalue().splitlines()
             if ln.startswith("beam ")]
    ids = [[int(t) for t in ln.split()[4:]] for ln in lines]
    scores = [float(ln.split()[3]) for ln in lines]
    beams_ok = (len(lines) == beam and scores == sorted(scores, reverse=True)
                and all(len(r) == gen_len and all(1 <= t <= vocab for t in r)
                        for r in ids))
    ms = host_ms(lambda: generate(model, beam, gen_len), reps=3)
    two = PTBModel(vocab, hidden, num_layers=2, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(3))
    prompt = torch.randint(0, vocab, (beam, steps), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    step, cell = lm_step_fn(two)
    with torch.no_grad():
        want = two((prompt + 1).float())
        carry = cell.init_carry(beam, "cuda")
        step_err = 0.0
        for t in range(steps):
            logits, carry = step(None, prompt[:, t], carry)
            step_err = max(step_err, rel_err(torch.log_softmax(logits, -1),
                                             want[:, t]))
    emit("languagemodel", card=nvidia_smi(),
         what=f"examples.languagemodel.main --vocab {vocab} --hidden "
         f"{hidden} --seqLen {steps} -b {batch} on {windows} synthetic "
         f"windows, one epoch, --beam {beam} --genLen {gen_len}",
         beams=lines, beams_ok=beams_ok,
         beam_ms_per_token=float(np.median(ms)) / gen_len, beam_ms=ms,
         stacked_step_err=step_err, tol=LM_STEP_TOL)
    if not beams_ok or step_err > LM_STEP_TOL:
        raise AssertionError(f"languagemodel beams {lines}, stacked-step "
                             f"error {step_err}")


def treelstm_phase(vocab: int = 20000, batch: int = 25,
                   lbfgs_trees: int = 256, n_nodes: int = 111,
                   leaves=(10, 57)):
    """The binary TreeLSTM sentiment net on the card (see the phase
    list)."""
    import copy

    import torch
    from torch.func import functional_call

    from bigdl_tpu_torch.models.treelstm import (
        TreeLSTMSentiment, synthetic_trees,
    )
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LBFGS, TreeNNAccuracy

    cpu = TreeLSTMSentiment(vocab, 128, 128, 5, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    word, left, right, labels = synthetic_trees(batch, vocab, leaves,
                                                n_nodes, seed=0)
    xs = [word, left, right]
    c_out, _, c_gp, cts, _, _ = tail_layer_run(cpu, xs, None, "cpu")
    d_out, _, d_gp, _, _, _ = tail_layer_run(cpu, xs, cts, "cuda")
    err = {"output": rel_err(d_out[0], c_out[0]),
           "param_grads": max(rel_err(d_gp[k], v) for k, v in c_gp.items())}
    acc = {}
    for all_nodes in (False, True):
        got = TreeNNAccuracy(all_nodes).apply(d_out[0], labels)
        want = TreeNNAccuracy(all_nodes).apply(c_out[0], labels)
        acc["all" if all_nodes else "root"] = {
            "card": [got.correct, got.count],
            "cpu": [want.correct, want.count]}
    acc_equal = all(v["card"] == v["cpu"] for v in acc.values())
    dev = copy.deepcopy(cpu).to("cuda")
    run = fwd_bwd(dev, [torch.from_numpy(a).to("cuda") for a in xs])
    ms = host_ms(run)
    counts = window_counts(run, "treelstm_fwd_bwd", n_nodes)
    # L-BFGS on the root loss of a larger forest
    t_word, t_left, t_right, t_labels = synthetic_trees(
        lbfgs_trees, vocab, leaves, n_nodes, seed=1)
    roots = (((t_word > 0) | (t_left > 0)) * np.arange(n_nodes)).argmax(1)
    crit = ClassNLLCriterion()
    evals = [0]

    def feval_on(model, device):
        ins = [torch.from_numpy(a).to(device)
               for a in (t_word, t_left, t_right)]
        r = torch.from_numpy(roots).to(device)
        tgt = torch.from_numpy(
            t_labels[np.arange(lbfgs_trees), roots]).to(device)
        rows = torch.arange(lbfgs_trees, device=device)

        def feval(params):
            evals[0] += 1
            ps = {k: v.detach().requires_grad_() for k, v in params.items()}
            with torch.enable_grad():
                loss = crit.apply(functional_call(model, ps, (ins,))[rows, r],
                                  tgt)
                grads = torch.autograd.grad(loss, list(ps.values()))
            return loss.detach(), dict(zip(ps, grads))

        return feval

    lc, gc = feval_on(cpu, "cpu")({k: p.detach()
                                   for k, p in cpu.named_parameters()})
    feval = feval_on(dev, "cuda")
    dparams = {k: p.detach() for k, p in dev.named_parameters()}
    ld, gd = feval(dparams)
    first = {"loss_rel_err": abs(float(ld) - float(lc)) / abs(float(lc)),
             "grad_rel_err": max(rel_err(gd[k], v) for k, v in gc.items())}
    evals[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = LBFGS(max_iter=10).optimize(feval, dparams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit("treelstm", card=nvidia_smi(),
         what=f"TreeLSTMSentiment({vocab}, 128, 128, 5), {batch} synthetic "
         f"binary trees of {leaves[0]}-{leaves[1] - 1} leaves padded to "
         f"{n_nodes} nodes; LBFGS(max_iter=10) on the root loss of "
         f"{lbfgs_trees} trees", err=err, tol=TREE_CARD_TOL,
         tree_nn_accuracy=acc, fwd_bwd_ms_p50=float(np.median(ms)),
         fwd_bwd_ms=ms, launches_per_node=counts["device_launches"],
         lbfgs_first=first, lbfgs_losses=losses, lbfgs_evals=evals[0],
         lbfgs_wall_s=wall, lbfgs_evals_per_s=evals[0] / wall)
    if max(list(err.values()) + list(first.values())) > TREE_CARD_TOL:
        raise AssertionError(f"treelstm card vs CPU {err}, {first}")
    if not (acc_equal and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"treelstm accuracy {acc}, L-BFGS {losses}")


def sparse_rows(rng, batch: int, features: int, per_row: int, ids: bool):
    """A (batch, features) ``SparseTensor`` on the CPU with ``per_row``
    hashed columns per row: feature values N(0, 1), or, with ``ids``, the
    1-based column ids themselves as the values (``LookupTableSparse``'s
    input, laid out (batch, per_row))."""
    import torch

    from bigdl_tpu_torch.tensor.sparse import SparseTensor

    rows = np.repeat(np.arange(batch), per_row)
    cols = rng.integers(0, features, batch * per_row)
    if ids:
        idx = np.stack([rows, np.tile(np.arange(per_row), batch)])
        return SparseTensor(idx, torch.from_numpy(
            (cols + 1).astype(np.float32)), (batch, per_row))
    return SparseTensor(np.stack([rows, cols]), torch.from_numpy(
        rng.standard_normal(batch * per_row).astype(np.float32)),
        (batch, features))


def extra_layer_cases():
    """A.7 group 3's layers for ``nn_extra``: (name, kind, build(generator)
    → module on the CPU, inputs(rng) → array, list, ``SparseTensor`` or
    list of them, rows checked against the CPU (``None``: all), the label
    of its forward + backward timing at the full batch or ``None``)."""
    import bigdl_tpu_torch.nn as T

    E, R, P, C = "elementwise", "reduction", "product", "convolution"
    N, S, H = "normalization", "sparse", "host_side"
    rows, maps = (64, 1024), (32, 64, 56, 56)
    words, vol = (64, 56, 300), (8, 64, 8, 28, 28)

    def normal(*shape, scale=1.0):
        return lambda rng: scale * rng.standard_normal(shape, np.float32)

    def table(*makers):
        return lambda rng: [m(rng) for m in makers]

    def with_zero_steps(rng):
        x = rng.standard_normal((64, 16, 1024)).astype(np.float32)
        x[:, ::4] = 0.0
        return x

    def half_zero(rng):
        x = rng.standard_normal(rows).astype(np.float32)
        return x * (rng.uniform(size=rows) < 0.5)

    def probabilities(rng):
        z = rng.standard_normal(rows)
        return (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(
            np.float32)

    def sparse(ids, per_row=40, features=1_000_000):
        return lambda rng: sparse_rows(rng, 2048, features, per_row, ids)

    def conv_map(g):
        return T.SpatialConvolutionMap(T.SpatialConvolutionMap.random(
            64, 64, 16), 3, 3, pad_w=1, pad_h=1, generator=g)

    cases = [
        # layers_extra: similarity
        ("Cosine", P, lambda g: T.Cosine(1024, 512, generator=g),
         normal(*rows), None, None),
        ("Euclidean", P, lambda g: T.Euclidean(1024, 512, generator=g),
         normal(*rows), None, None),
        ("DotProduct", R, lambda g: T.DotProduct(),
         table(normal(*rows), normal(*rows)), None, None),
        ("PairwiseDistance", R, lambda g: T.PairwiseDistance(2),
         table(normal(*rows), normal(*rows)), None, None),
        ("CosineDistance", R, lambda g: T.CosineDistance(),
         table(normal(*rows), normal(*rows)), None, None),
        # activations
        ("SoftMin", R, lambda g: T.SoftMin(), normal(*maps), 8, None),
        ("LogSigmoid", E, lambda g: T.LogSigmoid(), normal(*maps, scale=4.0),
         8, None),
        ("Threshold", E, lambda g: T.Threshold(0.2, -1.0), normal(*maps),
         8, None),
        ("RReLU", E, lambda g: T.RReLU(), normal(*maps), 8, None),
        ("HardSigmoid", E, lambda g: T.HardSigmoid(),
         normal(*maps, scale=4.0), 8, None),
        ("TanhShrink", E, lambda g: T.TanhShrink(), normal(*maps), 8,
         None),
        ("SoftShrink", E, lambda g: T.SoftShrink(0.3), normal(*maps), 8,
         None),
        ("HardShrink", E, lambda g: T.HardShrink(0.3), normal(*maps), 8,
         None),
        # table / shape
        ("Replicate", E, lambda g: T.Replicate(4, 1), normal(*rows), None,
         None),
        ("Index", E, lambda g: T.Index(1), lambda rng: [
            rng.standard_normal(rows).astype(np.float32),
            rng.integers(1, 65, 32).astype(np.int32)], None, None),
        ("Masking", E, lambda g: T.Masking(0.0), with_zero_steps, None,
         None),
        ("SelectTable", E, lambda g: T.SelectTable(-1),
         table(normal(*rows), normal(*rows), normal(*rows)), None, None),
        ("NarrowTable", E, lambda g: T.NarrowTable(2, 2),
         table(normal(*rows), normal(*rows), normal(*rows)), None, None),
        ("SpatialZeroPadding", E, lambda g: T.SpatialZeroPadding(1, 2, -1, 0),
         normal(*maps), 8, None),
        ("Scale", E, lambda g: T.Scale((64,)), normal(*maps), 8, None),
        ("Negative", E, lambda g: T.Negative(), normal(*rows), None, None),
        ("GradientReversal", E, lambda g: T.GradientReversal(0.5),
         normal(*maps), 8, None),
        ("L1Penalty", E, lambda g: T.L1Penalty(0.1, True), normal(*maps),
         8, None),
        ("GaussianSampler", E, lambda g: T.GaussianSampler(),
         table(normal(*rows), normal(*rows, scale=0.3)), None, None),
        ("GaussianNoise", E, lambda g: T.GaussianNoise(0.5), normal(*maps),
         8, None),
        ("GaussianDropout", E, lambda g: T.GaussianDropout(0.2),
         normal(*maps), 8, None),
        # temporal / volumetric / dilated convolution, pooling, up-sampling
        ("TemporalConvolution", C, lambda g: T.TemporalConvolution(
            300, 100, 3, generator=g), normal(*words), None,
         "TemporalConvolution_k3"),
        ("TemporalConvolution", C, lambda g: T.TemporalConvolution(
            300, 100, 4, generator=g), normal(*words), None,
         "TemporalConvolution_k4"),
        ("TemporalConvolution", C, lambda g: T.TemporalConvolution(
            300, 100, 5, generator=g), normal(*words), None,
         "TemporalConvolution_k5"),
        ("VolumetricConvolution", C, lambda g: T.VolumetricConvolution(
            3, 64, 3, 3, 3, 1, 1, 1, 1, 1, 1, generator=g),
         normal(8, 3, 16, 112, 112), 1, "VolumetricConvolution"),
        ("VolumetricMaxPooling", R, lambda g: T.VolumetricMaxPooling(
            2, 2, 2), normal(8, 64, 16, 56, 56), 1,
         "VolumetricMaxPooling"),
        ("VolumetricAveragePooling", R, lambda g:
         T.VolumetricAveragePooling(2, 2, 2), normal(8, 64, 16, 56, 56), 1,
         None),
        ("SpatialDilatedConvolution", C, lambda g:
         T.SpatialDilatedConvolution(64, 64, 3, 3, 1, 1, 2, 2, 2, 2,
                                     generator=g), normal(*maps), 4, None),
        ("SpatialUpSamplingNearest", E, lambda g:
         T.SpatialUpSamplingNearest(2), normal(*maps), 8, None),
        ("SpatialUpSamplingBilinear", R, lambda g:
         T.SpatialUpSamplingBilinear(2), normal(*maps), 4, None),
        ("Bilinear", P, lambda g: T.Bilinear(1024, 1024, 16, generator=g),
         table(normal(*rows), normal(*rows)), None, None),
        # layers_more: table / shape
        ("Pack", E, lambda g: T.Pack(2), table(normal(*rows), normal(*rows)),
         None, None),
        ("Tile", E, lambda g: T.Tile(2, 3), normal(*rows), None, None),
        ("Reverse", E, lambda g: T.Reverse(2), normal(*maps), 8, None),
        ("InferReshape", E, lambda g: T.InferReshape([0, -1, 64]),
         normal(*rows), None, None),
        ("BifurcateSplitTable", E, lambda g: T.BifurcateSplitTable(2),
         normal(*rows), None, None),
        ("MixtureTable", R, lambda g: T.MixtureTable(),
         table(normal(64, 8), normal(64, 8, 1024)), None, None),
        ("MaskedSelect", H, lambda g: T.MaskedSelect(), lambda rng: [
            rng.standard_normal(rows).astype(np.float32),
            (rng.uniform(size=rows) < 0.5).astype(np.float32)], None, None),
        ("DenseToSparse", H, lambda g: T.DenseToSparse(64 * 1024),
         half_zero, None, None),
        # activations with weights
        ("SReLU", E, lambda g: T.SReLU((64, 56, 56), shared_axes=[2, 3],
                                       generator=g), normal(*maps), 8,
         None),
        ("Maxout", P, lambda g: T.Maxout(1024, 512, 4, generator=g),
         normal(*rows), None, None),
        # temporal pooling, padding, up-sampling, cropping
        ("TemporalMaxPooling", R, lambda g: T.TemporalMaxPooling(54),
         normal(64, 54, 100), None, "TemporalMaxPooling"),
        ("TemporalAveragePooling", R, lambda g:
         T.TemporalAveragePooling(3, 2, "SAME"), normal(*words), None,
         None),
        ("VolumetricZeroPadding", E, lambda g: T.VolumetricZeroPadding(
            1, 1, 1), normal(*vol), 2, None),
        ("UpSampling1D", E, lambda g: T.UpSampling1D(2), normal(*words),
         None, None),
        ("UpSampling3D", E, lambda g: T.UpSampling3D((2, 2, 2)),
         normal(*vol), 2, None),
        ("Cropping2D", E, lambda g: T.Cropping2D((1, 1), (2, 2)),
         normal(*maps), 8, None),
        ("Cropping3D", E, lambda g: T.Cropping3D((1, 1), (2, 2), (0, 3)),
         normal(*vol), 2, None),
        # convolutions
        ("VolumetricFullConvolution", C, lambda g:
         T.VolumetricFullConvolution(64, 32, 2, 2, 2, 2, 2, 2, generator=g),
         normal(*vol), 1, None),
        ("LocallyConnected2D", C, lambda g: T.LocallyConnected2D(
            64, 28, 28, 64, 3, 3, 1, 1, 1, 1, generator=g),
         normal(16, 64, 28, 28), 2, "LocallyConnected2D"),
        ("LocallyConnected1D", C, lambda g: T.LocallyConnected1D(
            56, 300, 100, 3, generator=g), normal(*words), 8, None),
        ("SpatialShareConvolution", C, lambda g: T.SpatialShareConvolution(
            64, 64, 3, 3, 1, 1, 1, 1, generator=g), normal(*maps), 4, None),
        ("SpatialSeparableConvolution", C, lambda g:
         T.SpatialSeparableConvolution(64, 128, 2, 3, 3, p_w=1, p_h=1,
                                       generator=g), normal(*maps), 4,
         None),
        ("SpatialConvolutionMap", C, conv_map, normal(*maps), 4, None),
        # dropout (no generator: the identity), normalization, penalty
        ("SpatialDropout1D", E, lambda g: T.SpatialDropout1D(0.5),
         normal(*words), None, None),
        ("SpatialDropout2D", E, lambda g: T.SpatialDropout2D(0.5),
         normal(*maps), 8, None),
        ("SpatialDropout3D", E, lambda g: T.SpatialDropout3D(0.5),
         normal(*vol), 2, None),
        ("SpatialWithinChannelLRN", N, lambda g: T.SpatialWithinChannelLRN(
            5, 1e-4, 0.75), normal(*maps), 4, None),
        ("SpatialSubtractiveNormalization", N, lambda g:
         T.SpatialSubtractiveNormalization(64), normal(*maps), 2, None),
        ("SpatialDivisiveNormalization", N, lambda g:
         T.SpatialDivisiveNormalization(64), normal(*maps), 2, None),
        ("SpatialContrastiveNormalization", N, lambda g:
         T.SpatialContrastiveNormalization(64), normal(*maps), 2, None),
        ("NegativeEntropyPenalty", E, lambda g:
         T.NegativeEntropyPenalty(0.01), probabilities, None, None),
        # sparse: 1,000,000 hashed features, 40 nonzeros a row, batch 2,048
        ("SparseLinear", S, lambda g: T.SparseLinear(1_000_000, 2,
                                                     generator=g),
         sparse(False), None, "SparseLinear"),
        ("SparseJoinTable", S, lambda g: T.SparseJoinTable(2),
         lambda rng: [sparse(False)(rng), sparse(False)(rng)], None, None),
    ]
    for comb in ("sum", "mean", "sqrtn"):
        cases.append(("LookupTableSparse", S, lambda g, c=comb:
                      T.LookupTableSparse(1_000_000, 64, c, generator=g),
                      sparse(True), None, f"LookupTableSparse_{comb}"))
    return cases


def extra_criterion_cases():
    """(name, criterion, inputs(rng) → (input, target)) at (64, 1024)."""
    from bigdl_tpu_torch import nn as T

    def f32(a):
        return np.asarray(a, np.float32)

    def make(kind):
        def inputs(rng):
            x = f32(rng.standard_normal((64, 1024)))
            y = f32(rng.standard_normal((64, 1024)))
            pm1 = f32(np.where(rng.uniform(size=64) < 0.5, 1.0, -1.0))
            labels = f32(rng.integers(1, 1025, 64))
            if kind == "multilabel":
                t = np.zeros((64, 1024), np.float32)
                t[:, :5] = rng.integers(1, 1025, (64, 5))
                return x, t
            return {"pair": ([x, y], pm1),
                    "hinge": (np.abs(x), f32(np.sign(y))),
                    "rank": ([x[:, 0], y[:, 0]], pm1),
                    "labels": (x, labels),
                    "ignore": (x, np.where(labels % 7 == 0, 3.0,
                                           labels).astype(np.float32)),
                    "none": (x, None),
                    "xy": (x, y),
                    "dice": (f32(rng.uniform(size=(64, 1024))),
                             f32(rng.uniform(size=(64, 1024)) < 0.5)),
                    "gauss": ([x, 0.3 * y], None),
                    "gauss_t": ([x, 0.3 * y], f32(rng.standard_normal(
                        (64, 1024)))),
                    "sign": (x, f32(np.sign(y)))}[kind]
        return inputs

    multi = (T.MultiCriterion().add(T.MSECriterion(), 0.5)
             .add(T.AbsCriterion(), 2.0))
    return [
        ("CosineEmbeddingCriterion", T.CosineEmbeddingCriterion(0.3),
         make("pair")),
        ("HingeEmbeddingCriterion", T.HingeEmbeddingCriterion(1.0),
         make("hinge")),
        ("MarginRankingCriterion", T.MarginRankingCriterion(0.5),
         make("rank")),
        ("MultiMarginCriterion", T.MultiMarginCriterion(2), make("labels")),
        ("MultiLabelMarginCriterion", T.MultiLabelMarginCriterion(),
         make("multilabel")),
        ("L1Cost", T.L1Cost(), make("none")),
        ("SoftmaxWithCriterion", T.SoftmaxWithCriterion(3), make("ignore")),
        ("DiceCoefficientCriterion", T.DiceCoefficientCriterion(),
         make("dice")),
        ("MultiCriterion", multi, make("xy")),
        ("KLDCriterion", T.KLDCriterion(), make("gauss")),
        ("GaussianCriterion", T.GaussianCriterion(), make("gauss_t")),
        ("CosineDistanceCriterion", T.CosineDistanceCriterion(),
         make("xy")),
        ("SoftMarginCriterion", T.SoftMarginCriterion(), make("sign")),
        ("CosineProximityCriterion", T.CosineProximityCriterion(),
         make("xy")),
        ("ClassSimplexCriterion", T.ClassSimplexCriterion(1024),
         make("labels")),
    ]


def nn_extra_phase():
    """A.7 group 3 on the card against the port's own CPU run (see the
    phase list); raises on any error beyond ``NN_EXTRA_TOL``."""
    import copy

    import torch

    errors, kinds, timings = {}, {}, {}
    for i, (name, kind, build, inputs, checked, timed) in enumerate(
            extra_layer_cases()):
        layer = build(torch.Generator().manual_seed(i))
        x = inputs(np.random.default_rng(i))
        xc = _first_rows(x, checked)
        c_out, c_gx, c_gp, cts, _, c_idx = tail_layer_run(layer, xc, None,
                                                          "cpu")
        d_out, d_gx, d_gp, _, _, d_idx = tail_layer_run(layer, xc, cts,
                                                        "cuda")
        pairs = (list(zip(d_out, c_out)) + list(zip(d_gx, c_gx))
                 + [(d_gp[k], v) for k, v in c_gp.items()])
        err = max(rel_err(a, b) for a, b in pairs)
        if not all(torch.equal(a, b) for a, b in zip(d_idx, c_idx)):
            err = float("inf")
        errors[name] = max(err, errors.get(name, 0.0))
        kinds[name] = kind
        if timed:
            dev = copy.deepcopy(layer).to("cuda").train()
            xd = _on(x, "cuda")
            run = fwd_bwd(dev, xd)
            ms = host_ms(run)
            counts = window_counts(run, f"nn_extra_{timed}", 1)
            timings[timed] = {
                "layer": repr(dev), "input": list(_leaves(xd)[0].shape),
                "fwd_bwd_ms_p50": float(np.median(ms)), "fwd_bwd_ms": ms,
                "launches": counts["host_launch_calls"],
                "device_records": counts["device_launches"]}
            del dev, xd, run
        del layer, x
        torch.cuda.empty_cache()
    for i, (name, crit, inputs) in enumerate(extra_criterion_cases()):
        x, t = inputs(np.random.default_rng(200 + i))
        got = []
        for device in ("cpu", "cuda"):
            xd = ([torch.from_numpy(v).to(device) for v in x]
                  if isinstance(x, list) else torch.from_numpy(x).to(device))
            td = None if t is None else torch.from_numpy(t).to(device)
            loss = crit.forward(xd, td)
            g = crit.backward(xd, td)
            got.append((loss, g if isinstance(g, list) else [g]))
        (lc, gc), (ld, gd) = got
        errors[name] = max([abs(ld - lc) / max(abs(lc), 1e-30)]
                           + [rel_err(a, b) for a, b in zip(gd, gc)])
        kinds[name] = "criterion"
    misses = {n: {"err": e, "tol": NN_EXTRA_TOL[kinds[n]]}
              for n, e in errors.items() if not e <= NN_EXTRA_TOL[kinds[n]]}
    draws = random_draws_on_card()
    emit("nn_extra", card=nvidia_smi(), names=len(errors),
         max_err={n: {"kind": kinds[n], "err": e} for n, e in errors.items()},
         tol=NN_EXTRA_TOL, fwd_bwd=timings, random_draws=draws,
         misses=misses)
    bad_draws = [k for k, v in draws.items() if not v["ok"]]
    if misses or bad_draws or len(errors) != 83:
        raise AssertionError(f"nn_extra: {len(errors)} names, card vs CPU "
                             f"misses {misses}, random draws {bad_draws}")


def random_draws_on_card() -> dict:
    """The random layers drawing from a CUDA generator in training mode:
    each draw's law (the slope range and mean, the noise's deviation, the
    spatial dropouts' keep rate and one decision per channel) and a
    bitwise repeat per seed."""
    import torch

    from bigdl_tpu_torch import nn as T
    from bigdl_tpu_torch.nn.module import use_rng

    ones = torch.ones((64, 64, 56, 56), device="cuda")

    def drawn(layer, x, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with use_rng(gen):
            return layer.train()(x)

    out = {}
    cases = {
        "RReLU": (T.RReLU(0.1, 0.3), -ones,
                  lambda o: {"min": float(-o.max()), "max": float(-o.min()),
                             "mean": float(-o.mean())},
                  lambda s: s["min"] >= 0.1 and s["max"] <= 0.3
                  and abs(s["mean"] - 0.2) < 1e-3),
        "GaussianNoise": (T.GaussianNoise(0.5), ones,
                          lambda o: {"std": float((o - 1).std())},
                          lambda s: abs(s["std"] - 0.5) < 1e-3),
        "GaussianDropout": (T.GaussianDropout(0.2), ones,
                            lambda o: {"mean": float(o.mean()),
                                       "std": float(o.std())},
                            lambda s: abs(s["mean"] - 1) < 1e-3
                            and abs(s["std"] - 0.5) < 1e-3),
        "GaussianSampler": (T.GaussianSampler(),
                            [ones * 0, ones * float(np.log(0.25))],
                            lambda o: {"std": float(o.std())},
                            lambda s: abs(s["std"] - 0.5) < 1e-3),
    }
    for n, shape in (("SpatialDropout1D", (256, 56, 1024)),
                     ("SpatialDropout2D", (256, 1024, 7, 7)),
                     ("SpatialDropout3D", (256, 1024, 2, 3, 3))):
        x = torch.ones(shape, device="cuda")
        per = (lambda o: o.amax(1) == o.amin(1)) if n.endswith("1D") else (
            lambda o: o.flatten(2).amax(-1) == o.flatten(2).amin(-1))
        cases[n] = (getattr(T, n)(0.3), x,
                    lambda o, per=per: {"keep": float((o > 0).float().mean()),
                                        "per_channel": bool(per(o).all())},
                    lambda s: abs(s["keep"] - 0.7) < 5e-3
                    and s["per_channel"])
    for n, (layer, x, stats, good) in cases.items():
        o = drawn(layer, x, 1)
        s = stats(o)
        s["repeat_bitwise"] = bool(torch.equal(drawn(layer, x, 1), o))
        s["ok"] = bool(good(s) and s["repeat_bitwise"])
        out[n] = s
    return out


def alexnet_phase(batch: int = 128, steps: int = 8, check_batch: int = 4):
    """AlexNet on the card (see the phase list). No port kernel runs on
    this path: its convolutions are cuDNN's ``F.conv2d``."""
    import copy

    import torch

    from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT, train_main
    from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD

    model, wall, step_s, losses, peak = main_run(
        train_main, ["-b", str(batch), "--synthetic", str(batch * steps),
                     "--maxIteration", str(steps)], batch)
    samples = synthetic_imagenet_samples(batch * 4, seed=1)
    window = optimizer_window(model, samples, ClassNLLCriterion(),
                              SGD(0.01, momentum=0.9), batch, 4)
    del model
    window()                                   # warm
    counts = window_counts(window, "alexnet_train", 4)
    del samples, window
    torch.cuda.empty_cache()
    rng = np.random.default_rng(41)
    batches = [(rng.standard_normal((check_batch, 3, 224, 224)).astype(
        np.float32), rng.integers(1, 1001, check_batch).astype(np.float32))
        for _ in range(3)]
    check = held_on_card(
        "alexnet", lambda: AlexNet_OWT(
            1000, has_dropout=False, device="cpu",
            generator=torch.Generator().manual_seed(3)),
        batches, ClassNLLCriterion(), lambda: SGD(0.01, momentum=0.9))
    p50 = baseline_emit(
        "alexnet", f"AlexNet_OWT train_main (Dropout on, batch {batch}, "
        f"224², f32, SGD 0.01/0.9, {steps} iterations on {batch * steps} "
        f"synthetic images); card vs CPU at batch {check_batch}, dropout "
        "off: 1 f32 step, 3 f64 steps", batch, wall, step_s, losses, peak,
        counts, check)
    # the Caffe layout: LRN and two-group convolutions, 227² crops
    cpu = AlexNet(1000, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    x = np.random.default_rng(42).standard_normal(
        (batch, 3, 227, 227)).astype(np.float32)
    err = {}
    for dtype in (torch.float32, torch.float64):
        xs = x[:check_batch].astype(str(dtype).split(".")[-1])
        c_out, c_gx, c_gp, cts, _, _ = tail_layer_run(cpu.to(dtype), xs,
                                                      None, "cpu")
        d_out, d_gx, d_gp, _, _, _ = tail_layer_run(cpu, xs, cts, "cuda")
        err[str(dtype).split(".")[-1]] = {
            "output": rel_err(d_out[0], c_out[0]),
            "input_grad": rel_err(d_gx[0], c_gx[0]),
            "param_grads": {k: rel_err(d_gp[k], v) for k, v in c_gp.items()}}
    cpu.to(torch.float32)
    dev = copy.deepcopy(cpu).to("cuda").train()
    del cpu
    run = fwd_bwd(dev, torch.from_numpy(x).to("cuda"))
    ms = host_ms(run)
    caffe_counts = window_counts(run, "alexnet_caffe_fwd_bwd", 1)
    emit("alexnet", card=nvidia_smi(),
         what=f"AlexNet (Caffe layout: LRN, two-group conv2/4/5), batch "
         f"{batch}, 227², f32, forward + backward (Dropout without a "
         f"generator); card vs CPU at batch {check_batch}",
         err=err, tol=ALEXNET_CARD_TOL,
         fwd_bwd_ms_p50=float(np.median(ms)), fwd_bwd_ms=ms,
         images_per_s=batch / (float(np.median(ms)) / 1e3),
         launches=caffe_counts["device_launches"])
    del dev, run
    torch.cuda.empty_cache()
    f64 = err["float64"]
    worst = max([f64["output"], f64["input_grad"]]
                + list(f64["param_grads"].values()))
    if not (err["float32"]["output"] <= ALEXNET_CARD_TOL["f32_output"]
            and worst <= ALEXNET_CARD_TOL["f64"]):
        raise AssertionError(f"alexnet (Caffe) card vs CPU {err}")
    return {"alexnet_step_ms_p50": p50 * 1e3}


def keras_output_err(build, x) -> float:
    """The eval-mode f32 output of ``build()`` (a CPU model) on ``x`` on
    the card against the CPU, relative to the CPU's largest value."""
    import copy

    import torch

    cpu = build().evaluate()
    dev = copy.deepcopy(cpu).to("cuda")
    with torch.no_grad():
        want = cpu(torch.from_numpy(x))
        got = dev(torch.from_numpy(x).to("cuda")).cpu()
    return rel_err(got, want)


def keras_round_trip(model, x) -> dict:
    """``save_module`` the card's ``model`` and ``load_module`` it back
    onto the card: the file's size and the seconds of both, and whether
    the eval-mode outputs on ``x`` are bitwise equal."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch.nn.module import AbstractModule

    root = tempfile.mkdtemp(prefix="keras_")
    path = os.path.join(root, "model.bigdl")
    try:
        model.evaluate()
        xs = torch.as_tensor(x).to("cuda")
        with torch.no_grad():
            before = model(xs)
        t0 = time.perf_counter()
        model.save_module(path)
        t1 = time.perf_counter()
        loaded = AbstractModule.load_module(path, device="cuda").evaluate()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            after = loaded(xs)
        on_card = all(p.is_cuda for p in loaded.parameters())
        return {"bitwise_equal": bool(torch.equal(before, after))
                and on_card, "save_s": t1 - t0, "load_s": t2 - t1,
                "file_mib": os.path.getsize(path) / 2 ** 20}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def keras_resnet50_phase(batch: int = 64, steps: int = 6,
                         check_batch: int = 2):
    """Keras 1.2.2's ResNet50 through the port's Keras API (see the phase
    list). No port kernel runs on this path: its convolutions are cuDNN's
    ``F.conv2d``."""
    import torch

    from bigdl_tpu_torch.examples.keras_apps import (
        RESNET50_PARAMS, RESNET50_RUNNING_STATS, resnet50,
    )
    from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.nn import keras as K
    from bigdl_tpu_torch.optim import SGD

    def build(device="cpu"):
        gen = torch.Generator(device).manual_seed(5)
        return resnet50(K, K.Input((3, 224, 224), device=device,
                                   generator=gen))

    model = build("cuda")
    learnable = sum(p.numel() for p in model.parameters())
    stats = sum(b.numel() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    samples = synthetic_imagenet_samples(batch * steps, seed=7)
    wall, step_s, losses, peak = optimizer_run(
        model, samples, ClassNLLCriterion(), SGD(0.1, momentum=0.9), batch)
    window = optimizer_window(model, samples[:batch * 4],
                              ClassNLLCriterion(), SGD(0.1, momentum=0.9),
                              batch, 4)
    window()                                   # warm
    counts = window_counts(window, "keras_resnet50_train", 4)
    del samples, window
    torch.cuda.empty_cache()
    trip = keras_round_trip(model, np.random.default_rng(8).standard_normal(
        (8, 3, 224, 224)).astype(np.float32))
    # a Graph's nodes link both ways: its parameters go at a collection
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(43)
    batches = [(rng.standard_normal((check_batch, 3, 224, 224)).astype(
        np.float32), rng.integers(1, 1001, check_batch).astype(np.float32))
        for _ in range(2)]
    out_err = keras_output_err(build, batches[0][0])
    check, ok = held_on_card("keras_resnet50", build, batches,
                             ClassNLLCriterion(),
                             lambda: SGD(0.1, momentum=0.9))
    check["f32_output_rel_err"] = out_err
    p50 = baseline_emit(
        "keras_resnet50", "Keras 1.2.2 applications ResNet50(include_top, "
        "th) built with the port's Keras functional API (Merge sum, head "
        f"log_softmax), Optimizer at batch {batch}, 224², f32, SGD "
        f"0.1/0.9, {steps} iterations on {batch * steps} synthetic images; "
        f"card vs CPU at batch {check_batch}: eval f32 output, 1 f32 step, "
        "2 f64 steps; save_module/load_module round trip on the card",
        batch, wall, step_s, losses, peak, counts,
        (check, ok and out_err <= KERAS_CARD_TOL["keras_resnet50"]))
    emit("keras_resnet50", card=nvidia_smi(), learnable_params=learnable,
         running_stats=stats, total=learnable + stats,
         published_total=RESNET50_PARAMS,
         published_running_stats=RESNET50_RUNNING_STATS,
         matches_published=(learnable + stats, stats)
         == (RESNET50_PARAMS, RESNET50_RUNNING_STATS),
         f32_output_tol=KERAS_CARD_TOL["keras_resnet50"],
         round_trip=trip)
    if (learnable + stats, stats) != (RESNET50_PARAMS,
                                      RESNET50_RUNNING_STATS):
        raise AssertionError(f"keras ResNet50 has {learnable} + {stats} "
                             f"parameters, Keras publishes "
                             f"{RESNET50_PARAMS} ({RESNET50_RUNNING_STATS} "
                             "running statistics)")
    if not trip["bitwise_equal"]:
        raise AssertionError(f"keras ResNet50 load_module round trip {trip}")
    return {"keras_resnet50_step_ms_p50": p50 * 1e3}


def keras_imdb_phase(batch: int = 30, steps: int = 8, check_batch: int = 4):
    """Keras 1.2.2's IMDB CNN-LSTM from its Keras-1.2 JSON through the
    port's importer (see the phase list). No port kernel runs on this path
    (cuDNN's convolution, cuBLAS products, the port's LSTM cell in plain
    ops)."""
    import torch

    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.examples.keras_apps import (
        imdb_cnn_lstm_json, imdb_cnn_lstm_weights,
    )
    from bigdl_tpu_torch.nn import BCECriterion
    from bigdl_tpu_torch.optim import SGD, Adam
    from bigdl_tpu_torch.utils.keras_loader import (
        load_keras_json, load_keras_weights,
    )

    js = imdb_cnn_lstm_json()
    weights = imdb_cnn_lstm_weights(js, seed=9)
    maxlen = json.loads(js)["config"][0]["config"]["input_length"]
    vocab = json.loads(js)["config"][0]["config"]["input_dim"]

    def build(device="cpu"):
        gen = torch.Generator(device).manual_seed(6)
        return load_keras_weights(
            load_keras_json(js, device=device, generator=gen), js, weights)

    t0 = time.perf_counter()
    model = build("cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    rng = np.random.default_rng(10)
    ids = rng.integers(0, vocab, (batch * steps, maxlen)).astype(np.int32)
    labels = rng.integers(0, 2, batch * steps).astype(np.float32)
    samples = [Sample(i, np.float32([y])) for i, y in zip(ids, labels)]
    wall, step_s, losses, peak = optimizer_run(
        model, samples, BCECriterion(), Adam(1e-3), batch)
    window = optimizer_window(model, samples[:batch * 4], BCECriterion(),
                              Adam(1e-3), batch, 4)
    window()                                   # warm
    counts = window_counts(window, "keras_imdb_train", 4)
    trip = keras_round_trip(model, ids[:batch])
    del model, window
    batches = [(ids[i * check_batch:(i + 1) * check_batch],
                labels[i * check_batch:(i + 1) * check_batch, None])
               for i in range(3)]
    out_err = keras_output_err(build, batches[0][0])
    check, ok = held_on_card("keras_imdb", build, batches, BCECriterion(),
                             lambda: SGD(0.05, momentum=0.9))
    check["f32_output_rel_err"] = out_err
    p50 = baseline_emit(
        "keras_imdb", "Keras 1.2.2 examples/imdb_cnn_lstm.py (Embedding "
        f"{vocab}x128 on maxlen {maxlen}, Dropout 0.25, Convolution1D 64x5 "
        "relu, MaxPooling1D 4, LSTM 70, Dense 1, sigmoid) from its "
        "Keras-1.2 to_json() through load_keras_json, keras-1 weight "
        "arrays from a seed through load_keras_weights; the LSTM's "
        "inner_activation is stated 'sigmoid', not the example's default "
        "hard_sigmoid, which the importer refuses; Optimizer at batch "
        f"{batch}, BCECriterion, Adam 1e-3, {steps} iterations on seeded "
        f"ids; card vs CPU at batch {check_batch} (dropout off): eval f32 "
        "output, 3 f32 and 3 f64 SGD 0.05/0.9 steps",
        batch, wall, step_s, losses, peak, counts,
        (check, ok and out_err <= KERAS_CARD_TOL["keras_imdb"]),
        unit="sequences")
    emit("keras_imdb", card=nvidia_smi(), import_s=import_s,
         f32_output_tol=KERAS_CARD_TOL["keras_imdb"], round_trip=trip)
    if not trip["bitwise_equal"]:
        raise AssertionError(f"keras IMDB load_module round trip {trip}")
    return {"keras_imdb_step_ms_p50": p50 * 1e3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the card", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    hgmma = {name: hgmma_per_kernel(name) for name in WGMMA_KERNELS}
    serialized = [line for name, log in logs.items()
                  for line in serialized_wgmma(name, log)]
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: ptxas_summary(log) for name, log in logs.items()},
         hgmma=hgmma, wgmma_serialized=serialized)
    for name, counts in hgmma.items():
        for kernel, n in counts.items():
            if n <= 0:
                raise AssertionError(f"no HGMMA instruction in {kernel} of "
                                     f"{name}: wgmma was not emitted")
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    data_plane_phase()
    entry = kernels_phase()
    requant = kv_requant_phase()
    w8 = w8a16_phase()
    flash = flash_phase()
    check_phase()
    train_check_phase()
    entry["launches"], requant["launches"], batched_gap_p99_s = serve_phase()
    if not (entry["launches"] and requant["launches"]):
        raise AssertionError("decode_attention or kv_requant never launched "
                             "on the main path")
    for phase in (lambda: serve_modes_phase(batched_gap_p99_s),
                  serve_async_phase, serve_spec_phase, serve_lora_phase,
                  serve_disagg_phase, serve_autopilot_phase,
                  serve_generate_phase):
        n_da, n_kr = phase()
        entry["launches"] += n_da
        requant["launches"] += n_kr
    w8["launches"] = int8_infer_phase()
    int8 = int8_decode_phase()
    w8["launches"] += int8["w8a16"]
    entry["launches"] += int8["decode_attention"]
    requant["launches"] += int8["kv_requant"]
    for name, n in train_phase().items():
        flash[name]["launches"] = n
        flash[name]["launches_by_phase"] = {"train": n}
    for phase_name, phase in (("lm_knobs", lm_knobs_phase),
                              ("lm_main", lm_main_phase),
                              ("seq_parallel", seq_parallel_phase),
                              ("ring_replay", ring_replay_phase)):
        for name, n in phase().items():
            flash[name]["launches"] += n
            flash[name]["launches_by_phase"][phase_name] = n
    parallel_ext_phase()
    fused = fused_conv_phase()
    fused_shapes_phase()
    resnet_check_phase()
    for name, n in resnet_train_phase().items():
        fused[name]["launches"] = n
    resnet_main_phase()
    resnet_folder_phase()
    for name, n in resnet_u8_phase().items():
        fused[name]["launches"] += n
    resnet_preempt_phase()
    lenet_phase()
    vgg_phase()
    inception_phase()
    textclassifier_phase()
    text_news20_phase()
    distri_vgg_phase()
    for name, n in distri_resnet_phase().items():
        fused[name]["launches"] += n
    distri_pod_phase()
    nn_tail_phase()
    autoencoder_phase()
    finetune_phase()
    rnn_cells_phase()
    ptb_phase()
    languagemodel_phase()
    treelstm_phase()
    nn_extra_phase()
    alexnet_phase()
    keras_resnet50_phase()
    keras_imdb_phase()
    conv = conv3x3_phase()
    emit("timing_guard", guard_ms=guard_ms(),
         host_enqueue_ms_max=HOST_ENQUEUE["max_ms"],
         timed_launches=HOST_ENQUEUE["launches"],
         launches_enqueued_after_the_guard=HOST_ENQUEUE["over_guard"],
         kept_all_the_same=HOST_ENQUEUE["kept_over_guard"])
    print(json.dumps({"kernels": [entry]
                      + [flash[n] for n in ("fwd", "dq", "dkv")]
                      + [fused[n] for n in ("fwd", "dgrad", "wgrad")]
                      + [conv, requant, w8]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
